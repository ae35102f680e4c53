"""ImageNet-shaped image batches (port of the synthetic part of
:mod:`apex_tpu.data.image_folder`).

:func:`synthetic_image_batches` yields the reference's seeded stream of
uint8 NHWC images and int32 labels (the same numpy draws, so the same
batches); :func:`normalize_on_device` is the reference prefetcher's
``sub_(mean).div_(std)`` on the tensor's own device.  A normalized
``[N, H, W, C]`` batch's ``permute(0, 3, 1, 2)`` is the model's
channels-last ``[N, C, H, W]`` input with no copy.  The folder loader,
its crops and decode workers are not ported yet (ROADMAP.md, section
A.4).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_on_device",
           "synthetic_image_batches"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_on_device(x_uint8: torch.Tensor, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD, dtype=None) -> torch.Tensor:
    """uint8 ``[..., C]`` images to ``(x / 255 - mean) / std`` in ``dtype``
    (default fp32), computed on ``x_uint8``'s device in that dtype, as the
    reference computes it."""
    dtype = dtype or torch.float32
    dev = x_uint8.device
    x = x_uint8.to(dtype) / torch.tensor(255.0, dtype=dtype, device=dev)
    mean = torch.tensor(mean, dtype=dtype, device=dev)
    std = torch.tensor(std, dtype=dtype, device=dev)
    return (x - mean) / std


def synthetic_image_batches(batch_size: int, image_size: int,
                            num_classes: int, seed: int = 0
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """An endless stream of ``(images, labels)``: uint8
    ``[batch, size, size, 3]`` and int32 ``[batch]``, drawn from
    ``RandomState(seed)`` as the reference draws them."""
    rng = np.random.RandomState(seed)
    while True:
        x = rng.randint(0, 256, size=(batch_size, image_size, image_size, 3),
                        dtype=np.uint8)
        y = rng.randint(0, num_classes, size=(batch_size,)).astype(np.int32)
        yield x, y
