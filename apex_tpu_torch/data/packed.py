"""Packed (decode-free) image input path — pack once, memcpy at train time
(port of :mod:`apex_tpu.data.packed`).

Role in the reference lineage: the apex imagenet recipe's answer to an
input-bound loader is more DataLoader workers and ultimately DALI
(``examples/imagenet/main_amp.py:207-232``).  Both scale *decode*
horizontally.  The packed path moves decode out of the training job
entirely: preprocess the dataset once into a fixed-shape array shard,
then the per-step host work is a fancy-index gather out of a
memory-mapped uint8 array — pure memcpy, no codec — and the
*augmentation* runs on the card inside the step (:func:`random_crop_flip`,
then :func:`~apex_tpu_torch.data.image_folder.normalize_on_device`).

Format (``<prefix>.data`` + ``<prefix>.labels.npy`` + ``<prefix>.json``),
the reference's byte for byte, so either package reads the other's
shards:

- ``.data``  — raw uint8, shape [N, side, side, 3] (NHWC, C-order);
- ``.labels.npy`` — int32 [N];
- ``.json`` — {"n", "side", "classes", "version"} metadata.

Records are stored at ``side`` (default 232 — slightly larger than the
224 train crop) so the on-device random crop retains translation
augmentation; RandomResizedCrop's scale/aspect jitter is traded away
(decode-free means fixed-shape records).

The reference draws the crop offsets and flips from ``jax.random``
inside its jitted step.  The port splits the augmentation in two:
:func:`draw_crop_flip` draws them from an explicit ``torch.Generator``
on the batch's device, and :func:`apply_crop_flip` crops, flips and
normalizes from given offsets and flips with one gather on the card —
no host sync anywhere.

The producer/prefetch machinery (bounded queue, per-iteration state,
preemption + rewind contracts) lives in
:mod:`apex_tpu_torch.data._producer` and is shared with the LM-side
:class:`~apex_tpu_torch.data.sequence.PackedSequenceLoader`.  This module
imports torch only inside the on-device functions.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from apex_tpu_torch.data._producer import ProducerLoader
from apex_tpu_torch.data.image_folder import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageFolder,
    center_crop_resize,
    normalize_on_device,
)

__all__ = [
    "PackedImageDataset",
    "PackedLoader",
    "apply_crop_flip",
    "center_crop",
    "draw_crop_flip",
    "pack_image_folder",
    "random_crop_flip",
]


def pack_image_folder(root_or_dataset, out_prefix: str, side: int = 232,
                      workers: int = 8, resize: Optional[int] = None
                      ) -> "PackedImageDataset":
    """Decode an ImageFolder tree once into a packed array shard.

    Each image is center-crop-resized to ``side``x``side`` uint8 (the
    deterministic eval transform — augmentation happens on-device at
    train time) and appended to ``<out_prefix>.data``.  ``resize``
    forwards to :func:`center_crop_resize` (default: the reference's
    256/224-proportional pre-resize for ``side``); an **eval** shard
    packed at ``side == image_size`` is therefore pixel-identical to the
    online JPEG eval transform.  Decode fans out over ``workers`` PIL
    threads; packing is a one-time cost, so the online loader's native
    JPEG fast path is not plumbed through here.
    """
    from concurrent.futures import ThreadPoolExecutor

    ds = (root_or_dataset if isinstance(root_or_dataset, ImageFolder)
          else ImageFolder(root_or_dataset))
    n = len(ds)
    if n == 0:
        raise ValueError("empty dataset")
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    # raw file (not .npy): the loader memmaps with an explicit shape from
    # the sidecar json, and raw bytes keep the format trivially
    # inspectable/appendable for sharded packers.
    mm = np.memmap(out_prefix + ".data", dtype=np.uint8, mode="w+",
                   shape=(n, side, side, 3))
    labels = np.empty((n,), np.int32)

    def one(i: int) -> None:
        img, label = ds.load(i)
        mm[i] = center_crop_resize(img, side, resize)
        labels[i] = label

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(one, range(n)))
    mm.flush()
    del mm
    np.save(out_prefix + ".labels.npy", labels)
    with open(out_prefix + ".json", "w") as f:
        json.dump({"n": n, "side": side, "classes": ds.classes,
                   "version": 1}, f)
    return PackedImageDataset(out_prefix)


class PackedImageDataset:
    """Memory-mapped view over a packed shard (see module docstring)."""

    def __init__(self, prefix: str):
        with open(prefix + ".json") as f:
            meta = json.load(f)
        if meta.get("version") != 1:
            raise ValueError(f"unknown packed format version: {meta}")
        self.side = int(meta["side"])
        self.classes = list(meta["classes"])
        self._n = int(meta["n"])
        self.images = np.memmap(prefix + ".data", dtype=np.uint8, mode="r",
                                shape=(self._n, self.side, self.side, 3))
        self.labels = np.load(prefix + ".labels.npy")
        if self.labels.shape != (self._n,):
            raise ValueError(
                f"labels shape {self.labels.shape} != ({self._n},)")

    def __len__(self) -> int:
        return self._n


class PackedLoader(ProducerLoader):
    """DP-sharded train iterator over a :class:`PackedImageDataset`.

    Same surface and contracts as
    :class:`~apex_tpu_torch.data.image_folder.ImageFolderLoader` — yields
    ``(uint8 [B, side, side, 3], int32 [B])`` with
    ``B = local_batch * len(dp_ranks)`` and ``dp_ranks[i]``'s shard at
    rows ``[i*local : (i+1)*local]``, Megatron-sampler epoch shuffling,
    GLOBAL ``consumed_samples`` mid-epoch resume, context-manager
    ``close()``, per-host ``dp_ranks`` input sharding — so
    ``prefetch_to_device`` and the examples compose unchanged.  The
    producer is a single background thread
    (:class:`~apex_tpu_torch.data._producer.ProducerLoader`): per batch it
    fancy-indexes the memmap (gather-memcpy, no codec), which one core
    sustains at chip rate; ``prefetch`` bounds the queue.

    Batches are full ``side``-sized records; run
    :func:`random_crop_flip` (train) or :func:`center_crop` (eval)
    on the card inside the step.
    """

    def __init__(self, dataset: PackedImageDataset, local_batch: int,
                 data_parallel_size: int = 1, consumed_samples: int = 0,
                 seed: int = 0, prefetch: int = 2, dp_ranks=None):
        super().__init__(
            total_samples=len(dataset), local_batch=local_batch,
            data_parallel_size=data_parallel_size,
            consumed_samples=consumed_samples, seed=seed,
            prefetch=prefetch, dp_ranks=dp_ranks)
        self.dataset = dataset

    def _gather(self, idx_per_rank) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.concatenate(idx_per_rank)
        # single fancy-index: one gather-memcpy out of the page cache
        return (self.dataset.images[idx],
                self.dataset.labels[idx].astype(np.int32))


# ---------------------------------------------------------------------------
# On-device augmentation (no host sync; runs first in the train step)
# ---------------------------------------------------------------------------

def draw_crop_flip(batch: int, margin: int, generator, device=None):
    """Per-example crop offsets and flips for :func:`apply_crop_flip`:
    ``(off_h, off_w, flip)``, int64 ``[batch]`` offsets uniform in
    ``[0, margin]`` and a bool ``[batch]`` flip with probability 1/2,
    drawn from ``generator`` on its device (the reference draws the same
    distributions from ``jax.random``)."""
    import torch

    device = generator.device if device is None else device
    off_h = torch.randint(0, margin + 1, (batch,), generator=generator,
                          device=device)
    off_w = torch.randint(0, margin + 1, (batch,), generator=generator,
                          device=device)
    flip = torch.rand((batch,), generator=generator, device=device) < 0.5
    return off_h, off_w, flip


def apply_crop_flip(images_u8, off_h, off_w, flip, out_size: int,
                    mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=None):
    """Crop ``images_u8`` (uint8 ``[B, S, S, C]``) at the given per-example
    offsets to ``out_size``, mirror the rows whose ``flip`` is set, and
    normalize: the reference's ``dynamic_slice`` + ``where(flip,
    crop[:, ::-1], crop)`` + :func:`normalize_on_device`, as one uint8
    gather on the images' device followed by the normalize."""
    import torch

    dev = images_u8.device
    b = images_u8.shape[0]
    ar = torch.arange(out_size, device=dev)
    rows = off_h.to(dev)[:, None] + ar                       # [B, out]
    cols = torch.where(flip.to(dev)[:, None], out_size - 1 - ar, ar)
    cols = off_w.to(dev)[:, None] + cols                     # [B, out]
    bidx = torch.arange(b, device=dev)[:, None, None]
    crop = images_u8[bidx, rows[:, :, None], cols[:, None, :]]
    # same arithmetic as the online path so --packed is not a numerics
    # A/B confounder
    return normalize_on_device(crop, mean, std, dtype)


def random_crop_flip(images_u8, generator, out_size: int,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=None):
    """Per-example random crop + horizontal flip + normalize, on the
    images' device (the reference's ``random_crop_flip(images_u8, key,
    out_size)`` with a ``torch.Generator`` on that device in place of the
    key).

    ``images_u8``: uint8 [B, S, S, 3] from :class:`PackedLoader`;
    returns normalized [B, out_size, out_size, 3] in ``dtype`` (default
    fp32), whose ``permute(0, 3, 1, 2)`` is the model's channels-last
    input.  Runs under the ``data/augment`` profiler range and makes no
    host sync: the draws stay on the device."""
    from apex_tpu_torch.observability.spans import named_span

    b, s = images_u8.shape[0], images_u8.shape[1]
    margin = s - out_size
    if margin < 0:
        raise ValueError(f"out_size {out_size} > stored side {s}")
    with named_span("data/augment"):
        off_h, off_w, flip = draw_crop_flip(b, margin, generator,
                                            images_u8.device)
        return apply_crop_flip(images_u8, off_h, off_w, flip, out_size,
                               mean, std, dtype)


def center_crop(images_u8, out_size: int, mean=IMAGENET_MEAN,
                std=IMAGENET_STD, dtype=None):
    """Deterministic eval transform: center crop + normalize, on the
    images' device."""
    s = images_u8.shape[1]
    off = (s - out_size) // 2
    if off < 0:
        raise ValueError(f"out_size {out_size} > stored side {s}")
    crop = images_u8[:, off:off + out_size, off:off + out_size, :]
    return normalize_on_device(crop, mean, std, dtype)
