"""Data helpers (counterpart of :mod:`apex_tpu.data`): the synthetic
ImageNet-shaped batches and the on-device normalization of
:mod:`apex_tpu_torch.data.image_folder`, ``segment_loss_mask``, which the
packed 3D GPT step needs, and ``_producer.reap_process``, the fleet's
child teardown.  The folder loader, the packed shards, the prefetcher and
the data service are not ported yet (ROADMAP.md, section A.4)."""

from apex_tpu_torch.data.image_folder import (  # noqa: F401
    normalize_on_device,
    synthetic_image_batches,
)
from apex_tpu_torch.data.sequence import segment_loss_mask  # noqa: F401

__all__ = ["normalize_on_device", "segment_loss_mask",
           "synthetic_image_batches"]
