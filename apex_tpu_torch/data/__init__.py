"""Input pipelines (counterpart of :mod:`apex_tpu.data`), layered as the
reference's:

- **decode** — :class:`ImageFolderLoader` with a selectable worker
  backend (``backend="process"``, spawned workers, or ``"thread"``),
  per-rank ``dp_ranks`` index sharding, the native libjpeg decode
  (``_native/jpegdec.c``, built with ``cc`` at first use) falling back to
  PIL per image, and uint8 batches normalized on the card inside the step;
- **decode-free** — :mod:`apex_tpu_torch.data.packed` packs the dataset
  once into a memory-mapped uint8 shard (the reference's file format, so
  either package reads the other's), cropped and flipped on the card;
  :mod:`apex_tpu_torch.data.sequence` is the LM twin: pre-tokenized,
  length-packed sequence shards with segment ids for the GPT trainers;
- **transfer** — :func:`prefetch_to_device` double-buffers the
  host->device copies on a dedicated thread through pinned memory and a
  side CUDA stream, recording the residual ``data/stall_ms``;
- **service** — :class:`DataService` moves the whole loader into a
  spawned process feeding the trainer over a bounded queue.

All layers carry GLOBAL ``consumed_samples`` for exact mid-epoch resume
through ``resilience.CheckpointManager``.  Importing this package
imports no torch (the functions that run on the card import it), so a
spawned decode worker starts without it.
"""

from apex_tpu_torch.data.image_folder import (
    ImageFolder,
    ImageFolderLoader,
    center_crop_resize,
    normalize_on_device,
    random_resized_crop,
    sample_crop_box,
    synthetic_image_batches,
)
from apex_tpu_torch.data.packed import (
    PackedImageDataset,
    PackedLoader,
    pack_image_folder,
)
from apex_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device
from apex_tpu_torch.data.sequence import (
    PackedSequenceDataset,
    PackedSequenceLoader,
    pack_token_documents,
    segment_loss_mask,
    synthetic_token_documents,
)
from apex_tpu_torch.data.service import DataService

__all__ = [
    "DataService",
    "DevicePrefetcher",
    "ImageFolder",
    "ImageFolderLoader",
    "PackedImageDataset",
    "PackedLoader",
    "PackedSequenceDataset",
    "PackedSequenceLoader",
    "center_crop_resize",
    "normalize_on_device",
    "pack_image_folder",
    "pack_token_documents",
    "prefetch_to_device",
    "random_resized_crop",
    "sample_crop_box",
    "segment_loss_mask",
    "synthetic_image_batches",
    "synthetic_token_documents",
]
