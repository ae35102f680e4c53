"""Data helpers (counterpart of :mod:`apex_tpu.data`): only
``segment_loss_mask``, which the packed 3D GPT step needs, and
``_producer.reap_process``, the fleet's child teardown.  The loaders,
the prefetcher and the packing service are not ported yet (ROADMAP.md,
section A.4)."""

from apex_tpu_torch.data.sequence import segment_loss_mask  # noqa: F401

__all__ = ["segment_loss_mask"]
