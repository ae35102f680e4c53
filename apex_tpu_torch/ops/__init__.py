"""Attention, loss and norm ops (port of :mod:`apex_tpu.ops`): flash
attention with its CUDA kernels, the fused softmax cross entropy, the
scale/mask softmax family of :mod:`apex_tpu_torch.ops.softmax` with the
attention mask enum, and the row LayerNorm/RMSNorm kernels of
:mod:`apex_tpu_torch.ops.pallas_norm`."""

from apex_tpu_torch.ops import pallas_norm, softmax  # noqa: F401
