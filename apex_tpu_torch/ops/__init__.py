"""Attention, loss and norm ops (port of :mod:`apex_tpu.ops`): flash
attention with its CUDA kernels, the fused softmax cross entropy, the
scale/mask softmax family of :mod:`apex_tpu_torch.ops.softmax` with the
attention mask enum, and the row LayerNorm/RMSNorm kernels of
:mod:`apex_tpu_torch.ops.pallas_norm`.  As in the JAX package,
``flash_attention`` here is the function; its module is
``importlib.import_module("apex_tpu_torch.ops.flash_attention")``.
Importing builds nothing: each kernel is built at its first launch."""

from apex_tpu_torch.ops import pallas_norm, softmax  # noqa: F401
from apex_tpu_torch.ops.softmax import (  # noqa: F401
    AttnMaskType,
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss  # noqa: F401
from apex_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
)
