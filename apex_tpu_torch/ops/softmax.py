"""The attention mask enum of :mod:`apex_tpu.ops.softmax`.

The fused scale/mask softmax family of that module is not ported yet (the
port's attention core runs the flash kernels only)."""

import enum

__all__ = ["AttnMaskType"]


class AttnMaskType(enum.Enum):
    """``apex/transformer/enums.py`` AttnMaskType."""

    padding = 1
    causal = 2
