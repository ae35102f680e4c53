"""Transformer enums (port of :mod:`apex_tpu.transformer.enums`).

``AttnMaskType`` is defined once in :mod:`apex_tpu_torch.ops.softmax` and
re-exported here at the reference's path."""

import enum

from apex_tpu_torch.ops.softmax import AttnMaskType

__all__ = ["LayerType", "AttnType", "AttnMaskType", "ModelType"]


class LayerType(enum.Enum):
    """``apex/transformer/enums.py`` LayerType."""

    encoder = 1
    decoder = 2


class AttnType(enum.Enum):
    """``apex/transformer/enums.py`` AttnType."""

    self_attn = 1
    cross_attn = 2


class ModelType(enum.Enum):
    """``apex/transformer/enums.py`` ModelType (the encoder/decoder split
    of T5-style pipelines)."""

    encoder_or_decoder = 1
    encoder_and_decoder = 2
