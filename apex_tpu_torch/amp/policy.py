"""Precision policies, the O0-O3 opt levels (port of
:mod:`apex_tpu.amp.policy`).

- ``O0``: everything fp32;
- ``O1``: fp32 parameters, half compute at module boundaries;
- ``O2``: half parameters except norms (kept fp32), fp32 master weights,
  dynamic loss scaling;
- ``O3``: parameters and compute all half, no master weights.

The default half dtype is bf16; fp16 activates dynamic loss scaling in
O1 too.  A policy casts trees (:mod:`apex_tpu_torch.amp._tree`) of
tensors.  The norm exemption matches names: a leaf whose path holds a
string component containing one of :data:`NORM_PATH_PATTERNS`
(case-insensitive) is a norm parameter.  For a torch module, apply the
policy to ``dict(module.named_parameters())``: its keys carry the module
names (``...encoder.final_layernorm.scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from apex_tpu_torch.amp._tree import tree_map_with_path

__all__ = [
    "Policy",
    "policy",
    "O0",
    "O1",
    "O2",
    "O3",
    "cast_floating",
    "cast_to_compute",
    "cast_to_param",
    "cast_to_output",
]

# substrings of a path component that mark a norm parameter (the
# keep_batchnorm_fp32 exemption)
NORM_PATH_PATTERNS = (
    "batchnorm",
    "batch_stats",
    "layernorm",
    "layer_norm",
    "rmsnorm",
    "rms_norm",
    "groupnorm",
    "group_norm",
    "_bn",
    "bn_",
    "norm",
)


def _path_is_norm(path) -> bool:
    return any(isinstance(name, str)
               and any(pat in name.lower() for pat in NORM_PATH_PATTERNS)
               for name in path)


def cast_floating(tree, dtype: torch.dtype, *,
                  except_norms_to: torch.dtype = None):
    """Every floating-point tensor of ``tree`` cast to ``dtype``; other
    leaves (integer labels, bool masks) pass through, and a Python float
    becomes a 0-d CPU tensor of that dtype.  With ``except_norms_to``,
    norm leaves (by path) go to that dtype instead."""

    def cast(path, x):
        target = dtype
        if except_norms_to is not None and _path_is_norm(path):
            target = except_norms_to
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(target)
        if isinstance(x, float):
            return torch.tensor(x, dtype=target)
        return x

    return tree_map_with_path(cast, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Where each dtype is used: ``param_dtype`` (amp's
    ``cast_model_type``), ``compute_dtype``, ``output_dtype``,
    ``norm_dtype`` (``keep_batchnorm_fp32``), ``master_weights`` and
    ``loss_scale`` ("dynamic", a float, or None)."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    norm_dtype: torch.dtype
    master_weights: bool
    loss_scale: Union[str, float, None]

    def cast_to_compute(self, tree):
        return cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        """Parameters to ``param_dtype``, norm parameters to
        ``norm_dtype``."""
        if self.norm_dtype != self.param_dtype:
            return cast_floating(tree, self.param_dtype,
                                 except_norms_to=self.norm_dtype)
        return cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return cast_floating(tree, self.output_dtype)

    def with_options(self, **kw) -> "Policy":
        """Fields overridden, as ``amp.initialize``'s keywords."""
        return dataclasses.replace(self, **kw)

    @property
    def uses_half_params(self) -> bool:
        return self.param_dtype != torch.float32


def _make(name: str, half: torch.dtype) -> Policy:
    f32 = torch.float32
    fields = {
        "O0": dict(param_dtype=f32, compute_dtype=f32, output_dtype=f32,
                   norm_dtype=f32, master_weights=False, loss_scale=None),
        "O1": dict(param_dtype=f32, compute_dtype=half, output_dtype=f32,
                   norm_dtype=f32, master_weights=False,
                   loss_scale="dynamic" if half == torch.float16 else None),
        "O2": dict(param_dtype=half, compute_dtype=half, output_dtype=f32,
                   norm_dtype=f32, master_weights=True, loss_scale="dynamic"),
        "O3": dict(param_dtype=half, compute_dtype=half, output_dtype=half,
                   norm_dtype=half, master_weights=False, loss_scale=1.0),
    }[name]
    return Policy(name=name, **fields)


def policy(opt_level: str = "O1",
           half_dtype: torch.dtype = torch.bfloat16) -> Policy:
    """The policy of an Apex opt level, with ``half_dtype`` bf16 (the
    default) or fp16."""
    if opt_level not in ("O0", "O1", "O2", "O3"):
        raise ValueError(
            f"unknown opt_level {opt_level!r}; expected one of O0, O1, O2, "
            "O3 (reference: apex/amp/frontend.py:104)")
    return _make(opt_level, half_dtype)


O0 = policy("O0")
O1 = policy("O1")
O2 = policy("O2")
O3 = policy("O3")


def cast_to_compute(tree, p: Policy):
    return p.cast_to_compute(tree)


def cast_to_param(tree, p: Policy):
    return p.cast_to_param(tree)


def cast_to_output(tree, p: Policy):
    return p.cast_to_output(tree)
