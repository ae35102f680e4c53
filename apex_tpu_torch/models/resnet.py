"""ResNet (port of :mod:`apex_tpu.models.resnet`), the ImageNet workload.

Activations are ``N, C, H, W`` tensors in ``torch.channels_last`` memory,
the reference's NHWC.  The norm layer is
:class:`~apex_tpu_torch.parallel.SyncBatchNorm` (``axis_name="dp"`` makes
it synchronized; ``None`` is local BN), composed as in the reference:
BN + ReLU after each inner convolution, and BN + residual + ReLU at the
end of a block.

The modules carry the Flax module names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>/Conv_<j>``, ``SyncBatchNorm_<j>``, ``conv_proj``,
``bn_proj``, ``head``), so that the amp policies' name patterns keep the
BN parameters fp32 under O2 as they do in the reference, and so that
:func:`from_flax_resnet` / :func:`to_flax_resnet` carry weights across.

Two places where plain PyTorch differs from Flax:

- **padding.**  Flax's ``padding="SAME"`` pads asymmetrically for a
  stride of 2 (the low side ``total // 2``): (2, 3) for the 7x7 stem and
  (0, 1) for a 3x3/2 on an even size, and ``max_pool(..., "SAME")`` pads
  (0, 1) with -inf.  ``F.conv2d(padding=3)`` and ``F.max_pool2d(
  padding=1)`` pad symmetrically and give other numbers.  The pads here
  are computed from the input size as XLA computes them, and an uneven
  pair is applied with ``F.pad`` before a convolution of padding 0;
- **the head.**  The spatial mean is taken in fp32 and rounded to the
  activations' dtype (``jnp.mean`` of a bf16 array), and the classifier
  is an fp32 product whatever its parameters' dtype (``nn.Dense(dtype=
  float32)``).

Weights come from a seed (:meth:`ResNet.reset_parameters`: LeCun-normal
convolutions and head, as Flax's defaults; BN scale 1 and bias 0) or
from a Flax checkpoint.  No kernel of the reference lies here: the
convolutions are ``F.conv2d`` (cuDNN on the card).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["ResNet", "ResNet18", "ResNet50", "ResNet101", "BasicBlock",
           "BottleneckBlock", "same_pads", "from_flax_resnet",
           "to_flax_resnet"]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(low, high)`` with
    ``low = total // 2``, so an odd total puts the extra element high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_args(x: torch.Tensor, kernel: int, stride: int):
    """``(padding for the op, pads for F.pad or None)``: a symmetric pair
    goes to the op itself, an uneven one to ``F.pad``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], kernel, stride),
                          same_pads(x.shape[3], kernel, stride))
    if hl == hh and wl == wh:
        return (hl, wl), None
    return (0, 0), (wl, wh, hl, hh)


class Conv(nn.Module):
    """A bias-free ``kernel x kernel`` convolution with ``"SAME"``
    padding, computed in ``dtype`` (the Flax ``nn.Conv(use_bias=False,
    dtype=...)``).  ``weight`` is ``[out, in, kh, kw]``."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel, kernel,
            device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding, pads = _pad_args(x, self.kernel, self.stride)
        x = x.to(self.dtype)
        if pads is not None:
            x = F.pad(x, pads)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=padding)


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: the pad
    is -inf, uneven pads high."""
    padding, pads = _pad_args(x, kernel, stride)
    if pads is not None:
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride, padding=padding)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions; a 1x1 projection of the input where the
    shape changes."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 axis_name=None, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        conv = partial(Conv, dtype=dtype, device=device)
        bn = partial(SyncBatchNorm, axis_name=axis_name, device=device)
        self.Conv_0 = conv(in_features, features, 3, strides)
        self.SyncBatchNorm_0 = bn(features, fuse_relu=True)
        self.Conv_1 = conv(features, features, 3)
        if strides != 1 or in_features != features:
            self.conv_proj = conv(in_features, features, 1, strides)
            self.bn_proj = bn(features)
        self.SyncBatchNorm_1 = bn(features, fuse_relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.SyncBatchNorm_0(self.Conv_0(x))
        y = self.Conv_1(y)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(self.conv_proj(x))
        return self.SyncBatchNorm_1(y, z=residual)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``4 * features``; a 1x1 projection of
    the input where the shape changes."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 axis_name=None, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        conv = partial(Conv, dtype=dtype, device=device)
        bn = partial(SyncBatchNorm, axis_name=axis_name, device=device)
        out = features * 4
        self.Conv_0 = conv(in_features, features, 1)
        self.SyncBatchNorm_0 = bn(features, fuse_relu=True)
        self.Conv_1 = conv(features, features, 3, strides)
        self.SyncBatchNorm_1 = bn(features, fuse_relu=True)
        self.Conv_2 = conv(features, out, 1)
        if strides != 1 or in_features != out:
            self.conv_proj = conv(in_features, out, 1, strides)
            self.bn_proj = bn(out)
        self.SyncBatchNorm_2 = bn(out, fuse_relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.SyncBatchNorm_0(self.Conv_0(x))
        y = self.SyncBatchNorm_1(self.Conv_1(y))
        y = self.Conv_2(y)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(self.conv_proj(x))
        return self.SyncBatchNorm_2(y, z=residual)


class ResNet(nn.Module):
    """A ResNet of ``stage_sizes`` blocks of ``block_cls`` per stage.

    ``axis_name="dp"`` synchronizes every BN over the data-parallel ranks
    (the reference's ``--sync_bn``); ``dtype`` is the compute dtype of
    the convolutions (the parameters are fp32 until an amp policy casts
    them).  ``forward(x)`` takes ``[N, 3, H, W]`` images and returns fp32
    logits; in ``train()`` mode the BN layers normalize with the batch's
    statistics and update their running ones.  The model is built on
    ``device``, the card unless the caller names another (``"cpu"``);
    so are its blocks, convolutions and BN layers built alone."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 axis_name: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device=None, seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv_init = Conv(in_channels, num_filters, 7, 2, dtype=dtype,
                              device=device)
        self.bn_init = SyncBatchNorm(num_filters, axis_name=axis_name,
                                     fuse_relu=True, device=device)
        features = num_filters
        index = 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                block = block_cls(
                    features, num_filters * 2 ** i,
                    strides=2 if i > 0 and j == 0 else 1,
                    axis_name=axis_name, dtype=dtype, device=device)
                self.add_module(f"{block_cls.__name__}_{index}", block)
                features = num_filters * 2 ** i * block_cls.expansion
                index += 1
        self.head = nn.Linear(features, num_classes, device=device)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Seeded weights: convolutions and head LeCun-normal (truncated
        at two standard deviations, variance ``1 / fan_in``), head bias 0,
        BN scale 1 and bias 0, running mean 0 and variance 1."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() > 1:
                fan_in = math.prod(p.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                cpu = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                p.copy_(cpu)
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)

    def blocks(self):
        return [m for name, m in self.named_children()
                if name.startswith(("BasicBlock_", "BottleneckBlock_"))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn_init(self.conv_init(x))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks():
            x = block(x)
        x = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


def ResNet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock,
                  **kw)


def _to_torch(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def from_flax_resnet(variables) -> dict:
    """The state dict of the port's :class:`ResNet` from the Flax model's
    ``variables`` (``{"params": ..., "batch_stats": ...}``, leaves torch
    tensors, numpy or anything ``numpy.asarray`` reads): conv kernels
    HWIO to OIHW, the Dense kernel transposed, BN ``scale``/``bias`` and
    the running statistics by the Flax module names.  The dtypes are
    kept (an O2 tree keeps its bf16 kernels)."""
    state = {}
    for path, leaf in _walk(variables["params"]):
        *mods, name = path
        t = _to_torch(leaf)
        if name == "kernel" and t.dim() == 4:
            state[".".join(mods + ["weight"])] = t.permute(3, 2, 0, 1)
        elif name == "kernel":
            state[".".join(mods + ["weight"])] = t.t()
        else:
            state[".".join(path)] = t
    for path, leaf in _walk(variables.get("batch_stats", {})):
        state[".".join(path)] = _to_torch(leaf)
    return {k: v.contiguous() for k, v in state.items()}


def to_flax_resnet(state: dict) -> dict:
    """The inverse of :func:`from_flax_resnet`: ``{"params": ...,
    "batch_stats": ...}`` nested by the Flax module names, with the Flax
    layouts (HWIO kernels, ``[in, out]`` Dense).  The leaves are CPU
    tensors of the state's dtypes, as the port's ``save_checkpoint``
    takes them (numpy has no bf16: ``t.float().numpy()`` is an exact
    copy of a bf16 leaf)."""
    out = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *mods, name = key.split(".")
        if name in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", t
        elif name == "weight" and t.dim() == 4:
            coll, name, leaf = "params", "kernel", t.permute(2, 3, 1, 0)
        elif name == "weight":
            coll, name, leaf = "params", "kernel", t.t()
        else:
            coll, leaf = "params", t
        node = out[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = leaf.detach().to("cpu", copy=True).contiguous()
    return out
