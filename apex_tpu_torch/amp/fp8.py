"""FP8 training with delayed scaling (port of :mod:`apex_tpu.amp.fp8`).

The TransformerEngine delayed-scaling recipe, as the JAX package states
it:

- each quantized tensor carries an :class:`Fp8Meta`: ``amax_history
  [H]`` and the current ``scale``;
- quantize: ``q = cast(clip(x * scale, +-fp8_max))``, with the scale
  ``fp8_max / (amax_hist_max * margin)`` taken from *earlier* steps
  (delayed: no extra pass over the data before the GEMM);
- after the GEMM the step's amax rolls into the history
  (:func:`update_meta`);
- gradients are quantized to e5m2 with a *just-in-time* scale from the
  cotangent's own amax: its magnitude follows the loss scale, which can
  jump by 2**16 between steps, where a delayed scale would saturate the
  clip silently.

:func:`fp8_matmul_t` is the one GEMM core (``y = x @ w.T``, ``w [out,
in]``), a :class:`torch.autograd.Function` with two routes.  On CUDA
tensors the three products run on Hopper's fp8 tensor cores through
``torch._scaled_mm`` (e4m3 operands forward; the e5m2 cotangent against
an e4m3 operand backward, since e5m2 x e5m2 is not a supported pair),
with fp32 accumulation (``use_fast_accum=False``) and every dimension
zero-padded to a multiple of 16; the scales stay 0-d fp32 tensors on the
device, so no step syncs with the host.  On CPU tensors the plain version
runs, in the reference's order of operations: quantize, upcast to fp32,
multiply, divide by the product of the scales.  The amax and quantize
passes are plain torch ops on both routes, as they are plain XLA in the
reference: the JAX package computes its fp8 GEMM outside any Pallas
kernel, so no hand-written kernel stands behind this module.

The forward saves the quantized operands (one byte an element) and the
scales it used; the metas are rolled by *replacing* their tensors, never
by writing into them, so a backward always sees its own forward's
scales.

With ``axis=`` (a tensor-parallel axis name, see
:mod:`apex_tpu_torch.parallel`) :func:`update_meta` takes the MAX of
the step's amax over the axis's ranks before it rolls it in, so every
rank of the group keeps the same scales, as the reference's ``pmax``
does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = ["Fp8Meta", "Fp8Dense", "Fp8MetaState", "fp8_quantize",
           "fp8_matmul_t", "update_meta", "E4M3", "E5M2"]

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
_MARGIN = 1.0
# torch._scaled_mm takes every dimension in multiples of this
_ALIGN = 16

# fp8 GEMMs launched on the card (forward; dx and dw of the backward)
# since the counts were last set to 0
FWD_GEMMS = 0
BWD_GEMMS = 0


class Fp8Meta(NamedTuple):
    """Delayed-scaling state for one quantized tensor."""

    amax_history: torch.Tensor  # [H] fp32
    scale: torch.Tensor         # () fp32

    @classmethod
    def init(cls, history_len: int = 16, device=None) -> "Fp8Meta":
        return cls(
            amax_history=torch.zeros(history_len, dtype=torch.float32,
                                     device=device),
            scale=torch.ones((), dtype=torch.float32, device=device))


def _fp8_max(dtype) -> float:
    return float(torch.finfo(dtype).max)


def _max_over(dtype, amax) -> torch.Tensor:
    """``fp8_max / amax`` as one IEEE division, as XLA takes it (torch's
    ``float / tensor`` multiplies by the reciprocal, which is up to 2 ulp
    away)."""
    return torch.full_like(amax, _fp8_max(dtype)) / amax


def _quantize(v, scale, dtype):
    """``cast(clip(v * scale, +-fp8_max))`` in fp32."""
    lim = _fp8_max(dtype)
    return torch.clamp(v.float() * scale, -lim, lim).to(dtype)


def _amax(v) -> torch.Tensor:
    return v.detach().abs().amax().float()


def fp8_quantize(x, meta: Fp8Meta, dtype=E4M3):
    """Quantize with the *delayed* scale; returns ``(q, amax_now)``."""
    return _quantize(x, meta.scale, dtype), _amax(x)


def update_meta(meta: Fp8Meta, amax_now, dtype=E4M3,
                axis: Optional[str] = None) -> Fp8Meta:
    """Roll the amax history and refresh the scale: a new :class:`Fp8Meta`
    (the old one is left as it was).  An amax of 0 keeps the old scale, as
    does a NaN one; an infinite amax gives the scale 0, as in the
    reference.  With ``axis`` the amax is first all-reduced (MAX) over
    that axis's ranks."""
    amax_now = torch.as_tensor(amax_now, dtype=torch.float32,
                               device=meta.scale.device).detach().reshape(())
    if axis is not None:
        from apex_tpu_torch.parallel.collectives import all_reduce

        amax_now = all_reduce(amax_now, axis, "max")
    hist = torch.cat([amax_now[None], meta.amax_history[:-1]])
    amax = hist.max()
    scale = torch.where(amax > 0, _max_over(dtype, amax * _MARGIN),
                        meta.scale)
    return Fp8Meta(amax_history=hist, scale=scale)


def _jit_scale(g) -> torch.Tensor:
    """The cotangent's just-in-time e5m2 scale."""
    g_amax = _amax(g)
    return torch.where(g_amax > 0, _max_over(E5M2, g_amax),
                       torch.ones_like(g_amax))


def _jit_e5m2_f32(g):
    """The cotangent quantized to e5m2 with a just-in-time scale, upcast
    to fp32 and unscaled."""
    g_scale = _jit_scale(g)
    return _quantize(g, g_scale, E5M2).float() / g_scale


# --------------------------------------------------- the card's GEMMs


def _row_major(q):
    """A contiguous copy of the fp8 matrix ``q`` (through its bytes)."""
    if q.is_contiguous():
        return q
    return q.view(torch.uint8).contiguous().view(q.dtype)


def _padded(q, rows: int, cols: int):
    """``q [r, c]`` with zero rows and columns appended to ``[rows,
    cols]`` (the zero byte is +0 in both fp8 formats)."""
    r, c = q.shape
    if (r, c) == (rows, cols):
        return q
    return F.pad(q.view(torch.uint8), (0, cols - c, 0, rows - r)).view(
        q.dtype)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _scaled_mm_t(a, bt, inv_a, inv_b, out_dtype):
    """``(a * inv_a) @ (bt * inv_b).T`` on the fp8 tensor cores, summed in
    fp32: ``a [M, K]`` and ``bt [N, K]`` fp8, ``inv_a``/``inv_b`` 0-d
    fp32.  ``_scaled_mm`` takes its second operand column-major, which
    ``bt.t()`` of a row-major ``bt`` is, and every dimension in multiples
    of 16: the zeros padded in add nothing to the sums, and the padded
    rows and columns of the product are cut off."""
    a, bt = _row_major(a), _row_major(bt)
    (m, k), n = a.shape, bt.shape[0]
    mp, kp, np_ = _up(m), _up(k), _up(n)
    y = torch._scaled_mm(_padded(a, mp, kp), _padded(bt, np_, kp).t(),
                         scale_a=inv_a, scale_b=inv_b, out_dtype=out_dtype,
                         use_fast_accum=False)
    return y[:m, :n]


def _t(q):
    """The transpose of the fp8 matrix ``q``, row-major."""
    return _row_major(q.t())


class _Fp8MatmulT(torch.autograd.Function):
    """``y = x @ w.T`` through e4m3 operands; the backward through an e5m2
    cotangent.  ``card`` picks ``torch._scaled_mm`` or the plain
    version."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, card: bool):
        global FWD_GEMMS
        x2d = x.reshape(-1, x.shape[-1])
        xq = _quantize(x2d, x_scale, E4M3)
        wq = _quantize(w, w_scale, E4M3)
        ctx.save_for_backward(xq, wq, x_scale, w_scale)
        ctx.card, ctx.x_shape = card, x.shape
        ctx.dtypes = (x.dtype, w.dtype)
        if card:
            y = _scaled_mm_t(xq, wq, x_scale.reciprocal(),
                             w_scale.reciprocal(), x.dtype)
            FWD_GEMMS += 1
        else:
            y = ((xq.float() @ wq.float().t())
                 / (x_scale * w_scale)).to(x.dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        global BWD_GEMMS
        xq, wq, x_scale, w_scale = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        g2d = g.reshape(-1, g.shape[-1])                  # [N, out]
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if ctx.card:
            g_scale = _jit_scale(g2d)
            gq, inv_g = _quantize(g2d, g_scale, E5M2), g_scale.reciprocal()
            if need_dx:
                dx = _scaled_mm_t(gq, _t(wq), inv_g, w_scale.reciprocal(),
                                  torch.float32)
                BWD_GEMMS += 1
            if need_dw:
                dw = _scaled_mm_t(_t(gq), _t(xq), inv_g,
                                  x_scale.reciprocal(), torch.float32)
                BWD_GEMMS += 1
        else:
            g32 = _jit_e5m2_f32(g2d)
            if need_dx:
                dx = (g32 @ wq.float()) / w_scale
            if need_dw:
                dw = (g32.t() @ xq.float()) / x_scale
        if dx is not None:
            dx = dx.reshape(ctx.x_shape).to(x_dtype)
        if dw is not None:
            dw = dw.to(w_dtype)
        return dx, dw, None, None, None


def _fp8_matmul_t(x, w, xm: Fp8Meta, wm: Fp8Meta, route: str):
    """:func:`fp8_matmul_t` on a named route: ``"card"``
    (``torch._scaled_mm``; CUDA tensors only) or ``"plain"``."""
    if route not in ("card", "plain"):
        raise ValueError(f"route must be 'card' or 'plain', got {route!r}")
    if route == "card" and not x.is_cuda:
        raise ValueError("the card route of fp8_matmul_t takes CUDA tensors")
    return _Fp8MatmulT.apply(x, w, xm.scale, wm.scale, route == "card")


def fp8_matmul_t(x, w, xm: Fp8Meta, wm: Fp8Meta):
    """``y = x @ w.T`` computed through fp8 with delayed scaling.

    ``x [..., in]``, ``w [out, in]`` (the torch layout the parallel
    linears keep), ``xm``/``wm`` the :class:`Fp8Meta` of each; ``y`` has
    ``x``'s dtype, ``dx`` and ``dw`` the dtypes of ``x`` and ``w``.  Pure
    with respect to the metas: the caller rolls them with
    :func:`update_meta`.  CUDA tensors take the fp8 tensor cores, CPU
    tensors the plain version."""
    return _fp8_matmul_t(x, w, xm, wm, "card" if x.is_cuda else "plain")


# ------------------------------------------------ state and the layer


class _MetaBuffers(nn.Module):
    """One :class:`Fp8Meta` as the buffers ``amax_history`` and ``scale``."""

    def __init__(self, history_len: int, device):
        super().__init__()
        meta = Fp8Meta.init(history_len, device)
        self.register_buffer("amax_history", meta.amax_history)
        self.register_buffer("scale", meta.scale)

    @property
    def meta(self) -> Fp8Meta:
        return Fp8Meta(self.amax_history, self.scale)

    def set(self, meta: Fp8Meta) -> None:
        # new tensors, never written in place: a pending backward keeps
        # the scales its forward saved
        self.amax_history, self.scale = meta


class Fp8MetaState(nn.Module):
    """The delayed-scaling state of one fp8 GEMM: the ``x`` and ``w``
    metas (buffers ``x.amax_history``, ``x.scale``, ``w.amax_history``,
    ``w.scale``), the Flax ``"fp8_meta"`` collection's ``{"metas": {"x",
    "w"}}`` of one layer."""

    def __init__(self, history_len: int = 16, device=None):
        super().__init__()
        self.x = _MetaBuffers(history_len, device)
        self.w = _MetaBuffers(history_len, device)

    def metas(self) -> Dict[str, Fp8Meta]:
        return {"x": self.x.meta, "w": self.w.meta}

    @torch.no_grad()
    def roll(self, x, w, axis: Optional[str] = None) -> None:
        """Roll both metas with this step's amaxes of ``x`` and ``w``
        (their MAX over ``axis`` where given)."""
        self.x.set(update_meta(self.x.meta, _amax(x), E4M3, axis))
        self.w.set(update_meta(self.w.meta, _amax(w), E4M3, axis))


def _lecun_normal_(t) -> None:
    """Flax's ``lecun_normal`` for a ``[fan_in, ...]`` kernel: a normal
    truncated at two deviations, of variance ``1 / fan_in`` after the
    truncation."""
    std = math.sqrt(1.0 / t.shape[0]) / .87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


class Fp8Dense(nn.Module):
    """Dense layer computing through fp8 with delayed scaling.

    ``kernel [in_features, features]`` (Flax's layout, so the JAX layer's
    weights load one to one), ``lecun_normal``-initialised from torch's
    global generator, and ``bias [features]`` zero.  The metas live in
    :attr:`fp8_meta` (:class:`Fp8MetaState` buffers, in ``state_dict()``)
    and roll after the GEMM in ``training`` mode only: an ``eval()``
    forward leaves them as they were, as the reference's ``apply`` without
    a mutable ``"fp8_meta"`` does; with ``axis`` their amaxes are shared
    (MAX) over that axis's ranks.  ``device`` defaults to the CUDA
    device."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, history_len: int = 16,
                 axis: Optional[str] = None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.features = features
        self.axis = axis
        self.kernel = nn.Parameter(torch.empty(
            in_features, features, dtype=param_dtype, device=device))
        _lecun_normal_(self.kernel.data)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.fp8_meta = Fp8MetaState(history_len, device)

    def forward(self, x):
        x2d = x.reshape(-1, x.shape[-1])
        m = self.fp8_meta.metas()
        y = fp8_matmul_t(x2d, self.kernel.t(), m["x"], m["w"])
        if self.training:
            self.fp8_meta.roll(x2d, self.kernel, self.axis)
        y = y.reshape(*x.shape[:-1], self.features)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
