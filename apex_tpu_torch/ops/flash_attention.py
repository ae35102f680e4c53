"""Flash attention with a custom backward: the CUDA kernels and their plain
PyTorch versions.

Port of :mod:`apex_tpu.ops.flash_attention`, with the same layouts and
semantics::

    q, k, v:  [batch, heads, seq, head_dim]   (k and v share their shape)
    out:      q's shape and dtype
    lse:      [batch, heads, sq] fp32  (-1e30 for a row that sees no key)
    segment_ids_q / segment_ids_kv:  [batch, s] int (>= 0)

Three kernels carry it, F1-F3 of the port (``csrc/flash_attention.cu``;
the source's note says how they are built):

- F1, the forward (``flash_attention_with_lse``): blockwise online softmax,
  returning ``(out, lse)``.  It has two routes, chosen by
  :func:`fwd_route` from the operands' dtype and shape: ``"tc"``, the
  Hopper tensor-core kernel (wgmma, TMA, an mbarrier ring; bf16 q, k, v,
  head dim a multiple of 8 up to 128), and ``"simt"``, the CUDA-core
  kernel, for fp32 (exact fp32) and the head dims the first does not
  take.  A failed build or launch on either raises;
- F2, ``dq_chunk``: dq from ``(q, k, v, do, lse, delta)``;
- F3, ``dkv_chunk``: dk and dv over the transposed blocking.

F2 and F3 have the same two routes, chosen together by :func:`bwd_route`
from ``q, k, v, do``: ``"tc"`` (bf16, head dim a multiple of 8 up to 128)
and ``"simt"`` for the rest.  On the tc route dk and dv are fp32 sums in
the tensor cores' order, so they differ from the simt route's (which are
bit-identical to the plain version's in bf16) within the rounding of
their bf16 outputs; the rounding points are the same.

:class:`FlashAttentionFunction` ties them together as the JAX
``custom_vjp`` does: it saves ``(q, k, v, segments, seed, out, lse)``,
computes ``delta = sum(do * out)`` in fp32 and calls F2 and F3.  On CUDA
tensors each wrapper launches its kernel; on CPU tensors it runs the plain
version beside it (:func:`flash_fwd_plain`, :func:`flash_dq_plain`,
:func:`flash_dkv_plain`), which repeats the TPU kernels' arithmetic: the
forward sweeps K/V in blocks of 512 with the same online rescale,
and every bf16 rounding point of the TPU kernels is kept (P to V's dtype
before P.V, dS to K's dtype for dq and to Q's dtype for dk, the dropped P
to dO's dtype for dv, outputs in the input dtype).

Masks: ``causal`` compares global positions ``q_offset + row`` and
``kv_offset + col``; segment ids mask attention across segments; a row
that sees no key gets output 0 and lse -1e30.  Attention dropout is the
JAX package's counter hash (murmur3 over seed, batch*heads, row, col),
bit for bit, so the same seed drops the same entries on both sides;
``l`` sums the undropped probabilities.  The seed is an int32 (a Python
int or a one-element tensor, which may live on the card).

The plain versions sweep K/V in blocks of the JAX package's default
``block_k`` (512); the CUDA kernels tile by 64.  The entry points take the
JAX package's ``block_q`` / ``block_k`` in the same places and validate
them (:func:`resolve_default_blocks`), as tiling hints that neither the
kernels nor the plain versions use.
"""

from __future__ import annotations

import numbers
from typing import Optional

import torch

from apex_tpu_torch import _build

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "dq_chunk",
    "dkv_chunk",
    "FlashAttentionFunction",
    "flash_fwd_plain",
    "flash_dq_plain",
    "flash_dkv_plain",
    "keep_mask",
    "fwd_route",
    "bwd_route",
    "resolve_default_blocks",
]

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512
_LANES = 128
_M32 = 0xFFFFFFFF

# launches of each kernel since the count was last set to 0; each total
# is also counted per route
FWD_LAUNCHES = 0
FWD_TC_LAUNCHES = 0
FWD_SIMT_LAUNCHES = 0
DQ_LAUNCHES = 0
DQ_TC_LAUNCHES = 0
DQ_SIMT_LAUNCHES = 0
DKV_LAUNCHES = 0
DKV_TC_LAUNCHES = 0
DKV_SIMT_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _resolve(scale: Optional[float], d: int) -> float:
    return (1.0 / (d ** 0.5)) if scale is None else scale


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_default_blocks(block_q=None, block_k=None):
    """``(block_q, block_k)`` with an unset one at the JAX package's default
    (256, 512); raise unless each is a positive int.  The port's kernels
    tile by 64 and its plain versions sweep in blocks of
    ``DEFAULT_BLOCK_K`` whatever is given."""
    block_q = DEFAULT_BLOCK_Q if block_q is None else block_q
    block_k = DEFAULT_BLOCK_K if block_k is None else block_k
    for name, x in (("block_q", block_q), ("block_k", block_k)):
        if (isinstance(x, bool) or not isinstance(x, numbers.Integral)
                or x <= 0):
            raise ValueError(f"{name} must be a positive int, got {x!r}")
    return block_q, block_k


def _seed_tensor(dropout_seed, device) -> torch.Tensor:
    if dropout_seed is None:
        raise ValueError(
            "dropout_rate > 0 requires an explicit dropout_seed (vary it "
            "per training step; a silent constant seed would drop the same "
            "attention entries forever)")
    return torch.as_tensor(dropout_seed, dtype=torch.int32,
                           device=device).reshape(1)


def _segments(seg_q, seg_k, b, sq, sk, device):
    """Both segment-id arrays as int32 ``[b, s]``, or ``(None, None)``; a
    missing side is all zeros, as in the JAX package."""
    if seg_q is None and seg_k is None:
        return None, None
    if seg_q is None:
        seg_q = torch.zeros((b, sq), dtype=torch.int32, device=device)
    if seg_k is None:
        seg_k = torch.zeros((b, sk), dtype=torch.int32, device=device)
    return seg_q.to(torch.int32), seg_k.to(torch.int32)


# ------------------------------------------------------ dropout keep mask


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the product is
    split at bit 16 so no intermediate leaves int64's range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x):
    """murmur3 finaliser on uint32 values held in int64 (torch has no
    uint32 shift on the CPU)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _thresh(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def keep_mask(seed, bh, rows, cols, rate: float):
    """The JAX package's ``_keep_mask``: keep ``(row, col)`` of head row
    ``bh`` (``batch * heads + head``) iff its hash reaches the threshold.

    ``seed``: int32 scalar tensor; ``bh``: int64 tensor broadcastable
    against ``rows [..., r, 1]`` and ``cols [..., 1, c]`` (global
    coordinates)."""
    h = _mix32((seed.long() & _M32) ^ 0x9E3779B9)
    h = _mix32((h + (bh.long() & _M32)) & _M32)
    h = _mix32((h + (rows.long() & _M32)) & _M32)
    h = _mix32((h + (cols.long() & _M32)) & _M32)
    return h >= _thresh(rate)


def _block_keep(seed, b, h, row_g, col_g, rate):
    """Keep mask ``[b, h, rows, cols]`` for global coordinates."""
    bh = torch.arange(b * h, device=row_g.device).reshape(b, h, 1, 1)
    return keep_mask(seed.reshape(()), bh, row_g[:, None], col_g[None, :],
                     rate)


# ------------------------------------------------------- plain versions


def _block_mask(row_g, col_g, causal, seg_q, seg_kb):
    """Causal + segment mask ``[b or 1, 1, rows, cols]`` or None."""
    mask = None
    if causal:
        mask = (row_g[:, None] >= col_g[None, :])[None, None]
    if seg_q is not None:
        sm = (seg_q[:, :, None] == seg_kb[:, None, :])[:, None]
        mask = sm if mask is None else mask & sm
    return mask


def _blocks(sk: int):
    bk = min(DEFAULT_BLOCK_K, _round_up(max(sk, 1), _LANES))
    return [(j, min(j + bk, sk)) for j in range(0, sk, bk)]


def flash_fwd_plain(q, k, v, seg_q=None, seg_k=None, seed=None, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0,
                    dropout_rate: float = 0.0):
    """Plain PyTorch version of F1: ``(out, lse)``.  Products of
    input-dtype values accumulate in fp32; the K/V sweep runs in blocks of
    ``DEFAULT_BLOCK_K`` with the TPU kernel's online rescale and guards."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _resolve(scale, d)
    seg_q, seg_k = _segments(seg_q, seg_k, b, sq, sk, q.device)
    qf = q.float()
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    row_g = q_offset + torch.arange(sq, device=q.device)
    inv = 1.0
    if dropout_rate > 0.0:
        seed = _seed_tensor(seed, q.device)
        inv = 1.0 / (1.0 - dropout_rate)
    for j0, j1 in _blocks(sk):
        col_g = kv_offset + torch.arange(j0, j1, device=q.device)
        s = torch.matmul(qf, k[:, :, j0:j1].float().transpose(-1, -2)) * scale
        mask = _block_mask(row_g, col_g, causal, seg_q,
                           None if seg_k is None else seg_k[:, j0:j1])
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * alpha + p.sum(dim=-1)
        if dropout_rate > 0.0:
            keep = _block_keep(seed, b, h, row_g, col_g, dropout_rate)
            p = torch.where(keep, p * inv, 0.0)
        pv = p.to(v.dtype).float()
        acc = acc * alpha[..., None] + torch.matmul(pv, v[:, :, j0:j1].float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))
    return out, lse


def _bwd_block(q, k, v, do, lse, delta, seg_q, seg_k, seed, j0, j1, *,
               causal, scale, q_offset, kv_offset, dropout_rate):
    """One K/V block of the backward over all q rows: ``(p, p_dropped,
    ds)`` in fp32, before any rounding."""
    b, h, sq, _ = q.shape
    row_g = q_offset + torch.arange(sq, device=q.device)
    col_g = kv_offset + torch.arange(j0, j1, device=q.device)
    s = torch.matmul(q.float(), k[:, :, j0:j1].float().transpose(-1, -2)) * scale
    mask = _block_mask(row_g, col_g, causal, seg_q,
                       None if seg_k is None else seg_k[:, j0:j1])
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    lse_safe = torch.where(lse <= NEG_INF * 0.5, 0.0, lse)
    p = torch.exp(s - lse_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.matmul(do.float(), v[:, :, j0:j1].float().transpose(-1, -2))
    p_drop = p
    if dropout_rate > 0.0:
        keep = _block_keep(_seed_tensor(seed, q.device), b, h, row_g, col_g,
                           dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    return p_drop, ds


def flash_dq_plain(q, k, v, do, lse, delta, seg_q=None, seg_k=None,
                   seed=None, *, causal: bool = False,
                   scale: Optional[float] = None, q_offset: int = 0,
                   kv_offset: int = 0, dropout_rate: float = 0.0):
    """Plain PyTorch version of F2: dq in q's dtype, dS rounded to K's
    dtype before ``dS @ K``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _resolve(scale, d)
    seg_q, seg_k = _segments(seg_q, seg_k, b, sq, sk, q.device)
    dq = torch.zeros((b, h, sq, d), device=q.device)
    for j0, j1 in _blocks(sk):
        _, ds = _bwd_block(q, k, v, do, lse, delta, seg_q, seg_k, seed, j0,
                           j1, causal=causal, scale=scale, q_offset=q_offset,
                           kv_offset=kv_offset, dropout_rate=dropout_rate)
        dq = dq + torch.matmul(ds.to(k.dtype).float(), k[:, :, j0:j1].float())
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, seg_q=None, seg_k=None,
                    seed=None, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0, dropout_rate: float = 0.0):
    """Plain PyTorch version of F3: ``(dk, dv)`` in k's and v's dtypes;
    the dropped P is rounded to dO's dtype for dv, dS to Q's for dk."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _resolve(scale, d)
    seg_q, seg_k = _segments(seg_q, seg_k, b, sq, sk, q.device)
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    for j0, j1 in _blocks(sk):
        p_drop, ds = _bwd_block(q, k, v, do, lse, delta, seg_q, seg_k, seed,
                                j0, j1, causal=causal, scale=scale,
                                q_offset=q_offset, kv_offset=kv_offset,
                                dropout_rate=dropout_rate)
        dv[:, :, j0:j1] = torch.matmul(
            p_drop.to(do.dtype).float().transpose(-1, -2), do.float())
        dk[:, :, j0:j1] = torch.matmul(
            ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk, dv


# ----------------------------------------------------------- the kernels


def _check_shapes(q, k, v, seg_q, seg_k):
    """The shapes every path takes: q ``[b, h, sq, d]``, k and v
    ``[b, h, sk, d]``, segment ids ``[b, s]``; raise on anything else."""
    if (q.dim() != 4 or k.shape[:2] != q.shape[:2]
            or k.shape[-1] != q.shape[-1] or v.shape != k.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not [b, h, s, d] alike")
    b, _, sq, _ = q.shape
    for name, seg, s in (("segment_ids_q", seg_q, sq),
                         ("segment_ids_kv", seg_k, k.shape[2])):
        if seg is not None and tuple(seg.shape) != (b, s):
            raise ValueError(
                f"{name} must be [{b}, {s}], got {tuple(seg.shape)}")


def _check_cuda(named, q):
    """What the CUDA kernels take beyond the shapes; raise on anything
    else."""
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name in ("k", "v", "do"):
        t = named.get(name)
        if t is not None and t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {t.dtype}")
    for name in ("lse", "delta"):
        t = named.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    if q.shape[-1] > 128:
        raise ValueError(f"head_dim {q.shape[-1]} > 128 is not compiled")


def _dropout_args(seed, rate, device):
    """(seed tensor or None, keep threshold, 1 / keep probability); the
    caller keeps the tensor alive across the launch."""
    if rate <= 0.0:
        return None, 0, 1.0
    return _seed_tensor(seed, device), _thresh(rate), 1.0 / (1.0 - rate)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tc_route(q, k, *rest) -> str:
    """``"tc"`` (the tensor-core kernels) for bf16 operands with a head dim
    that is a multiple of 8 up to 128, at least one key and 16-byte-aligned
    storage (TMA's rule for a tensor's base and row stride); ``"simt"``
    for anything else."""
    ops = (q, k, *rest)
    d = q.shape[-1]
    if (all(t.dtype == torch.bfloat16 for t in ops) and d % 8 == 0
            and 0 < d <= 128 and k.shape[2] > 0
            and all(t.data_ptr() % 16 == 0 for t in ops)):
        return "tc"
    return "simt"


def fwd_route(q, k, v) -> str:
    """The F1 kernel that operands of these dtypes and shapes take (see
    :func:`_tc_route`)."""
    return _tc_route(q, k, v)


def bwd_route(q, k, v, do) -> str:
    """The F2 and F3 kernels that operands of these dtypes and shapes take,
    by the same rule as :func:`fwd_route` over ``do`` too."""
    return _tc_route(q, k, v, do)


def _fwd(q, k, v, seg_q, seg_k, seed, *, causal, scale, q_offset,
         kv_offset, dropout_rate, route=None):
    """F1 on CUDA tensors, its plain version on CPU tensors.  ``route``
    names the kernel (``"tc"`` or ``"simt"``); by default
    :func:`fwd_route` chooses it."""
    global FWD_LAUNCHES, FWD_TC_LAUNCHES, FWD_SIMT_LAUNCHES
    _check_shapes(q, k, v, seg_q, seg_k)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, seg_q, seg_k, seed, causal=causal,
                               scale=scale, q_offset=q_offset,
                               kv_offset=kv_offset,
                               dropout_rate=dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    seg_q, seg_k = _segments(seg_q, seg_k, b, sq, sk, q.device)
    _check_cuda(dict(q=q, k=k, v=v, seg_q=seg_q, seg_k=seg_k), q)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    seed_t, thresh, inv = _dropout_args(seed, dropout_rate, q.device)
    route = route or fwd_route(q, k, v)
    lib = _build.library()
    if route == "tc":
        fn, lead = lib.apex_flash_fwd_tc, ()
    elif route == "simt":
        fn, lead = lib.apex_flash_fwd, (_DTYPE_CODES[q.dtype],)
    else:
        raise ValueError(f"unknown flash forward route {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _ptr(seg_q), _ptr(seg_k), _ptr(seed_t), out.data_ptr(),
                lse.data_ptr(), b * h, h, sq, sk, d, int(causal), q_offset,
                kv_offset, _resolve(scale, d), thresh, inv,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash forward kernel ({route}) launch failed: "
                           f"CUDA error {rc}")
    FWD_LAUNCHES += 1
    if route == "tc":
        FWD_TC_LAUNCHES += 1
    else:
        FWD_SIMT_LAUNCHES += 1
    return out, lse


def _check_bwd_shapes(q, k, v, do, lse, delta, seg_q, seg_k):
    _check_shapes(q, k, v, seg_q, seg_k)
    if (do.shape != q.shape or lse.shape != q.shape[:3]
            or delta.shape != q.shape[:3]):
        raise ValueError("do must be q's shape, lse and delta [b, h, sq]")


def _bwd_operands(q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv):
    b, h, sq, _ = q.shape
    seg_q, seg_k = _segments(segment_ids_q, segment_ids_kv, b, sq,
                             k.shape[2], q.device)
    _check_cuda(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                     seg_q=seg_q, seg_k=seg_k), q)
    return seg_q, seg_k


def _bwd_launch(kernel, route, q, k, v, do, lse, delta, seg_q, seg_k,
                dropout_seed, outs, *, causal, scale, q_offset, kv_offset,
                dropout_rate):
    """Launch F2 (``kernel="dq"``) or F3 (``"dkv"``) on ``route`` into
    ``outs``; raise if the launch fails."""
    b, h, sq, d = q.shape
    seed_t, thresh, inv = _dropout_args(dropout_seed, dropout_rate, q.device)
    lib = _build.library()
    if route == "tc":
        fn, lead = getattr(lib, f"apex_flash_{kernel}_tc"), ()
    elif route == "simt":
        fn, lead = getattr(lib, f"apex_flash_{kernel}"), (
            _DTYPE_CODES[q.dtype],)
    else:
        raise ValueError(f"unknown flash backward route {route!r}")
    with torch.cuda.device(q.device):
        rc = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(seg_q),
                _ptr(seg_k), _ptr(seed_t), *(t.data_ptr() for t in outs),
                b * h, h, sq, k.shape[2], d, int(causal), q_offset,
                kv_offset, _resolve(scale, d), thresh, inv,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash {kernel} kernel ({route}) launch failed: "
                           f"CUDA error {rc}")


def _dq(q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv,
        dropout_seed, *, causal, scale, q_offset, kv_offset, dropout_rate,
        route=None):
    """F2 on CUDA tensors, its plain version on CPU tensors.  ``route``
    names the kernel (``"tc"`` or ``"simt"``); by default
    :func:`bwd_route` chooses it."""
    global DQ_LAUNCHES, DQ_TC_LAUNCHES, DQ_SIMT_LAUNCHES
    _check_bwd_shapes(q, k, v, do, lse, delta, segment_ids_q,
                      segment_ids_kv)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset, dropout_rate=dropout_rate)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, segment_ids_q,
                              segment_ids_kv, dropout_seed, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_q, seg_k = _bwd_operands(q, k, v, do, lse, delta, segment_ids_q,
                                 segment_ids_kv)
    dq = torch.empty_like(q)
    route = route or bwd_route(q, k, v, do)
    _bwd_launch("dq", route, q, k, v, do, lse, delta, seg_q, seg_k,
                dropout_seed, (dq,), **kw)
    DQ_LAUNCHES += 1
    if route == "tc":
        DQ_TC_LAUNCHES += 1
    else:
        DQ_SIMT_LAUNCHES += 1
    return dq


def _dkv(q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv,
         dropout_seed, *, causal, scale, q_offset, kv_offset, dropout_rate,
         route=None):
    """F3 on CUDA tensors, its plain version on CPU tensors; ``route`` as
    for :func:`_dq`."""
    global DKV_LAUNCHES, DKV_TC_LAUNCHES, DKV_SIMT_LAUNCHES
    _check_bwd_shapes(q, k, v, do, lse, delta, segment_ids_q,
                      segment_ids_kv)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset, dropout_rate=dropout_rate)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, segment_ids_q,
                               segment_ids_kv, dropout_seed, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    seg_q, seg_k = _bwd_operands(q, k, v, do, lse, delta, segment_ids_q,
                                 segment_ids_kv)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = route or bwd_route(q, k, v, do)
    _bwd_launch("dkv", route, q, k, v, do, lse, delta, seg_q, seg_k,
                dropout_seed, (dk, dv), **kw)
    DKV_LAUNCHES += 1
    if route == "tc":
        DKV_TC_LAUNCHES += 1
    else:
        DKV_SIMT_LAUNCHES += 1
    return dk, dv


def dq_chunk(q, k, v, do, lse, delta, *, causal, scale=None,
             block_q=None, block_k=None, q_offset=0, kv_offset=0,
             segment_ids_q=None, segment_ids_kv=None, dropout_rate=0.0,
             dropout_seed=None):
    """dq of one K/V chunk given the *global* ``lse``/``delta`` (F2).

    Each (q-block, k-block) pair's gradient depends on the others only
    through (lse, delta), so ring backward can re-drive this per chunk.
    ``block_q``/``block_k`` are validated tiling hints
    (:func:`resolve_default_blocks`)."""
    resolve_default_blocks(block_q, block_k)
    return _dq(q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv,
               dropout_seed, causal=causal, scale=scale, q_offset=q_offset,
               kv_offset=kv_offset, dropout_rate=dropout_rate)


def dkv_chunk(q, k, v, do, lse, delta, *, causal, scale=None,
              block_q=None, block_k=None, q_offset=0, kv_offset=0,
              segment_ids_q=None, segment_ids_kv=None, dropout_rate=0.0,
              dropout_seed=None):
    """``(dk, dv)`` of one K/V chunk given the global ``lse``/``delta``
    (F3); ``block_q``/``block_k`` as for :func:`dq_chunk`."""
    resolve_default_blocks(block_q, block_k)
    return _dkv(q, k, v, do, lse, delta, segment_ids_q, segment_ids_kv,
                dropout_seed, causal=causal, scale=scale, q_offset=q_offset,
                kv_offset=kv_offset, dropout_rate=dropout_rate)


# ------------------------------------------------- autograd + public API


class FlashAttentionFunction(torch.autograd.Function):
    """``(out, lse)`` with the flash backward (the JAX ``_flash_core``
    custom VJP): only ``out``'s cotangent propagates; ``lse`` is a
    by-product for sharded-softmax composition."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, seed, causal, scale, block_q,
                block_k, q_offset, kv_offset, dropout_rate):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _fwd(q, k, v, seg_q, seg_k, seed, causal=causal,
                        scale=scale, q_offset=q_offset, kv_offset=kv_offset,
                        dropout_rate=dropout_rate)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, seed, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, block_q=block_q,
                      block_k=block_k, q_offset=q_offset,
                      kv_offset=kv_offset, dropout_rate=dropout_rate)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, seg_q, seg_k, seed, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        kw = dict(ctx.kw, segment_ids_q=seg_q, segment_ids_kv=seg_k,
                  dropout_seed=seed)
        dq = dq_chunk(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_chunk(q, k, v, do, lse, delta, **kw)
        return (dq, dk, dv) + (None,) * 10


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None,
                             q_offset: int = 0, kv_offset: int = 0, *,
                             segment_ids_q=None, segment_ids_kv=None,
                             dropout_rate: float = 0.0, dropout_seed=None):
    """Attention returning ``(out, lse)``; differentiable in q, k, v.

    ``segment_ids_q/kv`` (int >= 0, ``[b, s]``) mask attention across
    segment boundaries.  ``dropout_rate``/``dropout_seed`` apply attention
    dropout after the softmax (vary the seed per step).  ``block_q`` /
    ``block_k`` are validated tiling hints (:func:`resolve_default_blocks`),
    in the JAX package's positions."""
    block_q, block_k = resolve_default_blocks(block_q, block_k)
    seed = (_seed_tensor(dropout_seed, q.device) if dropout_rate > 0.0
            else None)
    return FlashAttentionFunction.apply(
        q, k, v, segment_ids_q, segment_ids_kv, seed, causal, scale,
        block_q, block_k, q_offset, kv_offset, float(dropout_rate))


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None, *,
                    segment_ids_q=None, segment_ids_kv=None,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """``softmax(q k^T * scale [+ masks]) v`` without materialising the
    score matrix.  ``q, k, v: [batch, heads, seq, head_dim]``."""
    out, _ = flash_attention_with_lse(
        q, k, v, causal, scale, block_q, block_k, 0, 0,
        segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return out
