"""The port's contrib multihead attention
(``apex_tpu_torch.contrib.multihead_attn``) against the JAX package's,
fp32 on the CPU, T 16 (the encoder-decoder module: 8 queries over 16
keys), batch 2, 32 channels, 4 heads.

Every mask mode of both modules: none, binary key padding (through the
flash kernels as segment ids, 0 for every query, the mask for the keys;
the JAX side's kernels in interpret mode), an additive mask (the plain
softmax core), both at once, ``include_norm_add`` and the biases.  In
every key-padding case the second batch row's keys are all padding:
each of its queries sees no key, and both packages give it output 0
(so 0 after a bias-free output projection, pinned).  The weights are the
Flax modules', carried by ``from_flax_multihead_attn``.  Output and every
gradient (query, key, each parameter) within 1e-5 of the largest element
of its tensor (measured up to 8e-7 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn
from apex_tpu_torch.serving.bridge import from_flax_multihead_attn

T, TQ, B, C, H = 16, 8, 2, 32, 4
LIMIT = 1e-5


def _inputs(tq):
    rng = np.random.RandomState(1)
    query = rng.randn(tq, B, C).astype(np.float32)
    key = rng.randn(T, B, C).astype(np.float32)
    g = rng.randn(tq, B, C).astype(np.float32)
    pad = np.zeros((B, T), np.int32)
    pad[0, -5:] = 1                 # the first row's last 5 keys
    pad[1, :] = 1                   # the second row's every key
    additive = np.triu(np.full((tq, T), -1e9, np.float32), k=1)[None, None]
    return query, key, g, pad, additive


SELF_CASES = {
    "no_mask": (dict(), dict()),
    "key_padding": (dict(), dict(pad=True)),
    "additive": (dict(mask_additive=True), dict(additive=True)),
    "additive_key_padding": (dict(mask_additive=True),
                             dict(pad=True, additive=True)),
    "norm_add_bias": (dict(include_norm_add=True, bias=True),
                      dict(pad=True)),
}
ENCDEC_CASES = {
    "no_mask": (dict(), dict()),
    "key_padding": (dict(), dict(pad=True)),
    "attn_mask": (dict(), dict(additive=True)),
    "norm_add_bias": (dict(include_norm_add=True, bias=True),
                      dict(pad=True)),
}


def _compare(jmod, port, masks, encdec):
    query, key, g, pad, additive = _inputs(TQ if encdec else T)
    kw = {}
    if masks.get("pad"):
        kw["key_padding_mask"] = pad
    if masks.get("additive"):
        kw["attn_mask"] = additive
    args = (query, key) if encdec else (query,)
    # random weights in the Flax tree's shapes (tracing ``init`` is
    # enough: its compile would cost as much as the run's)
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args, **kw),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.2 + (len(s.shape) == 1)).astype(
            np.float32), shapes)
    port.load_state_dict(from_flax_multihead_attn(params))

    @jax.jit
    def run(p, args):
        out, vjp = jax.vjp(
            lambda p, args: jmod.apply({"params": p}, *args, **kw), p, args)
        return out, vjp(jnp.asarray(g))

    want, (gp, gargs) = jax.device_get(run(params, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = port(*leaves, **{k: torch.from_numpy(v) for k, v in kw.items()})
    out.backward(torch.from_numpy(g))
    grads = from_flax_multihead_attn(gp)
    pairs = [("out", out.detach(), want)]
    pairs += [(f"d{n}", t.grad, w) for n, t, w in zip(("query", "key"),
                                                      leaves, gargs)]
    pairs += [(n, p.grad, grads[n]) for n, p in port.named_parameters()]
    assert len(grads) == len(list(port.parameters()))
    for name, got, w in pairs:
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= LIMIT, (name, err)
    if masks.get("pad") and not masks.get("additive") \
            and port.out_proj.bias is None and not port.include_norm_add:
        # every query of the all-padding row sees no key: output 0
        assert not out[:, 1].any() and not np.asarray(want)[:, 1].any()
    return out


@pytest.mark.parametrize("case", list(SELF_CASES))
def test_self_multihead_attn_matches_jax(case):
    module_kw, masks = SELF_CASES[case]
    _compare(jmha.SelfMultiheadAttn(embed_dim=C, num_heads=H, **module_kw),
             SelfMultiheadAttn(C, H, device="cpu", **module_kw), masks,
             encdec=False)


@pytest.mark.parametrize("case", list(ENCDEC_CASES))
def test_encdec_multihead_attn_matches_jax(case):
    module_kw, masks = ENCDEC_CASES[case]
    _compare(jmha.EncdecMultiheadAttn(embed_dim=C, num_heads=H,
                                      **module_kw),
             EncdecMultiheadAttn(C, H, device="cpu", **module_kw), masks,
             encdec=True)


def test_dropout_is_seeded_by_the_generator_and_differentiable():
    """Attention dropout (in the flash kernels) draws its seed from the
    generator: the same seed drops the same entries, another seed others,
    and ``generator=None`` is deterministic."""
    query, _, _, pad, _ = _inputs(T)
    m = SelfMultiheadAttn(C, H, dropout=0.3, include_norm_add=True,
                          device="cpu")
    x = torch.tensor(query, requires_grad=True)
    kp = torch.from_numpy(pad)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return m(x, key_padding_mask=kp, generator=gen)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.equal(run(None), run(None)) and not torch.allclose(
        run(None), a)
    a.square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in m.parameters())
    assert torch.isfinite(x.grad).all()


def test_additive_mask_with_norm_add_is_refused_as_in_jax():
    with pytest.raises(ValueError):
        jmha.SelfMultiheadAttn(embed_dim=C, num_heads=H,
                               include_norm_add=True,
                               mask_additive=True).init(
            jax.random.PRNGKey(0), jnp.zeros((T, B, C)))
    with pytest.raises(ValueError):
        SelfMultiheadAttn(C, H, include_norm_add=True, mask_additive=True,
                          device="cpu")
    with pytest.raises(ValueError):
        SelfMultiheadAttn(30, 4, device="cpu")


def test_projections_compute_in_the_promoted_dtype():
    """As Flax's ``Dense``: bf16 activations through fp32 parameters
    compute in fp32; bf16 parameters keep bf16."""
    query, key, _, _, _ = _inputs(TQ)
    m = EncdecMultiheadAttn(C, H, device="cpu")
    q, k = (torch.from_numpy(a).bfloat16() for a in (query, key))
    assert m(q, k).dtype == torch.float32
    assert m.to(torch.bfloat16)(q, k).dtype == torch.bfloat16


def test_modules_without_a_device_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SelfMultiheadAttn, EncdecMultiheadAttn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(C, H)
