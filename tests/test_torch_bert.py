"""The port's BERT (``apex_tpu_torch.transformer.testing.BertModel``), its
pooler and ``bert_extended_attention_mask`` against the JAX package's, on
the CPU at ``bench.py::bench_bert_large``'s CPU widths (hidden 64, 2
layers, 4 heads, vocabulary 512, batch 2 x 32) with a padded mask.

The weights are a Flax ``BertModel``'s, carried by ``from_flax_bert``.
The JAX side runs jitted (its flash kernels in interpret mode, as the
JAX package's own tests run them), one step function a core shared by
the tests through a module-scoped fixture.  Limits, fp32:

- logits (LM at every position, the pad rows included, since both sides
  run the same core; binary) within 2e-5 absolute (measured about
  3e-7);
- every gradient of the bench's loss within 1e-5 of the largest element
  of its tensor (measured up to 7e-7 of it);
- three ``FusedAdam(lr=1e-4)`` steps of the bench's loss: the losses
  within 1e-6 relative (measured up to 1.4e-7) and every parameter
  within 1e-5 absolute of the JAX steps' (measured 9.4e-7; Adam moves a
  weight by up to 1e-4 a step, about ``lr`` times the sign of a small
  gradient, so a gradient near 0 amplifies its rounding);
- flash against the default core, in the port, within 2e-5 at the real
  positions only (the JAX package's own rule, ``tests/test_transformer_
  lm.py``): a pad row of the default core sees a fully masked row and
  mixes every value uniformly, a flash pad row the pad keys only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.ops.softmax import AttnMaskType as JaxMaskType
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jxent
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.testing import BertModel as JaxBert
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing import TransformerLanguageModel as JaxLM
from apex_tpu.transformer.testing import (
    bert_extended_attention_mask as jax_ext_mask,
)
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving.bridge import from_flax_bert
from apex_tpu_torch.transformer.testing import (
    BertModel,
    TransformerConfig,
    TransformerLanguageModel,
    bert_extended_attention_mask,
)

# bench.py::bench_bert_large's CPU configuration
WIDTHS = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
              padded_vocab_size=512, max_position_embeddings=64,
              hidden_dropout=0.0, attention_dropout=0.0, tensor_axis=None)
BATCH, SEQ, LENGTHS = 2, 32, (27, 13)
STEPS = 3


def _inputs():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, WIDTHS["padded_vocab_size"],
                         (BATCH, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None, :] < np.asarray(LENGTHS)[:, None]).astype(
        np.int32)
    return tokens, mask


def _jax_loss(lm, binary, tokens):
    """The bench's loss: mean cross entropy over the ``[s*b, V]`` logits
    against ``tokens.T`` plus the sentence-order term."""
    ce = jxent(lm.reshape(-1, lm.shape[-1]), tokens.T.reshape(-1),
               padding_idx=-1, half_to_float=True)
    return jnp.mean(ce) + jnp.mean(-jax.nn.log_softmax(binary)[:, 0])


def bert_loss(lm, binary, tokens):
    """The same loss in the port."""
    ce = softmax_cross_entropy_loss(lm.reshape(-1, lm.shape[-1]),
                                    tokens.t().reshape(-1), padding_idx=-1,
                                    half_to_float=True)
    return ce.mean() + (-torch.log_softmax(binary, dim=-1)[:, 0]).mean()


def _jax_steps(cfg, params, tokens, mask, steps):
    """``steps`` jitted FusedAdam steps of the bench loss: per step
    ``(loss, lm, binary, grads)`` of the weights it started from, and the
    final parameters."""
    model, opt = JaxBert(cfg), JaxFusedAdam(lr=1e-4)

    def loss_fn(p):
        lm, binary = model.apply({"params": p}, tokens, mask)
        return _jax_loss(lm, binary, tokens), (lm, binary)

    @jax.jit
    def step(p, state):
        (loss, (lm, binary)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        p, state = opt.step(grads, state, p)
        return (loss, lm, binary, grads), p, state

    state, out = opt.init(params), []
    for _ in range(steps):
        rec, params, state = step(params, state)
        out.append(jax.device_get(rec))
    return out, jax.device_get(params)


@pytest.fixture(scope="module")
def ref():
    tokens, mask = _inputs()
    init_cfg = JaxConfig(**WIDTHS)
    params = jax.device_get(jax.jit(JaxBert(init_cfg).init)(
        jax.random.PRNGKey(0), tokens, mask)["params"])
    runs = {}
    for flash in (True, False):
        cfg = JaxConfig(**WIDTHS, use_flash_attention=flash)
        runs[flash] = _jax_steps(cfg, params, tokens, mask,
                                 STEPS if flash else 1)
    return dict(tokens=tokens, mask=mask, params=params, runs=runs)


def _port(params, flash, **kw):
    model = BertModel(TransformerConfig(**WIDTHS, use_flash_attention=flash,
                                        **kw), device="cpu", seed=None)
    model.load_state_dict(from_flax_bert(params))
    return model


def _port_step(model, opt, tokens, mask):
    opt.zero_grad(set_to_none=True)
    t = torch.from_numpy(tokens).long()
    lm, binary = model(t, torch.from_numpy(mask))
    loss = bert_loss(lm, binary, t)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    return (float(loss.detach()), lm.detach().numpy(),
            binary.detach().numpy(), grads)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "default"])
def test_bert_logits_and_gradients_match_jax(ref, flash):
    loss, lm, binary, grads = ref["runs"][flash][0][0]
    model = _port(ref["params"], flash)
    got = _port_step(model, FusedAdam(model.parameters(), lr=1e-4),
                     ref["tokens"], ref["mask"])
    np.testing.assert_allclose(got[0], float(loss), rtol=1e-6)
    np.testing.assert_allclose(got[1], np.asarray(lm), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[2], np.asarray(binary), rtol=0, atol=2e-5)
    want = from_flax_bert(grads)
    assert set(want) == set(got[3])
    for name, g in got[3].items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (name, err)


def test_bert_fused_adam_steps_match_jax(ref):
    """Three FusedAdam steps of the bench's loss (flash, as the bench
    runs): the losses and the final parameters."""
    steps, final = ref["runs"][True]
    model = _port(ref["params"], True)
    opt = FusedAdam(model.parameters(), lr=1e-4)
    losses = [_port_step(model, opt, ref["tokens"], ref["mask"])[0]
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, [float(s[0]) for s in steps],
                               rtol=1e-6)
    assert losses[-1] < losses[0]
    want, start = from_flax_bert(final), from_flax_bert(ref["params"])
    moved = 0.0
    for name, p in model.state_dict().items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - start[name].numpy()).max()))
    assert moved > 1e-5


def test_flash_matches_the_default_core_at_real_positions_only(ref):
    """The JAX package's rule for BERT's two cores: equal at every real
    position and in the binary head; a pad row differs (a uniform mix in
    the default core, the pad keys only under flash)."""
    t = torch.from_numpy(ref["tokens"]).long()
    m = torch.from_numpy(ref["mask"])
    out = {}
    for flash in (True, False):
        model = _port(ref["params"], flash,
                      apply_query_key_layer_scaling=False)
        with torch.no_grad():
            out[flash] = [x.numpy() for x in model(t, m)]
    real = ref["mask"].T.astype(bool)[:, :, None]
    np.testing.assert_allclose(out[True][0] * real, out[False][0] * real,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(out[True][0] - out[False][0])[~real[..., 0]].max() > 1e-3


def test_extended_attention_mask_matches_jax():
    mask = np.random.RandomState(1).randint(0, 2, (3, 7)).astype(np.int32)
    got = bert_extended_attention_mask(torch.from_numpy(mask))
    want = np.asarray(jax_ext_mask(jnp.asarray(mask)))
    assert got.dtype == torch.bool and got.shape == (3, 1, 7, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pooler_and_add_pooler_match_jax():
    """``TransformerLanguageModel(add_pooler=True)`` returns ``(hidden,
    pooled)``, the pooler at ``pooling_sequence_index``."""
    kw = dict(WIDTHS, num_layers=1)
    tokens, _ = _inputs()
    jm = JaxLM(JaxConfig(**kw), self_attn_mask_type=JaxMaskType.padding,
               add_pooler=True)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                             tokens)["params"])
    hidden, pooled = jax.jit(lambda p: jm.apply(
        {"params": p}, tokens, pooling_sequence_index=3))(params)
    port = TransformerLanguageModel(
        TransformerConfig(**kw), self_attn_mask_type=AttnMaskType.padding,
        add_pooler=True, device="cpu")
    prefix = "language_model."
    port.load_state_dict({k[len(prefix):]: v for k, v in from_flax_bert(
        {"language_model": params}).items()})
    with torch.no_grad():
        got_h, got_p = port(torch.from_numpy(tokens).long(),
                            pooling_sequence_index=3)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hidden), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(pooled), rtol=0,
                               atol=2e-5)
    assert got_p.shape == (BATCH, kw["hidden_size"])
    no_pooler = TransformerLanguageModel(TransformerConfig(**kw),
                                         device="cpu")
    assert no_pooler.pooler is None
    assert isinstance(no_pooler(torch.from_numpy(tokens).long()),
                      torch.Tensor)


def test_parameters_are_the_flax_models_and_the_lm_head_bias_is_sharded():
    """Every Flax leaf lands on a port parameter of its shape (the Dense
    kernels transposed), with and without the binary head."""
    tokens, mask = _inputs()
    for head in (True, False):
        jm = JaxBert(JaxConfig(**WIDTHS), add_binary_head=head)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), tokens,
                                mask)["params"]
        want = from_flax_bert(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes))
        model = BertModel(TransformerConfig(**WIDTHS), add_binary_head=head,
                          device="cpu")
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape for k in got)
        assert got["lm_head.dense.weight"].shape == (64, 64)
        assert tuple(shapes["lm_head"]["bias"].shape) == \
            (WIDTHS["padded_vocab_size"],)
        assert (model.binary_head is None) == (not head)
        if head:
            assert got["binary_head.weight"].shape == (2, 64)
        lm, binary = model(torch.from_numpy(tokens).long(),
                           torch.from_numpy(mask))
        assert lm.shape == (SEQ, BATCH, WIDTHS["padded_vocab_size"])
        assert (binary is None) == (not head)


def test_seeded_weights_follow_the_jax_initializers():
    cfg = TransformerConfig(**WIDTHS)
    a = BertModel(cfg, device="cpu", seed=3).state_dict()
    b = BertModel(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    std = cfg.init_method_std
    out = a["language_model.encoder.layers.0.mlp.dense_4h_to_h.kernel"]
    qkv = a["language_model.encoder.layers.0.self_attention."
            "query_key_value.kernel"]
    assert abs(float(qkv.std()) - std) < 0.1 * std
    assert abs(float(out.std()) - std / 2.0) < 0.1 * std
    assert torch.equal(a["lm_head.layernorm.scale"],
                       torch.ones(WIDTHS["hidden_size"]))
    assert not a["lm_head.bias"].any()


def test_bert_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertModel(TransformerConfig(**WIDTHS))
