"""Cross attention and the decoder layer of the port's standalone
transformer LM against the JAX package's, fp32 on the CPU.

``ParallelAttention(attention_type=AttnType.cross_attn)`` (queries from
the decoder stream, packed K/V from the encoder's output, the default
core over ``enc_dec_mask``, with and without a mask) and
``ParallelTransformerLayer(layer_type=LayerType.decoder)`` (self
attention, then LayerNorm and cross attention, then the MLP), with
``apply_residual_connection_post_layernorm`` off and on and with the
flash core on the causal self attention.  Query-key layer scaling is on
at layer 2.  Decoder 8 tokens, encoder 12, batch 2, hidden 32, 4 heads.
The layers take the Flax modules' parameters by name.  Output and every
gradient (the input, the encoder output, each parameter) within 1e-5 of
the largest element of its tensor (measured up to 6e-7 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.ops.softmax import AttnMaskType as JaxMaskType
from apex_tpu.transformer.enums import AttnType as JaxAttnType
from apex_tpu.transformer.enums import LayerType as JaxLayerType
from apex_tpu.transformer.testing import ParallelAttention as JaxAttention
from apex_tpu.transformer.testing import (
    ParallelTransformerLayer as JaxLayer,
)
from apex_tpu.transformer.testing import TransformerConfig as JaxConfig
from apex_tpu_torch.ops.softmax import AttnMaskType
from apex_tpu_torch.transformer.enums import AttnType, LayerType
from apex_tpu_torch.transformer.testing import (
    ParallelAttention,
    ParallelTransformerLayer,
    TransformerConfig,
)

WIDTHS = dict(hidden_size=32, num_attention_heads=4, hidden_dropout=0.0,
              attention_dropout=0.0, tensor_axis=None)
SQ, SK, B, H = 8, 12, 2, 32
LIMIT = 1e-5


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(SQ, B, H).astype(np.float32)
    enc = rng.randn(SK, B, H).astype(np.float32)
    g = rng.randn(SQ, B, H).astype(np.float32)
    # the second row's last 5 encoder positions are padding (True = masked)
    enc_dec = np.zeros((B, 1, SQ, SK), bool)
    enc_dec[1, :, :, -5:] = True
    return x, enc, g, enc_dec


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.tensor(np.asarray(v))
    return out


def _compare(jmod, port, call_jax, call_port, seed=3):
    """Output and gradients (inputs and parameters) of the Flax module
    ``jmod`` and the port's ``port`` on the same inputs and weights."""
    x, enc, g, enc_dec = _inputs()
    params = jax.device_get(jax.jit(lambda k: jmod.init(
        k, *call_jax(x, enc, enc_dec)))(jax.random.PRNGKey(seed))["params"])
    port.load_state_dict(_flat(params))

    @jax.jit
    def run(p, x, enc):
        def f(p, x, enc):
            out = jmod.apply({"params": p}, *call_jax(x, enc, enc_dec))
            return out[0] + out[1] if isinstance(out, tuple) else out
        out, vjp = jax.vjp(f, p, x, enc)
        return out, vjp(jnp.asarray(g))

    want, (gp, gx, genc) = jax.device_get(run(params, x, enc))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(enc, requires_grad=True)
    out = call_port(port, xt, et, torch.from_numpy(enc_dec))
    out = out[0] + out[1] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(g))
    pairs = [("out", out.detach(), want), ("dx", xt.grad, gx),
             ("dencoder", et.grad, genc)]
    grads = _flat(gp)
    pairs += [(n, p.grad, grads[n]) for n, p in port.named_parameters()]
    assert len(grads) == len(list(port.parameters()))
    for name, got, w in pairs:
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= LIMIT, (name, err)


@pytest.mark.parametrize("masked", [True, False], ids=["enc_dec_mask",
                                                       "no_mask"])
def test_cross_attention_matches_jax(masked):
    jax_cfg, cfg = JaxConfig(**WIDTHS), TransformerConfig(**WIDTHS)
    jmod = JaxAttention(jax_cfg, layer_number=2,
                        attention_type=JaxAttnType.cross_attn)
    port = ParallelAttention(cfg, 2, attention_type=AttnType.cross_attn,
                             device="cpu")
    assert not hasattr(port, "query_key_value")
    _compare(jmod, port,
             lambda x, enc, m: (x, m if masked else None, enc),
             lambda mod, x, enc, m: mod(x, m if masked else None,
                                        encoder_output=enc))


DECODER_CASES = {
    "pre_ln": dict(apply_residual_connection_post_layernorm=False),
    "post_ln": dict(apply_residual_connection_post_layernorm=True),
    "flash_self_attention": dict(use_flash_attention=True),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_layer_matches_jax(case):
    kw = dict(WIDTHS, **DECODER_CASES[case])
    jmod = JaxLayer(JaxConfig(**kw), layer_number=2,
                    layer_type=JaxLayerType.decoder,
                    self_attn_mask_type=JaxMaskType.causal)
    port = ParallelTransformerLayer(
        TransformerConfig(**kw), 2, layer_type=LayerType.decoder,
        self_attn_mask_type=AttnMaskType.causal, device="cpu")
    _compare(jmod, port,
             lambda x, enc, m: (x, None, enc, m),
             lambda mod, x, enc, m: mod(x, None, encoder_output=enc,
                                        enc_dec_mask=m))


def test_encoder_layers_hold_no_cross_attention():
    layer = ParallelTransformerLayer(TransformerConfig(**WIDTHS),
                                     device="cpu")
    names = {n.split(".")[0] for n, _ in layer.named_parameters()}
    assert names == {"input_layernorm", "self_attention",
                     "post_attention_layernorm", "mlp"}
