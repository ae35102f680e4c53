"""GPT parameter structure and seeded initialisation.

Port of the parameter side of
:mod:`apex_tpu.transformer.testing.gpt_parallel_train`: the same
:class:`GPT3DParams` tree (``embedding``, stacked ``layers``, ``final_ln``,
with the JAX package's leaf names) holding torch tensors, and an
initialiser with the same distributions as the Flax init (normal with
``init_method_std`` for the embeddings and the input-facing kernels,
``std / sqrt(2 * num_layers)`` for the output-facing ones, zero biases,
unit LayerNorm scales), drawn from a ``torch.Generator`` seeded by the
caller.  The single-device step is
:func:`apex_tpu_torch.testing.l1.train_step`, the data-, tensor- and
sequence-parallel one :func:`apex_tpu_torch.testing.l1.
parallel_train_step` (a rank's shards cut by
:func:`apex_tpu_torch.transformer.tensor_parallel.shard_params`); the
pipelined 3D step (``build_gpt_3d``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["GPT3DParams", "init_gpt_params", "merge_layer_stack"]


class GPT3DParams(NamedTuple):
    embedding: dict
    layers: dict      # stacked [L, ...] (or the pipeline form [vpp, pp, ...])
    final_ln: dict


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def merge_layer_stack(layers: dict, num_layers: int) -> dict:
    """``[vpp, pp, ...]`` -> ``[L, ...]`` (a row-major merge: virtual-stage
    major is plain layer order); a stack already ``[L, ...]`` is returned
    as it is.  The form is read off the per-layer LayerNorm scale, which
    has one dim of its own."""
    lead = layers["input_layernorm"]["scale"].dim() - 1
    if lead == 1:
        return layers
    if lead != 2:
        raise ValueError(f"layer stack with {lead} leading dims")
    return _map(layers, lambda t: t.reshape((num_layers,) + t.shape[2:]))


def init_gpt_params(config: TransformerConfig, seed: int, *,
                    device: Optional[torch.device] = None) -> GPT3DParams:
    """Random GPT parameters from ``seed``, layers stacked ``[L, ...]``,
    in ``config.param_dtype`` on ``device`` (default: the CUDA device)."""
    cfg = config
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.param_dtype
    L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
    std = cfg.init_method_std
    out_std = std / math.sqrt(2.0 * L)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s).to(dt)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dt)

    def linear(n_out, n_in, s):
        return {"kernel": normal((L, n_out, n_in), s), "bias": zeros((L, n_out))}

    def norm():
        return {"scale": torch.ones((L, h), device=device, dtype=dt),
                "bias": zeros((L, h))}

    qkv_out = (cfg.num_attention_heads + 2 * cfg.query_groups) * cfg.head_dim
    mlp = {"dense_h_to_4h": linear(f, h, std),
           "dense_4h_to_h": linear(h, f, out_std)}
    if cfg.swiglu:
        mlp["dense_h_to_4h_gate"] = linear(f, h, std)
    layers = {
        "input_layernorm": norm(),
        "self_attention": {
            "query_key_value": linear(qkv_out, h, std),
            "dense": linear(h, cfg.num_attention_heads * cfg.head_dim,
                            out_std),
        },
        "post_attention_layernorm": norm(),
        "mlp": mlp,
    }
    embedding = {"word_embeddings": {
        "embedding": normal((cfg.padded_vocab_size, h), std)}}
    if cfg.position_embedding_type == "learned":
        embedding["position_embeddings"] = {
            "embedding": normal((cfg.max_position_embeddings, h), std)}
    final_ln = {"scale": torch.ones((h,), device=device, dtype=dt),
                "bias": zeros((h,))}
    return GPT3DParams(embedding=embedding, layers=layers, final_ln=final_ln)
