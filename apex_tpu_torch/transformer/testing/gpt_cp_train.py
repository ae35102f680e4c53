"""Context-parallel GPT training (port of
:mod:`apex_tpu.transformer.testing.gpt_cp_train`).

The standalone GPT stack trains with its sequence dimension sharded over
the ``cp`` axis of the grid: the causal core runs
:func:`~apex_tpu_torch.transformer.context_parallel.ring_attention` (or
Ulysses, ``config.context_impl``), composed with data parallelism on the
batch dimension.  Rank ``(d, c)`` of the ``(dp, cp)`` grid holds rows
``[d * b/dp, (d + 1) * b/dp)`` and positions ``[c * s/cp, (c + 1) *
s/cp)`` of the global ``[b, s]`` tokens.

The cross-shard mechanics, as in the reference:

- **global position ids**: rank ``c`` embeds positions ``c * s_local +
  [0, s_local)`` (under RoPE the attention offsets its own rotation);
- **next-token labels across the shard boundary**: each rank's last
  position predicts the next rank's first token, fetched with one
  ``ppermute`` of the first column; rank ``cp - 1`` receives rank 0's
  first token, a target for the global last position, which is masked;
- **loss normalisation**: the masked sum and count each summed over
  ``(dp, cp)``, so every rank holds the global mean.

Every parameter is whole on every rank; after the backward
``loss_fn.reduce_gradients(params)`` sums each gradient over ``(dp,
cp)``, the reduction the reference's ``shard_map`` transpose inserts.
Groups of one rank are skipped, so at ``dp = cp = 1`` the step calls no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.distributed import all_reduce_gradients
from apex_tpu_torch.parallel.mesh import CONTEXT_AXIS, DATA_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.partition import (
    PartitionSpec,
)
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    init_gpt_params,
    merge_layer_stack,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["build_gpt_cp"]


def _size_index(axis):
    n = cc.bound_axis_size(axis)
    return n, (cc.axis_index(axis) if n > 1 else 0)


class _CPLoss:
    """The global masked-mean loss of the context-parallel step, and the
    reduction that makes its gradients whole; see :func:`build_gpt_cp`."""

    def __init__(self, local_logits, dp_axis, cp_axis):
        self._local_logits = local_logits
        self._dp_axis, self._cp_axis = dp_axis, cp_axis
        self._axes = (dp_axis, cp_axis)

    def _shard(self, tokens):
        """This rank's ``[b/dp, s/cp]`` block of the global tokens."""
        dp, d = _size_index(self._dp_axis)
        cp, c = _size_index(self._cp_axis)
        b, s = tokens.shape[0] // dp, tokens.shape[1] // cp
        return tokens[d * b:(d + 1) * b, c * s:(c + 1) * s]

    def per_token(self, params, tokens, generator=None):
        """``(losses, mask)``, both ``[b/dp, s/cp]``: this rank's
        per-token next-token losses (fp32) and the mask that drops the
        global last position."""
        from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

        cp, c = _size_index(self._cp_axis)
        tokens = self._shard(tokens)
        logits = self._local_logits(params, tokens, c, generator)
        # the shard's last label is the next rank's first token
        first = tokens[:, :1]
        nxt = first if cp == 1 else cc.ppermute(
            first, self._cp_axis, [(i, (i - 1) % cp) for i in range(cp)])
        labels = torch.cat([tokens[:, 1:], nxt], dim=1)
        # the logits flattened in their own s-major order, the small labels
        # transposed instead; fp32 losses from them in their storage dtype
        per_tok = softmax_cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels.t().reshape(-1),
            padding_idx=-1, half_to_float=True).reshape(
                labels.shape[1], labels.shape[0]).t()
        mask = torch.ones_like(per_tok)
        if c == cp - 1:
            mask[:, -1] = 0.0
        return per_tok, mask

    def __call__(self, params, tokens, generator=None):
        """The loss over the global ``tokens`` (the same value on every
        rank); ``generator`` turns dropout on (``None``: deterministic)."""
        per_tok, mask = self.per_token(params, tokens, generator)
        total, count = (per_tok * mask).sum(), mask.sum()
        if cc.bound_axis_size(self._axes) > 1:
            total = mappings.reduce_from_tensor_model_parallel_region(
                total, self._axes)
            count = cc.all_reduce(count, self._axes)
        return total / count

    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """After the loss's backward: every gradient summed over ``(dp,
        cp)``, in place (skipped at one rank)."""
        grads = [p.grad for p in tree_leaves(params) if p.grad is not None]
        if grads and cc.bound_axis_size(self._axes) > 1:
            reduced = all_reduce_gradients(grads, self._axes,
                                           gradient_average=False)
            torch._foreach_copy_(grads, reduced)


def _cp_tree(params: GPT3DParams, num_layers: int) -> dict:
    layers = merge_layer_stack(params.layers, num_layers)
    tree = {"embedding": params.embedding}
    for i in range(num_layers):
        tree[f"layer_{i}"] = tree_map(lambda t, i=i: t[i], layers)
    tree["final_ln"] = params.final_ln
    return tree


def build_gpt_cp(
    config: TransformerConfig,
    *,
    mesh=None,
    dp_axis: str = DATA_AXIS,
    cp_axis: str = CONTEXT_AXIS,
    device=None,
):
    """Return ``(init_fn, make_loss_fn, make_train_step)``; every rank of
    the grid calls them.

    ``config.context_axis`` must equal ``cp_axis`` and
    ``config.tensor_axis`` must be ``None`` (cp x tp is not this
    harness's).  ``tokens: [global_batch, seq]``, the same on every rank:
    each rank takes its block (batch over ``dp_axis``, sequence over
    ``cp_axis``); ``seq / cp`` must fit ``max_position_embeddings``.

    - ``init_fn(seed=0, sample_tokens=None, params=None) -> (params,
      specs)``: ``{"embedding", "layer_<i>", "final_ln"}``, leaf tensors
      that require gradients in ``config.param_dtype`` on ``device``, every
      spec replicated.  ``params``: the JAX harness's tree with numpy
      leaves (:func:`apex_tpu_torch.serving.bridge.from_flax_gpt_cp`), the
      port's, or a :class:`GPT3DParams`; else :func:`init_gpt_params` from
      ``seed`` (the serial model's weights of that seed).
    - ``make_loss_fn(specs) -> loss_fn``: ``loss_fn(params, tokens,
      generator=None)`` the global loss; ``loss_fn.per_token`` this rank's
      per-token losses and mask; ``loss_fn.reduce_gradients(params)``
      after the backward.
    - ``make_train_step(opt, specs) -> step``: ``step(params, tokens,
      generator=None) -> loss`` (``opt`` over the leaves of ``params``,
      updating them in place).

    ``generator`` (a ``torch.Generator`` on ``device``) turns dropout on,
    which the reference's harness never does: Ulysses then runs attention
    dropout in the kernels; ring attention refuses it."""
    from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
    from apex_tpu_torch.ops.softmax import AttnMaskType
    from apex_tpu_torch.serving.bridge import from_flax_gpt_cp
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        functional_layer,
    )
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        Embedding,
        ParallelTransformerLayer,
        parallel_lm_logits,
    )

    del mesh
    cfg = config
    if cfg.context_axis != cp_axis:
        raise ValueError(
            f"config.context_axis ({cfg.context_axis!r}) must equal "
            f"cp_axis ({cp_axis!r})")
    if cfg.tensor_axis is not None:
        raise ValueError("context-parallel harness requires tensor_axis="
                         "None (use Ulysses for head-sharded attention)")
    device = resolve_device(device)
    embed = Embedding(cfg, device=device)
    layer = ParallelTransformerLayer(
        cfg, self_attn_mask_type=AttnMaskType.causal, device=device)
    final_ln = FusedLayerNorm(cfg.hidden_size, cfg.layernorm_epsilon,
                              param_dtype=cfg.param_dtype, device=device)

    def local_logits(params, tokens, c, generator):
        """Logits ``[s_local, b_local, vocab]`` of this rank's block."""
        s_local = tokens.shape[1]
        pos = None
        if cfg.position_embedding_type == "learned":
            pos = c * s_local + torch.arange(s_local,
                                             device=tokens.device)[None, :]
        h = functional_layer(embed, params["embedding"], tokens, pos,
                             generator)
        for i in range(cfg.num_layers):
            h = functional_layer(layer, params[f"layer_{i}"], h, None,
                                 generator)
        h = functional_layer(final_ln, params["final_ln"], h)
        return parallel_lm_logits(
            h, params["embedding"]["word_embeddings"]["embedding"], cfg)

    def init_fn(seed: int = 0, sample_tokens=None, params=None):
        del sample_tokens
        if params is None:
            serial = dataclasses.replace(cfg, context_axis=None)
            params = init_gpt_params(serial, seed, device=device)
        if isinstance(params, GPT3DParams):
            params = _cp_tree(params, cfg.num_layers)
        elif not isinstance(tree_leaves(params)[0], torch.Tensor):
            params = from_flax_gpt_cp(params)
        params = tree_map(
            lambda t: t.detach().to(device=device, dtype=cfg.param_dtype,
                                    copy=True).requires_grad_(True), params)
        return params, tree_map(lambda _: PartitionSpec(), params)

    def make_loss_fn(param_specs):
        del param_specs
        return _CPLoss(local_logits, dp_axis, cp_axis)

    def make_train_step(opt, param_specs):
        loss_fn = make_loss_fn(param_specs)

        def step(params, tokens, generator: Optional[torch.Generator] = None):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, tokens, generator)
            loss.backward()
            loss_fn.reduce_gradients(params)
            opt.step()
            return loss.detach()

        return step

    return init_fn, make_loss_fn, make_train_step
