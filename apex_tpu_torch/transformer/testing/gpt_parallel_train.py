"""The 3D-parallel GPT training step, dp x pp(x vpp) x tp(+sp), and the
GPT parameter tree (port of
:mod:`apex_tpu.transformer.testing.gpt_parallel_train`).

:class:`GPT3DParams` is the JAX package's tree (``embedding``, stacked
``layers``, ``final_ln``, with its leaf names) holding torch tensors, and
:func:`init_gpt_params` draws it with the Flax init's distributions
(normal with ``init_method_std`` for the embeddings and the input-facing
kernels, ``std / sqrt(2 * num_layers)`` for the output-facing ones, zero
biases, unit LayerNorm scales) from a ``torch.Generator`` seeded by the
caller.

:func:`build_gpt_3d` is the runtime's integration point, as in the
reference: the vocab-parallel embedding, the transformer layers through
the rotation pipeline over ``pp`` with virtual chunks (one layer a
virtual stage), the tied vocab-parallel head and cross entropy, each
tensor-parallel over ``tp`` with Megatron sequence parallelism, and the
loss averaged over ``dp``.  Each rank holds its ``(dp, pp, tp)`` shard:
the embedding and ``final_ln`` whole over ``pp``, the layer stack
``[vpp, 1, ...]`` (rank ``s`` holds chunk ``c`` = virtual stage ``c * pp
+ s`` of the ``[vpp, pp, ...]`` stack, a plain reshape of layer order).
The single-device step is :func:`apex_tpu_torch.testing.l1.train_step`,
the one without a pipeline :func:`apex_tpu_torch.testing.l1.
parallel_train_step`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp._tree import tree_leaves, tree_map
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel.distributed import all_reduce_gradients
from apex_tpu_torch.parallel.mesh import DATA_AXIS, PIPELINE_AXIS, TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["GPT3DParams", "init_gpt_params", "merge_layer_stack",
           "build_gpt_3d", "gpt3d_logical_folds"]


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


def gpt3d_logical_folds(tree):
    """The fold-count tree of ``tree`` (the JAX package's resharding
    annotation): ``2`` on every leaf of a :class:`GPT3DParams` ``layers``
    stack (its ``[vpp, pp]`` dims are one folded logical axis), ``0``
    elsewhere; works on any tree of dicts, lists and named tuples that
    contains :class:`GPT3DParams` nodes."""
    def mark(node):
        if isinstance(node, GPT3DParams):
            return GPT3DParams(embedding=tree_map(lambda _: 0, node.embedding),
                               layers=tree_map(lambda _: 2, node.layers),
                               final_ln=tree_map(lambda _: 0, node.final_ln))
        if isinstance(node, dict):
            return {k: mark(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(mark(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(mark(v) for v in node)
        return 0

    return mark(tree)


class _Loss:
    """The global (dp-mean) loss of the 3D step, and the reductions that
    make its gradients whole; see :func:`build_gpt_3d`."""

    def __init__(self, local_loss, param_specs, cfg, dp_axis, tp_axis,
                 packed_inputs):
        self._local_loss = local_loss
        self._specs = param_specs
        self._sp = cfg.sp
        self._dp_axis, self._tp_axis = dp_axis, tp_axis
        self._packed = packed_inputs

    def __call__(self, params, batch):
        """The loss over the whole global batch (every rank holds the
        same value); ``batch`` is this rank's data-parallel slice (with
        ``packed_inputs`` the ``(tokens, segment_ids)`` pair)."""
        vec = self._local_loss(params, batch)
        dp = cc.bound_axis_size(self._dp_axis)
        if dp > 1:
            # the shards' sum, its gradient each shard's own: the dp sum of
            # the parameters' gradients (reduce_gradients) completes it
            vec = mappings.reduce_from_tensor_model_parallel_region(
                vec, self._dp_axis) / dp
        if self._packed:
            # mean of sums over mean of counts: the exact masked mean,
            # however unevenly the padding falls on the shards
            return vec[0] / vec[1]
        return vec[0]

    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """After the loss's backward: the gradients of the leaves that
        are whole on every tensor-parallel rank but met only its sequence
        shard (under sequence parallelism) summed over ``tp``, then every
        gradient summed over ``dp``; in place.  A group of one rank is
        skipped."""
        leaves = tree_leaves(params)
        jobs = []
        if self._sp:
            # (a spec is a tuple: walk the params' structure, not its)
            whole = tree_leaves(tree_map(
                lambda p, spec: self._tp_axis not in spec, params,
                self._specs))
            jobs.append((self._tp_axis,
                         [p for p, w in zip(leaves, whole) if w]))
        jobs.append((self._dp_axis, leaves))
        for axis, ps in jobs:
            grads = [p.grad for p in ps if p.grad is not None]
            if not grads or cc.bound_axis_size(axis) == 1:
                continue
            reduced = all_reduce_gradients(grads, axis,
                                           gradient_average=False)
            torch._foreach_copy_(grads, reduced)


def build_gpt_3d(
    config: TransformerConfig,
    *,
    num_chunks: int = 1,
    num_microbatches: int = 2,
    mesh=None,
    dp_axis: str = DATA_AXIS,
    pp_axis: str = PIPELINE_AXIS,
    tp_axis: str = TENSOR_AXIS,
    moe_aux_coeff: float = 1e-2,
    remat_ticks=None,
    packed_inputs: bool = False,
    block_diagonal: bool = False,
    device=None,
):
    """Return ``(init_fn, make_loss_fn, make_train_step)``; every rank of
    the grid calls them (:func:`apex_tpu_torch.parallel.
    initialize_model_parallel`; without a grid, one rank).

    - ``init_fn(seed=0, sample_tokens=None, params=None) -> (params,
      param_specs)``: this rank's shard of the global parameters, leaf
      tensors that require gradients, in ``config.param_dtype`` on
      ``device``, and their :class:`~apex_tpu_torch.transformer.
      tensor_parallel.PartitionSpec` tree.  The global parameters are
      ``params`` (the JAX package's ``GPT3DParams`` with numpy leaves,
      carried by :func:`apex_tpu_torch.serving.bridge.from_jax_params`, or
      the port's; layers ``[L, ...]`` or ``[vpp, pp, ...]``), else
      :func:`init_gpt_params` from ``seed``.  ``sample_tokens`` is
      accepted for the reference's signature.
    - ``make_loss_fn(param_specs) -> loss_fn``: ``loss_fn(params,
      tokens)`` is the dp-mean loss (``tokens`` this rank's ``[b/dp, s]``
      slice); after its backward, ``loss_fn.reduce_gradients(params)``
      sums the sequence-parallel partial gradients over ``tp`` and every
      gradient over ``dp``, the reductions the reference's ``shard_map``
      transpose inserts, and ``.grad`` is then the loss's gradient.
    - ``make_train_step(opt, param_specs, scaler=None, grad_tap=None,
      collect_stats=False)``: ``step(params, tokens) -> loss`` (``opt``
      an optimizer over the leaves of ``params``, updating them in
      place); with an amp ``scaler``, ``step(params, tokens, sentinel) ->
      (sentinel, loss)``: the loss scaled, the gradients checked on every
      rank and the flag agreed over the grid, the update skipped (the
      parameters and optimizer state keep their bits) on an overflow and
      ``sentinel.skipped_steps`` counted (:mod:`apex_tpu_torch.
      resilience.sentinel`); ``grad_tap`` (``grads -> grads``) runs
      between the backward and that check.

    ``config.num_layers`` must be ``pp * num_chunks``.  The batch splits
    into ``num_microbatches`` microbatches; the layers run through
    :func:`~apex_tpu_torch.transformer.pipeline_parallel.pipeline_apply`
    (each tick's stage recomputed in the backward; ``remat_ticks`` its
    grouped-tick remat), and every pipeline rank computes the embedding,
    the head and the loss, the loss over the microbatches' mean losses.

    ``packed_inputs``: the batch is ``(tokens, segment_ids)`` and the loss
    the segment-masked mean (:func:`apex_tpu_torch.data.sequence.
    segment_loss_mask`).  ``block_diagonal`` (with ``packed_inputs`` and
    ``config.use_flash_attention``): the segment ids ride the pipeline
    beside the activations and reach the flash kernels' segment masking,
    so attention is block-diagonal causal.

    Not ported (ROADMAP.md): ``config.num_experts`` (mixture of experts,
    section A.2 item 2) raises here, and ``collect_stats`` (the
    observability stats, section A.3) in ``make_train_step``;
    ``moe_aux_coeff`` is accepted for the reference's signature.
    """
    from apex_tpu_torch.data.sequence import segment_loss_mask
    from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
    from apex_tpu_torch.ops.softmax import AttnMaskType
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        pipeline_apply,
        split_into_microbatches,
    )
    from apex_tpu_torch.transformer.tensor_parallel.partition import (
        infer_param_specs,
        shard_params,
    )
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        functional_layer,
        gpt_next_token_loss,
    )
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        Embedding,
        ParallelTransformerLayer,
        parallel_lm_logits,
    )

    del moe_aux_coeff
    cfg = config
    if cfg.num_experts is not None:
        raise NotImplementedError(
            "build_gpt_3d with num_experts: mixture of experts is not "
            "ported yet (ROADMAP.md, section A.2, item 2)")
    if block_diagonal:
        if not packed_inputs:
            raise ValueError(
                "block_diagonal requires packed_inputs=True — the segment "
                "ids that define the blocks arrive with the packed batch")
        if not cfg.use_flash_attention:
            raise ValueError(
                "block_diagonal requires config.use_flash_attention: the "
                "fused-softmax attention core has no segment-mask "
                "mechanism and would silently ignore the ids")
    pp = mesh.shape[pp_axis] if mesh is not None \
        else cc.bound_axis_size(pp_axis)
    vpp = num_chunks
    if cfg.num_layers != pp * vpp:
        raise ValueError(
            f"num_layers ({cfg.num_layers}) != pp*vpp ({pp}*{vpp})")
    device = resolve_device(device)
    m = num_microbatches

    embed = Embedding(cfg, device=device)
    layer = ParallelTransformerLayer(
        cfg, self_attn_mask_type=AttnMaskType.causal, device=device)
    final_ln = FusedLayerNorm(cfg.hidden_size, cfg.layernorm_epsilon,
                              param_dtype=cfg.param_dtype, device=device)

    def init_fn(seed: int = 0, sample_tokens=None, params=None):
        del sample_tokens
        if params is None:
            params = init_gpt_params(cfg, seed, device=device)
        elif not isinstance(tree_leaves(params)[0], torch.Tensor):
            from apex_tpu_torch.serving.bridge import from_jax_params

            params = from_jax_params(params)
        s = cc.axis_index(pp_axis) if pp > 1 else 0
        layers = merge_layer_stack(params.layers, cfg.num_layers)
        layers = tree_map(
            lambda t: t.reshape((vpp, pp) + tuple(t.shape[1:]))[:, s:s + 1],
            layers)
        local = GPT3DParams(embedding=params.embedding, layers=layers,
                            final_ln=params.final_ln)
        specs = infer_param_specs(local, axis=tp_axis)
        if cfg.tp_world > 1:
            local = shard_params(local, specs, cc.axis_index(tp_axis),
                                 cfg.tp_world, axis=tp_axis)
        local = tree_map(
            lambda t: t.detach().to(device=device, dtype=cfg.param_dtype,
                                    copy=True).requires_grad_(True), local)
        return local, specs

    def stage_fn(lp, x):
        if block_diagonal:
            x, seg = x
            return functional_layer(layer, lp, x, None, None, seg), seg
        return functional_layer(layer, lp, x)

    def local_loss(p: GPT3DParams, batch):
        """This dp shard's loss as a ``(1,)`` vector (packed: ``[masked
        sum, masked count]``); every pipeline and tensor rank holds the
        same value."""
        tokens, segments = batch if packed_inputs else (batch, None)
        mbs = split_into_microbatches(tokens, m)
        # the embedding of the whole batch, its batch dim then split into
        # the microbatches' rows (split_into_microbatches' order)
        h = functional_layer(embed, p.embedding, tokens)  # [s(/tp), b, hid]
        h = h.reshape(h.shape[0], m, -1, h.shape[-1]).transpose(0, 1) \
            .contiguous()                                 # [m, s, b/m, hid]
        inputs = h
        if block_diagonal:
            inputs = (h, split_into_microbatches(segments, m))
        out = pipeline_apply(stage_fn, p.layers, inputs, axis=pp_axis,
                             num_chunks=vpp, params_already_local=True,
                             remat_ticks=remat_ticks)
        if block_diagonal:
            out = out[0]

        def logits_of(hid):
            hid = functional_layer(final_ln, p.final_ln, hid)
            return parallel_lm_logits(
                hid, p.embedding["word_embeddings"]["embedding"], cfg)

        if packed_inputs:
            seg_mbs = split_into_microbatches(segments, m)
            sums, counts = [], []
            for i in range(m):
                per_tok = gpt_next_token_loss(logits_of(out[i]), mbs[i], cfg)
                mask = segment_loss_mask(seg_mbs[i])
                sums.append((per_tok * mask).sum())
                counts.append(mask.sum())
            return torch.stack([torch.stack(sums).sum(),
                                torch.clamp(torch.stack(counts).sum(),
                                            min=1.0)])
        losses = torch.stack([
            gpt_next_token_loss(logits_of(out[i]), mbs[i], cfg).mean()
            for i in range(m)])
        return losses.mean().reshape(1)

    def make_loss_fn(param_specs):
        return _Loss(local_loss, param_specs, cfg, dp_axis, tp_axis,
                     packed_inputs)

    def make_train_step(opt, param_specs, scaler=None, grad_tap=None,
                        collect_stats: bool = False):
        if collect_stats:
            raise NotImplementedError(
                "make_train_step(collect_stats=True): the training stats "
                "of the observability package are not ported yet "
                "(ROADMAP.md, section A.3)")
        loss_fn = make_loss_fn(param_specs)

        if scaler is None:
            def step(params, tokens):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, tokens)
                loss.backward()
                loss_fn.reduce_gradients(params)
                opt.step()
                return loss.detach()

            return step

        from apex_tpu_torch.resilience.sentinel import sentinel_guarded_apply

        def guarded_step(params, tokens, sent):
            scale_used = sent.scaler.scale
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, tokens)
            (loss * scale_used).backward()
            loss_fn.reduce_gradients(params)
            grads = tree_map(lambda p: p.grad, params)
            if grad_tap is not None:
                grads = grad_tap(grads)
                for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                    p.grad = g
            new_sent = sentinel_guarded_apply(
                scaler, opt, grads, sent, axes=(dp_axis, pp_axis, tp_axis),
                grad_scale=scale_used)
            return new_sent, loss.detach()

        return guarded_step

    return init_fn, make_loss_fn, make_train_step
