"""The 3D-parallel GPT training step, dp x pp(x vpp) x tp(+sp), and the
GPT parameter tree (port of
:mod:`apex_tpu.transformer.testing.gpt_parallel_train`).

:class:`GPT3DParams` is the JAX package's tree (``embedding``, stacked
``layers``, ``final_ln``, with its leaf names) holding torch tensors, and
:func:`init_gpt_params` draws it with the Flax init's distributions
(normal with ``init_method_std`` for the embeddings and the input-facing
kernels, ``std / sqrt(2 * num_layers)`` for the output-facing ones, zero
biases, unit LayerNorm scales) from a ``torch.Generator`` seeded by the
caller; with ``num_experts`` the MLP's leaves are the Switch MLP's
(``router [L, h, E]`` in fp32, the expert stacks ``w1 [L, E, h, ffn]``,
``b1``, ``w2 [L, E, ffn, h]``, ``b2``, at the reference's layout).

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
    if cfg.num_experts is not None:
        E = cfg.num_experts
        mlp = {"router": torch.randn((L, h, E), generator=gen, device=device,
                                     dtype=torch.float32).mul_(0.02),
               "w1": normal((L, E, h, f), 0.02), "b1": zeros((L, E, f)),
               "w2": normal((L, E, f, h), 0.02 / math.sqrt(2 * E)),
               "b2": zeros((L, E, h))}
    else:
        mlp = {"dense_h_to_4h": linear(f, h, std),
               "dense_4h_to_h": linear(h, f, out_std)}
    if cfg.swiglu and cfg.num_experts is None:
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
    contains :class:`GPT3DParams` nodes (``None`` stays ``None``, an
    empty subtree as in the JAX package)."""
    def mark(node):
        if node is None:
            return None
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
                 packed_inputs, moe_aux_coeff, with_aux=False):
        self._local_loss = local_loss
        self._with_aux = with_aux
        self._specs = param_specs
        self._sp = cfg.sp
        self._dp_axis, self._tp_axis = dp_axis, tp_axis
        self._packed = packed_inputs
        self._aux_coeff = (moe_aux_coeff if cfg.num_experts is not None
                           else None)

    def __call__(self, params, batch):
        """The loss over the whole global batch (every rank holds the
        same value); ``batch`` is this rank's data-parallel slice (with
        ``packed_inputs`` the ``(tokens, segment_ids)`` pair).  With
        ``with_aux`` (the telemetry variant) ``(loss, aux_mb)``: the
        dp-mean per-microbatch MoE aux ``[m]`` (zeros for dense configs,
        detached), which rode the same dp reduction as extra elements."""
        vec = self._local_loss(params, batch, self._with_aux)
        dp = cc.bound_axis_size(self._dp_axis)
        if dp > 1:
            # the shards' sum, its gradient each shard's own: the dp sum of
            # the parameters' gradients (reduce_gradients) completes it
            vec = mappings.reduce_from_tensor_model_parallel_region(
                vec, self._dp_axis) / dp
        base = 1
        if self._packed:
            # mean of sums over mean of counts: the exact masked mean,
            # however unevenly the padding falls on the shards; the MoE
            # aux term rides as a third element, added after the division
            loss = vec[0] / vec[1]
            base = 2
            if self._aux_coeff is not None:
                loss = loss + self._aux_coeff * vec[2]
                base = 3
        else:
            loss = vec[0]
        if self._with_aux:
            return loss, vec[base:].detach()
        return loss

    def _not_split_over(self, params, axis):
        """The leaves of ``params`` whose spec does not name ``axis``."""
        # (a spec is a tuple: walk the params' structure, not its)
        whole = tree_leaves(tree_map(lambda p, spec: axis not in spec,
                                     params, self._specs))
        return [p for p, w in zip(tree_leaves(params), whole) if w]

    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """After the loss's backward: the gradients of the leaves that
        are whole on every tensor-parallel rank but met only its sequence
        shard (under sequence parallelism) summed over ``tp``, then every
        gradient summed over ``dp`` but those of leaves split over it (the
        expert stacks under ``expert_axis="dp"``, whole on their owner);
        in place.  A group of one rank is skipped."""
        jobs = []
        if self._sp:
            jobs.append((self._tp_axis,
                         self._not_split_over(params, self._tp_axis)))
        jobs.append((self._dp_axis,
                     self._not_split_over(params, self._dp_axis)))
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
      between the backward and that check.  ``collect_stats`` appends a
      :class:`~apex_tpu_torch.observability.trainstats.PartialTrainStats`
      to what the step returns: ``step(params, tokens) -> (loss,
      stats)``, ``step(params, tokens, sentinel) -> (sentinel, loss,
      stats)`` (``loss_scale``, ``grad_scale`` and ``skipped_steps``
      filled in).  Its norms are this rank's partial sums
      (:func:`~apex_tpu_torch.observability.trainstats.
      device_partial_norms`, no collective), taken from the gradients and
      the pre-update parameters under ``torch.no_grad()``, and the
      per-microbatch MoE aux rides the loss's own reductions as extra
      elements, so the step makes the bare step's collectives and no host
      sync, and its parameters and optimizer state are the bare step's
      bit for bit.

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

    ``config.num_experts``: each layer's MLP is a Switch MLP
    (:class:`~apex_tpu_torch.transformer.moe.SwitchMLP`), its expert
    stacks split over ``config.expert_axis`` (``infer_param_specs(...,
    ep_axis=)``, each rank holding its experts; their gradients are not
    summed over that axis).  A ``(1,)`` aux slot per microbatch rides the
    pipeline beside the activations, each stage adding its layer's
    load-balancing loss (:func:`~apex_tpu_torch.transformer.moe.
    collect_moe_aux`); the loss adds ``moe_aux_coeff`` times the
    microbatches' mean aux, averaged over ``tp`` under sequence
    parallelism (each tensor rank routes its own sequence shard; without
    it the value is the same on every tensor rank), and under
    ``packed_inputs`` after the masked division.
    """
    from apex_tpu_torch.data.sequence import segment_loss_mask
    from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm
    from apex_tpu_torch.ops.softmax import AttnMaskType
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        pipeline_apply,
        split_into_microbatches,
    )
    from apex_tpu_torch.transformer.moe import collect_moe_aux
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

    cfg = config
    moe = cfg.num_experts is not None
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
        ep_axis = cfg.expert_axis
        specs = infer_param_specs(local, axis=tp_axis, ep_axis=ep_axis)
        if cfg.tp_world > 1:
            local = shard_params(local, specs, cc.axis_index(tp_axis),
                                 cfg.tp_world, axis=tp_axis)
        ep = cc.bound_axis_size(ep_axis) if moe else 1
        if ep > 1 and ep_axis != tp_axis:
            local = shard_params(local, specs, cc.axis_index(ep_axis), ep,
                                 axis=ep_axis)
        router = local.layers["mlp"]["router"] if moe else None
        local = tree_map(lambda t: t.detach().to(
            device=device, dtype=cfg.param_dtype, copy=True), local)
        if moe:
            # fp32 whatever param_dtype, as the reference's SwitchMLP holds it
            local.layers["mlp"]["router"] = router.detach().to(
                device=device, dtype=torch.float32, copy=True)
        return tree_map(lambda t: t.requires_grad_(True), local), specs

    def stage_fn(lp, xa):
        """One layer on a microbatch's activation tuple: ``x``, then the
        MoE aux slot (with ``num_experts``), then the segment ids (with
        ``block_diagonal``)."""
        x, *rest = xa
        aux = rest.pop(0) if moe else None
        seg = rest.pop(0) if block_diagonal else None
        out = [functional_layer(layer, lp, x, None, None, seg)]
        if moe:
            out.append(aux + collect_moe_aux(layer))
        if block_diagonal:
            out.append(seg)
        return tuple(out)

    def local_loss(p: GPT3DParams, batch, with_aux: bool = False):
        """This dp shard's loss as a ``(1,)`` vector (packed: ``[masked
        sum, masked count]``); every pipeline and tensor rank holds the
        same value.  ``with_aux`` appends the per-microbatch MoE aux
        ``[m]`` (detached; zeros for dense configs, which never read the
        pipeline's aux carry)."""
        tokens, segments = batch if packed_inputs else (batch, None)
        mbs = split_into_microbatches(tokens, m)
        # the embedding of the whole batch, its batch dim then split into
        # the microbatches' rows (split_into_microbatches' order)
        h = functional_layer(embed, p.embedding, tokens)  # [s(/tp), b, hid]
        h = h.reshape(h.shape[0], m, -1, h.shape[-1]).transpose(0, 1) \
            .contiguous()                                 # [m, s, b/m, hid]
        inputs = [h]
        if moe:
            # the per-microbatch (1,) aux slot; bubble ticks never reach
            # an exit, so they add nothing
            inputs.append(torch.zeros((m, 1), dtype=torch.float32,
                                      device=h.device))
        if block_diagonal:
            inputs.append(split_into_microbatches(segments, m))
        outs = pipeline_apply(stage_fn, p.layers, tuple(inputs),
                              axis=pp_axis, num_chunks=vpp,
                              params_already_local=True,
                              remat_ticks=remat_ticks)
        out = outs[0]
        aux_term = aux_mb = None
        if with_aux:
            # telemetry rider: observational only, cut from the graph so
            # the backward (and the gradients, bit for bit) is the bare one
            aux_mb = (outs[1].detach().reshape(m) if moe else
                      torch.zeros((m,), dtype=torch.float32, device=h.device))
        if moe:
            aux_term = outs[1].mean().reshape(1)
            if cfg.sp:
                # each tensor rank routed its own sequence shard: the
                # mean over tp, its gradient each rank's share (the
                # router's and experts' gradients are then summed over tp);
                # the telemetry vector rides the same reduction
                if with_aux:
                    red = mappings.reduce_from_tensor_model_parallel_region(
                        torch.cat([aux_term, aux_mb]), tp_axis) / cfg.tp_world
                    aux_term, aux_mb = red[:1], red[1:].detach()
                else:
                    aux_term = \
                        mappings.reduce_from_tensor_model_parallel_region(
                            aux_term, tp_axis) / cfg.tp_world

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
            parts = [torch.stack(sums).sum().reshape(1),
                     torch.clamp(torch.stack(counts).sum(), min=1.0)
                     .reshape(1)]
            if moe:
                parts.append(aux_term)
            if with_aux:
                parts.append(aux_mb)
            return torch.cat(parts)
        losses = torch.stack([
            gpt_next_token_loss(logits_of(out[i]), mbs[i], cfg).mean()
            for i in range(m)])
        ce = losses.mean().reshape(1)
        if aux_term is not None:
            ce = ce + moe_aux_coeff * aux_term
        return ce if aux_mb is None else torch.cat([ce, aux_mb])

    def make_loss_fn(param_specs):
        return _Loss(local_loss, param_specs, cfg, dp_axis, tp_axis,
                     packed_inputs, moe_aux_coeff)

    def make_aux_loss_fn(param_specs):
        """Telemetry variant of ``make_loss_fn``: ``loss_fn(params,
        tokens) -> (loss, aux_mb)`` with ``aux_mb`` the dp-mean
        per-microbatch MoE aux ``[m]`` (zeros for dense configs).  The
        same collectives as the bare loss: the aux vector widens the
        existing dp (and, under sequence parallelism, tp) reductions, and
        is cut from the graph, so the gradients are the bare ones."""
        return _Loss(local_loss, param_specs, cfg, dp_axis, tp_axis,
                     packed_inputs, moe_aux_coeff, with_aux=True)

    def stats_norms(param_specs):
        """This rank's norm partials (``trainstats.device_partial_norms``):
        the layer stack is split over ``pp`` (each pipeline rank holds its
        own stages) though its specs do not name it."""
        from apex_tpu_torch.observability import trainstats as ts
        from apex_tpu_torch.transformer.tensor_parallel.partition import (
            PartitionSpec,
        )

        split = GPT3DParams(
            embedding=_map(param_specs.embedding,
                           lambda _: PartitionSpec()),
            layers=_map(param_specs.layers,
                        lambda _: PartitionSpec(pp_axis)),
            final_ln=_map(param_specs.final_ln, lambda _: PartitionSpec()))
        return ts.device_partial_norms(mesh, param_specs, split_leaves=split)

    def make_train_step(opt, param_specs, scaler=None, grad_tap=None,
                        collect_stats: bool = False):
        from apex_tpu_torch.observability import trainstats as ts

        if collect_stats:
            loss_fn = make_aux_loss_fn(param_specs)
            partial_norms = stats_norms(param_specs)
        else:
            loss_fn = make_loss_fn(param_specs)

        if scaler is None:
            def step(params, tokens):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, tokens)
                if collect_stats:
                    loss, aux_mb = loss
                loss.backward()
                loss_fn.reduce_gradients(params)
                if collect_stats:
                    # the norms of the pre-update parameters
                    grads = tree_map(lambda p: p.grad, params)
                    stats = ts.partial_train_stats(
                        loss.detach(), partial_norms(grads, params),
                        moe_aux=aux_mb)
                opt.step()
                if collect_stats:
                    return loss.detach(), stats
                return loss.detach()

            return step

        from apex_tpu_torch.resilience.sentinel import sentinel_guarded_apply

        def guarded_step(params, tokens, sent):
            scale_used = sent.scaler.scale
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, tokens)
            if collect_stats:
                loss, aux_mb = loss
            (loss * scale_used).backward()
            loss_fn.reduce_gradients(params)
            grads = tree_map(lambda p: p.grad, params)
            if grad_tap is not None:
                grads = grad_tap(grads)
                for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                    p.grad = g
            if collect_stats:
                scale = torch.as_tensor(scale_used).detach().clone()
                partials = partial_norms(grads, params)
            new_sent = sentinel_guarded_apply(
                scaler, opt, grads, sent, axes=(dp_axis, pp_axis, tp_axis),
                grad_scale=scale_used)
            if not collect_stats:
                return new_sent, loss.detach()
            stats = ts.partial_train_stats(
                loss.detach(), partials, grad_scale=scale, loss_scale=scale,
                skipped_steps=new_sent.skipped_steps, moe_aux=aux_mb)
            return new_sent, loss.detach(), stats

        return guarded_step

    return init_fn, make_loss_fn, make_train_step
