"""Pipeline-parallel utilities (port of
:mod:`apex_tpu.transformer.pipeline_parallel.utils`).

The global microbatch calculator and its accessors, the loss average
over the data-parallel ranks, the parameters' L2 norm, the left-to-right
LM masks and position ids (with the per-document resets), a device
memory report from the CUDA caching allocator, and the rank-0 and
last-rank prints.  The loss average is a report: it calls
:func:`apex_tpu_torch.parallel.collectives.all_reduce`, which autograd
does not see.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.amp._tree import tree_map
from apex_tpu_torch.utils.tree import tree_l2_norm
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)

__all__ = [
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "average_losses_across_data_parallel_group",
    "calc_params_l2_norm",
    "get_ltor_masks_and_position_ids",
    "report_memory",
    "print_rank_0",
    "print_rank_last",
]

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def setup_microbatch_calculator(
    rank: int = 0,
    rampup_batch_size=None,
    global_batch_size: int = 1,
    micro_batch_size: int = 1,
    data_parallel_size: int = 1,
) -> None:
    """Build the global calculator (once; a second call raises)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError("num microbatches calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


def _destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_num_microbatches() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def average_losses_across_data_parallel_group(losses,
                                              axis: Optional[str] = None):
    """The mean of each loss, stacked, and averaged over ``axis`` (the
    data-parallel axis of the grid) when it is given."""
    averaged = torch.stack([torch.as_tensor(l).float().mean()
                            for l in losses])
    if axis is not None:
        averaged = cc.all_reduce(averaged, axis, "mean")
    return averaged


def calc_params_l2_norm(params, per_tensor: bool = False):
    """The global L2 norm of a tree of parameters in fp32, or with
    ``per_tensor`` the tree of each leaf's norm.  Each rank holds its
    shards once, so no duplicate needs filtering."""
    if per_tensor:
        return tree_map(
            lambda p: torch.linalg.vector_norm(p.detach().float()), params)
    return tree_l2_norm(params)


def get_ltor_masks_and_position_ids(
    data,
    eod_token: Optional[int] = None,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """``(attention_mask, loss_mask, position_ids)`` for a left-to-right
    LM batch ``data [b, s]``: a bool causal mask ``[1 or b, 1, s, s]``
    with True for masked out, a float loss mask with the EOD positions
    zeroed under ``eod_mask_loss``, int32 position ids ``[b, s]``.

    ``reset_position_ids`` restarts the positions after each EOD token
    (the EOD keeps its place in its document); ``reset_attention_mask``
    also masks attention across documents (the mask then per row)."""
    b, s = data.shape
    device = data.device
    att_batch = b if reset_attention_mask else 1
    causal = ~torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
    attention_mask = causal.expand(att_batch, 1, s, s)

    loss_mask = torch.ones(data.shape, dtype=torch.float32, device=device)
    if eod_mask_loss:
        if eod_token is None:
            raise ValueError("eod_mask_loss requires eod_token")
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)

    pos = torch.arange(s, dtype=torch.int32, device=device)
    position_ids = pos.expand(b, s)

    if reset_position_ids or reset_attention_mask:
        if eod_token is None:
            raise ValueError("document reset requires eod_token")
        is_eod = (data == eod_token).to(torch.int32)
        doc_id = torch.cumsum(is_eod, dim=1) - is_eod   # EOD in its document
        if reset_position_ids:
            # a document starts just after the last strictly earlier EOD
            after_eod = torch.where(is_eod == 1, pos + 1, 0)
            shifted = torch.nn.functional.pad(after_eod[:, :-1], (1, 0))
            doc_start = torch.cummax(shifted, dim=1).values
            position_ids = (pos - doc_start).to(torch.int32)
        if reset_attention_mask:
            same_doc = doc_id[:, None, :] == doc_id[:, :, None]
            attention_mask = attention_mask | ~same_doc[:, None, :, :]
    return attention_mask, loss_mask, position_ids


def report_memory(name: str = "") -> str:
    """Memory of each local CUDA device from the caching allocator
    (MiB in use, peak, and the device's total), printed on the last rank
    and returned; empty without a card."""
    lines = []
    for d in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_allocated(d) / 2**20
        peak = torch.cuda.max_memory_allocated(d) / 2**20
        limit = torch.cuda.get_device_properties(d).total_memory / 2**20
        lines.append(
            f"[{name}] cuda:{d} memory (MB) | in-use: {in_use:.1f}"
            f" | peak: {peak:.1f} | limit: {limit:.1f}")
    report = "\n".join(lines)
    print_rank_last(report)
    return report


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def print_rank_0(message: str) -> None:
    """Print on global rank 0 only."""
    if _rank_and_world()[0] == 0:
        print(message, flush=True)


def print_rank_last(message: str) -> None:
    """Print on the last global rank only."""
    rank, world = _rank_and_world()
    if rank == world - 1:
        print(message, flush=True)
