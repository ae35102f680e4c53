"""Flat-bucket ZeRO training with gradient accumulation: the port of the
repository's ``examples/zero_grad_accum.py`` (the usage shape of the
reference's ``apex/contrib/test/optimizers/test_dist_adam.py``).

Parameters replicated, optimizer state sharded 1/dp (ZeRO-2), the batch
split over the data-parallel ranks.  Each step accumulates
``MICROBATCHES`` local microbatch gradients with no collective, then
``DistributedFusedAdam``'s reduce-scatter and all-gather run once a
bucket (``n_buckets=2``); on a grid with a ``dcn`` axis the reduction is
hierarchical (reduce-scatter over ``dp``, the shard all-reduced over
``dcn``).

Run on the card, one process a GPU::

    torchrun --nproc-per-node N -m apex_tpu_torch.examples.zero_grad_accum

or on the CPU over gloo (``--device cpu``).  Without a launcher the job
is one process.  :func:`main` uses the process group and the rank grid
when the caller has set them up.
"""

from __future__ import annotations

import argparse

MICROBATCHES = 4


def main(steps: int = 40, device=None, log_every: int = 5):
    """Train the two-layer MLP ``steps`` steps; returns the losses."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    device = resolve_device(device)
    if not dist.is_initialized():
        parallel.initialize_distributed(device=device)
    if not parallel.model_parallel_is_initialized():
        parallel.initialize_model_parallel()
    print(parallel.mesh.get_rank_info())

    D, H = 64, 128
    rng = np.random.RandomState(0)
    w1 = torch.tensor((rng.randn(D, H) / np.sqrt(D)).astype(np.float32),
                      device=device, requires_grad=True)
    w2 = torch.tensor((rng.randn(H, D) / np.sqrt(H)).astype(np.float32),
                      device=device, requires_grad=True)

    def loss_fn(batch):
        x, y = batch
        return torch.mean((torch.relu(x @ w1) @ w2 - y) ** 2)

    # n_buckets=2: two reduce-scatters and two all-gathers a step;
    # outer_axis="dcn" (the default) makes the same configuration
    # hierarchical on a grid with a dcn axis
    opt = DistributedFusedAdam([w1, w2], lr=1e-3, weight_decay=1e-2,
                               n_buckets=2)
    parallel.zero_init(opt, [w1, w2])
    step = parallel.zero_data_parallel_train_step(
        loss_fn, opt, microbatches=MICROBATCHES)

    losses = []
    for i in range(steps):
        x = torch.from_numpy(
            rng.randn(64 * MICROBATCHES, D).astype(np.float32)).to(device)
        batch = parallel.dp_shard_batch((x, x))   # identity target
        losses.append(float(step(batch)))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:3d} loss {losses[-1]:.5f}")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.steps, args.device)
