"""Rank-side half of the port's RN50 SyncBN trace test
(``test_torch_l1_rn50.py``).

:func:`syncbn_steps` runs on every rank of an eight-rank gloo group
started by :func:`apex_tpu_torch.parallel.launch.start_multiprocess`:
for each SyncBN cell it replays steps from the states the test saved
(``torch.save``d :meth:`~apex_tpu_torch.testing.l1.RN50Trainer.snapshot`
dicts), each rank on its image of the batch, and returns each step's
loss, gradient norm and loss scale; and it runs one ``SyncBatchNorm``
over two index groups of four ranks (``axis_index_groups``), forward and
backward, one image a rank.  Torch and the port only: the spawned ranks
never import JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.testing import l1

GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]


def group_inputs():
    """Eight images ``[8, 6, 5, 5]``, the output gradient of the same
    shape, and the BN parameters, the same on every rank."""
    rng = np.random.RandomState(11)
    x = (rng.randn(8, 6, 5, 5) * 2 + 0.5).astype(np.float32)
    g = rng.randn(8, 6, 5, 5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    return x, g, scale, bias


def _grouped_bn():
    """This rank's output, input gradient, parameter gradients (its share)
    and running statistics of a SyncBatchNorm summed within its index
    group, as numpy."""
    from apex_tpu_torch.parallel import SyncBatchNorm

    rank = dist.get_rank()
    x, g, scale, bias = group_inputs()
    m = SyncBatchNorm(6, momentum=0.2, fuse_relu=True, axis_name="dp",
                      axis_index_groups=GROUPS, device="cpu")
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.tensor(x[rank:rank + 1], requires_grad=True)
    y = m(xt)
    (y * torch.from_numpy(g[rank:rank + 1])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dscale": m.scale.grad.numpy(), "dbias": m.bias.grad.numpy(),
            "running_mean": m.running_mean.numpy(),
            "running_var": m.running_var.numpy()}


def syncbn_steps(state_dir, cells, steps):
    parallel.initialize_model_parallel()
    try:
        out = {"groups": _grouped_bn()}
        x_np, y_np = l1.rn50_batch()
        for cell in cells:
            tr = l1.RN50Trainer(cell, device="cpu", seed=None)
            x, y = parallel.dp_shard_batch(
                (tr.images(x_np), torch.as_tensor(y_np)), axis="dp")
            rows = []
            for i in range(steps):
                snap = torch.load(os.path.join(state_dir, f"{i}.pt"),
                                  weights_only=False)  # the test's own
                if tr.scaler is None:
                    snap["scaler"] = None
                tr.restore(snap)
                loss, grad_norm = tr.step(x, y)
                rows.append((float(loss), float(grad_norm),
                             float(tr.sstate.scale) if tr.scaler else None))
            out[cell] = rows
        return out
    finally:
        parallel.destroy_model_parallel()
