"""A one-rank gloo process group and rank grid in the test process.

The port's ZeRO optimizers and the checkpoints of their state run over
the live grid's collectives, so a test at world size 1 joins a group of
one rank first.  A module imports ``world1`` and names it as a fixture;
the group and the grid are torn down after the test.
"""

import pytest


@pytest.fixture
def world1():
    import torch.distributed as dist

    from apex_tpu_torch import parallel

    parallel.initialize_distributed(device="cpu")
    try:
        yield parallel.initialize_model_parallel()
    finally:
        parallel.destroy_model_parallel()
        dist.destroy_process_group()
