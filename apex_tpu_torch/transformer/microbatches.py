"""Microbatch calculators — number of microbatches per global step (a
copy of :mod:`apex_tpu.transformer.microbatches`, which is host code
only; the port imports nothing of the JAX package).

Behavioral spec: ``apex/transformer/microbatches.py`` — factory
``build_num_microbatches_calculator:26``, ``ConstantNumMicroBatches:93``,
``RampupBatchsizeNumMicroBatches:112``.  Pure host-side arithmetic (no device
state in the reference either); reproduced 1:1 because the ramp-up semantics
(batch size grows linearly in ``batch_size_increment`` steps over
``ramup_samples`` consumed samples) are part of the training recipe.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "build_num_microbatches_calculator",
    "NumMicroBatchesCalculator",
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
]


class NumMicroBatchesCalculator:
    """Base interface (``microbatches.py:78-91``)."""

    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Fixed ``global // (micro * dp)`` microbatches (``microbatches.py:93-110``)."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("number of microbatches must be at least 1")
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear batch-size ramp-up (``microbatches.py:112-194``).

    Batch size starts at ``start_batch_size`` and increases by
    ``batch_size_increment`` every
    ``ramup_samples / ((global - start) / increment)`` consumed samples until
    it reaches ``global_batch_size``.
    """

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        super().__init__()
        if start_batch_size <= 0 or batch_size_increment <= 0:
            raise ValueError("start batch size and increment must be positive")
        if ramup_samples < 0:
            raise ValueError("ramp-up samples must be non-negative")
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )

        diff_batch_size = global_batch_size - start_batch_size
        if diff_batch_size < 0:
            raise ValueError(
                "expected global batch size to be greater than or equal to "
                "start batch size"
            )
        if diff_batch_size % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff_batch_size}) to "
                f"be divisible by global batch size increment "
                f"({batch_size_increment})"
            )
        num_increments = diff_batch_size // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0 else 0
        )

        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool):
        if (consumed_samples > self.ramup_samples
                or self.rampup_samples_per_increment == 0):
            # Past ramp-up, or degenerate ramp (start == global or zero
            # ramp-up samples): jump straight to the full batch size.
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size
            )
        if consistency_check:
            if (self.current_global_batch_size
                    % self.micro_batch_times_data_parallel_size != 0):
                raise ValueError(
                    f"current global batch size "
                    f"({self.current_global_batch_size}) is not divisible by "
                    f"micro-batch-size ({self.micro_batch_size}) times data "
                    f"parallel size ({self.data_parallel_size})"
                )
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size
        )


def build_num_microbatches_calculator(
    rank: int = 0,
    rampup_batch_size=None,
    global_batch_size: int = 1,
    micro_batch_size: int = 1,
    data_parallel_size: int = 1,
) -> NumMicroBatchesCalculator:
    """Factory, ``microbatches.py:26-76``.  ``rampup_batch_size`` is the
    reference's 3-element list ``[start, increment, ramup_samples]``."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "expected the following format: --rampup-batch-size <start batch "
            "size> <batch size increment> <ramp-up samples>"
        )
    start_batch_size = int(rampup_batch_size[0])
    batch_size_increment = int(rampup_batch_size[1])
    ramup_samples = int(rampup_batch_size[2])
    return RampupBatchsizeNumMicroBatches(
        start_batch_size, batch_size_increment, ramup_samples,
        global_batch_size, micro_batch_size, data_parallel_size,
    )
