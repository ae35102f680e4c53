"""Megatron pretraining batch samplers (port of
:mod:`apex_tpu.transformer._data._batchsampler`, the reference's
``apex/transformer/_data/_batchsampler.py``).

``MegatronPretrainingSampler`` walks sample indices from
``consumed_samples`` and gives each data-parallel rank its window of every
global minibatch; ``MegatronPretrainingRandomSampler`` gives each rank a
bucket of ``total // (local_mb * dp) * local_mb`` indices, permuted per
epoch and resumable mid-epoch from ``consumed_samples``.  Both yield lists
of indices for any indexable dataset, one sampler per data-parallel rank.

The permutation is ``numpy.random.RandomState(epoch)``'s, as in the JAX
package, so both packages yield the same indices; the reference's
``torch.Generator`` permutation differs, while the contract
(deterministic per epoch, disjoint equal shards, mid-epoch resume) is
the same.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]


class _Base:
    def __len__(self) -> int:
        return self.total_samples

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new: int) -> None:
        self._local_minibatch_size = new
        self.local_minibatch_times_data_parallel_size = (
            new * self.data_parallel_size)

    @staticmethod
    def _check(total_samples, consumed_samples, local_minibatch_size,
               data_parallel_rank, data_parallel_size):
        if total_samples <= 0:
            raise ValueError(f"no sample to consume: {total_samples}")
        if consumed_samples >= total_samples:
            raise ValueError(
                f"no samples left to consume: {consumed_samples}, "
                f"{total_samples}")
        if local_minibatch_size <= 0:
            raise ValueError(
                f"local minibatch size must be greater than 0: "
                f"{local_minibatch_size}")
        if data_parallel_size <= 0:
            raise ValueError(
                f"data parallel size must be greater than 0: "
                f"{data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError(
                f"data_parallel_rank should be smaller than data parallel "
                f"size: {data_parallel_rank} < {data_parallel_size}")


class MegatronPretrainingSampler(_Base):
    """Contiguous DP-sharded sampler (reference ``:38-100``).

    Deliberate fix vs the reference: its ``__iter__`` accumulates only
    ``local_minibatch_size`` indices before slicing ``[rank*lmb :
    (rank+1)*lmb]``, which returns an empty list for every rank > 0 (an
    upstream bug — Megatron-core accumulates ``lmb * dp``).  This
    implementation accumulates the full global minibatch and slices each
    rank's disjoint window, which is the documented contract.
    """

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True):
        self._check(total_samples, consumed_samples, local_minibatch_size,
                    data_parallel_rank, data_parallel_size)
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        self.drop_last = drop_last

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.local_minibatch_times_data_parallel_size:
                start, end = self.get_start_end_idx()
                yield batch[start:end]
                batch = []
        if batch and not self.drop_last:
            start, end = self.get_start_end_idx()
            yield batch[start:end]


class MegatronPretrainingRandomSampler(_Base):
    """Randomized DP-sharded sampler (reference ``:102-180``): each rank
    owns a contiguous bucket, permuted with an epoch-seeded generator;
    ``consumed_samples`` resumes mid-epoch."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 local_minibatch_size: int, data_parallel_rank: int,
                 data_parallel_size: int):
        self._check(total_samples, max(consumed_samples, 0) % max(
            total_samples, 1), local_minibatch_size, data_parallel_rank,
            data_parallel_size)
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            local_minibatch_size * data_parallel_size)
        self.last_batch_size = (
            total_samples % self.local_minibatch_times_data_parallel_size)
        if total_samples < self.local_minibatch_times_data_parallel_size:
            raise ValueError(
                f"total_samples ({total_samples}) smaller than one global "
                f"minibatch (local_minibatch_size*data_parallel_size = "
                f"{self.local_minibatch_times_data_parallel_size})")

    def __iter__(self):
        active = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active
        current_epoch_samples = self.consumed_samples % active

        bucket_size = (self.total_samples
                       // self.local_minibatch_times_data_parallel_size
                       ) * self.local_minibatch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        rng = np.random.RandomState(self.epoch)
        random_idx = rng.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += (
                    self.local_minibatch_times_data_parallel_size)
                yield batch
                batch = []
