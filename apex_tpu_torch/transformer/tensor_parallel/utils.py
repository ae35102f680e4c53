"""Shape and partition helpers for tensor parallelism (port of
:mod:`apex_tpu.transformer.tensor_parallel.utils`)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ensure_divisibility", "divide", "split_tensor_along_last_dim",
           "VocabUtility"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False
                                ) -> Tuple[torch.Tensor, ...]:
    """The last dimension in ``num_partitions`` equal chunks (views, or
    contiguous copies with ``contiguous_split_chunks``)."""
    size = divide(x.shape[-1], num_partitions)
    chunks = torch.split(x, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """A vocabulary in contiguous per-rank ranges ``[first, last)``."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank) -> Tuple:
        index_f = rank * per_partition_vocab_size
        return index_f, index_f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank,
                                           world_size: int) -> Tuple:
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank)
