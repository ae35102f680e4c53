"""Shape utilities for tensor parallelism (port of
:mod:`apex_tpu.transformer.tensor_parallel.utils`; this slice needs only
the divisibility helpers)."""

from __future__ import annotations

__all__ = ["ensure_divisibility", "divide"]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator
