"""Packed-code Hamming distance (XOR + popcount on 32-bit words).

Port of ``fspann_tpu/ops/hamming.py``, which replaces the reference's
``GreedyPartitioner.hamming`` BitSet clone+xor+cardinality
(GreedyPartitioner.java:78-82).  PyTorch has no popcount, so
:func:`popcount` is a SWAR bit count in int64: words may arrive as int32 or
int64 tensors holding 32-bit patterns (the port's device codes are int32
bit patterns of the JAX package's uint32 words), and widening first keeps
every intermediate free of signed overflow.
"""

from __future__ import annotations

import torch


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word pattern: int32 ``[...]``."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed codes; last axis is the word axis.

    Broadcasts like torch: ``a [..., W]``, ``b [..., W]`` → int32 ``[...]``.
    """
    return popcount(torch.bitwise_xor(a, b)).sum(dim=-1, dtype=torch.int32)
