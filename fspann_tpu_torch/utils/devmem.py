"""Device-memory budget heuristic (single source of truth).

The index sizes its resident scan state and its [Q, N] scan scratch from
the device's free memory; the constants (fraction of free, fallback for
devices without memory stats, absolute floor) are the JAX package's.
"""

from __future__ import annotations

import torch


def free_memory_budget(numerator: int, denominator: int, fallback: int,
                       floor: int = 256 << 20, device=None) -> int:
    """``max(free * numerator // denominator, floor)`` for a CUDA
    ``device`` (default: the current CUDA device when one exists), where
    ``free`` is the free memory ``torch.cuda.mem_get_info`` reports plus
    what PyTorch's caching allocator holds reserved but unused;
    ``fallback`` for the CPU, which reports no memory stats."""
    if device is None:
        if not torch.cuda.is_available():
            return fallback
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return fallback
    free, _total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return max(free * numerator // denominator, floor)
