"""fspann_tpu_torch — the forward-secure encrypted ANN system on PyTorch + CUDA.

The PyTorch port of ``fspann_tpu``: the same module layout and public names,
with device work written as torch ops and the repository's one hand kernel
(the streaming exact L2 top-k, ``ops/l2_topk.py`` + ``csrc/l2_topk.cu``)
written in CUDA C++ for Hopper (sm_90a).  Host-side modules (config, crypto,
store, io, query tokens and aggregates, utils) are carried copies of the JAX
package's modules: importing ``fspann_tpu`` would import jax, which this
package never does.

Routing–ciphertext orthogonality is unchanged: routing state is a pure
function of (seed, config, sample statistics) and never depends on key or
cipher state.

Integer widths are explicit everywhere (there is no global x64 switch):
routing keys are int64, ids and scores int32.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device an entry point serves from when its caller names none:
    the CUDA card.

    There is no fallback: without a CUDA device this raises, so a host whose
    CUDA is broken fails at once instead of serving from the CPU.  The CPU
    is a choice the caller makes (``device="cpu"``, or ``--device cpu`` on
    the command line), as the CPU test suite does; there every kernel
    wrapper runs its plain torch version."""
    return resolve_device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.  A
    CUDA device on a host without one raises here, at construction, with
    the way to ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" (or "
            "--device cpu on the command line) to run on the CPU")
    return device
