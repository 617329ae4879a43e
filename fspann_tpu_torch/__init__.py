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
    """``cuda`` when a CUDA device is available, else ``cpu``.

    The CPU answer exists for the CPU test suite, where every kernel
    wrapper runs its plain torch version; the serving path on a GPU host
    never falls back to it."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
