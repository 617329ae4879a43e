"""Carry a JAX-package bank (the index's "weights") into the port.

The two packages draw ``alpha`` and the offsets from different generators
(threefry ``jax.random`` there, ``torch.Generator`` here), so the same seed
gives different banks.  To encode identically, take the JAX bank's arrays
and install them::

    jb = jax_system.index.bank                  # fspann_tpu.ops.coding.GBank
    bank = bank_from_jax(np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed)
    torch_system.index.set_bank(bank)           # before index_stream

With the same bank, ``encode_numpy`` gives bit-identical codes and keys in
both packages.
"""

from __future__ import annotations

import numpy as np

from ..ops.coding import GBank


def bank_from_jax(alpha: np.ndarray, r: np.ndarray, omega: np.ndarray,
                  m: int, lam: int, tables: int, divisions: int,
                  seed: int) -> GBank:
    """A port bank holding exactly the JAX bank's arrays (float32)."""
    g = tables * divisions
    alpha = np.ascontiguousarray(alpha, np.float32)
    r = np.ascontiguousarray(r, np.float32)
    omega = np.ascontiguousarray(omega, np.float32)
    if alpha.ndim != 3 or alpha.shape[:2] != (g, m) \
            or r.shape != (g, m) or omega.shape != (g, m):
        raise ValueError(f"bank arrays {alpha.shape}/{r.shape}/{omega.shape} "
                         f"do not match G={g}, m={m}")
    if not (omega > 0).all():
        raise ValueError("bank widths must be positive")
    return GBank(alpha, r, omega, int(m), int(lam), int(tables),
                 int(divisions), int(seed))
