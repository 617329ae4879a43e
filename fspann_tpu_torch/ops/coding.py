"""LSH coding (reference "Algorithm-1"): bank construction + host encode.

Reference behavior being reproduced (index/paper/Coding.java):

* A ``GFunction`` per (table, division) group ``g``: row-normalized Gaussian
  projections ``alpha[g, m, d]``, offsets ``r[g, m] ∈ [0, ω)``, widths
  ``omega[g, m] > 0`` (Coding.java:52-97).
* ``H(v)_j = floor((alpha_j · v + r_j) / omega_j)`` (Coding.java:250-258).
* ``C(v)`` = MSB-first bit-interleaved code of ``m*lam`` bits: position
  ``p = l*m + j`` holds bit ``lam-1-l`` of ``H_j`` (Coding.java:285-301).
* Data-adaptive widths: ``omega_j = projected_range_j / OMEGA_DIVISOR`` from a
  sample (Coding.java:184-241, divisor 2.5).
* 63-bit sortable key: code bit ``p`` → key bit ``62-p``, ``p < 63``
  (GreedyPartitioner.java:87-96).

The bank is a plain frozen dataclass of numpy arrays, built on the host.
``alpha`` and the unit offsets are drawn from a ``torch.Generator`` seeded
from ``seed`` — NOT the JAX package's threefry stream, so the same seed
gives a different bank there.  Tests and cross-package runs carry a JAX bank
across with :func:`fspann_tpu_torch.api.convert.bank_from_jax`.

The serving path encodes on the host (:func:`encode_numpy`, numpy BLAS);
device encode (``project_h``/``pack_codes``/``encode``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# fold-in tags separating the alpha and offset streams of one seed
_ALPHA_TAG = 0x414C5048
_R_TAG = 0x4F464653


@dataclasses.dataclass(frozen=True)
class GBank:
    """All G = tables*divisions hash functions as one immutable value —
    a deterministic function of ``(seed, m, lam, tables, divisions,
    sample)``, replacing the reference's global mutable
    ``GFunctionRegistry`` singleton (index/paper/GFunctionRegistry.java)."""

    alpha: np.ndarray   # f32 [G, m, d]  row-normalized Gaussian projections
    r: np.ndarray       # f32 [G, m]     offsets in [0, omega)
    omega: np.ndarray   # f32 [G, m]     bucket widths > 0
    m: int
    lam: int
    tables: int
    divisions: int
    seed: int

    @property
    def g(self) -> int:
        return self.tables * self.divisions

    @property
    def d(self) -> int:
        return self.alpha.shape[-1]

    @property
    def code_bits(self) -> int:
        return self.m * self.lam

    @property
    def code_words(self) -> int:
        return (self.code_bits + 31) // 32


def _generator(seed: int, tag: int) -> torch.Generator:
    """The CPU generator (mt19937) keeps only the low 32 bits of its seed,
    so the stream tag is XORed in rather than concatenated."""
    gen = torch.Generator("cpu")
    gen.manual_seed((int(seed) ^ tag) & 0xFFFFFFFF)
    return gen


def _alpha_from_seed(seed: int, g: int, m: int, d: int) -> np.ndarray:
    a = torch.randn((g, m, d), generator=_generator(seed, _ALPHA_TAG),
                    dtype=torch.float32)
    norm = torch.sqrt(torch.clamp((a * a).sum(dim=-1, keepdim=True),
                                  min=1e-12))
    return (a / norm).numpy()


def _r_unit_from_seed(seed: int, g: int, m: int) -> np.ndarray:
    return torch.rand((g, m), generator=_generator(seed, _R_TAG),
                      dtype=torch.float32).numpy()


def _omega_from_sample(sample: np.ndarray, alpha: np.ndarray,
                       r_unit: np.ndarray,
                       omega_divisor: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-projection range of the sample → (r, omega).  The [S, G·m]
    projection is a float32 product on the CPU (torch's CPU matmul is full
    float32; TF32 exists only on CUDA)."""
    s = torch.from_numpy(np.ascontiguousarray(sample, np.float32))
    a = torch.from_numpy(np.ascontiguousarray(alpha, np.float32))
    g, m, d = a.shape
    proj = (s @ a.reshape(g * m, d).T).reshape(-1, g, m)        # [S, G, m]
    rng = proj.amax(dim=0) - proj.amin(dim=0)                   # [G, m]
    omega = torch.clamp(rng, min=1e-6) / np.float32(omega_divisor)
    omega = torch.where(omega > 0, omega, torch.full_like(omega, 1e-3))
    r = torch.from_numpy(np.asarray(r_unit, np.float32)) * omega
    return r.numpy(), omega.numpy()


def build_bank_from_sample(sample: np.ndarray, m: int, lam: int, tables: int,
                           divisions: int, seed: int,
                           omega_divisor: float = 2.5) -> GBank:
    """Data-adaptive bank (reference Coding.buildFromSample:184-241)."""
    g = tables * divisions
    d = np.shape(sample)[-1]
    alpha = _alpha_from_seed(seed, g, m, d)
    r_unit = _r_unit_from_seed(seed, g, m)
    r, omega = _omega_from_sample(np.asarray(sample), alpha, r_unit,
                                  omega_divisor)
    return GBank(alpha, r, omega, m, lam, tables, divisions, seed)


def bank_from_stats(omega: np.ndarray, r: np.ndarray, d: int, m: int, lam: int,
                    tables: int, divisions: int, seed: int) -> GBank:
    """Rebuild a bank from persisted (omega, r) stats + seed — alpha is
    regenerated from the seed, stats are exact."""
    g = tables * divisions
    alpha = _alpha_from_seed(seed, g, m, d)
    return GBank(alpha, np.asarray(r, np.float32),
                 np.asarray(omega, np.float32), m, lam, tables, divisions,
                 seed)


# ----------------------------------------------------------------------------
# Host (numpy) encode path — used when ingestion runs on the host
# ----------------------------------------------------------------------------

def encode_numpy(x: np.ndarray, bank: GBank,
                 chunk: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Same pipeline as :func:`encode` in pure numpy (BLAS matmul + packing).

    Used for host-side ingestion (``runtime.encode_backend="cpu"``) where a
    remote device link would make per-batch round trips the build bottleneck.
    Corpus and queries must be encoded on the SAME backend — f32 rounding can
    differ across backends exactly at bucket boundaries.

    Rows are processed in ``chunk`` blocks so the elementwise/packing
    temporaries (y, h, bits — ~10 bytes per code bit per row) stay
    cache-resident: a 100k-row batch at 3,072-bit codes otherwise streams
    ~6 GB of f32 projections through DRAM EIGHT times (projection, +r,
    /omega, floor, cast, shift/mask, pad, packbits), and on the
    bandwidth-starved serving host those passes — not the BLAS — dominated
    the whole 1M build (profile_build.py: encode 225 s of 236 s insert;
    chunking cuts it ~4x).  Per-chunk results are bit-identical to the
    whole-batch computation (all ops are elementwise or row-local)."""
    a = np.asarray(bank.alpha, np.float32)
    r = np.asarray(bank.r, np.float32)
    om = np.asarray(bank.omega, np.float32)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    m, lam, w = bank.m, bank.lam, bank.code_words
    g = a.shape[0]
    a2 = np.ascontiguousarray(a.reshape(g * m, -1).T)   # [d, g*m] for BLAS
    shifts = np.arange(lam - 1, -1, -1, dtype=np.uint32)
    pad = w * 32 - lam * m
    codes = np.empty((n, g, w), np.uint32)
    keys = np.empty((n, g), np.int64)
    for lo in range(0, n, chunk):
        xs = x[lo:lo + chunk]
        y = (xs @ a2).reshape(len(xs), g, m)
        h = np.floor((y + r) / om).astype(np.int32)
        hu = h.astype(np.uint32)
        # uint8 bit matrix + np.packbits (MSB-first — exactly the weight
        # order of the packed-word layout)
        bits = (((hu[..., None, :] >> shifts[:, None]) & np.uint32(1))
                .astype(np.uint8))
        bits = bits.reshape(*h.shape[:-1], lam * m)
        if pad:
            bits = np.pad(bits,
                          [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
        packed = np.packbits(bits, axis=-1)        # [..., w*4] bytes
        c = (np.ascontiguousarray(packed)
             .view(">u4").astype(np.uint32))       # [..., w] MSB-first
        codes[lo:lo + len(xs)] = c
        k = c[..., 0].astype(np.int64) << 31
        if w > 1:
            k = k | (c[..., 1].astype(np.int64) >> 1)
        keys[lo:lo + len(xs)] = k
    return codes, keys
