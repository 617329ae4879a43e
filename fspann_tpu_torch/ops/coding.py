"""LSH coding (reference "Algorithm-1"): bank construction, host and device encode.

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
``alpha`` and the unit offsets are drawn from JAX's threefry stream
(:mod:`.threefry`, numpy only) under the JAX package's fold-in tags, and
``alpha`` is row-normalised with XLA's CPU summation order, so a seed gives
the JAX package's bank bit for bit: a store that records only the seed and
the sample statistics (the JAX ``bank.npz``, ``mesh_state.npz``) reopens
here.  The sample statistics are XLA:CPU's too (:func:`_omega_from_sample`),
so a bank built from a sample is the JAX package's, whatever BLAS the host
has.  A bank held in memory crosses with
:func:`fspann_tpu_torch.api.convert.bank_from_jax`.

Two encoders, as in the JAX package: :func:`encode_numpy` on the host
(numpy BLAS; ``encode_backend="cpu"``) and :func:`encode` on the tensor's
device (``encode_backend="default"``).  On the device, packed words are
int32 tensors holding the uint32 bit patterns of the JAX package's words
(:func:`words_to_torch` / :func:`words_to_numpy` convert); every reader that
needs their unsigned value widens to int64 and masks.  The projection runs
in full float32 (TF32 off), but its rounding still differs from numpy's and
XLA's, so a point sitting on a bucket boundary can flip a code bit between
the two encoders — corpus and queries must be encoded on the same backend.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiler, threads
from . import threefry
from .refine import full_fp32_matmul

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


def _key(seed: int, tag: int) -> np.ndarray:
    """``fold_in(PRNGKey(uint32(seed)), tag)``: one stream per tag."""
    return threefry.fold_in(threefry.prng_key(seed), tag)


def _alpha_from_seed(seed: int, g: int, m: int, d: int) -> np.ndarray:
    """Row-normalised Gaussian projections, as the JAX package draws them:
    ``a / sqrt(max(sum(a * a, -1), 1e-12))`` in float32, the sum in XLA's
    CPU order (:func:`.threefry.sum_last_f32`)."""
    a = threefry.normal(_key(seed, _ALPHA_TAG), (g, m, d))
    sq = threefry.sum_last_f32(a * a)[..., None]
    return a / np.sqrt(np.maximum(sq, np.float32(1e-12)))


def _r_unit_from_seed(seed: int, g: int, m: int) -> np.ndarray:
    return threefry.uniform(_key(seed, _R_TAG), (g, m))


def build_random_bank(d: int, m: int, lam: int, tables: int, divisions: int,
                      seed: int, omega: float = 1.0) -> GBank:
    """Uniform-width bank when no sample statistics are available
    (reference Coding.buildRandomG:136-161)."""
    g = tables * divisions
    alpha = _alpha_from_seed(seed, g, m, d)
    om = np.full((g, m), np.float32(omega))
    r = _r_unit_from_seed(seed, g, m) * om
    return GBank(alpha, r, om, m, lam, tables, divisions, seed)


# XLA:CPU hands the sample's float32 product [S, d] x [d, N] (N = G*m) to
# YNNPACK's dot (the default ``xla_cpu_experimental_ynn_fusion_type``).  On
# an AVX-512 host YNNPACK picks, by the product's shape, a kernel with column
# tiles of 64, 32, 16 or 8 that keeps each output in 1, 2, 4 or 4 interleaved
# FMA chains ("lanes"): the least ``ceil(N / tile) * tile * ceil(d / lanes)
# * lanes * cost``, a tie going to the wider tile.  The contraction is cut
# into blocks of ``512 * lanes`` steps, each summed on its own, and the
# block sums are added left to right.  All of it is read from XLA's results
# (tests/test_torch_coding.py holds it against XLA's product and JAX's
# bank); the 8-wide kernel's cost is only known to lie between 1.25 and
# 1.33.
_YNN_KERNELS = ((64, 1, 1.0), (32, 2, 1.0), (16, 4, 1.0), (8, 4, 1.3))
_YNN_BLOCK = 512
_SCREEN_ROWS = 4_096


def _ynn_lanes(n: int, d: int) -> int:
    """The FMA chains per output of the kernel YNNPACK picks for a float32
    product ``d`` deep and ``n`` columns wide (``_YNN_KERNELS``)."""
    def cost(kernel):
        tile, lanes, factor = kernel
        return (-(-n // tile) * tile * -(-d // lanes) * lanes * factor, -tile)
    return min(_YNN_KERNELS, key=cost)[1]


def _lane_sum(x: np.ndarray, a: np.ndarray, lo: int, hi: int,
              lanes: int) -> np.ndarray:
    """float32 ``x[:, lo:hi] · a[:, lo:hi]`` over row pairs in ``lanes``
    interleaved FMA chains from 0, summed pairwise (``(l0 + l1) + (l2 +
    l3)``); the contraction steps past the last whole group of ``lanes``
    are summed the same way with half the lanes and added after."""
    q = lo + (hi - lo) // lanes * lanes
    total = None
    if q > lo:
        chains = []
        for j in range(lanes):
            acc = np.zeros(x.shape[0], np.float32)
            for k in range(lo + j, q, lanes):
                acc = threefry.fma(x[:, k], a[:, k], acc)
            chains.append(acc)
        while len(chains) > 1:
            chains = [chains[i] + chains[i + 1]
                      for i in range(0, len(chains), 2)]
        total = chains[0]
    if hi > q:
        tail = _lane_sum(x, a, q, hi, lanes // 2)
        total = tail if total is None else total + tail
    return total


def _xla_cpu_dot_f32(x: np.ndarray, a: np.ndarray, lanes: int
                     ) -> np.ndarray:
    """float32 dot products of row pairs ``x[p] · a[p]`` (both [P, d]),
    rounded as XLA:CPU's dot rounds them with a kernel of ``lanes`` chains
    (:func:`_ynn_lanes`): blocks of ``512 * lanes`` contraction steps, their
    sums added left to right."""
    d = x.shape[1]
    total = None
    for lo in range(0, d, _YNN_BLOCK * lanes):
        part = _lane_sum(x, a, lo, min(d, lo + _YNN_BLOCK * lanes), lanes)
        total = part if total is None else total + part
    return total


def _projection_extremes(x: np.ndarray, a: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Column maxima and minima, float32 [N] each, of the float32 product
    ``x @ a.T`` (x [S, d], a [N, d]) as XLA:CPU rounds it, whatever BLAS
    this host has.

    A float64 product, in any summation order, lies within ``B = 2 d 2^-24
    max|x_i| max|a_j|`` (Euclidean norms) of every float32 result: the
    float32 dot's error bound, its float64 twin's, and room for underflow.
    So only an element within ``2 B`` of its column's float64 maximum can
    hold the float32 maximum (and the mirror for the minimum); those few
    are recomputed in XLA's order (:func:`_xla_cpu_dot_f32`)."""
    s, d = x.shape
    blocks = [torch.from_numpy(x[r0:r0 + _SCREEN_ROWS])
              for r0 in range(0, s, _SCREEN_ROWS)]
    x_norm = max((float(b.double().norm(dim=1).max()) for b in blocks),
                 default=0.0)
    a64 = torch.from_numpy(a).double()
    bound = 2 * (2.0 * d * 2.0 ** -24 * x_norm * float(a64.norm(dim=1).max())
                 + d * 2.0 ** -148)
    a64t = a64.T.contiguous()
    hi = torch.full((a.shape[0],), -np.inf, dtype=torch.float64)
    lo = torch.full((a.shape[0],), np.inf, dtype=torch.float64)
    ymax = np.full(a.shape[0], -np.inf, np.float32)
    ymin = np.full(a.shape[0], np.inf, np.float32)
    picks = []                                 # (rows, columns, value)
    for r0, b in zip(range(0, s, _SCREEN_ROWS), blocks):
        e = b.double() @ a64t
        hi = torch.maximum(hi, e.amax(dim=0))
        lo = torch.minimum(lo, e.amin(dim=0))
        rows, cols = torch.nonzero((e >= hi - bound) | (e <= lo + bound),
                                   as_tuple=True)
        picks.append((rows + r0, cols, e[rows, cols]))
    if not picks:
        return ymax, ymin
    rows, cols, e = (torch.cat(p) for p in zip(*picks))
    keep = (e >= hi[cols] - bound) | (e <= lo[cols] + bound)
    rows, cols = rows[keep].numpy(), cols[keep].numpy()
    y = _xla_cpu_dot_f32(x[rows], a[cols], _ynn_lanes(a.shape[0], d))
    np.maximum.at(ymax, cols, y)
    np.minimum.at(ymin, cols, y)
    return ymax, ymin


def _omega_from_sample(sample: np.ndarray, alpha: np.ndarray,
                       r_unit: np.ndarray,
                       omega_divisor: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-projection range of the sample → (r, omega), equal to the JAX
    package's bit for bit: the projection's extremes as XLA:CPU rounds them
    (:func:`_projection_extremes`), and the division by the static divisor
    as XLA compiles it, a product with its float32 reciprocal."""
    x = np.ascontiguousarray(sample, np.float32)
    g, m, d = np.shape(alpha)
    a = np.ascontiguousarray(alpha, np.float32).reshape(g * m, d)
    hi, lo = _projection_extremes(x, a)
    rng = (hi - lo).reshape(g, m)
    omega = np.maximum(rng, np.float32(1e-6)) \
        * np.float32(1 / np.float32(omega_divisor))
    omega = np.where(omega > 0, omega, np.float32(1e-3)).astype(np.float32)
    return np.asarray(r_unit, np.float32) * omega, omega


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


def _f32(a, device) -> torch.Tensor:
    """A bank array (numpy, or a tensor already) as float32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def bank_to(bank: GBank, device) -> GBank:
    """The bank with its arrays as float32 tensors on ``device`` (the index
    keeps one such copy instead of moving ``alpha`` every batch)."""
    return GBank(_f32(bank.alpha, device), _f32(bank.r, device),
                 _f32(bank.omega, device), bank.m, bank.lam, bank.tables,
                 bank.divisions, bank.seed)


# ----------------------------------------------------------------------------
# Packed words on the device
# ----------------------------------------------------------------------------

def words_to_torch(codes: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words (numpy) → int32 tensor of the same bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(codes, np.uint32).view(np.int32))
    return t if device is None else t.to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor → uint32 words (numpy, on the host)."""
    return words.to(torch.int32).cpu().numpy().view(np.uint32)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """The unsigned value of 32-bit word patterns, as int64."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _as_int32_pattern(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor with the same low 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ----------------------------------------------------------------------------
# Device encode path (encode_backend="default")
# ----------------------------------------------------------------------------

def project_h(x: torch.Tensor, bank: GBank) -> torch.Tensor:
    """``H`` for a batch: int32 [N, G, m] (reference Coding.H:250-258).
    The product runs in full float32 on CUDA (TF32 off), the counterpart of
    the JAX package's ``Precision.HIGHEST``."""
    dev = x.device
    a, r, om = (_f32(v, dev) for v in (bank.alpha, bank.r, bank.omega))
    g, m, d = a.shape
    with full_fp32_matmul():
        y = (x.to(torch.float32) @ a.reshape(g * m, d).T).reshape(
            *x.shape[:-1], g, m)
    return torch.floor((y + r) / om).to(torch.int32)


def pack_codes(h: torch.Tensor, m: int, lam: int) -> torch.Tensor:
    """Interleave + pack ``H`` into 32-bit words, MSB-first.

    Position ``p = l*m + j`` (level l = 0 is the most significant bit of each
    h_j) is stored at bit ``31 - p%32`` of word ``p//32``, so word-wise
    unsigned lexicographic order == code prefix order.
    Output: int32 bit patterns [..., W] (the weighted sum runs in int64).
    """
    bits_total = m * lam
    w = (bits_total + 31) // 32
    hu = _u32(h)
    shifts = torch.arange(lam - 1, -1, -1, dtype=torch.int64, device=h.device)
    bits = (hu[..., None, :] >> shifts[:, None]) & 1          # [..., lam, m]
    bits = bits.reshape(*h.shape[:-1], bits_total)
    pad = w * 32 - bits_total
    if pad:
        bits = F.pad(bits, (0, pad))
    bits = bits.reshape(*h.shape[:-1], w, 32)
    weights = 1 << (31 - torch.arange(32, dtype=torch.int64, device=h.device))
    return _as_int32_pattern((bits * weights).sum(dim=-1))


def keys_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """63-bit sortable key from packed code words
    (reference GreedyPartitioner.computeKey:87-96).

    key bit ``62-p`` = code bit ``p`` for ``p < 63``; with MSB-first packing
    this is ``(w0 << 31) | (w1 >> 1)`` over the words' unsigned values.
    """
    w0 = _u32(codes[..., 0])
    if codes.shape[-1] > 1:
        return (w0 << 31) | (_u32(codes[..., 1]) >> 1)
    return w0 << 31


def keys2_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """Secondary sort key: code bits 63..125 (the bits the 63-bit primary
    key truncates), MSB-first — ``key2 bit 62-(p-63) = code bit p``.

    Sorting by the (key, key2) pair restores the exact code-prefix order up
    to 126 bits (``runtime.wide_keys``); for ``m*lam <= 63`` key2 == 0
    everywhere and the pair order is the reference order.  Bit 63 is
    word1's LSB, bits 64..95 are word2, bits 96..125 the top 30 bits of
    word3.
    """
    w = codes.shape[-1]
    z = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    w1 = _u32(codes[..., 1]) if w > 1 else z
    w2 = _u32(codes[..., 2]) if w > 2 else z
    w3 = _u32(codes[..., 3]) if w > 3 else z
    return ((w1 & 1) << 62) | (w2 << 30) | (w3 >> 2)


def keys2_from_codes_numpy(codes: "np.ndarray") -> "np.ndarray":
    """Numpy twin of :func:`keys2_from_codes` (host build path)."""
    w = codes.shape[-1]
    z = np.zeros(codes.shape[:-1], np.int64)
    w1 = codes[..., 1].astype(np.int64) if w > 1 else z
    w2 = codes[..., 2].astype(np.int64) if w > 2 else z
    w3 = codes[..., 3].astype(np.int64) if w > 3 else z
    return ((w1 & 1) << 62) | (w2 << 30) | (w3 >> 2)


def h1(x: torch.Tensor, bank: GBank) -> torch.Tensor:
    """Collapse multi-projection H into one int32 hash per (vector, group)
    via 31x+h mixing (reference Coding.H1:264-271), with int32 wraparound
    made explicit in int64."""
    h = project_h(x, bank).to(torch.int64)
    acc = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    for j in range(h.shape[-1]):
        acc = ((acc * 31 + h[..., j] + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return acc.to(torch.int32)


def encode(x: torch.Tensor, bank: GBank, chunk: int = 16_384
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full coding pipeline on ``x``'s device: vectors → (packed codes,
    sort keys).

    Returns ``codes: int32 [N, G, W]`` (uint32 bit patterns) and
    ``keys: int64 [N, G]``.  Rows go through in ``chunk`` blocks so the
    int64 bit scratch of :func:`pack_codes` stays bounded; every op is
    row-local, so the result does not depend on the chunking.
    """
    n = x.shape[0]
    codes = torch.empty((n, bank.g, bank.code_words), dtype=torch.int32,
                        device=x.device)
    keys = torch.empty((n, bank.g), dtype=torch.int64, device=x.device)
    for lo in range(0, n, chunk):
        c = pack_codes(project_h(x[lo:lo + chunk], bank), bank.m, bank.lam)
        codes[lo:lo + len(c)] = c
        keys[lo:lo + len(c)] = keys_from_codes(c)
    return codes, keys


# ----------------------------------------------------------------------------
# Host (numpy) encode path — used when ingestion runs on the host
# ----------------------------------------------------------------------------

# rows a pool thread encodes at a time in :func:`encode_numpy`.  On the
# H100 host's 8 cores, 1M rows of 3,072-bit codes took, in three runs of
# ``scripts/torch_build_bench.py``, 4.6 / 5.5 / 3.4 s at 1,024 rows a
# thread against 6.6 / 6.4 / 3.2 at 512; 7.1 and 5.1 at 2,048, 17.2 at
# 4,096 and 7.0 at 256
POOL_ROWS = 1024

# the functions that read and set the thread count of a process's
# OpenBLAS, under the names numpy's wheels (scipy-openblas, 64-bit
# integers), older wheels and plain builds give them
_BLAS_THREADS = (
    ("scipy_openblas_get_num_threads64_", "scipy_openblas_set_num_threads64_"),
    ("openblas_get_num_threads64_", "openblas_set_num_threads64_"),
    ("openblas_get_num_threads", "openblas_set_num_threads"))
_BLAS_LOCK = threading.Lock()


@functools.cache
def _numpy_blas_threads():
    """(get, set) of the thread count of the OpenBLAS numpy's products run
    on, found among the libraries this process has mapped (numpy's own
    first); None where numpy's BLAS is another."""
    try:
        with open("/proc/self/maps") as f:
            paths = sorted({ln.split()[-1] for ln in f
                            if "openblas" in ln.rsplit("/", 1)[-1].lower()},
                           key=lambda path: "numpy" not in path)
    except OSError:
        return None
    for path in paths:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        for get, set_ in _BLAS_THREADS:
            if hasattr(lib, get) and hasattr(lib, set_):
                get, set_ = getattr(lib, get), getattr(lib, set_)
                get.argtypes, get.restype = [], ctypes.c_int
                set_.argtypes, set_.restype = [ctypes.c_int], None
                return get, set_
    return None


@contextlib.contextmanager
def _one_blas_thread():
    """numpy's products on one thread each while the block runs: a pool's
    workers that each run a product would otherwise each start a BLAS team
    as wide as the host (the pooled encode of 1M rows at d 96, 3,072 bits,
    took 26.2 s with the teams against 6.4 s without on the H100 host's 8
    cores; ``scripts/torch_build_bench.py``).  OpenBLAS keeps the count
    for the whole process, so the block holds a lock and sets the count
    back after it; a numpy product that another thread runs meanwhile runs
    on one thread too, which is why only the set-up's ingest, which no
    query overlaps, takes it.  With another BLAS nothing is set, which
    changes the time and not the result."""
    fns = _numpy_blas_threads()
    if fns is None:
        yield
        return
    get, set_ = fns
    with _BLAS_LOCK:
        before = get()
        set_(1)
        try:
            yield
        finally:
            set_(before)


def encode_numpy(x: np.ndarray, bank: GBank, chunk: int = 4096,
                 width: int = 1) -> tuple[np.ndarray, np.ndarray]:
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
    whole-batch computation (all ops are elementwise or row-local), so
    with ``width`` > 1 (the set-up's ingest, ``index/service``) a call of
    more than one chunk runs on ``width`` host threads (numpy releases the
    interpreter lock inside each step), each taking
    :data:`POOL_ROWS` rows at a time, with numpy's BLAS on one thread
    meanwhile (:func:`_one_blas_thread`).  Other calls run on the caller's
    thread.  A call of more than one chunk adds 1 to the counter
    ``index.encode.calls`` and the threads that took its rows to
    ``index.encode.workers``."""
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
    took = set()

    def encode_chunk(lo: int) -> None:
        took.add(threading.get_ident())
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

    chunks = -(-n // chunk)
    width = min(chunks, width)
    if width > 1:
        chunk = min(chunk, POOL_ROWS)      # encode_chunk reads ``chunk``
    with _one_blas_thread() if width > 1 else contextlib.nullcontext():
        threads.map_threads(encode_chunk, range(0, n, chunk), width)
    if chunks > 1:
        profiler.count("index.encode.calls")
        profiler.count("index.encode.workers", len(took))
    return codes, keys
