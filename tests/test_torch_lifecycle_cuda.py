"""The packed scan state, ``update_rows``, the native host scan and live
insert on a CUDA device against the same work on the CPU, at 100k rows of
3,072-bit codes (24 groups x 128 bits).  Every field must be equal bit for
bit.  The scans compared across devices or layouts select the exact top-L
(``approx=False``): the default selection is approximate on the card and
exact on the CPU, and its blocks follow the layout's chunks.

No top-level jax import: on a GPU host these run with
``python -m pytest --noconftest -m cuda tests/test_torch_lifecycle_cuda.py``
and skip where there is no CUDA device."""

import numpy as np
import pytest
import torch

from fspann_tpu_torch.ops import coding, native_scan
from fspann_tpu_torch.ops import hamming_scan as hs

FIELDS = ("ids", "scores", "n_unique", "n_raw", "n_dec")
N, G, W, CB = 100_000, 24, 4, 128
ADAPTIVE = dict(anchor=100, margin=40)
KW = dict(approx=False, **ADAPTIVE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed=11, nq=64):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << 32, (N, G, W), dtype=np.uint64) \
        .astype(np.uint32)
    qcodes = codes[rng.integers(0, N, nq)].copy()
    qcodes[:, :, 0] ^= rng.integers(0, 1 << 32, (nq, G), dtype=np.uint64) \
        .astype(np.uint32)
    tomb = rng.random(N) < 0.01
    return codes, qcodes, tomb


def _scan(idx, queries, approx):
    """The scan that ``idx.route_batch`` runs on ``queries`` (flat over the
    unpacked state, chunked over the packed one), with ``approx``
    chosen."""
    rt, cb = idx.cfg.runtime, idx.cfg.paper.code_bits
    qbits = torch.from_numpy(hs.unpack_bits_numpy(
        idx.encode_queries(queries)[0], cb)).to(idx.device)
    kw = dict(approx=approx, anchor=rt.adaptive_decrypt_anchor,
              margin=rt.adaptive_decrypt_margin,
              floor=rt.adaptive_decrypt_floor)
    st, tomb = idx._scan_state, idx._tombstones_scan()
    if isinstance(st, hs.PackedScanState):
        return hs.scan_chunked(st, qbits, tomb, 2000, code_bits=cb, **kw)
    return hs.scan(st, qbits, tomb, 2000, **kw)


def _equal(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f}")


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 7, 64])
def test_packed_scan_cuda_matches_cpu(cuda, nq):
    codes, qcodes, tomb = _inputs(seed=nq)
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes[:nq], CB))
    tb = torch.from_numpy(tomb)
    host = hs.build_scan_state_packed(codes, CB)
    dev = hs.build_scan_state_packed(codes, CB, device=cuda)
    assert dev.words.dtype == torch.int32 and dev.words.is_cuda
    assert torch.equal(host.words, dev.words.cpu())
    assert torch.equal(host.popc, dev.popc.cpu())
    want = hs.scan(hs.build_scan_state(codes, CB), qbits, tb, 2000, **KW)
    got = hs.scan_chunked(dev, qbits.to(cuda), tb.to(cuda), 2000,
                          chunk=32_768, code_bits=CB, **KW)
    _equal(got, want, "packed CUDA vs unpacked CPU")


@pytest.mark.cuda
def test_update_rows_cuda_keeps_storage(cuda):
    codes, qcodes, tomb = _inputs()
    cut = N - 4096
    st = hs.build_scan_state_packed(
        np.concatenate([codes[:cut], np.zeros_like(codes[cut:])]), CB,
        device=cuda)
    ptr, shape = st.words.data_ptr(), st.words.shape
    new_popc = hs.build_scan_state_packed(codes[cut:], CB).popc
    words = hs.update_rows(st.words, coding.words_to_torch(codes[cut:], cuda),
                           cut)
    popc = hs.update_rows(st.popc, new_popc.to(cuda), cut)
    assert words.data_ptr() == ptr and words.shape == shape
    fresh = hs.build_scan_state_packed(codes, CB, device=cuda)
    assert torch.equal(words, fresh.words) and torch.equal(popc, fresh.popc)
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes, CB)).to(cuda)
    tb = torch.from_numpy(tomb).to(cuda)
    _equal(hs.scan_chunked(hs.PackedScanState(words, popc), qbits, tb, 2000,
                           chunk=32_768, code_bits=CB, **KW),
           hs.scan_chunked(fresh, qbits, tb, 2000, chunk=32_768,
                           code_bits=CB, **KW), "update_rows vs fresh")


@pytest.mark.cuda
def test_native_scan_matches_cuda_scan(cuda):
    codes, qcodes, tomb = _inputs()
    qbits = torch.from_numpy(hs.unpack_bits_numpy(qcodes, CB)).to(cuda)
    want = hs.scan(hs.build_scan_state(codes, CB, device=cuda), qbits,
                   torch.from_numpy(tomb).to(cuda), 2000, **KW)
    got = native_scan.scan_topl(codes, qcodes, tomb, 2000, **ADAPTIVE)
    _equal(got, want, "native vs CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", ["off", "on"])
def test_index_live_insert_cuda_matches_cpu(cuda, packed):
    """append_rows on a CUDA index (in place, then past capacity) routes
    like the same index on the CPU: the exact scan over either state is
    equal, and the served route on the card is its scan with the default
    (approximate) selection."""
    from fspann_tpu_torch.config import (EvalConfig, PaperConfig,
                                         RuntimeConfig, SystemConfig)
    from fspann_tpu_torch.index.service import PartitionedIndex

    rng = np.random.default_rng(3)
    base = rng.normal(size=(20_000, 32)).astype(np.float32)
    extra = rng.normal(size=(3_000, 32)).astype(np.float32)
    cfg = SystemConfig(
        paper=PaperConfig(m=64, lam=2, divisions=3, tables=8, seed=13),
        runtime=RuntimeConfig(refinement_limit=2000,
                              max_global_candidates=2000, block_size=128,
                              routing_mode="scan", encode_backend="cpu",
                              scan_packed=packed, scan_native="off",
                              scan_capacity_rows=22_000,
                              adaptive_decrypt_margin=40),
        eval=EvalConfig(k_variants=(1, 10))).validate()
    out = []
    for dev in ("cpu", cuda):
        idx = PartitionedIndex(cfg, 32, device=dev)
        idx.stage(np.arange(20_000), base)
        idx.finalize()
        st = idx._scan_state
        rows = st.words if packed == "on" else st.bits
        ptr = rows.data_ptr()
        idx.append_rows(np.arange(20_000, 21_500), extra[:1500])
        rows = idx._scan_state.words if packed == "on" \
            else idx._scan_state.bits
        assert rows.data_ptr() == ptr and idx._scan_rows == 22_000
        idx.append_rows(np.arange(21_500, 23_000), extra[1500:])
        assert idx._scan_rows == 23_000 + 4096
        idx.mark_deleted([7, 20_003])
        out.append(_scan(idx, extra[::50], approx=False))
    _equal(out[1], out[0], f"index {packed}")
    _equal(idx.route_batch(*idx.encode_queries(extra[::50])),
           _scan(idx, extra[::50], approx=True), f"served {packed}")
