"""The port's sharded index over several device slots
(fspann_tpu_torch/parallel/sharded.py ``make_mesh(devices=...)``) against
the JAX package's 8-device CPU mesh (tests/conftest.py), bit for bit.

8 shards are spread over 1, 2, 4 and 8 slots, every slot the CPU: the slots
share the device, but each holds its own tensors, so the code that places
state per slot, runs a step per slot, gathers the blocks onto the first
slot and copies each slot to the host is the code a host of several cards
runs.  Inputs sit on the grid of tests/test_torch_sharded.py (vectors
multiples of 1/16, ``alpha`` multiples of 2^-10), where both packages'
device encoders are exact, so codes, tables, ids and scores are compared
bit for bit and plaintext distances to 1e-6 relative.  The JAX side of each
scenario runs once per module (``scope="module"`` fixtures) and every slot
count is held to it.

Mirrors ``__graft_entry__.dryrun_multichip`` and the index-level tests of
tests/test_torch_sharded.py, and the facade of
tests/test_torch_distributed_serving.py."""

import dataclasses
import types
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fspann_tpu import config as jconfig
from fspann_tpu.ops import coding as jcoding
from fspann_tpu.parallel import serving as jserving
from fspann_tpu.parallel.sharded import ShardedIndex as JIndex
from fspann_tpu.parallel.sharded import make_mesh as jmake_mesh
from fspann_tpu_torch import config as tconfig
from fspann_tpu_torch.api.convert import bank_from_jax
from fspann_tpu_torch.ops import coding
from fspann_tpu_torch.parallel import serving as tserving
from fspann_tpu_torch.parallel import sharded as tsharded
from fspann_tpu_torch.parallel.sharded import Mesh, ShardedIndex, make_mesh

torch.set_num_threads(1)

ND = 8                       # shards, as the JAX CPU mesh has devices
SLOTS = [1, 2, 4, 8]
DIST_RTOL = 1e-6
CPU = torch.device("cpu")


def _grid(x):
    return (np.round(np.asarray(x, np.float64) * 16) / 16).astype(np.float32)


def _banks(sample, m=8, lam=2, tables=3, divisions=2, seed=13):
    """(JAX bank, the same bank in the port), ``alpha`` on the 2^-10 grid."""
    jb = jcoding.build_bank_from_sample(sample, m, lam, tables, divisions,
                                        seed)
    alpha = (np.round(np.asarray(jb.alpha, np.float64) * 1024) / 1024) \
        .astype(np.float32)
    jb = dataclasses.replace(jb, alpha=alpha)
    return jb, bank_from_jax(alpha, np.asarray(jb.r), np.asarray(jb.omega),
                             jb.m, jb.lam, jb.tables, jb.divisions, jb.seed)


def _assert_codes_equal(jb, bank, x):
    """The premise of every bit-for-bit comparison below."""
    jc, jk = jcoding.encode(jnp.asarray(x), jb)
    tc, tk = coding.encode(torch.from_numpy(np.ascontiguousarray(x)), bank)
    np.testing.assert_array_equal(coding.words_to_numpy(tc), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _mesh(slots):
    return make_mesh(ND, devices=["cpu"] * slots)


def _index(slots, bank, block=32, wide=False):
    return ShardedIndex(_mesh(slots), bank, block_size=block, wide_keys=wide)


STATE = ("point_codes", "words", "bits", "popc", "tombs")


def _jax_tables(j):
    return {f: None if getattr(j.table, f) is None
            else j._gather_host(getattr(j.table, f))
            for f in j.table._fields}


def _jax_state(j):
    return {f: None if getattr(j, f) is None else j._gather_host(getattr(j, f))
            for f in STATE}


def _assert_per_slot(t, slots):
    """The state is a list with one tensor per slot, whatever the slot
    count, on the slot's device, holding the slot's shards back to back:
    never one tensor for the whole mesh."""
    spp = ND // slots
    assert t.mesh.slots == (CPU,) * slots and t.mesh.shards_per_slot == spp
    for f in ("base",) + STATE:
        arr = getattr(t, f)
        if arr is None:
            continue
        parts = t._per_device(arr)
        assert len(parts) == slots, f
        assert isinstance(arr, list) and len(arr) == slots, f
        for p, dev in zip(parts, t.mesh.slots):
            assert isinstance(p, torch.Tensor) and p.device == dev, f
            assert p.shape[0] == t.shard_rows * spp, f
        assert len({p.data_ptr() for p in parts}) == slots, f
    tables = t._per_device(t.table)
    assert isinstance(t.table, list) and len(tables) == slots
    assert all(tb.ids.shape[0] == spp for tb in tables)


def _assert_tables_equal(want, t):
    for f, a in want.items():
        parts = [getattr(tb, f) for tb in t._per_device(t.table)]
        if a is None:
            assert all(p is None for p in parts), f
            continue
        b = np.concatenate([p.numpy() for p in parts])
        if f == "rep_codes":
            b = b.view(np.uint32)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_state_equal(want, t):
    for f, a in want.items():
        b = getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = t._gather_host(b)
            if b.dtype == np.int32 and f != "popc":
                b = b.view(np.uint32)
            np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_same(got, want, what=""):
    for g, w, name in zip(got, want, ("ids", "scores")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.int32 and g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def _assert_query_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=DIST_RTOL)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32


def _host(pair):
    return tuple(np.asarray(x) for x in pair)


# -- the mesh ----------------------------------------------------------------


def test_make_mesh_rules(monkeypatch):
    """``device=`` alone is one slot (today's layout), ``devices=`` names the
    slots, an uneven split raises, and no card (or a card the host does not
    have) raises instead of stacking the shards on fewer devices."""
    one = make_mesh(8, device="cpu")
    assert one.slots == (CPU,) and one.n_shards == 8
    assert one.shards_per_slot == 8 and one.device == CPU
    assert make_mesh(device="cpu") == Mesh(1, (CPU,))
    four = make_mesh(8, devices=["cpu"] * 4)
    assert four.slots == (CPU,) * 4 and four.shards_per_slot == 2
    assert four.devices == (CPU,) and four.device == CPU
    assert make_mesh(devices=["cpu", "cpu"]).n_shards == 2
    for bad in (dict(n_devices=6, devices=["cpu"] * 4),
                dict(n_devices=3, devices=["cpu"] * 2),
                dict(n_devices=0, device="cpu"),
                dict(device="cpu", devices=["cpu"])):
        with pytest.raises(ValueError):
            make_mesh(**bad)
    with pytest.raises(ValueError):
        Mesh(4, ())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, dict(n_devices=4), dict(devices=["cuda:0"]),
               dict(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(**kw)

    # a host of two cards (no card is touched: a mesh allocates nothing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh() == Mesh(2, cards)
    assert make_mesh(4) == Mesh(4, cards)
    assert make_mesh(1) == Mesh(1, cards[:1])
    assert make_mesh(8, devices=["cuda:1", "cuda:0"]).slots == cards[::-1]
    with pytest.raises(ValueError, match="split evenly"):
        make_mesh(3)
    with pytest.raises(ValueError, match="not visible"):
        make_mesh(4, devices=[f"cuda:{i}" for i in range(4)])


def test_scan_layout_counts_slots_that_share_a_device(tmp_path):
    """``"auto"`` packs when the rows of any one device do not fit its
    budget (4 GiB on the CPU): the 8 shards of 4 slots on the CPU count
    together, not 2 at a time."""
    cfg = tconfig.SystemConfig(
        paper=tconfig.PaperConfig(m=8, lam=2, divisions=2, tables=3,
                                  seed=13),
        runtime=tconfig.RuntimeConfig(routing_mode="scan",
                                      scan_packed="auto")).validate()
    bits = cfg.paper.num_groups * cfg.paper.code_bits
    rows = (4 << 30) // (bits * 4)      # 2 shards fit, 8 do not
    sys_ = tserving.DistributedEncryptedSystem(cfg, str(tmp_path), 16,
                                               mesh=_mesh(4))
    try:
        assert sys_._scan_layout(rows) == "packed"
        assert sys_._scan_layout(rows // 8) is True
    finally:
        sys_.close()


# -- the paths of dryrun_multichip ------------------------------------------


@pytest.fixture(scope="module")
def dryrun():
    """Every path ``__graft_entry__.dryrun_multichip`` drives, at its
    shapes, on the JAX mesh."""
    n, d, q, k = 64 * ND, 32, 4, 5
    rng = np.random.default_rng(0)
    base = _grid(rng.normal(size=(n, d)))
    queries = _grid(rng.normal(size=(q, d)))
    jb, bank = _banks(base, m=8, lam=2, tables=2, divisions=2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    jbw, bankw = _banks(base, m=24, lam=3, tables=2, divisions=2)
    _assert_codes_equal(jbw, bankw, base)
    ref = {}
    j = JIndex(jmake_mesh(ND), jb, block_size=16)
    j.build(base, keep_codes=True, keep_bits=True)
    ref["tables"], ref["state"] = _jax_tables(j), _jax_state(j)
    ref["base"] = j._gather_host(j.base)
    jstep = jax.jit(j.query_step_fn(probes=2, refinement_limit=64, k=k))
    ref["query"] = _host(jstep(j.table, j.base, j.tombs,
                               jnp.asarray(queries)))
    ref["rerank"] = j.route(queries, probes=2, refinement_limit=64,
                            rerank_limit=32)
    ref["scan"] = j.scan_route(queries, limit=32, approx=False)
    j2 = JIndex(jmake_mesh(ND), jb, block_size=16)
    j2.build_stream((base[i:i + 50] for i in range(0, n, 50)), n,
                    keep_bits=True)
    ref["stream_tables"], ref["stream_state"] = _jax_tables(j2), \
        _jax_state(j2)
    j3 = JIndex(jmake_mesh(ND), jb, block_size=16)
    j3.build(base, keep_base=False, keep_bits="packed")
    ref["packed_state"] = _jax_state(j3)
    j4 = JIndex(jmake_mesh(ND), jbw, block_size=16, wide_keys=True)
    j4.build(base, keep_base=False, keep_codes=True, keep_bits=False)
    ref["wide_tables"] = _jax_tables(j4)
    ref["wide_route"] = j4.route(queries, probes=2, refinement_limit=64)
    return types.SimpleNamespace(base=base, queries=queries, k=k, bank=bank,
                                 bankw=bankw, ref=ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_dryrun_multichip_equalities_over_slots(dryrun, slots):
    base, queries, ref = dryrun.base, dryrun.queries, dryrun.ref
    t = _index(slots, dryrun.bank, block=16)
    t.build(base, keep_codes=True, keep_bits=True)
    _assert_per_slot(t, slots)
    _assert_tables_equal(ref["tables"], t)
    _assert_state_equal(ref["state"], t)
    np.testing.assert_array_equal(t._gather_host(t.base), ref["base"])
    got = t.query_step_fn(probes=2, refinement_limit=64, k=dryrun.k)(
        t.table, t.base, t.tombs, torch.from_numpy(queries))
    assert got[0].device == t.mesh.device
    _assert_query_same(_host(got), ref["query"])
    _assert_same(t.route(queries, probes=2, refinement_limit=64,
                         rerank_limit=32), ref["rerank"], "rerank route")
    _assert_same(t.scan_route(queries, limit=32), ref["scan"], "scan")

    t2 = _index(slots, dryrun.bank, block=16)
    assert t2.build_stream((base[i:i + 50] for i in range(0, len(base), 50)),
                           len(base), keep_bits=True) == len(base)
    _assert_per_slot(t2, slots)
    _assert_tables_equal(ref["stream_tables"], t2)
    _assert_state_equal(ref["stream_state"], t2)
    _assert_same(t2.scan_route(queries, limit=32), ref["scan"], "streamed")

    t3 = _index(slots, dryrun.bank, block=16)
    t3.build(base, keep_base=False, keep_bits="packed")
    _assert_per_slot(t3, slots)
    _assert_state_equal(ref["packed_state"], t3)
    _assert_same(t3.scan_route(queries, limit=32), ref["scan"], "packed")
    t3.merge_backend = "host"
    _assert_same(t3.scan_route(queries, limit=32), ref["scan"], "host merge")

    t4 = _index(slots, dryrun.bankw, block=16, wide=True)
    t4.build(base, keep_base=False, keep_codes=True, keep_bits=False)
    _assert_tables_equal(ref["wide_tables"], t4)
    assert all(tb.min_key2 is not None for tb in t4._per_device(t4.table))
    _assert_same(t4.route(queries, probes=2, refinement_limit=64),
                 ref["wide_route"], "wide route")


# -- the scan: layouts, merges, approx ---------------------------------------


@pytest.fixture(scope="module")
def scan_case():
    n, d, q, L = 1500, 12, 5, 64
    rng = np.random.default_rng(21)
    base = _grid(rng.normal(size=(n, d)) * 4)
    queries = _grid(base[:q] + 0.05)
    jb, bank = _banks(base[:512], seed=5)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    dead = np.arange(0, n, 97)
    ref = {}
    for layout in (True, "packed"):
        j = JIndex(jmake_mesh(ND), jb, block_size=32)
        j.build(base, keep_base=False, keep_bits=layout, capacity=n + 128)
        j.mark_deleted(dead)
        ref[layout, "state"] = _jax_state(j)
        for approx in (False, True):
            ref[layout, approx] = j.scan_route(queries, limit=L,
                                               approx=approx)
        ref[layout, "sub"] = j.scan_route(queries, limit=L, probe_shards=3,
                                          approx=False)
    return types.SimpleNamespace(base=base, queries=queries, bank=bank,
                                 dead=dead, L=L, ref=ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_scan_over_slots_matches_jax(scan_case, slots):
    """Unpacked and packed, ``approx`` off and on, merged on the first
    slot (``"ici"``) and on the host, with tombstones and a probe-shard
    cap: every route equals the JAX mesh's."""
    c = scan_case
    for layout in (True, "packed"):
        t = _index(slots, c.bank)
        t.build(c.base, keep_base=False, keep_bits=layout,
                capacity=len(c.base) + 128)
        t.mark_deleted(c.dead)
        _assert_per_slot(t, slots)
        _assert_state_equal(c.ref[layout, "state"], t)
        for merge in ("ici", "host"):
            t.merge_backend = merge
            for approx in (False, True):
                _assert_same(t.scan_route(c.queries, limit=c.L,
                                          approx=approx),
                             c.ref[layout, approx], (layout, merge, approx))
            _assert_same(t.scan_route(c.queries, limit=c.L, probe_shards=3),
                         c.ref[layout, "sub"], (layout, merge, "probe 3"))
        # the host-merge step hands back one block tensor a slot
        mk = t.scan_route_step_fn_packed if layout == "packed" \
            else t.scan_route_step_fn
        ids, sc = mk(c.L, merge="host")(
            t.words if layout == "packed" else t.bits, t.popc, t.tombs,
            torch.from_numpy(c.queries), t.n)
        parts = t._per_device(ids)
        assert len(parts) == slots
        assert all(p.shape == (len(c.queries), ND // slots * c.L)
                   for p in parts)
        _assert_same(tsharded.host_merge_topl(ids, sc, c.L),
                     c.ref[layout, False], (layout, "host step"))


# -- the probe route, the re-rank, the plaintext query -----------------------


@pytest.fixture(scope="module")
def probe_case():
    n, d, q = 1024, 16, 5
    rng = np.random.default_rng(22)
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(base[rng.integers(0, n, q)]
                    + rng.normal(size=(q, d)) * 0.1)
    jb, bank = _banks(base[:1000])
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    dead = np.arange(0, n, 7)
    j = JIndex(jmake_mesh(ND), jb, block_size=32)
    j.build(base, keep_base=True, keep_codes=True, keep_bits=False)
    j.mark_deleted(dead)
    ref = dict(
        route=j.route(queries, probes=3, refinement_limit=256),
        rerank=j.route(queries, probes=3, refinement_limit=512,
                       rerank_limit=60),
        sub=j.route(queries, probes=3, refinement_limit=256,
                    probe_shards=2),
        query=j.query(queries, probes=3, refinement_limit=256, k=5),
        query_sub=j.query(queries, probes=3, refinement_limit=256, k=5,
                          probe_shards=3))
    return types.SimpleNamespace(base=base, queries=queries, bank=bank,
                                 dead=dead, ref=ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_probe_rerank_and_query_over_slots_match_jax(probe_case, slots):
    c = probe_case
    t = _index(slots, c.bank)
    t.build(c.base, keep_base=True, keep_codes=True, keep_bits=False)
    t.mark_deleted(c.dead)
    _assert_per_slot(t, slots)
    _assert_same(t.route(c.queries, probes=3, refinement_limit=256),
                 c.ref["route"], "route")
    _assert_same(t.route(c.queries, probes=3, refinement_limit=512,
                         rerank_limit=60), c.ref["rerank"], "re-rank")
    _assert_same(t.route(c.queries, probes=3, refinement_limit=256,
                         probe_shards=2), c.ref["sub"], "probe 2 shards")
    _assert_query_same(t.query(c.queries, probes=3, refinement_limit=256,
                               k=5), c.ref["query"])
    _assert_query_same(t.query(c.queries, probes=3, refinement_limit=256,
                               k=5, probe_shards=3), c.ref["query_sub"])


# -- streamed build, live insert, delete, checkpoint -------------------------


@pytest.fixture(scope="module")
def lifecycle():
    n0, n1, d, cap = 1500, 300, 16, 2048
    rng = np.random.default_rng(23)
    base = _grid(rng.normal(size=(n0 + n1, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    jb, bank = _banks(base[:512], 8, 2, 2, 2)
    _assert_codes_equal(jb, bank, base)
    _assert_codes_equal(jb, bank, queries)
    sizes = [300, 77, 423, 400, 156, 144]      # ragged, crossing slots
    off = np.cumsum([0] + sizes)
    dead = np.arange(3, n0 + n1, 11)
    ref = {}
    j = JIndex(jmake_mesh(ND), jb, block_size=16)
    j.build_stream((base[a:b] for a, b in zip(off, off[1:])), n0,
                   keep_bits=True, keep_codes=True, capacity=cap)
    ref["stream_tables"], ref["stream_state"] = _jax_tables(j), \
        _jax_state(j)
    ref["stream_scan"] = j.scan_route(queries, limit=64, approx=False)
    ref["stream_route"] = j.route(queries, probes=3, refinement_limit=128)
    for layout in (True, "packed"):
        j = JIndex(jmake_mesh(ND), jb, block_size=16)
        j.build(base[:n0], keep_base=False, keep_bits=layout, capacity=cap)
        j.append_scan_rows(base[n0:])
        j.mark_deleted(dead)
        ref[layout, "state"] = _jax_state(j)
        ref[layout] = j.scan_route(queries, limit=64, approx=False)
        j.mark_undeleted(dead[:20])
        ref[layout, "undeleted"] = j.scan_route(queries, limit=64,
                                                approx=False)
    return types.SimpleNamespace(base=base, queries=queries, bank=bank, n0=n0,
                                 cap=cap, dead=dead, off=off, ref=ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_build_stream_over_slots_matches_jax(lifecycle, slots):
    c = lifecycle
    t = _index(slots, c.bank, block=16)
    assert t.build_stream((c.base[a:b] for a, b in zip(c.off, c.off[1:])),
                          c.n0, keep_bits=True, keep_codes=True,
                          capacity=c.cap) == c.n0
    _assert_per_slot(t, slots)
    _assert_tables_equal(c.ref["stream_tables"], t)
    _assert_state_equal(c.ref["stream_state"], t)
    _assert_same(t.scan_route(c.queries, limit=64), c.ref["stream_scan"])
    _assert_same(t.route(c.queries, probes=3, refinement_limit=128),
                 c.ref["stream_route"])


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in sorted(z.namelist())}


@pytest.mark.parametrize("slots", SLOTS)
def test_live_insert_delete_and_save_over_slots(lifecycle, slots, tmp_path):
    """Inserts land in place on the slot that owns them, deletes and
    undeletes reach the right slot's mask, every route equals JAX's, and
    the checkpoint holds the same bytes as the one-slot mesh's."""
    c = lifecycle
    n1 = len(c.base) - c.n0
    for layout in (True, "packed"):
        idx = {}
        for s in sorted({1, slots}):
            t = _index(s, c.bank, block=16)
            t.build(c.base[:c.n0], keep_base=False, keep_bits=layout,
                    capacity=c.cap)
            state = t.words if layout == "packed" else t.bits
            ptrs = [(p.data_ptr(), q.data_ptr(), r.data_ptr())
                    for p, q, r in zip(t._per_device(state),
                                       t._per_device(t.popc),
                                       t._per_device(t.tombs))]
            np.testing.assert_array_equal(t.append_scan_rows(c.base[c.n0:]),
                                          np.arange(c.n0, c.n0 + n1))
            t.mark_deleted(c.dead)
            state = t.words if layout == "packed" else t.bits
            assert [(p.data_ptr(), q.data_ptr(), r.data_ptr())
                    for p, q, r in zip(t._per_device(state),
                                       t._per_device(t.popc),
                                       t._per_device(t.tombs))] == ptrs, \
                "the insert or the delete moved the state"
            _assert_per_slot(t, s)
            _assert_state_equal(c.ref[layout, "state"], t)
            _assert_same(t.scan_route(c.queries, limit=64), c.ref[layout],
                         (layout, "after insert and delete"))
            t.save_state(str(tmp_path / f"{layout}-{s}.npz"))
            t.mark_undeleted(c.dead[:20])
            _assert_same(t.scan_route(c.queries, limit=64),
                         c.ref[layout, "undeleted"], (layout, "undelete"))
            idx[s] = t
        assert _npz_members(tmp_path / f"{layout}-{slots}.npz") == \
            _npz_members(tmp_path / f"{layout}-1.npz")
        with pytest.raises(RuntimeError, match="capacity"):
            idx[slots].append_scan_rows(c.base[:c.cap])


@pytest.mark.parametrize("src,dst", [(1, 4), (4, 1), (4, 8), (8, 4), (1, 8),
                                     (8, 2)])
def test_restore_across_slot_counts(lifecycle, src, dst, tmp_path):
    """A checkpoint restores into any slot count of the same shard count,
    every slot's codes straight onto its device."""
    c = lifecycle
    a = _index(src, c.bank, block=16)
    a.build(c.base, keep_base=False, keep_bits=True, keep_codes=True)
    path = str(tmp_path / "mesh_state.npz")
    a.save_state(path)
    b = ShardedIndex.restore_state(path, _mesh(dst), keep_codes=True,
                                   keep_bits=True)
    _assert_per_slot(b, dst)
    assert b.n == a.n and b.shard_rows == a.shard_rows
    for f in STATE:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(b._gather_host(y),
                                          a._gather_host(x), err_msg=f)
    _assert_same(b.scan_route(c.queries, limit=64),
                 a.scan_route(c.queries, limit=64), "scan")
    _assert_same(b.route(c.queries, probes=3, refinement_limit=128,
                         rerank_limit=40),
                 a.route(c.queries, probes=3, refinement_limit=128,
                         rerank_limit=40), "re-rank")
    with pytest.raises(ValueError, match="8 devices"):
        ShardedIndex.restore_state(path, make_mesh(4, devices=["cpu"] * 4))


def test_jax_checkpoint_restores_into_four_slots(tmp_path):
    """A ``mesh_state.npz`` as the JAX package writes it (no ``alpha``: the
    port regenerates it from the seed) restores into 4 slots and serves
    JAX's routes."""
    n, d = 1200, 16
    rng = np.random.default_rng(24)
    base = _grid(rng.normal(size=(n, d)) * 3)
    queries = _grid(rng.normal(size=(5, d)) * 3)
    raw = jcoding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    j = JIndex(jmake_mesh(ND), raw, block_size=16)
    j.build(base, keep_base=False, keep_bits=True, keep_codes=True)
    path = str(tmp_path / "mesh_state.npz")
    j.save_state(path)
    back = ShardedIndex.restore_state(path, _mesh(4), keep_codes=True)
    _assert_per_slot(back, 4)
    _assert_codes_equal(raw, back.bank, queries)
    _assert_tables_equal(_jax_tables(j), back)
    _assert_state_equal(_jax_state(j), back)
    _assert_same(back.scan_route(queries, limit=64),
                 j.scan_route(queries, limit=64, approx=False))
    _assert_same(back.route(queries, probes=3, refinement_limit=128,
                            rerank_limit=40),
                 j.route(queries, probes=3, refinement_limit=128,
                         rerank_limit=40))


# -- the facade ----------------------------------------------------------------


@pytest.fixture
def grid_banks(monkeypatch):
    """Each facade draws its own bank (equal bit for bit), with ``alpha``
    then put on the 2^-10 grid in both, where the two device encoders'
    summation orders give the same codes."""
    def on_grid(build):
        def grid_build(*args, **kw):
            b = build(*args, **kw)
            alpha = (np.round(np.asarray(b.alpha, np.float64) * 1024)
                     / 1024).astype(np.float32)
            return dataclasses.replace(b, alpha=alpha)
        return grid_build

    for coding in (jserving.coding, tserving.coding):
        monkeypatch.setattr(coding, "build_bank_from_sample",
                            on_grid(coding.build_bank_from_sample))


@pytest.mark.parametrize("mode,merge", [("probe", "ici"), ("scan", "ici"),
                                        ("scan", "host")])
def test_facade_over_four_slots(tmp_path, grid_banks, mode, merge):
    """``DistributedEncryptedSystem`` over 4 slots serves the ids and
    distances of the one-slot facade and of the JAX facade, through build,
    search, live insert (scan mode), delete, save and a fresh restore."""
    n, d, q, k = 2048, 16, 6, 10
    rng = np.random.default_rng(25)
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = _grid(centers[rng.integers(0, 16, n)]
                 + rng.normal(size=(n, d)).astype(np.float32))
    queries = _grid(centers[rng.integers(0, 16, q)]
                    + rng.normal(size=(q, d)).astype(np.float32))
    extra = _grid(base[:64] + 0.25)

    def run(c, system):
        cfg = c.SystemConfig(
            paper=c.PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=c.RuntimeConfig(
                refinement_limit=512, max_global_candidates=512,
                default_probes=4, block_size=32, rerank_limit=200,
                routing_mode=mode, mesh_merge=merge)).validate()
        sys_ = system(cfg, "db")
        out = {}
        try:
            sys_.build(base, capacity=n + 128)
            out["first"] = sys_.search_batch(queries, k)
            if mode == "scan":
                out["ids"] = sys_.insert_live(extra)
                out["own"] = sys_.search_batch(extra[:8], k)
            sys_.delete(np.arange(0, n, 5))
            out["deleted"] = sys_.search_batch(queries, k)
            sys_.save_index()
        finally:
            sys_.close()
        back = system(cfg, "db")
        try:
            out["restored_n"] = back.restore_index()
            out["restored"] = back.search_batch(queries, k)
        finally:
            back.close()
        return out

    def jax_system(cfg, tag):
        return jserving.DistributedEncryptedSystem(
            cfg, str(tmp_path / "jax" / tag), d)

    def port_system(slots):
        def make(cfg, tag):
            return tserving.DistributedEncryptedSystem(
                cfg, str(tmp_path / f"torch{slots}" / tag), d,
                mesh=_mesh(slots))
        return make

    want = run(jconfig, jax_system)
    one = run(tconfig, port_system(1))
    four = run(tconfig, port_system(4))
    for name, ref in (("JAX", want), ("one slot", one)):
        assert sorted(four) == sorted(ref), name
        for key, a in ref.items():
            b = four[key]
            if isinstance(a, tuple):
                np.testing.assert_array_equal(b[0], a[0],
                                              err_msg=f"{name} {key}")
                np.testing.assert_allclose(b[1], a[1], rtol=DIST_RTOL,
                                           err_msg=f"{name} {key}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{name} {key}")
    assert four["first"][0].shape == (q, k)
    assert (four["first"][0] >= 0).all()
