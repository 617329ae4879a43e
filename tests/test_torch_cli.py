"""The port's command line (fspann_tpu_torch/api/cli.py) and the carried
modules it reaches — multi-dimension systems, decoys, key utilities,
interfaces and paths — on the CPU, against the JAX package where both can
run the same input.

Mirrors tests/test_cli.py, tests/test_multidim.py, tests/test_interfaces.py
and the keyutils case of tests/test_aux.py."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fspann_tpu_torch.api import cli
from fspann_tpu_torch.api.multidim import MultiDimSystem
from fspann_tpu_torch.config import (EvalConfig, PaperConfig,
                                     ReencryptionConfig, RuntimeConfig,
                                     SystemConfig)

torch.set_num_threads(1)


def write_fvecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, 1 + d), "<f4")
    out[:, 0:1] = np.frombuffer(np.full(n, d, "<i4").tobytes(), "<f4"
                                ).reshape(n, 1)
    out[:, 1:] = arr
    out.tofile(str(path))


@pytest.fixture
def dataset(tmp_path, rng):
    centers = rng.normal(size=(8, 12)).astype(np.float32) * 5
    base = centers[rng.integers(0, 8, 1200)] + \
        rng.normal(size=(1200, 12)).astype(np.float32)
    queries = centers[rng.integers(0, 8, 6)] + \
        rng.normal(size=(6, 12)).astype(np.float32)
    write_fvecs(tmp_path / "base.fvecs", base)
    write_fvecs(tmp_path / "q.fvecs", queries)
    return tmp_path


def small_cfg_file(tmp_path, **runtime):
    p = tmp_path / "cfg.json"
    rt = {"refinementLimit": 300, "maxGlobalCandidates": 300,
          "blockSize": 32}
    rt.update(runtime)
    p.write_text(json.dumps({
        "paper": {"m": 6, "lambda": 2, "divisions": 2, "tables": 2, "seed": 5},
        "runtime": rt, "eval": {"kVariants": [1, 5]},
        "profiles": {"SCAN": {"runtime": {"routingMode": "scan",
                                          "rerankLimit": 100}}},
    }))
    return str(p)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_full_then_query_only(dataset, capsys):
    cfg = small_cfg_file(dataset)
    rc = cli.main(["--data", str(dataset / "base.fvecs"),
                   "--queries", str(dataset / "q.fvecs"),
                   "--gt", "AUTO", "--config", cfg,
                   "--base-dir", str(dataset / "db"),
                   "--results", str(dataset / "res"),
                   "--query-batch", "4", "--device", "cpu"])
    assert rc == 0
    out = _last_json(capsys)
    assert out["recall_at_10"] is None     # k <= 5 here
    assert out["queries"] == 6
    assert (dataset / "res" / "summary.csv").exists()

    rc2 = cli.main(["--query-only", "--queries", str(dataset / "q.fvecs"),
                    "--config", cfg,
                    "--base-dir", str(dataset / "db"),
                    "--results", str(dataset / "res2"),
                    "--query-batch", "4", "--no-reencrypt",
                    "--device", "cpu"])
    assert rc2 == 0
    assert _last_json(capsys)["queries"] == 6


def test_cli_requires_data_without_query_only(dataset):
    with pytest.raises(SystemExit):
        cli.main(["--queries", str(dataset / "q.fvecs"),
                  "--base-dir", str(dataset / "db2"), "--device", "cpu"])


def test_cli_gt_validation_gate(dataset, rng):
    """A corrupted GT file aborts the run (reference behavior,
    ForwardSecureANNSystem.java:2158-2186)."""
    cfg = small_cfg_file(dataset)
    bad_gt = rng.integers(0, 1200, (6, 5)).astype(np.int32)
    out = np.empty((6, 6), "<i4")
    out[:, 0] = 5
    out[:, 1:] = bad_gt
    out.tofile(str(dataset / "bad.ivecs"))
    with pytest.raises(SystemExit, match="GT validation failed"):
        cli.main(["--data", str(dataset / "base.fvecs"),
                  "--queries", str(dataset / "q.fvecs"),
                  "--gt", str(dataset / "bad.ivecs"), "--config", cfg,
                  "--base-dir", str(dataset / "db3"),
                  "--results", str(dataset / "res3"), "--device", "cpu"])


@pytest.mark.parametrize("scan_native", ["auto", "off"])
def test_cli_scan_profile_matches_jax_cli(dataset, capsys, scan_native):
    """A scan profile through both packages' command lines, the JAX bank
    placed in the port's store directory first: the same recall and
    ratio (host encode, so both encode the same codes)."""
    from fspann_tpu.api import cli as jcli
    from fspann_tpu.index.service import PartitionedIndex as JIndex
    from fspann_tpu import config as jconfig
    from fspann_tpu_torch.api.convert import bank_from_jax
    from fspann_tpu_torch.config import load_config
    from fspann_tpu_torch.index.service import PartitionedIndex

    cfg = small_cfg_file(dataset, encodeBackend="cpu", scanNative=scan_native)

    def run(main, db, extra=()):
        rc = main(["--data", str(dataset / "base.fvecs"),
                   "--queries", str(dataset / "q.fvecs"),
                   "--gt", "AUTO", "--config", cfg, "--profile", "SCAN",
                   "--base-dir", str(dataset / db),
                   "--results", str(dataset / f"res_{db}"),
                   "--query-batch", "4", *extra])
        assert rc == 0
        assert (dataset / f"res_{db}" / "summary.csv").exists()
        return _last_json(capsys)

    want = run(jcli.main, "jax")
    jb = JIndex(jconfig.load_config(cfg, "SCAN"), 12,
                bank_path=str(dataset / "jax" / "bank.npz")).bank
    PartitionedIndex(load_config(cfg, "SCAN"), 12,
                     bank_path=str(dataset / "torch" / "bank.npz"),
                     device="cpu").set_bank(bank_from_jax(
                         np.asarray(jb.alpha), np.asarray(jb.r),
                         np.asarray(jb.omega), jb.m, jb.lam, jb.tables,
                         jb.divisions, jb.seed))
    got = run(cli.main, "torch", ("--device", "cpu"))
    assert got["queries"] == want["queries"] == 6
    assert got["recall_at_10"] == want["recall_at_10"]
    assert got["ratio"] == pytest.approx(want["ratio"], abs=1e-6)


def test_cli_decoys_produce_real_metrics(dataset, capsys):
    """--decoys still produces recall/ratio, equal to a decoy-free run:
    evaluation masks decoys out."""
    cfg = small_cfg_file(dataset)

    def run(extra, dbdir):
        rc = cli.main(["--data", str(dataset / "base.fvecs"),
                       "--queries", str(dataset / "q.fvecs"),
                       "--gt", "AUTO", "--config", cfg,
                       "--base-dir", str(dataset / dbdir),
                       "--results", str(dataset / ("res_" + dbdir)),
                       "--query-batch", "4", "--no-reencrypt",
                       "--device", "cpu"] + extra)
        assert rc == 0
        return _last_json(capsys)

    plain = run([], "db_plain")
    cloak = run(["--decoys"], "db_cloak")
    assert cloak["queries"] == plain["queries"] == 6
    assert cloak["recall_at_10"] == pytest.approx(plain["recall_at_10"])
    assert cloak["ratio"] == pytest.approx(plain["ratio"], abs=1e-6)


def test_decoys_match_jax(rng):
    from fspann_tpu.query.decoy import DecoyGenerator as JDecoys
    from fspann_tpu_torch.query.decoy import DecoyGenerator

    q = rng.normal(size=(20, 12)).astype(np.float32)
    for mode in ("gaussian", "uniform", "clustered"):
        a, sa = DecoyGenerator(12, rate=0.5, seed=9, mode=mode).interleave(q)
        b, sb = JDecoys(12, rate=0.5, seed=9, mode=mode).interleave(q)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
        assert (sa == -1).sum() > 0
        np.testing.assert_array_equal(a[sa >= 0], q[sa[sa >= 0]])


# -- multi-dimension systems (tests/test_multidim.py) -------------------------


def small_cfg(**runtime):
    return SystemConfig(
        paper=PaperConfig(m=6, lam=2, divisions=2, tables=2, seed=5),
        runtime=RuntimeConfig(refinement_limit=300, max_global_candidates=300,
                              block_size=32, **runtime),
        eval=EvalConfig(k_variants=(1, 5)),
    ).validate()


def test_two_dims_share_keys(tmp_path, rng):
    md = MultiDimSystem(small_cfg(), str(tmp_path / "db"), device="cpu")
    try:
        v8 = rng.normal(size=(1100, 8)).astype(np.float32)
        v16 = rng.normal(size=(1100, 16)).astype(np.float32)
        md.batch_insert(np.arange(1100), v8)
        md.batch_insert(np.arange(1100), v16)
        md.finalize_for_search()
        assert md.dims == [8, 16]
        assert md.search(md.create_token(v8[3], 1))[0].id == 3
        assert md.search(md.create_token(v16[5], 1))[0].id == 5
        assert md.system_for(8).km is md.system_for(16).km
        rep = md.run_selective_reencryption()
        assert rep["new_version"] == 2
        assert set(rep["per_dim"]) == {8, 16}
        assert rep["per_dim"][8]["reencrypted"] > 0
        assert md.search(md.create_token(v8[3], 1))[0].id == 3
        assert md.search(md.create_token(v16[5], 1))[0].id == 5
    finally:
        md.shutdown()


def test_multidim_restore_all(tmp_path, rng):
    md = MultiDimSystem(small_cfg(), str(tmp_path / "db"), device="cpu")
    v8 = rng.normal(size=(1100, 8)).astype(np.float32)
    v16 = rng.normal(size=(1100, 16)).astype(np.float32)
    md.batch_insert(np.arange(1100), v8)
    md.batch_insert(np.arange(1100), v16)
    md.finalize_for_search()
    r1 = md.search(md.create_token(v8[3], 1))[0].id
    md.shutdown()
    md2 = MultiDimSystem(small_cfg(), str(tmp_path / "db"), device="cpu")
    try:
        assert md2.restore_all() == {8: 1100, 16: 1100}
        assert md2.search(md2.create_token(v8[3], 1))[0].id == r1
        assert md2.search(md2.create_token(v16[5], 1))[0].id == 5
    finally:
        md2.shutdown()


def test_multidim_background_reencryption_shares_keystore(tmp_path, rng):
    cfg = dataclasses.replace(
        small_cfg(), reencryption=ReencryptionConfig(
            background_enabled=True, background_interval_s=30.0))
    md = MultiDimSystem(cfg, str(tmp_path / "db"), device="cpu")
    try:
        md.batch_insert(np.arange(1100),
                        rng.normal(size=(1100, 8)).astype(np.float32))
        md.finalize_for_search()
        sub = md.system_for(8)
        assert sub.background is not None
        assert sub.background.svc.km is md.km
        assert sub.store.km is md.km and sub.tokens.km is md.km
        md.km.rotate()
        migrated = sub.background.run_once()
        assert migrated > 0
        assert sub.store.meta.count_with_version(2) == migrated
    finally:
        md.shutdown()


@pytest.mark.parametrize("scan_native", ["auto", "off"])
def test_multidim_scan_mode_with_live_insert(tmp_path, rng, scan_native):
    """Scan-mode sub-systems off one keystore, each taking live inserts."""
    md = MultiDimSystem(small_cfg(routing_mode="scan", rerank_limit=80,
                                  scan_native=scan_native),
                        str(tmp_path / "md"), device="cpu")
    try:
        for dim in (8, 24):
            base = rng.normal(size=(1100, dim)).astype(np.float32) * 3
            s = md.system_for(dim)
            s.index_stream(base, batch_size=400)
            s.finalize_for_search()
            assert s.search(s.create_token(base[5], 5))[0].id == 5
            new = rng.normal(size=(3, dim)).astype(np.float32) * 3 + 30
            s.insert_live(np.arange(1100, 1103), new)
            assert s.search(s.create_token(new[2], 1))[0].id == 1102
        assert md.system_for(8).km is md.system_for(24).km
    finally:
        md.shutdown()


# -- interfaces, paths, key utilities -----------------------------------------


def test_protocol_conformance(tmp_path):
    from fspann_tpu_torch import interfaces as I
    from fspann_tpu_torch.crypto.keys import KeyManager
    from fspann_tpu_torch.crypto.rotation import KeyRotationService
    from fspann_tpu_torch.index.service import PartitionedIndex
    from fspann_tpu_torch.store.metadata import MetadataLog
    from fspann_tpu_torch.store.point_store import PointStore

    km = KeyManager(str(tmp_path / "ks"))
    store = PointStore(str(tmp_path / "db"), km, dim=4)
    rot = KeyRotationService(km, store)
    idx = PartitionedIndex(SystemConfig().validate(), dim=4, device="cpu")
    meta = MetadataLog(str(tmp_path / "m.log"))
    try:
        assert isinstance(idx, I.IndexService)
        assert isinstance(rot, I.KeyLifeCycleService)
        assert isinstance(rot, I.SelectiveReencryptor)
        assert isinstance(store, I.PointStoreProtocol)
        assert isinstance(store, I.StorageSizer)
        assert isinstance(meta, I.MetadataManager)
    finally:
        store.close()


def test_fspaths_defaults_and_env(tmp_path, monkeypatch):
    import os

    from fspann_tpu_torch.utils.paths import FsPaths

    p = FsPaths(str(tmp_path / "base"))
    assert p.points_dir.endswith("points")
    assert p.keystore_file.endswith("keystore.blob")
    monkeypatch.setenv("FSPANN_POINTS_DIR", "/elsewhere/pts")
    assert FsPaths(str(tmp_path)).points_dir == "/elsewhere/pts"
    monkeypatch.setenv("FSPANN_BASE_DIR", str(tmp_path / "envbase"))
    assert FsPaths().base_dir == str(tmp_path / "envbase")
    assert os.path.isdir(FsPaths(str(tmp_path / "made")).ensure().base_dir)


def test_keyutils():
    from fspann_tpu.crypto import keyutils as jkeyutils
    from fspann_tpu_torch.crypto.keyutils import key_from_bytes, try_decrypt

    kv = key_from_bytes(bytes(range(32)), version=7)
    assert kv.version == 7
    ct = kv.gcm().seal(b"\x00" * 12, b"hello", b"aad1")
    assert try_decrypt(bytes(range(32)), b"\x00" * 12, ct,
                       [b"wrong", b"aad1"]) == b"hello"
    assert try_decrypt(bytes(range(1, 33)), b"\x00" * 12, ct,
                       [b"aad1"]) is None
    # the JAX package opens what the port sealed
    assert jkeyutils.try_decrypt(bytes(range(32)), b"\x00" * 12, ct,
                                 [b"aad1"]) == b"hello"
