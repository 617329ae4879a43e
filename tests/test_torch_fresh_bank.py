"""A fresh build in each package, from the same data, with no bank carried
across: the JAX facade and the port's (``device="cpu"``) each draw their
bank from the sample their index buffers (``coding.build_bank_from_sample``)
and write it to their own store.  The bank files (the port's also holds
``alpha``), the corpus codes and the
scan route's final ids are equal bit for bit; distances agree within
``DIST_RTOL`` (``torch_mirror``).  Codes are encoded on the host
(``encode_backend="cpu"``), where both packages run the same numpy code."""

import numpy as np

from fspann_tpu.io import synthetic
from torch_mirror import DIST_RTOL, results, systems

DIM = 128
N = 3_000


def scan_cfg(c):
    return c.SystemConfig(
        paper=c.PaperConfig(seed=13),
        runtime=c.RuntimeConfig(routing_mode="scan", encode_backend="cpu",
                                refinement_limit=400,
                                max_global_candidates=400,
                                block_size=32)).validate()


def test_fresh_builds_draw_the_same_bank(tmp_path):
    base, queries = synthetic.lsh_hard_corpus(N, DIM, 16, seed=42)
    js, make = systems(scan_cfg, tmp_path, DIM)
    ts = make()
    try:
        for s in (js, ts):
            s.index_stream(base, batch_size=1_000)
            s.finalize_for_search()
        jbank = np.load(tmp_path / "jax" / "bank.npz")
        tbank = np.load(tmp_path / "torch" / "bank.npz")
        # the port's file also keeps alpha, which JAX regenerates from
        # the seed
        assert set(tbank.files) == set(jbank.files) | {"alpha"}
        for f in jbank.files:
            np.testing.assert_array_equal(tbank[f], jbank[f], err_msg=f)
        np.testing.assert_array_equal(tbank["alpha"],
                                      np.asarray(js.index.bank.alpha))
        np.testing.assert_array_equal(ts.index._scan_codes,
                                      np.asarray(js.index._scan_codes))
        got, want = results(ts, queries, 10), results(js, queries, 10)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=DIST_RTOL)
    finally:
        js.shutdown()
        ts.shutdown()
