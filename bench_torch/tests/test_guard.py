"""The benchmark measures the port alone: a run imports neither JAX nor
the JAX package, and no harness source names the JAX-era drivers."""

import os
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ("bench" + ".py", "chip" + "_smoke", "bench" + "_results")


def test_no_harness_source_names_the_jax_drivers():
    top = os.path.join(ROOT, "bench_torch")
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for word in FORBIDDEN:
                    assert word not in text, (f, word)


def test_a_run_imports_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from bench_torch import harness\n"
        "t = time.perf_counter()\n"
        "out = harness.run_cell(%r, 'sift1m-scan.ycsb-d', 7, 0.2, False,\n"
        "                       'cpu', t, t, overrides={'n': 3000})\n"
        "assert out['correct'], out\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'fspann_tpu' or m.startswith('fspann_tpu.')]\n"
        "assert not bad, bad\n" % (ROOT, ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch", "run.py"),
         "--workload", "sift1m-scan.b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
