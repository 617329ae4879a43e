"""The readers of the set-up's spans and counter (``metrics/build_*.setup``:
``index.encode`` and ``store.seal`` under the ``system.index_stream`` root,
``index.finalize.tables`` under ``system.finalize``, and the counters
``index.encode.workers`` over ``index.encode.calls``) on synthetic root
records: each reads its number, and nothing from a program that keeps no
such root or counter."""

import json
import os
import types

import pytest

from bench_torch import harness

from .conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SCAN = [c for c in CELLS if harness.Cell.find(ROOT, c).config["program"]
        ["runtime"]["encode_backend"] == "cpu"]
RUN = types.SimpleNamespace(kind="batch", queries=0)
# the roots a build through the facade leaves, as {name: total ns}
ROOTS = {
    "system.index_stream": {"system.index_stream": 9_000_000_000,
                            "index.encode": 2_500_000_000,
                            "store.seal": 750_000_000,
                            "store.persist": 400_000_000,
                            "index.encode.calls": 4,
                            "index.encode.workers": 30},
    "system.finalize": {"system.finalize": 3_000_000_000,
                        "index.finalize.tables": 1_250_000_000},
}


def _reader(name):
    return harness._module(os.path.join(ROOT, "bench_torch", "metrics",
                                        f"{name}.py")).read


def _program(monkeypatch, roots):
    from fspann_tpu_torch.utils import profiler

    asked = []

    def recent(root, n):
        asked.append((root, n))
        return [roots[root]] * n if root in roots else []

    monkeypatch.setattr(profiler, "recent", recent)
    return asked


@pytest.mark.parametrize("name,unit,better,source,cells", [
    ("build_encode_s.setup", "s", "lower", "program_span", CELLS),
    ("build_seal_s.setup", "s", "lower", "program_span", CELLS),
    ("build_tables_s.setup", "s", "lower", "program_span", CELLS),
    ("build_encode_workers.setup", "threads", "higher", "program_counter",
     SCAN)])
def test_the_entries(name, unit, better, source, cells):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry == {"name": name, "unit": unit, "better": better,
                     "source": source, "layer": "set-up",
                     "moves": "setup_s", "workloads": cells}


@pytest.mark.parametrize("name,root,value", [
    ("build_encode_s.setup", "system.index_stream", 2.5),
    ("build_seal_s.setup", "system.index_stream", 0.75),
    ("build_tables_s.setup", "system.finalize", 1.25),
    ("build_encode_workers.setup", "system.index_stream", 7.5)])
def test_each_reads_its_root(monkeypatch, name, root, value):
    asked = _program(monkeypatch, ROOTS)
    assert _reader(name)(RUN) == pytest.approx(value)
    assert asked == [(root, 1)]


@pytest.mark.parametrize("name", ["build_encode_s.setup", "build_seal_s.setup",
                                  "build_tables_s.setup",
                                  "build_encode_workers.setup"])
def test_nothing_without_the_roots(monkeypatch, name):
    """A program without the set-up's roots (the parent of the change that
    added them) reads as nothing, and so does one without the recorder."""
    _program(monkeypatch, {})
    assert _reader(name)(RUN) is None
    from fspann_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "recent")
    assert _reader(name)(RUN) is None


def test_a_device_encode_reads_no_workers(monkeypatch):
    """The probe configuration encodes on the card: its root has the
    ``index.encode`` span and no host encode counters."""
    root = {k: v for k, v in ROOTS["system.index_stream"].items()
            if not k.startswith("index.encode.")}
    _program(monkeypatch, {"system.index_stream": root})
    assert _reader("build_encode_workers.setup")(RUN) is None
    assert _reader("build_encode_s.setup")(RUN) == pytest.approx(2.5)
