"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration in ``configs/<config>.json``, the traffic mix in
``traffic/<mix>.json``, each metric's reader in ``metrics/<metric>.py`` and
the configuration's plain reference in ``references/<name>.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import compare, corpus, trace as trace_mod, traffic as traffic_mod

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 2048          # served queries compared with the reference
# the profiler covers the window's first whole cycles up to this many
# seconds: the reading of a longer trace of single queries alone would
# take minutes
TRACE_SECONDS = 10.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str):
    spec = importlib.util.spec_from_file_location(
        "bench_torch._" + os.path.basename(path)[:-3].replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int = 1

    @staticmethod
    def find(root: str, workload: str) -> "Cell":
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        w = cells[workload]
        cfg = load_json(os.path.join(HERE, "configs", f"{w['config']}.json"))
        mix = traffic_mod.load(root, w["traffic"])

        def mine(ms):
            return [m for m in ms
                    if workload in m.get("workloads", [workload])]

        return Cell(workload, cfg, mix, mine(bench["end_to_end"]),
                    mine(bench["per_layer"]), w["chips"])


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where the run has nothing to read)."""

    cell: Cell
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    queries: int = 0
    inserted_rows: int = 0
    insert_ms: list = dataclasses.field(default_factory=list)
    latencies_ms: list = dataclasses.field(default_factory=list)
    stats: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: trace_mod.Trace | None = None
    route_calls: list = dataclasses.field(default_factory=list)
    route_event_ms: float | None = None
    rerank_calls: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.cell.traffic["requests"]

    @property
    def program(self) -> dict:
        return self.cell.config["program"]

    def note(self, msg: str) -> None:
        self.notes.append(msg)


def system_config(program: dict):
    """The program's ``SystemConfig`` from a configuration's ``program``
    block: its defaults with the ``paper`` and ``runtime`` fields given."""
    from fspann_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    return dataclasses.replace(
        cfg, paper=dataclasses.replace(cfg.paper, **program["paper"]),
        runtime=dataclasses.replace(cfg.runtime, **program["runtime"])
    ).validate()


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Instruments:
    """The traced run's spans around calls into the program's layers, on
    this run's own objects, and the counts the rooflines need.  Patches
    are undone by :meth:`close`."""

    def __init__(self, system, run: Run):
        self._undo = []
        self.run = run
        cuda = run.device.type == "cuda"
        idx = system.index
        route = idx.route_batch
        pp = system.cfg.paper
        bits = pp.num_groups * pp.code_bits     # the whole code
        self.events = []
        # counts are taken while the profiler runs
        self.active = True

        def route_batch(qcodes, *a, **kw):
            if not self.active:
                return route(qcodes, *a, **kw)
            limit = min(idx.cfg.runtime.effective_refinement(), idx._n_rows)
            run.route_calls.append((len(qcodes), idx._n_rows, bits, limit))
            ev = None
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with record_function("bench.route_batch"):
                out = route(qcodes, *a, **kw)
            if ev is not None:
                ev[1].record()
                self.events.append(ev)
            return out

        self._set(idx, "route_batch", route_batch)
        self._span(system.store, "load_score_batch", "bench.decrypt")
        self._span(system.store, "load_decrypt_batch", "bench.decrypt")
        self._span(system.tokens, "create_batch", "bench.create_batch")
        from fspann_tpu_torch.ops import refine as refine_mod
        from fspann_tpu_torch.ops import routing as routing_mod

        self._span(refine_mod, "refine", "bench.refine")
        hamming = routing_mod.code_hamming

        def code_hamming(pc, qcodes, ids, *a, **kw):
            if not self.active:
                return hamming(pc, qcodes, ids, *a, **kw)
            n, words = pc.shape[0], pc.shape[1] if pc.dim() == 2 else \
                int(np.prod(pc.shape[1:]))
            where = torch.where((ids >= 0) & (ids < n), ids,
                                torch.full_like(ids, n)).reshape(-1).long()
            seen = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
            seen[where] = True
            run.rerank_calls.append((seen[:n].sum(), words, qcodes.numel(),
                                     ids.numel()))
            with record_function("bench.code_hamming"):
                return hamming(pc, qcodes, ids, *a, **kw)

        self._set(routing_mod, "code_hamming", code_hamming)

    def _set(self, obj, attr, fn):
        had = attr in vars(obj)
        old = getattr(obj, attr)
        self._undo.append((obj, attr, old, had))
        setattr(obj, attr, fn)

    def _span(self, obj, attr, name):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)

        self._set(obj, attr, wrapped)

    def close(self) -> None:
        if self.events:
            torch.cuda.synchronize()
            self.run.route_event_ms = sum(a.elapsed_time(b)
                                          for a, b in self.events)
        self.run.rerank_calls = [(int(d), w, q, i)
                                 for d, w, q, i in self.run.rerank_calls]
        for obj, attr, old, had in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo.clear()


class Served:
    """Every answer of the window, with what is needed to check it."""

    def __init__(self, k: int):
        self.k = k
        self.queries, self.ids, self.dists, self.live = [], [], [], []

    def add(self, queries, ids, dists, live: int) -> None:
        self.queries.append(np.asarray(queries, np.float32))
        self.ids.append(np.asarray(ids, np.int64))
        self.dists.append(np.asarray(dists, np.float32))
        self.live.append(np.full(len(ids), live, np.int64))

    def arrays(self):
        return (np.concatenate(self.queries), np.concatenate(self.ids),
                np.concatenate(self.dists), np.concatenate(self.live))


def _single_arrays(results, k: int):
    ids = np.full(k, -1, np.int64)
    dists = np.full(k, np.inf, np.float32)
    for j, r in enumerate(results[:k]):
        ids[j], dists[j] = r.id, r.distance
    return ids, dists


def _cycle(system, gen: traffic_mod.Generator, run: Run, served: Served,
           span, warmup: bool = False) -> None:
    """One cycle of the mix: the insert, then the requests."""
    spec = gen.spec
    ins = gen.insert()
    if ins is not None:
        t0 = time.perf_counter()
        with span("bench.insert_live"):
            system.insert_live(*ins)
        ms = (time.perf_counter() - t0) * 1e3
        if not warmup:
            run.insert_ms.append(ms)
            run.inserted_rows += len(ins[0])
    live = len(gen.rows)
    k, b = spec["top_k"], spec["batch"]
    calls = 1 if warmup else spec["calls"]
    if spec["requests"] == "batch":
        q = gen.queries(b * calls, warmup)
        toks = [system.tokens.create_batch(q[s:s + b], k)
                for s in range(0, len(q), b)]
        with span("bench.search_batches"):
            res = system.query_service.search_batches(toks)
        if warmup:
            return
        for j, r in enumerate(res):
            served.add(q[j * b:(j + 1) * b], r.ids, r.distances, live)
            run.stats.extend(r.stats)
        run.queries += len(q)
        return
    q = gen.queries(calls, warmup)
    for qi in q:
        t0 = time.perf_counter()
        tok = system.create_token(qi, k)
        with span("bench.search"):
            got = system.search(tok)
        ms = (time.perf_counter() - t0) * 1e3
        if warmup:
            continue
        run.latencies_ms.append(ms)
        run.stats.extend(system.query_service.last_stats)
        ids, dists = _single_arrays(got, k)
        served.add(qi[None], ids[None], dists[None], live)
        run.queries += 1


def _read_metrics(run: Run, specs: list) -> dict:
    out = {}
    for m in specs:
        reader = _module(os.path.join(HERE, "metrics", f"{m['name']}.py"))
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _check(run: Run, served: Served, rows: np.ndarray, seed: int,
           device) -> tuple[bool, int, dict]:
    """(correct, failed requests, checks) of the window's answers."""
    cfg = run.cell.config
    k = served.k
    queries, ids, dists, live = served.arrays()
    bad = compare.malformed(ids, dists, live, k)
    failed = int(bad.sum())
    rng = corpus.stream_rng(seed, corpus.SAMPLE)
    pick = np.sort(rng.choice(len(ids), min(SAMPLE, len(ids)),
                              replace=False))
    ref = _module(os.path.join(HERE, "references",
                               f"{cfg['reference']}.py"))
    t0 = time.perf_counter()
    stored = ref.stored_rows(
        rows, cfg["program"]["runtime"]["storage_dtype"], device)
    ref_ids, ref_d = ref.topk(stored, queries[pick], live[pick], k)
    served_ref_d = ref.distances(stored, queries[pick], ids[pick])
    del stored
    new_from = run.cell.config["corpus"]["n"] + run.cell.traffic.get(
        "insert_rows", 0) if run.inserted_rows else None
    values = compare.numbers(ids[pick], dists[pick], served_ref_d, ref_ids,
                             ref_d, new_from)
    values["failed"] = failed
    limits = {"failed": {"max": 0}, **cfg["limits"]}
    if new_from is None:
        limits.pop("recall10_new", None)
    correct, checks = compare.judge(values, limits)
    log(f"reference: {len(pick)} of {len(ids)} served queries compared "
        f"against exact top-{k} in {time.perf_counter() - t0:.2f} s")
    return correct, failed, checks


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, t_cuda: float,
             control: bool = False, overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``control`` serves with
    the configuration's ``control`` block applied (its lower precision);
    ``overrides`` and ``traffic_overrides`` replace keys of the
    configuration's ``corpus`` block and of the mix (tests run the harness
    at a small size)."""
    from fspann_tpu_torch.api.system import ForwardSecureANNSystem

    device = torch.device(device)
    cell = Cell.find(root, workload)
    cfg = cell.config
    if overrides:
        cfg["corpus"] = {**cfg["corpus"], **overrides}
    if traffic_overrides:
        cell.traffic.update(traffic_overrides)
    program = cfg["program"]
    if control:
        ctl = cfg["control"]
        program = {**program,
                   "paper": {**program["paper"], **ctl.get("paper", {})},
                   "runtime": {**program["runtime"], **ctl.get("runtime", {})}}
    run = Run(cell, device)
    cuda = device.type == "cuda"
    log(f"cell {workload}: config {cell.config['name']}, seed {seed}, "
        f"window {seconds} s, trace {int(traced)}, control {int(control)}; "
        f"{power_line() if cuda else 'cpu'}")
    log(f"host: {len(os.sched_getaffinity(0))} cpus usable, load "
        f"{' '.join(open('/proc/loadavg').read().split()[:3])}")

    t0 = time.perf_counter()
    mix = corpus.mixture(cfg["corpus"])
    base, cluster = corpus.base_rows(mix, seed, device)
    rows = traffic_mod.Rows(base, cluster)
    gen = traffic_mod.Generator(cell.traffic, mix, rows, seed)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_corpus = time.perf_counter() - t0

    work = tempfile.TemporaryDirectory(prefix="fspann_bench_")
    system = ForwardSecureANNSystem(system_config(program),
                                    os.path.join(work.name, "db"), mix.d,
                                    query_batch=program["query_batch"],
                                    device=device)
    t0 = time.perf_counter()
    system.index_stream(base, batch_size=program["ingest_batch"])
    t_insert = time.perf_counter() - t0
    t0 = time.perf_counter()
    system.finalize_for_search()
    t_final = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in system.index.finalize_sec.items()}

    served = Served(cell.traffic["top_k"])
    inst = Instruments(system, run) if traced else None
    span = record_function if traced else (lambda name:
                                           contextlib.nullcontext())
    t0 = time.perf_counter()
    _cycle(system, gen, run, served, span, warmup=True)
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    run.route_calls.clear()
    run.rerank_calls.clear()
    if inst is not None:
        inst.events.clear()
    hits0 = system.metrics.counters.get("query.cache_hits", 0)

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t_win = time.perf_counter()
    run.setup_s = t_win - t_start
    traced_s = None
    cycles = []
    while time.perf_counter() - t_win < seconds:
        t0 = time.perf_counter()
        _cycle(system, gen, run, served, span)
        cycles.append(time.perf_counter() - t0)
        if prof is not None and traced_s is None \
                and time.perf_counter() - t_win >= TRACE_SECONDS:
            if cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            traced_s = time.perf_counter() - t_win
            inst.active = False
            traced_q = run.queries
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t_win
    if prof is not None and traced_s is None:
        prof.__exit__(None, None, None)
        traced_s, traced_q = run.window_s, run.queries
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    hits = system.metrics.counters.get("query.cache_hits", 0) - hits0
    if inst is not None:
        inst.close()
        t0 = time.perf_counter()
        run.trace = trace_mod.summarize(prof.events(), traced_s)
        rest_s = max(run.window_s - traced_s, 1e-9)
        log(f"trace read in {time.perf_counter() - t0:.1f} s; traced "
            f"{traced_s:.3f} s of the window: {traced_q} queries, "
            f"{traced_q / traced_s:.4f} a second; untraced after it: "
            f"{(run.queries - traced_q) / rest_s:.4f} a second")
        del prof

    log(f"setup {run.setup_s:.3f} s: process and CUDA start "
        f"{t_cuda - t_start:.3f}, corpus {t_corpus:.3f}, index_stream "
        f"{t_insert:.3f}, finalize {t_final:.3f} {stages}, warm-up "
        f"{t_warm:.3f}")
    log(f"window {run.window_s:.3f} s: {run.queries} queries, "
        f"{len(run.insert_ms)} inserts of {run.inserted_rows} rows, "
        f"query cache hits {hits:.0f}")
    cq = np.percentile(cycles, [0, 25, 50, 75, 100])
    half = len(cycles) // 2
    log(f"cycles: {len(cycles)}, seconds min/q1/median/q3/max "
        f"{' '.join(f'{v:.4f}' for v in cq)}; first half "
        f"{sum(cycles[:half]):.3f} s, second half {sum(cycles[half:]):.3f} s "
        f"of {half} and {len(cycles) - half}")
    if run.stats:
        log("per query: " + ", ".join(
            f"{f} {np.mean([getattr(x, f) for x in run.stats]) / d:.4f}"
            for f, d in (("route_ns", 1e6), ("decrypt_ns", 1e6),
                         ("refine_ns", 1e6), ("cand_decrypted", 1))))
    if run.insert_ms:
        ins = np.percentile(run.insert_ms, [0, 50, 100])
        log(f"insert_live ms min/median/max {ins[0]:.1f} {ins[1]:.1f} "
            f"{ins[2]:.1f}")
    if run.latencies_ms:
        lat = np.asarray(run.latencies_ms)
        log(f"latency over {len(lat)} queries: median "
            f"{np.median(lat):.4f} ms, p95 {np.percentile(lat, 95):.4f} ms")
    metrics = _read_metrics(run, cell.per_layer if traced
                            else cell.end_to_end)
    for msg in run.notes:
        log(msg)
    disk = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(work.name) for f in fs)
    log(f"store on disk at the window's end: {disk / 2**20:.1f} MiB")

    # the program's state goes before the reference runs on the card
    system.store.close()
    del system, inst
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, failed, checks = _check(run, served, rows.all(), seed, device)
    work.cleanup()

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": bool(correct),
           "attempted": run.queries + len(run.insert_ms),
           "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']}) "
            f"{'ok' if c['pass'] else 'FAILED'}")
    out["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                     for n, c in checks.items()}
    return out
