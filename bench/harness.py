"""One run of one cell: set-up, the measured window, the check of every
answer, the metrics, and the result's line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name from ``BENCHMARK.json``: ``bench/configs/<config>.json``
(via its ``file``), ``bench/traffic/<traffic>.json`` (data: the entry point
that issues the requests, their seeds and knobs), and
``bench/metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None, and optionally the host ``SPANS`` it needs). What a traffic mix
names is found by name too: its entry point ``bench/entries/<entry>.py``
(``make(...)`` returns ``call(i)``, which issues the window's i-th call and
returns the requests it finished with their parameters), and its
``replay``: the program's stage table ``bench/stages/<replay>.py`` and the
plain replay ``bench/reference/<replay>.py``.
"""
from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GAP_NAMED_S = 1e-3          # idle gaps shorter than this are not named


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_of(man: dict, workload: str):
    """``(cell, config, traffic, end_to_end, per_layer)`` of a workload."""
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((REPO / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(specs):
        return [m for m in specs if workload in m.get("workloads",
                                                       [workload])]
    return (cell, config, traffic, mine(man["end_to_end"]),
            mine(man["per_layer"]))


def load(folder: str, name: str):
    """The module ``bench/<folder>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + "".join(c if c.isalnum() else "_"
                                     for c in name),
        BENCH / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    return load("metrics", name)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


class Request:
    __slots__ = ("wall_s", "trace", "edges", "params", "part", "cut", "t0",
                 "t1")

    def __init__(self, params, res, t0, t1, edges):
        self.wall_s, self.t0, self.t1 = t1 - t0, t0, t1
        self.trace = list(res.trace)
        self.edges = edges
        self.params = params
        self.part = res.assignment
        self.cut = res.cut


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.requests = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.spans = []
        self.events = None
        self.lp_work = []
        self.bal_work = []
        self.slabs = []

    def kernel_seconds(self, source: str, kernels=None) -> float:
        """Device seconds of a hand-written source's kernels (or of the
        named ones among them) in the window."""
        return sum(e.dur for e in self.events or ()
                   if e.family is not None and e.family[0] == source
                   and (kernels is None or e.family[1] in kernels))


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(args, cell, config, traffic, e2e, layer, device, t_start):
    """Set up, measure and check one cell on ``device``; returns the
    result's dict (``metrics`` per the trace flag)."""
    import torch

    from . import graphs
    from .capture import Recorder
    from .reference import check

    cuda = torch.device(device).type == "cuda"

    def stage(name, t):
        say(f"setup {name} {time.perf_counter() - t:.3f} s")
        return time.perf_counter()

    t = stage("torch", t_start)      # the interpreter's start: torch, numpy
    from repro_torch.graphs.format import Graph
    from repro_torch.kernels import _build
    t = stage("import", t)
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t = stage("cuda_init", t)
    if cuda:
        _build.build_all(("lp_move", "seg_merge", "bal_round"))
    t = stage("libraries", t)
    arrays = graphs.make(config, args.seed)
    g = Graph(*arrays)
    edges = g.m // 2
    t = stage("graph", t)

    metrics = [(m, load_metric(m["name"]))
               for m in (layer if args.trace else e2e)]
    spans = [s for _, mod in metrics for s in getattr(mod, "SPANS", ())]
    replay = traffic["replay"]
    table = load("stages", replay).STAGES
    kinds = [kind for kind, *_ in table]
    rec = Recorder(table, tracing=bool(args.trace), span_targets=spans)
    call = load("entries", traffic["entry"]).make(g, config, traffic,
                                                  args.seed, device)
    call(0)
    if cuda:
        torch.cuda.synchronize()
    t = stage("warm", t)
    run = Run()
    run.setup_s = time.perf_counter() - t_start
    say(f"setup total {run.setup_s:.3f} s")

    # ---- the window -------------------------------------------------------
    sample = int(np.random.default_rng([args.seed, 1]).integers(0, 2))
    for lst in (rec.records, rec.lp_work, rec.bal_work, rec.slabs,
                rec.spans):
        lst.clear()
    before = dict(_build.LAUNCHES)
    dtrace = None
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if args.trace:
            from .devtrace import DeviceTrace
            dtrace = DeviceTrace(rec._side)
            dtrace.start()
    failed = 0
    done = None
    sampled = None      # the sampled call's first request
    cpu0 = sum(os.times()[:2])
    t0 = time.perf_counter()
    t1 = t0
    i = 0
    while True:
        rec.request, rec.sampled = i, i == sample
        ts = time.perf_counter()
        try:
            with rec.span("request"):
                done = call(i)
                if cuda:
                    torch.cuda.synchronize()
        except Exception:    # a call that fails ends the window
            traceback.print_exc()
            failed += 1
            t1 = time.perf_counter()
            break
        t1 = time.perf_counter()
        if i == sample:
            sampled = len(run.requests)
        run.requests.extend(Request(p, r, ts, t1, edges) for p, r in done)
        i += 1
        if t1 - t0 >= args.seconds:
            break
    rec.sampled = False
    run.window_s = t1 - t0
    cpu_s = sum(os.times()[:2]) - cpu0
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
        peak_all = max(setup_peak, run.peak_bytes)
    else:
        peak_all = 0
    launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    if dtrace is not None:
        from .devtrace import kernel_families, label, launch_mismatches
        t_read = time.perf_counter()
        events = dtrace.stop()
        run.events = [e for e in events if e.stream not in
                      dtrace.bench_streams]
        families = kernel_families(BENCH)
        label(run.events, families)
        say(f"trace read {time.perf_counter() - t_read:.3f} s, "
            f"{len(run.events)} device operations")
        bad = launch_mismatches(run.events, families, launches)
        if bad:
            raise SystemExit(
                "the profiler's trace does not hold every launch of the "
                "window, so its device times cannot be trusted: " +
                ", ".join(f"{k} traced {a}, counted {b}" for k, a, b in bad))
    run.spans = list(rec.spans)
    run.lp_work = list(rec.lp_work)
    run.bal_work = rec.work_counts() if args.trace else []
    run.slabs = list(rec.slabs)
    rec.restore()
    say(f"window {run.window_s:.3f} s ({cpu_s:.1f} s of the process's "
        f"CPU time), {len(run.requests)} requests, {failed} failed; walls " + json.dumps(
            [round(r.wall_s, 4) for r in run.requests]) + "; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))

    # ---- correctness, after the window ------------------------------------
    t_check = time.perf_counter()
    counts = dict(ids=0, overload=0, cut_gap=0, answer_diff=0)
    for r in run.requests:
        for k, v in check.answer(arrays, r.part, int(config["k"]),
                                 float(config["epsilon"]), r.cut).items():
            counts[k] += v
    del done
    if cuda:
        torch.cuda.empty_cache()
    if sampled is not None and sampled < len(run.requests):
        mine = run.requests[sampled]
        theirs, ref_stages = check.replay(replay, arrays, mine.params,
                                          device)
        counts["answer_diff"] = check.diff(mine.part, theirs)
        counts.update(check.stages(kinds, rec.records, ref_stages))
    else:
        counts["answer_diff"] = g.n
        counts.update(check.stages(kinds, [], []))
    say(f"check {time.perf_counter() - t_check:.3f} s over "
        f"{len(run.requests)} answers and the replay of call {sample} "
        f"({len(rec.records)} stages)")
    correct = failed == 0 and bool(run.requests) and \
        all(v <= 0 for v in counts.values())

    out = {"correct": correct, "attempted": len(run.requests) + failed,
           "failed": failed, "metrics": {}}
    if run.requests:
        for spec, mod in metrics:
            v = mod.read(run)
            if v is not None:
                out["metrics"][spec["name"]] = {"value": float(v),
                                                "unit": spec["unit"]}
    out["device"] = device_record(torch, device, cell["chips"], peak_all)
    if dtrace is not None and run.requests:
        from .devtrace import busy_seconds
        out["breakdown"] = breakdown(run)
        out["device"].update(busy_s=busy_seconds(run.events),
                             window_s=run.window_s)
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    return out


def device_record(torch, device, chips, peak) -> dict:
    from .roofline import power_limit
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": int(chips), "memory_peak_bytes": int(peak),
            "power": power_limit()}


def breakdown(run) -> dict:
    """The ten device operations that took most time, and the host spans
    that held the longest idle stretches of the device."""
    from .devtrace import idle_gaps, innermost
    by_op = {}
    for e in run.events:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.dur
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    starts, names = innermost(run.spans)
    held = {}
    for a, b in idle_gaps(run.events, run.requests[0].t0,
                          run.requests[-1].t1):
        if b - a < GAP_NAMED_S:
            name = "(short gaps)"
        else:
            j = bisect.bisect_right(starts, 0.5 * (a + b)) - 1
            name = (names[j] if j >= 0 else None) or "(no span)"
        held[name] = held.get(name, 0.0) + (b - a)
    gaps = sorted(held.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    man = manifest()
    cell, config, traffic, e2e, layer = cell_of(man, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        say(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}: no result")
        return 2
    out = run_cell(args, cell, config, traffic, e2e, layer, "cuda", t_start)
    found = forbidden_modules()
    if found:
        say("modules of JAX or of the JAX package were loaded: "
            + ", ".join(found) + ": no result")
        return 3
    for k, v in out["checks"].items():
        say(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(out), flush=True)
    return 0
