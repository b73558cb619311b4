"""The device's timeline over the measured window, from ``torch.profiler``.

The profiler records the device's activity (kernels, copies, fills) only;
its timeline is put on the host's ``perf_counter`` clock by two marker
kernels launched at known host times, one at each end of the window. The
profiler is trusted only where its count of each hand-written kernel's
launches equals the program's own launch counter (``LAUNCHES``) over the
same window, since a profiler window can lose device records.
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
import time
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER_CYCLES = 20000


class DeviceEvent:
    """One device operation on the host clock; ``family`` is its
    ``(source, kernel)`` where it is a hand-written kernel (``label``)."""
    __slots__ = ("name", "t0", "t1", "stream", "kind", "family")

    def __init__(self, name, t0, t1, stream, kind):
        self.name, self.t0, self.t1 = name, t0, t1
        self.stream, self.kind = stream, kind
        self.family = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def kernel_families(root: Path) -> dict:
    """``bench/kernels/<source>.json`` by source name: the ``__global__``
    names of each hand-written CUDA source, and which of them is launched
    once per call of which ``LAUNCHES`` counters."""
    out = {}
    for path in sorted(glob.glob(str(root / "kernels" / "*.json"))):
        spec = json.loads(Path(path).read_text())
        spec["patterns"] = [re.compile(r"\b%s\b" % re.escape(k))
                            for k in spec["kernels"]]
        out[Path(path).stem] = spec
    return out


def family_of(name: str, families: dict):
    """``(source, kernel)`` of a hand-written kernel's event, else None."""
    for src, spec in families.items():
        for k, pat in zip(spec["kernels"], spec["patterns"]):
            if pat.search(name):
                return src, k
    return None


def label(events, families: dict) -> None:
    """Set each kernel event's ``family``, matching each distinct name
    once."""
    seen = {}
    for e in events:
        if e.kind == "kernel":
            if e.name not in seen:
                seen[e.name] = family_of(e.name, families)
            e.family = seen[e.name]


class DeviceTrace:
    """``start`` / ``stop`` around the window; ``events`` after ``stop``."""

    def __init__(self, side_stream=None):
        import torch
        self.torch = torch
        self.side = side_stream
        self.marks = []
        self.events = []
        self.bench_streams = set()
        self.prof = None

    def _mark(self):
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self.marks.append(t)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()
        if self.side is not None:     # names the benchmark's own stream
            with self.torch.cuda.stream(self.side):
                self.torch.cuda._sleep(MARKER_CYCLES)
            self.torch.cuda.synchronize()

    def stop(self):
        self._mark()
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                raw = json.load(fh)["traceEvents"]
        self.prof = None
        dev = [e for e in raw if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATEGORIES]
        dev.sort(key=lambda e: e["ts"])
        d0, d1, host, spins, self.bench_streams = align(
            dev, self.marks[0], self.marks[-1])
        inside = [e for e in dev if d0 <= e["ts"] <= d1
                  and id(e) not in spins]
        self.events = [DeviceEvent(e["name"], host(e["ts"]),
                                   host(e["ts"] + e.get("dur", 0)),
                                   e.get("args", {}).get("stream"),
                                   e["cat"]) for e in inside]
        return self.events


def _stream(e):
    return e.get("args", {}).get("stream")


def align(dev, h0: float, h1: float):
    """``(d0, d1, host, spins, bench_streams)`` of a trace's device events
    (chrome-trace dicts sorted by ``ts``): the window's ends on the
    device's clock, the map from it to the host's ``perf_counter``, the ids
    of the marker kernels, and the benchmark's own streams. The markers are
    the ``spin`` kernels launched at host times h0 and h1 on the program's
    stream (the one holding most kernels). A trace that lost one of the two
    keeps the other, which the program's work on its stream places as the
    start or the end, and maps at the host clock's rate."""
    spins = [e for e in dev
             if e.get("cat") == "kernel" and "spin" in e["name"]]
    if not spins:
        raise RuntimeError("the profiler's trace holds none of the "
                           "window's marker kernels")
    count = {}
    for e in dev:
        if e.get("cat") == "kernel":
            count[_stream(e)] = count.get(_stream(e), 0) + 1
    main = max({_stream(e) for e in spins}, key=lambda s: count[s])
    marks = [e for e in spins if _stream(e) == main]
    ids = {id(e) for e in spins}
    scale = 1.0
    if len(marks) >= 2:
        d0, d1 = marks[0]["ts"], marks[-1]["ts"]
        if d1 > d0:
            scale = (h1 - h0) / ((d1 - d0) * 1e-6)
    else:
        work = [e["ts"] for e in dev
                if _stream(e) == main and id(e) not in ids]
        ts = marks[0]["ts"]
        if not work or ts <= work[len(work) // 2]:
            d0, d1 = ts, ts + (h1 - h0) * 1e6
        else:
            d0, d1 = ts - (h1 - h0) * 1e6, ts

    def host(ts):
        return h0 + (ts - d0) * 1e-6 * scale

    return (d0, d1, host, ids,
            {_stream(e) for e in spins} - {main})


def launch_mismatches(events, families: dict, launches: dict) -> list:
    """Each ``(kernel, traced, counted)`` where the trace's launches of a
    once-a-call kernel differ from the counters' change over the window."""
    traced = {}
    for ev in events:
        if ev.family is not None:
            traced[ev.family[1]] = traced.get(ev.family[1], 0) + 1
    bad = []
    for spec in families.values():
        for kernel, counters in spec["launches"].items():
            counted = sum(launches.get(c, 0) for c in counters)
            if traced.get(kernel, 0) != counted:
                bad.append((kernel, traced.get(kernel, 0), counted))
    return bad


def busy_seconds(events) -> float:
    """Seconds in which some device operation ran: the union of the
    events' intervals."""
    spans = sorted((e.t0, e.t1) for e in events)
    busy, cur0, cur1 = 0.0, None, None
    for t0, t1 in spans:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    return busy


def idle_gaps(events, t0: float, t1: float):
    """The intervals of [t0, t1] in which no device operation ran."""
    gaps, edge = [], t0
    for e in sorted(events, key=lambda e: e.t0):
        if e.t0 > edge:
            gaps.append((edge, e.t0))
        edge = max(edge, e.t1)
    if t1 > edge:
        gaps.append((edge, t1))
    return gaps


def innermost(spans):
    """``(starts, names)``: from ``starts[i]`` on, the innermost open host
    span is ``names[i]`` (None where none is open). The spans, one
    thread's ``(name, t0, t1)``, nest."""
    starts, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            starts.append(end)
            names.append(stack[-1][0] if stack else None)

    for name, t0, t1 in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(t0)
        stack.append((name, t1))
        starts.append(t0)
        names.append(name)
    close_until(float("inf"))
    return starts, names
