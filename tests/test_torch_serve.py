"""repro_torch's serving tier against the JAX package's, on the same
traffic (requests carried across with
``repro_torch.carry.request_from_fields``): the scheduler, the admission
queue and the metrics as pure functions on the same inputs through both
packages; ``PartitionServer`` bit-identical to solo runs of both
packages under concurrency, batching and coalescing; its failure paths
(worker exception and retry, deadline, kill, overload, close), the
quality downgrade at admission, what it does not port
(``devices_per_mesh > 1``) and its CUDA default; the serve CLI against
the reference CLI. Workers are single-device sessions on the CPU here
(``device="cpu"``); the ``gpu`` test serves a batch on the card.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as ref_api  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro.api.backends import required_devices as ref_required  # noqa: E402
from repro.core import PartitionerConfig as RefConfig  # noqa: E402
from repro.serve import metrics as ref_metrics  # noqa: E402
from repro.serve import scheduler as ref_scheduler  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve import (AdmissionQueue, PartitionServer,  # noqa: E402
                               ServeMetrics, Ticket, pick_worker)
from repro_torch.serve import metrics as serve_metrics  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
REF_CFG = RefConfig(contraction_limit=128, ip_repetitions=2, num_chunks=4)


def port(req):
    """The port's request with the reference request's fields."""
    return carry.request_from_fields(
        {f.name: getattr(req, f.name) for f in dataclasses.fields(req)})


def mixed_ref_requests(count=8, base_n=700):
    return [ref_api.PartitionRequest(
        graph=ref_api.GraphSpec("rgg2d", base_n * (1 + i % 3), 8.0,
                                seed=5 + i % 2),
        k=2 * (1 + i % 2), config=REF_CFG, backend="single")
        for i in range(count)]


def mixed_requests(count=8, base_n=700):
    return [port(r) for r in mixed_ref_requests(count, base_n)]


_SOLO = {}


def solo_runs(ref_reqs):
    """(port solo, reference solo) results of each request, one run per
    distinct request for the whole module."""
    out = []
    for r in ref_reqs:
        key = tuple((f.name, getattr(r, f.name))
                    for f in dataclasses.fields(r))
        if key not in _SOLO:
            _SOLO[key] = (api.Partitioner(device=CPU).run(port(r)),
                          ref_api.Partitioner().run(r))
        out.append(_SOLO[key])
    return out


def server(**kw):
    return PartitionServer(device=CPU, **kw)


@pytest.fixture
def temp_backend():
    names = []

    def register(name, fn):
        backends.register_backend(name, fn)
        names.append(name)

    yield register
    for name in names:
        backends._REGISTRY.pop(name, None)


# ---------------------------------------------------------------------------
# scheduler policy (pure): the same candidates through both packages
# ---------------------------------------------------------------------------

def W(wid, devices, inflight=0):
    return SimpleNamespace(wid=wid, devices=devices, inflight=inflight)


SCHED_CASES = [
    (2, [W(0, 8), W(1, 2), W(2, 4)], 1), (4, [W(0, 8), W(1, 2), W(2, 4)], 2),
    (8, [W(0, 8), W(1, 2), W(2, 4)], 0), (2, [W(0, 8), W(1, 4)], 1),
    (16, [W(0, 8), W(1, 4)], 0), (1, [W(0, 1, inflight=1), W(1, 1)], 1),
    (1, [W(0, 1), W(1, 1)], 0), (1, [], None),
]


@pytest.mark.parametrize("need,cands,want", SCHED_CASES)
def test_scheduler_matches_reference(need, cands, want):
    got = pick_worker(need, cands)
    ref = ref_scheduler.pick_worker(need, cands)
    assert (got and got.wid) == (ref and ref.wid)
    assert (None if got is None else got.wid) == want
    for w in cands:
        assert scheduler.rank(need, w.devices, w.inflight, w.wid) == \
            ref_scheduler.rank(need, w.devices, w.inflight, w.wid)
    servers = [SimpleNamespace(sid=f"s{w.wid}", devices=w.devices,
                               inflight=w.inflight) for w in cands]
    a = scheduler.pick_server(need, servers)
    b = ref_scheduler.pick_server(need, servers)
    assert (a and a.sid) == (b and b.sid)


def test_required_devices_matches_reference():
    for kw, n in [(dict(), 50000), (dict(devices=4), 50000),
                  (dict(devices=4), 100),
                  (dict(backend="single", devices=4), 50000),
                  (dict(devices=16), 50000)]:
        r = ref_api.PartitionRequest(graph=ref_api.GraphSpec("rgg2d", 50000),
                                     k=4, **kw)
        assert backends.required_devices(port(r), n) == ref_required(r, n)


# ---------------------------------------------------------------------------
# admission queue (pure): the same operations on both packages' queues
# ---------------------------------------------------------------------------

QUEUES = [(AdmissionQueue, Ticket),
          (ref_serve.AdmissionQueue, ref_serve.Ticket)]


def make_ticket(cls, priority, seq, deadline=None):
    return cls(request=None, priority=priority, seq=seq, future=Future(),
               submit_t=time.monotonic(), deadline=deadline)


def queue_script(Q, T):
    """Priority order, requeue, capacity, close, drain and pop_batch on
    one queue class; returns what each step gave."""
    out = []
    q = Q(capacity=8)
    for prio, seq in [(1, 0), (0, 1), (1, 2), (0, 3)]:
        out.append(q.put(make_ticket(T, prio, seq)))
    out.append([(t.priority, t.seq) for t in (q.pop() for _ in range(4))])
    first = make_ticket(T, 0, 0)
    q.put(first)
    q.put(make_ticket(T, 0, 1))
    t = q.pop()
    out += [t is first, q.requeue(t), q.pop() is first]
    q = Q(capacity=2)
    out += [q.put(make_ticket(T, 0, 0)), q.put(make_ticket(T, 0, 1)),
            q.put(make_ticket(T, 0, 2)), q.requeue(make_ticket(T, 0, 3))]
    q.close()
    out += [q.put(make_ticket(T, 0, 4)), len(q.drain()), q.depth()]
    q = Q(capacity=16)
    for seq in range(5):
        q.put(make_ticket(T, seq % 2, seq))
    pick = (lambda t: t.priority == 0)
    out.append([(t.priority, t.seq) for t in q.pop_batch(pick, limit=2)])
    out.append([(t.priority, t.seq) for t in q.pop_batch(pick, limit=5)])
    out.append(q.depth())
    return out


def test_queue_operations_match_reference():
    got, want = (queue_script(Q, T) for Q, T in QUEUES)
    assert got == want
    assert got[4] == [(0, 1), (0, 3), (1, 0), (1, 2)]
    assert got[-3:] == [[(0, 0), (0, 2)], [(0, 4)], 2]


def test_pop_matching_order_matches_reference_queue():
    rng = random.Random(42)
    for trial in range(20):
        keys = [(rng.randrange(4), seq)
                for seq in range(rng.randrange(1, 40))]
        order = list(range(len(keys)))
        rng.shuffle(order)
        pred = (lambda t: True) if trial % 2 else \
            (lambda t: t.seq % 3 != 0)
        drained = []
        for Q, T in QUEUES:
            q = Q(capacity=64)
            for i in order:
                q.put(make_ticket(T, *keys[i]))
            got = [(t.priority, t.seq) for t in iter(
                lambda: q.pop_matching(pred), None)]
            rest = [(t.priority, t.seq) for t in iter(
                lambda: q.pop_matching(lambda _: True), None)]
            drained.append((got, rest))
        assert drained[0] == drained[1]
        assert drained[0][0] == sorted(k for k in keys
                                       if pred(SimpleNamespace(seq=k[1])))


def test_queue_pop_survives_spurious_wakeup():
    q = AdmissionQueue(capacity=8)
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop(timeout=5.0)))
    t.start()
    time.sleep(0.05)
    with q._cond:
        q._cond.notify_all()            # wake with an empty heap
    time.sleep(0.05)
    assert not got, "waiter returned early on a spurious wakeup"
    ticket = make_ticket(Ticket, 0, 0)
    assert q.put(ticket)
    t.join(timeout=5)
    assert not t.is_alive() and got == [ticket]


def test_queue_two_consumers_no_starvation():
    q = AdmissionQueue(capacity=64)
    got, lock = [], threading.Lock()

    def consume():
        while True:
            t = q.pop(timeout=10.0)
            if t is None:
                return
            with lock:
                got.append(t.seq)

    threads = [threading.Thread(target=consume) for _ in range(2)]
    for t in threads:
        t.start()
    for seq in range(20):
        q.put(make_ticket(Ticket, 0, seq))
        time.sleep(0.002)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with lock:
            if len(got) == 20:
                break
        time.sleep(0.01)
    q.close()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(20))


def test_queue_pop_closed_drained_and_lingering_pop_batch():
    q = AdmissionQueue(capacity=8)
    ticket = make_ticket(Ticket, 0, 0)
    q.put(ticket)
    q.close()
    assert q.pop(timeout=5.0) is ticket
    t0 = time.monotonic()
    assert q.pop(timeout=30.0) is None
    assert time.monotonic() - t0 < 1.0
    q = AdmissionQueue(capacity=8)
    late = make_ticket(Ticket, 0, 9)
    timer = threading.Timer(0.05, lambda: q.put(late))
    timer.start()
    assert q.pop_batch(lambda t: t.priority == 0, limit=1,
                       window_s=5.0) == [late]
    timer.join(timeout=5)


def test_ticket_deadline():
    now = time.monotonic()
    assert make_ticket(Ticket, 0, 0, deadline=now - 1).expired()
    t2 = make_ticket(Ticket, 0, 0, deadline=now + 60)
    assert not t2.expired() and 0 < t2.remaining() <= 60
    assert make_ticket(Ticket, 0, 0).remaining() is None


# ---------------------------------------------------------------------------
# metrics (pure): the same samples through both packages
# ---------------------------------------------------------------------------

def test_percentile_matches_reference():
    rng = np.random.default_rng(3)
    cases = [[], [7.0], [1.0, 2.0], [1.0, 2.0, 3.0],
             [float(i) for i in range(1, 101)],
             [float(i) for i in range(1, 102)]]
    cases += [sorted(rng.random(int(rng.integers(1, 300))).tolist())
              for _ in range(10)]
    for xs in cases:
        for p in (0, 1, 25, 50, 75, 90, 99, 99.9, 100):
            assert serve_metrics.percentile(xs, p) == \
                ref_metrics.percentile(xs, p)
    xs101 = [float(i) for i in range(1, 102)]
    assert serve_metrics.percentile(xs101, 50) == 51.0
    assert serve_metrics.percentile(xs101, 99) == 100.0


def metrics_script(cls):
    m = cls(2)
    m.on_submit(3)
    m.on_done(True, 0.5, 0.1, worker=1)
    m.on_batch(4, 2)
    snaps = [m.snapshot(), m.snapshot_window()]
    for i in range(40):
        m.on_submit(i % 7)
        m.on_dispatch(i % 5)
        if i % 9 == 0:
            m.on_retry()
        if i % 11 == 0:
            m.on_reject()
        if i % 13 == 0:
            m.on_downgrade()
        m.on_done(i % 6 != 0, 0.01 * i, 0.001 * i, worker=i % 3,
                  expired=i % 12 == 0)
    m.on_batch(3, 3)
    m.resize_workers(5)
    snaps += [m.snapshot(), m.snapshot_window(), m.snapshot_window()]
    return snaps


def test_serve_metrics_match_reference():
    got, want = metrics_script(ServeMetrics), metrics_script(
        ref_serve.ServeMetrics)
    assert got == want
    first = got[0]
    assert first["submitted"] == first["completed"] == 1
    assert first["per_worker_served"] == [0, 1]
    assert first["queue_depth_max"] == 3
    assert (first["batches"], first["coalesced"],
            first["batch_size_max"]) == (1, 2, 4)


# ---------------------------------------------------------------------------
# server: bit-identity under concurrency, batching and coalescing
# ---------------------------------------------------------------------------

def test_concurrent_mixed_batch_matches_solo_and_reference():
    ref_reqs = mixed_ref_requests(8)
    solo = solo_runs(ref_reqs)
    with server(meshes=2) as srv:
        results = srv.serve([port(r) for r in ref_reqs])
        stats = srv.stats()
    for r, (s, ref) in zip(results, solo):
        assert r.ok and r.error is None
        np.testing.assert_array_equal(r.result.assignment, s.assignment)
        np.testing.assert_array_equal(r.result.assignment, ref.assignment)
        assert r.result.cut == s.cut == ref.cut
    assert stats["completed"] == len(ref_reqs)
    assert sum(stats["per_worker_served"]) == len(ref_reqs)
    assert all(c > 0 for c in stats["per_worker_served"])


def test_graph_cache_shared_across_workers():
    spec = api.GraphSpec("rgg2d", 900, 8.0, seed=9)
    cfg = carry.config_from_dict(dataclasses.asdict(REF_CFG))
    reqs = [api.PartitionRequest(graph=spec, k=k, config=cfg,
                                 backend="single") for k in (2, 3, 4, 5)]
    with server(meshes=2) as srv:
        results = srv.serve(reqs)
        assert len(srv._graph_cache) == 1
    assert all(r.ok for r in results)


def _hold_until_inflight(srv, wid):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and srv.workers[wid].inflight == 0:
        time.sleep(0.01)


@pytest.mark.parametrize("stack", ["on", "off"])
def test_batched_dispatch_coalesces_and_matches_solo(stack):
    ref_distinct = [ref_api.PartitionRequest(
        graph=ref_api.GraphSpec("rgg2d", 600, 8.0, seed=s), k=4,
        config=REF_CFG, backend="single") for s in (1, 2, 3)]
    solo = solo_runs(ref_distinct)
    reqs = [port(ref_distinct[i % 3]) for i in range(12)]
    with server(meshes=1, batch_max=8, batch_window_ms=50.0,
                stack=stack) as srv:
        srv.workers[0].hold()
        futs = [srv.submit(r) for r in reqs]
        _hold_until_inflight(srv, 0)
        srv.workers[0].release()
        results = [f.result(timeout=300) for f in futs]
        stats = srv.stats()
    for i, r in enumerate(results):
        assert r.ok, r.error
        s, ref = solo[i % 3]
        np.testing.assert_array_equal(r.result.assignment, s.assignment)
        np.testing.assert_array_equal(r.result.assignment, ref.assignment)
    assert stats["completed"] == len(reqs)
    assert stats["batches"] >= 1, "burst never dispatched as a batch"
    assert stats["coalesced"] >= 1 and stats["batch_size_max"] >= 2


def test_batching_disabled_keeps_solo_dispatch():
    with server(meshes=1, batch_max=1) as srv:
        results = srv.serve(mixed_requests(4, base_n=400))
        stats = srv.stats()
    assert all(r.ok for r in results) and stats["batches"] == 0


@pytest.mark.parametrize("kw", [
    dict(batch_max=0), dict(batch_window_ms=-1.0), dict(meshes=0),
    dict(devices_per_mesh=0), dict(max_retries=-1),
    dict(max_inflight_per_worker=0),
])
def test_server_rejects_bad_construction(kw):
    with pytest.raises(ValueError):
        server(**kw)


def test_multi_device_meshes_raise_naming_the_distributed_item():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        server(meshes=2, devices_per_mesh=2)


def test_server_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartitionServer(meshes=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.PartitionSession()


# ---------------------------------------------------------------------------
# server: quality routing and failure paths
# ---------------------------------------------------------------------------

def test_quality_best_with_deadline_is_downgraded_to_fast():
    base = ref_api.PartitionRequest(
        graph=ref_api.GraphSpec("rgg2d", 700, 8.0, seed=5), k=4,
        config=REF_CFG, backend="single")
    best = dataclasses.replace(base, quality="best")
    fast = dataclasses.replace(base, quality="fast")
    (s_fast, r_fast), (s_best, _) = solo_runs([fast, best])
    with server(meshes=1) as srv:
        down = srv.submit(port(best), deadline_s=600).result(timeout=300)
        kept = srv.submit(port(best)).result(timeout=300)
        explicit = srv.submit(dataclasses.replace(
            port(best), refine="unconstrained"), deadline_s=600
        ).result(timeout=300)
        stats = srv.stats()
    assert down.ok and kept.ok and explicit.ok
    assert stats["downgraded"] == 1
    assert down.result.request.quality == "fast"
    np.testing.assert_array_equal(down.result.assignment, s_fast.assignment)
    np.testing.assert_array_equal(down.result.assignment, r_fast.assignment)
    np.testing.assert_array_equal(kept.result.assignment, s_best.assignment)


def test_worker_exception_retries_then_structured_error(temp_backend):
    calls = []

    def boom(g, req, ctx):
        calls.append(1)
        raise RuntimeError("kaboom")

    temp_backend("serve-torch-boom", boom)
    bad = api.PartitionRequest(graph=api.GraphSpec("rgg2d", 400), k=2,
                               backend="serve-torch-boom")
    with server(meshes=2) as srv:
        res = srv.serve([bad])[0]
        assert not res.ok and res.error == "worker_failed"
        assert res.attempts == 2 and "kaboom" in res.detail
        assert len(calls) == 2
        stats = srv.stats()
        assert stats["retried"] == 1 and stats["failed"] == 1
        assert srv.serve(mixed_requests(1))[0].ok


def test_deadline_expiry_returns_structured_error():
    reqs = mixed_requests(1)
    with server(meshes=2) as srv:
        for w in srv.workers:
            w.hold()
        fut = srv.submit(reqs[0], deadline_s=0.02)
        time.sleep(0.15)
        for w in srv.workers:
            w.release()
        res = fut.result(timeout=60)
        assert not res.ok and res.error == "deadline_exceeded"
        assert res.result is None and srv.stats()["expired"] == 1
        assert srv.serve(reqs)[0].ok


def test_killed_worker_request_completes_on_other_worker():
    ref_reqs = mixed_ref_requests(4)
    solo = solo_runs(ref_reqs)
    with server(meshes=2) as srv:
        srv.workers[1].hold()
        futs = [srv.submit(port(r)) for r in ref_reqs]
        _hold_until_inflight(srv, 1)
        assert srv.workers[1].inflight > 0
        srv.kill_worker(1)
        results = [f.result(timeout=120) for f in futs]
        stats = srv.stats()
    for r, (s, _) in zip(results, solo):
        assert r.ok
        np.testing.assert_array_equal(r.result.assignment, s.assignment)
    assert stats["retried"] >= 1 and stats["per_worker_served"][1] == 0


def test_all_workers_dead_resolves_no_worker():
    with server(meshes=2) as srv:
        srv.kill_worker(0)
        srv.kill_worker(1)
        res = srv.serve(mixed_requests(1))[0]
        assert not res.ok and res.error == "no_worker"


def test_admission_overload_rejects_structurally():
    reqs = mixed_requests(6, base_n=400)
    with server(meshes=1, max_queue=2) as srv:
        srv.workers[0].hold()
        futs = [srv.submit(r) for r in reqs]
        rejected = [f.result(timeout=5) for f in futs
                    if f.done() and not f.result().ok]
        assert rejected and all(r.error == "rejected" for r in rejected)
        srv.workers[0].release()
        kept = [f.result(timeout=120) for f in futs]
        assert sum(1 for r in kept if r.ok) >= 2
        assert srv.stats()["rejected"] == len(rejected)


def test_priorities_dispatch_before_later_arrivals():
    done, lock = [], threading.Lock()

    def track(tag):
        def _cb(fut):
            with lock:
                done.append(tag)
        return _cb

    reqs = mixed_requests(5, base_n=400)
    with server(meshes=1) as srv:
        srv.workers[0].hold()
        filler = srv.submit(reqs[0])
        _hold_until_inflight(srv, 0)
        assert srv.workers[0].inflight == 1
        labels = [3, 1, 2, 0]
        futs = []
        for r, prio in zip(reqs[1:], labels):
            f = srv.submit(r, priority=prio)
            f.add_done_callback(track(prio))
            futs.append(f)
        srv.workers[0].release()
        filler.result(timeout=120)
        for f in futs:
            f.result(timeout=120)
    assert done == sorted(labels)


def test_deadline_mid_attempt_keeps_worker_alive(temp_backend):
    release = threading.Event()

    def slow(g, req, ctx):
        release.wait(30)
        return np.zeros(g.n, dtype=np.int64)

    temp_backend("serve-torch-slow", slow)
    try:
        slow_req = api.PartitionRequest(graph=api.GraphSpec("rgg2d", 300),
                                        k=2, backend="serve-torch-slow")
        with server(meshes=1) as srv:
            res = srv.serve([slow_req], deadline_s=0.2)[0]
            assert not res.ok and res.error == "deadline_exceeded"
            assert srv.workers[0].alive
            busy = srv.serve(mixed_requests(1, base_n=400),
                             timeout_s=0.3)[0]
            assert not busy.ok and busy.error == "worker_failed"
            assert "draining" in busy.detail and srv.workers[0].alive
            release.set()
            assert srv.serve(mixed_requests(1, base_n=400))[0].ok
    finally:
        release.set()


def test_retried_ticket_does_not_block_queue(temp_backend):
    def boom(g, req, ctx):
        raise RuntimeError("kaboom")

    temp_backend("serve-torch-boom2", boom)
    bad = api.PartitionRequest(graph=api.GraphSpec("rgg2d", 300), k=2,
                               backend="serve-torch-boom2")
    reqs = mixed_requests(2, base_n=400)
    with server(meshes=2) as srv:
        for w in srv.workers:
            w.hold()
        f_bad = srv.submit(bad)            # -> worker 0 (tie: lowest id)
        f_g1 = srv.submit(reqs[0])         # -> worker 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                srv.workers[0].inflight == 0
                or srv.workers[1].inflight == 0):
            time.sleep(0.01)
        f_g2 = srv.submit(reqs[1])         # queued behind both
        srv.workers[0].release()
        assert f_g2.result(timeout=120).ok
        assert srv.workers[1].inflight == 1     # still held
        srv.workers[1].release()
        assert f_g1.result(timeout=120).ok
        res_bad = f_bad.result(timeout=120)
        assert not res_bad.ok and res_bad.error == "worker_failed"


def test_submit_after_close_raises_and_close_resolves_queued():
    srv = server(meshes=1)
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(mixed_requests(1)[0])
    srv = server(meshes=1)
    srv.workers[0].hold()
    futs = [srv.submit(r) for r in mixed_requests(3, base_n=400)]
    srv.close(wait=False)
    srv.workers[0].release()
    results = [f.result(timeout=60) for f in futs]
    assert all(r.ok or r.error == "server_closed" for r in results)
    assert any(r.error == "server_closed" for r in results)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _serve_cli(module, *extra, cuda_hidden=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if cuda_hidden:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", module, "--meshes", "2", "--requests", "6",
         "--n", "1000", "--k", "4", "--verify", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


_TIMES = ("queue_wait_s", "total_s", "worker", "time_s")


def test_serve_cli_matches_reference_cli():
    ref = _serve_cli("repro.launch.serve")
    out = _serve_cli("repro_torch.launch.serve", "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert out.returncode == 0, out.stderr
    want = [json.loads(x) for x in ref.stdout.splitlines()]
    got = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(got) == len(want) == 8
    for a, b in zip(got[:6], want[:6]):
        assert {k: v for k, v in a.items() if k not in _TIMES} == \
            {k: v for k, v in b.items() if k not in _TIMES}
        assert a["ok"] and a["feasible"]
    assert got[6] == want[6] == {"verify": "bit-identical"}
    for key in ("submitted", "completed", "failed", "rejected", "retried",
                "meshes", "devices_per_mesh"):
        assert got[7]["stats"][key] == want[7]["stats"][key]


def test_serve_cli_refuses_without_cuda_and_multi_device_meshes():
    out = _serve_cli("repro_torch.launch.serve")
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr
    out = _serve_cli("repro_torch.launch.serve", "--device", "cpu",
                     "--devices-per-mesh", "2")
    assert out.returncode == 2 and out.stdout == ""
    assert "queue 1 item 5" in out.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_served_batch_on_gpu_stacks_and_matches_solo():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    cfg = carry.config_from_dict(dataclasses.asdict(REF_CFG))
    distinct = [api.PartitionRequest(
        graph=api.GraphSpec("rgg2d", 600 + 300 * s, 8.0, seed=s), k=4,
        config=cfg, backend="single") for s in range(4)]
    reqs = distinct + distinct[:2]
    solo = api.Partitioner().run_batch(distinct)
    _build.reset_launches()
    with PartitionServer(meshes=1, batch_max=8, batch_window_ms=50.0) as srv:
        srv.workers[0].hold()
        futs = [srv.submit(r) for r in reqs]
        _hold_until_inflight(srv, 0)
        srv.workers[0].release()
        results = [f.result(timeout=300) for f in futs]
        stats = srv.stats()
    for r, s in zip(results, solo + solo[:2]):
        assert r.ok, r.detail
        np.testing.assert_array_equal(r.result.assignment, s.assignment)
    assert stats["batches"] >= 1 and stats["coalesced"] >= 2
    assert _build.LAUNCHES["lp_move_stacked"] > 0
