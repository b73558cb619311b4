"""repro_torch.fabric against repro.fabric: the wire codec (the same bytes
for the same request, each package decoding the other's frames), the
registry's leases, the autoscaler's hysteresis and server routing, the
single-process runtime helpers, the front door against scripted fake
workers (real sockets, no partitions), and two real CPU worker
processes: results bit-identical to solo runs of both packages, a
SIGKILLed worker's ticket failed over, a SIGTERM drain answering every
admitted ticket. Results are integers, compared exactly.
"""
import dataclasses
import json
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_jobs  # noqa: E402
from repro import api as ref_api  # noqa: E402
from repro.core.deep_mgp import PartitionerConfig as RefConfig  # noqa: E402
from repro.fabric import FabricClient as RefClient  # noqa: E402
from repro.fabric import protocol as ref_protocol  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.api.runtime import (device_count, device_slices,  # noqa
                                     distributed_init)
from repro_torch.fabric import (AutoscaleConfig, AutoscalePolicy,  # noqa
                                FabricClient, FrontDoor, ServerRegistry,
                                pick_server)
from repro_torch.fabric import protocol  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REF_CFG = RefConfig(contraction_limit=128, ip_repetitions=2, num_chunks=4)
CFG = carry.config_from_dict(dataclasses.asdict(REF_CFG))


def tiny_request(n=60, k=2, seed=3):
    return api.PartitionRequest(graph=api.GraphSpec("rgg2d", n, 6.0,
                                                    seed=seed),
                                k=k, config=CFG, backend="single")


def ref_request(req):
    """The reference's twin of a port request (a GraphSpec graph)."""
    g = req.graph
    return ref_api.PartitionRequest(
        graph=ref_api.GraphSpec(g.family, g.n, g.avg_deg, seed=g.seed),
        k=req.k, epsilon=req.epsilon, preset=req.preset,
        config=RefConfig(**dataclasses.asdict(req.config)), seed=req.seed,
        backend=req.backend, kernel=req.kernel)


def wire(d):
    return json.dumps(d, separators=(",", ":")).encode("utf-8")


def fields(req):
    """A request's fields (requests compare by identity)."""
    return {f.name: getattr(req, f.name) for f in dataclasses.fields(req)}


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_framing_roundtrip_and_eof():
    a, b = socket.socketpair()
    try:
        protocol.send_msg(a, {"op": "ping", "x": [1, 2, 3]})
        assert ref_protocol.recv_msg(b) == {"op": "ping", "x": [1, 2, 3]}
        ref_protocol.send_msg(b, {"op": "pong"})
        assert protocol.recv_msg(a) == {"op": "pong"}
        a.close()
        assert protocol.recv_msg(b) is None
    finally:
        b.close()


def test_framing_midframe_eof_is_protocol_error():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", 100) + b"abc")
        a.close()
        with pytest.raises(protocol.ProtocolError):
            protocol.recv_msg(b)
    finally:
        b.close()


def test_request_codec_spec_same_bytes_both_ways():
    req = dataclasses.replace(tiny_request(), kernel="fused", seed=4,
                              quality="best", collect_trace=False)
    ref = ref_request(req)
    ref = dataclasses.replace(ref, quality="best", collect_trace=False)
    mine = protocol.encode_request(req)
    assert wire(mine) == wire(ref_protocol.encode_request(ref))
    assert fields(ref_protocol.decode_request(mine)) == fields(ref)
    back = protocol.decode_request(ref_protocol.encode_request(ref))
    assert fields(back) == fields(req)


def test_request_codec_graph_arrays_same_bytes_both_ways():
    g = ref_generators.make("rgg2d", 80, 6.0, seed=1)
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    req = api.PartitionRequest(graph=h, k=2, config=CFG, backend="single",
                               contraction="sharded", weights="owner")
    ref = ref_api.PartitionRequest(graph=g, k=2, config=REF_CFG,
                                   backend="single", contraction="sharded",
                                   weights="owner")
    assert wire(protocol.encode_request(req)) == \
        wire(ref_protocol.encode_request(ref))
    got = protocol.decode_request(ref_protocol.encode_request(ref))
    for field in ("indptr", "adjncy", "eweights", "vweights"):
        want = getattr(g, field)
        have = getattr(got.graph, field)
        assert have.dtype == want.dtype
        assert np.array_equal(have, want)
    assert got.config == CFG and got.contraction == "sharded"
    got = ref_protocol.decode_request(protocol.encode_request(req))
    assert np.array_equal(got.graph.adjncy, g.adjncy) and got.k == 2


def fake_ok(req, sid, assignment=None, cut=3):
    """A canned ok ServeResult wire dict, as a worker would send."""
    n = req.graph.n
    asg = np.arange(n, dtype=np.int64) % 2 if assignment is None \
        else assignment
    sr = SimpleNamespace(
        ok=True, error=None, detail="", worker=0, attempts=1, priority=0,
        queue_wait_s=0.001, total_s=0.01,
        result=SimpleNamespace(assignment=asg, cut=cut, feasible=True,
                               backend="fake", time_s=0.01,
                               metrics={"n": np.int64(n)}))
    return protocol.encode_serve_result(sr, sid)


def test_result_codec_roundtrip_both_ways():
    req = tiny_request()
    mine = fake_ok(req, "srv-a")
    sr = SimpleNamespace(
        ok=True, error=None, detail="", worker=0, attempts=1, priority=0,
        queue_wait_s=0.001, total_s=0.01,
        result=SimpleNamespace(
            assignment=np.arange(req.graph.n, dtype=np.int64) % 2, cut=3,
            feasible=True, backend="fake", time_s=0.01,
            metrics={"n": np.int64(req.graph.n)}))
    assert wire(mine) == wire(ref_protocol.encode_serve_result(sr, "srv-a"))
    for decode in (protocol.decode_result, ref_protocol.decode_result):
        res = decode(mine)
        assert res.ok and res.server == "srv-a" and res.cut == 3
        assert res.assignment.dtype == np.int64
        assert np.array_equal(res.assignment,
                              np.arange(req.graph.n, dtype=np.int64) % 2)
        assert res.metrics == {"n": req.graph.n}
    err = protocol.decode_result(
        ref_protocol.error_result("worker_failed", "boom", attempts=2))
    assert not err.ok and err.error == "worker_failed"
    assert err.attempts == 2 and err.assignment is None
    assert err.summary()["error"] == "worker_failed"
    assert protocol.error_result("x", "y", 1) == \
        ref_protocol.error_result("x", "y", 1)


# ---------------------------------------------------------------------------
# registry leases (fake clock)
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_lease_register_renew_expire_timing():
    clk = Clock()
    reg = ServerRegistry(ttl_s=5.0, clock=clk)
    rec = reg.register("w0", "127.0.0.1", 1234, devices=2, meshes=3)
    assert rec.lease_expiry == 105.0 and rec.generation == 0
    assert [r.server_id for r in reg.alive()] == ["w0"]
    clk.t = 104.0
    assert reg.renew("w0", metrics={"inflight": 1})
    assert reg.get("w0").lease_expiry == 109.0
    assert reg.get("w0").renewals == 1
    assert reg.get("w0").metrics == {"inflight": 1}
    clk.t = 109.0
    assert reg.alive() == []
    assert [r.server_id for r in reg.expire()] == ["w0"]
    assert reg.expire() == []


def test_renew_after_expiry_is_false_then_reregister_bumps_generation():
    clk = Clock()
    reg = ServerRegistry(ttl_s=2.0, clock=clk)
    reg.register("w0", "h", 1)
    clk.t += 3.0
    assert not reg.renew("w0")
    assert not reg.renew("never-registered")
    rec = reg.register("w0", "h", 2)
    assert rec.generation == 1 and rec.port == 2
    assert reg.register("w0", "h", 3).generation == 2


def test_expire_removes_only_lapsed_and_alive_is_sorted():
    clk = Clock()
    reg = ServerRegistry(ttl_s=5.0, clock=clk)
    reg.register("b", "h", 1)
    clk.t += 3.0
    reg.register("a", "h", 2)
    clk.t += 3.0
    assert [r.server_id for r in reg.expire()] == ["b"]
    assert [r.server_id for r in reg.alive()] == ["a"]
    assert len(reg) == 1
    assert reg.snapshot()[0]["server_id"] == "a"
    assert reg.deregister("a").server_id == "a"
    assert reg.deregister("a") is None


# ---------------------------------------------------------------------------
# autoscaler policy hysteresis and server routing (pure)
# ---------------------------------------------------------------------------

def test_policy_grows_only_after_consecutive_pressure_windows():
    pol = AutoscalePolicy(AutoscaleConfig(
        min_workers=1, max_workers=3, grow_queue_depth=2.0,
        grow_windows=2, shrink_windows=4))
    assert pol.observe(workers=1, queue_depth=5) == 0
    assert pol.observe(workers=1, queue_depth=0, submitted=1) == 0
    assert pol.observe(workers=1, queue_depth=5) == 0
    assert pol.observe(workers=1, queue_depth=5) == 1
    assert pol.observe(workers=2, queue_depth=3) == 0
    assert pol.observe(workers=2, queue_depth=3) == 0


def test_policy_deadline_miss_is_always_a_breach():
    pol = AutoscalePolicy(AutoscaleConfig(grow_windows=2, max_workers=2))
    assert pol.observe(workers=1, queue_depth=0, deadline_misses=1) == 0
    assert pol.observe(workers=1, queue_depth=0, deadline_misses=1) == 1


def test_policy_shrinks_after_idle_windows_within_bounds():
    pol = AutoscalePolicy(AutoscaleConfig(
        min_workers=1, max_workers=3, shrink_windows=3))
    for _ in range(2):
        assert pol.observe(workers=2, queue_depth=0) == 0
    assert pol.observe(workers=2, queue_depth=0) == -1
    for _ in range(10):
        assert pol.observe(workers=1, queue_depth=0) == 0
    for _ in range(10):
        assert pol.observe(workers=2, queue_depth=0, inflight=1) == 0


def test_policy_never_grows_past_max():
    pol = AutoscalePolicy(AutoscaleConfig(max_workers=2, grow_windows=1))
    assert pol.observe(workers=1, queue_depth=9) == 1
    assert pol.observe(workers=2, queue_depth=9) == 0


def test_autoscale_config_validates():
    for bad in (dict(min_workers=0), dict(min_workers=3, max_workers=2),
                dict(eval_period_s=0.0), dict(grow_windows=0)):
        with pytest.raises(ValueError):
            AutoscaleConfig(**bad).validate()


def test_process_scaler_spawns_the_port_worker(monkeypatch):
    from repro_torch.fabric import autoscaler

    seen = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            seen.append(cmd)
            self.pid = 7

        def poll(self):
            return None

    monkeypatch.setattr(autoscaler.subprocess, "Popen", FakePopen)
    sc = autoscaler.ProcessScaler(["--frontdoor", "h:1"], id_prefix="t")
    sid = sc.scale_up()
    assert seen[0][1:5] == ["-m", "repro_torch.launch.fabric", "worker",
                            "--server-id"]
    assert seen[0][5] == sid and seen[0][6:] == ["--frontdoor", "h:1"]
    assert sc.count() == 1


def S(sid, devices=1, inflight=0):
    return SimpleNamespace(sid=sid, devices=devices, inflight=inflight)


def test_pick_server_exact_fit_load_then_sid():
    assert pick_server(4, [S("a", 8), S("b", 4)]).sid == "b"
    assert pick_server(2, [S("a", 8), S("b", 4)]).sid == "b"
    assert pick_server(1, [S("a", 1, inflight=2), S("b", 1)]).sid == "b"
    assert pick_server(1, [S("b", 1), S("a", 1)]).sid == "a"
    assert pick_server(1, []) is None


# ---------------------------------------------------------------------------
# runtime helpers (the single-process part)
# ---------------------------------------------------------------------------

def test_device_slices_error_names_counts_and_feasible_carve():
    have = device_count()
    with pytest.raises(RuntimeError) as ei:
        device_slices(have + 1, 4)
    msg = str(ei.value)
    assert f"only {have} device(s) available" in msg
    assert ("largest feasible" in msg) or ("no carve" in msg)
    with pytest.raises(ValueError):
        device_slices(0, 1)


def test_distributed_init_single_process_noop(monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() == {"mode": "single-process",
                                  "process_id": 0, "num_processes": 1}
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "1")
    assert distributed_init()["mode"] == "single-process"


def test_distributed_init_validates_ranks_then_names_the_engine():
    """Bad ranks raise; a valid request joins the distributed engine's
    group (here one gloo rank, in a fresh process)."""
    with pytest.raises(ValueError):
        distributed_init(coordinator_address="127.0.0.1:9",
                         num_processes=2, process_id=5)
    with pytest.raises(ValueError):
        distributed_init(coordinator_address="127.0.0.1:9",
                         num_processes=0)
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    with torch_dist_jobs.held_port() as port:
        code = ("import json, torch.distributed as dist\n"
                "from repro_torch.api.runtime import distributed_init\n"
                f"info = distributed_init('127.0.0.1:{port}', 1, 0, "
                "device='cpu')\n"
                "dist.destroy_process_group()\n"
                "print(json.dumps(info))\n")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info == {"mode": "multi-process", "process_id": 0,
                    "num_processes": 1, "backend": "gloo",
                    "device": "cpu"}


# ---------------------------------------------------------------------------
# front door vs scripted fake workers (real sockets, no partitions)
# ---------------------------------------------------------------------------

class FakeWorker:
    """A scripted fabric server: registers with the front door over a
    real heartbeat connection and answers ``partition`` frames with
    whatever ``handler(msg, conn) -> wire dict | None`` returns (None =
    stay silent; the handler may also close ``conn`` to fake a crash)."""

    def __init__(self, fd_addr, sid, handler, *, renew=True,
                 heartbeat_s=0.1):
        self.sid, self.handler = sid, handler
        self._renew, self._heartbeat_s = renew, heartbeat_s
        self._fd_addr = fd_addr
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.host, self.port = self._listener.getsockname()[:2]
        threading.Thread(target=self._accept, daemon=True).start()
        threading.Thread(target=self._heartbeat, daemon=True).start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                msg = protocol.recv_msg(conn)
                if msg is None:
                    return
                if msg.get("op") != "partition":
                    continue
                res = self.handler(msg, conn)
                if res is not None:
                    protocol.send_msg(conn, {"op": "result",
                                             "id": msg["id"],
                                             "result": res})
        except (OSError, protocol.ProtocolError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _heartbeat(self):
        try:
            sock = protocol.connect(*self._fd_addr, timeout=5.0)
            protocol.send_msg(sock, {
                "op": "register",
                "server": {"server_id": self.sid, "host": self.host,
                           "port": self.port, "devices": 1, "meshes": 1,
                           "pid": 0}})
            protocol.recv_msg(sock)
            while self._renew and not self._stop.wait(self._heartbeat_s):
                protocol.send_msg(sock, {"op": "renew",
                                         "server_id": self.sid})
                protocol.recv_msg(sock)
            sock.close()
        except (OSError, protocol.ProtocolError):
            pass

    def stop(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


def wait_for_servers(fd, count, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        with fd._cond:
            live = sum(1 for h in fd._handles.values() if h.alive)
        if live >= count:
            return
        time.sleep(0.01)
    raise AssertionError(f"{count} server(s) never connected")


def ok_handler(sid):
    return lambda m, c: fake_ok(protocol.decode_request(m["request"]), sid)


def test_frontdoor_routes_and_decodes():
    req = tiny_request()
    with FrontDoor(port=0, lease_ttl_s=2.0) as fd:
        w = FakeWorker((fd.host, fd.port), "a", ok_handler("a"))
        try:
            wait_for_servers(fd, 1)
            with FabricClient(fd.host, fd.port) as client:
                res = client.submit(req).result(timeout=30)
                assert res.ok and res.server == "a" and res.attempts == 1
                assert np.array_equal(
                    res.assignment,
                    np.arange(req.graph.n, dtype=np.int64) % 2)
                st = client.status()
                assert [s["server_id"] for s in st["servers"]] == ["a"]
        finally:
            w.stop()


def test_frontdoor_work_connection_waits_for_long_runs():
    """The dial's 5 s timeout must not stay on the work connection: a run
    may take longer, and a read timeout would fail its worker over."""
    with FrontDoor(port=0, lease_ttl_s=2.0) as fd:
        w = FakeWorker((fd.host, fd.port), "a", ok_handler("a"))
        try:
            wait_for_servers(fd, 1)
            with fd._cond:
                assert fd._handles["a"].sock.gettimeout() is None
        finally:
            w.stop()


@pytest.mark.parametrize("fault", ["server_closed", "connection_lost"])
def test_frontdoor_fails_over_to_the_other_server(fault):
    def bad(msg, conn):
        if fault == "connection_lost":
            conn.close()       # drop the work connection mid-request
            return None
        return protocol.error_result("server_closed", "draining")

    with FrontDoor(port=0, lease_ttl_s=2.0) as fd:
        w1 = FakeWorker((fd.host, fd.port), "a-bad", bad)
        w2 = FakeWorker((fd.host, fd.port), "b-good", ok_handler("b-good"))
        try:
            wait_for_servers(fd, 2)
            with FabricClient(fd.host, fd.port) as client:
                res = client.submit(tiny_request()).result(timeout=30)
                assert res.ok and res.server == "b-good"
                assert res.attempts == 2
        finally:
            w1.stop()
            w2.stop()


def test_frontdoor_reroutes_from_expired_lease():
    with FrontDoor(port=0, lease_ttl_s=0.6) as fd:
        dead = FakeWorker((fd.host, fd.port), "a-dead", lambda m, c: None,
                          renew=False)
        good = FakeWorker((fd.host, fd.port), "b-good", ok_handler("b-good"))
        try:
            wait_for_servers(fd, 2)
            with FabricClient(fd.host, fd.port) as client:
                t0 = time.monotonic()
                res = client.submit(tiny_request()).result(timeout=30)
                assert res.ok and res.server == "b-good"
                assert res.attempts == 2
                assert time.monotonic() - t0 < 10.0
            assert fd.registry.get("a-dead") is None
        finally:
            dead.stop()
            good.stop()


def test_frontdoor_no_worker_when_retries_exhausted():
    with FrontDoor(port=0, lease_ttl_s=2.0, max_retries=1) as fd:
        bad = FakeWorker((fd.host, fd.port), "only",
                         lambda m, c: protocol.error_result(
                             "worker_failed", "boom"))
        try:
            wait_for_servers(fd, 1)
            with FabricClient(fd.host, fd.port) as client:
                res = client.submit(tiny_request()).result(timeout=30)
                assert not res.ok and res.error == "no_worker"
                assert "boom" in res.detail
        finally:
            bad.stop()


def test_frontdoor_fresh_ticket_waits_then_deadline():
    with FrontDoor(port=0, lease_ttl_s=2.0) as fd:
        with FabricClient(fd.host, fd.port) as client:
            res = client.submit(tiny_request(),
                                deadline_s=0.3).result(timeout=30)
            assert not res.ok and res.error == "deadline_exceeded"


def test_frontdoor_rejects_malformed_request():
    with FrontDoor(port=0, lease_ttl_s=2.0) as fd:
        sock = protocol.connect(fd.host, fd.port, timeout=5.0)
        try:
            protocol.send_msg(sock, {"op": "partition", "id": 7,
                                     "request": {"graph": {"kind": "?"}}})
            resp = protocol.recv_msg(sock)
            assert resp["op"] == "result" and resp["id"] == 7
            assert resp["result"]["error"] == "rejected"
        finally:
            sock.close()


def test_client_connection_loss_is_structured():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    host, port = lst.getsockname()[:2]
    accepted = []
    threading.Thread(target=lambda: accepted.append(lst.accept()[0]),
                     daemon=True).start()
    client = FabricClient(host, port)
    try:
        fut = client.submit(tiny_request())
        t_end = time.monotonic() + 5
        while not accepted and time.monotonic() < t_end:
            time.sleep(0.01)
        accepted[0].close()
        res = fut.result(timeout=30)
        assert not res.ok and res.error == "connection_lost"
    finally:
        client.close()
        lst.close()


# ---------------------------------------------------------------------------
# two real CPU worker processes
# ---------------------------------------------------------------------------

def spawn_worker(fd, sid):
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
                    JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fabric", "worker",
         "--frontdoor", f"{fd.host}:{fd.port}", "--server-id", sid,
         "--heartbeat-s", "0.3", "--device", "cpu"],
        stdout=subprocess.PIPE, env=env, text=True, cwd=ROOT)


def wait_inflight(fd, sids, timeout=30.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        with fd._cond:
            busy = {s for s, h in fd._handles.items() if h.inflight}
        if set(sids) <= busy:
            return
        time.sleep(0.005)
    raise AssertionError(f"{sids} never all busy")


def test_two_worker_processes_bit_identical_failover_and_drain():
    reqs = [tiny_request(n=400 + 100 * i, k=2 + i % 2, seed=2 + i)
            for i in range(3)]
    reqs.append(dataclasses.replace(reqs[0], seed=5))    # request seed
    big = tiny_request(n=1000, k=4, seed=9)
    solo = [api.Partitioner(device="cpu").run(r) for r in reqs + [big]]
    want = [ref_api.Partitioner().run(ref_request(r)) for r in reqs + [big]]
    for s, w in zip(solo, want):
        assert np.array_equal(s.assignment, w.assignment) and s.cut == w.cut
    with FrontDoor(port=0, lease_ttl_s=3.0) as fd:
        procs = {sid: spawn_worker(fd, sid) for sid in ("w0", "w1")}
        try:
            ready = {sid: json.loads(p.stdout.readline())
                     for sid, p in procs.items()}
            assert all(r["op"] == "ready" and r["runtime"]["mode"] ==
                       "single-process" for r in ready.values())
            wait_for_servers(fd, 2, timeout=60)
            # the reference's client reads the port's frames
            with RefClient(fd.host, fd.port) as client:
                rs = [client.submit(ref_request(r)) for r in reqs]
                rs = [f.result(timeout=120) for f in rs]
            assert {r.server for r in rs} == {"w0", "w1"}
            for r, s in zip(rs, solo):
                assert r.ok and r.attempts == 1
                assert np.array_equal(r.assignment, s.assignment)
                assert r.cut == s.cut
            with FabricClient(fd.host, fd.port) as client:
                # SIGKILL w0 with a ticket in flight on each worker: its
                # ticket fails over to w1
                futs = [client.submit(big), client.submit(big)]
                wait_inflight(fd, ("w0", "w1"))
                procs["w0"].kill()
                rs = [f.result(timeout=120) for f in futs]
            assert all(r.ok and r.server == "w1" for r in rs)
            assert sorted(r.attempts for r in rs) == [1, 2]
            for r in rs:
                assert np.array_equal(r.assignment, solo[-1].assignment)
            # SIGTERM drain of w1 with three tickets admitted on its own
            # port: every one is answered (the running one ok, queued
            # ones ok or server_closed), then it deregisters and exits 0
            sock = protocol.connect(ready["w1"]["host"],
                                    ready["w1"]["port"], timeout=5.0)
            try:
                for i in range(3):
                    protocol.send_msg(sock, {
                        "op": "partition", "id": i,
                        "request": protocol.encode_request(big)})
                time.sleep(0.3)
                procs["w1"].send_signal(signal.SIGTERM)
                got = {}
                while len(got) < 3:
                    msg = protocol.recv_msg(sock)
                    assert msg is not None, f"answers {sorted(got)} only"
                    got[msg["id"]] = msg["result"]
            finally:
                sock.close()
            assert procs["w1"].wait(timeout=60) == 0
            oks = [r for r in got.values() if r["ok"]]
            assert oks and all(r["error"] == "server_closed"
                               for r in got.values() if not r["ok"])
            for r in oks:
                asg = protocol.decode_array(r["assignment"])
                assert np.array_equal(asg, solo[-1].assignment)
            t_end = time.monotonic() + 10
            while fd.registry.get("w1") and time.monotonic() < t_end:
                time.sleep(0.05)
            assert fd.registry.get("w1") is None
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
