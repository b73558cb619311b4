"""The port's multi-device serving tier against the JAX reference's, run
live: ``PartitionSession(devices=2)`` and ``PartitionServer(meshes=2,
devices_per_mesh=2)`` of both packages serve one mix of requests. The
reference runs on forced host devices (through ``torch_dist_jobs``'s
shim, in the file's one JAX subprocess); the port on meshes of gloo rank
processes (``api.runtime.PeMesh``). The mix: ``dist`` requests on rgg2d
n=2000 (seed 3, k=8, C=64) in both memory models, the same request with
its graph sent as a ``GraphSpec`` and as arrays, an ``auto`` request the
policy sends to ``dist`` (n=1500), a ``single`` request at devices=2 and
one request at devices=1. Assignment, cut, summary and trace (timings
left out) must be the reference's bit for bit; every distributed
request must have gone through a mesh, whose ranks' digests agreed.

Then the port alone: a follower rank of mesh 0 SIGKILLed mid-request
(the request completes on mesh 1, mesh 0 is retired), a concurrent
batch of distributed requests against solo runs, ranks that raise alike
or unlike, a mesh that fails to start, a fabric worker of two-rank
meshes, the serve CLI with two-device meshes and the port's selftest.
The reference's answers on this mix: cuts 182 (both forms), 195
(sharded), 100, 92 and 107.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import runtime  # noqa: E402
from repro_torch.serve import PartitionServer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
C64 = {"contraction_limit": 64}
SHARDED = {"contraction": "sharded", "balance": "dist", "weights": "owner"}
A = ["rgg2d", 2000, 8.0, 3]
REQS = [
    {"graph": A, "as": "spec", "k": 8, "devices": 2, "backend": "dist",
     "config": C64},
    {"graph": A, "as": "graph", "k": 8, "devices": 2, "backend": "dist",
     "config": C64},
    {"graph": A, "as": "spec", "k": 8, "devices": 2, "backend": "dist",
     "config": C64, "request": SHARDED},
    {"graph": ["rgg2d", 1500, 8.0, 5], "as": "spec", "k": 4, "devices": 2,
     "config": C64},
    {"graph": ["rgg2d", 1200, 8.0, 7], "as": "spec", "k": 4, "devices": 2,
     "backend": "single", "config": C64},
    {"graph": ["rgg2d", 1000, 8.0, 9], "as": "graph", "k": 4, "devices": 1,
     "config": C64},
]
CUTS = [182, 182, 195, 100, 92, 107]
BACKENDS = ["dist", "dist", "dist", "dist", "single", "single"]
JOBS = [dict(id="session", kind="session", P=2, reqs=REQS, kernel="fused"),
        dict(id="server", kind="server", P=2, reqs=REQS,
             kernel="composed")]


@pytest.fixture(scope="module", autouse=True)
def reference_runs(tmp_path_factory):
    """The two job subprocesses start with the module's first test; the
    tests that need no reference answer run first, meanwhile."""
    return torch_dist_jobs.start_both(JOBS,
                                      str(tmp_path_factory.mktemp("ds")))


@pytest.fixture(scope="module")
def results(reference_runs):
    return reference_runs(600)


# every test's own limit (seconds): it takes 3-15 s alone and up to
# about three times that beside the suite's other workers
LIMIT_S = 240


@pytest.fixture(autouse=True)
def limit():
    """Each test's limit (``torch_dist_jobs.time_limit``); a test adds the
    subprocesses it starts to the yielded list."""
    with torch_dist_jobs.time_limit(LIMIT_S) as procs:
        yield procs


def same(got, want):
    return (np.array_equal(got["part"], want["part"])
            and got["cut"] == want["cut"]
            and got["feasible"] == want["feasible"]
            and got["summary"] == want["summary"]
            and got["trace"] == want["trace"])


def test_ranks_that_raise_alike_keep_the_mesh_unlike_fail_it(one_thread):
    with runtime.PeMesh(["cpu", "cpu"]) as mesh:
        with pytest.raises(ValueError, match="refused on this rank"):
            mesh.call(torch_dist_jobs.raise_on, [0, 1])
        assert mesh.alive
        assert mesh.call(torch_dist_jobs.raise_on, []).value is False
        with pytest.raises(runtime.MeshFailure, match="unlike each other"):
            mesh.call(torch_dist_jobs.raise_on, [1])
        assert not mesh.alive
        with pytest.raises(runtime.MeshFailure, match="closed"):
            mesh.call(torch_dist_jobs.raise_on, [])
    assert all(p.exitcode is not None for p in mesh._procs)


def test_a_mesh_whose_ranks_fail_to_start_raises(monkeypatch, one_thread):
    """Rank 0 cannot listen on the group's port (taken): the mesh raises
    naming the rank and stops the other one, which waits for it."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        monkeypatch.setattr(runtime, "_free_port",
                            lambda: taken.getsockname()[1])
        t0 = time.monotonic()
        with pytest.raises(runtime.MeshFailure,
                           match="rank 0 of the mesh failed to start"):
            runtime.PeMesh(["cpu", "cpu"])
        assert time.monotonic() - t0 < 60


def _cli(*cmd, timeout=300):
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", *cmd], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_cli_with_two_device_meshes_verifies():
    out = _cli("repro_torch.launch.serve", "--meshes", "2",
               "--devices-per-mesh", "2", "--device", "cpu", "--requests",
               "4", "--n", "1000", "--k", "4", "--verify")
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [x["backend"] for x in lines[:4]] == ["single"] * 3 + ["dist"]
    assert lines[4] == {"verify": "bit-identical"}
    assert lines[5]["stats"]["devices_per_mesh"] == 2


def test_selftest_smoke_on_two_cpu_ranks():
    out = _cli("repro_torch.launch.selftest", "--devices", "2", "--device",
               "cpu", "--n", "500", "--test", "smoke")
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [x["test"] for x in lines] == [
        "collectives.direct", "collectives.grid", "halo.direct",
        "halo.grid_vs_direct"]
    assert all(x["pass"] for x in lines)


def test_selftest_refuses_analysis_and_cards_it_does_not_have():
    out = _cli("repro_torch.launch.selftest", "--devices", "2", "--test",
               "analysis")
    assert out.returncode == 2 and out.stdout == ""
    assert "--device cpu" in out.stderr
    out = _cli("repro_torch.launch.selftest", "--devices", "2", "--test",
               "smoke")
    assert out.returncode == 2 and out.stdout == ""
    assert "--device cpu" in out.stderr


@pytest.mark.parametrize("jid", ["session", "server"])
@pytest.mark.parametrize("i", range(len(REQS)))
def test_serving_matches_the_reference(results, jid, i):
    ref, port = results
    want, got = ref[jid]["results"][i], port[jid]["results"][i]
    assert same(got, want)
    assert got["cut"] == CUTS[i] and got["backend"] == BACKENDS[i]


@pytest.mark.parametrize("jid", ["session", "server"])
def test_every_distributed_request_went_through_a_mesh(results, jid):
    """Four requests resolve to ``dist`` at two devices: each is one
    ``PeMesh.call`` whose ranks' digests agreed (else it raises); the
    spec and the arrays of one graph give one answer."""
    _, port = results
    assert np.sum(port[jid]["mesh_calls"]) == BACKENDS.count("dist")
    res = port[jid]["results"]
    assert same(res[0], res[1])
    for r in res[:4]:
        assert any(t["phase"] == "dist-coarsen" for t in r["trace"])


def _req(i):
    return torch_dist_jobs.build_requests("repro_torch", [REQS[i]])[0]


def test_killed_follower_rank_fails_over_to_the_other_mesh(results,
                                                          one_thread):
    """Rank 1 of mesh 0 is stopped before the request reaches it and
    killed while rank 0 runs it: the attempt fails at once, mesh 0 is
    retired with its worker, and the request completes on mesh 1."""
    ref, _ = results
    with PartitionServer(meshes=2, devices_per_mesh=2, device="cpu") as srv:
        mesh0 = srv.workers[0].mesh
        os.kill(mesh0.pids[1], signal.SIGSTOP)
        fut = srv.submit(_req(0))
        t_end = time.monotonic() + 60
        while not mesh0.busy and time.monotonic() < t_end:
            time.sleep(0.001)
        assert mesh0.busy
        time.sleep(0.3)
        os.kill(mesh0.pids[1], signal.SIGKILL)
        r = fut.result(timeout=120)
        st = srv.stats()
        alive = [w.alive for w in srv.workers]
        mesh1 = srv.workers[1].mesh
        assert mesh1.alive and mesh1.calls == 1
    assert r.ok and r.worker == 1 and r.attempts == 2
    assert same(torch_dist_jobs.served(r.result),
                ref["session"]["results"][0])
    assert st["retried"] == 1 and st["per_worker_served"] == [0, 1]
    assert alive == [False, True]
    assert not mesh0.alive and "died" in mesh0.failure
    assert all(p.exitcode is not None for p in mesh0._procs)


def test_concurrent_batch_of_distributed_requests_equals_solo_runs(
        results, one_thread):
    ref, _ = results
    idx = [2, 0, 3, 1]
    reqs = [_req(i) for i in idx]
    with api.PartitionSession(devices=2, max_workers=4,
                              device="cpu") as sess:
        batch = sess.run_batch(reqs)
        solo = [sess.submit(r).result() for r in reqs]
        assert sess.mesh.calls == 8
    for i, b, s in zip(idx, batch, solo):
        assert same(torch_dist_jobs.served(b), ref["session"]["results"][i])
        assert np.array_equal(b.assignment, s.assignment)


def test_fabric_worker_of_two_rank_meshes_serves_a_solo_answer(
        results, one_thread, limit):
    from repro_torch.fabric import FabricClient, FrontDoor, status_of
    ref, _ = results
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    with FrontDoor(lease_ttl_s=5.0) as fd:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fabric", "worker",
             "--frontdoor", f"{fd.host}:{fd.port}", "--server-id", "mesh2",
             "--devices-per-mesh", "2", "--device", "cpu",
             "--heartbeat-s", "0.3"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        limit.append(proc)
        try:
            ready = json.loads(proc.stdout.readline())
            assert ready["devices"] == 2 and ready["meshes"] == 1
            t_end = time.monotonic() + 60
            while time.monotonic() < t_end and \
                    not status_of(fd.host, fd.port)["servers"]:
                time.sleep(0.1)
            (srv,) = status_of(fd.host, fd.port)["servers"]
            assert srv["devices"] == 2
            with FabricClient(fd.host, fd.port) as client:
                futs = [client.submit(r) for r in (_req(2), _req(5))]
                rs = [f.result(timeout=300) for f in futs]
            for r, i in zip(rs, (2, 5)):
                want = ref["server"]["results"][i]
                assert r.ok and r.server == "mesh2"
                assert np.array_equal(r.assignment, want["part"])
                assert r.cut == want["cut"]
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0


def test_fabric_group_of_two_processes_spans_one_mesh_of_two(
        results, limit, tmp_path):
    """A worker of two processes at two devices a mesh is one server:
    process 0 registers it (``devices=2``), process 1 hosts the mesh's
    rank 1, and its answers are the reference's; SIGTERM to process 0
    ends both with exit 0."""
    from repro_torch.fabric import FabricClient, FrontDoor, status_of
    ref, _ = results
    with FrontDoor(lease_ttl_s=5.0) as fd, \
            torch_dist_jobs.held_port() as port:
        procs = torch_dist_jobs.fabric_group(fd, 2, 2, "span2", str(tmp_path),
                                             port)
        limit.extend(procs)
        try:
            ready = [json.loads(p.stdout.readline() or "{}") for p in procs]
            assert ready[0]["server_id"] == "span2"
            assert ready[0]["devices"] == 2 and ready[0]["processes"] == 2
            assert [c["process"] for c in ready[0]["cards"]] == [0, 1]
            assert ready[1]["role"] == "rank-host"
            assert ready[1]["process_id"] == 1
            t_end = time.monotonic() + 60
            while time.monotonic() < t_end and \
                    not status_of(fd.host, fd.port)["servers"]:
                time.sleep(0.1)
            (srv,) = status_of(fd.host, fd.port)["servers"]
            assert srv["server_id"] == "span2" and srv["devices"] == 2
            with FabricClient(fd.host, fd.port) as client:
                futs = [client.submit(r) for r in (_req(2), _req(5))]
                rs = [f.result(timeout=300) for f in futs]
        finally:
            procs[0].send_signal(signal.SIGTERM)
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(timeout=60))
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes.append(("killed", p.wait()))
    for r, i in zip(rs, (2, 5)):
        want = ref["server"]["results"][i]
        assert r.ok and r.server == "span2"
        assert np.array_equal(r.assignment, want["part"])
        assert r.cut == want["cut"] == CUTS[i]
    assert codes == [0, 0], [(tmp_path / f"p{i}.err").read_text()[-2000:]
                             for i in range(2)]
