"""The fabric worker of several processes (``python -m
repro_torch.launch.fabric worker --num-processes N``,
``repro_torch.api.group``) on the CPU: gloo groups of worker processes
with ``--device cpu`` and no card visible, behind a port ``FrontDoor``.

At one device a mesh every process is a whole worker (ids ``S.p<I>``),
whose answers equal an in-process ``PartitionServer``'s. Above one, one
server spans the group; a rank host killed in the middle of a request
fails only the mesh with a rank on it, the ticket fails over and process
0 serves on, and no rank of the dead host lingers; when process 0 dies
then, its rank hosts exit 1 and every rank ends. A carve that does not
fit exits 2 with ``device_slices``' message, a mesh that would hold one
card twice is refused (a pure check over listed cards), and a group
missing a process exits 2 within its start-up bound. Before a process
leaves the group every process checks in on its store
(``group.check_in``, rank 0 last): a caller waits for the others, and
one whose peer never checks in raises, and its worker exits 2, naming
the missing count. The spanning form's answers against the reference
are in ``test_torch_dist_serving.py``.

Last, the reference's own fault pinned: two JAX processes joined by
``repro.api.runtime.distributed_init`` each carve the same slice over
the whole group's devices (ROADMAP queue 3).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

torch = pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402
from repro_torch.api import group, runtime  # noqa: E402
from repro_torch.fabric import FabricClient, FrontDoor, status_of  # noqa
from repro_torch.fabric import protocol  # noqa: E402
from repro_torch.serve import PartitionServer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
C64 = {"contraction_limit": 64}
LIMIT_S = 240


@pytest.fixture(autouse=True)
def limit():
    with torch_dist_jobs.time_limit(LIMIT_S) as procs:
        yield procs


def requests(specs):
    return torch_dist_jobs.build_requests("repro_torch", specs)


def ready_lines(procs):
    return [json.loads(p.stdout.readline() or "{}") for p in procs]


def wait_servers(fd, count, timeout=60.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        servers = status_of(fd.host, fd.port)["servers"]
        if len(servers) >= count:
            return servers
        time.sleep(0.1)
    raise AssertionError(f"{count} server(s) never registered")


def stop(procs, sig=signal.SIGTERM, timeout=60):
    """Signal the live processes of ``procs``; their exit codes."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(("killed", p.wait()))
    return codes


def worker_stats(ready):
    """``PartitionServer.stats()`` of the worker whose ready line this is,
    through its own port."""
    sock = protocol.connect(ready["host"], ready["port"], timeout=10.0)
    try:
        protocol.send_msg(sock, {"op": "status"})
        return protocol.recv_msg(sock)["stats"]
    finally:
        sock.close()


def stat_fields(pid):
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    return stat.rsplit(")", 1)[1].split()


def running(pid):
    fields = stat_fields(pid)
    return fields is not None and fields[0] != "Z"


def children(pid):
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            fields = stat_fields(d.name)
            if fields is not None and int(fields[1]) == pid:
                out.append(int(d.name))
    return out


def cmdline(pid):
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes().decode()
    except OSError:
        return ""


# ---------------------------------------------------------------------------
# one device a mesh: every process a whole worker
# ---------------------------------------------------------------------------

def test_group_at_one_device_a_mesh_is_a_worker_a_process(limit, tmp_path):
    reqs = requests([{"graph": ["rgg2d", 500 + 100 * i, 8.0, 3 + i],
                      "as": "spec", "k": 4, "devices": 1,
                      "backend": "single", "config": C64}
                     for i in range(4)])
    with FrontDoor(lease_ttl_s=5.0) as fd, \
            torch_dist_jobs.held_port() as port:
        procs = torch_dist_jobs.fabric_group(fd, 2, 1, "S", str(tmp_path),
                                             port)
        limit.extend(procs)
        try:
            # the in-process answers while the group starts
            with PartitionServer(meshes=1, device="cpu") as srv:
                want = [srv.submit(r).result(timeout=120) for r in reqs]
            ready = ready_lines(procs)
            assert [r.get("server_id") for r in ready] == ["S.p0", "S.p1"]
            for i, r in enumerate(ready):
                assert r["role"] == "worker" and r["devices"] == 1
                assert r["runtime"]["mode"] == "multi-process"
                assert r["runtime"]["process_id"] == i
                assert r["runtime"]["num_processes"] == 2
            servers = wait_servers(fd, 2)
            assert sorted(s["server_id"] for s in servers) == ["S.p0", "S.p1"]
            with FabricClient(fd.host, fd.port) as client:
                rs = [f.result(timeout=120)
                      for f in [client.submit(r) for r in reqs]]
        finally:
            codes = stop(procs)
    assert codes == [0, 0], [(tmp_path / f"p{i}.err").read_text()[-2000:]
                             for i in range(2)]
    assert {r.server for r in rs} == {"S.p0", "S.p1"}
    for r, w in zip(rs, want):
        assert r.ok and r.attempts == 1
        assert np.array_equal(r.assignment, w.result.assignment)
        assert r.cut == w.result.cut


# ---------------------------------------------------------------------------
# above one: one server spans the group
# ---------------------------------------------------------------------------

def test_a_dying_rank_host_fails_only_its_mesh(limit, tmp_path):
    """Four processes, two meshes of two (processes 0-1 and 2-3). The rank
    of mesh 0 on process 1 is stopped, a request goes to mesh 0, and
    process 1 is killed: the ticket fails over to mesh 1, process 0 serves
    on with it, and the stopped rank, continued, ends with its host. Then
    process 0 is killed: processes 2 and 3 exit 1, naming it, and no rank
    of the group lingers (SIGTERM to process 0, which ends every process
    with exit 0, is ``test_torch_dist_serving.py``'s)."""
    (req,) = requests([{"graph": ["rgg2d", 1500, 8.0, 5], "as": "spec",
                        "k": 4, "devices": 2, "backend": "dist",
                        "config": C64}])
    with FrontDoor(lease_ttl_s=5.0) as fd, \
            torch_dist_jobs.held_port() as port:
        procs = torch_dist_jobs.fabric_group(fd, 4, 2, "span", str(tmp_path),
                                             port, meshes=2)
        limit.extend(procs)
        try:
            ready = ready_lines(procs)
            assert ready[0]["processes"] == 4 and ready[0]["meshes"] == 2
            assert [c["process"] for c in ready[0]["cards"]] == [0, 1, 2, 3]
            assert [r["role"] for r in ready[1:]] == ["rank-host"] * 3
            (srv,) = wait_servers(fd, 1)
            assert srv["server_id"] == "span" and srv["devices"] == 2
            host1 = procs[1].pid
            ranks = [c for c in children(host1)
                     if "spawn_main" in cmdline(c)]
            assert len(ranks) == 1
            descendants = children(host1)
            others = [c for p in (procs[0], procs[2], procs[3])
                      for c in children(p.pid)]
            os.kill(ranks[0], signal.SIGSTOP)
            with FabricClient(fd.host, fd.port) as client:
                fut = client.submit(req)
                t_end = time.monotonic() + 60
                while not fd.status()["servers"][0].get("inflight") and \
                        time.monotonic() < t_end:
                    time.sleep(0.01)
                time.sleep(0.5)
                procs[1].kill()
                r = fut.result(timeout=120)
                again = client.submit(req).result(timeout=120)
            os.kill(ranks[0], signal.SIGCONT)
            t_end = time.monotonic() + 30
            while any(running(p) for p in descendants) and \
                    time.monotonic() < t_end:
                time.sleep(0.1)
            lingering = [p for p in descendants if running(p)]
            stats = worker_stats(ready[0])
            procs[0].kill()
            codes = [p.wait(timeout=60) for p in procs]
            t_end = time.monotonic() + 30
            while any(running(p) for p in others) and \
                    time.monotonic() < t_end:
                time.sleep(0.1)
            lingering += [p for p in others if running(p)]
        finally:
            stop(procs, signal.SIGKILL)
    errs = [(tmp_path / f"p{i}.err").read_text()[-2000:] for i in range(4)]
    # the server's own failover: one front-door attempt, two meshes
    assert r.ok and r.worker == 1, (r.error, r.detail, errs)
    assert again.ok and again.worker == 1
    assert np.array_equal(r.assignment, again.assignment)
    assert stats["retried"] == 1 and stats["per_worker_served"] == [0, 2]
    assert [w["alive"] for w in stats["workers"]] == [False, True]
    assert lingering == []
    assert codes == [-signal.SIGKILL, -signal.SIGKILL, 1, 1], errs
    assert all("process 0 of the group is gone" in e for e in errs[2:])


def test_a_carve_that_does_not_fit_exits_2(limit, tmp_path):
    with FrontDoor(lease_ttl_s=5.0) as fd, \
            torch_dist_jobs.held_port() as port:
        procs = torch_dist_jobs.fabric_group(fd, 2, 2, "big", str(tmp_path),
                                             port, meshes=2)
        limit.extend(procs)
        try:
            codes = [p.wait(timeout=120) for p in procs]
        finally:
            stop(procs, signal.SIGKILL)
        assert status_of(fd.host, fd.port)["servers"] == []
    want = ("cannot carve 2 slice(s) of 2 device(s) (4 total): only 2 "
            "device(s) available; largest feasible: 1 slice(s) of 2, or 2 "
            "slice(s) of 1 device(s)")
    errs = [(tmp_path / f"p{i}.err").read_text() for i in range(2)]
    assert codes == [2, 2], errs
    assert all(want in e for e in errs)


# ---------------------------------------------------------------------------
# the check-in before a process leaves the group
# ---------------------------------------------------------------------------

def stores(kind):
    """Two handles of one store, for ranks 0 and 1: one ``HashStore``, or
    a ``TCPStore`` on a port of its own (rank 0's serves it)."""
    import datetime
    if kind == "hash":
        store = torch.distributed.HashStore()
        return store, store
    timeout = datetime.timedelta(seconds=30)
    server = torch.distributed.TCPStore("127.0.0.1", 0, 2, True,
                                        timeout=timeout,
                                        wait_for_workers=False)
    return server, torch.distributed.TCPStore("127.0.0.1", server.port, 2,
                                              False, timeout=timeout)


@pytest.mark.parametrize("kind", ["hash", "tcp"])
@pytest.mark.parametrize("first", [0, 1])
def test_check_in_returns_only_once_every_process_has_checked_in(kind,
                                                                 first):
    """The first caller, rank 0 or 1, waits for the second; rank 0 (the
    store's host in a group) returns only after rank 1 has counted itself
    out."""
    import threading
    store = stores(kind)
    done = {}

    def call(rank):
        group.check_in(store[rank], rank, 2, 30.0)
        done[rank] = time.monotonic()

    t = threading.Thread(target=call, args=(first,))
    t.start()
    time.sleep(0.5)
    assert t.is_alive() and not done
    second_at = time.monotonic()
    call(1 - first)
    t.join(30.0)
    assert not t.is_alive()
    assert min(done.values()) >= second_at
    assert store[0].add(group.ARRIVED_KEY, 0) == 2
    assert store[0].add(group.DEPARTED_KEY, 0) == 1


@pytest.mark.parametrize("rank, n, peers_in, missing", [
    (0, 2, 0, "1 of the group's 2 processes never checked in within 0.3 s"),
    (1, 2, 0, "1 of the group's 2 processes never checked in within 0.3 s"),
    (0, 3, 0, "2 of the group's 3 processes never checked in within 0.3 s"),
    (0, 2, 1, "1 of the group's 2 processes never counted itself out after "
     "the check-in within 0.3 s"),
])
def test_check_in_alone_raises_naming_the_missing_count(rank, n, peers_in,
                                                        missing):
    """A caller whose peers never check in (or, for rank 0, check in and
    never count themselves out) raises within its bound, naming how many
    are missing."""
    store = torch.distributed.HashStore()
    if peers_in:
        store.add(group.ARRIVED_KEY, peers_in)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as exc:
        group.check_in(store, rank, n, 0.3)
    assert str(exc.value) == missing
    assert 0.3 <= time.monotonic() - t0 < 10


def card(process, device="cuda:0", uuid="GPU-0", hostname="h0"):
    return group.GroupCard(process, f"10.0.0.{process}", hostname, device,
                           uuid)


@pytest.mark.parametrize("slices, clash", [
    ([[card(0), card(1, uuid="GPU-1")]], None),
    ([[card(0), card(1)]], "mesh 0 would hold card cuda:0 of h0 (GPU-0) "
     "twice: processes 0 and 1"),
    ([[card(0, "cpu", None), card(1, "cpu", None)]], None),
    ([[card(0, uuid=None), card(1, uuid=None, hostname="h1")]], None),
    ([[card(0, uuid=None), card(1, uuid=None)]], "card cuda:0 of h0 (no "
     "UUID) twice: processes 0 and 1"),
    ([[card(0), card(1, uuid="GPU-1")], [card(2, uuid="GPU-2"),
                                         card(3, "cuda:1", "GPU-2")]],
     "mesh 1 would hold card cuda:1 of h0 (GPU-2) twice: processes 2 and 3"),
])
def test_check_cards_names_a_card_a_mesh_holds_twice(slices, clash):
    if clash is None:
        group.check_cards(slices)
        return
    with pytest.raises(RuntimeError, match="NCCL refuses") as exc:
        group.check_cards(slices)
    assert clash in str(exc.value)


def test_carve_of_listed_cards_keeps_process_order():
    pool = [card(i, uuid=f"GPU-{i}") for i in range(5)]
    assert runtime.carve(pool, 2, 2) == [pool[:2], pool[2:4]]
    with pytest.raises(RuntimeError, match=r"cannot carve 3 slice\(s\) of "
                       r"2 device\(s\) \(6 total\): only 5"):
        runtime.carve(pool, 3, 2)


START = ("import sys\n"
         "from repro_torch.api import runtime\n"
         "runtime.MESH_START_TIMEOUT_S = 1.0\n"
         "from repro_torch.launch.fabric import main\n"
         "sys.exit(main(sys.argv[1:]))\n")


def test_a_group_missing_a_process_exits_2_within_its_bound(limit):
    """Process 0 of one group of two and process 1 of another start alone
    (the start-up bound cut to 1 s): each exits 2, naming its group,
    within the bound."""
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.monotonic()
    with torch_dist_jobs.held_port() as port0, \
            torch_dist_jobs.held_port() as port1:
        procs = [subprocess.Popen(
            [sys.executable, "-c", START, "worker", "--devices-per-mesh",
             "2", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(alone)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
            for alone, port in ((0, port0), (1, port1))]
        limit.extend(procs)
        outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 2, err[-2000:]
        assert out == ""
        assert "group of 2 process(es) did not form within 1 s" in err
    assert time.monotonic() - t0 < 60


SILENT = ("import sys, time\n"
          "from repro_torch.api import runtime\n"
          "runtime.distributed_init(sys.argv[1], 2, int(sys.argv[2]), "
          "device='cpu', timeout_s=120)\n"
          "print('joined', flush=True)\n"
          "time.sleep(300)\n")


@pytest.mark.parametrize("silent", [1, 0])
def test_a_process_whose_peer_never_checks_in_exits_2(limit, silent):
    """A worker process whose peer joins the group and never checks in
    (the check-in's bound cut to 10 s) exits 2 naming the missing count,
    with no ready line, whether the silent peer is the store's host or
    not."""
    env = child_env(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    code = START.replace("= 1.0", "= 10.0")
    with torch_dist_jobs.held_port() as port:
        addr = f"127.0.0.1:{port}"
        peer = subprocess.Popen(
            [sys.executable, "-c", SILENT, addr, str(silent)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        worker = subprocess.Popen(
            [sys.executable, "-c", code, "worker", "--device", "cpu",
             "--coordinator", addr, "--num-processes", "2",
             "--process-id", str(1 - silent)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        limit.extend([peer, worker])
        try:
            out, err = worker.communicate(timeout=120)
            joined = peer.stdout.readline()
        finally:
            peer.kill()
            peer.communicate()
    assert joined == "joined\n"
    assert worker.returncode == 2, err[-2000:]
    assert out == ""
    assert ("fabric worker: 1 of the group's 2 processes never checked in "
            "within 10 s") in err


# ---------------------------------------------------------------------------
# the reference's fault
# ---------------------------------------------------------------------------

PROBE = ("import json, sys\n"
         "from repro.api.runtime import device_slices, distributed_init\n"
         "distributed_init(sys.argv[1], 2, int(sys.argv[2]))\n"
         "print(json.dumps([str(d) for d in device_slices(1, 2)[0]]))\n")


def test_reference_carves_meshes_over_the_whole_group(limit):
    """Two JAX processes joined by the reference's ``distributed_init``
    both see the group's two devices, one local to each, and both carve
    the same slice over them: each would build, and register, a server on
    a mesh that spans the other process (ROADMAP queue 3, item 8)."""
    pytest.importorskip("jax")
    env = child_env(drop=("XLA_FLAGS",), PYTHONPATH=str(ROOT / "src"),
                    JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    with torch_dist_jobs.held_port() as port:
        procs = [subprocess.Popen([sys.executable, "-c", PROBE,
                                   f"127.0.0.1:{port}", str(i)], cwd=ROOT,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for i in range(2)]
        limit.extend(procs)
        outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    slices = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert slices[0] == slices[1] and len(slices[0]) == 2
    assert len(set(slices[0])) == 2
