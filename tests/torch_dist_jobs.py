"""Run jobs of the distributed engine through the JAX reference or the port
(a helper of ``tests/test_torch_dist_*.py``, run as a script).

    python tests/torch_dist_jobs.py ref  JOBS.json OUT.pkl
    python tests/torch_dist_jobs.py port JOBS.json OUT.pkl
    python tests/torch_dist_jobs.py refcli [repro.launch.partition flags]

A job is a dict: ``id``, ``kind``, ``P``, ``graph`` ([family, n, avg_deg,
seed]) and the kind's own fields. Both packages get the same graph (the
generators are copies) and the same inputs, drawn here from numpy with the
job's ``seed_in``; the results are numpy arrays, ints and lists, pickled
as ``{id: result}``.

``ref`` runs every job in this process on forced host devices. jax 0.9's
``jax.shard_map`` takes ``check_vma`` where the reference passes
``check_rep``; the reference binds ``shard_map`` at import, so the
``shard_map`` attribute of its four ``dist`` modules is rebound to a
wrapper that drops ``check_rep`` and passes ``check_vma=False``. Nothing
in ``src/repro/`` changes.

``port`` spawns, for each P, one process a rank (gloo, the CPU, one thread
each; every P's group at once), each of which joins its group through
``repro_torch.api.runtime.distributed_init`` and runs that P's jobs in
order. Results come from rank 0, with ``same_on_every_rank`` recording
that every rank returned the same bytes.

The ``session`` and ``server`` kinds serve a mix of requests (``reqs``:
dicts of a graph, ``as`` "spec" or "graph", ``k``, ``devices``,
``backend``, ``config`` and further request fields) through the package's
own ``PartitionSession(devices=P)`` (a ``run_batch``) or
``PartitionServer(meshes=2, devices_per_mesh=P)``. They run in the
script's own process: the reference's on its forced host devices, the
port's on meshes of gloo rank processes that its session and server
spawn themselves.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import socket
import sys

import numpy as np
from torch_threads import child_env

TIMINGS = ("time_s", "exchange_s", "precontract_s")


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in TIMINGS}


def _inputs(job, n):
    """The job's numpy inputs: a partition, LP labels, budgets."""
    rng = np.random.default_rng(job.get("seed_in", 0))
    k = job.get("k", 4)
    part = rng.integers(0, k, n)
    if job.get("skew"):
        part[:n // 3] = 0                       # overload block 0
    labels = rng.integers(0, max(1, n // job.get("cluster_div", 4)), n)
    return part.astype(np.int64), labels.astype(np.int64)


def _lmax(g, k):
    total = int(np.asarray(g.vweights).sum())
    return np.full(k, int(np.ceil(1.03 * total / k)) + 1, dtype=np.int64)


def _shards_dict(sh):
    return {f: getattr(sh, f) for f in (
        "P", "n", "n_loc", "m_loc", "n_ghost", "halo_width", "offsets",
        "arc_src", "arc_dst_idx", "arc_w", "vweights", "local_gid",
        "ghost_gid", "send_idx", "recv_slot")}


def _graph_dict(g):
    return {f: np.asarray(getattr(g, f)) for f in (
        "indptr", "adjncy", "eweights", "vweights")}


def _collective_inputs(P, p):
    slab = (np.arange(P * 3, dtype=np.int32).reshape(P, 3) * 7
            + 1000 * p).astype(np.int32)
    shard = np.array([p, -p, 3 * p + 1], dtype=np.int32)
    dense = (np.arange(P * 2, dtype=np.int32) * (p + 1) - p).astype(np.int32)
    counts = ((np.arange(P) + p) % 3).astype(np.int32)
    return slab, shard, dense, counts


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def install_reference_shim(devices: int = 6):
    """Force ``devices`` host devices (before jax starts) and rebind the
    reference's ``shard_map`` (module docstring). Returns the wrapper."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices}"
    import jax

    def shard_map(f=None, **kw):
        kw.pop("check_rep", None)
        kw["check_vma"] = False
        return jax.shard_map(f, **kw)

    import repro.dist.compat as compat
    import repro.dist.dist_balance as dist_balance
    import repro.dist.dist_contraction as dist_contraction
    import repro.dist.dist_lp as dist_lp
    for mod in (dist_lp, dist_contraction, dist_balance, compat):
        mod.shard_map = shard_map
    return shard_map


def _ref_collectives(job, shard_map):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro.dist import collectives as C
    from repro.dist.dist_lp import make_mesh_1d
    from repro.graphs import generators
    from repro.graphs.distribute import distribute_graph
    P, use_grid = job["P"], job["use_grid"]
    mesh = make_mesh_1d(P)
    ins = [_collective_inputs(P, p) for p in range(P)]
    sh = distribute_graph(generators.make(*job["graph"]), P)
    vals = np.where(sh.local_gid < sh.n, sh.local_gid * 3 + 1, 0) \
        .astype(np.int32)

    def per_pe(slab, shard, dense, counts, v, si, rs):
        slab, shard, dense, counts = slab[0], shard[0], dense[0], counts[0]
        a2a = C.all_to_all(slab, "pe", P, use_grid=use_grid)
        gat = C.all_gather_1d(shard, "pe", P, use_grid=use_grid)
        bgat = C.all_gather_1d(shard > 0, "pe", P, use_grid=use_grid)
        sca = C.psum_scatter_1d(dense, "pe", P, use_grid=use_grid)
        seg, segc = C.exchange_segments(slab[:, :, None] * jnp.ones(
            (1, 1, 2), jnp.int32), counts, "pe", P, use_grid=use_grid)
        halo = C.halo_exchange(v[0], si[0], rs[0], sh.n_ghost, "pe", P,
                               use_grid=use_grid)
        return tuple(x[None] for x in (a2a, gat, bgat, sca, seg, segc,
                                       halo))

    pe = PS("pe")
    fn = shard_map(per_pe, mesh=mesh, in_specs=(pe,) * 7,
                   out_specs=(pe,) * 7)
    outs = fn(*(jnp.asarray(np.stack([x[i] for x in ins]))
                for i in range(4)),
              jnp.asarray(vals), jnp.asarray(sh.send_idx),
              jnp.asarray(sh.recv_slot))
    names = ("all_to_all", "all_gather_1d", "all_gather_bool",
             "psum_scatter_1d", "exchange_segments", "segment_counts",
             "halo_exchange")
    return {k: np.asarray(v) for k, v in zip(names, outs)}


def _run(job, pkg, pe=None, shard_map=None):
    """One job through package ``pkg`` ("repro" or "repro_torch")."""
    import importlib
    gen = importlib.import_module(f"{pkg}.graphs.generators")
    distribute = importlib.import_module(f"{pkg}.graphs.distribute")
    kind, P = job["kind"], job["P"]
    if kind in ("session", "server"):
        return _serve_mix(job, pkg)
    g = gen.make(*job["graph"])
    # the reference builds its mesh itself; the port takes its group
    dkw = {} if pe is None else {"pe": pe}
    if pkg == "repro":
        job = dict(job, kernel="composed")   # its Pallas kernels are broken
    if kind == "collectives":
        if pkg == "repro":
            return _ref_collectives(job, shard_map)
        return _port_collectives(job, pe)
    if kind == "distribute":
        return _shards_dict(distribute.distribute_graph(g, P))
    if kind in ("impl", "backend"):
        return _run_partition(job, pkg, g, pe)
    sh = distribute.distribute_graph(g, P)
    part, labels = _inputs(job, g.n)
    use_grid = job.get("use_grid", False)
    if kind == "cluster":
        lp = importlib.import_module(f"{pkg}.dist.dist_lp")
        return lp.dist_cluster(sh, job["W"], num_iterations=2,
                               num_chunks=job.get("chunks", 4),
                               seed=job.get("seed", 0), use_grid=use_grid,
                               weights=job["weights"],
                               kernel=job["kernel"], **dkw)
    if kind in ("lp_refine", "ulp_refine"):
        lp = importlib.import_module(f"{pkg}.dist.dist_lp")
        fn = lp.dist_lp_refine if kind == "lp_refine" else lp.dist_ulp_refine
        return fn(sh, part, _lmax(g, job["k"]), num_iterations=2,
                  num_chunks=job.get("chunks", 4), seed=job.get("seed", 0),
                  use_grid=use_grid, weights=job["weights"], **dkw)
    if kind == "rebalance":
        bal = importlib.import_module(f"{pkg}.dist.dist_balance")
        stats = {}
        out = bal.dist_rebalance(sh, part, _lmax(g, job["k"]),
                                 top_m=job.get("top_m", 16),
                                 seed=job.get("seed", 0), use_grid=use_grid,
                                 weights=job["weights"],
                                 kernel=job["kernel"], stats=stats, **dkw)
        return {"part": out, "stats": _strip(stats)}
    if kind == "enforce":
        bal = importlib.import_module(f"{pkg}.dist.dist_balance")
        stats = {}
        out = bal.dist_enforce_cluster_weights(sh, labels, job["W"],
                                               use_grid=use_grid,
                                               stats=stats, **dkw)
        return {"labels": out, "stats": _strip(stats)}
    if kind == "contract":
        con = importlib.import_module(f"{pkg}.dist.dist_contraction")
        res = con.dist_contract(sh, labels, use_grid=use_grid,
                                kernel=job["kernel"], **dkw)
        return {"mapping": res.mapping, "graph": _graph_dict(res.graph),
                "shards": _shards_dict(res.shards),
                "stats": _strip(res.stats)}
    raise ValueError(f"unknown job kind {kind!r}")


def _run_partition(job, pkg, g, pe):
    import importlib
    dp = importlib.import_module(f"{pkg}.core.deep_mgp")
    cfg = dp.PartitionerConfig(**dict(job["config"], kernel=job["kernel"]))
    if job["kind"] == "impl":
        part_mod = importlib.import_module(f"{pkg}.dist.dist_partitioner")
        trace = []
        kw = {} if pe is None else {"pe": pe}
        part = part_mod.dist_partition_impl(g, job["k"], job["P"], cfg=cfg,
                                            use_grid=job["use_grid"],
                                            trace=trace, **kw)
        return {"part": part, "trace": [_strip(r) for r in trace]}
    api = importlib.import_module(f"{pkg}.api")
    req = api.PartitionRequest(graph=g, k=job["k"], devices=job["P"],
                               backend=job["backend"], config=cfg,
                               **job.get("request", {}))
    eng = api.Partitioner(device="cpu") if pkg == "repro_torch" \
        else api.Partitioner()
    res = eng.run(req)
    summary = res.summary()
    summary.pop("time_s")
    return {"part": res.assignment, "cut": res.cut,
            "feasible": res.feasible, "summary": summary,
            "trace": [_strip(r) for r in res.trace]}


def build_requests(pkg, reqs, kernel="composed"):
    """The ``reqs`` of a serving job as ``pkg``'s requests."""
    import importlib
    api = importlib.import_module(f"{pkg}.api")
    gen = importlib.import_module(f"{pkg}.graphs.generators")
    dp = importlib.import_module(f"{pkg}.core.deep_mgp")
    out = []
    for d in reqs:
        graph = api.GraphSpec(*d["graph"]) if d["as"] == "spec" \
            else gen.make(*d["graph"])
        cfg = dp.PartitionerConfig(**dict(d["config"], kernel=kernel))
        out.append(api.PartitionRequest(
            graph=graph, k=d["k"], devices=d["devices"],
            backend=d.get("backend", "auto"), config=cfg,
            **d.get("request", {})))
    return out


def served(res):
    """A served ``PartitionResult`` as the serving tests compare it."""
    summary = res.summary()
    summary.pop("time_s")
    return {"part": res.assignment, "cut": res.cut,
            "feasible": res.feasible, "backend": res.backend,
            "summary": summary, "trace": [_strip(r) for r in res.trace]}


def _serve_mix(job, pkg):
    import importlib
    P = job["P"]
    port = pkg == "repro_torch"
    kw = {"device": "cpu"} if port else {}
    reqs = build_requests(pkg, job["reqs"],
                          job.get("kernel", "composed") if port
                          else "composed")
    if job["kind"] == "session":
        api = importlib.import_module(f"{pkg}.api")
        with api.PartitionSession(devices=P, max_workers=4, **kw) as sess:
            res = sess.run_batch(reqs)
            out = {"results": [served(r) for r in res]}
            if port:
                out["mesh_calls"] = sess.mesh.calls
        return out
    serve = importlib.import_module(f"{pkg}.serve")
    with serve.PartitionServer(meshes=2, devices_per_mesh=P, **kw) as srv:
        res = srv.serve(reqs)
        st = srv.stats()
        calls = [w.mesh.calls for w in srv.workers] if port else None
    return {"results": [served(r.result) if r.ok else
                        {"error": r.error, "detail": r.detail}
                        for r in res],
            "per_worker_served": st["per_worker_served"],
            "mesh_calls": calls}


@contextlib.contextmanager
def time_limit(seconds):
    """Hold a test's block to ``seconds``. Past them a watchdog SIGKILLs
    this process's ``multiprocessing`` children (mesh ranks) and the
    ``subprocess.Popen``s added to the yielded list, which ends every
    wait on them at once (a mesh's owner waits on its ranks' process
    sentinels, a reader on a pipe sees its end), and the test fails
    naming the limit. Should the block still not return within a minute
    more, faulthandler prints every thread's stack and ends the process:
    nothing hangs."""
    import faulthandler
    import multiprocessing
    import threading

    import pytest
    procs: list = []
    fired = threading.Event()

    def expire():
        fired.set()
        for p in multiprocessing.active_children():
            p.kill()
        for p in procs:
            if p.poll() is None:
                p.kill()

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(seconds + 60, exit=True)
    try:
        yield procs
    finally:
        timer.cancel()
        faulthandler.cancel_dump_traceback_later()
        if fired.is_set():
            pytest.fail(f"the test ran past its limit of {seconds} s",
                        pytrace=False)


def run_both(jobs, tmp_dir, timeout=900):
    """Run ``jobs`` through the reference and the port at once, in two
    subprocesses: ``(ref, port)`` result dicts."""
    return start_both(jobs, tmp_dir)(timeout)


def start_both(jobs, tmp_dir):
    """Start ``run_both``'s two subprocesses and return the function
    that waits for them (``timeout`` seconds) and returns their results,
    so that a caller can do other work meanwhile."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jobs_path = os.path.join(tmp_dir, "jobs.json")
    with open(jobs_path, "w") as fh:
        json.dump(jobs, fh)
    env = child_env(PYTHONPATH=os.path.join(root, "src"),
                    JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    procs = {}
    for which in ("ref", "port"):
        out = os.path.join(tmp_dir, f"{which}.pkl")
        err = os.path.join(tmp_dir, f"{which}.err")
        with open(err, "w") as fh:
            procs[which] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), which,
                 jobs_path, out], cwd=root, env=env,
                stdout=subprocess.DEVNULL, stderr=fh), out, err)

    def finish(timeout=900):
        res = []
        for which, (pr, out, err) in procs.items():
            try:
                pr.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p[0].kill()
                raise
            if pr.returncode != 0:
                with open(err) as fh:
                    tail = fh.read()[-4000:]
                raise RuntimeError(f"{which} jobs failed ({pr.returncode}):"
                                   f"\n{tail}")
            with open(out, "rb") as fh:
                res.append(pickle.load(fh))
        return tuple(res)

    return finish


def _ref_main(jobs, out):
    """Every job once per distinct input: the reference runs composed
    whatever the job's kernel mode, so the fused twin reuses the result."""
    shard_map = install_reference_shim()
    res, seen = {}, {}
    for j in jobs:
        key = json.dumps({k: v for k, v in j.items()
                          if k not in ("id", "kernel")}, sort_keys=True)
        if key not in seen:
            seen[key] = _run(j, "repro", shard_map=shard_map)
        res[j["id"]] = seen[key]
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _ref_cli(argv):
    """The reference's partition CLI, through the shim."""
    install_reference_shim()
    from repro.launch import partition
    sys.argv = ["repro.launch.partition"] + list(argv)
    return partition.main()


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def _port_collectives(job, pe):
    import torch
    from repro_torch.dist import collectives as C
    from repro_torch.graphs import generators
    from repro_torch.graphs.distribute import distribute_graph
    P, p, use_grid = job["P"], pe.rank, job["use_grid"]
    slab, shard, dense, counts = (torch.from_numpy(x) for x in
                                  _collective_inputs(P, p))
    sh = distribute_graph(generators.make(*job["graph"]), P)
    vals = np.where(sh.local_gid < sh.n, sh.local_gid * 3 + 1, 0) \
        .astype(np.int32)
    seg, segc = C.exchange_segments(
        slab[:, :, None].expand(P, 3, 2).contiguous(), counts, pe,
        use_grid=use_grid)
    mine = {
        "all_to_all": C.all_to_all(slab, pe, use_grid=use_grid),
        "all_gather_1d": C.all_gather_1d(shard, pe, use_grid=use_grid),
        "all_gather_bool": C.all_gather_1d(shard > 0, pe,
                                           use_grid=use_grid),
        "psum_scatter_1d": C.psum_scatter_1d(dense, pe, use_grid=use_grid),
        "exchange_segments": seg, "segment_counts": segc,
        "halo_exchange": C.halo_exchange(
            torch.from_numpy(vals[p]), torch.from_numpy(sh.send_idx[p]),
            torch.from_numpy(sh.recv_slot[p]), sh.n_ghost, pe,
            use_grid=use_grid)}
    import torch.distributed as dist
    every = [None] * P
    dist.all_gather_object(every, {k: v.numpy() for k, v in mine.items()})
    return {k: np.stack([e[k] for e in every]) for k in mine}


def _digest(obj) -> str:
    return hashlib.sha256(pickle.dumps(obj)).hexdigest()


def _rank(rank, P, port, jobs, path):
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.api import runtime
    from repro_torch.dist import world_group
    runtime.distributed_init(f"127.0.0.1:{port}", P, rank, device="cpu")
    pe = world_group("cpu")
    res = {}
    for job in jobs:
        out = _run(job, "repro_torch", pe=pe)
        every = [None] * P
        dist.all_gather_object(every, _digest(out))
        res[job["id"]] = out
        res[job["id"] + ":same_on_every_rank"] = len(set(every)) == 1
    if rank == 0:
        with open(path, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def held_port():
    """A free port of 127.0.0.1 for a group's coordinator, held for the
    block. The socket stays bound with ``SO_REUSEADDR`` and never listens:
    the kernel then gives the port to no other ``bind`` to port 0 and to
    no outgoing connection, while the coordinator's store, which binds
    with ``SO_REUSEADDR`` too, still can. Released at once, the port could
    go to another test's socket before the coordinator's process gets to
    bind it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    try:
        yield s.getsockname()[1]
    finally:
        s.close()


def fabric_group(frontdoor, n, devices_per_mesh, server_id, err_dir, port,
                 meshes=1):
    """Start the ``n`` processes of a fabric worker group (``python -m
    repro_torch.launch.fabric worker --num-processes n``, ``--device cpu``
    over gloo, no card visible) registered with ``frontdoor``, their
    coordinator at ``port`` (``held_port``): their ``Popen``s, process 0
    first, each reading its stdout (the ready line) and writing its stderr
    to ``err_dir/p<I>.err``."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = child_env(PYTHONPATH=os.path.join(root, "src"),
                    CUDA_VISIBLE_DEVICES="")
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for i in range(n):
        with open(os.path.join(err_dir, f"p{i}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.fabric",
                 "worker", "--frontdoor", f"{frontdoor.host}:"
                 f"{frontdoor.port}", "--server-id", server_id,
                 "--meshes", str(meshes), "--devices-per-mesh",
                 str(devices_per_mesh), "--device", "cpu",
                 "--heartbeat-s", "0.3", "--coordinator", coordinator,
                 "--num-processes", str(n), "--process-id", str(i)],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=err,
                text=True))
    return procs


def loaded_reference_modules(pe):
    """On a mesh's rank: the JAX modules and the reference's it loaded."""
    return sorted(m for m in sys.modules if m in ("jax", "repro")
                  or m.startswith(("jax.", "jaxlib", "repro.")))


def raise_on(pe, ranks):
    """On a mesh's rank: raise a ``ValueError`` on ``ranks``."""
    if pe.rank in ranks:
        raise ValueError("refused on this rank")
    return pe.rank in ranks


def _port_main(jobs, out):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    by_p = {}
    owner = [j for j in jobs if j["kind"] in ("session", "server")]
    jobs = [j for j in jobs if j not in owner]
    for j in jobs:
        by_p.setdefault(j["P"], []).append(j)
    tmp = os.path.dirname(os.path.abspath(out))
    procs, paths = [], []
    with contextlib.ExitStack() as ports:
        for P, js in sorted(by_p.items()):
            port = ports.enter_context(held_port())
            path = os.path.join(tmp, f"port-P{P}.pkl")
            paths.append(path)
            for r in range(P):
                pr = ctx.Process(target=_rank, args=(r, P, port, js, path))
                pr.start()
                procs.append(pr)
        # the serving jobs spawn their own meshes, from this process
        res = {j["id"]: _run(j, "repro_torch") for j in owner}
        for pr in procs:
            pr.join()
    bad = [pr.exitcode for pr in procs if pr.exitcode != 0]
    if bad:
        raise SystemExit(f"port ranks failed: exit codes {bad}")
    for path in paths:
        with open(path, "rb") as f:
            res.update(pickle.load(f))
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    if sys.argv[1] == "refcli":
        sys.exit(_ref_cli(sys.argv[2:]))
    which, jobs_path, out_path = sys.argv[1:4]
    with open(jobs_path) as fh:
        jobs_in = json.load(fh)
    (_ref_main if which == "ref" else _port_main)(jobs_in, out_path)
