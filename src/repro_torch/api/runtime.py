"""Runtime/device helpers — port of ``repro.api.runtime``.

``device_count`` and ``device_slices`` carve the CUDA devices of this
process. ``distributed_init`` is the multi-process runtime of the
distributed engine (``dist/``): one process a PE, joined in a
``torch.distributed`` group (NCCL on the cards, gloo when the CPU is
asked for); in single-process mode it is a deliberate no-op, so the same
entry point runs unchanged on a laptop, in CI and on one card.
``pe_group`` gives the ``dist`` backends the group of a request's P
ranks, and makes a one-rank group for a one-device request when none is
initialised.

``PeMesh`` is the port's device mesh (the reference's 1-D ``"pe"`` mesh
of P devices in one process): P rank processes, spawned once and kept
for the mesh's life, each joined to its own group of P through
``distributed_init`` (NCCL on its card, gloo for CPU ranks). The process
that owns the mesh sends each call to every rank and reads the answers
back; it never takes part in the collectives, so one process can own
several meshes. A mesh of a fabric worker that spans a group of
processes (``api.group``) may have ranks that another process of the
group hosts. Nothing here touches a device at import.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import socket
import threading
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Sequence


def device_count() -> int:
    """CUDA devices visible to this process (0 without CUDA)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def carve(pool: Sequence, num_slices: int,
          devices_per_slice: int) -> List[list]:
    """``num_slices`` disjoint contiguous slices of ``devices_per_slice``
    entries of ``pool`` each, in its order: the carve of
    ``device_slices``, over this process's cards or over a group's
    (``api.group.GroupOwner.carve``).

    Raises ``RuntimeError`` when the pool holds fewer than ``num_slices *
    devices_per_slice`` entries — oversubscribing a device into two
    meshes would serialize their work against each other, which is
    exactly what a multi-mesh tier exists to avoid."""
    if num_slices < 1 or devices_per_slice < 1:
        raise ValueError(
            "need num_slices >= 1 and devices_per_slice >= 1, got "
            f"{num_slices} x {devices_per_slice}")
    have = len(pool)
    need = num_slices * devices_per_slice
    if have < need:
        # name the shortfall AND the largest feasible carve, both ways
        # round — the caller decides whether to shrink the slice count
        # or the slices themselves
        feas_slices = have // devices_per_slice
        feas_per = have // num_slices
        if feas_slices >= 1:
            hint = (f"largest feasible: {feas_slices} slice(s) of "
                    f"{devices_per_slice}")
            if feas_per >= 1 and feas_per != devices_per_slice:
                hint += (f", or {num_slices} slice(s) of {feas_per} "
                         "device(s)")
        elif feas_per >= 1:
            hint = (f"largest feasible: {num_slices} slice(s) of "
                    f"{feas_per} device(s)")
        else:
            hint = "no carve of this shape is feasible"
        raise RuntimeError(
            f"cannot carve {num_slices} slice(s) of {devices_per_slice} "
            f"device(s) ({need} total): only {have} device(s) "
            f"available; {hint}")
    pool = list(pool)
    return [pool[i * devices_per_slice:(i + 1) * devices_per_slice]
            for i in range(num_slices)]


def device_slices(num_slices: int, devices_per_slice: int) -> List[list]:
    """Carve this process's CUDA devices into ``num_slices`` disjoint
    contiguous slices of ``devices_per_slice`` devices each (the serving
    tier's worker meshes: one server per device group); ``carve``
    raises when the process has too few."""
    import torch
    return carve([torch.device("cuda", i) for i in range(device_count())],
                 num_slices, devices_per_slice)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device=None,
                     timeout_s: Optional[float] = None) -> dict:
    """The multi-process runtime of the distributed engine: this process
    joins a ``torch.distributed`` group of ``num_processes`` ranks as rank
    ``process_id``, with the group's address ``coordinator_address``
    (``host:port``; rank 0 listens there).

    Arguments fall back to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables.
    ``num_processes`` of 1 (or unset with no coordinator) is the
    single-process mode: a deliberate no-op that returns ``{"mode":
    "single-process", "process_id": 0, "num_processes": 1}``. Ranks are
    validated (``ValueError``). A rank runs on its card by default: NCCL,
    bound to card ``local_device_ids[0]`` (else ``process_id`` modulo the
    cards it sees), and it raises without CUDA; ``device="cpu"`` asks for
    the CPU on purpose and joins with gloo. ``timeout_s`` bounds every
    collective of the group (torch's default when None). Returns ``{"mode":
    "multi-process", "process_id", "num_processes", "backend",
    "device"}``."""
    coordinator_address = coordinator_address or \
        os.environ.get("REPRO_COORDINATOR") or None
    if num_processes is None:
        env_np = os.environ.get("REPRO_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if process_id is None:
        env_pid = os.environ.get("REPRO_PROCESS_ID")
        process_id = int(env_pid) if env_pid else None
    if coordinator_address is None and (num_processes or 1) <= 1:
        return {"mode": "single-process", "process_id": 0,
                "num_processes": 1}
    if num_processes is not None and num_processes < 1:
        raise ValueError(
            f"num_processes must be >= 1, got {num_processes}")
    if process_id is not None and num_processes is not None and \
            not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for "
            f"{num_processes} process(es)")
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError(
            "the multi-process runtime needs the coordinator address, the "
            "process count and this process's id (arguments or "
            "REPRO_COORDINATOR / REPRO_NUM_PROCESSES / REPRO_PROCESS_ID), "
            f"got {coordinator_address!r}, {num_processes}, {process_id}")
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "distributed_init: this process already belongs to a "
            "torch.distributed group")
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        from ..kernels.dispatch import resolve_device
        resolve_device(device)           # raises without CUDA
        local = local_device_ids[0] if local_device_ids else \
            process_id % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    kw = {} if timeout_s is None else \
        {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return {"mode": "multi-process", "process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(), "backend": backend,
            "device": str(dev)}


def pe_group(P: int, device):
    """The ``dist.PeGroup`` a ``dist`` backend runs a P-device request
    under: the initialised default group, which must have P ranks and a
    backend that serves ``device`` (gloo the CPU, NCCL a card). With no
    group and P == 1, a one-rank group is made here and kept for the
    process. Raises ``ValueError`` otherwise."""
    import torch
    import torch.distributed as dist
    from ..dist.collectives import world_group
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if P != 1:
            raise ValueError(
                f"a request for {P} devices runs one process a device, "
                "under a torch.distributed group of that size, and none is "
                "initialised: start the ranks with repro_torch.api.runtime."
                "distributed_init (REPRO_COORDINATOR / REPRO_NUM_PROCESSES "
                "/ REPRO_PROCESS_ID), or run launch/partition.py --devices "
                f"{P}")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != P:
        raise ValueError(
            f"a request for {P} devices under a torch.distributed group of "
            f"{dist.get_world_size()} ranks: start {P} ranks with "
            "repro_torch.api.runtime.distributed_init, or run "
            f"launch/partition.py --devices {P}")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(
            f"the torch.distributed group runs {dist.get_backend()}, which "
            f"does not serve {dev}; a rank on {dev} needs {want}")
    return world_group(dev)


# ---------------------------------------------------------------------------
# meshes of rank processes
# ---------------------------------------------------------------------------

# the bound on every collective of a mesh's group: a rank that stops
# answering fails its peers' collectives after this long, not after
# torch's default of minutes
MESH_GROUP_TIMEOUT_S = 120.0
# spawning a rank re-imports torch and joins the group
MESH_START_TIMEOUT_S = 300.0
# fields of a trace record that differ from rank to rank
TIMINGS = ("time_s", "exchange_s", "precontract_s")
# array buffers from this size on travel through shared memory: on an
# H100 host, a mesh call carrying a 2^20 graph (117 MB of buffers) took
# 4.4-4.8 s all through the pipe and 0.45-0.61 s with its buffers in a
# shared-memory block (benchmarks/torch_mesh_transfer.py)
SHM_MIN_BYTES = 1 << 20


class MeshFailure(RuntimeError):
    """A mesh's rank died, failed to start or answered unlike its peers.
    ``mesh.alive`` tells whether the mesh survived it (only a digest
    mismatch leaves the ranks running)."""


class RankOutput(NamedTuple):
    """What a function run on a mesh may return instead of a plain value:
    ``value`` must be the same on every rank (its digest is compared),
    ``local`` may differ (rank 0's is returned)."""
    value: Any
    local: Any = None


class MeshReply(NamedTuple):
    """Rank 0's answer to one ``PeMesh.call`` (its launches and seconds
    go to the mesh's counts: ``PeMesh.launches``, ``call_seconds``)."""
    value: Any
    local: Any


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strip_timings(trace) -> list:
    return [{k: v for k, v in r.items() if k not in TIMINGS}
            for r in trace]


def _pack(obj, shm: bool = True) -> tuple:
    """``obj`` as a pipe message: pickled (protocol 5) with its large
    array buffers out of band, in one shared-memory block whose reader
    unlinks it (``_unpack``). ``shm=False`` keeps every buffer in band,
    for a reader on another host."""
    from multiprocessing import resource_tracker, shared_memory
    if not shm:
        return pickle.dumps(obj, protocol=5), None, ()
    big: list = []

    def in_band(buf) -> bool:
        if buf.raw().nbytes < SHM_MIN_BYTES:
            return True
        big.append(buf)
        return False

    data = pickle.dumps(obj, protocol=5, buffer_callback=in_band)
    if not big:
        return data, None, ()
    sizes = [b.raw().nbytes for b in big]
    shm = shared_memory.SharedMemory(create=True, size=sum(sizes))
    # the reader unlinks the block; this process must not at its exit
    resource_tracker.unregister(shm._name, "shared_memory")
    off = 0
    for b, n in zip(big, sizes):
        shm.buf[off:off + n] = b.raw()
        off += n
    shm.close()
    return data, shm.name, sizes


def _unpack(msg: tuple, unlink: bool = True):
    data, name, sizes = msg
    if name is None:
        return pickle.loads(data)
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=name)
    try:
        bufs, off = [], 0
        for n in sizes:
            bufs.append(bytearray(shm.buf[off:off + n]))
            off += n
    finally:
        shm.close()
        if unlink:
            shm.unlink()
    return pickle.loads(data, buffers=bufs)


def _unlink(msg: tuple) -> None:
    """Drop a packed message's block if its reader has not."""
    if msg[1] is None:
        return
    from multiprocessing import shared_memory
    try:
        shm = shared_memory.SharedMemory(name=msg[1])
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _wait_closed(conn, sentinel, deadline: float) -> None:
    """Read ``conn`` until it ends, its host's ``sentinel`` is ready or
    ``deadline`` passes."""
    from multiprocessing.connection import wait as mp_wait
    while True:
        left = deadline - time.monotonic()
        if left <= 0 or not mp_wait([conn, sentinel], timeout=left) or \
                sentinel.poll():
            return
        try:
            conn.recv()
        except (EOFError, OSError):
            return


def _digest(obj) -> str:
    return hashlib.sha256(pickle.dumps(obj)).hexdigest()


def _error_payload(exc: BaseException) -> tuple:
    try:
        blob = pickle.dumps(exc)
    except Exception:
        blob = None
    return (type(exc).__name__, str(exc),
            "".join(traceback.format_exception(exc))[-4000:], blob)


def _mesh_rank(conn, addr: str, P: int, rank: int, device: str,
               shm: bool = True) -> None:
    """A mesh's rank process: join the group, say ready, then run every
    call the owner sends until it says close or goes away. ``shm``: the
    owner shares this host (its answer's buffers may go through a
    shared-memory block)."""
    try:
        import torch
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads() // P))
        distributed_init(addr, P, rank,
                         local_device_ids=[dev.index] if dev.type == "cuda"
                         else None,
                         device="cpu" if dev.type == "cpu" else device,
                         timeout_s=MESH_GROUP_TIMEOUT_S)
        from ..dist.collectives import world_group
        pe = world_group(dev)
        conn.send(("ready", os.getpid(), pe.backend))
    except BaseException as exc:
        try:
            conn.send(("error", _error_payload(exc)))
        except Exception:
            pass
        return
    from ..kernels import _build
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg[0] == "close":
            break
        before = dict(_build.LAUNCHES)
        try:
            # every rank reads the one block; the owner unlinks it
            fn, args, kwargs = _unpack(msg[1], unlink=False)
            t0 = time.perf_counter()
            out = fn(pe, *args, **kwargs)
            elapsed = time.perf_counter() - t0
            value, local = (out.value, out.local) \
                if isinstance(out, RankOutput) else (out, None)
            launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            reply = ("ok", _digest(value), launches, elapsed,
                     _pack((value, local), shm) if rank == 0 else None)
        except Exception as exc:
            reply = ("error", _error_payload(exc))
        try:
            conn.send(reply)
        except (EOFError, OSError):
            break
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class PeMesh:
    """A 1-D mesh of ``len(devices)`` PEs, one rank process each: the
    port's counterpart of the reference's ``Mesh(devices, ("pe",))``.

    ``devices`` are distinct cards (``device_slices``) or CPU devices
    (gloo ranks, ``torch.device("cpu")`` repeated). The ranks are
    spawned at construction (the ``spawn`` context: CUDA does not
    survive a fork) and kept until ``close``. ``call`` runs one function
    on every rank at a time: two calls' collectives on one group must
    never interleave. While it waits, the owner watches every rank's
    pipe and process, never a collective, so a rank that dies fails the
    call at once: the mesh kills its other ranks and raises
    ``MeshFailure``. Array buffers of 1 MiB and more (a ``Graph``'s
    arrays, an assignment) travel through a shared-memory block, the
    rest of a call and its answer through the pipe.

    With ``group`` (the ``api.group.GroupOwner`` of a fabric worker that
    spans processes), ``devices`` are the group's ``GroupCard``s and a
    rank whose card another process owns is spawned by that process: it
    reaches this one through the group's listener in place of a pipe,
    its buffers travel in band, the mesh group's address is the host of
    the mesh's rank 0, and its death shows through its connection and
    through its host's (``HostLink.sentinel``).
    """

    axis_names = ("pe",)      # a 1-D mesh, as ``dist/sharding.py`` reads it

    def __init__(self, devices: Sequence, wait: bool = True, group=None):
        import multiprocessing as mp

        import torch
        devices = list(devices)
        # each rank's host: None for a child of this process
        self._links = [None] * len(devices) if group is None else \
            [None if c.process == group.process else group.link(c.process)
             for c in devices]
        devs = [torch.device(d if group is None else d.device)
                for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        # a group's cards are its carve's to check (``check_cards``)
        if group is None and kinds == {"cuda"}:
            idx = [d.index for d in devs]
            if None in idx or len(set(idx)) != len(idx):
                raise ValueError(
                    f"a mesh's cards must be distinct and indexed, got "
                    f"{[str(d) for d in devs]}: one rank a card (NCCL "
                    "refuses two ranks of one group on a card)")
            if max(idx) >= device_count():
                raise RuntimeError(
                    f"a mesh over {[str(d) for d in devs]} needs card "
                    f"{max(idx)}, and only {device_count()} card(s) are "
                    "visible; carve meshes with device_slices")
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(
                "a mesh's devices are all cards or all the CPU, got "
                f"{[str(d) for d in devs]}")
        self.devices = devs
        self.size = len(devs)
        self._lock = threading.Lock()           # one call at a time
        self._state = threading.Lock()
        self._alive = True
        self._ready = False
        self._killed = False
        self.failure: Optional[str] = None
        self.calls = 0
        # each answered call's seconds from the send to the last rank's
        # answer, and rank 0's seconds in the function (the difference
        # is the call's transfer cost)
        self.call_seconds: List[float] = []
        self.rank_seconds: List[float] = []
        # every rank's kernel launches over the mesh's calls, by rank
        self.launches: List[Dict[str, int]] = [{} for _ in devs]
        self.backend: Optional[str] = None
        self.pids: List[int] = []
        self._group = group
        self._key = os.urandom(8).hex()        # the mesh, to its hosts
        ctx = mp.get_context("spawn")
        self._conns: list = []
        self._procs: list = []
        try:
            # the group's address: the host of the mesh's rank 0
            if self._links[0] is None:
                host = "127.0.0.1" if group is None else group.host
                addr = f"{host}:{_free_port()}"
            else:
                addr = self._links[0].mesh_address()
            for r, d in enumerate(devs):
                link = self._links[r]
                if link is not None:
                    link.spawn(self._key, r, self.size, addr, str(d))
                    self._conns.append(None)    # it dials in
                    self._procs.append(None)
                    continue
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_mesh_rank, daemon=True,
                    name=f"repro-torch-mesh-rank{r}",
                    args=(child, addr, self.size, r, str(d)))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
        except MeshFailure as exc:
            self._fail(str(exc))
        if wait:
            self.wait_ready()

    @property
    def axis_sizes(self):
        return (self.size,)

    def __repr__(self) -> str:
        return (f"PeMesh(size={self.size}, devices="
                f"{[str(d) for d in self.devices]}, alive={self._alive})")

    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def busy(self) -> bool:
        """A call is in flight (or the ranks are starting)."""
        return self._lock.locked()

    def wait_ready(self) -> "PeMesh":
        """Block until every rank has joined the group; raise
        ``MeshFailure`` (and kill the ranks) if one fails to start."""
        with self._lock:
            if self._ready:
                return self
            if not self._alive:
                raise MeshFailure(f"the mesh is closed: {self.failure}")
            deadline = time.monotonic() + MESH_START_TIMEOUT_S
            for r, link in enumerate(self._links):
                if link is not None and self._conns[r] is None:
                    try:
                        self._conns[r] = self._group.rank_connection(
                            self._key, r, link, deadline)
                    except MeshFailure as exc:
                        self._fail(str(exc))
            msgs = self._collect(
                "start", timeout=max(0.0, deadline - time.monotonic()))
            bad = {r: m for r, m in msgs.items() if m[0] != "ready"}
            if bad:
                r, m = sorted(bad.items())[0]
                self._fail(f"rank {r} of the mesh failed to start: "
                           f"{m[1][0]}: {m[1][1]}\n{m[1][2]}")
            self.pids = [msgs[r][1] for r in range(self.size)]
            self.backend = msgs[0][2]
            self._ready = True
        return self

    # -- calls -------------------------------------------------------------

    def call(self, fn, *args, **kwargs) -> MeshReply:
        """Run ``fn(pe, *args, **kwargs)`` on every rank (``pe`` is the
        rank's ``dist.PeGroup``; ``fn`` a module-level function) and
        return rank 0's answer. Every rank's value must have the same
        digest, else ``MeshFailure``. An exception every rank raised
        alike is raised again here, and the mesh stays up; one that
        differs from rank to rank fails the mesh."""
        self.wait_ready()
        with self._lock:
            if not self._alive:
                raise MeshFailure(f"the mesh is closed: {self.failure}")
            t0 = time.perf_counter()
            # one message for the ranks on this host (buffers in a
            # shared-memory block), one for the others (in band)
            call = (fn, args, kwargs)
            packed = _pack(call) if None in self._links else None
            in_band = _pack(call, shm=False) \
                if any(self._links) else None
            try:
                for r, conn in enumerate(self._conns):
                    try:
                        conn.send(("call", in_band if self._links[r]
                                   else packed))
                    except (OSError, EOFError):
                        self._fail(f"rank {r} of the mesh is gone "
                                   f"({self._exit_text(r)})")
                msgs = self._collect("call")
                ok = msgs[0][0] == "ok"
                reply = _unpack(msgs[0][4]) if ok else None
            finally:
                if packed is not None:
                    _unlink(packed)
            seconds = time.perf_counter() - t0
            self.calls += 1
        if ok:
            with self._state:
                self.call_seconds.append(seconds)
                self.rank_seconds.append(msgs[0][3])
        errors = {r: m[1] for r, m in msgs.items() if m[0] == "error"}
        if errors:
            kinds = {(e[0], e[1]) for e in errors.values()}
            if len(errors) < self.size or len(kinds) > 1:
                text = "; ".join(f"rank {r}: {e[0]}: {e[1]}"
                                 for r, e in sorted(errors.items()))
                self._fail(f"the ranks failed unlike each other ({text})"
                           f"\n{errors[min(errors)][2]}")
            name, text, tb, blob = errors[0]
            exc = None
            if blob is not None:
                try:
                    exc = pickle.loads(blob)
                except Exception:
                    exc = None
            if not isinstance(exc, Exception):
                exc = RuntimeError(f"{name}: {text}")
            exc.add_note(f"raised on every rank of {self!r}; rank 0:\n{tb}")
            raise exc
        digests = [msgs[r][1] for r in range(self.size)]
        if len(set(digests)) != 1:
            raise MeshFailure(
                f"the ranks of {self!r} returned different results "
                f"(digests {[d[:12] for d in digests]})")
        with self._state:
            for r, total in enumerate(self.launches):
                for k, v in msgs[r][2].items():
                    total[k] = total.get(k, 0) + v
        return MeshReply(*reply)

    def reset_counts(self) -> None:
        """Zero the launch counts and the calls' seconds."""
        with self._state:
            self.launches = [{} for _ in self.devices]
            self.call_seconds = []
            self.rank_seconds = []

    def partition(self, req, name: str) -> MeshReply:
        """Run a request's ``dist``/``dist-grid`` backend on every rank:
        ``req.graph`` travels as it is (a ``GraphSpec`` as its fields,
        each rank materializing it; a ``Graph`` as its arrays). Returns
        the reply whose value is ``(assignment, trace without timings)``
        and whose ``local`` is rank 0's whole trace."""
        return self.call(_partition_on_rank, req, name)

    def _collect(self, what: str, timeout: Optional[float] = None
                 ) -> Dict[int, tuple]:
        """One message from every rank. A rank's process that ends first
        fails the mesh; after the first error reply, the others get the
        group's timeout (they may be stuck in a collective with it)."""
        pending = dict(enumerate(self._conns))
        got: Dict[int, tuple] = {}
        start = time.monotonic()
        deadline = None if timeout is None else start + timeout
        sentinels = {self._sentinel(r): r for r in range(self.size)}
        try:
            self._wait_all(what, pending, got, sentinels, start, deadline)
        except MeshFailure:
            for m in got.values():      # answers no one will read
                if m[0] == "ok" and m[4] is not None:
                    _unlink(m[4])
            raise
        return got

    def _wait_all(self, what, pending, got, sentinels, start, deadline):
        from multiprocessing.connection import wait as mp_wait
        while pending:
            if deadline is not None and time.monotonic() >= deadline:
                late = sorted(pending)
                self._fail(f"rank(s) {late} of the mesh did not answer "
                           f"the {what} within {deadline - start:.0f} s")
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            ready = mp_wait(list(pending.values()) + list(sentinels),
                            timeout=left)
            for obj in ready:
                if obj in sentinels:
                    r = sentinels[obj]
                    conn = self._conns[r]
                    if r in pending and conn.poll():
                        continue            # read its last answer first
                    self._fail(f"rank {r} of the mesh died during the "
                               f"{what} ({self._exit_text(r)})")
                r = self._conns.index(obj)
                if r not in pending:
                    continue
                try:
                    msg = obj.recv()
                except (EOFError, OSError):
                    self._fail(f"rank {r} of the mesh died during the "
                               f"{what} ({self._exit_text(r)})")
                got[r] = msg
                del pending[r]
                if msg[0] == "error" and what == "start":
                    return              # its peers wait for it in vain
                if msg[0] == "error" and pending:
                    grace = time.monotonic() + MESH_GROUP_TIMEOUT_S + 30
                    deadline = grace if deadline is None else \
                        min(deadline, grace)

    def _sentinel(self, r: int):
        """What becomes ready when rank ``r`` is gone: its process's
        sentinel, or its host's (a rank dies with its host)."""
        link = self._links[r]
        return self._procs[r].sentinel if link is None else link.sentinel

    def _exit_text(self, r: int) -> str:
        link = self._links[r]
        if link is not None:
            return link.describe()
        proc = self._procs[r]
        proc.join(timeout=1.0)
        code = proc.exitcode
        why = "killed with the mesh" if self._killed else \
            f"exit code {code}"
        return f"pid {proc.pid}, {why}"

    def _fail(self, detail: str):
        self._teardown(detail)
        raise MeshFailure(detail)

    # -- lifecycle ---------------------------------------------------------

    def _teardown(self, detail: Optional[str]) -> None:
        with self._state:
            if self._alive:
                self._alive = False
                self.failure = detail
        self._kill_ranks()
        for proc in self._procs:
            if proc is not None:
                proc.join(timeout=10.0)
        for conn in self._conns:
            if conn is not None:
                conn.close()

    def _kill_ranks(self) -> None:
        """SIGKILL every rank: this process's children itself, the
        others through their hosts."""
        for proc, link in zip(self._procs, self._links):
            if link is not None:
                link.end(self._key, 0.0)
            elif proc.is_alive():
                proc.kill()

    def kill(self) -> None:
        """SIGKILL every rank now. A call in flight fails with
        ``MeshFailure``; the mesh is closed."""
        self._killed = True
        with self._state:
            if self._alive:
                self._alive = False
                self.failure = "the mesh was killed"
        self._kill_ranks()
        if self._lock.acquire(timeout=0):
            try:
                self._teardown("the mesh was killed")
            finally:
                self._lock.release()

    def close(self) -> None:
        """Stop the ranks: they leave their group and exit. A mesh with
        a call in flight is killed instead."""
        if not self._lock.acquire(timeout=0):
            self.kill()
            return
        try:
            with self._state:
                if not self._alive:
                    was_alive = False
                else:
                    self._alive = False
                    self.failure = "the mesh was closed"
                    was_alive = True
            if was_alive:
                for conn in self._conns:
                    if conn is None:
                        continue            # a rank that never dialed in
                    try:
                        conn.send(("close",))
                    except (OSError, EOFError):
                        pass
                deadline = time.monotonic() + 30.0
                for proc in self._procs:
                    if proc is not None:
                        proc.join(timeout=30.0)
                # a rank of another process is gone once its connection
                # ends (or its host is)
                for conn, link in zip(self._conns, self._links):
                    if link is not None and conn is not None:
                        _wait_closed(conn, link.sentinel, deadline)
            self._teardown(self.failure)
        finally:
            self._lock.release()

    def __enter__(self) -> "PeMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def mesh_devices(P: int, device=None) -> list:
    """The devices of a P-PE mesh: the first P cards (``device_slices``,
    which raises without them: no quiet fallback to the CPU), or P CPU
    ranks for ``device="cpu"``."""
    import torch
    if P < 1:
        raise ValueError(f"a mesh needs P >= 1, got {P}")
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * P
    from ..kernels.dispatch import resolve_device
    resolve_device(device)              # raises without CUDA
    return device_slices(1, P)[0]


def spawn_meshes(slices: Sequence[Sequence], group=None) -> List[PeMesh]:
    """One ``PeMesh`` a device slice, all spawned at once; if one fails
    to start, every mesh is closed and the failure raised. ``group``: a
    ``GroupOwner`` whose cards the slices hold (``PeMesh``)."""
    meshes: List[PeMesh] = []
    try:
        for devs in slices:
            meshes.append(PeMesh(devs, wait=False, group=group))
        for m in meshes:
            m.wait_ready()
    except BaseException:
        for m in meshes:
            m.kill()
        raise
    return meshes


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

_RANK_GRAPHS: Dict[Any, Any] = {}


def _rank_graph(spec):
    """A rank's materialized ``GraphSpec`` (the last few kept)."""
    g = _RANK_GRAPHS.pop(spec, None)
    if g is None:
        g = spec.materialize()
    _RANK_GRAPHS[spec] = g
    while len(_RANK_GRAPHS) > 8:
        _RANK_GRAPHS.pop(next(iter(_RANK_GRAPHS)))
    return g


def _partition_on_rank(pe, req, name: str) -> RankOutput:
    """One request's distributed backend on this rank."""
    import numpy as np

    from .backends import BackendContext, get_backend
    from .request import GraphSpec
    g = _rank_graph(req.graph) if isinstance(req.graph, GraphSpec) \
        else req.graph
    ctx = BackendContext(device=pe.device, devices=pe.P,
                         trace=[] if req.collect_trace else None)
    part = np.asarray(get_backend(name)(g, req, ctx), dtype=np.int64)
    trace = list(ctx.trace or ())
    return RankOutput((part, strip_timings(trace)), trace)
