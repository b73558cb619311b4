"""A fabric worker of several processes: the group's rendezvous and the
hosts of its meshes' ranks.

A worker started with ``--num-processes N`` (N > 1) joins a
``torch.distributed`` group through ``runtime.distributed_init``: one
card a process (gloo and the CPU with ``--device cpu``). The group is a
rendezvous, never a collective: two processes bound to one card form an
NCCL group that fails at its first collective, so nothing here issues
one. Once the rendezvous is done every process checks in on the group's
store and leaves the group (``leave``), which frees its default group
for a one-device ``dist`` request, as in a worker of one process.

At one device a mesh every process is a whole worker and needs nothing
more. Above one, the group is one server. Process 0 is the worker
(``GroupOwner``): it listens on a ``multiprocessing.connection``
listener whose address and authkey travel in the group's store, waits
until every other process has checked in, pools the group's cards in
process order (one a process: the card ``distributed_init`` bound) and
carves its meshes from the pool (``GroupOwner.carve``). A mesh's rank
runs where its card is: process 0's as its children (``PeMesh``), the
others as children of the process that owns the card (``RankHost``): a
rank joins a group of its own (``runtime._mesh_rank``), and a child can
be killed alone while its host serves the group's other meshes. Such a
rank dials process 0's listener in place of a pipe, and dies with its
host.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from . import runtime
from .runtime import MeshFailure

# the group store's key under which process 0 publishes its listener
OWNER_KEY = "repro_torch/fabric/owner"
# the group store's counts of the check-in before the group is left
ARRIVED_KEY = "repro_torch/fabric/arrived"
DEPARTED_KEY = "repro_torch/fabric/departed"


class GroupCard(NamedTuple):
    """One process's device in the group's pool."""
    process: int            # the process that owns it
    host: str               # the address its peers reach that process at
    hostname: str
    device: str             # "cuda:0" (on that process's host) or "cpu"
    uuid: Optional[str]     # the card's UUID (None for the CPU)


def local_card(process: int, host: str, device: str) -> GroupCard:
    """This process's entry of the pool."""
    import torch
    dev = torch.device(device)
    uuid = None
    if dev.type == "cuda":
        uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid",
                           "")) or None
    return GroupCard(process, host, socket.gethostname(), str(dev), uuid)


def check_cards(slices: Sequence[Sequence[GroupCard]]) -> None:
    """Raise ``RuntimeError`` naming the first card that a slice holds
    twice (processes of a group that share a card): NCCL refuses two
    ranks of one group on a card. CPU entries never clash."""
    for i, cards in enumerate(slices):
        seen: Dict[tuple, GroupCard] = {}
        for c in cards:
            if c.device == "cpu":
                continue
            key = ("uuid", c.uuid) if c.uuid else ("card", c.hostname,
                                                   c.device)
            if key in seen:
                raise RuntimeError(
                    f"mesh {i} would hold card {c.device} of "
                    f"{c.hostname} ({c.uuid or 'no UUID'}) twice: "
                    f"processes {seen[key].process} and {c.process} are "
                    "both bound to it, and NCCL refuses two ranks of one "
                    "group on a card; give every process of a mesh a card "
                    "of its own")
            seen[key] = c


def leave() -> None:
    """Leave the group once its rendezvous is done: check in with every
    other process (``check_in``), then destroy the group."""
    import torch.distributed as dist
    if dist.is_initialized():
        check_in(_store(), dist.get_rank(), dist.get_world_size(),
                 runtime.MESH_START_TIMEOUT_S)
        dist.destroy_process_group()


def check_in(store, rank: int, n: int, timeout_s: float) -> None:
    """Return once all ``n`` processes of a group have called this on its
    ``store``, rank 0 (the store's host) last.

    Torch runs no barrier after ``init_process_group``: a process that
    destroys its group as soon as it has joined can close its gloo pairs
    while a peer is still connecting them. So every process adds one to a
    count and waits until it reaches ``n``; then the others count
    themselves out and rank 0, whose store they still read, waits for
    them. The store carries no collective, so processes that share a card
    under NCCL may check in too. Raises ``RuntimeError`` naming the count
    still missing after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    store.add(ARRIVED_KEY, 1)
    _await_count(store, ARRIVED_KEY, n, n, "checked in", timeout_s,
                 deadline)
    if rank:
        store.add(DEPARTED_KEY, 1)
    else:
        _await_count(store, DEPARTED_KEY, n - 1, n,
                     "counted itself out after the check-in", timeout_s,
                     deadline)


def _await_count(store, key: str, want: int, n: int, what: str,
                 timeout_s: float, deadline: float) -> None:
    pause = 0.001
    while True:
        have = store.add(key, 0)
        if have >= want:
            return
        if not _left(deadline):
            raise RuntimeError(
                f"{want - have} of the group's {n} processes never "
                f"{what} within {timeout_s:g} s")
        time.sleep(min(pause, _left(deadline)))
        pause = min(2 * pause, 0.05)


def _store():
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _left(deadline: float) -> float:
    return max(0.0, deadline - time.monotonic())


def _local_address(conn) -> str:
    """The address of this end of ``conn``: where its peer reaches us."""
    s = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        return s.getsockname()[0]
    finally:
        s.close()


# ---------------------------------------------------------------------------
# process 0
# ---------------------------------------------------------------------------

class HostLink:
    """Process 0's end of another process of the group: its control
    connection, read by a thread of its own. ``sentinel`` becomes ready
    (and stays so) once that process is gone."""

    def __init__(self, owner: "GroupOwner", hello: tuple, conn):
        from multiprocessing import Pipe
        _, self.process, self.pid, card = hello
        self.card = GroupCard(*card)
        self._conn = conn
        self._cond = owner._cond
        self._send_lock = threading.Lock()
        self.alive = True
        self._seq = 0
        self._ports: Dict[int, Tuple[str, int]] = {}
        # (mesh key, rank) -> why the rank ended before it dialed in
        self.gone: Dict[Tuple[str, int], str] = {}
        self.sentinel, self._dead = Pipe(duplex=False)
        threading.Thread(target=self._read, daemon=True,
                         name=f"repro-torch-group-p{self.process}").start()

    def welcome(self, pool: dict) -> None:
        self._send(("welcome", pool))

    def _read(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            with self._cond:
                if msg[0] == "port":
                    self._ports[msg[1]] = (msg[2], msg[3])
                elif msg[0] == "ended":
                    self.gone[(msg[1], msg[2])] = msg[3]
                self._cond.notify_all()
        with self._cond:
            self.alive = False
            self._cond.notify_all()
        self._dead.close()              # the sentinel reads its end
        self._conn.close()

    def _send(self, msg: tuple) -> None:
        try:
            with self._send_lock:
                self._conn.send(msg)
        except (OSError, EOFError, ValueError) as exc:
            raise MeshFailure(f"{self.describe()}: {exc}") from None

    def describe(self) -> str:
        state = "" if self.alive else ", which is gone"
        return (f"hosted by process {self.process} of the group (pid "
                f"{self.pid}){state}")

    def mesh_address(self, timeout: float = 60.0) -> str:
        """``host:port`` on this process's host for a mesh group whose
        rank 0 it hosts."""
        with self._cond:
            self._seq += 1
            seq = self._seq
        self._send(("port", seq))
        deadline = time.monotonic() + timeout
        with self._cond:
            while seq not in self._ports:
                if not self.alive or not _left(deadline):
                    raise MeshFailure(
                        f"no address for a mesh group from the rank "
                        f"{self.describe()}")
                self._cond.wait(_left(deadline))
            host, port = self._ports.pop(seq)
        return f"{host}:{port}"

    def spawn(self, key: str, rank: int, P: int, addr: str,
              device: str) -> None:
        self._send(("spawn", key, rank, P, addr, device))

    def end(self, key: str, grace_s: float) -> None:
        """Have the host kill mesh ``key``'s rank if it has not exited
        after ``grace_s``."""
        try:
            self._send(("end", key, grace_s))
        except MeshFailure:
            pass                        # gone: its ranks died with it

    def exit(self, code: int, reason: str) -> None:
        try:
            self._send(("exit", code, reason))
        except MeshFailure:
            pass


class GroupOwner:
    """Process 0 of a worker whose meshes span a group of processes.
    ``start`` makes it; ``cards`` is the pool (one entry a process, in
    process order), ``carve`` its meshes' slices, ``close`` ends every
    other process of the group."""

    process = 0

    def __init__(self, info: dict, host: str):
        from multiprocessing.connection import Listener
        self.num_processes = info["num_processes"]
        self.host = host
        self._authkey = os.urandom(32)
        self._listener = Listener((host, 0), authkey=self._authkey)
        self.address = self._listener.address
        self._cond = threading.Condition()
        self._links: Dict[int, HostLink] = {}
        self._ranks: Dict[Tuple[str, int], object] = {}
        self._closing = False
        self.cards: List[GroupCard] = [local_card(0, host, info["device"])]
        threading.Thread(target=self._accept, daemon=True,
                         name="repro-torch-group-accept").start()

    @classmethod
    def start(cls, info: dict, host: str) -> "GroupOwner":
        """Publish the listener in the group's store and wait until every
        other process has checked in (``MESH_START_TIMEOUT_S``); raise
        ``RuntimeError`` naming the processes that have not."""
        owner = cls(info, host)
        try:
            _store().set(OWNER_KEY, json.dumps({
                "host": host, "port": owner.address[1],
                "authkey": owner._authkey.hex()}))
            owner._wait_check_ins(
                time.monotonic() + runtime.MESH_START_TIMEOUT_S)
            leave()
        except BaseException as exc:
            owner.close(2, f"process 0 could not start the group: {exc}")
            raise
        return owner

    def _wait_check_ins(self, deadline: float) -> None:
        n = self.num_processes
        with self._cond:
            while len(self._links) < n - 1:
                if not _left(deadline):
                    missing = sorted(set(range(1, n)) - set(self._links))
                    raise RuntimeError(
                        f"process(es) {missing} of the group of {n} did not "
                        f"check in with process 0 within "
                        f"{runtime.MESH_START_TIMEOUT_S:.0f} s")
                self._cond.wait(_left(deadline))
            links = [self._links[i] for i in range(1, n)]
        self.cards += [link.card for link in links]
        welcome = {"processes": n,
                   "cards": [c._asdict() for c in self.cards]}
        for link in links:
            link.welcome(welcome)

    def _accept(self) -> None:
        from multiprocessing import AuthenticationError
        while True:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError, AuthenticationError):
                if self._closing:
                    return
                continue
            if self._closing:
                conn.close()
                return
            try:
                hello = conn.recv() if conn.poll(30.0) else None
            except (EOFError, OSError):
                hello = None
            with self._cond:
                if hello and hello[0] == "host" and \
                        0 < hello[1] < self.num_processes and \
                        hello[1] not in self._links:
                    self._links[hello[1]] = HostLink(self, hello, conn)
                elif hello and hello[0] == "rank":
                    self._ranks[(hello[1], hello[2])] = conn
                else:
                    conn.close()
                self._cond.notify_all()

    def link(self, process: int) -> HostLink:
        return self._links[process]

    def carve(self, num_slices: int, per: int) -> List[List[GroupCard]]:
        """The pool's ``runtime.carve``, refused where a slice holds one
        card twice (``check_cards``)."""
        slices = runtime.carve(self.cards, num_slices, per)
        check_cards(slices)
        return slices

    def rank_connection(self, key: str, rank: int, link: HostLink,
                        deadline: float):
        """The connection of mesh ``key``'s rank ``rank`` once it has
        dialed in; ``MeshFailure`` if it ended first, its host is gone or
        ``deadline`` passes."""
        with self._cond:
            while (key, rank) not in self._ranks:
                why = link.gone.get((key, rank))
                if why is not None:
                    raise MeshFailure(
                        f"rank {rank} of the mesh, {link.describe()}, "
                        f"ended before it dialed in ({why})")
                if not link.alive or not _left(deadline):
                    raise MeshFailure(
                        f"rank {rank} of the mesh, {link.describe()}, did "
                        "not dial in")
                self._cond.wait(_left(deadline))
            return self._ranks.pop((key, rank))

    def close(self, code: int = 0, reason: str = "",
              timeout_s: float = 30.0) -> None:
        """Tell every other process to exit with ``code`` (and
        ``reason``), wait for them within ``timeout_s``, and stop
        listening."""
        from multiprocessing.connection import Client
        with self._cond:
            links = list(self._links.values())
        for link in links:
            link.exit(code, reason)
        deadline = time.monotonic() + timeout_s
        for link in links:
            link.sentinel.poll(_left(deadline))
        self._closing = True
        try:                            # wake the accepting thread
            Client(self.address, authkey=self._authkey).close()
        except OSError:
            pass
        self._listener.close()


# ---------------------------------------------------------------------------
# the other processes
# ---------------------------------------------------------------------------

class RankHost:
    """A process I > 0 of the group: it checks in with process 0
    (``join``), then spawns, ends and reports the ranks that process 0
    asks it for (``serve``) until process 0 tells it to exit or goes
    away, or ``stop`` is called."""

    def __init__(self, info: dict):
        from multiprocessing.connection import Client
        self.process = info["process_id"]
        deadline = time.monotonic() + runtime.MESH_START_TIMEOUT_S
        store = _store()
        try:
            store.wait([OWNER_KEY], datetime.timedelta(
                seconds=max(1.0, _left(deadline))))
            owner = json.loads(store.get(OWNER_KEY))
        except RuntimeError as exc:     # DistStoreError: a timeout
            raise RuntimeError(
                "process 0 of the group did not publish its address within "
                f"{runtime.MESH_START_TIMEOUT_S:.0f} s ({exc})") from None
        self._owner = (owner["host"], owner["port"])
        self._authkey = bytes.fromhex(owner["authkey"])
        try:
            self._conn = Client(self._owner, authkey=self._authkey)
        except OSError as exc:
            raise RuntimeError(
                f"cannot reach process 0 of the group at {self._owner}: "
                f"{exc}") from None
        self.host = _local_address(self._conn)
        self.card = local_card(self.process, self.host, info["device"])
        self._conn.send(("host", self.process, os.getpid(),
                         tuple(self.card)))
        if not self._conn.poll(_left(deadline)):
            raise RuntimeError(
                "process 0 of the group did not take this process in within "
                f"{runtime.MESH_START_TIMEOUT_S:.0f} s")
        try:
            msg = self._conn.recv()
        except (EOFError, OSError):
            raise RuntimeError("process 0 of the group went away while "
                               "taking this process in") from None
        if msg[0] != "welcome":
            raise RuntimeError(f"process 0 of the group refused this "
                               f"process: {msg[2]}")
        self.welcome = msg[1]
        # mesh key -> (rank, its process)
        self._children: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        leave()

    def stop(self) -> None:
        """End ``serve`` (a signal handler may call it)."""
        self._stop.set()

    def serve(self) -> Tuple[int, str]:
        """Run process 0's requests; return the exit code and why."""
        from multiprocessing.connection import wait as mp_wait
        code, reason = 1, "process 0 of the group is gone"
        while not self._stop.is_set():
            with self._lock:
                ranks = {p.sentinel: (k, r, p)
                         for k, (r, p) in self._children.items()}
            ready = mp_wait([self._conn, *ranks], timeout=0.2)
            for s in ready:
                if s in ranks:
                    self._ended(*ranks[s])
            if self._conn not in ready:
                continue
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] == "spawn":
                self._spawn(*msg[1:])
            elif msg[0] == "port":
                self._reply(("port", msg[1], self.host,
                             runtime._free_port()))
            elif msg[0] == "end":
                threading.Thread(target=self._end, args=msg[1:],
                                 daemon=True).start()
            elif msg[0] == "exit":
                code, reason = msg[1], msg[2]
                break
        else:
            code, reason = 0, ""
        with self._lock:
            procs = [p for _, p in self._children.values()]
            self._children.clear()
        for p in procs:
            p.kill()
        for p in procs:
            p.join(timeout=10.0)
        self._conn.close()
        return code, reason

    def _reply(self, msg: tuple) -> None:
        try:
            self._conn.send(msg)
        except (OSError, EOFError):
            pass                        # process 0 is gone: serve ends

    def _spawn(self, key: str, rank: int, P: int, addr: str,
               device: str) -> None:
        import multiprocessing as mp
        try:
            proc = mp.get_context("spawn").Process(
                target=_hosted_rank, daemon=True,
                name=f"repro-torch-mesh-rank{rank}",
                args=(self._owner, self._authkey, key, rank, P, addr,
                      device, os.getpid()))
            proc.start()
        except Exception as exc:
            self._reply(("ended", key, rank, f"{type(exc).__name__}: {exc}"))
            return
        with self._lock:
            self._children[key] = (rank, proc)

    def _ended(self, key: str, rank: int, proc) -> None:
        proc.join(timeout=1.0)
        with self._lock:
            if self._children.get(key, (None, None))[1] is not proc:
                return                  # ended on request
            del self._children[key]
        self._reply(("ended", key, rank, f"exit code {proc.exitcode}"))

    def _end(self, key: str, grace_s: float) -> None:
        with self._lock:
            _, proc = self._children.pop(key, (None, None))
        if proc is None:
            return
        proc.join(timeout=grace_s)
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=10.0)


def _hosted_rank(owner: tuple, authkey: bytes, key: str, rank: int, P: int,
                 addr: str, device: str, host_pid: int) -> None:
    """A mesh rank that a ``RankHost`` spawned: it dies with its host,
    dials process 0 and runs as a rank of this process would."""
    from multiprocessing.connection import Client

    def watch() -> None:
        while os.getppid() == host_pid:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    conn = Client(owner, authkey=authkey)
    conn.send(("rank", key, rank))
    runtime._mesh_rank(conn, addr, P, rank, device, shm=False)
