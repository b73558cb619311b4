"""Fabric CLI of the port — run the cross-process serving tier.

  # terminal 1: the front door (routing + registry + autoscaler)
  python -m repro_torch.launch.fabric frontdoor --port 7070

  # terminals 2..N: worker processes (each a whole PartitionServer on
  # the card; --device cpu runs one on the CPU on purpose)
  python -m repro_torch.launch.fabric worker --frontdoor 127.0.0.1:7070 \
      --meshes 1
  # a worker of P-card meshes (one rank process a card; with --device
  # cpu, P CPU ranks): it registers devices=P
  python -m repro_torch.launch.fabric worker --frontdoor 127.0.0.1:7070 \
      --meshes 1 --devices-per-mesh 2

  # a group of N worker processes (one card each; gloo and the CPU with
  # --device cpu), process I of N started with:
  python -m repro_torch.launch.fabric worker --frontdoor 127.0.0.1:7070 \
      --coordinator 127.0.0.1:7071 --num-processes N --process-id I \
      [--devices-per-mesh P]

  # anywhere: fleet status as JSON
  python -m repro_torch.launch.fabric status --frontdoor 127.0.0.1:7070

Every role prints one JSON "ready" line on stdout once it is
listening (machine-readable: the selftest, the bench and the
autoscaler's ``ProcessScaler`` all coordinate on it), then serves
until SIGTERM/SIGINT — which drains gracefully: no new admissions,
in-flight work finishes, queued tickets resolve ``server_closed``.

A worker takes ``--coordinator host:port --num-processes N
--process-id I`` (or the ``REPRO_COORDINATOR`` etc. environment
variables) for ``repro_torch.api.runtime.distributed_init``: one process
is a no-op. The group is a rendezvous (``repro_torch.api.group``):

* at ``--devices-per-mesh 1`` every process is a whole worker on its own
  card, with its own port and registration; a given ``--server-id S``
  registers as ``S.p<I>``;
* above one the group is one server: process 0 pools the group's cards
  (one a process, in process order), carves ``--meshes`` slices of P from
  them and registers once (``devices=P``); its ready line adds
  ``processes`` and ``cards``. Every other process hosts the ranks of
  the meshes on its card, prints a ``rank-host`` ready line once process
  0 has taken it in, and never registers. A carve that does not fit, or
  a mesh that would hold one card twice, exits 2. SIGTERM to process 0
  drains it and ends the whole group (exit 0 everywhere); a rank host
  that ends fails the meshes with a rank on it, and process 0 serves on
  with the others; a rank host whose process 0 ends exits 1.

A worker of one process needs no group for its meshes:
``--devices-per-mesh P`` spawns the ranks of each mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def _addr(s: str):
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(
            f"expected HOST:PORT, got {s!r}")
    return host, int(port)


def _ready(role: str, **fields) -> None:
    print(json.dumps({"op": "ready", "role": role, **fields}),
          flush=True)


def _run_frontdoor(args) -> int:
    from repro_torch.fabric import AutoscaleConfig, FrontDoor

    autoscale = None
    if args.autoscale:
        autoscale = AutoscaleConfig(
            min_workers=args.min_workers, max_workers=args.max_workers,
            grow_queue_depth=args.grow_queue_depth,
            grow_windows=args.grow_windows,
            shrink_windows=args.shrink_windows,
            eval_period_s=args.eval_period_s)
    fd = FrontDoor(host=args.host, port=args.port,
                   lease_ttl_s=args.lease_ttl_s,
                   max_queue=args.max_queue,
                   max_retries=args.max_retries,
                   autoscale=autoscale,
                   worker_args=args.worker_args.split()
                   if args.worker_args else None)
    _ready("frontdoor", host=fd.host, port=fd.port,
           autoscale=bool(autoscale))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    fd.close()
    return 0


def _run_worker(args) -> int:
    from torch.distributed import DistError

    from repro_torch.api import group, runtime
    from repro_torch.fabric import FabricWorker
    from repro_torch.kernels.dispatch import NoCudaDevice

    owner = None
    try:
        # the multi-process group first (a no-op for one process)
        try:
            info = runtime.distributed_init(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id, device=args.device,
                timeout_s=runtime.MESH_START_TIMEOUT_S)
        except DistError as exc:        # a store that timed out
            n = args.num_processes or os.environ.get("REPRO_NUM_PROCESSES")
            raise RuntimeError(
                f"the group of {n} process(es) did not form within "
                f"{runtime.MESH_START_TIMEOUT_S:.0f} s: {exc}") from None
        procs, pid = info["num_processes"], info["process_id"]
        spanning = procs > 1 and args.devices_per_mesh > 1
        if spanning and pid > 0:
            return _run_rank_host(group.RankHost(info), info)
        if spanning:
            coord = args.coordinator or os.environ["REPRO_COORDINATOR"]
            owner = group.GroupOwner.start(info, coord.rpartition(":")[0])
        else:
            group.leave()
        worker = FabricWorker(
            frontdoor=args.frontdoor, host=args.host, port=args.port,
            server_id=args.server_id, meshes=args.meshes,
            devices_per_mesh=args.devices_per_mesh, backend=args.backend,
            heartbeat_s=args.heartbeat_s, max_queue=args.max_queue,
            device=args.device,
            process_id=pid if procs > 1 and not spanning else None,
            group=owner)
    except NoCudaDevice as exc:
        print(f"fabric worker: no CUDA device ({exc}); pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    except RuntimeError as exc:     # too few cards, a mesh's start, the group
        if owner is not None:
            owner.close(2, str(exc))
        print(f"fabric worker: {exc}", file=sys.stderr)
        return 2
    worker.install_signal_handlers()
    extra = {} if owner is None else {
        "processes": owner.num_processes,
        "cards": [c._asdict() for c in owner.cards]}
    _ready("worker", server_id=worker.server_id, host=worker.host,
           port=worker.port, meshes=worker.meshes,
           devices=worker.devices_per_mesh, runtime=info, **extra)
    worker.wait()
    if owner is not None:
        owner.close(0, "process 0 stopped")
    return 0


def _run_rank_host(host, info: dict) -> int:
    """A process I > 0 of a group whose meshes span it: host their ranks
    on this process's card until process 0 ends the group."""
    signal.signal(signal.SIGTERM, lambda *a: host.stop())
    signal.signal(signal.SIGINT, lambda *a: host.stop())
    _ready("rank-host", process_id=host.process,
           num_processes=info["num_processes"], host=host.host,
           device=host.card.device, pid=os.getpid())
    code, reason = host.serve()
    if code:
        print(f"fabric worker: {reason}", file=sys.stderr)
    return code


def _run_status(args) -> int:
    from repro_torch.fabric import status_of

    st = status_of(*args.frontdoor, timeout=args.timeout)
    print(json.dumps(st, indent=None if args.compact else 2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fabric")
    sub = ap.add_subparsers(dest="role", required=True)

    fdp = sub.add_parser("frontdoor", help="run the RPC front door")
    fdp.add_argument("--host", default="127.0.0.1")
    fdp.add_argument("--port", type=int, default=0,
                     help="0 picks an ephemeral port (see ready line)")
    fdp.add_argument("--lease-ttl-s", type=float, default=5.0)
    fdp.add_argument("--max-queue", type=int, default=1024)
    fdp.add_argument("--max-retries", type=int, default=1)
    fdp.add_argument("--autoscale", action="store_true",
                     help="own a local worker fleet sized by pressure")
    fdp.add_argument("--min-workers", type=int, default=1)
    fdp.add_argument("--max-workers", type=int, default=2)
    fdp.add_argument("--grow-queue-depth", type=float, default=2.0)
    fdp.add_argument("--grow-windows", type=int, default=2)
    fdp.add_argument("--shrink-windows", type=int, default=4)
    fdp.add_argument("--eval-period-s", type=float, default=0.5)
    fdp.add_argument("--worker-args", default="",
                     help="extra args for autoscaled workers, e.g. "
                          "'--meshes 2'")
    fdp.set_defaults(run=_run_frontdoor)

    wp = sub.add_parser("worker", help="run one PartitionServer process")
    wp.add_argument("--frontdoor", type=_addr, default=None,
                    help="front door HOST:PORT to register with")
    wp.add_argument("--host", default="127.0.0.1")
    wp.add_argument("--port", type=int, default=0)
    wp.add_argument("--server-id", default=None)
    wp.add_argument("--meshes", type=int, default=1)
    wp.add_argument("--devices-per-mesh", type=int, default=1)
    wp.add_argument("--backend", default=None)
    wp.add_argument("--heartbeat-s", type=float, default=1.0)
    wp.add_argument("--max-queue", type=int, default=1024)
    wp.add_argument("--device", default=None,
                    help="torch device of the worker's server (default: "
                         "the card; 'cpu' on purpose)")
    wp.add_argument("--coordinator", default=None,
                    help="the group's coordinator HOST:PORT (process 0 "
                         "listens there): a worker of --num-processes "
                         "processes")
    wp.add_argument("--num-processes", type=int, default=None)
    wp.add_argument("--process-id", type=int, default=None)
    wp.set_defaults(run=_run_worker)

    sp = sub.add_parser("status", help="query a front door")
    sp.add_argument("--frontdoor", type=_addr, required=True)
    sp.add_argument("--timeout", type=float, default=10.0)
    sp.add_argument("--compact", action="store_true")
    sp.set_defaults(run=_run_status)

    args = ap.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
