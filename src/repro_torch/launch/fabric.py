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
is a no-op. A worker that joins such a group of several processes (a
server spanning hosts) is not ported yet (ROADMAP queue 1, item 5): it
exits 2. Its meshes need no group of its own: ``--devices-per-mesh P``
spawns the ranks of each mesh.
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
    from repro_torch.api import runtime
    from repro_torch.fabric import FabricWorker
    from repro_torch.kernels.dispatch import NoCudaDevice

    procs = args.num_processes or int(
        os.environ.get("REPRO_NUM_PROCESSES") or 1)
    if procs > 1:
        print(f"fabric worker: a worker that joins a group of {procs} "
              "processes (one server across hosts) is not ported to "
              "repro_torch yet (ROADMAP queue 1, item 5); "
              "--devices-per-mesh P spawns a worker's meshes itself",
              file=sys.stderr)
        return 2
    try:
        # the multi-process group first (a no-op for one process)
        info = runtime.distributed_init(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id)
        worker = FabricWorker(
            frontdoor=args.frontdoor, host=args.host, port=args.port,
            server_id=args.server_id, meshes=args.meshes,
            devices_per_mesh=args.devices_per_mesh, backend=args.backend,
            heartbeat_s=args.heartbeat_s, max_queue=args.max_queue,
            device=args.device)
    except NoCudaDevice as exc:
        print(f"fabric worker: no CUDA device ({exc}); pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    except RuntimeError as exc:     # too few cards, a mesh's start
        print(f"fabric worker: {exc}", file=sys.stderr)
        return 2
    worker.install_signal_handlers()
    _ready("worker", server_id=worker.server_id, host=worker.host,
           port=worker.port, meshes=worker.meshes,
           devices=worker.devices_per_mesh, runtime=info)
    worker.wait()
    return 0


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
                    help="multi-process coordinator HOST:PORT (a worker "
                         "of more than one process is not ported yet)")
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
