"""What a request's trip through a mesh of rank processes costs, apart
from the partitioning: the owner packs the request (``api.runtime._pack``:
pickled, a ``Graph``'s large array buffers in one shared-memory block),
sends it down each rank's pipe, the rank unpacks it, and the answer
comes back the same way (``api.runtime.PeMesh``).

    python3 benchmarks/torch_mesh_transfer.py [--n 1048576] [--device cpu]

Times, each three times: ``_pack`` and ``_unpack`` of phase 4's request
(rgg2d, seed 17) in this process; a ``PeMesh.call`` of a function that
returns at once, with the request as its argument (the whole trip, and
the rank's seconds in the function): its buffers through shared memory
(``graph_shm``, the mesh's way), everything through the pipe
(``graph_pipe``: ``SHM_MIN_BYTES`` raised above the request's size), and
the request's ``GraphSpec`` (``spec``: nothing large to send). Prints one
JSON line a measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def echo_n(pe, req):
    """On a rank: the request's vertex count."""
    return req.graph.n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: card 0; 'cpu')")
    args = ap.parse_args()

    from repro_torch import api
    from repro_torch.api import runtime

    def say(what, **kw):
        print(json.dumps({"what": what, **kw}), flush=True)

    spec = api.GraphSpec("rgg2d", args.n, 8.0, seed=17)
    req = api.PartitionRequest(graph=spec.materialize(), k=16)
    for _ in range(3):
        t0 = time.perf_counter()
        msg = runtime._pack(req)
        t1 = time.perf_counter()
        runtime._unpack(msg)
        say("pack", pickled_bytes=len(msg[0]), shm_bytes=sum(msg[2]),
            pack_s=t1 - t0, unpack_s=time.perf_counter() - t1)

    t0 = time.perf_counter()
    with runtime.PeMesh(runtime.mesh_devices(1, args.device)) as mesh:
        say("spawn", device=str(mesh.devices[0]),
            seconds=time.perf_counter() - t0)
        shm_min = runtime.SHM_MIN_BYTES
        for form, r, floor in (
                ("graph_shm", req, shm_min),
                ("graph_pipe", req, 1 << 62),
                ("spec", api.PartitionRequest(graph=spec, k=16), shm_min)):
            runtime.SHM_MIN_BYTES = floor
            for _ in range(3):
                mesh.call(echo_n, r)
                say(f"call_{form}", seconds=mesh.call_seconds[-1],
                    rank_seconds=mesh.rank_seconds[-1])
        runtime.SHM_MIN_BYTES = shm_min
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True) if args.device != "cpu" else None
    print(smi.stdout.strip() if smi and smi.returncode == 0 else
          f"host {os.cpu_count()} cores")
    return 0


if __name__ == "__main__":
    sys.exit(main())
