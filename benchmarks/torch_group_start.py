"""How often a fabric worker group fails to start on a loaded host (CPU).

Torch runs no barrier after ``init_process_group``: a process that
destroys its group as soon as it has joined can close its gloo pairs
while a peer is still connecting them. The port's groups check in on
their store first (``repro_torch.api.group.check_in``). Two measures:

  # two-process gloo groups, --parallel at a time, beside --busy
  # CPU-bound processes: each process joins through
  # runtime.distributed_init, then leaves at once (destroy_process_group)
  # or through group.leave (the check-in)
  PYTHONPATH=src python benchmarks/torch_group_start.py probe \
      --groups 128 --parallel 8 --busy 6 --leave at-once
  PYTHONPATH=src python benchmarks/torch_group_start.py probe \
      --groups 128 --parallel 8 --busy 6 --leave check-in

  # a test file run --runs times in each tree, the trees' runs side by
  # side, beside --busy CPU-bound processes
  python benchmarks/torch_group_start.py pytest --runs 20 --busy 6 \
      --tree . --tree artifacts/parent tests/test_torch_fabric_group.py

Each prints one JSON line per group wave or run and a last JSON line of
totals. Every process it starts is ended before it exits.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MEMBER = """
import sys
import torch.distributed as dist
from repro_torch.api import group, runtime
addr, rank, leave = sys.argv[1], int(sys.argv[2]), sys.argv[3]
runtime.distributed_init(addr, 2, rank, device="cpu", timeout_s=60)
if leave == "check-in":
    group.leave()
else:
    dist.destroy_process_group()
"""


def _env(src: str, **extra) -> dict:
    return dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="",
                OMP_NUM_THREADS="1", **extra)


def _held_port() -> socket.socket:
    """A bound, never listening ``SO_REUSEADDR`` socket: the kernel hands
    its port to no other ``bind(0)``, while the coordinator's store can
    still bind it."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


def probe(args) -> dict:
    src = os.path.join(os.path.abspath(args.src))
    failed, tails, done = 0, [], 0
    t0 = time.monotonic()
    while done < args.groups:
        wave = min(args.parallel, args.groups - done)
        socks = [_held_port() for _ in range(wave)]
        procs = []
        for s in socks:
            addr = f"127.0.0.1:{s.getsockname()[1]}"
            procs.append([subprocess.Popen(
                [sys.executable, "-c", MEMBER, addr, str(r), args.leave],
                env=_env(src), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True) for r in range(2)])
        bad = 0
        for pair in procs:
            outs = []
            for p in pair:
                try:
                    outs.append(p.communicate(timeout=120)[1])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append("killed after 120 s\n" + p.communicate()[1])
            if any(p.returncode != 0 for p in pair):
                bad += 1
                tails.append([(p.returncode, e.strip().splitlines()[-1:])
                              for p, e in zip(pair, outs)])
        for s in socks:
            s.close()
        done += wave
        failed += bad
        print(json.dumps({"wave_groups": wave, "wave_failed": bad}),
              flush=True)
    return {"measure": "probe", "leave": args.leave, "groups": done,
            "parallel": args.parallel, "busy": args.busy, "failed": failed,
            "seconds": round(time.monotonic() - t0, 1),
            "failures": tails[:10]}


def run_pytest(args) -> dict:
    results = {t: [] for t in args.tree}
    t0 = time.monotonic()
    for i in range(args.runs):
        procs = {}
        for tree in args.tree:
            tree_abs = os.path.abspath(tree)
            procs[tree] = subprocess.Popen(
                [sys.executable, "-m", "pytest", "-q",
                 "-p", "no:cacheprovider", "-p", "no:randomly",
                 *args.files], cwd=tree_abs,
                env=_env(os.path.join(tree_abs, "src"),
                         JAX_PLATFORMS="cpu"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        for tree, p in procs.items():
            try:
                out = p.communicate(timeout=args.timeout)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\nkilled at the timeout"
            last = out.strip().splitlines()[-1:] or [""]
            failed = [ln.split(" - ")[0] for ln in out.splitlines()
                      if ln.startswith("FAILED ")]
            rec = {"tree": tree, "run": i + 1, "rc": p.returncode,
                   "summary": last[0], "failed": failed}
            results[tree].append(rec)
            print(json.dumps(rec), flush=True)
    return {"measure": "pytest", "files": args.files, "busy": args.busy,
            "seconds": round(time.monotonic() - t0, 1),
            "trees": {t: {"runs": len(r),
                          "runs_failed": sum(x["rc"] != 0 for x in r),
                          "tests_failed": sum(len(x["failed"]) for x in r)}
                      for t, r in results.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_group_start")
    sub = ap.add_subparsers(dest="measure", required=True)
    pp = sub.add_parser("probe", help="two-process gloo groups")
    pp.add_argument("--groups", type=int, default=128)
    pp.add_argument("--parallel", type=int, default=8)
    pp.add_argument("--leave", choices=["at-once", "check-in"],
                    default="check-in")
    pp.add_argument("--src", default=os.path.join(ROOT, "src"))
    tp = sub.add_parser("pytest", help="a test file, again and again")
    tp.add_argument("--runs", type=int, default=20)
    tp.add_argument("--tree", action="append", required=True)
    tp.add_argument("--timeout", type=float, default=900.0)
    tp.add_argument("files", nargs="+")
    for p in (pp, tp):
        p.add_argument("--busy", type=int, default=6,
                       help="CPU-bound processes run beside the measure")
    args = ap.parse_args(argv)
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    try:
        res = probe(args) if args.measure == "probe" else run_pytest(args)
    finally:
        for b in busy:
            b.kill()
        for b in busy:
            b.wait()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
