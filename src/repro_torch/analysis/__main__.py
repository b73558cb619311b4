"""``python -m repro_torch.analysis`` — run the verifier suite.

Default mode tapes the real entry points (the host ones here, on
``--device``; the ``dist_*`` ones on every rank of a mesh of
``--devices`` ranks: one card a rank, or gloo ranks on the CPU with
``--device cpu``) and runs all four passes; exit code 0 iff there are no
unsuppressed findings. ``--fixture <name>`` runs one pass against its
seeded violation instead and must exit 1 — both directions are checked.
The entry points run, so this runs on the card unless ``--device cpu``
is given: without a CUDA device, or with fewer cards than ``--devices``,
it exits 2. A run that fails (an entry raised, a rank died) exits 3, so
a broken run never passes for a fixture that fired.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional

FIXTURES = ("collective", "overflow", "lint", "limits")


def _run_fixture(name: str, devices: list, dev, report) -> None:
    from . import collectives_pass, lint, limits, overflow_pass

    if name == "collective":
        from ..api.runtime import PeMesh, mesh_devices
        from .fixtures import fixture_collective_mismatch as fx

        if len(devices) < 2:        # a divergence needs two ranks
            try:
                devices = mesh_devices(2, dev if dev.type == "cpu" else None)
            except (RuntimeError, ValueError):
                devices = ["cpu", "cpu"]
                report.note("collective fixture: one card, so its two "
                            "ranks are gloo ranks on the CPU")
        with PeMesh(devices) as mesh:
            collectives_pass.run(mesh.call(fx.trace_on_rank).value, report)
    elif name == "overflow":
        from .fixtures import fixture_overflow as fx

        overflow_pass.run(fx.captured(dev), report)
    elif name == "lint":
        from .fixtures import fixture_lint as fx

        lint.check_file(fx.__file__, report, serve_hot=True)
    else:
        from .fixtures import fixture_limits as fx

        limits.run(report, dev, static_fn=fx.static_bytes, cases=fx.cases())


def _repo(P: int, devices: list, dev, report) -> None:
    from ..api.runtime import PeMesh
    from ..kernels import _build
    from . import collectives_pass, entrypoints, limits, lint, overflow_pass

    before = dict(_build.LAUNCHES)
    with PeMesh(devices) as mesh:
        runs = entrypoints.collect(P, dev, mesh)
        launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        for rank in mesh.launches:
            for k, v in rank.items():
                launches[k] += v
    logged = collectives_pass.run(runs, report)
    taped = overflow_pass.run(runs, report)
    grid, boundary = limits.run(report, dev)
    files = lint.run(report)
    report.note(
        f"traced {len({r.name for r in runs})} entries ({taped} ops taped, "
        f"{logged} collectives logged), limits grid {grid} points and "
        f"{boundary} boundary points, linted {files} files")
    report.note("kernel launches " + json.dumps(
        {k: v for k, v in launches.items() if v}, sort_keys=True))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="taped SPMD/overflow/launch-limit verifier + AST lint")
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks of the mesh the dist_* entries run on")
    ap.add_argument("--device", default=None,
                    help="where the entries run (default: the cards, one a "
                         "rank; 'cpu': here and on gloo ranks)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the JSON report to PATH")
    ap.add_argument("--fixture", default=None, choices=FIXTURES,
                    help="run one pass against its seeded violation instead")
    args = ap.parse_args(argv)

    from ..api.runtime import mesh_devices
    from ..kernels.dispatch import resolve_device
    from .findings import Allowlist, Report

    try:
        dev = resolve_device(args.device)
        devices = mesh_devices(args.devices,
                               dev if dev.type == "cpu" else None)
    except (RuntimeError, ValueError) as exc:
        print(f"analysis: {exc}; pass --device cpu for CPU ranks",
              file=sys.stderr)
        return 2

    try:
        if args.fixture:
            report = Report(Allowlist([]))  # fixtures: nothing suppressed
            _run_fixture(args.fixture, devices, dev, report)
        else:
            report = Report(Allowlist.load())
            _repo(args.devices, devices, dev, report)
    except Exception:
        traceback.print_exc()
        print("analysis: the run failed", file=sys.stderr)
        return 3

    print(report.to_text())
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(report.to_json() + os.linesep)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
