"""Multi-pod dry-run — port of ``repro.launch.dryrun``: run the step of
every (arch x shape x mesh) cell on fake tensors (no allocation) over a
fake process group of the mesh's size, and print each cell's per-device
memory, flops and collective schedule for §Roofline.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
  python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch
  python -m repro_torch.launch.dryrun --all --config smoke --device cpu

Where the reference forces 512 host devices and lets XLA lower and
compile each step, the port starts a ``"fake"`` process group of the
mesh's size with this process as rank 0 (no peers, every collective a
no-op), lays each step's abstract arguments out as DTensors of fake
tensors by its input shardings, and runs the step eagerly under the
step's ``FakeTensorMode`` and a dispatch mode of its own
(``StepMeter``), which sees each op on rank 0's local tensors:

* ``memory_analysis.argument_size_bytes``: rank 0's local bytes of the
  arguments; ``output_size_bytes`` the bytes of the outputs' storages
  the step made; ``temp_size_bytes`` the peak of the live storages the
  step made, less those outputs;
* ``cost_analysis.flops`` and ``hlo_flops_per_device``: rank 0's local
  flops (``torch.utils.flop_counter``'s formulas over the local ops; a
  ``FlopCounterMode`` above DTensor would count global flops);
* ``collectives``: count and result bytes per c10d functional op on
  rank 0, the reference's wire-volume proxy;
* ``hlo_flops_per_device_corrected`` equals the flops: the port's layers
  are an eager loop, which every op of every layer passes, so the
  reference's scan probe (a 1- and a 2-layer compile) has no
  counterpart, and neither has its HLO text parser
  (``collective_stats``);
* ``device_memory_bytes`` (arguments plus temporaries) and ``fits``
  against the card's ``total_memory`` (80 GB for an H100 where no card is
  visible), reported and not enforced.

A train step's finiteness check has no value on fake tensors: the step
that updates runs, the branch the reference's compiled ``lax.cond``
holds. ``--mesh`` picks ``pod`` (32 x 8, the default), ``multi-pod`` (2
x 32 x 8), ``node`` (1 x 8) or ``card`` (1 x 1); ``--config smoke`` runs
the SMOKE configs at the production shapes. A cell that raises is
reported and makes the run exit 1. Fake tensors are made on the CUDA
device unless ``--device cpu``; without a card the CLI exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

H100_BYTES = 80 * 10 ** 9

MESHES = {"pod": ((32, 8), ("data", "model")),
          "multi-pod": ((2, 32, 8), ("pod", "data", "model")),
          "node": ((1, 8), ("data", "model")),
          "card": ((1, 1), ("data", "model"))}


def start_fake_group(world: int) -> None:
    """A ``"fake"`` default process group of ``world`` ranks with this
    process as rank 0; an existing group must be a fake one at least
    that large."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry-run needs a fake group of {world} ranks; this "
                f"process has a {dist.get_backend()} group of "
                f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def build_mesh(name: str, device: str):
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = MESHES[name]
    n = math.prod(shape)
    start_fake_group(n)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors of ``tree`` (each storage once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class _Propagation:
    """Marks DTensor's output-shape propagation, which runs each new op
    once on global-shaped fake tensors: no rank runs those."""

    def __init__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self.cls = ShardingPropagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            if hasattr(ShardingPropagator, name):
                self.name = name
                break
        else:
            raise RuntimeError("this torch's ShardingPropagator has no "
                               "tensor-meta propagation to mark")
        self.depth = 0

    def __enter__(self):
        self.orig = getattr(self.cls, self.name)
        orig, mark = self.orig, self

        def marked(prop, *a, **kw):
            mark.depth += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                mark.depth -= 1
        setattr(self.cls, self.name, marked)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


class StepMeter(TorchDispatchMode):
    """Rank 0's local flops, collectives and live storage bytes of the
    ops run under it. An op on DTensors is deferred to DTensor, whose
    local ops come back here; storages that exist when the meter starts
    (the arguments) are not counted."""

    def __init__(self, args):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.prop = _Propagation()
        self.flops = 0
        self.collectives = {}
        self.live = self.peak = 0
        self.known = {id(_local(t).untyped_storage())
                      for t in _tensors(args)}
        self.args = args            # keeps the ids above from reuse
        self.counted = {}

    def __enter__(self):
        self.prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.prop.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.prop.depth:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.namespace == "_c10d_functional" and \
                packet.__name__ != "wait_tensor":
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(out))
            ent = self.collectives.setdefault(packet.__name__,
                                              {"count": 0, "bytes": 0})
            ent["count"] += 1
            ent["bytes"] += nbytes
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self.known:
                continue
            n = st.nbytes()
            self.known.add(key)
            self.counted[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.known.discard(key)
        self.live -= self.counted.pop(key, 0)

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree`` the meter counted (made by
        the step, alive now)."""
        seen = set()
        for t in _tensors(tree):
            key = id(_local(t).untyped_storage())
            if key in self.counted:
                seen.add(key)
        return sum(self.counted[k] for k in seen)


def card_bytes(device: str) -> int:
    if device == "cuda" and torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


def run_cell(entry, shape_name: str, mesh_name="pod",
             device: str = "cuda", verbose: bool = True) -> dict:
    """One cell on the mesh ``mesh_name`` names (``MESHES``) or on a
    ``DeviceMesh`` given as it; returns its result (module docstring)."""
    from ..launch.steps import build_step
    from ..models.common import distribute

    mesh = build_mesh(mesh_name, device) if isinstance(mesh_name, str) \
        else mesh_name
    n_dev = mesh.size()
    t0 = time.time()
    built = build_step(entry, shape_name, mesh)
    with built.fake_mode:
        args = distribute(built.args, built.in_shardings, mesh)
    t_build = time.time() - t0
    arg_bytes = local_bytes(args)
    meter = StepMeter(args)
    t0 = time.time()
    with built.fake_mode, meter:
        out = built.fn(*args)
    t_run = time.time() - t0
    out_bytes = meter.new_bytes(out)
    temp = meter.peak - out_bytes
    mem = {"argument_size_bytes": arg_bytes,
           "output_size_bytes": out_bytes,
           "temp_size_bytes": temp}
    cost = {"flops": float(meter.flops)}
    total = card_bytes(device)
    result = {
        "arch": entry.arch_id,
        "shape": shape_name,
        "mesh": list(mesh.shape),
        "mesh_axes": list(mesh.mesh_dim_names),
        "n_devices": n_dev,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory_analysis": mem,
        "cost_analysis": cost,
        "collectives": meter.collectives,
        "model_flops": built.model_flops,
        "hlo_flops_per_device": cost["flops"],
        "hlo_flops_per_device_corrected": cost["flops"],
        "optimizer": built.opt_name,
        "device_memory_bytes": arg_bytes + temp,
        "card_memory_bytes": total,
        "fits": arg_bytes + temp <= total,
    }
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x32x8 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", choices=sorted(MESHES), default=None,
                    help="pod (32x8, the default), multi-pod (2x32x8), "
                         "node (1x8) or card (1x1)")
    ap.add_argument("--config", choices=("full", "smoke"), default="full",
                    help="the full CONFIGs (default) or the SMOKE ones")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the CUDA "
                         "device; 'cpu' on purpose)")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH/SHAPE", help="one cell (repeatable)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--out", default=None, help="artifact dir for JSONs")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import load_all
    from ..kernels.dispatch import NoCudaDevice, resolve_device
    try:
        device = resolve_device(args.device).type
    except NoCudaDevice as exc:
        print(f"dryrun: no CUDA device ({exc}); pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    if not args.all and args.arch is None and not args.cell:
        ap.error("name an --arch or a --cell, or pass --all")

    registry = load_all()
    if args.config == "smoke":
        registry = {k: dataclasses.replace(e, config=e.smoke_config)
                    for k, e in registry.items()}
    if args.all:
        cells = [(entry, s.name) for entry in registry.values()
                 for s in entry.shapes]
    elif args.cell:
        cells = [(registry[c.split("/")[0]], c.split("/")[1])
                 for c in args.cell]
    else:
        entry = registry[args.arch]
        names = [args.shape] if args.shape else [s.name
                                                 for s in entry.shapes]
        cells = [(entry, n) for n in names]

    if args.both_meshes:
        meshes = ["pod", "multi-pod"]
    elif args.mesh:
        meshes = [args.mesh]
    else:
        meshes = ["multi-pod" if args.multi_pod else "pod"]
    if args.jobs > 1:
        return _run_jobs(args, cells, meshes, device)
    start_fake_group(max(math.prod(MESHES[m][0]) for m in meshes))

    failures = []
    for entry, shape_name in cells:
        for mesh_name in meshes:
            tag = f"{entry.arch_id}/{shape_name}/{mesh_name}"
            fn = tag.replace("/", "__") + ".json"
            if args.skip_existing and args.out and \
                    os.path.exists(os.path.join(args.out, fn)):
                continue
            try:
                res = run_cell(entry, shape_name, mesh_name, device)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(res, f, indent=1)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(json.dumps({"cell": tag, "error": repr(e)}),
                      flush=True)
                traceback.print_exc()
    if failures:
        print(f"FAILED {len(failures)} cells", file=sys.stderr)
        return 1
    return 0


def _run_jobs(args, cells, meshes, device) -> int:
    """The cells dealt round-robin to ``args.jobs`` worker processes (each
    this CLI with its share as ``--cell``s), all started at once; their
    lines are printed as each ends. Exit 1 if any worker fails."""
    import subprocess
    todo = [(f"{e.arch_id}/{s}", m) for m in meshes for e, s in cells]
    procs = []
    for w in range(min(args.jobs, len(todo))):
        share = todo[w::args.jobs]
        for mesh in meshes:
            mine = [c for c, m in share if m == mesh]
            if not mine:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh", mesh, "--config", args.config,
                   "--device", device]
            for c in mine:
                cmd += ["--cell", c]
            if args.out:
                cmd += ["--out", args.out]
            if args.skip_existing:
                cmd.append("--skip-existing")
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        sys.stdout.flush()
        failed += p.returncode != 0
    if failed:
        print(f"FAILED {failed} worker processes", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
