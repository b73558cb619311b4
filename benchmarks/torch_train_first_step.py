"""Where a fresh training process's first seconds go: the wall time of
each step of the training CLI's loop (``launch/train.py``: the SMOKE
config, ``train.data`` batches, AdamW), in this process from its start.

    python3 benchmarks/torch_train_first_step.py [--arch gemma-2b] \\
        [--steps 20] [--no-recompute] [--device cpu]

``--no-recompute`` runs the LM's layers and attention blocks without
``torch.utils.checkpoint`` (``models.transformer._recorded`` made a
plain call): the same numbers, nothing recomputed. Prints one JSON line
(the imports' seconds, the parameters' draw, each step's seconds with
the device synchronised, and whether ``torch._dynamo`` was imported
before and after the first step: ``torch.utils.checkpoint`` imports it
at its first call) and the card's name and power limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-recompute", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    import torch

    from repro_torch import configs
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import make_train_step

    dev = resolve_device(args.device)
    imports_s = time.perf_counter() - T_START
    if args.no_recompute:
        T._recorded = lambda fn, *a: fn(*a)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    cfg = configs.get(args.arch).smoke_config
    loss, specs, mk = cli.make_lm_pipeline(cfg, 8, 128, 0, dev)
    t = time.perf_counter()
    params = init_params(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    sync()
    init_s = time.perf_counter() - t
    init, step = make_train_step(loss, OptConfig(lr=1e-3))
    state = init(params)
    dynamo = ["torch._dynamo" in sys.modules]
    steps = []
    for s in range(args.steps):
        t = time.perf_counter()
        state, _ = step(state, mk(s), donate=True)
        sync()
        steps.append(time.perf_counter() - t)
        if s == 0:
            dynamo.append("torch._dynamo" in sys.modules)
    name = "cpu"
    if dev.type == "cuda":
        name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"arch": args.arch, "recompute": not args.no_recompute,
                      "imports_s": imports_s, "init_s": init_s,
                      "step_s": steps,
                      "dynamo_before_first_step": dynamo[0],
                      "dynamo_after_first_step": dynamo[1]}))
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
