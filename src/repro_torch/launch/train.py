"""End-to-end training CLI — port of ``repro.launch.train``:

  python -m repro_torch.launch.train --arch gat-cora --steps 200
  python -m repro_torch.launch.train --arch gemma-2b --steps 50 \\
      --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train ... --device cpu

Trains the arch's ``SMOKE`` config with random weights from ``--seed``
on deterministic synthetic data (``train.data``; a GNN on one
``build_gnn_batch`` graph of 400 nodes), checkpointing every
``--ckpt-every`` steps and resuming from the latest checkpoint in
``--ckpt-dir``. Prints the reference's lines: the wall time, the logged
losses and whether the loss improved. Runs on the CUDA device unless
``--device`` names another (``cpu`` on purpose); without one it exits 2.
"""
from __future__ import annotations

import argparse
import sys
import time


def make_lm_pipeline(cfg, batch: int, seq: int, seed: int, device):
    import torch

    from ..models import transformer as T
    from ..train import data

    def mk(step):
        return {k: torch.as_tensor(v, device=device) for k, v in
                data.lm_batch(step, batch, seq, cfg.vocab, seed).items()}
    return (lambda p, b: T.loss_fn(p, b, cfg)), T.build_specs(cfg), mk


def make_dlrm_pipeline(cfg, batch: int, seed: int, device):
    import torch

    from ..models import dlrm as DL
    from ..train import data

    def mk(step):
        return {k: torch.as_tensor(v, device=device) for k, v in
                data.dlrm_batch(step, batch, cfg.n_dense, cfg.n_sparse,
                                cfg.vocab_per_table, cfg.bag_size,
                                seed).items()}
    return (lambda p, b: DL.loss_fn(p, b, cfg)), DL.build_specs(cfg), mk


def make_gnn_pipeline(entry, cfg, seed: int, device):
    import importlib

    from .gnn_data import build_gnn_batch

    batch = build_gnn_batch(entry.arch_id, cfg, n=400, seed=seed,
                            device=device)
    mod = importlib.import_module(
        f"repro_torch.models.gnn.{_mod_name(entry.arch_id)}")
    return (lambda p, b: mod.loss_fn(p, b, cfg)), mod.build_specs(cfg), \
        (lambda step: batch)


def _mod_name(arch_id: str) -> str:
    return {"gat-cora": "gat", "schnet": "schnet", "nequip": "nequip",
            "dimenet": "dimenet"}[arch_id]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                         "device; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    import torch

    from .. import configs
    from ..kernels.dispatch import NoCudaDevice, resolve_device
    from ..models.common import init_params
    from ..train.optimizer import OptConfig
    from ..train.trainer import TrainLoopConfig, make_train_step, run_loop

    try:
        dev = resolve_device(args.device)
    except NoCudaDevice as exc:
        print(f"train: no CUDA device ({exc}); pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    entry = configs.get(args.arch)
    cfg = entry.smoke_config
    if entry.kind == "lm":
        loss, specs, mk = make_lm_pipeline(cfg, args.batch, args.seq,
                                           args.seed, dev)
    elif entry.kind == "recsys":
        loss, specs, mk = make_dlrm_pipeline(cfg, max(args.batch, 64),
                                             args.seed, dev)
    else:
        loss, specs, mk = make_gnn_pipeline(entry, cfg, args.seed, dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(specs, gen, device=dev)
    init_state, step = make_train_step(
        loss, OptConfig(name=args.optimizer, lr=args.lr),
        microbatches=args.microbatches)
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           log_every=max(1, args.steps // 10))
    t0 = time.time()
    state, hist = run_loop(init_state, step, mk, params, loop)
    dt = time.time() - t0
    print(f"arch={args.arch} steps={args.steps} wall={dt:.1f}s")
    for s, l in hist["loss"]:
        print(f"  step {s:5d}  loss {l:.4f}")
    first, last = hist["loss"][0][1], hist["loss"][-1][1]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
