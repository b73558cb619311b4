"""Train a GAT for a few hundred steps with partitioner-driven placement —
the port's counterpart of the reference's
``examples/gnn_partitioned_training.py``, as a CLI:

  python -m repro_torch.launch.gnn_partitioned_training
  python -m repro_torch.launch.gnn_partitioned_training --device cpu

The example's steps: an rgg2d graph of 4000 vertices (seed 7) with its
ids shuffled (no free locality), ``gnn_placement.plan`` on 8 devices,
then 300 AdamW steps (lr 3e-3) of a small GAT on the placed graph, its
labels the community of each placed id. Prints the halo bytes the
placement saves and the loss trail; exits 1 if the loss did not fall.
Runs on the CUDA device unless ``--device`` names another (``cpu`` on
purpose); without one it exits 2. The placement's kernels and the GAT
run on that device.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PLACE_CONFIG = dict(contraction_limit=64, ip_repetitions=2, num_chunks=4)
STEPS, LOG_EVERY, LR = 300, 50, 3e-3


def place(device, n: int = 4000, seed: int = 7, n_devices: int = 8):
    """``(plan, rng)``: the example's shuffled graph placed on
    ``n_devices``; ``rng`` (numpy, seed 0) has drawn the shuffle and
    goes on to draw the features."""
    from ..core.partitioner import PartitionerConfig
    from ..graphs import generators
    from ..graphs.format import permute
    from ..placement import gnn_placement

    g = generators.make("rgg2d", n, 8.0, seed=seed)
    rng = np.random.default_rng(0)
    g, _ = permute(g, rng.permutation(g.n))
    plan = gnn_placement.plan(g, n_devices,
                              config=PartitionerConfig(**PLACE_CONFIG),
                              device=device)
    return plan, rng


def gat_config():
    from ..models.gnn import gat
    return gat.GATConfig(d_in=32, d_hidden=8, n_heads=4, n_classes=5)


def placed_batch(plan, rng, cfg, device):
    """The placed graph's batch: features from ``rng``, and as labels the
    community of each placed id (``n_classes`` contiguous ranges)."""
    import torch

    from ..models.gnn.common import GraphBatch

    g2 = plan.graph
    N = g2.n + 1
    feat = rng.standard_normal((N, cfg.d_in)).astype(np.float32)
    labels = np.zeros(N, dtype=np.int64)
    labels[:g2.n] = (np.arange(g2.n) * cfg.n_classes) // g2.n

    def dev(x):
        return torch.as_tensor(x, device=device)
    return GraphBatch(senders=dev(g2.arc_tails().astype(np.int32)),
                      receivers=dev(np.asarray(g2.adjncy, dtype=np.int32)),
                      n_node=N, node_feat=dev(feat), labels=dev(labels),
                      node_mask=dev(np.arange(N) < g2.n))


def train(params, batch, cfg, steps: int = STEPS,
          log_every: int = LOG_EVERY):
    """The example's loop: ``(state, history)``."""
    from ..models.gnn import gat
    from ..train.optimizer import OptConfig
    from ..train.trainer import TrainLoopConfig, make_train_step, run_loop

    init_state, step = make_train_step(
        lambda p, b: gat.loss_fn(p, b, cfg), OptConfig(lr=LR))
    return run_loop(init_state, step, lambda s: batch, params,
                    TrainLoopConfig(steps=steps, log_every=log_every))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                         "device; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    import torch

    from ..kernels.dispatch import NoCudaDevice, resolve_device
    from ..models.common import init_params
    from ..models.gnn import gat

    try:
        dev = resolve_device(args.device)
    except NoCudaDevice as exc:
        print(f"gnn_partitioned_training: no CUDA device ({exc}); pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2
    plan, rng = place(dev)
    print(f"halo bytes/exchange: naive={plan.baseline_halo_bytes} "
          f"partitioned={plan.halo_bytes} "
          f"({plan.baseline_halo_bytes / max(plan.halo_bytes, 1):.2f}x "
          "less)")
    cfg = gat_config()
    batch = placed_batch(plan, rng, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gat.build_specs(cfg), gen, device=dev)
    t0 = time.time()
    _, hist = train(params, batch, cfg)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{STEPS} steps in {time.time() - t0:.1f}s on {name}; loss: "
          + " -> ".join(f"{l:.3f}" for _, l in hist["loss"]))
    if not hist["loss"][-1][1] < hist["loss"][0][1]:
        print("gnn_partitioned_training: the loss did not fall",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
