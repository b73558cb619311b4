"""The train step and its fault-tolerant training loop — port of
``repro.train.trainer``.

``make_train_step`` closes over a loss function and an optimizer and
returns ``(state, batch) -> (state, metrics)``, its gradients from
autograd. The loop layers the production concerns on top:

  * checkpoint/restart   — periodic atomic saves, auto-resume
    (``checkpoint.py``);
  * deterministic data   — batch = f(seed, step): restart-safe skipping;
  * straggler/failure    — a watchdog wall-clock per step aborts the run
    (exit code 75) so the scheduler can relaunch it, to resume from the
    last checkpoint;
  * NaN containment      — non-finite losses or grad norms skip the
    update and are counted; persistent NaNs abort.

A state is ``{"params", "opt", "step", "nan_skips"}``, the reference's
tree (``step`` and ``nan_skips`` int32 scalars), so a checkpoint crosses
between the two packages. The step runs on DTensor states as it runs on
plain ones (the split layouts, ``launch/steps.py``): the loss is
replicated before its gradient, a microbatch takes each rank's own rows
(``microbatch``), and on fake tensors (a dry-run) the non-finite check,
which has no value to read, takes the updating branch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate

from ..dist.sharding import contiguous_stride
from . import checkpoint
from .optimizer import OptConfig, clip_by_global_norm, make_optimizer, \
    zeros_of
from .tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    step_timeout_s: float = 0.0      # 0 = no watchdog
    max_nan_skips: int = 10


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: autograd over
    detached copies of the parameter leaves (they share storage), so the
    caller's tensors never enter a graph. A leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    ps = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = _replicated(loss_fn(unflatten(params, ps), batch))
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, ps)]
    return loss.detach(), unflatten(params, grads)


def _replicated(x):
    """A DTensor sharded or partial on some mesh dimension, replicated
    (a loss is one value on every rank); anything else as it is."""
    if isinstance(x, DTensor) and any(not p.is_replicate()
                                      for p in x.placements):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


def finite_on_host(flag) -> bool:
    """The host's reading of a step's finiteness flag. A fake tensor (a
    dry-run) has no value: its step is the one that updates, the branch
    the reference's compiled ``lax.cond`` holds."""
    if isinstance(flag, DTensor):
        flag = flag.to_local()
    return True if is_fake(flag) else bool(flag)


def microbatch(x, i: int, n: int):
    """Microbatch ``i`` of ``n`` of ``x``'s leading axis: rows [i B/n,
    (i+1) B/n), as the reference's reshape and scan take them. A DTensor
    split on that axis gives each rank's ``i``-th block of its own rows
    instead: the same rows in another grouping, so the step's loss and
    gradient are the same sums in another order, and no row moves."""
    if isinstance(x, DTensor) and any(p.is_shard(0) for p in x.placements):
        loc = x.to_local()
        part = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))[i]
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        return DTensor.from_local(part, x.device_mesh, x.placements,
                                  run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig,
                    microbatches: int = 1, accum_dtype=None):
    """loss_fn(params, batch) -> scalar. Returns ``(init_state,
    train_step)``; ``train_step(state, batch, donate=False)``.

    ``microbatches > 1`` enables gradient accumulation: the global batch
    (a dict of tensors) is split on the leading axis and each
    microbatch's ``g / microbatches`` is summed in ``accum_dtype``
    (float32 by default), in order, as the reference's ``lax.scan``
    sums them. A non-finite loss or grad norm skips the update: params
    and optimizer state come back as they were, ``step`` still advances
    and ``nan_skips`` counts the skip. ``donate`` writes the update into
    the state's own tensors (``optimizer`` module)."""
    opt_init, opt_update = make_optimizer(opt_cfg)
    adt = accum_dtype or torch.float32

    def init_state(params):
        dev = leaves(params)[0].device
        return {"params": params, "opt": opt_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "nan_skips": torch.zeros((), dtype=torch.int32, device=dev)}

    def _value_and_grad(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        if not isinstance(batch, dict):
            raise TypeError("microbatches > 1 split a dict batch of "
                            f"tensors, not a {type(batch).__name__}")
        loss = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
        grads = tree_map(lambda p: zeros_of(p, p.shape, adt), params)
        for i in range(microbatches):
            li, gi = value_and_grad(loss_fn, params, {
                k: microbatch(v, i, microbatches) for k, v in batch.items()})
            grads = tree_map(lambda a, g: a + (g / microbatches).to(a.dtype),
                             grads, gi)
            loss = loss + li / microbatches
        return loss, grads

    def train_step(state, batch, donate: bool = False):
        loss, grads = _value_and_grad(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        if finite_on_host(finite):
            new_p, new_opt = opt_update(grads, state["opt"],
                                        state["params"], donate=donate)
        else:
            new_p, new_opt = state["params"], state["opt"]
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1,
                     "nan_skips": state["nan_skips"]
                     + (1 - finite.to(torch.int32))}
        metrics = {"loss": loss, "grad_norm": gnorm, "finite": finite}
        return new_state, metrics

    return init_state, train_step


def run_loop(init_state, train_step, make_batch: Callable[[int], Any],
             params, loop_cfg: TrainLoopConfig) -> Tuple[Any, Dict]:
    """Fault-tolerant loop. Returns (final_state, history).

    The loop trains a copy of ``params`` and donates its own state to
    every step, so the caller's parameters stay as they were. The
    reference's ``jit`` flag (jit the step and donate its state) has no
    counterpart: the port's step runs op by op either way."""
    params = tree_map(torch.clone, params)
    state = init_state(params)
    start = 0
    if loop_cfg.ckpt_dir:
        last = checkpoint.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state, extra = checkpoint.restore(loop_cfg.ckpt_dir, state)
            start = int(extra.get("next_step", last))
    history = {"loss": [], "grad_norm": []}
    for step in range(start, loop_cfg.steps):
        t0 = time.time()
        batch = make_batch(step)
        state, metrics = train_step(state, batch, donate=True)
        if loop_cfg.step_timeout_s and \
                time.time() - t0 > loop_cfg.step_timeout_s:
            # straggler watchdog: surface to the scheduler for relaunch
            raise SystemExit(75)
        if (step + 1) % loop_cfg.log_every == 0 or step == start:
            history["loss"].append((step, float(metrics["loss"])))
            history["grad_norm"].append((step,
                                         float(metrics["grad_norm"])))
        nan_skips = int(state["nan_skips"])
        if nan_skips > loop_cfg.max_nan_skips:
            raise RuntimeError(f"too many non-finite steps ({nan_skips})")
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            checkpoint.save(loop_cfg.ckpt_dir, step + 1, state,
                            extra={"next_step": step + 1})
            checkpoint.prune(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts)
    return state, history
