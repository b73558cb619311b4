"""Optimizers from scratch (no ``torch.optim``): AdamW and Adafactor —
port of ``repro.train.optimizer``.

Functional, on trees of tensors (``train.tree``), under
``torch.no_grad()``. The state layouts are the reference's, so a
checkpoint crosses between the two packages: AdamW ``{"m", "v",
"step"}``, Adafactor ``{"slots": {...: {"vr", "vc"} | {"v"}}, "step"}``
with ``step`` an int32 scalar. Each leaf is updated in the reference's
op order: cast to float32, update, cast back to the leaf's dtype.

Adafactor (Shazeer & Stern, arXiv:1804.04235) keeps a factored second
moment (row and column means) for every matrix whose last two dims are
both at least ``min_dim_factored``.

``donate=True`` writes each leaf's new values into the tensors it was
given (parameters, moments) and returns those: the values are the same,
but a step holds one copy of the state, as the reference's jitted step
reuses the buffers donated to it. ``trainer.run_loop`` donates. AdamW,
elementwise, updates a leaf ``UPDATE_CHUNK`` elements at a time, so its
temporaries stay small beside a large stacked leaf (gemma-2b's ``w_in``
is 4.8 GB in float32; whole, its ~7 temporaries took 34 GB); the values
are the whole leaf's.

On DTensors (the split layouts) AdamW updates each rank's local shard,
the gradient and moments first laid out as the parameter is: a flat
view of a sharded leaf is no DTensor layout, and the update is
elementwise, so the values are the same. Adafactor's row and column
means reduce across shards through DTensor. New slots and accumulators
of a DTensor leaf are DTensors over its mesh (``zeros_of``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from .tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"               # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """``(grads scaled to a global norm of at most max_norm, norm)``; the
    norm sums the leaves' float32 squares in leaf order."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# elements of a leaf AdamW updates at a time (128 MB of float32)
UPDATE_CHUNK = 1 << 25


def _put(old: torch.Tensor, new: torch.Tensor, donate: bool):
    """``new``, written into ``old`` when donating."""
    return old.copy_(new) if donate else new


def _flat_out(t: torch.Tensor) -> torch.Tensor:
    """``t`` as one flat view, to be written slice by slice."""
    if not t.is_contiguous():
        raise ValueError("a donated parameter or moment must be a "
                         "contiguous tensor")
    return t.view(-1)


def zeros_of(p, shape, dtype, drop=None):
    """Zeros of ``shape`` and ``dtype`` beside ``p``: on a DTensor ``p``
    a DTensor over its mesh, sharded as ``p`` is on the dims it keeps
    (``drop``: the one dim of ``p`` the shape leaves out)."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    out = []
    for pl in p.placements:
        if not pl.is_shard():
            out.append(Replicate())
            continue
        d = pl.dim
        if drop is not None:
            drop_d = drop % p.dim()
            if d == drop_d:
                out.append(Replicate())
                continue
            d -= d > drop_d
        out.append(Shard(d))
    return dtensor_zeros(tuple(shape), dtype=dtype,
                         device_mesh=p.device_mesh, placements=out)


def _local_like(x, p):
    """``x`` laid out as ``p`` and taken local, where ``p`` is a
    DTensor; else ``x``."""
    if not isinstance(p, DTensor):
        return x
    if not isinstance(x, DTensor):
        raise TypeError("a DTensor parameter needs DTensor gradients and "
                        "moments")
    if tuple(x.placements) != tuple(p.placements):
        x = x.redistribute(p.device_mesh, p.placements)
    return x.to_local()


def _scalar(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _step_scalar(params):
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    def zeros(p):
        return zeros_of(p, p.shape, torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step_scalar(params)}


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptConfig, donate: bool = False):
    step = state["step"] + 1
    t = _scalar(step).float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(g, m, v, p):
        if isinstance(p, DTensor):
            new = upd(*(_local_like(x, p) for x in (g, m, v, p)))
            return tuple(DTensor.from_local(x, p.device_mesh, p.placements,
                                            run_check=False, shape=p.shape,
                                            stride=p.stride())
                         for x in new)
        outs = (p, m, v) if donate else tuple(
            torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for x in (p, m, v))
        gf, mf, vf, pf = (x.reshape(-1) for x in (g, m, v, p))
        of = [_flat_out(t) for t in outs]
        for i in range(0, pf.numel(), UPDATE_CHUNK):
            sl = slice(i, i + UPDATE_CHUNK)
            g_, m_, v_, p_ = gf[sl].float(), mf[sl], vf[sl], pf[sl]
            m_new = cfg.b1 * m_ + (1 - cfg.b1) * g_
            v_new = cfg.b2 * v_ + (1 - cfg.b2) * torch.square(g_)
            mh = m_new / bc1
            vh = v_new / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) + \
                cfg.weight_decay * p_.float()
            of[0][sl] = (p_.float() - cfg.lr * delta).to(p.dtype)
            of[1][sl] = m_new
            of[2][sl] = v_new
        return outs

    out = [upd(g, m, v, p) for g, m, v, p in
           zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
               leaves(params))]
    return unflatten(params, [o[0] for o in out]), {
        "m": unflatten(params, [o[1] for o in out]),
        "v": unflatten(params, [o[2] for o in out]), "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------

def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, cfg: OptConfig):
    def one(p):
        f32 = torch.float32
        if _factored(p.shape, cfg.min_dim_factored):
            return {"vr": zeros_of(p, p.shape[:-1], f32, drop=-1),
                    "vc": zeros_of(p, p.shape[:-2] + p.shape[-1:], f32,
                                   drop=-2)}
        return {"v": zeros_of(p, p.shape, f32)}
    return {"slots": unflatten(params, [one(p) for p in leaves(params)]),
            "step": _step_scalar(params)}


def slots_of(params, slots):
    """The slot dict of every parameter leaf, in leaf order."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in slots_of(params[k], slots[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, sl in zip(params, slots) for s in slots_of(p, sl)]
    return [slots]


@torch.no_grad()
def adafactor_update(grads, state, params, cfg: OptConfig,
                     donate: bool = False):
    step = state["step"] + 1
    t = step.float()
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    lr = cfg.lr

    def upd(g, slot, p):
        g = g.float()
        g2 = torch.square(g) + 1e-30
        if "vr" in slot:
            vr = beta2 * slot["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * slot["vc"] + (1 - beta2) * g2.mean(-2)
            rfac = vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
            prec = rfac[..., None] * vc[..., None, :]
            new_slot = {"vr": _put(slot["vr"], vr, donate),
                        "vc": _put(slot["vc"], vc, donate)}
        else:
            v = beta2 * slot["v"] + (1 - beta2) * g2
            prec = v
            new_slot = {"v": _put(slot["v"], v, donate)}
        u = g * torch.rsqrt(prec + 1e-30)
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        newp = p.float() - lr * u - lr * cfg.weight_decay * p.float()
        return _put(p, newp.to(p.dtype), donate), new_slot

    out = [upd(g, s, p) for g, s, p in
           zip(leaves(grads), slots_of(params, state["slots"]),
               leaves(params))]
    return unflatten(params, [o[0] for o in out]), {
        "slots": unflatten(params, [o[1] for o in out]), "step": step}


def make_optimizer(cfg: OptConfig):
    """``(init(params), update(grads, state, params, donate=False))``."""
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p, donate=False: adamw_update(
            g, s, p, cfg, donate)
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p, donate=False: adafactor_update(
                    g, s, p, cfg, donate))
    raise ValueError(cfg.name)
