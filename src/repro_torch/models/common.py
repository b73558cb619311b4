"""Model substrate: parameter specs with logical sharding axes, init,
and the small set of NN ops everything reuses — port of
``repro.models.common``.

Every parameter is declared as a ``ParamSpec`` carrying its *logical*
axes ('embed', 'mlp', 'heads', 'vocab', 'expert', ...), which
``dist/sharding.py`` maps onto mesh axes. A spec tree is a nested dict
of ``ParamSpec``; a parameter tree the same dicts of tensors, keyed as
the reference keys them, so a reference tree crosses over key for key
(``repro_torch.carry.model_from``).

``init_params`` draws from an explicit ``torch.Generator``. JAX's
threefry stream has no torch counterpart, so equal seeds give other
weights in the two packages: parity runs on carried weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in length")


SpecTree = Any     # nested dict of ParamSpec
ParamTree = Any    # nested dict of torch.Tensor


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], specs: SpecTree):
    """``fn`` over every ``ParamSpec`` of a nested dict, same structure."""
    if is_spec(specs):
        return fn(specs)
    return {k: tree_map_specs(fn, v) for k, v in specs.items()}


def spec_leaves(specs: SpecTree):
    """``(path, spec)`` pairs in the reference's leaf order (dict keys
    sorted at every level, as ``jax.tree_util`` flattens them)."""
    if is_spec(specs):
        return [((), specs)]
    out = []
    for k in sorted(specs):
        out += [((k,) + p, s) for p, s in spec_leaves(specs[k])]
    return out


def _std(spec: ParamSpec) -> float:
    if spec.init == "embed":
        return spec.scale
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else \
        max(1, math.prod(spec.shape))
    return spec.scale / math.sqrt(fan_in)


# a leaf of another dtype than float32 is drawn this many float32
# normals at a time (arctic's bf16 e_in is 8.93e9 elements a layer)
DRAW_CHUNK = 1 << 26


def init_params(specs: SpecTree, generator: torch.Generator,
                device=None) -> ParamTree:
    """Parameters of ``specs`` on ``device`` (the card by default):
    zeros, ones, or normals of the reference's scale, drawn one leaf
    after the other in the reference's leaf order on ``generator``'s
    device (a CUDA generator draws on the card).

    A float32 leaf is one draw of its shape. A leaf of another dtype is
    drawn in float32 ``DRAW_CHUNK`` elements at a time along its
    flattened order, each slice scaled and rounded into the leaf, so it
    never needs a float32 copy of itself whole."""
    device = resolve_device(device)

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.dtype != torch.float32:
            out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
            flat = out.view(-1)
            for i in range(0, flat.numel(), DRAW_CHUNK):
                n = min(DRAW_CHUNK, flat.numel() - i)
                x = torch.randn((n,), generator=generator,
                                dtype=torch.float32, device=generator.device)
                flat[i:i + n] = x.mul_(_std(spec))
            return out
        x = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (x.mul_(_std(spec))).to(device=device, dtype=spec.dtype)

    return _tree_of(specs, {path: one(s) for path, s in spec_leaves(specs)})


def _tree_of(specs: SpecTree, leaves: Dict, path=()) -> Any:
    """``specs``' nested dicts with ``leaves[path]`` at each spec. (A
    module function: a nested recursive one would sit in a reference
    cycle with ``leaves``, which would then outlive the tree until the
    cycle collector ran: gigabytes on the card.)"""
    if is_spec(specs):
        return leaves[path]
    return {k: _tree_of(v, leaves, path + (k,)) for k, v in specs.items()}


def param_count(specs: SpecTree) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(specs))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma + beta).to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_ACT: Dict[str, Callable] = {
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "ssp": lambda x: softplus(x) - math.log(2.0),   # shifted softplus
    "tanh": torch.tanh,
}


def act_fn(name: str):
    return _ACT[name]


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs        # (..., S, half)
    ang = ang[..., None, :]                           # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0):
    """Stable CE in fp32; optional z-loss (log-sum-exp regularizer)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)
