"""Wrapper of the ``lp_gain`` CUDA kernel (``csrc/lp_gain.cu``).

The label-propagation gain over ELL rows: the hand-written Hopper port of
the JAX package's Pallas kernel ``repro/kernels/lp_gain/lp_gain.py::
lp_gain_ell``. A CPU tensor runs the plain version (``ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import lp_gain_ell_ref

_SIG = {"lp_gain_ell": [_build.P] * 6 + [_build.I] * 2 + [_build.P] * 4}


def check_launch(N: int, D: int) -> None:
    """Raise unless N rows of D lanes fit the launch."""
    if D < 1:
        raise ValueError("lp_gain_ell: rows have no lanes")
    if N >= 2**31:
        raise ValueError(f"lp_gain_ell: {N} rows exceed the launch limit")


def lp_gain_ell(lab, w, tgt_w, own_lab, vw, budget, *, row_tile: int = 256):
    """``(best, target, own_conn)``, each (N, 1) f32 / int32 / f32; the
    contract of ``ref.lp_gain_ell_ref``. ``row_tile`` must divide N, as
    the reference asserts; the kernel itself takes any N."""
    N, D = lab.shape
    if row_tile < 1 or N % row_tile:
        raise ValueError(f"lp_gain_ell: row_tile {row_tile} does not "
                         f"divide the {N} rows")
    if lab.device.type == "cpu":
        return lp_gain_ell_ref(lab, w, tgt_w, own_lab, vw, budget)
    if lab.device.type != "cuda":
        raise ValueError(f"lp_gain_ell: unsupported device {lab.device}")
    dev = lab.device
    _build.require("lp_gain_ell lab", lab, torch.int32, (N, D), dev)
    for name, t in (("w", w), ("tgt_w", tgt_w)):
        _build.require(f"lp_gain_ell {name}", t, torch.float32, (N, D), dev)
    _build.require("lp_gain_ell own_lab", own_lab, torch.int32, (N, 1), dev)
    _build.require("lp_gain_ell vw", vw, torch.float32, (N, 1), dev)
    _build.require("lp_gain_ell budget", budget, torch.float32, (1, 1), dev)
    check_launch(N, D)
    best = torch.empty(N, 1, dtype=torch.float32, device=dev)
    target = torch.empty(N, 1, dtype=torch.int32, device=dev)
    own_conn = torch.empty(N, 1, dtype=torch.float32, device=dev)
    if N == 0:
        return best, target, own_conn
    lib = _build.load("lp_gain", _SIG)
    p = _build.ptr
    err = lib.lp_gain_ell(p(lab), p(w), p(tgt_w), p(own_lab), p(vw),
                          p(budget), N, D, p(best), p(target), p(own_conn),
                          _build.stream_of(lab))
    _build.check(err, "lp_gain")
    _build.count_launch("lp_gain")
    return best, target, own_conn
