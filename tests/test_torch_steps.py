"""The port's step builders (``repro_torch.launch.steps``) against the
reference's, and its split layouts' numerics on a 2 x 2 mesh.

One JAX subprocess (512 forced host devices) and one port subprocess
(four gloo ranks) run at once (``tests/torch_steps_jobs.py``); both draw
the same inputs from numpy.

Tolerances:

* builders: exact. Every cell's name, ``opt_name`` and ``model_flops``
  (the same formulas in the same order, so the same float), every
  argument leaf's path, shape and dtype, and every in-sharding's spec
  against the reference's ``PartitionSpec`` as a tuple, on the (32, 8)
  and (2, 32, 8) meshes: nothing here is arithmetic.
* numerics (SMOKE configs at float32 compute, so that a reduction split
  across ranks shows as float32 rounding, not as bf16 flips): losses
  within 1e-5 relative, since the sharded reductions sum in another
  order; the gradient norm and AdamW's first moment within ``share`` of
  the largest |value| (1e-3 for the LMs and 1e-4 for GAT and DLRM, the
  gradient tolerances of ``test_torch_train_models.py``), the second
  moment within twice that; updated parameters within 1e-6 of each
  leaf's largest |value| (at least 1) where |m| exceeds ``share`` of its
  largest, and within 2 lr elsewhere: Adam's first step moves an element
  by about lr x sign(g), which flips where g sits at rounding noise;
  logits and caches at ``test_torch_transformer.py``'s float32
  tolerance, rtol 2e-4 with atol 2e-4 of the largest |value|; the DLRM
  serve scores rtol = atol = 1e-5 (``test_torch_models.py``).
* The MoE (granite) is held against the reference at the same mesh
  only: a mesh's data axis sets how its tokens are grouped. The dense
  models' split steps also equal the port's unsplit ones at the same
  tolerances.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401
from torch._subclasses.fake_tensor import is_fake

from repro_torch.configs import load_all
from repro_torch.dist.sharding import MeshShape
from repro_torch.launch import steps
from repro_torch.models.common import map_with_specs

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_steps_jobs as jobs  # noqa: E402

LR = 1e-3
DENSE = ("gemma-2b", "gat-cora", "dlrm-rm2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    env = child_env(PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src")] +
        [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
         if p]), JAX_PLATFORMS="cpu")
    script = os.path.join(HERE, "torch_steps_jobs.py")
    procs = {side: subprocess.Popen(
        [sys.executable, script, side, str(d / f"{side}.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side in ("ref", "port")}
    out = {}
    for side, p in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{side} failed:\n{log[-4000:]}"
        with open(d / f"{side}.pkl", "rb") as f:
            out[side] = pickle.load(f)
    return out


def _port_meta(b):
    args, shardings = {}, {}

    def walk(t, spec, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, spec[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, (v, s) in enumerate(zip(t, spec)):
                walk(v, s, path + (str(i),))
        else:
            key = "/".join(path)
            args[key] = (tuple(t.shape), str(t.dtype).split(".")[-1])
            shardings[key] = tuple(spec)
    walk(b.args, b.in_shardings)
    return args, shardings


@pytest.mark.parametrize("mesh", jobs.PROD_MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", sorted(load_all()))
def test_builders_equal_the_reference(runs, mesh, arch):
    shape, names = mesh
    meta = runs["ref"]["meta"]
    entry = load_all()[arch]
    for s in entry.shapes:
        b = steps.build_step(entry, s.name, MeshShape(names, shape))
        want = meta[(shape, b.name)]
        assert b.opt_name == want["opt_name"], b.name
        assert b.model_flops == want["model_flops"], b.name
        args, shardings = _port_meta(b)
        assert args == want["args"], b.name
        assert shardings == want["shardings"], b.name


def test_builders_cover_every_cell(runs):
    names = {n for _, n in runs["ref"]["meta"]}
    assert len(names) == 40 and len(runs["ref"]["meta"]) == 80
    assert names == {f"{a}/{s.name}" for a, e in load_all().items()
                     for s in e.shapes}


def test_args_are_fake_and_shardings_cover_them():
    """arctic-480b's train state (960 GB of weights) is built as fake
    tensors, one spec tuple at each, as long as its tensor's rank."""
    b = steps.build_step(load_all()["arctic-480b"], "train_4k",
                         MeshShape(("data", "model"), (32, 8)))
    seen = []
    map_with_specs(lambda t, s: seen.append((t, s)), b.args,
                   b.in_shardings)
    assert b.opt_name == "adafactor" and len(seen) > 10
    assert all(is_fake(t) for t, _ in seen)
    assert all(len(s) in (0, t.dim()) for t, s in seen)


def _share(arch):
    return 1e-3 if arch in jobs.LM else 1e-4


def _close_train(got, want, share, what):
    loss_g, loss_w = float(got["1/loss"]), float(want["1/loss"])
    assert abs(loss_g - loss_w) <= 1e-5 * abs(loss_w), (what, loss_g,
                                                         loss_w)
    gn_g, gn_w = float(got["1/grad_norm"]), float(want["1/grad_norm"])
    assert abs(gn_g - gn_w) <= share * gn_w, (what, gn_g, gn_w)
    for k in ("1/finite", "0/step", "0/nan_skips", "0/opt/step"):
        assert np.array_equal(got[k], want[k]), (what, k)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        if not k.startswith("0/opt/") and not k.startswith("0/params/"):
            continue
        if k == "0/opt/step":
            continue
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = np.abs(g.astype(np.float64) - w)
        if k.startswith("0/opt/m/"):
            assert err.max() <= share * scale, (what, k)
        elif k.startswith("0/opt/v/"):
            assert err.max() <= 2 * share * scale, (what, k)
        else:
            m = np.abs(want["0/opt/m/" + k[len("0/params/"):]])
            tight = 1e-6 * max(scale, 1.0)
            big = m > share * float(m.max())
            assert float(err[big].max(initial=0.0)) <= tight, (what, k)
            assert float(err.max()) <= 2 * LR + tight, (what, k)


def _close_forward(got, want, arch, what):
    assert set(got) == set(want), what
    rtol = 1e-5 if arch == "dlrm-rm2" else 2e-4
    for k, w in want.items():
        atol = rtol * (1.0 if arch == "dlrm-rm2"
                       else max(float(np.abs(w).max()), 1e-30))
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("cid", [c[0] for c in jobs.CASES])
def test_split_step_matches_the_reference_at_the_same_mesh(runs, cid):
    _, arch, _, kind, _ = next(c for c in jobs.CASES if c[0] == cid)
    want = runs["ref"]["cases"][cid]["out"]
    got = runs["port"][cid]["split"]
    assert set(got) == set(want), cid
    if kind in ("train", "gnn_full", "recsys_train"):
        _close_train(got, {k: np.asarray(v) for k, v in want.items()},
                     _share(arch), cid)
    else:
        _close_forward(got, want, arch, cid)
    if arch in DENSE:
        unsplit = runs["port"][cid]["unsplit"]
        if kind in ("train", "gnn_full", "recsys_train"):
            _close_train(got, unsplit, _share(arch), cid + " unsplit")
        else:
            _close_forward(got, unsplit, arch, cid + " unsplit")


def test_restore_splits_an_adamw_state_on_a_device_mesh(runs):
    """``checkpoint.restore`` with the train step's state shardings and
    a 2 x 2 ``DeviceMesh`` of gloo ranks gives DTensors whose
    ``full_tensor()`` is the saved array, byte for byte, on every
    leaf; the weights and moments split over ``model``."""
    rows = runs["port"]["checkpoint"]
    assert rows and all(same for _, _, same in rows), \
        [p for p, _, same in rows if not same]
    placed = {p: pl for p, pl, _ in rows}
    assert placed["params/embed"] == ("R", "S0")
    assert placed["opt/m/layers/w_out"] == ("R", "S1")
    assert sum("S" in "".join(pl) for pl in placed.values()) >= 8


def test_adafactor_updates_split_slots_as_it_updates_whole_ones(runs):
    """One Adafactor update on DTensors (gemma-2b SMOKE, factored slots
    laid out as ``launch.steps`` lays them out, their row and column
    means reduced across shards) against the same update on plain
    tensors: every leaf within 1e-6 of its largest |value|, float32
    rounding of means summed in another order."""
    split, plain = runs["port"]["adafactor"]
    assert set(split) == set(plain) and any("/vr" in k for k in plain)
    for k, w in plain.items():
        tol = 1e-6 * max(float(abs(w).max()), 1e-30)
        assert float(abs(split[k] - w).max()) <= tol, k


def test_microbatches_split_the_rows_each_rank_holds(runs):
    """gemma-2b SMOKE at microbatches=2 on the 2 x 2 mesh (each rank's
    i-th block of its own rows is microbatch i) against the plain step
    (rows [i B/2, (i+1) B/2)): the same rows in another grouping, so the
    loss within 1e-5 relative and the step at the train tolerances."""
    split, plain = runs["port"]["microbatches"]
    _close_train(split, plain, _share("gemma-2b"), "microbatches=2")
