"""Gradients and train steps of the port's models (``repro_torch.models``
with ``repro_torch.train``) against the JAX package on the same numpy
inputs, on the CPU, at each arch's ``SMOKE`` config, B <= 2, S <= 16.

The reference's parameters come from its own ``init_params`` and cross
over through ``carry.model_from``, its optimizer and train states
through ``carry.opt_state_from`` / ``train_state_from``. Its LM
functions are compiled with XLA's excess precision off, as
``tests/test_torch_transformer.py::strict`` compiles them (every bf16 op
rounded on its own, as in its eager run). Tolerances, and why:

* losses: 1e-6 relative; the forwards are the reference's op for op.
* LM gradients at float32: each leaf within ``LM_GRAD_SHARE`` = 1e-3 of
  its own largest |gradient|. Sums in another order leave ~1e-7 of each
  product, and backward through attention's softmax and the cross
  entropy subtracts weighted means, so a leaf's small elements carry the
  absolute error of its large ones: elementwise rtol = atol = 2e-4 does
  not hold on the ``embed`` leaves (gradients up to ~170). The largest
  share measured is 3.5e-4 (arctic ``wq``); 1e-3 leaves ~3x.
* LM gradients at bf16 compute (gemma-2b): ``LM_BF16_SHARE`` = 2^-4 of
  each leaf's largest |gradient|. Backward rounds every activation
  gradient to bf16 (2^-9 relative) and a leaf sums B·S of them; the
  largest share measured over the five archs is 0.031 (stablelm
  ``wq``), gemma-2b's 0.019.
* GNN and DLRM gradients: rtol = atol = 1e-4, the NequIP / DimeNet
  forward tolerance (``tests/test_torch_models.py``).
* one train step: loss, grad norm, ``m`` and ``v`` as the gradients
  (``v`` at twice the share: it is g^2); parameters by
  ``assert_adam_step_close`` below.
"""
import dataclasses
import functools

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import dlrm as ref_dlrm  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.models.gnn import common as ref_gcommon  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import gat as ref_gat  # noqa: E402
from repro.models.gnn import nequip as ref_nequip  # noqa: E402
from repro.models.gnn import schnet as ref_schnet  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.models import dlrm, transformer as T  # noqa: E402
from repro_torch.models.gnn import dimenet, gat, nequip, schnet  # noqa: E402
from repro_torch.train import optimizer, trainer  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths, \
    tree_map  # noqa: E402

CPU = "cpu"
LMS = list(carry.LM_ARCHS)
GNNS = ["gat-cora", "schnet", "nequip", "dimenet"]
REF = {"gat-cora": ref_gat, "schnet": ref_schnet, "nequip": ref_nequip,
       "dimenet": ref_dimenet, "dlrm-rm2": ref_dlrm}
PORT = {"gat-cora": gat, "schnet": schnet, "nequip": nequip,
        "dimenet": dimenet, "dlrm-rm2": dlrm}
LOSS_REL = 1e-6
LM_GRAD_SHARE = 1e-3
LM_BF16_SHARE = 2.0 ** -4
MODEL_TOL = 1e-4
REF_ENTRIES = ref_configs.load_all()
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def strict(fn, *args):
    """``fn`` compiled for ``args``' shapes with XLA's excess precision
    off (``tests/test_torch_transformer.py::strict``)."""
    return jax.jit(fn).lower(*args).compile(
        dict(FAST_COMPILE, xla_allow_excess_precision=False))


def ref_run(fn, *args):
    return strict(fn, *args)(*args)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def by_path(tree):
    """``{path: float32 numpy leaf}`` of a tree of either package (a
    dict of that form passes through)."""
    if isinstance(tree, dict) and tree and all(
            isinstance(k, tuple) for k in tree):
        return tree
    if not isinstance(leaves(tree)[0], torch.Tensor):
        tree = jax.tree_util.tree_map(np.asarray, tree)
    return {p: as_np(v) for p, v in leaves_with_paths(tree)}


def assert_tree_shares(got, want, share, what):
    """Every leaf of ``got`` within ``share`` x its ``want`` leaf's
    largest |value|; the same paths on both sides."""
    g, w = by_path(got), by_path(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        err = float(np.abs(g[p] - w[p]).max()) if w[p].size else 0.0
        scale = float(np.abs(w[p]).max()) if w[p].size else 0.0
        assert err <= share * scale + 1e-30, \
            f"{what} {'/'.join(p)}: {err} beyond {share} x {scale}"


def assert_tree_close(got, want, tol, what):
    g, w = by_path(got), by_path(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        np.testing.assert_allclose(g[p], w[p], rtol=tol, atol=tol,
                                   err_msg=f"{what} {'/'.join(p)}")


def loss_close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)


# ---------------------------------------------------------------------------
# models and batches on both sides
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's own init of the arch's SMOKE config (compiled:
    eagerly it dispatches op by op, ~3 s a model)."""
    mod = REF.get(arch, ref_T)
    specs = mod.build_specs(REF_ENTRIES[arch].smoke_config)
    key = jax.random.key(0)
    return jax.jit(lambda k: ref_common.init_params(specs, k)).lower(
        key).compile(FAST_COMPILE)(key)


def lm(arch, dtype="float32"):
    """(reference cfg, reference params, port params, port cfg); the
    parameters (their spec dtypes) serve every compute dtype."""
    cfg = dataclasses.replace(REF_ENTRIES[arch].smoke_config,
                              compute_dtype=getattr(jnp, dtype))
    ref = _ref_params(arch)
    arrays = jax.tree_util.tree_map(np.asarray, ref)
    params, pcfg = carry.model_from(arch, arrays, dataclasses.asdict(cfg),
                                    device=CPU)
    return cfg, ref, params, pcfg


def lm_tokens(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def gat_fields(rng, cfg, n=60, e=200):
    """``tests/test_torch_models.py``'s GAT batch: random arcs and five
    sentinel (padding) edges."""
    snd = np.concatenate([rng.integers(0, n, e), np.full(5, n)])
    rcv = np.concatenate([rng.integers(0, n, e), np.full(5, n)])
    return dict(senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
                n_node=n + 1,
                node_feat=rng.standard_normal((n + 1, cfg.d_in))
                .astype(np.float32),
                labels=rng.integers(0, cfg.n_classes, n + 1),
                node_mask=np.arange(n + 1) < n)


def mol_fields(rng, n=24, e=64, n_graphs=2, want_trip=False):
    """``tests/test_arch_smoke.py::_mol_batch``'s batch as numpy fields."""
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n, e)
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    snd, rcv = np.concatenate([snd, rcv]), np.concatenate([rcv, snd])
    pos = rng.standard_normal((n + 1, 3)).astype(np.float32) * 1.5
    f = dict(senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
             n_node=n + 1, species=rng.integers(0, 10, n + 1),
             positions=pos,
             graph_id=(np.arange(n + 1) * n_graphs // (n + 1)).astype(
                 np.int32),
             n_graphs=n_graphs,
             labels=rng.standard_normal(n_graphs).astype(np.float32),
             node_mask=np.arange(n + 1) < n)
    if want_trip:
        kj, ji = ref_dimenet.build_triplets(f["senders"], f["receivers"],
                                            n + 1, cap=4 * snd.shape[0])
        f.update(trip_kj=kj, trip_ji=ji)
    return f


def dlrm_fields(rng, cfg, B=16, bag=2):
    return dict(dense=rng.standard_normal((B, cfg.n_dense))
                .astype(np.float32),
                sparse=rng.integers(0, cfg.vocab_per_table,
                                    (B, cfg.n_sparse, bag)).astype(np.int32),
                labels=rng.integers(0, 2, B).astype(np.float32))


def small_model(arch):
    """(reference cfg, reference params, port params, port cfg,
    reference batch, port batch) of a GNN or DLRM."""
    cfg = REF_ENTRIES[arch].smoke_config
    ref = _ref_params(arch)
    params, pcfg = carry.model_from(
        arch, {k: np.asarray(v) for k, v in ref.items()},
        dataclasses.asdict(cfg), device=CPU)
    rng = np.random.default_rng(3)
    if arch == "dlrm-rm2":
        f = dlrm_fields(rng, cfg)
        return cfg, ref, params, pcfg, \
            {k: jnp.asarray(v) for k, v in f.items()}, \
            carry.dlrm_batch_from(f, device=CPU)
    f = gat_fields(rng, cfg) if arch == "gat-cora" else \
        mol_fields(rng, want_trip=(arch == "dimenet"))
    rb = ref_gcommon.GraphBatch(**{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in f.items()})
    return cfg, ref, params, pcfg, rb, carry.graph_batch_from(f, device=CPU)


# ---------------------------------------------------------------------------
# backward through every model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LMS)
def test_lm_backward_runs_and_remat_changes_no_gradient(arch):
    """``loss.backward()`` through every SMOKE LM: each leaf gets a finite
    gradient, and ``remat`` (each layer and attention block recomputed
    in backward) gives the same gradients bit for bit. The blockwise
    attention once changed its scores in place, which autograd refuses
    ("modified by an inplace operation")."""
    cfg, _, params, pcfg = lm(arch)
    toks = torch.tensor(lm_tokens(cfg), dtype=torch.int64)
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(pcfg, remat=remat)
        ps = {k: ({n: v.clone().requires_grad_() for n, v in t.items()}
                  if isinstance(t, dict) else t.clone().requires_grad_())
              for k, t in params.items()}
        loss = T.loss_fn(ps, {"tokens": toks}, c)
        loss.backward()
        grads[remat] = {p: v.grad for p, v in leaves_with_paths(ps)}
        assert all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads[remat].values())
    for p, g in grads[False].items():
        assert torch.equal(g, grads[True][p]), p


def test_layers_unbind_keeps_the_forward_and_assembles_each_gradient_once():
    """``forward`` takes each stacked leaf apart by one ``unbind``: the
    logits are those of the per-layer views, and each stacked leaf's
    gradient is one tensor of the leaf's shape."""
    _, _, params, pcfg = lm("granite-moe-1b-a400m")
    toks = torch.tensor(lm_tokens(pcfg), dtype=torch.int64)
    got = T.forward(params, toks, pcfg)[0]
    x = T._embed(params, toks, pcfg)
    pos = torch.arange(16)[None].expand(2, 16)
    for li in range(pcfg.n_layers):
        x, _ = T._layer_fn(T._layer(params, li), x, pos, pcfg, T.NULL_CTX)
    assert torch.equal(got, T._logits(params, x, pcfg, softcap=True))
    lp = T._layers(params, pcfg.n_layers)
    w = params["layers"]["wq"].clone().requires_grad_()
    parts = T._layers({"layers": {"wq": w}}, 2)
    (parts[0]["wq"].sum() + 2 * parts[1]["wq"].sum()).backward()
    assert w.grad.shape == w.shape and float(w.grad[1].min()) == 2.0
    assert torch.equal(lp[1]["wq"], params["layers"]["wq"][1])


# ---------------------------------------------------------------------------
# value_and_grad against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in LMS]
                         + [("gemma-2b", "bfloat16")])
def test_lm_value_and_grad_match_reference(arch, dtype):
    cfg, ref, params, pcfg = lm(arch, dtype)
    toks = lm_tokens(cfg)
    want_loss, want = ref_run(jax.value_and_grad(
        lambda p, t: ref_T.loss_fn(p, {"tokens": t}, cfg)), ref,
        jnp.asarray(toks))
    loss, grads = trainer.value_and_grad(
        lambda p, b: T.loss_fn(p, b, pcfg), params,
        {"tokens": torch.tensor(toks, dtype=torch.int64)})
    loss_close(loss, want_loss)
    assert_tree_shares(grads, want, LM_GRAD_SHARE if dtype == "float32"
                       else LM_BF16_SHARE, f"{arch} {dtype} grad")


def test_moe_aux_loss_carries_its_gradient_to_the_router():
    """The Switch aux loss alone reaches the router, as the reference's
    does, and equals its gradient there."""
    cfg, ref, params, pcfg = lm("granite-moe-1b-a400m")
    toks = lm_tokens(cfg)
    want = ref_run(jax.grad(lambda p, t: ref_T.forward(p, t, cfg)[1]), ref,
                   jnp.asarray(toks))
    _, grads = trainer.value_and_grad(
        lambda p, b: T.forward(p, b, pcfg)[1], params,
        torch.tensor(toks, dtype=torch.int64))
    router = grads["layers"]["router"]
    assert float(router.abs().max()) > 0
    assert_tree_shares(grads["layers"]["router"],
                       want["layers"]["router"], LM_GRAD_SHARE, "router")


@pytest.mark.parametrize("arch", GNNS + ["dlrm-rm2"])
def test_gnn_and_dlrm_value_and_grad_match_reference(arch):
    cfg, ref, params, pcfg, rb, pb = small_model(arch)
    want_loss, want = ref_run(jax.value_and_grad(
        lambda p: REF[arch].loss_fn(p, rb, cfg)), ref)
    loss, grads = trainer.value_and_grad(
        lambda p, b: PORT[arch].loss_fn(p, b, pcfg), params, pb)
    loss_close(loss, want_loss)
    assert_tree_close(grads, want, MODEL_TOL, f"{arch} grad")


# ---------------------------------------------------------------------------
# one train step from the same state
# ---------------------------------------------------------------------------

def assert_adam_step_close(got, want, m, lr, share, what):
    """Parameters after one AdamW step. Adam's first step moves an
    element by lr x g / (|g| + eps), about lr x sign(g): where |g| lies
    at the two packages' gradient noise its sign may differ, and the
    element by up to 2 lr between them while every gradient is within
    its tolerance. So: within 1e-6 x the leaf's largest |value| (float32
    rounding of ~10 elementwise ops) where |g| exceeds ``share`` x the
    leaf's largest |g|, and within 2 lr plus that elsewhere. The
    reference's first moment ``m`` (0.1 x its clipped gradient) stands
    for g."""
    g, w, gr = by_path(got), by_path(want), by_path(m)
    for p in w:
        scale = float(np.abs(w[p]).max()) if w[p].size else 0.0
        tight = 1e-6 * max(scale, 1.0)
        err = np.abs(g[p] - w[p])
        big = np.abs(gr[p]) > share * float(np.abs(gr[p]).max())
        assert float(err[big].max(initial=0.0)) <= tight, \
            f"{what} {'/'.join(p)}: {float(err[big].max())} beyond {tight}"
        assert float(err.max(initial=0.0)) <= 2 * lr + tight, \
            f"{what} {'/'.join(p)}: {float(err.max())} beyond 2 lr"


def ref_state(init_state, ref_params):
    return jax.tree_util.tree_map(np.asarray, init_state(ref_params))


STEP_CASES = {
    # arch -> (optimizer, tolerance share of the gradients)
    "gemma-2b": ("adamw", LM_GRAD_SHARE),
    "granite-moe-1b-a400m": ("adafactor", LM_GRAD_SHARE),
    "gat-cora": ("adamw", MODEL_TOL),
    "dlrm-rm2": ("adamw", MODEL_TOL),
}


def step_models(arch):
    """(reference loss fn, reference params, port state, port loss fn,
    reference batch, port batch)."""
    opt = STEP_CASES[arch][0]
    if arch in LMS:
        cfg, ref, _, pcfg = lm(arch)
        toks = lm_tokens(cfg)
        rb, pb = {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.tensor(toks, dtype=torch.int64)}
        ref_loss = lambda p, b: ref_T.loss_fn(p, b, cfg)  # noqa: E731
        port_loss = lambda p, b: T.loss_fn(p, b, pcfg)  # noqa: E731
    else:
        cfg, ref, _, pcfg, rb, pb = small_model(arch)
        ref_loss = lambda p, b: REF[arch].loss_fn(p, b, cfg)  # noqa: E731
        port_loss = lambda p, b: PORT[arch].loss_fn(p, b,  # noqa: E731
                                                    pcfg)
    ref_init, _ = ref_trainer.make_train_step(ref_loss,
                                              ref_opt.OptConfig(name=opt))
    state, _ = carry.train_state_from(arch, opt, ref_state(ref_init, ref),
                                      dataclasses.asdict(cfg), device=CPU)
    return ref_loss, ref, state, port_loss, rb, pb


@pytest.mark.parametrize("arch", list(STEP_CASES))
def test_train_step_matches_reference(arch):
    opt, share = STEP_CASES[arch]
    ref_loss, ref, state, port_loss, rb, pb = step_models(arch)
    ocfg = ref_opt.OptConfig(name=opt)
    ref_init, ref_step = ref_trainer.make_train_step(ref_loss, ocfg)
    if arch in LMS:
        want, wm = ref_run(ref_step, ref_init(ref), rb)
    else:
        want, wm = ref_run(lambda s: ref_step(s, rb), ref_init(ref))
    _, step = trainer.make_train_step(port_loss, optimizer.OptConfig(
        name=opt))
    got, gm = step(state, pb)
    loss_close(gm["loss"], wm["loss"])
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= \
        share * float(wm["grad_norm"])
    assert bool(gm["finite"]) and int(got["step"]) == 1 and \
        int(got["nan_skips"]) == 0
    if opt == "adamw":
        assert int(got["opt"]["step"]) == 1
        assert_tree_shares(got["opt"]["m"], want["opt"]["m"], share, "m")
        assert_tree_shares(got["opt"]["v"], want["opt"]["v"], 2 * share,
                           "v")
        assert_adam_step_close(got["params"], want["params"],
                               want["opt"]["m"], ocfg.lr, share, arch)
    else:
        # Adafactor's update is g / sqrt(v) clipped to RMS 1 (no sign
        # step): the parameters move by lr times a unit-RMS update
        assert_tree_shares(got["opt"]["slots"], want["opt"]["slots"],
                           2 * share, "slots")
        g, g0 = by_path(got["params"]), by_path(state["params"])
        w, w0 = by_path(want["params"]), by_path(ref)
        assert_tree_shares({p: g[p] - g0[p] for p in g},
                           {p: w[p] - w0[p] for p in w}, 4 * share,
                           "update")


def test_microbatches_match_reference_and_the_whole_batch():
    """``microbatches=2``: the reference's accumulation (float32, g / 2 a
    microbatch, in order), and the port's one-batch step within float32
    rounding (a dense LM's loss is the mean over equal-length rows)."""
    ref_loss, ref, state, port_loss, rb, pb = step_models("gemma-2b")
    ocfg = ref_opt.OptConfig()
    ref_init, ref_step = ref_trainer.make_train_step(ref_loss, ocfg,
                                                     microbatches=2)
    want, wm = ref_run(ref_step, ref_init(ref), rb)
    init, step = trainer.make_train_step(port_loss, optimizer.OptConfig(),
                                         microbatches=2)
    got, gm = step(state, pb)
    loss_close(gm["loss"], wm["loss"])
    assert_adam_step_close(got["params"], want["params"], want["opt"]["m"],
                           ocfg.lr, LM_GRAD_SHARE, "microbatches=2")
    assert_tree_shares(got["opt"]["m"], want["opt"]["m"], LM_GRAD_SHARE,
                       "m")
    _, whole = trainer.make_train_step(port_loss, optimizer.OptConfig())
    one, om = whole(state, pb)
    assert abs(float(om["loss"]) - float(gm["loss"])) <= \
        LOSS_REL * float(om["loss"])
    assert_tree_shares(one["opt"]["m"], got["opt"]["m"], LM_GRAD_SHARE,
                       "m, one batch")
    with pytest.raises(TypeError, match="dict"):
        trainer.make_train_step(port_loss, optimizer.OptConfig(),
                                microbatches=2)[1](state, object())


@pytest.mark.parametrize("where", ["batch", "params"])
def test_non_finite_step_is_skipped_as_the_reference_skips_it(where):
    """A NaN in the batch or an inf in the parameters: both packages skip
    the update (params and optimizer state unchanged bit for bit),
    advance ``step`` and count one skip."""
    ref_loss, ref, state, port_loss, rb, pb = step_models("dlrm-rm2")
    if where == "batch":
        dense = np.asarray(rb["dense"]).copy()
        dense[3, 2] = np.nan
        rb = dict(rb, dense=jnp.asarray(dense))
        pb = dict(pb, dense=torch.from_numpy(dense))
    else:
        w = np.asarray(ref["bot_w0"]).copy()
        w[0, 0] = np.inf
        ref = dict(ref, bot_w0=jnp.asarray(w))
        state["params"]["bot_w0"] = torch.from_numpy(w)
    ref_init, ref_step = ref_trainer.make_train_step(ref_loss,
                                                     ref_opt.OptConfig())
    before = ref_init(ref)
    want, wm = ref_run(lambda s: ref_step(s, rb), before)
    assert not bool(wm["finite"]) and int(want["nan_skips"]) == 1
    init, step = trainer.make_train_step(port_loss, optimizer.OptConfig())
    kept = tree_map(torch.clone, {"params": state["params"],
                                  "opt": state["opt"]})
    got, gm = step(state, pb, donate=True)
    assert not bool(gm["finite"])
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["nan_skips"]) == 1 and int(got["opt"]["step"]) == 0
    for (p, a), (_, b) in zip(leaves_with_paths(
            {"params": got["params"], "opt": got["opt"]}),
            leaves_with_paths(kept)):
        assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(
            leaves_with_paths(jax.tree_util.tree_map(
                np.asarray, {"params": want["params"], "opt": want["opt"]})),
            leaves_with_paths(jax.tree_util.tree_map(
                np.asarray, {"params": before["params"],
                             "opt": before["opt"]}))):
        np.testing.assert_array_equal(a, b, err_msg="/".join(p))
