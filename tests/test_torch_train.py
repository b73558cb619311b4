"""The port's training substrate (``repro_torch.train``: data, optimizers,
checkpoints, the loop), its training CLI and its partitioned-GAT example
against the JAX package on the same numpy inputs, on the CPU.

Tolerances, and why:

* data batches, checkpoint leaves, manifests, skips and a resumed loop:
  equal, bit for bit (numpy draws; bytes on disk; no arithmetic);
* optimizer updates: each leaf (parameters and moments) within
  ``OPT_SHARE`` = 1e-6 of its largest |value| after one and after three
  updates. An update is ~10 float32 elementwise ops (2^-24 relative
  each) plus, for Adafactor, row and column means summed in another
  order; the bias corrections ``b ** t`` and ``rsqrt`` of XLA and torch
  may differ in the last bit. The largest share measured is ~2e-7;
* ``clip_by_global_norm``: the norm within 1e-6 relative (a float32 sum
  of squares in another order), the clipped gradients within 1e-6 of
  each leaf's largest |value|;
* the example's first 10 losses from the same initial parameters:
  ``EXAMPLE_LOSS_REL`` = 1e-4 relative. The first GAT gradients agree
  within ~1e-6 (``tests/test_torch_train_models.py``), but Adam's first
  steps move each element by about lr x sign(g), so an element whose
  gradient lies at the noise may step the other way (2 lr = 6e-3): ten
  steps of that move the loss by ~1e-5 relative (measured 4e-6).
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core.partitioner import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro.graphs.format import permute as ref_permute  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models.gnn import common as ref_gcommon  # noqa: E402
from repro.models.gnn import gat as ref_gat  # noqa: E402
from repro.placement import gnn_placement as ref_gnn  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import carry, configs  # noqa: E402
from repro_torch.launch import \
    gnn_partitioned_training as example  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.train import checkpoint, data, optimizer, \
    trainer  # noqa: E402
from repro_torch.train.tree import leaves_with_paths, tree_map  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from torch_fake_mesh import fake_mesh  # noqa: E402

CPU = "cpu"
OPT_SHARE = 1e-6
EXAMPLE_LOSS_REL = 1e-4


def np_tree(tree):
    """``{path: numpy leaf}`` of a tree of either package."""
    if isinstance(next(iter(leaves_with_paths(tree)))[1], torch.Tensor):
        return {p: v.detach().numpy() for p, v in leaves_with_paths(tree)}
    return {p: np.asarray(v) for p, v in leaves_with_paths(
        jax.tree_util.tree_map(np.asarray, tree))}


def assert_shares(got, want, share, what=""):
    g, w = np_tree(got), np_tree(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        err = float(np.abs(g[p].astype(np.float64) - w[p]).max())
        scale = float(np.abs(w[p]).max())
        assert err <= share * scale, f"{what} {'/'.join(p)}: {err} > " \
            f"{share} x {scale}"


def assert_equal_trees(got, want):
    g, w = np_tree(got), np_tree(want)
    assert list(g) == list(w)
    for p in w:
        assert g[p].dtype == w[p].dtype, p
        np.testing.assert_array_equal(g[p], w[p], err_msg="/".join(p))


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_batches_are_the_references_bit_for_bit(seed, step):
    for got, want in (
            (data.lm_batch(step, 3, 17, 512, seed),
             ref_data.lm_batch(step, 3, 17, 512, seed)),
            (data.dlrm_batch(step, 5, 13, 26, 1000, 3, seed),
             ref_data.dlrm_batch(step, 5, 13, 26, 1000, 3, seed))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def opt_inputs(seed=0):
    """Parameters with a factored leaf (both last dims >= 128), a stacked
    factored leaf, and unfactored ones; gradients for three steps."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (130, 140), "layers": {"e": (2, 128, 160),
                                          "b": (7,), "thin": (3, 200, 20)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), [draw(0.1 * (i + 1)) for i in range(3)]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_optimizer_updates_match_reference(name, n_steps):
    params, grads = opt_inputs()
    cfg = ref_opt.OptConfig(name=name, lr=1e-2)
    r_init, r_upd = ref_opt.make_optimizer(cfg)
    p_init, p_upd = optimizer.make_optimizer(optimizer.OptConfig(name=name,
                                                                 lr=1e-2))
    rp, rs = jax.tree_util.tree_map(jnp.asarray, params), None
    rs = r_init(rp)
    pp = to_torch(params)
    ps = p_init(pp)
    if name == "adafactor":
        assert sorted(ps["slots"]["w"]) == ["vc", "vr"]
        assert sorted(ps["slots"]["layers"]["e"]) == ["vc", "vr"]
        assert sorted(ps["slots"]["layers"]["thin"]) == ["v"]
    assert_equal_trees(ps, rs)                 # zeros, shapes and dtypes
    upd = jax.jit(r_upd)
    for i in range(n_steps):
        rp, rs = upd(jax.tree_util.tree_map(jnp.asarray, grads[i]), rs, rp)
        pp, ps = p_upd(to_torch(grads[i]), ps, pp)
    assert int(ps["step"]) == n_steps and ps["step"].dtype == torch.int32
    assert_shares(pp, rp, OPT_SHARE, "params")
    assert_shares({k: v for k, v in ps.items() if k != "step"},
                  {k: v for k, v in rs.items() if k != "step"}, OPT_SHARE,
                  "state")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donated_update_gives_the_same_values_in_the_given_tensors(
        name, monkeypatch):
    """Donated or not, and for AdamW a leaf in slices of 777 elements or
    whole: the same bits."""
    params, grads = opt_inputs(1)
    init, upd = optimizer.make_optimizer(optimizer.OptConfig(name=name))
    pp = to_torch(params)
    ps = init(pp)
    want_p, want_s = upd(to_torch(grads[0]), ps, pp)
    mine = tree_map(torch.clone, {"p": pp, "s": ps})
    got_p, got_s = upd(to_torch(grads[0]), mine["s"], mine["p"],
                       donate=True)
    assert got_p["w"] is mine["p"]["w"]
    assert_equal_trees(got_p, want_p)
    assert_equal_trees(got_s, want_s)
    monkeypatch.setattr(optimizer, "UPDATE_CHUNK", 777)
    got_p, got_s = upd(to_torch(grads[0]), ps, pp)
    assert_equal_trees(got_p, want_p)
    assert_equal_trees(got_s, want_s)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Above ``max_norm`` the gradients are scaled down; below it they
    come back as they were."""
    _, grads = opt_inputs(2)
    want, wnorm = jax.jit(lambda g: ref_opt.clip_by_global_norm(
        g, max_norm))(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    got, norm = optimizer.clip_by_global_norm(to_torch(grads[0]), max_norm)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    assert (float(norm) > max_norm) == (max_norm == 0.5)
    assert_shares(got, want, OPT_SHARE)
    if max_norm > float(norm):
        assert_equal_trees(got, grads[0])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def gemma_states(opt="adamw"):
    """The same float32 train state in both packages (the reference's
    init of gemma-2b's SMOKE config, one step on)."""
    ent = ref_configs.load_all()["gemma-2b"]
    cfg = dataclasses.replace(ent.smoke_config, compute_dtype=jnp.float32)
    from repro.models import transformer as ref_T
    key = jax.random.key(0)
    specs = ref_T.build_specs(cfg)
    ref_params = jax.jit(lambda k: ref_common.init_params(specs, k))(key)
    init, step = ref_trainer.make_train_step(
        lambda p, b: ref_T.loss_fn(p, b, cfg), ref_opt.OptConfig(name=opt))
    toks = jnp.asarray(ref_data.lm_batch(0, 2, 8, cfg.vocab)["tokens"])
    ref_state, _ = jax.jit(step)(init(ref_params), {"tokens": toks})
    arrays = jax.tree_util.tree_map(np.asarray, ref_state)
    state, pcfg = carry.train_state_from("gemma-2b", opt, arrays,
                                         dataclasses.asdict(cfg),
                                         device=CPU)
    return ref_state, state, pcfg


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoints_cross_between_the_packages(tmp_path, opt):
    """A state saved by the reference restores in the port and the
    reverse, leaf for leaf bit-identical, with the same manifest (paths
    in jax's flatten order, shapes, dtypes) and ``extra``."""
    ref_state, state, _ = gemma_states(opt)
    assert_equal_trees(state, ref_state)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    ra = ref_ckpt.save(a, 3, ref_state, extra={"next_step": 3})
    pb = checkpoint.save(b, 3, state, extra={"next_step": 3})
    assert manifest(ra) == manifest(pb)
    paths = [leaf["path"] for leaf in manifest(pb)["leaves"]]
    assert "opt/step" in paths and "params/layers/wq" in paths
    for i in range(len(paths)):
        np.testing.assert_array_equal(
            np.load(os.path.join(ra, "arrays", f"{i}.npy")),
            np.load(os.path.join(pb, "arrays", f"{i}.npy")))
    like = tree_map(torch.zeros_like, state)
    got, extra = checkpoint.restore(a, like)
    assert extra == {"next_step": 3}
    assert_equal_trees(got, ref_state)
    want, extra = ref_ckpt.restore(b, jax.tree_util.tree_map(jnp.zeros_like,
                                                             ref_state))
    assert extra == {"next_step": 3}
    assert_equal_trees(want, state)
    # a sharding that replicates restores; one that splits refuses
    specs = tree_map(lambda t: (None,) * t.dim(), state)
    checkpoint.restore(b, like, shardings=specs)
    specs["params"]["embed"] = ("model", None)
    with pytest.raises(NotImplementedError,
                       match="a split needs a DeviceMesh"):
        checkpoint.restore(b, like, shardings=specs)
    # with a DeviceMesh the split restores: rank 0 keeps its rows
    with fake_mesh((2,), ("model",)) as mesh:
        got, _ = checkpoint.restore(b, like, shardings=specs, mesh=mesh)
        emb = got["params"]["embed"]
        assert tuple(emb.placements) == (Shard(0),)
        n = emb.shape[0] // 2
        assert torch.equal(emb.to_local(), state["params"]["embed"][:n])


def test_bfloat16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    x = np.asarray(jnp.asarray([[1.5, -2.0, 3.25]], jnp.bfloat16))
    ref_ckpt.save(str(tmp_path / "r"), 1, {"w": x})
    tx = torch.tensor([[1.5, -2.0, 3.25]], dtype=torch.bfloat16)
    checkpoint.save(str(tmp_path / "p"), 1, {"w": tx})
    r, p = (str(tmp_path / d / "step_00000001") for d in "rp")
    assert manifest(r) == manifest(p)
    assert open(os.path.join(r, "arrays", "0.npy"), "rb").read() == \
        open(os.path.join(p, "arrays", "0.npy"), "rb").read()
    got, _ = checkpoint.restore(str(tmp_path / "r"),
                                {"w": torch.zeros_like(tx)})
    assert torch.equal(got["w"], tx)


def test_latest_step_and_prune_agree_with_the_reference(tmp_path):
    for pkg, d in ((ref_ckpt, tmp_path / "r"), (checkpoint, tmp_path / "p")):
        assert pkg.latest_step(str(d)) is None
        for s in (5, 10, 15, 20):
            pkg.save(str(d), s, {"x": np.arange(3)})
        os.makedirs(d / "step_00000099.tmp")   # an unfinished save
        assert pkg.latest_step(str(d)) == 20
        pkg.prune(str(d), keep=2)
    assert sorted(os.listdir(tmp_path / "r")) == \
        sorted(os.listdir(tmp_path / "p")) == \
        ["step_00000015", "step_00000020", "step_00000099.tmp"]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def lm_loop(ckpt_dir=None, steps=6):
    """gemma-2b SMOKE at float32 on ``lm_batch`` (a new batch each
    step): (init_state, train_step, make_batch, params, cfg)."""
    cfg = dataclasses.replace(configs.get("gemma-2b").smoke_config,
                              compute_dtype=torch.float32)
    params = init_params(T.build_specs(cfg),
                         torch.Generator().manual_seed(0), device=CPU)
    init, step = trainer.make_train_step(
        lambda p, b: T.loss_fn(p, b, cfg), optimizer.OptConfig(lr=1e-3))

    def mk(s):
        return {k: torch.from_numpy(v)
                for k, v in data.lm_batch(s, 2, 8, cfg.vocab).items()}
    return init, step, mk, params


def test_a_resumed_loop_ends_where_an_uninterrupted_one_does(tmp_path):
    """Stopped after the checkpoint at step 3 and run again, the loop
    restores it, resumes at ``extra["next_step"]`` and ends bit-identical
    to an uninterrupted run; the caller's parameters stay as they were."""
    init, step, mk, params = lm_loop()
    kept = tree_map(torch.clone, params)
    whole, hist = trainer.run_loop(init, step, mk, params,
                                   trainer.TrainLoopConfig(steps=6,
                                                           log_every=1))
    assert_equal_trees(params, kept)
    assert [s for s, _ in hist["loss"]] == list(range(6))
    d = str(tmp_path)
    cfg = trainer.TrainLoopConfig(steps=3, ckpt_dir=d, ckpt_every=3,
                                  log_every=1)
    trainer.run_loop(init, step, mk, params, cfg)
    assert checkpoint.latest_step(d) == 3
    resumed, rhist = trainer.run_loop(
        init, step, mk, params, dataclasses.replace(cfg, steps=6))
    assert [s for s, _ in rhist["loss"]] == [3, 4, 5]
    assert rhist["loss"] == hist["loss"][3:]
    assert_equal_trees(resumed, whole)
    assert checkpoint.latest_step(d) == 6
    assert int(resumed["step"]) == 6


def test_watchdog_exits_75_and_persistent_nans_abort():
    init, step, mk, params = lm_loop()
    with pytest.raises(SystemExit) as exc:
        trainer.run_loop(init, step, mk, params, trainer.TrainLoopConfig(
            steps=2, step_timeout_s=1e-9))
    assert exc.value.code == 75
    bad = dict(params, ln_f=torch.full_like(params["ln_f"], float("nan")))
    with pytest.raises(RuntimeError, match=r"too many non-finite steps \(3\)"):
        trainer.run_loop(init, step, mk, bad, trainer.TrainLoopConfig(
            steps=5, max_nan_skips=2))


# ---------------------------------------------------------------------------
# the partitioned-GAT example and the CLI
# ---------------------------------------------------------------------------

def placement_sha(plan):
    blocks = np.searchsorted(plan.offsets, plan.perm, side="right") - 1
    return hashlib.sha256(np.ascontiguousarray(
        blocks.astype(np.int64)).tobytes()).hexdigest()


def test_partitioned_gat_example_matches_the_reference():
    """At the example's own size: the placement (cut, halo bytes, the
    sha256 of every vertex's block) equals the reference's; the first 10
    losses from the reference's own initial parameters are within
    ``EXAMPLE_LOSS_REL`` of the reference's ``run_loop`` on the same
    batch; the port's 300 steps lower the loss."""
    plan, rng = example.place(CPU)
    g = ref_generators.make("rgg2d", 4000, 8.0, seed=7)
    rrng = np.random.default_rng(0)
    g, _ = ref_permute(g, rrng.permutation(g.n))
    want = ref_gnn.plan(g, 8, config=RefConfig(**example.PLACE_CONFIG))
    assert (plan.cut, plan.halo_bytes, plan.baseline_halo_bytes) == \
        (want.cut, want.halo_bytes, want.baseline_halo_bytes)
    assert placement_sha(plan) == placement_sha(want)
    assert plan.halo_bytes < plan.baseline_halo_bytes
    cfg = example.gat_config()
    batch = example.placed_batch(plan, rng, cfg, CPU)
    feat = rrng.standard_normal((g.n + 1, cfg.d_in)).astype(np.float32)
    np.testing.assert_array_equal(batch.node_feat.numpy(), feat)
    rcfg = ref_gat.GATConfig(**dataclasses.asdict(cfg))
    rb = ref_gcommon.GraphBatch(
        senders=jnp.asarray(batch.senders.numpy()),
        receivers=jnp.asarray(batch.receivers.numpy()), n_node=batch.n_node,
        node_feat=jnp.asarray(feat), labels=jnp.asarray(batch.labels.numpy()),
        node_mask=jnp.asarray(batch.node_mask.numpy()))
    rparams = ref_common.init_params(ref_gat.build_specs(rcfg),
                                     jax.random.key(0))
    init, step = ref_trainer.make_train_step(
        lambda p, b: ref_gat.loss_fn(p, b, rcfg),
        ref_opt.OptConfig(lr=example.LR))
    # the reference's jitted step cannot take a GraphBatch (not a pytree:
    # its own example fails there on this jax), so the batch is closed
    # over and the loop hands the step None
    _, whist = ref_trainer.run_loop(
        init, lambda s, _: step(s, rb), lambda s: None, rparams,
        ref_trainer.TrainLoopConfig(steps=10, log_every=1))
    params, _ = carry.model_from("gat-cora", jax.tree_util.tree_map(
        np.asarray, rparams), dataclasses.asdict(rcfg), device=CPU)
    _, hist = example.train(params, batch, cfg, steps=10, log_every=1)
    assert [s for s, _ in hist["loss"]] == [s for s, _ in whist["loss"]]
    for (_, got), (_, w) in zip(hist["loss"], whist["loss"]):
        assert abs(got - w) <= EXAMPLE_LOSS_REL * w, (got, w)
    _, hist = example.train(params, batch, cfg)
    assert [s for s, _ in hist["loss"]] == [0, 49, 99, 149, 199, 249, 299]
    assert hist["loss"][-1][1] < 0.5 * hist["loss"][0][1]


def test_train_cli_on_the_cpu(capsys, tmp_path):
    """``--arch gat-cora --steps 10 --device cpu`` prints the reference's
    lines; a second run with a checkpoint directory resumes."""
    assert train_cli.main(["--arch", "gat-cora", "--steps", "10",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=gat-cora steps=10 wall=")
    assert [int(line.split()[1]) for line in out[1:-1]] == list(range(10))
    assert out[-1].startswith("loss ") and out[-1].endswith("(improved)")
    d = str(tmp_path)
    for steps, first in ((4, 0), (6, 4)):
        assert train_cli.main(["--arch", "dlrm-rm2", "--steps", str(steps),
                               "--ckpt-dir", d, "--ckpt-every", "2",
                               "--device", "cpu", "--batch", "16"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert int(out[1].split()[1]) == first
    assert checkpoint.latest_step(d) == 6
