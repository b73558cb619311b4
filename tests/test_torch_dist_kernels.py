"""The distributed engine's kernel forms and runtime, against the JAX
reference (the plain versions on the CPU; the kernels themselves are held
to them on the card by ``chip_smoke.py``).

* ``lp_move`` in the distributed admission form (``ncw <= nbud - vw``)
  with heavy rows: the split chunk (capped slab + overflow carrying the
  budgets) against the whole rows and the JAX package's
  ``lp_move_chunk_ref(..., fit_sum=False)``; and the fused chunk step of
  ``dist_cluster`` on real PE shards of ba (hubs) and rgg2d against the
  reference's composed ``_local_moves`` + ``_intra_pe_revert``.
* ``bal_scores`` on the distributed table (lanes into [locals, ghosts,
  sentinel], validity a prefix of the rows): ``fused_round_scores_dist``
  against the reference's composed ``balance_gains`` over the PE's sorted
  arcs (hub shards) and against its ``bal_scores_ref`` oracle fed as its
  own fused round feeds it.
* the dist ELL builders hold the reference's rows, lane for lane.
* ``api.runtime.distributed_init``: its validation, its single-process
  no-op and its gloo branch (two processes), and a collective handed a
  tensor on another device.

Integers and one f32 gain from an int32 are compared exactly.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch_dist_jobs  # noqa: E402

from repro.core import balance as ref_balance  # noqa: E402
from repro.dist import dist_lp as ref_dist_lp  # noqa: E402
from repro.graphs import distribute as ref_distribute  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro.kernels.bal_round import ops as ref_bal_ops  # noqa: E402
from repro.kernels.bal_round import ref as ref_bal_ref  # noqa: E402
from repro.kernels.lp_move import ops as ref_move_ops  # noqa: E402
from repro.kernels.lp_move import ref as ref_lp_ref  # noqa: E402
from repro_torch.api.runtime import distributed_init  # noqa: E402
from repro_torch.dist import dist_lp  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.graphs.distribute import distribute_graph  # noqa: E402
from repro_torch.kernels.bal_round import ops as bal_ops  # noqa: E402
from repro_torch.kernels.lp_move import ops as move_ops  # noqa: E402
from repro_torch.kernels.lp_move.ref import lp_move_chunk_ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
I32_MAX = 2**31 - 1
BIG = 2**30


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def shards_of(family, n, P, seed=7):
    spec = (family, n, 8.0, seed)
    return (distribute_graph(generators.make(*spec), P),
            ref_distribute.distribute_graph(ref_generators.make(*spec), P))


# ---------------------------------------------------------------------------
# (a) lp_move: the distributed admission form with heavy rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hub", [(0, 300), (1, 120), (2, 3000),
                                      (3, 60)])
def test_lp_move_dist_split_matches_whole_row(seed, hub):
    rng = np.random.default_rng(seed)
    R, D, n_labels, W = 48, 32, 40, 30
    degs = rng.integers(0, D + 1, R)
    degs[[3, 17, 30]] = (hub, D + 1, 2 * D)
    degs[-3:] = 0                                    # padded tail rows
    indptr = np.zeros(R + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(degs)
    adj = rng.integers(0, 500, int(indptr[-1]))
    w = rng.integers(1, 6, int(indptr[-1]))
    lab = rng.integers(0, n_labels, 500).astype(np.int32)
    cw = rng.integers(0, 2 * W, n_labels).astype(np.int32)
    bud = rng.integers(W // 2, 2 * W, n_labels).astype(np.int32)
    bud[lab[adj[indptr[17]:indptr[18]]]] = -BIG      # row 17: nothing fits
    own = rng.integers(0, n_labels, R).astype(np.int32)
    vw = rng.integers(1, 4, R).astype(np.int32)
    full = int(degs.max())
    wi = np.full((R, full), -1, np.int32)
    ww = np.zeros((R, full), np.int32)
    move_ops.ell_rows(indptr, adj, w, 0, R, wi, ww)
    si = np.full((R, D), -1, np.int32)
    sw = np.zeros((R, D), np.int32)
    ov = move_ops.ell_rows(indptr, adj, w, 0, R, si, sw)
    assert set(ov.rows.tolist()) == {3, 17, 30}

    def operands(ids):
        valid = ids >= 0
        nlab = np.where(valid, lab[np.maximum(ids, 0)], -1).astype(np.int32)
        safe = np.maximum(nlab, 0)
        return (nlab, np.where(valid, cw[safe], I32_MAX).astype(np.int32),
                np.where(valid, bud[safe], 0).astype(np.int32))

    v0, salt, nl = 40, int(rng.integers(0, 2**32)), n_labels
    nlab, ncw, nbud = operands(wi)
    whole = lp_move_chunk_ref(t32(nlab), t32(ww), t32(ncw), t32(own),
                              t32(vw), W, v0, salt, nl, nbud=t32(nbud))
    s_lab, s_cw, s_bud = operands(si)
    o_lab = lab[ov.idx]
    over = (t32(ov.rows), t32(ov.ptr), t32(o_lab), t32(ov.w),
            t32(cw[o_lab]), t32(bud[o_lab]))
    split = lp_move_chunk_ref(t32(s_lab), t32(sw), t32(s_cw), t32(own),
                              t32(vw), W, v0, salt, nl, nbud=t32(s_bud),
                              overflow=over)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert whole[0][[3, 30]].any() and not whole[0][17]
    # the host admission form differs: the budgets matter
    host = lp_move_chunk_ref(t32(nlab), t32(ww), t32(ncw), t32(own),
                             t32(vw), W, v0, salt, nl)
    assert not all(torch.equal(a, b) for a, b in zip(host, whole))
    if hub <= 300:
        scal = np.array([[W, v0]], np.int32)
        r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
            *(jnp.asarray(x) for x in (nlab, ww, ncw, own[:, None],
                                       vw[:, None], scal)),
            jnp.asarray(np.array([[salt]], np.uint32)),
            nbud=jnp.asarray(nbud), fit_sum=False)
        np.testing.assert_array_equal(whole[0].numpy(),
                                      np.asarray(r_moved)[:, 0])
        np.testing.assert_array_equal(whole[1].numpy(),
                                      np.asarray(r_tgt)[:, 0])


def _tables(rng, sh, p, W):
    """A live clustering state of PE p: the label table, its src view,
    cluster weights and budgets over the n + 1 labels."""
    n, n_loc, n_ghost = sh.n, sh.n_loc, sh.n_ghost
    lab_loc = rng.integers(0, n, n_loc).astype(np.int32)
    lab_loc[sh.local_gid[p] == n] = n
    lab_ghost = rng.integers(0, n, n_ghost).astype(np.int32)
    tab = np.concatenate([lab_loc, lab_ghost, [n]]).astype(np.int32)
    lab_src = np.concatenate([lab_loc, [n]]).astype(np.int32)
    cw = rng.integers(0, 2 * W, n + 1).astype(np.int32)
    cw[n] = BIG
    bud = np.full(n + 1, W, np.int32)
    bud[n] = -BIG
    vw = np.concatenate([sh.vweights[p], [0]]).astype(np.int32)
    return tab, lab_src, cw, bud, vw


# PE 0 of ba holds its hubs (heavy rows); PE 1 of ba and rgg2d none
@pytest.mark.parametrize("family,p,hubs", [("ba", 0, True), ("ba", 1, False),
                                           ("rgg2d", 0, False)])
def test_fused_chunk_move_matches_reference_composed(family, p, hubs):
    sh, _ = shards_of(family, 1200, 2)
    rng = np.random.default_rng(p)
    W = 9
    tab, lab_src, cw, bud, vw = _tables(rng, sh, p, W)
    ch = move_ops.build_move_chunks_dist(sh, 4, p)
    srcs, dsts, ws = ref_distribute.chunk_local_arcs(sh, 4)
    heavy = 0
    for b in range(4):
        salt = int(rng.integers(0, 2**32))
        ov = ch.overflow[b]
        heavy += 0 if ov is None else len(ov.rows)
        move, tgt = dist_lp._fused_chunk_move(
            t32(lab_src), t32(tab), t32(cw), t32(bud), t32(vw),
            t32(ch.idx[b]), t32(ch.w[b]), int(ch.v0[b]), salt, sh.n_loc, W,
            sh.n + 1, None if ov is None else tuple(t32(x) for x in ov))
        jl, jt, jc, jb, jv = (jnp.asarray(x) for x in
                              (lab_src, tab, cw, bud, vw))
        r_move, r_tgt, r_cur = ref_dist_lp._local_moves(
            jl, jt, jc, jb, jv, jnp.asarray(srcs[p, b]),
            jnp.asarray(dsts[p, b]), jnp.asarray(ws[p, b]),
            jnp.uint32(salt), sh.n_loc, cluster_mode=True)
        vw_m = jnp.where(r_move, jv, 0)
        d_in = jnp.zeros(sh.n + 1, jnp.int32).at[r_tgt].add(vw_m)
        d_out = jnp.zeros(sh.n + 1, jnp.int32).at[r_cur].add(vw_m)
        r_move = ref_dist_lp._intra_pe_revert(
            r_move, r_tgt, r_cur, jv, jc, d_in, d_out, jnp.uint32(salt),
            sh.n_loc, sh.n + 1, jnp.int32(W))
        np.testing.assert_array_equal(move.numpy(), np.asarray(r_move))
        moved = np.asarray(r_move)
        np.testing.assert_array_equal(tgt.numpy()[moved],
                                      np.asarray(r_tgt)[moved])
        assert moved.any()
    assert (heavy > 0) == hubs


# ---------------------------------------------------------------------------
# (b) bal_scores on the distributed label table
# ---------------------------------------------------------------------------

def _blocks(rng, sh, p, k):
    n, n_loc = sh.n, sh.n_loc
    lab_loc = rng.integers(0, k, n_loc).astype(np.int32)
    lab_loc[rng.random(n_loc) < 0.4] = 0             # an overloaded block
    lab_loc[sh.local_gid[p] == n] = k
    lab_ghost = rng.integers(0, k, sh.n_ghost).astype(np.int32)
    tab = np.concatenate([lab_loc, lab_ghost, [k]]).astype(np.int32)
    lab_src = np.concatenate([lab_loc, [k]]).astype(np.int32)
    bw = np.full(k + 1, I32_MAX, np.int32)
    bw[:k] = np.bincount(lab_loc[lab_loc < k], minlength=k)
    lm = np.full(k + 1, I32_MAX, np.int32)
    lm[:k] = int(np.count_nonzero(sh.local_gid[p] < n) / k * 1.1)
    vw = np.concatenate([sh.vweights[p], [0]]).astype(np.int32)
    gid = np.concatenate([sh.local_gid[p], [sh.n]])
    return tab, lab_src, bw, lm, vw, gid < sh.n


@pytest.mark.parametrize("family,P,p,hubs", [
    ("ba", 2, 0, True), ("ba", 2, 1, False), ("rgg2d", 4, 2, False),
    ("ba", 1, 0, True)])
def test_bal_scores_dist_form_matches_reference_gains(family, P, p, hubs):
    sh, _ = shards_of(family, 1200, P)
    rng = np.random.default_rng(P + p)
    k = 6
    tab, lab_src, bw, lm, vw, vld = _blocks(rng, sh, p, k)
    idx, ew, ov = bal_ops.build_balance_ell_dist(sh, p)
    assert (ov is not None) == hubs
    salt = int(rng.integers(0, 2**32))
    rel, tgt = bal_ops.fused_round_scores_dist(
        t32(tab), t32(lab_src), t32(bw), t32(lm), t32(idx), t32(ew),
        t32(vw), int(vld.sum()), salt,
        overflow=None if ov is None else tuple(t32(x) for x in ov))
    real = sh.arc_src[p] < sh.n_loc
    src = np.where(real, sh.arc_src[p], sh.n_loc)
    lab_dst = tab[sh.arc_dst_idx[p]]
    order = np.lexsort((lab_dst, src))
    r_rel, r_tgt = ref_balance.balance_gains(
        *(jnp.asarray(x) for x in (lab_src, src[order], lab_dst[order],
                                   sh.arc_w[p][order], bw, lm)), None,
        jnp.asarray(vw), jnp.uint32(salt), sh.n_loc,
        valid=jnp.asarray(vld), restricted=False)
    np.testing.assert_array_equal(rel.numpy(), np.asarray(r_rel))
    np.testing.assert_array_equal(tgt.numpy()[vld], np.asarray(r_tgt)[vld])
    assert np.isfinite(rel.numpy()).sum() > 0


def test_bal_scores_dist_form_matches_the_oracle_fed_as_the_reference():
    sh, ref_sh = shards_of("rgg2d", 800, 2)
    rng = np.random.default_rng(3)
    k, p = 5, 1
    tab, lab_src, bw, lm, vw, vld = _blocks(rng, sh, p, k)
    salt = int(rng.integers(0, 2**32))
    idx, ew, _ = bal_ops.build_balance_ell_dist(sh, p)
    rel, tgt = bal_ops.fused_round_scores_dist(
        t32(tab), t32(lab_src), t32(bw), t32(lm), t32(idx), t32(ew),
        t32(vw), int(vld.sum()), salt)
    # the reference's fused round gathers these for its Pallas kernel
    r_idx, r_w = ref_bal_ops.build_balance_ell_dist(ref_sh)
    r_idx, r_w = r_idx[p], r_w[p]
    R = r_idx.shape[0]
    valid = r_idx >= 0
    nlab = np.where(valid, tab[np.maximum(r_idx, 0)], -1).astype(np.int32)
    nl = np.maximum(nlab, 0)
    fb_t = np.full(lab_src.shape, int(np.argmin(bw)), np.int32)

    def col(x, fill=0):
        out = np.full((R, 1), fill, np.int32)
        out[:x.shape[0], 0] = x
        return jnp.asarray(out)

    fb_ok = (bw[fb_t] <= lm[fb_t] - vw) & (fb_t != lab_src)
    r_rel, r_tgt = ref_bal_ref.bal_scores_ref(
        jnp.asarray(nlab), jnp.asarray(r_w), jnp.asarray(bw[nl]),
        jnp.asarray(lm[nl]), col(lab_src), col(vw),
        col((bw[lab_src] > lm[lab_src]).astype(np.int32)),
        col(vld.astype(np.int32)), col(fb_t),
        col(fb_ok.astype(np.int32)),
        jnp.asarray(np.array([[salt]], np.uint32)))
    num = lab_src.shape[0]
    np.testing.assert_array_equal(rel.numpy(), np.asarray(r_rel)[:num, 0])
    np.testing.assert_array_equal(tgt.numpy()[vld],
                                  np.asarray(r_tgt)[:num, 0][vld])


@pytest.mark.parametrize("family,P", [("ba", 2), ("rgg2d", 2), ("ba", 1)])
def test_dist_ell_builders_hold_the_reference_rows(family, P):
    """Lane for lane (slab then overflow) the port's capped rows are the
    reference's max-degree rows, over the same chunk spans."""
    sh, ref_sh = shards_of(family, 1200, P)
    r_idx, r_w, r_v0 = ref_move_ops.build_move_chunks_dist(ref_sh, 4)
    b_idx, b_w = ref_bal_ops.build_balance_ell_dist(ref_sh)

    def rows(idx, w, ov):
        out = [list(zip(i[i >= 0].tolist(), x[i >= 0].tolist()))
               for i, x in zip(idx, w)]
        if ov is not None:
            for h, r in enumerate(ov.rows):
                a, b = ov.ptr[h], ov.ptr[h + 1]
                out[r] += list(zip(ov.idx[a:b].tolist(), ov.w[a:b].tolist()))
        return out

    for p in range(P):
        ch = move_ops.build_move_chunks_dist(sh, 4, p)
        np.testing.assert_array_equal(ch.v0, r_v0[p])
        for b in range(4):
            got = rows(ch.idx[b], ch.w[b], ch.overflow[b])
            want = rows(r_idx[p, b], r_w[p, b], None)
            assert got == want[:len(got)] and \
                not any(want[len(got):])
        idx, w, ov = bal_ops.build_balance_ell_dist(sh, p)
        got = rows(idx, w, ov)[:sh.n_loc + 1]
        assert got == rows(b_idx[p], b_w[p], None)[:sh.n_loc + 1]


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_distributed_init_validates_and_is_a_no_op_alone(monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() == {"mode": "single-process",
                                  "process_id": 0, "num_processes": 1}
    for kw in (dict(coordinator_address="127.0.0.1:9", num_processes=2,
                    process_id=5),
               dict(coordinator_address="127.0.0.1:9", num_processes=0),
               dict(num_processes=2, process_id=0),
               dict(coordinator_address="127.0.0.1:9", num_processes=2)):
        with pytest.raises(ValueError):
            distributed_init(**kw)


_RANK = r"""
import json, sys, torch
from repro_torch.api import runtime
from repro_torch.dist import collectives as C
info = runtime.distributed_init(device="cpu")
pe = C.world_group()
x = torch.tensor([pe.rank + 1], dtype=torch.int32)
total = int(C.psum(x, pe)[0])
try:
    C.all_gather_1d(torch.zeros(1, device="meta"), pe)
    wrong = "no error"
except ValueError as exc:
    wrong = str(exc)
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps(dict(info, total=total, wrong=wrong)))
"""


def test_distributed_init_joins_a_gloo_group_of_two():
    procs = []
    with torch_dist_jobs.held_port() as port:
        for r in range(2):
            env = child_env(PYTHONPATH=str(ROOT / "src"),
                            CUDA_VISIBLE_DEVICES="",
                            REPRO_COORDINATOR=f"127.0.0.1:{port}",
                            REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [pr.communicate(timeout=120) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-2000:]
    infos = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for r, info in enumerate(infos):
        assert info["mode"] == "multi-process" and info["backend"] == "gloo"
        assert info["process_id"] == r and info["num_processes"] == 2
        assert info["device"] == "cpu" and info["total"] == 3
        assert "handed to a collective" in info["wrong"]


def test_carry_hands_over_shards_and_the_dist_config():
    import dataclasses
    from repro.core.deep_mgp import PartitionerConfig as RefConfig
    from repro_torch import carry
    _, ref_sh = shards_of("ba", 600, 2)
    sh = carry.shards_from(ref_sh)
    for f in dataclasses.fields(ref_sh):
        a, b = getattr(sh, f.name), getattr(ref_sh, f.name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype, f.name
    assert sh.table_size == ref_sh.table_size
    ref_cfg = RefConfig(contraction="sharded", balance="dist",
                        weights="owner", contraction_limit=32)
    cfg = carry.config_from_dict(dataclasses.asdict(ref_cfg))
    assert (cfg.contraction, cfg.balance, cfg.weights) == \
        ("sharded", "dist", "owner")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    # the grid routing crosses as the request's backend
    from repro.api import PartitionRequest as RefRequest
    from repro.api import GraphSpec as RefSpec
    ref_req = RefRequest(graph=RefSpec("rgg2d", 600, 8.0, 3), k=4,
                         devices=4, backend="dist-grid", config=ref_cfg)
    req = carry.request_from_fields({f.name: getattr(ref_req, f.name) for f
                                     in dataclasses.fields(ref_req)})
    assert req.backend == "dist-grid" and req.devices == 4
    assert dataclasses.asdict(req.config) == dataclasses.asdict(ref_cfg)
    # the carried shards cluster as the reference's shards would
    ch = move_ops.build_move_chunks_dist(sh, 4, 0)
    _, _, r_v0 = ref_move_ops.build_move_chunks_dist(ref_sh, 4)
    np.testing.assert_array_equal(ch.v0, r_v0[0])
