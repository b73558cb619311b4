"""The plain versions of repro_torch's four main-path CUDA kernels against
the JAX package's kernels and oracles, and the device routing of all
seven kernel wrappers (the three off the main path have their parity
tests in ``test_torch_micro_kernels.py``).

On the CPU each kernel wrapper runs its plain PyTorch version (``ref.py``),
which follows the CUDA kernel's own formulation (per-row ELL scans, weight
tables and one sort for the revert) rather than the composed sort path.
Here that plain version is held to the JAX package on identical inputs
made from a numpy seed:

* ``lp_move`` (both admission forms) to ``lp_move_chunk_ref``;
* ``seg_merge`` to the Pallas ``seg_merge`` in interpret mode and to the
  composed ``seg_merge_ref``; the fused dedup to ``dedup_arcs``;
* ``bal_scores`` (restricted or not; its own gathers from the ELL ids and
  the block tables) to ``bal_scores_ref`` fed by numpy gathers of the same
  inputs, and the fused round's scores to ``core.balance.balance_gains``;
* ``greedy_pick`` to the Pallas ``greedy_pick`` in interpret mode and to
  ``greedy_pick_ref``.

Integer outputs are compared exactly. The f32 relative gain ``rel`` is
compared exactly too: both sides convert the same int32 gain, take the
same ``max(vw, 1)`` and do one IEEE multiply or divide on it, so there is
no rounding to differ. The kernels themselves run only on a GPU: the
``gpu`` tests hold each one to its plain version there.
"""
import functools

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.contraction import dedup_arcs as ref_dedup_arcs  # noqa: E402
from repro.kernels.bal_round import bal_round as ref_bal  # noqa: E402
from repro.kernels.bal_round import ref as ref_bal_ref  # noqa: E402
from repro.kernels.lp_move import ref as ref_lp_ref  # noqa: E402
from repro.kernels.seg_merge import ref as ref_seg_ref  # noqa: E402
from repro.kernels.seg_merge import seg_merge as ref_seg  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bal_round import bal_round  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.lp_gain import lp_gain  # noqa: E402
from repro_torch.kernels.lp_move import lp_move  # noqa: E402
from repro_torch.kernels.seg_merge import ops as seg_ops  # noqa: E402
from repro_torch.kernels.seg_merge import seg_merge  # noqa: E402

I32_MAX = 2**31 - 1


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


# ---------------------------------------------------------------------------
# lp_move
# ---------------------------------------------------------------------------

def _move_inputs(seed, R=64, D=96, n_labels=24, W=12):
    """ELL chunk operands with production padding: sentinel lanes (label
    -1, weight 0, cluster weight I32_MAX), fully padded tail rows."""
    rng = np.random.default_rng(seed)
    nlab = rng.integers(0, n_labels, (R, D)).astype(np.int32)
    nlab[rng.random((R, D)) < 0.25] = -1
    nlab[-4:] = -1
    nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0).astype(np.int32)
    ncw = np.where(nlab >= 0, rng.integers(0, 2 * W + 2, (R, D)),
                   I32_MAX).astype(np.int32)
    nbud = rng.integers(0, 2 * W + 2, (R, D)).astype(np.int32)
    own = rng.integers(0, n_labels, R).astype(np.int32)
    vw = rng.integers(1, 4, R).astype(np.int32)
    v0 = int(rng.integers(0, 1000))
    salt = int(rng.integers(0, 2**32))
    return nlab, nw, ncw, nbud, own, vw, v0, salt, n_labels, W


@pytest.mark.parametrize("fit_sum", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lp_move_plain_matches_reference(fit_sum, seed):
    nlab, nw, ncw, nbud, own, vw, v0, salt, nl, W = _move_inputs(seed)
    scal = np.array([[W, v0]], dtype=np.int32)
    jargs = [jnp.asarray(x) for x in (nlab, nw, ncw, own[:, None],
                                      vw[:, None], scal)]
    jargs.append(jnp.asarray(np.array([[salt]], dtype=np.uint32)))
    r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
        *jargs, None if fit_sum else jnp.asarray(nbud), fit_sum=fit_sum)
    moved, tgt = lp_move.lp_move_chunk(
        t32(nlab), t32(nw), t32(ncw), t32(own), t32(vw), W, v0, salt, nl,
        nbud=None if fit_sum else t32(nbud))
    np.testing.assert_array_equal(moved.numpy(), np.asarray(r_moved)[:, 0])
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(r_tgt)[:, 0])
    assert not moved.numpy()[-4:].any()


def test_lp_move_plain_reverts_over_budget_movers():
    """Many rows pulled to one light label: the revert must cut the
    movers back in (rank, row) order exactly as the reference does."""
    R, D, W = 48, 4, 10
    nlab = np.full((R, D), -1, np.int32)
    nlab[:, 0] = 7
    nw = np.where(nlab >= 0, 3, 0).astype(np.int32)
    ncw = np.where(nlab >= 0, 1, I32_MAX).astype(np.int32)
    own = (100 + np.arange(R)).astype(np.int32)
    vw = np.full(R, 2, np.int32)
    scal = np.array([[W, 5]], np.int32)
    salt = np.array([[99]], np.uint32)
    r_moved, _ = ref_lp_ref.lp_move_chunk_ref(
        *(jnp.asarray(x) for x in (nlab, nw, ncw, own[:, None],
                                   vw[:, None], scal, salt)))
    moved, tgt = lp_move.lp_move_chunk(t32(nlab), t32(nw), t32(ncw),
                                       t32(own), t32(vw), W, 5, 99, 200)
    np.testing.assert_array_equal(moved.numpy(), np.asarray(r_moved)[:, 0])
    assert 0 < int(moved.sum()) < R                  # some kept, some not
    assert (tgt.numpy() == 7).all()


def _stress_inputs(kind, R, seed=5):
    """An ELL chunk that loads the kernel's phase B (the candidates of the
    revert): ``none`` has no candidate, ``one_target`` makes every row a
    mover to label 0 and so a candidate, ``spread`` puts candidates on
    many targets among ~2^21 labels (a 52-bit sort key), ``holes`` has
    -1 lanes anywhere in a row, not only a suffix. Tail rows are all
    padding."""
    rng = np.random.default_rng(seed)
    D = {"none": 16, "one_target": 4, "spread": 24, "holes": 40}[kind]
    if kind == "one_target":
        W, nl = 10, R + 1
        nlab = np.full((R, D), -1)
        nlab[:, 0] = 0
        nw = np.where(nlab >= 0, 3, 0)
        ncw = np.where(nlab >= 0, 1, I32_MAX)
        own = 1 + np.arange(R)
        vw = np.full(R, 2)
    else:
        W, nl = {"none": (10**6, 40), "spread": (40, 2**21 - 5),
                 "holes": (30, 50)}[kind]
        pool = rng.choice(nl, min(nl, max(2, R // 4)), replace=False)
        nlab = pool[rng.integers(0, pool.size, (R, D))]
        nlab[rng.random((R, D)) < 0.4] = -1
        nlab[R - R // 8:] = -1
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        lo, hi = (0, 20) if kind == "none" else (W // 2, W - 2)
        ncw = np.where(nlab >= 0, rng.integers(lo, hi, (R, D)), I32_MAX)
        own = pool[rng.integers(0, pool.size, R)]
        vw = rng.integers(1, 4, R)
    nbud = np.minimum(ncw + vw[:, None] + rng.integers(0, 2, (R, D)),
                      I32_MAX)
    v0 = int(rng.integers(0, 1000))
    salt = int(rng.integers(0, 2**32))
    arrs = [x.astype(np.int32) for x in (nlab, nw, ncw, nbud, own, vw)]
    return (*arrs, v0, salt, nl, W)


STRESS = [("none", 3000), ("one_target", 4000), ("spread", 2000),
          ("holes", 2000)]


@pytest.mark.parametrize("fit_sum", [True, False])
@pytest.mark.parametrize("kind,R", STRESS)
def test_lp_move_plain_matches_reference_on_phase_b_stress(kind, R, fit_sum):
    nlab, nw, ncw, nbud, own, vw, v0, salt, nl, W = _stress_inputs(kind, R)
    scal = np.array([[W, v0]], dtype=np.int32)
    jargs = [jnp.asarray(x) for x in (nlab, nw, ncw, own[:, None],
                                      vw[:, None], scal)]
    jargs.append(jnp.asarray(np.array([[salt]], dtype=np.uint32)))
    r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
        *jargs, None if fit_sum else jnp.asarray(nbud), fit_sum=fit_sum)
    moved, tgt = lp_move.lp_move_chunk(
        t32(nlab), t32(nw), t32(ncw), t32(own), t32(vw), W, v0, salt, nl,
        nbud=None if fit_sum else t32(nbud))
    np.testing.assert_array_equal(moved.numpy(), np.asarray(r_moved)[:, 0])
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(r_tgt)[:, 0])
    movers = int((tgt.numpy() != own).sum())
    assert movers > 0 and not moved.numpy()[R - R // 8:].any()
    if kind == "none":
        assert int(moved.sum()) == movers           # nothing reverted
    if kind == "one_target":     # room W - light = 9: four movers of 2 stay
        assert movers == R and int(moved.sum()) == 4


# ---------------------------------------------------------------------------
# seg_merge
# ---------------------------------------------------------------------------

def _records(seed, L, ids):
    """Seeded (src, dst, w) records. An int ``seed`` gives ids below
    ``ids`` with a fifth invalid (I32_MAX, w=0); a named case loads one
    corner of the radix-sort design. Returns (src, dst, w, max_id), with
    max_id the bound a caller may pass (None: negative ids)."""
    rng = np.random.default_rng(seed if isinstance(seed, int) else L)
    src = rng.integers(0, ids, L)
    dst = rng.integers(0, ids, L)
    w = rng.integers(1, 9, L)
    if seed == "width":          # a max id of 2^7 - 1 needs 8 bits
        src[:3] = dst[3:5] = ids - 1
    elif seed == "one_half":     # I32_MAX in src only, or in dst only
        src[rng.random(L) < 0.2] = I32_MAX
        dst[rng.random(L) < 0.2] = I32_MAX
    elif seed == "negative":     # any int32: no bound, 32-bit halves
        src -= ids // 2
        dst -= ids // 2
        src[:4] = I32_MAX
    elif seed == "long_run":     # one key repeated beyond a tile
        src[:5000] = 7
        dst[:5000] = 3
        rng.shuffle(src)
        dst[src == 7] = 3
    elif seed == "all_invalid":
        src[:] = dst[:] = I32_MAX
        w[:] = 0
    elif seed == "wrap":         # run totals that wrap int32
        w = rng.integers(2**29, 2**30, L)
    elif seed == "full_width":   # ids near the top of int32
        src = I32_MAX - 1 - rng.integers(0, ids, L)
        dst = I32_MAX - 1 - rng.integers(0, ids, L)
    if isinstance(seed, int) or seed == "pow2_miss":
        pad = rng.random(L) < 0.2
        src[pad] = dst[pad] = I32_MAX
        w[pad] = 0
    valid = np.concatenate([src[src != I32_MAX], dst[dst != I32_MAX]])
    if valid.size and valid.min() < 0:
        max_id = None
    else:
        max_id = int(valid.max()) if valid.size else 0
    return (src.astype(np.int32), dst.astype(np.int32), w.astype(np.int32),
            max_id)


SEG_CASES = [(0, 256, 6), (1, 200, 30), (2, 5, 2), (3, 1, 3),
             ("pow2_miss", 1000, 50), ("width", 300, 128),
             ("one_half", 500, 40), ("negative", 700, 60),
             ("long_run", 6000, 20), ("all_invalid", 777, 1),
             ("wrap", 2000, 10), ("full_width", 600, 40)]


@pytest.mark.parametrize("seed,L,ids", SEG_CASES)
def test_seg_merge_plain_matches_pallas_and_oracle(seed, L, ids):
    """The plain version, with the ids' bound (the narrowed key) and
    without (32-bit halves), against the JAX composed oracle, and against
    the Pallas kernel in interpret mode up to 4096 records."""
    src, dst, w, max_id = _records(seed, L, ids)
    if seed == "width":
        assert seg_merge.key_bits(max_id) == 8
    wants = [ref_seg_ref.seg_merge_ref(jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(w))]
    if L <= 4096:
        wants.append(ref_seg.seg_merge(src, dst, w, interpret=True))
    for bound in {max_id, None}:
        got = seg_merge.seg_merge(t32(src), t32(dst), t32(w), max_id=bound)
        for want in wants:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_key_bits_leave_room_for_the_invalid_id():
    """bit_length(max_id + 1): the all-ones value of a half stays above
    every valid id; without a bound the halves are 32 bits wide."""
    kb = seg_merge.key_bits
    assert [kb(0), kb(1), kb(126), kb(127), kb(2**19 - 1)] == [1, 2, 7, 8, 20]
    assert kb(None) == 32 and kb(I32_MAX - 1) == 31
    for bad in (-1, I32_MAX):
        with pytest.raises(ValueError, match="max_id"):
            kb(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_dedup_matches_reference_dedup_arcs(seed):
    rng = np.random.default_rng(seed)
    m = 300
    csrc = rng.integers(0, 25, m)
    cdst = rng.integers(0, 25, m)
    w = rng.integers(1, 7, m)
    assert seg_ops.dedup_fits(csrc, cdst, w)
    got = seg_ops.dedup_arcs_fused(csrc, cdst, w, torch.device("cpu"))
    want = ref_dedup_arcs(csrc, cdst, w, kernel="composed")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_dedup_fit_check_keeps_int32_limits_only():
    a = np.array([0, 1], dtype=np.int64)
    assert seg_ops.dedup_fits(a, a[::-1], np.array([1, 1]))
    assert not seg_ops.dedup_fits(a[:0], a[:0], a[:0])
    assert not seg_ops.dedup_fits(np.array([0, I32_MAX]), a, a)
    assert not seg_ops.dedup_fits(a, a, np.array([2**30, 2**30]))
    big = np.zeros(9 * 2**20, dtype=np.int64)   # far beyond any VMEM gate
    assert seg_ops.dedup_fits(big, big + 1, np.ones_like(big))


def test_dedup_fit_check_keeps_the_record_limit(monkeypatch):
    """Beyond the kernel's int32 record offsets the fused dedup does not
    fit (and raises); nothing pads the records any more."""
    a = np.arange(12, dtype=np.int64)
    assert seg_ops.dedup_fits(a, a[::-1], np.ones_like(a))
    monkeypatch.setattr(seg_ops, "MAX_RECORDS", 11)
    assert not seg_ops.dedup_fits(a, a[::-1], np.ones_like(a))
    with pytest.raises(ValueError, match="int32"):
        seg_ops.dedup_arcs_fused(a, a[::-1], np.ones_like(a),
                                 torch.device("cpu"))


def test_fused_dedup_raises_outside_int32_instead_of_falling_back():
    """Records the int32 kernel cannot merge exactly raise on every device;
    the numpy path is taken only under ``kernel="composed"``."""
    a = np.array([0, 1, 2], dtype=np.int64)
    heavy = np.array([2**30, 1, 2**30], dtype=np.int64)
    with pytest.raises(ValueError, match="int32"):
        seg_ops.dedup_arcs_fused(a, a[::-1], heavy, torch.device("cpu"))
    with pytest.raises(ValueError, match="int32"):
        seg_ops.dedup_arcs_fused(np.array([0, I32_MAX]), a[:2], a[:2],
                                 torch.device("cpu"))
    # self loops only: nothing left to merge, nothing to check
    out = seg_ops.dedup_arcs_fused(a, a, heavy, torch.device("cpu"))
    assert all(x.size == 0 for x in out)


# ---------------------------------------------------------------------------
# bal_scores / greedy_pick
# ---------------------------------------------------------------------------

def _bal_inputs(seed, K, restricted, R=64, D=96, n=None, hub=False,
                weights=(1, 6)):
    """``bal_scores`` operands in the kernel's form: ELL ids (-1 lanes
    anywhere in a row, rows ``>= n`` as given) and weights, the rows'
    blocks and vertex weights, the (K,) block tables. Returns (args, salt,
    kw) of the wrapper. ``hub``: row 3 has all D lanes valid."""
    rng = np.random.default_rng(seed)
    n = R - 4 if n is None else n
    ell_idx = rng.integers(0, R, (R, D))
    ell_idx[rng.random((R, D)) < 0.25] = -1
    if hub:
        ell_idx[3] = rng.integers(0, R, D)
    ell_w = np.where(ell_idx >= 0, rng.integers(*weights, (R, D)), 0)
    labels = rng.integers(0, K, R)
    labels[rng.random(R) < 0.4] = 0              # one crowded block
    vw = rng.integers(1, 4, R)
    bw = rng.integers(0, 40, K)
    lm = rng.integers(10, 40, K)
    fb = rng.integers(0, K, K)
    args = [t32(x) for x in (ell_idx, ell_w, labels, vw, bw, lm, fb)]
    salt = int(rng.integers(0, 2**32))
    kw = {}
    if restricted:
        kw["parent"] = t32(rng.integers(0, max(1, K // 2), K))
    return args + [n], salt, kw


def _bal_reference(args, salt, kw):
    """The JAX ``bal_scores_ref`` on the same inputs, its operands gathered
    with numpy."""
    idx, w, labels, vw, bw, lm, fb = (a.numpy() for a in args[:7])
    n = args[7]
    valid = idx >= 0
    nlab = np.where(valid, labels[np.maximum(idx, 0)], -1).astype(np.int32)
    nl = np.maximum(nlab, 0)
    fb_t = fb[labels]
    cols = [labels, vw, bw[labels] > lm[labels], np.arange(len(labels)) < n,
            fb_t, (bw[fb_t] <= lm[fb_t] - vw) & (fb_t != labels)]
    jargs = [jnp.asarray(x) for x in (nlab, w, bw[nl], lm[nl])]
    jargs += [jnp.asarray(c.astype(np.int32)[:, None]) for c in cols]
    jargs.append(jnp.asarray(np.array([[salt]], dtype=np.uint32)))
    jkw = {}
    if "parent" in kw:
        par = kw["parent"].numpy()
        jkw = {"npar": jnp.asarray(par[nl]),
               "opar": jnp.asarray(par[labels][:, None])}
    rel, tgt = ref_bal_ref.bal_scores_ref(*jargs, **jkw,
                                          restricted="parent" in kw)
    return np.asarray(rel)[:, 0], np.asarray(tgt)[:, 0]


def _check_bal_scores(args, salt, kw):
    rel, tgt = bal_round.bal_scores(*args, salt, **kw)
    r_rel, r_tgt = _bal_reference(args, salt, kw)
    assert rel.dtype == torch.float32 and tgt.dtype == torch.int32
    # exact: same int32 gain, same f32 convert / max / one mul or div
    np.testing.assert_array_equal(rel.numpy(), r_rel)
    np.testing.assert_array_equal(tgt.numpy(), r_tgt)
    assert np.all(rel.numpy()[args[7]:] == -np.inf)
    return rel


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("seed,k", [(0, 2), (1, 9), (2, 32)])
def test_bal_scores_plain_matches_reference(restricted, seed, k):
    rel = _check_bal_scores(*_bal_inputs(seed, k, restricted))
    assert np.isfinite(rel.numpy()).any()       # some rows do move


# (seed, K, _bal_inputs options) of the kernel's edge cases
BAL_CASES = {
    "holes": (3, 24, {}),                          # -1 lanes anywhere
    "hub_256": (4, 16, dict(D=256, hub=True)),     # a 256-lane hub row
    "k_beyond_4096": (5, 5000, dict(R=96)),
    "rows_beyond_n": (6, 12, dict(n=29)),          # rows >= n keep lanes
    "wrapping_weights": (7, 6, dict(weights=(2**29, 2**30))),
}


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("case", list(BAL_CASES))
def test_bal_scores_plain_matches_reference_cases(case, restricted):
    seed, K, opts = BAL_CASES[case]
    args, salt, kw = _bal_inputs(seed, K, restricted, **opts)
    if case == "k_beyond_4096":       # the tables' far end is reached
        args[2][:8] = torch.arange(K - 8, K, dtype=torch.int32)
    _check_bal_scores(args, salt, kw)


def test_fused_round_scores_match_the_composed_gains():
    """The fused round's scores (fallback table + ``bal_scores`` on the
    ELL form) equal ``core.balance.balance_gains`` on the sorted arc slab
    of the same graph, restricted or not."""
    from repro_torch.core import balance as t_balance
    from repro_torch.core import lp as t_lp
    from repro_torch.graphs import generators
    from repro_torch.kernels.bal_round import ops as bal_ops

    g = generators.make("rgg2d", 500, 8.0, seed=3)
    chunks = t_lp.build_chunks(g, 1)
    n_pad = chunks.n_pad
    rng = np.random.default_rng(1)
    k = 8
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:g.n] = np.where(rng.random(g.n) < 0.5, 0,
                            rng.integers(0, k, g.n))
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:g.n] = g.vweights
    bw = np.bincount(labels[:g.n], weights=vw[:g.n], minlength=k)
    lm = np.full(k, int(bw.mean() * 1.05), dtype=np.int32)
    par = np.array([0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int32)
    idx, ew, ov = bal_ops.build_balance_ell(g, n_pad)
    assert ov is None                           # max degree 32: no hub
    src, dst, w = (t32(x[0]) for x in (chunks.src, chunks.dst, chunks.w))
    lab_t, vw_t, bw_t, lm_t, par_t = (t32(x) for x in (labels, vw, bw, lm,
                                                       par))
    lab_dst = lab_t[dst.long()]
    order = t_lp.sort2(src, lab_dst)
    valid = torch.arange(n_pad + 1) < g.n
    for restricted in (False, True):
        want = t_balance.balance_gains(
            lab_t, src[order], lab_dst[order], w[order], bw_t, lm_t, par_t,
            vw_t, 11, n_pad, valid, restricted=restricted)
        got = bal_ops.fused_round_scores(
            lab_t, bw_t, lm_t, par_t, t32(idx), t32(ew), vw_t, g.n, 11,
            restricted=restricted)
        assert np.isfinite(want[0].numpy()).any()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# (4, ...): M beyond one of the kernel's 512-entry passes; (5, ...): a table
# far beyond anything a CTA could stage (4 MB)
@pytest.mark.parametrize("seed,M,K", [(0, 64, 16), (1, 128, 64),
                                      (2, 7, 3), (3, 128, 8192),
                                      (4, 1300, 300), (5, 64, 2**20)])
def test_greedy_pick_plain_matches_pallas_and_oracle(seed, M, K):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.standard_normal(M).astype(np.float32))[::-1].copy()
    vals[rng.random(M) < 0.3] = -np.inf
    tgt = rng.integers(0, K, M).astype(np.int32)
    src = rng.integers(0, K, M).astype(np.int32)
    cw = rng.integers(1, 5, M).astype(np.int32)
    bw = rng.integers(0, 60, K).astype(np.int32)
    lm = rng.integers(10, 50, K).astype(np.int32)
    acc, bw_out = bal_round.greedy_pick(torch.from_numpy(vals), t32(tgt),
                                        t32(src), t32(cw), t32(bw), t32(lm))
    jx = [jnp.asarray(x) for x in (vals, tgt, src, cw, bw, lm)]
    p_acc, p_bw = ref_bal.greedy_pick(*jx, interpret=True)
    r_acc, r_bw = ref_bal_ref.greedy_pick_ref(*jx)
    assert acc.dtype == torch.bool and bw_out.dtype == torch.int32
    for want_acc, want_bw in ((p_acc, p_bw), (r_acc, r_bw)):
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
        np.testing.assert_array_equal(bw_out.numpy(), np.asarray(want_bw))


@pytest.mark.parametrize("K", [1, 37])
def test_greedy_pick_plain_clamps_pool_ids_like_the_oracle(K):
    """Pool ids at or beyond K are read at K - 1 and never written, as in
    the JAX ``greedy_pick_ref`` (whose jnp indexing would wrap a negative
    id, where the port clamps it to 0: the balancer gives only ids in
    [0, K))."""
    rng = np.random.default_rng(K)
    M = 96
    vals = np.sort(rng.standard_normal(M).astype(np.float32))[::-1].copy()
    tgt = rng.integers(0, K + 3, M).astype(np.int32)
    src = rng.integers(0, K + 3, M).astype(np.int32)
    cw = rng.integers(-4, 5, M).astype(np.int32)   # K = 1 needs c < 0
    bw = rng.integers(0, 60, K).astype(np.int32)
    lm = rng.integers(10, 50, K).astype(np.int32)
    bw[0] = lm[0] + 3                                # block 0 over budget
    acc, bw_out = bal_round.greedy_pick(torch.from_numpy(vals), t32(tgt),
                                        t32(src), t32(cw), t32(bw), t32(lm))
    r_acc, r_bw = ref_bal_ref.greedy_pick_ref(
        *(jnp.asarray(x) for x in (vals, tgt, src, cw, bw, lm)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(r_acc))
    np.testing.assert_array_equal(bw_out.numpy(), np.asarray(r_bw))
    assert acc.numpy().any()


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version; nothing else falls back
# ---------------------------------------------------------------------------

def _small_calls(device):
    nlab, nw, ncw, _, own, vw, v0, salt, nl, W = _move_inputs(9, R=8, D=4)
    src, dst, w, _ = _records(9, 16, 4)
    bargs, bsalt, _ = _bal_inputs(9, 4, False, R=8, D=4)
    vals = torch.zeros(4, dtype=torch.float32, device=device)
    i4 = torch.zeros(4, dtype=torch.int32, device=device)
    i8 = torch.zeros(8, dtype=torch.int32, device=device)
    on = (lambda x: t32(x).to(device))
    f32 = (lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
           .to(device))
    rng = np.random.default_rng(9)
    lab = rng.integers(-1, 3, (8, 4))
    g_own = rng.integers(0, 3, (8, 1))
    blocks = rng.integers(0, 3, (4, 4, 4))      # integer-valued: exact sums
    st = _stress_inputs("one_target", 1500)    # two 1024-key sort tiles
    return {
        "lp_move": lambda: lp_move.lp_move_chunk(
            on(nlab), on(nw), on(ncw), on(own), on(vw), W, v0, salt, nl),
        "lp_move_stress": lambda: lp_move.lp_move_chunk(
            *(on(a) for a in st[:3]), on(st[4]), on(st[5]), st[9], st[6],
            st[7], st[8], nbud=on(st[3])),
        "seg_merge": lambda: seg_merge.seg_merge(on(src), on(dst), on(w)),
        **{f"seg_merge_{case}": functools.partial(_seg_call, on, case, L, ids)
           for case, L, ids in SEG_CASES[4:] + [("big", 2**22 + 1, 136674)]},
        "bal_scores": lambda: bal_round.bal_scores(
            *(a.to(device) for a in bargs[:7]), bargs[7], bsalt),
        "greedy_pick": lambda: bal_round.greedy_pick(vals, i4, i4, i4, i8,
                                                     i8),
        "lp_gain": lambda: lp_gain.lp_gain_ell(
            on(lab), f32(np.where(lab >= 0, 2, 0)),
            f32(np.where(lab >= 0, lab + 1, np.inf)),
            on(g_own), f32(np.ones((8, 1))),
            f32([[3]]), row_tile=4),
        "bsr_spmm": lambda: (bsr_spmm.bsr_spmm(
            on([1, 0, 2, 1]), f32(blocks), f32(np.arange(36).reshape(12, 3)),
            block_rows=2, nnz_per_row=2),),
        "embedding_bag": lambda: (embedding_bag.embedding_bag_1row(
            on([[0, 2], [1, 1], [2, 0]]), f32(np.arange(12).reshape(3, 4))),),
    }


def _seg_call(on, case, L, ids):
    """seg_merge on a named case of ``_records``, with its bound; ``big``
    is L = 2^22 + 1 records with the level-0 ids' width (18 bits)."""
    src, dst, w, max_id = _records(case if case != "big" else 0, L, ids)
    return seg_merge.seg_merge(on(src), on(dst), on(w), max_id=max_id)


MICRO = ["lp_gain", "bsr_spmm", "embedding_bag"]
SEG = [f"seg_merge_{case}" for case, _, _ in SEG_CASES[4:]]


@pytest.mark.parametrize("kernel", ["lp_move", "lp_move_stress",
                                    "seg_merge", "bal_scores",
                                    "greedy_pick"] + MICRO + SEG)
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(kernel):
    before = dict(_build.LAUNCHES)
    out = _small_calls(torch.device("cpu"))[kernel]()
    assert all(t.device.type == "cpu" for t in out)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["lp_move", "lp_move_stress",
                                    "seg_merge", "bal_scores",
                                    "greedy_pick"] + MICRO + SEG)
def test_other_devices_raise_instead_of_falling_back(kernel):
    with pytest.raises(ValueError, match="unsupported device"):
        _small_calls(torch.device("meta"))[kernel]()


def test_build_is_lazy_and_content_hashed():
    """Importing the kernel modules builds nothing; each library's name
    carries the hash of its sources and flags."""
    target = _build._target("lp_move")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("lp_move-") and target.suffix == ".so"
    assert _build._libs == {}
    assert set(_build.SOURCES) == {"lp_move", "seg_merge", "bal_round",
                                   "lp_gain", "bsr_spmm", "embedding_bag"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["lp_move", "lp_move_stress",
                                    "seg_merge", "bal_scores",
                                    "greedy_pick"] + MICRO + SEG
                         + ["seg_merge_big"])
def test_kernel_matches_plain_version_on_gpu(kernel, cuda_device):
    counter = ("seg_merge" if kernel.startswith("seg_merge")
               else kernel.removesuffix("_stress"))
    before = _build.LAUNCHES[counter]
    got = _small_calls(cuda_device)[kernel]()
    torch.cuda.synchronize()
    want = _small_calls(torch.device("cpu"))[kernel]()
    assert _build.LAUNCHES[counter] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_lp_move_outputs_hold_no_scratch(cuda_device):
    moved, tgt = _small_calls(cuda_device)["lp_move_stress"]()
    R = moved.shape[0]
    # moved and tgt share one 8 R-byte allocation, apart from the scratch
    assert moved.untyped_storage().data_ptr() == \
        tgt.untyped_storage().data_ptr()
    assert moved.untyped_storage().nbytes() == 8 * R


@pytest.mark.gpu
def test_seg_merge_outputs_hold_no_scratch(cuda_device):
    out = _small_calls(cuda_device)["seg_merge_long_run"]()
    L = out[0].shape[0]
    # the four outputs share one 16 L-byte allocation, apart from the
    # kernel's scratch
    assert all(x.untyped_storage().data_ptr() ==
               out[0].untyped_storage().data_ptr() for x in out)
    assert out[0].untyped_storage().nbytes() == 16 * L
