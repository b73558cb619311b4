"""repro_torch's unconstrained refinement tier against the JAX package's,
bit for bit.

The penalty schedule, one chunk step (restricted and not, the penalty at
0, in between and at R-1 of R, one block at a 2^31-1 budget), a pass over
all chunks, the host loop with its ``stats``, ``balance_and_refine``
with the afterburner's ``repair_rounds``, and the whole partitioner
through ``Partitioner(backend="single")`` under both kernel modes on
``benchmarks/quality.py::refine_pareto(scale="small", ks=(16,))``'s four
instances, comparing assignment, cut and trace (``refine-mode`` records
included), and once through ``quality="best"``. Integer paths: every
comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import lp as ref_lp  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import refinement as ref_refinement  # noqa: E402
from repro.core import unconstrained as ref_unc  # noqa: E402
from repro.core.deep_mgp import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.core import refinement, unconstrained  # noqa: E402

CPU = torch.device("cpu")
I32_MAX = 2**31 - 1


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def graphs(family="rgg2d", n=600, seed=11):
    g = ref_generators.make(family, n, 8.0, seed=seed)
    return g, carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                      g.vweights)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_penalty_schedule_matches_reference(R):
    got = unconstrained.penalty_schedule(R)
    assert got == ref_unc.penalty_schedule(R)
    assert all(type(x) is float for x in got) and got[0] == 0.0


def _skewed_state(g, k, seed, restricted):
    """Labels with 60% of the vertices in block 0 (so moves into block 0
    pay the penalty), budgets 10% above the mean, block 2's budget at
    2^31-1; the padded tables and slabs of ``build_chunks``."""
    rng = np.random.default_rng(seed)
    part = np.where(rng.random(g.n) < 0.6, 0,
                    rng.integers(0, k, g.n)).astype(np.int64)
    l_final = ref_metrics.l_max(g.total_vweight, k, 0.1,
                                int(g.vweights.max()))
    lv = np.full(k, l_final, dtype=np.int64)
    lv[2] = I32_MAX
    parent = (np.arange(k) // 2).astype(np.int64) if restricted else None
    bw, lvp, prp, _ = ref_refinement.pad_blocks(
        ref_metrics.block_weights(g, part, k), lv, parent)
    chunks = ref_lp.build_chunks(g, 4)
    n_pad = chunks.n_pad
    labels = np.zeros(n_pad + 1, np.int32)
    labels[:g.n] = part
    vw = np.zeros(n_pad + 1, np.int32)
    vw[:g.n] = g.vweights
    return part, lv, parent, (labels, bw, lvp, prp, chunks, vw, n_pad)


@pytest.mark.parametrize("pen_num", [0, 2, 3])
@pytest.mark.parametrize("restricted", [False, True])
def test_urefine_chunk_matches_reference(restricted, pen_num):
    """One chunk step at penalty pen_num / 4 (0, in between, R-1)."""
    g, _ = graphs(seed=21)
    k = 6
    _, _, _, (labels, bw, lvp, prp, chunks, vw, n_pad) = _skewed_state(
        g, k, 21, restricted)
    assert lvp[2] == I32_MAX and bw[0] > lvp[0]
    pen_den = 4
    moved = False
    for b in range(chunks.num_chunks):
        salt = (b * 0xC2B2AE35 + 99) % 2**32
        want_l, want_b = ref_unc._urefine_chunk(
            jnp.asarray(labels), jnp.asarray(bw), jnp.asarray(lvp),
            jnp.asarray(prp), jnp.asarray(chunks.src[b]),
            jnp.asarray(chunks.dst[b]), jnp.asarray(chunks.w[b]),
            jnp.asarray(vw), jnp.uint32(salt), jnp.int32(pen_num),
            jnp.int32(pen_den), n_pad, restricted)
        got_l, got_b = unconstrained._urefine_chunk(
            t(labels), t(bw), t(lvp), t(prp), t(chunks.src[b]),
            t(chunks.dst[b]), t(chunks.w[b]), t(vw), salt, pen_num,
            pen_den, n_pad, restricted)
        assert got_l.dtype == got_b.dtype == torch.int32
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
        moved |= bool((got_l.numpy() != labels).any())
    assert moved


@pytest.mark.parametrize("restricted", [False, True])
def test_urefine_iteration_matches_reference(restricted):
    g, _ = graphs(seed=22)
    k = 6
    part, _, _, (labels, bw, lvp, prp, chunks, vw, n_pad) = _skewed_state(
        g, k, 22, restricted)
    R = 3
    jl, jb = jnp.asarray(labels), jnp.asarray(bw)
    tl, tb = t(labels), t(bw)
    for it in range(R):
        seed = (41 * 2654435761 + it) % 2**32
        jl, jb = ref_unc.urefine_iteration(
            jl, jb, jnp.asarray(lvp), jnp.asarray(prp),
            jnp.asarray(chunks.src), jnp.asarray(chunks.dst),
            jnp.asarray(chunks.w), jnp.asarray(vw), jnp.uint32(seed),
            jnp.int32(it), jnp.int32(R), n=n_pad, restricted=restricted)
        tl, tb = unconstrained.urefine_iteration(
            tl, tb, t(lvp), t(prp), t(chunks.src), t(chunks.dst),
            t(chunks.w), t(vw), seed, it, R, n=n_pad,
            restricted=restricted)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tl.numpy()[:g.n] != part).any()


@pytest.mark.parametrize("restricted", [False, True])
def test_unconstrained_refine_matches_reference(restricted):
    g, h = graphs(seed=23)
    k = 6
    part, lv, parent, _ = _skewed_state(g, k, 23, restricted)
    st_r, st_t = {}, {}
    want = ref_unc.unconstrained_refine(g, part, lv, parent=parent,
                                        num_iterations=3, num_chunks=4,
                                        seed=5, stats=st_r)
    got = unconstrained.unconstrained_refine(h, part, lv, parent=parent,
                                             num_iterations=3,
                                             num_chunks=4, seed=5,
                                             stats=st_t, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert st_t == st_r == {"penalty": [0.0, 0.3333, 0.6667]}
    assert (got != part).any()
    st_t = {}   # the schedule is recorded before the early return
    assert unconstrained.unconstrained_refine(
        h, part, lv[:1], num_iterations=2, stats=st_t,
        device=CPU) is part
    assert st_t == {"penalty": [0.0, 0.5]}


@pytest.mark.parametrize("kernel", ["composed", "fused"])
def test_balance_and_refine_unconstrained_records_repair_rounds(kernel):
    """A skewed start the first rebalance must repair; the stats carry the
    schedule and the afterburner's rounds, as the reference's do."""
    g, h = graphs(n=900, seed=24)
    k = 8
    part, _, _, _ = _skewed_state(g, k, 24, False)
    l_final = ref_metrics.l_max(g.total_vweight, k, 0.03,
                                int(g.vweights.max()))
    lv = np.full(k, l_final, dtype=np.int64)
    st_r, st_t = {}, {}
    want = ref_refinement.balance_and_refine(
        g, part, lv, num_iterations=2, num_chunks=4, seed=3,
        kernel="composed", refine="unconstrained", stats=st_r)
    got = refinement.balance_and_refine(
        h, part, lv, num_iterations=2, num_chunks=4, seed=3, kernel=kernel,
        refine="unconstrained", stats=st_t, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert st_t == st_r
    assert st_t["penalty"] == [0.0, 0.5]
    assert st_t["repair_rounds"] >= 1       # the afterburner ran
    assert ref_metrics.is_feasible(g, got, k, 0.03)


# refine_pareto(scale="small", ks=(16,)): benchmarks/common.py's
# instance_set and bench_config, spelled out; the reference's cuts
BENCH_CONFIG = RefConfig(contraction_limit=256, ip_repetitions=2,
                         num_chunks=4)
PARETO = {"rgg2d": (8, 788), "rgg3d": (8, 1382), "rhg": (12, 1605),
          "ba": (8, 9936)}        # family -> (avg degree, cut)


def _strip(trace):
    return [{k: v for k, v in rec.items() if k != "time_s"}
            for rec in trace]


def _ref_run(g, **kw):
    return ref_api.Partitioner(backend="single").run(
        ref_api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                 config=BENCH_CONFIG, **kw))


@pytest.fixture(scope="module")
def pareto_runs():
    out = {}
    for family, (deg, _) in PARETO.items():
        g = ref_generators.make(family, 4000, deg, seed=17)
        out[family] = (g, _ref_run(g, refine="unconstrained"))
    return out


def _port_run(g, **kw):
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    cfg = carry.config_from_dict(dataclasses.asdict(BENCH_CONFIG))
    return api.Partitioner(backend="single", device=CPU).run(
        api.PartitionRequest(graph=h, k=16, epsilon=0.03, config=cfg, **kw))


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("family", sorted(PARETO))
def test_unconstrained_partition_is_bit_identical(pareto_runs, family,
                                                  kernel):
    g, ref = pareto_runs[family]
    assert ref.cut == PARETO[family][1] and ref.feasible
    res = _port_run(g, refine="unconstrained", kernel=kernel)
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert res.metrics == ref.metrics and res.feasible
    assert _strip(res.trace) == _strip(ref.trace)
    modes = [r for r in res.trace if r["phase"] == "refine-mode"]
    assert [r["stage"] for r in modes][0] == "initial"
    assert [r["stage"] for r in modes][-1] == "final"
    assert all(r["mode"] == "unconstrained" and r["penalty"] == [0.0, 0.5]
               for r in modes)


def test_quality_best_is_the_unconstrained_tier(pareto_runs):
    g, ref_unc_run = pareto_runs["rgg2d"]
    ref = _ref_run(g, quality="best")
    res = _port_run(g, quality="best")
    assert res.request.resolve_config().refine == "unconstrained"
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    np.testing.assert_array_equal(res.assignment, ref_unc_run.assignment)
    assert _strip(res.trace) == _strip(ref.trace)
    assert any(r["phase"] == "refine-mode" for r in res.trace)
