"""The port's three kernels off the main path (``lp_gain``, ``bsr_spmm``,
``embedding_bag``) and their entry points against the JAX package on the
same numpy inputs.

On the CPU each kernel wrapper runs its plain PyTorch version; here that
is held to the JAX package's Pallas kernel (interpret mode), its jnp
oracle and its ``ops`` entry point:

* ``to_ell``, ``prepare_ell`` and ``graph_to_bsr`` give the reference's
  arrays bit for bit;
* ``lp_gain`` is exact: its f32 sums are integer-valued below 2^24, so
  no summation order can change them;
* ``bsr_spmm`` sums its block products in another order than XLA's, so it
  gets the reference tests' tolerances: rtol/atol 1e-5 on sparse blocks,
  2e-4 on dense normal ones, rtol 5e-5 / atol 5e-4 through ``spmm``;
* ``embedding_bag`` adds rows in j order from zero; ``.sum(axis=1)`` of
  up to two rows is the same sum, beyond that it gets 1e-5.

Inputs come from seeded numpy generators (no Hypothesis: its example
database is tracked and a property run rewrites it).
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graphs import format as ref_format  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro.kernels.bsr_spmm import bsr_spmm as ref_bsr  # noqa: E402
from repro.kernels.bsr_spmm import ops as ref_bsr_ops  # noqa: E402
from repro.kernels.bsr_spmm import ref as ref_bsr_ref  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as ref_eb  # noqa: E402
from repro.kernels.embedding_bag import ops as ref_eb_ops  # noqa: E402
from repro.kernels.embedding_bag import ref as ref_eb_ref  # noqa: E402
from repro.kernels.lp_gain import lp_gain as ref_gain  # noqa: E402
from repro.kernels.lp_gain import ops as ref_gain_ops  # noqa: E402
from repro.kernels.lp_gain import ref as ref_gain_ref  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.graphs import format as t_format  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops as bsr_ops  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag as eb  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.lp_gain import lp_gain  # noqa: E402
from repro_torch.kernels.lp_gain import ops as gain_ops  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _graphs(family, n, seed=0, **kw):
    """The same graph for both packages: the reference's arrays, carried."""
    if family == "grid2d":
        g = ref_generators.grid2d(kw["nx"], kw["ny"])
    else:
        g = ref_generators.make(family, n, 8.0, seed=seed)
    return g, carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                      g.vweights)


def _eq(got, want):
    """Bit-identical, dtype included."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# to_ell / prepare_ell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,n,max_degree", [("rgg2d", 600, None),
                                                 ("ba", 4000, 64)])
def test_to_ell_matches_reference(family, n, max_degree):
    g, tg = _graphs(family, n, seed=2)
    if max_degree is not None:       # the cut must bite
        assert int(g.degrees().max()) > max_degree
    want = ref_format.to_ell(g, max_degree=max_degree)
    got = t_format.to_ell(tg, max_degree=max_degree)
    for a, b in zip(got[:2], want[:2]):
        _eq(a, b)
    assert got[2] == want[2]


@pytest.mark.parametrize("family,n,row_tile,max_degree",
                         [("rgg2d", 600, 128, 512), ("ba", 4000, 256, 64)])
def test_prepare_ell_matches_reference(family, n, row_tile, max_degree):
    g, tg = _graphs(family, n, seed=1)
    want = ref_gain_ops.prepare_ell(g, row_tile, max_degree)
    got = gain_ops.prepare_ell(tg, row_tile, max_degree)
    for a, b in zip(got[:2], want[:2]):
        _eq(a, b)
    assert got[2] == want[2] and got[0].shape[0] % row_tile == 0


# ---------------------------------------------------------------------------
# lp_gain
# ---------------------------------------------------------------------------

def _rand_lp_inputs(rng, n, d, n_labels, budget):
    """tests/test_kernels.py's generator: 20% padding lanes, integer
    weights 1-4, integer cluster weights around the budget."""
    lab = rng.integers(0, n_labels, (n, d)).astype(np.int32)
    lab[rng.random((n, d)) < 0.2] = -1
    w = rng.integers(1, 5, (n, d)).astype(np.float32)
    w[lab < 0] = 0.0
    cw = rng.integers(1, budget + 3, n_labels).astype(np.float32)
    tgt_w = np.where(lab >= 0, cw[np.maximum(lab, 0)], np.inf
                     ).astype(np.float32)
    own = rng.integers(0, n_labels, (n, 1)).astype(np.int32)
    vw = rng.integers(1, 3, (n, 1)).astype(np.float32)
    return lab, w, tgt_w, own, vw


@pytest.mark.parametrize("n,d,n_labels,budget", [(256, 128, 50, 8),
                                                 (512, 256, 50, 8),
                                                 (256, 128, 4, 3)])
def test_lp_gain_plain_matches_pallas_and_oracle(n, d, n_labels, budget):
    rng = np.random.default_rng(n + d + n_labels)
    arrs = _rand_lp_inputs(rng, n, d, n_labels, budget)
    b = np.full((1, 1), budget, np.float32)
    got = lp_gain.lp_gain_ell(*(torch.from_numpy(x) for x in (*arrs, b)),
                              row_tile=128)
    jargs = [jnp.asarray(x) for x in (*arrs, b)]
    pallas = ref_gain.lp_gain_ell(*jargs, row_tile=128)
    oracle = ref_gain_ref.lp_gain_ell_ref(*jargs)
    assert [t.dtype for t in got] == [torch.float32, torch.int32,
                                      torch.float32]
    for a, p, o in zip(got, pallas, oracle):
        _eq(a.numpy(), p)
        _eq(a.numpy(), o)
    assert (got[1].numpy() >= 0).any()


@pytest.mark.parametrize("slack", [10, -5])
def test_lp_gain_entry_matches_reference_ops(slack):
    """``ops.lp_gain`` on rgg2d 600 with 8 labels; a loose budget and one
    below the heaviest block, so admission bites."""
    g, tg = _graphs("rgg2d", 600, seed=2)
    labels = np.random.default_rng(0).integers(0, 8, g.n)
    cw = np.zeros(8, dtype=np.int64)
    np.add.at(cw, labels, g.vweights)
    budget = float(cw.max() + slack)
    want = ref_gain_ops.lp_gain(g, labels, cw, budget, row_tile=128)
    got = gain_ops.lp_gain(tg, labels, cw, budget, row_tile=128, device=CPU)
    for a, b in zip(got, want):
        _eq(a, b)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lp_gain_entry_matches_the_chip_checks_edge_scan():
    """The edge scan ``chip_smoke.py`` holds the full-size run to agrees
    with the entry point where both run (a tight budget, k=16)."""
    _, tg = _graphs("rgg2d", 2000, seed=4)
    k = 16
    labels = np.random.default_rng(1).integers(0, k, tg.n)
    cw = np.bincount(labels, weights=tg.vweights, minlength=k)
    budget = float(np.sort(cw)[k // 2])
    got = gain_ops.lp_gain(tg, labels, cw, budget, device=CPU)
    want = _chip_smoke().edge_scan_gain(tg, labels, cw, budget, k)
    for a, b in zip(got, want):
        _eq(a, b)
    assert (want[1] == -1).any() and (want[1] >= 0).any()


def test_lp_gain_row_tile_must_divide_the_rows():
    z = torch.zeros(6, 4, dtype=torch.int32)
    f = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="row_tile"):
        lp_gain.lp_gain_ell(z, f, f, z[:, :1], f[:, :1], torch.ones(1, 1),
                            row_tile=4)


# ---------------------------------------------------------------------------
# bsr_spmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,n,kw", [("rgg2d", 300, {}),
                                         ("rgg2d", 700, {}),
                                         ("grid2d", 0, {"nx": 32, "ny": 40})])
def test_graph_to_bsr_bitwise_equal(family, n, kw):
    g, tg = _graphs(family, n, seed=3, **kw)
    want = ref_bsr_ops.graph_to_bsr(g)
    got = bsr_ops.graph_to_bsr(tg)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[2:] == want[2:]


def _blocks(seed, rb, nnz, bs, f, dense):
    rng = np.random.default_rng(seed)
    col = rng.integers(0, rb, rb * nnz).astype(np.int32)
    if dense:
        vals = rng.standard_normal((rb * nnz, bs, bs)).astype(np.float32)
    else:
        vals = (rng.random((rb * nnz, bs, bs)) *
                (rng.random((rb * nnz, bs, bs)) < 0.05)).astype(np.float32)
    x = rng.standard_normal((rb * bs, f)).astype(np.float32)
    return col, vals, x


@pytest.mark.parametrize("dense,tol", [(False, 1e-5), (True, 2e-4)])
def test_bsr_plain_matches_pallas_and_oracle(dense, tol):
    rb, nnz, bs, f = (3, 2, 128, 128) if dense else (4, 3, 128, 128)
    col, vals, x = _blocks(7, rb, nnz, bs, f, dense)
    got = bsr_spmm.bsr_spmm(torch.from_numpy(col), torch.from_numpy(vals),
                            torch.from_numpy(x), block_rows=rb,
                            nnz_per_row=nnz)
    jargs = [jnp.asarray(a) for a in (col, vals, x)]
    for want in (ref_bsr.bsr_spmm(*jargs, block_rows=rb, nnz_per_row=nnz),
                 ref_bsr_ref.bsr_spmm_ref(*jargs, block_rows=rb,
                                          nnz_per_row=nnz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("n,f", [(300, 64), (700, 130)])
def test_spmm_matches_reference(n, f):
    g, tg = _graphs("rgg2d", n, seed=3)
    x = np.random.default_rng(1).standard_normal((g.n, f)).astype(np.float32)
    got = bsr_ops.spmm(tg, x, device=CPU)
    want = ref_bsr_ops.spmm(g, x)
    assert got.shape == (g.n, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-4)
    a = np.zeros((g.n, g.n), dtype=np.float32)
    a[g.arc_tails(), np.asarray(g.adjncy)] = g.eweights
    np.testing.assert_allclose(got, a @ x, rtol=5e-5, atol=5e-4)


def test_spmm_states_the_block_bytes_and_raises_before_allocating(
        monkeypatch):
    _, tg = _graphs("rgg2d", 300, seed=3)
    rb = -(-tg.n // 128)
    monkeypatch.setattr(bsr_ops, "_free_bytes", lambda dev: 1000)
    monkeypatch.setattr(bsr_ops, "_fill", lambda *a: pytest.fail(
        "allocated the blocks"))
    with pytest.raises(MemoryError, match=rf"need \d+ bytes \({rb} block"):
        bsr_ops.spmm(tg, np.zeros((tg.n, 4), np.float32), device=CPU)


def test_bsr_column_block_out_of_range_raises():
    col, vals, x = _blocks(0, 2, 1, 4, 3, dense=True)
    col[1] = 2
    with pytest.raises(ValueError, match="out of range"):
        bsr_spmm.bsr_spmm(torch.from_numpy(col), torch.from_numpy(vals),
                          torch.from_numpy(x), block_rows=2, nnz_per_row=1)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,bag,v,d", [(32, 1, 500, 64), (16, 4, 200, 128),
                                       (8, 2, 100, 200)])
def test_embedding_bag_matches_reference(b, bag, v, d):
    rng = np.random.default_rng(b * bag)
    idx = rng.integers(0, v, (b, bag)).astype(np.int32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    got = eb.embedding_bag_1row(torch.from_numpy(idx),
                                torch.from_numpy(table)).numpy()
    entry = eb_ops.embedding_bag(idx, table, device=CPU)
    _eq(entry, got)
    pallas = np.asarray(ref_eb.embedding_bag_1row(jnp.asarray(idx),
                                                  jnp.asarray(table)))
    oracle = np.asarray(ref_eb_ref.embedding_bag_ref(jnp.asarray(idx),
                                                     jnp.asarray(table)))
    ref_entry = ref_eb_ops.embedding_bag(idx, table)
    for want in (pallas, oracle, ref_entry):
        if bag <= 2:
            _eq(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embedding_bag_sums_duplicate_indices():
    table = np.eye(8, 128, dtype=np.float32)
    idx = np.array([[2, 2, 2], [1, 3, 1]], dtype=np.int32)
    out = eb_ops.embedding_bag(idx, table, device=CPU)
    assert out[0, 2] == 3.0 and out[1, 1] == 2.0 and out[1, 3] == 1.0
    _eq(out, ref_eb_ops.embedding_bag(idx, table))


@pytest.mark.parametrize("bad", [-1, 6])
def test_embedding_bag_index_out_of_range_raises(bad):
    table = np.ones((6, 4), dtype=np.float32)
    idx = np.array([[0, 1], [bad, 2]], dtype=np.int32)
    with pytest.raises(ValueError, match=r"out of range \[0, 6\)"):
        eb_ops.embedding_bag(idx, table, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        eb.embedding_bag_1row(torch.from_numpy(idx), torch.from_numpy(table))


@pytest.mark.parametrize("bad", [-1, 6])
def test_embedding_bag_entry_checks_indices_on_the_host(bad):
    """The entry point's range check runs on the numpy indices before any
    tensor reaches a device: a device that runs nothing still gets it."""
    table = np.ones((6, 4), dtype=np.float32)
    idx = np.array([[0, 1], [bad, 2]], dtype=np.int32)
    with pytest.raises(ValueError, match=r"out of range \[0, 6\)"):
        eb_ops.embedding_bag(idx, table, device="meta")


@pytest.mark.gpu
def test_embedding_bag_kernel_traps_on_an_unchecked_index():
    """An index outside [0, V) that reaches the kernel through the
    unchecked launch path stops it (``__trap``) instead of being read; the
    CUDA context is unusable afterwards, so this runs in a child."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "from repro_torch.kernels.embedding_bag import embedding_bag as eb\n"
        "table = torch.ones(6, 64, device='cuda')\n"
        "idx = torch.tensor([[0], [6]], dtype=torch.int32, device='cuda')\n"
        "out = eb._gather(idx, table)\n"
        "torch.cuda.synchronize()\n"
        "print('NOT STOPPED', float(out.sum()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "NOT STOPPED" not in proc.stdout
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


def test_micro_kernels_count_no_launch_on_the_cpu():
    before = dict(_build.LAUNCHES)
    eb_ops.embedding_bag(np.zeros((2, 1), np.int32),
                         np.ones((3, 4), np.float32), device=CPU)
    _, tg = _graphs("rgg2d", 300, seed=3)
    bsr_ops.spmm(tg, np.ones((tg.n, 2), np.float32), device=CPU)
    gain_ops.lp_gain(tg, np.zeros(tg.n, np.int64), np.array([tg.n]), 1e9,
                     device=CPU)
    assert _build.LAUNCHES == before
