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
  up to two rows is the same sum, beyond that it gets 1e-5;
* ``prepare_ell`` and ``lp_gain`` at 32 lanes give the reference's
  128-lane results (cut to 32 lanes; bit for bit);
* the error-compensated TF32 split of the ``bsr_spmm`` kernel, emulated
  with int32 bit operations and summed as the kernel sums it under a
  model of the tensor cores' truncating mma, keeps its products within
  the kernel's rtol / atol 1e-5.

The ``gpu``-marked tests hold the two kernels redesigned for the card
(``bsr_spmm`` on non-finite inputs, ``lp_gain`` at both lane widths) to
their plain versions there; they skip without a CUDA device.

Inputs come from seeded numpy generators (no Hypothesis: its example
database is tracked and a property run rewrites it).
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

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


@pytest.mark.parametrize("family,n,seed,d32", [("rgg2d", 600, 1, 32),
                                               ("ba", 1000, 2, 160)])
def test_prepare_ell_at_32_lanes_is_the_reference_cut(family, n, seed, d32):
    """32 lanes: the reference's arrays cut to max(32, ceil(d / 32) * 32)
    lanes (ba 1000 has a vertex of degree 139: 160 lanes, not 256)."""
    g, tg = _graphs(family, n, seed=seed)
    want = ref_gain_ops.prepare_ell(g, 128)
    idx, wgt, d = gain_ops.prepare_ell(tg, 128, lanes=32)
    assert d == d32 == max(32, -(-int(g.degrees().max()) // 32) * 32)
    assert want[2] == max(128, -(-d32 // 128) * 128) > d32 or d32 == 128
    _eq(idx, want[0][:, :d32])
    _eq(wgt, want[1][:, :d32])
    assert (want[0][:, d32:] == -1).all() and (want[1][:, d32:] == 0).all()


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


@pytest.mark.parametrize("lanes", [32, 128])
@pytest.mark.parametrize("family,n,seed", [("rgg2d", 600, 2), ("ba", 1000, 2)])
def test_lp_gain_entry_at_both_lane_widths_matches_reference_ops(
        family, n, seed, lanes):
    """``ops.lp_gain`` at 32 lanes (its default) and at 128 gives the
    reference's ``lp_gain`` (128 lanes, the Pallas kernel in interpret
    mode) bit for bit: rgg2d (32 against 128 lanes) and ba 1000, whose
    degree-139 hub makes the widths 160 and 256. The budget admits only
    the lighter half of the blocks, so admission bites."""
    g, tg = _graphs(family, n, seed=seed)
    labels = np.random.default_rng(3).integers(0, 8, g.n)
    cw = np.zeros(8, dtype=np.int64)
    np.add.at(cw, labels, g.vweights)
    budget = float(np.sort(cw)[4])
    want = ref_gain_ops.lp_gain(g, labels, cw, budget, row_tile=128)
    got = gain_ops.lp_gain(tg, labels, cw, budget, row_tile=128, device=CPU,
                           lanes=lanes)
    for a, b in zip(got, want):
        _eq(a, b)
    assert (want[1] >= 0).any() and (want[1] == -1).any()


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
# bsr_spmm's error-compensated TF32 ("3xTF32"), emulated on the CPU
# ---------------------------------------------------------------------------

def _tf32_rna(v):
    """``cvt.rna.tf32.f32`` of finite f32 by int32 bit operations: the
    magnitude rounded to 10 mantissa bits, ties away from zero (half of
    the 13 dropped bits added to the sign-magnitude pattern, then the 13
    bits cleared)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _finite_f32(seed, n=200_000):
    """Finite f32 over the whole exponent range, subnormals, signed zeros
    and exact tf32 ties included."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = bits.view(np.float32)
    v = v[np.isfinite(v)]
    ties = (rng.integers(0, 2**19, 1000, dtype=np.uint64).astype(np.uint32)
            << 13 | 0x1000).view(np.float32)
    extra = np.array([0.0, -0.0, 1.0, -1.0, 1 + 2**-11, -(1 + 2**-11),
                      np.finfo(np.float32).tiny, 2**-149, 3.0e38],
                     dtype=np.float32)
    return torch.from_numpy(np.concatenate([v, ties[np.isfinite(ties)],
                                            extra]))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_rna_rounds_to_nearest_ties_away(seed):
    v = _finite_f32(seed)
    v = v[v.abs() < 3.4e38]          # rounding up past FLT_MAX gives inf
    hi = _tf32_rna(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    # the same rounding in f64: 10 mantissa bits at v's exponent
    # (subnormals at the smallest normal exponent), ties away from zero
    a = v.double().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, 1.0))).clamp(min=-126)
    ulp = torch.pow(2.0, e - 10)
    want = torch.sign(v.double()) * torch.floor(a / ulp + 0.5) * ulp
    np.testing.assert_array_equal(hi.double().numpy(), want.numpy())
    assert torch.equal(hi.signbit(), v.signbit())


@pytest.mark.parametrize("seed", [2, 3])
def test_tf32_split_hi_plus_residual_is_exact(seed):
    """``v - hi`` is exact in f32, so hi + (v - hi) == v for every finite
    f32; rounding the residual to tf32 (the kernel's lo) leaves at most
    2^-22 |v|, or half of tf32's subnormal step, 2^-137."""
    v = _finite_f32(seed)
    v = v[v.abs() < 3.4e38]
    hi = _tf32_rna(v)
    res = v - hi
    assert torch.equal(hi.double() + res.double(), v.double())
    lo = _tf32_rna(res)
    left = (v.double() - hi.double() - lo.double()).abs()
    assert bool((left <= torch.clamp(2.0**-22 * v.double().abs(),
                                     min=2.0**-137)).all())


def _round_toward_zero(v, window):
    """v (f64) cut toward zero to ``window`` significant bits."""
    a = v.abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, 1.0)))
    step = torch.pow(2.0, e - (window - 1))
    return torch.trunc(v / step) * step


def _mma(c, prods, window):
    """A model of one ``mma.sync`` TF32 step per output: ``c`` (f64 holding
    f32) plus its eight products (exact: tf32 x tf32 fits f32), every
    addend truncated toward zero at the scale of the largest (``window``
    bits), summed, the sum cut toward zero to f32's 24 bits."""
    terms = torch.cat([c[..., None], prods], -1)
    top = terms.abs().amax(-1)
    e = torch.floor(torch.log2(torch.where(top > 0, top, 1.0)))
    step = torch.pow(2.0, e - (window - 1))[..., None]
    total = (torch.trunc(terms / step) * step).sum(-1)
    return _round_toward_zero(total, 24).float().double()


def _tensor_core_bsr(col, vals, x, rb, nnz, chained, window=22):
    """The kernel's finite path under the ``_mma`` model: per 8-deep step,
    a_lo x_hi, a_hi x_lo and a_hi x_hi summed by three mma steps in a
    fresh value and added to the f32 Y tile rounded to nearest; or, with
    ``chained``, the three mma steps onto the Y tile itself."""
    bs, f = vals.shape[1], x.shape[1]
    ah, al = (t.double() for t in _split(vals))
    xh, xl = (t.double() for t in _split(x))
    acc = torch.zeros(rb, bs, f, dtype=torch.float64)
    for slot in range(nnz):
        c = col.view(rb, nnz)[:, slot].long()
        pairs = [(a.view(rb, nnz, bs, bs)[:, slot], b.view(-1, bs, f)[c])
                 for a, b in ((al, xh), (ah, xl), (ah, xh))]
        for k0 in range(0, bs, 8):
            k1 = min(k0 + 8, bs)
            step = acc if chained else torch.zeros_like(acc)
            for a, b in pairs:      # products (rb, bs, f, depth)
                p = (a[:, :, k0:k1, None] * b[:, None, k0:k1, :]
                     ).permute(0, 1, 3, 2)
                step = _mma(step, p, window)
            acc = step if chained else (acc.float() + step.float()).double()
    return acc.view(rb * bs, f).float()


@pytest.mark.parametrize("rb,nnz,bs,f", [(3, 2, 128, 1), (4, 3, 128, 130),
                                         (5, 1, 128, 64), (3, 2, 64, 96)])
def test_three_tf32_products_hold_the_kernels_tolerance(rb, nnz, bs, f):
    """a_lo x_hi + a_hi x_lo + a_hi x_hi, each product of tf32 parts,
    summed as the kernel sums them (three mma steps a depth of 8 in a
    fresh value, then one f32 add to the Y tile), stays within the
    kernel's (rtol 1e-5, atol 1e-5) of the plain version on
    chip_smoke.py's ragged bsr_spmm shapes (one slot a row, F = 1 and 130,
    BS = 64). The mma model truncates every addend at 22 bits below the
    largest, coarser than the H100 showed: chaining the three steps onto
    the Y tile measured 1.9e-5 there on the F = 130 shape, 3.1e-5 under
    this model. Chaining is also worse than the kernel's order here, and
    a single TF32 product misses the tolerance."""
    col, vals, x = _blocks(rb * 100 + f, rb, nnz, bs, f, dense=False)
    col, vals, x = (torch.from_numpy(a) for a in (col, vals, x))
    kw = dict(block_rows=rb, nnz_per_row=nnz)
    want = bsr_spmm.bsr_spmm(col, vals, x, **kw)
    got = _tensor_core_bsr(col, vals, x, rb, nnz, chained=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    chained = _tensor_core_bsr(col, vals, x, rb, nnz, chained=True)
    assert ((got - want).abs().max() <= (chained - want).abs().max())
    ah, _ = _split(vals)
    xh, _ = _split(x)
    assert not torch.allclose(bsr_spmm.bsr_spmm(col, ah, xh, **kw), want,
                              rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the redesigned kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rb,nnz,bs,f,kind", [
    (4, 3, 128, 128, "scattered"), (3, 2, 128, 130, "scattered"),
    (5, 2, 64, 1, "scattered"), (4, 2, 128, 128, "zero_weights"),
    (3, 3, 99, 36, "zero_weights"), (3, 2, 128, 64, "beyond_split")])
def test_bsr_spmm_kernel_carries_non_finite_values_on_gpu(
        rb, nnz, bs, f, kind, cuda_device):
    """+-inf and NaN in X, zero padded slots on column block 0, an inf met
    only by zero weights (NaN in the plain version), values beyond the
    split's range: the kernel gives the plain version's NaNs and
    infinities and its finite values within rtol / atol 1e-5."""
    col, vals, x = _chip_smoke().bsr_non_finite(
        np.random.default_rng(rb * bs + f), rb, nnz, bs, f, kind)
    col = col.astype(np.int32)
    vals, x = vals.astype(np.float32), x.astype(np.float32)
    kw = dict(block_rows=rb, nnz_per_row=nnz)
    want = bsr_spmm.bsr_spmm(*(torch.from_numpy(a) for a in (col, vals, x)),
                             **kw)
    assert (~want.isfinite()).any()
    on = [torch.from_numpy(a).to(cuda_device) for a in (col, vals, x)]
    got = bsr_spmm.bsr_spmm(*on, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [32, 128])
@pytest.mark.parametrize("family,n,seed", [("rgg2d", 2000, 2),
                                           ("ba", 1000, 2)])
def test_lp_gain_kernel_matches_plain_at_both_lane_widths_on_gpu(
        family, n, seed, lanes, cuda_device):
    """The kernel on the entry point's operands at 32 and 128 lanes (D =
    32 and 128 on rgg2d, 160 and 256 on ba 1000) gives the plain
    version's bits."""
    _, tg = _graphs(family, n, seed=seed)
    labels = np.random.default_rng(4).integers(0, 8, tg.n)
    cw = np.bincount(labels, weights=tg.vweights, minlength=8)
    budget = float(cw.max() - 5)
    args = gain_ops.gain_operands(tg, labels, cw, budget, 256, cuda_device,
                                  lanes)
    got = lp_gain.lp_gain_ell(*args)
    want = lp_gain.lp_gain_ell(*(a.cpu() for a in args))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert (want[1] >= 0).any()


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
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=600)
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
