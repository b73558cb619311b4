"""repro_torch's int32 helpers against the JAX semantics they stand in for.

Each test pins one torch-versus-JAX divergence that decides bit-identity
of the port: uint32 hashing done in int64, ``lax.sort(num_keys=2)`` as a
composite key under a stable sort, ``lax.top_k``'s tie order, the int32
result of a cumulative sum, and the identities of empty segments. Inputs
come from a numpy seed and go to both packages as numpy arrays; every
comparison is exact.
"""
import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import lp as ref_lp  # noqa: E402
from repro.kernels.lp_move.lp_move import _h32  # noqa: E402
from repro_torch.core import lp  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

I32_MAX = 2**31 - 1
I32_MIN = -2**31


@pytest.mark.parametrize("salt", [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789])
def test_hash32_matches_both_reference_hashes(salt):
    rng = np.random.default_rng(salt & 0xFFFF)
    x = np.concatenate([
        np.array([-1, 0, 1, I32_MAX, I32_MIN, -2], dtype=np.int32),
        rng.integers(I32_MIN, I32_MAX, 2000, dtype=np.int64).astype(np.int32)])
    got = lp.hash32(torch.from_numpy(x), salt).numpy()
    want = np.asarray(ref_lp._hash32(jnp.asarray(x), jnp.uint32(salt)))
    want_k = np.asarray(_h32(jnp.asarray(x), jnp.uint32(salt)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_k)


def test_hash32_sentinel_hashes_as_uint32_max():
    """-1 (the ELL padding label) hashes as 0xFFFFFFFF, not as -1 widened
    to int64."""
    salt = 0x12345678
    h = (0xFFFFFFFF * 2654435761) % 2**32 ^ salt
    h ^= h >> 15
    got = int(lp.hash32(torch.tensor([-1], dtype=torch.int32), salt)[0])
    assert got == h & 0x7FFFFFFF


def test_sort2_is_the_stable_two_key_lax_sort():
    rng = np.random.default_rng(3)
    n = 5000
    k1 = rng.integers(0, 40, n).astype(np.int32)
    k2 = rng.integers(0, 25, n).astype(np.int32)   # many full ties
    iota = np.arange(n, dtype=np.int32)
    _, _, want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2),
                               jnp.asarray(iota)), num_keys=2)
    got = lp.sort2(torch.from_numpy(k1), torch.from_numpy(k2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort2_with_31_bit_second_key():
    rng = np.random.default_rng(4)
    k1 = rng.integers(0, 3, 1000).astype(np.int32)
    k2 = rng.integers(0, I32_MAX, 1000).astype(np.int32)
    k2[::7] = k2[0]
    _, _, want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2),
                               jnp.arange(1000, dtype=jnp.int32)),
                              num_keys=2)
    got = lp.sort2(torch.from_numpy(k1), torch.from_numpy(k2), k2_bits=31)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_tie_order_is_lax_top_k():
    """``lax.top_k`` ranks ties by the lower index; a stable descending
    sort reproduces that, which the balancer's pool order depends on."""
    rel = np.array([1, 3, 3, 2, 3], dtype=np.float32)
    _, want = jax.lax.top_k(jnp.asarray(rel), 3)
    got = torch.sort(torch.from_numpy(rel), descending=True,
                     stable=True).indices[:3]
    np.testing.assert_array_equal(np.asarray(want), [1, 2, 4])
    np.testing.assert_array_equal(got.numpy(), [1, 2, 4])


def test_topk_tie_order_with_infinities():
    rng = np.random.default_rng(5)
    rel = rng.integers(-3, 4, 3000).astype(np.float32)
    rel[rng.random(3000) < 0.4] = -np.inf
    _, want = jax.lax.top_k(jnp.asarray(rel), 128)
    got = torch.sort(torch.from_numpy(rel), descending=True,
                     stable=True).indices[:128]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cumsum32_stays_int32():
    x = torch.tensor([I32_MAX, 1, 5], dtype=torch.int32)
    out = lp.cumsum32(x)
    assert out.dtype == torch.int32
    want = np.asarray(jnp.cumsum(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(out.numpy(), want)   # wraps like XLA


def test_segment_ops_and_empty_segment_identities():
    rng = np.random.default_rng(6)
    num = 50
    seg = np.sort(rng.integers(0, num, 400))
    seg = seg[(seg % 3) != 0]             # every third segment empty
    x = rng.integers(-1000, 1000, seg.size).astype(np.int32)
    ts, tx = torch.from_numpy(seg), torch.from_numpy(x)
    js, jx = jnp.asarray(seg), jnp.asarray(x)
    for mine, theirs in ((lp.segment_sum, jax.ops.segment_sum),
                         (lp.segment_max, jax.ops.segment_max),
                         (lp.segment_min, jax.ops.segment_min)):
        got = mine(tx, ts, num)
        want = np.asarray(theirs(jx, js, num_segments=num))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(lp.segment_max(tx, ts, num)[0]) == I32_MIN
    assert int(lp.segment_min(tx, ts, num)[0]) == I32_MAX


@pytest.mark.parametrize("b,seed", [(1, 0), (8, 7), (5, 2**32 - 3)])
def test_chunk_salt_stream(b, seed):
    mult = 0x85EBCA6B
    want = np.asarray(jnp.arange(b, dtype=jnp.uint32) * np.uint32(mult)
                      + jnp.uint32(seed % 2**32))
    assert lp.chunk_salts(b, seed, mult) == [int(v) for v in want]


def test_kernel_mode_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.resolve_kernel_mode("auto", cpu) == "composed"
    assert dispatch.resolve_kernel_mode("auto", cuda) == "fused"
    for mode in ("fused", "composed"):
        assert dispatch.resolve_kernel_mode(mode, cpu) == mode
    with pytest.raises(ValueError):
        dispatch.check_kernel_mode("pallas")


def test_resolve_device_never_falls_back_to_cpu():
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert dispatch.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch.resolve_device(None)
        with pytest.raises(RuntimeError):
            dispatch.resolve_device("cuda")

