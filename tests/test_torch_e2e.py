"""The port's main path end to end against the JAX reference, bit for bit.

``repro_torch.api.Partitioner(backend="single", device="cpu")`` and
``repro.api.Partitioner(backend="single")`` run the same request (the
graph and config carried over as plain arrays and a field dict) and must
return the same assignment, the same cut and the same per-level trace
records apart from wall times. Under ``kernel="fused"`` the port runs the
plain versions of its CUDA kernels, so this also covers the fused wiring.

* the anchor: rgg2d n=4000, k=16, eps=0.03, benchmark config — cut 819;
* ba n=4000 (max degree 236): the hub-heavy family — cut 9978;
* weighted rgg2d n=3000, k=16 (the reference's ``weighted_variant``):
  contraction merges arcs of weight above 1, so ``seg_merge`` sums them;
* rgg2d n=6000, k=256, C=32: many blocks, deep recursive bisection.

The ``auto`` backend policy is the reference's; a request it sends to a
distributed backend raises, since the port has none yet.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as ref_api  # noqa: E402
from repro.api import backends as ref_backends  # noqa: E402
from repro.core.deep_mgp import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.core import deep_mgp, metrics  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

# benchmarks/common.py::bench_config(), spelled out
BENCH_CONFIG = RefConfig(contraction_limit=256, ip_repetitions=2,
                         num_chunks=4)
CASES = {"rgg2d": (819, 19), "ba": (9978, 236)}   # cut, max degree


@pytest.fixture(scope="module")
def reference_runs():
    """One JAX reference run per family, shared by both kernel modes."""
    out = {}
    for family in CASES:
        g = ref_generators.make(family, 4000, 8.0, seed=17)
        res = ref_api.Partitioner(backend="single").run(
            ref_api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                     config=BENCH_CONFIG))
        out[family] = (g, res)
    return out


def _strip(trace):
    return [{k: v for k, v in rec.items() if k != "time_s"}
            for rec in trace]


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("family", sorted(CASES))
def test_single_backend_is_bit_identical(reference_runs, family, kernel):
    g, ref = reference_runs[family]
    cut, max_deg = CASES[family]
    assert int(np.diff(g.indptr).max()) == max_deg
    assert ref.metrics["cut"] == cut and ref.feasible
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    cfg = carry.config_from_dict(dataclasses.asdict(BENCH_CONFIG))
    launches = dict(_build.LAUNCHES)
    res = api.Partitioner(backend="single", device="cpu").run(
        api.PartitionRequest(graph=h, k=16, epsilon=0.03, config=cfg,
                             kernel=kernel))
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert res.metrics["cut"] == cut and res.feasible
    assert res.metrics == ref.metrics
    assert _strip(res.trace) == _strip(ref.trace)
    assert [r["phase"] for r in res.trace][-1] == "final"
    assert _build.LAUNCHES == launches          # CPU: plain versions only


# name -> (family, n, k, weighted, config fields)
MORE_CASES = {
    "weighted_rgg2d_3000_k16": ("rgg2d", 3000, 16, True,
                                dataclasses.asdict(BENCH_CONFIG)),
    "rgg2d_6000_k256_c32": ("rgg2d", 6000, 256, False,
                            dict(contraction_limit=32)),
}


@pytest.fixture(scope="module")
def more_reference_runs():
    out = {}
    for name, (family, n, k, weighted, fields) in MORE_CASES.items():
        g = ref_generators.make(family, n, 8.0, seed=17)
        if weighted:
            g = ref_generators.weighted_variant(g, seed=17)
        res = ref_api.Partitioner(backend="single").run(
            ref_api.PartitionRequest(graph=g, k=k, epsilon=0.03,
                                     config=RefConfig(**fields)))
        out[name] = (g, res)
    return out


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("name", sorted(MORE_CASES))
def test_single_backend_is_bit_identical_on_more_instances(
        more_reference_runs, name, kernel):
    g, ref = more_reference_runs[name]
    _, _, k, weighted, fields = MORE_CASES[name]
    assert ref.feasible
    if weighted:
        assert g.eweights.max() > 1 and g.vweights.max() > 1
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    cfg = carry.config_from_dict(dataclasses.asdict(RefConfig(**fields)))
    res = api.Partitioner(backend="single", device="cpu").run(
        api.PartitionRequest(graph=h, k=k, epsilon=0.03, config=cfg,
                             kernel=kernel))
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert res.metrics == ref.metrics and res.feasible
    assert _strip(res.trace) == _strip(ref.trace)


class _Req:
    def __init__(self, devices, backend="auto"):
        self.devices, self.backend = devices, backend


@pytest.mark.parametrize("devices", [1, 2, 4, 16, 32])
def test_auto_backend_policy_matches_reference(devices):
    threshold = backends.MIN_VERTICES_PER_DEVICE * devices
    assert threshold == ref_backends.MIN_VERTICES_PER_DEVICE * devices
    for n in (1, threshold - 1, threshold, threshold + 1, 10**6):
        for backend in ("auto", "single"):
            req = _Req(devices, backend)
            assert backends.resolve_backend(req, n) == \
                ref_backends.resolve_backend(req, n)
    want = ("single" if devices == 1 else
            "dist-grid" if devices >= 16 else "dist")
    assert backends.resolve_backend(_Req(devices), threshold) == want


def test_request_the_policy_sends_to_dist_raises():
    """Two devices and 2000 vertices: the reference's policy picks
    ``dist``; with no process group of two ranks the port raises, naming
    how to start them, instead of running ``single`` (which gave cut 194
    before the policy was mirrored). The dist backends are registered."""
    req = api.PartitionRequest(graph=api.GraphSpec("rgg2d", 2000, 8.0,
                                                   seed=1),
                               k=4, devices=2)
    with pytest.raises(ValueError,
                       match=r"distributed_init.*--devices 2"):
        api.Partitioner(device="cpu").run(req)
    for name in ("dist", "dist-grid"):
        assert callable(backends.get_backend(name))


def test_config_carries_every_reference_field():
    ref = dataclasses.asdict(RefConfig(seed=5, kernel="fused"))
    cfg = carry.config_from_dict(ref)
    assert dataclasses.asdict(cfg) == ref
    with pytest.raises(TypeError):
        carry.config_from_dict({**ref, "no_such_field": 1})


def test_partition_entry_point_on_cpu():
    h = carry.graph_from_arrays(
        *(getattr(ref_generators.make("rgg2d", 1200, 8.0, seed=2), f)
          for f in ("indptr", "adjncy", "eweights", "vweights")))
    cfg = deep_mgp.PartitionerConfig(contraction_limit=100, num_chunks=4,
                                     ip_repetitions=1)
    trace = []
    part = deep_mgp.partition(h, 4, cfg, trace=trace, device="cpu")
    assert part.shape == (h.n,) and part.min() == 0 and part.max() == 3
    assert metrics.is_feasible(h, part, 4, cfg.epsilon)
    assert trace[0]["phase"] == "coarsen" and trace[-1]["phase"] == "final"
    assert metrics.edge_cut(h, part) == trace[-1]["cut"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("refine", ["lp", "unconstrained"])
def test_full_size_on_gpu_matches_reference(cuda_device, refine):
    """rgg2d at 2^20 vertices, k=16, preset fast: the port on the card
    (CUDA kernels) against the JAX reference on the CPU (composed), under
    both refinement tiers. ``lp`` gives cut 15465, feasible, over five
    coarsening levels."""
    g = ref_generators.make("rgg2d", 1 << 20, 8.0, seed=17)
    assert (g.m, int(np.diff(g.indptr).max())) == (8378246, 24)
    ref = ref_api.Partitioner(backend="single").run(
        ref_api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                 kernel="composed", refine=refine))
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    res = api.Partitioner(backend="single", device=cuda_device).run(
        api.PartitionRequest(graph=h, k=16, epsilon=0.03, kernel="fused",
                             refine=refine))
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert _strip(res.trace) == _strip(ref.trace)
    assert res.metrics["cut"] == ref.metrics["cut"]
    if refine == "lp":
        assert res.metrics["cut"] == 15465
    else:
        assert sum(r["phase"] == "refine-mode" for r in res.trace) == 7
    assert res.feasible
    assert sum(r["phase"] == "coarsen" for r in res.trace) == 5
