"""repro_torch's facade beyond the ``single`` backend against the JAX
package's, bit for bit: the paper's baselines (``random_balanced``,
``single_level_lp``, ``plain_mgp``) as functions and as backends,
``Partitioner.compare``, the single-device ``PartitionSession`` (its
``BucketCache``, its lifecycle and what it does not port; its
``submit_many`` in ``test_torch_batching.py``), the partition
CLI as a subprocess, and the kernel build's lock under concurrent first
loads (the compiler replaced by a stub).
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as ref_api  # noqa: E402
from repro.api import backends as ref_backends  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core.deep_mgp import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.deep_mgp import PartitionerConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def carried(g):
    return carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                   g.vweights)


def _strip(record):
    return {k: v for k, v in record.items() if k != "time_s"}


def _strip_trace(trace):
    return [_strip(rec) for rec in trace]


@pytest.fixture(scope="module")
def rgg2000():
    """rgg2d n=2000 (seed 3): plain_mgp k=4 gives cut 209 and
    single_level_lp 970 in the reference."""
    return ref_generators.make("rgg2d", 2000, 8.0, seed=3)


@pytest.mark.parametrize("k,seed,weighted", [(4, 0, False), (7, 5, False),
                                             (16, 2, True)])
def test_random_balanced_matches_reference(k, seed, weighted):
    g = ref_generators.make("rgg2d", 900, 8.0, seed=seed)
    if weighted:
        g = ref_generators.weighted_variant(g, seed=seed)
    want = ref_baselines.random_balanced(g, k, seed)
    got = baselines.random_balanced(carried(g), k, seed)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=k).min() > 0


@pytest.mark.parametrize("name,cut", [("plain_mgp", 209),
                                      ("single_level_lp", 970)])
def test_baseline_backends_match_reference(rgg2000, name, cut):
    ref = ref_api.Partitioner(backend=name).run(
        ref_api.PartitionRequest(graph=rgg2000, k=4))
    res = api.Partitioner(backend=name, device=CPU).run(
        api.PartitionRequest(graph=carried(rgg2000), k=4))
    assert ref.cut == res.cut == cut and res.feasible
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert _strip(res.summary()) == _strip(ref.summary())


@pytest.mark.parametrize("kernel", ["composed", "fused"])
def test_baseline_functions_match_reference(kernel):
    """plain_mgp with a contraction limit that makes it coarsen (two
    levels), single_level_lp with its own eps and seed; the port's
    ``kernel`` knob only changes how the hot loops run."""
    g = ref_generators.make("rgg2d", 3000, 8.0, seed=8)
    fields = dict(contraction_limit=40, num_chunks=4, ip_repetitions=2,
                  seed=4)
    want = ref_baselines.plain_mgp(g, 8, cfg=RefConfig(**fields))
    got = baselines.plain_mgp(carried(g), 8,
                              cfg=PartitionerConfig(kernel=kernel, **fields),
                              device=CPU)
    np.testing.assert_array_equal(got, want)
    want = ref_baselines.single_level_lp(g, 5, eps=0.05, seed=6)
    got = baselines.single_level_lp(carried(g), 5, eps=0.05, seed=6,
                                    device=CPU)
    np.testing.assert_array_equal(got, want)


def test_compare_matches_reference():
    spec = dict(family="rgg2d", n=2500, avg_deg=8.0, seed=6)
    names = ["single", "plain_mgp", "single_level_lp"]
    ref = ref_api.Partitioner().compare(
        ref_api.PartitionRequest(graph=ref_api.GraphSpec(**spec), k=8,
                                 quality="best"), names)
    res = api.Partitioner(device=CPU).compare(
        api.PartitionRequest(graph=api.GraphSpec(**spec), k=8,
                             quality="best"), names)
    assert [r.backend for r in res] == names
    graphs = {id(r.request.graph) for r in res}
    assert len(graphs) == 1                  # materialized once
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.assignment, b.assignment)
        assert _strip(a.summary()) == _strip(b.summary())
        assert _strip_trace(a.trace) == _strip_trace(b.trace)
    assert res[0].cut < res[2].cut


def test_registry_and_batchable_match_reference():
    names = {"single", "plain_mgp", "single_level_lp"}
    assert names <= set(backends.available_backends())
    for name in names | {"dist", "dist-grid", "no-such"}:
        assert api.is_batchable(name) == ref_backends.is_batchable(name)
    for devices in (1, 2, 16):
        for backend in ("auto", "single", "plain_mgp"):
            req = types.SimpleNamespace(devices=devices, backend=backend)
            for n in (10, 64 * devices, 10**6):
                assert backends.required_devices(req, n) == \
                    ref_backends.required_devices(req, n)


# rgg2d n=2000, k=8, C=64: the reference gives cuts 169, 335 and 212 on
# graph seeds 0, 1 and 2
SESSION_SPECS = [(0, 169), (1, 335), (2, 212)]


def _session_requests(mod):
    cfg = (RefConfig if mod is ref_api else PartitionerConfig)(
        contraction_limit=64)
    reqs = [mod.PartitionRequest(graph=mod.GraphSpec("rgg2d", 2000, 8.0,
                                                     seed=s),
                                 k=8, config=cfg) for s, _ in SESSION_SPECS]
    reqs.append(dataclasses.replace(reqs[0], quality="best"))
    return reqs


def test_session_run_batch_matches_solo_runs_and_reference():
    with ref_api.PartitionSession(devices=1, max_workers=4) as sess:
        want = sess.run_batch(_session_requests(ref_api))
    reqs = _session_requests(api)
    with api.PartitionSession(devices=1, max_workers=4, device=CPU) as sess:
        got = sess.run_batch(reqs)
        stats = sess.stats()
        assert len(sess._graph_cache) == 3   # one materialize per spec
    solo = api.Partitioner(device=CPU).run_batch(reqs)
    assert [r.cut for r in got[:3]] == [c for _, c in SESSION_SPECS]
    for a, b, c in zip(got, solo, want):
        np.testing.assert_array_equal(a.assignment, b.assignment)
        np.testing.assert_array_equal(a.assignment, c.assignment)
        assert _strip_trace(a.trace) == _strip_trace(b.trace) == \
            _strip_trace(c.trace)
        assert _strip(a.summary()) == _strip(c.summary())
    assert any(r["phase"] == "refine-mode" for r in got[3].trace)
    assert stats["served"] == 4 and stats["devices"] == 1


def test_bucket_cache_evicts_least_recently_used():
    cache = api.BucketCache(maxsize=2)
    cache["a"], cache["b"] = 1, 2
    assert cache.get("a") == 1          # a is now the most recent
    cache["c"] = 3
    assert "b" not in cache and "a" in cache and "c" in cache
    assert len(cache) == 2 and cache.evictions == 1
    assert cache["a"] == 1 and cache.get("b", 9) == 9
    cache["d"] = 4                      # c was used least recently
    assert sorted(cache.keys()) == ["a", "d"] and cache.evictions == 2
    with pytest.raises(ValueError):
        api.BucketCache(maxsize=0)


def test_session_validates_and_rejects_after_close():
    for bad in (dict(devices=0), dict(stack="sometimes"),
                dict(graph_cache_size=0)):
        with pytest.raises(ValueError):
            api.PartitionSession(device=CPU, **bad)
    sess = api.PartitionSession(devices=1, device=CPU)
    assert sess.mesh is None
    sess.close()
    with pytest.raises(RuntimeError, match="session is closed"):
        sess.submit(api.PartitionRequest(graph=api.GraphSpec("rgg2d", 100),
                                         k=2))


@pytest.mark.parametrize("what,item", [("devices", 5), ("mesh", 5),
                                       ("shard_ctx", 5)])
def test_unported_session_parts_raise(what, item):
    with api.PartitionSession(device=CPU) as sess:
        calls = {
            "devices": lambda: api.PartitionSession(devices=2, device=CPU),
            "mesh": lambda: api.PartitionSession(mesh=object(), device=CPU),
            "shard_ctx": lambda: sess.shard_ctx,
        }
        with pytest.raises(NotImplementedError,
                           match=f"queue 1 item {item}"):
            calls[what]()


def _cli(module, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", module, "--family", "rgg2d", "--n", "1500",
         "--k", "8", "--compare", "--trace", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_matches_reference_cli():
    ref = _cli("repro.launch.partition", "--refine", "unconstrained")
    out = _cli("repro_torch.launch.partition", "--refine", "unconstrained",
               "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert out.returncode == 0, out.stderr
    want = [json.loads(x) for x in ref.stdout.splitlines()]
    got = [json.loads(x) for x in out.stdout.splitlines()]
    assert [_strip(x) for x in got] == [_strip(x) for x in want]
    backends_run = [x["backend"] for x in got if "backend" in x]
    assert backends_run == ["single", "plain_mgp", "single_level_lp"]
    assert any(x.get("phase") == "refine-mode" for x in got)


class _StubCompiler:
    """Stands in for ``subprocess.Popen`` of nvcc: writes the ``-o``
    file after a pause, so that concurrent first loads overlap."""

    def __init__(self):
        self.sources = []
        self._lock = threading.Lock()

    def __call__(self, cmd, stdout=None, stderr=None):
        with self._lock:
            self.sources.append(Path(cmd[-1]).stem)
        out = Path(cmd[cmd.index("-o") + 1])
        time.sleep(0.05)
        out.write_bytes(b"stub")
        return types.SimpleNamespace(wait=lambda: 0)


def test_build_load_compiles_once_under_concurrent_first_loads(
        tmp_path, monkeypatch):
    compiler = _StubCompiler()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", compiler)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            path=path, f=types.SimpleNamespace()))
    names = ["lp_move", "seg_merge"] * 6
    barrier = threading.Barrier(len(names))
    got, errors = [None] * len(names), []

    def first_load(i, name):
        try:
            barrier.wait(timeout=30)
            got[i] = _build.load(name, {"f": []})
        except Exception as exc:            # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_load, args=(i, n))
                   for i, n in enumerate(names)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert sorted(compiler.sources) == ["lp_move", "seg_merge"]
    for name in ("lp_move", "seg_merge"):
        libs = {id(lib) for lib, n in zip(got, names) if n == name}
        assert len(libs) == 1
        assert (tmp_path / _build._target(name).name).read_bytes() == b"stub"
    assert list(tmp_path.glob("*.tmp")) == []


def test_launch_counts_stay_exact_under_threads():
    saved = dict(_build.LAUNCHES)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()

        def count():
            for _ in range(5000):
                _build.count_launch("greedy_pick")

        threads = [threading.Thread(target=count) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert _build.LAUNCHES["greedy_pick"] == 8 * 5000
    finally:
        sys.setswitchinterval(old)
        _build.LAUNCHES.update(saved)
