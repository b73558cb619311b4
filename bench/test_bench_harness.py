"""The harness without a card: a measurement run refuses to fall back to
the CPU, nothing it imports is JAX's, and at a small size on the CPU a
clean run comes out correct while the control and every planted fault
come out not correct."""
import argparse
import contextlib
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from bench import control, harness

REPO = Path(__file__).resolve().parent.parent
# a seed whose sampled request is the window's first
SEED = 2
N = 6000


def env():
    import os
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    e.pop("PYTHONPATH", None)
    return e


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "rgg2d-n20-k16.solo",
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_harness_imports_nothing_of_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.harness as h, bench.capture, bench.devtrace, "
        "bench.control, bench.reference.check, bench.reference.single, "
        "bench.graphs\n"
        "import repro_torch.api\n"
        "[h.load(f, n) for f, n in (('entries', 'run'), "
        "('stages', 'single'))]\n"
        "[h.load_metric(m['name']) for m in h.manifest()['per_layer'] "
        "+ h.manifest()['end_to_end']]\n"
        "print(h.forbidden_modules())\n" % (str(REPO), str(REPO / "src")))
    out = subprocess.run([sys.executable, "-c", code], env=env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = set(harness.forbidden_modules())
    for name in ("repro_torch", "repro_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()


def run(workload, plant=None):
    cell, config, traffic, e2e, layer = harness.cell_of(harness.manifest(),
                                                        workload)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=0.0,
                              trace=0)
    ctx = control.PLANTS[plant]() if plant else contextlib.nullcontext()
    with ctx:
        return harness.run_cell(args, cell, dict(config, n=N), traffic, e2e,
                                layer, "cpu", time.perf_counter())


CELLS = ["rgg2d-n20-k16.solo", "rhg-n17-k16.solo"]


@pytest.mark.parametrize("workload", CELLS)
def test_clean_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"partition_medges_per_s",
                                   "peak_device_gib", "setup_s"}
    assert list(out)[-1] == "checks"
    assert {"answer_diff", "extend_diff", "initial_diff",
            "stage_order"} <= set(out["checks"])


# at the tests' 6000 vertices no rhg request ever goes over budget, so a
# balancer that does nothing changes nothing there
FAULTS = [(w, p) for w in CELLS for p in sorted(control.PLANTS)
          if (w, p) != ("rhg-n17-k16.solo", "unchanged_balance")]


@pytest.mark.parametrize("workload,plant", FAULTS)
def test_planted_fault_is_not_correct(workload, plant):
    out = run(workload, plant)
    assert not out["correct"], out["checks"]
