"""The port's distributed partitioner against the JAX reference's on
rgg2d n=1500 (seed 3, k=8, C=32) at P = 1, 2 and 4, the last on a real
2 x 2 grid (``dist-grid``): the facade's backends and
``dist_partition_impl`` directly, in both memory models, with
``refine="unconstrained"``, in both kernel modes; and the partition CLI
with ``--devices 2 --device cpu`` (two gloo ranks) against the reference
CLI with ``--devices 2``. Assignments, cuts, summaries and traces
(timings left out) must be the reference's bit for bit. The reference's
cuts: 321 (P=1), 320 / 323 / 293 (P=2: default, sharded, unconstrained),
373 / 317 / 301 (P=4 grid).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import child_env, one_thread  # noqa: F401

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GRAPH = ["rgg2d", 1500, 8.0, 3]
SHARDED = dict(contraction="sharded", balance="dist", weights="owner")
CASES = [(1, "dist", "default", {}), (2, "dist", "default", {}),
         (2, "dist", "sharded", SHARDED),
         (2, "dist", "unconstrained", dict(refine="unconstrained")),
         (4, "dist-grid", "default", {}),
         (4, "dist-grid", "sharded", SHARDED),
         (4, "dist-grid", "unconstrained", dict(refine="unconstrained"))]
CUTS = {(1, "default"): 321, (2, "default"): 320, (2, "sharded"): 323,
        (2, "unconstrained"): 293, (4, "default"): 373, (4, "sharded"): 317,
        (4, "unconstrained"): 301}


def _jobs():
    jobs = [dict(id=f"P{P}-{name}-{kernel}", kind="backend", P=P,
                 graph=GRAPH, k=8, backend=backend, kernel=kernel,
                 config=dict(contraction_limit=32), request=req)
            for P, backend, name, req in CASES
            for kernel in ("composed", "fused")]
    for P, grid in ((2, False), (4, True)):
        for kernel in ("composed", "fused"):
            jobs.append(dict(id=f"impl-P{P}-{kernel}", kind="impl", P=P,
                             graph=GRAPH, k=8, use_grid=grid, kernel=kernel,
                             config=dict(contraction_limit=32, **SHARDED)))
    return jobs


JOBS = _jobs()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return torch_dist_jobs.run_both(JOBS, str(tmp_path_factory.mktemp("dg")))


@pytest.mark.parametrize("jid", [j["id"] for j in JOBS])
def test_matches_the_reference(results, jid):
    ref, port = results
    want, got = ref[jid], port[jid]
    assert np.array_equal(got["part"], want["part"])
    assert got["trace"] == want["trace"]
    if "summary" in want:
        assert got["cut"] == want["cut"]
        assert got["summary"] == want["summary"]
    assert port[jid + ":same_on_every_rank"]


@pytest.mark.parametrize("case", sorted(CUTS))
def test_cuts_are_the_known_ones(results, case):
    _, port = results
    P, name = case
    for kernel in ("composed", "fused"):
        assert port[f"P{P}-{name}-{kernel}"]["cut"] == CUTS[case]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("time_s", "exchange_s")}


def test_cli_devices_2_matches_the_reference_cli():
    flags = ["--family", "rgg2d", "--n", "4200", "--k", "4", "--devices",
             "2", "--trace"]
    env = child_env(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                    CUDA_VISIBLE_DEVICES="")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_jobs.py"),
         "refcli", *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.partition", *flags,
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    r_out, r_err = ref.communicate(timeout=300)
    p_out, p_err = port.communicate(timeout=300)
    assert ref.returncode == 0, r_err[-3000:]
    assert port.returncode == 0, p_err[-3000:]
    want = [_strip(json.loads(x)) for x in r_out.splitlines()]
    got = [_strip(json.loads(x)) for x in p_out.splitlines()]
    assert got == want
    assert got[0]["backend"] == "dist" and got[0]["devices"] == 2
    assert any(r.get("phase") == "dist-uncoarsen" for r in got)
