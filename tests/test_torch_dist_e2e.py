"""The port's distributed partitioner end to end against the JAX
reference's, run live: the facade's ``dist`` backend on rgg2d n=4000
(seed 17, k=16, C=64) at P = 1 and 2, in both memory models (host
contraction / host balance / replicated tables, and sharded contraction /
distributed balance / owner tables), with ``refine="unconstrained"``, in
both kernel modes. The assignment, the cut, the summary and the trace
(timings left out) must be the reference's bit for bit, on every rank.
The reference's cuts on this input: 462 (P=1), 523 (P=2), 502 (P=2,
sharded/dist/owner), 450 (P=2, unconstrained).
"""
import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402

GRAPH = ["rgg2d", 4000, 8.0, 17]
SHARDED = dict(contraction="sharded", balance="dist", weights="owner")
CASES = [(1, "default", {}), (2, "default", {}), (2, "sharded", SHARDED),
         (2, "unconstrained", dict(refine="unconstrained"))]
CUTS = {(1, "default"): 462, (2, "default"): 523, (2, "sharded"): 502,
        (2, "unconstrained"): 450}


def _jobs():
    return [dict(id=f"P{P}-{name}-{kernel}", kind="backend", P=P,
                 graph=GRAPH, k=16, backend="dist", kernel=kernel,
                 config=dict(contraction_limit=64), request=req)
            for P, name, req in CASES for kernel in ("composed", "fused")]


JOBS = _jobs()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return torch_dist_jobs.run_both(JOBS, str(tmp_path_factory.mktemp("de")))


@pytest.mark.parametrize("jid", [j["id"] for j in JOBS])
def test_backend_matches_the_reference(results, jid):
    ref, port = results
    want, got = ref[jid], port[jid]
    assert np.array_equal(got["part"], want["part"])
    assert got["cut"] == want["cut"] and got["feasible"] == want["feasible"]
    assert got["summary"] == want["summary"]
    assert got["trace"] == want["trace"]
    assert port[jid + ":same_on_every_rank"]


@pytest.mark.parametrize("case", sorted(CUTS))
def test_cuts_are_the_known_ones(results, case):
    _, port = results
    P, name = case
    for kernel in ("composed", "fused"):
        assert port[f"P{P}-{name}-{kernel}"]["cut"] == CUTS[case]


def test_the_runs_have_distributed_levels(results):
    _, port = results
    for j in JOBS:
        phases = [r["phase"] for r in port[j["id"]]["trace"]]
        assert "dist-coarsen" in phases and "dist-uncoarsen" in phases
    sharded = port["P2-sharded-fused"]["trace"]
    assert all(r["payload_bytes"] > 0 for r in sharded
               if r["phase"] == "dist-coarsen")
