"""The port's verifier (``repro_torch.analysis``) on its own, on the CPU.

The repo run at P = 2 (the ``dist_*`` entries on two gloo ranks) is
clean with every allowlist entry used; its OFL001 sites are the
counterparts of the JAX package's ``[[overflow]]`` entries (read from
that package's ``allowlist.toml``, a data file), each reference entry
without a counterpart listed with its reason; every fixture fires, the
collective one at two ranks without hanging; the tape follows taint
through views and writes in place; SPMD001 flags a collective outside
the entry's groups; LIM002 / LIM003 hold over every kernel wrapper; and
the CLI refuses to run without a card unless ``--device cpu`` is given.
The ``gpu`` test holds LIM001 to the built libraries on the card.
"""
import json
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (collectives_pass, entrypoints,  # noqa: E402
                                  limits, overflow_pass, tracing)
from repro_torch.analysis import findings as port_findings  # noqa: E402
from repro_torch.analysis.__main__ import _repo, _run_fixture  # noqa: E402
from repro_torch.analysis.fixtures import fixture_limits  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = "tests/test_torch_analysis_port.py"
REF_ALLOWLIST = ROOT / "src" / "repro" / "analysis" / "allowlist.toml"
CPU = torch.device("cpu")


def rules(report):
    return [f.rule for f in report.findings]


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------------
# the repo at P = 2 on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repo_report():
    report = port_findings.Report(port_findings.Allowlist.load())
    _repo(2, [CPU, CPU], CPU, report)
    return report


def test_repo_is_clean_and_every_allowlist_entry_is_used(repo_report):
    assert repo_report.ok, repo_report.to_text()
    assert repo_report.allowlist.unused() == []
    assert any(n.startswith("traced 19 entries") for n in repo_report.notes)
    assert any("LIM001" in n and "not run" in n for n in repo_report.notes)


# the port's OFL001 sites -> the reference's [[overflow]] entry each is
# the counterpart of ("repro_torch" read as "repro")
COUNTERPARTS = {
    ("dist/dist_lp.py", "_local_moves"): ("dist/dist_lp.py", "_local_moves"),
    ("dist/dist_lp.py", "_penalized_moves"):
        ("dist/dist_lp.py", "_penalized_moves"),
    ("dist/dist_lp.py", "_intra_pe_revert"):
        ("dist/dist_lp.py", "_intra_pe_revert"),
    ("dist/dist_lp.py", "_bounce_back"): ("dist/dist_lp.py", "_bounce_back"),
    ("dist/dist_lp.py", "_bounce_back_owner"):
        ("dist/dist_lp.py", "_bounce_back_owner"),
    ("dist/dist_balance.py", "dist_enforce_cluster_weights"):
        ("dist/dist_balance.py", "per_pe"),       # _build_enforce_fn's body
    ("core/lp.py", "_cluster_chunk"): ("core/lp.py", "_cluster_chunk"),
    ("core/unconstrained.py", "_urefine_chunk"):
        ("core/unconstrained.py", "_urefine_chunk"),
    ("kernels/lp_move/ref.py", "move_targets_ref"):
        ("kernels/lp_move/lp_move.py", "phase_a"),
    ("kernels/lp_move/ref.py", "candidates_ref"):
        ("kernels/lp_move/lp_move.py", "phase_b1"),
    ("kernels/lp_move/ref.py", "lp_move_chunk_ref"):
        ("kernels/lp_move/lp_move.py", "phase_b2"),
}
# reference entries with no port site, and why
NO_COUNTERPART = {
    ("dist/dist_lp.py", "_apply_and_sync"):
        "the port's `cw + psum(...)` compares nothing; _bounce_back does",
    ("dist/dist_lp.py", "_commit_to_owners"):
        "the owner commit compares nothing; _bounce_back_owner does",
    ("dist/dist_lp.py", "_fused_chunk_move"):
        "its comparisons run in the kernel's plain version (ref.py)",
    ("dist/dist_lp.py", "chunk_body"):
        "no scan body: the chunk loop is host code comparing no sum",
    ("dist/dist_lp.py", "per_pe"):
        "no per-PE closure: the engine is SPMD host code",
    ("core/lp.py", "_argmax_target"):
        "the reference's taint comes from segment_sum's scatter-add "
        "combiner sub-jaxpr; the port's index_add_ is one op",
    ("core/lp.py", "_own_connection"):
        "the same segment_sum sub-jaxpr taint, absent in the port",
    ("core/balance.py", "balance_gains"):
        "the same segment_sum sub-jaxpr taint, absent in the port",
    ("core/balance.py", "body"):
        "the greedy walk is greedy_pick_ref's Python ints, no tape sees",
    ("core/balance.py", "balance_round"):
        "the block table comes fresh out of that walk: no sum compared",
    ("kernels/lp_move/ops.py", "_chunk_step"):
        "the port updates the table in place with index_add_",
}


def test_overflow_sites_are_the_reference_entries_counterparts(
        repo_report):
    with open(REF_ALLOWLIST, "rb") as f:
        ref_allow = tomllib.load(f)
    ref_sites = {(e["file"][len("src/repro/"):], e["function"])
                 for e in ref_allow["overflow"]}
    assert len(ref_sites) == 22
    port_sites = {(f.file[len("src/repro_torch/"):], f.function)
                  for f in repo_report.suppressed + repo_report.findings
                  if f.rule == "OFL001"}
    assert port_sites == set(COUNTERPARTS)
    assert {COUNTERPARTS[s] for s in port_sites} | set(NO_COUNTERPART) \
        == ref_sites
    assert not {COUNTERPARTS[s] for s in port_sites} & set(NO_COUNTERPART)


# ---------------------------------------------------------------------------
# every fixture fires
# ---------------------------------------------------------------------------

def test_collective_fixture_fires_at_two_ranks_without_hanging():
    out = _cli("repro_torch.analysis", "--device", "cpu", "--devices", "2",
               "--fixture", "collective", timeout=180)
    assert out.returncode == 1, out.stdout + out.stderr
    lines = [x for x in out.stdout.splitlines() if "SPMD002" in x]
    assert len(lines) == 2            # one anchor a rank
    assert "fixture_collective_mismatch.py:" in lines[0]
    assert "(mismatched)" in lines[0]
    assert "rank 0: psum" in lines[0] and "rank 1: the end" in lines[0]


@pytest.mark.parametrize("name,want", [
    ("overflow", ["OFL001"]),
    ("lint", ["LNT001", "LNT001", "LNT002", "LNT003"]),
    ("limits", ["LIM002"]),
])
def test_fixture_fires(name, want):
    report = port_findings.Report()
    _run_fixture(name, [CPU, CPU], CPU, report)
    assert sorted(rules(report)) == want
    if name == "overflow":
        (f,) = report.findings
        assert f.function == "admit" and "fixture_overflow" in f.file


def _raises_on_rank1(pe):
    from repro_torch.dist import collectives
    x = torch.zeros(2, dtype=torch.int32)
    if pe.rank == 1:
        raise ValueError("rank 1 broke")
    return collectives.psum(x, pe)


def _rank_job(pe):
    mod = sys.modules[__name__]
    spec = entrypoints.Spec("raises", mod, "_raises_on_rank1",
                            lambda: mod._raises_on_rank1(pe), True)
    return collectives_pass.run_on_rank(pe, [spec])


def test_an_entry_raising_on_one_rank_fails_every_rank_without_hanging():
    """Rank 0 waits at its psum's lockstep exchange; rank 1's exception
    meets it there, so rank 0 abandons the entry and every rank raises
    the same error once the entries are done: the mesh reports it."""
    from repro_torch.api.runtime import PeMesh
    with PeMesh([CPU, CPU]) as mesh:
        with pytest.raises(RuntimeError,
                           match="rank 1, raises: ValueError: rank 1 broke"):
            mesh.call(_rank_job)
        assert mesh.alive


def test_a_failed_run_is_not_a_fired_fixture(monkeypatch):
    from repro_torch.analysis import __main__ as cli

    def broken(*args):
        raise RuntimeError("a rank died")

    monkeypatch.setattr(cli, "_run_fixture", broken)
    assert cli.main(["--device", "cpu", "--fixture", "lint"]) == 3


def test_cli_needs_a_card_unless_the_cpu_is_asked_for():
    out = _cli("repro_torch.analysis", "--fixture", "lint")
    assert out.returncode == 2 and out.stdout == ""
    assert "--device cpu" in out.stderr


# ---------------------------------------------------------------------------
# the tape and the collective rules
# ---------------------------------------------------------------------------

def through_view(cw, vw):
    out = torch.zeros_like(cw)
    out[2:5] = (cw + vw)[2:5]           # a sum written through a view
    view = out.view(-1)                 # a view keeps its base's taint
    return view <= 7


def scatter_into(cw, vw, idx):
    out = torch.zeros_like(cw)
    out.index_add_(0, idx, cw + vw)     # transparent scatter, in place
    out.copy_(cw)                       # a whole overwrite clears it
    return out <= 7


@pytest.mark.parametrize("name,want", [("through_view", ["OFL001"]),
                                       ("scatter_into", [])])
def test_taint_follows_storage_through_views_and_writes(name, want):
    mod = sys.modules[__name__]
    cw = torch.arange(8, dtype=torch.int32)
    args = (cw, cw.clone()) + ((torch.arange(8),) if name == "scatter_into"
                               else ())
    tape = tracing.capture(mod, name, lambda: getattr(mod, name)(*args))
    report = port_findings.Report()
    overflow_pass.walk(tape.ops, name, report, set())
    assert rules(report) == want


def test_capture_names_a_stale_registry():
    mod = sys.modules[__name__]
    with pytest.raises(RuntimeError, match="tracing registry is out of "
                       "date"):
        tracing.capture(mod, "through_view", lambda: None)


def test_spmd001_flags_a_collective_outside_the_entry_groups():
    site = (HERE, 1, "f")
    run = entrypoints.EntryRun(
        "dist_x", (HERE, "f"), 0, [],
        [("psum", "pe", "torch.int32", 4, (0, 1), site),
         ("psum", "other", "torch.int32", 4, (0, 2), site)],
        [("allreduce_", site)], None)
    report = port_findings.Report()
    assert collectives_pass.run([run], report) == 2
    assert rules(report) == ["SPMD001", "SPMD001"]
    assert "[0, 2]" in report.findings[0].message
    assert "around dist/collectives.py" in report.findings[1].message


# ---------------------------------------------------------------------------
# LIM002 / LIM003 over every wrapper
# ---------------------------------------------------------------------------

def test_launch_checks_agree_with_the_fit_predicates():
    report = port_findings.Report()
    cases = limits.boundary_cases()
    assert {c[0] for c in cases} == {
        "seg_merge", "lp_move", "lp_move/bal_scores heavy rows",
        "bal_scores", "lp_gain", "bsr_spmm", "embedding_bag"}
    assert limits.check_boundaries(report, cases) > 60
    assert report.findings == []
    report = port_findings.Report()
    limits.check_boundaries(report, fixture_limits.cases())
    (f,) = report.findings
    assert f.rule == "LIM002" and "2147483647" in f.message
    assert f.file.endswith("seg_merge/seg_merge.py")
    assert f.function == "check_launch"


def test_limit_constants_agree_with_their_sources(tmp_path):
    report = port_findings.Report()
    assert limits.check_constants(report) >= 8
    assert report.findings == []
    names = {c[0] for c in limits.constant_copies()}
    assert names == set(limits.limit_sources())
    stale = tmp_path / "stale.py"
    stale.write_text("MAX_BS = 64\nMAX_RECORDS = 2**31 - 1\n"
                     "I32_MAX = int(np.iinfo(np.int32).max) - 1\n")
    report = port_findings.Report()
    limits.check_constants(report, files=[str(stale)])
    assert rules(report) == ["LIM003", "LIM003"]


def test_scratch_inventories_read_the_cuda_sources():
    c = limits.cu_constants("common.cuh", "seg_merge.cu")
    assert (c["TILE"], c["RADIX"], c["MAX_PASSES"]) == (1024, 256, 8)
    assert c["TILE_KEYS"] == 4 * c["TILE"] and c["N_COUNTERS"] == 9
    one = limits.static_bytes("seg_merge", {"L": 1})
    assert one % 256 == 0 and one > 0
    big = dict(S=1, R=4096, num_labels=4097, H=0, lanes=0)
    assert limits.static_bytes("lp_move", dict(big, H=3, lanes=692)) > \
        limits.static_bytes("lp_move", big)


@pytest.mark.gpu
def test_scratch_inventories_match_the_built_libraries():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: LIM001 reads the built libraries")
    report = port_findings.Report()
    assert limits.check_inventories(report) > 50
    assert report.findings == []
    report = port_findings.Report()
    limits.check_inventories(report, fixture_limits.static_bytes)
    assert "LIM001" in rules(report)


# ---------------------------------------------------------------------------
# the selftest, end to end
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_selftest_analysis_on_cpu_ranks():
    out = _cli("repro_torch.launch.selftest", "--devices", "2", "--device",
               "cpu", "--test", "analysis", timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [x["test"] for x in lines] == [
        "analysis.repo_clean", "analysis.fixture_collective_fires",
        "analysis.fixture_overflow_fires", "analysis.fixture_lint_fires",
        "analysis.fixture_limits_fires"]
    assert all(x["pass"] for x in lines)
