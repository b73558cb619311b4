"""The port's verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``) on the CPU.

The reference stages jaxprs; the port tapes runs (``tracing``). Held
equal: the report's text and JSON and the allowlist loader's errors;
the overflow pass's verdicts over pairs of small programs written in
jnp and in torch (the sum form, the guard form, an int64 widen, a sum
with a literal, a sum under ``cumsum``, a sum carried across loop
iterations — ``lax.scan`` against a Python loop — and a sum through
``where`` and a gather); the lint's rule counts over each package's own
fixture; the 19 entry names. The port alone is in
``test_torch_analysis_port.py``.

On jax 0.9.0 the reference finds no user frame, so its findings carry
empty anchors; the port's name the function (a ROADMAP queue 3 fault of
the reference, routed around here).
"""
import collections
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.analysis import entrypoints as ref_entrypoints  # noqa: E402
from repro.analysis import findings as ref_findings  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import overflow_pass as ref_overflow  # noqa: E402
from repro.analysis.fixtures import fixture_lint as ref_fixture  # noqa: E402
from repro_torch.analysis import (entrypoints, lint,  # noqa: E402
                                  overflow_pass, tracing)
from repro_torch.analysis import findings as port_findings  # noqa: E402
from repro_torch.analysis.fixtures import fixture_lint  # noqa: E402

HERE = "tests/test_torch_analysis.py"
CPU = torch.device("cpu")


def rules(report):
    return [f.rule for f in report.findings]


# ---------------------------------------------------------------------------
# the report and the allowlist loader
# ---------------------------------------------------------------------------

def _fill(pkg):
    allow = pkg.Allowlist([
        pkg.AllowEntry(kind="overflow", file="src/x.py", function="f",
                       reason="bounded"),
        pkg.AllowEntry(kind="lint", file="src/y.py", reason="reviewed")])
    report = pkg.Report(allow)
    for i, (rule, name, file, func) in enumerate((
            ("OFL001", "overflow", "src/x.py", "f"),
            ("OFL001", "overflow", "src/x.py", "f"),
            ("OFL001", "overflow", "src/z.py", "g"),
            ("LNT002", "lint", "", ""),
            ("LNT003", "lint", "src/w.py", "h"))):
        report.add(pkg.Finding(rule=rule, pass_name=name, message=f"m{i}",
                               file=file, line=i, function=func,
                               entry="e"))
    report.note("traced 2 entries")
    return report


def test_report_renders_as_the_reference_does():
    want, got = _fill(ref_findings), _fill(port_findings)
    assert got.to_text() == want.to_text()
    assert got.to_json() == want.to_json()
    assert got.ok is want.ok is False
    assert [f.anchor() for f in got.findings] == \
        [f.anchor() for f in want.findings]


@pytest.mark.parametrize("body,match", [
    ('[[overflow]]\nfile = "src/x.py"\n', "reason"),
    ('[[lint]]\nfile = "src/x.py"\nreason = "  "\n', "reason"),
    ('[[typo]]\nfile = "src/x.py"\nreason = "r"\n', "unknown table"),
])
def test_allowlist_loader_errors_match_the_reference(tmp_path, body, match):
    p = tmp_path / "allow.toml"
    p.write_text(body)
    with pytest.raises(ValueError) as want:
        ref_findings.Allowlist.load(str(p))
    with pytest.raises(ValueError, match=match) as got:
        port_findings.Allowlist.load(str(p))
    # the unknown-table message lists each package's own tables
    assert str(got.value).split(" (expected")[0] == \
        str(want.value).split(" (expected")[0]


def test_check_rep_table_has_no_counterpart(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[check_rep]]\nfile = "src/x.py"\nreason = "r"\n')
    with pytest.raises(ValueError, match="unknown table"):
        port_findings.Allowlist.load(str(p))
    assert "limits" in port_findings.ALLOWLIST_KINDS


def test_repo_allowlist_loads_and_every_entry_has_reason():
    allow = port_findings.Allowlist.load()
    assert allow.entries
    assert all(e.reason.strip() for e in allow.entries)
    assert all(e.file.startswith("src/repro_torch/") for e in allow.entries)


# ---------------------------------------------------------------------------
# overflow verdicts: one program in jnp and in torch
# ---------------------------------------------------------------------------

def _jnp_programs():
    def sum_form(cw, vw, lab, bud):
        return cw[lab] + vw <= bud

    def guard_form(cw, vw, lab, bud):
        return cw[lab] <= bud - vw

    def widened(cw, vw, lab, bud):
        return cw[lab].astype(jnp.int64) + vw.astype(jnp.int64) <= \
            bud.astype(jnp.int64)

    def literal_sum(cw, vw, lab, bud):
        return cw[lab] + 1 <= bud

    def under_cumsum(cw, vw, lab, bud):
        return jnp.cumsum(cw[lab] + vw) <= bud

    def carried(cw, vw, lab, bud):
        def body(c, x):
            return c + x, c <= bud
        return jax.lax.scan(body, jnp.zeros_like(vw), jnp.stack([vw] * 3))

    def through_gather(cw, vw, lab, bud):
        s = jnp.where(lab >= 0, cw + vw, 0)
        return s[lab] <= bud

    return dict(sum_form=sum_form, guard_form=guard_form, widened=widened,
                literal_sum=literal_sum, under_cumsum=under_cumsum,
                carried=carried, through_gather=through_gather)


def sum_form(cw, vw, lab, bud):
    return cw[lab] + vw <= bud


def guard_form(cw, vw, lab, bud):
    return cw[lab] <= bud - vw


def widened(cw, vw, lab, bud):
    return cw[lab].long() + vw.long() <= bud.long()


def literal_sum(cw, vw, lab, bud):
    return cw[lab] + 1 <= bud


def under_cumsum(cw, vw, lab, bud):
    return torch.cumsum(cw[lab] + vw, 0) <= bud


def carried(cw, vw, lab, bud):
    c, oks = torch.zeros_like(vw), []
    for _ in range(3):
        oks.append(c <= bud)
        c = c + vw
    return c, oks


def through_gather(cw, vw, lab, bud):
    s = torch.where(lab >= 0, cw + vw, 0)
    return s[lab.long()] <= bud


PROGRAMS = {"sum_form": ["OFL001"], "guard_form": [], "widened": [],
            "literal_sum": [], "under_cumsum": [], "carried": ["OFL001"],
            "through_gather": ["OFL001"]}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_overflow_verdicts_match_the_reference(name):
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 50, 8).astype(np.int32) for _ in range(2)] + \
        [rng.integers(0, 8, 8).astype(np.int32),
         np.full(8, 100, np.int32)]
    with jax.enable_x64(True):          # the widen must stay int64
        jaxpr = jax.make_jaxpr(_jnp_programs()[name])(
            *(jnp.asarray(a) for a in arrays))
    want = ref_findings.Report()
    ref_overflow.run([(name, jaxpr)], want)

    mod = sys.modules[__name__]
    args = [torch.from_numpy(a) for a in arrays]
    tape = tracing.capture(mod, name, lambda: getattr(mod, name)(*args))
    got = port_findings.Report()
    overflow_pass.run([entrypoints.EntryRun(name, ("", ""), -1, tape.ops,
                                            [], [], None)], got)
    assert rules(got) == rules(want) == PROGRAMS[name]
    for f in got.findings:
        assert (f.file, f.function) == (HERE, name)


# ---------------------------------------------------------------------------
# lint and the registry
# ---------------------------------------------------------------------------

def test_lint_fixture_counts_match_the_reference():
    want, got = ref_findings.Report(), port_findings.Report()
    ref_lint.check_file(ref_fixture.__file__, want, serve_hot=True)
    lint.check_file(fixture_lint.__file__, got, serve_hot=True)
    assert collections.Counter(rules(got)) == \
        collections.Counter(rules(want)) == \
        {"LNT001": 2, "LNT002": 1, "LNT003": 1}


def test_registry_has_the_reference_entries():
    want = [s[0] for s in ref_entrypoints.build_specs(2)]
    got = [s.name for s in entrypoints.build_specs(2, CPU)]
    assert got == want and len(got) == 19
    assert [s.dist for s in entrypoints.build_specs(2, CPU)] == \
        [n.startswith("dist_") for n in want]
