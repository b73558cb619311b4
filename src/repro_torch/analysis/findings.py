"""Finding + report plumbing shared by the ``repro_torch.analysis``
passes.

A :class:`Finding` is one verifier hit: a rule id, a human message and
a source anchor (repo-relative file, line, enclosing function). Passes
append findings to a :class:`Report`; the reviewed suppression file
(``analysis/allowlist.toml``) downgrades known-and-reasoned sites to
"suppressed" so ``python -m repro_torch.analysis`` exits 0 on a clean
tree and nonzero the moment a new unreviewed site appears.

The text and JSON renderings are the JAX package's, line for line. The
suppression tables differ: ``check_rep`` has no counterpart (there is
no replication checker to switch off in ``torch.distributed``, see
``collectives_pass``) and ``limits`` (the launch-limit rules of
``limits``) is new.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import tomllib

def _repo_root() -> str:
    here = os.path.abspath(__file__)  # <repo>/src/repro_torch/analysis/..
    for _ in range(4):
        here = os.path.dirname(here)
    return here


REPO_ROOT = _repo_root()
ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__), "allowlist.toml")

# allowlist table names -> the finding rules they may suppress
ALLOWLIST_KINDS = {
    "overflow": ("OFL001",),
    "lint": ("LNT001", "LNT002", "LNT003"),
    "limits": ("LIM001", "LIM002", "LIM003"),
}


def rel_to_repo(path: str) -> str:
    """Repo-relative form of ``path`` (stable suppression keys)."""
    apath = os.path.abspath(path)
    root = REPO_ROOT + os.sep
    if apath.startswith(root):
        return apath[len(root) :].replace(os.sep, "/")
    return path.replace(os.sep, "/")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier hit, anchored to source."""

    rule: str  # e.g. "SPMD001"
    pass_name: str  # "collectives" | "overflow" | "limits" | "lint"
    message: str
    file: str = ""  # repo-relative path ("" = synthetic site)
    line: int = 0
    function: str = ""
    entry: str = ""  # taped entry point that reached the site

    def anchor(self) -> str:
        where = f"{self.file}:{self.line}" if self.file else "<static>"
        if self.function:
            where += f" ({self.function})"
        return where

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    kind: str
    file: str
    reason: str
    function: str = ""  # "" = whole file

    def matches(self, finding: Finding) -> bool:
        if finding.rule not in ALLOWLIST_KINDS.get(self.kind, ()):
            return False
        if self.file != finding.file:
            return False
        return self.function in ("", finding.function)


class Allowlist:
    """Reviewed suppressions; every entry carries a reason string."""

    def __init__(self, entries: List[AllowEntry]):
        self.entries = entries
        self.used: set = set()

    @classmethod
    def load(cls, path: str = ALLOWLIST_PATH) -> "Allowlist":
        if not os.path.exists(path):
            return cls([])
        with open(path, "rb") as f:
            data = tomllib.load(f)
        entries: List[AllowEntry] = []
        for kind, rows in data.items():
            if kind not in ALLOWLIST_KINDS:
                raise ValueError(
                    f"allowlist: unknown table [[{kind}]] "
                    f"(expected one of {sorted(ALLOWLIST_KINDS)})"
                )
            for row in rows:
                reason = str(row.get("reason", "")).strip()
                if not reason:
                    raise ValueError(
                        f"allowlist: [[{kind}]] entry for "
                        f"{row.get('file')!r} has no reason string — "
                        "every suppression must be justified"
                    )
                entries.append(
                    AllowEntry(
                        kind=kind,
                        file=str(row.get("file", "")),
                        function=str(row.get("function", "")),
                        reason=reason,
                    )
                )
        return cls(entries)

    def suppresses(self, finding: Finding) -> Optional[AllowEntry]:
        for i, entry in enumerate(self.entries):
            if entry.matches(finding):
                self.used.add(i)
                return entry
        return None

    def unused(self) -> List[AllowEntry]:
        return [
            e for i, e in enumerate(self.entries) if i not in self.used
        ]


class Report:
    """Collects findings across passes; renders text and JSON."""

    def __init__(self, allowlist: Optional[Allowlist] = None):
        self.allowlist = allowlist or Allowlist([])
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.notes: List[str] = []

    def add(self, finding: Finding) -> None:
        if self.allowlist.suppresses(finding):
            self.suppressed.append(finding)
        else:
            self.findings.append(finding)

    def note(self, message: str) -> None:
        self.notes.append(message)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "notes": list(self.notes),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def to_text(self) -> str:
        lines: List[str] = []
        for f in self.findings:
            lines.append(
                f"[{f.pass_name}:{f.rule}] {f.anchor()}: {f.message}"
            )
        sites: Dict[str, int] = {}
        for f in self.suppressed:
            key = f"[{f.pass_name}:{f.rule}:allowed] {f.file} " + (
                f.function or "(file-wide)"
            )
            sites[key] = sites.get(key, 0) + 1
        for key, count in sites.items():
            lines.append(f"{key} x{count}")
        for n in self.notes:
            lines.append(f"[note] {n}")
        for e in self.allowlist.unused():
            lines.append(
                f"[note] allowlist entry unused: [[{e.kind}]] "
                f"{e.file} {e.function or '(file-wide)'}"
            )
        verdict = "clean" if self.ok else "FAILING"
        lines.append(
            f"[analysis] {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed — {verdict}"
        )
        return "\n".join(lines)
