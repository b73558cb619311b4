"""Collective-consistency pass over the ``dist_*`` entries' runs.

The failure mode that matters at scale is a deadlock every PE sits in
silently. The port's collectives all go through ``dist/collectives.py``
(``all_to_all``, ``all_gather``, ``reduce_scatter``, ``psum``: the
reference's names), which calls ``collectives.OBSERVER`` before it
issues each one. While an entry runs on a rank, :class:`CollectiveLog`
is that observer: it records each call as (kind, group, dtype, numel,
call site) and checks it.

* ``SPMD001`` — a collective over a group that is neither the entry's
  ``PeGroup.group`` nor one of its ``grid()`` subgroups (the counterpart
  of a collective over an axis the ``shard_map`` mesh does not declare);
  also a c10d collective the tape saw that ``dist/collectives.py`` did
  not announce, which the lockstep check below cannot see.
* ``SPMD002`` — the ranks' collective sequences differ: a deadlock, or
  a silent mispairing of two different collectives. It is checked in
  lockstep: before each collective, and once at the end of the entry,
  the ranks exchange that collective's fingerprint (kind, the group's
  role, dtype, numel) over a side gloo group. A mismatch becomes a
  finding anchored at each rank's call site and every rank abandons the
  entry (raising :class:`CollectiveMismatch` before the collective is
  issued), so no rank is left hanging in it.

The reference checks every branch of a ``lax.cond`` statically, taken
or not. The port checks the paths the registry's inputs take: a branch
the run does not reach is not seen.

``SPMD003`` (a ``shard_map`` staged with ``check_rep=False`` and not
allowlisted) has no counterpart: ``torch.distributed`` has no
replication checker to turn off, and the allowlist loader rejects a
``[[check_rep]]`` table as unknown.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch.distributed as dist

from . import tracing
from .findings import Finding, Report

_COLLECTIVES_FILE = ("src/repro_torch/dist/collectives.py",)
_END = ("end of entry",)

_SIDE: list = []


class CollectiveMismatch(Exception):
    """The ranks' fingerprints disagreed; the entry is abandoned."""


def side_group():
    """A gloo group over every rank of the (one) default group, for the
    verifier's own exchanges: made once a rank process, by every rank at
    once (``new_group`` is collective)."""
    if not _SIDE:
        _SIDE.append(dist.new_group(backend="gloo"))
    return _SIDE[0]


def _role(group, pe) -> str:
    if group is pe.group:
        return "pe"
    grid = pe._grid
    if grid is not None and group is not None:
        if group is grid[2]:
            return "grid-row"
        if group is grid[3]:
            return "grid-col"
    return "other"


class CollectiveLog:
    """The collective observer of one entry's run on one rank (a context
    manager around the callee, inside its tape)."""

    def __init__(self, pe, side, tape: tracing.Tape):
        self.pe, self.side, self.tape = pe, side, tape
        self.records: List[tuple] = []
        self.exchanges = 0
        self.mismatch: Optional[tuple] = None

    def __enter__(self) -> "CollectiveLog":
        from ..dist import collectives
        collectives.OBSERVER = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        from ..dist import collectives
        collectives.OBSERVER = None
        if exc_type is None:
            self._lockstep(_END, tracing.NO_SITE)
        elif not issubclass(exc_type, CollectiveMismatch):
            # let the peers leave their next exchange instead of waiting
            try:
                self._lockstep(("raised", exc_type.__name__),
                               tracing.NO_SITE)
            except CollectiveMismatch:
                pass
        return False

    def __call__(self, kind: str, x, group, pe) -> None:
        site = tracing.user_site(skip=_COLLECTIVES_FILE)
        role = _role(group, pe)
        ranks = tuple(dist.get_process_group_ranks(group)) \
            if group is not None else tuple(range(dist.get_world_size()))
        fp = (kind, role, str(x.dtype), int(x.numel()))
        self.records.append(fp + (ranks, site))
        self._lockstep(fp, site)
        self.tape.announce()

    def _lockstep(self, fp: tuple, site: tracing.Site) -> None:
        every: List[Any] = [None] * self.pe.P
        self.exchanges += 1
        with self.tape.paused():
            dist.all_gather_object(every, (fp, site), group=self.side)
        if len({e[0] for e in every}) > 1:
            self.mismatch = (self.exchanges, every)
            raise CollectiveMismatch(f"collective #{self.exchanges}")


def run_on_rank(pe, specs) -> list:
    """Tape each spec on this rank under a collective log; gather every
    rank's runs over the side group, so every rank returns the same list
    (in rank order). An entry that raised on some rank raises on every
    rank once all entries are done: the ranks stay in step until then."""
    from .entrypoints import EntryRun
    side = side_group()
    runs, errors = [], []
    for spec in specs:
        tape = tracing.Tape()
        log = CollectiveLog(pe, side, tape)
        try:
            tracing.capture(spec.module, spec.attr, spec.invoke, tape=tape,
                            scope=log)
        except CollectiveMismatch:
            pass
        except Exception as exc:
            errors.append(f"rank {pe.rank}, {spec.name}: "
                          f"{type(exc).__name__}: {exc}")
        runs.append(EntryRun(spec.name, spec.site, pe.rank, tape.ops,
                             log.records, tape.unlogged, log.mismatch))
    every: List[Any] = [None] * pe.P
    dist.all_gather_object(every, (runs, errors), group=side)
    failed = [e for _, errs in every for e in errs]
    if failed:
        raise RuntimeError("analysis: an entry raised: " + "; ".join(failed))
    return [r for rank_runs, _ in every for r in rank_runs]


def _describe(fp: tuple) -> str:
    if fp == _END:
        return "the end of the entry"
    if fp[0] == "raised":
        return f"an exception ({fp[1]})"
    kind, role, dtype, numel = fp
    return f"{kind} over the {role} group ({dtype}[{numel}])"


def run(runs: List[Any], report: Report) -> int:
    """Check every rank's collective log; returns collectives logged."""
    logged = 0
    seen = set()
    for run in runs:
        logged += len(run.collectives)
        for kind, role, dtype, numel, ranks, site in run.collectives:
            if role == "other":
                _add(report, seen, "SPMD001", site, run,
                     f"{kind} over a group of ranks {list(ranks)} that is "
                     "neither the entry's PeGroup nor one of its grid "
                     "subgroups")
        for name, site in run.unlogged:
            _add(report, seen, "SPMD001", site, run,
                 f"c10d {name} issued around dist/collectives.py: the "
                 "lockstep check cannot see it")
        if run.mismatch is not None:
            index, every = run.mismatch
            fp, site = every[run.rank]
            if site == tracing.NO_SITE:
                site = (run.site[0], 0, run.site[1])
            others = "; ".join(f"rank {r}: {_describe(e[0])}"
                               for r, e in enumerate(every))
            _add(report, seen, "SPMD002", site, run,
                 f"ranks diverge at collective #{index} ({others}) — "
                 "SPMD deadlock or mispairing")
    return logged


def _add(report: Report, seen: set, rule: str, site: tuple, run,
         message: str) -> None:
    finding = Finding(rule=rule, pass_name="collectives", message=message,
                      file=site[0], line=site[1], function=site[2],
                      entry=run.name)
    if finding not in seen:
        seen.add(finding)
        report.add(finding)
