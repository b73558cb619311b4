"""Int32 overflow dataflow pass over the entries' tapes.

The failure mode: weight arithmetic is int32 on purpose — device tables
stay compact — and the contract is that *totals* are range-checked up
front (``_check_int32_weights``, ``build_chunks``) while
*per-comparison* arithmetic must be arranged so it cannot wrap. The
sanctioned guard is the subtraction form ``w <= budget - c``; the bug
shape is the sum form ``w + c <= budget``, where ``w + c`` can exceed
2^31 - 1 and wrap negative, silently admitting an overweight move.

The reference's rules, one for one, over aten ops (``OFL001``):

* fresh taint: an ``add`` / ``mul`` (or ``add_`` / ``mul_``) of two
  non-literal operands whose result is ``torch.int32``;
* taint passes through ``sub`` (and ``rsub``) and through an add/mul
  with a literal;
* flag: ``lt`` / ``le`` / ``gt`` / ``ge`` (``.Tensor`` and ``.Scalar``
  forms) with a tainted operand;
* bounded (the totals the up-front checks bound): ``sum``, ``cumsum``,
  the ``amax`` / ``amin`` / ``max`` / ``min`` reductions, ``argmax`` /
  ``argmin``, ``arange``, ``psum`` and ``reduce_scatter``;
* transparent: ``where``, ``clamp``, ``maximum`` / ``minimum``, ``neg``,
  ``abs``, indexing and gathers, views and reshapes, ``cat`` / ``stack``,
  ``_to_copy`` / ``to``, ``sort``, ``remainder``, copies, the
  scatter-type ops (``index_put``, ``index_add``, ``scatter_add``,
  ``scatter_reduce``; the port's ``segment_sum`` is an ``index_add_``
  where the reference's lowers to a scatter-add) and ``all_to_all`` /
  ``all_gather``;
* anything else drops taint (hash mixers, bit ops, ``eq``, ...).

A write in place sets the taint of the tensor it writes: the whole
storage's when it writes all of it, else in addition to what the
storage held. A result that aliases an operand (a view) keeps its
storage's taint. uint32 has no place here: the port's hash arithmetic
runs in int64 (``core/lp.py::hash32``), so it never taints.

A loop unrolls in the tape, so a sum formed in iteration i meets the
comparison of iteration i + 1 as it does at run time (the reference
walks a scan body twice for that). Findings are reported once a source
site and entry. Bounded sites are suppressed by ``[[overflow]]``
allowlist entries keyed on (file, function), each with the reason the
bound holds.
"""
from __future__ import annotations

from typing import Any, List

from .findings import Finding, Report

_SUM = {"add", "mul", "add_", "mul_"}
_PASS = {"sub", "sub_", "rsub"}
_CMP = {"lt", "le", "gt", "ge", "lt_", "le_", "gt_", "ge_"}
_TRANSPARENT = {
    "where", "clamp", "clamp_", "clamp_min", "clamp_max", "maximum",
    "minimum", "neg", "abs", "index", "index_select", "gather", "take",
    "masked_select", "masked_fill", "masked_fill_", "repeat_interleave",
    "view", "_unsafe_view", "reshape", "select", "slice", "squeeze",
    "unsqueeze", "expand", "permute", "transpose", "t", "flatten",
    "alias", "as_strided", "unbind", "split", "split_with_sizes", "narrow",
    "diagonal", "unfold", "cat", "stack", "_to_copy", "to", "clone",
    "contiguous", "copy", "detach", "sort", "remainder", "flip",
    "roll", "repeat", "constant_pad_nd", "index_put", "index_put_",
    "index_add", "index_add_", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_copy",
    "index_copy_", "all_to_all", "all_gather"}


class _Taint:
    def __init__(self) -> None:
        self.summed: set = set()

    def get(self, key) -> bool:
        return key is not None and key in self.summed

    def put(self, key, val: bool) -> None:
        if val:
            self.summed.add(key)
        else:
            self.summed.discard(key)


def _flag(op, ops: List[bool]) -> bool:
    """The taint of ``op``'s result, from its operands' taint."""
    name = op.name
    if name == "copy_":           # (self, src): the source's values only
        return len(ops) > 1 and ops[1]
    if name in _SUM:
        lhs = op.operands[:2]
        fresh = op.dtype == "torch.int32" and len(lhs) == 2 and \
            None not in lhs
        return fresh or any(ops)
    if name in _PASS or name in _TRANSPARENT:
        return any(ops)
    return False          # bounded (sum, cumsum, psum, ...) or dropped


def walk(ops, entry: str, report: Report, seen: set) -> None:
    """Propagate taint through one tape; flag comparisons of sums."""
    taint = _Taint()
    for op in ops:
        flags = [taint.get(k) for k in op.operands]
        if op.name in _CMP and any(flags):
            file, line, func = op.site
            finding = Finding(
                rule="OFL001", pass_name="overflow",
                message=(f"{op.name} compares an int32 sum that can wrap "
                         "— use the guard form `w <= budget - c` or "
                         "widen to int64 before adding"),
                file=file, line=line, function=func, entry=entry)
            if finding not in seen:
                seen.add(finding)
                report.add(finding)
            continue
        val = _flag(op, flags)
        ins = set(op.operands)
        written = {k for k, _ in op.written}
        for key in op.outs:
            if key not in ins and key not in written:
                taint.put(key, val)
        for key, whole in op.written:
            taint.put(key, val if whole else (val or taint.get(key)))


def run(runs: List[Any], report: Report) -> int:
    """Run the overflow pass on every entry's tape; returns ops seen."""
    seen: set = set()
    taped = 0
    for run in runs:
        walk(run.ops, run.name, report, seen)
        taped += len(run.ops)
    return taped
