"""Launch-limit verifier for the CUDA kernels: the port's counterpart of
the JAX package's static VMEM estimator.

The TPU's VMEM gate has no counterpart here (``kernels/dispatch.py``):
the CUDA kernels tile across CTAs and raise outside their launch
limits. Three rules take VMEM001–003's places.

* ``LIM001`` — the static inventory of the device scratch that
  ``csrc/lp_move.cu`` and ``csrc/seg_merge.cu`` carve up (their layout
  comments: 256-byte aligned pieces, the constants read from the
  sources) differs by more than 5% from the built libraries' own
  ``lp_move_scratch_bytes`` / ``seg_merge_scratch_bytes`` somewhere on a
  grid of (S, R, labels, H, G, hubs) and L. It needs the libraries, so it
  runs on the card; on the CPU the report notes that it was not run.
  ``bal_round`` takes no scratch: its limits fall under LIM002.
* ``LIM002`` — a fit predicate on the ops side and a wrapper's launch
  check classify a boundary point differently (e.g. 2^31 - 1 against
  2^31). The ops side is the predicate the callers gate on where there
  is one (``seg_merge/ops.py::_fits``; ``lp_move.check_stack_limits``,
  which a solo call at S = 1 must agree with) and otherwise the envelope
  the kernel's C entry states (``int`` shapes below 2^31, the counts it
  needs at least one of, ``bsr_spmm.cu``'s 128-row Y tile). Every
  wrapper's check is a pure function of shapes (``check_launch``,
  ``_build.check_heavy``), so nothing is allocated.
* ``LIM003`` — a module holds a copy of a limit constant
  (``MAX_RECORDS``, ``I32_MAX``, ``MAX_STACK``, ``MAX_BS``,
  ``HOST_ELL_LIMIT_BYTES``) that differs from its source, in a Python
  module of the port or a CUDA source.
"""
from __future__ import annotations

import ast
import functools
import os
import re
from typing import Callable, Dict, List, Tuple

from .findings import REPO_ROOT, Finding, Report, rel_to_repo

Piece = Tuple[str, int]           # (name, bytes)

_CSRC = os.path.join(REPO_ROOT, "src", "repro_torch", "csrc")
_I32 = 2**31


# ---------------------------------------------------------------------------
# LIM001: static scratch inventories against the libraries
# ---------------------------------------------------------------------------

def _eval_c(expr: str, known: Dict[str, int]) -> int:
    """Value of a C integer constant expression over ``known`` names."""
    return _eval(ast.parse(expr.strip(), mode="eval").body, known)


def cu_constants(*files: str) -> Dict[str, int]:
    """``constexpr int`` constants and enumerators of ``csrc`` files, in
    order (later files see the earlier ones' names)."""
    known: Dict[str, int] = {}
    for name in files:
        with open(os.path.join(_CSRC, name), encoding="utf-8") as f:
            text = f.read()
        for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", text):
            known[m.group(1)] = _eval_c(m.group(2), known)
        for body in re.findall(r"enum\s*\{([^}]*)\}", text):
            for item in body.split(","):
                if "=" in item:
                    key, val = item.split("=")
                    known[key.strip()] = _eval_c(val, known)
    return known


def _aligned(pieces: List[Piece]) -> int:
    return sum((b + 255) // 256 * 256 for _, b in pieces)


def lp_move_inventory(S: int, R: int, num_labels: int, H: int, G: int,
                      hubs: int) -> List[Piece]:
    """The scratch pieces of ``lp_move`` (``lp_move.cu``, ``Scratch``)."""
    c = cu_constants("common.cuh", "lp_move.cu")
    r, nl = S * R, S * num_labels
    tiles = S * -(-R // c["TILE"])
    pieces = [("pmove", 4 * r), ("light", 4 * r), ("newcw", 4 * r),
              ("key0", 8 * r), ("row0", 4 * r), ("key1", 8 * r),
              ("row1", 4 * r)]
    # a walking hub range's partial winners: PMAX of 4 ints
    pieces.append(("part", 16 * c["PMAX"] * G))
    pieces += [("din", 4 * nl), ("dout", 4 * nl), ("movedin", 4 * nl),
               ("ctr", 4 * S * c["N_COUNTERS"]),
               ("hist", 4 * S * c["MAX_PASSES"] * c["RADIX"]),
               ("cstat", 8 * tiles)]
    if H:
        pieces.append(("heavy", 4 * r))          # one flag a row
    # hub tables: 2 HUB_RANGE slots of 4 ints a hub range; two tickets a
    # hub row and the role ticket
    pieces += [("tab", 32 * c["HUB_RANGE"] * G),
               ("ticket", 4 * (2 * hubs + 1) if hubs else 0)]
    return pieces


def seg_merge_inventory(L: int) -> List[Piece]:
    """The scratch pieces of ``seg_merge`` (``seg_merge.cu``)."""
    c = cu_constants("common.cuh", "seg_merge.cu")
    tiles = -(-L // c["TILE_KEYS"])
    return [("key0", 8 * L), ("val0", 4 * L), ("key1", 8 * L),
            ("val1", 4 * L), ("ctr", 4 * c["N_COUNTERS"]),
            ("hist", 4 * c["MAX_PASSES"] * c["RADIX"]),
            ("st", 8 * tiles * c["RADIX"]), ("run_sum", 4 * L)]


def _grids() -> Dict[str, List[dict]]:
    lp: List[dict] = []
    for S in (1, 4, 64):
        for R in (1, 67, 4096, 262144):
            for labels in (2, 4097, 1 << 20):
                heavy = ((0, 0, 0), (3, 0, 0), (3, 2, 1)) if S == 1 \
                    else ((0, 0, 0),)
                for H, G, hubs in heavy:
                    lp.append(dict(S=S, R=R, num_labels=labels, H=H, G=G,
                                   hubs=hubs))
    seg = [dict(L=L) for L in (1, 2, 100, 1024, 4095, 4096, 65536, 1 << 20,
                               (1 << 22) + 1)]
    return {"lp_move": lp, "seg_merge": seg}


def static_bytes(kernel: str, point: dict) -> int:
    inventory = {"lp_move": lp_move_inventory,
                 "seg_merge": seg_merge_inventory}[kernel]
    return _aligned(inventory(**point))


def library_bytes(kernel: str, point: dict) -> int:
    """The built library's own count (builds it at first use)."""
    if kernel == "lp_move":
        from ..kernels.lp_move.lp_move import _scratch_bytes
        return _scratch_bytes(point["S"], point["R"], point["num_labels"],
                              point["H"], point["G"], point["hubs"])
    from ..kernels.seg_merge.seg_merge import _scratch_bytes
    return _scratch_bytes(point["L"])


def check_inventories(report: Report,
                      static_fn: Callable[[str, dict], int] = static_bytes,
                      tolerance: float = 0.05) -> int:
    """LIM001 over the grid; returns the points checked."""
    checked = 0
    for kernel, grid in _grids().items():
        for point in grid:
            checked += 1
            static = static_fn(kernel, point)
            lib = library_bytes(kernel, point)
            gap = abs(static - lib) / max(1, lib)
            if gap > tolerance:
                report.add(Finding(
                    rule="LIM001", pass_name="limits",
                    message=(f"{kernel}{point}: static inventory {static}B "
                             f"vs the library's {lib}B ({gap:.1%} > "
                             f"{tolerance:.0%})"),
                    function=kernel))
    return checked


# ---------------------------------------------------------------------------
# LIM002: fit predicates against the wrappers' launch checks
# ---------------------------------------------------------------------------

def _accepts(check: Callable, *shape) -> bool:
    try:
        check(*shape)
    except ValueError:
        return False
    return True


def _around(*limits: int) -> Tuple[int, ...]:
    return tuple(sorted({x + d for x in limits for d in (-1, 0, 1)
                         if x + d >= 0}))


def boundary_cases() -> List[tuple]:
    """``(kernel, ops side, ops predicate, wrapper check, points)``: the
    predicate says whether a shape fits; the check raises ValueError if
    the wrapper refuses it."""
    from ..kernels import _build
    from ..kernels.bal_round import bal_round
    from ..kernels.bsr_spmm import bsr_spmm
    from ..kernels.embedding_bag import embedding_bag
    from ..kernels.lp_gain import lp_gain
    from ..kernels.lp_move import lp_move
    from ..kernels.seg_merge import ops as seg_ops
    from ..kernels.seg_merge import seg_merge

    tm = cu_constants("bsr_spmm.cu")["TM"]     # rows of bsr_spmm's Y tile
    edge = _around(1, _I32 - 1)
    return [
        ("seg_merge", "seg_merge/ops.py::_fits",
         lambda L: seg_ops._fits(L, 0, 0),
         seg_merge.check_launch, [(L,) for L in edge]),
        ("lp_move", "lp_move.py::check_stack_limits at S = 1",
         lambda R, D, N: _accepts(lp_move.check_stack_limits, 1, R, N, D),
         lp_move.check_launch,
         [(x, 1, 1) for x in edge] + [(1, x, 1) for x in edge]
         + [(1, 1, x) for x in edge]),
        ("lp_move/bal_scores heavy rows", "int32 heavy-table slots",
         lambda H, D, M: 2 * (H * D + M) < _I32,
         functools.partial(_build.check_heavy, "heavy"),
         [(1, 1, m) for m in _around(_I32 // 2 - 1)]),
        ("bal_scores", "C entry: 1 <= R < 2^31, D, K >= 1",
         lambda R, D, K: 1 <= R < _I32 and D >= 1 and K >= 1,
         bal_round.check_launch,
         [(x, 1, 1) for x in edge] + [(1, x, 1) for x in _around(1)]
         + [(1, 1, x) for x in _around(1)]),
        ("lp_gain", "C entry: N < 2^31, D >= 1",
         lambda N, D: N < _I32 and D >= 1, lp_gain.check_launch,
         [(x, 1) for x in edge] + [(1, x) for x in _around(1)]),
        ("bsr_spmm", f"C entry: 1 <= BS <= {tm} (the Y tile), rows < 2^31",
         lambda bs, rows: 1 <= bs <= tm and rows < _I32,
         bsr_spmm.check_launch,
         [(x, 1) for x in _around(1, tm)] + [(1, x) for x in edge]),
        ("embedding_bag", "C entry: B, D, V < 2^31",
         lambda B, D, V: max(B, D, V) < _I32, embedding_bag.check_launch,
         [(x, 1, 1) for x in edge] + [(1, x, 1) for x in edge]
         + [(1, 1, x) for x in edge]),
    ]


def check_boundaries(report: Report, cases=None) -> int:
    """LIM002 over every wrapper; returns the points checked."""
    checked = 0
    for kernel, ops_side, fits, check, points in cases or boundary_cases():
        for point in points:
            checked += 1
            want, got = bool(fits(*point)), _accepts(check, *point)
            if want != got:
                fn = getattr(check, "func", check)      # a partial's
                report.add(Finding(
                    rule="LIM002", pass_name="limits",
                    message=(f"{kernel} at {point}: {ops_side} says "
                             f"{'fits' if want else 'does not fit'}, the "
                             f"launch check {'accepts' if got else 'refuses'}"),
                    file=rel_to_repo(fn.__code__.co_filename),
                    line=fn.__code__.co_firstlineno,
                    function=fn.__name__))
    return checked


# ---------------------------------------------------------------------------
# LIM003: copies of limit constants
# ---------------------------------------------------------------------------

# constant -> (source module, its value there); a copy anywhere else in
# the port, by name or by the CUDA names below, must equal it
def limit_sources() -> Dict[str, Tuple[str, int]]:
    from ..kernels import dispatch
    from ..kernels.bsr_spmm import bsr_spmm
    from ..kernels.lp_move import lp_move
    from ..kernels.seg_merge import seg_merge
    return {"MAX_RECORDS": (seg_merge.__name__, seg_merge.MAX_RECORDS),
            "I32_MAX": ("int32", _I32 - 1),
            "MAX_STACK": (lp_move.__name__, lp_move.MAX_STACK),
            "MAX_BS": (bsr_spmm.__name__, bsr_spmm.MAX_BS),
            "HOST_ELL_LIMIT_BYTES": (dispatch.__name__,
                                     dispatch.HOST_ELL_LIMIT_BYTES)}


# the CUDA sources' names for a limit
_CUDA_NAMES = {"I32_MAX": "I32_MAX", "TM": "MAX_BS"}


def _eval(node: ast.AST, known: Dict[str, int]) -> int:
    """A constant integer expression: numbers, + - * // << >> **, names
    in ``known`` and ``np.iinfo(np.int32).max`` (``int(...)`` taken)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name) and node.id in known:
        return known[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval(node.operand, known)
    if isinstance(node, ast.BinOp):
        a, b = _eval(node.left, known), _eval(node.right, known)
        ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b,
               ast.FloorDiv: a // b if b else 0, ast.LShift: a << b,
               ast.RShift: a >> b, ast.Pow: a ** b}
        if type(node.op) in ops:
            return ops[type(node.op)]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id == "int" and len(node.args) == 1:
        return _eval(node.args[0], known)
    text = ast.unparse(node)
    if text in ("np.iinfo(np.int32).max", "numpy.iinfo(numpy.int32).max"):
        return _I32 - 1
    raise ValueError(f"not a constant integer expression: {text}")


def constant_copies(files=None) -> List[Tuple[str, str, int, int]]:
    """``(name, file, line, value)`` of every module-level definition of
    a limit constant in the port's Python files and CUDA sources."""
    from .lint import repo_files
    names = set(limit_sources())
    out = []
    for path in files if files is not None else repo_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in tree.body:
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in names:
                    try:
                        val = _eval(node.value, {})
                    except ValueError:
                        continue
                    out.append((t.id, rel_to_repo(path), node.lineno, val))
    for cu in sorted(os.listdir(_CSRC)):
        path = os.path.join(_CSRC, cu)
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                m = re.match(r"\s*(?:#define\s+(\w+)\s+(.+)|"
                             r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);)",
                             line)
                if not m:
                    continue
                name = m.group(1) or m.group(3)
                expr = (m.group(2) or m.group(4)).split("//")[0]
                if name in _CUDA_NAMES:
                    try:
                        val = _eval_c(expr, {})
                    except (ValueError, SyntaxError):
                        continue
                    out.append((_CUDA_NAMES[name], rel_to_repo(path), i,
                                val))
    return out


def check_constants(report: Report, files=None) -> int:
    """LIM003; returns the copies checked."""
    sources = limit_sources()
    copies = constant_copies(files)
    for name, file, line, val in copies:
        src, want = sources[name]
        if val != want:
            report.add(Finding(
                rule="LIM003", pass_name="limits",
                message=(f"{name} = {val} here, {want} in its source "
                         f"{src}"),
                file=file, line=line))
    return len(copies)


def run(report: Report, device=None, static_fn=static_bytes,
        cases=None) -> Tuple[int, int]:
    """All three rules; LIM001 only on a CUDA ``device``. Returns the
    LIM001 grid points and the LIM002 boundary points checked."""
    import torch
    grid = 0
    if device is not None and torch.device(device).type == "cuda":
        grid = check_inventories(report, static_fn)
    else:
        report.note("limits: LIM001 (scratch inventories against the "
                    "built libraries) not run: the caller asked for the "
                    "CPU")
    boundary = check_boundaries(report, cases)
    check_constants(report)
    return grid, boundary
