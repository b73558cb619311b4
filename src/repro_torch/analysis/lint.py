"""AST lint for repo rules ruff cannot express, over ``src/repro_torch``.

* ``LNT001`` — global-state RNG: ``np.random.<fn>`` other than the
  explicit-generator constructors (``default_rng``, ``Generator``,
  ``SeedSequence``, the bit generators), ``random.<fn>`` other than
  ``random.Random``, and a torch sampler (``rand*``, ``randint``,
  ``randperm``, ``bernoulli``, ``multinomial``, ``normal``) without a
  ``generator=``. Bit-identity with the JAX package rests on explicit
  generators: a draw from the global state depends on whatever drew
  before it. (The reference's rule is host RNG under ``jax.jit``; eager
  torch stages nothing, so the port's hazard is the global state.)
* ``LNT002`` — a ``torch.distributed`` collective called without
  ``group=``: the implicit default group changes what the call means
  (the counterpart of ``shard_map`` without ``check_rep=``), and the
  collectives pass keys its group check on the explicit group.
* ``LNT003`` — ``.item()``, ``.tolist()`` or ``.cpu()`` in the
  serve-dispatch hot path (``src/repro_torch/serve``), the counterparts
  of ``.item()`` / ``jax.device_get``: a device sync per request melts
  the batched dispatch throughput the serve tier exists to provide.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, List, Optional

from .findings import REPO_ROOT, Finding, Report, rel_to_repo

# np.random attributes that build explicit generators
_NP_RNG_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
              "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937"}
_TORCH_SAMPLERS = {"rand", "randn", "rand_like", "randn_like", "randint",
                   "randint_like", "randperm", "bernoulli", "multinomial",
                   "normal"}
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_object",
                "all_gather_into_tensor", "all_gather_single",
                "all_to_all", "all_to_all_single", "reduce_scatter",
                "reduce_scatter_tensor", "reduce_scatter_single",
                "broadcast", "broadcast_object_list", "reduce", "gather",
                "gather_object", "scatter", "scatter_object_list",
                "barrier", "monitored_barrier"}
_SYNCS = {"item": ".item()", "tolist": ".tolist()", "cpu": ".cpu()"}
_SERVE_HOT_PREFIXES = ("src/repro_torch/serve/",)
_SKIP_PARTS = ("/fixtures/", "/tests/", "/__pycache__/")


def _attr_chain(node: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def _iter_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _enclosing_function(tree: ast.AST, target: ast.AST) -> str:
    """Name of the innermost FunctionDef containing ``target``."""
    best = ""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(child is target for child in ast.walk(node)):
                best = node.name
    return best


def _global_rng(chain: List[str], call: ast.Call) -> Optional[str]:
    """The call's text if it draws from a global RNG state."""
    text = ".".join(chain)
    if chain[:2] in (["np", "random"], ["numpy", "random"]):
        return text if len(chain) == 3 and chain[2] not in _NP_RNG_OK \
            else None
    if len(chain) == 2 and chain[0] == "random":
        return text if chain[1] != "Random" else None
    if len(chain) == 2 and chain[0] == "torch" and \
            chain[1] in _TORCH_SAMPLERS:
        if not any(kw.arg == "generator" for kw in call.keywords):
            return text
    return None


def _is_collective(chain: List[str]) -> bool:
    if not chain or chain[-1] not in _COLLECTIVES:
        return False
    return chain[:-1] in (["dist"], ["torch", "distributed"])


def check_file(path: str, report: Report,
               serve_hot: Optional[bool] = None) -> None:
    """Run all lint rules over one file."""
    file = rel_to_repo(path)
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    if serve_hot is None:
        serve_hot = file.startswith(_SERVE_HOT_PREFIXES)

    def add(rule: str, call: ast.Call, message: str) -> None:
        report.add(Finding(rule=rule, pass_name="lint", message=message,
                           file=file, line=call.lineno,
                           function=_enclosing_function(tree, call)))

    for call in _iter_calls(tree):
        chain = _attr_chain(call.func)
        if not chain:
            continue
        drawn = _global_rng(chain, call)
        if drawn:
            add("LNT001", call, f"{drawn}() draws from a global RNG state "
                "— pass an explicit generator")
        if _is_collective(chain) and \
                not any(kw.arg == "group" for kw in call.keywords):
            add("LNT002", call, f"{'.'.join(chain)}() without an explicit "
                "group= keyword")
        if serve_hot and chain[-1] in _SYNCS and \
                isinstance(call.func, ast.Attribute):
            add("LNT003", call, f"{_SYNCS[chain[-1]]} in the "
                "serve-dispatch hot path forces a device sync per request")


def repo_files() -> List[str]:
    """Python files the lint pass covers (``src/repro_torch``)."""
    root = os.path.join(REPO_ROOT, "src", "repro_torch")
    files: List[str] = []
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            norm = "/" + rel_to_repo(path) + "/"
            if any(part in norm for part in _SKIP_PARTS):
                continue
            files.append(path)
    return sorted(files)


def run(report: Report, files: Optional[List[str]] = None) -> int:
    targets = files if files is not None else repo_files()
    for path in targets:
        check_file(path, report)
    return len(targets)
