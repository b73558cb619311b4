"""Tape the aten ops of *real* entry points as they run.

The JAX package stages its programs to jaxprs (``jax.make_jaxpr``) and
never runs them. Eager PyTorch has no staging step, so the port's
counterpart of a jaxpr is a *tape of a run*: a
``TorchDispatchMode`` that records every aten op the callee executes,
in order. The callee therefore **runs**, unlike the reference's: on the
CPU in the tests and with ``--device cpu``, on the card in the chip
check. What the tape sees is what that run did; the passes check the
paths that the registry's inputs take (``entrypoints``).

Each :class:`Op` holds the op's name (the aten overload packet, e.g.
``add`` or ``index_add_``), its tensor operands and results by identity,
which operands are literals (a Python number, or a 0-dim tensor the run
made from one: ``scalar_tensor`` / ``lift_fresh``; the reference's jaxpr
literals), the result's dtype, the tensors the op writes in place, and
the user frame: the innermost stack frame in the repository that is not
this package's machinery (a fixture's frame counts, so do a test's).

Identity is the tensor's *storage*: a view and its base share one, so an
in-place write through a view (``labels[v0:v1] = ...``, an
``index_put_``) reaches the base's taint, as it reaches its values. The
tape holds every tensor it sees until it ends, so no storage is freed
and reused under a live key (a freed ``id()`` would hand its taint to a
stranger). When the tape ends it drops the tensors; the ops keep plain
ints and strings, so a rank process can ship its tape to the owner.

The CUDA kernels are ``ctypes`` launches (``kernels/_build.py``) below
the dispatcher, so on the card the tape ends at a kernel's wrapper: its
results come from ``torch.empty`` and carry no taint. On the CPU a
wrapper runs its plain version (``ref.py``), whose ops the tape sees:
that run is where the kernels' arithmetic is checked, as the reference
walks into its Pallas bodies.

:func:`capture` patches the callee attribute an entry point looks up
with a proxy that runs the real callee under a tape and raises
:class:`Captured`, so the entry unwinds as the reference's does after
its trace.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import REPO_ROOT, rel_to_repo

Site = Tuple[str, int, str]          # (repo-relative file, line, function)
NO_SITE: Site = ("", 0, "")

_ANALYSIS = "src/repro_torch/analysis/"
_FIXTURES = "src/repro_torch/analysis/fixtures/"
# ops whose 0-dim result is a literal operand (a number the run wrapped)
_LITERAL_MAKERS = ("scalar_tensor", "lift_fresh", "lift_fresh_copy")
# c10d ops -> the reference's collective names, and the argument the op
# writes (its output) and the one it reads
_C10D = {"alltoall_base_": ("all_to_all", 0, 1),
         "_allgather_base_": ("all_gather", 0, 1),
         "allgather_into_tensor_coalesced_": ("all_gather", 0, 1),
         "_reduce_scatter_base_": ("reduce_scatter", 0, 1),
         "allreduce_": ("psum", 0, 0)}


class Op(NamedTuple):
    """One taped aten op (see the module docstring)."""

    name: str                         # overload packet: "add", "lt", ...
    operands: Tuple[Optional[int], ...]   # storage keys; None = literal
    outs: Tuple[int, ...]             # storage keys of the results
    written: Tuple[Tuple[int, bool], ...]  # (key, whole storage?)
    dtype: str                        # the (first) result's dtype
    site: Site


class Captured(Exception):
    """Sentinel carrying the tape out of an entry point."""

    def __init__(self, tape: "Tape"):
        super().__init__("captured")
        self.tape = tape


_codes: Dict[Any, Optional[str]] = {}
_sites: Dict[Tuple[Any, int], Site] = {}


def _user_file(code) -> Optional[str]:
    """Repo-relative file of a user frame's code, else None."""
    rel = _codes.get(code, "?")
    if rel == "?":
        path = os.path.abspath(code.co_filename)
        rel = None
        if path.startswith(REPO_ROOT + os.sep):
            rel = rel_to_repo(path)
            if rel.startswith(_ANALYSIS) and not rel.startswith(_FIXTURES):
                rel = None
        _codes[code] = rel
    return rel


def user_site(skip: Tuple[str, ...] = ()) -> Site:
    """The innermost user frame of the caller's stack; files in ``skip``
    (repo-relative) are passed over too."""
    f = sys._getframe(1)
    while f is not None:
        rel = _user_file(f.f_code)
        if rel is not None and rel not in skip:
            key = (f.f_code, f.f_lineno)
            site = _sites.get(key)
            if site is None:
                site = _sites.setdefault(
                    key, (rel, f.f_lineno, f.f_code.co_name))
            return site
        f = f.f_back
    return NO_SITE


def _key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _flat(args) -> List[Any]:
    out: List[Any] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(_flat(a))
        else:
            out.append(a)
    return out


_writes: Dict[Any, Tuple[Tuple[int, str], ...]] = {}


def _written_args(func, args, kwargs) -> List[Any]:
    """The arguments ``func`` writes (its ``(a!)`` ones, ``out=`` too)."""
    pos = _writes.get(func)
    if pos is None:
        pos = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
        _writes[func] = pos
    return [args[i] if i < len(args) else kwargs.get(name)
            for i, name in pos]


class Tape(TorchDispatchMode):
    """Records every aten op run under it (``with Tape() as tape``).

    ``unlogged`` holds the c10d ops no :mod:`.collectives_pass` log
    announced (a collective issued around ``dist/collectives.py``), with
    their sites."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Op] = []
        self.unlogged: List[Tuple[str, Site]] = []
        self._announced = 0
        self._keep: List[torch.Tensor] = []
        self._literal: set = set()
        self._paused = 0

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._keep = []           # the keys stay; the tensors may go
        return out

    @contextlib.contextmanager
    def paused(self):
        """Run ops unrecorded (the verifier's own side traffic)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def announce(self) -> None:
        """The next c10d op is one the collective log has seen."""
        self._announced += 1

    def _operand(self, a) -> Optional[int]:
        if isinstance(a, torch.Tensor):
            key = _key(a)
            if key is None or key in self._literal:
                return None
            self._keep.append(a)
            return key
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if name in ("max", "min") and func._overloadname == "other":
            name = {"max": "maximum", "min": "minimum"}[name]
        site = user_site()
        if func.namespace == "c10d":
            self._record_c10d(name, args, site)
            return
        flat = _flat(args) + _flat(list(kwargs.values()))
        operands = tuple(self._operand(a) for a in flat
                         if isinstance(a, (torch.Tensor, int, float)))
        results = [t for t in _flat([out]) if isinstance(t, torch.Tensor)]
        outs = tuple(k for k in (self._operand(t) for t in results)
                     if k is not None)
        if name in _LITERAL_MAKERS and results and results[0].dim() == 0:
            self._literal.add(_key(results[0]))
            outs = ()
        written = tuple(self._write(t) for t in _written_args(func, args,
                                                              kwargs)
                        if isinstance(t, torch.Tensor))
        dtype = str(results[0].dtype) if results else ""
        self.ops.append(Op(name, operands, outs, written, dtype, site))

    def _write(self, t: torch.Tensor) -> Tuple[int, bool]:
        whole = t.numel() * t.element_size() == \
            t.untyped_storage().nbytes()
        self._keep.append(t)
        return (_key(t), whole)

    def _record_c10d(self, name: str, args, site: Site) -> None:
        if name not in _C10D:
            return
        if self._announced:
            self._announced -= 1
        else:
            self.unlogged.append((name, site))
        kind, w, r = _C10D[name]
        outs = [t for t in _flat([args[w]]) if isinstance(t, torch.Tensor)]
        ins = [t for t in _flat([args[r]]) if isinstance(t, torch.Tensor)]
        written = tuple(self._write(t) for t in outs)
        operands = tuple(self._operand(t) for t in ins)
        self.ops.append(Op(kind, operands, (), written,
                           str(outs[0].dtype) if outs else "", site))


def capture(module: Any, attr: str, invoke: Callable[[], Any],
            tape: Optional[Tape] = None,
            scope: Optional[Any] = None) -> Tape:
    """Run ``invoke()`` with ``module.attr`` patched to tape its first
    call: the real callee runs under ``tape`` (a new one by default) and
    inside ``scope`` (a context manager, e.g. a collective log), then
    the proxy raises :class:`Captured` and the entry unwinds."""
    real = getattr(module, attr)
    tape = Tape() if tape is None else tape

    def patched(*args: Any, **kwargs: Any) -> Any:
        with tape, (scope or contextlib.nullcontext()):
            real(*args, **kwargs)
        raise Captured(tape)

    setattr(module, attr, patched)
    try:
        invoke()
    except Captured as cap:
        return cap.tape
    finally:
        setattr(module, attr, real)
    raise RuntimeError(
        f"analysis: {module.__name__}.{attr} was never called by the "
        "entry point — the tracing registry is out of date")
