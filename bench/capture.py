"""What the benchmark records inside the program's timed path: its own
wrappers around the program's module attributes, installed once before
the warm request so that every request runs through the same calls.

* Stage results (for the correctness check): the arrays that each stage
  of a sampled request returned, in call order, as the backend's stage
  table (``bench/stages/<backend>.py``) names them (``Recorder.sampled``
  switches them on per request).
* Work counts (for the rooflines, when tracing): the rows and arcs each
  clustering call's LP-move passes cover, and the rows and arcs of the
  overloaded blocks that each balancing round has to score, counted on a
  side stream.
* Host spans (when tracing): intervals of the stages and of other named
  program calls, on the host clock, which the per-layer metrics declare
  (``SPANS``) and which name the device's idle gaps.

Nothing here changes an argument or a result.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import time

import numpy as np


def csr_bytes(n: int, m: int) -> int:
    """The bytes of a CSR of n vertices and m arcs as the benchmark counts
    them, whatever layout the program keeps: int64 offsets, int32 heads,
    int64 arc weights."""
    return 8 * (n + 1) + 12 * m


# a host call outside the stages and the preparation spans, spanned in a
# traced run only to name the device's idle stretches it holds
NAMING_SPANS = (("edge_cut", "repro_torch.core.metrics", "edge_cut"),)


class Recorder:
    """Owns the wrappers; ``restore`` puts the program's attributes back."""

    def __init__(self, stages, tracing: bool, span_targets=()):
        self.tracing = tracing
        self.sampled = False
        self.records = []           # (kind, arrays) of sampled requests
        self.lp_work = []           # (rows, arcs, iterations) per call
        self.bal_work = []          # (rows, rows_over, arcs_over) per round
        self.slabs = []             # (request, slab + overflow, csr bytes)
        self.spans = []             # (name, t0, t1) on the host clock
        self.request = -1
        self._bal_deg = None
        self._side = None
        self._undo = []
        for kind, module, attr, arrays in stages:
            self._wrap(module, attr, self._stage(kind, arrays))
        if tracing:
            self._install_work()
            for name, module, attr in (*NAMING_SPANS, *span_targets):
                self._wrap(module, attr, self._spanned(name))

    # -- plumbing ----------------------------------------------------------

    def _wrap(self, module: str, attr: str, make):
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        wrapped = functools.wraps(fn)(make(fn, inspect.signature(fn)))
        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, fn))

    def restore(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.tracing:
                self.spans.append((name, t0, time.perf_counter()))

    def _spanned(self, name):
        def make(fn, sig):
            def call(*a, **kw):
                with self.span(name):
                    return fn(*a, **kw)
            return call
        return make

    def _stage(self, kind, arrays):
        """A wrapper spanned by the stage's kind that, in a sampled
        request, keeps copies of the result's compared arrays."""
        def make(fn, sig):
            def call(*a, **kw):
                with self.span(kind):
                    out = fn(*a, **kw)
                if self.sampled:
                    self.records.append(
                        (kind, [np.array(x) for x in arrays(out)]))
                return out
            return call
        return make

    # -- work counts (tracing) ---------------------------------------------

    def _install_work(self):
        import torch
        self._side = torch.cuda.Stream()

        def cluster(fn, sig):
            def call(*a, **kw):
                args = sig.bind(*a, **kw)
                args.apply_defaults()
                g = args.arguments["g"]
                self.lp_work.append((g.n, g.m,
                                     args.arguments["num_iterations"]))
                return fn(*a, **kw)
            return call

        def rebalance(fn, sig):
            def call(g, *a, **kw):
                self._bal_deg = torch.from_numpy(np.diff(g.indptr)).cuda()
                return fn(g, *a, **kw)
            return call

        def scores(fn, sig):
            def call(labels, bw, l_max, parent, ell_idx, ell_w, vw_pad, n,
                     *a, **kw):
                # the rows and arcs of the blocks overloaded at the round's
                # start, on the side stream, kept as device scalars until
                # the window has closed
                cur = torch.cuda.current_stream()
                self._side.wait_stream(cur)
                with torch.cuda.stream(self._side):
                    rows = (bw > l_max)[labels[:n].long()]
                    self.bal_work.append((n, rows.sum(),
                                          self._bal_deg[:n][rows].sum()))
                cur.wait_stream(self._side)
                return fn(labels, bw, l_max, parent, ell_idx, ell_w, vw_pad,
                          n, *a, **kw)
            return call

        def slab(fn, sig):
            def call(g, *a, **kw):
                out = fn(g, *a, **kw)
                if not any(r == self.request for r, _, _ in self.slabs):
                    arrays = [out.idx, out.w] + [x for o in out.overflow
                                                 if o is not None for x in o]
                    self.slabs.append((self.request,
                                       sum(x.nbytes for x in arrays),
                                       csr_bytes(g.n, g.m)))
                return out
            return call

        self._wrap("repro_torch.core.deep_mgp", "cluster", cluster)
        self._wrap("repro_torch.core.balance", "rebalance", rebalance)
        self._wrap("repro_torch.kernels.bal_round.ops", "fused_round_scores",
                   scores)
        self._wrap("repro_torch.kernels.lp_move.ops", "build_move_chunks",
                   slab)

    def work_counts(self):
        """The balancing rounds' counts as host integers."""
        return [(n, int(r), int(a)) for n, r, a in self.bal_work]
