"""Request objects for the partitioning facade — port of
``repro.api.request``.

A ``PartitionRequest`` fully describes one partitioning job: the graph
(either an in-memory ``Graph`` or a ``GraphSpec`` naming a synthetic
family to generate), the block count ``k``, the balance slack, the
preset/config, the seed, and a backend hint. Requests are frozen — a
serving session can hash ``GraphSpec``s for caching and replay a request
byte-for-byte.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..core.deep_mgp import PartitionerConfig
from ..core.partitioner import PRESETS, resolve_config
from ..graphs.format import Graph


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Generator spec: which synthetic family to materialize (hashable,
    so sessions can cache the generated graph across requests)."""
    family: str
    n: int
    avg_deg: float = 8.0
    seed: int = 0

    def validate(self) -> "GraphSpec":
        from ..graphs import generators
        if self.family not in generators._FAMILIES:
            raise ValueError(
                f"unknown graph family {self.family!r}; expected one of "
                f"{sorted(generators._FAMILIES)}")
        if self.n < 0:
            raise ValueError(f"graph size n must be >= 0, got {self.n}")
        return self

    def materialize(self) -> Graph:
        from ..graphs import generators
        self.validate()
        return generators.make(self.family, self.n, self.avg_deg,
                               seed=self.seed)


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionRequest:
    """One partitioning job, the reference's request field for field.

    The port serves the single-device backends (``single`` and the
    baselines ``plain_mgp`` / ``single_level_lp``); ``"auto"`` resolves
    to ``single`` unless the reference's policy picks a distributed
    backend, which raises until it is ported. ``contraction`` /
    ``weights`` / ``balance`` are the reference's distributed
    memory-model knobs and are ignored by the single-device backends.
    ``kernel`` picks the hot-loop implementation ("auto" | "fused" |
    "composed") — results are bit-identical either way.

    ``refine`` selects the refinement algorithm ("lp" | "unconstrained");
    ``quality`` is the serving-facing spelling of the same choice
    ("fast" -> lp, "best" -> unconstrained). An explicit ``refine``
    always wins over ``quality``.
    """
    graph: Union[Graph, GraphSpec]
    k: int
    epsilon: float = 0.03
    preset: str = "fast"                        # "fast" | "strong"
    config: Optional[PartitionerConfig] = None  # overrides the preset
    seed: int = 0
    backend: str = "auto"
    devices: int = 1                            # PE count for dist backends
    collect_trace: bool = True                  # per-level records cost an
                                                # O(m) cut pass per level
    contraction: Optional[str] = None           # "host" | "sharded"
    weights: Optional[str] = None               # "replicated" | "owner"
    balance: Optional[str] = None               # "host" | "dist"
    kernel: Optional[str] = None                # "auto"|"fused"|"composed"
    refine: Optional[str] = None                # "lp" | "unconstrained"
    quality: Optional[str] = None               # "fast" | "best"

    def validate(self) -> "PartitionRequest":
        from ..kernels.dispatch import check_kernel_mode
        from .backends import available_backends
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.config is None and self.preset not in PRESETS:
            raise ValueError(f"unknown preset {self.preset!r}; expected "
                             f"one of {sorted(PRESETS)}")
        if self.backend != "auto" and \
                self.backend not in available_backends():
            raise ValueError(
                f"unknown backend {self.backend!r}; expected 'auto' or "
                f"one of {available_backends()}")
        if self.contraction not in (None, "host", "sharded"):
            raise ValueError(
                "contraction must be 'host' or 'sharded', "
                f"got {self.contraction!r}")
        if self.weights not in (None, "replicated", "owner"):
            raise ValueError(
                "weights must be 'replicated' or 'owner', "
                f"got {self.weights!r}")
        if self.balance not in (None, "host", "dist"):
            raise ValueError(
                f"balance must be 'host' or 'dist', got {self.balance!r}")
        if self.kernel is not None:
            check_kernel_mode(self.kernel)
        if self.refine is not None:
            from ..core.refinement import check_refine_mode
            check_refine_mode(self.refine)
        if self.quality not in (None, "fast", "best"):
            raise ValueError(
                f"quality must be 'fast' or 'best', got {self.quality!r}")
        if self.config is not None:
            self.config.validate()
        if isinstance(self.graph, GraphSpec):
            self.graph.validate()
        return self

    def resolve_graph(self) -> Graph:
        if isinstance(self.graph, GraphSpec):
            return self.graph.materialize()
        return self.graph

    def resolve_config(self) -> PartitionerConfig:
        """Preset (+ epsilon/seed) unless an explicit config was given;
        request-level ``contraction``/``weights``/``balance``/``kernel``/
        ``refine`` override either. ``quality`` maps to ``refine``
        ("best" -> "unconstrained", "fast" -> "lp") only when ``refine``
        itself is unset — the explicit knob wins."""
        cfg = resolve_config(self.preset, self.config, self.epsilon,
                             self.seed)
        overrides = {}
        if self.contraction is not None:
            overrides["contraction"] = self.contraction
        if self.weights is not None:
            overrides["weights"] = self.weights
        if self.balance is not None:
            overrides["balance"] = self.balance
        if self.kernel is not None:
            overrides["kernel"] = self.kernel
        if self.refine is not None:
            overrides["refine"] = self.refine
        elif self.quality is not None:
            overrides["refine"] = ("unconstrained" if self.quality == "best"
                                   else "lp")
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides).validate()
        return cfg
