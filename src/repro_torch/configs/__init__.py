"""Architecture registry — port of ``repro.configs``: one module per
architecture registers an ``ArchEntry``: the five LMs, the four GNNs and
DLRM (``_MODULES``), with the reference's three shape sets."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | long_decode |
    #                      gnn_full | gnn_minibatch | gnn_molecule |
    #                      recsys_train | recsys_serve | recsys_retrieval
    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    kind: str            # lm | gnn | recsys
    family: str          # dense | moe | gnn | recsys
    config: Any          # full-size model config
    smoke_config: Any    # reduced config for CPU smoke tests
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.arch_id] = entry
    return entry


_MODULES = [
    "arctic_480b", "granite_moe_1b", "gemma_2b", "stablelm_12b", "qwen2_7b",
    "schnet", "nequip", "gat_cora", "dimenet", "dlrm_rm2",
]


def load_all() -> Dict[str, ArchEntry]:
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")
    return dict(_REGISTRY)


def get(arch_id: str) -> ArchEntry:
    if arch_id not in _REGISTRY:
        load_all()
    return _REGISTRY[arch_id]


# ---------------------------------------------------------------------------
# shared shape sets
# ---------------------------------------------------------------------------

LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill",
              {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode",
              {"seq_len": 32768, "global_batch": 128}),
    # long-context DECODE is linear per step (one query against a
    # sequence-sharded KV cache); 500k PREFILL would be quadratic
    ShapeSpec("long_500k", "long_decode",
              {"seq_len": 524288, "global_batch": 1}),
)


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "gnn_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_pad": _pad512(2708 + 1), "e_pad": _pad512(2 * 10556)}),
    ShapeSpec("minibatch_lg", "gnn_minibatch",
              {"n_nodes": 232965, "n_edges": 114615892,
               "batch_nodes": 1024, "fanout": (15, 10),
               # sampled subgraph (padded): seeds*(1+15+150) nodes
               "n_pad": _pad512(1024 * 166 + 1),
               "e_pad": _pad512(1024 * (15 + 150))}),
    ShapeSpec("ogb_products", "gnn_full",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_pad": _pad512(2449029 + 1),
               "e_pad": _pad512(2 * 61859140)}),
    ShapeSpec("molecule", "gnn_molecule",
              {"n_nodes": 30, "n_edges": 64, "batch": 128,
               "n_pad": _pad512(30 * 128 + 1),
               "e_pad": _pad512(2 * 64 * 128)}),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", {"batch": 65536}),
    ShapeSpec("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "recsys_retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)
