"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBF, cutoff 10."""
from ..models.gnn.schnet import SchNetConfig
from . import ArchEntry, GNN_SHAPES, register

CONFIG = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                      n_rbf=300, cutoff=10.0)
SMOKE = SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                     n_rbf=24, cutoff=5.0)

ENTRY = register(ArchEntry(
    arch_id="schnet", kind="gnn", family="gnn",
    config=CONFIG, smoke_config=SMOKE, shapes=GNN_SHAPES,
    notes="non-molecular shapes (full_graph/minibatch) use synthesized 3D "
          "positions; the kernel regime (gather+segment_sum) is identical."))
