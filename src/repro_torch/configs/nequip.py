"""nequip [arXiv:2101.03164]: 5 layers, mult=32, l_max=2, 8 RBF, cutoff 5,
E(3)-equivariant tensor products (Cartesian irreps)."""
from ..models.gnn.nequip import NequIPConfig
from . import ArchEntry, GNN_SHAPES, register

CONFIG = NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                      n_rbf=8, cutoff=5.0)
SMOKE = NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                     n_rbf=4, cutoff=5.0)

ENTRY = register(ArchEntry(
    arch_id="nequip", kind="gnn", family="gnn",
    config=CONFIG, smoke_config=SMOKE, shapes=GNN_SHAPES))
