"""gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden, 8 heads, attn agg."""
from ..models.gnn.gat import GATConfig
from . import ArchEntry, GNN_SHAPES, register

CONFIG = GATConfig(name="gat-cora", n_layers=2, d_in=1433, d_hidden=8,
                   n_heads=8, n_classes=7)
SMOKE = GATConfig(name="gat-cora-smoke", n_layers=2, d_in=32, d_hidden=4,
                  n_heads=2, n_classes=5)

ENTRY = register(ArchEntry(
    arch_id="gat-cora", kind="gnn", family="gnn",
    config=CONFIG, smoke_config=SMOKE, shapes=GNN_SHAPES,
    notes="partitioner applies directly: node placement minimizes halo "
          "volume (collective roofline term ~ edge cut)."))
