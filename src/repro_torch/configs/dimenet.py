"""dimenet [arXiv:2003.03123]: 6 blocks, d=128, bilinear 8, 7 spherical x
6 radial basis — triplet-gather kernel regime."""
from ..models.gnn.dimenet import DimeNetConfig
from . import ArchEntry, GNN_SHAPES, register

CONFIG = DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                       n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0)
SMOKE = DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=32,
                      n_bilinear=4, n_spherical=4, n_radial=4, cutoff=5.0)

ENTRY = register(ArchEntry(
    arch_id="dimenet", kind="gnn", family="gnn",
    config=CONFIG, smoke_config=SMOKE, shapes=GNN_SHAPES,
    notes="triplet lists are built host-side (gnn/dimenet.build_triplets) "
          "and padded; cap 2x edges for full-graph dry-runs."))
