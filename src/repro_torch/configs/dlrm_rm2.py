"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction."""
from ..models.dlrm import DLRMConfig
from . import ArchEntry, RECSYS_SHAPES, register

CONFIG = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                    vocab_per_table=1_000_000, bot_mlp=(512, 256, 64),
                    top_mlp=(512, 512, 256, 1))
SMOKE = DLRMConfig(name="dlrm-rm2-smoke", n_dense=13, n_sparse=6,
                   embed_dim=16, vocab_per_table=1000, bot_mlp=(32, 16),
                   top_mlp=(64, 32, 1))

ENTRY = register(ArchEntry(
    arch_id="dlrm-rm2", kind="recsys", family="recsys",
    config=CONFIG, smoke_config=SMOKE, shapes=RECSYS_SHAPES,
    notes="partitioner applies via table co-occurrence placement "
          "(placement/dlrm_placement.py)."))
