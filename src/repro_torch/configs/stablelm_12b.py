"""stablelm-12b [hf:stabilityai]: 40L d=5120 32H (GQA kv=8) d_ff=13824
vocab=100352."""
from ..models.transformer import TransformerConfig
from . import ArchEntry, LM_SHAPES, register

CONFIG = TransformerConfig(
    name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
    n_kv_heads=8, head_dim=160, d_ff=13824, vocab=100352, glu=True,
    activation="silu", remat=True)

SMOKE = TransformerConfig(
    name="stablelm-12b-smoke", n_layers=2, d_model=80, n_heads=4,
    n_kv_heads=2, head_dim=20, d_ff=128, vocab=512, glu=True,
    activation="silu", remat=False)

ENTRY = register(ArchEntry(
    arch_id="stablelm-12b", kind="lm", family="dense",
    config=CONFIG, smoke_config=SMOKE, shapes=LM_SHAPES,
    notes="partitioner inapplicable (dense LM, DESIGN §8)."))
