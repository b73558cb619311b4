"""qwen2-7b [arXiv:2407.10671]: 28L d=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias."""
from ..models.transformer import TransformerConfig
from . import ArchEntry, LM_SHAPES, register

CONFIG = TransformerConfig(
    name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    head_dim=128, d_ff=18944, vocab=152064, glu=True, activation="silu",
    qkv_bias=True, remat=True)

SMOKE = TransformerConfig(
    name="qwen2-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, glu=True, activation="silu",
    qkv_bias=True, remat=False)

ENTRY = register(ArchEntry(
    arch_id="qwen2-7b", kind="lm", family="dense",
    config=CONFIG, smoke_config=SMOKE, shapes=LM_SHAPES,
    notes="28 heads not divisible by model=16: planner shards FFN/vocab, "
          "replicates the head dim (DESIGN §6). Partitioner inapplicable."))
