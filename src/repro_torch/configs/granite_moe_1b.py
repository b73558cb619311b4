"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L d=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8."""
from ..models.transformer import TransformerConfig
from . import ArchEntry, LM_SHAPES, register

CONFIG = TransformerConfig(
    name="granite-moe-1b", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155, glu=True,
    activation="silu", moe=True, n_experts=32, top_k=8, moe_d_ff=512,
    remat=True)

SMOKE = TransformerConfig(
    name="granite-moe-1b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=64, vocab=512, glu=True,
    activation="silu", moe=True, n_experts=4, top_k=2, moe_d_ff=64,
    remat=False)

ENTRY = register(ArchEntry(
    arch_id="granite-moe-1b-a400m", kind="lm", family="moe",
    config=CONFIG, smoke_config=SMOKE, shapes=LM_SHAPES,
    notes="vocab 49155 is not divisible by 16: the sharding planner "
          "replicates the vocab dim (DESIGN §6) — exercised on purpose."))
