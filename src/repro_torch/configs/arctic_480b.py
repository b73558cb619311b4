"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d=7168 56H (GQA
kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2 + dense residual."""
import torch

from ..models.transformer import TransformerConfig
from . import ArchEntry, LM_SHAPES, register

CONFIG = TransformerConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    head_dim=128, d_ff=4864, vocab=32000, glu=True, activation="silu",
    moe=True, n_experts=128, top_k=2, moe_dense_residual=True,
    moe_d_ff=4864, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True)

SMOKE = TransformerConfig(
    name="arctic-480b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, head_dim=16, d_ff=96, vocab=512, glu=True,
    activation="silu", moe=True, n_experts=8, top_k=2,
    moe_dense_residual=True, moe_d_ff=96, remat=False)

ENTRY = register(ArchEntry(
    arch_id="arctic-480b", kind="lm", family="moe",
    config=CONFIG, smoke_config=SMOKE, shapes=LM_SHAPES,
    notes="MoE placement engine applies (expert co-activation, DESIGN §8); "
          "Adafactor + bf16 params for pod memory fit."))
