"""gemma-2b [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) head_dim=256
d_ff=16384 GeGLU vocab=256000, tied embeddings."""
from ..models.transformer import TransformerConfig
from . import ArchEntry, LM_SHAPES, register

CONFIG = TransformerConfig(
    name="gemma-2b", n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    head_dim=256, d_ff=16384, vocab=256000, glu=True,
    activation="gelu_tanh", tied_embeddings=True, remat=True)

SMOKE = TransformerConfig(
    name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=16, d_ff=128, vocab=512, glu=True, activation="gelu_tanh",
    tied_embeddings=True, remat=False)

ENTRY = register(ArchEntry(
    arch_id="gemma-2b", kind="lm", family="dense",
    config=CONFIG, smoke_config=SMOKE, shapes=LM_SHAPES,
    notes="partitioner inapplicable (dense LM, DESIGN §8); MQA kv=1 "
          "replicates KV over the model axis."))
