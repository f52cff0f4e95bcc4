"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 — mistral-nemo
backbone; the pixtral ViT frontend is a STUB per the assignment:
``input_specs`` supplies precomputed patch embeddings (B, 256, d).
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="attn")
    if reduced:
        return ModelConfig(
            name="pixtral_12b", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
            groups=(((blk,), 2),), act="silu", frontend="patch",
            frontend_len=8, rope_theta=1e9)
    return ModelConfig(
        name="pixtral_12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, head_dim=160, d_ff=14336, vocab_size=131072,
        groups=(((blk,), 40),), act="silu", frontend="patch",
        frontend_len=256, rope_theta=1e9)
