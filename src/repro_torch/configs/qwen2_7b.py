"""qwen2-7b [arXiv:2407.10671; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — QKV bias.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="attn")
    if reduced:
        return ModelConfig(
            name="qwen2_7b", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512,
            groups=(((blk,), 2),), act="silu", qkv_bias=True,
            rope_theta=1e6)
    return ModelConfig(
        name="qwen2_7b", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
        groups=(((blk,), 28),), act="silu", qkv_bias=True,
        rope_theta=1e6)
