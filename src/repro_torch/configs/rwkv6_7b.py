"""rwkv6-7b "Finch" [arXiv:2404.05892; hf]

32L d_model=4096 (attn-free, 64 heads of size 64) d_ff=14336
vocab=65536 — data-dependent decay WKV; O(1)-state decode makes every
long-context cell runnable.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="rwkv")
    if reduced:
        return ModelConfig(
            name="rwkv6_7b", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
            groups=(((blk,), 2),))
    return ModelConfig(
        name="rwkv6_7b", n_layers=32, d_model=4096, n_heads=64,
        n_kv_heads=64, head_dim=64, d_ff=14336, vocab_size=65536,
        groups=(((blk,), 32),))
