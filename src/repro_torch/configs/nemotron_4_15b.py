"""nemotron-4-15b [arXiv:2402.16819; unverified]

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 — squared-ReLU
MLP (non-gated), rope.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="attn")
    if reduced:
        return ModelConfig(
            name="nemotron_4_15b", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
            groups=(((blk,), 2),), act="relu2")
    return ModelConfig(
        name="nemotron_4_15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=256000,
        groups=(((blk,), 32),), act="relu2")
