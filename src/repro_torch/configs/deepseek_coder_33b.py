"""deepseek-coder-33b [arXiv:2401.14196; hf]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 — llama-arch.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="attn")
    if reduced:
        return ModelConfig(
            name="deepseek_coder_33b", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=512,
            groups=(((blk,), 2),), act="silu")
    return ModelConfig(
        name="deepseek_coder_33b", n_layers=62, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=19200, vocab_size=32256,
        groups=(((blk,), 62),), act="silu")
