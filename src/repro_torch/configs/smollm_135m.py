"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 — llama-arch
small, tied embeddings.  The port serves it at full width on the card
(``chip_smoke.py`` phase ``lm``).
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    blk = BlockDef(kind="attn")
    if reduced:
        return ModelConfig(
            name="smollm_135m", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
            groups=(((blk,), 2),), act="silu", tie_embeddings=True)
    return ModelConfig(
        name="smollm_135m", n_layers=30, d_model=576, n_heads=9,
        n_kv_heads=3, head_dim=64, d_ff=1536, vocab_size=49152,
        groups=(((blk,), 30),), act="silu", tie_embeddings=True)
