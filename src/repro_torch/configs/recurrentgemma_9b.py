"""recurrentgemma-9b [arXiv:2402.19427; unverified]

38 blocks cycling (RG-LRU, RG-LRU, local-attn window 2048) — 12 full
triples + one trailing recurrent pair.  d_model=4096, MQA 16H kv=1
head_dim=256, d_ff=12288 GeGLU, lru_width=4096, conv width 4.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    rec = BlockDef(kind="rglru")
    if reduced:
        attn = BlockDef(kind="attn", attn_impl="local", rope="rope",
                        window=16)
        return ModelConfig(
            name="recurrentgemma_9b", n_layers=3, d_model=64, n_heads=4,
            n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
            groups=(((rec, rec, attn), 1),), act="geglu", lru_width=64,
            conv_width=4)
    attn = BlockDef(kind="attn", attn_impl="local", rope="rope",
                    window=2048)
    return ModelConfig(
        name="recurrentgemma_9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
        groups=(((rec, rec, attn), 12), ((rec, rec), 1)), act="geglu",
        lru_width=4096, conv_width=4)
