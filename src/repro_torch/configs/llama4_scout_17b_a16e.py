"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 16 routed
top-1 + 1 shared expert every layer; iRoPE: 3 chunked-local (rope,
chunk 8192) : 1 global (NoPE) — the sub-quadratic pattern that makes
long_500k runnable for this arch.
"""
from ..models.common import BlockDef, ModelConfig


def _groups(chunk: int):
    local = BlockDef(kind="attn", attn_impl="chunked", rope="rope",
                     window=chunk, moe=True)
    glob = BlockDef(kind="attn", attn_impl="full", rope="nope", moe=True)
    return ((local, local, local, glob),)


def config(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="llama4_scout_17b_a16e", n_layers=4, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512, groups=((_groups(32)[0], 1),),
            act="silu", n_experts=4, top_k=1, n_shared_experts=1,
            moe_d_ff=128, rope_theta=500000.0)
    return ModelConfig(
        name="llama4_scout_17b_a16e", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=202048, groups=((_groups(8192)[0], 12),),
        act="silu", n_experts=16, top_k=1, n_shared_experts=1,
        moe_d_ff=8192, rope_theta=500000.0)
