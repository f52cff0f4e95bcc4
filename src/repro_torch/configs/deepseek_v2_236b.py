"""deepseek-v2-236b [arXiv:2405.04434; hf]

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v=128) vocab=102400; layer 0 dense FFN (12288), layers
1-59 MoE: 160 routed top-6 + 2 shared, expert d_ff=1536.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    dense = BlockDef(kind="mla", moe=False)
    moe = BlockDef(kind="mla", moe=True)
    if reduced:
        return ModelConfig(
            name="deepseek_v2_236b", n_layers=3, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=24, d_ff=128, vocab_size=512,
            groups=(((dense,), 1), ((moe,), 2)), act="silu",
            n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=32,
            kv_lora_rank=16, q_lora_rank=24, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16)
    return ModelConfig(
        name="deepseek_v2_236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=12288, vocab_size=102400,
        groups=(((dense,), 1), ((moe,), 59)), act="silu",
        n_experts=160, top_k=6, n_shared_experts=2, moe_d_ff=1536,
        kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128)
