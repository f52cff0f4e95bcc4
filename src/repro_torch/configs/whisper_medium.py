"""whisper-medium [arXiv:2212.04356; unverified]

Enc-dec: 24 encoder + 24 decoder layers, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865, layernorm + gelu.  The conv audio frontend is a
STUB: ``input_specs`` supplies precomputed frame embeddings
(B, 1500, d) — the transformer backbone is what the cell exercises.
"""
from ..models.common import BlockDef, ModelConfig


def config(reduced: bool = False) -> ModelConfig:
    enc = BlockDef(kind="attn")
    dec = BlockDef(kind="attn", cross_attn=True)
    if reduced:
        return ModelConfig(
            name="whisper_medium", family="encdec", n_layers=4,
            d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
            vocab_size=512, groups=(((dec,), 2),),
            enc_groups=(((enc,), 2),), act="gelu", norm="layernorm",
            frontend="audio", enc_len=32)
    return ModelConfig(
        name="whisper_medium", family="encdec", n_layers=48,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=51865, groups=(((dec,), 24),),
        enc_groups=(((enc,), 24),), act="gelu", norm="layernorm",
        frontend="audio", enc_len=1500)
