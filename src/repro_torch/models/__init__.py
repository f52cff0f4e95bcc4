"""The port's model zoo: the JAX package's ``models/`` (GQA, MLA, RWKV-6
and RG-LRU blocks, dense and MoE feed-forwards, the whisper
encoder-decoder) as PyTorch modules and plain functions on tensors."""
from .common import BlockDef, ModelConfig
from .registry import Model, build_model
from .transformer import Transformer

__all__ = ["ModelConfig", "BlockDef", "build_model", "Model", "Transformer"]
