"""The port's model zoo: the dense GQA decoders of the JAX package's
``models/`` as PyTorch modules and plain functions on tensors (MoE, MLA,
RWKV-6, RG-LRU and the encoder-decoder wait: ``ROADMAP.md`` Queue 1)."""
from .common import BlockDef, ModelConfig
from .registry import Model, build_model
from .transformer import Transformer

__all__ = ["ModelConfig", "BlockDef", "build_model", "Model", "Transformer"]
