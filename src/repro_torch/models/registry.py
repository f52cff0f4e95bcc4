"""Model registry: config -> Model bundle (init / forward / loss / serve
fns).

``build_model(cfg)`` wires the assembly for any ModelConfig (GQA, MLA,
RWKV-6 or RG-LRU blocks, dense or MoE feed-forward, an encoder);
``get(name)`` resolves an architecture from ``repro_torch.configs``.
The model state is a :class:`~.transformer.Transformer` on a device;
CUDA unless the caller names another.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.device import default_device
from . import transformer as tfm
from .common import ModelConfig, init_params


class Model(NamedTuple):
    cfg: ModelConfig
    param_specs: dict

    def init(self, generator: torch.Generator | None = None, dtype=None,
             device=None) -> tfm.Transformer:
        """Random params drawn on ``generator``'s device (a CPU generator
        seeded 0 when None), then moved to ``device``."""
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        tree = init_params(self.param_specs, generator,
                           dtype or self.cfg.dtype)
        return tfm.Transformer(self.cfg, tree).to(device)

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        return tfm.init_cache(self.cfg, batch, max_len,
                              dtype or self.cfg.dtype,
                              default_device(device))

    def loss(self, params, batch, constrain=tfm._ident, remat: bool = True,
             loss_chunk: int = 512):
        return tfm.lm_loss(params, self.cfg, batch, constrain=constrain,
                           remat=remat, loss_chunk=loss_chunk)

    def forward(self, params, batch, **kw):
        return tfm.forward(params, self.cfg, batch, **kw)

    def logits(self, params, hidden, constrain=tfm._ident):
        return tfm.logits_fn(params, self.cfg, hidden, constrain)

    def prefill(self, params, batch, cache, constrain=tfm._ident):
        return tfm.prefill(params, self.cfg, batch, cache,
                           constrain=constrain)

    def decode_step(self, params, token, cache, pos: int,
                    constrain=tfm._ident):
        return tfm.decode_step(params, self.cfg, token, cache, pos=pos,
                               constrain=constrain)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, param_specs=tfm.model_param_specs(cfg))


@functools.lru_cache(maxsize=None)
def get(name: str, reduced: bool = False) -> Model:
    """Resolve an assigned architecture by id (see repro_torch.configs)."""
    from .. import configs
    return build_model(configs.get_config(name, reduced=reduced))
