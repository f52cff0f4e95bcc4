"""Training loop: the step factory and the restartable trainer.

The port's copy of the JAX package's ``train/loop.py``.
``make_train_step`` builds the (loss -> grad -> AdamW) step for a Model;
it differentiates with respect to detached aliases of the params (a
bf16 copy of them with ``grad_dtype="bf16"``), so the model's own
parameters never build a graph, and it writes the new values into them
in place under ``torch.no_grad()``: the module keeps its identity.

``Trainer`` runs the steps:
  * checkpoint every ``ckpt_every`` steps and at the last step (atomic,
    in the JAX package's layout and leaf paths: a train checkpoint of
    either package restores into the other);
  * **restart**: picks up the latest complete checkpoint and replays
    the deterministic data stream from that step;
  * **straggler hook**: a step slower than ``step_timeout_s`` is noted in
    ``slow_steps`` for an orchestrator to act on.

One host readback a step: the loss, as a float.

With a ``ShardingPolicy`` the params are DTensors placed by its
``param_shardings`` (in place in the module), the AdamW moments and
master weights take the params' placements (the reference's
``in_shardings`` / ``out_shardings``), each batch is placed by its
``batch_sharding``, and the step runs in the policy's scope with its
``constrain``.  A checkpoint of a sharded trainer is written in the JAX
layout, full leaves gathered once and written by rank 0; a restore
places each leaf's shard for the trainer's mesh, whatever mesh wrote
it (the elastic restart).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..core.device import default_device
from ..models.transformer import _ident, param_dict, stack_layers, \
    unstack_layers
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import OptState, tree_leaves, tree_map, tree_unflatten
from ..sharding.policy import NamedSharding, gathered, place_params


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    loss_chunk: int = 512
    step_timeout_s: float = 300.0
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def make_train_step(model, policy, opt_cfg: AdamWConfig,
                    loss_chunk: int = 512):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)``:
    ``params`` (a ``Transformer``) updated in place and returned,
    ``metrics`` 0-d tensors on its device (``loss``, ``grad_norm``,
    ``lr``).  With a ``policy`` the params, optimizer state and batch
    arrive placed (see :class:`Trainer`) and keep their placements."""
    gdtype = torch.bfloat16 if opt_cfg.grad_dtype == "bf16" else None
    constrain = policy.constrain if policy is not None else _ident
    scope = policy.context if policy is not None else contextlib.nullcontext

    def step(params, opt: OptState, batch: dict):
        with scope():
            tree = param_dict(params)
            leaves = tree_map(lambda p: p.detach().to(gdtype or p.dtype)
                              .requires_grad_(), tree)
            loss = model.loss(leaves, batch, constrain=constrain,
                              remat=True, loss_chunk=loss_chunk)
            grads = tree_unflatten(leaves, torch.autograd.grad(
                loss, tree_leaves(leaves)))
            new, opt, metrics = adamw_update(opt_cfg, grads, opt, tree)
            with torch.no_grad():
                for p, n in zip(tree_leaves(tree), tree_leaves(new)):
                    p.copy_(n)
            metrics["loss"] = loss.detach()
            metrics = {k: gathered(v) for k, v in metrics.items()}
        return params, opt, metrics

    return step


# ======================================================================
# the train state's checkpoint, in the JAX package's layout
# ======================================================================
def state_tree(params, opt: OptState) -> tuple:
    """``(params, opt)`` as the JAX package's ``Trainer`` saves them:
    every group's layers stacked (copies), ``master=None`` kept None."""
    def stack(t):
        return None if t is None else stack_layers(t)
    return (params.tree(), OptState(stack(opt.m), stack(opt.v),
                                    stack(opt.master), opt.step))


def save_train_checkpoint(ckpt_dir: str, step: int, params, opt: OptState,
                          extra: dict | None = None) -> str:
    return save_checkpoint(ckpt_dir, step, state_tree(params, opt), extra)


def _placements_of(tree):
    """``tree`` with each DTensor leaf's ``NamedSharding`` and every
    other leaf None."""
    if isinstance(tree, dict):
        return {k: _placements_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [_placements_of(v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_placements_of(v) for v in tree))
    if hasattr(tree, "placements"):
        return NamedSharding(tree.device_mesh, tuple(tree.placements))
    return None


def restore_train_checkpoint(ckpt_dir: str, step: int, params,
                             opt: OptState):
    """Load ``step`` into ``params`` in place (dtypes, devices and
    placements kept) and into a new OptState shaped like ``opt``.  A
    sharded ``params`` / ``opt`` takes each leaf's shard for its own
    mesh, whatever mesh wrote the checkpoint.  Returns
    ``(params, opt, extra)``."""
    like = state_tree(params, opt)
    (ptree, o), extra = restore_checkpoint(ckpt_dir, step, like,
                                           shardings=_placements_of(like))
    with torch.no_grad():
        for p, x in zip(tree_leaves(param_dict(params)),
                        tree_leaves(unstack_layers(ptree))):
            p.copy_(x)

    def unstack(t):
        return None if t is None else unstack_layers(t)
    return params, OptState(unstack(o.m), unstack(o.v), unstack(o.master),
                            o.step), extra


class Trainer:
    def __init__(self, model, data, tcfg: TrainConfig, policy=None,
                 device=None):
        """Runs on ``device`` (CUDA when None); with a ``policy`` (a
        ``ShardingPolicy`` on a DeviceMesh of that device type) sharded
        over its mesh."""
        self.model, self.data, self.tcfg = model, data, tcfg
        self.policy = policy
        self.device = default_device(device)
        self.step_fn = make_train_step(model, policy, tcfg.opt,
                                       tcfg.loss_chunk)
        self.slow_steps: list[int] = []

    def _init_state(self):
        """float32 params drawn on a generator on the trainer's device,
        seeded ``seed``; fresh optimizer state."""
        g = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(g, torch.float32, device=self.device)
        if self.policy is not None:
            place_params(self.policy, self.model.param_specs, params,
                         inplace=True)
        return params, adamw_init(self.tcfg.opt, param_dict(params))

    def run(self, resume: bool = True) -> dict:
        tcfg = self.tcfg
        params, opt = self._init_state()
        start = 0
        if resume:
            last = latest_step(tcfg.ckpt_dir)
            if last is not None:
                params, opt, _ = restore_train_checkpoint(
                    tcfg.ckpt_dir, last, params, opt)
                start = last
        losses = []
        for step in range(start, tcfg.steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            if self.policy is not None:
                batch = {k: self.policy.distribute(v, self.policy.batch_spec())
                         for k, v in batch.items()}
            t0 = time.time()
            params, opt, metrics = self.step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if dt > tcfg.step_timeout_s:
                self.slow_steps.append(step)   # straggler hook
            losses.append(loss)
            if step % tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt*1e3:.0f} ms)")
            if (step + 1) % tcfg.ckpt_every == 0 or step + 1 == tcfg.steps:
                save_train_checkpoint(tcfg.ckpt_dir, step + 1, params, opt,
                                      {"loss": loss})
        return {"params": params, "opt": opt, "losses": losses,
                "slow_steps": self.slow_steps}
