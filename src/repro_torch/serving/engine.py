"""Serving: prefill/decode step factories + a batched engine with the
PFO-backed kNN-LM head.

The port's copy of the JAX package's ``serving/engine.py``.
``ServingEngine`` drives batched requests end to end and realizes the
paper's use case (§2.2 online nearest neighbors): the prompt's last
hidden state queries a **PFO datastore** of (hidden -> next-token)
memories and the output distribution interpolates
p = (1-lam) p_LM + lam p_kNN (Khandelwal-style kNN-LM); every finished
request **online-inserts** its (hidden, token) pair.  The datastore is
driven through the port's ``StreamEngine`` (or ``DistStreamEngine``).

Host traffic: the generated tokens stay on the device and come back in
one copy at the end of :meth:`ServingEngine.generate`; the prompt's last
hidden state comes back once when the datastore needs it.  Those are the
engine's own readbacks (``n_readbacks``); the stream's flushes count
theirs in its ``stats()``.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..obs import NULL_OBS
from ..sharding.policy import distribute_cache, gathered, place_params
from .stream import StreamEngine


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0          # 0 => greedy
    knn_lambda: float = 0.25
    knn_k: int = 8
    knn_temp: float = 10.0


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s arithmetic in ``x``'s dtype: x - max, less
    the log of the sum of its exps, each step rounded to that dtype as
    the reference rounds it (``torch.log_softmax`` rounds once, and in
    bfloat16 lands on another value for about a fifth of the entries)."""
    u = x - x.amax(-1, keepdim=True)
    return u - torch.log(torch.exp(u).sum(-1, keepdim=True))


def make_prefill_step(model, policy=None):
    """``prefill(params, batch, cache) -> (last_logits, cache,
    last_hidden)`` (see ``transformer.prefill``).  With a policy the
    step runs in its scope and lays out activations by its
    ``constrain``; params, batch and cache arrive placed (DTensors)."""
    if policy is None:
        return model.prefill

    def prefill(params, batch, cache):
        with policy.context():
            return model.prefill(params, batch, cache,
                                 constrain=policy.constrain)

    return prefill


def make_decode_step(model, policy=None):
    """``decode(params, token, cache, pos) -> (logits, cache)``."""
    if policy is None:
        return model.decode_step

    def decode(params, token, cache, pos: int):
        with policy.context():
            return model.decode_step(params, token, cache, pos,
                                     constrain=policy.constrain)

    return decode


class ServingEngine:
    """Batched server (fixed batch, greedy) with optional PFO kNN-LM
    augmentation.  The model runs on its params' device.

    The kNN datastore is driven through the stream engine's request
    front-end: the queries and the post-request online inserts are
    *submitted* to the stream and coalesced into its micro-batches."""

    def __init__(self, model, params, scfg: ServeConfig, policy=None,
                 pfo_index=None, knn_vocab_map=None, pfo_stream=None):
        """With a ``policy`` (a ``ShardingPolicy`` on a DeviceMesh) the
        engine serves a placed copy of ``params`` (their placements from
        ``param_shardings``), places each batch by ``batch_sharding`` and
        each cache by ``cache_pspecs``; logits and the kNN head's hidden
        state come back to every rank whole.  The PFO datastore is not
        sharded."""
        self.model, self.scfg, self.policy = model, scfg, policy
        if policy is not None:
            params = place_params(policy, model.param_specs, params)
        self.params = params
        self.device = params["embed"].device
        self.prefill_step = make_prefill_step(model, policy)
        self.decode_step = make_decode_step(model, policy)
        if pfo_stream is None and pfo_index is not None:
            pfo_stream = StreamEngine(pfo_index)
        self.stream = pfo_stream
        # .index is None for distributed backends: the kNN paths are
        # gated on the stream itself, never on .pfo
        self.pfo = pfo_stream.index if pfo_stream is not None else None
        # the datastore's observability handle, so serving spans and
        # metrics land next to the stream's round metrics
        self.obs = pfo_stream.obs if pfo_stream is not None else NULL_OBS
        # datastore value -> token id mapping (np array indexed by id)
        self.knn_vocab_map = knn_vocab_map
        self.n_readbacks = 0              # the engine's own device reads

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.n_readbacks += 1
        return t.cpu().numpy()

    # -- kNN-LM ----------------------------------------------------------
    def _knn_logits(self, hidden: np.ndarray, vocab: int) -> torch.Tensor:
        """hidden (B, D) -> (B, V) kNN distribution (log space, float32,
        on the model's device): each neighbour's weight is
        exp(-knn_temp * dist) over its row's sum; a token's log-weight is
        the log of its neighbours' weights (each plus 1e-20) summed, and
        -1e30 where no neighbour maps to it."""
        t0 = time.perf_counter()
        with self.obs.span("knn", batch=int(hidden.shape[0])):
            tickets = [self.stream.query(hidden[b], k=self.scfg.knn_k)
                       for b in range(hidden.shape[0])]
            res = self.stream.flush()
        self.obs.histogram("serving.knn_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        ids = np.stack([res[t][0] for t in tickets])
        dists = np.stack([res[t][1] for t in tickets])
        ok = ids >= 0
        toks = self.knn_vocab_map[np.where(ok, ids, 0)]
        dev = self.device
        ok_d = torch.from_numpy(ok).to(dev)
        w = torch.where(ok_d, torch.exp(-self.scfg.knn_temp
                                        * torch.from_numpy(dists).to(dev)),
                        0.0)
        w = w / torch.clamp_min(w.sum(1, keepdim=True), 1e-9)
        acc = torch.zeros((hidden.shape[0], vocab), dtype=torch.float32,
                          device=dev)
        rows = torch.arange(hidden.shape[0], device=dev)[:, None]
        acc.index_put_((rows.expand_as(w), torch.from_numpy(
            toks.astype(np.int64)).to(dev)),
            torch.where(ok_d, w + 1e-20, 0.0), accumulate=True)
        return torch.where(acc > 0, torch.log(acc), -1e30)

    def _next_token(self, logits: torch.Tensor,
                    hidden: np.ndarray | None) -> torch.Tensor:
        """Greedy next token (B,) int32, on the device."""
        lam = self.scfg.knn_lambda
        logp = _log_softmax(logits)
        if self.stream is not None and hidden is not None and lam > 0:
            knn = self._knn_logits(hidden, logits.shape[-1])
            logp = torch.logaddexp(math.log1p(-lam) + logp,
                                   math.log(lam) + _log_softmax(knn))
        if self.scfg.temperature > 0:
            raise NotImplementedError("greedy only in the offline build")
        return torch.argmax(logp, dim=-1).to(torch.int32)

    def _placed_token(self, tok: torch.Tensor) -> torch.Tensor:
        """The next step's (B, 1) tokens, placed by the batch rule."""
        if self.policy is None:
            return tok[:, None]
        return self.policy.distribute(tok[:, None], self.policy.batch_spec())

    # -- serving ---------------------------------------------------------
    def _mark(self):
        """A point on the step clock: a recorded CUDA event on a card
        (its time is read after the final copy, so marking adds no
        sync), else the host clock."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        if isinstance(a, torch.cuda.Event):
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def generate(self, batch: dict, max_new: int = 32,
                 insert_online: bool = True):
        """Batched generation; returns (tokens (B, max_new) int32 numpy,
        stats)."""
        cfg = self.model.cfg
        b = batch["tokens"].shape[0]
        prompt_len = batch["tokens"].shape[1]
        front = cfg.frontend_len if cfg.frontend == "patch" else 0
        total = prompt_len + max_new + front
        cache = self.model.init_cache(b, total, device=self.device)
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        pol = self.policy
        if pol is not None:
            cache = distribute_cache(pol, cfg, cache)
            batch = {k: pol.distribute(v, pol.batch_spec())
                     for k, v in batch.items()}
        knn = self.stream is not None and self.scfg.knn_lambda > 0
        t0 = time.perf_counter()
        with self.obs.span("prefill", batch=b, prompt_len=prompt_len):
            logits, cache, last = self.prefill_step(self.params, batch,
                                                    cache)
            logits, last = gathered(logits), gathered(last)
            # the kNN head's query and the datastore's new memories
            last_hidden = None
            if knn or (insert_online and self.stream is not None):
                last_hidden = self._to_host(last.float())
        self.obs.histogram("serving.prefill_ms").observe(
            (time.perf_counter() - t0) * 1e3)

        out = torch.zeros((b, max_new), dtype=torch.int32,
                          device=self.device)
        pos = prompt_len + front
        tok = self._next_token(logits[:, 0], last_hidden)
        marks = [self._mark()]
        for i in range(max_new):
            out[:, i] = tok
            with self.obs.span("decode", step=i):
                logits, cache = self.decode_step(
                    self.params, self._placed_token(tok), cache, pos + i)
                logits = gathered(logits)
                # decode steps do not consult the kNN head (hidden=None)
                tok = self._next_token(logits[:, 0], None)
            marks.append(self._mark())
        out = self._to_host(out)
        h_decode = self.obs.histogram("serving.decode_step_ms")
        for a, b_ in zip(marks, marks[1:]):
            h_decode.observe(self._ms(a, b_))
        self.obs.counter("serving.tokens_generated").inc(b * max_new)
        stats = {"prompt_len": prompt_len, "generated": max_new}

        if insert_online and self.stream is not None:
            # the paper's online-update half: store this request's
            # (hidden -> first produced token) memories via the stream
            base = self.stream.backend.n_inserted
            ids = np.arange(base, base + b, dtype=np.int32)
            for r in range(b):
                self.stream.insert(int(ids[r]), last_hidden[r])
            self.stream.flush()
            self.obs.counter("serving.datastore_inserts").inc(b)
            if self.knn_vocab_map is not None:
                need = base + b
                if self.knn_vocab_map.shape[0] < need:
                    self.knn_vocab_map = np.resize(self.knn_vocab_map,
                                                   need + 1024)
                self.knn_vocab_map[ids] = out[:, 0]
            stats["datastore_size"] = self.stream.backend.n_inserted
        return out, stats
