"""The port's kNN-LM ``ServingEngine`` against the JAX package's on the CPU.

Reduced ``smollm_135m`` in float32 with the JAX package's weights
(``convert.params_from_numpy``); both datastores are the kNN-LM
example's PFO config with the JAX index's projections
(``convert.proj_from_numpy``), both filled with the same 96 memories
(the JAX model's hidden states over ``SyntheticLM`` text, mapped to the
next token).  Three rounds of four requests with the kNN head on: the
tokens, the stats, the ``knn_vocab_map`` and every integer leaf of the
datastores are equal.  Hidden states are margin-checked: every table
and partition projection of each vector inserted or queried lies at
least 1e-4 from zero (float64), so the two packages' float sums cannot
hash it differently.  ``_knn_logits`` on identical hidden states agrees
within 1e-5; over a one-rank gloo ``DistStreamEngine`` the engine
serves as over a ``StreamEngine``; sampling and sharding policies are
refused; and the serving entry point runs on the CPU.

Run as a script on a dump of the full-width datastore
(``scripts/lm_datastore.py``), it prints the recall@k of the JAX index
and of the port's on it, with the same projections
(:func:`recall_vs_jax`)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/test_torch_lm_serving.py \
        build/lm_datastore.npz
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jax_configs
from repro.core import PFOConfig as JaxPFOConfig
from repro.core import PFOIndex as JaxIndex
from repro.models.registry import build_model as jax_build
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import configs, convert
from repro_torch.core import DistConfig, PFOConfig, PFOIndex
from repro_torch.data import SyntheticLM
from repro_torch.models.registry import build_model
from repro_torch.serving import (DistStreamEngine, ServeConfig,
                                 ServingEngine, StreamEngine)
from repro_torch.serving import engine as engine_mod
from repro_torch.sharding import stream_mesh
from test_torch_index import _assert_states_equal

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MARGIN = 1e-4
KNN_TOL = 1e-5
ROUNDS, REQUESTS, PROMPT, NEW = 3, 4, 12, 8
N_MEMORIES = 96
#: the kNN-LM example's datastore (examples/knnlm_serving.py:26-28)
PFO_KW = dict(L=4, C=2, m=2, l=32, t=4, max_leaves_per_tree=512,
              main_max_leaves_per_tree=2048, store_capacity=16384,
              max_candidates_total=128)
SERVE_KW = dict(knn_lambda=0.3, knn_k=8)


def _margins(x: np.ndarray, proj: dict, L: int) -> np.ndarray:
    """Per row: the smallest |table| and |partition| projection (float64)."""
    table = np.asarray(proj["table_proj"], np.float64)
    part = np.asarray(proj["part_proj"], np.float64)
    p = x.astype(np.float64) @ table
    bits = np.where(p >= 0, 1.0, -1.0).reshape(len(x), L, 32)
    pp = np.einsum("nlm,lmc->nlc", bits, part)
    return np.minimum(np.abs(p).min(1), np.abs(pp).min((1, 2)))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(
        jax_configs.get_config("smollm_135m", reduced=True),
        dtype=jnp.float32)
    tcfg = dataclasses.replace(
        configs.get_config("smollm_135m", reduced=True), dtype=torch.float32)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    jidx = JaxIndex(JaxPFOConfig(dim=jcfg.d_model, **PFO_KW), seed=0)
    proj = jax.tree.map(np.asarray, jidx.state.proj)
    tidx = PFOIndex(PFOConfig(dim=tcfg.d_model, **PFO_KW), device="cpu",
                    proj=convert.proj_from_numpy(proj))

    # the memories: the JAX model's hidden states over synthetic text,
    # mapped to the next token; the margin-safe ones, in order
    text = SyntheticLM(jcfg.vocab_size, 32, 8, seed=3).batch(0)
    hid, _ = jm.forward(jp, {"tokens": jnp.asarray(text["tokens"])})
    mem = np.asarray(hid, np.float32).reshape(-1, jcfg.d_model)
    nxt = text["labels"].reshape(-1)
    keep = _margins(mem, proj, PFO_KW["L"]) >= MARGIN
    mem, nxt = mem[keep][:N_MEMORIES], nxt[keep][:N_MEMORIES]
    assert len(mem) == N_MEMORIES
    ids = np.arange(N_MEMORIES, dtype=np.int32)
    jidx.insert(ids, mem)
    tidx.insert(ids, mem)
    vocab_map = np.zeros(16384, np.int32)
    vocab_map[:N_MEMORIES] = nxt

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (REQUESTS, PROMPT))
               .astype(np.int32) for _ in range(ROUNDS)]
    # every prompt's last hidden state (each round's kNN query and online
    # insert) is margin-safe under both packages' forward passes
    for p in prompts:
        jh, _ = jm.forward(jp, {"tokens": jnp.asarray(p)})
        th, _ = tm.forward(tp, {"tokens": torch.from_numpy(p)})
        last = np.asarray(jh[:, -1], np.float32)
        gap = np.abs(th[:, -1].numpy() - last).max()
        assert (_margins(last, proj, PFO_KW["L"]) >= MARGIN + 10 * gap).all()

    jeng = JaxServingEngine(jm, jp, JaxServeConfig(**SERVE_KW),
                            pfo_index=jidx, knn_vocab_map=vocab_map.copy())
    teng = ServingEngine(tm, tp, ServeConfig(**SERVE_KW), pfo_index=tidx,
                         knn_vocab_map=vocab_map.copy())
    outs = []
    for p in prompts:
        outs.append((jeng.generate({"tokens": p}, max_new=NEW),
                     teng.generate({"tokens": p}, max_new=NEW)))
    return dict(jeng=jeng, teng=teng, jidx=jidx, tidx=tidx, outs=outs,
                prompts=prompts, jm=jm, jp=jp, mem=mem, nxt=nxt, proj=proj)


def test_tokens_and_stats_equal(setup):
    for (jout, jstats), (tout, tstats) in setup["outs"]:
        assert tout.dtype == np.int32 and tout.shape == (REQUESTS, NEW)
        np.testing.assert_array_equal(tout, jout)
        assert tstats == jstats
    assert setup["outs"][-1][1][1]["datastore_size"] == \
        N_MEMORIES + ROUNDS * REQUESTS


def test_knn_head_changes_the_tokens(setup):
    """The first token of a round follows the datastore: without the kNN
    head (lambda 0) the model's own argmax differs somewhere."""
    eng = setup["teng"]
    plain = ServingEngine(eng.model, eng.params,
                          ServeConfig(knn_lambda=0.0))
    (_, _), (tout, _) = setup["outs"][0]
    out, _ = plain.generate({"tokens": setup["prompts"][0]}, max_new=NEW,
                            insert_online=False)
    logits, _, _ = eng.model.prefill(
        eng.params, {"tokens": torch.from_numpy(setup["prompts"][0])},
        eng.model.init_cache(REQUESTS, PROMPT + 1, device="cpu"))
    np.testing.assert_array_equal(out[:, 0], logits[:, 0].argmax(-1).numpy())
    assert (out[:, 0] != tout[:, 0]).any()


def test_vocab_map_and_datastore_equal(setup):
    np.testing.assert_array_equal(setup["teng"].knn_vocab_map,
                                  setup["jeng"].knn_vocab_map)
    _assert_states_equal(setup["jidx"], setup["tidx"])
    assert setup["tidx"].n_inserted == setup["jidx"].n_inserted


def test_knn_logits_on_identical_hiddens(setup):
    jh, _ = setup["jm"].forward(setup["jp"],
                                {"tokens": jnp.asarray(setup["prompts"][1])})
    hidden = np.asarray(jh[:, -1], np.float32)
    hidden = np.concatenate([hidden, setup["mem"][:4]])     # self-hits too
    vocab = setup["jm"].cfg.vocab_size
    want = setup["jeng"]._knn_logits(hidden, vocab)
    got = setup["teng"]._knn_logits(hidden, vocab)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KNN_TOL)
    assert ((want > -1e29).sum(1) > 0).all()


def test_knn_logits_add_up_repeated_tokens(setup):
    """Neighbours that map to one token add their weights: with every id
    mapped to one of three tokens, each row's eight neighbours repeat."""
    engines = (setup["jeng"], setup["teng"])
    saved = [e.knn_vocab_map for e in engines]
    vmap = (np.arange(len(saved[0])) % 3).astype(np.int32)
    hidden = setup["mem"][10:14]
    vocab = setup["jm"].cfg.vocab_size
    try:
        for e in engines:
            e.knn_vocab_map = vmap.copy()
        want = setup["jeng"]._knn_logits(hidden, vocab)
        got = setup["teng"]._knn_logits(hidden, vocab).numpy()
    finally:
        for e, m in zip(engines, saved):
            e.knn_vocab_map = m
    assert ((want > -1e29).sum(1) <= 3).all()
    assert (want.max(1) > np.log(0.5)).all()         # a token's sum > 1/2
    np.testing.assert_allclose(got, want, rtol=0, atol=KNN_TOL)


def _bf16_logits(raw: np.ndarray):
    j = jnp.asarray(raw, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("peaked", [False, True])
def test_next_token_in_bf16(setup, peaked):
    """On bfloat16 logits the model's log-probs have the reference's bits
    (``jax.nn.log_softmax`` in the logits' dtype) and the tokens with the
    kNN head mixed in are the reference's (src/repro/serving/
    engine.py:124-132); ``peaked``: eight tokens of each row hold most
    of the mass."""
    jeng, teng = setup["jeng"], setup["teng"]
    vocab = setup["jm"].cfg.vocab_size
    raw = np.random.default_rng(7).normal(size=(4, vocab)) * 3
    if peaked:
        raw[:, :8] += 16
    jl = jnp.asarray(raw, jnp.bfloat16)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        torch.bfloat16)
    got = engine_mod._log_softmax(tl)
    assert got.dtype == torch.bfloat16
    if not peaked:      # a peaked row's bf16 sum may round another way
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(jax.nn.log_softmax(jl))
                                      .view(np.int16))
    hidden = setup["mem"][20:24]
    np.testing.assert_array_equal(teng._next_token(tl, hidden).numpy(),
                                  jeng._next_token(jl, hidden))


def test_readbacks_per_generate(setup):
    """The engine reads the device twice a generate: the prompt's last
    hidden state and the tokens, once each."""
    assert setup["teng"].n_readbacks == 2 * ROUNDS


def test_engine_over_the_distributed_stream(setup, tmp_path):
    """Over a one-rank gloo ``DistStreamEngine`` (whose ``.index`` is None)
    the kNN head and the online inserts still run: the tokens, stats and
    vocab map equal the engine's over a ``StreamEngine`` on the same
    projections and memories."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        teng = setup["teng"]
        cfg = PFOConfig(dim=teng.model.cfg.d_model, **PFO_KW)
        proj = convert.proj_from_numpy(setup["proj"])
        streams = [DistStreamEngine(DistConfig(pfo=cfg, n_model=1),
                                    stream_mesh(1, device="cpu"), proj=proj),
                   StreamEngine(PFOIndex(cfg, device="cpu", proj=proj))]
        outs = []
        for stream in streams:
            for i, v in enumerate(setup["mem"]):
                stream.insert(i, v)
            stream.flush()
            vmap = np.zeros(PFO_KW["store_capacity"], np.int32)
            vmap[:N_MEMORIES] = setup["nxt"]
            eng = ServingEngine(teng.model, teng.params,
                                ServeConfig(**SERVE_KW), pfo_stream=stream,
                                knn_vocab_map=vmap)
            out = [eng.generate({"tokens": p}, max_new=NEW)
                   for p in setup["prompts"][:2]]
            outs.append((eng.pfo, out, eng.knn_vocab_map))
    finally:
        dist.destroy_process_group()
    (dpfo, dout, dmap), (spfo, sout, smap) = outs
    assert dpfo is None and spfo is not None
    for (dt, dstats), (st, sstats) in zip(dout, sout):
        np.testing.assert_array_equal(dt, st)
        assert dstats == sstats
    assert dout[-1][1]["datastore_size"] == N_MEMORIES + 2 * REQUESTS
    np.testing.assert_array_equal(dmap, smap)


@pytest.mark.parametrize("bad", ["temperature"])
def test_what_the_engine_refuses(setup, bad):
    """Sampling (temperature > 0) is not ported."""
    teng = setup["teng"]
    eng = ServingEngine(teng.model, teng.params,
                        ServeConfig(knn_lambda=0.0, temperature=0.7))
    with pytest.raises(NotImplementedError, match="greedy only"):
        eng.generate({"tokens": setup["prompts"][0]}, max_new=2)


def test_serve_entry_point_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--max-new", "4"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "round 1: generated (4, 4)" in out.stdout


# ======================================================================
# the full-width datastore, JAX index against the port's (not a test)
# ======================================================================
def recall_vs_jax(path: str) -> dict:
    """The dump's memories into the JAX index and the port's (the dump's
    config and projections, 4,096-row insert calls), its queries at k
    through both: each one's recall@k against the exact angular top-k
    (float64), answers per query, and the queries whose ids agree."""
    z = np.load(path)
    mem, q, k = z["mem"], z["queries"], int(z["k"])
    kw = json.loads(str(z["datastore"]))
    proj = {"table_proj": z["table_proj"], "part_proj": z["part_proj"]}
    jidx = JaxIndex(JaxPFOConfig(dim=mem.shape[1], **kw))
    jidx.state = jidx.state._replace(
        proj={n: jnp.asarray(v) for n, v in proj.items()})
    tidx = PFOIndex(PFOConfig(dim=mem.shape[1], **kw), device="cpu",
                    proj=convert.proj_from_numpy(proj))
    for a in range(0, len(mem), 4096):
        ids = np.arange(a, min(a + 4096, len(mem)), dtype=np.int32)
        jidx.insert(ids, mem[ids])
        tidx.insert(ids, mem[ids])
    unit = mem / np.linalg.norm(mem.astype(np.float64), axis=1)[:, None]
    qu = q / np.linalg.norm(q.astype(np.float64), axis=1)[:, None]
    truth = np.argsort(-(qu @ unit.T), axis=1)[:, :k]
    out = dict(memories=len(mem), queries=len(q), k=k)
    got = {}
    for name, idx in (("jax", jidx), ("port", tidx)):
        ids, _ = idx.query(q, k)
        got[name] = np.asarray(ids)
        out[name] = dict(
            recall=float(np.mean([len(set(got[name][i]) & set(truth[i]))
                                  / k for i in range(len(q))])),
            answers_per_query=float((got[name] >= 0).sum(1).mean()))
    out["queries_with_equal_ids"] = int(
        (got["jax"] == got["port"]).all(1).sum())
    return out


if __name__ == "__main__":
    print(json.dumps(recall_vs_jax(sys.argv[1])), flush=True)
