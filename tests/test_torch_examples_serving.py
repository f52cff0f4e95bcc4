"""The port's streaming and kNN-LM example programs against the JAX
package's on the CPU (the quickstart and training examples:
``tests/test_torch_examples.py``; ``chip_smoke.example_module`` loads
them).

- streaming_recsys: on the JAX index's projections and the same
  ``VectorStream``, the ids each query answers and recall@10 equal in the
  first 2 epochs (a row whose distances tie within 1e-6 compared as a
  set), and the rounds;
- knnlm_serving: reduced smollm_135m in f32 from the JAX initial weights
  (``convert.params_from_numpy``), 2 rounds: the tokens and the datastore
  size equal.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import PFOConfig as JaxPFOConfig
from repro.core import PFOIndex as JaxIndex
from repro.data import VectorStream as JaxVectorStream
from repro.kernels import ops as jax_ops
from repro.models.registry import build_model as jax_build
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import StreamConfig as JaxStreamConfig
from repro.serving import StreamEngine as JaxStreamEngine
from test_torch_examples import DIST_TOL, _jax_proj, chip_smoke

torch.set_num_threads(1)

TIE_TOL = 1e-6
STREAM_EPOCHS = 2
KNN_ROUNDS = 2


# ----------------------------------------------------------------------
# streaming_recsys
# ----------------------------------------------------------------------
def _jax_stream(cfg, epochs: int, batch: int, queries: int):
    """examples/streaming_recsys.py's epochs on the JAX engine.  Its
    ``warmup()`` (which leaves the state bit-identical) is left out: it
    compiles every bucket, most of which these epochs never use."""
    index = JaxIndex(JaxPFOConfig(**dataclasses.asdict(cfg)), seed=0)
    engine = JaxStreamEngine(index, JaxStreamConfig(max_batch=256,
                                                    default_k=10))
    stream = JaxVectorStream(dim=cfg.dim, n_clusters=24, seed=1)
    all_ids = np.zeros((0,), np.int32)
    all_vecs = np.zeros((0, cfg.dim), np.float32)
    out = []
    for epoch in range(epochs):
        ids, vecs = stream.batch(epoch, batch)
        q = stream.queries(epoch, queries)
        all_ids = np.concatenate([all_ids, ids])
        all_vecs = np.concatenate([all_vecs, vecs])
        tickets = []
        qi = 0
        for r in range(batch):
            engine.insert(int(ids[r]), vecs[r])
            if r % (batch // queries) == 0 and qi < queries:
                tickets.append(engine.query(q[qi], k=10))
                qi += 1
        res = engine.flush()
        got = np.stack([np.asarray(res[t][0]) for t in tickets])
        dists = np.stack([np.asarray(res[t][1]) for t in tickets])
        oid, _ = jax_ops.brute_force_topk(jnp.asarray(q),
                                          jnp.asarray(all_vecs), 10,
                                          "angular")
        oracle = all_ids[np.asarray(oid)]
        recall = np.mean([len(set(got[i]) & set(oracle[i])) / 10
                          for i in range(queries)])
        out.append(dict(ids=got, dists=dists, recall=float(recall),
                        rounds=engine.stats()["rounds"]))
    return out, _jax_proj(index)


def _same_answer(jids, jd, tids, td) -> bool:
    """Equal ids in order; where a row's distances tie within TIE_TOL,
    equal as sets."""
    if np.array_equal(jids, tids):
        return True
    ties = np.diff(np.sort(np.asarray(jd))).min() <= TIE_TOL
    return bool(ties and set(jids.tolist()) == set(tids.tolist()))


def test_streaming_recsys_matches_jax(capsys):
    sr = chip_smoke.example_module("streaming_recsys")
    ref, proj = _jax_stream(sr.config(), STREAM_EPOCHS, sr.BATCH, sr.QUERIES)
    capsys.readouterr()
    got = sr.run("cpu", proj=proj, epochs=STREAM_EPOCHS)
    assert len(got) == STREAM_EPOCHS
    run = dict(s=0.0, out=capsys.readouterr().out, launches={})
    printed = chip_smoke.examples_epochs(run["out"])
    assert [e["recall"] for e in printed] == [round(t["recall"], 2)
                                              for t in got]
    chip_smoke.examples_streaming(run, run, STREAM_EPOCHS)
    other = dict(run, out=re.sub(
        r"recall@10=([\d.]+)",
        lambda m: f"recall@10={float(m.group(1)) + 0.05:.2f}", run["out"]))
    with pytest.raises(AssertionError, match="recall@10 card"):
        chip_smoke.examples_streaming(run, other, STREAM_EPOCHS)
    for e, (j, t) in enumerate(zip(ref, got)):
        assert t["store"] == sr.BATCH * (e + 1)
        bad = [i for i in range(sr.QUERIES)
               if not _same_answer(j["ids"][i], j["dists"][i], t["ids"][i],
                                   t["dists"][i])]
        assert not bad, f"epoch {e}: queries {bad} answered differently"
        np.testing.assert_allclose(t["dists"], j["dists"], rtol=0,
                                   atol=DIST_TOL)
        assert t["recall"] == j["recall"]
        assert t["rounds"] == j["rounds"]


# ----------------------------------------------------------------------
# knnlm_serving
# ----------------------------------------------------------------------
def test_knnlm_serving_matches_jax(capsys):
    kn = chip_smoke.example_module("knnlm_serving")
    jcfg = dataclasses.replace(
        jax_configs.get_config("smollm_135m", reduced=True),
        dtype=jnp.float32)
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.float32)
    pfo = JaxIndex(JaxPFOConfig(
        dim=jcfg.d_model, L=4, C=2, m=2, l=32, t=4, max_leaves_per_tree=512,
        main_max_leaves_per_tree=2048, store_capacity=16384,
        max_candidates_total=128), seed=0)
    proj = _jax_proj(pfo)
    engine = JaxServingEngine(model, params,
                              JaxServeConfig(knn_lambda=0.3, knn_k=8),
                              pfo_index=pfo,
                              knn_vocab_map=np.zeros(16384, np.int32))
    rng = np.random.default_rng(0)
    ref = []
    for _ in range(KNN_ROUNDS):
        batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                        (kn.REQUESTS, kn.PROMPT))
                 .astype(np.int32)}
        ref.append(engine.generate(batch, max_new=kn.NEW,
                                   insert_online=True))

    capsys.readouterr()
    got = kn.run("cpu", rounds=KNN_ROUNDS,
                 params=jax.tree.map(np.asarray, params), proj=proj,
                 dtype=torch.float32)
    printed = chip_smoke.examples_knnlm(
        dict(s=0.0, out=capsys.readouterr().out, launches={}), KNN_ROUNDS,
        kn.REQUESTS)
    assert printed["tokens0"] == [out[0].tolist() for out, _ in
                                  got["rounds"]]
    assert len(got["rounds"]) == KNN_ROUNDS
    for r, ((jout, jstats), (tout, tstats)) in enumerate(
            zip(ref, got["rounds"])):
        np.testing.assert_array_equal(tout, np.asarray(jout),
                                      err_msg=f"round {r}")
        assert tstats["datastore_size"] == jstats["datastore_size"] \
            == kn.REQUESTS * (r + 1)
