"""Model-level checks shared by the four configs with the newer block
kinds (``test_torch_mla.py``, ``test_torch_recurrent.py``,
``test_torch_encdec.py``), against the JAX package on the CPU in f32.

Each config runs reduced, on the JAX package's weights with the zero-init
leaves drawn from numpy (``test_torch_models.perturb_zero_leaves``):

* ``prefill_decode_matches_forward``: the JAX package's own check
  (``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``):
  a prefill then one decode step equals the full forward's last logits,
  in the config's bf16, within its 3e-2;
* ``loss_and_grads_match_jax``: ``lm_loss`` within 1e-5 relative and
  every gradient leaf within 1e-4 relative in norm of ``jax.grad``'s;
* ``generate_matches_jax``: greedy ``ServingEngine.generate`` tokens
  equal the JAX engine's (no datastore: the kNN head is held in
  ``test_torch_lm_serving.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.models.transformer import param_dict, stack_layers
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import ServeConfig, ServingEngine
from test_torch_models import _pair
from test_torch_train import _leaves, _rel

B = 2
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DECODE_TOL = 3e-2        # tests/test_arch_smoke.py:88-91


def batch(cfg, rng, t: int, labels: bool = False) -> dict:
    """Tokens (and labels), and whisper's frame embeddings."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, t)).astype(
            np.int32)
    if cfg.frontend == "audio":
        b["features"] = rng.normal(size=(B, cfg.enc_len, cfg.d_model)
                                   ).astype(np.float32)
    return b


def _tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def prefill_decode_matches_forward(arch: str) -> None:
    _, _, _, tm, tp = _pair(arch, "bf16", seed=2)
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    t = 16
    prompt = batch(cfg, rng, t)
    cache = tm.init_cache(B, t + 8, dtype=torch.float32, device="cpu")
    _, cache, _ = tm.prefill(tp, _tb(prompt), cache)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    got, _ = tm.decode_step(tp, torch.from_numpy(nxt), cache, t)
    full = dict(prompt, tokens=np.concatenate([prompt["tokens"], nxt], 1))
    hidden, _ = tm.forward(tp, _tb(full))
    want = tm.logits(tp, hidden[:, -1:])
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def loss_and_grads_match_jax(arch: str, chunk: int = 4) -> None:
    jcfg, jm, jp, tm, tp = _pair(arch, "f32", seed=1)
    b = batch(jcfg, np.random.default_rng(1), 12, labels=True)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, remat=True,
        loss_chunk=chunk)))(jp)
    tp.requires_grad_(True)
    loss = tm.loss(tp, _tb(b), remat=True, loss_chunk=chunk)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    got = _leaves(stack_layers(tadamw.tree_map(lambda p: p.grad,
                                               param_dict(tp))))
    want = _leaves(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for path in want:
        assert _rel(got[path], want[path]) <= GRAD_TOL, path


def generate_matches_jax(arch: str, new: int = 6) -> np.ndarray:
    """Two rounds of greedy generation; returns the port's tokens."""
    jcfg, jm, jp, tm, tp = _pair(arch, "f32", seed=3)
    jeng = JaxServingEngine(jm, jp, JaxServeConfig(knn_lambda=0.0))
    teng = ServingEngine(tm, tp, ServeConfig(knn_lambda=0.0))
    rng = np.random.default_rng(4)
    for _ in range(2):
        b = batch(jcfg, rng, 10)
        jout, jstats = jeng.generate(b, max_new=new, insert_online=False)
        tout, tstats = teng.generate(b, max_new=new, insert_online=False)
        np.testing.assert_array_equal(tout, jout)
        assert tstats == jstats
    return tout

