"""The port's step-cost analysis (``repro_torch.analysis``) against the
JAX package's.

* ``param_counts`` and ``model_flops`` equal the JAX package's exactly
  for every runnable (arch, shape) cell at published widths (spec-only:
  nothing is allocated).
* ``analyze_step``'s product FLOPs of reduced smollm and llama4 on one
  device lie within 5% of ``analyze_hlo(...).flops`` of the JAX
  package's jitted step (its compiled HLO) for prefill and decode, and
  within 10% for a train step (remat on both sides).  The LM stack
  reaches no ``pallas_call``, so the reference's ``REPRO_PALLAS`` switch
  does not change that HLO.  Both numbers are printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import analyze_hlo
from repro.analysis import model_flops as jmf
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.serving.engine import make_decode_step as jdecode
from repro.serving.engine import make_prefill_step as jprefill
from repro.train.loop import make_train_step as jtrain
from repro_torch import configs, convert
from repro_torch.analysis import analyze_step, model_flops as tmf
from repro_torch.configs.shapes import runnable_cells
from repro_torch.models.transformer import param_dict
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving.engine import make_decode_step, make_prefill_step
from repro_torch.train import make_train_step

torch.set_num_threads(1)

B, T, CACHE, CHUNK = 2, 16, 32, 8


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_match_jax(arch):
    assert tmf.param_counts(arch) == jmf.param_counts(arch)
    for a, shape in runnable_cells():
        if a == arch:
            assert tmf.model_flops(arch, shape) == \
                jmf.model_flops(arch, shape), shape
    print(arch, tmf.param_counts(arch))


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                               dtype=torch.float32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm_params = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp))
    from repro_torch.models.registry import build_model
    return jm, jp, build_model(tcfg), tm_params


def _hlo_flops(fn, *args) -> float:
    return analyze_hlo(fn.lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["smollm_135m", "llama4_scout_17b_a16e"])
def test_analyze_step_flops_near_analyze_hlo(arch, kind):
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    if kind == "prefill":
        want = _hlo_flops(jprefill(jm, None), jp, {"tokens": toks},
                          jm.init_cache(B, CACHE, jnp.float32))
        _, st = analyze_step(make_prefill_step(tm, None), tp,
                             {"tokens": torch.from_numpy(toks)},
                             tm.init_cache(B, CACHE, device="cpu"))
        tol = 0.05
    elif kind == "decode":
        jc = jm.init_cache(B, CACHE, jnp.float32)
        _, jc = jprefill(jm, None)(jp, {"tokens": toks}, jc)
        want = _hlo_flops(jdecode(jm, None), jp, toks[:, :1], jc,
                          jnp.int32(T))
        tc = tm.init_cache(B, CACHE, device="cpu")
        _, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
        _, st = analyze_step(make_decode_step(tm, None), tp,
                             torch.from_numpy(toks[:, :1]), tc, T)
        tol = 0.05
    else:
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        jcfg = JAdamWConfig()
        want = _hlo_flops(jtrain(jm, None, jcfg, loss_chunk=CHUNK), jp,
                          jadamw_init(jcfg, jp), batch)
        tcfg = AdamWConfig()
        _, st = analyze_step(make_train_step(tm, None, tcfg,
                                             loss_chunk=CHUNK), tp,
                             adamw_init(tcfg, param_dict(tp)),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        tol = 0.10
    print(f"{arch} {kind}: port {st.flops:.6g} FLOPs, JAX HLO {want:.6g}")
    assert abs(st.flops - want) <= tol * want
