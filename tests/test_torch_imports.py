"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the
port's example programs ``examples/*_torch.py``, its scripts
``scripts/{insert_ab,lm_datastore,lookup_ab}.py`` and the multi-rank
children ``tests/_torch_dist_child.py`` and ``tests/_torch_shard_child.py``
import neither JAX nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "_torch_dist_child.py",
    REPO / "tests" / "_torch_shard_child.py"] + [
    REPO / "examples" / f"{name}_torch.py" for name in (
        "quickstart", "streaming_recsys", "knnlm_serving", "train_smollm")] + [
    REPO / "scripts" / f"{name}.py" for name in (
        "insert_ab", "lm_datastore", "lookup_ab")]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_in_source(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.obs, repro_torch.storage, "
            "repro_torch.core.coldtier, repro_torch.core.baselines, "
            "repro_torch.serving, repro_torch.obs.slo, "
            "repro_torch.checkpoint, repro_torch.sharding, "
            "repro_torch.core.distributed, repro_torch.models, "
            "repro_torch.configs, repro_torch.data, "
            "repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.models.moe, repro_torch.optim, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.models.rwkv6, "
            "repro_torch.models.rglru, repro_torch.sharding.policy, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.configs.shapes, repro_torch.analysis, "
            "repro_torch.analysis.cost, repro_torch.analysis.model_flops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
