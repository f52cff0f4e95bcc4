"""A run of the command on the card: a sound run prints ``correct`` true
and the control false.  Skips where there is no CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from _small import REPO


def _run(*extra) -> dict:
    out = subprocess.run(
        [sys.executable, "pfo_bench/run.py", "--workload",
         "glove-100-angular.ycsb-b", "--seed", "3000000077", "--seconds", "3",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_the_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run()
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    control = _run("--control")
    assert not control["correct"]
