"""``chip_smoke.py``'s own checks, on the CPU: its ``lsh_hash`` hold at
large d (``hash_flips`` with ``rounding``) passes fp32-accurate products
and fails one whose operands are rounded to bf16 or to 1xTF32; and the
runner it starts each example program with passes the program its
command line and writes the launch counts however the program ends.

``ops.lsh_hash`` is swapped for each product; the plain version and the
float64 projection stay as the script uses them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)


def _tf32(t):
    """Round fp32 to TF32's 10 mantissa bits (to nearest)."""
    b = t.float().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _pack(proj):
    bits = (proj >= 0).to(torch.int64).reshape(proj.shape[0], -1, 32)
    return (bits * torch.tensor(ref._MSB_WEIGHTS)).sum(-1)


PRODUCTS = {
    "fp32_chunked": lambda x, a: _pack(sum(
        x[:, k:k + 256] @ a[k:k + 256] for k in range(0, x.shape[1], 256))),
    "3xtf32": lambda x, a: _pack(
        _tf32(x) @ _tf32(a) + _tf32(x) @ _tf32(a - _tf32(a))
        + _tf32(x - _tf32(x)) @ _tf32(a)),
    "1xtf32": lambda x, a: _pack(_tf32(x) @ _tf32(a)),
    "bf16": lambda x, a: _pack(x.bfloat16().float() @ a.bfloat16().float()),
}


def _held(flips) -> bool:
    """``lsh_hash_at``'s checks with ``rounding``."""
    return (flips["far"] == 0 and flips["plain_err"] < chip_smoke.FLIP_SIGMAS
            and flips["near"] <= flips["in_band"] // 4 + 1)


@pytest.mark.parametrize("d,norm", [(5120, 70.0), (1024, 30.0)])
@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_lsh_hash_band_tells_fp32_from_rounded_operands(monkeypatch, d, norm,
                                                        product):
    """1,024 rows of hidden-state-like vectors (a few outlier dims, norm
    as the families' states) against 128 Gaussian projections."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn((1024, d), generator=g)
    x[:, :4] *= 20
    x = x / x.norm(dim=1, keepdim=True) * norm
    a = torch.randn((d, 128), generator=g)
    monkeypatch.setattr(chip_smoke.ops, "lsh_hash", PRODUCTS[product])
    flips = chip_smoke.hash_flips(x, a, rounding=True)
    assert _held(flips) == (product in ("fp32_chunked", "3xtf32")), flips


@pytest.mark.parametrize("code", [0, 3])
def test_example_runner_passes_argv_and_writes_launches(tmp_path, code):
    script = tmp_path / "prog.py"
    script.write_text(
        "import sys, torch\n"
        "from repro_torch.kernels import ops\n"
        "assert __name__ == '__main__'\n"
        "print(sys.argv)\n"
        "ops.lsh_hash(torch.ones(4, 8), torch.ones(8, 32))\n"
        f"sys.exit({code})\n")
    log, inputs = tmp_path / "launches.json", tmp_path / "inputs.pt"
    env = dict(os.environ, PYTHONPATH=str(chip_smoke.ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", chip_smoke.EXAMPLE_RUNNER, str(script),
         str(log), str(inputs), "--steps", "7"], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stderr[-2000:]
    assert proc.stdout.strip() == repr([str(script), "--steps", "7"])
    launches = json.loads(log.read_text())
    assert set(launches) >= {"lsh_hash", "gather_rank", "pair_dist"}
    assert not any(launches.values())       # the CPU runs the plain versions
    assert torch.load(inputs) == {}         # ... and taps only the card's
