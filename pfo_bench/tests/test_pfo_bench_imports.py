"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
benchmarks, and its reference imports nothing of the program.  Names
are compared whole, by their top level: ``repro_torch`` is not
``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys

from _small import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
HARNESS = sorted(p for p in (REPO / "pfo_bench").rglob("*.py")
                 if "tests" not in p.parts)


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_module_imports_jax_or_the_jax_package():
    assert HARNESS
    for p in HARNESS:
        bad = _top_level_imports(p) & FORBIDDEN
        assert not bad, f"{p.relative_to(REPO)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in HARNESS if "reference" in p.parts]
    assert ref
    for p in ref:
        names = _top_level_imports(p)
        assert names <= {"__future__", "contextlib", "numpy", "torch"}, \
            f"{p.relative_to(REPO)} imports {names}"


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process, then ``sys.modules`` by
    whole top-level names, as ``run.py`` checks it after the window."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO / 'pfo_bench/tests')!r})\n"
        "from _small import run_small\n"
        "r = run_small('glove-100-angular.stream-mix', seconds=0.3)\n"
        "from pfo_bench import run\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(r['correct'], run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == "True []"
