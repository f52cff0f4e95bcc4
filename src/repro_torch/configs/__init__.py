"""Assigned architecture configs (one module per arch id), on the port's
``ModelConfig``.

``get_config(name, reduced=)`` returns the exact published config or a
family-faithful reduced config for CPU tests.  ``ARCH_IDS`` is the
assignment list; ``shapes`` holds the per-arch input-shape cells and
``input_specs`` builds (shape, dtype) stand-ins for the dry-run.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llama4_scout_17b_a16e",
    "deepseek_v2_236b",
    "smollm_135m",
    "nemotron_4_15b",
    "deepseek_coder_33b",
    "qwen2_7b",
    "pixtral_12b",
    "whisper_medium",
    "rwkv6_7b",
    "recurrentgemma_9b",
]

# dashed aliases matching the assignment text
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(name: str, reduced: bool = False):
    name = ALIASES.get(name, name)
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.config(reduced=reduced)


from . import shapes  # noqa: E402
from .shapes import SHAPES, input_specs, runnable_cells  # noqa: E402,F401
