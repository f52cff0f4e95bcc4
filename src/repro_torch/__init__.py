"""PyTorch + CUDA port of PFO (the JAX package ``repro`` is the reference).

``repro_torch.core.index.PFOIndex`` is the entry point: the hot hash
forests and the sealed snapshot ring of the paper's system, run on an
NVIDIA GPU through the hand-written kernels in ``repro_torch.kernels``.
"""
