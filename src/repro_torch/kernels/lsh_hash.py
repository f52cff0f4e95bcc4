"""CUDA launch of the ``lsh_hash`` kernel (``csrc/lsh_hash.cu``).

Replaces the JAX package's Pallas TPU kernel ``lsh_hash_pallas``
(``src/repro/kernels/lsh_hash.py``): packed sign-random-projection
keys from a 3xTF32 tensor-core product (fp32-accurate), with the sign,
the bit-pack and the int64 widening fused into its epilogue, so the
(N, P) projection never reaches device memory and a call is one launch.
The plain version is :func:`repro_torch.kernels.ref.ref_lsh_hash`;
callers go through :func:`repro_torch.kernels.ops.lsh_hash`.
"""
from __future__ import annotations

import torch

from . import _build


def lsh_hash_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(N, d) f32 x (d, P) f32, both on one CUDA device ->
    (N, P//32) int64 keys in [0, 2^32)."""
    if not (x.is_cuda and a.device == x.device):
        raise ValueError("lsh_hash_cuda needs x and a on one CUDA device")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("lsh_hash_cuda takes float32 inputs")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("lsh_hash_cuda takes contiguous inputs")
    n, d = x.shape
    d2, p = a.shape
    if d != d2 or p % 32:
        raise ValueError(f"bad shapes x{tuple(x.shape)} a{tuple(a.shape)}")
    words = p // 32
    out = torch.empty((n, words), dtype=torch.int64, device=x.device)
    if n:
        fn = _build.load("lsh_hash")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(x.data_ptr(), a.data_ptr(), out.data_ptr(), n, d,
                        words, stream), "lsh_hash")
        _build.LAUNCHES["lsh_hash"] += 1
    return out
