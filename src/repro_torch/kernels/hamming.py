"""CUDA launch of the ``hamming`` kernel (``csrc/hamming.cu``).

Replaces the JAX package's Pallas TPU kernel ``hamming_pallas``
(``src/repro/kernels/hamming.py``): bit differences between packed
compound keys, counted on the int8 tensor cores as ``popc(a) + popc(b) -
2 popc(a & b)``, so the (Q, N, W) XOR is never built.  The port carries
keys as int64 in [0, 2^32) (as ``lsh_hash`` returns them); the kernel
reads the int64 keys and takes their low 32 bits itself.
The plain version is :func:`repro_torch.kernels.ref.ref_hamming`;
callers go through :func:`repro_torch.kernels.ops.hamming`.
"""
from __future__ import annotations

import torch

from . import _build

_TILE_Q, _TILE_N = 64, 128     # query x stored keys of a block's tile
_MAX_WORDS = 63                 # both key tiles, 192 x (W | 1) words, in 48 KB
_MAX_TILES = 2**31 - 1          # the 1-D grid walks every tile


def _high_words(keys: torch.Tensor) -> torch.Tensor:
    """Whether any int64 key has a bit set above its low 32 (a 0-d bool
    tensor, on the keys' device): one reduction over the high words, read
    in place (little-endian)."""
    return keys.view(torch.int32)[:, 1::2].any()


def hamming_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) integer keys in [0, 2^32) on one CUDA device ->
    (Q, N) int32 total bit differences."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("hamming_cuda needs a and b on one CUDA device")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError("hamming_cuda takes int64 keys (values < 2^32)")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"bad shapes a{tuple(a.shape)} b{tuple(b.shape)}")
    nq, w = a.shape
    n = b.shape[0]
    if (not 1 <= w <= _MAX_WORDS or nq >= 2**31 or n >= 2**31
            or -(-nq // _TILE_Q) * -(-n // _TILE_N) > _MAX_TILES):
        raise ValueError(f"hamming_cuda takes 1 <= W <= {_MAX_WORDS} and "
                         "Q, N within its grid")
    out = torch.empty((nq, n), dtype=torch.int32, device=a.device)
    if nq and n:
        a, b = a.contiguous(), b.contiguous()
        bad = _high_words(a) | _high_words(b)
        fn = _build.load("hamming")
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if bool(bad):                   # the one readback
            raise ValueError("hamming_cuda takes keys in [0, 2^32)")
        _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), nq, n, w,
                        stream), "hamming")
        _build.LAUNCHES["hamming"] += 1
    return out
