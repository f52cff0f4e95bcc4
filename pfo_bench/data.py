"""A deployment's base vectors, made on the device from the seed in a few
large calls (a configuration's ``data`` entry says how)."""
from __future__ import annotations

import torch


def noise_scale(cfg: dict) -> float:
    """One coordinate's root-mean-square size in the deployment's data
    (unit rows): the unit a traffic mix's ``noise`` is given in."""
    return 1.0 / cfg["dim"] ** 0.5


def base_vectors(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """(n, dim) float32 clustered unit rows, about ``per_cluster`` to a
    cluster around random unit centres, with ``spread`` of the centre's
    norm as noise."""
    data, dim = cfg["data"], cfg["dim"]
    if not data.get("unit"):
        raise ValueError("only unit rows are made: a configuration of other "
                         "data brings its own branch here")
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((max(1, n // data["per_cluster"]), dim),
                          generator=g, device=device)
    centers = centers / centers.norm(dim=1, keepdim=True)
    which = torch.randint(0, centers.shape[0], (n,), generator=g,
                          device=device)
    x = centers[which] + data["spread"] / dim ** 0.5 * torch.randn(
        (n, dim), generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True)
