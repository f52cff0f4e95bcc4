"""Attention: GQA (opt. bias) with its local/chunked variants, its
cross-attention (whisper's decoder), and MLA (deepseek-v2).

The port's copy of the JAX package's ``models/attention.py``.
Full-sequence attention is computed *blockwise*: an online softmax over
KV chunks, as einsums in float32, in the reference's order and with its
masked score ``NEG_INF = -1e30`` (not ``-inf``), so a fully masked chunk
gives p = 1 on every lane until a later chunk's max rescales it away.
No fused attention operator is used: it would change both the
arithmetic and the masking.  MLA rides the same path as latent-space
MQA in the weight-absorbed form: q_eff = [q_nope·W_kb, q_rope], k_eff =
[c_kv, k_rope], v = c_kv (so Dv = kv_lora differs from Dk = kv_lora +
qk_rope), and the up-projection W_vb applies after the attention.

Caches: ``KVCache(k, v, length)`` with k, v (B, S, KV, head_dim);
``MLACache(c_kv, k_rope, length)`` with c_kv (B, S, kv_lora) and k_rope
(B, S, qk_rope).  ``length`` is a host int (the filled prefix).  A step
writes its entries into the cache's tensors in place at ``length`` and
returns the cache with the new length; past ``S`` it raises (the
reference's ``dynamic_update_slice`` would clamp the start and overwrite
the tail).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .common import BlockDef, ModelConfig, ParamSpec, apply_rope, dense, \
    reshape, rmsnorm, rope_freqs

NEG_INF = -1e30


# ----------------------------------------------------------------------
# parameter declarations
# ----------------------------------------------------------------------
def gqa_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    sp = {
        "wq": ParamSpec((d, cfg.q_features), ("embed", "q_features")),
        "wk": ParamSpec((d, cfg.kv_features), ("embed", "kv_features")),
        "wv": ParamSpec((d, cfg.kv_features), ("embed", "kv_features")),
        "wo": ParamSpec((cfg.q_features, d), ("q_features", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((cfg.q_features,), ("q_features",), "zeros")
        sp["bk"] = ParamSpec((cfg.kv_features,), ("kv_features",), "zeros")
        sp["bv"] = ParamSpec((cfg.kv_features,), ("kv_features",), "zeros")
    return sp


def mla_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    sp = {
        "wkv_a": ParamSpec((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                           ("embed", "kv_lora")),
        "kv_norm": ParamSpec((cfg.kv_lora_rank,), ("kv_lora",), "ones"),
        "wk_b": ParamSpec((cfg.kv_lora_rank,
                           cfg.n_heads * cfg.qk_nope_dim),
                          ("kv_lora", "q_features")),
        "wv_b": ParamSpec((cfg.kv_lora_rank,
                           cfg.n_heads * cfg.v_head_dim),
                          ("kv_lora", "q_features")),
        "wo": ParamSpec((cfg.n_heads * cfg.v_head_dim, d),
                        ("q_features", "embed")),
    }
    if cfg.q_lora_rank:
        sp["wq_a"] = ParamSpec((d, cfg.q_lora_rank), ("embed", "kv_lora"))
        sp["q_norm"] = ParamSpec((cfg.q_lora_rank,), ("kv_lora",), "ones")
        sp["wq_b"] = ParamSpec((cfg.q_lora_rank, cfg.n_heads * qk),
                               ("kv_lora", "q_features"))
    else:
        sp["wq"] = ParamSpec((d, cfg.n_heads * qk), ("embed", "q_features"))
    return sp


def cross_param_specs(cfg: ModelConfig) -> dict:
    return gqa_param_specs(dataclasses.replace(cfg, qkv_bias=False))


# ----------------------------------------------------------------------
# blockwise softmax attention (flash-style, in plain tensor ops)
# ----------------------------------------------------------------------
def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: int, chunk_align: int, kv_len_valid: int | None):
    """(Tq, Skv) bool: which keys each query position may attend."""
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    if chunk_align:
        mask &= kv_pos[None, :] >= torch.div(
            q_pos[:, None], chunk_align, rounding_mode="floor") * chunk_align
    if kv_len_valid is not None:
        mask &= kv_pos[None, :] < kv_len_valid
    return mask


def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        kv_chunk: int = 1024, window: int = 0,
                        chunk_align: int = 0, kv_len_valid: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q (B,Tq,H,Dk); k (B,S,KV,Dk); v (B,S,KV,Dv).  ``q_offset``: absolute
    position of q[0].  ``window``: sliding local window; ``chunk_align``:
    llama4 aligned-chunk locality.  ``kv_len_valid`` masks ragged cache
    fill.  Peak score memory is (B,Tq,H,kv_chunk).
    """
    b, tq, h, dk = q.shape
    s_total, kv_heads = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = h // kv_heads
    scale = scale if scale is not None else 1.0 / (dk ** 0.5)
    n_chunks = max(s_total // kv_chunk, 1)
    kc = s_total // n_chunks
    if kc * n_chunks != s_total:
        raise ValueError(f"kv length {s_total} must split into chunks "
                         f"(kv_chunk={kv_chunk})")
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)
    qg = reshape(q, b, tq, kv_heads, groups, dk).float()

    o = torch.zeros((b, tq, kv_heads, groups, dv), dtype=torch.float32,
                    device=dev)
    m = torch.full((b, tq, kv_heads, groups), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, tq, kv_heads, groups), dtype=torch.float32,
                    device=dev)
    for c in range(n_chunks):
        kci = k[:, c * kc:(c + 1) * kc].float()
        vci = v[:, c * kc:(c + 1) * kc].float()
        kv_pos = c * kc + torch.arange(kc, device=dev)
        mask = _mask(q_pos, kv_pos, causal=causal, window=window,
                     chunk_align=chunk_align, kv_len_valid=kv_len_valid)
        s = torch.einsum("btkgd,bskd->btkgs", qg, kci) * scale
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        mc = torch.amax(s, dim=-1)
        p = torch.exp(s - mc[..., None])
        lc = torch.sum(p, dim=-1)
        oc = torch.einsum("btkgs,bskd->btkgd", p, vci)

        m_new = torch.maximum(m, mc)
        a1 = torch.exp(m - m_new)
        a2 = torch.exp(mc - m_new)
        o = o * a1[..., None] + oc * a2[..., None]
        l = l * a1 + lc * a2
        m = m_new
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return _positions_whole(reshape(out, b, tq, h, dv).to(q.dtype))


def _positions_whole(out):
    """Attention over a sequence-sharded cache leaves DTensor's output
    split over the query positions (dim 1); that split is gathered, so a
    product over (B, T) flattens no split inner dim (DTensor's strided
    layout for one reads values back)."""
    if not hasattr(out, "device_mesh") or \
            not any(p.is_shard(1) for p in out.placements):
        return out
    from torch.distributed.tensor import Replicate
    return out.redistribute(out.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in out.placements])


def dense_decode_attention(q, k, v, *, q_pos: int, window: int = 0,
                           chunk_align: int = 0,
                           kv_len_valid: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Single-token decode attention over the whole cache, one flat
    einsum and a softmax (no chunk reshaping)."""
    b, tq, h, dk = q.shape
    assert tq == 1
    s, kv_heads = k.shape[1], k.shape[2]
    groups = h // kv_heads
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / (dk ** 0.5)
    qg = reshape(q, b, kv_heads, groups, dk).float()

    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    kv_pos = torch.arange(s, device=q.device)
    mask = kv_pos <= q_pos
    if window:
        mask &= q_pos - kv_pos < window
    if chunk_align:
        mask &= kv_pos >= (q_pos // chunk_align) * chunk_align
    if kv_len_valid is not None:
        mask &= kv_pos < kv_len_valid
    sc = torch.where(mask[None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return reshape(o, b, 1, h, dv).to(q.dtype)


# ----------------------------------------------------------------------
# GQA block (prefill + decode)
# ----------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S, KV, D)
    v: torch.Tensor
    length: int       # filled prefix (host int: no readback a layer)


def _impl_kwargs(blk: BlockDef) -> dict:
    if blk.attn_impl == "local":
        return {"window": blk.window}
    if blk.attn_impl == "chunked":
        return {"chunk_align": blk.window}
    return {}


def _write(buf: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``buf[:, start:start + T] = new`` (cast), raising past its end."""
    t, max_len = new.shape[1], buf.shape[1]
    if start + t > max_len:
        raise ValueError(f"KV cache full: {start} + {t} positions past "
                         f"max_len {max_len}")
    if hasattr(buf, "device_mesh"):
        _write_placed(buf, start, new)
        return
    buf[:, start:start + t] = new.to(buf.dtype)


def _write_placed(buf, start: int, new) -> None:
    """:func:`_write` into a DTensor cache.  DTensor has no rule for a
    slice assignment into a dim it shards (a cache sharded over
    ``cache_seq``), so each rank writes by hand the new positions that
    fall in its own block of the sequence: ``new`` is laid out as the
    cache is, with its sequence dim whole, and nothing is gathered."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    want = [Replicate() if p.is_shard(1) else p for p in pl]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    nl = new.to(buf.dtype).redistribute(mesh, want).to_local()
    local = buf.to_local()
    # this rank's block of the sequence: split in mesh-dim order
    idx, n = 0, 1
    for i, (p, c) in enumerate(zip(pl, mesh.get_coordinate())):
        if p.is_shard(1):
            idx, n = idx * mesh.size(i) + c, n * mesh.size(i)
    lo = idx * -(-buf.shape[1] // n)
    a, b = max(start, lo), min(start + new.shape[1], lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = nl[:, a - start:b - start]


def gqa_apply(p, cfg: ModelConfig, blk: BlockDef, x: torch.Tensor,
              positions: torch.Tensor, cache: KVCache | None = None,
              cross_kv=None, causal: bool = True,
              constrain=lambda t, a: t):
    """Self-attention of x (B,T,D), or with ``cross_kv = (k, v)``
    cross-attention to them (no rope on the query, no mask, no cache).
    ``causal=False`` is the encoder's.  ``constrain`` lays out q, k and
    v by their logical axes, as the reference does (TP over heads where
    they divide).  Returns (out, new_cache)."""
    b, t, _ = x.shape
    q = reshape(dense(x, p["wq"], p.get("bq")), b, t, cfg.n_heads,
                cfg.head_dim)
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    if cross_kv is None:
        k = reshape(dense(x, p["wk"], p.get("bk")), b, t, cfg.n_kv_heads,
                    cfg.head_dim)
        v = reshape(dense(x, p["wv"], p.get("bv")), b, t, cfg.n_kv_heads,
                    cfg.head_dim)
        k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
        v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
        if blk.rope == "rope":
            cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    else:
        k, v = cross_kv

    new_cache = None
    if cache is not None and cross_kv is None:
        start, max_len = cache.length, cache.k.shape[1]
        _write(cache.k, start, k)
        _write(cache.v, start, v)
        new_cache = KVCache(cache.k, cache.v, start + t)
        if t == 1:
            o = dense_decode_attention(
                q, cache.k, cache.v, q_pos=start, kv_len_valid=start + 1,
                **_impl_kwargs(blk))
        else:
            o = blockwise_attention(
                q, cache.k, cache.v, causal=True, q_offset=start,
                kv_chunk=min(1024, max_len), kv_len_valid=start + t,
                **_impl_kwargs(blk))
    else:
        o = blockwise_attention(
            q, k, v, causal=cross_kv is None and causal, q_offset=0,
            kv_chunk=min(1024, max(k.shape[1], 1)), **_impl_kwargs(blk))
    out = dense(reshape(o, b, t, cfg.q_features), p["wo"])
    return out, new_cache


def gqa_init_cache(cfg: ModelConfig, blk: BlockDef, batch: int,
                   max_len: int, dtype: torch.dtype, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


# ----------------------------------------------------------------------
# MLA block (deepseek-v2): latent-space MQA through the same flash path
# ----------------------------------------------------------------------
class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S, kv_lora)
    k_rope: torch.Tensor   # (B, S, qk_rope)
    length: int            # filled prefix (host int)


def mla_apply(p, cfg: ModelConfig, blk: BlockDef, x: torch.Tensor,
              positions: torch.Tensor, cache: MLACache | None = None):
    """Causal MLA of x (B,T,D) in the weight-absorbed form.  Returns
    (out, new_cache)."""
    b, t, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(dense(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = reshape(dense(cq, p["wq_b"]), b, t, cfg.n_heads, qk)
    else:
        q = reshape(dense(x, p["wq"]), b, t, cfg.n_heads, qk)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    cos, sin = rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = dense(x, p["wkv_a"])
    c_kv = rmsnorm(ckv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., cfg.kv_lora_rank:][..., None, :], cos,
                        sin)[..., 0, :]

    if cache is not None:
        start = cache.length
        _write(cache.c_kv, start, c_kv)
        _write(cache.k_rope, start, k_rope)
        new_cache = MLACache(cache.c_kv, cache.k_rope, start + t)
        c_all, r_all = cache.c_kv, cache.k_rope
        kv_valid, q_off = start + t, start
    else:
        new_cache = None
        c_all, r_all = c_kv, k_rope
        kv_valid, q_off = None, 0

    # absorbed: q_eff = [q_nope W_kb, q_rope]; k_eff = [c_kv, k_rope]
    wkb = reshape(p["wk_b"], cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_dim)
    q_abs = torch.einsum("bthd,rhd->bthr", q_nope.float(),
                         wkb.float()).to(x.dtype)
    q_eff = torch.cat([q_abs, q_rope], dim=-1)            # (B,T,H,r+rope)
    k_eff = torch.cat([c_all, r_all], dim=-1)[:, :, None, :]
    v_eff = c_all[:, :, None, :]                          # (B,S,1,r)

    if t == 1 and cache is not None:
        lat = dense_decode_attention(
            q_eff, k_eff, v_eff, q_pos=q_off, kv_len_valid=kv_valid,
            scale=1.0 / (qk ** 0.5))                      # (B,1,H,r)
    else:
        lat = blockwise_attention(
            q_eff, k_eff, v_eff, causal=True, q_offset=q_off,
            kv_chunk=min(1024, k_eff.shape[1]), kv_len_valid=kv_valid,
            scale=1.0 / (qk ** 0.5))                      # (B,T,H,r)

    wvb = reshape(p["wv_b"], cfg.kv_lora_rank, cfg.n_heads, cfg.v_head_dim)
    o = torch.einsum("bthr,rhd->bthd", lat.float(), wvb.float()).to(x.dtype)
    out = dense(reshape(o, b, t, cfg.n_heads * cfg.v_head_dim), p["wo"])
    return out, new_cache


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                           device=device),
        length=0)
