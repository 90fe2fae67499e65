"""Per-slot ring KV caches for batched decode (port of the GQA and MLA
parts of ``repro.serve.kvcache``, and its slot resets for every cache kind,
the RWKV6 and Mamba2 recurrent states and the Zamba2 hybrid's unstacked
shared-block rings included).

``pos``/``length`` have shape ``(B,)``: every slot of a continuous-batching
engine advances its own ring.  Update ops take a whole token chunk
``(B, C, ...)`` with a per-slot valid count ``n_tokens: (B,)``.

Unlike the reference's pure functions, the port writes in place: the ring
buffers (``k``, ``v``, MLA's ``c_kv`` and ``k_rope``, and int8 scales) are
updated in their storage, and
:func:`reset_slots` zeroes rows in place, so a decode step never copies a
cache.  ``cache_update`` and ``mla_cache_update`` return a new dict holding the same
buffers and new ``pos``/``length`` tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import ModelConfig

# un-stacked rank of every cache leaf: the batch axis of a leaf sits at
# ``ndim - rank`` (leaves may carry leading layer-stack axes); a copy of
# ``repro.topology.partitioning.CACHE_LEAF_RANKS``
CACHE_LEAF_RANKS = {
    "k": 4, "v": 4, "k_scale": 4, "v_scale": 4,
    "c_kv": 3, "k_rope": 3, "c_kv_scale": 3, "k_rope_scale": 3,
    "conv": 3, "ssm": 4, "wkv": 4, "tm_x": 2, "cm_x": 2,
    "pos": 1, "length": 1,
}


def quant(x: torch.Tensor):
    """absmax int8 over the last axis.  Returns (q, scale); ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def _ring_write(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor,
                n: torch.Tensor) -> torch.Tensor:
    """Write a token chunk into a per-slot ring buffer, in place.

    buf: (B, cap, ...), val: (B, C, ...), pos/n: (B,).  Row ``b`` writes its
    first ``n[b]`` chunk tokens at slots ``(pos[b] + t) % cap``; when
    ``n[b] > cap`` only the last ``cap`` of them land (last write wins).
    The reference scatters with ``mode="drop"`` to discard invalid lanes;
    torch has no drop mode, so invalid lanes write back the value the slot
    already holds.  That is exact while ``C <= cap`` (the lanes of a row
    then hit distinct slots); a wider chunk is written lane by lane, in
    order.  No host synchronisation either way.  Returns ``buf``.
    """
    B, cap = buf.shape[:2]
    C = val.shape[1]
    dev = buf.device
    t = torch.arange(C, device=dev)[None, :]
    n = n.long()[:, None]
    wpos = torch.remainder(pos.long()[:, None] + t, cap)            # (B,C)
    valid = (t < n) & (t >= n - cap)                                 # (B,C)
    rows = torch.arange(B, device=dev)[:, None].expand(B, C)
    val = val.to(buf.dtype)
    tail = (1,) * (buf.dim() - 2)
    if C <= cap:
        keep = buf[rows, wpos]
        buf[rows, wpos] = torch.where(valid.view(B, C, *tail), val, keep)
        return buf
    for i in range(C):
        r, w = rows[:, i], wpos[:, i]
        buf[r, w] = torch.where(valid[:, i].view(B, *tail), val[:, i], buf[r, w])
    return buf


def attn_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    K, hd = cfg.num_kv_heads, cfg.head_dim
    c = {
        "k": torch.zeros((batch, capacity, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, K, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros((batch, capacity, K, 1), dtype=torch.float32,
                                  device=device)
    return c


def _n_tokens(n: Optional[torch.Tensor], B: int, C: int, device):
    if n is None:
        return torch.full((B,), C, dtype=torch.int32, device=device)
    return n.to(torch.int32)


def cache_update(cfg: ModelConfig, cache: Dict, k, v,
                 n_tokens: Optional[torch.Tensor] = None) -> Dict:
    """Insert a chunk's k, v (B,C,K,hd) at each row's own ring offset (in
    place); rows with ``n_tokens == 0`` are left untouched.  Returns a dict
    with the same buffers and the advanced ``pos``/``length``."""
    cap = cache["k"].shape[1]
    n = _n_tokens(n_tokens, k.shape[0], k.shape[1], k.device)
    pos = cache["pos"]
    if cache["k"].dtype == torch.int8:
        kq, ks = quant(k)
        vq, vs = quant(v)
        _ring_write(cache["k"], kq, pos, n)
        _ring_write(cache["v"], vq, pos, n)
        _ring_write(cache["k_scale"], ks, pos, n)
        _ring_write(cache["v_scale"], vs, pos, n)
    else:
        _ring_write(cache["k"], k, pos, n)
        _ring_write(cache["v"], v, pos, n)
    return dict(cache, pos=pos + n,
                length=torch.clamp(cache["length"] + n, max=cap))


def cache_kv(cfg: ModelConfig, cache: Dict):
    """Attendable (k, v): int8 caches are dequantized to bf16, as in the
    reference's dense path."""
    if cache["k"].dtype == torch.int8:
        return (dequant(cache["k"], cache["k_scale"]).to(torch.bfloat16),
                dequant(cache["v"], cache["v_scale"]).to(torch.bfloat16))
    return cache["k"], cache["v"]


def mla_cache(cfg: ModelConfig, batch: int, capacity: int,
              dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The MLA compressed-latent ring: ``c_kv (B,cap,kv_lora_rank)`` and the
    shared ``k_rope (B,cap,qk_rope_head_dim)``; an int8 cache quantizes each
    half on its own, with ``c_kv_scale`` and ``k_rope_scale (B,cap,1)``."""
    c = {
        "c_kv": torch.zeros((batch, capacity, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, capacity, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("c_kv_scale", "k_rope_scale"):
            c[name] = torch.zeros((batch, capacity, 1), dtype=torch.float32,
                                  device=device)
    return c


def mla_cache_update(cache: Dict, c_kv_t, k_rope_t,
                     n_tokens: Optional[torch.Tensor] = None) -> Dict:
    """Insert a chunk's latent ``c_kv_t (B,C,kvr)`` and ``k_rope_t
    (B,C,rope)`` at each row's own ring offset (in place); rows with
    ``n_tokens == 0`` are left untouched.  Returns a dict with the same
    buffers and the advanced ``pos``/``length``."""
    cap = cache["c_kv"].shape[1]
    n = _n_tokens(n_tokens, c_kv_t.shape[0], c_kv_t.shape[1], c_kv_t.device)
    pos = cache["pos"]
    if cache["c_kv"].dtype == torch.int8:
        q1, s1 = quant(c_kv_t)
        q2, s2 = quant(k_rope_t)
        _ring_write(cache["c_kv"], q1, pos, n)
        _ring_write(cache["k_rope"], q2, pos, n)
        _ring_write(cache["c_kv_scale"], s1, pos, n)
        _ring_write(cache["k_rope_scale"], s2, pos, n)
    else:
        _ring_write(cache["c_kv"], c_kv_t, pos, n)
        _ring_write(cache["k_rope"], k_rope_t, pos, n)
    return dict(cache, pos=pos + n,
                length=torch.clamp(cache["length"] + n, max=cap))


def write_positions(cache, new) -> None:
    """Copy the advanced ``pos``/``length`` of ``new`` (the tuple of
    per-segment dicts that :func:`repro_torch.models.transformer.decode`
    returns) into ``cache``'s own tensors, which then keep their addresses
    (a CUDA graph replays the addresses it captured)."""
    for seg, nxt in zip(cache, new):
        for name in ("pos", "length"):
            if name in seg and nxt[name] is not seg[name]:
                seg[name].copy_(nxt[name])


def _reset(cache: Any, rows: torch.Tensor) -> Any:
    """Zero, in place, the rows of every leaf where ``rows: (B,)`` is True."""
    for name, leaf in _leaves(cache):
        bax = leaf.dim() - CACHE_LEAF_RANKS.get(name, leaf.dim())
        if leaf.dim() == 0 or not 0 <= bax < leaf.dim():
            continue
        shape = [1] * leaf.dim()
        shape[bax] = leaf.shape[bax]
        leaf.masked_fill_(rows.view(shape), 0)
    return cache


def reset_slots(cache: Any, mask) -> Any:
    """Zero the cache rows of every slot where ``mask: (B,)`` is True, in
    place: per-slot ``pos``/``length`` restart at 0 and the ring rows and
    RWKV6 and Mamba2 recurrent states are wiped (a leaf's batch axis is
    read off ``CACHE_LEAF_RANKS``, so stacked and unstacked leaves alike).  Works on one layer's dict, a
    layer-stacked dict, or the tuple of
    :func:`repro_torch.models.transformer.init_cache`.  Returns ``cache``."""
    _, dev = _batch_axis(cache)
    return _reset(cache, torch.as_tensor(mask, dtype=torch.bool, device=dev))


def reset_slot(cache: Any, i: int) -> Any:
    """Zero batch slot ``i``'s cache rows, in place."""
    B, dev = _batch_axis(cache)
    return _reset(cache, torch.arange(B, device=dev) == i)


def _leaves(cache: Any):
    """(name, tensor) of every leaf of a cache dict or tuple of dicts."""
    if isinstance(cache, (tuple, list)):
        for c in cache:
            yield from _leaves(c)
        return
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf)
        else:
            yield name, leaf


def _batch_axis(cache: Any):
    """(batch size, device) read off the first leaf ``CACHE_LEAF_RANKS``
    places: any cache kind, with or without ``pos``."""
    for name, leaf in _leaves(cache):
        rank = CACHE_LEAF_RANKS.get(name)
        if rank is not None and leaf.dim() >= rank:
            return leaf.shape[leaf.dim() - rank], leaf.device
    raise ValueError("the cache has no leaf with a batch axis")
