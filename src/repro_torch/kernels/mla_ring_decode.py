"""Launch of the MLA latent flash-decoding CUDA kernel
(``csrc/mla_ring_decode.cu``), the Hopper counterpart of
``repro.kernels.mla_ring_decode.mla_ring_decode_kernel``.

The latent cache is passed in its ``(B, cap, kvr)`` / ``(B, cap, rope)``
layout with its strides; the kernel masks the ragged last slot tile itself,
so no padded copy of the cache is made.  :func:`route` picks the kernel's
route: ``"wgmma"`` for a bf16 cache at 512 + 64 (the MLA engine's path; 64
query rows a block, the ring's resident tiles split over a cluster that
merges through distributed shared memory), ``"mma"`` for every other case,
where the wrapper splits the ring's slot tiles across blocks and allocates
the fp32 partials that a second kernel merges (:func:`launches`).  Route
``"mma"`` takes every latent width that is a multiple of 16 up to 512 with every RoPE width that is a multiple of 16
up to 64, each run in the first of ``PADDED_WIDTHS`` that holds it
(:func:`padded_widths`).  :func:`splits`, :func:`split_tiles`,
:func:`block_rows` and :func:`smem_bytes` mirror the launch arithmetic;
:func:`mla_split_plain` replicates route ``"wgmma"``'s arithmetic for the
CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

# the (latent, rope) widths the kernel is built for: its 576-wide key is
# split over 8 warps in 8-column steps, so the sum is a multiple of 64
PADDED_WIDTHS = ((32, 32), (64, 64), (128, 64), (256, 64), (512, 64))
WIDTHS_TAKEN = ("a latent width that is a multiple of 16 up to 512 and a "
                "RoPE width that is a multiple of 16 up to 64")
TILE = 32                 # latent slots per tile (kBK / kWBK in the source)
ROWS_PER_BLOCK = {"mma": 32, "wgmma": 64}   # query rows (t, h) a block
BLOCKS_PER_SM = 2         # route "mma"'s split target
SPLIT_MAX = 8             # route "wgmma": splits of a row block, one cluster
WGMMA_WIDTHS = (512, 64)  # route "wgmma"'s (latent, rope)
Q_PARTS = 2               # route "wgmma": bf16 parts of each query element
STAGES = 2                # route "wgmma": slot tiles in flight
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ROUTE_CODES = {"mma": 0, "wgmma": 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mla_ring_decode kernel: {msg}")


def padded_widths(kvr: int, rope: int):
    """The (latent, rope) widths the kernel runs ``(kvr, rope)`` in: the
    first of ``PADDED_WIDTHS`` that holds both (DeepSeek-V3's 512 + 64 as
    they are; its SMOKE config's 32 + 16 in 32 + 32).  Raises
    ``ValueError`` outside ``WIDTHS_TAKEN``."""
    _check(kvr % 16 == 0 and 16 <= kvr <= 512 and rope % 16 == 0
           and 16 <= rope <= 64,
           f"latent widths ({kvr}, {rope}); the kernel takes {WIDTHS_TAKEN}")
    return next(p for p in PADDED_WIDTHS if p[0] >= kvr and p[1] >= rope)


def route(kv_dtype, kvr: int, rope: int) -> str:
    """``"wgmma"`` for a bf16 cache at ``WGMMA_WIDTHS`` (DeepSeek-V3's 512 +
    64, the MLA engine's path); ``"mma"`` for every other cache dtype and
    width (fp32, int8, the SMOKE config's 32 + 16)."""
    if kv_dtype == torch.bfloat16 and (kvr, rope) == WGMMA_WIDTHS:
        return "wgmma"
    return "mma"


def row_blocks(C: int, H: int, route_: str) -> int:
    """Blocks of ``ROWS_PER_BLOCK[route_]`` query rows (t·H + h) a batch
    row takes."""
    return -(-(C * H) // ROWS_PER_BLOCK[route_])


def block_rows(C: int, H: int, route_: str, blk: int):
    """The ``(t, h)`` rows block ``blk`` of a batch row serves."""
    rows = ROWS_PER_BLOCK[route_]
    return [(r // H, r % H)
            for r in range(blk * rows, min(C * H, (blk + 1) * rows))]


def resident_tiles(pos: int, length: int, cap: int):
    """The tiles of ``TILE`` slots holding a row's resident slots, in route
    ``"wgmma"``'s order (the ring interval of ``length`` slots from ``(pos -
    length) mod cap``, then its wrapped part), each once."""
    if length <= 0:
        return []
    start = (pos - length) % cap
    a0, a1 = start // TILE, (min(start + length, cap) - 1) // TILE
    nb = min((start + length - cap - 1) // TILE + 1, a0) if start + length > cap else 0
    return list(range(a0, a1 + 1)) + list(range(nb))


def active_splits(pos: int, length: int, cap: int, nsplit: int) -> int:
    """The splits of a row's cluster that walk tiles on route ``"wgmma"``:
    one a resident tile at most, one at least.  With one, split 0
    normalises in-block and the others leave at once."""
    return max(1, min(nsplit, len(resident_tiles(pos, length, cap))))


def split_tiles(pos: int, length: int, cap: int, nsplit: int, split: int):
    """The resident tiles block ``split`` of a cluster walks on route
    ``"wgmma"``: :func:`active_splits` contiguous shares; a split past that
    count walks none."""
    tiles = resident_tiles(pos, length, cap)
    ne = active_splits(pos, length, cap, nsplit)
    if split >= ne:
        return []
    return tiles[split * len(tiles) // ne:(split + 1) * len(tiles) // ne]


def smem_bytes(route_: str, kvr: int = 512, rope: int = 64) -> int:
    """Dynamic shared memory of one block.  ``"wgmma"``: the query rows'
    bf16 parts (``Q_PARTS`` × 64 rows × 576), ``STAGES`` slot tiles of
    [c_kv | k_rope] in bf16, barriers, the merge's (m, l), the exchange of
    one warpgroup's partial scores (64 × 32 fp32; after the last tile the
    merge's weights) and 1 KB of alignment slack; the merge's fp32 O (64 ×
    520) reuses the query space.
    ``"mma"``: two fp32 tiles of 32 rows (queries, slots) at the padded
    width, the warps' partial scores and probabilities, row state."""
    if route_ == "wgmma":
        dq = sum(WGMMA_WIDTHS)
        q = Q_PARTS * ROWS_PER_BLOCK["wgmma"] * dq * 2
        assert ROWS_PER_BLOCK["wgmma"] * (WGMMA_WIDTHS[0] + 8) * 4 <= q
        exchange = 2 * 64 * TILE * 4 // 2     # one warpgroup's half of S, fp32
        return (q + STAGES * TILE * dq * 2 + 64 + ROWS_PER_BLOCK["wgmma"] * 8
                + exchange + 1024)
    lat, rp = padded_widths(kvr, rope)
    rows = ROWS_PER_BLOCK["mma"]
    return 4 * (2 * rows * (lat + rp + 4) + 9 * rows * (TILE + 4) + 3 * rows)


def mla_ring_decode_cuda(q_eff, c_kv, k_rope, pos, length, n_tokens,
                         scale: float, window: int, c_kv_scale=None,
                         k_rope_scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,C,H,kvr) fp32."""
    _check(q_eff.dim() == 4 and c_kv.dim() == 3 and k_rope.dim() == 3,
           f"shapes q{tuple(q_eff.shape)} c_kv{tuple(c_kv.shape)} "
           f"k_rope{tuple(k_rope.shape)}")
    B, C, H, dq = q_eff.shape
    cap, kvr = c_kv.shape[1:]
    rope = k_rope.shape[2]
    _check(c_kv.shape[0] == B and k_rope.shape[:2] == (B, cap)
           and dq == kvr + rope,
           f"q{tuple(q_eff.shape)} does not match the latent cache "
           f"c_kv{tuple(c_kv.shape)} k_rope{tuple(k_rope.shape)}")
    padded_widths(kvr, rope)
    _check(q_eff.dtype == torch.float32, f"query dtype {q_eff.dtype}")
    _check(c_kv.dtype in _KV_CODES and k_rope.dtype == c_kv.dtype,
           f"cache dtypes {c_kv.dtype}/{k_rope.dtype}")
    _check(window >= 0, f"window {window} < 0")
    _check(q_eff.stride(-1) == 1 and c_kv.stride(-1) == 1
           and k_rope.stride(-1) == 1, "q/c_kv/k_rope need a contiguous last axis")
    es = c_kv.element_size()
    _check(all(t.data_ptr() % 16 == 0 for t in (c_kv, k_rope))
           and all(st * es % 16 == 0
                   for st in c_kv.stride()[:2] + k_rope.stride()[:2]),
           "cache rows must start on 16-byte boundaries")
    int8 = c_kv.dtype == torch.int8
    _check(int8 == (c_kv_scale is not None) == (k_rope_scale is not None),
           "int8 caches need c_kv_scale and k_rope_scale, float caches none")
    if int8:
        _check(c_kv_scale.shape == k_rope_scale.shape == (B, cap, 1)
               and c_kv_scale.dtype == k_rope_scale.dtype == torch.float32
               and c_kv_scale.stride() == k_rope_scale.stride(),
               "scales must be fp32 (B,cap,1) with equal strides")
    dev = q_eff.device
    tensors = [c_kv, k_rope, pos, length, n_tokens] + (
        [c_kv_scale, k_rope_scale] if int8 else [])
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "every tensor must be on the same CUDA device")
    q_eff = q_eff.contiguous()            # query rows are read as float4
    pos, length, n_tokens = (t.to(torch.int32).contiguous()
                             for t in (pos, length, n_tokens))
    out = torch.empty((B, C, H, kvr), dtype=torch.float32, device=dev)
    how = route(c_kv.dtype, kvr, rope)
    nsplit, per = splits(B, C, H, cap, dev, how)
    part_o = part_ml = None
    if nsplit > 1 and how == "mma":
        part_o = torch.empty((nsplit, B, C, H, kvr), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((nsplit, B, C, H, 2), dtype=torch.float32,
                              device=dev)
    sc = c_kv_scale.stride()[:2] if int8 else (0, 0)
    err = build.load("mla_ring_decode").mla_ring_decode_launch(
        q_eff.data_ptr(), *q_eff.stride()[:3],
        c_kv.data_ptr(), *c_kv.stride()[:2],
        k_rope.data_ptr(), *k_rope.stride()[:2], _KV_CODES[c_kv.dtype],
        c_kv_scale.data_ptr() if int8 else None,
        k_rope_scale.data_ptr() if int8 else None, *sc,
        pos.data_ptr(), length.data_ptr(), n_tokens.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        B, C, H, kvr, rope, cap, int(window), _ROUTE_CODES[how], nsplit, per,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_ring_decode kernel launch failed: error {err}")
    return out, launches(how, nsplit)


def launches(route_: str, nsplit: int) -> int:
    """Kernels one call launches: route ``"mma"`` with splits adds its
    merge kernel; route ``"wgmma"`` merges (or needs no merge) in its one
    launch."""
    return 2 if route_ == "mma" and nsplit > 1 else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The device's SM count, asked of the driver once per device."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, nsplit: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.load("mla_ring_decode").mla_ring_decode_max_clusters(
            nsplit, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"mla_ring_decode: cluster query failed: error {err}")
    return out.value


def max_clusters(dev: torch.device, nsplit: int) -> int:
    """How many clusters of ``nsplit`` route-``"wgmma"`` blocks the device
    holds at once (the driver's answer, asked once per device and size)."""
    return _max_clusters(dev.index if dev.index is not None
                         else torch.cuda.current_device(), nsplit)


def splits(B: int, C: int, H: int, cap: int, dev, route_: str = "mma",
           fit=None):
    """(nsplit, tiles per split of a full ring) for these shapes.  Route
    ``"mma"``: split the ring's slot tiles across blocks until there are
    about ``BLOCKS_PER_SM`` blocks per SM; with ``nsplit == 1`` the kernel
    normalises in-block and no merge runs.  Route ``"wgmma"`` (one block an
    SM): split each row block's resident tiles over up to ``SPLIT_MAX``
    blocks of one cluster, as many as one wave of blocks holds, then fewer while
    the row blocks' clusters would not all fit on the card at once
    (``fit(nsplit)``, by default :func:`max_clusters`: the H100 holds fewer
    than the 16 clusters of 8 such blocks a C = 1 call needs).  ``dev`` is a
    device (its SM count is cached) or an SM count."""
    sms = dev if isinstance(dev, int) else sm_count(dev)
    blocks = B * row_blocks(C, H, route_)
    tiles = -(-cap // TILE)
    if route_ == "wgmma":
        want = max(1, min(SPLIT_MAX, tiles, sms // blocks))
        fit = fit or functools.partial(max_clusters, dev)
        while want > 1 and fit(want) < blocks:
            want -= 1
        return want, -(-tiles // want)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _bf16_parts(x: torch.Tensor, parts: int):
    """x as ``parts`` bf16 terms (in fp32), each rounding what the earlier
    ones left: hi, lo (, ...)."""
    out, rest = [], x
    for _ in range(parts):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def mla_split_plain(q_eff, c_kv, k_rope, pos, length, n_tokens, scale: float,
                    window: int = 0, nsplit: int = 1) -> torch.Tensor:
    """Route ``"wgmma"``'s arithmetic in plain PyTorch, for tests: the
    fp32 queries as ``Q_PARTS`` bf16 parts against the bf16 cache; the
    ring's resident tiles of ``TILE`` slots in the kernel's order, split
    into ``nsplit`` shares (:func:`split_tiles`); an online softmax per tile
    on base 2 with the scale folded into the exponent; P as a bf16 hi + lo
    pair against ``c_kv``; the shares merged by their (m, l).  Returns
    (B,C,H,kvr) fp32; rows with ``n_tokens == 0`` are zeros."""
    from repro_torch.models.attention_core import ring_attend_mask

    B, C, H, _ = q_eff.shape
    cap, kvr = c_kv.shape[1:]
    c = scale * math.log2(math.e)
    neg = -1e30
    qparts = _bf16_parts(q_eff.float(), Q_PARTS)
    qpos = ((pos - n_tokens).long()[:, None]
            + torch.arange(C, device=q_eff.device)[None, :])
    mask = ring_attend_mask(pos, length, cap, qpos, window)        # (B,C,cap)
    out = torch.zeros((B, C, H, kvr), dtype=torch.float32)
    for b in range(B):
        if int(n_tokens[b]) <= 0:
            continue
        ckv, kr = c_kv[b].float(), k_rope[b].float()
        shares = []
        for sp in range(nsplit):
            m = torch.full((C, H), neg)
            l = torch.zeros((C, H))
            o = torch.zeros((C, H, kvr))
            for t in split_tiles(int(pos[b]), int(length[b]), cap, nsplit, sp):
                sl = slice(t * TILE, min(cap, (t + 1) * TILE))
                s = sum(qp[b, ..., :kvr] @ ckv[sl].T + qp[b, ..., kvr:] @ kr[sl].T
                        for qp in qparts)
                s = torch.where(mask[b, :, None, sl], s, torch.full_like(s, neg))
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - mx) * c)
                mc = torch.where(mx == neg, torch.zeros_like(mx), mx * c)
                p = torch.exp2(s * c - mc[..., None])
                l = l * alpha + p.sum(-1)
                hi, lo = _bf16_parts(p, 2)
                o = o * alpha[..., None] + lo @ ckv[sl] + hi @ ckv[sl]
                m = mx
            shares.append((m, l, o))
        M = torch.stack([s[0] for s in shares]).amax(0)
        L = sum(s[1] * torch.exp2((s[0] - M) * c) for s in shares)
        O = sum(s[2] * (torch.exp2((s[0] - M) * c) / L)[..., None] for s in shares)
        out[b] = O
    return out
