"""The launch arithmetic of the port's redesigned kernels, which the CUDA
sources repeat and the CPU cannot run: ``ring_decode``'s grid, its split of
each row's resident tiles and its shared-memory size, ``flash_attention``'s
bf16 grid (rows s·g + j of one KV group per block, causal blocks longest
first) and shared-memory size, and ``lora_matmul``'s route, tile width,
persistent schedule and shared-memory size; ``wkv6``'s grid, chunks,
shared memory and blocks an SM.

Resident tiles are checked against the residency mask itself
(``ring_slot_positions``, the plain versions' mask); the flash grid
against the visible (query, key) pairs of each row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import ring_decode as rd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.models.attention_core import ring_slot_positions  # noqa: E402

H100_SMS = 132


def _states(cap):
    """(pos, length) pairs: empty, partial, exactly full, wrapped at several
    offsets, far past the capacity."""
    out = [(0, 0), (1, 1), (cap, cap), (cap + 1, cap), (2 * cap + 7, cap),
           (5 * cap - 3, cap)]
    out += [(p, min(p, cap)) for p in (3, cap // 2, cap - 1, cap + cap // 3)]
    return out


@pytest.mark.parametrize("cap", [1, 63, 64, 65, 100, 256, 1000, 1024])
def test_ring_resident_tiles_are_the_tiles_holding_resident_slots(cap):
    for pos, length in _states(cap):
        _, resident = ring_slot_positions(torch.tensor([pos]),
                                          torch.tensor([length]), cap)
        slots = np.flatnonzero(resident[0].numpy())
        want = sorted(set((slots // rd.TILE).tolist()))
        got = rd.resident_tiles(pos, length, cap)
        assert len(got) == len(set(got)), (pos, length, got)
        assert sorted(got) == want, (pos, length)


@pytest.mark.parametrize("cap", [64, 100, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("nsplit", [1, 2, 4, 9])
def test_ring_splits_cover_each_resident_tile_once(cap, nsplit):
    """Every resident tile is walked by exactly one split; each split that
    walks any walks at least MIN_TILES where the ring holds that many."""
    for pos, length in _states(cap):
        tiles = rd.resident_tiles(pos, length, cap)
        shares = [rd.split_tiles(pos, length, cap, nsplit, s)
                  for s in range(nsplit)]
        walked = [t for sh in shares for t in sh]
        assert sorted(walked) == sorted(tiles), (pos, length)
        busy = [sh for sh in shares if sh]
        assert len(busy) <= max(1, len(tiles) // rd.MIN_TILES)
        if len(tiles) >= rd.MIN_TILES:
            assert all(len(sh) >= rd.MIN_TILES for sh in busy), (pos, length)


@pytest.mark.parametrize("B,C,H,K,cap,route,want", [
    (8, 1, 32, 8, 1024, "narrow", (1, 4)),   # Llama decode: 256 blocks
    (8, 1, 32, 8, 1024, "keys", (1, 4)),     # the same on an fp32 cache
    (8, 4, 32, 8, 1024, "narrow", (1, 4)),   # 16 rows: one narrow group
    (8, 16, 32, 8, 1024, "tensor", (1, 4)),  # prefill chunk, tensor cores
    (8, 16, 32, 8, 1024, "rows", (2, 4)),    # fp32 chunk, CUDA cores
    (8, 1, 32, 8, 64, "keys", (1, 1)),       # one-tile ring: one split
    (8, 16, 32, 8, 64, "tensor", (1, 1)),
    (8, 16, 32, 8, 200, "tensor", (1, 1)),   # 4 tiles (last ragged): one split
    (8, 16, 32, 8, 256, "rows", (2, 1)),
    (1, 1, 32, 8, 8192, "keys", (1, 32)),    # long ring: 32 splits of 4 tiles
    (2, 3, 32, 8, 1000, "tensor", (1, 4)),   # 12 rows: one group
    (8, 1, 64, 8, 1024, "keys", (1, 4)),     # g 8 at C 1: 8 rows
    (8, 16, 128, 1, 1024, "rows", (64, 2)),  # MQA, 2048 rows: 64 groups
])
def test_ring_plan(B, C, H, K, cap, route, want):
    groups, nsplit = rd.plan(B, C, H, K, cap, H100_SMS, route)
    assert (groups, nsplit) == want
    per = rd.GROUP_ROWS[route]
    assert (groups - 1) * per < H // K * C <= groups * per
    if -(-cap // rd.TILE) < 2 * rd.MIN_TILES:
        assert nsplit == 1      # one block per (b, kv head, row group)


def test_ring_route():
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert [rd.route(bf, bf, r) for r in (1, 16, 17, 64)] == [
        "narrow", "narrow", "tensor", "tensor"]
    assert [rd.route(f32, f32, r) for r in (1, 8, 9, 64)] == [
        "keys", "keys", "rows", "rows"]
    assert rd.route(f32, bf, 64) == "rows"           # fp32 queries
    assert rd.route(bf, i8, 64) == "rows"            # int8 cache
    assert rd.route(f32, i8, 4) == "keys"


@pytest.mark.parametrize("hd", rd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("route", ["keys", "rows", "narrow", "tensor"])
def test_ring_smem_fits(hd, dtype, route):
    """The ring of tiles (2–4 stages, in the padded tile width), the reused
    partial-state area and the queries stay within the 227 KB a block may
    use, with at least two stages and, for 16-bit and 8-bit caches on the
    load-bound routes, at least three; route "rows" leaves room for two
    blocks an SM.  Every head dim the kernel takes is checked."""
    es = torch.empty((), dtype=dtype).element_size()
    w = rd.padded_hd(hd)                 # the tile width hd runs in
    stage = 2 * rd.TILE * (w * es + 16) + (2 * rd.TILE * 4 if es == 1 else 0)
    budget = rd.ROWS_RING_BUDGET if route == "rows" else rd.RING_BUDGET
    stages = min(4, max(2, budget // stage))
    assert stages >= (3 if es < 4 and route != "rows" else 2)
    assert rd.smem_bytes(hd, dtype, route) <= rd.SMEM_LIMIT
    if route == "rows" and w <= 64:
        assert 2 * rd.smem_bytes(hd, dtype, route) <= rd.SMEM_LIMIT


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_smem_fits(hd):
    assert fa.bf16_smem_bytes(hd) <= fa.SMEM_LIMIT


@pytest.mark.parametrize("B,S,T,H,K,causal,window", [
    (4, 512, 512, 32, 8, True, 0),      # the train step
    (4, 512, 512, 32, 8, True, 128),
    (2, 500, 500, 32, 8, True, 0),      # S not a multiple of 64
    (1, 77, 77, 8, 1, False, 0),        # g 8, non-causal
    (2, 200, 333, 16, 2, True, 0),      # T > S
    (1, 130, 130, 24, 8, True, 20),     # g 3: positions split across blocks
    (1, 64, 64, 8, 8, True, 1000),      # g 1, window longer than S
    (1, 300, 300, 6, 3, True, 5),       # g 2, window shorter than a tile
])
def test_flash_blocks_cover_rows_and_visible_keys(B, S, T, H, K, causal, window):
    """Every row s·g + j of every (b, KV head) lies in exactly one block;
    each block's key tiles hold every key its rows see; causal grids start
    with the blocks that walk the most tiles."""
    g = H // K
    seen = np.zeros((B, K, S * g), np.int32)
    blocks = fa.bf16_blocks(B, S, T, H, K, causal, window)
    for b, kh, m0, t_begin, n_tiles in blocks:
        rows = np.arange(m0, min(m0 + fa.ROWS_PER_BLOCK, S * g))
        seen[b, kh, rows] += 1
        s = rows // g
        hi = np.minimum(T, s + 1) if causal else np.full_like(s, T)
        lo = np.maximum(0, s - window + 1) if window else np.zeros_like(s)
        vis = hi > lo
        assert (lo[vis] >= t_begin).all()
        assert (hi[vis] <= t_begin + n_tiles * fa.KEYS_PER_TILE).all()
    assert (seen == 1).all()
    if causal and not window:
        tiles = [blk[4] for blk in blocks]
        assert tiles == sorted(tiles, reverse=True)


# -- lora_matmul's wgmma route: route, tile width, persistent schedule ------

@pytest.mark.parametrize("din,dout,dtype,want", [
    (2048, 2048, torch.bfloat16, "wgmma"),    # the main paths' shapes
    (2048, 512, torch.bfloat16, "wgmma"),
    (2048, 1000, torch.bfloat16, "wgmma"),    # dout ragged against the tile
    (2048, 1003, torch.bfloat16, "wmma"),     # no TMA stride for 1003 columns
    (2044, 2048, torch.bfloat16, "wmma"),
    (16, 8, torch.bfloat16, "wgmma"),
    (2048, 2048, torch.float32, "fp32"),
])
def test_lora_route(din, dout, dtype, want):
    assert lm.route(din, dout, dtype) == want


@pytest.mark.parametrize("M,dout,r,bn,grid", [
    (2048, 2048, 16, 256, 128),    # train step wq/wo, RWKV6 targets: one wave
    (2048, 2048, 4, 256, 128),
    (2048, 2048, 32, 128, 132),    # ranks above 16 take at most 128 columns
    (2048, 512, 16, 64, 128),      # train step wk/wv: 64 tiles at 128 wide
    (2048, 512, 32, 64, 128),
    (8192, 2048, 16, 256, 132),    # RWKV6 prefill: 512 tiles, 3.9 waves
    (2048, 2048, 64, 128, 132),
    (2048, 2048, 128, 128, 132),
    (1999, 1000, 7, 128, 128),
])
def test_lora_tile_per_main_shape(M, dout, r, bn, grid):
    p = lm.plan(M, 2048, dout, r, torch.bfloat16, H100_SMS)
    assert (p["route"], p["bn"], p["grid"]) == ("wgmma", bn, grid)
    assert p["tiles"] == -(-M // lm.TILE_M) * -(-dout // bn)
    assert p["stages"] >= 3


@pytest.mark.parametrize("M,dout,bn,grid", [
    (2048, 2048, 256, 128), (8192, 2048, 256, 132), (2048, 512, 64, 128),
    (1999, 1000, 128, 128), (300, 520, 64, 45), (129, 8, 64, 2),
    (8192, 2048, 128, 132), (5000, 3000, 128, 132), (128, 64, 64, 1)])
def test_lora_schedule_covers_every_tile_once(M, dout, bn, grid):
    """The persistent grid's grouped raster visits every output tile exactly
    once, and the blocks' shares differ by at most one tile."""
    shares = lm.schedule(M, dout, bn, grid)
    tiles = [t for share in shares for t in share]
    want = {(m, n) for m in range(0, M, lm.TILE_M) for n in range(0, dout, bn)}
    assert len(tiles) == len(want) and set(tiles) == want
    sizes = [len(share) for share in shares]
    assert max(sizes) - min(sizes) <= 1


def test_lora_raster_groups_tile_rows():
    """Blocks in flight together share x rows and W columns in L2: on a
    64 × 64-tile grid the first wave's 132 tiles touch 8 tile rows and 17
    tile columns (25 tiles of operands), where a row-major order would
    touch 3 rows and all 64 columns (67)."""
    first = [lm.tile_origin(t, 64, 64, 256) for t in range(H100_SMS)]
    assert len(set(first)) == H100_SMS
    assert {m // lm.TILE_M for m, _ in first} == set(range(lm.GROUP_M))
    assert {n // 256 for _, n in first} == set(range(17))


@pytest.mark.parametrize("rp", lm.RANK_PADS)
@pytest.mark.parametrize("bn", lm.TILE_NS)
def test_lora_smem_fits(bn, rp):
    """Every (tile width, padded rank) the plan may choose keeps three or
    four stages within the 227 KB a block may use; 256 columns are left to
    ranks of 16 and below."""
    if bn in lm.tile_widths(rp):
        assert 3 <= lm.stages(bn, rp) <= lm.MAX_STAGES
        assert lm.smem_bytes(bn, rp) <= lm.SMEM_LIMIT
    else:
        assert bn == 256 and rp > 16


# -- wkv6: one block per (b, h), chunks of 16, two prepared chunks in flight --

@pytest.mark.parametrize("dtype,H,hd,want_per_sm", [
    (torch.bfloat16, 32, 64, 2),    # RWKV6-1.6B prefill: 256 blocks
    (torch.float32, 32, 64, 2),     # the fp32 parity route
    (torch.bfloat16, 64, 32, 4),    # the SMOKE config's head dim: 512 blocks
    (torch.float32, 64, 32, 4),
])
def test_wkv6_plan_runs_the_main_shapes_in_one_wave(dtype, H, hd, want_per_sm):
    """At B 8, S 1024 every (b, h) block is resident at once on 132 SMs:
    two blocks an SM fit 227 KB of shared memory (232,448 bytes a block, an
    SM's 233,472 with 1 KB reserved per block) at hd 64, four at hd 32."""
    p = wk.plan(8, 1024, H, hd, dtype, H100_SMS)
    assert (p.grid, p.threads, p.chunks) == (8 * H, 3 * hd, 1024 // wk.CHUNK)
    assert p.blocks_per_sm == want_per_sm
    assert want_per_sm * (p.smem + wk.BLOCK_RESERVED_BYTES) <= wk.SM_SHARED_BYTES
    assert p.smem <= wk.MAX_BLOCK_SHARED_BYTES
    assert p.waves == 1


@pytest.mark.parametrize("hd,dtype,built", [
    (64, torch.bfloat16, 95232), (64, torch.float32, 113664),
    (32, torch.bfloat16, 52992), (32, torch.float32, 54016),
])
def test_wkv6_smem_matches_the_built_structs(hd, dtype, built):
    """``sizeof(Smem<hd, T>)`` as the kernel built on the H100 reports it
    (``wkv6_smem_bytes``; chip_smoke.py checks the two agree on the card)."""
    assert wk.smem_bytes(hd, torch.tensor([], dtype=dtype).element_size()) == built


@pytest.mark.parametrize("S", [1, 15, 16, 17, 200, 257, 1024])
def test_wkv6_chunks_cover_the_sequence_once(S):
    """Chunks of 16 tokens: the last may be ragged (masked in the kernel),
    and none starts past S."""
    n = wk.plan(2, S, 4, 64, torch.bfloat16).chunks
    assert (n - 1) * wk.CHUNK < S <= n * wk.CHUNK


@pytest.mark.parametrize("hd", [16, 48, 128])
def test_wkv6_plan_refuses_other_head_dims(hd):
    with pytest.raises(ValueError, match=r"the kernel takes \(32, 64\)"):
        wk.plan(1, 16, 1, hd, torch.float32)
