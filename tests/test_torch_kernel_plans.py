"""The launch arithmetic of the port's redesigned kernels, which the CUDA
sources repeat and the CPU cannot run: ``ring_decode``'s grid, its split of
each row's resident tiles and its shared-memory size, ``flash_attention``'s
bf16 grid (rows s·g + j of one KV group per block, causal blocks longest
first) and shared-memory size, and ``lora_matmul``'s route, tile width,
persistent schedule and shared-memory size; ``wkv6``'s grid, chunks,
shared memory and blocks an SM; ``bgmv``'s clusters, din chunks, column
tiles and shared memory; ``mla_ring_decode``'s routes, query-row blocks,
resident-tile splits and shared memory.

Resident tiles are checked against the residency mask itself
(``ring_slot_positions``, the plain versions' mask); the flash grid
against the visible (query, key) pairs of each row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bgmv as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import mla_ring_decode as mla  # noqa: E402
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


# -- bgmv: clusters of 8 share a row's z; chunks of din, tiles of dout --------

BF, F32 = torch.bfloat16, torch.float32
BGMV_DTYPES = [(BF, BF), (F32, F32), (F32, BF), (BF, F32)]
# the serving paths' projections: Llama wq/wo and wk/wv, MLA wq_b, wkv_a, wo
BGMV_SHAPES = [(2048, 2048), (2048, 512), (1536, 24576), (7168, 576),
               (16384, 7168)]


@pytest.mark.parametrize("x_dt,p_dt", BGMV_DTYPES)
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("din,dout", BGMV_SHAPES)
def test_bgmv_din_chunks_cover_din_once(x_dt, p_dt, C, din, dout):
    """The cluster's blocks shrink disjoint chunks of din that together
    cover it once, as evenly as whole chunks allow; at the main shapes'
    rank 16 a block walks at most four chunks."""
    p = bg.plan(C, din, dout, 4, 4, x_dt, p_dt)
    got = sorted(r for q in range(bg.CLUSTER) for r in bg.din_chunks(p, din, q))
    assert got[0][0] == 0 and got[-1][1] == din
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(d1 > d0 for d0, d1 in got)
    assert p.kc % 64 == 0 and p.nchunk == len(got)
    per = [len(bg.din_chunks(p, din, q)) for q in range(bg.CLUSTER)]
    assert max(per) - min(per) <= 1
    assert max(per) <= 4


@pytest.mark.parametrize("dout", [512, 576, 2048, 7168, 24576])
@pytest.mark.parametrize("x_dt,p_dt", BGMV_DTYPES)
@pytest.mark.parametrize("Pmax", [4, 16])
def test_bgmv_column_tiles_cover_dout_once(dout, x_dt, p_dt, Pmax):
    """Tiles of a multiple of 64 columns, at most TILE_MAX, cover dout once
    over the row's CLUSTER·clusters blocks; the last tile of the last
    cluster is the only one that may be short or empty."""
    p = bg.plan(16, 2048, dout, 4, Pmax, x_dt, p_dt)
    assert p.tile_n % 64 == 0 and 64 <= p.tile_n <= bg.TILE_MAX
    tiles = [bg.column_tile(p, dout, blk) for blk in range(bg.CLUSTER * p.clusters)]
    cols = [c for c0, c1 in tiles for c in range(c0, c1)]
    assert cols == list(range(dout))
    # no cluster is all padding
    assert (p.clusters - 1) * bg.CLUSTER * p.tile_n < dout
    assert p.tile_n * 4 * Pmax * torch.empty((), dtype=p_dt).element_size() \
        <= max(bg.B_TILE_BUDGET, 64 * 4 * Pmax * 4)


def test_bgmv_cluster_is_portable():
    assert 1 <= bg.CLUSTER <= 8           # the portable cluster size


@pytest.mark.parametrize("x_dt,p_dt", BGMV_DTYPES)
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("Pmax", [4, 16])
@pytest.mark.parametrize("din,dout", BGMV_SHAPES)
def test_bgmv_smem_fits(x_dt, p_dt, C, Pmax, din, dout):
    """Every dtype pair at C 1 and 16, ranks 16 and 64 (pages of 4), at each
    serving projection: the B tile, two stages, the cluster's partial z's
    and z, and the page ids fit the 227 KB a block may use."""
    p = bg.plan(C, din, dout, 4, Pmax, x_dt, p_dt)
    xe = torch.empty((), dtype=x_dt).element_size()
    pe = torch.empty((), dtype=p_dt).element_size()
    stage = p.x_rows * (p.kc * xe + bg.PAD) + p.r_pad * (p.kc * pe + bg.PAD)
    assert p.smem == (p.tile_n * 4 * Pmax * pe + 2 * stage
                      + (bg.CLUSTER + 1) * p.c_pad * p.r_pad * 4
                      + -(-4 * Pmax // 16) * 16)
    assert p.smem <= bg.SMEM_LIMIT == 232_448
    assert (p.c_pad, p.r_pad) == (16, 4 * Pmax)


def test_bgmv_route():
    assert [bg.route(BF, BF, c) for c in (1, 4, 7, 8, 16)] == [
        "fma", "fma", "fma", "mma", "mma"]
    assert {bg.route(x, p, 16) for x, p in BGMV_DTYPES[1:]} == {"fma"}
    assert bg.plan(16, 2048, 2048, 4, 4, BF, BF).x_rows == 16
    assert bg.plan(3, 2048, 2048, 4, 4, BF, BF).x_rows == 3


def test_bgmv_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bg.plan(4096, 2048, 2048, 4, 16, F32, F32)


# -- mla_ring_decode: 64 query rows a block, splits of the resident tiles -----

@pytest.mark.parametrize("C,H", [(1, 128), (16, 128), (1, 16), (16, 16),
                                 (3, 16), (5, 7)])
@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_mla_blocks_cover_every_row_once(C, H, route):
    blocks = mla.row_blocks(C, H, route)
    rows = [r for blk in range(blocks) for r in mla.block_rows(C, H, route, blk)]
    assert rows == [(t, h) for t in range(C) for h in range(H)]
    assert all(len(mla.block_rows(C, H, route, blk)) == mla.ROWS_PER_BLOCK[route]
               for blk in range(blocks - 1))


@pytest.mark.parametrize("cap", [1, 31, 32, 33, 100, 256, 1000, 1024])
def test_mla_resident_tiles_are_the_tiles_holding_resident_slots(cap):
    for pos, length in _states(cap):
        _, resident = ring_slot_positions(torch.tensor([pos]),
                                          torch.tensor([length]), cap)
        slots = np.flatnonzero(resident[0].numpy())
        want = sorted(set((slots // mla.TILE).tolist()))
        got = mla.resident_tiles(pos, length, cap)
        assert len(got) == len(set(got)), (pos, length, got)
        assert sorted(got) == want, (pos, length)


@pytest.mark.parametrize("cap", [32, 100, 288, 1000, 1024])
@pytest.mark.parametrize("nsplit", [1, 2, 6, 7, 8])
def test_mla_splits_cover_each_resident_tile_once(cap, nsplit):
    """Every resident tile is walked by exactly one split of the cluster;
    the splits that walk any are the first min(nsplit, resident) ones and
    their shares differ by at most one tile."""
    for pos, length in _states(cap):
        tiles = mla.resident_tiles(pos, length, cap)
        shares = [mla.split_tiles(pos, length, cap, nsplit, s)
                  for s in range(nsplit)]
        assert [t for sh in shares for t in sh] == tiles, (pos, length)
        busy = [len(sh) for sh in shares if sh]
        ne = mla.active_splits(pos, length, cap, nsplit)
        assert ne == max(1, min(nsplit, len(tiles)))
        assert len(busy) == min(nsplit, len(tiles))
        assert all(shares[s] for s in range(len(busy)))      # the first ones
        if busy:
            assert max(busy) - min(busy) <= 1


def test_mla_route():
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert mla.route(bf, 512, 64) == "wgmma"      # DeepSeek-V3's bf16 cache
    assert mla.route(i8, 512, 64) == "mma"
    assert mla.route(f32, 512, 64) == "mma"
    assert mla.route(bf, 32, 16) == "mma"         # the SMOKE config's widths
    assert mla.route(bf, 448, 64) == "mma"


@pytest.mark.parametrize("kvr,rope", [(512, 64), (32, 16), (64, 64), (128, 64),
                                      (256, 64), (400, 16)])
def test_mla_smem_fits(kvr, rope):
    """Route "mma" at every padded width, route "wgmma" at 512 + 64: within
    the 227 KB a block may use; route "wgmma"'s fp32 query rows land raw
    in its query parts' space, and its merge buffer (64 × 520 fp32) fits
    that space too."""
    assert mla.smem_bytes("mma", kvr, rope) <= mla.SMEM_LIMIT
    assert mla.smem_bytes("wgmma") <= mla.SMEM_LIMIT
    assert 64 * 520 * 4 <= mla.Q_PARTS * 64 * 576 * 2 == 64 * 576 * 4


@pytest.mark.parametrize("B,C,fit,want", [
    (8, 1, {8: 15, 7: 15, 6: 16}, 6),   # fewer than 16 clusters of 7 or 8 fit
    (8, 1, {8: 16}, 8),                 # 16 row blocks a wave at 8 splits
    (8, 16, {}, 1),                     # 256 row blocks fill the card alone
    (1, 1, {8: 15}, 8),                 # 2 row blocks: 8 splits fit
    (8, 4, {}, 2),                      # 64 row blocks: 2 splits, one wave
])
def test_mla_wgmma_splits(B, C, fit, want):
    """Splits of a row block's resident tiles: enough blocks to cover the
    SMs, at most SPLIT_MAX, fewer while the row blocks' clusters would not
    all be resident at once."""
    nsplit, per = mla.splits(B, C, 128, 1024, H100_SMS, "wgmma",
                             fit=lambda n: fit.get(n, 10 ** 6))
    assert nsplit == want
    assert nsplit * per >= 1024 // mla.TILE


def test_mla_mma_splits_keep_their_arithmetic():
    """Route "mma" splits the full ring's tiles as before (32-row blocks,
    about two blocks an SM)."""
    assert mla.splits(8, 1, 128, 1024, H100_SMS) == (8, 4)
    assert mla.splits(8, 16, 128, 1024, H100_SMS) == (1, 32)


def test_mla_launches_a_call():
    """One launch a call, except route "mma" with splits, which adds its
    merge kernel (the launch counter counts both)."""
    assert mla.launches("wgmma", 8) == 1
    assert mla.launches("mma", 8) == 2             # fp32 / int8 / SMOKE at C 1
    assert mla.launches("mma", 1) == 1             # C 16: no split