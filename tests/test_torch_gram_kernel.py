"""``adapter_gram``'s launch arithmetic, its arithmetic and its layouts, on
the CPU.

``adapter_gram.plan`` is the launch the CUDA source repeats (tile, cluster,
K slices a block, stages, shared memory): held here to its invariants at
``chip_smoke.py``'s shapes, the delta route's r 512 and ragged edges, in
both layouts.  ``gram_3xtf32_plain`` (the kernel's 3xTF32 split, its warps'
and its cluster's fixed summing order, the mirrored upper triangle) is held
to the reference's ``adapter_gram`` (the Pallas kernel's entry point, as
``test_torch_train_kernels.py`` runs it) at 1e-5 of max |xᵀx|: dropping
lo·lo costs ~2^-20 of each product.  ``operand`` is the layout choice of
``ops.adapter_gram``: a transposed view of a stored wide stack is passed
as it lies.  The CUDA kernel runs only on the card, where ``chip_smoke.py``
holds it to ``ref.adapter_gram_ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import adapter_gram as ag  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


# (G, K, r, layout, tile, cluster, per): chip_smoke.py's cases, the delta
# route's r 512, and edges (r 5, 12 and 200; K under one slice)
PLANS = [
    (32, 2048, 64, "col", 64, 3, 11),
    (32, 2048, 16, "col", 32, 3, 6),
    (32, 2048, 128, "col", 128, 3, 11),
    (32, 512, 16, "col", 32, 2, 2),
    (32, 512, 64, "col", 64, 3, 3),
    (32, 512, 128, "col", 128, 3, 3),
    (32, 2000, 60, "col", 64, 3, 11),
    (32, 2048, 64, "row", 64, 3, 11),
    (32, 2048, 128, "row", 128, 3, 11),
    (4, 2048, 512, "col", 128, 2, 16),
    (4, 2048, 512, "row", 128, 2, 16),
    (3, 70, 5, "col", 32, 1, 1),
    (2, 1001, 12, "row", 32, 8, 1),
    (1, 8, 200, "col", 128, 1, 1),
]


@pytest.mark.parametrize("G,K,r,layout,tile,cluster,per", PLANS)
def test_adapter_gram_plan(G, K, r, layout, tile, cluster, per):
    """Tiles ti ≤ tj cover the upper triangle once, the cluster's blocks
    cover K once in whole slices, the cluster is the largest whose launch
    the card holds in one wave, and a block's shared memory fits."""
    p = ag.plan(G, K, r, layout)
    assert (p.route, p.tile, p.cluster, p.per) == ("mma", tile, cluster, per)
    # tiles: every (ti, tj) with ti <= tj exactly once, covering r
    pairs = [ag.tile_coords(p, t) for t in range(p.tiles)]
    assert sorted(pairs) == [(i, j) for i in range(p.strips)
                             for j in range(i, p.strips)]
    assert (p.strips - 1) * p.tile < r <= p.strips * p.tile
    # K: the blocks of a cluster cover [0, K) once, in whole slices
    assert p.rows == (128 if p.tile == 32 else 64)
    spans = [ag.block_rows(p, K, q) for q in range(p.cluster)]
    covered = [k for a, b in spans for k in range(a, b)]
    assert covered == list(range(K))
    assert p.rows_per_block == p.per * p.rows
    assert all(a % p.rows == 0 for a, b in spans if b > a)
    # the cluster: the largest size up to 8 and the slices whose clusters
    # the card holds in one wave, every block with slices of its own
    slices = -(-K // p.rows)
    assert 1 <= p.cluster <= min(8, slices)
    assert p.grid == (p.cluster * p.tiles, G)
    assert all(b > a for a, b in spans)
    assert p.cluster == 1 or G * p.tiles <= ag.CLUSTERS_HELD[p.cluster - 1]
    assert not any(G * p.tiles <= ag.CLUSTERS_HELD[s - 1]
                   and (s - 1) * -(-slices // s) < slices
                   for s in range(p.cluster + 1, min(8, slices) + 1))
    # shared memory: the ring (one strip a stage on diagonal-only launches,
    # two with off-diagonal tiles) under the block limit, and the
    # reduction tile and the exchange's sums aliased onto it
    assert p.smem == ag.smem_bytes(p.tile, layout, 2 if p.strips > 1 else 1)
    assert p.smem <= ag.SMEM_LIMIT
    assert p.smem >= 4 * (p.tile * (p.tile + 4) + p.tile * (p.tile + 1))
    if p.tile <= 64:                         # one partial tile a warp on K
        assert p.smem >= 4 * (512 // p.tile + 1) * p.tile * (p.tile + 4)
    assert p.stages == {32: 4, 64: 8, 128: 3}[p.tile]


def test_adapter_gram_plan_refuses_only_what_cannot_run():
    for bad in ((0, 64, 8, "col"), (2, 0, 8, "col"), (2, 64, 0, "row"),
                (70000, 64, 8, "col"), (2, 64, 8, "diag")):
        with pytest.raises(ValueError):
            ag.plan(*bad)
    assert ag.plan(1, 1, 1, "col").cluster == 1
    assert ag.plan(1, 1, 4096, "row").tiles == 32 * 33 // 2


@pytest.mark.parametrize("shape,layout", [
    ((600, 12), "col"),           # tail slice (600 rows over 64-row slices)
    ((3, 600, 12), "col"),        # a batch axis (the reference's vmap)
    ((2, 100, 40), "col"),
    ((2, 300, 130), "col"),       # r > 128: off-diagonal tiles
    ((3, 24, 1001), "row"),       # a wide stack read in its stored layout
])
def test_gram_3xtf32_plain_matches_reference(shape, layout):
    """The kernel's arithmetic against the reference's ``adapter_gram`` on
    the same (m, r) stacks; a "row" input is the stored (G, r, n) tensor,
    whose transpose the reference takes."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    x3 = x if x.ndim == 3 else x[None]
    tall = x3 if layout == "col" else np.ascontiguousarray(np.swapaxes(x3, 1, 2))
    want = np.asarray(jax.vmap(jops.adapter_gram)(jnp.asarray(tall)))
    got = ag.gram_3xtf32_plain(torch.from_numpy(x3), layout).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert np.array_equal(got, np.swapaxes(got, 1, 2))       # exactly symmetric


def test_split_is_the_kernels():
    """hi keeps the top 19 bits (tf32), hi + lo is x exactly before lo is
    read as tf32, and lo is at most 2^-10 of |x|."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi, lo = ag._split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= x.abs() * 2.0 ** -10).all()
    assert ((hi + lo) - x).abs().max() <= x.abs().max() * 2.0 ** -20


def test_layout_choice_reads_a_transposed_stack_where_it_lies():
    """A ``.mT`` view of a contiguous (G, r, n) stack goes to the kernel
    as the stored tensor in the row layout (no copy); a contiguous stack
    in the col layout as itself; any other view as a contiguous copy."""
    stored = torch.zeros(4, 24, 2048)
    view = stored.mT
    t, layout = ag.operand(view)
    assert layout == "row" and t.data_ptr() == stored.data_ptr()
    assert t.is_contiguous() and t.shape == (4, 24, 2048)
    tall = torch.zeros(4, 2048, 24)
    t, layout = ag.operand(tall)
    assert layout == "col" and t is tall
    strided = torch.zeros(4, 2048, 48)[:, :, ::2]
    t, layout = ag.operand(strided)
    assert layout == "col" and t.is_contiguous()
    assert t.data_ptr() != strided.data_ptr()
    # ops.adapter_gram: the same answer either way on the CPU, and the
    # transposed view of a stack on another device reaches the kernel's
    # launcher without a copy (the meta device is not CUDA: it raises there)
    a = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 12, 300))
                         .astype(np.float32))
    want = tops.adapter_gram(a.mT.contiguous()).numpy()   # sums in another order
    np.testing.assert_allclose(tops.adapter_gram(a.mT).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="CUDA"):
        tops.adapter_gram(a.to("meta").mT)
