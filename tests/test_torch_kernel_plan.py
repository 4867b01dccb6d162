"""The CUDA kernels' launch plans, checked on the CPU (no card needed).

``kruskal_grad.plan`` sets the tile, the block count, the fold and the
cross-block reduction's chunk; ``segment_reduce.plan`` and
``scatter_accum.plan`` partition the output rows among blocks.  All are
pure functions of the shapes, so the bits of a result do not depend on
the phase flags or on the card.  ``flash_attention_bwd.plan`` lays out
the flash backward's three launches (Di, dK/dV, dQ), which its C entry
refuses unless they are the build's.  ``mode_product_rows.plan`` picks the
serving tables' route (narrow or wide) and tiles the build and the row
patch, whose block count fixes the colsum's order.
"""
import dataclasses
import inspect
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention_bwd, kruskal_grad,
                                 mode_product_rows, scatter_accum,
                                 segment_reduce)

GRAD_SHAPES = list(itertools.product(
    (1, 3, 4, 10),                      # N
    (1, 3, 4, 16, 32),                  # J
    (1, 4, 5, 32),                      # R
    (1, 7, 4096, 4099, 262_144, 1_000_000)))  # B


def test_grad_plan_reads_the_shapes_only():
    """No flag, device or card reaches the plan: the same shapes give the
    same tiling for every flag combination."""
    assert list(inspect.signature(kruskal_grad.plan).parameters) == [
        "N", "J", "R", "B"]
    assert kruskal_grad.plan(3, 4, 4, 4096) == kruskal_grad.plan(3, 4, 4,
                                                                 4096)


def test_grad_plan_fills_the_card_at_the_training_shape():
    pl = kruskal_grad.plan(3, 4, 4, 4096)
    assert pl.bt <= 32 and pl.blocks >= 128
    assert (pl.threads, pl.slices) == (128, 2)   # 96 of 128 threads fold
    assert pl.blocks <= kruskal_grad.MAX_BLOCKS


@pytest.mark.parametrize("N", [1, 3, 4, 10])
def test_grad_plan_is_launchable_for_every_width(N):
    for n, J, R, B in (s for s in GRAD_SHAPES if s[0] == N):
        pl = kruskal_grad.plan(n, J, R, B)
        W = kruskal_grad.group_width(J, R)
        assert W >= max(J, R) and W & (W - 1) == 0 and W <= 32
        assert pl.threads == pl.bt * W
        assert pl.threads % 32 == 0 and pl.threads <= 256
        assert 1 <= pl.blocks <= min(kruskal_grad.MAX_BLOCKS,
                                     -(-B // pl.bt))
        s = pl.slices   # the fold: powers of two within a warp, one pass
        assert s & (s - 1) == 0 and s <= 32 and pl.bt % s == 0
        assert s == 1 or s * n * J * R <= pl.threads
        assert 2 * s * n * J * R > pl.threads or 2 * s > min(pl.bt, 32)
        njr = n * J * R
        tile = n * J * (R + 1) + n * pl.bt * (J + R) + njr
        # the tiles, or the last block's per-lane sums of the partials
        assert pl.smem_bytes == 4 * max(tile, 2 * pl.threads)
        assert pl.smem_bytes <= kruskal_grad.SMEM_LIMIT == 232_448


def test_grad_plan_rejects_shapes_the_kernel_does_not_take():
    for bad in ((11, 4, 4, 10), (3, 65, 4, 10), (3, 4, 65, 10),
                (7, 64, 64, 10), (3, 4, 4, 0), (0, 4, 4, 10)):
        with pytest.raises(ValueError, match="kruskal_grad"):
            kruskal_grad.plan(*bad)


@pytest.mark.parametrize("N", [1, 2, 3, 4])
@pytest.mark.parametrize("J,R", [(48, 48), (64, 64), (48, 64), (64, 4),
                                 (4, 64), (33, 33)])
def test_grad_plan_is_launchable_at_widths_up_to_64(N, J, R):
    """A warp a sample (W = 32), two entries a lane; the tile fits 256
    threads and a block's shared memory."""
    for B in (1, 4096, 262_144):
        pl = kruskal_grad.plan(N, J, R, B)
        assert kruskal_grad.group_width(J, R) == 32
        assert pl.threads == 32 * pl.bt and pl.threads <= 256
        tile = N * J * (R + 1) + N * pl.bt * (J + R) + N * J * R
        assert pl.smem_bytes == 4 * max(tile, 2 * pl.threads)
        assert pl.smem_bytes <= kruskal_grad.SMEM_LIMIT
        assert 1 <= pl.blocks <= min(kruskal_grad.MAX_BLOCKS,
                                     -(-B // pl.bt))
    assert kruskal_grad.plan(4, 64, 64, 4096).bt == 8   # no shrink needed


def test_grad_plan_shrinks_the_tile_before_it_refuses():
    """At J = R = 64 the factors, tiles and partial of N = 6 modes fit at
    8 samples a tile; from N = 7 not even one sample fits."""
    assert kruskal_grad.plan(6, 64, 64, 4096).bt == 8
    assert kruskal_grad.plan(10, 50, 50, 4096).bt == 4   # shrunk
    for N in (7, 8, 9, 10):
        with pytest.raises(ValueError, match="shared memory"):
            kruskal_grad.plan(N, 64, 64, 4096)


@pytest.mark.parametrize("J", [1, 3, 4, 32, 48, 64])
@pytest.mark.parametrize("rows", [1, 2182, 17_770, 480_189])
def test_segment_plan_covers_every_row_once(rows, J):
    pl = segment_reduce.plan(rows, J)
    assert pl.rows_per_block % 4 == 0   # 16-byte aligned starts, any J
    hits = np.zeros(rows, np.int64)
    for k in range(pl.blocks):
        hits[k * pl.rows_per_block:(k + 1) * pl.rows_per_block] += 1
    assert (hits == 1).all()
    assert (pl.blocks - 1) * pl.rows_per_block < rows
    assert pl.chunk & (pl.chunk - 1) == 0
    assert pl.smem_bytes == 4 * (pl.rows_per_block * J
                                 + pl.chunk * (J + 1))
    assert pl.smem_bytes <= 48 * 1024   # no opt-in attribute needed


def test_segment_plan_spreads_small_modes_over_many_blocks():
    """The Netflix modes at J = 4: even 2,182 rows take over 128 blocks."""
    blocks = [segment_reduce.plan(r, 4).blocks
              for r in (480_189, 17_770, 2_182)]
    assert blocks == [469, 247, 182]
    with pytest.raises(ValueError, match="segment_reduce"):
        segment_reduce.plan(0, 4)
    with pytest.raises(ValueError, match="segment_reduce"):
        segment_reduce.plan(10, 65)


@pytest.mark.parametrize("J", [1, 4, 32, 48, 64])
@pytest.mark.parametrize("rows", [1, 2182, 17_770, 480_189])
def test_scatter_plan_covers_every_row_once(rows, J):
    """Contiguous ranges, 16-byte aligned starts (ranges and sub-tiles),
    every row in exactly one block; the hit list, the staged rows and a
    sub-tile fit 88 kB (one block of 512 threads a SM)."""
    pl = scatter_accum.plan(rows, J, 4096)
    assert pl.rows_per_block % 4 == 0 and pl.tile_rows % 4 == 0
    assert 4 <= pl.tile_rows <= pl.rows_per_block
    assert pl.tile_rows * J <= scatter_accum.TILE_FLOATS
    assert pl.rows_per_block <= 0xffff   # a hit packs its row in 16 bits
    hits = np.zeros(rows, np.int64)
    for k in range(pl.blocks):
        hits[k * pl.rows_per_block:(k + 1) * pl.rows_per_block] += 1
    assert (hits == 1).all()
    assert (pl.blocks - 1) * pl.rows_per_block < rows
    assert pl.smem_bytes == 4 * (scatter_accum.CHUNK
                                 + scatter_accum.STAGE_FLOATS
                                 + pl.tile_rows * J)
    assert pl.smem_bytes <= 88 * 1024
    assert scatter_accum.STAGE_FLOATS // J >= 32   # hits staged a pass
    assert pl.rounds == 1


def test_scatter_plan_reads_the_shapes_only():
    """Every block reads every id, so the Netflix modes at J = 4 take at
    most 128 blocks each, mode 0 in one sub-tile; B only sets the rounds
    over the ids."""
    assert list(inspect.signature(scatter_accum.plan).parameters) == [
        "num_rows", "J", "B"]
    blocks = [scatter_accum.plan(r, 4, 4096).blocks
              for r in (480_189, 17_770, 2_182)]
    assert blocks == [128, 127, 110]
    pl = scatter_accum.plan(480_189, 4, 4096)
    assert pl.tile_rows == pl.rows_per_block == 3752
    assert scatter_accum.plan(480_189, 64, 4096).tile_rows == 256
    # a range never outgrows 16 bits of row: huge modes take more blocks
    assert scatter_accum.plan(10_000_000, 1, 4096).rows_per_block == 65_532
    assert [scatter_accum.plan(50, 4, B).rounds
            for B in (1, 4096, 4097, 262_144)] == [1, 1, 2, 64]
    for bad in ((0, 4, 10), (10, 65, 10), (10, 4, 0)):
        with pytest.raises(ValueError, match="scatter_accum"):
            scatter_accum.plan(*bad)


# flash backward: (B, Sq, Sk, H, Hk) — the LM's training shape, ragged
# sequences off the 128/32 tiles, GQA and not, a single row
BWD_SHAPES = [(2, 2048, 2048, 40, 8), (1, 301, 333, 10, 2),
              (2, 200, 290, 4, 2), (3, 129, 127, 6, 3), (1, 1, 1, 1, 1),
              (2, 2047, 2047, 40, 8)]


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_bwd_plan_fits_shared_memory_at_every_head_size(D):
    """Both kernels' shared memory fits the 232,448 bytes a block may
    take; at D = 128 each takes all of it."""
    p = flash_attention_bwd.plan(2, 2048, 2048, 40, 8, D)
    assert all(0 < b <= 232_448 for b in p.smem)
    assert p.warps == 8 and p.kv_tile[0] == p.q_tile[0] == 16 * p.warps
    if D == 128:
        assert p.smem == (232_448, 232_448)


def test_flash_bwd_plan_runs_every_product_in_3xtf32():
    """Three tensor-core passes for each of the five products, never one
    pass of TF32; the C entry gets them packed two bits each."""
    p = flash_attention_bwd.plan(2, 2048, 2048, 40, 8, 128)
    assert flash_attention_bwd.PRODUCTS == ("S", "dP", "dV", "dK", "dQ")
    assert p.passes == (3, 3, 3, 3, 3)
    c = list(p.to_c())
    assert len(c) == 11 and c[5] == 3 * (1 + 4 + 16 + 64 + 256)
    assert c[:5] == [8, 128, 32, 128, 32] and c[6:8] == list(p.smem)


@pytest.mark.parametrize("D,Dv", [(64, 64), (192, 128)])
def test_flash_bwd_plan_drops_the_passes_of_bf16_sides(D, Dv):
    """bf16 inputs: S and dP (bf16 × bf16) in one pass, dV, dK and dQ
    (f32 P or dS × bf16) in two; tiles, shared bytes and grids as f32's."""
    p = flash_attention_bwd.plan(2, 2048, 2048, 16, 16, D, Dv,
                                 torch.bfloat16)
    f32 = flash_attention_bwd.plan(2, 2048, 2048, 16, 16, D, Dv)
    assert p.passes == (1, 1, 2, 2, 2)
    assert list(p.to_c())[5] == 1 + 1 * 4 + 2 * 16 + 2 * 64 + 2 * 256
    assert dataclasses.replace(p, passes=f32.passes) == f32


@pytest.mark.parametrize("B,Sq,Sk,H,Hk", BWD_SHAPES)
def test_flash_bwd_plan_grid_covers_every_tile_once(B, Sq, Sk, H, Hk):
    """Each (batch, KV head, key) row belongs to one dK/dV block and each
    (batch, head, query) row to one dQ block, the blocks with the most
    causal work first; the Di launch has a warp for every row."""
    p = flash_attention_bwd.plan(B, Sq, Sk, H, Hk, 64)
    (dot, _, _), (kv, _, _), (qg, _, _) = p.grids
    assert all(g[1:] == (1, 1) for g in p.grids)
    assert dot * 8 >= B * H * Sq > (dot - 1) * 8   # 8 warps a block
    bk, bq = p.kv_tile[0], p.q_tile[0]
    keys = np.zeros((B, Hk, Sk), np.int64)
    tiles = []
    for x in range(kv):
        kt, hk, b = x // (Hk * B), x % Hk, x // Hk % B
        keys[b, hk, kt * bk:(kt + 1) * bk] += 1
        tiles.append(kt)
    assert (keys == 1).all() and tiles == sorted(tiles)
    rows = np.zeros((B, H, Sq), np.int64)
    tiles = []
    nq = -(-Sq // bq)
    for x in range(qg):
        qt, h, b = nq - 1 - x // (H * B), x % H, x // H % B
        rows[b, h, qt * bq:(qt + 1) * bq] += 1
        tiles.append(qt)
    assert (rows == 1).all() and tiles == sorted(tiles, reverse=True)


def test_flash_bwd_plan_workspace_at_the_training_shape():
    """The only scratch is Di, (B, H, Sq) f32: 655,360 bytes at the
    training shape; dQ is a second pass, with no partials."""
    assert flash_attention_bwd.plan(2, 2048, 2048, 40, 8,
                                    128).workspace == 4 * 2 * 40 * 2048
    assert flash_attention_bwd.plan(1, 301, 333, 10, 2,
                                    32).workspace == 4 * 10 * 301


def test_flash_bwd_plan_at_mla_widths_takes_16_row_ring_tiles():
    """(D, Dv) = (192, 128): resident 128 × 192 and 128 × 128 tiles and
    three stages of 32-row ring tiles would take 289,792 shared bytes;
    16-row ring tiles take 226,816, within the 232,448 a block may have.
    The grids and the Di workspace are those of any width."""
    p = flash_attention_bwd.plan(2, 2048, 2048, 16, 16, 192, 128)
    assert p.kv_tile == p.q_tile == (128, 16)
    assert p.smem == (226_816, 226_816)
    assert flash_attention_bwd._smem_bytes(192, 128, 128, 32) == 289_792
    assert p.passes == (3,) * 5 and p.workspace == 4 * 2 * 16 * 2048
    assert p.grids == flash_attention_bwd.plan(2, 2048, 2048, 16, 16,
                                               128).grids
    c = list(p.to_c())
    assert c[:5] == [8, 128, 16, 128, 16] and c[6:8] == [226_816] * 2
    for bad in ((192, 192), (128, 192), (192, 64)):
        with pytest.raises(ValueError, match="D in"):
            flash_attention_bwd.plan(1, 64, 64, 2, 2, *bad)


@pytest.mark.parametrize("D", [8, 24, 96, 256])
def test_flash_bwd_plan_refuses_head_sizes_the_kernel_lacks(D):
    with pytest.raises(ValueError, match="D in"):
        flash_attention_bwd.plan(1, 64, 64, 2, 2, D)


def test_segment_plan_routes_long_runs_to_the_walk():
    """The training batches (B = 4096 at the Netflix modes) stay on the
    staged route; the ALS chunk (2^22 × J²) and CCD's whole-mode sums (89 M
    × 1) walk, one lane group a row."""
    for rows in (480_189, 17_770, 2_182):
        assert segment_reduce.plan(rows, 4, 4096).route == "staged"
        assert segment_reduce.plan(rows, 4, 4096) == segment_reduce.plan(
            rows, 4)
    for rows, J, B in ((480_189, 16, 1 << 22), (2_182, 16, 1 << 22),
                       (2_182, 1, 89_164_901), (64, 64, 4096)):
        pl = segment_reduce.plan(rows, J, B)
        W = segment_reduce.group_width(J)
        assert pl.route == "walk" and pl.rows_per_block == 256 // W
        assert pl.blocks == -(-rows // pl.rows_per_block)
        assert pl.smem_bytes == 0
    assert [segment_reduce.group_width(J) for J in (1, 3, 4, 16, 33, 64)] \
        == [1, 4, 4, 16, 32, 32]


def _group_lower_bound(ids, a, t, W):
    """csrc/segment_reduce.cu::group_lower_bound, lane by lane."""
    b = len(ids)
    while a < b:
        n = b - a
        count = sum(ids[a + (sub + 1) * n // (W + 1)] < t
                    for sub in range(W))
        if count == 0:
            b = a + n // (W + 1)
        else:
            next_a = a + count * n // (W + 1) + 1
            if count < W:
                b = a + (count + 1) * n // (W + 1)
            a = next_a
    return a


@pytest.mark.parametrize("W", [1, 2, 4, 16, 32])
def test_walk_search_finds_each_rows_run(W):
    """The walk route's (W + 1)-ary search, transcribed: for every row of
    sorted ids with long runs, gaps and ids outside [0, rows) it finds the
    first position of the row and of the next one."""
    import bisect

    rng = np.random.default_rng(W)
    for n, hi in ((1, 3), (7, 4), (1000, 20), (5000, 3000)):
        ids = np.sort(rng.integers(-2, hi, n)).tolist()
        for r in range(hi):
            start = _group_lower_bound(ids, 0, r, W)
            assert start == bisect.bisect_left(ids, r)
            assert _group_lower_bound(ids, start, r + 1, W) == \
                bisect.bisect_left(ids, r + 1)


# ---------------------------------------------------------------------------
# mode_product_rows: the serving tables' build and row patch
# ---------------------------------------------------------------------------

TABLE_WIDTHS = (1, 3, 4, 5, 8, 9, 33, 63, 64)
TABLE_ROWS = (4_099, 60_000, 480_189)


def _table_edges(J, R, patch):
    """1, the route's tile − 1, tile, tile + 1, then the serving sizes."""
    tile = mode_product_rows.plan(1, J, R, patch=patch).rows_per_tile
    return sorted({1, max(1, tile - 1), tile, tile + 1, *TABLE_ROWS})


def test_table_plan_reads_the_shapes_only():
    """The plan takes the shapes and the storage width, nothing of a device;
    the route follows J and R alone."""
    mpr = mode_product_rows
    assert list(inspect.signature(mpr.plan).parameters) == [
        "M", "J", "R", "patch", "itemsize", "table_rows"]
    assert mpr.plan(60_000, 64, 64) == mpr.plan(60_000, 64, 64)
    assert mpr.plan(480_189, 4, 4).route == "narrow"
    assert mpr.plan(2_000, 8, 8, patch=True).route == "narrow"
    for J, R in ((9, 4), (4, 9), (64, 64), (64, 1), (1, 64)):
        assert mpr.plan(100, J, R).route == "wide"
    # the wide build keeps two blocks an SM (80 kB at J = R = 64, f32) and
    # gives every block the same rows: 259 blocks of 232 at 60,000
    pl = mpr.plan(60_000, 64, 64)
    assert (pl.rows_per_tile, pl.blocks, pl.rows_per_block, pl.smem) == (
        128, 259, 232, 81_920)
    with pytest.raises(ValueError, match="J, R <= 64"):
        mpr.plan(10, 4, 65)
    with pytest.raises(ValueError, match="M >= 1"):
        mpr.plan(0, 4, 4)


@pytest.mark.parametrize("patch", [False, True])
@pytest.mark.parametrize("JR", TABLE_WIDTHS)
def test_table_plan_covers_every_row_once(JR, patch):
    """The kernels' walk reaches every (row, column) once: a wide build's
    block b takes rows [b·n, (b + 1)·n) (n a multiple of 8, so its tiles
    start 16-byte aligned) in tiles of 128; a patch's or a narrow build's
    block b takes tiles b, b + blocks, ...; a wide tile's 16 row groups
    take TM rows each and its column groups four columns each; a narrow
    thread takes one row."""
    mpr = mode_product_rows
    for M in _table_edges(JR, JR, patch):
        pl = mpr.plan(M, JR, JR, patch=patch)
        if pl.rows_per_block:
            n = pl.rows_per_block
            assert n % 8 == 0 and (pl.blocks - 1) * n < M <= pl.blocks * n
            hits = np.zeros(M, np.int64)
            tiles = 0
            for b in range(pl.blocks):
                hits[b * n:(b + 1) * n] += 1
                tiles += -(-(min(M, (b + 1) * n) - b * n) // pl.rows_per_tile)
            assert (hits == 1).all() and tiles == pl.tiles
        else:
            tiles = np.zeros(pl.tiles, np.int64)
            for b in range(pl.blocks):
                tiles[b::pl.blocks] += 1
            assert (tiles == 1).all()
            assert pl.tiles * pl.rows_per_tile >= M > (pl.tiles - 1) * \
                pl.rows_per_tile
        if pl.route == "narrow":
            assert pl.threads == pl.rows_per_tile   # a row a thread
            continue
        cg = -(-JR // 4)
        tm = pl.rows_per_tile // mpr.ROW_GROUPS
        assert cg * mpr.ROW_GROUPS <= pl.threads
        cover = np.zeros((pl.rows_per_tile, 4 * cg), np.int64)
        for t in range(cg * mpr.ROW_GROUPS):
            rg, c = divmod(t, cg)
            cover[rg * tm:(rg + 1) * tm, 4 * c:4 * c + 4] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
def test_table_plan_fits_shared_memory_at_every_width(itemsize):
    """Every J, R <= 64: a wide build fits two blocks an SM (the opt-in
    limit halved), a patch the default 48 kB (no opt-in), narrow plans a
    few hundred bytes; the patch's workspace holds the ids, the counter,
    the bit map of 60,000 rows and the partials, each part 16-byte
    aligned."""
    mpr = mode_product_rows
    for J, R in itertools.product(range(1, 65), repeat=2):
        build = mpr.plan(60_000, J, R, itemsize=itemsize)
        assert build.smem <= mpr.SMEM_MAX // 2
        patch = mpr.plan(6_000, J, R, patch=True, itemsize=itemsize,
                         table_rows=60_000)
        assert patch.smem <= mpr.SMEM_DEFAULT
        if build.route == "wide":
            S = -(-R // 4) * 4
            assert build.smem == 4 * J * S + 2 * itemsize * 128 * J
        ids, bits = (6_000 + 4) & ~3, (1_875 + 3) & ~3
        assert ids >= 6_001 and ids % 4 == 0 and bits % 4 == 0
        assert 32 * bits >= 60_000
        assert patch.workspace == ids + bits + patch.blocks * R


@pytest.mark.parametrize("K", [1, 31, 32, 33, 127, 128, 129, 600, 6_000,
                               14_294, 16_384, 16_385, 60_000])
def test_table_patch_blocks_are_a_function_of_k_alone(K):
    """The colsum folds each thread's rows, a block's threads, then the
    blocks in order: fixed tiles (32 rows on the wide route, 128 on the
    narrow one) and a constant cap make the block count, and so the
    order, the same at every width and storage of a route; nothing of a
    device enters it."""
    mpr = mode_product_rows
    for route, rows in (("wide", mpr.PATCH_ROWS),
                        ("narrow", mpr.PATCH_NARROW)):
        want = min(-(-K // rows), mpr.MAX_BLOCKS)
        for J, R in itertools.product(TABLE_WIDTHS, repeat=2):
            for itemsize in (4, 2):
                pl = mpr.plan(K, J, R, patch=True, itemsize=itemsize)
                if pl.route == route:
                    assert (pl.rows_per_tile, pl.blocks) == (rows, want)
                    # the last block's segments: each adds at most 32·4
                    # partials, in 32-wide rounds
                    assert -(-pl.blocks // (pl.threads // R)) <= 128
