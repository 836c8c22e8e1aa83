"""The rasterizer's binning keys and ``tile_blend``'s culling, on the CPU.

* ``bin_keys_plain`` (the plain version of the ``bin_keys`` kernel) against
  a numpy uint32 transcription of the JAX package's key build
  (``bevy_hanabi_tpu/render/raster.py:361-423``), XOR 0x80000000 viewed as
  int32, bit for bit, in all four modes.
* ``sort_tiles`` on those 32-bit keys against the int64 form it replaced:
  the same ``pidx_sorted``, ``starts`` and ``ends``.
* The coverage tests of ``csrc/tile_blend.cu`` through plain mirrors of the
  kernel's formulas, on adversarial quads drawn by ``hypothesis``: the
  per-pixel test (``|num| <= |det|`` in float32 in place of the two
  divisions, for a finite det) must give ``tile_blend_plain``'s coverage on
  every (entry, pixel) pair, and every (entry, warp block) pair that the
  float64 block bound culls must be uncovered there.

Every comparison here is exact: keys are integers, coverage is a boolean,
and a culled pair either is uncovered or the test fails.
"""

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu_torch.render import raster

T = 16  # the tile size of every cell; the kernel's warp blocks are 8x4 pixels there
NTX = NTY = 4

# ---- keys ---------------------------------------------------------------------


def _jax_keys_np(tile, depths, nt, mode):
    """raster.py:336-423 in numpy uint32 / float32, line for line."""
    num_entries = tile.shape[0]
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    idx_bits = max(1, int(np.ceil(np.log2(max(num_entries, 2)))))
    slack = 32 - tile_bits - idx_bits

    def quant_depth(depth_bits):
        finite = depths > -np.inf
        dmin = np.min(np.where(finite, depths, np.float32(np.inf)))
        dmax = np.max(np.where(finite, depths, np.float32(-np.inf)))
        span_d = np.maximum(dmax - dmin, np.float32(1e-9))
        scale = np.float32((1 << depth_bits) - 1)
        with np.errstate(invalid="ignore"):
            q = np.clip((depths - dmin) / span_d, np.float32(0.0), np.float32(1.0)) * scale
        return q.astype(np.uint32), scale

    if mode in ("first", "depth"):
        db = min(slack, 8) if mode == "depth" else 0
        key = (tile.astype(np.uint32) << np.uint32(db + idx_bits)) | np.arange(
            num_entries, dtype=np.uint32)
        if db:
            dq, _ = quant_depth(db)
            key = key | (dq << np.uint32(idx_bits))
    else:
        depth_bits = min(22, 32 - tile_bits)
        dq, scale = quant_depth(depth_bits)
        dq_key = dq if mode == "payload" else scale.astype(np.uint32) - dq
        key = (tile.astype(np.uint32) << np.uint32(depth_bits)) | dq_key
    return key


def _entries(case, n, nt, seed):
    """(tile int32, depth f32) of ``n`` entries: binned ones on tiles
    0..nt-1 with depths > 1e-4, the rest on the sentinel tile nt at -inf."""
    r = np.random.default_rng(seed)
    tile = r.integers(0, nt, n).astype(np.int32)
    depth = r.uniform(0.5, 60.0, n).astype(np.float32)
    binned = r.random(n) < 0.8
    if case == "nothing binned":
        binned[:] = False
    elif case == "one binned":
        binned[:] = False
        binned[n // 3] = True
    elif case == "equal depths":
        depth[:] = np.float32(7.25)
    elif case == "near and far":
        depth[::7] = np.float32(1e-4) * np.float32(1.5)
        depth[1::7] = np.float32(3e4)
    tile[~binned] = nt
    depth[~binned] = -np.inf
    return tile, depth


CASES = ["random", "nothing binned", "one binned", "equal depths", "near and far"]
# (n, nt): 512^2 at T=16 puts the sentinel tile 1024 on bit 31 of the
# ordered key; the small grid leaves bit 31 clear
SHAPES = [(5000, 1024), (3000, 64)]


@pytest.mark.parametrize("mode", [None, "payload", "first", "depth"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,nt", SHAPES)
def test_bin_keys_plain_is_jax_uint32_key(mode, case, n, nt):
    tile, depth = _entries(case, n, nt, seed=n + nt)
    want = (_jax_keys_np(tile, depth, nt, mode) ^ np.uint32(0x80000000)).view(np.int32)
    t, d = torch.from_numpy(tile), torch.from_numpy(depth)
    rng = raster.depth_range_plain(d)
    got = raster.bin_keys_plain(t, d, rng, nt, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(raster.bin_keys(t, d, rng, nt, mode), got)
    if case == "random" and nt == 1024 and mode is None:
        assert (want < 0).any() and (want >= 0).any()  # the sentinel's bit 31 flips the sign


@pytest.mark.parametrize("case", CASES)
def test_depth_range_plain_is_min_and_max_of_binned_depths(case):
    tile, depth = _entries(case, 4000, 256, seed=1)
    rng = raster.depth_range_plain(torch.from_numpy(depth)).numpy()
    binned = depth[tile < 256]
    if binned.size == 0:
        assert np.isnan(rng).all()
    else:
        np.testing.assert_array_equal(rng, [binned.min(), binned.max()])


def test_bin_keys_needs_a_range_where_it_quantises_depth():
    tile, depth = (torch.from_numpy(a) for a in _entries("random", 64, 16, seed=0))
    with pytest.raises(ValueError, match="depth_range"):
        raster.bin_keys(tile, depth, None, 16, None)
    first = raster.bin_keys(tile, depth, None, 16, "first")  # no depth bits
    assert torch.equal(first, raster.bin_keys_plain(tile, depth, None, 16, "first"))
    with pytest.raises(ValueError, match="no room"):
        raster.bin_keys(torch.zeros(1 << 22, dtype=torch.int32), torch.zeros(1 << 22),
                        None, 1 << 12, "first")


def _sort_tiles_int64(tile, depth, nt, mode):
    """The int64-key form of ``sort_tiles`` that the 32-bit keys replaced."""
    n = tile.shape[0]
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    tile64 = tile.to(torch.int64)

    def quant(depth_bits):
        finite = depth > -torch.inf
        dmin = torch.where(finite, depth, torch.inf).min()
        dmax = torch.where(finite, depth, -torch.inf).max()
        span_d = torch.clamp(dmax - dmin, min=1e-9)
        scale = float((1 << depth_bits) - 1)
        return (torch.clamp((depth - dmin) / span_d, 0.0, 1.0) * scale).to(torch.int64)

    if mode in ("first", "depth"):
        idx_bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
        db = min(32 - tile_bits - idx_bits, 8) if mode == "depth" else 0
        shift = db + idx_bits
        key = (tile64 << shift) | torch.arange(n, dtype=torch.int64)
        if db:
            key = key | (quant(db) << idx_bits)
        key_sorted = torch.sort(key).values
        pidx_sorted = key_sorted & ((1 << idx_bits) - 1)
    else:
        shift = min(22, 32 - tile_bits)
        dq = quant(shift)
        if mode is None:
            dq = ((1 << shift) - 1) - dq
        key_sorted, pidx_sorted = torch.sort((tile64 << shift) | dq, stable=True)
    r = torch.searchsorted(key_sorted, torch.arange(nt + 1, dtype=torch.int64) << shift)
    return pidx_sorted, r[:-1], r[1:]


@pytest.mark.parametrize("mode", [None, "payload", "first", "depth"])
@pytest.mark.parametrize("case", ["random", "nothing binned", "equal depths", "near and far"])
def test_sort_tiles_matches_the_int64_keys(mode, case):
    tile, depth = (torch.from_numpy(a) for a in _entries(case, 5000, 1024, seed=7))
    want = _sort_tiles_int64(tile, depth, 1024, mode)
    for rng in (None, raster.depth_range_plain(depth)):  # computed inside, or handed in
        got = raster.sort_tiles(tile, depth, 1024, mode, rng)
        for a, b in zip(got, want):
            assert torch.equal(a.to(torch.int64), b)


# ---- tile_blend's culling predicates -----------------------------------------


def _covered(rows):
    """Coverage under ``tile_blend_plain``'s test of one entry ``rows``
    (f32 [10]) put in every tile of a 4x4-tile grid: bool [nt, T, T]."""
    nt = NTX * NTY
    window = torch.from_numpy(np.tile(rows, (nt, 1, 1)))
    window[:, :, 6:10] = 1.0  # an opaque white splat marks its covered pixels
    has = torch.ones((nt, 1), dtype=torch.bool)
    fb = raster.tile_blend_plain(window, has, T, NTX, NTY, (0.0, 0.0, 0.0, 0.0), "opaque")
    return (fb[..., 3] == 1.0).numpy()


def _pixel_centres():
    """px, py f32 [nt, T, T] of every pixel of the grid (raster.py:426-435)."""
    tiles = np.arange(NTX * NTY)
    ar = np.arange(T)
    py = ((tiles // NTX)[:, None, None] * T + ar[None, :, None]).astype(np.float32) + np.float32(0.5)
    px = ((tiles % NTX)[:, None, None] * T + ar[None, None, :]).astype(np.float32) + np.float32(0.5)
    return np.broadcast_to(px, (NTX * NTY, T, T)), np.broadcast_to(py, (NTX * NTY, T, T))


def _det(r):
    """The clamped det of tile_blend.cu's per-entry terms (float32)."""
    det = r[2] * r[5] - r[3] * r[4]
    clamped = bool(np.abs(det) < np.float32(1e-9))
    return (np.float32(1e-9) if clamped else det), clamped


def _pixel_test(r, px, py):
    """tile_blend.cu's per-pixel coverage test in float32, as the kernel:
    |num_u|, |num_v| <= |det| for a finite det, else the two divisions."""
    det, _ = _det(r)
    dx = px - r[0]
    dy = py - r[1]
    nu = r[5] * dx - r[4] * dy
    nv = -r[3] * dx + r[2] * dy
    if not np.isfinite(det):
        return (np.abs(nu / det) <= 1) & (np.abs(nv / det) <= 1)
    ad = np.abs(det)
    return (np.abs(nu) <= ad) & (np.abs(nv) <= ad)


def _cullable(r):
    det, clamped = _det(r)
    return bool(np.isfinite(r[:6]).all() and np.isfinite(det) and not clamped)


def _block_culled(r, x0, x1, y0, y1):
    """tile_blend.cu's ``block_culled`` in float64, as the kernel."""
    det, _ = _det(r)
    cx, cy, a1x, a1y, a2x, a2y = (float(v) for v in r[:6])
    ad = abs(float(det))
    dx0, dx1, dy0, dy1 = x0 - cx, x1 - cx, y0 - cy, y1 - cy
    mx, my = max(abs(dx0), abs(dx1)), max(abs(dy0), abs(dy1))
    rel = 2.0**-20
    bu = ad * (1.0 + rel) + rel * (abs(a2y) * mx + abs(a2x) * my)
    ux, uy = (a2y * dx0, a2y * dx1), (-a2x * dy0, -a2x * dy1)
    if min(ux) + min(uy) > bu or max(ux) + max(uy) < -bu:
        return True
    bv = ad * (1.0 + rel) + rel * (abs(a1y) * mx + abs(a1x) * my)
    vx, vy = (-a1y * dx0, -a1y * dx1), (a1x * dy0, a1x * dy1)
    return min(vx) + min(vy) > bv or max(vx) + max(vy) < -bv


def _blocks():
    """The pixel-centre bounds (x0, x1, y0, y1) and the [nt, T, T] mask of
    every warp's 8x4 block in the grid."""
    px, py = _pixel_centres()
    out = []
    for tile in range(NTX * NTY):
        for bi in range(T // 4):
            for bj in range(T // 8):
                m = np.zeros((NTX * NTY, T, T), dtype=bool)
                m[tile, 4 * bi: 4 * bi + 4, 8 * bj: 8 * bj + 8] = True
                out.append((float(px[m].min()), float(px[m].max()), float(py[m].min()),
                            float(py[m].max()), m))
    return out


BLOCKS = _blocks()


def _check_culling(rows):
    """The pixel test is the reference's coverage and every culled block
    is uncovered; returns the shares of uncovered pixels and culled blocks."""
    r = np.asarray(rows, dtype=np.float32)
    covered = _covered(r)
    px, py = _pixel_centres()
    culled = 0
    with np.errstate(all="ignore"):
        test = _pixel_test(r, px, py)
        assert np.array_equal(test, covered), f"the pixel test differs from the reference on {r.tolist()}"
        if _cullable(r):
            for x0, x1, y0, y1, m in BLOCKS:
                if _block_culled(r, x0, x1, y0, y1):
                    culled += 1
                    assert not covered[m].any(), f"a covered block was culled for {r.tolist()}"
    return float(1.0 - covered.mean()), culled / len(BLOCKS)


def _quads(st):
    """The strategy of adversarial quad rows, built from ``hypothesis``'s
    ``strategies`` module ``st``."""
    finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
    special = st.sampled_from([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, 3e38, -3e38])
    mag_of = st.sampled_from([1e-30, 1e-9, 1e-6, 1e-3, 0.05, 0.5, 1.0, 4.0, 17.0, 300.0, 1e6, 1e20])

    @st.composite
    def quads(draw):
        """Rows [cx, cy, h1x, h1y, h2x, h2y] of adversarial quads over the
        64x64-pixel grid: tiny, huge, collinear, degenerate (|det| < 1e-9),
        non-finite, off-screen, edges through pixel centres, or any floats."""
        kind = draw(st.sampled_from(
            ["scaled", "collinear", "degenerate", "nonfinite", "offscreen", "edge", "any"]))
        cx = draw(st.floats(-20.0, 84.0, width=32))
        cy = draw(st.floats(-20.0, 84.0, width=32))
        mag = draw(mag_of)
        unit = st.floats(-1.0, 1.0, width=32)
        a1 = [draw(unit) * mag, draw(unit) * mag]
        a2 = [draw(unit) * mag, draw(unit) * mag]
        if kind == "collinear":
            k = draw(st.floats(-4.0, 4.0, width=32))
            a2 = [a1[0] * k, a1[1] * k]
        elif kind == "degenerate":
            k = draw(st.floats(-4.0, 4.0, width=32))
            eps = draw(st.sampled_from([1e-12, 1e-10, 5e-10, 9e-10, 1e-9, 2e-9]))
            a2 = [a1[0] * k + eps, a1[1] * k]
        elif kind == "offscreen":
            cx = draw(st.sampled_from([-1e4, -300.0, 400.0, 1e7, 1e30]))
        elif kind == "edge":
            # a half-axis that ends on (or a few ulps off) a pixel centre
            tx = np.float32(draw(st.integers(0, 63))) + np.float32(0.5)
            ty = np.float32(draw(st.integers(0, 63))) + np.float32(0.5)
            cx = float(np.float32(draw(st.integers(-4, 68))) + np.float32(draw(st.sampled_from([0.0, 0.5, 0.25]))))
            cy = float(np.float32(draw(st.integers(-4, 68))) + np.float32(0.5))
            ulps = draw(st.integers(-3, 3))
            hx = np.float32(tx - np.float32(cx))
            hx = np.nextafter(hx, np.float32(np.inf if ulps > 0 else -np.inf)) if ulps else hx
            for _ in range(abs(ulps) - 1):
                hx = np.nextafter(hx, np.float32(np.inf if ulps > 0 else -np.inf))
            a1 = [float(hx), draw(st.sampled_from([0.0, 1e-7, -1e-7]))]
            a2 = [draw(st.sampled_from([0.0, 1e-7])), float(np.float32(ty - np.float32(cy))) or 0.5]
        row = [cx, cy, *a1, *a2]
        if kind == "nonfinite":
            row[draw(st.integers(0, 5))] = draw(special)
        elif kind == "any":
            row = [draw(st.one_of(finite32, special)) for _ in range(6)]
        return np.asarray(row + [1.0, 1.0, 1.0, 1.0], dtype=np.float32)

    return quads()


def test_division_free_test_is_exact_at_the_boundary():
    """|fl(x / d)| <= 1 exactly when |x| <= |d|, for a normal float d: the
    kernel's comparison in place of the reference's division, on numerators
    a few ulps either side of d and on random ones, over d from the 1e-9
    clamp up to 1e30."""
    r = np.random.default_rng(11)
    d = (10.0 ** r.uniform(-9, 30, 4000)).astype(np.float32) * r.choice([-1, 1], 4000).astype(np.float32)
    xs = [d, -d, r.uniform(-2, 2, 4000).astype(np.float32) * d]
    for k in range(1, 4):
        up, down = d.copy(), d.copy()
        for _ in range(k):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
        xs += [up, down]
    for x in xs:
        assert np.array_equal(np.abs(x / d) <= 1, np.abs(x) <= np.abs(d))


def test_pixel_test_is_the_reference_and_culling_skips_only_uncovered_pairs():
    hypothesis = pytest.importorskip("hypothesis")  # the other tests here need no hypothesis
    from hypothesis import strategies as st

    @hypothesis.settings(max_examples=400, deadline=None, derandomize=True,
                         suppress_health_check=[hypothesis.HealthCheck.too_slow])
    @hypothesis.given(_quads(st))
    def check(rows):
        _check_culling(rows)

    check()


def test_culling_skips_most_pairs_of_small_quads():
    """On quads of the headline's size (~2 px) the block bound culls most
    (entry, block) pairs, the pixel test matches the reference on every
    (entry, pixel) pair, and no culled block holds a covered pixel."""
    r = np.random.default_rng(3)
    uncovered, culled = [], []
    for _ in range(200):
        cx, cy = r.uniform(0.0, 64.0, 2)
        ang = r.uniform(0.0, np.pi)
        size = r.uniform(0.3, 2.0)
        h1 = size * np.array([np.cos(ang), np.sin(ang)])
        h2 = size * np.array([-np.sin(ang), np.cos(ang)])
        s, c = _check_culling([cx, cy, *h1, *h2, 1.0, 1.0, 1.0, 1.0])
        uncovered.append(s)
        culled.append(c)
    assert np.mean(uncovered) > 0.99 and np.mean(culled) > 0.95
