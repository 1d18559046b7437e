"""Depth resolve over CSR triangle bins: a Pallas kernel through Triton.

The replacement for the reference's serial per-pixel hot loop
(our_gl.cpp:147-200).  One program owns one (tile_h, 128) tile of an
active-tile list.  It walks its bin segment — the tile's triangles in
submission order — with a loop whose trip count is the bin's own length,
and merges each triangle by a sequential compare-select: ``z < depth``
takes the pixel.  Submission order plus strict-less is the reference's
first-drawn-wins z-test (our_gl.cpp:165); no atomics, and nothing is
carried between programs, which run in any order.

Per bin entry a program reads the triangle id and that triangle's row
of the per-triangle table (screen xy, NDC z, clip w, clamped bbox).  The
decision math is ops.semantics in the float32 oracle's operation order.
Triton lowers f32 division to the approximate ``div.full.f32``, so on
the GPU the three barycentric divisions are emitted as IEEE
``div.rn.f32``; Triton does not contract mul+add into FMA.  Coverage,
winner and depth therefore match the oracle bit for bit.

The same resolve also yields the reference's exact per-pass counters
(our_gl.cpp:194-200) when ``collect_stats`` is set: the z-pass event
count and the max z over events, as two extra planes.

Varyings are interpolated after the merge, in XLA (``interp_varyings``):
one gather of the winning triangle's row per pixel, then the same
perspective-correct formulas as the scan path's phase B
(ops.raster.shade_winners).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tinyrenderder_tpu.ops import device, semantics
from tinyrenderder_tpu.ops.raster import BACKGROUND
from tinyrenderder_tpu.ops.raster_tiled import (TILE_H, TILE_W, Bins,
                                                _from_tiles, _to_tiles)

__all__ = ["TriRecords", "build_records", "resolve_tiles",
           "interp_varyings", "depth_resolve_pallas"]

# Per-triangle table columns (f32):
#   0..5    screen ax, ay, bx, by, cx, cy
#   6..8    NDC z0, z1, z2
#   9..11   clip w0, w1, w2 (phase C only)
#   12..15  bbox min_x, max_x, min_y, max_y (exact small ints as f32)
TBL = 16
_Z, _W, _BB = 6, 9, 12

#: warps per program (one program = one tile of tile_h x 128 pixels).
#: Chosen on an H100 inside the fused frame (PERF.md): 1 < 2 < 4 < 8 <
#: 16 <= 32, i.e. the more threads share a tile's pixels, the faster.
NUM_WARPS = 32


class TriRecords(NamedTuple):
    """What the resolve reads for one pass: the bins' triangle ids in
    bin order, the per-triangle table, and (color passes) the corner
    varyings for phase C."""

    sorted_tri: jax.Array        # (P,) int32, tile-major bin entries
    table: jax.Array             # (max(F, 1), TBL) f32
    vary: jax.Array | None       # (F, 3, V) f32, None for depth-only


def build_records(setup, sorted_tri, vary_corners=None) -> TriRecords:
    """Pack the per-triangle table.  ``vary_corners``: optional
    (F, 3, V) varying corner values."""
    f = setup["valid"].shape[0]
    if f == 0:
        # keep the in-kernel loads in range for a zero-face pass (its
        # bins are empty, so no row is ever read)
        table = jnp.zeros((1, TBL), jnp.float32)
    else:
        table = jnp.concatenate([
            setup["screen"].reshape(-1, 6).astype(jnp.float32),
            setup["ndc_z"].astype(jnp.float32),
            setup["clip_w"].astype(jnp.float32),
            setup["bbox"].astype(jnp.float32),
        ], axis=1)
    return TriRecords(sorted_tri.astype(jnp.int32), table, vary_corners)


def _div_rn(a, b):
    """IEEE round-to-nearest f32 division (PTX ``div.rn.f32``)."""
    b = jnp.broadcast_to(b, a.shape)
    [q] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, a.dtype)])
    return q


def _pixel_grid(t, origin, n_tiles_x, tile_h, tile_w, y_stride, shape):
    """Global integer pixel coordinates (as f32) of tile ``t``: ``origin``
    is this buffer's global pixel offset (row-band sharding); a
    ``y_stride`` above ``tile_h`` is an interleaved row band (local tile
    row j is global row origin_y/tile_h + j*stride)."""
    gx0 = origin[0] + (t % n_tiles_x) * tile_w
    gy0 = origin[1] + (t // n_tiles_x) * y_stride
    xi = gx0 + jax.lax.broadcasted_iota(jnp.int32, shape, len(shape) - 1)
    yi = gy0 + jax.lax.broadcasted_iota(jnp.int32, shape, len(shape) - 2)
    return xi.astype(jnp.float32), yi.astype(jnp.float32)


def _merge(tri, col, xi, yi, depth, winner, ev, div):
    """Test one triangle against a block of pixels and merge it
    (strict-less, so the earlier triangle keeps ties).  ``col(j)`` reads
    table column j of ``tri``."""
    half = jnp.float32(0.5)
    px = xi + half
    py = yi + half
    b0, b1, b2, _ = semantics.barycentric(
        col(0), col(1), col(2), col(3), col(4), col(5), px, py, jnp,
        div=div)
    covered = semantics.coverage_mask(b0, b1, b2)
    z = semantics.affine_z(col(_Z), col(_Z + 1), col(_Z + 2), b0, b1, b2)
    covered &= jnp.isfinite(z)
    covered &= ((xi >= col(_BB)) & (xi <= col(_BB + 1))
                & (yi >= col(_BB + 2)) & (yi <= col(_BB + 3)))
    take = covered & (z < depth)
    depth = jnp.where(take, z, depth)
    winner = jnp.where(take, tri, winner)
    if ev is not None:
        n, zmax = ev
        ev = (n + take.astype(jnp.float32),
              jnp.maximum(zmax, jnp.where(take, z, -jnp.inf)))
    return depth, winner, ev


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _resolve_kernel(ids_ref, start_ref, count_ref, origin_ref, tri_ref,
                    tbl_ref, init_ref, depth_ref, winner_ref, *ev_ref,
                    n_tiles_x, tile_h, tile_w, y_stride, exact_div):
    i = pl.program_id(0)
    t = ids_ref[i]
    seg = start_ref[i]
    count = count_ref[i]
    origin = (origin_ref[0], origin_ref[1])
    xi, yi = _pixel_grid(t, origin, n_tiles_x, tile_h, tile_w, y_stride,
                         (tile_h, tile_w))
    div = _div_rn if exact_div else None
    stats = bool(ev_ref)

    def body(k, carry):
        depth, winner, *ev = carry
        tri = tri_ref[seg + k]
        depth, winner, ev = _merge(
            tri, lambda j: tbl_ref[tri, j], xi, yi, depth, winner,
            tuple(ev) if stats else None, div)
        return (depth, winner, *(ev or ()))

    init = (init_ref[t],
            jnp.full((tile_h, tile_w), BACKGROUND, jnp.int32))
    if stats:
        init += (jnp.zeros((tile_h, tile_w), jnp.float32),
                 jnp.full((tile_h, tile_w), -jnp.inf, jnp.float32))
    depth, winner, *ev = jax.lax.fori_loop(0, count, body, init)
    depth_ref[0] = depth
    winner_ref[0] = winner
    if stats:
        ev_ref[0][0, 0] = ev[0]
        ev_ref[0][0, 1] = ev[1]


@functools.partial(jax.jit, static_argnames=(
    "n_tiles_x", "tile_h", "tile_w", "interpret", "collect_stats",
    "y_stride"))
def _resolve_kernel_jit(ids, start, counts, sorted_tri, table, depth_frame,
                        origin, n_tiles_x, tile_h, tile_w, interpret,
                        collect_stats, y_stride):
    a = ids.shape[0]
    if sorted_tri.shape[0] == 0:
        sorted_tri = jnp.zeros((1,), jnp.int32)
    kernel = functools.partial(
        _resolve_kernel, n_tiles_x=n_tiles_x, tile_h=tile_h, tile_w=tile_w,
        y_stride=y_stride, exact_div=not interpret)
    tile = pl.BlockSpec((1, tile_h, tile_w), lambda i: (i, 0, 0))
    whole = pl.BlockSpec()
    out_specs = [tile, tile]
    out_shape = [jax.ShapeDtypeStruct((a, tile_h, tile_w), jnp.float32),
                 jax.ShapeDtypeStruct((a, tile_h, tile_w), jnp.int32)]
    ins = [ids, start, counts, origin, sorted_tri, table, depth_frame]
    if collect_stats:
        out_specs.append(pl.BlockSpec((1, 2, tile_h, tile_w),
                                      lambda i: (i, 0, 0, 0)))
        out_shape.append(
            jax.ShapeDtypeStruct((a, 2, tile_h, tile_w), jnp.float32))
    out = pl.pallas_call(
        kernel,
        grid=(a,),
        in_specs=[whole] * len(ins),
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        name="depth_resolve",
    )(*ins)
    depth, winner, *ev = out
    return depth, winner, (ev[0] if ev else None)


def interp_varyings(records: TriRecords, winner_c, ids, n_tiles_x: int,
                    tile_h: int, tile_w: int, origin, y_stride: int):
    """Phase C input: per-pixel perspective-correct varyings of the
    winning triangle, (A, V, tile_h, tile_w).  Pixels without a winner
    hold garbage that the merge masks out."""
    table, vary = records.table, records.vary
    f = vary.shape[0]
    widx = jnp.clip(winner_c, 0, f - 1)
    xi, yi = _pixel_grid(ids[:, None, None], origin, n_tiles_x, tile_h,
                         tile_w, y_stride, (1, tile_h, tile_w))
    half = jnp.float32(0.5)
    px = jnp.broadcast_to(xi + half, widx.shape)
    py = jnp.broadcast_to(yi + half, widx.shape)
    scr = table[:, :6][widx]                          # (A, th, tw, 6)
    ws = table[:, _W:_W + 3][widx]                    # (A, th, tw, 3)
    b0, b1, b2, _ = semantics.barycentric(
        scr[..., 0], scr[..., 1], scr[..., 2], scr[..., 3], scr[..., 4],
        scr[..., 5], px, py, jnp)
    pb0, pb1, pb2 = semantics.perspective_correct_bary(
        b0, b1, b2, ws[..., 0], ws[..., 1], ws[..., 2], jnp)
    vw = vary.astype(jnp.float32)[widx]               # (A, th, tw, 3, V)
    val = semantics.interp3(vw[..., 0, :], vw[..., 1, :], vw[..., 2, :],
                            pb0[..., None], pb1[..., None], pb2[..., None])
    return jnp.moveaxis(val, -1, 1)


def resolve_tiles(ids, start, counts, records: TriRecords, depth_frame,
                  n_tiles_x: int, tile_h: int, tile_w: int, n_vary: int,
                  interpret: bool, origin=None, collect_stats: bool = False,
                  y_stride: int | None = None):
    """Depth resolve of the tiles ``ids`` (tile ids of ``depth_frame``,
    in range; padding entries carry count 0) against their bins
    ``records.sorted_tri[start[i]:start[i] + counts[i]]``.

    Returns compact (A, tile_h, tile_w) planes: depth (f32), winner
    (int32 pass-local triangle id, BACKGROUND where the pass did not win),
    varyings (A, n_vary, tile_h, tile_w) or None, and with
    ``collect_stats`` the (A, 2, tile_h, tile_w) event planes (z-pass
    event count, max z over events), else None."""
    if interpret and device.platform() == "gpu":
        raise ValueError("the resolve kernel never runs interpreted on "
                         "the GPU")
    if origin is None:
        origin = jnp.zeros((2,), jnp.int32)
    origin = origin.astype(jnp.int32)
    if y_stride is None:
        y_stride = tile_h                 # contiguous band / single device
    args = (ids.astype(jnp.int32), start.astype(jnp.int32),
            counts.astype(jnp.int32), records.sorted_tri, records.table,
            depth_frame, origin)
    depth, winner, ev = _resolve_kernel_jit(
        *args, n_tiles_x=n_tiles_x, tile_h=tile_h, tile_w=tile_w,
        interpret=interpret, collect_stats=collect_stats, y_stride=y_stride)
    vary = None
    if n_vary:
        vary = interp_varyings(records, winner, args[0], n_tiles_x, tile_h,
                               tile_w, origin, y_stride)
    return depth, winner, vary, ev


# ---------------------------------------------------------------------------
# Dense (every screen tile) entry point
# ---------------------------------------------------------------------------

def depth_resolve_pallas(setup, bins: Bins, init_depth,
                         height: int, width: int,
                         tile_h: int = TILE_H, tile_w: int = TILE_W,
                         interpret: bool | None = None):
    """Phase A over every screen tile — same contract as
    raster_tiled.depth_resolve_tiled: (depth (H, W), winner (H, W) i32)."""
    if interpret is None:
        interpret = device.interpret()
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    records = build_records(setup, bins.sorted_tri)
    init_tiles = _to_tiles(init_depth, nty, ntx, tile_h, tile_w, jnp.inf)
    depth_t, winner_t, _, _ = resolve_tiles(
        jnp.arange(ntx * nty, dtype=jnp.int32), bins.start[:-1],
        bins.counts, records, init_tiles, ntx, tile_h, tile_w, 0,
        interpret)
    return (_from_tiles(depth_t, nty, ntx, tile_h, tile_w, height, width),
            _from_tiles(winner_t, nty, ntx, tile_h, tile_w, height, width))
