"""Binned tile rasterizer — the work-efficient device path.

The pure-XLA scan path (ops.raster) touches every screen pixel for every
triangle chunk: O(F * H * W).  This module first *bins* triangles to
screen tiles (the data-parallel replacement for the reference's
per-pixel bbox walk, our_gl.cpp:130-148), so depth resolve costs only
O(sum over triangles of (tiles overlapped) * tile_area):

  1. Per-triangle tile span from the clamped screen bbox.
  2. Expand to (tile, triangle) pairs with the classic scatter-heads +
     segmented-fill trick (no dynamic shapes: pair capacity is a static,
     power-of-two-padded bound).
  3. Stable-sort pairs by tile id -> CSR bins (pair order within a tile is
     triangle submission order, which preserves the reference's
     first-drawn-wins z-tie semantics, our_gl.cpp:165).
  4. Depth-resolve each tile against only its bin (scan over bin chunks),
     with pixels of a tile laid out as a (TILE_H, 128) block.
  5. Shade winners once per pixel via the shared gather-based phase B
     (ops.raster.shade_winners).

Decision math is ops.semantics, so output is bit-identical to the scan
path and parity-comparable with the CPU oracle.  The production path
(ops.raster_sparse) resolves the same bins with the Pallas kernel in
ops.raster_pallas (dynamic per-tile trip counts); this XLA version is
the portable fallback and the correctness reference for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import raster, semantics
from tinyrenderder_tpu.ops.raster import BACKGROUND, FrameBuffers
from tinyrenderder_tpu.shaders import finalize_color

__all__ = ["render_pass_tiled", "bin_triangles_csr", "Bins",
           "TILE_H", "TILE_W"]

# Tile shape: one resolve program owns a (TILE_H, TILE_W) block of
# pixels (both powers of two, as Triton blocks must be).  16 rows beat
# 32 on the card even at 2048x2048 (PERF.md): a pair costs the tile's
# area and phase C shades every pixel of an active tile.  Frames are
# bitwise-identical at any tile height.
TILE_H = 16
TILE_W = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


# ---------------------------------------------------------------------------
# Binning: triangles -> per-tile CSR bins
# ---------------------------------------------------------------------------

class Bins:
    """CSR triangle bins: sorted_tri[start[t]:start[t+1]] are the triangle
    ids overlapping tile t, ascending (= submission order)."""

    def __init__(self, sorted_tri, start, counts, n_tiles_x, n_tiles_y,
                 total_pairs=None, capacity=None):
        self.sorted_tri = sorted_tri      # (P,) int32, -1 padding at the end
        self.start = start                # (T + 1,) int32
        self.counts = counts              # (T,) int32
        self.n_tiles_x = n_tiles_x
        self.n_tiles_y = n_tiles_y
        self.total_pairs = total_pairs    # device scalar (unfetched)
        self.capacity = capacity          # static pair capacity used

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_x * self.n_tiles_y

    def overflowed(self) -> bool:
        """Host-syncs the true pair count; True if pairs were dropped.
        Call *after* dispatching downstream work so the transfer overlaps."""
        if self.total_pairs is None or self.capacity is None:
            return False
        return int(jax.device_get(self.total_pairs)) > self.capacity


@functools.partial(jax.jit, static_argnames=("tile_w", "tile_h",
                                             "ty_stride"))
def _tile_spans(setup, tile_w: int, tile_h: int, ty_lo=None, ty_hi=None,
                tx_lo=None, tx_hi=None, ty_stride: int = 1):
    """Per-triangle tile ranges and pair spans from the clamped bbox.

    ``ty_lo``/``ty_hi`` and ``tx_lo``/``tx_hi`` (inclusive, may be
    traced) clip the tile range to a screen block — the sharded paths
    bin each device's block independently; returned tx0/ty0 are
    block-local.

    ``ty_stride`` (static) > 1 selects an INTERLEAVED row band: the
    device owns global tile rows ty_lo, ty_lo+stride, ... (ty_hi is
    then the count-1 in stride units, i.e. the last owned row is
    ty_lo + ty_hi*stride).  Owned rows are consecutive in block-local
    space, so the pair expansion (_build_bins) is unchanged — only this
    clip and the kernels' y origin know about the stride.  Interleaving
    splits coverage hot spots (which are contiguous in y) evenly across
    devices.
    """
    bbox = setup["bbox"]                      # (F, 4) min_x, max_x, min_y, max_y
    valid = setup["valid"]
    tx0 = bbox[:, 0] // tile_w
    tx1 = bbox[:, 1] // tile_w
    ty0 = bbox[:, 2] // tile_h
    ty1 = bbox[:, 3] // tile_h
    if ty_lo is not None and ty_stride > 1:
        # owned global rows: ty_lo + m*stride for m in [0, ty_hi];
        # block-local row = m.  (stride is a static python int, so the
        # divisions lower to constant-divisor sequences, not the slow
        # per-element VPU div — see _exact_divmod_i32.)
        m0 = (jnp.maximum(ty0 - ty_lo, 0) + (ty_stride - 1)) // ty_stride
        m1 = jnp.minimum((ty1 - ty_lo) // ty_stride, ty_hi)
        span_y = jnp.where(valid & (m1 >= m0), m1 - m0 + 1, 0)
        ty0 = m0                              # block-local
    elif ty_lo is not None:
        ty0c = jnp.maximum(ty0, ty_lo)
        ty1c = jnp.minimum(ty1, ty_hi)
        span_y = jnp.where(valid & (ty1c >= ty0c), ty1c - ty0c + 1, 0)
        ty0 = ty0c - ty_lo                    # block-local
    else:
        span_y = jnp.where(valid, ty1 - ty0 + 1, 0)
    if tx_lo is not None:
        tx0c = jnp.maximum(tx0, tx_lo)
        tx1c = jnp.minimum(tx1, tx_hi)
        span_x = jnp.where(valid & (tx1c >= tx0c), tx1c - tx0c + 1, 0)
        tx0 = tx0c - tx_lo                    # block-local
    else:
        span_x = jnp.where(valid, tx1 - tx0 + 1, 0)
    span_x = span_x.astype(jnp.int32)
    span_y = span_y.astype(jnp.int32)
    spans = jnp.where(span_y > 0, span_x, 0) * span_y
    total = jnp.sum(spans)
    return tx0.astype(jnp.int32), ty0.astype(jnp.int32), span_x, spans, total


def _exact_divmod_i32(k, s):
    """(k // s, k % s) for non-negative int32 via f32 division + a one-step
    correction — exact for k < 2^21 (f32 quotient error < 0.5 there, and
    the correction absorbs an approximate divide's last-bit error too).
    Bitwise-equal to integer div/mod in range."""
    q = jnp.floor(k.astype(jnp.float32)
                  / s.astype(jnp.float32)).astype(jnp.int32)
    r = k - q * s
    q = q + (r >= s).astype(jnp.int32) - (r < 0).astype(jnp.int32)
    r = k - q * s
    return q, r


#: jnp.searchsorted lowering for the CSR start offsets (output is
#: method-independent).
_SEARCHSORTED_METHOD = "scan"


@functools.partial(jax.jit,
                   static_argnames=("pair_capacity", "n_tiles_x", "n_tiles_y",
                                    "return_keys"))
def _build_bins(tx0, ty0, span_x, spans, pair_capacity: int,
                n_tiles_x: int, n_tiles_y: int, return_keys: bool = False):
    """Expand spans into (tile, tri) pairs and sort by tile (stable).

    All five per-triangle columns travel through ONE packed row gather,
    and the in-run div/mod uses the exact-f32 form (_exact_divmod_i32)."""
    f = spans.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    p = pair_capacity

    offs = jnp.cumsum(spans) - spans          # exclusive prefix sum (F,)
    has = spans > 0
    # scatter run heads; offsets of span>0 triangles are strictly increasing
    head_idx = jnp.where(has, offs, p)        # p = out of range -> dropped
    tri_ids = jnp.arange(f, dtype=jnp.int32)
    heads = jnp.full((p,), -1, jnp.int32).at[head_idx].set(
        tri_ids, mode="drop")
    # segmented fill: triangle ids are ascending, so a running max
    # propagates each head through its run
    tri = jax.lax.cummax(heads)

    pair_pos = jnp.arange(p, dtype=jnp.int32)
    safe_tri = jnp.maximum(tri, 0)
    ptbl = jnp.stack([offs, spans, jnp.maximum(span_x, 1), tx0, ty0],
                     axis=1)                  # (F, 5) packed columns
    pg = ptbl[safe_tri]                       # ONE per-pair row gather
    k = pair_pos - pg[:, 0]                   # index within the run
    in_run = (tri >= 0) & (k < pg[:, 1])

    if p < (1 << 21):
        ky, kx = _exact_divmod_i32(k, pg[:, 2])
    else:
        # k can exceed the exact-f32 divmod range (2^21); fall back to
        # true integer div/mod, correct at any capacity
        kc = jnp.maximum(k, 0)
        ky = kc // pg[:, 2]
        kx = kc - ky * pg[:, 2]
    tile_x = pg[:, 3] + kx
    tile_y = pg[:, 4] + ky
    tile_id = tile_y * n_tiles_x + tile_x
    tile_id = jnp.where(in_run, tile_id, n_tiles)   # sentinel sorts to end

    sorted_tile, sorted_tri = jax.lax.sort(
        (tile_id.astype(jnp.int32), jnp.where(in_run, tri, -1)), num_keys=1)
    start = jnp.searchsorted(sorted_tile,
                             jnp.arange(n_tiles + 1, dtype=jnp.int32),
                             side="left",
                             method=_SEARCHSORTED_METHOD).astype(jnp.int32)
    counts = start[1:] - start[:-1]
    if return_keys:
        return sorted_tri, start, counts, sorted_tile
    return sorted_tri, start, counts


# pair-capacity cache: (F, tiles_x, tiles_y) -> last-known-good capacity.
# Avoids a per-frame host sync; overflow is detected after downstream
# dispatch via Bins.overflowed().
_PAIR_CAPACITY: dict = {}

def bin_triangles_csr(setup, width: int, height: int,
                      tile_w: int = TILE_W, tile_h: int = TILE_H,
                      capacity: int | None = None) -> Bins:
    """Bin a pass's triangles to screen tiles.

    The static pair capacity comes from the cache (first frame of a
    (mesh, resolution) pair syncs once, with 2x headroom); callers must
    check ``bins.overflowed()`` after dispatching downstream work and
    retry with ``capacity=next_pow2(true_total)`` if it fires.
    """
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    key = (int(setup["valid"].shape[0]), n_tiles_x, n_tiles_y,
           tile_h, tile_w)
    tx0, ty0, span_x, spans, total = _tile_spans(setup, tile_w, tile_h)
    if capacity is None:
        capacity = _PAIR_CAPACITY.get(key)
        if capacity is None:                      # first frame: sync once
            capacity = _quantize_capacity(int(jax.device_get(total)))
        _PAIR_CAPACITY[key] = capacity
    else:
        # an explicit capacity only GROWS the shared cache entry: the
        # overflow retry's next_pow2 must persist, but a forced-small
        # test capacity must not poison later frames with the same key
        prev = _PAIR_CAPACITY.get(key)
        if prev is None or capacity > prev:
            _PAIR_CAPACITY[key] = capacity
    sorted_tri, start, counts = _build_bins(
        tx0, ty0, span_x, spans, capacity, n_tiles_x, n_tiles_y)
    return Bins(sorted_tri, start, counts, n_tiles_x, n_tiles_y,
                total_pairs=total, capacity=capacity)


def _quantize_soft(n: int) -> int:
    """12.5% headroom on a sixteenth-pow2 grain: every pre-stage op
    (sort, gathers, scatter, records) scales with capacity, so the pow2
    grain's up-to-2x inflation is worth trading for more (cheap,
    compile variants.  Growth on overflow lands on the next grain step,
    so drifting scenes step at most 16 times per octave."""
    want = n + n // 8
    grain = max(256, _next_pow2(want) // 16)
    return max(256, _cdiv(want, grain) * grain)


def _quantize_capacity(total: int) -> int:
    """Static pair capacity: 25% headroom rounded to a power of two
    (pow2 quantization bounds the number of distinct compiled programs
    as pair counts drift across frames)."""
    return max(8, _next_pow2(total + total // 4))


# ---------------------------------------------------------------------------
# Tiled depth resolve
# ---------------------------------------------------------------------------

def _to_tiles(img, n_tiles_y, n_tiles_x, tile_h, tile_w, fill):
    """(H, W) -> (T, tile_h, tile_w), padding ragged edges with `fill`."""
    h, w = img.shape
    ph, pw = n_tiles_y * tile_h, n_tiles_x * tile_w
    if (ph, pw) != (h, w):
        img = jnp.pad(img, ((0, ph - h), (0, pw - w)), constant_values=fill)
    return (img.reshape(n_tiles_y, tile_h, n_tiles_x, tile_w)
               .transpose(0, 2, 1, 3)
               .reshape(n_tiles_y * n_tiles_x, tile_h, tile_w))


def _from_tiles(tiles, n_tiles_y, n_tiles_x, tile_h, tile_w, height, width):
    img = (tiles.reshape(n_tiles_y, n_tiles_x, tile_h, tile_w)
                .transpose(0, 2, 1, 3)
                .reshape(n_tiles_y * tile_h, n_tiles_x * tile_w))
    return img[:height, :width]


def depth_resolve_tiled(setup, bins: Bins, init_depth,
                        height: int, width: int,
                        tile_h: int = TILE_H, tile_w: int = TILE_W,
                        bin_capacity: int | None = None, chunk: int = 8):
    """Phase A over CSR bins.  Returns (depth (H, W), winner (H, W) i32).

    Exact same decisions as raster.depth_resolve_xla: NaN-tolerant
    coverage, affine z, bbox test in global pixel coords, strict-less
    depth with first-drawn-wins ties (bin order = submission order).
    """
    if bin_capacity is None:
        bin_capacity = max(1, int(jax.device_get(jnp.max(bins.counts))))
    bin_capacity = _next_pow2(bin_capacity)
    return _depth_resolve_tiled_jit(
        setup, bins.sorted_tri, bins.start, init_depth,
        height, width, bins.n_tiles_x, bins.n_tiles_y,
        tile_h, tile_w, bin_capacity, chunk)


@functools.partial(jax.jit, static_argnames=(
    "height", "width", "n_tiles_x", "n_tiles_y", "tile_h", "tile_w",
    "bin_capacity", "chunk"))
def _depth_resolve_tiled_jit(setup, sorted_tri, start, init_depth,
                             height, width, n_tiles_x, n_tiles_y,
                             tile_h, tile_w, bin_capacity, chunk):
    n_tiles = n_tiles_x * n_tiles_y
    dtype = setup["screen"].dtype
    f = setup["valid"].shape[0]
    p = sorted_tri.shape[0]

    # padded (T, C) bucket view of the CSR bins, -1 where empty
    c = bin_capacity
    counts = start[1:] - start[:-1]
    slot = jnp.arange(c, dtype=jnp.int32)[None, :]              # (1, C)
    idx = jnp.clip(start[:-1, None] + slot, 0, p - 1)
    bucket = jnp.where(slot < counts[:, None], sorted_tri[idx], -1)

    # global pixel coordinates of each tile's block
    t_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    gx0 = (t_ids % n_tiles_x) * tile_w                          # (T,)
    gy0 = (t_ids // n_tiles_x) * tile_h
    xi = gx0[:, None, None] + jnp.arange(tile_w, dtype=jnp.int32)[None, None, :]
    yi = gy0[:, None, None] + jnp.arange(tile_h, dtype=jnp.int32)[None, :, None]
    half = jnp.asarray(0.5, dtype=dtype)
    px = xi.astype(dtype) + half                                # (T, 1, TW)
    py = yi.astype(dtype) + half                                # (T, TH, 1)
    px = px[:, None]                                            # (T, 1, 1, TW)
    py = py[:, None]                                            # (T, 1, TH, 1)
    xi = xi[:, None]
    yi = yi[:, None]

    screen = setup["screen"].astype(dtype)
    ndc_z = setup["ndc_z"].astype(dtype)
    bbox = setup["bbox"]
    valid = setup["valid"]

    init_zt = _to_tiles(init_depth, n_tiles_y, n_tiles_x, tile_h, tile_w,
                        jnp.inf)
    init_it = jnp.full((n_tiles, tile_h, tile_w), BACKGROUND, jnp.int32)

    nchunk = _cdiv(c, chunk)
    pad = nchunk * chunk - c
    bucket_c = jnp.pad(bucket, ((0, 0), (0, pad)), constant_values=-1)
    bucket_c = bucket_c.reshape(n_tiles, nchunk, chunk).transpose(1, 0, 2)

    def step(carry, tri):                                        # tri (T, K)
        zbuf, idbuf = carry
        live = tri >= 0
        st = jnp.clip(tri, 0, max(f - 1, 0))
        scr = screen[st]                                         # (T, K, 3, 2)
        zs = ndc_z[st]                                           # (T, K, 3)
        bb = bbox[st]                                            # (T, K, 4)

        def tc(k, a):                                            # (T, K, 1, 1)
            return scr[:, :, k, a][..., None, None]

        b0, b1, b2, _ = semantics.barycentric(
            tc(0, 0), tc(0, 1), tc(1, 0), tc(1, 1), tc(2, 0), tc(2, 1),
            px, py, jnp)
        covered = semantics.coverage_mask(b0, b1, b2)
        z = semantics.affine_z(
            zs[:, :, 0, None, None], zs[:, :, 1, None, None],
            zs[:, :, 2, None, None], b0, b1, b2)
        covered &= jnp.isfinite(z)
        covered &= ((xi >= bb[:, :, 0, None, None])
                    & (xi <= bb[:, :, 1, None, None])
                    & (yi >= bb[:, :, 2, None, None])
                    & (yi <= bb[:, :, 3, None, None]))
        covered &= (live & valid[st])[..., None, None]

        zc = jnp.where(covered, z, jnp.inf)
        best = jnp.argmin(zc, axis=1)                            # first min
        zmin = jnp.take_along_axis(zc, best[:, None], axis=1)[:, 0]
        tri_b = jnp.broadcast_to(tri[:, :, None, None], zc.shape)
        win = jnp.take_along_axis(tri_b, best[:, None], axis=1)[:, 0]
        better = zmin < zbuf
        zbuf = jnp.where(better, zmin, zbuf)
        idbuf = jnp.where(better, win, idbuf)
        return (zbuf, idbuf), None

    (zt, it), _ = jax.lax.scan(step, (init_zt, init_it), bucket_c)
    depth = _from_tiles(zt, n_tiles_y, n_tiles_x, tile_h, tile_w,
                        height, width)
    winner = _from_tiles(it, n_tiles_y, n_tiles_x, tile_h, tile_w,
                         height, width)
    return depth, winner


# ---------------------------------------------------------------------------
# Full pass
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("shader", "width", "height"))
def _vertex_setup_jit(attrs, uniforms, shader, width: int, height: int):
    clip, varyings = shader.vertex(uniforms, attrs, jnp)
    vp = jnp.asarray(math3d.viewport(0, 0, width, height),
                     dtype=attrs["position"].dtype)
    setup = semantics.triangle_setup_planes(clip, vp, width, height, jnp)
    return setup, varyings


def _vertex_stage(attrs, uniforms, shader, width: int, height: int,
                  geom_axis=None):
    """Vertex transform + triangle setup over all F triangles — the
    per-triangle stage shared by every pre-kernel path (reference
    anchor: the vertex loop main.cpp:660-665 + setup our_gl.cpp:89-135).

    With ``geom_axis`` (a shard_map axis name, or tuple of names for
    2-D meshes) the stage is GEOMETRY-SHARDED: each device transforms a
    contiguous F/N slice of the triangles and the per-triangle outputs
    are all_gather'ed (tiled).  Contiguous slices concatenated
    in axis order restore the exact submission order, and every op here
    is per-triangle with fixed scalar evaluation order
    (semantics.apply_mat4 — no cross-triangle reduction, no matrix-unit
    contraction), so the sharded result is BITWISE identical to the
    replicated computation.  Zero padding (to a multiple of N) yields
    point-degenerate triangles whose screen edge cross product is
    exactly 0 -> backface-rejected (triangle_setup_planes) -> zero tile
    spans, so padding contributes no pairs downstream.

    This removes the one replicated per-triangle term from the sharded
    fused pipeline.  The all_gather payload is the setup dict + varyings
    (~tens of floats per triangle) — cheap next to the per-pixel
    stages it unblocks.
    """
    if geom_axis is None:
        return _vertex_setup_jit(attrs, uniforms, shader, width, height)
    f = attrs["position"].shape[0]
    n = jax.lax.axis_size(geom_axis)
    if f < n:          # fewer triangles than devices: not worth slicing
        clip, varyings = shader.vertex(uniforms, attrs, jnp)
        vp = jnp.asarray(math3d.viewport(0, 0, width, height),
                         dtype=attrs["position"].dtype)
        return semantics.triangle_setup_planes(
            clip, vp, width, height, jnp), varyings
    chunk = -(-f // n)
    idx = jax.lax.axis_index(geom_axis)

    def slice_leaf(x):
        pad = chunk * n - f
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return jax.lax.dynamic_slice_in_dim(x, idx * chunk, chunk, 0)

    attrs_c = jax.tree.map(slice_leaf, attrs)
    clip_c, vary_c = shader.vertex(uniforms, attrs_c, jnp)
    vp = jnp.asarray(math3d.viewport(0, 0, width, height),
                     dtype=attrs["position"].dtype)
    setup_c = semantics.triangle_setup_planes(clip_c, vp, width, height, jnp)

    def gather_leaf(x):
        full = jax.lax.all_gather(x, geom_axis, tiled=True)
        return full[:f] if full.shape[0] != f else full

    return jax.tree.map(gather_leaf, setup_c), jax.tree.map(
        gather_leaf, vary_c)


@functools.partial(jax.jit, static_argnames=("shader", "width", "height"))
def _shade_merge_jit(fb: FrameBuffers, depth, winner_local, setup, varyings,
                     uniforms, winner_offset, shader, width, height):
    won = winner_local >= 0
    new_winner = jnp.where(won, winner_local + winner_offset, fb.winner)
    if shader.writes_color:
        color = raster.shade_winners(fb.color, winner_local, setup, varyings,
                                     shader, uniforms, height, width)
    else:
        color = fb.color                 # depth-only pass
    return FrameBuffers(color=color, depth=depth, winner=new_winner)


def _varying_layout(shader, varyings):
    """Static (name, channels) layout for packing varyings into planes."""
    spec = tuple((name, varyings[name].shape[-1]) for name in varyings)
    return spec


def _flatten_varyings(varyings, spec=None):
    """{name: (F, 3, C)} -> (F, 3, V) in spec (default: dict) order."""
    names = [n for n, _ in spec] if spec else list(varyings)
    return jnp.concatenate([varyings[n] for n in names], axis=-1)



@functools.partial(jax.jit, static_argnames=(
    "shader", "spec", "width", "height", "tile_h", "tile_w"))
def _post_pallas_jit(fb: FrameBuffers, depth_t, winner_t, vary_t, uniforms,
                     winner_offset, shader, spec, width, height,
                     tile_h, tile_w):
    """Fused post-kernel stage: untile depth/winner/varyings (one
    transpose), dense fragment shading, merge.  Depth-only shaders
    (writes_color=False) skip the varying untile and shading."""
    n_tiles_y = _cdiv(height, tile_h)
    n_tiles_x = _cdiv(width, tile_w)
    depth = _from_tiles(depth_t, n_tiles_y, n_tiles_x, tile_h, tile_w,
                        height, width)
    winner_local = _from_tiles(winner_t.astype(jnp.int32), n_tiles_y,
                               n_tiles_x, tile_h, tile_w, height, width)
    won = winner_local >= 0
    if not shader.writes_color:
        new_winner = jnp.where(won, winner_local + winner_offset, fb.winner)
        return FrameBuffers(color=fb.color, depth=depth, winner=new_winner)
    v = vary_t.shape[1]
    img = (vary_t.reshape(n_tiles_y, n_tiles_x, v, tile_h, tile_w)
           .transpose(0, 3, 1, 4, 2)
           .reshape(n_tiles_y * tile_h, n_tiles_x * tile_w, v)
           [:height, :width])
    vary = {}
    i = 0
    for name, c in spec:
        vary[name] = img[..., i:i + c]
        i += c
    rgb = shader.fragment(uniforms, vary, jnp)
    out = finalize_color(rgb, jnp)
    color = jnp.where(won[..., None], out, fb.color)
    new_winner = jnp.where(won, winner_local + winner_offset, fb.winner)
    return FrameBuffers(color=color, depth=depth, winner=new_winner)


def render_pass_tiled(fb: FrameBuffers, attrs: dict, shader, uniforms: dict,
                      winner_offset: int = 0,
                      tile_h: int = TILE_H, tile_w: int = TILE_W,
                      chunk: int = 8, use_pallas: bool | None = None,
                      strict_capacity: bool = True,
                      _capacity: int | None = None):
    """Render one (mesh, shader) pass through the binned tile pipeline.

    Same contract as raster.render_pass_xla.  ``use_pallas=None`` takes
    the sparse pipeline with the resolve kernel (ops.raster_sparse) on the
    GPU and this module's XLA resolve on the CPU.

    ``strict_capacity=True`` (default) host-syncs the true pair count per
    pass and retries on bin overflow — exact output always, one host
    round trip per pass.  ``strict_capacity=False`` resolves the count
    asynchronously at the *next* frame: steady-state loops never block;
    a frame whose pair count jumps past the cached capacity (+25%
    headroom) may drop triangles once, after which the capacity grows.
    The async contract applies to the Pallas/sparse branch (the
    production path); the XLA fallback branch always validates its bins
    host-side — it is the CPU debug path, not a benchmark target.
    """
    height, width = fb.color.shape[:2]
    uniforms = dict(uniforms)
    f = attrs["position"].shape[0]
    if f == 0:
        empty = {"valid": jnp.zeros((0,), bool),
                 "screen": jnp.zeros((0, 3, 2), jnp.float32),
                 "ndc_z": jnp.zeros((0, 3), jnp.float32),
                 "clip_w": jnp.zeros((0, 3), jnp.float32),
                 "bbox": jnp.zeros((0, 4), jnp.int32)}
        return fb, empty

    if use_pallas is None:
        from tinyrenderder_tpu.ops import device
        use_pallas = device.platform() == "gpu"

    if use_pallas:
        # sparse active-tile pipeline (ops.raster_sparse): compacted
        # kernel grid + tiled-resident merge; this wrapper keeps the
        # (H, W) FrameBuffers contract by tiling/untiling per pass —
        # frame loops should hold FrameTiles directly (scene.py does)
        from tinyrenderder_tpu.ops import raster_sparse
        caps = None
        if _capacity is not None:     # test hook: forced pair capacity
            n_tiles = _cdiv(width, tile_w) * _cdiv(height, tile_h)
            caps = (_capacity, n_tiles)
        ft = raster_sparse.buffers_to_tiles(fb, width, height,
                                            tile_h, tile_w)
        ft, setup, _ = raster_sparse.render_pass_tiles(
            ft, attrs, shader, uniforms, width, height,
            winner_offset=winner_offset, tile_h=tile_h, tile_w=tile_w,
            strict_capacity=strict_capacity, _caps=caps)
        return raster_sparse.tiles_to_buffers(ft, width, height,
                                              tile_h, tile_w), setup

    setup, varyings = _vertex_setup_jit(attrs, uniforms, shader, width, height)
    bins = bin_triangles_csr(setup, width, height, tile_w, tile_h,
                             capacity=_capacity)
    depth, winner_local = depth_resolve_tiled(
        setup, bins, fb.depth, height, width, tile_h, tile_w, chunk=chunk)
    new_fb = _shade_merge_jit(fb, depth, winner_local, setup, varyings,
                              uniforms, jnp.int32(winner_offset), shader,
                              width, height)
    if bins.overflowed():
        grown = _quantize_capacity(int(jax.device_get(bins.total_pairs)))
        return render_pass_tiled(fb, attrs, shader, uniforms, winner_offset,
                                 tile_h, tile_w, chunk, use_pallas,
                                 strict_capacity, _capacity=grown)
    return new_fb, setup
