"""Active-tile sparse pipeline: tiled-resident framebuffers + compacted
kernel grids.

  * ``FrameTiles`` keeps the frame in (T, tile_h, tile_w) tiled layout
    across ALL passes; the single (H, W) untile happens once per frame
    at the transfer boundary (z-snapshot/restore around excluded passes
    stays a free pytree swap).
  * The resolve kernel (ops.raster_pallas) runs over a COMPACTED list of
    non-empty tile ids.  Outputs are compact (A_cap, th, tw) blocks
    scattered back into the frame; untouched tiles cost nothing.
    Fragment shading (phase C) also runs only on the compact active
    set, so texture-gather cost scales with covered area instead of
    screen area.

Decision math is ops.semantics inside the resolve, so coverage/winner
maps match the XLA tiled path and the oracle.

The reference anchor is unchanged: this replaces the serial per-pixel
loop of our_gl.cpp:147-200.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import device, raster_pallas, semantics
from tinyrenderder_tpu.ops.raster import BACKGROUND, FrameBuffers
from tinyrenderder_tpu.ops.raster_tiled import (TILE_H, TILE_W, _build_bins,
                                                _cdiv, _next_pow2,
                                                _quantize_soft, _tile_spans,
                                                _vertex_stage)
from tinyrenderder_tpu.shaders import finalize_color

__all__ = ["FrameTiles", "new_frame_tiles", "tiles_to_buffers",
           "buffers_to_tiles", "render_pass_tiles"]


class FrameTiles(NamedTuple):
    """Framebuffers resident in tiled layout: tile t covers pixel rows
    (t // ntx)*th .. +th and cols (t % ntx)*tw .. +tw.  Ragged-edge
    padding pixels can never be covered (the bbox test is in global
    pixel coords), so they stay background and slicing untiles exactly.

    Color is PACKED 0x00BBGGRR int32 (not (..., 3) uint8): one 32-bit
    plane makes every tile buffer the same (T, th, tw) 32-bit shape and
    the per-pass merge moves one word per pixel."""

    color: jax.Array     # (T, th, tw) i32, packed 0x00BBGGRR
    depth: jax.Array     # (T, th, tw) f32
    winner: jax.Array    # (T, th, tw) i32


def _pack_rgb(rgb_u8):
    """(..., 3) uint8 -> packed 0x00BBGGRR int32."""
    c = rgb_u8.astype(jnp.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def _unpack_rgb(packed):
    """packed int32 -> (..., 3) uint8."""
    return jnp.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                      (packed >> 16) & 0xFF], axis=-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("width", "height", "tile_h",
                                             "tile_w"))
def new_frame_tiles(width: int, height: int, tile_h: int = TILE_H,
                    tile_w: int = TILE_W) -> FrameTiles:
    n = _cdiv(width, tile_w) * _cdiv(height, tile_h)
    return FrameTiles(
        color=jnp.zeros((n, tile_h, tile_w), jnp.int32),
        depth=jnp.full((n, tile_h, tile_w), jnp.inf, jnp.float32),
        winner=jnp.full((n, tile_h, tile_w), BACKGROUND, jnp.int32),
    )


def _to_tiles_nd(img, nty, ntx, th, tw, fill):
    """(H, W, ...) -> (T, th, tw, ...) with ragged edges padded."""
    h, w = img.shape[:2]
    ph, pw = nty * th, ntx * tw
    if (ph, pw) != (h, w):
        pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
        img = jnp.pad(img, pad, constant_values=fill)
    tail = img.shape[2:]
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
    return (img.reshape((nty, th, ntx, tw) + tail)
               .transpose(perm)
               .reshape((nty * ntx, th, tw) + tail))


def _from_tiles_nd(tiles, nty, ntx, th, tw, height, width):
    tail = tiles.shape[3:]
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
    img = (tiles.reshape((nty, ntx, th, tw) + tail)
                .transpose(perm)
                .reshape((nty * th, ntx * tw) + tail))
    return img[:height, :width]


@functools.partial(jax.jit, static_argnames=("width", "height", "tile_h",
                                             "tile_w"))
def buffers_to_tiles(fb: FrameBuffers, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W) -> FrameTiles:
    nty, ntx = _cdiv(height, tile_h), _cdiv(width, tile_w)
    return FrameTiles(
        color=_to_tiles_nd(_pack_rgb(fb.color), nty, ntx, tile_h, tile_w, 0),
        depth=_to_tiles_nd(fb.depth, nty, ntx, tile_h, tile_w, jnp.inf),
        winner=_to_tiles_nd(fb.winner, nty, ntx, tile_h, tile_w, BACKGROUND),
    )


@functools.partial(jax.jit, static_argnames=("width", "height", "tile_h",
                                             "tile_w"))
def tiles_to_buffers(ft: FrameTiles, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W
                     ) -> FrameBuffers:
    """The transfer boundary: tiled frame -> (H, W) FrameBuffers."""
    nty, ntx = _cdiv(height, tile_h), _cdiv(width, tile_w)

    def untile(x):
        return _from_tiles_nd(x, nty, ntx, tile_h, tile_w, height, width)

    return FrameBuffers(color=_unpack_rgb(untile(ft.color)),
                        depth=untile(ft.depth), winner=untile(ft.winner))


@functools.partial(jax.jit, static_argnames=("width", "height", "tile_h",
                                             "tile_w"))
def untile_plane(x, width: int, height: int, tile_h: int = TILE_H,
                 tile_w: int = TILE_W):
    """One (T, th, tw) plane -> (H, W) (e.g. an excluded pass's depth)."""
    return _from_tiles_nd(x, _cdiv(height, tile_h), _cdiv(width, tile_w),
                          tile_h, tile_w, height, width)


@functools.partial(jax.jit, static_argnames=(
    "shader", "width", "height", "capacity", "a_cap",
    "tile_h", "tile_w", "nty_band", "ty_stride", "ntx_band", "geom_axis"))
def _pre_sparse_jit(attrs, uniforms, shader, width, height, capacity,
                    a_cap, tile_h, tile_w, ty_lo=None,
                    nty_band=None, ty_stride=1, tx_lo=None, ntx_band=None,
                    geom_axis=None, ty_rows=None):
    """Fused pre-kernel stage: vertex transform, setup, binning, the
    per-triangle records, and active-tile compaction — one dispatch.

    ``capacity`` (soft-grained) is the static pair capacity.

    ``ty_lo`` (traced tile-row offset) + ``nty_band`` (static tile-row
    count) restrict binning to a horizontal band of the screen — the
    sharded production path (parallel/dist.py) runs this per device with
    its own band; tile ids and the active-tile compaction are then
    band-local (pair with an ``origin`` on the kernel call).
    ``tx_lo``/``ntx_band`` clip columns the same way (2-D screen-block
    sharding).  ``geom_axis`` (shard_map axis name/tuple) additionally
    shards the per-triangle vertex stage over the mesh (see
    raster_tiled._vertex_stage — bitwise-equal, all_gather'ed).
    ``ty_rows`` (traced, <= nty_band) narrows the band to its first
    ``ty_rows`` tile rows — measured-load bands give devices UNEQUAL
    contiguous row counts under one static shape (parallel/dist.py);
    rows past ty_rows bin nothing and stay background."""
    setup, varyings = _vertex_stage(attrs, uniforms, shader, width,
                                    height, geom_axis)
    n_tiles_x = ntx_band if ntx_band is not None else _cdiv(width, tile_w)
    n_tiles_y = nty_band if nty_band is not None else _cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    ty_hi = (None if ty_lo is None
             else (n_tiles_y - 1 if ty_stride > 1
                   else ty_lo + ((ty_rows - 1) if ty_rows is not None
                                 else n_tiles_y - 1)))
    tx_hi = None if tx_lo is None else tx_lo + (n_tiles_x - 1)
    tx0, ty0, span_x, spans, total = _tile_spans(setup, tile_w, tile_h,
                                                 ty_lo, ty_hi,
                                                 tx_lo, tx_hi,
                                                 ty_stride=ty_stride)
    sorted_tri, start, counts = _build_bins(
        tx0, ty0, span_x, spans, capacity, n_tiles_x, n_tiles_y)

    if shader.writes_color:
        from tinyrenderder_tpu.ops.raster_tiled import _flatten_varyings
        spec = tuple(shader.varying_spec.items())
        if set(n for n, _ in spec) != set(varyings):
            raise ValueError(f"{shader.name}.varying_spec "
                             f"{sorted(dict(spec))} != vertex output "
                             f"{sorted(varyings)}")
        vary_corners = _flatten_varyings(varyings, spec)
    else:
        vary_corners = None
    records = raster_pallas.build_records(setup, sorted_tri, vary_corners)

    # active-tile compaction: ids[j] = j-th non-empty tile (ascending),
    # padding entries = n_tiles sentinel (out-of-bounds -> scatter-dropped)
    active = counts > 0
    n_active = jnp.sum(active.astype(jnp.int32))
    pos = jnp.cumsum(active.astype(jnp.int32)) - 1
    slot = jnp.where(active, pos, a_cap)
    ids = jnp.full((a_cap,), n_tiles, jnp.int32).at[slot].set(
        jnp.arange(n_tiles, dtype=jnp.int32), mode="drop")
    kernel_ids = jnp.minimum(ids, n_tiles - 1)   # in-range for block maps
    start_a = start[:-1][kernel_ids]
    counts_a = jnp.where(ids < n_tiles, counts[kernel_ids], 0)
    return (setup, records, ids, kernel_ids, start_a, counts_a,
            total, n_active)


@functools.partial(jax.jit, static_argnames=("shader", "spec", "w_cap"))
def _post_sparse_jit(ft: FrameTiles, ids, kernel_ids, depth_c, winner_c,
                     vary_c, uniforms, winner_offset, shader, spec,
                     w_cap=None):
    """Fused post-kernel stage in COMPACT space: fragment-shade only the
    active tiles, merge, scatter back into the tiled frame.  Padding
    entries (ids == n_tiles) scatter out of bounds and are dropped.

    ``w_cap`` (static, <= a_cap) enables WON-TILE shading: the kernel's
    merge already resolved the depth test against the running frame, so
    a tile where this pass won zero pixels needs no fragment shading at
    all.  The shade runs on the w_cap tiles that won >= 1 pixel (late
    passes of multi-pass frames are heavily occluded: the 12-triangle
    full-screen room pass of the 3-mesh scene is active on every tile
    but wins on far fewer).  Capacity
    semantics match every other cap: first frame seeds w_cap = a_cap
    (never degrades), later frames use the measured quantized count;
    overflow (won tiles > w_cap) leaves the overflowed tiles' WON
    pixels unshaded (color 0) for that frame and raises the same-frame
    overflow flag.  Returns (FrameTiles, won_tile_total)."""
    winner_c = winner_c.astype(jnp.int32)
    won = winner_c >= 0
    a_cap = kernel_ids.shape[0]
    live = (ids < ft.depth.shape[0])
    new_depth = ft.depth.at[ids].set(depth_c, mode="drop")
    new_w_c = jnp.where(won, winner_c + winner_offset,
                        ft.winner[kernel_ids])
    new_winner = ft.winner.at[ids].set(new_w_c, mode="drop")
    if not shader.writes_color:
        # no shading -> no won-tile cap pressure.  -1 is the explicit
        # "no pressure" sentinel: a plain 0 is indistinguishable from a
        # measured zero and would let a depth-only pass consume the
        # once-only refinement of a key it shares with a color pass
        # (e.g. shadow map size == frame size), shrinking that key's
        # w_cap to the minimum and forcing the color pass to overflow.
        return (FrameTiles(color=ft.color, depth=new_depth,
                           winner=new_winner), jnp.asarray(-1, jnp.int32))
    wonk = jnp.any(won, axis=(1, 2)) & live          # (A,) pass won in tile
    won_total = jnp.sum(wonk.astype(jnp.int32))
    if w_cap is None or w_cap >= a_cap:
        vary_s, sel = vary_c, None
    else:
        # compact to won tiles (same machinery as the active compaction)
        pos = jnp.cumsum(wonk.astype(jnp.int32)) - 1
        slot = jnp.where(wonk, pos, w_cap)
        sel = jnp.full((w_cap,), a_cap, jnp.int32).at[slot].set(
            jnp.arange(a_cap, dtype=jnp.int32), mode="drop")
        vary_s = vary_c[jnp.minimum(sel, a_cap - 1)]
    vary = {}
    i = 0
    for name, c in spec:
        vary[name] = jnp.moveaxis(vary_s[:, i:i + c], 1, -1)  # (W, th, tw, c)
        i += c
    rgb = shader.fragment(uniforms, vary, jnp)
    out_s = _pack_rgb(finalize_color(rgb, jnp))
    if sel is None:
        out = out_s
    else:
        out = (jnp.zeros((a_cap,) + out_s.shape[1:], out_s.dtype)
               .at[sel].set(out_s, mode="drop"))
    new_c_c = jnp.where(won, out, ft.color[kernel_ids])
    new_color = ft.color.at[ids].set(new_c_c, mode="drop")
    return (FrameTiles(color=new_color, depth=new_depth,
                       winner=new_winner), won_total)


# capacity caches shared with raster_tiled's conventions: key ->
# (pair capacity, active-tile capacity, won-tile capacity); async totals
# resolve one frame later (async capacity pattern: stage the device
_SPARSE_CAPACITY: dict = {}
_SPARSE_PENDING: dict = {}

#: keys whose won-tile cap already refined down from its a_cap seed.
#: The shrink happens ONCE; afterwards the cap only grows on overflow —
#: re-shrinking every frame under a moving camera made each frame a new
#: static cap tuple, i.e. a full program recompile per frame.
_W_REFINED: set = set()


def _quantize_active(n_active: int, n_tiles: int) -> int:
    """Active-tile capacity: 12.5% headroom rounded UP to a sixteenth of
    the (pow2-rounded) tile count.  Pow2 rounding like the pair capacity
    would jump straight to n_tiles once coverage passes ~40% (e.g. 965
    active of 2048 -> 2048) and the compaction would never engage; an
    n_tiles/16 grain keeps at most 16 compiled grid variants per
    resolution.  Every a_cap unit is a kernel program plus a full
    phase-C tile shade (the per-pixel texture-gather floor), so the
    headroom is kept tight (965 active of 2048 -> a_cap 1152)."""
    grain = max(8, _next_pow2(n_tiles) // 16)
    want = n_active + n_active // 8
    return max(8, min(_cdiv(want, grain) * grain, n_tiles))


def _resolve_pending(key, n_tiles):
    """Async-mode bookkeeping: fold a previous frame's (pair, active)
    totals into the capacity cache once their D2H has landed.

    NEVER blocks: a not-ready future stays pending however old it is
    (forcing it would hide a host sync in the frame loop).  Staleness is
    bounded by the
    same-frame ``overflowed`` flag instead: every frame reports its own
    drops, so a late capacity fold only delays *growth*, never
    exactness detection.  New same-key totals keep folding into the
    pending slot (element-wise max) while it waits."""
    prev = _SPARSE_PENDING.get(key)
    if prev is None:
        return
    totals_dev, prev_caps, age = prev
    ready = getattr(totals_dev, "is_ready", lambda: True)()
    if ready:
        _SPARSE_PENDING.pop(key)
        t = [int(x) for x in np.asarray(totals_dev)[:3]]
        pt, pa = t[0], t[1]
        wt = t[2] if len(t) > 2 else -1
        # compare against the CURRENT caps, not the pending snapshot —
        # another path (fused strict, shadows) may have grown them in
        # between, and writing from the snapshot would revert that
        cur = _SPARSE_CAPACITY.get(key, prev_caps)
        cap, a_cap, *rest = cur
        w_cap = rest[0] if rest else a_cap
        if pt > cap or pa > a_cap or wt > w_cap:
            import logging
            logging.getLogger(__name__).warning(
                "sparse overflow (pairs %d/%d, tiles %d/%d, won %d/%d) "
                "detected %d frame(s) late; capacity grown",
                pt, cap, pa, a_cap, wt, w_cap, age + 1)
            _SPARSE_CAPACITY[key] = _grow_caps(
                (cap, a_cap, w_cap), (pt, pa, wt), n_tiles)
            if wt >= 0:       # the depth-only sentinel never consumes
                _W_REFINED.add(key)       # the one-time w refinement
        else:
            _won_refine_once(key, wt, n_tiles)
    else:
        _SPARSE_PENDING[key] = (totals_dev, prev_caps, age + 1)


def _resolve_caps(key, attrs, uniforms, shader, width, height,
                  tile_h, tile_w, n_tiles):
    caps = _SPARSE_CAPACITY.get(key)
    if caps is None:
        # first frame: one extra sync each for the pair count and the
        # active-tile count (both needed as static capacities)
        setup0, _ = _vertex_setup(attrs, uniforms, shader, width, height)
        *_, total0 = _tile_spans(setup0, tile_w, tile_h)
        capacity = _quantize_soft(int(jax.device_get(total0)))
        n_act0 = _count_active(setup0, capacity, width, height,
                               tile_h, tile_w)
        a0 = _quantize_active(int(jax.device_get(n_act0)), n_tiles)
        caps = (capacity, a0, a0)       # w_cap seeds = a_cap (never
    elif len(caps) == 2:                # degrades); refined from the
        caps = (*caps, caps[1])         # measured won-tile count later
    _SPARSE_CAPACITY[key] = caps
    return caps


def render_pass_tiles(ft: FrameTiles, attrs: dict, shader, uniforms: dict,
                      width: int, height: int, winner_offset: int = 0,
                      tile_h: int = TILE_H, tile_w: int = TILE_W,
                      strict_capacity: bool = True,
                      interpret: bool | None = None,
                      collect_stats: bool = False,
                      _caps: tuple | None = None):
    """Render one (mesh, shader) pass on a tiled-resident frame through
    the sparse pipeline.  Same output contract as
    raster_tiled.render_pass_tiled (after tiles_to_buffers), same
    capacity semantics: strict mode host-syncs and retries on pair-bin
    OR active-list overflow; async mode resolves the counts next frame.

    Returns (new FrameTiles, setup, overflowed) — ``overflowed`` is a
    DEVICE bool scalar (true iff this pass dropped pairs or tiles), so
    callers can fold it into frame outputs without a host sync.

    ``collect_stats=True`` additionally returns a 4th element: a device
    (fragments, min_z, max_z) triple with the reference's EXACT counter
    semantics — fragments counts z-pass *events* including overdraw in
    submission order (our_gl.cpp:194-200), z-range is over drawn events
    (not the final buffer).  The resolve's sequential merge yields them
    as two extra output planes; off on the bench path.
    """
    if interpret is None:
        interpret = device.interpret()
    uniforms = dict(uniforms)
    f = attrs["position"].shape[0]
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    if f == 0:
        empty = {"valid": jnp.zeros((0,), bool),
                 "screen": jnp.zeros((0, 3, 2), jnp.float32),
                 "ndc_z": jnp.zeros((0, 3), jnp.float32),
                 "clip_w": jnp.zeros((0, 3), jnp.float32),
                 "bbox": jnp.zeros((0, 4), jnp.int32)}
        if collect_stats:
            zero = jnp.float32(0)
            return (ft, empty, jnp.asarray(False),
                    (zero, jnp.float32(jnp.inf), jnp.float32(-jnp.inf)))
        return ft, empty, jnp.asarray(False)

    key = (f, n_tiles_x, n_tiles_y, tile_h, tile_w)

    if not strict_capacity:
        _resolve_pending(key, n_tiles)

    if _caps is not None:
        caps = _caps
        _SPARSE_CAPACITY[key] = caps
    else:
        caps = _resolve_caps(key, attrs, uniforms, shader, width, height,
                             tile_h, tile_w, n_tiles)
    if len(caps) == 2:
        caps = (*caps, caps[1])
    capacity, a_cap, w_cap = caps

    spec = (tuple(shader.varying_spec.items())
            if shader.writes_color else ())
    n_vary = sum(c for _, c in spec)
    (setup, records, ids, kernel_ids, start_a, counts_a, total,
     n_active) = _pre_sparse_jit(attrs, uniforms, shader, width, height,
                                 capacity, a_cap, tile_h, tile_w)
    depth_c, winner_c, vary_c, ev_c = raster_pallas.resolve_tiles(
        kernel_ids, start_a, counts_a, records, ft.depth, n_tiles_x,
        tile_h, tile_w, n_vary, interpret, collect_stats=collect_stats)
    new_ft, won_total = _post_sparse_jit(
        ft, ids, kernel_ids, depth_c, winner_c, vary_c, uniforms,
        jnp.int32(winner_offset), shader, spec, w_cap=w_cap)
    overflowed = ((total > capacity) | (n_active > a_cap)
                  | (won_total > w_cap))
    events = None
    if collect_stats:
        events = _reduce_events_jit(ev_c, depth_c, winner_c, ids, n_tiles)

    if strict_capacity:
        tot, act, wt = (int(x) for x in
                        jax.device_get((total, n_active, won_total)))
        if tot > capacity or act > a_cap or wt > w_cap:
            # grow from the CURRENT store (another same-key pass may
            # have grown it since this plan was snapshot)
            grown = _grow_caps(_SPARSE_CAPACITY.get(key, caps),
                               (tot, act, wt), n_tiles)
            _SPARSE_CAPACITY[key] = grown
            if wt >= 0:
                # only a real won-tile measurement consumes the one-time
                # w refinement; the depth-only sentinel (wt<0) must not
                _W_REFINED.add(key)
            return render_pass_tiles(ft, attrs, shader, uniforms,
                                     width, height, winner_offset,
                                     tile_h, tile_w, strict_capacity,
                                     interpret, collect_stats, _caps=grown)
        _won_refine_once(key, wt, n_tiles)
    else:
        _fold_or_stage_pending(_SPARSE_PENDING, key,
                               jnp.stack([total, n_active, won_total]),
                               caps)
    if collect_stats:
        return new_ft, setup, overflowed, events
    return new_ft, setup, overflowed


# ---- capacity bookkeeping (shared by the per-pass driver, the fused
# frame, the fused shadow program, and the sharded fused path).  A
# totals row is (pairs, active tiles, won tiles); caps are the matching
# static (pair, active-tile, won-tile) capacities. ---------------------------

def _caps_from_totals(t, n_tiles):
    """Quantize a totals row into a fresh capacity tuple."""
    t = [int(x) for x in t]
    return (_quantize_soft(t[0]), _quantize_active(t[1], n_tiles),
            _quantize_active(t[2], n_tiles))


def _caps_fit(caps, t):
    return all(int(x) <= c for x, c in zip(t[:3], caps))


def _won_refine_once(key, wt, n_tiles):
    """Shrink a key's won-tile cap from its a_cap seed to the measured
    count, EXACTLY ONCE (shared by the strict/async per-pass drivers,
    the fused frame, and the fused shadow program).  wt < 0 is the
    depth-only "no pressure" sentinel (see _post_sparse_jit) and never
    consumes the refinement; afterwards the cap only grows on overflow
    (per-frame shrinking = a program retrace per frame, see
    _W_REFINED)."""
    if wt is None or wt < 0 or key in _W_REFINED:
        return
    caps = _SPARSE_CAPACITY.get(key)
    if caps is not None and len(caps) >= 3:
        w_new = min(caps[-1], max(8, _quantize_active(wt, n_tiles)))
        if w_new < caps[-1]:
            _SPARSE_CAPACITY[key] = (*caps[:-1], w_new)
    _W_REFINED.add(key)


def _grow_caps(caps, t, n_tiles):
    return tuple(max(a, b) for a, b in
                 zip(caps, _caps_from_totals(t, n_tiles)))


@jax.jit
def _reduce_events_jit(ev_c, depth_c, winner_c, ids, n_tiles):
    """Per-pass exact counters from the kernel's event planes: fragment
    (z-pass event) total, min/max z over drawn events.  The min event at
    a pixel is its final pass depth (events strictly decrease), so
    min_z = min over won pixels of the resolved depth."""
    live = (ids < n_tiles)[:, None, None]
    # per-pixel event counts are small (f32-exact); the SUM can pass
    # 2^24 on heavy overdraw — accumulate in int32 (exact to 2^31)
    frags = jnp.sum(jnp.where(live, ev_c[:, 0], 0.0).astype(jnp.int32))
    max_z = jnp.max(jnp.where(live, ev_c[:, 1], -jnp.inf))
    won = live & (winner_c.astype(jnp.int32) >= 0)
    min_z = jnp.min(jnp.where(won, depth_c, jnp.inf))
    return frags, min_z, max_z


@functools.partial(jax.jit, static_argnames=("shader", "width", "height"))
def _vertex_setup(attrs, uniforms, shader, width: int, height: int):
    clip, _ = shader.vertex(uniforms, attrs, jnp)
    vp = jnp.asarray(math3d.viewport(0, 0, width, height),
                     dtype=attrs["position"].dtype)
    return semantics.triangle_setup_planes(clip, vp, width, height, jnp), None


@functools.partial(jax.jit, static_argnames=("capacity", "width", "height",
                                             "tile_h", "tile_w"))
def _count_active(setup, capacity, width, height, tile_h, tile_w):
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    tx0, ty0, span_x, spans, _ = _tile_spans(setup, tile_w, tile_h)
    _, _, counts = _build_bins(tx0, ty0, span_x, spans, capacity,
                               n_tiles_x, n_tiles_y)
    return jnp.sum((counts > 0).astype(jnp.int32))


# ---------------------------------------------------------------------------
# Fused frame: all passes in ONE jitted program
# ---------------------------------------------------------------------------

def _fused_frame_body(attrs_t, uniforms_t, plan, width, height,
                      tile_h, tile_w, interpret, ty_lo=None,
                      nty_band=None, origin=None, ty_stride=1,
                      tx_lo=None, ntx_band=None, geom_axis=None,
                      ty_rows=None):
    """Trace the whole multi-pass frame as one program (see
    _frame_fused_jit).  With ``ty_lo``/``nty_band``/``origin`` the frame
    is a horizontal band of the screen: binning is band-clipped, the
    FrameTiles cover only the band's tiles, and the kernels rasterize at
    global pixel coordinates via ``origin`` — this is the body the
    sharded production path (parallel/dist.py) runs per device inside
    shard_map, making the fast path and the scaled path the same path.
    ``tx_lo``/``ntx_band`` additionally clip columns: the frame is then
    a 2-D screen block (('ty','tx') meshes)."""
    n_tiles_x = ntx_band if ntx_band is not None else _cdiv(width, tile_w)
    n_tiles_y = nty_band if nty_band is not None else _cdiv(height, tile_h)
    n = n_tiles_x * n_tiles_y
    ft = FrameTiles(
        color=jnp.zeros((n, tile_h, tile_w), jnp.int32),
        depth=jnp.full((n, tile_h, tile_w), jnp.inf, jnp.float32),
        winner=jnp.full((n, tile_h, tile_w), BACKGROUND, jnp.int32),
    )
    snapshot = None
    in_excluded = False
    overflow = jnp.asarray(False)
    totals = []
    y_stride = None if ty_stride == 1 else tile_h * ty_stride
    for (shader, caps, exclude, offset), attrs, uniforms in zip(
            plan, attrs_t, uniforms_t):
        if exclude:
            if not in_excluded:
                snapshot = ft.depth                  # main.cpp:700
                in_excluded = True
        elif in_excluded:
            ft = FrameTiles(color=ft.color, depth=snapshot,
                            winner=ft.winner)        # main.cpp:730
            in_excluded = False
        spec = (tuple(shader.varying_spec.items())
                if shader.writes_color else ())
        n_vary = sum(c for _, c in spec)
        cap, ac, wc = caps
        (setup, records, ids, kernel_ids, sa, ca, total, na
         ) = _pre_sparse_jit(attrs, uniforms, shader, width, height,
                             cap, ac, tile_h, tile_w,
                             ty_lo=ty_lo, nty_band=nty_band,
                             ty_stride=ty_stride,
                             tx_lo=tx_lo, ntx_band=ntx_band,
                             geom_axis=geom_axis, ty_rows=ty_rows)
        d_c, w_c, v_c, _ = raster_pallas.resolve_tiles(
            kernel_ids, sa, ca, records, ft.depth, n_tiles_x, tile_h,
            tile_w, n_vary, interpret, origin=origin, y_stride=y_stride)
        ft, wt = _post_sparse_jit(ft, ids, kernel_ids, d_c, w_c, v_c,
                                  uniforms, jnp.int32(offset), shader,
                                  spec, w_cap=wc)
        ovf = (total > cap) | (na > ac) | (wt > wc)
        totals.append(jnp.stack([total, na, wt]))
        overflow = overflow | ovf
    out_depth = snapshot if in_excluded else ft.depth
    return ft, out_depth, overflow, jnp.stack(totals)


@functools.partial(jax.jit, static_argnames=(
    "plan", "width", "height", "tile_h", "tile_w", "interpret"))
def _frame_fused_jit(attrs_t, uniforms_t, plan, width, height,
                     tile_h, tile_w, interpret):
    """One XLA program for the whole multi-pass frame.

    ``plan``: static tuple of (shader, caps, exclude, offset) per pass.
    Folding every pre/kernel/post stage of every pass into a single
    program removes the host dispatch cost per stage and lets XLA
    schedule across pass boundaries.  The z-snapshot /
    restore around exclude_from_output_depth passes (main.cpp:700,730)
    is static control flow here."""
    return _fused_frame_body(attrs_t, uniforms_t, plan, width, height,
                             tile_h, tile_w, interpret)


class _StagedTotals:
    """Zero-dispatch staging view of per-pass rows of a device totals
    array.

    Async-mode staging used to slice each pass's row out of the fused
    program's stacked totals eagerly (``totals[i, :w]``) — two XLA host
    dispatches per pass per frame of pure overhead.  Staging the WHOLE array plus
    row indices defers the slice (and the same-frame same-key
    element-wise max merge) to resolve time as a host numpy op.
    Duck-typed like a jax.Array for the resolvers' existing protocol:
    ``is_ready`` / ``copy_to_host_async`` / ``__array__``.
    """

    __slots__ = ("arr", "axis", "rows", "extras")

    def __init__(self, arr, row: int, axis: int = 0):
        self.arr = arr
        self.axis = axis
        self.rows = [row]
        self.extras: list = []

    def merge_row(self, row: int) -> None:
        """Fold another same-key pass of the SAME frame (same ``arr``)
        into this entry; the element-wise max happens at resolve."""
        self.rows.append(row)

    def merge_array(self, vec) -> None:
        """Fold a LATER frame's device totals vector into this
        unresolved entry (the per-pass async drivers' same-key fold).
        Widths may differ; the shared prefix folds, the rest is kept
        from the base."""
        f = getattr(vec, "copy_to_host_async", None)
        if f is not None:
            f()
        self.extras.append(vec)

    def is_ready(self) -> bool:
        for a in (self.arr, *self.extras):
            f = getattr(a, "is_ready", None)
            if f is not None and not f():
                return False
        return True

    def copy_to_host_async(self) -> None:
        for a in (self.arr, *self.extras):
            f = getattr(a, "copy_to_host_async", None)
            if f is not None:
                f()

    def __array__(self, dtype=None, copy=None):
        h = np.take(np.asarray(self.arr), self.rows, axis=self.axis)
        h = h.max(axis=self.axis)
        for e in self.extras:
            ev = np.asarray(e)
            w = min(h.shape[-1], ev.shape[-1])
            h[..., :w] = np.maximum(h[..., :w], ev[..., :w])
        return h if dtype is None else h.astype(dtype)


def _stage_pending(pending: dict, key, view, caps) -> None:
    """Stage a totals view for next-frame resolution unless the key
    already has an unresolved entry (shared by the fused, sharded-fused
    and fused-shadow drivers so their staging cannot drift)."""
    if key not in pending:
        view.copy_to_host_async()
        pending[key] = (view, caps, 0)


def _fold_or_stage_pending(pending: dict, key, totals_dev, caps) -> None:
    """Per-pass async staging: fold ``totals_dev`` (a device totals
    vector) into an existing unresolved pending slot — element-wise
    max: a second same-key pass's overflow was invisible while the slot
    only ever held the first pass's totals — else stage it fresh.  The
    existing slot may hold a plain device vector (staged by a per-pass
    driver) or a _StagedTotals view (staged by a fused driver); both
    fold WITHOUT materializing, so this never blocks on a D2H."""
    prev = pending.get(key)
    if prev is None:
        try:
            totals_dev.copy_to_host_async()
        except AttributeError:
            pass
        pending[key] = (totals_dev, caps, 0)
    elif isinstance(prev[0], _StagedTotals):
        prev[0].merge_array(totals_dev)
    else:
        pending[key] = (jnp.maximum(prev[0], totals_dev),
                        prev[1], prev[2])


def render_frame_fused(passes, width: int, height: int,
                       tile_h: int = TILE_H, tile_w: int = TILE_W,
                       strict_capacity: bool = True,
                       interpret: bool | None = None):
    """Render a whole multi-pass frame in one fused dispatch.

    ``passes``: list of (attrs, shader, uniforms, exclude_from_output_
    depth); every pass must have > 0 faces.  Returns (FrameTiles,
    out_depth_tiles, overflow-device-bool).  Capacity semantics match
    the per-pass drivers: strict mode fetches all totals once (one
    host sync per frame instead of one per pass) and re-renders on
    growth; async mode folds totals in on a later frame."""
    if interpret is None:
        interpret = device.interpret()
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y

    plan = []
    keys = []
    attrs_t = []
    unis_t = []
    offset = 0
    for attrs, shader, uniforms, exclude in passes:
        f = attrs["position"].shape[0]
        if f == 0:
            raise ValueError("render_frame_fused requires non-empty passes")
        uniforms = dict(uniforms)
        key = (f, n_tiles_x, n_tiles_y, tile_h, tile_w)
        if not strict_capacity:
            _resolve_pending(key, n_tiles)
        caps = _resolve_caps(key, attrs, uniforms, shader, width, height,
                             tile_h, tile_w, n_tiles)
        plan.append((shader, caps, bool(exclude), offset))
        keys.append(key)
        attrs_t.append(attrs)
        unis_t.append(uniforms)
        offset += f

    ft, out_depth, overflow, totals = _frame_fused_jit(
        tuple(attrs_t), tuple(unis_t), tuple(plan), width, height,
        tile_h, tile_w, interpret)

    if strict_capacity:
        if _book_strict(keys, plan, totals, n_tiles):
            return render_frame_fused(passes, width, height, tile_h,
                                      tile_w, strict_capacity, interpret)
    else:
        _book_async(keys, plan, totals)
    return ft, out_depth, overflow


def _book_strict(keys, plan, totals, n_tiles) -> bool:
    """Strict-mode capacity bookkeeping shared by the fused drivers:
    fetch the frame's totals once, grow any overflowed caps, consume the
    one-time won-tile refinements.  Returns True iff anything grew (the
    caller re-renders)."""
    tot_host = np.asarray(jax.device_get(totals))
    grown = False
    for key, (shader, caps, *_), t in zip(keys, plan, tot_host):
        if not _caps_fit(caps, t):
            # grow from the CURRENT store, not the plan snapshot:
            # an earlier same-key pass may have grown it this frame
            # already and the snapshot write would revert it
            _SPARSE_CAPACITY[key] = _grow_caps(
                _SPARSE_CAPACITY.get(key, caps), t, n_tiles)
            if int(t[2]) >= 0:
                # a real won-tile measurement is folded in by the
                # growth; the depth-only sentinel (wt<0) must not
                # consume the one-time w refinement
                _W_REFINED.add(key)
            grown = True
        else:
            _won_refine_once(key, int(t[2]), n_tiles)
    return grown


def _book_async(keys, plan, totals) -> None:
    """Async-mode staging shared by the fused drivers.  Merges same-key
    passes within this frame before staging: a pending slot that held
    only the FIRST pass's totals made a later same-key pass's overflow
    invisible to the resolve."""
    staged: dict = {}
    for i, (key, (shader, caps, *_)) in enumerate(zip(keys, plan)):
        prev = staged.get(key)
        if prev is None:
            staged[key] = (caps, _StagedTotals(totals, i))
        else:
            prev[1].merge_row(i)
    for key, (caps, st) in staged.items():
        _stage_pending(_SPARSE_PENDING, key, st, caps)


# ---------------------------------------------------------------------------
# Single-pass direct-to-image fast path
# ---------------------------------------------------------------------------

def _shade_compact_fresh(winner_c, vary_c, ids, n_tiles, uniforms, shader,
                         spec):
    """Fragment-shade the compact active tiles of a single pass on a
    FRESH frame: the kernel's winner >= 0 already IS the merge outcome
    (nothing to lose against), so the three frame-tile gathers
    (ft.color/depth/winner[kernel_ids]) and the depth/winner merges of
    the general post stage vanish.  Returns (packed colors with losers
    forced to background 0, live won-tile count)."""
    won = winner_c.astype(jnp.int32) >= 0
    vary = {}
    i = 0
    for name, c in spec:
        vary[name] = jnp.moveaxis(vary_c[:, i:i + c], 1, -1)
        i += c
    rgb = shader.fragment(uniforms, vary, jnp)
    out = _pack_rgb(finalize_color(rgb, jnp))
    live = (ids < n_tiles)[:, None, None]
    c_img = jnp.where(won & live, out, 0)
    wonk = jnp.any(won, axis=(1, 2)) & (ids < n_tiles)
    return c_img, jnp.sum(wonk.astype(jnp.int32))


def _compact_to_image(c_img, ids, n_tiles, n_tiles_x, n_tiles_y,
                      tile_h, tile_w, direct):
    """Place compact packed-color tiles into a padded (nty*th, ntx*tw)
    screen-layout image (background 0).

    ``direct=True``: one windowed lax.scatter straight into image layout
    (padding entries, ids == n_tiles, land in an extra trash tile row
    that the caller crops — n_tiles // ntx == nty exactly).
    ``direct=False``: the general path's tile scatter + untile."""
    if direct:
        idx = jnp.stack([(ids // n_tiles_x) * tile_h,
                         (ids % n_tiles_x) * tile_w], axis=-1)
        img = jnp.zeros(((n_tiles_y + 1) * tile_h, n_tiles_x * tile_w),
                        jnp.int32)
        dn = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1, 2), inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0, 1))
        # indices_are_sorted: ``ids`` comes from the active-tile
        # compaction in _pre_sparse_jit, which emits ASCENDING tile ids
        # with every padding slot equal to n_tiles (so padding rows land
        # past the real rows, in the trash tile row the caller crops).
        # A sorted-order promise on an unsorted stream may lower to a
        # silently wrong scatter — if the compaction's output order ever
        # changes, this flag must be revisited with it.
        return jax.lax.scatter(img, idx, c_img, dn,
                               indices_are_sorted=True,
                               unique_indices=False)
    tiles = jnp.zeros((n_tiles, tile_h, tile_w), jnp.int32
                      ).at[ids].set(c_img, mode="drop")
    return _from_tiles_nd(tiles, n_tiles_y, n_tiles_x, tile_h, tile_w,
                          n_tiles_y * tile_h, n_tiles_x * tile_w)


def _fused_image_body(attrs_t, uniforms_t, plan, width, height,
                      tile_h, tile_w, interpret, direct, ty_lo=None,
                      nty_band=None, origin=None, ty_stride=1,
                      geom_axis=None, ty_rows=None):
    """Trace a single-color-pass frame straight to a packed (rows*th,
    ntx*tw) int32 image: pre + kernel as in _fused_frame_body, then the
    fresh-frame compact shade and ONE placement — no depth/winner tile
    materialization, no 3-plane untile.  With ``ty_lo``/``nty_band``/
    ``origin``/``ty_stride`` the frame is a horizontal band of the
    screen (the sharded production path runs this body per device
    inside shard_map, exactly like _fused_frame_body)."""
    (shader, caps, _exclude, _offset) = plan[0]
    attrs, uniforms = attrs_t[0], uniforms_t[0]
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = nty_band if nty_band is not None else _cdiv(height, tile_h)
    n = n_tiles_x * n_tiles_y
    spec = tuple(shader.varying_spec.items())
    n_vary = sum(c for _, c in spec)
    neg1 = jnp.asarray(-1, jnp.int32)
    y_stride = None if ty_stride == 1 else tile_h * ty_stride
    init_depth = jnp.full((n, tile_h, tile_w), jnp.inf, jnp.float32)
    cap, ac, _wc = caps
    (setup, records, ids, kernel_ids, sa, ca, total, na
     ) = _pre_sparse_jit(attrs, uniforms, shader, width, height,
                         cap, ac, tile_h, tile_w,
                         ty_lo=ty_lo, nty_band=nty_band,
                         ty_stride=ty_stride, geom_axis=geom_axis,
                         ty_rows=ty_rows)
    _, w_c, v_c, _ = raster_pallas.resolve_tiles(
        kernel_ids, sa, ca, records, init_depth, n_tiles_x, tile_h,
        tile_w, n_vary, interpret, origin=origin, y_stride=y_stride)
    c_img, _wt = _shade_compact_fresh(w_c, v_c, ids, n, uniforms,
                                      shader, spec)
    ovf = (total > cap) | (na > ac)
    # won-tile pressure is always the -1 sentinel here: the image path
    # shades every active tile, so it must never consume or overflow a
    # shared key's won-tile refinement
    totals = jnp.stack([total, na, neg1])
    img = _compact_to_image(c_img, ids, n, n_tiles_x, n_tiles_y,
                            tile_h, tile_w, direct)
    return img[:n_tiles_y * tile_h], ovf, totals


@functools.partial(jax.jit, static_argnames=(
    "plan", "width", "height", "tile_h", "tile_w", "interpret", "direct"))
def _frame_fused_image_jit(attrs_t, uniforms_t, plan, width, height,
                           tile_h, tile_w, interpret, direct):
    """One XLA program for a single-color-pass frame whose only
    deliverable is the (H, W, 3) image (see _fused_image_body)."""
    img, ovf, totals = _fused_image_body(attrs_t, uniforms_t, plan,
                                         width, height, tile_h, tile_w,
                                         interpret, direct)
    return _unpack_rgb(img[:height, :width]), ovf, totals[None]


def render_frame_fused_image(passes, width: int, height: int,
                             tile_h: int = TILE_H, tile_w: int = TILE_W,
                             strict_capacity: bool = True,
                             interpret: bool | None = None,
                             direct: bool = False):
    """Render a SINGLE color pass directly to an (H, W, 3) uint8 image.

    The production fast path for frames whose deliverable is the image
    alone (the reference's per-frame framebuffer write, main.cpp:786 —
    the z-buffer is an internal there too): identical pre/kernel stages
    to render_frame_fused, but the post stage never materializes the
    depth/winner tile planes and the single placement replaces the
    tile scatter + 3-plane untile.  Bitwise-identical colors to
    tiles_to_buffers(render_frame_fused(...)).color (tested).
    Returns (image, overflow-device-bool); capacity semantics match
    render_frame_fused exactly (shared caches and keys)."""
    if len(passes) != 1:
        raise ValueError("render_frame_fused_image takes exactly one pass")
    attrs, shader, uniforms, _exclude = passes[0]
    if not shader.writes_color:
        raise ValueError("render_frame_fused_image needs a color shader")
    if attrs["position"].shape[0] == 0:
        raise ValueError("render_frame_fused_image requires a non-empty pass")
    if interpret is None:
        interpret = device.interpret()
    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    uniforms = dict(uniforms)
    f = attrs["position"].shape[0]
    key = (f, n_tiles_x, n_tiles_y, tile_h, tile_w)
    if not strict_capacity:
        _resolve_pending(key, n_tiles)
    caps = _resolve_caps(key, attrs, uniforms, shader, width, height,
                         tile_h, tile_w, n_tiles)
    plan = ((shader, caps, False, 0),)
    keys = [key]
    image, overflow, totals = _frame_fused_image_jit(
        (attrs,), (uniforms,), plan, width, height, tile_h, tile_w,
        interpret, direct)
    if strict_capacity:
        if _book_strict(keys, plan, totals, n_tiles):
            return render_frame_fused_image(passes, width, height,
                                            tile_h, tile_w,
                                            strict_capacity, interpret,
                                            direct)
    else:
        _book_async(keys, plan, totals)
    return image, overflow


def render_frame_tiles(passes, width: int, height: int,
                       strict_capacity: bool = True,
                       tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Multi-pass frame fully resident in tiled layout (main.cpp:647-736
    flow incl. the z-snapshot/restore around exclude_from_output_depth
    passes, main.cpp:700,730).  ``passes``: iterable of (attrs, shader,
    uniforms, exclude_from_output_depth).

    Returns (FrameTiles, output_depth_tiles, overflowed-device-bool,
    setups list).  The single (H, W) untile is the caller's transfer
    boundary (tiles_to_buffers)."""
    ft = new_frame_tiles(width, height, tile_h, tile_w)
    snapshot = None
    in_excluded = False
    offset = 0
    overflow = jnp.asarray(False)
    setups = []
    for attrs, shader, uniforms, exclude in passes:
        if exclude:
            if not in_excluded:
                snapshot = ft.depth          # immutable: free snapshot
                in_excluded = True
        elif in_excluded:
            ft = FrameTiles(color=ft.color, depth=snapshot,
                            winner=ft.winner)
            in_excluded = False
        ft, setup, ovf = render_pass_tiles(
            ft, attrs, shader, uniforms, width, height,
            winner_offset=offset, tile_h=tile_h, tile_w=tile_w,
            strict_capacity=strict_capacity)
        overflow = overflow | ovf
        setups.append(setup)
        offset += attrs["position"].shape[0]
    out_depth = snapshot if in_excluded else ft.depth
    return ft, out_depth, overflow, setups
