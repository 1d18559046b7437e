"""Two-phase device rasterizer (pure-XLA reference path).

The reference's serial hot loop (our_gl.cpp:147-200) interleaves z-test,
shading and write per pixel.  Because its shaders never discard
(main.cpp:169, :260) and the z-test precedes shading (our_gl.cpp:165),
depth resolution is separable from shading with *identical* output:

  Phase A (depth resolve): for every triangle and covered pixel, find the
    minimum affine-interpolated NDC z per pixel, breaking ties by lowest
    triangle (= submission) index — exactly what serial strict-less testing
    produces.  Implemented as a ``lax.scan`` over triangle chunks: within a
    chunk a first-occurrence argmin, across chunks a strict-less select.

  Phase B (shade winners): gather the winning triangle's vertices per
    pixel, recompute barycentrics at the pixel center, interpolate varyings
    with perspective-correct weights, evaluate the shader once per pixel
    (dense, VPU-friendly), and write color where a winner exists.

All discontinuous decisions go through ops.semantics, so output is
bit-comparable with the float32 CPU oracle.

This module is the always-available XLA path (used for tests on CPU meshes
and as the fallback); ops.raster_tiled adds binning, and ops.raster_pallas
the Pallas resolve kernel, with the same semantics.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import semantics
from tinyrenderder_tpu.shaders import finalize_color

__all__ = ["FrameBuffers", "new_framebuffers", "render_pass_xla",
           "depth_resolve_xla", "shade_winners", "pass_stats"]

BACKGROUND = -1  # winner id for empty pixels


@jax.tree_util.register_dataclass
@dataclass
class FrameBuffers:
    """Immutable render-target state (the reference's framebuffer +
    global zbuffer, our_gl.cpp:12-15, as an explicit value — enabling the
    snapshot/restore the reference does by copying (main.cpp:700,730))."""

    color: jax.Array      # (H, W, 3) uint8
    depth: jax.Array      # (H, W) float32, +inf where empty
    winner: jax.Array     # (H, W) int32 triangle id of current depth owner

    @property
    def width(self) -> int:
        return self.color.shape[1]

    @property
    def height(self) -> int:
        return self.color.shape[0]


def new_framebuffers(width: int, height: int, dtype=jnp.float32) -> FrameBuffers:
    """init_zbuffer semantics: depth cleared to +inf (our_gl.cpp:72-74)."""
    return FrameBuffers(
        color=jnp.zeros((height, width, 3), dtype=jnp.uint8),
        depth=jnp.full((height, width), jnp.inf, dtype=dtype),
        winner=jnp.full((height, width), BACKGROUND, dtype=jnp.int32),
    )


def _pad_to_multiple(arr, multiple, axis=0, fill=0):
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return jnp.pad(arr, pad, constant_values=fill)


def depth_resolve_xla(setup: dict, height: int, width: int, chunk: int = 8,
                      init_depth=None, init_winner=None, x0=0, y0=0):
    """Phase A over the full image, scanning triangle chunks.

    setup: dict from semantics.triangle_setup_planes over (F, 3, 4) clip.
    x0/y0: global pixel coordinates of this buffer's top-left corner
    (used by the sharded path, where each device owns a row band but the
    viewport/bbox stay in global coordinates).  May be traced scalars.
    Returns (depth (H, W), winner (H, W) int32).
    

    LOCKSTEP WARNING: pass_events_xla duplicates this step's
    coverage/merge sequence (it must stay bitwise-identical; see
    its docstring).  Edit both or neither.
    """
    f = setup["valid"].shape[0]
    dtype = setup["screen"].dtype
    if init_depth is None:
        init_depth = jnp.full((height, width), jnp.inf, dtype=dtype)
    if init_winner is None:
        init_winner = jnp.full((height, width), BACKGROUND, dtype=jnp.int32)
    if f == 0:
        return init_depth, init_winner

    ids = jnp.arange(f, dtype=jnp.int32)
    valid = setup["valid"]
    screen = setup["screen"].astype(dtype)
    ndc_z = setup["ndc_z"].astype(dtype)
    bbox = setup["bbox"]

    nchunk = -(-f // chunk)
    ids_c = _pad_to_multiple(ids, chunk).reshape(nchunk, chunk)
    valid_c = _pad_to_multiple(valid, chunk).reshape(nchunk, chunk)
    screen_c = _pad_to_multiple(screen, chunk).reshape(nchunk, chunk, 3, 2)
    z_c = _pad_to_multiple(ndc_z, chunk).reshape(nchunk, chunk, 3)
    bbox_c = _pad_to_multiple(bbox, chunk).reshape(nchunk, chunk, 4)

    xi = (jnp.asarray(x0, jnp.int32)
          + jnp.arange(width, dtype=jnp.int32))[None, None, :]   # (1, 1, W)
    yi = (jnp.asarray(y0, jnp.int32)
          + jnp.arange(height, dtype=jnp.int32))[None, :, None]  # (1, H, 1)
    half = jnp.asarray(0.5, dtype=dtype)
    px = xi.astype(dtype) + half
    py = yi.astype(dtype) + half

    def step(carry, data):
        zbuf, idbuf = carry
        c_ids, c_valid, c_screen, c_z, c_bbox = data

        def tcoord(k, a):  # (K,) per-triangle scalar -> (K, 1, 1)
            return c_screen[:, k, a][:, None, None]

        b0, b1, b2, _ = semantics.barycentric(
            tcoord(0, 0), tcoord(0, 1), tcoord(1, 0), tcoord(1, 1),
            tcoord(2, 0), tcoord(2, 1), px, py, jnp)
        covered = semantics.coverage_mask(b0, b1, b2)
        z = semantics.affine_z(c_z[:, 0, None, None], c_z[:, 1, None, None],
                               c_z[:, 2, None, None], b0, b1, b2)
        covered &= jnp.isfinite(z)
        # only pixels inside the clamped integer bbox are visited
        # (our_gl.cpp:147-148)
        covered &= ((xi >= c_bbox[:, 0, None, None])
                    & (xi <= c_bbox[:, 1, None, None])
                    & (yi >= c_bbox[:, 2, None, None])
                    & (yi <= c_bbox[:, 3, None, None]))
        covered &= c_valid[:, None, None]

        zc = jnp.where(covered, z, jnp.inf)
        best = jnp.argmin(zc, axis=0)                       # first min = lowest id
        zmin = jnp.take_along_axis(zc, best[None], axis=0)[0]
        win_id = c_ids[best]
        better = zmin < zbuf                                # strict: first drawn wins
        zbuf = jnp.where(better, zmin, zbuf)
        idbuf = jnp.where(better, win_id, idbuf)
        return (zbuf, idbuf), None

    (depth, winner), _ = jax.lax.scan(
        step, (init_depth, init_winner),
        (ids_c, valid_c, screen_c, z_c, bbox_c))
    return depth, winner


@functools.partial(jax.jit, static_argnames=("height", "width", "chunk"))
def pass_events_xla(setup: dict, init_depth, height: int, width: int,
                    chunk: int = 8):
    """EXACT per-pass event counters for the scan path, matching the
    reference's our_gl.cpp:194-200 semantics and the Pallas kernels'
    event planes (raster_pallas._tile_kernel ev_ref): ``frags`` counts
    z-pass EVENTS in submission order (overdraw included — a pixel drawn
    then overdrawn counts twice), ``max_z`` is the max z over events,
    ``min_z`` the min over pixels this pass finally won (events at a
    pixel strictly decrease, so the min event = resolved depth).

    Runs as a SEPARATE scan from depth_resolve_xla for the same reason
    the kernels use a separate stats launch: fusing the event prefix-min
    into the frame's resolve could perturb XLA's FMA grouping of
    affine_z by 1 ulp (e35d513).  Returns (depth, winner, frags, min_z,
    max_z); depth/winner equal depth_resolve_xla's on every backend
    tested, but callers should keep using the frame path's outputs for
    the frame.
    

    LOCKSTEP WARNING: the per-chunk coverage/merge sequence below
    (padding, tcoord, barycentric, affine_z, finiteness, bbox,
    argmin merge) must stay op-for-op identical to
    depth_resolve_xla's step — the exact-stats contract asserts
    their depth/winner agree bitwise on every backend.  Edit both
    or neither.
    """
    f = setup["valid"].shape[0]
    dtype = setup["screen"].dtype
    if f == 0:
        return (init_depth,
                jnp.full((height, width), BACKGROUND, jnp.int32),
                jnp.float32(0), jnp.float32(jnp.inf),
                jnp.float32(-jnp.inf))

    ids = jnp.arange(f, dtype=jnp.int32)
    nchunk = -(-f // chunk)
    ids_c = _pad_to_multiple(ids, chunk).reshape(nchunk, chunk)
    valid_c = _pad_to_multiple(setup["valid"], chunk).reshape(nchunk, chunk)
    screen_c = _pad_to_multiple(setup["screen"].astype(dtype),
                                chunk).reshape(nchunk, chunk, 3, 2)
    z_c = _pad_to_multiple(setup["ndc_z"].astype(dtype),
                           chunk).reshape(nchunk, chunk, 3)
    bbox_c = _pad_to_multiple(setup["bbox"], chunk).reshape(nchunk, chunk, 4)

    xi = jnp.arange(width, dtype=jnp.int32)[None, None, :]
    yi = jnp.arange(height, dtype=jnp.int32)[None, :, None]
    half = jnp.asarray(0.5, dtype=dtype)
    px = xi.astype(dtype) + half
    py = yi.astype(dtype) + half

    def step(carry, data):
        zbuf, idbuf, frags, max_z = carry
        c_ids, c_valid, c_screen, c_z, c_bbox = data

        def tcoord(k, a):
            return c_screen[:, k, a][:, None, None]

        b0, b1, b2, _ = semantics.barycentric(
            tcoord(0, 0), tcoord(0, 1), tcoord(1, 0), tcoord(1, 1),
            tcoord(2, 0), tcoord(2, 1), px, py, jnp)
        covered = semantics.coverage_mask(b0, b1, b2)
        z = semantics.affine_z(c_z[:, 0, None, None], c_z[:, 1, None, None],
                               c_z[:, 2, None, None], b0, b1, b2)
        covered &= jnp.isfinite(z)
        covered &= ((xi >= c_bbox[:, 0, None, None])
                    & (xi <= c_bbox[:, 1, None, None])
                    & (yi >= c_bbox[:, 2, None, None])
                    & (yi <= c_bbox[:, 3, None, None]))
        covered &= c_valid[:, None, None]
        zc = jnp.where(covered, z, jnp.inf)

        # exact sequential z-test events within the chunk: event k fires
        # iff zc[k] < min(carry depth, zc[0..k-1])
        incl = jax.lax.cummin(zc, axis=0)
        excl = jnp.concatenate(
            [jnp.full((1, height, width), jnp.inf, zc.dtype), incl[:-1]],
            axis=0)
        thresh = jnp.minimum(excl, zbuf[None])
        events = zc < thresh
        # int32 accumulation: the counter is documented EXACT and f32
        # loses integer exactness past 2^24 events (a heavy-overdraw
        # 2048-square pass exceeds that); int32 is exact to 2^31
        frags = frags + jnp.sum(events.astype(jnp.int32))
        max_z = jnp.maximum(
            max_z, jnp.max(jnp.where(events, zc, -jnp.inf)))

        best = jnp.argmin(zc, axis=0)
        zmin = jnp.take_along_axis(zc, best[None], axis=0)[0]
        win_id = c_ids[best]
        better = zmin < zbuf
        zbuf = jnp.where(better, zmin, zbuf)
        idbuf = jnp.where(better, win_id, idbuf)
        return (zbuf, idbuf, frags, max_z), None

    init_winner = jnp.full((height, width), BACKGROUND, jnp.int32)
    (depth, winner, frags, max_z), _ = jax.lax.scan(
        step, (init_depth.astype(dtype), init_winner,
               jnp.int32(0), jnp.float32(-jnp.inf)),
        (ids_c, valid_c, screen_c, z_c, bbox_c))
    min_z = jnp.min(jnp.where(winner >= 0, depth, jnp.inf))
    return depth, winner, frags, min_z, max_z


def shade_winners(fb_color, winner_local, setup, varyings,
                  shader, uniforms, height: int, width: int, x0=0, y0=0):
    """Phase B: evaluate the fragment shader once per winning pixel.

    winner_local: (H, W) int32 — this pass's triangle index per pixel,
    BACKGROUND where this pass did not win the depth test.
    x0/y0: global pixel offset of this buffer (sharded row bands).
    """
    f = setup["valid"].shape[0]
    if f == 0:
        return fb_color
    dtype = setup["screen"].dtype

    mine = winner_local >= 0
    widx = jnp.clip(winner_local, 0, f - 1)

    scr = setup["screen"][widx]          # (H, W, 3, 2)
    zs = setup["ndc_z"][widx]            # (H, W, 3)
    ws = setup["clip_w"][widx]           # (H, W, 3)

    half = jnp.asarray(0.5, dtype=dtype)
    px = (jnp.asarray(x0, dtype)
          + jnp.arange(width, dtype=dtype))[None, :] + half
    py = (jnp.asarray(y0, dtype)
          + jnp.arange(height, dtype=dtype))[:, None] + half
    px = jnp.broadcast_to(px, (height, width))
    py = jnp.broadcast_to(py, (height, width))

    b0, b1, b2, _ = semantics.barycentric(
        scr[..., 0, 0], scr[..., 0, 1], scr[..., 1, 0], scr[..., 1, 1],
        scr[..., 2, 0], scr[..., 2, 1], px, py, jnp)
    pb0, pb1, pb2 = semantics.perspective_correct_bary(
        b0, b1, b2, ws[..., 0], ws[..., 1], ws[..., 2], jnp)

    vary_pix = {}
    for name, v in varyings.items():
        vw = v[widx]                     # (H, W, 3, C)
        vary_pix[name] = semantics.interp3(
            vw[..., 0, :], vw[..., 1, :], vw[..., 2, :],
            pb0[..., None], pb1[..., None], pb2[..., None])

    rgb = shader.fragment(uniforms, vary_pix, jnp)
    out = finalize_color(rgb, jnp)
    return jnp.where(mine[..., None], out, fb_color)


@functools.partial(jax.jit, static_argnames=("shader", "width", "height", "chunk"))
def _render_pass_xla_jit(fb: FrameBuffers, attrs, uniforms, winner_offset,
                         shader, width: int, height: int, chunk: int):
    xp = jnp
    dtype = attrs["position"].dtype
    clip, varyings = shader.vertex(uniforms, attrs, xp)
    vp = jnp.asarray(math3d.viewport(0, 0, width, height), dtype=dtype)
    setup = semantics.triangle_setup_planes(clip, vp, width, height, xp)

    # fresh local winner buffer seeded with the existing depth: a triangle
    # of this pass only wins a pixel by beating *both* earlier passes'
    # depths and its same-pass competitors — exactly the serial semantics
    depth, winner_local = depth_resolve_xla(
        setup, height, width, chunk=chunk, init_depth=fb.depth)

    won = winner_local >= 0
    new_winner = jnp.where(won, winner_local + winner_offset, fb.winner)
    if shader.writes_color:
        color = shade_winners(fb.color, winner_local, setup, varyings,
                              shader, uniforms, height, width)
    else:
        color = fb.color                 # depth-only pass
    return FrameBuffers(color=color, depth=depth, winner=new_winner), setup


def render_pass_xla(fb: FrameBuffers, attrs: dict, shader, uniforms: dict,
                    winner_offset: int = 0, chunk: int = 8):
    """Render one (mesh, shader) pass on device via the scan path.

    attrs: {name: (F, 3, C) float32} from Mesh.face_attributes.
    Returns (new FrameBuffers, setup dict for stats).
    """
    height, width = fb.color.shape[:2]
    uniforms = dict(uniforms)
    return _render_pass_xla_jit(
        fb, attrs, uniforms, jnp.int32(winner_offset), shader,
        width, height, chunk)


def pass_stats(setup: dict) -> dict:
    """Aggregate the reference's per-pass counters from a setup dict
    (our_gl.cpp:18-22 equivalents computable without the serial loop)."""
    valid = np.asarray(setup["valid"])
    bbox = np.asarray(setup["bbox"])
    n = int(valid.shape[0])
    if valid.any():
        vb = bbox[valid]
        agg = dict(min_x=int(vb[:, 0].min()), max_x=int(vb[:, 1].max()),
                   min_y=int(vb[:, 2].min()), max_y=int(vb[:, 3].max()))
    else:
        agg = dict(min_x=2**31 - 1, max_x=-2**31, min_y=2**31 - 1, max_y=-2**31)
    agg["triangles"] = n
    agg["valid_triangles"] = int(valid.sum())
    return agg
