"""SPMD multi-device rendering: framebuffer row bands over a device mesh.

The reference renders one framebuffer on one CPU thread
(our_gl.cpp:147-200).  The data-parallel scaling axis is *pixel ownership*:
shard the framebuffer's rows across a ``jax.sharding.Mesh`` with
``jax.shard_map``, replicate the (small) geometry, and let every device
rasterize only its band.  Because each pixel lives on exactly one device,
depth resolution needs **no collectives at all** — the only communication
is the implicit output layout (and a host gather when writing the TGA).
This is the renderer's analogue of sequence parallelism: the "ring" the
scaling book would stream is unnecessary since triangle setup is tiny
compared to per-pixel work.

Semantics are identical to the single-device scan path: each band runs
ops.raster.depth_resolve_xla / shade_winners with a global pixel-row
offset (``lax.axis_index * band_h``), so sharded output is
pixel-identical to unsharded (asserted by tests/test_parallel.py on 8
virtual CPU devices — the multi-node-tests-without-a-cluster strategy,
SURVEY.md §4.4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import device, raster, semantics
from tinyrenderder_tpu.ops.raster import FrameBuffers

__all__ = ["make_mesh", "render_pass_sharded", "render_frame_sharded",
           "render_pass_geometry_sharded", "render_frame_geometry_sharded",
           "render_frame_fused_sharded", "tiles_to_buffers_sharded",
           "new_sharded_framebuffers", "AXIS"]

AXIS = "rows"
AXIS_Y, AXIS_X = "ty", "tx"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (AXIS,))


def make_mesh_grid(n_rows: int, n_cols: int) -> Mesh:
    """2-D ('ty', 'tx') device mesh: framebuffer sharded in both screen
    axes (row bands x column bands)."""
    devices = jax.devices()
    n = n_rows * n_cols
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]).reshape(n_rows, n_cols),
                (AXIS_Y, AXIS_X))


def new_sharded_framebuffers(mesh: Mesh, width: int, height: int) -> FrameBuffers:
    """Fresh framebuffers laid out as row bands (1-D mesh) or screen
    blocks (2-D mesh) across the devices (init_zbuffer semantics: depth
    cleared to +inf, our_gl.cpp:72-74)."""
    if mesh.axis_names == (AXIS_Y, AXIS_X):
        if height % mesh.shape[AXIS_Y] or width % mesh.shape[AXIS_X]:
            raise ValueError(f"{width}x{height} not divisible by the "
                             f"{dict(mesh.shape)} mesh")
        sharding = NamedSharding(mesh, P(AXIS_Y, AXIS_X))
    else:
        n = mesh.devices.size
        if height % n:
            raise ValueError(f"height {height} not divisible by {n} devices")
        sharding = NamedSharding(mesh, P(AXIS))

    @functools.partial(jax.jit, out_shardings=sharding)
    def init():
        return FrameBuffers(
            color=jnp.zeros((height, width, 3), jnp.uint8),
            depth=jnp.full((height, width), jnp.inf, jnp.float32),
            winner=jnp.full((height, width), raster.BACKGROUND, jnp.int32),
        )

    return init()


@functools.lru_cache(maxsize=None)
def _sharded_pass_fn(mesh: Mesh, shader, width: int, height: int, chunk: int):
    n = mesh.devices.size
    band_h = height // n
    vp = math3d.viewport(0, 0, width, height)

    def shard_body(fb: FrameBuffers, attrs, uniforms, winner_offset):
        y0 = jax.lax.axis_index(AXIS) * band_h
        dtype = attrs["position"].dtype
        # replicated geometry work: vertex transform + triangle setup is
        # tiny next to per-pixel work, so every device redoes it rather
        # than paying an all-gather (scaling-book style tradeoff)
        clip, varyings = shader.vertex(uniforms, attrs, jnp)
        setup = semantics.triangle_setup_planes(
            clip, jnp.asarray(vp, dtype=dtype), width, height, jnp)
        # the fresh winner buffer must carry the same device-varying type
        # as the depth it is scanned with (shard_map vma tracking)
        init_winner = jax.lax.pcast(
            jnp.full((band_h, width), raster.BACKGROUND, jnp.int32),
            AXIS, to="varying")
        depth, winner_local = raster.depth_resolve_xla(
            setup, band_h, width, chunk=chunk, init_depth=fb.depth,
            init_winner=init_winner, y0=y0)
        won = winner_local >= 0
        new_winner = jnp.where(won, winner_local + winner_offset, fb.winner)
        if shader.writes_color:
            color = raster.shade_winners(fb.color, winner_local, setup,
                                         varyings, shader, uniforms,
                                         band_h, width, y0=y0)
        else:
            color = fb.color             # depth-only pass
        return FrameBuffers(color=color, depth=depth, winner=new_winner)

    fb_spec = FrameBuffers(color=P(AXIS), depth=P(AXIS), winner=P(AXIS))
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(fb_spec, P(), P(), P()),
        out_specs=fb_spec)
    return jax.jit(mapped)


def render_pass_sharded(mesh: Mesh, fb: FrameBuffers, attrs: dict, shader,
                        uniforms: dict, winner_offset: int = 0,
                        chunk: int = 8) -> FrameBuffers:
    """Render one (mesh, shader) pass with the framebuffer row-sharded
    over ``mesh``.  Same per-pixel results as raster.render_pass_xla."""
    height, width = fb.color.shape[:2]
    fn = _sharded_pass_fn(mesh, shader, width, height, chunk)
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    return fn(fb, attrs, dict(uniforms), jnp.int32(winner_offset))


def render_frame_sharded(mesh: Mesh, passes, width: int, height: int,
                         chunk: int = 8, tiled: bool | None = None,
                         return_output_depth: bool = False,
                         strict_capacity: bool = True):
    """Full multi-pass frame (the main.cpp:647-736 flow) on a sharded
    framebuffer.  ``passes``: iterable of (attrs, shader, uniforms) or
    (attrs, shader, uniforms, exclude_from_output_depth).

    Passes flagged ``exclude_from_output_depth`` get the reference's
    z-snapshot-around-the-eye-pass semantics (main.cpp:700,730): their
    depth writes are restored away before any later pass and excluded
    from the frame's *output* depth.  The snapshot is a free pytree
    reference (sharded arrays are immutable) and needs no collectives.

    ``tiled=None`` uses the production binned/Pallas pipeline when the
    band height is tile-aligned, else the scan path.

    Returns ``fb``, or ``(fb, output_depth)`` when
    ``return_output_depth`` — ``fb.depth`` always includes every pass,
    ``output_depth`` is the post-restore depth SSAO/z-viz should see.
    """
    from tinyrenderder_tpu.ops import raster_tiled
    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    if tiled is None:
        if two_d:
            tiled = (height % (mesh.shape[AXIS_Y] * raster_tiled.TILE_H) == 0
                     and width % (mesh.shape[AXIS_X] * raster_tiled.TILE_W) == 0)
        else:
            # width alignment matters too: the tiled path needs whole
            # tile columns, else fall back to the scan path
            tiled = (height % (mesh.devices.size * raster_tiled.TILE_H) == 0
                     and width % raster_tiled.TILE_W == 0)
    if two_d and not tiled:
        raise ValueError("2-D meshes require the tiled pipeline "
                         "(tile-aligned blocks)")
    fb = new_sharded_framebuffers(mesh, width, height)
    offset = 0
    snapshot_depth = None
    in_excluded = False
    for item in passes:
        attrs, shader, uniforms, *rest = item
        exclude = bool(rest[0]) if rest else False
        if exclude:
            if not in_excluded:
                snapshot_depth = fb.depth       # immutable: free snapshot
                in_excluded = True
        elif in_excluded:
            # main.cpp:730: restore before any later pass renders
            fb = FrameBuffers(color=fb.color, depth=snapshot_depth,
                              winner=fb.winner)
            in_excluded = False
        if tiled:
            fb = render_pass_sharded_tiled(mesh, fb, attrs, shader, uniforms,
                                           winner_offset=offset,
                                           strict_capacity=strict_capacity)
        else:
            fb = render_pass_sharded(mesh, fb, attrs, shader, uniforms,
                                     winner_offset=offset, chunk=chunk)
        offset += attrs["position"].shape[0]
    if return_output_depth:
        out_depth = snapshot_depth if in_excluded else fb.depth
        return fb, out_depth
    return fb



# ---------------------------------------------------------------------------
# Geometry (triangle) parallelism: the collectives-based SPMD analogue
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _geometry_pass_fn(mesh: Mesh, shader, width: int, height: int,
                      chunk: int, f_shard: int):
    """SPMD triangle parallelism (SURVEY.md §2 parallelism checklist):
    the face arrays are sharded over the mesh in contiguous submission-
    order blocks, every device rasterizes its block over the FULL frame,
    and the per-device results merge with XLA collectives:

      * depth: ``lax.pmin`` — all-reduce-min of the per-device z-buffers.
      * winner: min global triangle id among devices achieving the
        merged z (the reference's strict-less first-drawn-wins tie rule
        our_gl.cpp:165 IS min-id-at-min-z, since submission order is id
        order).
      * color: each device shades only pixels its triangle won; an
        exactly-one-contributor ``lax.psum`` assembles the frame.

    Complements the zero-collective pixel-ownership sharding
    (_sharded_pass_fn): that path scales per-pixel work, this one scales
    per-triangle work for high-poly/small-frame regimes — together they
    are the renderer's data/tensor-parallel pair.  Bitwise-identical to
    the single-device scan path (tests/test_parallel.py)."""
    vp = math3d.viewport(0, 0, width, height)
    BIG = jnp.int32(1 << 30)

    def shard_body(fb: FrameBuffers, attrs_shard, uniforms, winner_offset):
        base = jax.lax.axis_index(AXIS) * f_shard
        dtype = attrs_shard["position"].dtype
        clip, varyings = shader.vertex(uniforms, attrs_shard, jnp)
        setup = semantics.triangle_setup_planes(
            clip, jnp.asarray(vp, dtype=dtype), width, height, jnp)
        init_winner = jax.lax.pcast(
            jnp.full((height, width), raster.BACKGROUND, jnp.int32),
            AXIS, to="varying")
        init_depth = jax.lax.pcast(fb.depth, AXIS, to="varying")
        depth_l, winner_l = raster.depth_resolve_xla(
            setup, height, width, chunk=chunk, init_depth=init_depth,
            init_winner=init_winner)
        # ---- collective merge ----
        zmin = jax.lax.pmin(depth_l, AXIS)
        cand = jnp.where((winner_l >= 0) & (depth_l == zmin),
                         winner_l + base, BIG)
        gwin = jax.lax.pmin(cand, AXIS)
        drawn = gwin < BIG
        new_winner = jnp.where(drawn, gwin + winner_offset, fb.winner)
        if shader.writes_color:
            mine = drawn & (cand == gwin)      # this device owns the pixel
            color_l = raster.shade_winners(
                fb.color, jnp.where(mine, winner_l, raster.BACKGROUND),
                setup, varyings, shader, uniforms, height, width)
            col = jax.lax.psum(
                jnp.where(mine[..., None], color_l.astype(jnp.int32), 0),
                AXIS).astype(jnp.uint8)
            any_mine = jax.lax.psum(mine.astype(jnp.int32), AXIS) > 0
            color = jnp.where(any_mine[..., None], col, fb.color)
        else:
            color = fb.color
        return FrameBuffers(color=color, depth=zmin, winner=new_winner)

    attrs_spec = P(AXIS)                        # faces sharded, axis 0
    fb_spec = FrameBuffers(color=P(), depth=P(), winner=P())
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(fb_spec, attrs_spec, P(), P()),
        out_specs=fb_spec)
    return jax.jit(mapped)


def render_pass_geometry_sharded(mesh: Mesh, fb: FrameBuffers, attrs: dict,
                                 shader, uniforms: dict,
                                 winner_offset: int = 0,
                                 chunk: int = 8) -> FrameBuffers:
    """One pass with triangles sharded over the mesh (see
    _geometry_pass_fn).  The framebuffer is replicated; face arrays are
    padded to a device multiple with degenerate (w=0, auto-rejected)
    triangles so contiguous blocks preserve submission order."""
    n = mesh.devices.size
    f = attrs["position"].shape[0]
    f_shard = -(-max(f, 1) // n)
    pad = f_shard * n - f
    if pad:
        attrs = {k: jnp.concatenate(
            [jnp.asarray(v),
             jnp.zeros((pad,) + tuple(v.shape[1:]), v.dtype)], axis=0)
            for k, v in attrs.items()}
    fn = _geometry_pass_fn(mesh, shader, width=fb.width, height=fb.height,
                           chunk=chunk, f_shard=f_shard)
    return fn(fb, attrs, uniforms, jnp.int32(winner_offset))


def render_frame_geometry_sharded(mesh: Mesh, passes, width: int,
                                  height: int, chunk: int = 8):
    """Multi-pass frame with geometry parallelism (incl. the z-snapshot
    semantics around excluded passes, main.cpp:700,730).  Returns
    (fb, output_depth)."""
    fb = raster.new_framebuffers(width, height)
    offset = 0
    snapshot_depth = None
    in_excluded = False
    for item in passes:
        attrs, shader, uniforms, *rest = item
        exclude = bool(rest[0]) if rest else False
        if exclude:
            if not in_excluded:
                snapshot_depth = fb.depth
                in_excluded = True
        elif in_excluded:
            fb = FrameBuffers(color=fb.color, depth=snapshot_depth,
                              winner=fb.winner)
            in_excluded = False
        fb = render_pass_geometry_sharded(mesh, fb, attrs, shader,
                                          uniforms, winner_offset=offset,
                                          chunk=chunk)
        offset += attrs["position"].shape[0]
    out_depth = snapshot_depth if in_excluded else fb.depth
    return fb, out_depth


# ---------------------------------------------------------------------------
# Production sharded path: per-band CSR binning + the Pallas tile kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sharded_tiled_fn(mesh: Mesh, shader, width: int, height: int,
                      capacity: int, tile_h: int, tile_w: int,
                      interpret: bool):
    from tinyrenderder_tpu.ops import raster_pallas, raster_tiled

    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n_rows = mesh.shape[AXIS_Y] if two_d else mesh.devices.size
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    band_h = height // n_rows
    band_w = width // n_cols
    band_tiles_y = band_h // tile_h
    band_tiles_x = band_w // tile_w
    spec = (tuple(shader.varying_spec.items())
            if shader.writes_color else ())
    n_vary = sum(c for _, c in spec)
    vp = math3d.viewport(0, 0, width, height)

    def shard_body(fb: FrameBuffers, attrs, uniforms, winner_offset):
        iy = jax.lax.axis_index(AXIS_Y if two_d else AXIS)
        ix = jax.lax.axis_index(AXIS_X) if two_d else jnp.int32(0)
        ty_lo = iy * band_tiles_y
        ty_hi = ty_lo + band_tiles_y - 1
        tx_lo = ix * band_tiles_x
        tx_hi = tx_lo + band_tiles_x - 1
        dtype = attrs["position"].dtype

        clip, varyings = shader.vertex(uniforms, attrs, jnp)
        setup = semantics.triangle_setup_planes(
            clip, jnp.asarray(vp, dtype=dtype), width, height, jnp)
        tx0, ty0, span_x, spans, total = raster_tiled._tile_spans(
            setup, tile_w, tile_h, ty_lo, ty_hi,
            tx_lo if two_d else None, tx_hi if two_d else None)
        sorted_tri, start, counts = raster_tiled._build_bins(
            tx0, ty0, span_x, spans, capacity, band_tiles_x, band_tiles_y)
        vary_corners = (raster_tiled._flatten_varyings(varyings, spec)
                        if spec else None)
        records = raster_pallas.build_records(setup, sorted_tri,
                                              vary_corners)
        init_tiles = raster_tiled._to_tiles(
            fb.depth, band_tiles_y, band_tiles_x, tile_h, tile_w, jnp.inf)
        origin = jnp.stack([ix * jnp.int32(band_w), iy * jnp.int32(band_h)])
        depth_t, winner_t, vary_t, _ = raster_pallas.resolve_tiles(
            jnp.arange(band_tiles_x * band_tiles_y, dtype=jnp.int32),
            start[:-1], counts, records, init_tiles, band_tiles_x, tile_h,
            tile_w, n_vary, interpret, origin=origin)
        new_fb = raster_tiled._post_pallas_jit(
            fb, depth_t, winner_t, vary_t, uniforms, winner_offset,
            shader, spec, band_w, band_h, tile_h, tile_w)
        t_out = total.reshape(1, 1) if two_d else total.reshape(1)
        return new_fb, t_out              # per-block totals, gathered

    if two_d:
        block = P(AXIS_Y, AXIS_X)
        total_spec = P(AXIS_Y, AXIS_X)
    else:
        block = P(AXIS)
        total_spec = P(AXIS)
    fb_spec = FrameBuffers(color=block, depth=block, winner=block)
    # check_vma=False: pallas_call's out_shapes don't carry vma metadata
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(fb_spec, P(), P(), P()),
        out_specs=(fb_spec, total_spec),
        check_vma=False)
    return jax.jit(mapped)


# legacy sharded per-pass path: async pending totals, (key) ->
# (device totals, capacity, age) — the shared async-capacity pattern
_SHARDED_TILED_PENDING: dict = {}


def render_pass_sharded_tiled(mesh: Mesh, fb: FrameBuffers, attrs: dict,
                              shader, uniforms: dict,
                              winner_offset: int = 0,
                              tile_h: int | None = None,
                              tile_w: int | None = None,
                              strict_capacity: bool = True,
                              _capacity: int | None = None) -> FrameBuffers:
    """One pass through the binned/Pallas pipeline with the framebuffer
    row-sharded over ``mesh``: each device bins triangles against its own
    band's tile grid and rasterizes only those — still zero collectives.

    ``strict_capacity=False`` resolves the per-block pair totals
    asynchronously at a later pass instead of blocking on a per-pass
    device_get — the same one-frame-late overflow contract as the
    single-device paths.  Prefer render_frame_fused_sharded: it runs the
    production sparse pipeline under the same sharding."""
    from tinyrenderder_tpu.ops import raster_tiled

    if tile_h is None:
        tile_h = raster_tiled.TILE_H
    if tile_w is None:
        tile_w = raster_tiled.TILE_W
    height, width = fb.color.shape[:2]
    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n_rows = mesh.shape[AXIS_Y] if two_d else mesh.devices.size
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    if (height % n_rows) or (height // n_rows) % tile_h:
        raise ValueError(f"height {height} not divisible into {n_rows} "
                         f"tile-aligned bands")
    if (width % n_cols) or (width // n_cols) % tile_w:
        raise ValueError(f"width {width} not divisible into {n_cols} "
                         f"tile-aligned columns")
    f = attrs["position"].shape[0]
    if f == 0:
        return fb
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    uniforms = dict(uniforms)

    key = (f, width, height, n_rows, n_cols, "sharded")
    if not strict_capacity:
        _resolve_sharded_tiled_pending(key)
    capacity = (_capacity if _capacity is not None
                else raster_tiled._PAIR_CAPACITY.get(key))
    if capacity is None:
        # first frame: sync once on the unsharded full-screen pair count
        # (an upper bound for every band)
        setup0, _ = raster_tiled._vertex_setup_jit(
            attrs, uniforms, shader, width, height)
        *_, total0 = raster_tiled._tile_spans(setup0, tile_w, tile_h)
        capacity = raster_tiled._quantize_capacity(
            int(jax.device_get(total0)))
    raster_tiled._PAIR_CAPACITY[key] = capacity

    interpret = device.interpret()
    fn = _sharded_tiled_fn(mesh, shader, width, height, capacity,
                           tile_h, tile_w, interpret)
    new_fb, totals = fn(fb, attrs, uniforms, jnp.int32(winner_offset))
    if not strict_capacity:
        if key not in _SHARDED_TILED_PENDING:
            tmax = jnp.max(totals)
            try:
                tmax.copy_to_host_async()
            except AttributeError:
                pass
            _SHARDED_TILED_PENDING[key] = (tmax, capacity, 0)
        return new_fb
    tot = int(jax.device_get(jnp.max(totals)))
    if tot > capacity:
        return render_pass_sharded_tiled(
            mesh, fb, attrs, shader, uniforms, winner_offset, tile_h,
            tile_w, strict_capacity,
            _capacity=raster_tiled._quantize_capacity(tot))
    return new_fb


def _resolve_sharded_tiled_pending(key):
    from tinyrenderder_tpu.ops import raster_tiled
    prev = _SHARDED_TILED_PENDING.get(key)
    if prev is None:
        return
    tot_dev, cap, age = prev
    ready = getattr(tot_dev, "is_ready", lambda: True)()
    # never block on an un-landed D2H (see raster_sparse._resolve_pending)
    if ready:
        _SHARDED_TILED_PENDING.pop(key)
        tot = int(np.asarray(tot_dev))
        if tot > cap:
            import logging
            logging.getLogger(__name__).warning(
                "sharded pass overflow (%d/%d) detected %d pass(es) "
                "late; capacity grown", tot, cap, age + 1)
            raster_tiled._PAIR_CAPACITY[key] = max(
                raster_tiled._PAIR_CAPACITY.get(key, cap),
                raster_tiled._quantize_capacity(tot))
    else:
        _SHARDED_TILED_PENDING[key] = (tot_dev, cap, age + 1)


# ---------------------------------------------------------------------------
# Sharded PRODUCTION pipeline: the fused sparse frame under shard_map
# ---------------------------------------------------------------------------
#
# The fast path and the scaled path are the same path.  This section
# runs raster_sparse._fused_frame_body — the production fused frame
# (sparse pre -> resolve kernel -> phase C, tiled-resident) — once per
# device over row bands of the screen:
#
#   * every device re-runs the (tiny) vertex/setup stage, bins
#     triangles against ITS band's tile grid only (band-clipped
#     _tile_spans), builds band-local records, and rasterizes its own
#     FrameTiles at global pixel coordinates via the kernel ``origin``;
#   * pixels have exactly one owner, so there are ZERO collectives —
#     per-band outputs concatenate along the tile axis into the global
#     tiled frame;
#   * per-band (pair, active, won) totals come back as a sharded array;
#     capacity bookkeeping can run ASYNC (copy_to_host_async +
#     next-frame resolve), so steady-state loops never block on a
#     device round trip.
#
# Parity contract: band-clipped bins are per-tile identical to the
# full-screen bins (same pairs, same order), so every tile's kernel
# merge — and therefore the whole frame — is BITWISE identical to the
# single-device fused path (tests/test_parallel.py asserts this on the
# 8-virtual-device CPU mesh).  Reference anchor: our_gl.cpp:147-200.

# (plan-shape key) -> list of per-pass caps used by the sharded frame
_SHARD_FUSED_CAPS: dict = {}
_SHARD_FUSED_PENDING: dict = {}
_SHARD_FUSED_REFINED: set = set()   # keys whose caps are band-local
_SHARD_FUSED_W_REFINED: set = set()  # keys whose won-tile cap was measured


@functools.lru_cache(maxsize=None)
def _sharded_fused_fn(mesh: Mesh, plan, width: int, height: int,
                      tile_h: int, tile_w: int, interpret: bool,
                      interleave: bool = False, geom_shard: bool = False,
                      band_cap: int | None = None):
    from tinyrenderder_tpu.ops import raster_sparse

    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n = mesh.devices.size
    n_rows = mesh.shape[AXIS_Y] if two_d else n
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    nty = height // tile_h
    band_tiles_y = nty // n_rows
    band_tiles_x = (width // tile_w) // n_cols
    axes = (AXIS_Y, AXIS_X) if two_d else AXIS
    ft_spec = raster_sparse.FrameTiles(color=P(axes), depth=P(axes),
                                      winner=P(axes))

    if band_cap is not None:
        # MEASURED-LOAD bands (1-D meshes): each device owns a
        # contiguous run of tile rows of UNEQUAL height under one
        # static band shape (band_cap rows); its (lo, rows) arrive as
        # sharded (N,) operands, so repartitioning a scene re-traces
        # nothing.  Rows past ``rows`` bin no pairs and stay
        # background; the row map at the transfer boundary drops them.
        def shard_body_measured(attrs_t, uniforms_t, lo, rows):
            ty_lo = lo[0].astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (ty_lo * tile_h).astype(jnp.int32)])
            ft, out_depth, overflow, totals = \
                raster_sparse._fused_frame_body(
                    attrs_t, uniforms_t, plan, width, height, tile_h,
                    tile_w, interpret, ty_lo=ty_lo, nty_band=band_cap,
                    origin=origin, ty_stride=1,
                    geom_axis=(AXIS if geom_shard else None),
                    ty_rows=rows[0].astype(jnp.int32))
            return (ft, out_depth, overflow.reshape(1), totals[None])

        mapped = jax.shard_map(
            shard_body_measured, mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P(AXIS)),
            out_specs=(ft_spec, P(AXIS), P(AXIS), P(AXIS)),
            check_vma=False)
        return jax.jit(mapped)

    def shard_body(attrs_t, uniforms_t):
        tx_lo = None
        if two_d:
            iy = jax.lax.axis_index(AXIS_Y)
            ix = jax.lax.axis_index(AXIS_X)
            ty_lo = (iy * band_tiles_y).astype(jnp.int32)
            tx_lo = (ix * band_tiles_x).astype(jnp.int32)
            origin = jnp.stack([(tx_lo * tile_w).astype(jnp.int32),
                                (ty_lo * tile_h).astype(jnp.int32)])
            stride = 1
        elif interleave:
            # device b owns tile rows b, b+n, b+2n, ... — coverage hot
            # spots (contiguous in y) spread evenly across devices
            b = jax.lax.axis_index(AXIS)
            ty_lo = b.astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (b * tile_h).astype(jnp.int32)])
            stride = n
        else:
            b = jax.lax.axis_index(AXIS)
            ty_lo = (b * band_tiles_y).astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (ty_lo * tile_h).astype(jnp.int32)])
            stride = 1
        # geometry sharding: the per-triangle vertex stage — the one
        # term the row/block decomposition replicates — also splits
        # over the mesh (all devices jointly on 2-D grids) and
        # all_gathers, bitwise-equal (raster_tiled._vertex_stage)
        geom_axis = (axes if geom_shard else None)
        ft, out_depth, overflow, totals = raster_sparse._fused_frame_body(
            attrs_t, uniforms_t, plan, width, height, tile_h, tile_w,
            interpret, ty_lo=ty_lo, nty_band=band_tiles_y, origin=origin,
            ty_stride=stride,
            tx_lo=tx_lo, ntx_band=band_tiles_x if two_d else None,
            geom_axis=geom_axis)
        return (ft, out_depth, overflow.reshape(1), totals[None])

    # on a 2-D mesh the flat band-tile axis shards over BOTH axes
    # jointly: global device order is row-major (iy * n_cols + ix);
    # blocks_to_flat_tiles / the 2-D untile reorder at the boundary
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(ft_spec, P(axes), P(axes), P(axes)),
        check_vma=False)          # pallas outputs carry no vma metadata
    return jax.jit(mapped)


def _fold_fused_totals(key, t_max, n_tiles_band) -> bool:
    """Fold one measured per-band totals max into the caps store.

    Mirrors the single-device rules exactly: the first fold shrinks the
    full-screen-seeded caps to band-local sizes (once, _SHARD_FUSED_
    REFINED); the won-tile slot refines SEPARATELY and only from a real
    measurement — a depth-only pass reports the wt<0 sentinel
    (raster_sparse._post_sparse_jit) and must keep the seeded w_cap, or
    a color pass sharing the key would shade 8 won tiles forever; after
    refinement caps only grow, always from the CURRENT store (another
    same-key pass may have grown them since this frame ran — f67fb41).
    Returns True when t_max overflowed the current caps (the frame that
    measured it dropped work: strict mode re-renders, async mode warns).
    """
    from tinyrenderder_tpu.ops import raster_sparse
    cur = _SHARD_FUSED_CAPS[key]
    fit = raster_sparse._caps_fit(cur, t_max)
    wt = int(t_max[2])
    if key not in _SHARD_FUSED_REFINED:
        q = raster_sparse._caps_from_totals(t_max, n_tiles_band)
        if wt < 0:
            q = (*q[:-1], cur[-1])              # sentinel: keep seeded w
        else:
            _SHARD_FUSED_W_REFINED.add(key)
        _SHARD_FUSED_CAPS[key] = q
        _SHARD_FUSED_REFINED.add(key)
        return not fit
    if wt >= 0 and key not in _SHARD_FUSED_W_REFINED:
        w_new = min(cur[-1], max(8, raster_sparse._quantize_active(
            wt, n_tiles_band)))
        if w_new < cur[-1]:
            cur = (*cur[:-1], w_new)
            _SHARD_FUSED_CAPS[key] = cur
        _SHARD_FUSED_W_REFINED.add(key)
    if not fit:
        _SHARD_FUSED_CAPS[key] = raster_sparse._grow_caps(cur, t_max,
                                                          n_tiles_band)
    return not fit


def _clamp_band_caps(caps, n_tiles_band):
    """The active- and won-tile capacities can never exceed the band's
    tile count."""
    cap, ac, wc = caps
    return (cap, min(ac, n_tiles_band), min(wc, n_tiles_band))


# ---- measured-load band splitting -------------------------------------------
#
# Interleaved row bands equalize contiguous coverage hot spots, but
# stride aliasing can still leave ~2x pair-count imbalance on
# center-concentrated scenes at small tile-row counts (the dryrun's own
# per-shard totals print max/mean 1.895).  Measured bands instead give
# each device a CONTIGUOUS run of tile rows sized by the measured
# per-row pair cost (classic linear min-max partition), under ONE
# static band shape so shard_map shapes and capacity caches stay
# uniform: every device's buffers hold band_cap tile rows, a device
# with fewer real rows simply bins nothing into the surplus, and the
# transfer-boundary row map drops the dead rows.  Bitwise parity holds
# like every other layout: one owner per pixel, global coordinates.

def _check_bands(bands, n, height, tile_h):
    if len(bands) != n:
        raise ValueError(f"bands has {len(bands)} entries for {n} devices")
    if height % tile_h:
        raise ValueError(f"height {height} not tile-aligned")
    nty = height // tile_h
    at = 0
    for lo, rows in bands:
        if lo != at or rows < 0:
            raise ValueError(f"bands must tile [0, {nty}) contiguously, "
                             f"got {bands}")
        at += rows
    if at != nty:
        raise ValueError(f"bands cover {at} of {nty} tile rows")


@functools.partial(jax.jit, static_argnames=("shader", "width", "height",
                                             "tile_h", "tile_w"))
def _row_costs_jit(attrs, uniforms, shader, width, height, tile_h, tile_w):
    """(nty,) pair count per tile row for one pass: the same clamped
    bbox the binning uses (raster_tiled._tile_spans), accumulated as a
    difference array over rows — one tiny reduction, no pair expansion."""
    from tinyrenderder_tpu.ops import raster_sparse
    setup, _ = raster_sparse._vertex_setup(attrs, uniforms, shader,
                                           width, height)
    nty = -(-height // tile_h)
    bbox = setup["bbox"]
    valid = setup["valid"]
    tx0 = (bbox[:, 0] // tile_w).astype(jnp.int32)
    tx1 = (bbox[:, 1] // tile_w).astype(jnp.int32)
    ty0 = (bbox[:, 2] // tile_h).astype(jnp.int32)
    ty1 = (bbox[:, 3] // tile_h).astype(jnp.int32)
    ok = valid & (ty1 >= ty0) & (tx1 >= tx0)
    add = jnp.where(ok, tx1 - tx0 + 1, 0).astype(jnp.int32)
    diff = jnp.zeros(nty + 1, jnp.int32)
    diff = diff.at[jnp.clip(ty0, 0, nty)].add(add, mode="drop")
    diff = diff.at[jnp.clip(ty1 + 1, 0, nty)].add(-add, mode="drop")
    return jnp.cumsum(diff)[:nty]


def measure_tile_row_costs(passes, width: int, height: int,
                           tile_h: int | None = None,
                           tile_w: int | None = None) -> np.ndarray:
    """Measured per-tile-row binning cost (pair counts) summed over the
    frame's passes — the balance_bands input.  One (nty,)-int fetch
    (the blocking form of measure_tile_row_costs_device)."""
    dev = measure_tile_row_costs_device(passes, width, height,
                                        tile_h, tile_w)
    return np.asarray(jax.device_get(dev)).astype(np.int64)


def _stable_band_cap(bands, nty: int, n: int) -> int:
    """The STATIC band shape for an unequal partition.  A partition at
    the minimal possible max (ceil(nty/n) — even_unequal_bands always,
    and any DP result that tight) keeps EXACTLY that shape: it is a
    pure function of (nty, n), so stability is free and padding would
    only buy ~1/even extra capacity-shaped compute per device.  Looser
    measured partitions use the default DP cap (even + ~12.5%) so
    repartitioning (camera/model motion re-measures) never changes
    traced shapes; only a caller-forced larger cap pays a retrace."""
    even = -(-nty // n)
    mx = max(r for _, r in bands)
    if mx <= even:
        return even
    cap = even + max(1, even // 8)
    return cap if mx <= cap else mx


def even_unequal_bands(nty: int, n: int) -> tuple:
    """Measurement-free near-even contiguous partition: the first
    nty % n bands get one extra row.  The zero-sync default for frames
    whose rows don't divide by the device count (the fused path's
    legality fix); measured bands (balance_bands) refine it when the
    caller can afford the measurement."""
    base, extra = divmod(nty, n)
    bands = []
    at = 0
    for b in range(n):
        rows = base + (1 if b < extra else 0)
        bands.append((at, rows))
        at += rows
    return tuple(bands)


def measure_tile_row_costs_device(passes, width: int, height: int,
                                  tile_h: int | None = None,
                                  tile_w: int | None = None):
    """Device-resident per-tile-row cost sum over the passes — the
    async form of measure_tile_row_costs: start its D2H with
    copy_to_host_async and resolve on a LATER frame (the scene driver's
    band cache does), so steady-state loops never block on it."""
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W
    th = tile_h or TILE_H
    tw = tile_w or TILE_W
    total = None
    for attrs, shader, uniforms, *_ in passes:
        attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
        costs = _row_costs_jit(attrs, dict(uniforms), shader, width,
                               height, th, tw)
        total = costs if total is None else total + costs
    return total


def balance_bands(row_costs, n: int,
                  band_cap: int | None = None) -> tuple:
    """Optimal contiguous min-max partition of the tile rows into ``n``
    bands (linear-partition DP over the measured per-row costs), each at
    most ``band_cap`` rows.  Returns ((lo, rows), ...) per device.

    The default cap is TIGHT — ceil(nty/n) + max(1, ceil/8), ~12.5%
    slack: every device's static band shape follows the LARGEST band,
    and the capacity-shaped stages cost time proportional to that shape
    (an unconstrained cap can hand one device many near-empty rows,
    and every device pays for the largest band's shape).  Scenes whose
    pair imbalance is worth more shape can pass a larger cap."""
    costs = np.asarray(row_costs, np.float64)
    nty = len(costs)
    even = -(-nty // n)
    cap = (band_cap if band_cap is not None
           else even + max(1, even // 8))
    cap = max(cap, even)               # feasibility: n bands must cover
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    inf = float("inf")
    dp = np.full(nty + 1, inf)
    dp[0] = 0.0
    cut = np.zeros((n + 1, nty + 1), np.int32)
    for b in range(1, n + 1):
        ndp = np.full(nty + 1, inf)
        for i in range(nty + 1):
            j0 = max(0, i - cap)
            cand = np.maximum(dp[j0:i + 1], prefix[i] - prefix[j0:i + 1])
            k = int(np.argmin(cand))
            ndp[i] = cand[k]
            cut[b][i] = j0 + k
        dp = ndp
    bands = []
    i = nty
    for b in range(n, 0, -1):
        j = int(cut[b][i])
        bands.append((j, i - j))
        i = j
    bands.reverse()
    return tuple(bands)


@functools.lru_cache(maxsize=64)
def _band_row_map_dev(bands, band_cap: int, tile_h: int, height: int):
    """Device-resident row map, cached per partition: the sharded
    transfer helpers run per frame and the host O(H) build + H2D
    upload must not repeat while the partition holds still."""
    return jnp.asarray(_band_row_map(bands, band_cap, tile_h, height))


def _band_row_map(bands, band_cap: int, tile_h: int,
                  height: int) -> np.ndarray:
    """(H,) gather indices: global pixel row -> its row in the
    device-concatenated (n * band_cap * tile_h, W) padded output."""
    src = np.empty(height, np.int64)
    for b, (lo, rows) in enumerate(bands):
        for t in range(rows):
            g0 = (lo + t) * tile_h
            s0 = (b * band_cap + t) * tile_h
            src[g0:g0 + tile_h] = np.arange(s0, s0 + tile_h)
    return src


def render_frame_fused_sharded(mesh: Mesh, passes, width: int, height: int,
                               tile_h: int | None = None,
                               tile_w: int | None = None,
                               strict_capacity: bool = True,
                               interleave: bool = False,
                               geom_shard: bool = True,
                               bands: tuple | None = None):
    """Render a whole multi-pass frame through the PRODUCTION fused
    pipeline with the framebuffer row-band-sharded over ``mesh``.

    ``passes``: list of (attrs, shader, uniforms,
    exclude_from_output_depth); every pass must be non-empty.  Returns
    (FrameTiles sharded on the tile axis, out_depth tiles, per-band
    overflow device bools).  Use tiles_to_buffers_sharded for the
    (H, W) row-sharded FrameBuffers.

    Capacity semantics: capacities are shared by every band (shard_map
    needs uniform static shapes).  The first frame of a key seeds them
    from the full-screen totals (a correct upper bound for any band,
    one sync); afterwards they are REFINED to the quantized per-band
    maxima — strict mode syncs the per-band totals each frame and
    re-renders on overflow; async mode resolves them a frame late
    (exactly the single-device _resolve_pending contract).

    ``interleave=True`` assigns device b the tile rows b, b+N, b+2N, ...
    instead of one contiguous block.  Coverage concentrates in
    contiguous y ranges on real scenes (the busiest contiguous band of
    the 2048² head holds ~2x the average pair count), so interleaving equalizes per-device pair counts —
    and since capacities are shared across bands and sized by the MAX
    band, balanced bands shrink every device's pre-stage too.  The
    render stays collective-free; the one global row reorder happens in
    tiles_to_buffers_sharded(interleave=True) at the transfer boundary.
    Output FrameTiles are in device-major band order — pass the same
    ``interleave`` flag to the untile helpers.

    On a 2-D ``('ty','tx')`` mesh (make_mesh_grid) each device owns a
    SCREEN BLOCK: binning is clipped in both axes, the kernels rasterize
    at global pixel coordinates via the 2-D origin, and the flat tile
    axis shards over both mesh axes jointly (device-major row-major
    blocks — tiles_to_buffers_sharded assembles (H, W) without any
    reorder; blocks_to_flat_tiles gives single-device tile order for
    comparisons).  Bitwise-identical to the single-device fused frame,
    like the 1-D path.  ``interleave`` is 1-D-only.

    ``geom_shard=True`` (default) also shards the per-triangle vertex
    stage over the mesh — each device transforms F/N triangles and the
    setup/varyings all_gather in submission order
    (raster_tiled._vertex_stage, bitwise-equal).  This removes the one
    replicated term the screen decomposition leaves; the per-pixel
    stages stay collective-free.

    ``bands`` (1-D meshes, exclusive with ``interleave``): a per-device
    tuple of (first tile row, row count) — MEASURED-LOAD contiguous
    bands of unequal height, from balance_bands over measured per-row
    pair costs (measure_tile_row_costs).  All devices share one static
    band shape (max row count); a device's surplus rows bin nothing and
    the transfer-boundary row map drops them.  Pass the same ``bands``
    to tiles_to_buffers_sharded / untile_one_sharded.  Bitwise-
    identical to every other layout (each pixel has exactly one owner
    rasterizing at global coordinates)."""
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W

    if tile_h is None:
        tile_h = TILE_H
    if tile_w is None:
        tile_w = TILE_W
    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n = mesh.devices.size
    n_rows = mesh.shape[AXIS_Y] if two_d else n
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    if two_d and interleave:
        raise ValueError("interleave is only supported on 1-D row meshes")
    if bands is not None:
        if two_d or interleave:
            raise ValueError("bands needs a 1-D row mesh without "
                             "interleave")
        _check_bands(bands, n, height, tile_h)
    elif height % (n_rows * tile_h):
        raise ValueError(f"height {height} not divisible into {n_rows} "
                         f"tile-aligned bands")
    if width % (n_cols * tile_w):
        raise ValueError(f"width {width} not divisible into {n_cols} "
                         f"tile-aligned columns")
    n_tiles_x = width // tile_w
    nty = height // tile_h
    band_cap = (_stable_band_cap(bands, nty, n_rows)
                if bands is not None else None)
    band_tiles_y = band_cap if bands is not None else nty // n_rows
    n_tiles_band = (n_tiles_x // n_cols) * band_tiles_y
    n_tiles_full = n_tiles_x * nty
    interpret = device.interpret()

    plan = []
    keys = []
    attrs_t = []
    unis_t = []
    offset = 0
    for attrs, shader, uniforms, exclude in passes:
        f = attrs["position"].shape[0]
        if f == 0:
            raise ValueError("render_frame_fused_sharded requires "
                             "non-empty passes")
        attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
        uniforms = dict(uniforms)
        key = (f, n_tiles_x, nty, tile_h, tile_w, n_rows, n_cols,
               "fused-sharded",
               ("measured", band_cap) if bands is not None else interleave)
        caps = _SHARD_FUSED_CAPS.get(key)
        if caps is None:
            # seed from the full-screen totals: an upper bound for any
            # band (one sync on the first frame of this key only)
            caps = raster_sparse._resolve_caps(
                (f, n_tiles_x, nty), attrs, uniforms, shader,
                width, height, tile_h, tile_w, n_tiles_full)
            caps = _clamp_band_caps(caps, n_tiles_band)
            _SHARD_FUSED_CAPS[key] = caps
        elif not strict_capacity:
            _resolve_fused_pending(key, n_tiles_band)
            caps = _SHARD_FUSED_CAPS[key]
        plan.append((shader, caps, bool(exclude), offset))
        keys.append(key)
        attrs_t.append(attrs)
        unis_t.append(uniforms)
        offset += f

    fn = _sharded_fused_fn(mesh, tuple(plan), width, height,
                           tile_h, tile_w, interpret, interleave,
                           geom_shard, band_cap=band_cap)
    if bands is not None:
        lo_arr = jnp.asarray([lo for lo, _ in bands], jnp.int32)
        rows_arr = jnp.asarray([r for _, r in bands], jnp.int32)
        ft, out_depth, overflow, totals = fn(tuple(attrs_t),
                                             tuple(unis_t),
                                             lo_arr, rows_arr)
    else:
        ft, out_depth, overflow, totals = fn(tuple(attrs_t),
                                             tuple(unis_t))
    # totals: (n_bands, n_passes, 3)

    if strict_capacity:
        tot_host = np.asarray(jax.device_get(totals))
        t_max = tot_host.max(axis=0)              # (n_passes, 3)
        grown = False
        for key, t in zip(keys, t_max):
            grown |= _fold_fused_totals(key, t, n_tiles_band)
        if grown:
            return render_frame_fused_sharded(
                mesh, passes, width, height, tile_h, tile_w,
                strict_capacity, interleave, geom_shard, bands)
    else:
        # merge same-key passes within this frame (element-wise max)
        # BEFORE staging: a key's pending slot held only the FIRST
        # pass's totals, so a later same-key pass's overflow was
        # invisible to the resolve forever
        staged: dict = {}
        for i, key in enumerate(keys):
            prev = staged.get(key)
            if prev is None:
                # axis=1: totals is (n_bands, n_passes, w) — the view
                # keeps the band axis for the resolver's per-band max
                staged[key] = raster_sparse._StagedTotals(totals, i, axis=1)
            else:
                prev.merge_row(i)
        for key, st in staged.items():
            raster_sparse._stage_pending(_SHARD_FUSED_PENDING, key, st,
                                         _SHARD_FUSED_CAPS[key])
    return ft, out_depth, overflow


@functools.lru_cache(maxsize=None)
def _sharded_fused_image_fn(mesh: Mesh, plan, width: int, height: int,
                            tile_h: int, tile_w: int, interpret: bool,
                            interleave: bool, geom_shard: bool,
                            direct: bool, band_cap: int | None = None):
    from tinyrenderder_tpu.ops import raster_sparse

    n = mesh.devices.size
    nty = height // tile_h
    band_tiles_y = nty // n

    if band_cap is not None:
        # measured-load bands (see _sharded_fused_fn): per-device
        # (lo, rows) as sharded operands under one static band shape
        def shard_body_measured(attrs_t, uniforms_t, lo, rows):
            ty_lo = lo[0].astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (ty_lo * tile_h).astype(jnp.int32)])
            img, overflow, totals = raster_sparse._fused_image_body(
                attrs_t, uniforms_t, plan, width, height, tile_h, tile_w,
                interpret, direct, ty_lo=ty_lo, nty_band=band_cap,
                origin=origin, ty_stride=1,
                geom_axis=(AXIS if geom_shard else None),
                ty_rows=rows[0].astype(jnp.int32))
            return img, overflow.reshape(1), totals[None][None]

        mapped = jax.shard_map(
            shard_body_measured, mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS)),
            check_vma=False)
        return jax.jit(mapped)

    def shard_body(attrs_t, uniforms_t):
        b = jax.lax.axis_index(AXIS)
        if interleave:
            ty_lo = b.astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (b * tile_h).astype(jnp.int32)])
            stride = n
        else:
            ty_lo = (b * band_tiles_y).astype(jnp.int32)
            origin = jnp.stack([jnp.int32(0),
                                (ty_lo * tile_h).astype(jnp.int32)])
            stride = 1
        img, overflow, totals = raster_sparse._fused_image_body(
            attrs_t, uniforms_t, plan, width, height, tile_h, tile_w,
            interpret, direct, ty_lo=ty_lo, nty_band=band_tiles_y,
            origin=origin, ty_stride=stride,
            geom_axis=(AXIS if geom_shard else None))
        return img, overflow.reshape(1), totals[None][None]

    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False)          # pallas outputs carry no vma metadata
    return jax.jit(mapped)


def render_frame_fused_image_sharded(mesh: Mesh, passes, width: int,
                                     height: int, tile_h: int | None = None,
                                     tile_w: int | None = None,
                                     strict_capacity: bool = True,
                                     interleave: bool = False,
                                     geom_shard: bool = True,
                                     direct: bool = False,
                                     bands: tuple | None = None):
    """Single-color-pass direct-to-image under the sharded fused
    pipeline (1-D row meshes): each device renders its band straight to
    packed image rows (raster_sparse._fused_image_body — no depth/
    winner tile planes, no 3-plane untile) and the concatenated rows
    ARE the frame.  Bitwise-identical to the single-device
    render_frame_fused_image (tested).  Capacity keys, seeding,
    refinement, and async staging are shared verbatim with
    render_frame_fused_sharded (the image path reports the won-tile
    sentinel, so it never consumes a shared key's w refinement).
    Returns ((H, W, 3) uint8 device array, per-band overflow bools)."""
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W

    if tile_h is None:
        tile_h = TILE_H
    if tile_w is None:
        tile_w = TILE_W
    if mesh.axis_names != (AXIS,):
        raise ValueError("render_frame_fused_image_sharded needs a 1-D "
                         "row mesh (make_mesh)")
    if len(passes) != 1:
        raise ValueError("render_frame_fused_image_sharded takes exactly "
                         "one pass")
    attrs, shader, uniforms, _exclude = passes[0]
    if not shader.writes_color:
        raise ValueError("render_frame_fused_image_sharded needs a color "
                         "shader")
    n = mesh.devices.size
    if bands is not None:
        if interleave:
            raise ValueError("bands is exclusive with interleave")
        _check_bands(bands, n, height, tile_h)
    elif height % (n * tile_h):
        raise ValueError(f"height {height} not divisible into {n} "
                         f"tile-aligned bands")
    if width % tile_w:
        raise ValueError(f"width {width} not tile-aligned")
    n_tiles_x = width // tile_w
    nty = height // tile_h
    band_cap = (_stable_band_cap(bands, nty, n)
                if bands is not None else None)
    band_tiles_y = band_cap if bands is not None else nty // n
    n_tiles_band = n_tiles_x * band_tiles_y
    n_tiles_full = n_tiles_x * nty
    interpret = device.interpret()

    f = attrs["position"].shape[0]
    if f == 0:
        raise ValueError("render_frame_fused_image_sharded requires a "
                         "non-empty pass")
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    uniforms = dict(uniforms)
    key = (f, n_tiles_x, nty, tile_h, tile_w, n, 1, "fused-sharded",
           ("measured", band_cap) if bands is not None else interleave)
    caps = _SHARD_FUSED_CAPS.get(key)
    if caps is None:
        caps = raster_sparse._resolve_caps(
            (f, n_tiles_x, nty), attrs, uniforms, shader,
            width, height, tile_h, tile_w, n_tiles_full)
        caps = _clamp_band_caps(caps, n_tiles_band)
        _SHARD_FUSED_CAPS[key] = caps
    elif not strict_capacity:
        _resolve_fused_pending(key, n_tiles_band)
        caps = _SHARD_FUSED_CAPS[key]
    plan = ((shader, caps, False, 0),)

    fn = _sharded_fused_image_fn(mesh, plan, width, height, tile_h,
                                 tile_w, interpret, interleave,
                                 geom_shard, direct, band_cap=band_cap)
    if bands is not None:
        lo_arr = jnp.asarray([lo for lo, _ in bands], jnp.int32)
        rows_arr = jnp.asarray([r for _, r in bands], jnp.int32)
        img, overflow, totals = fn((attrs,), (uniforms,), lo_arr, rows_arr)
    else:
        img, overflow, totals = fn((attrs,), (uniforms,))
    # totals: (n_bands, 1, 3)

    if strict_capacity:
        t_max = np.asarray(jax.device_get(totals)).max(axis=0)[0]
        if _fold_fused_totals(key, t_max, n_tiles_band):
            return render_frame_fused_image_sharded(
                mesh, passes, width, height, tile_h, tile_w,
                strict_capacity, interleave, geom_shard, direct, bands)
    else:
        st = raster_sparse._StagedTotals(totals, 0, axis=1)
        raster_sparse._stage_pending(_SHARD_FUSED_PENDING, key, st,
                                     _SHARD_FUSED_CAPS[key])
    if interleave:
        img = _deinterleave_rows(img, n, band_tiles_y, tile_h)
    elif bands is not None:
        img = img[_band_row_map_dev(bands, band_cap, tile_h, height)]
    return raster_sparse._unpack_rgb(img[:height, :width]), overflow


def _resolve_fused_pending(key, n_tiles_band):
    """Async capacity bookkeeping for the sharded fused path: fold a
    previous frame's per-band totals in once their D2H lands.  The first
    resolve REPLACES the (full-screen-seeded, oversized) caps with the
    quantized per-band maxima (recorded in _SHARD_FUSED_REFINED); later
    resolves only grow on overflow."""
    prev = _SHARD_FUSED_PENDING.get(key)
    if prev is None:
        return
    totals_dev, prev_caps, age = prev
    ready = getattr(totals_dev, "is_ready", lambda: True)()
    # never block on an un-landed D2H (see raster_sparse._resolve_pending)
    if ready:
        _SHARD_FUSED_PENDING.pop(key)
        t_max = np.asarray(totals_dev).max(axis=0)
        if _fold_fused_totals(key, t_max, n_tiles_band):
            import logging
            logging.getLogger(__name__).warning(
                "sharded fused overflow detected %d frame(s) late; "
                "capacity grown", age + 1)
    else:
        _SHARD_FUSED_PENDING[key] = (totals_dev, prev_caps, age + 1)


def _deinterleave_rows(x, n, band_nty, tile_h):
    """Device-major row blocks -> globally interleaved tile rows.

    With interleaved bands, device b's untiled block holds global tile
    rows b, b+n, b+2n, ...; the concatenated (H, W[, C]) array is
    therefore tile-row-interleaved device-major.  One reshape/moveaxis
    restores global row order — this runs OUTSIDE shard_map at the
    transfer boundary only, where XLA inserts the (unavoidable) row
    exchange; the render itself stays collective-free."""
    t = x.reshape((n, band_nty, tile_h) + x.shape[1:])
    return jnp.moveaxis(t, 0, 1).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _sharded_untile_fn(mesh: Mesh, width: int, height: int,
                       tile_h: int, tile_w: int,
                       interleave: bool = False,
                       band_cap: int | None = None):
    from tinyrenderder_tpu.ops import raster_sparse

    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n = mesh.devices.size
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    band_ntx = (width // tile_w) // n_cols
    band_nty = (band_cap if band_cap is not None
                else (height // tile_h) // (mesh.shape[AXIS_Y]
                                            if two_d else n))

    def shard_body(ft):
        def untile(x):
            return raster_sparse._from_tiles_nd(
                x, band_nty, band_ntx, tile_h, tile_w, band_nty * tile_h,
                band_ntx * tile_w)
        return FrameBuffers(
            color=raster_sparse._unpack_rgb(untile(ft.color)),
            depth=untile(ft.depth), winner=untile(ft.winner))

    # 2-D blocks: each shard untiles to (band_h, band_w[, 3]) and the
    # ('ty','tx') out-spec assembles the global (H, W) directly
    axes = (AXIS_Y, AXIS_X) if two_d else AXIS
    ft_spec = raster_sparse.FrameTiles(color=P(axes), depth=P(axes),
                                       winner=P(axes))
    fb_spec = FrameBuffers(color=P(*axes) if two_d else P(axes),
                           depth=P(*axes) if two_d else P(axes),
                           winner=P(*axes) if two_d else P(axes))
    mapped = jax.shard_map(shard_body, mesh=mesh, in_specs=(ft_spec,),
                           out_specs=fb_spec, check_vma=False)
    if band_cap is not None:
        # the row map arrives as a RUNTIME operand: the cache key stays
        # (mesh, shapes, band_cap), so repartitioning a scene re-traces
        # nothing here either

        def full_measured(ft, row_src):
            fb = mapped(ft)
            return FrameBuffers(color=fb.color[row_src],
                                depth=fb.depth[row_src],
                                winner=fb.winner[row_src])
        return jax.jit(full_measured)
    if not interleave:
        return jax.jit(mapped)

    def full(ft):
        fb = mapped(ft)
        return FrameBuffers(
            color=_deinterleave_rows(fb.color, n, band_nty, tile_h),
            depth=_deinterleave_rows(fb.depth, n, band_nty, tile_h),
            winner=_deinterleave_rows(fb.winner, n, band_nty, tile_h))
    return jax.jit(full)


def blocks_to_flat_tiles(x, width: int, height: int, n_rows: int,
                         n_cols: int, tile_h: int, tile_w: int):
    """Reorder a 2-D-block-sharded flat tile axis (device-major
    row-major blocks, as render_frame_fused_sharded returns on a
    ('ty','tx') mesh) into single-device global row-major tile order.
    Host-side numpy; used for comparisons/tests — the production
    transfer path goes through tiles_to_buffers_sharded, which needs no
    reorder."""
    x = np.asarray(x)
    ntx = width // tile_w
    nty = height // tile_h
    band_ty = nty // n_rows
    band_tx = ntx // n_cols
    t = np.arange(nty * ntx)
    ty, tx = t // ntx, t % ntx
    dev = (ty // band_ty) * n_cols + (tx // band_tx)
    local = (ty % band_ty) * band_tx + (tx % band_tx)
    return x[dev * (band_ty * band_tx) + local]


def tiles_to_buffers_sharded(mesh: Mesh, ft, width: int, height: int,
                             tile_h: int | None = None,
                             tile_w: int | None = None,
                             interleave: bool = False,
                             bands: tuple | None = None) -> FrameBuffers:
    """Per-band untile of a sharded FrameTiles: (H, W) buffers
    row-sharded over the mesh (no resharding, no collectives).  With
    ``interleave`` the bands are tile-row-interleaved (see
    render_frame_fused_sharded) and the final global row reorder happens
    here, at the transfer boundary; with ``bands`` (measured-load
    layout) the row map drops each device's dead padding rows the same
    way."""
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W
    if tile_h is None:
        tile_h = TILE_H
    if tile_w is None:
        tile_w = TILE_W
    if interleave and mesh.axis_names == (AXIS_Y, AXIS_X):
        raise ValueError("interleave is only supported on 1-D row meshes")
    if bands is not None:
        band_cap = _stable_band_cap(bands, height // tile_h,
                                    mesh.devices.size)
        fn = _sharded_untile_fn(mesh, width, height, tile_h, tile_w,
                                interleave, band_cap)
        return fn(ft, _band_row_map_dev(bands, band_cap, tile_h, height))
    fn = _sharded_untile_fn(mesh, width, height, tile_h, tile_w, interleave)
    return fn(ft)


@functools.lru_cache(maxsize=None)
def _sharded_untile_one_fn(mesh: Mesh, width: int, height: int,
                           tile_h: int, tile_w: int,
                           interleave: bool = False,
                           band_cap: int | None = None):
    from tinyrenderder_tpu.ops import raster_sparse

    two_d = mesh.axis_names == (AXIS_Y, AXIS_X)
    n = mesh.devices.size
    n_cols = mesh.shape[AXIS_X] if two_d else 1
    band_ntx = (width // tile_w) // n_cols
    band_nty = (band_cap if band_cap is not None
                else (height // tile_h) // (mesh.shape[AXIS_Y]
                                            if two_d else n))

    def shard_body(x):
        return raster_sparse._from_tiles_nd(
            x, band_nty, band_ntx, tile_h, tile_w, band_nty * tile_h,
            band_ntx * tile_w)

    in_spec = P((AXIS_Y, AXIS_X)) if two_d else P(AXIS)
    out_spec = P(AXIS_Y, AXIS_X) if two_d else P(AXIS)
    mapped = jax.shard_map(shard_body, mesh=mesh, in_specs=(in_spec,),
                           out_specs=out_spec, check_vma=False)
    if band_cap is not None:
        return jax.jit(lambda x, row_src: mapped(x)[row_src])
    if not interleave:
        return jax.jit(mapped)
    return jax.jit(lambda x: _deinterleave_rows(mapped(x), n, band_nty,
                                                tile_h))


def untile_one_sharded(mesh: Mesh, tiles, width: int, height: int,
                       tile_h: int | None = None, tile_w: int | None = None,
                       interleave: bool = False,
                       bands: tuple | None = None):
    """Single-plane sharded untile (e.g. the excluded-pass out_depth)."""
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W
    if tile_h is None:
        tile_h = TILE_H
    if tile_w is None:
        tile_w = TILE_W
    if interleave and mesh.axis_names == (AXIS_Y, AXIS_X):
        raise ValueError("interleave is only supported on 1-D row meshes")
    if bands is not None:
        band_cap = _stable_band_cap(bands, height // tile_h,
                                    mesh.devices.size)
        fn = _sharded_untile_one_fn(mesh, width, height, tile_h, tile_w,
                                    interleave, band_cap)
        return fn(tiles, _band_row_map_dev(bands, band_cap, tile_h,
                                           height))
    fn = _sharded_untile_one_fn(mesh, width, height, tile_h, tile_w,
                                interleave)
    return fn(tiles)


# ---------------------------------------------------------------------------
# Geometry parallelism on the PRODUCTION pipeline: faces sharded, each
# device runs the binned sparse path over the full frame, per-device
# results merge with pmin/psum collectives
# ---------------------------------------------------------------------------
#
# The collectives-based geometry axis of _geometry_pass_fn rides the
# O(F*H*W) scan kernel.  This section gives it the production engine:
# every device bins ITS contiguous face block through raster_sparse
# (active-tile compaction + the resolve kernel + compact phase-C
# shading), producing pass-local full-frame
# tile planes that merge exactly like _geometry_pass_fn's:
#
#   depth:  lax.pmin — the global strict-less winner z;
#   winner: min global id among devices achieving the merged z (ties
#           across devices = min id = first submitted, our_gl.cpp:165;
#           within a device the kernel's ordered merge already picked
#           the first);
#   color:  exactly-one-contributor lax.psum of the per-device shaded
#           packed colors.
#
# Bitwise-identical to the single-device tiles pipeline
# (tests/test_parallel.py::test_geometry_tiles_*).

_GEOM_TILES_BIG = 1 << 30


@functools.lru_cache(maxsize=None)
def _geometry_tiles_fn(mesh: Mesh, shader, width: int, height: int,
                       caps, f_shard: int, tile_h: int, tile_w: int,
                       interpret: bool):
    from tinyrenderder_tpu.ops import raster_pallas, raster_sparse
    from tinyrenderder_tpu.ops.raster_tiled import _cdiv
    from tinyrenderder_tpu.shaders import finalize_color

    n_tiles_x = _cdiv(width, tile_w)
    n_tiles_y = _cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    cap, a_cap = caps[:2]     # geometry merge shades its own way — no
                              # won-tile cap (pmin needs all candidates)
    spec = (tuple(shader.varying_spec.items())
            if shader.writes_color else ())
    n_vary = sum(c for _, c in spec)
    BIG = jnp.int32(_GEOM_TILES_BIG)

    def shard_body(ft, attrs_shard, uniforms, winner_offset):
        base = (jax.lax.axis_index(AXIS) * f_shard).astype(jnp.int32)
        (setup, records, ids, kernel_ids, sa, ca, total, na
         ) = raster_sparse._pre_sparse_jit(
            attrs_shard, uniforms, shader, width, height, cap, a_cap,
            tile_h, tile_w)
        inf_tiles = jnp.full((n_tiles, tile_h, tile_w), jnp.inf,
                             jnp.float32)
        d_c, w_c, v_c, _ = raster_pallas.resolve_tiles(
            kernel_ids, sa, ca, records, inf_tiles, n_tiles_x, tile_h,
            tile_w, n_vary, interpret)
        # pass-local full-frame planes (scatter-compact, drop padding)
        w_ci = w_c.astype(jnp.int32)
        d_full = inf_tiles.at[ids].set(d_c, mode="drop")
        w_full = (jnp.full((n_tiles, tile_h, tile_w), -1, jnp.int32)
                  .at[ids].set(w_ci, mode="drop"))
        # ---- collective merge (identical rule to _geometry_pass_fn) ----
        zmin = jax.lax.pmin(d_full, AXIS)
        better = zmin < ft.depth
        cand = jnp.where((w_full >= 0) & (d_full == zmin) & better,
                         w_full + base, BIG)
        gwin = jax.lax.pmin(cand, AXIS)
        drawn = better & (gwin < BIG)
        new_depth = jnp.where(better, zmin, ft.depth)
        new_winner = jnp.where(drawn, gwin + winner_offset, ft.winner)
        if shader.writes_color:
            vary = {}
            i = 0
            for name, c in spec:
                vary[name] = jnp.moveaxis(v_c[:, i:i + c], 1, -1)
                i += c
            rgb = shader.fragment(uniforms, vary, jnp)
            packed_c = raster_sparse._pack_rgb(finalize_color(rgb, jnp))
            c_full = (jnp.zeros((n_tiles, tile_h, tile_w), jnp.int32)
                      .at[ids].set(packed_c, mode="drop"))
            mine = drawn & (cand == gwin)
            col = jax.lax.psum(jnp.where(mine, c_full, 0), AXIS)
            new_color = jnp.where(drawn, col, ft.color)
        else:
            new_color = ft.color
        # shard-max demand totals (pair, active, w-sentinel): the caps
        # were seeded from a first-frame full-geometry probe, which is
        # an upper bound only for THAT frame's view — camera motion can
        # outgrow them, so the caller stages these for the same
        # one-frame-late growth every other capacity path gets
        totals = jax.lax.pmax(
            jnp.stack([total, na, jnp.int32(-1)]), AXIS)
        return raster_sparse.FrameTiles(color=new_color, depth=new_depth,
                                        winner=new_winner), totals

    ft_spec = P()                         # frame replicated on all devices
    from tinyrenderder_tpu.ops.raster_sparse import FrameTiles
    fspec = FrameTiles(color=ft_spec, depth=ft_spec, winner=ft_spec)
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(fspec, P(AXIS), P(), P()),
        out_specs=(fspec, P()),
        check_vma=False)
    return jax.jit(mapped)


def render_pass_geometry_tiles(mesh: Mesh, ft, attrs: dict, shader,
                               uniforms: dict, width: int, height: int,
                               winner_offset: int = 0,
                               tile_h: int | None = None,
                               tile_w: int | None = None):
    """One pass with TRIANGLES sharded over the mesh through the
    production binned pipeline (see _geometry_tiles_fn).  The
    tiled frame is replicated; face arrays pad to a device multiple
    with degenerate (w=0, auto-rejected) triangles so contiguous blocks
    preserve submission order.  Capacities seed from a full-geometry
    probe (an upper bound for every shard ON THAT FRAME); later frames'
    demand is staged through the shared coarse pending machinery, so
    growth under camera motion lands one frame late with a warning —
    the same contract as the single-device async paths."""
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.ops.raster_tiled import TILE_H, TILE_W, _cdiv

    if tile_h is None:
        tile_h = TILE_H
    if tile_w is None:
        tile_w = TILE_W
    n = mesh.devices.size
    f = attrs["position"].shape[0]
    if f == 0:
        return ft
    f_shard = -(-max(f, 1) // n)
    pad = f_shard * n - f
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    if pad:
        attrs = {k: jnp.concatenate(
            [v, jnp.zeros((pad,) + tuple(v.shape[1:]), v.dtype)], axis=0)
            for k, v in attrs.items()}
    uniforms = dict(uniforms)
    ntx, nty = _cdiv(width, tile_w), _cdiv(height, tile_h)
    n_tiles = ntx * nty
    key = (f_shard * n, ntx, nty, tile_h, tile_w)
    raster_sparse._resolve_pending(key, n_tiles)
    caps = raster_sparse._resolve_caps(
        key, attrs, uniforms, shader, width, height, tile_h, tile_w,
        n_tiles)
    interpret = device.interpret()
    fn = _geometry_tiles_fn(mesh, shader, width, height, caps, f_shard,
                            tile_h, tile_w, interpret)
    ft_out, totals_dev = fn(ft, attrs, uniforms, jnp.int32(winner_offset))
    raster_sparse._fold_or_stage_pending(raster_sparse._SPARSE_PENDING,
                                         key, totals_dev, caps)
    return ft_out


def render_frame_geometry_tiles(mesh: Mesh, passes, width: int,
                                height: int):
    """Multi-pass frame with production-pipeline geometry parallelism,
    incl. the z-snapshot semantics around excluded passes
    (main.cpp:700,730).  Returns (FrameTiles, output_depth_tiles)."""
    from tinyrenderder_tpu.ops import raster_sparse

    ft = raster_sparse.new_frame_tiles(width, height)
    offset = 0
    snapshot = None
    in_excluded = False
    for item in passes:
        attrs, shader, uniforms, *rest = item
        exclude = bool(rest[0]) if rest else False
        if exclude:
            if not in_excluded:
                snapshot = ft.depth
                in_excluded = True
        elif in_excluded:
            ft = raster_sparse.FrameTiles(color=ft.color, depth=snapshot,
                                          winner=ft.winner)
            in_excluded = False
        ft = render_pass_geometry_tiles(mesh, ft, attrs, shader, uniforms,
                                        width, height,
                                        winner_offset=offset)
        offset += attrs["position"].shape[0]
    out_depth = snapshot if in_excluded else ft.depth
    return ft, out_depth
