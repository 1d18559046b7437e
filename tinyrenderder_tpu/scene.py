"""Scene driver: passes, frustum culling, multi-backend rendering.

Capability-parity target: the main() scene flow of main.cpp:469-807 —
per-model frustum culling against the view-projection frustum
(main.cpp:623-624, :647, :680, :706), per-pass ModelView = view * model
matrix (main.cpp:653), per-pass shader uniforms, and the z-buffer
snapshot/restore around the eye pass (main.cpp:700, :730) which here is
just value-semantics on the FrameBuffers pytree.

Backends:
  "xla"    — ops.raster scan path (always available, parity reference)
  "tiled"  — the fused sparse pipeline (ops.raster_sparse: binning, the
             Pallas resolve kernel, compact phase-C shading) — production
  "oracle" — the serial NumPy golden renderer (tinyrenderder_tpu.oracle)
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu import math3d, oracle
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.math3d import Frustum
from tinyrenderder_tpu.models.mesh import Mesh
from tinyrenderder_tpu.shaders import Shader
from tinyrenderder_tpu.shaders import tokens_match as Shader_tokens_match
from tinyrenderder_tpu.utils.stats import RenderStats

log = logging.getLogger("tinyrenderder_tpu.scene")

__all__ = ["ScenePass", "Scene", "RenderResult", "render_scene"]


@dataclass
class ScenePass:
    """One model submission: mesh + model matrix + shader
    (a main.cpp:647-668-style block)."""

    mesh: Mesh
    model_matrix: np.ndarray
    shader: Shader
    name: str = ""
    material_index: int = 0
    #: passes flagged True are rendered into color but their depth writes are
    #: excluded from the frame's *output* depth (the reference's eye pass:
    #: zbuffer snapshot before, restore after, main.cpp:700,730 — SSAO then
    #: sees the no-eyes depth)
    exclude_from_output_depth: bool = False


@dataclass
class RenderResult:
    color: np.ndarray            # (H, W, 3) uint8 RGB
    depth: np.ndarray            # (H, W) float — output depth (post-restore)
    full_depth: np.ndarray       # (H, W) float — including excluded passes
    stats: RenderStats
    pass_timings: dict = field(default_factory=dict)
    #: device bool scalar (or None): True iff any pass of THIS frame
    #: dropped work to a capacity overflow (async capacity mode); part of
    #: the frame's own outputs, so checking it costs no extra round trip
    #: once the frame is synced
    overflowed: object = None


@dataclass
class Scene:
    """A renderable scene description (camera + passes)."""

    camera: Camera
    width: int
    height: int
    passes: list[ScenePass] = field(default_factory=list)

    def add(self, mesh: Mesh, model_matrix, shader: Shader, **kw) -> ScenePass:
        p = ScenePass(mesh=mesh, model_matrix=np.asarray(model_matrix, dtype=np.float64),
                      shader=shader, **kw)
        self.passes.append(p)
        return p

    def world_aabbs(self) -> list:
        return [p.mesh.get_world_aabb(p.model_matrix) for p in self.passes]

    def describe(self) -> str:
        """Scene-analysis text in the spirit of main.cpp:545-579."""
        lines = ["=== Scene Analysis ==="]
        for p in self.passes:
            c = p.mesh.get_center()
            wb = p.mesh.get_world_aabb(p.model_matrix)
            wc = wb.center()
            lines.append(f"  {p.name or p.mesh.name}: local center "
                         f"({c[0]:.4f}, {c[1]:.4f}, {c[2]:.4f}) world center "
                         f"({wc[0]:.4f}, {wc[1]:.4f}, {wc[2]:.4f}) "
                         f"faces {p.mesh.nfaces}")
        return "\n".join(lines)

    def render(self, backend: str = "xla", dtype=np.float32,
               frustum_cull: bool = True, collect_stats: bool = True,
               transfer: bool = True,
               strict_capacity: bool = True) -> RenderResult:
        return render_scene(self, backend=backend, dtype=dtype,
                            frustum_cull=frustum_cull,
                            collect_stats=collect_stats, transfer=transfer,
                            strict_capacity=strict_capacity)

    def render_image(self, backend: str = "tiled", dtype=np.float32,
                     frustum_cull: bool = True, transfer: bool = True,
                     strict_capacity: bool = True):
        return render_scene_image(self, backend=backend, dtype=dtype,
                                  frustum_cull=frustum_cull,
                                  transfer=transfer,
                                  strict_capacity=strict_capacity)


# one-entry frustum cache: plane extraction + normalization is ~0.1 ms
# of host Python per frame, and bench/animation loops either keep the
# camera fixed or change it every frame (either way one entry suffices)
_FRUSTUM_CACHE: tuple | None = None


def _frustum_cached(view_proj: np.ndarray) -> Frustum:
    global _FRUSTUM_CACHE
    key = view_proj.tobytes()
    hit = _FRUSTUM_CACHE
    if hit is not None and hit[0] == key:
        return hit[1]
    f = Frustum.from_matrix(view_proj)
    _FRUSTUM_CACHE = (key, f)
    return f


def _cull_passes(scene: Scene, frustum_cull: bool, stats: RenderStats):
    """Per-model frustum culling (main.cpp:623-736).

    The cull decision is cached on the scene (one entry): it depends
    only on the view-projection matrix and each pass's (mesh AABB,
    model matrix, face count), all of which hold still across steady-
    state render loops, while the 6-plane test costs ~0.2 host ms per
    frame on multi-pass scenes."""
    vp = scene.camera.projection_matrix @ scene.camera.view_matrix
    ckey = (vp.tobytes(), frustum_cull,
            tuple((id(p), id(p.mesh), p.mesh.nfaces,
                   id(p.mesh.get_local_aabb()),
                   p.model_matrix.tobytes()) for p in scene.passes))
    hit = scene.__dict__.get("_cull_cache")
    if hit is not None and hit[0] == ckey:
        visible, culled = hit[1], hit[2]
    else:
        frustum = _frustum_cached(vp)
        visible, culled = [], []
        for p in scene.passes:
            if frustum_cull and not frustum.intersects(
                    p.mesh.get_world_aabb(p.model_matrix)):
                culled.append(p)
                log.info("%s CULLED by frustum", p.name or p.mesh.name)
                continue
            visible.append(p)
        scene.__dict__["_cull_cache"] = (ckey, visible, culled)
    for p in culled:
        stats.models_culled += 1
        stats.culled_triangles += p.mesh.nfaces
    for p in visible:
        stats.models_rendered += 1
        stats.total_triangles += p.mesh.nfaces
    return visible


def _ref_tuples_match(a, b) -> bool:
    """Element-wise ``is`` comparison of two same-arity tuples (or two
    Nones) — identity keys with keep-alive semantics (the cached tuple
    pins every element, so id recycling cannot alias)."""
    if a is None or b is None:
        return a is b
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _pass_inputs(scene: Scene, p: ScenePass, dtype, device: bool = False):
    view = scene.camera.view_matrix
    persp = scene.camera.projection_matrix
    modelview = view @ p.model_matrix
    material = (p.mesh.materials[p.material_index]
                if p.mesh.materials else None)
    if device:
        # One-entry per-pass cache of the finished device uniforms dict:
        # build_uniforms + the device-cache sweep cost a few tenths of a
        # host ms per pass per frame, all of it identical across frames
        # whenever the camera holds still (every steady-state bench
        # config).  Keyed on everything build_uniforms reads: matrices
        # by value, material/large arrays by kept-alive reference (the
        # shader token, shaders.Shader.uniforms_token; the material
        # token pins each texture array so rebinding m.diffuse etc. is
        # a cache miss).  Downstream never mutates the dict in place
        # (render_frame_fused and the shadow driver copy before
        # editing), so sharing it is safe.
        token = p.shader.uniforms_token()
        mtok = (None if material is None else
                (material, material.diffuse, material.normal,
                 material.specular, material.emission))
        key = (modelview.tobytes(), persp.tobytes(),
               np.dtype(dtype).str)
        hit = p.__dict__.get("_device_inputs_cache")
        if (hit is not None and hit[0] == key
                and _ref_tuples_match(hit[1], mtok)
                and hit[2] is p.shader
                and Shader_tokens_match(hit[3], token)):
            return p.mesh.device_face_attributes(dtype), hit[4]
        uniforms = p.shader.build_uniforms(modelview, persp, material, dtype)
        # big arrays through the keyed device cache; small ones (matrices,
        # light dirs) uploaded here once — the dict persists across frames,
        # so every dispatch passes ready device arrays (no per-frame H2D
        # copies)
        import jax.numpy as jnp
        uniforms = {k: (_to_device_cached(v) if (isinstance(v, np.ndarray)
                                                 and v.size >= 4096)
                        else jnp.asarray(v) if isinstance(v, np.ndarray)
                        else v)
                    for k, v in uniforms.items()}
        p.__dict__["_device_inputs_cache"] = (key, mtok, p.shader, token,
                                              uniforms)
        return p.mesh.device_face_attributes(dtype), uniforms
    uniforms = p.shader.build_uniforms(modelview, persp, material, dtype)
    return p.mesh.face_attributes(dtype), uniforms


# device copies of big immutable uniforms (textures, shadow maps), keyed
# by the host array's identity — re-uploading ~1 MB of textures per pass
# per frame would dominate animation loops
_DEVICE_UNIFORM_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_DEVICE_UNIFORM_CACHE_BYTES = 256 << 20   # HBM+host bound for cached uniforms


def _sync(x):
    """Completion barrier for the per-pass timings of stats mode."""
    import jax
    return jax.block_until_ready(x)


def _to_device_cached(v):
    """LRU device cache for large uniforms (textures, shadow maps).

    LRU (hits refresh recency), bounded by total BYTES: one-shot arrays
    like per-frame shadow maps age out quickly instead of (a) pinning
    up to 256 dead device buffers and (b) FIFO-evicting the long-lived
    textures the cache exists for."""
    if not isinstance(v, np.ndarray) or v.size < 4096:
        return v
    hit = _DEVICE_UNIFORM_CACHE.get(id(v))
    if hit is not None and hit[0] is v:
        _DEVICE_UNIFORM_CACHE.move_to_end(id(v))
    else:
        import jax.numpy as jnp
        dev = jnp.asarray(v)
        _DEVICE_UNIFORM_CACHE[id(v)] = (v, dev)  # keep v alive: id stays valid
        hit = (v, dev)
        total = sum(e[0].nbytes for e in _DEVICE_UNIFORM_CACHE.values())
        while total > _DEVICE_UNIFORM_CACHE_BYTES and len(
                _DEVICE_UNIFORM_CACHE) > 1:
            _, (old_v, _) = _DEVICE_UNIFORM_CACHE.popitem(last=False)
            total -= old_v.nbytes
    return hit[1]


def render_scene(scene: Scene, backend: str = "xla", dtype=np.float32,
                 frustum_cull: bool = True, collect_stats: bool = True,
                 transfer: bool = True,
                 strict_capacity: bool = True) -> RenderResult:
    """``collect_stats=False`` skips per-pass stats/timing host syncs;
    ``transfer=False`` leaves the result buffers on device.  Use both for
    animation/benchmark inner loops."""
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)
    timings: dict[str, float] = {}

    if backend == "oracle":
        return _render_oracle(scene, visible, dtype, stats, timings)
    if backend in ("xla", "tiled"):
        return _render_device(scene, visible, dtype, stats, timings, backend,
                              collect_stats, transfer, strict_capacity)
    if backend == "sharded":
        return _render_sharded(scene, visible, dtype, stats, timings,
                               transfer, collect_stats,
                               strict_capacity=strict_capacity)
    if backend == "sharded-2d":
        return _render_sharded(scene, visible, dtype, stats, timings,
                               transfer, collect_stats,
                               strict_capacity=strict_capacity, two_d=True)
    if backend == "sharded-geometry":
        return _render_sharded(scene, visible, dtype, stats, timings,
                               transfer, collect_stats, geometry=True,
                               strict_capacity=strict_capacity)
    if backend == "sharded-measured":
        return _render_sharded(scene, visible, dtype, stats, timings,
                               transfer, collect_stats,
                               strict_capacity=strict_capacity,
                               measured=True)
    raise ValueError(f"unknown backend: {backend}")


def render_scene_image(scene: Scene, backend: str = "tiled",
                       dtype=np.float32, frustum_cull: bool = True,
                       transfer: bool = True,
                       strict_capacity: bool = True):
    """Render a frame whose ONLY deliverable is the (H, W, 3) uint8
    color image — the reference's per-frame framebuffer write
    (main.cpp:786; the z-buffer is an internal there too).

    Single-color-pass frames route through the direct-to-image fused
    pipeline (ops.raster_sparse.render_frame_fused_image: no depth/
    winner tile planes, one windowed placement instead of the tile
    scatter + 3-plane untile) on the tiled backend, and through
    dist.render_frame_fused_image_sharded on the sharded backend.
    Any other scene shape or backend falls back to the full render and
    returns its color — the colors are bitwise-identical either way
    (tested), so callers never need to know which route ran.

    ``transfer=False`` leaves the image on device (benchmark/animation
    inner loops).  Returns the image only; use ``render()`` when depth,
    stats, or the overflow flag are part of the deliverable."""
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)

    single_color = (len(visible) == 1
                    and visible[0].mesh.nfaces > 0
                    and visible[0].shader.writes_color
                    and not visible[0].exclude_from_output_depth)
    if single_color and backend in ("tiled", "sharded"):
        from tinyrenderder_tpu.ops import raster_sparse, raster_tiled

        attrs, uniforms = _pass_inputs(scene, visible[0], dtype,
                                       device=True)
        passes = [(attrs, visible[0].shader, uniforms, False)]
        if backend == "tiled":
            image, _overflow = raster_sparse.render_frame_fused_image(
                passes, scene.width, scene.height,
                strict_capacity=strict_capacity)
            return np.asarray(image) if transfer else image
        if backend == "sharded":
            from tinyrenderder_tpu.parallel import dist
            mesh = dist.make_mesh()
            n_dev = mesh.devices.size
            if (scene.height % raster_tiled.TILE_H == 0
                    and scene.width % raster_tiled.TILE_W == 0):
                # rows not divisible by the device count: near-even
                # unequal bands keep the fused image path with zero
                # measurement syncs (same auto-route as _render_sharded)
                bands = (dist.even_unequal_bands(
                            scene.height // raster_tiled.TILE_H, n_dev)
                         if n_dev > 1 and scene.height
                         % (n_dev * raster_tiled.TILE_H) else None)
                inter = (SHARDED_INTERLEAVE and n_dev > 1
                         and bands is None)
                image, _overflow = dist.render_frame_fused_image_sharded(
                    mesh, passes, scene.width, scene.height,
                    strict_capacity=strict_capacity, interleave=inter,
                    bands=bands)
                return np.asarray(image) if transfer else image

    result = render_scene(scene, backend=backend, dtype=dtype,
                          frustum_cull=frustum_cull, collect_stats=False,
                          transfer=transfer,
                          strict_capacity=strict_capacity)
    return result.color


def _pick_grid(n_dev: int, width: int, height: int, th: int, tw: int):
    """Most-square (n_rows, n_cols) factorization of ``n_dev`` whose
    blocks tile-align with the frame, or None."""
    best = None
    for n_cols in range(1, n_dev + 1):
        if n_dev % n_cols:
            continue
        n_rows = n_dev // n_cols
        if height % (n_rows * th) or width % (n_cols * tw):
            continue
        score = abs(n_rows - n_cols)
        if best is None or score < best[0]:
            best = (score, n_rows, n_cols)
    return None if best is None else best[1:]


def _render_sharded(scene, visible, dtype, stats, timings,
                    transfer=True, collect_stats=True,
                    geometry=False, strict_capacity=True,
                    two_d=False, measured=False) -> RenderResult:
    """Framebuffer row-sharded across every available device (the
    multi-chip production path; on one device it degenerates to tiled).
    ``geometry=True`` shards triangles instead of pixels and merges with
    pmin/psum collectives (backend "sharded-geometry" — the high-poly/
    small-frame scaling axis).  ``two_d=True`` (backend "sharded-2d")
    shards the frame in BOTH screen axes over the most-square
    tile-aligned ('ty','tx') grid — same fused production pipeline,
    2-D block per device; falls back to row bands when no 2-D grid
    divides the frame.  ``measured=True`` (backend "sharded-measured")
    splits the rows into MEASURED-LOAD contiguous bands (unequal
    heights from the measured per-tile-row pair cost, cached per scene
    state — dist.balance_bands) instead of interleaving; for scenes
    where stride aliasing leaves the interleaved layout imbalanced
    (the stress/mixed streams measure interleave 1.35 vs measured 1.08
    max/mean, scripts/band_balance.py).

    Same semantics as the single-device backends, including the
    z-snapshot/restore around exclude_from_output_depth passes
    (main.cpp:700,730) — asserted sharded-vs-xla by tests/test_parallel.py.
    """
    import jax

    from tinyrenderder_tpu.ops import raster_tiled
    from tinyrenderder_tpu.parallel import dist

    mesh = dist.make_mesh()
    n_dev = mesh.devices.size
    if two_d and not geometry:
        grid = _pick_grid(n_dev, scene.width, scene.height,
                          raster_tiled.TILE_H, raster_tiled.TILE_W)
        if grid is not None and grid[1] > 1:
            mesh = dist.make_mesh_grid(*grid)
    passes = []
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype, device=True)
        passes.append((attrs, p.shader, uniforms, p.exclude_from_output_depth))
    two_d_mesh = mesh.axis_names != (dist.AXIS,)
    overflowed = None          # non-fused branches have no device flag
    fused_ok = (not geometry and passes
                and all(a["position"].shape[0] > 0 for a, *_ in passes)
                and (two_d_mesh  # grid choice already proved divisibility
                     # 1-D: tile-aligned is enough — when the rows don't
                     # divide by n_dev, measured unequal bands carry it
                     or (scene.height % raster_tiled.TILE_H == 0
                         and scene.width % raster_tiled.TILE_W == 0)))
    t0 = time.perf_counter()
    if not passes:
        # every pass frustum-culled (or an empty scene): background frame,
        # like the single-device backends — the geometry branch would
        # otherwise index visible[-1]
        from tinyrenderder_tpu.ops import raster
        fb = raster.new_framebuffers(scene.width, scene.height)
        out_depth = fb.depth
    elif geometry:
        if (scene.width % raster_tiled.TILE_W == 0
                and scene.height % raster_tiled.TILE_H == 0
                and all(a["position"].shape[0] > 0 for a, *_ in passes)):
            # production path: faces sharded through the binned/Pallas
            # pipeline, pmin/psum merge on tiles
            ft, out_depth_t = dist.render_frame_geometry_tiles(
                mesh, passes, scene.width, scene.height)
            from tinyrenderder_tpu.ops import raster_sparse
            fb = raster_sparse.tiles_to_buffers(ft, scene.width,
                                                scene.height)
            in_excluded = visible[-1].exclude_from_output_depth
            if in_excluded:
                out_depth = raster_sparse.untile_plane(
                    out_depth_t, scene.width, scene.height)
            else:
                out_depth = fb.depth
        else:
            fb, out_depth = dist.render_frame_geometry_sharded(
                mesh, passes, scene.width, scene.height)
    elif fused_ok:
        # PRODUCTION path: the fused sparse pipeline itself under
        # shard_map row bands (the fast path and the scaled path are
        # the same path).  Bands are INTERLEAVED (device b owns
        # tile rows b, b+N, ...) so coverage hot spots — contiguous in y
        # on real scenes — split evenly across devices; on one device
        # this is the identity layout.
        # unequal bands when asked for (backend "sharded-measured":
        # MEASURED partition, async-refreshed) OR when the frame's tile
        # rows don't divide by the device count — there the even/
        # interleaved layouts are illegal and the only alternative used
        # to be the slow non-fused fallback (the stress/mixed bench
        # frames: 800 px = 50 tile rows over 4 devices).  The
        # auto-route uses the measurement-FREE near-even partition
        # (the measured cache would block a camera-animated loop on a
        # device fetch per frame).
        needs_bands = (not two_d_mesh and n_dev > 1
                       and scene.height % (n_dev * raster_tiled.TILE_H))
        if measured and n_dev > 1:
            bands = _measured_bands_cached(scene, passes, n_dev)
        elif needs_bands:
            bands = dist.even_unequal_bands(
                scene.height // raster_tiled.TILE_H, n_dev)
        else:
            bands = None
        inter = (SHARDED_INTERLEAVE and n_dev > 1 and not two_d_mesh
                 and bands is None)
        ft, out_depth_t, overflow_b = dist.render_frame_fused_sharded(
            mesh, passes, scene.width, scene.height,
            strict_capacity=strict_capacity, interleave=inter,
            bands=bands)
        # same-frame device overflow flag (any band), like the
        # single-device tiles path — part of the frame's own outputs
        import jax.numpy as jnp
        overflowed = jnp.any(overflow_b)
        fb = dist.tiles_to_buffers_sharded(mesh, ft, scene.width,
                                           scene.height, interleave=inter,
                                           bands=bands)
        in_excluded = visible[-1].exclude_from_output_depth
        out_depth = (dist.untile_one_sharded(mesh, out_depth_t,
                                             scene.width, scene.height,
                                             interleave=inter, bands=bands)
                     if in_excluded else fb.depth)
    else:
        fb, out_depth = dist.render_frame_sharded(
            mesh, passes, scene.width, scene.height,
            return_output_depth=True)
    if collect_stats:
        _sync(fb.color)
        timings["frame"] = time.perf_counter() - t0
    if transfer:
        color = np.asarray(fb.color)
        depth = np.asarray(out_depth)
        full_depth = np.asarray(fb.depth)
    else:
        color, depth, full_depth = fb.color, out_depth, fb.depth
    if collect_stats:
        _accumulate_exact_events(scene, passes, visible, stats)
    return RenderResult(color=color, depth=depth, full_depth=full_depth,
                        stats=stats, pass_timings=timings,
                        overflowed=overflowed)


def _measured_bands_cached(scene, passes, n_dev):
    """Per-scene cache of the measured-load band partition (backend
    "sharded-measured") with the async-capacity idiom: the FIRST frame
    of a scene blocks once for the measurement; when the scene state
    changes afterwards (camera or model motion — the key holds each
    pass's kept-alive attrs AND uniforms dict identities, which the
    per-pass input cache rebuilds whenever any matrix or material
    changes), the re-measurement's D2H is started async and resolved on
    a LATER frame, with the previous partition serving in the meantime.
    Balance refreshes a few frames late; correctness never depends on
    the partition (any legal bands are bitwise-identical)."""
    import numpy as _np

    from tinyrenderder_tpu.parallel import dist
    refs = tuple(x for a, _s, u, *_ in passes
                 for x in (a["position"], u))
    shape = (scene.width, scene.height, n_dev)
    cache = scene.__dict__.setdefault("_band_cache", {})
    if cache.get("shape") != shape:
        # first use OR a structural change (frame size / device count):
        # stale bands would be ILLEGAL for the new shape, so this case
        # blocks for one measurement — it is a re-setup, not a frame
        costs = dist.measure_tile_row_costs(passes, scene.width,
                                            scene.height)
        cache.update(shape=shape, refs=refs, pending=None,
                     bands=dist.balance_bands(costs, n_dev))
        return cache["bands"]
    pending = cache.get("pending")
    if pending is not None and getattr(pending, "is_ready",
                                       lambda: True)():
        costs = _np.asarray(pending).astype(_np.int64)
        cache.update(pending=None,
                     bands=dist.balance_bands(costs, n_dev))
        pending = None
    if pending is None and not _ref_tuples_match(cache.get("refs"), refs):
        # scene state moved (camera/model — new pass-input identities):
        # start ONE async re-measure and keep serving the previous
        # partition until its D2H lands (never block per frame, never
        # relaunch over an in-flight measurement).  NOTE: under the
        # stable capacity key a rebalance can under-provision a band's
        # refined caps for one async-mode frame — the same one-frame-
        # late overflow contract as every other capacity change (the
        # frame flags overflow; animation re-renders it strict).
        dev = dist.measure_tile_row_costs_device(passes, scene.width,
                                                 scene.height)
        if hasattr(dev, "copy_to_host_async"):
            dev.copy_to_host_async()
        cache.update(refs=refs, pending=dev)
    return cache["bands"]


def _accumulate_exact_events(scene, passes, visible, stats):
    """EXACT reference counters (our_gl.cpp:194-200 semantics, overdraw
    included) for backends whose frame program doesn't emit event
    planes: replay the passes through the replicated events scan
    (raster.pass_events_xla), including the excluded-pass z-snapshot
    semantics.  Stats mode only — the scan is a second depth resolve."""
    import jax
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster, raster_tiled

    w, h = scene.width, scene.height
    depth_ev = jnp.full((h, w), jnp.inf, jnp.float32)
    snapshot = None
    in_excluded = False
    for (attrs, shader, uniforms, exclude), p in zip(passes, visible):
        if exclude:
            if not in_excluded:
                snapshot = depth_ev                  # main.cpp:700
                in_excluded = True
        elif in_excluded:
            depth_ev = snapshot                      # main.cpp:730
            in_excluded = False
        setup, _ = raster_tiled._vertex_setup_jit(
            attrs, dict(uniforms), shader, w, h)
        depth_ev, _, frags, mn, mx = raster.pass_events_xla(
            setup, depth_ev, h, w)
        frags, mn, mx = (float(x) for x in jax.device_get((frags, mn, mx)))
        stats.fragments_drawn += int(frags)
        if np.isfinite(mn):
            stats.merge_z(mn, mx)
        agg = raster.pass_stats(setup)
        stats.triangles_rasterized += agg["triangles"]
        if agg["valid_triangles"]:
            stats.merge_bbox(agg["min_x"], agg["min_y"],
                             agg["max_x"], agg["max_y"])
    stats.fragments_exact = True


def _render_oracle(scene, visible, dtype, stats, timings) -> RenderResult:
    frame = oracle.OracleFrame(
        color=np.zeros((scene.height, scene.width, 3), dtype=np.uint8),
        zbuffer=np.full((scene.height, scene.width), np.inf, dtype=dtype),
        stats=stats)
    snapshot = None
    in_excluded = False
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype)
        if p.exclude_from_output_depth:
            if not in_excluded:
                snapshot = frame.zbuffer.copy()     # main.cpp:700
                in_excluded = True
        elif in_excluded:
            # main.cpp:730: restore before any later pass renders, so its
            # depth writes land in the snapshot-restored buffer
            frame.zbuffer = snapshot.copy()
            in_excluded = False
        t0 = time.perf_counter()
        oracle.render_pass(frame, oracle.OraclePass(attrs, p.shader, uniforms),
                           scene.width, scene.height, dtype=dtype)
        timings[p.name or p.mesh.name] = time.perf_counter() - t0
    full_depth = frame.zbuffer
    out_depth = snapshot if in_excluded else full_depth
    return RenderResult(color=frame.color, depth=out_depth,
                        full_depth=full_depth, stats=stats,
                        pass_timings=timings)


#: the sharded fused backend uses interleaved row bands (device b owns
#: tile rows b, b+N, ...) for coverage balance; set False to force the
#: contiguous-band layout (same pixels, different device assignment —
#: both bitwise-identical to the single-device frame)
SHARDED_INTERLEAVE = True


def _render_device_tiles(scene, visible, dtype, stats, timings,
                         collect_stats, transfer,
                         strict_capacity) -> RenderResult:
    """Production frame loop: the framebuffers stay in tiled layout
    across every pass (ops.raster_sparse); the single (H, W) untile is
    the transfer boundary."""
    import jax
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster, raster_sparse

    width, height = scene.width, scene.height
    th = raster_sparse.TILE_H

    if not collect_stats and visible and all(
            p.mesh.nfaces > 0 for p in visible):
        # fast path: the whole multi-pass frame in one fused dispatch
        passes_l = []
        for p in visible:
            attrs, uniforms = _pass_inputs(scene, p, dtype, device=True)
            passes_l.append((attrs, p.shader, uniforms,
                             p.exclude_from_output_depth))
        ft, out_depth_t, overflow = raster_sparse.render_frame_fused(
            passes_l, width, height, tile_h=th,
            strict_capacity=strict_capacity)
        in_excluded = visible[-1].exclude_from_output_depth
        return _finish_device_tiles(scene, ft, out_depth_t, in_excluded,
                                    overflow, stats, timings,
                                    collect_stats, transfer, tile_h=th)

    ft = raster_sparse.new_frame_tiles(width, height, tile_h=th)
    snapshot = None
    in_excluded = False
    winner_offset = 0
    overflow = jnp.asarray(False)
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype, device=True)
        if p.exclude_from_output_depth:
            if not in_excluded:
                snapshot = ft.depth                 # main.cpp:700
                in_excluded = True
        elif in_excluded:
            ft = raster_sparse.FrameTiles(          # main.cpp:730
                color=ft.color, depth=snapshot, winner=ft.winner)
            in_excluded = False
        t0 = time.perf_counter()
        out = raster_sparse.render_pass_tiles(
            ft, attrs, p.shader, uniforms, width, height,
            winner_offset=winner_offset, strict_capacity=strict_capacity,
            collect_stats=collect_stats, tile_h=th)
        ft, setup, ovf = out[:3]
        overflow = overflow | ovf
        if collect_stats:
            _sync(ft.color)
            timings[p.name or p.mesh.name] = time.perf_counter() - t0
            agg = raster.pass_stats(setup)
            stats.triangles_rasterized += agg["triangles"]
            if agg["valid_triangles"]:
                stats.merge_bbox(agg["min_x"], agg["min_y"],
                                 agg["max_x"], agg["max_y"])
            # exact z-pass event counters from the kernel
            # (our_gl.cpp:194-200 semantics, overdraw included)
            frags, min_z, max_z = (float(x) for x in
                                   jax.device_get(out[3]))
            stats.fragments_drawn += int(frags)
            if np.isfinite(min_z):
                stats.merge_z(min_z, max_z)
        winner_offset += p.mesh.nfaces

    out_depth_t = snapshot if in_excluded else ft.depth
    return _finish_device_tiles(scene, ft, out_depth_t, in_excluded,
                                overflow, stats, timings, collect_stats,
                                transfer, tile_h=th)


def _finish_device_tiles(scene, ft, out_depth_t, in_excluded, overflow,
                         stats, timings, collect_stats,
                         transfer, tile_h=None) -> RenderResult:
    import jax

    from tinyrenderder_tpu.ops import raster_sparse

    width, height = scene.width, scene.height
    if tile_h is None:
        tile_h = raster_sparse.TILE_H
    fb = raster_sparse.tiles_to_buffers(ft, width, height, tile_h=tile_h)
    if in_excluded:
        out_depth_hw = raster_sparse.untile_plane(out_depth_t, width,
                                                  height, tile_h=tile_h)
    else:
        out_depth_hw = fb.depth
    if transfer:
        color = np.asarray(fb.color)
        full_depth = np.asarray(fb.depth)
        out_depth = (np.asarray(out_depth_hw)
                     if in_excluded else full_depth)
    else:
        color, full_depth, out_depth = fb.color, fb.depth, out_depth_hw
    if collect_stats:
        # fragments_drawn and the z-range were accumulated per pass from
        # the kernel's exact event counters; nothing to approximate here
        stats.fragments_exact = True
        if bool(jax.device_get(overflow)):
            log.warning("frame dropped work to a capacity overflow "
                        "(async mode); capacity grows next frame")
    return RenderResult(color=color, depth=out_depth,
                        full_depth=full_depth, stats=stats,
                        pass_timings=timings, overflowed=overflow)


def _render_device(scene, visible, dtype, stats, timings, backend,
                   collect_stats=True, transfer=True,
                   strict_capacity=True) -> RenderResult:
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster

    if backend == "tiled":
        return _render_device_tiles(scene, visible, dtype, stats, timings,
                                    collect_stats, transfer, strict_capacity)
    pass_fn = raster.render_pass_xla

    fb = raster.new_framebuffers(scene.width, scene.height, dtype=jnp.float32)
    snapshot_depth = None
    in_excluded = False
    winner_offset = 0
    passes_seen = []
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype, device=True)
        passes_seen.append((attrs, p.shader, uniforms,
                            p.exclude_from_output_depth))
        if p.exclude_from_output_depth:
            if not in_excluded:
                snapshot_depth = fb.depth           # immutable: free snapshot
                in_excluded = True
        elif in_excluded:
            # main.cpp:730: restore before any later pass renders
            fb = raster.FrameBuffers(color=fb.color, depth=snapshot_depth,
                                     winner=fb.winner)
            in_excluded = False
        t0 = time.perf_counter()
        fb, setup = pass_fn(fb, attrs, p.shader, uniforms,
                            winner_offset=winner_offset)
        if collect_stats:
            _sync(fb.color)
            timings[p.name or p.mesh.name] = time.perf_counter() - t0
        winner_offset += p.mesh.nfaces

    if transfer:
        full_depth = np.asarray(fb.depth)
        out_depth = (np.asarray(snapshot_depth)
                     if in_excluded else full_depth)
        color = np.asarray(fb.color)
    else:
        full_depth = fb.depth
        out_depth = snapshot_depth if in_excluded else full_depth
        color = fb.color
    if collect_stats:
        # exact z-pass event counters (overdraw-inclusive), same
        # semantics as the tiled backend's kernel event planes
        _accumulate_exact_events(scene, passes_seen, visible, stats)
    return RenderResult(color=color, depth=out_depth,
                        full_depth=full_depth, stats=stats,
                        pass_timings=timings)
