"""Two-pass hard shadow mapping.

The reference snapshot has no shadow pass (SURVEY.md scope fence), but the
tinyrenderer course it follows renders one: pass 1 rasterizes the scene's
depth from the light's viewpoint; pass 2 shades normally, gating the
lit terms by a depth comparison against that shadow map.

Device shape: the shadow map is just a depth-only frame render (the engine's
phase A with no shading), producing an (S, S) float32 array that pass 2's
``ShadowMappedShader`` samples with nearest gathers — the same machinery
as texture sampling.  Both passes run through any backend (oracle / xla /
tiled), so shadowed renders have a golden path too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.scene import RenderResult, Scene
from tinyrenderder_tpu.shaders import DepthShader, PhongShader, ShadowMappedShader

__all__ = ["light_camera_for_scene", "render_depth_from_light",
           "shadowed_scene", "render_with_shadows", "ShadowSettings"]


@dataclass
class ShadowSettings:
    size: int = 1024          # shadow map resolution (square)
    fov_margin: float = 1.3   # widen the light frustum beyond the scene
    distance_factor: float = 2.5


def light_camera_for_scene(scene: Scene, light_dir,
                           settings: ShadowSettings | None = None) -> Camera:
    """Place a camera looking down ``light_dir`` (direction light travels
    *from*, i.e. the shaders' to-light vector) framing the whole scene.
    Cached on the scene: the AABB sweep + frustum math is pure host work
    that repeats identically every frame of a static-light loop."""
    settings = settings or ShadowSettings()
    ckey = (tuple((id(p.mesh), p.model_matrix.tobytes())
                  for p in scene.passes),
            np.asarray(light_dir, np.float64).tobytes(),
            settings.size, settings.fov_margin, settings.distance_factor)
    cached = scene.__dict__.get("_shadow_light_cam")
    if cached is not None and cached[0] == ckey:
        return cached[1]
    boxes = scene.world_aabbs()
    lo = np.min([b.min for b in boxes], axis=0)
    hi = np.max([b.max for b in boxes], axis=0)
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - lo)) * 0.5
    radius = max(radius, 1e-3)
    d = math3d.normalized(np.asarray(light_dir, dtype=np.float64))
    dist = radius * settings.distance_factor

    cam = Camera()
    cam.set_eye(center + d * dist)
    cam.set_target(center)
    up = (0.0, 1.0, 0.0) if abs(d[1]) < 0.99 else (1.0, 0.0, 0.0)
    cam.set_up(np.asarray(up))
    fov = 2.0 * np.degrees(np.arctan2(radius, dist)) * settings.fov_margin
    cam.set_fov(float(np.clip(fov, 10.0, 120.0)))
    cam.set_aspect(1.0)
    # distance_factor <= 1.5 would put the near plane at or behind the
    # eye; clamp to a small positive near (valid perspective projection)
    cam.set_clipping(max(dist - radius * 1.5, radius * 1e-3),
                     dist + radius * 1.5)
    scene.__dict__["_shadow_light_cam"] = (ckey, cam)
    return cam


def invalidate_caches(scene: Scene) -> None:
    """Drop the per-scene shadow caches (light camera, merged mesh,
    depth scene).  Call after mutating a mesh's ``positions`` IN PLACE:
    the caches key on ``id(mesh)`` + model-matrix bytes, which cannot
    see an in-place geometry edit.  (Rebinding a fresh Mesh or changing
    a model matrix invalidates naturally.)"""
    for k in ("_shadow_light_cam", "_shadow_merged",
              "_shadow_depth_scene"):
        scene.__dict__.pop(k, None)


def _merged_world_mesh(scene: Scene):
    """All scene meshes merged into one, model matrices baked into the
    positions — the light's depth pass has no per-mesh state (DepthShader
    uses no lights/materials), so one pass replaces len(passes) passes.
    Cached on the scene keyed by the pass list and matrices (an IN-PLACE
    positions edit is invisible to this key — see invalidate_caches)."""
    from tinyrenderder_tpu.models.mesh import Mesh

    key = tuple((id(p.mesh), p.model_matrix.tobytes())
                for p in scene.passes)
    cached = scene.__dict__.get("_shadow_merged")
    if cached is not None and cached[0] == key:
        return cached[1]
    pos, fac = [], []
    offset = 0
    for p in scene.passes:
        m = p.model_matrix
        ph = p.mesh.positions @ m[:3, :3].T + m[:3, 3]
        w = (p.mesh.positions @ m[3:4, :3].T + m[3, 3]).reshape(-1, 1)
        pos.append(ph / w)                      # AABB-style w divide
        fac.append(p.mesh.faces + offset)
        offset += p.mesh.nverts
    merged = Mesh(positions=np.concatenate(pos),
                  faces=np.concatenate(fac), name="shadow_merged")
    scene.__dict__["_shadow_merged"] = (key, merged)
    return merged


def render_depth_from_light(scene: Scene, light_cam: Camera,
                            settings: ShadowSettings,
                            backend: str = "xla",
                            transfer: bool = True,
                            strict_capacity: bool = True) -> np.ndarray:
    """Pass 1: depth-only render of every mesh from the light's view.
    ``transfer=False`` keeps the shadow map on device (it is consumed as
    a pass-2 uniform, so a host round trip is pure overhead);
    ``strict_capacity=False`` skips the per-pass pair-count host sync."""
    merged = _merged_world_mesh(scene)
    ckey = (id(merged), id(light_cam), settings.size)
    cached = scene.__dict__.get("_shadow_depth_scene")
    if cached is not None and cached[0] == ckey:
        depth_scene = cached[1]
    else:
        depth_scene = Scene(camera=light_cam, width=settings.size,
                            height=settings.size)
        depth_scene.add(merged, np.eye(4), DepthShader(),
                        name="lightdepth")
        scene.__dict__["_shadow_depth_scene"] = (ckey, depth_scene)
    # collect_stats is always off: the depth pass returns only the map,
    # and exact stats would replay a SECOND full depth resolve of the
    # merged scene (plus per-pass host syncs) just to be discarded
    result = depth_scene.render(backend=backend, frustum_cull=False,
                                collect_stats=False, transfer=transfer,
                                strict_capacity=strict_capacity)
    if transfer:
        return np.asarray(result.full_depth, dtype=np.float32)
    return result.full_depth.astype("float32")


def shadowed_scene(scene: Scene, light_dir, shadow_map: np.ndarray,
                   light_cam: Camera, settings: ShadowSettings) -> Scene:
    """Pass 2 scene: every PhongShader pass swapped for a
    ShadowMappedShader carrying its model-space -> light-screen matrix.

    Cached on the source scene: the pass list, shader objects and
    shadow matrices are static across a static-light loop — only the
    shadow MAP changes per frame, and it flows through build_uniforms as
    data (the shader invariant), so a cache hit just swaps the map on
    the existing shaders.  Rebuilding scene + shader objects per frame
    cost several host-side ms and defeated the jit/uniform caches."""
    vp_l = math3d.viewport(0, 0, settings.size, settings.size)
    light_vp = vp_l @ light_cam.projection_matrix @ light_cam.view_matrix

    ckey = (tuple((id(p.mesh), p.model_matrix.tobytes(), id(p.shader))
                  for p in scene.passes),
            light_vp.tobytes(), id(scene.camera),
            scene.width, scene.height)
    cached = scene.__dict__.get("_shadow_lit_scene")
    if cached is not None and cached[0] == ckey:
        lit = cached[1]
        for p in lit.passes:
            if isinstance(p.shader, ShadowMappedShader):
                p.shader.shadow_map = shadow_map
        return lit

    out = Scene(camera=scene.camera, width=scene.width, height=scene.height)
    for p in scene.passes:
        sh = p.shader
        if isinstance(sh, PhongShader) and not isinstance(sh, ShadowMappedShader):
            shadow_matrix = light_vp @ p.model_matrix
            sh = ShadowMappedShader(
                sh.key_light_world, sh.fill_light_world, sh.rim_light_world,
                shadow_matrix=shadow_matrix, shadow_map=shadow_map,
                normal_map_strength=sh.normal_map_strength)
        out.add(p.mesh, p.model_matrix, sh, name=p.name,
                material_index=p.material_index,
                exclude_from_output_depth=p.exclude_from_output_depth)
    scene.__dict__["_shadow_lit_scene"] = (ckey, out)
    return out


import functools as _ft


def _shadow_fused_jit_factory():
    import jax

    from tinyrenderder_tpu.ops import raster_sparse as rs

    @_ft.partial(jax.jit, static_argnames=(
        "dplan", "plan", "size", "width", "height", "interpret",
        "smap_keys"))
    def _shadow_fused_jit(d_attrs, d_unis, attrs_t, unis_t, dplan, plan,
                          size, width, height, interpret, smap_keys):
        """Both shadow passes in ONE program: light-view depth resolve,
        single-plane untile, then the shaded passes consuming that map
        as a uniform — no host boundary between the passes."""
        ft_d, od_d, ovf_d, tot_d = rs._frame_fused_jit(
            (d_attrs,), (d_unis,), dplan, size, size,
            rs.TILE_H, rs.TILE_W, interpret)
        depth_hw = rs.untile_plane(od_d, size, size)
        new_unis = []
        for i, u in enumerate(unis_t):
            if i in smap_keys:
                u = dict(u)
                u["shadow_map"] = depth_hw
            new_unis.append(u)
        ft, od, ovf, tot = rs._frame_fused_jit(
            attrs_t, tuple(new_unis), plan, width, height,
            rs.TILE_H, rs.TILE_W, interpret)
        return ft, od, ovf_d | ovf, tot_d, tot, depth_hw

    return _shadow_fused_jit


_SHADOW_FUSED_JIT = None


def _render_with_shadows_fused(scene: Scene, light_dir, light_cam,
                               settings: ShadowSettings,
                               strict_capacity: bool, transfer: bool,
                               frustum_cull: bool = True):
    """Fast path: the whole two-pass shadow frame as one fused program.
    Only for the tiled backend without per-pass stats; capacity
    bookkeeping mirrors raster_sparse.render_frame_fused."""
    global _SHADOW_FUSED_JIT
    import jax
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import device
    from tinyrenderder_tpu.ops import raster_sparse as rs
    from tinyrenderder_tpu.scene import (_finish_device_tiles,
                                         _pass_inputs)
    from tinyrenderder_tpu.utils.stats import RenderStats

    if _SHADOW_FUSED_JIT is None:
        _SHADOW_FUSED_JIT = _shadow_fused_jit_factory()
    interpret = device.interpret()
    S = settings.size

    # light-view depth pass inputs (cached scene + merged mesh)
    merged = _merged_world_mesh(scene)
    ckey = (id(merged), id(light_cam), S)
    cached = scene.__dict__.get("_shadow_depth_scene")
    if cached is not None and cached[0] == ckey:
        depth_scene = cached[1]
    else:
        depth_scene = Scene(camera=light_cam, width=S, height=S)
        depth_scene.add(merged, np.eye(4), DepthShader(),
                        name="lightdepth")
        scene.__dict__["_shadow_depth_scene"] = (ckey, depth_scene)
    dp = depth_scene.passes[0]
    d_attrs, d_unis = _pass_inputs(depth_scene, dp, np.float32,
                                   device=True)

    # pass-2 scene with a placeholder map (replaced inside the jit)
    placeholder = scene.__dict__.get("_shadow_map_placeholder")
    if placeholder is None or placeholder.shape != (S, S):
        placeholder = jnp.zeros((S, S), jnp.float32)
        scene.__dict__["_shadow_map_placeholder"] = placeholder
    lit = shadowed_scene(scene, light_dir, placeholder, light_cam,
                         settings)
    # same per-model frustum culling as the non-fused path applies via
    # lit.render()
    from tinyrenderder_tpu.scene import _cull_passes
    visible = _cull_passes(lit, frustum_cull, RenderStats())
    if not visible:
        return None               # caller falls back to the general path
    p2 = []
    for p in visible:
        attrs, uniforms = _pass_inputs(lit, p, np.float32, device=True)
        p2.append((attrs, p.shader, uniforms,
                   p.exclude_from_output_depth))
    smap_keys = tuple(i for i, p in enumerate(visible)
                      if isinstance(p.shader, ShadowMappedShader))

    def _plan_for(passes, width, height):
        ntx = -(-width // rs.TILE_W)
        nty = -(-height // rs.TILE_H)
        n_tiles = ntx * nty
        plan, keys = [], []
        offset = 0
        for attrs, shader, uniforms, exclude in passes:
            f = attrs["position"].shape[0]
            uniforms = dict(uniforms)
            key = (f, ntx, nty, rs.TILE_H, rs.TILE_W)
            if not strict_capacity:
                rs._resolve_pending(key, n_tiles)
            caps = rs._resolve_caps(key, attrs, uniforms, shader, width,
                                    height, rs.TILE_H, rs.TILE_W, n_tiles)
            plan.append((shader, caps, bool(exclude), offset))
            keys.append((key, n_tiles))
            offset += f
        return tuple(plan), keys

    # retry until capacities fit: growth is monotone on a quantized
    # grid, so the loop terminates (strict mode's exactness promise — a
    # fixed attempt cap could silently return a degraded frame).  The
    # attempt counter only feeds a warning.
    _attempt = 0
    while True:
        _attempt += 1
        dplan, dkeys = _plan_for(
            [(d_attrs, dp.shader, d_unis, False)], S, S)
        plan, keys = _plan_for(p2, lit.width, lit.height)
        ft, od, ovf, tot_d, tot, depth_hw = _SHADOW_FUSED_JIT(
            d_attrs, d_unis,
            tuple(x[0] for x in p2), tuple(dict(x[2]) for x in p2),
            dplan, plan, S, lit.width, lit.height, interpret, smap_keys)

        def _book(keys, plans, totals):
            grown = False
            tot_host = (np.asarray(jax.device_get(totals))
                        if strict_capacity else None)
            staged: dict = {}
            for i, ((key, n_tiles), (sh, caps, *_)) in \
                    enumerate(zip(keys, plans)):
                if strict_capacity:
                    if not rs._caps_fit(caps, tot_host[i]):
                        rs._SPARSE_CAPACITY[key] = rs._grow_caps(
                            caps, tot_host[i], n_tiles)
                        rs._W_REFINED.add(key)
                        grown = True
                    else:
                        rs._won_refine_once(key, int(tot_host[i][2]),
                                            n_tiles)
                else:
                    # zero-dispatch staging (rs._StagedTotals): the row
                    # slice + same-key element-wise max fold both happen
                    # on the host copy at resolve time
                    prev = staged.get(key)
                    if prev is None:
                        staged[key] = (caps, rs._StagedTotals(totals, i))
                    else:
                        prev[1].merge_row(i)
            for key, (caps, st) in staged.items():
                rs._stage_pending(rs._SPARSE_PENDING, key, st, caps)
            return grown

        grown = _book(dkeys, list(dplan), tot_d)
        grown = _book(keys, list(plan), tot) or grown
        if not (strict_capacity and grown):
            break
        if _attempt >= 6:
            import logging
            logging.getLogger(__name__).warning(
                "fused shadow capacities still growing after %d "
                "attempts; continuing until they fit", _attempt)

    in_excluded = visible[-1].exclude_from_output_depth
    result = _finish_device_tiles(lit, ft, od, in_excluded, ovf,
                                  RenderStats(), {}, False, transfer)
    shadow_map = np.asarray(depth_hw) if transfer else depth_hw
    return result, shadow_map


def render_with_shadows(scene: Scene, light_dir,
                        settings: ShadowSettings | None = None,
                        backend: str = "xla", frustum_cull: bool = True,
                        collect_stats: bool = True, transfer: bool = True,
                        strict_capacity: bool = True,
                        ) -> tuple[RenderResult, np.ndarray]:
    """Full two-pass shadowed render.  Returns (result, shadow_map)."""
    settings = settings or ShadowSettings()
    light_cam = light_camera_for_scene(scene, light_dir, settings)
    if (backend == "tiled" and not collect_stats
            and all(p.mesh.nfaces > 0 for p in scene.passes)):
        fused = _render_with_shadows_fused(scene, light_dir, light_cam,
                                           settings, strict_capacity,
                                           transfer, frustum_cull)
        if fused is not None:     # None: every pass frustum-culled
            return fused
    shadow_map = render_depth_from_light(scene, light_cam, settings, backend,
                                         transfer=transfer,
                                         strict_capacity=strict_capacity)
    lit = shadowed_scene(scene, light_dir, shadow_map, light_cam, settings)
    result = lit.render(backend=backend, frustum_cull=frustum_cull,
                        collect_stats=collect_stats, transfer=transfer,
                        strict_capacity=strict_capacity)
    return result, shadow_map
