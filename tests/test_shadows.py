"""Two-pass hard shadow mapping (benchmark config #4)."""

import numpy as np
import pytest

from tinyrenderder_tpu import math3d, shadows
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.scene import Scene
from tinyrenderder_tpu.shaders import PhongShader, ShadowMappedShader

KEY = math3d.normalized(math3d.vec3(0.6, 1.2, 0.8))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


def _blocker_scene(w=96, h=72) -> Scene:
    """Sphere hovering over a ground plane, light from above: the sphere
    must cast a shadow onto the plane."""
    sphere = procedural.uv_sphere(10, 14, radius=0.5)
    sphere.materials = [procedural.default_head_material(16)]
    ground = procedural.plane(6.0, y=-1.0)
    ground.materials = [procedural.default_head_material(16)]

    cam = Camera()
    cam.set_eye(math3d.vec3(0.0, 1.2, 3.2))
    cam.set_target(math3d.vec3(0.0, -0.3, 0.0))
    cam.set_fov(55.0)
    cam.set_aspect(w / h)
    cam.set_clipping(0.1, 50.0)

    scene = Scene(camera=cam, width=w, height=h)
    shader = PhongShader(KEY, FILL, RIM, normal_map_strength=0.0)
    scene.add(sphere, math3d.translation_matrix(0.0, 0.2, 0.0), shader,
              name="sphere")
    scene.add(ground, math3d.identity4(),
              PhongShader(KEY, FILL, RIM, normal_map_strength=0.0),
              name="ground")
    return scene


def test_shadow_darkens_ground():
    scene = _blocker_scene()
    plain = scene.render(backend="xla").color
    settings = shadows.ShadowSettings(size=256)
    result, shadow_map = shadows.render_with_shadows(
        scene, KEY, settings, backend="xla")
    shadowed = result.color

    assert np.isfinite(shadow_map).any(), "light pass rendered nothing"
    darker = (shadowed.astype(int) < plain.astype(int) - 20).all(axis=-1)
    assert darker.sum() > 30, "no shadowed pixels found"
    # the hard factor never brightens anything
    assert not (shadowed.astype(int) > plain.astype(int) + 1).any()


def test_shadowed_engine_matches_oracle():
    """Pass 2 parity: same shadow map fed to oracle and engine."""
    from helpers import assert_parity

    scene = _blocker_scene(80, 60)
    settings = shadows.ShadowSettings(size=192)
    light_cam = shadows.light_camera_for_scene(scene, KEY, settings)
    sm = shadows.render_depth_from_light(scene, light_cam, settings, "xla")
    lit = shadows.shadowed_scene(scene, KEY, sm, light_cam, settings)

    res_oracle = lit.render(backend="oracle", dtype=np.float32)
    res_engine = lit.render(backend="xla")

    class _FrameShim:
        zbuffer = res_oracle.full_depth
        color = res_oracle.color

    class _FbShim:
        depth = res_engine.full_depth
        color = res_engine.color

    assert_parity(_FrameShim, _FbShim)


def test_shadowed_tiled_matches_xla():
    scene = _blocker_scene(80, 60)
    settings = shadows.ShadowSettings(size=192)
    light_cam = shadows.light_camera_for_scene(scene, KEY, settings)
    sm = shadows.render_depth_from_light(scene, light_cam, settings, "xla")
    lit = shadows.shadowed_scene(scene, KEY, sm, light_cam, settings)
    a = lit.render(backend="xla").color
    b = lit.render(backend="tiled").color
    assert (a == b).all()


def test_shadowed_scene_swaps_shaders():
    scene = _blocker_scene()
    settings = shadows.ShadowSettings(size=64)
    light_cam = shadows.light_camera_for_scene(scene, KEY, settings)
    sm = np.full((64, 64), np.inf, np.float32)
    lit = shadows.shadowed_scene(scene, KEY, sm, light_cam, settings)
    assert all(isinstance(p.shader, ShadowMappedShader) for p in lit.passes)
    # an all-empty shadow map means everything is lit -> identical to plain
    plain = scene.render(backend="xla").color
    full = lit.render(backend="xla").color
    assert (plain == full).all()


def test_fused_shadow_path_matches_loop():
    """The single-dispatch two-pass fast path (collect_stats=False,
    tiled) must produce the same frame as the two-render path."""
    scene = _blocker_scene()
    settings = shadows.ShadowSettings(size=128)
    # reference: the per-pass loop through the same sparse pipeline,
    # so the comparison is bitwise
    r_ref, sm_ref = shadows.render_with_shadows(
        scene, KEY, settings, backend="tiled", frustum_cull=False,
        collect_stats=True, transfer=True, strict_capacity=True)
    r_fus, sm_fus = shadows.render_with_shadows(
        scene, KEY, settings, backend="tiled", frustum_cull=False,
        collect_stats=False, transfer=True, strict_capacity=True)
    np.testing.assert_array_equal(np.asarray(sm_ref), np.asarray(sm_fus))
    np.testing.assert_array_equal(r_ref.color, r_fus.color)
    np.testing.assert_array_equal(np.asarray(r_ref.full_depth),
                                  np.asarray(r_fus.full_depth))
