"""Scene driver tests: culling, multi-pass flow, backend agreement,
z-snapshot semantics, CLI end-to-end."""

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.scene import Scene
from tinyrenderder_tpu.shaders import EyeShader, FlatShader, PhongShader

KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


def small_scene(width=72, height=72):
    cam = Camera()
    cam.set_eye((0, 0.8, 3.2))
    cam.set_target((0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    scene = Scene(camera=cam, width=width, height=height)

    head = procedural.bumpy_head(10, 14)
    head.materials = [procedural.default_head_material(32)]
    eyes = procedural.uv_sphere(6, 8, radius=0.15)
    eyes.positions += np.array([0.3, 0.2, 0.85])
    eyes.finalize()
    plane = procedural.plane(6.0, -1.2)

    scene.add(plane, np.eye(4), FlatShader(light_world=(0.2, 1, 0.3)), name="floor")
    scene.add(head, np.eye(4), PhongShader(KEY, FILL, RIM), name="head")
    scene.add(eyes, np.eye(4), EyeShader(KEY, RIM), name="eyes",
              exclude_from_output_depth=True)
    return scene


def test_backends_agree():
    scene = small_scene()
    r_oracle = scene.render(backend="oracle")
    r_xla = scene.render(backend="xla")
    assert r_oracle.stats.fragments_drawn > 0
    d = np.abs(r_xla.color.astype(int) - r_oracle.color.astype(int))
    assert d.max() <= 1
    assert np.array_equal(np.isfinite(r_xla.full_depth),
                          np.isfinite(r_oracle.full_depth))


def test_depth_snapshot_excludes_eye_pass():
    scene = small_scene()
    r = scene.render(backend="xla")
    # output depth must be the pre-eyes snapshot: the full depth is nearer
    # (or newly covered) wherever the eye pass won pixels
    assert np.isfinite(r.depth).sum() <= np.isfinite(r.full_depth).sum()
    both = np.isfinite(r.depth) & np.isfinite(r.full_depth)
    nearer = (r.full_depth[both] < r.depth[both]).sum()
    new_cov = (np.isfinite(r.full_depth) & ~np.isfinite(r.depth)).sum()
    assert nearer + new_cov > 0, "eye pass must have won some pixels"


def test_frustum_culls_offscreen_model():
    scene = small_scene()
    moon = procedural.uv_sphere(6, 8)
    scene.add(moon, math3d.translation_matrix(500, 0, 0),
              FlatShader(), name="moon")
    r = scene.render(backend="xla")
    assert r.stats.models_culled == 1
    assert r.stats.culled_triangles == moon.nfaces
    assert r.stats.models_rendered == 3

    r2 = scene.render(backend="xla", frustum_cull=False)
    assert r2.stats.models_culled == 0
    # moon draws nothing anyway (offscreen) -> identical image
    assert np.array_equal(r.color, r2.color)


def test_scene_describe():
    scene = small_scene()
    text = scene.describe()
    assert "head" in text and "faces" in text


def test_stats_against_oracle():
    scene = small_scene()
    r_o = scene.render(backend="oracle")
    r_x = scene.render(backend="xla")
    assert r_o.stats.triangles_rasterized == r_x.stats.triangles_rasterized
    assert (r_o.stats.min_x, r_o.stats.min_y, r_o.stats.max_x, r_o.stats.max_y) == \
           (r_x.stats.min_x, r_x.stats.min_y, r_x.stats.max_x, r_x.stats.max_y)
    # the scan backend's counters are EXACT (overdraw-inclusive z-pass
    # events via raster.pass_events_xla)
    assert r_x.stats.fragments_exact
    assert r_x.stats.fragments_drawn == r_o.stats.fragments_drawn
    assert r_x.stats.fragments_drawn >= np.isfinite(r_x.full_depth).sum()
    assert np.isclose(r_o.stats.min_z, r_x.stats.min_z, atol=1e-5)
    assert np.isclose(r_o.stats.max_z, r_x.stats.max_z, atol=1e-5)
    desc = r_x.stats.describe()
    assert "triangles=" in desc and "winners only" not in desc


def test_cli_end_to_end(tmp_path):
    from tinyrenderder_tpu import cli
    rc = cli.run(["--width", "64", "--height", "48", "--outdir", str(tmp_path),
                  "--backend", "xla"])
    assert rc == 0
    for name in ("phong.tga", "zbuffer.tga", "ao.tga", "final.tga"):
        assert (tmp_path / name).exists(), name
    from tinyrenderder_tpu.utils import tga
    img = tga.read(tmp_path / "phong.tga")
    assert img.width == 64 and img.height == 48


def test_device_uniform_cache_lru_and_byte_bound(monkeypatch):
    """Large uniforms are cached by identity (hits return the SAME device
    buffer and refresh recency); one-shot arrays age out by total-byte
    eviction instead of displacing long-lived textures (LRU)."""
    import tinyrenderder_tpu.scene as scene_mod
    monkeypatch.setattr(scene_mod, "_DEVICE_UNIFORM_CACHE",
                        type(scene_mod._DEVICE_UNIFORM_CACHE)())
    monkeypatch.setattr(scene_mod, "_DEVICE_UNIFORM_CACHE_BYTES", 3 * 8192)
    tex = np.zeros(8192, np.uint8)           # the long-lived "texture"
    dev_tex = scene_mod._to_device_cached(tex)
    assert scene_mod._to_device_cached(tex) is dev_tex       # identity hit
    # churn one-shot arrays (per-frame shadow maps): the texture stays
    # cached because every hit refreshes its recency
    for _ in range(8):
        scene_mod._to_device_cached(np.ones(8192, np.uint8))
        assert scene_mod._to_device_cached(tex) is dev_tex
    # total bytes stay bounded
    total = sum(e[0].nbytes
                for e in scene_mod._DEVICE_UNIFORM_CACHE.values())
    assert total <= 3 * 8192
    # small arrays bypass the cache entirely
    small = np.zeros(16, np.float32)
    assert scene_mod._to_device_cached(small) is small


def test_sponza_standin_normals_face_inward():
    """The asset-less default scene's room box must have vertex normals
    agreeing with its (flipped, inward) winding — regression: flipping
    faces after cube() authored outward normals left every visible wall
    lit from behind."""
    from tinyrenderder_tpu.cli import _load_or_procedural
    from tinyrenderder_tpu.models.manager import ModelManager
    room = _load_or_procedural(ModelManager(), "/nonexistent/sponza.obj",
                               "sponza")
    p, f, n = room.positions, room.faces, room.normals
    geom = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
    geom /= np.linalg.norm(geom, axis=-1, keepdims=True)
    corner_dot = (n[f] * geom[:, None, :]).sum(-1)
    assert (corner_dot > 0.99).all()


def test_cli_explicit_model_parse_failure_is_fatal(tmp_path):
    """An explicitly-passed model path that EXISTS but fails to load
    must error out, not silently render a procedural stand-in."""
    import pytest as _pytest

    from tinyrenderder_tpu import cli
    bad = tmp_path / "broken.obj"
    bad.write_text("v 0 0 abc\nf 1 2 3\n")
    with _pytest.raises(SystemExit):
        cli.build_default_scene(str(bad), 64, 48)


def test_pass_input_caches_never_go_stale():
    """The per-frame host caches (frustum/cull decision, world AABBs,
    device uniforms — scene._pass_inputs) must invalidate on every
    mutation they key on: camera motion, in-place model-matrix edits,
    shader light swaps, and pass-list changes.  Each mutated render is
    compared against a freshly built scene with the same state — a
    stale cache reproduces the PREVIOUS frame instead."""

    def build(eye=(0, 0.8, 3.2), key=KEY, dx=0.0):
        sc = small_scene()
        sc.camera.set_eye(eye)
        for p in sc.passes:
            if p.name == "head":
                p.model_matrix = np.asarray(
                    math3d.translation_matrix(dx, 0, 0), dtype=np.float64)
                p.shader = PhongShader(key, FILL, RIM)
        return sc

    sc = build()
    base = sc.render(backend="xla").color
    assert np.array_equal(base, build().render(backend="xla").color)

    # camera motion
    sc.camera.set_eye((0.4, 0.8, 3.0))
    moved = sc.render(backend="xla").color
    assert np.array_equal(
        moved, build(eye=(0.4, 0.8, 3.0)).render(backend="xla").color)
    assert not np.array_equal(moved, base)
    sc.camera.set_eye((0, 0.8, 3.2))

    # in-place model matrix mutation
    for p in sc.passes:
        if p.name == "head":
            p.model_matrix[:] = math3d.translation_matrix(0.5, 0, 0)
    shifted = sc.render(backend="xla").color
    assert np.array_equal(
        shifted, build(dx=0.5).render(backend="xla").color)
    assert not np.array_equal(shifted, base)
    for p in sc.passes:
        if p.name == "head":
            p.model_matrix[:] = np.eye(4)

    # shader mutable-state change (light direction attribute)
    new_key = math3d.normalized(math3d.vec3(-1.0, 0.2, 0.5))
    for p in sc.passes:
        if p.name == "head":
            p.shader.key_light_world = new_key
    relit = sc.render(backend="xla").color
    assert np.array_equal(
        relit, build(key=new_key).render(backend="xla").color)
    assert not np.array_equal(relit, base)
    for p in sc.passes:
        if p.name == "head":
            p.shader.key_light_world = KEY

    # in-place mutation of a small shader ndarray attribute (tokens
    # snapshot sub-4096-element arrays by VALUE, so even sc's own
    # array being edited under the cache must be seen)
    for p in sc.passes:
        if p.name == "head":
            p.shader.key_light_world = np.array(p.shader.key_light_world)
            p.shader.key_light_world[:] = new_key
    relit2 = sc.render(backend="xla").color
    assert np.array_equal(relit2, relit)
    for p in sc.passes:
        if p.name == "head":
            p.shader.key_light_world = np.array(KEY)

    # material texture rebinding (m.diffuse = new array) must miss both
    # the packed-texture cache on the material and the per-pass device
    # uniform cache (regression: session-6 caches keyed material by
    # identity only, so device backends served the stale texture)
    def red_tex():
        t = np.zeros((8, 8, 3), dtype=np.uint8)
        t[..., 0] = 255
        return t

    def rebind(s):
        for p in s.passes:
            if p.name == "head":
                p.mesh.materials[0].diffuse = red_tex()
        return s

    head_mat = next(p for p in sc.passes if p.name == "head").mesh.materials[0]
    orig_diffuse = head_mat.diffuse
    rebind(sc)
    retex = sc.render(backend="xla").color
    assert np.array_equal(retex, rebind(build()).render(backend="xla").color)
    assert not np.array_equal(retex, base)
    head_mat.diffuse = orig_diffuse

    # pass-list growth invalidates the cull cache
    n_before = len(sc.passes)
    extra = procedural.cube(size=0.4)
    extra.finalize()
    sc.add(extra, math3d.translation_matrix(1.0, 0.0, 0.0),
           FlatShader(light_world=(0.2, 1, 0.3)), name="box")
    grown = sc.render(backend="xla")
    assert grown.stats.models_rendered == n_before + 1
    assert not np.array_equal(grown.color, base)

    # and back to the base state: caches must reproduce frame one
    sc.passes.pop()
    again = sc.render(backend="xla").color
    assert np.array_equal(again, base)


def single_pass_scene(width=128, height=128):
    cam = Camera()
    cam.set_eye((0, 0.8, 3.2))
    cam.set_target((0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    scene = Scene(camera=cam, width=width, height=height)
    head = procedural.bumpy_head(10, 14)
    head.materials = [procedural.default_head_material(32)]
    scene.add(head, np.eye(4), PhongShader(KEY, FILL, RIM), name="head")
    return scene


def test_render_image_routes_single_pass_through_image_path(monkeypatch):
    """Scene.render_image on a single-color-pass frame must run the
    direct-to-image fused program
    and reproduce the general tiled path's colors bitwise."""
    from tinyrenderder_tpu.ops import raster_sparse

    sc = single_pass_scene()
    calls = []
    orig = raster_sparse.render_frame_fused_image

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(raster_sparse, "render_frame_fused_image", spy)
    img = sc.render_image(backend="tiled")
    assert len(calls) >= 1, "image route not taken"
    ref = sc.render(backend="tiled", collect_stats=False).color
    assert np.array_equal(img, np.asarray(ref))


def test_render_image_multipass_falls_back(monkeypatch):
    """Multi-pass scenes (and any shape the image program can't take)
    fall back to the full render; the caller still gets the frame."""
    from tinyrenderder_tpu.ops import raster_sparse

    sc = small_scene()

    def boom(*a, **kw):
        raise AssertionError("image path must not run on 3-pass scenes")

    monkeypatch.setattr(raster_sparse, "render_frame_fused_image", boom)
    img = sc.render_image(backend="tiled")
    ref = sc.render(backend="tiled", collect_stats=False).color
    assert np.array_equal(img, np.asarray(ref))


def test_render_image_sharded_route(monkeypatch):
    """The sharded backend's image route (8 virtual devices) must be
    bitwise-identical to the single-device tiled frame."""
    import jax

    from tinyrenderder_tpu.parallel import dist

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs the virtual multi-device mesh")
    sc = single_pass_scene()              # 128 = 8 devices x TILE_H
    calls = []
    orig = dist.render_frame_fused_image_sharded

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(dist, "render_frame_fused_image_sharded", spy)
    img = sc.render_image(backend="sharded")
    assert len(calls) >= 1, "sharded image route not taken"
    ref = sc.render(backend="tiled", collect_stats=False).color
    assert np.array_equal(img, np.asarray(ref))


def test_cli_image_only(tmp_path):
    """--image-only writes phong.tga alone, pixel-identical to the full
    run's phong output (the image is the sole deliverable)."""
    from tinyrenderder_tpu import cli
    rc = cli.run(["--width", "64", "--height", "48",
                  "--outdir", str(tmp_path), "--backend", "xla",
                  "--image-only"])
    assert rc == 0
    assert (tmp_path / "phong.tga").exists()
    assert not (tmp_path / "zbuffer.tga").exists()
    full = tmp_path / "full"
    rc = cli.run(["--width", "64", "--height", "48", "--outdir", str(full),
                  "--backend", "xla"])
    assert rc == 0
    from tinyrenderder_tpu.utils import tga
    a = tga.read(tmp_path / "phong.tga")
    b = tga.read(full / "phong.tga")
    assert np.array_equal(a.to_rgb(), b.to_rgb())


def test_render_image_sharded_nondivisible_bands(monkeypatch):
    """The sharded image route on a frame whose rows don't divide by
    the device count must use measured bands (not fall back), bitwise
    vs the tiled image."""
    import jax

    from tinyrenderder_tpu.parallel import dist

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs the virtual multi-device mesh")
    sc = single_pass_scene(width=128, height=176)     # 11 tile rows
    seen = {}
    orig = dist.render_frame_fused_image_sharded

    def spy(*a, **kw):
        seen["bands"] = kw.get("bands")
        return orig(*a, **kw)

    monkeypatch.setattr(dist, "render_frame_fused_image_sharded", spy)
    img = sc.render_image(backend="sharded")
    assert seen.get("bands") is not None, "bands route not taken"
    ref = sc.render(backend="tiled", collect_stats=False).color
    assert np.array_equal(img, np.asarray(ref))
