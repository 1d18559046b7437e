"""Orbit animation + checkpoint/resume (benchmark config #5)."""

import os

import numpy as np

from tinyrenderder_tpu import animation, math3d
from tinyrenderder_tpu.animation import AnimationConfig, orbit_eye, render_animation
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.scene import Scene
from tinyrenderder_tpu.shaders import GouraudShader, TexturedShader
from tinyrenderder_tpu.utils import tga


def _scene(w=48, h=40) -> Scene:
    sphere = procedural.uv_sphere(8, 12)
    sphere.materials = [procedural.default_head_material(16)]
    cam = Camera()
    cam.set_eye(math3d.vec3(0.0, 0.5, 3.0))
    cam.set_target(math3d.vec3(0.0, 0.0, 0.0))
    cam.set_fov(55.0)
    cam.set_aspect(w / h)
    cam.set_clipping(0.1, 50.0)
    scene = Scene(camera=cam, width=w, height=h)
    scene.add(sphere, math3d.identity4(), TexturedShader(), name="sphere")
    scene.add(procedural.plane(4.0, -1.2), math3d.identity4(),
              GouraudShader(), name="ground")
    return scene


def test_orbit_eye_full_circle():
    eye = np.array([1.0, 2.0, 3.0])
    target = np.array([0.5, 0.0, -0.5])
    assert np.allclose(orbit_eye(eye, target, 2 * np.pi), eye)
    # orbit preserves distance to target and height
    e90 = orbit_eye(eye, target, np.pi / 2)
    assert np.isclose(np.linalg.norm(e90 - target), np.linalg.norm(eye - target))
    assert np.isclose(e90[1], eye[1])


def test_animation_renders_frames(tmp_path):
    scene = _scene()
    cfg = AnimationConfig(frames=4, backend="xla", outdir=str(tmp_path),
                          orbit_degrees=360.0)
    summary = render_animation(scene, cfg)
    assert summary["frames_rendered"] == 4
    files = sorted(p for p in os.listdir(tmp_path) if p.endswith(".tga"))
    assert len(files) == 4
    # frames actually change as the camera orbits
    f0 = tga.read(str(tmp_path / files[0])).to_rgb()
    f2 = tga.read(str(tmp_path / files[2])).to_rgb()
    assert (f0 != f2).any()


def test_animation_resume(tmp_path):
    scene = _scene()
    full_dir = tmp_path / "full"
    part_dir = tmp_path / "part"
    cfg_full = AnimationConfig(frames=4, backend="xla", outdir=str(full_dir))
    render_animation(_scene(), cfg_full)

    # simulate a kill after 2 frames via the stop_after time-slice cap
    cfg_part = AnimationConfig(frames=4, backend="xla", outdir=str(part_dir))
    first = render_animation(scene, cfg_part, stop_after=2)
    assert first["frames_rendered"] == 2

    summary = render_animation(_scene(), cfg_part)
    assert summary["resumed_at"] == 2
    assert summary["frames_rendered"] == 2

    # resumed frames are identical to the uninterrupted run
    for i in range(4):
        a = tga.read(str(full_dir / ("frame_%04d.tga" % i))).to_rgb()
        b = tga.read(str(part_dir / ("frame_%04d.tga" % i))).to_rgb()
        assert (a == b).all(), f"frame {i} differs after resume"


def test_animation_complete_noop(tmp_path):
    cfg = AnimationConfig(frames=3, backend="xla", outdir=str(tmp_path))
    render_animation(_scene(), cfg)
    summary = render_animation(_scene(), cfg)
    assert summary["frames_rendered"] == 0
    assert summary["resumed_at"] == 3


def test_animation_repairs_overflowed_frames(tmp_path, monkeypatch):
    """Force a mid-animation capacity overflow (async mode) and assert
    every WRITTEN frame is bitwise equal to a strict-mode render: the
    overflowed frame must be repaired before its TGA lands (every
    covered pixel shaded, our_gl.cpp:187-192)."""
    from tinyrenderder_tpu.ops import raster_sparse

    stores = [
        (raster_sparse._SPARSE_CAPACITY, raster_sparse._SPARSE_PENDING,
         raster_sparse._W_REFINED),
    ]

    def _snapshot_keys():
        return [set(store) for store, *_ in stores]

    before = _snapshot_keys()

    # strict reference run: exact by construction
    strict_dir = tmp_path / "strict"
    cfg_strict = AnimationConfig(frames=3, backend="tiled",
                                 outdir=str(strict_dir),
                                 strict_capacity=True)
    render_animation(_scene(), cfg_strict)

    # poison the pair capacity of every key the scene populated so the
    # first async frame overflows, then run the async animation
    touched = False
    for (store, pending, refined), prev in zip(stores, before):
        for key in set(store) - prev:
            caps = store[key]
            store[key] = (8,) + tuple(caps[1:])
            pending.pop(key, None)
            refined.discard(key)
            touched = True
    assert touched, "strict run populated no capacity keys"

    async_dir = tmp_path / "async"
    cfg_async = AnimationConfig(frames=3, backend="tiled",
                                outdir=str(async_dir),
                                strict_capacity=False)
    summary = render_animation(_scene(), cfg_async)
    assert summary["overflows_repaired"] >= 1

    for i in range(3):
        a = tga.read(str(strict_dir / ("frame_%04d.tga" % i))).to_rgb()
        b = tga.read(str(async_dir / ("frame_%04d.tga" % i))).to_rgb()
        assert (a == b).all(), f"frame {i} differs from strict render"
