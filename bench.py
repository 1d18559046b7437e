"""Benchmark suite on the GPU: a few fixed scenes through the production
pipeline.

Times each configuration with ``jax.block_until_ready`` around batches
of frames (median batch), after a warm-up that compiles every shape.
Per-config details go to stderr and ``bench_report.json``; stdout gets
one JSON metric line per configuration, each carrying the card's name
and power limit, the headline (Phong at 2048x2048) last.

A run without a GPU exits nonzero: there is no CPU fallback metric.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it (no
    JAX involved)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"unknown (nvidia-smi rc={out.returncode})")


def _lights():
    from tinyrenderder_tpu import math3d
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    return key, fill, rim


def _head(n_lat=96, n_lon=144):
    from tinyrenderder_tpu.models import procedural
    head = procedural.bumpy_head(n_lat, n_lon)
    head.materials = [procedural.default_head_material(256)]
    return head


def _camera(width, height, eye=(0, 0.4, 2.6), target=(0, 0, 0), fov=60.0):
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.camera import Camera
    cam = Camera()
    cam.set_eye(math3d.vec3(*eye))
    cam.set_target(math3d.vec3(*target))
    cam.set_fov(fov)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    return cam


def build_pass(width, height, n_lat=96, n_lon=144, shader=None):
    """Single flagship pass: the headline head at 2048x2048."""
    from tinyrenderder_tpu.shaders import PhongShader
    head = _head(n_lat, n_lon)
    cam = _camera(width, height)
    key, fill, rim = _lights()
    shader = shader or PhongShader(key, fill, rim, normal_map_strength=0.5)
    uniforms = shader.build_uniforms(cam.view_matrix, cam.projection_matrix,
                                     head.materials[0], np.float32)
    attrs = head.face_attributes(np.float32)
    log(f"scene: head {head.nfaces} faces at {width}x{height}")
    return attrs, shader, uniforms


def _scene(width, height, shader_for=None, meshes=3):
    """Multi-mesh scene (head + eyes + room) for the animation config."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.scene import Scene
    from tinyrenderder_tpu.shaders import EyeShader, PhongShader

    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, eye=(0, 0.6, 3.0)),
                  width=width, height=height)
    head = _head(64, 96)
    scene.add(head, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5),
              name="head")
    if meshes >= 2:
        eyes = procedural.uv_sphere(12, 16, radius=0.12, name="eyes")
        eyes.positions += np.array([0.35, 0.25, 0.8])
        eyes.finalize()
        eyes.materials = [procedural.default_head_material(64)]
        scene.add(eyes, math3d.identity4(), EyeShader(key, rim), name="eyes",
                  exclude_from_output_depth=True)
    if meshes >= 3:
        room = procedural.cube(size=12.0, name="room")
        room.faces = room.faces[:, ::-1].copy()
        room.finalize()
        room.materials = [procedural.default_head_material(128)]
        scene.add(room, math3d.identity4(),
                  PhongShader(key, fill, rim, normal_map_strength=0.0),
                  name="room")
    return scene


def _time_frames(frame_fn, warmup, frames, batches: int = 3):
    """Median seconds per frame over ``batches`` batches of ``frames``
    frames, each batch ended by ``jax.block_until_ready``.  The first
    call (compilation included) is reported separately."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(frame_fn())
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        jax.block_until_ready(frame_fn())
    samples = []
    for _ in range(batches):
        t0 = time.perf_counter()
        r = None
        for _ in range(frames):
            r = frame_fn()
        jax.block_until_ready(r)
        samples.append((time.perf_counter() - t0) / frames)
    return float(np.median(samples)), compile_s, samples


def _timing_fields(dt, compile_s, samples=None):
    """Per-config record; ``samples`` (per-batch seconds per frame) adds
    the batch times and their median absolute deviation, so a later
    comparison can be judged against the run's own spread."""
    out = {"frame_ms": dt * 1e3, "fps": 1.0 / dt, "compile_s": compile_s}
    if samples:
        ms = sorted(s * 1e3 for s in samples)
        med = ms[len(ms) // 2]
        out["samples_frame_ms"] = [round(s, 3) for s in ms]
        out["mad_frame_ms"] = round(float(np.median(
            [abs(s - med) for s in ms])), 3)
    return out


def bench_single_pass(shader_name, width, height, warmup, frames):
    import jax.numpy as jnp

    from tinyrenderder_tpu.shaders import (GouraudShader, PhongShader,
                                           TexturedShader)

    key, fill, rim = _lights()
    shaders = {
        "gouraud": GouraudShader(light_world=key),
        "textured": TexturedShader(light_world=key),
        "phong": PhongShader(key, fill, rim, normal_map_strength=0.5),
    }
    attrs, shader, uniforms = build_pass(width, height,
                                         shader=shaders[shader_name])
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    # upload textures once, not per frame
    from tinyrenderder_tpu.scene import _to_device_cached
    uniforms = {k: _to_device_cached(v) for k, v in uniforms.items()}

    from tinyrenderder_tpu.ops import raster_sparse

    # the production route for image-only frames: the single-pass
    # direct-to-image fused program
    def frame():
        img, _ = raster_sparse.render_frame_fused_image(
            [(attrs, shader, uniforms, False)], width, height,
            strict_capacity=False)
        return img

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_shadows(width, height, warmup, frames, shadow_size=1024):
    from tinyrenderder_tpu import shadows
    key, _, _ = _lights()
    scene = _scene(width, height, meshes=3)
    settings = shadows.ShadowSettings(size=shadow_size)

    def frame():
        result, _ = shadows.render_with_shadows(
            scene, key, settings, backend="tiled", frustum_cull=False,
            collect_stats=False, transfer=False, strict_capacity=False)
        return result.color

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_stress(width, height, warmup, frames, grid=3):
    """Sponza-scale geometry: grid^2 dense heads (~246k triangles at
    grid=3) through the full pipeline."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.scene import _to_device_cached
    from tinyrenderder_tpu.shaders import PhongShader

    wall = procedural.head_wall(grid=grid)
    key, fill, rim = _lights()
    view = math3d.lookat((0, 0.3, 6.5), (0, 0, 0), (0, 1, 0))
    proj = math3d.perspective(60.0, width / height, 0.1, 50.0)
    shader = PhongShader(key, fill, rim, normal_map_strength=0.5)
    uniforms = {k: _to_device_cached(v) for k, v in shader.build_uniforms(
        view, proj, wall.materials[0], np.float32).items()}
    attrs = wall.device_face_attributes(np.float32)
    log(f"stress scene: {wall.nfaces} triangles at {width}x{height}")

    def frame():
        ft, _, _ = raster_sparse.render_frame_fused(
            [(attrs, shader, uniforms, False)], width, height,
            strict_capacity=False)
        return raster_sparse.tiles_to_buffers(ft, width, height).color

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            "mtri_s": wall.nfaces / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_mixed(width, height, warmup, frames, grid=3):
    """Mixed-regime stress: a few dozen giant room triangles + ~250k
    tiny head triangles in ONE mesh — the reference's actual
    Sponza-interior regime (main.cpp:483-513): very unequal bins in
    one pass."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.scene import _to_device_cached
    from tinyrenderder_tpu.shaders import PhongShader

    interior = procedural.mixed_interior(grid=grid)
    key, fill, rim = _lights()
    view = math3d.lookat((0, 0.3, 6.5), (0, 0, 0), (0, 1, 0))
    proj = math3d.perspective(60.0, width / height, 0.1, 50.0)
    shader = PhongShader(key, fill, rim, normal_map_strength=0.5)
    uniforms = {k: _to_device_cached(v) for k, v in shader.build_uniforms(
        view, proj, interior.materials[0], np.float32).items()}
    attrs = interior.device_face_attributes(np.float32)
    log(f"mixed scene: {interior.nfaces} triangles "
        f"(12 giant room + tiny heads) at {width}x{height}")

    def frame():
        ft, _, _ = raster_sparse.render_frame_fused(
            [(attrs, shader, uniforms, False)], width, height,
            strict_capacity=False)
        return raster_sparse.tiles_to_buffers(ft, width, height).color

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            "mtri_s": interior.nfaces / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_sharded_mesh1(width, height, warmup, frames):
    """The PRODUCTION pipeline under shard_map on a 1-device mesh: what
    the sharded fused path costs on one card next to the plain fused
    path."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.parallel import dist
    from tinyrenderder_tpu.scene import _to_device_cached
    from tinyrenderder_tpu.shaders import PhongShader

    key, fill, rim = _lights()
    attrs, shader, uniforms = build_pass(
        width, height, shader=PhongShader(key, fill, rim,
                                          normal_map_strength=0.5))
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    uniforms = {k: _to_device_cached(v) for k, v in uniforms.items()}
    mesh = dist.make_mesh(1)
    passes = [(attrs, shader, uniforms, False)]

    def frame():
        ft, _, _ = dist.render_frame_fused_sharded(
            mesh, passes, width, height, strict_capacity=False)
        return dist.tiles_to_buffers_sharded(mesh, ft, width, height).color

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_reference_pipeline(width, height, warmup, frames):
    """The reference's ACTUAL default output pipeline (main.cpp:743-786)
    at its default frame size (1200x800, main.cpp:26-27): the 3-pass
    multi-mesh scene render plus z-buffer visualization, full-frame
    64-tap SSAO, and the multiply composite — post stages in one fused
    device dispatch (ops/post.postprocess_device), everything device-
    resident.  SSAO reads the OUTPUT depth, i.e. the no-eyes snapshot
    (main.cpp:700,730 semantics), which scene.render's
    exclude_from_output_depth plumbing reproduces.  Ragged tile edges
    (1200 = 9.375 x 128) are padded by the tiled path."""
    from tinyrenderder_tpu.ops import post

    scene = _scene(width, height, meshes=3)

    def frame():
        result = scene.render(backend="tiled", frustum_cull=False,
                              collect_stats=False, transfer=False,
                              strict_capacity=False)
        _, _, final = post.postprocess_device(result.color, result.depth)
        return final

    dt, compile_s, samples = _time_frames(frame, warmup, frames)
    return {"mpix_s": width * height / dt / 1e6,
            **_timing_fields(dt, compile_s, samples)}


def bench_animation(width, height, frames):
    """Config #5: multi-mesh orbit; reports steady fps over `frames`
    orbit steps (no disk writes — render throughput only)."""
    import math as pymath

    from tinyrenderder_tpu.animation import orbit_eye

    scene = _scene(width, height, meshes=3)
    base_eye = np.array(scene.camera.params.eye)
    base_target = np.array(scene.camera.params.target)

    def render_at(i):
        angle = 2 * pymath.pi * i / max(frames, 1)
        scene.camera.set_eye(orbit_eye(base_eye, base_target, angle))
        return scene.render(backend="tiled", frustum_cull=False,
                            collect_stats=False, transfer=False,
                            strict_capacity=False).color

    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(render_at(0))
    compile_s = time.perf_counter() - t0
    # one full warm-up orbit: async capacity totals resolve frames late
    # and each growth re-traces the fused program, so every angle's
    # demand must have been seen before the timed batches (caps are
    # monotone after refinement); then a few synced frames so in-flight
    # totals land and any late growth re-traces here
    for j in range(1, frames):
        render_at(j)
    for j in range(4):
        jax.block_until_ready(render_at((j * frames) // 4))
    samples = []
    third = max(frames // 3, 1)
    for b in range(3):
        t0 = time.perf_counter()
        r = None
        for j in range(third):
            r = render_at(b * third + j)
        jax.block_until_ready(r)
        samples.append((time.perf_counter() - t0) / third)
    dt = float(np.median(samples))
    return {"frame_ms": dt * 1e3, "fps": 1.0 / dt,
            "mpix_s": width * height / dt / 1e6, "compile_s": compile_s}


def bench_animation_tga(width, height, frames):
    """The full `frames`-frame orbit through animation.py —
    checkpoint/resume ON, every frame transferred to host and written
    as a TGA file.  Reported separately from the render-only fps: the
    host transfer and encode are part of this number."""
    import shutil
    import tempfile

    from tinyrenderder_tpu.animation import AnimationConfig, render_animation

    scene = _scene(width, height, meshes=3)
    outdir = tempfile.mkdtemp(prefix="bench_anim_")
    cfg = AnimationConfig(frames=frames, backend="tiled", outdir=outdir,
                          frustum_cull=False, checkpoint=True)
    try:
        summary = render_animation(scene, cfg)
        written = len([f for f in __import__("os").listdir(outdir)
                       if f.endswith(".tga")])
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    dt = summary["seconds"] / max(summary["frames_rendered"], 1)
    return {"frame_ms": dt * 1e3, "fps": summary["fps"],
            "mpix_s": width * height / dt / 1e6,
            "frames_written": written, "compile_s": 0.0}


def _ensure_native() -> None:
    """Best-effort build of native/libtinyrenderder_native.so (gitignored,
    built from committed sources): the TGA codec falls back to Python
    silently, which is correct but slower, so build it for the
    animation TGA config."""
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        r = subprocess.run(["make", "-C", os.path.join(root, "native")],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            log(f"native build failed (rc={r.returncode}) — Python "
                "codec fallback in effect")
    except (OSError, subprocess.TimeoutExpired) as e:
        log(f"native build skipped ({e}) — Python codec fallback")


def main() -> int:
    from tinyrenderder_tpu.ops import device

    _ensure_native()
    if device.platform() != "gpu":
        log("bench.py measures the GPU; JAX found no GPU")
        return 1
    import jax

    device.use_compile_cache()
    gpu = card()
    big, mid = 2048, 800
    warmup, frames = 3, 10
    anim_frames = 120
    log(f"card: {gpu}; devices={len(jax.devices())} "
        f"kind={jax.devices()[0].device_kind}")
    report = {"card": gpu, "device_kind": jax.devices()[0].device_kind,
              "configs": {}}

    only = [s for s in os.environ.get("BENCH_ONLY", "").split(",") if s]

    def run(name, fn, *a):
        if only and not any(s in name for s in only):
            return None
        t0 = time.perf_counter()
        r = fn(*a)
        report["configs"][name] = r
        log(f"  {name}: {r['frame_ms']:.3f} ms/frame, {r['fps']:.1f} fps, "
            f"{r['mpix_s']:.1f} Mpix/s (compile {r['compile_s']:.1f}s, "
            f"total {time.perf_counter() - t0:.0f}s)")
        with open("bench_report.json", "w") as f:
            json.dump(report, f, indent=2)
        if name != f"phong_{big}":
            print(json.dumps({"metric": f"{name}_throughput",
                              "value": r["mpix_s"], "unit": "Mpix/s",
                              "card": gpu}), flush=True)
        return r

    head = run(f"phong_{big}", bench_single_pass, "phong", big, big,
               warmup, frames)
    run(f"gouraud_{mid}", bench_single_pass, "gouraud", mid, mid, warmup,
        frames)
    run(f"textured_{mid}", bench_single_pass, "textured", mid, mid, warmup,
        frames)
    run(f"shadow_phong_{mid}", bench_shadows, mid, mid, warmup, frames, 1024)
    run("reference_default_1200x800", bench_reference_pipeline, 1200, 800,
        warmup, frames)
    run("sponza_scale_246k_1280x800", bench_stress, 1280, 800, warmup,
        frames, 3)
    run("mixed_interior_1280x800", bench_mixed, 1280, 800, warmup, frames,
        3)
    run(f"phong_{big}_sharded_mesh1", bench_sharded_mesh1, big, big,
        warmup, frames)
    run(f"animation_multimesh_{big}", bench_animation, big, big, anim_frames)
    run(f"animation_tga_writes_{big}", bench_animation_tga, big, big,
        anim_frames)
    if head is not None:
        print(json.dumps({"metric": f"phong_shaded_throughput_{big}x{big}",
                          "value": head["mpix_s"], "unit": "Mpix/s",
                          "card": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
