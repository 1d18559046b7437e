"""Run the renderer's main path on an NVIDIA GPU and check its output.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded backends only

One process, one card (or the four of one host with ``--multi``).  The
last line of stdout is ``{"ok": true, "device": {...}}``; it is printed
only when every phase passed.  Without a GPU, or run outside a checkout
of the repository, the script exits nonzero and prints no result.

Phases, one card:
  1. the CLI at 1200x800 with ``--backend tiled`` (the reference's
     default scene and output files);
  2. parity: the default scene against the float32 oracle (coverage,
     winner and depth bitwise, color within 1 LSB); Phong at 2048x2048
     through the direct-to-image path and Scene.render against the
     ``xla`` backend; the 246k-triangle scene at 1280x800 against the
     XLA tiled resolve (winner bitwise, color within 1 LSB);
  3. shadows: the fused two-pass frame against the per-pass route;
  4. animation: 4 orbit frames at 2048x2048 to TGA, frame 0 against a
     single render of the same camera;
  5. timing: the fused frame with the resolve kernel against the plain
     XLA tiled pipeline, in three scenes;
  6. the ``gpu``-marked tests, in this process.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---- scenes -----------------------------------------------------------------

def _lights():
    from tinyrenderder_tpu import math3d
    return (math3d.normalized(math3d.vec3(1.0, 1.4, 1.0)),
            math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2)),
            math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5)))


def _camera(width, height, eye, target=(0, 0, 0)):
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.camera import Camera
    cam = Camera()
    cam.set_eye(math3d.vec3(*eye))
    cam.set_target(math3d.vec3(*target))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    return cam


def phong_scene(width, height):
    """The 27k-triangle normal-mapped head, one Phong pass."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.scene import Scene
    from tinyrenderder_tpu.shaders import PhongShader
    key, fill, rim = _lights()
    head = procedural.bumpy_head(96, 144)
    head.materials = [procedural.default_head_material(256)]
    scene = Scene(camera=_camera(width, height, (0, 0.4, 2.6)),
                  width=width, height=height)
    scene.add(head, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5),
              name="head")
    return scene


def stress_scene(width, height):
    """A 3x3 wall of dense heads: 246k triangles, very unequal bins."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.scene import Scene
    from tinyrenderder_tpu.shaders import PhongShader
    key, fill, rim = _lights()
    wall = procedural.head_wall(grid=3)
    scene = Scene(camera=_camera(width, height, (0, 0.3, 6.5)),
                  width=width, height=height)
    scene.add(wall, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5),
              name="wall")
    return scene


def room_scene(width, height):
    """Head + eyes (depth-excluded pass) + inward-facing room."""
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.scene import Scene
    from tinyrenderder_tpu.shaders import EyeShader, PhongShader
    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, (0, 0.6, 3.0)),
                  width=width, height=height)
    head = procedural.bumpy_head(64, 96)
    head.materials = [procedural.default_head_material(256)]
    scene.add(head, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5),
              name="head")
    eyes = procedural.uv_sphere(12, 16, radius=0.12, name="eyes")
    eyes.positions += np.array([0.35, 0.25, 0.8])
    eyes.finalize()
    eyes.materials = [procedural.default_head_material(64)]
    scene.add(eyes, math3d.identity4(), EyeShader(key, rim), name="eyes",
              exclude_from_output_depth=True)
    room = procedural.cube(size=12.0, name="room")
    room.faces = room.faces[:, ::-1].copy()
    room.finalize()
    room.materials = [procedural.default_head_material(128)]
    scene.add(room, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.0),
              name="room")
    return scene


def device_passes(scene):
    from tinyrenderder_tpu.scene import _cull_passes, _pass_inputs
    from tinyrenderder_tpu.utils.stats import RenderStats
    out = []
    for p in _cull_passes(scene, True, RenderStats()):
        attrs, uniforms = _pass_inputs(scene, p, np.float32, device=True)
        out.append((attrs, p.shader, uniforms, p.exclude_from_output_depth))
    return out


def fused_frame(scene):
    """The production fused frame, untiled: FrameBuffers on the card."""
    from tinyrenderder_tpu.ops import raster_sparse
    w, h = scene.width, scene.height
    ft, _, ovf = raster_sparse.render_frame_fused(device_passes(scene), w, h)
    check(not bool(ovf), "fused frame overflowed in strict mode")
    return raster_sparse.tiles_to_buffers(ft, w, h)


def ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    fin = np.isfinite(a) & np.isfinite(b)
    if not fin.any():
        return 0
    d = np.abs(a[fin].view(np.int32).astype(np.int64)
               - b[fin].view(np.int32).astype(np.int64))
    return int(d.max())


def color_delta(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64)
                      - np.asarray(b).astype(np.int64)).max())


# ---- phases -----------------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def phase_cli(width=1200, height=800):
    import re

    from tinyrenderder_tpu import cli
    rec = _Records()
    pkg_log = logging.getLogger("tinyrenderder_tpu")
    pkg_log.addHandler(rec)
    pkg_log.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            rc = cli.run(["--width", str(width), "--height", str(height),
                          "--backend", "tiled", "--outdir", out])
            dt = time.perf_counter() - t0
            check(rc == 0, f"cli returned {rc}")
            for name in ("phong", "zbuffer", "ao", "final"):
                path = os.path.join(out, name + ".tga")
                check(os.path.getsize(path) > 0, f"{name}.tga is empty")
    finally:
        pkg_log.removeHandler(rec)
    text = "\n".join(r.getMessage() for r in rec.records)
    m = re.search(r"fragments_drawn=(\d+)", text)
    check(m is not None and int(m.group(1)) > 0,
          "the CLI reported no fragments_drawn")
    overflow = [r.getMessage() for r in rec.records
                if r.levelno >= logging.WARNING and "overflow" in
                r.getMessage()]
    check(not overflow, f"capacity overflow reported: {overflow}")
    say(f"cli: {width}x{height} --backend tiled wrote phong/zbuffer/ao/"
        f"final.tga, fragments_drawn={m.group(1)}, overflow clear, "
        f"{dt:.3f} s including compilation")


def phase_parity_oracle(width=1200, height=800):
    from tinyrenderder_tpu import cli, oracle
    from tinyrenderder_tpu.scene import _cull_passes, _pass_inputs
    from tinyrenderder_tpu.utils.stats import RenderStats
    scene = cli.build_default_scene(None, width, height)
    fb = fused_frame(scene)
    res = scene.render(backend="tiled", collect_stats=False)
    check(np.array_equal(np.asarray(fb.color), res.color),
          "Scene.render(tiled) differs from the fused frame")
    t0 = time.perf_counter()
    host = []
    for p in _cull_passes(scene, True, RenderStats()):
        attrs, uniforms = _pass_inputs(scene, p, np.float32)
        host.append(oracle.OraclePass(attrs, p.shader, uniforms))
    frame = oracle.render_passes(host, width, height, dtype=np.float32)
    oracle_s = time.perf_counter() - t0
    depth, winner = np.asarray(fb.depth), np.asarray(fb.winner)
    cov = int((np.isfinite(depth) != np.isfinite(frame.zbuffer)).sum())
    win = int((winner != frame.winner).sum())
    du = ulps(depth, frame.zbuffer)
    dc = color_delta(fb.color, frame.color)
    say(f"parity default scene {width}x{height} vs float32 oracle "
        f"({oracle_s:.1f} s on the host): coverage mismatches {cov}, "
        f"winner mismatches {win}, max depth {du} ulp, max color delta "
        f"{dc} LSB, covered pixels {int(np.isfinite(depth).sum())}")
    check(cov == 0 and win == 0, "coverage/winner not bitwise the oracle's")
    check(du <= 2, f"depth {du} ulp from the oracle")
    check(dc <= 1, f"color {dc} LSB from the oracle")


def phase_parity_phong(width=2048, height=2048):
    scene = phong_scene(width, height)
    img = np.asarray(scene.render_image(backend="tiled"))
    tiled = scene.render(backend="tiled", collect_stats=False)
    xla = scene.render(backend="xla", collect_stats=False)
    check(np.array_equal(img, tiled.color),
          "direct-to-image path differs from Scene.render(tiled)")
    cov = int((np.isfinite(tiled.full_depth)
               != np.isfinite(xla.full_depth)).sum())
    du = ulps(tiled.full_depth, xla.full_depth)
    dc = color_delta(tiled.color, xla.color)
    say(f"parity phong {width}x{height}: image path == Scene.render "
        f"bitwise; vs backend xla: coverage mismatches {cov}, max depth "
        f"{du} ulp, max color delta {dc} LSB")
    check(cov == 0 and du <= 2 and dc <= 1, "phong tiled vs xla parity")


def phase_parity_stress(width=1280, height=800):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster, raster_tiled
    scene = stress_scene(width, height)
    fb = fused_frame(scene)
    (attrs, shader, uniforms, _), = device_passes(scene)
    ref, _ = raster_tiled.render_pass_tiled(
        raster.new_framebuffers(width, height, dtype=jnp.float32), attrs,
        shader, uniforms, use_pallas=False)
    win = int((np.asarray(fb.winner) != np.asarray(ref.winner)).sum())
    dc = color_delta(fb.color, ref.color)
    du = ulps(fb.depth, ref.depth)
    say(f"parity 246k-triangle scene {width}x{height} "
        f"({attrs['position'].shape[0]} faces) vs XLA tiled resolve: "
        f"winner mismatches {win}, max depth {du} ulp, max color delta "
        f"{dc} LSB")
    check(win == 0 and dc <= 1, "stress scene parity")


def phase_shadows(size=800, map_size=1024):
    from tinyrenderder_tpu import shadows
    key, _, _ = _lights()
    scene = room_scene(size, size)
    settings = shadows.ShadowSettings(size=map_size)
    fused, sm_f = shadows.render_with_shadows(
        scene, key, settings, backend="tiled", frustum_cull=False,
        collect_stats=False)
    loop, sm_l = shadows.render_with_shadows(
        scene, key, settings, backend="tiled", frustum_cull=False,
        collect_stats=True)
    same = (np.array_equal(fused.color, loop.color)
            and np.array_equal(np.asarray(sm_f), np.asarray(sm_l),
                               equal_nan=True))
    lit = int((fused.color.sum(-1) > 0).sum())
    say(f"shadows {size}x{size}, {map_size}^2 map: fused frame == per-pass "
        f"route bitwise: {same}; {lit} lit pixels")
    check(same and lit > 0, "fused shadow frame differs from the loop")


def phase_animation(size=2048, frames=4):
    from tinyrenderder_tpu.animation import AnimationConfig, render_animation
    from tinyrenderder_tpu.utils import tga
    scene = room_scene(size, size)
    eye = np.array(scene.camera.params.eye, dtype=np.float64)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        summary = render_animation(scene, AnimationConfig(
            frames=frames, backend="tiled", outdir=out, frustum_cull=False))
        dt = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(out) if f.endswith(".tga"))
        check(len(files) == frames, f"wrote {files}")
        scene.camera.set_eye(eye)
        single = scene.render(backend="tiled", frustum_cull=False,
                              collect_stats=False)
        ref = os.path.join(out, "single.tga")
        tga.TGAImage.from_rgb(single.color).write_tga_file(ref)
        with open(ref, "rb") as a, open(os.path.join(out, files[0]),
                                         "rb") as b:
            same = a.read() == b.read()
    say(f"animation {frames} frames {size}x{size} to TGA in {dt:.1f} s "
        f"(compilation included, {summary['overflows_repaired']} "
        f"overflows repaired); frame 0 == single render: {same}")
    check(same, "animation frame 0 differs from a single render")


def _time_frame(fn, frames=10):
    import jax
    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, min(times) * 1e3, max(times) * 1e3


def phase_timing(frames=10, big=2048):
    """The fused frame (resolve kernel + XLA stages) against the plain
    XLA tiled pipeline (raster_tiled.render_pass_tiled, pass by pass),
    median frame times on the card."""
    import jax.numpy as jnp

    from tinyrenderder_tpu import cli
    from tinyrenderder_tpu.ops import raster, raster_sparse, raster_tiled
    scenes = {"default 1200x800": cli.build_default_scene(None, 1200, 800),
              f"phong {big}x{big}": phong_scene(big, big),
              "246k 1280x800": stress_scene(1280, 800)}
    for name, scene in scenes.items():
        passes = device_passes(scene)
        w, h = scene.width, scene.height

        def fused():
            ft, _, _ = raster_sparse.render_frame_fused(
                passes, w, h, strict_capacity=False)
            return ft.color

        def plain():
            fb = raster.new_framebuffers(w, h, dtype=jnp.float32)
            off = 0
            for attrs, shader, uniforms, _ in passes:
                fb, _ = raster_tiled.render_pass_tiled(
                    fb, attrs, shader, uniforms, winner_offset=off,
                    use_pallas=False, strict_capacity=False)
                off += attrs["position"].shape[0]
            return fb.color

        k, k_lo, k_hi = _time_frame(fused, frames)
        x, x_lo, x_hi = _time_frame(plain, frames)
        say(f"timing {name}: fused frame with the resolve kernel "
            f"{k:.3f} ms (min {k_lo:.3f}, max {k_hi:.3f}); plain XLA "
            f"tiled pipeline {x:.3f} ms (min {x_lo:.3f}, max {x_hi:.3f})")


def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu_gate.py")])
    say(f"gpu-marked tests: pytest exit {int(rc)}")
    check(int(rc) == 0, "gpu-marked tests failed")


def phase_multi(big=2048, width=1280, height=800):
    import jax

    from tinyrenderder_tpu.parallel import dist
    devs = jax.devices()
    check(len(devs) == 4, f"--multi needs 4 devices, JAX sees {len(devs)}")
    cases = [(f"phong {big}x{big} sharded", phong_scene(big, big),
              "sharded"),
             (f"246k {width}x{height} sharded", stress_scene(width, height),
              "sharded"),
             (f"246k {width}x{height} sharded-geometry",
              stress_scene(width, height), "sharded-geometry")]
    for name, scene, backend in cases:
        w, h = scene.width, scene.height
        ref = fused_frame(scene)
        got = scene.render(backend=backend, collect_stats=False)
        same = (np.array_equal(got.color, np.asarray(ref.color))
                and np.array_equal(got.full_depth, np.asarray(ref.depth),
                                   equal_nan=True))
        say(f"multi {name}: == single-device fused frame bitwise: {same}")
        check(same, f"{name} differs from the single-device frame")
    # where the shards live: the production sharded frame on the mesh
    scene = stress_scene(width, height)
    mesh = dist.make_mesh()
    bands = dist.even_unequal_bands(height // 16, len(devs))
    ft, _, _ = dist.render_frame_fused_sharded(mesh, device_passes(scene),
                                               width, height, bands=bands)
    on = {s.device.id for s in ft.color.addressable_shards}
    check(len(on) == 4, f"shards on devices {sorted(on)}")
    say(f"multi: unequal bands {bands}; shards on devices {sorted(on)}")
    for d in devs:
        stats = d.memory_stats() or {}
        say(f"multi: device {d.id} bytes_in_use "
            f"{stats.get('bytes_in_use', 'not reported')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded backends against the "
                         "single-device frame, and no other phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import tinyrenderder_tpu  # noqa: F401  (sets the GPU division flag)
    from tinyrenderder_tpu.ops import device

    import jax
    if device.platform() != "gpu":
        print("chip_smoke: JAX found no GPU", file=sys.stderr)
        return 1
    device.use_compile_cache()
    say(f"card: {card()}")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        for phase in (phase_cli, phase_parity_oracle, phase_parity_phong,
                      phase_parity_stress, phase_shadows, phase_animation,
                      phase_timing, phase_gpu_tests):
            t = time.perf_counter()
            phase()
            say(f"[{phase.__name__} {time.perf_counter() - t:.1f} s]")
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
