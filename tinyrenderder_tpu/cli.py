"""Command-line scene driver — capability parity with main() (main.cpp:469-807).

Renders the reference's default multi-mesh scene (Sponza + head + eyes,
with the same model matrices, camera, lights and shader assignments), then
the SSAO post-pass and the four TGA outputs: phong.tga, zbuffer.tga,
ao.tga, final.tga.  The first positional argument overrides the head model
path exactly like ``argv[1]`` (main.cpp:478).

The reference repo ships no assets; when the OBJ paths don't exist this
driver substitutes deterministic procedural stand-ins (documented in
models.procedural) so the full pipeline remains runnable end to end.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.models.manager import ModelManager
from tinyrenderder_tpu.models.mesh import Mesh
from tinyrenderder_tpu.ops import post
from tinyrenderder_tpu.scene import Scene
from tinyrenderder_tpu.shaders import EyeShader, PhongShader
from tinyrenderder_tpu.utils import tga

log = logging.getLogger("tinyrenderder_tpu.cli")

# Render constants (main.cpp:26-30)
WIDTH = 1200
HEIGHT = 800
DEFAULT_MODEL_PATH = "obj/african_head/african_head.obj"
# the default scene's key light (main.cpp:615): ONE constant so the
# shadow pass always casts from the same direction the shaders light
KEY_LIGHT_DIR = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
EYES_MODEL_PATH = "obj/african_head/african_head_eye_inner.obj"
SPONZA_MODEL_PATH = "obj/sponza/sponza.obj"


def _load_or_procedural(manager: ModelManager, path: str, kind: str,
                        explicit: bool = False) -> Mesh:
    if os.path.exists(path):
        mesh = manager.load_model(path)
        if mesh is not None:
            return mesh
        if explicit:
            # the user pointed at a real file that failed to parse:
            # silently rendering a stand-in sphere would be a lie
            raise SystemExit(f"error: failed to load model: {path}")
        log.warning("%s exists but failed to load — using procedural "
                    "stand-in", path)
    else:
        log.warning("%s not found — using procedural stand-in", path)
    if kind == "head":
        mesh = procedural.bumpy_head(n_lat=32, n_lon=48)
        mesh.materials = [procedural.default_head_material()]
        return mesh
    if kind == "eyes":
        eyes = procedural.uv_sphere(n_lat=8, n_lon=12, radius=0.12, name="eyes")
        eyes.positions += np.array([0.35, 0.25, 0.8])
        eyes.finalize()
        eyes.materials = [procedural.default_head_material()]
        return eyes
    # sponza stand-in: a big inward-facing box room; sized so that the
    # reference's 0.014 sponza scale (main.cpp:506-507) leaves a ~56-unit
    # room enclosing the default camera.  Rebuild WITHOUT cube()'s
    # authored (outward) normals so finalize() regenerates them from the
    # flipped winding — flipping faces alone left every wall lit from
    # behind (normals opposite the visible side)
    out = procedural.cube(size=4000.0)
    room = Mesh(positions=out.positions, faces=out.faces[:, ::-1].copy(),
                uvs=out.uvs, name="sponza_standin").finalize()
    room.materials = [procedural.default_head_material(128)]
    return room


def build_default_scene(head_path: str | None = None,
                        width: int = WIDTH, height: int = HEIGHT,
                        manager: ModelManager | None = None) -> Scene:
    """The main.cpp default scene: model matrices (main.cpp:506-513),
    camera (main.cpp:585-597), lights (main.cpp:615-617), shader
    assignments (main.cpp:655-657, :688-689, :711-712)."""
    manager = manager or ModelManager.instance()
    head = _load_or_procedural(manager, head_path or DEFAULT_MODEL_PATH,
                               "head", explicit=head_path is not None)
    eyes = _load_or_procedural(manager, EYES_MODEL_PATH, "eyes")
    sponza = _load_or_procedural(manager, SPONZA_MODEL_PATH, "sponza")

    sponza_matrix = math3d.scale_matrix(0.014, 0.014, 0.014)
    head_matrix = (math3d.translation_matrix(0.0, 1.6815, 0.0)
                   @ math3d.rotation_y(-112.82 * math.pi / 180.0))
    eye_matrix = head_matrix

    camera = Camera()
    camera.set_eye(math3d.vec3(-3.4019, 2.2001, 1.8026))
    camera.set_target(math3d.vec3(1.3555, 1.5116, -0.9686))
    camera.set_up(math3d.vec3(0, 1, 0))
    camera.set_fov(70.0)
    camera.set_aspect(width / height)
    camera.set_clipping(0.05, 500.0)

    key_light = KEY_LIGHT_DIR
    fill_light = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim_light = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))

    scene = Scene(camera=camera, width=width, height=height)
    scene.add(sponza, sponza_matrix,
              PhongShader(key_light, fill_light, rim_light,
                          normal_map_strength=0.5),
              name="sponza")
    scene.add(head, head_matrix,
              PhongShader(key_light, fill_light, rim_light),
              name="head")
    scene.add(eyes, eye_matrix,
              EyeShader(key_light, rim_light),
              name="eyes", exclude_from_output_depth=True)
    return scene


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tinyrenderder_tpu — software rasterizer on JAX")
    parser.add_argument("model", nargs="?", default=None,
                        help="head model path override (reference argv[1]); "
                             "formats: .obj/.ply/.stl/.gltf/.glb/.dae/.fbx")
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--backend", default=None,
                        choices=["xla", "tiled", "oracle", "sharded",
                                 "sharded-2d", "sharded-geometry",
                                 "sharded-measured"],
                        help="default: tiled (the production sparse "
                             "pipeline with the resolve kernel) on the GPU, "
                             "xla on the CPU")
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--no-cull", action="store_true",
                        help="disable per-model frustum culling")
    parser.add_argument("--no-ssao", action="store_true")
    parser.add_argument("--image-only", action="store_true",
                        help="write ONLY phong.tga (the frame image is "
                             "the sole deliverable — single-color-pass "
                             "scenes route through the direct-to-image "
                             "fused pipeline; others fall back to the "
                             "full render, same colors)")
    parser.add_argument("--shadows", action="store_true",
                        help="two-pass hard shadow mapping from the key light")
    parser.add_argument("--shadow-size", type=int, default=1024)
    parser.add_argument("--animate", type=int, default=0, metavar="N",
                        help="render an N-frame orbit animation "
                             "(resumable via <outdir>/checkpoint.json)")
    parser.add_argument("--profile", action="store_true",
                        help="dump a jax.profiler trace to <outdir>/trace")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    # JAX_PLATFORMS=cpu selects the CPU; JAX reads it itself
    from tinyrenderder_tpu.ops import device
    device.use_compile_cache()
    if args.backend is None:
        args.backend = "tiled" if device.platform() == "gpu" else "xla"

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(message)s")
    log.info("=== tinyrenderder_tpu: renderer with ModelManager and frustum culling ===")

    scene = build_default_scene(args.model, args.width, args.height)
    log.info("%s", scene.describe())
    scene.camera.print_info()

    if args.animate:
        for flag, on in (("--shadows", args.shadows),
                         ("--profile", args.profile)):
            if on:
                log.warning("%s is not supported with --animate and is "
                            "ignored", flag)
        from tinyrenderder_tpu.animation import AnimationConfig, render_animation
        cfg = AnimationConfig(frames=args.animate, backend=args.backend,
                              outdir=args.outdir,
                              frustum_cull=not args.no_cull)
        summary = render_animation(scene, cfg)
        log.info("animation: %d frames in %.1f s (%.2f fps), resumed at %d",
                 summary["frames_rendered"], summary["seconds"],
                 summary["fps"], summary["resumed_at"])
        return 0

    profiler_cm = None
    if args.profile:
        import jax
        profiler_cm = jax.profiler.trace(os.path.join(args.outdir, "trace"))
        profiler_cm.__enter__()

    try:
        return _render_and_write(args, scene)
    finally:
        # finalize the trace even when the render raises — the trace of
        # a failing run is exactly the artifact worth keeping
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
            log.info("Saved profiler trace to %s/trace", args.outdir)


def _render_and_write(args, scene) -> int:
    t0 = time.perf_counter()
    if args.image_only:
        if args.shadows:
            log.warning("--shadows is not supported with --image-only "
                        "and is ignored")
        # same guard as the full path's models_rendered > 0 check: a
        # fully-culled scene must not clobber a previous phong.tga
        # with a background-only frame
        from tinyrenderder_tpu.scene import _cull_passes
        from tinyrenderder_tpu.utils.stats import RenderStats
        if not _cull_passes(scene, not args.no_cull, RenderStats()):
            log.warning("every model culled — phong.tga not written")
            return 0
        image = scene.render_image(backend=args.backend,
                                   frustum_cull=not args.no_cull)
        log.info("Render time: %.3f s (%s, image-only)",
                 time.perf_counter() - t0, args.backend)
        os.makedirs(args.outdir, exist_ok=True)
        tga.TGAImage.from_rgb(np.asarray(image)).write_tga_file(
            os.path.join(args.outdir, "phong.tga"))
        log.info("Saved: phong.tga")
        return 0
    if args.shadows:
        from tinyrenderder_tpu.shadows import ShadowSettings, render_with_shadows
        key_light = KEY_LIGHT_DIR       # the scene's key light: shadows
        result, _shadow_map = render_with_shadows(      # track it always
            scene, key_light, ShadowSettings(size=args.shadow_size),
            backend=args.backend, frustum_cull=not args.no_cull)
    else:
        result = scene.render(backend=args.backend,
                              frustum_cull=not args.no_cull)
    render_s = time.perf_counter() - t0
    log.info("Render time: %.3f s (%s)", render_s, args.backend)
    for name, dt in result.pass_timings.items():
        log.info("  pass %-10s %.3f s", name, dt)

    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)

    if result.stats.models_rendered > 0:
        tga.TGAImage.from_rgb(result.color).write_tga_file(
            os.path.join(outdir, "phong.tga"))
        log.info("Saved: phong.tga")

    if args.backend != "oracle" and not args.no_ssao:
        # one fused device dispatch for z-viz + SSAO + composite
        zimg_d, ao_d, final_d = post.postprocess_device(
            result.color, np.asarray(result.depth, dtype=np.float32))
        zimg, ao_u8, final = (np.asarray(zimg_d), np.asarray(ao_d),
                              np.asarray(final_d))
    else:
        depth = np.asarray(result.depth, dtype=np.float64)
        zimg = post.zbuffer_to_image(depth, np)
        ao_u8 = final = None
        if not args.no_ssao:
            ao_u8 = post.ssao_image(post.ssao_map(depth, np), np)
            final = post.composite(result.color, ao_u8, np)

    tga.TGAImage.from_rgb(np.repeat(zimg[..., None], 3, axis=-1)).write_tga_file(
        os.path.join(outdir, "zbuffer.tga"))
    log.info("Saved: zbuffer.tga")

    if not args.no_ssao:
        tga.TGAImage.from_rgb(np.repeat(ao_u8[..., None], 3, axis=-1)).write_tga_file(
            os.path.join(outdir, "ao.tga"))
        log.info("Saved: ao.tga")

        if result.stats.models_rendered > 0:
            tga.TGAImage.from_rgb(np.asarray(final)).write_tga_file(
                os.path.join(outdir, "final.tga"))
            log.info("Saved: final.tga")

    log.info("%s", result.stats.describe())
    log.info("%s", result.stats.culling_report())
    return 0


def main(argv=None) -> None:
    sys.exit(run(argv))


if __name__ == "__main__":
    main()
