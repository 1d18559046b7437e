"""Measure the REFERENCE renderer's hot-loop throughput on this host.

Builds tests/ref_harness/driver.cpp against the read-only reference
sources and times `rasterize` (our_gl.cpp:89-201) on the SAME triangle
streams bench.py renders, giving measured reference numbers where none
were published:

  head    the headline config's 27k-face head (bench.py _scene(meshes=1))
  stress  the 246k-triangle head wall (bench.bench_stress geometry) —
          the reference's own default workload scale (Sponza ~246k
          triangles, main.cpp:483-513)
  mixed   the mixed-interior clip stream (12 giant room triangles +
          ~250k tiny, bench.bench_mixed geometry)

The driver's IdShader is strictly CHEAPER than the reference's real
PhongShader (no texture fetches, no lighting), and the binary has no
Assimp/IO overhead — so the printed number flatters the reference and
any speedup over the reference derived from it is conservative.

Usage (builds the streams on the CPU, never on the card):
    JAX_PLATFORMS=cpu python scripts/bench_reference_cpu.py \
        [width height reps [stream]]
"""

import os
import re
import struct
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

REF = "/root/reference"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def build_stream(stream: str, width: int, height: int) -> np.ndarray:
    """The exact clip-space triangle stream of the named bench config,
    computed in float64 like the reference."""
    bench = _load_bench()
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.shaders import PhongShader

    key, fill, rim = bench._lights()
    shader = PhongShader(key, fill, rim, normal_map_strength=0.5)
    if stream == "head":
        # headline geometry/camera (27360-face head, eye (0, 0.4, 2.6))
        mesh = bench._head(96, 144)
        cam = bench._camera(width, height)
        view, proj = cam.view_matrix, cam.projection_matrix
    elif stream in ("stress", "mixed"):
        # bench_stress / bench_mixed geometry + camera verbatim
        from tinyrenderder_tpu.models import procedural
        mesh = (procedural.head_wall(grid=3) if stream == "stress"
                else procedural.mixed_interior(grid=3))
        view = math3d.lookat((0, 0.3, 6.5), (0, 0, 0), (0, 1, 0))
        proj = math3d.perspective(60.0, width / height, 0.1, 50.0)
    else:
        raise SystemExit(f"unknown stream {stream!r}")
    attrs = {k: np.asarray(v, np.float64)
             for k, v in mesh.face_attributes(np.float64).items()}
    uniforms = shader.build_uniforms(view, proj, None, np.float64)
    clip, _ = shader.vertex(uniforms, attrs, np)
    return np.ascontiguousarray(clip, dtype=np.float64)


def main():
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    height = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    stream = sys.argv[4] if len(sys.argv) > 4 else "head"

    clip = build_stream(stream, width, height)
    print(f"scene: stream={stream} {clip.shape[0]} faces at "
          f"{width}x{height}", file=sys.stderr)

    exe = "/tmp/refharness_bench/refdriver"
    os.makedirs(os.path.dirname(exe), exist_ok=True)
    subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{REF}",
         os.path.join(REPO, "tests", "ref_harness", "driver.cpp"),
         os.path.join(REF, "our_gl.cpp"), os.path.join(REF, "tgaimage.cpp"),
         "-o", exe], check=True)

    inp = "/tmp/refharness_bench/tris.bin"
    with open(inp, "wb") as f:
        f.write(struct.pack("<iii", width, height, clip.shape[0]))
        f.write(clip.tobytes())

    secs, frags = [], None
    for _ in range(reps):
        proc = subprocess.run(
            [exe, inp, "/tmp/refharness_bench/z.bin",
             "/tmp/refharness_bench/win.bin"],
            check=True, capture_output=True, text=True)
        secs.append(float(re.search(
            r"rasterize_seconds=([0-9.]+)", proc.stderr).group(1)))
        frags = int(re.search(
            r"fragments_drawn=(\d+)", proc.stderr).group(1))
    best = min(secs)
    mpix = width * height / best / 1e6
    print(f"reference hot loop ({reps} reps, best): {best * 1e3:.1f} ms/frame"
          f" = {mpix:.2f} Mpix/s frame-rate-equivalent,"
          f" {frags / best / 1e6:.2f} M z-pass-fragments/s"
          f" (IdShader — cheaper than the reference's real Phong;"
          f" numbers flatter the reference)")


if __name__ == "__main__":
    main()
