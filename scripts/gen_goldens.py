"""Regenerate the golden TGA fixtures in tests/golden/.

Goldens are rendered by the deterministic XLA CPU engine path: they pin
the engine's exact output across refactors/rounds (live oracle-parity
tests separately pin engine-vs-oracle at each run).  Run only after an
INTENTIONAL semantics change, never to paper over a diff:
    JAX_PLATFORMS=cpu python scripts/gen_goldens.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

# identical backend + rounding environment to tests/conftest.py — a
# different XLA flag set compiles differently-rounded programs and the
# goldens would differ at z-tie edge pixels
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
for _f in ("--xla_force_host_platform_device_count=8",
           "--xla_cpu_max_isa=AVX",
           "--xla_allow_excess_precision=false"):
    if _f.split("=")[0] not in _flags:
        _flags = (_flags + " " + _f).strip()
os.environ["XLA_FLAGS"] = _flags

import numpy as np

from helpers import (default_view, make_pass, render_engine,
                     standard_meshes)
from tinyrenderder_tpu.shaders import (EyeShader, FlatShader, GouraudShader,
                                       PhongShader, TexturedShader)
from tinyrenderder_tpu.utils import tga


def postprocess_golden():
    """Full post pipeline (z-viz + SSAO + composite) over the multi-pass
    scene — pins ops/post.py end to end."""
    import numpy as np

    from tinyrenderder_tpu.ops import post

    passes = golden_configs()["multi_pass"]
    fb = render_engine(passes, W, H, backend="xla")
    color = np.asarray(fb.color)
    depth = np.asarray(fb.depth, dtype=np.float64)
    zimg = post.zbuffer_to_image(depth, np)
    ao_u8 = post.ssao_image(post.ssao_map(depth, np), np)
    final = post.composite(color, ao_u8, np)
    return np.stack([zimg, ao_u8], axis=-1), final

W, H = 96, 72
KEY = np.array([1.0, 1.4, 1.0])
FILL = np.array([-0.3, 0.5, 0.2])
RIM = np.array([-1.0, 0.8, -1.5])


def golden_configs():
    meshes = standard_meshes()
    view, proj = default_view()

    def p(mesh, shader):
        return make_pass(meshes[mesh], shader, view, proj)

    return {
        "flat_head": [p("head", FlatShader(light_world=(0.3, 0.4, 1.0)))],
        "gouraud_head": [p("head", GouraudShader(light_world=(0.3, 0.4, 1.0)))],
        "textured_head": [p("head", TexturedShader())],
        "phong_nm_head": [p("head", PhongShader(KEY, FILL, RIM,
                                                normal_map_strength=0.5))],
        "eye_sphere": [p("sphere", EyeShader(KEY, RIM))],
        "multi_pass": [p("head", PhongShader(KEY, FILL, RIM)),
                       p("plane", TexturedShader()),
                       p("soup", GouraudShader())],
    }


def main():
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden")
    os.makedirs(out_dir, exist_ok=True)
    for name, passes in golden_configs().items():
        fb = render_engine(passes, W, H, backend="xla")
        color = np.asarray(fb.color)
        path = os.path.join(out_dir, f"{name}.tga")
        tga.TGAImage.from_rgb(color).write_tga_file(path)
        covered = int(np.isfinite(np.asarray(fb.depth)).sum())
        print(f"wrote {path} ({covered} covered px)")

    zao, final = postprocess_golden()
    zimg3 = np.repeat(zao[..., 0:1], 3, axis=-1)
    ao3 = np.repeat(zao[..., 1:2], 3, axis=-1)
    for name, img in (("post_zbuffer", zimg3), ("post_ao", ao3),
                      ("post_final", final)):
        path = os.path.join(out_dir, f"{name}.tga")
        tga.TGAImage.from_rgb(img).write_tga_file(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
