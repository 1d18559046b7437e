"""Generate a reference-scale on-disk asset set (african_head stand-in).

The reference repo ships no obj/ assets (main.cpp:478 loads
obj/african_head/african_head.obj at ~25k faces with real texture maps),
so parity tests need a real-scale asset that exercises the full DISK
pipeline: OBJ text -> tokenizer -> Mesh, MTL -> texture probing -> TGA
codec -> Material.  This script writes a deterministic 27360-face head
OBJ + MTL + three TGA maps (diffuse / object-space normal / specular),
and (with --golden) pins the CLI render of that asset as a golden TGA.

Usage:
    JAX_PLATFORMS=cpu python scripts/gen_real_asset.py <outdir> [--golden]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
for _f in ("--xla_force_host_platform_device_count=8",
           "--xla_cpu_max_isa=AVX",
           "--xla_allow_excess_precision=false"):
    if _f.split("=")[0] not in _flags:
        _flags = (_flags + " " + _f).strip()
os.environ["XLA_FLAGS"] = _flags

import numpy as np  # noqa: E402

GOLDEN_W, GOLDEN_H = 160, 100


def head_mesh():
    """The reference-scale head: 27360 faces (african_head is ~25k)."""
    from tinyrenderder_tpu.models import procedural
    mesh = procedural.bumpy_head(96, 144)
    mesh.materials = [procedural.default_head_material(256)]
    return mesh


def write_obj(mesh, path: str, mtl_rel: str | None = None,
              material_name: str = "head_mat") -> None:
    """Serialize a Mesh to OBJ text with full float64 round-trip precision
    (repr = shortest exact decimal).  The loader applies FlipUVs
    (v' = 1 - v), so vt rows store 1 - v."""
    def r(x):                      # repr of the PYTHON float: exact decimal
        return repr(float(x))

    lines = ["# generated by scripts/gen_real_asset.py"]
    if mtl_rel:
        lines.append(f"mtllib {mtl_rel}")
    for p in mesh.positions:
        lines.append(f"v {r(p[0])} {r(p[1])} {r(p[2])}")
    for t in mesh.uvs:
        lines.append(f"vt {r(t[0])} {r(1.0 - float(t[1]))}")
    for n in mesh.normals:
        lines.append(f"vn {r(n[0])} {r(n[1])} {r(n[2])}")
    if mtl_rel:
        lines.append(f"usemtl {material_name}")
    for f in mesh.faces:
        lines.append("f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in f))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def generate(outdir: str) -> str:
    """Write head.obj + head.mtl + 3 texture TGAs; returns the OBJ path."""
    from tinyrenderder_tpu.utils import tga
    os.makedirs(outdir, exist_ok=True)
    mesh = head_mesh()
    mat = mesh.materials[0]
    # vflip=False: descriptor top-left, so read().to_rgb() round-trips to
    # the exact material bytes (write default vflip=True reverses rows)
    for kind, img in (("diffuse", mat.diffuse), ("nm", mat.normal),
                      ("spec", mat.specular)):
        arr = img if img.ndim == 3 else img[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        tga.write(tga.TGAImage.from_rgb(arr),
                  os.path.join(outdir, f"head_{kind}.tga"), vflip=False)
    with open(os.path.join(outdir, "head.mtl"), "w") as fh:
        fh.write("newmtl head_mat\n"
                 "map_Kd head_diffuse.tga\n"
                 "map_Bump head_nm.tga\n"
                 "map_Ks head_spec.tga\n")
    obj_path = os.path.join(outdir, "head.obj")
    write_obj(mesh, obj_path, mtl_rel="head.mtl")
    return obj_path


def render_cli(obj_path: str, outdir: str, backend: str = "tiled") -> None:
    from tinyrenderder_tpu import cli
    cli.run([obj_path, "--width", str(GOLDEN_W), "--height", str(GOLDEN_H),
             "--backend", backend, "--outdir", outdir])


def main() -> int:
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/real_asset"
    obj_path = generate(outdir)
    print("wrote", obj_path)
    if "--golden" in sys.argv:
        import shutil
        import tempfile
        golden_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "golden")
        with tempfile.TemporaryDirectory() as td:
            render_cli(obj_path, td, backend="tiled")
            for name in ("phong", "final"):
                dst = os.path.join(golden_dir, f"real_head_cli_{name}.tga")
                shutil.copy(os.path.join(td, f"{name}.tga"), dst)
                print("pinned", dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
