"""Shared test helpers: standard small scenes and parity assertions."""

import numpy as np

from tinyrenderder_tpu import math3d, oracle
from tinyrenderder_tpu.models import procedural


def default_view(eye=(0, 0.5, 3), target=(0, 0, 0), fov=60.0, aspect=1.0,
                 near=0.1, far=50.0):
    view = math3d.lookat(eye, target, (0, 1, 0))
    proj = math3d.perspective(fov, aspect, near, far)
    return view, proj


def make_pass(mesh, shader, view, proj, model_matrix=None, dtype=np.float32,
              material_index=0):
    model_matrix = np.eye(4) if model_matrix is None else model_matrix
    modelview = view @ model_matrix
    material = mesh.materials[material_index] if mesh.materials else None
    uniforms = shader.build_uniforms(modelview, proj, material, dtype)
    attrs = mesh.face_attributes(dtype)
    return oracle.OraclePass(attrs=attrs, shader=shader, uniforms=uniforms)


def render_oracle(passes, w, h, dtype=np.float32):
    return oracle.render_passes(list(passes), w, h, dtype=dtype)


def render_engine(passes, w, h, backend="xla"):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster
    if backend == "tiled":
        from tinyrenderder_tpu.ops import raster_tiled
        pass_fn = raster_tiled.render_pass_tiled
    else:
        pass_fn = raster.render_pass_xla

    fb = raster.new_framebuffers(w, h)
    offset = 0
    for p in passes:
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb, _ = pass_fn(fb, attrs, p.shader, p.uniforms, winner_offset=offset)
        offset += attrs["position"].shape[0]
    return fb


def assert_parity(frame: "oracle.OracleFrame", fb, max_color_lsb=1,
                  depth_ulps=8, require_same_winners=True):
    """The engine-vs-oracle contract: identical coverage, winner map within
    the depth tolerance, depth within `depth_ulps` ulps (ill-conditioned
    triangles amplify evaluation-order differences; real scenes match
    bitwise), color within `max_color_lsb`."""
    color = np.asarray(fb.color)
    depth = np.asarray(fb.depth).astype(np.float32)
    oz = frame.zbuffer.astype(np.float32)

    cov_oracle = np.isfinite(oz)
    cov_engine = np.isfinite(depth)
    mismatch = cov_oracle != cov_engine
    assert not mismatch.any(), f"coverage differs at {np.argwhere(mismatch)[:5]}"

    both = cov_oracle
    if both.any():
        a = depth[both].view(np.int32).astype(np.int64)
        b = oz[both].view(np.int32).astype(np.int64)
        ulps = np.abs(a - b)
        assert ulps.max() <= depth_ulps, f"depth differs by {ulps.max()} ulps"

    dc = np.abs(color.astype(np.int64) - frame.color.astype(np.int64))
    assert dc.max() <= max_color_lsb, (
        f"color delta {dc.max()} at {np.argwhere((dc > max_color_lsb).any(-1))[:5]}")


def standard_meshes():
    head = procedural.bumpy_head(12, 16)
    head.materials = [procedural.default_head_material(32)]
    sphere = procedural.uv_sphere(10, 14)
    sphere.materials = [procedural.default_head_material(16)]
    soup = procedural.triangle_soup(40)
    return {"head": head, "sphere": sphere, "soup": soup,
            "plane": procedural.plane(3.0, -1.0), "cube": procedural.cube()}
