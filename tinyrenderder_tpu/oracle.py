"""CPU oracle: slow, obviously-correct NumPy renderer.

This is the correctness anchor for the whole framework — an independent,
serial re-implementation of the reference rasterizer's control flow
(our_gl.cpp:89-201, detailed in SURVEY.md §3.3), against which the
parallel engine is validated pixel-exactly:

  * triangles processed one at a time in submission order
  * per-triangle whole-triangle rejects (w <= 1e-12 / all-z-outside /
    NaN / back-face / empty clamped bbox)
  * per-pixel: affine barycentric coverage (NaN-tolerant ``not (b < 0)``
    like the C++ comparison chain), affine z interpolation, z *test before
    shading* with strict less-than, perspective-correct attribute
    interpolation, fragment shade, depth+color write

Shading and the discontinuous decision formulas are shared with the engine
(tinyrenderder_tpu.shaders / ops.semantics) so that a float32 oracle run is
bit-comparable to the device; the *orchestration* (the racy-looking
read-modify-write the reference does serially) is what this module pins
down.  Run with dtype=float64 to reproduce the reference's double math.

Stats are exact, including overdraw in fragments_drawn (our_gl.cpp:194).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import semantics
from tinyrenderder_tpu.shaders import Shader, finalize_color
from tinyrenderder_tpu.utils.stats import RenderStats

__all__ = ["OraclePass", "OracleFrame", "render_pass", "render_passes"]


@dataclass
class OraclePass:
    """One mesh+shader submission, mirroring a main.cpp render block
    (e.g. main.cpp:647-668)."""

    attrs: dict                      # {name: (F, 3, C)} face-corner attributes
    shader: Shader
    uniforms: dict                   # from shader.build_uniforms(..., dtype)


@dataclass
class OracleFrame:
    color: np.ndarray                # (H, W, 3) uint8 RGB
    zbuffer: np.ndarray              # (H, W) dtype, +inf where empty
    stats: RenderStats = field(default_factory=RenderStats)
    #: (H, W) int32 id of the triangle that last passed the z-test
    #: (ids count across passes in submission order), -1 where empty
    winner: np.ndarray | None = None


def _new_frame(width: int, height: int, dtype) -> OracleFrame:
    return OracleFrame(
        color=np.zeros((height, width, 3), dtype=np.uint8),
        zbuffer=np.full((height, width), np.inf, dtype=dtype),
        winner=np.full((height, width), -1, dtype=np.int32),
    )


def render_pass(frame: OracleFrame, p: OraclePass, width: int, height: int,
                dtype=np.float64, winner_offset: int = 0) -> None:
    """Rasterize every face of one pass into the frame, in order.
    ``winner_offset``: id of this pass's first triangle in the frame's
    winner map."""
    xp = np
    attrs = {k: np.asarray(v, dtype=dtype) for k, v in p.attrs.items()}
    uniforms = dict(p.uniforms)
    clip, varyings = p.shader.vertex(uniforms, attrs, xp)
    clip = np.asarray(clip, dtype=dtype)

    vp = math3d.viewport(0, 0, width, height).astype(dtype)
    setup = semantics.triangle_setup_planes(clip, vp, width, height, xp)

    nfaces = clip.shape[0]
    st = frame.stats
    st.triangles_rasterized += nfaces

    zbuf = frame.zbuffer
    color = frame.color
    if frame.winner is None:
        frame.winner = np.full(zbuf.shape, -1, dtype=np.int32)

    for f in range(nfaces):
        if not bool(setup["valid"][f]):
            continue
        min_x, max_x, min_y, max_y = (int(v) for v in setup["bbox"][f])
        st.merge_bbox(min_x, min_y, max_x, max_y)

        screen = setup["screen"][f]          # (3, 2)
        ndc_z = setup["ndc_z"][f]            # (3,)
        w = setup["clip_w"][f]               # (3,)

        xs = np.arange(min_x, max_x + 1)
        ys = np.arange(min_y, max_y + 1)
        px = (xs.astype(dtype) + dtype(0.5))[None, :]   # (1, W')
        py = (ys.astype(dtype) + dtype(0.5))[:, None]   # (H', 1)

        b0, b1, b2, _ = semantics.barycentric(
            screen[0, 0], screen[0, 1], screen[1, 0], screen[1, 1],
            screen[2, 0], screen[2, 1], px, py, xp)
        covered = semantics.coverage_mask(b0, b1, b2)

        z = semantics.affine_z(ndc_z[0], ndc_z[1], ndc_z[2], b0, b1, b2)
        covered &= np.isfinite(z)

        tile = zbuf[min_y:max_y + 1, min_x:max_x + 1]
        mask = covered & (z < tile)          # strict less: first drawn wins
        if not mask.any():
            continue

        midx = np.nonzero(mask)
        zwin = z[midx]
        frame.winner[min_y:max_y + 1, min_x:max_x + 1][midx] = (
            f + winner_offset)
        if not p.shader.writes_color:    # depth-only pass: skip shading
            tile[midx] = zwin
            st.fragments_drawn += int(mask.sum())
            st.merge_z(float(zwin.min()), float(zwin.max()))
            continue

        pb0, pb1, pb2 = semantics.perspective_correct_bary(
            b0, b1, b2, w[0], w[1], w[2], xp)

        vary_pix = {}
        for name, vv in varyings.items():
            v0, v1, v2 = (np.asarray(vv[f, k], dtype=dtype) for k in range(3))
            vary_pix[name] = semantics.interp3(
                v0[None, :], v1[None, :], v2[None, :],
                pb0[midx][:, None], pb1[midx][:, None], pb2[midx][:, None])
        rgb = p.shader.fragment(uniforms, vary_pix, xp)
        out = finalize_color(rgb, xp)

        tile[midx] = zwin
        color[min_y:max_y + 1, min_x:max_x + 1][midx] = out

        st.fragments_drawn += int(mask.sum())
        st.merge_z(float(zwin.min()), float(zwin.max()))


def render_passes(passes: list[OraclePass], width: int, height: int,
                  dtype=np.float64, frame: OracleFrame | None = None) -> OracleFrame:
    """Render a list of passes into one frame (fresh unless given)."""
    if frame is None:
        frame = _new_frame(width, height, dtype)
    offset = 0
    for p in passes:
        render_pass(frame, p, width, height, dtype=dtype,
                    winner_offset=offset)
        offset += int(np.asarray(p.attrs["position"]).shape[0])
    return frame
