"""Engine-vs-oracle parity: the core correctness tests.

The CPU oracle (serial, reference control flow) is the golden
implementation; the XLA two-phase engine must reproduce its coverage
exactly, depth to within a few ulp (bitwise on real scenes, on the CPU
without FMA and on the GPU) and
color to <= 1 LSB per channel at every pixel.
"""

import numpy as np
import pytest

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.shaders import (
    DepthShader, EyeShader, FlatShader, GouraudShader, PhongShader,
    TexturedShader)

from helpers import (assert_parity, default_view, make_pass, render_engine,
                     render_oracle, standard_meshes)

MESHES = standard_meshes()
KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


def shaders_to_test():
    return [
        ("flat", FlatShader(light_world=KEY)),
        ("gouraud", GouraudShader(light_world=KEY)),
        ("textured", TexturedShader(light_world=KEY)),
        ("phong", PhongShader(KEY, FILL, RIM)),
        ("phong_half_nm", PhongShader(KEY, FILL, RIM, normal_map_strength=0.5)),
        ("eye", EyeShader(KEY, RIM)),
        ("depth", DepthShader()),
    ]


@pytest.mark.parametrize("shader_name,shader", shaders_to_test())
def test_single_mesh_parity(shader_name, shader):
    view, proj = default_view()
    p = make_pass(MESHES["head"], shader, view, proj)
    frame = render_oracle([p], 96, 96)
    fb = render_engine([p], 96, 96)
    assert frame.stats.fragments_drawn > 0, "scene must actually draw"
    assert_parity(frame, fb)


def test_multi_pass_depth_interaction():
    """Overlapping meshes across passes: later pass loses on equal depth."""
    view, proj = default_view(eye=(0, 1.5, 4))
    passes = [
        make_pass(MESHES["plane"], FlatShader(light_world=(0, 1, 0.3)), view, proj),
        make_pass(MESHES["sphere"], GouraudShader(light_world=KEY), view, proj,
                  model_matrix=math3d.translation_matrix(0, 0, 0)),
        make_pass(MESHES["cube"], FlatShader(light_world=KEY, base_color=(50, 200, 90)),
                  view, proj,
                  model_matrix=(math3d.translation_matrix(0.9, 0, 0.6)
                                @ math3d.rotation_y(0.7))),
    ]
    frame = render_oracle(passes, 128, 128)
    fb = render_engine(passes, 128, 128)
    assert frame.stats.fragments_drawn > 0
    assert_parity(frame, fb)


def test_same_mesh_twice_first_wins():
    """Identical geometry submitted twice with different shaders: strict-less
    z-test means the first submission keeps every pixel."""
    view, proj = default_view()
    p1 = make_pass(MESHES["sphere"], FlatShader(light_world=KEY,
                                                base_color=(255, 0, 0)), view, proj)
    p2 = make_pass(MESHES["sphere"], FlatShader(light_world=KEY,
                                                base_color=(0, 255, 0)), view, proj)
    frame = render_oracle([p1, p2], 64, 64)
    fb = render_engine([p1, p2], 64, 64)
    assert_parity(frame, fb)
    covered = np.isfinite(frame.zbuffer)
    # all covered pixels are red-ish (first pass won everywhere)
    assert (np.asarray(fb.color)[covered][:, 1] == 0).all()


def test_triangle_soup_edge_cases():
    """Random soup including slivers/degenerates: coverage decisions must
    still agree exactly."""
    view, proj = default_view(eye=(0, 0, 3.5))
    p = make_pass(MESHES["soup"], GouraudShader(light_world=KEY), view, proj)
    frame = render_oracle([p], 128, 128)
    fb = render_engine([p], 128, 128)
    assert_parity(frame, fb)


def test_clipping_rejects_behind_camera():
    """Geometry behind the camera (w <= 0) must be rejected whole."""
    view, proj = default_view(eye=(0, 0, 0.5), target=(0, 0, 1))  # looking +z
    p = make_pass(MESHES["sphere"], FlatShader(light_world=KEY), view, proj,
                  model_matrix=math3d.translation_matrix(0, 0, -5))
    frame = render_oracle([p], 48, 48)
    fb = render_engine([p], 48, 48)
    assert frame.stats.fragments_drawn == 0
    assert not np.isfinite(np.asarray(fb.depth)).any()


def test_partially_offscreen():
    view, proj = default_view()
    p = make_pass(MESHES["sphere"], GouraudShader(light_world=KEY), view, proj,
                  model_matrix=math3d.translation_matrix(1.5, 1.2, 0))
    frame = render_oracle([p], 80, 80)
    fb = render_engine([p], 80, 80)
    assert frame.stats.fragments_drawn > 0
    assert_parity(frame, fb)


def test_backface_culling():
    """A plane viewed from behind draws nothing (cross <= 0 reject)."""
    view, proj = default_view(eye=(0, -2, 0.0001), target=(0, 0, 0))
    p = make_pass(MESHES["plane"], FlatShader(), view, proj)
    frame = render_oracle([p], 48, 48)
    fb = render_engine([p], 48, 48)
    assert frame.stats.fragments_drawn == 0
    assert not np.isfinite(np.asarray(fb.depth)).any()


def test_winner_map_matches_oracle_overdraw_order():
    """Engine winner ids reproduce the oracle's final visible triangle per
    pixel (checked via depth equality on a multi-object scene)."""
    view, proj = default_view(eye=(2, 2, 4))
    passes = [
        make_pass(MESHES["head"], PhongShader(KEY, FILL, RIM), view, proj),
        make_pass(MESHES["plane"], FlatShader(light_world=(0, 1, 0)), view, proj),
    ]
    frame = render_oracle(passes, 96, 96)
    fb = render_engine(passes, 96, 96)
    assert_parity(frame, fb)


def test_f32_vs_f64_oracle_divergence_is_edge_only():
    """The f32/f64 oracle comparison: differing pixels must be rare
    (coverage flips at triangle edges only)."""
    view, proj = default_view()
    shader = GouraudShader(light_world=KEY)
    p32 = make_pass(MESHES["head"], shader, view, proj, dtype=np.float32)
    p64 = make_pass(MESHES["head"], shader, view, proj, dtype=np.float64)
    f32 = render_oracle([p32], 96, 96, dtype=np.float32)
    f64 = render_oracle([p64], 96, 96, dtype=np.float64)
    cov32 = np.isfinite(f32.zbuffer)
    cov64 = np.isfinite(f64.zbuffer)
    flips = (cov32 != cov64).sum()
    assert flips <= 0.002 * cov64.sum() + 5
    both = cov32 & cov64
    dc = np.abs(f32.color[both].astype(int) - f64.color[both].astype(int))
    assert np.percentile(dc, 99.9) <= 1


def test_depth_only_shader_skips_color():
    """DepthShader (writes_color=False) must produce depth but leave the
    color buffer untouched, identically on every backend."""
    import numpy as np

    from helpers import default_view, make_pass, render_engine, render_oracle, standard_meshes
    from tinyrenderder_tpu.shaders import DepthShader

    meshes = standard_meshes()
    view, proj = default_view()
    p = make_pass(meshes["head"], DepthShader(), view, proj)

    frame = render_oracle([p], 64, 48)
    assert np.isfinite(frame.zbuffer).any()
    assert (frame.color == 0).all()

    for backend in ("xla", "tiled"):
        fb = render_engine([p], 64, 48, backend=backend)
        d = np.asarray(fb.depth)
        assert (np.isfinite(d) == np.isfinite(frame.zbuffer)).all(), backend
        assert (np.asarray(fb.color) == 0).all(), backend


def test_build_pair_records_zero_faces():
    """A zero-face pass must not crash the public record builder
    (regression: a gather from a 0-row table fails at trace time): the
    table keeps one dead row so in-kernel loads stay in range."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas
    setup = {"valid": jnp.zeros((0,), bool),
             "screen": jnp.zeros((0, 3, 2), jnp.float32),
             "ndc_z": jnp.zeros((0, 3), jnp.float32),
             "clip_w": jnp.zeros((0, 3), jnp.float32),
             "bbox": jnp.zeros((0, 4), jnp.int32)}
    rec = raster_pallas.build_records(
        setup, jnp.full((8,), -1, jnp.int32), None)
    assert rec.table.shape == (1, raster_pallas.TBL)
    assert float(jnp.abs(rec.table).max()) == 0.0
    assert rec.sorted_tri.dtype == jnp.int32 and rec.vary is None


def test_random_soup_parity_sweep():
    """Seeded random-soup property sweep (normal + sliver regimes):
    engine matches the oracle under assert_parity across many
    geometries, not just the fixed standard meshes.  Face count is
    constant so every seed reuses one compiled program.  A 100-seed x
    3-regime sweep of this generator passed at HEAD (session 5); the
    committed test keeps a few seeds per regime for suite time."""
    from tinyrenderder_tpu.models import procedural
    view, proj = default_view()
    w, h = 96, 64
    for kw in (dict(spread=1.0, tri_size=0.3),
               dict(spread=0.8, tri_size=0.01)):
        for seed in (1003, 1017, 1029):
            soup = procedural.triangle_soup(48, seed=seed, **kw)
            p = make_pass(soup, GouraudShader(light_world=KEY), view, proj)
            frame = render_oracle([p], w, h)
            fb = render_engine([p], w, h)
            assert_parity(frame, fb)


def test_near_plane_crossers_deterministic_not_oracle_exact():
    """The f32 exactness BOUNDARY, pinned (found by a session-5 random
    sweep): ILL-CONDITIONED triangles amplify f32 evaluation-ORDER
    differences between the oracle's scalar affine-z sum and the
    engine's fused grouping beyond the 8-ulp assert_parity bound.
    Two mechanisms observed:
    * near-plane crossers — a vertex at w -> 0+ renders (the reference
      clips nothing at the near plane, our_gl.cpp:94-106) with NDC z
      magnitudes in the tens; amplification = the z-magnitude ratio
      (1260 ulps at seed 1026, vertex w = 0.0059, ndc z -33);
    * sub-pixel slivers — screen 2x-area of 0.054 px^2 at seed 2005
      conditions the barycentric divide by ~1/area (45 ulps).

    What MUST still hold there — and what this test asserts:
    * coverage identical to the oracle (coverage is sign-based shared
      semantics, immune to the amplification),
    * the XLA scan and tiled/Pallas backends bitwise-identical to each
      other on depth AND winner (determinism and cross-backend
      exactness are unconditional; only oracle-vs-engine depth VALUES
      lose the 8-ulp bound, and neither ordering is more correct).
    The <=1-LSB reference contract is defined on real
    scenes, which have neither near-plane crossers nor sub-pixel
    slivers that win pixels."""
    from tinyrenderder_tpu.models import procedural
    view, proj = default_view()
    w, h = 96, 64
    cases = [(1025, dict(spread=2.5, tri_size=2.0)),   # near-plane
             (1026, dict(spread=2.5, tri_size=2.0)),   # crossers
             (1031, dict(spread=2.5, tri_size=2.0)),
             (2005, dict(spread=1.0, tri_size=0.3))]   # sub-px sliver
    for seed, kw in cases:
        soup = procedural.triangle_soup(48, seed=seed, **kw)
        p = make_pass(soup, GouraudShader(light_world=KEY), view, proj)
        frame = render_oracle([p], w, h)
        fx = render_engine([p], w, h, backend="xla")
        ft = render_engine([p], w, h, backend="tiled")
        dx, dt = np.asarray(fx.depth), np.asarray(ft.depth)
        cov = np.isfinite(dx)
        np.testing.assert_array_equal(np.isfinite(frame.zbuffer), cov)
        np.testing.assert_array_equal(dx[cov], dt[cov])
        np.testing.assert_array_equal(np.asarray(fx.winner),
                                      np.asarray(ft.winner))
