"""GPU parity gate.

The CPU suite runs the Pallas kernel in interpret mode; this marked
suite pins the REAL Triton kernel and XLA:GPU's own code on the card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

(``python chip_smoke.py`` runs it too).  On the GPU nothing contracts
mul+add into FMA and f32 division is IEEE (ops.device.EXACT_DIV_FLAG),
so the kernel's winner maps must equal the XLA tiled fallback's, and
coverage and depth must equal the serial NumPy float32 oracle's, bit
for bit.  Whether there is a card is decided in a fixture, never at
import time.
"""

import numpy as np
import pytest

from helpers import default_view, make_pass, render_oracle, standard_meshes
from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import raster, raster_sparse, raster_tiled
from tinyrenderder_tpu.shaders import GouraudShader, PhongShader

KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def _require_gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes()


def _passes(meshes, view, proj):
    return [make_pass(meshes["soup"], GouraudShader(), view, proj),
            make_pass(meshes["head"], PhongShader(KEY, FILL, RIM),
                      view, proj)]


def test_kernel_matches_xla_on_gpu(meshes):
    """Real kernel vs XLA fallback, both compiled for this card: winner
    maps bitwise (z-tie order), colors <=1 LSB."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 256, 128
    for p in _passes(meshes, view, proj):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb0 = raster.new_framebuffers(w, h)
        fb_k, _ = raster_tiled.render_pass_tiled(
            fb0, attrs, p.shader, p.uniforms, use_pallas=True)
        fb_x, _ = raster_tiled.render_pass_tiled(
            fb0, attrs, p.shader, p.uniforms, use_pallas=False)
        np.testing.assert_array_equal(np.asarray(fb_k.winner),
                                      np.asarray(fb_x.winner))
        d = np.abs(np.asarray(fb_k.color).astype(int)
                   - np.asarray(fb_x.color).astype(int))
        assert d.max() <= 1, f"{p.shader.name}: color delta {d.max()}"


def test_kernel_matches_oracle_on_gpu(meshes):
    """Real kernel vs the serial NumPy oracle: coverage and depth
    bitwise, colors <=1 LSB (the cross-backend exactness invariant on
    hardware)."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 256, 128
    passes = _passes(meshes, view, proj)
    frame = render_oracle(passes, w, h)

    fb = raster.new_framebuffers(w, h)
    offset = 0
    for p in passes:
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb, _ = raster_tiled.render_pass_tiled(
            fb, attrs, p.shader, p.uniforms, winner_offset=offset,
            use_pallas=True)
        offset += attrs["position"].shape[0]

    got_cov = np.asarray(fb.winner) >= 0
    want_cov = np.isfinite(frame.zbuffer)
    np.testing.assert_array_equal(got_cov, want_cov)
    np.testing.assert_array_equal(np.asarray(fb.depth), frame.zbuffer)
    dc = np.abs(np.asarray(fb.color).astype(np.int64)
                - frame.color.astype(np.int64))
    assert dc.max() <= 1, f"oracle color delta {dc.max()}"


def test_sparse_matches_dense_kernel_on_gpu(meshes):
    """The resolve over the compacted active-tile list vs the same
    kernel over every screen tile: depth, winner and varying planes
    bitwise on the active tiles."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas
    view, proj = default_view()
    w, h = 256, 128
    th, tw = raster_tiled.TILE_H, raster_tiled.TILE_W
    ntx, nty = -(-w // tw), -(-h // th)
    n_tiles = ntx * nty
    p = _passes(meshes, view, proj)[1]
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    cap = 4096
    (setup, records, ids, kernel_ids, start_a, counts_a, *_
     ) = raster_sparse._pre_sparse_jit(
        attrs, dict(p.uniforms), p.shader, w, h, cap, n_tiles, th, tw)
    n_vary = sum(p.shader.varying_spec.values())
    tx0, ty0, span_x, spans, _ = raster_tiled._tile_spans(setup, tw, th)
    sorted_tri, start, counts = raster_tiled._build_bins(
        tx0, ty0, span_x, spans, cap, ntx, nty)
    init = jnp.full((n_tiles, th, tw), jnp.inf, jnp.float32)
    d_d, w_d, v_d, _ = raster_pallas.resolve_tiles(
        jnp.arange(n_tiles, dtype=jnp.int32), start[:-1], counts, records,
        init, ntx, th, tw, n_vary, False)
    d_s, w_s, v_s, _ = raster_pallas.resolve_tiles(
        kernel_ids, start_a, counts_a, records, init, ntx, th, tw, n_vary,
        False)
    act = np.asarray(ids)
    live = act < n_tiles
    np.testing.assert_array_equal(np.asarray(d_s)[live],
                                  np.asarray(d_d)[act[live]])
    np.testing.assert_array_equal(np.asarray(w_s)[live],
                                  np.asarray(w_d)[act[live]])
    np.testing.assert_array_equal(np.asarray(v_s)[live],
                                  np.asarray(v_d)[act[live]])


def test_fused_sharded_mesh1_matches_fused_on_gpu(meshes):
    """The production sharded pipeline on a 1-device GPU mesh is
    bitwise the single-device fused frame — the shard_map row-band
    machinery (band-clipped binning, kernel pixel origin, band-local
    caps) must be exact in real lowering, not just on CPU meshes."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.parallel import dist
    from tinyrenderder_tpu.shaders import EyeShader
    view, proj = default_view()
    w, h = 256, 128
    g = make_pass(meshes["soup"], GouraudShader(), view, proj)
    ph = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    e = make_pass(meshes["sphere"], EyeShader(KEY, RIM), view, proj,
                  model_matrix=math3d.translation_matrix(0.3, 0.0, 1.2)
                  @ math3d.scale_matrix(0.4, 0.4, 0.4))
    passes = []
    for p, excl in ((g, False), (ph, False), (e, True)):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        passes.append((attrs, p.shader, dict(p.uniforms), excl))
    ft1, od1, _ = raster_sparse.render_frame_fused(passes, w, h)
    fb1 = raster_sparse.tiles_to_buffers(ft1, w, h)
    mesh = dist.make_mesh(1)
    ft2, od2, _ = dist.render_frame_fused_sharded(mesh, passes, w, h,
                                                  interleave=True)
    fb2 = dist.tiles_to_buffers_sharded(mesh, ft2, w, h, interleave=True)
    np.testing.assert_array_equal(np.asarray(fb1.winner),
                                  np.asarray(fb2.winner))
    assert np.array_equal(np.asarray(fb1.depth), np.asarray(fb2.depth),
                          equal_nan=True)
    np.testing.assert_array_equal(np.asarray(fb1.color),
                                  np.asarray(fb2.color))

    # the 2-D screen-block path in real lowering: a (1,1) grid
    # exercises the column-clipped pre-stages + 2-D kernel origin
    grid = dist.make_mesh_grid(1, 1)
    ft3, od3, _ = dist.render_frame_fused_sharded(grid, passes, w, h)
    fb3 = dist.tiles_to_buffers_sharded(grid, ft3, w, h)
    np.testing.assert_array_equal(np.asarray(fb1.winner),
                                  np.asarray(fb3.winner))
    assert np.array_equal(np.asarray(fb1.depth), np.asarray(fb3.depth),
                          equal_nan=True)
    np.testing.assert_array_equal(np.asarray(fb1.color),
                                  np.asarray(fb3.color))


def test_fused_frame_matches_loop_on_gpu(meshes):
    """The fused whole-frame program vs the per-pass loop with real
    kernels: bitwise frames including excluded-pass depth semantics."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.shaders import EyeShader
    view, proj = default_view()
    w, h = 256, 128
    g = make_pass(meshes["soup"], GouraudShader(), view, proj)
    ph = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    e = make_pass(meshes["sphere"], EyeShader(KEY, RIM), view, proj,
                  model_matrix=math3d.translation_matrix(0.3, 0.0, 1.2)
                  @ math3d.scale_matrix(0.4, 0.4, 0.4))
    passes = []
    for p, excl in ((g, False), (ph, False), (e, True)):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        passes.append((attrs, p.shader, dict(p.uniforms), excl))
    ft_l, od_l, _, _ = raster_sparse.render_frame_tiles(passes, w, h)
    ft_f, od_f, _ = raster_sparse.render_frame_fused(passes, w, h)
    for field in ("depth", "winner", "color"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ft_l, field)),
            np.asarray(getattr(ft_f, field)))
    np.testing.assert_array_equal(np.asarray(od_l), np.asarray(od_f))


def test_image_path_matches_fused_on_gpu(meshes):
    """The single-pass direct-to-image path with the real kernel: both
    placement variants must reproduce the general fused frame's colors
    bitwise on hardware."""
    import jax.numpy as jnp

    view, proj = default_view()
    w, h = 256, 128
    p = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM,
                                              normal_map_strength=0.5),
                  view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    passes = [(attrs, p.shader, dict(p.uniforms), False)]
    ft, _, _ = raster_sparse.render_frame_fused(passes, w, h)
    ref = np.asarray(raster_sparse.tiles_to_buffers(ft, w, h).color)
    for direct in (True, False):
        img, ovf = raster_sparse.render_frame_fused_image(
            passes, w, h, direct=direct)
        assert not bool(ovf)
        np.testing.assert_array_equal(np.asarray(img), ref)


def test_postprocess_device_matches_host_on_gpu(meshes):
    """The fused z-viz + 64-tap SSAO + composite dispatch compiled for
    this chip vs the host numpy reference path (main.cpp:743-786
    semantics): SSAO taps and the z normalization are compare/affine
    f32 math, composite is exact integer math — so the device images
    must match the f32 host path bitwise except where the z-gradient
    quantization rounds differently (allow <=1 LSB, same bound the
    golden suite pins on CPU)."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import post

    view, proj = default_view()
    w, h = 256, 128
    fb = raster.new_framebuffers(w, h)
    for p in _passes(meshes, view, proj):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb, _ = raster_tiled.render_pass_tiled(
            fb, attrs, p.shader, p.uniforms, use_pallas=True)
    color = np.asarray(fb.color)
    depth = np.asarray(fb.depth, dtype=np.float32)

    zimg_d, ao_d, final_d = post.postprocess_device(color, depth)

    # host reference in f32 to isolate GPU-compilation differences (the
    # f32-vs-f64 SSAO question is pinned separately by the CPU golden)
    zimg_h = post.zbuffer_to_image(depth, np)
    ao_h = post.ssao_image(post.ssao_map(depth, np), np)
    final_h = post.composite(color, ao_h, np)

    assert np.abs(np.asarray(zimg_d).astype(int)
                  - zimg_h.astype(int)).max() <= 1
    assert np.abs(np.asarray(ao_d).astype(int)
                  - ao_h.astype(int)).max() <= 1
    assert np.abs(np.asarray(final_d).astype(int)
                  - final_h.astype(int)).max() <= 2   # z/ao LSB compound


def test_measured_band_clip_on_gpu(meshes):
    """The measured-band machinery in REAL lowering: a padded
    band (static 6 tile rows, only 4 real) must reproduce exactly the
    corresponding rows of the full fused frame, with the dead padding
    rows left at background — the traced ty_rows clip, band-local
    compaction, and kernel origin all lower through the real kernels
    here (CPU meshes only ever ran them in interpret mode)."""
    import jax
    import jax.numpy as jnp

    view, proj = default_view()
    w, h = 256, 128                       # 8 tile rows
    p = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    passes = [(attrs, p.shader, dict(p.uniforms), False)]

    ft1, _, _ = raster_sparse.render_frame_fused(passes, w, h)
    fb1 = raster_sparse.tiles_to_buffers(ft1, w, h)

    # band: tile rows 2..5 (4 real rows) under a 6-row static shape
    key = (attrs["position"].shape[0], w // 128, h // 16, 16, 128)
    caps = raster_sparse._resolve_caps(
        key, attrs, dict(p.uniforms), p.shader, w, h, 16, 128,
        (w // 128) * (h // 16))
    plan = ((p.shader, caps, False, 0),)
    ty_lo = jnp.int32(2)
    origin = jnp.stack([jnp.int32(0), jnp.int32(2 * 16)])
    ft_b, _, _, _ = jax.jit(
        lambda a, u: raster_sparse._fused_frame_body(
            (a,), (u,), plan, w, h, 16, 128, False, ty_lo=ty_lo,
            nty_band=6, origin=origin, ty_rows=jnp.int32(4)),
        static_argnums=())(attrs, dict(p.uniforms))
    ntx = w // 128
    band = raster_sparse.FrameTiles(
        color=ft_b.color, depth=ft_b.depth, winner=ft_b.winner)
    fb_b = raster_sparse.tiles_to_buffers(band, w, 6 * 16)
    # real rows: band-local tile rows 0..3 == global tile rows 2..5
    np.testing.assert_array_equal(np.asarray(fb_b.color)[: 4 * 16],
                                  np.asarray(fb1.color)[2 * 16: 6 * 16])
    assert np.array_equal(np.asarray(fb_b.depth)[: 4 * 16],
                          np.asarray(fb1.depth)[2 * 16: 6 * 16],
                          equal_nan=True)
    # dead padding rows stay background
    assert not np.isfinite(np.asarray(fb_b.depth)[4 * 16:]).any()


def test_tile_h32_matches_tile_h16_on_gpu(meshes):
    """The 32-row tiling must reproduce the 16-row frame bitwise in real
    lowering — fused general chain AND the direct-to-image path."""
    import jax.numpy as jnp

    view, proj = default_view()
    w, h = 256, 128                       # 4 rows of 32 / 8 rows of 16
    p = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    passes = [(attrs, p.shader, dict(p.uniforms), False)]

    ft16, _, _ = raster_sparse.render_frame_fused(passes, w, h,
                                                  tile_h=16)
    fb16 = raster_sparse.tiles_to_buffers(ft16, w, h, tile_h=16)
    ft32, _, _ = raster_sparse.render_frame_fused(passes, w, h,
                                                  tile_h=32)
    fb32 = raster_sparse.tiles_to_buffers(ft32, w, h, tile_h=32)
    np.testing.assert_array_equal(np.asarray(fb16.color),
                                  np.asarray(fb32.color))
    assert np.array_equal(np.asarray(fb16.depth), np.asarray(fb32.depth),
                          equal_nan=True)
    np.testing.assert_array_equal(np.asarray(fb16.winner),
                                  np.asarray(fb32.winner))
    img32, _ = raster_sparse.render_frame_fused_image(passes, w, h,
                                                      tile_h=32)
    np.testing.assert_array_equal(np.asarray(fb16.color),
                                  np.asarray(img32))
