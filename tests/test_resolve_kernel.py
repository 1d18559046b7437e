"""The depth-resolve kernel (ops.raster_pallas) in interpret mode.

XLA:CPU codegen is capped at AVX here (tests/conftest.py), which has no
FMA, so the CPU runs the same uncontracted IEEE float32 arithmetic as
the GPU path.  The kernel's coverage, winner and depth maps must then
equal the serial NumPy float32 oracle's and the XLA tiled resolve's bit
for bit, and colors stay within 1 LSB of the oracle.
"""

import numpy as np
import pytest

from helpers import default_view, make_pass, render_oracle, standard_meshes
from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.shaders import (DepthShader, EyeShader, GouraudShader,
                                       PhongShader, TexturedShader)

KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))

SHADERS = {
    "gouraud": lambda: GouraudShader(light_world=KEY),
    "phong": lambda: PhongShader(KEY, FILL, RIM, normal_map_strength=0.5),
    "textured": lambda: TexturedShader(light_world=KEY),
    "eye": lambda: EyeShader(KEY, RIM),
    "depth": lambda: DepthShader(),
}


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes()


def _device_pass(p):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in p.attrs.items()}


def _setup_and_bins(p, w, h, tile_h, capacity=None):
    from tinyrenderder_tpu.ops import raster_tiled
    attrs = _device_pass(p)
    setup, varyings = raster_tiled._vertex_setup_jit(
        attrs, dict(p.uniforms), p.shader, w, h)
    bins = raster_tiled.bin_triangles_csr(setup, w, h, tile_h=tile_h,
                                          capacity=capacity)
    return attrs, setup, varyings, bins


@pytest.mark.parametrize("tile_h", [16, 32])
@pytest.mark.parametrize("shader", sorted(SHADERS))
def test_kernel_matches_oracle_and_xla(meshes, shader, tile_h):
    """Every shader kind, both tile heights: coverage, winner and depth
    bitwise against the oracle and the XLA tiled resolve; the full
    sparse pass (kernel + phase C) within 1 LSB of the oracle's color."""
    from tinyrenderder_tpu.ops import raster, raster_pallas, raster_tiled
    w, h = 150, 70                       # ragged on both tile axes
    view, proj = default_view()
    p = make_pass(meshes["head"], SHADERS[shader](), view, proj)
    frame = render_oracle([p], w, h)
    _, setup, _, bins = _setup_and_bins(p, w, h, tile_h)
    init = raster.new_framebuffers(w, h).depth
    d_k, w_k = raster_pallas.depth_resolve_pallas(
        setup, bins, init, h, w, tile_h=tile_h, interpret=True)
    d_x, w_x = raster_tiled.depth_resolve_tiled(setup, bins, init, h, w,
                                                tile_h=tile_h)
    np.testing.assert_array_equal(np.asarray(w_k), frame.winner)
    np.testing.assert_array_equal(np.asarray(d_k), frame.zbuffer)
    np.testing.assert_array_equal(np.asarray(w_k), np.asarray(w_x))
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_x))

    fb, _ = raster_tiled.render_pass_tiled(
        raster.new_framebuffers(w, h), _device_pass(p), p.shader,
        p.uniforms, tile_h=tile_h, use_pallas=True)
    np.testing.assert_array_equal(np.asarray(fb.winner), frame.winner)
    dc = np.abs(np.asarray(fb.color).astype(int)
                - frame.color.astype(int))
    assert dc.max() <= 1, f"{shader}: color delta {dc.max()}"


def test_phase_c_matches_scan_path_bitwise(meshes):
    """Phase C (per-pixel gather of the winner's row + perspective-
    correct interpolation) reproduces the scan path's phase B colors
    bit for bit: same formulas, same operation order."""
    from tinyrenderder_tpu.ops import raster, raster_tiled
    w, h = 130, 60
    view, proj = default_view()
    fb_k = raster.new_framebuffers(w, h)
    fb_x = raster.new_framebuffers(w, h)
    offset = 0
    for name, mesh in (("phong", "head"), ("textured", "plane"),
                       ("gouraud", "soup")):
        p = make_pass(meshes[mesh], SHADERS[name](), view, proj)
        attrs = _device_pass(p)
        fb_k, _ = raster_tiled.render_pass_tiled(
            fb_k, attrs, p.shader, p.uniforms, winner_offset=offset,
            use_pallas=True)
        fb_x, _ = raster.render_pass_xla(fb_x, attrs, p.shader, p.uniforms,
                                         winner_offset=offset)
        offset += attrs["position"].shape[0]
    for field in ("color", "depth", "winner"):
        np.testing.assert_array_equal(np.asarray(getattr(fb_k, field)),
                                      np.asarray(getattr(fb_x, field)))


@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_origin_and_row_stride(meshes, stride):
    """A band of the frame (the sharded bodies' view): tile rows
    ty_lo, ty_lo + stride, ... resolved at global pixel coordinates via
    ``origin`` and ``y_stride`` equal the same rows of the full frame."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas, raster_sparse
    w, h, th, tw = 256, 128, 16, 128
    ntx, nty = w // tw, h // th
    view, proj = default_view()
    p = make_pass(meshes["head"], SHADERS["phong"](), view, proj)
    attrs = _device_pass(p)
    uni = dict(p.uniforms)
    n_vary = sum(p.shader.varying_spec.values())
    inf = jnp.full((ntx * nty, th, tw), jnp.inf, jnp.float32)
    full = raster_sparse._pre_sparse_jit(attrs, uni, p.shader, w, h, 8192,
                                         ntx * nty, th, tw)
    _, rec, ids, kids, sa, ca, *_ = full
    d_f, w_f, v_f, _ = raster_pallas.resolve_tiles(
        kids, sa, ca, rec, inf, ntx, th, tw, n_vary, True)
    dense = {int(t): i for i, t in enumerate(np.asarray(ids))}

    ty_lo, rows = 1, 3
    band = raster_sparse._pre_sparse_jit(
        attrs, uni, p.shader, w, h, 8192, ntx * rows, th, tw,
        ty_lo=jnp.int32(ty_lo), nty_band=rows, ty_stride=stride)
    _, rec_b, ids_b, kids_b, sa_b, ca_b, *_ = band
    origin = jnp.array([0, ty_lo * th], jnp.int32)
    d_b, w_b, v_b, _ = raster_pallas.resolve_tiles(
        kids_b, sa_b, ca_b, rec_b, inf[:ntx * rows], ntx, th, tw, n_vary,
        True, origin=origin, y_stride=th * stride)
    checked = 0
    for i, t in enumerate(np.asarray(ids_b)):
        if t >= ntx * rows:
            continue                     # padding entry
        g = (ty_lo + (t // ntx) * stride) * ntx + t % ntx
        if g not in dense:
            assert (np.asarray(w_b[i]) < 0).all()
            continue
        j = dense[g]
        np.testing.assert_array_equal(np.asarray(d_b[i]), np.asarray(d_f[j]))
        np.testing.assert_array_equal(np.asarray(w_b[i]), np.asarray(w_f[j]))
        np.testing.assert_array_equal(np.asarray(v_b[i]), np.asarray(v_f[j]))
        checked += 1
    assert checked >= 2


def test_kernel_column_origin(meshes):
    """An x origin (2-D screen blocks): the right half of the frame
    resolved as its own block equals the full frame's right tiles."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas, raster_sparse
    w, h, th, tw = 256, 64, 16, 128
    ntx, nty = w // tw, h // th
    view, proj = default_view()
    p = make_pass(meshes["soup"], SHADERS["gouraud"](), view, proj)
    attrs = _device_pass(p)
    uni = dict(p.uniforms)
    inf = jnp.full((ntx * nty, th, tw), jnp.inf, jnp.float32)
    _, rec, ids, kids, sa, ca, *_ = raster_sparse._pre_sparse_jit(
        attrs, uni, p.shader, w, h, 4096, ntx * nty, th, tw)
    d_f, w_f, _, _ = raster_pallas.resolve_tiles(kids, sa, ca, rec, inf, ntx,
                                                 th, tw, 0, True)
    dense = {int(t): i for i, t in enumerate(np.asarray(ids))}
    _, rec_b, ids_b, kids_b, sa_b, ca_b, *_ = raster_sparse._pre_sparse_jit(
        attrs, uni, p.shader, w, h, 4096, nty, th, tw, ty_lo=jnp.int32(0),
        nty_band=nty, tx_lo=jnp.int32(1), ntx_band=1)
    d_b, w_b, _, _ = raster_pallas.resolve_tiles(
        kids_b, sa_b, ca_b, rec_b, inf[:nty], 1, th, tw, 0, True,
        origin=jnp.array([tw, 0], jnp.int32))
    checked = 0
    for i, t in enumerate(np.asarray(ids_b)):
        if t >= nty:
            continue
        g = int(t) * ntx + 1
        if g in dense:
            np.testing.assert_array_equal(np.asarray(w_b[i]),
                                          np.asarray(w_f[dense[g]]))
            np.testing.assert_array_equal(np.asarray(d_b[i]),
                                          np.asarray(d_f[dense[g]]))
            checked += 1
    assert checked >= 1


@pytest.mark.parametrize("mesh", ["soup", "head"])
def test_kernel_stats_events_exact(meshes, mesh):
    """collect_stats: the z-pass event count (overdraw included) and
    the event z-range equal the oracle's exact counters
    (our_gl.cpp:194-200), from one launch that also resolves the
    frame."""
    from tinyrenderder_tpu.ops import raster_sparse
    w, h = 160, 96
    view, proj = default_view()
    p = make_pass(meshes[mesh], SHADERS["gouraud"](), view, proj)
    frame = render_oracle([p], w, h)
    ft = raster_sparse.new_frame_tiles(w, h)
    ft2, _, _, (frags, mn, mx) = raster_sparse.render_pass_tiles(
        ft, _device_pass(p), p.shader, dict(p.uniforms), w, h,
        collect_stats=True)
    ft3, _, _ = raster_sparse.render_pass_tiles(
        ft, _device_pass(p), p.shader, dict(p.uniforms), w, h)
    assert int(frags) == frame.stats.fragments_drawn
    assert float(mn) == frame.stats.min_z
    assert float(mx) == frame.stats.max_z
    for field in ("color", "depth", "winner"):
        np.testing.assert_array_equal(np.asarray(getattr(ft2, field)),
                                      np.asarray(getattr(ft3, field)))


@pytest.mark.parametrize("tile_h", [16, 32])
def test_long_bins_one_tile(meshes, tile_h):
    """Every triangle of a dense soup lands in ONE tile: a bin hundreds
    of entries long, merged in submission order."""
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.ops import raster, raster_pallas, raster_tiled
    w, h = 100, tile_h                   # a single (tile_h, 128) tile
    view, proj = default_view()
    soup = procedural.triangle_soup(200, seed=11, spread=0.4, tri_size=0.5)
    p = make_pass(soup, SHADERS["gouraud"](), view, proj)
    frame = render_oracle([p], w, h)
    _, setup, _, bins = _setup_and_bins(p, w, h, tile_h)
    assert int(np.asarray(bins.counts).max()) > 64
    d, win = raster_pallas.depth_resolve_pallas(
        setup, bins, raster.new_framebuffers(w, h).depth, h, w,
        tile_h=tile_h, interpret=True)
    np.testing.assert_array_equal(np.asarray(win), frame.winner)
    np.testing.assert_array_equal(np.asarray(d), frame.zbuffer)
    d_x, w_x = raster_tiled.depth_resolve_tiled(
        setup, bins, raster.new_framebuffers(w, h).depth, h, w,
        tile_h=tile_h)
    np.testing.assert_array_equal(np.asarray(win), np.asarray(w_x))


def test_kernel_empty_bins_keep_init(meshes):
    """Tiles whose bins are empty (padding entries, count 0) return the
    frame's depth untouched and no winner."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas
    th, tw = 16, 128
    view, proj = default_view()
    p = make_pass(meshes["soup"], SHADERS["gouraud"](), view, proj)
    _, setup, _, bins = _setup_and_bins(p, 128, 32, th)
    rec = raster_pallas.build_records(setup, bins.sorted_tri)
    init = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, th, tw)).astype(np.float32))
    ids = jnp.array([1, 0, 1], jnp.int32)
    zero = jnp.zeros((3,), jnp.int32)
    d, win, vary, ev = raster_pallas.resolve_tiles(
        ids, zero, zero, rec, init, 1, th, tw, 0, True, collect_stats=True)
    np.testing.assert_array_equal(np.asarray(d),
                                  np.asarray(init)[np.asarray(ids)])
    assert (np.asarray(win) == -1).all() and vary is None
    assert (np.asarray(ev)[:, 0] == 0).all()
    assert (np.asarray(ev)[:, 1] == -np.inf).all()


def test_zero_face_pass_is_identity():
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    w, h = 64, 32
    attrs = {k: jnp.zeros((0, 3, c), jnp.float32)
             for k, c in [("position", 3), ("normal", 3), ("uv", 2),
                          ("tangent", 3), ("bitangent", 3)]}
    shader = GouraudShader()
    uni = shader.build_uniforms(np.eye(4), np.eye(4), None, np.float32)
    ft = raster_sparse.new_frame_tiles(w, h)
    ft2, setup, ovf, (frags, mn, mx) = raster_sparse.render_pass_tiles(
        ft, attrs, shader, uni, w, h, collect_stats=True)
    assert ft2 is ft and not bool(ovf) and int(frags) == 0
    assert setup["valid"].shape == (0,)


def test_resolve_output_shapes(meshes):
    """The wrapper's contract: compact (A, th, tw) depth f32 / winner
    int32, varyings (A, V, th, tw), event planes (A, 2, th, tw)."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas, raster_tiled
    th, tw, w, h = 32, 128, 256, 64
    view, proj = default_view()
    p = make_pass(meshes["head"], SHADERS["phong"](), view, proj)
    attrs, setup, varyings, bins = _setup_and_bins(p, w, h, th)
    spec = tuple(p.shader.varying_spec.items())
    vc = raster_tiled._flatten_varyings(varyings, spec)
    rec = raster_pallas.build_records(setup, bins.sorted_tri, vc)
    n = bins.n_tiles
    d, win, vary, ev = raster_pallas.resolve_tiles(
        jnp.arange(n, dtype=jnp.int32), bins.start[:-1], bins.counts, rec,
        jnp.full((n, th, tw), jnp.inf, jnp.float32), bins.n_tiles_x, th,
        tw, vc.shape[-1], True, collect_stats=True)
    assert d.shape == (n, th, tw) and d.dtype == jnp.float32
    assert win.shape == (n, th, tw) and win.dtype == jnp.int32
    assert vary.shape == (n, vc.shape[-1], th, tw)
    assert ev.shape == (n, 2, th, tw)
    assert rec.table.shape == (setup["valid"].shape[0], raster_pallas.TBL)


def test_capacity_overflow_regrows_exact(meshes):
    """Strict mode with deliberately tiny pair/tile caps: the pass
    overflows, grows its caps, re-renders, and returns the exact frame."""
    from tinyrenderder_tpu.ops import raster_sparse
    w, h = 160, 96
    view, proj = default_view()
    p = make_pass(meshes["head"], SHADERS["phong"](), view, proj)
    attrs = _device_pass(p)
    ft = raster_sparse.new_frame_tiles(w, h)
    ref, _, _ = raster_sparse.render_pass_tiles(ft, attrs, p.shader,
                                                dict(p.uniforms), w, h)
    key = (attrs["position"].shape[0], 2, 6, 16, 128)
    got, _, ovf = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, dict(p.uniforms), w, h, _caps=(8, 8, 8))
    assert raster_sparse._SPARSE_CAPACITY[key][0] > 8
    assert not bool(ovf)
    for field in ("color", "depth", "winner"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)))


# ---- the platform decision, the compile cache, the division flag ------------

@pytest.mark.parametrize("backend,interp", [("gpu", False), ("cpu", True)])
def test_platform_routing(monkeypatch, backend, interp):
    import jax

    from tinyrenderder_tpu.ops import device
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.platform() == backend
    assert device.interpret() is interp


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_platform_rejects_other_backends(monkeypatch, backend):
    import jax

    from tinyrenderder_tpu.ops import device
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        device.platform()
    with pytest.raises(RuntimeError):
        device.interpret()


def test_kernel_never_interpreted_on_gpu(monkeypatch, meshes):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import device, raster_pallas
    th, tw = 16, 128
    view, proj = default_view()
    p = make_pass(meshes["soup"], SHADERS["gouraud"](), view, proj)
    _, setup, _, bins = _setup_and_bins(p, 128, 32, th)
    rec = raster_pallas.build_records(setup, bins.sorted_tri)
    init = jnp.full((2, th, tw), jnp.inf, jnp.float32)
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    with pytest.raises(ValueError, match="never runs interpreted"):
        raster_pallas.resolve_tiles(jnp.arange(2, dtype=jnp.int32),
                                    bins.start[:2], bins.counts[:2], rec,
                                    init, 1, th, tw, 0, True)


def test_render_pass_tiled_default_route(monkeypatch, meshes):
    """``use_pallas=None`` takes the sparse kernel pipeline on the GPU
    platform and the XLA resolve on the CPU."""
    from tinyrenderder_tpu.ops import device, raster, raster_sparse
    from tinyrenderder_tpu.ops import raster_tiled
    calls = []
    real = raster_sparse.render_pass_tiles

    def spy(*a, **kw):
        calls.append(a)
        # run the pass itself on the CPU platform (interpreted kernel)
        monkeypatch.setattr(device, "platform", lambda: "cpu")
        return real(*a, **kw)

    monkeypatch.setattr(raster_sparse, "render_pass_tiles", spy)
    view, proj = default_view()
    p = make_pass(meshes["soup"], SHADERS["gouraud"](), view, proj)
    fb0 = raster.new_framebuffers(64, 32)
    raster_tiled.render_pass_tiled(fb0, _device_pass(p), p.shader,
                                   p.uniforms)
    assert calls == []
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    raster_tiled.render_pass_tiled(fb0, _device_pass(p), p.shader,
                                   p.uniforms)
    assert len(calls) == 1


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    from tinyrenderder_tpu.ops import device
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    import os

    import jax

    from tinyrenderder_tpu.ops import device
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.use_compile_cache() is None        # CPU: no cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    try:
        path = device.use_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_exact_div_flag_added_once(monkeypatch):
    from jax._src import xla_bridge

    from tinyrenderder_tpu.ops import device
    monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                        lambda: False)
    monkeypatch.setenv("XLA_FLAGS", "--xla_foo=1")
    device.require_exact_div()
    device.require_exact_div()
    import os
    flags = os.environ["XLA_FLAGS"].split()
    assert flags == ["--xla_foo=1", device.EXACT_DIV_FLAG]


def test_exact_div_flag_not_added_late(monkeypatch):
    from jax._src import xla_bridge

    from tinyrenderder_tpu.ops import device
    monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                        lambda: True)
    monkeypatch.setenv("XLA_FLAGS", "")
    device.require_exact_div()
    import os
    assert os.environ["XLA_FLAGS"] == ""
