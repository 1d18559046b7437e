"""Sparse active-tile pipeline (ops.raster_sparse) correctness tests.

The compacted-grid kernel must be bitwise-identical to the dense-grid
kernel and the XLA tiled path on depth/winner maps, with untouched tiles
preserved exactly; the overflow flag must fire on the frame that drops
work."""

import numpy as np
import pytest

from helpers import default_view, make_pass, standard_meshes
from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import raster, raster_sparse, raster_tiled
from tinyrenderder_tpu.shaders import (EyeShader, GouraudShader,
                                       PhongShader)

KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes()


def _passes(meshes, view, proj):
    return [make_pass(meshes["soup"], GouraudShader(), view, proj),
            make_pass(meshes["head"], PhongShader(KEY, FILL, RIM),
                      view, proj)]


def test_tiles_roundtrip():
    rng = np.random.default_rng(5)
    import jax.numpy as jnp
    h, w = 70, 150                     # ragged on both tile axes
    fb = raster.FrameBuffers(
        color=jnp.asarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)),
        depth=jnp.asarray(rng.normal(size=(h, w)).astype(np.float32)),
        winner=jnp.asarray(rng.integers(-1, 9, (h, w), dtype=np.int32)))
    ft = raster_sparse.buffers_to_tiles(fb, w, h)
    fb2 = raster_sparse.tiles_to_buffers(ft, w, h)
    for field in ("color", "depth", "winner"):
        np.testing.assert_array_equal(np.asarray(getattr(fb, field)),
                                      np.asarray(getattr(fb2, field)))


def test_sparse_matches_xla_tiled(meshes):
    """Sparse pallas (interpret) vs the XLA tiled fallback: bitwise
    winner maps (the exactness invariant), depth within 1 ulp (kernel
    affine_z fuses in a different program than the scan path), <=1 LSB
    color."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 160, 42                     # ragged edges + empty border tiles
    for p in _passes(meshes, view, proj):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb0 = raster.new_framebuffers(w, h)
        fb_s, _ = raster_tiled.render_pass_tiled(
            fb0, attrs, p.shader, p.uniforms, use_pallas=True)
        fb_x, _ = raster_tiled.render_pass_tiled(
            fb0, attrs, p.shader, p.uniforms, use_pallas=False)
        np.testing.assert_array_equal(np.asarray(fb_s.winner),
                                      np.asarray(fb_x.winner))
        ds, dx = np.asarray(fb_s.depth), np.asarray(fb_x.depth)
        fin = np.isfinite(dx)
        np.testing.assert_array_equal(fin, np.isfinite(ds))
        np.testing.assert_allclose(ds[fin], dx[fin], rtol=3e-7)
        d = np.abs(np.asarray(fb_s.color).astype(int)
                   - np.asarray(fb_x.color).astype(int))
        assert d.max() <= 1


def test_sparse_matches_dense_kernel_bitwise(meshes):
    """Sparse (compacted grid) vs dense (all-tiles grid) kernel launches
    on identical records: depth AND winner bitwise — compaction must not
    perturb any kernel math."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 160, 42
    th, tw = raster_tiled.TILE_H, raster_tiled.TILE_W
    ntx, nty = -(-w // tw), -(-h // th)
    n_tiles = ntx * nty
    for p in _passes(meshes, view, proj):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        cap = 4096
        (setup, records, ids, kernel_ids, start_a, counts_a, total,
         n_active) = raster_sparse._pre_sparse_jit(
            attrs, dict(p.uniforms), p.shader, w, h, cap, n_tiles, th, tw)
        n_vary = sum(p.shader.varying_spec.values())
        tx0, ty0, span_x, spans, _ = raster_tiled._tile_spans(setup, tw, th)
        sorted_tri, start, counts = raster_tiled._build_bins(
            tx0, ty0, span_x, spans, cap, ntx, nty)
        init = jnp.full((n_tiles, th, tw), jnp.inf, jnp.float32)
        from tinyrenderder_tpu.ops import raster_pallas
        d_d, w_d, v_d, _ = raster_pallas.resolve_tiles(
            jnp.arange(n_tiles, dtype=jnp.int32), start[:-1], counts,
            records, init, ntx, th, tw, n_vary, True)
        d_s, w_s, v_s, _ = raster_pallas.resolve_tiles(
            kernel_ids, start_a, counts_a, records, init, ntx, th, tw,
            n_vary, True)
        act = np.asarray(ids)
        live = act < n_tiles
        np.testing.assert_array_equal(np.asarray(d_s)[live],
                                      np.asarray(d_d)[act[live]])
        np.testing.assert_array_equal(np.asarray(w_s)[live],
                                      np.asarray(w_d)[act[live]])
        np.testing.assert_array_equal(np.asarray(v_s)[live],
                                      np.asarray(v_d)[act[live]])


def test_sparse_preserves_untouched_tiles(meshes):
    """A pass whose geometry covers a corner must leave every other
    tile's color/depth/winner bit-identical (the compaction contract)."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 512, 128                    # 4 x 8 = 32-tile grid at (16, 128)
    p = make_pass(meshes["soup"], GouraudShader(), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    rng = np.random.default_rng(9)
    base = raster.FrameBuffers(
        color=jnp.asarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)),
        depth=jnp.full((h, w), np.inf, jnp.float32),
        winner=jnp.full((h, w), raster.BACKGROUND, jnp.int32))
    ft = raster_sparse.buffers_to_tiles(base, w, h)
    ft2, setup, ovf = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, p.uniforms, w, h)
    assert not bool(ovf)
    touched = np.asarray(ft2.winner != ft.winner).any(axis=(1, 2))
    covered_tiles = int(touched.sum())
    assert 0 < covered_tiles < ft.winner.shape[0]
    # untouched tiles preserved bitwise (including random color bytes)
    keep = ~touched
    np.testing.assert_array_equal(np.asarray(ft2.color)[keep],
                                  np.asarray(ft.color)[keep])
    np.testing.assert_array_equal(np.asarray(ft2.depth)[keep],
                                  np.asarray(ft.depth)[keep])


def test_overflow_flag_fires_same_frame(meshes):
    """Non-strict mode: the frame that drops pairs reports it in its OWN
    outputs (device flag), not one frame later."""
    import jax.numpy as jnp
    view, proj = default_view()
    w = h = 64
    p = make_pass(meshes["soup"], GouraudShader(), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    key = (attrs["position"].shape[0],
           -(-w // raster_tiled.TILE_W), -(-h // raster_tiled.TILE_H),
           raster_tiled.TILE_H, raster_tiled.TILE_W)
    raster_sparse._SPARSE_CAPACITY.pop(key, None)
    raster_sparse._SPARSE_PENDING.pop(key, None)
    ft = raster_sparse.new_frame_tiles(w, h)
    _, _, ovf = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, p.uniforms, w, h,
        strict_capacity=False, _caps=(16, 1))
    assert bool(ovf)                   # capacity-busting frame flags NOW
    raster_sparse._SPARSE_PENDING.pop(key, None)
    raster_sparse._SPARSE_CAPACITY.pop(key, None)
    _, _, ovf2 = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, p.uniforms, w, h, strict_capacity=False)
    assert not bool(ovf2)


def test_exact_stats_match_oracle(meshes):
    """Device fragment counter must match the oracle's EXACT overdraw-
    inclusive z-pass event count and z-range (our_gl.cpp:194-200) on a
    multi-pass scene."""
    from tinyrenderder_tpu.camera import Camera
    from tinyrenderder_tpu.scene import Scene

    cam = Camera()
    cam.set_eye(math3d.vec3(0, 0.5, 3))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(160 / 42)
    cam.set_clipping(0.1, 50.0)
    sc = Scene(camera=cam, width=160, height=42)
    # overlapping passes -> guaranteed overdraw
    sc.add(meshes["soup"], np.eye(4), GouraudShader(), name="soup")
    sc.add(meshes["head"], np.eye(4), PhongShader(KEY, FILL, RIM),
           name="head")

    r_o = sc.render(backend="oracle")
    r_t = sc.render(backend="tiled")
    assert r_t.stats.fragments_exact
    assert r_t.stats.fragments_drawn == r_o.stats.fragments_drawn
    # winner-count lower bound sanity: events >= covered pixels
    assert r_t.stats.fragments_drawn >= int(
        np.isfinite(r_t.full_depth).sum())
    np.testing.assert_allclose(r_t.stats.min_z, r_o.stats.min_z, rtol=2e-7)
    np.testing.assert_allclose(r_t.stats.max_z, r_o.stats.max_z, rtol=2e-7)


def test_scene_tiles_loop_matches_xla(meshes):
    """Scene backend 'tiled' routed through the tiled-resident frame loop
    (the production path) vs the xla backend:
    winner bitwise, color <=1 LSB, output-depth exclusion preserved."""
    from tinyrenderder_tpu.camera import Camera
    from tinyrenderder_tpu.scene import Scene

    cam = Camera()
    cam.set_eye(math3d.vec3(0, 0.5, 3))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(160 / 42)
    cam.set_clipping(0.1, 50.0)
    sc = Scene(camera=cam, width=160, height=42)
    sc.add(meshes["head"], np.eye(4), PhongShader(KEY, FILL, RIM),
           name="head")
    eye_m = (math3d.translation_matrix(0.3, 0.0, 1.2)
             @ math3d.scale_matrix(0.4, 0.4, 0.4))
    sc.add(meshes["sphere"], eye_m, EyeShader(KEY, RIM), name="eyes",
           exclude_from_output_depth=True)

    r_x = sc.render(backend="xla")
    r_t = sc.render(backend="tiled")
    d = np.abs(r_t.color.astype(int) - r_x.color.astype(int))
    assert d.max() <= 1
    # output depth excludes the eye pass on both backends
    np.testing.assert_allclose(
        np.where(np.isfinite(r_t.depth), r_t.depth, 0.0),
        np.where(np.isfinite(r_x.depth), r_x.depth, 0.0), rtol=3e-7)
    assert (np.asarray(r_t.depth) != np.asarray(r_t.full_depth)).any()
    assert not bool(np.asarray(r_t.overflowed))


def test_frame_tiles_multipass_eye_semantics(meshes):
    """render_frame_tiles reproduces the scene loop's z-snapshot/restore
    (main.cpp:700,730) — vs the FrameBuffers-based reference loop."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 160, 42
    g = make_pass(meshes["soup"], GouraudShader(), view, proj)
    # eye sphere pulled toward the camera so its depth writes are the
    # nearest surface somewhere (-> output depth visibly excludes them)
    e = make_pass(meshes["sphere"], EyeShader(KEY, RIM), view, proj,
                  model_matrix=math3d.translation_matrix(0.3, 0.0, 1.2)
                  @ math3d.scale_matrix(0.4, 0.4, 0.4))
    ph = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    passes = []
    for p, excl in ((g, False), (ph, False), (e, True)):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        passes.append((attrs, p.shader, dict(p.uniforms), excl))

    ft, out_depth_t, ovf, _ = raster_sparse.render_frame_tiles(
        passes, w, h)
    fb = raster_sparse.tiles_to_buffers(ft, w, h)
    out_depth = raster_sparse.tiles_to_buffers(
        raster_sparse.FrameTiles(ft.color, out_depth_t, ft.winner),
        w, h).depth

    # reference loop through the per-pass FrameBuffers API
    ref = raster.new_framebuffers(w, h)
    snapshot = None
    offset = 0
    for attrs, shader, uniforms, excl in passes:
        if excl and snapshot is None:
            snapshot = ref.depth
        elif not excl and snapshot is not None:
            ref = raster.FrameBuffers(color=ref.color, depth=snapshot,
                                      winner=ref.winner)
            snapshot = None
        ref, _ = raster_tiled.render_pass_tiled(
            ref, attrs, shader, uniforms, winner_offset=offset,
            use_pallas=True)
        offset += attrs["position"].shape[0]

    np.testing.assert_array_equal(np.asarray(fb.depth),
                                  np.asarray(ref.depth))
    np.testing.assert_array_equal(np.asarray(fb.winner),
                                  np.asarray(ref.winner))
    np.testing.assert_array_equal(np.asarray(fb.color),
                                  np.asarray(ref.color))
    od, fd = np.asarray(out_depth), np.asarray(fb.depth)
    assert np.isfinite(od).sum() <= np.isfinite(fd).sum()
    assert (od != fd).any()            # eye depth excluded from output


def test_collect_stats_does_not_change_frame(meshes):
    """The exact-counter machinery must never perturb the frame: depth,
    winner and color are bitwise-identical with and without
    collect_stats (the ev prefix chain runs in a separate launch so the
    merge's FMA grouping is untouched, e35d513)."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 160, 42
    p = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    ft = raster_sparse.new_frame_tiles(w, h)
    a = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, dict(p.uniforms), w, h, collect_stats=False)
    b = raster_sparse.render_pass_tiles(
        ft, attrs, p.shader, dict(p.uniforms), w, h, collect_stats=True)
    for field in ("depth", "winner", "color"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a[0], field)),
            np.asarray(getattr(b[0], field)))


@pytest.mark.parametrize("slab_sy,min_won", [
    (4.0, 0),   # slab fills ALL tiles: pass 2 wins nothing (wt = 0)
    (2.6, 1),   # slab leaves border rows: pass 2 wins a FEW tiles —
                # the compacted sel-gather/shade/scatter with real
                # winners under w_cap < a_cap
])
def test_won_tile_cap_refinement_bitwise(meshes, slab_sy, min_won):
    """The won-tile shading cap (w_cap < a_cap) engages only after a
    first frame refines it; the compacted shade must stay bitwise equal
    to the uncompacted first frame.  Pass 2 is occluded geometry spread
    over every tile, winning on none or few — the worst cases for the
    compaction bookkeeping."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 256, 128                    # 2x8 tiles: quantizer can bite
    slab = np.diag([4.0, slab_sy, 0.2, 1.0])  # z~0.93 occluder
    back = np.diag([6.0, 6.0, 1.0, 1.0])   # soup spread wide and pushed
    back[2, 3] = -3.0                      # past the slab
    p1 = make_pass(meshes["cube"], GouraudShader(), view, proj,
                   model_matrix=slab)
    p2 = make_pass(meshes["soup"], GouraudShader(), view, proj,
                   model_matrix=back)

    def render():
        ft = raster_sparse.new_frame_tiles(w, h)
        offset = 0
        for p in (p1, p2):
            attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
            ft, _, ovf = raster_sparse.render_pass_tiles(
                ft, attrs, p.shader, dict(p.uniforms), w, h,
                winner_offset=offset)
            assert not bool(ovf)
            offset += attrs["position"].shape[0]
        return raster_sparse.tiles_to_buffers(ft, w, h)

    key2 = (p2.attrs["position"].shape[0], 2, 8,
            raster_tiled.TILE_H, raster_tiled.TILE_W)
    raster_sparse._SPARSE_CAPACITY.pop(key2, None)
    raster_sparse._W_REFINED.discard(key2)    # other suites may share key
    fb_first = render()                       # seeds + refines w_cap
    caps = raster_sparse._SPARSE_CAPACITY[key2]
    assert len(caps) == 3
    assert caps[2] < caps[1], (
        f"w_cap {caps[2]} did not refine below a_cap {caps[1]} — the "
        f"compacted-shade path is not being exercised")
    f1 = p1.attrs["position"].shape[0]
    won2 = int(((np.asarray(fb_first.winner) >= f1)
                .reshape(8, 16, 2, 128).any(axis=(1, 3))).sum())
    assert won2 >= min_won, f"pass 2 won {won2} tiles, wanted >= {min_won}"
    fb_second = render()                      # runs with refined w_cap
    np.testing.assert_array_equal(np.asarray(fb_first.color),
                                  np.asarray(fb_second.color))
    np.testing.assert_array_equal(np.asarray(fb_first.depth),
                                  np.asarray(fb_second.depth))
    np.testing.assert_array_equal(np.asarray(fb_first.winner),
                                  np.asarray(fb_second.winner))


def test_depth_pass_does_not_consume_won_refinement(meshes):
    """A writes_color=False pass reports the -1 'no pressure' sentinel,
    so it must neither shrink the shared key's w_cap nor consume the
    once-only refinement (capacity keys carry no shader identity — a
    shadow-map pass at frame resolution shares its key with the color
    pass of the same mesh)."""
    import jax.numpy as jnp
    from tinyrenderder_tpu.shaders import DepthShader
    view, proj = default_view()
    w, h = 256, 128
    p = make_pass(meshes["head"], DepthShader(), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    key = (attrs["position"].shape[0], 2, 8,
           raster_tiled.TILE_H, raster_tiled.TILE_W)
    raster_sparse._SPARSE_CAPACITY.pop(key, None)
    raster_sparse._W_REFINED.discard(key)
    ft = raster_sparse.new_frame_tiles(w, h)
    raster_sparse.render_pass_tiles(ft, attrs, p.shader, dict(p.uniforms),
                                    w, h)
    caps = raster_sparse._SPARSE_CAPACITY[key]
    assert key not in raster_sparse._W_REFINED, (
        "depth-only pass consumed the once-only won-tile refinement")
    assert caps[2] == caps[1], (
        f"depth-only pass shrank w_cap to {caps[2]} (a_cap {caps[1]})")


def test_staged_totals_lazy_view():
    """_StagedTotals defers the per-pass row slice (and the same-key
    element-wise max merge) to resolve time as host numpy — staging must
    not dispatch device ops (session-5 host-overhead fix) — while
    honoring the resolver protocol (is_ready/copy_to_host_async/
    __array__)."""
    import jax.numpy as jnp
    arr = jnp.asarray(np.array([[5, 2, 9, -1],
                                [3, 7, 1, -1],
                                [4, 4, 4, -1]], np.int32))
    st = raster_sparse._StagedTotals(arr, 0)
    st.merge_row(2)
    st.copy_to_host_async()               # protocol no-ops must not raise
    assert st.is_ready() in (True, False)
    np.testing.assert_array_equal(np.asarray(st), [5, 4, 9, -1])
    # sharded layout: (bands, passes, w) with axis=1 row selection keeps
    # the band axis for the resolver's own per-band max
    arr3 = jnp.asarray(np.arange(24, dtype=np.int32).reshape(2, 3, 4))
    st2 = raster_sparse._StagedTotals(arr3, 1, axis=1)
    np.testing.assert_array_equal(np.asarray(st2), np.asarray(arr3)[:, 1])


def test_fused_async_same_key_passes_fold_into_one_pending(meshes):
    """Two same-capacity-key passes in one fused async frame must stage
    ONE pending entry carrying BOTH rows: resolving it must grow the
    caps to the per-element max demand of the two passes (a single-row
    slot made the second pass's overflow invisible forever)."""
    import jax.numpy as jnp
    proj = np.asarray(math3d.perspective(60.0, 1.0, 0.1, 50.0))
    view_far = np.asarray(math3d.lookat((0, 0, 14.0), (0, 0, 0),
                                        (0, 1, 0)))
    view_near = np.asarray(math3d.lookat((0, 0, 1.6), (0, 0, 0),
                                         (0, 1, 0)))
    w, h = 128, 128
    p_far = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM),
                      view_far, proj)
    p_near = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM),
                       view_near, proj)
    attrs = {k: jnp.asarray(v) for k, v in p_far.attrs.items()}
    fused = [(attrs, p_far.shader, dict(p_far.uniforms), False),
             (attrs, p_near.shader, dict(p_near.uniforms), False)]
    key = (attrs["position"].shape[0], 1, 8,
           raster_tiled.TILE_H, raster_tiled.TILE_W)
    store = raster_sparse._SPARSE_CAPACITY
    pending = raster_sparse._SPARSE_PENDING
    store.pop(key, None)
    pending.pop(key, None)
    raster_sparse._W_REFINED.discard(key)

    # frame 1 (async): caps seed from the FAR pass (first same-key pass
    # probed); the near pass's bigger totals ride the same pending slot
    raster_sparse.render_frame_fused(fused, w, h, strict_capacity=False)
    entry = pending.get(key)
    assert entry is not None, "fused async frame staged no pending entry"
    assert getattr(entry[0], "rows", None) == [0, 1], (
        f"pending slot holds rows {getattr(entry[0], 'rows', None)}, "
        "expected both same-key passes")
    # the staged view materializes to the element-wise max of both rows
    np.testing.assert_array_equal(
        np.asarray(entry[0]),
        np.asarray(entry[0].arr)[[0, 1]].max(axis=0))
    caps_seeded = store[key]

    # frame 2: the pending resolves; pair/row caps must now cover the
    # NEAR pass's demand (a single-row slot only ever saw the far pass)
    raster_sparse.render_frame_fused(fused, w, h, strict_capacity=False)
    store_after = store[key]
    assert all(a >= b for a, b in zip(store_after, caps_seeded))
    # near-only async frames must not detect any pair/row overflow: the
    # fold already grew the caps to the max demand.  (Indices beyond the
    # first two — won tiles — legitimately differ solo vs competing.)
    near_only = [(attrs, p_near.shader, dict(p_near.uniforms), False)]
    raster_sparse.render_frame_fused(near_only, w, h,
                                     strict_capacity=False)
    raster_sparse.render_frame_fused(near_only, w, h,
                                     strict_capacity=False)   # resolves
    assert store[key][:2] == store_after[:2], (
        "async fold under-grew: near-only frames grew pair/row caps "
        f"further ({store_after[:2]} -> {store[key][:2]})")


def test_per_pass_fold_into_fused_staged_pending(meshes):
    """A per-pass async render whose capacity key holds an UNRESOLVED
    fused-staged pending entry (_StagedTotals) must fold its totals in
    without materializing or crashing (session-5 review finding:
    jnp.maximum(prev[0], vec) rejects the duck-typed view), and the
    eventual resolve must apply the element-wise max of both — across
    the width mismatch (fused coarse rows carry a trailing filler the
    per-pass (pairs, active, won) vector doesn't)."""
    import jax.numpy as jnp
    view, proj = default_view()
    w, h = 128, 128
    p = make_pass(meshes["head"], PhongShader(KEY, FILL, RIM), view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    key = (attrs["position"].shape[0], 1, 8,
           raster_tiled.TILE_H, raster_tiled.TILE_W)
    n_tiles = 8
    raster_sparse._SPARSE_CAPACITY.pop(key, None)
    raster_sparse._SPARSE_PENDING.pop(key, None)
    raster_sparse._W_REFINED.discard(key)

    # seed caps without staging a pending entry (strict mode)
    ft = raster_sparse.new_frame_tiles(w, h)
    raster_sparse.render_pass_tiles(ft, attrs, p.shader, dict(p.uniforms),
                                    w, h, strict_capacity=True)
    caps0 = raster_sparse._SPARSE_CAPACITY[key]

    class _Stuck(raster_sparse._StagedTotals):
        """Simulates an in-flight D2H (the copy may lag a frame)."""

        stuck = True

        def is_ready(self):
            return not self.stuck

    big = caps0[0] * 4
    fused_row = jnp.asarray(np.array([[big, 3, 2, -1]], np.int32))
    raster_sparse._SPARSE_PENDING[key] = (_Stuck(fused_row, 0), caps0, 0)

    # the per-pass async render must fold into the stuck entry, not crash
    raster_sparse.render_pass_tiles(ft, attrs, p.shader, dict(p.uniforms),
                                    w, h, strict_capacity=False)
    entry = raster_sparse._SPARSE_PENDING.get(key)
    assert entry is not None and isinstance(
        entry[0], raster_sparse._StagedTotals)
    assert len(entry[0].extras) == 1, "per-pass totals were not folded"
    merged = np.asarray(entry[0])
    assert merged[0] == big, "fused row's pair demand lost in the fold"
    assert merged[1] >= 1, "per-pass active count lost in the fold"

    # a not-ready entry stays pending however old (non-blocking
    # resolve); once the D2H lands, the resolve applies
    # the element-wise max: the pair cap must grow to cover the fused row
    for _ in range(9):
        raster_sparse._resolve_pending(key, n_tiles)
    assert key in raster_sparse._SPARSE_PENDING
    entry[0].stuck = False
    raster_sparse._resolve_pending(key, n_tiles)
    assert key not in raster_sparse._SPARSE_PENDING
    assert raster_sparse._SPARSE_CAPACITY[key][0] >= big
    raster_sparse._SPARSE_PENDING.pop(key, None)
    raster_sparse._SPARSE_CAPACITY.pop(key, None)
    raster_sparse._W_REFINED.discard(key)


class _SlowFuture:
    """A fake device totals vector whose D2H never lands until told to.

    Materializing it while not ready raises — proving the resolver
    never blocks on an un-landed copy."""

    def __init__(self, values):
        self._values = np.asarray(values)
        self.ready = False

    def is_ready(self):
        return self.ready

    def copy_to_host_async(self):
        pass

    def __array__(self, dtype=None, copy=None):
        if not self.ready:
            raise AssertionError(
                "resolver blocked on a not-ready D2H future")
        out = self._values
        return out if dtype is None else out.astype(dtype)


def test_pending_resolve_never_blocks_on_slow_future():
    """Age-outs must keep a not-ready pending entry, not force a
    blocking host copy (a hidden sync in the frame loop);
    once the future lands the overflow still resolves and caps grow."""
    key = ("slow-future-test", 8, 8, raster_tiled.TILE_H,
           raster_tiled.TILE_W)
    n_tiles = 64
    caps = (16, 8, 8)
    fut = _SlowFuture([999, 20, 10])       # all three totals overflow
    raster_sparse._SPARSE_CAPACITY[key] = caps
    raster_sparse._SPARSE_PENDING[key] = (fut, caps, 0)
    try:
        for i in range(20):                # way past the old age>=8 bar
            raster_sparse._resolve_pending(key, n_tiles)
            assert key in raster_sparse._SPARSE_PENDING
            assert raster_sparse._SPARSE_PENDING[key][2] == i + 1
        assert raster_sparse._SPARSE_CAPACITY[key] == caps  # no growth yet
        fut.ready = True
        raster_sparse._resolve_pending(key, n_tiles)
        assert key not in raster_sparse._SPARSE_PENDING
        grown = raster_sparse._SPARSE_CAPACITY[key]
        assert grown[0] >= 999 and grown[1] >= 20 and grown[2] >= 10
    finally:
        raster_sparse._SPARSE_PENDING.pop(key, None)
        raster_sparse._SPARSE_CAPACITY.pop(key, None)
        raster_sparse._W_REFINED.discard(key)


def test_sharded_pending_resolve_never_blocks():
    """Same non-blocking contract for the sharded per-pass resolver."""
    from tinyrenderder_tpu.parallel import dist

    key = ("slow-future-sharded", 1, 1)
    fut = _SlowFuture(4096)
    dist._SHARDED_TILED_PENDING[key] = (fut, 16, 0)
    try:
        for _ in range(20):
            dist._resolve_sharded_tiled_pending(key)
            assert key in dist._SHARDED_TILED_PENDING
        fut.ready = True
        dist._resolve_sharded_tiled_pending(key)
        assert key not in dist._SHARDED_TILED_PENDING
        assert raster_tiled._PAIR_CAPACITY.get(key, 0) >= 4096
    finally:
        dist._SHARDED_TILED_PENDING.pop(key, None)
        raster_tiled._PAIR_CAPACITY.pop(key, None)
