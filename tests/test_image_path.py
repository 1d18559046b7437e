"""Single-pass direct-to-image fast path
(raster_sparse.render_frame_fused_image) parity tests.

The image path skips the depth/winner tile materialization and the
3-plane untile of the general fused frame; its colors must stay
BITWISE identical to tiles_to_buffers(render_frame_fused(...)).color
at both tile heights and for both placement variants (the
cross-backend exactness invariant)."""

import numpy as np
import pytest

from helpers import default_view, make_pass, standard_meshes
from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.ops import raster_sparse
from tinyrenderder_tpu.shaders import GouraudShader, PhongShader

KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes()


def _clear_caches():
    raster_sparse._SPARSE_CAPACITY.clear()
    raster_sparse._SPARSE_PENDING.clear()
    raster_sparse._W_REFINED.clear()


def _one_pass(meshes, name="head", shader=None):
    import jax.numpy as jnp
    view, proj = default_view()
    shader = shader or PhongShader(KEY, FILL, RIM, normal_map_strength=0.5)
    p = make_pass(meshes[name], shader, view, proj)
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    return [(attrs, p.shader, dict(p.uniforms), False)]


def _reference_color(passes, w, h, tile_h=16):
    ft, _, ovf = raster_sparse.render_frame_fused(passes, w, h,
                                                  tile_h=tile_h,
                                                  strict_capacity=True)
    assert not bool(ovf)
    return np.asarray(raster_sparse.tiles_to_buffers(
        ft, w, h, tile_h=tile_h).color)


@pytest.mark.parametrize("tile_h", [16, 32])
@pytest.mark.parametrize("direct", [True, False])
def test_image_matches_fused_per_mode(meshes, tile_h, direct):
    w, h = 256, 128
    try:
        _clear_caches()
        passes = _one_pass(meshes)
        ref = _reference_color(passes, w, h, tile_h)
        img, ovf = raster_sparse.render_frame_fused_image(
            passes, w, h, tile_h=tile_h, strict_capacity=True,
            direct=direct)
        assert not bool(ovf)
        np.testing.assert_array_equal(np.asarray(img), ref)
    finally:
        _clear_caches()


def test_image_ragged_frame(meshes):
    """Non-tile-aligned width/height: the padded placement must crop to
    exactly the general path's image."""
    w, h = 160, 42
    try:
        _clear_caches()
        passes = _one_pass(meshes, "soup", GouraudShader())
        ref = _reference_color(passes, w, h)
        for direct in (True, False):
            img, _ = raster_sparse.render_frame_fused_image(
                passes, w, h, strict_capacity=True, direct=direct)
            np.testing.assert_array_equal(np.asarray(img), ref)
    finally:
        _clear_caches()


def test_image_async_capacity_and_growth(meshes):
    """Async mode stages totals for the next frame; deliberately tiny
    seeded caps must overflow, flag the frame, then grow via the pending
    resolve so a later frame is exact."""
    w, h = 256, 128
    try:
        _clear_caches()
        passes = _one_pass(meshes)
        ref = _reference_color(passes, w, h)
        f = passes[0][0]["position"].shape[0]
        key = (f, 2, 8, 16, 128)
        _clear_caches()
        raster_sparse._SPARSE_CAPACITY[key] = (8, 8, 8)
        img, ovf = raster_sparse.render_frame_fused_image(
            passes, w, h, strict_capacity=False)
        assert bool(np.asarray(ovf))          # same-frame overflow flag
        # let the staged totals land, then resolve + re-render
        np.asarray(img)
        for _ in range(4):
            img, ovf = raster_sparse.render_frame_fused_image(
                passes, w, h, strict_capacity=False)
            if not bool(np.asarray(ovf)):
                break
            np.asarray(img)
        assert not bool(np.asarray(ovf))
        np.testing.assert_array_equal(np.asarray(img), ref)
    finally:
        _clear_caches()


def test_image_strict_growth_loop(meshes):
    """Strict mode with undersized seeded caps must grow and re-render
    within the call, returning the exact image."""
    w, h = 256, 128
    try:
        _clear_caches()
        passes = _one_pass(meshes)
        ref = _reference_color(passes, w, h)
        f = passes[0][0]["position"].shape[0]
        key = (f, 2, 8, 16, 128)
        _clear_caches()
        raster_sparse._SPARSE_CAPACITY[key] = (8, 8, 8)
        img, ovf = raster_sparse.render_frame_fused_image(
            passes, w, h, strict_capacity=True)
        assert not bool(np.asarray(ovf))
        np.testing.assert_array_equal(np.asarray(img), ref)
    finally:
        _clear_caches()


def test_image_rejects_bad_passes(meshes):
    passes = _one_pass(meshes)
    with pytest.raises(ValueError):
        raster_sparse.render_frame_fused_image(passes * 2, 256, 128)
    from tinyrenderder_tpu.shaders import DepthShader
    bad = [(passes[0][0], DepthShader(),
            DepthShader().build_uniforms(np.eye(4), np.eye(4), None,
                                         np.float32), False)]
    with pytest.raises(ValueError):
        raster_sparse.render_frame_fused_image(bad, 256, 128)
