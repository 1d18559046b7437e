"""Reference-scale disk-asset pipeline test.

Generates a 27360-face head OBJ + MTL + three real TGA texture maps on
disk (african_head is ~25k faces, main.cpp:478), loads it back through
the full pipeline (tokenizer -> Mesh -> MTL probe -> TGA codec ->
Material), renders the CLI default scene via the argv[1] model-override
path (main.cpp:478) on xla AND tiled backends, and pins the output
against checked-in goldens.  Regenerate goldens (only after intentional
semantics changes) with:
    JAX_PLATFORMS=cpu python scripts/gen_real_asset.py <dir> --golden
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from gen_real_asset import (GOLDEN_H, GOLDEN_W, generate,  # noqa: E402
                            head_mesh, render_cli)
from tinyrenderder_tpu.models.obj import load_obj  # noqa: E402
from tinyrenderder_tpu.utils import tga  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("real_asset")
    generate(str(d))
    return str(d)


def test_disk_roundtrip_at_scale(asset_dir):
    """load_obj of the written file reproduces the in-memory mesh."""
    mem = head_mesh()
    disk = load_obj(os.path.join(asset_dir, "head.obj"))
    assert disk.nfaces == mem.nfaces == 27360
    ma, da = mem.face_attributes(np.float32), disk.face_attributes(np.float32)
    np.testing.assert_array_equal(ma["position"], da["position"])
    np.testing.assert_array_equal(ma["normal"], da["normal"])
    # uv v-channel passes through 1-(1-v): one rounding each way
    np.testing.assert_allclose(ma["uv"], da["uv"], atol=1.2e-7)
    # textures round-trip bit-exactly through MTL probe + TGA codec
    m, d = mem.materials[0], disk.materials[0]
    np.testing.assert_array_equal(m.diffuse, d.diffuse)
    np.testing.assert_array_equal(m.normal, d.normal)
    np.testing.assert_array_equal(m.specular, d.specular)


@pytest.mark.parametrize("backend", ["xla", "tiled"])
def test_cli_real_asset_golden(asset_dir, tmp_path, backend):
    """Full CLI run (argv[1] override, main.cpp:478) from real disk files
    at reference scale, pinned against the checked-in golden."""
    out = str(tmp_path / backend)
    os.makedirs(out)
    render_cli(os.path.join(asset_dir, "head.obj"), out, backend=backend)
    for name, tol in (("phong", 1), ("final", 2)):
        golden = tga.read(os.path.join(
            GOLDEN_DIR, f"real_head_cli_{name}.tga")).to_rgb()[::-1]
        got = tga.read(os.path.join(out, f"{name}.tga")).to_rgb()[::-1]
        assert got.shape == (GOLDEN_H, GOLDEN_W, 3)
        delta = np.abs(got.astype(int) - golden.astype(int))
        # nonzero pixels must be close; allow a couple of z-tie /
        # SSAO-threshold edge pixels to move between backends
        assert delta.max() <= tol or (delta > tol).any(-1).sum() <= 2, (
            f"{backend}/{name}: max delta {delta.max()}, "
            f"{(delta > tol).any(-1).sum()} px differ")
