"""glTF loader tests: GLB container == .gltf+bin == data-URI, accessor
decoding (strides, normalized ints, sparse), node-transform baking,
strip/fan triangulation, multi-primitive submeshes, embedded textures,
UV flip parity with OBJ, manager dispatch."""

import base64
import json
import struct
import sys

import numpy as np
import pytest

from tinyrenderder_tpu.models.gltf import load_gltf
from tinyrenderder_tpu.models.obj import load_obj

# the shared quad: 4 vertices, 2 triangles (same geometry as test_stl)
POS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
IDX = np.array([0, 1, 2, 0, 2, 3], np.uint16)


def _quad_json(buffer_entry, with_uv=True):
    pos_len = POS.nbytes
    uv_len = UV.nbytes if with_uv else 0
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": pos_len},
        {"buffer": 0, "byteOffset": pos_len, "byteLength": uv_len},
        {"buffer": 0, "byteOffset": pos_len + uv_len,
         "byteLength": IDX.nbytes},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 4,
         "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
        {"bufferView": 1, "componentType": 5126, "count": 4,
         "type": "VEC2"},
        {"bufferView": 2, "componentType": 5123, "count": 6,
         "type": "SCALAR"},
    ]
    attrs = {"POSITION": 0}
    if with_uv:
        attrs["TEXCOORD_0"] = 1
    return {
        "asset": {"version": "2.0"},
        "buffers": [buffer_entry],
        "bufferViews": views,
        "accessors": accessors,
        "meshes": [{"name": "quad", "primitives": [
            {"attributes": attrs, "indices": 2}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }


def _quad_bin(with_uv=True):
    parts = [POS.tobytes()]
    if with_uv:
        parts.append(UV.tobytes())
    parts.append(IDX.tobytes())
    return b"".join(parts)


def _write_glb(path, j, bin_data):
    jb = json.dumps(j).encode()
    jb += b" " * (-len(jb) % 4)
    bb = bin_data + b"\x00" * (-len(bin_data) % 4)
    body = (struct.pack("<II", len(jb), 0x4E4F534A) + jb
            + struct.pack("<II", len(bb), 0x004E4942) + bb)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def _check_quad(m):
    assert m.nverts == 4 and m.nfaces == 2
    np.testing.assert_allclose(m.positions, POS.astype(np.float64))
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [0, 2, 3]])
    # aiProcess_FlipUVs applied
    np.testing.assert_allclose(m.uvs[:, 1], 1.0 - UV[:, 1])
    # generated area-weighted normals
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4, atol=1e-12)


def test_glb_roundtrip(tmp_path):
    bin_data = _quad_bin()
    j = _quad_json({"byteLength": len(bin_data)})
    p = tmp_path / "m.glb"
    _write_glb(p, j, bin_data)
    _check_quad(load_gltf(str(p), load_textures=False))


def test_gltf_external_bin_and_data_uri(tmp_path):
    bin_data = _quad_bin()
    (tmp_path / "m.bin").write_bytes(bin_data)
    j = _quad_json({"uri": "m.bin", "byteLength": len(bin_data)})
    p1 = tmp_path / "m.gltf"
    p1.write_text(json.dumps(j))
    m1 = load_gltf(str(p1), load_textures=False)

    uri = ("data:application/octet-stream;base64,"
           + base64.b64encode(bin_data).decode())
    j2 = _quad_json({"uri": uri, "byteLength": len(bin_data)})
    p2 = tmp_path / "d.gltf"
    p2.write_text(json.dumps(j2))
    m2 = load_gltf(str(p2), load_textures=False)

    for m in (m1, m2):
        _check_quad(m)
    np.testing.assert_array_equal(m1.positions, m2.positions)


def test_gltf_matches_obj_geometry(tmp_path):
    """Same quad via glTF and OBJ -> identical positions/faces/uvs
    (shared postprocess contract incl. the V flip)."""
    bin_data = _quad_bin()
    j = _quad_json({"byteLength": len(bin_data)})
    pg = tmp_path / "m.glb"
    _write_glb(pg, j, bin_data)
    po = tmp_path / "m.obj"
    po.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                  "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                  "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    mg = load_gltf(str(pg), load_textures=False)
    mo = load_obj(str(po), load_textures=False)
    np.testing.assert_array_equal(mg.positions, mo.positions)
    np.testing.assert_array_equal(mg.faces, mo.faces)
    np.testing.assert_allclose(mg.uvs, mo.uvs)


def test_gltf_node_transform_baked(tmp_path):
    """TRS node transforms multiply into the vertices
    (aiProcess_PreTransformVertices analogue)."""
    bin_data = _quad_bin()
    j = _quad_json({"byteLength": len(bin_data)})
    j["nodes"] = [
        {"children": [1], "translation": [10, 0, 0]},
        {"mesh": 0, "scale": [2, 2, 2]},
    ]
    j["scenes"] = [{"nodes": [0]}]
    p = tmp_path / "t.glb"
    _write_glb(p, j, bin_data)
    m = load_gltf(str(p), load_textures=False)
    np.testing.assert_allclose(
        m.positions, POS.astype(np.float64) * 2 + [10, 0, 0])
    # rotation via matrix node: 90 deg about x maps +z normal to -y
    rot = [1, 0, 0, 0,
           0, 0, 1, 0,
           0, -1, 0, 0,
           0, 0, 0, 1]              # column-major glTF matrix
    j["nodes"] = [{"mesh": 0, "matrix": rot}]
    _write_glb(p, j, bin_data)
    m2 = load_gltf(str(p), load_textures=False)
    np.testing.assert_allclose(m2.normals, [[0, -1, 0]] * 4, atol=1e-12)


def test_gltf_strip_and_fan(tmp_path):
    """Primitive modes 5/6 triangulate to the same quad as mode 4."""
    for mode, idx in ((5, np.array([0, 1, 3, 2], np.uint16)),
                      (6, np.array([0, 1, 2, 3], np.uint16))):
        pos = POS.tobytes()
        ib = idx.tobytes()
        j = {
            "asset": {"version": "2.0"},
            "buffers": [{"byteLength": len(pos) + len(ib)}],
            "bufferViews": [
                {"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
                {"buffer": 0, "byteOffset": len(pos), "byteLength": len(ib)},
            ],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 4,
                 "type": "VEC3"},
                {"bufferView": 1, "componentType": 5123,
                 "count": idx.size, "type": "SCALAR"},
            ],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                        "indices": 1, "mode": mode}]}],
            "nodes": [{"mesh": 0}],
            "scenes": [{"nodes": [0]}],
        }
        p = tmp_path / f"m{mode}.glb"
        _write_glb(p, j, pos + ib)
        m = load_gltf(str(p), load_textures=False)
        assert m.nfaces == 2
        # every triangle's generated normal faces +z (consistent winding)
        e1 = m.positions[m.faces[:, 1]] - m.positions[m.faces[:, 0]]
        e2 = m.positions[m.faces[:, 2]] - m.positions[m.faces[:, 0]]
        assert (np.cross(e1, e2)[:, 2] > 0).all(), f"mode {mode} winding"


def test_gltf_interleaved_and_normalized(tmp_path):
    """byteStride-interleaved POSITION/TEXCOORD + normalized u16 UVs."""
    # layout per vertex: 3f32 pos + 2u16 normalized uv + 4 pad = 20 bytes
    rows = []
    uv16 = (UV * 65535).round().astype(np.uint16)
    for i in range(4):
        rows.append(POS[i].tobytes() + uv16[i].tobytes() + b"\x00" * 4)
    vtx = b"".join(rows)
    ib = IDX.tobytes()
    j = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(vtx) + len(ib)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vtx),
             "byteStride": 20},
            {"buffer": 0, "byteOffset": len(vtx), "byteLength": len(ib)},
        ],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
             "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5123,
             "count": 4, "type": "VEC2", "normalized": True},
            {"bufferView": 1, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
             "indices": 2}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    p = tmp_path / "i.glb"
    _write_glb(p, j, vtx + ib)
    m = load_gltf(str(p), load_textures=False)
    np.testing.assert_allclose(m.positions, POS.astype(np.float64))
    np.testing.assert_allclose(m.uvs[:, 1], 1.0 - UV[:, 1], atol=1e-4)


def test_gltf_sparse_accessor(tmp_path):
    """Sparse substitution overrides base accessor values."""
    bin_data = _quad_bin(with_uv=False)
    # sparse patch: move vertex 2 to (5,5,0)
    sp_idx = np.array([2], np.uint16).tobytes()
    sp_val = np.array([[5, 5, 0]], np.float32).tobytes()
    base = bin_data + sp_idx + sp_val
    j = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(base)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": POS.nbytes},
            {"buffer": 0, "byteOffset": POS.nbytes,
             "byteLength": IDX.nbytes},
            {"buffer": 0, "byteOffset": POS.nbytes + IDX.nbytes,
             "byteLength": len(sp_idx)},
            {"buffer": 0, "byteOffset": POS.nbytes + IDX.nbytes
             + len(sp_idx), "byteLength": len(sp_val)},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3", "sparse": {
                 "count": 1,
                 "indices": {"bufferView": 2, "componentType": 5123},
                 "values": {"bufferView": 3}}},
            {"bufferView": 1, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    p = tmp_path / "s.glb"
    _write_glb(p, j, base)
    m = load_gltf(str(p), load_textures=False)
    np.testing.assert_allclose(m.positions[2], [5, 5, 0])


def test_gltf_embedded_texture_and_submeshes(tmp_path):
    """GLB with an embedded PNG baseColorTexture + 2 primitives ->
    2 SubMesh ranges with per-range materials; texture decodes RGB."""
    PIL = pytest.importorskip("PIL.Image")
    import io
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 0] = 200
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG")
    png = buf.getvalue()

    pos = POS.tobytes()
    uv = UV.tobytes()
    i1 = np.array([0, 1, 2], np.uint16).tobytes()
    i2 = np.array([0, 2, 3], np.uint16).tobytes()
    bin_data = pos + uv + i1 + i2 + png
    o = 0
    views = []
    for ln in (len(pos), len(uv), len(i1), len(i2), len(png)):
        views.append({"buffer": 0, "byteOffset": o, "byteLength": ln})
        o += ln
    j = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
            {"bufferView": 3, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "textures": [{"source": 0}],
        "materials": [
            {"name": "tex", "pbrMetallicRoughness":
             {"baseColorTexture": {"index": 0}}},
            {"name": "plain"},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
             "indices": 2, "material": 0},
            {"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
             "indices": 3, "material": 1},
        ]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
    }
    p = tmp_path / "t.glb"
    _write_glb(p, j, bin_data)
    m = load_gltf(str(p))
    assert len(m.submeshes) == 2
    assert m.submeshes[0].material_index == 0
    assert m.submeshes[1].material_index == 1
    assert m.materials[0].has_diffuse
    assert not m.materials[1].has_diffuse
    np.testing.assert_array_equal(m.materials[0].diffuse[..., 0], 200)
    # the two primitives duplicated the 4 shared vertices
    assert m.nverts == 8 and m.nfaces == 2


def test_gltf_default_material_not_materials0(tmp_path):
    """A primitive without a 'material' property gets the default
    material (spec), not materials[0] — it must not steal another
    material's texture maps."""
    PIL = pytest.importorskip("PIL.Image")
    import io
    img = np.full((2, 2, 3), 77, np.uint8)
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG")
    png = buf.getvalue()

    bin_data = _quad_bin() + png
    j = _quad_json({"byteLength": len(bin_data)})
    j["bufferViews"].append({"buffer": 0,
                             "byteOffset": len(bin_data) - len(png),
                             "byteLength": len(png)})
    j["images"] = [{"bufferView": 3, "mimeType": "image/png"}]
    j["textures"] = [{"source": 0}]
    j["materials"] = [{"name": "tex", "pbrMetallicRoughness":
                       {"baseColorTexture": {"index": 0}}}]
    # the primitive deliberately has NO "material" key
    p = tmp_path / "d.glb"
    _write_glb(p, j, bin_data)
    m = load_gltf(str(p))
    sm = m.submeshes[0]
    assert m.materials[sm.material_index].name == "__gltf_default__"
    assert not m.materials[sm.material_index].has_diffuse


def test_gltf_embedded_texture_without_pillow(tmp_path, monkeypatch):
    """Pillow is optional: without it an embedded PNG texture raises an
    ImportError that names the missing package."""
    png = b"\x89PNG\r\n\x1a\n" + b"\x00" * 8
    bin_data = _quad_bin() + png
    j = _quad_json({"byteLength": len(bin_data)})
    j["bufferViews"].append({"buffer": 0,
                             "byteOffset": len(bin_data) - len(png),
                             "byteLength": len(png)})
    j["images"] = [{"bufferView": 3, "mimeType": "image/png"}]
    j["textures"] = [{"source": 0}]
    j["materials"] = [{"name": "tex", "pbrMetallicRoughness":
                       {"baseColorTexture": {"index": 0}}}]
    j["meshes"][0]["primitives"][0]["material"] = 0
    p = tmp_path / "np.glb"
    _write_glb(p, j, bin_data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_gltf(str(p))


def test_gltf_truncated_raises(tmp_path):
    p = tmp_path / "bad.glb"
    p.write_bytes(struct.pack("<III", 0x46546C67, 2, 100) + b"\x00" * 4)
    with pytest.raises(ValueError):
        load_gltf(str(p), load_textures=False)
    bin_data = _quad_bin()
    j = _quad_json({"byteLength": len(bin_data) + 64})   # declares too much
    p2 = tmp_path / "short.glb"
    _write_glb(p2, j, bin_data)
    with pytest.raises(ValueError, match="truncated"):
        load_gltf(str(p2), load_textures=False)


def test_gltf_manager_dispatch_and_render(tmp_path):
    """Manager routes .glb; the loaded mesh renders through the scene
    pipeline like any other format."""
    from tinyrenderder_tpu.models.manager import load_mesh
    bin_data = _quad_bin()
    j = _quad_json({"byteLength": len(bin_data)})
    p = tmp_path / "m.glb"
    _write_glb(p, j, bin_data)
    m = load_mesh(str(p), load_textures=False)
    assert m.nfaces == 2

    from tinyrenderder_tpu.camera import Camera
    from tinyrenderder_tpu.scene import Scene
    from tinyrenderder_tpu.shaders import FlatShader
    cam = Camera()
    cam.auto_setup_for_scene(m.get_local_aabb(), aspect=1.0)
    scene = Scene(camera=cam, width=64, height=64)
    scene.add(m, np.eye(4), FlatShader(), name="quad")
    out = scene.render(backend="xla")
    assert out.color.shape == (64, 64, 3)
    assert (np.asarray(out.color).sum(axis=-1) > 0).any()
