"""ctypes bindings to the native C++ runtime helpers (native/*.cpp).

The reference's host runtime is entirely C++ (codec, loader); the
JAX framework keeps the compute path in XLA/Pallas and implements
the host-side hot loops (TGA RLE codec, OBJ tokenizer) in C++ too, built
as ``native/libtinyrenderder_native.so`` via ``make -C native``.

Everything degrades gracefully to the pure-Python implementations when the
shared library hasn't been built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_NAME = "libtinyrenderder_native.so"
_lib: ctypes.CDLL | None = None
_checked = False


def _load() -> ctypes.CDLL | None:
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", _LIB_NAME),
                 os.path.join(here, _LIB_NAME)):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            lib.trd_rle_decode.restype = ctypes.c_longlong
            lib.trd_rle_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_longlong, ctypes.c_int]
            lib.trd_rle_encode.restype = ctypes.c_longlong
            lib.trd_rle_encode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
            if hasattr(lib, "trd_obj_parse"):
                lib.trd_obj_parse.restype = ctypes.c_void_p
                lib.trd_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
                for name in ("trd_obj_nverts", "trd_obj_nindices",
                             "trd_obj_nsubmeshes", "trd_obj_nmaterials",
                             "trd_obj_names_len"):
                    getattr(lib, name).restype = ctypes.c_longlong
                lib.trd_obj_nverts.argtypes = [ctypes.c_void_p]
                lib.trd_obj_nindices.argtypes = [ctypes.c_void_p]
                lib.trd_obj_nsubmeshes.argtypes = [ctypes.c_void_p]
                lib.trd_obj_nmaterials.argtypes = [ctypes.c_void_p]
                lib.trd_obj_flags.restype = ctypes.c_int
                lib.trd_obj_flags.argtypes = [ctypes.c_void_p]
                lib.trd_obj_copy.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_longlong)]
                lib.trd_obj_names_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.trd_obj_names.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_char_p]
                lib.trd_obj_free.argtypes = [ctypes.c_void_p]
            _lib = lib
            break
    return _lib


def available() -> bool:
    return _load() is not None


def rle_decode(raw: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    lib = _load()
    out = np.empty((h * w, bpp), dtype=np.uint8)
    n = lib.trd_rle_decode(
        raw, len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h * w, bpp)
    if n != h * w:
        raise ValueError(f"RLE decode produced {n} of {h * w} pixels")
    return out


def obj_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "trd_obj_parse")


def parse_obj(path: str, default_group: str):
    """Parse an OBJ's geometry via the C++ tokenizer.

    Returns (positions (V,3) f64, uvs (V,2), normals (V,3), faces (F,3)
    i32, submesh_table (S,3) [start_index, index_count, material] i64,
    material_names, group_names, mtllib_paths, any_uv, any_norm) or None
    on open failure.
    """
    lib = _load()
    h = lib.trd_obj_parse(path.encode(), default_group.encode())
    if not h:
        return None
    try:
        nv = lib.trd_obj_nverts(h)
        ni = lib.trd_obj_nindices(h)
        ns = lib.trd_obj_nsubmeshes(h)
        flags = lib.trd_obj_flags(h)
        if flags & 4:
            # a numeric token failed to parse fully — the Python
            # fallback raises ValueError there, so the native path must
            # behave the same (loader choice must not change semantics)
            raise ValueError(f"malformed numeric token in OBJ: {path}")
        pos = np.empty((nv, 3), np.float64)
        uv = np.empty((nv, 2), np.float64)
        nrm = np.empty((nv, 3), np.float64)
        faces = np.empty(ni, np.int32)
        sub = np.empty((ns, 3), np.int64)
        lib.trd_obj_copy(
            h,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sub.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))

        def names(which: int) -> list[str]:
            n = lib.trd_obj_names_len(h, which)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            lib.trd_obj_names(h, which, buf)
            return buf.raw[:n].decode(errors="replace").split("\n")

        return (pos, uv, nrm, faces.reshape(-1, 3), sub,
                names(0), names(1), names(2),
                bool(flags & 1), bool(flags & 2))
    finally:
        lib.trd_obj_free(h)


def rle_encode(flat: np.ndarray, bpp: int) -> bytes:
    lib = _load()
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    npix = flat.shape[0]
    # worst case: every pixel is its own raw chunk (1 header + bpp bytes)
    cap = npix * (bpp + 1) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.trd_rle_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), npix, bpp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError("RLE encode overflow")
    return out[:n].tobytes()
