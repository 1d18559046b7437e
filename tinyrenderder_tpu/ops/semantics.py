"""Exact rasterization semantics, shared by the CPU oracle and the engine.

Every discontinuous decision the reference rasterizer makes — coverage
sign, z-compare, back-face sign, bbox rounding — lives here as dtype- and
array-namespace-generic formulas with a *fixed operation order* (the C++
left-to-right association of our_gl.cpp).  The NumPy float32/float64 oracle
and the f32 JAX engine call the same functions, so a pixel covered on
device is covered in the oracle and vice versa; differences can then only
come from transcendental shading math (bounded to <= 1 LSB).

Reference anchors: barycentric our_gl.cpp:77-86; triangle rejects
our_gl.cpp:94-135; affine z interpolation our_gl.cpp:156-158; z-test
our_gl.cpp:165; perspective-correct barycentric our_gl.cpp:168-185.

All functions take ``xp`` (numpy or jax.numpy) and broadcast over leading
dimensions; scalars stay 0-d arrays of the working dtype.
"""

from __future__ import annotations

__all__ = [
    "apply_mat4", "barycentric", "coverage_mask", "interp3", "affine_z",
    "perspective_correct_bary", "triangle_setup_planes",
    "W_EPS", "DEGEN_EPS", "DENOM_EPS",
]

# Thresholds exactly as in the reference (our_gl.cpp:94, :82, :177)
W_EPS = 1e-12       # w <= W_EPS -> reject triangle
DEGEN_EPS = 1e-12   # |cross.z| < DEGEN_EPS -> degenerate barycentric
DENOM_EPS = 1e-15   # |persp denom| < DENOM_EPS -> fall back to affine bary


def apply_mat4(m, v, xp):
    """4x4 matrix times column 4-vector with C++ dot-product association:
    r_i = ((m[i,0]*x + m[i,1]*y) + m[i,2]*z) + m[i,3]*w
    (geometry.h:186-192 via dot<4>, summed left to right).

    v: (..., 4); m: (4, 4).  Returns (..., 4).
    """
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    rows = []
    for i in range(4):
        r = ((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * w
        rows.append(r)
    return xp.stack(rows, axis=-1)


def barycentric(ax, ay, bx, by, cx, cy, px, py, xp, div=None):
    """Affine barycentric coordinates of P in triangle (A, B, C).

    Exact formula order of our_gl.cpp:77-86:
      s0 = (C.x-A.x, B.x-A.x, A.x-P.x); s1 = (C.y-A.y, B.y-A.y, A.y-P.y)
      u = cross(s0, s1)
      degenerate iff |u.z| < 1e-12 -> (-1, 1, 1)
      else (1 - (u.x+u.y)/u.z, u.y/u.z, u.x/u.z)

    All args broadcastable; returns (b0, b1, b2, degenerate_mask).
    ``div(a, b)`` replaces ``a / b`` where the array namespace's own
    division is not IEEE (the GPU kernel passes ``div.rn.f32``).
    """
    s0x = cx - ax
    s0y = bx - ax
    s0z = ax - px
    s1x = cy - ay
    s1y = by - ay
    s1z = ay - py
    # cross(s0, s1) with the component formulas of geometry.h:143-149
    ux = s0y * s1z - s0z * s1y
    uy = s0z * s1x - s0x * s1z
    uz = s0x * s1y - s0y * s1x
    degen = xp.abs(uz) < DEGEN_EPS
    safe_uz = xp.where(degen, xp.ones_like(uz), uz)
    if div is None:
        b0 = 1.0 - (ux + uy) / safe_uz
        b1 = uy / safe_uz
        b2 = ux / safe_uz
    else:
        b0 = 1.0 - div(ux + uy, safe_uz)
        b1 = div(uy, safe_uz)
        b2 = div(ux, safe_uz)
    neg1 = xp.asarray(-1.0, dtype=b0.dtype)
    pos1 = xp.asarray(1.0, dtype=b0.dtype)
    b0 = xp.where(degen, neg1, b0)
    b1 = xp.where(degen, pos1, b1)
    b2 = xp.where(degen, pos1, b2)
    return b0, b1, b2, degen


def coverage_mask(b0, b1, b2):
    """The reference's NaN-tolerant inside test: ``not (b < 0)`` per
    coordinate (our_gl.cpp:150-153) — NaN barycentrics fall through to
    the later z-finiteness guard rather than rejecting here.  Every
    backend must use this exact predicate (bitwise parity invariant)."""
    return ~((b0 < 0) | (b1 < 0) | (b2 < 0))


def interp3(v0, v1, v2, b0, b1, b2):
    """Barycentric blend with the shaders' association
    (main.cpp:94-104): v0*b0 + v1*b1 + v2*b2, summed left to right."""
    return v0 * b0 + v1 * b1 + v2 * b2


def affine_z(z0, z1, z2, b0, b1, b2):
    """NDC depth interpolation with *affine* barycentrics
    (our_gl.cpp:156-158)."""
    return b0 * z0 + b1 * z1 + b2 * z2


def perspective_correct_bary(b0, b1, b2, w0, w1, w2, xp):
    """Perspective-correct barycentrics from clip-space w
    (our_gl.cpp:168-185): inv_w_i = |w_i| > 1e-12 ? 1/w_i : 0;
    denom = b0*iw0 + b1*iw1 + b2*iw2; |denom| < 1e-15 -> affine fallback.

    b* broadcast over pixels; w* broadcast (per-triangle scalars).
    Returns (p0, p1, p2).
    """
    one = xp.asarray(1.0, dtype=b0.dtype)
    zero = xp.zeros_like(b0)

    def inv(w):
        w = w + zero  # broadcast per-triangle scalar to pixel shape
        bad = xp.abs(w) <= W_EPS
        return xp.where(bad, xp.zeros_like(w), one / xp.where(bad, one, w))

    iw0, iw1, iw2 = inv(w0), inv(w1), inv(w2)
    denom = b0 * iw0 + b1 * iw1 + b2 * iw2
    fallback = xp.abs(denom) < DENOM_EPS
    safe = xp.where(fallback, one, denom)
    p0 = (b0 * iw0) / safe
    p1 = (b1 * iw1) / safe
    p2 = (b2 * iw2) / safe
    p0 = xp.where(fallback, b0, p0)
    p1 = xp.where(fallback, b1, p1)
    p2 = xp.where(fallback, b2, p2)
    return p0, p1, p2


def triangle_setup_planes(clip, viewport_mat, width, height, xp):
    """Per-triangle setup: rejects, NDC, screen coords, clamped bbox.

    Reproduces our_gl.cpp:89-135 decision-for-decision, vectorized over an
    arbitrary leading shape.  ``clip``: (..., 3, 4) clip-space vertices.

    Returns a dict of arrays (leading shape preserved):
      valid      bool — triangle survives all whole-triangle rejects
      screen     (..., 3, 2) screen-space xy
      ndc_z      (..., 3)
      clip_w     (..., 3)
      bbox       (..., 4) int32: min_x, max_x, min_y, max_y (clamped)
    """
    w = clip[..., 3]
    # reject if any w <= 1e-12 (covers the duplicate |w| < eps check)
    w_ok = xp.all(w > W_EPS, axis=-1)

    safe_w = xp.where(w == 0, xp.ones_like(w), w)
    ndc = clip / safe_w[..., None]

    # reject iff ALL three NDC z outside [-1, 1] (no near-plane clipping)
    z = ndc[..., 2]
    z_out = (z < -1.0) | (z > 1.0)
    z_ok = ~xp.all(z_out, axis=-1)

    # reject on any non-finite NDC component
    finite_ok = xp.all(xp.isfinite(ndc), axis=(-2, -1))

    # triangles failing the finite check are rejected anyway; zero their NDC
    # so no NaN/Inf reaches the bbox float->int casts below
    ndc = xp.where(xp.isfinite(ndc), ndc, xp.zeros_like(ndc))

    screen4 = apply_mat4(viewport_mat, ndc, xp)
    sx = screen4[..., 0]
    sy = screen4[..., 1]

    # back-face cull: screen-space edge cross must be > 0 (CCW front,
    # our_gl.cpp:124-127)
    e1x = sx[..., 1] - sx[..., 0]
    e1y = sy[..., 1] - sy[..., 0]
    e2x = sx[..., 2] - sx[..., 0]
    e2y = sy[..., 2] - sy[..., 0]
    cross = e1x * e2y - e1y * e2x
    facing_ok = cross > 0

    # clamped integer bbox (our_gl.cpp:130-135)
    min_xf = xp.floor(xp.min(sx, axis=-1))
    max_xf = xp.ceil(xp.max(sx, axis=-1))
    min_yf = xp.floor(xp.min(sy, axis=-1))
    max_yf = xp.ceil(xp.max(sy, axis=-1))
    # guard the float->int cast against overflow before taking max/min with
    # the screen bounds (the C++ int cast of a huge double is UB we avoid;
    # any clamp beyond the screen gives the same empty/clamped box)
    big = 2**30
    min_x = xp.maximum(0, xp.clip(min_xf, -big, big).astype(xp.int32))
    max_x = xp.minimum(width - 1, xp.clip(max_xf, -big, big).astype(xp.int32))
    min_y = xp.maximum(0, xp.clip(min_yf, -big, big).astype(xp.int32))
    max_y = xp.minimum(height - 1, xp.clip(max_yf, -big, big).astype(xp.int32))
    bbox_ok = (min_x <= max_x) & (min_y <= max_y)

    valid = w_ok & z_ok & finite_ok & facing_ok & bbox_ok
    return {
        "valid": valid,
        "screen": xp.stack([sx, sy], axis=-1),
        "ndc_z": z,
        "clip_w": w,
        "bbox": xp.stack([min_x, max_x, min_y, max_y], axis=-1),
    }
