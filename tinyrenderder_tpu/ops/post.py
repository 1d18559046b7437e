"""Post-processing: z-buffer visualization, SSAO, final composite.

Capability-parity targets:
  * save_zbuffer_image (main.cpp:269-314): normalize finite depths to
    [min, max], nearer = darker, infinite = white.
  * compute_ssao_at (main.cpp:317-362): horizon-style screen-space ambient
    occlusion over the depth buffer — 8 directions x 8 radial steps out to
    16 px; a sample occludes when its depth is more than 1e-3 nearer than
    the center; AO = 1 - 0.35 * occluded/total.  Out-of-bounds samples are
    skipped entirely; infinite samples count toward the total but never
    occlude; infinite centers get AO 1.0.
  * composite (main.cpp:768-786): final = phong * ao per channel with
    min(255, .) and truncating uint8 casts.

The reference's per-pixel 64-tap gather loop becomes 64 statically-shifted
array comparisons (dx, dy are pixel-independent: the C ``round(px + t)``
equals ``px + round(t)`` for every tap because no tap offset lands exactly
on a .5 tie).  Functions are xp-generic (numpy or jax.numpy) so the same
code is the float64 oracle and the f32 device path.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["zbuffer_to_image", "ssao_offsets", "ssao_map", "ssao_image",
           "composite", "AO_NUM_DIRECTIONS", "AO_STEPS_PER_DIRECTION",
           "AO_SAMPLE_RADIUS", "AO_OCCLUSION_THRESHOLD", "AO_INTENSITY"]

# SSAO parameters (main.cpp:317-321)
AO_NUM_DIRECTIONS = 8
AO_STEPS_PER_DIRECTION = 8
AO_SAMPLE_RADIUS = 16.0
AO_OCCLUSION_THRESHOLD = 1e-3
AO_INTENSITY = 0.35


def zbuffer_to_image(zbuffer, xp) -> "xp.ndarray":
    """Grayscale (H, W) uint8 view of a depth buffer (main.cpp:269-314).

    NOTE the reference's comment says "nearer = darker" but its CODE
    (value = 255*(1-normalized), main.cpp:306-307) maps the NEAREST
    depth to 255 (white, same as the infinite background) and the
    farthest to 0.  Parity targets the code, not the comment — this
    deliberately reproduces the inverted-looking gradient."""
    finite = xp.isfinite(zbuffer)
    any_finite = xp.any(finite)
    big = xp.asarray(1e9, dtype=zbuffer.dtype)
    zmin = xp.min(xp.where(finite, zbuffer, big))
    zmax = xp.max(xp.where(finite, zbuffer, -big))
    # degenerate range guard (main.cpp:294-296).  The reference's
    # ``zmin + 1e-7`` only works in double; in the device's float32 it
    # is a NO-OP whenever |zmin| > ~2^4 (1e-7 < half an ulp), leaving
    # 0/0 = NaN bytes where the f64 path yields 255 — so divide by a
    # positive-clamped denominator instead: an all-equal buffer gets
    # normalized = 0 -> 255 everywhere, exactly the f64 outcome.
    zmax = xp.where(zmax - zmin < 1e-7, zmin + 1e-7, zmax)
    denom = zmax - zmin
    denom = xp.where(denom > 0, denom, xp.ones_like(denom))
    normalized = (zbuffer - zmin) / denom
    value = xp.trunc(255.0 * (1.0 - normalized))  # nearer = darker
    value = xp.where(finite, value, 255.0)
    value = xp.where(any_finite, value, xp.full_like(value, 255.0))
    return xp.clip(value, 0, 255).astype(xp.uint8)


def ssao_offsets() -> list[tuple[int, int]]:
    """The 64 integer (dx, dy) taps of compute_ssao_at (main.cpp:332-339),
    with C round-half-away-from-zero semantics."""
    def c_round(v: float) -> int:
        return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))

    taps = []
    for direction in range(AO_NUM_DIRECTIONS):
        angle = 2.0 * math.pi * direction / AO_NUM_DIRECTIONS
        dx, dy = math.cos(angle), math.sin(angle)
        for step in range(1, AO_STEPS_PER_DIRECTION + 1):
            radius = step / AO_STEPS_PER_DIRECTION * AO_SAMPLE_RADIUS
            taps.append((c_round(dx * radius), c_round(dy * radius)))
    return taps


def ssao_map(zbuffer, xp):
    """Ambient-occlusion factor per pixel in [0.65, 1.0] as working-dtype
    floats (main.cpp:324-362)."""
    h, w = zbuffer.shape
    dtype = zbuffer.dtype
    nan = xp.asarray(xp.nan, dtype=dtype)
    pad = 17  # max |offset| is 16
    zpad = xp.full((h + 2 * pad, w + 2 * pad), nan, dtype=dtype)
    if xp is np:
        zpad[pad:pad + h, pad:pad + w] = zbuffer
    else:
        zpad = zpad.at[pad:pad + h, pad:pad + w].set(zbuffer)

    center = zbuffer
    occluded = xp.zeros((h, w), dtype=xp.int32)
    total = xp.zeros((h, w), dtype=xp.int32)
    threshold_ref = center - AO_OCCLUSION_THRESHOLD
    for dx, dy in ssao_offsets():
        sample = zpad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        in_bounds = ~xp.isnan(sample)           # NaN padding marks off-screen
        finite = xp.isfinite(sample)
        total = total + in_bounds.astype(xp.int32)
        occluded = occluded + (finite & (sample < threshold_ref)).astype(xp.int32)

    ratio = occluded.astype(dtype) / xp.maximum(total, 1).astype(dtype)
    ao = 1.0 - ratio * AO_INTENSITY
    ao = xp.where(total == 0, xp.ones_like(ao), ao)
    ao = xp.where(xp.isfinite(center), ao, xp.ones_like(ao))
    return ao


def ssao_image(ao, xp):
    """AO factor -> grayscale uint8 (main.cpp:760-761, truncating cast)."""
    return xp.trunc(255.0 * ao).astype(xp.uint8)


_POSTPROCESS_JIT = None


def postprocess_device(color_u8, depth):
    """Full post pipeline (z visualization, SSAO, composite) as one
    jitted device dispatch: (zbuffer_img, ao_img, final) uint8 arrays.

    Byte-identical to the numpy path (the SSAO taps and all casts are
    shared); used by the CLI on device backends so the 64-tap stencil
    runs as 64 shifted-plane compares on the VPU instead of host loops.
    """
    global _POSTPROCESS_JIT
    import jax
    import jax.numpy as jnp

    if _POSTPROCESS_JIT is None:
        def _run(color_u8, depth):
            zimg = zbuffer_to_image(depth, jnp)
            ao = ssao_map(depth, jnp)
            ao_u8 = ssao_image(ao, jnp)
            final = composite(color_u8, ao_u8, jnp)
            return zimg, ao_u8, final

        _POSTPROCESS_JIT = jax.jit(_run)
    return _POSTPROCESS_JIT(jnp.asarray(color_u8), jnp.asarray(depth))


def composite(color, ao_intensity_u8, xp):
    """final = phong * (ao_byte / 255) per channel (main.cpp:768-786).

    color: (H, W, 3) uint8; ao_intensity_u8: (H, W) uint8 — the composite
    reads the *quantized* AO image back like the reference does
    (main.cpp:774-775).

    Computed in INTEGER math ((c*a) // 255), which makes the numpy and
    device paths BITWISE-IDENTICAL (the previous formulation used f64
    on host but f32 on device — f64 is slow on the device — and the two could
    disagree by 1 LSB, falsifying postprocess_device's byte-identity
    claim).  Versus the reference's two-step f64 rounding
    (main.cpp:774: ao/255.0 then *c) the integer floor differs on
    exactly 12 of the 65536 byte pairs — products divisible by 255
    where the double rounding lands epsilon below the integer — by
    1 LSB, within the engine's documented <=1-LSB color contract
    (README correctness contract); every other pair is exact."""
    prod = color.astype(xp.int32) * ao_intensity_u8.astype(xp.int32)[..., None]
    return (prod // 255).astype(xp.uint8)
