"""Programmable shaders as pure, vectorized functions.

A data-parallel re-design of the reference ``IShader`` interface (our_gl.h:36-52)
and its two implementations PhongShader (main.cpp:39-171) and EyeShader
(main.cpp:176-262), plus the classic tinyrenderer-course shader set (flat,
Gouraud, textured, depth-only, shadow-mapped) required by the benchmark
configs.

Instead of virtual per-pixel calls, a shader here is a stateless object with
three pure methods operating on whole arrays (numpy or jax.numpy via ``xp``):

  build_uniforms(modelview, perspective, material, dtype)
      -> dict of host numpy arrays (the per-pass uniform pytree; computed in
         float64 like the reference's doubles, then cast to the working
         dtype so engine and oracle see identical uniform bits)
  vertex(u, attrs, xp)
      -> (clip (..., 3, 4), varyings {name: (..., 3, C)})
         vectorized over all faces at once — the reference's per-corner
         ``shader.vertex(face, vtx)`` loop (main.cpp:660-665) becomes one
         batched transform
  fragment(u, vary, xp)
      -> (..., 3) float RGB in the 0..255 domain, vectorized over pixels;
         the caller applies ``finalize_color`` (min(255, v) + truncating
         uint8 cast, main.cpp:161-167)

None of the shipped shaders discard fragments (main.cpp:169, :260), which
is what makes depth-resolve/shade separable; a shader that needs
discard sets ``coverage(u, vary, xp) -> bool mask`` and the engine folds it
into the depth phase.
"""

from __future__ import annotations

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.models.mesh import Material
from tinyrenderder_tpu.ops.semantics import apply_mat4

__all__ = [
    "Shader", "PhongShader", "EyeShader", "FlatShader", "GouraudShader",
    "TexturedShader", "DepthShader", "GrayDepthShader", "ShadowMappedShader",
    "sample_diffuse", "sample_normal_map", "sample_specular",
    "sample_emission", "finalize_color",
    "EYE_DIFFUSE_BRIGHTNESS_THRESHOLD", "EYE_SPECULAR_POWER_THRESHOLD",
]

# Eye-pixel heuristic thresholds (main.cpp:33-34)
EYE_DIFFUSE_BRIGHTNESS_THRESHOLD = 0.85
EYE_SPECULAR_POWER_THRESHOLD = 5.0


# ---------------------------------------------------------------------------
# Texture sampling (model.cpp:415-472): nearest neighbor, clamp-to-edge,
# truncating float->int index cast.
# ---------------------------------------------------------------------------

def _nearest_index(coord, size, xp):
    """x = clamp(int(u * size), 0, size - 1) with C truncation semantics
    (model.cpp:420-424)."""
    scaled = coord * float(size)
    idx = xp.trunc(scaled).astype(xp.int32)
    return xp.clip(idx, 0, size - 1)


def _gather_texel(tex, u, v, xp):
    """tex: (th, tw, c) uint8, rows top-first. Returns (..., c) uint8.

    Gathers by one flattened linear index (one index computation per
    texel instead of two).
    """
    th, tw = tex.shape[0], tex.shape[1]
    xi = _nearest_index(u, tw, xp)
    yi = _nearest_index(v, th, xp)
    return tex.reshape(th * tw, -1)[yi * tw + xi]


def _texel_rgb(texel, xp, dtype):
    """Texel bytes -> RGB floats with the reference's zero-filled TGAColor
    semantics: a c<3-channel texel leaves the missing BGRA bytes at 0, and
    shaders read (c[2], c[1], c[0]) as RGB (main.cpp:106) — so a grayscale
    texture contributes only to the blue channel, exactly like the C++."""
    if texel.shape[-1] >= 3:
        return texel[..., :3].astype(dtype)
    gray = texel[..., 0].astype(dtype)
    zero = xp.zeros_like(gray)
    return xp.stack([zero, zero, gray], axis=-1)


def sample_diffuse(tex, u, v, xp):
    """RGB in 0..255 as working-dtype floats; white fallback
    (model.cpp:415-426)."""
    if tex is None:
        shape = xp.shape(u) + (3,)
        return xp.full(shape, 255.0, dtype=u.dtype)
    return _texel_rgb(_gather_texel(tex, u, v, xp), xp, u.dtype)


def sample_normal_map(tex, u, v, xp):
    """Object-space normal decode (model.cpp:428-445): channel c/255*2-1
    per axis, normalized; (0, 0, 1) fallback."""
    if tex is None:
        shape = xp.shape(u)
        return xp.concatenate([
            xp.zeros(shape + (2,), dtype=u.dtype),
            xp.ones(shape + (1,), dtype=u.dtype),
        ], axis=-1)
    texel = _texel_rgb(_gather_texel(tex, u, v, xp), xp, u.dtype)
    n = texel / 255.0 * 2.0 - 1.0
    return normalized3(n, xp)


def sample_specular(tex, u, v, xp):
    """Scalar in [0, 1] computed in float32 like the C++ ``c[0]/255.0f``
    (model.cpp:447-459).  The reference reads BGRA byte 0 (= blue); our
    textures are RGB[A], so that is channel 2 for color maps and channel 0
    for grayscale.  1.0 fallback when no map."""
    if tex is None:
        return xp.ones(xp.shape(u), dtype=u.dtype)
    channel = 0 if tex.shape[-1] == 1 else 2
    texel = _gather_texel(tex, u, v, xp)[..., channel]
    return (texel.astype(xp.float32) / xp.float32(255.0)).astype(u.dtype)


def sample_emission(tex, u, v, xp):
    """RGB in 0..255; black fallback (model.cpp:461-472).  Grayscale
    maps follow the zero-filled TGAColor rule like every other sampler
    (_texel_rgb): gray lands in the blue channel, R=G=0."""
    if tex is None:
        return xp.zeros(xp.shape(u) + (3,), dtype=u.dtype)
    return _texel_rgb(_gather_texel(tex, u, v, xp), xp, u.dtype)


def pack_material_textures(material: "Material | None") -> np.ndarray | None:
    """Pack diffuse RGB + normal RGB + the specular byte into one
    (h, w, 7) uint8 texture when all three maps share a shape.

    A gather's cost is mostly per index, not per byte of the row, so
    one 7-channel gather replaces three map gathers.  The packed bytes are exactly what the individual samplers read
    (model.cpp:415-459), so decode results are bit-identical.
    """
    m = material
    if m is None or m.diffuse is None or m.normal is None or m.specular is None:
        return None
    d, n, s = m.diffuse, m.normal, m.specular
    if not (d.shape[:2] == n.shape[:2] == s.shape[:2]):
        return None
    if d.shape[-1] < 3 or n.shape[-1] < 3:
        return None     # grayscale maps take the zero-fill fallback path
    spec_channel = 0 if s.shape[-1] == 1 else 2   # sample_specular's choice
    return np.concatenate([
        d[..., :3], n[..., :3], s[..., spec_channel:spec_channel + 1],
    ], axis=-1).astype(np.uint8)


def sample_packed(packed, u, v, xp):
    """One gather -> (diffuse RGB, raw normal-map vector, specular scalar)
    with byte-identical decode to the individual samplers."""
    texel = _gather_texel(packed, u, v, xp)
    base = texel[..., 0:3].astype(u.dtype)
    nm = normalized3(texel[..., 3:6].astype(u.dtype) / 255.0 * 2.0 - 1.0, xp)
    spec = (texel[..., 6].astype(xp.float32) / xp.float32(255.0)).astype(u.dtype)
    return base, nm, spec


# ---------------------------------------------------------------------------
# Small vector helpers with fixed op order (shared exactness with oracle)
# ---------------------------------------------------------------------------

def dot3(a, b):
    """(ax*bx + ay*by) + az*bz — the left-to-right dot of geometry.h:122-127."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def normalized3(v, xp):
    """normalize with zero-length passthrough (geometry.h:136-140)."""
    length = xp.sqrt(dot3(v, v))
    safe = xp.where(length == 0, xp.ones_like(length), length)
    return xp.where((length == 0)[..., None], v, v / safe[..., None])


def _pad(v, w, xp):
    return xp.concatenate([v, xp.full(v.shape[:-1] + (1,), w, dtype=v.dtype)], axis=-1)


def transform_dir(m, v, xp):
    """ModelView * (v, 0) like the shaders transform normals
    (main.cpp:83-87); returns xyz."""
    return apply_mat4(m, _pad(v, 0.0, xp), xp)[..., :3]


def finalize_color(rgb, xp):
    """Per-channel min(255, v) + truncating unsigned-char cast
    (main.cpp:161-167)."""
    return xp.trunc(xp.minimum(rgb, 255.0)).astype(xp.uint8)


def _light_dirs_eye(modelview64: np.ndarray, world_dirs: list[np.ndarray]) -> list[np.ndarray]:
    """initLightDirections (main.cpp:55-69): rotate world light directions
    by the upper 3x3 of the *current* ModelView (which includes the model
    matrix — reference quirk: lights turn with the model), then normalize.
    Computed in float64 host math like the reference."""
    nm = modelview64[:3, :3]
    return [math3d.normalized(nm @ np.asarray(d, dtype=np.float64)) for d in world_dirs]


def _material_textures(material: Material | None) -> dict:
    m = material or Material()
    # cache the packed texture on the material, keyed by the identity of
    # the four source arrays (the key tuple keeps them alive, so id
    # recycling can't alias): build_uniforms runs per frame, and
    # rebinding e.g. m.diffuse must rebuild the pack.  In-place writes
    # INTO a texture array are out of contract (texture data is
    # immutable once bound; rebind to update).
    src = (m.diffuse, m.normal, m.specular, m.emission)
    cached = m.__dict__.get("_packed")
    if (cached is None
            or any(a is not b for a, b in zip(cached[0], src))):
        cached = (src, pack_material_textures(m))
        m.__dict__["_packed"] = cached
    return {
        "tex_diffuse": m.diffuse,
        "tex_normal": m.normal,
        "tex_specular": m.specular,
        "tex_emission": m.emission,
        "tex_packed": cached[1],
    }


def tokens_match(a, b) -> bool:
    """Compare two ``Shader.uniforms_token`` snapshots.  Reference
    entries compare with ``is`` (never stale: a swapped-in equal object
    just misses); value entries compare with ``==``."""
    if a is b:
        return True
    if len(a) != len(b):
        return False
    for ea, eb in zip(a, b):
        if ea[0] != eb[0] or ea[1] != eb[1]:
            return False
        if ea[1] == "ref":
            if ea[2] is not eb[2]:
                return False
        elif ea[2:] != eb[2:]:
            return False
    return True


class Shader:
    """Base shader: standard vertex stage shared by Phong/Eye
    (main.cpp:71-90 == main.cpp:199-218).

    Shaders are static arguments to the engine's jitted pipelines, so
    equality/hash are *content-based*: two instances whose traced code is
    identical (same class, same trace-time constants) share compiled
    programs.  Everything else (lights, matrices, textures, shadow maps)
    flows through ``build_uniforms`` as runtime data.  Subclasses whose
    trace depends on constructor state override ``_static_key``.
    """

    name = "base"
    #: varying channel counts, static per shader (engine buffer layout)
    varying_spec: dict[str, int] = {"uv": 2, "position_eye": 3, "normal_eye": 3}
    #: False for depth-only passes: the engine skips varying
    #: interpolation and fragment shading entirely (z-test precedes
    #: shading, our_gl.cpp:165, so depth output is unaffected)
    writes_color: bool = True

    def _static_key(self) -> tuple:
        return (type(self),)

    def uniforms_token(self) -> tuple:
        """Snapshot of the instance state ``build_uniforms`` reads, for
        the scene driver's per-pass uniform cache (build_uniforms is a
        few tenths of a host millisecond per pass per frame — real money
        on sub-15 ms frames).  Ndarrays below the device-upload-cache
        threshold (4096 elements) snapshot by VALUE (shape + dtype +
        bytes), so even in-place writes are seen — exactly the arrays the
        pre-cache code re-read every frame.  Arrays at/above it (shadow
        maps, textures) snapshot by object reference — the cache compares
        references with ``is`` and keeps them alive, so id-recycling
        cannot alias; in-place writes INTO such an array are out of
        contract (they were already invisible to the identity-keyed
        device-upload cache): rebind the attribute to update.  Compare
        tokens with :func:`tokens_match`, not ``==`` (ndarray refs don't
        __eq__)."""
        out = []
        for k in sorted(self.__dict__):
            if k.startswith("_"):
                continue           # private caches don't feed uniforms
            v = self.__dict__[k]
            if isinstance(v, np.ndarray) and v.size < 4096:
                v = (k, "nd", v.shape, v.dtype.str, v.tobytes())
            else:
                v = (k, "ref", v)  # big arrays / objects: by reference
            out.append(v)
        return tuple(out)

    def __hash__(self) -> int:
        return hash(self._static_key())

    def __eq__(self, other) -> bool:
        return (isinstance(other, Shader)
                and self._static_key() == other._static_key())

    def build_uniforms(self, modelview: np.ndarray, perspective: np.ndarray,
                       material: Material | None, dtype) -> dict:
        u = {
            "modelview": np.asarray(modelview, dtype=np.float64).astype(dtype),
            "perspective": np.asarray(perspective, dtype=np.float64).astype(dtype),
        }
        u.update(_material_textures(material))
        return u

    def vertex(self, u, attrs, xp):
        mv = u["modelview"]
        pos4 = _pad(attrs["position"], 1.0, xp)
        pos_eye4 = apply_mat4(mv, pos4, xp)
        normal_eye = transform_dir(mv, attrs["normal"], xp)
        clip = apply_mat4(u["perspective"], pos_eye4, xp)
        varyings = {
            "uv": attrs["uv"],
            "position_eye": pos_eye4[..., :3],
            "normal_eye": normal_eye,
        }
        return clip, varyings

    def fragment(self, u, vary, xp):
        raise NotImplementedError


class PhongShader(Shader):
    """Per-pixel 3-light Phong with object-space normal mapping
    (main.cpp:39-171), including the eye-pixel heuristic that disables the
    normal map on bright low-specular texels (main.cpp:109-112) and the
    ``max(1.0, specular(uv))`` exponent quirk (main.cpp:107)."""

    name = "phong"

    KEY_DIFFUSE_INTENSITY = 1.0
    KEY_SPECULAR_INTENSITY = 1.0
    FILL_DIFFUSE_INTENSITY = 0.35
    RIM_DIFFUSE_INTENSITY = 0.6
    AMBIENT = 0.10
    SPECULAR_SCALE = 0.35

    def __init__(self, key_light_world, fill_light_world, rim_light_world,
                 normal_map_strength: float = 1.0):
        self.key_light_world = np.asarray(key_light_world, dtype=np.float64)
        self.fill_light_world = np.asarray(fill_light_world, dtype=np.float64)
        self.rim_light_world = np.asarray(rim_light_world, dtype=np.float64)
        self.normal_map_strength = float(normal_map_strength)

    def _static_key(self) -> tuple:
        # the blend weight is baked into the traced fragment program
        return (type(self), self.normal_map_strength)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        key, fill, rim = _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64),
            [self.key_light_world, self.fill_light_world, self.rim_light_world])
        u["key_light_eye"] = key.astype(dtype)
        u["fill_light_eye"] = fill.astype(dtype)
        u["rim_light_eye"] = rim.astype(dtype)
        return u

    def fragment(self, u, vary, xp):
        return self._phong_fragment(u, vary, xp)[0]

    def _phong_fragment(self, u, vary, xp):
        """Returns (rgb, base diffuse sample) so subclasses (shadows) can
        reuse the texture fetch instead of re-gathering."""
        pos_eye = vary["position_eye"]
        geom_normal = vary["normal_eye"]
        uv = vary["uv"]
        uu, vv = uv[..., 0], uv[..., 1]

        if u["tex_packed"] is not None:
            base, nm, spec_val = sample_packed(u["tex_packed"], uu, vv, xp)
        else:
            base = sample_diffuse(u["tex_diffuse"], uu, vv, xp)  # (..., 3)
            spec_val = sample_specular(u["tex_specular"], uu, vv, xp)
            nm = sample_normal_map(u["tex_normal"], uu, vv, xp)
        specular_power = xp.maximum(xp.asarray(1.0, dtype=spec_val.dtype), spec_val)

        # eye-pixel detection (main.cpp:109-112); channel sum is symmetric,
        # so RGB vs the reference's BGR order is immaterial
        brightness = ((base[..., 0] + base[..., 1]) + base[..., 2]) / (3.0 * 255.0)
        is_eye = ((brightness >= EYE_DIFFUSE_BRIGHTNESS_THRESHOLD)
                  & (specular_power <= EYE_SPECULAR_POWER_THRESHOLD))

        nm_eye = transform_dir(u["modelview"], nm, xp)

        s = self.normal_map_strength
        blended = geom_normal * (1.0 - s) + nm_eye * s
        final_normal = xp.where(is_eye[..., None], geom_normal,
                                normalized3(blended, xp))

        view_dir = normalized3(-pos_eye, xp)

        key = u["key_light_eye"]
        key_diffuse = xp.maximum(0.0, dot3(final_normal, key)) * self.KEY_DIFFUSE_INTENSITY

        reflect_dir = normalized3(
            final_normal * (2.0 * dot3(final_normal, key))[..., None] - key, xp)
        reflect_view = xp.maximum(0.0, dot3(reflect_dir, view_dir))
        # exponent quirk (main.cpp:107): specPower = max(1.0, specular(uv))
        # with specular(uv) in [0, 1] (model.cpp:447-459) is ALWAYS 1.0,
        # and pow(x, 1.0) == x exactly in IEEE — so the C++ reference's
        # specular term is just reflect_view.  Computing x directly is
        # both faster (no transcendental) and closer to the reference
        # than exp(p*log(x)).
        del specular_power
        key_specular = xp.where(
            reflect_view > 0.0,
            reflect_view,
            xp.zeros_like(reflect_view)) * self.KEY_SPECULAR_INTENSITY

        fill_diffuse = (xp.maximum(0.0, dot3(final_normal, u["fill_light_eye"]))
                        * self.FILL_DIFFUSE_INTENSITY)
        rim_diffuse = (xp.maximum(0.0, dot3(final_normal, u["rim_light_eye"]))
                       * self.RIM_DIFFUSE_INTENSITY)

        total_diffuse = key_diffuse + fill_diffuse + rim_diffuse
        rgb = (base * (self.AMBIENT + total_diffuse)[..., None]
               + 255.0 * (self.SPECULAR_SCALE * key_specular)[..., None])
        return rgb, base


class EyeShader(Shader):
    """Glossy eye material (main.cpp:176-262): normalized interpolated
    normal, key+rim diffuse, specular exponent x8, spec scale 1.5, no
    normal map."""

    name = "eye"

    KEY_DIFFUSE_INTENSITY = 1.0
    RIM_DIFFUSE_INTENSITY = 0.6
    AMBIENT = 0.1
    SPECULAR_SCALE = 1.5

    def __init__(self, key_light_world, rim_light_world):
        self.key_light_world = np.asarray(key_light_world, dtype=np.float64)
        self.rim_light_world = np.asarray(rim_light_world, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        key, rim = _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64),
            [self.key_light_world, self.rim_light_world])
        u["key_light_eye"] = key.astype(dtype)
        u["rim_light_eye"] = rim.astype(dtype)
        return u

    def fragment(self, u, vary, xp):
        pos_eye = vary["position_eye"]
        normal = normalized3(vary["normal_eye"], xp)      # main.cpp:225-227
        uv = vary["uv"]
        uu, vv = uv[..., 0], uv[..., 1]

        if u["tex_packed"] is not None:
            base, _, spec_val = sample_packed(u["tex_packed"], uu, vv, xp)
        else:
            base = sample_diffuse(u["tex_diffuse"], uu, vv, xp)
            spec_val = sample_specular(u["tex_specular"], uu, vv, xp)
        view_dir = normalized3(-pos_eye, xp)
        key = u["key_light_eye"]

        key_diffuse = xp.maximum(0.0, dot3(normal, key)) * self.KEY_DIFFUSE_INTENSITY
        rim_diffuse = (xp.maximum(0.0, dot3(normal, u["rim_light_eye"]))
                       * self.RIM_DIFFUSE_INTENSITY)
        total_diffuse = key_diffuse + rim_diffuse
        # exponent quirk (main.cpp:235): specPower = max(1.0, specular(uv))
        # * 8.0 with specular(uv) in [0, 1] (model.cpp:447-459) is ALWAYS
        # 8.0 — integer power, computed by three exact squarings instead
        # of the transcendental pow (shared verbatim with the oracle, so
        # cross-path parity is structural)
        del spec_val
        reflect_dir = normalized3(
            normal * (2.0 * dot3(normal, key))[..., None] - key, xp)
        reflect_view = xp.maximum(0.0, dot3(reflect_dir, view_dir))
        x2 = reflect_view * reflect_view
        x4 = x2 * x2
        specular = x4 * x4          # reflect_view ** 8; 0 stays 0 exactly

        return (base * (self.AMBIENT + total_diffuse)[..., None]
                + 255.0 * (self.SPECULAR_SCALE * specular)[..., None])


class FlatShader(Shader):
    """Faceted Lambert shading: one eye-space face normal per triangle,
    single directional light.  (tinyrenderer-course config.)"""

    name = "flat"
    varying_spec = {"face_normal_eye": 3}

    def __init__(self, light_world=(0.0, 0.0, 1.0), base_color=(255.0, 255.0, 255.0)):
        self.light_world = np.asarray(light_world, dtype=np.float64)
        self.base_color = np.asarray(base_color, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        (u["light_eye"],) = [d.astype(dtype) for d in _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64), [self.light_world])]
        u["base_color"] = self.base_color.astype(dtype)
        return u

    def vertex(self, u, attrs, xp):
        clip, _ = super().vertex(u, attrs, xp)
        pos = attrs["position"]                       # (..., 3, 3)
        e1 = pos[..., 1, :] - pos[..., 0, :]
        e2 = pos[..., 2, :] - pos[..., 0, :]
        n = xp.stack([
            e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
            e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
            e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0],
        ], axis=-1)
        n_eye = normalized3(transform_dir(u["modelview"], n, xp), xp)
        face_normal = xp.broadcast_to(n_eye[..., None, :], pos.shape)
        return clip, {"face_normal_eye": face_normal}

    def fragment(self, u, vary, xp):
        intensity = xp.maximum(0.0, dot3(
            normalized3(vary["face_normal_eye"], xp), u["light_eye"]))
        return u["base_color"] * intensity[..., None]


class GouraudShader(Shader):
    """Per-vertex Lambert intensity, interpolated across the triangle —
    the classic tinyrenderer Gouraud config (benchmark config #1)."""

    name = "gouraud"
    varying_spec = {"intensity": 1}

    def __init__(self, light_world=(0.0, 0.0, 1.0), base_color=(255.0, 255.0, 255.0)):
        self.light_world = np.asarray(light_world, dtype=np.float64)
        self.base_color = np.asarray(base_color, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        (u["light_eye"],) = [d.astype(dtype) for d in _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64), [self.light_world])]
        u["base_color"] = self.base_color.astype(dtype)
        return u

    def vertex(self, u, attrs, xp):
        clip, vary = super().vertex(u, attrs, xp)
        n = normalized3(vary["normal_eye"], xp)
        intensity = xp.maximum(0.0, dot3(n, u["light_eye"]))
        return clip, {"intensity": intensity[..., None]}

    def fragment(self, u, vary, xp):
        return u["base_color"] * vary["intensity"]


class TexturedShader(GouraudShader):
    """Diffuse texture modulated by Gouraud intensity (benchmark config #2:
    UV gather sampling)."""

    name = "textured"
    varying_spec = {"intensity": 1, "uv": 2}

    def vertex(self, u, attrs, xp):
        clip, vary = super().vertex(u, attrs, xp)
        vary["uv"] = attrs["uv"]
        return clip, vary

    def fragment(self, u, vary, xp):
        uv = vary["uv"]
        base = sample_diffuse(u["tex_diffuse"], uv[..., 0], uv[..., 1], xp)
        return base * vary["intensity"]


class DepthShader(Shader):
    """Depth-only pass for shadow mapping (benchmark config #4, pass 1).
    The fragment stage is never consulted for depth (the z-test precedes
    shading, our_gl.cpp:165) and the engine skips shading entirely
    (writes_color=False); use GrayDepthShader for a shaded grayscale
    visualization pass."""

    name = "depth"
    varying_spec = {"ndc_z": 1}
    writes_color = False

    def vertex(self, u, attrs, xp):
        clip, _ = super().vertex(u, attrs, xp)
        w = clip[..., 3]
        safe_w = xp.where(w == 0, xp.ones_like(w), w)
        z = clip[..., 2] / safe_w
        return clip, {"ndc_z": z[..., None]}

    def fragment(self, u, vary, xp):
        v = (vary["ndc_z"][..., 0] * 0.5 + 0.5) * 255.0
        return xp.stack([v, v, v], axis=-1)


class GrayDepthShader(DepthShader):
    """DepthShader variant that does shade: NDC depth as grayscale
    (save_zbuffer_image-style visualization as a color pass)."""

    name = "gray_depth"
    writes_color = True


class ShadowMappedShader(PhongShader):
    """Two-pass hard shadows (benchmark config #4, pass 2): Phong lighting
    where the key light's diffuse+specular contribution is gated by a
    shadow-map depth comparison (tinyrenderer-style 0.3/1.0 hard factor).

    Uniform ``shadow_matrix`` maps this pass's *model-space* positions into
    the light pass's screen space (viewport_l @ persp_l @ view_l);
    ``shadow_map`` is the light-pass depth buffer (H_l, W_l) float.
    """

    name = "shadow_phong"
    varying_spec = {"uv": 2, "position_eye": 3, "normal_eye": 3, "position_model": 3}

    SHADOW_AMBIENT_FACTOR = 0.3
    SHADOW_EPS = 2e-3

    def __init__(self, key_light_world, fill_light_world, rim_light_world,
                 shadow_matrix: np.ndarray, shadow_map: np.ndarray,
                 normal_map_strength: float = 1.0):
        super().__init__(key_light_world, fill_light_world, rim_light_world,
                         normal_map_strength)
        self.shadow_matrix = np.asarray(shadow_matrix, dtype=np.float64)
        self.shadow_map = shadow_map

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        u["shadow_matrix"] = self.shadow_matrix.astype(dtype)
        sm = self.shadow_map
        if isinstance(sm, np.ndarray):      # device arrays stay on device
            sm = np.asarray(sm, dtype=dtype)
        u["shadow_map"] = sm
        return u

    def vertex(self, u, attrs, xp):
        clip, vary = super().vertex(u, attrs, xp)
        vary["position_model"] = attrs["position"]
        return clip, vary

    def shadow_factor(self, u, vary, xp):
        sm = u["shadow_map"]
        p4 = apply_mat4(u["shadow_matrix"],
                        _pad(vary["position_model"], 1.0, xp), xp)
        w = p4[..., 3]
        safe_w = xp.where(w == 0, xp.ones_like(w), w)
        sx = p4[..., 0] / safe_w
        sy = p4[..., 1] / safe_w
        sz = p4[..., 2] / safe_w
        h, wdt = sm.shape
        xi = xp.clip(xp.trunc(sx).astype(xp.int32), 0, wdt - 1)
        yi = xp.clip(xp.trunc(sy).astype(xp.int32), 0, h - 1)
        inside = (sx >= 0) & (sx < wdt) & (sy >= 0) & (sy < h) & (w > 0)
        closest = sm.reshape(h * wdt)[yi * wdt + xi]
        lit = (~inside) | (closest > sz - self.SHADOW_EPS)
        return xp.where(lit, xp.asarray(1.0, dtype=sx.dtype),
                        xp.asarray(self.SHADOW_AMBIENT_FACTOR, dtype=sx.dtype))

    def fragment(self, u, vary, xp):
        rgb, base = self._phong_fragment(u, vary, xp)
        # gate everything but the ambient term by the shadow factor,
        # reusing the Phong stage's diffuse sample (no second gather)
        amb = base * self.AMBIENT
        factor = self.shadow_factor(u, vary, xp)
        return amb + (rgb - amb) * factor[..., None]
