"""tinyrenderder_tpu — a software rasterization engine on JAX for NVIDIA GPUs.

A from-scratch re-design of the capabilities of the reference CPU renderer
(AnnaUshnova/tinyrenderder: a tinyrenderer-style C++17 rasterizer) as an
JAX / XLA / Pallas framework:

  * meshes are SoA pytrees of arrays (``models.mesh.Mesh``)
  * vertex transforms are batched elementwise math over all vertices
  * the per-pixel ``rasterize()`` loop (reference ``our_gl.cpp:89-201``)
    becomes a two-phase depth-resolve + shade pipeline:
      - phase A: coverage + depth resolve with deterministic
        first-submission-wins tie-break (a Pallas/Triton tile kernel on
        the GPU, interpreted on the CPU for tests)
      - phase B: per-pixel shading of the winning triangle (vmapped
        pure shader functions, texture sampling as gathers)
  * multi-chip scaling is framebuffer tile-sharding over a
    ``jax.sharding.Mesh`` (``parallel.dist``), not threads.

Public API parity map (reference file -> module):
  geometry.h            -> math3d
  camera.h              -> camera
  tgaimage.{h,cpp}      -> utils.tga
  model.{h,cpp}         -> models.mesh, models.obj, models.textures
  model_manager.{h,cpp} -> models.manager
  our_gl.{h,cpp}        -> ops.raster (+ math3d transforms, scene stats)
  main.cpp shaders/SSAO -> shaders, ops.post
  main.cpp scene driver -> scene, cli
"""

__version__ = "0.1.0"

from tinyrenderder_tpu import math3d  # noqa: F401
from tinyrenderder_tpu.ops import device as _device

# bitwise oracle parity needs IEEE f32 division from XLA:GPU; the flag
# must be in place before JAX starts its CUDA backend
_device.require_exact_div()
