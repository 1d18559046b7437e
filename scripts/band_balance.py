"""Per-device binning-load balance of the sharded layouts: pair totals
per band for the even, interleaved, and MEASURED band layouts on the
bench triangle streams.

Pair totals are the per-device pre-stage size (shared capacities are
sized by the MAX band) and exactly what the dryrun prints per shard.
Everything here is XLA math on the clamped bboxes
(raster_tiled._tile_spans), so the analysis runs on any backend, the
CPU included.

Usage: JAX_PLATFORMS=cpu python scripts/band_balance.py [n_devices]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax


def _stream(name, width, height):
    import jax.numpy as jnp

    from bench import _lights, build_pass
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.models import procedural
    from tinyrenderder_tpu.shaders import PhongShader

    key, fill, rim = _lights()
    if name == "head":
        attrs, shader, uniforms = build_pass(width, height)
    else:
        mesh = (procedural.head_wall(grid=3) if name == "stress"
                else procedural.mixed_interior(grid=3))
        view = math3d.lookat((0, 0.3, 6.5), (0, 0, 0), (0, 1, 0))
        proj = math3d.perspective(60.0, width / height, 0.1, 50.0)
        shader = PhongShader(key, fill, rim, normal_map_strength=0.5)
        uniforms = shader.build_uniforms(view, proj, mesh.materials[0],
                                         np.float32)
        attrs = mesh.face_attributes(np.float32)
    attrs = {k: jnp.asarray(v) for k, v in attrs.items()}
    return [(attrs, shader, uniforms, False)]


def band_totals(costs, bands):
    return [int(sum(costs[lo:lo + rows])) for lo, rows in bands]


def interleave_totals(costs, n):
    return [int(sum(costs[b::n])) for b in range(n)]


def report(name, totals):
    mean = sum(totals) / max(len(totals), 1)
    ratio = max(totals) / mean if mean else float("nan")
    print(f"  {name:<12} {totals}  max/mean {ratio:.3f}")
    return ratio


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    from tinyrenderder_tpu.parallel import dist
    print(f"backend={jax.default_backend()} n_devices={n}")
    results = {}
    for name, w, h in (("head", 2048, 2048), ("stress", 1280, 800),
                       ("mixed", 1280, 800)):
        passes = _stream(name, w, h)
        costs = dist.measure_tile_row_costs(passes, w, h)
        nty = len(costs)
        legal = nty % n == 0
        even = tuple((b * (nty // n), nty // n) for b in range(n))
        measured = dist.balance_bands(costs, n)
        cap = max(r for _, r in measured)
        print(f"{name} {w}x{h}: {int(costs.sum())} pairs over {nty} "
              f"tile rows; measured bands {measured}")
        if not legal:
            # even/interleaved bands need nty % n == 0 — on this frame
            # they cannot run the fused sharded path at all; the
            # hypothetical numbers below drop the last nty % n rows
            print(f"  NOTE: {nty} rows % {n} devices != 0 — even/"
                  f"interleave are ILLEGAL here; unequal bands "
                  f"(even_unequal_bands / measured) are what makes the "
                  f"fused path run")
        r_even = report("even*" if not legal else "even",
                        band_totals(costs, even))
        r_int = report("interleave*" if not legal else "interleave",
                       interleave_totals(costs, n))
        r_meas = report("measured", band_totals(costs, measured))
        print(f"  measured band_cap {cap} vs even rows {nty // n} "
              f"(static shape overhead x{cap / max(nty // n, 1):.2f})")
        results[name] = (r_even, r_int, r_meas, legal)
    print("\nsummary (max/mean; 1.0 = perfect; * = layout illegal on "
          "that frame, shown for shape only):")
    for name, (e, i, m, legal) in results.items():
        star = "" if legal else "*"
        print(f"  {name:<8} even{star} {e:.3f}  interleave{star} "
              f"{i:.3f}  measured {m:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
