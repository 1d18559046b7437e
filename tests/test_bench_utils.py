"""Unit tests for the bench harness helpers (per-config dispersion
records) and the measured-band row map."""

import numpy as np


def test_timing_fields_samples_and_mad():
    import bench
    rec = bench._timing_fields(0.010, 1.0,
                               samples=[0.011, 0.010, 0.013])
    assert rec["samples_frame_ms"] == [10.0, 11.0, 13.0]
    assert rec["mad_frame_ms"] == 1.0          # median |s - 11| = 1
    assert rec["frame_ms"] == 10.0
    rec2 = bench._timing_fields(0.010, 1.0)
    assert "samples_frame_ms" not in rec2


def test_band_row_map_roundtrip():
    from tinyrenderder_tpu.parallel import dist
    tile_h = 4
    bands = ((0, 3), (3, 1), (4, 0), (4, 2))   # 6 tile rows, cap 3
    cap = max(r for _, r in bands)
    height = 6 * tile_h
    src = dist._band_row_map(bands, cap, tile_h, height)
    # build the padded concatenated array and check the gather
    # reconstructs global row order
    padded = np.full((len(bands) * cap * tile_h,), -1, np.int64)
    for b, (lo, rows) in enumerate(bands):
        for t in range(rows):
            g0 = (lo + t) * tile_h
            s0 = (b * cap + t) * tile_h
            padded[s0:s0 + tile_h] = np.arange(g0, g0 + tile_h)
    assert (padded[src] == np.arange(height)).all()
