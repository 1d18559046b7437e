"""Orbit-camera animation with frame-level checkpoint/resume.

The animation benchmark: multi-mesh scene with an orbiting
camera, 120 frames at 2048^2.  The camera orbit rotates the eye around
the target about +Y (the reference's model-matrix rotY builder,
main.cpp:408-420, applied to the camera instead of the model so that jit
caches stay warm: geometry and shapes are identical across frames, only
uniforms change).

Checkpoint/resume (SURVEY.md §5): render state is pure value state, so a
killed job resumes at frame k from a JSON checkpoint — the reference's
closest analogue is its copyable z-buffer snapshot (main.cpp:700,730).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass

import numpy as np

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.scene import Scene
from tinyrenderder_tpu.utils import tga

log = logging.getLogger("tinyrenderder_tpu.animation")

__all__ = ["AnimationConfig", "orbit_eye", "render_animation"]

CHECKPOINT_NAME = "checkpoint.json"


@dataclass
class AnimationConfig:
    frames: int = 120
    orbit_degrees: float = 360.0
    backend: str = "tiled"
    outdir: str = "frames"
    frame_pattern: str = "frame_%04d.tga"
    frustum_cull: bool = True
    checkpoint: bool = True
    #: capacity mode for the per-frame renders.  False (default) runs
    #: the async capacity path — no per-frame host sync — and REPAIRS
    #: any frame whose same-frame overflow flag fired by re-rendering
    #: it in strict mode before its TGA is written (every written frame
    #: must have every covered pixel shaded, our_gl.cpp:187-192).  True
    #: renders every frame strict.
    strict_capacity: bool = False


def orbit_eye(eye, target, angle_rad: float) -> np.ndarray:
    """Rotate the eye position around the target about +Y."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    rel = eye - target
    rot = math3d.rotation_y(angle_rad)
    return target + (rot[:3, :3] @ rel)


def _checkpoint_path(cfg: AnimationConfig) -> str:
    return os.path.join(cfg.outdir, CHECKPOINT_NAME)


def _load_checkpoint(cfg: AnimationConfig) -> int:
    path = _checkpoint_path(cfg)
    if not (cfg.checkpoint and os.path.exists(path)):
        return 0
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("frames") == cfg.frames and data.get("orbit_degrees") == cfg.orbit_degrees:
            return int(data.get("next_frame", 0))
        log.warning("checkpoint config mismatch — restarting from frame 0")
    except (OSError, ValueError) as e:
        log.warning("unreadable checkpoint (%s) — restarting", e)
    return 0


def _save_checkpoint(cfg: AnimationConfig, next_frame: int) -> None:
    if not cfg.checkpoint:
        return
    # atomic write: a kill mid-dump (the exact event checkpointing
    # exists to survive) must not truncate the previous checkpoint
    path = _checkpoint_path(cfg)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"next_frame": next_frame, "frames": cfg.frames,
                   "orbit_degrees": cfg.orbit_degrees}, f)
    os.replace(tmp, path)


def render_animation(scene: Scene, cfg: AnimationConfig,
                     stop_after: int | None = None) -> dict:
    """Render the orbit sequence, resuming from the checkpoint if present.

    ``stop_after`` caps the number of frames rendered *this run* (time-
    sliced jobs); the checkpoint lets the next run continue the schedule.
    Returns timing summary {frames_rendered, resumed_at, seconds, fps}.
    """
    os.makedirs(cfg.outdir, exist_ok=True)
    start_frame = _load_checkpoint(cfg)
    if start_frame >= cfg.frames:
        log.info("animation already complete (%d frames)", cfg.frames)
        return {"frames_rendered": 0, "resumed_at": start_frame,
                "seconds": 0.0, "fps": 0.0}
    if start_frame:
        log.info("resuming at frame %d/%d", start_frame, cfg.frames)

    base_eye = np.array(scene.camera.params.eye, dtype=np.float64)
    base_target = np.array(scene.camera.params.target, dtype=np.float64)

    end_frame = cfg.frames
    if stop_after is not None:
        end_frame = min(end_frame, start_frame + stop_after)

    t0 = time.perf_counter()
    rendered = 0
    repaired = 0
    # one-frame write pipeline: frame i renders (and starts its D2H)
    # while frame i-1's bytes are encoded + written on the host.  TGA
    # files and checkpoints still land strictly in frame order; a kill
    # mid-loop leaves the unwritten frame to the resume path.
    pending: "tuple[int, object, object] | None" = None

    def _set_frame_eye(idx: int) -> None:
        angle = math.radians(cfg.orbit_degrees) * idx / cfg.frames
        scene.camera.set_eye(orbit_eye(base_eye, base_target, angle))

    def _write(idx, color, overflowed) -> None:
        nonlocal repaired
        # exactness gate: a capacity overflow means
        # this frame's tiles dropped work — never write it.  Re-render
        # the frame strict (host-syncs + retries until every cap fits;
        # by now the async resolve has usually grown the caps already,
        # so the retry is typically a single dispatch) and write that.
        # The flag's D2H was started with the color plane's, so reading
        # it here does not add a device round trip.
        if overflowed is not None and bool(np.asarray(overflowed)):
            log.warning("frame %d overflowed a capacity (async mode); "
                        "re-rendering strict before writing", idx)
            _set_frame_eye(idx)
            color = scene.render(backend=cfg.backend,
                                 frustum_cull=cfg.frustum_cull,
                                 collect_stats=False, transfer=False,
                                 strict_capacity=True).color
            repaired += 1
        path = os.path.join(cfg.outdir, cfg.frame_pattern % idx)
        tga.TGAImage.from_rgb(np.asarray(color)).write_tga_file(path)
        _save_checkpoint(cfg, idx + 1)

    try:
        for i in range(start_frame, end_frame):
            _set_frame_eye(i)
            # device-resident render: only the color plane crosses to the
            # host.  transfer=True would also pull two full f32 depth
            # planes — ~3.6x the bytes the TGA write needs.
            result = scene.render(backend=cfg.backend,
                                  frustum_cull=cfg.frustum_cull,
                                  collect_stats=False, transfer=False,
                                  strict_capacity=cfg.strict_capacity)
            color = result.color
            if hasattr(color, "copy_to_host_async"):
                color.copy_to_host_async()
            ovf = result.overflowed
            if ovf is not None and hasattr(ovf, "copy_to_host_async"):
                ovf.copy_to_host_async()
            if pending is not None:
                _write(*pending)
                rendered += 1
            pending = (i, color, ovf)
            if i % 10 == 0:
                # divide by DISPATCHED frames: the write pipeline keeps
                # `rendered` one behind, which overstated s/frame
                log.info("frame %d/%d (%.2f s/frame)", i, cfg.frames,
                         (time.perf_counter() - t0)
                         / max(i - start_frame + 1, 1))
        if pending is not None:
            _write(*pending)
            pending = None
            rendered += 1
    finally:
        # restore the scene camera even on a mid-loop exception: a same-
        # process retry must not orbit around a mid-orbit base eye
        scene.camera.set_eye(base_eye)
    dt = time.perf_counter() - t0
    return {"frames_rendered": rendered, "resumed_at": start_frame,
            "seconds": dt, "fps": rendered / dt if dt > 0 else 0.0,
            "overflows_repaired": repaired}
