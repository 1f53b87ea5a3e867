"""Per-frame state threading for the localization hot path.

Functions of fixed-shape tensors; ``core.localizer.Localizer`` drives
them. Two granularities:

  ``localize_step``   one frame: the ``vio`` stages in order
  ``localize_chunk``  K frames: a Python loop of ``frame_transition``
                      over the chunk; padding frames (``active`` False)
                      pass the state through, so every chunk has K
                      frames

``repro`` compiles every registered scenario into one program; this
package runs ``vio`` only, so the mode dispatch is a host-side check.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.eudoxus import EudoxusConfig
from repro_torch.core import primitives as prim
from repro_torch.core import tracks
from repro_torch.core.backend import msckf
from repro_torch.core.environment import MODE_VIO
from repro_torch.core.frontend import pipeline
from repro_torch.core.frontend.pipeline import FrontendResult


class LocalizerState(NamedTuple):
    """Per-robot state on the device. ``repro``'s ``ba`` field (the SLAM
    keyframe window) arrives with the SLAM slice."""
    filt: msckf.MsckfState
    tracks_uv: torch.Tensor     # (N, W, 2) uv observations across the window
    tracks_valid: torch.Tensor  # (N, W) bool
    prev_img: torch.Tensor      # (H, W) previous left image (LK source)
    prev_yx: torch.Tensor       # (N, 2) int32 previous frame's features
    prev_valid: torch.Tensor    # (N,) bool
    frame_idx: torch.Tensor     # () int32


class FrameInputs(NamedTuple):
    """One frame's inputs; for a K-frame chunk every tensor gains a
    leading (K,) axis. ``mode`` and ``active`` are host arrays: the mode
    is checked host-side, and padding frames are skipped host-side."""
    img_l: torch.Tensor   # (H, W) float32
    img_r: torch.Tensor   # (H, W) float32
    accel: torch.Tensor   # (ipf, 3) float32 IMU accel ending at this frame
    gyro: torch.Tensor    # (ipf, 3) float32
    gps: torch.Tensor     # (3,) float32, NaN when unavailable
    mode: np.ndarray      # () int32 scenario mode id
    active: np.ndarray    # () bool; False = padding frame


class FrameOutputs(NamedTuple):
    """Per-frame outputs: the frontend result and the post-frame pose."""
    fr: FrontendResult
    p: torch.Tensor     # (3,) post-frame position
    q: torch.Tensor     # (4,) post-frame orientation quaternion


def localize_step(state: LocalizerState, img_l, img_r, accel, gyro, gps,
                  mode: int, dt_imu: torch.Tensor, *, cfg, fx: float,
                  fy: float, cx: float, cy: float
                  ) -> Tuple[LocalizerState, FrameOutputs]:
    """One frame of the ``vio`` scenario: spine, then GPS fusion."""
    if int(mode) != MODE_VIO:
        raise ValueError(f"mode id {int(mode)} is not ported to repro_torch "
                         f"(only vio, id {MODE_VIO})")
    ctx = prim.FrameCtx(cfg=cfg, fx=fx, fy=fy, cx=cx, cy=cy, dt_imu=dt_imu)
    c = prim.FrameCarry(
        img_l=img_l, img_r=img_r, accel=accel, gyro=gyro, gps=gps,
        filt=state.filt, tracks_uv=state.tracks_uv,
        tracks_valid=state.tracks_valid, prev_img=state.prev_img,
        prev_yx=state.prev_yx, prev_valid=state.prev_valid,
        frame_idx=state.frame_idx)
    for stage in prim.VIO:
        c = stage(ctx, c)
    new_state = LocalizerState(
        filt=c.filt, tracks_uv=c.tracks_uv, tracks_valid=c.tracks_valid,
        prev_img=c.prev_img, prev_yx=c.prev_yx, prev_valid=c.prev_valid,
        frame_idx=c.frame_idx + 1)
    return new_state, FrameOutputs(fr=c.fr, p=c.filt.p, q=c.filt.q)


def frame_transition(state: LocalizerState, inp: FrameInputs,
                     dt_imu: torch.Tensor, **bound
                     ) -> Tuple[LocalizerState, FrameOutputs]:
    """One frame of the chunk, or a pass-through for a padding frame
    (which outputs the unchanged pose and no frontend result)."""
    if not bool(inp.active):
        return state, FrameOutputs(fr=None, p=state.filt.p, q=state.filt.q)
    return localize_step(state, inp.img_l, inp.img_r, inp.accel, inp.gyro,
                         inp.gps, inp.mode, dt_imu, **bound)


def localize_chunk(state: LocalizerState, inputs: FrameInputs,
                   dt_imu: torch.Tensor, **bound
                   ) -> Tuple[LocalizerState, List[FrameOutputs]]:
    """K frames: ``frame_transition`` over the chunk's leading axis.
    Returns the post-chunk state and the K per-frame outputs."""
    outs = []
    for k in range(len(inputs.active)):
        state, out = frame_transition(
            state, FrameInputs(*(leaf[k] for leaf in inputs)), dt_imu,
            **bound)
        outs.append(out)
    return state, outs


def init_localizer_state(cfg: EudoxusConfig, window: int, p0=None, v0=None,
                         q0=None, device=None) -> LocalizerState:
    """Fresh state for one robot, composed from the frontend and track
    carries and the filter's initial state."""
    n = cfg.frontend.max_features
    fe = pipeline.init_carry(cfg.frontend, device)
    tr = tracks.init_carry(n, window, device)
    return LocalizerState(
        filt=msckf.init_state(window, p0=p0, v0=v0, q0=q0, device=device),
        tracks_uv=tr.uv, tracks_valid=tr.valid, prev_img=fe.prev_img,
        prev_yx=fe.prev_yx, prev_valid=fe.prev_valid,
        frame_idx=torch.zeros((), dtype=torch.int32, device=device))
