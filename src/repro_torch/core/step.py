"""Per-frame state threading for the localization hot path.

Functions of fixed-shape tensors; ``core.localizer.Localizer`` drives
them. Two granularities:

  ``localize_step``   one frame: the spine, then the frame's scenario's
                      switch stages, then its gated stages
  ``localize_chunk``  K frames: a Python loop of ``frame_transition``
                      over the chunk; padding frames (``active`` False)
                      pass the state through, so every chunk has K
                      frames

``repro`` compiles every registered scenario into one program and picks
the stages per frame with ``lax.switch``/``lax.cond`` on the mode id;
here the mode id and ``active`` are host arrays, so the pick is a host
branch. The host also carries mirrors of the frame index and keyframe
count (``HostMirror``), which the BA trigger reads instead of the
device.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.eudoxus import EudoxusConfig
from repro_torch.core import primitives as prim
from repro_torch.core import scenarios, tracks
from repro_torch.core.backend import ba as ba_mod
from repro_torch.core.backend import msckf
from repro_torch.core.environment import PORTED, Mode
from repro_torch.core.frontend import pipeline
from repro_torch.core.frontend.pipeline import FrontendResult


class LocalizerState(NamedTuple):
    """Per-robot state on the device."""
    filt: msckf.MsckfState
    tracks_uv: torch.Tensor     # (N, W, 2) uv observations across the window
    tracks_valid: torch.Tensor  # (N, W) bool
    prev_img: torch.Tensor      # (H, W) previous left image (LK source)
    prev_yx: torch.Tensor       # (N, 2) int32 previous frame's features
    prev_valid: torch.Tensor    # (N,) bool
    frame_idx: torch.Tensor     # () int32
    ba: ba_mod.BAState          # SLAM keyframe window + marginalization prior


class HostMirror(NamedTuple):
    """Host copies of ``state.frame_idx`` and ``state.ba.n_kf``, read
    from the device once per ``Localizer`` call and advanced on the
    host frame by frame."""
    frame_idx: int
    n_kf: int


class FrameInputs(NamedTuple):
    """One frame's inputs; for a K-frame chunk every tensor gains a
    leading (K,) axis. ``mode`` and ``active`` are host arrays: the mode
    picks the stages host-side, and padding frames are skipped
    host-side."""
    img_l: torch.Tensor   # (H, W) float32
    img_r: torch.Tensor   # (H, W) float32
    accel: torch.Tensor   # (ipf, 3) float32 IMU accel ending at this frame
    gyro: torch.Tensor    # (ipf, 3) float32
    gps: torch.Tensor     # (3,) float32, NaN when unavailable
    mode: np.ndarray      # () int32 scenario mode id
    active: np.ndarray    # () bool; False = padding frame


class FrameOutputs(NamedTuple):
    """Per-frame outputs: what the host stage reads after the step.
    ``fr`` is None on padding frames; ``hist`` is None on frames whose
    scenario has no BoW stage and on padding frames; ``ba_ran`` is a
    host bool (the trigger is decided on the host)."""
    fr: Optional[FrontendResult]
    p: torch.Tensor                 # (3,) post-frame position
    q: torch.Tensor                 # (4,) post-frame orientation quaternion
    hist: Optional[torch.Tensor]    # (V,) BoW histogram
    ba_ran: bool


def localize_step(state: LocalizerState, host: HostMirror, img_l, img_r,
                  accel, gyro, gps, mode: int, dt_imu: torch.Tensor, *,
                  cfg, be_cfg, fx: float, fy: float, cx: float, cy: float,
                  baseline: float, intr: torch.Tensor, vocab: torch.Tensor
                  ) -> Tuple[LocalizerState, HostMirror, FrameOutputs]:
    """One frame: the spine, then the scenario's switch stages (filter
    only), then its gated stages."""
    spec = scenarios.SPECS[int(mode)]
    if Mode(spec.name) not in PORTED:
        raise ValueError(f"mode id {int(mode)} ({spec.name}) is not yet "
                         f"ported to repro_torch")
    ctx = prim.FrameCtx(cfg=cfg, be_cfg=be_cfg, fx=fx, fy=fy, cx=cx, cy=cy,
                        baseline=baseline, intr=intr, vocab=vocab,
                        dt_imu=dt_imu)
    c = prim.FrameCarry(
        img_l=img_l, img_r=img_r, accel=accel, gyro=gyro, gps=gps,
        filt=state.filt, tracks_uv=state.tracks_uv,
        tracks_valid=state.tracks_valid, prev_img=state.prev_img,
        prev_yx=state.prev_yx, prev_valid=state.prev_valid,
        frame_idx=state.frame_idx, ba=state.ba,
        host_frame_idx=host.frame_idx, host_n_kf=host.n_kf)
    for stage in prim.SPINE:
        c = stage(ctx, c)
    for name, params in spec.switch:
        c = dataclasses.replace(c, filt=prim.SWITCH[name](ctx, c, params))
    for name in spec.gated:
        c = prim.GATED[name](ctx, c)
    new_state = LocalizerState(
        filt=c.filt, tracks_uv=c.tracks_uv, tracks_valid=c.tracks_valid,
        prev_img=c.prev_img, prev_yx=c.prev_yx, prev_valid=c.prev_valid,
        frame_idx=c.frame_idx + 1, ba=c.ba)
    return new_state, HostMirror(host.frame_idx + 1, c.host_n_kf), \
        FrameOutputs(fr=c.fr, p=c.filt.p, q=c.filt.q, hist=c.hist,
                     ba_ran=c.ba_ran)


def frame_transition(state: LocalizerState, host: HostMirror,
                     inp: FrameInputs, dt_imu: torch.Tensor, **bound
                     ) -> Tuple[LocalizerState, HostMirror, FrameOutputs]:
    """One frame of the chunk, or a pass-through for a padding frame
    (which outputs the unchanged pose and no frontend result)."""
    if not bool(inp.active):
        return state, host, FrameOutputs(
            fr=None, p=state.filt.p, q=state.filt.q, hist=None, ba_ran=False)
    return localize_step(state, host, inp.img_l, inp.img_r, inp.accel,
                         inp.gyro, inp.gps, inp.mode, dt_imu, **bound)


def localize_chunk(state: LocalizerState, host: HostMirror,
                   inputs: FrameInputs, dt_imu: torch.Tensor, **bound
                   ) -> Tuple[LocalizerState, HostMirror, List[FrameOutputs]]:
    """K frames: ``frame_transition`` over the chunk's leading axis.
    Returns the post-chunk state and mirror and the K per-frame
    outputs."""
    outs = []
    for k in range(len(inputs.active)):
        state, host, out = frame_transition(
            state, host, FrameInputs(*(leaf[k] for leaf in inputs)), dt_imu,
            **bound)
        outs.append(out)
    return state, host, outs


def init_localizer_state(cfg: EudoxusConfig, window: int, p0=None, v0=None,
                         q0=None, device=None) -> LocalizerState:
    """Fresh state for one robot, composed from the frontend, track and
    windowed-BA carries and the filter's initial state."""
    n = cfg.frontend.max_features
    fe = pipeline.init_carry(cfg.frontend, device)
    tr = tracks.init_carry(n, window, device)
    return LocalizerState(
        filt=msckf.init_state(window, p0=p0, v0=v0, q0=q0, device=device),
        tracks_uv=tr.uv, tracks_valid=tr.valid, prev_img=fe.prev_img,
        prev_yx=fe.prev_yx, prev_valid=fe.prev_valid,
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        ba=ba_mod.init_ba_state(cfg.backend.ba_window, device))
