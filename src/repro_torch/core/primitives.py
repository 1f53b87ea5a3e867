"""Fundamental localization primitives — the stages ``vio`` composes.

The ``vio`` scenario is the shared spine (frontend, track ring, IMU
propagate + clone augment, MSCKF update) followed by GPS fusion. Each
stage is ``stage(ctx, carry) -> FrameCarry``.

On the card the spine's two heavy blocks run the hand-written kernels:
``_frontend`` goes through ``kernels.frontend_fused`` (kernels A, B, C)
and ``_imu_propagate`` through ``kernels.cov_update``; on the CPU the
same wrappers run their plain versions.

Per-frame gates stay tensors (frame 0's skipped propagation, GPS
validity), with one exception: whether the MSCKF update runs is a host
branch, which reads a device value. ``HOST_SYNCS`` counts those reads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import tracks
from repro_torch.core.backend import fusion, msckf
from repro_torch.core.frontend import pipeline
from repro_torch.kernels import cov_update

# device->host reads taken on the frame path, by stage
HOST_SYNCS = {"msckf_update": 0}


@dataclass(frozen=True)
class FrameCtx:
    """Per-localizer bindings shared by every stage."""
    cfg: Any                 # frontend config
    fx: float
    fy: float
    cx: float
    cy: float
    dt_imu: torch.Tensor     # () float32 IMU sample interval


@dataclass(frozen=True)
class FrameCarry:
    """The frame's inputs, the ``LocalizerState`` fields, and the
    frontend products later stages read."""
    img_l: torch.Tensor
    img_r: torch.Tensor
    accel: torch.Tensor
    gyro: torch.Tensor
    gps: torch.Tensor
    filt: Any
    tracks_uv: torch.Tensor
    tracks_valid: torch.Tensor
    prev_img: torch.Tensor
    prev_yx: torch.Tensor
    prev_valid: torch.Tensor
    frame_idx: torch.Tensor  # () int32 PRE-frame index
    fr: Any = None


def _replace(c: FrameCarry, **kw) -> FrameCarry:
    return dataclasses.replace(c, **kw)


def _frontend(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """FAST+ORB features, stereo correspondences, LK tracks."""
    fe_carry = pipeline.FrontendCarry(prev_img=c.prev_img,
                                      prev_yx=c.prev_yx,
                                      prev_valid=c.prev_valid)
    fe_carry, fr = pipeline.step_carry(fe_carry, c.img_l, c.img_r, ctx.cfg)
    return _replace(c, fr=fr, prev_img=fe_carry.prev_img,
                    prev_yx=fe_carry.prev_yx,
                    prev_valid=fe_carry.prev_valid)


def _track_ring(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """Fixed-shape track ring buffer over the clone window."""
    tracks_uv, tracks_valid = tracks.roll_and_update(
        c.tracks_uv, c.tracks_valid, c.fr.yx, c.fr.valid,
        c.fr.prev_yx, c.fr.track_valid)
    return _replace(c, tracks_uv=tracks_uv, tracks_valid=tracks_valid)


def _imu_propagate(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """MSCKF propagate + clone augmentation: nominal integration here,
    the covariance sweep in ``cov_update`` (frame 0 defines the start
    pose, so its propagation is gated off by a tensor, not a branch)."""
    f = c.filt
    q, p, v, F_seq, Q = msckf.propagate_terms(f, c.accel, c.gyro,
                                              dt=ctx.dt_imu)
    do = c.frame_idx > 0
    q = torch.where(do, q, f.q)
    p = torch.where(do, p, f.p)
    v = torch.where(do, v, f.v)
    P = cov_update.fused_update(f.P, F_seq, Q, do)
    W = f.clones_q.shape[0]
    filt = f._replace(
        q=q, p=p, v=v,
        clones_q=torch.cat([f.clones_q[1:], q[None]], dim=0),
        clones_p=torch.cat([f.clones_p[1:], p[None]], dim=0),
        n_clones=torch.clamp(f.n_clones + 1, max=W), P=P)
    return _replace(c, filt=filt)


def _msckf_update(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """MSCKF update on CONSUMED tracks only (ended this frame, or at
    full window length), each observation used exactly once."""
    uv, vd, count, consumed = tracks.select_consumed(c.tracks_uv,
                                                     c.tracks_valid)
    do_consume = (count >= tracks.MIN_UPDATE_TRACKS) & (c.frame_idx >= 3)
    HOST_SYNCS["msckf_update"] += 1
    if not bool(do_consume):
        return c
    filt = msckf.update(c.filt, uv, vd, fx=ctx.fx, fy=ctx.fy,
                        cx=ctx.cx, cy=ctx.cy)[0]
    return _replace(c, filt=filt,
                    tracks_valid=tracks.consume(c.tracks_valid, consumed))


def _gps_fusion(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """Loosely-coupled GPS position fusion (NaN fixes get zero weight)."""
    return _replace(c, filt=fusion.gps_update(c.filt, c.gps)[0])


# the vio scenario: the shared spine, then its switch stage
SPINE = (_frontend, _track_ring, _imu_propagate, _msckf_update)
VIO = SPINE + (_gps_fusion,)
