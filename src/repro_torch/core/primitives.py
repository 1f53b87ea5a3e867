"""Fundamental localization primitives — the stages scenarios compose.

Every scenario runs the shared spine (frontend, track ring, IMU
propagate + clone augment, MSCKF update), then its switch stages
(``SWITCH``: filter-only work such as GPS fusion), then its gated
stages (``GATED``: the BoW histogram and windowed BA + marginalization
of ``slam``). ``core.scenarios`` names the stages each scenario runs.
Signatures: ``spine(ctx, carry) -> FrameCarry``,
``switch(ctx, carry, params) -> MsckfState``,
``gated(ctx, carry) -> FrameCarry``.

On the card the heavy blocks run the hand-written kernels:
``_frontend`` goes through ``kernels.frontend_fused`` (kernels A, B, C),
``_imu_propagate`` through ``kernels.cov_update`` and
``_ba_marginalize`` through ``kernels.marg_schur``; on the CPU the same
wrappers run their plain versions.

Per-frame gates stay tensors (frame 0's skipped propagation, GPS
validity), with one exception: whether the MSCKF update runs is a host
branch, which reads a device value. ``HOST_SYNCS`` counts those reads.
The BA trigger is a host branch too, but it reads the host mirrors of
the frame index and keyframe count (``FrameCarry.host_frame_idx``/
``host_n_kf``), not the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import tracks
from repro_torch.core.backend import ba as ba_mod
from repro_torch.core.backend import fusion, msckf, tracking
from repro_torch.core.frontend import pipeline
from repro_torch.kernels import cov_update

# device->host reads, by what takes them: the MSCKF update gate (one per
# frame) and the host mirror of frame index and keyframe count (one per
# ``Localizer.run``/``step`` call)
HOST_SYNCS = {"msckf_update": 0, "host_mirror": 0}


@dataclass(frozen=True)
class FrameCtx:
    """Per-localizer bindings shared by every stage."""
    cfg: Any                 # frontend config
    be_cfg: Any              # backend config
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    intr: torch.Tensor       # (4,) fx fy cx cy on the device
    vocab: torch.Tensor      # (depth, 256) BoW hyperplanes
    dt_imu: torch.Tensor     # () float32 IMU sample interval


@dataclass(frozen=True)
class FrameCarry:
    """The frame's inputs, the ``LocalizerState`` fields, the host
    mirrors of the frame index and keyframe count, and the per-frame
    products later stages and the outputs read."""
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
    ba: Any
    host_frame_idx: int      # frame_idx, mirrored on the host
    host_n_kf: int           # ba.n_kf, mirrored on the host
    fr: Any = None
    hist: Any = None         # (V,) BoW histogram (bow_histogram frames)
    ba_ran: bool = False     # a BA round ran this frame


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


def _gps_fusion(ctx: FrameCtx, c: FrameCarry, params):
    """Loosely-coupled GPS position fusion (NaN fixes get zero weight).
    ``sigma_gps`` down-weights degraded receivers (``vio_degraded``)."""
    sigma = params.get("sigma_gps")
    if sigma is None:
        return fusion.gps_update(c.filt, c.gps)[0]
    return fusion.gps_update(c.filt, c.gps, sigma_gps=float(sigma))[0]


def _bow_histogram(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """BoW histogram of this frame's descriptors — the host map stage
    records it with the keyframe without touching the device."""
    return _replace(c, hist=tracking.bow_histogram(c.fr.desc, c.fr.valid,
                                                   ctx.vocab))


def _ba_marginalize(ctx: FrameCtx, c: FrameCarry) -> FrameCarry:
    """SLAM windowed BA + Schur marginalization (paper Sec. VI-A's
    variation-dominating kernel): push the post-frame pose as a keyframe
    and, when at least ``ba_min_keyframes`` are in the window and the
    frame index is a multiple of ``ba_every``, run the BA round. The
    trigger reads the host mirrors, so it takes no device read."""
    be = ctx.be_cfg
    R = msckf.quat_to_rot(c.filt.q)
    ba = ba_mod.push_keyframe(c.ba, R, c.filt.p)
    n_kf = min(c.host_n_kf + 1, ba.kf_valid.shape[0])
    ran = (n_kf >= be.ba_min_keyframes
           and c.host_frame_idx % be.ba_every == 0)
    if ran:
        pts, pv = ba_mod.backproject_stereo(
            c.fr.yx, c.fr.disparity, c.fr.stereo_valid, R, c.filt.p,
            fx=ctx.fx, fy=ctx.fy, cx=ctx.cx, cy=ctx.cy,
            baseline=ctx.baseline)
        lms, lmv = ba_mod.select_landmarks(pts, pv, be.ba_landmarks)
        ba = ba_mod.ba_round(ba, lms, lmv, ctx.intr, lm_iters=be.lm_iters,
                             lm_lambda0=be.lm_lambda0)
    return _replace(c, ba=ba, host_n_kf=n_kf, ba_ran=ran)


# the shared spine every scenario runs first
SPINE = (_frontend, _track_ring, _imu_propagate, _msckf_update)
# switch and gated stages, by the names ``core.scenarios`` uses
SWITCH = {"gps_fusion": _gps_fusion}
GATED = {"bow_histogram": _bow_histogram, "ba_marginalize": _ba_marginalize}
