"""Windowed bundle adjustment + Schur marginalization on fixed shapes.

State layout (``BAState``, one per robot, part of ``LocalizerState``):

    kf_R     (Kw, 3, 3)  window keyframe rotations (cam-to-world);
    kf_p     (Kw, 3)     window keyframe positions.  Slot 0 is the
                         OLDEST keyframe: the window fills front-to-back
                         and shifts left once full, so the gauge anchor
                         and the marginalized pose are both slot 0.
    kf_valid (Kw,)       which slots hold real keyframes
    n_kf     ()          int32 keyframes pushed (saturates at Kw)
    H_prior  (D, D)      marginalization prior over the Kw-1 kept poses,
    b_prior  (D,)        D = 6*(Kw-1) — refreshed by every BA pass
    last_cost ()         final LM cost of the latest BA pass

Per SLAM frame the step pushes the post-frame pose as a keyframe and,
when the BA trigger holds, back-projects the frame's stereo features
into a padded ``ba_landmarks`` budget, synthesizes the window's
observations, runs the fixed-iteration LM loop (``mapping.lm_optimize``)
and marginalizes the oldest pose through ``kernels.marg_schur`` (the
CUDA kernel on the card, its plain version on the CPU).

BA is feedback-free: results land in ``BAState`` and never touch the
filter.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.backend import mapping
from repro_torch.core.backend import matrix_blocks as mb
from repro_torch.kernels import marg_schur


class BAState(NamedTuple):
    kf_R: torch.Tensor       # (Kw, 3, 3)
    kf_p: torch.Tensor       # (Kw, 3)
    kf_valid: torch.Tensor   # (Kw,) bool
    n_kf: torch.Tensor       # () int32
    H_prior: torch.Tensor    # (6*(Kw-1), 6*(Kw-1))
    b_prior: torch.Tensor    # (6*(Kw-1),)
    last_cost: torch.Tensor  # () float32


def init_ba_state(ba_window: int, device=None) -> BAState:
    d = 6 * (ba_window - 1)
    f32 = dict(dtype=torch.float32, device=device)
    return BAState(
        kf_R=torch.eye(3, **f32).repeat(ba_window, 1, 1),
        kf_p=torch.zeros((ba_window, 3), **f32),
        kf_valid=torch.zeros((ba_window,), dtype=torch.bool, device=device),
        n_kf=torch.zeros((), dtype=torch.int32, device=device),
        H_prior=torch.zeros((d, d), **f32),
        b_prior=torch.zeros((d,), **f32),
        last_cost=torch.zeros((), **f32))


def push_keyframe(ba: BAState, R: torch.Tensor, p: torch.Tensor) -> BAState:
    """Append a keyframe: fill front-to-back, then shift left (slot 0
    stays the oldest). Masked selects on the device count: no host read."""
    kw = ba.kf_valid.shape[0]
    full = ba.n_kf >= kw
    slot = torch.arange(kw, device=ba.n_kf.device) == torch.clamp(
        ba.n_kf, max=kw - 1)

    def place(buf, new):
        shifted = torch.where(full, torch.roll(buf, -1, dims=0), buf)
        at = slot.reshape((kw,) + (1,) * (buf.dim() - 1))
        return torch.where(at, new, shifted)

    return ba._replace(
        kf_R=place(ba.kf_R, R), kf_p=place(ba.kf_p, p),
        kf_valid=place(ba.kf_valid, torch.ones((), dtype=torch.bool,
                                               device=ba.n_kf.device)),
        n_kf=torch.clamp(ba.n_kf + 1, max=kw))


def backproject_stereo(yx: torch.Tensor, disparity: torch.Tensor,
                       stereo_valid: torch.Tensor, R: torch.Tensor,
                       p: torch.Tensor, *, fx: float, fy: float, cx: float,
                       cy: float, baseline: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo features -> world points, and which of them are usable."""
    valid = stereo_valid & (disparity > 0.5)
    z = fx * baseline / torch.clamp(disparity, min=1e-3)
    u = yx[:, 1].float()
    v = yx[:, 0].float()
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pc = torch.stack([x, y, z], dim=1)
    pw = pc @ R.T + p
    return pw.float(), valid & (z < 60.0)


def select_landmarks(pts: torch.Tensor, valid: torch.Tensor,
                     budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad/crop to the fixed landmark budget, valid points first, ties in
    index order (a stable sort)."""
    sel = torch.argsort((~valid).to(torch.uint8), stable=True)[:budget]
    return pts[sel], valid[sel]


def window_problem(ba: BAState, lms: torch.Tensor, lm_valid: torch.Tensor,
                   intr: torch.Tensor) -> mapping.BAProblem:
    """Synthesize the window's observations by projecting the newest
    keyframe's landmarks into every window pose, masking invalid keyframe
    slots."""
    pc = (lms[None] - ba.kf_p[:, None]) @ ba.kf_R             # (Kw,M,3)
    z = torch.clamp(pc[..., 2], min=1e-3)
    u = intr[0] * pc[..., 0] / z + intr[2]
    v = intr[1] * pc[..., 1] / z + intr[3]
    ov = lm_valid[None] & (pc[..., 2] > 0.3) & ba.kf_valid[:, None]
    return mapping.BAProblem(poses_R=ba.kf_R, poses_p=ba.kf_p,
                             landmarks=lms, obs_uv=torch.stack([u, v], -1),
                             obs_valid=ov, intrinsics=intr)


def _pose_major(Hpl: torch.Tensor) -> torch.Tensor:
    """(K,M,6,3) couplings -> G (M, 6K, 3), row 6k+i for pose k."""
    k, m = Hpl.shape[0], Hpl.shape[1]
    return Hpl.permute(1, 0, 2, 3).reshape(m, 6 * k, 3).contiguous()


def marginalize_schur(Hpp, Hpl, Hll, bp, bl, jitter: float = 1e-4):
    """Marginalize the oldest pose + all landmarks through the blocked
    Schur reduction ``marg_schur.accumulate`` (numerically equivalent to
    ``mapping.marginalize``)."""
    a = Hll + jitter * torch.eye(3, dtype=Hll.dtype, device=Hll.device)[None]
    yy, yv = marg_schur.accumulate(_pose_major(Hpl), a.contiguous(),
                                   bl.contiguous())
    return _schur_tail(Hpp, bp, yy, yv, jitter)


def _schur_tail(Hpp, bp, yy, yv, jitter):
    """Schur complement of the landmark block inside H_mm (6x6 algebra)."""
    k = Hpp.shape[0]
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    s_d = Hpp[0] + jitter * eye6 - yy[:6, :6]
    s_d_inv = mb.inverse_spd(s_d, jitter=jitter)
    u = yy[6:, :6]                                    # C A^{-1} B, stacked
    h_keep = torch.block_diag(*Hpp[1:])
    h_prior = h_keep - (yy[6:, 6:] + u @ s_d_inv @ u.T)
    h_prior = 0.5 * (h_prior + h_prior.T)
    y0 = s_d_inv @ (bp[0] - yv[:6])                   # marginal pose soln
    b_prior = bp[1:].reshape(-1) - (yv[6:] - u @ y0)
    return h_prior, b_prior


def marginalize_schur_normal(Hpp, bp, r, jx, jl, jitter: float = 1e-4):
    """Marginalize straight from the BA residual Jacobians: the
    ``marg_schur.accumulate_normal`` kernel assembles each landmark's
    normal-equation blocks and feeds them to the Schur reduction. Only
    the pose-diagonal Hpp (K,6,6) and bp (K,6), which the 6x6 tail needs
    whole, are assembled outside it."""
    yy, yv = marg_schur.accumulate_normal(r.contiguous(), jx.contiguous(),
                                          jl.contiguous(), jitter=jitter)
    return _schur_tail(Hpp, bp, yy, yv, jitter)


def ba_round(ba: BAState, lms: torch.Tensor, lm_valid: torch.Tensor,
             intr: torch.Tensor, *, lm_iters: int,
             lm_lambda0: float) -> BAState:
    """One windowed BA + marginalization pass over the current window:
    LM-optimize the window, linearize at the optimum, marginalize the
    oldest pose into (H_prior, b_prior)."""
    prob = window_problem(ba, lms, lm_valid, intr)
    prob, costs = mapping.lm_optimize(prob, lm_iters, lm_lambda0)
    kw, m = prob.obs_valid.shape
    dev = lms.device
    r, jx, jl = mapping.residuals(
        prob, torch.zeros((kw, 6), dtype=torch.float32, device=dev),
        torch.zeros((m, 3), dtype=torch.float32, device=dev))
    hpp = torch.einsum("kmri,kmrj->kij", jx, jx)
    bp = torch.einsum("kmri,kmr->ki", jx, r)
    h_prior, b_prior = marginalize_schur_normal(hpp, bp, r, jx, jl)
    return ba._replace(H_prior=h_prior, b_prior=b_prior,
                       last_cost=costs[-1])
