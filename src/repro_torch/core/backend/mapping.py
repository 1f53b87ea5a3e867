"""SLAM mapping: Levenberg-Marquardt bundle adjustment + marginalization.

The paper's SLAM backend solves a nonlinear least-squares problem (Ceres
LM, Sec. IV-A) whose variation-dominating kernel is *marginalization* —
Schur-complement elimination with the [[diag A, B],[B^T, D(6x6)]]
structure (Sec. VI-A). Both are built on the shared matrix blocks:
  - normal equations: blocked H = J^T J
  - landmark elimination: diag-block inverse (the specialized unit)
  - pose solve: Cholesky + fwd/bwd substitution
All shapes static: K poses x M landmarks with validity masks. ``repro``
vmaps the per-observation work; here (K, M) are broadcast dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import matrix_blocks as mb
from repro_torch.core.backend.msckf import skew


class BAProblem(NamedTuple):
    poses_R: torch.Tensor      # (K,3,3) cam-to-world rotation
    poses_p: torch.Tensor      # (K,3)
    landmarks: torch.Tensor    # (M,3)
    obs_uv: torch.Tensor       # (K,M,2) pixel observations
    obs_valid: torch.Tensor    # (K,M) bool
    intrinsics: torch.Tensor   # (4,) fx fy cx cy


def reproject(R, p, lm, intr):
    """Project landmarks lm (..., 3) through poses R (..., 3, 3), p (..., 3)
    (broadcast): (pixel (..., 2), camera-frame point (..., 3))."""
    pc = (R.mT @ (lm - p)[..., None])[..., 0]
    z = torch.clamp(pc[..., 2], min=1e-3)
    return torch.stack([intr[0] * pc[..., 0] / z + intr[2],
                        intr[1] * pc[..., 1] / z + intr[3]], -1), pc


def residuals(prob: BAProblem, dposes: torch.Tensor, dlms: torch.Tensor):
    """r, J blocks for pose deltas (K,6: rot, trans) and landmark deltas:
    (K,M,2), (K,M,2,6), (K,M,2,3)."""
    intr = prob.intrinsics
    eye = torch.eye(3, dtype=torch.float32, device=intr.device)
    # apply increments on the linearization point
    R = prob.poses_R @ (eye + skew(dposes[:, :3]))             # (K,3,3)
    p = prob.poses_p + dposes[:, 3:]
    lm = prob.landmarks + dlms
    pred, pc = reproject(R[:, None], p[:, None], lm[None], intr)
    w = prob.obs_valid.float()[..., None]                      # (K,M,1)
    r = (prob.obs_uv - pred) * w
    z = torch.clamp(pc[..., 2], min=1e-3)
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([intr[0] / z, zero, -intr[0] * pc[..., 0] / z ** 2], -1),
        torch.stack([zero, intr[1] / z, -intr[1] * pc[..., 1] / z ** 2], -1),
    ], -2)                                                     # (K,M,2,3)
    w = w[..., None]
    Rt = R.mT[:, None]                                         # (K,1,3,3)
    J_rot = Jp @ skew(pc) * w
    J_tr = -(Jp @ Rt) * w
    J_lm = (Jp @ Rt) * w
    return r, torch.cat([J_rot, J_tr], dim=-1), J_lm


def build_normal_eqs(r, Jx, Jl):
    """Blocked Gauss-Newton system:
    Hpp (K,6,6), Hpl (K,M,6,3), Hll (M,3,3), bp (K,6), bl (M,3)."""
    Hpp = torch.einsum("kmri,kmrj->kij", Jx, Jx)          # block-diag per pose
    Hll = torch.einsum("kmri,kmrj->mij", Jl, Jl)          # (M,3,3)
    Hpl = torch.einsum("kmri,kmrj->kmij", Jx, Jl)         # (K,M,6,3)
    bp = torch.einsum("kmri,kmr->ki", Jx, r)              # (K,6)
    bl = torch.einsum("kmri,kmr->mi", Jl, r)              # (M,3)
    return Hpp, Hpl, Hll, bp, bl


def schur_solve(Hpp, Hpl, Hll, bp, bl, lam, anchor_weight: float = 1e6):
    """Eliminate landmarks (diag 3x3 blocks — the paper's reciprocal/
    small-inverse unit), solve the reduced pose system by Cholesky.

    The first pose is gauge-anchored (strong prior): windowed BA has a
    6-DoF gauge freedom, and without the anchor the solution slides along
    it (cost converges, poses don't)."""
    K = Hpl.shape[0]
    dev = Hpl.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    Hll_inv = mb.inverse_spd(Hll + lam * eye3[None])            # (M,3,3)
    # reduced system: S = Hpp_full - Hpl Hll^-1 Hlp
    HplHinv = torch.einsum("kmij,mjl->kmil", Hpl, Hll_inv)      # (K,M,6,3)
    S_off = torch.einsum("kmil,qmjl->kiqj", HplHinv, Hpl)       # (K,6,K,6)
    S = -S_off.reshape(6 * K, 6 * K)
    S = S + torch.block_diag(*Hpp) + lam * torch.eye(
        6 * K, dtype=torch.float32, device=dev)
    anchor = torch.zeros(6 * K, dtype=torch.float32, device=dev)
    anchor[:6] = anchor_weight
    S = S + torch.diag(anchor)                                  # gauge anchor
    rhs = bp.reshape(6 * K) - torch.einsum(
        "kmil,ml->ki", HplHinv, bl).reshape(6 * K)
    dx_p = mb.solve_spd(S, rhs[:, None])[:, 0]
    # back-substitute landmarks
    dxp_k = dx_p.reshape(K, 6)
    dl = torch.einsum("mij,mj->mi", Hll_inv,
                      bl - torch.einsum("kmij,ki->mj", Hpl, dxp_k))
    return dxp_k, dl


def lm_optimize(prob: BAProblem, iters: int = 10, lam0: float = 1e-3):
    """Levenberg-Marquardt loop (fixed iterations, damped retry built in).
    The accept test and the damping update stay tensors: no host read.
    Returns the optimized problem and the (iters,) per-iteration costs."""
    K, M = prob.obs_valid.shape
    dev = prob.landmarks.device
    dp = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    dl = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(iters):
        r, Jx, Jl = residuals(prob, dp, dl)
        Hpp, Hpl, Hll, bp, bl = build_normal_eqs(r, Jx, Jl)
        step_p, step_l = schur_solve(Hpp, Hpl, Hll, bp, bl, lam)
        c0 = torch.sum(r ** 2)
        c1 = torch.sum(residuals(prob, dp + step_p, dl + step_l)[0] ** 2)
        improved = c1 < c0
        dp = torch.where(improved, dp + step_p, dp)
        dl = torch.where(improved, dl + step_l, dl)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        costs.append(c1)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    poses_R = prob.poses_R @ (eye + skew(dp[:, :3]))
    return prob._replace(poses_R=poses_R, poses_p=prob.poses_p + dp[:, 3:],
                         landmarks=prob.landmarks + dl), torch.stack(costs)


def marginalize(Hpp, Hpl, Hll, bp, bl, jitter: float = 1e-4):
    """Marginalize the oldest pose + all landmarks via Schur complement
    (the dense oracle ``ba.marginalize_schur`` is checked against).

    The paper's A_mm = [[A, B], [B^T, D]] structure (Sec. VI-A): A is the
    landmark block (block-diagonal 3x3), D is the 6x6 oldest-pose block.
    The kept poses receive the resulting prior (H_prior, b_prior).
    """
    K = Hpl.shape[0]
    dev = Hpl.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    A_inv = mb.inverse_spd(Hll + jitter * eye3)                 # (M,3,3)
    Bt = Hpl[0]                                          # (M,6,3): B^T chunks
    # Schur complement of A inside H_mm: S_D = D - B^T A^{-1} B   (6x6)
    BtAinv = torch.einsum("mij,mjl->mil", Bt, A_inv)
    S_D = Hpp[0] + jitter * eye6 - torch.einsum("mil,mjl->ij", BtAinv, Bt)
    S_D_inv = mb.inverse_spd(S_D, jitter=jitter)

    # kept-pose <-> landmark couplings (no pose-pose factors)
    C_lm = Hpl[1:]                                       # (K-1, M, 6, 3)
    CAinv = torch.einsum("kmij,mjl->kmil", C_lm, A_inv)  # C A^{-1}
    term1 = torch.einsum("kmil,qmjl->kiqj", CAinv, C_lm)
    u = torch.einsum("kmil,mjl->kij", CAinv, Bt)         # C A^{-1} B
    term2 = torch.einsum("kij,jl,qml->kiqm", u, S_D_inv, u)
    n_keep = 6 * (K - 1)
    Hkeep = torch.block_diag(*Hpp[1:])
    H_prior = Hkeep - (term1 + term2).reshape(n_keep, n_keep)
    H_prior = 0.5 * (H_prior + H_prior.T)

    # b_prior = b_keep - H_km H_mm^{-1} b_m,  b_m = [bl; bp0]
    v_l = torch.einsum("mij,mj->mi", A_inv, bl)          # A^{-1} bl
    w = bp[0] - torch.einsum("mil,ml->i", BtAinv, bl)    # bp0 - B^T A^{-1} bl
    y0 = S_D_inv @ w                                     # marginal pose soln
    AinvB = torch.einsum("mij,mlj->mil", A_inv, Bt)      # A^{-1} B
    x_l = v_l - torch.einsum("mil,l->mi", AinvB, y0)     # landmark soln
    corr = torch.einsum("kmij,mj->ki", C_lm, x_l)        # C x_l
    b_prior = bp[1:].reshape(n_keep) - corr.reshape(n_keep)
    return H_prior, b_prior
