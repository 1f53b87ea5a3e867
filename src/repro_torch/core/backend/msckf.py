"""MSCKF (Multi-State Constraint Kalman Filter) — the VIO backend mode.

Sliding window of camera pose clones; feature tracks spanning the window
update the filter without putting landmarks in the state (Mourikis &
Roumeliotis 2007).

State layout (error-state, all fixed shapes):
  nominal: q (4) wxyz world<-body, p (3), v (3), bg (3), ba (3)
           + window clones: (W, 7) [q, p]
  error:   15 + 6W  (theta, dp, dv, dbg, dba | per clone: dtheta, dp)

``repro`` vmaps the per-feature and per-clone work; here features (F)
and clones (W) are explicit leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.backend import matrix_blocks as mb


# --------------------------------------------------------------------------
# quaternion / so3 utilities (wxyz), batched over leading dims
# --------------------------------------------------------------------------

def quat_mult(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                    keepdim=True), min=1e-12)


def quat_to_rot(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def small_quat(dtheta):
    half = 0.5 * dtheta
    return quat_normalize(torch.cat([torch.ones_like(half[..., :1]), half],
                                    dim=-1))


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


def _eye(n, like):
    return torch.eye(n, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# filter state
# --------------------------------------------------------------------------

class MsckfState(NamedTuple):
    q: torch.Tensor         # (4,)
    p: torch.Tensor         # (3,)
    v: torch.Tensor         # (3,)
    bg: torch.Tensor        # (3,)
    ba: torch.Tensor        # (3,)
    clones_q: torch.Tensor  # (W,4)
    clones_p: torch.Tensor  # (W,3)
    n_clones: torch.Tensor  # () int32
    P: torch.Tensor         # (15+6W, 15+6W) error covariance


_GRAVITY = {}


def gravity(device) -> torch.Tensor:
    """World gravity on ``device`` (made once per device)."""
    if device not in _GRAVITY:
        _GRAVITY[device] = torch.tensor([0.0, -9.81, 0.0], device=device)
    return _GRAVITY[device]


def init_state(window: int, p0=None, q0=None, v0=None,
               device=None) -> MsckfState:
    """Tight attitude/position (known start), loose velocity/biases."""
    def vec(x, default):
        if x is None:
            return torch.tensor(default, dtype=torch.float32, device=device)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    diag = torch.cat([
        torch.full((3,), 1e-4), torch.full((3,), 1e-4),
        torch.full((3,), 0.25), torch.full((3,), 1e-4),
        torch.full((3,), 1e-2), torch.full((6 * window,), 1e-4)])
    return MsckfState(
        q=vec(q0, [1.0, 0, 0, 0]), p=vec(p0, [0.0] * 3),
        v=vec(v0, [0.0] * 3),
        bg=torch.zeros(3, device=device), ba=torch.zeros(3, device=device),
        clones_q=torch.tensor([1.0, 0, 0, 0], device=device
                              ).repeat(window, 1),
        clones_p=torch.zeros((window, 3), device=device),
        n_clones=torch.zeros((), dtype=torch.int32, device=device),
        P=torch.diag(diag).to(device))


# --------------------------------------------------------------------------
# IMU propagation
# --------------------------------------------------------------------------

def _noise(dt, sigma_a, sigma_g, like):
    I3 = _eye(3, like)
    Q = torch.zeros((15, 15), device=like.device)
    Q[0:3, 0:3] = I3 * (sigma_g * dt) ** 2
    Q[6:9, 6:9] = I3 * (sigma_a * dt) ** 2
    Q[9:12, 9:12] = I3 * (1e-5 * dt) ** 2
    Q[12:15, 12:15] = I3 * (1e-4 * dt) ** 2
    return Q


def _imu_step(state: MsckfState, q, p, v, am, wm, dt):
    """One IMU sample: nominal integration + the 15x15 transition F."""
    w_hat = wm - state.bg
    a_hat = am - state.ba
    R = quat_to_rot(q)
    a_w = R @ a_hat + gravity(q.device)
    p_new = p + v * dt + 0.5 * a_w * dt * dt
    v_new = v + a_w * dt
    q_new = quat_normalize(quat_mult(q, small_quat(w_hat * dt)))
    I3 = _eye(3, q)
    F = _eye(15, q)
    F[0:3, 0:3] = I3 - skew(w_hat) * dt
    F[0:3, 9:12] = -I3 * dt
    F[3:6, 6:9] = I3 * dt
    F[6:9, 0:3] = -R @ skew(a_hat) * dt
    F[6:9, 12:15] = -R * dt
    return q_new, p_new, v_new, F


def propagate(state: MsckfState, accel: torch.Tensor, gyro: torch.Tensor,
              dt, sigma_a: float = 0.08,
              sigma_g: float = 0.004) -> MsckfState:
    """Propagate nominal state + covariance through IMU samples.
    accel/gyro: (K,3) body-frame measurements at interval dt."""
    q, p, v, P = state.q, state.p, state.v, state.P
    Q = _noise(dt, sigma_a, sigma_g, P)
    for k in range(accel.shape[0]):
        q, p, v, F = _imu_step(state, q, p, v, accel[k], gyro[k], dt)
        Pii = P[:15, :15]
        Pic = P[:15, 15:]
        Pii_new = mb.matmul(mb.matmul(F, Pii), mb.transpose(F)) + Q
        Pic_new = mb.matmul(F, Pic)
        P = P.clone()
        P[:15, :15] = 0.5 * (Pii_new + Pii_new.T)
        P[:15, 15:] = Pic_new
        P[15:, :15] = Pic_new.T
    return state._replace(q=q, p=p, v=v, P=P)


def propagate_terms(state: MsckfState, accel: torch.Tensor,
                    gyro: torch.Tensor, dt, sigma_a: float = 0.08,
                    sigma_g: float = 0.004):
    """Nominal integration + per-sample transitions, without touching P:
    returns (q, p, v, F_seq (K,15,15), Q (15,15)) for the fused
    covariance kernel (``kernels.cov_update``)."""
    q, p, v = state.q, state.p, state.v
    Fs = []
    for k in range(accel.shape[0]):
        q, p, v, F = _imu_step(state, q, p, v, accel[k], gyro[k], dt)
        Fs.append(F)
    return q, p, v, torch.stack(Fs), _noise(dt, sigma_a, sigma_g, state.P)


def augment(state: MsckfState) -> MsckfState:
    """Clone the current pose into the sliding window (shift-out oldest)."""
    W = state.clones_q.shape[0]
    clones_q = torch.cat([state.clones_q[1:], state.q[None]], dim=0)
    clones_p = torch.cat([state.clones_p[1:], state.p[None]], dim=0)
    d = 15 + 6 * W
    J = torch.zeros((6, d), device=state.P.device)
    J[0:3, 0:3] = _eye(3, J)
    J[3:6, 3:6] = _eye(3, J)
    keep = torch.cat([torch.arange(15), torch.arange(21, d),
                      torch.arange(15, 21)]).to(state.P.device)
    P_shift = state.P[keep][:, keep]      # oldest clone rows/cols at the end
    PJ = mb.matmul(P_shift, mb.transpose(J))          # (d,6)
    JPJ = mb.matmul(J, PJ)                            # (6,6)
    P_new = P_shift.clone()
    P_new[:, d - 6:] = PJ
    P_new[d - 6:, :] = PJ.T
    P_new[d - 6:, d - 6:] = JPJ
    return state._replace(clones_q=clones_q, clones_p=clones_p,
                          n_clones=torch.clamp(state.n_clones + 1, max=W),
                          P=P_new)


# --------------------------------------------------------------------------
# feature update
# --------------------------------------------------------------------------

def _to_camera(pw, R, clones_p):
    """Features pw (F,3) in every clone's camera frame (R (W,3,3)):
    (F,W,3)."""
    return torch.einsum("wji,fwj->fwi", R, pw[:, None, :] - clones_p[None])


def _project(pw, R, clones_p, fx, fy, cx, cy):
    """Camera-frame point, prediction and d(pred)/d(pc) for features pw
    (F,3) seen from every clone, depth clamped at 0.3."""
    pc = _to_camera(pw, R, clones_p)
    z = torch.clamp(pc[..., 2], min=0.3)
    pred = torch.stack([fx * pc[..., 0] / z + cx,
                        fy * pc[..., 1] / z + cy], dim=-1)
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([fx / z, zero, -fx * pc[..., 0] / z ** 2], -1),
        torch.stack([zero, fy / z, -fy * pc[..., 1] / z ** 2], -1)], dim=-2)
    return pc, pred, J_proj


def triangulate(obs_uv: torch.Tensor, obs_valid: torch.Tensor, clones_q,
                clones_p, fx: float, fy: float, cx: float, cy: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear triangulation + 5 Gauss-Newton steps of F features from
    their windowed observations. obs_uv: (F,W,2). Returns pw (F,3) and
    ok (F,)."""
    R = quat_to_rot(clones_q)                                # (W,3,3)
    d_c = torch.stack([(obs_uv[..., 0] - cx) / fx,
                       (obs_uv[..., 1] - cy) / fy,
                       torch.ones_like(obs_uv[..., 0])], dim=-1)  # (F,W,3)
    d_w = torch.einsum("wij,fwj->fwi", R, d_c)
    rays = d_w / torch.clamp(torch.linalg.vector_norm(d_w, dim=-1,
                                                      keepdim=True), min=1e-9)
    I3 = _eye(3, obs_uv)
    Pm = I3 - rays[..., :, None] * rays[..., None, :]        # (F,W,3,3)
    w = obs_valid.float()
    A = (w[..., None, None] * Pm).sum(1)
    b = (w[..., None] * torch.einsum("fwij,wj->fwi", Pm, clones_p)).sum(1)
    n_obs = obs_valid.sum(1)
    reg = 1e-9 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) + 1e-9
    pw = mb.solve_spd(A + reg[:, None, None] * I3, b[..., None])[..., 0]

    # Gauss-Newton refinement on reprojection error
    Rt = R.mT
    F = obs_uv.shape[0]
    for _ in range(5):
        _, pred, Jp = _project(pw, R, clones_p, fx, fy, cx, cy)
        r = (obs_uv - pred) * w[..., None]                   # (F,W,2)
        J = (Jp @ Rt[None]) * w[..., None, None]             # (F,W,2,3)
        Jf = J.reshape(F, -1, 3)
        H = Jf.mT @ Jf + 1e-4 * I3
        g = Jf.mT @ r.reshape(F, -1, 1)
        pw = pw + mb.solve_spd(H, g)[..., 0]

    # sanity gating: enough parallax-bearing obs, point in front of every
    # observing camera, finite
    pc = _to_camera(pw, R, clones_p)
    depths = torch.where(obs_valid, pc[..., 2], 1.0)
    nz = torch.clamp(n_obs, min=1)
    centroid = (clones_p[None] * w[..., None]).sum(1) / nz[:, None]
    spread = torch.sqrt(((clones_p[None] - centroid[:, None]) ** 2
                         ).sum(-1).mul(w).sum(1) / nz)
    mean_depth = torch.where(obs_valid, depths, 0.0).sum(1) / nz
    parallax = spread / torch.clamp(mean_depth, min=1e-3)
    ok = ((n_obs >= 3) & (depths > 0.4).all(1)
          & torch.isfinite(pw).all(1)
          & (torch.linalg.vector_norm(pw, dim=-1) < 1e3)
          & (parallax > 0.02))
    return pw, ok


def feature_jacobians(pw, clones_q, clones_p, obs_uv, obs_valid,
                      fx, fy, cx, cy):
    """Residuals + Jacobians of F features over the window.
    Returns r (F,2W), Hx (F,2W,6W) w.r.t clone errors, Hf (F,2W,3)."""
    F, W = obs_uv.shape[:2]
    R = quat_to_rot(clones_q)
    Rt = R.mT
    pc, pred, J_proj = _project(pw, R, clones_p, fx, fy, cx, cy)
    w = obs_valid.float()
    r = ((obs_uv - pred) * w[..., None]).reshape(F, 2 * W)
    wm = w[..., None, None]
    H_theta = (J_proj @ skew(pc)) * wm               # clone rotation err
    H_p = (-J_proj @ Rt[None]) * wm                  # clone position err
    H_f = (J_proj @ Rt[None]) * wm                   # feature position
    blocks = torch.cat([H_theta, H_p], dim=-1)       # (F,W,2,6)
    Hx = torch.zeros((F, W, 2, W, 6), device=pw.device)
    ar = torch.arange(W, device=pw.device)
    Hx[:, ar, :, ar, :] = blocks.permute(1, 0, 2, 3)
    return r, Hx.reshape(F, 2 * W, 6 * W), H_f.reshape(F, 2 * W, 3)


def nullspace_project(r, Hx, Hf):
    """Project out the feature Jacobian: A^T r, A^T Hx where A spans the
    left nullspace of Hf (QR-based, the MSCKF trick)."""
    n = Hf.shape[-2]
    eye = _eye(n, Hf).expand(Hf.shape[:-2] + (n, n))
    q_full, _ = mb.qr(torch.cat([Hf, eye], dim=-1))
    A = q_full[..., 3:]                  # (.., 2W, 2W-3) nullspace basis
    return (A.mT @ r[..., None])[..., 0], A.mT @ Hx


def update_residuals(state: MsckfState, tracks_uv: torch.Tensor,
                     tracks_valid: torch.Tensor, fx: float, fy: float,
                     cx: float, cy: float):
    """Stacked nullspace-projected residuals (m,) and Jacobian (m, d)
    from F feature tracks (F, W, 2)."""
    W = state.clones_q.shape[0]
    d = 15 + 6 * W
    pw, ok = triangulate(tracks_uv, tracks_valid, state.clones_q,
                         state.clones_p, fx, fy, cx, cy)
    r, Hx, Hf = feature_jacobians(pw, state.clones_q, state.clones_p,
                                  tracks_uv, tracks_valid, fx, fy, cx, cy)
    # any wild raw residual kills the whole feature (outlier rejection)
    ok = ok & (r.abs().amax(-1) < 20.0)
    r0, H0 = nullspace_project(r, Hx, Hf)
    okf = ok.float()
    r_all = r0 * okf[:, None]
    H_all = H0 * okf[:, None, None]
    m = r_all.numel()
    H_stack = torch.zeros((m, d), device=r_all.device)
    H_stack[:, 15:] = H_all.reshape(m, 6 * W)
    return r_all.reshape(m), H_stack


def apply_gain(state: MsckfState, r_stack: torch.Tensor,
               H_stack: torch.Tensor, K: torch.Tensor,
               sigma_px: float = 1.0):
    """Apply a Kalman gain K (d, m) with the Joseph-form covariance
    update."""
    d = state.P.shape[0]
    dx = K @ r_stack
    ikh = _eye(d, K) - mb.matmul(K, H_stack)
    P_new = mb.matmul(mb.matmul(ikh, state.P), mb.transpose(ikh)) \
        + (sigma_px ** 2) * mb.matmul(K, mb.transpose(K))
    P_new = 0.5 * (P_new + P_new.T)
    new_state = apply_correction(state, dx)._replace(P=P_new)
    return new_state, torch.linalg.vector_norm(dx[:15])


def update(state: MsckfState, tracks_uv: torch.Tensor,
           tracks_valid: torch.Tensor, fx: float, fy: float, cx: float,
           cy: float, sigma_px: float = 1.0):
    """MSCKF update from F feature tracks (F, W, 2)."""
    r_stack, H_stack = update_residuals(state, tracks_uv, tracks_valid,
                                        fx, fy, cx, cy)
    K = mb.kalman_gain(state.P, H_stack, sigma_px ** 2)   # (d, m)
    return apply_gain(state, r_stack, H_stack, K, sigma_px)


def apply_correction(state: MsckfState, dx: torch.Tensor) -> MsckfState:
    W = state.clones_q.shape[0]
    q = quat_normalize(quat_mult(state.q, small_quat(dx[0:3])))
    dc = dx[15:].reshape(W, 6)
    return state._replace(
        q=q, p=state.p + dx[3:6], v=state.v + dx[6:9],
        bg=state.bg + dx[9:12], ba=state.ba + dx[12:15],
        clones_q=quat_normalize(quat_mult(state.clones_q,
                                          small_quat(dc[:, :3]))),
        clones_p=state.clones_p + dc[:, 3:6])
