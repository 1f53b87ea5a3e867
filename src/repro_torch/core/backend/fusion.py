"""GPS fusion (VIO mode): loosely-coupled position EKF.

The GPS position observation updates the MSCKF state directly through
the shared Kalman-gain block (H selects the position rows).
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import matrix_blocks as mb
from repro_torch.core.backend.msckf import MsckfState, apply_correction


def gps_update(state: MsckfState, gps_pos: torch.Tensor,
               sigma_gps: float = 0.05):
    """Fuse a GPS position fix (world frame). NaN-safe: an invalid fix
    (any NaN) gets zero weight, without a host branch."""
    d = state.P.shape[0]
    dev = state.P.device
    valid = torch.isfinite(gps_pos).all()
    gps_safe = torch.where(valid, gps_pos, state.p)

    H = torch.zeros((3, d), device=dev)
    H[:, 3:6] = torch.eye(3, device=dev)
    r = gps_safe - state.p
    K = mb.kalman_gain(state.P, H, sigma_gps ** 2)
    w = valid.float()
    dx = (K @ r) * w
    ikh = torch.eye(d, device=dev) - w * mb.matmul(K, H)
    P_new = mb.matmul(mb.matmul(ikh, state.P), mb.transpose(ikh)) \
        + w * (sigma_gps ** 2) * mb.matmul(K, mb.transpose(K))
    P_new = 0.5 * (P_new + P_new.T)
    return (apply_correction(state, dx)._replace(P=P_new),
            torch.linalg.vector_norm(dx[3:6]))
