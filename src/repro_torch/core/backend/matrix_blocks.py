"""The five matrix building blocks (paper Tbl. I) shared by the backend:
multiplication, decomposition, inverse, transpose, fwd/bwd substitution.

Plain PyTorch here. ``repro`` sends these to its Pallas matmul/Cholesky
kernels only at 128-aligned shapes, which the EDX shapes are not
(d = 195, m = 1368), so there they stay XLA's; here they stay
``torch.matmul`` / ``torch.linalg``. All functions take leading batch
dimensions.

A failed Cholesky gives NaN, as ``jnp.linalg.cholesky`` does, instead
of raising: raising would need a device->host sync.
"""
from __future__ import annotations

from typing import Tuple

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def transpose(a: torch.Tensor) -> torch.Tensor:
    return a.mT


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where ``a`` is not positive definite."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l, float("nan"))


def tri_solve(l: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve l x = b (or l^T x = b with ``trans``) for triangular l."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=lower)
    return torch.linalg.solve_triangular(l, b, upper=not lower)


def solve_spd(s: torch.Tensor, b: torch.Tensor,
              jitter: float = 1e-8) -> torch.Tensor:
    """Solve S x = b for symmetric positive-definite S (Cholesky +
    forward + backward substitution)."""
    n = s.shape[-1]
    l = cholesky(s + jitter * torch.eye(n, dtype=s.dtype, device=s.device))
    y = tri_solve(l, b, lower=True)
    return tri_solve(l, y, lower=True, trans=True)


def inverse_spd(s: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Inverse of SPD matrices (batched over leading dims): ``solve_spd``
    against the identity."""
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    return solve_spd(s, eye.expand(s.shape), jitter)


def qr(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR (MSCKF nullspace projection)."""
    return torch.linalg.qr(a)


def kalman_gain(p: torch.Tensor, h: torch.Tensor,
                r_diag: float) -> torch.Tensor:
    """K from S = H P H^T + R; solve S K^T = H P^T."""
    ph_t = matmul(p, transpose(h))                     # (n, m)
    s = matmul(h, ph_t) + r_diag * torch.eye(h.shape[0], dtype=p.dtype,
                                             device=p.device)
    kt = solve_spd(s, transpose(ph_t))                 # (m, n)
    return transpose(kt)
