"""Fused IMU covariance sweep: propagate x K + clone augment on P.

The CUDA counterpart of ``repro/kernels/cov_update.py`` (kernel in
``csrc/cov_update.cu``): one CTA holds the whole error covariance in
shared memory, applies the K sequential IMU transitions on its 15-row
block (gated by ``do_prop``: frame 0 skips propagation but still
augments), then writes the clone-permuted, clone-inserted P back once.

``update_ref`` is the plain PyTorch version (the same math as
propagate-then-augment on P). ``fused_update`` takes it for a CPU
tensor, and for a CUDA tensor launches the kernel or raises;
``LAUNCHES["cov"]`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"cov": 0}

# shared memory one block may use on Hopper
SMEM_LIMIT = 232448


def _propagate_P(P, F, Q):
    """One sample's covariance transition on the IMU block."""
    Pii = P[:15, :15]
    Pic = P[:15, 15:]
    Pii_new = F @ Pii @ F.T + Q
    Pic_new = F @ Pic
    P = P.clone()
    P[:15, :15] = 0.5 * (Pii_new + Pii_new.T)
    P[:15, 15:] = Pic_new
    P[15:, :15] = Pic_new.T
    return P


def _augment_P(P):
    """Clone-window permutation + new-clone row/col insertion (P·Jᵀ is
    P's first 6 columns)."""
    d = P.shape[0]
    rows = torch.cat([P[:15], P[21:], P[15:21]], dim=0)
    P_shift = torch.cat([rows[:, :15], rows[:, 21:], rows[:, 15:21]], dim=1)
    PJ = P_shift[:, :6]                               # (d, 6)
    JPJ = PJ[:6, :]                                   # (6, 6)
    P_new = P_shift.clone()
    P_new[:, d - 6:] = PJ
    P_new[d - 6:, :] = PJ.T
    P_new[d - 6:, d - 6:] = JPJ
    return P_new


def update_ref(P: torch.Tensor, F_seq: torch.Tensor, Q: torch.Tensor,
               do_prop: torch.Tensor) -> torch.Tensor:
    """Plain version: P (d,d), F_seq (K,15,15), Q (15,15), do_prop ()
    bool/int tensor -> augmented post-propagation covariance (d,d)."""
    P_prop = P
    for k in range(F_seq.shape[0]):
        P_prop = _propagate_P(P_prop, F_seq[k], Q)
    return _augment_P(torch.where(torch.as_tensor(do_prop) > 0, P_prop, P))


def fused_update(P: torch.Tensor, F_seq: torch.Tensor, Q: torch.Tensor,
                 do_prop: torch.Tensor) -> torch.Tensor:
    if P.device.type == "cpu":
        return update_ref(P, F_seq, Q, do_prop)
    d = P.shape[0]
    K = F_seq.shape[0]
    for t, name, shape in ((P, "P", (d, d)), (F_seq, "F_seq", (K, 15, 15)),
                           (Q, "Q", (15, 15))):
        if t.device != P.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {P.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    if d < 21:
        raise ValueError(f"P must hold at least one clone (d >= 21), got {d}")
    lib = _build.lib()
    smem = lib.cov_update_smem_bytes(d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"cov_update keeps P in shared memory: d={d} needs "
                         f"{smem} B, above the {SMEM_LIMIT} B a block has")
    gate = torch.as_tensor(do_prop, device=P.device).to(torch.int32
                                                         ).reshape(1)
    out = torch.empty_like(P)
    err = lib.cov_update_launch(
        _build.ptr(P), _build.ptr(F_seq), _build.ptr(Q), _build.ptr(gate),
        d, K, _build.ptr(out), _build.stream())
    _build.check(err, "cov_update")
    LAUNCHES["cov"] += 1
    return out
