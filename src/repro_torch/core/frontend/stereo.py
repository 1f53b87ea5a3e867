"""Stereo matching: MO (hamming matching) + DR (block-matching refinement).

MO compares ORB descriptors between left/right features under the
epipolar constraint (same row +- tolerance, disparity in [0, max_disp]).
DR refines the matched disparity by SAD block matching around the match
plus parabolic sub-pixel interpolation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9


class StereoMatches(NamedTuple):
    right_idx: torch.Tensor    # (NL,) int32: matched right feature per left
    disparity: torch.Tensor    # (NL,) float32 refined disparity (px)
    valid: torch.Tensor        # (NL,) bool


def hamming_matrix(dl: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """(NL,256)x(NR,256) bool -> (NL,NR) float32 hamming distances
    (XOR-popcount as dot products on {0,1}; exact in fp32)."""
    a = dl.float()
    b = dr.float()
    return a @ (1 - b).T + (1 - a) @ b.T


def match(dl, yxl, vl, dr_, yxr, vr, *, max_disparity: int = 96,
          row_tol: int = 2, hamming_budget: int = 64) -> StereoMatches:
    dist = hamming_matrix(dl, dr_)                        # (NL,NR)
    rowdiff = (yxl[:, None, 0] - yxr[None, :, 0]).abs()
    disp = yxl[:, None, 1] - yxr[None, :, 1]              # left x - right x
    ok = ((rowdiff <= row_tol) & (disp >= 0) & (disp <= max_disparity)
          & vl[:, None] & vr[None, :])
    dist = torch.where(ok, dist, BIG)
    right_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, right_idx[:, None])[:, 0]
    valid = best <= hamming_budget
    disparity = torch.gather(disp.float(), 1, right_idx[:, None])[:, 0]
    return StereoMatches(right_idx=right_idx.to(torch.int32),
                         disparity=torch.clamp(disparity, min=0.0),
                         valid=valid)


def refine(img_l: torch.Tensor, img_r: torch.Tensor, yxl: torch.Tensor,
           matches: StereoMatches, *, radius: int = 5,
           window: int = 9) -> StereoMatches:
    """DR: SAD search of +-radius around the matched disparity, sub-pixel
    parabola fit on the SAD minimum."""
    w = window // 2
    il = img_l.float()
    ir = img_r.float()
    H, W = il.shape
    dev = il.device
    g = torch.arange(-w, w + 1, device=dev)
    dy = g[:, None].expand(window, window).reshape(-1)     # mgrid order
    dx = g[None, :].expand(window, window).reshape(-1)
    offsets = torch.arange(-radius, radius + 1, device=dev)

    y = yxl[:, 0].long()
    xl = yxl[:, 1].long()
    xr0 = xl - matches.disparity.to(torch.int32).long()
    rows = torch.clamp(y[:, None] + dy[None], 0, H - 1)           # (N,81)
    pl = il[rows, torch.clamp(xl[:, None] + dx[None], 0, W - 1)]  # (N,81)
    xr = xr0[:, None, None] + offsets[None, :, None] + dx[None, None, :]
    pr = ir[rows[:, None, :], torch.clamp(xr, 0, W - 1)]          # (N,11,81)
    sads = (pl[:, None, :] - pr).abs().sum(-1)                    # (N,11)

    j = torch.argmin(sads, dim=1)
    jc = torch.clamp(j, 1, sads.shape[1] - 2)
    s_m = torch.gather(sads, 1, (jc - 1)[:, None])[:, 0]
    s_0 = torch.gather(sads, 1, jc[:, None])[:, 0]
    s_p = torch.gather(sads, 1, (jc + 1)[:, None])[:, 0]
    denom = s_m - 2 * s_0 + s_p
    sub = torch.where(denom.abs() > 1e-6,
                      0.5 * (s_m - s_p) / torch.clamp(denom, min=1e-6), 0.0)
    # right x moved by offset => disparity shrinks by the same amount
    d_ref = matches.disparity - (offsets[jc].float()
                                 + torch.clamp(sub, -1, 1))
    d_ref = torch.where(matches.valid, torch.clamp(d_ref, min=0.1), 0.0)
    return StereoMatches(right_idx=matches.right_idx, disparity=d_ref,
                         valid=matches.valid & (d_ref > 0))
