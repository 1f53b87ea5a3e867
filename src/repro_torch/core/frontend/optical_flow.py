"""Pyramidal Lucas-Kanade temporal matching (the frontend's DC+LSS tasks).

Tracks feature points from frame t-1 to frame t: per level, iterate the
2x2 least-squares flow update over an 11x11 window (derivatives from
Sobel, bilinear sampling for sub-pixel warps). All features move
together along a leading batch dimension.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.core.frontend import filters
from repro_torch.core.frontend.orb import _bilinear


class FlowResult(NamedTuple):
    yx: torch.Tensor     # (N,2) float32 tracked positions in frame t
    valid: torch.Tensor  # (N,) bool


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = [img.float()]
    for _ in range(levels - 1):
        pyr.append(filters.downsample2(pyr[-1]))
    return pyr


def _window(w: int, device):
    """(dy, dx) offsets of a (2w+1)^2 window, row-major (np.mgrid order)."""
    g = torch.arange(-w, w + 1, device=device, dtype=torch.float32)
    n = 2 * w + 1
    return (g[:, None].expand(n, n).reshape(-1),
            g[None, :].expand(n, n).reshape(-1))


def _track_level(img0, img1, gx, gy, p0, p1, *, window: int, iters: int):
    """One pyramid level of LK. p0: source positions, p1: current guesses."""
    dyf, dxf = _window(window // 2, img0.device)
    ys = p0[:, 0:1] + dyf[None]
    xs = p0[:, 1:2] + dxf[None]
    i0 = _bilinear(img0, ys, xs)
    ix = _bilinear(gx, ys, xs)
    iy = _bilinear(gy, ys, xs)
    gxx = (ix * ix).sum(-1)
    gxy = (ix * iy).sum(-1)
    gyy = (iy * iy).sum(-1)
    det = gxx * gyy - gxy * gxy
    det_c = torch.clamp(det, min=1e-6)

    p = p1
    for _ in range(iters):
        i1 = _bilinear(img1, p[:, 0:1] + dyf[None], p[:, 1:2] + dxf[None])
        it = i1 - i0
        bx = (it * ix).sum(-1)
        by = (it * iy).sum(-1)
        # solve [gxx gxy; gxy gyy] d = -[bx; by]
        ddx = (-bx * gyy + by * gxy) / det_c
        ddy = (-by * gxx + bx * gxy) / det_c
        p = p + torch.stack([ddy, ddx], dim=-1)
    ok = det > 1e-4
    return torch.where(ok[:, None], p, p1), ok


def track(img_prev: torch.Tensor, img_next: torch.Tensor,
          yx_prev: torch.Tensor, valid: torch.Tensor, *, levels: int = 3,
          window: int = 11, iters: int = 10,
          max_residual: float = 12.0) -> FlowResult:
    """Track yx_prev (N,2 int/float) from img_prev into img_next."""
    pyr0 = build_pyramid(img_prev, levels)
    pyr1 = build_pyramid(img_next, levels)
    p = yx_prev.float() / (2 ** (levels - 1))
    ok_all = valid
    for lv in range(levels - 1, -1, -1):
        img0, img1 = pyr0[lv], pyr1[lv]
        gx, gy = filters.sobel(img0)
        p_src = yx_prev.float() / (2 ** lv)
        p, ok = _track_level(img0, img1, gx, gy, p_src, p,
                             window=window, iters=iters)
        ok_all = ok_all & ok
        if lv > 0:
            p = p * 2.0
    # forward-track residual check: appearance difference at the result
    dyf, dxf = _window(2, img_prev.device)
    p_old = yx_prev.float()
    a = _bilinear(pyr0[0], p_old[:, 0:1] + dyf[None], p_old[:, 1:2] + dxf[None])
    b = _bilinear(pyr1[0], p[:, 0:1] + dyf[None], p[:, 1:2] + dxf[None])
    res = (a - b).abs().mean(-1)
    H, W = img_next.shape
    inside = ((p[:, 0] >= 1) & (p[:, 0] < H - 2) &
              (p[:, 1] >= 1) & (p[:, 1] < W - 2))
    return FlowResult(yx=p, valid=ok_all & inside & (res < max_residual))
