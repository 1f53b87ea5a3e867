"""rBRIEF / ORB descriptors (the frontend's FC task).

256 point-pair intensity comparisons on a Gaussian-smoothed patch,
rotated by the intensity-centroid orientation. The sampling pattern is
``repro``'s table, drawn from the same seeded generator. The
orientation moments are summed over the disc in table order, one term
at a time, so that kernel B on the card can repeat the sum exactly.

Packed descriptors are carried as int32 bit patterns (bit j of word w is
``desc[32w + j]``): ``torch.uint32`` has little op support.
"""
from __future__ import annotations

import numpy as np
import torch

N_BITS = 256
PATCH_R = 15        # 31x31 patch

_rng = np.random.RandomState(1234)
# BRIEF pattern: gaussian-distributed pairs clipped to the patch
PAIRS = np.clip(_rng.randn(N_BITS, 4) * PATCH_R / 2.5, -PATCH_R, PATCH_R
                ).astype(np.float32)   # (256, [y1,x1,y2,x2])


def _bilinear(img: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample; y/x float tensors (clipped to the valid range)."""
    H, W = img.shape
    y = torch.clamp(y, 0.0, H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    dy = y - y0.float()
    dx = x - x0.float()
    flat = img.reshape(-1)
    base = y0 * W + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + W]
    v11 = flat[base + W + 1]
    return (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx
            + v10 * dy * (1 - dx) + v11 * dy * dx)


def circle_offsets() -> tuple:
    """The intensity-centroid sampling disc (r=7, 149 points) as host
    tables."""
    r = 7
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    circle = (dy ** 2 + dx ** 2) <= r ** 2
    return (np.asarray(dy[circle], np.float32),
            np.asarray(dx[circle], np.float32))


def orientation_t(img: torch.Tensor, yx: torch.Tensor, dy: torch.Tensor,
                  dx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per feature with the disc tables passed
    in. yx (N,2) int32 -> (N,) radians."""
    ys = yx[:, 0:1].float() + dy[None]
    xs = yx[:, 1:2].float() + dx[None]
    v = _bilinear(img, ys, xs)                       # (N, 149)
    p01 = v * dy[None]
    p10 = v * dx[None]
    m01 = torch.zeros(yx.shape[0], dtype=torch.float32, device=img.device)
    m10 = torch.zeros_like(m01)
    for k in range(dy.shape[0]):                     # table order
        m01 = m01 + p01[:, k]
        m10 = m10 + p10[:, k]
    return torch.atan2(m01, m10)


def orientation(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    dy, dx = circle_offsets()
    return orientation_t(img, yx, torch.as_tensor(dy, device=img.device),
                         torch.as_tensor(dx, device=img.device))


def describe_t(img: torch.Tensor, yx: torch.Tensor, angles: torch.Tensor,
               pairs: torch.Tensor) -> torch.Tensor:
    """``describe`` with the (256,4) BRIEF pattern passed in."""
    img = img.float()
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]
    y1 = pairs[None, :, 0] * c - pairs[None, :, 1] * s
    x1 = pairs[None, :, 0] * s + pairs[None, :, 1] * c
    y2 = pairs[None, :, 2] * c - pairs[None, :, 3] * s
    x2 = pairs[None, :, 2] * s + pairs[None, :, 3] * c
    py = yx[:, 0:1].float()
    px = yx[:, 1:2].float()
    v1 = _bilinear(img, py + y1, px + x1)
    v2 = _bilinear(img, py + y2, px + x2)
    return v1 < v2


def describe(img: torch.Tensor, yx: torch.Tensor,
             angles: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool rBRIEF descriptors (img should be pre-smoothed)."""
    return describe_t(img, yx, angles,
                      torch.as_tensor(PAIRS, device=img.device))


def pack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N,256) bool -> (N,8) int32 bit patterns of the uint32 words."""
    n = desc.shape[0]
    d = desc.reshape(n, 8, 32).long()
    weights = torch.ones(32, dtype=torch.long, device=desc.device) \
        << torch.arange(32, device=desc.device)
    words = (d * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)

