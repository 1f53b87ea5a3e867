"""Image filtering (the frontend's IF task): separable Gaussian + Sobel.

Written as explicit shifted-slice sums in ``repro``'s tap order (not as
``F.conv2d``), so the blur is bitwise equal to ``repro``'s and to the
CUDA kernel A that replaces it on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def gaussian_taps(sigma: float, radius: int = 0):
    r = radius or max(1, int(3 * sigma + 0.5))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple((k / k.sum()).tolist())


def edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices ``-lo .. n+hi-1`` clamped into ``[0, n)``: edge padding as
    a gather."""
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def _conv1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Same-size 1D convolution along axis with edge padding, summed in
    tap order from zero."""
    axis = axis % img.dim()
    r = len(taps) // 2
    n = img.shape[axis]
    p = img.float().index_select(axis, edge_index(n, r, r, img.device))
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i, t in enumerate(taps):
        out = out + p.narrow(axis, i, n) * t
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    taps = gaussian_taps(sigma)
    return _conv1d(_conv1d(img, taps, -2), taps, -1)


def sobel(img: torch.Tensor):
    """Returns (gx, gy) image gradients (float32)."""
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = _conv1d(_conv1d(img, smooth, -2), diff, -1) / 8.0
    gy = _conv1d(_conv1d(img, diff, -2), smooth, -1) / 8.0
    return gx, gy


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimation (pyramid level)."""
    b = gaussian_blur(img, 1.0)
    return b[..., ::2, ::2]
