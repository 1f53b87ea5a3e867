"""FAST-9 corner detection (the frontend's FD task) + grid NMS.

Fixed-shape, mask-based: the feature list is a static ``max_features``
buffer with a validity mask. The ring score is summed in ring order and
the top-K over cell maxima is a stable descending sort, so ties (most
cells score 0) resolve lower index first, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.frontend.filters import edge_index

# Bresenham circle of radius 3 (standard FAST-16 ring, clockwise).
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

# the descriptor patch must fit: corners this close to the border score 0
MARGIN = 16


class Features(NamedTuple):
    yx: torch.Tensor       # (N, 2) int32 row, col
    score: torch.Tensor    # (N,) float32 corner score
    valid: torch.Tensor    # (N,) bool


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W): ring pixel intensities around each pixel (edge-padded)."""
    H, W = img.shape
    p = img[edge_index(H, 3, 3, img.device)][:, edge_index(W, 3, 3,
                                                          img.device)]
    return torch.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dy, dx in CIRCLE])


def _has_arc(flags: torch.Tensor, arc_len: int) -> torch.Tensor:
    """Contiguous run of ``arc_len`` set flags around the 16-ring."""
    out = torch.zeros(flags.shape[1:], dtype=torch.bool, device=flags.device)
    for start in range(16):
        run = flags[start % 16]
        for j in range(1, arc_len):
            run = run & flags[(start + j) % 16]
        out = out | run
    return out


def fast_score(img: torch.Tensor, threshold: float,
               arc_len: int = 9) -> torch.Tensor:
    """Per-pixel FAST corner score (0 where not a corner, and within
    ``MARGIN`` px of the border). Score = sum of |diff|-t over the
    qualifying polarity, accumulated in ring order."""
    img = img.float()
    diff = _ring_stack(img) - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    corner_b = _has_arc(brighter, arc_len)
    corner_d = _has_arc(darker, arc_len)
    excess = diff.abs() - threshold
    sb = torch.zeros_like(img)
    sd = torch.zeros_like(img)
    for k in range(16):
        sb = sb + torch.where(brighter[k], excess[k], 0.0)
        sd = sd + torch.where(darker[k], excess[k], 0.0)
    score = torch.where(corner_b, sb, 0.0) + torch.where(corner_d, sd, 0.0)
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = ((yy >= MARGIN) & (yy < H - MARGIN) &
              (xx >= MARGIN) & (xx < W - MARGIN))
    return torch.where(inside, score, 0.0)


def cell_max(score: torch.Tensor, cell: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell maximum and its in-cell index (row-major within the
    cell, first maximum wins): (Hc, Wc) float32, (Hc, Wc) int32."""
    H, W = score.shape
    Hc, Wc = H // cell, W // cell
    s = score[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell)
    s = s.permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    idx = torch.argmax(s, dim=1)
    best = torch.gather(s, 1, idx[:, None])[:, 0]
    return best.reshape(Hc, Wc), idx.to(torch.int32).reshape(Hc, Wc)


def topk_cells(best: torch.Tensor, idx: torch.Tensor, max_features: int,
               cell: int = 8) -> Features:
    """The strongest ``max_features`` cells (stable descending sort:
    equal scores keep cell order), padded to the fixed budget."""
    Hc, Wc = best.shape
    bestf = best.reshape(Hc * Wc)
    idxf = idx.reshape(Hc * Wc).long()
    ar = torch.arange(Hc * Wc, device=best.device)
    cy = ar // Wc * cell + idxf // cell
    cx = ar % Wc * cell + idxf % cell
    k = min(max_features, Hc * Wc)
    srt = torch.sort(bestf, descending=True, stable=True)
    top_score, top_i = srt.values[:k], srt.indices[:k]
    yx = torch.stack([cy[top_i], cx[top_i]], dim=1).to(torch.int32)
    valid = top_score > 0
    if k < max_features:                     # pad to fixed budget
        pad = max_features - k
        yx = torch.cat([yx, yx.new_zeros((pad, 2))])
        top_score = torch.cat([top_score, top_score.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return Features(yx=yx, score=top_score, valid=valid)


def grid_nms_topk(score: torch.Tensor, max_features: int,
                  cell: int = 8) -> Features:
    """Non-max suppression on a cell grid, then global top-K."""
    best, idx = cell_max(score, cell)
    return topk_cells(best, idx, max_features, cell)


def detect(img: torch.Tensor, threshold: float = 20.0,
           max_features: int = 512, nms_cell: int = 8,
           arc_len: int = 9) -> Features:
    return grid_nms_topk(fast_score(img, threshold, arc_len),
                         max_features, nms_cell)
