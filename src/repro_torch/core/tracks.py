"""Fixed-shape feature-track ring buffer — the FPGA track-SRAM analogue.

One slot per feature-budget entry, each holding W (u,v) observations
across the MSCKF window plus a validity mask. All operations are
fixed-shape tensor code, so the per-frame bookkeeping stays on the
device:

  roll_and_update   shift the window, continue tracks via LK matches,
                    reseed dead slots from fresh detections
  select_consumed   pick the <= max_updates tracks consumed this frame
                    (ended with enough observations, or full-window)
                    into fixed-size update buffers
  consume           one-shot semantics: clear the history of consumed
                    tracks so each observation feeds the filter once
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# update-batch budget: at most this many tracks are consumed per frame
MAX_UPDATES = 24
# a track must span at least this many frames to constrain the filter
MIN_TRACK_OBS = 4
# skip the MSCKF update unless at least this many tracks are consumed
MIN_UPDATE_TRACKS = 4


class TrackCarry(NamedTuple):
    uv: torch.Tensor     # (N, W, 2) float32 uv observations across the window
    valid: torch.Tensor  # (N, W) bool


def init_carry(n: int, window: int, device=None) -> TrackCarry:
    """Empty track buffer for one robot."""
    return TrackCarry(uv=torch.zeros((n, window, 2), device=device),
                      valid=torch.zeros((n, window), dtype=torch.bool,
                                        device=device))


def roll_and_update(tracks_uv: torch.Tensor, tracks_valid: torch.Tensor,
                    det_yx: torch.Tensor, det_valid: torch.Tensor,
                    tracked_yx: torch.Tensor, tracked_valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift the window left; continue tracks whose feature was re-found
    by LK, clear + reseed the rest from this frame's detections.
    det_yx/tracked_yx are (N,2) in (row, col) order; the buffer stores
    (u,v) = (col, row)."""
    uv = torch.cat([tracks_uv[:, 1:], torch.zeros_like(tracks_uv[:, :1])],
                   dim=1)
    vd = torch.cat([tracks_valid[:, 1:],
                    torch.zeros_like(tracks_valid[:, :1])], dim=1)

    # continued: LK found the feature AND the slot was alive last frame
    cont = tracked_valid & vd[:, -2]
    dead = ~cont
    uv = torch.where(dead[:, None, None], 0.0, uv)
    vd = torch.where(dead[:, None], False, vd)

    tracked_uv = torch.stack([tracked_yx[:, 1], tracked_yx[:, 0]],
                             dim=-1).float()
    det_uv = torch.stack([det_yx[:, 1], det_yx[:, 0]], dim=-1).float()
    uv[:, -1] = torch.where(cont[:, None], tracked_uv, det_uv)
    vd[:, -1] = torch.where(cont, True, det_valid)
    return uv, vd


def select_consumed(tracks_uv: torch.Tensor, tracks_valid: torch.Tensor,
                    max_updates: int = MAX_UPDATES):
    """Fixed-shape selection of the tracks consumed this frame.

    Returns (uv, valid, count, consumed_mask): the first max_updates
    consumed tracks padded with zeros, the number of real rows (a ()
    tensor), and the (N,) mask of selected slots."""
    obs_count = tracks_valid.sum(dim=1)
    ended = (~tracks_valid[:, -1]) & (obs_count >= MIN_TRACK_OBS)
    full = tracks_valid.all(dim=1)
    mask = ended | full
    rank = torch.cumsum(mask.long(), dim=0) - 1
    consumed = mask & (rank < max_updates)
    count = consumed.sum()

    # stable sort puts selected slots first in original order
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:max_updates]
    take = mask[order]
    uv = torch.where(take[:, None, None], tracks_uv[order], 0.0)
    vd = torch.where(take[:, None], tracks_valid[order], False)
    return uv, vd, count, consumed


def consume(tracks_valid: torch.Tensor, consumed: torch.Tensor
            ) -> torch.Tensor:
    """Clear all but the newest observation of consumed tracks."""
    W = tracks_valid.shape[1]
    clear = torch.arange(W, device=tracks_valid.device) < (W - 1)
    return torch.where(consumed[:, None] & clear[None, :], False,
                       tracks_valid)
