"""Frontend task graph (paper Fig. 12).

    IF (image filter) ─┬─> FC (descriptors) ──> MO ─> DR   (stereo match)
    FD (FAST detect)  ─┘                      (needs L+R)
    IF(left) ─> DC ─> LSS                     (temporal match, L only)

``run_frontend`` takes the FE+MO slice through ``kernels.frontend_fused``
(kernels A, B, C on the card; their plain versions on the CPU), then DR
refinement and LK tracking. ``_fe_match_ref`` is the unfused
composition of the same slice, kept as the reference the fused path is
tested against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.frontend import fast, filters, optical_flow, orb, stereo
from repro_torch.kernels import frontend_fused


class FrontendResult(NamedTuple):
    yx: torch.Tensor            # (N,2) int32 left-image feature positions
    score: torch.Tensor         # (N,) float32
    valid: torch.Tensor         # (N,) bool
    desc: torch.Tensor          # (N,256) bool ORB descriptors (left)
    disparity: torch.Tensor     # (N,) float32 stereo disparity
    stereo_valid: torch.Tensor  # (N,) bool
    prev_yx: torch.Tensor       # (N,2) float32 tracked position of PREVIOUS
    track_valid: torch.Tensor   # (N,) bool      frame's features in this frame


def feature_extraction(img: torch.Tensor, cfg) -> tuple:
    """FE block = IF + FD + FC on one image."""
    smooth = filters.gaussian_blur(img, cfg.gaussian_sigma)     # IF
    feats = fast.detect(img, cfg.fast_threshold, cfg.max_features,
                        cfg.nms_window, cfg.fast_arc_len)       # FD
    ang = orb.orientation(smooth, feats.yx)
    desc = orb.describe(smooth, feats.yx, ang)                  # FC
    return feats, desc


def _fe_match_ref(img_l: torch.Tensor, img_r: torch.Tensor, cfg):
    """Unfused FE + MO slice: the reference composition of the fused
    kernels. Returns (fl, fr, dl, matches)."""
    fl, dl = feature_extraction(img_l.float(), cfg)
    fr, dr_ = feature_extraction(img_r.float(), cfg)
    m = stereo.match(dl, fl.yx, fl.valid, dr_, fr.yx, fr.valid,
                     max_disparity=cfg.stereo_max_disparity,
                     hamming_budget=cfg.stereo_hamming_budget)
    return fl, fr, dl, m


def run_frontend(img_l: torch.Tensor, img_r: torch.Tensor, cfg,
                 prev_img_l: Optional[torch.Tensor] = None,
                 prev_feats: Optional[fast.Features] = None
                 ) -> FrontendResult:
    """Full frontend for one stereo frame (optionally tracking from t-1)."""
    fl, fr, dl, m = frontend_fused.fe_match(img_l, img_r, cfg)

    # DR refinement (outside the fusion boundary)
    m = stereo.refine(img_l, img_r, fl.yx, m,
                      radius=cfg.block_match_radius)

    # TM: LK tracking of the previous frame's features into frame t
    if prev_img_l is not None and prev_feats is not None:
        tr = optical_flow.track(prev_img_l, img_l, prev_feats.yx,
                                prev_feats.valid,
                                levels=cfg.lk_pyramid_levels,
                                window=cfg.lk_window, iters=cfg.lk_iters)
        prev_yx, track_valid = tr.yx, tr.valid
    else:
        prev_yx = torch.zeros(fl.yx.shape, dtype=torch.float32,
                              device=fl.yx.device)
        track_valid = torch.zeros_like(fl.valid)

    return FrontendResult(
        yx=fl.yx, score=fl.score, valid=fl.valid, desc=dl,
        disparity=m.disparity, stereo_valid=m.valid & fl.valid,
        prev_yx=prev_yx, track_valid=track_valid)


class FrontendCarry(NamedTuple):
    """Frontend state carried frame to frame: the previous left image
    (LK source) and the previous frame's features. Frame 0 uses the
    all-invalid init carry, so LK output is masked off and every track
    slot reseeds from detections."""
    prev_img: torch.Tensor    # (H, W) float32
    prev_yx: torch.Tensor     # (N, 2) int32
    prev_valid: torch.Tensor  # (N,) bool


def empty_prev_features(n: int, device=None) -> fast.Features:
    """All-invalid previous-frame features (frame 0)."""
    return fast.Features(yx=torch.zeros((n, 2), dtype=torch.int32,
                                        device=device),
                         score=torch.zeros(n, device=device),
                         valid=torch.zeros(n, dtype=torch.bool,
                                           device=device))


def init_carry(cfg, device=None) -> FrontendCarry:
    """Fresh carry for one robot (frame 0 semantics, fixed shapes)."""
    feats = empty_prev_features(cfg.max_features, device)
    return FrontendCarry(
        prev_img=torch.zeros((cfg.height, cfg.width), device=device),
        prev_yx=feats.yx, prev_valid=feats.valid)


def step_carry(carry: FrontendCarry, img_l: torch.Tensor,
               img_r: torch.Tensor, cfg
               ) -> Tuple[FrontendCarry, FrontendResult]:
    """One frontend stage: run the full frontend from the carried
    previous frame, then advance the carry."""
    prev_feats = fast.Features(
        yx=carry.prev_yx, score=torch.zeros_like(carry.prev_yx[:, 0],
                                                 dtype=torch.float32),
        valid=carry.prev_valid)
    fr = run_frontend(img_l, img_r, cfg, carry.prev_img, prev_feats)
    return FrontendCarry(prev_img=img_l, prev_yx=fr.yx,
                         prev_valid=fr.valid), fr
