"""Fused frontend: detect + describe + match (kernels A, B, C).

The CUDA counterparts of ``repro/kernels/frontend_fused.py``'s Pallas
kernels, in ``csrc/frontend_fused.cu``:

  kernel A (``fe_detect``):   frame -> separable Gaussian blur + FAST-9
                              score + per-cell NMS argmax. Only the
                              smoothed frame and the (Hc, Wc) cell maxima
                              reach device memory.
  kernel B (``fc_describe``): smoothed frame + corner budget ->
                              orientation + rotated BRIEF + bit packing.
  kernel C (``mo_match``):    packed descriptors -> XOR-popcount epipolar
                              match with first-index argmin.

Each wrapper takes the plain PyTorch version beside it (``*_ref``) for a
tensor on the CPU, and for a CUDA tensor launches its kernel or raises;
``LAUNCHES`` counts kernel launches. The top-K over cell maxima stays
outside the kernels, as a stable descending sort.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.frontend import fast, filters, orb, stereo
from repro_torch.kernels import _build

LAUNCHES = {"A": 0, "B": 0, "C": 0}

_BIG_INT = 1 << 30


def supported(h: int, w: int, cell: int) -> bool:
    """Kernel A needs whole NMS cells."""
    return h % cell == 0 and w % cell == 0 and h >= cell and w >= cell


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_TABLES: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}


def _tables(device: torch.device):
    """The disc and BRIEF pattern tables on ``device`` (made once)."""
    if device not in _TABLES:
        cdy, cdx = orb.circle_offsets()
        _TABLES[device] = (torch.as_tensor(cdy, device=device),
                           torch.as_tensor(cdx, device=device),
                           torch.as_tensor(orb.PAIRS, device=device))
    return _TABLES[device]


# --------------------------------------------------------------------------
# kernel A: blur + FAST-9 + cell NMS
# --------------------------------------------------------------------------

def fe_detect_ref(img: torch.Tensor, cfg):
    """Plain version of kernel A: (smooth (H,W) f32, best (Hc,Wc) f32,
    idx (Hc,Wc) int32)."""
    img = img.float()
    smooth = filters.gaussian_blur(img, cfg.gaussian_sigma)
    score = fast.fast_score(img, cfg.fast_threshold, cfg.fast_arc_len)
    best, idx = fast.cell_max(score, cfg.nms_window)
    return smooth, best, idx


def fe_detect(img: torch.Tensor, cfg):
    if img.device.type == "cpu":
        return fe_detect_ref(img, cfg)
    _require(img, "img", torch.float32, 2)
    H, W = img.shape
    cell = cfg.nms_window
    if not supported(H, W, cell):
        raise ValueError(f"kernel A needs whole {cell}x{cell} NMS cells, "
                         f"got a {H}x{W} frame")
    taps = filters.gaussian_taps(cfg.gaussian_sigma)
    taps_c = (ctypes.c_float * len(taps))(*taps)
    smooth = torch.empty((H, W), dtype=torch.float32, device=img.device)
    best = torch.empty((H // cell, W // cell), dtype=torch.float32,
                       device=img.device)
    idx = torch.empty((H // cell, W // cell), dtype=torch.int32,
                      device=img.device)
    err = _build.lib().fe_detect_launch(
        _ptr(img), H, W, ctypes.cast(taps_c, ctypes.c_void_p), len(taps),
        float(cfg.fast_threshold), cfg.fast_arc_len, cell, _ptr(smooth),
        _ptr(best), _ptr(idx), _stream())
    _build.check(err, "fe_detect")
    LAUNCHES["A"] += 1
    return smooth, best, idx


# --------------------------------------------------------------------------
# kernel B: orientation + rBRIEF + bit packing
# --------------------------------------------------------------------------

def fc_describe_ref(smooth: torch.Tensor, yx: torch.Tensor):
    """Plain version of kernel B: (desc (N,256) uint8, packed (N,8)
    int32 bit patterns)."""
    cdy, cdx, pairs = _tables(smooth.device)
    ang = orb.orientation_t(smooth, yx, cdy, cdx)
    desc = orb.describe_t(smooth, yx, ang, pairs)
    return desc.to(torch.uint8), orb.pack_bits(desc)


def fc_describe(smooth: torch.Tensor, yx: torch.Tensor):
    if smooth.device.type == "cpu":
        return fc_describe_ref(smooth, yx)
    _require(smooth, "smooth", torch.float32, 2)
    _require(yx, "yx", torch.int32, 2)
    if yx.shape[1] != 2:
        raise ValueError(f"yx must be (N, 2), got {tuple(yx.shape)}")
    H, W = smooth.shape
    n = yx.shape[0]
    cdy, cdx, pairs = _tables(smooth.device)
    desc = torch.empty((n, orb.N_BITS), dtype=torch.uint8,
                       device=smooth.device)
    packed = torch.empty((n, orb.N_BITS // 32), dtype=torch.int32,
                         device=smooth.device)
    if n:
        err = _build.lib().fc_describe_launch(
            _ptr(smooth), H, W, _ptr(yx), n, _ptr(cdy), _ptr(cdx),
            cdy.shape[0], _ptr(pairs), orb.N_BITS, H - 1.001, W - 1.001,
            _ptr(desc), _ptr(packed), _stream())
        _build.check(err, "fc_describe")
        LAUNCHES["B"] += 1
    return desc, packed


# --------------------------------------------------------------------------
# kernel C: XOR-popcount epipolar match
# --------------------------------------------------------------------------

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def mo_match_ref(pk_l, yxl, vl, pk_r, yxr, vr, *, max_disparity: int,
                 row_tol: int = 2):
    """Plain version of kernel C: (idx (NL,) int32, best (NL,) int32,
    disp (NL,) f32) — first-index argmin of the masked distances."""
    x = (pk_l[:, None, :].long() ^ pk_r[None, :, :].long()) & 0xFFFFFFFF
    dist = _popcount32(x).sum(-1)                       # (NL, NR)
    rowdiff = (yxl[:, None, 0] - yxr[None, :, 0]).abs()
    disp = yxl[:, None, 1] - yxr[None, :, 1]
    ok = ((rowdiff <= row_tol) & (disp >= 0) & (disp <= max_disparity)
          & vl[:, None] & vr[None, :])
    dist = torch.where(ok, dist, _BIG_INT)
    idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, idx[:, None])[:, 0]
    dval = torch.gather(disp, 1, idx[:, None])[:, 0].float()
    return idx.to(torch.int32), best.to(torch.int32), dval


def mo_match(pk_l, yxl, vl, pk_r, yxr, vr, *, max_disparity: int,
             row_tol: int = 2):
    if pk_l.device.type == "cpu":
        return mo_match_ref(pk_l, yxl, vl, pk_r, yxr, vr,
                            max_disparity=max_disparity, row_tol=row_tol)
    for t, name, dt in ((pk_l, "pk_l", torch.int32), (yxl, "yxl", torch.int32),
                        (pk_r, "pk_r", torch.int32), (yxr, "yxr", torch.int32)):
        _require(t, name, dt, 2)
    _require(vl, "vl", torch.bool, 1)
    _require(vr, "vr", torch.bool, 1)
    nl, nr = pk_l.shape[0], pk_r.shape[0]
    for n, pk, yx, v, side in ((nl, pk_l, yxl, vl, "left"),
                               (nr, pk_r, yxr, vr, "right")):
        if (pk.shape != (n, 8) or yx.shape != (n, 2) or v.shape != (n,)
                or v.device != pk.device or yx.device != pk.device):
            raise ValueError(f"{side}: need packed (N, 8), yx (N, 2) and "
                             f"valid (N,) on one device")
    idx = torch.empty(nl, dtype=torch.int32, device=pk_l.device)
    best = torch.empty(nl, dtype=torch.int32, device=pk_l.device)
    disp = torch.empty(nl, dtype=torch.float32, device=pk_l.device)
    if nl:
        err = _build.lib().mo_match_launch(
            _ptr(pk_l), _ptr(yxl), _ptr(vl), _ptr(pk_r), _ptr(yxr), _ptr(vr),
            nl, nr, int(max_disparity), int(row_tol), _ptr(idx), _ptr(best),
            _ptr(disp), _stream())
        _build.check(err, "mo_match")
        LAUNCHES["C"] += 1
    return idx, best, disp


def match_packed(pk_l, yxl, vl, pk_r, yxr, vr, *, max_disparity: int,
                 hamming_budget: int, row_tol: int = 2
                 ) -> stereo.StereoMatches:
    """Epipolar-constrained hamming match on packed (N,8) descriptors."""
    idx, best, dval = mo_match(pk_l, yxl, vl, pk_r, yxr, vr,
                               max_disparity=max_disparity, row_tol=row_tol)
    return stereo.StereoMatches(right_idx=idx,
                                disparity=torch.clamp(dval, min=0.0),
                                valid=best <= hamming_budget)


# --------------------------------------------------------------------------
# composition
# --------------------------------------------------------------------------

def _detect_describe(img: torch.Tensor, cfg):
    """One image through kernels A + B: Features, desc (N,256) bool,
    packed (N,8) int32."""
    smooth, best, idx = fe_detect(img, cfg)
    feats = fast.topk_cells(best, idx, cfg.max_features, cfg.nms_window)
    desc_u8, packed = fc_describe(smooth, feats.yx)
    return feats, desc_u8 != 0, packed


def fe_match(img_l: torch.Tensor, img_r: torch.Tensor, cfg):
    """Fused FE + MO for one stereo frame: returns (fl, fr, dl, matches),
    the same tuple as ``pipeline._fe_match_ref``."""
    fl, dl, pk_l = _detect_describe(img_l.float(), cfg)
    fr, _, pk_r = _detect_describe(img_r.float(), cfg)
    m = match_packed(pk_l, fl.yx, fl.valid, pk_r, fr.yx, fr.valid,
                     max_disparity=cfg.stereo_max_disparity,
                     hamming_budget=cfg.stereo_hamming_budget)
    return fl, fr, dl, m
