#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (``/usr/local/cuda/bin`` or ``$NVCC``).
Phases, each fatal on failure:

1. setup: card name and power limit, versions, build of every kernel in
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   paths' shapes (EDX-CAR 720x1280 frames, 512 corners, P at d = 195
   with K = 10 IMU samples, do_prop 0 and 1; the marginalization
   kernels on the residual Jacobians of a BA round at K = 10, M = 64
   and on seeded ones at M = 50, each limit beside two broken controls
   that must fail it);
3. the paths: ``Localizer.run`` of the ``vio`` scenario at EDX-CAR full
   width (window 30, 24 frames of 720x1280 stereo, 10 IMU samples per
   frame, GPS, chunk 8), and of the ``slam`` scenario (16 frames, BA
   window 10, 64 landmarks, 10 LM iterations, BA every 2nd frame), with
   every kernel's launch count set to 0 before each and read after it;
   then each run again with the plain versions, and a small ``vio`` run
   against the CPU;
4. per-kernel device times (torch.profiler) beside the plain versions
   and the least time the card needs for the same work, and one
   profiled chunk of each path.

Prints one JSON line of per-kernel results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero, and
prints no result, without a GPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

# H100 SXM peak rates (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

T_FRAMES = 24
SLAM_FRAMES = 16
CHUNK = 8
WINDOW = 30
IMU_PER_FRAME = 10
N_LANDMARKS = 1200
REPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check(ok: bool, msg: str) -> None:
    """Fail the run (a check that ``python -O`` cannot strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_events(fn, reps: int = REPS):
    """The card's activity (kernels, copies) during ``reps`` calls, from
    torch.profiler's CUPTI trace: (name, start_us, end_us) tuples."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(evs) -> float:
    """Time the card was busy: the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(evs, key=lambda e: e[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over memory rate and
    operations over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


@contextlib.contextmanager
def plain_versions(marg_normal=None):
    """Route every kernel wrapper to its plain PyTorch version (and
    ``accumulate_normal`` to ``marg_normal`` where one is given)."""
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff
    from repro_torch.kernels import marg_schur as ms
    saved = (ff.fe_detect, ff.fc_describe, ff.mo_match, cu.fused_update,
             ms.accumulate_normal, ms.accumulate)
    ff.fe_detect, ff.fc_describe = ff.fe_detect_ref, ff.fc_describe_ref
    ff.mo_match, cu.fused_update = ff.mo_match_ref, cu.update_ref
    ms.accumulate_normal = marg_normal or ms.accumulate_normal_ref
    ms.accumulate = ms.accumulate_ref
    try:
        yield
    finally:
        (ff.fe_detect, ff.fc_describe, ff.mo_match, cu.fused_update,
         ms.accumulate_normal, ms.accumulate) = saved


def reset_counts() -> None:
    """Set every kernel's launch count and the host-sync counts to 0."""
    from repro_torch.core import primitives
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff
    from repro_torch.kernels import marg_schur as ms
    for counts in (ff.LAUNCHES, cu.LAUNCHES, ms.LAUNCHES,
                   primitives.HOST_SYNCS):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff
    from repro_torch.kernels import marg_schur as ms
    return {"A": ff.LAUNCHES["A"], "B": ff.LAUNCHES["B"],
            "C": ff.LAUNCHES["C"], "cov": cu.LAUNCHES["cov"],
            "normal": ms.LAUNCHES["normal"], "schur": ms.LAUNCHES["schur"]}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


# marginalization kernels vs plain: max|dY|/max|Y| and max|dy|/max|y|.
# The kernel sums the same float32 products as the plain version's
# einsums in another order, so the two differ by about the plain
# version's own float32 error against float64 on the same inputs, which
# the run measures: ~3e-7 on seeded Jacobians, but ~1e-3 on a real BA
# round, whose 3x3 landmark blocks are ill-conditioned (depth is weakly
# observed from nearby keyframes). The limit is 4x that
# error, and at least MARG_FLOOR; a kernel that drops one landmark or
# lays G out pose-minor misses it (the controls).
MARG_FLOOR = 1e-5


def ba_round_jacobians(seq, fe, be, cam, dev, n_kf: int = 7):
    """Residual Jacobians of a real BA round at EDX shapes: ``n_kf``
    ground-truth keyframes in a ``be.ba_window`` window (the empty slots
    give invalid observations), landmarks from frame ``n_kf - 1``'s
    stereo features, ``window_problem`` -> ``lm_optimize`` ->
    ``residuals``. The window's observations are its own landmarks'
    projections, so r is zero at the optimum up to rounding; the
    residuals are taken at a seeded perturbation of the optimum
    instead."""
    from repro_torch.core.backend import ba as ba_mod
    from repro_torch.core.backend import mapping
    from repro_torch.core.frontend import pipeline
    st = ba_mod.init_ba_state(be.ba_window, device=dev)
    for i in range(n_kf):
        pose = torch.as_tensor(seq.poses[i], dtype=torch.float32, device=dev)
        st = ba_mod.push_keyframe(st, pose[:3, :3], pose[:3, 3])
    i = n_kf - 1
    fr = pipeline.run_frontend(
        torch.as_tensor(seq.images_left[i], device=dev),
        torch.as_tensor(seq.images_right[i], device=dev), fe)
    pts, pv = ba_mod.backproject_stereo(
        fr.yx, fr.disparity, fr.stereo_valid, st.kf_R[i], st.kf_p[i],
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, baseline=cam.baseline)
    lms, lmv = ba_mod.select_landmarks(pts, pv, be.ba_landmarks)
    intr = torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy], device=dev)
    prob, _ = mapping.lm_optimize(
        ba_mod.window_problem(st, lms, lmv, intr), be.lm_iters,
        be.lm_lambda0)
    rs = np.random.RandomState(11)
    k, m = prob.obs_valid.shape
    dp = torch.as_tensor(rs.randn(k, 6).astype(np.float32) * 1e-3,
                         device=dev)
    dl = torch.as_tensor(rs.randn(m, 3).astype(np.float32) * 0.05,
                         device=dev)
    return mapping.residuals(prob, dp, dl), prob.obs_valid


def seeded_jacobians(k: int, m: int, dev):
    """Seeded residual Jacobians (numpy RandomState) with 20% of the
    observations invalid."""
    rs = np.random.RandomState(12)
    r = rs.randn(k, m, 2).astype(np.float32)
    jx = (rs.randn(k, m, 2, 6) * 0.1).astype(np.float32)
    jl = (rs.randn(k, m, 2, 3) * 0.1).astype(np.float32)
    ov = rs.rand(k, m) >= 0.2
    for x in (r, jx, jl):
        x[~ov] = 0.0
    return (tuple(torch.as_tensor(x, device=dev) for x in (r, jx, jl)),
            torch.as_tensor(ov, device=dev))


def marg_checks(cases: dict) -> dict:
    """Both marginalization entries against their plain versions on each
    case's (r, jx, jl), with two controls that must fail the limit: the
    plain version with the last valid landmark dropped, and with G laid
    out pose-minor. Returns the worst readings."""
    from repro_torch.kernels import marg_schur as ms
    worst = {"normal": 0.0, "schur": 0.0, "normal_abs": 0.0,
             "schur_abs": 0.0, "controls": {}, "limits": {}}
    for case, ((r, jx, jl), ov) in cases.items():
        k, m = jx.shape[:2]
        g, a, b = ms._normal_tile(r, jx, jl, 1e-4)
        g = g.contiguous()
        drop = int(torch.nonzero(ov.any(0))[-1])
        keep = torch.arange(m, device=r.device) != drop
        g_minor = g.reshape(m, k, 6, 3).transpose(1, 2).reshape(m, 6 * k, 3)
        for entry, kern, plain, plain64, dropped, minor in (
                ("normal", lambda: ms.accumulate_normal(r, jx, jl),
                 lambda: ms.accumulate_normal_ref(r, jx, jl),
                 lambda: ms.accumulate_normal_ref(
                     r.double(), jx.double(), jl.double()),
                 lambda: ms.accumulate_normal_ref(
                     r[:, keep], jx[:, keep], jl[:, keep]),
                 lambda: ms._tile_terms(g_minor, a, b)),
                ("schur", lambda: ms.accumulate(g, a, b),
                 lambda: ms.accumulate_ref(g, a, b),
                 lambda: ms.accumulate_ref(g.double(), a.double(),
                                           b.double()),
                 lambda: ms.accumulate_ref(g[keep], a[keep], b[keep]),
                 lambda: ms.accumulate_ref(g_minor, a, b))):
            Y, y = kern()
            Yp, yp = plain()
            Yd, yd = (v.float() for v in plain64())
            limit = [max(MARG_FLOOR, 4 * rel_err(Yp, Yd)),
                     max(MARG_FLOOR, 4 * rel_err(yp, yd))]
            err = (rel_err(Y, Yp), rel_err(y, yp))
            ctl = {}
            for what, fn in (("landmark dropped", dropped),
                             ("G pose-minor", minor)):
                Yc, yc = fn()
                ctl[what] = (rel_err(Y, Yc), rel_err(y, yc))
            log(f"[kernels] {entry} {case} (K={k}, M={m}): "
                f"max|dY|/max|Y| {err[0]:.3g}, max|dy|/max|y| "
                f"{err[1]:.3g} (limits {limit[0]:.3g}, {limit[1]:.3g}: 4x "
                f"the plain version's float32 error against float64, at "
                f"least {MARG_FLOOR}); controls that must fail them: "
                + ", ".join(f"{w} {c[0]:.3g}/{c[1]:.3g}"
                            for w, c in ctl.items()))
            check(err[0] <= limit[0] and err[1] <= limit[1],
                  f"{entry} disagrees with its plain version on {case}")
            for what, c in ctl.items():
                check(c[0] > limit[0] or c[1] > limit[1],
                      f"the marg limit cannot tell a kernel with {what}")
                worst["controls"][f"{entry} {case} {what}"] = c
            worst["limits"][f"{entry} {case}"] = limit
            worst[entry] = max(worst[entry], *err)
            worst[entry + "_abs"] = max(
                worst[entry + "_abs"], (Y - Yp).abs().max().item(),
                (y - yp).abs().max().item())
    return worst


def broken_normal(what: str):
    """A plain ``accumulate_normal`` that is wrong on purpose, for the
    slam path's controls: the last landmark with an observation dropped,
    or G laid out pose-minor."""
    from repro_torch.kernels import marg_schur as ms

    def normal(r, jx, jl, *, jitter=1e-4):
        g, a, b = ms._normal_tile(r, jx, jl, jitter)
        k, m = jx.shape[:2]
        if what == "landmark dropped":
            seen = torch.nonzero((jl != 0).flatten(2).any(2).any(0))
            keep = torch.arange(m, device=r.device) != int(seen[-1])
            return ms._tile_terms(g[keep], a[keep], b[keep])
        return ms._tile_terms(
            g.reshape(m, k, 6, 3).transpose(1, 2).reshape(m, 6 * k, 3), a, b)
    return normal


def map_diff(a, b) -> dict:
    """Differences between two localizers' SLAM maps: map points whose
    validity differs or that moved by more than 1e-4 m, differing
    descriptor bits, and keyframe histogram words whose support
    differs."""
    ma, mb = a.map, b.map
    moved = np.abs(ma.points - mb.points).max(axis=1) > 1e-4
    return dict(points=int(((ma.valid != mb.valid)
                            | (moved & ma.valid)).sum()),
                desc_bits=int((ma.descriptors != mb.descriptors).sum()),
                hist_words=int(((ma.keyframe_hists > 0)
                                != (mb.keyframe_hists > 0)).sum()))


def unsymmetrised_update(cu, P, F_seq, Q):
    """``update_ref`` at do_prop 1 without symmetrising the IMU block: a
    control the cov_update limit must reject."""
    for F in F_seq:
        Pii, Pic = F @ P[:15, :15] @ F.T + Q, F @ P[:15, 15:]
        P = P.clone()
        P[:15, :15], P[:15, 15:], P[15:, :15] = Pii, Pic, Pic.T
    return cu._augment_P(P)


def sectors_read(H: int, W: int, ys: torch.Tensor, xs: torch.Tensor) -> int:
    """32-B sectors of an (H, W) f32 frame that bilinear samples at
    (ys, xs) read: the four neighbours of each sample, after the clip."""
    y0 = torch.floor(torch.clamp(ys, 0.0, H - 1.001)).long()
    x0 = torch.floor(torch.clamp(xs, 0.0, W - 1.001)).long()
    base = (y0 * W + x0).reshape(-1)
    px = torch.cat([base, base + 1, base + W, base + W + 1])
    return torch.unique(px // 8).numel()


def imu_slices(seq, n):
    ipf = seq.imu_per_frame
    accel = np.stack([seq.imu_accel[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                      for i in range(n)]).astype(np.float32)
    gyro = np.stack([seq.imu_gyro[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                     for i in range(n)]).astype(np.float32)
    return accel, gyro


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2

    from repro_torch.configs.eudoxus import EDX_CAR
    from repro_torch.core import primitives
    from repro_torch.core.backend import ba as ba_mod
    from repro_torch.core.backend import msckf
    from repro_torch.core.environment import Environment
    from repro_torch.core.frontend import fast
    from repro_torch.core.localizer import Localizer
    from repro_torch.data import frames
    from repro_torch.kernels import _build
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff
    from repro_torch.kernels import marg_schur as ms

    dev = torch.device("cuda")
    # ---------------------------------------------------------------- 1
    smi = nvidia_smi_line()
    log(f"[setup] card: {smi}")
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"[setup] kernel build + load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS} s)")

    fe = EDX_CAR.frontend
    H, W = fe.height, fe.width
    t0 = time.perf_counter()
    seq = frames.generate(n_frames=T_FRAMES, H=H, W=W,
                          n_landmarks=N_LANDMARKS, seed=0,
                          imu_per_frame=IMU_PER_FRAME, gps_available=True)
    log(f"[setup] {T_FRAMES} frames of {H}x{W} stereo generated in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---------------------------------------------------------------- 2
    results = {}
    img_l = torch.as_tensor(seq.images_left[0], device=dev)
    img_r = torch.as_tensor(seq.images_right[0], device=dev)

    sm_k, best_k, idx_k = ff.fe_detect(img_l, fe)
    sm_p, best_p, idx_p = ff.fe_detect_ref(img_l, fe)
    feats_k = fast.topk_cells(best_k, idx_k, fe.max_features, fe.nms_window)
    feats_p = fast.topk_cells(best_p, idx_p, fe.max_features, fe.nms_window)
    errA = max((sm_k - sm_p).abs().max().item(),
               (best_k - best_p).abs().max().item())
    exactA = (torch.equal(idx_k, idx_p) and torch.equal(feats_k.yx, feats_p.yx)
              and torch.equal(feats_k.valid, feats_p.valid))
    log(f"[kernels] A fe_detect: smooth/best max |err| {errA:.3g} "
        f"(required 0: every sum runs in the plain version's order without "
        f"FMA), idx+corners exact {exactA}, {int(feats_p.valid.sum())} "
        f"valid corners")
    check(errA == 0.0 and exactA, "kernel A disagrees with fe_detect_ref")
    results["A"] = dict(max_abs_err=errA, exact=exactA)

    sm_r, best_r, idx_r = ff.fe_detect_ref(img_r, fe)
    fr_p = fast.topk_cells(best_r, idx_r, fe.max_features, fe.nms_window)
    yx = feats_p.yx.contiguous()
    d_k, pk_k = ff.fc_describe(sm_p, yx)
    d_p, pk_p = ff.fc_describe_ref(sm_p, yx)
    mis = int((d_k != d_p).sum())
    nbits = d_p.numel()
    exactB = torch.equal(pk_k, pk_p) and mis == 0
    log(f"[kernels] B fc_describe: {mis} of {nbits} descriptor bits differ "
        f"(required 0), packed words exact {exactB}")
    check(exactB, "kernel B disagrees with fc_describe_ref")
    check(torch.equal(ff.orb.pack_bits(d_k.bool()), pk_k),
          "kernel B packs words that disagree with its bits")
    results["B"] = dict(max_abs_err=float(mis > 0), exact=exactB,
                        mismatches=mis)

    pr = ff.fc_describe_ref(sm_r, fr_p.yx.contiguous())[1]
    args = (pk_p, yx, feats_p.valid, pr, fr_p.yx.contiguous(), fr_p.valid)
    kw = dict(max_disparity=fe.stereo_max_disparity)
    c_k = ff.mo_match(*args, **kw)
    c_p = ff.mo_match_ref(*args, **kw)
    exactC = all(torch.equal(a, b) for a, b in zip(c_k, c_p))
    errC = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(c_k, c_p))
    log(f"[kernels] C mo_match: idx/best/disparity exact {exactC}, "
        f"{int((c_p[1] <= fe.stereo_hamming_budget).sum())} matches")
    check(exactC, "kernel C disagrees with mo_match_ref")
    results["C"] = dict(max_abs_err=errC, exact=exactC)

    d = 15 + 6 * WINDOW
    rs = np.random.RandomState(0)
    M = rs.randn(d, d).astype(np.float32) * 0.01
    P = torch.as_tensor(M @ M.T + np.eye(d, dtype=np.float32) * 1e-4,
                        device=dev)
    st = msckf.init_state(WINDOW, device=dev)
    accel, gyro = imu_slices(seq, 2)
    dt = torch.tensor(seq.dt / IMU_PER_FRAME, device=dev)
    _, _, _, F_seq, Q = msckf.propagate_terms(
        st, torch.as_tensor(accel[1], device=dev),
        torch.as_tensor(gyro[1], device=dev), dt)
    # P's entries are <= ~0.02 and Q's <= ~1e-6 per sample, so the limit
    # (products summed in another order than cuBLAS) must sit well under
    # Q: the controls below show that a kernel dropping Q, or skipping
    # the symmetrisation of the IMU block, would fail it.
    tol = dict(rtol=1e-6, atol=1e-7)
    A = torch.as_tensor(rs.randn(15, 15).astype(np.float32), device=dev)
    Q_asym = Q + 1e-5 * (A - A.T)
    gate1 = torch.tensor(1, device=dev)
    errP = 0.0
    for do, q in ((0, Q), (1, Q), (1, Q_asym)):
        gate = torch.tensor(do, device=dev)
        a = cu.fused_update(P, F_seq, q, gate)
        b = cu.update_ref(P, F_seq, q, gate)
        errP = max(errP, (a - b).abs().max().item())
        check(torch.allclose(a, b, **tol), f"cov_update disagrees with "
              f"update_ref at do_prop={do}, Q symmetric {q is Q}")
    controls = {"Q dropped": (Q, cu.update_ref(P, F_seq, torch.zeros_like(Q),
                                               gate1)),
                "no symmetrisation": (Q_asym, unsymmetrised_update(
                    cu, P, F_seq, Q_asym))}
    ctl_err = {}
    for what, (q, wrong) in controls.items():
        a = cu.fused_update(P, F_seq, q, gate1)
        ctl_err[what] = (a - wrong).abs().max().item()
        check(not torch.allclose(a, wrong, **tol),
              f"the P limit cannot tell a kernel with {what}")
    log(f"[kernels] cov_update: P max |err| {errP:.3g} over do_prop 0/1 and "
        f"an asymmetric Q (limit rtol {tol['rtol']}, atol {tol['atol']}); "
        f"controls that must fail it: "
        + ", ".join(f"{k} {v:.3g}" for k, v in ctl_err.items()))
    results["cov"] = dict(max_abs_err=errP, exact=errP == 0.0)
    torch.cuda.synchronize()

    be = EDX_CAR.backend
    marg_in = {"BA round": ba_round_jacobians(seq, fe, be, seq.cam, dev),
               "seeded M=50": seeded_jacobians(be.ba_window, 50, dev)}
    ov = marg_in["BA round"][1]
    log(f"[kernels] BA round at K={be.ba_window}, M={be.ba_landmarks}: "
        f"{int((~ov).sum())} of {ov.numel()} observations invalid")
    marg = marg_checks(marg_in)
    for key in ("normal", "schur"):
        results[key] = dict(
            max_abs_err=marg[key + "_abs"], max_rel_err=marg[key],
            exact=marg[key] == 0.0,
            **{part: {k: v for k, v in marg[part].items()
                      if k.startswith(key)}
               for part in ("limits", "controls")})
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    accel, gyro = imu_slices(seq, T_FRAMES)
    v0 = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / seq.dt
    dt_imu = seq.dt / IMU_PER_FRAME
    gt = seq.poses[:T_FRAMES, :3, 3]

    def drive(loc, env, n_frames):
        st = loc.init_state(p0=seq.poses[0][:3, 3], v0=v0)
        times = []
        for s in range(0, n_frames, CHUNK):
            sl = slice(s, s + CHUNK)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            a.record()
            st = loc.run(st, seq.images_left[sl], seq.images_right[sl],
                         accel[sl], gyro[sl], seq.gps[sl], env, dt_imu,
                         chunk=CHUNK)
            b.record()
            b.synchronize()
            times.append((a.elapsed_time(b),
                          (time.perf_counter() - h0) * 1e3))
        return st, times

    def per_frame(chunk_ms, i):
        """ms/frame over the chunks after the first (warm) one."""
        steady = chunk_ms[1:]
        return sum(m[i] for m in steady) / (len(steady) * CHUNK)

    # --- the vio path
    env = Environment(gps_available=True, map_available=False)
    loc = Localizer(EDX_CAR, seq.cam, window=WINDOW)
    reset_counts()
    st, chunk_ms = drive(loc, env, T_FRAMES)
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = dict(primitives.HOST_SYNCS)
    expected = {"A": 2 * T_FRAMES, "B": 2 * T_FRAMES, "C": T_FRAMES,
                "cov": T_FRAMES, "normal": 0, "schur": 0}
    log(f"[main] vio: launches {launches} (expected {expected}); host "
        f"syncs {syncs}; chunks {loc.dispatch_count}")
    check(launches == expected, "a kernel of the vio path was not launched")
    traj = np.asarray(loc.trajectory)
    check(traj.shape == (T_FRAMES, 3) and bool(np.all(np.isfinite(traj))),
          f"trajectory of shape {traj.shape} is not finite (T, 3)")
    rmse = loc.rmse(gt)
    ms_frame, host_ms_frame = per_frame(chunk_ms, 0), per_frame(chunk_ms, 1)
    log(f"[main] vio EDX-CAR {H}x{W} window {WINDOW}: RMSE {rmse:.4f} m, "
        f"{ms_frame:.2f} ms/frame (CUDA events over chunks 2-3 after one "
        f"warm chunk; host clock {host_ms_frame:.2f}), chunk ms "
        f"{[round(m[0], 2) for m in chunk_ms]}")
    check(rmse < 1.0, f"RMSE {rmse} m: the filter diverged")

    with plain_versions():
        loc_p = Localizer(EDX_CAR, seq.cam, window=WINDOW)
        _, plain_chunk_ms = drive(loc_p, env, T_FRAMES)
    gap = float(np.abs(np.asarray(loc_p.trajectory) - traj).max())
    plain_ms_frame = per_frame(plain_chunk_ms, 0)
    log(f"[main] same run with the plain versions on the card: max position "
        f"gap {gap:.3g} m (bound 1e-2), RMSE {loc_p.rmse(gt):.4f} m, "
        f"{plain_ms_frame:.2f} ms/frame")
    check(gap <= 1e-2, "kernel path and plain path diverge")

    small = frames.generate(n_frames=10, H=120, W=160, n_landmarks=240,
                            seed=0, gps_available=True)
    scfg = dataclasses.replace(EDX_CAR, frontend=dataclasses.replace(
        fe, height=120, width=160, max_features=128))
    sa, sg = imu_slices(small, 10)
    sv0 = (small.poses[1][:3, 3] - small.poses[0][:3, 3]) / small.dt
    trajs = []
    for device in ("cpu", "cuda"):
        sl = Localizer(scfg, small.cam, window=8, device=device)
        s0 = sl.init_state(p0=small.poses[0][:3, 3], v0=sv0)
        sl.run(s0, small.images_left, small.images_right, sa, sg, small.gps,
               env, small.dt / small.imu_per_frame, chunk=4)
        trajs.append(np.asarray(sl.trajectory))
    sgap = float(np.abs(trajs[0] - trajs[1]).max())
    log(f"[main] 120x160 window 8: CUDA kernels vs CPU plain versions, max "
        f"position gap {sgap:.3g} m (bound 1e-2)")
    check(sgap <= 1e-2, "CUDA path and CPU path diverge at 120x160")

    # --- the slam path: BA fires at frames 2, 4, ..., 14 (at least 3
    # keyframes, frame index a multiple of ba_every)
    senv = Environment(gps_available=False, map_available=False)
    ba_frames = [i for i in range(SLAM_FRAMES) if i % be.ba_every == 0
                 and min(i + 1, be.ba_window) >= be.ba_min_keyframes]
    n_ba = len(ba_frames)
    ba_events = []
    real_round = ba_mod.ba_round

    def timed_round(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_round(*a, **k)
        e1.record()
        ba_events.append((e0, e1))
        return out

    ba_mod.ba_round = timed_round
    try:
        loc_s = Localizer(EDX_CAR, seq.cam, window=WINDOW)
        reset_counts()
        st_s, slam_chunk_ms = drive(loc_s, senv, SLAM_FRAMES)
        torch.cuda.synchronize()
        slam_launches = read_counts()
        slam_syncs = dict(primitives.HOST_SYNCS)
    finally:
        ba_mod.ba_round = real_round
    slam_expected = {"A": 2 * SLAM_FRAMES, "B": 2 * SLAM_FRAMES,
                     "C": SLAM_FRAMES, "cov": SLAM_FRAMES, "normal": n_ba,
                     "schur": 0}
    log(f"[main] slam: launches {slam_launches} (expected {slam_expected}); "
        f"BA runs {loc_s.ba_runs}; keyframes in the window "
        f"{int(st_s.ba.n_kf)}; host syncs {slam_syncs}; chunks "
        f"{loc_s.dispatch_count}")
    check(slam_launches == slam_expected,
          "a kernel of the slam path was not launched as expected")
    check(loc_s.ba_runs == n_ba == 7, f"{loc_s.ba_runs} BA runs, not 7")
    check(int(st_s.ba.n_kf) == be.ba_window, "the BA window is not full")
    straj = np.asarray(loc_s.trajectory)
    check(straj.shape == (SLAM_FRAMES, 3)
          and bool(np.all(np.isfinite(straj))), "slam trajectory not finite")
    check(bool(torch.isfinite(st_s.ba.H_prior).all())
          and bool(torch.isfinite(st_s.ba.b_prior).all()),
          "the marginalization prior is not finite")
    n_points = int(loc_s.map.valid.sum())
    check(n_points > 0 and len(loc_s._slam_keyframes) == SLAM_FRAMES
          and loc_s.map.keyframe_hists.shape[0] == SLAM_FRAMES + 1,
          "the SLAM map did not grow by one keyframe per frame")
    ba_round_ms = [e0.elapsed_time(e1) for e0, e1 in ba_events]
    steady_rounds = [t for f, t in zip(ba_frames, ba_round_ms) if f >= CHUNK]
    slam_ms_frame = per_frame(slam_chunk_ms, 0)
    slam_host_ms_frame = per_frame(slam_chunk_ms, 1)
    slam_rmse = loc_s.rmse(seq.poses[:SLAM_FRAMES, :3, 3])
    log(f"[main] slam EDX-CAR {H}x{W} window {WINDOW}, BA window "
        f"{be.ba_window}, {be.ba_landmarks} landmarks, {be.lm_iters} LM "
        f"iterations: RMSE {slam_rmse:.4f} m, {slam_ms_frame:.2f} ms/frame "
        f"(CUDA events over chunk 2 after one warm chunk; host clock "
        f"{slam_host_ms_frame:.2f}); BA round ms (CUDA events around "
        f"ba_round, every round) {[round(x, 3) for x in ba_round_ms]}; "
        f"map {n_points} points, {len(loc_s._slam_keyframes)} keyframes, "
        f"H_prior max {st_s.ba.H_prior.abs().max().item():.4g}, b_prior "
        f"max {st_s.ba.b_prior.abs().max().item():.3g}, last cost "
        f"{st_s.ba.last_cost.item():.3g}")

    def prior_gaps(st_o):
        """H_prior's gap relative to its largest entry, b_prior's
        absolute gap, against the kernel path's."""
        return (rel_err(st_s.ba.H_prior, st_o.ba.H_prior),
                (st_s.ba.b_prior - st_o.ba.b_prior).abs().max().item())

    with plain_versions():
        loc_sp = Localizer(EDX_CAR, seq.cam, window=WINDOW)
        st_sp, slam_plain_ms = drive(loc_sp, senv, SLAM_FRAMES)
    sgap_traj = float(np.abs(np.asarray(loc_sp.trajectory) - straj).max())
    h_gap, b_gap = prior_gaps(st_sp)
    c_gap = abs(st_s.ba.last_cost.item() - st_sp.ba.last_cost.item())
    md = map_diff(loc_s, loc_sp)
    slam_plain_ms_frame = per_frame(slam_plain_ms, 0)
    # BA is feedback-free, so the trajectory cannot show a broken marg
    # kernel; the prior can. The kernel's summation order moves H_prior
    # by 1.22e-4 of its largest entry and b_prior by 3.5e-4 (both
    # repeat to the digit run to run: every reduction's order is fixed),
    # so the limits sit at ~8x and ~6x those; the same run with a
    # broken accumulate_normal (the controls) must fail them. The cost
    # is held within 1e-6 (rounding noise: the window's observations
    # are its own landmarks' projections).
    h_lim, b_lim = 1e-3, 2e-3
    prior_ctl = {}
    for what in ("landmark dropped", "G pose-minor"):
        with plain_versions(broken_normal(what)):
            loc_c = Localizer(EDX_CAR, seq.cam, window=WINDOW)
            st_c, _ = drive(loc_c, senv, SLAM_FRAMES)
        prior_ctl[what] = prior_gaps(st_c)
    log(f"[main] same slam run with the plain versions on the card: "
        f"position gap {sgap_traj:.3g} m (bound 1e-2), H_prior relative "
        f"gap {h_gap:.3g} (bound {h_lim}), b_prior gap {b_gap:.3g} (bound "
        f"{b_lim}), last cost gap {c_gap:.3g} (bound 1e-6), differing map "
        f"points / descriptor bits / histogram words {md} (required 0), "
        f"{slam_plain_ms_frame:.2f} ms/frame; controls that must fail "
        f"the prior limits (H_prior/b_prior gap): "
        + ", ".join(f"{w} {c[0]:.3g}/{c[1]:.3g}"
                    for w, c in prior_ctl.items()))
    check(sgap_traj <= 1e-2 and h_gap <= h_lim and b_gap <= b_lim
          and c_gap <= 1e-6, "slam kernel path and plain path diverge")
    for what, (ch, cb) in prior_ctl.items():
        check(not (ch <= h_lim and cb <= b_lim),
              f"the slam prior limits cannot tell a path with {what}")
    check(not any(md.values()), "the SLAM maps of the kernel and plain "
          "paths differ")

    # ---------------------------------------------------------------- 4
    Hc, Wc = H // fe.nms_window, W // fe.nms_window
    N = fe.max_features
    # kernel B reads only the frame's pixels that its samples touch: the
    # 32-B sectors under the disc and the rotated pairs of this run's
    # corners, counted from the corners and angles themselves
    cdy, cdx, pairs = ff._tables(dev)
    ang = ff.orb.orientation_t(sm_p, yx, cdy, cdx)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    py, px = yx[:, 0:1].float(), yx[:, 1:2].float()
    ys = [py + cdy[None]] + [py + pairs[None, :, i] * c
                             - pairs[None, :, i + 1] * s for i in (0, 2)]
    xs = [px + cdx[None]] + [px + pairs[None, :, i] * s
                             + pairs[None, :, i + 1] * c for i in (0, 2)]
    b_sectors = sectors_read(H, W, torch.cat([y.reshape(-1) for y in ys]),
                             torch.cat([x.reshape(-1) for x in xs]))
    log(f"[timing] fc_describe touches {b_sectors} sectors "
        f"({b_sectors * 32} B) of the {H * W * 4} B smoothed frame")
    (mr, mjx, mjl), _ = marg_in["BA round"]
    mk, mm = mjx.shape[:2]
    marg_d = 6 * mk
    mg, ma, mb = ms._normal_tile(mr, mjx, mjl, 1e-4)
    mg = mg.contiguous()
    # operations per landmark of the marginalization kernels: the 3x3
    # adjugate inverse (~40), G A^-1 (D x 3 x 3 MACs), Y (symmetric, so
    # D(D+1)/2 x 3 MACs) and y (D x 3 MACs); accumulate_normal also
    # assembles hpl (K x 18 x 2 MACs), hll (9 x K x 2) and bl (3 x K x 2)
    marg_ops = mm * (40 + 2 * (marg_d * 9 + marg_d * (marg_d + 1) // 2 * 3
                               + marg_d * 3))
    marg_out = (marg_d * marg_d + marg_d) * 4
    # operations per unit: A ~150 per pixel (blur 2 x 13 mul+add, FAST
    # 16 differences, 32 compares, 16 |d|-t, 32 sums, the arc tests); B
    # ~14 per disc sample and ~28 per pair (rotation + two bilinear
    # samples); C ~30 integer ops per descriptor pair; cov_update the
    # 15 x 15 x d and 15 x 15 x 15 products of each IMU sample
    timings = {
        "A": (lambda: ff.fe_detect(img_l, fe),
              lambda: ff.fe_detect_ref(img_l, fe),
              bound(H * W * 4 * 2 + Hc * Wc * 8, H * W * 150)),
        "B": (lambda: ff.fc_describe(sm_p, yx),
              lambda: ff.fc_describe_ref(sm_p, yx),
              bound(b_sectors * 32 + N * 8 + (149 * 2 + 256 * 4) * 4
                    + N * (256 + 32), N * (149 * 14 + 256 * 28))),
        "C": (lambda: ff.mo_match(*args, **kw),
              lambda: ff.mo_match_ref(*args, **kw),
              bound(2 * N * (32 + 8 + 1) + 3 * N * 4, N * N * 30)),
        "cov": (lambda: cu.fused_update(P, F_seq, Q, gate1),
                lambda: cu.update_ref(P, F_seq, Q, gate1),
                bound(2 * d * d * 4 + F_seq.numel() * 4 + 15 * 15 * 4,
                      F_seq.shape[0] * (2 * 15 * 15 * d + 2 * 15 ** 3))),
        "normal": (lambda: ms.accumulate_normal(mr, mjx, mjl),
                   lambda: ms.accumulate_normal_ref(mr, mjx, mjl),
                   bound((mr.numel() + mjx.numel() + mjl.numel()) * 4
                         + marg_out,
                         marg_ops + mm * 2 * mk * (18 * 2 + 9 * 2 + 3 * 2))),
        "schur": (lambda: ms.accumulate(mg, ma, mb),
                  lambda: ms.accumulate_ref(mg, ma, mb),
                  bound((mg.numel() + ma.numel() + mb.numel()) * 4
                        + marg_out, marg_ops)),
    }
    meta = {
        "A": ("fe_detect", "src/repro/kernels/frontend_fused.py:117",
              "src/repro/kernels/frontend_fused.py:_fe_kernel",
              "src/repro_torch/csrc/frontend_fused.cu"),
        "B": ("fc_describe", "src/repro/kernels/frontend_fused.py:240",
              "src/repro/kernels/frontend_fused.py:_fc_kernel",
              "src/repro_torch/csrc/frontend_fused.cu"),
        "C": ("mo_match", "src/repro/kernels/frontend_fused.py:290",
              "src/repro/kernels/frontend_fused.py:_mo_kernel",
              "src/repro_torch/csrc/frontend_fused.cu"),
        "cov": ("cov_update", "src/repro/kernels/cov_update.py:64",
                "src/repro/kernels/cov_update.py:_cov_kernel",
                "src/repro_torch/csrc/cov_update.cu"),
        "normal": ("marg_normal", "src/repro/kernels/marg_schur.py:136",
                   "src/repro/kernels/marg_schur.py:_normal_kernel",
                   "src/repro_torch/csrc/marg_schur.cu"),
        "schur": ("marg_schur", "src/repro/kernels/marg_schur.py:63",
                  "src/repro/kernels/marg_schur.py:_schur_kernel",
                  "src/repro_torch/csrc/marg_schur.cu"),
    }
    # launches per path run: the spine kernels on the vio path, the
    # marginalization kernels on the slam path (accumulate is reached
    # by no path)
    path_launches = {k: (slam_launches[k] if k in ("normal", "schur")
                         else launches[k]) for k in meta}
    rows = []
    for key, (kern, plain, (bms, bby)) in timings.items():
        name, replaces, tpu, src = meta[key]
        evs = device_events(kern)
        mine = [e for e in evs if f"{name}_kernel" in e[0]]
        check(bool(mine), f"profiler saw no {name}_kernel")
        # per launch the profiler saw (it may record fewer than REPS)
        k_ms = sum(b - a for _, a, b in mine) / len(mine) / 1e3
        p_ms = busy_us(device_events(plain)) / REPS / 1e3
        ev_ms, pev_ms = time_ms(kern), time_ms(plain)
        log(f"[timing] {name}: kernel {k_ms * 1e3:.2f} us over "
            f"{len(mine)} of {REPS} launches, plain "
            f"{p_ms * 1e3:.1f} us (torch.profiler device time); per call "
            f"incl. host submit "
            f"(CUDA events) kernel {ev_ms * 1e3:.1f} us, plain "
            f"{pev_ms * 1e3:.1f} us; bound {bms * 1e3:.3f} us ({bby}); "
            f"library_ms null: no single PyTorch call computes this function")
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, tpu_kernel=tpu,
                         launches=path_launches[key], ms=k_ms, plain_ms=p_ms,
                         bound_ms=bms, bound_by=bby, library_ms=None,
                         event_ms=ev_ms, plain_event_ms=pev_ms,
                         **results[key]))

    # where a frame's time goes: one profiled chunk of each path after a
    # warm one
    def profile_chunk(path, env_):
        loc_t = Localizer(EDX_CAR, seq.cam, window=WINDOW)
        st_t = loc_t.init_state(p0=seq.poses[0][:3, 3], v0=v0)
        st_t = loc_t.run(st_t, seq.images_left[:CHUNK],
                         seq.images_right[:CHUNK], accel[:CHUNK],
                         gyro[:CHUNK], seq.gps[:CHUNK], env_, dt_imu,
                         chunk=CHUNK)
        sl = slice(CHUNK, 2 * CHUNK)
        h0 = time.perf_counter()
        evs = device_events(lambda: loc_t.run(
            st_t, seq.images_left[sl], seq.images_right[sl], accel[sl],
            gyro[sl], seq.gps[sl], env_, dt_imu, chunk=CHUNK), reps=1)
        span = (max(e[2] for e in evs) - min(e[1] for e in evs)) / 1e3
        busy = busy_us(evs) / 1e3
        per_name = {}
        for nm, a, b in evs:
            per_name[nm] = per_name.get(nm, 0.0) + (b - a) / 1e3
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"[profile] {path}, one chunk of {CHUNK} frames: device span "
            f"{span / CHUNK:.2f} ms/frame, busy {busy / CHUNK:.2f} ms/frame, "
            f"idle share {1 - busy / span:.3f}, {len(evs) / CHUNK:.0f} "
            f"device ops/frame (profiled wall "
            f"{(time.perf_counter() - h0) * 1e3:.0f} ms); top by device "
            f"ms/frame: "
            + "; ".join(f"{nm[:60]} {ms_ / CHUNK:.3f}" for nm, ms_ in top))
        return dict(device_span_ms_per_frame=span / CHUNK,
                    device_busy_ms_per_frame=busy / CHUNK,
                    idle_share=1 - busy / span,
                    device_ops_per_frame=len(evs) / CHUNK,
                    top=[(nm[:60], ms_ / CHUNK) for nm, ms_ in top])

    profile = profile_chunk("vio", env)
    slam_profile = profile_chunk("slam", senv)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows, "main_path": {
        "config": "EDX-CAR vio", "frames": T_FRAMES, "chunk": CHUNK,
        "window": WINDOW, "rmse_m": rmse, "ms_per_frame": ms_frame,
        "host_ms_per_frame": host_ms_frame,
        "plain_ms_per_frame": plain_ms_frame, "plain_gap_m": gap,
        "small_cpu_gap_m": sgap, "host_syncs": syncs,
        "profile": profile}, "slam_path": {
        "config": "EDX-CAR slam", "frames": SLAM_FRAMES, "chunk": CHUNK,
        "window": WINDOW, "ba_window": be.ba_window,
        "ba_landmarks": be.ba_landmarks, "lm_iters": be.lm_iters,
        "ba_runs": loc_s.ba_runs, "launches": slam_launches,
        "rmse_m": slam_rmse, "ms_per_frame": slam_ms_frame,
        "host_ms_per_frame": slam_host_ms_frame,
        "plain_ms_per_frame": slam_plain_ms_frame,
        "ba_round_ms": ba_round_ms, "steady_ba_round_ms": steady_rounds,
        "plain_gap_m": sgap_traj, "H_prior_rel_gap": h_gap,
        "b_prior_gap": b_gap, "prior_limits": [h_lim, b_lim],
        "prior_controls": prior_ctl, "last_cost_gap": c_gap, "map_diff": md,
        "map_points": n_points, "host_syncs": slam_syncs,
        "profile": slam_profile}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
