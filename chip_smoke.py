#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (``/usr/local/cuda/bin`` or ``$NVCC``).
Phases, each fatal on failure:

1. setup: card name and power limit, versions, build of every kernel in
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (EDX-CAR 720x1280 frames, 512 corners, P at
   d = 195 with K = 10 IMU samples, do_prop 0 and 1);
3. the main path: ``Localizer.run`` of the ``vio`` scenario at EDX-CAR
   full width (window 30, 24 frames of 720x1280 stereo, 10 IMU samples
   per frame, GPS, chunk 8), with every kernel's launch count read
   around it; then the same run with the plain versions, and a small
   run against the CPU;
4. per-kernel device times (torch.profiler, 50 calls) beside the plain
   versions and the least time the card needs for the same work.

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
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version."""
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff
    saved = (ff.fe_detect, ff.fc_describe, ff.mo_match, cu.fused_update)
    ff.fe_detect, ff.fc_describe = ff.fe_detect_ref, ff.fc_describe_ref
    ff.mo_match, cu.fused_update = ff.mo_match_ref, cu.update_ref
    try:
        yield
    finally:
        (ff.fe_detect, ff.fc_describe, ff.mo_match,
         cu.fused_update) = saved


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
    from repro_torch.core.backend import msckf
    from repro_torch.core.environment import Environment
    from repro_torch.core.frontend import fast
    from repro_torch.core.localizer import Localizer
    from repro_torch.data import frames
    from repro_torch.kernels import _build
    from repro_torch.kernels import cov_update as cu
    from repro_torch.kernels import frontend_fused as ff

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

    # ---------------------------------------------------------------- 3
    env = Environment(gps_available=True, map_available=False)
    accel, gyro = imu_slices(seq, T_FRAMES)
    v0 = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / seq.dt
    dt_imu = seq.dt / IMU_PER_FRAME
    gt = seq.poses[:T_FRAMES, :3, 3]

    def drive(loc):
        st = loc.init_state(p0=seq.poses[0][:3, 3], v0=v0)
        ms = []
        for s in range(0, T_FRAMES, CHUNK):
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
            ms.append((a.elapsed_time(b), (time.perf_counter() - h0) * 1e3))
        return st, ms

    loc = Localizer(EDX_CAR, seq.cam, window=WINDOW)
    for k in ff.LAUNCHES:
        ff.LAUNCHES[k] = 0
    cu.LAUNCHES["cov"] = 0
    primitives.HOST_SYNCS["msckf_update"] = 0
    st, chunk_ms = drive(loc)
    torch.cuda.synchronize()
    launches = {"A": ff.LAUNCHES["A"], "B": ff.LAUNCHES["B"],
                "C": ff.LAUNCHES["C"], "cov": cu.LAUNCHES["cov"]}
    syncs = primitives.HOST_SYNCS["msckf_update"]
    expected = {"A": 2 * T_FRAMES, "B": 2 * T_FRAMES, "C": T_FRAMES,
                "cov": T_FRAMES}
    log(f"[main] launches on the main path {launches} (expected "
        f"{expected}); host syncs {syncs}; chunks {loc.dispatch_count}")
    check(launches == expected, "a kernel of the path was not launched")
    traj = np.asarray(loc.trajectory)
    check(traj.shape == (T_FRAMES, 3) and bool(np.all(np.isfinite(traj))),
          f"trajectory of shape {traj.shape} is not finite (T, 3)")
    rmse = loc.rmse(gt)
    steady = chunk_ms[1:]
    ms_frame = sum(m[0] for m in steady) / (len(steady) * CHUNK)
    host_ms_frame = sum(m[1] for m in steady) / (len(steady) * CHUNK)
    log(f"[main] vio EDX-CAR {H}x{W} window {WINDOW}: RMSE {rmse:.4f} m, "
        f"{ms_frame:.2f} ms/frame (CUDA events over chunks 2-3 after one "
        f"warm chunk; host clock {host_ms_frame:.2f}), chunk ms "
        f"{[round(m[0], 2) for m in chunk_ms]}")
    check(rmse < 1.0, f"RMSE {rmse} m: the filter diverged")

    with plain_versions():
        loc_p = Localizer(EDX_CAR, seq.cam, window=WINDOW)
        _, plain_chunk_ms = drive(loc_p)
    gap = float(np.abs(np.asarray(loc_p.trajectory) - traj).max())
    plain_ms_frame = sum(m[0] for m in plain_chunk_ms[1:]) / (
        (len(plain_chunk_ms) - 1) * CHUNK)
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
    }
    rows = []
    for key, (kern, plain, (bms, bby)) in timings.items():
        name, replaces, tpu, src = meta[key]
        evs = device_events(kern)
        mine = [e for e in evs if f"{name}_kernel" in e[0]]
        check(bool(mine), f"profiler saw no {name}_kernel")
        k_ms = sum(b - a for _, a, b in mine) / REPS / 1e3
        p_ms = busy_us(device_events(plain)) / REPS / 1e3
        ev_ms, pev_ms = time_ms(kern), time_ms(plain)
        log(f"[timing] {name}: kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.1f} us (torch.profiler device time); per call "
            f"incl. host submit "
            f"(CUDA events) kernel {ev_ms * 1e3:.1f} us, plain "
            f"{pev_ms * 1e3:.1f} us; bound {bms * 1e3:.3f} us ({bby}); "
            f"library_ms null: no single PyTorch call computes this function")
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, tpu_kernel=tpu,
                         launches=launches[key], ms=k_ms, plain_ms=p_ms,
                         bound_ms=bms, bound_by=bby, library_ms=None,
                         event_ms=ev_ms, plain_event_ms=pev_ms,
                         **results[key]))

    # where a frame's time goes: one profiled chunk after a warm one
    loc_t = Localizer(EDX_CAR, seq.cam, window=WINDOW)
    st_t = loc_t.init_state(p0=seq.poses[0][:3, 3], v0=v0)
    st_t = loc_t.run(st_t, seq.images_left[:CHUNK], seq.images_right[:CHUNK],
                     accel[:CHUNK], gyro[:CHUNK], seq.gps[:CHUNK], env,
                     dt_imu, chunk=CHUNK)
    sl = slice(CHUNK, 2 * CHUNK)
    h0 = time.perf_counter()
    evs = device_events(lambda: loc_t.run(
        st_t, seq.images_left[sl], seq.images_right[sl], accel[sl],
        gyro[sl], seq.gps[sl], env, dt_imu, chunk=CHUNK), reps=1)
    span = (max(e[2] for e in evs) - min(e[1] for e in evs)) / 1e3
    busy = busy_us(evs) / 1e3
    per_name = {}
    for nm, a, b in evs:
        per_name[nm] = per_name.get(nm, 0.0) + (b - a) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    profile = dict(device_span_ms_per_frame=span / CHUNK,
                   device_busy_ms_per_frame=busy / CHUNK,
                   idle_share=1 - busy / span,
                   device_ops_per_frame=len(evs) / CHUNK,
                   top=[(nm[:60], ms / CHUNK) for nm, ms in top])
    log(f"[profile] one chunk of {CHUNK} frames: device span "
        f"{span / CHUNK:.2f} ms/frame, busy {busy / CHUNK:.2f} ms/frame, "
        f"idle share {1 - busy / span:.3f}, {len(evs) / CHUNK:.0f} device "
        f"ops/frame (profiled wall {(time.perf_counter() - h0) * 1e3:.0f} "
        f"ms); top by device ms/frame: "
        + "; ".join(f"{nm[:60]} {ms / CHUNK:.3f}" for nm, ms in top))
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows, "main_path": {
        "config": "EDX-CAR vio", "frames": T_FRAMES, "chunk": CHUNK,
        "window": WINDOW, "rmse_m": rmse, "ms_per_frame": ms_frame,
        "host_ms_per_frame": host_ms_frame,
        "plain_ms_per_frame": plain_ms_frame, "plain_gap_m": gap,
        "small_cpu_gap_m": sgap, "host_syncs": syncs,
        "profile": profile}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
