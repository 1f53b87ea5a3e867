"""The slice as a whole: repro_torch's ``vio`` ``Localizer`` on the CPU
against repro's on the same sequence, plus the localizer's contracts.

Bound: a per-frame position gap of at most 1e-2 m, a quarter of the
~0.04 m VIO RMSE on this sequence. Measured on the CPU: ~3e-8 m.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.environment import Environment as JEnv
from repro.core.localizer import Localizer as JLocalizer
from repro_torch import convert
from repro_torch.configs import eudoxus as t_eudoxus
from repro_torch.core.environment import Environment
from repro_torch.core.localizer import Localizer

ROOT = Path(__file__).resolve().parents[1]
GAP_BOUND = 1e-2
N_FRAMES = 14
VIO = Environment(gps_available=True, map_available=False)


def _port_cfg(cfg):
    return t_eudoxus.EudoxusConfig(
        name=cfg.name,
        frontend=t_eudoxus.FrontendConfig(**dataclasses.asdict(cfg.frontend)),
        backend=t_eudoxus.BackendConfig(**dataclasses.asdict(cfg.backend)),
        matrix_block=cfg.matrix_block)


def _inputs(seq, lo, hi):
    ipf = seq.imu_per_frame
    accel = np.stack([seq.imu_accel[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                      for i in range(lo, hi)])
    gyro = np.stack([seq.imu_gyro[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                     for i in range(lo, hi)])
    return (seq.images_left[lo:hi], seq.images_right[lo:hi], accel, gyro,
            seq.gps[lo:hi])


def _start(seq):
    v0 = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / seq.dt
    return dict(p0=seq.poses[0][:3, 3], v0=v0)


@pytest.fixture(scope="module")
def repro_runs(synthetic_sequence, small_cfg):
    """repro's trajectories (one Localizer, one compiled chunk program):
    all 14 frames, then frames 0-5 and 6-9 with the state at frame 6."""
    seq = synthetic_sequence
    dt = seq.dt / seq.imu_per_frame
    loc = JLocalizer(small_cfg, seq.cam, window=8)
    st = loc.run(loc.init_state(**_start(seq)), *_inputs(seq, 0, N_FRAMES),
                 JEnv(True, False), dt, chunk=4)
    full = np.asarray(loc.trajectory)
    mid = loc.run(loc.init_state(**_start(seq)), *_inputs(seq, 0, 6),
                  JEnv(True, False), dt, chunk=4)
    mid_np = jax.device_get(mid)
    loc.run(mid, *_inputs(seq, 6, 10), JEnv(True, False), dt, chunk=4)
    tail = np.asarray(loc.trajectory)[-4:]
    return dict(full=full, final=jax.device_get(st), rmse=loc.rmse(
        seq.poses[:N_FRAMES, :3, 3]), mid=mid_np, tail=tail)


def test_run_matches_repro(synthetic_sequence, small_cfg, repro_runs):
    """All 14 frames, chunk 4 (the last chunk is padded)."""
    seq = synthetic_sequence
    loc = Localizer(_port_cfg(small_cfg), seq.cam, window=8, device="cpu")
    st = loc.run(loc.init_state(**_start(seq)), *_inputs(seq, 0, N_FRAMES),
                 VIO, seq.dt / seq.imu_per_frame, chunk=4)
    traj = np.asarray(loc.trajectory)
    gap = np.linalg.norm(traj - repro_runs["full"], axis=1)
    print(f"per-frame position gap to repro: max {gap.max():.3g} m")
    assert traj.shape == (N_FRAMES, 3)
    assert gap.max() <= GAP_BOUND
    rmse = loc.rmse(seq.poses[:N_FRAMES, :3, 3])
    assert abs(rmse - repro_runs["rmse"]) <= 0.1 * repro_runs["rmse"]
    assert rmse < 0.1
    assert loc.dispatch_count == 4                  # ceil(14 / 4) chunks
    assert int(st.frame_idx) == N_FRAMES            # padding frames inert
    np.testing.assert_array_equal(st.tracks_valid.numpy(),
                                  repro_runs["final"].tracks_valid)


def test_mid_run_state_carry(synthetic_sequence, small_cfg, repro_runs):
    """Start the port from repro's state after 6 frames; both run the
    next 4 frames."""
    seq = synthetic_sequence
    st = convert.state_from_numpy(repro_runs["mid"], device="cpu")
    assert int(st.frame_idx) == 6
    back = convert.state_to_numpy(st)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(
                        tuple(repro_runs["mid"])[:len(back)])):
        np.testing.assert_array_equal(a, b)
    loc = Localizer(_port_cfg(small_cfg), seq.cam, window=8, device="cpu")
    loc.run(st, *_inputs(seq, 6, 10), VIO, seq.dt / seq.imu_per_frame,
            chunk=4)
    gap = np.abs(np.asarray(loc.trajectory) - repro_runs["tail"]).max()
    assert gap <= GAP_BOUND


def test_run_equals_step(synthetic_sequence, small_cfg):
    """``run`` with chunk 1 is the per-frame ``step`` loop, bitwise."""
    seq = synthetic_sequence
    cfg = _port_cfg(small_cfg)
    n = 6
    il, ir, a, g, gps = _inputs(seq, 0, n)
    dt = seq.dt / seq.imu_per_frame
    loc_r = Localizer(cfg, seq.cam, window=8, device="cpu")
    st_r = loc_r.run(loc_r.init_state(**_start(seq)), il, ir, a, g, gps,
                     VIO, dt, chunk=1)
    loc_s = Localizer(cfg, seq.cam, window=8, device="cpu")
    st_s = loc_s.init_state(**_start(seq))
    for i in range(n):
        st_s = loc_s.step(st_s, il[i], ir[i], a[i], g[i], gps[i], VIO, dt)
    np.testing.assert_array_equal(np.asarray(loc_r.trajectory),
                                  np.asarray(loc_s.trajectory))
    assert torch.equal(st_r.filt.P, st_s.filt.P)
    assert torch.equal(st_r.tracks_uv, st_s.tracks_uv)
    assert loc_r.dispatch_count == loc_s.dispatch_count == n


@pytest.mark.parametrize("env,scenario", [
    (Environment(False, False), "slam"),
    (Environment(False, True), "registration"),
    (Environment(False, False, airborne=True), "drone_vio"),
    (Environment(True, False, gps_degraded=True), "vio_degraded"),
])
def test_unported_scenarios_raise(synthetic_sequence, small_cfg, env,
                                  scenario):
    seq = synthetic_sequence
    loc = Localizer(_port_cfg(small_cfg), seq.cam, window=8, device="cpu")
    st = loc.init_state()
    with pytest.raises(ValueError, match=f"{scenario}.*not yet ported"):
        loc.run(st, *_inputs(seq, 0, 2), env, 0.01)
    with pytest.raises(ValueError, match="not yet ported"):
        loc.step(st, *(x[0] for x in _inputs(seq, 0, 1)), env, 0.01)
    assert loc.trajectory == []


def test_default_device_is_cuda(synthetic_sequence, small_cfg, monkeypatch):
    """Without ``device=`` the localizer runs on CUDA, and raises when
    there is no GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Localizer(_port_cfg(small_cfg), synthetic_sequence.cam, window=8)


def test_import_hygiene():
    """Importing every repro_torch module and chip_smoke.py pulls in
    neither jax nor any repro module."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 20
