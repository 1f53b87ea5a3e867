"""EUDOXUS end-to-end localizer, ``vio`` scenario: frontend -> MSCKF
propagate/augment/update -> GPS fusion.

``Localizer`` drives the functions of ``core.step``:

* ``step``: one frame;
* ``run``: a whole sequence in K-frame chunks. Each chunk is staged on
  the host as one padded K-frame stack (one host->device copy per input
  leaf), run frame by frame, and drained: its poses come back in one
  device->host copy. ``dispatch_count`` counts chunks, as ``repro``'s
  does.

The environment resolves to a scenario through the shipped rule table;
any scenario other than ``vio`` raises (``environment.require_ported``).
The staging is synchronous here; ``repro``'s two-slot async stager,
scheduler and host-Kalman fallback come with later slices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.eudoxus import EudoxusConfig
from repro_torch.core.environment import (Environment, mode_id,
                                          require_ported)
from repro_torch.core.step import (FrameInputs, FrameOutputs,
                                   LocalizerState, init_localizer_state,
                                   localize_chunk, localize_step)


class Localizer:
    def __init__(self, cfg: EudoxusConfig, cam, window: Optional[int] = None,
                 device=None):
        """device: ``None`` runs on CUDA (raising without a GPU); pass
        ``"cpu"`` for the plain PyTorch versions of the kernels."""
        self.cfg = cfg
        self.cam = cam
        self.window = window or cfg.backend.msckf_window
        self.device = resolve_device(device)
        self.trajectory: List[np.ndarray] = []
        self.dispatch_count = 0      # chunks (run) or frames (step) issued
        self._bound = dict(cfg=cfg.frontend, fx=cam.fx, fy=cam.fy,
                           cx=cam.cx, cy=cam.cy)

    def init_state(self, p0=None, v0=None, q0=None) -> LocalizerState:
        """p0/v0/q0: known start pose/velocity."""
        return init_localizer_state(self.cfg, self.window, p0=p0, v0=v0,
                                    q0=q0, device=self.device)

    def _dt(self, dt_imu: float) -> torch.Tensor:
        return torch.tensor(dt_imu, dtype=torch.float32, device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        # a copy, also on the CPU: the state keeps the left image
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def step(self, state: LocalizerState, img_l, img_r, imu_accel, imu_gyro,
             gps, env: Environment, dt_imu: float) -> LocalizerState:
        """One frame. imu_accel/gyro must cover the interval ENDING at
        this frame's timestamp."""
        mode = mode_id(require_ported(env))
        gps_arr = (np.full(3, np.nan, np.float32) if gps is None
                   else np.asarray(gps, np.float32))
        state, outs = localize_step(
            state, self._tensor(img_l), self._tensor(img_r),
            self._tensor(imu_accel), self._tensor(imu_gyro),
            self._tensor(gps_arr), mode, self._dt(dt_imu), **self._bound)
        self.dispatch_count += 1
        self.trajectory.append(outs.p.cpu().numpy())
        return state

    def run(self, state: LocalizerState, imgs_l, imgs_r, imu_accel,
            imu_gyro, gps, envs: Union[Environment, Sequence[Environment]],
            dt_imu: float, chunk: int = 8) -> LocalizerState:
        """Localize a T-frame sequence in K-frame chunks.

        imgs_l/imgs_r: (T,H,W); imu_accel/imu_gyro: (T,ipf,3) per-frame
        IMU slices ENDING at each frame; gps: (T,3) or None; envs: one
        Environment for the whole run or a length-T sequence."""
        T = len(imgs_l)
        if isinstance(envs, Environment):
            envs = [envs] * T
        if len(envs) != T:
            raise ValueError(f"{len(envs)} environments for {T} frames")
        chunk = max(int(chunk), 1)
        mids = [mode_id(require_ported(e)) for e in envs]

        gps_seq = np.full((T, 3), np.nan, np.float32)
        if gps is not None:
            g = np.asarray(gps, np.float32)
            for i, e in enumerate(envs):
                if e.gps_available:
                    gps_seq[i] = g[i]

        dt = self._dt(dt_imu)
        seq = (imgs_l, imgs_r, imu_accel, imu_gyro, gps_seq)
        for s in range(0, T, chunk):
            idxs = list(range(s, min(s + chunk, T)))
            inputs = self._build_chunk(idxs, seq, mids, chunk)
            state, outs = localize_chunk(state, inputs, dt, **self._bound)
            self.dispatch_count += 1
            self._drain_chunk(outs, len(idxs))
        return state

    def _build_chunk(self, idxs: List[int], seq, mids: List[int],
                     chunk: int) -> FrameInputs:
        """One padded K-frame chunk: host stacks, one copy per leaf."""
        imgs_l, imgs_r, imu_accel, imu_gyro, gps_seq = seq
        n = len(idxs)
        pad = chunk - n
        sl = slice(idxs[0], idxs[-1] + 1)

        def take(per_frame):
            arr = np.asarray(per_frame[sl], np.float32)
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad,) + arr.shape[1:], np.float32)])
            return torch.tensor(arr, device=self.device)

        return FrameInputs(
            img_l=take(imgs_l), img_r=take(imgs_r), accel=take(imu_accel),
            gyro=take(imu_gyro), gps=take(gps_seq),
            mode=np.asarray([mids[i] for i in idxs] + [mids[idxs[0]]] * pad,
                            np.int32),
            active=np.asarray([True] * n + [False] * pad))

    def _drain_chunk(self, outs: List[FrameOutputs], n_real: int) -> None:
        """Append the chunk's real frames' poses to the trajectory (one
        device->host copy)."""
        p = torch.stack([o.p for o in outs[:n_real]]).cpu().numpy()
        self.trajectory.extend(p)

    def rmse(self, gt_positions: np.ndarray) -> float:
        est = np.asarray(self.trajectory)
        n = min(len(est), len(gt_positions))
        return float(np.sqrt(np.mean(np.sum(
            (est[:n] - gt_positions[:n]) ** 2, axis=1))))
