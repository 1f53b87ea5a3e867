"""EUDOXUS end-to-end localizer: frontend -> mode dispatch -> backend.

Per frame (paper Fig. 4): the shared spine (frontend, track ring, MSCKF
propagate/augment/update), then the scenario's stages: GPS fusion
(``vio``, ``vio_degraded``), nothing more (``drone_vio``), or BoW + the
windowed BA and Schur marginalization (``slam``), whose map grows on the
host.

``Localizer`` drives the functions of ``core.step``:

* ``step``: one frame;
* ``run``: a whole sequence in K-frame chunks. Each chunk is staged on
  the host as one padded K-frame stack (one host->device copy per input
  leaf), run frame by frame, and drained: its poses and, for chunks with
  ``slam`` frames, the frontend leaves and histograms those frames' map
  bookkeeping reads come back in one device->host copy, and the SLAM
  host stage replays them in frame order (map growth never feeds back
  into the filter, and the host stage does no device work).
  ``dispatch_count`` counts chunks, as ``repro``'s does.

The environment resolves to a scenario through the shipped rule table;
``registration`` raises (``environment.require_ported``). The staging is
synchronous here; ``repro``'s two-slot async stager, scheduler and
host-Kalman fallback come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.eudoxus import EudoxusConfig
from repro_torch.core import primitives, scenarios
from repro_torch.core.backend import tracking
from repro_torch.core.environment import (Environment, mode_id,
                                          require_ported)
from repro_torch.core.step import (FrameInputs, FrameOutputs, HostMirror,
                                   LocalizerState, init_localizer_state,
                                   localize_chunk, localize_step)

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.bool_}


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy tensors to numpy in ONE device->host transfer: their bytes
    are packed into one buffer on the device first."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, offset = [], 0
    for t, f in zip(tensors, flat):
        dt = np.dtype(_NP_DTYPES[t.dtype])
        out.append(np.frombuffer(buf, dtype=dt, count=t.numel(),
                                 offset=offset).reshape(tuple(t.shape)))
        offset += f.numel()
    return out


def np_quat_to_rot(q: np.ndarray) -> np.ndarray:
    """NumPy twin of ``msckf.quat_to_rot`` — keeps the SLAM host stage
    free of device work."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def stereo_points_world(kf, cam) -> tuple:
    """Back-project a keyframe's stereo features to world points."""
    disp = kf["disparity"]
    valid = kf["svalid"] & (disp > 0.5)
    z = cam.fx * cam.baseline / np.maximum(disp, 1e-3)
    u = kf["yx"][:, 1]
    v = kf["yx"][:, 0]
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    pc = np.stack([x, y, z], axis=1)
    pw = pc @ kf["pose_R"].T + kf["pose_p"]
    return pw.astype(np.float32), valid & (z < 60.0)


@dataclass
class MapData:
    points: np.ndarray          # (M,3) world landmarks
    descriptors: np.ndarray     # (M,256) bool
    valid: np.ndarray           # (M,) bool
    keyframe_hists: np.ndarray  # (K,V) BoW histograms
    keyframe_poses: np.ndarray  # (K,4,4)


class Localizer:
    def __init__(self, cfg: EudoxusConfig, cam, window: Optional[int] = None,
                 device=None, vocab: Optional[torch.Tensor] = None):
        """device: ``None`` runs on CUDA (raising without a GPU); pass
        ``"cpu"`` for the plain PyTorch versions of the kernels.
        vocab: optional pre-built BoW hyperplanes (default
        ``make_vocab(cfg.backend.bow_vocab_size)`` on the device)."""
        self.cfg = cfg
        self.cam = cam
        self.window = window or cfg.backend.msckf_window
        self.device = resolve_device(device)
        self.vocab = (vocab if vocab is not None else torch.as_tensor(
            tracking.make_vocab(cfg.backend.bow_vocab_size),
            device=self.device))
        self.trajectory: List[np.ndarray] = []
        self.map: Optional[MapData] = None
        self._slam_keyframes: List[Dict] = []
        self.dispatch_count = 0      # chunks (run) or frames (step) issued
        self.ba_runs = 0             # BA + marginalization passes
        self._bound = dict(
            cfg=cfg.frontend, be_cfg=cfg.backend, fx=cam.fx, fy=cam.fy,
            cx=cam.cx, cy=cam.cy, baseline=cam.baseline, vocab=self.vocab,
            intr=torch.tensor([cam.fx, cam.fy, cam.cx, cam.cy],
                              dtype=torch.float32, device=self.device))

    def init_state(self, p0=None, v0=None, q0=None) -> LocalizerState:
        """p0/v0/q0: known start pose/velocity."""
        return init_localizer_state(self.cfg, self.window, p0=p0, v0=v0,
                                    q0=q0, device=self.device)

    def _dt(self, dt_imu: float) -> torch.Tensor:
        return torch.tensor(dt_imu, dtype=torch.float32, device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        # a copy, also on the CPU: the state keeps the left image
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    @staticmethod
    def _mirror(state: LocalizerState) -> HostMirror:
        """The host mirror of frame index and keyframe count (one read)."""
        primitives.HOST_SYNCS["host_mirror"] += 1
        return HostMirror(*torch.stack([state.frame_idx,
                                        state.ba.n_kf]).tolist())

    def step(self, state: LocalizerState, img_l, img_r, imu_accel, imu_gyro,
             gps, env: Environment, dt_imu: float) -> LocalizerState:
        """One frame. imu_accel/gyro must cover the interval ENDING at
        this frame's timestamp."""
        mode = mode_id(require_ported(env))
        gps_arr = (np.full(3, np.nan, np.float32) if gps is None
                   else np.asarray(gps, np.float32))
        state, _, out = localize_step(
            state, self._mirror(state), self._tensor(img_l),
            self._tensor(img_r), self._tensor(imu_accel),
            self._tensor(imu_gyro), self._tensor(gps_arr), mode,
            self._dt(dt_imu), **self._bound)
        self.dispatch_count += 1
        self._drain_chunk([out], [mode])
        return state

    def run(self, state: LocalizerState, imgs_l, imgs_r, imu_accel,
            imu_gyro, gps, envs: Union[Environment, Sequence[Environment]],
            dt_imu: float, chunk: int = 8) -> LocalizerState:
        """Localize a T-frame sequence in K-frame chunks.

        imgs_l/imgs_r: (T,H,W); imu_accel/imu_gyro: (T,ipf,3) per-frame
        IMU slices ENDING at each frame; gps: (T,3) or None; envs: one
        Environment for the whole run or a length-T sequence (the
        scenario may change from frame to frame)."""
        T = len(imgs_l)
        if isinstance(envs, Environment):
            envs = [envs] * T
        if len(envs) != T:
            raise ValueError(f"{len(envs)} environments for {T} frames")
        chunk = max(int(chunk), 1)
        mids = [mode_id(require_ported(e)) for e in envs]
        if T == 0:
            return state

        gps_seq = np.full((T, 3), np.nan, np.float32)
        if gps is not None:
            g = np.asarray(gps, np.float32)
            for i, e in enumerate(envs):
                if e.gps_available:
                    gps_seq[i] = g[i]

        dt = self._dt(dt_imu)
        seq = (imgs_l, imgs_r, imu_accel, imu_gyro, gps_seq)
        host = self._mirror(state)
        for s in range(0, T, chunk):
            idxs = list(range(s, min(s + chunk, T)))
            inputs = self._build_chunk(idxs, seq, mids, chunk)
            state, host, outs = localize_chunk(state, host, inputs, dt,
                                               **self._bound)
            self.dispatch_count += 1
            self._drain_chunk(outs[:len(idxs)], [mids[i] for i in idxs])
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

    def _drain_chunk(self, outs: List[FrameOutputs], mids: List[int]
                     ) -> None:
        """Host stage of one chunk's real frames, in frame order: append
        the poses to the trajectory and replay the SLAM frames' map
        bookkeeping. One device->host copy brings back all it reads."""
        slam = [scenarios.SPECS[m].host_stage == "slam" for m in mids]
        leaves = [torch.stack([o.p for o in outs])]
        if any(slam):
            leaves += [torch.stack([getattr(o.fr, k) for o in outs])
                       for k in ("yx", "disparity", "stereo_valid", "desc")]
            # frames without the BoW stage carry no histogram: zeros,
            # which the host stage never reads
            zero = torch.zeros_like(next(o.hist for o, s in zip(outs, slam)
                                         if s))
            leaves += [torch.stack([o.q for o in outs]),
                       torch.stack([zero if o.hist is None else o.hist
                                    for o in outs])]
        host = to_host(leaves)
        p = host[0]
        for j, is_slam in enumerate(slam):
            if is_slam:
                yx, disp, svalid, desc, q, hist = (a[j] for a in host[1:])
                self._slam_frame(q, p[j], yx, disp, svalid, desc, hist)
            self.trajectory.append(p[j].copy())
        self.ba_runs += sum(o.ba_ran for o in outs)

    def _slam_frame(self, q, p, yx, disparity, stereo_valid, desc,
                    hist) -> None:
        """Append-only SLAM map bookkeeping from one frame's post-frame
        pose and frontend result: record the keyframe, extend the map."""
        kf = {"pose_R": np_quat_to_rot(q), "pose_p": np.asarray(p),
              "yx": np.asarray(yx, np.float32), "disparity": disparity,
              "svalid": stereo_valid, "desc": desc, "hist": hist}
        self._slam_keyframes.append(kf)
        self._extend_map(kf)

    def _extend_map(self, kf):
        pts, valid = stereo_points_world(kf, self.cam)
        mp = self.cfg.backend.max_map_points
        if self.map is None:
            # the first keyframe's histogram and an identity pose open
            # the keyframe lists, as in ``repro``
            self.map = MapData(
                points=np.zeros((mp, 3), np.float32),
                descriptors=np.zeros((mp, 256), bool),
                valid=np.zeros(mp, bool),
                keyframe_hists=kf["hist"][None].copy(),
                keyframe_poses=np.eye(4)[None].repeat(1, 0))
        m = self.map
        free = np.nonzero(~m.valid)[0]
        add = np.nonzero(valid)[0][:free.size]
        slots = free[:add.size]
        m.points[slots] = pts[add]
        m.descriptors[slots] = kf["desc"][add]
        m.valid[slots] = True
        m.keyframe_hists = np.concatenate([m.keyframe_hists,
                                           kf["hist"][None]])
        pose = np.eye(4)
        pose[:3, :3] = kf["pose_R"]
        pose[:3, 3] = kf["pose_p"]
        m.keyframe_poses = np.concatenate([m.keyframe_poses, pose[None]])

    def rmse(self, gt_positions: np.ndarray) -> float:
        est = np.asarray(self.trajectory)
        n = min(len(est), len(gt_positions))
        return float(np.sqrt(np.mean(np.sum(
            (est[:n] - gt_positions[:n]) ** 2, axis=1))))
