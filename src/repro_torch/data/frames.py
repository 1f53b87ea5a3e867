"""Synthetic stereo/IMU/GPS sequence generator (EuRoC/KITTI stand-in).

Generates a textured-landmark world, a smooth 6-DoF trajectory, stereo
renders, and IMU/GPS streams with realistic noise — ground truth included,
so localization error (the paper's RMSE metric, Fig. 3) is measurable
without the (unavailable) original datasets. Numpy on purpose: this is
the data pipeline's producer side.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float = 0.12      # meters between stereo cameras

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1.0]])


@dataclass
class Sequence:
    images_left: np.ndarray    # (T,H,W) float32 in [0,255]
    images_right: np.ndarray
    poses: np.ndarray          # (T,4,4) ground-truth cam-to-world
    imu_accel: np.ndarray      # (T*imu_per_frame, 3) body accel incl. gravity
    imu_gyro: np.ndarray       # (T*imu_per_frame, 3) body angular velocity
    gps: np.ndarray            # (T,3) noisy positions (NaN when unavailable)
    landmarks: np.ndarray      # (M,3) world points
    cam: CameraModel
    dt: float                  # frame interval seconds
    imu_per_frame: int


def _yaw(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def make_trajectory(n_frames: int, dt: float, speed: float = 1.2,
                    rng=None) -> np.ndarray:
    """Smooth forward trajectory with gentle lateral sway + yaw."""
    t = np.arange(n_frames) * dt
    x = 0.35 * np.sin(0.35 * t)
    y = 0.12 * np.sin(0.22 * t + 1.0)
    z = speed * t
    yaw = 0.08 * np.sin(0.3 * t)
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _yaw(yaw[i])
        poses[i, :3, 3] = (x[i], y[i], z[i])
        poses[i, 3, 3] = 1.0
    return poses


def make_landmarks(n: int, z_range=(2.0, 40.0), xy_extent=12.0,
                   rng=None) -> np.ndarray:
    rng = rng or np.random.RandomState(0)
    pts = np.stack([
        rng.uniform(-xy_extent, xy_extent, n),
        rng.uniform(-xy_extent / 2, xy_extent / 2, n),
        rng.uniform(z_range[0], z_range[1] + 40.0, n),
    ], axis=1)
    return pts


def render_view(landmarks, brightness, sizes, pose_c2w, cam: CameraModel,
                H: int, W: int, right: bool = False) -> np.ndarray:
    """Render landmarks as Gaussian blobs onto a dim noisy background."""
    R = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3].copy()
    if right:
        t = t + R @ np.array([cam.baseline, 0, 0])
    pw = (landmarks - t) @ R                      # world -> camera
    z = pw[:, 2]
    vis = z > 0.5
    u = cam.fx * pw[:, 0] / np.maximum(z, 1e-6) + cam.cx
    v = cam.fy * pw[:, 1] / np.maximum(z, 1e-6) + cam.cy
    vis &= (u > 4) & (u < W - 5) & (v > 4) & (v < H - 5)

    img = np.full((H, W), 24.0, np.float32)
    rr = 4
    gy, gx = np.mgrid[-rr:rr + 1, -rr:rr + 1]
    for i in np.nonzero(vis)[0]:
        sig = sizes[i] * np.clip(8.0 / z[i], 0.4, 2.0)
        blob = brightness[i] * np.exp(-(gy ** 2 + gx ** 2) / (2 * sig ** 2))
        vi, ui = int(round(v[i])), int(round(u[i]))
        img[vi - rr:vi + rr + 1, ui - rr:ui + rr + 1] += blob
    return np.clip(img, 0, 255)


def generate(n_frames: int = 30, H: int = 120, W: int = 160,
             n_landmarks: int = 260, seed: int = 0, fps: float = 10.0,
             imu_per_frame: int = 10, gps_available: bool = True,
             gps_sigma: float = 0.05, accel_sigma: float = 0.05,
             gyro_sigma: float = 0.002) -> Sequence:
    rng = np.random.RandomState(seed)
    dt = 1.0 / fps
    cam = CameraModel(fx=0.9 * W, fy=0.9 * W, cx=W / 2, cy=H / 2)
    poses = make_trajectory(n_frames, dt)
    lms = make_landmarks(n_landmarks, rng=rng)
    bright = rng.uniform(120, 230, n_landmarks)
    sizes = rng.uniform(0.9, 1.6, n_landmarks)

    il = np.stack([render_view(lms, bright, sizes, poses[i], cam, H, W)
                   for i in range(n_frames)])
    ir = np.stack([render_view(lms, bright, sizes, poses[i], cam, H, W,
                               right=True) for i in range(n_frames)])
    il += rng.randn(*il.shape).astype(np.float32) * 1.5
    ir += rng.randn(*ir.shape).astype(np.float32) * 1.5

    # IMU: finite-difference the trajectory at the IMU rate
    n_imu = n_frames * imu_per_frame
    dti = dt / imu_per_frame
    # dense positions/orientations by interpolation
    ts = np.arange(n_imu) * dti
    tf = np.arange(n_frames) * dt
    pos_d = np.stack([np.interp(ts, tf, poses[:, i, 3]) for i in range(3)], 1)
    vel = np.gradient(pos_d, dti, axis=0)
    acc_w = np.gradient(vel, dti, axis=0)
    g = np.array([0, -9.81, 0.0])
    yaw_d = np.interp(ts, tf, np.arctan2(poses[:, 0, 2], poses[:, 0, 0]))
    gyro = np.zeros((n_imu, 3))
    gyro[:, 1] = np.gradient(yaw_d, dti)
    accel = np.zeros((n_imu, 3))
    for i in range(n_imu):
        Rw = _yaw(yaw_d[i])
        accel[i] = Rw.T @ (acc_w[i] - g)
    accel += rng.randn(n_imu, 3) * accel_sigma
    gyro += rng.randn(n_imu, 3) * gyro_sigma

    gps = poses[:, :3, 3] + rng.randn(n_frames, 3) * gps_sigma
    if not gps_available:
        gps = np.full_like(gps, np.nan)

    return Sequence(images_left=il, images_right=ir, poses=poses,
                    imu_accel=accel, imu_gyro=gyro, gps=gps, landmarks=lms,
                    cam=cam, dt=dt, imu_per_frame=imu_per_frame)


def tile_fleet_sequence(seq: Sequence, batch: int, n_frames: int):
    """Tile one sequence into (T, B, ...) fleet inputs: every robot sees
    the same frame stream (the benchmark/test workload for batched and
    sharded fleet execution). Returns (imgs_l, imgs_r, imu_accel,
    imu_gyro, gps) with shapes (T,B,H,W) x2, (T,B,ipf,3) x2, (T,B,3);
    the per-frame IMU slices END at each frame (clone/observation
    alignment, frame 0 reuses the first interval like the single-robot
    drivers)."""
    ipf = seq.imu_per_frame
    B, T = batch, n_frames
    il = np.stack([np.tile(seq.images_left[i][None], (B, 1, 1))
                   for i in range(T)])
    ir = np.stack([np.tile(seq.images_right[i][None], (B, 1, 1))
                   for i in range(T)])
    ac = np.stack([np.tile(
        seq.imu_accel[max(i - 1, 0) * ipf:max(i, 1) * ipf][None],
        (B, 1, 1)) for i in range(T)])
    gy = np.stack([np.tile(
        seq.imu_gyro[max(i - 1, 0) * ipf:max(i, 1) * ipf][None],
        (B, 1, 1)) for i in range(T)])
    gps = np.stack([np.tile(seq.gps[i][None], (B, 1))
                    for i in range(T)]).astype(np.float32)
    return il, ir, ac, gy, gps
