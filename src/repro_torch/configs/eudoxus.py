"""Eudoxus localization pipeline configs — the paper's own two prototypes.

EDX-CAR  : 1280x720 stereo (KITTI-class), larger matrix engine (Sec. VII-A)
EDX-DRONE:  640x480 stereo (EuRoC-class), embedded-scale engine

These are not LM architectures; they configure the unified localization
framework (frontend + 3-mode backend + scheduler) from the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class FrontendConfig:
    height: int
    width: int
    max_features: int = 512       # feature budget per frame
    fast_threshold: int = 20      # FAST-9 intensity threshold
    fast_arc_len: int = 9
    nms_window: int = 8           # grid cell for non-max suppression
    orb_patch: int = 31           # rBRIEF sampling patch
    gaussian_sigma: float = 2.0   # image filtering before descriptors
    stereo_max_disparity: int = 96
    stereo_hamming_budget: int = 64   # max hamming distance for a match
    block_match_radius: int = 5       # DR refinement window
    lk_window: int = 11               # Lucas-Kanade window
    lk_pyramid_levels: int = 3
    lk_iters: int = 10


@dataclass(frozen=True)
class BackendConfig:
    msckf_window: int = 30        # sliding window of stereo poses (paper: 30)
    imu_rate_hz: int = 200
    cam_rate_hz: int = 20
    max_map_points: int = 4096    # registration map size budget
    bow_vocab_size: int = 4096    # bag-of-words vocabulary leaves
    bow_depth: int = 3
    ba_window: int = 10           # SLAM local bundle-adjustment keyframes
    ba_landmarks: int = 64        # padded landmark budget per BA window
    ba_every: int = 2             # BA trigger cadence (every Nth frame)
    ba_min_keyframes: int = 3     # keyframes required before BA runs
    lm_iters: int = 10            # Levenberg-Marquardt iterations
    lm_lambda0: float = 1e-3
    marginalize_poses: int = 2    # poses dropped per marginalization


@dataclass(frozen=True)
class EudoxusConfig:
    name: str
    frontend: FrontendConfig
    backend: BackendConfig
    # matrix-engine block size (the paper's Mult./Decomp. unit width);
    # EDX-CAR uses a larger unit than EDX-DRONE (Sec. VII-A).
    matrix_block: int = 128
    # scheduler: offload only when predicted accel time < host time.
    scheduler_enabled: bool = True
    frame_pipelining: bool = True     # FE/SM + frontend/backend pipelining


EDX_CAR = EudoxusConfig(
    name="edx-car",
    frontend=FrontendConfig(height=720, width=1280),
    backend=BackendConfig(),
    matrix_block=256,
)

EDX_DRONE = EudoxusConfig(
    name="edx-drone",
    frontend=FrontendConfig(height=480, width=640, max_features=256),
    backend=BackendConfig(max_map_points=2048),
    matrix_block=128,
)

CONFIGS = {c.name: c for c in (EDX_CAR, EDX_DRONE)}
