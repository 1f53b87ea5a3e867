import os
import sys
from pathlib import Path

# tests must see the real device count (1 CPU device) — the 512-device
# flag is only ever set inside repro.launch.dryrun subprocesses.
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA GPU and nvcc (the test "
        "skips itself without one)")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def synthetic_sequence():
    """One shared small synthetic stereo/IMU/GPS sequence."""
    from repro.data import frames
    return frames.generate(n_frames=14, H=120, W=160, n_landmarks=240,
                           gps_available=True, accel_sigma=0.5,
                           gyro_sigma=0.02, seed=0)


@pytest.fixture(scope="session")
def small_cfg():
    """The shared 120x160/128-feature localization config (matches
    synthetic_sequence's frame size). The in-scan BA window/budget is
    shrunk to keep per-test compile time down — BA numerics have their
    own full-size tests in test_ba.py."""
    import dataclasses
    from repro.configs.eudoxus import EDX_DRONE
    fe = dataclasses.replace(EDX_DRONE.frontend, height=120, width=160,
                             max_features=128)
    be = dataclasses.replace(EDX_DRONE.backend, ba_window=5,
                             ba_landmarks=16, lm_iters=3)
    return dataclasses.replace(EDX_DRONE, frontend=fe, backend=be)


@pytest.fixture()
def no_kalman_offload_scheduler():
    """LatencyModels forcing the kalman_gain kernel onto the host path
    (offload_kalman=False) while every other kernel offloads — shared by
    the host-Kalman-fallback tests."""
    import repro.core.scheduler as sched

    class NoKalmanOffload(sched.LatencyModels):
        def should_offload(self, name, size, transfer_bytes=0,
                           overhead_s=None, transfer_bw=None):
            return name != "kalman_gain"

    return NoKalmanOffload
