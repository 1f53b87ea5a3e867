"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a GPU and nvcc: it carries the
``requires_cuda`` marker and skips itself without a card. On the card:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q

Imports neither jax nor repro, so it runs where only torch is installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.eudoxus import EDX_CAR
from repro_torch.core.environment import Environment
from repro_torch.core.frontend import pipeline
from repro_torch.core.localizer import Localizer
from repro_torch.data import frames
from repro_torch.kernels import cov_update
from repro_torch.kernels import frontend_fused as ff

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc; runs on the card")
    return torch.device("cuda")


def _frames(h, w, seed=0):
    seq = frames.generate(n_frames=1, H=h, W=w, n_landmarks=240, seed=seed)
    return (torch.as_tensor(seq.images_left[0]),
            torch.as_tensor(seq.images_right[0]))


def _fe_cfg(h, w, max_features=128):
    return dataclasses.replace(EDX_CAR.frontend, height=h, width=w,
                               max_features=max_features)


@pytest.mark.parametrize("h,w,n", [(120, 160, 128), (48, 200, 512),
                                   (64, 96, 32)])
def test_frontend_kernels_exact(cuda, h, w, n):
    """Kernels A, B, C equal their plain versions bit for bit, including
    a strip narrower than one 128-column tile and a corner budget above
    the cell count (48x200 has 150 cells)."""
    il, ir = (x.to(cuda) for x in _frames(h, w, seed=h + w))
    cfg = _fe_cfg(h, w, n)
    launches = dict(ff.LAUNCHES)
    for x, y in zip(ff.fe_detect(il, cfg), ff.fe_detect_ref(il, cfg)):
        assert torch.equal(x, y)
    fl_k, fr_k, dl_k, m_k = ff.fe_match(il, ir, cfg)
    assert ff.LAUNCHES == {"A": launches["A"] + 3, "B": launches["B"] + 2,
                           "C": launches["C"] + 1}
    fl_p, fr_p, dl_p, m_p = pipeline._fe_match_ref(il, ir, cfg)
    for x, y in zip(fl_k + fr_k + m_k, fl_p + fr_p + m_p):
        assert torch.equal(x, y)
    assert torch.equal(dl_k, dl_p)


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    il, _ = (x.to(cuda) for x in _frames(120, 160))
    with pytest.raises(ValueError, match="whole 8x8"):
        ff.fe_detect(il[:, :156].contiguous(), _fe_cfg(120, 156))
    with pytest.raises(TypeError):
        ff.fe_detect(il.double(), _fe_cfg(120, 160))
    with pytest.raises(ValueError, match="contiguous"):
        ff.fe_detect(il.T, _fe_cfg(160, 120))
    P = torch.eye(15 + 6 * 40, device=cuda)          # d = 255: too big
    F = torch.eye(15, device=cuda).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        cov_update.fused_update(P, F, torch.zeros(15, 15, device=cuda),
                                torch.tensor(1, device=cuda))


@pytest.mark.parametrize("window", [8, 30])
@pytest.mark.parametrize("do_prop", [1, 0])
def test_cov_update_kernel(cuda, window, do_prop):
    """1e-5: the kernel sums the 15-term products in another order than
    cuBLAS."""
    d = 15 + 6 * window
    rs = np.random.RandomState(window)
    M = rs.randn(d, d).astype(np.float32) * 0.01
    P = torch.as_tensor(M @ M.T + np.eye(d, dtype=np.float32) * 1e-4,
                        device=cuda)
    F = torch.as_tensor(np.eye(15, dtype=np.float32)
                        + rs.randn(10, 15, 15).astype(np.float32) * 0.01,
                        device=cuda)
    Q = torch.diag(torch.full((15,), 1e-6, device=cuda))
    gate = torch.tensor(do_prop, device=cuda)
    torch.testing.assert_close(cov_update.fused_update(P, F, Q, gate),
                               cov_update.update_ref(P, F, Q, gate),
                               rtol=1e-5, atol=1e-6)


def test_localizer_on_card_matches_cpu(cuda):
    """The vio path with the kernels on the card against the plain
    versions on the CPU (120x160, window 8, 10 frames, chunk 4)."""
    seq = frames.generate(n_frames=10, H=120, W=160, n_landmarks=240, seed=0)
    cfg = dataclasses.replace(EDX_CAR, frontend=_fe_cfg(120, 160))
    ipf = seq.imu_per_frame
    acc = np.stack([seq.imu_accel[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                    for i in range(10)])
    gyr = np.stack([seq.imu_gyro[max(i - 1, 0) * ipf:max(i, 1) * ipf]
                    for i in range(10)])
    v0 = (seq.poses[1][:3, 3] - seq.poses[0][:3, 3]) / seq.dt
    trajs = []
    for device in ("cpu", cuda):
        loc = Localizer(cfg, seq.cam, window=8, device=device)
        st = loc.init_state(p0=seq.poses[0][:3, 3], v0=v0)
        loc.run(st, seq.images_left, seq.images_right, acc, gyr, seq.gps,
                Environment(True, False), seq.dt / ipf, chunk=4)
        trajs.append(np.asarray(loc.trajectory))
    assert np.abs(trajs[0] - trajs[1]).max() <= 1e-2
