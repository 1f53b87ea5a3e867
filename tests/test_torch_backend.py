"""repro_torch backend (tracks, MSCKF, GPS fusion, covariance kernel)
against repro's, on the same numpy inputs (small window, CPU).

Post-update states and covariances are compared, never QR factors: the
two QR implementations may pick other column signs, and the update does
not depend on them (the nullspace basis only rotates the residuals).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracks as j_tracks
from repro.core.backend import fusion as j_fusion
from repro.core.backend import matrix_blocks as j_mb
from repro.core.backend import msckf as j_msckf
from repro.kernels import cov_update as j_cov
from repro.kernels import registry as j_registry
from repro_torch.core import tracks
from repro_torch.core.backend import fusion, msckf
from repro_torch.core.backend import matrix_blocks as mb
from repro_torch.kernels import cov_update

FX = FY = 144.0
CX, CY = 80.0, 60.0


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return np.asarray(x)


def _port_state(js) -> msckf.MsckfState:
    return msckf.MsckfState(*(_t(getattr(js, k))
                              for k in msckf.MsckfState._fields))


def _assert_state_close(ts, js, atol, p_rtol, p_atol):
    for k in ("q", "p", "v", "bg", "ba", "clones_q", "clones_p"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   _n(getattr(js, k)), atol=atol, err_msg=k)
    np.testing.assert_array_equal(ts.n_clones.numpy(), _n(js.n_clones))
    np.testing.assert_allclose(ts.P.numpy(), _n(js.P), rtol=p_rtol,
                               atol=p_atol)


def _track_inputs(seed, n=64, w=8):
    rs = np.random.RandomState(seed)
    uv = rs.rand(n, w, 2).astype(np.float32) * 100
    valid = rs.rand(n, w) > 0.3
    valid[: n // 4] = True                     # some full-window tracks
    det_yx = rs.randint(0, 100, (n, 2)).astype(np.int32)
    det_v = rs.rand(n) > 0.2
    trk_yx = (rs.rand(n, 2) * 100).astype(np.float32)
    trk_v = rs.rand(n) > 0.4
    return uv, valid, det_yx, det_v, trk_yx, trk_v


@pytest.mark.parametrize("seed", [0, 1])
def test_tracks_exact(seed):
    uv, valid, det_yx, det_v, trk_yx, trk_v = _track_inputs(seed)
    j = j_tracks.roll_and_update(jnp.asarray(uv), jnp.asarray(valid),
                                 jnp.asarray(det_yx), jnp.asarray(det_v),
                                 jnp.asarray(trk_yx), jnp.asarray(trk_v))
    t = tracks.roll_and_update(_t(uv), _t(valid), _t(det_yx), _t(det_v),
                               _t(trk_yx), _t(trk_v))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), _n(b))
    js = j_tracks.select_consumed(jnp.asarray(uv), jnp.asarray(valid))
    ts = tracks.select_consumed(_t(uv), _t(valid))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), _n(b))
    assert int(ts[2]) > 0
    np.testing.assert_array_equal(
        tracks.consume(_t(valid), ts[3]).numpy(),
        _n(j_tracks.consume(jnp.asarray(valid), js[3])))


def _imu(seed, k=10):
    rs = np.random.RandomState(seed)
    accel = (rs.randn(k, 3) * 0.3 + [0, 9.81, 0]).astype(np.float32)
    gyro = (rs.randn(k, 3) * 0.05).astype(np.float32)
    return accel, gyro


def test_propagate_terms_augment():
    """Nominal integration to rounding; covariance within 1e-5 relative
    (15x15 products summed in another order than XLA's)."""
    accel, gyro = _imu(3)
    js = j_msckf.init_state(4, v0=jnp.asarray([0.1, 0.0, 1.2]))
    ts = _port_state(js)
    dt = np.float32(0.005)
    jp = j_msckf.augment(j_msckf.propagate(js, jnp.asarray(accel),
                                           jnp.asarray(gyro), jnp.asarray(dt)))
    tp = msckf.augment(msckf.propagate(ts, _t(accel), _t(gyro), _t(dt)))
    _assert_state_close(tp, jp, atol=1e-6, p_rtol=1e-5, p_atol=1e-8)
    jt = j_msckf.propagate_terms(js, jnp.asarray(accel), jnp.asarray(gyro),
                                 jnp.asarray(dt))
    tt = msckf.propagate_terms(ts, _t(accel), _t(gyro), _t(dt))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-5, atol=1e-6)


def _update_problem(seed=0, w=8, f=24, n_pad=4):
    """A window of camera clones moving forward, landmarks in front, and
    noisy pixel tracks of them (the last ``n_pad`` rows are padding)."""
    rs = np.random.RandomState(seed)
    yaw = rs.randn(w) * 0.03
    cq = np.stack([np.cos(yaw / 2), np.zeros(w), np.sin(yaw / 2),
                   np.zeros(w)], 1).astype(np.float32)
    cp = np.stack([0.2 * np.sin(np.arange(w) * 0.7),
                   0.05 * np.arange(w), 0.4 * np.arange(w)],
                  1).astype(np.float32)
    js = j_msckf.init_state(w)
    M = rs.randn(15 + 6 * w, 15 + 6 * w).astype(np.float32) * 3e-3
    P = np.asarray(js.P) + M @ M.T
    js = js._replace(clones_q=jnp.asarray(cq), clones_p=jnp.asarray(cp),
                     q=jnp.asarray(cq[-1]), p=jnp.asarray(cp[-1]),
                     n_clones=jnp.int32(w), P=jnp.asarray(P))
    pts = np.stack([rs.uniform(-3, 3, f), rs.uniform(-2, 2, f),
                    rs.uniform(6, 15, f) + cp[-1, 2]], 1)
    Rs = np.stack([np.asarray(j_msckf.quat_to_rot(jnp.asarray(q)))
                   for q in cq])
    pc = np.einsum("wji,fwj->fwi", Rs, pts[:, None] - cp[None])
    uv = np.stack([FX * pc[..., 0] / pc[..., 2] + CX,
                   FY * pc[..., 1] / pc[..., 2] + CY], -1)
    uv = (uv + rs.randn(*uv.shape) * 0.5).astype(np.float32)
    valid = np.ones((f, w), bool)
    for i in range(f):
        valid[i, : rs.randint(0, w - 4)] = False
    uv[f - n_pad:] = 0.0
    valid[f - n_pad:] = False
    return js, uv, valid


def test_msckf_update():
    """Post-update state and covariance. The gain goes through a
    312x312 fp32 Cholesky; factorizations differ in summation order, so
    the state is held to 1e-5 and P to 1e-4 relative."""
    js, uv, valid = _update_problem()
    jn, jnorm = j_msckf.update(js, jnp.asarray(uv), jnp.asarray(valid),
                               FX, FY, CX, CY)
    tn, tnorm = msckf.update(_port_state(js), _t(uv), _t(valid),
                             FX, FY, CX, CY)
    assert float(jnorm) > 1e-4                     # a real correction
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-4)
    _assert_state_close(tn, jn, atol=1e-5, p_rtol=1e-4, p_atol=1e-8)


def test_triangulation_gate():
    js, uv, valid = _update_problem(seed=1)
    pw_j, ok_j = j_msckf.triangulate(jnp.asarray(uv[0]),
                                     jnp.asarray(valid[0]), js.clones_q,
                                     js.clones_p, FX, FY, CX, CY)
    pw_t, ok_t = msckf.triangulate(_t(uv), _t(valid), _t(js.clones_q),
                                   _t(js.clones_p), FX, FY, CX, CY)
    np.testing.assert_allclose(pw_t[0].numpy(), _n(pw_j), rtol=1e-4)
    assert bool(ok_t[0]) == bool(ok_j)
    assert not ok_t[-1]                            # padding row


@pytest.mark.parametrize("fix", ["valid", "nan"])
def test_gps_update(fix):
    """A valid fix moves the state; a NaN fix leaves it (zero weight)."""
    js, _, _ = _update_problem(seed=2)
    gps = (np.asarray(js.p) + [0.05, -0.02, 0.1]).astype(np.float32)
    if fix == "nan":
        gps[1] = np.nan
    jn, jd = j_fusion.gps_update(js, jnp.asarray(gps))
    tn, td = fusion.gps_update(_port_state(js), _t(gps))
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5, atol=1e-9)
    _assert_state_close(tn, jn, atol=1e-6, p_rtol=1e-5, p_atol=1e-9)


def test_kalman_gain_blocks():
    rs = np.random.RandomState(5)
    A = rs.randn(40, 40).astype(np.float32)
    P = (A @ A.T / 40 + np.eye(40)).astype(np.float32)
    H = rs.randn(12, 40).astype(np.float32)
    np.testing.assert_allclose(
        mb.kalman_gain(_t(P), _t(H), 0.25).numpy(),
        _n(j_mb.kalman_gain(jnp.asarray(P), jnp.asarray(H), 0.25)),
        rtol=1e-4, atol=1e-6)
    # a failed factorization is NaN, as jnp.linalg.cholesky's
    assert torch.isnan(mb.cholesky(-_t(P))).all()


@pytest.mark.parametrize("do_prop", [1, 0])
def test_cov_update_plain_matches_pallas(do_prop):
    """Plain covariance sweep == repro's Pallas kernel in interpret mode
    (1e-5 relative: 15x15 products summed in another order), including
    the frame-0 case where only the augment runs."""
    P, F_seq, Q, _ = j_registry._cov_update_inputs(6)
    ref = j_cov.fused_update(P, F_seq, Q, jnp.int32(do_prop),
                             interpret=True)
    out = cov_update.update_ref(_t(P), _t(F_seq), _t(Q), _t(do_prop))
    np.testing.assert_allclose(out.numpy(), _n(ref), rtol=1e-5, atol=1e-6)
    # the wrapper takes the plain version for a CPU tensor, no launch
    n0 = cov_update.LAUNCHES["cov"]
    assert torch.equal(
        cov_update.fused_update(_t(P), _t(F_seq), _t(Q), _t(do_prop)), out)
    assert cov_update.LAUNCHES["cov"] == n0


def test_cov_update_equals_propagate_augment():
    """The fused sweep reproduces msckf.propagate + augment on P."""
    accel, gyro = _imu(11)
    st = msckf.init_state(4)
    dt = torch.tensor(0.005)
    ref = msckf.augment(msckf.propagate(st, _t(accel), _t(gyro), dt))
    _, _, _, F_seq, Q = msckf.propagate_terms(st, _t(accel), _t(gyro), dt)
    out = cov_update.fused_update(st.P, F_seq, Q, torch.tensor(True))
    np.testing.assert_allclose(out.numpy(), ref.P.numpy(), rtol=1e-5,
                               atol=1e-8)

