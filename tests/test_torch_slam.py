"""The ``slam`` slice: repro_torch's BoW, bundle adjustment, Schur
marginalization and SLAM localizer on the CPU against repro's, on the
same seeded inputs. repro's Pallas kernels run as its own tests run
them (``interpret=True``), beside their ``_ref`` versions.

Tolerances, each with its reason:

* marg_schur plain versions: 1e-5 of the largest entry. Both sides sum
  the same float32 products in another order (XLA's vs PyTorch's
  einsum) on well-conditioned seeded blocks.
* Residuals and normal equations: 1e-5 and 1e-4 of the largest entry,
  the same cause. The reduced pose solve: 1e-3 at lam 10, where the
  system is well conditioned; LM is compared at its optimum (see the
  test for why not per iteration).
* ``H_prior`` of a whole run: 1e-2 of the largest entry. f32 rounding
  in ``_schur_tail``'s cancellation (kept poses minus landmark
  coupling), on landmarks that differ by ~2e-5 m between the packages
  (stereo disparity summed in another order). Measured 2.7e-4 (``slam``)
  and 1.1e-3 (mixed).
* ``b_prior`` and ``last_cost``: absolute 1e-2 and 1e-6. The window's
  observations are its own landmarks' projections, so the residual is
  zero up to rounding and both values are rounding noise (repro 1.7e-3
  and 1.6e-9; the port 0).
* Descriptors: kernel B's plain version sums the orientation moments in
  table order, repro in XLA's order (ROADMAP.md §3), which can flip a
  bit; at most 0.1% of bits may differ, and a flipped descriptor moves
  at most one word, so at most 2 histogram entries per keyframe change
  support. Measured 0 and 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import ba as j_ba
from repro.core.backend import mapping as j_mapping
from repro.core.backend import matrix_blocks as j_mb
from repro.core.backend import tracking as j_tracking
from repro.core.environment import Environment as JEnv
from repro.core.localizer import Localizer as JLocalizer
from repro.kernels import marg_schur as j_marg
from repro.kernels import registry as j_registry
from repro_torch import convert
from repro_torch.configs import eudoxus as t_eudoxus
from repro_torch.core.backend import ba, mapping, tracking
from repro_torch.core.backend import matrix_blocks as mb
from repro_torch.core.environment import Environment
from repro_torch.core.localizer import Localizer
from repro_torch.kernels import marg_schur

N_FRAMES = 14
GAP_BOUND = 1e-2
SLAM, VIO = Environment(False, False), Environment(True, False)
JSLAM, JVIO = JEnv(False, False), JEnv(True, False)
INTR = np.array([144.0, 144.0, 80.0, 60.0], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return np.asarray(x)


def _rel(a, b):
    a, b = _n(a).astype(np.float64), _n(b).astype(np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


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


def _envs(kind, lo, hi, vio, slam):
    """``slam`` on every frame, or ``mixed``: frames 0-5 vio, 6-13 slam."""
    return [vio if kind == "mixed" and i < 6 else slam for i in range(lo, hi)]


def _rot(a):
    th = np.linalg.norm(a)
    k = a / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _window(seed=0, kw=5, m=16, n_valid=5):
    """A seeded BA window: keyframes along a forward path, landmarks in
    front of them (some invalid), ``n_valid`` filled slots."""
    rs = np.random.RandomState(seed)
    kf_R = np.stack([_rot(a) for a in rs.randn(kw, 3) * 0.02])
    kf_p = np.arange(kw)[:, None] * [0.1, 0.0, 0.5] + rs.randn(kw, 3) * 0.01
    lms = rs.rand(m, 3) * [8, 6, 20] + [-4, -3, 4]
    lmv = rs.rand(m) > 0.15
    return (kf_R.astype(np.float32), kf_p.astype(np.float32),
            np.arange(kw) < n_valid, lms.astype(np.float32), lmv)


# --------------------------------------------------------------------------
# the marg_schur kernels' plain versions
# --------------------------------------------------------------------------

def _normal_inputs(case):
    if case == "registry48":
        return tuple(_n(x) for x in j_registry._marg_schur_inputs(48))
    rs = np.random.RandomState(10)                     # K=10, M=64 (EDX)
    r = rs.randn(10, 64, 2).astype(np.float32)
    jx = (rs.randn(10, 64, 2, 6) * 0.1).astype(np.float32)
    jl = (rs.randn(10, 64, 2, 3) * 0.1).astype(np.float32)
    jx[7:, 50:] = 0.0                                  # invalid observations
    jl[7:, 50:] = 0.0
    r[7:, 50:] = 0.0
    return r, jx, jl


@pytest.mark.parametrize("case", ["registry48", "edx10x64"])
def test_accumulate_normal_ref_matches_repro(case):
    r, jx, jl = _normal_inputs(case)
    Y, y = marg_schur.accumulate_normal_ref(_t(r), _t(jx), _t(jl))
    ja = [jnp.asarray(x) for x in (r, jx, jl)]
    for Yj, yj in (j_marg.accumulate_normal_ref(*ja),
                   j_marg.accumulate_normal(*ja, interpret=True)):
        assert _rel(Y, Yj) <= 1e-5 and _rel(y, yj) <= 1e-5
    # the CPU wrapper is the plain version
    Yw, yw = marg_schur.accumulate_normal(_t(r), _t(jx), _t(jl))
    assert torch.equal(Yw, Y) and torch.equal(yw, y)


@pytest.mark.parametrize("case", ["registry32", "edx10x64"])
def test_accumulate_ref_matches_repro(case):
    if case == "registry32":
        _, Hpl, Hll, _, bl = (_n(x) for x in j_registry._marg_inputs(32))
        k, m = Hpl.shape[:2]
        g = Hpl.transpose(1, 0, 2, 3).reshape(m, 6 * k, 3)
        a = Hll + 1e-4 * np.eye(3, dtype=np.float32)[None]
    else:
        gt, at, bl = marg_schur._normal_tile(
            *(_t(x) for x in _normal_inputs(case)), 1e-4)
        g, a, bl = gt.numpy(), at.numpy(), bl.numpy()
    Y, y = marg_schur.accumulate_ref(_t(g), _t(a), _t(bl))
    ja = [jnp.asarray(x) for x in (g, a, bl)]
    for Yj, yj in (j_marg.accumulate_ref(*ja),
                   j_marg.accumulate(*ja, interpret=True)):
        assert _rel(Y, Yj) <= 1e-5 and _rel(y, yj) <= 1e-5
    Yw, yw = marg_schur.accumulate(_t(g), _t(a), _t(bl))
    assert torch.equal(Yw, Y) and torch.equal(yw, y)


def test_marginalize_schur_matches_dense():
    """The blocked Schur formulation == the dense elimination
    (``mapping.marginalize``), and both == repro's."""
    ins = [_n(x) for x in j_registry._marg_inputs(32)]
    h_j, b_j = j_mapping.marginalize(*(jnp.asarray(x) for x in ins))
    h_d, b_d = mapping.marginalize(*(_t(x) for x in ins))
    h_s, b_s = ba.marginalize_schur(*(_t(x) for x in ins))
    for h, b in ((h_d, b_d), (h_s, b_s)):
        np.testing.assert_allclose(h.numpy(), _n(h_j), atol=1e-4)
        np.testing.assert_allclose(b.numpy(), _n(b_j), atol=1e-4)


def test_inverse_spd_batched():
    rs = np.random.RandomState(3)
    a = rs.randn(7, 3, 3).astype(np.float32)
    s = a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(mb.inverse_spd(_t(s)).numpy(),
                               _n(jax.vmap(j_mb.inverse_spd)(s)),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# BoW
# --------------------------------------------------------------------------

def test_make_vocab_exact():
    for v in (4096, 1000):
        np.testing.assert_array_equal(tracking.make_vocab(v),
                                      j_tracking.make_vocab(v))
    assert tracking.make_vocab(4096).shape == (12, tracking.N_BITS)


def test_bow_histogram_matches_repro():
    rs = np.random.RandomState(4)
    desc = rs.rand(128, 256) > 0.5
    valid = rs.rand(128) > 0.2
    planes = tracking.make_vocab(4096)
    h = tracking.bow_histogram(_t(desc), _t(valid), _t(planes)).numpy()
    hj = _n(j_tracking.bow_histogram(jnp.asarray(desc), jnp.asarray(valid),
                                     jnp.asarray(planes)))
    assert ((h > 0) != (hj > 0)).sum() == 0          # the same words
    np.testing.assert_allclose(h, hj, rtol=1e-6, atol=1e-7)
    assert abs(np.linalg.norm(h) - 1.0) < 1e-5


# --------------------------------------------------------------------------
# mapping: residuals, normal equations, Schur solve, LM
# --------------------------------------------------------------------------

def _problems(n_valid=5):
    kf_R, kf_p, kfv, lms, lmv = _window(n_valid=n_valid)
    jst = j_ba.init_ba_state(len(kfv))._replace(
        kf_R=jnp.asarray(kf_R), kf_p=jnp.asarray(kf_p),
        kf_valid=jnp.asarray(kfv))
    tst = ba.init_ba_state(len(kfv))._replace(
        kf_R=_t(kf_R), kf_p=_t(kf_p), kf_valid=_t(kfv))
    jp = j_ba.window_problem(jst, jnp.asarray(lms), jnp.asarray(lmv),
                             jnp.asarray(INTR))
    tp = ba.window_problem(tst, _t(lms), _t(lmv), _t(INTR))
    return jp, tp


def _deltas(k, m):
    rs = np.random.RandomState(5)
    return ((rs.randn(k, 6) * 0.01).astype(np.float32),
            (rs.randn(m, 3) * 0.05).astype(np.float32))


def test_window_problem_matches_repro():
    jp, tp = _problems(n_valid=3)
    np.testing.assert_array_equal(tp.obs_valid.numpy(), _n(jp.obs_valid))
    np.testing.assert_allclose(tp.obs_uv.numpy(), _n(jp.obs_uv), rtol=1e-6,
                               atol=1e-4)
    assert 0 < tp.obs_valid.sum() < tp.obs_valid.numel()


def test_residuals_and_normal_eqs_match_repro():
    """At a seeded perturbation of the linearization point, so that the
    residuals are not zero."""
    jp, tp = _problems(n_valid=3)
    dp, dl = _deltas(*tp.obs_valid.shape)
    jr = j_mapping.residuals(jp, jnp.asarray(dp), jnp.asarray(dl))
    tr = mapping.residuals(tp, _t(dp), _t(dl))
    for a, b in zip(tr, jr):
        assert _rel(a, b) <= 1e-5
    for a, b in zip(mapping.build_normal_eqs(*tr),
                    j_mapping.build_normal_eqs(*jr)):
        assert _rel(a, b) <= 1e-4
    # at lam 10 the reduced system is well conditioned; at LM's lam0 1e-3
    # the 1e6 gauge anchor beside slots holding only lam on their
    # diagonal leaves it nearly singular in float32, where neither
    # package's solve is close to a float64 one
    jeq = j_mapping.build_normal_eqs(*jr)
    teq = mapping.build_normal_eqs(*tr)
    for a, b in zip(mapping.schur_solve(*teq, torch.tensor(10.0)),
                    j_mapping.schur_solve(*jeq, jnp.float32(10.0))):
        assert _rel(a, b) <= 1e-3


def test_lm_optimize_matches_repro():
    """LM from a window whose landmarks are perturbed (nonzero cost).
    Each LM step solves the anchored system at lam 1e-3, where the two
    f32 solves differ by up to 10% (see above), so the per-iteration
    costs are compared only at the end: both packages drive the cost to
    rounding noise. The anchor fixes pose 0 but not the scale (scaling
    every position about pose 0 leaves the projections unchanged), and
    far landmarks are weakly held in depth, so the optimum is not unique:
    the port's is checked against repro's objective instead."""
    jp, tp = _problems()
    dp, dl = _deltas(*tp.obs_valid.shape)
    jp = jp._replace(landmarks=jp.landmarks + jnp.asarray(dl))
    tp = tp._replace(landmarks=tp.landmarks + _t(dl))
    c_start = float((mapping.residuals(tp, torch.zeros(5, 6),
                                       torch.zeros(16, 3))[0] ** 2).sum())
    jo, jc = j_mapping.lm_optimize(jp, 3, 1e-3)
    to, tc = mapping.lm_optimize(tp, 3, 1e-3)
    print(f"cost {c_start:.3g} -> port {tc.tolist()}, repro {_n(jc)}")
    assert tc.shape == (3,)
    assert float(tc[-1]) <= 1e-6 * c_start and float(jc[-1]) <= 1e-6 * c_start
    # the port's optimum is an optimum of repro's objective too
    jt = jp._replace(poses_R=jnp.asarray(to.poses_R.numpy()),
                     poses_p=jnp.asarray(to.poses_p.numpy()),
                     landmarks=jnp.asarray(to.landmarks.numpy()))
    r = j_mapping.residuals(jt, jnp.zeros((5, 6)), jnp.zeros((16, 3)))[0]
    assert float(jnp.sum(r ** 2)) <= 1e-6 * c_start
    np.testing.assert_allclose(to.poses_p[0].numpy(), _n(jo.poses_p[0]),
                               atol=1e-6)                  # the anchor


# --------------------------------------------------------------------------
# the BA window
# --------------------------------------------------------------------------

def test_push_keyframe_exact():
    """Fill, then shift left once the window is full (7 pushes into 5
    slots); every leaf equals repro's after every push."""
    rs = np.random.RandomState(6)
    js, ts = j_ba.init_ba_state(5), ba.init_ba_state(5)
    for i in range(7):
        R = _rot(rs.randn(3) * 0.1).astype(np.float32)
        p = rs.randn(3).astype(np.float32)
        js = j_ba.push_keyframe(js, jnp.asarray(R), jnp.asarray(p))
        ts = ba.push_keyframe(ts, _t(R), _t(p))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), _n(b))
    assert int(ts.n_kf) == 5 and bool(ts.kf_valid.all())


def test_backproject_stereo_matches_repro():
    rs = np.random.RandomState(7)
    n = 128
    yx = np.stack([rs.randint(0, 120, n), rs.randint(0, 160, n)],
                  1).astype(np.int32)
    disp = (rs.rand(n) * 40).astype(np.float32)
    sv = rs.rand(n) > 0.3
    R = _rot(np.array([0.05, -0.02, 0.1])).astype(np.float32)
    p = np.array([1.0, -0.5, 2.0], np.float32)
    kw = dict(fx=144.0, fy=144.0, cx=80.0, cy=60.0, baseline=0.12)
    jp, jv = j_ba.backproject_stereo(*(jnp.asarray(x) for x in
                                       (yx, disp, sv, R, p)), **kw)
    tp, tv = ba.backproject_stereo(*(_t(x) for x in (yx, disp, sv, R, p)),
                                   **kw)
    np.testing.assert_array_equal(tv.numpy(), _n(jv))
    np.testing.assert_allclose(tp.numpy(), _n(jp), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("budget", [8, 16, 40])
def test_select_landmarks_exact(budget):
    """Valid first, ties in index order: the 22 invalid points of 32 tie,
    so a budget above the 10 valid ones takes them lowest index first."""
    rs = np.random.RandomState(8)
    pts = rs.randn(32, 3).astype(np.float32)
    valid = np.zeros(32, bool)
    valid[rs.choice(32, 10, replace=False)] = True
    jp, jv = j_ba.select_landmarks(jnp.asarray(pts), jnp.asarray(valid),
                                   budget)
    tp, tv = ba.select_landmarks(_t(pts), _t(valid), budget)
    np.testing.assert_array_equal(tp.numpy(), _n(jp))
    np.testing.assert_array_equal(tv.numpy(), _n(jv))


@pytest.mark.parametrize("n_valid", [5, 3])
def test_ba_round_matches_repro(n_valid):
    """A full window and one with 2 empty slots (invalid observations)."""
    kf_R, kf_p, kfv, lms, lmv = _window(n_valid=n_valid)
    jst = j_ba.init_ba_state(5)._replace(
        kf_R=jnp.asarray(kf_R), kf_p=jnp.asarray(kf_p),
        kf_valid=jnp.asarray(kfv), n_kf=jnp.int32(n_valid))
    tst = ba.init_ba_state(5)._replace(
        kf_R=_t(kf_R), kf_p=_t(kf_p), kf_valid=_t(kfv),
        n_kf=torch.tensor(n_valid, dtype=torch.int32))
    jo = j_ba.ba_round(jst, jnp.asarray(lms), jnp.asarray(lmv),
                       jnp.asarray(INTR), lm_iters=3, lm_lambda0=1e-3,
                       marg_pallas=jnp.bool_(False))
    to = ba.ba_round(tst, _t(lms), _t(lmv), _t(INTR), lm_iters=3,
                     lm_lambda0=1e-3)
    gap = _rel(to.H_prior, jo.H_prior)
    print(f"H_prior relative gap {gap:.3g}")
    assert gap <= 1e-3
    assert np.abs(to.b_prior.numpy() - _n(jo.b_prior)).max() <= 1e-2
    assert abs(float(to.last_cost) - float(jo.last_cost)) <= 1e-6


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def _snapshot(loc, state):
    st = convert.state_to_numpy(state) if isinstance(
        state.frame_idx, torch.Tensor) else jax.device_get(state)
    m = loc.map
    return dict(traj=np.asarray(loc.trajectory), ba=st.ba,
                ba_runs=loc.ba_runs, n_keyframes=len(loc._slam_keyframes),
                points=m.points.copy(), valid=m.valid.copy(),
                desc=m.descriptors.copy(), hists=m.keyframe_hists.copy())


def _reset(loc):
    loc.trajectory, loc.map, loc._slam_keyframes, loc.ba_runs = [], None, \
        [], 0


@pytest.fixture(scope="module")
def repro_slam(synthetic_sequence, small_cfg):
    """repro's runs through one Localizer (one compiled chunk program):
    all 14 frames in ``slam`` and ``mixed``, and frames 0-5 then 6-9 in
    ``slam`` with the state at frame 6 (the map restarted at frame 6)."""
    seq = synthetic_sequence
    dt = seq.dt / seq.imu_per_frame
    loc = JLocalizer(small_cfg, seq.cam, window=8)
    out = {}
    for kind in ("slam", "mixed"):
        _reset(loc)
        st = loc.run(loc.init_state(**_start(seq)),
                     *_inputs(seq, 0, N_FRAMES),
                     _envs(kind, 0, N_FRAMES, JVIO, JSLAM), dt, chunk=4)
        out[kind] = _snapshot(loc, st)
    _reset(loc)
    mid = loc.run(loc.init_state(**_start(seq)), *_inputs(seq, 0, 6), JSLAM,
                  dt, chunk=4)
    out["mid"] = jax.device_get(mid)
    _reset(loc)
    st = loc.run(mid, *_inputs(seq, 6, 10), JSLAM, dt, chunk=4)
    out["tail"] = _snapshot(loc, st)
    return out


def _assert_slam_close(got, ref):
    gap = np.linalg.norm(got["traj"] - ref["traj"], axis=1).max()
    h_gap = _rel(got["ba"].H_prior, ref["ba"].H_prior)
    b_gap = np.abs(got["ba"].b_prior - ref["ba"].b_prior).max()
    bits = (got["desc"] != ref["desc"]).sum()
    words = ((got["hists"] > 0) != (ref["hists"] > 0)).sum(axis=1)
    pt_gap = np.abs(got["points"] - ref["points"]).max()
    print(f"position gap {gap:.3g} m, H_prior relative gap {h_gap:.3g}, "
          f"b_prior gap {b_gap:.3g}, last cost "
          f"{float(got['ba'].last_cost):.3g} vs "
          f"{float(ref['ba'].last_cost):.3g}, {got['valid'].sum()} vs "
          f"{ref['valid'].sum()} valid map points within {pt_gap:.3g} m, "
          f"{bits} descriptor bits and {words.sum()} histogram words "
          f"differ")
    assert got["traj"].shape == ref["traj"].shape
    assert gap <= GAP_BOUND
    assert got["ba_runs"] == ref["ba_runs"] > 0
    assert got["ba"].n_kf == ref["ba"].n_kf
    np.testing.assert_array_equal(got["ba"].kf_valid, ref["ba"].kf_valid)
    np.testing.assert_allclose(got["ba"].kf_p, ref["ba"].kf_p, atol=1e-4)
    assert h_gap <= 1e-2
    assert b_gap <= 1e-2
    assert abs(float(got["ba"].last_cost) - float(ref["ba"].last_cost)) \
        <= 1e-6
    assert got["n_keyframes"] == ref["n_keyframes"]
    assert got["hists"].shape == ref["hists"].shape
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["points"], ref["points"], atol=1e-3)
    assert bits <= 1e-3 * got["desc"][got["valid"]].size
    assert words.max() <= 2


@pytest.mark.parametrize("kind", ["slam", "mixed"])
def test_slam_run_matches_repro(synthetic_sequence, small_cfg, repro_slam,
                                kind):
    """All 14 frames, chunk 4 (the last chunk is padded): ``slam``
    throughout, or frames 0-5 ``vio`` then 6-13 ``slam``."""
    seq = synthetic_sequence
    loc = Localizer(_port_cfg(small_cfg), seq.cam, window=8, device="cpu")
    st = loc.run(loc.init_state(**_start(seq)), *_inputs(seq, 0, N_FRAMES),
                 _envs(kind, 0, N_FRAMES, VIO, SLAM),
                 seq.dt / seq.imu_per_frame, chunk=4)
    got = _snapshot(loc, st)
    _assert_slam_close(got, repro_slam[kind])
    n_slam = N_FRAMES - (6 if kind == "mixed" else 0)
    assert got["n_keyframes"] == n_slam
    assert got["hists"].shape[0] == n_slam + 1     # the first enters twice
    assert loc.dispatch_count == 4


def test_slam_state_carry(synthetic_sequence, small_cfg, repro_slam):
    """Start the port from repro's state after 6 ``slam`` frames (the BA
    window and prior included); both run frames 6-9."""
    seq = synthetic_sequence
    st = convert.state_from_numpy(repro_slam["mid"], device="cpu")
    back = convert.state_to_numpy(st)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(repro_slam["mid"]))):
        np.testing.assert_array_equal(a, b)
    assert int(st.ba.n_kf) == 5 and bool(st.ba.H_prior.abs().max() > 0)
    loc = Localizer(_port_cfg(small_cfg), seq.cam, window=8, device="cpu")
    st = loc.run(st, *_inputs(seq, 6, 10), SLAM, seq.dt / seq.imu_per_frame,
                 chunk=4)
    got = _snapshot(loc, st)
    _assert_slam_close(got, repro_slam["tail"])


def test_slam_run_equals_step(synthetic_sequence, small_cfg):
    """``run`` with chunk 1 is the per-frame ``step`` loop, bitwise, with
    the map and BA window."""
    seq = synthetic_sequence
    cfg = _port_cfg(small_cfg)
    n = 6
    il, ir, a, g, gps = _inputs(seq, 0, n)
    dt = seq.dt / seq.imu_per_frame
    loc_r = Localizer(cfg, seq.cam, window=8, device="cpu")
    st_r = loc_r.run(loc_r.init_state(**_start(seq)), il, ir, a, g, gps,
                     SLAM, dt, chunk=1)
    loc_s = Localizer(cfg, seq.cam, window=8, device="cpu")
    st_s = loc_s.init_state(**_start(seq))
    for i in range(n):
        st_s = loc_s.step(st_s, il[i], ir[i], a[i], g[i], gps[i], SLAM, dt)
    np.testing.assert_array_equal(np.asarray(loc_r.trajectory),
                                  np.asarray(loc_s.trajectory))
    for x, y in zip(st_r.ba, st_s.ba):
        assert torch.equal(x, y)
    assert loc_r.ba_runs == loc_s.ba_runs == 2
    np.testing.assert_array_equal(loc_r.map.points, loc_s.map.points)
    np.testing.assert_array_equal(loc_r.map.keyframe_hists,
                                  loc_s.map.keyframe_hists)
