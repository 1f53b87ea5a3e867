"""repro_torch frontend against repro's, on the same numpy inputs.

Small size: the 120x160 synthetic sequence, 128-feature budget. Where
repro reaches a Pallas kernel it runs in interpret mode, as repro's own
tests run it. Tolerances are stated per check with their reason.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontend import fast as j_fast
from repro.core.frontend import filters as j_filters
from repro.core.frontend import optical_flow as j_flow
from repro.core.frontend import orb as j_orb
from repro.core.frontend import pipeline as j_pipeline
from repro.core.frontend import stereo as j_stereo
from repro.kernels import frontend_fused as j_ff
from repro_torch.core.frontend import fast, filters, optical_flow, orb
from repro_torch.core.frontend import pipeline, stereo
from repro_torch.kernels import frontend_fused as ff

# Descriptor bits may flip where the two frameworks round the
# orientation differently: repro sums the 149 disc moments in XLA's
# vectorized order, the port in table order (so that kernel B can repeat
# it exactly), and a pair whose two samples are within rounding of each
# other then compares the other way. Measured: 1 bit in 32768.
DESC_MISMATCH = 1e-3


@pytest.fixture(scope="module")
def fe_cfg(small_cfg):
    return small_cfg.frontend


@pytest.fixture(scope="module")
def imgs(synthetic_sequence):
    s = synthetic_sequence
    return [np.asarray(x, np.float32) for x in
            (s.images_left[0], s.images_right[0], s.images_left[1])]


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return np.asarray(x)


def test_blur_sobel_downsample_exact(imgs):
    """Shifted-slice sums in tap order: bitwise equal to repro."""
    img = imgs[0]
    np.testing.assert_array_equal(
        filters.gaussian_blur(_t(img), 2.0).numpy(),
        _n(j_filters.gaussian_blur(jnp.asarray(img), 2.0)))
    for a, b in zip(filters.sobel(_t(img)), j_filters.sobel(jnp.asarray(img))):
        np.testing.assert_array_equal(a.numpy(), _n(b))
    np.testing.assert_array_equal(
        filters.downsample2(_t(img)).numpy(),
        _n(j_filters.downsample2(jnp.asarray(img))))


def test_fast_score_and_detect_exact(imgs, fe_cfg):
    """Ring-order score sum and stable top-K: scores, corners and the
    yx of invalid slots all equal."""
    img = imgs[0]
    np.testing.assert_array_equal(
        fast.fast_score(_t(img), 20, 9).numpy(),
        _n(j_fast.fast_score(jnp.asarray(img), 20, 9)))
    a = fast.detect(_t(img), 20, fe_cfg.max_features, 8, 9)
    b = j_fast.detect(jnp.asarray(img), 20, fe_cfg.max_features, 8, 9)
    np.testing.assert_array_equal(a.yx.numpy(), _n(b.yx))
    np.testing.assert_array_equal(a.valid.numpy(), _n(b.valid))
    np.testing.assert_array_equal(a.score.numpy(), _n(b.score))
    assert int(a.valid.sum()) > 20


def test_orientation_and_descriptors(imgs, fe_cfg):
    img = imgs[0]
    smooth = _n(j_filters.gaussian_blur(jnp.asarray(img), 2.0))
    yx = _n(j_fast.detect(jnp.asarray(img), 20, fe_cfg.max_features).yx)
    a_j = _n(j_orb.orientation(jnp.asarray(smooth), jnp.asarray(yx)))
    a_t = orb.orientation(_t(smooth), _t(yx)).numpy()
    # moments summed in another order: angles agree to rounding of the
    # moment sums (tiny moments near flat patches amplify it)
    np.testing.assert_allclose(a_t, a_j, atol=1e-3)
    # same angles in: rotated-pair sampling is bit exact
    d_same = orb.describe(_t(smooth), _t(yx), _t(a_j)).numpy()
    d_j = _n(j_orb.describe(jnp.asarray(smooth), jnp.asarray(yx),
                            jnp.asarray(a_j)))
    np.testing.assert_array_equal(d_same, d_j)
    # own angles: bounded mismatch (see DESC_MISMATCH)
    d_own = orb.describe(_t(smooth), _t(yx), _t(a_t)).numpy()
    assert (d_own != d_j).mean() <= DESC_MISMATCH
    # packing: int32 bit patterns of repro's uint32 words
    np.testing.assert_array_equal(
        orb.pack_bits(_t(d_j)).numpy(),
        _n(j_orb.pack_bits(jnp.asarray(d_j))).view(np.int32))


def test_stereo_match_and_refine(imgs, fe_cfg):
    """Same descriptors in: matches exact (integer hamming distances),
    refined disparity to SAD summation order."""
    il, ir = imgs[0], imgs[1]
    fl, fr, dl, _ = j_pipeline._fe_match_ref(jnp.asarray(il),
                                             jnp.asarray(ir), fe_cfg)
    _, _, dr, _ = j_pipeline._fe_match_ref(jnp.asarray(ir),
                                           jnp.asarray(il), fe_cfg)
    kw = dict(max_disparity=96, hamming_budget=64)
    m_j = j_stereo.match(dl, fl.yx, fl.valid, dr, fr.yx, fr.valid, **kw)
    m_t = stereo.match(_t(dl), _t(fl.yx), _t(fl.valid), _t(dr), _t(fr.yx),
                       _t(fr.valid), **kw)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a.numpy(), _n(b))
    r_j = j_stereo.refine(jnp.asarray(il), jnp.asarray(ir), fl.yx, m_j)
    r_t = stereo.refine(_t(il), _t(ir), _t(fl.yx), m_t)
    np.testing.assert_array_equal(r_t.valid.numpy(), _n(r_j.valid))
    np.testing.assert_allclose(r_t.disparity.numpy(), _n(r_j.disparity),
                               atol=1e-4)


def test_lk_track(imgs, fe_cfg):
    """Pyramidal LK from frame 0 to frame 1: positions to the rounding
    of the 121-term window sums, validity exact."""
    f0 = j_fast.detect(jnp.asarray(imgs[0]), 20, fe_cfg.max_features)
    tr_j = j_flow.track(jnp.asarray(imgs[0]), jnp.asarray(imgs[2]),
                        f0.yx, f0.valid)
    tr_t = optical_flow.track(_t(imgs[0]), _t(imgs[2]), _t(f0.yx),
                              _t(f0.valid))
    np.testing.assert_array_equal(tr_t.valid.numpy(), _n(tr_j.valid))
    np.testing.assert_allclose(tr_t.yx.numpy(), _n(tr_j.yx), atol=1e-3)
    assert int(tr_t.valid.sum()) > 10


def test_step_carry_two_frames(imgs, fe_cfg):
    """The full frontend stage from the frame-0 carry into frame 1."""
    jc = j_pipeline.init_carry(fe_cfg)
    tc = pipeline.init_carry(fe_cfg)
    for il in (imgs[0], imgs[2]):
        jc, fr_j = j_pipeline.step_carry(jc, jnp.asarray(il),
                                         jnp.asarray(imgs[1]), fe_cfg)
        tc, fr_t = pipeline.step_carry(tc, _t(il), _t(imgs[1]), fe_cfg)
        for name in ("yx", "valid", "score", "stereo_valid", "track_valid"):
            np.testing.assert_array_equal(getattr(fr_t, name).numpy(),
                                          _n(getattr(fr_j, name)), name)
        np.testing.assert_allclose(fr_t.disparity.numpy(),
                                   _n(fr_j.disparity), atol=1e-4)
        np.testing.assert_allclose(fr_t.prev_yx.numpy(), _n(fr_j.prev_yx),
                                   atol=1e-3)
        assert (fr_t.desc.numpy() != _n(fr_j.desc)).mean() <= DESC_MISMATCH
    np.testing.assert_array_equal(tc.prev_img.numpy(), _n(jc.prev_img))


@pytest.mark.parametrize("max_features", [128, 512])
def test_plain_kernels_match_pallas(imgs, fe_cfg, max_features):
    """The three plain kernel versions, composed as ``fe_match`` on the
    CPU, against repro's Pallas kernels in interpret mode. 120x160 has
    300 NMS cells, so a 512 budget takes the pad path."""
    cfg = dataclasses.replace(fe_cfg, max_features=max_features)
    il, ir = imgs[0], imgs[1]
    fl_j, fr_j, dl_j, m_j = j_ff.fe_match(jnp.asarray(il), jnp.asarray(ir),
                                          cfg, interpret=True)
    fl_t, fr_t, dl_t, m_t = ff.fe_match(_t(il), _t(ir), cfg)
    assert fl_t.yx.shape == (max_features, 2)
    for a, b in ((fl_t, fl_j), (fr_t, fr_j)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), _n(y))
    assert (dl_t.numpy() != _n(dl_j)).mean() <= DESC_MISMATCH
    for x, y in zip(m_t, m_j):
        np.testing.assert_array_equal(x.numpy(), _n(y))
    # the unfused reference composition gives the same tuple
    fl_r, fr_r, dl_r, m_r = pipeline._fe_match_ref(_t(il), _t(ir), cfg)
    for x, y in zip(fl_r + fr_r + m_r, fl_t + fr_t + m_t):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(dl_r.numpy(), dl_t.numpy())


def test_kernel_b_and_c_plain_on_pallas_inputs(imgs, fe_cfg):
    """Kernels B and C alone, each fed the Pallas pipeline's own inputs."""
    il, ir = imgs[0], imgs[1]
    smooth = j_filters.gaussian_blur(jnp.asarray(il), 2.0)
    fl, _, _ = j_ff._detect_describe(jnp.asarray(il), fe_cfg, True)
    fr, _, pk_r = j_ff._detect_describe(jnp.asarray(ir), fe_cfg, True)
    d_j, pk_j = j_ff._describe(smooth, fl.yx, True)
    d_t, pk_t = ff.fc_describe(_t(smooth), _t(fl.yx))
    assert d_t.dtype == torch.uint8 and pk_t.dtype == torch.int32
    assert (d_t.numpy() != _n(d_j)).mean() <= DESC_MISMATCH
    kw = dict(max_disparity=fe_cfg.stereo_max_disparity,
              hamming_budget=fe_cfg.stereo_hamming_budget)
    m_j = j_ff.match_packed(pk_j, fl.yx, fl.valid, pk_r, fr.yx, fr.valid,
                            interpret=True, **kw)
    m_t = ff.match_packed(_t(_n(pk_j).view(np.int32)), _t(fl.yx),
                          _t(fl.valid), _t(_n(pk_r).view(np.int32)),
                          _t(fr.yx), _t(fr.valid), **kw)
    for x, y in zip(m_t, m_j):
        np.testing.assert_array_equal(x.numpy(), _n(y))
    assert int(m_t.valid.sum()) > 0


def test_wrappers_take_plain_versions_on_cpu(imgs, fe_cfg):
    """A CPU tensor goes to the plain version; the launch counters only
    move for kernel launches."""
    before = dict(ff.LAUNCHES)
    a = ff.fe_detect(_t(imgs[0]), fe_cfg)
    b = ff.fe_detect_ref(_t(imgs[0]), fe_cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ff.LAUNCHES == before

