"""Kernels 10 and 5 (the unmasked and the row-striped EMM decode) of the
port against the JAX package's Pallas kernel ``emm_decode_pallas`` in
interpret mode: without ``valid`` (kernel 10) at [4, 4, 16, 16]; with a
forced ``stripe`` at s_hi 256; in the striped form JAX picks past s_hi 512
at s 33 (s_hi 528, stripe 16) and s 61 (s_hi 976, stripe 16), K = 2, gated
and ungated.  Seeded numpy inputs.  Tolerance: idx exact, scores 1e-6
(f32 on both sides); the port's striped and whole-map plain versions
bitwise equal to each other (one contraction per cell, a running argmax
whose ties go to the earlier stripe)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from siammot_tpu.ops.pallas.decode import emm_decode_pallas
from siammot_tpu_torch.models.emm import _hann_window
from siammot_tpu_torch.ops.decode import (decode_argmax, emm_decode_plain,
                                          emm_decode_striped,
                                          emm_decode_striped_plain,
                                          emm_decode_unmasked, pick_stripe)
from siammot_tpu_torch.ops.upsample import bicubic_matrix

UP = 16


def _inputs(k, s, seed, dead=()):
    rng = np.random.RandomState(seed)
    x4 = np.stack([2 * rng.randn(k, s, s), rng.randn(k, s, s),
                   60 + 20 * rng.randn(k, s, s),
                   120 + 40 * rng.randn(k, s, s)], 1).astype(np.float32)
    wh = np.stack([rng.uniform(40, 150, k), rng.uniform(80, 300, k)],
                  -1).astype(np.float32)
    valid = np.ones(k, bool)
    valid[list(dead)] = False
    wh[~valid] = 0.0           # a dead slot's box is all zeros
    u = bicubic_matrix(s, UP)
    window = _hann_window(s * UP).reshape(s * UP, s * UP)
    return x4, wh, u, window, valid


def _jax(x4, wh, u, window, valid, stripe=None):
    wh = np.where(wh == 0, 1.0, wh).astype(np.float32)
    i, s = emm_decode_pallas(
        jnp.asarray(x4), jnp.asarray(wh), jnp.asarray(u),
        jnp.asarray(window), None if valid is None else jnp.asarray(valid),
        sigma=0.4, use_centerness=True, up_scale=UP, stripe=stripe,
        interpret=True)
    return np.asarray(i), np.asarray(s)


def _t(*a):
    return [None if x is None else torch.from_numpy(x) for x in a]


def test_unmasked_matches_pallas_interpret():
    x4, wh, u, window, _ = _inputs(4, 16, 0, dead=(1,))
    want_i, want_s = _jax(x4, wh, u, window, None)
    got_i, got_s = emm_decode_unmasked(*_t(x4, wh, u, window), 0.4, True)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    # the dead slot decodes its maps: not (0, 0)
    assert got_s[1] > 0
    d_i, d_s = decode_argmax(*_t(x4, wh, u, window), None, 0.4, True)
    np.testing.assert_array_equal(d_i.numpy(), got_i.numpy())


def test_forced_stripe_matches_pallas_and_whole_map():
    x4, wh, u, window, valid = _inputs(4, 16, 1, dead=(2,))
    want_i, want_s = _jax(x4, wh, u, window, valid, stripe=64)
    got_i, got_s = emm_decode_striped(*_t(x4, wh, u, window, valid), 0.4,
                                      True, 64)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    whole_i, whole_s = emm_decode_plain(*_t(x4, wh, u, window, valid), 0.4,
                                        True)
    np.testing.assert_array_equal(got_i.numpy(), whole_i.numpy())
    np.testing.assert_array_equal(got_s.numpy(), whole_s.numpy())


@pytest.mark.parametrize("s", [33, 61])
@pytest.mark.parametrize("gated", [True, False])
def test_striped_matches_pallas_interpret(s, gated):
    x4, wh, u, window, valid = _inputs(2, s, 10 + s, dead=(1,))
    valid = valid if gated else None
    s_hi = s * UP
    assert s_hi > 512 and pick_stripe(s_hi) == 16
    want_i, want_s = _jax(x4, wh, u, window, valid)
    got_i, got_s = decode_argmax(*_t(x4, wh, u, window, valid), 0.4, True)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    if gated:
        assert got_i[1] == 0 and got_s[1] == 0
    # the striped plain version is the whole-map one, bit for bit
    whole_i, whole_s = emm_decode_plain(*_t(x4, wh, u, window, valid), 0.4,
                                        True)
    np.testing.assert_array_equal(got_i.numpy(), whole_i.numpy())
    np.testing.assert_array_equal(got_s.numpy(), whole_s.numpy())


def test_striped_plain_ties_and_nan_keep_the_first():
    """A tie across stripes goes to the earlier stripe, and the first NaN
    wins, as with a whole-map ``argmax``."""
    x4, wh, u, window, valid = _inputs(2, 16, 3)
    window_tie = np.zeros_like(window)
    window_tie[10, 5] = window_tie[200, 7] = 1.0
    x4z = np.zeros_like(x4)
    wh1 = np.ones_like(wh)
    i, _ = emm_decode_striped_plain(*_t(x4z, wh1, u, window_tie, valid),
                                    0.4, True, 8)
    np.testing.assert_array_equal(i.numpy(), 10 * 256 + 5)
    x4n = x4.copy()
    x4n[0, 0, 5, 5] = np.nan
    i_s, _ = emm_decode_striped_plain(*_t(x4n, wh, u, window, valid), 0.4,
                                      True, 32)
    i_w, _ = emm_decode_plain(*_t(x4n, wh, u, window, valid), 0.4, True)
    np.testing.assert_array_equal(i_s.numpy(), i_w.numpy())


def test_stripe_must_divide_the_map():
    x4, wh, u, window, valid = _inputs(1, 16, 4)
    with pytest.raises(ValueError):
        emm_decode_striped(*_t(x4, wh, u, window, valid), 0.4, True, 48)
    with pytest.raises(ValueError):
        decode_argmax(*_t(*_inputs(1, 65, 5)[:4], None), 0.4, True)


def test_decode_bands_cover_the_map():
    """The kernel's bands of ``BAND_ROWS`` rows (the scratch rows a slot):
    they cover the map, the last one ragged where s_hi is not a multiple
    (up 8 at s 13: 104 rows), none empty."""
    from siammot_tpu_torch.ops.decode import BAND_ROWS, decode_bands
    for s_hi, want in ((256, 16), (464, 29), (976, 61), (104, 7),
                       (528, 33), (1, 1)):
        n = decode_bands(s_hi)
        assert n == want
        assert (n - 1) * BAND_ROWS < s_hi <= n * BAND_ROWS
