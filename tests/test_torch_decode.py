"""Kernel 4 (masked EMM response decode) of the port against the JAX
package: the Pallas kernel ``emm_decode_pallas`` with ``valid`` in
interpret mode, and the whole ``decode_response_fused`` (XLA form) with
its box epilogue, dead slots in each.  Seeded numpy inputs.  Tolerance:
idx exact, scores 1e-6, boxes 1e-4 px (f32 on both sides)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.models.emm import EMMConfig as JaxEMMConfig
from siammot_tpu.models.emm import _hann_window as jax_hann
from siammot_tpu.models.emm import decode_response_fused as jax_decode
from siammot_tpu.ops.pallas.decode import emm_decode_pallas
from siammot_tpu.ops.upsample import bicubic_matrix as jax_bicubic
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.models.emm import (EMMConfig, _hann_window,
                                          decode_response_fused)
from siammot_tpu_torch.ops.decode import emm_decode
from siammot_tpu_torch.ops.upsample import bicubic_matrix

K, S, UP = 6, 16, 16


def _inputs(seed, ecfg):
    rng = np.random.RandomState(seed)
    cls_l = rng.randn(K, S, S, 2).astype(np.float32)
    ctr_l = rng.randn(K, S, S, 1).astype(np.float32)
    reg_l = (np.abs(rng.randn(K, S, S, 4)) * 20).astype(np.float32)
    x1y1 = rng.uniform(0, 200, (K, 2))
    wh = rng.uniform(30, 120, (K, 2))
    tmpl = np.concatenate([x1y1, x1y1 + wh], 1).astype(np.float32)
    sr = tmpl + ecfg.pad_pixels
    ext = (sr[:, 2:] - sr[:, :2]) / 2.0
    sr = np.concatenate([sr[:, :2] - ext, sr[:, 2:] + ext], 1)
    valid = np.array([True, False, True, True, False, True])
    # a dead slot carries an all-zero box, as the track state holds it
    tmpl[~valid] = 0.0
    return cls_l, ctr_l, reg_l, sr.astype(np.float32), tmpl, valid


def test_constants_match_jax():
    np.testing.assert_array_equal(bicubic_matrix(S, UP),
                                  jax_bicubic(S, UP))
    np.testing.assert_array_equal(_hann_window(S * UP), jax_hann(S * UP))


@pytest.mark.parametrize("use_centerness", [True, False])
def test_decode_matches_pallas_interpret(use_centerness):
    ecfg = JaxEMMConfig.from_cfg(jax_get_cfg())
    cls_l, ctr_l, reg_l, _, tmpl, valid = _inputs(1, ecfg)
    x4 = np.stack([cls_l[..., 1] - cls_l[..., 0], ctr_l[..., 0],
                   reg_l[..., 0] + reg_l[..., 2],
                   reg_l[..., 1] + reg_l[..., 3]], 1)
    wh = np.stack([tmpl[:, 2] - tmpl[:, 0], tmpl[:, 3] - tmpl[:, 1]], -1)
    u = bicubic_matrix(S, UP)
    window = _hann_window(S * UP).reshape(S * UP, S * UP)
    # the JAX wrapper guards zero extents before the kernel; the port's
    # kernel guards them itself
    wh_guarded = np.where(wh == 0, 1.0, wh).astype(np.float32)
    want_i, want_s = emm_decode_pallas(
        jnp.asarray(x4), jnp.asarray(wh_guarded), jnp.asarray(u),
        jnp.asarray(window), jnp.asarray(valid), sigma=0.4,
        use_centerness=use_centerness, up_scale=UP, interpret=True)
    got_i, got_s = emm_decode(torch.from_numpy(x4), torch.from_numpy(wh),
                              torch.from_numpy(u), torch.from_numpy(window),
                              torch.from_numpy(valid), 0.4, use_centerness)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_i.numpy()[~valid], 0)
    np.testing.assert_array_equal(got_s.numpy()[~valid], 0.0)


@pytest.mark.parametrize("seed", [2, 3])
def test_decode_response_fused_matches_xla(seed):
    ecfg = EMMConfig.from_cfg(get_cfg())
    jecfg = JaxEMMConfig.from_cfg(jax_get_cfg())
    cls_l, ctr_l, reg_l, sr, tmpl, valid = _inputs(seed, jecfg)
    want_b, want_s = jax_decode(*map(jnp.asarray, (cls_l, ctr_l, reg_l, sr,
                                                    tmpl)), jecfg, UP,
                                use_pallas=False)
    got_b, got_s = decode_response_fused(
        *map(torch.from_numpy, (cls_l, ctr_l, reg_l, sr, tmpl)), ecfg, UP,
        torch.from_numpy(valid))
    want_b, want_s = np.asarray(want_b), np.asarray(want_s)
    np.testing.assert_allclose(got_b.numpy()[valid], want_b[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy()[valid], want_s[valid], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_s.numpy()[~valid], 0.0)
    assert np.isfinite(got_b.numpy()).all()
