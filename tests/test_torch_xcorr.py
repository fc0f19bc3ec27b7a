"""Kernel 2 (masked depthwise xcorr) of the port against the JAX package:
the Pallas kernel with ``valid`` in interpret mode, and the XLA
``xcorr_depthwise`` on the live slots.  Seeded numpy inputs; f32 on both
sides, sums in the same i-major order -> 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from siammot_tpu.ops.pallas.xcorr import xcorr_depthwise_pallas
from siammot_tpu.ops.xcorr import xcorr_depthwise
from siammot_tpu_torch.ops.xcorr import xcorr_depthwise_masked

TOL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    s = rng.randn(5, 12, 12, 128).astype(np.float32)
    t = rng.randn(5, 5, 5, 128).astype(np.float32)
    valid = np.array([True, False, True, True, False])
    return s, t, valid


def test_masked_xcorr_matches_pallas_interpret(inputs):
    s, t, valid = inputs
    want = xcorr_depthwise_pallas(jnp.asarray(s), jnp.asarray(t),
                                  jnp.asarray(valid), interpret=True)
    got = xcorr_depthwise_masked(torch.from_numpy(s), torch.from_numpy(t),
                                 torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (5, 8, 8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.numpy()[~valid], 0.0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_masked_xcorr_live_slots_match_xla(inputs, dtype):
    s, t, valid = inputs
    if dtype == "bfloat16":
        js, jt = jnp.asarray(s, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16)
        ts = torch.from_numpy(s).to(torch.bfloat16)
        tt = torch.from_numpy(t).to(torch.bfloat16)
    else:
        js, jt = jnp.asarray(s), jnp.asarray(t)
        ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    # the XLA form sums the bf16 products in f32 too, then rounds to the
    # input dtype: compare in f32 against its f32-accumulated value
    want = np.asarray(xcorr_depthwise(js.astype(jnp.float32),
                                      jt.astype(jnp.float32)))
    got = xcorr_depthwise_masked(ts, tt, torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)
