"""Kernel 3 (masked EMM predictor) of the port against the JAX package:
the Pallas kernel ``emm_predictor_pallas`` in interpret mode, live and
dead slots, f32 and bf16 responses.  The port's plain version repeats the
kernel's math (f32 products, f32 sums, tower rounded to the response
dtype).  Tolerance: f32 -> 1e-4 (sums in another order); bf16 -> the
tower's bf16 rounding can flip by one unit, which moves a logit by up to
~3e-2 (the tolerance the card check uses too)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.models.emm import EMMPredictor as JaxEMMPredictor
from siammot_tpu.ops.pallas.predictor import emm_predictor_pallas
from siammot_tpu_torch.models.emm import EMMPredictor
from siammot_tpu_torch.utils.weights import jax_to_torch

K, S, C = 4, 16, 128


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    x = rng.randn(K, S, S, C).astype(np.float32)
    variables = JaxEMMPredictor(channels=C).init(jax.random.PRNGKey(3),
                                                 jnp.asarray(x))
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, jax.device_get(variables["params"]))
    valid = np.array([True, False, True, True])
    return x, params, valid


def _flat(params):
    return {f"params/emm/predictor/{m}/{leaf}": v
            for m, sub in params.items() for leaf, v in sub.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_predictor_matches_pallas_interpret(setup, dtype, tol):
    x, params, valid = setup
    jdt = jnp.dtype(dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    want = emm_predictor_pallas(jnp.asarray(x, jdt), jnp.asarray(valid),
                                jparams, interpret=True)

    tdt = getattr(torch, dtype)
    sd = {k[len("emm.predictor."):]: v
          for k, v in jax_to_torch(_flat(params)).items()}
    module = EMMPredictor(C).to(tdt)
    module.load_state_dict(sd, strict=True)
    got = module(torch.from_numpy(x).to(tdt), torch.from_numpy(valid))
    for g, w, name in zip(got, want, ("cls", "center", "reg")):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g[~valid], 0.0, err_msg=name)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_predictor_keys_follow_the_flax_tree(setup):
    _, params, _ = setup
    module = EMMPredictor(C)
    want = {f"{m}.{leaf}" for m, sub in params.items() for leaf in sub}
    assert set(module.state_dict()) == want
    assert module.cls_tower_conv.kernel.shape == (3, 3, C, C)
