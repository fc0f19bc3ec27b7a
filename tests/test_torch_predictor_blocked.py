"""Kernel 8 (the slot-blocked EMM predictor) of the port against the JAX
package: the Pallas kernel ``emm_predictor_pallas_blocked`` in interpret
mode at [8, 16, 16, 32] with ``block`` 4, one block with no live slot and
one mixed block, f32 and bf16 responses.  Tolerance: f32 within 1e-5 of
each output's largest magnitude (sums in another order); bf16 3e-2, the
per-slot predictor's tolerance (the tower's bf16 rounding can flip by one
unit, which moves a logit by up to ~3e-2).  The blocked plain version
equals the per-slot one, and the per-slot path through the module
dispatch takes the blocked kernel only under ``SIAMMOT_PREDICTOR_BLOCK``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.models.emm import EMMPredictor as JaxEMMPredictor
from siammot_tpu.ops.pallas.predictor import emm_predictor_pallas_blocked
from siammot_tpu_torch.models.emm import EMMPredictor, predictor_block
from siammot_tpu_torch.ops.predictor import (emm_predictor_blocked,
                                             emm_predictor_plain)
from siammot_tpu_torch.utils.weights import jax_to_torch

K, S, C, B = 8, 16, 32, 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(7)
    x = rng.randn(K, S, S, C).astype(np.float32)
    variables = JaxEMMPredictor(channels=C).init(jax.random.PRNGKey(5),
                                                 jnp.asarray(x))
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, jax.device_get(variables["params"]))
    # block 0 has no live slot, block 1 is mixed
    valid = np.array([False, False, False, False, True, False, True, True])
    return x, params, valid


def _torch_params(params, dtype):
    flat = {f"params/emm/predictor/{m}/{leaf}": v
            for m, sub in params.items() for leaf, v in sub.items()}
    return {k[len("emm.predictor."):]: v.to(dtype)
            for k, v in jax_to_torch(flat).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matches_pallas_interpret(setup, dtype):
    x, params, valid = setup
    jdt = jnp.dtype(dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    want = emm_predictor_pallas_blocked(jnp.asarray(x, jdt),
                                        jnp.asarray(valid), jparams,
                                        block=B, interpret=True)
    tdt = getattr(torch, dtype)
    tp = _torch_params(params, tdt)
    tx, tv = torch.from_numpy(x).to(tdt), torch.from_numpy(valid)
    got = emm_predictor_blocked(tx, tv, tp, B)
    per_slot = emm_predictor_plain(tx, tv, tp)
    for g, w, p, name in zip(got, want, per_slot, ("cls", "center", "reg")):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g[~valid], 0.0, err_msg=name)
        tol = 1e-5 * np.abs(w).max() if dtype == "float32" else 3e-2
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_array_equal(g, p.numpy(), err_msg=name)


def test_block_must_divide_the_slots(setup):
    x, params, valid = setup
    tp = _torch_params(params, torch.float32)
    with pytest.raises(ValueError):
        emm_predictor_blocked(torch.from_numpy(x), torch.from_numpy(valid),
                              tp, 3)


def test_module_reads_the_block_where_jax_does(setup, monkeypatch):
    """``SIAMMOT_PREDICTOR_BLOCK`` is read at the predictor call; B > 1
    with K % B == 0 takes kernel 8, anything else kernel 3, and both give
    the same outputs."""
    x, params, valid = setup
    module = EMMPredictor(C)
    module.load_state_dict(_torch_params(params, torch.float32))
    tx, tv = torch.from_numpy(x), torch.from_numpy(valid)
    for env, want in (("0", None), ("1", None), ("3", None), ("4", 4),
                      ("8", 8)):
        monkeypatch.setenv("SIAMMOT_PREDICTOR_BLOCK", env)
        assert predictor_block(K) == want
        for a, b in zip(module(tx, tv), emm_predictor_plain(
                tx, tv, {n: p.detach() for n, p in
                         module.named_parameters()})):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    monkeypatch.delenv("SIAMMOT_PREDICTOR_BLOCK")
    assert predictor_block(K) is None
