"""Kernel 3 (masked EMM predictor) of the port against the JAX package:
the Pallas kernel ``emm_predictor_pallas`` in interpret mode, live and
dead slots, f32 and bf16 responses.  The port's plain version repeats the
kernel's math (f32 products, f32 sums, tower rounded to the response
dtype).  Tolerance: f32 -> 1e-4 (sums in another order); bf16 -> the
tower's bf16 rounding can flip by one unit, which moves a logit by up to
~3e-2 (the tolerance the card check uses too).  The head pass's host plan
(band sizes, shared memory, the statistics' tile count) is checked here
too: the kernel itself runs only on the card (``test_torch_cuda.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.models.emm import EMMPredictor as JaxEMMPredictor
from siammot_tpu.ops.pallas.predictor import emm_predictor_pallas
from siammot_tpu_torch.models.emm import EMMPredictor
from siammot_tpu_torch.ops.predictor import (HEAD_BAND, HEAD_ITEMS,
                                             head_plan, head_rows,
                                             head_smem, stat_tiles)
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


# -- the head pass's host plan (ops/predictor.py:head_plan) ----------------

H100_SMEM = 232448   # bytes a block may opt in to on the H100


@pytest.mark.parametrize("s,c,planes", [
    (16, 128, 8), (29, 128, 8), (61, 128, 1), (13, 64, 4), (11, 32, 2),
    (75, 96, 6)])
def test_head_plan_takes_all_planes_where_they_fit(s, c, planes):
    """Every plane in one stage where that fits (the main path's 16x16
    and the AOT recipe's 29x29), else one plane a stage (SEARCH_REGION
    5's 61x61)."""
    pps, smem = head_plan(s, c, H100_SMEM)
    assert pps == planes
    assert smem == head_smem(s, c, pps) <= H100_SMEM
    assert c // 16 % pps == 0
    if pps == 1:
        assert head_smem(s, c, c // 16) > H100_SMEM


@pytest.mark.parametrize("s", [4, 11, 13, 16, 29, 46, 61, 75])
def test_head_band_stages_every_row_it_needs(s):
    """Each band of 256 consecutive positions (starting mid-row at S 13,
    29, 61) touches rows ya .. yb; with the halo it stages ya - 1 .. yb +
    1, never more rows than the kernel's shared memory holds
    (``head_rows``), and the bands cover every position once."""
    seen = np.zeros(s * s, int)
    for p0 in range(0, s * s, HEAD_BAND):
        p1 = min(p0 + HEAD_BAND, s * s)
        seen[p0:p1] += 1
        assert (p1 - 1) // s - p0 // s + 3 <= head_rows(s)
    assert (seen == 1).all()
    assert head_rows(s) <= s + 2
    assert HEAD_BAND == 4 * HEAD_ITEMS


def test_head_plan_budget():
    """Shared memory of a head block: the staged rows of a stage's
    16-channel planes, the head weights as 4 outputs a channel, the
    per-channel normalisation and the statistics; the plan takes one
    plane a stage where all planes do not fit, and raises with the limit
    where one plane does not (1280 channels' head weights)."""
    assert head_smem(16, 128, 4) == 4 * 18 * 18 * 64 + 9 * 128 * 16 \
        + 4 * 128 * 4 + 8 * 32 * 8 + 2 * 32 * 4
    assert head_plan(16, 128, head_smem(16, 128, 8) - 1)[0] == 1
    assert head_plan(61, 128, head_smem(61, 128))[0] == 1
    with pytest.raises(ValueError, match="bytes of shared memory"):
        head_plan(61, 128, head_smem(61, 128) - 1)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        head_plan(61, 1280, H100_SMEM)


@pytest.mark.parametrize("s,c,dtype,tiles", [
    (16, 128, torch.bfloat16, 2), (61, 128, torch.bfloat16, 30),
    (16, 128, torch.float32, 8), (29, 96, torch.float32, 28),
    (13, 64, torch.bfloat16, 2), (11, 256, torch.bfloat16, 2)])
def test_stat_tiles_count_the_tower_blocks(s, c, dtype, tiles):
    """One set of GroupNorm partials for each tower conv block of a slot
    and tower: position bands (128 in bf16, 64 in f32) x channel tiles."""
    assert stat_tiles(s, c, dtype) == tiles
