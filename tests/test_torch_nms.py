"""The port's fixed-point NMS against serial greedy NMS (maskrcnn
semantics, +1 IoU convention) and against the JAX ``nms_mask`` /
``batched_nms_mask``: the keep sets must be identical."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jax

from siammot_tpu.core import nms as jax_nms_mod
from siammot_tpu_torch.core.nms import batched_nms_mask, nms_mask


jax_nms = jax.jit(jax_nms_mod.nms_mask, static_argnums=(3,),
                  static_argnames=("max_out", "presorted"))
jax_batched_nms = jax.jit(jax_nms_mod.batched_nms_mask, static_argnums=(4,))


def _serial_greedy(boxes, scores, valid, thresh):
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    keep = np.zeros(len(boxes), bool)
    area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    kept = []
    for i in order:
        if not valid[i]:
            continue
        ok = True
        for j in kept:
            lt = np.maximum(boxes[i, :2], boxes[j, :2])
            rb = np.minimum(boxes[i, 2:], boxes[j, 2:])
            wh = np.clip(rb - lt + 1, 0, None)
            inter = wh[0] * wh[1]
            if inter / max(area[i] + area[j] - inter, 1e-12) > thresh:
                ok = False
                break
        if ok:
            kept.append(i)
            keep[i] = True
    return keep


def _boxes(rng, n, spread=200.0):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed,n,thresh", [(0, 60, 0.5), (1, 200, 0.7),
                                           (2, 120, 0.3)])
def test_nms_equals_serial_greedy(seed, n, thresh):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, n, spread=120.0)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.85
    want = _serial_greedy(boxes, scores, valid, thresh)
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), thresh).numpy()
    np.testing.assert_array_equal(got, want)
    jax_keep = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(got, jax_keep)


def test_deep_suppression_chain_runs_past_static_rounds():
    """A chain of 40 boxes each overlapping only the next needs more than
    the 16 static rounds; the convergence loop must finish it."""
    n = 40
    x = np.arange(n, dtype=np.float32) * 6.0
    boxes = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)],
                     1).astype(np.float32)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    valid = np.ones(n, bool)
    want = _serial_greedy(boxes, scores, valid, 0.3)
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_batched_presorted_with_max_out_matches_jax():
    """Leading batch dims (the RPN's per-level sets), presorted input and
    a max_out cap, against the JAX function vmapped set by set."""
    rng = np.random.RandomState(3)
    sets, n = 3, 50
    boxes = _boxes(rng, sets * n, 100.0).reshape(sets, n, 4)
    scores = -np.sort(-rng.rand(sets, n), axis=1).astype(np.float32)
    valid = np.ones((sets, n), bool)
    valid[:, -7:] = False
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), 0.7, max_out=10,
                   presorted=True).numpy()
    for i in range(sets):
        want = np.asarray(jax_nms(jnp.asarray(boxes[i]),
                                  jnp.asarray(scores[i]),
                                  jnp.asarray(valid[i]), 0.7, max_out=10,
                                  presorted=True))
        np.testing.assert_array_equal(got[i], want)
        assert got[i].sum() <= 10


def test_batched_nms_mask_matches_jax():
    rng = np.random.RandomState(4)
    n = 80
    boxes = _boxes(rng, n, 100.0)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) < 0.9
    idxs = rng.randint(0, 3, n).astype(np.int32)
    got = batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), torch.from_numpy(idxs),
                           0.5).numpy()
    want = np.asarray(jax_batched_nms(jnp.asarray(boxes),
                                      jnp.asarray(scores),
                                      jnp.asarray(valid),
                                      jnp.asarray(idxs), 0.5))
    np.testing.assert_array_equal(got, want)
