"""The port's training targets, samplers and losses against the JAX
package's functions, on the CPU: ``encode``, ``match_targets``,
``balanced_sample``, ``rpn_loss``, ``subsample_proposals``,
``box_head_loss``, ``sample_track_pairs``, ``emm_targets`` and
``emm_loss``.  The port draws its sampler priorities through ``draw``; the
test hands it the uniforms that the JAX function draws from its key
(``balanced_sample``: ``split`` into ``rng_p, rng_n``, then ``uniform``
over the pool; the EMM sampler: ``split(rng, 3)``).  Samples and masks
must agree exactly; losses and targets in f32 to 1e-5 relative (sums in
other orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import siammot_tpu.core.boxes as jax_boxes
import siammot_tpu.core.matcher as jax_matcher
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.box_head import BoxHeadConfig as JaxHeadConfig
from siammot_tpu.models.box_head import box_head_loss as jax_box_loss
from siammot_tpu.models.box_head import subsample_proposals as jax_subsample
from siammot_tpu.models.emm import EMMConfig as JaxEMMConfig
from siammot_tpu.models.emm import emm_loss as jax_emm_loss
from siammot_tpu.models.emm import emm_targets as jax_emm_targets
from siammot_tpu.models.emm import response_locations as jax_locations
from siammot_tpu.models.emm_sampler import \
    sample_track_pairs as jax_sample_pairs
from siammot_tpu.models.rpn import RPNConfig as JaxRPNConfig
from siammot_tpu.models.rpn import rpn_loss as jax_rpn_loss
from siammot_tpu_torch.core.boxes import encode
from siammot_tpu_torch.core.matcher import balanced_sample, match_targets
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.models.box_head import (BoxHeadConfig, box_head_loss,
                                               subsample_proposals)
from siammot_tpu_torch.models.emm import (EMMConfig, emm_loss, emm_targets,
                                          response_locations)
from siammot_tpu_torch.models.emm_sampler import sample_track_pairs
from siammot_tpu_torch.models.rpn import RPNConfig, grid_anchors, rpn_loss
from torch_port_util import Replay, balanced_uniforms, track_uniforms

RTOL = 1e-5


def _boxes(rng, n, lo=6, hi=60, extent=(120, 90)):
    xy = rng.uniform(0, 1, (n, 2)) * np.array(extent, np.float32)
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _gt(rng, b, g, n_valid, extent=(120, 90)):
    boxes = np.stack([_boxes(rng, g, 14, 50, extent) for _ in range(b)])
    ids = np.tile(np.arange(g, dtype=np.int32), (b, 1))
    ids[1::2] = np.roll(ids[1::2], 1, axis=1)   # the pair frame reorders
    valid = np.zeros((b, g), bool)
    valid[:, :n_valid] = True
    labels = valid.astype(np.int32)
    return boxes, ids, labels, valid


def _jboxes(boxes, scores, ids, labels, valid):
    return JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.asarray(scores),
                    ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                    valid=jnp.asarray(valid))


def _tboxes(boxes, scores, ids, labels, valid):
    return Boxes(*(torch.from_numpy(np.asarray(a))
                   for a in (boxes, scores, ids, labels, valid)))


def test_encode_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 30), _boxes(rng, 30)
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        want = np.asarray(jax_boxes.encode(jnp.asarray(a), jnp.asarray(b), w))
        got = encode(torch.from_numpy(a), torch.from_numpy(b), w).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_targets_matches_jax(low_quality):
    rng = np.random.RandomState(1)
    gt, pred = _boxes(rng, 6), _boxes(rng, 80)
    pred[:6] = gt + rng.uniform(-3, 3, gt.shape)   # some strong matches
    pred[10] = gt[2]                               # an exact tie
    gt_valid = np.array([1, 1, 1, 1, 1, 0], bool)
    pred_valid = rng.rand(80) < 0.9
    q = np.asarray(jax_boxes.box_iou(jnp.asarray(gt), jnp.asarray(pred)))
    want = jax_matcher.match_targets(jnp.asarray(q), jnp.asarray(gt_valid),
                                     jnp.asarray(pred_valid), 0.5, 0.3,
                                     low_quality)
    got = match_targets(torch.from_numpy(q), torch.from_numpy(gt_valid),
                        torch.from_numpy(pred_valid), 0.5, 0.3, low_quality)
    assert {-2, -1} <= set(np.asarray(want).tolist())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_balanced_sample_matches_jax():
    rng = np.random.RandomState(2)
    n = 300
    pos = rng.rand(2, n) < 0.2
    neg = ~pos & (rng.rand(2, n) < 0.8)
    pos[1, 40:] = False                       # few positives: negatives fill
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = [jax_matcher.balanced_sample(k, jnp.asarray(p), jnp.asarray(q),
                                        64, 0.25)
            for k, p, q in zip(keys, pos, neg)]
    got = balanced_sample(Replay(balanced_uniforms(keys, n)),
                          torch.from_numpy(pos), torch.from_numpy(neg), 64,
                          0.25)
    for i in range(2):
        for g, w in zip(got, want[i]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got[0][0].sum() == 16 and (got[0] | got[1]).sum(-1).eq(64).all()


def test_rpn_loss_matches_jax():
    rng = np.random.RandomState(4)
    b, g, size = 2, 5, (128, 96)
    strides, anchors_lvl, logits, deltas = (8, 16), [], [], []
    for s in strides:
        cell = np.array([[-s, -s, s, s], [-2 * s, -s, 2 * s, s],
                         [-s, -2 * s, s, 2 * s]], np.float32) + s / 2
        fh, fw = size[1] // s, size[0] // s
        anchors_lvl.append(grid_anchors((fh, fw), s, cell))
        logits.append(rng.randn(b, fh, fw, 3).astype(np.float32))
        deltas.append(0.2 * rng.randn(b, fh, fw, 12).astype(np.float32))
    boxes, ids, labels, valid = _gt(rng, b, g, 4, size)
    jcfg = JaxRPNConfig((8, 16), (16, 32), (0.5, 1.0, 2.0), 50, 20, 20, 0.7,
                        0, False, batch_per_image=32)
    tcfg = RPNConfig(50, 20, 20, 0.7, 0, False, batch_per_image=32)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    want = [jax_rpn_loss(k, [jnp.asarray(l[i]) for l in logits],
                         [jnp.asarray(d[i]) for d in deltas], anchors_lvl,
                         _jboxes(boxes[i], valid[i], ids[i], labels[i],
                                 valid[i]), size, jcfg)
            for i, k in enumerate(keys)]
    n = sum(len(a) for a in anchors_lvl)
    got = rpn_loss(Replay(balanced_uniforms(keys, n)),
                   [torch.from_numpy(l) for l in logits],
                   [torch.from_numpy(d) for d in deltas],
                   [torch.from_numpy(a) for a in anchors_lvl],
                   _tboxes(boxes, valid, ids, labels, valid), size, tcfg)
    for k in got:
        ref = np.mean([float(w[k]) for w in want])
        assert ref > 0, k
        np.testing.assert_allclose(float(got[k]), ref, rtol=RTOL, err_msg=k)


@pytest.fixture(scope="module")
def proposals():
    """Two frames of one clip: 40 proposals around 5 gt boxes (4 live),
    the gt appended, as ``forward_train`` builds them."""
    rng = np.random.RandomState(6)
    b, g, p = 2, 5, 40
    boxes, ids, labels, valid = _gt(rng, b, g, 4)
    props = np.concatenate(
        [np.stack([np.repeat(boxes[i], 8, 0)
                   + rng.uniform(-12, 12, (g * 8, 4)) for i in range(b)]),
         boxes], 1).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2)
    m = p + g
    scores = np.concatenate([rng.rand(b, p), np.ones((b, g))],
                            1).astype(np.float32)
    pvalid = np.concatenate([rng.rand(b, p) < 0.9, valid], 1)
    prop = (props, scores, np.full((b, m), -1, np.int32),
            np.zeros((b, m), np.int32), pvalid)
    return prop, (boxes, np.ones((b, g), np.float32), ids, labels, valid)


def test_subsample_and_box_head_loss_match_jax(proposals):
    prop, gt = proposals
    b, m = prop[4].shape
    hj = JaxHeadConfig(0.05, 0.5, 3, False, (10.0, 10.0, 5.0, 5.0),
                       batch_per_image=16)
    ht = BoxHeadConfig(0.05, 0.5, 3, False, (10.0, 10.0, 5.0, 5.0),
                       batch_per_image=16)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    want = [jax_subsample(k, _jboxes(*(a[i] for a in prop)),
                          _jboxes(*(a[i] for a in gt)), hj, 16)
            for i, k in enumerate(keys)]
    got_s, got_l, got_r = subsample_proposals(
        Replay(balanced_uniforms(keys, m)), _tboxes(*prop), _tboxes(*gt),
        ht, 16)
    for i, (ws, wl, wr) in enumerate(want):
        np.testing.assert_array_equal(got_s.valid[i].numpy(),
                                      np.asarray(ws.valid))
        np.testing.assert_array_equal(got_s.boxes[i].numpy(),
                                      np.asarray(ws.boxes))
        np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(wl))
        np.testing.assert_allclose(got_r[i].numpy(), np.asarray(wr),
                                   rtol=RTOL, atol=1e-6)
    assert (got_l > 0).any() and (got_l == 0).any()

    rng = np.random.RandomState(8)
    cl = rng.randn(b * 16, 3).astype(np.float32)
    bd = rng.randn(b * 16, 12).astype(np.float32)
    regs = got_r.reshape(-1, 4).numpy()
    labels = got_l.reshape(-1).numpy()
    valid = got_s.valid.reshape(-1).numpy()
    want = jax_box_loss(jnp.asarray(cl), jnp.asarray(bd), jnp.asarray(labels),
                        jnp.asarray(regs), jnp.asarray(valid))
    got = box_head_loss(torch.from_numpy(cl), torch.from_numpy(bd),
                        torch.from_numpy(labels), torch.from_numpy(regs),
                        torch.from_numpy(valid))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def test_sample_track_pairs_matches_jax(proposals):
    prop, gt = proposals
    b, m = prop[4].shape
    g = gt[4].shape[1]
    pair = np.arange(b) ^ 1
    gt_pair = tuple(a[pair] for a in gt)
    keys = jax.random.split(jax.random.PRNGKey(9), b)
    want = [jax_sample_pairs(k, _jboxes(*(a[i] for a in prop)),
                             jnp.asarray(prop[1][i]),
                             _jboxes(*(a[i] for a in gt)),
                             _jboxes(*(a[i] for a in gt_pair)), 12, 0.25,
                             0.25, 0.65, 0.35)
            for i, k in enumerate(keys)]
    got = sample_track_pairs(Replay(track_uniforms(keys, m, g)), _tboxes(*prop),
                             torch.from_numpy(prop[1]), _tboxes(*gt),
                             _tboxes(*gt_pair), 12, 0.25, 0.25, 0.65, 0.35)
    for i, w in enumerate(want):
        for k in ("src_boxes", "pair_boxes", "tar_boxes", "valid"):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(w[k]), err_msg=k)
    tar = got["tar_boxes"][got["valid"]]
    assert (tar == -1).all(-1).any() and (tar != -1).all(-1).any()


def test_emm_targets_and_loss_match_jax():
    rng = np.random.RandomState(10)
    k, s = 6, 16
    src = _boxes(rng, k, 20, 60)
    w = src[:, 2:] - src[:, :2] + 1
    sr = np.concatenate([src[:, :2] + 512 - w / 2, src[:, 2:] + 512 + w / 2],
                        1).astype(np.float32)
    tar = (src + rng.uniform(-6, 6, src.shape)).astype(np.float32)
    tar[4] = -1.0                                 # a dummy target
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    loc_w = np.asarray(jax_locations(jnp.asarray(sr), 30, 15, 512, 1))
    loc = response_locations(torch.from_numpy(sr), 30, 15, 512, 1)
    np.testing.assert_allclose(loc.numpy(), loc_w, rtol=RTOL, atol=1e-4)
    lab_w, reg_w = jax_emm_targets(jnp.asarray(loc_w), jnp.asarray(tar), 0.8)
    lab, reg = emm_targets(torch.from_numpy(loc_w), torch.from_numpy(tar),
                           0.8)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_w))
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_w), rtol=RTOL,
                               atol=1e-4)
    assert lab.sum() > 0

    jcfg = JaxEMMConfig(15, (0.25,), 2, 2.0, 0, 512, True, 0.4, 0.8, 1.0,
                        False)
    tcfg = EMMConfig(15, (0.25,), 2, 2.0, 0, 512, True, 0.4, False, 0.8,
                     1.0)
    cls = rng.randn(k, s, s, 2).astype(np.float32)
    ctr = rng.randn(k, s, s, 1).astype(np.float32)
    regl = (np.abs(rng.randn(k, s, s, 4)) * 20).astype(np.float32)
    want = jax_emm_loss(jnp.asarray(cls), jnp.asarray(ctr), jnp.asarray(regl),
                        jnp.asarray(loc_w), jnp.asarray(tar),
                        jnp.asarray(valid), jcfg)
    got = emm_loss(torch.from_numpy(cls), torch.from_numpy(ctr),
                   torch.from_numpy(regl), torch.from_numpy(loc_w),
                   torch.from_numpy(tar), torch.from_numpy(valid), tcfg)
    for name in want:
        assert float(want[name]) > 0, name
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=RTOL, err_msg=name)
