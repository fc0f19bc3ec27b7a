"""Modules of the port's slice against their JAX counterparts on the CPU,
one by one, with seeded numpy inputs: box ops, anchors, the uint8
normalisation, DLA-MINI + FPN features, RPN proposal selection, the box
head's track-aware post-processing, and the solver with the state
rebuild.  f32 on both sides: features to 1e-4, boxes to 1e-4 px,
masks/ids exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core import boxes as jbox
from siammot_tpu.core.structures import Boxes as JBoxes
from siammot_tpu.models import rpn as jrpn
from siammot_tpu.models.box_head import BoxHeadConfig as JHeadCfg
from siammot_tpu.models.box_head import postprocess as jpostprocess
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.models.siammot import normalize_images as jnormalize
from siammot_tpu.models.track_solver import SolverConfig as JSolverCfg
from siammot_tpu.models.track_solver import solve as jsolve
from siammot_tpu.models.track_state import TrackState as JState
from siammot_tpu.models.track_state import rebuild_state as jrebuild
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core import boxes as tbox
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.models import rpn as trpn
from siammot_tpu_torch.models.box_head import BoxHeadConfig, postprocess
from siammot_tpu_torch.models.siammot import SiamMOT, normalize_images
from siammot_tpu_torch.models.track_solver import SolverConfig, solve
from siammot_tpu_torch.models.track_state import TrackState, rebuild_state
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n):
    xy = rng.uniform(-20, 300, (n, 2))
    wh = rng.uniform(2, 120, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("op", ["iou", "decode", "clip", "extend", "levels"])
def test_box_ops_match_jax(op):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 20), _boxes(rng, 15)
    codes = rng.randn(20, 8).astype(np.float32)
    if op == "iou":
        got, want = tbox.box_iou(_t(a), _t(b)), jbox.box_iou(a, b)
    elif op == "decode":
        got, want = tbox.decode(_t(codes), _t(a)), jbox.decode(codes, a)
    elif op == "clip":
        got = tbox.clip_to_image(_t(a), (160, 120))
        want = jbox.clip_to_image(a, (160, 120))
    elif op == "extend":
        got = tbox.extend_box(_t(a), 1.0, 30.0)
        want = jbox.extend_box(a, 1.0, 30.0)
    else:
        from siammot_tpu.ops.roi_align import map_rois_to_levels
        got = tbox.map_rois_to_levels(_t(a), 2, 5)
        want = map_rois_to_levels(a, 2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)


def test_anchors_match_jax():
    for stride, size in ((4, 32), (16, 128), (64, 512)):
        cell = trpn.base_anchors(stride, size, (0.5, 1.0, 2.0))
        np.testing.assert_array_equal(
            cell, jrpn.base_anchors(stride, size, (0.5, 1.0, 2.0)))
        np.testing.assert_array_equal(
            trpn.grid_anchors((5, 7), stride, cell),
            jrpn.grid_anchors((5, 7), stride, cell))


def test_normalize_rezeroes_pad_like_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (1, 32, 48, 3)).astype(np.uint8)
    cfg = get_cfg()
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD
    got = normalize_images(_t(img), mean, std,
                           frame_sizes=torch.tensor([[40, 30]]))
    want = jnormalize(jnp.asarray(img), mean, std,
                      frame_sizes=jnp.asarray([[40, 30]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got[0, 30:] == 0).all() and (got[0, :, 40:] == 0).all()


@pytest.fixture(scope="module")
def mini_models():
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(MINI)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (64, 96), seed=2)
    params = jax.tree.map(jnp.asarray, unflatten_params(flat))
    cfg = get_cfg()
    cfg.merge_from_list(MINI)
    model = SiamMOT(cfg, device="cpu")
    return jmodel, params, model, model.cast_params(jax_to_torch(flat))


def test_features_match_jax(mini_models):
    """DLA-MINI (S2D stem) + FPN, all five levels."""
    jmodel, params, _, net = mini_models
    rng = np.random.RandomState(3)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    want = jmodel.net.apply(params, jnp.asarray(x),
                            method=jmodel.net.features)
    got = net.fpn(net.body(_t(x)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)


def test_select_proposals_matches_jax(mini_models):
    jmodel, _, model, _ = mini_models
    rng = np.random.RandomState(4)
    anchors = [np.asarray(a) for a in jmodel.anchors_for((64, 96))]
    logits, deltas = [], []
    for a in anchors:
        n = a.shape[0] // 3
        h, w = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)][len(logits)]
        assert h * w == n
        logits.append(rng.randn(1, h, w, 3).astype(np.float32))
        deltas.append((rng.randn(1, h, w, 12) * 0.3).astype(np.float32))
    jcfg = jrpn.RPNConfig.from_cfg(jmodel.cfg, is_train=False)
    jcfg = jcfg.replace(pre_nms_top_n=200, post_nms_top_n=60,
                        fpn_post_nms_top_n=80)
    want = jax.jit(lambda l, d, a: jrpn.select_proposals(
        l, d, a, (96, 60), jcfg))([jnp.asarray(l) for l in logits],
                                  [jnp.asarray(d) for d in deltas],
                                  [jnp.asarray(a) for a in anchors])
    tcfg = trpn.RPNConfig(200, 60, 80, jcfg.nms_thresh, jcfg.min_size,
                          False)
    got = trpn.select_proposals([_t(l) for l in logits],
                                [_t(d) for d in deltas],
                                [_t(a) for a in anchors], (96, 60), tcfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    v = got[2].numpy()
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(want[0])[v],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[v], np.asarray(want[1])[v],
                               rtol=0, atol=1e-6)


def test_postprocess_matches_jax():
    rng = np.random.RandomState(5)
    n, c = 30, 3
    logits = rng.randn(n, c).astype(np.float32) * 2
    deltas = rng.randn(n, 4 * c).astype(np.float32)
    boxes = _boxes(rng, n)
    ids = np.where(rng.rand(n) < 0.3, rng.randint(0, 9, n), -1).astype(
        np.int32)
    labels = rng.randint(0, c, n).astype(np.int32)
    valid = rng.rand(n) < 0.9
    jcfg = JHeadCfg(0.05, 0.5, c, False, (10.0, 10.0, 5.0, 5.0))
    want = jax.jit(lambda lg, dl, pr: jpostprocess(lg, dl, pr, (160, 120),
                                                   jcfg))(
        jnp.asarray(logits), jnp.asarray(deltas),
        JBoxes(*map(jnp.asarray, (boxes, np.zeros(n, np.float32), ids,
                                  labels, valid))))
    tcfg = BoxHeadConfig(0.05, 0.5, c, False, (10.0, 10.0, 5.0, 5.0))
    got = postprocess(_t(logits), _t(deltas),
                      Boxes(_t(boxes), torch.zeros(n), _t(ids), _t(labels),
                            _t(valid)), (160, 120), tcfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


def test_solver_and_rebuild_match_jax():
    """A state with active, dormant and free slots against rows that
    start, keep, suspend and resume tracks."""
    rng = np.random.RandomState(6)
    k, m, t, c = 6, 14, 3, 4
    ids = np.array([3, 5, -1, 7, 2, -1], np.int32)
    st = dict(template=rng.randn(k, t, t, c).astype(np.float32),
              boxes=_boxes(rng, k), sr=_boxes(rng, k), ids=ids,
              labels=np.ones(k, np.int32),
              active=np.array([1, 1, 0, 0, 1, 0], bool),
              last_active=np.array([4, 4, 0, 3, 4, 0], np.int32),
              next_id=np.array(8, np.int32), frame_idx=np.array(5, np.int32))
    row_ids = np.array([-1] * 8 + [3, 5, 7, 2, -1, 9], np.int32)
    scores = np.concatenate([rng.uniform(0.3, 0.95, 8),
                             [1.9, 1.2, 1.7, 1.5, 0.2, 1.8]]).astype(
        np.float32)
    rows = dict(boxes=_boxes(rng, m), scores=scores, ids=row_ids,
                labels=np.ones(m, np.int32),
                valid=np.array([1] * 12 + [0, 1], bool))
    jstate = JState(**{n: jnp.asarray(v) for n, v in st.items()})
    jrows = JBoxes(**{n: jnp.asarray(v) for n, v in rows.items()})
    jout, jact, jupd = jax.jit(lambda s, r: jsolve(
        s, r, JSolverCfg(0.4, 0.6, 0.4, 1)))(jstate, jrows)
    tstate = TrackState(**{n: _t(v) for n, v in st.items()})
    trows = Boxes(**{n: _t(v) for n, v in rows.items()})
    tout, tact, tupd = solve(tstate, trows, SolverConfig(0.4, 0.6, 0.4, 1))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    for f in ("valid", "ids", "labels"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)
    for n, v in tupd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jupd[n]), n)

    top = np.argsort(-np.where(np.asarray(jact), np.asarray(jout.scores),
                               -np.inf), kind="stable")[:k]
    fresh_t = rng.randn(k, t, t, c).astype(np.float32)
    fresh_sr = _boxes(rng, k)
    jnew = jrebuild(jstate, jax.tree.map(lambda a: a[top], jout),
                    jnp.asarray(np.asarray(jact)[top]), jnp.asarray(fresh_t),
                    jnp.asarray(fresh_sr), jupd["keep_dormant"],
                    jupd["next_id"], jstate.frame_idx)
    tnew = rebuild_state(tstate, tout.map(lambda a: a[_t(top)]),
                         tact[_t(top)], _t(fresh_t), _t(fresh_sr),
                         tupd["keep_dormant"], tupd["next_id"],
                         tstate.frame_idx)
    for n, v in tnew.numpy().items():
        np.testing.assert_allclose(v, np.asarray(getattr(jnew, n)),
                                   rtol=0, atol=1e-6, err_msg=n)
