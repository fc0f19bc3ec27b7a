"""The exact gather pooler's slice and the XLA-form toggles of the port
against the JAX step, on the CPU (DLA-MINI-FPN in float32).

- Frames: three frames of ``tests/test_torch_slice.py``'s scene and
  weights under three cuts, each against the jitted JAX step under the
  same cut: ``gather`` (``TPU.POOLER_WINDOWED`` False: the exact gather
  pooler at the three pool sites), ``xla`` (``TPU.USE_PALLAS`` and
  ``DECODE_PALLAS`` False: the EMM head over every slot and the XLA
  decode) and ``search_region_5_5`` (``SEARCH_REGION`` 5.5: an 82-wide
  search region, a 68-wide response, the XLA decode at s_hi 1088, where
  both packages leave the decode kernels).  Rows and track-state lanes as
  that file holds them: masks,
  ids and labels exact, boxes to 1e-3 px, scores to 1e-4.
- Two lanes of ``forward_streams`` with ``POOLER_WINDOWED`` False, each
  within 1e-5 of its own one-stream run (oneDNN off, as
  ``tests/test_torch_multistream.py`` runs its lane checks), ids exact.
- Training: ``forward_train`` with ``TPU.TRAIN_POOLER_WINDOWED`` False
  (the gather pooler's autograd Function with its plain backward) against
  ``jax.value_and_grad`` of the JAX step, held as
  ``tests/test_torch_train_slice.py`` holds the windowed step: the seven
  losses rtol 1e-4, each gradient within 1e-3 of its leaf's largest JAX
  gradient plus 1e-9, and two SGD steps against optax to 1e-6.
- ``TPU.CONV_MATMUL_STAGES`` (2, 3): the DLA-MINI FPN features against
  JAX's im2col matmul stages, within 1e-5 of their largest magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel.mesh import make_optimizer as jax_optimizer
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.inferencer import track_frames
from siammot_tpu_torch.engine.solver import make_optimizer
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.parallel.multistream import empty_states
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import (flatten_params, random_flax_params,
                             train_draws, unflatten_params)
import test_torch_slice as frames_slice
import test_torch_train_slice as train_slice

CUTS = {"gather": ["TPU.POOLER_WINDOWED", False],
        "xla": ["TPU.USE_PALLAS", False, "TPU.DECODE_PALLAS", False],
        "search_region_5_5": ["MODEL.TRACK_HEAD.SEARCH_REGION", 5.5]}
H, W = frames_slice.H, frames_slice.W
IMAGE_SIZE = frames_slice.IMAGE_SIZE
BOX_ATOL, SCORE_ATOL = frames_slice.BOX_ATOL, frames_slice.SCORE_ATOL
LANE_ATOL = 1e-5


def _weights(jmodel):
    flat = random_flax_params(jmodel, (H, W), seed=0)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    return flat


@pytest.fixture(scope="module", params=sorted(CUTS))
def frame_runs(request):
    overrides = frames_slice.OVERRIDES + CUTS[request.param]
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(overrides)
    jmodel = JaxSiamMOT(jcfg)
    flat = _weights(jmodel)
    frames = frames_slice._frames(np.random.RandomState(0), 3)
    step = jmodel.jit_step(image_size=IMAGE_SIZE)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    state = jmodel.empty_state()
    j_outs, j_states = [], []
    for f in frames:
        out, state = step(jparams, jnp.asarray(f), state)
        j_outs.append(jax.tree.map(np.asarray, out))
        j_states.append(jax.tree.map(np.asarray, state))

    cfg = get_cfg()
    cfg.merge_from_list(overrides)
    model = SiamMOT(cfg, device="cpu")
    result = track_frames(model, jax_to_torch(flat), frames, IMAGE_SIZE)
    return dict(j_outs=j_outs, j_states=j_states, result=result)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_frame_rows_match_jax(frame_runs, frame):
    j = frame_runs["j_outs"][frame]
    t = frame_runs["result"].outputs[frame]
    np.testing.assert_array_equal(t["valid"], j.valid)
    v = t["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(t["ids"][v], j.ids[v])
    np.testing.assert_array_equal(t["labels"][v], j.labels[v])
    np.testing.assert_allclose(t["boxes"][v], j.boxes[v], atol=BOX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(t["scores"][v], j.scores[v],
                               atol=SCORE_ATOL, rtol=0)


def test_final_state_lanes_match_jax(frame_runs):
    """The last frame's lanes (the earlier frames' rows already hold the
    tracks they carried); the templates as ``test_torch_slice.py``
    bounds them."""
    j = frame_runs["j_states"][-1]
    t = frame_runs["result"].state.numpy()
    assert (t["ids"] >= 0).sum() > 0
    for name in ("ids", "labels", "active", "last_active", "next_id",
                 "frame_idx"):
        np.testing.assert_array_equal(t[name], np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t["boxes"], j.boxes, atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(t["sr"], j.sr, atol=2 * BOX_ATOL, rtol=0)
    np.testing.assert_allclose(t["template"], j.template, rtol=0,
                               atol=2e-4 * np.abs(j.template).max())


def test_gather_lanes_match_their_own_runs():
    """Two streams (the scene and its mirror) through ``forward_streams``
    with the gather pooler: each lane equals its own run."""
    overrides = frames_slice.OVERRIDES + CUTS["gather"]
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(overrides)
    cfg = get_cfg()
    cfg.merge_from_list(overrides)
    model = SiamMOT(cfg, device="cpu")
    net = model.cast_params(jax_to_torch(_weights(JaxSiamMOT(jcfg))))
    frames = frames_slice._frames(np.random.RandomState(0), 3)
    streams = [frames, [np.ascontiguousarray(f[:, :, ::-1])
                        for f in frames]]
    with torch.backends.mkldnn.flags(enabled=False):
        own = []
        for frames in streams:
            state = model.empty_state()
            outs = []
            for f in frames:
                out, state = model.forward_inference(
                    net, torch.as_tensor(f), state, IMAGE_SIZE)
                outs.append(out.numpy())
            own.append((outs, state.numpy()))
        states = empty_states(model, 2)
        for t in range(3):
            images = torch.stack([torch.as_tensor(s[t]) for s in streams])
            out, states = model.forward_streams(net, images, states,
                                                IMAGE_SIZE)
            for lane in range(2):
                got, want = out.lane(lane).numpy(), own[lane][0][t]
                np.testing.assert_array_equal(got["valid"], want["valid"])
                np.testing.assert_array_equal(got["ids"], want["ids"])
                for f in ("boxes", "scores"):
                    np.testing.assert_allclose(got[f], want[f], rtol=0,
                                               atol=LANE_ATOL)
    for lane in range(2):
        got, want = states.lane(lane).numpy(), own[lane][1]
        np.testing.assert_array_equal(got["ids"], want["ids"])
        assert (want["ids"] >= 0).sum() > 0
        np.testing.assert_allclose(got["template"], want["template"],
                                   rtol=0, atol=LANE_ATOL)


# -- training with the gather pooler ----------------------------------------

TRAIN_OVERRIDES = train_slice.OVERRIDES + ["TPU.TRAIN_POOLER_WINDOWED",
                                           False]


@pytest.fixture(scope="module")
def train_runs():
    rng = np.random.RandomState(0)
    images, boxes, ids, labels, valid, sizes = train_slice._batch(rng)
    th, tw, b, g = (train_slice.H, train_slice.W, train_slice.B,
                    train_slice.G)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(TRAIN_OVERRIDES)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (th, tw), seed=1)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((b, g)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(7)

    def total(p):
        losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                      image_size=(tw, th),
                                      frame_sizes=jnp.asarray(sizes))
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(jparams)

    cfg = get_cfg()
    cfg.merge_from_list(TRAIN_OVERRIDES)
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(b, g),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, b,
                        sum(len(a) for a in model.anchors_for((th, tw))),
                        jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + g, g)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (tw, th), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    assert draws.done()
    return dict(jcfg=jcfg, jparams=jparams, jlosses=jlosses, jgrads=jgrads,
                cfg=cfg, model=model, net=net, losses=losses, flat=flat)


def test_gather_training_losses_match_jax(train_runs):
    j, t = train_runs["jlosses"], train_runs["losses"]
    assert sorted(j) == sorted(t) and len(t) == 7
    assert not train_runs["model"].train_windowed
    for k in j:
        assert np.isfinite(float(j[k])), k
        np.testing.assert_allclose(t[k].item(), float(j[k]),
                                   rtol=train_slice.LOSS_RTOL, err_msg=k)
    assert all(float(j[k]) > 0 for k in j)


def test_gather_training_gradients_match_jax(train_runs):
    jgrads = jax_to_torch(flatten_params(train_runs["jgrads"]))
    net = train_runs["net"]
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    assert set(jgrads) == set(params) | set(buffers)
    moved = 0
    for name, g in jgrads.items():
        if name in buffers:
            assert float(g.abs().max()) == 0.0, name
            continue
        got = params[name].grad
        if got is None:
            got = torch.zeros_like(g)
        scale = float(g.abs().max())
        err = float((got - g).abs().max())
        assert err <= train_slice.GRAD_REL * scale + train_slice.GRAD_FLOOR, \
            (name, err, scale)
        moved += name.startswith(("body.", "fpn.")) and scale > 0
    # the gradient reaches the FPN and the body (also through the table)
    assert moved > 0


def test_gather_training_sgd_steps_match_optax(train_runs):
    """Two updates from the gather step's weights with the JAX gradients
    on both sides, as ``test_torch_train_slice.py`` holds the optimizer."""
    jparams, jgrads = train_runs["jparams"], train_runs["jgrads"]
    tx = jax_optimizer(train_runs["jcfg"], jparams)
    state = tx.init(jparams)
    p = jparams
    net = train_runs["model"].build_master(jax_to_torch(train_runs["flat"]))
    opt = make_optimizer(train_runs["cfg"], net)
    grads = jax_to_torch(flatten_params(jgrads))
    params = dict(net.named_parameters())
    update = jax.jit(tx.update)
    for _ in range(2):
        updates, state = update(jgrads, state, p)
        p = optax.apply_updates(p, updates)
        for name, t in params.items():
            t.grad = grads[name].clone()
        opt.step()
        want = jax_to_torch(flatten_params(p))
        for name, t in params.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=train_slice.STEP_ATOL,
                                       err_msg=name)
    assert opt.count == 2


def test_conv_matmul_stages_features_match_jax():
    """JAX computes stages 2 and 3 of the DLA-MINI body as im2col matmuls;
    the port runs its convolutions: the same FPN maps."""
    overrides = frames_slice.OVERRIDES + ["TPU.CONV_MATMUL_STAGES", (2, 3)]
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(overrides)
    jmodel = JaxSiamMOT(jcfg)
    assert jmodel.net.matmul_stages == (2, 3)
    flat = _weights(jmodel)
    rng = np.random.RandomState(3)
    x = rng.randn(1, H, W, 3).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    want = jax.jit(lambda p, im: jmodel.net.apply(
        p, im, method=jmodel.net.features))(jparams, jnp.asarray(x))

    cfg = get_cfg()
    cfg.merge_from_list(overrides)
    assert tuple(cfg.TPU.CONV_MATMUL_STAGES) == (2, 3)
    model = SiamMOT(cfg, device="cpu")
    net = model.cast_params(jax_to_torch(flat))
    with torch.no_grad():
        got = net.fpn(net.body(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max())
        assert err <= 1e-5 * scale, (err, scale)
