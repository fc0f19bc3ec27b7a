"""The port's ResNet bodies against the JAX package, on the CPU.

* ``ResNetBottleneck`` over stride, ``stride_in_1x1``, groups and the
  projection shortcut, against the flax module on the same numpy
  weights (f32: 1e-5 of the output's largest magnitude, sums in another
  order).
* A narrow R-50 body (``RESNETS.STEM_OUT_CHANNELS`` 8,
  ``RES2_OUT_CHANNELS`` 16, ``WIDTH_PER_GROUP`` 4): C2..C5 within 1e-4 of
  each level's largest magnitude (16 bottlenecks in f32).
* Three frames of that R-50 SiamMOT (``BACKBONE_OUT_CHANNELS`` 32, the
  recipe's BGR255 pixels) row by row, as ``test_torch_slice.py``: masks,
  ids and labels exact, boxes to 1e-3 px, scores to 1e-4.
* One ``forward_train`` step with ``FREEZE_CONV_BODY_AT`` 2: the seven
  losses (rtol 1e-4), every unfrozen parameter's gradient within 1e-3 of
  that leaf's largest JAX gradient (plus 1e-9), no gradient at all for
  the stem and ``layer1`` (``requires_grad`` False), and two SGD updates
  against the JAX ``make_optimizer`` (optax): frozen leaves bitwise
  unchanged, the rest within 1e-6; a frozen run resumed from a
  checkpoint ends bitwise where the uninterrupted run ends.
* The reference ``.pth`` layout for a ResNet body: the port's import and
  export against the JAX functions, bit for bit, and export then import
  the identity.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.resnet import ResNetBottleneck as JaxBottleneck
from siammot_tpu.models.resnet import build_resnet as jax_build_resnet
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel.mesh import make_optimizer as jax_optimizer
from siammot_tpu.utils import checkpoint as jax_ckpt
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.inferencer import track_frames
from siammot_tpu_torch.engine.solver import frozen, make_optimizer
from siammot_tpu_torch.models.resnet import ResNetBottleneck, build_resnet
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils import checkpoint as ckpt
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import (flatten_params, random_flax_params,
                             random_module_params, train_draws,
                             unflatten_params)

NARROW = dict(stem_channels=8, res2_out_channels=16, width_per_group=4)
R50 = ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN",
       "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
       "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
       "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
       "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
       "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
       "INPUT.PIXEL_MEAN", (102.9801, 115.9465, 122.7717),
       "INPUT.PIXEL_STD", (1.0, 1.0, 1.0), "INPUT.TO_BGR255", True,
       "TPU.COMPUTE_DTYPE", "float32", "TPU.POOLER_DTYPE", "float32"]
BLOCK_TOL = 1e-5
BODY_TOL = 1e-4
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
LOSS_RTOL, GRAD_REL, GRAD_FLOOR, STEP_ATOL = 1e-4, 1e-3, 1e-9, 1e-6


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("stride,stride_in_1x1,groups,downsample", [
    (1, True, 1, True), (2, True, 1, True), (2, False, 1, True),
    (1, True, 1, False), (2, True, 4, True), (2, False, 4, True)])
def test_bottleneck_matches_jax(stride, stride_in_1x1, groups, downsample):
    cin = 8 if downsample else 32
    jm = JaxBottleneck(out_channels=32, bottleneck_channels=8, stride=stride,
                       num_groups=groups, stride_in_1x1=stride_in_1x1,
                       use_downsample=downsample)
    x = np.random.RandomState(1).randn(2, 9, 11, cin).astype(np.float32)
    flat = random_module_params(jm, x.shape, seed=stride + 3 * groups)
    want = jm.apply(unflatten_params(flat), jnp.asarray(x))
    tm = ResNetBottleneck(cin, 32, 8, stride=stride, num_groups=groups,
                          stride_in_1x1=stride_in_1x1,
                          use_downsample=downsample)
    tm.load_state_dict(jax_to_torch(flat), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want, BLOCK_TOL)


def test_narrow_r50_body_matches_jax():
    jm = jax_build_resnet("R-50-FPN", **NARROW)
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32)
    flat = random_module_params(jm, x.shape, seed=4)
    want = jm.apply(unflatten_params(flat), jnp.asarray(x))
    tm = build_resnet("R-50-FPN", **NARROW)
    tm.load_state_dict(jax_to_torch(flat), strict=True)
    assert tm.stage_channels == [16, 32, 64, 128]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w, stride in zip(got, want, (4, 8, 16, 32)):
        assert g.shape[2:] == (64 // stride, 96 // stride)
        _close(g.permute(0, 2, 3, 1).numpy(), w, BODY_TOL)


# ---- three frames of the narrow R-50 SiamMOT ----------------------------

H, W = 128, 160
IMAGE_SIZE = (W, 120)
FRAME_OPTS = R50 + ["MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
                    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
                    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
                    "TPU.MAX_TRACKS", 8]


def _frames(rng, n):
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    frames = []
    for t in range(n):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        img = img + rng.randn(H, W, 3) * 8
        frames.append(np.clip(img, 0, 255).astype(np.uint8)[None])
    return frames


def _scaled_stem(flat):
    """The recipe feeds 0-255 BGR pixels: scale the drawn stem so its
    output stays O(1), as ``utils/weights.py:seeded_params`` does."""
    flat["params/body/stem_conv1/kernel"] = \
        flat["params/body/stem_conv1/kernel"] / 64.0
    return flat


@pytest.fixture(scope="module")
def frame_runs():
    rng = np.random.RandomState(0)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(FRAME_OPTS)
    jmodel = JaxSiamMOT(jcfg)
    flat = _scaled_stem(random_flax_params(jmodel, (H, W), seed=5))
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    frames = _frames(rng, 3)
    step = jmodel.jit_step(image_size=IMAGE_SIZE)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    state = jmodel.empty_state()
    j_outs = []
    for f in frames:
        out, state = step(jparams, jnp.asarray(f), state)
        j_outs.append(jax.tree.map(np.asarray, out))
    cfg = get_cfg()
    cfg.merge_from_list(FRAME_OPTS)
    model = SiamMOT(cfg, device="cpu")
    result = track_frames(model, jax_to_torch(flat), frames, IMAGE_SIZE)
    return j_outs, result


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_r50_frame_rows_match_jax(frame_runs, frame):
    j_outs, result = frame_runs
    j, t = j_outs[frame], result.outputs[frame]
    np.testing.assert_array_equal(t["valid"], np.asarray(j.valid))
    v = t["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(t["ids"][v], np.asarray(j.ids)[v])
    np.testing.assert_array_equal(t["labels"][v], np.asarray(j.labels)[v])
    np.testing.assert_allclose(t["boxes"][v], np.asarray(j.boxes)[v],
                               atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(t["scores"][v], np.asarray(j.scores)[v],
                               atol=SCORE_ATOL, rtol=0)
    if frame:
        assert (result.state.ids >= 0).sum() > 0


# ---- a training step with FREEZE_CONV_BODY_AT 2 --------------------------

TH, TW, B, G = 64, 96, 2, 4
TRAIN_OPTS = R50 + ["MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 2,
                    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
                    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
                    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
                    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
                    "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8,
                    "TPU.MAX_GT", G]


def _batch(rng):
    base = rng.randint(0, 255, (TH // 8, TW // 8, 3)).astype(np.float32)
    images = []
    for t in range(B):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        images.append(np.clip(img + rng.randn(TH, TW, 3) * 8, 0,
                              255).astype(np.uint8))
    boxes = np.zeros((B, G, 4), np.float32)
    xy = rng.uniform(2, 40, (3, 2))
    wh = rng.uniform(14, 40, (3, 2))
    for t in range(B):
        boxes[t, :3, :2] = xy + 2 * t
        boxes[t, :3, 2:] = xy + 2 * t + wh
    ids = np.array([[0, 1, 2, -1], [0, 1, 3, -1]], np.int32)
    valid = np.array([[True] * 3 + [False]] * B)
    sizes = np.array([[TW, TH - 4], [TW, TH]], np.int32)
    return (np.stack(images), boxes, ids, valid.astype(np.int32), valid,
            sizes)


@pytest.fixture(scope="module")
def train_runs():
    rng = np.random.RandomState(0)
    images, boxes, ids, labels, valid, sizes = _batch(rng)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(TRAIN_OPTS)
    jmodel = JaxSiamMOT(jcfg)
    flat = _scaled_stem(random_flax_params(jmodel, (TH, TW), seed=6))
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((B, G)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(11)

    def total(p):
        losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                      image_size=(TW, TH),
                                      frame_sizes=jnp.asarray(sizes))
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(jparams)

    cfg = get_cfg()
    cfg.merge_from_list(TRAIN_OPTS)
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    opt = make_optimizer(cfg, net)
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(B, G),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, B,
                        sum(len(a) for a in model.anchors_for((TH, TW))),
                        jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G, G)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (TW, TH), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    assert draws.done()
    return dict(jcfg=jcfg, jparams=jparams, jlosses=jlosses, jgrads=jgrads,
                cfg=cfg, net=net, opt=opt, losses=losses)


def test_r50_losses_match_jax(train_runs):
    j, t = train_runs["jlosses"], train_runs["losses"]
    assert sorted(j) == sorted(t) and len(t) == 7
    for k in j:
        assert np.isfinite(float(j[k])), k
        np.testing.assert_allclose(t[k].item(), float(j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_r50_gradients_match_jax_and_frozen_get_none(train_runs):
    jgrads = jax_to_torch(flatten_params(train_runs["jgrads"]))
    net = train_runs["net"]
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    assert set(jgrads) == set(params) | set(buffers)
    n_frozen = 0
    for name, g in jgrads.items():
        if name in buffers:
            assert float(g.abs().max()) == 0.0, name
            continue
        p = params[name]
        if frozen(name, 2):
            assert not p.requires_grad and p.grad is None, name
            assert name.startswith(("body.stem_", "body.layer1_")), name
            n_frozen += 1
            continue
        assert p.requires_grad, name
        got = p.grad if p.grad is not None else torch.zeros_like(g)
        scale = float(g.abs().max())
        err = float((got - g).abs().max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, (name, err, scale)
    # the stem conv and layer1's 3 blocks (3 convs each + a projection)
    assert n_frozen == 1 + 3 * 3 + 1


def test_r50_frozen_sgd_steps_match_optax(train_runs):
    """Two updates from the same weights and (JAX) gradients: the stem
    and layer1 unchanged bit for bit, every other leaf as optax moves
    it."""
    jparams, jgrads, cfg = (train_runs["jparams"], train_runs["jgrads"],
                            train_runs["cfg"])
    tx = jax_optimizer(train_runs["jcfg"], jparams)
    state = tx.init(jparams)
    p = jparams
    net = SiamMOT(cfg, device="cpu").build_master(
        jax_to_torch(flatten_params(jparams)))
    start = {n: t.detach().clone() for n, t in net.named_parameters()}
    opt = make_optimizer(cfg, net)
    grads = jax_to_torch(flatten_params(jgrads))
    params = dict(net.named_parameters())
    update = jax.jit(tx.update)
    for _ in range(2):
        updates, state = update(jgrads, state, p)
        p = optax.apply_updates(p, updates)
        for name, t in params.items():
            if t.requires_grad:
                t.grad = grads[name].clone()
        opt.step()
    want = jax_to_torch(flatten_params(p))
    for name, t in params.items():
        if frozen(name, 2):
            assert torch.equal(t, start[name]), name
            np.testing.assert_array_equal(want[name].numpy(),
                                          start[name].numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(t.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=STEP_ATOL, err_msg=name)


def test_r50_frozen_training_resumes_bitwise(tmp_path):
    """2 steps, a checkpoint, a resume and 2 more steps end bitwise where
    4 uninterrupted steps end, with the stem and layer1 frozen (left out
    of the SGD groups, so the optimizer state indexes only the others);
    one CPU thread, where two runs are bitwise alike."""
    from siammot_tpu_torch.engine.solver import build_train_step
    from siammot_tpu_torch.engine.trainer import do_train
    from siammot_tpu_torch.utils.checkpoint import Checkpointer, resume

    images, boxes, ids, labels, valid, sizes = _batch(
        np.random.RandomState(3))
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(B, G),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    batches = [(torch.from_numpy(images).roll(i, 2), gt,
                torch.from_numpy(sizes)) for i in range(4)]
    cfg = get_cfg()
    cfg.merge_from_list(TRAIN_OPTS + ["SOLVER.WARMUP_ITERS", 3])
    rng = np.random.RandomState(4)
    start = {k: torch.from_numpy(
        (rng.randn(*v.shape) * 0.05
         + (1.0 if k.endswith("scale") else 0.0)).astype(np.float32))
        for k, v in SiamMOT(cfg, device="cpu").build_net()
        .state_dict().items()}

    def run(checkpointer, first, last):
        model = SiamMOT(cfg, device="cpu")
        net = model.build_master(start)
        opt = make_optimizer(cfg, net)
        it = resume(checkpointer, net, opt) if first else 0
        do_train(model, build_train_step(model, opt), net, opt,
                 iter(batches[it:]), checkpointer, max_iter=last,
                 checkpoint_period=100, log_period=10, start_iter=it)
        return net, opt

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_net, want_opt = run(None, False, 4)
        c = Checkpointer(str(tmp_path))
        run(c, False, 2)
        net, opt = run(c, True, 4)
    finally:
        torch.set_num_threads(n)
    assert opt.count == want_opt.count == 4
    for (name, a), (_, b) in zip(net.named_parameters(),
                                 want_net.named_parameters()):
        assert torch.equal(a, b), name
        assert a.requires_grad == (not frozen(name, 2)), name
    got, want = opt.state_dict()["sgd"], want_opt.state_dict()["sgd"]
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k
    n_live = sum(len(g["params"]) for g in want["param_groups"])
    assert n_live == sum(p.requires_grad for p in net.parameters())


# ---- the reference .pth layout --------------------------------------------

def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_r50_pth_import_export_match_jax():
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(R50)
    flat = random_flax_params(JaxSiamMOT(jcfg), (64, 64), seed=7)
    tree = jax.tree.map(np.asarray, unflatten_params(flat))
    ref = dict(jax_ckpt.export_torch_checkpoint(tree))
    assert "backbone.body.layer1.0.downsample.0.weight" in ref
    assert "backbone.body.layer2.1.downsample.0.weight" not in ref
    rng = np.random.RandomState(8)
    for k in ("backbone.body.stem.bn1", "backbone.body.layer3.2.bn2"):
        c = ref[k + ".weight"].shape[0]
        ref[k + ".running_mean"] = rng.randn(c).astype(np.float32)
        ref[k + ".running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    cfg = get_cfg()
    cfg.merge_from_list(R50)
    got, left = ckpt.import_torch_checkpoint(
        {k: torch.from_numpy(v) for k, v in ref.items()}, cfg)
    want, jleft = jax_ckpt.import_torch_checkpoint(ref, tree)
    assert left == jleft == []
    _same(got, jax_to_torch(jax_ckpt._flatten(want)))
    out = ckpt.export_torch_checkpoint(got)
    _same(out, jax_ckpt.export_torch_checkpoint(want))
    back, left = ckpt.import_torch_checkpoint(out, cfg)
    assert left == []
    _same(back, got)
