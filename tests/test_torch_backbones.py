"""The port's other DLA bodies and ``TPU.REMAT`` against the JAX package,
on the CPU.

* The plain stem (``TPU.S2D_STEM`` False: ``base_conv`` 7x7, ``level0``,
  ``level1``): three DLA-MINI frames row by row, as
  ``test_torch_slice.py`` (masks, ids and labels exact, boxes to 1e-3 px,
  scores to 1e-4).
* ``Bottle2neck`` over stride (the cascade on stride 1; off, with the
  last split average-pooled counting the padded zeros, on stride 2) and
  width, against the flax module (f32: 1e-5 of the output's largest
  magnitude); DLA-60-RES2NET-FPN's four levels at a 64x64 input, within
  1e-4 of each level's largest magnitude.
* The reference ``.pth`` layout of a plain-stem Res2Net body (the stem
  as it is, no phase decomposition; ``convs.{i}``/``bns.{i}``): the
  port's import and export against the JAX functions, bit for bit.
* ``TPU.REMAT``: one DLA-MINI ``forward_train`` step recomputing the
  trunk in the backward gives the non-remat step's gradients bit for
  bit on one CPU thread, and JAX's REMAT step's within 1e-3 of each
  leaf's largest JAX gradient (plus 1e-9), as
  ``test_torch_train_slice.py`` holds them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.dla import Bottle2neck as JaxBottle2neck
from siammot_tpu.models.dla import build_dla as jax_build_dla
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.utils import checkpoint as jax_ckpt
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.inferencer import track_frames
from siammot_tpu_torch.models.dla import Bottle2neck, build_dla
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils import checkpoint as ckpt
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import (MINI, draw_params, flatten_params,
                             random_flax_params, random_module_params,
                             train_draws, unflatten_params)

BLOCK_TOL, BODY_TOL = 1e-5, 1e-4
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-9
RES2NET = ["MODEL.BACKBONE.CONV_BODY", "DLA-60-RES2NET-FPN",
           "MODEL.DLA.DLA_STAGE2_OUT_CHANNELS", 128,
           "MODEL.DLA.DLA_STAGE3_OUT_CHANNELS", 256,
           "MODEL.DLA.DLA_STAGE4_OUT_CHANNELS", 512,
           "MODEL.DLA.DLA_STAGE5_OUT_CHANNELS", 1024]


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


# ---- the plain stem ---------------------------------------------------------

H, W = 128, 160
IMAGE_SIZE = (W, 120)
PLAIN = MINI + ["TPU.S2D_STEM", False,
                "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
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


@pytest.fixture(scope="module")
def plain_runs():
    rng = np.random.RandomState(0)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(PLAIN)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=9)
    assert "params/body/base_conv/kernel" in flat
    assert not any("/stem/" in k for k in flat)
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
    cfg.merge_from_list(PLAIN)
    result = track_frames(SiamMOT(cfg, device="cpu"), jax_to_torch(flat),
                          frames, IMAGE_SIZE)
    return j_outs, result


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_plain_stem_frame_rows_match_jax(plain_runs, frame):
    j_outs, result = plain_runs
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


# ---- Res2Net ----------------------------------------------------------------

@pytest.mark.parametrize("stride,planes,cardinality,base_width", [
    (1, 64, 1, 28), (2, 64, 1, 28), (1, 32, 8, 4), (2, 32, 8, 4)])
def test_bottle2neck_matches_jax(stride, planes, cardinality, base_width):
    rng = np.random.RandomState(stride + planes)
    x = rng.randn(2, 10, 14, planes).astype(np.float32)
    res = rng.randn(2, 10 // stride, 14 // stride, planes).astype(np.float32)
    jm = JaxBottle2neck(planes, stride, cardinality=cardinality,
                        base_width=base_width)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros(x.shape),
                                              jnp.zeros(res.shape)),
                            jax.random.PRNGKey(0))
    flat = draw_params(shapes, seed=planes + stride)
    want = jm.apply(unflatten_params(flat), jnp.asarray(x), jnp.asarray(res))
    tm = Bottle2neck(planes, planes, stride, cardinality=cardinality,
                     base_width=base_width)
    tm.load_state_dict(jax_to_torch(flat), strict=True)
    assert hasattr(tm, "convs_2") and not hasattr(tm, "convs_3")
    with torch.no_grad():
        got = tm(_nchw(x), _nchw(res)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want, BLOCK_TOL)


def test_res2net_body_matches_jax():
    jm = jax_build_dla("DLA-60-RES2NET-FPN", s2d_stem=True)
    x = np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32)
    flat = random_module_params(jm, x.shape, seed=10)
    want = jm.apply(unflatten_params(flat), jnp.asarray(x))
    tm = build_dla("DLA-60-RES2NET-FPN")
    tm.load_state_dict(jax_to_torch(flat), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w, c in zip(got, want, (128, 256, 512, 1024)):
        assert g.shape[1] == c
        _close(g.permute(0, 2, 3, 1).numpy(), w, BODY_TOL)


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_plain_stem_res2net_pth_import_export_match_jax():
    opts = RES2NET + ["TPU.S2D_STEM", False]
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(opts)
    flat = random_flax_params(JaxSiamMOT(jcfg), (64, 64), seed=12)
    tree = jax.tree.map(np.asarray, unflatten_params(flat))
    ref = dict(jax_ckpt.export_torch_checkpoint(tree))
    assert "backbone.body.level0.0.weight" in ref
    assert "backbone.body.level2.tree1.convs.2.weight" in ref
    rng = np.random.RandomState(13)
    for k in ("backbone.body.base_layer.1",
              "backbone.body.level3.tree1.tree1.bns.1"):
        c = ref[k + ".weight"].shape[0]
        ref[k + ".running_mean"] = rng.randn(c).astype(np.float32)
        ref[k + ".running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    cfg = get_cfg()
    cfg.merge_from_list(opts)
    got, left = ckpt.import_torch_checkpoint(
        {k: torch.from_numpy(v) for k, v in ref.items()}, cfg)
    want, jleft = jax_ckpt.import_torch_checkpoint(ref, tree)
    assert left == jleft == []
    _same(got, jax_to_torch(jax_ckpt._flatten(want)))
    assert got["body.base_conv.weight"].shape == (16, 3, 7, 7)
    out = ckpt.export_torch_checkpoint(got)
    _same(out, jax_ckpt.export_torch_checkpoint(want))
    back, left = ckpt.import_torch_checkpoint(out, cfg)
    assert left == []
    _same(back, got)


# ---- TPU.REMAT --------------------------------------------------------------

TH, TW, B, G = 64, 96, 2, 4
TRAIN = MINI + ["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
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


def _port_grads(flat, remat, batch, key, jcfg):
    images, boxes, ids, labels, valid, sizes = batch
    cfg = get_cfg()
    cfg.merge_from_list(TRAIN + ["TPU.REMAT", remat])
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(B, G),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, B,
                        sum(len(a) for a in model.anchors_for((TH, TW))),
                        jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G, G)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (TW, TH), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    return losses, {n: p.grad for n, p in net.named_parameters()}


def test_remat_step_gradients_match_plain_step_and_jax_remat():
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    images, boxes, ids, labels, valid, sizes = batch
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(TRAIN + ["TPU.REMAT", True])
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (TH, TW), seed=14)
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((B, G)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(15)

    def total(p):
        losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                      image_size=(TW, TH),
                                      frame_sizes=jnp.asarray(sizes))
        return sum(losses.values())

    jgrads = jax_to_torch(flatten_params(jax.jit(jax.grad(total))(
        jax.tree.map(jnp.asarray, unflatten_params(flat)))))

    # one thread: split over two, the CPU backward's sums land in another
    # order from run to run, and two plain steps already differ in bits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        l_plain, g_plain = _port_grads(flat, False, batch, key, jcfg)
        l_remat, g_remat = _port_grads(flat, True, batch, key, jcfg)
    finally:
        torch.set_num_threads(n)
    for k in l_plain:
        assert torch.equal(l_plain[k], l_remat[k]), k
    n_trunk = 0
    for name, g in g_plain.items():
        r = g_remat[name]
        if g is None:           # a projection no tree level reads
            assert r is None, name
            continue
        assert torch.equal(g, r), name
        n_trunk += name.startswith(("body.", "fpn."))
        want = jgrads[name]
        err = float((r - want).abs().max())
        assert err <= GRAD_REL * float(want.abs().max()) + GRAD_FLOOR, \
            (name, err)
    assert n_trunk > 30
