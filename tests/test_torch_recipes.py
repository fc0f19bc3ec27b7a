"""Recipes, given detections and entry-point defaults of the port.

- The port's YAML reader (``configs/node.py:read_yaml``, no ``yaml``)
  against ``yaml.safe_load`` for every file under ``configs/``: the same
  parsed tree, and the same config once merged into the port's defaults.
- ``utils/entities.py`` against ``siammot_tpu/utils/entities.py`` on
  seeded entities, exactly; ``resize_dims`` against the JAX package's.
- The AOT recipe builds, tracks two frames of a DLA-MINI body like the
  JAX step (rows exactly as ``test_torch_slice.py`` holds them: masks,
  ids and labels exact, boxes to 1e-3 px, scores to 1e-4), and takes a
  training step with ``TRAIN_POOLER_WINDOWED`` False (the exact gather
  pooler) with finite losses and gradients.
- ``track_frames`` raises when the recipe asks for given detections and
  none are passed; ``utils/golden.run`` defaults to the card.
"""

import glob
import inspect
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.data.transforms import resize_dims as jax_resize_dims
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.utils import entities as jax_entities
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu_torch.configs.defaults import get_cfg, resize_dims
from siammot_tpu_torch.configs.node import YamlSubsetError, read_yaml
from siammot_tpu_torch.core.matcher import uniform_draws
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.inferencer import track_frames
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils import entities, golden
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))
AOT = os.path.join(REPO, "configs", "dla", "DLA_34_FPN_EMM_AOT.yaml")
MOT17 = os.path.join(REPO, "configs", "dla", "DLA_34_FPN_EMM_MOT17.yaml")
H, W = 128, 160
SMALL = MINI + ["MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
                "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
                "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
                "TPU.MAX_TRACKS", 8]


@pytest.mark.parametrize("path", RECIPES,
                         ids=[os.path.basename(p) for p in RECIPES])
def test_reader_reads_every_recipe_as_yaml_does(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert read_yaml(path) == want
    got_cfg, want_cfg = get_cfg(), get_cfg()
    got_cfg.merge_from_file(path)
    want_cfg._merge_dict(want)
    assert got_cfg == want_cfg


def test_reader_refuses_what_it_does_not_read(tmp_path):
    for text in ("A:\n  - 1\n", "A: {b: 1}\n", "A: yes\n", "A: 1\nA: 2\n",
                 "A:\n  B: 1\n   C: 2\n", "A: &x 1\n", "A: |\n  t\n"):
        p = tmp_path / "r.yaml"
        p.write_text(text)
        with pytest.raises(YamlSubsetError, match="r.yaml:"):
            read_yaml(str(p))


def test_defaults_carry_the_jax_values():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for key in ("USE_GIVEN_DETECTIONS", "CLIP_LEN"):
        assert cfg.INFERENCE[key] == jcfg.INFERENCE[key]
    for key in ("MIN_SIZE_TEST", "MAX_SIZE_TEST"):
        assert cfg.INPUT[key] == jcfg.INPUT[key]
    for wh in ((1920, 1080), (1280, 720), (640, 480), (1080, 1920),
               (3840, 2160), (800, 800)):
        for sizes in ((800, 1500), (800, 1333), (2048, 2480), (384, 640)):
            assert resize_dims(*wh, *sizes) == jax_resize_dims(*wh, *sizes)
    assert resize_dims(1920, 1080, 800, 1500) == (1422, 800)


def _seeded_entities(rng, n):
    out = []
    for i in range(n):
        e = entities.AnnoEntity(time=33.0, id=int(rng.randint(-1, 50)))
        e.bbox = [float(v) for v in rng.uniform(0, 400, 2)] + \
            [float(v) for v in rng.uniform(0.5, 90, 2)]
        e.confidence = float(rng.uniform(0.3, 1.0))
        e.labels = {["person", "vehicle", "bike"][i % 3]: e.confidence} \
            if i % 4 else {}
        out.append(e)
    return out


def test_entities_match_the_jax_package():
    rng = np.random.RandomState(11)
    ents = _seeded_entities(rng, 20)
    for cap, scale in ((32, (1.0, 1.0)), (16, (0.74, 0.75))):
        got = entities.entities_to_boxes(ents, cap, scale)
        want = jax_entities.entities_to_boxes(ents, cap, scale)
        for f in ("boxes", "scores", "ids", "labels", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    out = {"boxes": rng.uniform(0, 300, (12, 4)).astype(np.float32),
           "scores": rng.rand(12).astype(np.float32),
           "ids": rng.randint(-1, 9, 12).astype(np.int32),
           "labels": rng.randint(0, 3, 12).astype(np.int32),
           "valid": rng.rand(12) < 0.6}
    got = entities.boxes_to_entities(out, 7, 233.3, (1.35, 1.35))
    want = jax_entities.boxes_to_entities(
        JaxBoxes(**{k: jnp.asarray(v) for k, v in out.items()}), 7, 233.3,
        (1.35, 1.35))
    assert len(got) == len(want) == int(out["valid"].sum())
    for g, w in zip(got, want):
        assert (g.time, g.id, g.bbox, g.confidence, g.labels, g.blob) == \
            (w.time, w.id, w.bbox, w.confidence, w.labels, w.blob)


def _frames(rng, n):
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    return [np.clip(np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
                    + rng.randn(H, W, 3) * 8, 0, 255).astype(np.uint8)[None]
            for t in range(n)]


def test_aot_recipe_tracks_like_the_jax_step():
    """AOT: template 7, SEARCH_REGION 5 (a 35x35 search region, a 29x29
    response, s_hi 464) on a DLA-MINI body, two frames."""
    rng = np.random.RandomState(1)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(AOT)
    jcfg.merge_from_list(SMALL)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=2)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    frames = _frames(rng, 2)
    step = jmodel.jit_step(image_size=(W, H))
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    state = jmodel.empty_state()
    want = []
    for f in frames:
        out, state = step(jparams, jnp.asarray(f), state)
        want.append(jax.tree.map(np.asarray, out))

    cfg = get_cfg()
    cfg.merge_from_file(AOT)
    cfg.merge_from_list(SMALL)
    assert not cfg.TPU.TRAIN_POOLER_WINDOWED
    model = SiamMOT(cfg, device="cpu")
    assert model.ecfg.response_size == 29
    params = jax_to_torch(flat)
    result = track_frames(model, params, frames, (W, H))
    assert int(result.state.occupied.sum()) > 0
    for g, w in zip(result.outputs, want):
        np.testing.assert_array_equal(g["valid"], np.asarray(w.valid))
        v = g["valid"]
        np.testing.assert_array_equal(g["ids"][v], np.asarray(w.ids)[v])
        np.testing.assert_array_equal(g["labels"][v],
                                      np.asarray(w.labels)[v])
        np.testing.assert_allclose(g["boxes"][v], np.asarray(w.boxes)[v],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"][v], np.asarray(w.scores)[v],
                                   rtol=0, atol=1e-4)
    # and it trains with the exact gather pooler: one step of the recipe
    # (16 box-head samples and 8 track pairs an image, to stay small)
    cfg.merge_from_list(["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
                         "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8])
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(params)
    boxes = torch.tensor([[20.0, 30.0, 60.0, 90.0], [80.0, 20.0, 120.0,
                                                      60.0]])
    gt = Boxes(boxes=torch.stack([boxes, boxes + 3.0]),
               scores=torch.ones(2, 2),
               ids=torch.tensor([[0, 1], [0, 1]], dtype=torch.int32),
               labels=torch.ones(2, 2, dtype=torch.int32),
               valid=torch.ones(2, 2, dtype=torch.bool))
    losses = model.forward_train(net, uniform_draws("cpu", 0),
                                 torch.from_numpy(np.concatenate(frames)),
                                 gt, (W, H))
    assert len(losses) == 7
    assert all(np.isfinite(v.item()) for v in losses.values()), losses
    sum(losses.values()).backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all()
               for p in net.parameters())


def test_given_recipe_needs_detections():
    cfg = get_cfg()
    cfg.merge_from_file(MOT17)
    cfg.merge_from_list(SMALL)
    model = SiamMOT(cfg, device="cpu")
    params = {k: torch.zeros_like(v)
              for k, v in model.build_net().state_dict().items()}
    with pytest.raises(ValueError, match="USE_GIVEN_DETECTIONS"):
        track_frames(model, params, _frames(np.random.RandomState(0), 1),
                     (W, H))


def test_entry_points_default_to_the_card():
    assert inspect.signature(golden.run).parameters["device"].default \
        == "cuda"
    assert inspect.signature(SiamMOT).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            golden.run()


def test_an_unregistered_motion_model_raises_as_jax_does():
    """``MODEL.TRACK_HEAD.MODEL`` other than EMM: the JAX package's
    registry lookup raises, and so does the port, with its message."""
    msgs = []
    for make, build in ((jax_get_cfg, JaxSiamMOT),
                        (get_cfg, lambda c: SiamMOT(c, device="cpu"))):
        cfg = make()
        cfg.merge_from_list(["MODEL.TRACK_HEAD.MODEL", "IMM"])
        with pytest.raises(KeyError) as err:
            build(cfg)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == "\"'IMM' is not registered; available: " \
                                 "['EMM']\""
