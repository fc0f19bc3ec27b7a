"""The port's whole inference slice against the JAX step, on the CPU.

A DLA-MINI-FPN SiamMOT in float32 (128x160 frames, 8 track slots, RPN
top-n 50/20) runs three frames through the JAX ``forward_inference`` and
through the port's ``track_frames`` on the same converted weights.  Rows
are compared one by one: valid masks, ids and labels exactly, boxes to
1e-3 px, scores to 1e-4; the track-state lanes likewise.  The weights are
seeded numpy draws, with the box classifier biased towards the
foreground so that tracks start and the EMM path runs on live slots.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.engine.inferencer import track_frames
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

H, W = 128, 160
IMAGE_SIZE = (W, 120)   # content rows 0..119; the pad is re-zeroed
OVERRIDES = MINI + [
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
    "TPU.MAX_TRACKS", 8,
]
# f32 on both sides; sums run in other orders -> boxes to 1e-3 px,
# scores and pooled features to 1e-4; ids, labels and masks exact
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4


def _frames(rng, n):
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    frames = []
    for t in range(n):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        img = img + rng.randn(H, W, 3) * 8
        frames.append(np.clip(img, 0, 255).astype(np.uint8)[None])
    return frames


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(0)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OVERRIDES)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=0)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    frames = _frames(rng, 3)

    step = jmodel.jit_step(image_size=IMAGE_SIZE)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    state = jmodel.empty_state()
    j_outs, j_states = [], []
    for f in frames:
        out, state = step(jparams, jnp.asarray(f), state)
        j_outs.append(jax.tree.map(np.asarray, out))
        j_states.append(jax.tree.map(np.asarray, state))

    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES)
    model = SiamMOT(cfg, device="cpu")
    params = jax_to_torch(flat)
    # per-frame states through the model step, outputs through the engine
    net = model.cast_params(params)
    t_state = model.empty_state()
    t_states = []
    for f in frames:
        _, t_state = model.forward_inference(net, torch.as_tensor(f),
                                             t_state, IMAGE_SIZE)
        t_states.append(t_state.numpy())
    result = track_frames(model, params, frames, IMAGE_SIZE)
    return j_outs, j_states, result, t_states


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_frame_rows_match_jax(runs, frame):
    j_outs, _, result, _ = runs
    j = j_outs[frame]
    t = result.outputs[frame]
    np.testing.assert_array_equal(t["valid"], np.asarray(j.valid))
    v = t["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(t["ids"][v], np.asarray(j.ids)[v])
    np.testing.assert_array_equal(t["labels"][v], np.asarray(j.labels)[v])
    np.testing.assert_allclose(t["boxes"][v], np.asarray(j.boxes)[v],
                               atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(t["scores"][v], np.asarray(j.scores)[v],
                               atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_track_state_lanes_match_jax(runs, frame):
    _, j_states, _, t_states = runs
    j, t = j_states[frame], t_states[frame]
    for name in ("ids", "labels", "active", "last_active", "next_id",
                 "frame_idx"):
        np.testing.assert_array_equal(t[name], np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t["boxes"], np.asarray(j.boxes),
                               atol=BOX_ATOL, rtol=0)
    # the search region is the box shifted by the pad and grown by the
    # box's own extent, so a box error of e moves its edges by up to 2e
    np.testing.assert_allclose(t["sr"], np.asarray(j.sr),
                               atol=2 * BOX_ATOL, rtol=0)
    # the template is pooled at boxes that agree to BOX_ATOL only; a
    # shift of 1e-3 px moves a bilinear sample by up to 1e-3 of the local
    # feature step, so the lanes agree to 2e-4 of the template's range
    jt = np.asarray(j.template)
    np.testing.assert_allclose(t["template"], jt, rtol=0,
                               atol=2e-4 * np.abs(jt).max())


def test_tracks_are_live_and_engine_matches_step(runs):
    """The EMM path ran on live slots, and the engine's final state is
    the step loop's."""
    _, j_states, result, t_states = runs
    assert (np.asarray(j_states[0].ids) >= 0).sum() > 0
    assert (t_states[1]["ids"] >= 0).sum() > 0
    final = result.state.numpy()
    for name, v in t_states[-1].items():
        np.testing.assert_array_equal(final[name], v, err_msg=name)
    assert len(result.frame_seconds) == 3
