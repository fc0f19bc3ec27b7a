"""The port's inference slice with a deformable body against the JAX step,
on the CPU.

A DLA-46-C-FPN SiamMOT with ``STAGE_WITH_DCN (F, F, F, T, T, T)`` (10
deformable 3x3s, the first of each stage stride 2) in float32, 128x160
frames, 8 track slots, RPN top-n 50/20, runs three frames through the
JAX ``forward_inference`` (whose DCN layers take the Pallas kernel in
interpret mode or the patch route, by the reference's own guard) and
through the port's ``track_frames`` on the same converted weights.  The
weights are seeded numpy draws, the offset convs scaled by 0.1 so that
most layers stay in the kernel's window, and the box classifier biased
towards the foreground so that tracks start.  Rows are compared one by
one: valid masks, ids and labels exactly, boxes to 1e-3 px, scores to
1e-4 (f32 on both sides, sums in other orders), as in
``test_torch_slice.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu_torch.configs.defaults import dla_dcn_overrides, get_cfg
from siammot_tpu_torch.engine.inferencer import track_frames
import siammot_tpu_torch.models.dla as dla_mod
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.ops.deform_conv import (deform_conv2d, in_window,
                                               window_route_possible)
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

H, W = 128, 160
IMAGE_SIZE = (W, 120)
OVERRIDES = MINI + dla_dcn_overrides("DLA-46-C-FPN") + [
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
    "TPU.MAX_TRACKS", 8,
]
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4
OFFSET_SCALE = 0.1


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
    flat = random_flax_params(jmodel, (H, W), seed=2)
    for key in flat:
        if "/offset/" in key:
            flat[key] = flat[key] * OFFSET_SCALE
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    assert sum("/offset/kernel" in k for k in flat) == 10
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
    routes = []

    def recording(x, offsets, kernel, stride=1, dilation=1):
        routes.append(window_route_possible(x.shape, kernel.shape, stride,
                                            dilation, x.element_size())
                      and bool(in_window(offsets)))
        return deform_conv2d(x, offsets, kernel, stride, dilation)

    dla_mod.deform_conv2d = recording
    try:
        result = track_frames(model, jax_to_torch(flat), frames, IMAGE_SIZE)
    finally:
        dla_mod.deform_conv2d = deform_conv2d
    return j_outs, j_states, result, routes


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_dcn_frame_rows_match_jax(runs, frame):
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


def test_dcn_final_state_matches_jax(runs):
    _, j_states, result, routes = runs
    # 10 deformable layers a frame, both routes taken
    assert len(routes) == 30 and 0 < sum(routes) < 30, routes
    j, t = j_states[-1], result.state.numpy()
    assert (t["ids"] >= 0).sum() > 0
    for name in ("ids", "labels", "active", "last_active", "next_id",
                 "frame_idx"):
        np.testing.assert_array_equal(t[name], np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t["boxes"], np.asarray(j.boxes),
                               atol=BOX_ATOL, rtol=0)
