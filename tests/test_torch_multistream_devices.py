"""The multi-stream step with its stream axis split over devices
(``parallel/multistream.py:build_multistream_step(..., devices=...)``),
on the CPU, where the same device stands in for each of two.

``test_torch_multistream.py``'s DLA-MINI-FPN in float32 (128x160 frames,
8 track slots) steps four streams for three frames with
``devices=["cpu", "cpu"]``: two lanes a device, each device through its
own copy of the net, the lanes' states kept as shards between frames.
Checked:
- every lane against the single-device step over the four streams: ids,
  labels, masks and integer state lanes exactly, floats within 1e-5 with
  oneDNN off (as the lane tests there run: oneDNN picks its convolution
  by batch size, and each device convolves a batch of two);
- the lanes against the JAX ``build_multistream_step(model, make_mesh(2))``
  on two of the eight virtual CPU devices (boxes to 1e-3 px, scores
  1e-4, ids exactly: ``test_torch_slice``'s tolerances);
- ``devices=None`` is bitwise the step of one device
  (``SiamMOT.forward_streams``); four streams over three devices raise;
  the net is copied once, at the first frame.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel import multistream as jax_ms
from siammot_tpu.parallel.mesh import make_mesh
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.parallel import multistream as ms
from siammot_tpu_torch.utils.weights import jax_to_torch
from test_torch_multistream import (BOX_ATOL, IMAGE_SIZE, LANE_ATOL,
                                    OVERRIDES, SCORE_ATOL, H, W,
                                    _assert_lane, _rows, _state,
                                    _stream_frames, batch_invariant)
from torch_port_util import random_flax_params, unflatten_params

S, T = 4, 3
DEVICES = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(OVERRIDES)
    cfg.merge_from_list(OVERRIDES)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=0)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    model = SiamMOT(cfg, device="cpu")
    net = model.cast_params(jax_to_torch(flat))
    streams = [_stream_frames(seed) for seed in range(S)]
    frames = [torch.as_tensor(np.stack([streams[i][t] for i in range(S)]))
              for t in range(T)]
    return dict(jmodel=jmodel, flat=flat, model=model, net=net,
                frames=frames)


def _run(step, net, model, frames):
    states = ms.empty_states(model, S)
    outs = []
    for images in frames:
        out, states = step(net, images, states)
        outs.append((_rows(out), _state(states)))
    return outs, states


@pytest.fixture(scope="module")
def runs(setup):
    model, net, frames = setup["model"], setup["net"], setup["frames"]
    with batch_invariant():
        one, _ = _run(ms.build_multistream_step(model, IMAGE_SIZE), net,
                      model, frames)
        two, states = _run(ms.build_multistream_step(
            model, IMAGE_SIZE, devices=DEVICES), net, model, frames)
    return dict(one=one, two=two, states=states)


@pytest.mark.parametrize("frame", range(T))
def test_sharded_lanes_equal_the_single_device_step(runs, frame):
    (rows1, st1), (rows2, st2) = runs["one"][frame], runs["two"][frame]
    for i in range(S):
        _assert_lane({k: v[i] for k, v in rows2.items()},
                     {k: v[i] for k, v in rows1.items()},
                     f"frame {frame} lane {i} rows", LANE_ATOL)
        _assert_lane({k: v[i] for k, v in st2.items()},
                     {k: v[i] for k, v in st1.items()},
                     f"frame {frame} lane {i} state", LANE_ATOL)
    assert rows2["valid"].any(axis=1).all()
    if frame == T - 1:
        assert (st2["ids"] >= 0).any(axis=1).all()


def test_states_stay_sharded_on_their_devices(runs):
    states = runs["states"]
    assert isinstance(states, ms.Sharded) and len(states.shards) == 2
    assert [s.ids.shape for s in states.shards] == [(2, 8)] * 2
    full = states.gather()
    assert full.ids.shape == (S, 8) and full.capacity == 8
    assert torch.equal(full.ids[3], states.shards[1].ids[1])
    assert torch.equal(states.ids, full.ids)


def test_sharded_step_matches_the_jax_mesh_step(setup, runs):
    jmodel = setup["jmodel"]
    step = jax_ms.build_multistream_step(jmodel, make_mesh(2),
                                         image_size=IMAGE_SIZE,
                                         donate_state=False)
    params = jax.tree.map(jnp.asarray, unflatten_params(setup["flat"]))
    states = jax_ms.empty_states(jmodel, S)
    for t, images in enumerate(setup["frames"]):
        out, states = step(params, jnp.asarray(images.numpy()), states)
        j, js = _rows(out), _state(states)
        rows, st = runs["two"][t]
        np.testing.assert_array_equal(rows["valid"], j["valid"])
        v = j["valid"]
        assert v.sum() > 0
        for f in ("ids", "labels"):
            np.testing.assert_array_equal(rows[f][v], j[f][v], err_msg=f)
        np.testing.assert_allclose(rows["boxes"][v], j["boxes"][v],
                                   atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(rows["scores"][v], j["scores"][v],
                                   atol=SCORE_ATOL, rtol=0)
        for f in ("ids", "labels", "active", "last_active", "next_id",
                  "frame_idx"):
            np.testing.assert_array_equal(st[f], js[f], err_msg=f)


def test_no_devices_is_bitwise_the_one_device_step(setup):
    model, net, frames = setup["model"], setup["net"], setup["frames"]
    step = ms.build_multistream_step(model, IMAGE_SIZE)
    states = want = ms.empty_states(model, S)
    for images in frames[:2]:
        out, states = step(net, images, states)
        w_out, want = model.forward_streams(net, images, want, IMAGE_SIZE)
        for f in ("boxes", "scores", "ids", "labels", "valid"):
            assert torch.equal(getattr(out, f), getattr(w_out, f)), f
        for a, b in zip(_state(states).values(), _state(want).values()):
            assert np.array_equal(a, b)


def test_streams_must_divide_over_devices_and_the_net_is_copied_once(
        setup, monkeypatch):
    model, net, frames = setup["model"], setup["net"], setup["frames"]
    with pytest.raises(ValueError, match="do not split over 3 devices"):
        ms.build_multistream_step(model, IMAGE_SIZE, devices=["cpu"] * 3)(
            net, frames[0], ms.empty_states(model, S))
    copies = []
    real = ms.copy.deepcopy
    monkeypatch.setattr(ms, "copy", types.SimpleNamespace(
        deepcopy=lambda x: copies.append(1) or real(x)))
    step = ms.build_multistream_step(model, IMAGE_SIZE, devices=DEVICES)
    states = ms.empty_states(model, S)
    for images in frames[:2]:
        _, states = step(net, images, states)
    assert len(copies) == len(DEVICES)
