"""Multi-stream inference of the port (``parallel/multistream.py``,
``SiamMOT.forward_streams``, ``engine/multistream_inferencer.py``) on the
CPU.

A DLA-MINI-FPN SiamMOT in float32 (128x160 frames, 8 track slots, RPN
top-n 50/20) steps three streams, each with its own seeded content, as
lanes of one batched step, with the box classifier biased towards the
foreground so that tracks start.  Every lane must equal its own
sequential ``forward_inference`` run (integers and masks exactly, floats
within 1e-5, the JAX package's own bound for its vmapped step), and the
JAX ``build_multistream_step`` on the same converted weights (boxes to
1e-3 px, scores 1e-4, ids exactly: ``test_torch_slice``'s tolerances),
in RPN mode and with stacked given detections.  Permuting the streams
permutes the outputs bit for bit; the clip loop equals stepping; the
wave packing equals the JAX package's; ``DatasetInference(n_streams=2)``
writes the caches of ``n_streams=1``.

oneDNN, PyTorch's default CPU convolution, picks its algorithm by batch
size: the trunk's maps of a batch of three differ from a batch of one by
up to 1.2e-4 (the FPN's finest level), and the boxes by 6.1e-5 px.  The
lane checks therefore run with oneDNN off (``mkldnn.flags``), where each
image's convolutions do not depend on the batch, and hold the lanes to
the 1e-5 bound; with oneDNN on, the lanes are held to the port-against-
JAX tolerances below (ids and masks still exact).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.engine import multistream_inferencer as jax_ms_inf
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel import multistream as jax_ms
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.data.motion_dataset import AnnoEntity, DataSample
from siammot_tpu_torch.engine import multistream_inferencer as ms_inf
from siammot_tpu_torch.engine.inferencer import DatasetInference
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.parallel.multistream import (build_clip_scan,
                                                    build_multistream_step,
                                                    empty_states)
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import MINI, random_flax_params, unflatten_params

H, W = 128, 160
IMAGE_SIZE = (W, 120)   # content rows 0..119; the pad is re-zeroed
S, T, G = 3, 3, 16      # streams, frames, given-detection capacity
OVERRIDES = MINI + [
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 20,
    "TPU.MAX_TRACKS", 8,
]
# a lane against its own sequential run: the JAX package's bound
# (__graft_entry__.py), integers and masks exactly
LANE_ATOL = 1e-5
# the port against JAX, f32 on both sides: test_torch_slice's
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4
ROW_FIELDS = ("boxes", "scores", "ids", "labels", "valid")
STATE_FIELDS = ("template", "boxes", "sr", "ids", "labels", "active",
                "last_active", "next_id", "frame_idx")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads, as the other files that run whole frames pin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stream_frames(seed, n=T):
    """A stream's own content: a textured scene drifting right, noisy."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    frames = []
    for t in range(n):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        img = img + rng.randn(H, W, 3) * 8
        frames.append(np.clip(img, 0, 255).astype(np.uint8)[None])
    return frames


def _given(seed):
    """Per frame, G padded public detections of one stream (numpy)."""
    rng = np.random.RandomState(100 + seed)
    out = []
    for _ in range(T):
        n = rng.randint(3, 8)
        xy = rng.uniform(0, 100, (G, 2))
        wh = rng.uniform(16, 50, (G, 2))
        out.append(dict(
            boxes=np.concatenate([xy, np.minimum(xy + wh, [W - 1, 119])],
                                 1).astype(np.float32),
            scores=rng.uniform(0.5, 1.0, G).astype(np.float32),
            ids=np.full(G, -1, np.int32), labels=np.ones(G, np.int32),
            valid=np.arange(G) < n))
    return out


def _stack(dicts):
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


def _rows(boxes):
    return {f: np.asarray(getattr(boxes, f)) for f in ROW_FIELDS}


def _state(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


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
    givens = [_given(seed) for seed in range(S)]
    return dict(jmodel=jmodel, flat=flat, model=model, net=net,
                streams=streams, givens=givens)


def _batched(setup, mode, order=range(S)):
    """The port's batched step over the streams in ``order``: per frame,
    (out rows, states) as numpy [S, ...]."""
    model, net = setup["model"], setup["net"]
    step = build_multistream_step(model, IMAGE_SIZE, mode == "given")
    states = empty_states(model, S)
    outs = []
    for t in range(T):
        images = torch.as_tensor(np.stack([setup["streams"][i][t]
                                           for i in order]))
        if mode == "given":
            g = _stack([setup["givens"][i][t] for i in order])
            given = Boxes(**{k: torch.as_tensor(v) for k, v in g.items()})
            out, states = step(net, images, states, given)
        else:
            out, states = step(net, images, states)
        outs.append((_rows(out), _state(states)))
    return outs


def _runs(setup, modes):
    """Batched and per-lane sequential runs of the port."""
    model, net = setup["model"], setup["net"]
    out = {}
    for mode in modes:
        seq = []
        for i in range(S):
            state, lane = model.empty_state(), []
            for t in range(T):
                given = None
                if mode == "given":
                    given = Boxes(**{k: torch.as_tensor(v) for k, v in
                                     setup["givens"][i][t].items()})
                o, state = model.forward_inference(
                    net, torch.as_tensor(setup["streams"][i][t]), state,
                    IMAGE_SIZE, given)
                lane.append((_rows(o), _state(state)))
            seq.append(lane)
        out[mode] = dict(batched=_batched(setup, mode), seq=seq)
    return out


def batch_invariant():
    """The CPU convolutions without oneDNN: a batch's per-image results
    are then those of a batch of one."""
    return torch.backends.mkldnn.flags(enabled=False)


@pytest.fixture(scope="module")
def runs(setup):
    with batch_invariant():
        return _runs(setup, ("rpn", "given"))


def _assert_lane(got, want, what, atol):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def test_empty_states_match_jax(setup):
    """(a) leaf by leaf: shape, dtype and value."""
    want = jax_ms.empty_states(setup["jmodel"], S)
    got = empty_states(setup["model"], S)
    for f in STATE_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("mode", ["rpn", "given"])
@pytest.mark.parametrize("frame", range(T))
def test_every_lane_equals_its_sequential_run(runs, mode, frame):
    """(b) every lane's rows and state lanes against its own run."""
    b_rows, b_state = runs[mode]["batched"][frame]
    assert b_rows["valid"].any(axis=1).all()
    for i in range(S):
        s_rows, s_state = runs[mode]["seq"][i][frame]
        _assert_lane({k: v[i] for k, v in b_rows.items()}, s_rows,
                     f"{mode} frame {frame} lane {i} rows", LANE_ATOL)
        _assert_lane({k: v[i] for k, v in b_state.items()}, s_state,
                     f"{mode} frame {frame} lane {i} state", LANE_ATOL)
    if frame == T - 1:
        # tracks live in every stream, with ids of their own
        assert (b_state["ids"] >= 0).any(axis=1).all()
        assert (b_state["next_id"] > 0).all()


def test_lanes_with_onednn_match_their_sequential_runs(setup):
    """(b) on the default CPU path (oneDNN, whose convolutions depend on
    the batch size): every lane's rows within the port-against-JAX
    tolerances of its own run, masks and ids exactly."""
    run = _runs(setup, ("rpn",))["rpn"]
    for t in range(T):
        b_rows, b_state = run["batched"][t]
        for i in range(S):
            s_rows, s_state = run["seq"][i][t]
            for name in ("valid", "ids", "labels"):
                np.testing.assert_array_equal(b_rows[name][i], s_rows[name])
            for name in ("ids", "active", "next_id", "frame_idx"):
                np.testing.assert_array_equal(b_state[name][i],
                                              s_state[name])
            np.testing.assert_allclose(b_rows["boxes"][i], s_rows["boxes"],
                                       atol=BOX_ATOL, rtol=0)
            np.testing.assert_allclose(b_rows["scores"][i],
                                       s_rows["scores"], atol=SCORE_ATOL,
                                       rtol=0)


@pytest.mark.parametrize("mode", ["rpn", "given"])
def test_batched_step_matches_jax(setup, runs, mode):
    """(c) the JAX vmapped step on the same weights, frames and given
    detections (its Pallas kernels as the JAX package's CPU tests run
    them): rows and the integer state lanes, every lane and frame."""
    jmodel = setup["jmodel"]
    step = jax_ms.build_multistream_step(
        jmodel, image_size=IMAGE_SIZE, donate_state=False,
        use_given=mode == "given")
    params = jax.tree.map(jnp.asarray, unflatten_params(setup["flat"]))
    states = jax_ms.empty_states(jmodel, S)
    for t in range(T):
        images = jnp.asarray(np.stack([setup["streams"][i][t]
                                       for i in range(S)]))
        if mode == "given":
            g = _stack([setup["givens"][i][t] for i in range(S)])
            out, states = step(params, images, states,
                               JaxBoxes(**{k: jnp.asarray(v)
                                           for k, v in g.items()}))
        else:
            out, states = step(params, images, states)
        j, js = _rows(out), _state(states)
        t_rows, t_state = runs[mode]["batched"][t]
        np.testing.assert_array_equal(t_rows["valid"], j["valid"])
        v = j["valid"]
        assert v.sum() > 0
        for f in ("ids", "labels"):
            np.testing.assert_array_equal(t_rows[f][v], j[f][v], err_msg=f)
        np.testing.assert_allclose(t_rows["boxes"][v], j["boxes"][v],
                                   atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(t_rows["scores"][v], j["scores"][v],
                                   atol=SCORE_ATOL, rtol=0)
        for f in ("ids", "labels", "active", "last_active", "next_id",
                  "frame_idx"):
            np.testing.assert_array_equal(t_state[f], js[f], err_msg=f)
        np.testing.assert_allclose(t_state["boxes"], js["boxes"],
                                   atol=BOX_ATOL, rtol=0)


def test_permuted_streams_permute_the_outputs(setup, runs):
    """(d) no lane mixing: the streams in another order give the same
    lanes, bit for bit, in that order."""
    order = [2, 0, 1]
    with batch_invariant():
        perm = _batched(setup, "rpn", order)
    for t in range(T):
        for got, want in zip(perm[t], runs["rpn"]["batched"][t]):
            for name in want:
                np.testing.assert_array_equal(got[name], want[name][order],
                                              err_msg=f"frame {t} {name}")


def test_clip_scan_equals_stepping(setup, runs):
    """(e) the clip loop over a [T, 1, H, W, 3] clip: each frame's rows
    and the final state as the per-frame steps give them."""
    model, net = setup["model"], setup["net"]
    scan = build_clip_scan(model, T, IMAGE_SIZE)
    clip = torch.as_tensor(np.stack(setup["streams"][1]))
    with batch_invariant():
        outs, state = scan(net, clip, model.empty_state())
    assert outs.boxes.shape[0] == T
    seq = runs["rpn"]["seq"][1]
    for t in range(T):
        for name, want in seq[t][0].items():
            np.testing.assert_array_equal(getattr(outs, name)[t].numpy(),
                                          want, err_msg=f"frame {t}")
    for name, want in seq[-1][1].items():
        np.testing.assert_array_equal(getattr(state, name).numpy(), want,
                                      err_msg=name)


class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("pack", ["0", "1"])
@pytest.mark.parametrize("n_streams", [2, 3, 4])
def test_wave_packing_matches_jax(monkeypatch, pack, n_streams):
    """(f) the same waves and lane-steps as the JAX package's, on a
    length-skewed set, with and without ``SIAMMOT_MS_PACK``."""
    monkeypatch.setenv("SIAMMOT_MS_PACK", pack)
    lens = [1500, 450, 1194, 600, 1050, 525, 837, 654, 10]
    group = [(f"v{i}", _Len(n)) for i, n in enumerate(lens)]
    want = jax_ms_inf.pack_waves(group, n_streams)
    got = ms_inf.pack_waves(group, n_streams)
    assert [[sid for sid, _ in w] for w in got] == \
        [[sid for sid, _ in w] for w in want]
    assert ms_inf.wave_lane_steps(got, n_streams) == \
        jax_ms_inf.wave_lane_steps(want, n_streams)


def _video(root, name, n_frames, seed):
    """A JPEG folder of drifting textured frames and its DataSample, with
    ground truth (so CLEAR-MOT has work) and public detections."""
    d = root / name
    d.mkdir()
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (96 // 8, 128 // 8, 3)).astype(np.float32)
    sample = DataSample(name, metadata=dict(
        fps=10.0, number_of_frames=n_frames, data_path=str(d),
        resolution={"width": 128, "height": 96}))
    pub = DataSample(name, metadata=dict(sample.metadata))
    for t in range(n_frames):
        img = np.kron(np.roll(base, 2 * t, axis=1), np.ones((8, 8, 1)))
        img = np.clip(img + rng.randn(96, 128, 3) * 8, 0, 255)
        cv2.imwrite(str(d / f"{t + 1:06d}.jpg"), img.astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        for k in range(3):
            for target, tid in ((sample, k + 1), (pub, -1)):
                e = AnnoEntity(time=t * 100.0, id=tid)
                e.bbox = [10.0 + 35 * k + 2 * t, 12.0 + 10 * k, 24.0, 40.0]
                e.confidence = 0.9 - 0.1 * k
                e.labels = {"person": e.confidence}
                e.blob = {"frame_idx": t}
                target.add_entity(e)
    return sample, pub


@pytest.mark.parametrize("given", [False, True])
def test_dataset_inference_n_streams_writes_the_sequential_caches(
        tmp_path, given):
    """(g) three videos of unequal length through ``DatasetInference``
    with two streams (a masked ride-along lane, then a wave with an empty
    lane) against one stream: the same per-video JSON, entity by entity
    (ids, frames and labels exactly, boxes and confidences within
    1e-5)."""
    opts = OVERRIDES + ["INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST",
                        128, "INFERENCE.USE_GIVEN_DETECTIONS", given]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(OVERRIDES)
    flat = random_flax_params(JaxSiamMOT(jcfg), (96, 128), seed=1)
    flat["params/box/predictor/cls_score/bias"] = np.array([-3.0, 3.0],
                                                           np.float32)
    params = jax_to_torch(flat)
    (tmp_path / "data").mkdir()
    videos = [_video(tmp_path / "data", f"v{i}", n, i)
              for i, n in enumerate((3, 5, 2))]
    dataset = [(s.id, s) for s, _ in videos]
    pub = {s.id: p for s, p in videos} if given else None
    model = SiamMOT(cfg, device="cpu")
    infs = {}
    for n in (1, 2):
        out = tmp_path / f"n{n}"
        out.mkdir()
        infs[n] = DatasetInference(cfg, model, params, dataset, str(out),
                                   public_detection=pub, n_streams=n)
        with batch_invariant():
            infs[n]()
    assert set(infs[2].speed) == {"v0", "v1", "v2"}
    assert [infs[2].speed[v][0] for v in ("v0", "v1", "v2")] == [3, 5, 2]
    n_tracked = 0
    # the JSON rounds nothing: the caches hold the step's f32 values
    for sid, _ in dataset:
        with open(tmp_path / "n1" / f"{sid}.json") as f:
            want = json.load(f)
        with open(tmp_path / "n2" / f"{sid}.json") as f:
            got = json.load(f)
        assert got["metadata"] == want["metadata"]
        assert len(got["entities"]) == len(want["entities"]) > 0
        for g, w in zip(got["entities"], want["entities"]):
            for key in ("id", "time", "blob", "labels"):
                if key == "labels":
                    assert list(g[key]) == list(w[key])
                else:
                    assert g[key] == w[key], (sid, key)
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=LANE_ATOL,
                                       rtol=0)
            assert abs(g["confidence"] - w["confidence"]) <= LANE_ATOL
            n_tracked += w["id"] >= 0
    assert n_tracked > 0
    assert os.listdir(tmp_path / "n2")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel", ["window_pool", "xcorr", "predictor",
                                    "decode"])
def test_kernel_wrappers_refuse_past_32_bit_counts(kernel):
    """Kernels 1-4 count elements in 32 bits: a wrapper given a tensor of
    more than 2**31 - 1 elements raises before any launch, naming the
    limit (meta tensors: the shapes with no memory behind them), and the
    largest multi-stream shapes chip_smoke.py runs (16 streams of 128
    slots at 720p) stay inside it."""
    from siammot_tpu_torch.ops import cuda
    from siammot_tpu_torch.ops.decode import emm_decode
    from siammot_tpu_torch.ops.predictor import _NAMES, emm_predictor
    from siammot_tpu_torch.ops.window_pool import window_pool
    from siammot_tpu_torch.ops.xcorr import xcorr_depthwise_masked

    def call(n, rows):
        if kernel == "window_pool":
            return window_pool(_meta(rows, 320, 128, dtype=torch.bfloat16),
                               _meta(n, 2, dtype=torch.int32),
                               _meta(n, 30, 128), _meta(n, 30, 128),
                               _meta(n, dtype=torch.bool))
        if kernel == "xcorr":
            return xcorr_depthwise_masked(
                _meta(n, 30, 30, 128, dtype=torch.bfloat16),
                _meta(n, 15, 15, 128, dtype=torch.bfloat16),
                _meta(n, dtype=torch.bool))
        if kernel == "predictor":
            params = {}
            for name in _NAMES:
                head = name.split(".")[0]
                cout = {"cls": 2, "center": 1, "reg": 4}.get(head, 128)
                params[name] = _meta(3, 3, 128, cout) \
                    if name.endswith("kernel") else \
                    _meta(cout if name.endswith("bias") else 128)
            return emm_predictor(_meta(n, 16, 16, 128),
                                 _meta(n, dtype=torch.bool), params)
        return emm_decode(_meta(n, 4, 16, 16), _meta(n, 2),
                          _meta(256, 16), _meta(256, 256),
                          _meta(n, dtype=torch.bool), 0.4, True)

    # far past the limit: every wrapper raises ValueError naming it
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        call(16 * 2 ** 20, 16 * 2 ** 16)
    # 16 streams x 128 slots, the pool table of 16 x 345 720p rows: inside
    # (nothing else refuses these shapes before the launch, where the
    # build needs nvcc)
    sizes = {"window_pool": [(16 * 345, 320, 128), (2048, 30, 30, 128)],
             "xcorr": [(2048, 30, 30, 128), (2048, 16, 16, 128)],
             "predictor": [(2, 2048, 128, 256)],
             "decode": [(2048, 4, 16, 16)]}[kernel]
    cuda.check_extent(kernel, *sizes)
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        cuda.check_extent(kernel, (2 ** 31,))


def test_a_pool_of_several_images_needs_each_rois_image():
    """A LevelPack of several images refuses ROIs without their image
    index (they would all pool image 0), and pools each ROI from its own
    image when given."""
    from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                          windowed_pool)
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, h, w, 8, generator=g)
             for h, w in ((16, 20), (8, 10))]
    pack = pack_levels(feats, (0.25, 0.125))
    rois = torch.tensor([[4.0, 4.0, 40.0, 30.0]] * 2)
    levels = torch.zeros(2, dtype=torch.int32)
    valid = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="image index"):
        windowed_pool(pack, rois, None, levels, 7, 2, 16, valid=valid)
    both = windowed_pool(pack, rois, torch.tensor([0, 1], dtype=torch.int32),
                         levels, 7, 2, 16, valid=valid)
    for i in range(2):
        one = pack_levels([f[i:i + 1] for f in feats], (0.25, 0.125))
        np.testing.assert_array_equal(
            both[i].numpy(),
            windowed_pool(one, rois[:1], None, levels[:1], 7, 2, 16,
                          valid=valid[:1])[0].numpy())
