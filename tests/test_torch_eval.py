"""Evaluation of the port (``siammot_tpu_torch/eval``, ``data/filters.py``,
``data/motion_dataset.py``, the post-filter of ``engine/inferencer.py``)
against the JAX package's, exactly: the same numpy and scipy operations
on the same inputs give the same bits.

Inputs: seeded random ground truth and predictions, with id switches,
misses, false positives, ignored (non-person, negative-id) ground truth
and predictions on ignored regions; and the JAX golden's predictions of
the committed sequence (``tests/fixtures/torch_golden_dataset.json.gz``).
"""

import math

import numpy as np
import pytest

from siammot_tpu.data import filters as jax_filters
from siammot_tpu.data.motion_dataset import DataSample as JaxSample
from siammot_tpu.data.motion_dataset import MotionDataset as JaxDataset
from siammot_tpu.engine.inferencer import DatasetInference as JaxInference
from siammot_tpu.eval.clearmot import eval_clears_mot as jax_clears
from siammot_tpu.eval.clearmot import merge_summaries as jax_merge
from siammot_tpu.eval.det_ap import eval_det_ap as jax_det_ap
from siammot_tpu_torch.data import filters
from siammot_tpu_torch.data.motion_dataset import DataSample, MotionDataset
from siammot_tpu_torch.engine.inferencer import DatasetInference
from siammot_tpu_torch.eval.clearmot import eval_clears_mot, merge_summaries
from siammot_tpu_torch.eval.det_ap import eval_det_ap
from siammot_tpu_torch.utils import dataset_golden as dg


def _video(rng, sid, n_frames=30, n_ids=6):
    """(gt dict, prediction dict) of one video: ground-truth walkers (one
    a static person, one with a negative id), predictions that follow them
    with noise, drop frames (misses), swap two ids halfway (a switch) and
    add false positives."""
    meta = {"fps": 30.0, "number_of_frames": n_frames,
            "resolution": {"width": 640, "height": 384}}
    start = rng.uniform(20, 500, (n_ids, 2))
    vel = rng.uniform(-4, 4, (n_ids, 2))
    size = rng.uniform(20, 60, (n_ids, 2))
    gt, pred = [], []
    for f in range(n_frames):
        t = f * 1000.0 / 30
        for k in range(n_ids):
            x, y = start[k] + f * vel[k]
            label = "static_person" if k == 4 else "person"
            gid = -1 if k == 5 else k + 1
            bbox = [float(x), float(y), float(size[k, 0]), float(size[k, 1])]
            gt.append({"time": t, "id": gid, "confidence": 1.0,
                       "labels": {label: 1}, "bbox": bbox,
                       "blob": {"frame_idx": f, "visibility": 1.0}})
            if rng.rand() < 0.15:
                continue                                    # a miss
            pid = 100 + k
            if k in (0, 1) and f >= n_frames // 2:
                pid = 101 - k                               # a switch
            conf = float(rng.uniform(0.5, 1.0))
            noisy = [v + float(rng.randn()) * 2 for v in bbox]
            pred.append({"time": t, "id": pid, "confidence": conf,
                         "labels": {"person": conf}, "bbox": noisy,
                         "blob": {"frame_idx": f}})
        for _ in range(rng.poisson(1.0)):                   # false positives
            conf = float(rng.uniform(0.3, 0.9))
            pred.append({"time": t, "id": int(rng.randint(200, 204)),
                         "confidence": conf, "labels": {"person": conf},
                         "bbox": [float(v) for v in rng.uniform(0, 400, 2)]
                         + [30.0, 50.0], "blob": {"frame_idx": f}})
    return ({"metadata": meta, "entities": gt},
            {"metadata": meta, "entities": pred})


@pytest.fixture(scope="module")
def videos():
    rng = np.random.RandomState(7)
    return {f"V{i}": _video(rng, f"V{i}") for i in range(3)}


def _both(videos):
    """(JAX gt pairs, JAX preds, port gt pairs, port preds)."""
    jg = [(sid, JaxSample.from_dict(sid, g)) for sid, (g, _) in
          sorted(videos.items())]
    jp = {sid: JaxSample.from_dict(sid, p) for sid, (_, p) in videos.items()}
    tg = [(sid, DataSample.from_dict(sid, g)) for sid, (g, _) in
          sorted(videos.items())]
    tp = {sid: DataSample.from_dict(sid, p) for sid, (_, p) in videos.items()}
    return jg, jp, tg, tp


def _same_summary(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and math.isnan(x):
            assert isinstance(y, float) and math.isnan(y), k
        else:
            assert x == y, (k, x, y)


@pytest.mark.parametrize("key", [None, "MOT17", "CRP"])
def test_clears_mot_equals_jax(videos, key):
    jg, jp, tg, tp = _both(videos)
    jf = jax_filters.build_data_filter_fn(key) if key else None
    tf = filters.build_data_filter_fn(key) if key else None
    jaccs, jtext = jax_clears(jg, jp, data_filter_fn=jf)
    accs, text = eval_clears_mot(tg, tp, data_filter_fn=tf)
    assert text == jtext
    for sid in jaccs:
        _same_summary(accs[sid].summary(), jaccs[sid].summary())
    _same_summary(merge_summaries(accs), jax_merge(jaccs))
    s = merge_summaries(accs)
    assert s["num_switches"] > 0 and s["num_misses"] > 0 \
        and s["num_false_positives"] > 0


@pytest.mark.parametrize("key", [None, "MOT17"])
def test_det_ap_equals_jax(videos, key):
    jg, jp, tg, tp = _both(videos)
    jf = jax_filters.build_data_filter_fn(key) if key else None
    tf = filters.build_data_filter_fn(key) if key else None
    want = jax_det_ap(jg, jp, data_filter_fn=jf)
    got = eval_det_ap(tg, tp, data_filter_fn=tf)
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= 1


class _Stub:
    _track_len, _track_conf = 5, 0.7


def test_post_filter_equals_jax(videos):
    _, jp, _, tp = _both(videos)
    for sid in videos:
        want = JaxInference._postprocess_tracks(_Stub(), jp[sid])
        got = DatasetInference._postprocess_tracks(_Stub(), tp[sid])
        assert got.to_dict() == want.to_dict()
        kept = {e.id for e in got.entities}
        assert kept and kept != {e.id for e in tp[sid].entities}


@pytest.mark.parametrize("key", ["MOT17", "CRP", "AOT"])
def test_filters_equal_jax(videos, key):
    g, p = videos["V0"]
    ents = [e for e in DataSample.from_dict("V0", g).entities[:40]] + \
        [e for e in DataSample.from_dict("V0", p).entities[:40]]
    jents = [e for e in JaxSample.from_dict("V0", g).entities[:40]] + \
        [e for e in JaxSample.from_dict("V0", p).entities[:40]]
    for e in ents[::3] + jents[::3]:
        e.blob["range_distance_m"] = 900.0
        e.labels = dict(e.labels, intruder=1)
    for train in (False, True):
        f = filters.build_data_filter_fn(key, is_train=train)
        jf = jax_filters.build_data_filter_fn(key, is_train=train)
        v, ig = f(ents)
        jv, jig = jf(jents)
        assert [e.to_dict() for e in v] == [e.to_dict() for e in jv]
        assert [e.to_dict() for e in ig] == [e.to_dict() for e in jig]
        v2, _ = f(ents, ig)
        jv2, _ = jf(jents, jig)
        assert [e.to_dict() for e in v2] == [e.to_dict() for e in jv2]


def test_golden_predictions_evaluate_as_in_jax():
    """The JAX golden's own predictions, through each package's
    post-filter and CLEAR-MOT: the same tracks and summaries as the JAX
    run stored."""
    data = dg.load()
    root = dg.ROOT_DIR + "/synmot_mini"
    jg = JaxDataset(root_path=root).get_split("test")
    tg = MotionDataset(root_path=root).get_split("test")
    for run, want in data["runs"].items():
        preds = {sid: DataSample.from_dict(sid, d)
                 for sid, d in want["predictions"].items()}
        tracks = {sid: DatasetInference._postprocess_tracks(_Stub(), s)
                  for sid, s in preds.items()}
        for sid, t in tracks.items():
            assert t.to_dict() == want["tracks"][sid]
        jtracks = {sid: JaxSample.from_dict(sid, t.to_dict())
                   for sid, t in tracks.items()}
        accs, text = eval_clears_mot(tg, tracks,
                                     filters.build_data_filter_fn("MOT17"))
        jaccs, jtext = jax_clears(jg, jtracks,
                                  jax_filters.build_data_filter_fn("MOT17"))
        assert text == jtext == want["summary_text"]
        assert dg.summaries(accs) == want["summary"]
        assert dg.summaries(jaccs) == want["summary"]


def test_json_layout_round_trips_between_packages(tmp_path, videos):
    g, p = videos["V1"]
    JaxSample.from_dict("V1", p).dump(str(tmp_path / "jax.json"))
    DataSample.load(str(tmp_path / "jax.json")).dump(
        str(tmp_path / "port.json"))
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    for cls in (JaxDataset, MotionDataset):
        ds = cls(root_path=str(tmp_path / cls.__module__))
        ds.add_sample(DataSample.from_dict("V1", g))
        ds.metadata = {"description": "x"}
        ds.dump()
        ds.dump_splits({"test": ["V1"]})
    for name in ("anno.json", "splits.json"):
        a = tmp_path / JaxDataset.__module__ / "annotation" / name
        b = tmp_path / MotionDataset.__module__ / "annotation" / name
        assert a.read_bytes() == b.read_bytes()
    back = MotionDataset(root_path=str(tmp_path / JaxDataset.__module__))
    assert back.get_split("test")[0][1].to_dict() == \
        DataSample.from_dict("V1", g).to_dict()
