"""The multi-stream engine through ``tools/test_net --n-streams 2`` against
the JAX golden, on the CPU.

``tests/fixtures/synmot_multi`` holds three test sequences of 10, 7 and 4
frames (``utils/dataset_golden.py`` says how they were made): with two
streams, wave packing runs the 10- and 7-frame videos together (the
shorter rides along as a masked lane for three steps), then the 4-frame
video beside an empty lane.  The JAX ``DatasetInference(n_streams=2)``
wrote ``tests/fixtures/torch_golden_multistream.json.gz`` over the same
frames (DLA-34-FPN-EMM on the bench weights, f32); the port's per-video
JSON caches, post-filtered tracks and CLEAR-MOT summary are held to it
within ``utils/dataset_golden.py``'s tolerances (ids, frames and labels
exactly, boxes 1e-2 px, confidences 1e-4, summary 1e-9, MOTP 1e-6).
"""

import numpy as np
import pytest
import torch

from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.data.motion_dataset import DataSample
from siammot_tpu_torch.data.transforms import EvalTransform
from siammot_tpu_torch.data.video_loader import normalized_frame_source
from siammot_tpu_torch.tools import test_net
from siammot_tpu_torch.utils import dataset_golden as dg

FRAMES = {"SYN-TE-01": 10, "SYN-TE-02": 7, "SYN-TE-03": 4}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads (see ``tests/test_torch_dataset.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_committed_frames_decode_to_the_jax_bytes():
    want = dg.load(dg.MULTI_FIXTURE)
    assert want["decoder"] == "libjpeg"
    cfg = get_cfg()
    cfg.merge_from_file(dg.RECIPE)
    for video, n in FRAMES.items():
        path = f"{dg.ROOT_DIR}/synmot_multi/test/{video}/img1"
        got = dg.frame_digests(x for x, _ in normalized_frame_source(
            path, EvalTransform(cfg)))
        assert got == want["frames"][video] and len(got) == n, video


def test_test_net_n_streams_matches_the_jax_golden(tmp_path):
    run = "given_f32"
    want = dg.load(dg.MULTI_FIXTURE)["runs"][run]
    inf = test_net.main(dg.cli_args(run, str(tmp_path), device="cpu",
                                    n_streams=dg.MULTI_STREAMS))
    assert {v: n for v, (n, _) in inf.speed.items()} == FRAMES
    tracked = 0
    for video in FRAMES:
        got = DataSample.load(str(tmp_path / f"{video}.json")).to_dict()
        dg.compare_samples(got, want["predictions"][video], f"{run} {video}")
        dg.compare_samples(inf.results[video].to_dict(),
                           want["tracks"][video], f"{run} {video} tracks")
        tracked += sum(e["id"] >= 0 for e in got["entities"])
    assert tracked > 0
    dg.compare_summaries(dg.summaries(inf.accs), want["summary"], run)
    assert np.isfinite(dg.summaries(inf.accs)["OVERALL"]["mota"])
