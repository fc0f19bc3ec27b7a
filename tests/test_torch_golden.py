"""The default configuration end to end: the port's DLA-34-FPN-EMM frame
step on the repo's trained weights against the JAX step's rows.

``tests/fixtures/torch_golden_dla34.npz`` holds what the JAX step
returned for four frames of the crowded synthetic scene at 320x576 in
float32 (written by ``tests/torch_port_golden.py``; ``siammot_tpu_torch/
utils/golden.py`` runs the port and compares).  The port's CPU path in
float32 must match it row by row: valid masks, ids, labels and the
integer track-state lanes exactly, boxes to 1e-2 px, scores to 1e-4,
template sums to 1e-4 of the slot's sum of magnitudes (f32 on both
sides, 33 convolutions deep, sums in other orders; measured 1.8e-4 px,
4e-6 and 9e-7).  In bf16 rows can
move and ids can be handed out in another order, so the bf16 frame is
held by matching boxes: every fixture row has a bf16 row with IoU >= 0.5,
box errors within 8 px and scores within 5e-2 (measured on the CPU: 4.6
px and 1.1e-2).

``tests/fixtures/torch_golden_toggles.npz`` holds the JAX step's rows for
the same frames under three cuts of the configuration (``golden.CUTS``:
given public detections with the MOT17 recipe's overrides,
``TPU.MASKED_TRACK_KERNELS`` False, ``SEARCH_REGION`` 5), written by
``tests/torch_port_golden.py --toggles``.  The port's f32 CPU path must
match each with the tolerances above; every state lane is compared over
all K slots, dead ones included (the unmasked route's dead slots feed
nothing into the state).  The bf16 gap of each cut is printed, not
gated.
"""

import os

import numpy as np
import pytest

from siammot_tpu_torch.utils import golden

BF16_BOX = 8.0
BF16_SCORE = 5e-2


@pytest.fixture(scope="module")
def fixture():
    return golden.load()


def test_fixture_is_small_and_has_live_tracks(fixture):
    assert os.path.getsize(golden.FIXTURE) < 2 ** 20
    for i in range(golden.N_FRAMES):
        assert fixture[f"f{i}/rows/valid"].sum() > 20
        assert fixture[f"f{i}/state/template"].shape == (128, 3)
    assert (fixture[f"f{golden.N_FRAMES - 1}/state/ids"] >= 0).sum() > 20


def test_f32_frames_match_the_jax_step(fixture):
    r = golden.compare(golden.run("cpu", "float32"), fixture)
    assert r["ok"], r


def test_bf16_frames_stay_near_the_jax_step(fixture):
    r = golden.matched_gap(golden.run("cpu", "bfloat16"), fixture)
    assert r["unmatched"] == 0, r
    assert r["box_err"] <= BF16_BOX and r["score_err"] <= BF16_SCORE, r


@pytest.fixture(scope="module")
def toggles():
    return golden.load(golden.TOGGLES_FIXTURE)


def test_toggles_fixture_is_small_and_covers_every_cut(toggles):
    assert os.path.getsize(golden.TOGGLES_FIXTURE) < 200 * 1024
    for name in golden.CUTS:
        cut = golden.cut(toggles, name)
        assert len(cut) == len(golden.load())
        last = golden.N_FRAMES - 1
        assert (cut[f"f{last}/state/ids"] >= 0).sum() > 20


@pytest.mark.parametrize("name", sorted(golden.CUTS))
def test_f32_cut_matches_the_jax_step(toggles, name):
    r = golden.compare(golden.run("cpu", "float32", name),
                       golden.cut(toggles, name))
    assert r["ok"], r


def test_bf16_cuts_gap_is_printed(toggles, capsys):
    for name in sorted(golden.CUTS):
        gap = golden.matched_gap(golden.run("cpu", "bfloat16", name),
                                 golden.cut(toggles, name))
        with capsys.disabled():
            print(f"\nbf16 gap, cut {name}: {gap}")
        assert gap["rows"] > 0
