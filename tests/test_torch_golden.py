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
the same frames under five cuts of the configuration (``golden.CUTS``:
given public detections with the MOT17 recipe's overrides,
``TPU.MASKED_TRACK_KERNELS`` False, ``SEARCH_REGION`` 5,
``TPU.POOLER_WINDOWED`` False, ``TPU.USE_PALLAS`` and ``DECODE_PALLAS``
False), written by
``tests/torch_port_golden.py --toggles``.  The port's f32 CPU path must
match each with the tolerances above; every state lane is compared over
all K slots, dead ones included (the unmasked route's dead slots feed
nothing into the state).  The bf16 gap of each cut is printed, not
gated.

``tests/fixtures/torch_golden_dla34_bf16.npz`` holds the JAX step's own
rows in bf16 (``TPU.COMPUTE_DTYPE`` and ``TPU.POOLER_DTYPE`` bfloat16;
``tests/torch_port_golden.py --bf16``): the yardstick of the port's bf16
frame.  The port's bf16 frame may lie no further from it than JAX's own
bf16 frame lies from JAX's f32 frame, with a margin of the bf16
tolerances above and one unmatched row (measured on the CPU: 58 ids, 1
unmatched row, 22.55 px, 0.369 against 62 ids, 1 row, 22.41 px, 0.369).
``tests/torch_bf16_layers.py`` shows where the two bf16 steps part.

``golden.decode_races`` reports how near the f32 frames' decode sits to
a tie of its argmax: the default frames hold an exact one on the CPU.
"""

import os

import numpy as np
import pytest

from siammot_tpu_torch.utils import golden

BF16_BOX = 8.0
BF16_SCORE = 5e-2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads for the port's f32 and bf16 DLA-34 runs here, as
    ``tests/test_torch_dataset.py`` pins them: the suite runs several
    files at once on one machine, where a thread a core in every process
    oversubscribes it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def bf16_frames():
    return golden.run("cpu", "bfloat16")


def test_bf16_frames_stay_near_the_jax_step(fixture, bf16_frames):
    r = golden.matched_gap(bf16_frames, fixture)
    assert r["unmatched"] == 0, r
    assert r["box_err"] <= BF16_BOX and r["score_err"] <= BF16_SCORE, r


def test_bf16_fixture_is_small_and_has_live_tracks():
    bf16 = golden.load(golden.BF16_FIXTURE)
    assert os.path.getsize(golden.BF16_FIXTURE) < 2 ** 20
    assert set(bf16) == set(golden.load())
    for i in range(golden.N_FRAMES):
        assert bf16[f"f{i}/rows/valid"].sum() > 20
    assert (bf16[f"f{golden.N_FRAMES - 1}/state/ids"] >= 0).sum() > 20


def test_bf16_gap_to_the_jax_bf16_step_is_bounded(fixture, bf16_frames,
                                                  capsys):
    bf16 = golden.load(golden.BF16_FIXTURE)
    gap = golden.matched_gap(bf16_frames, bf16)
    jax_gap = golden.matched_gap(bf16, fixture)
    with capsys.disabled():
        print(f"\nbf16 frames against the JAX bf16 rows: {gap}; JAX's bf16 "
              f"rows against its f32 rows: {jax_gap}")
    assert gap["rows"] == sum(int(bf16[f"f{i}/rows/valid"].sum())
                              for i in range(golden.N_FRAMES))
    assert jax_gap["rows"] == sum(int(fixture[f"f{i}/rows/valid"].sum())
                                  for i in range(golden.N_FRAMES))
    assert gap["unmatched"] <= jax_gap["unmatched"] + 1, (gap, jax_gap)
    assert gap["ids_differ"] <= jax_gap["ids_differ"], (gap, jax_gap)
    assert gap["box_err"] <= jax_gap["box_err"] + BF16_BOX, (gap, jax_gap)
    assert gap["score_err"] <= jax_gap["score_err"] + BF16_SCORE, (gap,
                                                                   jax_gap)


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


def test_decode_races_report_the_closest_cells():
    """``golden.decode_races`` on the default frames in f32: the closest
    races first, each the best and second-best cell of a decoded slot,
    its gap in ulps of the best; the default frames hold a race of at
    most 2 ulps (an exact tie on the CPU), which is why a change to the
    f32 sums before the decode can move a golden row."""
    races = golden.decode_races("cpu", "float32", None, n=3)
    assert len(races) == 3
    assert [r["ulps"] for r in races] == sorted(r["ulps"] for r in races)
    for r in races:
        a, b = r["p_conf"]
        assert a >= b and r["cells"][0] < r["cells"][1]
        spacing = float(np.spacing(np.float32(a)))
        assert r["ulps"] == pytest.approx((a - b) / spacing)
        assert 0 <= r["frame"] < golden.N_FRAMES
    assert races[0]["ulps"] <= 2, races
