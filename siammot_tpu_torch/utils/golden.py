"""The default configuration's end-to-end check: the port's frame step
against rows the JAX step wrote for the same frames.

``tests/torch_port_golden.py`` (which needs JAX) runs the JAX
``SiamMOT.forward_inference`` on the CPU with the repo's trained
DLA-34-FPN-EMM weights (``fixtures/bench_weights_f16.npz``), float32
compute and pooler dtype, over the first ``N_FRAMES`` frames of the
crowded synthetic scene at a reduced frame size, and stores every frame's
output rows and track-state lanes in ``tests/fixtures/
torch_golden_dla34.npz``.  :func:`run` drives the port over the same
frames (on the CPU or the card, in f32 or bf16) and :func:`compare`
measures it against the fixture.  The track templates ([K, 15, 15, 128]
per frame) are kept as per-slot sums, sums of squares and sums of
magnitudes, to hold the fixture under 1 MB.

``tests/fixtures/torch_golden_toggles.npz`` holds the same frames under
five cuts of the configuration (:data:`CUTS`), each a path that selects
other kernels: ``given``, the MOT17 recipe's overrides with the scene's
public detections (:func:`given_detections`) replacing the RPN;
``unmasked``, ``TPU.MASKED_TRACK_KERNELS`` False (kernels 6 and 10);
``wide_sr``, ``SEARCH_REGION`` 5 (a 75x75 search region, a 61x61
response, the striped decode at s_hi 976); ``gather``,
``TPU.POOLER_WINDOWED`` False (the exact gather pooler at the three pool
sites); ``xla``, ``TPU.USE_PALLAS`` and ``DECODE_PALLAS`` False (the EMM
head over every slot, the XLA decode).  Its keys carry the cut's name
in front (``given/f0/rows/boxes``); :func:`cut` selects one.

``tests/fixtures/torch_golden_dla34_bf16.npz`` holds the default
configuration's frames from the JAX step in bf16 (``TPU.COMPUTE_DTYPE``
and ``TPU.POOLER_DTYPE`` bfloat16): the yardstick of the port's bf16
frame, whose gap to it :func:`matched_gap` measures.
"""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_golden_dla34.npz")
TOGGLES_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                               "torch_golden_toggles.npz")
BF16_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                            "torch_golden_dla34_bf16.npz")
WEIGHTS = os.path.join(REPO, "fixtures", "bench_weights_f16.npz")
N_FRAMES = 4
H, W = 320, 576           # content = padded size (multiples of 32)
SEED = 42
ROW_FIELDS = ("boxes", "scores", "ids", "labels", "valid")
STATE_EXACT = ("ids", "labels", "active", "last_active", "next_id",
               "frame_idx")
# f32 on both sides, sums in other orders (XLA on the CPU against oneDNN
# or cuDNN, 33 convs deep): boxes to 1e-2 px, scores to 1e-4, template
# sums to 1e-4 of the slot's sum of magnitudes (sums of squares and of
# magnitudes relative to themselves); ids, labels, masks and the integer
# lanes exactly
BOX_ATOL = 1e-2
SCORE_ATOL = 1e-4
TEMPLATE_RTOL = 1e-4
# the toggles fixture's cuts: merge_from_list options over overrides()
CUTS = {
    "given": ["INPUT.AMODAL", True, "MODEL.TRACK_HEAD.MAX_DORMANT_FRAMES",
              30, "INFERENCE.USE_GIVEN_DETECTIONS", True],
    "unmasked": ["TPU.MASKED_TRACK_KERNELS", False],
    "wide_sr": ["MODEL.TRACK_HEAD.SEARCH_REGION", 5.0],
    "gather": ["TPU.POOLER_WINDOWED", False],
    "xla": ["TPU.USE_PALLAS", False, "TPU.DECODE_PALLAS", False],
}


def frames():
    """The ``N_FRAMES`` uint8 frames [1, H, W, 3] of the crowded scene."""
    from .synth import render_scene
    return render_scene(N_FRAMES, H, SEED, H, W)[0]


def overrides(dtype: str = "float32", cut_name: str = None) -> list:
    return ["TPU.COMPUTE_DTYPE", dtype, "TPU.POOLER_DTYPE", dtype] \
        + (CUTS[cut_name] if cut_name else [])


def given_detections() -> list:
    """Per golden frame, the public detections of the scene's sprites
    (``synth.public_detections``, seed ``SEED``), original resolution =
    the frame's."""
    from .synth import public_detections, render_scene
    boxes = render_scene(N_FRAMES, H, SEED, H, W)[1]
    return public_detections(boxes, (W, H), seed=SEED)


def template_summary(template: np.ndarray) -> np.ndarray:
    """[K, T, T, C] -> [K, 3]: per-slot sum, sum of squares and sum of
    magnitudes (f64)."""
    t = np.asarray(template, np.float64).reshape(template.shape[0], -1)
    return np.stack([t.sum(1), (t * t).sum(1), np.abs(t).sum(1)], 1)


def pack(outputs, states) -> dict:
    """Per-frame rows and track-state lanes as flat npz arrays."""
    out = {}
    for i, (o, s) in enumerate(zip(outputs, states)):
        for f in ROW_FIELDS:
            out[f"f{i}/rows/{f}"] = np.asarray(o[f])
        for f in STATE_EXACT + ("boxes", "sr"):
            out[f"f{i}/state/{f}"] = np.asarray(s[f])
        out[f"f{i}/state/template"] = template_summary(s["template"])
    return out


def run(device: str = "cuda", dtype: str = "float32",
        cut_name: str = None, extra=()) -> dict:
    """The port over the golden frames (under the cut ``cut_name`` of
    :data:`CUTS`, if given, and the ``extra`` options after it):
    :func:`pack` of its rows and states."""
    import torch

    from ..configs.defaults import get_cfg
    from ..engine.inferencer import GIVEN_DETECTION_CAPACITY
    from ..models.siammot import SiamMOT
    from .entities import entities_to_boxes
    from .weights import jax_to_torch, load_npz

    cfg = get_cfg()
    cfg.merge_from_list(overrides(dtype, cut_name) + list(extra))
    model = SiamMOT(cfg, device=device)
    net = model.cast_params(jax_to_torch(load_npz(WEIGHTS)))
    state = model.empty_state()
    dets = given_detections() if cfg.INFERENCE.USE_GIVEN_DETECTIONS \
        else [None] * N_FRAMES
    outs, states = [], []
    for f, d in zip(frames(), dets):
        given = None if d is None else entities_to_boxes(
            d, GIVEN_DETECTION_CAPACITY, device=device)
        out, state = model.forward_inference(net, torch.as_tensor(f),
                                             state, (W, H), given)
        outs.append(out.numpy())
        states.append(state.numpy())
    return pack(outs, states)


def decode_races(device: str = "cuda", dtype: str = "float32",
                 cut_name: str = None, n: int = 3, extra=()) -> list:
    """The ``n`` closest races of the decode's argmax over the golden
    frames (under the cut ``cut_name`` and the ``extra`` options, as
    :func:`run`), closest first: for each frame and
    decoded slot, p_conf's best and second-best cells
    (``ops/decode.py:penalized_confidence`` over the decode's own inputs)
    and their gap in ulps of the best.  A gap of 0 is an exact tie, which
    the first-index rule settles, so any change to the sums before the
    decode may move that row."""
    import torch

    from ..models import emm as emm_mod
    from ..ops.decode import STRIPED_MAX, penalized_confidence

    races, calls = [], []
    inner = emm_mod.decode_argmax

    def wrapped(x4, wh, u, window, valid, sigma, use_c, *rest):
        # the XLA decode (rest: stripe, xla) and the decode past s_hi
        # 1024 read every slot
        every = valid is None or (len(rest) > 1 and rest[1]) \
            or u.shape[0] > STRIPED_MAX
        slots = (valid.nonzero()[:, 0] if not every
                 else torch.arange(x4.shape[0], device=x4.device))
        frame = len(calls)
        calls.append(len(slots))
        for i in range(0, len(slots), 8):
            k = slots[i:i + 8]
            p, _ = penalized_confidence(x4[k], wh[k], u, window, sigma,
                                        use_c)
            top, cell = p.reshape(len(k), -1).topk(2)
            ulp = torch.nextafter(top[:, 0], torch.full_like(
                top[:, 0], float("inf"))) - top[:, 0]
            for j in range(len(k)):
                races.append(dict(
                    frame=frame, slot=int(k[j]),
                    cells=sorted(int(c) for c in cell[j]),
                    p_conf=[float(v) for v in top[j]],
                    ulps=float((top[j, 0] - top[j, 1]) / ulp[j])))
        return inner(x4, wh, u, window, valid, sigma, use_c, *rest)

    emm_mod.decode_argmax = wrapped
    try:
        run(device, dtype, cut_name, extra)
    finally:
        emm_mod.decode_argmax = inner
    return sorted(races, key=lambda r: r["ulps"])[:n]


def compare(got: dict, want: dict) -> dict:
    """Gaps of ``got`` against ``want`` over every frame: row-mask and id
    mismatches, the largest box and score errors on rows valid in both,
    the same for the state lanes, and whether all lie within the
    tolerances above."""
    r = dict(valid_mismatch=0, id_mismatch=0, label_mismatch=0,
             box_err=0.0, score_err=0.0, state_mismatch=0,
             state_box_err=0.0, template_rel_err=0.0)
    for i in range(N_FRAMES):
        g = {f: got[f"f{i}/rows/{f}"] for f in ROW_FIELDS}
        w = {f: want[f"f{i}/rows/{f}"] for f in ROW_FIELDS}
        r["valid_mismatch"] += int((g["valid"] != w["valid"]).sum())
        both = g["valid"] & w["valid"]
        r["id_mismatch"] += int((g["ids"][both] != w["ids"][both]).sum())
        r["label_mismatch"] += int(
            (g["labels"][both] != w["labels"][both]).sum())
        if both.any():
            r["box_err"] = max(r["box_err"], float(np.abs(
                g["boxes"][both] - w["boxes"][both]).max()))
            r["score_err"] = max(r["score_err"], float(np.abs(
                g["scores"][both] - w["scores"][both]).max()))
        for f in STATE_EXACT:
            r["state_mismatch"] += int(np.sum(
                got[f"f{i}/state/{f}"] != want[f"f{i}/state/{f}"]))
        for f in ("boxes", "sr"):
            r["state_box_err"] = max(r["state_box_err"], float(np.abs(
                got[f"f{i}/state/{f}"] - want[f"f{i}/state/{f}"]).max()))
        # the sum's error against the sum of magnitudes (a sum can cancel
        # to near zero), the other two against themselves
        tg, tw = got[f"f{i}/state/template"], want[f"f{i}/state/template"]
        den = np.maximum(tw[:, [2, 1, 2]], 1e-6)
        r["template_rel_err"] = max(r["template_rel_err"], float(
            (np.abs(tg - tw) / den).max()))
    r["live_rows"] = int(sum(want[f"f{i}/rows/valid"].sum()
                             for i in range(N_FRAMES)))
    r["live_slots"] = int((want[f"f{N_FRAMES - 1}/state/ids"] >= 0).sum())
    r["ok"] = (r["valid_mismatch"] == 0 and r["id_mismatch"] == 0
               and r["label_mismatch"] == 0 and r["state_mismatch"] == 0
               and r["box_err"] <= BOX_ATOL and r["score_err"] <= SCORE_ATOL
               and r["state_box_err"] <= 2 * BOX_ATOL
               and r["template_rel_err"] <= TEMPLATE_RTOL)
    return r


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU [len(a), len(b)] of x1y1x2y2 boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-9)


def matched_gap(got: dict, want: dict) -> dict:
    """A gap that survives rows moving (the bf16 frame against the f32
    fixture): each valid fixture row is matched to the valid row of
    ``got`` with the largest IoU.  Counts the fixture rows with no match
    of IoU >= 0.5 and, over matched pairs, the ids that differ (track
    rows, id >= 0 on either side) and the largest box and score errors."""
    r = dict(rows=0, unmatched=0, extra=0, ids_differ=0, box_err=0.0,
             score_err=0.0)
    for i in range(N_FRAMES):
        g = {f: got[f"f{i}/rows/{f}"] for f in ROW_FIELDS}
        w = {f: want[f"f{i}/rows/{f}"] for f in ROW_FIELDS}
        gv, wv = g["valid"].nonzero()[0], w["valid"].nonzero()[0]
        r["rows"] += len(wv)
        r["extra"] += max(len(gv) - len(wv), 0)
        if len(wv) == 0:
            continue
        if len(gv) == 0:
            r["unmatched"] += len(wv)
            continue
        iou = _iou(w["boxes"][wv], g["boxes"][gv])
        best = iou.argmax(1)
        ok = iou[np.arange(len(wv)), best] >= 0.5
        r["unmatched"] += int((~ok).sum())
        wi, gi = wv[ok], gv[best[ok]]
        if len(wi):
            r["box_err"] = max(r["box_err"], float(np.abs(
                g["boxes"][gi] - w["boxes"][wi]).max()))
            r["score_err"] = max(r["score_err"], float(np.abs(
                g["scores"][gi] - w["scores"][wi]).max()))
            tracked = (g["ids"][gi] >= 0) | (w["ids"][wi] >= 0)
            r["ids_differ"] += int((g["ids"][gi] != w["ids"][wi])[
                tracked].sum())
    return r


def load(path: str = FIXTURE) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def cut(data: dict, name: str) -> dict:
    """The frames of one cut of the toggles fixture, keys as in
    :func:`pack`."""
    pre = f"{name}/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
