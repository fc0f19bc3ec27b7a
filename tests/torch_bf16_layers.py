"""Where the port's bf16 frame and the JAX step's bf16 frame part, layer
by layer, on the first golden frame (no tracks yet, so the detector
alone).

    JAX_PLATFORMS=cpu python tests/torch_bf16_layers.py

Runs the JAX package and the port on the CPU, each in float32 and in
bfloat16 (``TPU.COMPUTE_DTYPE`` and ``TPU.POOLER_DTYPE``), on the repo's
trained DLA-34-FPN-EMM weights and the crowded scene's first frame at
320x576 (``siammot_tpu_torch/utils/golden.py``), and prints for each
layer the largest error relative to the layer's largest magnitude:

- the FPN levels and the RPN's logits and box deltas;
- the box head's class logits and box deltas on one shared set of rois
  (the JAX f32 run's proposals), so that only the head's arithmetic
  differs;
- each run's own proposals against the JAX f32 run's: how many of the
  300 have no match at IoU 0.99 or 0.5;

and first, for each golden frame, the rows' gaps (``golden.matched_gap``)
between the port's bf16 frames, JAX's bf16 rows
(``tests/fixtures/torch_golden_dla34_bf16.npz``) and JAX's f32 rows.

Where the two bf16 steps lie equally far from f32 at every layer, their
rows part downstream, at discrete decisions (NMS, the solver's order of
new ids), and not through a precision the two compute differently.
Takes about a minute.
"""

import os
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from siammot_tpu.configs.defaults import get_cfg as jax_cfg  # noqa: E402
from siammot_tpu.models.box_head import pool_levels as jax_levels  # noqa
from siammot_tpu.models.rpn import select_proposals as jax_select  # noqa
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT  # noqa: E402
from siammot_tpu.models.siammot import normalize_images as jax_norm  # noqa
from siammot_tpu.ops.roi_align_windowed import pack_levels as jax_pack  # noqa
from siammot_tpu_torch.configs.defaults import get_cfg  # noqa: E402
from siammot_tpu_torch.models.box_head import pool_levels  # noqa: E402
from siammot_tpu_torch.models.rpn import select_proposals  # noqa: E402
from siammot_tpu_torch.models.siammot import SiamMOT  # noqa: E402
from siammot_tpu_torch.models.siammot import normalize_images  # noqa: E402
from siammot_tpu_torch.ops.roi_align_windowed import pack_levels  # noqa
from siammot_tpu_torch.utils import golden  # noqa: E402
from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz  # noqa
from torch_port_util import unflatten_params  # noqa: E402

DTYPES = ("float32", "bfloat16")
RUNS = (("jax", "float32"), ("jax", "bfloat16"), ("port", "float32"),
        ("port", "bfloat16"))


def jax_model(dtype):
    cfg = jax_cfg()
    cfg.merge_from_list(golden.overrides(dtype))
    model = JaxSiamMOT(cfg)
    params = model.cast_params(jax.tree.map(
        jnp.asarray, unflatten_params(load_npz(golden.WEIGHTS))))
    return model, params


def port_model(dtype):
    cfg = get_cfg()
    cfg.merge_from_list(golden.overrides(dtype))
    model = SiamMOT(cfg, device="cpu")
    return model, model.cast_params(jax_to_torch(load_npz(golden.WEIGHTS)))


def detector_maps(frame):
    """Per run: the FPN levels and the RPN's logits and deltas, NHWC f32
    numpy."""
    out = {}
    for dtype in DTYPES:
        model, params = jax_model(dtype)
        net = model.net
        img = jax_norm(jnp.asarray(frame), net.pixel_mean, net.pixel_std,
                       net.to_bgr255, frame_sizes=jnp.asarray(
                           [(golden.W, golden.H)], jnp.int32))
        feats = jax.jit(lambda p, i: net.apply(
            p, i, method=net.features))(params, img)
        lg, dl = jax.jit(lambda p, f: net.apply(
            p, f, method=net.rpn_maps))(params, feats)
        out["jax", dtype] = {k: [np.asarray(t) for t in v] for k, v in
                             (("fpn", feats), ("logits", lg),
                              ("deltas", dl))}
        model, net = port_model(dtype)
        cfg = model.cfg
        with torch.no_grad():
            x = normalize_images(
                torch.as_tensor(frame), cfg.INPUT.PIXEL_MEAN,
                cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255,
                frame_sizes=torch.tensor([(golden.W, golden.H)],
                                         dtype=torch.int32))
            feats = net.fpn(net.body(x.to(model.compute_dtype)))
            lg, dl = net.rpn(feats)
        out["port", dtype] = {
            "fpn": [f.permute(0, 2, 3, 1).float().numpy() for f in feats],
            "logits": [t.float().numpy() for t in lg],
            "deltas": [t.float().numpy() for t in dl]}
    return out


def proposals(maps, pkg, dtype):
    """(boxes, valid) of the run's own proposals."""
    m = maps[pkg, dtype]
    if pkg == "jax":
        model, _ = jax_model(dtype)
        b, _, v = jax_select([jnp.asarray(t) for t in m["logits"]],
                             [jnp.asarray(t) for t in m["deltas"]],
                             model.anchors_for((golden.H, golden.W)),
                             (golden.W, golden.H), model.rcfg_test)
    else:
        model, _ = port_model(dtype)
        b, _, v = select_proposals([torch.from_numpy(t) for t in
                                    m["logits"]],
                                   [torch.from_numpy(t) for t in
                                    m["deltas"]],
                                   model.anchors_for((golden.H, golden.W)),
                                   (golden.W, golden.H), model.rcfg)
    return np.asarray(b[0]), np.asarray(v[0])


def box_head(maps, rois, valid):
    """Per run: (class logits, box deltas) of the valid rois."""
    out = {}
    for dtype in DTYPES:
        model, params = jax_model(dtype)
        net = model.net
        n = len(net.box_scales)
        feats = [jnp.asarray(f) for f in maps["jax", dtype]["fpn"]]
        pack = jax_pack(feats[:n], net.box_scales, dtype=jnp.dtype(dtype))
        r = jnp.asarray(rois)
        cl, bd = net.apply(params, feats, r[None], jax_levels(r, n)[None],
                           pack, jnp.asarray(valid)[None],
                           method=net.box_predict)
        out["jax", dtype] = (np.asarray(cl[0])[valid],
                             np.asarray(bd[0])[valid])
        model, tnet = port_model(dtype)
        with torch.no_grad():
            feats = [torch.from_numpy(f) for f in maps["port", dtype]["fpn"]]
            pack = pack_levels(feats[:n], model.box_scales,
                               dtype=model.pooler_dtype)
            r = torch.from_numpy(rois.copy())
            cl, bd = tnet.box(pack, r, pool_levels(r, n),
                              torch.from_numpy(valid.copy()))
        out["port", dtype] = (cl.float().numpy()[valid],
                              bd.float().numpy()[valid])
    return out


def rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-12))


def row(name, got):
    """One layer: the two f32 runs, each bf16 run against JAX's f32, and
    the two bf16 runs against each other."""
    jf, jb, pf, pb = (got[r] for r in RUNS)
    print(f"{name:10s} port f32 vs JAX f32 {rel(pf, jf):.2e} | vs JAX f32: "
          f"JAX bf16 {rel(jb, jf):.2e}, port bf16 {rel(pb, jf):.2e} | "
          f"port bf16 vs JAX bf16 {rel(pb, jb):.2e}")


def frame_gaps():
    """Per golden frame, ``golden.matched_gap`` of the port's bf16 rows
    against JAX's bf16 rows, and of each bf16 step's rows against JAX's
    f32 rows."""
    f32, jax_bf16 = golden.load(), golden.load(golden.BF16_FIXTURE)
    port_bf16 = golden.run("cpu", "bfloat16")
    n = golden.N_FRAMES
    golden.N_FRAMES = 1
    try:
        for i in range(n):
            def one(d):
                return {k.replace(f"f{i}/", "f0/", 1): v
                        for k, v in d.items() if k.startswith(f"f{i}/")}
            for what, got, want in (
                    ("port bf16 vs JAX bf16", port_bf16, jax_bf16),
                    ("JAX bf16 vs JAX f32", jax_bf16, f32),
                    ("port bf16 vs JAX f32", port_bf16, f32)):
                print(f"frame {i} {what}: "
                      f"{golden.matched_gap(one(got), one(want))}")
    finally:
        golden.N_FRAMES = n


def main():
    frame_gaps()
    maps = detector_maps(golden.frames()[0])
    for key in ("fpn", "logits", "deltas"):
        for i in range(len(maps["jax", "float32"][key])):
            row(f"{key} {i}", {r: maps[r][key][i] for r in RUNS})
    rois, valid = proposals(maps, "jax", "float32")
    heads = box_head(maps, rois, valid)
    row("box cls", {r: heads[r][0] for r in RUNS})
    row("box delta", {r: heads[r][1] for r in RUNS})
    ref = rois[valid]
    for run in RUNS[1:]:
        b, v = proposals(maps, *run)
        best = golden._iou(b[v], ref).max(1)
        print(f"proposals {run[0]} {run[1]}: {int(v.sum())} against "
              f"{len(ref)}, no match at IoU 0.99: {int((best < 0.99).sum())}"
              f", at IoU 0.5: {int((best < 0.5).sum())}")


if __name__ == "__main__":
    main()
