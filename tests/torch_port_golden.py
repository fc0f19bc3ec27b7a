"""Write ``tests/fixtures/torch_golden_dla34.npz``: the JAX frame step's
rows and track-state lanes for the port's end-to-end check
(``siammot_tpu_torch/utils/golden.py`` says what it holds).

    JAX_PLATFORMS=cpu python tests/torch_port_golden.py \
        [--toggles | --bf16 | --dataset | --multistream]

Runs ``SiamMOT.forward_inference`` of the JAX package on the CPU (jitted
step, Pallas kernels in interpret mode or through their XLA forms, as the
JAX package's own CPU tests run them) with the repo's trained
DLA-34-FPN-EMM weights in float32, over the crowded synthetic scene's
first frames at 320x576.  Takes a few minutes.  ``--toggles`` writes
``tests/fixtures/torch_golden_toggles.npz`` instead: the same frames
under each cut of ``golden.CUTS`` (given public detections with the
MOT17 recipe's overrides, ``TPU.MASKED_TRACK_KERNELS`` False,
``SEARCH_REGION`` 5, ``TPU.POOLER_WINDOWED`` False, ``TPU.USE_PALLAS``
and ``DECODE_PALLAS`` False), each cut's keys prefixed with its name.
``--bf16`` writes ``tests/fixtures/torch_golden_dla34_bf16.npz``: the
default configuration's frames with ``TPU.COMPUTE_DTYPE`` and
``TPU.POOLER_DTYPE`` bfloat16, the yardstick of the port's bf16 frame.
``--dataset`` writes ``tests/fixtures/torch_golden_dataset.json.gz``: the
JAX ``DatasetInference`` over ``tests/fixtures/synmot_mini`` in each run
of ``siammot_tpu_torch/utils/dataset_golden.py``'s ``RUNS`` (what it
holds is said there; a few minutes).  ``--multistream`` writes
``tests/fixtures/torch_golden_multistream.json.gz``: the JAX
``DatasetInference(n_streams=2)`` over ``tests/fixtures/synmot_multi`` in
each run of ``dataset_golden.MULTI_RUNS`` (about two minutes).
``--export-npz CKPT OUT`` converts
the JAX package's orbax checkpoint CKPT (a ``model_*`` directory) into a
flat flax-tree ``.npz`` that the port reads (``--model-file OUT``).
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from siammot_tpu.configs.defaults import get_cfg  # noqa: E402
from siammot_tpu.models.siammot import SiamMOT  # noqa: E402
from siammot_tpu.utils.entities import entities_to_boxes  # noqa: E402
from siammot_tpu_torch.utils import golden  # noqa: E402
from siammot_tpu_torch.utils.weights import load_npz  # noqa: E402
from torch_port_util import unflatten_params  # noqa: E402


def run_jax(cut_name=None, dtype="float32"):
    """The JAX step over the golden frames (under a cut of
    ``golden.CUTS``) in ``dtype``: ``golden.pack`` of its rows and
    states."""
    t0 = time.time()
    cfg = get_cfg()
    cfg.merge_from_list(golden.overrides(dtype, cut_name))
    model = SiamMOT(cfg)
    params = jax.tree.map(jnp.asarray,
                          unflatten_params(load_npz(golden.WEIGHTS)))
    step = model.jit_step(image_size=(golden.W, golden.H))
    state = model.empty_state()
    dets = golden.given_detections() \
        if cfg.INFERENCE.USE_GIVEN_DETECTIONS else None
    outs, states = [], []
    for i, f in enumerate(golden.frames()):
        if dets is None:
            out, state = step(params, jnp.asarray(f), state)
        else:
            out, state = step(params, jnp.asarray(f), state,
                              entities_to_boxes(dets[i], 128))
        outs.append({k: np.asarray(getattr(out, k))
                     for k in golden.ROW_FIELDS})
        states.append({k: np.asarray(v) for k, v in
                       state._asdict().items()} if hasattr(state, "_asdict")
                      else {k: np.asarray(getattr(state, k)) for k in
                            golden.STATE_EXACT + ("boxes", "sr",
                                                  "template")})
        print(f"{cut_name or 'default'} frame {len(outs)}: "
              f"{int(outs[-1]['valid'].sum())} valid rows, "
              f"{int((states[-1]['ids'] >= 0).sum())} live slots "
              f"({time.time() - t0:.0f} s)", flush=True)
    return golden.pack(outs, states)


def run_dataset(folder="synmot_mini", runs=None, n_streams=1) -> dict:
    """The JAX ``DatasetInference`` (with ``n_streams``) over the committed
    sequences under ``tests/fixtures/<folder>`` in every run of ``runs``
    (default ``dataset_golden.RUNS``), and the frames' digests as the JAX
    package decoded them."""
    import tempfile

    from siammot_tpu.data import native
    from siammot_tpu.data.filters import build_data_filter_fn
    from siammot_tpu.data.motion_dataset import DataSample, MotionDataset
    from siammot_tpu.data.transforms import EvalTransform
    from siammot_tpu.data.video_loader import (normalized_frame_source,
                                               resolve_data_path)
    from siammot_tpu.engine.inferencer import DatasetInference
    from siammot_tpu_torch.utils import dataset_golden as dg

    root = os.path.join(dg.ROOT_DIR, folder)
    ds = MotionDataset("anno.json", root_path=root)
    samples = ds.get_split("test")
    pub = dict(MotionDataset("anno_pub_detection.json", root_path=root))
    params = jax.tree.map(jnp.asarray, unflatten_params(load_npz(dg.WEIGHTS)))
    out = {"decoder": "libjpeg" if native.available() else "cv2",
           "frames": {}, "runs": {}}
    for run in runs or dg.RUNS:
        t0 = time.time()
        cfg = get_cfg()
        cfg.merge_from_file(dg.RECIPE)
        cfg.merge_from_list(dg.overrides(run))
        if not out["frames"]:
            tr = EvalTransform(cfg)
            for sid, s in samples:
                src = normalized_frame_source(
                    resolve_data_path(s, ds.data_root_path), tr)
                out["frames"][sid] = dg.frame_digests(x for x, _ in src)
        with tempfile.TemporaryDirectory() as tmp:
            inf = DatasetInference(
                cfg, SiamMOT(cfg), params, samples, tmp,
                build_data_filter_fn("SYNMOT_HARD"),
                pub if cfg.INFERENCE.USE_GIVEN_DETECTIONS else None,
                dataset_root=ds.data_root_path, n_streams=n_streams)
            accs, text = inf()
            preds = {sid: DataSample.load(os.path.join(tmp, f"{sid}.json"))
                     .to_dict() for sid, _ in samples}
        out["runs"][run] = {
            "predictions": preds,
            "tracks": {sid: r.to_dict() for sid, r in inf.results.items()},
            "summary": dg.summaries(accs), "summary_text": text}
        overall = out["runs"][run]["summary"]["OVERALL"]
        print(f"{run}: {dg.summary_line(overall)} ({time.time() - t0:.0f} s)",
              flush=True)
    return out


def export_npz(ckpt: str, path: str) -> None:
    """An orbax checkpoint of the JAX package -> a flat flax-tree npz."""
    from siammot_tpu.utils.checkpoint import Checkpointer, _flatten
    restored = Checkpointer(os.path.dirname(os.path.abspath(ckpt))).load(
        ckpt, like=None)
    flat = {f"params/{k}" if not k.startswith("params/") else k:
            np.asarray(v) for k, v in _flatten(restored["params"]).items()}
    np.savez(path, **flat)
    print(f"wrote {path} ({len(flat)} arrays, iteration "
          f"{restored.get('iteration')})")


def main():
    if "--export-npz" in sys.argv[1:]:
        i = sys.argv.index("--export-npz")
        export_npz(sys.argv[i + 1], sys.argv[i + 2])
        return
    if "--multistream" in sys.argv[1:]:
        from siammot_tpu_torch.utils import dataset_golden as dg
        data = run_dataset("synmot_multi", dg.MULTI_RUNS, dg.MULTI_STREAMS)
        dg.dump(data, dg.MULTI_FIXTURE)
        print(f"wrote {dg.MULTI_FIXTURE} "
              f"({os.path.getsize(dg.MULTI_FIXTURE)} B)")
        return
    if "--dataset" in sys.argv[1:]:
        from siammot_tpu_torch.utils import dataset_golden as dg
        data = run_dataset()
        dg.dump(data)
        print(f"wrote {dg.FIXTURE} ({os.path.getsize(dg.FIXTURE)} B)")
        return
    if "--toggles" in sys.argv[1:]:
        path = golden.TOGGLES_FIXTURE
        data = {f"{name}/{k}": v for name in golden.CUTS
                for k, v in run_jax(name).items()}
    elif "--bf16" in sys.argv[1:]:
        path, data = golden.BF16_FIXTURE, run_jax(dtype="bfloat16")
    else:
        path, data = golden.FIXTURE, run_jax()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **data)
    print(f"wrote {path} ({os.path.getsize(path)} B)")


if __name__ == "__main__":
    main()
