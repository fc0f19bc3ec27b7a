"""Write ``tests/fixtures/torch_golden_dla34.npz``: the JAX frame step's
rows and track-state lanes for the port's end-to-end check
(``siammot_tpu_torch/utils/golden.py`` says what it holds).

    JAX_PLATFORMS=cpu python tests/torch_port_golden.py [--toggles | --bf16]

Runs ``SiamMOT.forward_inference`` of the JAX package on the CPU (jitted
step, Pallas kernels in interpret mode or through their XLA forms, as the
JAX package's own CPU tests run them) with the repo's trained
DLA-34-FPN-EMM weights in float32, over the crowded synthetic scene's
first frames at 320x576.  Takes a few minutes.  ``--toggles`` writes
``tests/fixtures/torch_golden_toggles.npz`` instead: the same frames
under each cut of ``golden.CUTS`` (given public detections with the
MOT17 recipe's overrides, ``TPU.MASKED_TRACK_KERNELS`` False,
``SEARCH_REGION`` 5), each cut's keys prefixed with its name.
``--bf16`` writes ``tests/fixtures/torch_golden_dla34_bf16.npz``: the
default configuration's frames with ``TPU.COMPUTE_DTYPE`` and
``TPU.POOLER_DTYPE`` bfloat16, the yardstick of the port's bf16 frame.
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


def main():
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
