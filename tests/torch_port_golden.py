"""Write ``tests/fixtures/torch_golden_dla34.npz``: the JAX frame step's
rows and track-state lanes for the port's end-to-end check
(``siammot_tpu_torch/utils/golden.py`` says what it holds).

    JAX_PLATFORMS=cpu python tests/torch_port_golden.py

Runs ``SiamMOT.forward_inference`` of the JAX package on the CPU (jitted
step, Pallas kernels in interpret mode or through their XLA forms, as the
JAX package's own CPU tests run them) with the repo's trained
DLA-34-FPN-EMM weights in float32, over the crowded synthetic scene's
first frames at 320x576.  Takes a few minutes.
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
from siammot_tpu_torch.utils import golden  # noqa: E402
from siammot_tpu_torch.utils.weights import load_npz  # noqa: E402
from torch_port_util import unflatten_params  # noqa: E402


def main():
    t0 = time.time()
    cfg = get_cfg()
    cfg.merge_from_list(golden.overrides("float32"))
    model = SiamMOT(cfg)
    params = jax.tree.map(jnp.asarray,
                          unflatten_params(load_npz(golden.WEIGHTS)))
    step = model.jit_step(image_size=(golden.W, golden.H))
    state = model.empty_state()
    outs, states = [], []
    for f in golden.frames():
        out, state = step(params, jnp.asarray(f), state)
        outs.append({k: np.asarray(getattr(out, k))
                     for k in golden.ROW_FIELDS})
        states.append({k: np.asarray(v) for k, v in
                       state._asdict().items()} if hasattr(state, "_asdict")
                      else {k: np.asarray(getattr(state, k)) for k in
                            golden.STATE_EXACT + ("boxes", "sr",
                                                  "template")})
        print(f"frame {len(outs)}: {int(outs[-1]['valid'].sum())} valid "
              f"rows, {int((states[-1]['ids'] >= 0).sum())} live slots "
              f"({time.time() - t0:.0f} s)", flush=True)
    data = golden.pack(outs, states)
    os.makedirs(os.path.dirname(golden.FIXTURE), exist_ok=True)
    np.savez_compressed(golden.FIXTURE, **data)
    print(f"wrote {golden.FIXTURE} ({os.path.getsize(golden.FIXTURE)} B)")


if __name__ == "__main__":
    main()
