"""Weight conversion from the JAX package's flax tree to the port.

The flax tree is stored flat, one ``params/<module path>/<leaf>`` key per
array (``fixtures/bench_weights_f16.npz``).  The port's modules nest
under the same names, so a key maps to a state-dict entry by its path
alone; only the leaf and the layout change:

  * conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw];
  * dense ``kernel`` [in, out] -> ``weight`` [out, in].  The box head's
    fc6 input is the pooled map flattened in (h, w, c) order on both
    sides, because the port's pool returns NHWC like the JAX pool;
  * the EMM predictor's conv kernels stay HWIO under ``kernel``: that is
    the layout its CUDA kernel reads;
  * FrozenBN and GroupNorm ``scale``/``bias`` keep their names.

A JAX gradient tree has the parameter tree's layout, so the same
conversion carries gradients across (the training parity tests do).
``load_npz`` reads the f16 bench weights as f32: the training step's
master parameters (``SiamMOT.build_master``).
"""

from __future__ import annotations

import numpy as np
import torch

_PREDICTOR = "emm.predictor."


def jax_to_torch(flat: dict) -> dict:
    """Convert a flat flax-tree dict (``{"params/...": ndarray}``) into a
    state dict for ``models.siammot.SiamMOTNet``.  Dtypes are kept; the
    model casts once when it loads them."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != "params" or len(parts) < 3:
            raise KeyError(f"not a flax parameter key: {key}")
        path, leaf = ".".join(parts[1:-1]), parts[-1]
        a = np.asarray(arr)
        if leaf == "kernel" and not (path + ".").startswith(_PREDICTOR):
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected kernel rank {a.ndim}: {key}")
            leaf = "weight"
        elif leaf not in ("kernel", "bias", "scale"):
            raise KeyError(f"unknown parameter leaf: {key}")
        name = f"{path}.{leaf}"
        if name in out:
            raise KeyError(f"two keys map to {name}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_npz(path: str) -> dict:
    """Read a flat flax-tree ``.npz`` into float32 numpy arrays."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}
