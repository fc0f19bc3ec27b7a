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
    the layout its CUDA kernel reads; so does the kernel of a deformable
    conv (``.../conv2/kernel`` beside ``.../conv2/offset/{kernel,bias}``),
    which kernel 9 reads as [9 * C, Co] rows.  Its offset conv is a plain
    conv and converts like one;
  * FrozenBN and GroupNorm ``scale``/``bias`` keep their names.

A JAX gradient tree has the parameter tree's layout, so the same
conversion carries gradients across (the training parity tests do).
:func:`torch_to_jax` is its inverse, for writing the flat tree back
(``save_npz``).  ``load_npz`` reads the f16 bench weights as f32: the
training step's master parameters (``SiamMOT.build_master``).
``seeded_params`` draws weights for a network the repo has none for (the
DCN, ResNet and Res2Net bodies).
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
    # a module with an ``offset`` child is a deformable conv
    dcn = {".".join(k.split("/")[1:-2]) for k in flat
           if k.split("/")[-2:-1] == ["offset"]}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != "params" or len(parts) < 3:
            raise KeyError(f"not a flax parameter key: {key}")
        path, leaf = ".".join(parts[1:-1]), parts[-1]
        a = np.asarray(arr)
        if leaf == "kernel" and not (path + ".").startswith(_PREDICTOR) \
                and path not in dcn:
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


def torch_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`jax_to_torch`: a port state dict -> the flat flax
    tree (``{"params/...": ndarray}``, dtypes kept).  A ``weight`` is a
    conv or dense weight and goes back to HWIO or [in, out] under
    ``kernel``; ``kernel``, ``bias`` and ``scale`` keep their layout."""
    out = {}
    for name, t in state_dict.items():
        path, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        if leaf == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected weight rank {a.ndim}: {name}")
            leaf = "kernel"
        elif leaf not in ("kernel", "bias", "scale"):
            raise KeyError(f"unknown parameter leaf: {name}")
        out["params/" + path.replace(".", "/") + "/" + leaf] = \
            np.ascontiguousarray(a)
    return out


def save_npz(path: str, state_dict: dict) -> None:
    """Write a port state dict as a flat flax-tree ``.npz`` (the layout of
    ``fixtures/bench_weights_f16.npz``, which the JAX package reads)."""
    np.savez(path, **torch_to_jax(state_dict))


def load_npz(path: str) -> dict:
    """Read a flat flax-tree ``.npz`` into float32 numpy arrays."""
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


RESIDUAL_SCALE = 0.2   # a seeded ResNet block's last FrozenBN scale


def seeded_params(model, frame, seed: int = 102) -> tuple:
    """Seeded weights for a network without trained weights in the repo
    (the DLA-102-DCN-FPN, ResNet and Res2Net slices): kernels
    N(0, 1/fan_in), norm scales ~1, biases small, the box classifier
    biased to the foreground so that tracks start.  A ResNet body's stem
    conv is divided by the standard deviation of the normalised
    ``frame`` (uint8 [1, H, W, 3]; the Caffe2 recipes feed 0-255 pixels)
    and each bottleneck's ``bn3`` scale is multiplied by
    ``RESIDUAL_SCALE``, so that activations stay O(1) through R-152's 50
    residual additions.  The offset convs of the deformable layers are
    then scaled on ``frame`` so that their outputs have a standard
    deviation of 0.35 px, inside kernel 9's window, or, for every fourth
    stride-1 layer, 1.0 px, outside it: the reference zero-initialises
    them, which would make DCN a plain conv.  Last, each FPN output conv
    is scaled so that its level has unit standard deviation on ``frame``:
    the heads then see O(1) features and propose boxes near their
    anchors, as trained weights do (unscaled, DLA-102's levels reach a
    few hundred, the RPN's deltas clip proposals to zero width, and a
    training step's regression targets overflow).  Returns (state dict
    on the CPU, number of deformable layers)."""
    from ..models.dla import DeformConv
    from ..models.siammot import normalize_images

    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, t in model.build_net().state_dict().items():
        if name.endswith("scale"):
            v = 1.0 + 0.05 * torch.randn(t.shape, generator=g)
        elif name.endswith(("weight", "kernel")) and t.dim() > 1:
            hwio = name.endswith("kernel")      # HWIO, else [out, in, ...]
            fan_in = int(np.prod(t.shape[:-1] if hwio else t.shape[1:]))
            v = torch.randn(t.shape, generator=g) / fan_in ** 0.5
        else:
            v = 0.05 * torch.randn(t.shape, generator=g)
        params[name] = v
    params["box.predictor.cls_score.bias"] = torch.tensor([-3.0, 3.0])
    cfg = model.cfg
    x = normalize_images(torch.as_tensor(frame).to(model.device),
                         cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                         cfg.INPUT.TO_BGR255)
    if "body.stem_conv1.weight" in params:
        params["body.stem_conv1.weight"] /= float(x.std())
    for name in params:
        if name.startswith("body.") and name.endswith(("bn3.scale",
                                                       "root.bn.scale")):
            params[name] *= RESIDUAL_SCALE
    net = model.cast_params(params)
    stds, strides, hooks = {}, {}, []
    for name, m in net.body.named_modules():
        if isinstance(m, DeformConv):
            strides[name] = m.stride
            hooks.append(m.offset.register_forward_hook(
                lambda mod, a, out, name=name: stds.__setitem__(
                    name, float(out.float().std()))))
    with torch.no_grad():
        feats = net.fpn(net.body(x.to(model.compute_dtype)))
    for h in hooks:
        h.remove()
    for i, f in enumerate(feats[:-1], start=1):    # P6 is P5 subsampled
        std = float(f.float().std())
        for leaf in ("weight", "bias"):
            params[f"fpn.layer{i}.{leaf}"] /= max(std, 1e-12)
    stride1 = [n for n in stds if strides[n] == 1]
    for name, std in stds.items():
        want = 1.0 if name in stride1[3::4] else 0.35
        for leaf in ("weight", "bias"):
            params[f"body.{name}.offset.{leaf}"] *= want / max(std, 1e-12)
    return params, len(stds)
