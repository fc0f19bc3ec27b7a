"""Checkpoints of the port (counterpart of ``siammot_tpu.utils.checkpoint``).

Three formats:

  * the port's own: :class:`Checkpointer` writes ``model_{iteration:07d}
    .pth`` through ``torch.save``, holding the net's f32 state dict, the
    optimizer's state (``engine.solver.ScheduledSGD.state_dict``: the SGD
    momentum buffers and the update count, the schedule's place) and the
    iteration, so a resumed run continues where the saved one stopped;
  * the reference's ``.pth`` (maskrcnn names, OIHW convs, FrozenBatchNorm
    statistics): :func:`import_torch_checkpoint` and its inverse
    :func:`export_torch_checkpoint`, own copies of the JAX mapping, which
    goes through the flax tree's names (``utils.weights.torch_to_jax`` /
    ``jax_to_torch`` carry the port's state dict to and from them);
  * the flat flax tree as ``.npz`` (``utils.weights.load_npz`` /
    ``save_npz``), the JAX-free exchange format with the JAX package,
    whose own checkpoints are orbax directories.

:func:`load_model_file` reads any of the three for ``tools/test_net``.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

import numpy as np
import torch

from ..models.dla import s2d_to_stem, stem_to_s2d
from .weights import jax_to_torch, load_npz, torch_to_jax

logger = logging.getLogger(__name__)

_NATIVE = re.compile(r"model_(\d+)\.pth$")


class Checkpointer:
    """Save and load (net, optimizer state, iteration) under a directory."""

    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)

    def save(self, iteration: int, net, optimizer=None,
             tag: Optional[str] = None) -> str:
        """Write ``model_{iteration:07d}.pth`` (or ``{tag}.pth``).  ``net``
        is a module or a state dict (f32 masters in training).  The file
        appears whole or not at all: it is written under a temporary name
        and renamed, so an interrupted save leaves nothing that
        :meth:`latest` would pick."""
        sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
        payload = {"model": {k: v.detach().cpu() for k, v in sd.items()},
                   "optimizer": None if optimizer is None
                   else optimizer.state_dict(),
                   "iteration": int(iteration)}
        path = os.path.join(self.dir, f"{tag or f'model_{iteration:07d}'}"
                                      f".pth")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def latest(self) -> Optional[str]:
        """Highest-numbered checkpoint; ``model_final`` only when there is
        none (a stale final from an interrupted earlier run must not
        shadow newer periodic checkpoints)."""
        cands = [(int(m.group(1)), f) for f in os.listdir(self.dir)
                 if (m := _NATIVE.fullmatch(f))]
        if cands:
            return os.path.join(self.dir, max(cands)[1])
        final = os.path.join(self.dir, "model_final.pth")
        return final if os.path.isfile(final) else None

    def load(self, path: Optional[str] = None) -> Optional[dict]:
        """``{"model", "optimizer", "iteration"}`` of ``path`` (default:
        :meth:`latest`), on the CPU; None when there is none."""
        path = path or self.latest()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)


def resume(checkpointer: Checkpointer, net, optimizer) -> int:
    """Load the latest checkpoint into ``net`` and ``optimizer`` in place;
    returns its iteration (0 when there is none): ``do_train``'s
    ``start_iter``."""
    ckpt = checkpointer.load()
    if ckpt is None:
        return 0
    with torch.no_grad():
        net.load_state_dict(ckpt["model"], strict=True)
    if ckpt["optimizer"] is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    logger.info("resumed from %s at iter %d", checkpointer.latest(),
                ckpt["iteration"])
    return int(ckpt["iteration"])


def _is_reference(sd: dict) -> bool:
    return any(k.removeprefix("module.").startswith("backbone.")
               for k in sd)


def load_model_file(path: str, model) -> dict:
    """The state dict of ``model`` (``models.siammot.SiamMOT``) that a
    ``--model-file`` names: a port checkpoint (a ``.pth`` file, or a
    directory whose :meth:`Checkpointer.latest` is taken), a reference
    ``.pth`` (maskrcnn names, converted by :func:`import_torch_checkpoint`)
    or a flat flax-tree ``.npz``.  Raises on anything else."""
    if os.path.isdir(path):
        found = Checkpointer(path).latest()
        if found is None:
            raise FileNotFoundError(f"no model_*.pth checkpoint in {path}")
        path = found
    if path.endswith(".npz"):
        return jax_to_torch(load_npz(path))
    if not path.endswith(".pth"):
        raise ValueError(f"--model-file {path}: expected a .pth, a .npz or "
                         f"a directory of model_*.pth checkpoints")
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state.get("model", state)
    if _is_reference(sd):
        params, leftovers = import_torch_checkpoint(sd, model.cfg)
        logger.info("imported reference weights %s (%d unmatched keys)",
                    path, len(leftovers))
        return params
    logger.info("loaded checkpoint %s at iter %s", path,
                state.get("iteration"))
    return {k: v.float() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# the reference's .pth layout <-> the flax tree's names
# ---------------------------------------------------------------------------

def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def fold_frozen_bn(sd: dict, prefix: str) -> dict:
    """maskrcnn FrozenBatchNorm2d (no eps): scale = w / sqrt(var),
    bias = b - mean * scale."""
    w = sd[prefix + ".weight"]
    b = sd[prefix + ".bias"]
    mean = sd[prefix + ".running_mean"]
    var = sd[prefix + ".running_var"]
    scale = w / np.sqrt(var)
    return {"scale": scale, "bias": b - mean * scale}


def _template(cfg) -> dict:
    """The flat flax tree of ``cfg``'s network, as the port builds it."""
    from ..models.siammot import SiamMOT
    return torch_to_jax(SiamMOT(cfg, device="cpu").build_net().state_dict())


def import_torch_checkpoint(path_or_state, cfg):
    """Convert a reference ``.pth`` state dict into the port's state dict
    for ``cfg``'s network; returns (state dict, unmatched reference keys).

    The module-name mapping between the reference graph
    (``backbone.body/fpn``, ``rpn.head``, ``roi_heads.box/track``) and the
    flax tree, as ``siammot_tpu.utils.checkpoint.import_torch_checkpoint``
    does it: FrozenBN folded; a ResNet body by maskrcnn's names
    (``stem.conv1``/``bn1``, ``layer{s}.{b}.conv{1,2,3}``/``bn{1,2,3}``,
    ``downsample.{0,1}``); a DLA body's plain stem phase-decomposed onto
    the S2D stem (exact) or, with ``TPU.S2D_STEM`` False, taken as it is,
    and its trees, with a Bottle2neck's ``convs.{i}``/``bns.{i}``; fc6's
    input permuted from C-major to HWC.  A key of the network that the
    file lacks keeps the freshly built network's value.
    """
    if isinstance(path_or_state, (str, os.PathLike)):
        state = torch.load(path_or_state, map_location="cpu",
                           weights_only=False)
        state = state.get("model", state)
    else:
        state = path_or_state
    sd = {k.removeprefix("module."): np.asarray(v)
          for k, v in state.items() if hasattr(v, "shape")}

    flat = _template(cfg)
    out = dict(flat)
    used = set()

    def put(jkey: str, value: np.ndarray):
        if jkey not in flat:
            raise KeyError(f"no such param in the network: {jkey}")
        if flat[jkey].shape != value.shape:
            raise ValueError(
                f"{jkey}: shape {value.shape} vs {flat[jkey].shape}")
        out[jkey] = np.asarray(value).astype(flat[jkey].dtype)

    def conv(tkey: str, jprefix: str):
        put(jprefix + "/kernel", _conv_kernel(sd[tkey + ".weight"]))
        used.add(tkey + ".weight")
        if tkey + ".bias" in sd:
            put(jprefix + "/bias", sd[tkey + ".bias"])
            used.add(tkey + ".bias")

    def bn(tkey: str, jprefix: str):
        f = fold_frozen_bn(sd, tkey)
        put(jprefix + "/scale", f["scale"])
        put(jprefix + "/bias", f["bias"])
        for suf in (".weight", ".bias", ".running_mean", ".running_var"):
            used.add(tkey + suf)

    def dense(tkey: str, jprefix: str):
        put(jprefix + "/kernel", sd[tkey + ".weight"].T)
        used.add(tkey + ".weight")
        if tkey + ".bias" in sd:
            put(jprefix + "/bias", sd[tkey + ".bias"])
            used.add(tkey + ".bias")

    def gn(tkey: str, jprefix: str):
        put(jprefix + "/scale", sd[tkey + ".weight"])
        put(jprefix + "/bias", sd[tkey + ".bias"])
        used.add(tkey + ".weight")
        used.add(tkey + ".bias")

    # ---- body: a ResNet's stem and stages; or a DLA's stem (the plain
    # one onto the S2D stem, or as it is), then its trees
    body = "backbone.body."
    resnet = "params/body/stem_conv1/kernel" in flat
    if resnet:
        conv(body + "stem.conv1", "params/body/stem_conv1")
        bn(body + "stem.bn1", "params/body/stem_bn1")
        for st in (1, 2, 3, 4):
            b = 0
            while f"{body}layer{st}.{b}.conv1.weight" in sd:
                tb, jb = f"{body}layer{st}.{b}", f"params/body/layer{st}_{b}"
                for c in (1, 2, 3):
                    conv(f"{tb}.conv{c}", f"{jb}/conv{c}")
                    bn(f"{tb}.bn{c}", f"{jb}/bn{c}")
                if f"{tb}.downsample.0.weight" in sd:
                    conv(f"{tb}.downsample.0", f"{jb}/downsample_conv")
                    bn(f"{tb}.downsample.1", f"{jb}/downsample_bn")
                b += 1
    elif "params/body/stem/s2d_base_conv/kernel" in flat:
        s2d = stem_to_s2d(
            _conv_kernel(sd[body + "base_layer.0.weight"]),
            fold_frozen_bn(sd, body + "base_layer.1"),
            _conv_kernel(sd[body + "level0.0.weight"]),
            fold_frozen_bn(sd, body + "level0.1"),
            _conv_kernel(sd[body + "level1.0.weight"]),
            fold_frozen_bn(sd, body + "level1.1"))
        for mod, payload in s2d.items():
            for leaf, val in payload.items():
                put(f"params/body/stem/{mod}/{leaf}", val)
        for t in ("base_layer.0", "level0.0", "level1.0"):
            used.add(body + t + ".weight")
        for t in ("base_layer.1", "level0.1", "level1.1"):
            for suf in (".weight", ".bias", ".running_mean", ".running_var"):
                used.add(body + t + suf)
    else:
        conv(body + "base_layer.0", "params/body/base_conv")
        bn(body + "base_layer.1", "params/body/base_bn")
        for lvl in (0, 1):
            i = 0
            while f"{body}level{lvl}.{3 * i}.weight" in sd:
                conv(f"{body}level{lvl}.{3 * i}",
                     f"params/body/level{lvl}_conv{i}")
                bn(f"{body}level{lvl}.{3 * i + 1}",
                   f"params/body/level{lvl}_bn{i}")
                i += 1

    def map_block(tprefix: str, jprefix: str):
        for c in (1, 2, 3):
            if f"{tprefix}.conv{c}.weight" in sd:
                conv(f"{tprefix}.conv{c}", f"{jprefix}/conv{c}")
                bn(f"{tprefix}.bn{c}", f"{jprefix}/bn{c}")
        i = 0   # a Bottle2neck's split convs (nn.ModuleList convs/bns)
        while f"{tprefix}.convs.{i}.weight" in sd:
            conv(f"{tprefix}.convs.{i}", f"{jprefix}/convs_{i}")
            bn(f"{tprefix}.bns.{i}", f"{jprefix}/bns_{i}")
            i += 1

    def map_tree(tprefix: str, jprefix: str):
        if f"{tprefix}.project.0.weight" in sd:
            conv(f"{tprefix}.project.0", f"{jprefix}/project_conv")
            bn(f"{tprefix}.project.1", f"{jprefix}/project_bn")
        if f"{tprefix}.root.conv.weight" in sd:  # leaf tree
            map_block(f"{tprefix}.tree1", f"{jprefix}/tree1")
            map_block(f"{tprefix}.tree2", f"{jprefix}/tree2")
            conv(f"{tprefix}.root.conv", f"{jprefix}/root/conv")
            bn(f"{tprefix}.root.bn", f"{jprefix}/root/bn")
        else:
            map_tree(f"{tprefix}.tree1", f"{jprefix}/tree1")
            map_tree(f"{tprefix}.tree2", f"{jprefix}/tree2")

    for lvl in () if resnet else (2, 3, 4, 5):
        map_tree(f"{body}level{lvl}", f"params/body/level{lvl}")

    # ---- FPN, RPN head
    for i in (1, 2, 3, 4):
        conv(f"backbone.fpn.fpn_inner{i}", f"params/fpn/inner{i}")
        conv(f"backbone.fpn.fpn_layer{i}", f"params/fpn/layer{i}")
    conv("rpn.head.conv", "params/rpn/conv")
    conv("rpn.head.cls_logits", "params/rpn/cls_logits")
    conv("rpn.head.bbox_pred", "params/rpn/bbox_pred")

    # ---- box head.  fc6 consumes the flattened pooled features: torch
    # flattens [C, res, res] (C-major), the flax tree and the port [res,
    # res, C] (HWC), so fc6's input dimension is permuted
    fx = "roi_heads.box.feature_extractor."

    def dense_fc6(tkey: str, jkey: str):
        wt = sd[tkey + ".weight"]                       # [out, C*res*res]
        in_j = flat[jkey + "/kernel"].shape[0]
        c = flat["params/fpn/layer1/kernel"].shape[-1]
        res = int(np.sqrt(in_j // c))
        if res * res * c != in_j:
            raise ValueError(f"fc6 input {in_j} is not res^2 x {c}")
        wt = wt.reshape(-1, c, res, res).transpose(0, 2, 3, 1)
        put(jkey + "/kernel", wt.reshape(wt.shape[0], -1).T)
        used.add(tkey + ".weight")
        put(jkey + "/bias", sd[tkey + ".bias"])
        used.add(tkey + ".bias")

    dense_fc6(fx + "fc6", "params/box/feature_extractor/fc6")
    dense(fx + "fc7", "params/box/feature_extractor/fc7")
    dense("roi_heads.box.predictor.cls_score",
          "params/box/predictor/cls_score")
    dense("roi_heads.box.predictor.bbox_pred",
          "params/box/predictor/bbox_pred")

    # ---- EMM predictor (make_conv3x3 towers: [conv, gn] sequentials)
    tp = "roi_heads.track.tracker.predictor."
    conv(tp + "cls_tower.0", "params/emm/predictor/cls_tower_conv")
    gn(tp + "cls_tower.1", "params/emm/predictor/cls_tower_gn")
    conv(tp + "reg_tower.0", "params/emm/predictor/reg_tower_conv")
    gn(tp + "reg_tower.1", "params/emm/predictor/reg_tower_gn")
    conv(tp + "cls.0", "params/emm/predictor/cls")
    conv(tp + "center.0", "params/emm/predictor/center")
    conv(tp + "reg.0", "params/emm/predictor/reg")

    leftovers = sorted(k for k in sd if k not in used
                       and "num_batches_tracked" not in k
                       and not k.startswith("fc."))
    return jax_to_torch(out), leftovers


def export_torch_checkpoint(state_dict: dict) -> dict:
    """Inverse of :func:`import_torch_checkpoint`: a reference-named state
    dict of torch tensors (OIHW convs, transposed FCs, FrozenBN unfolded
    with running statistics at identity, an S2D stem projected back onto
    the plain stem).  Export then import gives the same tensors, bit for
    bit, for a ResNet body, a plain stem, or an S2D stem that came from a
    plain one; a stem trained in S2D form has no exact plain form, and the
    projection's relative error is logged as a warning when it passes
    1e-3."""
    flat = torch_to_jax(state_dict)
    sd: dict = {}

    def conv(tkey, jprefix):
        sd[tkey + ".weight"] = np.transpose(flat[jprefix + "/kernel"],
                                            (3, 2, 0, 1))
        if jprefix + "/bias" in flat:
            sd[tkey + ".bias"] = flat[jprefix + "/bias"]

    def bn(tkey, jprefix):
        scale = flat[jprefix + "/scale"]
        sd[tkey + ".weight"] = scale
        sd[tkey + ".bias"] = flat[jprefix + "/bias"]
        sd[tkey + ".running_mean"] = np.zeros_like(scale)
        sd[tkey + ".running_var"] = np.ones_like(scale)

    def dense(tkey, jprefix):
        sd[tkey + ".weight"] = flat[jprefix + "/kernel"].T
        if jprefix + "/bias" in flat:
            sd[tkey + ".bias"] = flat[jprefix + "/bias"]

    def gn(tkey, jprefix):
        sd[tkey + ".weight"] = flat[jprefix + "/scale"]
        sd[tkey + ".bias"] = flat[jprefix + "/bias"]

    body = "backbone.body."
    resnet = "params/body/stem_conv1/kernel" in flat
    if resnet:
        conv(body + "stem.conv1", "params/body/stem_conv1")
        bn(body + "stem.bn1", "params/body/stem_bn1")
        for st in (1, 2, 3, 4):
            b = 0
            while f"params/body/layer{st}_{b}/conv1/kernel" in flat:
                tb, jb = f"{body}layer{st}.{b}", f"params/body/layer{st}_{b}"
                for c in (1, 2, 3):
                    conv(f"{tb}.conv{c}", f"{jb}/conv{c}")
                    bn(f"{tb}.bn{c}", f"{jb}/bn{c}")
                if f"{jb}/downsample_conv/kernel" in flat:
                    conv(f"{tb}.downsample.0", f"{jb}/downsample_conv")
                    bn(f"{tb}.downsample.1", f"{jb}/downsample_bn")
                b += 1
    elif "params/body/stem/s2d_base_conv/kernel" in flat:
        _export_s2d_stem(flat, sd)
    else:
        conv(body + "base_layer.0", "params/body/base_conv")
        bn(body + "base_layer.1", "params/body/base_bn")
        for lvl in (0, 1):
            i = 0
            while f"params/body/level{lvl}_conv{i}/kernel" in flat:
                conv(f"{body}level{lvl}.{3 * i}",
                     f"params/body/level{lvl}_conv{i}")
                bn(f"{body}level{lvl}.{3 * i + 1}",
                   f"params/body/level{lvl}_bn{i}")
                i += 1

    def map_block(tprefix, jprefix):
        for c in (1, 2, 3):
            if f"{jprefix}/conv{c}/kernel" in flat:
                conv(f"{tprefix}.conv{c}", f"{jprefix}/conv{c}")
                bn(f"{tprefix}.bn{c}", f"{jprefix}/bn{c}")
        i = 0   # a Bottle2neck's split convs
        while f"{jprefix}/convs_{i}/kernel" in flat:
            conv(f"{tprefix}.convs.{i}", f"{jprefix}/convs_{i}")
            bn(f"{tprefix}.bns.{i}", f"{jprefix}/bns_{i}")
            i += 1

    def map_tree(tprefix, jprefix):
        if f"{jprefix}/project_conv/kernel" in flat:
            conv(f"{tprefix}.project.0", f"{jprefix}/project_conv")
            bn(f"{tprefix}.project.1", f"{jprefix}/project_bn")
        if f"{jprefix}/root/conv/kernel" in flat:  # leaf tree
            map_block(f"{tprefix}.tree1", f"{jprefix}/tree1")
            map_block(f"{tprefix}.tree2", f"{jprefix}/tree2")
            conv(f"{tprefix}.root.conv", f"{jprefix}/root/conv")
            bn(f"{tprefix}.root.bn", f"{jprefix}/root/bn")
        else:
            map_tree(f"{tprefix}.tree1", f"{jprefix}/tree1")
            map_tree(f"{tprefix}.tree2", f"{jprefix}/tree2")

    for lvl in () if resnet else (2, 3, 4, 5):
        map_tree(f"{body}level{lvl}", f"params/body/level{lvl}")

    for i in (1, 2, 3, 4):
        conv(f"backbone.fpn.fpn_inner{i}", f"params/fpn/inner{i}")
        conv(f"backbone.fpn.fpn_layer{i}", f"params/fpn/layer{i}")
    conv("rpn.head.conv", "params/rpn/conv")
    conv("rpn.head.cls_logits", "params/rpn/cls_logits")
    conv("rpn.head.bbox_pred", "params/rpn/bbox_pred")

    fx = "roi_heads.box.feature_extractor."
    jkey = "params/box/feature_extractor/fc6"
    k = flat[jkey + "/kernel"]                          # [res*res*C, out]
    c = flat["params/fpn/layer1/kernel"].shape[-1]
    res = int(np.sqrt(k.shape[0] // c))
    wt = k.T.reshape(-1, res, res, c).transpose(0, 3, 1, 2)
    sd[fx + "fc6.weight"] = wt.reshape(wt.shape[0], -1)
    sd[fx + "fc6.bias"] = flat[jkey + "/bias"]
    dense(fx + "fc7", "params/box/feature_extractor/fc7")
    dense("roi_heads.box.predictor.cls_score",
          "params/box/predictor/cls_score")
    dense("roi_heads.box.predictor.bbox_pred",
          "params/box/predictor/bbox_pred")

    tp = "roi_heads.track.tracker.predictor."
    conv(tp + "cls_tower.0", "params/emm/predictor/cls_tower_conv")
    gn(tp + "cls_tower.1", "params/emm/predictor/cls_tower_gn")
    conv(tp + "reg_tower.0", "params/emm/predictor/reg_tower_conv")
    gn(tp + "reg_tower.1", "params/emm/predictor/reg_tower_gn")
    conv(tp + "cls.0", "params/emm/predictor/cls")
    conv(tp + "center.0", "params/emm/predictor/center")
    conv(tp + "reg.0", "params/emm/predictor/reg")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _export_s2d_stem(flat: dict, sd: dict) -> None:
    """The S2D stem of ``flat`` projected onto the reference's plain stem
    entries of ``sd``; warns when the projection is lossy."""
    body = "backbone.body."
    s2d_tree = {mod: {leaf.rsplit("/", 1)[1]: flat[leaf] for leaf in flat
                      if leaf.startswith(f"params/body/stem/{mod}/")}
                for mod in ("s2d_base_conv", "s2d_base_bn", "s2d_level0_conv",
                            "s2d_level0_bn", "s2d_level1_conv",
                            "s2d_level1_bn")}
    c0 = s2d_tree["s2d_base_bn"]["scale"].shape[0] // 4
    c1 = s2d_tree["s2d_level1_bn"]["scale"].shape[0]
    std = s2d_to_stem(s2d_tree, c0, c1)
    rt = stem_to_s2d(std["base_conv"]["kernel"], std["base_bn"],
                     std["level0_conv0"]["kernel"], std["level0_bn0"],
                     std["level1_conv0"]["kernel"], std["level1_bn0"])
    num = den = 0.0
    for mod, payload in rt.items():
        for leaf, val in payload.items():
            orig = s2d_tree[mod][leaf]
            num += float(np.sum((orig - val) ** 2))
            den += float(np.sum(orig ** 2))
    rel = (num / max(den, 1e-20)) ** 0.5
    if rel > 1e-3:
        logger.warning(
            "S2D stem projection is LOSSY (relative error %.3f): this stem "
            "was trained in S2D form and has no exact plain form; the "
            "exported weights will underperform.", rel)
    for tconv, tbn, mconv, mbn in (
            ("base_layer.0", "base_layer.1", "base_conv", "base_bn"),
            ("level0.0", "level0.1", "level0_conv0", "level0_bn0"),
            ("level1.0", "level1.1", "level1_conv0", "level1_bn0")):
        sd[body + tconv + ".weight"] = np.transpose(std[mconv]["kernel"],
                                                    (3, 2, 0, 1))
        s = std[mbn]["scale"]
        sd[body + tbn + ".weight"] = s
        sd[body + tbn + ".bias"] = std[mbn]["bias"]
        sd[body + tbn + ".running_mean"] = np.zeros_like(s)
        sd[body + tbn + ".running_var"] = np.ones_like(s)


def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": v}`` -> ``{"a": {"b": {"c": v}}}``."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
