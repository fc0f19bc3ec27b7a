"""Checkpoint I/O of the port (``siammot_tpu_torch/utils/checkpoint.py``)
against the JAX package's (``siammot_tpu/utils/checkpoint.py``).

* The reference ``.pth`` layout: the port's ``import_torch_checkpoint``
  gives, bit for bit, what the JAX import followed by ``jax_to_torch``
  gives, on the state dict that the JAX ``export_torch_checkpoint`` writes
  from drawn DLA-34 weights (S2D stem phase-decomposed from the plain
  stem, FrozenBN folded, also with drawn running statistics, fc6's input
  permuted); the port's export equals the JAX export; export then import
  is the identity, bit for bit.
* The flat flax tree: ``torch_to_jax(jax_to_torch(t)) == t`` bit for bit.
* The native format: ``Checkpointer`` names, the ``latest`` rule, the
  atomic save; ``load_model_file`` reads each format to the same tensors;
  and a resumed CPU training run (DLA-MINI, 2 steps + save + load + 2
  steps, one thread) ends bitwise where 4 uninterrupted steps end.

Every comparison here is exact: the conversions move and reorder values
with the same numpy operations on both sides.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.utils import checkpoint as jax_ckpt
from siammot_tpu_torch.configs.defaults import dla_dcn_overrides, get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.solver import build_train_step, make_optimizer
from siammot_tpu_torch.engine.trainer import do_train
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils import checkpoint as ckpt
from siammot_tpu_torch.utils.weights import (jax_to_torch, load_npz,
                                             save_npz, torch_to_jax)
from torch_port_util import MINI, random_flax_params, unflatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "fixtures", "bench_weights_f16.npz")


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def drawn():
    """Drawn DLA-34-FPN-EMM weights: the JAX tree and the reference state
    dict its export writes (with drawn FrozenBN statistics on one BN)."""
    jmodel = JaxSiamMOT(jax_get_cfg())
    flat = random_flax_params(jmodel, (64, 64), seed=3)
    tree = jax.tree.map(np.asarray, unflatten_params(flat))
    ref = jax_ckpt.export_torch_checkpoint(tree)
    return tree, ref


def test_torch_to_jax_inverts_jax_to_torch():
    flat = load_npz(BENCH)
    back = torch_to_jax(jax_to_torch(flat))
    _same(back, flat)
    # a deformable body: DCN kernels and their offset convs
    cfg = get_cfg()
    cfg.merge_from_list(MINI + dla_dcn_overrides("DLA-46-C-FPN"))
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in
          SiamMOT(cfg, device="cpu").build_net().state_dict().items()}
    assert any(k.endswith("conv2.kernel") for k in sd)
    _same(jax_to_torch(torch_to_jax(sd)), sd)


def test_import_matches_jax_import(drawn):
    tree, ref = drawn
    ref = dict(ref)
    rng = np.random.RandomState(5)
    bn = sorted(k[:-len(".weight")] for k in ref
                if k.startswith("backbone.body.level3.")
                and k.endswith(".bn1.weight"))[0]
    for k in (bn, "backbone.body.base_layer.1"):
        c = ref[k + ".weight"].shape[0]
        ref[k + ".running_mean"] = rng.randn(c).astype(np.float32)
        ref[k + ".running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    got, left = ckpt.import_torch_checkpoint(
        {k: torch.from_numpy(v) for k, v in ref.items()}, get_cfg())
    want, jleft = jax_ckpt.import_torch_checkpoint(ref, tree)
    assert left == jleft == []
    _same(got, jax_to_torch(jax_ckpt._flatten(want)))
    # the folded statistics and the fc6 permutation, spelled out
    f = jax_ckpt.fold_frozen_bn(ref, bn)
    np.testing.assert_array_equal(
        got[bn.removeprefix("backbone.") + ".scale"].numpy(), f["scale"])
    assert not np.array_equal(f["scale"], ref[bn + ".weight"])
    w = ref["roi_heads.box.feature_extractor.fc6.weight"]
    np.testing.assert_array_equal(
        got["box.feature_extractor.fc6.weight"].numpy(),
        w.reshape(-1, 128, 7, 7).transpose(0, 2, 3, 1).reshape(w.shape[0], -1))


def test_export_matches_jax_export_and_round_trips(drawn, caplog):
    tree, ref = drawn
    sd = jax_to_torch(jax_ckpt._flatten(tree))
    with caplog.at_level(logging.WARNING):
        out = ckpt.export_torch_checkpoint(sd)
    assert "LOSSY" in caplog.text       # a drawn S2D stem has no plain form
    _same(out, ref)
    # a stem that came from a plain one: export then import, bit for bit
    port, _ = ckpt.import_torch_checkpoint(out, get_cfg())
    again = ckpt.export_torch_checkpoint(port)
    _same(again, out)
    back, left = ckpt.import_torch_checkpoint(again, get_cfg())
    assert left == []
    _same(back, port)
    # the S2D stem is the phase decomposition of the plain one
    s2d = port["body.stem.s2d_base_conv.weight"].numpy()
    assert s2d.shape == (64, 12, 5, 5)


def test_unmatched_reference_keys_are_reported(drawn):
    _, ref = drawn
    extra = dict(ref, **{"roi_heads.extra.weight": np.zeros(3, np.float32),
                         "fc.weight": np.zeros(2, np.float32)})
    _, left = ckpt.import_torch_checkpoint(extra, get_cfg())
    assert left == ["roi_heads.extra.weight"]


def test_checkpointer_names_latest_and_atomic_save(tmp_path):
    c = ckpt.Checkpointer(str(tmp_path))
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    assert c.latest() is None and c.load() is None
    c.save(7, sd, tag="model_final")
    assert c.latest().endswith("model_final.pth")
    c.save(7, sd)
    c.save(12, sd)
    # a save cut off before its rename leaves only a temporary name
    (tmp_path / "model_0000099.pth.123.tmp").write_bytes(b"partial")
    assert sorted(os.listdir(tmp_path))[:3] == [
        "model_0000007.pth", "model_0000012.pth", "model_0000099.pth.123.tmp"]
    assert c.latest().endswith("model_0000012.pth")
    got = c.load()
    assert got["iteration"] == 12 and got["optimizer"] is None
    _same(got["model"], sd)


def test_load_model_file_reads_every_format(tmp_path, drawn):
    model = SiamMOT(get_cfg(), device="cpu")
    want = jax_to_torch(load_npz(BENCH))
    _same(ckpt.load_model_file(BENCH, model), want)
    npz = str(tmp_path / "tree.npz")
    save_npz(npz, want)
    _same(ckpt.load_model_file(npz, model), want)
    path = ckpt.Checkpointer(str(tmp_path / "run")).save(3, want)
    _same(ckpt.load_model_file(path, model), want)
    _same(ckpt.load_model_file(str(tmp_path / "run"), model), want)
    # a reference .pth, maskrcnn-style ({"model": ...}, "module." names)
    _, ref = drawn
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in ref.items()}, "iteration": 1}, pth)
    _same(ckpt.load_model_file(pth, model),
          ckpt.import_torch_checkpoint(ref, get_cfg())[0])
    with pytest.raises(ValueError):
        ckpt.load_model_file(str(tmp_path / "weights.bin"), model)


def _train_setup(seed: int = 0):
    cfg = get_cfg()
    cfg.merge_from_list(MINI + [
        "TPU.MAX_TRACKS", 8, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
        "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8, "TPU.MAX_GT", 4,
        "SOLVER.WARMUP_ITERS", 3])
    model = SiamMOT(cfg, device="cpu")
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy(
        (rng.randn(*v.shape) * 0.05
         + (1.0 if k.endswith("scale") else 0.0)).astype(np.float32))
        for k, v in model.build_net().state_dict().items()}
    net = model.build_master(params)
    opt = make_optimizer(cfg, net)
    return model, net, opt


def _batches(n):
    rng = np.random.RandomState(1)
    out = []
    for i in range(n):
        imgs = torch.from_numpy(rng.randint(0, 255, (2, 64, 96, 3)).astype(
            np.uint8))
        boxes = torch.tensor([[[4., 6., 40., 50.], [30., 10., 70., 40.],
                               [50., 20., 90., 60.], [0., 0., 0., 0.]]] * 2)
        boxes[:, :3] += float(i)
        gt = Boxes(boxes=boxes, scores=torch.ones(2, 4),
                   ids=torch.tensor([[0, 1, 2, -1]] * 2, dtype=torch.int32),
                   labels=torch.tensor([[1, 1, 1, 0]] * 2, dtype=torch.int32),
                   valid=torch.tensor([[True, True, True, False]] * 2))
        out.append((imgs, gt, torch.tensor([[96, 64]] * 2)))
    return out


@pytest.fixture
def one_thread():
    """One CPU thread: the threaded CPU convolutions' weight gradients sum
    in a varying order, so two uninterrupted runs differ in the last bit
    with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resumed_training_ends_bitwise_where_the_uninterrupted_run_ends(
        tmp_path, one_thread):
    batches = _batches(4)
    model, net, opt = _train_setup()
    do_train(model, build_train_step(model, opt), net, opt, iter(batches),
             None, max_iter=4, checkpoint_period=100, log_period=10)
    want_net, want_opt = net.state_dict(), opt.state_dict()

    c = ckpt.Checkpointer(str(tmp_path))
    model, net, opt = _train_setup()
    do_train(model, build_train_step(model, opt), net, opt, iter(batches),
             c, max_iter=2, checkpoint_period=100, log_period=10)
    assert c.latest().endswith("model_0000002.pth")
    model, net, opt = _train_setup()
    start = ckpt.resume(c, net, opt)
    assert start == 2 and opt.count == 2
    log = do_train(model, build_train_step(model, opt), net, opt,
                   iter(batches[start:]), c, max_iter=4,
                   checkpoint_period=100, log_period=10, start_iter=start)
    assert log.iteration == 4 and opt.count == 4
    _same(net.state_dict(), want_net)
    got_opt = opt.state_dict()
    assert got_opt["count"] == want_opt["count"]
    assert set(got_opt["sgd"]["state"]) == set(want_opt["sgd"]["state"])
    for k, v in want_opt["sgd"]["state"].items():
        assert torch.equal(got_opt["sgd"]["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k
    assert c.latest().endswith("model_0000004.pth")
