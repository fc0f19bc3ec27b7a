"""The port's training loader against the JAX package's, on the CPU.

Over the committed training fixture (``SYNMOT_MULTI_TRAIN``: the three
``tests/fixtures/synmot_multi`` sequences as a train split, and
``SYNCROWD_MINI_train_fbox``: four 640x384 crowded stills) with the
SYNMOT_HARD recipe's augmentation (jitter with hue, and for the stills
the motion crop, blur and JPEG compression), the port's
``IterationLoader`` gives the JAX ``build_train_data_loader``'s batches:
gt boxes, ids, labels, valid, sizes and video ids exactly, and the images
bit for bit (the transforms are bitwise here, ``test_torch_augment.py``).
A loader started at iteration 3 gives the iteration-3 batch of one
started at 0; the per-process slices of the global batch are JAX's.

The whole slice: on DLA-MINI with the same weights, the JAX loader's
first batch of the fixture's video split through the JAX
``forward_train`` and the port loader's first batch through the step
``tools/train_net`` builds (static input size, the JAX uniforms
replayed) give the seven losses within ``test_torch_train_slice``'s
``LOSS_RTOL``, after the two batches are checked to be the same bytes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import siammot_tpu.data.dataset_info as jax_info
from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.data.build import IterationLoader as JaxLoader
from siammot_tpu.data.build import build_dataset as jax_build_dataset
from siammot_tpu.data.build import \
    build_train_data_loader as jax_build_loader
from siammot_tpu.data.datasets import ClipCollator as JaxCollator
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.data.build import (IterationLoader, build_dataset,
                                          build_train_data_loader)
from siammot_tpu_torch.data.dataset_info import dataset_maps
from siammot_tpu_torch.data.datasets import ClipCollator
from siammot_tpu_torch.engine.solver import build_train_step, make_optimizer
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.weights import jax_to_torch
from test_torch_train_slice import LOSS_RTOL
from torch_port_util import (MINI, random_flax_params, train_draws,
                             unflatten_params)

RECIPE = "configs/dla/DLA_34_FPN_EMM_SYNMOT_HARD.yaml"
KEYS = ("SYNMOT_MULTI_TRAIN", "SYNCROWD_MINI_train_fbox")
FIELDS = ("boxes", "scores", "ids", "labels", "valid")


@pytest.fixture(scope="module", autouse=True)
def fixture_keys():
    """The fixture's registry keys on the JAX side too, and one CPU thread
    for the port (the suite runs several files at once)."""
    added = [k for k in KEYS if k not in jax_info.dataset_maps]
    for k in added:
        jax_info.dataset_maps[k] = dataset_maps[k]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    for k in added:
        del jax_info.dataset_maps[k]


def cfgs(opts=()):
    opts = ["DATASETS.ROOT_DIR", "tests/fixtures", "DATASETS.TRAIN", KEYS,
            "SOLVER.MAX_ITER", 4, "DATALOADER.NUM_WORKERS", 2] + list(opts)
    out = []
    for c in (get_cfg(), jax_get_cfg()):
        c.merge_from_file(RECIPE)
        c.merge_from_list(opts)
        out.append(c)
    return out


def assert_batch_equal(port, jax_batch):
    images, gt, sizes = port
    jimages, jgt, jsizes = jax_batch
    assert images.dtype == torch.uint8 and sizes.dtype == torch.int32
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(jgt, f)), err_msg=f)


def test_loader_matches_jax():
    cfg, jcfg = cfgs()
    port = list(build_train_data_loader(cfg))
    want = list(jax_build_loader(jcfg))
    assert len(port) == len(want) == 4
    for p, j in zip(port, want):
        assert p[0].shape == (4, 384, 640, 3)       # static 384x640
        assert_batch_equal(p, j)


def test_video_ids_and_items_match_jax():
    """The collator's fourth output (video ids, which the loader does not
    yield) and the items themselves, for each iteration's indices."""
    cfg, jcfg = cfgs()
    ds, jds = build_dataset(cfg), jax_build_dataset(jcfg)
    assert len(ds) == len(jds) and len(ds) == 7
    static = (384, 640)
    col = ClipCollator(32, cfg.TPU.MAX_GT, static)
    jcol = JaxCollator(32, jcfg.TPU.MAX_GT, static)
    loader = IterationLoader(ds, col, 2, 4)
    jloader = JaxLoader(jds, jcol, 2, 4)
    seen = set()
    for it in range(4):
        idx = loader._indices_for(it)
        assert idx == jloader._indices_for(it)
        items, jitems = [ds[i] for i in idx], [jds[i] for i in idx]
        got, want = col(items), jcol(jitems)
        assert got[3] == want[3]
        seen.update(got[3])
        np.testing.assert_array_equal(got[0], want[0])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got[1], f),
                                          getattr(want[1], f))
    assert any(v.endswith(".jpg") for v in seen) and \
        any(v.startswith("SYN-") for v in seen), seen


def test_restart_at_iteration_3():
    cfg, _ = cfgs()
    full = list(build_train_data_loader(cfg))
    late = list(build_train_data_loader(cfg, start_iter=3))
    assert len(late) == 1
    images, gt, sizes = late[0]
    assert torch.equal(images, full[3][0]) and torch.equal(sizes, full[3][2])
    for f in FIELDS:
        assert torch.equal(getattr(gt, f), getattr(full[3][1], f))


def test_process_sharding_matches_jax():
    """Each process loads its contiguous slice of the global batch, as the
    JAX loader slices it; the slices concatenate to the global batch (ids
    aside: each process numbers its own batch's instances)."""
    cfg, jcfg = cfgs(["SOLVER.VIDEO_CLIPS_PER_BATCH", 4,
                      "SOLVER.MAX_ITER", 2])
    ds, jds = build_dataset(cfg), jax_build_dataset(jcfg)

    def batches(pi, pc):
        col = ClipCollator(32, cfg.TPU.MAX_GT, (384, 640))
        return list(IterationLoader(ds, col, 4, 2, seed=3, process_index=pi,
                                    process_count=pc))

    for pc in (2, 4):
        for it in range(2):
            for pi in range(pc):
                got = IterationLoader(ds, None, 4, 2, seed=3,
                                      process_index=pi,
                                      process_count=pc)._indices_for(it)
                want = JaxLoader(jds, None, 4, 2, seed=3, process_index=pi,
                                 process_count=pc)._indices_for(it)
                assert got == want and len(got) == 4 // pc
    full, shards = batches(0, 1), [batches(i, 2) for i in range(2)]
    for it in range(2):
        assert torch.equal(full[it][0], torch.cat([s[it][0]
                                                   for s in shards]))
        for f in FIELDS:
            if f != "ids":
                assert torch.equal(getattr(full[it][1], f), torch.cat(
                    [getattr(s[it][1], f) for s in shards]))
    with pytest.raises(ValueError):
        IterationLoader(ds, None, 3, 2, process_count=2)


def test_no_route_falls_back(tmp_path):
    """A video file, a folder or still that is not JPEG, and a broken JPEG
    raise, naming the cause; nothing decodes them another way."""
    from siammot_tpu_torch.data.datasets import FrameReader, ImageDataset
    from siammot_tpu_torch.data.coco import CocoDataset
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="JPEG"):
        FrameReader(str(video))
    (tmp_path / "png").mkdir()
    (tmp_path / "png" / "000001.png").write_bytes(b"\x89PNG")
    with pytest.raises(NotImplementedError, match="JPEG"):
        FrameReader(str(tmp_path / "png"))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "000001.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    with pytest.raises(IOError):
        FrameReader(str(tmp_path / "bad"))[0]
    anno = tmp_path / "anno.json"
    anno.write_text('{"images": [{"id": 1, "file_name": "a.png", "width": 8, '
                    '"height": 8}], "annotations": [{"id": 1, "image_id": 1, '
                    '"bbox": [1, 1, 4, 4], "category_id": 1}], '
                    '"categories": [{"id": 1, "name": "person"}]}')
    ds = ImageDataset(CocoDataset(str(anno)), str(tmp_path))
    with pytest.raises(NotImplementedError, match="JPEG"):
        ds[0]


# -- the whole slice ----------------------------------------------------------

H, W = 96, 160
SLICE = MINI + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8,
    "DATASETS.TRAIN", ("SYNMOT_MULTI_TRAIN",),
    "SOLVER.VIDEO_CLIPS_PER_BATCH", 1, "SOLVER.MAX_ITER", 1,
    "INPUT.MIN_SIZE_TRAIN", (H,), "INPUT.MAX_SIZE_TRAIN", W,
    "TPU.INPUT_HEIGHT", H, "TPU.INPUT_WIDTH", W]


def test_first_batch_losses_match_jax():
    cfg, jcfg = cfgs(SLICE)
    (jimages, jgt, jsizes), = list(jax_build_loader(jcfg))
    (images, gt, sizes), = list(build_train_data_loader(cfg))
    assert_batch_equal((images, gt, sizes), (jimages, jgt, jsizes))
    b, g = images.shape[0], cfg.TPU.MAX_GT
    assert images.shape == (2, H, W, 3) and int(gt.valid.sum()) > 0

    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=1)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    key = jax.random.PRNGKey(7)
    jlosses = jax.jit(lambda p: jmodel.forward_train(
        p, key, jnp.asarray(jimages),
        JaxBoxes(*(jnp.asarray(getattr(jgt, f)) for f in FIELDS)),
        image_size=(W, H), frame_sizes=jnp.asarray(jsizes)))(jparams)

    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    step = build_train_step(model, make_optimizer(cfg, net),
                            cfg.SOLVER.ACCUMULATION_STEPS, image_size=(W, H))
    n_anchors = sum(len(a) for a in model.anchors_for((H, W)))
    draws = train_draws(key, b, n_anchors,
                        jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + g, g)
    metrics = step(net, images, gt, sizes, draws)
    assert draws.done()
    assert sorted(jlosses) == sorted(k for k in metrics if k != "loss")
    for k in jlosses:
        assert np.isfinite(float(jlosses[k])), k
        np.testing.assert_allclose(metrics[k].item(), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
