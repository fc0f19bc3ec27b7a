"""``tools/train_net`` under two data-parallel ranks on the CPU: gloo over a
``file://`` store, started with ``torch.multiprocessing.spawn`` as
``torch.distributed.run`` would start them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; ``tests/torch_ddp_worker.py:run_train_net``), one thread
a rank.

DLA-MINI over the committed training fixture with
``test_torch_train_net.py``'s options (4 iterations, a checkpoint every
2, the recipe's 2 clips a batch: one a rank).  Checked:
- rank 0 alone saves each checkpoint and writes the event file and
  ``log.txt``; rank 1 saves nothing;
- both ranks log the same (all-reduced) metrics, finite;
- each rank's loader batches are the JAX loader's shard of that process
  (``process_index`` r of 2), byte for byte, and their images the r-th
  contiguous half of the JAX loader's global batch;
- a copy of the run directory at iteration 2, resumed under two ranks,
  ends bitwise where the uninterrupted run ended (net and optimizer);
- ``TPU.DATA_PARALLEL`` 3 under a launcher's world of 2 raises.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import siammot_tpu.data.dataset_info as jax_info
from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.data.build import IterationLoader as JaxLoader
from siammot_tpu.data.build import build_dataset as jax_build_dataset
from siammot_tpu.data.datasets import ClipCollator as JaxCollator
from siammot_tpu_torch.data.dataset_info import dataset_maps
from siammot_tpu_torch.engine.tensorboard_writer import read_events
from siammot_tpu_torch.tools import train_net
from test_torch_train_net import OPTS, RECIPE
import torch_ddp_worker

WORLD = 2
KEYS = ("SYNMOT_MULTI_TRAIN", "SYNCROWD_MINI_train_fbox")


def _train(train_dir, tag):
    out = str(train_dir.parent / f"{tag}.out")
    argv = ["--config-file", RECIPE, "--train-dir", str(train_dir),
            "--device", "cpu"] + OPTS
    torch_ddp_worker.spawn(torch_ddp_worker.run_train_net,
                           (WORLD, str(train_dir.parent / f"{tag}.store"),
                            argv, out), WORLD)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_train")
    return _train(root / "runs", "first")


def test_rank_0_alone_writes_the_run_directory(first_run):
    r0, r1 = first_run
    out = r0["out"]
    assert r1["out"] == out
    assert r0["iteration"] == r1["iteration"] == 4
    assert r0["steps"] == r1["steps"] == 4
    assert r0["saves"] == [(2, None), (4, None), (4, None),
                           (4, "model_final")]
    assert r1["saves"] == []
    for f in ("config.yaml", "log.txt", "model_0000002.pth",
              "model_0000004.pth", "model_final.pth"):
        assert os.path.exists(os.path.join(out, f)), f
    files = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    assert len(files) == 1
    steps = [e["step"] for e in read_events(files[0])[1:]]
    assert steps == [4] * len(steps) and steps
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    assert text.count("iter 4/4") == 1 and "data parallel: rank 0 of 2" \
        in text


def test_both_ranks_log_the_same_metrics(first_run):
    r0, r1 = first_run
    assert r0["logged"] == r1["logged"]
    [(it, metrics)] = r0["logged"]
    assert it == 4 and len(metrics) == 8
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.fixture
def jax_keys():
    added = [k for k in KEYS if k not in jax_info.dataset_maps]
    for k in added:
        jax_info.dataset_maps[k] = dataset_maps[k]
    yield
    for k in added:
        del jax_info.dataset_maps[k]


def test_each_rank_loads_its_shard_of_the_jax_batch(first_run, jax_keys):
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(RECIPE)
    jcfg.merge_from_list(OPTS)
    jds = jax_build_dataset(jcfg)
    col = JaxCollator(jcfg.DATALOADER.SIZE_DIVISIBILITY,
                      max_gt=jcfg.TPU.MAX_GT,
                      static_size=(jcfg.TPU.INPUT_HEIGHT,
                                   jcfg.TPU.INPUT_WIDTH))

    def batches(pi, pc):
        return list(JaxLoader(jds, col, jcfg.SOLVER.VIDEO_CLIPS_PER_BATCH,
                              jcfg.SOLVER.MAX_ITER, num_workers=2, seed=0,
                              process_index=pi, process_count=pc))

    full = batches(0, 1)
    for r, rank in enumerate(first_run):
        want = batches(r, WORLD)
        assert sorted(rank["batches"]) == [1, 2, 3, 4]
        for it, (images, gt, sizes) in rank["batches"].items():
            jimages, jgt, jsizes = want[it - 1]
            np.testing.assert_array_equal(images.numpy(),
                                          np.asarray(jimages))
            np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
            for f, v in gt.items():
                np.testing.assert_array_equal(v, np.asarray(getattr(jgt, f)),
                                              err_msg=f)
            half = np.asarray(full[it - 1][0])[2 * r:2 * r + 2]
            np.testing.assert_array_equal(images.numpy(), half)


def test_resume_under_two_ranks_is_bitwise(first_run, tmp_path):
    out = first_run[0]["out"]
    resumed = tmp_path / "runs" / os.path.basename(out)
    shutil.copytree(out, resumed)
    for f in ("model_0000004.pth", "model_final.pth"):
        os.remove(resumed / f)
    r0, r1 = _train(tmp_path / "runs", "resume")
    assert r0["out"] == str(resumed)
    assert r0["steps"] == r1["steps"] == 2
    assert sorted(r0["batches"]) == [3, 4]
    for it in (3, 4):
        assert torch.equal(r0["batches"][it][0],
                           first_run[0]["batches"][it][0])
    assert r0["logged"] == first_run[0]["logged"]
    want = torch.load(os.path.join(out, "model_final.pth"),
                      weights_only=True)
    got = torch.load(resumed / "model_final.pth", weights_only=True)
    assert got["iteration"] == want["iteration"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 4
    for k, st in want["optimizer"]["sgd"]["state"].items():
        assert torch.equal(got["optimizer"]["sgd"]["state"][k]
                           ["momentum_buffer"], st["momentum_buffer"]), k


def test_data_parallel_must_match_the_world(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="DATA_PARALLEL=3"):
        train_net.main(["--config-file", RECIPE, "--train-dir",
                        str(tmp_path), "--device", "cpu"] + OPTS
                       + ["TPU.DATA_PARALLEL", "3"])
    assert not os.listdir(tmp_path)
