"""The port's data-parallel training step (``parallel/mesh.py``) against
the JAX package's, on the CPU: two ranks under gloo, started with
``torch.multiprocessing.spawn`` over a ``file://`` store, one thread a
rank (``tests/torch_ddp_worker.py``), beside
``siammot_tpu.parallel.mesh.build_train_step(model, tx, make_mesh(2))`` on
two of the eight virtual CPU devices.

DLA-MINI-FPN in float32 at ``test_torch_train_slice.py``'s size, two
clips of two 64x96 frames a step, one clip a rank.  Rank r replays the
draws of the JAX device r (``jax.random.fold_in(step_rng, r)`` through
``torch_port_util.train_draws``).  Checked, as
``test_torch_train_slice.py`` holds one device:
- the seven losses and their total, averaged over the ranks, rtol 1e-4;
- every averaged gradient within 1e-3 of its leaf's largest JAX gradient
  plus 1e-9 (the JAX gradients: ``jax.grad`` of each device's
  ``forward_train`` averaged, what the step's ``pmean`` averages);
- the parameters after each of two steps against the JAX step's within
  1e-6 (the SGD update on gradients that agree to the bound above);
- both ranks' parameters bitwise equal;
- ``ACCUMULATION_STEPS`` 2 under two ranks (two clips a rank) against the
  JAX step's scan with ``make_mesh(2)``: losses and the parameters after
  the step, as above;
- a group of one bitwise the plain step;
- a step where rank 1's clip has no live target (every gt row invalid):
  it finishes and meets the JAX step; and a branch only rank 0 runs,
  whose gradient rank 1 zero-fills before the all-reduce;
- ``sync_restored_state``: rank 0 resumes from a checkpoint, rank 1 with
  an empty directory takes its weights, optimizer state and iteration;
- a stop file that only rank 0 sees stops both ranks at the same step.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel.mesh import build_train_step as jax_dp_step
from siammot_tpu.parallel.mesh import make_mesh
from siammot_tpu.parallel.mesh import make_optimizer as jax_optimizer
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.matcher import draw_seed
from siammot_tpu_torch.engine.solver import make_optimizer
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.checkpoint import Checkpointer
from siammot_tpu_torch.utils.weights import jax_to_torch
from test_torch_train_slice import (GRAD_FLOOR, GRAD_REL, LOSS_RTOL,
                                    OVERRIDES, STEP_ATOL, G, H, W, _batch)
from torch_port_util import (flatten_params, random_flax_params,
                             train_draws, unflatten_params)
import torch_ddp_worker

WORLD = 2
FIELDS = ("boxes", "scores", "ids", "labels", "valid")


def _clips(seed, n, dead=()):
    """``n`` clips of two frames (``test_torch_train_slice._batch``), the
    clips in ``dead`` with every gt row invalid: (images [2n, H, W, 3],
    gt fields [2n, G], sizes [2n, 2]) in numpy."""
    rng = np.random.RandomState(seed)
    parts = [_batch(rng) for _ in range(n)]
    images, boxes, ids, labels, valid, sizes = (
        np.concatenate([p[i] for p in parts]) for i in range(6))
    for c in dead:
        valid[2 * c:2 * c + 2] = False
        labels[2 * c:2 * c + 2] = 0
    gt = dict(boxes=boxes, scores=np.ones(valid.shape, np.float32), ids=ids,
              labels=labels, valid=valid)
    return images, gt, sizes


def _shard(batch, rank, world=WORLD):
    images, gt, sizes = batch
    per = len(images) // world
    sl = slice(rank * per, (rank + 1) * per)
    return images[sl], {k: v[sl] for k, v in gt.items()}, sizes[sl]


def _spawn(tmp_path, jobs, world=WORLD):
    tmp_path.mkdir()
    path = str(tmp_path / "jobs.pt")
    torch.save(jobs, path)
    torch_ddp_worker.spawn(torch_ddp_worker.run_jobs,
                           (world, str(tmp_path / "store"), path), world)
    return [torch.load(f"{path}.rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OVERRIDES)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=1)
    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES)
    model = SiamMOT(cfg, device="cpu")
    n_anchors = sum(len(a) for a in model.anchors_for((H, W)))
    n_props = jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G

    def draws(key, frames):
        return train_draws(key, frames, n_anchors, n_props, G).blocks

    return dict(jcfg=jcfg, jmodel=jmodel, flat=flat, cfg=cfg, model=model,
                draws=draws)


def _jax_batch(batch):
    images, gt, sizes = batch
    return (jnp.asarray(images),
            JaxBoxes(**{k: jnp.asarray(v) for k, v in gt.items()}),
            jnp.asarray(sizes))


def _tree(flat):
    return jax.tree.map(jnp.asarray, unflatten_params(flat))


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The JAX side (the DP step, each device's gradients) and one spawn
    of two ranks that runs every port job."""
    tmp = tmp_path_factory.mktemp("ddp")
    jmodel, jcfg, flat = setup["jmodel"], setup["jcfg"], setup["flat"]
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    batch = _clips(0, 2)
    dead = _clips(0, 2, dead=(1,))
    acc_batch = _clips(3, 4)

    tx = jax_optimizer(jcfg, _tree(flat))
    mesh = make_mesh(WORLD)
    step = jax_dp_step(jmodel, tx, mesh, image_size=(W, H))
    jax_out = {}
    for name, b, n in (("steps", batch, 2), ("dead", dead, 1)):
        params = _tree(flat)
        state = tx.init(params)
        jb = _jax_batch(b)
        outs = []
        for s in range(n):
            params, state, m = step(params, state, *jb, keys[s])
            outs.append(({k: float(v) for k, v in m.items()},
                         jax_to_torch(flatten_params(params))))
        jax_out[name] = outs
    acc_step = jax_dp_step(jmodel, tx, mesh, image_size=(W, H),
                           accum_steps=2)
    params = _tree(flat)
    params, _, m = acc_step(params, tx.init(params), *_jax_batch(acc_batch),
                            keys[0])
    jax_out["accum"] = [({k: float(v) for k, v in m.items()},
                         jax_to_torch(flatten_params(params)))]

    def loss_fn(p, key, images, gt, sizes):
        losses = jmodel.forward_train(p, key, images, gt, image_size=(W, H),
                                      frame_sizes=sizes)
        return sum(losses.values())

    grad = jax.jit(jax.grad(loss_fn))
    jax_grads = {}
    for name, b in (("steps", batch), ("dead", dead)):
        per = [flatten_params(grad(_tree(flat), jax.random.fold_in(
            keys[0], r), *_jax_batch(_shard(b, r)))) for r in range(WORLD)]
        jax_grads[name] = jax_to_torch(
            {k: (per[0][k] + per[1][k]) / 2 for k in per[0]})

    params = jax_to_torch(flat)
    draws = setup["draws"]
    common = dict(kind="steps", opts=OVERRIDES, params=params,
                  image_size=(W, H))

    def rank_draws(key, fold=()):
        out = []
        for r in range(WORLD):
            k = jax.random.fold_in(key, r)
            if fold:
                out.append(sum((draws(jax.random.fold_in(k, i), 2)
                                for i in fold), []))
            else:
                out.append(draws(k, 2))
        return out

    jobs = dict(
        steps=dict(common, batches=[[_shard(batch, r) for r in range(WORLD)]]
                   * 2, draws=[rank_draws(k) for k in keys]),
        dead=dict(common, batches=[[_shard(dead, r) for r in range(WORLD)]],
                  draws=[rank_draws(keys[0])]),
        accum=dict(common, accum=2,
                   batches=[[_shard(acc_batch, r) for r in range(WORLD)]],
                   draws=[rank_draws(keys[0], fold=(0, 1))]),
        none_grad=dict(kind="none_grad"),
        stop=dict(kind="stop", stop_file=str(tmp / "STOP")),
        sync=dict(kind="sync", opts=OVERRIDES,
                  dirs=[_checkpoint_dir(setup, tmp), str(tmp / "empty")]))
    ranks = _spawn(tmp / "two", jobs)
    one = _spawn(tmp / "one", dict(world_of_one=dict(
        common, kind="world_of_one", batches=[[batch]],
        draws=[[draws(keys[0], 4)]])), world=1)[0]
    return dict(jax=jax_out, grads=jax_grads, ranks=ranks, one=one,
                tmp=tmp)


def _checkpoint_dir(setup, tmp):
    """A run directory at iteration 5 with a stepped optimizer (momentum
    buffers and an update count of 3)."""
    cfg, model = setup["cfg"], setup["model"]
    torch.manual_seed(9)
    net = model.build_master(model.build_net().state_dict())
    opt = make_optimizer(cfg, net)
    for _ in range(3):
        for p in net.parameters():
            if p.requires_grad:
                p.grad = torch.randn_like(p)
        opt.step()
    d = tmp / "ckpt"
    Checkpointer(str(d)).save(5, net, opt)
    return str(d)


def _assert_losses(got, want):
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def _assert_grads(got, want):
    for name, g in got.items():
        w = want[name]
        g = torch.zeros_like(w) if g is None else g
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, (name, err, scale)


def _assert_params(got, want):
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)


def _assert_ranks_equal(ranks, name):
    for s, (a, b) in enumerate(zip(ranks[0][name]["params"],
                                   ranks[1][name]["params"])):
        for k in a:
            assert torch.equal(a[k], b[k]), (name, s, k)
        assert ranks[0][name]["metrics"][s] == ranks[1][name]["metrics"][s]


def test_two_ranks_match_the_jax_mesh_step(runs):
    ranks, want = runs["ranks"], runs["jax"]["steps"]
    _assert_ranks_equal(ranks, "steps")
    port = ranks[0]["steps"]
    _assert_grads(port["grads"], runs["grads"]["steps"])
    for s in range(2):
        _assert_losses(port["metrics"][s], want[s][0])
        _assert_params(port["params"][s], want[s][1])
    # the two steps drew differently, and so did the two ranks
    assert port["metrics"][0] != port["metrics"][1]


def test_accumulation_under_two_ranks_matches_jax(runs):
    ranks = runs["ranks"]
    _assert_ranks_equal(ranks, "accum")
    m, params = runs["jax"]["accum"][0]
    _assert_losses(ranks[0]["accum"]["metrics"][0], m)
    _assert_params(ranks[0]["accum"]["params"][0], params)


def test_a_group_of_one_is_bitwise_the_plain_step(runs):
    plain, group = runs["one"]["world_of_one"]["plain"], \
        runs["one"]["world_of_one"]["group"]
    assert plain["metrics"].keys() == group["metrics"].keys()
    for k, v in plain["metrics"].items():
        assert torch.equal(v, group["metrics"][k]), k
    for k, v in plain["params"].items():
        assert torch.equal(v, group["params"][k]), k
        a, b = plain["grads"][k], group["grads"][k]
        assert (a is None and not b.any()) or torch.equal(a, b), k


def test_a_rank_without_live_targets_meets_jax(runs):
    """Rank 1's clip has no valid gt row: its box-regression and tracker
    terms are zero there, the step ends on both ranks and meets JAX."""
    ranks, (m, params) = runs["ranks"], runs["jax"]["dead"][0]
    _assert_ranks_equal(ranks, "dead")
    port = ranks[0]["dead"]
    _assert_losses(port["metrics"][0], m)
    _assert_grads(port["grads"], runs["grads"]["dead"])
    _assert_params(port["params"][0], params)


def test_a_gradient_missing_on_one_rank_is_zero_filled(runs):
    r0, r1 = (r["none_grad"] for r in runs["ranks"])
    assert r1["local"]["branch.weight"] is None
    assert r0["local"]["branch.weight"] is not None
    for k, g in r0["reduced"].items():
        assert torch.equal(g, r1["reduced"][k]), k
        local1 = r1["local"][k]
        want = (r0["local"][k] + (0 if local1 is None else local1)) / 2
        torch.testing.assert_close(g, want, rtol=1e-6, atol=0)
    assert r0["loss"] == r1["loss"]


def test_sync_restored_state_takes_rank_0s(runs):
    r0, r1 = (r["sync"] for r in runs["ranks"])
    assert r0["found"].endswith("model_0000005.pth") and r1["found"] is None
    assert r0["start"] == r1["start"] == 5
    assert r0["kept"]       # rank 0's momentum buffers are not replaced
    ckpt = Checkpointer(os.path.dirname(r0["found"])).load()
    for k, v in ckpt["model"].items():
        assert torch.equal(r1["model"][k], v), k
    assert r1["optimizer"]["count"] == ckpt["optimizer"]["count"] == 3
    state = ckpt["optimizer"]["sgd"]["state"]
    assert len(state) == len(r1["optimizer"]["sgd"]["state"]) > 0
    for k, st in state.items():
        assert torch.equal(r1["optimizer"]["sgd"]["state"][k]
                           ["momentum_buffer"], st["momentum_buffer"]), k


def test_a_stop_file_one_rank_sees_stops_every_rank(runs):
    """The stop request is all-reduced at each step boundary: rank 0
    alone sees the file its second step wrote, and both ranks end after
    iteration 2 (neither waits in a collective for the other)."""
    assert [r["stop"] for r in runs["ranks"]] == [
        dict(iteration=2, steps=2)] * WORLD


def test_draw_seeds_are_distinct_per_iteration_and_rank():
    """Rank 0 keeps the one-process seed; no two (iteration, rank) pairs
    of a run share a seed."""
    assert draw_seed(3, 7) == draw_seed(3, 7, 0) == 3 * 1_000_003 + 7
    seeds = {draw_seed(0, it, r) for it in range(0, 50_000, 7)
             for r in range(8)}
    assert len(seeds) == len(range(0, 50_000, 7)) * 8
