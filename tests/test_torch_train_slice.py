"""The port's training slice against the JAX training step, on the CPU.

A DLA-MINI-FPN SiamMOT in float32, one clip pair (B = 2 frames of
64x96), RPN train top-n 32/16/16, 16 box-head samples and 8 track pairs
per image, 4 ground-truth rows per frame.  ``jax.value_and_grad`` of the
JAX ``forward_train`` runs beside the port's ``forward_train`` +
``backward`` on the same converted weights, with the samplers' uniform
priorities replayed from the JAX keys (``jax.random.split(rng, 3 * b)``,
then each sampler's own splits).  Checked: the seven losses (rtol 1e-4:
f32 on both sides, sums in other orders), every parameter gradient
(within 1e-3 of that leaf's largest JAX gradient, as the gradients sum
over thousands of terms in other orders, plus 1e-9 absolute: at 32
channels the EMM GroupNorm groups hold one channel each and remove the
tower convs' bias exactly, so those two leaves carry only rounding
noise, about 1e-10 on both sides), zero JAX gradients for the FrozenBN
leaves (buffers in the port), the optimizer against optax over two steps
(1e-6) and the learning-rate schedule; then the train step and the loop.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.parallel.mesh import make_lr_schedule as jax_schedule
from siammot_tpu.parallel.mesh import make_optimizer as jax_optimizer
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.matcher import uniform_draws
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.engine.solver import (build_train_step,
                                             make_lr_schedule,
                                             make_optimizer)
from siammot_tpu_torch.engine.trainer import SmoothedValue, do_train
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import (MINI, flatten_params, random_flax_params,
                             train_draws, unflatten_params)

H, W, B, G = 64, 96, 2, 4
OVERRIDES = MINI + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8,
    "TPU.MAX_GT", G,
]
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-9
STEP_ATOL = 1e-6


def _batch(rng):
    """Two textured frames of one clip and their ground truth: ids 0-2 in
    frame 0, ids 0, 1 and 3 in frame 1 (id 2 has no target in the pair
    frame), one padding row each; frame 0's pad rows re-zeroed."""
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    images = []
    for t in range(B):
        img = np.kron(np.roll(base, t, axis=1), np.ones((8, 8, 1)))
        img = img + rng.randn(H, W, 3) * 8
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    boxes = np.zeros((B, G, 4), np.float32)
    xy = rng.uniform(2, 40, (3, 2))
    wh = rng.uniform(14, 40, (3, 2))
    for t in range(B):
        boxes[t, :3, :2] = xy + 2 * t
        boxes[t, :3, 2:] = xy + 2 * t + wh
    ids = np.array([[0, 1, 2, -1], [0, 1, 3, -1]], np.int32)
    valid = np.array([[True] * 3 + [False]] * B)
    labels = valid.astype(np.int32)
    sizes = np.array([[W, H - 4], [W, H]], np.int32)
    return np.stack(images), boxes, ids, labels, valid, sizes


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(0)
    images, boxes, ids, labels, valid, sizes = _batch(rng)

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OVERRIDES)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=1)
    jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((B, G)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(7)

    def total(p):
        losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                      image_size=(W, H),
                                      frame_sizes=jnp.asarray(sizes))
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(jparams)

    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES)
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    gt = Boxes(boxes=torch.from_numpy(boxes),
               scores=torch.ones(B, G), ids=torch.from_numpy(ids),
               labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, B, sum(len(a) for a in model.anchors_for((H, W))),
                         jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G, G)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (W, H), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    assert draws.done()
    return dict(jcfg=jcfg, jparams=jparams, jlosses=jlosses, jgrads=jgrads,
                cfg=cfg, model=model, net=net, losses=losses, flat=flat,
                batch=(torch.from_numpy(images), gt,
                       torch.from_numpy(sizes)))


def test_losses_match_jax(runs):
    j, t = runs["jlosses"], runs["losses"]
    assert sorted(j) == sorted(t) and len(t) == 7
    for k in j:
        assert np.isfinite(float(j[k])), k
        np.testing.assert_allclose(t[k].item(), float(j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    # the slice exercises every loss term
    assert all(float(j[k]) > 0 for k in j), {k: float(v) for k, v in j.items()}


def test_gradients_match_jax(runs):
    jgrads = jax_to_torch(flatten_params(runs["jgrads"]))
    net = runs["net"]
    params = dict(net.named_parameters())
    buffers = dict(net.named_buffers())
    assert set(jgrads) == set(params) | set(buffers)
    for name, g in jgrads.items():
        if name in buffers:     # FrozenBN: gradient stopped in JAX
            assert float(g.abs().max()) == 0.0, name
            continue
        got = params[name].grad
        if got is None:         # a projection no tree level reads
            got = torch.zeros_like(g)
        scale = float(g.abs().max())
        err = float((got - g).abs().max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, (name, err, scale)


def test_sgd_steps_match_optax(runs):
    """Two updates of the port's optimizer against optax from the same
    weights and (JAX) gradients: decay on weights only, 2x rate and no
    decay on bias/scale leaves, momentum, the warmup rate."""
    jparams, jgrads, cfg = runs["jparams"], runs["jgrads"], runs["cfg"]
    tx = jax_optimizer(runs["jcfg"], jparams)
    state = tx.init(jparams)
    p = jparams
    model = runs["model"]
    net = model.build_master(jax_to_torch(runs["flat"]))
    opt = make_optimizer(cfg, net)
    grads = jax_to_torch(flatten_params(jgrads))
    params = dict(net.named_parameters())
    update = jax.jit(tx.update)
    for step in range(2):
        updates, state = update(jgrads, state, p)
        p = optax.apply_updates(p, updates)
        for name, t in params.items():
            t.grad = grads[name].clone()
        opt.step()
        want = jax_to_torch(flatten_params(p))
        for name, t in params.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=STEP_ATOL, err_msg=name)
    assert opt.count == 2


def test_lr_schedule_matches_jax(runs):
    ours = make_lr_schedule(runs["cfg"])
    ref = jax_schedule(runs["jcfg"])
    for it in (0, 1, 499, 500, 30000, 40000):
        np.testing.assert_allclose(ours(it), float(ref(it)), rtol=1e-6)


def test_train_step_is_forward_backward_and_one_update(runs):
    """The step equals forward_train + backward + one update; a batch that
    would split a frame pair is refused."""
    model, cfg = runs["model"], runs["cfg"]
    images, gt, sizes = runs["batch"]
    flat = jax_to_torch(runs["flat"])
    net_a = model.build_master(flat)
    opt_a = make_optimizer(cfg, net_a)
    metrics = build_train_step(model, opt_a)(
        net_a, images, gt, sizes, uniform_draws("cpu", 5))
    net_b = model.build_master(flat)
    opt_b = make_optimizer(cfg, net_b)
    losses = model.forward_train(net_b, uniform_draws("cpu", 5), images, gt,
                                 None, sizes)
    sum(losses.values()).backward()
    opt_b.step()
    np.testing.assert_allclose(float(metrics["loss"]),
                               sum(losses.values()).item(), rtol=1e-6)
    for (n, a), (_, b) in zip(net_a.named_parameters(),
                              net_b.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=n)
    with pytest.raises(ValueError):
        build_train_step(model, opt_a, accum_steps=2)(
            net_a, images, gt, sizes, uniform_draws("cpu", 5))


def test_accumulation_averages_pair_microbatches(runs):
    """accum_steps 2 over two clip pairs: one update with the mean of the
    two pairs' gradients (and the mean of their losses)."""
    model, cfg = runs["model"], runs["cfg"]
    images, gt, sizes = runs["batch"]
    images4 = torch.cat([images, images.flip(2)])
    gt4 = gt.map(lambda v: torch.cat([v, v]))
    sizes4 = torch.cat([sizes, sizes])
    flat = jax_to_torch(runs["flat"])
    net_a = model.build_master(flat)
    opt_a = make_optimizer(cfg, net_a)
    metrics = build_train_step(model, opt_a, accum_steps=2)(
        net_a, images4, gt4, sizes4, uniform_draws("cpu", 6))
    net_b = model.build_master(flat)
    opt_b = make_optimizer(cfg, net_b)
    draws = uniform_draws("cpu", 6)
    totals = []
    for sl in (slice(0, 2), slice(2, 4)):
        losses = model.forward_train(net_b, draws, images4[sl],
                                     gt4.map(lambda v: v[sl]), None,
                                     sizes4[sl])
        totals.append(sum(losses.values()))
        (totals[-1] / 2).backward()
    opt_b.step()
    np.testing.assert_allclose(float(metrics["loss"]),
                               (totals[0] + totals[1]).item() / 2,
                               rtol=1e-6)
    assert abs(totals[0].item() - totals[1].item()) > 1e-6
    for (n, a), (_, b) in zip(net_a.named_parameters(),
                              net_b.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=n)


def test_do_train_runs_and_stops(runs, tmp_path):
    model, cfg = runs["model"], runs["cfg"]
    images, gt, sizes = runs["batch"]
    net = model.build_master(jax_to_torch(runs["flat"]))
    opt = make_optimizer(cfg, net)
    step = build_train_step(model, opt)
    seen = []
    log = do_train(model, step, net, opt, iter([(images, gt, sizes)] * 5),
                   None, max_iter=2, checkpoint_period=100, log_period=1,
                   tensorboard_writer=lambda it, m: seen.append((it, m)))
    assert log.iteration == 2 and opt.count == 2 and len(seen) == 2
    assert all(np.isfinite(list(m.values())).all() for _, m in seen)
    stop = tmp_path / "STOP"
    stop.write_text("")
    log = do_train(model, step, net, opt, iter([(images, gt, sizes)] * 5),
                   None, max_iter=4, checkpoint_period=100,
                   stop_file=str(stop))
    assert log.iteration == 0 and opt.count == 2
    meter = SmoothedValue(window=2)
    for v in (1.0, 2.0, 4.0):
        meter.update(v)
    assert meter.median == 3.0 and meter.global_avg == 7.0 / 3
