"""The deformable conv's backward (``ops/deform_conv.py:DeformConv2dFn``)
against ``jax.vjp`` of the JAX ``deform_conv2d`` (default route), on the
CPU.

The JAX package differentiates the exact patch form (route B) whichever
route its forward took (``_pallas_guarded_bwd``); the port's backward is
the VJP of its route-B plain form, recomputed from the saved inputs.
Cases: f32 and bf16, stride 1 and 2, offsets in the kernel's window
(route A forward) and out of it.  Before this backward the port's CPU
path differentiated route A's arithmetic on an in-window layer: the
first test keeps that gap in view (offset gradients off by 22% of their
scale in f32 and 141% in bf16 on the W = 300 layer).

Tolerances, of each gradient's largest magnitude: f32 1e-5 (the same
sums in another order; measured under 5e-7).  bf16: the VJP rounds its
intermediates to bf16 at other places than XLA's transposed einsum and
gather do, so single elements move by a few bf16 steps: 2^-5 for the
input's and the offsets' gradients (measured up to 1.8e-2 and 5.2e-3),
2^-9 for the kernel's, whose sums are f32 on both sides; and the mean
error stays under 2^-9.

Then one training step of a DLA-46-C-FPN SiamMOT with deformable stages
3-5 (offset convs scaled by 0.1: most layers in the window): the losses
(rtol 1e-4) and every parameter's gradient, offset convs and DCN kernels
among them, within 1e-3 of that leaf's largest JAX gradient plus 1e-8,
as ``test_torch_train_slice.py`` holds them: at 32 channels the EMM
GroupNorm groups hold one channel each and remove the tower convs' bias
exactly, so those two leaves carry only rounding noise (up to 4e-9 here
on both sides, with this body's larger activations).
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from siammot_tpu_torch.configs.defaults import dla_dcn_overrides, get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.ops.deform_conv import (_taps, deform_conv2d,
                                               deform_conv2d_plain,
                                               deform_conv2d_vjp, in_window,
                                               sample_plain,
                                               window_route_possible)
from siammot_tpu_torch.utils.weights import jax_to_torch
from torch_port_util import (MINI, flatten_params, random_flax_params,
                             train_draws, unflatten_params)

F32_TOL = 1e-5
BF16_TOL = {"x": 2.0 ** -5, "offsets": 2.0 ** -5, "kernel": 2.0 ** -9}
BF16_MEAN_TOL = 2.0 ** -9
# the bf16 offsets' gradient against the exact VJP, of its scale: one
# rounding of the result and of the upstream gradient (measured 3.0e-3;
# 9.7e-3 while the corner weights' derivatives were bf16)
EXACT_OFFSETS_TOL = 5e-3
LOSS_RTOL, GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3, 1e-8

# (H, W, C, Co, stride, offset scale, forward route), as
# tests/test_torch_deform.py: W = 300 puts coordinates past 256
CASES = [(20, 300, 16, 24, 1, 0.3, "A"), (12, 20, 16, 24, 1, 0.3, "A"),
         (20, 300, 16, 24, 1, 2.0, "B"), (20, 300, 16, 24, 2, 0.8, "B"),
         (9, 13, 40, 8, 2, 3.0, "B")]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    h, w, c, co, stride, scale, _ = case
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(1, h, w, c).astype(np.float32)
    off = (rng.randn(1, ho, wo, 18) * scale).astype(np.float32)
    k = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(1, ho, wo, co).astype(np.float32)
    return x, off, k, g


def _jax_vjp(x, off, k, g, stride, dtype):
    fn = partial(jax_deform_conv2d, stride=stride, dilation=1)
    _, vjp = jax.vjp(fn, *[jnp.asarray(a, dtype) for a in (x, off, k)])
    return [np.asarray(t.astype(jnp.float32))
            for t in jax.jit(vjp)(jnp.asarray(g, dtype))]


def _port_grads(fn, x, off, k, g, stride, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_()
          for a in (x, off, k)]
    out = fn(*ts, stride)
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [t.grad.float().numpy() for t in ts]


def test_in_window_bf16_gradients_are_route_b_not_route_a():
    """The fault this backward closes: on an in-window bf16 layer (route A
    forward), autograd through route A's plain arithmetic misses JAX's
    offset gradients by more than their scale; the route-B VJP meets
    them."""
    x, off, k, g = _inputs(CASES[0])
    want = _jax_vjp(x, off, k, g, 1, jnp.bfloat16)
    _, old = _port_grads(deform_conv2d_plain, x, off, k, g, 1,
                         torch.bfloat16)
    _, new = _port_grads(deform_conv2d, x, off, k, g, 1, torch.bfloat16)
    scale = np.abs(want[1]).max()
    assert np.abs(old[1] - want[1]).max() > 0.5 * scale
    assert np.abs(new[1] - want[1]).max() <= BF16_TOL["offsets"] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}s{c[4]}{c[6]}"
                         if isinstance(c, tuple) else str(c))
def test_deform_vjp_matches_jax(case, dtype):
    x, off, k, g = _inputs(case)
    stride = case[4]
    td = getattr(torch, dtype)
    route_a = window_route_possible(x.shape, k.shape, stride, 1,
                                    torch.tensor(0, dtype=td).element_size()) \
        and bool(in_window(torch.from_numpy(off).to(td)))
    assert route_a == (case[6] == "A")
    want = _jax_vjp(x, off, k, g, stride, jnp.dtype(dtype))
    out, got = _port_grads(deform_conv2d, x, off, k, g, stride, td)
    # the forward under autograd is the no-grad forward
    with torch.no_grad():
        plain = deform_conv2d(*[torch.from_numpy(a).to(td)
                                for a in (x, off, k)], stride)
    assert torch.equal(out.detach(), plain)
    for name, a, b in zip(("x", "offsets", "kernel"), got, want):
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        err = np.abs(a - b)
        if dtype == "float32":
            assert err.max() <= F32_TOL * scale, (name, err.max() / scale)
        else:
            assert err.max() <= BF16_TOL[name] * scale, \
                (name, err.max() / scale)
            assert err.mean() <= BF16_MEAN_TOL * scale, \
                (name, err.mean() / scale)


def _vjp_f64(x, off, k, g, stride):
    """Route B's VJP in f64 at the coordinates bf16 rounds to."""
    b, ho, wo = off.shape[:3]
    c, co = k.shape[2:]
    gy, gx = _taps(b, ho, wo, stride, 1, x.device)
    o = off.reshape(b, ho, wo, 9, 2)
    oy = (gy.to(off.dtype) + o[..., 0]).double() - gy.double()
    ox = (gx.to(off.dtype) + o[..., 1]).double() - gx.double()
    leaves = [x.double().requires_grad_(),
              torch.stack([oy, ox], -1).reshape(b, ho, wo,
                                                18).requires_grad_(),
              k.double().requires_grad_()]
    s = sample_plain(leaves[0], leaves[1], stride, 1, False)
    out = s.reshape(-1, 9 * c) @ leaves[2].reshape(9 * c, co)
    return torch.autograd.grad(out, leaves, g.double().reshape(-1, co))


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_offset_gradient_on_positive_features_is_near_exact(stride):
    """Post-ReLU features share a large positive mean, so the offsets'
    gradient is a small difference of the four corners' large terms.
    Rounding each term to bf16 left errors near 1e-2 of its scale here
    (3.3e-2 on a DLA-102 training step on the card); the weights'
    derivatives in f32 leave one rounding."""
    rng = np.random.RandomState(3)
    h, w, c, co = 24, 40, 128, 64
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.from_numpy(np.maximum(rng.randn(2, h, w, c) + 6.0, 0)
                         .astype(np.float32)).bfloat16()
    off = torch.from_numpy((rng.randn(2, ho, wo, 18) * 1.5)
                           .astype(np.float32)).bfloat16()
    k = torch.from_numpy((rng.randn(3, 3, c, co) / np.sqrt(9 * c))
                         .astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(2, ho, wo, co)
                         .astype(np.float32)).bfloat16()
    got = deform_conv2d_vjp(x, off, k, g, stride)
    want = _vjp_f64(x, off, k, g, stride)
    scale = float(want[1].abs().max())
    err = float((got[1].double() - want[1]).abs().max())
    assert err <= EXACT_OFFSETS_TOL * scale, err / scale


def test_vjp_skips_inputs_not_asked_for():
    x, off, k, g = [torch.from_numpy(a) for a in _inputs(CASES[3])]
    gx, go, gk = deform_conv2d_vjp(x, off, k, g, 2)
    only = deform_conv2d_vjp(x, off, k, g, 2, need=(False, False, True))
    assert only[0] is None and only[1] is None
    assert torch.equal(only[2], gk)
    k2 = k.clone().requires_grad_()
    deform_conv2d(x, off, k2, 2).backward(g)
    assert torch.equal(k2.grad, gk)


# ---- a DLA-46-C-FPN DCN training step --------------------------------------

H, W, B, G = 64, 96, 2, 4
OFFSET_SCALE = 0.1
OPTS = MINI + dla_dcn_overrides("DLA-46-C-FPN") + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 16,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE", 8,
    "TPU.MAX_GT", G]


def test_dcn_training_step_gradients_match_jax():
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (H // 8, W // 8, 3)).astype(np.float32)
    images = np.stack([np.clip(np.kron(np.roll(base, t, axis=1),
                                       np.ones((8, 8, 1)))
                               + rng.randn(H, W, 3) * 8, 0,
                               255).astype(np.uint8) for t in range(B)])
    boxes = np.zeros((B, G, 4), np.float32)
    xy, wh = rng.uniform(2, 40, (3, 2)), rng.uniform(14, 40, (3, 2))
    for t in range(B):
        boxes[t, :3, :2] = xy + 2 * t
        boxes[t, :3, 2:] = xy + 2 * t + wh
    ids = np.array([[0, 1, 2, -1], [0, 1, 3, -1]], np.int32)
    valid = np.array([[True] * 3 + [False]] * B)
    labels = valid.astype(np.int32)
    sizes = np.array([[W, H - 4], [W, H]], np.int32)

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(OPTS)
    jmodel = JaxSiamMOT(jcfg)
    flat = random_flax_params(jmodel, (H, W), seed=16)
    for key in flat:
        if "/offset/" in key:
            flat[key] = flat[key] * OFFSET_SCALE
    assert sum("/offset/kernel" in k for k in flat) == 10
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((B, G)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(17)

    def total(p):
        losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                      image_size=(W, H),
                                      frame_sizes=jnp.asarray(sizes))
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, unflatten_params(flat)))
    jgrads = jax_to_torch(flatten_params(jgrads))

    cfg = get_cfg()
    cfg.merge_from_list(OPTS)
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(B, G),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, B,
                        sum(len(a) for a in model.anchors_for((H, W))),
                        jcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G, G)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (W, H), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    n_dcn = 0
    for name, p in net.named_parameters():
        want = jgrads[name]
        got = p.grad if p.grad is not None else torch.zeros_like(want)
        err = float((got - want).abs().max())
        assert err <= GRAD_REL * float(want.abs().max()) + GRAD_FLOOR, \
            (name, err)
        n_dcn += name.endswith(("conv2.kernel", "conv2.offset.weight"))
        if name.endswith("conv2.offset.weight"):
            assert float(want.abs().max()) > 0, name
    assert n_dcn == 20
