"""Kernel 9 (deformable conv) of the port against the JAX package, on the
CPU: ``deform_conv2d`` (the port's plain version) against the JAX
``deform_conv2d`` under ``jit``, whose default route runs the Pallas
kernel in interpret mode off the TPU, over stride 1 and 2, offsets inside
and outside the kernel's window, f32 and bf16; then a narrow
DLA-102-shaped body with DCN stages, built through the JAX ``DLA`` class,
against the port's body on the same numpy weights.

Tolerances: f32 -> 2e-5 of the output's largest magnitude (the same
samples, f32 sums over 9 C terms in another order).  bf16 -> the route's
arithmetic is reproduced, so samples agree but for a few where XLA fuses
the route-A blend differently (one bf16 step each), and the f32 sums run
in another order, so an output can round to a neighbouring bf16 value:
one bf16 step (2^-7 relative) plus 2^-9 of the output's largest
magnitude, on fewer than 1% of the elements.  The body, f32 through 26 DCN layers and
~100 convs: 1e-4 of each level's largest magnitude.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.models.dla import DLA as JaxDLA
from siammot_tpu.models.dla import Bottleneck as JaxBottleneck
from siammot_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from siammot_tpu_torch.configs.defaults import (DLA_STAGE_WIDTHS,
                                                dla_dcn_overrides)
from siammot_tpu_torch.models.dla import DLA
from siammot_tpu_torch.models.dla import Bottleneck
from siammot_tpu_torch.ops.deform_conv import (deform_conv2d, in_window,
                                               sample_plain, tap_splits,
                                               window_route_possible)
from siammot_tpu_torch.utils.weights import jax_to_torch

F32_TOL = 2e-5
BF16_STEP = 2.0 ** -7
BF16_ATOL = 2.0 ** -9
BODY_TOL = 1e-4

# (H, W, C, Co, stride, offset scale, route): W = 300 puts coordinates
# above 256, where bf16 drops whole pixels; offsets N(0, 0.3^2) stay
# within the window, N(0, 2^2) leave it
CASES = [(20, 300, 16, 24, 1, 0.3, "A"), (20, 300, 16, 24, 1, 2.0, "B"),
         (20, 300, 16, 24, 2, 0.8, "B"), (9, 13, 40, 8, 2, 3.0, "B")]


def _inputs(case, seed):
    h, w, c, co, stride, scale, _ = case
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(1, h, w, c).astype(np.float32)
    off = (rng.randn(1, ho, wo, 18) * scale).astype(np.float32)
    k = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    return x, off, k


def _jax(x, off, k, stride, dtype):
    fn = jax.jit(partial(jax_deform_conv2d, stride=stride, dilation=1))
    out = fn(*[jnp.asarray(a, dtype) for a in (x, off, k)])
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[4]}s{c[6]}"
                         if isinstance(c, tuple) else str(c))
def test_deform_conv_matches_jax(case, dtype):
    x, off, k = _inputs(case, 0)
    stride = case[4]
    td = getattr(torch, dtype)
    tx, toff, tk = (torch.from_numpy(a).to(td) for a in (x, off, k))
    route_a = window_route_possible(tx.shape, tk.shape, stride, 1,
                                    tx.element_size()) \
        and bool(in_window(toff))
    assert route_a == (case[6] == "A")
    want = _jax(x, off, k, stride, jnp.dtype(dtype))
    got = deform_conv2d(tx, toff, tk, stride).float().numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale)
    else:
        err = np.abs(got - want)
        tol = BF16_STEP * np.abs(want) + BF16_ATOL * scale
        assert (err <= tol).all(), err.max()
        assert (err > 0).mean() < 0.01, (err > 0).mean()


def test_route_b_rounds_coordinates_like_jax():
    """In bf16 the patch route adds the int tap position and the bf16
    offset in bf16 (JAX's promotion), so past x = 256 a sample lands on a
    whole pixel.  The port reproduces that: exact coordinates would miss
    the JAX output by far more than one bf16 step."""
    case = CASES[2]
    x, off, k = _inputs(case, 1)
    want = _jax(x, off, k, 2, jnp.bfloat16)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, off, k)]
    got = deform_conv2d(*tb, 2).float().numpy()
    # exact coordinates: the same samples taken in f32, then rounded
    exact = sample_plain(tb[0].float(), tb[1].float(), 2, 1, False)
    exact = (exact.to(torch.bfloat16).float().reshape(-1, 9 * 16)
             @ tb[2].float().reshape(9 * 16, 24)).to(torch.bfloat16)
    exact = exact.float().numpy().reshape(want.shape)
    scale = np.abs(want).max()
    far = np.abs(exact - want)[..., 128:, :]      # columns x >= 256
    assert far.max() > 0.2 * scale
    err = np.abs(got - want)
    assert (err <= BF16_STEP * np.abs(want) + BF16_ATOL * scale).all()


@pytest.mark.parametrize("n,co,splits", [
    (92 * 160, 128, 1), (46 * 80, 256, 3), (23 * 40, 512, 3),
    (2 * 23 * 40, 64, 9), (300 * 128, 128, 1), (66 * 128, 128, 1)])
def test_tap_splits_give_half_the_sms_a_block(n, co, splits):
    """The bf16 kernel's split of the nine taps (DLA-102's stages 3-5 at
    720p, a small layer, two that need no split): the fewest of 1, 3 and
    9 with a block for at least half of the H100's 132 SMs, the blocks
    being 128 pixels x 128 channels, or 64 x 256 past 128 channels."""
    px, ch = (64, 256) if co > 128 else (128, 128)
    tiles = -(-n // px) * -(-co // ch)
    assert tap_splits(n, co) == splits
    assert tiles * splits >= 66 or splits == 9


def _draw(shapes, rng, offset_scale):
    """Numpy weights in the flax tree layout: kernels ~ N(0, 1/fan_in),
    FrozenBN scales ~ 1; the offset convs' kernels scaled by
    ``offset_scale`` so that most layers stay in the kernel's window."""
    flat = {}

    def walk(tree, prefix):
        for key, v in tree.items():
            name = f"{prefix}/{key}"
            if isinstance(v, dict):
                walk(v, name)
                continue
            if key == "kernel":
                a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                if prefix.endswith("/offset"):
                    a = a * offset_scale
            elif key == "scale":
                a = 1.0 + 0.05 * rng.randn(*v.shape)
            else:
                a = 0.05 * rng.randn(*v.shape)
            flat[name] = a.astype(np.float32)

    walk(shapes, "params")
    return flat


@pytest.fixture(scope="module")
def body():
    levels = (1, 1, 1, 3, 4, 1)
    channels = (8, 16, 16, 32, 64, 128)
    dcn = (False, False, False, True, True, True)
    jmodel = JaxDLA(levels=levels, channels=channels, block=JaxBottleneck,
                    residual_root=True, stage_with_dcn=dcn, s2d_stem=True)
    rng = np.random.RandomState(0)
    image = rng.randn(1, 64, 96, 3).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(image))["params"]
    flat = _draw(shapes, rng, 0.1)
    tree = {}
    for key, v in flat.items():
        node = tree
        for p in key.split("/")[1:-1]:
            node = node.setdefault(p, {})
        node[key.split("/")[-1]] = jnp.asarray(v)
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(image))
    net = DLA(levels, channels, block=Bottleneck, residual_root=True,
              stage_with_dcn=dcn)
    sd = {k[len("body."):]: v for k, v in
          jax_to_torch({f"params/body/{k[len('params/'):]}": v
                        for k, v in flat.items()}).items()}
    net.load_state_dict(sd, strict=True)
    routes = []

    def hook(mod, args, out):
        x = args[0]
        off = mod.offset(x).permute(0, 2, 3, 1)
        routes.append(window_route_possible(
            x.permute(0, 2, 3, 1).shape, mod.kernel.shape, mod.stride, 1, 4)
            and bool(in_window(off)))

    from siammot_tpu_torch.models.dla import DeformConv
    for m in net.modules():
        if isinstance(m, DeformConv):
            m.register_forward_hook(hook)
    with torch.no_grad():
        got = net(torch.from_numpy(image))
    return [np.asarray(w) for w in want], [g.permute(0, 2, 3, 1).numpy()
                                           for g in got], routes


def test_dcn_body_matches_jax(body):
    want, got, routes = body
    # levels (1, 1, 1, 3, 4, 1): 8 + 16 + 2 deformable 3x3s, the first of
    # each stage stride 2 (patch route), most of the rest in the window
    assert len(routes) == 26
    assert sum(routes) >= 13 and not all(routes), routes
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BODY_TOL * np.abs(w).max())


@pytest.mark.parametrize("body_name", sorted(DLA_STAGE_WIDTHS))
def test_dcn_variant_trees_map_onto_the_port(body_name):
    """Every ported Bottleneck variant with DCN on stages 3-5, as the
    model zoo builds the -DCN bodies (``tools/bench_variants.py``): the
    JAX parameter tree (shapes from ``jax.eval_shape``) converts key by
    key onto the port's state dict, shapes equal, the deformable kernels
    kept HWIO."""
    from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
    from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
    from siammot_tpu_torch.configs.defaults import get_cfg
    from siammot_tpu_torch.models.siammot import SiamMOT
    from torch_port_util import random_flax_params

    opts = dla_dcn_overrides(body_name)
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(opts)
    flat = random_flax_params(JaxSiamMOT(jcfg), (64, 64), seed=0)
    cfg = get_cfg()
    cfg.merge_from_list(opts)
    want = SiamMOT(cfg, device="cpu").build_net().state_dict()
    sd = jax_to_torch(flat)
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    dcn = [k for k in flat if k.endswith("conv2/offset/kernel")]
    n_dcn = {"DLA-102-FPN": 26, "DLA-169-FPN": 42}.get(body_name)
    assert len(dcn) == (n_dcn or len(dcn)) and dcn
    key = dcn[0][:-len("offset/kernel")] + "kernel"
    name = ".".join(key.split("/")[1:])
    np.testing.assert_array_equal(sd[name].numpy(), flat[key])
