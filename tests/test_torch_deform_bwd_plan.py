"""Kernel 9's backward as the card runs it, on the CPU: its host plans and
the plain forms of its chunked arithmetic, against the JAX package.

* ``pixel_splits`` / ``pixel_chunks``: the chunks of pixels the bf16
  dKernel product (``ops/cuda/deform_bwd.cu:deform_bwd_dk``) splits over,
  at each of DLA-102-DCN's 26 training layers (4 x 736x1280): every pixel
  once and in order, and enough blocks to fill the H100's 132 SMs.
* ``dkernel_plain``: dKernel summed chunk by chunk in that order, the
  chunks' f32 sums added in order, against a jitted ``jax.vjp`` of the
  JAX ``deform_conv2d`` on ``tests/test_torch_deform_grad.py``'s cases
  and tolerances.
* ``ds_passes``: the passes over the source pixels in which the backward
  makes and uses dS; and the input gradient summed over those passes
  with its f32 sums carried between them, bitwise the one-pass sum.
* Route B's bf16 fractions: with one-hot weights the forward gives its
  samples; at coordinates in (-0.5, 0), where bf16 rounds the fraction,
  the port's plain bf16 route B is bitwise the JAX ``deform_conv2d`` (the
  kernel is held to this plain version bit for bit on the card,
  ``tests/test_torch_cuda.py``).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from siammot_tpu_torch.ops.deform_conv import (DK_PIXELS, L2_BYTES, SMS,
                                               _dx_contributions,
                                               _route_b_point, _sum_in_order,
                                               _taps, deform_conv2d_bwd_plain,
                                               deform_conv2d_plain,
                                               dkernel_plain, ds_passes,
                                               in_window, pixel_chunks,
                                               pixel_splits, sample_plain,
                                               window_route_possible)
from test_torch_deform_bwd import _jax_vjp
from test_torch_deform_grad import (BF16_MEAN_TOL, BF16_TOL, CASES, F32_TOL,
                                    _inputs)

# DLA-102-DCN-FPN's deformable 3x3s in a training step at 4 x 736x1280:
# (input H, W, C = Co, stride), the stride-2 first layer of stages 3-5
# and the stride-1 rest (1 + 7, 1 + 15, 1 + 1)
LAYERS = ([(184, 320, 128, 2)] + [(92, 160, 128, 1)] * 7
          + [(92, 160, 256, 2)] + [(46, 80, 256, 1)] * 15
          + [(46, 80, 512, 2)] + [(23, 40, 512, 1)])
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _out_pixels(h, w, stride):
    return BATCH * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)


@pytest.mark.parametrize("layer", range(len(LAYERS)))
def test_pixel_splits_fill_the_card(layer):
    """The chunks cover every pixel once, in order, on 64-pixel steps; the
    blocks (a tap's 128 channels x 128 outputs, or 64 x 256 past 128
    outputs, times the chunks) fill at least 90% of their waves and at
    least 90% of the SMs."""
    h, w, c, stride = LAYERS[layer]
    n = _out_pixels(h, w, stride)
    splits = pixel_splits(n, c, c)
    chunks = pixel_chunks(n, splits)
    assert len(chunks) == splits > 1
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    for (a0, a1), (b0, _) in zip(chunks, chunks[1:]):
        assert a1 == b0
    for a0, a1 in chunks:
        assert a0 < a1 and a0 % DK_PIXELS == 0
    mc, nt = (64, 256) if c > 128 else (128, 128)
    blocks = 9 * -(-c // mc) * -(-c // nt) * splits
    assert blocks >= 0.9 * SMS
    assert blocks >= 0.9 * SMS * -(-blocks // SMS)


@pytest.mark.parametrize("n,c,co,splits", [
    (35, 40, 8, 1), (240, 16, 24, 1), (6000, 16, 24, 11),
    (40 * 64 + 5, 512, 512, 5), (23 * 40, 512, 512, 1), (64, 128, 128, 1)])
def test_pixel_splits_small_layers(n, c, co, splits):
    """A layer with fewer 64-pixel steps than ``DK_MIN_STEPS`` times the
    chunks the card would want takes fewer chunks; the rest as at
    DLA-102's shapes."""
    assert pixel_splits(n, c, co) == splits
    chunks = pixel_chunks(n, splits)
    assert [p for ch in chunks for p in range(*ch)] == list(range(n))


def _jax_grads(case, dtype):
    x, off, k, g = _inputs(case)
    return [np.asarray(t.astype(jnp.float32)) for t in _jax_vjp(
        *[jnp.asarray(a, jnp.dtype(dtype)) for a in (x, off, k, g)],
        case[4])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}s{c[4]}{c[6]}")
def test_chunked_dkernel_matches_jax_vjp(case, dtype):
    """dKernel summed over the planner's chunks of pixels in order, each
    chunk's f32 sum added to the last, rounded once: within the JAX VJP's
    tolerances, and within the rounding of f32 sums taken in another
    order of the one-chunk plain backward."""
    x, off, k, g = _inputs(case)
    stride = case[4]
    td = getattr(torch, dtype)
    tx, toff, tk, tg = (torch.from_numpy(a).to(td) for a in (x, off, k, g))
    n, c, co = g.shape[0] * g.shape[1] * g.shape[2], k.shape[2], k.shape[3]
    splits = pixel_splits(n, c, co)
    got = dkernel_plain(tx, toff, tg, stride, 1, splits)
    want = _jax_grads(case, dtype)[2]
    a = got.float().numpy()
    scale = np.abs(want).max()
    err = np.abs(a - want)
    if dtype == "float32":
        assert err.max() <= F32_TOL * scale, err.max() / scale
    else:
        assert err.max() <= BF16_TOL["kernel"] * scale, err.max() / scale
        assert err.mean() <= BF16_MEAN_TOL * scale, err.mean() / scale
    whole = deform_conv2d_bwd_plain(tx, toff, tk, tg, stride,
                                    need=(False, False, True))[2]
    if splits == 1:
        assert torch.equal(got, whole)
    else:
        d = (got.double() - whole.double()).abs()
        assert float(d.max()) <= (1e-6 if dtype == "float32"
                                  else 2.0 ** -8) * float(
            whole.double().abs().max())


@pytest.mark.parametrize("h,w,c,stride,passes", [
    (92, 160, 128, 1, 2), (46, 80, 256, 1, 2), (23, 40, 512, 1, 1),
    (184, 320, 128, 2, 1), (92, 160, 256, 2, 1), (46, 80, 512, 2, 1)])
def test_ds_passes_keep_the_backward_below_a_sample_tensor(h, w, c, stride,
                                                           passes):
    """At DLA-102-DCN's training shapes in bf16: two passes over the
    pixels at stride 1 where dS is past the L2 (stages 3 and 4), and there
    half of dS with the input gradient's f32 sums [B H W, C] and the lists
    hold less than an [N, 9C] tensor; one at stride 2, where the f32 sums
    alone would not, and at stage 5, whose dS fits in the L2."""
    n, p = _out_pixels(h, w, stride), BATCH * h * w
    got = ds_passes(n, p, c, 2)
    assert len(got) == passes
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(got, got[1:]))
    alive = max(b - a for a, b in got) * 9 * c * 2 \
        + (4 * p * c if passes > 1 else 0) + 36 * n * 8 + 4 * (2 * p + 1)
    assert (alive < n * 9 * c * 2) == (passes > 1)
    assert len(ds_passes(n, p, c, 2, want_x=False)) == (
        1 if n * 9 * c * 2 <= L2_BYTES else 2)


def _pile(dtype, h=8, w=8, c=8):
    """Every sample of a stride-1 layer at (3.25, 4.5): 576 terms a pixel
    on four pixels, over six decades."""
    rng = np.random.RandomState(7)
    gy, gx = _taps(1, h, w, 1, 1, torch.device("cpu"))
    off = torch.stack(torch.broadcast_tensors(3.25 - gy, 4.5 - gx), -1)
    ds = rng.randn(1, h, w, 9, c) * 10.0 ** rng.uniform(-3, 3,
                                                        (1, h, w, 9, c))
    return off.to(dtype), torch.from_numpy(ds.astype(np.float32)).to(
        dtype).float(), (h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["pile", "stride 1", "stride 2"])
def test_input_gradient_in_passes_is_the_one_pass_sum(dtype, layer):
    """The input gradient summed pass by pass over chunks of source pixels
    in order (as ``ds_passes`` splits a layer), the f32 sums carried from
    one pass to the next, is bitwise the sum over the whole list in source
    order (the gather's passes on the card)."""
    if layer == "pile":
        off, ds, (h, w) = _pile(dtype)
        stride = 1
    else:
        stride = 1 if layer == "stride 1" else 2
        h, w, c = 15, 22, 24
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        rng = np.random.RandomState(3)
        off = torch.from_numpy((1.5 * rng.randn(1, ho, wo, 9, 2)).astype(
            np.float32)).to(dtype)
        ds = torch.from_numpy(rng.randn(1, ho, wo, 9, c).astype(
            np.float32)).to(dtype).float()
    b, ho, wo, _, c = ds.shape
    gy, gx = _taps(b, ho, wo, stride, 1, torch.device("cpu"))
    dest, vals = _dx_contributions(
        ds, *_route_b_point(gy, gx, off[..., 0], off[..., 1], dtype), h, w)
    key = torch.arange(len(dest))
    whole = _sum_in_order(dest, key, vals, b * h * w)
    n = b * ho * wo
    passes = [(0, n // 3), (n // 3, n)]     # as ds_passes splits a layer
    acc = None
    for n0, n1 in passes:
        part = (key >= 36 * n0) & (key < 36 * n1)
        acc = _sum_in_order(dest[part], key[part], vals[part], b * h * w,
                            init=acc)
    assert torch.equal(acc, whole)


def _one_hot_case(dtype, stride, where, seed=4):
    """x, offsets in (-0.5, 0) with bits below 2^-8 (relative, or at the
    absolute coordinate: -gy + u) and the one-hot kernel w[tap, c, tap C
    + c] = 1."""
    rng = np.random.RandomState(seed)
    b, h, w, c = 1, 12, 20, 8
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
    u = -(rng.randint(1, 128, (b, ho, wo, 9, 2)) + 0.5) / 256
    off = torch.from_numpy(u.astype(np.float32))
    if where == "absolute":
        gy, gx = _taps(b, ho, wo, stride, 1, torch.device("cpu"))
        off = off - torch.stack(torch.broadcast_tensors(gy, gx), -1).float()
    off = off.reshape(b, ho, wo, 18).to(dtype)
    k = torch.eye(9 * c).reshape(3, 3, c, 9 * c).to(dtype)
    return x, off, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,where", [
    (1, "relative"), (1, "absolute"), (2, "relative"), (2, "absolute")])
def test_one_hot_forward_is_jax_bit_for_bit(dtype, stride, where):
    """With one-hot weights the forward's output is its samples: the
    port's plain forward gives ``sample_plain``'s, and at coordinates in
    (-0.5, 0) with bits below 2^-8 (route B rounds the bf16 fraction
    there: -0.337890625 gives 0.6640625) route B in bf16 is bitwise the
    JAX ``deform_conv2d``; route A, and f32, within
    ``tests/test_torch_deform.py``'s tolerances."""
    td = getattr(torch, dtype)
    x, off, k = _one_hot_case(td, stride, where)
    route_a = window_route_possible(x.shape, k.shape, stride, 1,
                                    x.element_size()) and bool(in_window(off))
    assert route_a == (stride == 1 and where == "relative")
    got = deform_conv2d_plain(x, off, k, stride)
    b, ho, wo = off.shape[:3]
    c = x.shape[3]
    assert torch.equal(got.reshape(b, ho, wo, 9, c),
                       sample_plain(x, off, stride, 1, route_a))
    fn = jax.jit(partial(jax_deform_conv2d, stride=stride, dilation=1))
    want = np.asarray(fn(*[jnp.asarray(t.float().numpy(), jnp.dtype(dtype))
                           for t in (x, off, k)]).astype(jnp.float32))
    if route_a or dtype == "float32":
        # the Pallas kernel's blend, or an f32 blend, which XLA may fuse
        # otherwise (tests/test_torch_deform.py's tolerances)
        scale = np.abs(want).max()
        tol = (2e-5 * scale if dtype == "float32"
               else 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * scale)
        assert (np.abs(got.float().numpy() - want) <= tol).all()
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bfloat16" and not route_a:
        # the rounding matters here: exact fractions give other samples
        oy = off.reshape(b, ho, wo, 9, 2)
        gy, gx = _taps(b, ho, wo, stride, 1, torch.device("cpu"))
        cy = gy.to(td) + oy[..., 0]
        exact = (cy.float() - torch.floor(cy.float())).to(td).float()
        assert not torch.equal(exact, cy.float() - torch.floor(cy.float()))
