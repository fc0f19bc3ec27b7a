"""Kernel 6 (unmasked depthwise xcorr and its gradient) of the port
against the JAX package, on the CPU: the plain forward against the Pallas
kernel without ``valid`` in interpret mode, and the port's differentiable
xcorr (its backward's plain versions) against ``jax.vjp`` of
``siammot_tpu.ops.xcorr.xcorr_depthwise_auto``.  Seeded numpy inputs
(N = 3, 12x12 search, 5x5 template, 8 channels); f32 on both sides, sums
in other orders -> atol 1e-5."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.ops.pallas.xcorr import xcorr_depthwise_pallas
from siammot_tpu.ops.xcorr import xcorr_depthwise_auto as jax_xcorr_auto
from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                         xcorr_depthwise_auto,
                                         xcorr_depthwise_plain,
                                         xcorr_grad_search,
                                         xcorr_grad_search_plain,
                                         xcorr_grad_template)

ATOL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    s = rng.randn(3, 12, 12, 8).astype(np.float32)
    t = rng.randn(3, 5, 5, 8).astype(np.float32)
    g = rng.randn(3, 8, 8, 8).astype(np.float32)
    return s, t, g


def test_forward_matches_pallas_interpret(inputs):
    s, t, _ = inputs
    want = xcorr_depthwise_pallas(jnp.asarray(s), jnp.asarray(t),
                                  interpret=True)
    got = xcorr_depthwise(torch.from_numpy(s), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (3, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_backward_matches_jax_vjp(inputs):
    s, t, g = inputs
    out, vjp = jax.vjp(jax_xcorr_auto, jnp.asarray(s), jnp.asarray(t))
    want_s, want_t = vjp(jnp.asarray(g))
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    got = xcorr_depthwise_auto(ts, tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=ATOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_s), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_t), rtol=0,
                               atol=ATOL)


def test_gradient_pieces_are_autograd_of_the_plain_xcorr(inputs):
    """Each gradient wrapper's CPU path against autograd through
    ``xcorr_depthwise_plain``; both keep the inputs' dtypes (bf16 in)."""
    s, t, g = inputs
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    xcorr_depthwise_plain(ts, tt).backward(torch.from_numpy(g))
    gt = torch.from_numpy(g)
    torch.testing.assert_close(xcorr_grad_search(gt, torch.from_numpy(t)),
                               ts.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(xcorr_grad_search_plain(gt,
                                                       torch.from_numpy(t)),
                               ts.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(xcorr_grad_template(torch.from_numpy(s), gt),
                               tt.grad, rtol=0, atol=ATOL)
    sb = torch.from_numpy(s).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
    xcorr_depthwise_auto(sb, tb).backward(gt)
    assert sb.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("hs,ht", [(75, 15), (35, 7)])
def test_backward_past_32_matches_jax_vjp(hs, ht):
    """SEARCH_REGION 5's 75x75 search region with the 15x15 template and
    the AOT recipe's 35x35 with its 7x7 one: search gradients past the
    32x32 the card's kernel once took.  The port's differentiable xcorr
    (its backward's plain versions) and ``xcorr_grad_search_plain``
    against ``jax.vjp`` of the JAX package's ``xcorr_depthwise_auto``; 2
    slots, 4 channels, f32.  Sums of up to 225 (the template gradient: up
    to 3721) products in other orders -> 1e-5 of the largest value."""
    rng = np.random.RandomState(hs + ht)
    ho = hs - ht + 1
    s = rng.randn(2, hs, hs, 4).astype(np.float32)
    t = rng.randn(2, ht, ht, 4).astype(np.float32)
    g = rng.randn(2, ho, ho, 4).astype(np.float32)
    out, vjp = jax.vjp(jax_xcorr_auto, jnp.asarray(s), jnp.asarray(t))
    want_s, want_t = (np.asarray(w) for w in vjp(jnp.asarray(g)))
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    got = xcorr_depthwise_auto(ts, tt)
    got.backward(torch.from_numpy(g))
    plain_s = xcorr_grad_search_plain(torch.from_numpy(g),
                                      torch.from_numpy(t))
    assert plain_s.shape == (2, hs, hs, 4)
    for name, k, w in (("output", got.detach().numpy(), np.asarray(out)),
                       ("d_search", ts.grad.numpy(), want_s),
                       ("d_search plain", plain_s.numpy(), want_s),
                       ("d_template", tt.grad.numpy(), want_t)):
        np.testing.assert_allclose(k, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


H100_SMEM = 232448   # bytes a block may opt in to on an H100


def test_grad_search_plan():
    """The search gradient's bands and column segments for an H100's
    shared memory: the training shapes (16x16 g, 15x15 taps) keep one band
    in every dtype mix, SEARCH_REGION 3's 45x45 output one band,
    SEARCH_REGION 5's 75x75 bands of 32 rows (16 when both inputs are
    bf16) and five 16-wide segments (the 15-wide template's compile-time
    form), the AOT recipe's 35x35 one band in f32 and bands of 16 when
    both are bf16.  Every plan covers the output with segments of at most
    64 and fits two stages; a gradient too wide for one output row's band
    raises with the limit."""
    from siammot_tpu_torch.ops.xcorr import (W_GEN, _row_stride,
                                             grad_search_plan)
    cases = {(16, 15, 4, 4): (30, 1), (16, 15, 4, 2): (30, 1),
             (16, 15, 2, 2): (30, 1), (31, 15, 4, 2): (45, 1),
             (61, 15, 4, 4): (32, 5), (61, 15, 4, 2): (32, 5),
             (61, 15, 2, 2): (16, 5), (29, 7, 4, 2): (35, 1),
             (29, 7, 2, 2): (16, 1)}
    for (hg, ht, gs, tsz), want in cases.items():
        rows, segs = grad_search_plan(hg, hg, ht, ht, gs, tsz, H100_SMEM)
        assert (rows, segs) == want, (hg, ht, gs, tsz)
        ho = hg + ht - 1
        assert 1 <= rows <= ho and segs * W_GEN >= ho
        assert -(-ho // segs) <= W_GEN
        tile = 16 if gs == tsz == 2 else 8
        rs = _row_stride(hg * tile * gs, 32 // tile, tile * gs)
        stage = min(hg, rows + ht - 1) * rs + ht * ht * tile * tsz
        assert 2 * (-(-stage // 16) * 16) <= H100_SMEM
    with pytest.raises(ValueError, match=str(H100_SMEM)):
        grad_search_plan(61, 2000, 15, 15, 4, 4, H100_SMEM)
