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
