"""Kernel 9's backward, ``ops/deform_conv.py:deform_conv2d_bwd`` (CUDA in
``ops/cuda/deform_bwd.cu``), through its plain version
``deform_conv2d_bwd_plain`` on the CPU.

The plain version writes route B's VJP out step by step in the kernels'
order: the samples, dKernel = S^T G and dS = G W^T with f32 sums, the
offsets' gradient from dS and the corners with the corner weights'
derivatives in f32, and the input's gradient summed for each input pixel
over its contributions in source order.  It is held to ``jax.vjp`` of the
JAX ``deform_conv2d`` (whose backward, ``_pallas_guarded_bwd``, is the VJP
of the exact patch form) on ``tests/test_torch_deform_grad.py``'s cases
and tolerances, and to the port's autograd VJP ``deform_conv2d_vjp``:
the kernel's gradient bitwise (the same product), the others to the f32
rounding of sums taken in another order (f32 1e-6 of the scale; bf16
one bf16 step of the element).

The order is fixed: on a layer whose samples all land on one 2x2 patch of
the input, each of those four pixels sums hundreds of terms of mixed
magnitude, and any permutation of the contribution list gives the same
bits, while the reversed order gives other bits.  The card test of the
kernels against this version is in ``tests/test_torch_cuda.py``.
"""

import itertools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import siammot_tpu_torch.ops.deform_conv as dc
from siammot_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from siammot_tpu_torch.ops.deform_conv import (_dx_contributions,
                                               _route_b_point, _sum_in_order,
                                               _taps, deform_conv2d,
                                               deform_conv2d_bwd,
                                               deform_conv2d_bwd_plain,
                                               deform_conv2d_vjp)
from test_torch_deform_grad import (BF16_MEAN_TOL, BF16_TOL, CASES, F32_TOL,
                                    _inputs)

NAMES = ("x", "offsets", "kernel")
AUTOGRAD_F32_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@partial(jax.jit, static_argnums=4)
def _jax_vjp(x, off, k, g, stride):
    """``jax.vjp`` of the JAX ``deform_conv2d`` (default route), forward
    and backward in one jit (eager, its Pallas forward runs in interpret
    mode for seconds)."""
    fn = partial(jax_deform_conv2d, stride=stride, dilation=1)
    return jax.vjp(fn, x, off, k)[1](g)


def _case_ids(c):
    return f"{c[1]}s{c[4]}{c[6]}" if isinstance(c, tuple) else str(c)


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_plain_backward_matches_jax_vjp(case, dtype):
    x, off, k, g = _inputs(case)
    stride = case[4]
    want = [np.asarray(t.astype(jnp.float32)) for t in _jax_vjp(
        *[jnp.asarray(a, jnp.dtype(dtype)) for a in (x, off, k, g)], stride)]
    got = deform_conv2d_bwd_plain(*_torch((x, off, k, g),
                                          getattr(torch, dtype)), stride)
    for name, a, b in zip(NAMES, got, want):
        a = a.float().numpy()
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_plain_backward_matches_autograd_vjp(case, dtype):
    x, off, k, g = _inputs(case, seed=1)
    td = getattr(torch, dtype)
    args = _torch((x, off, k, g), td)
    got = deform_conv2d_bwd_plain(*args, case[4])
    want = deform_conv2d_vjp(*args, case[4])
    assert torch.equal(got[2], want[2])
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == td and a.shape == b.shape, name
        a, b = a.double(), b.double()
        if dtype == "float32":
            assert (a - b).abs().max() <= AUTOGRAD_F32_TOL * b.abs().max(), \
                name
        else:
            assert ((a - b).abs() <= 2.0 ** -8 * b.abs()).all(), name


def _pile(dtype, h=8, w=8, c=8, co=4):
    """A stride-1 layer whose every sample sits at (3.25, 4.5): all 36
    corner terms of each of its 64 pixels land on 4 input pixels.  The
    upstream gradient spans six decades, so the f32 sums depend on their
    order."""
    rng = np.random.RandomState(7)
    gy, gx = _taps(1, h, w, 1, 1, torch.device("cpu"))
    off = torch.stack(torch.broadcast_tensors(3.25 - gy, 4.5 - gx), -1)
    off = off.reshape(1, h, w, 18).to(dtype)
    x = torch.from_numpy(rng.randn(1, h, w, c).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.randn(3, 3, c, co).astype(np.float32)).to(dtype)
    g = rng.randn(1, h, w, co) * 10.0 ** rng.uniform(-3, 3, (1, h, w, co))
    return x, off, k, torch.from_numpy(g.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_input_gradient_sums_in_a_fixed_order(dtype):
    x, off, k, g = _pile(dtype)
    b, h, w, c = x.shape
    dx = deform_conv2d_bwd_plain(x, off, k, g, 1)[0]
    hit = torch.zeros(h, w, dtype=torch.bool)
    hit[3:5, 4:6] = True
    assert (dx[0][~hit] == 0).all() and (dx[0][hit] != 0).all()
    # the contribution list as the plain version builds it
    ds = (g.reshape(-1, k.shape[3]).float()
          @ k.reshape(9 * c, -1).float().t()).to(dtype).float()
    ds = ds.reshape(b, h, w, 9, c)
    o = off.reshape(b, h, w, 9, 2)
    gy, gx = _taps(b, h, w, 1, 1, x.device)
    dest, vals = _dx_contributions(
        ds, *_route_b_point(gy, gx, o[..., 0], o[..., 1], dtype), h, w)
    key = torch.arange(len(dest))
    assert int((dest >= 0).sum()) == 4 * 9 * h * w
    assert int(torch.bincount(dest[dest >= 0]).max()) == 9 * h * w
    want = _sum_in_order(dest, key, vals, b * h * w)
    assert torch.equal(want.to(dtype).reshape(x.shape), dx)
    # any order of the list: the same bits
    for seed in range(3):
        perm = torch.randperm(len(dest),
                              generator=torch.Generator().manual_seed(seed))
        assert torch.equal(_sum_in_order(dest[perm], key[perm], vals[perm],
                                         b * h * w), want)
    # in source order, one term at a time
    for q in torch.nonzero(torch.bincount(dest[dest >= 0])).flatten():
        acc = torch.zeros(c)
        for i in torch.nonzero(dest == q).flatten():
            acc = acc + vals[i]
        assert torch.equal(acc, want[q])
    # the order matters here: the reversed list sums to other bits
    assert not torch.equal(_sum_in_order(dest, len(key) - 1 - key, vals,
                                         b * h * w), want)


def test_need_leaves_out_what_is_not_asked_for():
    x, off, k, g = _torch(_inputs(CASES[3]), torch.float32)
    full = deform_conv2d_bwd_plain(x, off, k, g, 2)
    for need in itertools.product((False, True), repeat=3):
        got = deform_conv2d_bwd(x, off, k, g, 2, need=need)
        for asked, a, b in zip(need, got, full):
            assert (a is None) != asked
            if asked:
                assert torch.equal(a, b)
    ts = [t.clone().requires_grad_(r) for t, r in zip((x, off, k),
                                                      (True, False, True))]
    deform_conv2d(*ts, 2).backward(g)
    assert ts[1].grad is None
    assert torch.equal(ts[0].grad, full[0])
    assert torch.equal(ts[2].grad, full[2])


@pytest.mark.parametrize("impl", ["pallas", "patch", "gather4", "shiftwin"])
def test_backward_dispatch(impl, monkeypatch):
    """``pallas`` on CPU tensors: the kernels' plain version, no launch
    counted; ``patch``, ``gather4`` and ``shiftwin``: autograd through
    their own forms (``deform_conv2d_vjp``), as the JAX package
    differentiates its XLA forms."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, kw.get("impl")))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dc, "deform_conv2d_bwd_plain",
                        spy("plain", dc.deform_conv2d_bwd_plain))
    monkeypatch.setattr(dc, "deform_conv2d_vjp",
                        spy("vjp", dc.deform_conv2d_vjp))
    x, off, k, g = _torch(_inputs(CASES[4]), torch.bfloat16)
    ts = [t.clone().requires_grad_() for t in (x, off, k)]
    launches = deform_conv2d_bwd.launches
    deform_conv2d(*ts, 2, 1, impl).backward(g)
    assert calls == ([("plain", None)] if impl == "pallas"
                     else [("vjp", impl)])
    assert deform_conv2d_bwd.launches == launches
    want = (deform_conv2d_bwd_plain(x, off, k, g, 2) if impl == "pallas"
            else deform_conv2d_vjp(x, off, k, g, 2, impl=impl))
    for t, v in zip(ts, want):
        assert torch.equal(t.grad, v)


@pytest.mark.parametrize("bad,error", [
    ("kernel 5x5", ValueError), ("offsets 9 taps", ValueError),
    ("float16", TypeError), ("strided", ValueError), ("grad", ValueError)])
def test_kernel_wrapper_raises_on_what_it_does_not_take(bad, error):
    """Off the CPU (here the meta device) the wrapper checks its inputs
    before any launch, as the forward's does."""
    x = torch.empty(1, 12, 20, 16, device="meta")
    off = torch.empty(1, 12, 20, 18, device="meta")
    k = torch.empty(3, 3, 16, 24, device="meta")
    g = torch.empty(1, 12, 20, 24, device="meta")
    if bad == "kernel 5x5":
        k = torch.empty(5, 5, 16, 24, device="meta")
    elif bad == "offsets 9 taps":
        off = torch.empty(1, 12, 20, 9, device="meta")
    elif bad == "float16":
        x, off, k, g = (t.half() for t in (x, off, k, g))
    elif bad == "strided":
        x = torch.empty(1, 12, 40, 16, device="meta")[:, :, ::2]
    else:
        g = torch.empty(1, 12, 20, 8, device="meta")
    with pytest.raises(error, match="deform_conv2d_bwd"):
        deform_conv2d_bwd(x, off, k, g, 1)
