"""The deformable conv's forms that ``SIAMMOT_DCN_IMPL`` selects
(``ops/deform_conv.py``: ``gather4``, ``patch``, ``shiftwin``,
``pallas``) against the JAX package's ``deform_conv2d(..., impl=...)``
under ``jit``, on the CPU.

Inputs as ``tests/test_torch_deform.py``'s: a W = 300 layer (bf16 drops
whole pixels of the coordinates past 256) and a narrow 9x13 one, stride 1
and 2, offsets N(0, 0.3^2) inside ``shiftwin``'s window of radius 2 and
N(0, 2^2) outside it (its patch fallback).  ``shiftwin``'s gradient runs
at radius 0 with offsets in [0, 1) (in the window) and N(0, 0.3^2) (out
of it): JAX's VJP of the radius-2 form, (2r+2)^2 = 36 shifted views a
tap under a ``lax.cond``, takes minutes to compile on the CPU, and the
radius only sets how many shifts the same code sums.  The port takes
another radius only in ``deform_conv2d_form``, the plain form that
``deform_conv2d``'s backward differentiates, so that test differentiates
it directly.

Tolerances:
- the bf16 samples (``deform_sample``, ``_shiftwin_sampled``) before the
  product: bitwise, the form's arithmetic as XLA runs it reproduced;
- the output, f32: 1e-5 of its largest magnitude (the same samples, the
  [N, 9C] @ [9C, Co] sums in another order; measured under 1e-6);
- the output, bf16: within 2^-8 of its largest magnitude, and bitwise
  but for fewer than 1% of the elements: the f32 sums of the product run
  in another order, so an output can round to the neighbouring bf16 value
  (measured: 0 to 0.01% of the elements, 2.8e-4 of the scale);
- the gradients against ``jax.vjp`` of the same form: f32 1e-5 of each
  gradient's largest magnitude (measured under 5e-7); bf16 as
  ``tests/test_torch_deform_grad.py`` holds route B (autograd rounds its
  intermediates at other places than XLA's transposed gathers and
  einsum): 2^-5 for x and the offsets (measured up to 1.8e-2), 2^-9 for
  the kernel, whose sums are f32 on both sides, and a mean error under
  2^-9.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.ops import deform_conv as jdc
from siammot_tpu_torch.models.dla import DeformConv
from siammot_tpu_torch.ops.deform_conv import (R, _taps, deform_conv2d,
                                               deform_conv2d_bwd_plain,
                                               deform_conv2d_form,
                                               deform_conv2d_plain,
                                               deform_conv2d_vjp,
                                               resolve_impl, sample_gather4,
                                               sample_shiftwin)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
BF16_GRAD_TOL = {"x": 2.0 ** -5, "offsets": 2.0 ** -5, "kernel": 2.0 ** -9}
BF16_MEAN_TOL = 2.0 ** -9
DTYPES = ["float32", "bfloat16"]

# (H, W, C, Co, stride, offset scale)
IN = [(20, 300, 16, 24, 1, 0.3), (9, 13, 40, 8, 2, 0.3)]
OUT = [(20, 300, 16, 24, 1, 2.0), (20, 300, 16, 24, 2, 2.0)]


def _ids(c):
    return f"{c[1]}s{c[4]}x{c[5]}" if isinstance(c, tuple) else str(c)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0, uniform=False):
    h, w, c, co, stride, scale = case
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(1, h, w, c).astype(np.float32)
    off = (rng.uniform(0, 1, (1, ho, wo, 18)) if uniform
           else rng.randn(1, ho, wo, 18) * scale).astype(np.float32)
    k = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(1, ho, wo, co).astype(np.float32)
    return x, off, k, g


def _torch(arrays, dtype, grad=False):
    return [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(grad)
            for a in arrays]


def _f32(t):
    return np.asarray(t.astype(jnp.float32)) if hasattr(t, "astype") and \
        not isinstance(t, torch.Tensor) else t.detach().float().numpy()


def _assert_output(got, want, dtype):
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_TOL * scale, err.max() / scale
    else:
        assert err.max() <= BF16_TOL * scale, err.max() / scale
        assert (err > 0).mean() < 0.01, (err > 0).mean()


def _jax_forward(x, off, k, stride, dtype, impl):
    fn = jax.jit(partial(jdc.deform_conv2d, stride=stride, dilation=1,
                         impl=impl, shift_r=R))
    return _f32(fn(*[jnp.asarray(a, dtype) for a in (x, off, k)]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,case", [
    (impl, c) for impl in ("gather4", "patch") for c in IN + OUT]
    + [("shiftwin", c) for c in IN + OUT[:1]], ids=_ids)
def test_form_matches_jax(impl, case, dtype):
    """Each form against the JAX form; ``shiftwin`` in its window and,
    for the N(0, 2^2) offsets, through its patch fallback."""
    x, off, k, _ = _inputs(case)
    want = _jax_forward(x, off, k, case[4], jnp.dtype(dtype), impl)
    got = _f32(deform_conv2d(*_torch((x, off, k), dtype), case[4], 1, impl))
    assert got.shape == want.shape
    _assert_output(got, want, dtype)
    if impl == "shiftwin" and case in OUT:
        patch = _f32(deform_conv2d(*_torch((x, off, k), dtype), case[4], 1,
                                   "patch"))
        np.testing.assert_array_equal(got, patch)


@pytest.mark.parametrize("case", IN, ids=_ids)
def test_bf16_samples_are_bitwise_the_jax_forms(case):
    """``gather4``'s and ``shiftwin``'s bf16 samples before the product,
    bit for bit (the coordinates of ``gather4`` added in the offsets'
    dtype, as JAX promotes int32 + bf16; ``shiftwin``'s weight times view
    in f32, as XLA computes it).  In f32 the samples differ from XLA's
    in the last bit, where it contracts a product and a sum into one
    fused multiply-add; the f32 outputs are held above."""
    x, off, _, _ = _inputs(case)
    stride, dtype = case[4], "bfloat16"
    jx, joff = (jnp.asarray(a, jnp.dtype(dtype)) for a in (x, off))
    b, ho, wo, _ = off.shape
    gy = (jnp.arange(ho) * stride - 1)[:, None, None] \
        + jnp.repeat(jnp.arange(3), 3)[None, None, :]
    gx = (jnp.arange(wo) * stride - 1)[None, :, None] \
        + jnp.tile(jnp.arange(3), 3)[None, None, :]
    o = joff.reshape(b, ho, wo, 9, 2)
    want = jax.jit(jdc.deform_sample)(jx, gy[None] + o[..., 0],
                                      gx[None] + o[..., 1])
    tx, toff = _torch((x, off), dtype)
    np.testing.assert_array_equal(
        _f32(sample_gather4(tx, toff, stride, 1)), _f32(want))
    want = jax.jit(partial(jdc._shiftwin_sampled, kh=3, kw=3, stride=stride,
                           dilation=1, r=2))(jx, joff)
    np.testing.assert_array_equal(
        _f32(sample_shiftwin(tx, toff, stride, 1, 2)), _f32(want))
    gy_t, gx_t = _taps(b, ho, wo, stride, 1, "cpu")
    assert np.array_equal(gy_t[0, :, 0].numpy(), np.asarray(gy[:, 0]))
    assert np.array_equal(gx_t[0, 0].numpy(), np.asarray(gx[0]))


def _assert_grads(got, want, dtype):
    for name, g, w in zip(("x", "offsets", "kernel"), got, want):
        scale = np.abs(w).max()
        err = np.abs(g - w)
        if dtype == "float32":
            assert err.max() <= F32_TOL * scale, (name, err.max() / scale)
        else:
            assert err.max() <= BF16_GRAD_TOL[name] * scale, \
                (name, err.max() / scale)
            assert err.mean() <= BF16_MEAN_TOL * scale, \
                (name, err.mean() / scale)


def _grads(case, dtype, impl, shift_r=None, uniform=False):
    """The port's gradients and JAX's.  ``shift_r`` None: through
    ``deform_conv2d`` (``shiftwin`` at the port's radius ``R``), whose
    backward must be bitwise :func:`deform_conv2d_vjp`; another radius:
    autograd through ``deform_conv2d_form``, the form that backward
    recomputes."""
    x, off, k, g = _inputs(case, 1, uniform)
    fn = partial(jdc.deform_conv2d, stride=case[4], dilation=1, impl=impl,
                 shift_r=R if shift_r is None else shift_r)
    _, vjp = jax.vjp(fn, *[jnp.asarray(a, jnp.dtype(dtype))
                           for a in (x, off, k)])
    want = [_f32(t) for t in jax.jit(vjp)(jnp.asarray(g, jnp.dtype(dtype)))]
    ts = _torch((x, off, k), dtype, grad=True)
    if shift_r is None:
        out = deform_conv2d(*ts, case[4], 1, impl)
    else:
        out = deform_conv2d_form(*ts, case[4], 1, impl, shift_r)
    out.backward(*_torch((g,), dtype))
    got = [t.grad.float().numpy() for t in ts]
    if shift_r is None:
        # the backward recomputes the same form: the VJP alone gives its
        # bits
        again = deform_conv2d_vjp(*(t.detach() for t in ts),
                                  _torch((g,), dtype)[0], case[4], 1,
                                  impl=impl)
        for a, b in zip(again, got):
            np.testing.assert_array_equal(a.float().numpy(), b)
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", IN + OUT[:1], ids=_ids)
@pytest.mark.parametrize("impl", ["gather4", "patch"])
def test_form_gradient_matches_jax_vjp(impl, case, dtype):
    got, want = _grads(case, dtype, impl)
    _assert_grads(got, want, dtype)


@pytest.mark.parametrize("case,uniform,dtype", [
    ((12, 20, 16, 24, 1, 0.3), True, "float32"),
    ((12, 20, 16, 24, 1, 0.3), True, "bfloat16"),
    ((9, 13, 40, 8, 2, 0.3), True, "bfloat16"),
    ((12, 20, 16, 24, 1, 0.3), False, "float32")],
    ids=["s1in-f32", "s1in-bf16", "s2in-bf16", "s1out-f32"])
def test_shiftwin_gradient_matches_jax_vjp(case, uniform, dtype):
    """At radius 0: offsets in [0, 1) keep every floor at 0 (the shifted
    views); N(0, 0.3^2) leave it (the patch fallback's gradient)."""
    got, want = _grads(case, dtype, "shiftwin", shift_r=0, uniform=uniform)
    _assert_grads(got, want, dtype)


def test_environment_variable_is_read_at_each_call(monkeypatch):
    x, off, k, _ = _inputs(IN[1])
    args = _torch((x, off, k), "bfloat16")
    forms = {impl: deform_conv2d(*args, 2, 1, impl)
             for impl in ("gather4", "patch", "shiftwin", "pallas")}
    assert not torch.equal(forms["gather4"], forms["patch"])
    layer = DeformConv(40, 8, stride=2).to(torch.bfloat16)
    with torch.no_grad():
        layer.offset.weight.zero_()
        layer.offset.bias.copy_(torch.tensor(0.37))
        layer.kernel.copy_(args[2])
    xin = args[0].permute(0, 3, 1, 2)
    for impl in ("gather4", "patch", "shiftwin", "pallas", "gather4"):
        monkeypatch.setenv("SIAMMOT_DCN_IMPL", impl)
        assert resolve_impl() == impl
        assert torch.equal(deform_conv2d(*args, 2), forms[impl]), impl
        with torch.no_grad():
            out = layer(xin).permute(0, 2, 3, 1)
        assert torch.equal(out, deform_conv2d(
            args[0], torch.full_like(args[1], 0.37), args[2], 2, 1, impl))
    monkeypatch.delenv("SIAMMOT_DCN_IMPL")
    assert resolve_impl() == "pallas"


def test_unknown_impl_raises_the_jax_message(monkeypatch):
    x, off, k, _ = _inputs(IN[1])
    monkeypatch.setenv("SIAMMOT_DCN_IMPL", "bogus")
    with pytest.raises(ValueError) as want:
        jdc.deform_conv2d(*[jnp.asarray(a) for a in (x, off, k)], 2)
    with pytest.raises(ValueError) as got:
        deform_conv2d(*_torch((x, off, k), "float32"), 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="'nope'"):
        deform_conv2d(*_torch((x, off, k), "float32"), 2, 1, "nope")


@pytest.mark.parametrize("dtype", DTYPES)
def test_pallas_is_unchanged(dtype):
    """The default form is the guarded kernel-9 route: on the CPU its plain
    version, bit for bit, and route B's backward: its kernels' plain
    version (``deform_conv2d_bwd_plain``) bit for bit, within the
    gradient tolerances of route B's autograd VJP (the input's gradient
    sums each pixel's terms in source order, autograd in its own)."""
    x, off, k, g = _inputs(IN[0], 2)
    args = _torch((x, off, k), dtype)
    want = deform_conv2d_plain(*args, 1)
    assert torch.equal(deform_conv2d(*args, 1), want)
    assert torch.equal(deform_conv2d(*args, 1, 1, "pallas"), want)
    ts = _torch((x, off, k), dtype, grad=True)
    gt = _torch((g,), dtype)[0]
    deform_conv2d(*ts, 1).backward(gt)
    for t, v in zip(ts, deform_conv2d_bwd_plain(*args, gt, 1)):
        assert torch.equal(t.grad, v)
    _assert_grads([t.grad.float().numpy() for t in ts],
                  [v.float().numpy() for v in deform_conv2d_vjp(*args, gt,
                                                                1)], dtype)
