"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (as on
the CPU machines that run the tier-1 suite).  On a machine with the card
and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX). Shapes are the
main path's and the other shapes the JAX kernels take (predictor bf16
and f32 at 16x16, 29x29, 61x61 and two narrow maps with 0, 1, 37 and 128
live slots, kernel 8 with groups of 2 and 8 slots, decode s_hi 464 and 512,
the deformable conv at DLA-102's stages and with its taps split, the
unmasked xcorr's three passes at the training shapes in every dtype mix
and at other widths, the window pool at each site's size and window with
every kind of ``valid``, the masked xcorr with 0, 1, 37 and 128 of 128
slots live at 16x16, 61x61 and two generic widths, the pool's table
gradient at the three training sites and under a crowded tile, the
gather pooler at each site's size with hundreds of ROIs on one spot),
small elsewhere. Kernel 2's live slots must equal kernel 6's output bit
for bit, kernels 3, 7 and 8 and the gather pooler's backward must give
the same bits from launch to launch, kernel 8 kernel 3's bits, the
gather backward its ordered plain form's (``roi_align_bwd_ordered``) and
the gather forward its first version's (digests); the P016 and YUV444
video conversions (``data/nvdec.cu``) their plain versions bit for bit.
Tolerances as in ``chip_smoke.py``: pool/xcorr f32 sums in another order
(1e-4 + 1e-3|x|), predictor logits 3e-2 in bf16 (tower rounding) and
1e-4 in f32, decode idx exact and scores 1e-5, deformable conv 2e-5 of
the output's scale in f32 and one bf16 step plus 2^-9 of the scale in
bf16 (the same samples, f32 sums in another order), and with one-hot
weights its samples bit for bit; its backward's samples bitwise, its
bf16 dKernel product within one bf16 rounding of cuBLAS's S^T G, its
gradients within 1e-5 of their scale in f32 and, in bf16,
``chip_smoke.DCN_GRAD_MAX``/``DCN_GRAD_MEAN`` (2^-5 and 2^-9 of the
scale: dS rounds to bf16 after sums in another order), and bitwise the
same from call to call.
"""

import numpy as np
import pytest
import torch

from siammot_tpu_torch.core.boxes import map_rois_to_levels
from siammot_tpu_torch.models.emm import _decode_constants
from siammot_tpu_torch.ops.decode import emm_decode, emm_decode_plain
from siammot_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_bwd,
                                               deform_conv2d_bwd_plain,
                                               deform_conv2d_plain)
from siammot_tpu_torch.ops.predictor import (_NAMES, emm_predictor,
                                             emm_predictor_plain)
from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                      window_geometry)
from siammot_tpu_torch.ops.window_pool import (window_pool,
                                               window_pool_bwd,
                                               window_pool_bwd_plain,
                                               window_pool_plain,
                                               window_pool_train)
from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                         xcorr_depthwise_auto,
                                         xcorr_depthwise_masked,
                                         xcorr_depthwise_plain)

pytestmark = pytest.mark.cuda

SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _valid(n, seed):
    v = np.random.RandomState(seed).rand(n) < 0.4
    v[0] = True
    return torch.from_numpy(v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_pool_kernel(dev, dtype):
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(1, 64 // 2 ** i, 96 // 2 ** i, 128, generator=g)
             for i in range(4)]
    pack = pack_levels([f.to(dev) for f in feats], SCALES, dtype=dtype)
    xy = torch.rand(40, 2, generator=g) * 300
    rois = torch.cat([xy, xy + 10 + 100 * torch.rand(40, 2, generator=g)], 1)
    levels = map_rois_to_levels(rois, 2, 5).to(dev)
    scales = torch.tensor(SCALES, device=dev)[levels.long()]
    args = window_geometry(pack.heights, pack.widths, pack.row_offsets,
                           rois.to(dev), levels, scales, 7, 2, 32, 0, 4) \
        + (_valid(40, 1).to(dev),)
    got = window_pool(pack.table, *args)
    want = window_pool_plain(pack.table, *args)
    assert (got[~args[3]] == 0).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_xcorr_kernel(dev, dtype):
    g = torch.Generator().manual_seed(2)
    s = torch.randn(9, 30, 30, 160, generator=g).to(dev, dtype)
    t = torch.randn(9, 15, 15, 160, generator=g).to(dev, dtype)
    valid = _valid(9, 3).to(dev)
    got = xcorr_depthwise_masked(s, t, valid)
    want = xcorr_depthwise_plain(s, t, valid)
    assert (got[~valid] == 0).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


def test_predictor_kernel(dev):
    g = torch.Generator().manual_seed(4)
    params = {}
    for name in _NAMES:
        head = name.split(".")[0]
        cout = {"cls": 2, "center": 1, "reg": 4}.get(head, 128)
        shape = (3, 3, 128, cout) if name.endswith("kernel") else (cout,)
        t = torch.randn(*shape, generator=g) * (0.03 if len(shape) > 1
                                                 else 0.1)
        if name.endswith("scale"):
            t = t + 1
        params[name] = t.to(dev, torch.bfloat16).contiguous()
    x = torch.randn(6, 16, 16, 128, generator=g).to(dev, torch.bfloat16)
    valid = _valid(6, 5).to(dev)
    for got, want in zip(emm_predictor(x, valid, params),
                         emm_predictor_plain(x, valid, params)):
        assert (got[~valid] == 0).all()
        torch.testing.assert_close(got, want, atol=3e-2, rtol=0)
    with pytest.raises(ValueError):
        emm_predictor(x.float(), valid, params)


def _predictor_params(g, c, dtype, dev):
    params = {}
    for name in _NAMES:
        head = name.split(".")[0]
        cout = {"cls": 2, "center": 1, "reg": 4}.get(head, c)
        shape = (3, 3, c, cout) if name.endswith("kernel") else (cout,)
        t = torch.randn(*shape, generator=g) * (0.03 if len(shape) > 1
                                                 else 0.1)
        if name.endswith("scale"):
            t = t + 1
        params[name] = t.to(dev, dtype).contiguous()
    return params


@pytest.mark.parametrize("s,c,dtype,tol", [
    (16, 128, torch.float32, 1e-4), (29, 128, torch.bfloat16, 3e-2),
    (29, 128, torch.float32, 1e-4), (13, 64, torch.bfloat16, 3e-2),
    (11, 96, torch.bfloat16, 3e-2), (11, 32, torch.bfloat16, 3e-2)])
def test_predictor_kernel_tiled_shapes(dev, s, c, dtype, tol):
    """Other shapes: the f32 frame's (the FFMA tower conv), the AOT
    recipe's 29x29 response, and narrower maps (C not a multiple of 64:
    the bf16 kernel's smaller swizzle, a part-filled channel tile)."""
    g = torch.Generator().manual_seed(11)
    params = _predictor_params(g, c, dtype, dev)
    x = torch.randn(7, s, s, c, generator=g).to(dev, dtype)
    valid = _valid(7, 12).to(dev)
    for got, want in zip(emm_predictor(x, valid, params),
                         emm_predictor_plain(x, valid, params)):
        assert (got[~valid] == 0).all()
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


_PRED_SHAPES = [(16, 128), (29, 128), (61, 128), (13, 64), (11, 32)]


def _predictor_case(dev, s, c, live, dtype, seed=29, k=128):
    g = torch.Generator().manual_seed(seed)
    params = _predictor_params(g, c, dtype, dev)
    x = torch.randn(k, s, s, c, generator=g).to(dev, dtype)
    valid = torch.zeros(k, dtype=torch.bool)
    valid[torch.randperm(k, generator=g)[:live]] = True
    return x, valid.to(dev), params


@pytest.mark.parametrize("live", [0, 1, 37, 128])
@pytest.mark.parametrize("s,c", _PRED_SHAPES)
def test_predictor_kernel_wgmma(dev, s, c, live):
    """The bf16 tower conv on wgmma and the head pass at the main path's
    16x16, the AOT recipe's 29x29, SEARCH_REGION 5's 61x61 (head bands
    starting mid-row) and narrow 13x13x64 and 11x11x32 maps, with 0, 1,
    37 and all 128 of 128 slots live: against the plain version, dead
    slots exactly zero."""
    x, valid, params = _predictor_case(dev, s, c, live, torch.bfloat16)
    for got, want in zip(emm_predictor(x, valid, params),
                         emm_predictor_plain(x, valid, params)):
        assert (got[~valid] == 0).all()
        torch.testing.assert_close(got, want, atol=3e-2, rtol=0)


@pytest.mark.parametrize("live", [0, 1, 37, 128])
@pytest.mark.parametrize("s,c", _PRED_SHAPES)
def test_predictor_kernel_f32_live_slots(dev, s, c, live):
    """The f32 form (FFMA tower conv, the same head pass) at the same
    shapes and occupancies: within 1e-4 of the plain version."""
    x, valid, params = _predictor_case(dev, s, c, live, torch.float32)
    for got, want in zip(emm_predictor(x, valid, params),
                         emm_predictor_plain(x, valid, params)):
        assert (got[~valid] == 0).all()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [16, 61])
def test_predictor_kernels_repeat_bitwise(dev, s, dtype):
    """Kernels 3 and 8 give the same bits launched twice (the GroupNorm
    partials are added in a fixed order, no atomics), and kernel 8, which
    runs kernel 3's kernels over groups of slots, gives kernel 3's bits."""
    from siammot_tpu_torch.ops.predictor import emm_predictor_blocked
    x, valid, params = _predictor_case(dev, s, 128, 37, dtype, seed=31)
    first = emm_predictor(x, valid, params)
    for out in (emm_predictor(x, valid, params),
                emm_predictor_blocked(x, valid, params, 8),
                emm_predictor_blocked(x, valid, params, 8)):
        for a, b in zip(first, out):
            assert torch.equal(a, b)


@pytest.mark.parametrize("s,up", [(29, 16), (32, 16), (13, 16), (16, 8)])
def test_decode_kernel_other_sizes(dev, s, up):
    """s_hi 464 (the AOT recipe), 512 (the whole-map limit), 208 and 128:
    ragged sizes and the chunked row factor."""
    g = torch.Generator().manual_seed(13)
    k = 9
    u, window = _decode_constants(s, up, str(dev))
    x4 = torch.stack([2 * torch.randn(k, s, s, generator=g),
                      torch.randn(k, s, s, generator=g),
                      60 + 20 * torch.randn(k, s, s, generator=g),
                      120 + 40 * torch.randn(k, s, s, generator=g)], 1)
    wh = torch.stack([40 + 110 * torch.rand(k, generator=g),
                      80 + 220 * torch.rand(k, generator=g)], -1)
    valid = _valid(k, 14)
    args = (x4.to(dev).contiguous(), wh.to(dev), u, window, valid.to(dev),
            0.4, True)
    gi, gs = emm_decode(*args)
    wi, ws = emm_decode_plain(*args)
    torch.testing.assert_close(gi, wi, atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,co,stride,scale", [
    (23, 40, 64, 64, 1, 0.3), (23, 300, 32, 48, 1, 2.0),
    (46, 80, 64, 64, 2, 0.8), (9, 13, 40, 8, 2, 3.0),
    (11, 17, 13, 10, 1, 0.3), (12, 9, 20, 7, 2, 2.0)])
def test_deform_kernel(dev, dtype, h, w, c, co, stride, scale):
    """Kernel 9 against its plain version: both routes, both strides,
    partial channel tiles, coordinates past 256, and C and Co that are
    not multiples of 8 (element loads; an odd Co)."""
    g = torch.Generator().manual_seed(15)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(2, h, w, c, generator=g).to(dev, dtype)
    off = (scale * torch.randn(2, ho, wo, 18, generator=g)).to(dev, dtype)
    k = (torch.randn(3, 3, c, co, generator=g) / (9 * c) ** 0.5).to(dev,
                                                                    dtype)
    got = deform_conv2d(x, off, k, stride).float()
    want = deform_conv2d_plain(x, off, k, stride).float()
    scale_ = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5 * scale_, rtol=0)
    else:
        torch.testing.assert_close(got, want, atol=2 ** -9 * scale_,
                                   rtol=2 ** -7)


def _deform_close(got, want):
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2 ** -9 * scale, rtol=2 ** -7)


@pytest.mark.parametrize("route", ["A", "B"])
@pytest.mark.parametrize("stage,h,w,c,stride", [
    (3, 184, 320, 128, 2), (3, 92, 160, 128, 1), (4, 92, 160, 256, 2),
    (4, 46, 80, 256, 1), (5, 46, 80, 512, 2), (5, 23, 40, 512, 1)])
def test_deform_kernel_dla102_stages(dev, stage, h, w, c, stride, route):
    """The bf16 wgmma kernel at DLA-102-DCN's stage shapes (C = Co), both
    strides; offsets inside kernel 9's window (route A where the stride
    allows it) and outside (route B)."""
    from siammot_tpu_torch.ops.deform_conv import (in_window,
                                                   window_route_possible)
    g = torch.Generator().manual_seed(30 + stage)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(1, h, w, c, generator=g).to(dev, torch.bfloat16)
    scale = 0.35 if route == "A" else 3.0
    off = (scale * torch.randn(1, ho, wo, 18, generator=g)).to(
        dev, torch.bfloat16)
    k = (torch.randn(3, 3, c, c, generator=g) / (9 * c) ** 0.5).to(
        dev, torch.bfloat16)
    a = window_route_possible(x.shape, k.shape, stride, 1, 2) \
        and bool(in_window(off))
    assert a == (route == "A" and stride == 1)
    _deform_close(deform_conv2d(x, off, k, stride),
                  deform_conv2d_plain(x, off, k, stride))


@pytest.mark.parametrize("splits", [3, 9])
def test_deform_kernel_tap_split(dev, splits):
    """DLA-102's stage 5 (23x40x512), the taps split over 3 and 9 blocks
    with f32 partial sums, against the unsplit kernel and the plain
    version: the same samples, f32 sums in another order."""
    from siammot_tpu_torch.ops.deform_conv import _launch, tap_splits
    assert tap_splits(23 * 40, 512) == 3
    g = torch.Generator().manual_seed(40)
    x = torch.randn(1, 23, 40, 512, generator=g).to(dev, torch.bfloat16)
    off = (0.35 * torch.randn(1, 23, 40, 18, generator=g)).to(
        dev, torch.bfloat16)
    k = (torch.randn(3, 3, 512, 512, generator=g) / 68.0).to(
        dev, torch.bfloat16)
    whole = _launch(x, off, k, 1, 1, 1)
    split = _launch(x, off, k, 1, 1, splits)
    _deform_close(split, whole)
    _deform_close(split, deform_conv2d_plain(x, off, k, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,co,stride,scale", [
    (23, 40, 64, 64, 1, 0.3), (23, 300, 32, 48, 1, 2.0),
    (46, 80, 64, 64, 2, 0.8), (9, 13, 40, 8, 2, 3.0),
    (11, 17, 13, 10, 1, 0.3), (92, 160, 128, 128, 1, 0.35),
    (8, 8, 8, 4, 1, None), (23, 40, 512, 512, 1, 0.35),
    (12, 20, 64, 200, 2, 0.8), (10, 14, 16, 24, 1, "out")])
def test_deform_backward_kernels(dev, dtype, h, w, c, co, stride, scale):
    """Kernel 9's backward against its plain version: both strides,
    coordinates past 256, ragged channels (element loads), a DLA-102
    stage-3 layer, C = 512, Co not a multiple of 128, a pile (scale None:
    every sample at (3.25, 4.5), so four input pixels take 9 x 64 terms
    each) and empty lists (every sample outside the map); the samples bit
    for bit; in bf16 the wgmma dKernel within one bf16 rounding of
    cuBLAS's f32-sum S^T G on them; two calls bitwise alike; one launch
    counted a call."""
    from siammot_tpu_torch.ops.deform_conv import (_bwd_dkernel,
                                                   _bwd_sample, _f32_sums,
                                                   _taps, sample_plain)
    g = torch.Generator().manual_seed(16)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(2, h, w, c, generator=g).to(dev, dtype)
    if scale is None:
        gy, gx = _taps(2, ho, wo, stride, 1, torch.device("cpu"))
        off = torch.stack(torch.broadcast_tensors(3.25 - gy, 4.5 - gx), -1)
        off = off.expand(2, ho, wo, 9, 2).reshape(2, ho, wo, 18)
    elif scale == "out":
        off = torch.full((2, ho, wo, 18), 100.0)
    else:
        off = scale * torch.randn(2, ho, wo, 18, generator=g)
    off = off.to(dev, dtype).contiguous()
    k = (torch.randn(3, 3, c, co, generator=g) / (9 * c) ** 0.5).to(dev,
                                                                    dtype)
    gr = torch.randn(2, ho, wo, co, generator=g).to(dev, dtype)
    s = _bwd_sample(x, off, stride, 1)
    assert torch.equal(s, sample_plain(x, off, stride, 1, False).reshape(
        s.shape))
    if dtype == torch.bfloat16:
        with _f32_sums():
            ref = s.float().t() @ gr.reshape(s.shape[0], co).float()
        dk = _bwd_dkernel(x, off, gr, stride, 1).float().reshape(ref.shape)
        scale_ = float(ref.abs().max())
        assert ((dk - ref).abs() <= 2 ** -12 * scale_
                + 2 ** -8 * ref.abs()).all()
    launches = deform_conv2d_bwd.launches
    got = deform_conv2d_bwd(x, off, k, gr, stride)
    again = deform_conv2d_bwd(x, off, k, gr, stride)
    assert deform_conv2d_bwd.launches == launches + 2
    want = deform_conv2d_bwd_plain(x, off, k, gr, stride)
    for a, b, v in zip(got, again, want):
        assert torch.equal(a, b)
        a, v = a.double(), v.double()
        scale_ = float(v.abs().max())
        err = (a - v).abs()
        if scale == "out":
            assert torch.equal(a, v)    # nothing lands: all zero
        elif dtype == torch.float32:
            assert float(err.max()) <= 1e-5 * scale_
        else:
            assert float(err.max()) <= 2 ** -5 * scale_
            assert float(err.mean()) <= 2 ** -9 * scale_


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,stride,scale", [
    (23, 40, 64, 1, 0.35), (24, 40, 128, 2, 0.8), (11, 17, 13, 1, 2.0),
    (9, 12, 256, 1, 0.35), (8, 8, 8, 1, None), (15, 22, 40, 2, 3.0)])
def test_deform_backward_input_gradient_from_the_same_ds(dev, dtype, h, w, c,
                                                        stride, scale):
    """The input gradient's kernels (the lists, then the gather, in one
    pass and in two with the f32 sums carried) given the plain version's
    own dS: bitwise the plain version's dX, whose arithmetic and order
    they share (odd maps, ragged channels, both strides, the 576-term
    pile)."""
    from siammot_tpu_torch.ops import cuda
    from siammot_tpu_torch.ops.deform_conv import (_BWD_SCATTER_ARGS,
                                                   _bwd_geometry,
                                                   _bwd_lists, _taps)
    g = torch.Generator().manual_seed(24)
    b, co = 2, 24
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(b, h, w, c, generator=g).to(dtype)
    if scale is None:
        gy, gx = _taps(b, ho, wo, stride, 1, torch.device("cpu"))
        off = torch.stack(torch.broadcast_tensors(3.25 - gy, 4.5 - gx), -1)
        off = off.expand(b, ho, wo, 9, 2).reshape(b, ho, wo, 18)
    else:
        off = scale * torch.randn(b, ho, wo, 18, generator=g)
    off = off.to(dtype).contiguous()
    k = (torch.randn(3, 3, c, co, generator=g) / (9 * c) ** 0.5).to(dtype)
    gr = torch.randn(b, ho, wo, co, generator=g).to(dtype)
    want = deform_conv2d_bwd_plain(x, off, k, gr, stride,
                                   need=(True, False, False))[0]
    n = b * ho * wo
    ds = (gr.reshape(n, co).float() @ k.reshape(9 * c, co).float().t()).to(
        dtype).to(dev)
    xd, od = x.to(dev), off.to(dev)
    geometry = _bwd_geometry(xd, od, stride, 1)
    lists = _bwd_lists(od, xd.shape, geometry)
    fn = cuda.function("siammot_deform_bwd_scatter", _BWD_SCATTER_ARGS)
    for passes in ([(0, n)], [(0, n // 3), (n // 3, n)]):
        dx = torch.empty_like(xd)
        acc = torch.empty(b * h * w, c, dtype=torch.float32, device=dev)
        for i, (n0, n1) in enumerate(passes):
            last = i == len(passes) - 1
            part = ds[n0:n1].contiguous()
            cuda.check("deform_bwd_scatter", fn(
                cuda.ptr(xd), cuda.ptr(od), cuda.ptr(part), None,
                *(cuda.ptr(t) for t in lists),
                cuda.ptr(acc) if i else None, None if last else cuda.ptr(acc),
                cuda.ptr(dx) if last else None, n0, n1, *geometry,
                cuda.stream(xd.device)))
        assert torch.equal(dx.cpu(), want), passes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride,where", [
    (1, "relative"), (1, "absolute"), (2, "relative"), (2, "absolute")])
def test_deform_forward_one_hot_gives_the_samples(dev, dtype, stride, where):
    """Kernel 9's forward with one-hot weights (Co = 9 C) gives
    ``sample_plain``'s samples bit for bit on both routes (relative
    offsets in (-0.5, 0) at stride 1: route A; the rest route B) with
    coordinates in (-0.5, 0) that carry bits below 2^-8, where route B's
    bf16 fraction rounds."""
    from siammot_tpu_torch.ops.deform_conv import (_taps, in_window,
                                                   sample_plain,
                                                   window_route_possible)
    g = torch.Generator().manual_seed(22)
    b, h, w, c = 2, 24, 40, 16
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    off = -(torch.randint(1, 128, (b, ho, wo, 9, 2), generator=g) + 0.5) \
        / 256
    if where == "absolute":
        gy, gx = _taps(b, ho, wo, stride, 1, torch.device("cpu"))
        off = off - torch.stack(torch.broadcast_tensors(gy, gx), -1)
    off = off.reshape(b, ho, wo, 18).to(dev, dtype).contiguous()
    k = torch.eye(9 * c).reshape(3, 3, c, 9 * c).to(dev, dtype)
    route_a = window_route_possible(x.shape, k.shape, stride, 1,
                                    x.element_size()) and bool(in_window(off))
    assert route_a == (stride == 1 and where == "relative")
    got = deform_conv2d(x, off, k, stride).reshape(b, ho, wo, 9, c)
    assert torch.equal(got, sample_plain(x, off, stride, 1, route_a))


def test_deform_backward_memory_at_stage_3(dev):
    """A bf16 call at DLA-102's training stage-3 shape (4 x 92x160x128)
    allocates less than an [N, 9C] sample tensor beyond its outputs: S is
    never written, and dS lives half at a time."""
    g = torch.Generator().manual_seed(23)
    x = torch.randn(4, 92, 160, 128, generator=g).to(dev, torch.bfloat16)
    off = (0.35 * torch.randn(4, 92, 160, 18, generator=g)).to(
        dev, torch.bfloat16)
    k = (torch.randn(3, 3, 128, 128, generator=g) / 34.0).to(
        dev, torch.bfloat16)
    gr = torch.randn(4, 92, 160, 128, generator=g).to(dev, torch.bfloat16)
    deform_conv2d_bwd(x, off, k, gr, 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = deform_conv2d_bwd(x, off, k, gr, 1)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base \
        - sum(t.numel() * t.element_size() for t in got)
    assert extra < 4 * 92 * 160 * 9 * 128 * 2


def test_decode_kernel(dev):
    g = torch.Generator().manual_seed(6)
    k = 10
    u, window = _decode_constants(16, 16, str(dev))
    x4 = torch.stack([2 * torch.randn(k, 16, 16, generator=g),
                      torch.randn(k, 16, 16, generator=g),
                      60 + 20 * torch.randn(k, 16, 16, generator=g),
                      120 + 40 * torch.randn(k, 16, 16, generator=g)], 1)
    x4[1, 2] = 0.0       # a zero extent: 1/0 = inf, exp(-inf) = 0
    wh = torch.stack([40 + 110 * torch.rand(k, generator=g),
                      80 + 220 * torch.rand(k, generator=g)], -1)
    wh[2] = 0.0          # a zero template box is guarded, not divided by
    valid = _valid(k, 7)
    valid[1] = valid[2] = True
    args = (x4.to(dev).contiguous(), wh.to(dev), u, window, valid.to(dev),
            0.4, True)
    gi, gs = emm_decode(*args)
    wi, ws = emm_decode_plain(*args)
    torch.testing.assert_close(gi, wi, atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)
    assert (gi[~args[4]] == 0).all() and (gs[~args[4]] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_xcorr_unmasked_forward_and_gradients(dev, dtype):
    """Kernel 6 at the training shapes (30x30 search, 15x15 template; 160
    channels for a partial channel tile): forward against the plain
    version, both gradients against autograd through the plain version,
    each cast to its input's dtype."""
    g = torch.Generator().manual_seed(8)
    s = torch.randn(5, 30, 30, 160, generator=g).to(dev, dtype)
    t = torch.randn(5, 15, 15, 160, generator=g).to(dev, dtype)
    up = torch.randn(5, 16, 16, 160, generator=g).to(dev)
    torch.testing.assert_close(xcorr_depthwise(s, t),
                               xcorr_depthwise_plain(s, t), atol=1e-4,
                               rtol=1e-3)
    grads = []
    for fn in (xcorr_depthwise_auto, xcorr_depthwise_plain):
        si = s.clone().requires_grad_(True)
        ti = t.clone().requires_grad_(True)
        out = fn(si, ti)
        out.backward(up)
        grads.append((si.grad, ti.grad))
    (ks, kt), (ps, pt) = grads
    assert ks.dtype == dtype and kt.dtype == dtype
    # bf16 gradients: both round the same f32 sums, one ulp apart at most
    tol = dict(atol=1e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=8e-3)
    torch.testing.assert_close(ks.float(), ps.float(), **tol)
    torch.testing.assert_close(kt.float(), pt.float(), **tol)


def test_window_pool_backward_kernel_overlapping_windows(dev):
    """Kernel 7: 60 ROIs crowded into a small area (their windows overlap)
    and some at the table's edges, on an f32 table; against autograd
    through the plain pool, and through the differentiable pool."""
    g = torch.Generator().manual_seed(9)
    feats = [torch.randn(2, 64 // 2 ** i, 96 // 2 ** i, 128, generator=g)
             for i in range(4)]
    pack = pack_levels([f.to(dev) for f in feats], SCALES)
    n = 60
    xy = torch.rand(n, 2, generator=g) * torch.tensor([120.0, 80.0])
    wh = 16 + 200 * torch.rand(n, 2, generator=g)
    rois = torch.cat([xy, xy + wh], 1)
    rois[:6, 2:] = torch.tensor([383.0, 255.0])      # right/bottom edges
    rois[6:9, :2] = 0.0                              # top-left corner
    levels = map_rois_to_levels(rois, 2, 5).to(dev)
    img = (torch.arange(n) % 2).to(dev, torch.int32)
    block = img * 4 + levels
    scales = torch.tensor(SCALES, device=dev)[levels.long()]
    origins, wy, wx = window_geometry(pack.heights, pack.widths,
                                      pack.row_offsets, rois.to(dev), block,
                                      scales, 15, 2, 32, 0, 4)
    up = torch.randn(n, 15, 15, 128, generator=g).to(dev)
    shape = tuple(pack.table.shape)
    got = window_pool_bwd(up, origins, wy, wx, shape)
    want = window_pool_bwd_plain(up, origins, wy, wx, shape)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    table = pack.table.clone().requires_grad_(True)
    window_pool_train(table, origins, wy, wx).backward(up)
    torch.testing.assert_close(table.grad, want, atol=1e-4, rtol=1e-3)
    valid = _valid(n, 10).to(dev)           # dead ROIs add nothing
    torch.testing.assert_close(
        window_pool_bwd(up, origins, wy, wx, shape, valid),
        window_pool_bwd_plain(up, origins, wy, wx, shape, valid), atol=1e-4,
        rtol=1e-3)
    with pytest.raises(TypeError):
        window_pool_train(pack.table.to(torch.bfloat16), origins, wy, wx)


def _decode_args(dev, k, s, seed):
    g = torch.Generator().manual_seed(seed)
    u, window = _decode_constants(s, 16, str(dev))
    x4 = torch.stack([2 * torch.randn(k, s, s, generator=g),
                      torch.randn(k, s, s, generator=g),
                      60 + 20 * torch.randn(k, s, s, generator=g),
                      120 + 40 * torch.randn(k, s, s, generator=g)], 1)
    wh = torch.stack([40 + 110 * torch.rand(k, generator=g),
                      80 + 220 * torch.rand(k, generator=g)], -1)
    return x4.to(dev).contiguous(), wh.to(dev), u, window


def test_decode_unmasked_kernel(dev):
    """Kernel 10 at [128, 4, 16, 16], every slot decoded, a zero-extent
    slot among them: idx exact, scores 1e-5."""
    from siammot_tpu_torch.ops.decode import emm_decode_unmasked
    x4, wh, u, window = _decode_args(dev, 128, 16, 21)
    wh[5] = 0.0
    gi, gs = emm_decode_unmasked(x4, wh, u, window, 0.4, True)
    wi, ws = emm_decode_plain(x4, wh, u, window, None, 0.4, True)
    torch.testing.assert_close(gi, wi, atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,stripe,gated", [(61, 16, True), (61, 16, False),
                                            (46, 32, True), (33, 16, False)])
def test_decode_striped_kernel(dev, s, stripe, gated):
    """Kernel 5 at s_hi 976, 736 and 528 against its plain version: idx
    exact, scores 1e-5; gated dead slots (0, 0)."""
    from siammot_tpu_torch.ops.decode import (emm_decode_striped,
                                              emm_decode_striped_plain)
    x4, wh, u, window = _decode_args(dev, 6, s, 22 + s)
    valid = _valid(6, 23).to(dev) if gated else None
    gi, gs = emm_decode_striped(x4, wh, u, window, valid, 0.4, True, stripe)
    wi, ws = emm_decode_striped_plain(x4, wh, u, window, valid, 0.4, True,
                                      stripe)
    torch.testing.assert_close(gi, wi, atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)
    if gated:
        assert (gi[~valid] == 0).all() and (gs[~valid] == 0).all()


def test_decode_striped_kernel_is_bitwise_the_whole_map_kernel(dev):
    """A forced stripe (8, 16 and 64) at s_hi 256 and 464 gives bitwise
    the (idx, score) of kernels 4 (gated) and 10 (ungated)."""
    from siammot_tpu_torch.ops.decode import (emm_decode_striped,
                                              emm_decode_unmasked)
    for s, stripe in ((16, 64), (16, 16), (16, 8), (29, 16)):
        x4, wh, u, window = _decode_args(dev, 12, s, 24)
        valid = _valid(12, 25).to(dev)
        for v in (valid, None):
            si, ss = emm_decode_striped(x4, wh, u, window, v, 0.4, True,
                                        stripe)
            wi, ws = (emm_decode(x4, wh, u, window, v, 0.4, True)
                      if v is not None else
                      emm_decode_unmasked(x4, wh, u, window, 0.4, True))
            assert torch.equal(si, wi) and torch.equal(ss, ws), (s, stripe)


def _decode_case(dev, k, s, up, seed):
    """Seeded decode inputs at response side ``s`` and upsampling ``up``."""
    g = torch.Generator().manual_seed(seed)
    u, window = _decode_constants(s, up, str(dev))
    x4 = torch.stack([2 * torch.randn(k, s, s, generator=g),
                      torch.randn(k, s, s, generator=g),
                      60 + 20 * torch.randn(k, s, s, generator=g),
                      120 + 40 * torch.randn(k, s, s, generator=g)], 1)
    wh = torch.stack([40 + 110 * torch.rand(k, generator=g),
                      80 + 220 * torch.rand(k, generator=g)], -1)
    return x4.to(dev).contiguous(), wh.to(dev), u, window


def _decode_kernel_and_plain(x4, wh, u, window, valid, stripe=None):
    """(kernel, plain) (idx, score) of the entry point the arguments pick:
    kernel 5 with a stripe, else 4 (gated) or 10."""
    from siammot_tpu_torch.ops.decode import (emm_decode_striped,
                                              emm_decode_striped_plain,
                                              emm_decode_unmasked)
    if stripe is not None:
        return (emm_decode_striped(x4, wh, u, window, valid, 0.4, True,
                                   stripe),
                emm_decode_striped_plain(x4, wh, u, window, valid, 0.4,
                                         True, stripe))
    got = emm_decode(x4, wh, u, window, valid, 0.4, True) \
        if valid is not None else emm_decode_unmasked(x4, wh, u, window,
                                                      0.4, True)
    return got, emm_decode_plain(x4, wh, u, window, valid, 0.4, True)


@pytest.mark.parametrize("live", [0, 1, 37, 128])
@pytest.mark.parametrize("s,stripe", [(16, None), (61, 16)])
def test_decode_kernel_live_slots(dev, live, s, stripe):
    """Kernels 4 (s_hi 256) and 5 (s_hi 976) with 0, 1, 37 and all 128
    slots live, at random places (the kernel orders them live first):
    idx exact and scores 1e-5 against the plain version, dead slots
    (0, 0)."""
    k = 128
    x4, wh, u, window = _decode_case(dev, k, s, 16, 50 + live)
    valid = torch.zeros(k, dtype=torch.bool)
    valid[torch.randperm(k, generator=torch.Generator().manual_seed(live))
          [:live]] = True
    valid = valid.to(dev)
    (gi, gs), (wi, ws) = _decode_kernel_and_plain(x4, wh, u, window, valid,
                                                  stripe)
    assert (gi[~valid] == 0).all() and (gs[~valid] == 0).all()
    torch.testing.assert_close(gi, wi.to(gi.dtype), atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,up,stripe", [(16, 16, None), (29, 16, None),
                                         (46, 16, 32), (61, 16, 16),
                                         (13, 8, None), (33, 16, 16)])
@pytest.mark.parametrize("gated", [True, False])
def test_decode_kernel_sizes(dev, s, up, stripe, gated):
    """s_hi 256, 464, 736 and 976 (the compile-time forms and the generic
    one), 104 (a ragged last band of 16 rows) and 528 (a ragged last chunk
    of 256 columns and a ragged band of the old kernel), gated and
    ungated: idx exact and scores 1e-5 against the plain version."""
    k = 12
    x4, wh, u, window = _decode_case(dev, k, s, up, 60 + s)
    valid = _valid(k, 61).to(dev) if gated else None
    (gi, gs), (wi, ws) = _decode_kernel_and_plain(x4, wh, u, window, valid,
                                                  stripe)
    torch.testing.assert_close(gi, wi.to(gi.dtype), atol=0, rtol=0)
    torch.testing.assert_close(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,stripe", [(16, None), (61, 16)])
def test_decode_kernel_nan_and_ties_keep_the_first(dev, s, stripe):
    """Zero responses make every cell's confidence 0, so the map's value
    is sigma times the window: a window of ones ties every cell (index 0
    wins); a window of zeros with two ones (the lower flat index wins: it
    lies in the first band and the last chunk of columns, the other in a
    later band and the first chunk); the Hann window with two NaN cells
    (the first NaN wins).  Gated (kernel 4 or 5) and not (10 or 5),
    kernel and plain version both at the index named; the score is
    sigmoid(0)."""
    k = 3
    x4 = torch.zeros(k, 4, s, s, device=dev)
    wh = torch.full((k, 2), 50.0, device=dev)
    u, hann = _decode_constants(s, 16, str(dev))
    s_hi = 16 * s
    a, b = (5, s_hi - 6), (s_hi - 40, 17)      # a: earlier row, later column
    cells = (torch.tensor([b[0], a[0]], device=dev),
             torch.tensor([b[1], a[1]], device=dev))
    for window, want in (
            (torch.ones_like(hann), 0),
            (torch.zeros_like(hann).index_put_(cells, torch.ones(
                2, device=dev)), a[0] * s_hi + a[1]),
            (hann.clone().index_put_(cells, torch.full(
                (2,), float("nan"), device=dev)), a[0] * s_hi + a[1])):
        for valid in (torch.ones(k, dtype=torch.bool, device=dev), None):
            (gi, gs), (wi, ws) = _decode_kernel_and_plain(
                x4, wh, u, window.contiguous(), valid, stripe)
            assert (gi == want).all() and (wi == want).all(), (want, gi, wi)
            assert (gs == 0.5).all() and (ws == 0.5).all()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 1e-4)])
def test_predictor_blocked_kernel(dev, dtype, tol):
    """Kernel 8 at [32, 16, 16, 128] and [16, 29, 29, 64], B = 8: a block
    with no live slot, mixed blocks; against its plain version."""
    from siammot_tpu_torch.ops.predictor import (emm_predictor_blocked,
                                                 emm_predictor_blocked_plain)
    g = torch.Generator().manual_seed(26)
    for k, s, c in ((32, 16, 128), (16, 29, 64)):
        x = torch.randn(k, s, s, c, generator=g).to(dev, dtype)
        valid = torch.zeros(k, dtype=torch.bool)
        valid[torch.tensor([0, 3, 9, 10, 11, 12, 13, 14, 15])] = True
        params = {}
        for name in _NAMES:
            head = name.split(".")[0]
            n = {"cls": 2, "center": 1, "reg": 4}.get(head, c)
            if name.endswith("kernel"):
                t = torch.randn(3, 3, c, n, generator=g) * 0.03
            elif name.endswith("scale"):
                t = 1 + 0.1 * torch.randn(c, generator=g)
            else:
                t = 0.1 * torch.randn(n, generator=g)
            params[name] = t.to(dev, dtype).contiguous()
        args = (x, valid.to(dev), params, 8)
        for got, want in zip(emm_predictor_blocked(*args),
                             emm_predictor_blocked_plain(*args)):
            assert (got[~valid.to(dev)] == 0).all()
            torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,s,c,block", [(32, 16, 128, 2), (32, 16, 128, 8),
                                         (16, 29, 64, 2), (32, 61, 128, 8)])
def test_predictor_blocked_kernel_groups(dev, dtype, k, s, c, block):
    """Kernel 8 with groups of 2 and 8 slots, at 16x16, 29x29 and 61x61:
    the live slots at the front as the step's top-k leaves them, so some
    groups hold no live slot and one is mixed; against its plain version,
    dead slots exactly zero."""
    from siammot_tpu_torch.ops.predictor import (emm_predictor_blocked,
                                                 emm_predictor_blocked_plain)
    g = torch.Generator().manual_seed(k + s + block)
    params = _predictor_params(g, c, dtype, dev)
    x = torch.randn(k, s, s, c, generator=g).to(dev, dtype)
    valid = torch.zeros(k, dtype=torch.bool, device=dev)
    valid[:block + block // 2 + 1] = True
    args = (x, valid, params, block)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(emm_predictor_blocked(*args),
                         emm_predictor_blocked_plain(*args)):
        assert (got[~valid] == 0).all()
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_xcorr_kernels_at_the_wide_search_region(dev, dtype):
    """Kernels 2 and 6 (forward) at SEARCH_REGION 5's 75x75 x 15x15 ->
    61x61, four 16-wide segments an output row."""
    g = torch.Generator().manual_seed(27)
    k = 5
    search = torch.randn(k, 75, 75, 128, generator=g).to(dev, dtype)
    tmpl = (0.1 * torch.randn(k, 15, 15, 128, generator=g)).to(dev, dtype)
    valid = _valid(k, 28).to(dev)
    got = xcorr_depthwise_masked(search, tmpl, valid)
    want = xcorr_depthwise_plain(search, tmpl, valid)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    assert (got[~valid] == 0).all()
    torch.testing.assert_close(xcorr_depthwise(search, tmpl),
                               xcorr_depthwise_plain(search, tmpl),
                               atol=1e-4, rtol=1e-3)


_F32, _BF16 = torch.float32, torch.bfloat16


def _xcorr_passes(search, tmpl, up, with_search_grad=True):
    """(name, kernel output, plain output) of kernel 6's three passes; the
    template gradient's yardstick is the exact correlation rounded once
    (``xcorr_depthwise_exact``): its kernel's sums are near exact, where
    f32 sums in JAX's order stray past the tolerance on their own over
    SEARCH_REGION 5's 3721 taps
    (``tests/test_torch_xcorr_grad.py::test_plain_f32_sums_against_the_
    exact_correlation``)."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_exact,
                                             xcorr_grad_search,
                                             xcorr_grad_search_plain,
                                             xcorr_grad_template)
    out = [("forward", xcorr_depthwise(search, tmpl),
            xcorr_depthwise_plain(search, tmpl)),
           ("grad_template", xcorr_grad_template(search, up),
            xcorr_depthwise_exact(search, up))]
    if with_search_grad:
        out.append(("grad_search", xcorr_grad_search(up, tmpl),
                    xcorr_grad_search_plain(up, tmpl)))
    return out


@pytest.mark.parametrize("k", [0, 1, 6])
@pytest.mark.parametrize("c", [128, 160])
@pytest.mark.parametrize("sdt,tdt", [(_F32, _F32), (_BF16, _BF16),
                                     (_BF16, _F32), (_F32, _BF16)])
def test_xcorr_unmasked_passes(dev, k, c, sdt, tdt):
    """Kernel 6's three passes at the training shapes (30x30 search,
    15x15 template, 16x16 upstream gradient), each against its plain
    version: the forward with search in ``sdt`` and template in ``tdt``,
    the template gradient (search with the f32 gradient) and the search
    gradient (the f32 gradient with the template) -- bf16/bf16 is the
    bf16 step's mix.  No slot (K = 0), one, and six; 160 channels for a
    fifth tile of 32."""
    g = torch.Generator().manual_seed(30 + k)
    search = torch.randn(k, 30, 30, c, generator=g).to(dev, sdt)
    tmpl = (0.1 * torch.randn(k, 15, 15, c, generator=g)).to(dev, tdt)
    up = torch.randn(k, 16, 16, c, generator=g).to(dev)
    for name, got, want in _xcorr_passes(search, tmpl, up):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("hs,ws,ht,wt", [(20, 24, 7, 5), (29, 29, 7, 7),
                                         (9, 40, 9, 3), (75, 75, 15, 15)])
@pytest.mark.parametrize("c", [128, 20])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_xcorr_unmasked_other_shapes(dev, hs, ws, ht, wt, c, dtype):
    """Kernel 6 at widths without a compile-time form (its generic
    instantiation), 20 channels (element copies, a partial tile), and at
    SEARCH_REGION 5's 75x75 x 15x15 -> 61x61, where the template gradient
    (61x61 taps) runs on the tensor cores like every template gradient;
    search gradients wider or taller than 32 (9x40, 75x75) run in bands
    of output rows and column segments."""
    g = torch.Generator().manual_seed(hs * ws + c)
    search = torch.randn(3, hs, ws, c, generator=g).to(dev, dtype)
    tmpl = (0.1 * torch.randn(3, ht, wt, c, generator=g)).to(dev, dtype)
    up = torch.randn(3, hs - ht + 1, ws - wt + 1, c, generator=g).to(dev)
    for name, got, want in _xcorr_passes(search, tmpl, up):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_xcorr_passes_at_the_wide_search_region(dev, dtype):
    """Kernel 6's three passes at SEARCH_REGION 5's 75x75 x 15x15 ->
    61x61, search and template in ``dtype`` and the f32 upstream gradient
    (a training step's mix): the template gradient's 3721 taps on the
    tensor cores, the search gradient's 75x75 output in bands of 32 output
    rows and five 16-wide column segments."""
    g = torch.Generator().manual_seed(41)
    search = torch.randn(4, 75, 75, 128, generator=g).to(dev, dtype)
    tmpl = (0.1 * torch.randn(4, 15, 15, 128, generator=g)).to(dev, dtype)
    up = torch.randn(4, 61, 61, 128, generator=g).to(dev)
    for name, got, want in _xcorr_passes(search, tmpl, up):
        assert got.shape == want.shape, name
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("hg,ht,gdt,tdt", [(31, 15, _F32, _F32),
                                           (31, 15, _F32, _BF16),
                                           (29, 7, _F32, _F32),
                                           (29, 7, _F32, _BF16),
                                           (29, 7, _BF16, _BF16),
                                           (61, 15, _BF16, _BF16)])
def test_xcorr_grad_search_past_32(dev, hg, ht, gdt, tdt):
    """The search gradient at SEARCH_REGION 3's 45x45 (15x15 taps), the
    AOT recipe's 35x35 (7x7 taps) and 75x75, the gradient in ``gdt`` and
    the template in ``tdt`` (bf16 both: 16-channel tiles, bands of 16
    rows), against the plain version; the training shape's plan is still
    one band."""
    from siammot_tpu_torch.ops.xcorr import (_smem_limit, grad_search_plan,
                                             xcorr_grad_search,
                                             xcorr_grad_search_plain)
    assert grad_search_plan(16, 16, 15, 15, 4, 2,
                            _smem_limit(torch.cuda.current_device())) \
        == (30, 1)
    g = torch.Generator().manual_seed(hg + ht)
    up = torch.randn(5, hg, hg, 128, generator=g).to(dev, gdt)
    tmpl = (0.1 * torch.randn(5, ht, ht, 128, generator=g)).to(dev, tdt)
    got = xcorr_grad_search(up, tmpl)
    assert got.shape == (5, hg + ht - 1, hg + ht - 1, 128)
    torch.testing.assert_close(got, xcorr_grad_search_plain(up, tmpl),
                               atol=1e-4, rtol=1e-3)


# kernel 6's template gradient on the tensor cores (cuda/xcorr_grad.cu):
# search [K, hs, ws, C], upstream gradient [K, hg, wg, C]
_GT_SHAPES = [(35, 35, 29, 29),    # the AOT recipe
              (75, 75, 61, 61),    # SEARCH_REGION 5
              (30, 30, 16, 16),    # the default training shape
              (20, 24, 14, 20), (29, 29, 23, 23), (9, 40, 1, 38),
              (40, 40, 21, 21),    # POOLER_RESOLUTION 20: two row blocks
              (100, 100, 81, 81),  # ... at SEARCH_REGION 5
              (60, 40, 19, 9)]     # 42x32: three row blocks, 32 wide


@pytest.mark.parametrize("hs,ws,hg,wg", _GT_SHAPES)
@pytest.mark.parametrize("sdt,gdt", [(_BF16, _F32), (_F32, _F32),
                                     (_BF16, _BF16), (_F32, _BF16)])
@pytest.mark.parametrize("c,k", [(128, 3), (20, 3), (256, 1), (128, 0)])
def test_xcorr_grad_template_kernel(dev, hs, ws, hg, wg, sdt, gdt, c, k):
    """The template gradient's tensor-core kernel against
    ``xcorr_depthwise_exact`` (the exact correlation rounded once; see
    :func:`_xcorr_passes`) at the AOT recipe's, SEARCH_REGION 5's, the
    default (where the wrapper routes to ``xcorr6_kernel``), three generic
    shapes and outputs past 16x16 (row blocks, four n8 tiles), the search
    and the upstream gradient each in f32 or bf16 (f32 inputs split into
    three bf16 terms), 128, 20 (element copies, a partial channel tile)
    and 256 channels, 3, 1 and 0 slots; f32 sums in another order -> atol
    1e-4, rtol 1e-3."""
    from siammot_tpu_torch.ops.xcorr import (_grad_template_mma,
                                             xcorr_depthwise_exact)
    g = torch.Generator().manual_seed(hs * ws + hg + c + k)
    search = torch.randn(k, hs, ws, c, generator=g).to(dev, sdt)
    up = torch.randn(k, hg, wg, c, generator=g).to(dev, gdt)
    got = _grad_template_mma(search, up)
    want = xcorr_depthwise_exact(search, up)
    assert got.shape == (k, hs - hg + 1, ws - wg + 1, c)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("hs,hg,sdt", [(75, 61, _BF16), (75, 61, _F32),
                                       (35, 29, _BF16), (30, 16, _BF16),
                                       (40, 21, _BF16)])
def test_xcorr_grad_template_same_bits(dev, hs, hg, sdt):
    """The template gradient has no atomics and a fixed summation order:
    two launches give the same bits, at SEARCH_REGION 5's, the AOT
    recipe's, the default and POOLER_RESOLUTION 20's shapes, over more
    items than the persistent grid has blocks."""
    from siammot_tpu_torch.ops.xcorr import _grad_template_mma
    g = torch.Generator().manual_seed(hs + hg)
    search = torch.randn(96, hs, hs, 128, generator=g).to(dev, sdt)
    up = torch.randn(96, hg, hg, 128, generator=g).to(dev)
    first = _grad_template_mma(search, up)
    assert torch.equal(first, _grad_template_mma(search, up))


def test_xcorr_grad_template_limits(dev):
    """An output past 32 wide raises with the kernel's limit."""
    from siammot_tpu_torch.ops.xcorr import xcorr_grad_template
    search = torch.zeros(1, 40, 60, 8, device=dev)
    with pytest.raises(ValueError, match="32 wide"):
        xcorr_grad_template(search, torch.zeros(1, 23, 23, 8, device=dev))


def _pool_case(dev, s, window, pad, dtype, c, seed):
    """A 4-level table of a 256x384 image and 24 ROIs (some crossing the
    image's edges and corners) pooled at S, window and virtual pad."""
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(1, 64 // 2 ** i, 96 // 2 ** i, c, generator=g)
             for i in range(4)]
    pack = pack_levels([f.to(dev) for f in feats], SCALES, dtype=dtype)
    n = 24
    xy = torch.rand(n, 2, generator=g) * torch.tensor([384.0, 256.0])
    rois = torch.cat([xy, xy + 8 + 150 * torch.rand(n, 2, generator=g)], 1)
    rois[0] = torch.tensor([-20.0, -30.0, 40.0, 50.0])       # top-left
    rois[1] = torch.tensor([350.0, 220.0, 420.0, 290.0])     # bottom-right
    rois[2] = torch.tensor([0.0, 100.0, 383.0, 140.0])       # full width
    rois[3] = torch.tensor([300.0, 0.0, 383.0, 255.0])       # right edge
    rois[4] = torch.tensor([0.0, 0.0, 383.0, 255.0])         # whole image
    levels = map_rois_to_levels(rois, 2, 5).to(dev)
    scales = torch.tensor(SCALES, device=dev)[levels.long()]
    return pack.table, window_geometry(       # rois in padded coordinates
        pack.heights, pack.widths, pack.row_offsets, (rois + pad).to(dev),
        levels,
        scales, s, 2, window, pad, 4)


@pytest.mark.parametrize("s,window,pad", [(7, 64, 0), (15, 64, 0),
                                          (30, 128, 512)])
@pytest.mark.parametrize("dtype", [_BF16, _F32])
@pytest.mark.parametrize("live", ["some", "none", "all", "null"])
@pytest.mark.parametrize("c", [128, 64])
def test_window_pool_kernel_sites(dev, s, window, pad, dtype, live, c):
    """Kernel 1 at the three pool sites' S and windows (box 7/64, template
    15/64, search region 30/128 with its virtual pad), bf16 and f32
    tables, 128 and 64 channels, ROIs at the table's edges and corners;
    ``valid`` with some, no and every ROI live, and None (every ROI live,
    the training forward)."""
    table, (origins, wy, wx) = _pool_case(dev, s, window, pad, dtype, c,
                                          seed=s + c)
    n = wy.shape[0]
    valid = {"some": _valid(n, 40).to(dev),
             "none": torch.zeros(n, dtype=torch.bool, device=dev),
             "all": torch.ones(n, dtype=torch.bool, device=dev),
             "null": None}[live]
    got = window_pool(table, origins, wy, wx, valid)
    want = window_pool_plain(table, origins, wy, wx, valid)
    if valid is not None:
        assert (got[~valid] == 0).all()
    assert want.abs().max() > 0 or live == "none"
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("hs,ws,ht,wt,c", [(30, 30, 15, 15, 128),
                                           (75, 75, 15, 15, 128),
                                           (35, 35, 7, 7, 128),
                                           (20, 44, 9, 16, 20)])
@pytest.mark.parametrize("live", [0, 1, 37, 128])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_xcorr_masked_runs_kernel_6(dev, hs, ws, ht, wt, c, live, dtype):
    """Kernel 2 on kernel 6's kernel, 128 slots with 0, 1, 37 and all
    live: the default 30x30 x 15x15 -> 16x16, SEARCH_REGION 5's 75 -> 61
    (four 16-wide segments a row), a 7x7 template (the generic form) and a
    16-wide one over 20 channels (15-wide segments, element copies).
    Against the plain version; dead slots exact zeros; live slots bitwise
    the unmasked kernel's output on the same inputs."""
    g = torch.Generator().manual_seed(hs * ws + ht + live)
    k = 128
    search = torch.randn(k, hs, ws, c, generator=g).to(dev, dtype)
    tmpl = (0.1 * torch.randn(k, ht, wt, c, generator=g)).to(dev, dtype)
    valid = torch.zeros(k, dtype=torch.bool)
    valid[torch.randperm(k, generator=g)[:live]] = True
    valid = valid.to(dev)
    got = xcorr_depthwise_masked(search, tmpl, valid)
    want = xcorr_depthwise_plain(search, tmpl, valid)
    assert (got[~valid] == 0).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    assert torch.equal(got[valid], xcorr_depthwise(search, tmpl)[valid])


@pytest.mark.parametrize("s,window,pad", [(7, 64, 0), (15, 64, 0),
                                          (30, 128, 512)])
@pytest.mark.parametrize("c", [128, 20])
def test_window_pool_bwd_kernel_sites(dev, s, window, pad, c):
    """Kernel 7 at the three training sites' S, window and virtual pad,
    ROIs at the table's edges and corners, 128 channels (16-byte loads)
    and 20 (element loads): against the plain version; a second launch
    bitwise the same; with ``valid``, bitwise the gradient of the live
    ROIs alone (dead ROIs add nothing, the live ones keep their order)."""
    table, (origins, wy, wx) = _pool_case(dev, s, window, pad, _F32, c,
                                          seed=60 + s + c)
    shape = tuple(table.shape)
    n = wy.shape[0]
    g = torch.Generator().manual_seed(61 + s)
    up = torch.randn(n, s, s, c, generator=g).to(dev)
    got = window_pool_bwd(up, origins, wy, wx, shape)
    want = window_pool_bwd_plain(up, origins, wy, wx, shape)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    assert torch.equal(got, window_pool_bwd(up, origins, wy, wx, shape))
    valid = _valid(n, 62).to(dev)
    masked = window_pool_bwd(up, origins, wy, wx, shape, valid)
    torch.testing.assert_close(
        masked, window_pool_bwd_plain(up, origins, wy, wx, shape, valid),
        atol=1e-4, rtol=1e-3)
    live = valid.nonzero()[:, 0]
    assert torch.equal(masked, window_pool_bwd(
        up[live].contiguous(), origins[live].contiguous(),
        wy[live].contiguous(), wx[live].contiguous(), shape))


def test_window_pool_bwd_kernel_crowded_tile(dev):
    """Kernel 7 with 300 ROIs stacked over one spot of level 0, so that
    one table tile lies under more ROIs than one 32-ROI word of its mask
    holds: against the plain version, and bitwise repeatable."""
    from siammot_tpu_torch.ops.window_pool import tile_counts, touched_rects
    g = torch.Generator().manual_seed(63)
    feats = [torch.randn(1, 64 // 2 ** i, 96 // 2 ** i, 128, generator=g)
             for i in range(4)]
    pack = pack_levels([f.to(dev) for f in feats], SCALES)
    n = 300
    xy = torch.tensor([100.0, 80.0]) + 20 * torch.rand(n, 2, generator=g)
    rois = torch.cat([xy, xy + 30 + 60 * torch.rand(n, 2, generator=g)], 1)
    levels = map_rois_to_levels(rois, 2, 5).to(dev)
    scales = torch.tensor(SCALES, device=dev)[levels.long()]
    origins, wy, wx = window_geometry(pack.heights, pack.widths,
                                      pack.row_offsets, rois.to(dev), levels,
                                      scales, 15, 2, 64, 0, 4)
    shape = tuple(pack.table.shape)
    counts = tile_counts(touched_rects(origins, wy, wx, shape), shape)
    assert counts.max() > 96
    up = torch.randn(n, 15, 15, 128, generator=g).to(dev)
    got = window_pool_bwd(up, origins, wy, wx, shape)
    torch.testing.assert_close(
        got, window_pool_bwd_plain(up, origins, wy, wx, shape), atol=1e-4,
        rtol=1e-3)
    assert torch.equal(got, window_pool_bwd(up, origins, wy, wx, shape))


def test_window_pool_bwd_kernel_unstaged_rois(dev):
    """Kernel 7 at the search-region site's S (30) with ROIs a few table
    cells wide, whose bins are much smaller than a cell: each tile meets
    all 30 x 30 bins of such a ROI, more than a shared-memory stage holds,
    so the gather reads them from global memory.  Against the plain
    version, bitwise repeatable."""
    g = torch.Generator().manual_seed(64)
    feats = [torch.randn(1, 64 // 2 ** i, 96 // 2 ** i, 128, generator=g)
             for i in range(4)]
    pack = pack_levels([f.to(dev) for f in feats], SCALES)
    n = 40
    xy = torch.rand(n, 2, generator=g) * torch.tensor([300.0, 200.0])
    rois = torch.cat([xy, xy + 4 + 8 * torch.rand(n, 2, generator=g)], 1)
    rois[n // 2:, 2:] = rois[n // 2:, :2] + 80       # and some larger ones
    levels = map_rois_to_levels(rois, 2, 5).to(dev)
    scales = torch.tensor(SCALES, device=dev)[levels.long()]
    origins, wy, wx = window_geometry(pack.heights, pack.widths,
                                      pack.row_offsets, rois.to(dev), levels,
                                      scales, 30, 2, 32, 0, 4)
    shape = tuple(pack.table.shape)
    assert ((wy[:n // 2] != 0).any(2).all()
            and (wx[:n // 2] != 0).any(2).all())  # every bin in the window
    up = torch.randn(n, 30, 30, 128, generator=g).to(dev)
    got = window_pool_bwd(up, origins, wy, wx, shape)
    torch.testing.assert_close(
        got, window_pool_bwd_plain(up, origins, wy, wx, shape), atol=1e-4,
        rtol=1e-3)
    assert torch.equal(got, window_pool_bwd(up, origins, wy, wx, shape))


@pytest.mark.parametrize("live", [0, 1, 37, 128])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_xcorr_past_64_wide(dev, live, dtype):
    """Kernels 2 and 6 at SEARCH_REGION 5.5's 82x82 x 15x15 -> 68x68 (five
    16-wide segments a row, the last one past the output): against the
    plain version, dead slots zero, live slots bitwise kernel 6's."""
    g = torch.Generator().manual_seed(68 + live)
    k = 128
    search = torch.randn(k, 82, 82, 128, generator=g).to(dev, dtype)
    tmpl = (0.1 * torch.randn(k, 15, 15, 128, generator=g)).to(dev, dtype)
    valid = torch.zeros(k, dtype=torch.bool)
    valid[torch.randperm(k, generator=g)[:live]] = True
    valid = valid.to(dev)
    got = xcorr_depthwise_masked(search, tmpl, valid)
    assert got.shape == (k, 68, 68, 128) and (got[~valid] == 0).all()
    torch.testing.assert_close(got, xcorr_depthwise_plain(search, tmpl, valid),
                               atol=1e-4, rtol=1e-3)
    assert torch.equal(got[valid], xcorr_depthwise(search, tmpl)[valid])


def _roi_table(g, dev, dtype, c, images=2):
    from siammot_tpu_torch.ops.roi_align import level_table
    return level_table([torch.randn(images, 48 // 2 ** i, 80 // 2 ** i, c,
                                    generator=g).to(dev, dtype)
                        for i in range(4)], SCALES)


def _roi_args(g, table, n, o, pad, valid):
    """``roi_align_fwd``'s arguments for n ROIs over a 320x192 frame
    (padded coordinates where ``pad``), some past the map's edges."""
    dev = table.table.device
    sz = 4 + 150 * torch.rand(n, 2, generator=g)
    xy = torch.rand(n, 2, generator=g) * 340 - 10 + pad
    rois = torch.cat([xy, xy + sz], 1)
    img = torch.randint(0, table.images, (n,), generator=g)
    levels = map_rois_to_levels(rois - pad, 2, 5)
    geom, scale = table.geometry(img.to(dev), levels.to(dev), pad)
    return (table.table, rois.to(dev), geom, scale, o, 2,
            None if valid is None else valid.to(dev))


_ROI_ATOL = {_F32: 1e-5, _BF16: 2.0 ** -7}


@pytest.mark.parametrize("o,pad", [(7, 0), (15, 0), (30, 512), (35, 256)])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("live", ["some", "none", "null"])
@pytest.mark.parametrize("c", [128, 20])
def test_roi_align_kernel_sites(dev, o, pad, dtype, live, c):
    """The gather pooler's forward at each site's size and pad: against
    the plain version within 1e-5 (f32) or one bf16 ulp (2^-7) of the
    output's scale; rows not ``valid`` exactly zero."""
    from siammot_tpu_torch.ops.roi_align import roi_align_fwd, roi_align_plain
    g = torch.Generator().manual_seed(o * 7 + pad + c)
    n = 48
    valid = {"some": torch.rand(n, generator=g) < 0.6,
             "none": torch.zeros(n, dtype=torch.bool), "null": None}[live]
    args = _roi_args(g, _roi_table(g, dev, dtype, c), n, o, pad, valid)
    got = roi_align_fwd(*args)
    want = roi_align_plain(*args)
    assert got.dtype == dtype and got.shape == (n, o, o, c)
    if valid is not None:
        assert (got[~args[6]] == 0).all()
    scale = float(want.float().abs().max()) if live != "none" else 1.0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ROI_ATOL[dtype] * scale)


@pytest.mark.parametrize("o,pad", [(7, 0), (35, 256)])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_roi_align_bwd_kernel(dev, o, pad, dtype):
    """The gather pooler's backward (a gather in a fixed order, no
    atomics) against its plain version: its f32 sums within 1e-4 of the
    gradient's scale, its output in the table's dtype those sums rounded
    bit for bit; and the autograd Function's gradient in the maps against
    autograd through the plain forward in f32."""
    from siammot_tpu_torch.ops.roi_align import (roi_align_bwd,
                                                 roi_align_bwd_plain,
                                                 roi_align_plain,
                                                 roi_align_rows)
    g = torch.Generator().manual_seed(o + pad)
    n = 64
    table = _roi_table(g, dev, dtype, 128)
    args = _roi_args(g, table, n, o, pad, None)
    up = torch.randn(n, o, o, 128, generator=g).to(dev, dtype)
    bargs = (up, *args[1:4], tuple(table.table.shape), o, 2, table.layout)
    got = roi_align_bwd(*bargs)
    got32 = roi_align_bwd(*bargs, dtype=_F32)
    want = roi_align_bwd_plain(*bargs[:7])
    assert got.dtype == dtype
    assert torch.equal(got, got32.to(dtype))
    torch.testing.assert_close(got32, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    if dtype == _F32:
        t = table.table.clone().requires_grad_(True)
        roi_align_rows(t, *args[1:6], None, table.layout).backward(up)
        t2 = table.table.clone().requires_grad_(True)
        roi_align_plain(t2, *args[1:6]).backward(up)
        torch.testing.assert_close(t.grad, t2.grad, rtol=0,
                                   atol=1e-4 * float(t2.grad.abs().max()))


@pytest.mark.parametrize("o,pad", [(7, 0), (15, 0), (35, 256)])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("c", [128, 20])
def test_roi_align_bwd_kernel_in_its_order(dev, o, pad, dtype, c):
    """The backward bitwise its plain form summed in the kernel's order
    (``roi_align_bwd_ordered``: ROIs in order, then each ROI's bins and
    their samples), in the table's dtype, the same bits from call to
    call; the 16-byte and the scalar (C = 20) routes."""
    from siammot_tpu_torch.ops.roi_align import (roi_align_bwd,
                                                 roi_align_bwd_ordered)
    g = torch.Generator().manual_seed(o * 3 + pad + c)
    n = 24
    table = _roi_table(g, dev, dtype, c)
    args = _roi_args(g, table, n, o, pad, None)
    up = torch.randn(n, o, o, c, generator=g).to(dev, dtype)
    bargs = (up, *args[1:4], tuple(table.table.shape), o, 2, table.layout)
    got = roi_align_bwd(*bargs)
    assert got.dtype == dtype
    assert torch.equal(got, roi_align_bwd(*bargs))
    assert torch.equal(got, roi_align_bwd_ordered(*bargs))


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_roi_align_bwd_kernel_writes_every_row(dev, dtype):
    """Every element of the table gradient is written: after a NaN-filled
    block of the gradient's size is freed (the caching allocator hands it
    back), the rows no ROI reaches are exactly 0 and nothing is NaN."""
    from siammot_tpu_torch.ops.roi_align import (roi_align_bwd,
                                                 roi_align_bwd_plain)
    g = torch.Generator().manual_seed(3)
    n, o = 16, 7
    table = _roi_table(g, dev, dtype, 128)
    args = _roi_args(g, table, n, o, 0, None)
    up = torch.randn(n, o, o, 128, generator=g).to(dev, dtype)
    bargs = (up, *args[1:4], tuple(table.table.shape), o, 2, table.layout)
    want = roi_align_bwd_plain(*bargs[:7])
    nan = torch.full(tuple(table.table.shape), float("nan"), dtype=dtype,
                     device=dev)
    ptr = nan.data_ptr()
    del nan
    got = roi_align_bwd(*bargs)
    assert got.data_ptr() == ptr
    assert not torch.isnan(got).any()
    untouched = (want == 0).all(1)
    assert untouched.sum() > table.table.shape[0] // 2
    assert (got[untouched] == 0).all()


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("o,pad", [(7, 0), (35, 256)])
def test_roi_align_bwd_kernel_piled_up(dev, dtype, o, pad):
    """Hundreds of ROIs on one spot (as a training step's pairs pile up
    around a few objects): the backward's f32 sums within 1e-4 of the
    plain gradient's scale, two calls bitwise alike and bitwise the
    ordered form (its long lists cut into chunks)."""
    from siammot_tpu_torch.ops.roi_align import (roi_align_bwd,
                                                 roi_align_bwd_ordered,
                                                 roi_align_bwd_plain)
    g = torch.Generator().manual_seed(o + 1)
    n = 600
    table = _roi_table(g, dev, dtype, 128, images=1)
    centre = torch.tensor([150.0, 90.0, 190.0, 130.0]) + pad
    rois = (centre + 6 * torch.randn(n, 4, generator=g)).to(dev)
    levels = torch.zeros(n, dtype=torch.int32, device=dev)
    geom, scale = table.geometry(None, levels, pad)
    up = torch.randn(n, o, o, 128, generator=g).to(dev, dtype)
    bargs = (up, rois, geom, scale, tuple(table.table.shape), o, 2,
             table.layout)
    got = roi_align_bwd(*bargs)
    assert torch.equal(got, roi_align_bwd(*bargs))
    got32 = roi_align_bwd(*bargs, dtype=_F32)
    assert torch.equal(got, got32.to(dtype))
    want = roi_align_bwd_plain(*bargs[:7])
    torch.testing.assert_close(got32, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(got, roi_align_bwd_ordered(*bargs))


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("q", [32, 64, None])
def test_roi_align_bwd_kernel_long_lists_in_chunks(dev, dtype, q,
                                                   monkeypatch):
    """Long tile lists cut into chunks of 32 or 64 ROIs (as many partial
    slots as that takes), or not cut (no slots): bitwise the ordered form
    with the same slots, the same bits from call to call, the f32 sums
    within 1e-4 of the plain gradient's scale."""
    import siammot_tpu_torch.ops.roi_align as ra
    g = torch.Generator().manual_seed(77)
    n, o = 300, 7
    table = _roi_table(g, dev, dtype, 128, images=1)
    rois = (torch.tensor([150.0, 90.0, 190.0, 130.0])
            + 6 * torch.randn(n, 4, generator=g)).to(dev)
    levels = torch.zeros(n, dtype=torch.int32, device=dev)
    geom, scale = table.geometry(None, levels, 0)
    up = torch.randn(n, o, o, 128, generator=g).to(dev, dtype)
    bargs = (up, rois, geom, scale, tuple(table.table.shape), o, 2,
             table.layout)
    on, _ = ra.bwd_tile_lists(*bargs[1:4], o, 2, table.layout)
    lengths = on.sum(1)
    parts = 0 if q is None else int(sum(-(-int(m) // q) for m in lengths
                                        if m > q))
    if q is not None:
        assert parts > 0 and ra.bwd_chunk_size(lengths, parts) == q
    monkeypatch.setattr(ra, "BWD_PARTS", parts)
    got = ra.roi_align_bwd(*bargs)
    assert torch.equal(got, ra.roi_align_bwd(*bargs))
    assert torch.equal(got, ra.roi_align_bwd_ordered(*bargs))
    got32 = ra.roi_align_bwd(*bargs, dtype=_F32)
    want = ra.roi_align_bwd_plain(*bargs[:7])
    torch.testing.assert_close(got32, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_roi_align_kernel_past_the_staged_shared_memory(dev, dtype):
    """64 x 64 outputs at a sampling ratio of 4: the staged forward's
    block would pass the 227 KB a block may hold, so the call takes the
    unstaged kernel; against the plain version as at every site."""
    from siammot_tpu_torch.ops.roi_align import roi_align_fwd, roi_align_plain
    g = torch.Generator().manual_seed(64)
    args = _roi_args(g, _roi_table(g, dev, dtype, 128), 6, 64, 0, None)
    args = args[:5] + (4, None)
    got = roi_align_fwd(*args)
    want = roi_align_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ROI_ATOL[dtype]
                               * float(want.float().abs().max()))


def test_roi_align_bwd_kernel_at_its_most_rois(dev):
    """``BWD_MAX_ROIS`` ROIs (a tile's list fills the shared memory a
    block may opt in to) launch and match the plain version; one more is
    the wrapper's ValueError."""
    from siammot_tpu_torch.ops.roi_align import (BWD_MAX_ROIS, roi_align_bwd,
                                                 roi_align_bwd_plain)
    g = torch.Generator().manual_seed(5)
    n, o = BWD_MAX_ROIS, 2
    table = _roi_table(g, dev, _F32, 4, images=1)
    xy = torch.rand(n, 2, generator=g) * 300
    rois = torch.cat([xy, xy + 8 + 8 * torch.rand(n, 2, generator=g)],
                     1).to(dev)
    levels = torch.zeros(n, dtype=torch.int32, device=dev)
    geom, scale = table.geometry(None, levels, 0)
    up = torch.randn(n, o, o, 4, generator=g).to(dev)
    bargs = (up, rois, geom, scale, tuple(table.table.shape), o, 2,
             table.layout)
    got = roi_align_bwd(*bargs)
    want = roi_align_bwd_plain(*bargs[:7])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    more = (torch.cat([up, up[:1]]), torch.cat([rois, rois[:1]]),
            torch.cat([geom, geom[:1]]), torch.cat([scale, scale[:1]]))
    with pytest.raises(ValueError, match="ROIs"):
        roi_align_bwd(*more, *bargs[4:])


def roi_fwd_digest(dev, o, pad, dtype, c):
    """The gather forward's output bits on a seeded case at one site's
    size and pad (48 ROIs, some dead): sha256 of the bytes, 16 hex
    digits."""
    import hashlib
    from siammot_tpu_torch.ops.roi_align import roi_align_fwd
    g = torch.Generator().manual_seed(1000 + o * 7 + pad + c)
    n = 48
    valid = torch.rand(n, generator=g) < 0.6
    args = _roi_args(g, _roi_table(g, dev, dtype, c), n, o, pad, valid)
    out = roi_align_fwd(*args).contiguous().cpu()
    if dtype == _BF16:
        out = out.view(torch.int16)
    return hashlib.sha256(out.numpy().tobytes()).hexdigest()[:16]


# the forward's bits at each site as the kernel's first version (a thread
# an output column, its corners loaded from global memory) gave them:
# (o, pad, dtype, C) -> roi_fwd_digest
_ROI_FWD_DIGESTS = {
    (7, 0, _F32, 128): "086a87e2a79b03e2",
    (7, 0, _F32, 20): "bf628ffa0c7ffac6",
    (7, 0, _BF16, 128): "31815b037a33fb61",
    (7, 0, _BF16, 20): "7715ff2ad72979bd",
    (15, 0, _F32, 128): "53f2395458491163",
    (15, 0, _F32, 20): "b61cc16242ae82c4",
    (15, 0, _BF16, 128): "30ccf8fbc7f5fc69",
    (15, 0, _BF16, 20): "f73889528c51a1eb",
    (30, 512, _F32, 128): "4cf96984a94fdc8b",
    (30, 512, _F32, 20): "86401236a7131b94",
    (30, 512, _BF16, 128): "80283ef2f85dcd2d",
    (30, 512, _BF16, 20): "c55bc096be76f4d2",
    (35, 256, _F32, 128): "b80dc98d07c03d92",
    (35, 256, _F32, 20): "a0b82e42ff763f96",
    (35, 256, _BF16, 128): "a831587af87f088a",
    (35, 256, _BF16, 20): "4cd4003a61ed72da",
}


@pytest.mark.parametrize("key", sorted(_ROI_FWD_DIGESTS, key=str))
def test_roi_align_kernel_digest(dev, key):
    """The forward's output bit for bit the first version's at each
    site's size and pad, both dtypes and routes."""
    o, pad, dtype, c = key
    assert roi_fwd_digest(dev, o, pad, dtype, c) == _ROI_FWD_DIGESTS[key]


@pytest.mark.parametrize("case", [(1280, 720, 10, "left"),
                                  (1280, 720, 12, "center"),
                                  (200, 121, 10, "left"), (64, 9, 12, "top")])
def test_p016_to_rgb_kernel(dev, case):
    """The P016 conversion kernel bitwise its plain version on random
    words (the samples in the top bits), at each chroma siting."""
    from siammot_tpu_torch.data import nvdec
    w, h, depth, where = case
    siting = {"left": nvdec.SITING_LEFT, "center": nvdec.SITING_CENTER,
              "top": (0, 0)}[where]
    rng = np.random.RandomState(w + h + depth)
    words = rng.randint(0, 1 << 16, (nvdec.nv12_rows(h), w + 64)) \
        & ~((1 << (16 - depth)) - 1)
    frame = torch.from_numpy(words.astype(np.uint16).view(np.int16))
    got = nvdec.p016_to_rgb(frame.to(dev), w, h, depth, siting)
    assert torch.equal(got.cpu(), nvdec.p016_to_rgb_plain(frame, w, h, depth,
                                                          siting))


@pytest.mark.parametrize("case", [(1280, 720, 8), (1280, 720, 10),
                                  (1280, 720, 12), (101, 7, 10)])
def test_yuv444_to_rgb_kernel(dev, case):
    """The YUV444 conversion kernel bitwise its plain version on random
    bytes or words, swscale's 32-bit wrap included."""
    from siammot_tpu_torch.data import nvdec
    w, h, depth = case
    rng = np.random.RandomState(w + h + depth)
    rows = nvdec.yuv444_rows(h)
    if depth == 8:
        frame = torch.from_numpy(rng.randint(0, 256, (rows, w + 3))
                                 .astype(np.uint8))
    else:
        words = rng.randint(0, 1 << 16, (rows, w + 3)) \
            & ~((1 << (16 - depth)) - 1)
        frame = torch.from_numpy(words.astype(np.uint16).view(np.int16))
    got = nvdec.yuv444_to_rgb(frame.to(dev), w, h, depth)
    assert torch.equal(got.cpu(), nvdec.yuv444_to_rgb_plain(frame, w, h,
                                                            depth))
