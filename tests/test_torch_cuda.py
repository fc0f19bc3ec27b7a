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
gradient at the three training sites and under a crowded tile), small
elsewhere. Kernel 2's live slots must equal kernel 6's output bit for
bit, kernels 3, 7 and 8 must give the same bits from launch to launch,
and kernel 8 kernel 3's bits.
Tolerances as in ``chip_smoke.py``: pool/xcorr f32 sums in another order
(1e-4 + 1e-3|x|), predictor logits 3e-2 in bf16 (tower rounding) and
1e-4 in f32, decode idx exact and scores 1e-5, deformable conv 2e-5 of
the output's scale in f32 and one bf16 step plus 2^-9 of the scale in
bf16 (the same samples, f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from siammot_tpu_torch.core.boxes import map_rois_to_levels
from siammot_tpu_torch.models.emm import _decode_constants
from siammot_tpu_torch.ops.decode import emm_decode, emm_decode_plain
from siammot_tpu_torch.ops.deform_conv import (deform_conv2d,
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
    """(name, kernel output, plain output) of kernel 6's three passes."""
    from siammot_tpu_torch.ops.xcorr import (xcorr_grad_search,
                                             xcorr_grad_search_plain,
                                             xcorr_grad_template)
    out = [("forward", xcorr_depthwise(search, tmpl),
            xcorr_depthwise_plain(search, tmpl)),
           ("grad_template", xcorr_grad_template(search, up),
            xcorr_depthwise_plain(search, up))]
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
    (61x61 taps) takes the banded fallback kernel; search gradients wider or
    taller than 32 (9x40, 75x75) run in bands of output rows and column
    segments."""
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
    (a training step's mix): the search gradient's 75x75 output in bands
    of 32 output rows and five 16-wide column segments."""
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
    """The gather pooler's backward (atomic f32 adds) against its plain
    version within 1e-4 of the gradient's scale, and the autograd
    Function's gradient in the maps against autograd through the plain
    forward in f32."""
    from siammot_tpu_torch.ops.roi_align import (roi_align_bwd,
                                                 roi_align_bwd_plain,
                                                 roi_align_plain,
                                                 roi_align_rows)
    g = torch.Generator().manual_seed(o + pad)
    n = 64
    table = _roi_table(g, dev, dtype, 128)
    args = _roi_args(g, table, n, o, pad, None)
    up = torch.randn(n, o, o, 128, generator=g).to(dev, dtype)
    bargs = (up, *args[1:4], tuple(table.table.shape), o, 2)
    got = roi_align_bwd(*bargs)
    want = roi_align_bwd_plain(*bargs)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    if dtype == _F32:
        t = table.table.clone().requires_grad_(True)
        roi_align_rows(t, *args[1:6]).backward(up)
        t2 = table.table.clone().requires_grad_(True)
        roi_align_plain(t2, *args[1:6]).backward(up)
        torch.testing.assert_close(t.grad, t2.grad, rtol=0,
                                   atol=1e-4 * float(t2.grad.abs().max()))
