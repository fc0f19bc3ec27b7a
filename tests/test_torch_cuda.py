"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (as on
the CPU machines that run the tier-1 suite).  On a machine with the card
and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX).  Shapes are the
main path's where a kernel takes only those (predictor), small
elsewhere.  Tolerances as in ``chip_smoke.py``: pool/xcorr f32 sums in
another order (1e-4 + 1e-3|x|), predictor logits 3e-2 (bf16 tower
rounding), decode idx exact and scores 1e-5.
"""

import numpy as np
import pytest
import torch

from siammot_tpu_torch.core.boxes import map_rois_to_levels
from siammot_tpu_torch.models.emm import _decode_constants
from siammot_tpu_torch.ops.decode import emm_decode, emm_decode_plain
from siammot_tpu_torch.ops.predictor import (_NAMES, emm_predictor,
                                             emm_predictor_plain)
from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                      window_geometry)
from siammot_tpu_torch.ops.window_pool import window_pool, window_pool_plain
from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_masked,
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
