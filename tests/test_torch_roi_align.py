"""The exact gather pooler of the port (``ops/roi_align.py``, plain forms)
against the JAX package's, on the CPU.

- ``roi_align``, ``multilevel_roi_align`` and
  ``multilevel_roi_align_batched`` against the jitted JAX functions on
  seeded maps (the shapes of ``tests/test_roi_align.py``: an 8-channel
  16x20 level, four FPN levels of two images), with and without the
  virtual pad, with ROIs that straddle the pad band and the map's edge:
  in f32 within 1e-5 of the output's largest magnitude (sums in other
  orders), in bf16 within one bf16 rounding of it (2^-8; both sides round
  the same products and sums, measured equal).
- The level mapper exactly.
- The gradient in the maps (the autograd Function with its plain
  backward) against ``jax.vjp`` in f32, within 1e-5 of the gradient's
  largest magnitude (the scatter adds in another order).
- ``window_clamp_mask`` exactly as JAX's on random ROIs at the three
  sites' windows; ``python -m siammot_tpu_torch.tools.check_window_clamp``
  prints the JAX tool's JSON line over ``tests/fixtures/synmot_mini``.
- The XLA-form decode at s_hi 1088 (``SEARCH_REGION`` 5.5: K = 4, s_lo 68,
  x16) against JAX's ``decode_response_fused``: indices exact, scores to
  1e-6, boxes to 1e-4 px.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.models import emm as jax_emm
from siammot_tpu.ops import roi_align as J
from siammot_tpu.ops import roi_align_windowed as JW
from siammot_tpu_torch.core import boxes as box_ops
from siammot_tpu_torch.models import emm as port_emm
from siammot_tpu_torch.ops import roi_align as P
from siammot_tpu_torch.ops import roi_align_windowed as PW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (0.25, 0.125, 0.0625, 0.03125)
LEVEL_HW = ((48, 64), (24, 32), (12, 16), (6, 8))
F32_REL = 1e-5
BF16_REL = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32, F32_REL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_REL)}


def _rois(rng, n, lo=-40.0, hi=260.0, wh=(1.0, 120.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*wh, (n, 2))],
                          1).astype(np.float32)


def _close(got, want, rel, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)
    return err / scale


@pytest.fixture(scope="module")
def maps():
    rng = np.random.RandomState(0)
    return [rng.randn(2, h, w, 8).astype(np.float32) for h, w in LEVEL_HW]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad", [0, 3])
def test_roi_align_matches_jax(dtype, pad):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.RandomState(1)
    feat = rng.randn(16, 20, 8).astype(np.float32)
    # padded coordinates: some ROIs reach into the pad band and past it
    rois = _rois(rng, 40, lo=-30.0, hi=100.0, wh=(0.5, 60.0))
    want = J.roi_align(jnp.asarray(feat, jdt), jnp.asarray(rois), 5, 0.25,
                       2, pad)
    got = P.roi_align(torch.from_numpy(feat).to(tdt),
                      torch.from_numpy(rois), 5, 0.25, 2, pad)
    assert got.dtype == tdt and got.shape == (40, 5, 5, 8)
    _close(got, want, rel, f"roi_align {dtype} pad {pad}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad_pixels", [0, 128])
def test_multilevel_roi_align_matches_jax(maps, dtype, pad_pixels):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.RandomState(2)
    rois = _rois(rng, 64)
    levels = rng.randint(0, 4, 64).astype(np.int32)
    want = J.multilevel_roi_align([jnp.asarray(m[0], jdt) for m in maps],
                                  jnp.asarray(rois), jnp.asarray(levels), 7,
                                  SCALES, 2, pad_pixels)
    got = P.multilevel_roi_align(
        [torch.from_numpy(m[0]).to(tdt) for m in maps],
        torch.from_numpy(rois), torch.from_numpy(levels), 7, SCALES, 2,
        pad_pixels)
    _close(got, want, rel, f"multilevel {dtype} pad {pad_pixels}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pad_pixels", [0, 128])
def test_batched_roi_align_matches_jax(maps, dtype, pad_pixels):
    """Two images; the P6 level JAX drops is passed and dropped here too;
    dead rows pool to zeros as JAX's ``jnp.where`` zeroes them."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.RandomState(3)
    p6 = rng.randn(2, 3, 4, 8).astype(np.float32)
    n = 64
    rois = _rois(rng, n)
    img = rng.randint(0, 2, n).astype(np.int32)
    levels = box_ops.map_rois_to_levels(torch.from_numpy(rois), 2, 5)
    valid = rng.rand(n) < 0.7
    want = J.multilevel_roi_align_batched(
        [jnp.asarray(m, jdt) for m in maps + [p6]], jnp.asarray(rois),
        jnp.asarray(img), jnp.asarray(levels.numpy()), 15, SCALES, 2,
        pad_pixels)
    want = jnp.where(jnp.asarray(valid)[:, None, None, None], want, 0)
    got = P.multilevel_roi_align_batched(
        [torch.from_numpy(m).to(tdt) for m in maps + [p6]],
        torch.from_numpy(rois), torch.from_numpy(img), levels, 15, SCALES,
        2, pad_pixels, valid=torch.from_numpy(valid))
    _close(got, want, rel, f"batched {dtype} pad {pad_pixels}")
    assert not got[torch.from_numpy(~valid)].any()


def test_level_mapper_is_exact():
    rng = np.random.RandomState(4)
    boxes = _rois(rng, 2000, lo=0.0, hi=2000.0, wh=(0.0, 900.0))
    boxes[:5, 2:] = boxes[:5, :2]         # zero-area boxes
    want = J.map_rois_to_levels(jnp.asarray(boxes), 2, 5)
    got = P.map_rois_to_levels(torch.from_numpy(boxes), 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) == 4


def test_rois_across_the_pad_band_and_the_edge(maps):
    """ROIs placed across the pad band's inner and outer edges and the
    map's last row and column, at every level (f32, pad 128 px)."""
    n = 0
    rois = []
    for s, (h, w) in zip(SCALES, LEVEL_HW):
        pad = 128 * s
        for y0, x0 in ((pad - 2, pad - 3), (-1.5, -1.2), (pad + h - 2,
                                                           pad + w - 1),
                       (2 * pad + h - 1, 2 * pad + w - 0.5)):
            rois.append([x0 / s, y0 / s, (x0 + 5) / s, (y0 + 4) / s])
            n += 1
    rois = np.asarray(rois, np.float32)
    levels = np.repeat(np.arange(4, dtype=np.int32), 4)
    want = J.multilevel_roi_align([jnp.asarray(m[1]) for m in maps],
                                  jnp.asarray(rois), jnp.asarray(levels), 7,
                                  SCALES, 2, 128)
    got = P.multilevel_roi_align([torch.from_numpy(m[1]) for m in maps],
                                 torch.from_numpy(rois),
                                 torch.from_numpy(levels), 7, SCALES, 2, 128)
    _close(got, want, F32_REL, "pad band and edge")
    # some samples read the map, some the pad band's zeros
    w = np.asarray(want)
    assert (np.abs(w).reshape(n, -1).max(1) > 0).sum() >= n // 2
    assert (w == 0).any()


@pytest.mark.parametrize("pad_pixels", [0, 128])
def test_gradient_matches_jax_vjp(maps, pad_pixels):
    rng = np.random.RandomState(5)
    n = 48
    rois = _rois(rng, n)
    img = rng.randint(0, 2, n).astype(np.int32)
    levels = rng.randint(0, 4, n).astype(np.int32)
    g = rng.randn(n, 7, 7, 8).astype(np.float32)

    def f(fs):
        return J.multilevel_roi_align_batched(
            fs, jnp.asarray(rois), jnp.asarray(img), jnp.asarray(levels), 7,
            SCALES, 2, pad_pixels)

    _, vjp = jax.vjp(f, [jnp.asarray(m) for m in maps])
    want = vjp(jnp.asarray(g))[0]
    feats = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    out = P.multilevel_roi_align_batched(
        feats, torch.from_numpy(rois), torch.from_numpy(img),
        torch.from_numpy(levels), 7, SCALES, 2, pad_pixels)
    out.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(feats, want)):
        _close(t.grad, w, F32_REL, f"gradient of level {i}")
    # single-level form, pad in feature pixels
    feat = torch.from_numpy(maps[0][1]).requires_grad_(True)
    _, vjp1 = jax.vjp(lambda x: J.roi_align(x, jnp.asarray(rois), 7, 0.25,
                                            2, 4), jnp.asarray(maps[0][1]))
    P.roi_align(feat, torch.from_numpy(rois), 7, 0.25, 2, 4).backward(
        torch.from_numpy(g))
    _close(feat.grad, vjp1(jnp.asarray(g))[0], F32_REL, "roi_align grad")


@pytest.mark.parametrize("site", ["box", "template", "search_region"])
def test_window_clamp_mask_matches_jax(site):
    """Random ROIs at each site's output size and window (the defaults:
    box 7/64, template 15/64, search region 30/128 with a 512 px pad) on
    720p levels; the masks agree exactly and some ROIs clamp."""
    out, window, pad = {"box": (7, 64, 0), "template": (15, 64, 0),
                        "search_region": (30, 128, 512)}[site]
    rng = np.random.RandomState(6)
    heights, widths = [184, 92, 46, 23], [320, 160, 80, 40]
    boxes = _rois(rng, 3000, lo=-50.0, hi=1200.0, wh=(2.0, 700.0))
    levels = box_ops.map_rois_to_levels(torch.from_numpy(boxes), 2, 5)
    rois = boxes + pad if pad else boxes
    scales = np.asarray(SCALES, np.float32)[levels.numpy()]
    want = np.asarray(JW.window_clamp_mask(
        jnp.asarray(rois), scales, heights, widths,
        jnp.asarray(levels.numpy()), out, 2, window, pad_pixels=pad))
    got = PW.window_clamp_mask(torch.from_numpy(rois), scales, heights,
                               widths, levels, out, 2, window,
                               pad_pixels=pad).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_check_window_clamp_prints_the_jax_line(tmp_path):
    """Both tools over the committed sequence, seen as the SYNMOT_HARD
    dataset (the key both packages have)."""
    os.symlink(os.path.join(REPO, "tests", "fixtures", "synmot_mini"),
               tmp_path / "SYNMOT_HARD")
    argv = ["--config-file",
            os.path.join(REPO, "configs", "dla",
                         "DLA_34_FPN_EMM_SYNMOT_HARD.yaml"),
            "--dataset", "SYNMOT_HARD", "--set", "test",
            "DATASETS.ROOT_DIR", str(tmp_path)]
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import check_window_clamp as jax_tool
    finally:
        sys.path.pop(0)
    from siammot_tpu_torch.tools import check_window_clamp as port_tool

    def line(main, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(args)
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    old = sys.argv
    sys.argv = ["check_window_clamp.py"] + argv
    try:
        want = line(lambda _: jax_tool.main(), None)
    finally:
        sys.argv = old
    got = line(port_tool.main, argv)
    assert got == want
    assert want["n_gt"] > 0 and want["n_pub_det"] > 0


def test_xla_decode_past_1024_matches_jax():
    """``SEARCH_REGION`` 5.5 with a 15 template: a 68-wide response, s_hi
    1088, past the striped kernel: the port dispatches to the XLA form,
    as ``siammot_tpu/models/emm.py:417`` does."""
    rng = np.random.RandomState(7)
    k, s_lo = 4, 68
    ecfg_kw = dict(resolution=15, scales=SCALES, sampling_ratio=2,
                   search_region=5.5, min_search_wh=0.0, pad_pixels=512,
                   use_centerness=True, cosine_window_weight=0.4,
                   amodal=False, cls_pos_region=0.8, track_loss_weight=1.0)
    jcfg = jax_emm.EMMConfig(**ecfg_kw)
    pcfg = port_emm.EMMConfig(**ecfg_kw)
    assert pcfg.sr_size - pcfg.resolution + 1 == s_lo
    cls = (2 * rng.randn(k, s_lo, s_lo, 2)).astype(np.float32)
    ctr = rng.randn(k, s_lo, s_lo, 1).astype(np.float32)
    reg = (40 + 15 * rng.rand(k, s_lo, s_lo, 4)).astype(np.float32)
    xy = rng.uniform(600, 900, (k, 2))
    tb = np.concatenate([xy, xy + rng.uniform(40, 120, (k, 2))],
                        1).astype(np.float32)
    sr = np.asarray(jax_emm.make_search_region(jnp.asarray(tb), jcfg))
    valid = np.array([True, False, True, True])
    want_b, want_s = jax_emm.decode_response_fused(
        jnp.asarray(cls), jnp.asarray(ctr), jnp.asarray(reg),
        jnp.asarray(sr), jnp.asarray(tb), jcfg, 16, use_pallas=True,
        valid=jnp.asarray(valid))
    got_b, got_s = port_emm.decode_response_fused(
        torch.from_numpy(cls), torch.from_numpy(ctr), torch.from_numpy(reg),
        torch.from_numpy(sr), torch.from_numpy(tb), pcfg, 16,
        torch.from_numpy(valid))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0,
                               atol=1e-4)
    # the argmax cells themselves: JAX's XLA branch (emm.py:424-441)
    # evaluated here with jnp, against the port's dispatch
    from siammot_tpu.ops.upsample import bicubic_matrix
    from siammot_tpu_torch.models.emm import _decode_constants
    from siammot_tpu_torch.ops.decode import decode_argmax
    s_hi = s_lo * 16
    hi = jax.lax.Precision.HIGHEST
    u = jnp.asarray(bicubic_matrix(s_lo, 16))
    x = jnp.stack([cls[..., 1] - cls[..., 0], ctr[..., 0],
                   reg[..., 0] + reg[..., 2], reg[..., 1] + reg[..., 3]],
                  -1)
    up = jnp.einsum("oh,khwc->kowc", u, x, precision=hi)
    up = jnp.einsum("pw,khwc->khpc", u, up, precision=hi)
    cls_prob = jax.nn.sigmoid(up[..., 0])
    conf = cls_prob * jax.nn.sigmoid(up[..., 1])
    sw = up[..., 2] / (tb[:, 2] - tb[:, 0])[:, None, None]
    sh = up[..., 3] / (tb[:, 3] - tb[:, 1])[:, None, None]
    penalty = jnp.exp((-jnp.maximum(sw, 1 / sw) * jnp.maximum(sh, 1 / sh)
                       + 1.0) * 0.1)
    window = jnp.asarray(jax_emm._hann_window(s_hi)).reshape(s_hi, s_hi)
    p_conf = conf * penalty * 0.6 + 0.4 * window
    want_idx = np.asarray(jnp.argmax(p_conf.reshape(k, -1), axis=1))
    pu, pwin = _decode_constants(s_lo, 16, "cpu")
    x4 = torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous()
    wh = torch.from_numpy(tb[:, 2:] - tb[:, :2])
    idx, score = decode_argmax(x4, wh, pu, pwin, torch.from_numpy(valid),
                               0.4, True)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert idx.dtype == torch.int32 and int(idx.max()) < s_hi * s_hi
    np.testing.assert_allclose(score.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
