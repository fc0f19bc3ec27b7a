"""Kernel 7 (the window pool's table gradient) of the port against the JAX
package, on the CPU.

The port's plain table gradient (autograd through the plain pool, what
the wrapper runs for CPU tensors) against the Pallas backward kernel
``window_pool_pallas_bwd`` in interpret mode, at 128 channels, with ROIs
crowded so that their windows overlap and some pressed against the
table's edges; and the port's differentiable ``windowed_pool``
(``valid=None``) at each training pool site against ``jax.grad`` of the
JAX ``windowed_pool`` on its XLA path, down to the per-level FPN maps
(through ``stack_levels``' pads and concatenation).  Seeded numpy inputs;
f32 on both sides, sums in other orders -> 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.ops.pallas.window_pool import window_pool_pallas_bwd
from siammot_tpu.ops.roi_align_windowed import pack_levels as jax_pack
from siammot_tpu.ops.roi_align_windowed import windowed_pool as jax_pool
from siammot_tpu_torch.core.boxes import map_rois_to_levels
from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                      window_geometry,
                                                      windowed_pool)
from siammot_tpu_torch.ops.window_pool import window_pool_bwd

SCALES = (0.25, 0.125, 0.0625, 0.03125)
ATOL = RTOL = 1e-4


def _feats(rng, b, c, h=32, w=48):
    return [rng.randn(b, h // 2 ** i, w // 2 ** i, c).astype(np.float32)
            for i in range(4)]


def _crowded_rois(rng, n, lo, hi, extent):
    """ROIs packed into a small area (overlapping windows); the first two
    touch the right/bottom edge of level 0, the next one the top-left."""
    x1 = rng.uniform(0, extent[0] / 3, n)
    y1 = rng.uniform(0, extent[1] / 3, n)
    rois = np.stack([x1, y1, x1 + rng.uniform(lo, hi, n),
                     y1 + rng.uniform(lo, hi, n)], -1).astype(np.float32)
    rois[:2, 2:] = [extent[0] - 1, extent[1] - 1]
    rois[:2, :2] = rois[:2, 2:] - rng.uniform(lo, hi, (2, 2))
    rois[2, :2] = 0.0
    return rois


def test_table_gradient_matches_pallas_interpret():
    rng = np.random.RandomState(11)
    win, size, c = 16, 7, 128
    feats = _feats(rng, 2, c)
    pack = pack_levels([torch.from_numpy(f) for f in feats], SCALES)
    n = 6
    rois = torch.from_numpy(_crowded_rois(rng, n, 10, 40, (192, 128)))
    levels = map_rois_to_levels(rois, 2, 5)
    block = torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32) * 4 + levels
    scales = torch.tensor(SCALES)[levels.long()]
    origins, wy, wx = window_geometry(pack.heights, pack.widths,
                                      pack.row_offsets, rois, block, scales,
                                      size, 2, win, 0, 4)
    rows = origins[:, 0].numpy()
    assert len(set(rows.tolist())) < n or \
        (np.abs(rows[:, None] - rows[None]) < win).sum() > n  # overlaps
    g = rng.randn(n, size, size, c).astype(np.float32)
    r, wmax, _ = pack.table.shape
    got = window_pool_bwd(torch.from_numpy(g), origins, wy, wx,
                          tuple(pack.table.shape))
    # the Pallas kernel reads whole windows: the JAX pool pads the table
    # by one window of rows (and columns up to one window) first
    padded = (r + win, max(wmax, win), c)
    want = np.asarray(window_pool_pallas_bwd(
        jnp.asarray(g), jnp.asarray(origins.numpy()), jnp.asarray(wy.numpy()),
        jnp.asarray(wx.numpy()), padded, jnp.float32, win, interpret=True))
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(want[r:], 0.0)
    np.testing.assert_array_equal(want[:, wmax:], 0.0)
    np.testing.assert_allclose(got.numpy(), want[:r, :wmax], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("site", ["box", "template", "search_region"])
def test_windowed_pool_gradient_matches_jax_xla(site):
    rng = np.random.RandomState({"box": 21, "template": 22,
                                 "search_region": 23}[site])
    c, n, b = 32, 10, 2
    feats = _feats(rng, b, c)
    img_idx = (np.arange(n) % b).astype(np.int32)
    pad = 0
    if site == "box":
        size, win = 7, 32
        rois = level_rois = _crowded_rois(rng, n, 8, 90, (192, 128))
    elif site == "template":
        size, win = 15, 32
        rois = level_rois = _crowded_rois(rng, n, 20, 90, (192, 128))
    else:
        size, win, pad = 30, 64, 512
        level_rois = _crowded_rois(rng, n, 20, 60, (192, 128))
        w = level_rois[:, 2:] - level_rois[:, :2] + 1
        rois = np.concatenate([level_rois[:, :2] + pad - w / 2,
                               level_rois[:, 2:] + pad + w / 2],
                              1).astype(np.float32)
    levels = map_rois_to_levels(torch.from_numpy(level_rois), 2, 5)
    up = rng.randn(n, size, size, c).astype(np.float32)

    def jax_loss(fs):
        pk = jax_pack(fs, SCALES, dtype=jnp.float32)
        out = jax_pool(pk, jnp.asarray(rois), jnp.asarray(img_idx),
                       jnp.asarray(levels.numpy()), size, 2, win,
                       pad_pixels=pad, backend="xla")
        return jnp.sum(out * up), out

    (_, want_out), want = jax.value_and_grad(jax_loss, has_aux=True)(
        [jnp.asarray(f) for f in feats])

    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    pack = pack_levels(tf, SCALES, dtype=torch.float32)
    out = windowed_pool(pack, torch.from_numpy(rois),
                        torch.from_numpy(img_idx), levels, size, 2, win,
                        pad_pixels=pad, valid=None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(up)).sum().backward()
    assert np.abs(np.asarray(want[0])).max() > 0
    for lvl, (t, w) in enumerate(zip(tf, want)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"level {lvl}")


def _site_geometry(rng, site, n=20):
    """A 2-image table of 8 channels and ``n`` ROIs (some at its edges)
    with one training site's (S, window, pad)."""
    size, win, pad = {"box": (7, 16, 0), "template": (15, 32, 0),
                      "search_region": (30, 32, 16)}[site]
    pack = pack_levels([torch.from_numpy(f) for f in _feats(rng, 2, 8)],
                       SCALES)
    rois = torch.from_numpy(_crowded_rois(rng, n, 6, 60, (192, 128)))
    levels = map_rois_to_levels(rois, 2, 5)
    img = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32))
    scales = torch.tensor(SCALES)[levels.long()]
    geo = window_geometry(pack.heights, pack.widths, pack.row_offsets,
                          rois + pad, img * 4 + levels, scales, size, 2,
                          win, pad, 4)
    return geo, tuple(pack.table.shape)


@pytest.mark.parametrize("site", ["box", "template", "search_region"])
@pytest.mark.parametrize("dead", [False, True])
def test_touched_rects_bound_each_rois_gradient(site, dead):
    """Kernel 7's first pass in plain PyTorch (``touched_rects``): each
    ROI's rectangle is the bounding box of the table cells its plain
    gradient reaches (all-ones upstream gradient, weights >= 0, so no
    cancellation), and a dead ROI's is empty."""
    from siammot_tpu_torch.ops.window_pool import (touched_rects,
                                                   window_pool_bwd_plain)
    rng = np.random.RandomState(40 + dead)
    (origins, wy, wx), shape = _site_geometry(rng, site)
    n, s, _ = wy.shape
    valid = torch.from_numpy(rng.rand(n) < 0.5) if dead else None
    rects = touched_rects(origins, wy, wx, shape, valid)
    for i in range(n):
        grad = window_pool_bwd_plain(torch.ones(1, s, s, shape[2]),
                                     origins[i:i + 1], wy[i:i + 1],
                                     wx[i:i + 1], shape)
        cells = (grad != 0).any(-1).nonzero()
        if (valid is not None and not valid[i]) or len(cells) == 0:
            assert rects[i, 0] > rects[i, 1] and rects[i, 2] > rects[i, 3]
        else:
            assert rects[i].tolist() == [
                int(cells[:, 0].min()), int(cells[:, 0].max()),
                int(cells[:, 1].min()), int(cells[:, 1].max())], i


@pytest.mark.parametrize("site", ["box", "search_region"])
def test_tile_counts_count_the_rectangles_meeting_each_tile(site):
    """``tile_counts``: per table tile of kernel 7's gather, the ROIs whose
    rectangle meets it, against a loop over tiles and ROIs."""
    from siammot_tpu_torch.ops.window_pool import (BWD_TILE, tile_counts,
                                                   touched_rects)
    rng = np.random.RandomState(45)
    (origins, wy, wx), shape = _site_geometry(rng, site, n=40)
    rects = touched_rects(origins, wy, wx, shape).tolist()
    counts = tile_counts(torch.tensor(rects), shape)
    tr, tc = BWD_TILE
    for b in range(counts.shape[0]):
        for t in range(counts.shape[1]):
            want = sum(r[0] <= r[1] and r[0] <= b * tr + tr - 1
                       and r[1] >= b * tr and r[2] <= t * tc + tc - 1
                       and r[3] >= t * tc for r in rects)
            assert counts[b, t] == want, (b, t)
    assert counts.max() > 1
