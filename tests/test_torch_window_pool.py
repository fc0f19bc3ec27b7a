"""Kernel 1 (windowed ROIAlign pool) of the port against the JAX package.

The port's origins/weights prologue and the plain pool it runs on the CPU
are held against ``roi_align_windowed(..., backend="xla")`` at every
pool site's geometry (box head, template, padded search region), with
dead rows, and against the Pallas kernel ``window_pool_pallas`` run in
interpret mode at one small shape.  Inputs come from numpy with a fixed
seed.  Tolerance: f32 on both sides, sums in another order -> 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import siammot_tpu.ops.pallas.window_pool as jax_wp
from siammot_tpu.ops.roi_align import map_rois_to_levels as jax_levels
from siammot_tpu.ops.roi_align_windowed import \
    roi_align_windowed as jax_roi_align_windowed
from siammot_tpu.ops.roi_align_windowed import stack_levels as jax_stack
from siammot_tpu_torch.core.boxes import map_rois_to_levels
from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                      roi_align_windowed,
                                                      stack_levels,
                                                      window_geometry)
from siammot_tpu_torch.ops.window_pool import window_pool, window_pool_plain

SCALES = (0.25, 0.125, 0.0625, 0.03125)
ATOL = RTOL = 1e-4


def _feats(rng, c, h=64, w=96):
    return [rng.randn(1, h // 2 ** i, w // 2 ** i, c).astype(np.float32)
            for i in range(4)]


def _rois(rng, n, lo, hi, extent=(300, 200)):
    x1 = rng.uniform(0, extent[0], n)
    y1 = rng.uniform(0, extent[1], n)
    return np.stack([x1, y1, x1 + rng.uniform(lo, hi, n),
                     y1 + rng.uniform(lo, hi, n)], -1).astype(np.float32)


def _both(feats, rois, level_rois, size, window, pad, valid):
    table, offsets, heights, widths = jax_stack(
        [jnp.asarray(f) for f in feats])
    levels = np.asarray(jax_levels(jnp.asarray(level_rois), 2, 5))
    scales = np.asarray(SCALES, np.float32)[levels]
    ref = jax_roi_align_windowed(
        table, jnp.asarray(offsets), jnp.asarray(heights),
        jnp.asarray(widths), jnp.asarray(rois), jnp.asarray(levels),
        jnp.asarray(scales), size, 2, window=window, pad_pixels=pad,
        backend="xla", valid=jnp.asarray(valid))

    pack = pack_levels([torch.from_numpy(f) for f in feats], SCALES)
    t_levels = map_rois_to_levels(torch.from_numpy(level_rois), 2, 5)
    np.testing.assert_array_equal(t_levels.numpy(), levels)
    out = roi_align_windowed(
        pack.table, pack.row_offsets, pack.heights, pack.widths,
        torch.from_numpy(rois), t_levels, torch.from_numpy(scales), size, 2,
        window, pad, 4, valid=torch.from_numpy(valid))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("site", ["box", "template", "search_region"])
def test_pool_sites_match_jax_xla(site):
    rng = np.random.RandomState({"box": 1, "template": 2,
                                 "search_region": 3}[site])
    feats = _feats(rng, 32)
    n = 12
    valid = rng.rand(n) < 0.7
    valid[0] = True
    if site == "box":
        rois = _rois(rng, n, 8, 120)
        got, want = _both(feats, rois, rois, 7, 32, 0, valid)
    elif site == "template":
        rois = _rois(rng, n, 20, 90)
        got, want = _both(feats, rois, rois, 15, 32, 0, valid)
    else:
        boxes = _rois(rng, n, 20, 60)
        pad = 512
        w = boxes[:, 2:] - boxes[:, :2] + 1
        sr = np.concatenate([boxes[:, :2] + pad - w / 2,
                             boxes[:, 2:] + pad + w / 2], 1)
        got, want = _both(feats, sr.astype(np.float32), boxes, 30, 64, pad,
                          valid)
    assert np.abs(want[valid]).max() > 0
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pool_matches_pallas_interpret():
    """The Pallas kernel (interpret mode, compacted with dead rows) and
    the port's pool on the same prologue."""
    rng = np.random.RandomState(4)
    feats = _feats(rng, 128)
    rois = _rois(rng, 6, 20, 80)
    valid = np.array([True, False, True, True, False, True])
    table, offsets, heights, widths = jax_stack(
        [jnp.asarray(f) for f in feats])
    levels = jax_levels(jnp.asarray(rois), 2, 5)
    scales = jnp.asarray(np.array(SCALES, np.float32))[levels]
    args = (table, jnp.asarray(offsets), jnp.asarray(heights),
            jnp.asarray(widths), jnp.asarray(rois), levels, scales)

    orig = jax_wp.window_pool_pallas

    def interp(table, origins, wy, wx, window, channel_block=128,
               interpret=False, out_blocks=None, n_valid=None):
        return orig(table, origins, wy, wx, window, channel_block, True,
                    out_blocks, n_valid)

    jax_wp.window_pool_pallas = interp
    try:
        want = jax_roi_align_windowed(*args, 7, 2, window=48,
                                      backend="pallas",
                                      valid=jnp.asarray(valid))
    finally:
        jax_wp.window_pool_pallas = orig

    pack = pack_levels([torch.from_numpy(f) for f in feats], SCALES)
    got = roi_align_windowed(
        pack.table, pack.row_offsets, pack.heights, pack.widths,
        torch.from_numpy(rois), torch.from_numpy(np.array(levels)),
        torch.from_numpy(np.array(scales)), 7, 2, 48, 0, 4,
        valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_stack_levels_matches_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, h, w, 8).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6))]
    want = jax_stack([jnp.asarray(f) for f in feats])
    got = stack_levels([torch.from_numpy(f) for f in feats])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_plain_pool_reads_only_live_rows():
    """The CPU wrapper takes the plain version; dead rows are zeros even
    when their weights are not."""
    rng = np.random.RandomState(6)
    pack = pack_levels([torch.from_numpy(f) for f in _feats(rng, 16)],
                       SCALES)
    rois = torch.from_numpy(_rois(rng, 5, 20, 80))
    levels = map_rois_to_levels(rois, 2, 5)
    scales = torch.tensor(SCALES)[levels.long()]
    origins, wy, wx = window_geometry(pack.heights, pack.widths,
                                      pack.row_offsets, rois, levels, scales,
                                      7, 2, 32, 0, 4)
    valid = torch.tensor([True, False, True, False, True])
    out = window_pool(pack.table, origins, wy, wx, valid)
    ref = window_pool_plain(pack.table, origins, wy, wx,
                            torch.ones(5, dtype=torch.bool))
    assert (out[~valid] == 0).all()
    torch.testing.assert_close(out[valid], ref[valid])
