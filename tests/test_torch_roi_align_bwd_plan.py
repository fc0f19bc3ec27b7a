"""The gather pooler's backward as the card runs it
(``ops/cuda/roi_align.cu``: ``roi_bwd_taps``, ``roi_bwd_masks``,
``roi_bwd_gather``), on the CPU: its host plan, a mirror of its lists and
the plain form of its summation order, against brute force, the plain
backward and the JAX package.

* ``bwd_plan`` tiles every table row exactly once; a table's layout
  holds every block its ROIs name.
* The lists: a Python mirror of the kernels' spans (each table row's and
  column's first and last sample, from the neighbouring samples' taps),
  rectangles, blocks, the 32-ROI mask words of each row band and column
  span, and the tile lists they give (walking the AND of two words low
  bit to high), against a brute-force scan of every sample's taps: the
  samples reaching a row are contiguous and are its span, and each
  tile's list holds, in ROI order, exactly the ROIs of its block whose
  taps' rectangle meets it.  ROIs across images and levels, in the pad
  band, past the map's edge, degenerate (1 px) and very large, more than
  one mask word of them, and piled on one spot.
* The plain form of the lists, ``bwd_tile_lists``, is the mirror's; the
  chunk size of long lists, ``bwd_chunk_size``, the least that fits.
* The order: ``roi_align_bwd_ordered`` (ROIs in order, then each ROI's
  bins in row-major order, then each bin's samples; a long list's chunks
  summed apart and added in order) within 1e-4 of the
  scale of ``roi_align_bwd_plain`` (``index_add_``'s order) and of
  ``jax.vjp`` of the JAX ``multilevel_roi_align_batched``; in the table's
  dtype, those f32 sums rounded once; a permutation of the ROIs permutes
  the order.
* ``level_table``: the table is bitwise the per-image construction it
  replaced, and the maps' gradients through the three training sites are
  equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siammot_tpu.ops import roi_align as J
from siammot_tpu_torch.ops import roi_align as P

SCALES = (0.25, 0.125, 0.0625, 0.03125)
LEVEL_HW = ((48, 64), (24, 32), (12, 16), (6, 8))
TILE = P.BWD_TILE
BWD_CHUNK = P.BWD_CHUNK
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _maps(seed, c=8, dtype=torch.float32, images=2):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(images, h, w, c).astype(np.float32))
            .to(dtype) for h, w in LEVEL_HW]


def _case(kind, seed=0, images=2, pad_pixels=0):
    """ROIs [N, 4] (padded coordinates), image and level indices."""
    rng = np.random.RandomState(seed)
    if kind == "spread":
        n = 40
        xy = rng.uniform(-40, 260, (n, 2))
        wh = rng.uniform(1, 120, (n, 2))
    elif kind == "degenerate":
        n = 36
        xy = rng.uniform(-10, 250, (n, 2))
        wh = rng.choice([0.0, 0.3, 1.0], (n, 2))
    elif kind == "large":
        n = 12
        xy = rng.uniform(-600, 100, (n, 2))
        wh = rng.uniform(400, 2000, (n, 2))
    elif kind == "piled":
        n = 90
        xy = np.array([100.0, 60.0]) + rng.randn(n, 2) * 4
        wh = np.array([60.0, 50.0]) + rng.randn(n, 2) * 3
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32) + pad_pixels
    piled = kind == "piled"
    img = (np.zeros(n) if piled else rng.randint(0, images, n)).astype(
        np.int32)
    levels = (np.full(n, 1) if piled else rng.randint(0, 4, n)).astype(
        np.int32)
    return torch.from_numpy(rois), torch.from_numpy(img), \
        torch.from_numpy(levels)


def _axis_taps(rois, geom, scale, o, r):
    """Each ROI's taps on each axis: ((lo, hi, w_lo, w_hi) of the rows,
    the same of the columns), [N, o r] each, as the kernels compute them
    (``axis_taps``, the plain form's ``_bilinear_1d``)."""
    _, h, w, pad = geom.long().unbind(1)
    start = rois[:, :2] * scale[:, None]
    extent = (rois[:, 2:] * scale[:, None] - start).clamp(min=1.0)
    ys = P._sample_positions(start[:, 1], extent[:, 1], o, r)
    xs = P._sample_positions(start[:, 0], extent[:, 0], o, r)
    return P._bilinear_1d(ys, h, pad), P._bilinear_1d(xs, w, pad)


def _hits(t, i, u):
    lo, hi, wlo, whi = t
    return (lo[i] == u and wlo[i] != 0) or (hi[i] == u and whi[i] != 0)


def mirror_spans(t, size):
    """``roi_bwd_taps``' spans along one axis of one ROI: for each row u
    of the level, lo | hi << 16 of the samples reaching it (0: none),
    each end set by the sample whose neighbour does not reach u; and the
    rows' extremes."""
    lo, hi, wlo, whi = t
    sp = np.zeros(size, np.int64)
    ext = [None, None]
    os_ = len(lo)
    for i in range(os_):
        for u, wt in ((lo[i], wlo[i]), (hi[i], whi[i])):
            if wt == 0:
                continue
            if i == 0 or not _hits(t, i - 1, u):
                sp[u] |= i
            if i + 1 == os_ or not _hits(t, i + 1, u):
                sp[u] |= (i + 1) << 16
            ext = [u if ext[0] is None else min(ext[0], u),
                   u if ext[1] is None else max(ext[1], u)]
    return sp, ext


def mirror_lists(rois, geom, scale, o, r, layout):
    """The kernels' lists: per ROI its spans, rectangle and block; per
    tile (block, tile row, tile column) its ROIs in the order the gather
    visits them."""
    blocks, tiles, bands, cols = P.bwd_plan(layout)
    (ylo, yhi, ywl, ywh), (xlo, xhi, xwl, xwh) = [
        [a.numpy() for a in t] for t in _axis_taps(rois, geom, scale, o, r)]
    n = rois.shape[0]
    g = geom.numpy()
    per_roi = []
    for k in range(n):
        ty = (ylo[k], yhi[k], ywl[k], ywh[k])
        tx = (xlo[k], xhi[k], xwl[k], xwh[k])
        sy, ey = mirror_spans(ty, g[k, 1])
        sx, ex = mirror_spans(tx, g[k, 2])
        blk = -1
        if ey[0] is not None and ex[0] is not None:
            for b, row in enumerate(blocks):
                if tuple(row[:3]) == tuple(g[k, :3]):
                    blk = b
        per_roi.append(dict(ty=ty, tx=tx, sy=sy, sx=sx, rect=ey + ex,
                            blk=blk))
    words = -(-n // 32)
    band_w = np.zeros((bands, words), np.uint64)
    col_w = np.zeros((cols, words), np.uint64)
    for b, (_, h, w, _, tc, band0, col0) in enumerate(blocks):
        for q in range(-(-h // TILE)):
            for k, d in enumerate(per_roi):
                y0, y1 = d["rect"][:2]
                if d["blk"] == b and y0 <= q * TILE + TILE - 1 and \
                        y1 >= q * TILE:
                    band_w[band0 + q, k // 32] |= np.uint64(1 << (k % 32))
        for q in range(tc):
            for k, d in enumerate(per_roi):
                x0, x1 = d["rect"][2:]
                if d["blk"] == b and x0 <= q * TILE + TILE - 1 and \
                        x1 >= q * TILE:
                    col_w[col0 + q, k // 32] |= np.uint64(1 << (k % 32))
    lists = {}
    for b, (_, h, w, _, tc, band0, col0) in enumerate(blocks):
        for tr in range(-(-h // TILE)):
            for tcol in range(tc):
                order = []
                for wd in range(words):
                    m = int(band_w[band0 + tr, wd] & col_w[col0 + tcol, wd])
                    while m:
                        low = m & -m
                        order.append(wd * 32 + low.bit_length() - 1)
                        m &= m - 1
                lists[(b, tr, tcol)] = order
    return per_roi, lists


def _geometry(kind, images=2, pad_pixels=0, o=7):
    table = P.level_table(_maps(1, images=images), SCALES)
    rois, img, levels = _case(kind, 3, images, pad_pixels)
    geom, scale = table.geometry(img, levels, pad_pixels)
    return table, rois, geom, scale


@pytest.mark.parametrize("layout", [tuple(LEVEL_HW) * 2, ((5, 9),),
                                    ((1, 40), (17, 3), (8, 8), (9, 16))])
def test_bwd_plan_tiles_every_row_once(layout):
    blocks, tiles, bands, cols = P.bwd_plan(layout)
    seen = np.zeros(sum(h * w for h, w in layout), np.int64)
    ntiles = 0
    for first, h, w, tile0, tc, band0, col0 in blocks:
        assert tile0 == ntiles
        tr = -(-h // TILE)
        assert tc == -(-w // TILE)
        ntiles += tr * tc
        for t in range(tr * tc):
            y, x = t // tc * TILE, t % tc * TILE
            for cy in range(y, min(y + TILE, h)):
                for cx in range(x, min(x + TILE, w)):
                    seen[first + cy * w + cx] += 1
    assert ntiles == tiles
    assert (seen == 1).all()
    assert bands == sum(-(-h // TILE) for h, _ in layout)
    assert cols == sum(-(-w // TILE) for _, w in layout)


@pytest.mark.parametrize("images", [1, 2])
def test_table_layout_holds_every_block_a_roi_names(images):
    """The backward tiles the table by :attr:`LevelTable.layout`: it
    covers the table's rows, and every (first row, height, width) a ROI's
    geometry names is one of its blocks."""
    table, rois, geom, scale = _geometry("spread", images=images)
    layout = table.layout
    assert sum(h * w for h, w in layout) == table.table.shape[0]
    assert len(layout) == images * len(LEVEL_HW)
    blocks = {tuple(b[:3]) for b in P.bwd_plan(layout)[0].tolist()}
    assert set(map(tuple, geom[:, :3].tolist())) <= blocks


@pytest.mark.parametrize("kind,pad_pixels", [
    ("spread", 0), ("spread", 128), ("degenerate", 0), ("large", 0),
    ("large", 128), ("piled", 0)])
@pytest.mark.parametrize("o", [7, 35])
def test_lists_against_every_sample(kind, pad_pixels, o):
    table, rois, geom, scale = _geometry(kind, pad_pixels=pad_pixels)
    r = 2
    per_roi, lists = mirror_lists(rois, geom, scale, o, r, table.layout)
    blocks = P.bwd_plan(table.layout)[0]
    g = geom.numpy()
    rects = []
    for d, gk in zip(per_roi, g):
        for t, sp, size in ((d["ty"], d["sy"], gk[1]),
                            (d["tx"], d["sx"], gk[2])):
            for u in range(size):
                reach = [i for i in range(len(t[0])) if _hits(t, i, u)]
                if reach:
                    assert reach == list(range(reach[0], reach[-1] + 1))
                    assert sp[u] == reach[0] | (reach[-1] + 1) << 16
                else:
                    assert sp[u] == 0
        # brute force: the rows and columns of the block its four corners
        # reach with a non-zero weight
        ys = [u for u in range(gk[1]) if d["sy"][u]]
        xs = [u for u in range(gk[2]) if d["sx"][u]]
        rects.append((min(ys), max(ys), min(xs), max(xs)) if ys and xs
                     else None)
    idx_w = P._corners(rois, geom, scale, o, r)
    for k, rect in enumerate(rects):
        rows = torch.cat([i[k][w[k] != 0] for i, w in idx_w]).unique()
        if rect is None:
            assert len(rows) == 0 and per_roi[k]["blk"] == -1
            continue
        y, x = (rows - g[k, 0]) // g[k, 2], (rows - g[k, 0]) % g[k, 2]
        assert (int(y.min()), int(y.max()), int(x.min()),
                int(x.max())) == rect
    for (b, tr, tc), order in lists.items():
        want = [k for k, rect in enumerate(rects)
                if rect is not None and per_roi[k]["blk"] == b
                and rect[0] <= tr * TILE + TILE - 1 and rect[1] >= tr * TILE
                and rect[2] <= tc * TILE + TILE - 1 and rect[3] >= tc * TILE]
        assert order == want
    assert sum(map(len, lists.values())) > 0
    if kind == "piled":
        assert max(map(len, lists.values())) > 64
    # the plain form of the lists
    on, row_tile = P.bwd_tile_lists(rois, geom, scale, o, r, table.layout)
    for (b, tr, tc), order in lists.items():
        first, h, w, tile0, tcols = blocks[b][:5]
        t = tile0 + tr * tcols + tc
        assert torch.nonzero(on[t])[:, 0].tolist() == order
        y, x = tr * TILE, tc * TILE
        assert int(row_tile[first + y * w + x]) == t


def _table_grad_from_jax(grads, images):
    return torch.cat([torch.from_numpy(np.asarray(gl[i], np.float32))
                      .reshape(-1, gl.shape[-1])
                      for i in range(images) for gl in grads])


@pytest.mark.parametrize("kind,pad_pixels,o", [
    ("spread", 0, 7), ("spread", 0, 15), ("spread", 128, 15),
    ("degenerate", 0, 7), ("degenerate", 0, 15), ("large", 0, 7),
    ("large", 0, 15), ("piled", 0, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_order_against_plain_and_jax(kind, pad_pixels, o, dtype):
    maps = _maps(2, dtype=dtype)
    table = P.level_table(maps, SCALES)
    rois, img, levels = _case(kind, 4, 2, pad_pixels)
    geom, scale = table.geometry(img, levels, pad_pixels)
    n = rois.shape[0]
    up = torch.from_numpy(np.random.RandomState(7).randn(n, o, o, 8)
                          .astype(np.float32)).to(dtype)
    shape = tuple(table.table.shape)
    got = P.roi_align_bwd_ordered(up, rois, geom, scale, shape, o, 2,
                                  table.layout, torch.float32)
    plain = P.roi_align_bwd_plain(up, rois, geom, scale, shape, o, 2)
    scale_ = float(plain.abs().max())
    assert scale_ > 0
    assert float((got - plain).abs().max()) <= REL * scale_
    # in the dtype: the f32 sums rounded once
    assert torch.equal(P.roi_align_bwd_ordered(up, rois, geom, scale, shape,
                                               o, 2, table.layout),
                       got.to(dtype))
    if dtype != torch.float32:
        return
    jdt = jnp.float32

    def f(fs):
        return J.multilevel_roi_align_batched(
            fs, jnp.asarray(rois.numpy()), jnp.asarray(img.numpy()),
            jnp.asarray(levels.numpy()), o, SCALES, 2, pad_pixels)

    _, vjp = jax.vjp(f, [jnp.asarray(m.numpy(), jdt) for m in maps])
    want = _table_grad_from_jax(vjp(jnp.asarray(up.numpy()))[0], 2)
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chunk_size_is_the_least_that_fits(seed):
    """``bwd_chunk_size``: the least ``BWD_CHUNK << k`` whose chunks of the
    lists longer than it fit in the slots, by brute force over every
    step; no list is cut where none fits."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, [40, 300, 3000, 60000][seed], 500)
    parts = int(rng.choice([0, 16, 256, 1024]))
    fits = [BWD_CHUNK << k for k in range(P.BWD_CHUNK_STEPS)
            if sum(-(-n // (BWD_CHUNK << k)) for n in lengths
                   if n > BWD_CHUNK << k) <= parts]
    q = P.bwd_chunk_size(torch.from_numpy(lengths), parts)
    assert q == (fits[0] if fits else BWD_CHUNK << P.BWD_CHUNK_STEPS - 1)
    assert BWD_CHUNK << P.BWD_CHUNK_STEPS - 1 > P.BWD_MAX_ROIS


@pytest.mark.parametrize("q", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_order_sums_long_lists_in_chunks(q, dtype):
    """Where a tile's list is longer than the chunk size, the ordered form
    is, on that tile's rows, its chunks' sums (each the uncut order over
    the chunk's ROIs, from zero) added in chunk order; tiles of short
    lists are the uncut order; all within 1e-4 of the plain backward."""
    maps = _maps(3, dtype=dtype)
    table = P.level_table(maps, SCALES)
    rois, img, levels = _case("piled", 13)
    geom, scale = table.geometry(img, levels)
    n, o = rois.shape[0], 7
    up = torch.from_numpy(np.random.RandomState(14).randn(n, o, o, 8)
                          .astype(np.float32)).to(dtype)
    shape, layout = tuple(table.table.shape), table.layout
    on, row_tile = P.bwd_tile_lists(rois, geom, scale, o, 2, layout)
    lengths = on.sum(1)
    parts = int(sum(-(-int(n_) // q) for n_ in lengths if n_ > q))
    assert parts > 0 and P.bwd_chunk_size(lengths, parts) == q
    got = P.roi_align_bwd_ordered(up, rois, geom, scale, shape, o, 2, layout,
                                  torch.float32, parts)
    uncut = P.roi_align_bwd_ordered(up, rois, geom, scale, shape, o, 2,
                                    layout, torch.float32, 0)
    plain = P.roi_align_bwd_plain(up, rois, geom, scale, shape, o, 2)
    for a in (got, uncut):
        assert float((a - plain).abs().max()) <= REL * float(
            plain.abs().max())
    want = uncut.clone()
    for t in torch.nonzero(lengths > q)[:, 0].tolist():
        rows = torch.nonzero(row_tile == t)[:, 0]
        members = torch.nonzero(on[t])[:, 0]
        acc = None
        for j in range(0, len(members), q):
            k = members[j:j + q]
            part = P.roi_align_bwd_ordered(up[k], rois[k], geom[k], scale[k],
                                           shape, o, 2, layout,
                                           torch.float32, 0)[rows]
            acc = part if acc is None else acc + part
        want[rows] = acc
    assert torch.equal(got, want)
    assert not torch.equal(got, uncut)


def test_kernel_order_is_the_rois_order():
    """The order is the ROIs': the same ROIs in another order give the
    same plain sums to 1e-4, and the ordered form follows the new order
    (a ROI moved to the front adds first)."""
    maps = _maps(5)
    table = P.level_table(maps, SCALES)
    rois, img, levels = _case("piled", 6)
    geom, scale = table.geometry(img, levels)
    n = rois.shape[0]
    up = torch.from_numpy(np.random.RandomState(8).randn(n, 7, 7, 8)
                          .astype(np.float32))
    shape = tuple(table.table.shape)
    a = P.roi_align_bwd_ordered(up, rois, geom, scale, shape, 7, 2,
                                table.layout)
    perm = torch.from_numpy(np.random.RandomState(9).permutation(n))
    b = P.roi_align_bwd_ordered(up[perm], rois[perm], geom[perm],
                                scale[perm], shape, 7, 2, table.layout)
    assert float((a - b).abs().max()) <= REL * float(a.abs().max())
    assert not torch.equal(a, b)


def test_level_table_is_the_per_image_table():
    """The table is bitwise the per-image construction it replaced, and
    the maps' gradients through the three training sites (box and
    template 7x7, search region 35x35 with a 256 px pad) are equal."""
    for dtype in (torch.float32, torch.bfloat16):
        feats = [m.requires_grad_(True) for m in _maps(11, dtype=dtype)]
        new = P.level_table(feats, SCALES)
        c = feats[0].shape[-1]
        old_table = torch.cat([f[i].reshape(-1, c) for i in range(2)
                               for f in feats])
        assert torch.equal(new.table, old_table)
        old = dataclasses.replace(new, table=old_table)
        grads = []
        for tab in (new, old):
            total = 0
            for kind, o, pad in (("spread", 7, 0), ("degenerate", 7, 0),
                                 ("spread", 35, 256)):
                rois, img, levels = _case(kind, 12, 2, pad)
                out = tab.pool(rois, img, levels, o, 2, pad)
                up = torch.from_numpy(np.random.RandomState(o).randn(
                    *out.shape).astype(np.float32)).to(dtype)
                total = total + (out.float() * up.float()).sum()
            grads.append(torch.autograd.grad(total, feats))
        for a, b in zip(*grads):
            assert torch.equal(a, b)
