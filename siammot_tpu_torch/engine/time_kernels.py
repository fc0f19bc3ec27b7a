"""Device time of kernels 6, 1, 2, 7, 4, 10, 5, 3 and 8 at
``chip_smoke.py``'s shapes, for the port found under a given root (this
checkout, or another commit's ``siammot_tpu_torch`` unpacked elsewhere, to
compare two versions on one card).

    python3 siammot_tpu_torch/engine/time_kernels.py [--root DIR]
        [--only predictor]

Kernel 6's three passes at the training shapes (N = 1024 pairs, f32 and
bf16 inputs, the f32 upstream gradient) and at SEARCH_REGION 5's
(75x75 x 15x15 -> 61x61, N = 256, f32; a tree whose search gradient
refuses that size says so), its forward over 128 bf16 slots, and kernel
1 at the three inference sites (37 of 128 slots live), the three
training sites (f32 table, 1024 ROIs each) and the search-region pool at
75x75, kernel 2 at 30x30 x 15x15 -> 16x16 and 75x75 -> 61x61 (bf16, 37
of 128 slots live), kernel 7 at the three training sites (f32 upstream
gradient, 1024 ROIs each), and the decode: kernel 4 at s_hi 256 and 464
(37 of 128 slots live), kernel 10 at [128, 4, 16, 16] and kernel 5 at
s_hi 976 (stripe 16), gated and ungated; kernel 3 at 16x16 bf16 with 37
and with 128 of 128 slots live, at 29x29 and 61x61 bf16 and at 16x16 f32,
and kernel 8 (B 8, 37 live slots at the front) at 16x16 bf16 and f32 and
61x61 bf16, each also split by kernel (tower conv, head pass; profiler);
then the bf16 DLA-34 frames' gap to the JAX step's bf16 rows
(``tests/fixtures/torch_golden_dla34_bf16.npz`` of this checkout).
``--only predictor`` times kernels 3 and 8 and the gap alone. Each is
checked against its plain version and timed with ``chip_smoke.py``'s two
timers:
``device_ms`` (a CUDA graph of the calls, replayed between events) and
``timed_ms`` (events around the wrapper calls, the host's enqueue
included). Prints one line a kernel with a digest of its outputs' bits
(equal digests in two trees: the same bits) and, last, ``RESULT`` and a
JSON object {name: [device ms, host-inclusive ms, max abs err, digest]}
(kernels 3 and 8 add {kernel: device ms}).
Needs a CUDA device; the card's name and power limit go first.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the siammot_tpu_torch to time")
    ap.add_argument("--only", choices=("predictor",),
                    help="time kernels 3 and 8 (and the bf16 gap) alone")
    args_ = ap.parse_args()
    root = os.path.abspath(args_.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import siammot_tpu_torch
    if not siammot_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"time_kernels: imported {siammot_tpu_torch.__file__}"
                         f", not the package under {root}")

    dev = torch.device("cuda", 0)
    cs.log(f"{cs.card_line()}; timing {root}")
    out = {}

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def record(name, fn, err, iters=20, split=False):
        bits = digest(*(lambda o: o if isinstance(o, tuple) else (o,))(fn()))
        out[name] = (cs.device_ms(fn, iters=iters), cs.timed_ms(fn), err,
                     bits)
        by = cs.kernel_split_ms(fn, iters=min(iters, 10)) if split else {}
        if by:
            out[name] += (by,)
        cs.log(f"  {name}: {out[name][0]:.4f} ms device, {out[name][1]:.4f} "
               f"ms with the host's enqueue, max abs err {err:.3g}, digest "
               f"{bits}" + (f"; by kernel: {cs.split_text(by)}" if by else ""))

    if args_.only != "predictor":
        other_kernels(cs, dev, record)
    predictor_kernels(cs, dev, record)
    print("RESULT " + json.dumps(out), flush=True)


def predictor_kernels(cs, dev, record):
    """Kernels 3 and 8 at chip_smoke's shapes, then the bf16 frames' gap
    to the JAX bf16 rows."""
    import torch
    from siammot_tpu_torch.ops.predictor import (emm_predictor,
                                                 emm_predictor_blocked,
                                                 emm_predictor_blocked_plain,
                                                 emm_predictor_plain)
    from siammot_tpu_torch.utils import golden

    def close(got, want, dtype, what):
        tol = cs.PRED_ATOL if dtype == torch.bfloat16 else cs.PRED_F32_ATOL
        return max(cs.close(a, b, tol, 0.0, what)[0]
                   for a, b in zip(got, want))

    g = torch.Generator().manual_seed(6)
    for s_, dtype, live in ((16, torch.bfloat16, cs.LIVE),
                            (16, torch.bfloat16, cs.K),
                            (29, torch.bfloat16, cs.LIVE),
                            (61, torch.bfloat16, cs.LIVE),
                            (16, torch.float32, cs.LIVE)):
        x = torch.randn(cs.K, s_, s_, cs.C, generator=g).to(dev, dtype)
        params = cs.predictor_params(g, dev, dtype)
        valid = cs.live_mask(cs.K, live, g, dev)
        args = (x, valid, params)
        err = close(emm_predictor(*args), emm_predictor_plain(*args), dtype,
                    f"emm_predictor {s_}")
        record(f"emm_predictor {s_}x{s_} {str(dtype)[6:]} {live} live",
               lambda: emm_predictor(*args), err,
               iters=20 if s_ < 61 else 5, split=True)
    valid = torch.zeros(cs.K, dtype=torch.bool, device=dev)
    valid[:cs.LIVE] = True
    for s_, dtype in ((16, torch.bfloat16), (16, torch.float32),
                      (61, torch.bfloat16)):
        x = torch.randn(cs.K, s_, s_, cs.C, generator=g).to(dev, dtype)
        params = cs.predictor_params(g, dev, dtype)
        args = (x, valid, params, 8)
        err = close(emm_predictor_blocked(*args),
                    emm_predictor_blocked_plain(*args), dtype,
                    f"emm_predictor_blocked {s_}")
        record(f"emm_predictor_blocked {s_}x{s_} {str(dtype)[6:]} B=8 "
               f"{cs.LIVE} live", lambda: emm_predictor_blocked(*args), err,
               iters=20 if s_ < 61 else 5, split=True)
    del x, args
    torch.cuda.empty_cache()
    gap = golden.matched_gap(golden.run(str(dev), "bfloat16"),
                             golden.load(os.path.join(
                                 REPO, "tests", "fixtures",
                                 "torch_golden_dla34_bf16.npz")))
    cs.log(f"  bf16 DLA-34 frames against the JAX bf16 rows: "
           f"{cs.gap_text(gap)}")


def other_kernels(cs, dev, record):
    """Kernels 6, 1, 7, 2, 4, 10 and 5 at chip_smoke's shapes."""
    import torch
    from siammot_tpu_torch.ops.window_pool import (window_pool,
                                                   window_pool_bwd,
                                                   window_pool_bwd_plain,
                                                   window_pool_plain)
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_masked,
                                             xcorr_depthwise_plain,
                                             xcorr_grad_search,
                                             xcorr_grad_search_plain,
                                             xcorr_grad_template)
    g = torch.Generator().manual_seed(1)
    n, c = cs.N_TRAIN, cs.C
    for dtype in (torch.float32, torch.bfloat16):
        search = torch.randn(n, 30, 30, c, generator=g).to(dev, dtype)
        tmpl = (0.1 * torch.randn(n, 15, 15, c, generator=g)).to(dev, dtype)
        up = torch.randn(n, 16, 16, c, generator=g).to(dev)
        for name, fn, plain, args in (
                ("forward", xcorr_depthwise, xcorr_depthwise_plain,
                 (search, tmpl)),
                ("grad_template", xcorr_grad_template, xcorr_depthwise_plain,
                 (search, up)),
                ("grad_search", xcorr_grad_search, xcorr_grad_search_plain,
                 (up, tmpl))):
            err = cs.close(fn(*args), plain(*args), cs.POOL_ATOL,
                           cs.POOL_RTOL, name)[0]
            record(f"xcorr {name} N={n} {str(dtype)[6:]}",
                   lambda: fn(*args), err, iters=10)
        del search, tmpl, up
        torch.cuda.empty_cache()
    search = torch.randn(cs.K, 30, 30, c, generator=g).to(dev, torch.bfloat16)
    tmpl = (0.1 * torch.randn(cs.K, 15, 15, c, generator=g)).to(
        dev, torch.bfloat16)
    err = cs.close(xcorr_depthwise(search, tmpl),
                   xcorr_depthwise_plain(search, tmpl), cs.POOL_ATOL,
                   cs.POOL_RTOL, "xcorr forward, 128 slots")[0]
    record(f"xcorr forward {cs.K} slots bfloat16",
           lambda: xcorr_depthwise(search, tmpl), err)
    del search, tmpl
    # the three passes at SEARCH_REGION 5's shapes
    n_sr = 256
    search = torch.randn(n_sr, 75, 75, c, generator=g).to(dev)
    tmpl = (0.1 * torch.randn(n_sr, 15, 15, c, generator=g)).to(dev)
    up = torch.randn(n_sr, 61, 61, c, generator=g).to(dev)
    for name, fn, plain, args in (
            ("forward", xcorr_depthwise, xcorr_depthwise_plain,
             (search, tmpl)),
            ("grad_template", xcorr_grad_template, xcorr_depthwise_plain,
             (search, up)),
            ("grad_search", xcorr_grad_search, xcorr_grad_search_plain,
             (up, tmpl))):
        try:
            got = fn(*args)
        except ValueError as e:  # an earlier tree's size limit
            cs.log(f"  xcorr {name} 75x75 N={n_sr} float32: refused ({e})")
            continue
        err = cs.close(got, plain(*args), cs.POOL_ATOL, cs.POOL_RTOL,
                       f"{name} 75x75")[0]
        del got
        record(f"xcorr {name} 75x75 N={n_sr} float32", lambda: fn(*args),
               err, iters=5)
    del search, tmpl, up
    torch.cuda.empty_cache()

    table, sites = cs.pool_inputs(torch.Generator().manual_seed(0), dev)
    for site, (origins, wy, wx, valid) in sites.items():
        args = (table, origins, wy, wx, valid)
        record(f"window_pool {site}", lambda: window_pool(*args),
               cs.check_pool(args, site)[0])
    table, sites = cs.train_pool_inputs(torch.Generator().manual_seed(1),
                                        dev)
    shape = tuple(table.shape)
    g = torch.Generator().manual_seed(2)
    for site, (origins, wy, wx) in sites.items():
        args = (table, origins, wy, wx, None)
        err = cs.close(window_pool(*args), window_pool_plain(*args),
                       cs.POOL_ATOL, cs.POOL_RTOL, site)[0]
        record(f"window_pool training {site}", lambda: window_pool(*args),
               err, iters=10)
        s = wy.shape[1]
        bargs = (torch.randn(len(wy), s, s, c, generator=g).to(dev), origins,
                 wy, wx, shape)
        err = cs.close(window_pool_bwd(*bargs), window_pool_bwd_plain(*bargs),
                       cs.POOL_ATOL, cs.POOL_RTOL, f"{site} backward")[0]
        record(f"window_pool_bwd training {site}",
               lambda: window_pool_bwd(*bargs), err, iters=10)
        del bargs
    del table, sites

    # kernel 2 at the default search region and at SEARCH_REGION 5
    g = torch.Generator().manual_seed(3)
    for hs in (30, 75):
        valid = cs.live_mask(cs.K, cs.LIVE, g, dev)
        search = torch.randn(cs.K, hs, hs, c, generator=g).to(
            dev, torch.bfloat16)
        tmpl = (0.1 * torch.randn(cs.K, 15, 15, c, generator=g)).to(
            dev, torch.bfloat16)
        args = (search, tmpl, valid)
        got = xcorr_depthwise_masked(*args)
        cs.dead_zero(got, valid, f"xcorr_masked {hs}")
        err = cs.close(got, xcorr_depthwise_plain(*args), cs.POOL_ATOL,
                       cs.POOL_RTOL, f"xcorr_masked {hs}")[0]
        record(f"xcorr_masked {hs}x{hs} -> {hs - 14}x{hs - 14} {cs.LIVE} "
               f"live bfloat16", lambda: xcorr_depthwise_masked(*args), err)
    del search, tmpl, args, got
    torch.cuda.empty_cache()
    # the search-region pool at 75x75 (SEARCH_REGION 5), as phase 2e
    from siammot_tpu_torch.core.boxes import map_rois_to_levels
    from siammot_tpu_torch.models.emm import EMMConfig, make_search_region
    from siammot_tpu_torch.ops.roi_align_windowed import (pack_levels,
                                                          window_geometry)
    g = torch.Generator().manual_seed(4)
    feats = [torch.randn(1, h, w, c, generator=g).to(dev)
             for h, w in cs.FPN_HW]
    pack = pack_levels(feats, cs.SCALES, dtype=torch.bfloat16)
    ecfg = EMMConfig(15, cs.SCALES, 2, 5.0, 0, 512, True, 0.4, False)
    tb = cs.track_boxes(cs.K, g)
    block = map_rois_to_levels(tb, 2, 5).to(dev)
    scales = torch.tensor(cs.SCALES, device=dev)[block.long()]
    geo = window_geometry(pack.heights, pack.widths, pack.row_offsets,
                          make_search_region(tb, ecfg).to(dev), block,
                          scales, 75, 2, 128, 512, 4)
    args = (pack.table, *geo, cs.live_mask(cs.K, cs.LIVE, g, dev))
    record("window_pool sr_pool 75x75", lambda: window_pool(*args),
           cs.check_pool(args, "sr_pool 75x75")[0])
    del pack, feats, args

    # kernels 4 (s_hi 256 and the AOT recipe's 464), 10 and 5 (s_hi 976)
    from siammot_tpu_torch.ops.decode import (emm_decode, emm_decode_plain,
                                              emm_decode_striped,
                                              emm_decode_striped_plain,
                                              emm_decode_unmasked)
    g = torch.Generator().manual_seed(5)
    for s_ in (16, 29):
        args = (*cs.decode_inputs(g, dev, s_),
                cs.live_mask(cs.K, cs.LIVE, g, dev), 0.4, True)
        err = cs.compare_decode(emm_decode(*args), emm_decode_plain(*args),
                                args, f"emm_decode s_hi={16 * s_}")
        record(f"emm_decode s_hi={16 * s_} {cs.LIVE} live",
               lambda: emm_decode(*args), err)
    args = cs.decode_inputs(g, dev, 16)
    err = cs.compare_decode(emm_decode_unmasked(*args, 0.4, True),
                            emm_decode_plain(*args, None, 0.4, True),
                            (*args, None, 0.4, True), "emm_decode_unmasked")
    record(f"emm_decode_unmasked s_hi=256 {cs.K} slots",
           lambda: emm_decode_unmasked(*args, 0.4, True), err)
    args = cs.decode_inputs(g, dev, 61)
    for valid in (cs.live_mask(cs.K, cs.LIVE, g, dev), None):
        a7 = (*args, valid, 0.4, True)
        err = cs.compare_decode(emm_decode_striped(*a7, 16),
                                emm_decode_striped_plain(*a7, 16), a7,
                                "emm_decode_striped s_hi=976")
        record(f"emm_decode_striped s_hi=976 stripe=16 "
               f"{'gated' if valid is not None else 'ungated'}",
               lambda: emm_decode_striped(*a7, 16), err, iters=5)


if __name__ == "__main__":
    main()
