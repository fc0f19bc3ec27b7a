"""Device time of kernels 6, 1, 2 and 7 at ``chip_smoke.py``'s shapes, for
the port found under a given root (this checkout, or another commit's
``siammot_tpu_torch`` unpacked elsewhere, to compare two versions on one
card).

    python3 siammot_tpu_torch/engine/time_kernels.py [--root DIR]

Kernel 6's three passes at the training shapes (N = 1024 pairs, f32 and
bf16 inputs, the f32 upstream gradient), its forward over 128 bf16
slots, and kernel 1 at the three inference sites (37 of 128 slots live),
the three training sites (f32 table, 1024 ROIs each) and the
search-region pool at 75x75, kernel 2 at 30x30 x 15x15 -> 16x16 and
75x75 -> 61x61 (bf16, 37 of 128 slots live) and kernel 7 at the three
training sites (f32 upstream gradient, 1024 ROIs each). Each is checked
against its plain version and timed with ``chip_smoke.py``'s two timers:
``device_ms`` (a CUDA graph of the calls, replayed between events) and
``timed_ms`` (events around the wrapper calls, the host's enqueue
included). Prints one line a kernel and, last, ``RESULT`` and a JSON
object {name: [device ms, host-inclusive ms, max abs err]}. Needs a CUDA
device; the card's name and power limit go first.
"""

import argparse
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
    root = os.path.abspath(ap.parse_args().root)
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

    dev = torch.device("cuda", 0)
    cs.log(f"{cs.card_line()}; timing {root}")
    out = {}

    def record(name, fn, err, iters=20):
        out[name] = (cs.device_ms(fn, iters=iters), cs.timed_ms(fn), err)
        cs.log(f"  {name}: {out[name][0]:.4f} ms device, {out[name][1]:.4f} "
               f"ms with the host's enqueue, max abs err {err:.3g}")

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
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
