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
``--only predictor`` times kernels 3 and 8 and the gap alone.
``--only deform_bwd`` times kernel 9's backward alone
(``ops/deform_conv.py:deform_conv2d_bwd``): at phase 2d's stage shapes
(batch 1; stride 2, stride 1 in and out of the window; bf16 and f32) and
at the 26 deformable layers of a DLA-102-DCN training step (4 x 736x1280
bf16, seeded inputs), each split by kernel, and the step's sum.
``--only roi_align`` times the exact gather pooler's two kernels
(``ops/cuda/roi_align.cu``) at phase 11a's sites: the AOT step's three
training sites (1024 ROIs each over four 2464x2048 frames' levels, bf16
and f32; the forward, and the backward on a seeded upstream gradient,
bitwise over two calls) and the 720p inference sites (bf16, 37 of 128
slots live), with the bf16 step's sums, then the same training sites in
bf16 with the ROIs piled up: each frame's 256 box-head ROIs and 256
track pairs around one object, as a step samples them around a few.
``--only xcorr_grad`` times kernel 6's template gradient
(``ops/xcorr.py:xcorr_grad_template``) at the default training shape (30x30
search, 16x16 upstream gradient, N = 1024, bf16 and f32 search), the AOT
recipe's (35x35 with 29x29, N = 1024, bf16 search), SEARCH_REGION 5's
(75x75 with 61x61, N = 256, f32 and bf16 search), its training step's
(N = 1024, bf16 search) and POOLER_RESOLUTION 20's (40x40 with 21x21,
a 20x20 output, N = 1024, bf16 search), the gradient f32 throughout,
each beside ``F.conv2d`` (f32, groups = N*C) and its bound; the routed
kernel, JAX's f32 order and the exact correlation against one another
at 35/29 and 75/61 on the card test's inputs; then the AOT recipe's
other two kernel-6 passes, the forward (35x35 by 7x7) and the search
gradient (29x29 with 7x7), bf16 as its step runs them, each beside its
PyTorch call (``F.conv2d`` on the same bf16 inputs, ``F.conv_transpose2d``
of the f32 gradient by the template in f32; groups = N*C), which of the
two is faster and by what factor.  At the default
shape, whose route is ``xcorr6_kernel``, the tensor-core kernel is timed
beside it.
Each is
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
    ap.add_argument("--only", choices=("predictor", "deform_bwd",
                                       "roi_align", "xcorr_grad"),
                    help="time kernels 3 and 8 (and the bf16 gap), kernel "
                    "9's backward, the gather pooler's kernels or kernel "
                    "6's template gradient alone")
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
            t = t.detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            h.update(t.numpy().tobytes())
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
        return out[name]

    if args_.only == "deform_bwd":
        deform_bwd_kernels(cs, dev, record)
    elif args_.only == "roi_align":
        roi_align_kernels(cs, dev, record)
    elif args_.only == "xcorr_grad":
        xcorr_grad_kernels(cs, dev, record)
    else:
        if args_.only != "predictor":
            other_kernels(cs, dev, record)
        predictor_kernels(cs, dev, record)
    print("RESULT " + json.dumps(out), flush=True)


def xcorr_grad_kernels(cs, dev, record):
    """Kernel 6's template gradient at the training shapes, each beside
    ``F.conv2d`` and its bound (:func:`chip_smoke.template_grad_bound`),
    and held to the exact correlation (a tree without
    ``xcorr_depthwise_exact``: to its plain version); its accuracy
    readings (:func:`template_grad_accuracy`); then the AOT recipe's
    forward and search gradient beside their bounds and their PyTorch
    calls, ``F.conv2d`` and ``F.conv_transpose2d`` grouped by slot and
    channel (``groups`` = N * C)."""
    import torch
    import torch.nn.functional as F
    import siammot_tpu_torch.ops.xcorr as xc
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                             xcorr_depthwise_plain,
                                             xcorr_grad_search,
                                             xcorr_grad_search_plain,
                                             xcorr_grad_template)
    exact = getattr(xc, "xcorr_depthwise_exact", xcorr_depthwise_plain)
    g = torch.Generator().manual_seed(9)
    c = cs.C
    bf, f32 = torch.bfloat16, torch.float32
    for what, n, hs, hg, sdt in (("default", 1024, 30, 16, bf),
                                 ("default", 1024, 30, 16, f32),
                                 ("AOT", 1024, 35, 29, bf),
                                 ("SEARCH_REGION 5", 256, 75, 61, f32),
                                 ("SEARCH_REGION 5", 256, 75, 61, bf),
                                 ("SEARCH_REGION 5 step", 1024, 75, 61, bf),
                                 ("POOLER_RESOLUTION 20", 1024, 40, 21, bf)):
        s = torch.randn(n, hs, hs, c, generator=g).to(dev, sdt)
        up = torch.randn(n, hg, hg, c, generator=g).to(dev)
        err = cs.close(xcorr_grad_template(s, up), exact(s, up),
                       cs.POOL_ATOL, cs.POOL_RTOL, f"grad_template {what}")[0]
        torch.cuda.empty_cache()
        ms = record(f"xcorr grad_template {what} {hs}x{hs} g {hg}x{hg} "
                    f"N={n} {str(sdt)[6:]}", lambda: xcorr_grad_template(
                        s, up), err, iters=5)[0]
        s_nchw = s.float().permute(0, 3, 1, 2).reshape(1, n * c, hs, hs)
        g_w = up.permute(0, 3, 1, 2).reshape(n * c, 1, hg, hg)
        lms = cs.timed_ms(lambda: F.conv2d(s_nchw, g_w, groups=n * c),
                          iters=5, warmup=1)
        bms, by = cs.template_grad_bound(s, up)
        cs.log(f"    F.conv2d {lms:.4f} ms; bound {bms:.4f} ms ({by}); "
               f"kernel {ms / bms:.2f}x its bound")
        if hg == 16 and hasattr(xc, "_grad_template_mma"):
            # the default shape routes to xcorr6_kernel: the tensor-core
            # kernel beside it in the same call
            err = cs.close(xc._grad_template_mma(s, up), exact(s, up),
                           cs.POOL_ATOL, cs.POOL_RTOL,
                           f"grad_template mma {what}")[0]
            record(f"xcorr grad_template {what} on the tensor cores (not "
                   f"routed) N={n} {str(sdt)[6:]}",
                   lambda: xc._grad_template_mma(s, up), err, iters=5)
        del s, up, s_nchw, g_w
        torch.cuda.empty_cache()
    if exact is not xcorr_depthwise_plain:
        template_grad_accuracy(cs, dev, exact)
    # the AOT recipe's other two passes: search and template bf16, the
    # upstream gradient f32
    n = 1024
    s = torch.randn(n, 35, 35, c, generator=g).to(dev, bf)
    t = (0.1 * torch.randn(n, 7, 7, c, generator=g)).to(dev, bf)
    up = torch.randn(n, 29, 29, c, generator=g).to(dev)
    macs = n * 29 * 29 * 7 * 7 * c
    # the one PyTorch call of each, channels first and grouped by slot and
    # channel (the layouts made outside the timed call): the forward
    # F.conv2d on the same bf16 search and template, the search gradient
    # F.conv_transpose2d of the f32 gradient by the template in f32 (the
    # call takes one dtype)
    t_w = t.permute(0, 3, 1, 2).reshape(n * c, 1, 7, 7)
    s_nchw = s.permute(0, 3, 1, 2).reshape(1, n * c, 35, 35)
    up_nchw = up.permute(0, 3, 1, 2).reshape(1, n * c, 29, 29)
    t_w32 = t_w.float()

    def nhwc(x, h):
        return x.reshape(n, c, h, h).permute(0, 2, 3, 1)
    for name, fn, plain, args, nbytes, lib, call in (
            ("forward", xcorr_depthwise, xcorr_depthwise_plain, (s, t),
             n * c * ((35 * 35 + 49) * 2 + 29 * 29 * 4), "F.conv2d",
             lambda: F.conv2d(s_nchw, t_w, groups=n * c)),
            ("grad_search", xcorr_grad_search, xcorr_grad_search_plain,
             (up, t), n * c * (29 * 29 * 4 + 49 * 2 + 35 * 35 * 4),
             "F.conv_transpose2d",
             lambda: F.conv_transpose2d(up_nchw, t_w32, groups=n * c))):
        want = plain(*args)
        err = cs.close(fn(*args), want, cs.POOL_ATOL, cs.POOL_RTOL,
                       f"AOT {name}")[0]
        ms = record(f"xcorr {name} AOT N={n} bfloat16", lambda: fn(*args),
                    err, iters=5)[0]
        got = nhwc(call(), want.shape[1]).float()
        lerr = float((got - want.float()).abs().max())
        lms = cs.timed_ms(call, iters=5, warmup=1)
        bms, by = cs.bound(nbytes, 2.0 * macs, cs.F32_FLOPS)
        faster = "the kernel" if ms < lms else lib
        cs.log(f"    {lib} {lms:.4f} ms (max abs diff to the plain version "
               f"{lerr:.3g}); {faster} faster by "
               f"{max(ms, lms) / min(ms, lms):.2f}x; bound {bms:.4f} ms "
               f"({by}); kernel {ms / bms:.2f}x its bound")
        del got, want
    del s, t, up, t_w, s_nchw, up_nchw, t_w32
    torch.cuda.empty_cache()


def template_grad_accuracy(cs, dev, exact):
    """The template gradient as routed (``xcorr_grad_template``), the
    plain version's f32 sums in JAX's order and the exact correlation
    (``exact``), pairwise, on the inputs of ``tests/test_torch_cuda.py::
    test_xcorr_grad_template_kernel`` (3 slots, 128 channels, N(0, 1), the
    gradient f32, the search bf16 or f32) at the AOT recipe's 35/29 and
    SEARCH_REGION 5's 75/61: the largest difference, the largest ratio
    of the difference to the card tests' tolerance (atol 1e-4 + rtol 1e-3
    of the second of the pair; past 1, ``assert_close`` fails) and the
    elements past it."""
    import torch
    from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise_plain,
                                             xcorr_grad_template)
    k, c = 3, 128
    for hs, hg in ((35, 29), (75, 61)):
        for sdt in (torch.bfloat16, torch.float32):
            g = torch.Generator().manual_seed(hs * hs + hg + c + k)
            s = torch.randn(k, hs, hs, c, generator=g).to(dev, sdt)
            up = torch.randn(k, hg, hg, c, generator=g).to(dev)
            got = {"kernel": xcorr_grad_template(s, up),
                   "JAX-order f32": xcorr_depthwise_plain(s, up),
                   "exact": exact(s, up)}
            for a, b in (("kernel", "JAX-order f32"), ("kernel", "exact"),
                         ("JAX-order f32", "exact")):
                d = (got[a].double() - got[b].double()).abs()
                r = d / (cs.POOL_ATOL + cs.POOL_RTOL * got[b].double().abs())
                cs.log(f"  accuracy {hs}/{hg} search {str(sdt)[6:]}: {a} "
                       f"against {b}: max abs diff {float(d.max()):.4g}, "
                       f"{float(r.max()):.4f} of the tolerance, "
                       f"{int((r > 1).sum())} elements past it")


def deform_bwd_kernels(cs, dev, record):
    """Kernel 9's backward at phase 2d's stage shapes and at a DLA-102-DCN
    training step's 26 layers (offsets N(0, 0.8^2) at stride 2, N(0,
    0.35^2) at stride 1, as 2d's), then the step's sum of device ms."""
    import torch
    import siammot_tpu_torch.ops.deform_conv as dc
    from siammot_tpu_torch.ops.deform_conv import deform_conv2d_bwd
    g = torch.Generator().manual_seed(5)

    def sweep(x, off, gr, stride):
        """The bf16 dKernel product alone over chunk counts (a tree with
        the product), beside the planner's pick."""
        if x.dtype != torch.bfloat16 or not hasattr(dc, "pixel_splits"):
            return
        n, c = off.shape[0] * off.shape[1] * off.shape[2], x.shape[3]
        steps = -(-n // dc.DK_PIXELS)
        times = {s_: cs.device_ms(lambda: dc._bwd_dkernel(
            x, off, gr, stride, 1, s_), iters=5)
            for s_ in (1, 2, 3, 5, 7, 10, 14, 20, 28) if s_ <= steps}
        cs.log(f"    dKernel product by chunks: " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()) + f" ms device; "
            f"pixel_splits picks {dc.pixel_splits(n, c, gr.shape[-1])}")

    def inputs(b, h, w, c, stride, scale, dtype):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        x = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
        off = (scale * torch.randn(b, ho, wo, 18, generator=g)).to(dev,
                                                                  dtype)
        k = (torch.randn(3, 3, c, c, generator=g) / (9 * c) ** 0.5).to(
            dev, dtype)
        gr = torch.randn(b, ho, wo, c, generator=g).to(dev, dtype)
        return x, off, k, gr

    for stage, (h, w), c, _, _ in cs.DCN_STAGES:
        for dtype in (torch.bfloat16, torch.float32):
            for stride, scale, (hi, wi) in ((2, 0.8, (h, w)),
                                            (1, 0.35, (h // 2, w // 2)),
                                            (1, 2.0, (h // 2, w // 2))):
                x, off, k, gr = inputs(1, hi, wi, c, stride, scale, dtype)
                record(f"deform_bwd stage{stage} {hi}x{wi}x{c} s{stride} "
                       f"offsets {scale} {str(dtype).split('.')[-1]}",
                       lambda: deform_conv2d_bwd(x, off, k, gr, stride), 0.0,
                       iters=5, split=True)
                if scale != 2.0:
                    sweep(x, off, gr, stride)
                del x, off, k, gr
    step = 0.0
    for (h, w, c, stride), count in (((184, 320, 128, 2), 1),
                                     ((92, 160, 128, 1), 7),
                                     ((92, 160, 256, 2), 1),
                                     ((46, 80, 256, 1), 15),
                                     ((46, 80, 512, 2), 1),
                                     ((23, 40, 512, 1), 1)):
        x, off, k, gr = inputs(4, h, w, c, stride, 0.8 if stride == 2
                               else 0.35, torch.bfloat16)
        step += count * record(
            f"deform_bwd training layer 4x{h}x{w}x{c} s{stride} (x{count})",
            lambda: deform_conv2d_bwd(x, off, k, gr, stride), 0.0, iters=5,
            split=True)[0]
        sweep(x, off, gr, stride)
        del x, off, k, gr
    cs.log(f"  deform_bwd, the training step's 26 layers: {step:.4f} ms "
           "device")


def roi_align_kernels(cs, dev, record):
    """The gather pooler's forward and backward at phase 11a's sites (its
    seeds), each checked against its plain version, then the bf16 AOT
    step's sums over its three sites and the inference frame's; then the
    bf16 training sites with the ROIs piled up (:func:`piled_boxes`) and
    their sums."""
    import torch
    from siammot_tpu_torch.ops.roi_align import roi_align_fwd
    g = torch.Generator().manual_seed(11)
    gc = torch.Generator(device=dev).manual_seed(11)
    step = {}
    for dtype in (torch.bfloat16, torch.float32):
        sites, layout = cs.roi_training_sites(g, gc, dev, dtype)
        roi_training_kernels(cs, dev, record, sites, layout, gc, "training",
                             step if dtype == torch.bfloat16 else {})
        del sites
        torch.cuda.empty_cache()
    for site, args in cs.roi_inference_sites(g, dev).items():
        what = f"inference {site} bfloat16"
        step["frame"] = step.get("frame", 0.0) + record(
            f"roi_align_fwd {what}", lambda: roi_align_fwd(*args),
            cs.check_roi_align(args, what))[0]
    cs.log(f"  gather pooler, the bf16 AOT step's three sites: forward "
           f"{step['fwd']:.4f} ms, backward {step['bwd']:.4f} ms device; "
           f"the inference frame's three: forward {step['frame']:.4f} ms")
    g = torch.Generator().manual_seed(12)
    gc = torch.Generator(device=dev).manual_seed(12)
    piled = {}
    sites, layout = cs.roi_training_sites(g, gc, dev, torch.bfloat16,
                                          piled_boxes(cs, g))
    roi_training_kernels(cs, dev, record, sites, layout, gc, "piled", piled)
    cs.log(f"  gather pooler, the bf16 AOT step's three sites piled up: "
           f"forward {piled['fwd']:.4f} ms, backward {piled['bwd']:.4f} ms "
           "device")


def roi_training_kernels(cs, dev, record, sites, layout, gc, kind, step):
    """The gather forward and backward (on a seeded upstream gradient) at
    each of ``sites``, checked and timed, the backward's longest tile list
    logged; their device ms summed into ``step``."""
    import torch
    from siammot_tpu_torch.ops.roi_align import roi_align_bwd, roi_align_fwd
    for site, args in sites.items():
        dtype = args[0].dtype
        what = f"{kind} {site} {str(dtype).split('.')[-1]}"
        fms = record(f"roi_align_fwd {what}", lambda: roi_align_fwd(*args),
                     cs.check_roi_align(args, what), iters=5)[0]
        out = roi_align_fwd(*args)
        grad = torch.randn(out.shape, generator=gc, device=dev,
                           dtype=torch.float32).to(dtype)
        del out
        bargs = cs.roi_bwd_args(args, grad, layout)
        bms = record(f"roi_align_bwd {what}", lambda: roi_align_bwd(*bargs),
                     cs.check_roi_align_bwd(bargs, f"{what} backward"),
                     iters=5)[0]
        most, mean = cs.roi_tile_counts(bargs)
        cs.log(f"    ROIs a table tile: max {most}, mean {mean:.1f}")
        step["fwd"] = step.get("fwd", 0.0) + fms
        step["bwd"] = step.get("bwd", 0.0) + bms
        del grad, bargs


def piled_boxes(cs, g):
    """(box-head ROIs, template boxes), 1024 each, piled up as a training
    step samples them around a few objects: one object a frame (60-150 x
    120-300 px, seeded, inside the AOT frame), and each frame's 256
    templates and 256 proposals around it, their centres moved and their
    sides scaled by N(0, 0.05^2) (templates) and N(0, 0.2^2) (proposals)
    of its size."""
    import torch
    per = cs.N_TRAIN // 4
    sz = torch.tensor([60.0, 120.0]) + torch.tensor([90.0, 180.0]) \
        * torch.rand(4, 2, generator=g)
    ctr = sz / 2 + torch.rand(4, 2, generator=g) * (
        torch.tensor(cs.AOT_FRAME, dtype=torch.float32) - sz)
    ctr, sz = ctr.repeat_interleave(per, 0), sz.repeat_interleave(per, 0)

    def around(jitter):
        c = ctr + jitter * sz * torch.randn(ctr.shape, generator=g)
        s = sz * torch.exp(jitter * torch.randn(sz.shape, generator=g))
        return torch.cat([c - s / 2, c + s / 2], 1)

    return around(0.2), around(0.05)


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
