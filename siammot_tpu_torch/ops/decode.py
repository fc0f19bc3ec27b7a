"""Kernels 4, 10 and 5: the EMM response decode (upsample + penalty +
argmax).

All three replace ``siammot_tpu/ops/pallas/decode.py:emm_decode_pallas``:
kernel 4 with ``valid`` in its whole-map form (``_decode_kernel`` through
``_gated_kernel``), kernel 10 without ``valid`` (``_plain_kernel``: every
slot decoded, as ``TPU.MASKED_TRACK_KERNELS`` False asks), kernel 5 in its
row-striped form (``_decode_kernel_striped``), which JAX takes for
``512 < s_hi <= 1024`` and tests force with ``stripe``.  Per slot: the
x16 bicubic upsample ``U . X . U^T`` of 4 channels,
``sigmoid(diff) * sigmoid(ctr)``, the scale/ratio penalty with raw IEEE
divisions, the Hann blend, then the first-occurrence argmax and the cls
probability there.  Gated dead slots return (0, 0).

On the H100 the decode is bound by operations on the CUDA cores, in f32:
4.2 M multiply-adds per slot at the main path's s_hi 256 (247 M at s_hi
976) and, per cell, the penalty's divisions and exponentials, about as
much again at s_hi 256; the point is that the [s_hi, s_hi] maps never
leave the chip.  One CUDA kernel (``cuda/decode.cu:decode_band_kernel``)
runs all three: a persistent grid over (live slot, band of 16 rows)
items, the slots ordered live first on the device, each item building its
band's row factor in shared memory and passing over the map's columns
with 2 x 4 cells x 4 channels of accumulators a thread; a second launch
reduces each slot's band bests.  Every cell is computed with one
contraction order and the (value, index) bests reduce with ties toward
the lower flat index, so the kernel's (idx, score) are bitwise those of
the earlier whole-map and striped kernels, and the same for any stripe.
Responses up to s = 64 (the striped form's limit, s_hi 1024).  Past
s_hi 1024, or with ``TPU.USE_PALLAS`` or ``DECODE_PALLAS`` False, the
port runs the JAX package's XLA decode in torch ops (:func:`decode_xla`),
as JAX does there.
"""

from __future__ import annotations

import torch

from . import cuda

_ARGS = (cuda.P,) * 8 + (cuda.I,) * 3 + (cuda.F, cuda.F, cuda.I, cuda.P)
WHOLE_MAP_MAX = 512       # JAX's whole-map kernel up to this s_hi
STRIPED_MAX = 1024        # JAX's striped kernel up to this s_hi (emm.py)
BAND_ROWS = 16            # rows of the kernel's band (cuda/decode.cu BAND)
S_MAX = 64                # largest response side the kernel takes


def decode_bands(s_hi: int) -> int:
    """Bands of ``BAND_ROWS`` rows the kernel cuts an [s_hi, s_hi] map
    into (the last one ragged): the scratch rows per slot."""
    return -(-s_hi // BAND_ROWS)


def pick_stripe(s_hi: int) -> int:
    """The stripe JAX picks (``decode.py:_pick_stripe``)."""
    for d in (128, 64, 32, 16, 8):
        if s_hi % d == 0:
            return d
    raise ValueError(f"s_hi={s_hi} has no multiple-of-8 stripe divisor")


def _check(x4, wh, u, window, valid):
    k, four, s, _ = x4.shape
    s_hi = u.shape[0]
    if four != 4 or u.shape != (s_hi, s) or window.shape != (s_hi, s_hi) \
            or wh.shape != (k, 2) or (valid is not None
                                      and valid.shape != (k,)):
        raise ValueError("decode: inconsistent shapes")
    for t in (x4, wh, u, window):
        if t.dtype != torch.float32:
            raise TypeError("decode: x4, wh, u and window must be f32")
    for t in (x4, wh, u, window) + (() if valid is None else (valid,)):
        if t.device != x4.device or not t.is_contiguous():
            raise ValueError("decode: inputs must be contiguous, on one "
                             "device")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError("decode: valid must be bool")
    return k, s, s_hi


def _launch(x4, wh, u, window, valid, sigma, use_centerness):
    """One decode launch (kernels 4, 10 and 5 alike); ``valid`` None
    decodes every slot."""
    k, s, s_hi = _check(x4, wh, u, window, valid)
    if s > S_MAX:
        raise ValueError(f"decode kernel takes s <= {S_MAX}, got {s}")
    cuda.check_extent("emm_decode", x4, window, (k, decode_bands(s_hi), 3))
    partial = torch.empty((k, decode_bands(s_hi), 3), dtype=torch.int32,
                          device=x4.device)
    idx = torch.empty((k,), dtype=torch.int32, device=x4.device)
    score = torch.empty((k,), dtype=torch.float32, device=x4.device)
    fn = cuda.function("siammot_emm_decode", _ARGS)
    # 1 - sigma is rounded from the double, as the reference's Python
    # scalar is, not computed from the f32 sigma
    cuda.check("emm_decode", fn(
        cuda.ptr(x4), cuda.ptr(wh), cuda.ptr(u), cuda.ptr(window),
        None if valid is None else cuda.ptr(valid), cuda.ptr(partial),
        cuda.ptr(idx), cuda.ptr(score), k, s, s_hi, float(sigma),
        float(1.0 - sigma), int(bool(use_centerness)),
        cuda.stream(x4.device)))
    return idx, score


def emm_decode(x4: torch.Tensor, wh: torch.Tensor, u: torch.Tensor,
               window: torch.Tensor, valid: torch.Tensor, sigma: float,
               use_centerness: bool):
    """Kernel 4: penalized-confidence argmax over the upsampled response
    of the live slots.

    x4 [K, 4, s, s] f32 (cls logit difference, centerness logit, l+r,
    t+b); wh [K, 2] f32 template box extents; u [s_hi, s] f32 bicubic
    matrix; window [s_hi, s_hi] f32 Hann window; valid [K] bool.
    Returns (idx [K] int32 flat argmax, score [K] f32 cls probability
    there).  CUDA tensors launch the kernel; CPU tensors take
    :func:`emm_decode_plain`.
    """
    if x4.device.type == "cpu":
        return emm_decode_plain(x4, wh, u, window, valid, sigma,
                                use_centerness)
    if valid is None:
        raise ValueError("emm_decode: kernel 4 is the gated form; "
                         "emm_decode_unmasked decodes every slot")
    out = _launch(x4, wh, u, window, valid, sigma, use_centerness)
    emm_decode.launches += 1
    return out


emm_decode.launches = 0


def emm_decode_unmasked(x4: torch.Tensor, wh: torch.Tensor, u: torch.Tensor,
                        window: torch.Tensor, sigma: float,
                        use_centerness: bool):
    """Kernel 10: :func:`emm_decode` over every slot (no gate): a dead
    slot decodes whatever maps it was given.  CUDA tensors launch the
    kernel; CPU tensors take :func:`emm_decode_plain` with ``valid``
    None."""
    if x4.device.type == "cpu":
        return emm_decode_plain(x4, wh, u, window, None, sigma,
                                use_centerness)
    out = _launch(x4, wh, u, window, None, sigma, use_centerness)
    emm_decode_unmasked.launches += 1
    return out


emm_decode_unmasked.launches = 0


def emm_decode_striped(x4: torch.Tensor, wh: torch.Tensor, u: torch.Tensor,
                       window: torch.Tensor, valid, sigma: float,
                       use_centerness: bool, stripe: int):
    """Kernel 5: the row-striped decode, the same (idx, score) as
    :func:`emm_decode` (gated, ``valid`` [K] bool) or
    :func:`emm_decode_unmasked` (``valid`` None) for any ``stripe``, a
    multiple of 8 up to 128 that divides s_hi; s <= 64.  The kernel's
    bands are its own (the stripe only picks this entry point: the answer
    does not depend on the cut).  CUDA tensors launch the kernel; CPU
    tensors take :func:`emm_decode_striped_plain`.
    """
    _check_stripe(u.shape[0], stripe)
    if x4.device.type == "cpu":
        return emm_decode_striped_plain(x4, wh, u, window, valid, sigma,
                                        use_centerness, stripe)
    out = _launch(x4, wh, u, window, valid, sigma, use_centerness)
    emm_decode_striped.launches += 1
    return out


emm_decode_striped.launches = 0


def _check_stripe(s_hi: int, stripe: int) -> None:
    if stripe < 8 or stripe > 128 or stripe % 8 or s_hi % stripe:
        raise ValueError(f"stripe {stripe} must be a multiple of 8 up to "
                         f"128 that divides s_hi {s_hi}")


def decode_argmax(x4, wh, u, window, valid, sigma, use_centerness,
                  stripe=None, xla=False):
    """The decode the JAX package dispatches to (``models/emm.py:417``):
    its XLA decode (:func:`decode_xla`, every slot, ``valid`` unread) with
    ``xla`` (``TPU.USE_PALLAS`` or ``DECODE_PALLAS`` False) or past s_hi
    1024; else the striped kernel past s_hi 512 or with ``stripe`` given,
    else the whole-map kernel, gated (kernel 4) or not (kernel 10,
    ``valid`` None)."""
    s_hi = u.shape[0]
    if xla or (stripe is None and s_hi > STRIPED_MAX):
        return decode_xla(x4, wh, u, window, sigma, use_centerness)
    if stripe is None and s_hi > WHOLE_MAP_MAX:
        stripe = pick_stripe(s_hi)
    if stripe is not None:
        return emm_decode_striped(x4, wh, u, window, valid, sigma,
                                  use_centerness, stripe)
    if valid is None:
        return emm_decode_unmasked(x4, wh, u, window, sigma, use_centerness)
    return emm_decode(x4, wh, u, window, valid, sigma, use_centerness)


def _row_factor(x4, u):
    """T_c = U . x4_c for every upsampled row, [K, 4, s_hi, s]."""
    return torch.einsum("oh,kchw->kcow", u, x4)


def _cells(t, wh, u, window, sigma, use_centerness, r0, r1):
    """The decode's per-cell math in plain PyTorch over rows [r0, r1)
    from the row factor ``t``: (p_conf, cls_prob), each
    [K, r1 - r0, s_hi] f32."""
    up = torch.einsum("pw,kcow->kcop", u, t[:, :, r0:r1])
    bw = torch.where(wh[:, 0] == 0, torch.ones_like(wh[:, 0]), wh[:, 0])
    bh = torch.where(wh[:, 1] == 0, torch.ones_like(wh[:, 1]), wh[:, 1])
    cls_prob = torch.sigmoid(up[:, 0])
    conf = cls_prob * torch.sigmoid(up[:, 1]) if use_centerness else cls_prob
    # raw IEEE divisions: zero and negative upsampled extents carry
    # meaning (models/emm.py decode_response in the JAX package)
    scale_w = up[:, 2] / bw[:, None, None]
    scale_h = up[:, 3] / bh[:, None, None]
    scale_w = torch.maximum(scale_w, 1.0 / scale_w)
    scale_h = torch.maximum(scale_h, 1.0 / scale_h)
    penalty = torch.exp((-scale_w * scale_h + 1.0) * 0.1)
    return (conf * penalty * (1 - sigma) + sigma * window[None, r0:r1],
            cls_prob)


def penalized_confidence(x4, wh, u, window, sigma, use_centerness):
    """The decode's per-cell math over the whole map: (p_conf, cls_prob),
    each [K, s_hi, s_hi] f32."""
    return _cells(_row_factor(x4, u), wh, u, window, sigma, use_centerness,
                  0, u.shape[0])


def _gate(idx, score, valid):
    idx = idx.to(torch.int32)
    if valid is None:
        return idx, score
    return (torch.where(valid, idx, torch.zeros_like(idx)),
            torch.where(valid, score, torch.zeros_like(score)))


def emm_decode_plain(x4, wh, u, window, valid, sigma, use_centerness):
    """Plain PyTorch version: the XLA fused decode's math (first maximal
    index); with ``valid``, dead slots (0, 0)."""
    k = x4.shape[0]
    p_conf, cls_prob = penalized_confidence(x4, wh, u, window, sigma,
                                            use_centerness)
    idx = torch.argmax(p_conf.reshape(k, -1), dim=1)
    score = torch.gather(cls_prob.reshape(k, -1), 1, idx[:, None])[:, 0]
    return _gate(idx, score, valid)


# slots a chunk of the XLA decode (4 maps of [s_hi, s_hi] f32 each and
# their per-cell temporaries: about 0.3 GB a chunk at s_hi 1088)
XLA_CHUNK = 16


def decode_xla(x4, wh, u, window, sigma, use_centerness):
    """The JAX package's XLA decode (``siammot_tpu/models/emm.py:424-444``)
    in torch ops, over every slot: the two upsampling products (f32
    ``torch.matmul``/``einsum``; the port turns TF32 off), the cls and
    centerness sigmoids, the scale penalty with raw IEEE divisions, the Hann
    blend, the first maximal index and the cls probability there, a chunk
    of slots at a time.  Returns (idx [K] int32, score [K] f32); JAX's XLA
    form reads no ``valid``, so no slot is gated."""
    k = x4.shape[0]
    idx, score = [], []
    for i in range(0, k, XLA_CHUNK):
        p_conf, cls_prob = penalized_confidence(
            x4[i:i + XLA_CHUNK], wh[i:i + XLA_CHUNK], u, window, sigma,
            use_centerness)
        m = p_conf.shape[0]
        j = torch.argmax(p_conf.reshape(m, -1), dim=1)
        idx.append(j)
        score.append(torch.gather(cls_prob.reshape(m, -1), 1,
                                  j[:, None])[:, 0])
    if not idx:
        return (torch.zeros((0,), dtype=torch.int32, device=x4.device),
                torch.zeros((0,), dtype=torch.float32, device=x4.device))
    return torch.cat(idx).to(torch.int32), torch.cat(score)


def emm_decode_striped_plain(x4, wh, u, window, valid, sigma,
                             use_centerness, stripe):
    """Plain PyTorch version of the striped decode: the cells of
    :func:`emm_decode_plain`, a stripe of rows at a time, with a running
    (max, first index, cls) that a later stripe replaces only on a strictly
    larger value (NaN counting as the largest, the first one winning);
    gated dead slots (0, 0) and skipped."""
    _check_stripe(u.shape[0], stripe)
    k, s_hi = x4.shape[0], u.shape[0]
    live = torch.arange(k, device=x4.device) if valid is None \
        else valid.nonzero()[:, 0]
    t, whl = _row_factor(x4[live], u), wh[live]
    n = len(live)
    best_v = torch.full((n,), -float("inf"), device=x4.device)
    best_i = torch.full((n,), s_hi * s_hi, dtype=torch.long,
                        device=x4.device)
    best_c = torch.full((n,), -float("inf"), device=x4.device)
    for r0 in range(0, s_hi, stripe):
        p_conf, cls_prob = _cells(t, whl, u, window, sigma, use_centerness,
                                  r0, r0 + stripe)
        flat = p_conf.reshape(n, stripe * s_hi)
        i = torch.argmax(flat, dim=1) if n else best_i
        v = torch.gather(flat, 1, i[:, None])[:, 0]
        c = torch.gather(cls_prob.reshape(n, stripe * s_hi), 1,
                         i[:, None])[:, 0]
        take = (v.isnan() & ~best_v.isnan()) | (v > best_v)
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i + r0 * s_hi, best_i)
        best_c = torch.where(take, c, best_c)
    idx = torch.zeros((k,), dtype=torch.long, device=x4.device)
    score = torch.zeros((k,), dtype=torch.float32, device=x4.device)
    idx[live] = best_i
    score[live] = best_c
    return _gate(idx, score, valid)
