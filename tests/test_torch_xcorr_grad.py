"""Kernel 6 (unmasked depthwise xcorr and its gradient) of the port
against the JAX package, on the CPU: the plain forward against the Pallas
kernel without ``valid`` in interpret mode, and the port's differentiable
xcorr (its backward's plain versions) against ``jax.vjp`` of
``siammot_tpu.ops.xcorr.xcorr_depthwise_auto``.  Seeded numpy inputs
(N = 3, 12x12 search, 5x5 template, 8 channels); f32 on both sides, sums
in other orders -> atol 1e-5."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.ops.pallas.xcorr import xcorr_depthwise_pallas
from siammot_tpu.ops.xcorr import xcorr_depthwise_auto as jax_xcorr_auto
from siammot_tpu_torch.ops.xcorr import (xcorr_depthwise,
                                         xcorr_depthwise_auto,
                                         xcorr_depthwise_exact,
                                         xcorr_depthwise_plain,
                                         xcorr_grad_search,
                                         xcorr_grad_search_plain,
                                         xcorr_grad_template)

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two CPU threads: the suite runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    s = rng.randn(3, 12, 12, 8).astype(np.float32)
    t = rng.randn(3, 5, 5, 8).astype(np.float32)
    g = rng.randn(3, 8, 8, 8).astype(np.float32)
    return s, t, g


def test_forward_matches_pallas_interpret(inputs):
    s, t, _ = inputs
    want = xcorr_depthwise_pallas(jnp.asarray(s), jnp.asarray(t),
                                  interpret=True)
    got = xcorr_depthwise(torch.from_numpy(s), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (3, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_backward_matches_jax_vjp(inputs):
    s, t, g = inputs
    out, vjp = jax.vjp(jax_xcorr_auto, jnp.asarray(s), jnp.asarray(t))
    want_s, want_t = vjp(jnp.asarray(g))
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    got = xcorr_depthwise_auto(ts, tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=ATOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_s), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_t), rtol=0,
                               atol=ATOL)


def test_gradient_pieces_are_autograd_of_the_plain_xcorr(inputs):
    """Each gradient wrapper's CPU path against autograd through
    ``xcorr_depthwise_plain``; both keep the inputs' dtypes (bf16 in)."""
    s, t, g = inputs
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    xcorr_depthwise_plain(ts, tt).backward(torch.from_numpy(g))
    gt = torch.from_numpy(g)
    torch.testing.assert_close(xcorr_grad_search(gt, torch.from_numpy(t)),
                               ts.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(xcorr_grad_search_plain(gt,
                                                       torch.from_numpy(t)),
                               ts.grad, rtol=0, atol=ATOL)
    torch.testing.assert_close(xcorr_grad_template(torch.from_numpy(s), gt),
                               tt.grad, rtol=0, atol=ATOL)
    sb = torch.from_numpy(s).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
    xcorr_depthwise_auto(sb, tb).backward(gt)
    assert sb.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("hs,ht", [(75, 15), (35, 7)])
def test_backward_past_32_matches_jax_vjp(hs, ht):
    """SEARCH_REGION 5's 75x75 search region with the 15x15 template and
    the AOT recipe's 35x35 with its 7x7 one: search gradients past the
    32x32 the card's kernel once took.  The port's differentiable xcorr
    (its backward's plain versions) and ``xcorr_grad_search_plain``
    against ``jax.vjp`` of the JAX package's ``xcorr_depthwise_auto``; 2
    slots, 4 channels, f32.  Sums of up to 225 (the template gradient: up
    to 3721) products in other orders -> 1e-5 of the largest value."""
    rng = np.random.RandomState(hs + ht)
    ho = hs - ht + 1
    s = rng.randn(2, hs, hs, 4).astype(np.float32)
    t = rng.randn(2, ht, ht, 4).astype(np.float32)
    g = rng.randn(2, ho, ho, 4).astype(np.float32)
    out, vjp = jax.vjp(jax_xcorr_auto, jnp.asarray(s), jnp.asarray(t))
    want_s, want_t = (np.asarray(w) for w in vjp(jnp.asarray(g)))
    ts = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    got = xcorr_depthwise_auto(ts, tt)
    got.backward(torch.from_numpy(g))
    plain_s = xcorr_grad_search_plain(torch.from_numpy(g),
                                      torch.from_numpy(t))
    assert plain_s.shape == (2, hs, hs, 4)
    for name, k, w in (("output", got.detach().numpy(), np.asarray(out)),
                       ("d_search", ts.grad.numpy(), want_s),
                       ("d_search plain", plain_s.numpy(), want_s),
                       ("d_template", tt.grad.numpy(), want_t)):
        np.testing.assert_allclose(k, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


H100_SMEM = 232448   # bytes a block may opt in to on an H100


def test_grad_search_plan():
    """The search gradient's bands and column segments for an H100's
    shared memory: the training shapes (16x16 g, 15x15 taps) keep one band
    in every dtype mix, SEARCH_REGION 3's 45x45 output one band,
    SEARCH_REGION 5's 75x75 bands of 32 rows (16 when both inputs are
    bf16) and five 16-wide segments (the 15-wide template's compile-time
    form), the AOT recipe's 35x35 one band in f32 and bands of 16 when
    both are bf16.  Every plan covers the output with segments of at most
    64 and fits two stages; a gradient too wide for one output row's band
    raises with the limit."""
    from siammot_tpu_torch.ops.xcorr import (W_GEN, _row_stride,
                                             grad_search_plan)
    cases = {(16, 15, 4, 4): (30, 1), (16, 15, 4, 2): (30, 1),
             (16, 15, 2, 2): (30, 1), (31, 15, 4, 2): (45, 1),
             (61, 15, 4, 4): (32, 5), (61, 15, 4, 2): (32, 5),
             (61, 15, 2, 2): (16, 5), (29, 7, 4, 2): (35, 1),
             (29, 7, 2, 2): (16, 1)}
    for (hg, ht, gs, tsz), want in cases.items():
        rows, segs = grad_search_plan(hg, hg, ht, ht, gs, tsz, H100_SMEM)
        assert (rows, segs) == want, (hg, ht, gs, tsz)
        ho = hg + ht - 1
        assert 1 <= rows <= ho and segs * W_GEN >= ho
        assert -(-ho // segs) <= W_GEN
        tile = 16 if gs == tsz == 2 else 8
        rs = _row_stride(hg * tile * gs, 32 // tile, tile * gs)
        stage = min(hg, rows + ht - 1) * rs + ht * ht * tile * tsz
        assert 2 * (-(-stage // 16) * 16) <= H100_SMEM
    with pytest.raises(ValueError, match=str(H100_SMEM)):
        grad_search_plan(61, 2000, 15, 15, 4, 4, H100_SMEM)


# the card's kernel of the template gradient (``cuda/xcorr_grad.cu``):
# its host plan and its arithmetic in plain PyTorch

def split_terms(x, terms):
    """``x`` as ``terms`` bf16 values whose sum is ``x``, as f32: the
    template gradient kernel's split (hi = ``x`` rounded to bf16, to
    nearest with ties away: 0x8000 added to its f32 bits and the low 16
    cleared; then the same of the rest, ...; each difference exact in
    f32).  Three terms hold an f32 exactly (the third's rest is zero); a
    bf16 input is its own one term."""
    out, rest = [], x.float()
    for _ in range(terms):
        bits = rest.view(torch.int32)
        out.append(((bits + 0x8000) & -65536).view(torch.float32))
        rest = rest - out[-1]
    return out


def xcorr_grad_template_split(search, grad, terms=None, order=2):
    """The template gradient kernel's arithmetic in plain PyTorch: the
    search and ``g`` split as the kernel splits them (three bf16 terms an
    f32 input, one a bf16 one, or ``terms`` for both), the products of
    the terms of indices ``ts + tg <= order`` (of order at most
    2^-8``order``) summed in f64, rounded once to f32."""
    ss = split_terms(search, terms or (3 if search.dtype == torch.float32
                                       else 1))
    gs = split_terms(grad, terms or (3 if grad.dtype == torch.float32
                                     else 1))
    k, hs, ws, c = search.shape
    _, hg, wg, _ = grad.shape
    ht, wt = hs - hg + 1, ws - wg + 1
    acc = torch.zeros((k, ht, wt, c), dtype=torch.float64)
    for i_s, s in enumerate(ss):
        for i_g, g in enumerate(gs):
            if i_s + i_g > order:
                continue
            s64, g64 = s.double(), g.double()
            for i in range(hg):
                for j in range(wg):
                    acc += s64[:, i:i + ht, j:j + wt, :] \
                        * g64[:, i:i + 1, j:j + 1, :]
    return acc.float()


def _gt_smem_ok(plan, limit):
    nt, blocks, p, br, smem = plan
    return smem <= limit and br % p == 0 and br >= p


@pytest.mark.parametrize("hs,ws,hg,wg,s_size,g_size,want", [
    (30, 30, 16, 16, 2, 4, (2, 1, 2, 30)),     # the default training step
    (30, 30, 16, 16, 4, 4, (2, 1, 2, 18)),     # the f32 step
    (35, 35, 29, 29, 2, 4, (1, 1, 4, 20)),     # the AOT recipe
    (75, 75, 61, 61, 2, 4, (2, 1, 2, 8)),      # SEARCH_REGION 5's step
    (75, 75, 61, 61, 4, 4, (2, 1, 2, 4)),      # SEARCH_REGION 5 in f32
    (75, 75, 61, 61, 2, 2, (2, 1, 2, 16)),
    (20, 24, 14, 20, 4, 4, (1, 1, 4, 12)),
    (9, 40, 1, 38, 4, 4, (1, 1, 4, 4)),
    (40, 40, 21, 21, 2, 4, (4, 2, 1, 18)),     # POOLER_RESOLUTION 20
    (100, 100, 81, 81, 2, 4, (4, 2, 1, 1)),    # ... at SEARCH_REGION 5
    (60, 40, 19, 9, 4, 4, (4, 3, 1, 14))])     # 42x32: three row blocks
def test_grad_template_plan(hs, ws, hg, wg, s_size, g_size, want):
    """The template gradient's plan for an H100's shared memory: one, two
    or four n8 tiles by the output's width, row blocks of equal height up
    to 16 by its height, an A tile for 4 search rows at a 7-high template
    and 2 at a 15-high one, and the tallest band of whole steps whose
    layout fits two blocks an SM (every search row at the default shape,
    8 at SEARCH_REGION 5's training step, 20 of the AOT recipe's 35, one
    at POOLER_RESOLUTION 20 and SEARCH_REGION 5's 81-wide gradient)."""
    from siammot_tpu_torch.ops.xcorr import grad_template_plan
    plan = grad_template_plan(hs, ws, hg, wg, s_size, g_size, H100_SMEM)
    assert plan[:4] == want
    nt, blocks, p, br, smem = plan
    assert _gt_smem_ok(plan, (H100_SMEM + 1024) // 2 - 1024)
    hb = -(-(hs - hg + 1) // blocks)
    assert hb <= 16 and blocks * hb >= hs - hg + 1 > (blocks - 1) * hb
    assert br <= -(-(hb + hg - 1) // p) * p


def test_grad_template_plan_limits():
    """Outputs past 32 wide and shared memory too small for one step's
    band raise with the limit; a gradient past 64 wide (two segments of
    four k-steps) still plans, for one block an SM where two do not
    fit."""
    from siammot_tpu_torch.ops.xcorr import grad_template_plan
    with pytest.raises(ValueError, match="32 wide"):
        grad_template_plan(40, 60, 23, 23, 2, 4, H100_SMEM)   # 18x38
    with pytest.raises(ValueError, match="30000"):
        grad_template_plan(75, 75, 61, 61, 4, 4, 30000)
    plan = grad_template_plan(90, 130, 76, 116, 4, 4, H100_SMEM)
    assert _gt_smem_ok(plan, H100_SMEM)
    assert plan[4] > (H100_SMEM + 1024) // 2 - 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_terms_sum_to_the_input(dtype):
    """Three bf16 terms hold an f32 exactly (their f64 sum is the input
    bit for bit, across 2^-100 .. 2^126 and both signs; below that the
    third term falls under bf16's normal range and keeps fewer bits); a
    bf16 input is its own single term."""
    rng = np.random.RandomState(7)
    x = (rng.randn(4096) * np.exp2(rng.randint(-100, 127, 4096))).astype(
        np.float32)
    t = torch.from_numpy(x).to(dtype)
    terms = split_terms(t, 3 if dtype == torch.float32 else 1)
    total = sum(p.double() for p in terms)
    assert torch.equal(total, t.double())
    for p in terms:
        assert torch.equal(p, p.to(torch.bfloat16).float())


@pytest.mark.parametrize("hs,hg", [(35, 29), (75, 61)])
def test_split_emulation_matches_jax_vjp(hs, hg):
    """The template gradient kernel's arithmetic in plain PyTorch
    (``xcorr_grad_template_split``: the search and the upstream gradient
    split into bf16 terms as the kernel splits them, the products summed
    in f64) against ``jax.vjp`` of the JAX package's
    ``xcorr_depthwise_auto`` at the AOT recipe's 35x35 search with its
    29x29 gradient and SEARCH_REGION 5's 75x75 with 61x61; 2 slots, 4
    channels, f32 and the bf16 search of a training step.  JAX's own f32
    sums of up to 3721 products -> 1e-5 of the largest value."""
    rng = np.random.RandomState(hs + hg)
    ht = hs - hg + 1
    s = rng.randn(2, hs, hs, 4).astype(np.float32)
    t = rng.randn(2, ht, ht, 4).astype(np.float32)
    g = rng.randn(2, hg, hg, 4).astype(np.float32)
    for sb in (s, np.array(jnp.asarray(s, jnp.bfloat16).astype(
            jnp.float32))):
        _, vjp = jax.vjp(jax_xcorr_auto, jnp.asarray(sb), jnp.asarray(t))
        want = np.asarray(vjp(jnp.asarray(g))[1])
        search = torch.from_numpy(sb)
        if sb is not s:
            search = search.to(torch.bfloat16)
        got = xcorr_grad_template_split(search, torch.from_numpy(g))
        assert got.dtype == torch.float32 and got.shape == (2, ht, ht, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
def test_three_term_split_holds_the_card_tolerance(sdt):
    """At SEARCH_REGION 5's 75x75 search and 61x61 gradient (4 slots, 32
    channels, the card tests' N(0, 1) inputs), the kernel's split (three
    bf16 terms an f32 input) stays within the card tests' tolerance,
    atol 1e-4 + rtol 1e-3, of the exact correlation
    (``xcorr_depthwise_exact``), where two terms with their three
    products (hi*hi + hi*lo + lo*hi) stray past it near zero."""
    rng = np.random.RandomState(61)
    s = torch.from_numpy(rng.randn(4, 75, 75, 32).astype(np.float32)).to(sdt)
    g = torch.from_numpy(rng.randn(4, 61, 61, 32).astype(np.float32))
    exact = xcorr_depthwise_exact(s, g).double()
    tol = 1e-4 + 1e-3 * exact.abs()

    def worst(got):
        return float(((got.double() - exact).abs() / tol).max())

    assert worst(xcorr_grad_template_split(s, g)) < 0.05
    assert worst(xcorr_grad_template_split(s, g, terms=2, order=1)) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ht,wt", [(7, 6), (33, 32)])
def test_plain_xcorr_sums(dtype, ht, wt):
    """``xcorr_depthwise_plain`` sums i-major in f32 at any number of taps
    (7x6 and 33x32: bit for bit numpy's f32 products added in that order,
    JAX's and ``xcorr6_kernel``'s order), through either of its two loops
    (with and without autograd), masked slots zero; the card's yardstick
    of the template gradient, ``xcorr_depthwise_exact``, is bit for bit
    numpy's f64 sums rounded once to f32."""
    rng = np.random.RandomState(ht)
    hs, ws = ht + 13, wt + 12
    s = torch.from_numpy(rng.randn(3, hs, ws, 5).astype(np.float32)).to(
        dtype)
    t = torch.from_numpy(rng.randn(3, ht, wt, 5).astype(np.float32)).to(
        dtype)
    wants = []
    for ft in (np.float32, np.float64):
        s_, t_ = s.float().numpy().astype(ft), t.float().numpy().astype(ft)
        want = np.zeros((3, 14, 13, 5), ft)
        for i in range(ht):
            for j in range(wt):
                want += s_[:, i:i + 14, j:j + 13] * t_[:, i:i + 1, j:j + 1]
        wants.append(want.astype(np.float32))
    want, exact = wants
    assert np.array_equal(xcorr_depthwise_plain(s, t).numpy(), want)
    st = s.clone().requires_grad_(True)
    assert np.array_equal(xcorr_depthwise_plain(st, t).detach().numpy(),
                          want)
    valid = torch.tensor([True, False, True])
    got = xcorr_depthwise_plain(s, t, valid).numpy()
    assert np.array_equal(got[[0, 2]], want[[0, 2]]) and (got[1] == 0).all()
    assert np.array_equal(xcorr_depthwise_exact(s, t).numpy(), exact)
    assert np.array_equal(xcorr_depthwise_exact(st, t).numpy(), exact)


def _card_tolerance_ratio(got, want):
    """The largest |got - want| over the card tests' atol 1e-4 + rtol
    1e-3 |want|: above 1, ``torch.testing.assert_close`` fails."""
    return float(((got.double() - want.double()).abs()
                  / (1e-4 + 1e-3 * want.double().abs())).max())


@pytest.mark.parametrize("hs,hg,sdt,stray", [
    (35, 29, torch.bfloat16, False), (35, 29, torch.float32, False),
    (75, 61, torch.bfloat16, True), (75, 61, torch.float32, True)])
def test_plain_f32_sums_against_the_exact_correlation(hs, hg, sdt, stray):
    """Why the card holds the template gradient's kernel to
    ``xcorr_depthwise_exact``: on the card test's own inputs
    (``tests/test_torch_cuda.py::test_xcorr_grad_template_kernel``, 3
    slots, 128 channels, N(0, 1), an f32 upstream gradient), the plain
    version's f32 sums in JAX's order land within the card tolerance of
    the exact correlation at the AOT recipe's 841 taps, and past it on
    their own near zero at SEARCH_REGION 5's 3721."""
    k, c = 3, 128
    g = torch.Generator().manual_seed(hs * hs + hg + c + k)
    search = torch.randn(k, hs, hs, c, generator=g).to(sdt)
    up = torch.randn(k, hg, hg, c, generator=g)
    ratio = _card_tolerance_ratio(xcorr_depthwise_plain(search, up),
                                  xcorr_depthwise_exact(search, up))
    assert (ratio > 1.0) == stray, ratio
