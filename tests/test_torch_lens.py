"""Parity of the port's lensing path with the JAX package: the spline
prefilter, kernel B8's plain version ``lens_map_ref`` against
``lens_map_pallas`` in interpret mode (orders 3 and 5, batched, and past
the displacement cap), the uncapped spline path, kappa -> deflection, and
``FlatLensingSims`` on the same draws. B8's closed-form weights
(``spline_weights``) against the piecewise ones, and a torch emulation of
the kernel's per-block window (tile range, window origin, wrapped-index
tables, wide blocks through device memory) against ``lens_map_ref``. The
CUDA kernel is held to its plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import grf as jgrf, lensing as jlens, theory as jtheory
from orphics_tpu.ops import pallas_lens

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import lensing as tlens, theory as ttheory
from orphics_tpu_torch.ops import lens as tlensop

torch.set_num_threads(1)

# The bound tests/test_lensing.py holds the Pallas kernel to against the
# spline path: fp32 tap sums in another order and fractions computed as
# (y + p) - floor(y + p) vs p - floor(p): 2e-5 of the map's max.
TOL_LENS = 2e-5


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jg = jgeo.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    tg = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jth = jtheory.default_theory()
    fls = jlens.FlatLensingSims(jg, jth, beam_arcmin=1.5, noise_uk_arcmin=7.0)
    B, C = 2, 2
    keys = jax.random.split(jax.random.PRNGKey(11), B * (C + 1)).reshape(
        B, C + 1, 2)
    imaps = np.stack([np.stack([np.asarray(fls.get_unlensed(keys[b, c]))
                                for c in range(C)])
                      for b in range(B)]).astype(np.float32)
    kappas = np.stack([np.asarray(fls.get_kappa(keys[b, C]))
                       for b in range(B)]).astype(np.float32)
    alphas = np.stack([np.asarray(jlens.alpha_from_kappa(
        jnp.asarray(kappas[b]), jg)) for b in range(B)]).astype(np.float32)
    assert np.abs(alphas).max() / jg.dy < 8.0      # inside the cap
    return jg, tg, jth, imaps, kappas, alphas


def test_spline_prefilter_and_weights(setup):
    jg, tg, _, imaps, _, _ = setup
    for order in (3, 5):
        np.testing.assert_array_equal(
            tlensop._bspline_freq_response(64, order),
            pallas_lens._bspline_freq_response(64, order))
        c_t = tlensop.spline_coeffs(_t(imaps), tg, order).numpy()
        c_j = np.asarray(pallas_lens.spline_coeffs(jnp.asarray(imaps), jg,
                                                   order))
        # two fp32 FFTs around a division by the response: 1e-5 of the max
        assert np.abs(c_t - c_j).max() <= 1e-5 * np.abs(c_j).max()
        t = np.linspace(0.0, 0.999, 101).astype(np.float32)
        wfn_t = (tlensop._bspline3_weights if order == 3
                 else tlensop._bspline5_weights)
        wfn_j = (pallas_lens._bspline3_weights if order == 3
                 else pallas_lens._bspline5_weights)
        # fp32 polynomials whose terms reach ~1e2 before cancelling to
        # weights below 1, with powers rounded differently: 1e-6 absolute
        for a, b in zip(wfn_t(torch.as_tensor(t)), wfn_j(jnp.asarray(t))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        # partition of unity
        np.testing.assert_allclose(sum(wfn_t(torch.as_tensor(t))).numpy(),
                                   1.0, atol=1e-6)


@pytest.mark.parametrize("order", [3, 5])
def test_lens_map_ref_matches_pallas_batched(setup, order):
    """(B, C, ny, nx) with per-batch deflections shared by components."""
    jg, tg, _, imaps, _, alphas = setup
    ref = np.asarray(pallas_lens.lens_map_pallas(
        jnp.asarray(imaps), jnp.asarray(alphas), jg, order=order,
        interpret=True))
    coeffs = tlensop.spline_coeffs(_t(imaps), tg, order)
    out = tlensop.lens_map_ref(coeffs, _t(alphas), tg, order=order).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=TOL_LENS)
    # the dispatching wrapper: plain version on a CPU tensor, same shapes
    got = tlensop.lens_map_kernel(_t(imaps), _t(alphas), tg, order=order)
    assert got.shape == imaps.shape
    np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                               atol=TOL_LENS)
    # rank-2 input with a (2, ny, nx) deflection
    one = tlensop.lens_map_kernel(_t(imaps[1, 0]), _t(alphas[1]), tg,
                                  order=order)
    np.testing.assert_allclose(one.numpy() / scale, ref[1, 0] / scale,
                               atol=TOL_LENS)


def test_lens_map_ref_past_the_cap(setup):
    """Deflections beyond maxdisp_px are clipped the same way."""
    jg, tg, _, imaps, _, alphas = setup
    big = (alphas * 12.0).astype(np.float32)
    D = 4
    assert np.abs(big).max() / jg.dy > D + 2
    for order in (3, 5):
        ref = np.asarray(pallas_lens.lens_map_pallas(
            jnp.asarray(imaps), jnp.asarray(big), jg, order=order,
            maxdisp_px=D, interpret=True))
        out = tlensop.lens_map_kernel(_t(imaps), _t(big), tg, order=order,
                                      maxdisp_px=D).numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=TOL_LENS)


def test_spline_path_and_deflection(setup):
    jg, tg, _, imaps, kappas, alphas = setup
    # kappa -> phi and kappa -> deflection, one fp32 FFT pair each
    a_t = tlens.alpha_from_kappa(_t(kappas[0]), tg).numpy()
    assert np.abs(a_t - alphas[0]).max() <= 1e-5 * np.abs(alphas[0]).max()
    p_t = tlens.kappa_to_phi(_t(kappas[0]), tg).numpy()
    p_j = np.asarray(jlens.kappa_to_phi(jnp.asarray(kappas[0]), jg))
    assert np.abs(p_t - p_j).max() <= 1e-5 * np.abs(p_j).max()
    for order in (3, 5):
        ref = np.asarray(jlens.lens_map_spline(jnp.asarray(imaps[0]),
                                               jnp.asarray(alphas[0]), jg,
                                               order=order))
        out = tlens.lens_map_spline(_t(imaps[0]), _t(alphas[0]), tg,
                                    order=order).numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=TOL_LENS)
        # the capped kernel path agrees with the spline path in the cap
        capped = tlensop.lens_map_kernel(_t(imaps[0]), _t(alphas[0]), tg,
                                         order=order).numpy()
        np.testing.assert_allclose(capped / scale, ref / scale,
                                   atol=TOL_LENS)


def test_flat_lensing_sims_same_draws():
    """get_sim on the same white noise: observed map and intermediates."""
    jg = jgeo.rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
    tg = tp.rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
    jth = jtheory.default_theory()
    tth = ttheory.default_theory()
    jf = jlens.FlatLensingSims(jg, jth, beam_arcmin=8.0, noise_uk_arcmin=10.0,
                               lens_order=3, dtype=jnp.float32)
    tf = tlens.FlatLensingSims(tg, tth, beam_arcmin=8.0, noise_uk_arcmin=10.0,
                               lens_order=3, device="cpu")
    key = jax.random.PRNGKey(3)
    obs_j, ex_j = jf.get_sim(key, return_intermediate=True)
    etas = [np.asarray(jgrf.rand_kmap(k, jg, 1, dtype=jnp.float32))
            for k in jax.random.split(key, 3)]
    obs_t, ex_t = tf.get_sim_from_noise(*map(_t, etas),
                                        return_intermediate=True)
    # GRF synthesis and lensing in fp32 on both sides: 1e-4 of the max
    for name in ("unlensed", "kappa", "lensed", "noise"):
        a, b = ex_t[name].numpy(), np.asarray(ex_j[name])
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
    b = np.asarray(obs_j)
    assert np.abs(obs_t.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    gen = torch.Generator().manual_seed(1)
    assert tf.get_sim(gen).shape == tg.shape


def test_closed_form_weights_equal_piecewise():
    """``spline_weights`` (the Horner pieces the kernel evaluates) against
    the piecewise ``_bspline{3,5}_weights`` on a grid of t in [0, 1): the
    same polynomials, so 1e-7 in float64 (they agree to ~1e-15). In
    float32 each Horner step rounds once against the float64 piecewise
    weights: 3e-7 absolute (weights <= 0.67, a few float32 ulps)."""
    t64 = torch.linspace(0.0, 1.0, 4097, dtype=torch.float64)[:-1]
    for order, piecewise in ((3, tlensop._bspline3_weights),
                             (5, tlensop._bspline5_weights)):
        want = piecewise(t64)
        got = tlensop.spline_weights(t64, order)
        assert len(got) == order + 1
        for g, w in zip(got, want):
            assert (g - w).abs().max().item() <= 1e-7
        g32 = tlensop.spline_weights(t64.float(), order)
        for g, w in zip(g32, want):
            assert g.dtype == torch.float32
            assert (g.double() - w).abs().max().item() <= 3e-7
        np.testing.assert_allclose(sum(got).numpy(), 1.0, atol=1e-12)


def _emulate_b8(coeffs, alpha, geom, order, D, tile=tlensop.TILE,
                rmax=tlensop.WINDOW_RANGE):
    """The CUDA kernel's per-block bookkeeping in torch: for each tile of
    outputs, the range of the clipped deflection floors, the window's
    origin and size, the wrapped row and column tables, the window's taps
    (rows outer, columns inner) with the closed-form weights; a block whose
    range exceeds ``rmax`` takes its taps from the whole plane, wrapped per
    tap. Returns the lensed maps and the count of such wide blocks."""
    B, C, ny, nx = coeffs.shape
    TY, TX = tile
    o0 = tlensop._OFFS[order][0]
    py = torch.clamp(alpha[:, 0] / geom.dy, -D, D)
    px = torch.clamp(alpha[:, 1] / geom.dx, -D, D)
    fy, fx = torch.floor(py), torch.floor(px)
    wy = tlensop.spline_weights(py - fy, order)
    wx = tlensop.spline_weights(px - fx, order)
    fy, fx = fy.long(), fx.long()
    out = torch.empty_like(coeffs)
    wide = 0
    for b in range(B):
        for by0 in range(0, ny, TY):
            for bx0 in range(0, nx, TX):
                sl = (b, slice(by0, by0 + TY), slice(bx0, bx0 + TX))
                fyb, fxb = fy[sl], fx[sl]
                vy, vx = fyb.shape
                lo_y, lo_x = int(fyb.min()), int(fxb.min())
                rng_y, rng_x = int(fyb.max()) - lo_y, int(fxb.max()) - lo_x
                iy = torch.arange(vy)[:, None]
                ix = torch.arange(vx)[None, :]
                if rng_y > rmax or rng_x > rmax:
                    wide += 1
                    rows = [(by0 + iy + fyb + o0 + k) % ny
                            for k in range(order + 1)]
                    cols = [(bx0 + ix + fxb + o0 + m) % nx
                            for m in range(order + 1)]
                    taps = lambda src, k, m: src[rows[k], cols[m]]
                else:
                    h, w = vy + rng_y + order, vx + rng_x + order
                    wrow = (by0 + lo_y + o0 + torch.arange(h)) % ny
                    wcol = (bx0 + lo_x + o0 + torch.arange(w)) % nx
                    ry, rx = iy + fyb - lo_y, ix + fxb - lo_x
                    taps = lambda src, k, m: src[wrow][:, wcol][ry + k,
                                                                rx + m]
                for c in range(C):
                    acc = torch.zeros((vy, vx))
                    for k in range(order + 1):
                        t = torch.zeros((vy, vx))
                        for m in range(order + 1):
                            t = t + wx[m][sl] * taps(coeffs[b, c], k, m)
                        acc = acc + wy[k][sl] * t
                    out[b, c, by0:by0 + vy, bx0:bx0 + vx] = acc
    return out, wide


@pytest.mark.parametrize("order", [3, 5])
def test_kernel_window_emulation_matches_ref(order):
    """The emulated kernel equals ``lens_map_ref`` to 2e-5 of the max on a
    ragged grid (70 x 45: no side a multiple of the tile), two batch
    entries and two components: with the pipeline's cap D = 8 (no wide
    block: a floor range is at most 2 D = 16), and with D = max(ny, nx)
    and a deflection whose floors span more than the window in some
    blocks (those take their taps from the whole plane) but not all."""
    tg = tp.rect_geometry(width_arcmin=45 * 3.0, height_arcmin=70 * 3.0,
                          px_res_arcmin=3.0)
    assert tg.shape == (70, 45)
    rng = np.random.default_rng(order)
    B, C = 2, 2
    maps = torch.as_tensor(rng.standard_normal((B, C) + tg.shape)
                           .astype(np.float32))
    coeffs = tlensop.spline_coeffs(maps, tg, order).contiguous()
    # a smooth deflection: white noise low-passed on the Fourier plane
    k = np.fft.fft2(rng.standard_normal((B, 2) + tg.shape))
    ky = np.fft.fftfreq(tg.shape[0])[:, None]
    kx = np.fft.fftfreq(tg.shape[1])[None, :]
    smooth = np.fft.ifft2(k * np.exp(-(ky ** 2 + kx ** 2) / 0.002)).real
    smooth /= np.abs(smooth).max()
    TY, TX = tlensop.TILE
    nblocks = B * -(-tg.shape[0] // TY) * -(-tg.shape[1] // TX)
    for amax_px, D, wide_expected in ((6.0, 8, False),
                                      (15.0, max(tg.shape), True)):
        alpha = torch.as_tensor((smooth * amax_px * tg.dy)
                                .astype(np.float32))
        ref = tlensop.lens_map_ref(coeffs, alpha, tg, order, D)
        got, wide = _emulate_b8(coeffs, alpha, tg, order, D)
        if wide_expected:
            assert 0 < wide < nblocks, wide
        else:
            assert wide == 0
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= TOL_LENS * scale
        # a tighter window sends every block through device memory
        got, wide = _emulate_b8(coeffs, alpha, tg, order, D, rmax=-1)
        assert wide == nblocks
        assert (got - ref).abs().max().item() <= TOL_LENS * scale
