"""Parity of the port's binning (kernels B1, B2 and B2''s plain versions and
the binners built on them) with the JAX package: ``bin_reduce_ref`` against
``bin_matmul``, ``bin2_reduce`` against ``bin2_matmul`` and
``bin_pair_power`` against ``bin_pair_power`` in Pallas interpret mode, the
host binners ``bin1d`` / ``bin1D`` / ``bin_in_annuli``, and ``Bin2D``/``RfftBin2D`` against the JAX binners
(rowcum and Pallas-interpret). The CUDA kernels are held to their plain
versions in test_torch_cuda.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import binning as jbin
from orphics_tpu.ops import pallas_fft as pf
from orphics_tpu.ops.pallas_kernels import bin2_matmul, bin_matmul
from orphics_tpu.ops.pallas_kernels import bin_pair_power as j_bin_pair_power

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import binning as tbin
from orphics_tpu_torch.ops.bin_reduce import (_seg_tiles, bin2_reduce,
                                               bin2_reduce_ref,
                                               bin_pair_power,
                                               bin_pair_power_ref, bin_reduce,
                                               bin_reduce_ref)

torch.set_num_threads(1)

# Bin sums against the binned |data|: bin_matmul's bf16 hi/lo split keeps
# ~16-17 mantissa bits per element (pallas_kernels.py:11-17), the plain
# version sums in float64; both are held to 1e-6 of sum |data * w| per bin.
TOL_BIN = 1e-6
# The JAX CPU binners take the rowcum route: differences of fp32 cumulative
# sums along a row of nx terms, good to ~nx * 2**-24 relative (5e-6, nx=96).
RTOL_ROWCUM = 5e-6


def _bin_err(out, ref, absref):
    return np.max(np.abs(np.asarray(out) - np.asarray(ref))
                  / np.maximum(np.asarray(absref), 1e-300))


@pytest.mark.parametrize("n,weighted", [(8192 + 1000, False),
                                        (8192 + 1000, True),
                                        (3 * 8192, True)])
def test_bin_reduce_ref_matches_bin_matmul(n, weighted):
    """N not a multiple of the Pallas block (tail in XLA) and a multiple."""
    rng = np.random.default_rng(n)
    B, nseg = 2, 19
    data = rng.standard_normal((B, n)).astype(np.float32) + 0.3
    ids = rng.integers(0, nseg, n).astype(np.int32)
    w = rng.integers(1, 3, n).astype(np.float32) if weighted else None
    ref = bin_matmul(jnp.asarray(data), jnp.asarray(ids), nseg,
                     weights=None if w is None else jnp.asarray(w),
                     interpret=True)
    tw = None if w is None else torch.as_tensor(w)
    out = bin_reduce_ref(torch.as_tensor(data), torch.as_tensor(ids), nseg, tw)
    absref = bin_reduce_ref(torch.as_tensor(np.abs(data)),
                            torch.as_tensor(ids), nseg, tw)
    assert out.shape == (B, nseg) and out.dtype == torch.float32
    assert _bin_err(out, ref, absref) <= TOL_BIN
    # the dispatching wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        bin_reduce(torch.as_tensor(data), torch.as_tensor(ids), nseg,
                   tw).numpy(), out.numpy())
    # float64 numpy oracle
    wn = np.ones(n) if w is None else w.astype(np.float64)
    oracle = np.stack([np.bincount(ids, weights=data[b] * wn, minlength=nseg)
                       for b in range(B)])
    assert _bin_err(out, oracle, absref) <= 1e-7


def test_bin2_reduce_matches_bin2_matmul():
    """tests/test_core.py's half-plane case: the mirror-even fields of a
    (3, 256, 256) plane binned over mirror-symmetric ids, nseg 24; and the
    2 bin(half) - bin(row 0) + bin(row n/2) identity against the
    full-plane sums."""
    rng = np.random.default_rng(13)
    n, B = 256, 3
    zr = rng.standard_normal((B, n, n)).astype(np.float32)
    zi = rng.standard_normal((B, n, n)).astype(np.float32)
    perm, inv = pf.row_perm(n)
    mrow = inv[(n - perm) % n]
    p_of_h, pnyq = pf.half_rows(n)
    zm_r, zm_i = zr[:, mrow][:, :, mrow], zi[:, mrow][:, :, mrow]
    qs_full = 0.5 * (zr ** 2 + zi ** 2 + zm_r ** 2 + zm_i ** 2)
    c_full = zr * zm_r - zi * zm_i
    ids = rng.integers(0, 20, size=(n, n)).astype(np.int32)
    ids = np.minimum(ids, ids[mrow][:, mrow])
    nsg = 24
    qs = qs_full[:, p_of_h].reshape(B, -1)
    c = c_full[:, p_of_h].reshape(B, -1)
    idh = ids[p_of_h].reshape(-1)
    want = bin2_matmul(jnp.asarray(qs), jnp.asarray(c), jnp.asarray(idh),
                       nsg, block=4096, interpret=True)
    tq, tc = torch.as_tensor(qs), torch.as_tensor(c)
    tid = torch.as_tensor(idh)
    got = bin2_reduce(tq, tc, tid, nsg)
    for g, w, x in zip(got, want, (tq, tc)):
        assert g.shape == (B, nsg) and g.dtype == torch.float32
        absref = bin_reduce_ref(x.abs(), tid, nsg).double()
        assert _bin_err(g, w, absref) <= TOL_BIN     # empty bins: 0 == 0
        np.testing.assert_array_equal(g.numpy(),
                                      bin_reduce_ref(x, tid, nsg).numpy())
    for x, bh in ((qs_full, got[0].numpy()), (c_full, got[1].numpy())):
        seg = lambda v, i: np.stack([np.bincount(i.ravel(), v[b].ravel(),
                                                 minlength=nsg)
                                     for b in range(B)])
        recon = 2 * bh - seg(x[:, 0], ids[0]) + seg(x[:, pnyq], ids[pnyq])
        full = seg(x.astype(np.float64), ids)
        assert np.abs(recon - full).max() <= 1e-5 * np.abs(full).max()
    with pytest.raises(ValueError, match="must match"):
        bin2_reduce(tq, tc[:2], tid, nsg)


def _dropped_ids(rng, n, nseg):
    """Ids in [0, nseg) with runs of -1 (a caller's dropped segments), one
    of them longer than the kernels' 32-id steps, and a few ids >= nseg
    (also dropped)."""
    ids = rng.integers(0, nseg, n).astype(np.int32)
    ids[rng.random(n) < 0.5] = -1
    ids[100:400] = -1
    ids[rng.random(n) < 0.01] = nseg + 3
    return ids


@pytest.mark.parametrize("n,weighted", [(8192 + 1000, False),
                                        (2 * 8192, True)])
def test_ref_drops_ids_like_bin_matmul(n, weighted):
    """Ids outside [0, nseg) (-1 where a caller drops segments) are
    dropped by the plain versions as by the JAX one-hot: B1 against
    ``bin_matmul``, B2 against ``bin2_matmul``, within 1e-6 of the binned
    |data|, and equal to the sums over the kept ids alone."""
    rng = np.random.default_rng(n + 7)
    B, nseg = 3, 21
    d1, d2 = (rng.standard_normal((B, n)).astype(np.float32) + 0.3
              for _ in range(2))
    ids = _dropped_ids(rng, n, nseg)
    w = rng.integers(1, 3, n).astype(np.float32) if weighted else None
    tid = torch.as_tensor(ids)
    tw = None if w is None else torch.as_tensor(w)
    want = bin_matmul(jnp.asarray(d1), jnp.asarray(ids), nseg,
                      weights=None if w is None else jnp.asarray(w),
                      interpret=True)
    got = bin_reduce(torch.as_tensor(d1), tid, nseg, tw)
    absref = bin_reduce_ref(torch.as_tensor(np.abs(d1)), tid, nseg, tw)
    assert _bin_err(got, want, absref) <= TOL_BIN
    keep = (ids >= 0) & (ids < nseg)
    wn = np.ones(n) if w is None else w.astype(np.float64)
    oracle = np.stack([np.bincount(ids[keep], (d1[b] * wn)[keep],
                                   minlength=nseg) for b in range(B)])
    assert _bin_err(got, oracle, absref) <= 1e-7
    want2 = bin2_matmul(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(ids),
                        nseg, block=4096, interpret=True)
    got2 = bin2_reduce(torch.as_tensor(d1), torch.as_tensor(d2), tid, nseg)
    for g, wj, x in zip(got2, want2, (d1, d2)):
        absref = bin_reduce_ref(torch.as_tensor(np.abs(x)), tid, nseg)
        assert _bin_err(g, wj, absref) <= TOL_BIN


def test_seg_tiles_cover_every_segment_once():
    """The kernel's segment tiling: tiles of at most ``cap`` segments, none
    empty, covering [0, nseg) exactly once."""
    for cap in (1, 7, 100, 256):
        for nseg in range(1, 1001):
            tile, ntiles = _seg_tiles(nseg, cap)
            assert 1 <= tile <= cap
            hits = np.zeros(nseg, np.int64)
            for z in range(ntiles):
                lo, hi = z * tile, min(nseg, (z + 1) * tile)
                assert lo < hi
                hits[lo:hi] += 1
            assert (hits == 1).all(), (nseg, cap)


def test_bin_reduce_rejects_bad_inputs():
    d = torch.zeros(2, 10)
    ids = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        bin_reduce(d.double(), ids, 3)
    with pytest.raises(ValueError):
        bin_reduce(d, ids.long(), 3)
    with pytest.raises(ValueError):
        bin_reduce(d, ids[:5], 3)
    with pytest.raises(ValueError):
        bin_reduce(d, ids, 3, weights=torch.ones(10, dtype=torch.float64))


@pytest.fixture(scope="module")
def geoms():
    return (jgeo.rect_geometry(width_arcmin=96 * 3.0, px_res_arcmin=3.0),
            tp.rect_geometry(width_arcmin=96 * 3.0, px_res_arcmin=3.0))


def test_bin2d_matches_jax(geoms):
    jg, tg = geoms
    edges = np.arange(40, 3000, 60.0)
    rng = np.random.default_rng(4)
    data = (rng.standard_normal((2,) + jg.shape) ** 2).astype(np.float32)
    jb = jbin.Bin2D(jg.modlmap_np(), edges, strategy="rowcum")
    tb = tbin.Bin2D(tg.modlmap_np(), edges, device="cpu")
    np.testing.assert_array_equal(tb.counts, jb.counts)
    np.testing.assert_array_equal(tb.centers, jb.centers)
    c, m_t = tb.bin(torch.as_tensor(data))
    _, m_j = jb.bin(jnp.asarray(data))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL_ROWCUM)
    # and the JAX Pallas route (one-hot MXU in interpret mode): its bf16
    # hi/lo split rounds each element to ~2**-17 relative, which small
    # low-l bins (tens of pixels) do not average away: 8e-6 relative
    m_p = np.asarray(jb._pallas_sum(jnp.asarray(data), interpret=True)) \
        * np.asarray(jb._inv_counts)
    np.testing.assert_allclose(m_t.numpy(), m_p, rtol=8e-6)
    # weighted means and scatter errors
    wt = rng.uniform(0.5, 2.0, jg.shape).astype(np.float32)
    np.testing.assert_allclose(
        tb.bin(torch.as_tensor(data), weights=torch.as_tensor(wt))[1].numpy(),
        np.asarray(jb.bin(jnp.asarray(data), weights=jnp.asarray(wt))[1]),
        rtol=RTOL_ROWCUM)
    _, mt, et = tb.bin_err(torch.as_tensor(data[0]))
    _, mj, ej = jb.bin_err(jnp.asarray(data[0]))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL_ROWCUM)
    # the error is a difference of two such means: 1e-4 relative
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)


def test_rfft_bin2d_matches_jax_and_full_plane(geoms):
    jg, tg = geoms
    edges = np.arange(40, 3000, 80.0)
    rng = np.random.default_rng(5)
    m = rng.standard_normal((2,) + jg.shape).astype(np.float32)
    p_full = np.abs(np.fft.fft2(m)) ** 2
    p_half = p_full[..., :jg.nx // 2 + 1].astype(np.float32)
    jb = jbin.RfftBin2D(jg, edges, strategy="rowcum")
    tb = tbin.RfftBin2D(tg, edges, device="cpu")
    np.testing.assert_array_equal(tb.counts, jb.counts)
    _, m_t = tb.bin(torch.as_tensor(p_half))
    _, m_j = jb.bin(jnp.asarray(p_half))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL_ROWCUM)
    # half-plane binning with the 2/1 weights == full-plane binning
    full = tbin.Bin2D(tg.modlmap_np(), edges, device="cpu")
    _, m_f = full.bin(torch.as_tensor(p_full.astype(np.float32)))
    np.testing.assert_allclose(m_t.numpy(), m_f.numpy(), rtol=1e-5)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("n", [4 * 1024 + 300, 3 * 1024])
def test_bin_pair_power_matches_jax(n, sym):
    """B2' (plain version here) against the JAX kernel in interpret mode
    with block 1024, so that its XLA tail runs too: bin(q) and bin(c)
    within 1e-6 of the binned |field| (c cancels: read against bin(|c|))."""
    rng = np.random.default_rng(n)
    B, nseg = 3, 24
    zr, zi, mr, mi = (rng.standard_normal((B, n)).astype(np.float32)
                      for _ in range(4))
    ids = rng.integers(0, nseg, n).astype(np.int32)
    want = j_bin_pair_power(*(jnp.asarray(a) for a in (zr, zi, mr, mi)),
                            jnp.asarray(ids), nseg, block=1024, sym=sym,
                            interpret=True)
    t = [torch.as_tensor(a) for a in (zr, zi, mr, mi)]
    tid = torch.as_tensor(ids)
    got = bin_pair_power(*t, tid, nseg, sym=sym)
    q = 0.5 * (zr ** 2 + zi ** 2 + mr ** 2 + mi ** 2) if sym \
        else zr ** 2 + zi ** 2
    c = zr * mr - zi * mi
    for g, w, field in zip(got, want, (q, c)):
        assert g.shape == (B, nseg) and g.dtype == torch.float32
        absref = bin_reduce_ref(torch.as_tensor(np.abs(field)), tid, nseg)
        assert _bin_err(g, w, absref) <= TOL_BIN
        oracle = np.stack([np.bincount(ids, field[b].astype(np.float64),
                                       minlength=nseg) for b in range(B)])
        assert _bin_err(g, oracle, absref) <= TOL_BIN
    ref = bin_pair_power_ref(*t, tid, nseg, sym)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# B2' with dropped ids against the JAX kernel: bin(c) cancels, and the
# JAX kernel's bf16 hi/lo sums of c read up to 1.03e-6 of bin(|c|) against
# the float64 sums on the inputs below (the port's plain version 1e-7), so
# the two are held to each other at 2e-6. A dropped pixel summed by either
# side would be an error of order 1.
TOL_PAIR_JAX = 2e-6


@pytest.mark.parametrize("sym", [False, True])
def test_bin_pair_power_drops_ids_like_jax(sym):
    """B2' with -1 (and >= nseg) ids against the JAX kernel in interpret
    mode and against float64 sums over the kept ids: the dropped pixels'
    fields are left out of both sums."""
    rng = np.random.default_rng(31 + sym)
    B, n, nseg = 2, 4 * 1024 + 300, 17
    planes = [rng.standard_normal((B, n)).astype(np.float32)
              for _ in range(4)]
    ids = _dropped_ids(rng, n, nseg)
    want = j_bin_pair_power(*(jnp.asarray(a) for a in planes),
                            jnp.asarray(ids), nseg, block=1024, sym=sym,
                            interpret=True)
    tid = torch.as_tensor(ids)
    got = bin_pair_power(*(torch.as_tensor(a) for a in planes), tid, nseg,
                         sym=sym)
    zr, zi, mr, mi = planes
    q = 0.5 * (zr ** 2 + zi ** 2 + mr ** 2 + mi ** 2) if sym \
        else zr ** 2 + zi ** 2
    keep = (ids >= 0) & (ids < nseg)
    for g, wj, field in zip(got, want, (q, zr * mr - zi * mi)):
        absref = bin_reduce_ref(torch.as_tensor(np.abs(field)), tid, nseg)
        assert _bin_err(g, wj, absref) <= TOL_PAIR_JAX
        oracle = np.stack([np.bincount(ids[keep],
                                       field[b][keep].astype(np.float64),
                                       minlength=nseg) for b in range(B)])
        assert _bin_err(g, oracle, absref) <= 1e-7


def test_bin_pair_power_splits_a_packed_pair():
    """With mirror-symmetric bins, (bq + bc) / 2 and (bq - bc) / 2 are the
    binned powers of the two real maps packed as m1 + i m2, with and
    without ``sym``."""
    rng = np.random.default_rng(2)
    n, B, nseg = 16, 2, 5
    m1, m2 = rng.standard_normal((2, B, n, n))
    z = np.fft.fft2(m1 + 1j * m2)
    zm = np.roll(z[:, ::-1, ::-1], (1, 1), (1, 2))
    ky = np.fft.fftfreq(n)[:, None]
    kx = np.fft.fftfreq(n)[None, :]
    ids = np.minimum((np.hypot(ky, kx) * 8).astype(np.int32), nseg - 1)
    flat = lambda a: torch.as_tensor(a.reshape(B, -1).astype(np.float32))
    tid = torch.as_tensor(ids.ravel())
    seg = lambda p: np.stack([np.bincount(ids.ravel(), p[b].ravel(),
                                          minlength=nseg) for b in range(B)])
    p1, p2 = seg(np.abs(np.fft.fft2(m1)) ** 2), seg(np.abs(np.fft.fft2(m2)) ** 2)
    for sym in (False, True):
        bq, bc = bin_pair_power(flat(z.real), flat(z.imag), flat(zm.real),
                                flat(zm.imag), tid, nseg, sym=sym)
        np.testing.assert_allclose(((bq + bc) / 2).numpy(), p1, rtol=1e-5)
        np.testing.assert_allclose(((bq - bc) / 2).numpy(), p2, rtol=1e-5)


def test_bin_pair_power_rejects_bad_inputs():
    d = torch.zeros(2, 10)
    ids = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="must match"):
        bin_pair_power(d, d, d[:1], d, ids, 3)
    with pytest.raises(ValueError, match="float32"):
        bin_pair_power(d, d.double(), d, d, ids, 3)
    with pytest.raises(ValueError, match="int32"):
        bin_pair_power(d, d, d, d, ids.long(), 3)
    with pytest.raises(ValueError, match="positive"):
        bin_pair_power(d, d, d, d, ids, 0)


def test_bin1d_and_bin1D_match_jax():
    """Host numpy on both sides: array-equal."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 3000, 500)
    y = rng.standard_normal(500)
    y[::17] = np.nan
    edges = np.arange(100, 2500, 150.0)
    for got, want in zip(tbin.bin1d(x, y, edges), jbin.bin1d(x, y, edges)):
        np.testing.assert_array_equal(got, want)
    yy = np.nan_to_num(y)
    tb, jb = tbin.bin1D(edges), jbin.bin1D(edges)
    assert tb.numbins == jb.numbins
    for got, want in zip(tb.bin(x, yy), jb.bin(x, yy)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.bin(x, yy, stat=np.nansum),
                         jb.bin(x, yy, stat=np.nansum)):
        np.testing.assert_array_equal(got, want)


def test_bin_in_annuli_matches_jax(geoms):
    """A radial profile on the real-space radius grid, from a host radius
    map and from a tensor."""
    jg, tg = geoms
    rng = np.random.default_rng(6)
    data = rng.standard_normal((2,) + tg.shape).astype(np.float32) + 1.0
    edges = np.linspace(0.0, 0.9 * tg.modrmap_np().max(), 9)
    cj, want = jbin.bin_in_annuli(jnp.asarray(data), jg.modrmap_np(), edges)
    for modr in (tg.modrmap_np(), tg.modrmap(torch.float64, "cpu")):
        ct, got = tbin.bin_in_annuli(torch.as_tensor(data), modr, edges)
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL_ROWCUM)
