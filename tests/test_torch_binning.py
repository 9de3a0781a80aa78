"""Parity of the port's binning (kernels B1 and B2's plain versions and the
binners built on them) with the JAX package: ``bin_reduce_ref`` against
``bin_matmul`` and ``bin2_reduce`` against ``bin2_matmul`` in Pallas
interpret mode, and ``Bin2D``/``RfftBin2D`` against the JAX binners
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

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import binning as tbin
from orphics_tpu_torch.ops.bin_reduce import (_seg_tiles, bin2_reduce,
                                               bin2_reduce_ref, bin_reduce,
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
    tb = tbin.Bin2D(tg.modlmap_np(), edges)
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
    tb = tbin.RfftBin2D(tg, edges)
    np.testing.assert_array_equal(tb.counts, jb.counts)
    _, m_t = tb.bin(torch.as_tensor(p_half))
    _, m_j = jb.bin(jnp.asarray(p_half))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL_ROWCUM)
    # half-plane binning with the 2/1 weights == full-plane binning
    full = tbin.Bin2D(tg.modlmap_np(), edges)
    _, m_f = full.bin(torch.as_tensor(p_full.astype(np.float32)))
    np.testing.assert_allclose(m_t.numpy(), m_f.numpy(), rtol=1e-5)
