"""ops/sht and ops/legendre of the port against the JAX package.

Tolerances:
* host tables (recurrence tables, seeds, ring grids, loop bounds, fold
  helpers): integers equal, float64 within 1e-13 relative;
* the captured seeds: l_s equal; values within 1e-10 relative (the port
  captures in float64, JAX in double-single float32, ~2^-48 per step);
* float64 transforms against the JAX scan under x64 (GL and Clenshaw-Curtis
  grids, spin 0 and 2): 1e-10 of max|ref|;
* float32 transforms against the JAX Pallas kernels in interpret mode:
  1e-6 of max|ref| (tests/test_sht.py holds JAX's own kernel to its scan at
  2e-6). The plain versions are float64 loops, so they agree to the
  float32 rounding of the inputs and outputs;
* the kernel's algorithm (captured seeds, loop bounds, fold), emulated here
  in torch on the CPU, on the port's seeds and on JAX's
  (``convert.load_sht_tables``): 1e-6 of max|ref|; its fast mode against
  its default mode 2e-4 (tests/test_sht.py:716-748);
* float32 roundtrip: 3e-6 (the JAX dd roundtrip error at lmax 1023-2047).

Each JAX reference is computed once per module, in the ``jref`` fixture.
"""
import jax  # noqa: F401  (the JAX package runs on its CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu.ops import pallas_sht as ps
from orphics_tpu.ops import sht as jsht
from orphics_tpu_torch import convert
from orphics_tpu_torch.ops import alm as talm
from orphics_tpu_torch.ops import legendre as leg
from orphics_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

TOL_TAB = 1e-13
TOL_SEED = 1e-10
TOL_F64 = 1e-10
TOL_F32 = 1e-6
TOL_FAST = 2e-4
TOL_RT = 3e-6


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _asym(mod, lmax):
    r = mod.gauss_legendre_rings(lmax)
    th = np.asarray(r.theta_array())
    th[0] *= 0.9
    return mod.RingGeom(tuple(th.tolist()), r.weights, r.nphi)


def _rings(mod, grid, lmax):
    if grid == "asym":
        return _asym(mod, lmax)
    if grid == "cc":
        return mod.clenshaw_curtis_rings(2 * lmax + 2)
    return mod.gauss_legendre_rings(lmax)


def _maps(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's outputs on the module's inputs."""
    out = {}
    # float32 through the Pallas kernels in interpret mode
    for lmax, grid, nb in ((47, "gl", 3), (48, "gl", 0), (47, "asym", 0)):
        rings = _rings(jsht, grid, lmax)
        m = _maps(lmax, ((nb,) if nb else ()) + rings.shape)
        a = ps.map2alm_pl(jnp.asarray(m), rings, lmax, interpret=True)
        out[("ana", lmax, grid)] = (m, np.asarray(a))
        s = ps.alm2map_pl(a, rings, lmax, interpret=True)
        out[("syn", lmax, grid)] = (np.asarray(a), np.asarray(s))
    rings = jsht.gauss_legendre_rings(47)
    q, u = _maps(1, (2, 2) + rings.shape)
    e, b = ps.map2alm_spin_pl(jnp.asarray(q), jnp.asarray(u), rings, 47,
                              interpret=True)
    out["spin_ana"] = (q, u, np.asarray(e), np.asarray(b))
    qq, uu = ps.alm2map_spin_pl(e, b, rings, 47, interpret=True)
    out["spin_syn"] = (np.asarray(e), np.asarray(b), np.asarray(qq),
                       np.asarray(uu))
    m = out[("ana", 48, "gl")][0]
    rings = jsht.gauss_legendre_rings(48)
    out["fast"] = np.asarray(ps.map2alm_pl(jnp.asarray(m), rings, 48,
                                           interpret=True, fast=True))
    # the kernels' host tables, with JAX's captured seeds
    for key in ((47, (0,), 0), (48, (0,), 0), (47, (-2, 2), 0),
                (47, (-2, 2), 1)):
        lmax, ns, ni = key
        out[("host",) + key] = ps._prep_host(
            lmax, jsht.gauss_legendre_rings(lmax), 128, 256, ns, ni, True)
    out[("host", 47, "asym")] = ps._prep_host(47, _asym(jsht, 47), 128, 256,
                                             (0,), 0, False)
    return out


# ---------------------------------------------------------------- host side

@pytest.mark.parametrize("lmax", [12, 47])
def test_host_tables(lmax):
    for grid in ("gl", "cc"):
        rj, rt = _rings(jsht, grid, lmax), _rings(tsht, grid, lmax)
        np.testing.assert_array_equal(rt.theta, rj.theta)
        np.testing.assert_array_equal(rt.weights, rj.weights)
        assert rt.nphi == rj.nphi
    for ns in ((0,), (-2, 2)):
        tj = jsht._wigner_tables_np(lmax, ns)
        tt = leg._wigner_tables_np(lmax, ns)
        assert set(tj) == set(tt)
        for k in tj:
            if np.issubdtype(np.asarray(tj[k]).dtype, np.integer):
                np.testing.assert_array_equal(tt[k], tj[k])
            else:
                assert _rel(tt[k], tj[k]) <= TOL_TAB, k
        th = rj.theta_array()
        mj, ej = jsht._seed_mantissa_exp(tj, th, np.float64)
        mt, et = leg._seed_mantissa_exp(tt, th, np.float64)
        np.testing.assert_array_equal(et, ej)
        assert _rel(mt, mj) <= TOL_TAB
    assert tsht._fast_fft_len(97) == jsht._fast_fft_len(97)
    with pytest.raises(ValueError):
        tsht._ring_analysis(torch.zeros(4, 10), rt, lmax)


@pytest.mark.parametrize("lmax", [47, 2047])
def test_bounds_tables(lmax, monkeypatch):
    """The dead-tile and loop-bound tables equal JAX's on the same l_s
    grid: at JAX's chunk of 8 l-steps, JAX's own (128, 256) tiles and (1,
    256) tiles; at the kernels' chunk of 16 (JAX's functions with their
    chunk set to 16) the kernels' (1, 32) groups, dead groups engaged at
    lmax 2047."""
    rings = jsht.gauss_legendre_rings(lmax)
    Th = (rings.ntheta + 1) // 2
    th = rings.theta_array()[:Th]
    capL = np.random.default_rng(lmax).integers(-1, lmax + 1,
                                                (Th, lmax + 1)).astype(
                                                    np.int32)
    for lc, tiles in ((8, ((128, 256), (1, 256))),
                      (leg._LC, ((1, leg._TG), (128, 256)))):
        monkeypatch.setattr(ps, "_UNROLL", lc)
        Lp = -(-(lmax + 1) // lc) * lc
        for mt, tt in tiles:
            Tp = -(-Th // tt) * tt
            Mp = -(-(lmax + 1) // mt) * mt
            np.testing.assert_array_equal(
                leg._lend_table(lmax, th, mt, tt, Lp, Tp, lc),
                ps._lend_table(lmax, th, mt, tt, Lp, Tp))
            if lmax < 100 or (mt, lc) == (1, leg._LC):
                np.testing.assert_array_equal(
                    leg._bounds_table(capL, lmax, th, mt, tt, Lp, Tp, Mp,
                                      lc),
                    ps._bounds_table(capL, lmax, th, mt, tt, Lp, Tp, Mp))
    if lmax == 2047:
        for tt in (256, leg._TG):
            assert (leg._lend_table(lmax, th, 1, tt, Lp,
                                    -(-Th // tt) * tt) == 0).any()


def test_kernel_bounds_follow_the_group(jref):
    """The kernel tables' bounds are _bounds_table's on the captured l_s at
    the kernels' (1, 32) groups and chunk of 16; the m-major recurrence
    tables are the plain version's, transposed and padded to whole
    chunks."""
    for lmax, ns, ni, layout in ((47, (0,), 0, "fold"),
                                 (48, (0,), 0, "fold"),
                                 (47, (-2, 2), 1, "half")):
        tab = leg.tables(lmax, tsht.gauss_legendre_rings(lmax), ns, ni,
                         layout)
        k = leg.kernel_tables(tab)
        L1, Tk = lmax + 1, k["Tk"]
        assert k["Lp"] % leg._LC == 0 and k["Lp"] - leg._LC < L1 <= k["Lp"]
        assert k["ng"] == -(-Tk // leg._TG)
        want = leg._bounds_table(k["ls"].numpy().T, lmax,
                                 tab["theta"][:Tk], 1, leg._TG, k["Lp"],
                                 k["ng"] * leg._TG, L1)
        np.testing.assert_array_equal(k["bounds"].numpy(), want)
        for n in "ABC":
            assert k[n].shape == (L1, k["Lp"])
            np.testing.assert_array_equal(k[n][:, :L1].numpy(),
                                          tab[n].T.numpy())
            assert not k[n][:, L1:].any()
        # JAX's captured l_s give the same bounds at the kernels' groups
        ls = np.asarray(jref[("host", lmax, ns, ni)]["l0"])[:Tk, :L1]
        np.testing.assert_array_equal(
            leg._bounds_table(ls, lmax, tab["theta"][:Tk], 1, leg._TG,
                              k["Lp"], k["ng"] * leg._TG, L1), want)


@pytest.mark.parametrize("T", [10, 11])
def test_fold_helpers(T):
    G = _maps(T, (2, T, 9)) + 1j * _maps(T + 1, (2, T, 9))
    for got, ref in zip(leg._fold_G(torch.as_tensor(G), T),
                        ps._fold_G(jnp.asarray(G), T, 9)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    Th = (T + 1) // 2
    north, south = G[:, :Th], G[:, Th - 1::-1].copy()
    got = leg._unfold_acc(torch.as_tensor(north), torch.as_tensor(south), T)
    ref = ps._unfold_acc(jnp.asarray(north), jnp.asarray(south), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(leg._north_south(torch.as_tensor(G), T),
                        ps._north_south(jnp.asarray(G), T)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(leg._parity_grid_np(8),
                                  ps._parity_grid_np(8))


@pytest.mark.parametrize("key", [(47, (0,), 0, "fold"), (48, (0,), 0, "fold"),
                                 (47, (-2, 2), 0, "half"),
                                 (47, (-2, 2), 1, "half")])
def test_captured_seeds(jref, key):
    """The port's float64 capture pass lands on JAX's l_s, with the same
    seed pair and exponent."""
    lmax, ns, ni, layout = key
    host = jref[("host", lmax, ns, ni)]
    k = leg.kernel_tables(leg.tables(lmax, tsht.gauss_legendre_rings(lmax),
                                     ns, ni, layout))
    Tk, L1 = k["Tk"], lmax + 1
    cut = lambda a: np.asarray(a)[:Tk, :L1].T
    np.testing.assert_array_equal(k["ls"].numpy(), cut(host["l0"]))
    np.testing.assert_array_equal(k["se"].numpy(), cut(host["se"]))
    for mine, hi, lo in ((k["s1_32"], "sm", "sl"), (k["s0_32"], "smP",
                                                    "slP")):
        want = cut(host[hi]).astype(np.float64) + cut(host[lo])
        np.testing.assert_array_equal(mine.numpy(), cut(host[hi]))
        mant = (k["s1"] if hi == "sm" else k["s0"]).numpy() \
            * 2.0 ** (30 * k["se"].numpy())
        assert _rel(mant, want) <= TOL_SEED


# ------------------------------------------------- float64 vs the JAX scan

@pytest.mark.parametrize("grid", ["gl", "cc", "asym"])
def test_f64_transforms_vs_scan(grid):
    lmax = 31
    rj, rt = _rings(jsht, grid, lmax), _rings(tsht, grid, lmax)
    m = _maps(7, (2, 2) + rj.shape, np.float64)
    a = jsht.map2alm(jnp.asarray(m[:, 0]), rj, lmax)
    got = tsht.map2alm(torch.as_tensor(m[:, 0]), rt, lmax)
    assert got.dtype == torch.complex128 and _rel(got, a) <= TOL_F64
    ref = jsht.alm2map(a, rj, lmax)
    got = tsht.alm2map(torch.as_tensor(np.asarray(a)), rt, lmax)
    assert got.dtype == torch.float64 and _rel(got, ref) <= TOL_F64
    e, b = jsht.map2alm_spin(jnp.asarray(m[:, 0]), jnp.asarray(m[:, 1]), rj,
                             lmax)
    ge, gb = tsht.map2alm_spin(torch.as_tensor(m[:, 0]),
                               torch.as_tensor(m[:, 1]), rt, lmax)
    scale = float(np.abs(np.asarray(e)).max())
    assert np.abs(ge.numpy() - np.asarray(e)).max() <= TOL_F64 * scale
    assert np.abs(gb.numpy() - np.asarray(b)).max() <= TOL_F64 * scale
    q, u = jsht.alm2map_spin(e, b, rj, lmax)
    gq, gu = tsht.alm2map_spin(torch.as_tensor(np.asarray(e)),
                               torch.as_tensor(np.asarray(b)), rt, lmax)
    assert _rel(gq, q) <= TOL_F64 and _rel(gu, u) <= TOL_F64
    teb = np.stack([np.asarray(a)[0], np.asarray(e)[0], np.asarray(b)[0]])
    got = tsht.alm2map_pol(torch.as_tensor(teb), rt, lmax)
    assert _rel(got, jsht.alm2map_pol(jnp.asarray(teb), rj, lmax)) <= TOL_F64
    got = tsht.map2alm_pol(got, rt, lmax)
    assert _rel(got, jsht.map2alm_pol(jsht.alm2map_pol(jnp.asarray(teb), rj,
                                                       lmax), rj, lmax)) \
        <= TOL_F64


# ------------------------------------ float32 vs the JAX Pallas kernels

@pytest.mark.parametrize("key", [("ana", 47, "gl"), ("ana", 48, "gl"),
                                 ("ana", 47, "asym"), ("syn", 47, "gl"),
                                 ("syn", 48, "gl"), ("syn", 47, "asym")])
def test_f32_vs_pallas(jref, key):
    """Batched (lmax 47, even T) and single (lmax 48, odd T) on the folded
    grid, and the unfolded asymmetric grid."""
    kind, lmax, grid = key
    rings = _rings(tsht, grid, lmax)
    x, ref = jref[key]
    fn = tsht.map2alm if kind == "ana" else tsht.alm2map
    got = fn(torch.as_tensor(x), rings, lmax)
    assert got.dtype == (torch.complex64 if kind == "ana" else torch.float32)
    assert tuple(got.shape) == ref.shape and _rel(got, ref) <= TOL_F32


def test_spin2_f32_vs_pallas(jref):
    """Spin 2, folded and packed (two maps)."""
    rings = tsht.gauss_legendre_rings(47)
    q, u, e, b = jref["spin_ana"]
    ge, gb = tsht.map2alm_spin(torch.as_tensor(q), torch.as_tensor(u), rings,
                               47)
    scale = np.abs(e).max()
    assert np.abs(ge.numpy() - e).max() <= TOL_F32 * scale
    assert np.abs(gb.numpy() - b).max() <= TOL_F32 * scale
    e, b, qq, uu = jref["spin_syn"]
    gq, gu = tsht.alm2map_spin(torch.as_tensor(e), torch.as_tensor(b), rings,
                               47)
    assert _rel(gq, qq) <= TOL_F32 and _rel(gu, uu) <= TOL_F32


def test_f32_roundtrip():
    lmax = 63
    rings = tsht.gauss_legendre_rings(lmax)
    rng = np.random.default_rng(2)
    n = talm.nalm(lmax)
    a0 = torch.complex(*(torch.as_tensor(rng.standard_normal(n)
                                         .astype(np.float32))
                         for _ in range(2)))
    a0[: lmax + 1] = a0[: lmax + 1].real.to(a0.dtype)   # m = 0 real
    a1 = tsht.map2alm(tsht.alm2map(a0, rings, lmax), rings, lmax)
    assert (a1 - a0).abs().max().item() <= TOL_RT
    with pytest.raises(NotImplementedError):
        tsht.alm2map_spin(a0, a0, rings, lmax, spin=1)


# ------------------------------ the kernel's algorithm, emulated on the CPU
# (leg._kernel_ana / _kernel_syn; the fast mode's plain version is this
# emulation)

@pytest.mark.parametrize("seeds", ["port", "jax"])
def test_kernel_algorithm_vs_pallas(jref, seeds):
    """The transforms run through the kernels' algorithm (emulated) on the
    port's own captured seeds and on JAX's, against the JAX kernels."""
    for lmax, grid, ns, layout in ((47, "gl", (0,), "fold"),
                                   (48, "gl", (0,), "fold"),
                                   (47, "asym", (0,), "full"),
                                   (47, "gl", (-2, 2), "half")):
        rings = _rings(tsht, grid, lmax)
        own = {}
        if seeds == "jax":
            # the transform's tables with JAX's captured seeds, by Wigner
            # column
            for ni in range(len(ns)):
                hkey = ("host", lmax, "asym") if grid == "asym" \
                    else ("host", lmax, ns, ni)
                own[ni] = convert.load_sht_tables(
                    leg.tables(lmax, rings, ns, ni, layout), jref[hkey])
        ana = lambda G, tab: leg._kernel_ana(G, own.get(tab["ni"], tab))
        syn = lambda a, tab: leg._kernel_syn(a, own.get(tab["ni"], tab))
        if ns == (0,):
            x, ref = jref[("ana", lmax, grid)]
            assert _rel(tsht.map2alm(torch.as_tensor(x), rings, lmax,
                                     ana=ana), ref) <= TOL_F32
            x, ref = jref[("syn", lmax, grid)]
            assert _rel(tsht.alm2map(torch.as_tensor(x), rings, lmax,
                                     syn=syn), ref) <= TOL_F32
        else:
            q, u, e, b = jref["spin_ana"]
            ge, _ = tsht.map2alm_spin(torch.as_tensor(q), torch.as_tensor(u),
                                      rings, lmax, ana=ana)
            assert _rel(ge, e) <= TOL_F32
            e, b, qq, _ = jref["spin_syn"]
            gq, _ = tsht.alm2map_spin(torch.as_tensor(e), torch.as_tensor(b),
                                      rings, lmax, syn=syn)
            assert _rel(gq, qq) <= TOL_F32
    # the JAX tables went to the emulator only: the port's own are intact
    tab = leg.tables(47, _rings(tsht, "gl", 47), (0,), 0, "fold")
    assert "kernel" not in tab
    k = leg.kernel_tables(tab)
    assert k["ls"].shape == (48, 24)
    leg.clear_tables()
    again = leg.tables(47, _rings(tsht, "gl", 47), (0,), 0, "fold")
    assert again is not tab and leg.kernel_tables(again) is not k
    assert torch.equal(leg.kernel_tables(again)["ls"], k["ls"])


def test_kernel_algorithm_fast(jref):
    """The fast mode's float32 recurrence against the default mode, and
    against the JAX fast kernel on the same seeds."""
    lmax = 48
    rings = tsht.gauss_legendre_rings(lmax)
    tab = leg.tables(lmax, rings, (0,), 0, "fold")
    m = torch.as_tensor(jref[("ana", lmax, "gl")][0])
    w = tsht._weights(rings, torch.float32, "cpu")
    G = (tsht._ring_analysis(m, rings, lmax) * w[:, None])[None]
    dd = leg._kernel_ana(G, tab)
    fast = leg._kernel_ana(G, tab, fast=True)
    assert _rel(fast, dd) <= TOL_FAST
    got = tsht._mat2alm(fast[0], lmax)
    assert _rel(got, jref["fast"]) <= TOL_FAST
    a = dd[:, :, :]
    assert _rel(leg._kernel_syn(a, tab, True),
                leg._kernel_syn(a, tab)) <= TOL_FAST


def test_fast_plain_version():
    """The plain versions with ``fast`` on float32 inputs are the fast
    kernel's algorithm, and the wrappers take them for CPU tensors; float64
    inputs take the float64 loop whatever ``fast`` says, as the kernels'
    float64 instance does."""
    lmax = 40
    rings = tsht.gauss_legendre_rings(lmax)
    rng = np.random.default_rng(5)
    for layout, ns, ni in (("fold", (0,), 0), ("half", (-2, 2), 0)):
        tab = leg.tables(lmax, rings, ns, ni, layout)
        G = torch.complex(*(torch.as_tensor(rng.standard_normal(
            (2, tab["Tr"], lmax + 1)), dtype=torch.float32)
            for _ in range(2)))
        a = torch.complex(*(torch.as_tensor(rng.standard_normal(
            (2, lmax + 1, lmax + 1)), dtype=torch.float32)
            for _ in range(2)))
        for fn, ref, emu, x in ((leg.legendre_ana, leg.legendre_ana_ref,
                                 leg._kernel_ana, G),
                                (leg.legendre_syn, leg.legendre_syn_ref,
                                 leg._kernel_syn, a)):
            want = emu(x, tab, True)
            assert torch.equal(ref(x, tab, fast=True), want)
            assert torch.equal(fn(x, tab, fast=True), want)
            dd = ref(x, tab)
            assert 0 < _rel(want, dd) <= TOL_FAST
            x64 = x.to(torch.complex128)
            assert torch.equal(ref(x64, tab, fast=True), ref(x64, tab))
