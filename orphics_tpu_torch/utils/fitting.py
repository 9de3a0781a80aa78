"""Linear-model fitting, PTEs, sampling, and covariance utilities (port of
``orphics_tpu.utils.fitting``).

Reference: ``orphics/stats.py`` — ``fit_linear_model`` (:168),
``fit_linear_model_pte_from_sims`` (:192), ``fit_gauss`` (:203),
``sim_pte/get_pte/nsigma_from_pte`` (:47,43,39),
``InverseTransformSampling`` (:55), ``Solver``/``solve`` (:213,232),
``OQE`` (:365), ``CinvUpdater``/``sm_update`` (:494,525), ``cov2corr``
(:542), ``correlated_hybrid_matrix`` (:549), ``extrapolate_power_law``
(:18), ``get_sigma2`` (:133), ``npspace`` (:775). The linear algebra runs
in torch on the inputs' device (host arrays: ``device``, ``None`` the
card), the curve fits in host scipy, as in the JAX package. Draws take a
``torch.Generator`` in place of a JAX key.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from .._device import as_tensor, resolve

__all__ = ["fit_linear_model", "fit_linear_model_pte_from_sims", "fit_gauss",
           "get_pte", "sim_pte", "nsigma_from_pte", "pte_from_nsigma",
           "InverseTransformSampling", "InverseTransformSampling2D",
           "eig_analyze", "Solver", "solve", "OQE",
           "CinvUpdater", "sm_update", "cov2corr",
           "correlated_hybrid_matrix", "extrapolate_power_law",
           "get_sigma2", "npspace", "alpha_from_confidence", "timeit"]


def npspace(minim, maxim, num, scale="lin"):
    if scale in ("lin", "linear"):
        return np.linspace(minim, maxim, num)
    if scale == "log":
        return np.logspace(np.log10(minim), np.log10(maxim), num)
    raise ValueError(scale)


def _generator(generator, seed, device):
    """``generator``, or a new one on ``device`` seeded with ``seed`` (the
    JAX functions' default key is ``PRNGKey(seed)``)."""
    if generator is not None:
        return generator
    g = torch.Generator(device=resolve(device))
    g.manual_seed(seed)
    return g


# ------------------------------------------------------------------
# PTEs
# ------------------------------------------------------------------

def nsigma_from_pte(pte):
    from scipy.special import erfinv
    return erfinv(1 - pte) * np.sqrt(2)


def pte_from_nsigma(nsigma):
    from scipy.special import erf
    return 1 - erf(nsigma / np.sqrt(2))


def get_pte(chisquare_data, chisquares_sims):
    sims = np.asarray(chisquares_sims)
    return sims[chisquare_data < sims].size / sims.size


def _chi2_draws(covmat, nsamples, generator):
    """Gaussian draws ``(nsamples, n)`` from ``covmat`` (its Cholesky
    factor times standard normals from ``generator``)."""
    L = torch.linalg.cholesky(covmat)
    draws = torch.randn((nsamples, covmat.shape[0]), generator=generator,
                        dtype=covmat.dtype, device=covmat.device)
    return draws @ L.T


def sim_pte(data, covmat, nsamples, generator=None, device=None):
    """PTE of data chi^2 against Gaussian draws from covmat (reference
    ``stats.py:55``); ``generator`` (default: seed 0 on the covariance's
    device) draws the samples."""
    covmat = as_tensor(covmat, device)
    data = as_tensor(data, covmat.device, covmat.dtype)
    cinv = torch.linalg.inv(covmat)
    chisq = float(data @ cinv @ data)
    gen = _generator(generator, 0, covmat.device)
    samples = _chi2_draws(covmat, nsamples, gen)
    chis = torch.einsum("ij,jk,ik->i", samples, cinv, samples)
    return get_pte(chisq, chis.cpu().numpy())


# ------------------------------------------------------------------
# Linear-model fits
# ------------------------------------------------------------------

def fit_linear_model(x, y, ycov, funcs, dofs=None, deproject=False,
                     Cinv=None, Cy=None):
    """GLS fit of y = sum_i a_i f_i(x); returns (coeffs, coeff_cov,
    chi2/dof, pte) — reference ``stats.py:168`` (host numpy, as the JAX
    package)."""
    from scipy.stats import chi2 as chi2dist
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1, 1)
    C = np.asarray(ycov)
    A = np.stack([np.asarray(f(x)) for f in funcs], axis=1)
    s = (lambda M, v: solve(M, v, device="cpu")) if deproject \
        else np.linalg.solve
    CA = s(C, A) if Cinv is None else Cinv @ A
    cov = np.linalg.inv(A.T @ CA)
    if Cy is None:
        Cy = s(C, y) if Cinv is None else Cinv @ y
    X = cov @ (A.T @ Cy)
    YAX = y - A @ X
    CYAX = s(C, YAX) if Cinv is None else Cinv @ YAX
    chisq = float((YAX.T @ CYAX).ravel()[0])
    dofs = len(x) - len(funcs) if dofs is None else dofs
    pte = 1 - chi2dist.cdf(chisq, dofs)
    return X, cov, chisq / dofs, pte


def fit_linear_model_pte_from_sims(x, y, ycov, funcs, y_fiducial,
                                   nsims=10000, generator=None, device=None,
                                   **kw):
    """PTE of the fit chi^2 against fiducial-model Gaussian sims
    (reference ``stats.py:192``), the per-sim GLS solved as one batched
    product on ``device`` (``None``: the card) instead of a Python loop;
    ``generator`` (default: seed 1 there) draws the sims."""
    X_data, cov_data, chisq_data, _ = fit_linear_model(x, y, ycov, funcs)
    x = np.asarray(x)
    C = as_tensor(np.asarray(ycov, np.float64), device)
    A = torch.as_tensor(np.stack([np.asarray(f(x)) for f in funcs], axis=1),
                        dtype=C.dtype, device=C.device)
    gen = _generator(generator, 1, C.device)
    samples = torch.as_tensor(np.asarray(y_fiducial), dtype=C.dtype,
                              device=C.device) + _chi2_draws(C, nsims, gen)
    Cinv = torch.linalg.inv(C)
    cov = torch.linalg.inv(A.T @ Cinv @ A)
    X = (samples @ Cinv @ A) @ cov.T                 # (nsims, nfuncs)
    r = samples - X @ A.T
    chis = torch.einsum("si,ij,sj->s", r, Cinv, r).cpu().numpy() \
        / (len(x) - len(funcs))
    pte = get_pte(chisq_data, chis)
    return X_data, cov_data, chisq_data, pte


def fit_cltt_power(ells, cls, cltt_func, w0, sigma2, ell0=0, alpha=1,
                   fix_knee=False):
    """Fit binned TT power to theory + white + red noise amplitudes
    (reference ``stats.py:148``). Returns a callable model."""
    from scipy.optimize import curve_fit
    from ..geometry import arcmin
    ells = np.asarray(ells, dtype=float)
    cls = np.asarray(cls, dtype=float)
    sw0 = w0 * arcmin
    if fix_knee:
        funcs = [lambda x: np.full_like(np.asarray(x, float), sw0 ** 2)]
        p0 = [1.0]
    else:
        funcs = [lambda x: np.full_like(np.asarray(x, float), sw0 ** 2),
                 lambda x: (sw0 ** 2 * (ell0 / np.asarray(x, float))
                            ** (-alpha) if ell0 > 1e-3
                            else np.full_like(np.asarray(x, float), sw0 ** 2))]
        p0 = [1.0, ell0 if ell0 > 1e-3 else 1.0]
    model = lambda x, *args: sum(a * f(x) for a, f in zip(args, funcs))
    X, _ = curve_fit(model, ells, cls - np.asarray(cltt_func(ells)),
                     p0=p0, sigma=np.sqrt(np.asarray(sigma2)),
                     absolute_sigma=True, bounds=(0, np.inf))
    return lambda x: (np.asarray(cltt_func(x))
                      + sum(c * f(x) for c, f in zip(X, funcs)))


def fit_gauss(x, y, mu_guess=None, sigma_guess=None):
    """Gaussian fit to a curve (reference ``stats.py:203``)."""
    from scipy.optimize import curve_fit
    x = np.asarray(x)
    y = np.asarray(y)
    ynorm = np.trapezoid(y, x)
    yn = y / ynorm
    gaussian = lambda t, mu, s: np.exp(-(t - mu) ** 2 / 2 / s ** 2) \
        / np.sqrt(2 * np.pi * s ** 2)
    popt, _ = curve_fit(gaussian, x, yn, p0=[mu_guess, sigma_guess])
    return popt[0], abs(popt[1]), ynorm, yn


def get_sigma2(ells, cls, w0, delta_ells, fsky, ell0=0, alpha=1,
               w0p=None, ell0p=0, alphap=1, clxx=None, clyy=None):
    """Knox per-bandpower variance of an auto or cross spectrum with
    atmospheric (red) noise — same signature and semantics as reference
    ``stats.py:133``: the noise term is the red component alone
    ``(w0 rad)^2 (ell0/l)^{-alpha}`` (zero when ``ell0`` is), and the
    result is divided by the bandpower width ``delta_ells``."""
    from ..geometry import arcmin
    ells = np.asarray(ells, dtype=float)
    afact = ((ell0 / ells) ** (-alpha)) if ell0 > 1e-3 else 0.0 * ells
    nlxx = (w0 * arcmin) ** 2 * afact
    if clxx is not None:
        afact = ((ell0p / ells) ** (-alphap)) if ell0 > 1e-3 else 0.0 * ells
        nlyy = (w0p * arcmin) ** 2 * afact
        tcl2 = np.asarray(cls) ** 2 + (clxx + nlxx) * (clyy + nlyy)
    else:
        assert clyy is None and w0p is None
        tcl2 = 2.0 * (np.asarray(cls) + nlxx) ** 2
    return tcl2 / (2 * ells + 1) / fsky / delta_ells


# ------------------------------------------------------------------
# Cinv application with deprojection
# ------------------------------------------------------------------

class Solver:
    """Apply C^-1 with rank-k template deprojection (reference
    ``stats.py:213``); host arrays go to ``device`` (``None``: the
    card)."""

    def __init__(self, C, u=None, device=None):
        C = as_tensor(C, device)
        N = C.shape[0]
        if u is None:
            u = torch.ones((N, 1), dtype=C.dtype, device=C.device)
        u = as_tensor(u, C.device, C.dtype)
        Cinvu = torch.linalg.solve(C, u)
        self.precalc = Cinvu @ torch.linalg.solve(u.T @ Cinvu, u.T)
        self.C = C

    def solve(self, x):
        Cinvx = torch.linalg.solve(self.C, as_tensor(x, self.C.device,
                                                     self.C.dtype))
        return Cinvx - self.precalc @ Cinvx


def solve(C, x, u=None, device=None):
    """Deprojected C^-1 x (reference ``stats.py:232``), as a host array."""
    return Solver(C, u=u, device=device).solve(x).cpu().numpy()


# ------------------------------------------------------------------
# Optimal quadratic estimator (reference stats.py:365)
# ------------------------------------------------------------------

class OQE:
    """Optimal quadratic estimator for Gaussian likelihoods: precomputes
    C^-1 dC/dp products and the Fisher matrix; ``estimate(data)`` returns
    bias-subtracted parameter estimates. The solves run on ``device``
    (``None``: the card), the Fisher algebra on the host."""

    def __init__(self, fid_cov, dcov_dict: Dict, fid_params_dict: Dict,
                 deproject=True, templates=None, device=None):
        self.params = list(dcov_dict.keys())
        self.fids = fid_params_dict
        fid_cov = as_tensor(fid_cov, device)
        if deproject:
            self._solver = Solver(fid_cov, u=templates)
            slv = self._solver.solve
        else:
            slv = lambda x: torch.linalg.solve(
                fid_cov, as_tensor(x, fid_cov.device, fid_cov.dtype))
        self.solver = slv
        self.ps = {p: slv(dcov_dict[p]).cpu().numpy() for p in self.params}
        self.biases = {p: np.trace(self.ps[p]) for p in self.params}
        n = len(self.params)
        self.Fisher = np.zeros((n, n))
        for (p1, p2) in itertools.combinations_with_replacement(self.params,
                                                                2):
            i, j = self.params.index(p1), self.params.index(p2)
            self.Fisher[i, j] = 0.5 * np.trace(self.ps[p1] @ self.ps[p2])
            self.Fisher[j, i] = self.Fisher[i, j]
        self.Finv = np.linalg.inv(self.Fisher)
        self.marg_errors = np.sqrt(np.diagonal(self.Finv))

    def sigma(self):
        return dict(zip(self.params, self.marg_errors.tolist()))

    def estimate(self, data):
        data = np.asarray(data)
        cinvdat = self.solver(data).cpu().numpy()
        vec = [float(data.T @ self.ps[p] @ cinvdat) - self.biases[p]
               for p in self.params]
        ans = 0.5 * self.Finv @ np.asarray(vec)
        return {p: self.fids[p] + ans[i] for i, p in enumerate(self.params)}


OQESlim = OQE  # the deproject=True specialization is the default here


# ------------------------------------------------------------------
# Rank-1 covariance updates (reference stats.py:494-540)
# ------------------------------------------------------------------

def sm_update(Ainv, u, v=None, device=None):
    """Sherman-Morrison: (A + u v^T)^-1 from A^-1; host arrays go to
    ``device`` (``None``: the card)."""
    Ainv = as_tensor(Ainv, device)
    u = as_tensor(u, Ainv.device, Ainv.dtype).reshape(-1, 1)
    v = u if v is None else as_tensor(v, Ainv.device,
                                      Ainv.dtype).reshape(-1, 1)
    ldot = float((v.T @ (Ainv @ u)).squeeze())
    det_update = 1.0 + ldot
    ans = Ainv - (Ainv @ (u @ v.T) @ Ainv) / det_update
    return ans, det_update


class CinvUpdater:
    """Amplitude-scaled rank-1 updates of a set of Cinvs (reference
    ``stats.py:494``) — for profile-amplitude likelihoods; host arrays go
    to ``device`` (``None``: the card)."""

    def __init__(self, cinvs, logdets, profile, device=None):
        self.cinvs = [as_tensor(c, device) for c in cinvs]
        self.logdets = logdets
        c0 = self.cinvs[0]
        u = as_tensor(profile, c0.device, c0.dtype).reshape(-1, 1)
        self.update_unnormalized = [c @ (u @ u.T) @ c for c in self.cinvs]
        self.det_unnormalized = [float((u.T @ (c @ u)).squeeze())
                                 for c in self.cinvs]

    def get_cinv(self, index, amplitude):
        det_update = 1.0 + amplitude ** 2 * self.det_unnormalized[index]
        cinv = (self.cinvs[index]
                - amplitude ** 2 * self.update_unnormalized[index]
                / det_update)
        return cinv, np.log(det_update) + self.logdets[index]


# ------------------------------------------------------------------
# misc covariance utilities
# ------------------------------------------------------------------

def cov2corr(mat):
    mat = np.asarray(mat)
    d = np.sqrt(np.diagonal(mat))
    return mat / d[:, None] / d[None, :]


def correlated_hybrid_matrix(data_covmat, theory_covmat=None,
                             theory_corr=None, cap=True, cap_off=0.99):
    """Diagonal data variances + theory correlation structure
    (reference ``stats.py:549``)."""
    if theory_corr is None:
        theory_corr = cov2corr(theory_covmat)
    r = np.array(theory_corr, copy=True)
    if cap:
        r = np.clip(r, -cap_off, cap_off)
        np.fill_diagonal(r, 1.0)
    d = np.sqrt(np.diagonal(np.asarray(data_covmat)))
    return r * d[:, None] * d[None, :]


def extrapolate_power_law(x, y, x_extra, x_percentile=30.0):
    """Power-law extension of a curve from its high-x tail
    (reference ``stats.py:18``)."""
    from scipy.optimize import curve_fit
    x = np.asarray(x)
    y = np.asarray(y)
    threshold = np.percentile(x, 100 - x_percentile)
    sel = x >= threshold
    popt, _ = curve_fit(lambda xx, a, b: a * xx ** b, x[sel], y[sel])
    y_extra = popt[0] * np.asarray(x_extra) ** popt[1]
    return np.append(x, x_extra), np.append(y, y_extra)


def _interp(u, xp, fp):
    """``numpy.interp`` of ``u`` on an ascending table, in torch: one table
    ``xp`` / ``fp`` for all of ``u`` (1-D), or a table per entry (their
    leading shape is ``u``'s)."""
    n = xp.shape[-1]
    if xp.ndim == 1:
        xp, fp = xp.expand(u.shape + (n,)), fp.expand(u.shape + (n,))
    i = torch.searchsorted(xp.contiguous(), u.unsqueeze(-1)).squeeze(
        -1).clamp(1, n - 1)
    x0, x1 = xp.gather(-1, (i - 1)[..., None])[..., 0], \
        xp.gather(-1, i[..., None])[..., 0]
    f0, f1 = fp.gather(-1, (i - 1)[..., None])[..., 0], \
        fp.gather(-1, i[..., None])[..., 0]
    t = torch.where(x1 > x0, (u - x0) / torch.where(x1 > x0, x1 - x0, 1.0),
                    0.0)
    out = f0 + t.clamp(0.0, 1.0) * (f1 - f0)
    out = torch.where(u <= xp[..., 0], fp[..., 0], out)
    return torch.where(u >= xp[..., -1], fp[..., -1], out)


class InverseTransformSampling:
    """Sample from an arbitrary tabulated 1D PDF (reference
    ``stats.py:55``) with a ``torch.Generator``; the tables live on
    ``device`` (``None``: the card)."""

    def __init__(self, xvals, pdf_vals, device=None):
        x = np.asarray(xvals, dtype=np.float64)
        p = np.maximum(np.asarray(pdf_vals, dtype=np.float64), 0)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                               * np.diff(x))])
        cdf /= cdf[-1]
        dev = resolve(device)
        self._x = torch.as_tensor(x, device=dev)
        self._cdf = torch.as_tensor(cdf, device=dev)

    def generate(self, nsamples, generator=None):
        gen = _generator(generator, 0, self._x.device)
        u = torch.rand((nsamples,), generator=gen, dtype=torch.float64,
                       device=self._x.device)
        return _interp(u, self._cdf, self._x)


def alpha_from_confidence(c):
    """n-sigma for c-probability enclosure of a 2D Gaussian
    (reference ``stats.py:~250``)."""
    return np.sqrt(2.0 * np.log(1.0 / (1.0 - c)))


def _sync(out):
    """Wait for the card's work on every CUDA tensor in ``out`` (a tensor
    or nested lists, tuples and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)
    return out


def timeit(fn):
    """Wall-time decorator (reference ``stats.py:902``); waits for the
    card's results so the number is honest."""
    import functools
    import time as _time

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        t0 = _time.perf_counter()
        out = _sync(fn(*a, **kw))
        print(f"{fn.__name__}: {_time.perf_counter() - t0:.6f} s")
        return out

    return wrapped


class InverseTransformSampling2D:
    """Sample from an arbitrary tabulated 2D PDF p(y, x) (reference
    ``stats.py:120``), vectorized: the marginal p(y) and every conditional
    p(x|y) CDF are tabulated once, and ``generate`` is table lookups. The
    tables live on ``device`` (``None``: the card)."""

    def __init__(self, ys, xs, updf, bounds_error=False, device=None):
        ys = np.asarray(ys, np.float64)
        xs = np.asarray(xs, np.float64)
        pdf = np.maximum(np.asarray(updf, np.float64), 0.0)
        pdf = pdf / np.trapezoid(np.trapezoid(pdf, xs), ys)
        dev = resolve(device)
        self.ys = torch.as_tensor(ys, device=dev)
        self.xs = torch.as_tensor(xs, device=dev)
        mpdf_y = np.trapezoid(pdf, xs)                    # (ny,)
        cdf_y = np.concatenate([[0.0], np.cumsum(
            0.5 * (mpdf_y[1:] + mpdf_y[:-1]) * np.diff(ys))])
        self._cdf_y = torch.as_tensor(cdf_y / cdf_y[-1], device=dev)
        with np.errstate(invalid="ignore", divide="ignore"):
            cpdf = np.nan_to_num(pdf / mpdf_y[:, None])   # p(x | y)
        ccdf = np.concatenate(
            [np.zeros((len(ys), 1)),
             np.cumsum(0.5 * (cpdf[:, 1:] + cpdf[:, :-1])
                       * np.diff(xs)[None, :], axis=1)], axis=1)
        ccdf = ccdf / np.maximum(ccdf[:, -1:], 1e-300)
        self._ccdf = torch.as_tensor(ccdf, device=dev)   # (ny, nx)

    def generate(self, nsamples, generator=None):
        """Returns (ysamples, xsamples) tensors of length nsamples."""
        gen = _generator(generator, 0, self.ys.device)
        kw = dict(generator=gen, dtype=torch.float64, device=self.ys.device)
        uy = torch.rand((nsamples,), **kw)
        ysamp = _interp(uy, self._cdf_y, self.ys)
        iy = torch.searchsorted(self.ys, ysamp).clamp(0, len(self.ys) - 1)
        ux = torch.rand((nsamples,), **kw)
        xsamp = _interp(ux, self._ccdf[iy], self.xs.expand(nsamples, -1))
        return ysamp, xsamp


def eig_analyze(cmb2d, start=0, eigfunc=np.linalg.eigh, plot_file=None):
    """Eigenvalue diagnostic of a (ncomp, ncomp, ny, nx) 2D power matrix
    (reference ``stats.py:~190``): prints the minimum eigenvalue and
    whether any are negative; optionally plots the sorted spectra (the
    JAX function imports its ``Plotter`` from ``utils.io``, which has
    none; the port takes ``utils.plot``'s)."""
    es = eigfunc(np.asarray(cmb2d)[start:, start:, ...].T)[0]
    print(start, es.min(), np.any(es < 0.0))
    if plot_file is not None:
        from .plot import Plotter
        numw = range(int(np.prod(es.shape[:-1])))
        pl = Plotter(xlabel="n", ylabel="e", yscale="log")
        for ind in range(es.shape[-1]):
            pl.add(numw, np.sort(np.real(es[..., ind].ravel())))
            pl.add(numw, np.sort(np.imag(es[..., ind].ravel())), ls="--")
        pl.done(plot_file)
    return es
