"""Curve fits (part of the port of ``orphics_tpu.utils.fitting``).

Only :func:`fit_gauss` is ported so far: ``models/nfwfit.fit_nfw_profile``
uses it. It is host numpy and scipy, as in the JAX package. The rest of
that module (linear-model fits, PTEs, samplers, solvers) is ROADMAP queue
A, item 21.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fit_gauss"]


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
