"""Cross-only lensing 4-point estimator from data splits (port of
``orphics_tpu.models.splitlens``).

Reference ``orphics/lensing.py:959`` ``SplitLensing`` — the unbiased
kappa power from nsplits >= 4 splits that uses no auto-spectra (Madhavacheril
et al. split-based estimator). The per-pair QE fragments are our native
:class:`~orphics_tpu_torch.models.qe.QE`; the combinatorics carry over
exactly, on the device of the split k-maps.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve

from ..geometry import Geometry
from ..ops import fourier as F

__all__ = ["SplitLensing"]


class SplitLensing:
    def __init__(self, geom: Geometry, qest, XY: str = "TT"):
        self.geom = geom
        self.qest = qest
        self.est = XY

    def qpower(self, k1, k2):
        return F.f2power(k1, k2, self.geom)

    def qfrag(self, a, b):
        """kappa fragment from two k-map legs (returns raw-fft kappa)."""
        return self.qest.kappa_from_map(self.est, a, b, return_ft=True)

    def cross_estimator(self, ksplits, device=None):
        """Unbiased 4-point kappa power from split k-maps
        (reference ``lensing.py:980``; requires nsplits >= 4); a host array
        goes to ``device`` (``None``: the card)."""
        splits = ksplits if isinstance(ksplits, torch.Tensor) \
            else torch.as_tensor(np.asarray(ksplits), device=resolve(device))
        n = splits.shape[0]
        ns = float(n)
        s = splits.mean(dim=0)
        k = self.qfrag(s, s)
        kiisum = 0.0
        psum = 0.0
        psum2 = 0.0
        for i in range(n):
            mi = splits[i]
            ki = 0.5 * (self.qfrag(mi, s) + self.qfrag(s, mi))
            kii = self.qfrag(mi, mi)
            kiisum = kiisum + kii
            kic = ki - kii / ns
            psum = psum + self.qpower(kic, kic)
            for j in range(i + 1, n):
                mj = splits[j]
                kij = 0.5 * (self.qfrag(mi, mj) + self.qfrag(mj, mi))
                psum2 = psum2 + self.qpower(kij, kij)
        kc = k - kiisum / ns ** 2
        return ((ns ** 4) * self.qpower(kc, kc) - 4.0 * ns ** 2 * psum
                + 4.0 * psum2) / ns / (ns - 1.0) / (ns - 2.0) / (ns - 3.0)
