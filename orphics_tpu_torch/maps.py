"""Facade mirroring the reference's ``orphics.maps`` public API (port of
``orphics_tpu.maps``).

Thin, reference-shaped wrappers over the port's implementations in
``orphics_tpu_torch.ops`` / ``orphics_tpu_torch.models``. Users of the
reference (``orphics/maps.py``) find the same names here; functions take a
:class:`~orphics_tpu_torch.geometry.Geometry` instead of ``(shape, wcs)``
and ``torch.Generator`` draws instead of integer seeds. ``MapRotator`` is
the spherical one of ``models/curved.py``, as in the JAX facade.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import as_tensor
from .ops.interp import interp as _interp

from .geometry import Geometry, rect_geometry, arcmin, degree
from .ops import fourier as _F
from .ops.binning import Bin2D, bin_in_annuli
from .models import grf as _grf
from .models.grf import (MapGen, spec2flat, harm2map, map2harm, cmb_ps,
                         white_noise)
from .models.fastcl import FastCl
from .models.mapstools import (
    flux, MatchedFilter, matched_filter, FourierStack,
    get_normalized_center, mask_center, crop_center, get_central, Purify,
    iqu_to_pure_lteb, inpaint_cg, analytical_tf, minimum_ell, cosine_taper,
    downsample_power, SymMat, symmat_from_data, sanitize_beam,
    gapfill_edge_conv_flat, binary_mask, area, fsky, area_sqdeg, rescale,
    rotate, diagonal_cov, ncov, thumbnail_healpix,
    generate_correlated_alm, ftrans, real_space_filter,
    rfilter)
from .models.curved import (
    synalm_matrix, rand_map, rand_cmb_sim, smoothing, masked_cls,
    cosine_stitch, stitched_noise, kspace_coadd_alms,
    gal2equ_rotation, pointing_rotation, rotate_map, MapRotator,
    galactic_mask, galactic_mask_rings, pixsize_map)
from .models import curved as _curved
from .ops.sht import (RingGeom, gauss_legendre_rings, clenshaw_curtis_rings,
                      map2alm, alm2map, map2alm_spin, alm2map_spin,
                      map2alm_pol, alm2map_pol)
from .models.splits import (split_calc, noise_from_splits,
                            cross_split_spectrum, crossband_errors,
                            error_fsky)
from .models.noise import (rednoise, atm_factor, ivar, rms_from_ivar,
                           modulated_noise_map, get_masked_ivar)
from .models.ilc import (silc, cilc, silc_noise, cilc_noise, ilc_cov,
                         ilc_cinv, ilc_empirical_cov, kspace_coadd,
                         calculate_harmonic_coadd_weights,
                         harmonic_coaddition)
from .ops.distance import cosine_apodize, grow_mask, mask_srcs
from .ops.windows import (cosine_window, get_taper, get_taper_deg,
                          sigma_from_fwhm, fwhm_from_sigma)
from .ops.alm import change_alm_lmax

__all__ = [
    "rect_geometry", "Geometry", "MapGen", "FourierCalc", "binned_power",
    "mask_kspace", "filter_map", "gauss_beam", "wfactor", "spec2flat",
    "harm2map", "map2harm", "cmb_ps", "white_noise", "interp",
]

mask_kspace = _F.mask_kspace
filter_map = _F.filter_map
gauss_beam = _F.gauss_beam


def interp(x, y, fill_value=0.0):
    """1D linear interpolator factory (reference's ubiquitous
    ``maps.interp(ells, cls)(modlmap)`` idiom); the returned function
    evaluates on its argument's device (``device`` for a host array)."""
    x = np.asarray(x)
    y = np.asarray(y)

    def f(xq, device=None):
        return _interp(as_tensor(xq, device), x, y, left=fill_value,
                       right=fill_value)

    return f


class FourierCalc:
    """Reference-shaped wrapper (``orphics/maps.py:1594``) over
    :mod:`orphics_tpu_torch.ops.fourier`, keeping the familiar method
    surface; every method runs on its input's device."""

    def __init__(self, geom: Geometry, iau: bool = False):
        self.geom = geom
        self.iau = iau
        self.normfact = geom.area / geom.npix ** 2

    def fft(self, emap):
        return _F.fft2(emap, self.geom, "raw")

    def ifft(self, kmap):
        return _F.ifft2(kmap, self.geom, "raw")

    def iqu2teb(self, emap):
        k = _F.fft2(emap, self.geom, "raw")
        if k.ndim >= 3 and k.shape[-3] == 3:
            k = _F.iqu2teb(k, self.geom, iau=self.iau)
        return k

    def f2power(self, kmap1, kmap2, pixel_units=False):
        return _F.f2power(kmap1, kmap2, self.geom, pixel_units)

    def f1power(self, map1, kmap2, pixel_units=False):
        k1 = self.iqu2teb(map1)
        return _F.f2power(k1, kmap2, self.geom, pixel_units), k1

    def power2d(self, emap=None, emap2=None, kmap=None, kmap2=None):
        return _F.power2d(emap, emap2, self.geom, iau=self.iau,
                          kmap1=kmap, kmap2=kmap2)


def wfactor(n: int, mask, sq: bool = True, pixsizemap=None, device=None):
    """Mask spectral-window correction w_n = <mask^n> (area weighted).

    Reference ``orphics/maps.py:932``.
    """
    w = as_tensor(mask, device) ** n
    if pixsizemap is not None:
        pixsizemap = as_tensor(pixsizemap, w.device)
        return torch.sum(w * pixsizemap) / torch.sum(pixsizemap)
    return torch.mean(w)


def binned_power(imap, bin_edges=None, binner: Bin2D = None, imap2=None,
                 mask=1.0, geom: Geometry = None, fc: FourierCalc = None,
                 device=None):
    """Map(s) -> masked, binned 1D power with the w2 correction
    (reference ``orphics/maps.py:1350``), on ``imap``'s device (``device``
    for a host map); the power is binned as float32 on ``Bin2D`` (B1 on
    the card). Accepts a precomputed :class:`Bin2D`."""
    imap = as_tensor(imap, device)
    if fc is None:
        fc = FourierCalc(geom)
    geom = fc.geom
    if binner is None:
        binner = Bin2D(geom.modlmap_np(), bin_edges, device=imap.device)
    m2 = imap if imap2 is None else as_tensor(imap2, imap.device)
    mask = as_tensor(mask, imap.device)
    p2d, _, _ = fc.power2d(imap * mask, m2 * mask)
    w2 = wfactor(2, mask.expand(geom.ny, geom.nx))
    cents, p1d = binner.bin((p2d / w2).to(torch.float32))
    return cents, p1d

# --- full reference-name tail (same module path as orphics.maps) -----------
from .models.mapstools import (
    autofiltered_maps, fourier_stack, radial_window, apodize_profile,
    radial_mask, block_smooth, field_variance, random_source_map,
    psizemap, get_ecc, filter_alms, area_from_mask, flat_sim,
    resample_fft, resampled_geometry, split_sky, slice_from_box, cutup,
    bounds_from_list, spec1d_to_2d, get_lnlike, pixcov_sim, butterworth,
    resolution, get_planck_cutout, interpolate_grid, init_deriv_window,
    gauss_kern, gkern_interp, convolve_profile, convolve,
    convolve_gaussian, get_grf_cmb, get_grf_realization, rgeo,
    circular_mask, pixcov)
from .models.curved import (MapRotatorEquator, get_rotated_pixels,
                            cutout_gnomonic, galactic_mask_equ,
                            north_galactic_mask, south_galactic_mask)
from .models.ilc import (ilc_def_response, ilc_index, ilc_map_term,
                         ilc_comb_a_b, apply_harmonic_coadd_weights)
from .models.pixcov import rotate_pol_power
