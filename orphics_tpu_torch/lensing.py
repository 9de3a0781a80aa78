"""Facade mirroring reference ``orphics.lensing`` (port of
``orphics_tpu.lensing``)."""
from .models.lensing import (
    fkappa_to_fphi, kappa_to_phi, kappa_to_fphi, alpha_from_kappa, gradient,
    lens_map_spline, taylens, FlatLensingSims, gnfw, f_c, fnfw, rho_nfw,
    proj_rho_nfw, projected_rho, kappa_nfw_generic, kappa_generic,
    nfw_kappa_profile, sanitize_power, fill_low_ell)
from .models.qe import (QE, NlGenerator, lensing_noise_2d, rdn0, mcn0,
                        n1_tt)
from .models.splitlens import SplitLensing
from .models.nfwfit import (binned_nfw, fit_nfw_profile, filter_bin_kappa2d,
                            nfw_kappa, NFWkappa, lens_cov, beam_cov)

# reference-compatible aliases
flat_taylens = taylens
sanitizePower = sanitize_power
fillLowEll = fill_low_ell
qest = QE
from .models.lensing import FixedLens, validate_geometry
from .models.nfwfit import (filter_bin_kappa1d, kappa_nfw_profiley1d,
                            kappa_nfw_profiley, mass_estimate, lens_cov_pol,
                            NFWMatchedFilterSN, rayleigh, kappa_from_rhofunc,
                            kappa_nfw)
