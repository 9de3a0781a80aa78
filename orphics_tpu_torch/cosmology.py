"""Facade mirroring reference ``orphics.cosmology`` (port of
``orphics_tpu.cosmology``)."""
from .models.cosmology import (defaultConstants, defaultCosmology, Cosmology,
                               LimberCosmology, LensForecast, s8_from_as,
                               As_from_s8, get_limber_clkk_flat_universe,
                               get_lensed_cls, get_lensed_cls_exact,
                               noise_pad_infinity)
from .models.lensed_cls import lensed_cls, lensed_correlations
from .models.shear import LimberCosmicShear, gaussian_band_covariance

# the reference exposes the cobaya likelihood under this name
GenericLimberCosmicShear = LimberCosmicShear
from .models.theory import (TheorySpectra, default_theory, planck_theory,
                            load_theory_from_camb)
from .models.noise import (noise_func, atm_factor, get_atmosphere,
                           getAtmosphere)
from .models.grf import cmb_ps as power_from_theory

# reference-compatible aliases
loadTheorySpectraFromCAMB = load_theory_from_camb
from .models.cosmology import (unpack_cmb_theory,
                               enmap_power_from_orphics_theory,
                               loadTheorySpectraFromPycambResults,
                               fk_comparison, pk_comparison, class_cls,
                               ClassCosmology, save_glens_cls_from_ini,
                               load_theory_from_glens, get_lss_cls,
                               phi2kappa, get_camb_lens_obj, CAMB)
from .models.noise import white_noise_with_atm_func
from .models.foregrounds import dl_filler
from .models.rsd import (growth_rate, Pgg_Pvv_Pgv, kmode_derivatives,
                         kmode_fisher)
