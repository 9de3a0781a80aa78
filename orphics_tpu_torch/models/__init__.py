"""Models of the port: theory, GRFs, lensing, the quadratic estimator, the
fused lensing pipeline and the rest of ``orphics_tpu.models``. Re-exports
what ``orphics_tpu.models`` does."""
from . import (theory, grf, lensing, qe, ilc, noise, splits, pixcov,
               cosmology, foregrounds, catalogs, nfwfit, splitlens)
from .theory import TheorySpectra, default_theory, load_theory_from_camb
from .grf import MapGen, rand_map, spec2flat, harm2map, map2harm, cmb_ps
from .lensing import FlatLensingSims, alpha_from_kappa, kappa_to_phi
from .qe import QE, NlGenerator, lensing_noise_2d
