"""Facade mirroring reference ``orphics.stats``."""
from .ops.binning import Bin2D, RfftBin2D, bin1d, bin1D, bin_in_annuli
from .parallel.statistics import SuffStats, Statistics, Stats, get_stats
from .utils.fitting import (fit_linear_model, fit_linear_model_pte_from_sims,
                            fit_cltt_power,
                            fit_gauss, get_pte, sim_pte, nsigma_from_pte,
                            InverseTransformSampling, Solver, solve, OQE,
                            OQESlim, CinvUpdater, sm_update, cov2corr,
                            correlated_hybrid_matrix, extrapolate_power_law,
                            get_sigma2, npspace, alpha_from_confidence,
                            timeit)
from .models.grf import eig_pow
from .utils.plot import corner_plot

# reference-compatible aliases
bin2D = Bin2D
from .utils.fitting import InverseTransformSampling2D, eig_analyze
from .parallel.statistics import load_stats
