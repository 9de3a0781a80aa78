"""Operators of the port: Fourier calculus, interpolation, binning and the
kernels' wrappers. Re-exports what ``orphics_tpu.ops`` does, less its
Pallas modules (``pallas_fft``, ``pallas_kernels``), whose kernels live in
``csrc/`` behind ``dft``, ``bin_reduce`` and the other wrappers."""
from . import (fourier, binning, distance, windows, alm, matfft, algorithms)
from .fourier import (fft2, ifft2, rfft2, irfft2, f2power, power2d,
                      mask_kspace, filter_map, kfilter, gauss_beam,
                      iqu2teb, teb2iqu, queb_rotmat, interp1d_to_2d)
from .binning import Bin2D, RfftBin2D, bin1d, bin1D, bin_in_annuli
from .distance import (distance_transform, cosine_apodize, grow_mask,
                       mask_srcs)
from .windows import cosine_window, get_taper, get_taper_deg
