"""Operators of the port: Fourier calculus, interpolation, binning and the
kernels (``bin_reduce``, ``lens``)."""
