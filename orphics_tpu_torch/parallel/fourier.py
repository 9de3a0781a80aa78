"""Grid-axis distributed Fourier analysis over a process mesh (port of
``orphics_tpu.parallel.fourier``).

Maps too large for one card shard over *rows*. This module writes the MPI
"pencil/slab" FFT decomposition (FFTW's ``fftw_mpi_plan_dft_2d``, which
pixell's MPI FFTs use) as per-rank bodies over a mesh axis, with
``torch.distributed`` collectives on the axis's process group:

* :func:`fft2_dist` — local row FFTs, one ``all_to_all`` shard transpose,
  local column FFTs, and the transpose back.
* :func:`masked_bandpowers_dist` — masked spectra of a very large map:
  window multiply, the distributed FFT without the transpose back, |Z|^2,
  the column block binned by kernel B1 (:func:`..ops.bin_reduce.bin_reduce`),
  then one all-reduce of the sums and counts. One all-to-all and one
  all-reduce are the only transport.
* :func:`lens_cov_dist` — the reference's row-parallel lensed pixel-pixel
  covariance (``orphics/lensing.py:563-648``): each rank lenses its block
  of covariance rows through kernel B8 (``nfwfit._lens_rows``), and an
  all-to-all transposes the blocks between the one-sided applications.

As in the JAX package, the inputs are the global arrays (each rank reads
only its block) and the outputs are what JAX returns: the gathered maps,
the replicated bandpowers, the full covariance, on every rank. Host arrays
go to the mesh's device; a tensor must already be there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import Geometry
from ..models.nfwfit import _beam_rows, _lens_rows
from ..ops.bin_reduce import bin_reduce

__all__ = ["fft2_dist", "ifft2_dist", "masked_bandpowers_dist",
           "lens_cov_dist"]


def _on_mesh(x, mesh, dtype=None):
    """``x`` on the mesh's device: a host array is copied there (sharing no
    memory with the caller's), a tensor elsewhere is refused (nothing moves
    between host and card here)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != mesh.device.type:
            raise ValueError(f"a tensor on {x.device} for a mesh on "
                             f"{mesh.device}")
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=mesh.device)


def _block(x, dim, ax):
    """Rank ``ax.index``'s block of ``ax.size`` equal blocks along
    ``dim``."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"length {n} does not split over {ax.size} ranks")
    nb = n // ax.size
    return x.narrow(dim, ax.index * nb, nb)


def _complex(x):
    return x.to(torch.complex128 if x.dtype in (torch.float64,
                                                torch.complex128)
                else torch.complex64)


def _fft2_local(x, ax, inverse, back):
    """Per-rank body: ``x`` is this rank's (..., ny / S, nx) complex row
    block of a map whose rows are split over ``ax`` (S ranks, nx divisible
    by S). Returns the rank's row block of the 2D FFT (``back``) or its
    (..., ny, nx / S) column block."""
    fft = torch.fft.ifft if inverse else torch.fft.fft
    z = fft(x, dim=-1)                                   # rows: local
    # shard transpose: (..., ny_l, nx) -> (..., ny, nx / S)
    z = ax.all_to_all(z, split_axis=-1, concat_axis=-2)
    z = fft(z, dim=-2)                                   # columns: full
    if back:
        # back to row blocks: (..., ny, nx / S) -> (..., ny_l, nx)
        z = ax.all_to_all(z, split_axis=-2, concat_axis=-1)
    return z


def fft2_dist(x, mesh, axis: str = "grid", batch_axis=None,
              inverse: bool = False):
    """Distributed raw 2D FFT of ``x`` (..., ny, nx) with rows split over
    mesh axis ``axis`` (``ny`` and ``nx`` divisible by its size) and,
    optionally, the leading batch dimension over ``batch_axis``. Each rank
    transforms its block; the result is gathered on every rank. Real
    inputs go to complex64 (float64: complex128)."""
    x = _complex(_on_mesh(x, mesh))
    ax = mesh.axis(axis)
    bax = mesh.axis(batch_axis) if batch_axis is not None and x.ndim > 2 \
        else None
    rows = _block(x, -2, ax)
    if bax is not None:
        rows = _block(rows, 0, bax)
    z = ax.all_gather(_fft2_local(rows, ax, inverse, True), -2)
    return z if bax is None else bax.all_gather(z, 0)


def ifft2_dist(x, mesh, axis: str = "grid", batch_axis=None):
    """Distributed raw inverse 2D FFT (see :func:`fft2_dist`)."""
    return fft2_dist(x, mesh, axis=axis, batch_axis=batch_axis,
                     inverse=True)


def _bin_ids(dig, nbins):
    """B1's ids for a digitized table: ``dig`` 1..nbins -> 0..nbins-1, every
    other value (the JAX tables' 0 for out of range) -> -1, which B1
    skips."""
    ids = dig.reshape(-1).to(torch.int32) - 1
    return torch.where((ids >= 0) & (ids < nbins), ids, -1)


def _masked_bp_local(m_l, w_l, dig_l, nbins, norm, ax):
    """Per-rank body of :func:`masked_bandpowers_dist`: the rank's row
    blocks of the maps (..., ny / S, nx) and window, its column block of
    the bin table (ny, nx / S). Returns the (..., nbins) bandpowers, the
    same on every rank of ``ax``. One B1 launch sums the power planes and a
    row of ones (the bins' pixel counts) over the block."""
    z = _fft2_local(_complex(m_l * w_l), ax, False, False)   # (..., ny, nx_l)
    p = ((z.real * z.real + z.imag * z.imag) * norm).to(torch.float32)
    batch = p.shape[:-2]
    ids = _bin_ids(dig_l, nbins)
    p = p.reshape(-1, ids.numel())
    sums = bin_reduce(torch.cat([p, p.new_ones((1, ids.numel()))]), ids,
                      nbins)                                   # B1
    red = ax.all_reduce(sums.to(torch.float64))
    out = red[:-1] / red[-1].clamp_min(1.0)
    return out.reshape(batch + (nbins,)).to(m_l.dtype)


def masked_bandpowers_dist(maps, window, dig, nbins: int, norm, mesh,
                           axis: str = "grid", batch_axis=None):
    """Binned masked power spectra of very large maps.

    Parameters
    ----------
    maps : (..., ny, nx) real; each rank reads its block of rows over
        ``axis`` (and, with ``batch_axis``, of the leading batch dim).
    window : (ny, nx) apodization; each rank reads the same rows.
    dig : (ny, nx) integer bin index per Fourier cell (0 = out of range,
        1..nbins in range — ``np.digitize`` against the bin edges of the
        *unshifted* fft2 modulus map); each rank reads its block of
        COLUMNS: the power is consumed in the column-block layout the
        distributed FFT ends in.
    nbins : number of bins; norm : area/npix^2 power normalization.
    Returns (..., nbins) bandpower sums / counts on every rank.

    Per rank: window, row FFTs, one all-to-all, column FFTs, |Z|^2 in
    float32 and B1 over the column block (the power and the counts in one
    launch), then one all-reduce of the sums and counts; the transpose
    back to row blocks is never made. With ``batch_axis`` an all-gather
    over it assembles the batch.
    """
    maps = _on_mesh(maps, mesh)
    ax = mesh.axis(axis)
    bax = mesh.axis(batch_axis) if batch_axis is not None and maps.ndim > 2 \
        else None
    m_l = _block(maps, -2, ax)
    if bax is not None:
        m_l = _block(m_l, 0, bax)
    w_l = _block(_on_mesh(window, mesh, maps.dtype), -2, ax)
    dig_l = _block(_on_mesh(dig, mesh), -1, ax)
    out = _masked_bp_local(m_l, w_l, dig_l, int(nbins), float(norm), ax)
    return out if bax is None else bax.all_gather(out, 0)


def _transpose_rows(c, ax):
    """The rank's row block of ``C^T`` from its row block of ``C`` (n_l,
    npix): one all-to-all of the column blocks."""
    return ax.all_to_all(c, split_axis=1, concat_axis=0).T.contiguous()


def _lens_cov_local(rows, alpha, geom, order, kbeam, ax):
    """Per-rank body of :func:`lens_cov_dist`: the rank's row block of
    ``ucov`` -> its row block of the lensed (and beamed) covariance; each
    side one B8 call on the block's rows."""
    c = _lens_rows(rows, alpha, geom, order)
    c = _lens_rows(_transpose_rows(c, ax), alpha, geom, order)
    if kbeam is not None:
        c = _beam_rows(_transpose_rows(c, ax), kbeam, geom)
        c = _beam_rows(_transpose_rows(c, ax), kbeam, geom)
    return c


def lens_cov_dist(ucov, alpha, geom: Geometry, mesh, lens_order: int = 5,
                  kbeam=None, row_axes=("sims", "grid")):
    """Row-split lensed pix-pix covariance L U L^T (+ beam): the mesh
    version of the reference's MPI row loop (``orphics/lensing.py:563-648``,
    comm-rank strided rows), equal to :func:`..models.nfwfit.lens_cov`.

    ``ucov`` is (npix, npix); its rows split over the flattened
    ``row_axes`` (npix divisible by their ranks). Each one-sided
    application lenses the rank's rows (one B8 call); between them an
    all-to-all transposes the row blocks. Float32, as ``lens_cov``;
    returns the full covariance on every rank.
    """
    ax = mesh.axis(row_axes)
    ucov = _on_mesh(ucov, mesh, torch.float32)
    alpha = _on_mesh(alpha, mesh, torch.float32)
    if kbeam is not None:
        kbeam = _on_mesh(kbeam, mesh, torch.float32)
    rows = _block(ucov, 0, ax).contiguous()
    c = _lens_cov_local(rows, alpha, geom, lens_order, kbeam, ax)
    return ax.all_gather(c, 0)
