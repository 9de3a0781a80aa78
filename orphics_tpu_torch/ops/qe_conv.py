"""The generic quadratic estimator's filter algebra around cuFFT
(``models/qe.py``'s ``QE.unnormalized_phi`` and ``QE.kappa_from_map``):
three elementwise kernels of ``csrc/qe_conv.cu`` and their plain versions.

* :func:`qe_leg` writes the leg spectra ``plane_k * src`` of one source;
* :func:`qe_pair` sums the real-space products of legs into the two
  components ``S_y, S_x`` of the source before the forward transforms;
* :func:`qe_post` forms ``post_y * F_y + post_x * F_x`` from their spectra.

The engine's plan puts into the real planes and coefficients everything
around the transforms (see ``csrc/qe_conv.cu``). For CUDA tensors each
wrapper launches its kernel; for CPU tensors it runs the plain version, the
same arithmetic in PyTorch. Complex64 with float32 planes, or complex128
with float64 planes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils.profiling import spanned

__all__ = ["qe_leg", "qe_leg_ref", "qe_pair", "qe_pair_ref", "qe_post",
           "qe_post_ref", "MAX_LEGS", "MAX_PRODUCTS"]

# csrc/qe_conv.cu's MAXL and MAXP (qe_conv_max_legs / _products)
MAX_LEGS = 8
MAX_PRODUCTS = 32

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_complex(name, *zs):
    for z in zs:
        if z.dtype not in _REAL:
            raise ValueError(f"{name} takes complex64 or complex128 planes, "
                             f"got {z.dtype}")
        if z.ndim != 3:
            raise ValueError(f"{name} takes (batch, ny, nx) planes, got "
                             f"{tuple(z.shape)}")


def _check_cuda(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def qe_leg_ref(src, planes):
    """Plain version: ``planes[k] * src`` for each plane."""
    return tuple(w * src for w in planes)


@spanned("orphics.qe.qe_leg")
def qe_leg(src, planes):
    """The leg spectra of one source: a tuple of ``planes[k] * src``.
    ``src``: ``(batch, ny, nx)`` complex; ``planes``: ``(nlegs, ny, nx)``
    real of the same precision, ``1 <= nlegs <= MAX_LEGS``."""
    _check_complex("qe_leg", src)
    if planes.dtype != _REAL[src.dtype] or planes.ndim != 3 \
            or planes.shape[1:] != src.shape[1:]:
        raise ValueError(f"qe_leg: planes {tuple(planes.shape)} "
                         f"{planes.dtype} do not match the source "
                         f"{tuple(src.shape)} {src.dtype}")
    n = planes.shape[0]
    if not 1 <= n <= MAX_LEGS:
        raise ValueError(f"qe_leg takes 1 to {MAX_LEGS} planes, got {n}")
    if src.is_cuda:
        _check_cuda("qe_leg", src, planes)
        outs = [torch.empty_like(src) for _ in range(n)]
        ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
        err = _build.library().qe_leg_launch(
            src.data_ptr(), planes.data_ptr(), ptrs, n, src.shape[0],
            src.shape[1] * src.shape[2], int(src.dtype == torch.complex128),
            _stream(src))
        _build.check(err, "qe_leg")
        qe_leg.launches += 1
        return tuple(outs)
    if src.device.type == "cpu":
        return qe_leg_ref(src, planes)
    raise ValueError(f"qe_leg: unsupported device {src.device}")


qe_leg.launches = 0


def qe_pair_ref(legs, pairs, prev):
    """Plain version: ``S_i = prev_i + sum c * legs[p] * legs[q]`` over the
    ``(i, c, p, q)`` of ``pairs`` with that component, in their order."""
    batch = max(leg.shape[0] for leg in legs)
    shape = (batch,) + tuple(legs[0].shape[1:])
    s = [torch.zeros(shape, dtype=legs[0].dtype, device=legs[0].device)
         if prev is None else prev[i] for i in range(2)]
    for i, c, p, q in pairs:
        s[i] = s[i] + c * (legs[p] * legs[q])
    return s[0], s[1]


@spanned("orphics.qe.qe_pair")
def qe_pair(legs, pairs, prev):
    """The two components of the estimator's real-space source,
    ``(S_y, S_x)``, each ``(batch, ny, nx)``: ``S_i = prev_i + sum c *
    legs[p] * legs[q]`` over the products ``(i, c, p, q)`` of ``pairs``
    (``i`` in {0, 1}, ``c`` a real number, ``p, q`` indices into
    ``legs``). ``legs``: at most ``MAX_LEGS`` complex ``(batch or 1, ny,
    nx)`` planes of one dtype, a leg of batch 1 pairing with every row;
    ``prev``: None (the sums start at 0) or the ``(S_y, S_x)`` of an
    earlier call."""
    legs = tuple(legs)
    _check_complex("qe_pair", *legs)
    batch = max(leg.shape[0] for leg in legs)
    for leg in legs:
        if leg.dtype != legs[0].dtype or leg.shape[1:] != legs[0].shape[1:] \
                or leg.shape[0] not in (1, batch):
            raise ValueError("qe_pair: legs of one dtype and plane shape, "
                             "each of batch 1 or the batch, got "
                             + ", ".join(f"{tuple(g.shape)} {g.dtype}"
                                         for g in legs))
    shape = (batch,) + tuple(legs[0].shape[1:])
    if prev is not None:
        if len(prev) != 2 or any(s.dtype != legs[0].dtype
                                 or tuple(s.shape) != shape for s in prev):
            raise ValueError(f"qe_pair: prev must be two {shape} planes of "
                             f"{legs[0].dtype}")
    if not 1 <= len(legs) <= MAX_LEGS or not 1 <= len(pairs) <= MAX_PRODUCTS:
        raise ValueError(f"qe_pair takes 1 to {MAX_LEGS} legs and 1 to "
                         f"{MAX_PRODUCTS} products, got {len(legs)}, "
                         f"{len(pairs)}")
    for i, _, p, q in pairs:
        if i not in (0, 1) or not (0 <= p < len(legs) and 0 <= q < len(legs)):
            raise ValueError(f"qe_pair: product {(i, p, q)} out of range")
    dev = legs[0]
    if dev.is_cuda:
        _check_cuda("qe_pair", *legs, *(prev or ()))
        out = (torch.empty(shape, dtype=dev.dtype, device=dev.device),
               torch.empty(shape, dtype=dev.dtype, device=dev.device))
        n, m = len(legs), len(pairs)
        npix = shape[1] * shape[2]
        err = _build.library().qe_pair_launch(
            (ctypes.c_void_p * n)(*(g.data_ptr() for g in legs)),
            (ctypes.c_longlong * n)(*(0 if g.shape[0] == 1 and batch > 1
                                      else npix for g in legs)),
            n, (ctypes.c_int * m)(*(int(t[0]) for t in pairs)),
            (ctypes.c_int * m)(*(int(t[2]) for t in pairs)),
            (ctypes.c_int * m)(*(int(t[3]) for t in pairs)),
            (ctypes.c_double * m)(*(float(t[1]) for t in pairs)), m,
            None if prev is None else prev[0].data_ptr(),
            None if prev is None else prev[1].data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), batch, npix,
            int(dev.dtype == torch.complex128), _stream(dev))
        _build.check(err, "qe_pair")
        qe_pair.launches += 1
        return out
    if dev.device.type == "cpu":
        return qe_pair_ref(legs, pairs, prev)
    raise ValueError(f"qe_pair: unsupported device {dev.device}")


qe_pair.launches = 0


def qe_post_ref(fy, fx, post):
    """Plain version: ``post[0] * fy + post[1] * fx``."""
    return post[0] * fy + post[1] * fx


@spanned("orphics.qe.qe_post")
def qe_post(fy, fx, post):
    """``post[0] * fy + post[1] * fx``: ``fy, fx`` ``(batch, ny, nx)``
    complex, ``post`` ``(2, ny, nx)`` real of the same precision."""
    _check_complex("qe_post", fy, fx)
    if fx.dtype != fy.dtype or fx.shape != fy.shape \
            or post.dtype != _REAL[fy.dtype] \
            or tuple(post.shape) != (2,) + tuple(fy.shape[1:]):
        raise ValueError(f"qe_post: spectra {tuple(fy.shape)}, "
                         f"{tuple(fx.shape)} and post {tuple(post.shape)} "
                         f"{post.dtype} do not match")
    if fy.is_cuda:
        _check_cuda("qe_post", fy, fx, post)
        out = torch.empty_like(fy)
        err = _build.library().qe_post_launch(
            fy.data_ptr(), fx.data_ptr(), post.data_ptr(), out.data_ptr(),
            fy.shape[0], fy.shape[1] * fy.shape[2],
            int(fy.dtype == torch.complex128), _stream(fy))
        _build.check(err, "qe_post")
        qe_post.launches += 1
        return out
    if fy.device.type == "cpu":
        return qe_post_ref(fy, fx, post)
    raise ValueError(f"qe_post: unsupported device {fy.device}")


qe_post.launches = 0
