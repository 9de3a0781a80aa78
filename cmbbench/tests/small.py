"""Small CPU versions of the benchmark's cells for its tests.

The flat cells' grids are cut to 256^2, the curved cell to lmax 63 on 96 x
192 rings, and their batches to a few maps; the program runs its plain CPU
versions. Its CPU draws are another stream than the card's, so
:func:`card_stream` makes the plain versions draw the card's Philox stream
(the references' frozen copy), as the kernels do.
"""
from __future__ import annotations

import contextlib
import copy

import torch

from cmbbench.reference import streams
from cmbbench.run import load_cell

CELLS = ("tt2048.sim", "lensqe512.sim", "tt2048.cross", "lensqe512.recon",
         "curvedqe2047.recon")
_SMALL = {
    "tt2048.sim": ({"n": 256}, {"batch": 8}),
    "tt2048.cross": ({"n": 256}, {"batch": 4, "inputs": {"count": 8}}),
    "lensqe512.sim": ({"n": 256}, {"batch": 4}),
    "lensqe512.recon": ({"n": 256}, {"batch": 4, "inputs": {"count": 8}}),
    # lmax 63 on gauss_legendre_rings(95), 2 sims a step from 4 held alms
    "curvedqe2047.recon": (
        {"lmax": 63, "lmin": 8,
         "rings": {"kind": "gauss_legendre", "lmax": 95, "ntheta": 96,
                   "nphi": 192},
         "bins": {"start": 8, "stop": 64, "step": 8}},
        {"batch": 2, "inputs": {"count": 4}}),
}


def small_cell(name):
    """``(bench, workload, config, traffic)`` of the cell at the small
    size, every step's answers kept."""
    bench, wl, cfg, traffic = load_cell(name)
    c, t = _SMALL[name]
    cfg = {**cfg, **c}
    traffic = copy.deepcopy(traffic)
    for k, v in t.items():
        if isinstance(v, dict):
            traffic[k].update(v)
        else:
            traffic[k] = v
    traffic["keep_every"] = 1
    return bench, wl, cfg, traffic


def _philox_planes(scale, seed, batch):
    from orphics_tpu_torch.ops.noise_planes import seed_words
    words = [int(v) for v in seed_words(seed).tolist()]
    re, im = streams.normals(words, 0, batch * scale.numel())
    shape = (batch,) + tuple(scale.shape)
    er = torch.as_tensor(re.reshape(shape), dtype=torch.float32)
    ei = torch.as_tensor(im.reshape(shape), dtype=torch.float32)
    return er * scale, ei * scale


@contextlib.contextmanager
def card_stream():
    """The port's plain noise draws take the card kernels' stream."""
    from orphics_tpu_torch.ops import dft, noise_planes
    saved = noise_planes.noise_planes_ref, dft.noise_planes_ref
    noise_planes.noise_planes_ref = dft.noise_planes_ref = _philox_planes
    try:
        yield
    finally:
        noise_planes.noise_planes_ref, dft.noise_planes_ref = saved
