"""Galaxy catalogs -> maps: pixelization, overdensities, mock catalogs
(port of ``orphics_tpu.models.catalogs``).

Re-design of reference ``orphics/catalogs.py``: histogram map-making on
flat-sky geometries (one ``index_add_`` on the positions' device) and
HEALPix (native C++ ``ang2pix`` on the host, counts on the device),
overdensity maps, correlated Poisson mocks (``Pow2Cat``, flat-sky, with
leading batch dims), random catalogs, sample splitting and duplicate
merging, and the FFT Zeldovich velocity reconstruction (CIC paint,
smoothing, solve and trilinear sample on the positions' device, in
float64). Maps and counts are float64 tensors. Draws take a
``torch.Generator``; each has a ``*_from_noise`` twin fed its normals or
uniforms. FITS loaders run on the native reader (``utils/fitsio``);
``df_from_fits`` needs astropy or fitsio, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, device_of, resolve
from .._device import to_numpy as _host
from ..geometry import Geometry, arcmin, degree
from ..utils import healpix as hp

__all__ = ["binned_map", "CatMapper", "get_delta", "get_delta_healpix",
           "random_catalog_flat", "get_random_catalog", "Pow2Cat",
           "split_samples", "optimize_splits", "select_based_on_mask",
           "merge_duplicates", "df_from_fits", "load_fits",
           "healpix_binned_map"]


def binned_map(decs_rad, ras_rad, geom: Geometry, weights=None, device=None):
    """Histogram sources into a flat-sky map (reference ``catalogs.py:16``):
    pixel indices by ``geom.sky2pix`` rounded half to even (as
    ``jnp.round``), sources outside the map weighted 0, then one
    ``index_add_`` into a float64 map on the positions' device (or on
    ``device`` when they are host arrays)."""
    dev = device_of(decs_rad, device)
    decs, ras = as_tensor(decs_rad, dev), as_tensor(ras_rad, dev)
    pix = geom.sky2pix(torch.stack([decs, ras]))
    iy = torch.round(pix[0]).to(torch.int64)
    ix = torch.round(pix[1]).to(torch.int64)
    good = (iy >= 0) & (iy < geom.ny) & (ix >= 0) & (ix < geom.nx)
    w = (torch.ones(iy.shape, dtype=torch.float64, device=dev)
         if weights is None else as_tensor(weights, dev, torch.float64))
    w = torch.where(good, w, 0.0)
    idx = iy.clamp(0, geom.ny - 1) * geom.nx + ix.clamp(0, geom.nx - 1)
    cmap = torch.zeros(geom.npix, dtype=torch.float64, device=dev)
    cmap.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return cmap.reshape(geom.shape)


def healpix_binned_map(decs_rad, ras_rad, nside: int, weights=None,
                       device=None):
    """Histogram sources into a HEALPix RING map: ``ang2pix`` on the host
    (the native library where it builds), the float64 counts by
    ``index_add_`` on the positions' device (or ``device``)."""
    dev = device_of(decs_rad, device)
    theta = np.pi / 2.0 - _host(decs_rad)
    phi = np.mod(_host(ras_rad), 2 * np.pi)
    pix = torch.as_tensor(hp.ang2pix(nside, theta, phi), device=dev)
    w = (torch.ones(pix.shape, dtype=torch.float64, device=dev)
         if weights is None else as_tensor(weights, dev, torch.float64))
    out = torch.zeros(hp.nside2npix(nside), dtype=torch.float64, device=dev)
    return out.index_add_(0, pix, w.reshape(-1))


class CatMapper:
    """Catalog -> (counts, overdensity) maps (reference ``catalogs.py:482``):
    flat geometry or HEALPix nside. ``counts`` is a float64 tensor on the
    positions' device (or ``device``)."""

    def __init__(self, ras_deg, decs_deg, geom: Geometry = None,
                 nside: int = None, weights=None, device=None):
        self.geom = geom
        self.nside = nside
        self.ras = (ras_deg * degree if isinstance(ras_deg, torch.Tensor)
                    else np.asarray(ras_deg) * degree)
        self.decs = (decs_deg * degree if isinstance(decs_deg, torch.Tensor)
                     else np.asarray(decs_deg) * degree)
        self.weights = weights
        self.device = device_of(self.decs, device)
        if geom is not None:
            self.counts = binned_map(self.decs, self.ras, geom, weights,
                                     device=self.device)
        else:
            self.counts = healpix_binned_map(self.decs, self.ras, nside,
                                             weights, device=self.device)

    def get_map(self):
        return self.counts

    def get_delta(self, mask=None):
        """Overdensity delta = n/<n> - 1 over the (optionally masked)
        footprint (reference ``catalogs.py:578``)."""
        return get_delta(self.counts, mask)


def get_delta(counts, mask=None, device=None):
    """Functional overdensity (reference ``catalogs.py:618``): ``(delta,
    nmean)`` with ``delta = counts / nmean - 1`` inside the mask and 0
    outside, ``nmean`` the masked mean count (a 0-d tensor)."""
    c = as_tensor(counts, device_of(counts, device))
    mask = (torch.ones_like(c) if mask is None
            else as_tensor(mask, c.device, c.dtype))
    nmean = torch.sum(c * mask) / torch.sum(mask)
    return torch.where(mask > 0, c / nmean - 1.0, 0.0), nmean


get_delta_healpix = get_delta


def random_catalog_flat_from_noise(uy, ux, geom: Geometry):
    """(decs, ras) on a flat patch from uniforms ``uy``, ``ux`` in [0, 1)."""
    h, w = geom.extent
    return (uy - 0.5) * h + geom.y0, (ux - 0.5) * w


def random_catalog_flat(generator: torch.Generator, geom: Geometry,
                        nsources: int, device=None):
    """Uniform random float64 (dec, ra) positions on a flat patch
    (reference ``catalogs.py:468``)."""
    kw = dict(generator=generator, dtype=torch.float64,
              device=resolve(device))
    uy = torch.rand((nsources,), **kw)
    ux = torch.rand((nsources,), **kw)
    return random_catalog_flat_from_noise(uy, ux, geom)


def get_random_catalog_from_noise(uz, up):
    """(ras, decs) in degrees on the sphere from uniforms ``uz``, ``up``
    in [0, 1): z = sin(dec) uniform in [-1, 1), ra uniform in [0, 2 pi)."""
    z = uz * 2.0 - 1.0
    return torch.rad2deg(up * (2 * np.pi)), torch.rad2deg(torch.arcsin(z))


def get_random_catalog(generator: torch.Generator, nsources: int,
                       device=None):
    """Uniform random positions on the sphere, float64 degrees (reference
    ``catalogs.py:323``): ``(ras, decs)``."""
    kw = dict(generator=generator, dtype=torch.float64,
              device=resolve(device))
    uz = torch.rand((nsources,), **kw)
    up = torch.rand((nsources,), **kw)
    return get_random_catalog_from_noise(uz, up)


class Pow2Cat:
    """Correlated (galaxy, kappa) mock: draw correlated GRFs from
    (clgg, clkg, clkk), Poisson-sample galaxies from the overdensity
    (flat-sky re-design of reference ``catalogs.py:352``). Draws take
    leading ``batch`` dims: several mocks in one call."""

    def __init__(self, geom: Geometry, ells, clgg, clkg, clkk,
                 ngal_per_arcmin2: float, dtype=torch.float64, device=None):
        from .grf import MapGen
        self.geom = geom
        ells = np.asarray(ells)
        # spec2flat paints by INTEGER index: re-grid spectra that are
        # not sampled at ell = 0..L-1 (e.g. CAMB tables from ell 2)
        if ells[0] != 0 or np.any(np.diff(ells) != 1):
            dense = np.arange(int(ells[-1]) + 1)
            regrid = lambda c: np.interp(dense, ells,
                                         np.asarray(c, np.float64),
                                         left=0.0, right=0.0)
            clgg, clkk, clkg = (regrid(clgg), regrid(clkk),
                                regrid(clkg))
            ells = dense
        ps = np.zeros((2, 2, len(ells)))
        ps[0, 0] = np.asarray(clgg)
        ps[1, 1] = np.asarray(clkk)
        ps[0, 1] = ps[1, 0] = np.asarray(clkg)
        self.mgen = MapGen(geom, ps, dtype=dtype, device=device)
        self.nbar = ngal_per_arcmin2 * geom.pixsize / (arcmin ** 2)

    def get_maps_from_noise(self, eta):
        """(delta_g, kappa) from complex white noise ``eta`` of shape
        ``(..., 2, ny, nx)`` (what ``grf.rand_kmap`` draws)."""
        maps = self.mgen.get_map_from_noise(eta)
        return maps[..., 0, :, :], maps[..., 1, :, :]

    def get_maps(self, generator: torch.Generator, batch=()):
        """(delta_g, kappa) correlated realizations, ``batch + (ny, nx)``."""
        maps = self.mgen.get_map(generator, batch=batch)
        return maps[..., 0, :, :], maps[..., 1, :, :]

    def counts_from_delta(self, delta, generator: torch.Generator):
        """Counts ~ Poisson(nbar (1 + delta)), the mean clipped at 0."""
        lam = torch.clamp(self.nbar * (1.0 + delta), min=0.0)
        return torch.poisson(lam, generator=generator)

    def get_cat(self, generator: torch.Generator, max_count: int = 20,
                batch=()):
        """(counts map, kappa map): counts ~ Poisson(nbar (1+delta_g))
        (reference ``catalogs.py:396``; ``max_count`` is unused, as in the
        JAX package). The same law as the JAX draw, another stream."""
        delta, kappa = self.get_maps(generator, batch)
        return self.counts_from_delta(delta, generator), kappa


def split_samples(in_samples, split_points):
    """Per-bin (S/N, mean, N) for a sample split at the given edges —
    the reference's exact semantics (``catalogs.py:769``): S/N is the
    bin mean times sqrt(count); bins are (a, b] like the reference's
    ``A > a & A <= b``."""
    split_points = np.asarray(split_points)
    assert np.all(np.diff(split_points) > 0), \
        "Split points should be monotonically increasing."
    A = _host(in_samples)
    sns, means, Ns = [], [], []
    for a, b in zip(split_points[:-1], split_points[1:]):
        sel = (A > a) & (A <= b)
        n = int(sel.sum())
        mean = A[sel].mean() if n else np.nan
        means.append(mean)
        Ns.append(n)
        sns.append(mean * np.sqrt(n))
    return np.asarray(sns), np.asarray(means), np.asarray(Ns)


def split_sample_indices(values, split_points):
    """Index groups partitioned at thresholds (utility; the round-3
    behavior of ``split_samples`` before the reference-semantics
    alignment)."""
    values = _host(values)
    edges = [-np.inf] + list(split_points) + [np.inf]
    return [np.where((values >= lo) & (values < hi))[0]
            for lo, hi in zip(edges[:-1], edges[1:])]


def optimize_splits(in_samples, in_splits):
    """Re-place the interior bin edges so the per-bin S/N variance is
    minimized, keeping the outermost edges fixed — the reference's
    ``fmin`` formulation (``catalogs.py:810``)."""
    from scipy.optimize import fmin
    in_splits = np.asarray(in_splits, dtype=float)
    in_samples = _host(in_samples)

    def cost(x):
        x = np.asarray(x).ravel()
        if np.any(np.diff(x) < 0):
            return np.inf
        edges = np.concatenate([[in_splits[0]], x, [in_splits[-1]]])
        if np.any(np.diff(edges) <= 0):
            return np.inf
        sns, _, _ = split_samples(in_samples, edges)
        return np.var(sns)

    res = fmin(cost, in_splits[1:-1], disp=False)
    return np.concatenate([[in_splits[0]], np.ravel(res),
                           [in_splits[-1]]])


def select_based_on_mask(ras_deg, decs_deg, mask, geom: Geometry = None,
                         nside: int = None, threshold: float = 0.5):
    """Keep sources whose pixel passes the mask (reference
    ``catalogs.py:837``): a host boolean array."""
    ras = _host(ras_deg) * degree
    decs = _host(decs_deg) * degree
    mask = _host(mask)
    if geom is not None:
        pix = geom.sky2pix(torch.as_tensor(np.stack([decs, ras]))).numpy()
        iy = np.round(pix[0]).astype(int)
        ix = np.round(pix[1]).astype(int)
        good = ((iy >= 0) & (iy < geom.ny) & (ix >= 0) & (ix < geom.nx))
        vals = np.zeros(len(ras))
        vals[good] = mask[iy[good], ix[good]]
    else:
        pix = hp.ang2pix(nside, np.pi / 2 - decs, np.mod(ras, 2 * np.pi))
        vals = mask[pix]
    return vals > threshold


def merge_duplicates(ras_deg, decs_deg, radius_arcmin: float = 1.0):
    """Merge sources within an angular radius to their mean position
    (KD-tree, reference ``catalogs.py:984``)."""
    from scipy.spatial import cKDTree
    ras = np.asarray(_host(ras_deg), dtype=np.float64)
    decs = np.asarray(_host(decs_deg), dtype=np.float64)
    # unit vectors for chordal metric
    th = np.radians(90 - decs)
    ph = np.radians(ras)
    xyz = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], axis=1)
    chord = 2 * np.sin(0.5 * radius_arcmin * arcmin)
    tree = cKDTree(xyz)
    pairs = tree.query_pairs(chord)
    parent = np.arange(len(ras))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in pairs:
        pi, pj = find(i), find(j)
        if pi != pj:
            parent[pj] = pi
    roots = np.array([find(i) for i in range(len(ras))])
    out_ra, out_dec = [], []
    for r in np.unique(roots):
        sel = roots == r
        out_ra.append(ras[sel].mean())
        out_dec.append(decs[sel].mean())
    return np.asarray(out_ra), np.asarray(out_dec)


def df_from_fits(fname, columns=None):
    """FITS table -> pandas DataFrame (reference ``catalogs.py:975``);
    requires astropy or fitsio (gated like the reference's optional deps)."""
    try:
        from astropy.io import fits as afits
        with afits.open(fname) as hdul:
            data = hdul[1].data
            cols = columns or data.names
            import pandas as pd
            return pd.DataFrame({c: np.asarray(data[c]) for c in cols})
    except ImportError:
        pass
    try:
        import fitsio
        import pandas as pd
        data = fitsio.read(fname, columns=columns)
        return pd.DataFrame({c: data[c] for c in data.dtype.names})
    except ImportError as e:
        raise ImportError("reading FITS requires astropy or fitsio") from e


# ---------------------------------------------------------------------
# Survey catalog loaders (reference catalogs.py:587-766) on the native
# FITS reader (utils/fitsio) — no astropy required.
# ---------------------------------------------------------------------

def _read_catalog_table(fname):
    """FITS bintable or HDF5 -> dict of column arrays."""
    if str(fname).endswith((".hdf", ".h5", ".hdf5")):
        import pandas as pd
        df = pd.read_hdf(fname)
        return {c: np.asarray(df[c]) for c in df.columns}
    from ..utils.fitsio import read_bintable
    return read_bintable(fname)


def load_boss(boss_files, zmin, zmax, do_weights=True, sys_weights=True,
              verbose=False):
    """Concatenate BOSS catalog FITS files with the standard
    systematic/completeness weighting and a redshift cut (reference
    ``load_boss``, ``catalogs.py:587``).

    Returns (ras, decs, weights-or-None, zs) in degrees.
    """
    ras, decs, zs, w = [], [], [], []
    for f in boss_files:
        cat = _read_catalog_table(f)
        if do_weights:
            m = cat["WEIGHT_SYSTOT"] if sys_weights else 1.0
            w.append(np.asarray(
                m * (cat["WEIGHT_NOZ"] + cat["WEIGHT_CP"] - 1.0)))
        ras.append(np.asarray(cat["RA"]))
        decs.append(np.asarray(cat["DEC"]))
        zs.append(np.asarray(cat["Z"]))
        if verbose:
            print(f)
    ras = np.concatenate(ras)
    decs = np.concatenate(decs)
    zs = np.concatenate(zs)
    sel = (zs >= zmin) & (zs < zmax)
    wout = np.concatenate(w)[sel] if do_weights else None
    return ras[sel], decs[sel], wout, zs[sel]


class BOSSMapper(CatMapper):
    """BOSS galaxy catalog -> counts map + random-derived footprint mask
    (reference ``BOSSMapper``, ``catalogs.py:657``). ``rand_map`` and
    ``mask`` are host float64 arrays; the randoms' smoothing runs on the
    counts' device."""

    def __init__(self, boss_files, random_files=None, rand_sigma_arcmin=2.0,
                 rand_threshold=1e-3, zmin=0.0, zmax=10.0,
                 geom: Geometry = None, nside: int = None, do_weights=True,
                 verbose=False, device=None):
        ras, decs, w, _ = load_boss(boss_files, zmin, zmax, do_weights,
                                    verbose=verbose)
        super().__init__(ras, decs, geom=geom, nside=nside, weights=w,
                         device=device)
        self.mask = None
        if random_files is not None:
            rand = 0.0
            for rf in random_files:
                cat = _read_catalog_table(rf)
                zs = np.asarray(cat["Z"])
                sel = (zs >= zmin) & (zs < zmax)
                rc = CatMapper(np.asarray(cat["RA"])[sel],
                               np.asarray(cat["DEC"])[sel],
                               geom=geom, nside=nside, device=self.device)
                rand = rand + _host(rc.counts)
            self.rand_map = rand
            self.update_mask(rand_sigma_arcmin, rand_threshold)

    def update_mask(self, rand_sigma_arcmin=2.0, rand_threshold=1e-3):
        smap = np.asarray(self.rand_map, np.float64)
        if rand_sigma_arcmin > 1e-3:
            if self.geom is not None:
                from ..ops import fourier as F
                sig = rand_sigma_arcmin * arcmin
                ml = torch.as_tensor(self.geom.modlmap_np(),
                                     device=self.device)
                kern = torch.exp(-0.5 * ml ** 2 * sig ** 2)
                smap = _host(F.kfilter(torch.as_tensor(smap,
                                                       device=self.device),
                                       kern, self.geom))
            else:
                # healpix: degrade/upgrade block smoothing at the
                # requested scale (native ud_grade; no SHT smoothing)
                res_arcmin = np.degrees(
                    np.sqrt(hp.nside2pixarea(self.nside))) * 60
                fac = max(1, int(2 ** np.round(np.log2(
                    max(1.0, rand_sigma_arcmin / res_arcmin)))))
                nside_lo = max(1, self.nside // fac)
                smap = hp.ud_grade(hp.ud_grade(smap, nside_lo), self.nside)
        self.mask = (smap > rand_threshold).astype(np.float64)


class HSCMapper(CatMapper):
    """HSC shear catalog -> weights/response/shear maps (reference
    ``HSCMapper``, ``catalogs.py:706``). Columns follow the HSC hsm
    regauss naming; any dict-like table works. The weighted maps are
    binned on the counts' device and kept as host float64 arrays."""

    def __init__(self, cat_file=None, pz_file=None, mask_threshold=4.0,
                 geom: Geometry = None, nside: int = None, table=None,
                 device=None):
        self.cat = table if table is not None \
            else _read_catalog_table(cat_file)
        ras = np.asarray(self.cat["ira"])
        decs = np.asarray(self.cat["idec"])
        self.wts = np.asarray(
            self.cat["ishape_hsm_regauss_derived_weight"])
        if pz_file is not None:
            pz = _read_catalog_table(pz_file)
            keys = [k for k in pz if k.endswith("photoz_best")]
            self.zs = np.asarray(pz[keys[0]]) if keys else None
        super().__init__(ras, decs, geom=geom, nside=nside, device=device)
        self.hsc_wts = self._wmap(self.wts)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.mean_wt = np.nan_to_num(self.hsc_wts / _host(self.counts))
        self.update_mask(mask_threshold)

    def _wmap(self, weights):
        if self.geom is not None:
            m = binned_map(self.decs, self.ras, self.geom, weights,
                           device=self.device)
        else:
            m = healpix_binned_map(self.decs, self.ras, self.nside, weights,
                                   device=self.device)
        return _host(m)

    def update_mask(self, mask_threshold):
        self.mask = (self.mean_wt > mask_threshold).astype(np.float64)

    def get_shear(self, do_m=True, do_c=True):
        """Calibrated (g1, g2) maps from the hsm regauss columns
        (reference ``catalogs.py:743``)."""
        cat = self.cat
        rms = np.asarray(cat["ishape_hsm_regauss_derived_rms_e"])
        m = np.asarray(cat["ishape_hsm_regauss_derived_bias_m"])
        e1 = np.asarray(cat["ishape_hsm_regauss_e1"])
        e2 = np.asarray(cat["ishape_hsm_regauss_e2"])
        c1 = np.asarray(cat["ishape_hsm_regauss_derived_bias_c1"])
        c2 = np.asarray(cat["ishape_hsm_regauss_derived_bias_c2"])
        wts = self.wts
        hsc_wts = self.hsc_wts
        with np.errstate(invalid="ignore", divide="ignore"):
            resp = 1.0 - np.nan_to_num(self._wmap(wts * rms ** 2) / hsc_wts)
            hsc_m = np.nan_to_num(self._wmap(wts * m) / hsc_wts) \
                if do_m else 0.0
            he1 = self._wmap(wts * e1)
            he2 = self._wmap(wts * e2)
            hc1 = np.nan_to_num(self._wmap(wts * c1) / hsc_wts) \
                if do_c else 0.0
            hc2 = np.nan_to_num(self._wmap(wts * c2) / hsc_wts) \
                if do_c else 0.0
            g1 = np.nan_to_num(he1 / 2.0 / resp / (1.0 + hsc_m) / hsc_wts) \
                - np.nan_to_num(hc1 / (1.0 + hsc_m))
            g2 = np.nan_to_num(he2 / 2.0 / resp / (1.0 + hsc_m) / hsc_wts) \
                - np.nan_to_num(hc2 / (1.0 + hsc_m))
        return g1, g2


# ---------------------------------------------------------------------
# Mangle polygon masks (reference catalogs.py:881 hp_from_mangle)
# ---------------------------------------------------------------------

def read_mangle_ply(fname):
    """Parse a mangle .ply polygon file: list of (weight, caps[n,4])
    where each cap is (x, y, z, cm) and a point v is inside the cap iff
    1 - dot(v, xyz) < cm (cm < 0 flips the sense, per mangle)."""
    import re
    polys = []
    with open(fname) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("polygon"):
            ncaps = int(re.search(r"(\d+)\s+caps", line).group(1))
            wm = re.search(r"([0-9.eE+-]+)\s+weight", line)
            weight = float(wm.group(1)) if wm else 1.0
            caps = np.array([[float(v) for v in lines[i + 1 + j].split()]
                             for j in range(ncaps)])
            polys.append((weight, caps))
            i += 1 + ncaps
        else:
            i += 1
    return polys


def _in_polygon(vecs, caps):
    """(N,) bool: unit vectors inside all caps of one polygon."""
    inside = np.ones(vecs.shape[0], bool)
    for (x, y, z, cm) in caps:
        cd = 1.0 - (vecs[:, 0] * x + vecs[:, 1] * y + vecs[:, 2] * z)
        this = cd < abs(cm)
        if cm < 0:
            this = ~this
        inside &= this
    return inside


def hp_from_mangle(weight_ply_files, nside, veto_ply_files=None):
    """Rasterize mangle .ply masks to a HEALPix RING map (reference
    ``hp_from_mangle``, ``catalogs.py:881``): weights from the weight
    files are summed per pixel; veto polygons zero pixels. Host numpy."""
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    st = np.sin(theta)
    vecs = np.stack([st * np.cos(phi), st * np.sin(phi),
                     np.cos(theta)], -1)
    out = np.zeros(npix)
    for f in weight_ply_files:
        for weight, caps in read_mangle_ply(f):
            out[_in_polygon(vecs, caps)] += weight
    if veto_ply_files:
        for f in veto_ply_files:
            for _, caps in read_mangle_ply(f):
                out[_in_polygon(vecs, caps)] = 0.0
    return out


# ---------------------------------------------------------------------
# FFT Zeldovich velocity reconstruction (reference catalogs.py:255
# reconstruct_velocities, which wraps pyrecon/nbodykit)
# ---------------------------------------------------------------------

def _cic_cells(p, lo, cell, nmesh):
    """The lower CIC cell (N, 3) and the fractions (N, 3) of positions."""
    g = (p - lo) / cell
    i0 = torch.floor(g).to(torch.int64).clamp(0, nmesh - 2)
    return i0, (g - i0).clamp(0.0, 1.0)


def _corners(i0, f, nmesh):
    """The eight (flat cell index, trilinear weight) pairs of each row."""
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wt = (f[:, 0] if dx else 1 - f[:, 0]) \
                    * (f[:, 1] if dy else 1 - f[:, 1]) \
                    * (f[:, 2] if dz else 1 - f[:, 2])
                idx = ((i0[:, 0] + dx) * nmesh + i0[:, 1] + dy) * nmesh \
                    + i0[:, 2] + dz
                yield idx, wt


def reconstruct_velocities(ras, decs, zs, ras_rand, decs_rand, zs_rand,
                           zeff=0.55, bg=1.92, h=0.676, omegam=0.31,
                           fkp_weights=None, fkp_weights_rand=None,
                           nmesh=128, smoothing_radius=10.0, cc=None,
                           device=None):
    """Line-of-sight velocity reconstruction at the galaxy positions.

    First-order (Zeldovich) replacement for the reference's pyrecon
    ``MultiGridReconstruction`` path: paint galaxies and randoms to a CIC
    mesh (``index_add_``), smooth, and solve v(k) = i a H f delta(k) k /
    (b k^2) with ``torch.fft.rfftn`` / ``irfftn``, then trilinearly sample
    the LOS component at the galaxy positions. All in float64 on the
    positions' device (or ``device`` for host arrays); the comoving
    distances come from the host cosmology ``cc``.

    Returns vlos (km/s) at the galaxy positions, a float64 tensor.
    """
    from .cosmology import Cosmology
    if cc is None:
        cc = Cosmology({"H0": h * 100.0,
                        "omch2": (omegam - 0.048) * h ** 2,
                        "ombh2": 0.048 * h ** 2})
    dev = device_of(ras, device)
    zs_h = np.asarray(_host(zs), np.float64)
    zr_h = np.asarray(_host(zs_rand), np.float64)
    if np.any(zs_h <= 0) or np.any(zr_h <= 0):
        raise ValueError("redshifts must be positive")

    def sky2cart(ra, dec, z):
        chi = torch.as_tensor(np.asarray(cc.comoving_radial_distance(
            np.atleast_1d(z)), np.float64), device=dev)
        ra = torch.deg2rad(as_tensor(ra, dev, torch.float64))
        dec = torch.deg2rad(as_tensor(dec, dev, torch.float64))
        cd = torch.cos(dec)
        return torch.stack([chi * cd * torch.cos(ra),
                            chi * cd * torch.sin(ra),
                            chi * torch.sin(dec)], -1)

    pos = sky2cart(ras, decs, zs_h)
    posr = sky2cart(ras_rand, decs_rand, zr_h)
    f64 = dict(dtype=torch.float64, device=dev)
    wg = (torch.ones(len(pos), **f64) if fkp_weights is None
          else as_tensor(fkp_weights, dev, torch.float64))
    wr = (torch.ones(len(posr), **f64) if fkp_weights_rand is None
          else as_tensor(fkp_weights_rand, dev, torch.float64))

    # mesh bounds with padding
    lo = posr.min(0).values - 50.0
    hi = posr.max(0).values + 50.0
    box = hi - lo
    cell = box / nmesh

    def cic_paint(p, w):
        i0, f = _cic_cells(p, lo, cell, nmesh)
        mesh = torch.zeros(nmesh ** 3, **f64)
        for idx, wt in _corners(i0, f, nmesh):
            mesh.index_add_(0, idx, w * wt)
        return mesh.reshape((nmesh,) * 3)

    ng = cic_paint(pos, wg)
    nr = cic_paint(posr, wr)
    alpha = wg.sum() / torch.clamp(wr.sum(), min=1e-30)
    delta = torch.where(nr > 0, ng / (alpha * nr) - 1.0, 0.0)
    del ng, nr

    # the wave numbers on the host in float64, as numpy forms them
    kf = 2 * np.pi / box.cpu().numpy()
    kx = np.fft.fftfreq(nmesh) * nmesh * kf[0]
    ky = np.fft.fftfreq(nmesh) * nmesh * kf[1]
    kz = np.fft.rfftfreq(nmesh) * nmesh * kf[2]
    KX, KY, KZ = (torch.as_tensor(k, device=dev)
                  for k in np.meshgrid(kx, ky, kz, indexing="ij"))
    k2 = KX ** 2 + KY ** 2 + KZ ** 2
    k2[0, 0, 0] = 1.0
    dk = torch.fft.rfftn(delta) * torch.exp(-0.5 * k2 * smoothing_radius ** 2)
    a = 1.0 / (1.0 + zeff)
    # f = dlnD/dlna ~ Om(z)^0.55; aH in km/s/Mpc
    Ez = cc.Ez(zeff)
    omz = omegam * (1 + zeff) ** 3 / Ez ** 2
    f_growth = omz ** 0.55
    aH = a * cc.H0 * Ez
    fac = 1j * (aH * f_growth / bg / k2)
    v = torch.stack([torch.fft.irfftn(fac * K * dk, s=(nmesh,) * 3,
                                      dim=(0, 1, 2))
                     for K in (KX, KY, KZ)], -1).reshape(-1, 3)
    del dk, fac, KX, KY, KZ, k2

    # trilinear sample at galaxy positions, project on LOS
    i0, f = _cic_cells(pos, lo, cell, nmesh)
    vg = torch.zeros((len(pos), 3), **f64)
    for idx, wt in _corners(i0, f, nmesh):
        vg += wt[:, None] * v[idx]
    los = pos / torch.linalg.norm(pos, dim=1, keepdim=True)
    return torch.sum(vg * los, dim=1)


__all__ += ["load_boss", "BOSSMapper", "HSCMapper", "read_mangle_ply",
            "hp_from_mangle", "reconstruct_velocities"]




def select_region(ra_col, dec_col, other_cols, ra_min, ra_max, dec_min,
                  dec_max):
    """Select catalog rows inside an (ra, dec) box, wrapping RA at 180
    degrees (reference ``catalogs.py`` ``select_region``; native wrap
    in place of astropy.Angle)."""
    ra = np.asarray(ra_col, np.float64)
    ra = (ra + 180.0) % 360.0 - 180.0          # wrap_at('180d')
    dec = np.asarray(dec_col, np.float64)
    sel = (ra > ra_min) & (ra < ra_max) & (dec > dec_min) & (dec < dec_max)
    return ra[sel], dec[sel], [np.asarray(c)[sel] for c in other_cols]


def enplot_annotate(fname, ras, decs, radius, width, color):
    """Write an enplot annotation file of circles (reference
    ``catalogs.py`` ``enplot_annotate``; the plain-text format is
    independent of enplot itself)."""
    with open(fname, "w") as f:
        for i, (ra, dec) in enumerate(zip(ras, decs)):
            r = radius[i] if isinstance(radius, (list, np.ndarray)) else radius
            w = width[i] if isinstance(width, (list, np.ndarray)) else width
            c = color[i] if isinstance(color, (list, np.ndarray)) else color
            f.write("c %.4f %.4f 0 0 %d %d %s \n" % (dec, ra, r, w, c))


def convert_catalog_to_enplot_annotate_file(annot_fname, ras, decs,
                                            radius=10, width=4,
                                            color="red", mask=None,
                                            geom=None, threshold=0.99):
    """Catalog -> annotation file, optionally mask-filtered (reference
    ``catalogs.py`` ``convert_catalog_to_enplot_annotate_file``)."""
    if mask is not None:
        sel = np.asarray(select_based_on_mask(ras, decs, mask, geom=geom,
                                              threshold=threshold))
        ras = np.asarray(ras)[sel]
        decs = np.asarray(decs)[sel]
    enplot_annotate(annot_fname, ras, decs, radius, width, color)


def convert_fits_catalog_to_enplot_annotate_file(fits_file, annot_fname,
                                                 ra_name="RA",
                                                 dec_name="DEC", **kw):
    """FITS catalog -> annotation file (reference
    ``convert_fits_catalog_to_enplot_annotate_file``)."""
    from ..utils.fitsio import read_bintable
    tab = read_bintable(fits_file)
    convert_catalog_to_enplot_annotate_file(annot_fname, tab[ra_name],
                                            tab[dec_name], **kw)


def convert_hilton_catalog_to_enplot_annotate_file(fits_file, annot_fname,
                                                   **kw):
    """ACT (Hilton et al.) cluster catalog -> annotation file (reference
    ``convert_hilton_catalog_to_enplot_annotate_file``: the Hilton
    catalogs use RADeg/decDeg column names)."""
    convert_fits_catalog_to_enplot_annotate_file(
        fits_file, annot_fname, ra_name="RADeg", dec_name="decDeg", **kw)


def load_fits(fits_file, column_names, hdu_num=1, Nmax=None):
    """Columns from a FITS binary table as a {name: array} dict — the
    reference's return shape (``catalogs.py:428``); native FITS reader,
    no astropy."""
    from ..utils.fitsio import read_bintable
    tab = read_bintable(fits_file, hdu=hdu_num)
    return {name: np.asarray(tab[name])[:Nmax] for name in column_names}


def dndz(z, z0=1.0 / 3.0):
    """Simple 1-parameter dn/dz parameterization (reference
    ``orphics/catalogs.py:439``): a tensor for a tensor ``z`` (on its
    device), else a host array."""
    if isinstance(z, torch.Tensor):
        return (z ** 2) * torch.exp(-z / z0) / (2.0 * z0 ** 3)
    z = np.asarray(z)
    return (z ** 2) * np.exp(-z / z0) / (2.0 * z0 ** 3)


def filter_fits(infile, conditions=None, drop_cols=None, strict=True,
                mask=None, mask_geom=None, mask_threshold=0.5,
                ra_name="RADeg", dec_name="decDeg", verbose=True,
                outfile=None):
    """Filter rows of a FITS binary-table catalog by column conditions
    and an optional sky mask (reference ``orphics/catalogs.py:65``).

    Native version: the table is read with the built-in FITS reader;
    ``conditions`` is either a dict {column: minimum} (every column must
    exceed its minimum) or a boolean expression string evaluated against
    the columns (e.g. ``"(SNR > 5) & (LAMBDA > 20)"``).  ``mask`` is a
    flat-sky mask array with its ``mask_geom`` Geometry (rows sampling
    below ``mask_threshold`` are dropped) or a healpix RING array.
    Returns the filtered column dict; with ``outfile`` it is also written
    back as a FITS BINTABLE.
    """
    from ..utils import fitsio as _fitsio
    cols = _fitsio.read_bintable(infile)
    nrows = len(next(iter(cols.values())))
    keep = np.ones(nrows, dtype=bool)
    if conditions is not None:
        if isinstance(conditions, dict):
            for name, thresh in conditions.items():
                if name not in cols:
                    if strict:
                        raise KeyError(name)
                    continue
                keep &= np.asarray(cols[name]) > thresh
        else:
            ns = {k: np.asarray(v) for k, v in cols.items()}
            # empty __builtins__ — otherwise eval() injects the real
            # builtins module, making the condition string a code-
            # execution vector (__import__ etc.)
            try:
                keep &= np.asarray(
                    eval(conditions, {"np": np, "__builtins__": {}}, ns),
                    bool)
            except NameError:
                if strict:
                    raise
    if mask is not None:
        if ra_name not in cols or dec_name not in cols:
            if strict:
                raise KeyError((ra_name, dec_name))
        else:
            ras = np.asarray(cols[ra_name], float)
            decs = np.asarray(cols[dec_name], float)
            mask = np.asarray(mask)
            if mask_geom is not None:
                sel = select_based_on_mask(ras, decs, mask, mask_geom,
                                           threshold=mask_threshold)
            else:  # healpix RING mask
                from ..utils import healpix as hp
                nside = hp.npix2nside(mask.size)
                pix = hp.ang2pix(nside, np.radians(90.0 - decs),
                                 np.radians(np.mod(ras, 360.0)))
                sel = mask[pix] >= mask_threshold
            keep &= sel
    out = {k: np.asarray(v)[keep] for k, v in cols.items()}
    if drop_cols:
        for c in drop_cols:
            if c in out:
                del out[c]
            elif strict:
                raise KeyError(c)
    if verbose:
        print(f"filter_fits: kept {int(keep.sum())}/{nrows} rows")
    if outfile is not None:
        _fitsio.write_bintable(outfile, out)
    return out


def fits_catalog_to_json(fits_file, ra_col, dec_col, name_col=None,
                         extra_cols=None, hdu_num=1, Nmax=None,
                         output_file=None):
    """Convert a FITS catalog to the JSON source-catalog format
    (reference ``orphics/catalogs.py:185``)."""
    import json as _json
    from ..utils import fitsio as _fitsio
    cols = _fitsio.read_bintable(fits_file, hdu=hdu_num)
    ras = np.asarray(cols[ra_col], float)
    decs = np.asarray(cols[dec_col], float)
    n = len(ras) if Nmax is None else min(Nmax, len(ras))
    sources = []
    for i in range(n):
        if name_col is not None:
            name = cols[name_col][i]
            name = name.decode() if isinstance(name, bytes) else str(name)
        else:
            name = f"Source_{i}"
        entry = {"name": name.strip(), "ra": float(ras[i]),
                 "dec": float(decs[i])}
        if extra_cols:
            def _jsonable(v):
                v = v.item() if hasattr(v, "item") else v
                if isinstance(v, bytes):
                    return v.decode(errors="replace").strip()
                return v if isinstance(v, (int, float, bool)) else str(v)
            entry["extra"] = {c: _jsonable(cols[c][i])
                              for c in extra_cols}
        sources.append(entry)
    if output_file is not None:
        with open(output_file, "w") as f:
            _json.dump(sources, f, indent=1)
    return sources
