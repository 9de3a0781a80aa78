"""Publication-style plotting helpers (reference ``orphics/io.py:429``;
port of ``orphics_tpu.utils.plot``).

Thin host-side matplotlib wrappers: the ``Plotter`` schemes and methods
mirror the reference so analysis scripts port directly. matplotlib is
imported inside each function, so importing this module needs none of it.
Every array argument may be a tensor on any device: it is copied to the
host (``.detach().cpu().numpy()``) where it enters.
"""
from __future__ import annotations

import os

import numpy as np

from .._device import to_numpy as _host

__all__ = ["Plotter", "plot_img", "hist", "html_gallery", "corner_plot",
           "hplot", "mollview",
           "high_res_plot_img", "mplot", "layered_contour",
           "generate_gallery_html", "write_gallery_html",
           "alpha_from_confidence"]

_SCHEMES = {
    "Dell": (r"$\ell$", r"$D_{\ell}$", "linlog", lambda x: x ** 2 / 2 / np.pi),
    "Dl": (r"$\ell$", r"$D_{\ell}$", "linlog", lambda x: x ** 2 / 2 / np.pi),
    "Cell": (r"$\ell$", r"$C_{\ell}$", "linlog", lambda x: 1),
    "Cl": (r"$\ell$", r"$C_{\ell}$", "linlog", lambda x: 1),
    "Pk": (r"$k$ (Mpc$^{-1}$)", r"$P(k)$ (Mpc$^3$)", "loglog", lambda x: 1),
    "CL": (r"$L$", r"$C_{L}$", "linlog", lambda x: 1),
    "LCL": (r"$L$", r"$LC_{L}$", "linlin", lambda x: x),
    "rCell": (r"$\ell$", r"$\Delta C_{\ell} / C_{\ell}$", "linlin",
              lambda x: 1),
    "rCl": (r"$\ell$", r"$\Delta C_{\ell} / C_{\ell}$", "linlin",
            lambda x: 1),
    "dCell": (r"$\ell$", r"$\Delta C_{\ell}$", "linlin", lambda x: 1),
    "dCl": (r"$\ell$", r"$\Delta C_{\ell}$", "linlin", lambda x: 1),
    "rCL": (r"$L$", r"$\Delta C_{L}/C_{L}$", "linlin", lambda x: 1),
}


class Plotter:
    """Reference-compatible quick plotter (``orphics/io.py:429``)."""

    def __init__(self, scheme=None, xlabel=None, ylabel=None, xyscale=None,
                 xscale="linear", yscale="linear", scalefn=None, title=None,
                 ftsize=14, **kwargs):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self._plt = plt
        if scheme is not None:
            if scheme not in _SCHEMES:
                raise ValueError(f"unknown scheme {scheme}")
            xl, yl, xys, sfn = _SCHEMES[scheme]
            xlabel = xlabel or xl
            ylabel = ylabel or yl
            xyscale = xyscale or xys
            scalefn = scalefn or sfn
        self.scalefn = scalefn or (lambda x: 1)
        if xyscale is not None:
            m = {"log": "log", "lin": "linear"}
            xscale, yscale = m[xyscale[:3]], m[xyscale[3:]]
        self._fig = plt.figure(**kwargs)
        if title:
            self._fig.suptitle(title)
        self._ax = self._fig.add_subplot(1, 1, 1)
        self._ax.set_xscale(xscale)
        self._ax.set_yscale(yscale)
        if xlabel:
            self._ax.set_xlabel(xlabel, fontsize=ftsize)
        if ylabel:
            self._ax.set_ylabel(ylabel, fontsize=ftsize)
        self.do_legend = False

    def add(self, x, y, label=None, lw=2, addx=0, **kwargs):
        if label is not None:
            self.do_legend = True
        x = _host(x)
        y = _host(y) * self.scalefn(x)
        return self._ax.plot(x + addx, y, label=label, linewidth=lw, **kwargs)

    def add_err(self, x, y, yerr, ls="none", band=False, alpha=1.0,
                marker="o", label=None, addx=0.0, **kwargs):
        x = _host(x)
        s = self.scalefn(x)
        y = _host(y) * s
        yerr = _host(yerr) * s
        if band:
            self._ax.plot(x + addx, y, ls=ls, marker=marker, label=label,
                          **kwargs)
            self._ax.fill_between(x + addx, y - yerr, y + yerr, alpha=alpha)
        else:
            self._ax.errorbar(x + addx, y, yerr=yerr, ls=ls, marker=marker,
                              label=label, alpha=alpha, **kwargs)
        if label is not None:
            self.do_legend = True

    def hist(self, data, **kwargs):
        return self._ax.hist(_host(data), **kwargs)

    def plot2d(self, data, lim=None, clbar=True, cm=None, label=None,
               extent=None, **kwargs):
        arr = _host(data)
        vmin, vmax = (None, None)
        if lim is not None:
            vmin, vmax = (lim if isinstance(lim, (list, tuple))
                          else (-lim, lim))
        img = self._ax.imshow(arr, vmin=vmin, vmax=vmax, cmap=cm,
                              extent=extent, interpolation="none", **kwargs)
        if clbar:
            cbar = self._fig.colorbar(img, ax=self._ax)
            if label:
                cbar.set_label(label)

    def hline(self, y=0.0, ls="--", alpha=0.5, color="k", **kwargs):
        self._ax.axhline(y=y, ls=ls, alpha=alpha, color=color, **kwargs)

    def vline(self, x=0.0, ls="--", alpha=0.5, color="k", **kwargs):
        self._ax.axvline(x=x, ls=ls, alpha=alpha, color=color, **kwargs)

    def legend(self, **kwargs):
        return self._ax.legend(**kwargs)

    def done(self, filename=None, verbose=False, **kwargs):
        if self.do_legend:
            self.legend()
        if filename is not None:
            self._fig.savefig(filename, bbox_inches="tight", **kwargs)
            if verbose:
                print("Saved plot to " + filename)
        self._plt.close(self._fig)


def plot_img(array, filename=None, lim=None, cm="coolwarm", label=None,
             verbose=False, **kwargs):
    """Quick 2D map image (reference ``orphics/io.py:366``). ``verbose``
    goes to :meth:`Plotter.done` (the JAX function passes it on to the
    figure, which refuses it, so its ``mplot`` raises)."""
    p = Plotter(**kwargs)
    p.plot2d(array, lim=lim, cm=cm, label=label)
    p.done(filename, verbose=verbose)


def hist(data, bins=40, filename=None, **kwargs):
    p = Plotter(**kwargs)
    p.hist(data, bins=bins)
    p.done(filename)


def html_gallery(image_files, outfile="gallery.html", ncols=3, titles=None):
    """Static HTML image gallery for batch visual review (reference
    ``orphics/io.py:1016-1144``)."""
    rows = []
    for i, f in enumerate(image_files):
        t = titles[i] if titles else os.path.basename(f)
        rows.append(f'<div style="display:inline-block;margin:4px;">'
                    f'<p>{t}</p><img src="{f}" width="400"/></div>')
    html = ("<html><body>" + "\n".join(rows) + "</body></html>")
    with open(outfile, "w") as fh:
        fh.write(html)
    return outfile


def power_crop(p2d, N, fname, do_ftrans=True, **kwargs):
    """Crop + log-fftshift view of a 2D spectrum (reference
    ``orphics/io.py:297``)."""
    import numpy as _np
    from ..models.mapstools import ftrans, crop_center
    pmap = _host(ftrans(p2d, device="cpu")) if do_ftrans else _host(p2d)
    ny, nx = pmap.shape[-2:]
    pimg = crop_center(pmap, N, int(N * nx / ny))
    plot_img(pimg, fname, **kwargs)


def fplot(img, savename=None, log=True, **kwargs):
    """fftshifted (log) Fourier-plane image (reference ``io.py:304``)."""
    lfunc = np.log10 if log else (lambda x: x)
    plot_img(lfunc(np.fft.fftshift(_host(img))), savename, **kwargs)


def fisher_plot(chi2ds, xval, yval, paramlabelx, paramlabely, thk=2,
                cols=None, labels=None, levels=(2.0,), save_file=None):
    """Fisher confidence ellipses (reference ``orphics/io.py:873``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    xx = np.arange(360) / 180.0 * np.pi
    circl = np.array([np.cos(xx), np.sin(xx)])
    n = len(chi2ds)
    cols = cols or [None] * n
    labels = labels or [None] * n
    for chi2d, col, lab in zip(chi2ds, cols, labels):
        L = np.linalg.cholesky(_host(chi2d))
        ans = 1.52 * L @ circl
        ax.plot(ans[0] + xval, ans[1] + yval, linewidth=thk, color=col,
                label=lab)
    ax.set_xlabel(paramlabelx)
    ax.set_ylabel(paramlabely)
    if any(l is not None for l in labels):
        ax.legend()
    if save_file:
        fig.savefig(save_file, bbox_inches="tight")
    plt.close(fig)
    return fig, ax


from .fitting import alpha_from_confidence


def corner_plot(fishers, labels, params, fid_dict=None, latex_dict=None,
                confidence_level=0.683, show_1d=True, colors=None,
                save_file=None, thk=2):
    """Triangle/corner plot from Fisher matrices (reference
    ``orphics/stats.py:253`` ``corner_plot``).

    fishers : list of (nP, nP) Fisher matrices over ``params`` (same
        ordering); labels : one legend label per matrix; fid_dict maps
        parameter name -> fiducial value (ellipse centers).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    params = list(params)
    nP = len(params)
    fid_dict = fid_dict or {}
    latex_dict = latex_dict or {}
    colors = colors or [f"C{i}" for i in range(len(fishers))]
    alpha = alpha_from_confidence(confidence_level)
    xx = np.arange(360) / 180.0 * np.pi
    circl = np.array([np.cos(xx), np.sin(xx)])
    covs = [np.linalg.inv(_host(f)) for f in fishers]
    size = nP if show_1d else nP - 1
    fig, axes = plt.subplots(size, size, figsize=(2.2 * size, 2.2 * size),
                             squeeze=False)
    start = 0 if show_1d else 1
    for i in range(nP):
        for j in range(nP):
            if j < i + start:
                continue
            r, c = (j, i) if show_1d else (j - 1, i)
            ax = axes[r][c]
            xf = fid_dict.get(params[i], 0.0)
            yf = fid_dict.get(params[j], 0.0)
            for cov, col, lab in zip(covs, colors, labels):
                if i == j:
                    sig = np.sqrt(cov[i, i])
                    ts = np.linspace(xf - 4 * sig, xf + 4 * sig, 200)
                    ax.plot(ts, np.exp(-(ts - xf) ** 2 / (2 * sig ** 2)),
                            color=col, linewidth=thk,
                            label=lab if (i == 0) else None)
                else:
                    sub = cov[np.ix_([i, j], [i, j])]
                    L = np.linalg.cholesky(sub)
                    pts = alpha * (L @ circl)
                    ax.plot(pts[0] + xf, pts[1] + yf, color=col,
                            linewidth=thk,
                            label=lab if (i == 0 and j == 1 and not
                                          show_1d) else None)
            if r == size - 1:
                ax.set_xlabel(latex_dict.get(params[i], params[i]))
            else:
                ax.xaxis.set_visible(False)
            if c == 0 and r > 0:
                ax.set_ylabel(latex_dict.get(params[j], params[j]))
            elif c > 0:
                ax.yaxis.set_visible(False)
    # hide the unused upper triangle
    for r in range(size):
        for c in range(size):
            used = (c <= r) if show_1d else (c <= r)
            if not used:
                axes[r][c].axis("off")
    handles, labs = axes[0][0].get_legend_handles_labels()
    if not handles and size > 1:
        handles, labs = axes[1][0].get_legend_handles_labels()
    if handles:
        fig.legend(handles, labs, loc="upper right")
    fig.tight_layout()
    if save_file:
        fig.savefig(save_file, bbox_inches="tight")
    plt.close(fig)
    return fig


class FisherPlots:
    """Multi-section Fisher forecast plotting (reference
    ``orphics/io.py:689``)."""

    def __init__(self):
        self.fishers = {}
        self.fidDicts = {}
        self.paramLists = {}
        self.paramLatexLists = {}

    def addSection(self, section, paramList, paramLatexList, fidDict):
        self.fishers[section] = {}
        self.fidDicts[section] = fidDict
        self.paramLists[section] = paramList
        self.paramLatexLists[section] = paramLatexList

    def addFisher(self, section, setName, fisherMat, gaussOnly=False):
        self.fishers[section][setName] = (gaussOnly, _host(fisherMat))

    def plot1d(self, section, paramName, frange, setNames, labels=None,
               saveFile="default.png"):
        fval = self.fidDicts[section][paramName]
        i = self.paramLists[section].index(paramName)
        p = Plotter(xlabel="$" + self.paramLatexLists[section][i] + "$",
                    ylabel="$\\mathcal{L}$")
        labels = labels or [None] * len(setNames)
        for setName, lab in zip(setNames, labels):
            gaussOnly, fisher = self.fishers[section][setName]
            if gaussOnly:
                sig2 = fisher ** 2
            else:
                sig2 = np.linalg.inv(fisher)[i, i]
            p.add(frange, np.exp(-(frange - fval) ** 2 / 2.0 / sig2),
                  label=lab)
        p.done(saveFile)

    def plotPair(self, section, paramXYPair, setNames, labels=None,
                 saveFile="default.png"):
        paramX, paramY = paramXYPair
        xval = self.fidDicts[section][paramX]
        yval = self.fidDicts[section][paramY]
        i = self.paramLists[section].index(paramX)
        j = self.paramLists[section].index(paramY)
        chi2ds = []
        for s in setNames:
            _, fisher = self.fishers[section][s]
            Finv = np.linalg.inv(fisher)
            chi2ds.append(Finv[np.ix_([i, j], [i, j])])
        labels = labels or [None] * len(setNames)
        return fisher_plot(chi2ds, xval, yval,
                           "$" + self.paramLatexLists[section][i] + "$",
                           "$" + self.paramLatexLists[section][j] + "$",
                           labels=labels, save_file=saveFile)


class WhiskerPlot:
    """Point-with-error whisker comparison plot (reference
    ``orphics/io.py:903``)."""

    def __init__(self, means, errs, labels, xlabel="$S_8$", colors=None,
                 vline=None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = len(means)
        self.fig, self.ax = plt.subplots(figsize=(5, 0.5 * n + 1))
        ys = np.arange(n)[::-1]
        colors = colors or ["C0"] * n
        for y, m, e, lab, c in zip(ys, means, errs, labels, colors):
            e = np.atleast_1d(e)
            xerr = e[:, None] if e.ndim == 1 and e.size == 2 else e
            self.ax.errorbar([m], [y], xerr=np.reshape(e, (-1, 1)),
                             fmt="o", color=c)
            self.ax.text(m, y + 0.2, lab, fontsize=9, ha="center")
        if vline is not None:
            self.ax.axvline(vline, ls="--", color="k", alpha=0.5)
        self.ax.set_yticks([])
        self.ax.set_xlabel(xlabel)

    def save(self, fname):
        self.fig.savefig(fname, bbox_inches="tight")
        import matplotlib.pyplot as plt
        plt.close(self.fig)


def high_res_plot_img(array, filename=None, down=None, verbose=True,
                      overwrite=True, crange=None, cmap="viridis"):
    """Large-array image dump (reference ``io.py``
    ``high_res_plot_img``; matplotlib imsave in place of enplot)."""
    import os
    import numpy as _np
    if not overwrite and filename is not None and os.path.isfile(filename):
        return
    arr = _host(array)
    if down is not None and down > 1:
        ny, nx = arr.shape[-2:]
        arr = arr[..., : ny - ny % down, : nx - nx % down]
        arr = arr.reshape(arr.shape[:-2]
                          + (ny // down, down, nx // down, down)
                          ).mean(axis=(-3, -1))
    vmin, vmax = (crange if crange is not None
                  else (_np.nanmin(arr), _np.nanmax(arr)))
    if filename is None:
        return arr
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.imsave(filename, arr, vmin=vmin, vmax=vmax, cmap=cmap,
               origin="lower")
    if verbose:
        print("Saved high-res plot to", filename)


def mplot(img, savename=None, verbose=True, **kwargs):
    """fftshifted log10 image of a 2D power plane (reference ``io.py``
    ``mplot``)."""
    import numpy as _np
    shifted = _np.fft.fftshift(_np.log10(_host(img)))
    plot_img(shifted, filename=savename, verbose=verbose, **kwargs)


def layered_contour(imap, imap_contour, contour_levels, contour_color,
                    contour_width=1, mask=None, filename=None, **kwargs):
    """Image with contour overlay from a second map (reference
    ``io.py`` ``layered_contour``; matplotlib in place of enplot)."""
    import numpy as _np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    arr = _host(imap)
    if mask is not None:
        arr = _np.where(_host(mask) > 0, arr, _np.nan)
    fig, ax = plt.subplots()
    im = ax.imshow(arr, origin="lower", **kwargs)
    ax.contour(_host(imap_contour), levels=contour_levels,
               colors=contour_color, linewidths=contour_width)
    fig.colorbar(im, ax=ax)
    if filename is not None:
        fig.savefig(filename, bbox_inches="tight")
        plt.close(fig)
    return fig


def generate_gallery_html(image_files, ncols=3, titles=None):
    """The gallery HTML string (reference ``generate_gallery_html``) —
    delegates to the html_gallery builder."""
    import io as _io
    import tempfile
    import os
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "g.html")
        html_gallery(image_files, outfile=out, ncols=ncols, titles=titles)
        with open(out) as f:
            return f.read()


def write_gallery_html(image_files, outfile, ncols=3, titles=None):
    """Write the gallery HTML to a file (reference
    ``write_gallery_html``)."""
    html_gallery(image_files, outfile=outfile, ncols=ncols, titles=titles)


def hplot(img, savename=None, verbose=True, grid=False, down=None,
          **kwargs):
    """High-resolution map render (the reference's enplot-based ``hplot``,
    ``orphics/io.py:313``), drawn natively with matplotlib at one map
    pixel per image pixel."""
    out = high_res_plot_img(_host(img), filename=savename, down=down,
                            verbose=False, **kwargs)
    if savename is not None and verbose:
        print(f"Saved plot to {savename}")
    return out


def mollview(hp_map, filename=None, lim=None, coord="C", verbose=True,
             return_projected_map=False, xsize=1200, title=None,
             cmap="coolwarm", dpi=None, **kwargs):
    """Mollweide all-sky render of a healpix RING map (reference
    ``orphics/io.py:346``), implemented natively: sample a Mollweide
    (lon, lat) pixel grid and look each point up with the built-in
    ang2pix — no healpy."""
    from . import healpix as hp
    hp_map = _host(hp_map)
    nside = hp.npix2nside(hp_map.size)
    ysize = xsize // 2
    x = np.linspace(-2.0, 2.0, xsize)
    y = np.linspace(-1.0, 1.0, ysize)
    xx, yy = np.meshgrid(x, y)
    # inverse Mollweide projection
    sin_t = np.clip(yy, -1.0, 1.0)
    theta_aux = np.arcsin(sin_t)
    lat = np.arcsin(np.clip((2 * theta_aux + np.sin(2 * theta_aux))
                            / np.pi, -1, 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        lon = np.pi * xx / (2 * np.cos(theta_aux))
    valid = (np.abs(lon) <= np.pi) & ((xx / 2) ** 2 + yy ** 2 <= 1.0)
    img = np.full(xx.shape, np.nan)
    th = np.pi / 2 - lat[valid]
    ph = np.mod(lon[valid], 2 * np.pi)
    img[valid] = hp_map[hp.ang2pix(nside, th, ph)]
    if lim is None:
        cmin = cmax = None
    elif isinstance(lim, (list, tuple)):
        cmin, cmax = lim
    else:
        cmin, cmax = -lim, lim
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(xsize / 120.0, ysize / 120.0))
    im = ax.imshow(img[::-1], vmin=cmin, vmax=cmax, cmap=cmap, **kwargs)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.6)
    if filename is not None:
        fig.savefig(filename, dpi=dpi, bbox_inches="tight")
        if verbose:
            print(f"Saved healpix plot to {filename}")
    plt.close(fig)          # never leak figures (loops over many maps)
    if return_projected_map:
        return img
