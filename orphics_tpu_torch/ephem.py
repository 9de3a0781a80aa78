"""Low-precision analytic solar-system ephemeris (a copy of
``orphics_tpu.ephem``: numpy only).

Native replacement for the ``pixell.ephem.eval`` dependency of reference
``orphics/time.py:154`` (``body_circle_annotations``): geocentric RA/Dec
and distance of the Sun, Moon and planets from Keplerian mean elements
(Standish/JPL approximate elements, J2000 frame, valid 1800-2050 at the
arcminute-to-degree level) and the Meeus low-precision lunar series.
Good for plot annotations and scan planning; not for pointing.

All angles internal are radians; `eval_body` mirrors the pixell API:
returns (radec[N,2] in radians, dist[N] in AU).
"""
from __future__ import annotations

import numpy as np

__all__ = ["eval_body", "sun_radec", "moon_radec", "BODIES"]

_DEG = np.pi / 180.0
_J2000 = 946728000.0            # unix ctime of 2000-01-01 12:00 TT (approx)
_OBLIQ = 23.43928 * _DEG        # mean obliquity at J2000

# Standish approximate Keplerian elements, J2000 ecliptic frame.
# Per planet: (a [AU], e, I [deg], L [deg], varpi [deg], Omega [deg])
# value at J2000 and rate per Julian century.
_ELEMENTS = {
    "Mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350,
                 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                 0.16047689, -0.12534081)),
    "Venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950,
               131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729,
               0.00268329, -0.27769418)),
    "EM_Bary": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
                 102.93768193, 0.0),
                (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
                 0.32327364, 0.0)),
    "Mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205,
              -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499,
              0.44441088, -0.29257343)),
    "Jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106)),
    "Saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794)),
    "Uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589)),
    "Neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.00508664)),
}

BODIES = ("Sun", "Moon", "Mercury", "Venus", "Mars", "Jupiter", "Saturn",
          "Uranus", "Neptune")


def _centuries(ctime):
    return (np.asarray(ctime, np.float64) - _J2000) / (36525.0 * 86400.0)


def _kepler(M, e, iters=8):
    """Solve Kepler's equation E - e sin E = M (vectorized Newton)."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _helio_ecliptic(body, T):
    """Heliocentric ecliptic (x, y, z) in AU from mean elements."""
    el0, rate = _ELEMENTS[body]
    a, e, I, L, varpi, Om = (v0 + r * T for v0, r in zip(el0, rate))
    I = I * _DEG
    L = L * _DEG
    varpi = varpi * _DEG
    Om = Om * _DEG
    w = varpi - Om                       # argument of perihelion
    M = np.mod(L - varpi + np.pi, 2 * np.pi) - np.pi
    E = _kepler(M, e)
    xp = a * (np.cos(E) - e)             # orbital-plane coords
    yp = a * np.sqrt(1 - e ** 2) * np.sin(E)
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(I), np.sin(I)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return np.stack([x, y, z], -1)


def _ecl_to_radec(vec):
    """Ecliptic J2000 cartesian -> (ra, dec, r)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    ce, se = np.cos(_OBLIQ), np.sin(_OBLIQ)
    xe = x
    ye = y * ce - z * se
    ze = y * se + z * ce
    r = np.sqrt(xe ** 2 + ye ** 2 + ze ** 2)
    ra = np.mod(np.arctan2(ye, xe), 2 * np.pi)
    dec = np.arcsin(np.clip(ze / np.maximum(r, 1e-30), -1, 1))
    return ra, dec, r


def sun_radec(ctime):
    """Geocentric RA/Dec/distance of the Sun."""
    T = _centuries(ctime)
    earth = _helio_ecliptic("EM_Bary", T)
    return _ecl_to_radec(-earth)


def moon_radec(ctime):
    """Geocentric RA/Dec/distance of the Moon (Meeus low-precision
    series, ~0.3 deg)."""
    T = _centuries(ctime)
    # mean elements (degrees)
    Lp = 218.3164477 + 481267.88123421 * T      # mean longitude
    D = 297.8501921 + 445267.1114034 * T        # mean elongation
    M = 357.5291092 + 35999.0502909 * T         # sun mean anomaly
    Mp = 134.9633964 + 477198.8675055 * T       # moon mean anomaly
    F = 93.2720950 + 483202.0175233 * T         # argument of latitude
    D, M, Mp, F = (v * _DEG for v in (D, M, Mp, F))
    lam = (Lp * _DEG
           + (6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
              + 0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp)
              - 0.185116 * np.sin(M) - 0.114332 * np.sin(2 * F)
              + 0.058793 * np.sin(2 * D - 2 * Mp)
              + 0.057066 * np.sin(2 * D - M - Mp)
              + 0.053322 * np.sin(2 * D + Mp)
              + 0.045758 * np.sin(2 * D - M)) * _DEG)
    beta = ((5.128122 * np.sin(F) + 0.280602 * np.sin(Mp + F)
             + 0.277693 * np.sin(Mp - F) + 0.173237 * np.sin(2 * D - F))
            * _DEG)
    # distance in Earth radii -> AU
    dist_km = (385000.56 - 20905.355 * np.cos(Mp)
               - 3699.111 * np.cos(2 * D - Mp) - 2955.968 * np.cos(2 * D))
    r = dist_km / 1.495978707e8
    cb = np.cos(beta)
    vec = np.stack([r * cb * np.cos(lam), r * cb * np.sin(lam),
                    r * np.sin(beta)], -1)
    return _ecl_to_radec(vec)


def eval_body(body, ctimes):
    """(radec [N, 2] radians, dist [N] AU) for a named body — the
    ``pixell.ephem.eval`` surface used by the reference."""
    ctimes = np.atleast_1d(np.asarray(ctimes, np.float64))
    body = body.capitalize() if body.lower() != "em_bary" else "EM_Bary"
    if body == "Sun":
        ra, dec, r = sun_radec(ctimes)
    elif body == "Moon":
        ra, dec, r = moon_radec(ctimes)
    elif body in _ELEMENTS and body != "EM_Bary":
        T = _centuries(ctimes)
        planet = _helio_ecliptic(body, T)
        earth = _helio_ecliptic("EM_Bary", T)
        ra, dec, r = _ecl_to_radec(planet - earth)
    else:
        raise ValueError(f"unknown body {body!r}")
    return np.stack([ra, dec], -1), r
