"""Time conversions for site-local observation bookkeeping (a copy of
``orphics_tpu.time_utils``: zoneinfo and numpy only).

Reference ``orphics.time`` (``time.py:8,49``): ctime <-> human-readable
local civil time at a (lat, lng). The reference resolves the IANA
timezone with the ``timezonefinder`` package (polygon lookup);
the package resolves it natively: a built-in table of observatory
sites (nearest within 10 deg great-circle) with a longitude-based
``Etc/GMT±N`` fallback, then converts with stdlib ``zoneinfo``
(DST-correct). At observatory coordinates the two agree exactly
(``tests/test_reference_parity_time.py``).
"""
from __future__ import annotations

import datetime as _dt
from zoneinfo import ZoneInfo

import numpy as np

__all__ = ["htime", "ctime", "timezone_at", "DEFAULT_SITE_LAT",
           "DEFAULT_SITE_LON"]

# pixell's default_site (the ACT / Simons Observatory site on Cerro
# Toco, Chile) — the reference's default lat/lng (time.py:44)
DEFAULT_SITE_LAT = -22.9585
DEFAULT_SITE_LON = -67.7876

# (lat, lng, IANA zone) for the observatory sites this library's users
# actually point at; nearest-site lookup keeps htime/ctime DST-correct
# there without a polygon database
_SITE_ZONES = (
    (-22.9585, -67.7876, "America/Santiago"),    # ACT / SO / CLASS
    (-23.0229, -67.7548, "America/Santiago"),    # ALMA plateau
    (-29.0146, -70.6926, "America/Santiago"),    # La Silla
    (-30.1716, -70.8009, "America/Santiago"),    # Tololo / Rubin
    (-90.0, 0.0, "Antarctica/South_Pole"),       # SPT / BICEP
    (19.8207, -155.4681, "Pacific/Honolulu"),    # Mauna Kea
    (38.4331, -79.8398, "America/New_York"),     # Green Bank
    (50.5248, 6.8836, "Europe/Berlin"),          # Effelsberg
    (-30.7215, 21.4110, "Africa/Johannesburg"),  # SKA Karoo
    (-31.2749, 149.0672, "Australia/Sydney"),    # Siding Spring
    (28.7569, -17.8925, "Atlantic/Canary"),      # La Palma
    (37.2339, -118.2951, "America/Los_Angeles"), # OVRO
    (32.7016, -109.8719, "America/Phoenix"),     # Mt Graham (no DST)
    (40.8175, -121.4733, "America/Los_Angeles"), # Hat Creek
    (13.1030, 77.5553, "Asia/Kolkata"),          # Bengaluru / RRI
)


def _gcdist_deg(lat1, lng1, lat2, lng2):
    p1, p2 = np.deg2rad(lat1), np.deg2rad(lat2)
    dl = np.deg2rad(lng2 - lng1)
    c = (np.sin(p1) * np.sin(p2) + np.cos(p1) * np.cos(p2) * np.cos(dl))
    return np.rad2deg(np.arccos(np.clip(c, -1.0, 1.0)))


def timezone_at(lat=None, lng=None):
    """IANA timezone name for a coordinate: nearest known observatory
    site within 10 deg, else the longitude's ``Etc/GMT±N`` zone (note
    the POSIX sign inversion: UTC-5 is ``Etc/GMT+5``)."""
    lat = DEFAULT_SITE_LAT if lat is None else float(lat)
    lng = DEFAULT_SITE_LON if lng is None else float(lng)
    dists = [_gcdist_deg(lat, lng, slat, slng)
             for slat, slng, _ in _SITE_ZONES]
    i = int(np.argmin(dists))
    if dists[i] <= 10.0:
        return _SITE_ZONES[i][2]
    off = int(np.round(lng / 15.0))
    return "Etc/GMT" if off == 0 else f"Etc/GMT{-off:+d}"


def htime(ctime, lat=None, lng=None, el=None):
    """UNIX timestamp -> local civil time string "YYYY-MM-DD HH:MM:SS"
    at (lat, lng) (reference ``time.py:8``; ``el`` accepted for
    signature compatibility)."""
    tz = ZoneInfo(timezone_at(lat, lng))
    return _dt.datetime.fromtimestamp(float(ctime), tz).strftime(
        "%Y-%m-%d %H:%M:%S")


def ctime(timestr, lat=None, lng=None):
    """Local civil time string "YYYY-MM-DD HH:MM:SS" at (lat, lng) ->
    UNIX timestamp (reference ``time.py:49``; inverse of htime)."""
    tz = ZoneInfo(timezone_at(lat, lng))
    local = _dt.datetime.strptime(timestr, "%Y-%m-%d %H:%M:%S").replace(
        tzinfo=tz)
    return local.timestamp()


def get_columns(obs, keys):
    """Extract keys from row dicts into numpy-array columns (reference
    ``time.py:102``)."""
    rows = [tuple(ob[k] for k in keys) for ob in obs]
    columns = list(zip(*rows)) if rows else [[] for _ in keys]
    return {key: np.array(col) for key, col in zip(keys, columns)}


# Sidereal orbital periods in seconds (reference ``time.py:127``)
BODY_PERIOD = {
    "Moon": 27.321661 * 86400.0,
    "Sun": 365.256 * 86400.0,
    "Mercury": 87.969 * 86400.0,
    "Venus": 224.701 * 86400.0,
    "Mars": 686.980 * 86400.0,
    "Jupiter": 4332.589 * 86400.0,
    "Saturn": 10759.22 * 86400.0,
    "Uranus": 30685.4 * 86400.0,
    "Neptune": 60189.0 * 86400.0,
}

BODY_STYLE = {
    "Sun": dict(radius_pix=40, width_pix=4, color="orange"),
    "Moon": dict(radius_pix=20, width_pix=3, color="black"),
    "Mercury": dict(radius_pix=10, width_pix=2, color="gray"),
    "Venus": dict(radius_pix=10, width_pix=2, color="blue"),
    "Mars": dict(radius_pix=10, width_pix=2, color="red"),
    "Jupiter": dict(radius_pix=10, width_pix=2, color="brown"),
    "Saturn": dict(radius_pix=10, width_pix=2, color="purple"),
    "Uranus": dict(radius_pix=10, width_pix=2, color="cyan"),
    "Neptune": dict(radius_pix=10, width_pix=2, color="green"),
}


def body_circle_annotations(ctime1, ctime2, bodies=None,
                            points_per_orbit=20, min_points=3,
                            max_points=200, default_radius=12,
                            default_width=2, default_color="white",
                            text_size=18):
    """Plot-annotation circles marking solar-system body tracks between
    two ctimes (reference ``time.py:154``), using the native analytic
    ephemeris in :mod:`orphics_tpu_torch.ephem` instead of pixell.ephem.

    Returns an enplot-style annotate list of ["circle", dec, ra, ...]
    rows (degrees)."""
    from . import ephem
    if bodies is None:
        # the reference's default ordering (time.py:173) — Sun first
        bodies = ["Sun", "Moon", "Mercury", "Venus", "Mars", "Jupiter",
                  "Saturn", "Uranus", "Neptune"]
    dt = float(ctime2 - ctime1)
    annotations = []
    for body in bodies:
        period = BODY_PERIOD.get(body)
        if period is None:
            continue
        if dt <= 0:
            ctimes = np.array([float(ctime1)])
        else:
            n = int(np.ceil(dt / period * points_per_orbit))
            n = max(min_points, min(max_points, n))
            ctimes = np.linspace(ctime1, ctime2, n)
        radec, _ = ephem.eval_body(body, ctimes)
        ra_deg = np.degrees(radec[:, 0])
        dec_deg = np.degrees(radec[:, 1])
        style = BODY_STYLE.get(body, {})
        radius_pix = style.get("radius_pix", default_radius)
        width_pix = style.get("width_pix", default_width)
        color = style.get("color", default_color)
        for ra, dec in zip(ra_deg, dec_deg):
            annotations.append(["circle", float(dec), float(ra), 0, 0,
                                radius_pix, width_pix, color])
        annotations.append(["text", float(dec_deg[-1]), float(ra_deg[-1]),
                            0, 0, body, text_size, color])
    return annotations


__all__ += ["get_columns", "body_circle_annotations", "BODY_PERIOD",
            "BODY_STYLE"]
