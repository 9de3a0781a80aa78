"""Host-side IO: config files, HDF5/npz/pickle persistence, hashing,
logging, colored prints (reference ``orphics/io.py``; port of
``orphics_tpu.utils.io``). h5py, yaml and PIL are imported inside the
functions that use them, so importing this module needs none of them.
Arrays to save may be tensors on any device."""
from __future__ import annotations

import contextlib
import hashlib
import io as _io
import logging
import os
import pickle
import sys
import time

import numpy as np

from .._device import to_numpy as _host

__all__ = ["save_dict", "load_dict", "save_pickle", "load_pickle",
           "get_hash", "hash_dict", "mkdir", "save_cols", "load_cols",
           "config_from_yaml", "config_from_file", "list_from_config",
           "bin_edges_from_config", "cprint", "bcolors", "get_logger",
           "nostdout", "load_path_config"]


# ---- dict <-> hdf5 (reference io.py:89-115) -------------------------

def save_dict(fname, d):
    import h5py
    with h5py.File(fname, "w") as f:
        for k, v in d.items():
            f[k] = _host(v)


def load_dict(fname):
    import h5py
    out = {}
    with h5py.File(fname, "r") as f:
        for k in f.keys():
            out[k] = np.asarray(f[k])
    return out


def save_pickle(fname, obj):
    with open(fname, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(fname):
    with open(fname, "rb") as f:
        return pickle.load(f)


# ---- hashing (reference io.py:120-130) --------------------------------

def get_hash(arr_or_path):
    """MD5 hex digest. Given a path to an existing file, hashes the file
    contents — byte-identical to reference ``io.py:120`` ``get_hash``.
    Given an array, hashes its contiguous buffer (an extension the
    reference does not have)."""
    if isinstance(arr_or_path, (str, os.PathLike)) and os.path.isfile(arr_or_path):
        with open(arr_or_path, "rb") as f:
            return hashlib.md5(f.read()).hexdigest()
    return hashlib.md5(
        np.ascontiguousarray(_host(arr_or_path)).tobytes()).hexdigest()


def hash_dict(d):
    """Order-independent dict hash — same algorithm as reference
    ``io.py:130`` (sha256 of compact sorted-key JSON), so digests are
    directly comparable across the two codebases."""
    import json
    serialized = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(serialized.encode("utf-8")).hexdigest()


def mkdir(dirpath, comm=None):
    """Race-safe mkdir (reference io.py:209 is MPI-collective; here any
    concurrent process tolerates the existing dir)."""
    os.makedirs(dirpath, exist_ok=True)
    return dirpath


def save_cols(fname, cols, **kwargs):
    np.savetxt(fname, np.stack([_host(c) for c in cols], axis=1), **kwargs)


def load_cols(fname, **kwargs):
    return np.loadtxt(fname, unpack=True, **kwargs)


# ---- config (reference io.py:193-281) ----------------------------------

def config_from_yaml(fname):
    import yaml
    with open(fname) as f:
        return yaml.safe_load(f)


def config_from_file(fname):
    """INI file -> ConfigParser (reference io.py:257). Supports both the
    reference's ``Config.get(section, name)``/``getfloat`` API and
    mapping access ``config[section][name]``."""
    import configparser
    assert os.path.isfile(fname)
    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read(fname)
    return cp


def load_path_config(fname=None):
    """paths_local.ini / paths.ini convention (reference io.py:245)."""
    import configparser
    if fname is None:
        for cand in ("input/paths_local.ini", "input/paths.ini"):
            if os.path.exists(cand):
                fname = cand
                break
    if fname is None:
        raise FileNotFoundError("no paths config found")
    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read(fname)
    return cp


def list_from_config(config, section, name):
    return [float(x) for x in config[section][name].split(",")]


def bin_edges_from_config(config, section):
    """Bin edges from an INI section (reference io.py:265): the
    reference schema is ``spacing``/``left_edge``/``right_edge``/
    ``num_bins`` through ``npspace``; a ``bin_edges_low``/``high``/
    ``width`` arange spec is also accepted."""
    spec = config[section]
    if "left_edge" in spec:
        from .fitting import npspace
        return npspace(float(spec["left_edge"]), float(spec["right_edge"]),
                       int(spec["num_bins"]),
                       scale=spec.get("spacing", "lin"))
    lo = float(spec["bin_edges_low"]) if "bin_edges_low" in spec else 0.0
    hi = float(spec["bin_edges_high"])
    w = float(spec["bin_edges_width"])
    return np.arange(lo, hi + w, w)


# ---- console / logging (reference io.py:152-182, 650-688) ---------------

class bcolors:
    HEADER = '\033[95m'
    OKBLUE = '\033[94m'
    OKGREEN = '\033[92m'
    WARNING = '\033[93m'
    FAIL = '\033[91m'
    ENDC = '\033[0m'
    BOLD = '\033[1m'
    UNDERLINE = '\033[4m'


def cprint(string, color=None, bold=False, uline=False):
    prefix = ""
    if color is not None:
        prefix = getattr(bcolors, {
            "h": "HEADER", "b": "OKBLUE", "g": "OKGREEN",
            "y": "WARNING", "r": "FAIL"}.get(color, color.upper()))
    if bold:
        prefix += bcolors.BOLD
    if uline:
        prefix += bcolors.UNDERLINE
    print(prefix + str(string) + bcolors.ENDC)


def get_logger(log_file=None, level=logging.INFO):
    """Timestamped file+console logger (reference io.py:172)."""
    logger = logging.getLogger("orphics_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is None:
        log_file = time.strftime("log_%Y%m%d_%H%M%S.txt")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


@contextlib.contextmanager
def nostdout():
    """Suppress stdout within a block (reference io.py:45)."""
    saved = sys.stdout
    sys.stdout = _io.StringIO()
    try:
        yield
    finally:
        sys.stdout = saved


# ---------------------------------------------------------------------------
# Reference-surface tail (io.py small utilities)
# ---------------------------------------------------------------------------

class latex:
    """Common axis-label strings (reference ``io.py`` ``latex``)."""
    ell = r"$\ell$"
    L = r"$L$"
    dl = r"$D_{\ell}$"
    cl = r"$C_{\ell}$"
    cL = r"$C_{L}$"
    ratcl = r"$\Delta C_{\ell}/C_{\ell}$"


class DummyFile:
    """Write sink (reference ``io.py`` ``DummyFile``)."""

    def write(self, x):
        pass

    def flush(self):
        pass


@contextlib.contextmanager
def no_context():
    """A nullcontext (reference ``io.py`` ``no_context``)."""
    yield None


def proceedyn(prompt="Proceed? (Y/N): ", _input=input):
    """Interactive Y/N gate; exits the process on N (reference
    ``io.py`` ``proceedyn``)."""
    while True:
        choice = _input(prompt).strip().lower()
        if choice == "y":
            print("Continuing...")
            return True
        if choice == "n":
            print("Exiting.")
            raise SystemExit(0)
        print("Invalid input. Please type Y or N.")


def dateversion():
    """YYYYMMDD stamp (reference ``io.py`` ``dateversion``)."""
    from datetime import datetime
    return datetime.now().strftime("%Y%m%d")


def print_dict(data):
    """Pretty-print a dict as sorted JSON (reference ``print_dict``)."""
    import json
    print(json.dumps(data, sort_keys=True, indent=4, default=str))


def print_keys_tree(d, indent=0):
    """Print nested dict keys as a tree (reference
    ``print_keys_tree``)."""
    for key, value in d.items():
        print("  " * indent + str(key))
        if isinstance(value, dict):
            print_keys_tree(value, indent + 1)


class LoggerWriter:
    """File-like adapter feeding writes into a logging level function
    (reference ``io.py`` ``LoggerWriter``)."""

    def __init__(self, level):
        self.level = level

    def write(self, message):
        if message != "\n":
            self.level(message)

    def flush(self):
        pass


def dict_from_section(config, section_name):
    """Dict of parsed values from an INI section (reference
    ``dict_from_section``)."""
    out = {}
    for key in config[section_name]:
        if key == "__name__":
            continue
        try:
            out[key] = list_from_config(config, section_name, key)[0]
        except ValueError:
            out[key] = config.get(section_name, key)
    return out


def prepare_dir(savedir, overwrite, comm=None, msg=None):
    """mkdir that refuses to clobber an existing version dir unless
    ``overwrite`` (reference ``prepare_dir``)."""
    import os
    if msg is None:
        msg = ("This version already exists on disk. Please use a "
               "different version identifier.")
    if not overwrite:
        assert not os.path.exists(savedir), msg
    mkdir(savedir, comm)


def join_nums(nums):
    """'_'-join of stringified numbers (reference ``join_nums``)."""
    return "_".join([str(f) for f in nums])


def list_from_string(string):
    """Comma-separated floats (reference ``list_from_string``)."""
    return [float(x) for x in string.split(",")]


def list_strings_from_config(config, section, name):
    """Comma-split raw strings from an INI entry (reference
    ``list_strings_from_config``)."""
    return config.get(section, name).split(",")


def datify(timestamps):
    """Unix timestamps -> datetime objects (reference ``datify``)."""
    from datetime import datetime
    import numpy as _np
    return [datetime.fromtimestamp(t)
            for t in _np.atleast_1d(timestamps)]


def but_her_emails(string=None, filename=None):
    """Extract email addresses from a string or file (reference
    ``but_her_emails``)."""
    import re
    if string is None:
        with open(filename or "emails.txt") as f:
            string = f.read().replace("\n", "")
    return re.findall(r"[\w\.-]+@[\w\.-]+", string)


def blend(fg_file, bg_file, alpha, save_file=None, verbose=True):
    """Alpha-blend two image files (reference ``blend``; requires
    PIL — raises ImportError if unavailable, like the reference)."""
    from PIL import Image
    blended = Image.blend(Image.open(fg_file), Image.open(bg_file),
                          alpha=alpha)
    if save_file is not None:
        blended.save(save_file)
        if verbose:
            cprint("Saved blended image to " + save_file, color="g")
    return blended
