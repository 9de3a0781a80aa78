"""Host utilities of the port (mirrors ``orphics_tpu.utils``). Importing
them needs none of matplotlib, h5py, yaml, PIL or pandas: each function
that uses one imports it."""
from . import io, plot, fitting, healpix
