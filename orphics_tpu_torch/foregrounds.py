"""Facade mirroring reference ``orphics.foregrounds`` (port of
``orphics_tpu.foregrounds``)."""
from .models.foregrounds import *  # noqa: F401,F403
from .models.foregrounds import __all__ as _fg_all  # noqa: F401
from .models.szhalo import (compute_cl_yy, compute_tsz_power,  # noqa: F401
                            HaloModelYY, battaglia_yl, tinker_f,
                            tinker_bias)

__all__ = list(_fg_all) + ["compute_cl_yy", "compute_tsz_power",
                           "HaloModelYY", "battaglia_yl", "tinker_f",
                           "tinker_bias"]
from .models.szhalo import (compton_y_cib_powers, clyy_classy_sz,  # noqa
                            CIBHaloModel, clyy)
__all__ += ["compton_y_cib_powers", "clyy_classy_sz", "CIBHaloModel",
            "clyy"]
