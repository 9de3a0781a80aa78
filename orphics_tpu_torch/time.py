"""Facade mirroring reference ``orphics.time`` (observation-time and
ephemeris helpers); implementations live in ``time_utils`` / ``ephem``."""
from .time_utils import *  # noqa: F401,F403
from .time_utils import __all__ as __all__  # noqa: F401
