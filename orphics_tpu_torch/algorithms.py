"""Facade mirroring reference ``orphics.algorithms`` (port of
``orphics_tpu.algorithms``)."""
from .ops.algorithms import vectorized_bisection_search
