"""The process-mesh layer (port of ``orphics_tpu.parallel``): sufficient
statistics, the ensemble runtime, and the grid- and ring-distributed
transforms, on ``torch.distributed``."""
from . import statistics, runtime, fourier, sht
from .statistics import SuffStats, Statistics, Stats, get_stats
from .runtime import (get_mesh, distribute, mpi_distribute, ensemble,
                      ensemble_stats, ensemble_stats_checkpointed,
                      init_multihost)
