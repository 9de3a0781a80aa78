"""Facade mirroring reference ``orphics.mpi`` — the process-mesh runtime
(port of ``orphics_tpu.mpi``).

The reference distributes Monte-Carlo tasks over MPI ranks
(``orphics/mpi.py:78-106``); here ranks are ``torch.distributed``
processes on a :class:`~.parallel.runtime.Mesh` and reductions are its
collectives. A :class:`fakeMpiComm`-compatible object is provided so
reference-shaped scripts run unchanged in serial mode.
"""
import os

from .parallel.runtime import (get_mesh, distribute, mpi_distribute,
                               ensemble, ensemble_stats,
                               mpi_abort_on_exception)


class fakeMpiComm:
    """Serial stand-in with the reference's surface (``mpi.py:41``)."""

    def __init__(self):
        self.rank = 0
        self.size = 1

    def Get_rank(self):
        return 0

    def Get_size(self):
        return 1

    def Barrier(self):
        pass

    def barrier(self):
        pass

    def Abort(self, code=1):
        raise SystemExit(code)


MPI = None
comm = fakeMpiComm()
rank = 0
numcores = 1
disable_mpi_env = os.environ.get("DISABLE_MPI", "false")
