"""``legendre_syn.roofline``: the least time of a step's work in the layer
of the ``legendre_syn`` family (``Entry.work()``, counted from the cell's
geometry by ``work_sht.py``) over the device time of the family's
kernels a step, in percent."""
from cmbbench.layer_metrics import roofline


def read(ctx):
    return roofline(ctx, "legendre_syn")
