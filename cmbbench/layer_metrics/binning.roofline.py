"""``binning.roofline``: the least time of a step's work in the layer of
the ``binning`` family (``Entry.work()``, counted from the cell's shapes)
over the device time of the family's kernels a step, in percent."""
from cmbbench.layer_metrics import roofline


def read(ctx):
    return roofline(ctx, "binning")
