"""``allreduce_ms``: device milliseconds a step in NCCL's collective kernels
(the ``collective`` family) on rank 0 over the traced stretch. A kernel
of the all-reduce runs from its launch until every rank has joined, so
this reads the wait for the slowest rank too."""


def read(ctx):
    return (ctx.trace or {}).get("family_ms", {}).get("collective")
