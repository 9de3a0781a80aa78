"""``elementwise_ms``: device milliseconds a step in PyTorch's own
elementwise, reduction, copy, index and fill kernels (the ``elementwise``
family) over the traced stretch."""


def read(ctx):
    return (ctx.trace or {}).get("family_ms", {}).get("elementwise")
