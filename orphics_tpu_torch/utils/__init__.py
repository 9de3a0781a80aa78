"""Host utilities of the port (mirrors ``orphics_tpu.utils``)."""
