"""Models of the port: theory, GRFs, lensing, the quadratic estimator and
the fused lensing pipeline."""
