"""Device compute kernels: codec, fused scans, aggregation, join, sort."""
