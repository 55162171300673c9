"""Data-parallel calibration over ``torch.distributed`` (the JAX package's
mesh-sharded calibration)."""
