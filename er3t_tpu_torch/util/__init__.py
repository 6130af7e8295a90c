"""Utilities of the port: NumPy copies of ``er3t_tpu/util`` modules."""
