"""Scene inputs of the port: NumPy copies of ``er3t_tpu/pre`` modules."""
