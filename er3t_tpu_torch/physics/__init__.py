"""Physics helpers of the port: NumPy copies of ``er3t_tpu/physics`` modules."""
