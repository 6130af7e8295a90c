"""Utilities of the port: NumPy copies of ``er3t_tpu/util`` modules, and
the port's own spans and counters (:mod:`.trace`)."""
