"""GPU counterparts of the TPU gather probes of ``scripts/``.

:mod:`.gather` holds the kernels' wrappers and their plain versions;
:mod:`.gather_probe` is the entry point.  Nothing is imported eagerly here.
"""
