"""Satellite readers and DAAC tools (a copy of ``er3t_tpu/sat/__init__.py``:
the same five submodules; ``calipso`` is imported on its own)."""

from . import ahi, daac, modis, oco2, viirs  # noqa: F401
