"""Quicklook plots and the interactive comparison page (a copy of
``er3t_tpu/vis/__init__.py``: the same four functions)."""

from .plot import compare_data_2d, plot_flux_profile, quicklook_radiance  # noqa: F401
from .intv import compare_data_2d_html  # noqa: F401
