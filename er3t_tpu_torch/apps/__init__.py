"""Applications of the port over its solver: the reflectance LUT and
bispectral retrieval (:mod:`.lut`), spectral flux and radiance
(:mod:`.spectral`) and cloud-map position corrections (:mod:`.cldpos`);
the package imports :mod:`.lut`, as ``er3t_tpu/apps/__init__.py`` does.
"""

from . import lut  # noqa: F401
