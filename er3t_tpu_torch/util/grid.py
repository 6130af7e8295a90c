"""Gridding helpers (NumPy copy of ``er3t_tpu/util/grid.py``: ``downscale``
:17-35, ``downscale_3d`` :38-39, ``get_lay_index`` :53-57).
"""

from __future__ import annotations

import numpy as np

__all__ = ['downscale_3d', 'downscale', 'get_lay_index']


def downscale(data: np.ndarray, new_shape, operation: str = 'mean') -> np.ndarray:
    """Block-reduce an array to ``new_shape`` (each dim must divide evenly)."""
    data = np.asarray(data)
    if data.ndim != len(new_shape):
        raise ValueError('rank mismatch')
    pairs = []
    for old, new in zip(data.shape, new_shape):
        if old % new:
            raise ValueError(f'{old} not divisible by {new}')
        pairs.extend([new, old // new])
    out = data.reshape(pairs)
    axes = tuple(range(1, 2 * len(new_shape), 2))
    if operation == 'mean':
        return out.mean(axis=axes)
    if operation == 'sum':
        return out.sum(axis=axes)
    if operation == 'max':
        return out.max(axis=axes)
    raise ValueError(operation)


def downscale_3d(data, new_shape):
    return downscale(data, new_shape, 'mean')


def get_lay_index(z_query: np.ndarray, z_grid: np.ndarray) -> np.ndarray:
    """Nearest layer index in ``z_grid`` for each query altitude
    (reference: util.py:816-833)."""
    z_query = np.atleast_1d(z_query)
    return np.abs(z_query[:, None] - np.asarray(z_grid)[None, :]).argmin(axis=1)
