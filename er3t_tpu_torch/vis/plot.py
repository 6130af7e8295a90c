"""Quicklook plotting (a copy of ``er3t_tpu/vis/plot.py``, lines 1-81; the
fields may be torch tensors on any device, copied to the host with
:func:`host_array` where the reference calls ``np.asarray``).

``quicklook_radiance`` / ``plot_flux_profile`` replace the reference's
per-example matplotlib blocks; ``compare_data_2d`` is the side-by-side 2D
comparison the reference builds with bokeh (er3t/vis/intv.py:16-...),
rendered with matplotlib here.
"""

from __future__ import annotations

import numpy as np

from ..rtm.out import _host

__all__ = ['quicklook_radiance', 'plot_flux_profile', 'compare_data_2d',
           'host_array']


def host_array(x):
    """``x`` as a NumPy array on the host: a tensor (on any device) is
    detached and copied, anything else goes through ``np.asarray``."""
    return np.asarray(_host(x))


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def quicklook_radiance(rad, fname=None, title='Radiance', extent=None,
                       vmax=None):
    """Save an image of a 2D radiance field; returns the figure."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(host_array(rad).T, origin='lower', cmap='viridis',
                   extent=extent, vmax=vmax)
    fig.colorbar(im, ax=ax, label='Radiance [W m$^{-2}$ nm$^{-1}$ sr$^{-1}$]')
    ax.set_title(title)
    ax.set_xlabel('x')
    ax.set_ylabel('y')
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches='tight')
        plt.close(fig)     # batch loops must not accumulate open figures
    return fig


def plot_flux_profile(flux, z_lev_km, fname=None, title='Flux profile'):
    """Plot f_up / f_down / f_down_direct / f_down_diffuse vs altitude."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 6))
    for key, style in (('f_down', '-'), ('f_down_direct', '--'),
                       ('f_down_diffuse', ':'), ('f_up', '-.')):
        prof = np.squeeze(host_array(flux[key]))
        if prof.ndim > 1:
            prof = prof.reshape(-1, prof.shape[-1]).mean(axis=0)
        ax.plot(prof, z_lev_km, style, label=key)
    ax.set_xlabel('Flux [W m$^{-2}$ nm$^{-1}$]')
    ax.set_ylabel('Altitude [km]')
    ax.legend()
    ax.set_title(title)
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches='tight')
        plt.close(fig)     # batch loops must not accumulate open figures
    return fig


def compare_data_2d(data0, data1, labels=('A', 'B'), fname=None):
    """Side-by-side maps + scatter comparison of two 2D fields."""
    plt = _plt()
    d0 = host_array(data0)
    d1 = host_array(data1)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    vmax = np.nanmax([np.nanmax(d0), np.nanmax(d1)])
    for ax, d, lab in zip(axes[:2], (d0, d1), labels):
        im = ax.imshow(d.T, origin='lower', cmap='viridis', vmin=0, vmax=vmax)
        ax.set_title(lab)
        fig.colorbar(im, ax=ax)
    ok = np.isfinite(d0) & np.isfinite(d1)
    axes[2].plot(d0[ok].ravel(), d1[ok].ravel(), '.', ms=1, alpha=0.3)
    axes[2].plot([0, vmax], [0, vmax], 'r-', lw=1)
    axes[2].set_xlabel(labels[0])
    axes[2].set_ylabel(labels[1])
    r = np.corrcoef(d0[ok].ravel(), d1[ok].ravel())[0, 1] if ok.sum() > 1 else np.nan
    axes[2].set_title(f'r = {r:.4f}')
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches='tight')
        plt.close(fig)     # batch loops must not accumulate open figures
    return fig
