"""Spectral flux + radiance example on the PyTorch/CUDA port
(er3t_tpu_torch): examples/01_er3t_tpu_spectral.py over the port's
``apps.spectral``, a twin of the reference's
``00_er3t_lrt.py`` spectral cases (lrt_init_spec_flx / lrt_init_spec_rad,
the reference's examples/00_er3t_lrt.py + er3t/rtm/lrt/lrt_flx.py:207-412).

Produces ``examples/output_torch/01_spectral.png`` with:

* SSFR-style surface/TOA irradiance spectra (350-950 nm, 8 nm slit) for a
  clear and a COT=10 water-cloud sky;
* TOA nadir radiance spectra for the same pair;
* the aerosol-loaded direct-beam attenuation.

Engine: the deterministic doubling-adding multi-stream solver with
correlated-k absorption (er3t_tpu_torch.apps.spectral, NumPy on the host)
— the libRadtran role; the MC solver covers the 3D spectral cases
(examples/00_er3t_tpu_torch.py).  ``simulate`` computes the spectra and
``plot`` draws them.

Usage: python examples/01_er3t_tpu_torch_spectral.py [--step 10] [--fast]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.apps.spectral import spec_flx, spec_rad
from er3t_tpu_torch.pre.atm import atm_atmmod

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'output_torch')


def simulate(args):
    """The five spectra of the figure: clear, cloudy and hazy flux, clear
    and cloudy radiance."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    step = 50.0 if args.fast else args.step
    wvl_f = np.arange(350.0, 951.0, step)
    wvl_r = np.arange(350.0, 951.0, max(step, 25.0))
    cld = dict(cloud_base=1.0, cloud_top=2.0, cloud_optical_thickness=10.0,
               cloud_effective_radius=10.0)
    aer = dict(aerosol_optical_depth=0.3, single_scattering_albedo=0.92,
               asymmetry_parameter=0.7, angstrom_exponent=1.3)
    ns = 4 if args.fast else 8

    print(f'# spectral flux: {wvl_f.size} wavelengths x 16 g ...', flush=True)
    clear = spec_flx(atm, wavelengths=wvl_f, solar_zenith_angle=30.0,
                     surface_albedo=0.06, n_streams=ns)
    cloudy = spec_flx(atm, wavelengths=wvl_f, solar_zenith_angle=30.0,
                      surface_albedo=0.06, cld_cfg=cld, n_streams=ns)
    hazy = spec_flx(atm, wavelengths=wvl_f, solar_zenith_angle=30.0,
                    surface_albedo=0.06, aer_cfg=aer, n_streams=ns)
    print(f'# spectral radiance: {wvl_r.size} wavelengths x 16 g ...',
          flush=True)
    rad_clear = spec_rad(atm, wavelengths=wvl_r, solar_zenith_angle=30.0,
                         sensor_zenith_angle=0.0, surface_albedo=0.06,
                         n_streams=ns)
    rad_cloudy = spec_rad(atm, wavelengths=wvl_r, solar_zenith_angle=30.0,
                          sensor_zenith_angle=0.0, surface_albedo=0.06,
                          cld_cfg=cld, n_streams=ns)
    return dict(clear=clear, cloudy=cloudy, hazy=hazy, rad_clear=rad_clear,
                rad_cloudy=rad_cloudy)


def plot(spectra):
    """Draw the spectra of :func:`simulate` into ``OUT``/01_spectral.png;
    returns the file name."""
    clear, cloudy, hazy = spectra['clear'], spectra['cloudy'], spectra['hazy']
    rad_clear, rad_cloudy = spectra['rad_clear'], spectra['rad_cloudy']
    os.makedirs(OUT, exist_ok=True)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
    ax = axes[0]
    ax.plot(clear['wvl'], clear['toa'], 'k--', lw=1, label='TOA down')
    ax.plot(clear['wvl'], clear['f_down'], 'C0', label='sfc down (clear)')
    ax.plot(cloudy['wvl'], cloudy['f_down'], 'C1',
            label='sfc down (COT=10)')
    ax.plot(clear['wvl'], clear['f_up'], 'C0', ls=':', label='TOA up (clear)')
    ax.plot(cloudy['wvl'], cloudy['f_up'], 'C1', ls=':',
            label='TOA up (COT=10)')
    ax.set_xlabel('wavelength [nm]')
    ax.set_ylabel('irradiance [W m$^{-2}$ nm$^{-1}$]')
    ax.set_title('spectral irradiance (8 nm slit)')
    ax.legend(fontsize=7)

    ax = axes[1]
    ax.plot(rad_clear['wvl'], rad_clear['rad'], 'C0', label='clear')
    ax.plot(rad_cloudy['wvl'], rad_cloudy['rad'], 'C1', label='COT=10')
    ax.set_xlabel('wavelength [nm]')
    ax.set_ylabel('radiance [W m$^{-2}$ nm$^{-1}$ sr$^{-1}$]')
    ax.set_title('TOA nadir radiance')
    ax.legend(fontsize=8)

    ax = axes[2]
    ax.plot(clear['wvl'], clear['f_down_direct'], 'C0',
            label='direct (clear)')
    ax.plot(hazy['wvl'], hazy['f_down_direct'], 'C2',
            label='direct (AOD550=0.3)')
    ax.plot(hazy['wvl'], hazy['f_down_diffuse'], 'C2', ls=':',
            label='diffuse (AOD550=0.3)')
    ax.set_xlabel('wavelength [nm]')
    ax.set_ylabel('irradiance [W m$^{-2}$ nm$^{-1}$]')
    ax.set_title('aerosol attenuation (Angstrom 1.3)')
    ax.legend(fontsize=8)

    fig.tight_layout()
    fn = os.path.join(OUT, '01_spectral.png')
    fig.savefig(fn, dpi=130)
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--step', type=float, default=10.0,
                    help='flux wavelength step [nm]')
    ap.add_argument('--fast', action='store_true',
                    help='coarse grids for a quick smoke run')
    args = ap.parse_args()
    print(f'# wrote {plot(simulate(args))}')


if __name__ == '__main__':
    main()
