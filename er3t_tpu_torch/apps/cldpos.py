"""Cloud-map position corrections for satellite-driven 3D scenes (NumPy copy
of ``er3t_tpu/apps/cldpos.py:19-141``: ``move_correlate``,
``parallax_shift``, ``wind_shift``, ``shift_fields`` and
``correct_cloud_map``).

Retrieved cloud maps are re-registered to the true cloud positions: the
parallax of each cloud's height along the sensor azimuth, the advection by
the steering wind between two overpasses, and an integer mask
cross-correlation.  Azimuth in degrees clockwise from north; ``i`` indexes
x/east with spacing ``dx_km``, ``j`` indexes y/north with spacing
``dy_km``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['move_correlate', 'parallax_shift', 'wind_shift', 'shift_fields',
           'correct_cloud_map']


def move_correlate(mask_a, mask_b, max_offset=10):
    """Integer (di, dj) shifting ``mask_b`` onto ``mask_a``.

    Maximizes the overlap of the two binary masks over integer shifts in
    [-max_offset, max_offset]^2 (the er3t.util.move_correlate role: the
    reflectance-derived cloud mask vs the L2 product's CTH mask, reference
    :918-920).  Returns (0, 0) when either mask is empty.
    """
    a = np.asarray(mask_a, dtype=np.float64)
    b = np.asarray(mask_b, dtype=np.float64)
    if a.sum() == 0 or b.sum() == 0:
        return 0, 0
    best, best_off = -1.0, (0, 0)
    ii = np.arange(a.shape[0])[:, None]
    jj = np.arange(a.shape[1])[None, :]
    for di in range(-max_offset, max_offset + 1):
        for dj in range(-max_offset, max_offset + 1):
            s = np.roll(np.roll(b, di, axis=0), dj, axis=1)
            # exclude content wrapped past the domain edge — the
            # reference scores only in-bounds samples (util.py:360-373);
            # wrapped copies create spurious overlap at wrong shifts for
            # clouds near the boundary
            valid = ((ii >= di) if di >= 0 else (ii < a.shape[0] + di)) \
                & ((jj >= dj) if dj >= 0 else (jj < a.shape[1] + dj))
            score = float((a * s * valid).sum())
            if score > best:
                best, best_off = score, (di, dj)
    return best_off


def parallax_shift(cth_km, sfh_km, vza_deg, vaa_deg, dx_km, dy_km):
    """Per-pixel (di, dj) fractional grid-cell parallax correction.

    The apparent cloud position is displaced away from the sensor by
    ``(CTH - sfc_h) tan(VZA)``; the correction moves each cloudy pixel by
    that distance along the sensor azimuth (reference ``para_corr``,
    01_oco2_rad-sim.py:786-806 — geodesic displacement at azimuth
    ``vaa``).  All inputs broadcast; heights in km.
    """
    dist = (np.asarray(cth_km) - np.asarray(sfh_km)) \
        * np.tan(np.deg2rad(vza_deg))
    az = np.deg2rad(vaa_deg)
    return (dist * np.sin(az) / dx_km,       # east component
            dist * np.cos(az) / dy_km)       # north component


def wind_shift(u10, v10, dt_s, dx_km, dy_km):
    """(di, dj) advection by the steering wind over ``dt_s`` seconds.

    ``u10`` eastward / ``v10`` northward wind [m/s] (reference
    ``wind_corr``, 01_oco2_rad-sim.py:808-826, applied with the scene
    median wind and the imager-to-sensor time offset).
    """
    return (np.asarray(u10) * dt_s / 1000.0 / dx_km,
            np.asarray(v10) * dt_s / 1000.0 / dy_km)


def shift_fields(fields, di, dj, fill=0.0):
    """Scatter 2D ``fields`` to their corrected positions.

    ``di``/``dj`` are per-pixel (or scalar) fractional cell offsets; each
    source pixel writes its values to the rounded destination cell, and
    destinations outside the grid are dropped (the reference's bounds
    check, :1045-1050).  Returns the shifted fields plus the destination
    mask.  Only pixels where the FIRST field is > 0 move (the cloudy set,
    matching the reference's ``indices_x/indices_y`` loop).
    """
    fields = [np.asarray(f) for f in fields]
    nx, ny = fields[0].shape
    src = fields[0] > 0
    ii, jj = np.nonzero(src)
    ic = np.round(ii + np.broadcast_to(di, fields[0].shape)[ii, jj]) \
        .astype(np.int64)
    jc = np.round(jj + np.broadcast_to(dj, fields[0].shape)[ii, jj]) \
        .astype(np.int64)
    ok = (ic >= 0) & (ic < nx) & (jc >= 0) & (jc < ny)
    outs = []
    for f in fields:
        o = np.full_like(f, fill)
        o[ic[ok], jc[ok]] = f[ii[ok], jj[ok]]
        outs.append(o)
    msk = np.zeros((nx, ny), dtype=np.int32)
    msk[ic[ok], jc[ok]] = 1
    return outs, msk


def correct_cloud_map(cot, cer, cth, *, sfh_km=0.0, vza_deg=0.0,
                      vaa_deg=0.0, u10=0.0, v10=0.0, dt_s=0.0,
                      dx_km=0.25, dy_km=0.25, mode='3d', align_mask=None,
                      align_max_offset=10):
    """Compose the full correction chain for a retrieved cloud map.

    ``mode='3d'``: parallax + wind (the reference's 3D branch,
    :1058-1100); ``mode='ipa'``: wind only (:1024-1050 — IPA runs keep the
    apparent positions since the IPA forward model sees the same
    parallax).  ``align_mask``: an independent cloud mask (e.g. the
    reflectance-derived one) to register the map against by integer
    cross-correlation first — the reference's ``move_correlate`` step of
    ``cdata_cld_ipa`` (:912-935), applied before the physical
    corrections.  Returns (cot, cer, cth, mask).
    """
    dia = dja = 0.0
    if align_mask is not None:
        dia, dja = move_correlate(align_mask, np.asarray(cot) > 0,
                                  max_offset=align_max_offset)
    if mode == '3d':
        dip, djp = parallax_shift(cth, sfh_km, vza_deg, vaa_deg,
                                  dx_km, dy_km)
    else:
        dip = djp = 0.0
    diw, djw = wind_shift(u10, v10, dt_s, dx_km, dy_km)
    (cot_c, cer_c, cth_c), msk = shift_fields(
        [cot, cer, cth], np.asarray(dip) + diw + dia,
        np.asarray(djp) + djw + dja)
    return cot_c, cer_c, cth_c, msk
