"""What decides ``correct``: the program's fields against the plain
reference's, at the timed sizes.

For each field the cell names (an (Nx, Ny) image of the solve results, at a
level for flux), ``<field>.strip_z_rms``: the root mean square, over the Nx
column strips and the Ny row strips of the image, of the gap between the
program's strip mean and the reference's, in units of its standard error.
The error is the reference's per-photon variance of that strip (from its
independent batches) over both photon counts.  A field right in the mean
but wrong in place (a deposit in the wrong pixel, an image shifted or
flipped) moves the strips it touches.  And ``<field>.mean_z``: the gap
between the program's and the reference's domain means, in units of its
standard error, worked out the same way from the batches' domain means.
It pools every pixel, so a scale error of a part in a hundred reads
several errors, where each strip's own noise hides it.

Fields of other shapes:

* a field marked ``"domain": true`` is averaged over the domain on both
  sides first (the program's domain-average tallies are a (1, 1) image,
  the reference's per-column crossings are averaged per batch), and only
  ``<field>.mean_z`` is read;
* a profile (a 1-D field, such as ``hr`` of (Nz,)): ``<field>.
  profile_z_rms``, the root mean square over its entries of each entry's
  gap in standard errors, and ``<field>.mean_z`` of its mean over entries;
* pixels that are NaN in the reference (outside a fisheye camera's
  circle) are left out of the strips and means on both sides; a NaN of the
  program anywhere else makes every number of that field NaN, which fails
  (a domain average takes the NaN along).

Beside them ``photons_missing``: the photons that the requests asked for
and the program did not launch, summed over the window's requests (a
budget is exact); and ``photons_cut_ppm``: the photons still in flight
when a flight stopped at its step cap, dropped with what they would still
have tallied, per million photons asked.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ['field_images', 'numbers', 'judge']


def field_images(result_data, fields):
    """{field name: float64 image} of one solve result's data: (Nx, Ny), a
    (1, 1) domain average, or a profile."""
    out = {}
    for f in fields:
        a = np.asarray(result_data[f['key']], dtype=np.float64)
        if 'level' in f:
            a = a[..., f['level']]
        if f.get('domain'):
            a = np.full((1, 1), np.mean(a))
        out[f['name']] = a
    return out


def _strips(img, mean=np.mean):
    return np.concatenate([mean(img, axis=1), mean(img, axis=0)])


def _rms(z):
    return float(np.sqrt(np.mean(z ** 2)))


def _z(prog, ref_batches, n_prog, n_ref_batch):
    """Gaps between the program's ``prog`` and the mean of the reference's
    ``ref_batches`` (K, ...) in standard errors; nothing where the
    reference's batches do not vary."""
    r = ref_batches.mean(axis=0)
    n_ref = n_ref_batch * ref_batches.shape[0]
    v = ref_batches.var(axis=0, ddof=1) * n_ref_batch
    se2 = v * (1.0 / n_prog + 1.0 / n_ref)
    ok = se2 > 0
    return (prog - r)[ok] / np.sqrt(se2[ok])


def numbers(prog_images, n_prog, ref_batches, n_ref_batch, fields,
            photons_missing, photons_cut=0):
    """The numbers compared.  ``prog_images``: {field: [image per request]}
    (each request of equal photons, ``n_prog`` asked in all); ``ref_batches``:
    {field: [image per reference batch]}, ``n_ref_batch`` photons each."""
    out = {'photons_missing': float(photons_missing),
           'photons_cut_ppm': 1e6 * float(photons_cut) / float(n_prog)}
    for f in fields:
        name = f['name']
        p = np.mean(prog_images[name], axis=0)
        rb = np.stack(ref_batches[name])
        mean = np.mean
        masked = np.isnan(rb).any(axis=0)
        stray = bool(np.isnan(p[~masked]).any())
        if masked.any():
            p, rb = np.where(masked, np.nan, p), np.where(masked, np.nan, rb)
            mean = _nanmean
        got = {}
        if p.ndim == 1:
            z = _z(p, rb, n_prog, n_ref_batch)
            got[f'{name}.profile_z_rms'] = _rms(z)
        elif p.size > 1:
            z = _z(_strips(p, mean), np.stack([_strips(b, mean) for b in rb]),
                   n_prog, n_ref_batch)
            got[f'{name}.strip_z_rms'] = _rms(z)
        zm = _z(np.array([mean(p)]),
                mean(rb, axis=tuple(range(1, rb.ndim)))[:, None], n_prog,
                n_ref_batch)
        got[f'{name}.mean_z'] = float(abs(zm[0])) if zm.size else np.inf
        # a program NaN where the reference has a number would otherwise
        # drop out of the masked strips and means
        out.update({k: np.nan for k in got} if stray else got)
    return out


def _nanmean(a, axis=None):
    """``np.nanmean``, quiet where a whole strip lies outside the image (its
    NaN then drops out of :func:`_z`)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        return np.nanmean(a, axis=axis)


def judge(values, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is not finite fails."""
    rows = [(k, values[k], float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
