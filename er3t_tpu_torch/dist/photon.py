"""Photon-parallel transport: the scene replicated on every rank, one
photon stream a rank, tallies summed (counterpart of
``er3t_tpu/dist/photon.py``).

The counterpart of the reference's fan-out of independent runs over
processes; the only communication is the final sum.
"""

from __future__ import annotations

import torch

from ..rtm.mc import SolverConfig, Tallies, resolve_device
from ..rtm.mc_flight import transport_flight
from ..rtm.scene import SceneArrays
from .mesh import Mesh, rank_seed

__all__ = ['transport_photon_parallel', 'scene_on']


def scene_on(scene: SceneArrays, device) -> SceneArrays:
    """``scene`` with every tensor on ``device`` (no copy where it is
    there already)."""
    return SceneArrays(*[t.to(device) for t in scene])


def transport_photon_parallel(scene, st, cfg: SolverConfig, n_photon: int,
                              mesh: Mesh, seed: int = 0, axes=('x', 'b'),
                              flux_w=None, rad_w=None,
                              stats: dict | None = None) -> Tallies:
    """Run the flight engine on every rank of ``mesh`` and sum the tallies
    (reference :78-98): the same structure as one rank's run.

    The budget split is exact, the first ``n_photon % mesh.size`` ranks
    taking one photon more; rank ``r`` draws from a generator seeded
    ``rank_seed(seed, r)`` on its device.  ``axes`` names the mesh axes
    the photon streams span, which must be every axis longer than 1 (the
    tallies are summed over all ranks).  Ranks held in one process run one
    after the other.  ``stats``: optional dict that receives ``rank_steps``
    and ``rank_photons``, per local rank."""
    left = [a for a, n in mesh.shape.items() if n > 1 and a not in axes]
    if left:
        raise ValueError(f'axes {tuple(axes)} leave out mesh axes {left}: '
                         'the tallies are summed over every rank')
    n_per, rem = divmod(int(n_photon), mesh.size)
    tals, steps, photons = [], [], []
    for r in mesh.local_ranks:
        dev = mesh.device(r)
        scn = scene_on(scene, dev)
        resolve_device(scn, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(rank_seed(seed, r))
        tal = transport_flight(scn, st, cfg, n_per + (r < rem), gen,
                               flux_w=flux_w, rad_w=rad_w)
        tals.append(tal)
        steps.append(int(tal.n_steps))
        photons.append(int(tal.n_launched))
    if stats is not None:
        stats.update(rank_steps=steps, rank_photons=photons)
    return Tallies(*[mesh.psum([getattr(t, f) for t in tals])
                     for f in Tallies._fields])
