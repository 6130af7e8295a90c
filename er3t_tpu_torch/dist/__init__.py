"""Multi-device transport of the port (counterpart of ``er3t_tpu/dist``):
:mod:`.mesh` (ranks and collectives), :mod:`.photon` (photon-parallel
runs) and :mod:`.decomp` (x-slab domain decomposition with photon
migration).  Nothing is imported eagerly here."""
