"""Roofline arithmetic of the port (counterpart of ``repro/roofline``):
the conv layer's operation and byte counts and the model counts of the
ported configs (``flops``), and the card's peaks with the least time a
call could take and the dry-run's counting of one rank's step
(``analysis``)."""
from . import analysis, flops  # noqa: F401
