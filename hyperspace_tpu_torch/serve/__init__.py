"""Concurrent serve frontend and the replicated fleet member built on it.

Counterpart of ``hyperspace_tpu/serve/``. The many-queries-one-process
plane over the single-query engine: admission control (single-flight
dedup, load shedding, per-tenant SLO classes), snapshot-consistent index
pinning and retry/degrade at the operation boundary
(:mod:`hyperspace_tpu_torch.serve.frontend`). With
``hyperspace.fleet.enabled`` the frontend is a
:class:`~hyperspace_tpu_torch.serve.fleet.FleetFrontend`: durable
cross-process pins, index-version fanout over the bus
(:mod:`hyperspace_tpu_torch.serve.bus`), cross-process single-flight
through the claim/spool plane, and the fast plane of Unix-socket pushes
and owner routing (:mod:`~hyperspace_tpu_torch.serve.fastbus`,
:mod:`~hyperspace_tpu_torch.serve.router`).
"""

from hyperspace_tpu_torch.serve.frontend import ServeFrontend, plan_fingerprint


def __getattr__(name):
    # FleetFrontend lazily: most sessions never enter fleet mode, and the
    # fleet module pulls in the bus and spool machinery
    if name == "FleetFrontend":
        from hyperspace_tpu_torch.serve.fleet import FleetFrontend

        return FleetFrontend
    raise AttributeError(name)


__all__ = ["ServeFrontend", "FleetFrontend", "plan_fingerprint"]
