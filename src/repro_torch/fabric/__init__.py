"""Cross-process serving fabric — the tier above ``repro_torch.serve``,
port of ``repro.fabric``.

A :class:`FrontDoor` admits partition requests over a lightweight RPC
protocol (length-prefixed JSON over TCP, standard library only) and
routes them to registered :class:`FabricWorker` processes — each one a
whole ``PartitionServer`` with its own CUDA context, loaded kernels and
graph caches, so that two workers on one card never share an
interpreter lock. Workers keep a heartbeat lease warm in the front
door's :class:`ServerRegistry`; a killed worker's in-flight requests
fail over to the survivors with the same structured-error contract as
the in-process tier, and an optional autoscaler grows/shrinks the fleet
from queue pressure:

    from repro_torch.fabric import FrontDoor, FabricWorker, FabricClient

    fd = FrontDoor(port=0)
    w = FabricWorker(frontdoor=(fd.host, fd.port), meshes=2)
    with FabricClient(fd.host, fd.port) as c:
        res = c.submit(request).result()  # FabricResult
        res.ok, res.assignment, res.server

Results are bit-identical to solo ``repro_torch.api.Partitioner.run``
for the same request. See ``repro_torch.launch.fabric`` for the CLI.

Exports resolve lazily (PEP 562) so importing ``repro_torch.fabric``
never touches a device — the front door and client own no devices; only
worker processes ever run a partition.
"""

from importlib import import_module

_EXPORTS = {
    "FrontDoor": ".frontdoor",
    "FabricWorker": ".worker",
    "FabricClient": ".client",
    "status_of": ".client",
    "FabricResult": ".protocol",
    "ServerRegistry": ".registry",
    "ServerRecord": ".registry",
    "AutoscaleConfig": ".autoscaler",
    "AutoscalePolicy": ".autoscaler",
    "ProcessScaler": ".autoscaler",
    "pick_server": ".frontdoor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        mod = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    return getattr(import_module(mod, __name__), name)


def __dir__():
    return __all__
