"""Serving tier of the port — traffic, not single jobs.

``PartitionServer`` layers an admission queue (priorities, deadlines),
a best-fit worker scheduler, a shared graph cache and worker supervision
(one retry on another worker, then a structured error) over N
single-device ``PartitionSession`` workers on one torch device:

    from repro_torch.serve import PartitionServer

    with PartitionServer(meshes=2) as srv:          # on the CUDA device
        fut = srv.submit(request, priority=0, deadline_s=30.0)
        res = fut.result()  # ServeResult
        res.ok, res.result, res.error, res.worker

Results are bit-identical to solo ``repro_torch.api.Partitioner.run``
for the same request. Same-bucket batches coalesce identical requests
and stack their level-0 clustering (``serve.batching``).

Exports resolve lazily (PEP 562), so importing ``repro_torch.serve``
touches no device.
"""

from importlib import import_module

_EXPORTS = {
    "PartitionServer": ".server",
    "ServeResult": ".server",
    "AdmissionQueue": ".queue",
    "Ticket": ".queue",
    "ServeMetrics": ".metrics",
    "pick_worker": ".scheduler",
    "rank": ".scheduler",
    "BucketKey": ".batching",
    "bucket_of": ".batching",
    "pad_graph": ".batching",
    "remove_padding": ".batching",
    "run_coalesced": ".batching",
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
