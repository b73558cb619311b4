"""Runtime/device helpers — port of ``repro.api.runtime``.

``device_count`` and ``device_slices`` carve the CUDA devices of this
process. ``distributed_init`` is the multi-process runtime of the
distributed engine (``dist/``): one process a PE, joined in a
``torch.distributed`` group (NCCL on the cards, gloo when the CPU is
asked for); in single-process mode it is a deliberate no-op, so the same
entry point runs unchanged on a laptop, in CI and on one card.
``pe_group`` gives the ``dist`` backends the group of a request's P
ranks, and makes a one-rank group for a one-device request when none is
initialised. Nothing here touches a device at import.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence


def device_count() -> int:
    """CUDA devices visible to this process (0 without CUDA)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_slices(num_slices: int, devices_per_slice: int) -> List[list]:
    """Carve this process's CUDA devices into ``num_slices`` disjoint
    contiguous slices of ``devices_per_slice`` devices each (the serving
    tier's worker meshes: one server per device group).

    Raises ``RuntimeError`` when the process does not have ``num_slices *
    devices_per_slice`` devices — oversubscribing a device into two
    meshes would serialize their work against each other, which is
    exactly what a multi-mesh tier exists to avoid."""
    if num_slices < 1 or devices_per_slice < 1:
        raise ValueError(
            "need num_slices >= 1 and devices_per_slice >= 1, got "
            f"{num_slices} x {devices_per_slice}")
    import torch
    have = device_count()
    need = num_slices * devices_per_slice
    if have < need:
        # name the shortfall AND the largest feasible carve, both ways
        # round — the caller decides whether to shrink the slice count
        # or the slices themselves
        feas_slices = have // devices_per_slice
        feas_per = have // num_slices
        if feas_slices >= 1:
            hint = (f"largest feasible: {feas_slices} slice(s) of "
                    f"{devices_per_slice}")
            if feas_per >= 1 and feas_per != devices_per_slice:
                hint += (f", or {num_slices} slice(s) of {feas_per} "
                         "device(s)")
        elif feas_per >= 1:
            hint = (f"largest feasible: {num_slices} slice(s) of "
                    f"{feas_per} device(s)")
        else:
            hint = "no carve of this shape is feasible"
        raise RuntimeError(
            f"cannot carve {num_slices} slice(s) of {devices_per_slice} "
            f"device(s) ({need} total): only {have} device(s) "
            f"available; {hint}")
    devs = [torch.device("cuda", i) for i in range(need)]
    return [devs[i * devices_per_slice:(i + 1) * devices_per_slice]
            for i in range(num_slices)]


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device=None) -> dict:
    """The multi-process runtime of the distributed engine: this process
    joins a ``torch.distributed`` group of ``num_processes`` ranks as rank
    ``process_id``, with the group's address ``coordinator_address``
    (``host:port``; rank 0 listens there).

    Arguments fall back to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables.
    ``num_processes`` of 1 (or unset with no coordinator) is the
    single-process mode: a deliberate no-op that returns ``{"mode":
    "single-process", "process_id": 0, "num_processes": 1}``. Ranks are
    validated (``ValueError``). A rank runs on its card by default: NCCL,
    bound to card ``local_device_ids[0]`` (else ``process_id`` modulo the
    cards it sees), and it raises without CUDA; ``device="cpu"`` asks for
    the CPU on purpose and joins with gloo. Returns ``{"mode":
    "multi-process", "process_id", "num_processes", "backend",
    "device"}``."""
    coordinator_address = coordinator_address or \
        os.environ.get("REPRO_COORDINATOR") or None
    if num_processes is None:
        env_np = os.environ.get("REPRO_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if process_id is None:
        env_pid = os.environ.get("REPRO_PROCESS_ID")
        process_id = int(env_pid) if env_pid else None
    if coordinator_address is None and (num_processes or 1) <= 1:
        return {"mode": "single-process", "process_id": 0,
                "num_processes": 1}
    if num_processes is not None and num_processes < 1:
        raise ValueError(
            f"num_processes must be >= 1, got {num_processes}")
    if process_id is not None and num_processes is not None and \
            not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for "
            f"{num_processes} process(es)")
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError(
            "the multi-process runtime needs the coordinator address, the "
            "process count and this process's id (arguments or "
            "REPRO_COORDINATOR / REPRO_NUM_PROCESSES / REPRO_PROCESS_ID), "
            f"got {coordinator_address!r}, {num_processes}, {process_id}")
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "distributed_init: this process already belongs to a "
            "torch.distributed group")
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        from ..kernels.dispatch import resolve_device
        resolve_device(device)           # raises without CUDA
        local = local_device_ids[0] if local_device_ids else \
            process_id % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return {"mode": "multi-process", "process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(), "backend": backend,
            "device": str(dev)}


def pe_group(P: int, device):
    """The ``dist.PeGroup`` a ``dist`` backend runs a P-device request
    under: the initialised default group, which must have P ranks and a
    backend that serves ``device`` (gloo the CPU, NCCL a card). With no
    group and P == 1, a one-rank group is made here and kept for the
    process. Raises ``ValueError`` otherwise."""
    import torch
    import torch.distributed as dist
    from ..dist.collectives import world_group
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if P != 1:
            raise ValueError(
                f"a request for {P} devices runs one process a device, "
                "under a torch.distributed group of that size, and none is "
                "initialised: start the ranks with repro_torch.api.runtime."
                "distributed_init (REPRO_COORDINATOR / REPRO_NUM_PROCESSES "
                "/ REPRO_PROCESS_ID), or run launch/partition.py --devices "
                f"{P}")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != P:
        raise ValueError(
            f"a request for {P} devices under a torch.distributed group of "
            f"{dist.get_world_size()} ranks: start {P} ranks with "
            "repro_torch.api.runtime.distributed_init, or run "
            f"launch/partition.py --devices {P}")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(
            f"the torch.distributed group runs {dist.get_backend()}, which "
            f"does not serve {dev}; a rank on {dev} needs {want}")
    return world_group(dev)
