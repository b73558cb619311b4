"""Runtime/device helpers for the serving fabric — the single-process part
of ``repro.api.runtime``.

``device_count`` and ``device_slices`` carve the CUDA devices of this
process; ``distributed_init`` validates a multi-process request and, in
single-process mode, is a deliberate no-op, so the same worker entry
point runs unchanged on a laptop, in CI and on one card. The
multi-process mode needs the distributed engine (``dist/``), which is
not ported to ``repro_torch`` yet: asking for it raises
``NotImplementedError``. Nothing here touches a device at import.
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
                     local_device_ids: Optional[Sequence[int]] = None
                     ) -> dict:
    """The fabric worker's multi-process runtime.

    Arguments fall back to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment variables.
    ``num_processes`` of 1 (or unset with no coordinator) is the
    single-process mode: a deliberate no-op that returns ``{"mode":
    "single-process", "process_id": 0, "num_processes": 1}``. Ranks are
    validated (``ValueError``); a valid multi-process request raises
    ``NotImplementedError``: it needs the distributed engine."""
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
    raise NotImplementedError(
        f"distributed_init({coordinator_address!r}, num_processes="
        f"{num_processes}, process_id={process_id}): the multi-process "
        "runtime needs the distributed engine (dist/), which is not "
        "ported to repro_torch yet")
