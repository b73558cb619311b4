"""Admission queue for the serving tier — a copy of the JAX package's
``serve/queue.py`` (threading only, jax-free).

A bounded, thread-safe priority queue of :class:`Ticket` objects. Lower
``priority`` values dispatch first; ties dispatch in admission order
(the sequence number doubles as the tiebreak, so a *retried* ticket —
which keeps its original sequence number — goes back to the front of
its priority class instead of behind newer work).

Deadlines are carried on the ticket and *checked by the consumers*
(dispatcher and workers), not enforced here: expiry must produce a
structured error result, which only the server can resolve.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Set


@dataclasses.dataclass
class Ticket:
    """One admitted request plus its serving state.

    ``deadline`` and ``timeout_s`` are distinct knobs: the deadline is
    an absolute completion bound (expired tickets resolve to a
    structured ``deadline_exceeded`` error without running), while
    ``timeout_s`` bounds one *attempt* on one worker (a timed-out
    attempt marks that worker wedged and retries elsewhere).
    """

    request: object  # PartitionRequest
    priority: int
    seq: int
    future: Future
    submit_t: float  # monotonic admission time
    deadline: Optional[float] = None  # absolute monotonic deadline
    timeout_s: Optional[float] = None  # per-attempt run timeout
    need: int = 1  # PE count the resolved backend wants
    bucket: Optional[tuple] = None  # shape bucket (batchable) or None
    attempts: int = 0  # failed attempts so far
    # mesh ids (in-process server) or server-id strings (fabric front
    # door) this ticket must not be routed to again
    excluded: Set = dataclasses.field(default_factory=set)
    worker: Optional[int] = None  # worker currently assigned
    dispatch_t: Optional[float] = None  # first leave-the-queue time
    errors: List[str] = dataclasses.field(default_factory=list)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the deadline (None when unbounded)."""
        if self.deadline is None:
            return None
        now = time.monotonic() if now is None else now
        return max(0.0, self.deadline - now)


class AdmissionQueue:
    """Bounded priority queue; ``put`` returns False when full/closed.

    ``requeue`` bypasses the capacity bound: a retried ticket was
    already admitted once, and dropping it on a full queue would turn
    the retry guarantee into a coin flip under load.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._heap: list = []  # (priority, seq, ticket)
        self._cond = threading.Condition()
        self._closed = False

    def put(self, ticket: Ticket) -> bool:
        with self._cond:
            if self._closed or len(self._heap) >= self.capacity:
                return False
            heapq.heappush(self._heap, (ticket.priority, ticket.seq, ticket))
            self._cond.notify()
            return True

    def requeue(self, ticket: Ticket) -> bool:
        with self._cond:
            if self._closed:
                return False
            heapq.heappush(self._heap, (ticket.priority, ticket.seq, ticket))
            self._cond.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Highest-priority ticket, or None on timeout — or immediately
        once the queue is closed *and* drained.

        Waits in a deadline loop: a spurious wakeup, or a competing
        consumer winning the notify, puts this caller back to sleep for
        the time actually remaining instead of returning None with time
        still on the clock (the lost-wakeup bug under two consumers)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._heap:
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return heapq.heappop(self._heap)[2]

    def pop_matching(self, pred) -> Optional[Ticket]:
        """Remove and return the highest-priority ticket satisfying
        ``pred``, or None (without blocking). This is what lets the
        dispatcher skip a ticket whose eligible meshes are all busy and
        serve the next one — instead of head-of-line blocking the whole
        queue behind it.

        One linear scan over the heap array tracking the best match
        (the heap is unordered beyond its invariant, so every entry is
        visited once), then an O(log n) index removal — the dispatcher's
        hot loop must not pay the old sort-the-whole-heap O(n log n)."""
        with self._cond:
            return self._pop_matching_locked(pred)

    def pop_batch(
        self, pred, limit: int, window_s: float = 0.0
    ) -> List[Ticket]:
        """Remove up to ``limit`` tickets satisfying ``pred``, best
        (priority, seq) first. When fewer than ``limit`` are queued,
        linger up to ``window_s`` for more matching admissions — the
        dispatcher's batch-collection window. Returns immediately with
        whatever matched once the queue is closed."""
        out: List[Ticket] = []
        if limit <= 0:
            return out
        deadline = time.monotonic() + max(0.0, window_s)
        with self._cond:
            while len(out) < limit:
                t = self._pop_matching_locked(pred)
                if t is not None:
                    out.append(t)
                    continue
                if self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return out

    def _pop_matching_locked(self, pred) -> Optional[Ticket]:
        heap = self._heap
        best = -1
        for i, (prio, seq, t) in enumerate(heap):
            if best >= 0 and (prio, seq) >= heap[best][:2]:
                continue
            if pred(t):
                best = i
        if best < 0:
            return None
        return self._remove_at(best)

    def _remove_at(self, i: int) -> Ticket:
        """Remove the entry at heap index ``i``: swap in the last entry
        and restore the invariant around the hole (float up, else sink
        below the smaller child). (priority, seq) keys are unique, so
        entry comparisons never reach the unorderable ticket payload."""
        heap = self._heap
        entry = heap[i]
        last = heap.pop()
        if i < len(heap):
            heap[i] = last
            while i > 0 and heap[i] < heap[(i - 1) >> 1]:
                parent = (i - 1) >> 1
                heap[i], heap[parent] = heap[parent], heap[i]
                i = parent
            n = len(heap)
            while True:
                child = 2 * i + 1
                if child >= n:
                    break
                if child + 1 < n and heap[child + 1] < heap[child]:
                    child += 1
                if heap[child] < heap[i]:
                    heap[i], heap[child] = heap[child], heap[i]
                    i = child
                else:
                    break
        return entry[2]

    def drain(self) -> List[Ticket]:
        """Remove and return every queued ticket (close-time cleanup)."""
        with self._cond:
            out = [t for _, _, t in self._heap]
            self._heap.clear()
            return out

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
