"""Adaptive microbatch coalescing for the ingest hot path (copy of
``jubatus_tpu/server/microbatch.py``; the perf tuner's coalescer core
retargets the flush bound through ``set_max_batch``).

The reference applies each datum under a write lock as it arrives
(classifier_serv.cpp:127-146) — fine when an update is a few hundred ns
of pointer math, wrong on an accelerator where every step costs launches
and a host/device round trip whatever the batch size. Here concurrent
update RPCs coalesce into one device batch.

Design — batching from backpressure, zero idle waiting: a submitter that
finds no flush in progress becomes the flusher and processes its items
IMMEDIATELY (a lone client never waits); while its flush occupies the
device, later submitters enqueue and block on tickets; when the flusher
finishes it drains everything that accumulated as ONE batch, and keeps
draining until the queue is empty before handing off. Load creates
batches; idleness creates latency-free pass-through.

Exceptions from a flush propagate to exactly the tickets whose items
were in that batch.

Coalescing depth is bounded by RPC worker concurrency: with the
reference-parity default of 2 worker threads (``-c``), at most one call
can queue behind a flush, so flushes ≈ RPCs. Ingest deployments
should raise ``-c`` toward their client concurrency.

Usage billing: with ``usage_hook`` set, each ticket carries its
submitting thread's principal and its enqueue and claim times, and at the
end of its flush the hook gets (principal, rows, queue seconds, the
flush's seconds times the ticket's share of the rows). The flush's
seconds are host wall time around ``flush_fn``: on the card a flush that
returns before its kernels finish bills their launch time only, and no
synchronisation is added for billing.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Sequence

from jubatus_tpu_torch.rpc import principal as principals

__all__ = ["Coalescer", "PipelinedCoalescer"]

#: trailing flush-duration EWMA weight: ~10 flushes of memory, newest
#: weighted heaviest
FLUSH_EWMA_ALPHA = 0.2


class _Ticket:
    __slots__ = ("event", "result", "error", "count", "weight",
                 "principal", "enq", "claimed")

    def __init__(self, count: int, weight: int,
                 principal: str | None = None, enq: float = 0.0) -> None:
        self.event = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        self.count = count    # item-list slots (queue bookkeeping)
        self.weight = weight  # examples represented (max_batch accounting)
        #: usage billing: the submitting RPC thread's principal rides the
        #: ticket into the flush (the flusher runs on ANOTHER ticket's
        #: thread, so the thread-local is useless by flush time), plus
        #: the enqueue / claim stamps queue residency derives from
        self.principal = principal
        self.enq = enq
        self.claimed = 0.0


class Coalescer:
    """Coalesce concurrent ``submit(items)`` calls into batched
    ``flush_fn(all_items)`` invocations.

    ``flush_fn`` receives the concatenated item list and returns a value;
    every contributing submitter gets that same return value (engines
    here return accepted-count, which callers recompute from their own
    len(items) — see ``submit``'s return). ``max_batch`` bounds one
    flush; the rest stays queued for the next round.
    """

    def __init__(self, flush_fn: Callable[[List[Any]], Any],
                 max_batch: int = 8192,
                 weigher: Callable[[Any], int] | None = None,
                 split_results: bool = False) -> None:
        """``weigher(item) -> examples`` lets one item represent a whole
        request's batch (the native fast path queues per-REQUEST array
        triples — far less Python object churn than per-example rows);
        max_batch then bounds examples, not items. Default: 1 per item.

        ``split_results``: QUERY-plane mode — ``flush_fn`` must return a
        sequence with one entry per submitted item, and each submitter
        receives exactly its own slice (train flushes return one shared
        scalar instead, the default)."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._flush = flush_fn
        self._max_batch = max_batch
        self._weigher = weigher
        self._split = split_results
        self._lock = threading.Lock()
        self._pending_items: List[Any] = []
        self._pending_tickets: List[_Ticket] = []
        self._active = False
        #: flush invocations / items flushed (observability; get_status)
        self.flush_count = 0
        self.item_count = 0
        #: queued-but-unflushed examples (the autoscaler's primary load
        #: signal: arrival outrunning the device drains HERE first) and
        #: the cumulative arrival counter its rate derives from
        self._pending_weight = 0
        self._arrived = 0
        self._arrival_ref = (time.monotonic(), 0)
        #: trailing flush-duration EWMA (ms); 0 until a flush has run.
        #: The single-stage coalescer folds the whole flush in, the
        #: pipelined one folds only the device stage: the drain rate
        self._flush_ms_ewma = 0.0
        #: usage billing: when set, called once per completed ticket as
        #: hook(principal, rows, queue_seconds, device_share_seconds);
        #: the service layer binds it to the usage ledger
        self.usage_hook: Callable[[str | None, int, float, float],
                                  None] | None = None

    def submit(self, items: Sequence[Any],
               timeout: float | None = 60.0) -> Any:
        """Block until a flush containing ``items`` completes; returns
        that flush's result. Raises whatever the flush raised.

        ``timeout`` None or <= 0 waits forever. On timeout, items still
        QUEUED are withdrawn first — a TimeoutError then guarantees the
        model was not updated (same contract as a failed direct call); if
        the items were already claimed by an in-flight flush they cannot
        be recalled, so one more ``timeout`` is granted before giving up
        with a message saying the update may still land."""
        items = list(items)
        if not items:
            # split mode's contract is one result per item — for zero
            # items that is an empty sequence, not a flush of nothing
            return [] if self._split else self._flush([])
        if timeout is not None and timeout <= 0:
            timeout = None
        weight = (sum(self._weigher(i) for i in items)
                  if self._weigher is not None else len(items))
        # stamp the principal HERE, on the submitting RPC thread, where
        # the dispatch still holds it (only when billing is on)
        billing = self.usage_hook is not None
        ticket = _Ticket(len(items), weight,
                         principal=principals.current() if billing else None,
                         enq=time.perf_counter() if billing else 0.0)
        with self._lock:
            self._pending_items.extend(items)
            self._pending_tickets.append(ticket)
            self._pending_weight += weight
            self._arrived += weight
            i_flush = not self._active
            if i_flush:
                self._active = True
        if i_flush:
            self._drain()
        if not ticket.event.wait(timeout):
            with self._lock:
                if ticket in self._pending_tickets:
                    i = self._pending_tickets.index(ticket)
                    off = sum(t.count for t in self._pending_tickets[:i])
                    del self._pending_items[off:off + ticket.count]
                    self._pending_tickets.pop(i)
                    self._pending_weight -= ticket.weight
                    raise TimeoutError(
                        "microbatch flush did not start in time "
                        + ("(query withdrawn)" if self._split else
                           "(items withdrawn; model NOT updated)"))
            if not ticket.event.wait(timeout):
                raise TimeoutError(
                    "microbatch flush still running after grace period"
                    + ("" if self._split else
                       " — the update may still be applied; "
                       "do not blind-retry"))
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def _claim(self):
        """Pop the next batch (items + tickets + weight) under the lock;
        None when the queue is empty (caller releases flusher duty).
        Shared by the single-stage and pipelined drain loops."""
        if not self._pending_tickets:
            self._active = False
            return None
        batch: List[Any] = []
        tickets: List[_Ticket] = []
        batch_weight = 0
        while self._pending_tickets and \
                batch_weight + self._pending_tickets[0].weight \
                <= self._max_batch:
            t = self._pending_tickets.pop(0)
            tickets.append(t)
            batch_weight += t.weight
            batch.extend(self._pending_items[:t.count])
            del self._pending_items[:t.count]
        if not tickets:  # one oversized submit: flush it alone
            t = self._pending_tickets.pop(0)
            tickets.append(t)
            batch_weight += t.weight
            batch.extend(self._pending_items[:t.count])
            del self._pending_items[:t.count]
        self._pending_weight -= batch_weight
        if self.usage_hook is not None:
            now = time.perf_counter()
            for t in tickets:
                t.claimed = now
        return batch, tickets, batch_weight

    def _bill(self, tickets: List[_Ticket], batch_weight: int,
              device_dt: float) -> None:
        """Per-ticket usage billing at flush completion: queue residency
        (claim - enqueue) plus the flush's seconds shared by rows. Never
        raises: billing must not fail a flush that succeeded."""
        hook = self.usage_hook
        if hook is None:
            return
        for t in tickets:
            share = (device_dt * t.weight / batch_weight
                     if batch_weight else 0.0)
            queued = max(0.0, t.claimed - t.enq) if t.enq else 0.0
            try:
                hook(t.principal, t.weight, queued, share)
            except Exception:  # broad-ok — billing is best-effort
                pass

    def _note_flush_ms(self, dt_s: float) -> None:
        """Fold one flush's duration into the trailing EWMA (under the
        queue lock — stats() reads it there)."""
        ms = dt_s * 1e3
        with self._lock:
            self._flush_ms_ewma = ms if self._flush_ms_ewma == 0.0 else \
                FLUSH_EWMA_ALPHA * ms \
                + (1.0 - FLUSH_EWMA_ALPHA) * self._flush_ms_ewma

    def set_max_batch(self, depth: int) -> int:
        """Retarget the per-flush example bound (the coalescer tuner's
        actuation point). Clamped to >= 1 — a zero depth would wedge every
        submit. Taken under the queue lock that ``_claim`` holds, so a
        batch already claimed (and, in the pipelined coalescer, already
        featurized) keeps the bound it was claimed with; the next claim
        sees the new one. Returns the applied value."""
        depth = max(1, int(depth))
        with self._lock:
            self._max_batch = depth
        return depth

    @property
    def max_batch(self) -> int:
        return self._max_batch

    def _drain(self) -> None:
        while True:
            with self._lock:
                claimed = self._claim()
                if claimed is None:
                    return
                batch, tickets, batch_weight = claimed
            t0 = time.perf_counter()
            try:
                result = self._flush(batch)
                if self._split:
                    if len(result) != len(batch):
                        raise RuntimeError(
                            f"split flush returned {len(result)} results "
                            f"for {len(batch)} items")
                    off = 0
                    for t in tickets:
                        t.result = result[off:off + t.count]
                        off += t.count
                else:
                    for t in tickets:
                        t.result = result
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                for t in tickets:
                    t.error = e
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.flush_count += 1
                    self.item_count += batch_weight  # examples, not items
                self._note_flush_ms(dt)
                # single-stage flush: the whole flush is the device step
                self._bill(tickets, batch_weight, dt)
                for t in tickets:
                    t.event.set()

    def queue_depth(self) -> int:
        """Examples queued behind the current flush (0 when idle): the
        backpressure signal."""
        with self._lock:
            return self._pending_weight

    def arrival_per_sec(self) -> float:
        """Trailing arrival rate (examples/s) since the last reference
        point; the reference re-anchors every ~10 s, so callers polling
        on the telemetry tick read a short-window rate, not a lifetime
        mean."""
        now = time.monotonic()
        with self._lock:
            ref_t, ref_c = self._arrival_ref
            dt = now - ref_t
            rate = (self._arrived - ref_c) / dt if dt > 0 else 0.0
            if dt >= 10.0:
                self._arrival_ref = (now, self._arrived)
        return rate

    def stats(self) -> dict:
        rate = self.arrival_per_sec()
        with self._lock:
            flushes, items = self.flush_count, self.item_count
            depth = self._pending_weight
            flush_ms = self._flush_ms_ewma
            max_batch = self._max_batch
        return {
            "flush_count": flushes,
            "item_count": items,
            "avg_batch": (items / flushes if flushes else 0.0),
            "queue_depth": depth,
            "arrival_per_sec": round(rate, 1),
            "flush_ms_ewma": round(flush_ms, 3),
            "max_batch": max_batch,
        }


class PipelinedCoalescer(Coalescer):
    """Two-stage coalescer: host featurization overlapped with the device
    step (the feature pipeline's host/device overlap).

    ``prep_fn(items) -> prepared`` is stage 1 (host: decode + batch
    featurize); ``flush_fn(prepared)`` is stage 2 (device: upload +
    kernel). The flusher thread preps batch N+1 while a dedicated device
    worker consumes batch N — double-buffered (at most ONE prepared
    batch waits, so prep can never run unboundedly ahead of the model
    it trains against), with Coalescer's ticket/error semantics: a
    stage-1 error fails exactly that batch's tickets immediately, a
    stage-2 error fails them when the device stage completes.

    Span stamping: when ``trace`` (a tracing Registry) is given, stage 1
    records ``fv.convert`` and stage 2 ``fv.upload`` — the featurize vs
    device split in get_status and the span store.

    Overlap accounting: ``stats()`` adds prep/device seconds and
    ``overlap_fraction`` — the share of host featurize time that ran
    while the device stage was busy (time the pipeline hid)."""

    def __init__(self, prep_fn: Callable[[List[Any]], Any],
                 flush_fn: Callable[[Any], Any],
                 max_batch: int = 8192,
                 weigher: Callable[[Any], int] | None = None,
                 trace: Any = None) -> None:
        super().__init__(flush_fn, max_batch=max_batch, weigher=weigher)
        self._prep = prep_fn
        self._trace = trace
        self._dev_lock = threading.Lock()
        self._dev_ready = threading.Condition(self._dev_lock)
        self._dev_queue: List[tuple] = []      # at most 1 prepared batch
        self._dev_slot = threading.Semaphore(1)
        self._dev_thread: threading.Thread | None = None
        self._busy_lock = threading.Lock()
        self._dev_busy_total = 0.0
        self._dev_busy_since: float | None = None
        self.prep_seconds = 0.0
        self.device_seconds = 0.0
        self.overlap_seconds = 0.0

    # -- overlap accounting --------------------------------------------------
    def _device_busy_seconds(self) -> float:
        with self._busy_lock:
            t = self._dev_busy_total
            if self._dev_busy_since is not None:
                t += time.perf_counter() - self._dev_busy_since
            return t

    def _finish(self, tickets: List[_Ticket], batch_weight: int,
                device_dt: float = 0.0) -> None:
        with self._lock:
            self.flush_count += 1
            self.item_count += batch_weight
        self._bill(tickets, batch_weight, device_dt)
        for t in tickets:
            t.event.set()

    def _ensure_worker(self) -> None:
        if self._dev_thread is None or not self._dev_thread.is_alive():
            self._dev_thread = threading.Thread(
                target=self._device_loop, daemon=True,
                name="microbatch-device")
            self._dev_thread.start()

    def _device_loop(self) -> None:
        while True:
            with self._dev_lock:
                while not self._dev_queue:
                    self._dev_ready.wait()
                prepared, tickets, batch_weight = self._dev_queue.pop(0)
            with self._busy_lock:
                self._dev_busy_since = time.perf_counter()
            try:
                if self._trace is not None:
                    with self._trace.span("fv.upload"):
                        result = self._flush(prepared)
                else:
                    result = self._flush(prepared)
                for t in tickets:
                    t.result = result
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                for t in tickets:
                    t.error = e
            finally:
                with self._busy_lock:
                    now = time.perf_counter()
                    dt = now - self._dev_busy_since
                    self._dev_busy_total += dt
                    self.device_seconds += dt
                    self._dev_busy_since = None
                # the device stage IS the drain rate here — the prep
                # stage overlaps it, so only stage 2 bounds throughput
                self._note_flush_ms(dt)
                self._finish(tickets, batch_weight, device_dt=dt)
                self._dev_slot.release()

    def _drain(self) -> None:
        while True:
            with self._lock:
                claimed = self._claim()
                if claimed is None:
                    return
                batch, tickets, batch_weight = claimed
            # stage 1 in THIS thread: overlaps whatever batch the device
            # worker is currently consuming
            t0 = time.perf_counter()
            d0 = self._device_busy_seconds()
            err: BaseException | None = None
            prepared = None
            try:
                if self._trace is not None:
                    with self._trace.span("fv.convert"):
                        prepared = self._prep(batch)
                else:
                    prepared = self._prep(batch)
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                err = e
            d1 = self._device_busy_seconds()
            dt = time.perf_counter() - t0
            with self._busy_lock:
                self.prep_seconds += dt
                self.overlap_seconds += min(dt, max(d1 - d0, 0.0))
            if err is not None:
                for t in tickets:
                    t.error = err
                self._finish(tickets, batch_weight)
                continue
            # stage 2 handoff: block only when BOTH buffers are full
            # (one in flight on the device + one prepared)
            self._dev_slot.acquire()
            self._ensure_worker()
            with self._dev_lock:
                self._dev_queue.append((prepared, tickets, batch_weight))
                self._dev_ready.notify()

    def stats(self) -> dict:
        out = super().stats()
        with self._busy_lock:
            prep = self.prep_seconds
            dev = self.device_seconds
            ov = self.overlap_seconds
        out.update(
            prep_seconds=round(prep, 6),
            device_seconds=round(dev, 6),
            overlap_seconds=round(ov, 6),
            overlap_fraction=round(ov / prep, 4) if prep > 0 else 0.0,
        )
        return out
