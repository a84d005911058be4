"""The port's microbatch coalescer (jubatus_tpu_torch/server/microbatch.py):
the cases of tests/test_microbatch.py that need no plane the port leaves
out (the JAX server, tracing spans, usage billing), on the port's copy.
The live-server merge is in tests/test_torch_server.py."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from jubatus_tpu_torch.server.microbatch import Coalescer, PipelinedCoalescer


def test_lone_submit_is_passthrough():
    seen = []
    co = Coalescer(lambda b: (seen.append(list(b)), len(b))[1])
    assert co.submit([1, 2, 3]) == 3
    assert seen == [[1, 2, 3]]
    assert co.stats()["flush_count"] == 1


def test_empty_submit():
    co = Coalescer(lambda b: len(b))
    assert co.submit([]) == 0
    assert co.stats()["flush_count"] == 0


def test_concurrent_submits_coalesce_and_conserve():
    flushed = []
    gate = threading.Event()

    def flush(batch):
        if not gate.is_set():   # first flush blocks so the rest pile up
            gate.set()
            time.sleep(0.15)
        flushed.append(list(batch))
        return len(batch)

    co = Coalescer(flush)
    results = []

    def worker(base):
        results.append(co.submit([base * 10 + j for j in range(3)]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
        time.sleep(0.005)
    for t in threads:
        t.join()

    all_items = [x for b in flushed for x in b]
    assert sorted(all_items) == sorted(i * 10 + j
                                       for i in range(12) for j in range(3))
    assert len(all_items) == 36
    # piling up must have produced real coalescing
    assert len(flushed) < 12
    assert co.stats()["item_count"] == 36
    assert max(len(b) for b in flushed) > 3


def test_max_batch_splits():
    sizes = []
    gate = threading.Event()

    def slow_first(batch):
        if not gate.is_set():
            gate.set()
            time.sleep(0.1)
        sizes.append(len(batch))

    co = Coalescer(slow_first, max_batch=5)
    threads = [threading.Thread(target=co.submit, args=([j, j, j],))
               for j in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.005)
    for t in threads:
        t.join()
    assert sum(sizes) == 18
    assert all(s <= 5 or s == 3 for s in sizes)  # ≤ max, except lone-first


def test_oversized_single_submit_flushes_alone():
    sizes = []
    co = Coalescer(lambda b: sizes.append(len(b)), max_batch=4)
    co.submit(list(range(10)))
    assert sizes == [10]


def test_error_propagates_to_contributors_only():
    def flush(batch):
        if "bad" in batch:
            raise RuntimeError("poison")
        return len(batch)

    co = Coalescer(flush)
    with pytest.raises(RuntimeError, match="poison"):
        co.submit(["bad"])
    assert co.submit(["ok"]) == 1  # queue recovers after a failed flush


def test_timeout_withdraws_queued_items():
    """A timed-out submit whose items are still queued withdraws them —
    TimeoutError then guarantees the model was NOT updated."""
    gate = threading.Event()
    release = threading.Event()

    def flush(batch):
        gate.set()
        release.wait(5)
        return len(batch)

    co = Coalescer(flush)
    t = threading.Thread(target=co.submit, args=([1],))
    t.start()
    assert gate.wait(2)
    with pytest.raises(TimeoutError, match="NOT updated"):
        co.submit([2], timeout=0.1)
    release.set()
    t.join()
    assert co.stats()["item_count"] == 1  # withdrawn item never flushed


def test_zero_timeout_means_wait_forever():
    co = Coalescer(lambda b: len(b))
    assert co.submit([1, 2], timeout=0) == 2


def test_split_results_each_ticket_gets_its_slice():
    """Query-plane mode: the flush returns per-item results and every
    submitter receives exactly its own rows, under real concurrency."""

    def flush(items):
        return [f"r{x}" for x in items]

    co = Coalescer(flush, max_batch=64, split_results=True)
    out = {}
    barrier = threading.Barrier(8)

    def worker(k):
        barrier.wait()
        out[k] = co.submit([k * 10 + j for j in range(3)])

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for k in range(8):
        assert out[k] == [f"r{k * 10 + j}" for j in range(3)], out[k]


def test_split_results_wrong_length_surfaces_error():

    co = Coalescer(lambda items: ["only-one"], max_batch=8,
                   split_results=True)
    with pytest.raises(RuntimeError, match="split flush returned"):
        co.submit(["a", "b"])


def test_pipelined_basic_result_delivery():

    preps, flushes = [], []

    def prep(items):
        preps.append(list(items))
        return [x * 2 for x in items]

    def flush(prepared):
        flushes.append(list(prepared))
        return sum(prepared)

    co = PipelinedCoalescer(prep, flush, max_batch=64)
    assert co.submit([1, 2, 3]) == 12
    assert preps == [[1, 2, 3]] and flushes == [[2, 4, 6]]
    st = co.stats()
    assert st["flush_count"] == 1 and st["item_count"] == 3
    assert "overlap_fraction" in st


def test_pipelined_overlaps_prep_with_device():
    """While the device worker sleeps on batch N, the flusher must prep
    batch N+1 — overlap_seconds > 0 proves the stages really ran
    concurrently."""

    order = []

    def prep(items):
        order.append(("prep", tuple(items)))
        time.sleep(0.05)
        return items

    def flush(prepared):
        order.append(("flush", tuple(prepared)))
        time.sleep(0.1)
        return len(prepared)

    co = PipelinedCoalescer(prep, flush, max_batch=4)
    results = []
    threads = [threading.Thread(
        target=lambda i=i: results.append(co.submit([i])))
        for i in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.01)
    for t in threads:
        t.join()
    assert len(results) == 6
    st = co.stats()
    assert st["item_count"] == 6
    assert st["device_seconds"] > 0
    assert st["overlap_seconds"] > 0  # prep ran under an active flush
    assert 0 < st["overlap_fraction"] <= 1.0


def test_pipelined_prep_error_fails_only_that_batch():

    def prep(items):
        if any(x < 0 for x in items):
            raise ValueError("bad featurize")
        return items

    co = PipelinedCoalescer(prep, lambda p: len(p), max_batch=64)
    with pytest.raises(ValueError, match="bad featurize"):
        co.submit([-1])
    assert co.submit([1, 2]) == 2  # queue recovered
    assert co.stats()["flush_count"] == 2


def test_pipelined_device_error_propagates():

    def flush(prepared):
        raise RuntimeError("device on fire")

    co = PipelinedCoalescer(lambda i: i, flush, max_batch=64)
    with pytest.raises(RuntimeError, match="device on fire"):
        co.submit([1])
    # a later submit still works end to end after the error
    co2_calls = []
    co._flush = lambda p: (co2_calls.append(p), len(p))[1]
    assert co.submit([5, 6]) == 2


def test_pipelined_weigher_bounds_examples():
    """max_batch counts examples via the weigher, exactly like the
    single-stage coalescer."""

    sizes = []

    def prep(items):
        return items

    def flush(prepared):
        sizes.append(sum(a.shape[0] for a in prepared))
        return sizes[-1]

    gate = threading.Event()

    def slow_first_flush(prepared):
        if not gate.is_set():
            gate.set()
            time.sleep(0.1)
        return flush(prepared)

    co = PipelinedCoalescer(prep, slow_first_flush, max_batch=8,
                            weigher=lambda a: a.shape[0])
    threads = [threading.Thread(
        target=lambda: co.submit([np.zeros((4, 2))]))
        for _ in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.005)
    for t in threads:
        t.join()
    assert sum(sizes) == 24
    assert all(s <= 8 for s in sizes)


def test_queue_depth_and_arrival_rate_in_stats():
    release = threading.Event()
    started = threading.Event()

    def blocking_flush(batch):
        started.set()
        release.wait(5.0)
        return len(batch)

    co = Coalescer(blocking_flush, max_batch=4)
    t1 = threading.Thread(target=lambda: co.submit([1, 2]))
    t1.start()
    assert started.wait(5.0)
    # the flusher claimed its own items: queue is empty while it runs
    assert co.queue_depth() == 0
    t2 = threading.Thread(target=lambda: co.submit([3, 4, 5]))
    t2.start()
    deadline = time.monotonic() + 5.0
    while co.queue_depth() != 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    st = co.stats()
    assert st["queue_depth"] == 3          # queued behind the flush
    assert st["arrival_per_sec"] > 0.0     # 5 examples just arrived
    release.set()
    t1.join()
    t2.join()
    st = co.stats()
    assert st["queue_depth"] == 0          # drained back to idle
    assert co.queue_depth() == 0


def test_queue_depth_uses_weigher_examples():
    release = threading.Event()
    started = threading.Event()

    def blocking_flush(batch):
        started.set()
        release.wait(5.0)
        return len(batch)

    co = Coalescer(blocking_flush, max_batch=100,
                   weigher=lambda item: item["n"])
    t1 = threading.Thread(target=lambda: co.submit([{"n": 10}]))
    t1.start()
    assert started.wait(5.0)
    t2 = threading.Thread(target=lambda: co.submit([{"n": 7}, {"n": 5}]))
    t2.start()
    deadline = time.monotonic() + 5.0
    while co.queue_depth() != 12 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert co.queue_depth() == 12          # examples, not items
    release.set()
    t1.join()
    t2.join()


def test_timeout_withdrawal_returns_queue_depth():
    release = threading.Event()
    started = threading.Event()

    def blocking_flush(batch):
        started.set()
        release.wait(5.0)
        return len(batch)

    co = Coalescer(blocking_flush, max_batch=2)
    t1 = threading.Thread(target=lambda: co.submit([1, 2]))
    t1.start()
    assert started.wait(5.0)
    with pytest.raises(TimeoutError):
        co.submit([3, 4], timeout=0.05)
    assert co.queue_depth() == 0           # withdrawn items left no ghost
    release.set()
    t1.join()
