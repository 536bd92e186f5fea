"""Continuous-batching serving front-end.

The reference's batch engine amortizes assignment/rotation/tables over a
query batch (nns_engine_batch, query_common.hpp:149-243) but is synchronous.
Here, a background worker drains a request queue into FIXED-SHAPE batches
(jit compiles once) with a small collection window — the standard continuous
batching pattern: latency-bounded, throughput amortized across callers.

The pipeline is double-buffered: a collector thread drains the request queue
and builds padded batches while an executor thread blocks on the device for
the previous batch, so host-side collection (python queue churn + padding
copies) never serializes with device execution. Peak QPS is then bounded by
max(collection, execution) instead of their sum.

Usage:
    server = SearchServer(index, r=100, ma=24, keep=0.00213, batch_size=128)
    future = server.submit(query_vector)        # thread-safe, any caller
    dists, labels = future.result()
    server.close()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from qadc_tpu.index import flat as flat_mod, ivf as ivf_mod
from qadc_tpu.index.flat import FlatIndex
from qadc_tpu.index.ivf import IVFIndex


class SearchServer:
    """Batched asynchronous search over one index."""

    def __init__(
        self,
        index,
        r: int = 100,
        ma: int = 1,
        keep: float = 0.01,
        adc_type: str = "qadc",
        batch_size: int = 128,
        max_wait_ms: float = 2.0,
        search_fn=None,
        max_consecutive_failures: int = 3,
    ):
        """search_fn: optional (index, batch) -> (dists, labels) override —
        e.g. a partial of dist.sharded_ivf.search_qadc_ivf_sharded to serve a
        partition-sharded index over a mesh; default routes to the local
        flat/ivf search for adc_type.

        A failed batch fails only its own callers' futures; the server keeps
        serving (transient device errors must not kill serving, SURVEY
        §5.3). Only max_consecutive_failures failures in a row — evidence of
        poisoned state, not a transient — close the server and drain the
        queue."""
        self.index = index
        self.r = r
        self.ma = ma
        self.keep = keep
        self.adc_type = adc_type
        self.batch_size = batch_size
        self._search_fn = search_fn
        # Fixed-shape BUCKETS (jit compiles once per bucket): a lone request
        # pads to shape 1 — engaging the direct low-latency IVF path
        # (index/ivf.py) — instead of paying the full batch's cost.
        self.batch_buckets = sorted({1, min(8, batch_size), batch_size})
        self.max_wait_s = max_wait_ms / 1e3
        self.is_ivf = isinstance(index, IVFIndex)
        if search_fn is None:
            if not self.is_ivf and not isinstance(index, FlatIndex):
                raise TypeError(f"unsupported index type {type(index)}")
            if adc_type == "qadc" and index.pq.sq_bits != 4:
                raise ValueError("Quick ADC requires sq_bits == 4")
        self.max_consecutive_failures = max_consecutive_failures
        self._fail_streak = 0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Guards the closed-check + enqueue in submit() against the worker's
        # fail-shutdown (set _closed, drain queue): without it a submit that
        # passed the check could enqueue after the drain and never resolve.
        self._lock = threading.Lock()
        self._batches = 0  # served batch count (for tests/metrics)
        # Double-buffer: collector stages at most one batch (maxsize=1)
        # while the executor blocks on the device for the previous one.
        # A deeper queue would only add latency without adding overlap.
        self._exec_q: queue.Queue = queue.Queue(maxsize=1)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._executor = threading.Thread(target=self._execute_loop, daemon=True)
        self._collector.start()
        self._executor.start()

    def _search(self, batch):
        if self._search_fn is not None:
            return self._search_fn(self.index, batch)
        if self.is_ivf:
            if self.adc_type == "qadc":
                return ivf_mod.search_qadc(
                    self.index, batch, r=self.r, ma=self.ma, keep=self.keep
                )
            return ivf_mod.search_adc(self.index, batch, r=self.r, ma=self.ma)
        if self.adc_type == "qadc":
            return flat_mod.search_qadc(self.index, batch, r=self.r, keep=self.keep)
        return flat_mod.search_adc(self.index, batch, r=self.r)

    def _collect_loop(self):
        """Drain the request queue into padded fixed-shape batches and stage
        them for the executor. Always terminates by forwarding the None
        sentinel to the executor — the executor's shutdown paths rely on it."""
        dim = self.index.pq.dim
        while True:
            item = self._q.get()
            if item is None:
                self._exec_q.put(None)
                return
            pending = [item]
            # Collect up to batch_size requests before an ABSOLUTE deadline
            # (a per-get timeout would let a slow trickle stretch the window
            # to batch_size * max_wait — breaking the latency bound).
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-signal shutdown after this batch
                    break
                pending.append(nxt)

            bsz = next(b for b in self.batch_buckets if b >= len(pending))
            batch = np.zeros((bsz, dim), np.float32)
            for i, (vec, _) in enumerate(pending):
                batch[i] = vec
            self._exec_q.put((pending, batch))

    def _execute_loop(self):
        while True:
            item = self._exec_q.get()
            if item is None:
                return
            pending, batch = item
            try:
                dists, labels = self._search(batch)
                dists, labels = np.asarray(dists), np.asarray(labels)
            except Exception as e:  # noqa: BLE001 — fail this batch's callers, not silently
                for _, fut in pending:
                    fut.set_exception(e)
                self._fail_streak += 1
                if self._fail_streak < self.max_consecutive_failures:
                    continue  # transient failure: keep serving
                # Poisoned state (N failures in a row): close, then drain.
                # _closed is flipped under the lock so any submit that raced
                # past its check has already enqueued and will be drained;
                # everything after fails fast.
                with self._lock:
                    self._closed = True
                # The collector may hold a collected-but-unstaged batch and
                # may be blocked on _q.get(). Wake it: it flushes its pending
                # batch into _exec_q, sees the sentinel, forwards it — so
                # draining _exec_q *until the sentinel* provably fails every
                # in-flight future.
                self._q.put(None)
                while True:
                    staged = self._exec_q.get()
                    if staged is None:
                        break
                    for _, fut in staged[0]:
                        fut.set_exception(e)
                # Collector has exited; nothing else reads _q. Fail whatever
                # was enqueued before _closed flipped.
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if nxt is not None:
                        nxt[1].set_exception(e)
            else:
                self._fail_streak = 0
                self._batches += 1
                for i, (_, fut) in enumerate(pending):
                    fut.set_result((dists[i], labels[i]))

    def submit(self, query) -> Future:
        """Queue one query vector; resolves to (dists (r,), labels (r,))."""
        query = np.asarray(query, np.float32).reshape(-1)
        if query.shape[0] != self.index.pq.dim:
            raise ValueError(f"query dim {query.shape[0]} != index dim {self.index.pq.dim}")
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server closed")
            self._q.put((query, fut))
        return fut

    def close(self):
        with self._lock:
            self._closed = True
        self._q.put(None)
        self._collector.join(timeout=30)
        self._executor.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
