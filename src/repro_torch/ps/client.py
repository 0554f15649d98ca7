"""Async PS client — overlap pull/push with compute (HeterPS §3; port of
``repro.ps.client``).

The paper's workers hide the worker↔PS network hop behind compute: while
step *i* computes, the rows batch *i+1* needs are already being pulled
and the gradients of step *i−1* are being pushed.  :class:`PSClient`
implements that as a double-buffered iterator over a batch stream
(typically a :class:`~repro_torch.data.pipeline.PrefetchLoader`):

* a **puller** thread walks the stream, pulls each batch's rows from the
  :class:`~repro_torch.ps.sharding.ShardedTable`, and stages
  ``(batch, rows)`` pairs in a bounded queue (``depth`` = number of
  in-flight pulls);
* a **pusher** thread drains a push queue of ``(ids, grads)`` and applies
  them to the table;
* the main thread iterates ``(batch, rows)`` and calls :meth:`push` —
  both calls are non-blocking in steady state, so step time approaches
  ``max(compute, pull, push)`` instead of their sum.

On a CUDA table the puller and the pusher each run on a CUDA stream of
their own, so their device work (the pull's hot-cache merge, the push's
write-through) and their waits never serialize with the tower on the
main thread's stream.  Rows cross from the puller's stream to the
consumer's, and gradients from the caller's stream to the pusher's, with
an event: the receiving stream waits for it, and the tensor is recorded
on that stream so its memory is not reused while it is read.

Consistency: updates are applied in push order, but a pull staged while
pushes are in flight may read pre-push rows — bounded staleness of at
most ``depth`` steps, the standard async-PS trade (HeterPS trains CTR
models asynchronously for exactly this reason).  The hot cache is
replaced, never written in place, so readers never see torn rows.
Shutdown follows ``PrefetchLoader``'s contract: timed puts + a sentinel,
so neither side can hang.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import torch

from repro_torch import obs
from repro_torch.obs import trace as obs_trace

#: stream-end marker (same pattern as data.pipeline's sentinel)
_STOP = object()


def _side_stream(table):
    """A CUDA stream of its own for a client thread of a CUDA table, else
    ``None`` (a CPU table, or a stand-in without a device)."""
    dev = getattr(table, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    return torch.cuda.Stream(torch.device(dev))


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _ready_event(stream):
    """An event recorded on ``stream`` now (``None`` without a stream)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _receive(t, ev, stream) -> None:
    """Make ``stream`` wait for ``ev`` before it reads tensor ``t``, and
    keep ``t``'s memory from reuse until ``stream`` is done with it."""
    if ev is None:
        return
    stream.wait_event(ev)
    t.record_stream(stream)


class PSClient:
    """Double-buffered async pull/push over a :class:`ShardedTable`.

    Iterating yields ``(batch, rows)`` where ``rows = table.pull(
    batch[ids_key])`` was issued one step ahead; :meth:`push` enqueues a
    gradient push applied in the background.  Call :meth:`close` when
    done (drains queued pushes by default).
    """

    def __init__(self, table, loader, *, ids_key: str = "ids",
                 depth: int = 2, put_timeout: float = 0.05):
        self.table = table
        self._ids_key = ids_key
        self._put_timeout = put_timeout
        self._pull_q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._push_q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._closed = False
        self._lock = threading.Lock()
        self.steps_pulled = 0
        self.steps_pushed = 0
        self._pushes_enqueued = 0
        self._pushes_dropped = 0
        self._pusher_error: BaseException | None = None
        self._puller_error: BaseException | None = None
        self._pull_stream = _side_stream(table)
        self._push_stream = _side_stream(table)

        def puller():
            try:
                for batch in loader:
                    ids = batch[self._ids_key]
                    with obs_trace.span("ps.client.pull", "ps",
                                        step=self.steps_pulled), \
                            _on(self._pull_stream):
                        rows = self.table.pull(ids)
                        ready = _ready_event(self._pull_stream)
                    with self._lock:
                        self.steps_pulled += 1
                    placed = False
                    while not self._stop.is_set():
                        try:
                            self._pull_q.put((batch, rows, ready),
                                             timeout=self._put_timeout)
                            placed = True
                            break
                        except queue.Full:
                            continue
                    if not placed:
                        return  # close() requested while queue stayed full
            except BaseException as e:  # surfaced by __next__ at stream end
                self._puller_error = e
            finally:
                # always terminate the stream; make room by dropping staged
                # pulls once close() was requested (the consumer is gone)
                wait = self._put_timeout
                while True:
                    try:
                        self._pull_q.put(_STOP, timeout=wait)
                        return
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self._pull_q.get_nowait()
                            except queue.Empty:
                                pass
                        else:
                            wait = min(wait * 2, 1.0)

        def pusher():
            while True:
                item = self._push_q.get()
                if item is _STOP:
                    return
                ids, grads, lr, dedup, ready = item
                try:
                    with obs_trace.span("ps.client.push_apply", "ps",
                                        step=self.steps_pushed), \
                            _on(self._push_stream):
                        _receive(grads, ready, self._push_stream)
                        self.table.push(ids, grads, lr=lr, dedup=dedup)
                except BaseException as e:  # surface in flush()/close()
                    self._pusher_error = e
                    return
                with self._lock:
                    self.steps_pushed += 1

        self._puller = threading.Thread(target=puller, daemon=True)
        self._pusher = threading.Thread(target=pusher, daemon=True)
        self._puller.start()
        self._pusher.start()

    # --- pull side -------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._pull_q.get()
        if item is _STOP:
            self._done = True
            if self._puller_error is not None:
                # a pull failed mid-stream — surface it rather than letting
                # training end early looking like a clean (short) run
                raise RuntimeError("PS pull failed") from self._puller_error
            raise StopIteration
        batch, rows, ready = item
        if ready is not None:
            _receive(rows, ready, torch.cuda.current_stream(rows.device))
        return batch, rows

    # --- push side -------------------------------------------------------
    def push(self, ids, row_grads, *, lr: float, dedup: bool = True) -> None:
        """Queue an async push of ``-lr * row_grads`` at ``ids``.  A CUDA
        ``row_grads`` may still be in the making on the caller's stream:
        the pusher's stream waits for it."""
        if self._closed:
            raise RuntimeError("push() after close()")
        self._raise_pusher_error()
        ready = None
        if (self._push_stream is not None
                and isinstance(row_grads, torch.Tensor) and row_grads.is_cuda):
            ready = _ready_event(torch.cuda.current_stream(row_grads.device))
        self._push_q.put((ids, row_grads, lr, dedup, ready))
        with self._lock:
            self._pushes_enqueued += 1

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every queued push has been applied to the table.

        A pusher thread that already died (push raised, or it consumed
        the stop sentinel with work still queued) can never drain the
        queue — detected immediately and raised with the pending-push
        count, instead of spinning out the full ``timeout``.
        """
        deadline = time.monotonic() + timeout
        while True:
            self._raise_pusher_error()
            with self._lock:
                pending = self._pushes_enqueued - self.steps_pushed
                if pending <= 0:
                    return
            if not self._pusher.is_alive():
                # re-raise any error that landed between the check above
                # and the thread's exit, then fail fast — nothing will
                # ever apply these pushes
                self._raise_pusher_error()
                raise RuntimeError(
                    f"pusher thread exited with {pending} push(es) pending")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"PS push queue did not drain: {pending} push(es) "
                    f"pending after {timeout}s")
            time.sleep(0.001)

    def _raise_pusher_error(self):
        if self._pusher_error is not None:
            raise RuntimeError("PS push failed") from self._pusher_error

    # --- lifecycle ---------------------------------------------------------
    def close(self, *, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop both threads; with ``drain`` (default) queued pushes are
        applied first so the table reflects every ``push()`` call.

        Idempotent and deterministic even when the drain fails: a second
        ``close()`` is a no-op, and the failure paths (drain timeout /
        pusher thread died) re-raise with the number of dropped pushes —
        also recorded as ``pushes_dropped`` in :meth:`stats`, so the
        counters stay consistent (``pushed + dropped == enqueued``)."""
        if self._closed:
            return
        self._closed = True
        drain_error: BaseException | None = None
        sp = obs_trace.span(
            "ps.client.drain", "ps",
            pending=max(0, self._pushes_enqueued - self.steps_pushed))
        with sp:
            try:
                if drain and self._pusher_error is None:
                    self.flush(timeout=timeout)
            except (TimeoutError, RuntimeError) as e:
                drain_error = e
            finally:
                # even if the drain raised, stop both threads — a failed
                # close must not leave the puller/pusher running against
                # the table
                self._stop.set()
                # wake the pusher; drop a stale (unapplied) push to make
                # room if the queue is full
                while True:
                    try:
                        self._push_q.put(_STOP, timeout=self._put_timeout)
                        break
                    except queue.Full:
                        try:
                            self._push_q.get_nowait()
                        except queue.Empty:
                            pass
                self._puller.join(timeout)
                self._pusher.join(timeout)
            with self._lock:
                self._pushes_dropped = max(
                    0, self._pushes_enqueued - self.steps_pushed)
                dropped = self._pushes_dropped
            sp.args["dropped"] = dropped
        self._final_telemetry(dropped)
        # a pusher failure means queued gradients were dropped — surface it
        # even when the training loop already issued its last push()
        if self._pusher_error is not None:
            raise RuntimeError(
                f"PS push failed: {dropped} push(es) dropped"
            ) from self._pusher_error
        if drain_error is not None:
            if isinstance(drain_error, TimeoutError):
                raise TimeoutError(
                    f"PS push queue did not drain: {dropped} push(es) "
                    f"dropped") from drain_error
            raise RuntimeError(
                f"pusher thread exited with pushes pending: {dropped} "
                f"push(es) dropped") from drain_error

    def _final_telemetry(self, dropped: int) -> None:
        """Session-registry counters + final metrics snapshot at close —
        no-ops when obs is disabled / no run dir is configured."""
        reg = obs.REGISTRY
        reg.counter("ps.client.steps_pulled").inc(self.steps_pulled)
        reg.counter("ps.client.steps_pushed").inc(self.steps_pushed)
        reg.counter("ps.client.pushes_dropped").inc(dropped)
        obs.flush()

    def stats(self) -> dict:
        with self._lock:
            return {"steps_pulled": self.steps_pulled,
                    "steps_pushed": self.steps_pushed,
                    "pushes_enqueued": self._pushes_enqueued,
                    "pushes_dropped": self._pushes_dropped}
