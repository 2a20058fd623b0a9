"""Background JSONL writer: the rollout log's file I/O off the collect path
(the port's copy of :mod:`trlx_tpu.utils.async_writer`).

:class:`BackgroundJSONLWriter` writes from one daemon thread behind a
bounded queue:

- ``submit(path, rows)`` serialises one batch on the caller and enqueues
  it; it blocks only when the queue is full;
- ``flush()`` waits until everything enqueued has reached the file and
  re-raises the first permanent error of the thread; the orchestrator
  flushes at each phase's end, and with ``reraise=False`` from its
  exception path, so queued rows reach the disk even when collection
  raises;
- ``close()`` drains, stops the thread, then raises what is pending.

Failures follow the :mod:`~trlx_tpu_torch.utils.retry` taxonomy.
Permanent ones (a missing directory) surface at the next flush or
submit. Transient ones (a full disk, a flaky NFS) keep their batches in
an ordered retry buffer, written again before every later write; after
``degrade_after`` consecutive transient failures the writer degrades to
writing synchronously in the caller, with one warning. If the filesystem
recovers, every buffered batch lands in order; rows still unwritable at
``close()`` are a hard error. The append carries the ``writer.write``
fault-injection site (:mod:`~trlx_tpu_torch.resilience.chaos`).
"""

from __future__ import annotations

import json
import queue
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch.resilience import chaos
from trlx_tpu_torch.utils.retry import classify_io_error

#: buffered batches at most: past this, unwritable rows are a hard error
_RETRY_CAP = 256


class BackgroundJSONLWriter:
    """Appends batches of JSON lines to files from a background thread."""

    def __init__(self, maxsize: int = 64, degrade_after: int = 3):
        self._q: "queue.Queue[Optional[Tuple[str, List[str]]]]" = queue.Queue(maxsize)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._closed = False
        self.degrade_after = int(degrade_after)
        self._consecutive_failures = 0
        self._degraded = False
        self._warned_degrade = False
        # (path, lines) batches that failed transiently, in arrival order,
        # written again before any later batch
        self._retry: List[Tuple[str, List[str]]] = []

    def submit(self, path: str, rows: Sequence[Dict[str, Any]]) -> None:
        """Enqueue ``rows`` for appending to ``path``, one JSON object a
        line; a row that does not serialise fails here, on the caller."""
        if self._closed:
            raise RuntimeError("writer is closed")
        self._raise_pending()
        lines = [json.dumps(r) for r in rows]
        # a latch that only goes False -> True: a stale False enqueues one
        # more batch, which the thread still writes in order
        if self._degraded:
            self._join_queue()
            self._write_buffered(then=(path, lines))
            return
        self._ensure_thread()
        self._q.put((path, lines))

    @property
    def degraded(self) -> bool:
        """Whether the writer fell back to synchronous writes."""
        return self._degraded

    def flush(self, reraise: bool = True) -> None:
        """Wait until every submitted batch is written; raise the first
        permanent error of the thread (not with ``reraise=False``, for an
        exception path). Transiently failed batches get one more attempt
        here and stay buffered if it fails; they are a hard error only at
        :meth:`close`."""
        self._join_queue()
        self._write_buffered()
        if reraise:
            self._raise_pending()

    def close(self, reraise: bool = True) -> None:
        """Drain, stop the thread, then raise what is pending (also an
        error an earlier ``flush(reraise=False)`` held back)."""
        self.flush(reraise=False)
        self._closed = True
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        self._write_buffered()  # the buffered rows' last chance
        if reraise:
            self._raise_pending()
            if self._retry:
                n = sum(len(lines) for _, lines in self._retry)
                raise RuntimeError(
                    f"background rollout writer failed; {n} row(s) could not be written "
                    "(transient write failures never recovered)"
                )

    @property
    def pending(self) -> int:
        return self._q.unfinished_tasks

    # ------------------------------------------------------------------ #

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="rollout-jsonl-writer", daemon=True
                )
                self._thread.start()

    def _join_queue(self) -> None:
        if self._thread is not None:
            self._q.join()

    def _raise_pending(self) -> None:
        # the thread sets _error; take it under the lock so it is raised
        # exactly once
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "background rollout writer failed; rows after the failure may be missing"
            ) from err

    def _append(self, path: str, lines: List[str]) -> None:
        chaos.check("writer.write")
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")

    def _on_write_failure(self, batch: Tuple[str, List[str]], error: BaseException) -> None:
        """A failed batch: transient -> buffered (and maybe degrade);
        permanent -> pending. The caller holds ``_lock``."""
        if (isinstance(error, Exception) and classify_io_error(error) == "transient"
                and len(self._retry) < _RETRY_CAP):
            self._retry.append(batch)
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.degrade_after and not self._degraded:
                self._degraded = True
                if not self._warned_degrade:
                    self._warned_degrade = True
                    print(
                        "resilience: background rollout writer hit "
                        f"{self._consecutive_failures} consecutive transient write failures "
                        f"({type(error).__name__}: {error}) — degrading to synchronous "
                        "writes; buffered rows retry before each write",
                        file=sys.stderr,
                    )
            return
        if self._error is None:
            self._error = error

    def _write_buffered(self, then: Optional[Tuple[str, List[str]]] = None) -> None:
        """Write the buffered batches in order, then ``then``; the first
        failure buffers the rest again, still in order."""
        with self._lock:
            work = self._retry
            self._retry = []
            if then is not None:
                work.append(then)
            for i, batch in enumerate(work):
                try:
                    self._append(*batch)
                    self._consecutive_failures = 0
                except BaseException as e:
                    self._on_write_failure(batch, e)
                    self._retry.extend(work[i + 1:])
                    return

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                with self._lock:
                    pending = self._error is not None
                if not pending:
                    self._write_buffered(then=item)
            except BaseException as e:  # raised at the next flush or submit
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._q.task_done()
