"""Streaming token output: per-request bounded queues + iterators.

The port's copy of :mod:`trlx_tpu.serving.streaming` (the schedule-point
hooks of the JAX package's race auditor are left out).

The engine's decode step hands each step's live tokens to its
``token_sink``; :class:`StreamRouter` fans them out into per-request
:class:`TokenStream` queues the moment they exist — time-to-first-token
decouples from harvest-group completion (the ``serve/ttft_ms``
histogram measures the difference; docs/serving.md "Streaming").

Host-concurrency contract: the single-process serving loop interleaves producer and consumer on one
thread, but a loop-thread + consumer-thread deployment is supported —
so every buffer/flag touch happens under ``TokenStream._lock``. The
close-vs-push handoff is the canonical ``atomicity-split``: ``push``
decides closed-ness and buffers IN ONE critical section (a push racing a
close either lands before it or is dropped and counted, never torn), and
``__next__`` checks buffer-empty and closed under the same lock, so a
token pushed before ``close()`` can never be swallowed by a
``StopIteration``. A full queue drops the OLDEST buffered token and
counts the overflow (``overflows``), never blocks the decode loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional

from trlx_tpu_torch.utils import monotonic


class TokenStream:
    """Bounded per-request token queue with iterator access.

    ``__next__`` returns buffered tokens first; on an empty buffer it
    calls the ``pump`` callable (one serving-loop iteration) until a
    token lands or the stream closes. Closed + drained ⇒
    ``StopIteration``.
    """

    def __init__(
        self,
        request_id: int,
        maxlen: int = 1024,
        pump: Optional[Callable[[], object]] = None,
    ):
        self.request_id = request_id
        self._buf: "deque[int]" = deque(maxlen=max(1, int(maxlen)))
        self._pump = pump
        # guards every shared field below: producer (push/close from the
        # serving loop) and consumer (__next__/drain) may live
        # on different threads
        self._lock = threading.Lock()
        self.closed = False
        self.overflows = 0  # tokens dropped oldest-first on a full queue
        self.dropped_after_close = 0  # pushes that lost the race to close
        self.emitted = 0
        # stream-delivery trace marks (telemetry/request_trace.py): when
        # the first token reached this queue and when the stream closed
        # — the `serve/stream` span of the request's trace
        self.first_push_at: Optional[float] = None
        self.closed_at: Optional[float] = None

    def push(self, token: int) -> bool:
        """Buffer one token; returns False (token dropped + counted) when
        the stream already closed — closed-ness is decided under the same
        lock as the buffering, so a racing close never tears the pair."""
        with self._lock:
            if self.closed:
                self.dropped_after_close += 1
                return False
            if len(self._buf) == self._buf.maxlen:
                self.overflows += 1
            self._buf.append(int(token))
            self.emitted += 1
            if self.first_push_at is None:
                self.first_push_at = monotonic()
            return True

    def close(self) -> None:
        with self._lock:
            if not self.closed:
                self.closed_at = monotonic()
            self.closed = True

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        while True:
            with self._lock:
                if self._buf:
                    return self._buf.popleft()
                # empty AND closed observed atomically: any token pushed
                # before the close is in the buffer (push holds the same
                # lock), so stopping here cannot lose one
                if self.closed:
                    raise StopIteration
            if self._pump is None:
                raise StopIteration
            if not self._pump():
                # no progress (e.g. this request is quota-throttled and
                # nothing is decoding): yield the CPU while the bucket
                # refills instead of busy-spinning the serving loop
                time.sleep(0.002)

    def drain(self) -> List[int]:
        """Everything currently buffered, without pumping."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out


class StreamRouter:
    """Row-index → :class:`TokenStream` fan-out; the engine's
    ``token_sink``.

    Single-thread contract: the routing table itself (``_streams``) is
    mutated only by the serving loop (attach/close/pop happen at submit
    and harvest, on the loop thread); cross-thread traffic goes through
    the per-stream lock inside :class:`TokenStream`.
    """

    def __init__(self, maxlen: int = 1024):
        self.maxlen = int(maxlen)
        self._streams: Dict[int, TokenStream] = {}

    def attach(self, row: int, stream: TokenStream) -> None:
        """Bind an already-open stream (created at request submit, before
        its engine row existed) to its row."""
        self._streams[row] = stream

    def get(self, row: int) -> Optional[TokenStream]:
        return self._streams.get(row)

    @property
    def active(self) -> int:
        return sum(
            1 for s in self._streams.values() if not s.closed
        )

    def on_tokens(self, emitted: Dict[int, int]) -> None:
        """Engine token-sink callback: ``{row: token}`` for this decode
        step's live emissions. Closed-ness is decided inside
        :meth:`TokenStream.push` (one critical section) — checking
        ``stream.closed`` here first would re-open the check-then-act
        window the per-stream lock exists to close."""
        for row, token in emitted.items():
            stream = self._streams.get(row)
            if stream is not None:
                stream.push(token)

    def close(self, row: int) -> None:
        stream = self._streams.get(row)
        if stream is not None:
            stream.close()

    def pop(self, row: int) -> Optional[TokenStream]:
        return self._streams.pop(row, None)
