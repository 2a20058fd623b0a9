"""Trainer checkpoints (the port's counterpart of
:mod:`trlx_tpu.utils.checkpoint`): one ``torch.save`` file per saved step,
``<checkpoint_dir>/<step>/state.pt``, committed by an atomic rename, with
``meta.json`` beside it holding the save's wall clock (``_saved_at``).

- **Retention**, as the JAX package's Orbax manager (``max_to_keep=2``):
  after a step commits, only the two highest steps stay; a step older
  than those goes only after the new one has committed, so a crash
  mid-write always leaves a restorable step.
- **A directory left by a longer run**: steps above the one being
  written belong to a stale timeline. All but the newest of them go
  before the write and that one after the commit, so resume never
  restores the old run and the directory never holds no checkpoint.
- **Load** joins writes in flight, then prefers the newest timeline: of
  several steps, the one with the latest ``_saved_at`` (a crash between a
  commit and the stale GC can leave a higher step of the old run). The
  file is memory-mapped (private, copy on write): its pages are the host
  copy the callers copy into their modules, so a restore holds no second
  copy of the state in host memory beside the file's cached pages.
- **Asynchronous writes** (``async_save=True``): :meth:`CheckpointWriter.save`
  snapshots every tensor of the state into host memory (page-locked for
  CUDA tensors, one buffer set per state layout, reused by the next save
  of that layout) on a side stream, waits for the copy, and returns; a
  thread then runs ``torch.save`` and the retention. The thread touches
  no CUDA. A new save joins the previous write first, so its buffers are
  free; :func:`wait_for_checkpoints` joins every writer's write in flight
  and re-raises its error, and runs at process exit.

- **Retry and fault injection**: each write attempt passes the
  ``checkpoint.save`` site (:mod:`~trlx_tpu_torch.resilience.chaos`) and
  each read ``checkpoint.load``; a transient failure (the OSError family,
  :func:`~trlx_tpu_torch.utils.retry.classify_io_error`) is retried with
  bounded backoff (:func:`~trlx_tpu_torch.utils.retry.retry_call`), on the
  writer thread under ``async_save``, where a permanent or exhausted one
  surfaces at the next join.
- **A layout that does not match**: a checkpoint written under another
  freezing (``model.num_layers_unfrozen``) or moment dtype fails in
  ``load_state_dict`` ("Missing key(s)", "Unexpected key(s)", "size
  mismatch") or in the optimizer's ("doesn't match the size of
  optimizer's group"); :func:`translate_structure_errors` turns each into
  a ``ValueError`` naming those keys. It is permanent
  (:func:`classify_checkpoint_error`) and never made from an ``OSError``.
"""

from __future__ import annotations

import atexit
import copy
import json
import os
import shutil
import tempfile
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from trlx_tpu_torch.resilience import chaos
from trlx_tpu_torch.utils.retry import classify_io_error, retry_call

STATE_FILE = "state.pt"
META_FILE = "meta.json"
MAX_TO_KEEP = 2

_WRITERS: "weakref.WeakSet[CheckpointWriter]" = weakref.WeakSet()


def all_steps(directory: str) -> List[int]:
    """The steps under ``directory`` with a committed checkpoint, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.exists(os.path.join(directory, name, STATE_FILE))
    )


def _step_dirs(directory: str) -> List[int]:
    """Every step directory, committed or not."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _delete(directory: str, step: int) -> None:
    shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)


def _write(directory: str, state: Dict[str, Any], step: int, stale: List[int]) -> str:
    """Commit ``state`` as ``step``, then the retention and the last stale
    step's deletion; a transient failure is retried."""
    return retry_call(
        lambda: _write_once(directory, state, step, stale),
        classify=classify_io_error,
        describe=f"checkpoint save to {directory}",
    )


def _write_once(directory: str, state: Dict[str, Any], step: int, stale: List[int]) -> str:
    chaos.check("checkpoint.save", step=step)
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=step_dir)
    os.close(fd)
    try:
        with open(os.path.join(step_dir, META_FILE), "w") as f:
            json.dump({"_saved_at": time.time(), "step": step}, f)
        torch.save(state, tmp)
        path = os.path.join(step_dir, STATE_FILE)
        os.replace(tmp, path)  # a reader never sees half a file
    except BaseException:
        os.unlink(tmp)
        raise
    # retention runs with the newest stale step still present (the JAX
    # manager's order): every step below the two highest goes
    for s in _step_dirs(directory)[:-MAX_TO_KEEP]:
        _delete(directory, s)
    if stale:
        _delete(directory, stale[-1])  # the new step committed: the old timeline can go
    return path


def _host_tree(obj):
    """A structure-preserving copy of ``obj`` whose tensors are listed for
    the snapshot: returns ``(tree, tensors)``, each tensor in ``tree``
    replaced by its index in ``tensors``."""
    tensors: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x.detach())
            return _Slot(len(tensors) - 1)
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return copy.deepcopy(x)  # the writer must not see a later change

    return walk(obj), tensors


class _Slot:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _fill(tree, values: List[torch.Tensor]):
    if isinstance(tree, _Slot):
        return values[tree.index]
    if isinstance(tree, dict):
        return type(tree)((k, _fill(v, values)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, values) for v in tree)
    return tree


class CheckpointWriter:
    """Saves checkpoints, synchronously or on a thread; owns the host
    buffers of its asynchronous snapshots (freed with the writer)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[tuple, List[torch.Tensor]] = {}
        #: the last save's seconds: to its return (``save_s``), of that
        #: spent joining the previous write (``join_s``), and of its own
        #: write (``write_s``, set when the write ends)
        self.last_times: Dict[str, float] = {}
        _WRITERS.add(self)

    def wait(self) -> None:
        """Join the write in flight, if any; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _snapshot(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Copies of ``tensors`` in host memory, in this layout's buffers,
        complete when this returns. CUDA tensors copy on a side stream
        that first waits for the work queued on the current stream; the
        current stream then waits for the copies, so no later update can
        overwrite a tensor before its copy is taken."""
        layout = tuple((tuple(t.shape), t.dtype, t.device.type) for t in tensors)
        if layout not in self._buffers:
            self._buffers.clear()  # one layout's set at a time
            self._buffers[layout] = [
                torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=t.is_cuda and torch.cuda.is_available())
                for t in tensors
            ]
        bufs = self._buffers[layout]
        on_cuda = [i for i, t in enumerate(tensors) if t.is_cuda]
        if on_cuda:
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for i in on_cuda:
                    bufs[i].copy_(tensors[i], non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            current.wait_event(done)
            done.synchronize()
        for i, t in enumerate(tensors):
            if not t.is_cuda:
                bufs[i].copy_(t)
        return bufs

    def save(self, directory: str, state: Dict[str, Any], step: int,
             async_save: bool = False) -> str:
        """Write ``state`` as step ``step`` under ``directory``; returns the
        state file's path. With ``async_save`` the write runs on a thread
        once the snapshot is in host memory; otherwise it has committed
        when this returns."""
        t0 = time.monotonic()
        self.wait()  # two saves never overlap, and the buffers are free
        join_s = time.monotonic() - t0
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        step = int(step)
        stale = [s for s in _step_dirs(directory) if s > step]
        for s in stale[:-1]:
            _delete(directory, s)
        path = os.path.join(directory, str(step), STATE_FILE)
        if not async_save:
            t1 = time.monotonic()
            _write(directory, state, step, stale)
            self.last_times = {"save_s": time.monotonic() - t0, "join_s": join_s,
                               "write_s": time.monotonic() - t1}
            return path
        tree, tensors = _host_tree(state)
        snapshot = _fill(tree, self._snapshot(tensors))
        times = self.last_times = {"save_s": time.monotonic() - t0, "join_s": join_s}

        def run():
            t1 = time.monotonic()
            try:
                _write(directory, snapshot, step, stale)
            except BaseException as e:  # surfaced by wait()
                self._error = e
            times["write_s"] = time.monotonic() - t1

        self._thread = threading.Thread(target=run, name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        return path


def wait_for_checkpoints() -> None:
    """Block until every write in flight has committed; re-raises a
    background write's error."""
    for writer in list(_WRITERS):
        writer.wait()


atexit.register(wait_for_checkpoints)


def _saved_at(directory: str, step: int) -> float:
    try:
        with open(os.path.join(directory, str(step), META_FILE)) as f:
            return float(json.load(f).get("_saved_at", 0.0))
    except (OSError, ValueError):
        return 0.0


def latest_step(directory: str) -> Optional[int]:
    """The step :func:`load_checkpoint` restores: of the committed steps,
    the newest by ``_saved_at``, then by step (an unstamped step sorts by
    its number alone)."""
    steps = all_steps(directory)
    if not steps:
        return None
    return max(steps, key=lambda s: (_saved_at(directory, s), s))


def has_checkpoint(directory: str) -> bool:
    """Whether ``directory`` holds a committed checkpoint."""
    return bool(all_steps(directory))


#: phrasings of a layout disagreement: the JAX package's (Orbax's) and
#: torch's ``load_state_dict`` and optimizer ones; narrow on purpose, since
#: broad words ("shape", "different") appear in I/O failures too
_MISMATCH_HINTS = (
    "structure", "mismatch", "not match", "treedef",
    "missing key(s)", "unexpected key(s)", "doesn't match the size",
    "different number of parameter groups",
)


def _structure_mismatch_error(directory: str, e: BaseException) -> Optional[ValueError]:
    """The actionable ``ValueError`` for a layout disagreement, or None.

    The optimizer's state depends on the config: a frozen run
    (``model.num_layers_unfrozen``) keeps moments only for the trainable
    parameters, and ``train.adam_moment_dtype`` sets their dtype, so a
    checkpoint written under one layout does not load into another."""
    text = f"{type(e).__name__}: {e}".lower()
    if not any(h in text for h in _MISMATCH_HINTS):
        return None
    if isinstance(e, OSError):
        # an I/O error whose message holds a hint word is still I/O
        return None
    return ValueError(
        f"checkpoint under {directory} does not match the current train-state "
        "structure. This likely means the optimizer-state layout changed between "
        "the run that wrote the checkpoint and this configuration — e.g. "
        "`model.num_layers_unfrozen` (frozen runs store moments only for the "
        "trainable parameters) or `train.adam_moment_dtype` differs. Frozen-layout "
        "changes are not restorable: restore with the original configuration, or "
        "restart the run fresh with a new checkpoint dir. If neither key changed, "
        f"the underlying error was: {type(e).__name__}: {e}"
    )


def classify_checkpoint_error(e: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for a checkpoint failure: a
    structure mismatch is permanent however it was raised; the rest
    follows :func:`~trlx_tpu_torch.utils.retry.classify_io_error`."""
    if _structure_mismatch_error("", e) is not None:
        return "permanent"
    return classify_io_error(e)


@contextmanager
def translate_structure_errors(directory: str):
    """Re-raise a layout disagreement inside the block as the
    ``ValueError`` naming ``model.num_layers_unfrozen`` and
    ``train.adam_moment_dtype`` (chained to the original)."""
    try:
        yield
    except Exception as e:
        wrapped = _structure_mismatch_error(directory, e)
        if wrapped is None:
            raise
        raise wrapped from e


def load_checkpoint(directory: str, device=None) -> Dict[str, Any]:
    """The newest checkpoint's state (after every write in flight has
    landed), its tensors on ``device``; a transient read failure is
    retried, a structure mismatch refused at once."""
    wait_for_checkpoints()
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory!r}")
    path = os.path.join(directory, str(step), STATE_FILE)

    def read():
        chaos.check("checkpoint.load")
        return torch.load(path, map_location=device, weights_only=True, mmap=True)

    with translate_structure_errors(directory):
        return retry_call(read, classify=classify_checkpoint_error,
                          describe=f"checkpoint restore from {path}")
