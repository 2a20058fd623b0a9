"""Run ledger: one manifest per run, a JSONL to diff them against
(counterpart of :mod:`trlx_tpu.telemetry.run_ledger`; the port keeps its
own copy).

- :func:`build_manifest`: a dict capturing everything a later diff needs:
  config fingerprint, platform (the card, the torch and CUDA versions), git
  sha, span stats, the metrics-registry snapshot, health-event counts and
  the producer's free-form payload (a ``learn()`` summary).
- :func:`append_manifest`: append it as one JSONL line to the ledger
  (``TRLX_RUN_LEDGER`` env, or an explicit path). Append-only: the ledger
  is history.
- ``python -m trlx_tpu_torch.telemetry --compare <run_a> <run_b>``:
  resolve two runs (by run_id, ledger index, back-reference or manifest
  file path) and render the regression diff: numeric movers ranked by
  relative delta, span p50 deltas and health-event counts.
- ``--watch <run_dir>``: tail the live ``phases.jsonl`` a training run
  mirrors its flight-phase records into (``train.run_dir``), one rendered
  row per phase.

Everything is host-side standard-library I/O (the platform probe imports
torch on call); a failed ledger append must never take down the run that
produced the measurement (callers guard, and :func:`append_manifest` only
raises on programmer error).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, IO, List, Optional, Sequence

SCHEMA_VERSION = 1

#: env override for every default ledger path decision
LEDGER_ENV = "TRLX_RUN_LEDGER"
DEFAULT_LEDGER = "RUN_LEDGER.jsonl"


def default_ledger_path() -> str:
    return os.environ.get(LEDGER_ENV) or DEFAULT_LEDGER


def git_sha() -> str:
    """Short sha of the producing checkout ('' outside a repo / without
    git) — manifests self-identify the code that measured them."""
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True,
                text=True,
                timeout=5,
            ).stdout.strip()
        )
    except Exception:
        return ""


def _platform_info() -> Dict[str, Any]:
    """The flight recorder's platform keys (``backend``, ``device_kind``:
    the card's name, ``n_devices``) and the torch and CUDA versions."""
    from trlx_tpu_torch.telemetry.flight_recorder import _platform_info as info

    out = info()
    try:
        import torch

        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda or ""
    except Exception:
        pass
    return out


def build_manifest(
    kind: str,
    run_id: Optional[str] = None,
    config: Optional[Dict[str, Any]] = None,
    payload: Optional[Dict[str, Any]] = None,
    attribution: Optional[Sequence[Dict[str, Any]]] = None,
    span_stats: Optional[Dict[str, Dict[str, float]]] = None,
    metrics: Optional[Dict[str, Any]] = None,
    health_events: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """One run's manifest. ``span_stats`` and ``metrics`` default to the
    process-global tracer/registry state at call time (the epilogue
    callsite); pass explicit dicts when the caller already scoped its
    measurement window."""
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.telemetry.health import config_fingerprint

    if span_stats is None:
        try:
            span_stats = telemetry.get_tracer().stats()
        except Exception:
            span_stats = {}
    if metrics is None:
        try:
            metrics = telemetry.get_metrics().snapshot()
        except Exception:
            metrics = {}
    created = time.time()
    if run_id is None:
        run_id = (
            f"{kind}_{time.strftime('%Y%m%d_%H%M%S', time.localtime(created))}"
            f"_{os.getpid()}"
        )
    return {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id,
        "kind": kind,
        "created_unix": created,
        "date": time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(created)),
        "fingerprint": config_fingerprint(config) if config else "",
        "git_sha": git_sha(),
        "platform": _platform_info(),
        "span_stats": span_stats or {},
        "metrics": metrics or {},
        "health_events": dict(health_events or {}),
        "attribution": [dict(r) for r in (attribution or [])],
        "payload": dict(payload or {}),
    }


def numeric_payload(record: Dict[str, Any]) -> Dict[str, Any]:
    """The ledger-payload projection of a producer's record: plain
    numeric scalars only (bools excluded — they are flags, not
    measurements). One definition for every producer (the learn()
    epilogue, an A/B record), so a change to the
    filtering rule lands everywhere at once."""
    return {
        k: float(v)
        for k, v in (record or {}).items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


def append_manifest(
    manifest: Dict[str, Any], path: Optional[str] = None
) -> str:
    """Append one manifest line to the ledger; returns the path."""
    path = path or default_ledger_path()
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(manifest, default=float) + "\n")
    return path


def load_ledger(path: str) -> List[Dict[str, Any]]:
    """Every parseable manifest line, oldest first (a torn final line —
    the run died mid-append — is skipped, not fatal)."""
    runs: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                runs.append(rec)
    return runs


def resolve_run(
    spec: str, ledger_path: Optional[str] = None
) -> Dict[str, Any]:
    """A run manifest from a CLI spec: a manifest ``.json`` file path, a
    ledger ``.jsonl`` path (its newest run), a ``run_id`` recorded in
    the ledger (latest wins on collision), a back-reference ``~1``
    (newest) / ``~2`` (previous) / ``last`` / ``prev`` — spelled with a
    tilde because argparse would eat a bare ``-1`` as an option — or an
    integer index into the ledger."""
    if os.path.exists(spec):
        if spec.endswith(".jsonl"):
            runs = load_ledger(spec)
            if not runs:
                raise ValueError(f"{spec}: empty ledger")
            return runs[-1]
        with open(spec, encoding="utf-8") as fh:
            return json.load(fh)
    path = ledger_path or default_ledger_path()
    if not os.path.exists(path):
        raise ValueError(
            f"run {spec!r} is not a file and ledger {path!r} does not "
            f"exist (set --ledger or ${LEDGER_ENV})"
        )
    runs = load_ledger(path)
    for rec in reversed(runs):
        if rec.get("run_id") == spec:
            return rec
    index: Optional[int] = None
    if spec == "last":
        index = -1
    elif spec == "prev":
        index = -2
    elif spec.startswith("~") and spec[1:].isdigit():
        index = -int(spec[1:])
    else:
        try:
            index = int(spec)
        except ValueError:
            index = None
    if index is not None:
        try:
            return runs[index]
        except IndexError:
            pass
    raise ValueError(
        f"run {spec!r} not found in {path} ({len(runs)} runs; specs: "
        "a run_id, ~1/~2/last/prev back-references, an integer index, "
        "or a manifest path)"
    )


def append_ab_manifest(kind: str, record: Dict[str, Any]) -> Optional[str]:
    """Append an A/B measurement ``record`` to the run ledger as history
    (the JAX package's A/B harnesses call it; the port's A/B record,
    ``utils/ab_record.py``, is ROADMAP item 19's remainder), so
    ``--compare`` can diff any two A/B rounds. Numeric payload only;
    best-effort (returns None on failure — a ledger hiccup must not
    fail a measurement that already printed)."""
    try:
        flat: Dict[str, Any] = numeric_payload(record)
        flat["metric"] = record.get("metric", "")
        return append_manifest(build_manifest(kind, payload=flat))
    except Exception as e:
        print(
            f"run_ledger: A/B manifest append failed "
            f"({type(e).__name__}: {e})",
            file=sys.stderr,
        )
        return None


# -------------------------------- compare --------------------------------- #


def flatten_numeric(manifest: Dict[str, Any]) -> Dict[str, float]:
    """One flat numeric view of a manifest for the movers diff: payload
    scalars, the flattened metrics snapshot, and per-span p50s."""
    from trlx_tpu_torch.telemetry.metrics import flatten_snapshot

    out: Dict[str, float] = numeric_payload(manifest.get("payload") or {})
    for key, value in flatten_snapshot(manifest.get("metrics")).items():
        out[f"metrics/{key}"] = value
    for name, stats in (manifest.get("span_stats") or {}).items():
        if isinstance(stats, dict) and "p50_ms" in stats:
            out[f"span/{name}_p50_ms"] = float(stats["p50_ms"])
    for key, value in (manifest.get("health_events") or {}).items():
        out[f"health_events/{key}"] = float(value)
    return out


# one number formatter for the whole triage surface: --inspect and
# --compare must render values identically
from trlx_tpu_torch.telemetry.flight_recorder import _fmt  # noqa: E402


def compare_runs(
    a: Dict[str, Any], b: Dict[str, Any], top: int = 20
) -> str:
    """The regression diff between two manifests (``a`` = baseline,
    ``b`` = candidate), rendered in the ``--inspect`` triage style:
    header, largest relative movers over the shared numeric keys, keys
    only one side has, and attribution MFU deltas."""
    lines: List[str] = []
    for tag, m in (("a", a), ("b", b)):
        platform = m.get("platform") or {}
        lines.append(
            f"run {tag}: {m.get('run_id', '?')}  [{m.get('kind', '?')}]  "
            f"{m.get('date', '')}  git={m.get('git_sha', '') or '?'}  "
            f"platform={platform.get('backend', '?')}"
            f"/{platform.get('device_kind', '?')}"
        )
    fp_a, fp_b = a.get("fingerprint", ""), b.get("fingerprint", "")
    if fp_a and fp_b and fp_a != fp_b:
        lines.append(
            f"WARNING: config fingerprints differ ({fp_a} vs {fp_b}) — "
            "the runs measured different configs; deltas below mix "
            "config changes with regressions"
        )
    pk_a = (a.get("platform") or {}).get("device_kind")
    pk_b = (b.get("platform") or {}).get("device_kind")
    if pk_a and pk_b and pk_a != pk_b:
        lines.append(
            f"WARNING: device kinds differ ({pk_a} vs {pk_b}) — "
            "wall-clock deltas are not comparable across backends"
        )

    flat_a, flat_b = flatten_numeric(a), flatten_numeric(b)
    shared = sorted(set(flat_a) & set(flat_b))
    movers = []
    for key in shared:
        va, vb = flat_a[key], flat_b[key]
        if va == vb:
            continue
        rel = (vb - va) / max(abs(va), 1e-9)
        movers.append((abs(rel), key, va, vb, rel))
    movers.sort(reverse=True)
    lines.append("")
    if movers:
        lines.append(f"movers (largest relative delta, top {top}):")
        for _mag, key, va, vb, rel in movers[:top]:
            lines.append(
                f"  {key:40} {_fmt(va):>12} -> {_fmt(vb):>12} "
                f"({rel * 100.0:+.1f}%)"
            )
    else:
        lines.append("movers: none (all shared numeric keys identical)")
    only_a = sorted(set(flat_a) - set(flat_b))
    only_b = sorted(set(flat_b) - set(flat_a))
    if only_a:
        lines.append(f"only in a: {', '.join(only_a[:12])}")
    if only_b:
        lines.append(f"only in b: {', '.join(only_b[:12])}")

    attr_a = {
        r.get("program"): r for r in (a.get("attribution") or [])
    }
    attr_b = {
        r.get("program"): r for r in (b.get("attribution") or [])
    }
    rows = []
    for program in sorted(set(attr_a) & set(attr_b)):
        ma, mb = attr_a[program].get("mfu"), attr_b[program].get("mfu")
        if ma is not None and mb is not None:
            rows.append((program, float(ma), float(mb)))
    if rows:
        lines.append("")
        lines.append("attribution: measured MFU per program:")
        for program, ma, mb in rows:
            lines.append(
                f"  {program:32} {_fmt(ma):>10} -> {_fmt(mb):>10}"
            )
    return "\n".join(lines)


# --------------------------------- watch ---------------------------------- #


def phases_path(run_dir_or_file: str) -> str:
    """``--watch`` target resolution: a directory means its
    ``phases.jsonl``; an explicit ``.jsonl`` file is taken as-is. A
    path that does not exist YET is treated as a run directory too —
    watching before the training run creates it is the headline
    use-case, and resolving it to the bare name would tail the
    directory itself once it appears (IsADirectoryError)."""
    if os.path.isfile(run_dir_or_file) or (
        run_dir_or_file.endswith(".jsonl")
        and not os.path.isdir(run_dir_or_file)
    ):
        return run_dir_or_file
    return os.path.join(run_dir_or_file, "phases.jsonl")


def render_phase_row(row: Dict[str, Any]) -> str:
    """One live phase record as one terminal line: identity, the
    headline stats, span p50s, and any tripped events."""
    stats = row.get("stats") or {}
    spans = row.get("spans") or {}
    parts = [f"phase {row.get('phase', '?'):>4}"]
    if row.get("step") is not None:
        parts.append(f"step {row['step']}")
    for key in (
        "losses/total_loss",
        "policy/mean_rollout_kl",
        "exp/scores_mean",
        "health/entropy",
    ):
        if key in stats:
            parts.append(f"{key.split('/', 1)[1]}={_fmt(float(stats[key]))}")
    for name in ("phase/collect", "phase/train"):
        if name in spans:
            parts.append(
                f"{name.split('/', 1)[1]}={float(spans[name].get('p50_ms', 0)):.0f}ms"
            )
    events = row.get("events") or []
    if events:
        dets = sorted({e.get("detector", "?") for e in events})
        parts.append(f"events: {','.join(dets)}")
    mem = row.get("memory") or {}
    if "peak_bytes_in_use" in mem:
        parts.append(f"hbm_peak={mem['peak_bytes_in_use'] / 2**30:.2f}G")
    return "  ".join(parts)


def watch(
    run_dir_or_file: str,
    follow: bool = True,
    poll_s: float = 1.0,
    out: Optional[IO[str]] = None,
) -> int:
    """Tail a run's live phase rows, rendering each as one line.
    ``follow=False`` renders what is on disk and returns (the testable
    core); ``follow=True`` polls until interrupted. Returns the number
    of rows rendered."""
    out = out or sys.stdout
    path = phases_path(run_dir_or_file)
    rendered = 0
    pos = 0
    printed_waiting = False
    while True:
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                fh.seek(pos)
                while True:
                    line = fh.readline()
                    if not line:
                        break
                    if not line.endswith("\n") and follow:
                        break  # torn tail: re-read on the next poll
                    pos = fh.tell()
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except ValueError:
                        continue
                    print(render_phase_row(row), file=out)
                    rendered += 1
        elif not follow:
            raise FileNotFoundError(path)
        elif not printed_waiting:
            print(f"watching {path} (not created yet)...", file=out)
            printed_waiting = True
        if not follow:
            return rendered
        try:
            time.sleep(poll_s)
        except KeyboardInterrupt:
            return rendered


class PhaseLogWriter:
    """Append-one-JSON-line-per-phase mirror of the flight recorder's
    phase records into ``<run_dir>/phases.jsonl`` — the ``--watch``
    feed. Opens/closes per append (a phase boundary is seconds apart;
    durability beats a held handle that a preemption would tear)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, "phases.jsonl")
        self._warned = False

    def append(self, row: Dict[str, Any]) -> None:
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(row, default=float) + "\n")
        except OSError as e:
            if not self._warned:
                print(
                    f"run_ledger: cannot append phase row to "
                    f"{self.path} ({e}) — live --watch feed disabled",
                    file=sys.stderr,
                )
                self._warned = True
