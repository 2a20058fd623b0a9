"""CLI: flight-dump triage, run comparison, run watching (counterpart of
``python -m trlx_tpu.telemetry``).

- ``python -m trlx_tpu_torch.telemetry --inspect <dump.json>``: render a
  flight-recorder forensics dump as the triage view (run header and
  error, the tripped-detector table, the last-good-phase stats diff, span
  p50 deltas, the final phase's metrics snapshot). ``--json`` re-emits a
  machine-readable summary instead.
- ``python -m trlx_tpu_torch.telemetry --compare <run_a> <run_b>``:
  resolve two run-ledger manifests (run_id, ``~1``/``~2`` back-reference,
  ledger index, or a manifest file path; ``--ledger`` overrides
  ``$TRLX_RUN_LEDGER``) and render the regression diff; ``--json`` emits
  the deltas.
- ``python -m trlx_tpu_torch.telemetry --watch <run_dir>``: tail the live
  ``phases.jsonl`` a ``train.run_dir`` run mirrors its phase records into,
  one line per phase (``--no-follow`` renders what exists and exits).
- ``python -m trlx_tpu_torch.telemetry --trace-report <spans.jsonl>``: the
  critical-path / tenant-tail / decode-bubble report over a span log
  carrying request traces (:mod:`~trlx_tpu_torch.telemetry.trace_report`);
  ``--json`` emits the machine summary.

Exit status: 0 on success, 2 on unreadable or unresolvable inputs (the
content never affects the exit code: these are viewers, not gates).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.telemetry",
        description=(
            "inspect flight dumps, compare run-ledger manifests, watch "
            "live runs"
        ),
    )
    parser.add_argument(
        "--inspect",
        metavar="DUMP",
        help="path to a flight-recorder JSON dump",
    )
    parser.add_argument(
        "--compare",
        nargs=2,
        metavar=("RUN_A", "RUN_B"),
        help=(
            "two runs to diff: run_id, ledger index (-1 newest), or a "
            "manifest JSON path"
        ),
    )
    parser.add_argument(
        "--ledger",
        metavar="PATH",
        default=None,
        help="ledger JSONL for --compare run resolution "
        "(default: $TRLX_RUN_LEDGER or RUN_LEDGER.jsonl)",
    )
    parser.add_argument(
        "--watch",
        metavar="RUN_DIR",
        help="tail a run's live phases.jsonl (a train.run_dir)",
    )
    parser.add_argument(
        "--no-follow",
        action="store_true",
        help="with --watch: render the rows on disk and exit",
    )
    parser.add_argument(
        "--trace-report",
        metavar="SPANS",
        help=(
            "span JSONL with per-request traces: render the "
            "critical-path / tenant-tail / decode-bubble report"
        ),
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit a machine-readable summary instead of the triage view",
    )
    args = parser.parse_args(argv)

    if args.trace_report:
        from trlx_tpu_torch.telemetry.trace_report import render_report, report_json

        try:
            if args.json:
                print(json.dumps(report_json(args.trace_report)))
            else:
                print(render_report(args.trace_report))
        except OSError as e:
            print(f"error: cannot read {args.trace_report}: {e}", file=sys.stderr)
            return 2
        return 0

    if args.compare:
        from trlx_tpu_torch.telemetry.run_ledger import compare_runs, resolve_run

        try:
            run_a = resolve_run(args.compare[0], args.ledger)
            run_b = resolve_run(args.compare[1], args.ledger)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.json:
            from trlx_tpu_torch.telemetry.run_ledger import flatten_numeric

            flat_a, flat_b = flatten_numeric(run_a), flatten_numeric(run_b)
            deltas = {
                k: {"a": flat_a[k], "b": flat_b[k]}
                for k in sorted(set(flat_a) & set(flat_b))
                if flat_a[k] != flat_b[k]
            }
            print(
                json.dumps(
                    {
                        "run_a": run_a.get("run_id"),
                        "run_b": run_b.get("run_id"),
                        "deltas": deltas,
                    }
                )
            )
        else:
            print(compare_runs(run_a, run_b))
        return 0

    if args.watch:
        from trlx_tpu_torch.telemetry.run_ledger import watch

        try:
            watch(args.watch, follow=not args.no_follow)
        except FileNotFoundError as e:
            print(f"error: no phase log at {e}", file=sys.stderr)
            return 2
        return 0

    if args.inspect:
        from trlx_tpu_torch.telemetry.flight_recorder import inspect_dump, load_dump

        try:
            payload = load_dump(args.inspect)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot read {args.inspect}: {e}", file=sys.stderr)
            return 2

        if args.json:
            events = payload.get("events") or []
            counts: dict = {}
            for e in events:
                det = e.get("detector", "?")
                counts[det] = counts.get(det, 0) + 1
            print(
                json.dumps(
                    {
                        "reason": payload.get("reason"),
                        "fingerprint": payload.get("fingerprint"),
                        "error": payload.get("error"),
                        "phases_recorded": len(payload.get("phases") or []),
                        "event_counts": counts,
                    }
                )
            )
        else:
            print(inspect_dump(payload))
        return 0

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
