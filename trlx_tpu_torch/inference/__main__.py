"""Serving smokes (counterpart of ``python -m trlx_tpu.inference``).

- ``python -m trlx_tpu_torch.inference --smoke [--device cpu]``: build a
  tiny random-weight GPT-2 policy, serve a prompt batch through
  :class:`~trlx_tpu_torch.inference.server.InferenceServer`, and assert
  every request completes with finite logprobs and values and zero health
  events. Prints one JSON line with the completion lengths, the engine's
  counters and the ``serve/*`` metrics.
- ``python -m trlx_tpu_torch.inference --mt-smoke [--span-log PATH]
  [--device cpu]``: the multi-tenant QoS smoke
  (:func:`multi_tenant_smoke`); ``--span-log`` exports the run's span
  stream, the input of ``python -m trlx_tpu_torch.telemetry
  --trace-report``.

Both run on CUDA unless ``--device cpu`` is given (and fail without CUDA
otherwise).
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def tiny_config_dict() -> dict:
    """A tiny PPO config (the JAX package's test-harness shapes)."""
    return {
        "model": {
            "model_type": "gpt2",
            "model_arch": {
                "vocab_size": 32, "n_positions": 32, "n_embd": 32,
                "n_layer": 2, "n_head": 2,
            },
        },
        "train": {
            "seq_length": 8, "batch_size": 8, "dtype": "float32",
            "rollout": {
                "slots": 4, "admit_width": 2, "harvest_width": 2,
                "block_size": 4,
            },
        },
        "method": {
            "name": "PPOConfig",
            "gen_kwargs": {
                "max_new_tokens": 6, "do_sample": True,
                "eos_token_id": 30, "pad_token_id": 31,
            },
        },
    }


def serving_smoke(device=None, n_prompts: int = 6) -> int:
    import numpy as np

    from trlx_tpu_torch.inference.server import InferenceServer

    server = InferenceServer(tiny_config_dict(), seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = [
        [int(x) for x in rng.integers(1, 30, int(rng.integers(2, 8)))]
        for _ in range(n_prompts)
    ]
    ids = server.submit(prompts)
    results = server.wait(ids)
    failures = [
        rid for rid in ids
        if results[rid]["length"] < 1
        or not all(math.isfinite(x) for x in results[rid]["logprobs"])
        or not all(math.isfinite(x) for x in results[rid]["values"])
    ]
    events = server.health_events
    record = {
        "device": str(server.device),
        "completed": len(ids) - len(failures),
        "submitted": len(ids),
        "lengths": [results[r]["length"] for r in ids],
        "health_events": [ev.to_dict() for ev in events],
        "serving_metrics": server.metrics(),
        **server.stats(),
    }
    print(json.dumps(record))
    if failures:
        print(f"serving-smoke FAIL: requests {failures} incomplete or "
              "non-finite", file=sys.stderr)
        return 1
    if events:
        print(f"serving-smoke FAIL: {len(events)} health events on a "
              "clean run", file=sys.stderr)
        return 1
    print("serving-smoke PASS: all requests completed, zero health events",
          file=sys.stderr)
    return 0


def multi_tenant_smoke(device=None, span_log=None) -> int:
    """The serving tier's QoS smoke. One run must show:

    - **priority admission**: the high-priority tenant's requests,
      submitted AFTER the low-priority tenant's, are admitted and complete
      ahead of them (the slot pool is smaller than the request count);
    - **quota without starvation**: the low-priority tenant is
      token-bucket throttled (throttled rounds counted) yet every one of
      its requests completes;
    - **streamed TTFT < wait-for-harvest TTFT**: the first streamed token
      of a ``stream=True`` request arrives before its harvested result;
    - **prefix sharing**: a system-prompt prefix shared across tenants
      gives a nonzero ``engine/prefix_hit_rate``;
    - **per-tenant metrics**: ``serve/*[tenant=...]`` histograms with
      nonzero counts;
    - **request tracing**: every completed request emitted a closed
      ``serve/request`` span chain and the span ring dropped nothing;
    - **chunked prefill**: ``engine/prefill_chunks > 0`` at one chunk
      forward a pump;
    - **speculative decoding** through the trie drafter:
      ``engine/spec_accept_rate > 0``, and a spec-off rerun of the same
      prompts in the same order serves every row ``torch.equal``;
    - **zero health events**, on both runs.

    ``span_log`` exports the whole span stream (phase and request spans,
    counter tracks; one chrome-trace JSONL). Returns the exit code."""
    import copy

    import numpy as np
    import torch

    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.inference.server import InferenceServer

    cfg = tiny_config_dict()
    # near-greedy decode with a longer budget: random-weight generation
    # falls into short loops the drafter locks onto, so the spec path sees
    # real acceptance
    cfg["method"]["gen_kwargs"].update(
        {"temperature": 0.05, "max_new_tokens": 16, "min_new_tokens": 8}
    )
    cfg["train"]["rollout"] = {
        "engine": "continuous",
        "slots": 4, "admit_width": 2, "harvest_width": 2, "block_size": 4,
        # chunked prefill at one chunk forward a pump, and the trie drafter
        # over the shared-prefix pool
        "prefill_chunk": 4, "prefill_chunks_per_pump": 1,
        "spec_decode": {"enabled": True, "max_draft": 4, "drafter": "trie"},
    }
    serving_cfg = {
        "prefix_cache_blocks": 16,
        # generous budgets: a clean run must stay at zero health events
        # (the slo-breach detector is held with tight budgets in the tests)
        "slo_classes": {
            "interactive": {"queue_wait_budget_ms": 120000},
            "standard": {"queue_wait_budget_ms": 120000},
        },
        "tenants": {
            "gold": {"priority": 10, "slo_class": "interactive"},
            # the burst covers ONE request's cost (Q + R tokens) and the
            # rate refills about two requests a second: bronze is
            # throttled to a trickle but never starves
            "bronze": {
                "priority": 0, "rate": 60.0, "burst": 26.0,
                "slo_class": "standard",
            },
        },
    }
    server = InferenceServer(cfg, seed=0, device=device, serving=serving_cfg)
    Q = server.query_length
    rng = np.random.default_rng(0)
    system_prefix = [5, 6, 7, 8]  # shared across BOTH tenants

    def make_prompts(n):
        # cyclic two-token tails: every suffix recurs, so the drafter has
        # n-gram matches from the first decode step
        out = []
        for _ in range(n):
            a, b = (int(x) for x in rng.integers(1, 30, 2))
            tail = [int(t) for t in np.tile([a, b], Q)][: Q - len(system_prefix)]
            out.append(system_prefix + tail)
        return out

    bronze_prompts = make_prompts(4)
    gold_prompts = make_prompts(4)
    stream_prompts = make_prompts(1)
    # low-priority bronze submits FIRST, gold afterwards: priority
    # admission must still serve gold ahead of bronze
    bronze = server.submit(bronze_prompts, tenant="bronze")
    gold = server.submit(gold_prompts, tenant="gold")
    stream_rid = server.submit(stream_prompts, tenant="gold", stream=True)[0]

    # streamed TTFT: pull the first token through the stream (it pumps the
    # serving loop); wait-for-harvest TTFT: pump until the SAME request's
    # harvested result exists
    t0 = telemetry.monotonic()
    first_token = next(server.stream(stream_rid))
    ttft_stream_ms = (telemetry.monotonic() - t0) * 1000.0
    result_at_first_token = server.poll(stream_rid)
    while server.poll(stream_rid) is None:
        server._pump_once()
    ttft_harvest_ms = (telemetry.monotonic() - t0) * 1000.0

    server.flush()
    # engine rows are allocated in admission-feed order: the scheduler's
    # decision trail (taken before wait() pops the bookkeeping)
    admit_pos = dict(server._req_row)
    served = bronze + gold + [stream_rid]
    results = server.wait(served)

    order = server.completion_order
    rank = {rid: i for i, rid in enumerate(order)}
    gold_ranks = [rank[r] for r in gold + [stream_rid]]
    bronze_ranks = [rank[r] for r in bronze]
    gold_rows = [admit_pos[r] for r in gold + [stream_rid]]
    bronze_rows = [admit_pos[r] for r in bronze]
    stats = server.stats()
    metrics = server.metrics()
    events = server.health_events

    tracer = telemetry.get_tracer()
    request_spans = (
        [s for s in tracer.spans() if s.name == "serve/request"]
        if tracer.enabled else []
    )

    # spec-off rerun: the same prompts in the same submission order (the
    # same draw positions, so the same per-row noise): every served row
    # must be what the one-token loop produces
    cfg_off = copy.deepcopy(cfg)
    cfg_off["train"]["rollout"].pop("spec_decode")
    server_off = InferenceServer(cfg_off, seed=0, device=device, serving=serving_cfg)
    off = (server_off.submit(bronze_prompts, tenant="bronze")
           + server_off.submit(gold_prompts, tenant="gold")
           + server_off.submit(stream_prompts, tenant="gold"))
    results_off = server_off.wait(off)
    spec_parity = all(
        torch.equal(torch.tensor(results[a]["tokens"]), torch.tensor(results_off[b]["tokens"]))
        for a, b in zip(served, off)
    )

    record = {
        "device": str(server.device),
        "spec_drafter": type(server.engine.spec_drafter).__name__,
        "spec_off_row_parity": bool(spec_parity),
        "completion_order_tenants": [
            "gold" if r in set(gold + [stream_rid]) else "bronze" for r in order
        ],
        "gold_ranks": gold_ranks,
        "bronze_ranks": bronze_ranks,
        "gold_admission_rows": gold_rows,
        "bronze_admission_rows": bronze_rows,
        "first_streamed_token": int(first_token),
        "ttft_stream_ms": round(ttft_stream_ms, 3),
        "ttft_harvest_ms": round(ttft_harvest_ms, 3),
        "scheduler_throttled_rounds": stats["scheduler/throttled_rounds"],
        "prefix_hit_rate": stats["engine/prefix_hit_rate"],
        "prefix_blocks_saved": stats["engine/prefix_blocks_saved"],
        "prefill_chunks": stats["engine/prefill_chunks"],
        "prefill_cols_skipped": stats["engine/prefill_cols_skipped"],
        "prefill_flops_saved": stats["engine/prefill_flops_saved"],
        "released_placeholders": stats["engine/released"],
        "request_spans": len(request_spans),
        "spans_dropped": int(tracer.dropped),
        "health_events": [ev.to_dict() for ev in events],
        "serving_metrics": metrics,
        **stats,
    }
    print(json.dumps(record))
    if span_log and tracer.enabled:
        n_events = telemetry.export_chrome_jsonl(
            span_log, tracer.spans(),
            counters=telemetry.get_metrics().gauge_series(),
        )
        print(f"mt-smoke: exported {n_events} trace events to {span_log}",
              file=sys.stderr)

    failures = []
    if len(results) != len(served) or any(r["length"] < 1 for r in results.values()):
        failures.append("not every request completed")
    if max(gold_rows) > min(bronze_rows):
        failures.append(
            "priority inversion: a bronze request was ADMITTED before the "
            "last gold request despite submitting earlier with lower priority"
        )
    if sorted(gold_ranks[:4]) != list(range(4)):
        failures.append("the first completions were not the first gold wave")
    if stats["scheduler/throttled_rounds"] < 1:
        failures.append("bronze quota never throttled")
    if result_at_first_token is not None:
        failures.append("harvest completed before the first streamed token")
    if not ttft_stream_ms < ttft_harvest_ms:
        failures.append(
            f"streamed TTFT {ttft_stream_ms:.1f}ms not below wait-for-harvest "
            f"TTFT {ttft_harvest_ms:.1f}ms"
        )
    if not stats["engine/prefix_hit_rate"] > 0:
        failures.append("prefix sharing produced zero hits")
    if not stats["engine/prefill_chunks"] > 0:
        failures.append(
            "chunked prefill never ran (engine/prefill_chunks == 0) despite "
            "rollout.prefill_chunk being set"
        )
    if not stats["engine/spec_accept_rate"] > 0:
        failures.append(
            "spec decode accepted nothing (engine/spec_accept_rate == 0) "
            "despite rollout.spec_decode being enabled"
        )
    if not spec_parity:
        failures.append("spec-on served rows differ from the spec-off rerun")
    if server_off.health_events:
        failures.append(
            f"{len(server_off.health_events)} health events on the spec-off rerun"
        )
    if telemetry.get_metrics().enabled:
        for tenant in ("gold", "bronze"):
            key = f"serve/queue_wait_ms[tenant={tenant}]"
            if not metrics.get(key, {}).get("count"):
                failures.append(f"missing per-tenant histogram {key}")
    if tracer.enabled:
        # trace completeness and the ring's capacity canary: one closed
        # chain per completed request, zero evictions
        if len(request_spans) < len(results):
            failures.append(
                f"request tracing incomplete: {len(request_spans)} "
                f"serve/request spans for {len(results)} completed requests"
            )
        if telemetry.warn_on_span_drops(tracer):
            failures.append(
                f"span ring dropped {tracer.dropped} spans: raise "
                "telemetry.ring_size / TRLX_TELEMETRY_RING"
            )
    if events:
        failures.append(f"{len(events)} health events on a clean run")
    if failures:
        for f in failures:
            print(f"mt-smoke FAIL: {f}", file=sys.stderr)
        return 1
    print(
        "mt-smoke PASS: priority ordering, quota-throttle-no-starve, "
        f"streamed TTFT {ttft_stream_ms:.0f}ms < harvest {ttft_harvest_ms:.0f}ms, "
        f"prefix hit rate {stats['engine/prefix_hit_rate']:.2f}, "
        f"{stats['engine/prefill_chunks']:.0f} prefill chunks "
        f"({stats['engine/prefill_cols_skipped']:.0f} cols skipped), "
        f"spec accept rate {stats['engine/spec_accept_rate']:.2f} "
        "(equal to spec-off), zero health events",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.inference",
        description="continuous-batching serving utilities (PyTorch port)",
    )
    parser.add_argument(
        "--smoke", action="store_true",
        help="serve a tiny random policy and assert every request completes",
    )
    parser.add_argument(
        "--mt-smoke", action="store_true",
        help="run the multi-tenant QoS smoke: priority ordering, quota "
        "throttling without starvation, streamed TTFT below harvest TTFT, "
        "nonzero prefix-sharing hit rate, per-tenant serve/* histograms, "
        "complete request traces with zero span drops, chunked prefill, "
        "the trie-drafted spec path against a spec-off rerun, zero health "
        "events",
    )
    parser.add_argument(
        "--span-log", metavar="PATH", default=None,
        help="with --mt-smoke: export the run's span stream (phase and "
        "request spans, counter tracks) as chrome-trace JSONL, the input "
        "of `python -m trlx_tpu_torch.telemetry --trace-report`",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs the plain versions)",
    )
    args = parser.parse_args(argv)
    if args.smoke:
        return serving_smoke(device=args.device)
    if args.mt_smoke:
        return multi_tenant_smoke(device=args.device, span_log=args.span_log)
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
