#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: ``python3 chip_smoke.py`` (one H100).

Phases, each fatal on failure:

1. build — compile the flash-attention forward kernel
   (``trlx_tpu_torch/csrc/flash_fwd.cu``) with ``nvcc`` for ``sm_90a``;
2. kernel — hold the kernel against its plain PyTorch version on the card
   at the serving path's shapes (prefill, decode) and the edge cases
   (causal flag with a padding bias, ragged Q/K, per-head bias), in bf16
   and f32; time the prefill and decode shapes (kernel, plain version,
   ``scaled_dot_product_attention`` as a yardstick the port never calls)
   beside the card's bound;
3. model — full-width GPT-2 in f32 through the kernel against the plain
   attention: the forward without a cache, and prefill + decode through
   the paged cache against the plain full forward of the whole sequence;
4. serving — ``InferenceServer`` on CUDA with the ``configs/ppo_sentiments.yml``
   model at full GPT-2-small width (random weights from a seed, bf16
   compute) serves 64 prompts; every request must complete with finite
   logprobs/values, and the kernel launch count must equal
   12 x (prefill forwards + decode steps).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA, or when any phase fails. ``--profile PATH`` additionally serves the
same traffic under ``torch.profiler`` and writes a device-time summary (busy
share, device time by kernel) as JSON to PATH.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
TOL = {  # max |dO|, max |dLSE| against the plain version
    # f32: the two versions sum in a different order
    "float32": (1e-4, 1e-4),
    # bf16: P is rounded to bf16 before P.V and the plain version
    # normalises before that rounding, the kernel after the sum
    "bfloat16": (2e-2, 1e-3),
}
REPLACES = "trlx_tpu/ops/flash_attention.py:97"
L2_BYTES = 50 * 2**20  # H100 SXM


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fns, warmup: int = 3, rounds: int = 20, per_round: int = 10) -> float:
    """Device time of one call: the median over ``rounds`` of one CUDA
    event pair around ``per_round`` back-to-back calls, divided by
    ``per_round``, so the host's dispatch overlaps the device's work.
    ``fns`` holds one call per copy of the inputs and the calls cycle
    through them, so a call finds its inputs outside the L2 cache, as the
    serving path does."""
    import torch

    for i in range(warmup * len(fns)):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_round):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_round)
    return statistics.median(times)


def input_copies(tensors, nbytes: int):
    """Enough copies of ``tensors`` that one pass over them reads more
    than twice the card's L2 cache (the first copy is the tensors)."""
    n = min(8, 1 + -(-2 * L2_BYTES // nbytes))
    return [tensors] + [[t.clone() for t in tensors] for _ in range(n - 1)]


def kernel_cases(torch, attn):
    """(name, q, k, v, bias, causal) at the serving path's shapes and the
    edge cases; inputs from a fixed seed."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(B, Q, K, H=12, D=64):
        return [
            torch.randn(B, T, H, D, generator=gen, device=dev)
            for T in (Q, K, K)
        ]

    cases = []
    # admission prefill: 8 prompts, Q = 512 columns over a 576-wide cache
    # view; causal + left padding as one [B,1,Q,K] bias (engine layout)
    lens = torch.randint(16, 513, (8,), generator=gen, device=dev)
    cols = torch.arange(576, device=dev)[None, :]
    mask = ((cols >= 512 - lens[:, None]) & (cols < 512)).long()
    bias = attn.causal_bias(512, 576, 0, dev) + attn.padding_bias(mask)
    cases.append(("prefill", *qkv(8, 512, 576), bias, False))
    # decode: 32 slots, one query each at per-row depths, 576-wide cache
    depth = torch.randint(16, 576, (32,), generator=gen, device=dev)
    mask = (torch.arange(576, device=dev)[None, :] <= depth[:, None]).long()
    bias = attn.causal_bias(1, 576, depth, dev) + attn.padding_bias(mask)
    cases.append(("decode", *qkv(32, 1, 576), bias, False))
    # causal flag with a [B,1,1,K] padding bias (training-style forward).
    # As in tests/test_flash_attention.py the first keys stay valid: a
    # causal row that sees only padding keys is a discarded padding row,
    # and there the kernel (like the TPU kernel) averages its visible keys
    # while the plain version also averages the future keys it skips
    keep = torch.arange(320, device=dev)[None, :] < 4
    mask = (torch.rand(4, 320, generator=gen, device=dev) > 0.3) | keep
    cases.append(("causal_padding", *qkv(4, 320, 320), attn.padding_bias(mask.long()), True))
    # Q and K not multiples of 64, full-rank bias; and causal ragged
    bias = torch.randn(2, 1, 77, 141, generator=gen, device=dev)
    cases.append(("ragged", *qkv(2, 77, 141), bias, False))
    cases.append(("ragged_causal", *qkv(3, 100, 100), None, True))
    # per-head bias [1, H, Q, K]
    bias = torch.randn(1, 12, 130, 200, generator=gen, device=dev)
    cases.append(("per_head_bias", *qkv(2, 130, 200), bias, False))
    return cases


def phase_kernel(torch, fa, attn):
    import torch.nn.functional as F

    results, timed = [], {}
    for name, q32, k32, v32, bias, causal in kernel_cases(torch, attn):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, causal, True)
            o, lse = fa.flash_attention(q, k, v, bias, causal, True)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = TOL[dtype_name]
            ok = err_o <= tol_o and err_lse <= tol_lse and math.isfinite(err_o)
            results.append({
                "case": name, "dtype": dtype_name, "max_abs_err_o": err_o,
                "max_abs_err_lse": err_lse, "tol_o": tol_o, "tol_lse": tol_lse,
                "ok": ok,
            })
            log(f"phase 2: {name:15s} {dtype_name:8s} max|dO|={err_o:.3e} "
                f"max|dLSE|={err_lse:.3e} {'ok' if ok else 'FAIL'}")
            if name not in ("prefill", "decode"):
                continue
            B, Q, H, D = q.shape
            K = k.shape[1]
            # each input read once, the output written once
            nbytes = (
                sum(x.numel() * x.element_size() for x in (q, k, v, o))
                + bias.numel() * 4
            )
            copies = input_copies([q, k, v, bias], nbytes)
            kernel_ms = time_ms([
                lambda c=c: fa.flash_attention(*c, causal) for c in copies
            ])
            plain_ms = time_ms([
                lambda c=c: fa.flash_attention_reference(*c, causal)
                for c in copies
            ])
            # the yardstick in its own layout, the mask in the compute dtype
            library = [
                [x.transpose(1, 2) for x in c[:3]] + [c[3].to(dt)] for c in copies
            ]
            library_ms = time_ms([
                lambda c=c: F.scaled_dot_product_attention(*c[:3], attn_mask=c[3])
                for c in library
            ])
            del copies, library
            flops = 4 * B * H * Q * K * D
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            timed[(name, dtype_name)] = {
                "shape": f"B={B} H={H} Q={Q} K={K} D={D}",
                "ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
            }
            row = timed[(name, dtype_name)]
            log(f"phase 2: {name} {dtype_name} {row['shape']}: kernel_ms="
                f"{kernel_ms} plain_ms={plain_ms} library_ms={library_ms} "
                f"bound_ms={row['bound_ms']} ({row['bound_by']})")
    return results, timed


def phase_model(torch, fa):
    """Full-width GPT-2 in f32 through the kernel against the plain
    attention: (a) the forward without a cache (causal flag + padding
    bias); (b) prefill into the paged cache (rotated block tables) and
    greedy decode steps through it, whose logits must agree with the
    plain full forward over the whole sequence. f32 and no TF32, so the
    1e-3 tolerance leaves room only for summation order: a bf16 path
    would miss it."""
    from trlx_tpu_torch.inference.kv_cache import init_paged_cache
    from trlx_tpu_torch.inference.server import init_params
    from trlx_tpu_torch.models import gpt2
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    dev = "cuda"
    cfg = gpt2.GPT2Config(dtype="float32")
    model = CausalLMWithValueHead(cfg, device=dev)
    init_params(model, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B, Q, R = 2, 96, 4
    ids = torch.randint(0, cfg.vocab_size, (B, Q), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[0, :30] = 0  # left padding

    def plain(q, k, v, bias=None, causal=False, **kw):
        return fa.flash_attention_reference(q, k, v, bias, causal)

    def forward(attention, *args, **kw):
        orig = gpt2.dot_product_attention
        gpt2.dot_product_attention = attention
        try:
            with torch.no_grad():
                return model(*args, **kw)
        finally:
            gpt2.dot_product_attention = orig

    launched = fa.FLASH_FWD_LAUNCHES
    out = forward(gpt2.dot_product_attention, ids, attention_mask=mask)
    ref = forward(plain, ids, attention_mask=mask)
    real = mask.bool()
    err_fwd = max(
        (out[k] - ref[k])[real].abs().max().item() for k in ("logits", "values")
    )

    cache = init_paged_cache(cfg.n_layer, B, Q + R, cfg.n_head, 64,
                             torch.float32, block_size=16, device=dev)
    nb = cache[0]["block_tables"].shape[1]
    cache[0]["block_tables"].copy_(torch.stack(
        [torch.roll(torch.arange(nb, device=dev), -t) for t in (1, 4)]
    ).to(torch.int32))
    n_real = mask.sum(-1)
    step = forward(
        gpt2.dot_product_attention, ids,
        attention_mask=torch.cat([mask, mask.new_zeros(B, R)], 1),
        position_ids=(mask.cumsum(-1) - 1).clamp_min(0),
        cache=cache, cache_index=0, last_only=True,
    )["logits"][:, -1]
    seq, seq_mask, steps = ids, mask, [step]
    for t in range(R - 1):
        tok = steps[-1].argmax(-1)
        seq = torch.cat([seq, tok[:, None]], 1)
        seq_mask = torch.cat([seq_mask, mask.new_ones(B, 1)], 1)
        cache_mask = (torch.arange(Q + R, device=dev)[None] <= Q + t).long() * torch.cat(
            [mask, mask.new_ones(B, R)], 1)
        steps.append(forward(
            gpt2.dot_product_attention, tok[:, None], attention_mask=cache_mask,
            position_ids=(n_real + t)[:, None], cache=cache,
            cache_index=torch.full((B,), Q + t, device=dev),
        )["logits"][:, 0])
    full = forward(plain, seq, attention_mask=seq_mask)["logits"]
    err_cache = max(
        (steps[i] - full[:, Q - 1 + i]).abs().max().item() for i in range(R)
    )
    launched = fa.FLASH_FWD_LAUNCHES - launched
    ok = err_fwd <= 1e-3 and err_cache <= 1e-3 and launched == cfg.n_layer * (1 + R)
    log(f"phase 3: full-width f32 GPT-2, kernel vs plain: forward "
        f"max|d(logits, values)|={err_fwd:.3e}; paged prefill + {R - 1} decode "
        f"steps vs plain full forward max|dlogits|={err_cache:.3e}; "
        f"launches={launched} {'ok' if ok else 'FAIL'}")
    return ok


def serving_config():
    """The headline model (configs/ppo_sentiments.yml) at full GPT-2-small
    width with random weights, served with the engine geometry below."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_sentiments.yml")).to_dict()
    cfg["model"].update({
        "model_path": "",  # random weights: the checkpoint is not in the repo
        "tokenizer_path": "",
        "model_arch": {
            "vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
            "n_layer": 12, "n_head": 12,
        },
    })
    cfg["train"].update({
        "seq_length": 512, "dtype": "bfloat16",
        "rollout": {"slots": 32, "admit_width": 8, "harvest_width": 8,
                    "block_size": 16},
    })
    cfg["method"]["gen_kwargs"].update({
        "max_new_tokens": 64, "do_sample": True,
        "eos_token_id": 50256, "pad_token_id": 50256,
    })
    return cfg


def serving_prompts(seed: int = 0):
    """64 int-list prompts, real lengths drawn from 16..512."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        [int(x) for x in rng.integers(0, 50256, int(rng.integers(16, 513)))]
        for _ in range(64)
    ]


def serve(torch, server, prompts):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = server.submit(prompts)
    results = server.wait(rids)
    torch.cuda.synchronize()
    return rids, results, time.perf_counter() - t0


def phase_serving(torch, fa):
    import numpy as np

    from trlx_tpu_torch.inference.server import InferenceServer

    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(serving_config(), seed=0)
    prompts = serving_prompts()

    plain_calls = [0]
    orig_ref = fa.flash_attention_reference

    def counting_ref(*a, **kw):
        plain_calls[0] += 1
        return orig_ref(*a, **kw)

    fa.flash_attention_reference = counting_ref
    fa.FLASH_FWD_LAUNCHES = 0  # count the main path's launches only
    try:
        rids, results, wall = serve(torch, server, prompts)
    finally:
        fa.flash_attention_reference = orig_ref
    launches = fa.FLASH_FWD_LAUNCHES
    stats = server.stats()
    n_layer = server.model_config.n_layer
    expected = n_layer * int(stats["engine/prefills"] + stats["engine/decode_steps"])
    lengths = [results[r]["length"] for r in rids]
    finite = all(
        np.isfinite(results[r]["logprobs"]).all()
        and np.isfinite(results[r]["values"]).all()
        for r in rids
    )
    ttft = sorted(results[r]["timing"]["ttft_ms"] for r in rids)
    tokens = int(sum(lengths))
    record = {
        "requests": len(rids),
        "generated_tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "flash_fwd_launches": launches,
        "expected_launches": expected,
        "plain_attention_calls": plain_calls[0],
        "stats": stats,
    }
    log("phase 4: serving " + json.dumps(record))
    ok = (
        len(results) == 64
        and min(lengths) >= 1
        and finite
        and launches == expected
        and plain_calls[0] == 0
    )
    log(f"phase 4: {'ok' if ok else 'FAIL'} (complete={len(results)}/64, "
        f"min length={min(lengths)}, finite={finite}, launches={launches} "
        f"vs 12 x (prefills + decode steps) = {expected}, plain attention "
        f"calls={plain_calls[0]})")
    return ok, record


def profile_serving(torch, path: str) -> None:
    """``--profile PATH``: serve the same 64 prompts again under
    torch.profiler and summarise the device timeline — busy share of the
    wall, and device time by kernel — as JSON at ``path``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from trlx_tpu_torch.inference.server import InferenceServer

    server = InferenceServer(serving_config(), seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(torch, server, serving_prompts())
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, end = 0.0, -1.0
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in kernels:
        n, total = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, total + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]
    summary = {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
        "kernels_launched": len(kernels),
        "top_kernels": [
            {"name": n[:120], "count": c, "device_ms": t / 1e3,
             "share_of_busy": t / busy}
            for n, (c, t) in top
        ],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    log("profile: " + json.dumps({k: summary[k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "kernels_launched")}))
    for row in summary["top_kernels"][:12]:
        log(f"profile: {row['device_ms']:9.2f} ms {row['share_of_busy']:6.1%} "
            f"x{row['count']:<6d} {row['name'][:90]}")


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="also profile the serving phase; write the summary here")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from trlx_tpu_torch.ops import attention as attn
    from trlx_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    path = fa.build(verbose=True)
    fa._load()
    log(f"phase 1: built {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")

    checks, timed = phase_kernel(torch, fa, attn)
    kernel_ok = all(c["ok"] for c in checks)
    model_ok = phase_model(torch, fa)
    serving_ok, serving = phase_serving(torch, fa)
    if args.profile:
        profile_serving(torch, args.profile)

    def entry(shape):
        return {k: timed[(shape, "bfloat16")][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    decode = entry("decode")
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "trlx_tpu_torch/csrc/flash_fwd.cu",
        "replaces": REPLACES,
        "launches": serving["flash_fwd_launches"],
        "max_abs_err": max(c["max_abs_err_o"] for c in checks),
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "timed_shape": "decode bf16 " + decode["shape"],
        "prefill": entry("prefill"),
        "f32": {s: {k: timed[(s, "float32")][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for s in ("prefill", "decode")},
    }]
    log(", ".join(card) if card else "nvidia-smi: no output")
    print(json.dumps({"kernels": kernels}), flush=True)
    if not (kernel_ok and model_ok and serving_ok):
        failed = [n for n, ok in (("kernel", kernel_ok), ("model", model_ok),
                                  ("serving", serving_ok)) if not ok]
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
