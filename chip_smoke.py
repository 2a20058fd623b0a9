#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: ``python3 chip_smoke.py`` (one H100).

Phases, each fatal on failure:

1. build — compile the flash-attention kernels (``trlx_tpu_torch/csrc/
   flash_fwd.cu``: K1 in three variants, ``tile`` for bf16 with Q > 16 on
   the tensor cores, ``decode`` for bf16 with Q <= 16, ``fma`` for f32;
   ``flash_bwd.cu``: K2 dQ and K3 dK/dV, each ``tile`` for bf16 on the
   tensor cores and ``fma`` for f32, K2 in two instantiations, without and
   with the bias gradient) with ``nvcc`` for ``sm_90a``, both
   sources at once, and beside them each source's device code alone with
   ``ptxas -v`` (every run, so the report holds when the libraries were
   already built); print ``ptxas``'s registers, shared memory and spills
   per kernel, and the count of tensor-core instructions (``HMMA`` or
   ``HGMMA``) in each kernel's SASS (``cuobjdump -sass``). A spill in K1 or
   in a backward tile kernel, one of them missing from the report, or a
   tile kernel without tensor-core instructions fails the phase;
2. kernel — hold K1 against its plain PyTorch version on the card at the
   serving path's shapes (prefill, decode) and the edge cases (causal flag
   with a padding bias, ragged Q/K, per-head bias, 64 key tiles with peaked
   logits), in bf16 and f32; hold
   K1 again at the training path's shapes (the cases below and the rollout
   decode, B=128 Q=1 K=112, and the reference scoring, B=128 Q=K=112
   causal), all-padding causal rows included; hold K2 and
   K3 against the plain backward (fed K1's own O and LSE) at the
   training shape (B=16, T=112, causal + padding bias, and with left
   padding), the rollout-prefill shape (explicit causal + padding bias),
   ragged Q/K with a full-rank bias and a per-head bias, two long
   cases (16 query chunks and key tiles under the causal flag; 64 key
   tiles with peaked logits), and ILQL's update (B=128, T=64, causal +
   right padding), in bf16 (``tile``) and f32 (``fma``); K1 also at ILQL's
   eval prefill (B=128, Q=16, K=64, left padding: the ``decode`` variant
   at its largest Q) and eval decode step (Q=1, K=64);
   hold the autograd ``Function`` against autograd through the plain
   forward; time K1 at the five shapes of the two paths (serving prefill
   and decode, update forward, rollout prefill and decode, ILQL's update
   forward, eval prefill and eval step; the serving two in f32 too) and
   K2, K3 (through their C entry points, arguments packed beforehand, and
   through their Python wrappers) at the PPO and ILQL update shapes
   (kernel, plain version, and a
   PyTorch yardstick the port never calls: ``scaled_dot_product_attention``,
   and for the backward ``torch.autograd.grad`` of its output) beside the
   card's bound; and at the seq2seq path's attention shapes
   (``configs/ppo_ul2.yml``: the update's encoder self, decoder self and
   cross attentions, the sampler's encoder pass and decoder step), hold K1
   and, at the update's three, K2 (with the bias gradient for the two
   self-attentions' learned bias) and K3 in bf16 and f32, and time them in
   bf16 the same way (SDPA's backward with the bias as a grad-carrying
   mask);
3. model — full-width GPT-2 in f32 through the kernels against the plain
   attention: the forward without a cache, prefill + decode through the
   paged cache against the plain full forward of the whole sequence, and
   the gradient of a PPO loss on one minibatch (max relative error per
   parameter group); the same for the full-width f32 T5 of
   ``configs/ppo_ul2.yml``, its relative position tables included; and in
   bf16, the update's logprobs and PPO-loss gradient with
   ``train.logprob_chunk: 16`` against the unchunked head;
4. serving — ``InferenceServer`` on CUDA with the ``configs/ppo_sentiments.yml``
   model at full GPT-2-small width (random weights from a seed, bf16
   compute) serves 64 prompts; every request must complete with finite
   logprobs/values, and the K1 launches must be 12 x prefill forwards
   of the tile variant and 12 x decode steps of the decode variant, with
   no ``fma`` launch and no input copy;
5. training — ``trlx_tpu_torch.train`` on CUDA with the
   ``configs/ppo_sentiments.yml`` geometry at full GPT-2-small width
   (random weights from a seed, bf16 compute, 128 int-list prompts of real
   lengths 16-64, a host reward from the response ids) for two PPO phases
   (64 updates); every stat must be finite, the parameters must move, a
   fresh trainer's ``load`` must restore the saved state exactly, K1 must
   launch 12 x the trainer's forwards (the tile variant 12 x those over
   more than 16 positions, the decode variant 12 x the decode steps, no
   ``fma`` launch and no input copy), K2 and K3 12 x 64 times each, all of
   them the ``tile`` variant with no input copy, and the plain attention
   not at all;
6. seq2seq training — ``trlx_tpu_torch.train`` with the
   ``Seq2SeqPPOTrainer`` on ``configs/ppo_ul2.yml`` at full width, from a
   UL2 checkpoint in HF layout (gated-GELU, untied head, random weights
   from a seed) written by the phase and loaded through
   ``model.model_path`` (bf16 over f32 masters, 128 int-list prompts of
   real lengths 64-512 with a ground truth each, a host reward that reads
   it) for two PPO phases (80 updates); the loaded backbone must equal the
   written tensors, and the gates of phase 5 hold, with K1's ``tile``
   launches = 24 x the teacher-forced forwards + 8 x the sampler's encoder
   passes, ``decode`` = 16 x its decoder calls, K2 = K3 = 24 x the updates
   and K2 with the bias gradient 16 x the updates;
7. the benchmark workload — ``bench.py::_workload_config`` (copied here)
   from a GPT-2-small checkpoint in HF layout written by the phase
   (random weights from a seed, ``transformer.`` names, ``Conv1D`` [in,
   out], no ``lm_head.weight``) through ``trlx_tpu_torch.train(model_path
   =...)``, at both freezing definitions, ``(0, 2)`` and ``(2, None)``,
   each for two PPO phases (64 updates) with a 2-layer hydra KL reference;
   two named deviations (``kv_cache_dtype`` bf16 for ``"auto"``, health
   off). Gates: the loaded backbone equals the written tensors before the
   first update; the reference holds 2 blocks, ``wte`` and ``ln_f``
   (52 774 656 parameters against the full copy's 124 439 808); 12 K1
   ``tile`` launches per reference scoring, ``tile`` = 12 x the forwards
   that are not decode steps and ``decode`` = 12 x those; K2 = K3 = 12 x
   the updates under ``(0, 2)`` and 2 x under ``(2, None)``, all ``tile``;
   under ``(2, None)`` the bottom 10 blocks, ``wte`` and ``wpe``
   bit-identical after training and the top 2 blocks, ``ln_f`` and the
   value head moved; every stat finite; then an ``InferenceServer``
   restores the run's checkpoint (bit for bit, after its compute-dtype
   cast) and serves 8 of the prompts to completion with finite logprobs
   and values.

8. offline ILQL — ``trlx_tpu_torch.train(dataset=..., model_path=...)`` on
   ``configs/ilql_sentiments.yml`` as written (bf16 over f32 masters,
   ``seq_length`` 64, batch 128, two Q heads, tau 0.7, gamma 0.99, CQL 0.1,
   AWAC 1.0, alpha 0.005, a target sync every 5 updates, beta 4; the eval
   decode's defaults: 48 new tokens, top_k 20, sampled) from a GPT-2-small
   checkpoint in HF layout written by the phase, on 2048 synthetic
   (token_list, action_start) samples from a seed, for 32 updates (two
   epochs of 16 minibatches) with evals at 0, 16 and 32; named
   deviations: random weights, synthetic data, no tokenizer, 32 of 1000
   updates. Gates: the loaded backbone equals the written tensors; every
   stat finite; the parameters and the Q heads moved; after every update
   the target heads are ``alpha * q + (1 - alpha) * previous`` bit for bit
   on the 6 sync steps (5, 10, .., 30) and bit-identical to before on the
   rest; K1 ``tile`` = 12 x the update forwards, ``decode`` = 12 x the eval
   decode's forwards (its Q = 16 prefills and Q = 1 steps), K2 = K3 = 12 x
   32, all ``tile``, no ``fma`` launch, input copy or plain-attention call;
   a fresh trainer's ``load`` restores the saved state exactly, target
   heads and generator included; every eval's logprobs finite and its
   sampled tokens within the top 20 of the shifted logits. Prints the wall
   with the checkpoint load timed apart, updates/s, eval tokens/s and the
   peak memory from a clean start;

9. GRPO — ``trlx_tpu_torch.train`` on ``configs/grpo_sentiments.yml`` as
   written (groups of 8: 16 prompts x 8 per 128-rollout chunk, batch 16,
   4 epochs, no value loss, bf16 over f32 masters) from a GPT-2-small
   checkpoint in HF layout written by the smoke, for two phases (64
   updates; named deviations: random weights, token-id prompts and
   reward, 64 of 10 000 updates). Gates: the loaded bits; finite stats;
   moved parameters; every stored group of 8 holds one prompt; every group
   whose KL-shaped returns have a population std above 1e-2 has stored
   advantages of mean |.| < 1e-4 and population std within 1e-3 of 1; the
   value head's gradient exactly zero after every update (its first Adam
   moment stays 0); K1 by variant as phase 5 counts it, K2 = K3 = 12 x 64
   ``tile``; ``load`` exact. Then a cut seq2seq GRPO run:
   ``configs/ppo_ul2.yml`` through the ``Seq2SeqGRPOTrainer`` (groups of
   4, one phase of 40 updates) from a UL2 checkpoint written here, with
   the same group and value-head gates and K2 with the bias gradient 16 x
   the updates;
10. continuous-engine PPO — ``configs/ppo_sentiments.yml`` with
   ``train.rollout: {engine: continuous}`` (128 slots, admit and harvest
   32, block 16, poll 1) from the same checkpoint, two phases (64
   updates). Gates per collect phase: 128 rows admitted, completed and
   recycled, none pending, 0 < slot_util <= 1, each draw index once in the
   buffer, K1 ``tile`` = 12 x (admission prefills + reference scorings)
   and ``decode`` = 12 x decode steps; over the run phase 5's gates. Then
   the fixed sampler under per-row RNG and the engine decode the same 128
   prompts at one phase seed and the share of rows with identical tokens
   is printed (a report: bf16 and another batch shape can flip a
   near-tie), with the engine's host time per decode step.

Each path (phases 4 to 10, each definition of phase 7 and each run of
phase 9 on its own) runs with the launch counters set to 0 just before it
and read just after, and its peak memory is read from a clean start.
Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without CUDA, or when any phase fails. ``--profile PATH`` additionally
serves the same traffic, runs one training phase, a cut seq2seq run, one
phase of each phase-7 definition, one epoch of phase 8 and one phase each
of phases 9 (causal) and 10 under ``torch.profiler`` and writes each run's
device-time summary (busy share, device time by kernel) as JSON to PATH.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import os
import re
import statistics
import struct
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
# max |dQ|, |dK|, |dV| against the plain backward fed the same O and LSE,
# as a fraction of max(1, max |reference|):
BWD_TOL = {
    # f32: only the order of the sums differs
    "float32": 1e-4,
    # bf16: both round an f32 sum (taken in another order) to bf16, and dQ
    # also the bf16 cast of dS: up to 2 bf16 ulps (2^-8 each) at the top
    "bfloat16": 1 / 128,
}
REPLACES = {
    "flash_fwd": "trlx_tpu/ops/flash_attention.py:97",
    "flash_bwd_dq": "trlx_tpu/ops/flash_attention.py:211",
    "flash_bwd_dkv": "trlx_tpu/ops/flash_attention.py:265",
}
SOURCES = {
    "flash_fwd": "trlx_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "trlx_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "trlx_tpu_torch/csrc/flash_bwd.cu",
}
L2_BYTES = 50 * 2**20  # H100 SXM
N_LAYER = 12  # GPT-2 small
FWD_VARIANT_COUNTERS = {
    "tile": "FLASH_FWD_TILE_LAUNCHES",
    "decode": "FLASH_FWD_DECODE_LAUNCHES",
    "fma": "FLASH_FWD_FMA_LAUNCHES",
}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
BWD_VARIANTS = ("tile", "fma")


def write_safetensors(tensors: dict, path: str) -> None:
    """Write ``{name: tensor}`` as a ``.safetensors`` file, the layout HF
    checkpoints use: an 8-byte little-endian header length, a JSON header
    (per tensor its dtype, shape and byte offsets), then the tensors'
    bytes in the header's order."""
    import torch

    codes = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64"}
    flat = {n: tensors[n].detach().contiguous().cpu().reshape(-1) for n in sorted(tensors)}
    header, offset = {}, 0
    for name, t in flat.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the format pads the header to 8 bytes
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for t in flat.values():
            fh.write(t.view(torch.uint8).numpy())


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


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) from ``nvcc -Xptxas=-v``'s output:
    registers, shared memory bytes, spill store and load bytes."""
    rows, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            rows.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.setdefault(fn, {}).update(
                registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
    return rows


def tensor_core_instructions(fa, library: str) -> dict:
    """``{kernel: count of HMMA/HGMMA instructions}`` in each kernel of a
    built library's SASS (``cuobjdump -sass``)."""
    cuobjdump = os.path.join(os.path.dirname(fa._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump if os.path.exists(cuobjdump) else "cuobjdump", "-sass", library],
        capture_output=True, text=True, check=True,
    ).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    return counts


# per library, the kernels phase 1 gates, each by a piece of its mangled
# name: each in the ptxas report with no spill; the tile kernels also with
# tensor-core instructions in their SASS. K2's tile kernel has two
# instantiations, without the bias gradient (<false>, ILb0E) and with it
# (<true>, ILb1E), gated apart
GATED_KERNELS = {
    "flash_fwd": {k: k for k in (
        "flash_fwd_tile_kernel", "flash_fwd_decode_kernel", "flash_fwd_fma_kernel")},
    "flash_bwd": {
        "flash_bwd_dq_tile_kernel": "flash_bwd_dq_tile_kernelILb0E",
        "flash_bwd_dq_tile_kernel_dbias": "flash_bwd_dq_tile_kernelILb1E",
        "flash_bwd_dkv_tile_kernel": "flash_bwd_dkv_tile_kernel",
    },
}
TILE_KERNELS = ("flash_fwd_tile_kernel", "flash_bwd_dq_tile_kernel",
                "flash_bwd_dq_tile_kernel_dbias", "flash_bwd_dkv_tile_kernel")


def phase_build(fa) -> tuple:
    """Build both sources and, at the same time, compile their device code
    again with ``ptxas -v`` (so the report exists whether or not the
    libraries were already built); report registers, shared memory and
    spills per kernel and the tensor-core instructions of each kernel.
    Returns ``(ok, record)``; the record holds, per gated kernel, its
    registers, spill bytes (None when missing from the report) and, for
    the tile kernels, the HMMA/HGMMA count."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        reports = pool.submit(fa.ptxas_reports)
        paths = fa.build()
        reports = reports.result()
    fa._load()
    seconds = time.perf_counter() - t0
    log(f"phase 1: built {', '.join(os.path.relpath(p) for p in paths.values())} "
        f"and the ptxas reports in {seconds:.1f} s")
    record, mma, patterns = {}, {}, {}
    for name, kernels in GATED_KERNELS.items():
        ptxas = ptxas_report(reports[name])
        for fn, row in sorted(ptxas.items()):
            log(f"phase 1: ptxas {fn}: {json.dumps(row)}")
        patterns.update(kernels)
        for kernel, pattern in kernels.items():
            rows = [r for fn, r in ptxas.items() if pattern in fn]
            spills = [r.get("spill_bytes") for r in rows]
            record[kernel] = {
                "registers": max((r.get("registers", 0) for r in rows), default=None),
                "spill_bytes": sum(spills) if rows and None not in spills else None,
            }
        mma.update(tensor_core_instructions(fa, paths[name]))
    log(f"phase 1: tensor-core instructions (HMMA/HGMMA) per kernel: {json.dumps(mma)}")
    for kernel in TILE_KERNELS:
        record[kernel]["tensor_core_instructions"] = sum(
            n for fn, n in mma.items() if patterns[kernel] in fn)
    missing = [k for k, r in record.items() if r["spill_bytes"] is None]
    ok = not missing and all(r["spill_bytes"] == 0 for r in record.values()) and all(
        record[k]["tensor_core_instructions"] > 0 for k in TILE_KERNELS)
    log(f"phase 1: {'ok' if ok else 'FAIL'} ({json.dumps(record)}"
        f"{f'; missing from the ptxas report: {missing}' if missing else ''})")
    return ok, record


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
    # 64 key tiles, peaked logits and a per-row bias: P is the register A
    # operand of O += P V in every key tile of the tile variant, and a P
    # fragment that went stale or out of order between tiles would weight
    # the wrong V rows (V / 4 keeps |O| near 1, the scale TOL is set for)
    q, k, v = qkv(2, 128, 4096)
    bias = 2 * torch.randn(2, 1, 128, 4096, generator=gen, device=dev)
    cases.append(("long_k", 3 * q, k, v / 4, bias, False))
    return cases


def packed_forward_calls(torch, fa, copies, causal):
    """Per input copy, a zero-argument call of K1's C entry point with its
    arguments packed and its output allocated once (no LSE, as the path's
    no-grad calls), so that a timed call is the launch and not the Python
    wrapper around it. Returns ``(calls, outputs)``."""
    lib = fa._load()["flash_fwd"]
    stream = torch.cuda.current_stream().cuda_stream
    calls, outputs = [], []
    for q, k, v, bias in copies:
        B, Q, H, D = q.shape
        K = k.shape[1]
        b, sb = fa._bias_view(bias, B, H, Q, K)
        o = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device)
        outputs.append((b, o))
        calls.append(functools.partial(
            lib.trlx_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b.data_ptr() if b is not None else None, o.data_ptr(), None,
            fa.FORWARD_VARIANTS[fa.forward_variant(q.dtype, Q)], fa._DTYPES[q.dtype],
            B, H, Q, K, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *sb,
            float(D ** -0.5), int(bool(causal)), stream))
    return calls, outputs


def time_forward(torch, fa, attn, q, k, v, bias, causal) -> dict:
    """K1's time on these inputs beside its bound, the plain version's time
    and SDPA's (the yardstick the port never calls; a causal call takes the
    causal and padding masks as one mask in the compute dtype). ``ms`` is
    the C entry point's (arguments packed beforehand), ``wrapper_ms`` the
    Python wrapper's; ``packed_ok`` says the packed call launched and gave
    the wrapper's output."""
    import torch.nn.functional as F

    B, Q, H, D = q.shape
    K = k.shape[1]
    dtype_name = str(q.dtype).replace("torch.", "")
    # each input read once, the output written once; the operations over
    # the (query, key) pairs of the tiles K1 visits
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q)) + (
        bias.numel() * 4 if bias is not None else 0)
    pairs = int(fa.visited_keys(Q, K).sum()) if causal else Q * K
    flops = 4 * B * H * D * pairs
    copies = input_copies([q, k, v, bias], nbytes)
    calls, outputs = packed_forward_calls(torch, fa, copies, causal)
    kernel_ms = time_ms(calls)
    rc = calls[0]()
    torch.cuda.synchronize()
    packed_ok = rc == 0 and torch.equal(outputs[0][1], fa.flash_attention(q, k, v, bias, causal))
    del calls, outputs
    wrapper_ms = time_ms([lambda c=c: fa.flash_attention(*c, causal) for c in copies])
    plain_ms = time_ms([
        lambda c=c: fa.flash_attention_reference(*c, causal) for c in copies
    ])
    mask = bias
    if causal:
        mask = attn.causal_bias(Q, K, 0, q.device) + (0 if bias is None else bias)
    library = [
        [x.transpose(1, 2) for x in c[:3]] + [None if mask is None else mask.to(q.dtype)]
        for c in copies
    ]
    library_ms = time_ms([
        lambda c=c: F.scaled_dot_product_attention(*c[:3], attn_mask=c[3])
        for c in library
    ])
    del copies, library
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {
        "shape": f"B={B} H={H} Q={Q} K={K} D={D}" + (" causal" if causal else "")
                 + (f", bias {list(bias.shape)}" if bias is not None else ""),
        "variant": fa.forward_variant(q.dtype, Q),
        "ms": kernel_ms, "wrapper_ms": wrapper_ms, "packed_ok": packed_ok,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def log_timed(name, dtype_name, row):
    log(f"phase 2: time {name} {dtype_name} {row['shape']} ({row['variant']}): "
        f"kernel_ms={row['ms']} wrapper_ms={row['wrapper_ms']} plain_ms={row['plain_ms']} "
        f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} ({row['bound_by']}); "
        f"packed call gives the wrapper's output: {'ok' if row['packed_ok'] else 'FAIL'}")


def phase_kernel(torch, fa, attn):
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
            log(f"phase 2: {name:15s} {dtype_name:8s} ({fa.forward_variant(dt, q.shape[1])}) "
                f"max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e} {'ok' if ok else 'FAIL'}")
            if name in ("prefill", "decode"):
                timed[("serving_" + name, dtype_name)] = row = time_forward(
                    torch, fa, attn, q, k, v, bias, causal)
                log_timed("serving_" + name, dtype_name, row)
    return results, timed


# no backward runs at these shapes
FORWARD_ONLY = ("decode", "ref_scoring", "ilql_eval_prefill", "ilql_eval_decode",
                "engine_prefill", "engine_decode")
# the training paths' K1 shapes, timed in bf16 (backward_cases names)
TRAINING_SHAPES = {"train": "update_forward", "prefill": "rollout_prefill",
                   "decode": "rollout_decode", "ref_scoring": "ref_scoring",
                   "ilql_update": "ilql_update_forward",
                   "ilql_eval_prefill": "ilql_eval_prefill",
                   "ilql_eval_decode": "ilql_eval_decode",
                   "engine_prefill": "engine_admission_prefill"}
# the backward_cases whose K2/K3 are timed in bf16: PPO's and ILQL's update
TIMED_BACKWARD = ("train", "ilql_update")


def backward_cases(torch, attn):
    """(name, q, k, v, bias, causal) at the training path's shapes (update
    forward, rollout prefill and decode) and the edge cases, in f32; inputs
    from a fixed seed. K1 is held at each, K2/K3 at all but
    ``FORWARD_ONLY``."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def qkv(B, Q, K, H=12, D=64):
        return [torch.randn(B, T, H, D, generator=gen, device=dev) for T in (Q, K, K)]

    cases = []
    # the training forward: [query; response] of 64 + 48 under the causal
    # flag with a [B,1,1,K] padding bias; first keys valid (no row sees only
    # padding), and then PPO's left padding, where rows before a row's first
    # real token see only padding keys (generic dO there: the kernels must
    # still follow the forward's tile visits, as the TPU kernel defines it)
    keep = torch.arange(112, device=dev)[None, :] < 4
    mask = (torch.rand(16, 112, generator=gen, device=dev) > 0.2) | keep
    cases.append(("train", *qkv(16, 112, 112), attn.padding_bias(mask.long()), True))
    lens = torch.randint(16, 65, (16,), generator=gen, device=dev)
    mask = (torch.arange(112, device=dev)[None, :] >= 64 - lens[:, None]).long()
    cases.append(("train_left_pad", *qkv(16, 112, 112), attn.padding_bias(mask), True))
    # the rollout prefill: 64 prompt columns over the 112-wide cache, the
    # causal structure and left padding as one explicit bias
    cols = torch.arange(112, device=dev)[None, :]
    mask = ((cols >= 64 - lens[:, None].repeat(8, 1)) & (cols < 64)).long()
    bias = attn.causal_bias(64, 112, 0, dev) + attn.padding_bias(mask)
    cases.append(("prefill", *qkv(128, 64, 112), bias, False))
    # the rollout decode step (K1 only): one query at cache column 64 + t
    # over the 112-wide cache, the shifted causal mask and left padding as
    # one explicit bias
    t = int(torch.randint(0, 48, (), generator=gen, device=dev))
    mask = ((cols >= 64 - lens[:, None].repeat(8, 1)) & (cols <= 64 + t)).long()
    bias = attn.causal_bias(1, 112, 64 + t, dev) + attn.padding_bias(mask)
    cases.append(("decode", *qkv(128, 1, 112), bias, False))
    # the reference scoring (K1 only, no grad): all 128 rollouts' [query;
    # response] under the causal flag with their left padding
    mask = (torch.arange(112, device=dev)[None, :] >= 64 - lens[:, None].repeat(8, 1)).long()
    cases.append(("ref_scoring", *qkv(128, 112, 112), attn.padding_bias(mask), True))
    # ILQL (configs/ilql_sentiments.yml): the update forward over 128
    # right-padded samples of 9..64 tokens under the causal flag; the eval
    # prefill, 16 left-padded prompt columns over the 64-wide cache (K1's
    # decode variant at its largest Q); and an eval decode step at cache
    # column 16 + t
    n_tok = torch.randint(9, 65, (128,), generator=gen, device=dev)
    cols = torch.arange(64, device=dev)[None, :]
    cases.append(("ilql_update", *qkv(128, 64, 64), attn.padding_bias((cols < n_tok[:, None]).long()),
                  True))
    prompt = torch.randint(8, 17, (128,), generator=gen, device=dev)
    mask = ((cols >= 16 - prompt[:, None]) & (cols < 16)).long()
    bias = attn.causal_bias(16, 64, 0, dev) + attn.padding_bias(mask)
    cases.append(("ilql_eval_prefill", *qkv(128, 16, 64), bias, False))
    t = int(torch.randint(0, 48, (), generator=gen, device=dev))
    mask = ((cols >= 16 - prompt[:, None]) & (cols <= 16 + t)).long()
    bias = attn.causal_bias(1, 64, 16 + t, dev) + attn.padding_bias(mask)
    cases.append(("ilql_eval_decode", *qkv(128, 1, 64), bias, False))
    cases.append(("ragged_bias", *qkv(2, 77, 141), torch.randn(2, 1, 77, 141, generator=gen, device=dev), False))
    cases.append(("per_head_bias", *qkv(2, 130, 200), torch.randn(1, 12, 130, 200, generator=gen, device=dev), False))
    # long: 16 query chunks and 16 key tiles under the causal flag with a
    # padding bias; and 64 key tiles with peaked logits (x3 and a per-row
    # bias) and V / 4, as K1's long_k. A register A operand that went stale
    # or out of order between chunks or tiles, or a ring fault, shows here
    keep = torch.arange(1024, device=dev)[None, :] < 4
    mask = (torch.rand(2, 1024, generator=gen, device=dev) > 0.2) | keep
    cases.append(("long_causal", *qkv(2, 1024, 1024), attn.padding_bias(mask.long()), True))
    q, k, v = qkv(2, 128, 4096)
    bias = 2 * torch.randn(2, 1, 128, 4096, generator=gen, device=dev)
    cases.append(("long_k", 3 * q, k, v / 4, bias, False))
    # the continuous engine (phase 10; K1 only): an admission prefill of 32
    # prompts, 64 columns over the 112-wide paged view, causal from column
    # 0 and left padding as one [32, 1, 64, 112] bias; and one decode step
    # of 128 slots, each at its own column 64 + t
    lens = torch.randint(16, 65, (128, 1), generator=gen, device=dev)
    cols = torch.arange(112, device=dev)[None, :]
    mask = ((cols >= 64 - lens[:32]) & (cols < 64)).long()
    bias = attn.causal_bias(64, 112, 0, dev) + attn.padding_bias(mask)
    cases.append(("engine_prefill", *qkv(32, 64, 112), bias, False))
    t = torch.randint(0, 48, (128,), generator=gen, device=dev)
    mask = ((cols >= 64 - lens) & (cols <= 64 + t[:, None])).long()
    bias = attn.causal_bias(1, 112, 64 + t, dev) + attn.padding_bias(mask)
    cases.append(("engine_decode", *qkv(128, 1, 112), bias, False))
    return cases


def backward_bound(fa, q, k, bias, causal, dtype_name):
    """The least time of K2 and of K3 for these inputs: FLOPs over the
    (query, key) pairs of the tiles the forward visits (all pairs without
    the causal flag), bytes with each input read once and each output
    written once."""
    B, Q, H, D = q.shape
    K = k.shape[1]
    pairs = int(fa.visited_keys(Q, K).sum()) if causal else Q * K
    item = q.element_size()
    tensor = B * Q * H * D * item  # q, o, dO, dQ
    kv = B * K * H * D * item  # k, v, dK, dV
    extra = (bias.numel() * 4 if bias is not None else 0) + B * H * Q * 4  # bias, LSE
    out = {}
    for name, flops_per_pair, nbytes in (
        # S, dP, dQ products; reads q k v o dO, writes dQ
        ("flash_bwd_dq", 6, 4 * tensor + 2 * kv + extra),
        # S, dP, dV, dK products; reads q k v o dO, writes dK dV
        ("flash_bwd_dkv", 8, 3 * tensor + 4 * kv + extra),
    ):
        flops = flops_per_pair * D * pairs * B * H
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = {
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
    return out


def visited_reference(torch, fa, q, k, v, bias, causal):
    """K1's function in plain ops: the plain forward, restricted under the
    causal flag to the keys of the tiles K1 visits. On a causal row whose
    visible keys are all padding (PPO's left padding) every visited key
    sits at NEG_INF, and K1 averages exactly those keys, as the TPU kernel
    does; the unrestricted plain forward would average all K. On every
    other row the keys left out carry no weight either way."""
    if causal:
        Q, K = q.shape[1], k.shape[1]
        skip = torch.zeros(Q, K, device=q.device).masked_fill_(
            ~fa.visited_keys(Q, K, q.device), float("-inf"))
        bias = skip if bias is None else bias.float() + skip
    return fa.flash_attention_reference(q, k, v, bias, causal, True)


def packed_backward_calls(torch, fa, copies, causal):
    """Per input copy, zero-argument calls of the dQ and the dK/dV kernels'
    C entry points, their arguments packed and their outputs allocated
    once, so that a timed call is the launch and not the Python wrapper
    around it. Returns ``(dq_calls, dkv_calls, outputs)``; ``outputs``
    keeps the packed tensors alive."""
    lib = fa._load()["flash_bwd"]
    stream = torch.cuda.current_stream().cuda_stream
    dq_calls, dkv_calls, outputs = [], [], []
    for c in copies:
        _, inputs, common = fa._backward_args(*c, causal)
        ptrs = fa._pointers(inputs)
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in inputs[:3])
        outputs.append((inputs, dq, dk, dv))
        dq_calls.append(functools.partial(
            lib.trlx_flash_bwd_dq, *ptrs, dq.data_ptr(), None, *common, stream))
        dkv_calls.append(functools.partial(
            lib.trlx_flash_bwd_dkv, *ptrs, dk.data_ptr(), dv.data_ptr(), *common, stream))
    return dq_calls, dkv_calls, outputs


def phase_backward(torch, fa, attn):
    """K1 against its plain version at the training path's shapes; K2 and
    K3 against the plain backward; the autograd Function against autograd
    through the plain forward; K1 times at the training paths' shapes and
    K2/K3 times at PPO's and ILQL's update (``timed`` keyed by (case,
    kernel)). Returns ``(fwd_results, bwd_results, fwd_timed, timed)``."""
    import torch.nn.functional as F

    fwd_results, results, fwd_timed, timed = [], [], {}, {}
    for name, q32, k32, v32, bias, causal in backward_cases(torch, attn):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            o, lse = fa.flash_attention(q, k, v, bias, causal, True)
            o_ref, lse_ref = visited_reference(torch, fa, q, k, v, bias, causal)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = TOL[dtype_name]
            ok = math.isfinite(err_o) and err_o <= tol_o and err_lse <= tol_lse
            fwd_results.append({
                "case": "train_path_" + name, "dtype": dtype_name,
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "tol_o": tol_o, "tol_lse": tol_lse, "ok": ok,
            })
            log(f"phase 2: fwd {name:14s} {dtype_name:8s} B={q.shape[0]} Q={q.shape[1]} "
                f"K={k.shape[1]} ({fa.forward_variant(dt, q.shape[1])}) max|dO|={err_o:.3e} "
                f"max|dLSE|={err_lse:.3e} {'ok' if ok else 'FAIL'}")
            if name in TRAINING_SHAPES and dtype_name == "bfloat16":
                shape = TRAINING_SHAPES[name]
                fwd_timed[(shape, dtype_name)] = row = time_forward(
                    torch, fa, attn, q, k, v, bias, causal)
                log_timed(shape, dtype_name, row)
            if name in FORWARD_ONLY:
                continue
            gen = torch.Generator(device="cuda")
            gen.manual_seed(2)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            got = fa._launch_backward(q, k, v, bias, o, lse, do, causal)
            want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal)
            torch.cuda.synchronize()
            row = {"case": name, "dtype": dtype_name, "variant": fa.backward_variant(dt)}
            ok = True
            for key, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                tol = BWD_TOL[dtype_name] * max(1.0, w.float().abs().max().item())
                row[f"max_abs_err_{key}"], row[f"tol_{key}"] = err, tol
                ok = ok and math.isfinite(err) and err <= tol
            row["ok"] = ok
            results.append(row)
            log(f"phase 2: bwd {name:14s} {dtype_name:8s} ({row['variant']}) "
                f"max|ddQ|={row['max_abs_err_dq']:.3e} "
                f"max|ddK|={row['max_abs_err_dk']:.3e} max|ddV|={row['max_abs_err_dv']:.3e} "
                f"(tol {row['tol_dq']:.1e}/{row['tol_dk']:.1e}/{row['tol_dv']:.1e}) "
                f"{'ok' if ok else 'FAIL'}")
            if name not in TIMED_BACKWARD or dtype_name != "bfloat16":
                continue
            B, T = q.shape[:2]
            tensors = [q, k, v, bias, o, lse, do]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            copies = input_copies(tensors, nbytes)
            dq_calls, dkv_calls, packed = packed_backward_calls(torch, fa, copies, causal)
            kernel_dq = time_ms(dq_calls)
            kernel_dkv = time_ms(dkv_calls)
            # the packed calls launch without error and compute what the
            # wrappers computed (the kernels are deterministic)
            rcs = [dq_calls[0](), dkv_calls[0]()]
            torch.cuda.synchronize()
            same = rcs == [0, 0] and all(
                torch.equal(a, b) for a, b in zip(packed[0][1:], got))
            results.append({"case": name + "_packed_calls", "dtype": dtype_name, "ok": same,
                            "max_abs_err_dq": 0.0, "max_abs_err_dk": 0.0,
                            "max_abs_err_dv": 0.0})
            log(f"phase 2: packed K2/K3 calls at {name} rc={rcs}, outputs equal the wrappers': "
                f"{'ok' if same else 'FAIL'}")
            del packed, dq_calls, dkv_calls
            wrapper = {
                "flash_bwd_dq": time_ms([lambda c=c: fa._launch_dq(*c, causal) for c in copies]),
                "flash_bwd_dkv": time_ms([lambda c=c: fa._launch_dkv(*c, causal) for c in copies]),
            }
            plain = time_ms([
                lambda c=c: fa.flash_attention_backward_reference(*c, causal) for c in copies
            ])
            # the yardstick: SDPA's whole backward (dQ, dK, dV in one call)
            # with its forward taken outside the timed window; the causal
            # and padding masks as one additive mask in the compute dtype
            full_mask = (attn.causal_bias(T, T, 0, "cuda") + bias).to(dt)
            graphs = []
            for c in copies:
                ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in c[:3])
                out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=full_mask)
                graphs.append((out, (ql, kl, vl), c[6].transpose(1, 2)))
            library = time_ms([
                lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
                for g in graphs
            ])
            del copies, graphs
            bounds = backward_bound(fa, q, k, bias, causal, dtype_name)
            for kname, ms in (("flash_bwd_dq", kernel_dq), ("flash_bwd_dkv", kernel_dkv)):
                row = timed[(name, kname)] = {
                    "shape": f"B={B} H=12 Q=K={T} D=64 causal, bias {list(bias.shape)}",
                    "variant": fa.backward_variant(dt), "ms": ms, "wrapper_ms": wrapper[kname],
                    "plain_ms": plain, "library_ms": library, **bounds[kname],
                }
                log(f"phase 2: {kname} bf16 {name} {row['shape']} ({row['variant']}): "
                    f"kernel_ms={ms} wrapper_ms={wrapper[kname]} "
                    f"plain_ms={plain} (whole plain backward) library_ms={library} "
                    f"(SDPA's whole backward) bound_ms={bounds[kname]['bound_ms']} "
                    f"({bounds[kname]['bound_by']})")

    # the autograd Function (K1 forward, K2 + K3 backward) end to end
    # against autograd through the plain forward, f32, training shape
    name, q32, k32, v32, bias, causal = backward_cases(torch, attn)[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    w = torch.randn(q32.shape, generator=gen, device="cuda")
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        xs = [x.clone().requires_grad_() for x in (q32, k32, v32)]
        grads.append(torch.autograd.grad((fn(*xs, bias, causal) * w).sum(), xs))
    errs = [(g - r).abs().max().item() for g, r in zip(*grads)]
    tols = [BWD_TOL["float32"] * max(1.0, r.abs().max().item()) for r in grads[1]]
    ok = all(e <= t for e, t in zip(errs, tols))
    results.append({"case": "function_vs_autograd", "dtype": "float32", "ok": ok,
                    "max_abs_err_dq": errs[0], "max_abs_err_dk": errs[1],
                    "max_abs_err_dv": errs[2]})
    log(f"phase 2: autograd Function vs autograd of the plain forward (f32, {name}): "
        f"max|d(dq, dk, dv)|={errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} {'ok' if ok else 'FAIL'}")
    return fwd_results, results, fwd_timed, timed


def phase_model(torch, fa):
    """Full-width GPT-2 in f32 through the kernel against the plain
    attention: (a) the forward without a cache (causal flag + padding
    bias); (b) prefill into the paged cache (rotated block tables) and
    greedy decode steps through it, whose logits must agree with the
    plain full forward over the whole sequence. f32 and no TF32, so the
    1e-3 tolerance leaves room only for summation order: a bf16 path
    would miss it."""
    from trlx_tpu_torch.inference.kv_cache import init_paged_cache
    from trlx_tpu_torch.models import gpt2
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params

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

UL2_HEADS = 8  # configs/ppo_ul2.yml
# the seq2seq path's attention shapes (configs/ppo_ul2.yml: batch 12, chunk
# 16, 512 encoder columns, 49 new tokens, 8 heads): name -> (B, Q, K, bias
# kind, whether the update differentiates it). The update's two
# self-attentions carry the learned bias [B, H, Q, K] (relative table plus
# masks), so K2 returns its gradient; cross-attention has a [B, 1, 1, K]
# padding bias. The sampler's shapes run K1 only.
T5_SHAPES = {
    "t5_encoder_self": (12, 512, 512, "encoder", True),
    "t5_decoder_self": (12, 49, 49, "decoder", True),
    "t5_cross": (12, 49, 512, "cross", True),
    "t5_sampler_encode": (16, 512, 512, "encoder", False),
    "t5_sampler_self": (16, 1, 50, "decoder_step", False),
    "t5_sampler_cross": (16, 1, 512, "cross", False),
}


def t5_case(torch, attn, name):
    """(q, k, v, bias) f32 at one of ``T5_SHAPES``, from a fixed seed: a
    N(0, 1) relative table, prompt masks of real lengths 64-512 (left
    padding), the decoder's causal mask and its mask [1, response mask[:-1]],
    as models/t5.py sums them."""
    B, Q, K, kind, _ = T5_SHAPES[name]
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(20 + list(T5_SHAPES).index(name))
    q, k, v = (torch.randn(B, T, UL2_HEADS, 64, generator=gen, device=dev) for T in (Q, K, K))
    if kind in ("encoder", "cross"):
        lens = torch.randint(64, 513, (B,), generator=gen, device=dev)
        pad = attn.padding_bias((torch.arange(K, device=dev)[None] >= K - lens[:, None]).long())
        if kind == "cross":
            return q, k, v, pad
        return q, k, v, torch.randn(1, UL2_HEADS, Q, K, generator=gen, device=dev) + pad
    lens = torch.randint(1, K + 1, (B,), generator=gen, device=dev)
    dec_mask = (torch.arange(K, device=dev)[None] < lens[:, None]).long()
    if kind == "decoder":  # teacher-forced: Q = K response positions
        table = torch.randn(1, UL2_HEADS, Q, K, generator=gen, device=dev)
        return q, k, v, table + attn.causal_bias(Q, K, 0, dev) + attn.padding_bias(dec_mask)
    # one sampler step at cache slot t of K: row t of the table, the
    # causal mask at t and the slots written so far
    t = int(torch.randint(1, K, (), generator=gen, device=dev))
    table = torch.randn(1, UL2_HEADS, 1, K, generator=gen, device=dev)
    written = (torch.arange(K, device=dev)[None] <= t).long().expand(B, K)
    return q, k, v, table + attn.causal_bias(1, K, t, dev) + attn.padding_bias(written)


def packed_dbias_calls(torch, fa, copies):
    """Per input copy, a zero-argument call of K2's C entry point with the
    bias gradient (arguments packed, outputs allocated once). Returns
    ``(calls, outputs)``."""
    lib = fa._load()["flash_bwd"]
    stream = torch.cuda.current_stream().cuda_stream
    calls, outputs = [], []
    for c in copies:
        _, inputs, common = fa._backward_args(*c, False)
        B, H, Q, K = common[2:6]
        dq = torch.empty(inputs[0].shape, dtype=inputs[0].dtype, device="cuda")
        dbias = torch.empty((B, H, Q, K), device="cuda")
        outputs.append((inputs, dq, dbias))
        calls.append(functools.partial(
            lib.trlx_flash_bwd_dq, *fa._pointers(inputs), dq.data_ptr(), dbias.data_ptr(),
            *common, stream))
    return calls, outputs


def phase_t5_kernels(torch, fa, attn):
    """K1 against its plain version at the seq2seq path's six attention
    shapes, and K2 (with the bias gradient where the update takes one) and
    K3 against the plain backward at the update's three, in bf16 and f32;
    times in bf16: K1 at all six, K2(+dbias) and K3 at the update's three
    through their C entry points, beside the plain backward, SDPA's whole
    backward (with the bias as a grad-carrying ``attn_mask`` where the
    update differentiates it) and the bound. Returns ``(fwd_results,
    bwd_results, fwd_timed, bwd_timed)``."""
    import torch.nn.functional as F

    fwd_results, results, fwd_timed, bwd_timed = [], [], {}, {}
    for name, (B, Q, K, kind, update) in T5_SHAPES.items():
        q32, k32, v32, bias = t5_case(torch, attn, name)
        learned = kind in ("encoder", "decoder")
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            o, lse = fa.flash_attention(q, k, v, bias, False, True)
            o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias, False, True)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = TOL[dtype_name]
            ok = math.isfinite(err_o) and err_o <= tol_o and err_lse <= tol_lse
            fwd_results.append({"case": name, "dtype": dtype_name, "max_abs_err_o": err_o,
                                "max_abs_err_lse": err_lse, "tol_o": tol_o,
                                "tol_lse": tol_lse, "ok": ok})
            log(f"phase 2: fwd {name:17s} {dtype_name:8s} B={B} Q={Q} K={K} "
                f"({fa.forward_variant(dt, Q)}) max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if dtype_name == "bfloat16":
                fwd_timed[(name, dtype_name)] = row = time_forward(
                    torch, fa, attn, q, k, v, bias, False)
                log_timed(name, dtype_name, row)
            if not update:
                continue
            gen = torch.Generator(device="cuda")
            gen.manual_seed(8)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            got = fa._launch_backward(q, k, v, bias, o, lse, do, False, dbias=learned)
            want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, False,
                                                         learned)
            torch.cuda.synchronize()
            row = {"case": name, "dtype": dtype_name, "variant": fa.backward_variant(dt)}
            ok = True
            for key, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                # dbias is dS in f32 on both sides: only the order of the
                # sums differs
                tol = (1e-4 if key == "dbias" else BWD_TOL[dtype_name]) * max(
                    1.0, w.float().abs().max().item())
                row[f"max_abs_err_{key}"], row[f"tol_{key}"] = err, tol
                ok = ok and math.isfinite(err) and err <= tol
            row["ok"] = ok
            results.append(row)
            log(f"phase 2: bwd {name:17s} {dtype_name:8s} ({row['variant']}"
                f"{', dbias' if learned else ''}) "
                + " ".join(f"max|d{key}|={row[f'max_abs_err_{key}']:.3e}"
                           f"(tol {row[f'tol_{key}']:.1e})"
                           for key in ("dq", "dk", "dv", "dbias") if f"tol_{key}" in row)
                + f" {'ok' if ok else 'FAIL'}")
            if dtype_name != "bfloat16":
                continue
            tensors = [q, k, v, bias, o, lse, do]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            copies = input_copies(tensors, nbytes)
            if learned:
                dq_calls, packed = packed_dbias_calls(torch, fa, copies)
                _, dkv_calls, _ = packed_backward_calls(torch, fa, copies, False)
            else:
                dq_calls, dkv_calls, packed = packed_backward_calls(torch, fa, copies, False)
            kernel_dq, kernel_dkv = time_ms(dq_calls), time_ms(dkv_calls)
            rc = dq_calls[0]()
            torch.cuda.synchronize()
            same = rc == 0 and torch.equal(packed[0][1], got[0]) and (
                not learned or torch.equal(packed[0][2], got[3]))
            results.append({"case": name + "_packed_calls", "dtype": dtype_name, "ok": same,
                            "max_abs_err_dq": 0.0, "max_abs_err_dk": 0.0,
                            "max_abs_err_dv": 0.0})
            log(f"phase 2: packed K2 call at {name} rc={rc}, outputs equal the wrapper's: "
                f"{'ok' if same else 'FAIL'}")
            del packed, dq_calls, dkv_calls
            plain = time_ms([lambda c=c: fa.flash_attention_backward_reference(
                *c, False, learned) for c in copies])
            graphs = []
            for c in copies:
                ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in c[:3])
                mask = c[3].to(dt).detach().requires_grad_(learned)
                out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
                graphs.append((out, (ql, kl, vl, mask) if learned else (ql, kl, vl),
                               c[6].transpose(1, 2)))
            library = time_ms([
                lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
                for g in graphs
            ])
            del copies, graphs
            bounds = backward_bound(fa, q, k, bias, False, dtype_name)
            if learned:  # the dbias write, f32 [B, H, Q, K]
                extra = B * UL2_HEADS * Q * K * 4
                flops = bounds["flash_bwd_dq"]["flops"]
                nb = bounds["flash_bwd_dq"]["bytes"] + extra
                t_bytes = nb / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
                bounds["flash_bwd_dq"] = {"bound_ms": max(t_bytes, t_ops), "bytes": nb,
                                          "flops": flops,
                                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            shape = (f"B={B} H={UL2_HEADS} Q={Q} K={K} D=64, bias {list(bias.shape)}"
                     + (" (dbias)" if learned else ""))
            for kname, ms in (("flash_bwd_dq", kernel_dq), ("flash_bwd_dkv", kernel_dkv)):
                bwd_timed[(name, kname)] = {
                    "shape": shape, "variant": fa.backward_variant(dt), "dbias": learned,
                    "ms": ms, "plain_ms": plain, "library_ms": library, **bounds[kname],
                }
                log(f"phase 2: {kname} bf16 {name} {shape} ({fa.backward_variant(dt)}): "
                    f"kernel_ms={ms} plain_ms={plain} (whole plain backward) "
                    f"library_ms={library} (SDPA's whole backward) "
                    f"bound_ms={bounds[kname]['bound_ms']} ({bounds[kname]['bound_by']})")
    return fwd_results, results, fwd_timed, bwd_timed


def phase_model_backward(torch, fa):
    """Full-width f32 GPT-2 + value head: the gradient of a PPO loss on
    one minibatch (B=16, 64 left-padded prompt + 48 response columns)
    through K1/K2/K3 against the same through the plain attention. The
    gate, 1e-3 of each group's largest gradient, leaves room for f32
    summation order through 12 layers of backward, not for an error."""
    from trlx_tpu_torch.models import gpt2
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.ops.ppo_math import ppo_loss
    from trlx_tpu_torch.utils import logprobs_from_logits

    dev = "cuda"
    cfg = gpt2.GPT2Config(dtype="float32")
    model = CausalLMWithValueHead(cfg, device=dev)
    init_params(model, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    B, Q, R = 16, 64, 48
    lens = torch.randint(16, Q + 1, (B,), generator=gen, device=dev)
    q_mask = (torch.arange(Q, device=dev)[None] >= Q - lens[:, None]).long()
    q_ids = torch.randint(0, cfg.vocab_size, (B, Q), generator=gen, device=dev) * q_mask
    r_ids = torch.randint(0, cfg.vocab_size, (B, R), generator=gen, device=dev)
    r_len = torch.randint(1, R + 1, (B,), generator=gen, device=dev)
    r_mask = (torch.arange(R, device=dev)[None] < r_len[:, None]).long()
    old = [torch.randn(B, R, generator=gen, device=dev) for _ in range(4)]
    old[0] = old[0] * 0.1 - 10.0  # behaviour logprobs
    params = [p for p in model.parameters()]

    def plain(q, k, v, bias=None, causal=False):
        return fa.flash_attention_reference(q, k, v, bias, causal)

    def grads_with(attention):
        orig = gpt2.dot_product_attention
        gpt2.dot_product_attention = attention
        try:
            logits, values = model.response_forward(
                torch.cat([q_ids, r_ids], 1), torch.cat([q_mask, r_mask], 1), Q
            )
            logprobs = logprobs_from_logits(logits, r_ids)
            loss, _ = ppo_loss(logprobs, values.float(), *old, r_mask, 0.2, 0.2, 1.0)
            return torch.autograd.grad(loss, params)
        finally:
            gpt2.dot_product_attention = orig

    before = backward_variant_launches(fa)
    kernel = grads_with(gpt2.dot_product_attention)
    after = backward_variant_launches(fa)
    launches = {k: {v: after[k][v] - before[k][v] for v in BWD_VARIANTS} for k in BWD_KERNELS}
    reference = grads_with(plain)
    groups = {}
    for (name, _), g, r in zip(model.named_parameters(), kernel, reference):
        group = ("value head" if name.startswith("v_head") else
                 "embeddings" if ".wte." in name or ".wpe." in name else
                 "layer norms" if ".ln_" in name else
                 "attention" if ".attn." in name else "mlp")
        err, top = groups.get(group, (0.0, 0.0))
        groups[group] = (max(err, (g - r).abs().max().item()), max(top, r.abs().max().item()))
    rel = {k: err / max(top, 1e-30) for k, (err, top) in groups.items()}
    ok = all(math.isfinite(v) and v <= 1e-3 for v in rel.values()) and launches == {
        k: {"tile": 0, "fma": cfg.n_layer} for k in BWD_KERNELS}
    log("phase 3: full-width f32 GPT-2 PPO-loss gradient, kernels vs plain attention: "
        "max relative error per group " + json.dumps(rel) + f"; K2/K3 launches by variant "
        f"{json.dumps(launches)} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_logprob_chunk(torch):
    """Full-width GPT-2 + value head in bf16 over f32 masters: the update's
    logprobs and the PPO-loss gradient with ``train.logprob_chunk: 16``
    (``utils.chunked_logprobs``, as ``PPOTrainer._forward_logprobs_values``
    runs it) against the unchunked head, on one minibatch (B=16, 64
    left-padded prompt + 48 response columns). Both sides run the same
    kernels; only the LM head's f32 GEMM takes 16 response positions at a
    time instead of 48 and may sum in another order. So the logprobs must
    agree within 1e-4, and each parameter group's gradient within 1/64 of
    its largest (a bf16 rounding of the hidden state's gradient may fall
    the other way and carry through 12 layers). Prints each side's peak
    memory above the model."""
    from trlx_tpu_torch.models import gpt2
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.ops.ppo_math import ppo_loss
    from trlx_tpu_torch.utils import chunked_logprobs, logprobs_from_logits

    dev = "cuda"
    cfg = gpt2.GPT2Config()  # bf16 compute, f32 parameters
    model = CausalLMWithValueHead(cfg, device=dev)
    init_params(model, 5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    B, Q, R, chunk = 16, 64, 48, 16
    lens = torch.randint(16, Q + 1, (B,), generator=gen, device=dev)
    q_mask = (torch.arange(Q, device=dev)[None] >= Q - lens[:, None]).long()
    q_ids = torch.randint(0, cfg.vocab_size, (B, Q), generator=gen, device=dev) * q_mask
    r_ids = torch.randint(0, cfg.vocab_size, (B, R), generator=gen, device=dev)
    r_mask = (torch.arange(R, device=dev)[None] < torch.randint(
        1, R + 1, (B, 1), generator=gen, device=dev)).long()
    old = [torch.randn(B, R, generator=gen, device=dev) for _ in range(4)]
    old[0] = old[0] * 0.1 - 10.0  # behaviour logprobs
    names, params = zip(*model.named_parameters())
    ids, mask = torch.cat([q_ids, r_ids], 1), torch.cat([q_mask, r_mask], 1)

    def run(chunked):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if chunked:
            hidden, values = model.response_hidden(ids, mask, Q)
            logprobs = chunked_logprobs(model.transformer.logits, hidden, r_ids, chunk)
        else:
            logits, values = model.response_forward(ids, mask, Q)
            logprobs = logprobs_from_logits(logits, r_ids)
        loss, _ = ppo_loss(logprobs, values.float(), *old, r_mask, 0.2, 0.2, 1.0)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return logprobs.detach(), grads, torch.cuda.max_memory_allocated() - base

    lp_chunk, g_chunk, peak_chunk = run(True)
    lp_full, g_full, peak_full = run(False)
    err_lp = (lp_chunk - lp_full).abs().max().item()
    groups = {}
    for name, g, r in zip(names, g_chunk, g_full):
        group = ("value head" if name.startswith("v_head") else
                 "embeddings" if ".wte." in name or ".wpe." in name else
                 "layer norms" if ".ln_" in name else
                 "attention" if ".attn." in name else "mlp")
        err, top = groups.get(group, (0.0, 0.0))
        groups[group] = (max(err, (g - r).abs().max().item()), max(top, r.abs().max().item()))
    rel = {k: err / max(top, 1e-30) for k, (err, top) in groups.items()}
    ok = math.isfinite(err_lp) and err_lp <= 1e-4 and all(
        math.isfinite(v) and v <= 1 / 64 for v in rel.values())
    log(f"phase 3: full-width bf16 GPT-2, logprob_chunk {chunk} vs unchunked at B={B} R={R}: "
        f"max|dlogprobs|={err_lp:.3e} (tol 1e-4), gradient max relative error per group "
        f"{json.dumps(rel)} (tol 1/64); peak memory above the model {peak_chunk} B chunked, "
        f"{peak_full} B unchunked {'ok' if ok else 'FAIL'}")
    return ok


def ul2_arch(**overrides):
    """``configs/ppo_ul2.yml``'s architecture at its published widths."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_ul2.yml"))
    return dict(cfg.model.model_arch, **overrides)


def phase_t5_model_backward(torch, fa):
    """Full-width f32 T5 of ``configs/ppo_ul2.yml`` + value head: the
    gradient of a PPO loss on one minibatch (B=2, 128 left-padded encoder
    columns, 49 response columns) through K1/K2(+dbias)/K3 against the
    same through the plain attention (autograd through the plain forward,
    the bias included). The gate, 1e-3 of each group's largest gradient,
    leaves room for f32 summation order through 8 + 8 layers; the relative
    position tables are their own group."""
    from trlx_tpu_torch.models import t5
    from trlx_tpu_torch.models.heads import T5WithValueHead, init_params
    from trlx_tpu_torch.models.t5 import T5Config, shift_tokens_right
    from trlx_tpu_torch.ops.ppo_math import ppo_loss
    from trlx_tpu_torch.utils import logprobs_from_logits

    dev = "cuda"
    cfg = T5Config.from_dict(ul2_arch(dtype="float32", param_dtype="float32"))
    model = T5WithValueHead(cfg, device=dev)
    init_params(model, 3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    B, S, R = 2, 128, 49
    q_mask = (torch.arange(S, device=dev)[None] >= torch.tensor([[0], [70]], device=dev)).long()
    q_ids = torch.randint(2, 21128, (B, S), generator=gen, device=dev) * q_mask
    r_ids = torch.randint(2, 21128, (B, R), generator=gen, device=dev)
    r_mask = (torch.arange(R, device=dev)[None] < torch.tensor([[R], [20]], device=dev)).long()
    dec_ids = shift_tokens_right(r_ids, 0, 0)
    dec_mask = torch.cat([torch.ones_like(r_mask[:, :1]), r_mask[:, :-1]], 1)
    old = [torch.randn(B, R, generator=gen, device=dev) for _ in range(4)]
    old[0] = old[0] * 0.1 - 10.0
    names, params = zip(*model.named_parameters())

    def plain(q, k, v, bias=None, causal=False, learned_bias=False):
        return fa.flash_attention_reference(q, k, v, bias, causal)

    def grads_with(attention):
        orig = t5.dot_product_attention
        t5.dot_product_attention = attention
        try:
            out = model(q_ids, attention_mask=q_mask, decoder_input_ids=dec_ids,
                        decoder_attention_mask=dec_mask)
            logprobs = logprobs_from_logits(out["logits"], r_ids)
            loss, _ = ppo_loss(logprobs, out["values"].float(), *old, r_mask, 0.2, 0.2, 1.0)
            return torch.autograd.grad(loss, params)
        finally:
            t5.dot_product_attention = orig

    before = backward_variant_launches(fa)
    dbias0 = fa.FLASH_BWD_DQ_DBIAS_LAUNCHES
    kernel = grads_with(t5.dot_product_attention)
    after = backward_variant_launches(fa)
    launches = {k: {v: after[k][v] - before[k][v] for v in BWD_VARIANTS} for k in BWD_KERNELS}
    dbias = fa.FLASH_BWD_DQ_DBIAS_LAUNCHES - dbias0
    reference = grads_with(plain)
    groups = {}
    for name, g, r in zip(names, kernel, reference):
        group = ("value head" if name.startswith("v_head") else
                 "relative position tables" if "rel_bias" in name else
                 "embeddings" if "shared" in name or "lm_head" in name else
                 "layer norms" if "ln" in name else
                 "attention" if "Attention" in name else "feed-forward")
        err, top = groups.get(group, (0.0, 0.0))
        groups[group] = (max(err, (g - r).abs().max().item()), max(top, r.abs().max().item()))
    rel = {k: err / max(top, 1e-30) for k, (err, top) in groups.items()}
    n_attn = cfg.num_layers + 2 * cfg.num_decoder_layers
    n_self = cfg.num_layers + cfg.num_decoder_layers
    ok = (all(math.isfinite(v) and v <= 1e-3 for v in rel.values())
          and launches == {k: {"tile": 0, "fma": n_attn} for k in BWD_KERNELS}
          and dbias == n_self)
    log("phase 3: full-width f32 UL2 T5 PPO-loss gradient, kernels vs plain attention: "
        "max relative error per group " + json.dumps(rel) + f"; K2/K3 launches by variant "
        f"{json.dumps(launches)}, K2 with dbias {dbias} (want {n_self}) "
        f"{'ok' if ok else 'FAIL'}")
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


def reset_forward_counters(fa) -> None:
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_FWD_COPIES = 0
    for counter in FWD_VARIANT_COUNTERS.values():
        setattr(fa, counter, 0)


def reset_backward_counters(fa) -> None:
    fa.FLASH_BWD_COPIES = 0
    for kernel in BWD_KERNELS:
        setattr(fa, kernel.upper() + "_LAUNCHES", 0)
        for variant in BWD_VARIANTS:
            setattr(fa, f"{kernel.upper()}_{variant.upper()}_LAUNCHES", 0)


def backward_variant_launches(fa) -> dict:
    """K2's and K3's launches by variant."""
    return {kernel: {v: getattr(fa, f"{kernel.upper()}_{v.upper()}_LAUNCHES")
                     for v in BWD_VARIANTS} for kernel in BWD_KERNELS}


def forward_variant_launches(fa) -> dict:
    """K1's launches by variant and the wrapper's input copies, since the
    last ``reset_forward_counters``."""
    out = {v: getattr(fa, c) for v, c in FWD_VARIANT_COUNTERS.items()}
    out["copies"] = fa.FLASH_FWD_COPIES
    return out


def reset_peak(torch) -> int:
    """Free what earlier phases left (a trainer and its orchestrator point
    at each other, so they wait for a collection), zero the peak counter,
    and return the bytes still allocated: each path's peak starts clean."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


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

    mem_start = reset_peak(torch)
    server = InferenceServer(serving_config(), seed=0)
    prompts = serving_prompts()

    plain_calls = [0]
    orig_ref = fa.flash_attention_reference

    def counting_ref(*a, **kw):
        plain_calls[0] += 1
        return orig_ref(*a, **kw)

    fa.flash_attention_reference = counting_ref
    reset_forward_counters(fa)  # count the main path's launches only
    try:
        rids, results, wall = serve(torch, server, prompts)
    finally:
        fa.flash_attention_reference = orig_ref
    launches = fa.FLASH_FWD_LAUNCHES
    variants = forward_variant_launches(fa)
    stats = server.stats()
    n_layer = server.model_config.n_layer
    expected = n_layer * int(stats["engine/prefills"] + stats["engine/decode_steps"])
    # admission prefills run Q = seq_length (tile), decode steps Q = 1
    expected_variants = {
        "tile": n_layer * int(stats["engine/prefills"]),
        "decode": n_layer * int(stats["engine/decode_steps"]),
        "fma": 0, "copies": 0,
    }
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
        "allocated_at_start_bytes": mem_start,
        "flash_fwd_launches": launches,
        "expected_launches": expected,
        "flash_fwd_variants": variants,
        "expected_variants": expected_variants,
        "plain_attention_calls": plain_calls[0],
        "stats": stats,
    }
    log("phase 4: serving " + json.dumps(record))
    ok = (
        len(results) == 64
        and min(lengths) >= 1
        and finite
        and launches == expected
        and variants == expected_variants
        and plain_calls[0] == 0
    )
    log(f"phase 4: {'ok' if ok else 'FAIL'} (complete={len(results)}/64, "
        f"min length={min(lengths)}, finite={finite}, launches={launches} "
        f"vs 12 x (prefills + decode steps) = {expected}, by variant {variants} "
        f"vs {expected_variants}, plain attention calls={plain_calls[0]})")
    return ok, record


def training_config(checkpoint_dir: str):
    """The ``configs/ppo_sentiments.yml`` run at full GPT-2-small width with
    random weights, cut to two PPO phases (64 updates)."""
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
        "total_steps": 64, "eval_interval": 64, "checkpoint_interval": 64,
        "checkpoint_dir": checkpoint_dir,
    })
    return TRLConfig.from_dict(cfg)


def training_prompts(seed: int = 1):
    """128 int-list prompts, real lengths drawn from 16..64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        [int(x) for x in rng.integers(0, 50256, int(rng.integers(16, 65)))]
        for _ in range(128)
    ]


def training_reward(samples, queries, response_gt=None):
    """The share of response ids below 25000 (a host reward)."""
    return [
        sum(int(t) < 25000 for t in s.split()) / max(len(s.split()), 1)
        for s in samples
    ]


def phase_training(torch, fa):
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    rows, evals, saved_rng, plain_calls, decode_forwards = [], [], [], [0], [0]
    orig = {
        "train_on": PPOTrainer._train_on, "evaluate": PPOTrainer.evaluate,
        "save": PPOTrainer.save, "apply": PPOTrainer._apply,
        "fwd": fa.flash_attention_reference, "bwd": fa.flash_attention_backward_reference,
    }

    def apply(self, input_ids, *a, **kw):
        # the sampler's forwards: a prefill over the prompt columns, then
        # one decode step per token (Q = 1, K1's decode variant)
        decode_forwards[0] += input_ids.shape[1] <= 16
        return orig["apply"](self, input_ids, *a, **kw)

    def train_on(self, *a, **kw):
        out = orig["train_on"](self, *a, **kw)
        rows.append(out[0])
        return out

    def evaluate(self):
        out = orig["evaluate"](self)
        evals.append(out)
        return out

    def save(self, directory=None):
        # the sampling generator as saved (the final eval draws after it)
        saved_rng.append(self.generator.get_state())
        return orig["save"](self, directory)

    def counting(name):
        def fn(*a, **kw):
            plain_calls[0] += 1
            return orig[name](*a, **kw)
        return fn

    with tempfile.TemporaryDirectory() as tmp:
        config = training_config(tmp)
        PPOTrainer._train_on, PPOTrainer.evaluate, PPOTrainer.save = train_on, evaluate, save
        PPOTrainer._apply = apply
        fa.flash_attention_reference = counting("fwd")
        fa.flash_attention_backward_reference = counting("bwd")
        mem_start = reset_peak(torch)
        # count the main path's launches only
        reset_forward_counters(fa)
        reset_backward_counters(fa)
        t0 = time.perf_counter()
        try:
            trainer = trlx_tpu_torch.train(
                reward_fn=training_reward, prompts=training_prompts(), config=config
            )
            torch.cuda.synchronize()
        finally:
            PPOTrainer._train_on, PPOTrainer.evaluate = orig["train_on"], orig["evaluate"]
            PPOTrainer.save, PPOTrainer._apply = orig["save"], orig["apply"]
            fa.flash_attention_reference = orig["fwd"]
            fa.flash_attention_backward_reference = orig["bwd"]
        wall = time.perf_counter() - t0
        launches = {
            "flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
        }
        variants = forward_variant_launches(fa)
        bwd_variants = backward_variant_launches(fa)
        bwd_copies = fa.FLASH_BWD_COPIES
        peak = torch.cuda.max_memory_allocated()
        finite = all(np.isfinite(v).all() for r in rows for v in r.values()) and all(
            math.isfinite(v) for e in evals for v in e.values()
        )
        initial = CausalLMWithValueHead(trainer.model_config, device="cuda")
        init_params(initial, config.train.seed)
        start = initial.state_dict()
        changed = sum(
            not torch.equal(p, start[n]) for n, p in trainer.model.state_dict().items()
        )
        del initial, start
        fresh = PPOTrainer(training_config(tmp))
        fresh.load(tmp)
        saved, loaded = trainer.opt.state_dict(), fresh.opt.state_dict()
        restored = (
            all(torch.equal(fresh.model.state_dict()[n], p)
                for n, p in trainer.model.state_dict().items())
            and all(torch.equal(loaded["adamw"]["state"][i][key], value)
                    for i, st in saved["adamw"]["state"].items() for key, value in st.items())
            and (fresh.step, fresh.kl_coef, fresh.mean_kl, loaded["count"])
            == (trainer.step, trainer.kl_coef, trainer.mean_kl, saved["count"])
            and torch.equal(fresh.generator.get_state(), saved_rng[-1])
        )
        del fresh
    expected = {
        "flash_fwd": N_LAYER * trainer.forwards,
        "flash_bwd_dq": N_LAYER * 64,
        "flash_bwd_dkv": N_LAYER * 64,
    }
    # decode steps run Q = 1; the rollout prefill (Q = 64), the reference
    # and the update forwards (Q = 112) the tile variant
    expected_variants = {
        "tile": N_LAYER * (trainer.forwards - decode_forwards[0]),
        "decode": N_LAYER * decode_forwards[0],
        "fma": 0, "copies": 0,
    }
    # every update backward runs bf16: the tile variant only
    expected_bwd_variants = {k: {"tile": N_LAYER * 64, "fma": 0} for k in BWD_KERNELS}
    per_phase = trainer.step // len(trainer.phase_times)
    phases = [
        dict(p, rollout_tokens_per_s=p["rollout_tokens"] / p["collect_s"],
             updates_per_s=per_phase / p["train_s"])
        for p in trainer.phase_times
    ]
    record = {
        "wall_s": wall,
        "updates": trainer.step,
        "phases": phases,
        "evals": evals,
        "max_memory_allocated_bytes": peak,
        "allocated_at_start_bytes": mem_start,
        "forwards": trainer.forwards,
        "launches": launches,
        "expected_launches": expected,
        "decode_forwards": decode_forwards[0],
        "flash_fwd_variants": variants,
        "expected_variants": expected_variants,
        "backward_variants": bwd_variants,
        "expected_backward_variants": expected_bwd_variants,
        "backward_copies": bwd_copies,
        "plain_attention_calls": plain_calls[0],
        "params_changed": changed,
    }
    log("phase 5: training " + json.dumps(record))
    ok = (
        trainer.step == 64 and len(rows) == 2 and finite and changed > 0
        and restored and launches == expected and variants == expected_variants
        and bwd_variants == expected_bwd_variants and bwd_copies == 0
        and plain_calls[0] == 0
    )
    log(f"phase 5: {'ok' if ok else 'FAIL'} (updates={trainer.step}, phases={len(rows)}, "
        f"finite={finite}, changed tensors={changed}, load restores={restored}, "
        f"launches={launches} vs {expected}, K1 by variant {variants} vs "
        f"{expected_variants}, K2/K3 by variant {bwd_variants} vs {expected_bwd_variants}, "
        f"backward input copies={bwd_copies}, plain attention calls={plain_calls[0]})")
    return ok, record


def random_backbone(torch, module, seed: int) -> dict:
    """Fill ``module``'s parameters from a seeded generator on the card,
    N(0, 0.02), layer-norm weights around 1 (so that a name or layout
    mix-up shows in a load check), and return its state dict on the CPU."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.normal_(0.0, 0.02, generator=gen)
            if re.search(r"(^|[._])ln[._]", name) and name.endswith("weight"):
                p.add_(1.0)
    return {n: t.detach().cpu().contiguous() for n, t in module.state_dict().items()}


GPT2_CONV1D = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
               "mlp.c_proj.weight")


def gpt2_hf_layout(state: dict) -> dict:
    """The port's ``GPT2Model`` state dict in HF ``GPT2LMHeadModel``'s
    layout: names under ``transformer.``, ``Conv1D`` weights [in, out], and
    no ``lm_head.weight`` (tied to ``wte``; safetensors leaves it out)."""
    return {"transformer." + n: (t.t().contiguous() if n.endswith(GPT2_CONV1D) else t)
            for n, t in state.items()}


# the port's T5Model names -> HF T5ForConditionalGeneration's (no
# transposes: both store [out, in]; the relative position tables live in
# block 0 of each stack)
T5_HF_NAMES = (
    (r"^enc\.(\d+)\.ln_self\.", r"encoder.block.\1.layer.0.layer_norm."),
    (r"^enc\.(\d+)\.SelfAttention\.", r"encoder.block.\1.layer.0.SelfAttention."),
    (r"^enc\.(\d+)\.ln_ff\.", r"encoder.block.\1.layer.1.layer_norm."),
    (r"^enc\.(\d+)\.DenseReluDense\.", r"encoder.block.\1.layer.1.DenseReluDense."),
    (r"^dec\.(\d+)\.ln_self\.", r"decoder.block.\1.layer.0.layer_norm."),
    (r"^dec\.(\d+)\.SelfAttention\.", r"decoder.block.\1.layer.0.SelfAttention."),
    (r"^dec\.(\d+)\.ln_cross\.", r"decoder.block.\1.layer.1.layer_norm."),
    (r"^dec\.(\d+)\.EncDecAttention\.", r"decoder.block.\1.layer.1.EncDecAttention."),
    (r"^dec\.(\d+)\.ln_ff\.", r"decoder.block.\1.layer.2.layer_norm."),
    (r"^dec\.(\d+)\.DenseReluDense\.", r"decoder.block.\1.layer.2.DenseReluDense."),
    (r"^enc_rel_bias\.", "encoder.block.0.layer.0.SelfAttention."),
    (r"^dec_rel_bias\.", "decoder.block.0.layer.0.SelfAttention."),
    (r"^enc_final_ln\.", "encoder.final_layer_norm."),
    (r"^dec_final_ln\.", "decoder.final_layer_norm."),
)


def t5_hf_layout(state: dict) -> dict:
    """The port's ``T5Model`` state dict in HF ``T5ForConditionalGeneration``'s
    layout (``shared`` and an untied ``lm_head`` keep their names)."""
    out = {}
    for name, t in state.items():
        hf = name
        for pattern, repl in T5_HF_NAMES:
            hf = re.sub(pattern, repl, hf)
        out[hf] = t
    return out


def write_hf_checkpoint(path: str, config: dict, tensors: dict) -> None:
    """An HF checkpoint directory: ``config.json`` and ``model.safetensors``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh)
    write_safetensors(tensors, os.path.join(path, "model.safetensors"))


def state_equal(torch, module, want: dict) -> bool:
    """Whether ``module``'s state dict holds exactly ``want``'s names and
    bits."""
    got = module.state_dict()
    return set(got) == set(want) and all(torch.equal(got[n].cpu(), t) for n, t in want.items())


def write_ul2_checkpoint(torch, path: str, seed: int = 11) -> dict:
    """A UL2 checkpoint in HF layout at ``configs/ppo_ul2.yml``'s widths
    (gated-GELU, untied head) with random weights from ``seed``; returns
    the port-named backbone state it holds."""
    from trlx_tpu_torch.models.t5 import T5Config, T5Model

    arch = ul2_arch()
    state = random_backbone(torch, T5Model(T5Config.from_dict(arch), device="cuda"), seed)
    config = dict(arch, model_type="t5", architectures=["T5ForConditionalGeneration"],
                  relative_attention_num_buckets=32, relative_attention_max_distance=128,
                  layer_norm_epsilon=1e-6, pad_token_id=0, eos_token_id=1)
    write_hf_checkpoint(path, config, t5_hf_layout(state))
    return state


UL2_UPDATES = 80  # two PPO phases of 128 // 12 = 10 minibatches x 4 epochs


def ul2_training_config(checkpoint_dir: str, model_path: str = ""):
    """``configs/ppo_ul2.yml`` as written at full width, from the HF
    checkpoint at ``model_path`` (the fork's UL2 checkpoint is not in the
    repo: phase 6 writes one of the same layout with random weights) or
    random weights without one, cut from 10 000 updates to two PPO phases.
    The yml's eval interval (100) and checkpoint interval (10 000) leave
    the evals at step 0 and the end and the end-of-run save."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_ul2.yml")).to_dict()
    cfg["model"]["model_path"] = model_path
    cfg["train"].update({"total_steps": UL2_UPDATES, "checkpoint_dir": checkpoint_dir})
    return TRLConfig.from_dict(cfg)


def ul2_prompts(seed: int = 2):
    """128 int-list prompts of real lengths 64-512, ids in [2, 21128) (below
    the forced BOS), and a ground-truth response id for each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(2, 21128, int(rng.integers(64, 513)))]
               for _ in range(128)]
    return prompts, [str(int(x)) for x in rng.integers(2, 21128, 128)]


def ul2_reward(samples, queries, response_gt=None):
    """A host reward that reads ``response_gt``: 1 if the ground-truth id
    is among the response ids, plus the share of response ids below 10000."""
    gts = response_gt if response_gt is not None else [None] * len(samples)
    return [
        float(gt in s.split()) + sum(int(t) < 10000 for t in s.split()) / max(len(s.split()), 1)
        for s, gt in zip(samples, gts)
    ]


def phase_t5_training(torch, fa):
    """``trlx_tpu_torch.train`` with ``train.trainer: Seq2SeqPPOTrainer`` on
    ``configs/ppo_ul2.yml`` at full width for two PPO phases, from a UL2
    checkpoint in HF layout that the phase writes and loads through
    ``model.model_path`` (the loaded backbone must equal the written
    tensors before the first update); the gates of phase 5 with the
    seq2seq path's counts: K1 ``tile`` = 24 x the
    teacher-forced forwards (reference scoring and updates: 8 encoder, 8
    decoder self and 8 cross attentions) + 8 x the sampler's encoder
    passes, ``decode`` = 16 x its decoder calls; K2 = K3 = 24 x the
    updates, K2 with the bias gradient 16 x the updates; no ``fma`` launch,
    no input copy, no plain call."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.models.heads import T5WithValueHead, init_params
    from trlx_tpu_torch.trainer.seq2seq_ppo_trainer import Seq2SeqPPOTrainer

    rows, evals, saved_rng, plain_calls, backbone_loads = [], [], [], [0], []
    calls = {"encode": 0, "decode": 0}
    orig = {
        "learn": Seq2SeqPPOTrainer.learn,
        "train_on": Seq2SeqPPOTrainer._train_on, "evaluate": Seq2SeqPPOTrainer.evaluate,
        "save": Seq2SeqPPOTrainer.save, "encode": T5WithValueHead.encode,
        "decode": T5WithValueHead.decode,
        "fwd": fa.flash_attention_reference, "bwd": fa.flash_attention_backward_reference,
    }

    def counted(name):
        def fn(self, *a, **kw):
            calls[name] += 1
            return orig[name](self, *a, **kw)
        return fn

    def train_on(self, *a, **kw):
        out = orig["train_on"](self, *a, **kw)
        rows.append(out[0])
        return out

    def learn(self):
        backbone_loads.append(state_equal(torch, self.model.t5, written))  # before the first update
        return orig["learn"](self)

    def evaluate(self):
        out = orig["evaluate"](self)
        evals.append(out)
        return out

    def save(self, directory=None):
        saved_rng.append(self.generator.get_state())
        return orig["save"](self, directory)

    def plain(name):
        def fn(*a, **kw):
            plain_calls[0] += 1
            return orig[name](*a, **kw)
        return fn

    prompts, response_gt = ul2_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, run_dir = os.path.join(tmp, "ul2"), os.path.join(tmp, "run")
        written = write_ul2_checkpoint(torch, ckpt)
        config = ul2_training_config(run_dir, ckpt)
        Seq2SeqPPOTrainer._train_on, Seq2SeqPPOTrainer.evaluate = train_on, evaluate
        Seq2SeqPPOTrainer.save, Seq2SeqPPOTrainer.learn = save, learn
        T5WithValueHead.encode, T5WithValueHead.decode = counted("encode"), counted("decode")
        fa.flash_attention_reference = plain("fwd")
        fa.flash_attention_backward_reference = plain("bwd")
        mem_start = reset_peak(torch)
        # count the main path's launches only
        reset_forward_counters(fa)
        reset_backward_counters(fa)
        fa.FLASH_BWD_DQ_DBIAS_LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            trainer = trlx_tpu_torch.train(
                reward_fn=ul2_reward, prompts=prompts, response_gt=response_gt, config=config
            )
            torch.cuda.synchronize()
        finally:
            Seq2SeqPPOTrainer._train_on, Seq2SeqPPOTrainer.learn = orig["train_on"], orig["learn"]
            Seq2SeqPPOTrainer.evaluate, Seq2SeqPPOTrainer.save = orig["evaluate"], orig["save"]
            T5WithValueHead.encode, T5WithValueHead.decode = orig["encode"], orig["decode"]
            fa.flash_attention_reference = orig["fwd"]
            fa.flash_attention_backward_reference = orig["bwd"]
        wall = time.perf_counter() - t0
        launches = {
            "flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
            "flash_bwd_dq_dbias": fa.FLASH_BWD_DQ_DBIAS_LAUNCHES,
        }
        variants = forward_variant_launches(fa)
        bwd_variants = backward_variant_launches(fa)
        bwd_copies = fa.FLASH_BWD_COPIES
        peak = torch.cuda.max_memory_allocated()
        finite = all(np.isfinite(v).all() for r in rows for v in r.values()) and all(
            math.isfinite(v) for e in evals for v in e.values()
        )
        initial = T5WithValueHead(trainer.model_config, device="cuda")
        init_params(initial, config.train.seed)  # the value head
        initial.t5.load_state_dict(written)
        start = initial.state_dict()
        changed = sum(
            not torch.equal(p, start[n]) for n, p in trainer.model.state_dict().items()
        )
        table = "t5.enc_rel_bias.relative_attention_bias.weight"
        table_moved = not torch.equal(trainer.model.state_dict()[table], start[table])
        del initial, start
        fresh = Seq2SeqPPOTrainer(ul2_training_config(run_dir, ckpt))
        fresh.load(run_dir)
        saved, loaded = trainer.opt.state_dict(), fresh.opt.state_dict()
        restored = (
            all(torch.equal(fresh.model.state_dict()[n], p)
                for n, p in trainer.model.state_dict().items())
            and all(torch.equal(loaded["adamw"]["state"][i][key], value)
                    for i, st in saved["adamw"]["state"].items() for key, value in st.items())
            and (fresh.step, fresh.kl_coef, fresh.mean_kl, loaded["count"])
            == (trainer.step, trainer.kl_coef, trainer.mean_kl, saved["count"])
            and torch.equal(fresh.generator.get_state(), saved_rng[-1])
        )
        del fresh
    cfg = trainer.model_config
    n_enc, n_dec = cfg.num_layers, cfg.num_decoder_layers
    n_attn = n_enc + 2 * n_dec  # 24 attentions in a teacher-forced forward
    teacher_forced = trainer.forwards - calls["encode"] - calls["decode"]
    updates = trainer.step
    expected_variants = {
        "tile": n_attn * teacher_forced + n_enc * calls["encode"],
        "decode": 2 * n_dec * calls["decode"],
        "fma": 0, "copies": 0,
    }
    expected = {
        "flash_fwd": expected_variants["tile"] + expected_variants["decode"],
        "flash_bwd_dq": n_attn * updates,
        "flash_bwd_dkv": n_attn * updates,
        "flash_bwd_dq_dbias": (n_enc + n_dec) * updates,
    }
    expected_bwd_variants = {k: {"tile": n_attn * updates, "fma": 0} for k in BWD_KERNELS}
    per_phase = updates // len(trainer.phase_times)
    phases = [
        dict(p, rollout_tokens_per_s=p["rollout_tokens"] / p["collect_s"],
             updates_per_s=per_phase / p["train_s"])
        for p in trainer.phase_times
    ]
    record = {
        "wall_s": wall,
        "updates": updates,
        "phases": phases,
        "evals": evals,
        "max_memory_allocated_bytes": peak,
        "allocated_at_start_bytes": mem_start,
        "forwards": trainer.forwards,
        "teacher_forced_forwards": teacher_forced,
        "sampler_encodes": calls["encode"],
        "sampler_decoder_calls": calls["decode"],
        "launches": launches,
        "expected_launches": expected,
        "flash_fwd_variants": variants,
        "expected_variants": expected_variants,
        "backward_variants": bwd_variants,
        "expected_backward_variants": expected_bwd_variants,
        "backward_copies": bwd_copies,
        "plain_attention_calls": plain_calls[0],
        "params_changed": changed,
        "relative_table_moved": table_moved,
        "loaded_equals_written": backbone_loads == [True],
    }
    log("phase 6: seq2seq training " + json.dumps(record))
    ok = (
        updates == UL2_UPDATES and len(rows) == 2 and finite and changed > 0 and table_moved
        and backbone_loads == [True]
        and restored and launches == expected and variants == expected_variants
        and bwd_variants == expected_bwd_variants and bwd_copies == 0
        and plain_calls[0] == 0
    )
    log(f"phase 6: {'ok' if ok else 'FAIL'} (loaded backbone equals the written "
        f"checkpoint: {backbone_loads == [True]}, updates={updates}, phases={len(rows)}, "
        f"finite={finite}, changed tensors={changed}, relative table moved={table_moved}, "
        f"load restores={restored}, launches={launches} vs {expected}, K1 by variant "
        f"{variants} vs {expected_variants}, K2/K3 by variant {bwd_variants} vs "
        f"{expected_bwd_variants}, backward input copies={bwd_copies}, plain attention "
        f"calls={plain_calls[0]}, peak memory {peak} B)")
    return ok, record


# bench.py::_workload_config (bench.py:271-378), the headline workload,
# with its environment switches at their defaults (the fixed rollout
# engine, async RL off). Copied: bench.py imports trlx_tpu.
BENCH_WORKLOAD = {
    "model": {
        "model_type": "gpt2",
        "model_arch": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
                       "n_layer": 12, "n_head": 12, "kv_cache_dtype": "auto"},
    },
    "train": {
        "seq_length": 64, "batch_size": 16, "epochs": 3, "total_steps": 10000,
        "eval_interval": 100000, "checkpoint_interval": 1000000,
        "lr_init": 1.412e-4, "lr_target": 1.412e-4,
        "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "bfloat16",
        "health": {"enabled": True}, "rollout": {"engine": "fixed"}, "async_rl": {},
    },
    "method": {
        "name": "PPOConfig", "num_rollouts": 128, "chunk_size": 128, "ppo_epochs": 4,
        "init_kl_coef": 0.2, "target": 6, "horizon": 10000, "cliprange_reward": 10,
        "scale_reward": "running",
        "gen_kwargs": {"max_new_tokens": 48, "min_new_tokens": 48, "top_k": 0,
                       "do_sample": True, "eos_token_id": 50256, "pad_token_id": 50256},
    },
}
# what phase 7 runs differently from bench.py: (setting, bench.py's value,
# the port's, why)
BENCH_DEVIATIONS = (
    ("model.model_arch.kv_cache_dtype", "auto", "bfloat16",
     "the int8 KV cache that 'auto' resolves to at this shape is not ported (ROADMAP queue 1)"),
    ("train.health.enabled", True, False, "health monitoring is not ported (ROADMAP item 19)"),
)
# bench.py's two freezing definitions: (num_layers_unfrozen, ref_branch_layers)
BENCH_DEFINITIONS = {"faithful_0_2": (0, 2), "frozen_top2_2_none": (2, None)}
BENCH_UPDATES = 64  # two PPO phases of 128 // 16 = 8 minibatches x 4 epochs, cut from 10 000
GPT2_HF_CONFIG = {  # GPT-2 small, as its HF config.json names it
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], "vocab_size": 50257,
    "n_positions": 1024, "n_embd": 768, "n_layer": 12, "n_head": 12,
    "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new",
    "bos_token_id": 50256, "eos_token_id": 50256,
}


def bench_config(definition, checkpoint_dir: str):
    """``BENCH_WORKLOAD`` at one freezing definition, with the deviations
    and cut to ``BENCH_UPDATES`` updates."""
    import copy

    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = copy.deepcopy(BENCH_WORKLOAD)
    cfg["model"]["num_layers_unfrozen"], cfg["model"]["ref_branch_layers"] = definition
    cfg["model"]["model_arch"]["kv_cache_dtype"] = "bfloat16"
    cfg["train"]["health"] = {"enabled": False}
    cfg["train"].update(total_steps=BENCH_UPDATES, checkpoint_dir=checkpoint_dir)
    return TRLConfig.from_dict(cfg)


def bench_prompts():
    """bench.py's prompts (bench.py:405-407): 512 int lists, ids in
    [100, 40000), lengths 4-32."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(100, 40000, size=rng.integers(4, 33))]
            for _ in range(512)]


def bench_reward(samples, queries, response_gt=None):
    """bench.py's host reward (bench.py:409-411): length-normalised
    character diversity."""
    return [len(set(s)) / max(len(s), 1) for s in samples]


def hydra_sizes(cfg, branch: int) -> tuple:
    """(parameters of the hydra reference: ``branch`` blocks, ``wte`` and
    ``ln_f``; parameters of a full copy) of a GPT-2 backbone."""
    d = cfg.n_embd
    block = 12 * d * d + 13 * d  # ln_1, c_attn, c_proj, ln_2, c_fc, c_proj
    wte, wpe, ln_f = cfg.vocab_size * d, cfg.n_positions * d, 2 * d
    return branch * block + wte + ln_f, cfg.n_layer * block + wte + wpe + ln_f


def run_bench_definition(torch, fa, name, definition, ckpt, written, prompts, tmp):
    """One freezing definition of phase 7: train, gate, then serve 8 of the
    prompts from the run's checkpoint. Returns ``(ok, record)``."""
    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.inference.server import InferenceServer
    from trlx_tpu_torch.models.gpt2 import torch_dtype
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.checkpoint import load_checkpoint

    rows, evals, loaded, scoring_tiles, plain_calls, decode_forwards = [], [], [], [], [0], [0]
    orig = {
        "learn": PPOTrainer.learn, "train_on": PPOTrainer._train_on,
        "evaluate": PPOTrainer.evaluate, "apply": PPOTrainer._apply,
        "score_ref": PPOTrainer.score_ref,
        "fwd": fa.flash_attention_reference, "bwd": fa.flash_attention_backward_reference,
    }

    def learn(self):
        # before the first update: the loaded backbone and the reference's size
        loaded.append({
            "equals_written": state_equal(torch, self.model.transformer, written),
            "reference": [(p.numel(), p.numel() * p.element_size()) for p in self.ref.parameters()],
            "full": [(p.numel(), p.numel() * p.element_size())
                     for p in self.model.transformer.parameters()],
        })
        return orig["learn"](self)

    def apply(self, input_ids, *a, **kw):
        decode_forwards[0] += input_ids.shape[1] <= 16  # the sampler's steps
        return orig["apply"](self, input_ids, *a, **kw)

    def score_ref(self, *a, **kw):
        before = fa.FLASH_FWD_TILE_LAUNCHES
        out = orig["score_ref"](self, *a, **kw)
        scoring_tiles.append(fa.FLASH_FWD_TILE_LAUNCHES - before)
        return out

    def train_on(self, *a, **kw):
        out = orig["train_on"](self, *a, **kw)
        rows.append(out[0])
        return out

    def evaluate(self):
        out = orig["evaluate"](self)
        evals.append(out)
        return out

    def counting(key):
        def fn(*a, **kw):
            plain_calls[0] += 1
            return orig[key](*a, **kw)
        return fn

    run_dir = os.path.join(tmp, name)
    config = bench_config(definition, run_dir)
    PPOTrainer.learn, PPOTrainer._train_on, PPOTrainer.evaluate = learn, train_on, evaluate
    PPOTrainer._apply, PPOTrainer.score_ref = apply, score_ref
    fa.flash_attention_reference = counting("fwd")
    fa.flash_attention_backward_reference = counting("bwd")
    mem_start = reset_peak(torch)
    # count the main path's launches only
    reset_forward_counters(fa)
    reset_backward_counters(fa)
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(
            model_path=ckpt, reward_fn=bench_reward, prompts=prompts,
            eval_prompts=prompts[:128], config=config,
        )
        torch.cuda.synchronize()
    finally:
        PPOTrainer.learn, PPOTrainer._train_on = orig["learn"], orig["train_on"]
        PPOTrainer.evaluate, PPOTrainer._apply = orig["evaluate"], orig["apply"]
        PPOTrainer.score_ref = orig["score_ref"]
        fa.flash_attention_reference = orig["fwd"]
        fa.flash_attention_backward_reference = orig["bwd"]
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": fa.FLASH_FWD_LAUNCHES,
        "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
        "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
    }
    variants = forward_variant_launches(fa)
    bwd_variants = backward_variant_launches(fa)
    bwd_copies = fa.FLASH_BWD_COPIES
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v).all() for r in rows for v in r.values()) and all(
        math.isfinite(v) for e in evals for v in e.values())

    cfg, updates = trainer.model_config, trainer.step
    n_layer, branch = cfg.n_layer, trainer.ref_branch
    want_ref, want_full = hydra_sizes(cfg, branch)
    ref_params = sum(n for n, _ in loaded[0]["reference"]) if loaded else None
    full_params = sum(n for n, _ in loaded[0]["full"]) if loaded else None
    # the blocks whose attention backpropagates: all, or the unfrozen top
    trained = definition[0] if definition[0] > 0 else n_layer
    expected_variants = {
        "tile": n_layer * (trainer.forwards - decode_forwards[0]),
        "decode": n_layer * decode_forwards[0],
        "fma": 0, "copies": 0,
    }
    expected = {"flash_fwd": expected_variants["tile"] + expected_variants["decode"],
                "flash_bwd_dq": trained * updates, "flash_bwd_dkv": trained * updates}
    expected_bwd_variants = {k: {"tile": trained * updates, "fma": 0} for k in BWD_KERNELS}

    # which parameters moved, against the loaded backbone and the value
    # head's seeded init
    initial = CausalLMWithValueHead(cfg, device="cuda")
    init_params(initial, config.train.seed)
    initial.transformer.load_state_dict(written)
    start = initial.state_dict()
    final = trainer.model.state_dict()
    moved = {n: not torch.equal(final[n], start[n]) for n in final}
    del initial, start
    first_trained = n_layer - definition[0] if definition[0] > 0 else 0

    def layer(name):
        m = re.match(r"transformer\.h\.(\d+)\.", name)
        return int(m.group(1)) if m else None

    # under (k, None): the blocks below the top k and the embeddings
    # frozen; the top k blocks, ln_f and the value head trained
    frozen = [n for n in moved if first_trained and (
        n.startswith(("transformer.wte.", "transformer.wpe."))
        or (layer(n) is not None and layer(n) < first_trained))]
    top = [n for n in moved if first_trained and (
        n.startswith(("transformer.ln_f.", "v_head."))
        or (layer(n) is not None and layer(n) >= first_trained))]
    freezing_ok = (not any(moved[n] for n in frozen) and all(moved[n] for n in top)
                   if first_trained else sum(moved.values()) > 0)

    # serve 8 prompts from the run's checkpoint
    saved = load_checkpoint(run_dir, device="cpu")["model"]
    server = InferenceServer(config.to_dict(), checkpoint_dir=run_dir, seed=0)
    served = server.model.state_dict()
    # the server casts its weights to the compute dtype (the value head's
    # last layer stays f32): the same cast of the saved tensors, bit for bit
    restored = set(served) == set(saved) and all(
        torch.equal(p.cpu(), saved[n].to(p.dtype)) for n, p in served.items())
    cast = sum(p.dtype == torch_dtype(cfg.dtype) for p in served.values())
    results = server.generate(prompts[:8])
    complete = sum(
        bool(r["length"] >= 1 and np.isfinite(r["logprobs"]).all()
             and np.isfinite(r["values"]).all())
        for r in results)
    del server, saved, served

    per_phase = updates // len(trainer.phase_times)
    phases = [dict(p, rollout_tokens_per_s=p["rollout_tokens"] / p["collect_s"],
                   updates_per_s=per_phase / p["train_s"]) for p in trainer.phase_times]
    record = {
        "definition": {"num_layers_unfrozen": definition[0],
                       "ref_branch_layers": definition[1]},
        "wall_s": wall, "updates": updates, "phases": phases, "evals": evals,
        "max_memory_allocated_bytes": peak,
        "allocated_at_start_bytes": mem_start,
        "reference_parameters": ref_params,
        "reference_bytes": sum(b for _, b in loaded[0]["reference"]) if loaded else None,
        "full_copy_parameters": full_params,
        "full_copy_bytes": sum(b for _, b in loaded[0]["full"]) if loaded else None,
        "loaded_equals_written": bool(loaded) and loaded[0]["equals_written"],
        "k1_tile_per_reference_scoring": scoring_tiles,
        "forwards": trainer.forwards, "decode_forwards": decode_forwards[0],
        "launches": launches, "expected_launches": expected,
        "flash_fwd_variants": variants, "expected_variants": expected_variants,
        "backward_variants": bwd_variants, "expected_backward_variants": expected_bwd_variants,
        "backward_copies": bwd_copies, "plain_attention_calls": plain_calls[0],
        "params_moved": sum(moved.values()), "params": len(moved),
        "frozen_bit_identical": not any(moved[n] for n in frozen), "frozen_tensors": len(frozen),
        "top_moved": all(moved[n] for n in top), "top_tensors": len(top),
        "server_restored": restored, "server_cast_tensors": cast,
        "served_complete": complete,
    }
    log(f"phase 7: {name} " + json.dumps(record))
    ok = (
        record["loaded_equals_written"] and trainer.use_hydra and branch == 2
        and (ref_params, full_params) == (want_ref, want_full)
        and len(scoring_tiles) == len(trainer.phase_times)
        and all(n == n_layer for n in scoring_tiles)
        and updates == BENCH_UPDATES and len(rows) == 2 and finite and freezing_ok
        and launches == expected and variants == expected_variants
        and bwd_variants == expected_bwd_variants and bwd_copies == 0 and plain_calls[0] == 0
        and restored and complete == 8
    )
    log(f"phase 7: {name} {'ok' if ok else 'FAIL'} (loaded backbone equals the written "
        f"checkpoint: {record['loaded_equals_written']}; hydra reference {ref_params} "
        f"parameters, {record['reference_bytes']} B (want {want_ref}), full copy {full_params}, "
        f"{record['full_copy_bytes']} B (want {want_full}); K1 tile per reference scoring "
        f"{scoring_tiles} (want {n_layer} each); updates={updates}, phases={len(rows)}, "
        f"finite={finite}; frozen {len(frozen)} tensors bit-identical: "
        f"{record['frozen_bit_identical']}, top {len(top)} tensors moved: {record['top_moved']}, "
        f"moved {record['params_moved']}/{len(moved)}; launches={launches} vs {expected}, K1 by "
        f"variant {variants} vs {expected_variants}, K2/K3 by variant {bwd_variants} vs "
        f"{expected_bwd_variants}, backward input copies={bwd_copies}, plain attention "
        f"calls={plain_calls[0]}; server restored the checkpoint: {restored}, served "
        f"{complete}/8; wall {wall:.2f} s, peak memory {peak} B, {mem_start} B allocated at "
        "the start)")
    del trainer
    torch.cuda.empty_cache()
    return ok, record


def phase_bench_workload(torch, fa):
    """Phase 7, ``bench.py``'s headline workload: a GPT-2-small checkpoint
    in HF layout with random weights from a seed, written here
    (``config.json`` + ``model.safetensors``, ``transformer.`` names,
    ``Conv1D`` [in, out], no ``lm_head.weight``), trained through
    ``trlx_tpu_torch.train(model_path=...)`` at ``bench.py::_workload_config``
    for each freezing definition and served from each run's checkpoint.
    Returns ``(ok, {definition: record})``."""
    import tempfile

    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    log("phase 7: bench.py's workload; deviations: " + json.dumps([
        {"setting": k, "bench.py": b, "port": p, "why": why}
        for k, b, p, why in BENCH_DEVIATIONS]) + "; one device; total_steps "
        f"{BENCH_WORKLOAD['train']['total_steps']} cut to {BENCH_UPDATES}; eval prompts: the "
        "first 128")
    prompts = bench_prompts()
    records, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt2")
        written = random_backbone(
            torch, GPT2Model(GPT2Config.from_dict(GPT2_HF_CONFIG), device="cuda"), seed=7)
        write_hf_checkpoint(ckpt, GPT2_HF_CONFIG, gpt2_hf_layout(written))
        for name, definition in BENCH_DEFINITIONS.items():
            def_ok, records[name] = run_bench_definition(
                torch, fa, name, definition, ckpt, written, prompts, tmp)
            ok = ok and def_ok
    return ok, records


# configs/ilql_sentiments.yml as written, cut to two epochs of the
# synthetic dataset; what phase 8 runs differently: (setting, the yml's
# value, the port's, why)
ILQL_SAMPLES = 2048
ILQL_UPDATES = 32  # 2 epochs of 2048 // 128 = 16 minibatches, cut from 1000
ILQL_DEVIATIONS = (
    ("model.model_path", "gpt2", "GPT-2 small in HF layout, random weights from a seed",
     "the gpt2 checkpoint is not in the repo"),
    ("model.tokenizer_path", "gpt2", "", "the gpt2 tokenizer is not in the repo: samples are "
     "token ids"),
    ("dataset", "IMDB reviews with sentiment rewards", f"{ILQL_SAMPLES} synthetic (token_list, "
     "action_start) samples from a seed", "the dataset is not in the repo"),
    ("train.total_steps", 1000, ILQL_UPDATES, "the smoke's time limit"),
    ("train.eval_interval", 100, 16, "three evals in the cut run"),
    ("train.checkpoint_interval", 1000, ILQL_UPDATES, "one checkpoint, at the end"),
)
ILQL_TOP_K = 20  # the eval decode's default top_k (DEFAULT_ILQL_GEN_KWARGS)


def ilql_config(checkpoint_dir: str):
    """``configs/ilql_sentiments.yml`` as written, with the deviations
    (``model_path`` is given to ``train``; without it the weights are
    random at GPT-2 small's widths)."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ilql_sentiments.yml")).to_dict()
    arch = {k: GPT2_HF_CONFIG[k] for k in ("vocab_size", "n_positions", "n_embd", "n_layer",
                                            "n_head")}
    cfg["model"].update(model_path="", tokenizer_path="", model_arch=arch)
    cfg["train"].update(total_steps=ILQL_UPDATES, eval_interval=16,
                        checkpoint_interval=ILQL_UPDATES, checkpoint_dir=checkpoint_dir)
    return TRLConfig.from_dict(cfg)


def ilql_dataset(seed: int = 3):
    """``ILQL_SAMPLES`` (token_list, action_start) samples: prompts of 8-24
    ids, responses to at most 64 tokens in all; the reward is the share of
    response ids below 25000 (a host reward, as phase 5's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    samples, rewards = [], []
    for _ in range(ILQL_SAMPLES):
        start = int(rng.integers(8, 25))
        toks = [int(x) for x in rng.integers(0, 50256, int(rng.integers(start + 1, 65)))]
        samples.append((toks, start))
        rewards.append(float(np.mean([t < 25000 for t in toks[start:]])))
    return samples, rewards


def phase_ilql(torch, fa):
    """Phase 8, offline ILQL: ``trlx_tpu_torch.train(dataset=...,
    model_path=...)`` on ``configs/ilql_sentiments.yml`` from a GPT-2-small
    checkpoint in HF layout written here (random weights from a seed),
    with gates on the loaded bits, the stats, the target sync after every
    update, the launches, ``load`` and the eval decode's tokens. Returns
    ``(ok, record)``."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from trlx_tpu_torch.models.heads import CausalLMWithILQLHeads, init_params
    from trlx_tpu_torch.trainer import ilql_trainer
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer, q_parameters

    log("phase 8: offline ILQL on configs/ilql_sentiments.yml; deviations: " + json.dumps([
        {"setting": k, "yml": b, "port": p, "why": why} for k, b, p, why in ILQL_DEVIATIONS]))
    rows, evals, loaded, syncs, sync_ok = [], [], [], [], [True]
    times = {"load_s": 0.0, "update_s": 0.0, "eval_s": 0.0}
    sampler_calls, step_logits, plain_calls, saved_rng = [0], [], [0], []
    decoded = {"tokens": 0, "finite": True, "top_k": True, "live": 0}
    orig = {
        "learn": ILQLTrainer.learn, "train_step": ILQLTrainer.train_step,
        "evaluate": ILQLTrainer.evaluate, "sample": ILQLTrainer.sample,
        "apply": ILQLTrainer._sample_apply, "save": ILQLTrainer.save,
        "load_arch": ilql_trainer.load_arch,
        "fwd": fa.flash_attention_reference, "bwd": fa.flash_attention_backward_reference,
    }

    def load_arch(*a, **kw):
        t0 = time.perf_counter()
        out = orig["load_arch"](*a, **kw)
        times["load_s"] += time.perf_counter() - t0
        return out

    def learn(self):
        loaded.append(state_equal(torch, self.model.transformer, written))
        return orig["learn"](self)

    def train_step(self, mb):
        alpha = self.config.method.alpha
        every = self.config.method.steps_for_target_q_sync
        before = [t.clone() for t in q_parameters(self.target)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = orig["train_step"](self, mb)
        torch.cuda.synchronize()
        times["update_s"] += time.perf_counter() - t0
        rows.append({k: float(v) for k, v in stats.items()})
        after = q_parameters(self.target)
        if self.step % every == 0:
            syncs.append(self.step)
            want = [alpha * q + (1 - alpha) * t for q, t in zip(q_parameters(self.model.heads), before)]
        else:
            want = before
        sync_ok[0] &= all(torch.equal(a, w) for a, w in zip(after, want))
        return stats

    def sample_apply(self, input_ids, *a, **kw):
        sampler_calls[0] += 1
        out = orig["apply"](self, input_ids, *a, **kw)
        step_logits.append(out["logits"][:, -1])
        return out

    def sample(self, prompt_ids, prompt_mask):
        step_logits.clear()
        out = orig["sample"](self, prompt_ids, prompt_mask)
        live = out.response_mask.bool()
        decoded["finite"] &= bool(torch.isfinite(out.logprobs[live]).all())
        for t, logits in enumerate(step_logits):  # the token of step t comes from call t
            kth = torch.topk(logits, ILQL_TOP_K, dim=-1).values[:, -1]
            chosen = logits.gather(1, out.tokens[:, t].long()[:, None])[:, 0]
            decoded["top_k"] &= bool(((chosen >= kth) | ~live[:, t]).all())
        decoded["live"] += int(live.sum())
        decoded["tokens"] += int(live[: len(self.eval_pipeline)].sum())  # the real rows'
        step_logits.clear()
        return out

    def evaluate(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["evaluate"](self)
        torch.cuda.synchronize()
        times["eval_s"] += time.perf_counter() - t0
        evals.append(out)
        return out

    def save(self, directory=None):
        saved_rng.append(self.generator.get_state())  # the final eval draws after it
        return orig["save"](self, directory)

    def counting(key):
        def fn(*a, **kw):
            plain_calls[0] += 1
            return orig[key](*a, **kw)
        return fn

    samples, rewards = ilql_dataset()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, run_dir = os.path.join(tmp, "gpt2"), os.path.join(tmp, "run")
        written = random_backbone(
            torch, GPT2Model(GPT2Config.from_dict(GPT2_HF_CONFIG), device="cuda"), seed=13)
        write_hf_checkpoint(ckpt, GPT2_HF_CONFIG, gpt2_hf_layout(written))
        config = ilql_config(run_dir)
        ILQLTrainer.learn, ILQLTrainer.train_step = learn, train_step
        ILQLTrainer.evaluate, ILQLTrainer.sample = evaluate, sample
        ILQLTrainer._sample_apply, ILQLTrainer.save = sample_apply, save
        ilql_trainer.load_arch = load_arch
        fa.flash_attention_reference = counting("fwd")
        fa.flash_attention_backward_reference = counting("bwd")
        mem_start = reset_peak(torch)
        # count the main path's launches only
        reset_forward_counters(fa)
        reset_backward_counters(fa)
        t0 = time.perf_counter()
        try:
            trainer = trlx_tpu_torch.train(dataset=(samples, rewards), model_path=ckpt,
                                           config=config)
            torch.cuda.synchronize()
        finally:
            ILQLTrainer.learn, ILQLTrainer.train_step = orig["learn"], orig["train_step"]
            ILQLTrainer.evaluate, ILQLTrainer.sample = orig["evaluate"], orig["sample"]
            ILQLTrainer._sample_apply, ILQLTrainer.save = orig["apply"], orig["save"]
            ilql_trainer.load_arch = orig["load_arch"]
            fa.flash_attention_reference = orig["fwd"]
            fa.flash_attention_backward_reference = orig["bwd"]
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {
            "flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
        }
        variants = forward_variant_launches(fa)
        bwd_variants = backward_variant_launches(fa)
        bwd_copies = fa.FLASH_BWD_COPIES
        updates = trainer.step
        finite = all(math.isfinite(v) for r in rows for v in r.values()) and all(
            math.isfinite(v) for e in evals for v in e.values())

        # what moved, against the loaded backbone and the heads' seeded init
        initial = CausalLMWithILQLHeads(trainer.model_config, device="cuda")
        init_params(initial, config.train.seed)
        initial.transformer.load_state_dict(written)
        start = initial.state_dict()
        final = trainer.model.state_dict()
        moved = {n: not torch.equal(final[n], start[n]) for n in final}
        del initial, start, final
        q_names = [n for n in moved if n.startswith(("heads.q1_head.", "heads.q2_head."))]
        backbone_moved = sum(moved[n] for n in moved if n.startswith("transformer."))

        fresh = ILQLTrainer(ilql_config(run_dir))
        fresh.load(run_dir)
        saved, restored_opt = trainer.opt.state_dict(), fresh.opt.state_dict()
        restored = (
            all(torch.equal(fresh.model.state_dict()[n], p)
                for n, p in trainer.model.state_dict().items())
            and all(torch.equal(fresh.target.state_dict()[n], p)
                    for n, p in trainer.target.state_dict().items())
            and all(torch.equal(restored_opt["adamw"]["state"][i][key], value)
                    for i, st in saved["adamw"]["state"].items() for key, value in st.items())
            and (fresh.step, restored_opt["count"]) == (trainer.step, saved["count"])
            and torch.equal(fresh.generator.get_state(), saved_rng[-1])
        )
        del fresh
    n_layer = trainer.model_config.n_layer
    expected_variants = {
        "tile": n_layer * updates, "decode": n_layer * sampler_calls[0], "fma": 0, "copies": 0,
    }
    expected = {"flash_fwd": expected_variants["tile"] + expected_variants["decode"],
                "flash_bwd_dq": n_layer * ILQL_UPDATES, "flash_bwd_dkv": n_layer * ILQL_UPDATES}
    expected_bwd_variants = {k: {"tile": n_layer * ILQL_UPDATES, "fma": 0} for k in BWD_KERNELS}
    record = {
        "wall_s": wall, "checkpoint_load_s": times["load_s"],
        "wall_without_load_s": wall - times["load_s"],
        "updates": updates, "update_s": times["update_s"],
        "updates_per_s": updates / times["update_s"] if times["update_s"] else None,
        "evals": evals, "eval_s": times["eval_s"], "eval_tokens": decoded["tokens"],
        "eval_tokens_per_s": decoded["tokens"] / times["eval_s"] if times["eval_s"] else None,
        "max_memory_allocated_bytes": peak, "allocated_at_start_bytes": mem_start,
        "loaded_equals_written": bool(loaded) and loaded[0],
        "target_syncs": syncs, "target_sync_bit_exact": sync_ok[0],
        "forwards": trainer.forwards, "sampler_calls": sampler_calls[0],
        "launches": launches, "expected_launches": expected,
        "flash_fwd_variants": variants, "expected_variants": expected_variants,
        "backward_variants": bwd_variants, "expected_backward_variants": expected_bwd_variants,
        "backward_copies": bwd_copies, "plain_attention_calls": plain_calls[0],
        "params_moved": sum(moved.values()), "params": len(moved),
        "q_heads_moved": all(moved[n] for n in q_names), "q_head_tensors": len(q_names),
        "backbone_tensors_moved": backbone_moved,
        "load_restores": restored, "eval_logprobs_finite": decoded["finite"],
        "eval_tokens_in_top_k": decoded["top_k"], "eval_live_tokens": decoded["live"],
        "stats_finite": finite,
    }
    log("phase 8: ilql " + json.dumps(record))
    ok = (
        record["loaded_equals_written"] and updates == ILQL_UPDATES
        and len(rows) == ILQL_UPDATES and finite and len(evals) == 3
        and syncs == list(range(5, ILQL_UPDATES + 1, 5)) and sync_ok[0]
        and record["q_heads_moved"] and len(q_names) == 8 and backbone_moved > 0
        and trainer.forwards == updates + sampler_calls[0]
        and launches == expected and variants == expected_variants
        and bwd_variants == expected_bwd_variants and bwd_copies == 0 and plain_calls[0] == 0
        and restored and decoded["finite"] and decoded["top_k"] and decoded["live"] > 0
    )
    log(f"phase 8: ilql {'ok' if ok else 'FAIL'} (loaded backbone equals the written checkpoint: "
        f"{record['loaded_equals_written']}; updates={updates}, stats finite={finite}, "
        f"evals={len(evals)}; target syncs at {syncs}, bit-exact: {sync_ok[0]}; Q heads moved: "
        f"{record['q_heads_moved']} ({len(q_names)} tensors), backbone tensors moved "
        f"{backbone_moved}; launches={launches} vs {expected}, K1 by variant {variants} vs "
        f"{expected_variants}, K2/K3 by variant {bwd_variants} vs {expected_bwd_variants}, "
        f"backward input copies={bwd_copies}, plain attention calls={plain_calls[0]}; load "
        f"restores={restored}; eval logprobs finite={decoded['finite']}, tokens in the top "
        f"{ILQL_TOP_K} of the shifted logits={decoded['top_k']} ({decoded['live']} live); wall "
        f"{wall:.2f} s of which checkpoint load {times['load_s']:.2f} s, "
        f"{record['updates_per_s']} updates/s, {record['eval_tokens_per_s']} eval tokens/s, "
        f"peak memory {peak} B, {mem_start} B allocated at the start)")
    del trainer
    torch.cuda.empty_cache()
    return ok, record


# configs/grpo_sentiments.yml as written (phase 9) and configs/ppo_sentiments.yml
# with train.rollout {engine: continuous} (phase 10), from one GPT-2-small
# checkpoint in HF layout that the smoke writes; what both run differently
# from their yml: (setting, the yml's value, the port's, why)
GPT2_RUN_UPDATES = 64  # two phases of 128 // 16 = 8 minibatches x 4 epochs
GPT2_RUN_DEVIATIONS = (
    ("model.model_path", "lvwerra/gpt2-imdb", "GPT-2-small HF checkpoint, random weights",
     "the checkpoint is not in the repo"),
    ("model.tokenizer_path", "gpt2", "", "the tokenizer and the IMDB prompts are not in the "
     "repo: phase 5's 128 token-id prompts (16-64 ids) and token-id reward"),
    ("train.total_steps", 10000, GPT2_RUN_UPDATES, "two phases"),
)
# the cut seq2seq GRPO run of phase 9: configs/ppo_ul2.yml through the
# Seq2SeqGRPOTrainer, one phase
GRPO_S2S_GROUP = 4  # chunk_size 16 = 4 prompts x 4
GRPO_S2S_UPDATES = 40  # one phase of 128 // 12 = 10 minibatches x 4 epochs
GRPO_S2S_DEVIATIONS = (
    ("train.trainer", "Seq2SeqPPOTrainer", "Seq2SeqGRPOTrainer", "GRPO on the seq2seq path"),
    ("method", "PPOConfig", f"GRPOConfig, group_size {GRPO_S2S_GROUP}, vf_coef 0, "
     "scale_reward null", "GRPO's method section"),
    ("train.total_steps", 10000, GRPO_S2S_UPDATES, "one phase"),
)


def yml_config(name: str, checkpoint_dir: str, model_path: str, updates: int,
               train=None, method=None):
    """``configs/<name>`` as written, from the checkpoint at ``model_path``
    without a tokenizer, cut to ``updates`` updates; ``train`` and
    ``method`` update those sections."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", name)).to_dict()
    cfg["model"].update(model_path=model_path, tokenizer_path="")
    cfg["train"].update(total_steps=updates, checkpoint_dir=checkpoint_dir, **(train or {}))
    cfg["method"].update(method or {})
    return TRLConfig.from_dict(cfg)


def write_gpt2_checkpoint(torch, path: str, seed: int = 7) -> dict:
    """A GPT-2-small checkpoint in HF layout with random weights from
    ``seed``; returns the port-named backbone state it holds."""
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    written = random_backbone(
        torch, GPT2Model(GPT2Config.from_dict(GPT2_HF_CONFIG), device="cuda"), seed)
    write_hf_checkpoint(path, GPT2_HF_CONFIG, gpt2_hf_layout(written))
    return written


def counted_path(torch, fa, fn, patches=()):
    """Run ``fn()`` as one main path: the launch counters set to 0 just
    before it and read just after, every call of the plain attention
    counted, the peak memory read from a clean start, and ``patches``
    ((owner, name, replacement)) in place for the run only. Returns
    ``(fn's result, record)``."""
    plain = [0]

    def counting(f):
        def fn_(*a, **kw):
            plain[0] += 1
            return f(*a, **kw)
        return fn_

    patches = list(patches) + [
        (fa, "flash_attention_reference", counting(fa.flash_attention_reference)),
        (fa, "flash_attention_backward_reference",
         counting(fa.flash_attention_backward_reference))]
    missing = object()  # a name the owner inherits: deleted again after the run
    saved = [(owner, name, vars(owner).get(name, missing)) for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    mem_start = reset_peak(torch)
    reset_forward_counters(fa)
    reset_backward_counters(fa)
    fa.FLASH_BWD_DQ_DBIAS_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for owner, name, value in reversed(saved):
            if value is missing:
                delattr(owner, name)
            else:
                setattr(owner, name, value)
    return out, {
        "wall_s": time.perf_counter() - t0,
        "launches": {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
                     "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
                     "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
                     "flash_bwd_dq_dbias": fa.FLASH_BWD_DQ_DBIAS_LAUNCHES},
        "flash_fwd_variants": forward_variant_launches(fa),
        "backward_variants": backward_variant_launches(fa),
        "backward_copies": fa.FLASH_BWD_COPIES,
        "plain_attention_calls": plain[0],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_at_start_bytes": mem_start,
    }


def phase_rows(trainer) -> list:
    """Per collect phase: collect and train seconds, rollout tokens/s,
    updates/s."""
    per_phase = trainer.step // len(trainer.phase_times)
    return [dict(p, rollout_tokens_per_s=p["rollout_tokens"] / p["collect_s"],
                 updates_per_s=per_phase / p["train_s"]) for p in trainer.phase_times]


def restores(torch, trainer, fresh, saved_rng) -> bool:
    """Whether ``fresh``, after ``load``, holds ``trainer``'s saved state
    exactly: parameters, Adam moments, counters, KL state, generator."""
    saved, loaded = trainer.opt.state_dict(), fresh.opt.state_dict()
    return (
        all(torch.equal(fresh.model.state_dict()[n], p)
            for n, p in trainer.model.state_dict().items())
        and all(torch.equal(loaded["adamw"]["state"][i][key], value)
                for i, st in saved["adamw"]["state"].items() for key, value in st.items())
        and (fresh.step, fresh.kl_coef, fresh.mean_kl, loaded["count"])
        == (trainer.step, trainer.kl_coef, trainer.mean_kl, saved["count"])
        and torch.equal(fresh.generator.get_state(), saved_rng[-1])
    )


def instrument(torch, cls, backbone: str, written: dict, watch):
    """Patches (for ``counted_path``) that record a PPO-family trainer's
    run: the update stats per phase, the evals, the generator as saved,
    whether the loaded backbone (``model.<backbone>``) equals ``written``
    before the first update, and each pushed rollout chunk; ``watch`` is
    the dict they fill."""
    from trlx_tpu_torch.pipeline.ppo_buffer import PPORolloutBuffer

    watch.update(rows=[], evals=[], saved_rng=[], loaded=[], chunks=[], backbone=backbone,
                 written=written)
    orig = {n: getattr(cls, n) for n in ("learn", "_train_on", "evaluate", "save")}
    push = PPORolloutBuffer.push

    def learn(self):
        watch["loaded"].append(state_equal(torch, getattr(self.model, backbone), written))
        return orig["learn"](self)

    def train_on(self, *a, **kw):
        out = orig["_train_on"](self, *a, **kw)
        watch["rows"].append(out[0])
        return out

    def evaluate(self):
        out = orig["evaluate"](self)
        watch["evals"].append(out)
        return out

    def save(self, directory=None):
        watch["saved_rng"].append(self.generator.get_state())
        return orig["save"](self, directory)

    def record_push(self, batch):
        watch["chunks"].append(batch)
        return push(self, batch)

    return [(cls, "learn", learn), (cls, "_train_on", train_on), (cls, "evaluate", evaluate),
            (cls, "save", save), (PPORolloutBuffer, "push", record_push)]


def run_gates(torch, trainer, watch, record) -> dict:
    """What every trained path gates: the loaded bits, finite stats, moved
    backbone tensors (against the written checkpoint), 0 ``fma`` launches,
    input copies and plain calls."""
    import numpy as np

    finite = all(np.isfinite(v).all() for r in watch["rows"] for v in r.values()) and all(
        math.isfinite(v) for e in watch["evals"] for v in e.values())
    backbone = getattr(trainer.model, watch["backbone"]).state_dict()
    changed = sum(not torch.equal(t.cpu(), watch["written"][n]) for n, t in backbone.items())
    return {
        "loaded_equals_written": watch["loaded"] == [True],
        "finite": finite,
        "params_changed": changed,
        "no_fma_copies_or_plain": (
            record["flash_fwd_variants"]["fma"] == 0 and record["flash_fwd_variants"]["copies"] == 0
            and all(v["fma"] == 0 for v in record["backward_variants"].values())
            and record["backward_copies"] == 0 and record["plain_attention_calls"] == 0),
    }


def group_gates(chunks, returns, G: int) -> dict:
    """GRPO's stored rollouts, chunk by chunk: every group of ``G`` rows
    holds one prompt; each row's advantage is one value over its response
    (0 past it); every group whose KL-shaped returns have a population std
    above 1e-2 has advantages of mean |.| < 1e-4 and population std within
    1e-3 of 1."""
    same_query = broadcast = True
    checked = groups = 0
    worst_mean = worst_std = 0.0
    for batch, ret in zip(chunks, returns):
        n = batch.query_tokens.shape[0] // G
        q = batch.query_tokens.view(n, G, -1)
        same_query &= bool((q == q[:, :1]).all())
        mask = batch.response_mask.float()
        adv = batch.rewards[:, 0]
        broadcast &= bool((batch.rewards == adv[:, None] * mask).all())
        adv, ret = adv.view(n, G).double(), ret.view(n, G).double()
        sel = ret.std(1, correction=0) > 1e-2
        groups += n
        checked += int(sel.sum())
        if sel.any():
            worst_mean = max(worst_mean, adv[sel].mean(1).abs().max().item())
            worst_std = max(worst_std, (adv[sel].std(1, correction=0) - 1).abs().max().item())
    return {"groups": groups, "groups_checked": checked, "same_query": same_query,
            "broadcast": broadcast, "max_abs_group_mean": worst_mean,
            "max_abs_group_std_minus_1": worst_std,
            "ok": same_query and broadcast and checked > 0 and worst_mean < 1e-4
            and worst_std < 1e-3}


def value_head_watch(cls, watch):
    """A patch of ``cls.train_step`` counting the updates after which any
    value-head gradient element is nonzero (GRPO trains no value head)."""
    step = cls.train_step
    watch["value_grad_nonzero"] = 0

    def train_step(self, mb):
        out = step(self, mb)
        watch["value_grad_nonzero"] += any(
            p.grad is not None and bool(p.grad.any())
            for n, p in self.model.named_parameters() if n.startswith("v_head."))
        return out

    return [(cls, "train_step", train_step)]


def value_head_moments_zero(trainer) -> bool:
    return all(not trainer.opt.adamw.state[p]["exp_avg"].any()
               for n, p in trainer.model.named_parameters()
               if n.startswith("v_head.") and p in trainer.opt.adamw.state)


def returns_watch(watch):
    """A patch of ``PPOTrainer._shape_rewards`` recording each chunk's
    KL-shaped returns (the sum of the shaped rewards, before GRPO whitens
    them)."""
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    shape = PPOTrainer._shape_rewards
    watch["returns"] = []

    def shape_rewards(self, *a, **kw):
        rewards, mean_kl = shape(self, *a, **kw)
        watch["returns"].append(rewards.sum(1))
        return rewards, mean_kl

    return [(PPOTrainer, "_shape_rewards", shape_rewards)]


def phase_grpo(torch, fa, ckpt: str, written: dict):
    """Phase 9: GRPO on ``configs/grpo_sentiments.yml`` through
    ``trlx_tpu_torch.train`` from the GPT-2-small checkpoint at ``ckpt``
    (two phases, 64 updates), then the cut seq2seq GRPO run. Returns
    ``(ok, {"causal": record, "seq2seq": record})``."""
    import tempfile

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    log("phase 9: GRPO on configs/grpo_sentiments.yml; deviations: " + json.dumps([
        {"setting": k, "yml": y, "port": p, "why": why}
        for k, y, p, why in GPT2_RUN_DEVIATIONS]))
    watch = {"decode_forwards": 0}
    apply = PPOTrainer._apply

    def counted_apply(self, input_ids, *a, **kw):
        watch["decode_forwards"] += input_ids.shape[1] <= 16  # the sampler's steps
        return apply(self, input_ids, *a, **kw)

    records, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "grpo")

        def config():
            return yml_config("grpo_sentiments.yml", run_dir, ckpt, GPT2_RUN_UPDATES)

        patches = (instrument(torch, GRPOTrainer, "transformer", written, watch)
                   + value_head_watch(GRPOTrainer, watch) + returns_watch(watch)
                   + [(PPOTrainer, "_apply", counted_apply)])
        watch["decode_forwards"] = 0
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=training_prompts(), config=config()), patches)
        G = trainer.group_size
        fresh = GRPOTrainer(config())
        fresh.load(run_dir)
        restored = restores(torch, trainer, fresh, watch["saved_rng"])
        del fresh
    gates = run_gates(torch, trainer, watch, record)
    groups = group_gates(watch["chunks"], watch["returns"], G)
    tile = N_LAYER * (trainer.forwards - watch["decode_forwards"])
    expected = {
        "variants": {"tile": tile, "decode": N_LAYER * watch["decode_forwards"],
                     "fma": 0, "copies": 0},
        "backward": {k: {"tile": N_LAYER * GPT2_RUN_UPDATES, "fma": 0} for k in BWD_KERNELS},
    }
    record.update(updates=trainer.step, group_size=G, phases=phase_rows(trainer),
                  evals=watch["evals"], forwards=trainer.forwards,
                  decode_forwards=watch["decode_forwards"], groups=groups, gates=gates,
                  value_grad_nonzero_updates=watch["value_grad_nonzero"],
                  value_moments_zero=value_head_moments_zero(trainer), restored=restored,
                  expected=expected)
    causal_ok = (
        trainer.step == GPT2_RUN_UPDATES and len(watch["rows"]) == 2 and G == 8
        and all(v for k, v in gates.items() if k != "params_changed")
        and gates["params_changed"] > 0 and groups["ok"]
        and watch["value_grad_nonzero"] == 0 and record["value_moments_zero"] and restored
        and record["flash_fwd_variants"] == expected["variants"]
        and record["backward_variants"] == expected["backward"]
    )
    log("phase 9: grpo " + json.dumps(record))
    log(f"phase 9: grpo {'ok' if causal_ok else 'FAIL'} (updates={trainer.step}, gates "
        f"{gates}, groups {groups}, updates with a nonzero value-head gradient="
        f"{watch['value_grad_nonzero']}, value-head Adam moments zero="
        f"{record['value_moments_zero']}, load restores={restored}, K1 by variant "
        f"{record['flash_fwd_variants']} vs {expected['variants']}, K2/K3 by variant "
        f"{record['backward_variants']} vs {expected['backward']})")
    records["causal"], ok = record, ok and causal_ok
    del trainer
    s2s_ok, records["seq2seq"] = run_grpo_seq2seq(torch, fa)
    return ok and s2s_ok, records


def run_grpo_seq2seq(torch, fa):
    """Phase 9's cut seq2seq GRPO run: ``configs/ppo_ul2.yml`` through the
    ``Seq2SeqGRPOTrainer`` (groups of 4, one phase of 40 updates) from a
    UL2 checkpoint in HF layout written here. Gates: the loaded bits,
    finite stats, moved parameters, the group and value-head gates of the
    causal run, K2 = K3 = 24 x the updates, K2 with the bias gradient 16 x,
    all ``tile``; no ``fma`` launch, input copy or plain call."""
    import tempfile

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.grpo_trainer import Seq2SeqGRPOTrainer

    log("phase 9: seq2seq GRPO on configs/ppo_ul2.yml; deviations: " + json.dumps([
        {"setting": k, "yml": y, "port": p, "why": why}
        for k, y, p, why in GRPO_S2S_DEVIATIONS]))
    watch = {}
    prompts, response_gt = ul2_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, run_dir = os.path.join(tmp, "ul2"), os.path.join(tmp, "run")
        written = write_ul2_checkpoint(torch, ckpt)
        config = yml_config(
            "ppo_ul2.yml", run_dir, ckpt, GRPO_S2S_UPDATES,
            train={"trainer": "Seq2SeqGRPOTrainer"},
            method={"name": "GRPOConfig", "group_size": GRPO_S2S_GROUP, "vf_coef": 0.0,
                    "scale_reward": None})
        patches = (instrument(torch, Seq2SeqGRPOTrainer, "t5", written, watch)
                   + value_head_watch(Seq2SeqGRPOTrainer, watch) + returns_watch(watch))
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=ul2_reward, prompts=prompts, response_gt=response_gt, config=config),
            patches)
    cfg = trainer.model_config
    n_attn = cfg.num_layers + 2 * cfg.num_decoder_layers
    updates = trainer.step
    gates = run_gates(torch, trainer, watch, record)
    groups = group_gates(watch["chunks"], watch["returns"], trainer.group_size)
    expected = {"flash_bwd_dq": n_attn * updates, "flash_bwd_dkv": n_attn * updates,
                "flash_bwd_dq_dbias": (cfg.num_layers + cfg.num_decoder_layers) * updates}
    got = {k: record["launches"][k] for k in expected}
    record.update(updates=updates, phases=phase_rows(trainer), evals=watch["evals"],
                  groups=groups, gates=gates,
                  value_grad_nonzero_updates=watch["value_grad_nonzero"],
                  value_moments_zero=value_head_moments_zero(trainer), expected=expected)
    ok = (
        updates == GRPO_S2S_UPDATES and trainer.group_size == GRPO_S2S_GROUP
        and all(v for k, v in gates.items() if k != "params_changed")
        and gates["params_changed"] > 0 and groups["ok"] and watch["value_grad_nonzero"] == 0
        and record["value_moments_zero"] and got == expected
        and all(v["tile"] == n_attn * updates for v in record["backward_variants"].values())
    )
    log("phase 9: seq2seq grpo " + json.dumps(record))
    log(f"phase 9: seq2seq grpo {'ok' if ok else 'FAIL'} (updates={updates}, gates {gates}, "
        f"groups {groups}, updates with a nonzero value-head gradient="
        f"{watch['value_grad_nonzero']}, K2/K3 launches {got} vs {expected})")
    del trainer
    return ok, record


def phase_continuous(torch, fa, ckpt: str, written: dict):
    """Phase 10: PPO on ``configs/ppo_sentiments.yml`` with ``train.rollout:
    {engine: continuous}`` (128 slots, admit and harvest 32, block 16,
    poll 1) through ``trlx_tpu_torch.train`` from the GPT-2-small
    checkpoint at ``ckpt``, two phases (64 updates). Gates per collect
    phase: the engine admitted, completed and recycled 128 rows, none
    pending, 0 < slot_util <= 1, the buffer holds 128 rows with each draw
    index once, K1 ``tile`` = 12 x (admission prefills + reference
    scorings) and ``decode`` = 12 x decode steps during the collection;
    over the run: finite stats, moved parameters, K1 by variant as phase 5
    counts it, K2 = K3 = 12 x 64 ``tile``, no ``fma`` launch, input copy or
    plain call, and ``load`` exact. Then the fixed sampler under per-row
    RNG and the engine decode the same 128 prompts at one phase seed, and
    the share of rows with the same tokens is printed (bf16 and another
    batch shape can flip a near-tie: a report, not a gate). Prints the
    engine's host time per decode step and the per-row noise's share."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.inference import engine as engine_mod
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    log("phase 10: continuous-engine PPO on configs/ppo_sentiments.yml, train.rollout "
        "{engine: continuous}; deviations: " + json.dumps([
            {"setting": k, "yml": y, "port": p, "why": why}
            for k, y, p, why in GPT2_RUN_DEVIATIONS]))
    Engine = engine_mod.ContinuousBatchingEngine
    watch = {"decode_forwards": 0, "collects": [], "decode_host_s": 0.0, "noise_host_s": 0.0,
             "scorings": 0}
    orig = {"apply": PPOTrainer._apply, "score_ref": PPOTrainer.score_ref,
            "make_experience": PPOOrchestrator.make_experience, "drive": Engine.drive,
            "decode_step": Engine.decode_step, "row_noise": engine_mod.row_noise}

    def counted_apply(self, input_ids, *a, **kw):
        watch["decode_forwards"] += input_ids.shape[1] <= 16  # the engine's decode steps
        return orig["apply"](self, input_ids, *a, **kw)

    def score_ref(self, *a, **kw):
        watch["scorings"] += 1
        return orig["score_ref"](self, *a, **kw)

    def drive(self, target):
        for group in orig["drive"](self, target):
            watch["collects"][-1]["harvested"].extend(group["rows"])
            yield group

    def decode_step(self):
        t0 = time.perf_counter()
        out = orig["decode_step"](self)
        watch["decode_host_s"] += time.perf_counter() - t0
        return out

    def row_noise(*a, **kw):
        t0 = time.perf_counter()
        out = orig["row_noise"](*a, **kw)
        watch["noise_host_s"] += time.perf_counter() - t0
        return out

    def make_experience(self, *a, **kw):
        entry = {"harvested": []}
        watch["collects"].append(entry)
        before = forward_variant_launches(fa)
        scorings0 = watch["scorings"]
        stats = orig["make_experience"](self, *a, **kw)
        after = forward_variant_launches(fa)
        engine = self.trainer.rollout_engine_obj
        entry.update(
            stats={k: v for k, v in stats.items() if k.startswith("engine/")},
            pending=engine.pending, buffer_rows=len(self.trainer.buffer),
            launches={k: after[k] - before[k] for k in after},
            expected={"tile": N_LAYER * (engine.stats.prefills + watch["scorings"] - scorings0),
                      "decode": N_LAYER * engine.stats.decode_steps, "fma": 0, "copies": 0})
        return stats

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "continuous")

        def config():
            return yml_config("ppo_sentiments.yml", run_dir, ckpt, GPT2_RUN_UPDATES,
                              train={"rollout": {"engine": "continuous"}})

        patches = instrument(torch, PPOTrainer, "transformer", written, watch) + [
            (PPOTrainer, "_apply", counted_apply), (PPOTrainer, "score_ref", score_ref),
            (PPOOrchestrator, "make_experience", make_experience), (Engine, "drive", drive),
            (Engine, "decode_step", decode_step), (engine_mod, "row_noise", row_noise)]
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=training_prompts(), config=config()), patches)
        fresh = PPOTrainer(config())
        fresh.load(run_dir)
        restored = restores(torch, trainer, fresh, watch["saved_rng"])
        del fresh
    engine = trainer.rollout_engine_obj
    gates = run_gates(torch, trainer, watch, record)
    collects = []
    for c in watch["collects"]:
        st = c["stats"]
        c["ok"] = (
            st["engine/admitted"] == st["engine/completed"] == st["engine/slot_recycles"] == 128
            and c["pending"] == 0 and 0 < st["engine/slot_util"] <= 1
            and c["buffer_rows"] == 128 and sorted(c["harvested"]) == list(range(128))
            and c["launches"] == c["expected"])
        collects.append(dict(c, harvested_in_draw_order=c["harvested"] == sorted(c["harvested"]),
                             harvested=len(c["harvested"])))
    steps = sum(c["stats"]["engine/decode_steps"] for c in watch["collects"])
    expected = {
        "variants": {"tile": N_LAYER * (trainer.forwards - watch["decode_forwards"]),
                     "decode": N_LAYER * watch["decode_forwards"], "fma": 0, "copies": 0},
        "backward": {k: {"tile": N_LAYER * GPT2_RUN_UPDATES, "fma": 0} for k in BWD_KERNELS},
    }
    record.update(
        updates=trainer.step, phases=phase_rows(trainer), evals=watch["evals"],
        collects=collects, gates=gates, restored=restored, forwards=trainer.forwards,
        decode_forwards=watch["decode_forwards"], expected=expected,
        engine={"num_slots": engine.num_slots, "admit_width": engine.admit_width,
                "harvest_width": engine.harvest_width, "block_size": engine.block_size,
                "poll_interval": engine.done_poll_interval},
        decode_steps=steps,
        host_ms_per_decode_step=1e3 * watch["decode_host_s"] / max(steps, 1),
        row_noise_host_ms_per_step=1e3 * watch["noise_host_s"] / max(steps, 1))
    ok = (
        trainer.step == GPT2_RUN_UPDATES and len(watch["rows"]) == 2 and len(collects) == 2
        and all(c["ok"] for c in collects)
        and all(v for k, v in gates.items() if k != "params_changed")
        and gates["params_changed"] > 0 and restored
        and (engine.num_slots, engine.admit_width, engine.harvest_width) == (128, 32, 32)
        and record["flash_fwd_variants"] == expected["variants"]
        and record["backward_variants"] == expected["backward"]
    )
    # the two engines on the same prompts at one phase seed (not counted:
    # the main path's counts were read above)
    pipe = PromptPipeline(training_prompts(), trainer.query_length)
    ids, mask = pipe.input_ids[:128], pipe.attention_mask[:128]
    seed = 20261017
    engine.start_phase(seed)
    engine.submit(ids, mask)
    by_row = {}
    for group in engine.drive(128):
        for j, r in enumerate(group["rows"]):
            by_row[r] = group["tokens"][j]
    fixed = trainer._sampler(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                             rows=list(range(128)), phase_seed=seed)
    fixed_tokens = fixed.tokens.cpu().numpy()
    same = [bool(np.array_equal(by_row[r], fixed_tokens[r])) for r in range(128)]
    record["fixed_vs_engine_rows_identical"] = sum(same) / 128
    log("phase 10: continuous " + json.dumps(record))
    log(f"phase 10: continuous {'ok' if ok else 'FAIL'} (updates={trainer.step}, collects "
        f"{[{k: c[k] for k in ('ok', 'stats', 'launches', 'expected')} for c in collects]}, "
        f"gates {gates}, load restores={restored}, K1 by variant "
        f"{record['flash_fwd_variants']} vs {expected['variants']}, K2/K3 by variant "
        f"{record['backward_variants']} vs {expected['backward']}; host ms per decode step "
        f"{record['host_ms_per_decode_step']:.3f}, of it the per-row noise "
        f"{record['row_noise_host_ms_per_step']:.3f}; fixed sampler (per-row RNG) vs engine, "
        f"rows with identical tokens: {record['fixed_vs_engine_rows_identical']:.4f} (report)")
    del trainer
    return ok, record


def device_summary(prof, wall: float) -> dict:
    """Summarise a torch.profiler run's device timeline: busy share of the
    wall, and device time by kernel."""
    import tempfile

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
    # the port's kernels by name, every variant and instantiation summed
    ours = {}
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        rows = [(c, t) for n, (c, t) in by_name.items() if f"{kernel}_" in n]
        count, total = sum(c for c, _ in rows), sum(t for _, t in rows)
        ours[kernel] = {"count": count, "device_ms": total / 1e3,
                        "share_of_busy": total / busy if busy else 0.0}
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
        "kernels_launched": len(kernels),
        "port_kernels": ours,
        "top_kernels": [
            {"name": n[:120], "count": c, "device_ms": t / 1e3,
             "share_of_busy": t / busy}
            for n, (c, t) in top
        ],
    }


def profile_paths(torch, path: str) -> None:
    """``--profile PATH``: under torch.profiler, serve the same 64 prompts
    again, run one PPO phase (32 updates) of the training geometry, a cut
    seq2seq run (two 16-prompt chunks, 8 updates, one-chunk evals: the
    full phase's trace would hold some 10^6 events), one PPO phase (32
    updates) of phase 7's workload at each freezing definition, one epoch
    (16 updates, evals at 0 and 16, the checkpoint at the end) of phase
    8's ILQL run (random weights: loading is not profiled), and one phase
    (32 updates, the checkpoint load included) each of phase 9's GRPO run
    and phase 10's continuous-engine run; write each run's device summary
    as JSON at ``path``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    import trlx_tpu_torch
    from trlx_tpu_torch.inference.server import InferenceServer

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    summary = {}
    server = InferenceServer(serving_config(), seed=0)
    with profile(activities=activities) as prof:
        _, _, wall = serve(torch, server, serving_prompts())
    summary["serving"] = device_summary(prof, wall)
    del server
    with tempfile.TemporaryDirectory() as tmp:
        config = training_config(tmp)
        config.train.total_steps = 32
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            trlx_tpu_torch.train(reward_fn=training_reward, prompts=training_prompts(),
                                 config=config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summary["training"] = device_summary(prof, wall)
    prompts, response_gt = ul2_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        config = ul2_training_config(tmp)
        config.method.num_rollouts, config.train.total_steps = 32, 8
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            trlx_tpu_torch.train(reward_fn=ul2_reward, prompts=prompts,
                                 response_gt=response_gt, eval_prompts=prompts[:16],
                                 config=config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summary["seq2seq_training"] = device_summary(prof, wall)
    prompts = bench_prompts()
    for name, definition in BENCH_DEFINITIONS.items():
        with tempfile.TemporaryDirectory() as tmp:
            config = bench_config(definition, tmp)
            config.train.total_steps = 32
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                trlx_tpu_torch.train(reward_fn=bench_reward, prompts=prompts,
                                     eval_prompts=prompts[:128], config=config)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        summary["bench_" + name] = device_summary(prof, wall)
    samples, rewards = ilql_dataset()
    with tempfile.TemporaryDirectory() as tmp:
        config = ilql_config(tmp)
        config.train.total_steps = config.train.checkpoint_interval = 16
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            trlx_tpu_torch.train(dataset=(samples, rewards), config=config)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summary["ilql"] = device_summary(prof, wall)
    prompts = training_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt2")
        write_gpt2_checkpoint(torch, ckpt)
        for name, cfg_name, train in (
                ("grpo", "grpo_sentiments.yml", {}),
                ("continuous_engine", "ppo_sentiments.yml",
                 {"rollout": {"engine": "continuous"}})):
            config = yml_config(cfg_name, os.path.join(tmp, name), ckpt, 32, train=train)
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                trlx_tpu_torch.train(reward_fn=training_reward, prompts=prompts, config=config)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            summary[name] = device_summary(prof, wall)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    for name, run in summary.items():
        log(f"profile {name}: " + json.dumps({k: run[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "kernels_launched",
            "port_kernels")}))
        for row in run["top_kernels"][:12]:
            log(f"profile {name}: {row['device_ms']:9.2f} ms {row['share_of_busy']:6.1%} "
                f"x{row['count']:<6d} {row['name'][:90]}")


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="also profile the serving and training paths; "
                             "write the summaries here")
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

    build_ok, build = phase_build(fa)
    fwd_checks, timed = phase_kernel(torch, fa, attn)
    train_fwd_checks, bwd_checks, train_timed, bwd_timed = phase_backward(torch, fa, attn)
    t5_fwd_checks, t5_bwd_checks, t5_timed, t5_bwd_timed = phase_t5_kernels(torch, fa, attn)
    fwd_checks += train_fwd_checks + t5_fwd_checks
    bwd_checks += t5_bwd_checks
    timed.update(train_timed)
    timed.update(t5_timed)
    kernel_ok = all(c["ok"] for c in fwd_checks + bwd_checks) and all(
        row["packed_ok"] for row in timed.values())
    model_ok = (phase_model(torch, fa) & phase_model_backward(torch, fa)
                & phase_t5_model_backward(torch, fa) & phase_logprob_chunk(torch))
    serving_ok, serving = phase_serving(torch, fa)
    training_ok, training = phase_training(torch, fa)
    seq2seq_ok, seq2seq = phase_t5_training(torch, fa)
    bench_ok, bench = phase_bench_workload(torch, fa)
    ilql_ok, ilql = phase_ilql(torch, fa)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # one GPT-2-small checkpoint for phases 9 and 10
        gpt2_ckpt = os.path.join(tmp, "gpt2")
        gpt2_written = write_gpt2_checkpoint(torch, gpt2_ckpt)
        grpo_ok, grpo = phase_grpo(torch, fa, gpt2_ckpt, gpt2_written)
        continuous_ok, continuous = phase_continuous(torch, fa, gpt2_ckpt, gpt2_written)
        del gpt2_written
    # the paths of phases 9 and 10, each counted on its own
    new_paths = {"grpo": grpo["causal"], "grpo_seq2seq": grpo["seq2seq"],
                 "continuous_engine": continuous}
    if args.profile:
        profile_paths(torch, args.profile)

    def entry(shape):
        return {k: timed[(shape, "bfloat16")][k] for k in (
            "shape", "variant", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}

    decode = entry("serving_decode")
    k1_spills = [build[k]["spill_bytes"] for k in GATED_KERNELS["flash_fwd"]]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": SOURCES["flash_fwd"],
        "replaces": REPLACES["flash_fwd"],
        # K1 runs on every path; each path's count was read on its own
        "launches": (serving["flash_fwd_launches"] + training["launches"]["flash_fwd"]
                     + seq2seq["launches"]["flash_fwd"]
                     + sum(r["launches"]["flash_fwd"] for r in bench.values())
                     + ilql["launches"]["flash_fwd"]
                     + sum(r["launches"]["flash_fwd"] for r in new_paths.values())),
        "launches_by_path": {"serving": serving["flash_fwd_launches"],
                             "training": training["launches"]["flash_fwd"],
                             "seq2seq_training": seq2seq["launches"]["flash_fwd"],
                             **{"bench_" + n: r["launches"]["flash_fwd"]
                                for n, r in bench.items()},
                             "ilql": ilql["launches"]["flash_fwd"],
                             **{n: r["launches"]["flash_fwd"] for n, r in new_paths.items()}},
        "max_abs_err": max(c["max_abs_err_o"] for c in fwd_checks),
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "timed_shape": "serving decode bf16 " + decode["shape"],
        "prefill": entry("serving_prefill"),
        # every path shape of K1 in bf16, with the variant that ran
        "shapes": {shape: entry(shape) for shape in (
            "serving_prefill", "serving_decode", *TRAINING_SHAPES.values(), *T5_SHAPES)},
        "f32": {s: {k: timed[(s, "float32")][k] for k in (
                    "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms")}
                for s in ("serving_prefill", "serving_decode")},
        "launches_by_variant": {"serving": serving["flash_fwd_variants"],
                                "training": training["flash_fwd_variants"],
                                "seq2seq_training": seq2seq["flash_fwd_variants"],
                                **{"bench_" + n: r["flash_fwd_variants"]
                                   for n, r in bench.items()},
                                "ilql": ilql["flash_fwd_variants"],
                                **{n: r["flash_fwd_variants"] for n, r in new_paths.items()}},
        "tile_tensor_core_instructions": build["flash_fwd_tile_kernel"]["tensor_core_instructions"],
        # None, never an unmeasured 0, when a K1 kernel is missing from the report
        "k1_spill_bytes": None if None in k1_spills else sum(k1_spills),
    }]
    t5_update = [n for n, shape in T5_SHAPES.items() if shape[4]]
    for name, outputs in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
        row = bwd_timed[("train", name)]
        ilql_row = bwd_timed[("ilql_update", name)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the training paths; each path's count was read on its own
            "launches": (training["launches"][name] + seq2seq["launches"][name]
                         + sum(r["launches"][name] for r in bench.values())
                         + ilql["launches"][name]
                         + sum(r["launches"][name] for r in new_paths.values())),
            "launches_by_path": {"training": training["launches"][name],
                                 "seq2seq_training": seq2seq["launches"][name],
                                 **{"bench_" + n: r["launches"][name]
                                    for n, r in bench.items()},
                                 "ilql": ilql["launches"][name],
                                 **{n: r["launches"][name] for n, r in new_paths.items()}},
            "max_abs_err": max(c[f"max_abs_err_{o}"] for c in bwd_checks for o in outputs),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "variant", "wrapper_ms")},
            "timed_shape": "training bf16 " + row["shape"],
            "ilql_update": {k: ilql_row[k] for k in (
                "shape", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "t5_shapes": {n: {k: t5_bwd_timed[(n, name)][k] for k in (
                "shape", "dbias", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for n in t5_update},
            "launches_by_variant": {"training": training["backward_variants"][name],
                                    "seq2seq_training": seq2seq["backward_variants"][name],
                                    **{"bench_" + n: r["backward_variants"][name]
                                       for n, r in bench.items()},
                                    "ilql": ilql["backward_variants"][name],
                                    **{n: r["backward_variants"][name]
                                       for n, r in new_paths.items()}},
            **{k: build[f"{name}_tile_kernel"][k] for k in (
                "spill_bytes", "registers", "tensor_core_instructions")},
        })
    # K2 with the bias gradient: the same kernel's other instantiation,
    # timed at the encoder's self-attention (its largest shape)
    row = t5_bwd_timed[("t5_encoder_self", "flash_bwd_dq")]
    kernels.append({
        "name": "flash_bwd_dq_dbias",
        "route": "cuda",
        "source": SOURCES["flash_bwd_dq"],
        "replaces": REPLACES["flash_bwd_dq"],
        "launches": (seq2seq["launches"]["flash_bwd_dq_dbias"]
                     + grpo["seq2seq"]["launches"]["flash_bwd_dq_dbias"]),
        "launches_by_path": {"seq2seq_training": seq2seq["launches"]["flash_bwd_dq_dbias"],
                             "grpo_seq2seq": grpo["seq2seq"]["launches"]["flash_bwd_dq_dbias"]},
        "max_abs_err": max(c["max_abs_err_dbias"] for c in bwd_checks if "max_abs_err_dbias" in c),
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "variant")},
        "timed_shape": "seq2seq update bf16 encoder self-attention " + row["shape"],
        "t5_shapes": {n: {k: t5_bwd_timed[(n, "flash_bwd_dq")][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for n in t5_update if T5_SHAPES[n][3] in ("encoder", "decoder")},
        **{k: build["flash_bwd_dq_tile_kernel_dbias"][k] for k in (
            "spill_bytes", "registers", "tensor_core_instructions")},
    })
    log(", ".join(card) if card else "nvidia-smi: no output")
    print(json.dumps({"kernels": kernels}), flush=True)
    phases = (("build", build_ok), ("kernel", kernel_ok), ("model", model_ok),
              ("serving", serving_ok), ("training", training_ok),
              ("seq2seq_training", seq2seq_ok), ("bench_workload", bench_ok),
              ("ilql", ilql_ok), ("grpo", grpo_ok), ("continuous_engine", continuous_ok))
    if not all(ok for _, ok in phases):
        failed = [n for n, ok in phases if not ok]
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
