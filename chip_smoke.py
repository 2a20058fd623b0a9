#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: ``python3 chip_smoke.py`` (one H100).

Phases, each fatal on failure:

1. build — compile the flash-attention kernels (``trlx_tpu_torch/csrc/
   flash_fwd.cu``: K1 in five variants, ``tile`` for bf16 with Q > 16 on
   the tensor cores, ``decode`` for bf16 with Q <= 16, ``decode_int8``
   for the int8 KV cache's decode, ``fma`` for f32, ``split3`` for the
   ring's f32 blocks on the tensor cores through three bf16 planes;
   ``flash_bwd.cu``: K2 dQ and K3 dK/dV, each ``tile`` for
   bf16 on the tensor cores, ``fma`` for f32 and ``split3`` for the ring's
   blocks, K2's ``tile`` in two instantiations, without and with the bias
   gradient; every kernel instantiated for head dims 16, 24, 32, 64, 96,
   128 and 256, each instantiation gated on its own; ``split_planes.cu``:
   the split3 pre-pass; ``kv_quant.cu``: the int8 cache's quantizing
   write, for bf16 and f32 inputs) with ``nvcc`` for ``sm_90a``, all four
   sources at once, and beside them each source's device code alone with
   ``ptxas -v`` (every run, so the report holds when the libraries were
   already built); print ``ptxas``'s registers, shared memory and spills
   per kernel, the split3 kernels' dynamic shared memory, and the count
   of tensor-core instructions (``HMMA`` or ``HGMMA``) in each kernel's
   SASS (``cuobjdump -sass``). A spill in any gated kernel, one of them
   missing from the report, or a tile or split3 kernel without
   tensor-core instructions fails the phase;
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
   ragged Q/K with a full-rank bias and a per-head bias, Q <= 16 causal
   with rows that see only padding (the forward's whole visit), two long
   cases (16 query chunks and key tiles under the causal flag; 64 key
   tiles with peaked logits), and ILQL's update (B=128, T=64, causal +
   right padding), in bf16 (``tile``) and f32 (``fma``); K1 also at ILQL's
   eval prefill (B=128, Q=16, K=64, left padding: the ``decode`` variant
   at its largest Q) and eval decode step (Q=1, K=64); K1 at the serving
   tier's (phase 11) chunked-prefill forward (A=8, W=128 queries against
   the 512-key prompt view, ``tile``), the same chunk with keys 0..255 all
   pad and holding garbage (its output must equal the call on the real
   keys alone: masked keys carry exactly-zero weight), and the verify
   step (B=32, Q=5 against the 576-key view, ``decode``), bf16 and f32;
   hold the autograd ``Function`` against autograd through the plain
   forward; time K1 at the five shapes of the two paths (serving prefill
   and decode, update forward, rollout prefill and decode, ILQL's update
   forward, eval prefill and eval step, the chunk and the verify step; the
   serving four in f32 too) and
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
   mask); and the head-dim-256 instantiations at GPT-J-6B's shapes (H = 16:
   the rollout prefill B=128 Q=48 K=96 and decode step, the update B=8 T=96
   causal, the reference scoring B=128 T=96 causal, phase 12's admission
   prefill B=8 Q=512 K=576 and decode step B=32 K=576) and edges (ragged
   Q/K with a padding bias, all-padding causal rows, 16 key tiles with
   peaked logits, 16 query chunks under the causal flag, Q <= 16 causal,
   also with rows that see only padding, a learned bias through K2's
   dbias), K1, K2 (+dbias) and K3 in bf16 and f32, with V ~ N(0, 1) and
   O held elementwise to a fraction of P|V| + |O| (``O_REL_TOL``) that two
   planted faults (one 64-column V atom, or its share of key tile 0, left
   out) must break, timed in bf16 as the head-dim-64 rows are; and the same
   cases and checks for the head-dim-96 instantiations at GPT-NeoX-20B's
   shapes (H = 64: the rollout prefill B=64 Q=48 K=96 and decode step, the
   update B=32 T=96 causal, the reference scoring B=64 T=96 causal, phase
   14's admission prefill B=8 Q=512 K=576 and decode step B=32 K=576), the
   planted faults aimed at the padded atom's real columns 64..95; and the
   same for the small head dims, each tile padded to one 64-column atom:
   D = 24 at the randomwalks configs' shapes (H = 6: the rollout prefill
   B=128 Q=10 K=19, its decode step, the update B=64 T=19 causal, the
   reference scoring B=128 T=19 causal), D = 32 at the GPT-2 stand-in's
   (H = 4: the rollout prefill B=64 Q=8 K=20 and decode step, the update
   B=16 T=20 causal, the served prefill B=8 Q=40 K=64 and decode step) and
   D = 16 at the T5 stand-in's (H = 4: the encoder and decoder
   self-attentions with their learned bias through K2's dbias, the cross
   attention) and the learning guard's (H = 2: the update B=16 T=10
   causal, a decode step), each with the edges above at 4 heads, the
   planted faults aimed at the row's last 16-byte chunk (columns 16..23
   at D = 24); and the head-dim-128 instantiations at GPT-Neo 1.3B's
   shapes (H = 16, D = 256's cases at ``configs/ppo_gptj.yml``'s geometry
   and phase 19's, the global layers' masks) and, for its local layers,
   the band of 256 keys plus padding with the causal flag off (the update
   B=8 T=96, phase 19's admission prefill B=8 Q=512 K=576 and decode step
   B=32 K=576 at per-row depths, and a long band B=2 T=512 whose last
   query tile sees three wholly masked key tiles first), K2 and K3 at the
   update under both masks and at the long band, the planted faults aimed
   at the second atom, columns 64..127; at every training-path case K1's
   ``p_scale`` (1 on each row with a live key, 1 / the keys averaged on
   the others) against the plain one, and on PPO's left padding the
   autograd Function's gradient against autograd through K1's function in
   plain ops, in f32 and bf16;
3. model — full-width GPT-2 in f32 through the kernels against the plain
   attention: the forward without a cache, prefill + decode through the
   paged cache against the plain full forward of the whole sequence, and
   the gradient of a PPO loss on one minibatch (max relative error per
   parameter group); the same for the full-width f32 T5 of
   ``configs/ppo_ul2.yml``, its relative position tables included; and in
   bf16, the update's logprobs and PPO-loss gradient with
   ``train.logprob_chunk: 16`` against the unchunked head; the same three
   checks for a full-width f32 GPT-J cut to 2 blocks (D = 256, rotary
   positions at every decode step, the gradient at the yml's B = 8, 48 + 48
   columns); and a GPT-J checkpoint in HF layout at full width and 2
   blocks (``transformer.`` names, Linear [out, in], ``lm_head.bias``)
   written here and loaded through ``model.model_path`` by the PPO trainer
   on ``configs/ppo_gptj.yml``, bit for bit; the same for GPT-NeoX: a
   full-width f32 NeoX (6144 wide, 64 heads of 96, rotary on 24, vocab
   50 432, parallel residual) cut to 2 blocks, the gradient at the yml's
   B = 32, and an HF-layout checkpoint at full width and 2 blocks
   (``gpt_neox.`` names, the fused ``query_key_value`` [3 H Dh, E],
   ``embed_out.weight`` and the three buffers of older checkpoints)
   loaded through ``model.model_path`` on ``configs/ppo_neox20b.yml``, bit
   for bit; the same for GPT-Neo: a full-width f32 GPT-Neo 1.3B (2048
   wide, 16 heads of 128, vocab 50 257, window 256) cut to 4 blocks
   (global, local, global, local) at B = 2, T = 512, where the band
   truncates (the gradient over 256 + 256 columns), and an HF-layout
   checkpoint at full width and 4 blocks (``transformer.`` names,
   ``attn.attention.*``, the tied ``lm_head.weight`` and the two buffers
   of older checkpoints) loaded through ``model.model_path`` on phase
   20's config, bit for bit;
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
   not at all. The run has the telemetry on (``train.telemetry.ring_size``,
   ``train.run_dir``, ``train.profile_dir`` with ``train.profile_phase``
   the second PPO phase, and ``train.health``): (a) the trainer's own
   chrome trace of that phase is the only file in ``profile_dir``, and its
   CUDA kernel events named ``flash_fwd_tile_kernel``,
   ``flash_fwd_decode_kernel``, ``flash_bwd_dq_tile_kernel`` and
   ``flash_bwd_dkv_tile_kernel`` equal the launch counters' deltas across
   the window, none 0, with no ``fma`` launch in it; (b) no span dropped,
   ``phase/collect`` and ``phase/train`` twice each, every ``collect/*``
   span of the fixed path present, each phase's
   ``exp/overlap_drain_ms`` its ``train/drain`` span's duration; (c)
   ``run_dir`` holds ``manifest.json`` (the card named in its platform), a
   one-line ``ledger.jsonl`` and one ``phases.jsonl`` row per phase, and
   the telemetry CLI's ``--watch <run_dir> --no-follow`` (its ``main``, run
   in this process) renders them; (d) the metrics registry holds the
   ``exp/overlap_*`` and ``mem/*`` gauges. The phase prints its wall with
   the telemetry on, the spans per phase and the profiled phase's device
   busy share, and marks the profiled phase's times as such: the other
   phase's collect and train seconds are the unprofiled ones;
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
   no deviation: ``kv_cache_dtype: "auto"`` resolves at the sampler's
   capacity (64 + 48) by the port's ``INT8_KV_MAX_CAPACITY`` (printed),
   and run-health monitoring is on (each definition's health events by
   detector are printed). Gates: the loaded backbone equals the written
   tensors before the first update; the reference holds 2 blocks, ``wte``
   and ``ln_f`` (52 774 656 parameters against the full copy's 124 439
   808); 12 K1 ``tile`` launches per reference scoring, ``tile`` = 12 x
   the forwards that are not decode steps and 12 x those ``decode`` (on a
   bf16 cache) or ``decode_int8`` with the quantizing write 12 x every
   sampler forward (on an int8 cache); the nine ``health/*`` stats in the
   update rows; K2 = K3 = 12 x
   the updates under ``(0, 2)`` and 2 x under ``(2, None)``, all ``tile``;
   under ``(2, None)`` the bottom 10 blocks, ``wte`` and ``wpe``
   bit-identical after training and the top 2 blocks, ``ln_f`` and the
   value head moved; every stat finite; then an ``InferenceServer``
   restores the run's checkpoint (bit for bit, after its compute-dtype
   cast) and serves 8 of the prompts to completion with finite logprobs
   and values. ``TRLX_RUN_LEDGER`` points at a file in the phase's
   temporary directory: each definition's ``learn`` appends its manifest
   (``status: ok``), and the telemetry CLI's ``--compare ~2 ~1`` (in this
   process) renders the movers between the two.

8. offline ILQL — ``trlx_tpu_torch.train(dataset=..., model_path=...)`` on
   ``configs/ilql_sentiments.yml`` as written (bf16 over f32 masters,
   ``seq_length`` 64, batch 128, two Q heads, tau 0.7, gamma 0.99, CQL 0.1,
   AWAC 1.0, alpha 0.005, a target sync every 5 updates, beta 4; the eval
   decode's defaults: 48 new tokens, top_k 20, sampled) from a GPT-2-small
   checkpoint in HF layout written by the phase, on 2048 synthetic
   (token_list, action_start) samples from a seed, for 32 updates (two
   epochs of 16 minibatches) with evals at 0, 16 and 32; named
   deviations: random weights, synthetic data, no tokenizer, 32 of 1000
   updates, and a ``train.run_dir``, whose ``manifest.json`` must hold
   ``status: ok``. Gates: the loaded backbone equals the written tensors; every
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
   buffer, K1 ``tile`` = 12 x (admission prefills + reference scorings +
   the streamed phase's epoch-1 updates that ran as rows landed) and
   ``decode`` = 12 x decode steps; over the run phase 5's gates. Then
   the fixed sampler under per-row RNG and the engine decode the same 128
   prompts at one phase seed and the share of rows with identical tokens
   is printed (a report: bf16 and another batch shape can flip a
   near-tie), with the engine's host time per decode step. Then one cut
   run with the engine's serving features, ``prefill_chunk: 16`` and
   ``spec_decode: {enabled: true, max_draft: 4}``: one collect and its
   update pass (32 updates), held to the per-collect gates above (K1 by
   the variant each forward's width picks: the 16-column chunks and the
   5-column verify steps run ``decode``) and K2 = K3 = 12 x 32;
11. serving tier — ``InferenceServer`` on phase 4's model and geometry in
   bf16, greedy, with ``serving.prefix_cache_blocks: 128``,
   ``rollout.prefill_chunk: 128`` (2 chunk forwards a pump) and
   ``rollout.spec_decode`` (trie drafter, 4 drafts), serving 96 requests in
   12 bursts of 8: 64 share one of 4 system prompts of 384 tokens, each
   with its own 128-token turn, 32 take lengths 16..512; the same traffic
   again through phase 4's engine (the three features off) in the same
   call. Gates: 96/96 complete and finite; prefix hit blocks in (0, 64 x
   24]; every pool reference released, no block leaked; fewer chunk
   forwards than admitted groups x 4; K1 ``tile`` = 12 x chunk forwards,
   ``decode`` = 12 x (decode + verify steps); verify steps > 0. Then 16
   of the shared-prefix requests in f32 through K1's ``fma``, features on
   and off: the same tokens on every row but where the first difference is
   a near tie (top-2 logit margin < 1e-4 in the features-off run). Prints
   both runs' tokens/s, TTFT, peak, hit rate, chunks run and skipped with
   their FLOPs, spec accept rate, tokens per verify step, host ms per step,
   the decode step's cache read with and without the pool overlay, and the
   share of rows whose tokens match the features-off run;
12. GPT-J serving — ``InferenceServer`` with ``model_type: gptj`` at
   GPT-J-6B's widths and depth (vocab 50 400, 4096 wide, 28 blocks, 16
   heads of 256, rotary 64; random weights from a seed, bf16), phase 4's
   64 prompts, 64 new tokens, 32 slots, admit/harvest 8: 64/64 complete and
   finite; K1 ``tile`` = 28 x prefill forwards, ``decode`` = 28 x decode
   steps, all through the head-dim-256 instantiations; no ``fma`` launch,
   input copy or plain call. Prints tokens/s, TTFT p50/p95, the peak;
13. GPT-J PPO — ``trlx_tpu_torch.train`` on ``configs/ppo_gptj.yml`` at
   GPT-J-6B's widths cut to 8 of its 28 blocks (phase 12 serves all 28;
   bf16 over f32 masters, batch 8, 48 + 48 tokens with ``top_k: 0``, 128
   rollouts a chunk, 4 epochs, the 2-block hydra reference, the bottom 6
   blocks and ``wte`` frozen) for two PPO phases (128 updates) on 128
   int-list prompts of 16-48 tokens; named deviations: the mesh set to one
   device (the yml's ``tp: 4`` needs four ranks; phase 27 runs the mesh
   path), the depth, random
   weights, no tokenizer, 128 of 10 000 updates. Gates: finite stats; the
   top 2 blocks, ``ln_f``, ``lm_head`` and the value head moved, the bottom
   6 blocks and ``wte`` bit-identical; the reference holds blocks 6-7,
   ``wte``, ``ln_f`` and ``lm_head`` only; K1 ``tile`` = 8 x the
   non-decode forwards (8 a reference scoring: 6 trunk + 2 branch
   blocks), ``decode`` = 8 x the decode steps; K2 = K3 = 2 x 128,
   all ``tile``; no ``fma`` launch, input copy or plain call; a fresh
   trainer's ``load`` restores the saved state exactly. Prints the wall
   with the checkpoint write timed apart, collect and train seconds,
   rollout tokens/s, updates/s and the peak.

14. GPT-NeoX-20B serving — ``InferenceServer`` with ``model_type:
   gpt_neox`` at the 20B's widths and depth (vocab 50 432, 2048 positions,
   6144 wide, 44 blocks, 64 heads of 96, ``rotary_pct`` 0.25, parallel
   residual; random weights from a seed), ``dtype`` and ``param_dtype``
   bf16, so the policy is built in bf16 on the card with no f32 copy; eos
   = pad = 0; phase 4's 64 prompts and geometry. Gates: the card near
   empty before the build; 64/64 complete and finite; K1 ``tile`` = 44 x
   prefill forwards, ``decode`` = 44 x decode steps, all at D = 96; no
   ``fma`` launch, input copy or plain call. Prints tokens/s, TTFT
   p50/p95, the build's peak and serving's;
15. GPT-NeoX PPO — ``trlx_tpu_torch.train`` on ``configs/ppo_neox20b.yml``
   (bf16 over f32 masters, batch 32, 48 + 48 tokens with ``top_k: 0``, 64
   rollouts a chunk, 4 epochs, the 2-block hydra reference, running reward
   scaling) at full width for two PPO phases (16 updates) on 128 int-list
   prompts of 16-48 tokens; named deviations: the mesh set to one device
   (32 ranks; phase 27 runs the mesh path), depth 44 cut to 4 blocks (one
   card and the time limit; phase 14 serves all 44), random weights, no
   tokenizer, a host reward,
   16 of 6000 updates. Gates: finite stats; the top 2 blocks, ``ln_f``,
   ``lm_head`` and the value head moved, the bottom 2 blocks and ``wte``
   bit-identical; the reference holds blocks 2-3, ``wte``, ``ln_f`` and
   ``lm_head`` only (1 525 850 112 parameters); K1 ``tile`` = 4 x the
   non-decode forwards, ``decode`` = 4 x the decode
   steps; K2 = K3 = 2 x 16, all ``tile``; no ``fma`` launch, input copy
   or plain call; a fresh trainer's ``load`` restores the saved state
   exactly. Prints the wall with the checkpoint write timed apart, collect
   and train seconds, rollout tokens/s, updates/s and the peak.

16. randomwalks PPO — ``trlx_tpu_torch.train(reward_fn=, metric_fn=,
   prompts=, eval_prompts=)`` on ``configs/ppo_randomwalks.yml`` as written
   (6 blocks, 144 wide, 6 heads of 24, f32, batch 64, 128 rollouts, 4
   epochs, 200 updates, evals every 20) with a copy of
   ``examples/randomwalks.py``'s task; then the same yml in bf16 over f32
   masters for 32 updates (named deviations). Gates: finite stats; moved
   parameters; ``load`` exact; K1 = 6 x the trainer's forwards, by variant
   as each attention call's query width picks it (f32 ``fma``; bf16
   ``tile`` over the 19-column update and scoring, ``decode`` for the
   10-column prefill and the steps); K2 = K3 = 6 x the updates in the
   dtype's variant; no input copy or plain call. Prints wall, collect s,
   rollout tokens/s, updates/s, peak and ``metrics/optimality`` at the
   first and last eval (not gated);
17. randomwalks ILQL — ``configs/ilql_randomwalks.yml`` as written (1000
   updates of batch 64 on the copied ``make_dataset``'s 1000 walks, greedy
   evals every 100 under the adjacency ``logit_mask``) through
   ``trlx_tpu_torch.train(dataset=, logit_mask=)``. Gates: the target
   sync bit for bit after every update; finite stats; K1 ``fma`` = 6 x the
   forwards, K2 = K3 = 6 x the updates ``fma``; no input copy or plain
   call. Prints updates/s, eval tokens/s and the optimality;
18. the stand-ins and the learning guard — (a) the GPT-2 stand-in of
   ``examples/pretrained_standin.py`` (vocab 64, 128 wide, 2 blocks, 4
   heads of 32), written as an HF checkpoint with random weights (the
   card's machine has no ``transformers`` to pretrain it) and loaded by
   ``model.model_path`` on the stand-in's PPO config in f32 (96 updates)
   and bf16 (16), then served through ``InferenceServer`` in bf16 (64
   prompts of 17-40 tokens: ``tile`` prefills, ``decode`` steps); (b) the
   T5 stand-in (``d_model`` 64, 4 heads of ``d_kv`` 16, 2 + 2 layers, 8
   buckets) the same two ways through the ``Seq2SeqPPOTrainer``, K2 with
   dbias = 4 x the updates; (c) ``tests/test_torch_learning.py``'s
   target-token task (2 heads of 16): mean reward up by its 0.15 margin
   within 96 updates. Gates as phase 16's, with the loaded bits.
19. GPT-Neo 1.3B serving — ``InferenceServer`` with ``model_type:
   gpt_neo`` at GPT-Neo 1.3B's widths and depth (vocab 50 257, 2048
   positions, 2048 wide, 24 blocks of 16 heads of 128, global and local
   in turn at window 256; random weights from a seed), built in bf16,
   phase 4's 64 prompts and geometry (prompts past 256 tokens make the
   band truncate in the prefill and at every decode step). Gates as phase
   14's: K1 ``tile`` = 24 x prefill forwards, ``decode`` = 24 x decode
   steps, all at D = 128;
20. GPT-Neo PPO — ``trlx_tpu_torch.train`` on ``configs/ppo_gptj.yml``'s
   geometry (batch 8, 48 + 48 tokens, 128 rollouts, 4 epochs, the 2-block
   hydra reference) with ``model_type: gpt_neo`` and GPT-Neo 1.3B at full
   width and depth for two PPO phases (128 updates); named deviations:
   the model, the mesh set to one device, random weights, no tokenizer,
   128 of 10 000 updates. Gates as phase 13's, but the reference holds
   blocks 22-23 (a global and a local block), ``wte`` (the tied head) and
   ``ln_f``, and ``wpe`` stays bit-identical with the frozen blocks.
21. sequence-parallel ring attention — ``trlx_tpu_torch/ops/
   ring_attention.py`` at GPT-2 small's heads (12 of 64), B = 4, T = 8192,
   causal with a padded tail of 3 keys on row 0, in bf16 and f32: (a) the
   entry point, ``ring_attention_sharded(impl="flash")``, forward and
   backward over ``make_mesh({"dp": -1, "sp": 1})`` on a one-rank NCCL
   group the phase starts on a ``file://`` store and destroys (one card:
   NCCL refuses two ranks on one GPU, so the ring passes nothing here;
   an all-reduce over the ring's group checks the group); (b) the ``sp =
   4`` ring's four ranks in lockstep on the card (``lockstep_ring``: each
   rank's pass of the module runs its 2048-token step, rank by rank, and
   the blocks rotate between steps, as the point-to-point ring's do); the
   dense kernels (``flash_attention``, the causal flag and a padding
   bias) on the same inputs; the naive impl against the flash one on the
   last 2048 tokens (f32); (c) the block wrappers against their plain
   versions at the ring's 2048 x 2048 block (B = 4, H = 12) on a past
   block with left padding, the diagonal block and a wholly future block,
   ``flash_block_fwd`` in bf16 (``tile``) and f32 (``split3``; a future
   block: the uniform average at lse = NEG_INF + log Tk),
   ``flash_block_bwd`` (``split3``) in f32 against the three blocks'
   combined lse + 0.3 (a future block: exactly zero gradients), each timed
   beside its bound (the live pairs of its bias; bf16 over 989 TFLOP/s,
   the split3 route's six bf16 plane products per f32 product over the
   same, the f32 bound over the card's 67 TFLOP/s off the tensor cores
   beside it), its plain version and SDPA with the bias as a mask (for the
   backward SDPA's whole f32 backward), and the split pre-pass alone
   (held against its plain split bit for bit).
   Gates: K1 = K2 = K3 = 1 per forward and backward in (a), 16 in (b), K2
   and K3 ``split3``, K1 ``split3`` in f32 and ``tile`` in bf16, the split
   pre-pass 4 per backward and 3 per f32 forward, the block wrappers' own
   counts the same, no ``fma`` launch, no input copy, no plain call;
   finite outputs and gradients; (a) against (b), the order of their
   sums apart: outputs within ``O_REL_TOL`` of P|V| + |O| elementwise
   (P|V| the f32 kernels' attention of |V|), gradients within ``BWD_TOL``
   of the largest; in f32 both against the dense kernels within the same
   bounds, and on a B = 1, H = 2 slice each ring's error against f64
   attention at most twice the dense kernels' own; in bf16 (a), (b) and
   the dense kernels against the f32 ring on the same rounded inputs
   within the same bounds; the naive impl within the f32 bounds; every
   (c) case. Prints the walls and tokens/s of (a), (b) and the dense
   kernels and their peaks.
22. gpt2_moe — the switch-MoE GPT-2 at ``GPT2MoEConfig``'s defaults (GPT-2
   small's widths, 12 heads of 64, 4 experts in every second block, 209M
   parameters; random weights from a seed): (a) served as phase 4 serves
   (the routers, the layer norms and the value head's last layer kept
   f32, every other parameter bf16); (b) PPO on ``configs/ppo_sentiments.yml``'s geometry
   with ``model_type: gpt2_moe`` for two phases (64 updates), the rollout
   cast on and ``async_checkpoint: true`` with a save every 16 updates, its
   routers drawn N(0, 1/768) so that their logits have unit variance.
   Gates: (a) as phase 12's at D = 64; (b) finite stats, the router's
   among them, ``moe/max_load`` in [1/4, 1] and below 1 in some update,
   every switch block sending tokens to more than one expert and none to
   one alone at init, and one block so after the run, moved parameters, K1 by
   variant and K2 = K3 = 12 x 64 ``tile`` as phase 5, steps 48 and 64
   alone on disk, ``load`` exact, one rollout copy per set of masters with
   its routers, ``fc2`` and norms the f32 masters, the reference cast once.
   Prints each save's return and write seconds and the end save's write
   beside the final eval.

23. kv int8 — the int8 KV cache: (a) the quantizing write
   (``csrc/kv_quant.cu``) against its plain version bit for bit at every
   built head dim (a prefill and a decode step into a linear cache; a
   paged write through rotated tables with a publish into the shared
   pool), and K1's ``decode_int8`` against dequantization and the plain
   attention (O and LSE within ``TOL``'s bf16 bounds, ``p_scale`` within
   ``P_SCALE_TOL``, a row with no live key included; also reported: equal
   to the bf16 decode on the dequantized view), both timed at the serving
   decode (B=32 K=576) and the rollout decode (B=128 K=112) beside their
   bytes bounds, their plain versions, the bf16 decode and SDPA on the
   dequantized bf16 view; (b) the ``"auto"`` threshold's sweep: GPT-2
   small's greedy fixed sampler on an int8 and a bf16 cache, 48 new
   tokens, at B=128 with capacities 112 and 576, B=32 with 1088 and B=8
   with 2048, 5 interleaved pairs per shape, the medians of the decode
   forwards' tokens/s on the card's clock, and the capacity the figures
   support beside the port's ``INT8_KV_MAX_CAPACITY`` (reported, not
   gated: walls vary between calls); (c) phase 11's serving tier and
   traffic with ``kv_cache_dtype: int8`` (an int8 cache and pool). Gates:
   every (a) check; (b) finite; (c) complete and finite, prefix hits,
   verify steps, K1 ``tile`` = 12 x chunk forwards, ``decode_int8`` = 12
   x (decode + verify steps) and no bf16 ``decode``, the quantizing write
   12 x every forward, no ``fma`` launch, input copy or plain call.

24. resilience — the JAX package's six chaos scenarios
   (``trlx_tpu/analysis/chaos_smoke.py``) on the card through
   ``trlx_tpu_torch.train``, on ``configs/ppo_sentiments.yml``'s geometry
   at GPT-2 small's full width (random weights from the seed, bf16; a
   pass is 128 rollouts / batch 16 x 4 epochs = 32 updates): (a) clean,
   resilience on, two passes, against the same run with resilience off
   (the determinism check; a differing pair runs the plain run once more
   to tell nondeterminism from the supervisor); (b) ``checkpoint.save``
   failing twice under ``async_checkpoint`` (one pass), retried on the
   writer thread, equal to (a) at update 32; (c) a checkpoint written under
   ``num_layers_unfrozen: 2`` resumed into a fully trainable run: the
   translated ``ValueError``, 0 retries, 0 restarts, and how long the
   refusal took; (d) a real SIGTERM from the ``preempt`` site at the first
   pass boundary (update 32) under ``async_checkpoint``: the drain's
   emergency checkpoint, the supervisor's restart and the resume, every
   parameter, Adam moment, the KL state and the generator ``torch.equal``
   to the uninterrupted run; the time to recover (drain start to the
   resumed attempt's first update: the emergency write, the restart, the
   rebuild, the load and the collect before that update) and each
   attempt's peak; the resumed attempt starts with what the first started
   with (within ``RESILIENCE_START_MARGIN_BYTES``) and peaks at most
   ``RESILIENCE_PEAK_RATIO`` of the uninterrupted run's peak from the
   drain point on; the same pair for ILQL at
   ``configs/ilql_sentiments.yml``'s width, preempted at its first chunk
   boundary; (e) and (f) in one pass: ``rollout: {engine: continuous}``
   with a permanent ``engine.admit`` failure (the pass runs on the fixed
   sampler, one ``engine-fallback`` health event) and
   ``rollout_logging_dir`` with three ``writer.write`` disk-full failures
   (the writer degrades to synchronous writes and every row lands on
   disk in order). After every
   scenario the SIGTERM and SIGINT handlers are the ones from before it.
   One JSON line per scenario; (d)'s two resumed runs are counted paths
   (K2 = K3 ``tile`` = 12 x updates across both attempts, K1 = 12 x both
   trainers' forwards, no ``fma``, copy or plain call).
25. async RL — ``configs/ppo_async_sentiments.yml`` (the continuous
   engine with 16 slots admitting and harvesting 4, ``async_rl`` at
   ``staleness_window: 1``, health, resilience) from a GPT-2-small
   checkpoint in HF layout written here, with phase 9's deviations: (a)
   as written through ``trlx_tpu_torch.train``, two passes (64 updates):
   finite stats, moved parameters, weights pushed to the engine in each
   phase, ``async/staleness_max`` <= 1, no ``staleness-breach`` event, K1
   by variant as phase 10 counts it, K2 = K3 = 12 x 64 ``tile``, no
   ``fma`` launch, input copy or plain call; prints every phase's
   ``async/*`` and ``exp/overlap_*`` stats, collect and train seconds and
   rollout tokens/s; (b) one pass at the yml's shapes three ways,
   ``staleness_window: 0``, ``overlap=False`` and ``phase_overlap``
   without async: ``torch.equal`` parameters, KL sequences and stats rows,
   no weight push; (c) one pass of phase 5's fixed-sampler geometry,
   overlapped against serial: ``torch.equal``, its epoch-1 updates run
   during the collection; (d) an ``engine.admit`` failure at the second
   pass's first admission under async (``checkpoint_interval: 32``, so
   that the boundary is saved): one ``actor-dead`` event, an
   ``ActorDeadError`` (the engine not degraded), the supervisor's restart
   from the update-32 checkpoint and the run's end at 64, launches
   counted across both attempts; prints the time to recover (the failure
   to the resumed attempt's first update).
26. bf16 moments and the sweep — (a) phase 5's geometry
   (``configs/ppo_sentiments.yml``'s GPT-2 small, bf16 over f32 masters)
   for ``MOMENT_UPDATES`` updates twice from one seed (the end save
   asynchronous), ``train.adam_moment_dtype`` float32 then bfloat16: every moment tensor
   bf16 on the card, the moments' bytes half the f32 run's (4 B against
   8 B a trainable parameter), finite, moved, K1 by variant and K2/K3
   launches equal to the f32 run's with no plain call, a save, load and
   one update ``torch.equal`` to the update without them, the card's
   ``stochastic_round`` bit-equal to the plain CPU one on the same noise,
   and its mean over 4096 draws within 0.15 ulp; prints each run's moment
   bytes, peak, median update ms (the optimizer step and the whole
   ``train_step``, CUDA events), last KL and mean score; (b) ``python -m
   trlx_tpu_torch.sweep trlx_tpu_torch/examples/randomwalks.py --config
   configs/sweeps/ppo_randomwalks_sweep.yml --local --seed 0`` in process
   (``cli``, its wandb replay off): 4 trials of ``configs/ppo_randomwalks.yml`` (200 updates
   each) with the drawn ``lr_init``, ``init_kl_coef`` and ``ppo_epochs``;
   gates: 4 trials in the JSON, each in the yml's ranges, 200 updates, a
   finite ``metrics/optimality``, ``best`` its argmax, K1 = 6 x the
   trial's forwards and K2 = K3 = 6 x 200 ``fma``; prints each trial's
   parameters, optimality and wall.
27. mesh training — dp/fsdp/tp (``train.mesh``) on phase 5's geometry
   cut to one collect of 32 rows and 2 updates, no eval. World 1 in this
   process: one fixed minibatch's update (its gradient norm, the
   parameters after it) and a counted ``learn()``. Two ranks that share
   the card, started at the phase's start as ``chip_smoke.py --mesh-rank
   R --mesh-task T`` processes: an NCCL pair whose first all-reduce NCCL
   refuses (two ranks on one device; its error printed), and a gloo pair
   (``initialize``'s explicit ``backend``; gloo stages CUDA tensors
   through the host) that runs ``{fsdp: 2}`` then ``{tp: 2}``. Gates per
   mesh: every shard's initial bits equal world 1's; the fixed
   minibatch's gradient norm within ``MESH_GRAD_NORM_RTOL`` of world 1's,
   every parameter within 2 lr of world 1's after the update, at most
   ``MESH_FLIP_SHARE`` of the elements lr / 2 or more apart, the two
   updates' cosine at least ``MESH_UPDATE_COSINE`` (sums over the mesh,
   each element once, no gather); each rank's ``learn()`` finite and
   moving the parameters, its K1 ``tile`` = 12 x its non-decode forwards,
   ``decode`` = 12 x its decode steps, K2 = K3 = 12 x its updates, all
   ``tile``, no ``fma``, copy or plain call (world 1 too); each parameter
   the JAX specs shard at most its share on each rank. Prints NCCL's
   error and per mesh the backend, the gradient norms, the update's
   cosine and flip share, and each rank's resident bytes of parameters
   and moments beside world 1's.

Phase 5 also holds one collect with ``rollout_param_cast`` on against one
with it off, from the same seed, its layer norms perturbed: ``torch.equal``
tokens, logprobs, values, reference logprobs and rewards. Every phase
call's wall is logged as it ends and printed as one ``{"phase_walls":
{...}}`` line before the ``kernels`` line.

Each path (phases 4 to 27, each definition of phase 7, each run of phases
9, 16, 18, 21, 22, 26 and 27 on its own, phase 27's ranks each in its
process) runs with the launch counters set to 0 just
before it and read just after, and its peak memory is read from a clean start.
Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without CUDA, or when any phase fails. ``--profile PATH`` additionally
serves the same traffic, runs one training phase, a cut seq2seq run, one
phase of each phase-7 definition, one epoch of phase 8, one phase each
of phases 9 (causal) and 10, and phase 11's traffic with the features on
and off under ``torch.profiler`` and writes each run's
device-time summary (busy share, device time by kernel) as JSON to PATH
(phases 12 to 20 are not profiled).
"""

from __future__ import annotations

import concurrent.futures
import copy
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
# Head dim 256 (phase 2's GPT-J cases, V ~ N(0, 1)): |dO| elementwise as a
# fraction of P|V| + |O| (P|V| = sum_j p_j |v_j|, the plain weights times
# |V|), which bounds what rounding can move an element. In bf16 (unit
# roundoff u = 2^-8) the kernel and the plain version each round every
# weight (u of P|V| each) and the output (u of |O| each), and the kernel
# normalises after the sum (u of |O|): they differ by at most 2u P|V| +
# 3u |O|; the bound allows 4u (P|V| + |O|). In f32 only the order of the
# sums differs. Leaving out one 64-column V atom, or its share of one key
# tile, is held to break this bound (relative_o_check).
O_REL_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
# max |dQ|, |dK|, |dV| against the plain backward fed the same O and LSE,
# as a fraction of max(1, max |reference|):
# K1's p_scale against the plain one, relative: 1 / (keys averaged) from
# an f32 sum of ones in both
P_SCALE_TOL = 1e-6
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
    # the ring's block wrappers (phase 21), on K1 and on K2 + K3
    "flash_block_fwd": "trlx_tpu/ops/flash_attention.py:468",
    "flash_block_bwd": "trlx_tpu/ops/flash_attention.py:491",
    # the split3 pre-pass of both block wrappers' f32 operands: a helper of
    # their f32 route, the counterpart of no TPU kernel
    "split_planes": None,
    # the int8 KV cache (phase 23): K1's decode over int8 K/V, and the
    # quantizing cache write, whose JAX counterpart is XLA's fusion of
    # quantize_kv (trlx_tpu/models/gpt2.py:264) into write_cache's stores
    # (:307), no TPU kernel
    "flash_fwd_decode_int8": "trlx_tpu/ops/flash_attention.py:97",
    "kv_quant": None,
}
SOURCES = {
    "flash_fwd": "trlx_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "trlx_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "trlx_tpu_torch/csrc/flash_bwd.cu",
    "flash_block_fwd": "trlx_tpu_torch/csrc/flash_fwd.cu",
    "flash_block_bwd": "trlx_tpu_torch/csrc/flash_bwd.cu",
    "split_planes": "trlx_tpu_torch/csrc/split_planes.cu",
    "flash_fwd_decode_int8": "trlx_tpu_torch/csrc/flash_fwd.cu",
    "kv_quant": "trlx_tpu_torch/csrc/kv_quant.cu",
}
L2_BYTES = 50 * 2**20  # H100 SXM
N_LAYER = 12  # GPT-2 small
CHUNK_PAD_KEYS = 256  # phase 2's chunk case with an all-pad key range
FWD_VARIANT_COUNTERS = {
    "tile": "FLASH_FWD_TILE_LAUNCHES",
    "decode": "FLASH_FWD_DECODE_LAUNCHES",
    "fma": "FLASH_FWD_FMA_LAUNCHES",
}
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
BWD_VARIANTS = ("tile", "fma")
#: the split3 launches (the ring's block wrappers only) and the split
#: pre-pass's, read apart from the dense paths' variant counts
SPLIT3_COUNTERS = {"flash_fwd": "FLASH_FWD_SPLIT3_LAUNCHES",
                   "flash_bwd_dq": "FLASH_BWD_DQ_SPLIT3_LAUNCHES",
                   "flash_bwd_dkv": "FLASH_BWD_DKV_SPLIT3_LAUNCHES",
                   "split_planes": "FLASH_SPLIT_PLANES_LAUNCHES"}
#: the split3 route's bf16 plane products per f32 product
SPLIT3_PRODUCTS = 6


def write_safetensors(tensors: dict, path: str) -> None:
    """Write ``{name: tensor}`` as a ``.safetensors`` file, the layout HF
    checkpoints use: an 8-byte little-endian header length, a JSON header
    (per tensor its dtype, shape and byte offsets), then the tensors'
    bytes in the header's order."""
    import torch

    codes = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.bool: "BOOL"}
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
# tensor-core instructions in their SASS. Every kernel is built for head
# dims 64 (ILi64E), 96 (ILi96E, named "_d96" here), 256 (ILi256E,
# "_d256"), 16, 24, 32 and 128 ("_d16", "_d24", "_d32", "_d128"), gated apart; K2's tile
# kernel has two instantiations per head dim, without the bias gradient
# (Lb0E) and with it (Lb1E); the backward's f32 kernels (fma) are gated on
# spills as well
HEAD_DIM_SUFFIXES = ((64, ""), (96, "_d96"), (256, "_d256"), (16, "_d16"), (24, "_d24"),
                     (32, "_d32"), (128, "_d128"))
GATED_KERNELS = {
    "flash_fwd": {**{f"flash_fwd_{v}_kernel{sfx}": f"flash_fwd_{v}_kernelILi{d}E"
                     for d, sfx in HEAD_DIM_SUFFIXES for v in ("tile", "fma", "split3")},
                  # decode and decode_int8: one template over its rows' reader
                  **{f"flash_fwd_{v}_kernel{sfx}": (f"flash_fwd_decode_kernelILi{d}E", rows)
                     for d, sfx in HEAD_DIM_SUFFIXES
                     for v, rows in (("decode", "Bf16Rows"), ("decode_int8", "Int8Rows"))}},
    "flash_bwd": {name: pattern for d, sfx in HEAD_DIM_SUFFIXES for name, pattern in (
        (f"flash_bwd_dq_tile_kernel{sfx}", f"flash_bwd_dq_tile_kernelILi{d}ELb0E"),
        (f"flash_bwd_dq_tile_kernel_dbias{sfx}", f"flash_bwd_dq_tile_kernelILi{d}ELb1E"),
        (f"flash_bwd_dkv_tile_kernel{sfx}", f"flash_bwd_dkv_tile_kernelILi{d}E"),
        (f"flash_bwd_dq_fma_kernel{sfx}", f"flash_bwd_dq_fma_kernelILi{d}E"),
        (f"flash_bwd_dkv_fma_kernel{sfx}", f"flash_bwd_dkv_fma_kernelILi{d}E"),
        (f"flash_bwd_dq_split3_kernel{sfx}", f"flash_bwd_dq_split3_kernelILi{d}E"),
        (f"flash_bwd_dkv_split3_kernel{sfx}", f"flash_bwd_dkv_split3_kernelILi{d}E"))},
    "split_planes": {"split_planes_kernel": "split_planes_kernel"},
    "kv_quant": {"kv_quant_write_kernel_bf16": "kv_quant_write_kernelI13__nv_bfloat16E",
                 "kv_quant_write_kernel_f32": "kv_quant_write_kernelIfE"},
}


def kernel_matches(pattern, fn: str) -> bool:
    """Whether mangled name ``fn`` is the gated kernel ``pattern`` names: a
    piece of the name, or a tuple of pieces it holds all of."""
    return all(p in fn for p in ((pattern,) if isinstance(pattern, str) else pattern))
TILE_KERNELS = tuple(k + sfx for _, sfx in HEAD_DIM_SUFFIXES for k in (
    "flash_fwd_tile_kernel", "flash_bwd_dq_tile_kernel", "flash_bwd_dq_tile_kernel_dbias",
    "flash_bwd_dkv_tile_kernel", "flash_fwd_split3_kernel", "flash_bwd_dq_split3_kernel",
    "flash_bwd_dkv_split3_kernel"))


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
    libs = fa._load()
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
            rows = [r for fn, r in ptxas.items() if kernel_matches(pattern, fn)]
            spills = [r.get("spill_bytes") for r in rows]
            record[kernel] = {
                "registers": max((r.get("registers", 0) for r in rows), default=None),
                "spill_bytes": sum(spills) if rows and None not in spills else None,
            }
        mma.update(tensor_core_instructions(fa, paths[name]))
    log(f"phase 1: tensor-core instructions (HMMA/HGMMA) per kernel: {json.dumps(mma)}")
    for kernel in TILE_KERNELS:
        record[kernel]["tensor_core_instructions"] = sum(
            n for fn, n in mma.items() if kernel_matches(patterns[kernel], fn))
    # the split3 kernels' dynamic shared memory (ptxas reports static only)
    for d, sfx in HEAD_DIM_SUFFIXES:
        for kernel, smem in (
                ("flash_fwd_split3_kernel", libs["flash_fwd"].trlx_flash_fwd_split3_smem(d)),
                ("flash_bwd_dq_split3_kernel", libs["flash_bwd"].trlx_flash_bwd_split3_smem(d, 0)),
                ("flash_bwd_dkv_split3_kernel",
                 libs["flash_bwd"].trlx_flash_bwd_split3_smem(d, 1))):
            record[kernel + sfx]["dynamic_smem_bytes"] = smem
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
    # the serving tier (phase 11). A chunked-prefill forward: 8 prompts,
    # the third 128-column chunk (queries 256..383) against the prompt-wide
    # 512-key view, causal + left padding as one [A,1,W,Q] bias
    lens = torch.randint(16, 513, (8,), generator=gen, device=dev)
    mask = (torch.arange(512, device=dev)[None, :] >= 512 - lens[:, None]).long()
    bias = attn.causal_bias(128, 512, 256, dev) + attn.padding_bias(mask)
    cases.append(("chunk", *qkv(8, 128, 512), bias, False))
    # the same chunk where keys 0..255 are pad for every row and hold what
    # a skipped chunk leaves (here: large garbage): their softmax weight
    # must be exactly 0, so the output equals the call on keys 256.. alone
    mask = (torch.arange(512, device=dev)[None, :] >= 256).long().expand(8, 512)
    bias = attn.causal_bias(128, 512, 256, dev) + attn.padding_bias(mask)
    q, k, v = qkv(8, 128, 512)
    k[:, :CHUNK_PAD_KEYS] *= 100
    v[:, :CHUNK_PAD_KEYS] *= 100
    cases.append(("chunk_pad", q, k, v, bias, False))
    # a verify step: 32 slots, the anchor and 4 drafted tokens each at
    # per-row depths against the 576-wide view (the causal offset is each
    # row's first target column, the mask the window's validity)
    t = torch.randint(0, 60, (32,), generator=gen, device=dev)
    lens = torch.randint(16, 513, (32,), generator=gen, device=dev)
    cols = torch.arange(576, device=dev)[None, :]
    mask = ((cols >= 512 - lens[:, None]) & ((cols < 512) | (cols <= 512 + t[:, None] + 4))).long()
    bias = attn.causal_bias(5, 576, 512 + t, dev) + attn.padding_bias(mask)
    cases.append(("verify", *qkv(32, 5, 576), bias, False))
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
            b.data_ptr() if b is not None else None, o.data_ptr(), None, None,
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
            extra = {}
            if name == "chunk_pad":
                # the masked key range carries no weight: the kernel on the
                # real keys alone gives the same output
                P = CHUNK_PAD_KEYS
                o_real = fa.flash_attention(q, k[:, P:], v[:, P:], bias[..., P:], causal)
                extra["max_abs_err_o_vs_real_keys"] = err_r = (
                    o.float() - o_real.float()).abs().max().item()
                ok = ok and err_r <= tol_o
            results.append({
                "case": name, "dtype": dtype_name, "max_abs_err_o": err_o,
                "max_abs_err_lse": err_lse, "tol_o": tol_o, "tol_lse": tol_lse,
                "ok": ok, **extra,
            })
            log(f"phase 2: {name:15s} {dtype_name:8s} ({fa.forward_variant(dt, q.shape[1])}) "
                f"max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e} "
                + "".join(f"{k}={v:.3e} " for k, v in extra.items())
                + ('ok' if ok else 'FAIL'))
            if name in ("prefill", "decode", "chunk", "verify"):
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


def small_q_masked_rows_mask(torch, B: int, K: int, dev):
    """[B, K] padding mask for Q <= 16 under the causal flag: row 0's keys
    0..19 are padding, so its queries see only padding, and its real keys
    20..63 share key tile 0, which the forward's 16-row tile visits. Those
    rows average key tile 0's keys whose only mask is the causal one, so
    the backward must walk the forward's whole visit (64 keys), not its 16
    query rows."""
    mask = torch.ones(B, K, dtype=torch.long, device=dev)
    mask[0, :20] = 0
    return mask


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
    cases.append(("small_q_masked_rows", *qkv(2, 9, 130),
                  attn.padding_bias(small_q_masked_rows_mask(torch, 2, 130, dev)), True))
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


def visited_reference(torch, fa, q, k, v, bias, causal, p_scale=False):
    """K1's function in plain ops: the plain forward, restricted under the
    causal flag to the keys of the tiles K1 visits. On a causal row whose
    visible keys are all padding (PPO's left padding) every visited key
    sits at NEG_INF, and K1 averages exactly those keys, as the TPU kernel
    does; the unrestricted plain forward would average all K. On every
    other row the keys left out carry no weight either way. With
    ``p_scale`` it also returns K1's ``p_scale`` there."""
    if causal:
        Q, K = q.shape[1], k.shape[1]
        skip = torch.zeros(Q, K, device=q.device).masked_fill_(
            ~fa.visited_keys(Q, K, q.device), float("-inf"))
        bias = skip if bias is None else bias.float() + skip
    return fa.flash_attention_reference(q, k, v, bias, causal, True, p_scale)


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
            o_ref, lse_ref, p_scale_ref = visited_reference(
                torch, fa, q, k, v, bias, causal, p_scale=True)
            # K1's p_scale (the training forward's third output): exactly 1
            # on rows with a live key, 1 / (keys averaged) on the others
            _, _, p_scale = fa._launch(q, k, v, bias, causal, True, with_p_scale=True)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            live = lse > attn.NEG_INF / 2
            err_p_scale = ((p_scale - p_scale_ref).abs() / p_scale_ref).max().item()
            dead_rows = int((~live).sum())
            tol_o, tol_lse = TOL[dtype_name]
            ok = (math.isfinite(err_o) and err_o <= tol_o and err_lse <= tol_lse
                  and bool((p_scale[live] == 1).all()) and err_p_scale <= P_SCALE_TOL)
            fwd_results.append({
                "case": "train_path_" + name, "dtype": dtype_name,
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "max_rel_err_p_scale": err_p_scale, "rows_with_no_live_key": dead_rows,
                "tol_o": tol_o, "tol_lse": tol_lse, "ok": ok,
            })
            log(f"phase 2: fwd {name:14s} {dtype_name:8s} B={q.shape[0]} Q={q.shape[1]} "
                f"K={k.shape[1]} ({fa.forward_variant(dt, q.shape[1])}) max|dO|={err_o:.3e} "
                f"max|dLSE|={err_lse:.3e} p_scale rel err={err_p_scale:.3e} over "
                f"{dead_rows} rows with no live key {'ok' if ok else 'FAIL'}")
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
    # on PPO's left padding, whose first rows see only padding, against
    # autograd through K1's function in plain ops (visited_reference): the
    # Function scales dO's rows by K1's p_scale, so those rows take the
    # derivative of the weights their forward used
    name, q32, k32, v32, bias, causal = backward_cases(torch, attn)[1]
    assert name == "train_left_pad"
    for dtype_name in ("float32", "bfloat16"):
        xs32 = [x.to(getattr(torch, dtype_name)) for x in (q32, k32, v32)]
        do = torch.randn(xs32[0].shape, generator=gen, device="cuda").to(xs32[0].dtype)
        grads = []
        for fn in (fa.flash_attention,
                   lambda *a: visited_reference(torch, fa, *a)[0]):
            xs = [x.clone().requires_grad_() for x in xs32]
            grads.append(torch.autograd.grad(fn(*xs, bias, causal), xs, do))
        errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(*grads)]
        tols = [BWD_TOL[dtype_name] * max(1.0, r.float().abs().max().item()) for r in grads[1]]
        ok = all(math.isfinite(e) and e <= t for e, t in zip(errs, tols))
        results.append({"case": "function_vs_autograd_left_pad", "dtype": dtype_name, "ok": ok,
                        "max_abs_err_dq": errs[0], "max_abs_err_dk": errs[1],
                        "max_abs_err_dv": errs[2]})
        log(f"phase 2: autograd Function vs autograd of K1's plain function ({dtype_name}, "
            f"{name}, rows with no live key): max|d(dq, dk, dv)|={errs[0]:.3e}/{errs[1]:.3e}/"
            f"{errs[2]:.3e} {'ok' if ok else 'FAIL'}")
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
    """Phase 2 at the seq2seq path's six attention shapes
    (:func:`hold_and_time` over :func:`t5_case`): K1 at all six, K2 (with
    the bias gradient where the update takes a learned bias) and K3 at the
    update's three, in bf16 and f32; timed in bf16 (SDPA's backward with
    the bias as a grad-carrying mask where the update differentiates it).
    Returns ``(fwd_results, bwd_results, fwd_timed, bwd_timed)``."""
    cases = []
    for name, (B, Q, K, kind, update) in T5_SHAPES.items():
        learned = kind in ("encoder", "decoder")
        cases.append((name, *t5_case(torch, attn, name), False,
                      "dbias" if update and learned else "backward" if update else "forward"))
    updates = [n for n, shape in T5_SHAPES.items() if shape[4]]
    return hold_and_time(torch, fa, attn, cases, fwd_timed=tuple(T5_SHAPES),
                         bwd_timed=updates)


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
    reset_int8_counters(fa)


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


def training_config(checkpoint_dir: str, **train):
    """The ``configs/ppo_sentiments.yml`` run at full GPT-2-small width with
    random weights, cut to two PPO phases (64 updates); ``train`` updates
    the train section."""
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
        "checkpoint_dir": checkpoint_dir, **train,
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


CAST_BUFFER = ("query_tokens", "query_mask", "response_tokens", "response_mask", "logprobs",
               "values", "rewards")


def cast_collect_equality(torch, config_fn, prompts, reward) -> dict:
    """One collect with ``train.rollout_param_cast`` on and one with it off,
    from the same seed, on ``config_fn(checkpoint dir, **train)``'s policy
    with every layer norm perturbed the same way (N(0, 0.05²) from a seed,
    so the norms the cast keeps f32 are not 1 and 0) and the reference
    taken again from it: ``torch.equal`` tokens, masks, behaviour
    logprobs, values, reference logprobs and rewards. Off every counted
    path."""
    import gc
    import tempfile

    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline

    runs = {}
    for cast in (True, False):
        with tempfile.TemporaryDirectory() as tmp:
            config = config_fn(tmp, rollout_param_cast=cast)
            trainer = PPOTrainer(config)
            gen = torch.Generator(device="cuda").manual_seed(5)
            with torch.no_grad():
                for name, p in trainer.model.named_parameters():
                    if ".ln_" in name:
                        p.add_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
            trainer._setup_reference(trainer.model.transformer, trainer.model_config.n_layer)
            pipeline = get_pipeline("PromptPipeline")(prompts, trainer.query_length)
            get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=reward,
                                                chunk_size=config.method.chunk_size)
            refs, score_ref = [], trainer.score_ref

            def recorded(*a, **kw):
                refs.append(score_ref(*a, **kw))
                return refs[-1]

            trainer.score_ref = recorded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.orch.make_experience(config.method.num_rollouts, 0)
            torch.cuda.synchronize()
            buf = trainer.buffer.full
            runs[cast] = {
                "collect_s": time.perf_counter() - t0,
                "refreshes": trainer.rollout_cast_refreshes,
                "cast_dtype": str(trainer.rollout_cast_dtype),
                "tensors": {**{k: getattr(buf, k) for k in CAST_BUFFER},
                            "ref_logprobs": torch.cat(refs)},
            }
            trainer.orch = None
            del trainer, buf, refs
            gc.collect()
    on, off = runs[True], runs[False]
    equal = {k: bool(torch.equal(v, off["tensors"][k])) for k, v in on["tensors"].items()}
    return {
        "equal": equal, "all_equal": all(equal.values()),
        "tokens": int(on["tensors"]["response_mask"].sum()),
        "cast_on": {k: on[k] for k in ("collect_s", "refreshes", "cast_dtype")},
        "cast_off": {k: off[k] for k in ("collect_s", "refreshes", "cast_dtype")},
    }


#: the phase phase 5 profiles: the second PPO phase, as the trainer counts
#: them (the first collect is phase 0)
PROFILED_PHASE = 1
#: the kernels phase 5's profiled phase runs, by their name in the trace,
#: and the launch counter each must equal there
TRACE_KERNELS = {
    "flash_fwd_tile_kernel": "FLASH_FWD_TILE_LAUNCHES",
    "flash_fwd_decode_kernel": "FLASH_FWD_DECODE_LAUNCHES",
    "flash_bwd_dq_tile_kernel": "FLASH_BWD_DQ_TILE_LAUNCHES",
    "flash_bwd_dkv_tile_kernel": "FLASH_BWD_DKV_TILE_LAUNCHES",
}
#: launches that must not happen in the window: K1's f32 and int8 variants
TRACE_ABSENT = {"flash_fwd_fma_kernel": "FLASH_FWD_FMA_LAUNCHES",
                "flash_fwd_decode_kernel_int8": "FLASH_FWD_DECODE_INT8_LAUNCHES"}
COLLECT_SPANS = ("collect/prompt_draw", "collect/dispatch", "collect/decode", "collect/score",
                 "collect/land")


def trace_kernel_name(name: str):
    """The port kernel a CUDA kernel event's demangled name launches
    (``..._int8`` for K1's decode over the int8 cache), or None."""
    m = re.search(r"\b(flash_[a-z0-9_]+?_kernel)\b", name)
    if m is None:
        return None
    return m.group(1) + ("_int8" if "Int8Rows" in name else "")


#: the blocks of a ``torch.profiler`` chrome trace that ``read_chrome_trace``
#: decodes: the device's events (kernels, copies, fills) and the session's
_TRACE_CATS = re.compile(rb'"cat": "(kernel|gpu_memcpy|gpu_memset|Trace)"')
#: the exporter opens each event's block with a brace two spaces in
_TRACE_BLOCK = b"\n  {\n"


def read_chrome_trace(path: str) -> dict:
    """A ``torch.profiler`` chrome trace's device events (kernels, copies
    and fills, each as written) and its window in microseconds (the
    exporter's ``Trace`` event, which spans the profiler's session). A
    trace of a GPT-2 phase holds some 800,000 events, a ninth of them the
    device's, so this decodes only the blocks whose own category is one of
    those, and of each only the fields written before its args."""
    with open(path, "rb") as fh:
        data = fh.read()
    decoder = json.JSONDecoder()
    device, window = [], 0.0
    for m in _TRACE_CATS.finditer(data):
        start = data.rfind(_TRACE_BLOCK, 0, m.start())
        end = data.find(_TRACE_BLOCK, m.end())
        block = data[start:end if end >= 0 else len(data)]
        args = block.find(b'"args"')
        if start < 0 or 0 <= args < m.start() - start:
            continue  # inside an event's args: not its own category
        # the fields read come before the args, which need no decoding
        head = block[:args].rstrip(b", \n") + b"}" if args >= 0 else block
        event, _ = decoder.raw_decode(head.decode().strip())
        if event.get("ph") != "X":
            continue
        if event["cat"] == "Trace":
            window = max(window, float(event["dur"]))
        else:
            device.append(event)
    if not window:
        raise ValueError(f"{path}: no Trace event; not a torch.profiler chrome trace")
    return {"device": device, "window_us": window, "bytes": len(data)}


def device_busy_us(events) -> float:
    """The union of the events' ``[ts, ts + dur)`` intervals, in microseconds."""
    busy, end = 0.0, -1.0
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def kernel_event_counts(events) -> dict:
    """The port's kernel events by kernel (``trace_kernel_name``)."""
    counts = {}
    for e in events:
        kernel = trace_kernel_name(e["name"]) if e["cat"] == "kernel" else None
        if kernel is not None:
            counts[kernel] = counts.get(kernel, 0) + 1
    return counts


def telemetry_cli(*argv: str):
    """``python -m trlx_tpu_torch.telemetry`` run in this process (the
    same ``main``): ``(exit status, standard output, standard error)``."""
    import contextlib
    import io

    from trlx_tpu_torch.telemetry.__main__ import main as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli(list(argv))
        except SystemExit as e:  # argparse's refusals
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def profiler_window_watch(fa, window: dict) -> dict:
    """Replacements of ``PhaseProfiler.on_phase_start``/``on_phase_end`` that
    read the launch counters of ``TRACE_KERNELS`` and ``TRACE_ABSENT`` into
    ``window["start"]`` as the window opens and ``window["end"]`` just
    before it closes (the close synchronises and stops; nothing launches in
    between), and time the close (the stop and the trace's export) into
    ``window["close_s"]``."""
    from trlx_tpu_torch.telemetry.profiler import PhaseProfiler

    orig = {"start": PhaseProfiler.on_phase_start, "end": PhaseProfiler.on_phase_end}
    counters = {**TRACE_KERNELS, **TRACE_ABSENT}

    def read():
        return {name: getattr(fa, c) for name, c in counters.items()}

    def on_phase_start(self, phase_index):
        orig["start"](self, phase_index)
        if self.active and "start" not in window:
            window["start"] = read()

    def on_phase_end(self, sync=None):
        if self.active:
            window["end"] = read()
        t0 = time.perf_counter()
        orig["end"](self, sync)
        if "end" in window and "close_s" not in window:
            window["close_s"] = time.perf_counter() - t0

    return {"on_phase_start": (PhaseProfiler, on_phase_start, orig["start"]),
            "on_phase_end": (PhaseProfiler, on_phase_end, orig["end"])}


def telemetry_gates(torch, window, tracer, registry, overlap, run_dir, profile_dir) -> dict:
    """Phase 5's telemetry checks (a)-(d) over what one ``learn`` left:
    the profiler window's counter reads, the tracer, the metrics registry,
    each phase's overlap stats, the run and profile directories."""
    traces = sorted(os.listdir(profile_dir)) if os.path.isdir(profile_dir) else []
    want_trace = f"phase_{PROFILED_PHASE}.pt.trace.json"
    summary = {"kernel_events": {}, "close_s": window.get("close_s")}
    if traces == [want_trace]:
        t0 = time.perf_counter()
        trace = read_chrome_trace(os.path.join(profile_dir, want_trace))
        busy = device_busy_us(trace["device"])
        summary.update(
            kernel_events=kernel_event_counts(trace["device"]),
            device_events=len(trace["device"]), device_busy_ms=busy / 1e3,
            window_ms=trace["window_us"] / 1e3, device_busy_share=busy / trace["window_us"],
            trace_bytes=trace["bytes"], read_s=time.perf_counter() - t0)
    deltas = ({k: window["end"][k] - window["start"][k] for k in window["start"]}
              if {"start", "end"} <= set(window) else {})
    events = summary["kernel_events"]
    kernels_ok = bool(deltas) and all(
        events.get(k, 0) == deltas[k] > 0 for k in TRACE_KERNELS) and all(
        events.get(k, 0) == deltas[k] == 0 for k in TRACE_ABSENT)
    counts = {k: int(v["count"]) for k, v in tracer.stats().items()}
    drains = [s.duration_ms for s in tracer.spans("train/drain")]
    spans_ok = (tracer.dropped == 0 and counts.get("phase/collect") == 2
                and counts.get("phase/train") == 2 and all(k in counts for k in COLLECT_SPANS)
                and len(overlap) == 2
                and [o["exp/overlap_drain_ms"] for o in overlap] == drains)
    files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    manifest, ledger, rows, watch = {}, [], [], (None, "", "")
    if files == ["ledger.jsonl", "manifest.json", "phases.jsonl"]:
        with open(os.path.join(run_dir, "manifest.json")) as fh:
            manifest = json.load(fh)
        with open(os.path.join(run_dir, "ledger.jsonl")) as fh:
            ledger = fh.read().splitlines()
        with open(os.path.join(run_dir, "phases.jsonl")) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        watch = telemetry_cli("--watch", run_dir, "--no-follow")
    watch_lines = watch[1].splitlines()
    ledger_ok = (
        len(ledger) == 1 and [r.get("phase") for r in rows] == [0, 1]
        and watch[0] == 0 and len(watch_lines) == 2
        and (manifest.get("platform") or {}).get("device_kind") == torch.cuda.get_device_name(0)
        and (manifest.get("payload") or {}).get("status") == "ok")
    gauges = registry.snapshot()["gauges"]
    overlap_gauges = sorted(k for k in gauges if k.startswith("exp/overlap_"))
    mem_gauges = sorted(k for k in gauges if k.startswith("mem/"))
    registry_ok = (len(overlap_gauges) == 4
                   and mem_gauges == ["mem/hbm_live_bytes", "mem/hbm_peak_bytes"])
    return {
        "ok": kernels_ok and spans_ok and ledger_ok and registry_ok,
        "kernels_ok": kernels_ok, "spans_ok": spans_ok, "ledger_ok": ledger_ok,
        "registry_ok": registry_ok, "traces": traces, "trace": summary,
        "launch_deltas": deltas, "span_counts": counts, "spans_dropped": tracer.dropped,
        "spans_per_phase": [sum(int(v["count"]) for v in r.get("spans", {}).values())
                            for r in rows],
        "drain_ms": drains, "overlap_drain_ms": [o["exp/overlap_drain_ms"] for o in overlap],
        "run_dir_files": files, "ledger_lines": len(ledger), "phase_rows": len(rows),
        "watch": watch_lines, "watch_rc": watch[0],
        "manifest_platform": manifest.get("platform"),
        "overlap_gauges": overlap_gauges, "mem_gauges": mem_gauges,
    }


def phase_training(torch, fa):
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    rows, evals, saved_rng, plain_calls, decode_forwards = [], [], [], [0], [0]
    overlap, window = [], {}
    orig = {
        "train_on": PPOTrainer._train_on, "evaluate": PPOTrainer.evaluate,
        "save": PPOTrainer.save, "apply": PPOTrainer._apply,
        "finish": PPOTrainer.finish_streamed_phase,
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

    def finish(self):
        out = orig["finish"](self)
        overlap.append(dict(self._last_overlap_stats))  # this phase's
        return out

    def counting(name):
        def fn(*a, **kw):
            plain_calls[0] += 1
            return orig[name](*a, **kw)
        return fn

    profiler_patches = profiler_window_watch(fa, window)
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as obs:
        run_dir, profile_dir = os.path.join(obs, "run"), os.path.join(obs, "profiles")
        config = training_config(tmp, telemetry={"ring_size": 1 << 16}, run_dir=run_dir,
                                 profile_dir=profile_dir, profile_phase=PROFILED_PHASE,
                                 health={"enabled": True,
                                         "dump_dir": os.path.join(obs, "health_dumps")})
        PPOTrainer._train_on, PPOTrainer.evaluate, PPOTrainer.save = train_on, evaluate, save
        PPOTrainer._apply, PPOTrainer.finish_streamed_phase = apply, finish
        for name, (cls, patched, _) in profiler_patches.items():
            setattr(cls, name, patched)
        fa.flash_attention_reference = counting("fwd")
        fa.flash_attention_backward_reference = counting("bwd")
        mem_start = reset_peak(torch)
        # count the main path's launches only
        reset_forward_counters(fa)
        reset_backward_counters(fa)
        t0 = time.perf_counter()
        try:
            with telemetry.scoped_tracer() as tracer, telemetry.scoped_metrics() as registry:
                trainer = trlx_tpu_torch.train(
                    reward_fn=training_reward, prompts=training_prompts(), config=config
                )
                torch.cuda.synchronize()
        finally:
            PPOTrainer._train_on, PPOTrainer.evaluate = orig["train_on"], orig["evaluate"]
            PPOTrainer.save, PPOTrainer._apply = orig["save"], orig["apply"]
            PPOTrainer.finish_streamed_phase = orig["finish"]
            for name, (cls, _, original) in profiler_patches.items():
                setattr(cls, name, original)
            fa.flash_attention_reference = orig["fwd"]
            fa.flash_attention_backward_reference = orig["bwd"]
        wall = time.perf_counter() - t0
        tele = telemetry_gates(torch, window, tracer, registry, overlap, run_dir, profile_dir)
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
    cast_check = cast_collect_equality(torch, training_config, training_prompts(),
                                       training_reward)
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
    # phase PROFILED_PHASE ran under the profiler (and the wall holds its
    # close): phase 0's numbers are the unprofiled ones
    phases = [
        dict(p, rollout_tokens_per_s=p["rollout_tokens"] / p["collect_s"],
             updates_per_s=per_phase / p["train_s"], profiled=i == PROFILED_PHASE)
        for i, p in enumerate(trainer.phase_times)
    ]
    record = {
        "wall_s": wall,
        "wall_profiled": True,
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
        "rollout_cast_refreshes": trainer.rollout_cast_refreshes,
        "cast_collect_equality": cast_check,
        "telemetry": tele,
    }
    log("phase 5: training " + json.dumps(record))
    plain, profiled = phases[1 - PROFILED_PHASE], phases[PROFILED_PHASE]
    log(f"phase 5: unprofiled phase {1 - PROFILED_PHASE}: collect {plain['collect_s']:.3f} s, "
        f"train {plain['train_s']:.3f} s (the numbers to compare across trees); phase "
        f"{PROFILED_PHASE} under the profiler: collect {profiled['collect_s']:.3f} s, train "
        f"{profiled['train_s']:.3f} s; the wall holds the window's close")
    log(f"phase 5: telemetry {'ok' if tele['ok'] else 'FAIL'} (wall with the telemetry on "
        f"{wall:.2f} s; (a) traces {tele['traces']}, kernel events in phase {PROFILED_PHASE}'s "
        f"trace {tele['trace']['kernel_events']} vs the launch counters' deltas "
        f"{tele['launch_deltas']}, device busy {tele['trace'].get('device_busy_ms')} ms of "
        f"the {tele['trace'].get('window_ms')} ms window, share "
        f"{tele['trace'].get('device_busy_share')}, the window's close (stop and export) "
        f"{tele['trace'].get('close_s')} s, the trace's read {tele['trace'].get('read_s')} s; "
        f"(b) spans {tele['span_counts']}, per phase "
        f"{tele['spans_per_phase']}, dropped {tele['spans_dropped']}, train/drain "
        f"{tele['drain_ms']} ms vs exp/overlap_drain_ms {tele['overlap_drain_ms']}; (c) "
        f"run_dir {tele['run_dir_files']}, ledger lines {tele['ledger_lines']}, phase rows "
        f"{tele['phase_rows']}, --watch rc {tele['watch_rc']}: {tele['watch']}; platform "
        f"{tele['manifest_platform']}; (d) gauges {tele['overlap_gauges'] + tele['mem_gauges']})")
    ok = (
        tele["ok"] and trainer.step == 64 and len(rows) == 2 and finite and changed > 0
        and restored and launches == expected and variants == expected_variants
        and bwd_variants == expected_bwd_variants and bwd_copies == 0
        and plain_calls[0] == 0 and cast_check["all_equal"]
        and cast_check["cast_on"]["refreshes"] == 1 and cast_check["cast_off"]["refreshes"] == 0
    )
    log(f"phase 5: {'ok' if ok else 'FAIL'} (updates={trainer.step}, phases={len(rows)}, "
        f"finite={finite}, changed tensors={changed}, load restores={restored}, "
        f"launches={launches} vs {expected}, K1 by variant {variants} vs "
        f"{expected_variants}, K2/K3 by variant {bwd_variants} vs {expected_bwd_variants}, "
        f"backward input copies={bwd_copies}, plain attention calls={plain_calls[0]}; "
        f"a collect with the rollout cast on against off: equal {cast_check['equal']}, "
        f"refreshes {cast_check['cast_on']['refreshes']} / {cast_check['cast_off']['refreshes']})")
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
# the port's, why). Empty: "auto" resolves by the port's own threshold
# (phase 23's sweep) and run-health monitoring is on, as bench.py sets them
BENCH_DEVIATIONS = ()
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
    """``BENCH_WORKLOAD`` at one freezing definition, cut to
    ``BENCH_UPDATES`` updates, its health dumps under the run's
    directory."""
    import copy

    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = copy.deepcopy(BENCH_WORKLOAD)
    cfg["model"]["num_layers_unfrozen"], cfg["model"]["ref_branch_layers"] = definition
    cfg["train"]["health"] = dict(cfg["train"]["health"],
                                  dump_dir=os.path.join(checkpoint_dir, "health_dumps"))
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


def sampler_cache_dtype(trainer) -> str:
    """The KV cache dtype the trainer's sampler allocates: the model's
    ``kv_cache_dtype`` resolved at the sampler's capacity (prompt width
    plus new tokens)."""
    import warnings

    from trlx_tpu_torch.models.gpt2 import resolve_kv_cache_dtype

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return resolve_kv_cache_dtype(trainer.model_config.kv_cache_dtype,
                                      trainer.query_length + trainer.gen_config.max_new_tokens)


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
    sampler_forwards, overlap = [0], []
    orig = {
        "learn": PPOTrainer.learn, "train_on": PPOTrainer._train_on,
        "evaluate": PPOTrainer.evaluate, "apply": PPOTrainer._apply,
        "score_ref": PPOTrainer.score_ref, "finish": PPOTrainer.finish_streamed_phase,
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
        sampler_forwards[0] += 1  # each writes the KV cache once a layer
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

    def finish(self):
        # each streamed phase's overlap stats (the epoch-1 updates that
        # ran while the phase collected)
        out = orig["finish"](self)
        overlap.append(dict(self._last_overlap_stats))
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
    PPOTrainer.finish_streamed_phase = finish
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
        PPOTrainer.finish_streamed_phase = orig["finish"]
        fa.flash_attention_reference = orig["fwd"]
        fa.flash_attention_backward_reference = orig["bwd"]
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": fa.FLASH_FWD_LAUNCHES,
        "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
        "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
    }
    variants = forward_variant_launches(fa)
    kv_int8 = int8_launches(fa)
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
    # "auto" at the sampler's capacity: on an int8 cache the decode steps
    # take decode_int8 and every sampler forward writes through kv_quant
    kv_dtype = sampler_cache_dtype(trainer)
    int8 = kv_dtype == "int8"
    expected_variants = {
        "tile": n_layer * (trainer.forwards - decode_forwards[0]),
        "decode": 0 if int8 else n_layer * decode_forwards[0],
        "fma": 0, "copies": 0,
    }
    expected_int8 = {"flash_fwd_decode_int8": n_layer * decode_forwards[0] if int8 else 0,
                     "kv_quant": n_layer * sampler_forwards[0] if int8 else 0}
    expected = {"flash_fwd": n_layer * trainer.forwards,
                "flash_bwd_dq": trained * updates, "flash_bwd_dkv": trained * updates}
    monitor = trainer.health_monitor
    health = {
        "enabled": monitor is not None,
        "event_counts": dict(monitor.event_counts) if monitor else None,
        "events": [{k: e[k] for k in ("detector", "severity", "series", "step", "phase",
                                      "value")} for e in map(lambda ev: ev.to_dict(),
                                                             monitor.events)] if monitor else [],
        "health_summary": monitor.health_summary() if monitor else {},
        "flight_dumps": list(trainer.flight_recorder.dumped) if trainer.flight_recorder else [],
        "health_stats_in_rows": sorted({k for r in rows for k in r if k.startswith("health/")}),
    }
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
    # the server casts its weights to the compute dtype (the leaves the
    # rollout cast keeps stay f32): the same cast of the saved tensors, bit
    # for bit
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
        "kv_cache_dtype": kv_dtype, "kv_int8_launches": kv_int8,
        "expected_kv_int8_launches": expected_int8, "health": health,
        "backward_variants": bwd_variants, "expected_backward_variants": expected_bwd_variants,
        "backward_copies": bwd_copies, "plain_attention_calls": plain_calls[0],
        "params_moved": sum(moved.values()), "params": len(moved),
        "frozen_bit_identical": not any(moved[n] for n in frozen), "frozen_tensors": len(frozen),
        "top_moved": all(moved[n] for n in top), "top_tensors": len(top),
        "server_restored": restored, "server_cast_tensors": cast,
        "served_complete": complete, "overlap": overlap,
    }
    log(f"phase 7: {name} " + json.dumps(record))
    ok = (
        record["loaded_equals_written"] and trainer.use_hydra and branch == 2
        and (ref_params, full_params) == (want_ref, want_full)
        and len(scoring_tiles) == len(trainer.phase_times)
        and all(n == n_layer for n in scoring_tiles)
        and updates == BENCH_UPDATES and len(rows) == 2 and finite and freezing_ok
        and launches == expected and variants == expected_variants and kv_int8 == expected_int8
        and bwd_variants == expected_bwd_variants and bwd_copies == 0 and plain_calls[0] == 0
        and restored and complete == 8
        # run health on, as bench.py sets it: the monitor built, the
        # update's health stats fetched
        and health["enabled"] and len(health["health_stats_in_rows"]) == 9
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
        f"{expected_bwd_variants}, KV cache {kv_dtype}, int8 kernels "
        f"{kv_int8} vs {expected_int8}; health events by detector "
        f"{health['event_counts']}, health stats {health['health_stats_in_rows']}; "
        f"backward input copies={bwd_copies}, plain attention "
        f"calls={plain_calls[0]}; server restored the checkpoint: {restored}, served "
        f"{complete}/8; exp/overlap_streamed_updates per phase "
        f"{[o.get('exp/overlap_streamed_updates') for o in overlap]}; wall {wall:.2f} s, peak "
        f"memory {peak} B, {mem_start} B allocated at the start)")
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

    from trlx_tpu_torch.models.gpt2 import INT8_KV_MAX_CAPACITY, resolve_kv_cache_dtype

    capacity = BENCH_WORKLOAD["train"]["seq_length"] + BENCH_WORKLOAD["method"]["gen_kwargs"][
        "max_new_tokens"]
    log("phase 7: bench.py's workload; deviations: " + json.dumps([
        {"setting": k, "bench.py": b, "port": p, "why": why}
        for k, b, p, why in BENCH_DEVIATIONS]) + "; one device; total_steps "
        f"{BENCH_WORKLOAD['train']['total_steps']} cut to {BENCH_UPDATES}; eval prompts: the "
        f"first 128; kv_cache_dtype 'auto' at capacity {capacity} resolves to "
        f"{resolve_kv_cache_dtype('auto', capacity)!r} (INT8_KV_MAX_CAPACITY = "
        f"{INT8_KV_MAX_CAPACITY}); train.health.enabled: "
        f"{BENCH_WORKLOAD['train']['health']['enabled']}")
    prompts = bench_prompts()
    records, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt2")
        written = random_backbone(
            torch, GPT2Model(GPT2Config.from_dict(GPT2_HF_CONFIG), device="cuda"), seed=7)
        write_hf_checkpoint(ckpt, GPT2_HF_CONFIG, gpt2_hf_layout(written))
        # the run ledger: an environment variable, not a config change
        ledger = os.path.join(tmp, "run_ledger.jsonl")
        previous = os.environ.get("TRLX_RUN_LEDGER")
        os.environ["TRLX_RUN_LEDGER"] = ledger
        try:
            for name, definition in BENCH_DEFINITIONS.items():
                def_ok, records[name] = run_bench_definition(
                    torch, fa, name, definition, ckpt, written, prompts, tmp)
                ok = ok and def_ok
            compare_rc, compare_out, compare_err = telemetry_cli("--compare", "~2", "~1")
        finally:
            if previous is None:
                os.environ.pop("TRLX_RUN_LEDGER", None)
            else:
                os.environ["TRLX_RUN_LEDGER"] = previous
        manifests = []
        if os.path.exists(ledger):
            with open(ledger) as fh:
                manifests = [json.loads(line) for line in fh if line.strip()]
    statuses = [m["payload"].get("status") for m in manifests]
    movers = [line for line in compare_out.splitlines() if line.startswith("movers")]
    ledger_ok = (statuses == ["ok"] * len(BENCH_DEFINITIONS) and compare_rc == 0
                 and movers and not movers[0].startswith("movers: none"))
    for name, manifest in zip(BENCH_DEFINITIONS, manifests):
        records[name]["run_ledger_manifest"] = {"run_id": manifest["run_id"],
                                                "status": manifest["payload"].get("status")}
    log(f"phase 7: run ledger {'ok' if ledger_ok else 'FAIL'} (manifests "
        f"{[m['run_id'] for m in manifests]}, status {statuses}; --compare ~2 ~1 rc "
        f"{compare_rc}: {compare_out.splitlines()[:12]} {compare_err[-400:]})")
    return ok and ledger_ok, records


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
    ("train.run_dir", None, "a directory in the phase's temporary directory",
     "the run ledger's manifest is gated"),
)
ILQL_TOP_K = 20  # the eval decode's default top_k (DEFAULT_ILQL_GEN_KWARGS)


def ilql_config(checkpoint_dir: str, run_dir=None):
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
                        checkpoint_interval=ILQL_UPDATES, checkpoint_dir=checkpoint_dir,
                        run_dir=run_dir)
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


def ilql_update_watch(torch, train_step, rows, syncs, sync_ok, times):
    """A replacement of ``ILQLTrainer.train_step`` (``train_step``, the
    original) that times each update into ``times["update_s"]``, appends
    its stats to ``rows`` and holds the target heads after it: ``alpha * q
    + (1 - alpha) * previous`` bit for bit on the sync steps (appended to
    ``syncs``), bit-identical to before on the rest; ``sync_ok[0]`` stays
    True while every update holds."""
    from trlx_tpu_torch.trainer.ilql_trainer import q_parameters

    def watched(self, mb):
        alpha = self.config.method.alpha
        every = self.config.method.steps_for_target_q_sync
        before = [t.clone() for t in q_parameters(self.target)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = train_step(self, mb)
        torch.cuda.synchronize()
        times["update_s"] += time.perf_counter() - t0
        rows.append({k: float(v) for k, v in stats.items()})
        if self.step % every == 0:
            syncs.append(self.step)
            want = [alpha * q + (1 - alpha) * t
                    for q, t in zip(q_parameters(self.model.heads), before)]
        else:
            want = before
        sync_ok[0] &= all(torch.equal(a, w) for a, w in zip(q_parameters(self.target), want))
        return stats

    return watched


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
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

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

    train_step = ilql_update_watch(torch, orig["train_step"], rows, syncs, sync_ok, times)

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
        config = ilql_config(run_dir, run_dir=os.path.join(tmp, "ledger_run"))
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
        manifest_path = os.path.join(tmp, "ledger_run", "manifest.json")
        manifest = {}
        if os.path.exists(manifest_path):
            with open(manifest_path) as fh:
                manifest = json.load(fh)
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
        "manifest": {"kind": manifest.get("kind"), "payload": manifest.get("payload"),
                     "platform": manifest.get("platform")},
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
        and manifest.get("kind") == "train/ILQLTrainer"
        and (manifest.get("payload") or {}).get("status") == "ok"
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
        f"peak memory {peak} B, {mem_start} B allocated at the start; run ledger manifest "
        f"{manifest.get('kind')} status {(manifest.get('payload') or {}).get('status')})")
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
               train=None, method=None, model=None):
    """``configs/<name>`` as written, from the checkpoint at ``model_path``
    without a tokenizer, cut to ``updates`` updates; ``train``, ``method``
    and ``model`` update those sections."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", name)).to_dict()
    cfg["model"].update(model_path=model_path, tokenizer_path="", **(model or {}))
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
    fa.FLASH_BLOCK_FWD_LAUNCHES = fa.FLASH_BLOCK_BWD_LAUNCHES = 0
    for counter in SPLIT3_COUNTERS.values():
        setattr(fa, counter, 0)
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
                     "flash_bwd_dq_dbias": fa.FLASH_BWD_DQ_DBIAS_LAUNCHES,
                     "flash_block_fwd": fa.FLASH_BLOCK_FWD_LAUNCHES,
                     "flash_block_bwd": fa.FLASH_BLOCK_BWD_LAUNCHES},
        "flash_fwd_variants": forward_variant_launches(fa),
        "backward_variants": backward_variant_launches(fa),
        "split3_launches": {k: getattr(fa, c) for k, c in SPLIT3_COUNTERS.items()},
        "kv_int8_launches": int8_launches(fa),
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


def trainer_state(trainer, device=None) -> dict:
    """``trainer``'s state as ``save`` writes it: parameters, Adam moments,
    the update count and KL state; the tensors where they lie, or copied to
    ``device``."""
    def move(t):
        return t.detach().to(device, copy=True) if device is not None else t

    opt = trainer.opt.state_dict()
    return {
        "model": {n: move(t) for n, t in trainer.model.state_dict().items()},
        "adam": {(i, key): move(v) for i, st in opt["adamw"]["state"].items()
                 for key, v in st.items()},
        "counters": (trainer.step, trainer.kl_coef, trainer.mean_kl, opt["count"]),
    }


def restores(torch, saved: dict, fresh, saved_rng) -> bool:
    """Whether ``fresh``, after ``load``, holds the :func:`trainer_state`
    ``saved`` exactly, and the generator as saved."""
    now = trainer_state(fresh)
    return (
        all(set(now[part]) == set(saved[part]) and all(
            torch.equal(now[part][k].to(t.device), t) for k, t in saved[part].items())
            for part in ("model", "adam"))
        and now["counters"] == saved["counters"]
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

    def record_push(self, batch, versions=None):
        watch["chunks"].append(batch)
        return push(self, batch, versions)

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
        restored = restores(torch, trainer_state(trainer), fresh, watch["saved_rng"])
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
        scorings0, updates0 = watch["scorings"], watch["updates"]
        stats = orig["make_experience"](self, *a, **kw)
        after = forward_variant_launches(fa)
        engine = self.trainer.rollout_engine_obj
        # the streamed phase's epoch-1 updates that ran as rows landed
        updates = watch["updates"] - updates0
        entry.update(
            stats={k: v for k, v in stats.items() if k.startswith("engine/")},
            pending=engine.pending, buffer_rows=len(self.trainer.buffer),
            launches={k: after[k] - before[k] for k in after}, updates_during_collect=updates,
            expected={"tile": N_LAYER * (engine.stats.prefills + watch["scorings"] - scorings0
                                         + updates),
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
            (Engine, "decode_step", decode_step), (engine_mod, "row_noise", row_noise)
        ] + update_watch(PPOTrainer, watch)
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=training_prompts(), config=config()), patches)
        fresh = PPOTrainer(config())
        fresh.load(run_dir)
        restored = restores(torch, trainer_state(trainer), fresh, watch["saved_rng"])
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


# phase 10's cut collect with the engine's serving features: chunked
# admission prefill and speculative decoding on the trainer's engine
CONTINUOUS_FEATURES = {"engine": "continuous", "prefill_chunk": 16,
                       "spec_decode": {"enabled": True, "max_draft": 4}}
CONTINUOUS_FEATURES_UPDATES = 32  # one collect (128 rollouts) and its update pass


def run_continuous_features(torch, fa, ckpt: str, written: dict):
    """Phase 10's cut run: ``configs/ppo_sentiments.yml`` with
    ``train.rollout: {engine: continuous, prefill_chunk: 16, spec_decode:
    {enabled: true, max_draft: 4}}`` from the checkpoint at ``ckpt``, one
    collect and its update pass (32 updates). Held to phase 10's
    per-collect gates (128 admitted = completed = recycled, none pending,
    each draw index once, K1 by variant: the reference scorings on
    ``tile``, the decode and verify steps and the 16-column chunk forwards
    on the variant their width picks) and, over the run, phase 5's gates
    with K2 = K3 = 12 x updates."""
    import tempfile

    import trlx_tpu_torch
    from trlx_tpu_torch.inference import engine as engine_mod
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    Engine = engine_mod.ContinuousBatchingEngine
    watch = {"collects": [], "scorings": 0}
    orig = {"score_ref": PPOTrainer.score_ref, "make_experience": PPOOrchestrator.make_experience,
            "drive": Engine.drive}

    def score_ref(self, *a, **kw):
        watch["scorings"] += 1
        return orig["score_ref"](self, *a, **kw)

    def drive(self, target):
        for group in orig["drive"](self, target):
            watch["collects"][-1]["harvested"].extend(group["rows"])
            yield group

    def make_experience(self, *a, **kw):
        entry = {"harvested": []}
        watch["collects"].append(entry)
        before = forward_variant_launches(fa)
        scorings0, updates0 = watch["scorings"], watch["updates"]
        stats = orig["make_experience"](self, *a, **kw)
        after = forward_variant_launches(fa)
        engine = self.trainer.rollout_engine_obj
        st = engine.stats
        # the reference scorings and the epoch-1 updates run as rows landed
        updates = watch["updates"] - updates0
        entry["updates_during_collect"] = updates
        expected = {"tile": N_LAYER * (watch["scorings"] - scorings0 + updates),
                    "decode": N_LAYER * st.decode_steps,  # Q = 1 and the Q = 5 verify
                    "fma": 0, "copies": 0}
        chunk = fa.forward_variant(torch.bfloat16, engine.prefill_chunk)
        expected[chunk] += N_LAYER * st.prefill_chunks
        entry.update(
            stats={k: v for k, v in stats.items() if k.startswith("engine/")},
            counters={"prefills": st.prefills, "prefill_chunks": st.prefill_chunks,
                      "prefill_cols_skipped": st.prefill_cols_skipped,
                      "decode_steps": st.decode_steps, "verify_steps": st.spec_steps,
                      "spec_drafted": st.spec_drafted, "spec_accepted": st.spec_accepted},
            pending=engine.pending, buffer_rows=len(self.trainer.buffer),
            launches={k: after[k] - before[k] for k in after}, expected=expected,
            chunk_variant=chunk)
        return stats

    with tempfile.TemporaryDirectory() as tmp:
        config = yml_config("ppo_sentiments.yml", os.path.join(tmp, "features"), ckpt,
                            CONTINUOUS_FEATURES_UPDATES,
                            train={"rollout": dict(CONTINUOUS_FEATURES)})
        patches = instrument(torch, PPOTrainer, "transformer", written, watch) + [
            (PPOTrainer, "score_ref", score_ref),
            (PPOOrchestrator, "make_experience", make_experience), (Engine, "drive", drive)
        ] + update_watch(PPOTrainer, watch)
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=training_prompts(), config=config), patches)
    gates = run_gates(torch, trainer, watch, record)
    collects = []
    for c in watch["collects"]:
        st = c["stats"]
        c["ok"] = (
            st["engine/admitted"] == st["engine/completed"] == st["engine/slot_recycles"] == 128
            and c["pending"] == 0 and c["buffer_rows"] == 128
            and sorted(c["harvested"]) == list(range(128)) and c["launches"] == c["expected"]
            and c["counters"]["prefill_chunks"] > 0)
        collects.append(dict(c, harvested=len(c["harvested"])))
    engine = trainer.rollout_engine_obj
    expected_bwd = {k: {"tile": N_LAYER * CONTINUOUS_FEATURES_UPDATES, "fma": 0}
                    for k in BWD_KERNELS}
    record.update(updates=trainer.step, phases=phase_rows(trainer), collects=collects,
                  gates=gates, expected_backward=expected_bwd,
                  engine={"prefill_chunk": engine.prefill_chunk,
                          "spec_max_draft": engine.spec_max_draft})
    ok = (
        trainer.step == CONTINUOUS_FEATURES_UPDATES and len(collects) == 1
        and all(c["ok"] for c in collects)
        and all(v for k, v in gates.items() if k != "params_changed")
        and gates["params_changed"] > 0
        and (engine.prefill_chunk, engine.spec_max_draft) == (16, 4)
        and record["backward_variants"] == expected_bwd
    )
    log("phase 10: continuous with chunked prefill and spec decode " + json.dumps(record))
    log(f"phase 10: continuous features {'ok' if ok else 'FAIL'} (updates={trainer.step}, "
        f"collects {[{k: c[k] for k in ('ok', 'counters', 'launches', 'expected')} for c in collects]}, "
        f"gates {gates}, K2/K3 {record['backward_variants']} vs {expected_bwd})")
    del trainer
    return ok, record


# phase 11: the serving tier on phase 4's model and geometry (greedy, as
# deterministic requests are served), with the shared-prefix pool,
# chunked admission prefill and speculative decoding on
SERVING_TIER_FEATURES = {
    "rollout": {"engine": "continuous", "prefill_chunk": 128, "prefill_chunks_per_pump": 2,
                "spec_decode": {"enabled": True, "max_draft": 4, "drafter": "trie"}},
    "serving": {"prefix_cache_blocks": 128},
}
#: phase 11's two tenants (each takes every other burst of its traffic) and
#: their SLO classes: budgets no queue wait of the run comes near, so a
#: clean run stays at zero health events
SERVING_TIER_TENANTS = {"gold": {"priority": 10, "slo_class": "interactive"},
                        "bronze": {"priority": 0, "slo_class": "standard"}}
SERVING_TIER_SLO = {"interactive": {"queue_wait_budget_ms": 30000},
                    "standard": {"queue_wait_budget_ms": 60000}}
SERVING_TIER_RING = 1 << 17  # train.telemetry.ring_size of the traced run
SYSTEM_PROMPTS, SYSTEM_TOKENS, TURN_TOKENS = 4, 384, 128  # 24 + 8 blocks of 16
SHARED_REQUESTS, OTHER_REQUESTS = 64, 32
F32_REQUESTS = 16  # the f32 token check's cut: 4 + 12 shared-prefix requests
NEAR_TIE = 1e-4  # top-2 logit margin under which f32 rounding may pick either


def serving_tier_config(features: bool, dtype: str = "bfloat16"):
    """Phase 4's serving config, greedy, in ``dtype``; with ``features``
    the pool, chunked prefill and speculative decoding of phase 11."""
    cfg = serving_config()
    cfg["train"]["dtype"] = dtype
    cfg["method"]["gen_kwargs"]["do_sample"] = False
    cfg["train"]["serving"] = {"tenants": SERVING_TIER_TENANTS,
                               "slo_classes": SERVING_TIER_SLO}
    cfg["train"]["telemetry"] = {"ring_size": SERVING_TIER_RING}
    if features:
        cfg["train"]["rollout"].update(SERVING_TIER_FEATURES["rollout"])
        cfg["train"]["serving"].update(SERVING_TIER_FEATURES["serving"])
    return cfg


def serving_tier_prompts(seed: int = 4):
    """96 requests arriving in 12 bursts of 8 (one admission group each),
    the bursts in a seeded order: 8 bursts of chat traffic, two per system
    prompt, where each request is one of 4 system prompts of 384 tokens
    followed by its own 128-token turn (512 tokens, so all pad alike: the
    traffic a system prompt or a few-shot header gives), and 4 bursts of
    other traffic at phase 4's real lengths of 16..512. Skipping a chunk is
    a decision over an admission group, so what it saves depends on how
    alike a group's requests are. Returns the prompts and whether each
    shares a system prompt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    systems = rng.integers(0, 50256, (SYSTEM_PROMPTS, SYSTEM_TOKENS))
    bursts = []
    for b in range(SHARED_REQUESTS // 8):
        system = [int(t) for t in systems[b % SYSTEM_PROMPTS]]
        bursts.append([(system + [int(t) for t in rng.integers(0, 50256, TURN_TOKENS)], True)
                       for _ in range(8)])
    for _ in range(OTHER_REQUESTS // 8):
        bursts.append([([int(t) for t in rng.integers(0, 50256, int(rng.integers(16, 513)))],
                        False) for _ in range(8)])
    ordered = [req for b in rng.permutation(len(bursts)) for req in bursts[b]]
    return [p for p, _ in ordered], [shared for _, shared in ordered]


def serving_tier_tenants(n: int) -> list:
    """The tenant of each of phase 11's ``n`` requests: bursts of 8 go to
    ``gold`` and ``bronze`` in turn."""
    names = sorted(SERVING_TIER_TENANTS)
    return [names[(i // 8) % len(names)] for i in range(n)]


def serve_record(torch, server, prompts, waves=None, tenants=None):
    """Serve ``prompts`` (in ``waves``, each a list of indices, when given;
    request ``i`` as tenant ``tenants[i]`` when given) and return the
    results in prompt order, the wall, and the rates."""
    import numpy as np

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [None] * len(prompts)
    for wave in waves or [list(range(len(prompts)))]:
        if tenants is None:
            rids = server.submit([prompts[i] for i in wave])
        else:
            rids = [server.submit([prompts[i]], tenant=tenants[i])[0] for i in wave]
        done = server.wait(rids)
        for i, rid in zip(wave, rids):
            results[i] = done[rid]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(r["timing"]["ttft_ms"] for r in results)
    tokens = int(sum(r["length"] for r in results))
    return results, {
        "requests": len(results), "generated_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
    }


def host_watch(engine_mod, pool_cls):
    """Patches (for ``counted_path``) that time the engine's steps (their
    wall, device waits included), its drafting and its chunk planning, and
    the pool's admission planning, all on the host clock; and the dict they
    fill."""
    Engine = engine_mod.ContinuousBatchingEngine
    watch = {"step_s": 0.0, "steps": 0, "draft_s": 0.0, "plan_s": 0.0, "plans": 0}
    orig = {"step": Engine._step_once, "draft": Engine._draft_now,
            "need": Engine._plan_chunk_need, "plan": pool_cls.plan_admission}

    def timed(fn, key, count=None):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            watch[key] += time.perf_counter() - t0
            if count:
                watch[count] += 1
            return out
        return wrapper

    return watch, [(Engine, "_step_once", timed(orig["step"], "step_s", "steps")),
                   (Engine, "_draft_now", timed(orig["draft"], "draft_s")),
                   (Engine, "_plan_chunk_need", timed(orig["need"], "plan_s")),
                   (pool_cls, "plan_admission", timed(orig["plan"], "plan_s", "plans"))]


def overlay_timing(torch, server) -> dict:
    """The decode step's cache read at phase 11's shapes (32 slots, the
    576-wide view, 12 heads of 64), per layer: the paged view gather alone
    and with the pool overlay's second gather (``kv_cache.paged_write_read``
    with and without ``shared_tables``), timed as ``time_ms`` times."""
    from trlx_tpu_torch.inference import kv_cache

    layer = server.engine._state.cache[0]
    B, cap, H, D = layer["k"].shape
    cap -= 1
    k = torch.zeros(B, 1, H, D, dtype=layer["k"].dtype, device=layer["k"].device)
    idx = torch.full((B,), cap, device=k.device)  # the discard sentinel
    private = {key: layer[key] for key in ("k", "v", "block_tables")}
    shared = dict(private, **{key: layer[key] for key in ("shared_k", "shared_v",
                                                           "shared_tables")})
    return {name: time_ms([lambda c=c: kv_cache.paged_write_read(c, k, k, idx, k.dtype)])
            for name, c in (("view_gather_ms", private), ("with_overlay_ms", shared))}


def first_difference(a, b):
    """Index of the first differing token of two lists (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def top2_margin(torch, model, prompt, tokens) -> float:
    """Top-2 logit margin of ``model``'s next-token choice after ``prompt``
    and ``tokens`` (an uncached causal forward)."""
    ids = torch.tensor([list(prompt) + list(tokens)], device="cuda")
    with torch.no_grad():
        logits = model(ids)["logits"][0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


class OracleDrafter:
    """A drafter that proposes what a reference run served for the same
    prompt, aligned as the verify step reads drafts: the anchor it samples
    is token t, and draft j is checked against token t + j, so after t
    emitted tokens the oracle proposes the reference's tokens t+1..t+D.
    The policy accepts them wherever it computes what the reference
    computed, so this holds the verify step's accepted path (rather than
    its rejections) at full width."""

    def __init__(self, max_draft: int, answers: dict):
        self.max_draft, self.answers = max_draft, answers  # prompt -> tokens
        self._prompt, self._emitted = {}, {}

    def observe_context(self, row, tokens):
        self._prompt[row], self._emitted[row] = tuple(tokens), 0

    def observe_tokens(self, row, tokens):
        self._emitted[row] = self._emitted.get(row, 0) + len(tokens)

    def draft(self, row):
        t = self._emitted.get(row, 0)
        return list(self.answers.get(self._prompt.get(row), ())[t + 1:t + 1 + self.max_draft])

    def forget(self, row):
        self._prompt.pop(row, None)
        self._emitted.pop(row, None)

    def reset(self):
        self._prompt.clear()
        self._emitted.clear()

    def observe_accept(self, row, n_proposed, n_accepted):
        pass

    def set_tenant(self, row, tenant):
        pass

    def stats(self):
        return {}


def serve_counted(torch, fa, server, prompts, waves=None, tenants=None):
    """Serve ``prompts`` as one counted path (counters zeroed before, read
    after; the host watch in place); returns the results and the record:
    rates, launches, peak memory above the start, the engine's sharing,
    chunk and spec counters, host time per step."""
    import numpy as np

    from trlx_tpu_torch.inference import engine as engine_mod
    from trlx_tpu_torch.serving.prefix_cache import PrefixBlockPool

    watch, patches = host_watch(engine_mod, PrefixBlockPool)
    (results, rates), rec = counted_path(
        torch, fa, lambda: serve_record(torch, server, prompts, waves, tenants), patches)
    st, engine = server.engine.stats, server.engine
    steps = max(watch["steps"], 1)
    rec.update(
        rates, stats=server.stats(), decode_steps=st.decode_steps, verify_steps=st.spec_steps,
        prefills=st.prefills, prefill_chunks=st.prefill_chunks,
        prefill_chunks_skipped=st.prefill_cols_skipped // max(engine.prefill_chunk, 1),
        prefix_hit_blocks=st.prefix_hit_blocks, prefix_hit_rate=st.prefix_hit_rate,
        prefix_blocks_saved=st.prefix_blocks_saved, spec_accept_rate=st.spec_accept_rate,
        spec_tokens_per_verify_step=st.spec_tokens_per_step,
        spec_draft_len_p50=st.spec_draft_len_p50,
        peak_above_start_bytes=rec["max_memory_allocated_bytes"] - rec["allocated_at_start_bytes"],
        step_wall_ms=1e3 * watch["step_s"] / steps,
        draft_host_ms_per_step=1e3 * watch["draft_s"] / steps,
        plan_host_ms=1e3 * watch["plan_s"],
        finite=all(np.isfinite(r["logprobs"]).all() and np.isfinite(r["values"]).all()
                   for r in results),
        min_length=min(r["length"] for r in results))
    return results, rec


def request_trace_gates(tracer, registry, server, results, tenants, log_path) -> dict:
    """Phase 11's telemetry checks over the traced features-on run: one
    ``serve/request`` chain per completed request whose ``STAGES`` tile the
    root exactly (each stage starts where the one before ended, bit for
    bit, from the root's start to its end); no span dropped; each tenant's
    ``serve/*`` histogram counts equal to its completions; zero health
    events; and the telemetry CLI's ``--trace-report --json`` over the
    exported span log (in this process) with every chain complete and a
    zero residual up to the report's rounding (each stage and the e2e to 1
    us: at most 3.5 us a request)."""
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.telemetry.request_trace import ROOT, STAGES

    spans = tracer.spans()
    chains = {}
    for span in spans:
        trace_id = span.attrs.get("trace_id")
        if trace_id is not None:
            chains.setdefault(trace_id, []).append(span)
    roots = [c for c in chains.values() if sum(sp.name == ROOT for sp in c) == 1]
    tiled, worst_ns = 0, 0.0
    for chain in roots:
        root = next(sp for sp in chain if sp.name == ROOT)
        stages = sorted((sp for sp in chain if sp.name in STAGES), key=lambda sp: sp.start)
        contiguous = (bool(stages) and stages[0].start == root.start
                      and stages[-1].end == root.end
                      and all(a.end == b.start for a, b in zip(stages, stages[1:]))
                      and all(sp.parent == root.index for sp in stages))
        tiled += contiguous
        worst_ns = max(worst_ns, abs(sum(sp.end - sp.start for sp in stages)
                                     - (root.end - root.start)) * 1e9)
    snap = registry.snapshot()
    per_tenant = {}
    for tenant in sorted(set(tenants)):
        want = tenants.count(tenant)
        counts = {name: snap["histograms"].get(f"{name}[tenant={tenant}]", {}).get("count", 0)
                  for name in ("serve/queue_wait_ms", "serve/prefill_ms", "serve/ttft_ms",
                               "serve/decode_per_token_ms", "serve/e2e_ms")}
        counts["serve/requests_completed"] = snap["counters"].get(
            f"serve/requests_completed[tenant={tenant}]", 0)
        per_tenant[tenant] = {"completions": want, "counts": counts,
                              "equal": all(int(c) == want for c in counts.values())}
    n_events = telemetry.export_chrome_jsonl(log_path, spans,
                                             counters=registry.gauge_series())
    rc, out, err = telemetry_cli("--trace-report", log_path, "--json")
    report = json.loads(out) if rc == 0 else {}
    stage_names = sorted({sp.name for sp in spans if "trace_id" in sp.attrs})
    rec = {
        "requests": len(results), "chains": len(chains), "rooted_chains": len(roots),
        "tiled_chains": tiled, "stage_sum_max_abs_diff_ns": worst_ns,
        "spans": len(spans), "dropped": int(tracer.dropped), "span_names": stage_names,
        "per_tenant": per_tenant, "health_events": [e.to_dict() for e in server.health_events],
        "exported_events": n_events, "report_rc": rc, "report_err": err[-500:],
        "report": {k: report.get(k) for k in ("n_requests", "n_complete", "max_residual_pct",
                                              "tenants", "slo_classes")},
        "report_max_residual_ms": max((abs(r["e2e_ms"] - r["stage_sum_ms"])
                                       for r in report.get("requests", [])), default=1.0),
        "report_bubbles": {k: (report.get("bubbles") or {}).get(k) for k in (
            "median_step_ms", "total_bubble_ms", "n_spec_excluded", "spec_tokens_accepted")},
    }
    rec["gates"] = {
        "one_closed_chain_per_request": len(chains) == len(roots) == len(results),
        "stages_tile_the_root": tiled == len(results),
        "no_span_dropped": rec["dropped"] == 0,
        "per_tenant_counts": all(t["equal"] for t in per_tenant.values()),
        "zero_health_events": not rec["health_events"],
        # a zero residual up to the report's own rounding: each of the 6
        # stages and the e2e are rounded to 1 us
        "trace_report": (rc == 0 and report.get("n_complete") == len(results)
                         and rec["report_max_residual_ms"] <= 0.0035),
    }
    return rec


def multi_tenant_smoke_on_card(torch, tmp: str) -> dict:
    """``python -m trlx_tpu_torch.inference --mt-smoke`` on the card, in this
    process (its ``multi_tenant_smoke``, under a fresh tracer and metrics
    registry), its span log exported under ``tmp``: the exit status, the
    wall, and its JSON record and verdict lines."""
    import contextlib
    import io

    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.inference.__main__ import multi_tenant_smoke

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with telemetry.scoped_tracer(), telemetry.scoped_metrics(), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = multi_tenant_smoke(device="cuda", span_log=os.path.join(tmp, "mt_spans.jsonl"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    record = json.loads(out.getvalue().strip().splitlines()[0]) if rc in (0, 1) else {}
    keep = ("spec_off_row_parity", "gold_ranks", "bronze_ranks", "ttft_stream_ms",
            "ttft_harvest_ms", "scheduler_throttled_rounds", "prefix_hit_rate",
            "prefill_chunks", "request_spans", "spans_dropped", "health_events",
            "engine/spec_accept_rate")
    return {"rc": rc, "wall_s": wall, "record": {k: record.get(k) for k in keep},
            "verdict": [ln for ln in err.getvalue().splitlines() if "mt-smoke" in ln]}


def phase_serving_tier(torch, fa):
    """Phase 11: ``InferenceServer`` on phase 4's model and geometry in
    bf16, greedy, with ``serving.prefix_cache_blocks: 128``,
    ``rollout.prefill_chunk: 128`` (2 chunks a pump) and
    ``rollout.spec_decode`` (trie drafter, 4 drafts), serving
    :func:`serving_tier_prompts`; then the same traffic through phase 4's
    engine (the three features off), and, as a report, with the features on
    and the features-off run's tokens as drafts (:class:`OracleDrafter`),
    all in the same call. The requests go to two tenants
    (``SERVING_TIER_TENANTS``: priorities 10 and 0, SLO classes interactive
    and standard), a burst each in turn. The features-on run is traced (the
    tracer on, ``train.telemetry.ring_size`` = ``SERVING_TIER_RING``, a
    fresh metrics registry), the other two are not. Gates: 96/96 complete
    with finite logprobs and values; prefix hit blocks in (0, 64 x 24];
    every pool reference released and no block leaked; fewer chunk
    forwards than admitted groups x 4; K1 ``tile`` = 12 x chunk forwards,
    ``decode`` = 12 x (decode + verify steps), no ``fma`` launch, input
    copy or plain call, and the same launches per chunk and per step
    traced as untraced (the oracle run has the features on, untraced);
    verify steps > 0; :func:`request_trace_gates`; and
    :func:`multi_tenant_smoke_on_card` exits 0. Then 16 shared-prefix requests in f32 through the
    ``fma`` K1, features off, on, and on with the oracle drafter (whose
    drafts must mostly be accepted): tokens identical on every row, except
    where the first difference is a near tie (top-2 logit margin < 1e-4 in
    the features-off run). Prints the runs' tokens/s, TTFT, peak memory,
    sharing, chunk and spec counters, host time per step and the share of
    rows whose tokens match the features-off run."""
    import tempfile

    import numpy as np

    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.inference.engine import prefill_dot_flops
    from trlx_tpu_torch.inference.server import InferenceServer

    prompts, is_shared = serving_tier_prompts()
    tenants = serving_tier_tenants(len(prompts))
    untraced = functools.partial(telemetry.scoped_tracer, telemetry.Tracer(enabled=False))
    tmp = tempfile.mkdtemp(prefix="serving_tier_")
    with telemetry.scoped_tracer() as tracer, telemetry.scoped_metrics() as registry:
        server = InferenceServer(serving_tier_config(True), seed=0)
        on, rec = serve_counted(torch, fa, server, prompts, tenants=tenants)
        rec["traced"] = True
        rec["tracer_ring"] = tracer._records.maxlen
        t0 = time.perf_counter()
        rec["telemetry"] = request_trace_gates(tracer, registry, server, on, tenants,
                                               os.path.join(tmp, "spans.jsonl"))
        rec["telemetry"]["gates_wall_s"] = time.perf_counter() - t0
    engine, pool, cfg = server.engine, server.prefix_pool, server.model_config
    A, Q, W, cap = engine.admit_width, engine.Q, engine.prefill_chunk, engine.capacity
    rec["flops"] = {
        "chunk": engine._chunk_flop_cost(),
        "chunked_group": (Q // W - 1) * engine._chunk_flop_cost()
        + prefill_dot_flops(cfg, A, W, Q, heads=True),
        "monolithic_group": prefill_dot_flops(cfg, A, Q, cap, heads=True),
        "saved": engine.stats.prefill_flops_saved,
    }
    rec["pool"] = {"blocks": pool.pool_blocks, "free": pool.free_blocks,
                   "nodes": len(pool._nodes),
                   "max_refcount": max((n.refcount for n in pool._nodes.values()), default=0)}
    released = not server._acquired and not server._published_by_row
    rec["overlay"] = overlay_timing(torch, server)
    del server, engine, pool
    with untraced():
        server = InferenceServer(serving_tier_config(False), seed=0)
        off, rec_off = serve_counted(torch, fa, server, prompts, tenants=tenants)
    del server
    answers = {tuple(p): r["tokens"] for p, r in zip(prompts, off)}
    with untraced():
        server = InferenceServer(serving_tier_config(True), seed=0)
        server.engine.spec_drafter = OracleDrafter(server.engine.spec_max_draft, answers)
        oracle, rec_oracle = serve_counted(torch, fa, server, prompts, tenants=tenants)
    del server
    rec["mt_smoke"] = multi_tenant_smoke_on_card(torch, tmp)
    for r, results in ((rec, on), (rec_oracle, oracle)):
        r["rows_identical_to_features_off"] = float(np.mean(
            [a["tokens"] == b["tokens"] for a, b in zip(results, off)]))
    rec["rows_identical_shared"] = float(np.mean(
        [a["tokens"] == b["tokens"] for a, b, s in zip(on, off, is_shared) if s]))
    variants = rec["flash_fwd_variants"]
    expected = {"tile": N_LAYER * rec["prefill_chunks"],
                "decode": N_LAYER * rec["decode_steps"], "fma": 0, "copies": 0}
    rec["expected_variants"] = expected
    gates = {
        "complete": len(on) == len(prompts) and rec["min_length"] >= 1 and rec["finite"],
        "prefix_hits": 0 < rec["prefix_hit_blocks"] <= SHARED_REQUESTS * SYSTEM_TOKENS // 16,
        "pool_released": (rec["pool"]["max_refcount"] == 0 and released
                          and rec["pool"]["nodes"] + rec["pool"]["free"] == rec["pool"]["blocks"]),
        "chunks_skipped": rec["prefill_chunks"] < rec["prefills"] * (Q // W),
        "k1_by_variant": variants == expected,
        "no_plain_calls": rec["plain_attention_calls"] == 0,
        "verify_steps": rec["verify_steps"] > 0,
        # K1 per chunk forward and per decode/verify step, traced (features
        # on) and untraced (the oracle run, features on)
        "k1_unchanged_by_tracing": all(
            r["flash_fwd_variants"]["tile"] == N_LAYER * r["prefill_chunks"]
            and r["flash_fwd_variants"]["decode"] == N_LAYER * r["decode_steps"]
            and r["prefill_chunks"] > 0 and r["verify_steps"] > 0 for r in (rec, rec_oracle)),
        **{"telemetry_" + k: v for k, v in rec["telemetry"]["gates"].items()},
        "mt_smoke": rec["mt_smoke"]["rc"] == 0,
    }
    side_gates = {name: (len(res) == len(prompts) and r["finite"]
                         and r["plain_attention_calls"] == 0
                         and r["flash_fwd_variants"]["fma"] == 0
                         and r["flash_fwd_variants"]["copies"] == 0)
                  for name, res, r in (("features_off", off, rec_off),
                                       ("oracle_drafts", oracle, rec_oracle))}
    # the f32 cut: 16 shared-prefix requests through K1's fma variant, in
    # two waves (one request per system prompt publishes, the rest read)
    picks = [i for i, shared in enumerate(is_shared) if shared]
    first = {}
    for i in picks:
        first.setdefault(tuple(prompts[i][:SYSTEM_TOKENS]), i)
    wave1 = list(first.values())
    wave2 = [i for i in picks if i not in wave1][:F32_REQUESTS - len(wave1)]
    f32_prompts = [prompts[i] for i in wave1 + wave2]
    waves = [list(range(len(wave1))), list(range(len(wave1), len(f32_prompts)))]
    f32 = {}
    for name in ("features_off", "features_on", "oracle_drafts"):
        srv = InferenceServer(serving_tier_config(name != "features_off", "float32"), seed=0)
        if name == "oracle_drafts":
            srv.engine.spec_drafter = OracleDrafter(srv.engine.spec_max_draft, {
                tuple(p): r["tokens"] for p, r in zip(f32_prompts, f32["features_off"])})
        reset_forward_counters(fa)
        f32[name] = serve_record(torch, srv, f32_prompts, waves)[0]
        st = srv.engine.stats
        f32[name + "_record"] = {
            "variants": forward_variant_launches(fa), "verify_steps": st.spec_steps,
            "spec_accept_rate": st.spec_accept_rate,
            "spec_tokens_per_verify_step": st.spec_tokens_per_step,
            "prefix_hit_blocks": st.prefix_hit_blocks, "prefill_chunks": st.prefill_chunks}
        if name == "features_off":
            f32_model = srv.model
        del srv
    differing = {}
    for name in ("features_on", "oracle_drafts"):
        differing[name] = []
        for i, (a, b) in enumerate(zip(f32[name], f32["features_off"])):
            step = first_difference(a["tokens"], b["tokens"])
            if step is not None:
                margin = top2_margin(torch, f32_model, f32_prompts[i], b["tokens"][:step])
                differing[name].append({"row": i, "step": step, "top2_margin": margin})
    del f32_model
    rec["f32"] = {"requests": len(f32_prompts), "differing_rows": differing,
                  **{name: f32[name + "_record"]
                     for name in ("features_off", "features_on", "oracle_drafts")}}
    on32, oracle32 = f32["features_on_record"], f32["oracle_drafts_record"]
    gates["f32_tokens"] = all(d["top2_margin"] < NEAR_TIE
                              for rows in differing.values() for d in rows)
    gates["f32_through_fma"] = all(
        f32[n + "_record"]["variants"]["tile"] == f32[n + "_record"]["variants"]["decode"] == 0
        and f32[n + "_record"]["variants"]["fma"] > 0
        for n in ("features_off", "features_on", "oracle_drafts"))
    gates["f32_shared"] = on32["prefix_hit_blocks"] > 0
    gates["f32_oracle_drafts_accepted"] = oracle32["spec_accept_rate"] >= 0.5
    rec["features_off"], rec["oracle_drafts"] = rec_off, rec_oracle
    rec["gates"], rec["side_gates"] = gates, side_gates
    ok = all(gates.values()) and all(side_gates.values())
    log("phase 11: serving tier " + json.dumps(rec))
    summary = {name: {k: r[k] for k in (
        "tokens_per_s", "ttft_ms_p50", "ttft_ms_p95", "peak_above_start_bytes",
        "prefix_hit_rate", "prefix_blocks_saved", "prefills", "prefill_chunks",
        "prefill_chunks_skipped", "decode_steps", "verify_steps", "spec_accept_rate",
        "spec_tokens_per_verify_step", "spec_draft_len_p50", "step_wall_ms",
        "draft_host_ms_per_step", "plan_host_ms")} for name, r in (
            ("features_on_traced", rec), ("features_off", rec_off),
            ("oracle_drafts", rec_oracle))}
    tele = rec["telemetry"]
    log(f"phase 11: serving tier {'ok' if ok else 'FAIL'} (gates {gates}, side gates "
        f"{side_gates}; K1 by variant {variants} vs {expected}; {json.dumps(summary)}; "
        f"FLOPs {json.dumps(rec['flops'])}; rows identical to features off (bf16, report): "
        f"features on {rec['rows_identical_to_features_off']:.4f}, oracle drafts "
        f"{rec_oracle['rows_identical_to_features_off']:.4f}; overlay "
        f"{json.dumps(rec['overlay'])}; f32 {json.dumps(rec['f32'])}; request traces: "
        f"{tele['tiled_chains']}/{tele['requests']} chains tile their root (max |sum - root| "
        f"{tele['stage_sum_max_abs_diff_ns']:.3f} ns), {tele['dropped']} spans dropped of "
        f"{tele['spans']}, per-tenant counts {json.dumps(tele['per_tenant'])}, "
        f"{len(tele['health_events'])} health events, trace report {json.dumps(tele['report'])} "
        f"bubbles {json.dumps(tele['report_bubbles'])} ({tele['gates_wall_s']:.2f} s); "
        f"mt-smoke rc {rec['mt_smoke']['rc']} in {rec['mt_smoke']['wall_s']:.2f} s "
        f"{json.dumps(rec['mt_smoke']['record'])} {rec['mt_smoke']['verdict']})")
    return ok, rec


def device_summary(prof, wall: float) -> dict:
    """Summarise a torch.profiler run's device timeline: busy share of the
    wall, and device time by kernel."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        kernels = read_chrome_trace(trace)["device"]
    busy = device_busy_us(kernels)
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
    and phase 10's continuous-engine run, and phase 11's traffic with the
    serving features on and off; write each run's device summary as JSON
    at ``path``."""
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
    prompts = serving_tier_prompts()[0]
    for name, features in (("serving_tier", True), ("serving_tier_features_off", False)):
        server = InferenceServer(serving_tier_config(features), seed=0)
        with profile(activities=activities) as prof:
            _, rates = serve_record(torch, server, prompts)
        summary[name] = device_summary(prof, rates["wall_s"])
        del server
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


# ---------------------------------------------------------------------------
# GPT-J-6B (configs/ppo_gptj.yml): the head-dim-256 instantiations, the
# model, serving (phase 12) and PPO (phase 13)
# ---------------------------------------------------------------------------

GPTJ_ARCH = {  # EleutherAI/gpt-j-6B's config.json (configs/ppo_gptj.yml's model)
    "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096, "n_layer": 28,
    "n_head": 16, "rotary_dim": 64,
}
GPTJ_HF_CONFIG = {  # as its HF config.json names it
    "model_type": "gptj", "architectures": ["GPTJForCausalLM"], **GPTJ_ARCH,
    "n_inner": None, "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new",
    "tie_word_embeddings": False, "bos_token_id": 50256, "eos_token_id": 50256,
}
GPTJ_HEADS, GPTJ_D, GPTJ_EOS = 16, 256, 50256
GPTJ_CHECK_LAYERS = 2  # phase 3's cut depth and the HF checkpoint's (full width)
GPTJ_UPDATES = 128  # two PPO phases: 128 rollouts / batch 8 x 4 epochs each
GPTJ_TRAIN_LAYERS = 8  # phase 13's cut depth (phase 12 serves all 28)
# what phase 13 runs differently from configs/ppo_gptj.yml: (setting, the
# yml's value, the port's, why)
GPTJ_DEVIATIONS = (
    ("train.mesh", {"dp": -1, "fsdp": 1, "tp": 4}, {"dp": -1, "fsdp": 1, "tp": 1},
     "one card: tp 4 needs four ranks (phase 27 runs the mesh path with two ranks that "
     "share the card; four cards are ROADMAP item 14)"),
    ("model.model_arch.n_layer", 28, GPTJ_TRAIN_LAYERS, "the smoke's time limit: phase 12 "
     "serves all 28 blocks; every width, head count and head dim stays GPT-J-6B's"),
    ("model.model_path", "EleutherAI/gpt-j-6B", "", "the checkpoint is not in the repo: "
     "random weights from train.seed at its widths"),
    ("model.tokenizer_path", "gpt2", "", "no tokenizer in the repo: int-list prompts and a "
     "host reward on the ids"),
    ("train.total_steps", 10000, GPTJ_UPDATES, "the smoke's time limit: two PPO phases"),
    ("train.eval_interval", 100, GPTJ_UPDATES, "one eval, at the end"),
    ("train.checkpoint_interval", 10000, GPTJ_UPDATES, "one checkpoint, at the end"),
)
# K1 at GPT-J's path shapes, timed in bf16 (gptj_kernel_cases names)
GPTJ_TIMED = ("gptj_rollout_prefill", "gptj_rollout_decode", "gptj_update",
              "gptj_ref_scoring", "gptj_serving_prefill", "gptj_serving_decode")


def wide_kernel_cases(torch, attn, prefix: str, D: int, H: int, rollout_batch: int,
                      update_batch: int, seed: int):
    """(name, q, k, v, bias, causal, kind) at head dim ``D``, f32, from a
    fixed seed; ``kind``: ``"forward"`` (K1 only), ``"backward"`` (K1, then
    K2 and K3) or ``"dbias"`` (K2 with the bias gradient of a learned bias).
    The paths' shapes at ``H`` heads (48 prompt + 48 new tokens,
    ``rollout_batch`` rollouts, ``update_batch`` rows an update; phases 12
    and 14's serving geometry), and the edges at 4 heads: ragged Q/K with a
    padding bias, left padding whose first causal rows see only padding, 16
    key tiles with peaked logits, 16 query chunks and key tiles under the
    causal flag, Q <= 16 under the causal flag, also with rows that see
    only padding (:func:`small_q_masked_rows_mask`). Names start with
    ``prefix``."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qkv(B, Q, K, heads=H):
        return [torch.randn(B, T, heads, D, generator=gen, device=dev) for T in (Q, K, K)]

    def left(B, Q, K, lo, hi, width=None):
        """[B, K] masks of prompts of lo..hi real tokens left-padded to Q
        columns; the columns from Q on count up to ``width``."""
        lens = torch.randint(lo, hi + 1, (B, 1), generator=gen, device=dev)
        cols = torch.arange(K, device=dev)[None]
        return (cols >= Q - lens) & (cols < (Q if width is None else width))

    RB, UB = rollout_batch, update_batch
    cases = []
    # the fixed sampler's prefill: 48 prompt columns over the 96-wide cache,
    # causal and left padding as one [B, 1, Q, K] bias; a decode step at
    # column 48 + t
    bias = attn.causal_bias(48, 96, 0, dev) + attn.padding_bias(left(RB, 48, 96, 16, 48).long())
    cases.append((f"{prefix}_rollout_prefill", *qkv(RB, 48, 96), bias, False, "forward"))
    t = int(torch.randint(0, 48, (), generator=gen, device=dev))
    bias = attn.causal_bias(1, 96, 48 + t, dev) + attn.padding_bias(
        left(RB, 48, 96, 16, 48, width=49 + t).long())
    cases.append((f"{prefix}_rollout_decode", *qkv(RB, 1, 96), bias, False, "forward"))
    # the update: [query; response] of 48 + 48 under the causal flag with a
    # [B, 1, 1, K] padding bias (first keys valid), and with PPO's left
    # padding, whose rows before the first real token see only padding
    keep = torch.arange(96, device=dev)[None] < 4
    mask = (torch.rand(UB, 96, generator=gen, device=dev) > 0.2) | keep
    cases.append((f"{prefix}_update", *qkv(UB, 96, 96), attn.padding_bias(mask.long()), True,
                  "backward"))
    cases.append((f"{prefix}_update_left_pad", *qkv(UB, 96, 96),
                  attn.padding_bias(left(UB, 48, 96, 16, 48, width=96).long()), True, "backward"))
    # the reference scoring: all the rollouts under the causal flag
    cases.append((f"{prefix}_ref_scoring", *qkv(RB, 96, 96),
                  attn.padding_bias(left(RB, 48, 96, 16, 48, width=96).long()), True, "forward"))
    # the serving phase: an admission prefill of 8 prompts, 512 columns over
    # the 576-wide view, and a decode step of 32 slots at per-row depths
    bias = attn.causal_bias(512, 576, 0, dev) + attn.padding_bias(
        left(8, 512, 576, 16, 512).long())
    cases.append((f"{prefix}_serving_prefill", *qkv(8, 512, 576), bias, False, "forward"))
    depth = torch.randint(16, 576, (32,), generator=gen, device=dev)
    mask = (torch.arange(576, device=dev)[None] <= depth[:, None]).long()
    bias = attn.causal_bias(1, 576, depth, dev) + attn.padding_bias(mask)
    cases.append((f"{prefix}_serving_decode", *qkv(32, 1, 576), bias, False, "forward"))
    return cases + edge_kernel_cases(torch, attn, gen, prefix, D)


def edge_kernel_cases(torch, attn, gen, prefix: str, D: int):
    """The edges every head dim's phase-2 cases share, at 4 heads, drawn
    from ``gen`` (f32, kinds as :func:`wide_kernel_cases`'): ragged Q/K
    with a padding bias, 16 key tiles with peaked logits, 16 query chunks
    and key tiles under the causal flag, Q <= 16 under the causal flag,
    also with rows that see only padding, a learned bias through K2's
    dbias."""
    dev = "cuda"

    def qkv(B, Q, K):
        return [torch.randn(B, T, 4, D, generator=gen, device=dev) for T in (Q, K, K)]

    cases = []
    keep = torch.arange(141, device=dev)[None] < 4
    mask = (torch.rand(2, 141, generator=gen, device=dev) > 0.3) | keep
    cases.append((f"{prefix}_ragged", *qkv(2, 77, 141), attn.padding_bias(mask.long()), False,
                  "backward"))
    q, k, v = qkv(2, 130, 1024)
    bias = 2 * torch.randn(2, 1, 130, 1024, generator=gen, device=dev)
    cases.append((f"{prefix}_long_k", 3 * q, k, v, bias, False, "backward"))
    keep = torch.arange(1024, device=dev)[None] < 4
    mask = (torch.rand(1, 1024, generator=gen, device=dev) > 0.2) | keep
    cases.append((f"{prefix}_long_causal", *qkv(1, 1024, 1024),
                  attn.padding_bias(mask.long()), True, "backward"))
    cases.append((f"{prefix}_small_q_causal", *qkv(2, 9, 130), None, True, "backward"))
    cases.append((f"{prefix}_small_q_masked_rows", *qkv(2, 9, 130),
                  attn.padding_bias(small_q_masked_rows_mask(torch, 2, 130, dev)), True,
                  "backward"))
    # a learned [1, H, Q, K] bias under left padding: K2 with dbias
    table = 2 * torch.randn(1, 4, 130, 130, generator=gen, device=dev)
    q, k, v = qkv(2, 130, 130)
    lens = torch.randint(64, 131, (2, 1), generator=gen, device=dev)
    cols = torch.arange(130, device=dev)[None]
    pad = attn.padding_bias(((cols >= 130 - lens) & (cols < 130)).long())
    cases.append((f"{prefix}_dbias", q, k, v, table + pad, False, "dbias"))
    return cases


def gptj_kernel_cases(torch, attn):
    """:func:`wide_kernel_cases` at GPT-J-6B's D = 256, H = 16
    (configs/ppo_gptj.yml: 128 rollouts, batch 8)."""
    return wide_kernel_cases(torch, attn, "gptj", GPTJ_D, GPTJ_HEADS, rollout_batch=128,
                             update_batch=8, seed=30)


def phase_gptj_kernels(torch, fa, attn):
    """Phase 2 at D = 256 (:func:`hold_and_time` over
    :func:`gptj_kernel_cases`): K1, K2 (with and without dbias) and K3 in
    bf16 and f32; timed in bf16, K1 at ``GPTJ_TIMED``, K2 and K3 at the
    update and K2 with dbias at its case."""
    return hold_and_time(torch, fa, attn, gptj_kernel_cases(torch, attn),
                         fwd_timed=GPTJ_TIMED, bwd_timed=("gptj_update", "gptj_dbias"),
                         relative_o=True)


def relative_o_check(torch, fa, q, k, v, bias, causal, o, o_ref, dtype_name) -> dict:
    """K1's O held elementwise to ``O_REL_TOL`` of P|V| + |O_ref| (P|V|: the
    plain weights of :func:`visited_reference` times |V|, in f32), and two
    planted faults held to break that bound: the columns of V's last
    64-column swizzle atom left out of P.V (192..255 at D = 256; at D = 96
    the padded atom's real columns 64..95; below D = 64, where the row is
    one padded atom, its last 16-byte chunk, columns D - 8 .. D - 1: 16..23
    at D = 24), and those columns' share of key tile 0 left out. Returns
    the row's fields: max |dO| / bound for O and for each fault, and
    ``ok`` when O's is at most 1 and each fault's above 1."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o32, ref = o.float(), o_ref.float()
    tol = O_REL_TOL[dtype_name] * (
        visited_reference(torch, fa, qf, kf, vf.abs(), bias, causal)[0] + ref.abs())
    tol = tol.clamp_min(1e-30)
    D = q.shape[-1]
    # the last atom's real columns, or below D = 64 the row's last chunk
    last = slice((D - 1) // 64 * 64 if D >= 64 else D - 8, D)
    atom = o32.clone()
    atom[..., last] = 0
    tile0 = vf.clone()
    tile0[:, fa.KEY_TILE:] = 0
    key_tile = o32.clone()
    key_tile[..., last] -= visited_reference(torch, fa, qf, kf, tile0, bias, causal)[0][..., last]
    over = {name: ((f - ref).abs() / tol).max().item()
            for name, f in (("o", o32), ("v_atom", atom), ("v_atom_key_tile_0", key_tile))}
    err_over = over.pop("o")
    return {"max_err_over_tol_o": err_over, "planted_fault_err_over_tol": over,
            "ok": err_over <= 1 and all(x > 1 for x in over.values())}


def hold_and_time(torch, fa, attn, cases, fwd_timed, bwd_timed, relative_o=False):
    """Hold K1 against its plain version (restricted under the causal flag
    to the keys K1 visits) and, for a case of kind ``"backward"`` or
    ``"dbias"``, K2 (with the bias gradient for ``"dbias"``) and K3 against
    the plain backward fed K1's own O and LSE, in bf16 and f32, at
    ``cases`` ((name, q, k, v, bias, causal, kind) in f32); time in bf16 K1
    at the cases named in ``fwd_timed`` and K2, K3 at those in
    ``bwd_timed``, through their C entry points (arguments packed
    beforehand) and their wrappers, beside the plain version, SDPA (the
    yardstick the port never calls; for the backward its whole backward,
    with the bias as a grad-carrying mask where it is learned) and the
    bound. O is held to TOL's absolute bound, or with ``relative_o`` by
    :func:`relative_o_check`. Returns ``(fwd_results, bwd_results,
    fwd_timed, bwd_timed)``, the timed rows keyed by (case, dtype) and
    (case, kernel)."""
    import torch.nn.functional as F

    fwd_results, results, fwd_rows, bwd_rows = [], [], {}, {}
    for name, q32, k32, v32, bias, causal, kind in cases:
        B, Q, H, D = q32.shape
        K = k32.shape[1]
        learned = kind == "dbias"
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            o, lse = fa.flash_attention(q, k, v, bias, causal, True)
            o_ref, lse_ref = visited_reference(torch, fa, q, k, v, bias, causal)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = TOL[dtype_name]
            row = {"case": name, "dtype": dtype_name, "max_abs_err_o": err_o,
                   "max_abs_err_lse": err_lse, "tol_o": tol_o, "tol_lse": tol_lse}
            if relative_o:
                row["tol_o"] = f"{O_REL_TOL[dtype_name]:g} x (P|V| + |O|)"
                row.update(relative_o_check(torch, fa, q, k, v, bias, causal, o, o_ref,
                                            dtype_name))
                ok_o = row.pop("ok")
            else:
                ok_o = err_o <= tol_o
            row["ok"] = ok = math.isfinite(err_o) and ok_o and err_lse <= tol_lse
            fwd_results.append(row)
            detail = (f" max|dO|/bound={row['max_err_over_tol_o']:.3f}, planted faults' "
                      + ", ".join(f"{n} {x:.3g}" for n, x in
                                  row["planted_fault_err_over_tol"].items())
                      if relative_o else "")
            log(f"phase 2: fwd {name:20s} {dtype_name:8s} B={B} H={H} Q={Q} K={K} D={D}"
                f"{' causal' if causal else ''} ({fa.forward_variant(dt, Q)}) "
                f"max|dO|={err_o:.3e} max|dLSE|={err_lse:.3e}{detail} "
                f"{'ok' if ok else 'FAIL'}")
            if name in fwd_timed and dtype_name == "bfloat16":
                fwd_rows[(name, dtype_name)] = row = time_forward(
                    torch, fa, attn, q, k, v, bias, causal)
                log_timed(name, dtype_name, row)
            if kind == "forward":
                continue
            gen = torch.Generator(device="cuda")
            gen.manual_seed(31)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            got = fa._launch_backward(q, k, v, bias, o, lse, do, causal, dbias=learned)
            want = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do, causal,
                                                         learned)
            torch.cuda.synchronize()
            row = {"case": name, "dtype": dtype_name, "variant": fa.backward_variant(dt)}
            ok = True
            for key, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                # dbias is dS in f32 on both sides: only the order of the sums differs
                tol = (1e-4 if key == "dbias" else BWD_TOL[dtype_name]) * max(
                    1.0, w.float().abs().max().item())
                row[f"max_abs_err_{key}"], row[f"tol_{key}"] = err, tol
                ok = ok and math.isfinite(err) and err <= tol
            row["ok"] = ok
            results.append(row)
            log(f"phase 2: bwd {name:20s} {dtype_name:8s} ({row['variant']}"
                f"{', dbias' if learned else ''}) "
                + " ".join(f"max|d{key}|={row[f'max_abs_err_{key}']:.3e}"
                           f"(tol {row[f'tol_{key}']:.1e})"
                           for key in ("dq", "dk", "dv", "dbias") if f"tol_{key}" in row)
                + f" {'ok' if ok else 'FAIL'}")
            if dtype_name != "bfloat16" or name not in bwd_timed:
                continue
            tensors = [q, k, v, bias, o, lse, do]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            copies = input_copies(tensors, nbytes)
            # the packed outputs stay referenced while their calls run
            dkv_packed = None
            if learned:
                dq_calls, packed = packed_dbias_calls(torch, fa, copies)
                _, dkv_calls, dkv_packed = packed_backward_calls(torch, fa, copies, False)
            else:
                dq_calls, dkv_calls, packed = packed_backward_calls(torch, fa, copies, causal)
            kernel_dq, kernel_dkv = time_ms(dq_calls), time_ms(dkv_calls)
            rcs = [dq_calls[0](), dkv_calls[0]()]
            torch.cuda.synchronize()
            same = rcs == [0, 0] and torch.equal(packed[0][1], got[0]) and (
                torch.equal(packed[0][2], got[3]) if learned
                else all(torch.equal(a, b) for a, b in zip(packed[0][2:], got[1:])))
            results.append({"case": name + "_packed_calls", "dtype": dtype_name, "ok": same,
                            "max_abs_err_dq": 0.0, "max_abs_err_dk": 0.0,
                            "max_abs_err_dv": 0.0})
            log(f"phase 2: packed K2/K3 calls at {name} rc={rcs}, outputs equal the wrappers': "
                f"{'ok' if same else 'FAIL'}")
            del packed, dkv_packed, dq_calls, dkv_calls
            wrapper = {
                "flash_bwd_dq": time_ms([
                    (lambda c=c: fa._launch_packed("dq", fa._backward_args(*c, False), True))
                    if learned else (lambda c=c: fa._launch_dq(*c, causal)) for c in copies]),
                "flash_bwd_dkv": time_ms([lambda c=c: fa._launch_dkv(*c, causal)
                                          for c in copies]),
            }
            plain = time_ms([lambda c=c: fa.flash_attention_backward_reference(
                *c, causal, learned) for c in copies])
            # SDPA's whole backward, its forward outside the timed window;
            # the causal and padding masks as one mask in the compute dtype,
            # grad-carrying where the bias is learned
            graphs = []
            for c in copies:
                ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in c[:3])
                mask = c[3] + (attn.causal_bias(Q, K, 0, "cuda") if causal else 0)
                mask = mask.to(dt).detach().requires_grad_(learned)
                out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
                graphs.append((out, (ql, kl, vl, mask) if learned else (ql, kl, vl),
                               c[6].transpose(1, 2)))
            library = time_ms([
                lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)
                for g in graphs])
            del copies, graphs
            bounds = backward_bound(fa, q, k, bias, causal, dtype_name)
            if learned:  # the dbias write, f32 [B, H, Q, K]
                flops = bounds["flash_bwd_dq"]["flops"]
                nb = bounds["flash_bwd_dq"]["bytes"] + B * H * Q * K * 4
                t_bytes = nb / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
                bounds["flash_bwd_dq"] = {"bound_ms": max(t_bytes, t_ops), "bytes": nb,
                                          "flops": flops,
                                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            shape = (f"B={B} H={H} Q={Q} K={K} D={D}" + (" causal" if causal else "")
                     + (f", bias {list(bias.shape)}" if bias is not None else "")
                     + (" (dbias)" if learned else ""))
            for kname, ms in (("flash_bwd_dq", kernel_dq), ("flash_bwd_dkv", kernel_dkv)):
                bwd_rows[(name, kname)] = row = {
                    "shape": shape, "variant": fa.backward_variant(dt), "dbias": learned,
                    "ms": ms, "wrapper_ms": wrapper[kname], "plain_ms": plain,
                    "library_ms": library, **bounds[kname],
                }
                log(f"phase 2: {kname} bf16 {name} {shape} ({row['variant']}): "
                    f"kernel_ms={ms} wrapper_ms={wrapper[kname]} plain_ms={plain} (whole plain "
                    f"backward) library_ms={library} (SDPA's whole backward) "
                    f"bound_ms={row['bound_ms']} ({row['bound_by']})")
    return fwd_results, results, fwd_rows, bwd_rows


def gptj_model(torch, n_layer: int, dtype: str, seed: int):
    """A GPT-J-6B-wide policy (value head included) of ``n_layer`` blocks on
    the card, random weights from ``seed``."""
    from trlx_tpu_torch.models.gptj import GPTJConfig, GPTJModel
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params

    cfg = GPTJConfig(**dict(GPTJ_ARCH, n_layer=n_layer), dtype=dtype)
    model = CausalLMWithValueHead(cfg, GPTJModel, device="cuda")
    init_params(model, seed)
    return cfg, model


def phase_gptj_model(torch, fa):
    """Phase 3 at D = 256: :func:`wide_model_checks` on a full-width f32
    GPT-J of ``GPTJ_CHECK_LAYERS`` blocks, the gradient at the yml's B = 8."""
    from trlx_tpu_torch.models import gptj

    cfg, model = gptj_model(torch, GPTJ_CHECK_LAYERS, "float32", 40)
    return wide_model_checks(torch, fa, gptj, cfg, model, "GPT-J", GPTJ_D, full_depth=28,
                             grad_batch=8, seed=41)


def wide_model_checks(torch, fa, family, cfg, model, label: str, D: int, full_depth: int,
                      grad_batch: int, seed: int, seq: int = 96, grad_split=(48, 48)):
    """Phase 3 for a wide family at head dim ``D``: a full-width f32
    ``model`` (blocks cut from ``full_depth``) through the kernels against
    the plain attention (``family.dot_product_attention`` swapped). (a) the
    forward without a cache (2 rows of ``seq`` columns, left padding); (b)
    prefill into the paged cache (rotated block tables) and greedy decode
    steps at each row's position, against the plain full forward of the
    whole sequence; (c) the gradient of a PPO loss on one minibatch of the
    yml's geometry (``grad_batch`` rows, ``grad_split`` query + response
    columns), with K2 = K3 = one ``fma``
    launch per block, held per parameter group (max |error| / max |value|)
    against the gradient with the attention in f64
    (:func:`attention_f64`): within 1e-3 or twice the plain f32 version's
    own distance from it, whichever is larger. f32 and no TF32: at B = 8
    the plain version lies within ~3e-6 of the f64 attention's gradient, so
    the bound is 1e-3; at B = 32 f32 alone moves the embedding gradient by
    ~5e-3 of its largest element (``PERF.md`` §6), and the kernels are
    held to the precision f32 allows there."""
    from trlx_tpu_torch.inference.kv_cache import init_paged_cache
    from trlx_tpu_torch.ops.ppo_math import ppo_loss
    from trlx_tpu_torch.utils import logprobs_from_logits

    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, Q, R = 2, seq, 4
    ids = torch.randint(0, cfg.vocab_size, (B, Q), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    mask[0, :30] = 0  # left padding

    def plain(q, k, v, bias=None, causal=False, **kw):
        return fa.flash_attention_reference(q, k, v, bias, causal)

    def f64(q, k, v, bias=None, causal=False, **kw):
        return attention_f64(torch, q, k, v, bias, causal)

    def run(attention, fn, *args, **kw):
        orig = family.dot_product_attention
        family.dot_product_attention = attention
        try:
            return fn(*args, **kw)
        finally:
            family.dot_product_attention = orig

    def forward(attention, *args, **kw):
        with torch.no_grad():
            return run(attention, model, *args, **kw)

    kernel = family.dot_product_attention
    launched = fa.FLASH_FWD_LAUNCHES
    out = forward(kernel, ids, attention_mask=mask)
    ref = forward(plain, ids, attention_mask=mask)
    real = mask.bool()
    err_fwd = max((out[key] - ref[key])[real].abs().max().item() for key in ("logits", "values"))

    cache = init_paged_cache(cfg.n_layer, B, Q + R, cfg.n_head, D, torch.float32,
                             block_size=16, device=dev)
    nb = cache[0]["block_tables"].shape[1]
    cache[0]["block_tables"].copy_(torch.stack(
        [torch.roll(torch.arange(nb, device=dev), -t) for t in (1, 4)]).to(torch.int32))
    n_real = mask.sum(-1)
    step = forward(kernel, ids, attention_mask=torch.cat([mask, mask.new_zeros(B, R)], 1),
                   position_ids=(mask.cumsum(-1) - 1).clamp_min(0), cache=cache,
                   cache_index=0, last_only=True)["logits"][:, -1]
    seq, seq_mask, steps = ids, mask, [step]
    for t in range(R - 1):
        tok = steps[-1].argmax(-1)
        seq = torch.cat([seq, tok[:, None]], 1)
        seq_mask = torch.cat([seq_mask, mask.new_ones(B, 1)], 1)
        cache_mask = (torch.arange(Q + R, device=dev)[None] <= Q + t).long() * torch.cat(
            [mask, mask.new_ones(B, R)], 1)
        steps.append(forward(kernel, tok[:, None], attention_mask=cache_mask,
                             position_ids=(n_real + t)[:, None], cache=cache,
                             cache_index=torch.full((B,), Q + t, device=dev))["logits"][:, 0])
    full = forward(plain, seq, attention_mask=seq_mask)["logits"]
    err_cache = max((steps[i] - full[:, Q - 1 + i]).abs().max().item() for i in range(R))
    launched = fa.FLASH_FWD_LAUNCHES - launched
    fwd_ok = err_fwd <= 1e-3 and err_cache <= 1e-3 and launched == cfg.n_layer * (1 + R)
    log(f"phase 3: full-width f32 {label} ({cfg.n_layer} of {full_depth} blocks, D={D}), "
        f"kernel vs plain: forward max|d(logits, values)|={err_fwd:.3e}; paged prefill + "
        f"{R - 1} decode steps vs plain full forward max|dlogits|={err_cache:.3e}; "
        f"launches={launched} {'ok' if fwd_ok else 'FAIL'}")

    # the PPO-loss gradient at the yml's geometry
    B, (Q, R) = grad_batch, grad_split
    lens = torch.randint(16, Q + 1, (B,), generator=gen, device=dev)
    q_mask = (torch.arange(Q, device=dev)[None] >= Q - lens[:, None]).long()
    q_ids = torch.randint(0, cfg.vocab_size, (B, Q), generator=gen, device=dev) * q_mask
    r_ids = torch.randint(0, cfg.vocab_size, (B, R), generator=gen, device=dev)
    r_len = torch.randint(1, R + 1, (B,), generator=gen, device=dev)
    r_mask = (torch.arange(R, device=dev)[None] < r_len[:, None]).long()
    old = [torch.randn(B, R, generator=gen, device=dev) for _ in range(4)]
    old[0] = old[0] * 0.1 - 10.0  # behaviour logprobs
    params = list(model.parameters())

    def grads_with(attention):
        def loss_grads():
            logits, values = model.response_forward(
                torch.cat([q_ids, r_ids], 1), torch.cat([q_mask, r_mask], 1), Q)
            logprobs = logprobs_from_logits(logits, r_ids)
            loss, _ = ppo_loss(logprobs, values.float(), *old, r_mask, 0.2, 0.2, 1.0)
            return torch.autograd.grad(loss, params)
        return run(attention, loss_grads)

    before = backward_variant_launches(fa)
    kgrads = grads_with(kernel)
    after = backward_variant_launches(fa)
    launches = {k: {v: after[k][v] - before[k][v] for v in BWD_VARIANTS} for k in BWD_KERNELS}
    rgrads, f64grads = grads_with(plain), grads_with(f64)

    def rel(got, want):
        """max |error| / max |value| per parameter group"""
        groups = {}
        for (name, _), g, r in zip(model.named_parameters(), got, want):
            group = ("value head" if name.startswith("v_head") else
                     "embeddings" if ".wte." in name or ".wpe." in name else
                     "lm head" if ".lm_head." in name else
                     "layer norms" if ".ln_" in name else
                     "attention" if ".attn." in name else "mlp")
            err, top = groups.get(group, (0.0, 0.0))
            groups[group] = (max(err, (g - r).abs().max().item()),
                             max(top, r.abs().max().item()))
        return {k: err / max(top, 1e-30) for k, (err, top) in groups.items()}

    kernel_rel, plain_rel, kernel_vs_plain = (
        rel(kgrads, f64grads), rel(rgrads, f64grads), rel(kgrads, rgrads))
    bound = {k: max(1e-3, 2 * v) for k, v in plain_rel.items()}
    grad_ok = all(math.isfinite(v) and v <= bound[k] for k, v in kernel_rel.items()) and (
        launches == {k: {"tile": 0, "fma": cfg.n_layer} for k in BWD_KERNELS})
    log(f"phase 3: full-width f32 {label} PPO-loss gradient (B={B}, {Q} + {R}), max relative "
        "error per group against the f64 attention's gradient: kernels "
        + json.dumps(kernel_rel) + ", plain f32 attention " + json.dumps(plain_rel)
        + " (kernels vs plain " + json.dumps(kernel_vs_plain) + "), bound max(1e-3, 2 x plain)"
        + f"; K2/K3 launches by variant {json.dumps(launches)} {'ok' if grad_ok else 'FAIL'}")
    del model, kgrads, rgrads, f64grads, params
    return fwd_ok and grad_ok


def attention_f64(torch, q, k, v, bias=None, causal=False):
    """Attention in f64 (softmax(QK^T s + bias + causal mask) V, the
    output cast back to q's dtype): phase 3's yardstick for the gradient
    of a model around f32 attention."""
    Q, K = q.shape[1], k.shape[1]
    from trlx_tpu_torch.ops.attention import causal_bias

    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.double()
    if causal:
        logits = logits + causal_bias(Q, K, device=q.device).double()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v.double()).to(q.dtype)


def gptj_hf_layout(state: dict) -> dict:
    """The port's ``GPTJModel`` state dict in HF ``GPTJForCausalLM``'s
    layout: the backbone under ``transformer.``, the untied head (weight
    and bias) as ``lm_head.``; Linear weights stay [out, in]."""
    return {(n if n.startswith("lm_head.") else "transformer." + n): t for n, t in state.items()}


def phase_gptj_checkpoint(torch):
    """A GPT-J checkpoint in HF layout at full width and ``GPTJ_CHECK_LAYERS``
    blocks (random weights from a seed, ``config.json`` +
    ``model.safetensors``), loaded through ``model.model_path`` by the PPO
    trainer on ``configs/ppo_gptj.yml`` (its mesh set to one device): the
    loaded backbone must equal the written tensors bit for bit."""
    import tempfile

    from trlx_tpu_torch.models.gptj import GPTJConfig, GPTJModel
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    hf_config = dict(GPTJ_HF_CONFIG, n_layer=GPTJ_CHECK_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gptj")
        t0 = time.perf_counter()
        written = random_backbone(
            torch, GPTJModel(GPTJConfig.from_dict(hf_config), device="cuda"), seed=42)
        layout = gptj_hf_layout(written)
        write_hf_checkpoint(ckpt, hf_config, layout)
        write_s = time.perf_counter() - t0
        config = yml_config("ppo_gptj.yml", os.path.join(tmp, "run"), ckpt, GPTJ_UPDATES,
                            train={"mesh": {"dp": -1, "fsdp": 1, "tp": 1}})
        t0 = time.perf_counter()
        trainer = PPOTrainer(config)
        load_s = time.perf_counter() - t0
        equal = state_equal(torch, trainer.model.transformer, written)
        names = sorted(layout)
        del trainer
    ok = equal and "lm_head.bias" in names and all(
        n.startswith(("transformer.", "lm_head.")) for n in names)
    log(f"phase 3: GPT-J checkpoint in HF layout ({GPTJ_CHECK_LAYERS} blocks at full width, "
        f"{len(names)} tensors, transformer. names, Linear [out, in], lm_head.bias; written in "
        f"{write_s:.1f} s, trainer built and loaded in {load_s:.1f} s): loaded backbone equals "
        f"the written tensors bit for bit: {equal} {'ok' if ok else 'FAIL'}")
    return ok


def wide_serving_config(model_type: str, arch: dict, eos: int):
    """Phase 4's engine geometry and traffic (random weights from a seed) on
    ``model_type`` at ``arch``, ``eos`` also the pad: phases 12, 14 and
    19."""
    cfg = serving_config()
    cfg["model"].update(model_type=model_type, model_arch=dict(arch))
    cfg["method"]["gen_kwargs"].update(eos_token_id=eos, pad_token_id=eos)
    return cfg


def wide_training_config(checkpoint_dir: str, yml: str, model: dict, updates: int, eos: int):
    """``configs/<yml>`` for phases 13, 15 and 20, with the deviations each
    names: random weights (no checkpoint, no tokenizer), the mesh set to
    one device, ``updates`` updates with one eval and one checkpoint at
    the end, ``model`` updating the model section, ``eos`` also the pad."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", yml)).to_dict()
    cfg["model"].update(model_path="", tokenizer_path="", **model)
    cfg["train"].update(mesh={"dp": -1, "fsdp": 1, "tp": 1}, total_steps=updates,
                        eval_interval=updates, checkpoint_interval=updates,
                        checkpoint_dir=checkpoint_dir)
    cfg["method"]["gen_kwargs"].update(eos_token_id=eos, pad_token_id=eos)
    return TRLConfig.from_dict(cfg)


def serve_wide(torch, fa, phase: int, label: str, config: dict, depth: int, head_dim: int,
               checks=None, start_allocated_max=None, f32_leaves=("v_head.fc2.",)):
    """Phases 12, 14 and 19: ``InferenceServer`` on ``config`` (a wide
    family at full width and ``depth`` blocks, random weights from a seed)
    over the continuous engine and the paged cache, serving phase 4's 64
    prompts with 64 new tokens, 32 slots, admit/harvest 8. Gates: the card
    near empty before the build when ``start_allocated_max`` is given;
    every parameter bf16 but the value head's last layer (and any other
    name holding one of ``f32_leaves``, which must be f32); 64/64 complete
    with finite logprobs and values; the depth and head dim; ``checks``
    (``{name: fn(model config) -> bool}``); K1 ``tile`` = ``depth`` x
    prefill forwards, ``decode`` = ``depth`` x decode steps; 0 ``fma``
    launches, input copies and plain calls. Prints tokens/s, TTFT p50/p95,
    the build's peak and serving's."""
    import numpy as np

    from trlx_tpu_torch.inference.server import InferenceServer

    mem_start = reset_peak(torch)
    t0 = time.perf_counter()
    server = InferenceServer(config, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # an f32 build before its bf16 cast sets the peak there; the serving
    # path's own peak is counted_path's
    build_peak = torch.cuda.max_memory_allocated()
    dtypes = {str(p.dtype) for n, p in server.model.named_parameters()
              if not any(leaf in n for leaf in f32_leaves)}
    f32_kept = all(p.dtype == torch.float32 for n, p in server.model.named_parameters()
                   if any(leaf in n for leaf in f32_leaves))
    weights = sum(p.numel() * p.element_size() for p in server.model.parameters())
    prompts = serving_prompts()
    (rids, results, wall), record = counted_path(torch, fa, lambda: serve(torch, server, prompts))
    stats = server.stats()
    cfg = server.model_config
    expected_variants = {
        "tile": depth * int(stats["engine/prefills"]),
        "decode": depth * int(stats["engine/decode_steps"]),
        "fma": 0, "copies": 0,
    }
    lengths = [results[r]["length"] for r in rids]
    finite = all(np.isfinite(results[r]["logprobs"]).all()
                 and np.isfinite(results[r]["values"]).all() for r in rids)
    ttft = sorted(results[r]["timing"]["ttft_ms"] for r in rids)
    tokens = int(sum(lengths))
    checked = {name: bool(fn(cfg)) for name, fn in (checks or {}).items()}
    record.update({
        "model": f"{label} widths, {depth} blocks, served in bf16", "build_s": build_s,
        "parameter_dtypes": sorted(dtypes), "weight_bytes": weights,
        "requests": len(rids), "generated_tokens": tokens, "serve_wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "server_allocated_bytes": torch.cuda.memory_allocated(),
        "allocated_before_server_bytes": mem_start, "build_peak_bytes": build_peak,
        "peak_from_clean_start_bytes": max(build_peak, record["max_memory_allocated_bytes"]),
        "expected_variants": expected_variants, "checks": checked, "stats": stats,
    })
    log(f"phase {phase}: {label} serving " + json.dumps(record))
    ok = ((start_allocated_max is None or mem_start <= start_allocated_max)
          and dtypes == {"torch.bfloat16"} and f32_kept
          and len(results) == 64 and min(lengths) >= 1
          and finite and cfg.n_layer == depth and cfg.n_embd // cfg.n_head == head_dim
          and all(checked.values())
          and record["flash_fwd_variants"] == expected_variants
          and record["launches"]["flash_fwd"] == expected_variants["tile"]
          + expected_variants["decode"]
          and record["plain_attention_calls"] == 0)
    log(f"phase {phase}: {'ok' if ok else 'FAIL'} (allocated before the build {mem_start} B, "
        f"parameter dtypes {sorted(dtypes)} but {list(f32_leaves)} (f32: {f32_kept}), "
        f"{weights} B of weights; "
        f"{cfg.n_layer} blocks, head dim {cfg.n_embd // cfg.n_head}, checks {checked}; "
        f"complete={len(results)}/64, min length={min(lengths)}, finite={finite}, K1 by variant "
        f"{record['flash_fwd_variants']} vs {expected_variants}, plain attention calls="
        f"{record['plain_attention_calls']}; {record['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{record['ttft_ms_p50']:.0f} ms, p95 {record['ttft_ms_p95']:.0f} ms; the build's peak "
        f"{build_peak} B in {build_s:.1f} s, serving's {record['max_memory_allocated_bytes']} B)")
    del server
    return ok, record


def phase_gptj_serving(torch, fa):
    """Phase 12: :func:`serve_wide` on GPT-J-6B (28 blocks, 16 heads of
    256, rotary 64), built in f32 and cast to bf16 but the value head's
    last layer and the layer norms, as the trainers' rollout cast keeps
    them."""
    return serve_wide(torch, fa, 12, "GPT-J-6B",
                      wide_serving_config("gptj", GPTJ_ARCH, GPTJ_EOS), depth=28,
                      head_dim=GPTJ_D, f32_leaves=("v_head.fc2.", ".ln_"))


def gptj_prompts(seed: int = 5):
    """128 int-list prompts, real lengths drawn from 16..48."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 50256, int(rng.integers(16, 49)))]
            for _ in range(128)]


def train_wide(torch, fa, phase: int, label: str, config_fn, prompts, deviations, depth: int,
               updates: int, ref_parts, ref_parameters=None, host_copy_load=False,
               checks=None):
    """Phases 13, 15 and 20: ``trlx_tpu_torch.train`` on ``config_fn(checkpoint
    dir)`` (a wide family's PPO yml with its ``deviations``: bf16 over f32
    masters, the 2-block hydra reference, the blocks below it and the
    embeddings frozen), ``prompts``, two PPO phases. Gates: ``updates``
    updates in 2 phases; every stat finite; ``depth`` blocks, the branch at
    ``depth - 2``; ``checks`` (``{name: fn(trainer) -> bool}``); the top 2
    blocks, ``ln_f``, an untied head and the value head moved; the blocks
    below and the embeddings (``wte``, ``wpe``) bit-identical after
    training; the reference holds blocks ``depth - 2`` and up and
    ``ref_parts`` only (``ref_parameters`` parameters, when given); K1
    ``tile`` = ``depth`` x the forwards that are not decode steps (a
    reference scoring: the trunk and the 2 branch blocks), ``decode`` =
    ``depth`` x the decode steps; K2 = K3 = 2 x the updates, all ``tile``;
    no ``fma`` launch, input copy or plain call; a fresh trainer's ``load``
    restores the saved state exactly (with ``host_copy_load`` held against a
    host copy of the run's state, freed first: two such trainers do not fit
    the card together). Prints the wall with the checkpoint write timed
    apart, the collect and train seconds, rollout tokens/s, updates/s and
    the peak."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    log(f"phase {phase}: deviations: " + json.dumps([
        {"setting": k, "yml": y, "port": p, "why": why} for k, y, p, why in deviations]))
    watch, decode_forwards, scoring_tiles, save_s = {}, [0], [], []
    initial, reference = {}, {}
    orig = {n: getattr(PPOTrainer, n) for n in ("_apply", "score_ref", "save", "learn")}

    def apply(self, input_ids, *a, **kw):
        decode_forwards[0] += input_ids.shape[1] <= 16  # the sampler's steps
        return orig["_apply"](self, input_ids, *a, **kw)

    def score_ref(self, *a, **kw):
        before = fa.FLASH_FWD_TILE_LAUNCHES
        out = orig["score_ref"](self, *a, **kw)
        scoring_tiles.append(fa.FLASH_FWD_TILE_LAUNCHES - before)
        return out

    def save(self, directory=None):
        # the generator as saved (the final eval draws after it), and the
        # write's seconds
        watch["saved_rng"].append(self.generator.get_state())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["save"](self, directory)
        save_s.append(time.perf_counter() - t0)
        return out

    def learn(self):
        # before the first update: the initial parameters, on the host, and
        # the reference's contents against the full copy's
        initial.update({n: p.detach().to("cpu", copy=True)
                        for n, p in self.model.state_dict().items()})
        reference.update(
            names=sorted(self.ref.state_dict()),
            parameters=sum(p.numel() for p in self.ref.parameters()),
            full_parameters=sum(p.numel() for p in self.model.transformer.parameters()))
        return orig["learn"](self)

    with tempfile.TemporaryDirectory() as tmp:
        config = config_fn(tmp)
        # instrument's stats, evals and pushes; its learn and save are
        # replaced by the ones above
        patches = [p for p in instrument(torch, PPOTrainer, "transformer", {}, watch)
                   if p[1] not in ("learn", "save")] + [
            (PPOTrainer, "_apply", apply), (PPOTrainer, "score_ref", score_ref),
            (PPOTrainer, "save", save), (PPOTrainer, "learn", learn)]
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=prompts, config=config), patches)
        n_layer, steps = trainer.model_config.n_layer, trainer.step
        branch = trainer.branch_start
        checked = {name: bool(fn(trainer)) for name, fn in (checks or {}).items()}
        final = trainer.model.state_dict()
        moved = {n: not torch.equal(final[n].cpu(), initial[n]) for n in final}
        initial.clear()

        def block(name):
            m = re.match(r"transformer\.h\.(\d+)\.", name)
            return int(m.group(1)) if m else None

        frozen = [n for n in moved if n.startswith(("transformer.wte.", "transformer.wpe."))
                  or (block(n) is not None and block(n) < branch)]
        top = [n for n in moved if n not in frozen]
        finite = all(np.isfinite(v).all() for r in watch["rows"] for v in r.values()) and all(
            math.isfinite(v) for e in watch["evals"] for v in e.values())
        ref_blocks = sorted({int(n.split(".")[1]) for n in reference["names"]
                             if n.startswith("h.")})
        found_parts = sorted({n.split(".")[0] for n in reference["names"]})
        expected_variants = {
            "tile": n_layer * (trainer.forwards - decode_forwards[0]),
            "decode": n_layer * decode_forwards[0], "fma": 0, "copies": 0,
        }
        expected_bwd = {k: {"tile": 2 * steps, "fma": 0} for k in BWD_KERNELS}
        phases = phase_rows(trainer)
        forwards = trainer.forwards
        if host_copy_load:
            saved = trainer_state(trainer, "cpu")
            del trainer, final
            reset_peak(torch)
        else:
            # the run's gradients and rollouts freed first: two trainers
            # share the card
            trainer.opt.zero_grad()
            trainer.buffer = None
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fresh = PPOTrainer(config_fn(tmp))
        fresh.load(tmp)
        load_s = time.perf_counter() - t0
        restored = restores(torch, saved if host_copy_load else trainer_state(trainer), fresh,
                            watch["saved_rng"])
        del fresh
    record.update({
        "model": f"{label} widths, {n_layer} blocks, bf16 over f32 masters",
        "updates": steps, "phases": phases, "evals": watch["evals"],
        "checkpoint_write_s": save_s, "wall_without_checkpoint_s":
            record["wall_s"] - sum(save_s), "checkpoint_load_s": load_s,
        "reference": {"blocks": ref_blocks, "parts": found_parts,
                      "parameters": reference["parameters"],
                      "full_copy_parameters": reference["full_parameters"]},
        "k1_tile_per_reference_scoring": scoring_tiles,
        "forwards": forwards, "decode_forwards": decode_forwards[0],
        "expected_variants": expected_variants, "expected_backward_variants": expected_bwd,
        "frozen_tensors": len(frozen), "frozen_bit_identical": not any(moved[n] for n in frozen),
        "top_tensors": len(top), "top_moved": all(moved[n] for n in top),
        "finite": finite, "load_restores": restored, "checks": checked,
    })
    log(f"phase {phase}: {label} PPO " + json.dumps(record))
    ok = (
        steps == updates and len(watch["rows"]) == 2 and finite
        and n_layer == depth and branch == depth - 2 and all(checked.values())
        and ref_blocks == [depth - 2, depth - 1] and found_parts == sorted(ref_parts)
        and (ref_parameters is None or reference["parameters"] == ref_parameters)
        and record["frozen_bit_identical"] and record["top_moved"]
        and all(n == n_layer for n in scoring_tiles) and len(scoring_tiles) == 2
        and record["flash_fwd_variants"] == expected_variants
        and record["backward_variants"] == expected_bwd and record["backward_copies"] == 0
        and record["plain_attention_calls"] == 0 and restored
    )
    log(f"phase {phase}: {'ok' if ok else 'FAIL'} (updates={steps}, phases="
        f"{len(watch['rows'])}, finite={finite}; checks {checked}; reference blocks {ref_blocks} "
        f"and {found_parts}, {reference['parameters']} parameters against the full copy's "
        f"{reference['full_parameters']}; frozen {len(frozen)} tensors bit-identical: "
        f"{record['frozen_bit_identical']}, top {len(top)} tensors moved: {record['top_moved']}; "
        f"K1 tile per reference scoring {scoring_tiles}; K1 by variant "
        f"{record['flash_fwd_variants']} vs {expected_variants}; K2/K3 by variant "
        f"{record['backward_variants']} vs {expected_bwd}; backward copies "
        f"{record['backward_copies']}; plain attention calls {record['plain_attention_calls']}; "
        f"load restores {restored}; wall {record['wall_s']:.1f} s of which checkpoint write "
        f"{sum(save_s):.1f} s; peak {record['max_memory_allocated_bytes']} B)")
    return ok, record


def phase_gptj_training(torch, fa):
    """Phase 13: :func:`train_wide` on ``configs/ppo_gptj.yml`` with
    ``GPTJ_DEVIATIONS`` (GPT-J-6B widths cut to ``GPTJ_TRAIN_LAYERS`` = 8
    blocks, the bottom 6 and ``wte`` frozen), 128 int-list prompts of
    16..48 tokens; the reference holds blocks 6-7, ``wte``, ``ln_f`` and
    ``lm_head``."""
    config_fn = functools.partial(
        wide_training_config, yml="ppo_gptj.yml",
        model={"model_arch": dict(GPTJ_ARCH, n_layer=GPTJ_TRAIN_LAYERS)},
        updates=GPTJ_UPDATES, eos=GPTJ_EOS)
    return train_wide(torch, fa, 13, "GPT-J-6B", config_fn, gptj_prompts(),
                      GPTJ_DEVIATIONS, depth=GPTJ_TRAIN_LAYERS, updates=GPTJ_UPDATES,
                      ref_parts=("h", "lm_head", "ln_f", "wte"))


# ---------------------------------------------------------------------------
# GPT-NeoX-20B (configs/ppo_neox20b.yml): the head-dim-96 instantiations, the
# model, serving (phase 14) and PPO (phase 15)
# ---------------------------------------------------------------------------

NEOX_ARCH = {  # EleutherAI/gpt-neox-20b's config.json (configs/ppo_neox20b.yml's model)
    "vocab_size": 50432, "max_position_embeddings": 2048, "hidden_size": 6144,
    "num_hidden_layers": 44, "num_attention_heads": 64, "rotary_pct": 0.25,
    "rotary_emb_base": 10000, "use_parallel_residual": True, "layer_norm_eps": 1e-5,
}
NEOX_HF_CONFIG = {  # as its HF config.json names it
    "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"], **NEOX_ARCH,
    "intermediate_size": 24576, "hidden_act": "gelu", "tie_word_embeddings": False,
    "bos_token_id": 0, "eos_token_id": 0,
}
NEOX_HEADS, NEOX_D = 64, 96
NEOX_EOS = 0  # the 20B tokenizer's <|endoftext|>, also its pad
NEOX_CHECK_LAYERS = 2  # phase 3's cut depth and the HF checkpoint's (full width)
NEOX_TRAIN_LAYERS = 4  # phase 15's cut depth (44 blocks of f32 masters are 79.7 GB)
NEOX_UPDATES = 16  # two PPO phases: 64 rollouts / batch 32 x 4 epochs each
#: the hydra reference of phase 15: blocks 4-5, wte, ln_f and lm_head
NEOX_REFERENCE_PARAMETERS = 1_525_850_112
# what phase 15 runs differently from configs/ppo_neox20b.yml: (setting,
# the yml's value, the port's, why)
NEOX_DEVIATIONS = (
    ("train.mesh", {"dp": -1, "fsdp": 8, "tp": 4}, {"dp": -1, "fsdp": 1, "tp": 1},
     "one card: fsdp 8 x tp 4 needs 32 ranks (phase 27 runs the mesh path with two ranks "
     "that share the card; more cards are ROADMAP item 14)"),
    ("model.model_arch.num_hidden_layers", 44, NEOX_TRAIN_LAYERS, "one card: f32 masters of "
     "44 blocks alone are 79.7 GB (12 blocks at full width are 24.2 GB, 6 are 13.4 GB); and "
     "the smoke's time limit: phase 14 serves all 44 blocks, so the 44-block memory case is "
     "held by serving alone; every width, head count and head dim stays the 20B's"),
    ("model.model_path", "EleutherAI/gpt-neox-20b", "", "the checkpoint is not in the repo: "
     "random weights from train.seed at its widths"),
    ("model.tokenizer_path", "EleutherAI/gpt-neox-20b", "", "no tokenizer in the repo: "
     "int-list prompts and a host reward on the ids"),
    ("train.total_steps", 6000, NEOX_UPDATES, "the smoke's time limit: two PPO phases"),
    ("train.eval_interval", 100, NEOX_UPDATES, "one eval, at the end"),
    ("train.checkpoint_interval", 10000, NEOX_UPDATES, "one checkpoint, at the end"),
)
# K1 at NeoX's path shapes, timed in bf16 (neox_kernel_cases names)
NEOX_TIMED = ("neox_rollout_prefill", "neox_rollout_decode", "neox_update",
              "neox_ref_scoring", "neox_serving_prefill", "neox_serving_decode")
# the per-layer buffers older GPT-NeoX checkpoints carry (not weights)
NEOX_OLD_BUFFERS = ("attention.bias", "attention.masked_bias", "attention.rotary_emb.inv_freq")


def neox_kernel_cases(torch, attn):
    """:func:`wide_kernel_cases` at GPT-NeoX-20B's D = 96, H = 64
    (configs/ppo_neox20b.yml: 64 rollouts, batch 32)."""
    return wide_kernel_cases(torch, attn, "neox", NEOX_D, NEOX_HEADS, rollout_batch=64,
                             update_batch=32, seed=50)


def phase_neox_kernels(torch, fa, attn):
    """Phase 2 at D = 96 (:func:`hold_and_time` over
    :func:`neox_kernel_cases`): K1, K2 (with and without dbias) and K3 in
    bf16 and f32, O held relative to P|V| + |O| with the planted faults
    aimed at the padded atom's real columns 64..95; timed in bf16, K1 at
    ``NEOX_TIMED``, K2 and K3 at the update and K2 with dbias at its
    case."""
    return hold_and_time(torch, fa, attn, neox_kernel_cases(torch, attn),
                         fwd_timed=NEOX_TIMED, bwd_timed=("neox_update", "neox_dbias"),
                         relative_o=True)


def neox_model(torch, n_layer: int, dtype: str, seed: int):
    """A GPT-NeoX-20B-wide policy (value head included) of ``n_layer`` blocks
    on the card, random weights from ``seed``."""
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel

    cfg = NeoXConfig(**dict(NEOX_ARCH, num_hidden_layers=n_layer), dtype=dtype)
    model = CausalLMWithValueHead(cfg, NeoXModel, device="cuda")
    init_params(model, seed)
    return cfg, model


def phase_neox_model(torch, fa):
    """Phase 3 at D = 96: :func:`wide_model_checks` on a full-width f32
    GPT-NeoX of ``NEOX_CHECK_LAYERS`` blocks (64 heads of 96, rotary on 24,
    parallel residual), the gradient at the yml's B = 32."""
    from trlx_tpu_torch.models import neox

    cfg, model = neox_model(torch, NEOX_CHECK_LAYERS, "float32", 50)
    return wide_model_checks(torch, fa, neox, cfg, model, "GPT-NeoX", NEOX_D, full_depth=44,
                             grad_batch=32, seed=51)


# the port's NeoXModel names -> HF GPTNeoXForCausalLM's (no transposes: both
# store [out, in]; the fused query_key_value keeps its head-major layout)
NEOX_HF_NAMES = (
    (r"^h\.(\d+)\.ln_1\.", r"gpt_neox.layers.\1.input_layernorm."),
    (r"^h\.(\d+)\.ln_2\.", r"gpt_neox.layers.\1.post_attention_layernorm."),
    (r"^h\.(\d+)\.attn\.", r"gpt_neox.layers.\1.attention."),
    (r"^h\.(\d+)\.mlp\.", r"gpt_neox.layers.\1.mlp."),
    (r"^wte\.", "gpt_neox.embed_in."),
    (r"^ln_f\.", "gpt_neox.final_layer_norm."),
    (r"^lm_head\.", "embed_out."),
)


def neox_hf_layout(torch, state: dict, n_layer: int) -> dict:
    """The port's ``NeoXModel`` state dict in HF ``GPTNeoXForCausalLM``'s
    layout, with the three per-layer buffers of older checkpoints (the
    causal mask ``attention.bias``, ``attention.masked_bias`` and the
    rotary table ``attention.rotary_emb.inv_freq``), which are not weights."""
    out = {}
    for name, t in state.items():
        hf = name
        for pattern, repl in NEOX_HF_NAMES:
            hf = re.sub(pattern, repl, hf)
        out[hf] = t
    positions, rd = NEOX_ARCH["max_position_embeddings"], int(NEOX_D * NEOX_ARCH["rotary_pct"])
    for i in range(n_layer):
        pre = f"gpt_neox.layers.{i}."
        out[pre + "attention.bias"] = torch.tril(
            torch.ones(positions, positions, dtype=torch.bool))[None, None]
        out[pre + "attention.masked_bias"] = torch.tensor(-1e9)
        out[pre + "attention.rotary_emb.inv_freq"] = 1.0 / 10000 ** (
            torch.arange(0, rd, 2, dtype=torch.float32) / rd)
    return out


def phase_neox_checkpoint(torch):
    """A GPT-NeoX checkpoint in HF layout at full width and
    ``NEOX_CHECK_LAYERS`` blocks (random weights from a seed, ``config.json``
    + ``model.safetensors``: ``gpt_neox.`` names, the fused
    ``query_key_value`` [3 H Dh, E], ``embed_out.weight`` and the three
    buffers of older checkpoints), loaded through ``model.model_path`` by
    the PPO trainer on ``configs/ppo_neox20b.yml`` (its mesh set to one
    device): the loaded backbone must equal the written tensors bit for
    bit."""
    import tempfile

    from trlx_tpu_torch.models.neox import NeoXConfig, NeoXModel
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    hf_config = dict(NEOX_HF_CONFIG, num_hidden_layers=NEOX_CHECK_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "neox")
        t0 = time.perf_counter()
        written = random_backbone(
            torch, NeoXModel(NeoXConfig.from_dict(hf_config), device="cuda"), seed=52)
        layout = neox_hf_layout(torch, written, NEOX_CHECK_LAYERS)
        write_hf_checkpoint(ckpt, hf_config, layout)
        write_s = time.perf_counter() - t0
        config = yml_config("ppo_neox20b.yml", os.path.join(tmp, "run"), ckpt, NEOX_UPDATES,
                            train={"mesh": {"dp": -1, "fsdp": 1, "tp": 1}})
        t0 = time.perf_counter()
        trainer = PPOTrainer(config)
        load_s = time.perf_counter() - t0
        equal = state_equal(torch, trainer.model.transformer, written)
        names = sorted(layout)
        qkv = tuple(layout["gpt_neox.layers.0.attention.query_key_value.weight"].shape)
        del trainer
    buffers = [n for n in names if n.endswith(NEOX_OLD_BUFFERS)]
    ok = (equal and "embed_out.weight" in names and len(buffers) == 3 * NEOX_CHECK_LAYERS
          and qkv == (3 * NEOX_ARCH["hidden_size"], NEOX_ARCH["hidden_size"])
          and all(n.startswith(("gpt_neox.", "embed_out.")) for n in names))
    log(f"phase 3: GPT-NeoX checkpoint in HF layout ({NEOX_CHECK_LAYERS} blocks at full width, "
        f"{len(names)} tensors, gpt_neox. names, query_key_value {list(qkv)}, embed_out, "
        f"{len(buffers)} buffers of older checkpoints; written in {write_s:.1f} s, trainer built "
        f"and loaded in {load_s:.1f} s): loaded backbone equals the written tensors bit for "
        f"bit: {equal} {'ok' if ok else 'FAIL'}")
    return ok


#: what the earlier phases may leave allocated on the card before phase
#: 14's 61 GB build (the cached libraries' buffers, no model)
NEOX_START_ALLOCATED_MAX = 1 << 30


def phase_neox_serving(torch, fa):
    """Phase 14: :func:`serve_wide` on GPT-NeoX-20B (44 blocks, 64 heads
    of 96, rotary on 24, parallel residual), built in bf16 on the card
    directly (``dtype`` and ``param_dtype``), the card near empty before
    the build (``NEOX_START_ALLOCATED_MAX``)."""
    return serve_wide(torch, fa, 14, "GPT-NeoX-20B", wide_serving_config(
        "gpt_neox", dict(NEOX_ARCH, dtype="bfloat16", param_dtype="bfloat16"), NEOX_EOS),
                      depth=44,
                      head_dim=NEOX_D, checks={"rotary_dim_24": lambda c: c.rotary_dim == 24},
                      start_allocated_max=NEOX_START_ALLOCATED_MAX)


def neox_prompts(seed: int = 6):
    """128 int-list prompts, real lengths drawn from 16..48 (ids past the
    20B tokenizer's <|endoftext|>, 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 50277, int(rng.integers(16, 49)))]
            for _ in range(128)]


def phase_neox_training(torch, fa):
    """Phase 15: :func:`train_wide` on ``configs/ppo_neox20b.yml`` with
    ``NEOX_DEVIATIONS`` (GPT-NeoX-20B widths cut to 4 blocks, the bottom
    2 and ``wte`` frozen), 128 int-list prompts of 16..48 tokens; the
    reference holds blocks 2-3, ``wte``, ``ln_f`` and ``lm_head``
    (``NEOX_REFERENCE_PARAMETERS``); ``load`` held against a host copy."""
    config_fn = functools.partial(
        wide_training_config, yml="ppo_neox20b.yml",
        model={"model_arch": dict(NEOX_ARCH, num_hidden_layers=NEOX_TRAIN_LAYERS)},
        updates=NEOX_UPDATES, eos=NEOX_EOS)
    return train_wide(torch, fa, 15, "GPT-NeoX-20B", config_fn, neox_prompts(),
                      NEOX_DEVIATIONS, depth=NEOX_TRAIN_LAYERS, updates=NEOX_UPDATES,
                      ref_parts=("h", "lm_head", "ln_f", "wte"),
                      ref_parameters=NEOX_REFERENCE_PARAMETERS, host_copy_load=True)


# ---------------------------------------------------------------------------
# GPT-Neo 1.3B: the head-dim-128 instantiations, the model, serving (phase
# 19) and PPO (phase 20) on configs/ppo_gptj.yml's geometry
# ---------------------------------------------------------------------------

NEO_ARCH = {  # EleutherAI/gpt-neo-1.3B's config.json
    "vocab_size": 50257, "max_position_embeddings": 2048, "hidden_size": 2048,
    "num_layers": 24, "num_heads": 16, "window_size": 256,
    "attention_types": [[["global", "local"], 12]], "layer_norm_epsilon": 1e-5,
}
NEO_HF_CONFIG = {  # as its HF config.json names it
    "model_type": "gpt_neo", "architectures": ["GPTNeoForCausalLM"], **NEO_ARCH,
    "intermediate_size": None, "activation_function": "gelu_new", "embed_dropout": 0.0,
    "resid_dropout": 0.0, "attention_dropout": 0.0, "tie_word_embeddings": True,
    "bos_token_id": 50256, "eos_token_id": 50256,
}
NEO_HEADS, NEO_D, NEO_EOS, NEO_WINDOW = 16, 128, 50256, 256
NEO_LAYERS = ("global", "local") * 12
NEO_CHECK_LAYERS = 4  # phase 3's cut depth (global, local, global, local) and the checkpoint's
NEO_UPDATES = 128  # two PPO phases: 128 rollouts / batch 8 x 4 epochs each
# what phase 20 runs differently from configs/ppo_gptj.yml: (setting, the
# yml's value, the port's, why)
NEO_DEVIATIONS = (
    ("model.model_type", "gptj", "gpt_neo", "this slice's family: GPT-Neo 1.3B on upstream "
     "trlX's PPO config for the large causal families"),
    ("model.model_arch", "EleutherAI/gpt-j-6B's", "EleutherAI/gpt-neo-1.3B's",
     "GPT-Neo 1.3B at full width and depth: 24 blocks of 16 heads of 128, global and local "
     "(window 256) in turn"),
    ("train.mesh", {"dp": -1, "fsdp": 1, "tp": 4}, {"dp": -1, "fsdp": 1, "tp": 1},
     "gpt_neo under tp is refused (its local band under tensor parallelism: ROADMAP item "
     "14), and one card holds one rank"),
    ("model.model_path", "EleutherAI/gpt-j-6B", "", "no checkpoint in the repo: random "
     "weights from train.seed at GPT-Neo 1.3B's widths"),
    ("model.tokenizer_path", "gpt2", "", "no tokenizer in the repo: int-list prompts and a "
     "host reward on the ids"),
    ("train.total_steps", 10000, NEO_UPDATES, "the smoke's time limit: two PPO phases"),
    ("train.eval_interval", 100, NEO_UPDATES, "one eval, at the end"),
    ("train.checkpoint_interval", 10000, NEO_UPDATES, "one checkpoint, at the end"),
)
# K1 at GPT-Neo's path shapes, timed in bf16 (neo_kernel_cases names)
NEO_TIMED = ("neo_rollout_prefill", "neo_rollout_decode", "neo_update", "neo_update_local",
             "neo_ref_scoring", "neo_serving_prefill", "neo_serving_prefill_local",
             "neo_serving_decode", "neo_serving_decode_local", "neo_long_band")
# the per-layer buffers older GPT-Neo checkpoints carry (not weights)
NEO_OLD_BUFFERS = ("attn.attention.bias", "attn.attention.masked_bias")


def neo_kernel_cases(torch, attn):
    """:func:`wide_kernel_cases` at GPT-Neo 1.3B's D = 128, H = 16
    (configs/ppo_gptj.yml: 128 rollouts, batch 8): the global layers'
    attention (the causal flag, or the causal bias with a cache), and the
    local layers' where it differs, an explicit band of ``NEO_WINDOW`` keys
    (:func:`~trlx_tpu_torch.models.gpt_neo.local_causal_bias`) plus the
    padding bias with the causal flag off: the update (B = 8, T = 96, K2
    and K3 too), phase 19's admission prefill (B = 8, Q = 512 over 576
    keys, left-padded prompts of 16..512) and decode step (B = 32, per-row
    depths), and a long band (phase 3's B = 2, T = 512, K2 and K3 too),
    where the last query tile's first three key tiles lie wholly before
    the band."""
    from trlx_tpu_torch.models.gpt_neo import local_causal_bias

    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)

    def qkv(B, Q, K):
        return [torch.randn(B, T, NEO_HEADS, NEO_D, generator=gen, device=dev)
                for T in (Q, K, K)]

    def pad(B, K):  # padding with the first keys valid
        keep = torch.arange(K, device=dev)[None] < 4
        return attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > 0.2)
                                  | keep).long())

    cases = wide_kernel_cases(torch, attn, "neo", NEO_D, NEO_HEADS, rollout_batch=128,
                              update_batch=8, seed=60)
    band = local_causal_bias(96, 96, NEO_WINDOW, 0, dev)
    cases.append(("neo_update_local", *qkv(8, 96, 96), band + pad(8, 96), False, "backward"))
    lens = torch.randint(16, 513, (8, 1), generator=gen, device=dev)
    cols = torch.arange(576, device=dev)[None]
    bias = local_causal_bias(512, 576, NEO_WINDOW, 0, dev) + attn.padding_bias(
        ((cols >= 512 - lens) & (cols < 512)).long())
    cases.append(("neo_serving_prefill_local", *qkv(8, 512, 576), bias, False, "forward"))
    depth = torch.randint(16, 576, (32,), generator=gen, device=dev)
    bias = local_causal_bias(1, 576, NEO_WINDOW, depth) + attn.padding_bias(
        (cols <= depth[:, None]).long())
    cases.append(("neo_serving_decode_local", *qkv(32, 1, 576), bias, False, "forward"))
    band = local_causal_bias(512, 512, NEO_WINDOW, 0, dev)
    cases.append(("neo_long_band", *qkv(2, 512, 512), band + pad(2, 512), False, "backward"))
    return cases


def phase_neo_kernels(torch, fa, attn):
    """Phase 2 at D = 128 (:func:`hold_and_time` over
    :func:`neo_kernel_cases`): K1, K2 (with and without dbias) and K3 in
    bf16 and f32, O held relative to P|V| + |O| with the planted faults
    aimed at the second atom, columns 64..127; timed in bf16, K1 at
    ``NEO_TIMED``, K2 and K3 at the update under each layer type's mask
    and at the long band, K2 with dbias at its case."""
    return hold_and_time(torch, fa, attn, neo_kernel_cases(torch, attn), fwd_timed=NEO_TIMED,
                         bwd_timed=("neo_update", "neo_update_local", "neo_long_band",
                                    "neo_dbias"),
                         relative_o=True)


def phase_neo_model(torch, fa):
    """Phase 3 at D = 128: :func:`wide_model_checks` on a full-width f32
    GPT-Neo 1.3B of ``NEO_CHECK_LAYERS`` blocks (global, local, global,
    local) at B = 2, T = 512, where the band truncates on every path: the
    forward, the paged prefill and decode steps, and the PPO-loss gradient
    over 256 + 256 columns."""
    from trlx_tpu_torch.models import gpt_neo
    from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params

    cfg = GPTNeoConfig.from_dict(dict(NEO_ARCH, num_layers=NEO_CHECK_LAYERS, dtype="float32",
                                      attention_types=[[["global", "local"], 2]]))
    model = CausalLMWithValueHead(cfg, GPTNeoModel, device="cuda")
    init_params(model, 62)
    return wide_model_checks(torch, fa, gpt_neo, cfg, model, "GPT-Neo 1.3B", NEO_D,
                             full_depth=24, grad_batch=2, seed=63, seq=512,
                             grad_split=(256, 256))


def neo_hf_layout(torch, state: dict, n_layer: int) -> dict:
    """The port's ``GPTNeoModel`` state dict in HF ``GPTNeoForCausalLM``'s
    layout: ``transformer.`` names, the attention's projections under
    ``attn.attention.``, the tied head's copy ``lm_head.weight``, and the
    two per-layer buffers of older checkpoints (the causal mask
    ``attn.attention.bias`` and ``attn.attention.masked_bias``), which are
    not weights; Linear weights stay [out, in]."""
    out = {"transformer." + re.sub(r"\.attn\.", ".attn.attention.", n): t
           for n, t in state.items()}
    out["lm_head.weight"] = state["wte.weight"]
    positions = NEO_ARCH["max_position_embeddings"]
    for i in range(n_layer):
        pre = f"transformer.h.{i}.attn.attention."
        out[pre + "bias"] = torch.tril(
            torch.ones(positions, positions, dtype=torch.bool))[None, None]
        out[pre + "masked_bias"] = torch.tensor(-1e9)
    return out


def phase_neo_checkpoint(torch):
    """A GPT-Neo checkpoint in HF layout at full width and
    ``NEO_CHECK_LAYERS`` blocks (random weights from a seed, ``config.json``
    + ``model.safetensors``: ``transformer.`` names, ``attn.attention.*``,
    the tied ``lm_head.weight`` and the two buffers of older checkpoints),
    loaded through ``model.model_path`` by the PPO trainer on phase 20's
    config: the loaded backbone must equal the written tensors bit for
    bit."""
    import tempfile

    from trlx_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    types = [[["global", "local"], NEO_CHECK_LAYERS // 2]]
    hf_config = dict(NEO_HF_CONFIG, num_layers=NEO_CHECK_LAYERS, attention_types=types)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt_neo")
        t0 = time.perf_counter()
        written = random_backbone(
            torch, GPTNeoModel(GPTNeoConfig.from_dict(hf_config), device="cuda"), seed=64)
        layout = neo_hf_layout(torch, written, NEO_CHECK_LAYERS)
        write_hf_checkpoint(ckpt, hf_config, layout)
        write_s = time.perf_counter() - t0
        config = yml_config("ppo_gptj.yml", os.path.join(tmp, "run"), ckpt, NEO_UPDATES,
                            train={"mesh": {"dp": -1, "fsdp": 1, "tp": 1}},
                            model={"model_type": "gpt_neo"})
        t0 = time.perf_counter()
        trainer = PPOTrainer(config)
        load_s = time.perf_counter() - t0
        equal = state_equal(torch, trainer.model.transformer, written)
        types_loaded = trainer.model_config.layer_types
        names = sorted(layout)
        del trainer
    buffers = [n for n in names if n.endswith(NEO_OLD_BUFFERS)]
    ok = (equal and "lm_head.weight" in names and len(buffers) == 2 * NEO_CHECK_LAYERS
          and types_loaded == NEO_LAYERS[:NEO_CHECK_LAYERS]
          and "transformer.h.0.attn.attention.q_proj.weight" in names
          and all(n.startswith(("transformer.", "lm_head.")) for n in names))
    log(f"phase 3: GPT-Neo checkpoint in HF layout ({NEO_CHECK_LAYERS} blocks at full width, "
        f"{len(names)} tensors, transformer. names, attn.attention.*, the tied lm_head.weight, "
        f"{len(buffers)} buffers of older checkpoints; written in {write_s:.1f} s, trainer "
        f"built and loaded in {load_s:.1f} s; layer types {list(types_loaded)}): loaded backbone "
        f"equals the written tensors bit for bit: {equal} {'ok' if ok else 'FAIL'}")
    return ok


def phase_neo_serving(torch, fa):
    """Phase 19: :func:`serve_wide` on GPT-Neo 1.3B (24 blocks, global and
    local in turn, 16 heads of 128, window 256), built in bf16 on the card
    directly."""
    return serve_wide(torch, fa, 19, "GPT-Neo 1.3B", wide_serving_config(
        "gpt_neo", dict(NEO_ARCH, dtype="bfloat16", param_dtype="bfloat16"), NEO_EOS),
                      depth=24,
                      head_dim=NEO_D,
                      checks={"layer_types": lambda c: c.layer_types == NEO_LAYERS,
                              "window_256": lambda c: c.window_size == NEO_WINDOW})


def phase_neo_training(torch, fa):
    """Phase 20: :func:`train_wide` on ``configs/ppo_gptj.yml`` with
    ``NEO_DEVIATIONS`` (GPT-Neo 1.3B at full width and depth on upstream
    trlX's PPO geometry for the large causal families, the bottom 22
    blocks, ``wte`` and ``wpe`` frozen), 128 int-list prompts of 16..48 tokens; the reference holds
    blocks 22-23 (a global and a local block), ``wte`` (the tied head) and
    ``ln_f``."""
    config_fn = functools.partial(
        wide_training_config, yml="ppo_gptj.yml",
        model={"model_type": "gpt_neo", "model_arch": dict(NEO_ARCH)},
        updates=NEO_UPDATES, eos=NEO_EOS)
    return train_wide(torch, fa, 20, "GPT-Neo 1.3B", config_fn, gptj_prompts(7),
                      NEO_DEVIATIONS, depth=24, updates=NEO_UPDATES,
                      ref_parts=("h", "ln_f", "wte"),
                      checks={"branch_global_local": lambda t: t.model_config.layer_types[
                          t.branch_start:] == ("global", "local")})


# ---------------------------------------------------------------------------
# The small head dims 16, 24 and 32: the randomwalks configs (phases 16 and
# 17, D = 24), the pretrained stand-ins and the learning guard (phase 18,
# D = 32 and 16)
# ---------------------------------------------------------------------------

SMALL_HEAD_DIMS = (16, 24, 32)


def randomwalks_task(n_nodes: int = 21, walk_length: int = 9, seed: int = 1002):
    """The port's ``trlx_tpu_torch/examples/randomwalks.py::make_task``:
    ``(reward_fn, metric_fn, prompts, logit_mask, info)``. Node i is token
    i, ``n_nodes`` eos, ``n_nodes + 1`` pad; a prompt is one start node;
    the reward is the walk's optimality (shortest length over taken length,
    0 for an invalid edge or a walk that never reaches the goal)."""
    from trlx_tpu_torch.examples.randomwalks import make_task

    return make_task(n_nodes, walk_length, seed)


def randomwalks_dataset(info, n_walks: int = 1000, seed: int = 0):
    """``examples/ilql_randomwalks.py::make_dataset``: random-policy walks
    as ``(tokens, action_start)`` samples with their optimality rewards."""
    import numpy as np

    adj, dists, goal = info["adj"], info["dists"], info["goal"]
    rng = np.random.default_rng(seed)
    samples, rewards = [], []
    for _ in range(n_walks):
        start = int(rng.integers(1, info["n_nodes"]))
        node, walk = start, [start]
        for _ in range(info["walk_length"]):
            node = int(rng.choice(np.nonzero(adj[node])[0]))
            walk.append(node)
            if node == goal:
                break
        samples.append((walk, 1))
        rewards.append(float(dists[start] / (len(walk) - 1)) if walk[-1] == goal else 0.0)
    return samples, rewards


# examples/pretrained_standin.py's token layout (copied: the smoke imports
# nothing of examples/), shared by both stand-ins
STANDIN_VOCAB = 64
STANDIN_POS = list(range(2, 30))
STANDIN_NEG = list(range(32, 60))
STANDIN_EOS = 61
STANDIN_PAD = 63
# the stand-ins' architectures (examples/pretrained_standin.py:90-94,
# :122-127); the card's machine has no transformers to pretrain them, so
# phase 18 writes HF-layout checkpoints of these widths with random weights
STANDIN_GPT2_HF_CONFIG = {
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], "vocab_size": STANDIN_VOCAB,
    "n_positions": 64, "n_embd": 128, "n_layer": 2, "n_head": 4, "layer_norm_epsilon": 1e-5,
    "activation_function": "gelu_new", "bos_token_id": STANDIN_EOS,
    "eos_token_id": STANDIN_EOS,
}
STANDIN_T5_HF_CONFIG = {
    "model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
    "vocab_size": STANDIN_VOCAB, "d_model": 64, "d_kv": 16, "d_ff": 256, "num_layers": 2,
    "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
    "relative_attention_max_distance": 20, "feed_forward_proj": "relu",
    "tie_word_embeddings": True, "layer_norm_epsilon": 1e-6, "decoder_start_token_id": 0,
    "eos_token_id": 1, "pad_token_id": 0,
}


def standin_prompts(rng, n: int, length: int) -> list:
    """``examples/pretrained_standin.py::make_prompts``: half positive-topic,
    half negative-topic prompts, shuffled."""
    import numpy as np

    pos = rng.choice(STANDIN_POS, size=(n // 2, length))
    neg = rng.choice(STANDIN_NEG, size=(n - n // 2, length))
    docs = np.concatenate([pos, neg]).astype(np.int64)
    rng.shuffle(docs)
    return [list(map(int, row)) for row in docs]


def standin_reward(samples, queries, response_gt=None):
    """``examples/pretrained_standin.py::sentiment_reward``: the mean over
    response tokens of +1 (positive set), -1 (negative set), 0 (other)."""
    pos, neg = set(STANDIN_POS), set(STANDIN_NEG)
    scores = []
    for s in samples:
        toks = [int(t) for t in s.split() if t.lstrip("-").isdigit()]
        scores.append(sum((t in pos) - (t in neg) for t in toks) / len(toks) if toks else 0.0)
    return scores


def standin_rl_config(model_path: str, family: str, **train_overrides) -> dict:
    """``examples/pretrained_standin.py::_rl_config``: the stand-ins' PPO
    config (96 updates of batch 16, 64 rollouts, 2 epochs, 8 prompt + 12
    new tokens, f32)."""
    causal = family == "gpt2"
    gen_ids = ({"eos_token_id": STANDIN_EOS, "pad_token_id": STANDIN_PAD} if causal
               else {"eos_token_id": 1, "pad_token_id": 0, "decoder_start_token_id": 0})
    return {
        "model": {"model_type": family, "model_path": model_path},
        "train": {
            "seq_length": 8, "batch_size": 16, "epochs": 12, "total_steps": 96,
            "eval_interval": 100000, "checkpoint_interval": 1000000, "lr_init": 1.0e-3,
            "lr_target": 1.0e-3, "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
            "seed": 3, **({} if causal else {"trainer": "Seq2SeqPPOTrainer"}),
            **train_overrides,
        },
        "method": {
            "name": "PPOConfig", "num_rollouts": 64, "chunk_size": 64, "ppo_epochs": 2,
            "init_kl_coef": 0.005, "scale_reward": None,
            "gen_kwargs": {"max_new_tokens": 12, "min_new_tokens": 12, "top_k": 0,
                           "do_sample": True, **gen_ids},
        },
    }


def target_token_config(checkpoint_dir: str) -> dict:
    """``tests/test_torch_learning.py::_target_config`` (the learning
    guard): a from-scratch GPT-2 of 32 wide, 2 heads of 16; reward the share
    of 6 response tokens equal to 5."""
    return {
        "model": {"model_type": "gpt2", "model_arch": {
            "vocab_size": 16, "n_positions": 16, "n_embd": 32, "n_layer": 2, "n_head": 2}},
        "train": {"seq_length": 4, "batch_size": 16, "epochs": 12, "total_steps": 96,
                  "eval_interval": 1000, "checkpoint_interval": 100000,
                  "lr_init": 1.0e-3, "lr_target": 1.0e-3, "dtype": "float32", "seed": 7,
                  "checkpoint_dir": checkpoint_dir},
        "method": {"name": "PPOConfig", "num_rollouts": 64, "chunk_size": 64, "ppo_epochs": 2,
                   "init_kl_coef": 0.001, "scale_reward": None,
                   "gen_kwargs": {"max_new_tokens": 6, "min_new_tokens": 6, "top_k": 0,
                                  "do_sample": True, "eos_token_id": 14, "pad_token_id": 15}},
    }


def target_token_reward(samples, queries, response_gt=None):
    return [sum(tok == "5" for tok in s.split()) / 6 for s in samples]


def small_kernel_cases(torch, attn, D: int, seed: int):
    """(name, q, k, v, bias, causal, kind) at head dim ``D`` in f32 from a
    fixed seed, as :func:`wide_kernel_cases` gives them: the shapes of the
    paths that run D (phases 16-18), left padding whose first causal rows
    see only padding, and :func:`edge_kernel_cases`. Names start with
    ``d<D>_``."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = f"d{D}"

    def qkv(B, Q, K, H):
        return [torch.randn(B, T, H, D, generator=gen, device=dev) for T in (Q, K, K)]

    def pad(B, K, p_pad=0.2):  # padding with the first keys valid
        keep = torch.arange(K, device=dev)[None] < 4
        return attn.padding_bias(((torch.rand(B, K, generator=gen, device=dev) > p_pad)
                                  | keep).long())

    def left(B, Q, K, lo, hi, width=None):
        lens = torch.randint(lo, hi + 1, (B, 1), generator=gen, device=dev)
        cols = torch.arange(K, device=dev)[None]
        return (cols >= Q - lens) & (cols < (Q if width is None else width))

    def decode_step(B, K):  # one query at per-row depths over a K-wide cache
        depth = torch.randint(0, K, (B,), generator=gen, device=dev)
        mask = (torch.arange(K, device=dev)[None] <= depth[:, None]).long()
        return attn.causal_bias(1, K, depth, dev) + attn.padding_bias(mask)

    cases = []
    if D == 24:
        # configs/ppo_randomwalks.yml (6 heads of 24, 128 rollouts, batch
        # 64): the sampler's prefill of the 10 left-padded prompt columns
        # (one real) over the 19-wide cache and a decode step, the update
        # and the reference scoring over 10 + 9 columns (causal, the prompt
        # padded on the left and the walk on the right)
        bias = attn.causal_bias(10, 19, 0, dev) + attn.padding_bias(
            left(128, 10, 19, 1, 1).long())
        cases.append((f"{p}_rw_rollout_prefill", *qkv(128, 10, 19, 6), bias, False, "forward"))
        cases.append((f"{p}_rw_rollout_decode", *qkv(128, 1, 19, 6), decode_step(128, 19), False,
                      "forward"))
        cols = torch.arange(19, device=dev)[None]
        ends = torch.randint(11, 20, (64, 1), generator=gen, device=dev)
        walk = attn.padding_bias(((cols >= 9) & (cols < ends)).long())
        cases.append((f"{p}_rw_update", *qkv(64, 19, 19, 6), walk, True, "backward"))
        ends = torch.randint(11, 20, (128, 1), generator=gen, device=dev)
        walk = attn.padding_bias(((cols >= 9) & (cols < ends)).long())
        cases.append((f"{p}_rw_ref_scoring", *qkv(128, 19, 19, 6), walk, True, "forward"))
    elif D == 32:
        # the GPT-2 stand-in (4 heads of 32, 8 prompt + 12 new tokens, 64
        # rollouts, batch 16): the sampler's prefill and a decode step, the
        # update; served with prompts of 17-40 tokens over a 64-wide view
        bias = attn.causal_bias(8, 20, 0, dev) + attn.padding_bias(left(64, 8, 20, 8, 8).long())
        cases.append((f"{p}_standin_rollout_prefill", *qkv(64, 8, 20, 4), bias, False,
                      "forward"))
        cases.append((f"{p}_standin_rollout_decode", *qkv(64, 1, 20, 4), decode_step(64, 20),
                      False, "forward"))
        cases.append((f"{p}_standin_update", *qkv(16, 20, 20, 4), pad(16, 20), True,
                      "backward"))
        bias = attn.causal_bias(40, 64, 0, dev) + attn.padding_bias(
            left(8, 40, 64, 17, 40).long())
        cases.append((f"{p}_standin_serving_prefill", *qkv(8, 40, 64, 4), bias, False,
                      "forward"))
        cases.append((f"{p}_standin_serving_decode", *qkv(32, 1, 64, 4), decode_step(32, 64),
                      False, "forward"))
    else:
        # the T5 stand-in (4 heads of d_kv 16, 8 encoder and 12 decoder
        # columns, batch 16): both self-attentions with their learned
        # relative bias (K2 with dbias; the decoder's causal mask folded
        # into it) and the cross attention; the learning guard (2 heads of
        # 16, 4 prompt + 6 new tokens, batch 16, 64 rollouts)
        table = torch.randn(1, 4, 8, 8, generator=gen, device=dev)
        cases.append((f"{p}_t5s_encoder_self", *qkv(16, 8, 8, 4), table + pad(16, 8), False,
                      "dbias"))
        table = torch.randn(1, 4, 12, 12, generator=gen, device=dev)
        cases.append((f"{p}_t5s_decoder_self", *qkv(16, 12, 12, 4),
                      table + attn.causal_bias(12, 12, 0, dev), False, "dbias"))
        cases.append((f"{p}_t5s_cross", *qkv(16, 12, 8, 4), pad(16, 8), False, "backward"))
        cases.append((f"{p}_guard_rollout_decode", *qkv(64, 1, 10, 2), decode_step(64, 10),
                      False, "forward"))
        cases.append((f"{p}_guard_update", *qkv(16, 10, 10, 2), pad(16, 10), True, "backward"))
    # left padding whose first causal rows see only padding, then the
    # edges every head dim shares
    cases.append((f"{p}_left_pad", *qkv(2, 112, 112, 4),
                  attn.padding_bias(left(2, 112, 112, 16, 48, width=112).long()), True,
                  "backward"))
    return cases + edge_kernel_cases(torch, attn, gen, p, D)


# per small head dim: the cases timed in bf16 (K1 at the path shapes; K2
# and K3 at the update, K2 with dbias at the learned-bias cases), and the
# headline shapes of the kernels line (K1, K2/K3, K2 with dbias)
SMALL_TIMED = {
    24: (("d24_rw_rollout_prefill", "d24_rw_rollout_decode", "d24_rw_update",
          "d24_rw_ref_scoring"), ("d24_rw_update", "d24_dbias")),
    32: (("d32_standin_rollout_prefill", "d32_standin_rollout_decode", "d32_standin_update",
          "d32_standin_serving_prefill", "d32_standin_serving_decode"),
         ("d32_standin_update", "d32_dbias")),
    16: (("d16_t5s_encoder_self", "d16_t5s_decoder_self", "d16_t5s_cross",
          "d16_guard_rollout_decode", "d16_guard_update"),
         ("d16_guard_update", "d16_t5s_decoder_self", "d16_t5s_cross", "d16_dbias")),
}
SMALL_HEADLINES = {  # (K1, K2/K3, K2 with dbias)
    24: ("d24_rw_rollout_decode", "d24_rw_update", "d24_dbias"),
    32: ("d32_standin_serving_decode", "d32_standin_update", "d32_dbias"),
    16: ("d16_guard_rollout_decode", "d16_guard_update", "d16_t5s_decoder_self"),
}


def phase_small_kernels(torch, fa, attn):
    """Phase 2 at D = 16, 24 and 32 (:func:`hold_and_time` over
    :func:`small_kernel_cases`): K1, K2 (with and without dbias) and K3 in
    bf16 and f32, O held relative to P|V| + |O| with the planted faults
    aimed at the row's last 16-byte chunk (columns D - 8 .. D - 1: at
    D = 24 the columns 16..23 that the second k-step covers beside its
    zero padding); timed in bf16 at ``SMALL_TIMED``. Returns ``{D:
    (fwd_results, bwd_results, fwd_timed, bwd_timed)}``."""
    return {D: hold_and_time(torch, fa, attn, small_kernel_cases(torch, attn, D, seed=60 + D),
                             fwd_timed=SMALL_TIMED[D][0], bwd_timed=SMALL_TIMED[D][1],
                             relative_o=True)
            for D in SMALL_HEAD_DIMS}


def attention_widths(cls, widths: list):
    """A patch (for ``counted_path``) of the attention module ``cls``'s
    forward recording each call's query width: under the wrapper's rule
    (``forward_variant``) a bf16 call runs K1 ``tile`` above 16 columns and
    ``decode`` up to 16, an f32 call ``fma``."""
    forward = cls.forward

    def recorded(self, x, *a, **kw):
        widths.append(x.shape[1])
        return forward(self, x, *a, **kw)

    return [(cls, "forward", recorded)]


def expected_k1(widths: list, dtype: str) -> dict:
    """K1's launches by variant for attention calls of these query widths
    in ``dtype``, no input copy."""
    if dtype == "float32":
        return {"tile": 0, "decode": 0, "fma": len(widths), "copies": 0}
    tile = sum(w > 16 for w in widths)
    return {"tile": tile, "decode": len(widths) - tile, "fma": 0, "copies": 0}


def small_ppo_run(torch, fa, label: str, config, run, backbone: str, attention_cls,
                  written=None):
    """One PPO-family run of phases 16 and 18 as a main path
    (:func:`counted_path`): ``run()`` trains; records the update stats,
    evals, the initial and final parameters, each attention call's query
    width, the collect phases, and whether the loaded backbone equals
    ``written`` (when given) before the first update; then a fresh trainer
    ``load``s the end checkpoint. Returns ``(trainer, record)`` with the
    gates every such path shares: finite stats, moved parameters, ``load``
    exact, K1 by variant against the widths (:func:`expected_k1`) and
    one launch per layer a trainer forward, no input copy and no plain
    call."""
    import numpy as np

    from trlx_tpu_torch.trainer import get_trainer

    cls = get_trainer(config.train.trainer)
    watch, widths, initial = {}, [], {}
    orig_learn = cls.learn

    def learn(self):
        initial.update({n: p.detach().clone() for n, p in self.model.state_dict().items()})
        if written is not None:
            watch["loaded"].append(state_equal(torch, getattr(self.model, backbone), written))
        return orig_learn(self)

    patches = [p for p in instrument(torch, cls, backbone, written or {}, watch)
               if p[1] != "learn"] + [(cls, "learn", learn)] + attention_widths(
        attention_cls, widths)
    trainer, record = counted_path(torch, fa, run, patches)
    final = trainer.model.state_dict()
    moved = sum(not torch.equal(final[n], initial[n]) for n in final)
    finite = all(np.isfinite(v).all() for r in watch["rows"] for v in r.values()) and all(
        math.isfinite(v) for e in watch["evals"] for v in e.values())
    saved = trainer_state(trainer)
    fresh = cls(config)
    fresh.load(config.train.checkpoint_dir)
    restored = restores(torch, saved, fresh, watch["saved_rng"])
    del fresh, saved
    dtype = config.train.dtype
    phases = phase_rows(trainer)
    expected_variants = expected_k1(widths, dtype)
    record.update({
        "path": label, "dtype": dtype, "updates": trainer.step, "phases": phases,
        "collect_s": sum(p["collect_s"] for p in phases),
        "train_s": sum(p["train_s"] for p in phases),
        "updates_per_s": trainer.step / sum(p["train_s"] for p in phases),
        "rollout_tokens_per_s": sum(p["rollout_tokens"] for p in phases) / sum(
            p["collect_s"] for p in phases),
        "evals": watch["evals"], "forwards": trainer.forwards, "attention_calls": len(widths),
        "query_widths": sorted(set(widths)), "expected_variants": expected_variants,
        "tensors_moved": moved, "tensors": len(final), "finite": finite,
        "load_restores": restored,
    })
    if written is not None:
        record["loaded_equals_written"] = watch["loaded"] == [True]
    gates = {
        "finite": finite, "moved": moved > 0, "load_restores": restored,
        "k1_by_variant": record["flash_fwd_variants"] == expected_variants
        and record["launches"]["flash_fwd"] == len(widths),
        "no_copies_or_plain": record["backward_copies"] == 0
        and record["plain_attention_calls"] == 0,
        "loaded": written is None or record["loaded_equals_written"],
    }
    record["gates"] = gates
    return trainer, record


# configs/ppo_randomwalks.yml as written (phase 16), then its bf16 variant
RW_UPDATES = 200
RW_BF16_UPDATES = 32  # four collects of 128 rollouts: 2 minibatches x 4 epochs each
RW_BF16_DEVIATIONS = (
    ("train.dtype", "float32", "bfloat16 (over f32 masters)", "puts K1's bf16 variant and "
     "K2/K3 tile at D = 24 on a path"),
    ("train.total_steps", 200, RW_BF16_UPDATES, "four collects: the bf16 run checks the "
     "kernels, the f32 run the yml"),
)


def phase_randomwalks_ppo(torch, fa):
    """Phase 16: ``configs/ppo_randomwalks.yml`` as written (6 blocks, 144
    wide, 6 heads of 24, f32, batch 64, 128 rollouts, 4 epochs, 200
    updates, evals every 20 with the metric) through
    ``trlx_tpu_torch.train(reward_fn=, metric_fn=, prompts=,
    eval_prompts=)`` on :func:`randomwalks_task`; then the same yml in
    bf16 over f32 masters for ``RW_BF16_UPDATES`` (``RW_BF16_DEVIATIONS``).
    Gates: :func:`small_ppo_run`'s, with K1 = 6 x the trainer's forwards
    and K2 = K3 = 6 x the updates in the dtype's variant. Prints wall,
    collect s, rollout tokens/s, updates/s, peak and ``metrics/optimality``
    at the first and last eval (reported, not gated: the reference does not
    promise that randomwalks learns on every seed)."""
    import tempfile

    import trlx_tpu_torch
    from trlx_tpu_torch.models import gpt2

    log("phase 16: configs/ppo_randomwalks.yml as written; the bf16 run's deviations: "
        + json.dumps([{"setting": k, "yml": y, "port": p, "why": why}
                      for k, y, p, why in RW_BF16_DEVIATIONS]))
    reward_fn, metric_fn, prompts, _, _ = randomwalks_task()
    ok, records = True, {}
    for label, updates, train in (("randomwalks_ppo", RW_UPDATES, {}),
                                  ("randomwalks_ppo_bf16", RW_BF16_UPDATES,
                                   {"dtype": "bfloat16"})):
        with tempfile.TemporaryDirectory() as tmp:
            config = yml_config("ppo_randomwalks.yml", tmp, "", updates, train=train)
            trainer, rec = small_ppo_run(
                torch, fa, label, config, lambda: trlx_tpu_torch.train(
                    reward_fn=reward_fn, metric_fn=metric_fn, prompts=prompts,
                    eval_prompts=prompts, config=config),
                "transformer", gpt2.Attention)
        L, updates = trainer.model_config.n_layer, trainer.step
        variant = "fma" if config.train.dtype == "float32" else "tile"
        expected_bwd = {k: {"tile": 0, "fma": 0, variant: L * updates} for k in BWD_KERNELS}
        rec["gates"].update({
            "updates": updates == config.train.total_steps,
            "head_dim": trainer.model_config.n_embd // trainer.model_config.n_head == 24,
            "k1_per_forward": rec["launches"]["flash_fwd"] == L * trainer.forwards,
            "k2_k3": rec["backward_variants"] == expected_bwd,
        })
        rec.update(expected_backward_variants=expected_bwd,
                   optimality=[e.get("metrics/optimality") for e in rec["evals"]])
        path_ok = all(rec["gates"].values())
        log(f"phase 16: {label} " + json.dumps(rec))
        log(f"phase 16: {label} {'ok' if path_ok else 'FAIL'} (gates {json.dumps(rec['gates'])}; "
            f"updates={updates}, K1 by variant {rec['flash_fwd_variants']} vs "
            f"{rec['expected_variants']}, K2/K3 by variant {rec['backward_variants']}; wall "
            f"{rec['wall_s']:.1f} s, collect {rec['collect_s']:.1f} s, "
            f"{rec['rollout_tokens_per_s']:.0f} rollout tokens/s, {rec['updates_per_s']:.2f} "
            f"updates/s, peak {rec['max_memory_allocated_bytes']} B; optimality first "
            f"{rec['optimality'][0]} last {rec['optimality'][-1]})")
        ok = ok and path_ok
        records[label] = rec
        del trainer
    return ok, records


ILQL_RW_UPDATES = 1000  # configs/ilql_randomwalks.yml's total_steps


def phase_randomwalks_ilql(torch, fa):
    """Phase 17: ``configs/ilql_randomwalks.yml`` as written (6 blocks of
    6 heads of 24, f32, batch 64, two Q heads, tau 0.9, alpha 0.1, a target
    sync every 5 updates, greedy evals every 100 with the adjacency
    ``logit_mask``) for its 1000 updates on :func:`randomwalks_dataset`'s
    1000 walks, through ``trlx_tpu_torch.train(dataset=..., logit_mask=...,
    metric_fn=..., eval_prompts=...)``. Gates: after every update the target
    heads are ``alpha * q + (1 - alpha) * previous`` bit for bit on the sync
    steps and bit-identical to before on the rest; finite stats; K1 ``fma``
    = 6 x the trainer's forwards (updates and the eval decode's), K2 = K3
    = 6 x the updates, all ``fma``; no input copy or plain call. Prints
    updates/s, eval tokens/s and the optimality of each eval."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.models import gpt2
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    _, metric_fn, prompts, logit_mask, info = randomwalks_task()
    samples, rewards = randomwalks_dataset(info)
    rows, evals, syncs, sync_ok, widths = [], [], [], [True], []
    times = {"update_s": 0.0, "eval_s": 0.0}
    decoded = [0]
    orig = {"train_step": ILQLTrainer.train_step, "evaluate": ILQLTrainer.evaluate,
            "sample": ILQLTrainer.sample}

    def evaluate(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["evaluate"](self)
        torch.cuda.synchronize()
        times["eval_s"] += time.perf_counter() - t0
        evals.append(out)
        return out

    def sample(self, prompt_ids, prompt_mask):
        out = orig["sample"](self, prompt_ids, prompt_mask)
        decoded[0] += int(out.response_mask[: len(self.eval_pipeline)].sum())
        return out

    train_step = ilql_update_watch(torch, orig["train_step"], rows, syncs, sync_ok, times)
    patches = [(ILQLTrainer, "train_step", train_step), (ILQLTrainer, "evaluate", evaluate),
               (ILQLTrainer, "sample", sample)] + attention_widths(gpt2.Attention, widths)
    with tempfile.TemporaryDirectory() as tmp:
        config = yml_config("ilql_randomwalks.yml", tmp, "", ILQL_RW_UPDATES)
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            dataset=(samples, rewards), metric_fn=metric_fn, eval_prompts=prompts,
            logit_mask=logit_mask, config=config), patches)
    L, updates = trainer.model_config.n_layer, trainer.step
    every = config.method.steps_for_target_q_sync
    finite = all(math.isfinite(v) for r in rows for v in r.values()) and all(
        math.isfinite(v) for e in evals for v in e.values())
    expected_bwd = {k: {"tile": 0, "fma": L * updates} for k in BWD_KERNELS}
    expected_variants = expected_k1(widths, "float32")
    record.update({
        "updates": updates, "update_s": times["update_s"],
        "updates_per_s": updates / times["update_s"], "eval_s": times["eval_s"],
        "eval_tokens": decoded[0], "eval_tokens_per_s": decoded[0] / times["eval_s"],
        "evals": evals, "optimality": [e.get("metrics/optimality") for e in evals],
        "target_syncs": len(syncs), "target_sync_bit_exact": sync_ok[0],
        "forwards": trainer.forwards, "attention_calls": len(widths),
        "query_widths": sorted(set(widths)),
        "expected_variants": expected_variants, "expected_backward_variants": expected_bwd,
        "samples": len(samples), "mean_dataset_reward": float(np.mean(rewards)),
    })
    gates = {
        "updates": updates == ILQL_RW_UPDATES and len(rows) == updates,
        "head_dim": trainer.model_config.n_embd // trainer.model_config.n_head == 24,
        "finite": finite, "evals": len(evals) >= 2,
        "target_sync": sync_ok[0] and syncs == list(range(every, updates + 1, every)),
        "k1": record["flash_fwd_variants"] == expected_variants
        and record["launches"]["flash_fwd"] == L * trainer.forwards == len(widths),
        "k2_k3": record["backward_variants"] == expected_bwd,
        "no_copies_or_plain": record["backward_copies"] == 0
        and record["plain_attention_calls"] == 0,
    }
    record["gates"] = gates
    ok = all(gates.values())
    log("phase 17: configs/ilql_randomwalks.yml " + json.dumps(record))
    log(f"phase 17: {'ok' if ok else 'FAIL'} (gates {json.dumps(gates)}; updates={updates}, "
        f"{record['updates_per_s']:.1f} updates/s, {record['eval_tokens_per_s']:.0f} eval "
        f"tokens/s, target syncs {len(syncs)} bit-exact {sync_ok[0]}, K1 by variant "
        f"{record['flash_fwd_variants']} vs {expected_variants}, K2/K3 by variant "
        f"{record['backward_variants']}; optimality first {record['optimality'][0]} last "
        f"{record['optimality'][-1]}; wall {record['wall_s']:.1f} s, peak "
        f"{record['max_memory_allocated_bytes']} B)")
    del trainer
    return ok, record


# phase 18's bf16 runs of the stand-ins: what they run differently from
# examples/pretrained_standin.py's config
STANDIN_BF16_UPDATES = 16  # two collects of 64 rollouts: 4 minibatches x 2 epochs each
STANDIN_DEVIATIONS = (
    ("model.model_path", "a checkpoint pretrained by transformers on the topic corpus",
     "an HF-layout checkpoint of the same widths with random weights from a seed",
     "the card's machine has no transformers to pretrain it"),
)
STANDIN_BF16_DEVIATIONS = (
    ("train.dtype", "float32", "bfloat16 (over f32 masters)", "puts the bf16 variants at "
     "D = 32 (GPT-2) and 16 (T5, K2 with dbias) on a path"),
    ("train.total_steps", 96, STANDIN_BF16_UPDATES, "two collects"),
)
STANDIN_SERVING = {"seq_length": 40, "max_new_tokens": 24, "prompts": 64, "lengths": (17, 40)}
GUARD_MARGIN = 0.15  # tests/test_torch_learning.py's margin, within 96 updates


def standin_serving_config(model_path: str):
    """The GPT-2 stand-in checkpoint served in bf16 with phase 4's engine
    geometry: 40 prompt columns and 24 new tokens (the stand-in's 64
    positions)."""
    cfg = serving_config()
    cfg["model"].update(model_path=model_path, model_arch={})
    cfg["train"].update(seq_length=STANDIN_SERVING["seq_length"])
    cfg["method"]["gen_kwargs"].update(max_new_tokens=STANDIN_SERVING["max_new_tokens"],
                                      eos_token_id=STANDIN_EOS, pad_token_id=STANDIN_PAD)
    return cfg


def phase_standins(torch, fa):
    """Phase 18: (a) the GPT-2 stand-in (vocab 64, 128 wide, 2 blocks, 4
    heads of 32, 64 positions) written as an HF checkpoint with random
    weights and loaded through ``model.model_path`` on the stand-in's PPO
    config (:func:`standin_rl_config`) in f32 and, cut, in bf16; the same
    checkpoint served through ``InferenceServer`` in bf16 (64 prompts of
    17-40 tokens: K1 ``tile`` prefills and ``decode`` steps); (b) the T5
    stand-in (``d_model`` 64, 4 heads of ``d_kv`` 16, 2 + 2 layers, 8
    buckets) through the ``Seq2SeqPPOTrainer`` the same two ways, K2 with
    dbias = (encoder + decoder layers) x the updates, as phase 6 counts
    it; (c) the learning guard's target-token task
    (:func:`target_token_config`, D = 16): mean reward up by
    ``GUARD_MARGIN`` within 96 updates, as the CPU test holds it. Every
    trained path has :func:`small_ppo_run`'s gates and K2 = K3 = one
    launch per attention a forward, per update. Returns ``(ok,
    records)``."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.inference.server import InferenceServer
    from trlx_tpu_torch.models import gpt2, t5

    log("phase 18: the pretrained stand-ins and the learning guard; deviations: " + json.dumps(
        [{"setting": k, "example": y, "port": p, "why": why}
         for k, y, p, why in STANDIN_DEVIATIONS + STANDIN_BF16_DEVIATIONS]))
    ok, records = True, {}

    def trained(label, family, ckpt, written, train, attention_cls, backbone, head_dim):
        nonlocal ok
        prompts = standin_prompts(np.random.default_rng(1), 128, 8)
        with tempfile.TemporaryDirectory() as run_dir:
            config = TRLConfig.from_dict(standin_rl_config(ckpt, family, checkpoint_dir=run_dir,
                                                           **train))
            trainer, rec = small_ppo_run(
                torch, fa, label, config, lambda: trlx_tpu_torch.train(
                    reward_fn=standin_reward, prompts=prompts, config=config),
                backbone, attention_cls, written)
        cfg, updates = trainer.model_config, trainer.step
        if family == "gpt2":
            per_forward, n_attn, n_learned = cfg.n_layer, cfg.n_layer, 0
            dims = cfg.n_embd // cfg.n_head
        else:
            per_forward, n_learned = None, cfg.num_layers + cfg.num_decoder_layers
            n_attn, dims = cfg.num_layers + 2 * cfg.num_decoder_layers, cfg.d_kv
        variant = "fma" if config.train.dtype == "float32" else "tile"
        expected_bwd = {k: {"tile": 0, "fma": 0, variant: n_attn * updates} for k in BWD_KERNELS}
        rec["gates"].update({
            "updates": updates == config.train.total_steps, "head_dim": dims == head_dim,
            "k2_k3": rec["backward_variants"] == expected_bwd,
            "dbias": rec["launches"]["flash_bwd_dq_dbias"] == n_learned * updates,
        })
        if per_forward:
            rec["gates"]["k1_per_forward"] = (
                rec["launches"]["flash_fwd"] == per_forward * trainer.forwards)
        rec.update(expected_backward_variants=expected_bwd,
                   expected_dbias=n_learned * updates)
        path_ok = all(rec["gates"].values())
        log(f"phase 18: {label} " + json.dumps(rec))
        log(f"phase 18: {label} {'ok' if path_ok else 'FAIL'} (gates {json.dumps(rec['gates'])}; "
            f"D={dims}, updates={updates}, K1 by variant {rec['flash_fwd_variants']} vs "
            f"{rec['expected_variants']}, K2/K3 by variant {rec['backward_variants']}, K2 with "
            f"dbias {rec['launches']['flash_bwd_dq_dbias']}; wall {rec['wall_s']:.1f} s, "
            f"{rec['updates_per_s']:.1f} updates/s, peak {rec['max_memory_allocated_bytes']} B)")
        ok = ok and path_ok
        records[label] = rec

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the GPT-2 stand-in: PPO in f32 and bf16, then served
        ckpt = os.path.join(tmp, "standin_gpt2")
        written = random_backbone(torch, gpt2.GPT2Model(gpt2.GPT2Config.from_dict(
            STANDIN_GPT2_HF_CONFIG), device="cuda"), seed=70)
        write_hf_checkpoint(ckpt, STANDIN_GPT2_HF_CONFIG, gpt2_hf_layout(written))
        for label, train in (("standin_gpt2_ppo", {}), ("standin_gpt2_ppo_bf16", {
                "dtype": "bfloat16", "total_steps": STANDIN_BF16_UPDATES})):
            trained(label, "gpt2", ckpt, written, train, gpt2.Attention, "transformer", 32)
        rng = np.random.default_rng(8)
        lo, hi = STANDIN_SERVING["lengths"]
        prompts = [[int(x) for x in rng.integers(2, 60, int(rng.integers(lo, hi + 1)))]
                   for _ in range(STANDIN_SERVING["prompts"])]
        server = InferenceServer(standin_serving_config(ckpt), seed=0)
        widths = []
        (rids, results, wall), rec = counted_path(
            torch, fa, lambda: serve(torch, server, prompts),
            attention_widths(gpt2.Attention, widths))
        stats, L = server.stats(), server.model_config.n_layer
        expected_variants = expected_k1(widths, "bfloat16")
        lengths = [results[r]["length"] for r in rids]
        finite = all(np.isfinite(results[r]["logprobs"]).all()
                     and np.isfinite(results[r]["values"]).all() for r in rids)
        served = server.model.transformer.state_dict()
        loaded = set(served) == set(written) and all(
            torch.equal(served[n].cpu(), t.to(served[n].dtype)) for n, t in written.items())
        rec.update({
            "path": "standin_gpt2_serving", "requests": len(rids), "generated_tokens":
            int(sum(lengths)), "serve_wall_s": wall, "tokens_per_s": sum(lengths) / wall,
            "expected_variants": expected_variants, "stats": stats,
            "attention_calls": len(widths), "query_widths": sorted(set(widths)),
        })
        gates = {
            "complete": len(results) == len(prompts) and min(lengths) >= 1, "finite": finite,
            "head_dim": server.model_config.n_embd // server.model_config.n_head == 32,
            "k1_by_variant": rec["flash_fwd_variants"] == expected_variants,
            "tile_per_prefill": expected_variants["tile"] == L * int(stats["engine/prefills"]),
            "decode_per_step": expected_variants["decode"] == L * int(
                stats["engine/decode_steps"]),
            "tile_ran": expected_variants["tile"] > 0,
            "no_plain": rec["plain_attention_calls"] == 0, "loaded": loaded,
        }
        rec["gates"] = gates
        serving_ok = all(gates.values())
        log("phase 18: standin_gpt2_serving " + json.dumps(rec))
        log(f"phase 18: standin_gpt2_serving {'ok' if serving_ok else 'FAIL'} (gates "
            f"{json.dumps(gates)}; {len(results)}/{len(prompts)} complete, K1 by variant "
            f"{rec['flash_fwd_variants']} vs {expected_variants}; "
            f"{rec['tokens_per_s']:.0f} tokens/s, peak {rec['max_memory_allocated_bytes']} B)")
        ok = ok and serving_ok
        records["standin_gpt2_serving"] = rec
        del server

        # (b) the T5 stand-in: seq2seq PPO in f32 and bf16
        ckpt = os.path.join(tmp, "standin_t5")
        written = random_backbone(torch, t5.T5Model(t5.T5Config.from_dict(
            STANDIN_T5_HF_CONFIG), device="cuda"), seed=71)
        write_hf_checkpoint(ckpt, STANDIN_T5_HF_CONFIG, t5_hf_layout(written))
        for label, train in (("standin_t5_ppo", {}), ("standin_t5_ppo_bf16", {
                "dtype": "bfloat16", "total_steps": STANDIN_BF16_UPDATES})):
            trained(label, "t5", ckpt, written, train, t5.T5Attention, "t5", 16)

    # (c) the learning guard's target-token task (D = 16), from scratch
    means = []

    def reward(samples, queries, response_gt=None):
        scores = target_token_reward(samples, queries)
        means.append(float(np.mean(scores)))
        return scores

    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 13, size=rng.integers(1, 4))) for _ in range(64)]
    with tempfile.TemporaryDirectory() as tmp:
        config = TRLConfig.from_dict(target_token_config(tmp))
        trainer, rec = small_ppo_run(
            torch, fa, "learning_guard", config, lambda: trlx_tpu_torch.train(
                reward_fn=reward, prompts=prompts, eval_prompts=prompts[:16], config=config),
            "transformer", gpt2.Attention)
    L, updates = trainer.model_config.n_layer, trainer.step
    early, late = float(np.mean(means[:2])), float(np.max(means[-4:]))
    expected_bwd = {k: {"tile": 0, "fma": L * updates} for k in BWD_KERNELS}
    rec["gates"].update({
        "updates": updates == 96,
        "head_dim": trainer.model_config.n_embd // trainer.model_config.n_head == 16,
        "k1_per_forward": rec["launches"]["flash_fwd"] == L * trainer.forwards,
        "k2_k3": rec["backward_variants"] == expected_bwd,
        "reward_rises": late > early + GUARD_MARGIN,
        "min_new_tokens": int(trainer.buffer.full.response_mask.sum(1).min()) >= 6,
    })
    rec.update(expected_backward_variants=expected_bwd, reward_means=means,
               early_mean_reward=early, late_max_reward=late, margin=GUARD_MARGIN)
    guard_ok = all(rec["gates"].values())
    log("phase 18: learning_guard " + json.dumps(rec))
    log(f"phase 18: learning_guard {'ok' if guard_ok else 'FAIL'} (gates "
        f"{json.dumps(rec['gates'])}; mean reward {early:.3f} -> {late:.3f}, margin "
        f"{GUARD_MARGIN}; K1 by variant {rec['flash_fwd_variants']}, K2/K3 by variant "
        f"{rec['backward_variants']}; wall {rec['wall_s']:.1f} s)")
    records["learning_guard"] = rec
    del trainer
    return ok and guard_ok, records


# ---------------------------------------------------------------------------
# Phase 21: sequence-parallel ring attention (trlx_tpu_torch/ops/
# ring_attention.py) at GPT-2 small's attention width
# ---------------------------------------------------------------------------


def lockstep(passes) -> list:
    """Run ring passes, one generator per rank (``ring_fwd_steps`` or
    ``ring_bwd_steps`` of ``trlx_tpu_torch/ops/ring_attention.py``, whose
    every step calls the module's step function), in lockstep in this one
    process: each rank's pass runs its step, rank by rank, then what rank
    ``r`` passes on reaches rank ``r + 1`` as a contiguous tensor, as the
    point-to-point exchange's receive buffers hold it. Returns each pass's
    result."""
    n = len(passes)
    results, incoming = [None] * n, [None] * n
    while True:
        outgoing = []
        for r, steps in enumerate(passes):
            try:
                outgoing.append(steps.send(incoming[r]))
            except StopIteration as stop:
                results[r] = stop.value
        if not outgoing:
            return results
        if len(outgoing) < n:
            raise RuntimeError("lockstep: the ranks' passes ended at different steps")
        incoming = [tuple(t.contiguous() for t in outgoing[(r - 1) % n]) for r in range(n)]


def lockstep_ring(torch, ra, q, k, v, kv_mask, dout, n: int, causal: bool = True):
    """The ``sp = n`` ring over whole [B, T, H, D] tensors (kv_mask [B, T],
    ``dout`` the output's cotangent) with its ``n`` ranks in lockstep on
    this one device: rank ``r`` holds the ``r``-th T/n block of every
    input and does the work of the point-to-point ring's rank ``r``, in
    the same order (:func:`lockstep`). Returns ``(out, lse, dq, dk, dv)``
    whole: out [B, T, H, D] in q's dtype, lse [B, H, T] f32, the gradients
    in the input dtypes."""
    qs, ks, vs, ms, ds = (x.chunk(n, dim=1) for x in (q, k, v, kv_mask, dout))
    fwd = lockstep([ra.ring_fwd_steps(qs[r], ks[r], vs[r], ms[r], n, r, causal)
                    for r in range(n)])
    bwd = lockstep([ra.ring_bwd_steps(qs[r], ks[r], vs[r], ms[r], *fwd[r], ds[r], n, r, causal)
                    for r in range(n)])
    out = torch.cat([o for o, _ in fwd], dim=1)
    lse = torch.cat([lse for _, lse in fwd], dim=2)
    return (out, lse, *(torch.cat(g, dim=1) for g in zip(*bwd)))


RING_SHAPE = (4, 8192, 12, 64)  # B, T, H, D: GPT-2 small's heads, LONGCTX.json's longest row
RING_SP = 4  # the lockstep ring's ranks
RING_PAD = 3  # row 0's padded tail of keys
RING_NAIVE_T = 2048  # the naive impl's length (it stores every step's scores)
RING_SLICE = (1, 2)  # the f64 yardstick's rows and heads
RING_DTYPES = ("bfloat16", "float32")


def ring_inputs(torch, dev, seed: int = 21):
    """q, k, v and the output's cotangent [B, T, H, D] f32 ~ N(0, 1) from a
    seed, and kv_mask [B, T] int32 with row 0's last ``RING_PAD`` keys
    padding."""
    B, T, H, D = RING_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, dout = (torch.randn(B, T, H, D, generator=gen, device=dev) for _ in range(4))
    kv_mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    kv_mask[0, T - RING_PAD:] = 0
    return q, k, v, dout, kv_mask


def fwd_bwd(torch, fn, q, k, v, dout):
    """``fn(q, k, v)`` and the gradients of <out, dout> in q, k, v."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def timed_wall(torch, fn) -> float:
    """Host seconds of ``fn()`` from a synchronised start to a synchronised
    end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def o_bound_over(torch, o, ref, pv, dtype_name) -> float:
    """max |o - ref| / (O_REL_TOL (P|V| + |ref|)), elementwise, ``pv`` the
    attention of |V| in f32: at most 1 holds."""
    tol = (O_REL_TOL[dtype_name] * (pv + ref.float().abs())).clamp_min(1e-30)
    return ((o.float() - ref.float()).abs() / tol).max().item()


def grad_bound_over(g, ref, dtype_name) -> float:
    """max |g - ref| / (BWD_TOL max(1, max |ref|)): at most 1 holds."""
    ref = ref.float()
    return (g.float() - ref).abs().max().item() / (
        BWD_TOL[dtype_name] * max(1.0, ref.abs().max().item()))


def block_bound(q, k, bias, NEG, backward: bool, dtype_name) -> dict:
    """The least time of a block wrapper on these inputs: each input read
    once and each output written once (f32 bias and LSE; the backward
    reads q, k, v, o, dO in f32 and writes dq, dk, dv in f32), over the
    card's memory rate; 4 D FLOPs per live pair forward (S, P.V), 10 D
    backward (S, dP, dV, dQ, dK), over the peak of the route they take:
    bf16 on the tensor cores at 989 TFLOP/s, and f32 (the ``split3``
    route) as ``SPLIT3_PRODUCTS`` bf16 plane products per f32 product at
    the same rate. ``f32_bound_ms`` beside it is the bound at the card's
    67 TFLOP/s off the tensor cores (the ``fma`` route's)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    # the (row, query, key) triples the [B, 1, Tq, Tk] bias leaves
    # unmasked, over every head: the pairs the block's data needs
    pairs = int((bias > NEG / 2).sum()) * H
    if backward:
        nbytes = 4 * 4 * (B * Tq * H * D + B * Tk * H * D) + bias.numel() * 4 + B * H * Tq * 4
        flops, dtype_name = 10 * D * pairs, "float32"
    else:
        item = q.element_size()
        nbytes = item * (2 * B * Tq * H * D + 2 * B * Tk * H * D) + bias.numel() * 4 + B * H * Tq * 4
        flops = 4 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    route_flops = flops * (SPLIT3_PRODUCTS if dtype_name == "float32" else 1)
    t_ops = route_flops / PEAK_FLOPS["bfloat16"] * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "route_flops": route_flops, "live_pairs": pairs}
    if dtype_name == "float32":
        t_f32 = flops / PEAK_FLOPS["float32"] * 1e3
        out["f32_bound_ms"] = max(t_bytes, t_f32)
    return out


def ring_block_cases(torch, fa, ra, q32, k32, v32, dout32, kv_mask):
    """Phase 21 (c)'s blocks: rank 1's 2048 queries of the sp = 4 ring
    against block 0 (past, row 0's first ``RING_PAD`` keys padding: left
    padding), block 1 (its diagonal, causal) and block 2 (wholly future),
    each bias as the ring builds it; and the outside (combined) o and lse
    of those three blocks, the lse + 0.3, and the block's dO, for the
    backward. Returns ``(q, {name: (k, v, bias)}, (o, lse, do))`` in
    f32."""
    Tb = RING_SHAPE[1] // RING_SP
    blk = lambda x, i: x[:, i * Tb:(i + 1) * Tb]  # noqa: E731
    mask = kv_mask.clone()
    mask[0, :RING_PAD] = 0
    q, do = blk(q32, 1), blk(dout32, 1)
    q_pos = torch.arange(Tb, Tb * 2, device=q.device)
    cases = {}
    for name, src in (("past_padded", 0), ("diagonal", 1), ("future", 2)):
        k_pos = torch.arange(src * Tb, (src + 1) * Tb, device=q.device)
        cases[name] = (blk(k32, src), blk(v32, src),
                       ra._block_bias(blk(mask, src), q_pos, k_pos, True))
    out = torch.zeros(q.shape[0], q.shape[2], Tb, q.shape[3], device=q.device)
    lse = torch.full(out.shape[:3], float("-inf"), device=q.device)
    for k, v, bias in cases.values():
        o_i, lse_i = fa.flash_attention_reference(q, k, v, bias, False, True)
        out, lse = ra._combine(out, lse, o_i.transpose(1, 2), lse_i)
    return q, cases, (out, lse + 0.3, do.transpose(1, 2))


def phase_ring_blocks(torch, fa, ra, inputs) -> tuple:
    """Phase 21 (c): the block wrappers against their plain versions at
    the ring's 2048 x 2048 block (B = 4, H = 12) on ``ring_block_cases``'
    three biases, the forward in bf16 and f32, the backward (f32) against
    the outside lse; each timed beside its bound, its plain version and
    SDPA with the bias as a mask (for the backward, SDPA's whole f32
    backward), and the split pre-pass on one operand, held against its
    plain split bit for bit. Returns ``(checks, timed, the pre-pass's
    row)``."""
    import torch.nn.functional as F

    NEG = fa.NEG_INF
    q32, cases, (o, lse, do) = ring_block_cases(torch, fa, ra, *inputs)
    checks, timed = [], {}
    for name, (k32, v32, bias) in cases.items():
        for dtype_name in RING_DTYPES:
            dt = getattr(torch, dtype_name)
            q, k, v = (x.to(dt) for x in (q32, k32, v32))
            got_o, got_lse = fa.flash_block_fwd(q, k, v, bias)
            want_o, want_lse = fa.flash_attention_reference(q, k, v, bias, False, True)
            torch.cuda.synchronize()
            tol_o, tol_lse = TOL[dtype_name]
            err_o = (got_o.transpose(1, 2).float() - want_o.float()).abs().max().item()
            if name == "future":
                # the uniform average at lse ~ NEG_INF + log Tk, weighed 0 by the combine
                mean = v.float().mean(dim=1)[:, :, None]
                err_lse = ((got_lse - (NEG + math.log(k.shape[1]))).abs().max().item()
                           / abs(NEG))
                ok = (err_o <= tol_o and (got_o.float() - mean).abs().max().item() <= tol_o
                      and err_lse <= 1e-7)
            else:
                err_lse = (got_lse - want_lse).abs().max().item()
                ok = err_o <= tol_o and err_lse <= tol_lse
            checks.append({"case": f"block_fwd_{name}", "dtype": dtype_name, "ok": ok,
                           "max_abs_err_o": err_o, "max_err_lse": err_lse})
            log(f"phase 21: (c) flash_block_fwd {name} {dtype_name} "
                f"{fa.block_forward_variant(dt, q.shape[1])}: max |dO| {err_o:.3g} (tol {tol_o}), "
                f"|dLSE| {err_lse:.3g}{' relative' if name == 'future' else ''}: "
                f"{'ok' if ok else 'FAIL'}")
            slow = dtype_name == "float32"
            rounds = dict(warmup=2, rounds=10, per_round=2) if slow else {}
            mask = bias.to(dt)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            timed[("flash_block_fwd", name, dtype_name)] = {
                "shape": f"B={q.shape[0]} H={q.shape[2]} Tq={q.shape[1]} Tk={k.shape[1]} "
                         f"D={q.shape[3]}, {name} bias {list(bias.shape)}",
                "variant": fa.block_forward_variant(dt, q.shape[1]),
                "ms": time_ms([lambda: fa.flash_block_fwd(q, k, v, bias)], **rounds),
                "plain_ms": time_ms([lambda: fa.flash_attention_reference(
                    q, k, v, bias, False, True)], **rounds),
                "library_ms": time_ms([lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)], **rounds),
                **block_bound(q, k, bias, NEG, False, dtype_name)}
        got = fa.flash_block_bwd(q32, k32, v32, bias, o, lse, do)
        want = fa.flash_attention_backward_reference(
            q32, k32, v32, bias, o.transpose(1, 2), lse, do.transpose(1, 2))
        torch.cuda.synchronize()
        over = max(grad_bound_over(g, w, "float32") for g, w in zip(got, want))
        errs = {f"max_abs_err_{n}": (g - w).abs().max().item()
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        zero = name != "future" or not any(g.any().item() for g in got)
        ok = over <= 1 and zero and all(g.dtype == torch.float32 for g in got)
        checks.append({"case": f"block_bwd_{name}", "dtype": "float32", "ok": ok, **errs,
                       "err_over_tol": over})
        log(f"phase 21: (c) flash_block_bwd {name} (split3, outside lse + 0.3): {json.dumps(errs)}"
            f", max err / tol {over:.3g}{', exactly 0' if name == 'future' else ''}: "
            f"{'ok' if ok else 'FAIL'}")
        slow = dict(warmup=2, rounds=10, per_round=2)
        leaves = [x.detach().requires_grad_() for x in (q32, k32, v32)]
        sdpa = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves),
                                              attn_mask=bias)
        sdpa_do = do.contiguous()
        timed[("flash_block_bwd", name, "float32")] = {
            "shape": f"B={q32.shape[0]} H={q32.shape[2]} Tq={q32.shape[1]} Tk={k32.shape[1]} "
                     f"D={q32.shape[3]}, {name} bias {list(bias.shape)}, outside lse",
            "variant": "split3",
            "ms": time_ms([lambda: fa.flash_block_bwd(q32, k32, v32, bias, o, lse, do)], **slow),
            "plain_ms": time_ms([lambda: fa.flash_attention_backward_reference(
                q32, k32, v32, bias, o.transpose(1, 2), lse, do.transpose(1, 2))], **slow),
            "library_ms": time_ms([lambda: torch.autograd.grad(
                sdpa, leaves, sdpa_do, retain_graph=True)], **slow),
            **block_bound(q32, k32, bias, NEG, True, "float32")}
        del sdpa, leaves
    # the split pre-pass alone, on one of the block's f32 operands (the
    # forward runs it 3 times, the backward 4, inside the wrappers' times),
    # held against its plain split bit for bit; bound by its bytes (4 read
    # and 6 written an element)
    planes, want = fa.split_planes(q32), fa.split_planes_reference(q32)
    torch.cuda.synchronize()
    split_err = (planes.float() - want.float()).abs().max().item()
    checks.append({"case": "split_planes", "dtype": "float32", "ok": torch.equal(planes, want),
                   "max_abs_err": split_err})
    log(f"phase 21: (c) split_planes of the block's q against the plain split: "
        f"{'bit for bit' if torch.equal(planes, want) else f'FAIL, max |d| {split_err:.3g}'}")
    split_t_bytes = 10 * q32.numel() / HBM_BYTES_PER_S * 1e3
    split_ms = {"shape": f"one f32 operand [B, Tq, H, D] = {list(q32.shape)}",
                "ms": time_ms([lambda: fa.split_planes(q32)]),
                "plain_ms": time_ms([lambda: fa.split_planes_reference(q32)]),
                "bound_ms": split_t_bytes, "bound_by": "bytes", "library_ms": None,
                "max_abs_err": split_err}
    del planes, want
    for (kernel, name, dtype_name), row in timed.items():
        log(f"phase 21: (c) time {kernel} {dtype_name} {row['shape']} ({row['variant']}): "
            f"ms={row['ms']} plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
            f"bound_ms={row['bound_ms']} ({row['bound_by']}; {row['live_pairs']} live pairs)"
            + (f" f32_bound_ms={row['f32_bound_ms']}" if "f32_bound_ms" in row else ""))
    log(f"phase 21: (c) time split_planes, {split_ms['shape']}: ms={split_ms['ms']} "
        f"plain_ms={split_ms['plain_ms']} bound_ms={split_ms['bound_ms']} (bytes)")
    return checks, timed, split_ms


def phase_ring(torch, fa) -> tuple:
    """Phase 21: sequence-parallel ring attention at GPT-2 small's heads
    (12 of 64), B = 4, T = 8192, causal with row 0's padded tail, in bf16
    and f32: (a) the entry point, ``ring_attention_sharded(impl="flash")``
    over ``make_mesh({"dp": -1, "sp": 1})`` on a one-rank NCCL group the
    phase starts (a ``file://`` store in a temporary directory) and
    destroys; (b) the ``sp = 4`` ring's ranks in lockstep on this card
    (:func:`lockstep_ring`); the dense kernels (``flash_attention``, the
    causal flag and a padding bias) beside them; the naive impl at T =
    2048 against the flash one; (c) :func:`phase_ring_blocks`. Every gate
    is fatal. Returns ``(ok, record)``."""
    import tempfile

    from trlx_tpu_torch.ops import attention as attn
    from trlx_tpu_torch.ops import ring_attention as ra
    from trlx_tpu_torch.parallel import distributed, make_mesh

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    B, T, H, D = RING_SHAPE
    q32, k32, v32, dout32, kv_mask = ring_inputs(torch, dev)
    pad = attn.padding_bias(kv_mask)
    sb, sh = RING_SLICE
    gates, record = {}, {"paths": {}, "walls_s": {}, "tokens_per_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize("cuda", init_method=f"file://{os.path.join(tmp, 'store')}",
                               world_size=1, rank=0)
        try:
            mesh = make_mesh({"dp": -1, "sp": 1})
            gates["nccl"] = torch.distributed.get_backend() == "nccl"

            def ring_a(q, k, v, kv_mask=kv_mask, impl="flash"):
                return ra.ring_attention_sharded(q, k, v, mesh, kv_mask=kv_mask, causal=True,
                                                 impl=impl)

            def dense(q, k, v):
                return fa.flash_attention(q, k, v, pad, causal=True)

            results = {}
            for dtype_name in RING_DTYPES:
                dt = getattr(torch, dtype_name)
                q, k, v, dout = (x.to(dt) for x in (q32, k32, v32, dout32))
                a, rec_a = counted_path(torch, fa, lambda: fwd_bwd(torch, ring_a, q, k, v, dout))
                b, rec_b = counted_path(torch, fa, lambda: lockstep_ring(
                    torch, ra, q, k, v, kv_mask, dout, RING_SP))
                b = (b[0], *b[2:])  # out and the gradients (the lse stays)
                d, rec_d = counted_path(torch, fa, lambda: fwd_bwd(torch, dense, q, k, v, dout))
                walls = {
                    "nccl_sp1": timed_wall(torch, lambda: fwd_bwd(torch, ring_a, q, k, v, dout)),
                    "lockstep_sp4": timed_wall(torch, lambda: lockstep_ring(
                        torch, ra, q, k, v, kv_mask, dout, RING_SP)),
                    "dense": timed_wall(torch, lambda: fwd_bwd(torch, dense, q, k, v, dout))}
                record["walls_s"][dtype_name] = walls
                record["tokens_per_s"][dtype_name] = {n: B * T / w for n, w in walls.items()}
                record["paths"][f"ring_nccl_{dtype_name}"] = rec_a
                record["paths"][f"ring_lockstep_{dtype_name}"] = rec_b
                record[f"dense_{dtype_name}"] = rec_d
                k1 = fa.block_forward_variant(dt, T // RING_SP)
                for path, rec, n in (("nccl", rec_a, 1), ("lockstep", rec_b, RING_SP ** 2)):
                    split3 = rec["split3_launches"]
                    gates[f"launches_{path}_{dtype_name}"] = (
                        k1 == fa.block_forward_variant(dt, T)
                        and rec["launches"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                                "flash_bwd_dkv": n, "flash_bwd_dq_dbias": 0,
                                                "flash_block_fwd": n, "flash_block_bwd": n}
                        and {**rec["flash_fwd_variants"], "split3": split3["flash_fwd"]}
                        == {**{x: 0 for x in (*FWD_VARIANT_COUNTERS, "split3")}, k1: n,
                            "copies": 0}
                        and {kern: {**rec["backward_variants"][kern], "split3": split3[kern]}
                             for kern in BWD_KERNELS}
                        == {kern: {"tile": 0, "fma": 0, "split3": n} for kern in BWD_KERNELS}
                        and split3["split_planes"] == (4 + 3 * (dtype_name == "float32")) * n
                        and rec["backward_copies"] == 0 and rec["plain_attention_calls"] == 0)
                gates[f"finite_{dtype_name}"] = all(
                    bool(torch.isfinite(x).all()) and x.shape == q.shape for x in (*a, *b, *d))
                results[dtype_name] = {"a": a, "b": b, "dense": d}
                log(f"phase 21: {dtype_name}: (a) NCCL sp=1 fwd+bwd {walls['nccl_sp1']:.3f} s, "
                    f"(b) lockstep sp=4 {walls['lockstep_sp4']:.3f} s, dense kernels "
                    f"{walls['dense']:.3f} s ({json.dumps(record['tokens_per_s'][dtype_name])} "
                    f"tokens/s); peak (a) {rec_a['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
                    f"(b) {rec_b['max_memory_allocated_bytes'] / 2**30:.2f} GiB, dense "
                    f"{rec_d['max_memory_allocated_bytes'] / 2**30:.2f} GiB; launches (a) "
                    f"{json.dumps(rec_a['launches'])}, (b) {json.dumps(rec_b['launches'])}")
            # bf16's yardstick: the f32 ring on the same rounded inputs and cotangent
            rounded = [x.to(torch.bfloat16).float() for x in (q32, k32, v32, dout32)]
            results["bfloat16"]["ref"] = fwd_bwd(torch, ring_a, *rounded)
            del rounded
            # the NCCL group carries a collective: the f32 ring's loss summed over the ring
            loss = (results["float32"]["a"][0] * dout32).sum().reshape(1)
            summed = loss.clone()
            torch.distributed.all_reduce(summed, group=mesh.get_group("sp"))
            gates["nccl_all_reduce"] = torch.equal(summed, loss)
            # the naive impl against the flash one, f32, on the last 2048 tokens
            tail = slice(T - RING_NAIVE_T, T)
            qn, kn, vn, dn = (x[:, tail] for x in (q32, k32, v32, dout32))
            flash_n = fwd_bwd(torch, lambda *x: ring_a(*x, kv_mask=kv_mask[:, tail]), qn, kn, vn,
                              dn)
            naive_n = fwd_bwd(torch, lambda *x: ring_a(*x, kv_mask=kv_mask[:, tail],
                                                       impl="naive"), qn, kn, vn, dn)
            pv_n = fa.flash_attention(qn, kn, vn.abs(), pad[..., tail], causal=True)
            over = {"out": o_bound_over(torch, flash_n[0], naive_n[0], pv_n, "float32"),
                    **{g: grad_bound_over(x, y, "float32")
                       for g, x, y in zip(("dq", "dk", "dv"), flash_n[1:], naive_n[1:])}}
            gates["naive_vs_flash"] = max(over.values()) <= 1
            record["naive_vs_flash_err_over_tol"] = over
            log(f"phase 21: naive vs flash impl, f32, T={RING_NAIVE_T}: err / tol "
                f"{json.dumps(over)}")
            del flash_n, naive_n, pv_n
        finally:
            torch.distributed.destroy_process_group()

    # (a) against (b), and both against the dense kernels
    names = ("out", "dq", "dk", "dv")
    f32 = results["float32"]
    for dtype_name in RING_DTYPES:
        res = results[dtype_name]
        # the f32 attention of |V| on the dtype's rounded inputs: P|V|
        qr, kr, vr = (x.to(getattr(torch, dtype_name)).float() for x in (q32, k32, v32))
        pv = fa.flash_attention(qr, kr, vr.abs(), pad, causal=True)
        ref = res["dense" if dtype_name == "float32" else "ref"]
        ref_name = "dense" if dtype_name == "float32" else "f32_ring"
        pairs = {"nccl_vs_lockstep": (res["a"], res["b"]),
                 f"nccl_vs_{ref_name}": (res["a"], ref), f"lockstep_vs_{ref_name}": (res["b"], ref)}
        if dtype_name == "bfloat16":
            pairs["dense_vs_f32_ring"] = (res["dense"], ref)
        for label, (x, y) in pairs.items():
            over = {"out": o_bound_over(torch, x[0], y[0], pv, dtype_name),
                    **{g: grad_bound_over(gx, gy, dtype_name)
                       for g, gx, gy in zip(names[1:], x[1:], y[1:])}}
            gates[f"{label}_{dtype_name}"] = max(over.values()) <= 1
            record[f"{label}_{dtype_name}_err_over_tol"] = over
            log(f"phase 21: {dtype_name} {label.replace('_', ' ')}: err / tol {json.dumps(over)}")
        del pv, qr, kr, vr
    # f32: on a B = 1, H = 2 slice, each ring's error against f64 attention
    # at most twice the dense kernels' own
    qs, ks, vs, ds = (x[:sb, :, :sh].double() for x in (q32, k32, v32, dout32))
    exact = fwd_bwd(torch, lambda q, k, v: attention_f64(torch, q, k, v, pad[:sb], causal=True),
                    qs, ks, vs, ds)
    err = {path: {n: (x[:sb, :, :sh].double() - e).abs().max().item()
                  for n, x, e in zip(names, f32[path], exact)} for path in ("dense", "a", "b")}
    for path in ("a", "b"):
        gates[f"f64_slice_{path}"] = all(err[path][n] <= 2 * err["dense"][n] for n in names)
    record["f64_slice_max_abs_err"] = err
    log(f"phase 21: f32 against f64 attention on a B={sb}, H={sh} slice (bound: 2x the dense "
        f"kernels' own): {json.dumps(err)}")
    del exact, results, f32

    block_checks, block_timed, split = phase_ring_blocks(
        torch, fa, ra, (q32, k32, v32, dout32, kv_mask))
    gates["blocks"] = all(c["ok"] for c in block_checks)
    record.update(block_checks=block_checks, block_timed=block_timed, split_planes_ms=split,
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  phase_s=time.perf_counter() - t_phase)
    ok = all(gates.values())
    log(f"phase 21: {'ok' if ok else 'FAIL'} (gates {json.dumps(gates)}; "
        f"{record['phase_s']:.1f} s)")
    return ok, record


# ---------------------------------------------------------------------------
# gpt2_moe (phase 22): the switch-MoE GPT-2 at GPT2MoEConfig's defaults,
# served and trained with the asynchronous checkpoint write
# ---------------------------------------------------------------------------

MOE_UPDATES = 64  # two PPO phases of 128 // 16 = 8 minibatches x 4 epochs
MOE_CHECKPOINT_INTERVAL = 16  # saves at 16, 32, 48 and the end (64)
MOE_EOS = 50256
MOE_DEVIATIONS = (
    ("model.model_type", "gpt2", "gpt2_moe",
     "the family under test: GPT2MoEConfig's defaults, GPT-2 small's widths (12 blocks, "
     "12 heads of 64, vocab 50 257) with 4 experts in every second block"),
    ("model.model_path", "lvwerra/gpt2-imdb", "",
     "random weights from the seed: the family has no HF checkpoint"),
    ("model.tokenizer_path", "gpt2", "", "token-id prompts and a host reward"),
    ("train.total_steps", 10000, MOE_UPDATES, "two phases"),
    ("train.checkpoint_interval", 10000, MOE_CHECKPOINT_INTERVAL,
     "four saves, so the retention of two steps shows"),
    ("train.async_checkpoint", False, True, "the asynchronous write under test"),
)


def switch_loads(torch, model, prompts) -> list:
    """Per switch block of ``model``, on ``prompts`` left-padded into one
    batch (the pads routed too, as the training forward routes them):
    ``{"max_load": the largest expert's share of the tokens, "experts":
    how many experts took a token}``."""
    from trlx_tpu_torch.models.gpt2 import torch_dtype
    from trlx_tpu_torch.models.gpt2_moe import SwitchMLP, collect_moe_losses

    width = max(map(len, prompts))
    ids = torch.zeros(len(prompts), width, dtype=torch.long)
    mask = torch.zeros(len(prompts), width, dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, width - len(p):] = torch.tensor(p)
        mask[i, width - len(p):] = 1
    device = next(model.parameters()).device
    chosen = []

    def hook(m, args, _):
        x = args[0].reshape(-1, m.config.n_embd).to(torch_dtype(m.config.dtype)).float()
        chosen.append(int(torch.argmax(x @ m.router.float(), dim=-1).unique().numel()))

    layers = [m for m in model.modules() if isinstance(m, SwitchMLP)]
    handles = [m.register_forward_hook(hook) for m in layers]
    try:
        with torch.no_grad(), collect_moe_losses(model) as sown:
            model(ids.to(device), mask.to(device))
    finally:
        for h in handles:
            h.remove()
    return [{"max_load": float(d["max_load"]), "experts": n} for d, n in zip(sown, chosen)]


def moe_training_config(checkpoint_dir: str, **train):
    """``configs/ppo_sentiments.yml``'s geometry with ``model_type:
    gpt2_moe`` at GPT2MoEConfig's defaults and ``MOE_DEVIATIONS``."""
    from trlx_tpu_torch.data.configs import TRLConfig

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_sentiments.yml")).to_dict()
    cfg["model"].update(model_type="gpt2_moe", model_path="", tokenizer_path="",
                        model_arch={})
    cfg["train"].update(total_steps=MOE_UPDATES, eval_interval=MOE_UPDATES,
                        checkpoint_interval=MOE_CHECKPOINT_INTERVAL, async_checkpoint=True,
                        checkpoint_dir=checkpoint_dir, **train)
    return TRLConfig.from_dict(cfg)


def phase_moe_serving(torch, fa):
    """Phase 22 (a): :func:`serve_wide` on gpt2_moe at GPT2MoEConfig's
    defaults (12 blocks, 12 heads of 64: K1 at D = 64), built in f32 and
    cast to bf16 but the value head's last layer, the routers and the
    layer norms, as the trainers' rollout cast keeps them."""
    return serve_wide(torch, fa, 22, "gpt2_moe",
                      wide_serving_config("gpt2_moe", {}, MOE_EOS), depth=N_LAYER,
                      head_dim=64, f32_leaves=("v_head.fc2.", ".router", ".ln_"),
                      checks={"experts": lambda cfg: (cfg.n_experts, cfg.moe_every) == (4, 2)})


def phase_moe_training(torch, fa):
    """Phase 22 (b): ``trlx_tpu_torch.train`` on :func:`moe_training_config`
    (bf16 over f32 masters, the full-copy reference, the rollout cast on,
    ``async_checkpoint: true``), 128 prompts of phase 5, the routers drawn
    N(0, 1/768) before the reference copy. Gates: 64 updates in 2 phases;
    every stat finite, the router's (``losses/moe_aux``,
    ``losses/router_z``, ``moe/max_load``) among them, ``moe/max_load`` in
    [1/4, 1] and below 1 in some update; on 32 of the prompts
    (:func:`switch_loads`) every switch block's largest share below 1 and
    more than one expert chosen at init, and in one block after the run;
    the parameters moved; K1 ``tile`` = 12 x the forwards that are
    not decode steps, ``decode`` = 12 x those; K2 = K3 = 12 x 64 ``tile``;
    no ``fma`` launch, input copy or plain call; steps 48 and 64 alone on
    disk; a fresh trainer's ``load`` restores the last save exactly; one
    rollout copy per set of masters (made at the two collects and the
    final eval), its routers, ``fc2`` and norms the f32 masters themselves
    and every other parameter bf16; the full-copy reference cast once
    (half its f32 bytes). Prints each save's return, its join of the
    previous write and the write's own seconds, the end save's write
    against the final eval's seconds and what ``learn`` still waited for
    after the eval."""
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.models.gpt2_moe import SwitchMLP
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils import checkpoint as ckpt

    log("phase 22: gpt2_moe PPO; deviations: " + json.dumps([
        {"setting": k, "yml": y, "port": p, "why": why} for k, y, p, why in MOE_DEVIATIONS]))
    watch, decode_forwards, cast_steps, saves, waits, initial = {}, [0], [], [], [], {}
    orig = {"apply": PPOTrainer._apply, "rollout_model": PPOTrainer.rollout_model,
            "learn": PPOTrainer.learn, "save": ckpt.CheckpointWriter.save,
            "wait": ckpt.CheckpointWriter.wait, "reference": PPOTrainer._setup_reference}
    loads = {}  # per switch block, at init and after the run

    def setup_reference(self, backbone, n_layer):
        # the routers drawn as the CPU test draws them, N(0, 1), scaled to
        # the width so that the logits on the unit-variance normed
        # features have unit variance: at the 0.02 of GPT-2's init they
        # are near-tied and one expert takes most of a block's tokens.
        # Before the reference copy, so the KL reference is this policy.
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.train.seed + 22)
        with torch.no_grad():
            for m in backbone.modules():
                if isinstance(m, SwitchMLP):
                    m.router.normal_(0.0, m.config.n_embd ** -0.5, generator=gen)
        return orig["reference"](self, backbone, n_layer)

    def apply(self, input_ids, *a, **kw):
        decode_forwards[0] += input_ids.shape[1] <= 16  # the sampler's steps
        return orig["apply"](self, input_ids, *a, **kw)

    def rollout_model(self):
        cast_steps.append(self.step)
        return orig["rollout_model"](self)

    def learn(self):
        initial.update({n: p.detach().to("cpu", copy=True)
                        for n, p in self.model.state_dict().items()})
        return orig["learn"](self)

    def save(self, *a, **kw):
        out = orig["save"](self, *a, **kw)
        saves.append(self.last_times)  # the thread adds write_s when it ends
        return out

    def wait(self):
        t0 = time.perf_counter()
        try:
            return orig["wait"](self)
        finally:
            waits.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        config = moe_training_config(tmp)
        patches = [p for p in instrument(torch, PPOTrainer, "transformer", {}, watch)
                   if p[1] != "learn"] + [
            (PPOTrainer, "_apply", apply), (PPOTrainer, "rollout_model", rollout_model),
            (PPOTrainer, "learn", learn), (ckpt.CheckpointWriter, "save", save),
            (ckpt.CheckpointWriter, "wait", wait),
            (PPOTrainer, "_setup_reference", setup_reference)]
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=training_prompts(), config=config), patches)
        final_wait_s = waits[-1] if waits else None
        on_disk = ckpt.all_steps(tmp)
        steps, n_layer = trainer.step, trainer.model_config.n_layer
        final = trainer.model.state_dict()
        moved = sum(not torch.equal(final[n].cpu(), initial[n]) for n in final)
        # the routing at init and after the run, outside the counted path
        probe = copy.deepcopy(trainer.model)
        probe.load_state_dict(initial)
        loads["init"] = switch_loads(torch, probe, training_prompts()[:32])
        del probe
        initial.clear()
        rows = watch["rows"]
        finite = all(np.isfinite(v).all() for r in rows for v in r.values()) and all(
            math.isfinite(v) for e in watch["evals"] for v in e.values())
        router = {k: [float(x) for r in rows for x in r[k]]
                  for k in ("losses/moe_aux", "losses/router_z", "moe/max_load")}
        loads["end"] = switch_loads(torch, trainer.model, training_prompts()[:32])
        # every switch block spreads its tokens at init (no expert takes
        # them all, so more than one takes some), and after the run at
        # least one block still does; every update's max over the blocks
        # in [1/4, 1] (the largest of 4 shares), below 1 in some update
        spread_ok = (
            len(loads["init"]) == n_layer // 2
            and all(b["max_load"] < 1.0 and b["experts"] > 1 for b in loads["init"])
            and any(b["max_load"] < 1.0 and b["experts"] > 1 for b in loads["end"]))
        load_ok = (all(0.25 <= x <= 1.0 for x in router["moe/max_load"])
                   and min(router["moe/max_load"]) < 1.0 and spread_ok)
        cast = trainer._rollout_module
        masters = dict(trainer.model.named_parameters())
        kept = [n for n, p in cast.named_parameters()
                if any(k in n for k in ("router", "fc2", ".ln_"))]
        cast_ok = (cast is not None and all(
            p is masters[n] if n in kept else p.dtype == torch.bfloat16
            for n, p in cast.named_parameters())
            and any(n.endswith(".router") for n in kept))
        ref_bytes = sum(p.numel() * p.element_size() for p in trainer.ref.parameters())
        ref_f32_bytes = sum(p.numel() * 4 for p in trainer.ref.parameters())
        expected_variants = {
            "tile": n_layer * (trainer.forwards - decode_forwards[0]),
            "decode": n_layer * decode_forwards[0], "fma": 0, "copies": 0,
        }
        expected_bwd = {k: {"tile": n_layer * MOE_UPDATES, "fma": 0} for k in BWD_KERNELS}
        phases, forwards = phase_rows(trainer), trainer.forwards
        refreshes = trainer.rollout_cast_refreshes
        trainer.opt.zero_grad()
        trainer.buffer = None
        fresh = PPOTrainer(moe_training_config(tmp))
        t0 = time.perf_counter()
        fresh.load(tmp)
        load_s = time.perf_counter() - t0
        restored = restores(torch, trainer_state(trainer), fresh, watch["saved_rng"])
        del fresh
    final_eval_s = watch["evals"][-1].get("time/generate") if watch["evals"] else None
    record.update({
        "model": "gpt2_moe at GPT2MoEConfig's defaults (GPT-2 small widths, 4 experts every "
                 "2nd block), bf16 over f32 masters",
        "parameters": sum(p.numel() for p in trainer.model.parameters()),
        "updates": steps, "phases": phases, "evals": watch["evals"], "router": router,
        "forwards": forwards, "decode_forwards": decode_forwards[0],
        "expected_variants": expected_variants, "expected_backward_variants": expected_bwd,
        "params_moved": moved, "finite": finite, "max_load_in_range": load_ok,
        "switch_loads": loads,
        "steps_on_disk": on_disk, "load_restores": restored, "checkpoint_load_s": load_s,
        "saves": saves, "final_eval_s": final_eval_s, "final_join_s": final_wait_s,
        "rollout_cast_refreshes": refreshes, "rollout_cast_steps": sorted(set(cast_steps)),
        "rollout_cast_ok": cast_ok, "reference_bytes": ref_bytes,
        "reference_f32_bytes": ref_f32_bytes,
    })
    log("phase 22: gpt2_moe PPO " + json.dumps(record))
    ok = (
        steps == MOE_UPDATES and len(rows) == 2 and finite and moved > 0 and load_ok
        and all(len(v) == MOE_UPDATES for v in router.values())
        and record["flash_fwd_variants"] == expected_variants
        and record["backward_variants"] == expected_bwd and record["backward_copies"] == 0
        and record["plain_attention_calls"] == 0
        and on_disk == [MOE_UPDATES - MOE_CHECKPOINT_INTERVAL, MOE_UPDATES]
        and len(saves) == MOE_UPDATES // MOE_CHECKPOINT_INTERVAL
        and all("write_s" in t for t in saves) and restored
        and refreshes == len(set(cast_steps)) == 3 and cast_ok
        and ref_bytes < 0.51 * ref_f32_bytes
    )
    log(f"phase 22: gpt2_moe PPO {'ok' if ok else 'FAIL'} (updates={steps}, phases={len(rows)}, "
        f"finite={finite}, moved tensors={moved}, max load in [1/4, 1], below 1 in some "
        f"update, tokens spread in every switch block at init and in one after: {load_ok} "
        f"(per block, init {[b['max_load'] for b in loads['init']]}, end "
        f"{[b['max_load'] for b in loads['end']]}); K1 by "
        f"variant {record['flash_fwd_variants']} vs {expected_variants}; K2/K3 by variant "
        f"{record['backward_variants']} vs {expected_bwd}; backward copies "
        f"{record['backward_copies']}; plain attention calls {record['plain_attention_calls']}; "
        f"steps on disk {on_disk}; load restores {restored}; rollout copies {refreshes} at "
        f"steps {sorted(set(cast_steps))}, f32 routers, fc2 and norms shared: {cast_ok}; "
        f"reference {ref_bytes} B of {ref_f32_bytes} B in f32; saves returned in "
        f"{[round(t['save_s'], 3) for t in saves]} s, wrote in "
        f"{[round(t.get('write_s', -1), 3) for t in saves]} s; final eval {final_eval_s} s, "
        f"then joined {final_wait_s} s; wall {record['wall_s']:.1f} s, peak "
        f"{record['max_memory_allocated_bytes']} B)")
    del trainer
    return ok, record


def phase_moe(torch, fa):
    """Phase 22: gpt2_moe served (a) and trained (b); returns ``(ok,
    {"serving": record, "training": record})``."""
    serving_ok, serving = phase_moe_serving(torch, fa)
    training_ok, training = phase_moe_training(torch, fa)
    return serving_ok and training_ok, {"serving": serving, "training": training}


# ----------------------------------------------------------------------- #
# phase 23: the int8 KV cache
# ----------------------------------------------------------------------- #

#: heads of each built head dim's model (phase 2's cases): the small dims'
#: stand-ins, GPT-2, GPT-NeoX-20B, GPT-Neo 1.3B, GPT-J-6B
KV_INT8_HEADS = {16: 4, 24: 6, 32: 4, 64: 12, 96: 64, 128: 16, 256: 16}
#: the two decode shapes timed at D = 64, H = 12 (B, K): serving decode
#: (phase 4's 32 slots over a 576-wide view) and the rollout decode
#: (bench.py's B = 128 over 64 + 48)
KV_INT8_TIMED = {"serving_decode": (32, 576), "rollout_decode": (128, 112)}
#: the threshold sweep's shapes (B, capacity): bench.py's rollout (64 + 48),
#: the serving view, a long rollout and the JAX package's long-context point
KV_INT8_SWEEP = ((128, 112), (128, 576), (32, 1088), (8, 2048))
KV_INT8_SWEEP_NEW = 48  # decode steps per rollout (bench.py's max_new_tokens)
KV_INT8_PAIRS = 5  # interleaved int8 / bf16 pairs per shape


def int8_launches(fa) -> dict:
    """The int8 cache's two kernels' launches since the last reset."""
    from trlx_tpu_torch.ops import kv_quant

    return {"flash_fwd_decode_int8": fa.FLASH_FWD_DECODE_INT8_LAUNCHES,
            "kv_quant": kv_quant.KV_QUANT_LAUNCHES}


def reset_int8_counters(fa) -> None:
    from trlx_tpu_torch.ops import kv_quant

    fa.FLASH_FWD_DECODE_INT8_LAUNCHES = kv_quant.KV_QUANT_LAUNCHES = 0


def int8_decode_inputs(torch, attn, D, H, B, K, seed):
    """One decode step's q [B, 1, H, D] bf16 and the int8 cache's K/V
    (``quantize_kv`` of N(0, 1) bf16 values) at per-row depths with left
    padding, the last row with no live key; the bias [B, 1, 1, K] f32."""
    from trlx_tpu_torch.models.gpt2 import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (attn.QuantizedKV(*quantize_kv(
        torch.randn(B, K, H, D, generator=gen, device="cuda").bfloat16()), torch.bfloat16)
        for _ in range(2))
    depth = torch.randint(0, K, (B,), generator=gen, device="cuda")
    depth[0] = K - 1
    cols = torch.arange(K, device="cuda")[None, :]
    start = torch.randint(0, K // 4 + 1, (B,), generator=gen, device="cuda")
    mask = ((cols >= start[:, None]) & (cols <= depth[:, None])).long()
    mask[-1] = 0
    bias = attn.causal_bias(1, K, depth, "cuda") + attn.padding_bias(mask)
    return q, k, v, bias


def check_int8_decode(torch, fa, attn, D, H, B, K, seed) -> dict:
    """decode_int8 against dequantization and the plain version (O, LSE and
    ``p_scale``, within the bf16 decode's ``TOL``), and against the bf16
    decode on the dequantized view, bit for bit."""
    q, k, v, bias = int8_decode_inputs(torch, attn, D, H, B, K, seed)
    before = int8_launches(fa)["flash_fwd_decode_int8"]
    o, lse, p_scale = fa._launch_int8(q, k, v, bias, False, True, with_p_scale=True)
    counted = int8_launches(fa)["flash_fwd_decode_int8"] - before
    kd, vd = k.dequantize(), v.dequantize()
    o_ref, lse_ref, ps_ref = fa.flash_attention_reference(q, kd, vd, bias, False, True, True)
    o_bf16 = fa.flash_attention(q, kd, vd, bias, False)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL["bfloat16"]
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    err_ps = ((p_scale - ps_ref).abs() / ps_ref.abs()).max().item()
    row = {"kernel": "flash_fwd_decode_int8", "D": D, "shape": f"B={B} H={H} Q=1 K={K} D={D}",
           "max_abs_err": err_o,
           "max_abs_err_lse": err_lse, "p_scale_rel_err": err_ps,
           "equals_bf16_decode": bool(torch.equal(o, o_bf16)), "counted": counted}
    row["ok"] = (err_o <= tol_o and err_lse <= tol_lse and err_ps <= P_SCALE_TOL
                 and torch.isfinite(o).all().item() and counted == 1)
    return row


def check_quantized_write(torch, fa, D, H, seed) -> dict:
    """The quantizing write against its plain version (on the CPU) bit for
    bit: a 64-column prefill and a decode step into a linear cache, and a
    paged write through rotated tables into admitted slots with a publish
    into the shared pool (every real row; the sentinels are never read)."""
    from trlx_tpu_torch.inference import kv_cache as kvc
    from trlx_tpu_torch.models.gpt2 import kv_buffers
    from trlx_tpu_torch.ops import kv_quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok, launched, err = True, 0, 0.0

    def compare(got, want):
        nonlocal err
        for x in want:
            err = max(err, (got[x].cpu().float() - want[x].float()).abs().max().item())
        return all(torch.equal(got[x].cpu(), want[x]) for x in want)

    for B, T, start, C in ((4, 64, 0, 112), (8, 1, 100, 112)):
        k, v = (3 * torch.randn(B, T, H, D, generator=gen, device="cuda") for _ in range(2))
        k[0, 0, 0] = 0.0  # an all-zero (token, head)
        k, v = k.bfloat16(), v.bfloat16()
        got = kv_buffers(1, B, C, H, D, torch.bfloat16, "int8", device="cuda")[0]
        want = kv_buffers(1, B, C, H, D, torch.bfloat16, "int8")[0]
        before = kv_quant.KV_QUANT_LAUNCHES
        kv_quant.quantized_write(k, v, kv_quant.cache_buffers(got), row_stride=C, start=start)
        launched += kv_quant.KV_QUANT_LAUNCHES - before
        kv_quant.quantized_write(k.cpu(), v.cpu(), kv_quant.cache_buffers(want), row_stride=C,
                                 start=start)
        ok = compare(got, want) and ok
    S, cap, T, bs = 6, 32, 16, 4
    k, v = (3 * torch.randn(2, T, H, D, generator=gen, device="cuda") for _ in range(2))
    results = []
    for device in ("cuda", "cpu"):
        cache = kvc.init_paged_cache(1, S, cap, H, D, torch.bfloat16, "int8", bs, device)[0]
        cache.update(kvc.init_shared_pool(4, bs, H, D, torch.bfloat16, "int8", device))
        tables = kvc.rotate_block_table(cache["block_tables"], 3)[:2]
        positions = torch.arange(T, device=device)[None].repeat(2, 1)
        phys = kvc.physical_positions(tables, positions, cap)
        publish = torch.tensor([[0, 3, -1, -1], [-1, -1, 1, -1]], device=device)
        blk = torch.gather(publish, 1, (positions // bs).clamp(0, 3))
        pub_rows = torch.where(blk >= 0, blk * bs + positions % bs, 4 * bs)
        before = kv_quant.KV_QUANT_LAUNCHES
        kv_quant.quantized_write(
            k.bfloat16().to(device), v.bfloat16().to(device), kv_quant.cache_buffers(cache),
            rows=kv_quant.rows_of(torch.tensor([5, 2], device=device), phys, cap + 1),
            publish=kv_quant.cache_buffers(cache, "shared_"), publish_rows=pub_rows)
        launched += kv_quant.KV_QUANT_LAUNCHES - before
        results.append({x: t[:, :cap].cpu() if t.dim() == 4 else t[:-1].cpu()
                        for x, t in cache.items() if x != "block_tables"})
    ok = compare(*results) and ok
    return {"kernel": "kv_quant", "D": D, "H": H, "ok": ok and launched == 3,
            "launches": launched, "max_abs_err": err}


def time_int8(torch, fa, attn, B, K, H=12, D=64) -> dict:
    """At one decode shape: decode_int8 (its C entry point, arguments
    packed) beside its bytes bound (int8 K and V, their bf16 scales, q, o
    and the f32 bias), its plain version (dequantize, then the plain
    attention), the bf16 decode on the dequantized view and SDPA there
    (:func:`time_forward`); and the quantizing write of one step's K and V
    into a linear cache of capacity K beside its bound and its plain
    version."""
    from trlx_tpu_torch.models.gpt2 import kv_buffers
    from trlx_tpu_torch.ops import kv_quant

    q, k, v, bias = int8_decode_inputs(torch, attn, D, H, B, K, seed=B * K)
    nbytes = (2 * k.values.numel() + 2 * k.scale.numel() * 2 + 2 * q.numel() * 2
              + bias.numel() * 4)
    copies = input_copies([q, k.values, k.scale, v.values, v.scale, bias], nbytes)
    lib = fa._load()["flash_fwd"]
    stream = torch.cuda.current_stream().cuda_stream
    calls, keep = [], []
    for cq, kq, ks, vq, vs, cb in copies:
        b, sb = fa._bias_view(cb, B, H, 1, K)
        o = torch.empty_like(cq)
        keep.append((b, o))
        calls.append(functools.partial(
            lib.trlx_flash_fwd_int8, cq.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), b.data_ptr(), o.data_ptr(), None, None,
            B, H, 1, K, D, *cq.stride()[:3], *kq.stride()[:3], *vq.stride()[:3],
            *ks.stride()[:3], *vs.stride()[:3], *sb, float(D ** -0.5), 0, stream))
    ms = time_ms(calls)
    rc = calls[0]()
    torch.cuda.synchronize()
    packed_ok = rc == 0 and torch.equal(keep[0][1], fa.flash_attention_int8(q, k, v, bias))
    views = [(c[0], attn.QuantizedKV(c[1], c[2], torch.bfloat16),
              attn.QuantizedKV(c[3], c[4], torch.bfloat16), c[5]) for c in copies]
    wrapper_ms = time_ms([lambda c=c: fa.flash_attention_int8(*c) for c in views])
    plain_ms = time_ms([lambda c=c: fa.flash_attention_int8_reference(*c) for c in views])
    del calls, keep, copies, views
    bf16 = time_forward(torch, fa, attn, q, k.dequantize(), v.dequantize(), bias, False)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    decode = {"shape": f"B={B} H={H} Q=1 K={K} D={D}, bias [{B}, 1, 1, {K}]",
              "ms": ms, "wrapper_ms": wrapper_ms, "packed_ok": packed_ok, "plain_ms": plain_ms,
              "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes,
              "bf16_decode_ms": bf16["ms"], "bf16_decode_bound_ms": bf16["bound_ms"],
              "sdpa_bf16_ms": bf16["library_ms"], "library_ms": None}
    # the quantizing write: one step (T = 1) of K and V into row K - 1
    kn, vn = (torch.randn(B, 1, H, D, device="cuda").bfloat16() for _ in range(2))
    wbytes = 2 * kn.numel() * 2 + 2 * kn.numel() + 2 * B * H * 2
    cache = kv_buffers(1, B, K, H, D, torch.bfloat16, "int8", device="cuda")[0]
    dst = kv_quant.cache_buffers(cache)
    wcopies = input_copies([kn, vn], 2 * kn.numel() * 2)
    qlib = fa._load()["kv_quant"]
    wcalls = [functools.partial(
        qlib.trlx_kv_quant_write, a.data_ptr(), b.data_ptr(), 1, B, 1, H, D,
        *a.stride()[:3], *b.stride()[:3], *(t.data_ptr() for t in dst), None, K, K - 1,
        None, None, None, None, None, stream) for a, b in wcopies]
    write_ms = time_ms(wcalls)
    rows = torch.arange(B, device="cuda")[:, None] * K + K - 1
    write_plain_ms = time_ms([lambda a=a, b=b: kv_quant.quantized_write_reference(
        a, b, dst, rows) for a, b in wcopies])
    write = {"shape": f"B={B} T=1 H={H} D={D} into a {K}-position cache",
             "ms": write_ms, "plain_ms": write_plain_ms,
             "bound_ms": wbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": wbytes,
             "library_ms": None}
    del cache, dst, wcopies, wcalls
    return {"decode": decode, "write": write}


def sweep_model(torch, capacity_max: int):
    """GPT-2 small at ``configs/ppo_sentiments.yml``'s widths, random
    weights from a seed, positions up to ``capacity_max``, its weights
    cast to bf16 as the rollout cast keeps them."""
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, init_params
    from trlx_tpu_torch.utils import compute_dtype_cast

    cfg = GPT2Config(vocab_size=50257, n_positions=capacity_max, n_embd=768, n_layer=12,
                     n_head=12, dtype="bfloat16")
    model = CausalLMWithValueHead(cfg, GPT2Model, device="cuda")
    init_params(model, 0)
    random_backbone(torch, model.transformer, seed=13)
    return cfg, compute_dtype_cast(model, torch.bfloat16)


def sweep_rollout(torch, model, cfg, kv_dtype, ids, mask, R) -> dict:
    """One greedy fixed-sampler rollout of R tokens on a ``kv_dtype``
    cache; the device time of each decode forward from CUDA events around
    it (the host loop keeps the card waiting between them, so this is the
    step's wall on the card's clock). Returns decode tokens/s and ms."""
    import dataclasses

    from trlx_tpu_torch.models.gpt2 import init_cache
    from trlx_tpu_torch.ops.sampling import GenerationConfig, make_sampler

    gen = GenerationConfig.from_dict({"max_new_tokens": R, "min_new_tokens": R,
                                      "do_sample": False, "eos_token_id": 50256,
                                      "pad_token_id": 50256})
    events = []

    def apply(input_ids, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(input_ids, *a, **kw)
        end.record()
        events.append((input_ids.shape[1], start, end))
        return out

    kcfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    sampler = make_sampler(apply, lambda b, c: init_cache(kcfg, b, c, "cuda"), gen,
                           ids.shape[1])
    out = sampler(ids, mask)
    torch.cuda.synchronize()
    decode_ms = sum(s.elapsed_time(e) for w, s, e in events if w == 1)
    steps = sum(w == 1 for w, _, _ in events)
    return {"decode_ms": decode_ms, "steps": steps,
            "tokens_per_s": ids.shape[0] * steps / (decode_ms / 1e3),
            "finite": bool(torch.isfinite(out.logprobs).all())}


def int8_sweep(torch, fa) -> dict:
    """Phase 23 (b): int8 against bf16 decode tokens/s on GPT-2 small's
    fixed sampler at :data:`KV_INT8_SWEEP`, :data:`KV_INT8_PAIRS`
    interleaved pairs per shape after one warm-up each (the order flips
    every pair), medians reported; the capacity the figures support: the
    largest measured one up to which int8 is at least as fast at every
    measured capacity (0 when it is slower at the smallest)."""
    import warnings

    from trlx_tpu_torch.models.gpt2 import INT8_KV_MAX_CAPACITY

    cap_max = max(c for _, c in KV_INT8_SWEEP)
    cfg, model = sweep_model(torch, cap_max)
    rows = {}
    R = KV_INT8_SWEEP_NEW
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an explicit int8 past the threshold warns
        for B, cap in KV_INT8_SWEEP:
            gen = torch.Generator(device="cuda").manual_seed(cap)
            Q = cap - R
            ids = torch.randint(0, 50256, (B, Q), generator=gen, device="cuda")
            mask = torch.ones_like(ids)
            mask[B // 2:, : Q // 4] = 0  # half the rows left-padded
            for dt in ("int8", "bfloat16"):
                sweep_rollout(torch, model, cfg, dt, ids, mask, R)  # warm-up
            runs = {"int8": [], "bfloat16": []}
            for pair in range(KV_INT8_PAIRS):
                for dt in (("int8", "bfloat16") if pair % 2 == 0 else ("bfloat16", "int8")):
                    runs[dt].append(sweep_rollout(torch, model, cfg, dt, ids, mask, R))
            med = {dt: statistics.median(r["tokens_per_s"] for r in runs[dt]) for dt in runs}
            rows[cap] = {
                "B": B, "capacity": cap, "prompt": Q, "new_tokens": R,
                "int8_tokens_per_s": med["int8"], "bf16_tokens_per_s": med["bfloat16"],
                "int8_over_bf16": med["int8"] / med["bfloat16"],
                "int8_pairs": [r["tokens_per_s"] for r in runs["int8"]],
                "bf16_pairs": [r["tokens_per_s"] for r in runs["bfloat16"]],
                "finite": all(r["finite"] for rs in runs.values() for r in rs),
            }
            log(f"phase 23: sweep B={B} capacity={cap}: int8 {med['int8']:.1f} tokens/s, bf16 "
                f"{med['bfloat16']:.1f} tokens/s (medians of {KV_INT8_PAIRS} interleaved pairs; "
                f"int8/bf16 {rows[cap]['int8_over_bf16']:.4f}); int8 pairs "
                f"{rows[cap]['int8_pairs']}, bf16 pairs {rows[cap]['bf16_pairs']}")
    del model
    torch.cuda.empty_cache()
    supported = 0
    for cap in sorted(rows):
        if rows[cap]["int8_over_bf16"] < 1.0:
            break
        supported = cap
    log(f"phase 23: the sweep supports INT8_KV_MAX_CAPACITY = {supported}; the port's "
        f"constant is {INT8_KV_MAX_CAPACITY} "
        f"({'equal' if supported == INT8_KV_MAX_CAPACITY else 'DIFFERENT'}; walls vary between "
        "calls, so this is reported, not gated)")
    return {"rows": rows, "supported": supported, "constant": INT8_KV_MAX_CAPACITY}


def int8_serving_tier(torch, fa) -> tuple:
    """Phase 23 (c): phase 11's serving tier (the prefix pool, chunked
    prefill, the trie drafter) on its traffic with
    ``kv_cache_dtype: int8``: an int8 cache and an int8 pool. Gates: every
    request complete with finite logprobs and values, prefix hits, K1
    ``tile`` = 12 x chunk forwards (on the dequantized view),
    ``decode_int8`` = 12 x (decode + verify steps) and no bf16 ``decode``,
    the quantizing write 12 x every forward, no ``fma`` launch, input copy
    or plain call."""
    from trlx_tpu_torch.inference.server import InferenceServer

    prompts, _ = serving_tier_prompts()
    cfg = serving_tier_config(True)
    cfg["model"]["model_arch"]["kv_cache_dtype"] = "int8"
    server = InferenceServer(cfg, seed=0)
    layer = server.engine.init_state().cache[0]
    int8_cache = layer["k"].dtype == torch.int8 and layer["shared_k"].dtype == torch.int8
    results, rec = serve_counted(torch, fa, server, prompts)
    del server
    kv = rec["kv_int8_launches"]
    expected = {"tile": N_LAYER * rec["prefill_chunks"], "decode": 0, "fma": 0, "copies": 0}
    expected_int8 = {"flash_fwd_decode_int8": N_LAYER * rec["decode_steps"],
                     "kv_quant": N_LAYER * (rec["prefill_chunks"] + rec["decode_steps"])}
    gates = {
        "int8_cache_and_pool": int8_cache,
        "complete": len(results) == len(prompts) and rec["min_length"] >= 1 and rec["finite"],
        "prefix_hits": rec["prefix_hit_blocks"] > 0,
        "verify_steps": rec["verify_steps"] > 0,
        "k1_by_variant": rec["flash_fwd_variants"] == expected,
        "int8_kernels": kv == expected_int8,
        "no_plain_calls": rec["plain_attention_calls"] == 0,
    }
    rec.update(expected_variants=expected, expected_int8_launches=expected_int8, gates=gates)
    ok = all(gates.values())
    log(f"phase 23: int8 serving tier {'ok' if ok else 'FAIL'} (gates {gates}; K1 by variant "
        f"{rec['flash_fwd_variants']} vs {expected}; int8 kernels {kv} vs {expected_int8}; "
        f"tokens/s {rec['tokens_per_s']}, TTFT p50 {rec['ttft_ms_p50']} ms, peak above start "
        f"{rec['peak_above_start_bytes']} B, prefix hit rate {rec['prefix_hit_rate']}, decode "
        f"steps {rec['decode_steps']}, verify steps {rec['verify_steps']})")
    return ok, rec


def phase_kv_int8(torch, fa, attn) -> tuple:
    """Phase 23, the int8 KV cache: (a) both kernels against their plain
    versions at every built head dim (:func:`check_quantized_write`, bit
    for bit; :func:`check_int8_decode`, within ``TOL``), and both timed at
    the serving and rollout decode shapes (:func:`time_int8`); (b) the
    threshold sweep (:func:`int8_sweep`); (c) the int8 serving tier
    (:func:`int8_serving_tier`). Returns ``(ok, record)``."""
    checks = []
    for D in fa.HEAD_DIMS:
        H = KV_INT8_HEADS[D]
        checks.append(check_quantized_write(torch, fa, D, H, seed=D))
        for B, K in ((8, 576), (16, 112), (4, 65)):
            checks.append(check_int8_decode(torch, fa, attn, D, H, B, K, seed=D * 1000 + K))
    for c in checks:
        log(f"phase 23: check {json.dumps(c)}")
    timed = {name: time_int8(torch, fa, attn, B, K) for name, (B, K) in KV_INT8_TIMED.items()}
    for name, t in timed.items():
        log(f"phase 23: time {name} decode_int8 {json.dumps(t['decode'])}")
        log(f"phase 23: time {name} kv_quant {json.dumps(t['write'])}")
    checks_ok = all(c["ok"] for c in checks) and all(
        t["decode"]["packed_ok"] for t in timed.values())
    sweep = int8_sweep(torch, fa)
    tier_ok, tier = int8_serving_tier(torch, fa)
    sweep_ok = all(r["finite"] for r in sweep["rows"].values())
    ok = checks_ok and sweep_ok and tier_ok
    log(f"phase 23: kv int8 {'ok' if ok else 'FAIL'} (kernel checks {checks_ok}, "
        f"{sum(c['ok'] for c in checks)}/{len(checks)}; sweep finite {sweep_ok}; serving "
        f"tier {tier_ok})")
    return ok, {"checks": checks, "timed": timed, "sweep": sweep, "serving_tier": tier}


# phase 24: the resilience layer's scenarios at full GPT-2-small width
RESILIENCE_UPDATES = 64  # two passes of ppo_sentiments.yml's 128 // 16 minibatches x 4 epochs
RESILIENCE_PASS = 32  # one pass: (b), (e) with (f), and (d)'s drain point
RESILIENCE_ILQL_UPDATES = 16  # one epoch of phase 8's 2048 samples at batch 128
RESILIENCE_ILQL_CHUNK = 8  # eval_interval: the JAX trainer's chunk boundary, the drain point
RESILIENCE_RETRY = {"max_attempts": 4, "base_delay_s": 0.01, "max_delay_s": 0.05}
RESILIENCE_PEAK_RATIO = 1.1  # the resumed attempt's peak against the uninterrupted run's
# from the drain point on (the same work: the second pass and the end save)
RESILIENCE_START_MARGIN_BYTES = 4 << 20  # a resumed attempt's start over the first's: less
# than any GPT-2 small weight matrix in f32, so a leaked trainer cannot hide in it
PREEMPT_AT_FIRST_BOUNDARY = [{"site": "preempt", "mode": "preempt", "phase": 0}]


def resilience_ppo_config(checkpoint_dir: str, updates: int = RESILIENCE_UPDATES,
                          model=None, **train):
    """Phase 5's ``configs/ppo_sentiments.yml`` run cut to ``updates``;
    ``model`` and ``train`` update those sections."""
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = training_config(checkpoint_dir, total_steps=updates, **train).to_dict()
    cfg["model"].update(model or {})
    return TRLConfig.from_dict(cfg)


def resilience_ilql_config(checkpoint_dir: str, **train):
    """Phase 8's ``configs/ilql_sentiments.yml`` run at GPT-2 small's width
    with random weights, cut to one epoch with an eval (and so a chunk
    boundary) halfway."""
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = ilql_config(checkpoint_dir).to_dict()
    cfg["train"].update(total_steps=RESILIENCE_ILQL_UPDATES, eval_interval=RESILIENCE_ILQL_CHUNK,
                        checkpoint_interval=RESILIENCE_ILQL_UPDATES, **train)
    return TRLConfig.from_dict(cfg)


def resumable_state(torch, trainer) -> dict:
    """Host copies of what a resumed run must reproduce: every parameter,
    Adam moment and (ILQL) target head, the sampling generator, and the
    update, optimizer and KL counters."""
    opt = trainer.opt.state_dict()
    tensors = {f"model.{n}": t for n, t in trainer.model.state_dict().items()}
    tensors.update({f"adam.{i}.{k}": v for i, st in opt["adamw"]["state"].items()
                    for k, v in st.items()})
    if hasattr(trainer, "target"):
        tensors.update({f"target.{n}": t for n, t in trainer.target.state_dict().items()})
    tensors = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
    tensors["generator"] = trainer.generator.get_state()
    return {"tensors": tensors, "counters": (trainer.step, opt["count"],
                                             getattr(trainer, "kl_coef", None),
                                             getattr(trainer, "mean_kl", None))}


def state_difference(torch, got: dict, want: dict, skip=()) -> dict:
    """Whether two :func:`resumable_state` records are equal bit for bit
    (but for the keys in ``skip``), the keys that differ and their largest
    difference."""
    keys = [k for k in want["tensors"] if k not in skip]
    differ = [k for k in keys if k not in got["tensors"]
              or not torch.equal(got["tensors"][k], want["tensors"][k])]
    max_diff = max((float((got["tensors"][k].double() - want["tensors"][k].double()).abs().max())
                    for k in differ if k in got["tensors"] and k != "generator"
                    and got["tensors"][k].shape == want["tensors"][k].shape), default=0.0)
    equal = (not differ and set(got["tensors"]) - set(skip) == set(keys)
             and got["counters"] == want["counters"])
    return {"equal": equal, "tensors": len(keys), "differing": len(differ),
            "first_differing": differ[:5], "max_abs_diff": max_diff,
            "counters": [got["counters"], want["counters"]]}


def supervised_path(torch, fa, cls, run, extra_patches=(), split_peak_at=None):
    """``run()`` (a ``trlx_tpu_torch.train`` call) as one counted path with
    the supervisor's attempts, the drain, the load and the first update
    after it timed on the host clock (after a synchronise): returns
    ``(trainer or the exception raised, record, timeline)``. Each attempt's
    peak is read from its own start (the counter reset, nothing freed);
    with ``split_peak_at``, the attempt's peak from the drain point at
    that step on is read apart as ``peak_after_split_bytes``."""
    from trlx_tpu_torch import api
    from trlx_tpu_torch.resilience.preemption import PreemptionDrain
    from trlx_tpu_torch.trainer import BaseRLTrainer

    line = {"attempts": [], "drains": [], "loads": [], "first_update_after_load": None}
    supervised, drain = api.run_supervised, BaseRLTrainer.maybe_drain
    load, train_step = cls.load, cls.train_step

    def run_supervised(attempt, config):
        def timed(resume):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            entry = {"resume": resume, "allocated_at_start_bytes": torch.cuda.memory_allocated(),
                     "start": time.perf_counter()}
            line["attempts"].append(entry)
            try:
                return attempt(resume)
            finally:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                before = entry.pop("peak_before_split_bytes", None)
                entry.update(end=time.perf_counter(), peak_bytes=max(peak, before or 0))
                if before is not None:
                    entry["peak_after_split_bytes"] = peak
        return supervised(timed, config)

    def maybe_drain(self, phase=None, step=None):
        entry = line["attempts"][-1]
        if step == split_peak_at and "peak_before_split_bytes" not in entry:
            torch.cuda.synchronize()
            entry["peak_before_split_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return drain(self, phase, step)
        except PreemptionDrain:
            line["drains"].append({"start": t0, "end": time.perf_counter(), "step": step,
                                   "forwards": self.forwards})
            raise

    def timed_load(self, directory):
        t0 = time.perf_counter()
        out = load(self, directory)
        torch.cuda.synchronize()
        line["loads"].append((t0, time.perf_counter()))
        return out

    def first_update(self, mb):
        if line["loads"] and line["first_update_after_load"] is None:
            torch.cuda.synchronize()
            line["first_update_after_load"] = time.perf_counter()
        return train_step(self, mb)

    def guarded():
        try:
            return run()
        except Exception as e:  # the scenario's own gates judge it
            return e

    out, record = counted_path(torch, fa, guarded, patches=[
        (api, "run_supervised", run_supervised), (BaseRLTrainer, "maybe_drain", maybe_drain),
        (cls, "load", timed_load), (cls, "train_step", first_update), *extra_patches])
    return out, record, line


def recovery_times(line) -> dict:
    """The drain-to-first-update split of a resumed run (host clock, s)."""
    drain, resumed = line["drains"][0], line["attempts"][1]
    load_start, load_end = line["loads"][0]
    first = line["first_update_after_load"]
    return {"time_to_recover_s": first - drain["start"],
            "emergency_write_s": drain["end"] - drain["start"],
            "restart_s": resumed["start"] - drain["end"],
            "rebuild_s": load_start - resumed["start"], "load_s": load_end - load_start,
            "collect_before_first_update_s": first - load_end}


def resumed_path_gates(record, line, trainer, updates: int) -> dict:
    """A resumed run's launches across both attempts: K2 = K3 ``tile`` = 12
    x updates, K1 = 12 x both trainers' forwards; no ``fma``, input copy or
    plain call."""
    forwards = line["drains"][0]["forwards"] + trainer.forwards
    expected = {"flash_fwd": N_LAYER * forwards, "flash_bwd_dq": N_LAYER * updates,
                "flash_bwd_dkv": N_LAYER * updates}
    got = {k: record["launches"][k] for k in expected}
    bwd = {k: {"tile": N_LAYER * updates, "fma": 0} for k in BWD_KERNELS}
    return {"launches": got, "expected_launches": expected,
            "ok": (got == expected and record["backward_variants"] == bwd
                   and record["flash_fwd_variants"]["fma"] == 0
                   and record["flash_fwd_variants"]["copies"] == 0
                   and record["backward_copies"] == 0 and record["plain_attention_calls"] == 0)}


def attempts_summary(line) -> list:
    return [{k: a[k] for k in ("resume", "allocated_at_start_bytes", "peak_bytes",
                               "peak_after_split_bytes") if k in a}
            | {"seconds": a["end"] - a["start"]} for a in line["attempts"]]


def memory_gates(line, uninterrupted_line) -> dict:
    """The card holds one trainer across a restart: the resumed attempt
    starts with what the first attempt started with (within
    ``RESILIENCE_START_MARGIN_BYTES``), and peaks at most
    ``RESILIENCE_PEAK_RATIO`` times the uninterrupted run's peak over the
    same work (from the drain point on)."""
    first, resumed = line["attempts"][0], line["attempts"][1]
    same_work = uninterrupted_line["attempts"][0]["peak_after_split_bytes"]
    record = {"start_over_first_bytes": resumed["allocated_at_start_bytes"]
              - first["allocated_at_start_bytes"],
              "uninterrupted_peak_after_drain_point_bytes": same_work,
              "resumed_peak_ratio": resumed["peak_bytes"] / same_work}
    record["ok"] = (record["start_over_first_bytes"] <= RESILIENCE_START_MARGIN_BYTES
                    and record["resumed_peak_ratio"] <= RESILIENCE_PEAK_RATIO)
    return record


def phase_resilience(torch, fa):
    """Phase 24: the six scenarios (a)-(f) through ``trlx_tpu_torch.train``
    at full width, each gated, with the handlers checked after each.
    Returns ``(ok, {"paths": counted paths, "scenarios": records})``."""
    import signal
    import tempfile

    import trlx_tpu_torch
    from trlx_tpu_torch.resilience import chaos, preemption
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils import checkpoint as ckpt
    from trlx_tpu_torch.utils.async_writer import BackgroundJSONLWriter
    from trlx_tpu_torch.utils.retry import reset_retry_log, retry_log

    handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    prompts = training_prompts()
    scenarios, paths = {}, {}

    def ppo(config):
        return lambda: trlx_tpu_torch.train(reward_fn=training_reward, prompts=prompts,
                                            config=config)

    def ilql(config):
        samples, rewards = ilql_dataset()
        return lambda: trlx_tpu_torch.train(dataset=(samples, rewards), config=config)

    def report(name, record, ok):
        restored = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == handlers
        clean = not chaos.active() and preemption._guard is None
        record.update(handlers_restored=restored, chaos_cleared=clean)
        record["ok"] = bool(ok and restored and clean)
        scenarios[name] = record
        log("phase 24: resilience " + json.dumps({"scenario": name, **record}, default=str))
        reset_retry_log()
        return record["ok"]

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        def run_dir(name):
            return os.path.join(tmp, name)

        # (d)'s uninterrupted run, resilience off, synchronous saves
        plain, plain_rec, plain_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(run_dir("plain"))),
            split_peak_at=RESILIENCE_PASS)
        plain_ok = (isinstance(plain, PPOTrainer) and plain.step == RESILIENCE_UPDATES
                    and "peak_after_split_bytes" in plain_line["attempts"][0])
        plain_state = resumable_state(torch, plain) if plain_ok else None
        plain_peak = plain_line["attempts"][0]["peak_bytes"]
        del plain

        # (a) clean: resilience on, no chaos; its state at update 32 for (b)
        at_boundary = {}
        collect = PPOTrainer._collect_phase

        def snapshot_collect(self, iter_count, seed):
            if iter_count == RESILIENCE_PASS and not at_boundary:
                at_boundary.update(resumable_state(torch, self))
            return collect(self, iter_count, seed)

        clean, clean_rec, clean_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(
                run_dir("a"), resilience={"enabled": True})),
            extra_patches=[(PPOTrainer, "_collect_phase", snapshot_collect)])
        clean_done = isinstance(clean, PPOTrainer) and plain_ok
        diff = state_difference(torch, resumable_state(torch, clean), plain_state) \
            if clean_done else None
        record = {"updates": getattr(clean, "step", None), "error": None if clean_done else
                  repr(clean), "attempts": attempts_summary(clean_line),
                  "chaos_events": len(chaos.events()), "retries": len(retry_log),
                  "equal_to_resilience_off": diff, "wall_s": clean_rec["wall_s"],
                  "resilience_off_wall_s": plain_rec["wall_s"]}
        del clean
        if clean_done and not diff["equal"]:
            # tell nondeterminism from an effect of the supervisor
            again, _, _ = supervised_path(
                torch, fa, PPOTrainer, ppo(resilience_ppo_config(run_dir("plain_again"))))
            record["resilience_off_repeat"] = state_difference(
                torch, resumable_state(torch, again), plain_state)
            del again
        ok &= report("a_clean", record, clean_done and diff["equal"]
                     and len(clean_line["attempts"]) == 1 and not record["retries"])

        # (d) preempt / resume parity: a real SIGTERM at the first boundary
        resumed, res_rec, res_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(
                run_dir("d"), async_checkpoint=True,
                resilience={"enabled": True, "chaos": PREEMPT_AT_FIRST_BOUNDARY})))
        done = (isinstance(resumed, PPOTrainer) and plain_ok and len(res_line["drains"]) == 1
                and len(res_line["attempts"]) == 2 and bool(res_line["loads"]))
        record = {"updates": getattr(resumed, "step", None),
                  "error": None if isinstance(resumed, PPOTrainer) else repr(resumed),
                  "attempts": attempts_summary(res_line), "drains": res_line["drains"],
                  "uninterrupted_peak_bytes": plain_peak}
        if done:
            record["equal_to_uninterrupted"] = state_difference(
                torch, resumable_state(torch, resumed), plain_state)
            record.update(recovery_times(res_line))
            record["memory_gates"] = memory_gates(res_line, plain_line)
            gates = resumed_path_gates(res_rec, res_line, resumed, RESILIENCE_UPDATES)
            record["launch_gates"] = gates
            paths["resilience_ppo_resumed"] = res_rec
            record["resumed_device"] = str(resumed.device)  # device=None: CUDA on restart too
            done = (record["equal_to_uninterrupted"]["equal"] and res_line["drains"][0]["step"]
                    == RESILIENCE_PASS and res_line["attempts"][1]["resume"] and gates["ok"]
                    and record["memory_gates"]["ok"] and resumed.device.type == "cuda")
        del resumed, plain_state
        ok &= report("d_preempt_resume_ppo", record, done)

        # (d) for ILQL: uninterrupted, then preempted at the first chunk
        iplain, _, iplain_line = supervised_path(
            torch, fa, ILQLTrainer, ilql(resilience_ilql_config(run_dir("ilql_plain"))),
            split_peak_at=RESILIENCE_ILQL_CHUNK)
        iplain_ok = (isinstance(iplain, ILQLTrainer) and iplain.step == RESILIENCE_ILQL_UPDATES
                     and "peak_after_split_bytes" in iplain_line["attempts"][0])
        iplain_state = resumable_state(torch, iplain) if iplain_ok else None
        iplain_peak = iplain_line["attempts"][0]["peak_bytes"]
        del iplain
        iresumed, ires_rec, ires_line = supervised_path(
            torch, fa, ILQLTrainer, ilql(resilience_ilql_config(
                run_dir("ilql_d"), async_checkpoint=True,
                resilience={"enabled": True, "chaos": PREEMPT_AT_FIRST_BOUNDARY})))
        done = (isinstance(iresumed, ILQLTrainer) and iplain_ok
                and len(ires_line["drains"]) == 1 and len(ires_line["attempts"]) == 2
                and bool(ires_line["loads"]))
        record = {"updates": getattr(iresumed, "step", None),
                  "error": None if isinstance(iresumed, ILQLTrainer) else repr(iresumed),
                  "attempts": attempts_summary(ires_line), "drains": ires_line["drains"],
                  "uninterrupted_peak_bytes": iplain_peak}
        if done:
            record["equal_to_uninterrupted"] = state_difference(
                torch, resumable_state(torch, iresumed), iplain_state)
            record.update(recovery_times(ires_line))
            record["memory_gates"] = memory_gates(ires_line, iplain_line)
            gates = resumed_path_gates(ires_rec, ires_line, iresumed, RESILIENCE_ILQL_UPDATES)
            record["launch_gates"] = gates
            paths["resilience_ilql_resumed"] = ires_rec
            done = (record["equal_to_uninterrupted"]["equal"] and ires_line["drains"][0]["step"]
                    == RESILIENCE_ILQL_CHUNK and gates["ok"] and record["memory_gates"]["ok"])
        del iresumed, iplain_state
        ok &= report("d_preempt_resume_ilql", record, done)

        # (b) transient checkpoint I/O: the end save fails twice, on the
        # writer thread, and lands; the state is (a)'s at update 32
        flaky, flaky_rec, flaky_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(
                run_dir("b"), RESILIENCE_PASS, async_checkpoint=True,
                resilience={"enabled": True, "retry": RESILIENCE_RETRY, "chaos": [
                    {"site": "checkpoint.save", "mode": "error", "count": 2}]})))
        retries = [r["what"] for r in retry_log if "checkpoint save" in r["what"]]
        done = isinstance(flaky, PPOTrainer) and bool(at_boundary)
        record = {"updates": getattr(flaky, "step", None), "save_retries": len(retries),
                  "error": None if isinstance(flaky, PPOTrainer) else repr(flaky),
                  "attempts": attempts_summary(flaky_line),
                  "steps_on_disk": ckpt.all_steps(run_dir("b")), "wall_s": flaky_rec["wall_s"]}
        if done:
            # its generator drew the final eval after the save
            record["equal_to_clean_at_32"] = state_difference(
                torch, resumable_state(torch, flaky), at_boundary, skip=("generator",))
            done = (record["equal_to_clean_at_32"]["equal"] and len(retries) == 2
                    and record["steps_on_disk"] == [RESILIENCE_PASS]
                    and len(flaky_line["attempts"]) == 1)
        del flaky
        at_boundary.clear()
        ok &= report("b_transient_checkpoint_io", record, done)

        # (c) a permanent layout mismatch refuses at once
        frozen = resilience_ppo_config(run_dir("c"), model={"num_layers_unfrozen": 2})
        PPOTrainer(frozen).save()
        t0 = time.perf_counter()
        refused, refused_rec, refused_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(
                run_dir("c"), RESILIENCE_PASS, resume_from_checkpoint=True,
                resilience={"enabled": True, "retry": RESILIENCE_RETRY})))
        refusal_s = time.perf_counter() - t0
        record = {"error": repr(refused)[:300], "refusal_s": refusal_s,
                  "retries": len(retry_log), "attempts": attempts_summary(refused_line),
                  "load_s": [e - s for s, e in refused_line["loads"]]}
        ok &= report("c_permanent_mismatch", record, (
            isinstance(refused, ValueError) and "num_layers_unfrozen" in str(refused)
            and not retry_log and len(refused_line["attempts"]) == 1))
        del refused

        # (e) and (f) in one pass: the continuous engine fails at
        # admission (the fixed sampler takes over) and the rollout log's
        # disk fills three times (the writer degrades)
        writers, submitted = [], []
        init, submit = BackgroundJSONLWriter.__init__, BackgroundJSONLWriter.submit

        def recording_init(self, *a, **kw):
            writers.append(self)
            init(self, *a, **kw)

        def recording_submit(self, path, rows):
            submitted.extend(rows)
            return submit(self, path, rows)

        log_dir = run_dir("rollouts")
        degraded, _, ef_line = supervised_path(
            torch, fa, PPOTrainer, ppo(resilience_ppo_config(
                run_dir("ef"), RESILIENCE_PASS, rollout={"engine": "continuous"},
                rollout_logging_dir=log_dir,
                health={"enabled": True, "dump_dir": run_dir("ef_dumps")},
                resilience={"enabled": True, "chaos": [
                    {"site": "engine.admit", "mode": "permanent"},
                    {"site": "writer.write", "mode": "disk_full", "count": 3}]})),
            extra_patches=[(BackgroundJSONLWriter, "__init__", recording_init),
                           (BackgroundJSONLWriter, "submit", recording_submit)])
        done = isinstance(degraded, PPOTrainer)
        shared = {"updates": getattr(degraded, "step", None),
                  "attempts": attempts_summary(ef_line),
                  "error": None if done else repr(degraded), "shares_the_pass_of": None}
        counts = degraded.health_monitor.event_counts if done else {}
        record = dict(shared, engine_after=getattr(degraded, "rollout_engine", None),
                      fallback_events=counts.get("engine-fallback", 0),
                      shares_the_pass_of="f_writer_disk_full")
        ok &= report("e_engine_fallback", record, (
            done and degraded.step == RESILIENCE_PASS and degraded.rollout_engine == "fixed"
            and record["fallback_events"] == 1 and len(ef_line["attempts"]) == 1))
        on_disk = []
        for root, _, files in sorted(os.walk(log_dir)):
            for name in sorted(files):
                with open(os.path.join(root, name)) as f:
                    on_disk += [json.loads(line) for line in f]
        record = dict(shared, rows_submitted=len(submitted), rows_on_disk=len(on_disk),
                      in_order=on_disk == submitted, degraded=[w.degraded for w in writers],
                      shares_the_pass_of="e_engine_fallback")
        ok &= report("f_writer_disk_full", record, (
            done and on_disk == submitted and len(on_disk) == 128
            and record["degraded"] == [True]))
        del degraded
    log(f"phase 24: resilience {'ok' if ok else 'FAIL'} ("
        + ", ".join(f"{n} {'ok' if r['ok'] else 'FAIL'}" for n, r in scenarios.items()) + ")")
    return bool(ok), {"paths": paths, "scenarios": scenarios}


# phase 25: the asynchronous actor-learner on configs/ppo_async_sentiments.yml
ASYNC_YML = "ppo_async_sentiments.yml"
ASYNC_UPDATES = 64  # two passes of 128 // 16 = 8 minibatches x 4 epochs
ASYNC_PASS = 32
# (b) and (c) run one pass three and two ways, (d) two passes and a replay
ASYNC_PARITY_RUNS = {"staleness_window_0": ({"staleness_window": 0}, None),
                     "serial_overlap_false": ({}, False),
                     "overlap_without_async": (None, None)}


def overlap_watch(cls, watch):
    """A patch of ``cls.finish_streamed_phase`` keeping each phase's
    ``exp/overlap_*`` and ``async/*`` stats (``watch["overlap"]``)."""
    finish = cls.finish_streamed_phase
    watch["overlap"] = []

    def finish_streamed_phase(self):
        out = finish(self)
        watch["overlap"].append(dict(self._last_overlap_stats))
        return out

    return [(cls, "finish_streamed_phase", finish_streamed_phase)]


def update_watch(cls, watch):
    """A patch of ``cls.train_step`` counting the updates
    (``watch["updates"]``): a streamed phase runs its epoch-1 updates
    inside the collection, whose K1 ``tile`` count their forwards join."""
    step = cls.train_step
    watch["updates"] = 0

    def train_step(self, mb):
        watch["updates"] += 1
        return step(self, mb)

    return [(cls, "train_step", train_step)]


def async_phase_run(torch, config, prompts, reward, overlap=None):
    """One streamed phase of ``config`` through the phase API, off every
    counted path: ``begin_streamed_phase`` (plan seed ``train.seed``), the
    orchestrator's collection, ``finish_streamed_phase``. Returns the
    parameters (on the card), the stats rows, the KL sequence, the phase's
    stats and the engine's weight pushes (None on the fixed sampler)."""
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline

    trainer = PPOTrainer(config)
    pipeline = get_pipeline("PromptPipeline")(prompts, trainer.query_length)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=reward,
                                              chunk_size=config.method.chunk_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.begin_streamed_phase(seed=config.train.seed, overlap=overlap)
    orch.make_experience(config.method.num_rollouts, 0)
    n_up, rows, kl_seq = trainer.finish_streamed_phase()
    torch.cuda.synchronize()
    engine = trainer._rollout_engine_obj
    out = {"params": {n: p.detach().clone() for n, p in trainer.model.state_dict().items()},
           "rows": rows, "kl_seq": kl_seq, "n_up": n_up,
           "stats": dict(trainer._last_overlap_stats), "wall_s": time.perf_counter() - t0,
           "engine_weight_pushes": engine.stats.weight_pushes if engine is not None else None}
    orch.close()
    del trainer, orch, engine
    torch.cuda.empty_cache()
    return out


def runs_equal(torch, a, b) -> dict:
    """Parameters, the KL sequence and every stats row ``torch.equal``."""
    import numpy as np

    params = [n for n, p in a["params"].items() if not torch.equal(p, b["params"][n])]
    rows = [k for k in a["rows"] if k not in b["rows"]
            or not np.array_equal(a["rows"][k], b["rows"][k])]
    return {"equal": not params and not rows and a["kl_seq"] == b["kl_seq"]
            and a["n_up"] == b["n_up"] and set(a["rows"]) == set(b["rows"]),
            "differing_params": params[:5], "differing_rows": rows[:5],
            "kl_seq_equal": a["kl_seq"] == b["kl_seq"]}


def phase_async(torch, fa):
    """Phase 25: ``configs/ppo_async_sentiments.yml`` (the continuous
    engine, ``async_rl`` at ``staleness_window: 1``, health, resilience)
    from a GPT-2-small checkpoint written here: (a) as written through
    ``trlx_tpu_torch.train``, two passes (64 updates): finite stats,
    moved parameters, weights pushed in every phase, ``async/
    staleness_max`` <= 1, no ``staleness-breach`` event, K1 by variant as
    phase 10 counts it, K2 = K3 = 12 x 64 ``tile``, no ``fma`` launch,
    input copy or plain call; (b) one pass at the yml's shapes three ways,
    ``staleness_window: 0``, ``overlap=False`` and ``phase_overlap``
    without async: ``torch.equal`` parameters, KL sequence and stats rows,
    no weight push; (c) one pass of phase 5's fixed-sampler geometry
    overlapped and serial: ``torch.equal``, epoch-1 updates run during
    collection; (d) the ``engine.admit`` fault at the second pass's first
    admission under async: one ``actor-dead`` event, an
    ``ActorDeadError``, the supervisor's restart from the pass-boundary
    checkpoint (``checkpoint_interval: 32``) and the run's end, with the
    time to recover and the launches across both attempts. Returns ``(ok,
    {"paths": counted paths, ...})``."""
    import math
    import tempfile

    import numpy as np

    import trlx_tpu_torch
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.resilience import chaos
    from trlx_tpu_torch.trainer.async_rl import ActorDeadError
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    log("phase 25: async actor-learner PPO on configs/ppo_async_sentiments.yml; deviations: "
        + json.dumps([{"setting": k, "yml": y, "port": p, "why": why}
                      for k, y, p, why in GPT2_RUN_DEVIATIONS]))
    prompts, out, ok = training_prompts(), {"paths": {}}, True
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt2")
        written = write_gpt2_checkpoint(torch, ckpt, seed=25)

        # (a) the yml as written
        watch = {"decode_forwards": 0}
        apply = PPOTrainer._apply

        def counted_apply(self, input_ids, *a, **kw):
            watch["decode_forwards"] += input_ids.shape[1] <= 16  # the engine's decode steps
            return apply(self, input_ids, *a, **kw)

        run_dir = os.path.join(tmp, "a")
        config = yml_config(ASYNC_YML, run_dir, ckpt, ASYNC_UPDATES)
        patches = (instrument(torch, PPOTrainer, "transformer", written, watch)
                   + overlap_watch(PPOTrainer, watch)
                   + [(PPOTrainer, "_apply", counted_apply)])
        trainer, record = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
            reward_fn=training_reward, prompts=prompts, config=config), patches)
        gates = run_gates(torch, trainer, watch, record)
        events = dict(trainer.health_monitor.event_counts)
        expected = {
            "variants": {"tile": N_LAYER * (trainer.forwards - watch["decode_forwards"]),
                         "decode": N_LAYER * watch["decode_forwards"], "fma": 0, "copies": 0},
            "backward": {k: {"tile": N_LAYER * ASYNC_UPDATES, "fma": 0} for k in BWD_KERNELS},
        }
        overlap = watch["overlap"]
        stats_ok = (len(overlap) == 2
                    and all(p["async/weight_pushes"] > 0 and p["async/staleness_max"] <= 1
                            and all(math.isfinite(v) for v in p.values()) for p in overlap))
        record.update(updates=trainer.step, phases=phase_rows(trainer), evals=watch["evals"],
                      overlap=overlap, health_events=events, gates=gates,
                      forwards=trainer.forwards, decode_forwards=watch["decode_forwards"],
                      expected=expected, async_config=vars(trainer.async_config),
                      engine=trainer.rollout_engine_obj.stats.to_dict())
        a_ok = (
            trainer.step == ASYNC_UPDATES and len(watch["rows"]) == 2 and stats_ok
            and trainer.async_config.enabled and trainer.async_config.staleness_window == 1
            and all(v for k, v in gates.items() if k != "params_changed")
            and gates["params_changed"] > 0 and "staleness-breach" not in events
            and record["flash_fwd_variants"] == expected["variants"]
            and record["backward_variants"] == expected["backward"])
        log("phase 25: (a) async yml " + json.dumps(record))
        log(f"phase 25: (a) async yml {'ok' if a_ok else 'FAIL'} (updates={trainer.step}, "
            f"gates {gates}, per phase async/exp stats {overlap}, health events {events}, "
            f"phases {record['phases']}, K1 by variant {record['flash_fwd_variants']} vs "
            f"{expected['variants']}, K2/K3 by variant {record['backward_variants']} vs "
            f"{expected['backward']})")
        out["paths"]["async_yml"], out["a"], ok = record, record, ok and a_ok
        del trainer
        torch.cuda.empty_cache()

        # (b) one pass at the yml's shapes, three ways
        runs = {}
        for name, (async_rl, overlap_arg) in ASYNC_PARITY_RUNS.items():
            cfg = yml_config(ASYNC_YML, os.path.join(tmp, "b_" + name), ckpt, ASYNC_PASS)
            section = cfg.train.training["async_rl"]
            cfg.train.training["async_rl"] = (
                {"enabled": False} if async_rl is None else dict(section, **async_rl))
            runs[name] = async_phase_run(torch, cfg, prompts, training_reward, overlap_arg)
        base = runs["staleness_window_0"]
        compare = {n: runs_equal(torch, base, r) for n, r in runs.items() if r is not base}
        pushes = {n: [r["engine_weight_pushes"], r["stats"].get("async/weight_pushes")]
                  for n, r in runs.items()}
        b_ok = (all(c["equal"] for c in compare.values())
                and all(p[0] == 0 and p[1] in (0.0, None) for p in pushes.values())
                and base["n_up"] == ASYNC_PASS
                and runs["overlap_without_async"]["stats"]["exp/overlap_streamed_updates"] > 0)
        b_record = {"compare_to_staleness_window_0": compare, "weight_pushes": pushes,
                    "stats": {n: r["stats"] for n, r in runs.items()},
                    "wall_s": {n: r["wall_s"] for n, r in runs.items()}}
        log(f"phase 25: (b) serial parity {'ok' if b_ok else 'FAIL'} " + json.dumps(b_record))
        out["b"], ok = b_record, ok and b_ok
        del runs, base

        # (c) phase 5's fixed sampler, overlapped against serial
        runs = {name: async_phase_run(torch, training_config(
                    os.path.join(tmp, "c_" + name), total_steps=ASYNC_PASS),
                    prompts, training_reward, overlap_arg)
                for name, overlap_arg in (("overlapped", None), ("serial", False))}
        c_compare = runs_equal(torch, runs["overlapped"], runs["serial"])
        streamed = runs["overlapped"]["stats"]["exp/overlap_streamed_updates"]
        c_ok = (c_compare["equal"] and streamed > 0
                and runs["serial"]["stats"]["exp/overlap_streamed_updates"] == 0)
        c_record = {"compare": c_compare, "stats": {n: r["stats"] for n, r in runs.items()},
                    "wall_s": {n: r["wall_s"] for n, r in runs.items()}}
        log(f"phase 25: (c) fixed sampler overlap {'ok' if c_ok else 'FAIL'} "
            + json.dumps(c_record))
        out["c"], ok = c_record, ok and c_ok
        del runs

        # (d) a dead actor at the second pass's first admission
        deaths, collect, dead = [], PPOTrainer._collect_phase, PPOOrchestrator._actor_dead

        def arming_collect(self, iter_count, seed):
            if iter_count == ASYNC_PASS and not deaths:
                chaos.configure([{"site": "engine.admit", "mode": "error", "count": 1}])
            return collect(self, iter_count, seed)

        def actor_dead(self, error, iter_count):
            tr = self.trainer
            try:
                dead(self, error, iter_count)
            except ActorDeadError as e:
                deaths.append({"error": repr(e)[:200], "iter_count": iter_count,
                               "events": dict(tr.health_monitor.event_counts),
                               "engine": tr.rollout_engine, "forwards": tr.forwards,
                               "step": tr.step, "at": time.perf_counter()})
                raise

        d_config = yml_config(ASYNC_YML, os.path.join(tmp, "d"), ckpt, ASYNC_UPDATES, train={
            "checkpoint_interval": ASYNC_PASS,  # the restart's checkpoint, at the boundary
            "health": {"enabled": True, "dump_dir": os.path.join(tmp, "d_dumps")}})
        resumed, d_rec, line = supervised_path(
            torch, fa, PPOTrainer, lambda: trlx_tpu_torch.train(
                reward_fn=training_reward, prompts=prompts, config=d_config),
            extra_patches=[(PPOTrainer, "_collect_phase", arming_collect),
                           (PPOOrchestrator, "_actor_dead", actor_dead)])
        chaos.clear()
        done = isinstance(resumed, PPOTrainer) and len(deaths) == 1
        d_record = {"updates": getattr(resumed, "step", None), "deaths": deaths,
                    "error": None if isinstance(resumed, PPOTrainer) else repr(resumed),
                    "attempts": attempts_summary(line), "wall_s": d_rec["wall_s"]}
        if done:
            death = deaths[0]
            forwards = death["forwards"] + resumed.forwards
            expected = {"flash_fwd": N_LAYER * forwards, "flash_bwd_dq": N_LAYER * ASYNC_UPDATES,
                        "flash_bwd_dkv": N_LAYER * ASYNC_UPDATES}
            got = {k: d_rec["launches"][k] for k in expected}
            bwd = {k: {"tile": N_LAYER * ASYNC_UPDATES, "fma": 0} for k in BWD_KERNELS}
            load_start, load_end = line["loads"][0] if line["loads"] else (None, None)
            first = line["first_update_after_load"]
            d_record.update(
                launches=got, expected_launches=expected,
                # from the failure to the resumed attempt's first update
                time_to_recover_s=(first - death["at"]) if first else None,
                restart_s=line["attempts"][1]["start"] - line["attempts"][0]["end"],
                load_s=(load_end - load_start) if line["loads"] else None,
                collect_before_first_update_s=(first - load_end) if first and load_end
                else None)
            out["paths"]["async_dead_actor"] = d_rec
            # the detectors may trip on random weights too (a kl-spike):
            # the gate is the one actor-dead event
            done = (resumed.step == ASYNC_UPDATES and death["events"].get("actor-dead") == 1
                    and death["engine"] == "continuous" and death["step"] == ASYNC_PASS
                    and len(line["attempts"]) == 2 and line["attempts"][1]["resume"]
                    and bool(line["loads"]) and got == expected
                    and d_rec["backward_variants"] == bwd
                    and d_rec["flash_fwd_variants"]["fma"] == 0
                    and d_rec["flash_fwd_variants"]["copies"] == 0
                    and d_rec["backward_copies"] == 0 and d_rec["plain_attention_calls"] == 0
                    and resumed.rollout_engine == "continuous")
        log(f"phase 25: (d) dead actor {'ok' if done else 'FAIL'} "
            + json.dumps(d_record, default=str))
        out["d"], ok = d_record, ok and done
        del resumed
        torch.cuda.empty_cache()
    log(f"phase 25: async rl {'ok' if ok else 'FAIL'} (a {a_ok}, b {b_ok}, c {c_ok}, "
        f"d {done})")
    return bool(ok), out


# half of one collect of configs/ppo_sentiments.yml (128 // 16 minibatches x
# 4 epochs = 32 updates), to keep the smoke's phase walls under 1000 s
MOMENT_UPDATES = 16
SR_DRAWS = 4096  # tests/test_optimizer_precision.py's unbiasedness draws
SR_VALUES = (1.0 + 2 ** -9, -3.7e-4, 0.123456, 5.0e5, -1.0 - 2 ** -10)
SWEEP_YML = "ppo_randomwalks_sweep.yml"
SWEEP_UPDATES = 200  # configs/ppo_randomwalks.yml's total_steps
SWEEP_TRIALS = 4  # the sweep yml's num_samples


def event_timer(torch, owner, name: str, events: list):
    """A patch (for ``counted_path``) putting each call of ``owner.name``
    between two CUDA events, appended to ``events`` (read after the run)."""
    fn = getattr(owner, name)

    def timed(self, *a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(self, *a, **kw)
        end.record()
        events.append((start, end))
        return out

    return (owner, name, timed)


def optimizer_probe(torch, owner, events: list, memory: dict):
    """A patch (for ``counted_path``) of ``owner.step``: each call between
    two CUDA events, and its own transient bytes (the peak over what was
    allocated before it); the run's peak so far is kept in
    ``memory["peak"]`` across the reset this takes."""
    fn = owner.step

    def step(self):
        memory["peak"] = max(memory["peak"], torch.cuda.max_memory_allocated())
        before = memory["allocated_before_step"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(self)
        end.record()
        events.append((start, end))
        memory["step_transient"] = max(memory["step_transient"],
                                       torch.cuda.max_memory_allocated() - before)
        return out

    return (owner, "step", step)


def moment_tensors(opt) -> list:
    """The Adam moments an optimizer of ``trainer/common.py`` stores."""
    if hasattr(opt, "adamw"):
        return [st[k] for st in opt.adamw.state.values() for k in ("exp_avg", "exp_avg_sq")]
    return [opt.mu, opt.nu]


def moments_run(torch, fa, moment_dtype: str, tmp: str):
    """Phase 5's geometry for ``MOMENT_UPDATES`` updates with
    ``train.adam_moment_dtype: moment_dtype`` as a counted path; returns
    ``(trainer, config, record)`` with the moments' bytes, the median
    optimizer-step and ``train_step`` ms, the collect rows and whether the
    parameters moved."""
    import trlx_tpu_torch
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator
    from trlx_tpu_torch.trainer.common import ClippedAdamW, LowPrecisionAdamW
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    # the end save through the asynchronous writer: its pinned host
    # buffers take the moments at their dtype
    config = training_config(tmp, total_steps=MOMENT_UPDATES, eval_interval=MOMENT_UPDATES,
                             checkpoint_interval=MOMENT_UPDATES, async_checkpoint=True,
                             adam_moment_dtype=moment_dtype)
    opt_events, step_events, collects, initial = [], [], [], {}
    memory = {"peak": 0, "step_transient": 0, "allocated_before_step": 0}
    finish, learn = PPOOrchestrator._finish_collect_stats, PPOTrainer.learn

    def record_collect(self, *a, **kw):
        collects.append(finish(self, *a, **kw))
        return collects[-1]

    def learn_(self):
        initial.update({n: p.detach().to("cpu", copy=True)
                        for n, p in self.model.state_dict().items()})
        return learn(self)

    patches = [optimizer_probe(torch, ClippedAdamW, opt_events, memory),
               optimizer_probe(torch, LowPrecisionAdamW, opt_events, memory),
               event_timer(torch, PPOTrainer, "train_step", step_events),
               (PPOOrchestrator, "_finish_collect_stats", record_collect),
               (PPOTrainer, "learn", learn_)]
    trainer, rec = counted_path(torch, fa, lambda: trlx_tpu_torch.train(
        reward_fn=training_reward, prompts=training_prompts(), config=config), patches)
    moments = moment_tensors(trainer.opt)
    params = trainer.model.state_dict()
    # the probe reset the peak at each optimizer step: the run's is the
    # larger of the peaks before and after the last reset
    rec["max_memory_allocated_bytes"] = max(rec["max_memory_allocated_bytes"], memory["peak"])
    rec.update({
        "optimizer_step_transient_bytes": memory["step_transient"],
        "allocated_before_last_step_bytes": memory["allocated_before_step"],
        "adam_moment_dtype": moment_dtype, "optimizer": type(trainer.opt).__name__,
        "updates": trainer.step, "forwards": trainer.forwards,
        "trainable_parameters": sum(p.numel() for p in trainer.opt.params),
        "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
        "moment_dtypes": sorted({str(t.dtype) for t in moments}),
        "moments_on_cuda": all(t.is_cuda for t in moments),
        "optimizer_step_ms_median": statistics.median(
            a.elapsed_time(b) for a, b in opt_events),
        "train_step_ms_median": statistics.median(a.elapsed_time(b) for a, b in step_events),
        "optimizer_steps_timed": len(opt_events),
        "finite": all(bool(torch.isfinite(t).all()) for t in [*params.values(), *moments])
        and all(math.isfinite(v) for r in collects for v in r.values()
                if isinstance(v, float)),
        "tensors_moved": sum(not torch.equal(p.cpu(), initial[n]) for n, p in params.items()),
        "last_kl": float(trainer.mean_kl),
        "last_score_mean": collects[-1]["exp/score_mean"] if collects else None,
    })
    return trainer, config, rec


def stochastic_round_on_card(torch) -> dict:
    """The card's ``stochastic_round`` against the plain CPU one on the same
    inputs and noise (edge values first: +-0, +-max finite, a carry into
    the exponent, +-inf), bit for bit; then the mean of ``SR_DRAWS``
    draws of the generator's noise within 0.15 ulp of each value."""
    from trlx_tpu_torch.trainer.common import stochastic_round

    gen = torch.Generator().manual_seed(26)
    n = 1 << 20
    x = torch.randn(n, generator=gen) * torch.exp2(
        torch.randint(-40, 40, (n,), generator=gen).float())
    f32_max = torch.finfo(torch.float32).max
    edges = torch.tensor([0.0, -0.0, f32_max, -f32_max, 1.9999999, float("inf"),
                          float("-inf"), *SR_VALUES])
    x[:len(edges)] = edges
    noise = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen, dtype=torch.int32)
    noise[2] = 0xFFFF  # max finite rounds up to inf
    plain = stochastic_round(x, torch.bfloat16, noise=noise)
    card = stochastic_round(x.cuda(), torch.bfloat16, noise=noise.cuda()).cpu()
    values = torch.tensor(SR_VALUES, device="cuda")
    draws = stochastic_round(values.expand(SR_DRAWS, -1).contiguous(), torch.bfloat16,
                             generator=torch.Generator(device="cuda").manual_seed(0))
    mean = draws.float().mean(0).double().cpu()
    want = values.double().cpu()
    err_ulp = ((mean - want).abs() / (want.abs() * 2.0 ** -8)).tolist()
    return {"elements": n, "bit_equal": torch.equal(plain.view(torch.int16),
                                                    card.view(torch.int16)),
            "max_rounds_to_inf": bool(torch.isinf(card[2])),
            "mean_error_ulp": err_ulp, "unbiased": max(err_ulp) < 0.15}


def sweep_ranges(sweep: dict, params: dict) -> bool:
    """Whether a trial's values lie in the sweep yml's ranges."""
    for name, spec in sweep.items():
        if name == "tune_config":
            continue
        v, values = params[name], spec["values"]
        if spec["strategy"] in ("uniform", "loguniform"):
            if not values[0] <= v <= values[1]:
                return False
        elif v not in values:
            return False
    return True


def run_sweep(torch, fa) -> tuple:
    """(b): the sweep CLI in process on the port's random-walks example,
    the sweep yml as written, as one counted path; each trial's launches,
    forwards, updates and wall read around its ``trlx_tpu_torch.train``."""
    import tempfile

    import numpy as np
    import yaml

    import trlx_tpu_torch
    from trlx_tpu_torch.sweep.__main__ import cli

    root = os.path.dirname(os.path.abspath(__file__))
    yml = os.path.join(root, "configs", "sweeps", SWEEP_YML)
    with open(yml) as f:
        sweep = yaml.safe_load(f)
    trials, train = [], trlx_tpu_torch.train

    def counters():
        return {"flash_fwd": fa.FLASH_FWD_LAUNCHES, "variants": forward_variant_launches(fa),
                "backward": backward_variant_launches(fa)}

    def counted_train(*a, **kw):
        before, t0 = counters(), time.perf_counter()
        trainer = train(*a, **kw)
        torch.cuda.synchronize()
        after = counters()
        trials.append({
            "wall_s": time.perf_counter() - t0, "updates": trainer.step,
            "forwards": trainer.forwards, "n_layer": trainer.model_config.n_layer,
            "k1": after["flash_fwd"] - before["flash_fwd"],
            "k1_variants": {v: after["variants"][v] - before["variants"][v]
                            for v in after["variants"]},
            "backward": {k: {v: after["backward"][k][v] - before["backward"][k][v]
                             for v in BWD_VARIANTS} for k in BWD_KERNELS}})
        return trainer

    cwd, wandb_disabled = os.getcwd(), os.environ.get("WANDB_DISABLED")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sweep.json")
        os.chdir(tmp)  # the trials' relative checkpoint_dir lands here
        # the CLI's best-effort wandb replay is off: it writes offline runs
        # and starts wandb's service, none of which the smoke reads
        os.environ["WANDB_DISABLED"] = "1"
        try:
            best, rec = counted_path(torch, fa, lambda: cli([
                os.path.join(root, "trlx_tpu_torch", "examples", "randomwalks.py"),
                "--config", yml, "--local", "--seed", "0", "--output", out]),
                [(trlx_tpu_torch, "train", counted_train)])
        finally:
            os.chdir(cwd)
            if wandb_disabled is None:
                del os.environ["WANDB_DISABLED"]
            else:
                os.environ["WANDB_DISABLED"] = wandb_disabled
        with open(out) as f:
            data = json.load(f)
    metric = sweep["tune_config"]["metric"]
    values = [t["result"].get(metric) for t in data["trials"]]
    rows = [{"params": t["params"], metric: v, **c}
            for t, v, c in zip(data["trials"], values, trials)]
    finite = len(values) == SWEEP_TRIALS and all(
        v is not None and math.isfinite(v) for v in values)
    gates = {
        "trials": len(data["trials"]) == len(trials) == SWEEP_TRIALS,
        "in_ranges": all(sweep_ranges(sweep, t["params"]) for t in data["trials"]),
        "updates": all(c["updates"] == SWEEP_UPDATES for c in trials),
        "finite_metric": finite,
        "best_is_argmax": finite and data["best"] == best
        and best["params"] == data["trials"][int(np.argmax(values))]["params"],
        "k1_per_forward": all(c["k1"] == c["n_layer"] * c["forwards"] and c["k1_variants"] == {
            "tile": 0, "decode": 0, "fma": c["k1"], "copies": 0} for c in trials),
        "k2_k3": all(c["backward"] == {k: {"tile": 0, "fma": c["n_layer"] * c["updates"]}
                                       for k in BWD_KERNELS} for c in trials),
        "no_copies_or_plain": rec["backward_copies"] == 0 and rec["plain_attention_calls"] == 0,
    }
    rec.update(path="sweep", trials=rows, gates=gates,
               best={"params": best["params"], metric: best["result"].get(metric)})
    return all(gates.values()), rec


def phase_moments_sweep(torch, fa):
    """Phase 26: bf16 Adam moments with stochastic rounding, then the
    hyperparameter sweep as written (see the module docstring). Returns
    ``(ok, {"paths": {...}, "sweep": record, ...})``."""
    import tempfile

    import numpy as np

    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    out, runs = {"paths": {}}, {}
    for moment_dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp:
            trainer, config, rec = moments_run(torch, fa, moment_dtype, tmp)
            if moment_dtype == "bfloat16":
                # the end checkpoint, loaded into a second trainer: one more
                # update on the same rows in each must agree bit for bit
                mb = trainer.buffer.gather(np.arange(config.train.batch_size))
                fresh = PPOTrainer(config)
                fresh.load(tmp)
                for t in (trainer, fresh):
                    t.train_step(mb)
                torch.cuda.synchronize()
                rec["resume_update_equal"] = (
                    trainer.opt.count == fresh.opt.count == MOMENT_UPDATES + 1
                    and all(torch.equal(a, b) for a, b in zip(
                        trainer.model.parameters(), fresh.model.parameters()))
                    and all(torch.equal(a, b) for a, b in zip(
                        moment_tensors(trainer.opt), moment_tensors(fresh.opt))))
                del fresh
            del trainer
        runs[moment_dtype] = rec
        out["paths"][f"moments_{moment_dtype}"] = rec
        log(f"phase 26: (a) {moment_dtype} moments " + json.dumps(rec))
    f32, bf16 = runs["float32"], runs["bfloat16"]
    sr = stochastic_round_on_card(torch)
    expected_bwd = {k: {"tile": N_LAYER * MOMENT_UPDATES, "fma": 0} for k in BWD_KERNELS}
    gates = {
        "bf16_on_cuda": bf16["moment_dtypes"] == ["torch.bfloat16"] and bf16["moments_on_cuda"],
        "f32_moments": f32["moment_dtypes"] == ["torch.float32"],
        "half_the_bytes": bf16["moment_bytes"] * 2 == f32["moment_bytes"]
        and bf16["moment_bytes"] == 4 * bf16["trainable_parameters"]
        and f32["trainable_parameters"] == bf16["trainable_parameters"],
        "finite_and_moved": all(r["finite"] and r["tensors_moved"] > 0 for r in (f32, bf16)),
        "updates": f32["updates"] == bf16["updates"] == MOMENT_UPDATES
        and bf16["optimizer"] == "LowPrecisionAdamW" and f32["optimizer"] == "ClippedAdamW",
        "launches_as_f32": all(bf16[k] == f32[k] for k in (
            "launches", "flash_fwd_variants", "backward_variants"))
        and bf16["backward_variants"] == expected_bwd
        and bf16["launches"]["flash_fwd"] == N_LAYER * bf16["forwards"],
        "no_copies_or_plain": all(r["plain_attention_calls"] == 0 and r["backward_copies"] == 0
                                  and r["flash_fwd_variants"]["copies"] == 0
                                  for r in (f32, bf16)),
        "resume_update_equal": bf16["resume_update_equal"],
        "stochastic_round_bit_equal": sr["bit_equal"] and sr["max_rounds_to_inf"],
        "stochastic_round_unbiased": sr["unbiased"],
    }
    out.update(moments_gates=gates, stochastic_round=sr)
    a_ok = all(gates.values())
    log(f"phase 26: (a) bf16 moments {'ok' if a_ok else 'FAIL'} (gates {json.dumps(gates)}; "
        f"moment bytes f32 {f32['moment_bytes']} bf16 {bf16['moment_bytes']}, peak f32 "
        f"{f32['max_memory_allocated_bytes']} bf16 {bf16['max_memory_allocated_bytes']} B, "
        f"optimizer step transient f32 {f32['optimizer_step_transient_bytes']} bf16 "
        f"{bf16['optimizer_step_transient_bytes']} B, "
        f"median optimizer step f32 {f32['optimizer_step_ms_median']:.3f} bf16 "
        f"{bf16['optimizer_step_ms_median']:.3f} ms, median train_step f32 "
        f"{f32['train_step_ms_median']:.3f} bf16 {bf16['train_step_ms_median']:.3f} ms, wall "
        f"f32 {f32['wall_s']:.1f} bf16 {bf16['wall_s']:.1f} s; last KL f32 {f32['last_kl']} "
        f"bf16 {bf16['last_kl']}, mean score f32 {f32['last_score_mean']} bf16 "
        f"{bf16['last_score_mean']}; stochastic_round {json.dumps(sr)})")
    b_ok, sweep = run_sweep(torch, fa)
    out["sweep"] = sweep
    log("phase 26: (b) sweep " + json.dumps(sweep))
    log(f"phase 26: (b) sweep {'ok' if b_ok else 'FAIL'} (gates {json.dumps(sweep['gates'])}; "
        f"trials " + json.dumps([{k: t[k] for k in ("params", "metrics/optimality", "wall_s")}
                                 for t in sweep["trials"]])
        + f"; best {json.dumps(sweep['best'])}; sweep wall {sweep['wall_s']:.1f} s)")
    return a_ok and b_ok, out


def int8_kernel_entries(kv, bench) -> list:
    """The ``kernels`` line's entries of the int8 cache's two kernels: the
    serving decode shape's times at the top, the rollout decode's beside
    them; launches from the int8 serving tier's run (phase 23 (c)) and
    from phase 7's runs (where ``"auto"`` resolves to int8 at its
    capacity)."""
    out = []
    for name, part in (("flash_fwd_decode_int8", "decode"), ("kv_quant", "write")):
        by_path = {"int8_serving_tier": kv["serving_tier"]["kv_int8_launches"][name],
                   **{"bench_" + n: r["kv_int8_launches"][name] for n, r in bench.items()}}
        row = kv["timed"]["serving_decode"][part]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in kv["checks"] if c["kernel"] == name),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "timed_shape": "serving decode " + row["shape"],
            "rollout_decode": kv["timed"]["rollout_decode"][part],
            **({"bf16_decode_ms": row["bf16_decode_ms"], "sdpa_bf16_ms": row["sdpa_bf16_ms"]}
               if part == "decode" else {}),
        })
    return out


def ring_kernel_entries(ring) -> list:
    """The ``kernels`` line's entries of the ring's block wrappers: each
    timed at the diagonal block (the forward in bf16, the backward in
    f32), the other shapes beside it (with their variant: the forward's
    f32 rows ``split3``), launches on the ring's paths and by variant; and
    the split pre-pass's entry (its launches on those paths, timed on one
    of the block's operands)."""
    entries = []
    for name, head in (("flash_block_fwd", ("diagonal", "bfloat16")),
                       ("flash_block_bwd", ("diagonal", "float32"))):
        rows = {(b, d): r for (k, b, d), r in ring["block_timed"].items() if k == name}
        row = rows[head]
        errs = [v for c in ring["block_checks"] if c["case"].startswith(name[6:])
                for key, v in c.items() if key.startswith("max_abs_err")]
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "wrapper": f"trlx_tpu_torch/ops/flash_attention.py::{name}",
            "replaces": REPLACES[name],
            "launches": sum(r["launches"][name] for r in ring["paths"].values()),
            "launches_by_path": {p: r["launches"][name] for p, r in ring["paths"].items()},
            "launches_by_variant": {p: (
                {**r["flash_fwd_variants"], "split3": r["split3_launches"]["flash_fwd"]}
                if name == "flash_block_fwd" else
                {k: {**r["backward_variants"][k], "split3": r["split3_launches"][k]}
                 for k in BWD_KERNELS}) for p, r in ring["paths"].items()},
            "split_planes_launches": {p: r["split3_launches"]["split_planes"]
                                      for p, r in ring["paths"].items()},
            "max_abs_err": max(errs),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "variant")},
            **({"f32_bound_ms": row["f32_bound_ms"]} if "f32_bound_ms" in row else {}),
            "timed_shape": f"ring block {head[1]} " + row["shape"],
            "shapes": {f"{b} {d}": {k: r[k] for k in (
                "shape", "variant", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "f32_bound_ms") if k in r}
                for (b, d), r in rows.items() if (b, d) != head},
        })
    # the split3 pre-pass of both wrappers' f32 operands
    split = ring["split_planes_ms"]
    entries.append({
        "name": "split_planes", "route": "cuda", "source": SOURCES["split_planes"],
        "wrapper": "trlx_tpu_torch/ops/flash_attention.py::split_planes",
        "replaces": REPLACES["split_planes"],
        "launches": sum(r["split3_launches"]["split_planes"] for r in ring["paths"].values()),
        "launches_by_path": {p: r["split3_launches"]["split_planes"]
                             for p, r in ring["paths"].items()},
        **{k: split[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "timed_shape": "ring block " + split["shape"],
    })
    return entries


def wide_kernel_entries(prefix: str, suffix: str, label: str, timed_shapes, build, fwd_checks,
                        bwd_checks, fwd_timed, bwd_timed, paths, headlines=None) -> list:
    """The ``kernels`` line's entries of one head dim's instantiations
    (``suffix``: "_d256", "_d96", "_d16", ...): K1 (timed at ``headlines``'
    first shape, the serving decode step by default, every path shape of
    ``timed_shapes`` beside it), K2 and K3 (timed at its second, the update
    backward by default), K2 with dbias (at its third), their launches on
    ``paths`` (the phases that run that head dim) counted on their own."""
    k1_shape, bwd_shape, dbias_shape = headlines or (
        f"{prefix}_serving_decode", f"{prefix}_update", f"{prefix}_dbias")

    def fwd(shape):
        return {k: fwd_timed[(shape, "bfloat16")][k] for k in (
            "shape", "variant", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}

    decode = fwd(k1_shape)
    k1_spills = [build[k]["spill_bytes"] for k in GATED_KERNELS["flash_fwd"]
                 if k.endswith(suffix)]
    entries = [{
        "name": "flash_fwd" + suffix, "route": "cuda", "source": SOURCES["flash_fwd"],
        "replaces": REPLACES["flash_fwd"],
        "launches": sum(r["launches"]["flash_fwd"] for r in paths.values()),
        "launches_by_path": {n: r["launches"]["flash_fwd"] for n, r in paths.items()},
        "launches_by_variant": {n: r["flash_fwd_variants"] for n, r in paths.items()},
        "max_abs_err": max(c["max_abs_err_o"] for c in fwd_checks),
        **{k: decode[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "timed_shape": f"{label} {k1_shape} bf16 " + decode["shape"],
        "shapes": {shape: fwd(shape) for shape in timed_shapes if shape != k1_shape},
        "tile_tensor_core_instructions":
            build["flash_fwd_tile_kernel" + suffix]["tensor_core_instructions"],
        "k1_spill_bytes": None if None in k1_spills else sum(k1_spills),
    }]
    for name, outputs in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
        row = bwd_timed[(bwd_shape, name)]
        entry = {
            "name": name + suffix, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(r["launches"][name] for r in paths.values()),
            "launches_by_path": {n: r["launches"][name] for n, r in paths.items()},
            "launches_by_variant": {n: r["backward_variants"][name] for n, r in paths.items()},
            "max_abs_err": max(c[f"max_abs_err_{o}"] for c in bwd_checks for o in outputs),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "variant", "wrapper_ms")},
            "timed_shape": f"{label} {bwd_shape} bf16 " + row["shape"],
            "shapes": {shape: {k: r[k] for k in (
                "shape", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for (shape, kname), r in bwd_timed.items()
                if kname == name and shape != bwd_shape
                and (name == "flash_bwd_dkv" or not r["dbias"])},
            **{k: build[f"{name}_tile_kernel{suffix}"][k] for k in (
                "spill_bytes", "registers", "tensor_core_instructions")},
        }
        entries.append(entry)
    # K2's bias-gradient instantiation, held and timed on its own
    dbias = bwd_timed[(dbias_shape, "flash_bwd_dq")]
    entries.append({
        "name": "flash_bwd_dq_dbias" + suffix, "route": "cuda",
        "source": SOURCES["flash_bwd_dq"], "replaces": REPLACES["flash_bwd_dq"],
        "launches": sum(r["launches"]["flash_bwd_dq_dbias"] for r in paths.values()),
        "launches_by_path": {n: r["launches"]["flash_bwd_dq_dbias"] for n, r in paths.items()},
        "max_abs_err": max(c["max_abs_err_dbias"] for c in bwd_checks
                           if "max_abs_err_dbias" in c),
        **{k: dbias[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "variant", "wrapper_ms")},
        "timed_shape": f"{label} {dbias_shape} bf16 " + dbias["shape"],
        "shapes": {shape: {k: r[k] for k in (
            "shape", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for (shape, kname), r in bwd_timed.items()
            if kname == "flash_bwd_dq" and shape != dbias_shape and r["dbias"]},
        **{k: build["flash_bwd_dq_tile_kernel_dbias" + suffix][k] for k in (
            "spill_bytes", "registers", "tensor_core_instructions")},
    })
    return entries


# ------------------------- phase 27: mesh training ------------------------- #

#: phase 27's geometry: phase 5's (``configs/ppo_sentiments.yml``, GPT-2
#: small at full width, bf16 over f32 masters), cut to one collect of
#: MESH_ROLLOUTS rows and one epoch: MESH_ROLLOUTS // 16 updates
MESH_ROLLOUTS = 32
#: the meshes two ranks run on the one card, in one pair of processes
MESH_MESHES = {"fsdp2": {"dp": 1, "fsdp": 2, "tp": 1}, "tp2": {"dp": 1, "fsdp": 1, "tp": 2}}
#: the fixed minibatch's gradient norm, relative, against the world-1 run:
#: in f32 a mesh only reorders sums, which moves the norm by about f32's
#: unit roundoff (6e-8) times the few dozen partial sums it regroups, 1e-6;
#: bf16's unit roundoff is 2^15 times f32's
MESH_GRAD_NORM_RTOL = 2**15 * 1e-6
#: the update's parameters: Adam's first step moves an element by lr times
#: m / (sqrt(v) + eps), about lr * sign(g), so two runs differ by up to 2 lr
#: where rounding decides the sign of a gradient within bf16's noise (the
#: CPU tests' f32 exemption, grown to bf16's noise); of the elements, at
#: most MESH_FLIP_SHARE may differ by more than lr / 2, and the two updates'
#: cosine must be at least MESH_UPDATE_COSINE
MESH_FLIP_SHARE = 0.05
MESH_UPDATE_COSINE = 0.95


def mesh_config(checkpoint_dir: str, mesh: dict):
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = training_config(checkpoint_dir, mesh=mesh).to_dict()
    cfg["method"].update(num_rollouts=MESH_ROLLOUTS, chunk_size=MESH_ROLLOUTS, ppo_epochs=1)
    cfg["train"].update(total_steps=MESH_ROLLOUTS // cfg["train"]["batch_size"],
                        eval_interval=10**6, checkpoint_interval=10**6)
    return TRLConfig.from_dict(cfg)


def mesh_trainer(config):
    """The PPO trainer of ``config`` (random weights from its seed) with
    the first MESH_ROLLOUTS training prompts as its pipeline, and no eval
    pipeline (``learn()``'s evals would triple the decode steps)."""
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline

    trainer = PPOTrainer(config, reward_fn=training_reward)
    pipeline = get_pipeline("PromptPipeline")(training_prompts()[:MESH_ROLLOUTS],
                                              trainer.query_length)
    get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=training_reward,
                                        chunk_size=MESH_ROLLOUTS)
    return trainer


def mesh_fixed_minibatch(torch, trainer):
    """One fixed rollout of the first MESH_ROLLOUTS prompts through
    ``trainer`` (world 1), scored and shaped; returns its first minibatch."""
    import numpy as np

    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch

    batch, _ = next(iter(trainer.orch.pipeline.create_loader(MESH_ROLLOUTS, shuffle=False)))
    dev = trainer.device
    q, m = batch.input_ids.to(dev), batch.attention_mask.to(dev)
    out = trainer.sample(q, m)
    ref = trainer.score_ref(q, m, out.tokens, out.response_mask)
    texts = trainer.decode_responses(out.tokens, out.response_mask)
    scores = np.asarray(training_reward(texts, None), np.float32)
    rewards = trainer.compute_rewards(out.logprobs, ref, out.response_mask, scores)
    B = trainer.config.train.batch_size
    return PPORolloutBatch(q[:B], m[:B], out.tokens[:B], out.response_mask[:B],
                           out.logprobs[:B], out.values[:B], rewards[:B])


def mesh_learn(torch, fa, trainer):
    """``trainer.learn()`` as a counted path, its forwards split into
    decode steps (Q <= 16) and the rest; returns its record."""
    import types

    import numpy as np

    decode, apply = [0], type(trainer)._apply
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    finite = []

    def counted_apply(self, input_ids, *a, **kw):
        decode[0] += input_ids.shape[1] <= 16
        return apply(self, input_ids, *a, **kw)

    train_on = trainer._train_on

    def rows_on(*a, **kw):
        out = train_on(*a, **kw)
        finite.append(all(np.isfinite(v).all() for v in out[0].values()))
        return out

    trainer._train_on = rows_on
    trainer._apply = types.MethodType(counted_apply, trainer)
    trainer._rebuild_sampler()  # the sampler binds _apply when it is made
    _, rec = counted_path(torch, fa, trainer.learn)
    rec["forwards"], rec["decode_forwards"], rec["updates"] = (
        trainer.forwards, decode[0], trainer.step)
    rec["finite"] = bool(finite) and all(finite)
    rec["moved"] = any(not torch.equal(p, start[n]) for n, p in trainer.model.named_parameters())
    # what the local shapes predict: one launch per layer and forward, K1's
    # decode variant at Q <= 16 and tile above, K2 = K3 = one a layer and update
    n_layer = trainer.model_config.n_layer
    want_fwd = {"tile": n_layer * (rec["forwards"] - rec["decode_forwards"]),
                "decode": n_layer * rec["decode_forwards"], "fma": 0, "copies": 0}
    got_fwd = {k: rec["flash_fwd_variants"].get(k, 0) for k in want_fwd}
    want_bwd = {"tile": n_layer * rec["updates"], "fma": 0}
    rec["launch_gate"] = (got_fwd == want_fwd and rec["plain_attention_calls"] == 0
                          and all(rec["backward_variants"][k] == want_bwd for k in BWD_KERNELS))
    rec["launch_prediction"] = {"flash_fwd": want_fwd, "backward": want_bwd}
    return rec


def mesh_bytes(trainer) -> dict:
    """Resident bytes of the policy's parameters and of the optimizer's
    moments on this rank, and whether every parameter holds at most its
    share of the mesh (the JAX specs' axes)."""
    params = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    moments = sum(t.numel() * t.element_size() for st in trainer.opt.adamw.state.values()
                  for t in st.values() if t.dim() > 0)
    ok, sharded = True, 0
    if trainer.shards is not None:
        sizes = trainer.mesh.sizes
        for name, (held, full) in trainer.shards.shard_bytes().items():
            share = math.prod(sizes[a] for a in trainer.shards.placements[name].spec if a)
            ok &= held * share <= full
            sharded += share > 1
    return {"params_bytes": params, "moment_bytes": moments, "share_ok": ok,
            "sharded_params": sharded}


def mesh_rank(rank: int, task_path: str) -> int:
    """One rank of phase 27's pair (``chip_smoke.py --mesh-rank R
    --mesh-task T``): its process group on the task's backend over a
    ``file://`` store, both ranks on device 0. With ``probe`` one
    all-reduce and the error it raises (NCCL refuses two ranks on one
    device); else, per mesh, the fixed minibatch's update held against the
    world-1 run's and a counted ``learn()``. Writes ``rank<R>.json``."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
    from trlx_tpu_torch.ops import flash_attention as fa
    from trlx_tpu_torch.parallel import collectives as C
    from trlx_tpu_torch.parallel import distributed

    with open(task_path) as fh:
        task = json.load(fh)
    out = {"rank": rank, "backend": task["backend"]}
    distributed.initialize("cuda", init_method=f"file://{task['store']}", world_size=2,
                           rank=rank, backend=task["backend"])
    try:
        if task.get("probe"):
            try:
                x = torch.ones(4, device="cuda")
                dist.all_reduce(x)
                torch.cuda.synchronize()
                out["all_reduce"] = float(x.sum())
            except Exception as e:  # the refusal is the result
                out["error"] = f"{type(e).__name__}: {e}"[:1500]
            return 0
        fa._load()
        # the ranks start with the phase; world 1's files land later
        deadline = time.perf_counter() + 300
        while not os.path.exists(task["ready"]) and time.perf_counter() < deadline:
            time.sleep(0.2)
        mb = PPORolloutBatch(**torch.load(task["minibatch"], map_location="cuda"))
        w1_init = torch.load(task["world1_init"], map_location="cuda")
        w1_after = torch.load(task["world1_after"], map_location="cuda")
        with open(os.path.join(task["dir"], "lr.json")) as fh:
            lr = json.load(fh)
        for name, mesh in MESH_MESHES.items():
            t0 = time.perf_counter()
            rec = out[name] = {}
            with tempfile.TemporaryDirectory() as tmp:
                trainer = mesh_trainer(mesh_config(tmp, mesh))
                sh, world, dev = trainer.shards, trainer.mesh.world_group, trainer.device
                params = dict(trainer.model.named_parameters())
                # every shard against world 1's (no gather): the same
                # initial bits, then the fixed minibatch's update
                init = {n: p.detach().clone() for n, p in params.items()}
                same = all(torch.equal(sh.local_tensor(n, w1_init[n]), t) for n, t in init.items())
                rec["init_equal"] = bool(C.all_reduce(torch.tensor(int(same), device=dev),
                                                      world, "min"))
                stats = trainer.train_step(mb)
                rec["grad_norm"] = float(stats["optimizer/grad_norm"])
                rec.update(mesh_bytes(trainer))
                # sums over the mesh, each element counted once
                acc = torch.zeros(5, dtype=torch.float64, device=dev)
                worst = torch.zeros((), device=dev)
                for n, p in params.items():
                    one = sh.local_tensor(n, w1_after[n])
                    d_mesh, d_one = (p.detach() - init[n]).double(), (one - init[n]).double()
                    diff = (p.detach() - one).abs()
                    acc += torch.stack([(d_mesh * d_one).sum(), (d_one * d_one).sum(),
                                        (d_mesh * d_mesh).sum(), (diff > lr / 2).sum().double(),
                                        torch.tensor(float(diff.numel()), device=dev,
                                                     dtype=torch.float64)]) / sh.replication(n)
                    worst = torch.maximum(worst, diff.max())
                dot, n1, n2, flips, total = C.all_reduce(acc, world).tolist()
                rec["update_cosine"] = dot / math.sqrt(max(n1 * n2, 1e-300))
                rec["flip_share"] = flips / total
                rec["max_abs_diff"] = float(C.all_reduce(worst, world, "max"))
                del trainer, init, params
                gc.collect()
                torch.cuda.empty_cache()
                trainer = mesh_trainer(mesh_config(tmp, mesh))
                rec["learn"] = mesh_learn(torch, fa, trainer)
                rec["learn_bytes"] = mesh_bytes(trainer)
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            rec["wall_s"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(task["dir"], f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    return 0


def start_mesh_pair(task: dict, directory: str) -> list:
    """Start both ranks of ``task`` as ``chip_smoke.py --mesh-rank``
    processes; returns ``[(process, directory)]``."""
    os.makedirs(directory, exist_ok=True)
    task = dict(task, dir=directory, store=os.path.join(directory, "store"))
    path = os.path.join(directory, "task.json")
    with open(path, "w") as fh:
        json.dump(task, fh)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    return [(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               str(r), "--mesh-task", path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True), directory)
            for r in range(2)]


def finish_mesh_pair(procs: list, timeout: float) -> list:
    """Wait for (or, past ``timeout`` s, kill) both ranks; returns ``(exit
    code, output tail, record or None)`` per rank. Every process is
    stopped on return."""
    results = []
    try:
        for r, (p, directory) in enumerate(procs):
            try:
                text = p.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + f"\n(killed after {timeout} s)"
            rec_path = os.path.join(directory, f"rank{r}.json")
            rec = None
            if os.path.exists(rec_path):
                with open(rec_path) as fh:
                    rec = json.load(fh)
            results.append((p.returncode, text[-3000:], rec))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def phase_mesh(torch, fa):
    """Phase 27: dp/fsdp/tp training. World 1 in this process: phase 5's
    geometry, one fixed minibatch's update (the gradient norm and the
    parameters after it) and a counted ``learn()`` of one collect and
    MESH_ROLLOUTS // 16 updates, streamed. Then two ranks that share the
    card: NCCL's refusal of two ranks on one device (a probe pair), and on
    gloo, which stages CUDA tensors through the host (``initialize``'s
    explicit ``backend``), ``{fsdp: 2}`` then ``{tp: 2}`` in one pair of
    processes: each mesh's fixed update against world 1's, a counted
    ``learn()`` per rank with its launches by variant against the local
    shapes' prediction, and each rank's resident bytes. Returns ``(ok,
    record)``; the record's ``paths`` are the world-1 run and each rank's
    ``learn()``."""
    import gc
    import tempfile

    t0 = time.perf_counter()
    record = {"paths": {}}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks import and reach the card while world 1 runs: the NCCL
        # probe pair and the gloo pair (separate stores), both on device 0
        files = {k: os.path.join(tmp, f"{k}.pt") for k in ("minibatch", "init", "after")}
        ready = os.path.join(tmp, "ready")
        probe = start_mesh_pair({"backend": "nccl", "probe": True}, os.path.join(tmp, "nccl"))
        pair = start_mesh_pair({"backend": "gloo", "minibatch": files["minibatch"],
                                "world1_init": files["init"], "world1_after": files["after"],
                                "ready": ready}, os.path.join(tmp, "gloo"))
        try:
            trainer = mesh_trainer(mesh_config(os.path.join(tmp, "w1"), {"dp": -1}))
            init = {n: t.clone() for n, t in trainer.model.state_dict().items()}
            mb = mesh_fixed_minibatch(torch, trainer)
            stats = trainer.train_step(mb)
            after = trainer.model.state_dict()
            world1 = {"grad_norm": float(stats["optimizer/grad_norm"]), **mesh_bytes(trainer)}
            lr = float(trainer.config.train.lr_init)
            torch.save({k: v.cpu() for k, v in mb.__dict__.items()}, files["minibatch"])
            for name, state in (("init", init), ("after", after)):
                torch.save({n: t.cpu() for n, t in state.items()}, files[name])
            with open(os.path.join(tmp, "gloo", "lr.json"), "w") as fh:
                json.dump(lr, fh)
            open(ready, "w").close()
            del trainer, init, after
            reset_peak(torch)
            trainer = mesh_trainer(mesh_config(os.path.join(tmp, "w1_learn"), {"dp": -1}))
            world1["learn"] = mesh_learn(torch, fa, trainer)
            record["paths"]["mesh_world1"] = world1["learn"]
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            open(ready, "w").close()
            probe, pair = finish_mesh_pair(probe, 90), finish_mesh_pair(pair, 300)
    log(f"phase 27: world 1 {json.dumps(world1)}")
    ok &= world1["learn"]["launch_gate"] and world1["learn"]["finite"] \
        and world1["learn"]["moved"]
    record["world1"] = world1
    nccl = [rec.get("error") if rec else f"rank exited {rc}: {text[-400:]}"
            for rc, text, rec in probe]
    nccl_refused = all(e for e in nccl)
    record["nccl"] = {"refused": nccl_refused, "errors": nccl}
    log(f"phase 27: NCCL, two ranks on one device: "
        f"{'refused' if nccl_refused else 'ran'}: {nccl[0]}")
    if any(rc != 0 or rec is None for rc, _, rec in pair):
        for r, (rc, text, _) in enumerate(pair):
            log(f"phase 27: gloo rank {r} exited {rc}:\n{text}")
        return False, record
    record["meshes"] = {}
    for name in MESH_MESHES:
        ranks = [rec[name] for _, _, rec in pair]
        r0 = ranks[0]
        gates = {
            "init_equal": all(r["init_equal"] for r in ranks),
            "grad_norm": abs(r0["grad_norm"] - world1["grad_norm"])
            <= MESH_GRAD_NORM_RTOL * world1["grad_norm"],
            "params_max": r0["max_abs_diff"] <= 2 * lr * 1.001,
            "flip_share": r0["flip_share"] <= MESH_FLIP_SHARE,
            "cosine": r0["update_cosine"] >= MESH_UPDATE_COSINE,
            "learn_finite_moved": all(r["learn"]["finite"] and r["learn"]["moved"]
                                      for r in ranks),
            "launches": all(r["learn"]["launch_gate"] for r in ranks),
            "share": all(r["share_ok"] and r["sharded_params"] > 0 for r in ranks),
        }
        row = {"backend": "gloo", "gates": gates,
               "grad_norm": [r["grad_norm"] for r in ranks],
               "grad_norm_world1": world1["grad_norm"],
               "grad_norm_rel": abs(r0["grad_norm"] - world1["grad_norm"]) / world1["grad_norm"],
               "update_cosine": r0["update_cosine"], "flip_share": r0["flip_share"],
               "max_abs_diff": r0["max_abs_diff"], "lr": lr,
               "params_bytes": [r["params_bytes"] for r in ranks],
               "moment_bytes": [r["moment_bytes"] for r in ranks],
               "params_bytes_world1": world1["params_bytes"],
               "moment_bytes_world1": world1["moment_bytes"],
               "launches": [r["learn"]["flash_fwd_variants"] for r in ranks],
               "backward": [r["learn"]["backward_variants"] for r in ranks],
               "launches_world1": world1["learn"]["flash_fwd_variants"],
               "learn_wall_s": [r["learn"]["wall_s"] for r in ranks],
               "mesh_wall_s": [r["wall_s"] for r in ranks]}
        record["meshes"][name] = row
        log(f"phase 27: {name} {json.dumps(row)}")
        ok &= all(gates.values())
        for r, rank_rec in enumerate(ranks):
            record["paths"][f"mesh_{name}_rank{r}"] = rank_rec["learn"]
    record["wall_s"] = time.perf_counter() - t0
    return bool(ok), record


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH", default=None,
                        help="also profile the serving and training paths; "
                             "write the summaries here")
    # phase 27's rank processes (the smoke starts them itself)
    parser.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-task", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_task)

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
    walls = {}  # each phase call's wall, in call order

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[name] = time.perf_counter() - t0
            log(f"phase wall: {name} {walls[name]:.1f} s")

    build_ok, build = timed_phase("1 build", phase_build, fa)
    fwd_checks, timed = timed_phase("2 kernel", phase_kernel, torch, fa, attn)
    train_fwd_checks, bwd_checks, train_timed, bwd_timed = timed_phase(
        "2 backward", phase_backward, torch, fa, attn)
    t5_fwd_checks, t5_bwd_checks, t5_timed, t5_bwd_timed = timed_phase(
        "2 t5 kernels", phase_t5_kernels, torch, fa, attn)
    gptj_fwd_checks, gptj_bwd_checks, gptj_timed, gptj_bwd_timed = timed_phase(
        "2 gptj kernels", phase_gptj_kernels, torch, fa, attn)
    neox_fwd_checks, neox_bwd_checks, neox_timed, neox_bwd_timed = timed_phase(
        "2 neox kernels", phase_neox_kernels, torch, fa, attn)
    neo_fwd_checks, neo_bwd_checks, neo_timed, neo_bwd_timed = timed_phase(
        "2 neo kernels", phase_neo_kernels, torch, fa, attn)
    small = timed_phase("2 small kernels", phase_small_kernels, torch, fa, attn)
    small_checks = [c for D in SMALL_HEAD_DIMS for c in small[D][0] + small[D][1]]
    fwd_checks += train_fwd_checks + t5_fwd_checks
    bwd_checks += t5_bwd_checks
    timed.update(train_timed)
    timed.update(t5_timed)
    timed.update(gptj_timed)
    timed.update(neox_timed)
    timed.update(neo_timed)
    for D in SMALL_HEAD_DIMS:
        timed.update(small[D][2])
    kernel_ok = all(c["ok"] for c in fwd_checks + bwd_checks + gptj_fwd_checks
                    + gptj_bwd_checks + neox_fwd_checks + neox_bwd_checks
                    + neo_fwd_checks + neo_bwd_checks + small_checks) and all(row["packed_ok"] for row in timed.values())
    model_ok = True
    for name, fn, fn_args in (
            ("3 model", phase_model, (torch, fa)),
            ("3 model backward", phase_model_backward, (torch, fa)),
            ("3 t5 model backward", phase_t5_model_backward, (torch, fa)),
            ("3 logprob chunk", phase_logprob_chunk, (torch,)),
            ("3 gptj model", phase_gptj_model, (torch, fa)),
            ("3 gptj checkpoint", phase_gptj_checkpoint, (torch,)),
            ("3 neox model", phase_neox_model, (torch, fa)),
            ("3 neox checkpoint", phase_neox_checkpoint, (torch,)),
            ("3 neo model", phase_neo_model, (torch, fa)),
            ("3 neo checkpoint", phase_neo_checkpoint, (torch,))):
        model_ok = timed_phase(name, fn, *fn_args) & model_ok
    serving_ok, serving = timed_phase("4 serving", phase_serving, torch, fa)
    training_ok, training = timed_phase("5 training", phase_training, torch, fa)
    seq2seq_ok, seq2seq = timed_phase("6 seq2seq training", phase_t5_training, torch, fa)
    bench_ok, bench = timed_phase("7 bench workload", phase_bench_workload, torch, fa)
    ilql_ok, ilql = timed_phase("8 ilql", phase_ilql, torch, fa)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # one GPT-2-small checkpoint for phases 9 and 10
        gpt2_ckpt = os.path.join(tmp, "gpt2")
        gpt2_written = timed_phase("9 gpt2 checkpoint", write_gpt2_checkpoint, torch, gpt2_ckpt)
        grpo_ok, grpo = timed_phase("9 grpo", phase_grpo, torch, fa, gpt2_ckpt, gpt2_written)
        continuous_ok, continuous = timed_phase(
            "10 continuous engine", phase_continuous, torch, fa, gpt2_ckpt, gpt2_written)
        features_ok, features = timed_phase(
            "10 engine features", run_continuous_features, torch, fa, gpt2_ckpt, gpt2_written)
        continuous_ok = continuous_ok and features_ok
        del gpt2_written
    tier_ok, tier = timed_phase("11 serving tier", phase_serving_tier, torch, fa)
    gptj_serving_ok, gptj_serving = timed_phase("12 gptj serving", phase_gptj_serving, torch, fa)
    gptj_training_ok, gptj_training = timed_phase(
        "13 gptj training", phase_gptj_training, torch, fa)
    neox_serving_ok, neox_serving = timed_phase("14 neox serving", phase_neox_serving, torch, fa)
    neox_training_ok, neox_training = timed_phase(
        "15 neox training", phase_neox_training, torch, fa)
    rw_ok, rw = timed_phase("16 randomwalks ppo", phase_randomwalks_ppo, torch, fa)
    rw_ilql_ok, rw_ilql = timed_phase("17 randomwalks ilql", phase_randomwalks_ilql, torch, fa)
    standins_ok, standins = timed_phase("18 standins and guard", phase_standins, torch, fa)
    neo_serving_ok, neo_serving = timed_phase("19 neo serving", phase_neo_serving, torch, fa)
    neo_training_ok, neo_training = timed_phase("20 neo training", phase_neo_training, torch, fa)
    ring_ok, ring = timed_phase("21 ring attention", phase_ring, torch, fa)
    moe_ok, moe = timed_phase("22 gpt2_moe", phase_moe, torch, fa)
    kv_int8_ok, kv_int8 = timed_phase("23 kv int8", phase_kv_int8, torch, fa, attn)
    resilience_ok, resilience = timed_phase("24 resilience", phase_resilience, torch, fa)
    async_ok, async_rl = timed_phase("25 async rl", phase_async, torch, fa)
    moments_ok, moments = timed_phase("26 bf16 moments and sweep", phase_moments_sweep, torch,
                                      fa)
    mesh_ok, mesh = timed_phase("27 mesh training", phase_mesh, torch, fa)
    # the small head dims' paths (phases 16 to 18), each counted on its own
    small_paths = {24: {**rw, "randomwalks_ilql": rw_ilql, "sweep": moments["sweep"]},
                   32: {n: standins[n] for n in ("standin_gpt2_ppo", "standin_gpt2_ppo_bf16",
                                                 "standin_gpt2_serving")},
                   16: {n: standins[n] for n in ("standin_t5_ppo", "standin_t5_ppo_bf16",
                                                 "learning_guard")}}
    # the head-dim-256 paths (phases 12 and 13) and the head-dim-96 paths
    # (phases 14 and 15), counted on their own
    gptj_paths = {"gptj_serving": gptj_serving, "gptj_training": gptj_training}
    neox_paths = {"neox_serving": neox_serving, "neox_training": neox_training}
    # the head-dim-128 paths (phases 19 and 20), counted on their own
    neo_paths = {"neo_serving": neo_serving, "neo_training": neo_training}
    # the paths of phases 9 to 11, each counted on its own
    new_paths = {"grpo": grpo["causal"], "grpo_seq2seq": grpo["seq2seq"],
                 "continuous_engine": continuous, "continuous_engine_features": features,
                 "serving_tier": tier, "serving_tier_features_off": tier["features_off"],
                 "serving_tier_oracle_drafts": tier["oracle_drafts"],
                 # phase 22's gpt2_moe paths (K1, K2, K3 at D = 64)
                 "gpt2_moe_serving": moe["serving"], "gpt2_moe_training": moe["training"],
                 # phase 23's int8 serving tier (K1 tile on the dequantized
                 # view; its decode_int8 launches are counted in K1's too)
                 "int8_serving_tier": kv_int8["serving_tier"],
                 # phase 21's ring paths (the D = 64 kernels, K1 and K2/K3 by
                 # the block wrappers), each counted on its own
                 **ring["paths"],
                 # phase 24's resumed runs, each across both of its attempts
                 **resilience["paths"],
                 # phase 25's yml run and its dead-actor run (both attempts)
                 **async_rl["paths"],
                 # phase 26's f32- and bf16-moment runs
                 **moments["paths"],
                 # phase 27's world-1 run and each rank's (on its own process)
                 **mesh["paths"]}
    if args.profile:
        timed_phase("profile", profile_paths, torch, args.profile)

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
            "serving_prefill", "serving_decode", "serving_chunk", "serving_verify",
            *TRAINING_SHAPES.values(), *T5_SHAPES)},
        "f32": {s: {k: timed[(s, "float32")][k] for k in (
                    "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms")}
                for s in ("serving_prefill", "serving_decode", "serving_chunk",
                          "serving_verify")},
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
    kernels += wide_kernel_entries("gptj", "_d256", "GPT-J", GPTJ_TIMED, build, gptj_fwd_checks,
                                   gptj_bwd_checks, gptj_timed, gptj_bwd_timed, gptj_paths)
    kernels += wide_kernel_entries("neox", "_d96", "GPT-NeoX-20B", NEOX_TIMED, build,
                                   neox_fwd_checks, neox_bwd_checks, neox_timed,
                                   neox_bwd_timed, neox_paths)
    kernels += wide_kernel_entries("neo", "_d128", "GPT-Neo 1.3B", NEO_TIMED, build,
                                   neo_fwd_checks, neo_bwd_checks, neo_timed, neo_bwd_timed,
                                   neo_paths)
    small_labels = {24: "randomwalks", 32: "GPT-2 stand-in", 16: "T5 stand-in, learning guard"}
    for D in SMALL_HEAD_DIMS:
        kernels += wide_kernel_entries(f"d{D}", f"_d{D}", small_labels[D], SMALL_TIMED[D][0],
                                       build, *small[D], small_paths[D],
                                       headlines=SMALL_HEADLINES[D])
    kernels += ring_kernel_entries(ring)
    kernels += int8_kernel_entries(kv_int8, bench)
    log(", ".join(card) if card else "nvidia-smi: no output")
    walls["total"] = sum(walls.values())
    print(json.dumps({"phase_walls": walls}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    phases = (("build", build_ok), ("kernel", kernel_ok), ("model", model_ok),
              ("serving", serving_ok), ("training", training_ok),
              ("seq2seq_training", seq2seq_ok), ("bench_workload", bench_ok),
              ("ilql", ilql_ok), ("grpo", grpo_ok), ("continuous_engine", continuous_ok),
              ("serving_tier", tier_ok), ("gptj_serving", gptj_serving_ok),
              ("gptj_training", gptj_training_ok), ("neox_serving", neox_serving_ok),
              ("neox_training", neox_training_ok), ("randomwalks_ppo", rw_ok),
              ("randomwalks_ilql", rw_ilql_ok), ("standins_and_guard", standins_ok),
              ("neo_serving", neo_serving_ok), ("neo_training", neo_training_ok),
              ("ring_attention", ring_ok), ("gpt2_moe", moe_ok), ("kv_int8", kv_int8_ok),
              ("resilience", resilience_ok), ("async_rl", async_ok),
              ("bf16_moments_and_sweep", moments_ok), ("mesh_training", mesh_ok))
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
