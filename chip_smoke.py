#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object with its seconds:

* ``device``: the card (``nvidia-smi`` name and power limit, SMs, shared
  memory per block, L2).
* ``build``: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
  (cache_matmul, cache_matmul_quant, block_fused_ffn, flash_attention,
  ssd_chunk, ssd_chunk_bwd) with ``nvcc`` for ``sm_90a``, one compiler per source, all
  at once; records each gemv / wgmma kernel's registers and spills and
  each library's wgmma (HGMMA) and TMA load instructions.
* ``kernels``: holds each kernel against its plain PyTorch version on the
  card, in bf16 and fp32 (TF32 off): the matmul and FFN kernels at
  full-width yi-9b decode shapes, a 256-row prefill-sized shape and a
  ragged one; flash attention native and quantized (int8, fp8) at the
  prefill path's shape, the MoE prefill's (olmoe: 16 K/V heads for 16
  query heads), non-causal, ragged and at hd 32, with the fp32
  quantized kernel bitwise equal to the native one on dequantized K/V;
  tiles and blocks lowered from full-width plans under several grants;
  cache_matmul_quant with int8 and fp8 codes at every compiled tile of
  the dtype, at the decode shapes, 256 and 2048 rows and ragged shapes
  (its gemv tile at up to 8 rows, its wgmma tile above); the fused FFN
  also at ragged rows, d_model and d_ff (its wgmma tile above 8 bf16
  rows, its gemv tile below); ssd_chunk at
  full-width mamba2 heads (B/C per batch row) for chunks of 256, 128,
  64, a 44-token tail and 1, and at the reduced shape.  Then times each
  kernel at the shape of each path that runs it (the FFN kernels at
  decode and at the prefill's 2048 rows, ssd_chunk at the prefill's and
  a serving chunk's), checked against its plain version on the timed
  inputs.  Every row names its tile's kind: bf16 ``cache_matmul`` runs
  the gemv tile at up to 8 rows and a wgmma tile above (also at ragged
  rows, N and K), bf16 flash attention at hd 128 the wgmma kernel of
  its K/V storage (native, or int8 / fp8 codes) and native at hd 64 the
  wgmma tile of the q rows that fill the card (timed in turns against
  the other), the bf16 fused FFN at the prefill's rows its
  cluster-reduced wgmma tile and at decode rows its gemv tile (beside
  its partial bytes and, as a yardstick of several calls, the unfused
  bf16 chain),
  bf16 ``ssd_chunk`` its wgmma kind, the rest the simt tiles; the gemv /
  wgmma tiles must repeat bitwise and are timed in turns against the
  simt tile of the same plan (``simt_ms``).
* ``e2e``: full-width yi-9b cut to 4 layers, random weights from one
  seed: prefill, then two teacher-forced decode epochs (an LBM plan and an
  LWM plan) with a native, an int8 and an fp8 KV cache, and
  ``make_prefill`` under an LBM plan with native KV and an LWM plan with
  int8 KV, on the card with the kernels, against the same entry points
  on the CPU with the same weights.
* ``serve``: slice 1's path.  ``MultiTenantServer`` serves two full-width,
  full-depth (48-layer) yi-9b tenants, one resident and one arriving with
  a 256-token prompt, for 32 steps.  The plan kinds must be those the
  scheduler (the reference's, copied) can grant at full width.  The
  kernels' launch counters are zeroed just before the run and read just
  after it; every cache_matmul launch must be of the gemv kind (so for
  e2e, self and prefill: no simt launch on the bf16 path).  The
  pipelined server dispatches every decode item and prompt chunk as a
  captured CUDA graph; the record holds its captures, capture seconds,
  graph pool bytes and program-cache counters.  Then three warm
  ``run()`` calls of the same server (the resident alone), each of which
  must build nothing (no capture, no LRU miss, ``epoch_compiles`` all
  0), with their median tokens/s and spread; then a decode item of the
  resident is replayed against its eager run, bitwise (every serve
  phase does so), and one replayed decode epoch is profiled for where
  the time goes.
* ``self``: serial (eager) against pipelined (graphs) serving on the
  card, token streams bitwise equal: full width (4 layers) in a starved
  pool, granted LWM, its two residents one bucket, and the reduced width
  in a pool where the scheduler grants LBM.
* ``graphs``: graph replay against eager dispatch at full width cut to
  4 layers: a yi-9b prompt tenant's chunks and epochs (native, then int8
  KV), a resident alone and two as a bucket, a mamba2 prompt's chunk and
  tail and its epochs; the eager run goes straight through the epoch /
  prefill core on cloned caches, tokens and positions.  Tokens and every
  cache buffer bitwise, the replay's launch counts equal the eager
  run's, and each decode item's second replay captures nothing.
* ``prefill``: slice 2's path.  ``make_prefill`` of full-width,
  full-depth yi-9b (2 prompts of 1024 tokens) plain, under the smallest
  LBM grant that lowers fused with native KV, and under 32-page LWM
  grants with int8 and fp8 KV; counters zeroed just before and read just
  after one pass of the four (every block_fused_ffn launch and every
  quantized flash launch of the wgmma kind); gated against the plain
  path on the card (int8 and fp8 also by cosine and against a control
  with the plain attention, traced layer by layer); timed, and profiled
  once per plan kind (LBM/native, LWM/int8, LWM/fp8).
* ``serve_kv``: slice 3's serving path.  ``MultiTenantServer(kv_dtype=
  "auto")`` serves full-width, full-depth yi-9b: a resident tenant and
  three 256-token prompt tenants arriving at distinct steps on one
  weight set, in a pool where the precision ladder must place them on
  native, fp8_e4m3 and (partially reserved) int8; rungs, reservations,
  cache dtypes and page scales are gated.  Three warm runs (as serve's)
  and a replayed decode epoch of the resident profiled; one decode epoch
  is profiled eagerly with a native and an int8 cache.
* ``ffn_quant``: slice 3's kernel path.  ``ops.planned_ffn_quant`` over
  the 48 layers' FFN weights quantized to int8 and to fp8, at 2 and 2048
  rows, under the serve_kv decode plan, the LWM@32p prefill plan and a
  fused plan (the fallback tile); the launches of the gemv kind (2 rows)
  and the wgmma kind (2048 rows) counted, none of the simt kind; gated
  against the plain chain and against ``planned_ffn`` on the bf16
  weights, timed per pass, and cache_matmul_quant timed per GEMM, in
  turns against the simt tile of the same plan.
* ``e2e_ssm``: slice 4.  Full-width mamba2-370m cut to 4 layers, random
  weights from one seed: ``make_prefill`` of a 300-token prompt (a
  256-token chunk and a 44-token tail segment) under grants of 32, 16
  and 4 pages (SSD chunks 256, 128, 64), then a prefill and two
  teacher-forced decode epochs, on the card with ssd_chunk against the
  CPU with its plain version.  Records whether a chunked prefill
  (256 + 44) equals the one-shot one bitwise on the card.
* ``prefill_ssm``: ``make_prefill`` of full-depth (48-layer) mamba2 on 2
  prompts of 1024 tokens under the three grants; counters zeroed just
  before and read just after one pass of the three (every ssd_chunk
  launch of the wgmma kind, as in serve_ssm and self_ssm); the plans' logits
  gated against each other on an fp32 copy of the weights (SSD is exact
  under any chunking), and in bf16 relative to a plain-version control;
  timed warm, and profiled once.
* ``serve_ssm``: ``MultiTenantServer(["mamba2-370m"], reduced=False)``,
  full depth, batch 2, max_len 1024, a 6500-page pool: a resident and
  two arrivals at steps 4 and 8 with 512- and 300-token prompts and
  16-step budgets, whose 3113-page state reservations both fit whole;
  free pages at each admission, tokens/s, TTFT per arrival and peak
  memory reported; counters zeroed just before the run and read just
  after; three warm runs (as serve's); one replayed decode epoch and one
  prefill chunk profiled.
* ``self_ssm``: serial against pipelined serving of full-width,
  full-depth mamba2 on the card: two residents and a 300-token arrival
  whose prompt chunks run ssd_chunk; token streams bitwise equal,
  choices and prefill chunks equal, ssd_chunk launched.

* ``e2e_moe``: the MoE slice.  Full-width olmoe-1b-7b (64 experts of
  d_ff 1024, top-8) cut to 4 layers, random weights from one seed:
  ``make_prefill`` of a 40-token prompt under an LBM plan, an LWM native
  plan and an LWM int8 plan (each expert's FFN through the plan's
  kernels, every launch of the wgmma kind), then a teacher-forced decode
  epoch (the gathered-expert path), on the card against the CPU with the
  plain versions.
* ``prefill_moe``: ``make_prefill`` of full-depth olmoe on 2 prompts of
  1024 tokens (328 bucket rows an expert) plain, under the smallest LBM
  grant that lowers fused at d_ff 1024, and 32-page LWM grants with
  native and int8 KV, then ``make_prefill(cfg, serve=True)`` (2048
  drop-free rows an expert) under the LWM plan; counters zeroed just
  before and read just after the five calls (3,072 cache_matmul launches
  under LWM, 1,024 block_fused_ffn under LBM, 16 flash), every launch of
  the wgmma kind; each plan gated against the plain path (the int8 plan
  also as the prefill phase's, its run and the control's compared layer
  by layer: relative drift, routing flips, displaced tokens); timed warm
  and profiled.  ``prefill`` and ``prefill_moe`` run one function.  The
  kernels phase times cache_matmul at one expert's 328 and 2048 rows and
  block_fused_ffn at its 328 rows.
* ``serve_moe``: ``MultiTenantServer(["olmoe-1b-7b"], reduced=False)``,
  full depth, batch 2, max_len 512, 32 steps: a resident and a
  256-token arrival at step 8, in a 2600-page pool that holds the
  arrival's 2048-page reservation.  The server's MoE path runs no
  hand-written kernel (as the reference's: decode gathers the experts,
  prompt chunks run the plain buckets), so its counters must stay 0.
  Three warm runs and a replayed decode epoch profiled, with the expert
  gather's share: ``serve``'s function with these arguments.
* ``self_moe``: serial (eager) against pipelined (graphs) serving of two
  olmoe residents at full width cut to 4 layers, bitwise, as a bucket.
  The ``graphs`` phase holds an olmoe prompt tenant's chunks (256 + 128)
  and epochs, a resident alone and two as a bucket, replay == eager.
* ``serve_mix``: the reference CLI's default pool, yi-9b, olmoe-1b-7b
  and mamba2-370m at full width, through ``repro_torch.launch.serve
  .main`` in this process (``--full-width --arrivals 2 --prompt-len
  256``, a pool that holds each arch's native reservation); its printed
  lines, tokens/s, TTFTs and grant trace kept.

* ``serve_prefix``: the serve-feature slice.  The reference's ``prefix``
  workload (3 chat sessions on 2 system prompts, 2 turns, 512-token
  prefix, 128 tokens a turn) on full-width, full-depth yi-9b at batch 1,
  served with prefix dedup on and off at a prefill chunk of 128 on one
  weight memo, in a pool holding every reservation (:data:`SERVE_PREFIX`;
  at full width a chunk of 256 lowers to 128, so it would repeat the
  run): at least two warm arrivals, fewer prompt tokens computed with
  dedup, each warm arrival's chunks covering its private suffix, on ==
  off bitwise;
  warm and cold TTFT, snapshot bytes, tokens/s and peak memory kept.
  Then a full-prompt re-arrival on olmoe-1b-7b and on mamba2-370m: no
  chunk, nothing computed, the producer's stream bit for bit.
* ``serve_faults``: preempt / resume through a checkpoint (yi-9b native
  and int8 KV, mamba2), each bitwise against an unfaulted run, with its
  checkpoint bytes and ``recovery_s`` (the recapture included); the
  prefix re-seed path on yi-9b, bitwise against its control; the
  reference's overload burst on mamba2 (queue drained, deferrals and
  sheds, every served tenant decoded, no exception caught); its faulted
  schedule on mamba2 twice (equal logs, bitwise tokens, free pages
  restored).  Parameters and pool derivations in :data:`SERVE_FAULTS`.
* ``lookahead``: the reference's contested scenario at full width
  (:data:`LOOKAHEAD`: an olmoe resident, two yi-9b arrivals), with and
  without grant lookahead: at least one grant adjusted, none without,
  the resident's grants differ between the runs, the same kernels of
  the same kinds in both runs and bitwise tokens.  The adjusted grant
  is the olmoe resident's, whose decode launches no plan-dependent
  kernel, and the yi-9b arrivals' plans are the same in both runs, so
  on the card the token gate holds by construction: what the phase
  shows is the full-width pricing and the adjusted grant on the host.
  Each new phase zeroes the counters before each server run and reads
  them after it; yi-9b's decode runs cache_matmul's gemv tile, mamba2's
  prompt chunks ssd_chunk.

* ``e2e_hybrid``: the hybrid slice, zamba2-2.7b (54 layers: 9 groups of
  5 Mamba2 layers and one shared attention + FFN block, d_model 2560,
  d_ff 10240, 80 SSM heads, state 64, sliding window 4096) cut to one
  group, random weights from one seed: ``make_prefill`` of a 300-token
  prompt under an LBM plan with native KV and an LWM plan with int8 KV,
  then a prefill and two teacher-forced decode epochs with native, int8
  and fp8 caches, on the card with the kernels against the CPU with the
  plain versions (:data:`HYBRID_E2E`).
* ``prefill_hybrid``: ``make_prefill`` of full-depth zamba2 on 2 prompts
  of 1024 tokens plain, under the LBM grant of the widest fused block
  (1184 pages), and 32-page LWM grants with native and int8 KV: the
  shared FFN through block_fused_ffn / cache_matmul, 45 ssd_chunk
  launches a call, every launch wgmma; no flash kernel (the sliding
  window keeps attention plain, as in the reference).  In bf16 each plan
  is held relative to a control (the plain path with ssd_chunk's plain
  version), and on an fp32 copy of the weights within 2e-2 of plain;
  timed and profiled.  ``prefill``'s function.
* ``serve_hybrid``: ``serve``'s function on full-depth zamba2
  (:data:`SERVE_HYBRID`: a resident and a 256-token arrival, a pool of
  the arrival's reservation and an LBM grant's pages): 27 gemv launches
  a decode step (9 groups x 3), ssd_chunk in the prompt chunk, three
  warm runs, a replayed epoch profiled; then a full-prompt re-arrival
  of 64 tokens (fewer than the 80 SSM heads), bitwise as the cold
  producer.
* ``self_hybrid``: serial == pipelined at one group, two residents and a
  300-token int8 arrival (:data:`SELF_HYBRID`).  The ``graphs`` phase
  holds zamba2's items at one group too, and the kernels phase times
  the kernels at its shapes (``hybrid_timings``).

* ``e2e_encdec``: the encoder-decoder slice, whisper-tiny at full width
  and depth (:data:`ENCDEC_E2E`): ``make_prefill`` of 2 x (1500 frames +
  448 decoder tokens) plain, under the smallest fused LBM grant and an
  LWM@32p grant (the decoder's flash attention at hd 64 on its wgmma
  tile, its FFN at 896 rows on the wgmma tiles; the encoder and the
  cross-attention plain, as in the reference), then two teacher-forced
  decode epochs over the encoder output (LBM@34p: the fused FFN's gemv
  tile; LWM@3p: cache_matmul's gemv), on the card against the CPU with
  the plain versions on the same weights (fp32 there); no simt launch
  of the bf16 kernels (the kinds gate).
* ``serve_encdec``: ``serve``'s function on whisper (:data:`SERVE_ENCDEC`:
  a resident and a 64-token arrival, a pool of the arrival's quote and
  the decode FFN's LBM candidate): decode granted LBM (block_fused_ffn's
  gemv tile, 4 launches a step) and LWM (gemv), each tenant's
  zero ``enc`` read by every cross-attention; three warm runs, a
  replayed epoch profiled with the fused FFN's share and the share of
  the cross-attention K/V projections over the 1500 frames.
* ``self_encdec``: serial == pipelined on whisper, two residents (one
  bucket, each with its own ``enc``) and a 64-token arrival
  (:data:`SELF_ENCDEC`).  The ``graphs`` phase holds whisper's items
  too, and the kernels phase holds flash attention at whisper's and
  llava's prefill shapes against the plain version and times the
  kernels at both archs' shapes (``encdec_vlm_timings``).  Its LWM@32p
  int8 plan runs the quantized flash kernel's wgmma tile at hd 64.
* ``e2e_vlm``: the VLM slice, llava-next-mistral-7b cut to 4 layers
  (:data:`VLM_E2E`): ``make_prefill`` of 2 x (576 patch embeddings + 40
  tokens) under an LBM plan (native KV) and an LWM@32p int8 plan, every
  launch wgmma, card against CPU (fp32 there).
* ``prefill_vlm``: ``prefill``'s function on full-depth llava-next, 2 x
  (576 patches + 1024 tokens) = 1600 positions: plain, the smallest
  fused LBM grant at d_ff 14336, LWM@32p native and int8 (held by cosine
  and against a plain-attention control); every launch wgmma; timed and
  profiled.
* ``serve_vlm``: ``serve``'s function on full-depth llava-next
  (:data:`SERVE_QUOTE`: a resident and a 256-token arrival, the pool the
  arrival's quote and 324 pages): every decode launch of the gemv kind.

* ``prefill_<arch>`` / ``serve_<arch>``: the four registered archs no
  earlier phase runs, at their published widths (:data:`MORE_ARCHS`):
  granite-3-8b (d_ff 12,800), mistral-nemo-12b (attention 4096 wide
  beside a 5120-wide residual), starcoder2-15b (48:4 GQA, d_ff 24,576),
  all 40 layers, and kimi-k2-1t-a32b cut to 1 layer of 61 (head dim
  112, 384 experts, top 8; two layers' weights would leave too little
  of the card).  ``prefill``'s function (kimi: ``moe_prefill_plans``;
  its flash and quantized flash launches wgmma at hd 112, none simt),
  then ``serve``'s (:data:`SERVE_QUOTE`, as serve_vlm, but resident and
  arrival on one weight set: two starcoder2-15b sets would be 88 GB;
  kimi's decode, like olmoe's, launches no kernel).  The kernels phase holds
  flash attention at kimi's prefill shape (hd 112) and quantized at
  whisper's (hd 64) and times both (``arch_timings``).

* ``serve_fleet``: the fleet slice (:data:`SERVE_FLEET`).  The
  reference's ``fleet`` entry at full width: a ``FleetServer`` of 2
  replicas, both on the card, serves two yi-9b and two mamba2-370m
  256-token prompt tenants arriving together (batch 1, max_len 2048,
  epoch 8, 12 decode steps each), 2,649 pages a replica (the two
  archs' native quotes and 324).  Gated: every tenant's params, caches
  and buffers on its replica's device, one tenant of each arch a
  replica, each replica's decode streams bitwise equal to a replay of
  ``replica_scenarios()[r]`` on a fresh single-card server, and the
  fleet's launch counts (yi-9b's decode gemv, mamba2's prompt-chunk
  ssd_chunk) equal to the replays' sums.  Routes, per-replica tokens and
  page utilization, the fleet's wall and each replay's are kept; then
  one fleet round warm (the four tenants as residents, one round
  captured, then timed and profiled: tokens/s and the device's idle
  share), building nothing.
* ``fleet_failover``: the reference's failover scenario at full width
  (:data:`FLEET_FAILOVER`): three mamba2 tenants on 2 replicas, r0
  killed at step 8: every moved tenant completes on r1 with a
  ``recovery_s`` entry and r0 keeps no page or buffer; then again with
  r1 killed at step 12 too, which is logged as skipped ("last live
  replica") and raises nothing.

* ``serve_tp``: the tensor-parallel slice (:data:`SERVE_TP`), the
  reference's tp = 2 fleet scenario (tests/test_fleet.py:166) at full
  width: ``FleetServer(n_replicas=2, tp=2, devices=["cuda:0"] * 4)``,
  two full-depth yi-9b tenants (bf16), one a replica, the second with a
  128-token prompt, 16 steps.  Gated: every 'model'-split leaf's pieces
  on the group's devices at 1/tp of its bytes (bytes per shard
  printed), each attention cache one piece a shard (its KV heads) on
  the shard's device, every other leaf and buffer on the group's first
  device;
  each replica's streams bitwise equal to a replay on a fresh tp = 2
  group; the run repeated bitwise; a warm round (the two as residents)
  building nothing.  Then, the tp = 2 weights freed, a tp = 1 fleet on
  the same weights rebuilt from the same seeds: tp = 2 runs exactly
  twice its cache_matmul gemv launches (counters zeroed just before each
  run, read just after), every one at a shard's shape (4096 x 5504 and
  5504 x 4096), none on a whole FFN weight; warm tokens/s of both (a
  record, not a gate).
* ``e2e_tp``: all six families at full width cut to 2–6 layers
  (:data:`E2E_TP`; olmoe in both MoE modes), one seed's weights at
  tp = 2 on ``[cuda:0, cuda:0]`` against tp = 1: ``make_prefill`` and a
  prompt chunk with teacher-forced decode epochs under an LWM plan and,
  where the family has an FFN, an LBM plan; logits within 2e-2 of the
  largest (:func:`_gate`) and bitwise on a repeat; the plan kernels'
  launches at tp = 2 on each shard's d_ff slice, twice tp = 1's (once
  an expert under ``"fsdp"``).  An eager decode step's time at tp = 2
  and tp = 1 is recorded (:func:`_decode_ms`), not gated.
* ``example``: ``python -m repro_torch.examples.multi_tenant_serve
  --full-width --steps 6`` in a process of its own; rc 0 and its report.
* ``train_ssm``: the training slice (:data:`TRAIN_SSM`).
  ``repro_torch.launch.train.main`` trains full-width, full-depth
  mamba2-370m (bf16, remat, seq 1024 = four SSD chunks of 256, batch 8)
  for 10 steps on the card, checkpointing at 5 and 10; counters zeroed
  just before and read just after: 96 forward ssd_chunk launches a step
  (48 layers, again under remat; wgmma) and 48 ssd_chunk_bwd (wgmma), no
  other kernel; the loss finite and falling, no supervisor restart.  The
  checkpoint of step 5 restored into a fresh ``build`` replays steps 5
  and 6 with the first run's losses.  Step ms, tokens/s, model FLOP/s
  share, peak memory, checkpoint bytes and seconds, one profiled step.
  Gradients (:func:`train_grad_gates`): at full width cut to 2 layers
  in fp32 against the same step with ssd_chunk and its backward swapped
  for their plain versions (the simt kinds), and remat on == off
  bitwise; at full depth in bf16 relative to that plain-path control.
  The kernels phase holds ssd_chunk_bwd (wgmma and simt for bf16, simt
  for fp32) against its plain version and autograd at mamba2's (Q 256,
  a 44-token tail, Q 1), zamba2's and the reduced shape, and times the
  wgmma kind in turns against the simt kind at the prefill's and the
  train step's shapes, and the forward at the train step's.
* ``train_100m``: ``repro_torch.examples.train_100m --full`` (lm-100m,
  fp32) for 40 steps with its preemption at 20 and resume.
* ``train_cli``: ``launch/train.py::main --smoke`` for each of the six
  families on the card, then reduced olmoe in bf16, whose expert
  gradients come through ``models/moe.py::_dot_f32``'s bf16 bmm.
* ``dryrun``: the dry run (``launch/dryrun.py``) against the card
  (:data:`DRYRUN`).  yi-9b's plan-less ``make_prefill`` at full width
  and depth (2 x 2048) traced on fake tensors at a (1, 1) group: its
  argument bytes equal the live params' and tokens' exactly, its FLOPs
  ``FlopCounterMode``'s over the real call on the card exactly (no
  kernel is on that path), and its predicted peak (arguments + temp)
  within 10% of ``max_memory_allocated``; the roofline bound beside the
  measured ms.  mamba2-370m's train step (8 x 1024): argument bytes
  (params, AdamW state, batch) exact, and its FLOPs ``FlopCounterMode``'s
  exactly (the trace prices ssd_chunk and its backward as the kernels
  the card runs, by the FLOP formulas ``FlopCounterMode`` applies to
  them there); predicted and measured peak recorded, the bound beside
  the measured step ms.  Each trace launches no kernel and moves
  ``memory_allocated`` by nothing.  Then the CLI, ``python -m
  repro_torch.launch.dryrun --arch whisper-tiny --shape decode_32k
  --multi-pod --roofline`` (rc 0, "0 failures"), and ``python -m
  repro_torch.launch.roofline --mesh 2x16x16`` over its report, both
  with their report folder under ``build/chip_smoke/`` (the committed
  reports stay as they are); its argument bytes printed beside the
  reference's XLA figure.
* ``paper``: the analytic simulator's figure drivers from the port
  alone (``repro_torch.paper``: Figs. 2, 3, 7, 8, 9, Table III and the
  arrival sweep, each ``main()`` once at the reference's sizes) and
  ``python -m repro_torch.examples.quickstart``, on the card's host:
  they price the paper's simulated NPU SoC and launch nothing.  Each
  driver's CSV line and wall seconds are recorded, and the
  reference's acceptance bands (:data:`PAPER_BANDS`, from
  tests/test_sim.py and tests/test_codegen.py) are held: Fig. 7's
  average speedup and memory reduction, the area model's Table III
  shares, Fig. 3's reuse shares, and ``run_candidate``'s executed DRAM
  bytes against the mapper's.  No module of JAX (``jax``, ``jaxlib``,
  ``flax``) or of the JAX package (``repro``, ``benchmarks``) is loaded.

Then it prints the card's ``nvidia-smi`` line, the ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  With no CUDA device, or without the port's sources beside this
file, it exits non-zero and prints no result.  A fuller report goes to
``build/chip_smoke/`` (``chip_smoke.json``, the kernel cases, the
compiler logs).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-3}     # tests/test_kernels.py::tol

SERVE_PAGES = 1800     # an LBM grant (324 pages, where one exists) fits
#                        before the arrival's KV reservation (1536 pages)
SERVE_STEPS = 32
# warm runs: more run() calls of a served server, each building nothing
# (its programs were captured in the first run); their steps keep the
# resident inside the 128-token window the cold run used, so every
# program key repeats
WARM_RUNS = 3
ARRIVAL = dict(arrive_at=8.0, prompt_len=256, n_inferences=16)
# serial vs pipelined: (width, pages).  Full width is granted LWM only, so
# the starved full-width pool holds cache_matmul; block_fused_ffn's
# bitwise contract is held at the reduced width, where the scheduler
# grants LBM.
SELF_POOLS = (("full", 16), ("reduced", 64))
# prefill and prefill_moe: make_prefill at 2 x 1024 tokens, full depth
PREFILL = dict(batch=2, prompt_len=1024, lwm_pages=32)
# quantized-KV serving: batch 2, three 256-token arrivals with a 16-step
# budget at distinct steps, beside a resident decoding for `steps` steps
SERVE_KV = dict(batch=2, max_len=512, prompt_len=256, budget=16, steps=40,
                warm_steps=24, arrive_at=(4.0, 8.0, 12.0))
# Cosine bars of the quantized-KV prefill against the plain path.  int8:
# tests/test_quant_decode.py's 0.999.  fp8_e4m3 keeps 3 mantissa bits, a
# per-element error about three times int8's at hd 128; over 48 layers
# of random weights it reaches 0.9989 with the plain attention as well
# as with the kernel (the control in prefill_main_path, PERF.md), so its
# bar is 0.998.
PREFILL_COSINE = {"int8": 0.999, "fp8_e4m3": 0.998}
KV_CACHES = ("int8", "fp8_e4m3")
ATTN_GRANTS = (9, 32, 60)                   # pages; lower_attn -> blocks
# cache_matmul parity at ragged rows (gemv at 1, 2, 7; wgmma above), N and
# K not multiples of the tiles; K = 333 sends bf16 at 37 rows to simt
MM_RAGGED = ((1, 333, 1000), (2, 520, 1000), (7, 333, 1000), (37, 333, 1000),
             (37, 520, 1000), (65, 4096, 1000), (300, 520, 1000),
             (300, 1000, 4104))
# cache_matmul_quant's ragged (M, K, N): gemv rows with K, N off the tile;
# wgmma rows with K % 8 == 0 and N % 16 == 0 (TMA) off the 64 x 256 tile
MQ_RAGGED = ((1, 333, 1000), (2, 520, 1000), (7, 333, 1000), (37, 520, 1008),
             (65, 4096, 1008), (300, 1000, 4112))
SSM_ARCH = "mamba2-370m"
# ssd_chunk cases: the chunks the plans lower (256, 128, 64), a prompt's
# tail segment (44) and one token, each over three chunks
SSD_CHUNKS = (256, 128, 64, 44, 1)
# grants whose SSD chunk lowers to 256, 128 and 64
# (core/plan.py::lower_ssm_chunk: the thresholds are 24 and 6 pages)
SSM_GRANTS = (32, 16, 4)
SSM_E2E = dict(layers=4, batch=2, prompt_len=300)   # 256 + a 44-token tail
SSM_PREFILL = dict(batch=2, prompt_len=1024)
# two arrivals (step, prompt tokens) beside a resident; the pool holds
# both 3113-page state reservations whole
SERVE_SSM = dict(batch=2, max_len=1024, pages=6500, steps=32, budget=16,
                 arrivals=((4.0, 512), (8.0, 300)))
# serial == pipelined: two residents and an arrival (step, prompt tokens)
SELF_SSM = dict(batch=2, max_len=512, steps=16, budget=8, arrival=(4.0, 300))
# graph replay against eager dispatch, full width cut to 4 layers: yi-9b
# residents (one alone, two as a bucket) and a prompt tenant per KV rung,
# a mamba2 prompt tenant whose 300 tokens make a 256-token chunk and a
# 44-token tail; each decode item is checked at two positions (capture,
# then a replay of the same graph)
GRAPHS = dict(layers=4, batch=2, max_len=512, prompt_len=384,
              ssm_prompt_len=300, lwm_pages=32, k=4)
# bf16 agreement of the chunk plans at full depth: each plan's 1 - cosine
# against the 256-chunk plan within SSM_BF16_SPREAD times the control's
# (the plain version vs the kernel at chunk 256; first readings on the
# H100: 0.0065 and 0.0107 against 0.0057), or SSM_BF16_FLOOR where the
# control agrees closer, and the control's cosine at least SSM_BF16_COSINE
SSM_BF16_SPREAD = 3.0
SSM_BF16_FLOOR = 1e-3
SSM_BF16_COSINE = 0.98
MOE_ARCH = "olmoe-1b-7b"
# e2e_moe: 4 layers, a 40-token prompt (8 slots an expert: 16 bucket rows)
MOE_E2E = dict(layers=4, batch=2, prompt_len=40, lwm_pages=32)
# serve_moe (serve_main_path's arguments): a resident and an arrival at
# step 8; the pool holds the arrival's native KV reservation (2048
# pages) beside the grants
SERVE_MOE = dict(batch=2, max_len=512, pages=2600, steps=32, arrival=ARRIVAL)
SELF_MOE = dict(layers=4, batch=2, max_len=64, pages=1024, steps=12)
# serve_mix: the reference CLI's default pool at full width; the pool
# holds every arch's native reservation of one prompt beside the grants
SERVE_MIX = dict(archs=("yi-9b", MOE_ARCH, "mamba2-370m"), arrivals=2,
                 prompt_len=256, headroom=600)
# the kernel of a decode step's expert-weight gather
# (``params["gate"][top_e]``, PyTorch's indexing on dim 0)
GATHER_KERNEL = "vectorized_gather_kernel"
# serve_prefix: the reference's `prefix` benchmark workload
# (benchmarks/run.py::serve_prefix_bench) on full-width yi-9b.  The
# logical clock runs at 8 steps/s, not the reference's 4: at full width
# the grants lower every prompt chunk to 128 tokens (the reference's
# reduced width prefills in 256, and a chunk of 256 lowers to 128 as
# well, so only 128 is run), so a producer's prefill takes twice the
# epochs, and the arrival gaps must outlast it for the warm arrivals the
# workload is built for (tests/test_torch_prefix.py shows the schedule
# at both rates).  The pool holds every arrival's full reservation
# (3 pages a token at batch 1) beside `headroom` pages of grants, so no
# resident prefix is evicted mid-scenario.  Dedup on and off; the
# full-prompt re-arrivals (the reference's
# test_full_prompt_rearrival_skips_prefill) on olmoe and mamba2.
SERVE_PREFIX = dict(
    arch="yi-9b", sessions=dict(n_sessions=3, turns=2, n_prompts=2,
                                prefix_len=512, turn_tokens=128, gap_s=2.0,
                                n_inferences=8, seed=0),
    batch=1, max_len=1024, epoch_len=8, steps_per_s=8.0, steps=24,
    headroom=256, chunk=128,
    rearrival=dict(archs=(MOE_ARCH, SSM_ARCH), prompt_len=256,
                   n_inferences=6, max_len=512, at=(0.0, 4.0),
                   steps_per_s=4.0))
# serve_faults: the reference faults benchmark's scenarios
# (benchmarks/run.py::serve_faults_bench, tests/test_faults.py).  Pools:
# `pool_quotes` times the arch's full-width native quote of the prompt,
# as the reference's 64 pages are 32 of its 2-page quotes (preempt /
# resume and the faulted schedule); the burst's pool holds `burst_quotes`
# reservations, half of the 8 its queue keeps (the reference's 8 pages
# hold 4 of its 2-page quotes: "2x oversubscribed"); the pressure event
# seizes three quarters of the pool (48 of 64 pages in the reference).
SERVE_FAULTS = dict(
    dense="yi-9b", ssm=SSM_ARCH, batch=1, max_len=128, epoch_len=4,
    prompt_len=32, n_inferences=24, steps=24, pool_quotes=32,
    preempt=dict(step=8, hold_epochs=2),
    cases=(("yi-9b", "native"), ("yi-9b", "int8"), (SSM_ARCH, "native")),
    reseed=dict(prompt_len=32, n_inferences=4, follow=8, warm_steps=8,
                steps=16),
    burst=dict(n=12, prompt_len=96, n_inferences=8, arrive_at=0.5,
               queue_limit=8, queue_deadline_s=24.0, burst_quotes=4,
               steps=16),
    schedule=dict(pressure_step=4, straggler_step=12, straggler_hold=3,
                  preempt_step=16, preempt_hold=1, arrivals=(0.0, 1.0),
                  steps=32))
# lookahead: the reference's contested scenario
# (tests/test_alloc_batch.py::test_lookahead_adjusts_contested_grants
# _without_changing_tokens) at full width: two yi-9b arrivals of 192
# tokens at 3.0 and 3.25 s beside a resident, batch 1, max_len 256,
# epoch 2.  The resident is olmoe-1b-7b: at full width the reference's
# rule never adjusts a yi-9b resident (the NEC prices its stable grant
# tens of MB an epoch above the aggressive one, the page thrash it saves
# at most 5.6 MB; tests/test_torch_lookahead.py).  The pool holds both
# arrivals' reservations and `spare` pages, fewer than the resident's
# 164-page LBM grant: their reservations contest it.
LOOKAHEAD = dict(resident=MOE_ARCH, arrival="yi-9b", prompt_len=192,
                 n_inferences=8, resident_steps=24, arrive_at=(3.0, 3.25),
                 batch=1, max_len=256, epoch_len=2, spare=32, steps=24)
# the hybrid slice: zamba2-2.7b (54 layers: 9 groups of 5 Mamba2 layers
# and the shared attention + FFN block; d_model 2560, d_ff 10240, 80 SSM
# heads of P 64, state 64, sliding window 4096)
HYBRID_ARCH = "zamba2-2.7b"
# e2e_hybrid: one group (6 layers); a 300-token prompt (a 256-token SSD
# chunk and a 44-token tail) under the e2e phase's LBM and LWM grants
HYBRID_E2E = dict(batch=2, prompt_len=300, lbm_pages=324, lwm_pages=32)
# serve_hybrid (serve_main_path's arguments but the pool): a resident
# and a 256-token arrival at step 8, in a pool of the arrival's native
# reservation (_kv_reserve_pages: 5127 pages) and `headroom` pages, as
# many as an LBM grant at 128 rows claims (the serve phase's 324; at full
# width the scheduler has no LBM candidate, as for yi-9b); then a
# full-prompt re-arrival of a 64-token prompt, shorter than the 80 SSM
# heads that the snapshot of the state must keep whole
SERVE_HYBRID = dict(batch=2, max_len=512, steps=32, arrival=ARRIVAL,
                    headroom=324,
                    rearrival=dict(prompt_len=64, n_inferences=6, max_len=256,
                                   at=(0.0, 4.0), steps_per_s=4.0,
                                   epoch_len=8, steps=24))
# self_hybrid: serial == pipelined at one group, two residents and a
# 300-token arrival with an int8 cache (its K/V dicts carry scale leaves,
# its Mamba2 dicts do not: the first-token stamp reads the scales of the
# K/V dicts only)
SELF_HYBRID = dict(batch=2, max_len=512, steps=16, budget=8, arrival=(4.0, 300),
                   pages=1 << 16, kv_dtype="int8", matmul=("gemv",))
# the encoder-decoder and VLM slice.  whisper-tiny: 4 encoder and 4
# decoder layers, d_model 384, 6 heads of 64, d_ff 1536, vocab 51865
# (padded to 51968), 1500 frames; llava-next-mistral-7b: the Mistral-7B
# decoder (32 layers, d_model 4096, 32 / 8 heads of 128, d_ff 14336,
# vocab 32000) and 576 patch embeddings (one 24 x 24 tile)
ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "llava-next-mistral-7b"
# e2e_encdec: full depth, make_prefill of 2 x (1500 frames + 448 decoder
# tokens, whisper's decoder context) plain, under the smallest fused LBM
# grant at 448 rows and an LWM@32p grant; two teacher-forced decode
# epochs under the grants serve_encdec's decode gets (LBM@34p: the fused
# FFN's gemv tile; LWM@3p: cache_matmul's gemv)
ENCDEC_E2E = dict(batch=2, prompt_len=448, lwm_pages=32, decode_lbm_pages=34,
                  decode_lwm_pages=3)
# (the LWM@32p grant also with int8 KV: quantized flash at hd 64)
# serve_encdec (serve_main_path's arguments but the pool): a resident and
# a 64-token arrival at step 8, batch 2, max_len 448, in a pool of the
# arrival's native quote and the decode FFN's LBM candidate (24 + 15
# pages, _lbm_pool): the resident is granted LBM alone and LWM beside the
# arrival, so decode runs the fused FFN's gemv tile and cache_matmul's gemv
SERVE_ENCDEC = dict(batch=2, max_len=448, steps=32,
                    arrival=dict(arrive_at=8.0, prompt_len=64,
                                 n_inferences=16))
# the fused FFN's kernels, by name, for a profile's shares: the decode
# kind's cluster kernel, the simt tile's and the slab reduce
FUSED_FFN_KERNELS = ("ffn_gemv_kernel", "ffn_partial_kernel",
                     "ffn_reduce_kernel")
# self_encdec: serial == pipelined, two whisper residents (one bucket in
# the first epoch, each with its own enc buffer) and a 64-token arrival,
# in a pool where every decode is granted LBM (the fused FFN's gemv
# tile).  In serve_encdec's contended pool the serial loop's
# per-step grants differ from the pipelined loop's per-epoch ones, so
# the two would run different kernels
SELF_ENCDEC = dict(batch=2, max_len=448, steps=16, budget=8, arrival=(4.0, 64),
                   pages=1 << 16, kernels=("block_fused_ffn",),
                   kinds=dict(ffn=("gemv",)), bucket=True)
# e2e_vlm: 4 layers, make_prefill of 2 x (576 patches + 40 tokens) under
# an LBM plan (native KV) and an LWM@32p int8 plan
VLM_E2E = dict(layers=4, batch=2, prompt_len=40, lwm_pages=32)
# serve_vlm and serve_<arch>: serve's arguments, in a pool of the
# arrival's native quote and the serve phase's 324 pages of headroom (no
# LBM candidate at full width, as for yi-9b)
SERVE_QUOTE = dict(batch=2, max_len=512, steps=32, arrival=ARRIVAL,
                   headroom=324)
# the four archs no earlier phase runs, at their published widths (label,
# arch, layers kept: None for all).  kimi-k2's 61 layers are cut to one:
# its weights are 0.6 GB a layer outside the experts and 33.8 GB of
# experts (384 x 3 x 7168 x 2048 bf16), beside 4.7 GB of embedding and
# unembedding, so two layers (~72.6 GB) would leave too little of 80 GB
# for the activations, the decode expert gather and the graph pools
MORE_ARCHS = (("granite", "granite-3-8b", None),
              ("nemo", "mistral-nemo-12b", None),
              ("starcoder2", "starcoder2-15b", None),
              ("kimi", "kimi-k2-1t-a32b", 1))
# the fleet slice.  serve_fleet: the reference's `fleet` benchmark entry
# (benchmarks/run.py:279-292: identical prompt tenants arriving together,
# batch 1, max_len 2048, epoch_len 8, 12 decode steps, 256-token
# prompts) at full width on one card: 2 replicas both on the card, two
# yi-9b and two mamba2-370m tenants (~37 GB of weights; the reference's
# 8 olmoe weight sets would not fit).  The router's ties send one of each
# arch to each replica, so a replica's pool is the two archs' native
# quotes of one prompt and `headroom` pages, serve's 324 (the LBM grant
# at 128 rows its pool leaves room for).  `steps` bounds the run (the
# budgets end it).  A warm round: a fleet of the same four tenants as
# residents on the same weights, `epoch_len` steps a run() (one fleet
# round), captured once, then timed and profiled
SERVE_FLEET = dict(archs=("yi-9b", "yi-9b", SSM_ARCH, SSM_ARCH), replicas=2,
                   batch=1, max_len=2048, epoch_len=8, prompt_len=256,
                   n_inferences=12, steps=24, headroom=324)
# fleet_failover: the reference's failover scenario (benchmarks/run.py:
# 414-422, tests/test_faults.py::test_replica_kill_fails_over_to_survivors
# and ::test_kill_last_live_replica_is_refused) at full width: 2
# replicas on the card, three mamba2-370m tenants with 32-token prompts
# and 24-step budgets arriving at 0, 1 and 2 s, r0 killed at step 8;
# then the same with r1 killed at step 12 too (refused: the last live
# replica).  A replica's pool holds the three native quotes
FLEET_FAILOVER = dict(arch=SSM_ARCH, tenants=3, prompt_len=32, n_inferences=24,
                      batch=1, max_len=128, epoch_len=4, steps=24,
                      kill=(8, "r0"), last_kill=(12, "r1"))
# the training slice: ssd_chunk_bwd held at full-width mamba2 (B 2,
# 32 heads, N 128), zamba2 (80 heads, N 64) and the reduced shape, and
# timed at the prefill's and the train step's shapes; full-width,
# full-depth mamba2 trained through launch/train.py (seq 1024 = four
# 256-token SSD chunks, batch 8, 10 steps, checkpoints at 5 and 10, the
# resume from 5 replayed for RESUME_STEPS steps); its gradients held at
# 2 layers in fp32 against the plain versions (TOL, relative to each
# gradient's largest magnitude) and at full depth in bf16 relative to a
# plain-path control (1 - cosine to the fp32 gradients within
# SSM_BF16_SPREAD times the control's, or SSM_BF16_FLOOR), on GRAD_BATCH
# serve_tp: the reference's tensor-parallel fleet
# (tests/test_fleet.py:166: FleetServer(n_replicas=2, tp=2, batch=1,
# max_len=256, epoch_len=4), two yi-9b tenants) at full width and depth
# on one card: both groups' four devices are cuda:0.  The second tenant
# has a 128-token prompt, so prefill runs under tp; a replica's pool is
# its native quote and serve's 324 pages of headroom
SERVE_TP = dict(arch="yi-9b", replicas=2, tp=2, batch=1, max_len=256,
                epoch_len=4, steps=16, prompt_len=128, n_inferences=12,
                headroom=324)
# e2e_tp: (arch, MoE mode, layers) at full width, tp = 2 against tp = 1;
# zamba2 keeps one group of attn_every layers
E2E_TP = (("yi-9b", None, 4), ("mamba2-370m", None, 4),
          ("olmoe-1b-7b", "fsdp", 2), ("olmoe-1b-7b", "ep2d", 2),
          ("zamba2-2.7b", None, 6), ("whisper-tiny", None, 4),
          ("llava-next-mistral-7b", None, 4))
TRAIN_SSM = dict(steps=10, seq_len=1024, global_batch=8, ckpt_every=5,
                 lr=3e-4)
RESUME_STEPS = 2
GRAD_BATCH = dict(batch=2, seq_len=1024)
TRAIN_100M = dict(steps=40)
TRAIN_CLI = dict(steps=6, seq_len=64, global_batch=2, lr=1e-3)
# the dry run (launch/dryrun.py) held against runs on the card: yi-9b's
# plan-less prefill at the prefill phase's shape and mamba2's train step
# at train_ssm's, each traced on fake tensors at a (1, 1) group, then the
# CLI at whisper-tiny x decode_32k x 2x16x16.  The predicted peak
# (arguments + temp) of the prefill within PEAK_TOL of the card's.
DRYRUN = dict(prefill=dict(arch="yi-9b", batch=2, seq_len=2048),
              train=dict(arch=SSM_ARCH, batch=8, seq_len=1024, steps=3),
              cli=dict(arch="whisper-tiny", shape="decode_32k"),
              peak_tol=0.10, timed=3,
              # the reference's XLA figure for the CLI's cell
              # (experiments/dryrun/whisper-tiny__decode_32k__2x16x16.json)
              xla_argument_bytes=109_250_324)


# the paper phase: the figure drivers (repro_torch.paper) in the order
# of the reference's benchmarks/run.py, and the reference's acceptance
# bands as numbers: tests/test_sim.py:118-149 (Fig. 7), :152-166 (the
# area model, (expected, relative or absolute tolerance)), :169-176
# (Fig. 3), tests/test_codegen.py:72-82 (run_candidate within 2% of the
# mapper's analytic DRAM bytes)
PAPER = ("fig2_contention", "fig3_reuse", "fig7_speedup", "fig8_scaling",
         "fig9_qos", "table3_area", "arrival_sweep")
PAPER_BANDS = dict(
    speedup_avg=(1.5, 2.4), speedup_max=3.0, mem_reduction=(0.25, 0.45),
    npu={"NPU": (7905e3, "rel", 0.05), "Scratchpad": (0.797, "abs", 0.02),
         "PE Array": (0.165, "abs", 0.02), "CPT": (0.009, "abs", 0.004)},
    slice={"Cache Slice": (24676e3, "rel", 0.05),
           "Data Array": (0.887, "abs", 0.02),
           "Tag Array": (0.097, "abs", 0.02), "NEC": (0.003, "abs", 0.002)},
    no_reuse=(55, 80), over_1mb=(45, 80),
    codegen=((512, 1024, 2048, 0), (512, 1024, 2048, 12 * 2**20),
             (100, 70, 3000, 2**20), (333, 129, 777, 2**20)),
    codegen_rel=0.02)


def _phase(name, fn, *args, **kwargs):
    """Run one phase and print its record; the record is also appended
    to ``phases.jsonl`` in :data:`OUT_DIR`, so a run that fails later
    keeps the records of the phases before."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    rec = {"phase": name, **out, "seconds": round(time.perf_counter() - t0, 3)}
    line = json.dumps(rec)
    print(line, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "phases.jsonl", "a") as f:
        f.write(line + "\n")
    return rec


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------- device --
def device_info():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    p = torch.cuda.get_device_properties(0)
    return {"nvidia_smi": smi, "name": p.name, "sms": p.multi_processor_count,
            "smem_per_block_optin": p.shared_memory_per_block_optin,
            "l2_bytes": getattr(p, "L2_cache_size", None),
            "memory_bytes": p.total_memory, "torch": torch.__version__,
            "cuda": torch.version.cuda, "count": torch.cuda.device_count()}


# -------------------------------------------------------------- build --
def build_kernels():
    from repro_torch.kernels import build
    report = build.build()
    out = {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, rep in report.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(rep["log"])
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep["log"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             rep["log"])]
        out[name] = {"seconds": round(rep["seconds"], 3),
                     "max_registers": max(regs, default=None),
                     "max_spill_store_bytes": max(spills, default=None),
                     "tensor_core_kernels": _ptxas_entries(rep["log"]),
                     "sass": _sass_counts(build.library_path(name))}
    return {"nvcc": build.nvcc(), "sources": out}


def _sass_counts(lib):
    """How many wgmma (HGMMA) and TMA load (UTMALDG) instructions the
    library's machine code holds, by ``cuobjdump -sass`` (the toolkit's,
    beside ``nvcc``)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return "cuobjdump not found"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}


def _ptxas_entries(log: str):
    """Registers, spill bytes and static shared memory that ``-Xptxas -v``
    reports for each gemv / wgmma kernel of one library (their dynamic
    shared memory is the menu's ``smem_bytes``)."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if not re.search(r"gemv|wgmma", name):
            continue
        num = lambda pat: int(m.group(1)) if (m := re.search(pat, block)) else 0  # noqa: E731
        out[name] = {"registers": num(r"Used (\d+) registers"),
                     "spill_store_bytes": num(r"(\d+) bytes spill stores"),
                     "spill_load_bytes": num(r"(\d+) bytes spill loads"),
                     "static_smem_bytes": num(r"(\d+) bytes smem")}
    return out


# ------------------------------------------------------------ kernels --
def _randn(gen, shape, dtype, scale=1.0):
    import torch
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _close(got, want, dtype_name):
    import torch
    tol = TOL[dtype_name]
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    return err, ok


def kernel_cases(cfg, dev):
    """Every kernel against its plain version: decode and prefill-sized
    rows, a ragged shape, tiles from full-width plans under several
    grants; bf16 and fp32."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE, fused_ffn_pages
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dtype_name(dtype)
        eb = torch.tensor([], dtype=dtype).element_size()
        mm = []
        for pages in (32, 64, 300):
            plan = lower_ffn(LANE, d, f, eb, pages, want_fused=False)
            for m in (2, 256):
                mm.append((f"lwm@{pages}p up", m, d, f, plan.up_tile))
                mm.append((f"lwm@{pages}p down", m, f, d, plan.down_tile))
        ragged = lower_ffn(LANE, 333, 1000, eb, 64, want_fused=False)
        mm.append(("ragged", 37, 333, 1000, ragged.up_tile))
        # ragged rows, N and K under the path's smallest plan tile
        path_tile = lower_ffn(LANE, d, f, eb, 32, want_fused=False).up_tile
        mm += [(f"ragged m{m}", m, k, n, path_tile) for m, k, n in MM_RAGGED]
        for label, m, k, n, tile in mm:
            a = _randn(gen, (m, k), dtype)
            b = _randn(gen, (k, n), dtype, 1 / math.sqrt(k))
            got = ops.planned_matmul(a, b, tile)
            err, ok = _close(got, kmm.cache_matmul_plain(a, b), dn)
            hop = ops.legalize_matmul_tile(tile, m, limit, dtype, k, n)
            row = {"kernel": "cache_matmul", "case": label, "dtype": dn,
                   "shape": [m, k, n], "plan_tile": [tile.bm, tile.bn, tile.bk],
                   "kind": hop.kind, "hopper_tile": [hop.bm, hop.bn, hop.bk]}
            if hop.kind != "simt":       # two launches are bit-identical
                row["bitwise_repeat"] = bool(torch.equal(
                    got, ops.planned_matmul(a, b, tile)))
                ok = ok and row["bitwise_repeat"]
            rows.append({**row, "max_abs_err": err, "tol": TOL[dn], "ok": ok})
        ffn = []
        # the smallest LBM grant, and two that widen block_f
        for pages in (fused_ffn_pages(LANE, d, f, eb), 300 * eb, 600 * eb):
            plan = lower_ffn(LANE, d, f, eb, pages, want_fused=True)
            for s in (2, 256):
                ffn.append((f"lbm@{pages}p", s, d, f, plan))
        ffn.append(("ragged", 37, 333, 1000,
                    lower_ffn(LANE, 333, 1000, eb, 4096, want_fused=True)))
        # ragged rows with d_model and d_ff off the wgmma tile and its
        # cluster (d_ff 1000: 8 tiles of 128, the last one partial)
        ragged_ffn = lower_ffn(LANE, 520, 1000, eb, 4096, want_fused=True)
        ffn += [(f"ragged s{s}", s, 520, 1000, ragged_ffn)
                for s in (1, 2, 7, 37, 65, 300)]
        for label, s, dd, ff, plan in ffn:
            if not plan.fused:
                raise AssertionError(f"{label}: plan {plan} is not fused")
            x = _randn(gen, (s, dd), dtype)
            wg = _randn(gen, (dd, ff), dtype, 1 / math.sqrt(dd))
            wu = _randn(gen, (dd, ff), dtype, 1 / math.sqrt(dd))
            wd = _randn(gen, (ff, dd), dtype, 1 / math.sqrt(ff))
            got = ops.fused_ffn(x, wg, wu, wd, block_s=plan.block_s,
                                block_f=plan.block_f)
            err, ok = _close(got, kffn.block_fused_ffn_plain(x, wg, wu, wd), dn)
            hop = ops.legalize_ffn_tile(plan.block_s, min(plan.block_f, ff), s,
                                        limit, dtype, dd, ff)
            row = {"kernel": "block_fused_ffn", "case": label, "dtype": dn,
                   "shape": [s, dd, ff],
                   "plan_block": [plan.block_s, plan.block_f],
                   "kind": hop.kind, "hopper_tile": [hop.bs, hop.bf, hop.bk]}
            if hop.kind != "simt":       # two launches are bit-identical
                row["bitwise_repeat"] = bool(torch.equal(got, ops.fused_ffn(
                    x, wg, wu, wd, block_s=plan.block_s, block_f=plan.block_f)))
                ok = ok and row["bitwise_repeat"]
            rows.append({**row, "max_abs_err": err, "tol": TOL[dn], "ok": ok})
    return rows


def flash_cases(cfg, moe_cfg, dev, encdec_cfg, vlm_cfg, kimi_cfg):
    """flash_attention and flash_attention_quantized (int8, fp8) against
    their plain versions: the prefill path's shape, the MoE prefill's
    (olmoe: as many K/V heads as query heads), whisper's decoder prefill
    (2 x 448 positions, 6 heads of 64), llava's (2 x 1600 positions,
    32 / 8 heads of 128) and kimi-k2's (2 x 1024, 64 / 8 heads of 112),
    a non-causal one,
    ragged S and Sk (also S != Sk, at hd 112 too), a short prompt and hd
    32, with the tiles that plans under several grants legalize to (bf16
    at hd 128, 112 and 64: the wgmma kernels, native and quantized,
    bitwise on a repeat); bf16 and fp32.  In fp32 the quantized kernel must equal the native kernel
    on the dequantized K/V bitwise."""
    import torch
    from repro_torch.core.plan import lower_attn
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    # (label, B, H, Hkv, S, hd, causal, Sk)
    shapes = (("path", B, H, Hkv, S, hd, True, S),
              ("moe path", B, moe_cfg.num_heads, moe_cfg.num_kv_heads, S,
               moe_cfg.hd, True, S),
              ("encdec path", B, encdec_cfg.num_heads,
               encdec_cfg.num_kv_heads, ENCDEC_E2E["prompt_len"],
               encdec_cfg.hd, True, ENCDEC_E2E["prompt_len"]),
              ("vlm path", B, vlm_cfg.num_heads, vlm_cfg.num_kv_heads,
               vlm_cfg.num_patches + S, vlm_cfg.hd, True,
               vlm_cfg.num_patches + S),
              ("kimi path", B, kimi_cfg.num_heads, kimi_cfg.num_kv_heads, S,
               kimi_cfg.hd, True, S),
              ("ragged hd112", 1, 8, 1, 333, kimi_cfg.hd, True, 333),
              ("ragged Sk hd112", 1, 8, 1, 200, kimi_cfg.hd, False, 520),
              ("non-causal", 1, H, Hkv, 512, hd, False, 512),
              ("ragged", 1, 8, 2, 333, 64, True, 333),
              ("ragged non-causal", 1, 8, 2, 333, 64, False, 333),
              ("ragged hd128", 1, 8, 2, 333, hd, True, 333),
              ("ragged hd128 non-causal", 1, 8, 2, 333, hd, False, 333),
              ("ragged Sk hd128", 1, 8, 2, 200, hd, False, 520),
              ("short hd128", 1, 8, 2, 40, hd, True, 40),
              ("hd32", 1, 4, 2, 256, 32, True, 256))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dtype_name(dtype)
        eb = torch.tensor([], dtype=dtype).element_size()
        for label, b, h, hkv, s, d, causal, sk in shapes:
            q = _randn(gen, (b, h, s, d), dtype)
            k = _randn(gen, (b, hkv, sk, d), dtype)
            v = _randn(gen, (b, hkv, sk, d), dtype)
            for kv in ("native", "int8", "fp8_e4m3"):
                plans = {lower_attn(d, eb, p, kv, eb if kv == "native" else 1)
                         for p in ATTN_GRANTS}
                tiles = {ops.legalize_attn_tile(p.block_q, p.block_kv, d, s,
                                                limit, dtype, kv != "native"): p
                         for p in plans}
                for tile, plan in tiles.items():
                    row = {"kernel": "flash_attention", "case": label,
                           "dtype": dn, "kv": kv, "causal": causal,
                           "shape": [b, h, hkv, s, d], "sk": sk,
                           "plan_block": [plan.block_q, plan.block_kv],
                           "kind": tile.kind, "hopper_tile": [tile.bq, tile.bkv]}
                    if kv == "native":
                        got = kfa.flash_attention(q, k, v, causal, tile)
                        want = kfa.flash_attention_plain(q, k, v, causal)
                        if tile.kind != "simt":
                            row["bitwise_repeat"] = bool(torch.equal(
                                got, kfa.flash_attention(q, k, v, causal, tile)))
                    else:
                        row["kernel"] = "flash_attention_quantized"
                        kq, ks = quant.quantize_rows(k, kv)
                        vq, vs = quant.quantize_rows(v, kv)
                        ks, vs = ks[..., 0], vs[..., 0]
                        got = kfa.flash_attention_quantized(q, kq, vq, ks, vs,
                                                            causal, tile)
                        want = kfa.flash_attention_quantized_plain(
                            q, kq, vq, ks, vs, causal)
                        if tile.kind != "simt":
                            row["bitwise_repeat"] = bool(torch.equal(
                                got, kfa.flash_attention_quantized(
                                    q, kq, vq, ks, vs, causal, tile)))
                        if dtype == torch.float32:
                            native = kfa.flash_attention(
                                q, quant.dequantize_rows(kq, ks[..., None]),
                                quant.dequantize_rows(vq, vs[..., None]),
                                causal, tile)
                            row["bitwise_vs_native_on_dequantized"] = bool(
                                torch.equal(got, native))
                    err, ok = _close(got, want, dn)
                    ok = ok and row.get("bitwise_vs_native_on_dequantized",
                                        True) and row.get("bitwise_repeat", True)
                    rows.append({**row, "max_abs_err": err, "tol": TOL[dn],
                                 "ok": ok})
    return rows


def quant_cases(cfg, dev):
    """cache_matmul_quant against its plain version: int8 and fp8 codes,
    bf16 and fp32 activations, every compiled tile of the dtype at the
    shapes its kind takes: the full-width decode shapes (M = 2, gate/up
    and down), 256 and 2048 rows, and ragged shapes (rows 1, 2, 7, 37,
    65, 300 with K and N off the tiles); the gemv and wgmma tiles bitwise
    on a repeat."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import quant
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    shapes = (("decode up", 2, d, f), ("decode down", 2, f, d),
              ("256 up", 256, d, f), ("2048 up", 2048, d, f),
              ("2048 down", 2048, f, d), ("ragged", 37, 333, 1000),
              *((f"ragged m{m}", m, k, n) for m, k, n in MQ_RAGGED))

    def takes(tile, m, k, n):
        if tile.kind == "gemv":
            return m <= tile.bm
        if tile.kind == "wgmma":
            return m > 8 and k % 8 == 0 and n % 16 == 0
        return m in (2, 256, 2048) or (m, k, n) == (37, 333, 1000)

    rows = []
    for label, m, k, n in shapes:
        w = _randn(gen, (k, n), torch.float32, 1 / math.sqrt(k))
        for kv in KV_CACHES:
            q, sc = quant.quantize_cols(w, kv)
            for dtype in (torch.bfloat16, torch.float32):
                dn = _dtype_name(dtype)
                a = _randn(gen, (m, k), dtype)
                want = kmm.cache_matmul_quant_plain(a, q, sc)
                for tile in kmm.QUANT_TILES:
                    if dtype not in tile.dtypes or not takes(tile, m, k, n):
                        continue
                    got = kmm.cache_matmul_quant(a, q, sc, tile)
                    err, ok = _close(got, want, dn)
                    row = {"kernel": "cache_matmul_quant", "case": label,
                           "dtype": dn, "kv": kv, "shape": [m, k, n],
                           "kind": tile.kind,
                           "hopper_tile": [tile.bm, tile.bn, tile.bk]}
                    if tile.kind != "simt":
                        row["bitwise_repeat"] = bool(torch.equal(
                            got, kmm.cache_matmul_quant(a, q, sc, tile)))
                        ok = ok and row["bitwise_repeat"]
                    rows.append({**row, "max_abs_err": err, "tol": TOL[dn],
                                 "ok": ok})
            del q, sc
    return rows


def _median_ms(fn, reps: int = 30) -> float:
    """Median device time of one call: CUDA events around each call, the
    queue kept ahead of the host by a sleep kernel so that host overhead
    is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def _turns_ms(fns, reps: int = 30):
    """:func:`_median_ms` of each callable in ``fns`` (name -> fn),
    measured in turns, a b .. b a, so that a drift of the card's clock
    within the call falls on each alike: the mean of each one's two
    medians, by name."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(_median_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in got.items()}


def _bound(nbytes: int, flops: int, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _matmul_timing(a, b, tile, limit, reps: int):
    """cache_matmul at one of the path's shapes (bf16) with the tile the
    plan legalizes to, against the simt tile the fp32 rule picks at the
    same plan (the one every bf16 call ran before the gemv and wgmma
    kinds), timed in turns in this call, beside the plain version and
    ``torch.matmul``; the kernel held against the plain version."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops
    m, k = a.shape
    n = b.shape[1]
    hop = ops.legalize_matmul_tile(tile, m, limit, a.dtype, k, n)
    simt = ops.legalize_matmul_tile(tile, m, limit, torch.float32, k, n)
    bound, by = _bound(2 * (m * k + k * n + m * n), 2 * m * k * n, "bfloat16")
    got = kmm.cache_matmul(a, b, hop)
    err, ok = _close(got, kmm.cache_matmul_plain(a, b), "bfloat16")
    repeat = bool(torch.equal(got, kmm.cache_matmul(a, b, hop)))
    t = _turns_ms({"ms": lambda: kmm.cache_matmul(a, b, hop),
                   "simt_ms": lambda: kmm.cache_matmul(a, b, simt)}, reps)
    out = {"shape": [m, k, n], "plan_tile": [tile.bm, tile.bn, tile.bk],
           "kind": hop.kind, "hopper_tile": [hop.bm, hop.bn, hop.bk],
           "simt_tile": [simt.bm, simt.bn, simt.bk], **t,
           "plain_ms": _median_ms(lambda: kmm.cache_matmul_plain(a, b), reps),
           "library_ms": _median_ms(lambda: torch.matmul(a, b), reps),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "bitwise_repeat": repeat, "ok": ok and repeat}
    if hop.kind == "gemv":
        out["gemv_split"] = list(kmm.gemv_split(n, k, torch.cuda.get_device_properties(
            a.device).multi_processor_count))
    if hop.kind == "wgmma":
        out["output_tiles"] = -(-m // hop.bm) * -(-n // hop.bn)
    out["speedup_vs_simt"] = out["simt_ms"] / out["ms"]
    out["vs_library"] = out["ms"] / out["library_ms"]
    return out


def kernel_timings(cfg, dev, batch: int, lwm_pages: int, lbm_pages: int):
    """Kernel, plain and library times at the serving path's decode
    shapes (bf16, M = batch rows), with the tiles the serve's plans
    lower to."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    dt = torch.bfloat16
    eb = 2
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lwm = lower_ffn(LANE, d, f, eb, lwm_pages, want_fused=False)
    x = _randn(gen, (batch, d), dt)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    h = _randn(gen, (batch, f), dt)
    out = {}
    for label, a, b, tile in (("up", x, wg, lwm.up_tile),
                              ("down", h, wd, lwm.down_tile)):
        out[f"cache_matmul.{label}"] = _matmul_timing(a, b, tile, limit, 30)
    # the fused FFN's decode rows under the e2e phase's LBM grant, and at
    # 8 rows (a batch of 8: the gemv kind's largest, 8 rows a thread)
    lbm = _plan(cfg, "LBM", lbm_pages, LANE)
    out["block_fused_ffn.decode"] = _ffn_timing(x, wg, wu, wd, lbm, limit,
                                                30)
    out["block_fused_ffn.decode.rows8"] = _ffn_timing(
        _randn(gen, (8, d), dt), wg, wu, wd, lbm, limit, 30)
    return out


def tp_timings(cfg, dev, tp: int = 2):
    """The plan kernels at a tensor-parallel shard's shapes (yi-9b's d_ff
    cut in ``tp``): cache_matmul's gemv at the decode rows (2 x d @ d x
    f/tp and 2 x f/tp @ f/tp x d) under serve's LWM plan tile, and
    block_fused_ffn at the prefill's 2048 rows under its LBM plan, each
    held against its plain version and timed beside it and the library
    call (``torch.matmul``; the FFN: the unfused bf16 chain)."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    fs = f // tp
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lwm = lower_ffn(LANE, d, f, 2, 32, want_fused=False)
    x = _randn(gen, (2, d), dt)
    h = _randn(gen, (2, fs), dt)
    wg = _randn(gen, (d, fs), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (fs, d), dt, 1 / math.sqrt(f))
    out = {"cache_matmul.tp.up": _matmul_timing(x, wg, lwm.up_tile, limit, 30),
           "cache_matmul.tp.down": _matmul_timing(h, wd, lwm.down_tile, limit,
                                                  30)}
    s = PREFILL["batch"] * PREFILL["prompt_len"]
    plan = prefill_plans(cfg)["LBM/native"]
    xs = _randn(gen, (s, d), dt)
    wu = _randn(gen, (d, fs), dt, 1 / math.sqrt(d))
    out["block_fused_ffn.tp.prefill"] = _ffn_timing(xs, wg, wu, wd, plan,
                                                    limit, 10)
    return out


def _plan(cfg, kind: str, pages: int, seq_block: int,
          kv_dtype: str = "native"):
    """The KernelPlan a ``kind`` grant of ``pages`` lowers to, as the
    server lowers a Selection (core/plan.py::lower_selection)."""
    import torch
    from repro_torch.core.allocator import Selection
    from repro_torch.core.mct import MappingCandidate
    from repro_torch.core.plan import lower_selection
    from repro_torch.launch.serve import _lower_width
    cand = MappingCandidate(kind=kind, p_need=pages, dram_bytes=0, flops=0,
                            loops=(), cache_map=(), usage_limit_bytes=0)
    eb = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    plan = lower_selection(Selection(cand, pages, 0.0), pages,
                           seq_block=seq_block, d_model=cfg.d_model,
                           d_ff=_lower_width(cfg), dtype_bytes=eb,
                           head_dim=cfg.hd, ssm_chunk=cfg.ssm_chunk,
                           kv_dtype=kv_dtype)
    if plan.kind != kind:
        raise AssertionError(f"{kind}@{pages}p lowers to {plan.describe()}")
    return plan


def prefill_plans(cfg):
    """The prefill phase's settings: plain, the smallest LBM grant that
    lowers fused at seq_block = prompt_len (native KV), and LWM grants
    with int8 and fp8 KV."""
    from repro_torch.core.vmem import fused_ffn_pages
    s, lwm = PREFILL["prompt_len"], PREFILL["lwm_pages"]
    lbm = fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2)
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM", lbm, s),
            "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8"),
            "LWM/fp8_e4m3": _plan(cfg, "LWM", lwm, s, "fp8_e4m3")}


def _ffn_timing(x, wg, wu, wd, plan, limit, reps: int):
    """block_fused_ffn at one of the path's shapes (bf16) with the tile
    ``plan``'s fused blocks legalize to, against the simt tile the fp32
    rule picks at the same plan, timed in turns in this call, beside the
    plain version and the unfused bf16 chain (a yardstick of several
    calls); the kernel held against the plain version.  A gemv tile's
    row names its cluster (blocks a 64-wide d_ff tile) and times every
    cluster size in turns (``cluster_ms``), each held against the plain
    version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import ops
    (s, d), f = x.shape, wg.shape[1]
    ffn = plan.ffn
    hop = ops.legalize_ffn_tile(ffn.block_s, ffn.block_f, s, limit, x.dtype,
                                d, f)
    # the simt tile the same plan gives fp32 (every bf16 call's before)
    simt = ops.legalize_ffn_tile(ffn.block_s, ffn.block_f, s, limit,
                                 torch.float32, d, f)
    bound, by = _bound(2 * (2 * s * d + 3 * d * f), 6 * s * d * f, "bfloat16")
    got = kffn.block_fused_ffn(x, wg, wu, wd, hop)
    err, ok = _close(got, kffn.block_fused_ffn_plain(x, wg, wu, wd),
                     "bfloat16")
    repeat = bool(torch.equal(got, kffn.block_fused_ffn(x, wg, wu, wd, hop)))
    del got
    t = _turns_ms({"ms": lambda: kffn.block_fused_ffn(x, wg, wu, wd, hop),
                   "simt_ms": lambda: kffn.block_fused_ffn(x, wg, wu, wd,
                                                           simt)}, reps)

    def chain():         # several PyTorch calls: a yardstick, not a library
        return torch.matmul(F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu),
                            wd)

    clusters = _gemv_cluster_ms(x, wg, wu, wd, hop) if hop.kind == "gemv" \
        else None

    return {
        "shape": [s, d, f], "plan": plan.describe(), "kind": hop.kind,
        "hopper_tile": [hop.bs, hop.bf, hop.bk],
        "simt_tile": [simt.bs, simt.bf, simt.bk], **t,
        "tflops": 6 * s * d * f / t["ms"] / 1e9,
        "plain_ms": _median_ms(
            lambda: kffn.block_fused_ffn_plain(x, wg, wu, wd), reps),
        "library_ms": None,
        "chain_ms": _median_ms(chain, reps),
        "chain": "yardstick, several calls: torch.matmul x3 with silu * mul, "
                 "bf16, the hidden tensors through device memory",
        "bound_ms": bound, "bound_by": by,
        "partial_bytes": kffn.partial_bytes(hop, s, d, f),
        "simt_partial_bytes": kffn.partial_bytes(simt, s, d, f),
        "gemv_cluster": (kffn.gemv_cluster(d, f, ops.sm_count(x.device))
                         if hop.kind == "gemv" else None),
        "cluster_ms": clusters,
        "max_abs_err": err, "bitwise_repeat": repeat, "ok": ok and repeat,
        "speedup_vs_simt": t["simt_ms"] / t["ms"]}


def _gemv_cluster_ms(x, wg, wu, wd, tile, reps: int = 30):
    """The gemv tile at ``x``'s shape with each cluster size of 1, 2, 4
    and 8 blocks (those that leave every block a vector of Wd's columns)
    in place of ``kffn.gemv_cluster``'s, timed in turns; raises if one
    misses the plain version."""
    from repro_torch.kernels import block_fused_ffn as kffn
    d = x.shape[1]
    rule, fns = kffn.gemv_cluster, {}
    for c in (c for c in (1, 2, 4, 8) if c <= d // 8):
        def run(c=c):
            kffn.gemv_cluster = lambda *_: c
            try:
                return kffn.block_fused_ffn(x, wg, wu, wd, tile)
            finally:
                kffn.gemv_cluster = rule
        err, ok = _close(run(), kffn.block_fused_ffn_plain(x, wg, wu, wd),
                         "bfloat16")
        if not ok:
            raise AssertionError(f"block_fused_ffn gemv, cluster {c}: {err}")
        fns[c] = run
    return _turns_ms(fns, reps)


def prefill_timings(cfg, dev):
    """block_fused_ffn (LBM plan), cache_matmul's up and down GEMMs (LWM
    plan) and both flash kernels (the quantized one under the int8 and
    the fp8 plan) at the prefill path's shapes (bf16, B x prompt_len
    rows), with the tiles the prefill phase's plans lower to, each held
    against its plain version on the same inputs."""
    import torch
    from repro_torch.kernels import ops
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    plans = prefill_plans(cfg)
    lbm, lwm = plans["LBM/native"], plans["LWM/int8"]
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    x = _randn(gen, (B * S, d), dt)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    out["block_fused_ffn.prefill"] = _ffn_timing(x, wg, wu, wd, lbm, limit,
                                                  10)
    h = _randn(gen, (B * S, f), dt)
    for label, a, b, tile in (("up", x, wg, lwm.ffn.up_tile),
                              ("down", h, wd, lwm.ffn.down_tile)):
        out[f"cache_matmul.prefill.{label}"] = {
            "plan": lwm.describe(), **_matmul_timing(a, b, tile, limit, 10)}
    del x, h, wg, wu, wd
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    out["flash_attention"] = _flash_timing(q, k, v, lbm.attn, limit)
    # the quantized kernel under the LWM/int8 and LWM/fp8 plans
    for name in ("LWM/int8", "LWM/fp8_e4m3"):
        plan = plans[name]
        key = "flash_attention_quantized" + (
            "" if plan.kv_dtype == "int8" else f".{plan.kv_dtype}")
        out[key] = _flash_timing(q, k, v, plan.attn, limit, plan.kv_dtype)
    return out


def _flash_timing(q, k, v, attn, limit, kv_dtype: str = "native",
                  reps: int = 30):
    """Causal flash attention at one of the path's shapes (bf16 q [B, H,
    S, hd], K/V [B, Hkv, S, hd]) with the tile the plan's attention
    blocks ``attn`` legalize to, timed in turns against the simt tile
    the same plan gives fp32 (every bf16 call's before the wgmma
    kernels; the same tile where the head dim has no wgmma tile), and at
    hd 64 against the other wgmma tile of the head dim (``alt_ms``: 64
    or 128 q rows, held against the plain version too), beside the plain
    version and, for native K/V, SDPA.  A quantized
    ``kv_dtype`` runs flash_attention_quantized on K/V quantized per
    row.  The kernel is held against its plain version on the timed
    inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    quantized = kv_dtype != "native"
    tile = ops.legalize_attn_tile(attn.block_q, attn.block_kv, hd, S, limit,
                                  q.dtype, quantized, B * H,
                                  ops.sm_count(q.device))
    simt = ops.legalize_attn_tile(attn.block_q, attn.block_kv, hd, S, limit,
                                  torch.float32, quantized)
    flops = 2 * B * H * S * S * hd           # causal: half of 4*B*H*S*Sk*hd
    qo_bytes = 2 * 2 * B * H * S * hd        # q read, O written
    kv_bytes = (2 * B * Hkv * S * (hd + 4) if quantized    # codes, scales
                else 2 * 2 * B * Hkv * S * hd)
    bound, by = _bound(qo_bytes + kv_bytes, flops, "bfloat16")
    library = None
    if quantized:
        kq, ks = quant.quantize_rows(k, kv_dtype)
        vq, vs = quant.quantize_rows(v, kv_dtype)
        ks, vs = ks[..., 0], vs[..., 0]

        def run(tl):
            return kfa.flash_attention_quantized(q, kq, vq, ks, vs, True, tl)

        def plain():
            return kfa.flash_attention_quantized_plain(q, kq, vq, ks, vs, True)
    else:
        def run(tl):
            return kfa.flash_attention(q, k, v, True, tl)

        def plain():
            return kfa.flash_attention_plain(q, k, v, True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    alt = [t for t in kfa.TILES if t.kind == "wgmma" and t.hd == hd
           and t.kv == tile.kv and t != tile] if tile.kind == "wgmma" else []
    want = plain()
    got = run(tile)
    err, ok = _close(got, want, "bfloat16")
    repeat = bool(torch.equal(got, run(tile)))
    if alt:
        alt_err, alt_ok = _close(run(alt[0]), want, "bfloat16")
        ok = ok and alt_ok
    del got, want
    turns = {"ms": lambda: run(tile), "simt_ms": lambda: run(simt)}
    if alt:
        turns["alt_ms"] = lambda: run(alt[0])
    t = _turns_ms(turns, reps)
    out = {"shape": [B, H, Hkv, S, hd], "kv": kv_dtype,
           "plan": [attn.block_q, attn.block_kv], "kind": tile.kind,
           "hopper_tile": [tile.bq, tile.bkv],
           "simt_tile": [simt.bq, simt.bkv],
           **t, "tflops": flops / t["ms"] / 1e9,
           "plain_ms": _median_ms(plain, reps),
           "library_ms": _median_ms(library, reps) if library else None,
           "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "bitwise_repeat": repeat, "ok": ok and repeat,
           "speedup_vs_simt": t["simt_ms"] / t["ms"]}
    if alt:
        out.update(alt_tile=[alt[0].bq, alt[0].bkv], alt_max_abs_err=alt_err)
    if library:
        out["vs_library"] = t["ms"] / out["library_ms"]
    return out


def _ssd_inputs(gen, b, h, s, p, n, dtype):
    """ssd_chunk operands as tests/test_kernels.py::test_ssd_chunk draws
    them (dt softplus of a normal, A = |normal| + 0.1), with B and C per
    batch row [b, s, n], the model's layout."""
    import torch
    x = _randn(gen, (b * h, s, p), dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (b * h, s), torch.float32))
    A = _randn(gen, (b * h,), torch.float32).abs() + 0.1
    return (x, dt, A, _randn(gen, (b, s, n), dtype),
            _randn(gen, (b, s, n), dtype))


def _ssd_plain(x, dt, A, Bm, Cm, chunk, kind=None):
    """The plain version on the reference's broadcast [BH, S, N] B/C
    (``kind``, the kernel's, is ignored)."""
    from repro_torch.kernels import ssd_scan as kssd
    h = x.shape[0] // Bm.shape[0]
    return kssd.ssd_chunk_plain(x, dt, A, Bm.repeat_interleave(h, 0),
                                Cm.repeat_interleave(h, 0), chunk)


def ssd_cases(ssm_cfg, dev):
    """ssd_chunk against its plain version: full-width mamba2 heads (B 2
    x 32 heads, P 64, N 128, B/C per batch row) at each chunk of
    :data:`SSD_CHUNKS` over three chunks, and the reduced shape (P 32,
    N 16); bf16 and fp32 inputs, both at the fp32 tolerance (the
    arithmetic and the outputs are fp32).  bf16 runs the kind
    ``ops.ssd_kind`` routes (wgmma) and the simt kind, fp32 the simt
    kind; every case bitwise on a repeat."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    red = ssm_cfg.reduced()
    b, h, p, n = 2, ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    shapes = [("full", b, h, p, n, q, 3 * q) for q in SSD_CHUNKS]
    shapes.append(("reduced", b, red.ssm_heads, red.ssm_head_dim,
                   red.ssm_state, red.ssm_chunk, 3 * red.ssm_chunk))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, p, n, q, s in shapes:
            ops_in = _ssd_inputs(gen, b, h, s, p, n, dtype)
            want_y, want_st = _ssd_plain(*ops_in, q)
            for kind in dict.fromkeys((ops.ssd_kind(dtype, n, p), "simt")):
                y, st = kssd.ssd_chunk(*ops_in, q, kind=kind)
                ey, oky = _close(y, want_y, "float32")
                es, oks = _close(st, want_st, "float32")
                y2, st2 = kssd.ssd_chunk(*ops_in, q, kind=kind)
                repeat = bool(torch.equal(y, y2) and torch.equal(st, st2))
                rows.append({"kernel": "ssd_chunk", "case": f"{label} Q{q}",
                             "dtype": _dtype_name(dtype), "kind": kind,
                             "shape": [b * h, s, p, n], "chunk": q,
                             "max_abs_err": max(ey, es),
                             "tol": TOL["float32"], "bitwise_repeat": repeat,
                             "ok": oky and oks and repeat})
    return rows


def ssd_work(b, h, s, p, n, q, eb):
    """(bytes, operations) of one ssd_chunk call: x at ``eb`` bytes, dt
    and A fp32, B and C once per batch row, y and the states fp32
    written; the operations of ``kssd.chunk_flops`` (the causal half of
    the [Q x Q] score and weight products, and the states)."""
    from repro_torch.kernels import ssd_scan as kssd
    bh, n_c = b * h, s // q
    nbytes = (bh * s * p * eb + bh * s * 4 + bh * 4 + 2 * b * s * n * eb
              + bh * s * p * 4 + bh * n_c * n * p * 4)
    return nbytes, kssd.chunk_flops(bh, s, p, n, q)


def _ssd_timing(gen, b, h, s, p, n, q):
    """ssd_chunk at one shape (bf16, B/C per batch row): the routed kind
    timed in turns against the simt kind (``simt_ms``), plain and bound,
    checked against the plain version and bitwise on a repeat."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    ops_in = _ssd_inputs(gen, b, h, s, p, n, torch.bfloat16)
    kind = ops.ssd_kind(torch.bfloat16, n, p)
    y, st = kssd.ssd_chunk(*ops_in, q, kind=kind)
    want_y, want_st = _ssd_plain(*ops_in, q)
    ey, oky = _close(y, want_y, "float32")
    es, oks = _close(st, want_st, "float32")
    y2, st2 = kssd.ssd_chunk(*ops_in, q, kind=kind)
    repeat = bool(torch.equal(y, y2) and torch.equal(st, st2))
    del y, st, y2, st2
    bound, by = _bound(*ssd_work(b, h, s, p, n, q, 2), "bfloat16")
    x, dt, A, Bm, Cm = ops_in
    Bw, Cw = Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0)
    t = _turns_ms({"ms": lambda: kssd.ssd_chunk(*ops_in, q, kind=kind),
                   "simt_ms": lambda: kssd.ssd_chunk(*ops_in, q,
                                                     kind="simt")})
    return {"shape": [b, h, s, p, n], "chunk": q, "kind": kind, **t,
            "plain_ms": _median_ms(
                lambda: kssd.ssd_chunk_plain(x, dt, A, Bw, Cw, q)),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(ey, es), "bitwise_repeat": repeat,
            "ok": oky and oks and repeat,
            "speedup_vs_simt": t["simt_ms"] / t["ms"]}


def ssd_timings(ssm_cfg, dev):
    """ssd_chunk at the SSM paths' shapes (bf16, full-width mamba2): the
    prefill phase's (B 2, S 1024) at each chunk its grants lower, and a
    serving prompt chunk (B 2, S 256), by :func:`_ssd_timing`."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, h = SSM_PREFILL["batch"], ssm_cfg.ssm_heads
    p, n = ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    return {f"ssd_chunk.{label}": _ssd_timing(gen, b, h, s, p, n, q)
            for label, s, q in (("prefill", SSM_PREFILL["prompt_len"], 256),
                                ("prefill.q128", SSM_PREFILL["prompt_len"],
                                 128),
                                ("prefill.q64", SSM_PREFILL["prompt_len"], 64),
                                ("serve_chunk", 256, 256))}


def _ssd_bwd_plain(x, dt, A, Bm, Cm, chunk, gy, gS, kind=None):
    """ssd_chunk_bwd's plain version on the reference's broadcast B/C,
    summed over the heads that share a row as the wrapper sums: the
    control that stands in for the backward kernel (of any kind)."""
    from repro_torch.kernels import ssd_scan as kssd
    h = x.shape[0] // Bm.shape[0]
    dx, ddt, dA, dB, dC = kssd.ssd_chunk_bwd_plain(
        x, dt, A, Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0),
        chunk, gy, gS)
    G, S, N = Bm.shape
    return (dx, ddt, dA, dB.reshape(G, h, S, N).sum(1),
            dC.reshape(G, h, S, N).sum(1))


def _close_scaled(got, want, tol, floor: float = 1e-6):
    """(max |got - want|, whether it is within ``tol`` of want's largest
    magnitude, or of ``floor`` where that is larger): a gradient's long
    sums (the reverse cumsum of dcum, dA's sum over the positions) cancel,
    so an element-wise bar would hold its small entries to the rounding
    of the large ones."""
    err = float((got.float() - want.float()).abs().max())
    return err, err <= tol * max(float(want.float().abs().max()), floor)


def _ssd_bwd_grads(gen, b, h, s, p, n, dtype, q):
    """:func:`_ssd_inputs` and the output gradients gy, gS (fp32)."""
    import torch
    ops_in = _ssd_inputs(gen, b, h, s, p, n, dtype)
    gy = _randn(gen, (b * h, s, p), torch.float32)
    gS = _randn(gen, (b * h, s // q, n, p), torch.float32)
    return ops_in, gy, gS


def ssd_bwd_cases(ssm_cfg, hybrid_cfg, dev):
    """ssd_chunk_bwd against its plain version (on the card, the same
    inputs) and against ``torch.autograd`` of ssd_chunk_plain: full-width
    mamba2 (B 2, 32 heads, S 1024, P 64, N 128, Q 256; a 44-token tail
    chunk and Q 1 at B 1), zamba2 (80 heads, N 64) and the reduced shape
    (N 16, P 32), in bf16 and fp32 (TF32 off).  bf16 runs the kind
    ``ops.ssd_kind`` routes (wgmma) and the simt kind, fp32 the simt kind.
    Against the plain backward at the fp32 tolerance (all fp32
    arithmetic), against autograd at the input dtype's (autograd returns
    dx, dB, dC in it), each relative to the gradient's largest magnitude
    (:func:`_close_scaled`; at Q 1 to the larger of that and 1: dA's terms
    cancel to exactly 0 in the plain version and to rounding in the
    kernel); bitwise on a repeat, one launch of the kind a call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    red = ssm_cfg.reduced()
    h, p, n = ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    shapes = [("mamba2", 2, h, 1024, p, n, 256),
              ("mamba2 tail", 1, h, 132, p, n, 44),
              ("mamba2", 1, h, 8, p, n, 1),
              ("zamba2", 2, hybrid_cfg.ssm_heads, 1024,
               hybrid_cfg.ssm_head_dim, hybrid_cfg.ssm_state, 256),
              ("reduced", 2, red.ssm_heads, 3 * red.ssm_chunk,
               red.ssm_head_dim, red.ssm_state, red.ssm_chunk)]
    names = ("dx", "ddt", "dA", "dB", "dC")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dtype_name(dtype)
        for label, b, h, s, p, n, q in shapes:
            ops_in, gy, gS = _ssd_bwd_grads(gen, b, h, s, p, n, dtype, q)
            plain = _ssd_bwd_plain(*ops_in, q, gy, gS)
            leaves = [t.detach().clone().requires_grad_() for t in ops_in]
            y, st = _ssd_plain(*leaves, q)
            auto = torch.autograd.grad((y * gy).sum() + (st * gS).sum(),
                                       leaves)
            del y, st, leaves
            floor = 1.0 if q == 1 else 1e-6
            for kind in dict.fromkeys((ops.ssd_kind(dtype, n, p), "simt")):
                before = kssd.launches_bwd_by_kind[kind]
                got = kssd.ssd_chunk_bwd(*ops_in, q, gy, gS, kind=kind)
                again = kssd.ssd_chunk_bwd(*ops_in, q, gy, gS, kind=kind)
                launched = kssd.launches_bwd_by_kind[kind] - before
                repeat = all(torch.equal(a, c) for a, c in zip(got, again))
                del again
                errs, ok = {}, repeat and launched == 2
                for name, g, w, a in zip(names, got, plain, auto):
                    ep, okp = _close_scaled(g, w, TOL["float32"], floor)
                    ea, oka = _close_scaled(g.to(a.dtype), a, TOL[dn], floor)
                    errs[name] = {"vs_plain": ep, "vs_autograd": ea}
                    ok = ok and okp and oka
                rows.append({"kernel": "ssd_chunk_bwd",
                             "case": f"{label} Q{q}", "dtype": dn,
                             "kind": kind, "shape": [b * h, s, p, n],
                             "chunk": q,
                             "max_abs_err": max(e["vs_plain"]
                                                for e in errs.values()),
                             "errors": errs,
                             "tol": {"vs_plain": TOL["float32"],
                                     "vs_autograd": TOL[dn],
                                     "floor": floor},
                             "bitwise_repeat": repeat, "ok": ok})
                del got
            del plain, auto
    return rows


def ssd_bwd_work(b, h, s, p, n, q, eb):
    """(bytes, operations) of one ssd_chunk_bwd call: x at ``eb`` bytes,
    B and C once per batch row, dt, A, gy and gS fp32 read; dx, ddt, dA
    and dB, dC per batch row fp32 written; the operations of
    ``kssd.chunk_bwd_flops`` (the causal half of the five [Q x Q]
    products and the states' two products)."""
    from repro_torch.kernels import ssd_scan as kssd
    bh, n_c = b * h, s // q
    nbytes = (bh * s * p * eb + 2 * b * s * n * eb + bh * s * 4 + bh * 4
              + bh * s * p * 4 + bh * n_c * n * p * 4
              + bh * s * p * 4 + bh * s * 4 + bh * 4 + 2 * b * s * n * 4)
    return nbytes, kssd.chunk_bwd_flops(bh, s, p, n, q)


def ssd_bwd_timings(ssm_cfg, dev):
    """ssd_chunk_bwd at the SSM paths' shapes (bf16, full-width mamba2):
    the prefill's (B 2, S 1024) and the train step's (B 8, S 1024), Q 256;
    the kind ``ops.ssd_kind`` routes (wgmma) checked against the plain
    version on the timed inputs, bitwise on a repeat, timed in turns
    against the simt kind (``simt_ms``), plain timed by
    :func:`_median_ms`, the bound from :func:`ssd_bwd_work`.  Then the
    forward ssd_chunk at the train step's shape (:func:`_ssd_timing`)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    h, p, n = ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    kind = ops.ssd_kind(torch.bfloat16, n, p)
    out = {}
    for label, b in (("prefill", SSM_PREFILL["batch"]),
                     ("train", TRAIN_SSM["global_batch"])):
        s, q = 1024, 256
        ops_in, gy, gS = _ssd_bwd_grads(gen, b, h, s, p, n, torch.bfloat16, q)
        got = kssd.ssd_chunk_bwd(*ops_in, q, gy, gS, kind=kind)
        again = kssd.ssd_chunk_bwd(*ops_in, q, gy, gS, kind=kind)
        repeat = all(torch.equal(a, c) for a, c in zip(got, again))
        plain = _ssd_bwd_plain(*ops_in, q, gy, gS)
        checks = [_close_scaled(g, w, TOL["float32"])
                  for g, w in zip(got, plain)]
        del got, again, plain
        bound, by = _bound(*ssd_bwd_work(b, h, s, p, n, q, 2), "bfloat16")
        t = _turns_ms({
            "ms": lambda: kssd.ssd_chunk_bwd(*ops_in, q, gy, gS, kind=kind),
            "simt_ms": lambda: kssd.ssd_chunk_bwd(*ops_in, q, gy, gS,
                                                  kind="simt")})
        out[f"ssd_chunk_bwd.{label}"] = {
            "shape": [b, h, s, p, n], "chunk": q, "kind": kind, **t,
            "plain_ms": _median_ms(lambda: _ssd_bwd_plain(*ops_in, q, gy,
                                                          gS)),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(e for e, _ in checks),
            "bitwise_repeat": repeat,
            "ok": repeat and all(ok for _, ok in checks),
            "speedup_vs_simt": t["simt_ms"] / t["ms"]}
        del ops_in, gy, gS
    out["ssd_chunk.train"] = _ssd_timing(gen, TRAIN_SSM["global_batch"], h,
                                         1024, p, n, 256)
    return out


def hybrid_timings(hybrid_cfg, dev):
    """The kernels at full-width zamba2-2.7b's shapes (bf16): cache_matmul's
    gemv at decode (2 x 2560 @ 2560 x 10240 and 2 x 10240 @ 10240 x 2560,
    the e2e phase's LWM@32p plan) and its wgmma tile at the prefill's
    2048 rows (the 32-page LWM prefill plan), block_fused_ffn at 2048 x
    2560, d_ff 10240 (the prefill's LBM plan, beside the unfused chain),
    and ssd_chunk at the prefill's B 2, S 1024, 80 heads, P 64, N 64,
    chunk 256."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import ops
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cfg = hybrid_cfg
    d, f = cfg.d_model, cfg.d_ff
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    decode = _plan(cfg, "LWM", HYBRID_E2E["lwm_pages"], LANE)
    plans = hybrid_prefill_plans(cfg)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    out = {}
    x, h = _randn(gen, (B, d), dt), _randn(gen, (B, f), dt)
    for label, a, b, tile in (("up", x, wg, decode.ffn.up_tile),
                              ("down", h, wd, decode.ffn.down_tile)):
        out[f"cache_matmul.hybrid.{label}"] = {
            "plan": decode.describe(), **_matmul_timing(a, b, tile, limit,
                                                        30)}
    x = _randn(gen, (B * S, d), dt)
    lwm = plans["LWM/native"]
    out["cache_matmul.hybrid.prefill.up"] = {
        "plan": lwm.describe(),
        **_matmul_timing(x, wg, lwm.ffn.up_tile, limit, 10)}
    out["block_fused_ffn.hybrid"] = _ffn_timing(x, wg, wu, wd,
                                                plans["LBM/native"], limit, 10)
    del x, wg, wu, wd
    out["ssd_chunk.hybrid"] = _ssd_timing(
        gen, B, cfg.ssm_heads, S, cfg.ssm_head_dim, cfg.ssm_state,
        cfg.ssm_chunk)
    return out


def encdec_vlm_timings(encdec_cfg, vlm_cfg, dev):
    """The kernels at the encoder-decoder and VLM shapes (bf16).
    whisper-tiny: its decode FFN (2 x 384, d_ff 1536) under serve_encdec's
    grants, cache_matmul's gemv (LWM@3p) and block_fused_ffn's gemv tile
    (LBM@34p); its fused FFN at e2e_encdec's 896 prefill rows (the
    wgmma tile) and causal flash attention at hd 64 over 2 x 448 decoder
    positions, 6 heads (the 64-row wgmma tile of hd 64, in turns with
    the 128-row one; a batch of 8 takes 128 rows), against SDPA.
    llava-next: its decode gemv (2 x 4096 @ 4096 x 14336 and 2 x
    14336 @ 14336 x 4096, LWM@32p), and at prefill_vlm's 2 x (576 + 1024)
    = 3200 rows the LWM@32p GEMM, the fused FFN at d_ff 14336 (the
    smallest fused grant) and causal GQA flash attention at S 1600, 32 /
    8 heads of 128 (wgmma), native and int8."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import ops
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    cfg, e = encdec_cfg, ENCDEC_E2E
    d, f = cfg.d_model, cfg.d_ff
    B, S = e["batch"], e["prompt_len"]
    lwm = _plan(cfg, "LWM", e["decode_lwm_pages"], LANE)
    lbm = _plan(cfg, "LBM", e["decode_lbm_pages"], LANE)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    x = _randn(gen, (B, d), dt)
    out["cache_matmul.encdec.up"] = {
        "plan": lwm.describe(),
        **_matmul_timing(x, wg, lwm.ffn.up_tile, limit, 30)}
    out["block_fused_ffn.encdec.decode"] = _ffn_timing(x, wg, wu, wd, lbm,
                                                       limit, 30)
    pf = encdec_prefill_plans(cfg)["LBM/native"]
    x = _randn(gen, (B * S, d), dt)
    out["block_fused_ffn.encdec.prefill"] = _ffn_timing(x, wg, wu, wd, pf,
                                                        limit, 30)
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    out["flash_attention.encdec"] = _flash_timing(q, k, v, pf.attn, limit)
    # a batch of 8 prompts: the grid that fills the card with 128-row
    # q tiles (the legalization's other side)
    q8, k8, v8 = (_randn(gen, (8, H, S, hd), dt) for _ in range(3))
    out["flash_attention.encdec.b8"] = _flash_timing(q8, k8, v8, pf.attn,
                                                     limit)
    del q8, k8, v8
    cfg = vlm_cfg
    d, f = cfg.d_model, cfg.d_ff
    B, S = PREFILL["batch"], cfg.num_patches + PREFILL["prompt_len"]
    plans = vlm_prefill_plans(cfg)
    decode = _plan(cfg, "LWM", VLM_E2E["lwm_pages"], LANE)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    x, h = _randn(gen, (B, d), dt), _randn(gen, (B, f), dt)
    for label, a, b, tile in (("up", x, wg, decode.ffn.up_tile),
                              ("down", h, wd, decode.ffn.down_tile)):
        out[f"cache_matmul.vlm.{label}"] = {
            "plan": decode.describe(), **_matmul_timing(a, b, tile, limit,
                                                        30)}
    x = _randn(gen, (B * S, d), dt)
    lwm = plans["LWM/native"]
    out["cache_matmul.vlm.prefill.up"] = {
        "plan": lwm.describe(),
        **_matmul_timing(x, wg, lwm.ffn.up_tile, limit, 10)}
    out["block_fused_ffn.vlm"] = _ffn_timing(x, wg, wu, wd,
                                             plans["LBM/native"], limit, 10)
    del x, h, wg, wu, wd
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    out["flash_attention.vlm"] = _flash_timing(q, k, v,
                                               plans["LBM/native"].attn, limit)
    int8 = plans["LWM/int8"]
    out["flash_attention_quantized.vlm"] = _flash_timing(
        q, k, v, int8.attn, limit, int8.kv_dtype)
    return out


def arch_timings(kimi_cfg, encdec_cfg, dev):
    """Flash attention at the head dims its newest tiles serve (bf16):
    kimi-k2's causal GQA prefill (2 x 1024 positions, 64 / 8 heads of
    112) under prefill_kimi's LBM plan (native) and its LWM@32p plans
    with int8 and fp8 K/V, against SDPA for native K/V; whisper-tiny's
    decoder prefill (2 x 448, 6 heads of 64) under e2e_encdec's LWM@32p
    int8 plan (the quantized wgmma tile of hd 64)."""
    import torch
    from repro_torch.kernels import ops
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    out = {}
    cfg, (B, S) = kimi_cfg, (PREFILL["batch"], PREFILL["prompt_len"])
    plans = moe_prefill_plans(cfg)
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    out["flash_attention.kimi"] = _flash_timing(q, k, v,
                                                plans["LBM/native"].attn, limit)
    for kv in ("int8", "fp8_e4m3"):
        plan = _plan(cfg, "LWM", PREFILL["lwm_pages"], S, kv)
        out["flash_attention_quantized.kimi" + ("" if kv == "int8" else
                                                f".{kv}")] = _flash_timing(
            q, k, v, plan.attn, limit, kv)
    del q, k, v
    cfg, S = encdec_cfg, ENCDEC_E2E["prompt_len"]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    int8 = encdec_prefill_plans(cfg)["LWM/int8"]
    out["flash_attention_quantized.encdec"] = _flash_timing(
        q, k, v, int8.attn, limit, int8.kv_dtype)
    return out


def moe_timings(moe_cfg, dev):
    """cache_matmul and block_fused_ffn at olmoe-1b-7b's expert shapes:
    one expert's bucket of ``make_prefill`` at 2 x 1024 tokens (G*C = 328
    rows) and of ``make_prefill(cfg, serve=True)`` (2048 drop-free rows),
    gate/up [rows, 2048] @ [2048, 1024] and down [rows, 1024] @ [1024,
    2048] under the 32-page LWM plan (which both calls run), and the fused
    FFN at 328 rows under the smallest fused LBM plan, both lowered at
    d_ff 1024; the unfused bf16 chain as the fused FFN's yardstick."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.moe import capacity
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    plans = moe_prefill_plans(moe_cfg)
    lwm = plans["LWM/native"].ffn
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    d, f = moe_cfg.d_model, moe_cfg.d_ff
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    out = {}
    for call, rows in (("moe", B * capacity(S, moe_cfg)),
                       ("moe.serve", B * S)):
        x = _randn(gen, (rows, d), dt)
        h = _randn(gen, (rows, f), dt)
        for label, a, b, tile in (("up", x, wg, lwm.up_tile),
                                  ("down", h, wd, lwm.down_tile)):
            out[f"cache_matmul.{call}.{label}"] = {
                "plan": plans["LWM/native"].describe(),
                **_matmul_timing(a, b, tile, limit, 30)}
        if call == "moe":
            out["block_fused_ffn.moe"] = _ffn_timing(
                x, wg, wu, wd, plans["LBM/native"], limit, 30)
    return out


def check_kernels(cfg, ssm_cfg, moe_cfg, hybrid_cfg, encdec_cfg, vlm_cfg,
                  kimi_cfg, dev):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = (kernel_cases(cfg, dev)
            + flash_cases(cfg, moe_cfg, dev, encdec_cfg, vlm_cfg, kimi_cfg)
            + quant_cases(cfg, dev) + ssd_cases(ssm_cfg, dev)
            + ssd_bwd_cases(ssm_cfg, hybrid_cfg, dev))
    bad = [r for r in rows if not r["ok"]]
    timings = kernel_timings(cfg, dev, batch=2, lwm_pages=32, lbm_pages=324)
    timings.update(prefill_timings(cfg, dev))
    timings.update(ssd_timings(ssm_cfg, dev))
    timings.update(ssd_bwd_timings(ssm_cfg, dev))
    timings.update(moe_timings(moe_cfg, dev))
    timings.update(hybrid_timings(hybrid_cfg, dev))
    timings.update(encdec_vlm_timings(encdec_cfg, vlm_cfg, dev))
    timings.update(arch_timings(kimi_cfg, encdec_cfg, dev))
    timings.update(tp_timings(cfg, dev))
    bad += [k for k, v in timings.items() if not v["ok"]]
    worst = {}
    for r in rows:
        key = f"{r['kernel']}.{r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "kernel_cases.json").write_text(json.dumps(rows, indent=1))
    return {"allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32},
            "cases": len(rows), "failed": bad, "worst_abs_err": worst,
            "tolerance": TOL, "timings": timings}


# ---------------------------------------------------------------- e2e --
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _to_dtype(tree, dtype):
    """A copy of a params tree with every floating leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class _Forced:
    """Teacher forcing for decode_epoch: records each step's logits and
    feeds the next preset token instead of the greedy one."""

    def __init__(self, tokens):
        self.tokens, self.i, self.logits = tokens, 0, []

    def __call__(self, logits):
        self.logits.append(logits[:, -1].float())
        self.i += 1
        return self.tokens[:, self.i]


def _e2e_run(cfg, params, dev, prompt, forced, plans, kv_dtype="native",
             enc=None):
    """A prefill of ``prompt`` and a teacher-forced decode epoch of 4 steps
    under each of ``plans`` (an encoder-decoder's cross-attention over
    ``enc``): the prefill's and every step's last-position logits, fp32,
    copied to the host."""
    import torch
    from repro_torch.models.transformer import (decode_epoch, init_caches,
                                                prefill_chunk)
    caches = init_caches(params, cfg, prompt.shape[0], 64, kv_dtype=kv_dtype,
                         device=dev)
    toks = torch.from_numpy(prompt).long().to(dev)
    forced_t = torch.from_numpy(forced).long().to(dev)
    logits, caches = prefill_chunk(params, toks, caches, 0, cfg, enc)
    out = [logits[:, -1].float()]
    feed = _Forced(forced_t)
    index, k = prompt.shape[1], 4
    for plan in plans:
        _, caches = decode_epoch(params, forced_t[:, feed.i:feed.i + 1], caches,
                                 index, cfg, k, next_token_fn=feed,
                                 enc_out=enc, plan=plan)
        index += k
    out += feed.logits
    return torch.stack(out, 1).cpu()


def _gate(got, want, label: str):
    """Card against reference logits [..., V]: max |difference| <= 2e-2
    of the largest reference logit; a greedy token may differ only where
    the reference's own margin is within twice that."""
    import torch
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = 2e-2 * scale
    g_arg, w_arg = got.argmax(-1), want.argmax(-1)
    margin = want.max(-1).values - want.gather(-1, g_arg[..., None])[..., 0]
    agree = float((g_arg == w_arg).float().mean())
    bad_tokens = int(((g_arg != w_arg) & (margin > 2 * tol)).sum())
    if not (bool(torch.isfinite(got).all()) and err <= tol and bad_tokens == 0):
        raise AssertionError(f"{label}: err {err} tol {tol} agree {agree} "
                             f"bad_tokens {bad_tokens}")
    return {"max_abs_err": err, "max_abs_logit": scale, "tol": tol,
            "greedy_agreement": agree}


# the kernels that the plan-lowered prefill (and the e2e phase) launch
PREFILL_KERNELS = ("cache_matmul", "block_fused_ffn", "flash_attention",
                   "flash_attention_quantized")


def _counters():
    """The six kernels' launch counters, by kernel name, and each split
    by tile kind (``cache_matmul.gemv``, ``ssd_chunk.wgmma`` etc.); a
    replayed graph adds the launches its capture recorded."""
    from repro_torch.kernels import counters as kcount
    return kcount.snapshot()


def _gate_kinds(counters, label: str, matmul=(), flash=(), ffn=(), quant=(),
                flash_quantized=(), ssd=()):
    """Every bf16 launch of the path ran the kinds named: no cache_matmul
    launch of the ``simt`` kind, each kind of ``matmul`` launched; where
    ``flash`` names kinds, each of them launched and none of the simt
    kind unless ``simt`` is named; likewise ``ffn`` for block_fused_ffn,
    ``quant`` for cache_matmul_quant, ``flash_quantized`` for
    flash_attention_quantized and ``ssd`` for ssd_chunk."""
    bad = [k for k in matmul if counters[f"cache_matmul.{k}"] <= 0]
    if counters["cache_matmul.simt"]:
        bad.append("cache_matmul.simt")
    for name, kinds in (("flash_attention", flash), ("block_fused_ffn", ffn),
                        ("cache_matmul_quant", quant),
                        ("flash_attention_quantized", flash_quantized),
                        ("ssd_chunk", ssd)):
        bad += [f"{name}.{k}" for k in kinds if counters[f"{name}.{k}"] <= 0]
        if kinds and "simt" not in kinds and counters[f"{name}.simt"]:
            bad.append(f"{name}.simt")
    if bad:
        raise AssertionError(f"{label}: kinds {bad} wrong: {counters}")


def _zero_counters():
    from repro_torch.kernels import counters as kcount
    kcount.zero()


def check_e2e(cfg, dev, layers: int = 4, lbm_pages: int = 324,
              lwm_pages: int = 32):
    """The card with kernels against the CPU with the plain versions,
    same weights and tokens: prefill and two teacher-forced decode epochs
    (LBM, LWM) with a native cache, and again with an int8 and an fp8
    cache; then make_prefill of a ragged prompt under an LBM plan with
    native KV and an LWM plan with int8 KV.  Tolerance (bf16 activations
    rounded at different points over 4 layers): see :func:`_gate`; with
    a quantized cache the greedy tokens must also be equal, and its
    logits on the card reach :data:`PREFILL_COSINE` against the native
    cache's."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, num_layers=layers)
    plans = [_plan(cfg, "LBM", lbm_pages, LANE),
             _plan(cfg, "LWM", lwm_pages, LANE)]
    pf_plans = [plans[0], _plan(cfg, "LWM", lwm_pages, LANE, "int8")]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8))
    forced = rng.integers(0, cfg.vocab_size, (2, 9))
    prompt_len = 40              # ragged against every flash tile
    long_prompt = rng.integers(0, cfg.vocab_size, (2, prompt_len))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        toks = torch.from_numpy(long_prompt).long().to(device)
        pf = [prefill(params, {"tokens": toks}, p).float().cpu()
              for p in pf_plans]
        kv = {name: _e2e_run(cfg, params, device, prompt, forced, plans, name)
              for name in KV_CACHES}
        return _e2e_run(cfg, params, device, prompt, forced, plans), pf, kv

    params = M.init_params(cfg, seed=1, device=dev)
    l0 = _counters()
    got, got_pf, got_kv = run(params, dev)
    launches = {k: v - l0[k] for k, v in _counters().items()}
    want, want_pf, want_kv = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    res = {"layers": layers, "positions": int(got.shape[1]),
           "decode": _gate(got[..., :V], want[..., :V], "e2e decode"),
           "decode_quantized_kv": _quantized_gates(got, got_kv, want_kv, V,
                                                   "e2e"),
           "prefill": {p.describe(): _gate(g[..., :V], w[..., :V],
                                           f"e2e prefill {p.describe()}")
                       for p, g, w in zip(pf_plans, got_pf, want_pf)},
           "prompt_len": prompt_len, "launches": launches,
           "plans": [p.describe() for p in plans]}
    if min(launches[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"e2e: a kernel never launched: {launches}")
    # the LBM decode epochs run block_fused_ffn's gemv tile (2 rows),
    # make_prefill's 80 rows its wgmma tile
    _gate_kinds(launches, "e2e", ("gemv", "wgmma"), ("wgmma",),
                ffn=("gemv", "wgmma"))
    if launches["block_fused_ffn.wgmma"] <= 0:
        raise AssertionError(f"e2e: no wgmma block_fused_ffn launch: "
                             f"{launches}")
    return res


def _quantized_gates(got, got_kv, want_kv, V: int, label: str):
    """The decode logits with each quantized cache of :data:`KV_CACHES`:
    within :func:`_gate` of the CPU's, the greedy tokens equal, and at
    the cosine bar of :data:`PREFILL_COSINE` against the native cache's
    logits on the card."""
    import torch
    out = {}
    for name in KV_CACHES:
        g, w = got_kv[name][..., :V], want_kv[name][..., :V]
        gate = _gate(g, w, f"{label} decode {name} cache")
        cos = float(torch.nn.functional.cosine_similarity(
            g, got[..., :V], dim=-1).min())
        if gate["greedy_agreement"] != 1.0 or cos < PREFILL_COSINE[name]:
            raise AssertionError(f"{label} {name} cache: greedy "
                                 f"{gate['greedy_agreement']}, cosine {cos}")
        out[name] = {**gate, "min_cosine_vs_native": cos,
                     "min_cosine_bar": PREFILL_COSINE[name]}
    return out


# -------------------------------------------------------------- serve --
def _profile(run, annotations=(), shares=()):
    """Device time by kernel of one call of ``run`` (warm, synchronised),
    under ``torch.profiler``, and the device's idle share against the
    same call timed on the host clock without the profiler.  Each name in
    ``annotations`` (a ``record_function`` range inside ``run``) gets the
    device time of the kernels launched inside it (``kernel_ms``, from
    the range's host-side row) and the device span of the range
    (``span_ms``, which also holds the idle gaps while the host launches
    its kernels); both are kept out of the kernel rows.  Each name in
    ``shares`` gets the share of device time of every kernel whose name
    holds it (``shares``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()                                   # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        for a in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, a, None)
            if v is not None:
                return float(v)
        return 0.0

    events = prof.key_averages()
    annotated = {n: {} for n in annotations}
    for e in events:
        if e.key in annotations:
            on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
            total = max(float(getattr(e, a, 0) or 0) for a in (
                "device_time_total", "cuda_time_total"))
            annotated[e.key]["span_ms" if on_device else "kernel_ms"] = \
                total / 1e3
    rows = [(e.key, dev_us(e), e.count,
             str(getattr(e, "device_type", "")).endswith("CUDA"))
            for e in events if e.key not in annotations]
    rows = [r for r in rows if r[1] > 0]
    # kernels only, where the profiler tags them: an op and its kernel
    # would otherwise count twice
    kernels_only = any(r[3] for r in rows)
    if kernels_only:
        rows = [r for r in rows if r[3]]
    total_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    top = [{"name": n[:80], "device_ms": us / 1e3, "calls": c,
            "share": us / total_us} for n, us, c, _ in rows[:12]]
    out = {"wall_ms": wall_ms, "kernels_only": kernels_only,
           "kernel_launches": sum(r[2] for r in rows) if kernels_only
           else "not measured",
           "device_ms": total_us / 1e3 if total_us else "not measured",
           "idle_share": (1 - total_us / 1e3 / wall_ms) if total_us else
           "not measured", "top": top}
    if shares:
        out["shares"] = {n: (sum(r[1] for r in rows if n in r[0]) / total_us
                             if total_us else "not measured")
                         for n in shares}
    if annotations:
        out["annotated"] = {
            n: {**a, "kernel_share": a["kernel_ms"] * 1e3 / total_us}
            if a.get("kernel_ms") and total_us else (a or "not measured")
            for n, a in annotated.items()}
    return out


def _profile_replay(srv, t, k: int = 4, shares=()):
    """:func:`_profile` of one decode epoch of tenant ``t`` as the server
    dispatches it warm: one replay of its program for the item at its
    position (a program not cached yet is captured in ``_profile``'s
    warm-up call).  Each call puts the device position and the feedback
    token back (two small copies), so every call replays the same
    epoch.  ``shares`` as :func:`_profile`'s."""
    import torch
    plan = srv._dec_plan(t, t.plans[-1])
    item = ("single", t, plan, k)
    token = t.token.clone()
    host_ms = []

    def run():
        t0 = time.perf_counter()
        srv._fused_epoch_fn(item)()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t.index_dev.sub_(k)
        t.token.copy_(token)
        torch.cuda.synchronize()

    out = _profile(run, shares=shares)
    # the host's part of a replayed epoch: the lookup and the replay call
    # (the graph's launch), last of the three calls
    return {"plan": plan.describe() if plan is not None else None,
            "steps": k, "position": t.index, "replay_host_ms": host_ms[-1],
            **out}


def _warm_runs(srv, steps: int):
    """:data:`WARM_RUNS` more ``run()`` calls of a served server (only its
    residents are left): each must build nothing (``epoch_compiles`` all
    0, no capture, no LRU miss or eviction).  Returns each run's
    tokens/s, wall and host record, and the median tokens/s with its
    spread ((max - min) / median)."""
    runs = []
    for _ in range(WARM_RUNS):
        lru = (srv._fused_jits.misses, srv._prefill_jits.misses,
               srv._fused_jits.evictions, srv._prefill_jits.evictions)
        captures = srv._captures
        out = srv.run(steps=steps)
        h = out["host"]
        if (h["epoch_compiles"] != [0] * h["epochs"]
                or srv._captures != captures
                or lru != (srv._fused_jits.misses, srv._prefill_jits.misses,
                           srv._fused_jits.evictions,
                           srv._prefill_jits.evictions)):
            raise AssertionError(f"warm run built programs: {h}")
        runs.append({"tokens_per_s": out["tokens_per_s"],
                     "wall_s": out["wall_s"],
                     "tokens_served": out["tokens_served"], "host": h})
    rates = sorted(r["tokens_per_s"] for r in runs)
    med = rates[len(rates) // 2]
    return {"steps": steps, "runs": runs, "median_tokens_per_s": med,
            "spread": (rates[-1] - rates[0]) / med if med else None}


def _graph_pool_bytes(srv):
    """Bytes the server's graph memory pool holds on the card (its
    segments in the allocator's snapshot), or "not measured"."""
    import torch
    if srv._graph_pool is None:
        return 0
    try:
        segs = torch.cuda.memory._snapshot()["segments"]
    except (AttributeError, KeyError, RuntimeError):
        return "not measured"
    pool = tuple(srv._graph_pool)
    return sum(s["total_size"] for s in segs
               if tuple(s.get("segment_pool_id", ())) == pool)


def _programs(srv, out):
    """The server's program record: captures, capture seconds per graph,
    the graph pool's bytes and the LRU counters."""
    h = out["host"]
    return {"captures": h["captures"], "capture_s": h["capture_s"],
            "warmups": h["warmups"], "warmup_s": h["warmup_s"],
            "capture_s_per_graph": (h["capture_s"] / h["captures"]
                                    if h["captures"] else None),
            "graph_pool_bytes": _graph_pool_bytes(srv),
            "jit_cache": h["jit_cache"], "epoch_compiles": h["epoch_compiles"],
            "departure_evictions": h["departure_evictions"]}


def grantable_kinds(cfg, batch: int, pages: int):
    """Plan kinds the scheduler can grant a tenant of ``cfg`` in a pool of
    ``pages``: LWM always, LBM where the server's mapping of its decode
    FFN graph carries an LBM candidate that fits the pool.  The mapping
    is the port's copied core, so these are the reference's kinds (at
    full width its 2 ms LBM block cap leaves LWM only)."""
    from repro_torch.launch import serve as S
    tm = S._tenant_model(S._ffn_graph(cfg.name, cfg, seq_block=batch),
                         S._vmem_mapper(pages))
    lbm = any(m.lbm is not None and m.lbm.p_need <= pages
              for m in tm.mapping.mcts)
    return {"LBM", "LWM"} if lbm else {"LWM"}


def serve_main_path(cfg, dev, counters, label: str = "serve",
                    batch: int = 2, max_len: int = 512,
                    pages: int = SERVE_PAGES, steps: int = SERVE_STEPS,
                    arrival=ARRIVAL, kernels: bool = True, shares=(),
                    ffn=(), one_weight_set: bool = False):
    """Two full-width, full-depth tenants of ``cfg`` through the port's
    MultiTenantServer: a resident and an ``arrival`` (a prompt and a
    budget), whose native KV reservation the pool holds whole.
    ``counters`` receives the kernels' launch counts of this run: zeroed
    just before ``run``, read just after.  With ``kernels`` the FFN
    kernels of the plans granted must have launched, cache_matmul of the
    gemv kind (yi-9b); without, nothing may launch (olmoe-1b-7b: the
    server's MoE path gathers its experts in decode and runs the plain
    buckets in prompt chunks, as the reference's).  The plan kinds must
    be those the scheduler can grant; ``ffn`` names the block_fused_ffn
    kinds the path must launch (:func:`_gate_kinds`).  Then three warm
    runs, a decode item of the resident replayed against its eager run,
    which must be bitwise equal (:func:`_replay_vs_eager`), and one
    replayed decode epoch of the resident profiled with the named
    kernels' ``shares``.  With ``one_weight_set`` the arrival takes the
    resident's weights (one set on the card)."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    quote = _kv_reserve_pages(cfg, batch, arrival["prompt_len"])
    spec = TenantSpec(cfg.name, **arrival,
                      **({"param_seed": 0} if one_weight_set else {}))
    srv = MultiTenantServer([cfg.name], tenants=[spec], batch=batch,
                            max_len=max_len, total_pages=pages, epoch_len=4,
                            device=dev, reduced=False,
                            params_fn=(_params_memo(dev) if one_weight_set
                                       else None))
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    want_kinds = grantable_kinds(cfg, batch, pages)
    if kernels:
        need = {"cache_matmul"} | ({"block_fused_ffn"} if "LBM" in want_kinds
                                   else set())
        if min(counters[k] for k in need) <= 0:
            raise AssertionError(f"{label}: a kernel never launched: "
                                 f"{counters}")
        _gate_kinds(counters, label, ("gemv",), ffn=ffn)
    elif any(counters.values()):
        raise AssertionError(f"{label}: a kernel launched: {counters}")
    tenants = {}
    for t in srv.tenants:
        res = out["tenants"][t.tid]
        o = res["output"]
        want = steps if t.prompt_len == 0 else 1 + arrival["n_inferences"]
        problems = []
        if o.shape != (batch, want) or o.min() < 0 or o.max() >= cfg.vocab_size:
            problems.append(f"output {o.shape} [{o.min()}, {o.max()}], want "
                            f"({batch}, {want})")
        if t.prompt_len and not t.kv_wanted == t.kv_reserved == quote:
            problems.append(f"reservation {t.kv_reserved} of {t.kv_wanted}, "
                            f"quote {quote}")
        if problems:
            raise AssertionError(f"{label} {t.tid}: {problems}")
        tenants[t.tid] = {"tokens": res["tokens"], "ttft_s": res["ttft_s"],
                          "kv_wanted": res["kv_wanted"],
                          "kv_reserved": res["kv_reserved"],
                          "prefill_chunks": res["prefill_chunks"],
                          "lbm_frac": res["lbm_frac"],
                          "plans": dict(Counter(p.describe()
                                                for p in t.plans)),
                          "first_tokens": o[0, :8].tolist()}
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    if kinds != want_kinds:
        raise AssertionError(f"{label}: plan kinds {kinds}, the scheduler "
                             f"grants {want_kinds}")
    res = {"arch": cfg.name, "layers": srv.tenants[0].cfg.num_layers,
           "total_pages": pages, "quote": quote, "batch": batch,
           "max_len": max_len, "steps": steps, "plan_kinds": sorted(kinds),
           "launches": dict(counters),
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "dram_total": out["dram_bytes"],
           "host": out["host"], "tenants": tenants, "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, steps)
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    res["peak_memory_bytes_after_warm"] = torch.cuda.max_memory_allocated()
    t = srv.tenants[0]
    rec = res["replay_vs_eager"] = _replay_vs_eager(
        srv, ("single", t, srv._dec_plan(t, t.plans[-1]), 4))
    if not rec["bitwise"]:
        raise AssertionError(f"{label}: replay != eager: {rec}")
    res["profile"] = [_profile_replay(srv, srv.tenants[0], shares=shares)]
    return res


# --------------------------------------------------------------- self --
def check_serial_pipelined(cfg, dev, layers: int = 4):
    """Serial (per-step) and pipelined (epoch) serving of two resident
    tenants: bitwise-equal token streams and equal choice traces, under
    each pool of :data:`SELF_POOLS`: full width (4 layers) in a starved
    pool (the zero-page LWM candidate, cache_matmul), and the reduced
    width in a pool where the scheduler grants LBM (block_fused_ffn).
    Each pool's plan kind is the one :func:`grantable_kinds` computes,
    and some pool must be granted LBM."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    full = register(dataclasses.replace(cfg, name=f"{cfg.name}-{layers}layer",
                                        num_layers=layers))
    res = {}
    for width, pages in SELF_POOLS:
        arch = full if width == "full" else cfg
        served = arch if width == "full" else arch.reduced()
        kind = "LBM" if "LBM" in grantable_kinds(served, 2, pages) else "LWM"
        kernel = "block_fused_ffn" if kind == "LBM" else "cache_matmul"
        label = f"self {width}@{pages}p"
        outs = []
        _zero_counters()
        for pipeline in (False, True):
            srv = MultiTenantServer([arch.name, arch.name], batch=2, max_len=64,
                                    total_pages=pages, epoch_len=4,
                                    pipeline=pipeline, device=dev,
                                    reduced=width != "full")
            outs.append(srv.run(steps=12))
            got = {p.kind for t in srv.tenants for p in t.plans}
            if got != {kind}:
                raise AssertionError(f"{label}: plans {got}, want {kind}")
            plans = sorted({p.describe() for t in srv.tenants for p in t.plans})
            del srv
        counts = _counters()
        launches = counts[kernel]
        if launches <= 0:
            raise AssertionError(f"{label}: {kernel} never launched")
        if kernel == "cache_matmul" and served.dtype == "bfloat16":
            _gate_kinds(counts, label, ("gemv",))
        for tid, s in outs[0]["tenants"].items():
            p = outs[1]["tenants"][tid]
            if not np.array_equal(s["output"], p["output"]):
                raise AssertionError(f"{label} {tid}: serial and "
                                     "pipelined tokens differ")
            if s["choices"] != p["choices"]:
                raise AssertionError(f"{label} {tid}: choices differ")
        res[f"{width}@{pages}p"] = {
            "d_model": served.d_model, "layers": served.num_layers,
            "dtype": served.dtype, "kind": kind, "plans": plans,
            "launches": {k: v for k, v in counts.items()
                         if k.startswith(kernel)}, "tokens": {
                tid: v["tokens"] for tid, v in outs[1]["tenants"].items()},
            "bit_identical": True}
    if not any(r["kind"] == "LBM" for r in res.values()):
        raise AssertionError("self: no pool was granted LBM")
    return res


# ------------------------------------------------------------- graphs --
def _replay_vs_eager(srv, item):
    """One decode item or prompt chunk of a pipelined server on the card:
    the epoch core (or prefill core) runs eagerly, straight from the
    model, on clones of its tenants' caches, feedback tokens and device
    positions; then the server dispatches the item through its program
    (captured on a miss, then replayed).  Returns whether the tokens,
    every cache buffer, the feedback tokens and the positions are bitwise
    equal, the captures it took, and the kernel launches of both runs
    (the replay's from the counts its capture recorded)."""
    import torch
    from repro_torch.kernels import counters as kcount
    kind = item[0]
    if kind == "prefill":
        _, t, _, n = item
        group, plan, kv = [t], None, srv._kv_len(t.pf_pos + n)
    else:
        _, who, plan, n = item
        group, kv = (who if kind == "bucket" else [who]), srv._item_kv(item)
    clones = {t.tid: ([{name: b.clone() for name, b in c.items()}
                       for c in t.caches], t.token.clone(),
                      t.index_dev.clone(), srv._device_pos(t))
              for t in group}
    want = {}
    before = kcount.snapshot()
    for t in group:
        caches, tok, idx, pos = clones[t.tid]
        if kind == "prefill":
            want[t.tid], _ = srv._prefill_cores[t.cfg.name](
                t.params, caches, t.prompt_dev[:, pos:pos + n], idx, t.enc,
                kv_len=kv)
        else:
            want[t.tid], _ = srv._epoch_cores[t.cfg.name](
                t.params, caches, tok, idx, t.enc, plan=plan, k=n,
                kv_len=kv)
    eager = kcount.delta(before)
    captures = srv._captures
    before = kcount.snapshot()
    if kind == "prefill":
        srv._dispatch_prefill(item)
    else:
        srv._fused_epoch_fn(item)()
        for t in group:
            srv._advance(t, n)
    replay = kcount.delta(before)
    torch.cuda.synchronize()
    same = True
    for t in group:
        caches, _, _, pos = clones[t.tid]
        out = want[t.tid]
        same &= (torch.equal(t.log[:, pos + n - out.shape[1]:pos + n], out)
                 and torch.equal(t.token, out[:, -1:])
                 and int(t.index_dev) == pos + n == srv._device_pos(t)
                 and all(torch.equal(c[name], e[name])
                         for c, e in zip(t.caches, caches) for name in c))
    return {"kind": kind, "tenants": len(group), "position": pos, "steps": n,
            "kv_len": kv, "plan": plan.describe() if plan is not None else None,
            "kv_dtype": group[0].kv_dtype, "bitwise": bool(same),
            "captured": srv._captures - captures, "launches": replay,
            "eager_launches": eager}


def graph_checks(arch, dev, kv_dtype: str = "native", prompt_len=None):
    """Replay against eager dispatch in one pipelined server of ``arch``
    cut to :data:`GRAPHS`'s layers (a hybrid arch to one group: its
    ``attn_every`` layers): a prompt tenant's chunks (chunks of 256) and
    its decode epochs, and for an arch with attention and a native cache
    a resident's epochs alone and two residents' as a bucket.  Each
    decode item runs twice, at two positions: the first captures (after
    a warm-up where its signature has none), the second replays the same
    graph.  An MoE tenant's decode binds no plan (``_dec_plan``).
    Returns the checks and the server's record."""
    from repro_torch.core.vmem import LANE
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    from repro_torch.sim.driver import TenantSpec
    g = GRAPHS
    k = g["k"]
    if prompt_len is None:
        prompt_len = g["prompt_len"]
    layers = arch.attn_every if arch.family == "hybrid" else g["layers"]
    cut = register(dataclasses.replace(
        arch, name=f"{arch.name}-{layers}layer", num_layers=layers))
    dense = arch.family != "ssm"
    residents = [cut.name] * (3 if dense and kv_dtype == "native" else 0)
    srv = MultiTenantServer(
        residents, tenants=[TenantSpec(cut.name, prompt_len=prompt_len,
                                       n_inferences=2 * k)],
        batch=g["batch"], max_len=g["max_len"], total_pages=1 << 16,
        epoch_len=k, device=dev, reduced=False, kv_dtype=kv_dtype)
    planned = dense and not arch.is_moe
    plan = (_plan(cut, "LWM", g["lwm_pages"], LANE, kv_dtype) if planned
            else None)
    res_plan = _plan(cut, "LWM", g["lwm_pages"], LANE) if planned else None
    *res_t, prompt_t = srv.tenants
    checks = []
    while prompt_t.prefilling:    # chunks of 256, on the SSD grid
        chunk = min(256, prompt_t.prompt_len - prompt_t.pf_pos)
        checks.append(_replay_vs_eager(srv, ("prefill", prompt_t, None,
                                             chunk)))
    items = [("single", prompt_t, plan, k)]
    if res_t:
        items += [("single", res_t[0], res_plan, k),
                  ("bucket", res_t[1:], res_plan, k)]
    for item in items:     # capture, then a replay one epoch later
        checks += [_replay_vs_eager(srv, item) for _ in range(2)]
    rec = {"captures": srv._captures, "capture_s": srv._capture_s,
           "graph_pool_bytes": _graph_pool_bytes(srv),
           "warm_signatures": len(srv._warm_sigs)}
    del srv, res_t, prompt_t
    _release()
    return checks, rec


def _graph_faults(checks):
    """The checks that are not bitwise or whose replay launched other
    kernels than the eager run, and a second replay that captured."""
    bad = [c for c in checks if not c["bitwise"]
           or c["launches"] != c["eager_launches"]]
    repeats = [c for c in checks if c["kind"] != "prefill"][1::2]
    if any(c["captured"] for c in repeats):
        bad.append("a second replay captured")
    return bad


def check_graphs(cfg, ssm_cfg, dev, kinds: bool = True, moe_cfg=None,
                 hybrid_cfg=None, encdec_cfg=None):
    """Graph replay against eager dispatch at full width (4 layers), by
    :func:`graph_checks`: in a pipelined yi-9b server a prompt tenant's
    chunks (256 + 128 tokens) and epochs with a native and, in a second
    server, an int8 cache, a resident's epochs alone and two residents'
    as a bucket; in a mamba2 server a prompt tenant's 256-token chunk
    and 44-token tail and its epochs; with ``moe_cfg``, the same items of
    olmoe-1b-7b (native cache); with ``hybrid_cfg``, zamba2-2.7b cut to
    one group: a prompt tenant's 256-token chunk and 44-token tail, its
    epochs, a resident alone and two as a bucket (native cache); with
    ``encdec_cfg``, whisper-tiny's (4 decoder layers): a prompt tenant's
    chunks and epochs, a resident alone and two as a bucket, each
    tenant's cross-attention over its own ``enc``.  Every check must be
    bitwise in tokens and every cache buffer, launch the kernels the eager
    run launches (by the counts), and a second replay must capture
    nothing."""
    g = GRAPHS
    res, checks = {}, []
    cases = [(cfg, "native", g["prompt_len"]), (cfg, "int8", g["prompt_len"]),
             (ssm_cfg, "native", g["ssm_prompt_len"])]
    if moe_cfg is not None:
        cases.append((moe_cfg, "native", g["prompt_len"]))
    if hybrid_cfg is not None:
        cases.append((hybrid_cfg, "native", g["ssm_prompt_len"]))
    if encdec_cfg is not None:
        cases.append((encdec_cfg, "native", g["prompt_len"]))
    for arch, kv_dtype, prompt_len in cases:
        got, res[f"{arch.name}/{kv_dtype}"] = graph_checks(
            arch, dev, kv_dtype, prompt_len)
        checks += got
    bad = _graph_faults(checks)
    items = {c["kind"] for c in checks}
    launches = Counter()
    for c in checks:
        launches.update(c["launches"])
    if (bad or items != {"prefill", "single", "bucket"}
            or not launches["cache_matmul"] or not launches["ssd_chunk"]):
        raise AssertionError(f"graphs: {bad or items} ({dict(launches)}): "
                             f"{checks}")
    aot = _check_aot(cfg, dev)
    if kinds:   # full width: the decode matmuls' gemv, ssd_chunk's wgmma
        _gate_kinds({**dict.fromkeys(_counters(), 0), **launches}, "graphs",
                    ("gemv",),
                    ssd=("wgmma",))
    return {"layers": g["layers"], "servers": res, "checks": checks,
            "launches": dict(launches), "aot": aot, "bit_identical": True}


def _check_aot(cfg, dev):
    """``aot_warmup=True`` on the card (full width, 4 layers): two
    residents and a prompt tenant served with and without it; the tokens
    and choice traces must be equal, and the predicted programs (captured
    before the first epoch, each warm-up at the tenants' positions then)
    must be hits."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    name = f"{cfg.name}-{GRAPHS['layers']}layer"
    runs = {}
    for aot in (False, True):
        srv = MultiTenantServer(
            [name, name], tenants=[TenantSpec(name, prompt_len=256,
                                              n_inferences=8)],
            batch=GRAPHS["batch"], max_len=GRAPHS["max_len"],
            total_pages=1 << 16, epoch_len=GRAPHS["k"], device=dev,
            reduced=False, aot_warmup=aot)
        out = srv.run(steps=16)
        runs[aot] = (out, srv._fused_jits.misses)
        del srv
        _release()
    (plain, plain_misses), (warm, warm_misses) = runs[False], runs[True]
    for tid, p in plain["tenants"].items():
        w = warm["tenants"][tid]
        if not np.array_equal(p["output"], w["output"]) or \
                p["choices"] != w["choices"]:
            raise AssertionError(f"aot: {tid} differs with aot_warmup")
    if not warm["host"]["aot_compiled"] or warm_misses >= plain_misses:
        raise AssertionError(f"aot: {warm['host']} misses {warm_misses} "
                             f"vs {plain_misses}")
    return {"aot_compiled": warm["host"]["aot_compiled"],
            "fused_misses": {"plain": plain_misses, "aot": warm_misses},
            "epoch_compiles": {"plain": plain["host"]["epoch_compiles"],
                               "aot": warm["host"]["epoch_compiles"]},
            "tokens_equal": True}


# ------------------------------------------------------------ prefill --
def _plain_quantized_attention(fn):
    """``fn()`` with the quantized flash kernel's plain version in place
    of the kernel (a control run: it launches no quantized kernel)."""
    from repro_torch.kernels import flash_attention as kfa
    kernel = kfa.flash_attention_quantized
    kfa.flash_attention_quantized = (
        lambda q, k, v, ks, vs, causal, tile:
        kfa.flash_attention_quantized_plain(q, k, v, ks, vs, causal))
    try:
        return fn()
    finally:
        kfa.flash_attention_quantized = kernel


def _layer_trace(fn):
    """``fn()`` with each dense layer's attention output and output
    recorded and, in an MoE layer, the experts each token was routed to
    and those that the capacity buckets kept ([G, T, E] masks, taken from
    ``moe_apply``'s own dispatch).  Returns (fn's result, one record per
    layer in order)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    block, attention, dispatch = tr._dense_block, tr.mha, moe._dispatch
    records, layer = [], {}

    def traced_mha(*args, **kwargs):
        out = attention(*args, **kwargs)
        layer["attn"] = out[0]
        return out

    def traced_dispatch(x, top_e, C, E):
        out = dispatch(x, top_e, C, E)
        _, order, _, keep, tok = out
        G, T, K = top_e.shape
        expert = torch.gather(top_e.reshape(G, T * K), 1, order)
        kept = torch.zeros((G, T * E), dtype=torch.bool, device=x.device)
        kept.scatter_(1, tok * E + expert, keep)
        routed = torch.nn.functional.one_hot(top_e, E).sum(-2) > 0
        layer.update(routed=routed, kept=kept.reshape(G, T, E))
        return out

    def traced_block(*args, **kwargs):
        out = block(*args, **kwargs)
        records.append({"x": out[0], **layer})
        layer.clear()
        return out

    tr._dense_block, tr.mha, moe._dispatch = (traced_block, traced_mha,
                                              traced_dispatch)
    try:
        return fn(), records
    finally:
        tr._dense_block, tr.mha, moe._dispatch = block, attention, dispatch


def _layer_divergence(got, want):
    """Per layer, how far two traced runs drift apart: the attention
    outputs' and the layer outputs' max |difference| over ``want``'s
    largest value and, in an MoE layer, the tokens whose top-k experts
    differ (``route_flips``) and those whose kept experts differ under
    the same top-k (``displaced``: pushed out of, or let into, a full
    bucket by another token's new route)."""
    def rel(g, w):
        w = w.float()
        return float((g.float() - w).abs().max() / w.abs().max())

    rows = []
    for g, w in zip(got, want):
        row = {"attn_rel_err": rel(g["attn"], w["attn"]),
               "rel_err": rel(g["x"], w["x"])}
        if "routed" in w:
            flips = (g["routed"] != w["routed"]).any(-1)
            moved = (g["kept"] != w["kept"]).any(-1) & ~flips
            row.update(route_flips=int(flips.sum()), displaced=int(moved.sum()))
        rows.append(row)
    return rows


def _min_cosine(got, want) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(got, want,
                                                       dim=-1).min())


# the kinds every bf16 launch of the dense and MoE prefill must take
PREFILL_KINDS = dict(matmul=("wgmma",), flash=("wgmma",), ffn=("wgmma",),
                     flash_quantized=("wgmma",))


def prefill_main_path(cfg, dev, counters, label: str = "prefill", plans=None,
                      serve=(), profiled=("LBM/native", "LWM/int8",
                                          "LWM/fp8_e4m3"), prefix: int = 0):
    """``make_prefill`` of a full-width, full-depth arch (yi-9b: slice
    2's path; olmoe-1b-7b: the MoE slice's, one ``planned_ffn`` per
    expert and layer under a plan), 2 prompts of 1024 tokens from numpy,
    random weights from one seed, under ``plans`` (default: the four
    settings of :func:`prefill_plans`), then ``make_prefill(cfg,
    serve=True)`` under each plan named in ``serve``.  ``counters``
    receives the launch counts of one pass of the calls (zeroed just
    before, read just after); each call's own counts are kept too.
    Gates: finite logits; every plan within :func:`_gate` of the plain
    path of its ``serve``; a quantized-KV plan also at the cosine bar of
    :data:`PREFILL_COSINE` against it, and, where its call launched the
    quantized flash kernel, within :func:`_gate` of a control run that
    puts the plain attention in place of that kernel, the kernel's and
    the control's runs compared layer by layer
    (:func:`_layer_divergence`); each of the arch's kernels launched,
    every bf16 launch of the wgmma kind (:func:`_gate_kinds`).  A hybrid
    arch (zamba2-2.7b) launches :data:`HYBRID_KERNELS` (its sliding
    window keeps attention plain, no flash kernel runs; its Mamba2
    layers run ssd_chunk), and its bf16 plans are held relative to a
    control, the plain path with ssd_chunk's plain version
    (:func:`_relative_gate`: 45 random bf16 Mamba2 layers grow a
    rounding difference past :func:`_gate`'s bar), and on an fp32 copy
    of the weights each plan within :func:`_gate` of the plain path with
    its greedy tokens equal.  With ``prefix`` (llava-next: its 576
    patches) each prompt carries that many patch embeddings from numpy
    before its tokens, so the calls run prefix + 1024 positions.  Then
    each call is timed warm on the host clock, and those named in
    ``profiled`` profiled once."""
    import torch
    from repro_torch.models import model as M
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    V = cfg.vocab_size
    hybrid = cfg.family == "hybrid"
    kernels, kinds = ((HYBRID_KERNELS, HYBRID_KINDS) if hybrid
                      else (PREFILL_KERNELS, PREFILL_KINDS))
    params = M.init_params(cfg, seed=2, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (B, S))).long().to(dev)
    batch = {"tokens": toks}
    if prefix:
        batch["embeds_prefix"] = torch.from_numpy(
            np.random.default_rng(3).standard_normal(
                (B, prefix, cfg.d_model), dtype=np.float32)).to(
                    dev, cfg.torch_dtype)
    plans = plans or prefill_plans(cfg)
    calls = {name: (M.make_prefill(cfg), plan) for name, plan in plans.items()}
    calls.update({f"serve/{n}": (M.make_prefill(cfg, serve=True), plans[n])
                  for n in serve})

    def call(name):
        fn, plan = calls[name]
        out = fn(params, batch, plan)
        torch.cuda.synchronize()
        return out

    _zero_counters()
    logits, first_s, per_call = {}, {}, {}
    for name in calls:
        before = _counters()
        t0 = time.perf_counter()
        logits[name] = call(name)[:, :V].float()
        first_s[name] = time.perf_counter() - t0
        per_call[name] = {k: v - before[k] for k, v in _counters().items()
                          if v - before[k]}
    counters.update(_counters())
    if min(counters[k] for k in kernels) <= 0:
        raise AssertionError(f"{label}: a kernel never launched: {counters}")
    _gate_kinds(counters, label, **kinds)
    bad = [n for n, lg in logits.items() if not bool(torch.isfinite(lg).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite logits under {bad}")
    plain = {False: logits["plain"]}
    if serve:
        plain[True] = M.make_prefill(cfg, serve=True)(
            params, batch)[:, :V].float()
    gates = {}
    if hybrid:
        gates["control"] = _agreement(
            _plain_ssd_chunk(lambda: call("plain"))[:, :V].float(),
            plain[False])
    for name, lg in logits.items():
        if name == "plain":
            continue
        want = plain[name.startswith("serve/")]
        if not hybrid:
            gate = {**_gate(lg, want, f"{label} {name}"),
                    "min_cosine": _min_cosine(lg, want)}
        else:
            gate = _relative_gate(lg, want, gates["control"],
                                  f"{label} {name}")
        gates[name] = gate
        kv = calls[name][1].kv_dtype
        if kv == "native" or not per_call[name].get(
                "flash_attention_quantized"):
            continue        # nothing quantized (a sliding window: plain)
        # the control: the same plan and quantized K/V through the plain
        # attention, so the kernel's share of the error shows apart from
        # the quantization's
        _, traced = _layer_trace(lambda n=name: call(n))
        control, control_traced = _layer_trace(
            lambda n=name: _plain_quantized_attention(lambda: call(n)))
        control = control[:, :V].float()
        gate.update(min_cosine_bar=PREFILL_COSINE[kv],
                    control_min_cosine=_min_cosine(control, want),
                    control_max_abs_err=float((control - want).abs().max()),
                    vs_control=_gate(lg, control,
                                     f"{label} {name} vs control"),
                    layers_vs_control=_layer_divergence(traced,
                                                        control_traced))
        del traced, control_traced
        if gate["min_cosine"] < PREFILL_COSINE[kv]:
            raise AssertionError(f"{label} {name}: {gate}")
    if hybrid:
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _to_dtype(params, torch.float32)
        l32 = {name: M.make_prefill(c32)(p32, {"tokens": toks}, plan)[
            :, :V].float() for name, (_, plan) in calls.items()}
        del p32
        for name, lg in l32.items():
            if name == "plain":
                continue
            gate = gates[name]["fp32"] = _gate(
                lg, l32["plain"], f"{label} {name} fp32")
            if gate["greedy_agreement"] != 1.0:
                raise AssertionError(f"{label} {name} fp32: {gate}")
        del l32
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, (_, plan) in calls.items():
        t0 = time.perf_counter()
        call(name)
        wall = time.perf_counter() - t0
        runs[name] = {"plan": plan.describe() if plan is not None else None,
                      "first_wall_s": first_s[name], "wall_s": wall,
                      "tokens_per_s": B * (prefix + S) / wall,
                      "launches": per_call[name]}
    peak = torch.cuda.max_memory_allocated()
    profiles = {name: {"plan": runs[name]["plan"],
                       **_profile(lambda n=name: call(n))}
                for name in profiled}
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "prompt_len": S, "prefix": prefix,
            "launches": dict(counters), "gates": gates,
            "runs": runs, "peak_memory_bytes": peak, "profile": profiles}


# ----------------------------------------------------------- serve_kv --
def serve_kv_pool(cfg) -> int:
    """The serve_kv pool: one native reservation, one fp8 reservation and
    the serve phase's headroom above its native reservation."""
    from repro_torch.launch.serve import _kv_reserve_pages
    b, p = SERVE_KV["batch"], SERVE_KV["prompt_len"]
    native = _kv_reserve_pages(cfg, b, p)
    return native + _kv_reserve_pages(cfg, b, p, "fp8_e4m3") + (SERVE_PAGES
                                                                 - native)


def _profile_cache_epoch(cfg, params, dev, plan, kv_dtype, k: int = 4):
    """:func:`_profile` of one decode epoch (batch and prompt of
    :data:`SERVE_KV`) of a tenant with a ``kv_dtype`` cache, prefilled
    from a seeded prompt; K/V (de)quantization annotated."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import quant
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches
    B, P, L = SERVE_KV["batch"], SERVE_KV["prompt_len"], SERVE_KV["max_len"]
    caches = init_caches(params, cfg, B, L, kv_dtype=kv_dtype, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P))).long().to(dev)
    token, caches = M.make_prefill_chunk(cfg)(params, caches, prompt, 0)
    epoch = M.make_decode_epoch(cfg)
    state = {"token": token, "index": P}

    def run():
        i = state["index"]                 # the server's 128-token windows
        toks, _ = epoch(params, caches, state["token"], i, plan=plan, k=k,
                        kv_len=min(L, -(-(i + k) // LANE) * LANE))
        state["token"], state["index"] = toks[:, -1:], i + k
        torch.cuda.synchronize()

    names = ("quantize_rows", "dequantize_rows")
    kept = {n: getattr(quant, n) for n in names}

    def annotated(name):
        def fn(*a, **kw):
            with torch.profiler.record_function(name):
                return kept[name](*a, **kw)
        return fn

    for n in names:
        setattr(quant, n, annotated(n))
    try:
        return {"plan": plan.describe(), "kv_dtype": kv_dtype, "steps": k,
                **_profile(run, annotations=names)}
    finally:
        for n, fn in kept.items():
            setattr(quant, n, fn)


def serve_kv_main_path(cfg, dev, counters, found):
    """Quantized-KV serving: full-width, full-depth yi-9b under
    ``kv_dtype="auto"``, one resident tenant and three prompt tenants
    arriving at distinct steps, all on one weight set (``params_fn``
    memo), in the :func:`serve_kv_pool`.  The rung each arrival must take
    is computed from the reservation quotes and the free pages at its
    admission (the pool less the reservations already held), and
    asserted with the free pages the server saw.  ``counters`` receives
    the kernels' launch counts of the run (zeroed just before, read just
    after), ``found["decode_plan"]`` the int8 tenant's last decode plan.
    Then one decode epoch under that plan is profiled with a native and
    with an int8 cache."""
    import torch
    from repro_torch.core.policy import KV_PRECISION_LADDER, choose_kv_dtype
    from repro_torch.kernels import quant
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.models import model as M
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    B, P = SERVE_KV["batch"], SERVE_KV["prompt_len"]
    budget, steps = SERVE_KV["budget"], SERVE_KV["steps"]
    pool = serve_kv_pool(cfg)
    quotes = {kv: _kv_reserve_pages(cfg, B, P, kv) for kv in KV_PRECISION_LADDER}
    free, want_free, want_rungs = pool, [], []
    for _ in SERVE_KV["arrive_at"]:
        rung = choose_kv_dtype(quotes, free)
        want_free.append(free)
        want_rungs.append(rung)
        free -= min(quotes[rung], free)
    if want_rungs != ["native", "fp8_e4m3", "int8"]:
        raise AssertionError(f"serve_kv: pool {pool} gives rungs {want_rungs}")
    memo = {}

    def params_fn(c, pkey):
        if pkey not in memo:
            memo[pkey] = M.init_params(c, pkey, dev)
        return memo[pkey]

    specs = [TenantSpec(cfg.name, param_seed=0)] + [
        TenantSpec(cfg.name, arrive_at=at, prompt_len=P, n_inferences=budget,
                   param_seed=0) for at in SERVE_KV["arrive_at"]]
    srv = MultiTenantServer([], tenants=specs, batch=B,
                            max_len=SERVE_KV["max_len"], total_pages=pool,
                            epoch_len=4, device=dev, reduced=False,
                            kv_dtype="auto", params_fn=params_fn)
    seen_free, stamped = [], {}
    choose, record = srv._choose_kv_dtype, srv._record_page_scales

    def spy_choose(c, spec):
        seen_free.append(srv.cache.free_pages)
        return choose(c, spec)

    def spy_record(t):
        record(t)
        stamped[t.tid] = {
            "leaves": {n: str(b.dtype) for n, b in t.caches[0].items()},
            "page_scales": list(srv.cache.page_scales_of(t.tid + "#kv")
                                .values()),
            "pages": len(srv.cache.pages_of(t.tid + "#kv"))}

    srv._choose_kv_dtype, srv._record_page_scales = spy_choose, spy_record
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    if counters["cache_matmul"] <= 0:
        raise AssertionError(f"serve_kv: cache_matmul never launched: {counters}")
    if seen_free != want_free:
        raise AssertionError(f"serve_kv: free pages at admission {seen_free}, "
                             f"predicted {want_free}")
    want_kinds = grantable_kinds(cfg, B, pool)
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    if kinds != want_kinds:
        raise AssertionError(f"serve_kv: plan kinds {kinds}, the scheduler "
                             f"grants {want_kinds}")
    resident, arrivals = srv.tenants[0], srv.tenants[1:]
    vocab, tenants = cfg.vocab_size, {}
    for t, rung in [(resident, "native")] + list(zip(arrivals, want_rungs)):
        res = out["tenants"][t.tid]
        o = res["output"]
        want_len = steps if t.prompt_len == 0 else 1 + budget
        tags = {p.describe().partition("+kv:")[2] or "native" for p in t.plans}
        leaves = (stamped[t.tid]["leaves"] if t.prompt_len else
                  {n: str(b.dtype) for n, b in t.caches[0].items()})
        want_leaves = ({"k": "torch.bfloat16", "v": "torch.bfloat16"}
                       if rung == "native" else
                       {"k": str(quant.kv_storage_dtype(rung)),
                        "v": str(quant.kv_storage_dtype(rung)),
                        "k_scale": "torch.float32", "v_scale": "torch.float32"})
        problems = []
        if t.kv_dtype != rung or res["kv_dtype"] != rung or tags != {rung}:
            problems.append(f"rung {t.kv_dtype}/{res['kv_dtype']} tags {tags}")
        if leaves != want_leaves:
            problems.append(f"cache leaves {leaves}")
        if t.prompt_len and t.kv_wanted != quotes[rung]:
            problems.append(f"kv_wanted {t.kv_wanted} != {quotes[rung]}")
        if rung != "native":
            sc = stamped[t.tid]
            if not sc["page_scales"] or sc["pages"] != len(sc["page_scales"]) \
                    or min(sc["page_scales"]) <= 0:
                problems.append(f"page scales {sc}")
        if o.shape != (B, want_len) or o.min() < 0 or o.max() >= vocab:
            problems.append(f"output {o.shape} range [{o.min()}, {o.max()}]")
        if problems:
            raise AssertionError(f"serve_kv {t.tid}: {problems}")
        tenants[t.tid] = {
            "kv_dtype": t.kv_dtype, "tokens": res["tokens"],
            "ttft_s": res["ttft_s"], "kv_wanted": res["kv_wanted"],
            "kv_reserved": res["kv_reserved"],
            "prefill_chunks": res["prefill_chunks"],
            "plans": dict(Counter(p.describe() for p in t.plans)),
            "page_scales": ({"n": len(stamped[t.tid]["page_scales"]),
                             "min": min(stamped[t.tid]["page_scales"]),
                             "max": max(stamped[t.tid]["page_scales"])}
                            if rung != "native" else None),
            "first_tokens": o[0, :8].tolist()}
    full = [t.kv_reserved == t.kv_wanted for t in arrivals]
    if full != [True, True, False]:
        raise AssertionError(f"serve_kv: full reservations {full}, want "
                             "the first two full and the int8 one partial")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "total_pages": pool,
           "quotes": quotes, "free_at_admission": seen_free,
           "rungs": [t.kv_dtype for t in arrivals], "batch": B,
           "max_len": SERVE_KV["max_len"], "steps": steps,
           "plan_kinds": sorted(kinds), "launches": dict(counters),
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "dram_total": out["dram_bytes"],
           "host": out["host"], "tenants": tenants, "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, SERVE_KV["warm_steps"])
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    res["profile_replay"] = _profile_replay(srv, resident)
    int8 = arrivals[2]
    plan = int8.plans[-1]                       # its last decode epoch's
    params = memo[0]
    del srv, resident, arrivals, int8
    found["decode_plan"] = plan
    res["decode_plan"] = plan.describe()
    res["profile"] = {kv: _profile_cache_epoch(cfg, params, dev, plan, kv)
                      for kv in ("native", "int8")}
    prof = res["profile"]
    if all(isinstance(prof[kv]["device_ms"], float) for kv in prof):
        res["quantized_cache_overhead_share"] = (
            1 - prof["native"]["device_ms"] / prof["int8"]["device_ms"])
    return res


# ---------------------------------------------------------- ffn_quant --
def _plain_ffn_quant(x, wg, wg_s, wu, wu_s, wd, wd_s):
    import torch.nn.functional as F
    from repro_torch.kernels import cache_matmul as kmm
    g = kmm.cache_matmul_quant_plain(x, wg, wg_s)
    u = kmm.cache_matmul_quant_plain(x, wu, wu_s)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return kmm.cache_matmul_quant_plain(h, wd, wd_s)


def _library_quant_ms(a, q, scale, want, dn):
    """One PyTorch call computing the same function, timed on the same
    inputs: ``torch._weight_int8pack_mm`` for int8 codes where this
    build runs it on CUDA and it agrees with the plain version; else
    None and the reason."""
    import torch
    if q.dtype != torch.int8:
        return None, "no PyTorch call takes fp8 codes with per-column scales"
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch._weight_int8pack_mm missing"
    qt, st = q.t().contiguous(), scale[0].to(a.dtype).contiguous()
    try:
        got = fn(a, qt, st)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch._weight_int8pack_mm: {str(e).splitlines()[0][:160]}"
    err, ok = _close(got, want, dn)
    if not ok:
        return None, f"torch._weight_int8pack_mm disagrees: max error {err}"
    return _median_ms(lambda: fn(a, qt, st), 10), "torch._weight_int8pack_mm"


def quant_timings(cfg, dev, plans):
    """cache_matmul_quant at the ffn_quant path's GEMMs (bf16 A, int8 and
    fp8 codes, M = 2 and 2048 rows, gate/up and down) with the tiles each
    plan lowers to (gemv at 2 rows, wgmma at 2048), against its plain
    version on the timed inputs and bitwise on a repeat: CUDA event
    medians of the kernel and, in turns with it, of the simt tile the
    same plan gave before the new kinds (``simt_ms``), of the plain
    version, a library call where one computes the same function, and
    ``torch.matmul`` on a bf16 B dequantized beforehand (a yardstick for
    another function)."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops, quant
    d, f = cfg.d_model, cfg.d_ff
    dt, dn, eb = torch.bfloat16, "bfloat16", 2
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out, timed = {}, {}
    for rows in (2, 2048):
        acts = {"up": _randn(gen, (rows, d), dt), "down": _randn(gen, (rows, f), dt)}
        for kv in KV_CACHES:
            for gemm, (k, n) in (("up", (d, f)), ("down", (f, d))):
                w = _randn(gen, (k, n), torch.float32, 1 / math.sqrt(k))
                q, sc = quant.quantize_cols(w, kv)
                deq = (q.float() * sc).to(dt)
                a = acts[gemm]
                want = kmm.cache_matmul_quant_plain(a, q, sc)
                lib_ms, lib = _library_quant_ms(a, q, sc, want, dn)
                for pname, plan in plans.items():
                    tiles = ops.ffn_quant_tiles(plan, rows, d, f)
                    tile = tiles[0] if gemm == "up" else tiles[1]
                    hop = ops.legalize_matmul_quant_tile(tile, rows, limit,
                                                         dt, k, n)
                    # the simt tile the same plan gives fp32 (every bf16
                    # call's before the gemv and wgmma kinds)
                    simt = ops.legalize_matmul_quant_tile(
                        tile, rows, limit, torch.float32, k, n)
                    if (hop, simt) not in timed:  # plans that share tiles
                        bound, by = _bound(
                            eb * (rows * k + rows * n) + k * n + 4 * n,
                            2 * rows * k * n, dn)
                        got = kmm.cache_matmul_quant(a, q, sc, hop)
                        err, ok = _close(got, want, dn)
                        repeat = bool(torch.equal(
                            got, kmm.cache_matmul_quant(a, q, sc, hop)))
                        del got
                        reps = 30 if rows <= 8 else 10
                        t = _turns_ms({
                            "ms": lambda: kmm.cache_matmul_quant(a, q, sc, hop),
                            "simt_ms": lambda: kmm.cache_matmul_quant(
                                a, q, sc, simt)}, reps)
                        timed[hop, simt] = {
                            "kv": kv, "shape": [rows, k, n], "kind": hop.kind,
                            "hopper_tile": [hop.bm, hop.bn, hop.bk],
                            "simt_tile": [simt.bm, simt.bn, simt.bk], **t,
                            "speedup_vs_simt": t["simt_ms"] / t["ms"],
                            "plain_ms": _median_ms(
                                lambda: kmm.cache_matmul_quant_plain(a, q, sc),
                                reps),
                            "library_ms": lib_ms, "library": lib,
                            "yardstick_matmul_dequantized_bf16_ms": _median_ms(
                                lambda: torch.matmul(a, deq), reps),
                            "bound_ms": bound, "bound_by": by,
                            "max_abs_err": err, "bitwise_repeat": repeat,
                            "ok": ok and repeat}
                        if lib_ms is not None:
                            timed[hop, simt]["vs_library"] = t["ms"] / lib_ms
                        if hop.kind == "gemv":
                            timed[hop, simt]["gemv_split"] = list(
                                kmm.gemv_split(n, k, torch.cuda.
                                               get_device_properties(
                                                   a.device).multi_processor_count))
                    out[f"{kv} {pname} m{rows} {gemm}"] = {
                        "plan": pname, "plan_tile": [tile.bm, tile.bn, tile.bk],
                        **timed[hop, simt]}
                timed.clear()
                del w, q, sc, deq
    return out


def ffn_quant_plans(cfg, decode_plan):
    """The FfnPlans the ffn_quant phase runs: the decode grant of the
    serve_kv phase's int8 tenant, the LWM@32p prefill plan, and the
    smallest fused (LBM) prefill grant, whose quantized FFN takes the
    fallback tile."""
    from repro_torch.core.vmem import fused_ffn_pages
    s = PREFILL["prompt_len"]
    lbm = _plan(cfg, "LBM", fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2), s)
    lwm = _plan(cfg, "LWM", PREFILL["lwm_pages"], s)
    return {f"decode {decode_plan.describe()}": decode_plan.ffn,
            f"prefill {lwm.describe()}": lwm.ffn,
            f"fallback {lbm.describe()}": lbm.ffn}


def ffn_quant_main_path(cfg, dev, decode_plan, counters):
    """``ops.planned_ffn_quant`` over every layer of full-width yi-9b,
    FFN weights drawn in bf16 from one seed and quantized per column to
    int8 and to fp8, on x of 2 and of 2048 rows, under the three plans of
    :func:`ffn_quant_plans`.  ``counters`` receives the launch counts of
    one pass of the twelve settings (zeroed just before, read just
    after); each setting's 48-layer pass is timed on the host clock,
    synchronised.  Gates per layer: within tolerance of the plain chain on
    the same codes, and at :data:`PREFILL_COSINE` (per row) against
    ``ops.planned_ffn`` on the bf16 weights under the same plan."""
    import torch
    from repro_torch.kernels import ops, quant
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    plans = ffn_quant_plans(cfg, decode_plan)
    weights, qweights = [], {kv: [] for kv in KV_CACHES}
    for _ in range(L):
        w = tuple(_randn(gen, shape, torch.bfloat16, 1 / math.sqrt(shape[0]))
                  for shape in ((d, f), (d, f), (f, d)))
        weights.append(w)
        for kv in KV_CACHES:
            qweights[kv].append(tuple(t for wi in w
                                      for t in quant.quantize_cols(wi, kv)))
    xs = {rows: _randn(gen, (rows, d), torch.bfloat16) for rows in (2, 2048)}
    settings = [(kv, pname, rows) for kv in KV_CACHES for pname in plans
                for rows in xs]
    for kv, pname, rows in settings:                        # warm
        ops.planned_ffn_quant(xs[rows], *qweights[kv][0], plans[pname])
    torch.cuda.synchronize()
    _zero_counters()
    outs, pass_ms = {}, {}
    for key in settings:
        kv, pname, rows = key
        t0 = time.perf_counter()
        outs[key] = [ops.planned_ffn_quant(xs[rows], *qweights[kv][l],
                                           plans[pname]) for l in range(L)]
        torch.cuda.synchronize()
        pass_ms[key] = (time.perf_counter() - t0) * 1e3
    counters.update(_counters())
    if counters["cache_matmul_quant"] != len(settings) * L * 3:
        raise AssertionError(f"ffn_quant: launches {counters}, want "
                             f"{len(settings) * L * 3} cache_matmul_quant")
    # bf16 activations: 2 rows on the gemv tile, 2048 on a wgmma tile
    _gate_kinds(counters, "ffn_quant", quant=("gemv", "wgmma"))
    if counters["cache_matmul_quant.gemv"] != counters["cache_matmul_quant"] // 2:
        raise AssertionError(f"ffn_quant: kinds {counters}")
    results = {}
    for pname in plans:
        for rows, x in xs.items():
            ref = [ops.planned_ffn(x, *weights[l], plans[pname])
                   for l in range(L)]
            for kv in KV_CACHES:
                key = (kv, pname, rows)
                worst_err, min_cos, bad = 0.0, 1.0, []
                for l, got in enumerate(outs.pop(key)):
                    err, ok = _close(got, _plain_ffn_quant(x, *qweights[kv][l]),
                                     "bfloat16")
                    cos = float(torch.nn.functional.cosine_similarity(
                        got.float(), ref[l].float(), dim=-1).min())
                    worst_err, min_cos = max(worst_err, err), min(min_cos, cos)
                    if not ok or not bool(torch.isfinite(got).all()):
                        bad.append(l)
                if bad or min_cos < PREFILL_COSINE[kv]:
                    raise AssertionError(
                        f"ffn_quant {key}: layers {bad} off the plain chain "
                        f"(max error {worst_err}), min cosine {min_cos} "
                        "against planned_ffn")
                results[f"{kv} {pname} m{rows}"] = {
                    "pass_ms": pass_ms[key], "max_abs_err_vs_plain": worst_err,
                    "tol": TOL["bfloat16"],
                    "min_cosine_vs_bf16_planned_ffn": min_cos,
                    "min_cosine_bar": PREFILL_COSINE[kv]}
            del ref
    del weights, qweights, xs
    torch.cuda.empty_cache()
    timings = quant_timings(cfg, dev, plans)
    bad = [k for k, v in timings.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"ffn_quant: kernel off its plain version: {bad}")
    return {"arch": cfg.name, "layers": L, "plans": list(plans),
            "launches": dict(counters), "settings": results,
            "timings": timings}


# --------------------------------------------------------------- main --
# ---------------------------------------------------------------- ssm --
def _ssm_plans(cfg):
    """The plans of :data:`SSM_GRANTS` (LWM grants; an SSM layer reads
    only their SSD chunk), keyed by the chunk each lowers to."""
    from repro_torch.core.vmem import LANE
    plans = {}
    for pages in SSM_GRANTS:
        plan = _plan(cfg, "LWM", pages, LANE)
        plans[plan.ssm_chunk] = plan
    if sorted(plans, reverse=True) != [256, 128, 64]:
        raise AssertionError(f"SSM grants {SSM_GRANTS} lower to chunks "
                             f"{sorted(plans)}")
    return plans


def _kernel_share(profile, name: str):
    """Share of the profiled device time in kernels whose name holds
    ``name`` (from the profile's top rows)."""
    if not isinstance(profile.get("device_ms"), float):
        return "not measured"
    return sum(r["share"] for r in profile["top"] if name in r["name"])


def check_e2e_ssm(cfg, dev):
    """Full-width mamba2 cut to ``SSM_E2E["layers"]`` layers: the card
    with ssd_chunk against the CPU with its plain version, same weights
    and tokens.  ``make_prefill`` under the :func:`_ssm_plans` of a
    300-token prompt (a 256-token chunk and a 44-token tail segment: the
    plans' chunks do not divide 300, so each runs the architecture's
    256, as the reference does) and of a 512-token prompt (which each
    plan's chunk divides), then a prefill and two teacher-forced decode
    epochs of 4 steps; gated by :func:`_gate`, greedy tokens of the
    prefills equal.  Records, without gating, whether a chunked prefill
    (256 + 44, the state carried) equals the one-shot prefill bitwise on
    the card."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches, prefill_chunk
    cfg = dataclasses.replace(cfg, num_layers=SSM_E2E["layers"])
    B, P = SSM_E2E["batch"], SSM_E2E["prompt_len"]
    plans = _ssm_plans(cfg)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    forced = rng.integers(0, cfg.vocab_size, (B, 9))
    aligned = rng.integers(0, cfg.vocab_size, (B, 512))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        pf = {}
        for name in (P, 512):
            toks = torch.from_numpy(prompt if name == P else aligned)
            toks = toks.long().to(device)
            for q, plan in plans.items():
                pf[(name, q)] = prefill(params, {"tokens": toks},
                                        plan).float().cpu()
        return pf, _e2e_run(cfg, params, device, prompt, forced, [None, None])

    params = M.init_params(cfg, seed=1, device=dev)
    _zero_counters()
    got_pf, got = run(params, dev)
    launches = _counters()["ssd_chunk"]
    if launches <= 0:
        raise AssertionError("e2e_ssm: ssd_chunk never launched")
    toks = torch.from_numpy(prompt).long().to(dev)
    last, states = {}, {}
    for name, cuts in (("one_shot", (P,)), ("chunked", (256, P))):
        caches = init_caches(params, cfg, B, P, device=dev)
        lo = 0
        for hi in cuts:
            logits, caches = prefill_chunk(params, toks[:, lo:hi], caches, lo,
                                           cfg)
            lo = hi
        last[name], states[name] = logits, caches
    chunked = {
        "cuts": [256, P - 256],
        "logits_bitwise": bool(torch.equal(last["one_shot"], last["chunked"])),
        "states_bitwise": all(
            torch.equal(a[k], b[k]) for a, b in zip(states["one_shot"],
                                                    states["chunked"])
            for k in ("conv", "ssm")),
        "max_abs_logit_diff": float(
            (last["one_shot"] - last["chunked"]).abs().max())}
    want_pf, want = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    gates = {}
    for (n, q), got_q in got_pf.items():
        plan = plans[q]
        label = f"{n} tokens, {plan.pages}p/chunk{q}"
        gate = _gate(got_q[..., :V], want_pf[(n, q)][..., :V],
                     f"e2e_ssm prefill {label}")
        if gate["greedy_agreement"] != 1.0:
            raise AssertionError(f"e2e_ssm prefill {label}: {gate}")
        gates[label] = gate
    return {"arch": cfg.name, "layers": cfg.num_layers, "prompt_lens": [P, 512],
            "prefill": gates,
            "decode": _gate(got[..., :V], want[..., :V], "e2e_ssm decode"),
            "positions": int(got.shape[1]), "launches": launches,
            "chunked_vs_one_shot_on_card": chunked}


def _agreement(got, want):
    """Max |difference|, min cosine and greedy agreement of logits."""
    import torch
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "min_cosine": float(torch.nn.functional.cosine_similarity(
                got, want, dim=-1).min()),
            "greedy_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())}


def _relative_gate(got, want, control, label: str):
    """bf16 agreement of ``got`` with ``want`` held relative to a
    control's (``control``: :func:`_agreement` of a run that sums in
    another order at the same plan): 1 - cosine within
    :data:`SSM_BF16_SPREAD` times the control's, or
    :data:`SSM_BF16_FLOOR` where the control agrees closer, and the
    control's cosine at least :data:`SSM_BF16_COSINE`."""
    gate = _agreement(got, want)
    limit = max(SSM_BF16_SPREAD * (1.0 - control["min_cosine"]),
                SSM_BF16_FLOOR)
    gate["limit_one_minus_cosine"] = limit
    if (control["min_cosine"] < SSM_BF16_COSINE
            or 1.0 - gate["min_cosine"] > limit):
        raise AssertionError(f"{label}: {gate}, control {control}")
    return gate


def _plain_ssd_chunk(fn):
    """``fn()`` with ssd_chunk's plain version in place of the kernel (a
    control run: it launches no ssd_chunk)."""
    from repro_torch.kernels import ssd_scan as kssd
    kernel = kssd.ssd_chunk
    kssd.ssd_chunk = _ssd_plain
    try:
        return fn()
    finally:
        kssd.ssd_chunk = kernel


def prefill_ssm_main_path(cfg, dev, counters):
    """Slice 4's prefill path: ``make_prefill`` of full-width, full-depth
    mamba2 (bf16), 2 prompts of 1024 tokens from numpy, random weights
    from one seed, under the :func:`_ssm_plans` (SSD chunks 256, 128,
    64).  ``counters`` receives the launch counts of one pass of the
    three (zeroed just before, read just after).  Gates: finite logits;
    SSD is exact under any chunking, held on an fp32 copy of the same
    weights: the 128- and 64-chunk logits within :func:`_gate` of the
    256-chunk ones, greedy tokens equal.  In bf16 the three plans'
    agreement is held against a control: the 256-chunk plan with the
    plain version in place of the kernel, which sums in another order
    at the same chunk.  Over 48 random bf16 layers such differences grow
    to the size of the chunk-to-chunk ones, so the bar is relative: each
    plan's 1 - cosine within :data:`SSM_BF16_SPREAD` times the
    control's (at least :data:`SSM_BF16_FLOOR`), and the control's
    cosine at least
    :data:`SSM_BF16_COSINE`.  Then each plan is timed warm on the host
    clock, and the 256-chunk plan profiled once."""
    import torch
    from repro_torch.models import model as M
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    B, S = SSM_PREFILL["batch"], SSM_PREFILL["prompt_len"]
    V = cfg.vocab_size
    params = M.init_params(cfg, seed=2, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (B, S))).long().to(dev)
    plans = _ssm_plans(cfg)

    def call(plan, c=cfg, p=params):
        out = M.make_prefill(c)(p, {"tokens": toks}, plan)
        torch.cuda.synchronize()
        return out[:, :V].float()

    _zero_counters()
    logits, first_s = {}, {}
    for q, plan in plans.items():
        t0 = time.perf_counter()
        logits[q] = call(plan)
        first_s[q] = time.perf_counter() - t0
    counters.update(_counters())
    if counters["ssd_chunk"] <= 0:
        raise AssertionError(f"prefill_ssm: ssd_chunk never launched: "
                             f"{counters}")
    _gate_kinds(counters, "prefill_ssm", ssd=("wgmma",))
    bad = [q for q, lg in logits.items() if not bool(torch.isfinite(lg).all())]
    if bad:
        raise AssertionError(f"prefill_ssm: non-finite logits at chunks {bad}")
    want = logits[256]
    control = _agreement(_plain_ssd_chunk(lambda: call(plans[256])), want)
    gates = {"bf16": {f"chunk{q}_vs_256": _relative_gate(
        logits[q], want, control, f"prefill_ssm bf16 chunk {q}")
        for q in (128, 64)}}
    gates["bf16"]["control_plain_vs_kernel_chunk256"] = control
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _to_dtype(params, torch.float32)
    l32 = {q: call(plan, c32, p32) for q, plan in plans.items()}
    del p32
    for q in (128, 64):
        gates[f"fp32_chunk{q}_vs_256"] = {
            **_gate(l32[q], l32[256], f"prefill_ssm fp32 chunk {q} vs 256"),
            "min_cosine": _agreement(l32[q], l32[256])["min_cosine"]}
        if gates[f"fp32_chunk{q}_vs_256"]["greedy_agreement"] != 1.0:
            raise AssertionError(f"prefill_ssm fp32 chunk {q}: {gates}")
    runs = {}
    for q, plan in plans.items():
        t0 = time.perf_counter()
        call(plan)
        wall = time.perf_counter() - t0
        runs[f"chunk{q}"] = {"plan": plan.describe(), "pages": plan.pages,
                             "first_wall_s": first_s[q], "wall_s": wall,
                             "tokens_per_s": B * S / wall}
    peak = torch.cuda.max_memory_allocated()
    profile = _profile(lambda: call(plans[256]))
    profile["ssd_chunk_share"] = _kernel_share(profile, "ssd_chunk")
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "prompt_len": S, "launches": dict(counters), "gates": gates,
            "runs": runs, "allocated_at_start_bytes": base,
            "peak_memory_bytes": peak, "profile": profile}


def _profile_ssm_prefill_chunk(cfg, params, dev, tokens: int = 256):
    """:func:`_profile` of one serving prefill chunk of ``tokens`` prompt
    tokens (batch of :data:`SERVE_SSM`) from a zero state."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches
    B = SERVE_SSM["batch"]
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, tokens))).long().to(dev)
    chunk = M.make_prefill_chunk(cfg)

    def run():
        chunk(params, init_caches(params, cfg, B, tokens, device=dev), prompt,
              0)
        torch.cuda.synchronize()

    out = {"tokens": tokens, **_profile(run)}
    out["ssd_chunk_share"] = _kernel_share(out, "ssd_chunk")
    return out


def serve_ssm_main_path(cfg, dev, counters):
    """Slice 4's serving path: ``MultiTenantServer(["mamba2-370m"],
    reduced=False)``, full depth, in the :data:`SERVE_SSM` pool: a
    resident decoding for every step, and two prompt tenants arriving at
    steps 4 and 8.  Their state reservations (``_kv_reserve_pages``) must
    fit the pool together and be held whole; the free pages the server
    saw at each admission are reported.  ``counters`` receives the
    kernels' launch counts of the run (zeroed just before, read just
    after); ssd_chunk must have launched.  Then one decode epoch of the
    resident and one 256-token prefill chunk are profiled."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    B, steps, budget = SERVE_SSM["batch"], SERVE_SSM["steps"], SERVE_SSM["budget"]
    pool = SERVE_SSM["pages"]
    quotes = [_kv_reserve_pages(cfg, B, p) for _, p in SERVE_SSM["arrivals"]]
    if sum(quotes) > pool:
        raise AssertionError(f"serve_ssm: reservations {quotes} exceed the "
                             f"{pool}-page pool")
    specs = [TenantSpec(cfg.name, arrive_at=at, prompt_len=p,
                        n_inferences=budget)
             for at, p in SERVE_SSM["arrivals"]]
    srv = MultiTenantServer([cfg.name], tenants=specs, batch=B,
                            max_len=SERVE_SSM["max_len"], total_pages=pool,
                            epoch_len=4, device=dev, reduced=False)
    seen_free = []
    choose = srv._choose_kv_dtype

    def spy_choose(c, spec):
        seen_free.append(srv.cache.free_pages)
        return choose(c, spec)

    srv._choose_kv_dtype = spy_choose
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    if counters["ssd_chunk"] <= 0:
        raise AssertionError(f"serve_ssm: ssd_chunk never launched: {counters}")
    _gate_kinds(counters, "serve_ssm", ssd=("wgmma",))
    resident = srv.tenants[0]
    vocab, tenants = cfg.vocab_size, {}
    for t, quote in zip(srv.tenants, [0] + quotes):
        res = out["tenants"][t.tid]
        o = res["output"]
        want_len = steps if t.prompt_len == 0 else 1 + budget
        problems = []
        if o.shape != (B, want_len) or o.min() < 0 or o.max() >= vocab:
            problems.append(f"output {o.shape} range [{o.min()}, {o.max()}]")
        if t.kv_dtype != "native":
            problems.append(f"kv_dtype {t.kv_dtype}")
        if not t.kv_wanted == t.kv_reserved == quote:
            problems.append(f"reservation {t.kv_reserved} of {t.kv_wanted}, "
                            f"quote {quote}")
        if problems:
            raise AssertionError(f"serve_ssm {t.tid}: {problems}")
        tenants[t.tid] = {
            "prompt_len": t.prompt_len, "tokens": res["tokens"],
            "ttft_s": res["ttft_s"], "kv_wanted": res["kv_wanted"],
            "kv_reserved": res["kv_reserved"],
            "prefill_chunks": res["prefill_chunks"],
            "plans": dict(Counter(f"{p.describe()}/chunk{p.ssm_chunk}"
                                  for p in t.plans)),
            "first_tokens": o[0, :8].tolist()}
    res = {"arch": cfg.name, "layers": cfg.num_layers, "total_pages": pool,
           "quotes": quotes, "free_at_admission": seen_free, "batch": B,
           "max_len": SERVE_SSM["max_len"], "steps": steps,
           "plan_kinds": sorted({p.kind for t in srv.tenants
                                 for p in t.plans}),
           "launches": dict(counters), "tokens_served": out["tokens_served"],
           "wall_s": out["wall_s"], "tokens_per_s": out["tokens_per_s"],
           "dram_total": out["dram_bytes"], "host": out["host"],
           "tenants": tenants, "allocated_at_start_bytes": base,
           "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, steps)
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    params = resident.params
    res["profile"] = {"decode_epoch": _profile_replay(srv, resident),
                      "prefill_chunk": _profile_ssm_prefill_chunk(cfg, params,
                                                                  dev)}
    return res


def check_serial_pipelined_ssm(cfg, dev, counters):
    """Serial (per-step) and pipelined (epoch) serving on the card, in
    the pool of the arch's spec (:data:`SELF_SSM`: full-width,
    full-depth mamba2 in the serve_ssm pool; :data:`SELF_HYBRID`:
    zamba2 cut to one group; :data:`SELF_ENCDEC`: full-depth whisper
    granted LBM): two residents and a prompt tenant
    arriving mid-run at the spec's KV precision, whose prompt chunks run
    ssd_chunk (mamba2's O(1) decode steps are plain torch, as in the
    reference; zamba2's shared block runs cache_matmul's ``matmul``
    kinds; whisper's prompt chunks run plain and its decode the spec's
    ``kernels`` and ``kinds``, its residents one bucket where the spec
    says ``bucket``).  Bitwise-equal token streams, equal choice traces
    and prefill chunks.  A quantized arrival's first-token stamp must
    have read its cache scales.  ``counters`` receives the launch counts
    of the two runs (zeroed just before, read just after); the spec's
    kernels (ssd_chunk by default) must have launched."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    label = f"self_{cfg.family}"
    s = {"pages": SERVE_SSM["pages"], "kv_dtype": "native", "matmul": (),
         "kernels": ("ssd_chunk",), "kinds": dict(ssd=("wgmma",)),
         "bucket": False,
         **{"ssm": SELF_SSM, "hybrid": SELF_HYBRID,
            "encdec": SELF_ENCDEC}[cfg.family]}
    at, prompt_len = s["arrival"]
    arrival = TenantSpec(cfg.name, arrive_at=at, prompt_len=prompt_len,
                         n_inferences=s["budget"])
    outs, scaled = [], []
    _zero_counters()
    for pipeline in (False, True):
        srv = MultiTenantServer([cfg.name, cfg.name], tenants=[arrival],
                                batch=s["batch"], max_len=s["max_len"],
                                total_pages=s["pages"], epoch_len=4,
                                pipeline=pipeline, device=dev, reduced=False,
                                kv_dtype=s["kv_dtype"])
        scale_rows = srv._scale_rows

        def spy(t, scale_rows=scale_rows):
            rows = scale_rows(t)
            scaled.append(rows is not None)
            return rows

        srv._scale_rows = spy
        outs.append((srv.run(steps=s["steps"]),
                     {t.tid: list(t.chunks) for t in srv.tenants},
                     {t.tid: t.kv_dtype for t in srv.tenants}))
        buckets = sum(key[0] == "bucket" for key in srv._fused_jits.keys())
        del srv
    counters.update(_counters())
    for kernel in s["kernels"]:
        if counters[kernel] <= 0:
            raise AssertionError(f"{label}: {kernel} never launched: "
                                 f"{counters}")
    _gate_kinds(counters, label, s["matmul"], **s["kinds"])
    if s["bucket"] and not buckets:
        raise AssertionError(f"{label}: the residents never ran as a bucket")
    (serial, serial_chunks, kv), (piped, piped_chunks, _) = outs
    if s["kv_dtype"] != "native" and not (any(scaled) and s["kv_dtype"]
                                          in kv.values()):
        raise AssertionError(f"{label}: no {s['kv_dtype']} tenant's scales "
                             f"were read: {kv}")
    if serial_chunks != piped_chunks:
        raise AssertionError(f"{label}: prefill chunks differ: "
                             f"{serial_chunks} vs {piped_chunks}")
    for tid, o in serial["tenants"].items():
        p = piped["tenants"][tid]
        if not np.array_equal(o["output"], p["output"]):
            raise AssertionError(f"{label} {tid}: serial and pipelined "
                                 "tokens differ")
        if o["choices"] != p["choices"]:
            raise AssertionError(f"{label} {tid}: choices differ")
    return {"arch": cfg.name, "layers": cfg.num_layers, **s,
            "bucket_programs": buckets,
            "bit_identical": True, "launches": dict(counters),
            "prefill_chunks": piped_chunks, "kv_dtypes": kv,
            "tokens": {tid: v["tokens"] for tid, v in piped["tenants"].items()},
            "first_tokens": {tid: v["output"][0, :8].tolist()
                             for tid, v in piped["tenants"].items()}}


# ---------------------------------------------------------------- moe --
def moe_prefill_plans(cfg, seq_block=None):
    """The MoE prefill settings, lowered at the experts' d_ff: plain, the
    smallest LBM grant that lowers fused at ``seq_block`` (default: the
    prefill's prompt length), and 32-page LWM grants with native and
    int8 KV."""
    from repro_torch.core.vmem import fused_ffn_pages
    s = seq_block or PREFILL["prompt_len"]
    lwm = PREFILL["lwm_pages"]
    lbm = fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2)
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM", lbm, s),
            "LWM/native": _plan(cfg, "LWM", lwm, s),
            "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8")}


def check_e2e_moe(cfg, dev):
    """olmoe-1b-7b at full width cut to 4 layers, random weights from one
    seed: ``make_prefill`` of a 40-token prompt (16 bucket rows an
    expert) under an LBM plan, an LWM native plan and an LWM int8 plan,
    each expert's FFN through the plan's kernels, then a prefill and a
    teacher-forced decode epoch (the gathered-expert path), on the card
    against the same entry points on the CPU with the plain versions and
    the same weights.  Gate: :func:`_gate`; every bf16 kernel launch of
    the wgmma kind."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    e = MOE_E2E
    cfg = dataclasses.replace(cfg, num_layers=e["layers"])
    plans = {k: v for k, v in moe_prefill_plans(cfg, LANE).items()
             if v is not None}
    rng = np.random.default_rng(4)
    long_prompt = rng.integers(0, cfg.vocab_size, (e["batch"], e["prompt_len"]))
    prompt = rng.integers(0, cfg.vocab_size, (e["batch"], 8))
    forced = rng.integers(0, cfg.vocab_size, (e["batch"], 9))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        toks = torch.from_numpy(long_prompt).long().to(device)
        pf = {name: prefill(params, {"tokens": toks}, p).float().cpu()
              for name, p in plans.items()}
        return pf, _e2e_run(cfg, params, device, prompt, forced,
                            [plans["LWM/native"]])

    params = M.init_params(cfg, seed=3, device=dev)
    _zero_counters()
    got_pf, got_dec = run(params, dev)
    launches = _counters()
    want_pf, want_dec = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    if min(launches[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"e2e_moe: a kernel never launched: {launches}")
    _gate_kinds(launches, "e2e_moe", ("wgmma",), ("wgmma",), ("wgmma",),
                flash_quantized=("wgmma",))
    return {"layers": e["layers"], "prompt_len": e["prompt_len"],
            "plans": {n: p.describe() for n, p in plans.items()},
            "prefill": {n: _gate(got_pf[n][..., :V], want_pf[n][..., :V],
                                 f"e2e_moe prefill {n}") for n in plans},
            "decode": _gate(got_dec[..., :V], want_dec[..., :V],
                            "e2e_moe decode"),
            "launches": launches}


def check_serial_pipelined_moe(cfg, dev):
    """Serial (eager, per step) and pipelined (graphs) serving of two
    resident olmoe-1b-7b tenants at full width cut to 4 layers: token
    streams bitwise equal; the pipelined run decodes them as one
    bucket."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    m = SELF_MOE
    cut = register(dataclasses.replace(cfg, name=f"{cfg.name}-"
                                       f"{m['layers']}layer-self",
                                       num_layers=m["layers"]))
    outs, buckets = [], 0
    for pipeline in (False, True):
        srv = MultiTenantServer([cut.name, cut.name], batch=m["batch"],
                                max_len=m["max_len"], total_pages=m["pages"],
                                epoch_len=4, pipeline=pipeline, device=dev,
                                reduced=False)
        outs.append(srv.run(steps=m["steps"]))
        if pipeline:
            buckets = sum(1 for key in srv._fused_jits.keys()
                          if key[0] == "bucket")
        del srv
        _release()
    serial, piped = outs
    for tid, s_ in serial["tenants"].items():
        if not np.array_equal(s_["output"], piped["tenants"][tid]["output"]):
            raise AssertionError(f"self_moe {tid}: serial and pipelined "
                                 "tokens differ")
    if not buckets:
        raise AssertionError("self_moe: the residents never ran as a bucket")
    return {"arch": cfg.name, **m, "bucket_programs": buckets,
            "bit_identical": True,
            "tokens": {tid: v["tokens"] for tid, v in piped["tenants"].items()},
            "first_tokens": {tid: v["output"][0, :8].tolist()
                             for tid, v in piped["tenants"].items()}}


def serve_mix_main_path(dev, counters):
    """The reference CLI's default pool through the port's CLI, in this
    process: ``repro_torch.launch.serve.main`` with ``--full-width
    --archs yi-9b olmoe-1b-7b mamba2-370m --arrivals 2 --prompt-len
    256`` and a pool that holds each arch's native reservation of one
    prompt beside :data:`SERVE_MIX`'s headroom.  Its printed lines are
    kept.  ``counters`` receives the launch counts of the run (zeroed
    just before, read just after): yi-9b's decode runs cache_matmul's
    gemv tile and the mamba2 arrival's prompt chunks ssd_chunk."""
    import contextlib
    import io
    from repro_torch.launch import serve as S
    from repro_torch.models.base import get_arch
    m = SERVE_MIX
    pages = m["headroom"] + sum(
        S._kv_reserve_pages(get_arch(a), 2, m["prompt_len"])
        for a in m["archs"])
    argv = ["--full-width", "--device", dev, "--archs", *m["archs"],
            "--arrivals", str(m["arrivals"]), "--prompt-len",
            str(m["prompt_len"]), "--pages", str(pages)]
    buf = io.StringIO()
    _zero_counters()
    with contextlib.redirect_stdout(buf):
        out = S.main(argv)
    counters.update(_counters())
    if counters["cache_matmul"] <= 0 or counters["ssd_chunk"] <= 0:
        raise AssertionError(f"serve_mix: a kernel never launched: {counters}")
    _gate_kinds(counters, "serve_mix", ("gemv",), ssd=("wgmma",))
    tenants = {}
    for tid, res in out["tenants"].items():
        problems = []
        if res["tokens"] <= 0:
            problems.append("no tokens")
        if res["prompt_len"] and (res["ttft_s"] is None or res["kv_reserved"]
                                  != res["kv_wanted"]):
            problems.append(f"ttft {res['ttft_s']} reservation "
                            f"{res['kv_reserved']} of {res['kv_wanted']}")
        if problems:
            raise AssertionError(f"serve_mix {tid}: {problems}")
        tenants[tid] = {k: res[k] for k in (
            "tokens", "ttft_s", "prompt_len", "prefill_chunks", "kv_wanted",
            "kv_reserved", "lbm_frac", "choices", "plans")}
    return {"argv": argv, "pages": pages, "lines": buf.getvalue().splitlines(),
            "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
            "tokens_per_s": out["tokens_per_s"],
            "p95_ttft_s": out["p95_ttft_s"], "launches": dict(counters),
            "host": {k: out["host"][k] for k in (
                "epochs", "sched_wall_s", "dispatch_wall_s", "captures",
                "capture_s", "epoch_compiles")},
            "tenants": tenants}


# ----------------------------------------------------- serve features --
def _params_memo(dev, group=None):
    """A ``params_fn`` that makes each (config, param seed) weight set
    once, so tenants that share a seed share one set (a full-width yi-9b
    set is 17.6 GB); with ``group`` (a ``(1, tp)`` mesh) the set is kept
    only as placed on that group (``shard_params``), which the servers of
    a group of the same devices take as it is.  ``params_fn.memo.clear()``
    lets them go."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import model as M
    memo = {}

    def params_fn(c, pkey):
        if (c.name, pkey) not in memo:
            params = M.init_params(c, pkey, dev)
            memo[(c.name, pkey)] = (params if group is None
                                    else tp.shard_params(params, group))
            # the init's fp32 draws leave cached blocks of their sizes
            # (22.5 GB a kimi-k2 expert tensor) that nothing later reuses
            torch.cuda.empty_cache()
        return memo[(c.name, pkey)]
    params_fn.memo = memo
    return params_fn


def _run_counted(srv, steps: int, counters):
    """One ``run()`` of a server of the main path: the kernels' counters
    zeroed just before it and read just after, added to ``counters``.
    Returns (result, this run's counts)."""
    _zero_counters()
    out = srv.run(steps=steps)
    counts = _counters()
    for k, v in counts.items():
        counters[k] = counters.get(k, 0) + v
    return out, counts


def _launched(counts, label: str, kernel: str, matmul=()):
    """``kernel`` launched in the run; with ``matmul`` cache_matmul's
    launches of those kinds only (:func:`_gate_kinds`)."""
    if counts[kernel] <= 0:
        raise AssertionError(f"{label}: {kernel} never launched: {counts}")
    if matmul:
        _gate_kinds(counts, label, matmul)


def _kind_counts(counts):
    return {k: v for k, v in counts.items() if "." in k and v}


def _differing_outputs(a, b):
    """Tenants whose token streams differ between two results."""
    return [tid for tid in a["tenants"]
            if not np.array_equal(a["tenants"][tid]["output"],
                                  b["tenants"][tid]["output"])]


def _wall_free(log):
    return [{k: v for k, v in rec.items() if k not in ("recovery_s",
                                                        "waited_s")}
            for rec in log]


def serve_prefix_main_path(dev, counters):
    """The reference's ``prefix`` workload (:data:`SERVE_PREFIX`) through
    the port's server at full width and depth: three chat sessions on
    two system prompts, two turns each, served with prefix dedup on and
    off at a prefill chunk of 128, on one weight memo.  Gates: at least
    two warm arrivals, fewer prompt tokens computed with dedup, each
    warm arrival's chunks covering exactly its private suffix, the token
    streams on and off bitwise, yi-9b's decode through the gemv tile.
    Then the full-prompt re-arrival on olmoe and mamba2: no chunk,
    nothing computed, the producer's stream bit for bit."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.models.base import get_arch
    from repro_torch.sim.driver import SessionArrivals
    sp = SERVE_PREFIX
    arch = sp["arch"]

    def specs():
        return SessionArrivals(models=[arch], **sp["sessions"]).specs()
    pages = sp["headroom"] + sum(
        _kv_reserve_pages(get_arch(arch), sp["batch"], s.prompt_len)
        for s in specs())
    params_fn = _params_memo(dev)
    runs, outs = {}, {}
    chunk = sp["chunk"]
    for on in (True, False):
        label = f"serve_prefix dedup {'on' if on else 'off'}"
        torch.cuda.reset_peak_memory_stats()
        srv = MultiTenantServer(
            [], tenants=specs(), prefix_dedup=on, prefill_chunk=chunk,
            batch=sp["batch"], max_len=sp["max_len"], total_pages=pages,
            epoch_len=sp["epoch_len"], steps_per_s=sp["steps_per_s"],
            device=dev, reduced=False, params_fn=params_fn)
        out, counts = _run_counted(srv, sp["steps"], counters)
        _launched(counts, label, "cache_matmul", ("gemv",))
        outs[on] = out
        ten = out["tenants"]
        warm = [tid for tid, i in ten.items() if i["prefix_hit"] > 0]
        runs["on" if on else "off"] = {
            "tenants": {tid: {k: i[k] for k in (
                "prompt_len", "prefix_hit", "prefill_chunks",
                "prefill_computed", "ttft_s", "tokens", "kv_reserved",
                "kv_wanted")} for tid, i in ten.items()},
            "warm": warm,
            "warm_ttft_s": [ten[t]["ttft_s"] for t in warm],
            "cold_ttft_s": [i["ttft_s"] for t, i in ten.items()
                            if t not in warm],
            "prefill_computed": out["prefill_computed"],
            "prefill_tokens": out["prefill_tokens"],
            "prefix": out["prefix"],
            "snapshot_bytes": out["host"]["snapshot_bytes"],
            "tokens_per_s": out["tokens_per_s"], "wall_s": out["wall_s"],
            "tokens_served": out["tokens_served"],
            "captures": out["host"]["captures"],
            "capture_s": out["host"]["capture_s"],
            "launches": _kind_counts(counts),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del srv
        _release()
    a, b = outs[True], outs[False]
    warm = runs["on"]["warm"]
    problems = []
    if len(warm) < 2:
        problems.append(f"{len(warm)} warm arrivals")
    if not a["prefill_computed"] < b["prefill_computed"]:
        problems.append(f"computed {a['prefill_computed']} on, "
                        f"{b['prefill_computed']} off")
    for tid in warm:
        info = a["tenants"][tid]
        if sum(info["prefill_chunks"]) != (info["prompt_len"]
                                           - info["prefix_hit"]):
            problems.append(f"{tid} chunks {info['prefill_chunks']}")
    differ = _differing_outputs(a, b)
    if differ:
        problems.append(f"on != off for {differ}")
    if problems:
        raise AssertionError(f"serve_prefix: {problems}")
    params_fn.memo.clear()
    _release()
    rr = {"batch": sp["batch"], "epoch_len": sp["epoch_len"],
          "steps": sp["steps"], **sp["rearrival"]}
    rearrivals = {}
    for rarch in rr["archs"]:
        label = f"serve_prefix rearrival {rarch}"
        rearrivals[rarch], counts = _rearrival(
            get_arch(rarch), rr, sp["headroom"], dev, counters, params_fn,
            label)
        if rarch == SSM_ARCH:
            _launched(counts, label, "ssd_chunk")
        params_fn.memo.clear()
        _release()
    return {"arch": arch, "pages": pages, "runs": runs,
            "rearrival": rearrivals, "launches": dict(counters)}


def _rearrival(cfg, rr, headroom: int, dev, counters, params_fn, label: str):
    """A full-prompt re-arrival (the reference's
    test_full_prompt_rearrival_skips_prefill) at full width: two session
    tenants of ``cfg`` with one weight set and one prompt of
    ``rr["prompt_len"]`` tokens, arriving at ``rr["at"]`` with prefix
    dedup on, in a pool of both native reservations and ``headroom``
    pages.  The second must hit the first's full-length entry: no chunk,
    nothing computed, and the producer's (cold) stream bit for bit.
    Returns (its record, the run's counts)."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.sim.driver import TenantSpec
    quote = _kv_reserve_pages(cfg, rr["batch"], rr["prompt_len"])
    tenants = [TenantSpec(cfg.name, arrive_at=at,
                          n_inferences=rr["n_inferences"],
                          prompt_len=rr["prompt_len"], param_seed=5,
                          prompt_seed=7, prefix_len=rr["prompt_len"],
                          prefix_seed=3) for at in rr["at"]]
    torch.cuda.reset_peak_memory_stats()
    srv = MultiTenantServer(
        [], tenants=tenants, prefix_dedup=True, batch=rr["batch"],
        max_len=rr["max_len"], total_pages=2 * quote + headroom,
        epoch_len=rr["epoch_len"], steps_per_s=rr["steps_per_s"],
        device=dev, reduced=False, params_fn=params_fn)
    out, counts = _run_counted(srv, rr["steps"], counters)
    prod, warm = (out["tenants"][f"t{i}:{cfg.name}"] for i in (0, 1))
    problems = []
    if (warm["prefix_hit"] != rr["prompt_len"] or warm["prefill_chunks"]
            or warm["prefill_computed"] != 0
            or warm["tokens"] != rr["batch"] * (1 + rr["n_inferences"])):
        problems.append({k: warm[k] for k in (
            "prefix_hit", "prefill_chunks", "prefill_computed", "tokens")})
    if not np.array_equal(prod["output"], warm["output"]):
        problems.append("output differs from the producer's")
    if problems:
        raise AssertionError(f"{label}: {problems}")
    rec = {"pages": 2 * quote + headroom, "quote": quote,
           "prompt_len": rr["prompt_len"], "batch": rr["batch"],
           "producer": {k: prod[k] for k in ("prefill_chunks", "ttft_s",
                                             "tokens")},
           "warm": {k: warm[k] for k in ("prefix_hit", "prefill_chunks",
                                         "prefill_computed", "ttft_s",
                                         "tokens")},
           "snapshot_bytes": out["host"]["snapshot_bytes"],
           "prefix": out["prefix"], "launches": _kind_counts(counts),
           "first_tokens": warm["output"][0, :8].tolist(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del srv
    return rec, counts


def serve_faults_main_path(dev, counters):
    """Preemption and faults at full width and depth (:data:`SERVE_FAULTS`):
    (a) preempt / resume through a snapshot checkpoint on yi-9b with
    native and int8 KV and on mamba2, each against an unfaulted run of
    the same server, bitwise; (b) the prefix re-seed path on yi-9b
    against its control, bitwise; (c) the reference's overload burst on
    mamba2 (no exception, the queue drained, deferrals and sheds, every
    served tenant decoded); (d) the reference's faulted schedule
    (pressure, straggler, preempt) on mamba2 twice: equal fault logs
    (wall times out), tokens bitwise, the pool's free pages restored.
    Checkpoints go to ``build/chip_smoke/ckpt``."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.models.base import get_arch
    from repro_torch.sim.driver import TenantSpec
    from repro_torch.sim.faults import FaultEvent, FaultPlan
    sf = SERVE_FAULTS
    params_fn = _params_memo(dev)
    ckpt_root = OUT_DIR / "ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    dense, ssm = sf["dense"], sf["ssm"]

    def pool(arch, quotes=sf["pool_quotes"], prompt=sf["prompt_len"]):
        return quotes * _kv_reserve_pages(get_arch(arch), sf["batch"], prompt)

    def server(arch, pages, **kw):
        return MultiTenantServer(
            [], batch=sf["batch"], max_len=sf["max_len"],
            epoch_len=sf["epoch_len"], total_pages=pages, device=dev,
            reduced=False, params_fn=params_fn,
            ckpt_dir=str(ckpt_root / arch), **kw)

    def gate_kernels(counts, label, arch):
        if arch == ssm:
            _launched(counts, label, "ssd_chunk")
        else:
            _launched(counts, label, "cache_matmul", ("gemv",))

    # (a) preempt -> resume through a checkpoint
    preempt = {}
    for arch, kv in sf["cases"]:
        label = f"serve_faults preempt {arch}/{kv}"
        outs = {}
        for faulted in (False, True):
            plan = (FaultPlan([FaultEvent(kind="preempt", **sf["preempt"])])
                    if faulted else None)
            srv = server(arch, pool(arch), kv_dtype=kv, faults=plan)
            srv.enqueue([TenantSpec(arch, prompt_len=sf["prompt_len"],
                                    n_inferences=sf["n_inferences"])])
            out, counts = _run_counted(srv, sf["steps"], counters)
            gate_kernels(counts, label, arch)
            outs[faulted] = (out, counts, [p.describe()
                                           for p in srv.tenants[0].plans])
            del srv
        (ref, ref_counts, ref_plans), (out, counts, plans) = (outs[False],
                                                              outs[True])
        (tid, info), = out["tenants"].items()
        log = out["faults"]["log"]
        problems = []
        if [r["kind"] for r in log] != ["preempt", "resume"] or \
                log[0]["mode"] != "snapshot":
            problems.append(f"log {log}")
        if info["preemptions"] != 1 or info["kv_dtype"] != (
                kv if arch == dense else "native"):
            problems.append({k: info[k] for k in ("preemptions", "kv_dtype")})
        if _differing_outputs(ref, out):
            problems.append("resumed stream differs from the unfaulted one")
        if problems:
            raise AssertionError(f"{label}: {problems}")
        preempt[f"{arch}/{kv}"] = {
            "pages": pool(arch), "log": _wall_free(log),
            "recovery_s": out["faults"]["recovery_s"],
            "checkpoint_bytes": out["faults"]["checkpoint_bytes"],
            "preempt_evictions": out["host"]["preempt_evictions"],
            "captures": [ref["host"]["captures"], out["host"]["captures"]],
            "plans_equal": plans == ref_plans,
            "plans": dict(Counter(plans)),
            "launches": [_kind_counts(ref_counts), _kind_counts(counts)],
            "tokens_per_s": [ref["tokens_per_s"], out["tokens_per_s"]],
            "wall_s": [ref["wall_s"], out["wall_s"]],
            "first_tokens": info["output"][0, :8].tolist()}
    _release()

    # (b) the prefix re-seed path
    rs = sf["reseed"]
    label = "serve_faults reseed"
    base = TenantSpec(dense, prompt_len=rs["prompt_len"],
                      n_inferences=rs["n_inferences"], param_seed=0,
                      prompt_seed=1)
    follow = dataclasses.replace(base, n_inferences=rs["follow"])
    outs = []
    for preempted in (False, True):
        srv = server(dense, pool(dense), prefix_dedup=True)
        srv.enqueue([dataclasses.replace(base)])
        srv.run(steps=rs["warm_steps"])   # registers the full prompt
        t = srv._admit_spec(dataclasses.replace(follow))
        if t.prefix_hit != rs["prompt_len"]:
            raise AssertionError(f"{label}: hit {t.prefix_hit}")
        if preempted:
            if not srv.preempt_tenant(t, resume_after_epochs=1):
                raise AssertionError(f"{label}: not preempted")
            mode = srv.fault_log.of_kind("preempt")[0]["mode"]
            if mode != "prefix" or t.fed or t.caches is not None:
                raise AssertionError(f"{label}: mode {mode}")
        out, counts = _run_counted(srv, rs["steps"], counters)
        gate_kernels(counts, label, dense)
        outs.append((t, out, counts))
        del srv
    (t0, r_ctrl, c_ctrl), (t1, r, c) = outs
    a, b = r_ctrl["tenants"][t0.tid]["output"], r["tenants"][t1.tid]["output"]
    if t1.preemptions != 1 or not t1.recovery_s or a.shape != b.shape \
            or not np.array_equal(a, b):
        raise AssertionError(f"{label}: preemptions {t1.preemptions}, "
                             f"outputs {a.shape} {b.shape} differ")
    reseed = {"log": _wall_free(r["faults"]["log"]),
              "recovery_s": r["faults"]["recovery_s"],
              "checkpoint_bytes": r["faults"]["checkpoint_bytes"],
              "snapshot_bytes": r["host"]["snapshot_bytes"],
              "launches": [_kind_counts(c_ctrl), _kind_counts(c)],
              "first_tokens": b[0, :8].tolist()}
    params_fn.memo.clear()
    _release()

    # (c) the overload burst
    bu = sf["burst"]
    label = "serve_faults burst"
    quote = _kv_reserve_pages(get_arch(ssm), sf["batch"], bu["prompt_len"])
    pages = bu["burst_quotes"] * quote
    srv = server(ssm, pages, queue_limit=bu["queue_limit"],
                 queue_deadline_s=bu["queue_deadline_s"])
    srv.enqueue([TenantSpec(ssm, prompt_len=bu["prompt_len"],
                            n_inferences=bu["n_inferences"],
                            arrive_at=bu["arrive_at"],
                            qos_ms=(None if i % 3 == 0 else 50.0 * (i + 1)))
                 for i in range(bu["n"])])
    out, counts = _run_counted(srv, bu["steps"], counters)
    gate_kernels(counts, label, ssm)
    ov = out["overload"]
    if (ov["queued"] != 0 or ov["deferrals"] <= 0 or ov["shed_count"] <= 0
            or not out["tenants"]
            or any(i["tokens"] <= 0 for i in out["tenants"].values())):
        raise AssertionError(f"{label}: {ov}, tokens "
                             f"{[i['tokens'] for i in out['tenants'].values()]}")
    burst = {"pages": pages, "quote": quote, "deferrals": ov["deferrals"],
             "shed_count": ov["shed_count"],
             "shed": dict(Counter(s["reason"] for s in ov["shed"])),
             "served": len(out["tenants"]),
             "tokens": {tid: i["tokens"] for tid, i in out["tenants"].items()},
             "ttft_s": [i["ttft_s"] for i in out["tenants"].values()],
             "tokens_per_s": out["tokens_per_s"], "wall_s": out["wall_s"],
             "launches": _kind_counts(counts)}
    del srv
    params_fn.memo.clear()
    _release()

    # (d) the faulted schedule, twice
    sc = sf["schedule"]
    label = "serve_faults schedule"
    pages = pool(ssm)
    runs = []
    for _ in range(2):
        plan = FaultPlan([
            FaultEvent(step=sc["pressure_step"], kind="pool_pressure",
                       pages=3 * pages // 4),
            FaultEvent(step=sc["straggler_step"], kind="straggler",
                       hold_epochs=sc["straggler_hold"]),
            FaultEvent(step=sc["preempt_step"], kind="preempt",
                       hold_epochs=sc["preempt_hold"])])
        srv = server(ssm, pages, faults=plan)
        free0 = srv.cache.free_pages
        srv.enqueue([TenantSpec(ssm, prompt_len=sf["prompt_len"],
                                n_inferences=sf["n_inferences"], arrive_at=at)
                     for at in sc["arrivals"]])
        out, counts = _run_counted(srv, sc["steps"], counters)
        gate_kernels(counts, label, ssm)
        runs.append((out, srv.cache.free_pages, free0, counts))
        del srv
    (a, free_a, free0_a, ca), (b, free_b, free0_b, cb) = runs
    problems = []
    if _wall_free(a["faults"]["log"]) != _wall_free(b["faults"]["log"]):
        problems.append("fault logs differ")
    if _differing_outputs(a, b):
        problems.append(f"tokens differ: {_differing_outputs(a, b)}")
    if (free_a, free_b) != (free0_a, free0_b):
        problems.append(f"free pages {free0_a} -> {free_a}, "
                        f"{free0_b} -> {free_b}")
    if not {"pool_pressure", "straggler", "preempt", "resume"} <= {
            r["kind"] for r in a["faults"]["log"]}:
        problems.append(f"log {a['faults']['counts']}")
    if problems:
        raise AssertionError(f"{label}: {problems}")
    schedule = {"pages": pages, "pressure_pages": 3 * pages // 4,
                "log": _wall_free(a["faults"]["log"]),
                "counts": a["faults"]["counts"],
                "recovery_s": [a["faults"]["recovery_s"],
                               b["faults"]["recovery_s"]],
                "checkpoint_bytes": a["faults"]["checkpoint_bytes"],
                "free_pages": free_a,
                "launches": [_kind_counts(ca), _kind_counts(cb)]}
    params_fn.memo.clear()
    shutil.rmtree(ckpt_root, ignore_errors=True)
    _release()
    return {"preempt": preempt, "reseed": reseed, "burst": burst,
            "schedule": schedule, "launches": dict(counters)}


def lookahead_main_path(dev, counters):
    """The reference's contested scenario at full width (:data:`LOOKAHEAD`),
    served with and without grant lookahead on one weight memo.  Gates:
    the lookahead adjusts at least one grant, none without it, and the
    resident's grants differ between the runs; both runs launch the same
    kernels of the same kinds (yi-9b's decode through the gemv tile),
    and then their token streams are bitwise equal.  The adjusted grant
    is the olmoe resident's, whose decode launches no plan-dependent
    kernel, and the arrivals' plans do not change
    (tests/test_torch_lookahead.py), so on the card the token gate holds
    by construction."""
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.models.base import get_arch
    from repro_torch.sim.driver import TenantSpec
    la = LOOKAHEAD
    quote = _kv_reserve_pages(get_arch(la["arrival"]), la["batch"],
                              la["prompt_len"])
    pages = len(la["arrive_at"]) * quote + la["spare"]
    params_fn = _params_memo(dev)
    runs, outs, resident = {}, {}, {}
    for ahead in (True, False):
        label = f"lookahead {'on' if ahead else 'off'}"
        tenants = [TenantSpec(la["resident"], param_seed=0,
                              n_inferences=la["resident_steps"])] + [
            TenantSpec(la["arrival"], prompt_len=la["prompt_len"],
                       n_inferences=la["n_inferences"], arrive_at=at,
                       param_seed=0) for at in la["arrive_at"]]
        srv = MultiTenantServer(
            [], tenants=tenants, lookahead=ahead, batch=la["batch"],
            max_len=la["max_len"], total_pages=pages,
            epoch_len=la["epoch_len"], device=dev, reduced=False,
            params_fn=params_fn)
        out, counts = _run_counted(srv, la["steps"], counters)
        _launched(counts, label, "cache_matmul", ("gemv",))
        outs[ahead] = out
        resident[ahead] = list(srv.tenants[0].choices)
        runs["on" if ahead else "off"] = {
            "lookahead_adjusted": out["host"]["lookahead_adjusted"],
            "kinds": _kind_counts(counts),
            "choices": {t.tid: t.choices[-8:] for t in srv.tenants},
            "plans": {t.tid: dict(Counter(p.describe() for p in t.plans))
                      for t in srv.tenants},
            "dram_total": out["dram_bytes"],
            "tokens_per_s": out["tokens_per_s"], "wall_s": out["wall_s"],
            "ttft_s": {tid: i["ttft_s"] for tid, i in out["tenants"].items()}}
        del srv
    on, off = runs["on"], runs["off"]
    problems = []
    if on["lookahead_adjusted"] < 1 or off["lookahead_adjusted"] != 0:
        problems.append(f"adjusted {on['lookahead_adjusted']} / "
                        f"{off['lookahead_adjusted']}")
    if resident[True] == resident[False]:
        problems.append("the resident's grants are the same in both runs")
    if set(on["kinds"]) != set(off["kinds"]):
        problems.append(f"kinds {on['kinds']} / {off['kinds']}")
    elif _differing_outputs(outs[True], outs[False]):
        problems.append("tokens differ: "
                        f"{_differing_outputs(outs[True], outs[False])}")
    if problems:
        raise AssertionError(f"lookahead: {problems}")
    params_fn.memo.clear()
    _release()
    return {"pages": pages, "quote": quote, "runs": runs,
            "launches": dict(counters)}

# ------------------------------------------------------------- hybrid --
def hybrid_prefill_plans(cfg):
    """The hybrid prefill's settings: plain, the LBM grant at which the
    fused block reaches its widest at d_ff 10240 (block_f 1024: a larger
    grant lowers the same plan; core/plan.py::lower_ffn), and 32-page
    LWM grants with native and int8 KV, all at the prompt length."""
    from repro_torch.core.types import ceil_div
    from repro_torch.core.vmem import (PAGE_BYTES, fused_ffn_block_s,
                                       fused_ffn_vmem_bytes)
    s, lwm = PREFILL["prompt_len"], PREFILL["lwm_pages"]
    widest = min(cfg.d_ff, 1024)
    lbm = ceil_div(fused_ffn_vmem_bytes(fused_ffn_block_s(s, 2), widest,
                                        cfg.d_model, 2), PAGE_BYTES)
    plans = {"plain": None, "LBM/native": _plan(cfg, "LBM", lbm, s),
             "LWM/native": _plan(cfg, "LWM", lwm, s),
             "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8")}
    if plans["LBM/native"].ffn.block_f != widest:
        raise AssertionError(f"LBM@{lbm}p: {plans['LBM/native'].describe()}")
    return plans


# every bf16 launch of the hybrid prefill: the shared block's FFN and the
# Mamba2 layers' SSD scan (no flash kernel: the sliding window keeps the
# attention plain, as in the reference)
HYBRID_KERNELS = ("cache_matmul", "block_fused_ffn", "ssd_chunk")
HYBRID_KINDS = dict(matmul=("wgmma",), ffn=("wgmma",), ssd=("wgmma",))


def check_e2e_hybrid(cfg, dev):
    """Full-width zamba2-2.7b cut to one group (5 Mamba2 layers and the
    shared attention + FFN block): the card with the kernels against the
    CPU with the plain versions, same weights and tokens.
    ``make_prefill`` of a 300-token prompt (a 256-token SSD chunk and a
    44-token tail) under an LBM plan with native KV and an LWM plan with
    int8 KV (the shared FFN through block_fused_ffn's and cache_matmul's
    wgmma tiles, the scan through ssd_chunk), then a prefill and two
    teacher-forced decode epochs of 4 steps (LBM: the fused FFN's decode
    tile, LWM: cache_matmul's gemv) with a native, an int8 and an fp8
    cache.  Gated by :func:`_gate`; the prefills' greedy tokens equal, the
    quantized caches by :func:`_quantized_gates`."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    e = HYBRID_E2E
    cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every)
    plans = [_plan(cfg, "LBM", e["lbm_pages"], LANE),
             _plan(cfg, "LWM", e["lwm_pages"], LANE)]
    pf_plans = [plans[0], _plan(cfg, "LWM", e["lwm_pages"], LANE, "int8")]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (e["batch"], 8))
    forced = rng.integers(0, cfg.vocab_size, (e["batch"], 9))
    long_prompt = rng.integers(0, cfg.vocab_size,
                               (e["batch"], e["prompt_len"]))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        toks = torch.from_numpy(long_prompt).long().to(device)
        pf = [prefill(params, {"tokens": toks}, p).float().cpu()
              for p in pf_plans]
        kv = {name: _e2e_run(cfg, params, device, prompt, forced, plans, name)
              for name in KV_CACHES}
        return _e2e_run(cfg, params, device, prompt, forced, plans), pf, kv

    params = M.init_params(cfg, seed=1, device=dev)
    _zero_counters()
    got, got_pf, got_kv = run(params, dev)
    launches = _counters()
    want, want_pf, want_kv = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    prefills = {}
    for p, g, w in zip(pf_plans, got_pf, want_pf):
        label = f"e2e_hybrid prefill {p.describe()}"
        gate = prefills[p.describe()] = _gate(g[..., :V], w[..., :V], label)
        if gate["greedy_agreement"] != 1.0:
            raise AssertionError(f"{label}: {gate}")
    if min(launches[k] for k in HYBRID_KERNELS) <= 0:
        raise AssertionError(f"e2e_hybrid: a kernel never launched: "
                             f"{launches}")
    # the LBM decode epochs run block_fused_ffn's gemv tile (2 rows),
    # make_prefill's 600 rows its wgmma tile
    _gate_kinds(launches, "e2e_hybrid", ("gemv", "wgmma"), ssd=("wgmma",),
                ffn=("gemv", "wgmma"))
    if launches["block_fused_ffn.wgmma"] <= 0:
        raise AssertionError(f"e2e_hybrid: no wgmma block_fused_ffn launch: "
                             f"{launches}")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "prompt_len": e["prompt_len"], "positions": int(got.shape[1]),
            "plans": [p.describe() for p in plans], "prefill": prefills,
            "decode": _gate(got[..., :V], want[..., :V], "e2e_hybrid decode"),
            "decode_quantized_kv": _quantized_gates(got, got_kv, want_kv, V,
                                                    "e2e_hybrid"),
            "launches": _kind_counts(launches)}


def serve_hybrid_main_path(cfg, dev, counters):
    """The hybrid slice's serving path: :func:`serve_main_path` on
    full-width, full-depth zamba2-2.7b (:data:`SERVE_HYBRID`: a resident
    and a 256-token arrival in a pool of the arrival's native
    reservation and an LBM grant's pages).  Its decode binds the plan,
    so the shared block's FFN runs cache_matmul's gemv tile: 3 launches
    a group and decode step (9 groups: 27), none in prompt chunks, which
    scan through ssd_chunk.  ``counters`` receives the serving run's
    counts.  Then the full-prompt re-arrival of a 64-token prompt
    (:func:`_rearrival`): shorter than the 80 SSM heads, so a snapshot
    cut along the state's head axis would seed a wrong state."""
    from repro_torch.launch.serve import _kv_reserve_pages
    from repro_torch.models.transformer import num_groups
    sh = SERVE_HYBRID
    arrival = sh["arrival"]
    pages = sh["headroom"] + _kv_reserve_pages(cfg, sh["batch"],
                                               arrival["prompt_len"])
    res = serve_main_path(cfg, dev, counters, label="serve_hybrid",
                          batch=sh["batch"], max_len=sh["max_len"],
                          pages=pages, steps=sh["steps"], arrival=arrival)
    _launched(counters, "serve_hybrid", "ssd_chunk")
    _gate_kinds(counters, "serve_hybrid", ("gemv",), ssd=("wgmma",))
    decode_steps = sh["steps"] + arrival["n_inferences"]
    per_step = 3 * num_groups(cfg)
    if res["plan_kinds"] != ["LWM"] or (counters["cache_matmul.gemv"]
                                        != per_step * decode_steps):
        raise AssertionError(f"serve_hybrid: {counters['cache_matmul.gemv']} "
                             f"gemv launches, want {per_step} x "
                             f"{decode_steps} decode steps")
    res["gemv_per_decode_step"] = counters["cache_matmul.gemv"] / decode_steps
    _release()
    rr = {"batch": sh["batch"], **sh["rearrival"]}
    label = "serve_hybrid rearrival"
    res["rearrival"], counts = _rearrival(cfg, rr, sh["headroom"], dev, {},
                                          _params_memo(dev), label)
    _launched(counts, label, "ssd_chunk", ("gemv",))
    return res


# ------------------------------------------------- encoder-decoder, VLM --
def _lbm_pool(cfg, batch: int, prompt_len: int) -> int:
    """A pool of an arrival's native KV quote and the smallest LBM
    candidate of the decode FFN (whisper-tiny: 24 + 15 pages at 64
    tokens): one tenant at a time is granted LBM."""
    from repro_torch.launch import serve as S
    tm = S._tenant_model(S._ffn_graph(cfg.name, cfg, seq_block=batch),
                         S._vmem_mapper(1 << 16))
    lbm = min(m.lbm.p_need for m in tm.mapping.mcts if m.lbm is not None)
    return S._kv_reserve_pages(cfg, batch, prompt_len) + lbm


def encdec_prefill_plans(cfg):
    """e2e_encdec's make_prefill settings at the decoder's 448 positions:
    plain, the smallest LBM grant that lowers fused, and LWM@32p with
    native and with int8 KV (the quantized flash kernel at hd 64)."""
    from repro_torch.core.vmem import fused_ffn_pages
    e = ENCDEC_E2E
    s = e["prompt_len"]
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM",
                                fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2),
                                s),
            "LWM/native": _plan(cfg, "LWM", e["lwm_pages"], s),
            "LWM/int8": _plan(cfg, "LWM", e["lwm_pages"], s, "int8")}


def vlm_prefill_plans(cfg):
    """prefill_vlm's settings at 576 patches + 1024 tokens = 1600
    positions: plain, the smallest LBM grant that lowers fused at d_ff
    14336, and LWM@32p with native and with int8 KV."""
    from repro_torch.core.vmem import fused_ffn_pages
    s, lwm = cfg.num_patches + PREFILL["prompt_len"], PREFILL["lwm_pages"]
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM",
                                fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2),
                                s),
            "LWM/native": _plan(cfg, "LWM", lwm, s),
            "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8")}


def _fp32_reference(cfg, params):
    """The config and a host copy of ``params`` in fp32 (the same bf16
    values): the plain versions' reference for the slice's e2e phases,
    where bf16 GEMMs on the host CPU would take minutes."""
    import torch
    return (dataclasses.replace(cfg, dtype="float32"),
            _to_dtype(_to(params, "cpu"), torch.float32))


def check_e2e_encdec(cfg, dev):
    """Full-width, full-depth whisper-tiny (4 encoder and 4 decoder
    layers): the card with the kernels against the CPU with the plain
    versions, on the same weights (in fp32 there: :func:`_fp32_reference`).
    ``make_prefill`` of 2 x (1500 frames + 448 decoder tokens) plain and
    under :func:`encdec_prefill_plans` (the decoder's self-attention
    through flash attention at hd 64, its wgmma tile, native and, under
    LWM@32p with int8 KV, quantized; the FFN at 896 rows through
    block_fused_ffn's or cache_matmul's wgmma tile; the encoder
    and the cross-attention plain, as in the reference), then a prefill
    and two teacher-forced decode epochs over the encoder's output under
    the grants serve_encdec's decode gets (LBM@34p: the fused FFN's gemv
    tile; LWM@3p: cache_matmul's gemv).  Gated by :func:`_gate`; the
    kinds by :func:`_gate_kinds`: no simt launch."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    from repro_torch.models.transformer import encode
    e = ENCDEC_E2E
    B, S, V = e["batch"], e["prompt_len"], cfg.vocab_size
    pf_plans = encdec_prefill_plans(cfg)
    dec_plans = [_plan(cfg, "LBM", e["decode_lbm_pages"], LANE),
                 _plan(cfg, "LWM", e["decode_lwm_pages"], LANE)]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, V, (B, S))
    frames = rng.standard_normal((B, cfg.enc_len, cfg.d_model),
                                 dtype=np.float32)
    prompt = rng.integers(0, V, (B, 8))
    forced = rng.integers(0, V, (B, 9))

    def run(c, params, device):
        batch = {"tokens": torch.from_numpy(toks).long().to(device),
                 "embeds_prefix": torch.from_numpy(frames).to(
                     device, c.torch_dtype)}
        prefill, pf, counts = M.make_prefill(c), {}, {}
        for name, plan in pf_plans.items():
            before = _counters()
            pf[name] = prefill(params, batch, plan).float().cpu()
            counts[name] = {k: v - before[k] for k, v in _counters().items()
                            if v - before[k]}
        enc = encode(params, batch["embeds_prefix"], c)
        return pf, _e2e_run(c, params, device, prompt, forced, dec_plans,
                            enc=enc), counts

    params = M.init_params(cfg, seed=1, device=dev)
    _zero_counters()
    got_pf, got, per_call = run(cfg, params, dev)
    launches = _counters()
    want_pf, want, _ = run(*_fp32_reference(cfg, params), "cpu")
    del params
    prefill = {name: _gate(got_pf[name][..., :V], want_pf[name][..., :V],
                           f"e2e_encdec prefill {name}")
               for name in pf_plans}
    _gate_kinds(launches, "e2e_encdec", ("gemv", "wgmma"), flash=("wgmma",),
                ffn=("wgmma", "gemv"), flash_quantized=("wgmma",))
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "enc_layers": cfg.enc_layers, "frames": cfg.enc_len,
            "prompt_len": S, "batch": B, "reference": "cpu fp32",
            "prefill_plans": {n: p.describe() if p is not None else None
                              for n, p in pf_plans.items()},
            "decode_plans": [p.describe() for p in dec_plans],
            "prefill": prefill,
            "decode": _gate(got[..., :V], want[..., :V], "e2e_encdec decode"),
            "launches": dict(launches), "prefill_launches": per_call}


def _xattn_kv_share(cfg, batch: int, dev, profile):
    """The share of a replayed decode epoch's device time (``profile``,
    :func:`_profile_replay`'s) that the cross-attention K/V projections
    over the encoder's frames take: one step's projections (K and V of
    every decoder layer, [batch x 1500, 384] @ [384, 384] each, as
    ``mha`` runs them) timed alone, times the epoch's steps, over the
    epoch's device time."""
    import torch
    from repro_torch.models.layers import linear
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    dt, d = cfg.torch_dtype, cfg.d_model
    enc = _randn(gen, (batch, cfg.enc_len, d), dt)
    w = [{"w": _randn(gen, (d, cfg.num_kv_heads * cfg.hd), dt,
                      1 / math.sqrt(d))} for _ in range(2 * cfg.num_layers)]

    def step():
        for wi in w:
            linear(wi, enc)
    ms = _median_ms(step)
    total = profile["device_ms"]
    return {"step_ms": ms, "epoch_steps": profile["steps"],
            "gemms_per_step": len(w),
            "share": (ms * profile["steps"] / total
                      if isinstance(total, float) else "not measured")}


def serve_encdec_main_path(cfg, dev, counters):
    """The encoder-decoder slice's serving path: :func:`serve_main_path` on
    full-width, full-depth whisper-tiny (:data:`SERVE_ENCDEC`: a resident
    and a 64-token arrival, in a pool of the arrival's quote and the
    decode FFN's LBM candidate).  Decode is granted LBM (block_fused_ffn,
    its gemv tile: 4 launches a decode step, one a layer) and LWM beside
    the arrival (cache_matmul's gemv); the prompt chunk runs plain.
    Every tenant's cross-attention reads its ``enc``.  The replayed
    epoch's profile gets the fused FFN's kernels' shares and the share
    of the per-step cross-attention K/V projections
    (:func:`_xattn_kv_share`)."""
    se = SERVE_ENCDEC
    arrival = se["arrival"]
    pages = _lbm_pool(cfg, se["batch"], arrival["prompt_len"])
    res = serve_main_path(cfg, dev, counters, label="serve_encdec",
                          batch=se["batch"], max_len=se["max_len"],
                          pages=pages, steps=se["steps"], arrival=arrival,
                          ffn=("gemv",), shares=FUSED_FFN_KERNELS)
    res["xattn_kv"] = _xattn_kv_share(cfg, se["batch"], dev,
                                      res["profile"][0])
    fused = counters["block_fused_ffn.gemv"]
    if res["plan_kinds"] != ["LBM", "LWM"] or fused % cfg.num_layers:
        raise AssertionError(f"serve_encdec: plans {res['plan_kinds']}, "
                             f"{fused} fused launches for "
                             f"{cfg.num_layers} layers")
    res["fused_per_decode_step"] = cfg.num_layers
    res["lbm_decode_steps"] = fused // cfg.num_layers
    return res


def check_e2e_vlm(cfg, dev):
    """Full-width llava-next cut to :data:`VLM_E2E`'s 4 layers: the card
    with the kernels against the CPU with the plain versions, on the same
    weights (in fp32 there: :func:`_fp32_reference`).  ``make_prefill``
    of 2 x (576 patch embeddings + 40 tokens) under an LBM plan with
    native KV and an LWM@32p plan with int8 KV, every launch of the
    wgmma kind (the GEMMs and the fused FFN at 1232 rows, flash native
    and quantized at hd 128).  Gated by :func:`_gate`."""
    import torch
    from repro_torch.core.vmem import LANE, fused_ffn_pages
    from repro_torch.models import model as M
    e = VLM_E2E
    cfg = dataclasses.replace(cfg, num_layers=e["layers"])
    B, V, P = e["batch"], cfg.vocab_size, cfg.num_patches
    plans = {"LBM/native": _plan(cfg, "LBM", fused_ffn_pages(
                 LANE, cfg.d_model, cfg.d_ff, 2), LANE),
             "LWM/int8": _plan(cfg, "LWM", e["lwm_pages"], LANE, "int8")}
    rng = np.random.default_rng(8)
    toks = rng.integers(0, V, (B, e["prompt_len"]))
    patches = rng.standard_normal((B, P, cfg.d_model), dtype=np.float32)

    def run(c, params, device):
        batch = {"tokens": torch.from_numpy(toks).long().to(device),
                 "embeds_prefix": torch.from_numpy(patches).to(
                     device, c.torch_dtype)}
        return {n: M.make_prefill(c)(params, batch, p).float().cpu()
                for n, p in plans.items()}

    params = M.init_params(cfg, seed=1, device=dev)
    _zero_counters()
    got = run(cfg, params, dev)
    launches = _counters()
    want = run(*_fp32_reference(cfg, params), "cpu")
    del params
    gates = {n: _gate(got[n][..., :V], want[n][..., :V], f"e2e_vlm {n}")
             for n in plans}
    if min(launches[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"e2e_vlm: a kernel never launched: {launches}")
    _gate_kinds(launches, "e2e_vlm", **PREFILL_KINDS)
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "patches": P, "prompt_len": e["prompt_len"],
            "positions": P + e["prompt_len"], "reference": "cpu fp32",
            "plans": {n: p.describe() for n, p in plans.items()},
            "prefill": gates, "launches": _kind_counts(launches)}


def more_arch_config(arch: str, layers=None):
    """The registered config of ``arch``, cut to ``layers`` (registered
    under its own name, which the server looks up) where given."""
    from repro_torch.models.base import get_arch, register
    cfg = get_arch(arch)
    if layers is None:
        return cfg
    return register(dataclasses.replace(cfg, name=f"{arch}-{layers}layer",
                                        num_layers=layers))


def prefill_arch_main_path(cfg, dev, counters, label: str):
    """``prefill``'s function on one of :data:`MORE_ARCHS`: the dense
    archs under :func:`prefill_plans`, kimi-k2 under
    :func:`moe_prefill_plans`; every bf16 launch of the wgmma kind
    (kimi's flash and quantized flash at hd 112)."""
    if cfg.is_moe:
        return prefill_main_path(cfg, dev, counters, label=label,
                                 plans=moe_prefill_plans(cfg),
                                 profiled=("LBM/native", "LWM/native",
                                           "LWM/int8"))
    return prefill_main_path(cfg, dev, counters, label=label)


def serve_arch_main_path(cfg, dev, counters, label: str = "serve_vlm",
                         one_weight_set: bool = False):
    """``serve``'s function on llava-next (the VLM slice: its prompt
    serves through the dense decoder, as the reference's) and on
    :data:`MORE_ARCHS` (``one_weight_set``: both tenants on one set),
    full width and depth (:data:`SERVE_QUOTE`): a pool of the arrival's
    native quote and 324 pages.  The dense archs' decode launches only
    cache_matmul of the gemv kind (no LBM candidate at full width);
    kimi-k2's, like olmoe's, no kernel (its epoch profiled with the
    expert gather's share)."""
    from repro_torch.launch.serve import _kv_reserve_pages
    sv = SERVE_QUOTE
    arrival = sv["arrival"]
    pages = sv["headroom"] + _kv_reserve_pages(cfg, sv["batch"],
                                               arrival["prompt_len"])
    return serve_main_path(cfg, dev, counters, label=label, batch=sv["batch"],
                           max_len=sv["max_len"], pages=pages,
                           steps=sv["steps"], arrival=arrival,
                           kernels=not cfg.is_moe,
                           shares=(GATHER_KERNEL,) if cfg.is_moe else (),
                           one_weight_set=one_weight_set)


# ------------------------------------------------------------- fleet --
def _fleet_devices(dev, n: int):
    """``n`` replicas on one device: the CLI's placement rule (replica r
    on card r % device_count) on a one-card machine."""
    import torch
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return [d] * n


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif tree is not None:
        yield tree


def _misplaced(fleet):
    """Live tenants with a param, cache or buffer (feedback token,
    position, log, prompt, ``enc``) off their replica's device."""
    bad = []
    for srv in fleet.replicas:
        for t in srv.tenants:
            devs = {x.device for x in _tensors([
                t.params, t.caches, t.token, t.index_dev, t.log, t.enc,
                t.prompt_dev])}
            if devs != {srv.device}:
                bad.append((t.tid, srv.replica, sorted(map(str, devs))))
    return bad


def serve_fleet_pages(archs) -> int:
    """serve_fleet's pages a replica: the native quotes of one prompt of
    each arch (the router sends one tenant of each to each replica) and
    the headroom."""
    from repro_torch.launch.serve import _kv_reserve_pages
    from repro_torch.models.base import get_arch
    sf = SERVE_FLEET
    return sf["headroom"] + sum(
        _kv_reserve_pages(get_arch(a), sf["batch"], sf["prompt_len"])
        for a in sorted(set(archs)))


def fleet_failover_pages(arch) -> int:
    """fleet_failover's pages a replica: every tenant's native quote, so
    the survivor holds them all."""
    from repro_torch.launch.serve import _kv_reserve_pages
    from repro_torch.models.base import get_arch
    ff = FLEET_FAILOVER
    return ff["tenants"] * _kv_reserve_pages(get_arch(arch), ff["batch"],
                                             ff["prompt_len"])


def serve_fleet_main_path(dev, counters, archs=None, kinds: bool = True):
    """The fleet slice's main path (:data:`SERVE_FLEET`): a
    ``FleetServer`` of two replicas on one card serving two yi-9b and
    two mamba2-370m prompt tenants at full width.  Gated: every tenant's
    params, caches and buffers lie on its replica's device; one tenant
    of each arch a replica; every tenant served its budget; each
    replica's decode streams bitwise equal to a replay of its routed
    scenario on a fresh single-card server; the fleet's launch counts
    (zeroed just before its run, read just after, into ``counters``)
    equal to the sum of the replays' (yi-9b's decode gemv and mamba2's
    prompt-chunk ssd_chunk, of those kinds with ``kinds``).  Then one
    fleet round warm: a fleet of the same tenants as residents, captured
    in a first run of one round, then :data:`WARM_RUNS` rounds timed and
    one profiled (device idle share); none may build a program.  ``archs``
    replaces the full-width archs (small registered configs in tests)."""
    import torch
    from repro_torch.launch.serve import FleetServer, MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    sf = SERVE_FLEET
    archs = tuple(archs or sf["archs"])
    kw = dict(batch=sf["batch"], max_len=sf["max_len"],
              epoch_len=sf["epoch_len"], reduced=False)
    mix = sorted(set(archs))
    pages = serve_fleet_pages(archs)
    devices = _fleet_devices(dev, sf["replicas"])
    params_fn = _params_memo(dev)
    specs = [TenantSpec(a, prompt_len=sf["prompt_len"],
                        n_inferences=sf["n_inferences"]) for a in archs]
    torch.cuda.reset_peak_memory_stats()
    fleet = FleetServer(devices=devices, tenants=specs,
                        pages_per_replica=pages, params_fn=params_fn, **kw)
    bad = _misplaced(fleet)
    if bad:
        raise AssertionError(f"serve_fleet: off their replica's device: {bad}")
    routed = [sorted(s.model for s in r) for r in fleet.replica_scenarios()]
    if routed != [mix] * sf["replicas"]:
        raise AssertionError(f"serve_fleet: routed {routed}, want {mix} "
                             f"a replica")
    _zero_counters()
    out = fleet.run(steps=sf["steps"])
    counters.update(_counters())
    want = (sf["batch"], 1 + sf["n_inferences"])
    for tid, info in out["tenants"].items():
        o = info["output"]
        if not info["departed"] or o.shape != want or o.min() < 0:
            raise AssertionError(f"serve_fleet {tid}: departed "
                                 f"{info['departed']}, output {o.shape}, "
                                 f"want {want}")
    # each replica's routed scenario replayed alone, on the same weights
    replays, sums = [], Counter()
    for r, routed_specs in enumerate(fleet.replica_scenarios()):
        solo = MultiTenantServer([], tenants=routed_specs, total_pages=pages,
                                 device=fleet.replicas[r].device,
                                 params_fn=params_fn, **kw)
        ref, counts = _run_counted(solo, sf["steps"], {})
        sums.update(counts)
        differ = [tid for tid, info in ref["tenants"].items()
                  if out["tenants"][tid]["replica"] != f"r{r}"
                  or not np.array_equal(out["tenants"][tid]["output"],
                                        info["output"])]
        if differ or set(ref["tenants"]) != set(
                out["replicas"][r]["tenants"]):
            raise AssertionError(f"serve_fleet r{r}: the replay differs "
                                 f"for {differ}")
        replays.append({"replica": f"r{r}", "tenants": sorted(ref["tenants"]),
                        "wall_s": ref["wall_s"],
                        "tokens_served": ref["tokens_served"],
                        "tokens_per_s": ref["tokens_per_s"],
                        "launches": _kind_counts(counts),
                        "captures": ref["host"]["captures"]})
        del solo
        _release()
    if ({k: v for k, v in counters.items() if v}
            != {k: v for k, v in sums.items() if v}):
        raise AssertionError(f"serve_fleet: fleet launches {counters}, the "
                             f"replays' {dict(sums)}")
    _launched(counters, "serve_fleet", "ssd_chunk")
    if kinds:
        # at reduced widths LBM may be granted instead: no cache_matmul
        _launched(counters, "serve_fleet", "cache_matmul")
        _gate_kinds(counters, "serve_fleet", ("gemv",), ssd=("wgmma",))
    res = {"archs": list(archs), "replicas": sf["replicas"],
           "devices": [str(d) for d in devices],
           "pages_per_replica": pages,
           "routes": out["routes"], "per_replica": out["replicas"],
           "page_util_balance": out["page_util_balance"],
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "p95_ttft_s": out["p95_ttft_s"],
           "ttft_s": {tid: info["ttft_s"]
                      for tid, info in out["tenants"].items()},
           "launches": dict(counters), "replays": replays,
           "replay_wall_s_sum": sum(r["wall_s"] for r in replays),
           "captures": sum(srv._captures for srv in fleet.replicas),
           "capture_s": sum(srv._capture_s for srv in fleet.replicas),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del fleet
    _release()
    res["round"] = _fleet_round(archs, devices, pages, params_fn, kw)
    params_fn.memo.clear()
    return res


def _fleet_round(archs, devices, pages, params_fn, kw, tp: int = 1):
    """One fleet round warm: the tenants of ``archs`` as residents of a
    fleet on ``devices`` (groups of ``tp``; the same param seeds, so the
    same weights), a
    first ``run()`` of one round (``epoch_len`` steps) capturing every
    decode item, then :data:`WARM_RUNS` rounds timed (tokens/s) and one
    profiled (``_profile``: device time by kernel and idle share).  The
    positions stay inside the first 128-token window, so no warm round
    may build a program."""
    from repro_torch.launch.serve import FleetServer
    from repro_torch.sim.driver import TenantSpec
    steps = kw["epoch_len"]
    fleet = FleetServer(tp=tp, devices=devices,
                        tenants=[TenantSpec(a) for a in archs],
                        pages_per_replica=pages, params_fn=params_fn, **kw)
    cold = fleet.run(steps=steps)

    def builds():
        return [(srv._captures, srv._fused_jits.misses,
                 srv._prefill_jits.misses) for srv in fleet.replicas]
    built = builds()
    warm = [fleet.run(steps=steps) for _ in range(WARM_RUNS)]
    profile = _profile(lambda: fleet.run(steps=steps))
    if builds() != built:
        raise AssertionError(f"serve_fleet: a warm round built programs: "
                             f"{built} -> {builds()}")
    rates = sorted(o["tokens_per_s"] for o in warm)
    med = rates[len(rates) // 2]
    return {"steps": steps, "routes": cold["routes"],
            "cold_tokens_per_s": cold["tokens_per_s"],
            "cold_wall_s": cold["wall_s"],
            "warm_tokens_per_s": [o["tokens_per_s"] for o in warm],
            "warm_wall_s": [o["wall_s"] for o in warm],
            "median_tokens_per_s": med,
            "spread": (rates[-1] - rates[0]) / med if med else None,
            "profile": profile}


def fleet_failover_main_path(dev, counters, arch=None, kinds: bool = True):
    """The reference's failover scenario at full width
    (:data:`FLEET_FAILOVER`): r0 killed at step 8 moves its live tenants
    to r1, where each re-prefills, completes its remaining budget and
    has a ``recovery_s`` entry, while r0's tenants leave no buffer and
    its pool is whole again; then the same fleet with r1 killed at step
    12 too: that kill is logged as skipped ("last live replica"), every
    tenant completes on r1, nothing raises.  ``counters`` takes both
    runs' launches (each zeroed just before its run and read just after):
    the prompt chunks' ssd_chunk, of the wgmma kind with ``kinds``."""
    from repro_torch.launch.serve import FleetServer
    from repro_torch.sim.driver import TenantSpec
    from repro_torch.sim.faults import FaultEvent, FaultPlan
    ff = FLEET_FAILOVER
    arch = arch or ff["arch"]
    pages = fleet_failover_pages(arch)
    params_fn = _params_memo(dev)
    runs = {}
    for label, kills in (("kill", (ff["kill"],)),
                         ("kill_last", (ff["kill"], ff["last_kill"]))):
        plan = FaultPlan([FaultEvent(step=s, kind="replica_kill", target=t)
                          for s, t in kills])
        fleet = FleetServer(
            devices=_fleet_devices(dev, 2), faults=plan,
            tenants=[TenantSpec(arch, prompt_len=ff["prompt_len"],
                                n_inferences=ff["n_inferences"],
                                arrive_at=float(i))
                     for i in range(ff["tenants"])],
            pages_per_replica=pages, batch=ff["batch"], max_len=ff["max_len"],
            epoch_len=ff["epoch_len"], reduced=False, params_fn=params_fn)
        out, counts = _run_counted(fleet, ff["steps"], counters)
        fo = out["failover"]
        respecs = {f"t{s.seed}:{arch}": s
                   for s in fleet.replica_scenarios()[1]}
        problems = []
        if fo["killed"] != ["r0"] or not fo["moved"]:
            problems.append(f"killed {fo['killed']}, moved {fo['moved']}")
        for m in fo["moved"]:
            info = out["tenants"][m["tid"]]
            want = (ff["batch"], 1 + respecs[m["tid"]].n_inferences)
            if ((m["from"], m["to"], info["replica"]) != ("r0", "r1", "r1")
                    or not info["departed"] or info["output"].shape != want
                    or not fo["recovery_s"].get(m["tid"], 0) > 0):
                problems.append(f"{m}: {info['replica']}, departed "
                                f"{info['departed']}, output "
                                f"{info['output'].shape} want {want}, "
                                f"recovery {fo['recovery_s'].get(m['tid'])}")
        if not all(info["departed"] for info in out["tenants"].values()):
            problems.append("a tenant did not complete")
        dead = fleet.replicas[0]
        if (dead.cache.free_pages != pages
                or any(t.caches is not None for t in dead.tenants)):
            problems.append(f"r0 kept {pages - dead.cache.free_pages} pages "
                            f"or buffers")
        skipped = [r for r in out["faults"]["log"]
                   if r["kind"] == "replica_kill" and "skipped" in r]
        want_skipped = ([{"target": "r1", "skipped": "last live replica"}]
                        if len(kills) > 1 else [])
        if [{k: r[k] for k in ("target", "skipped")}
                for r in skipped] != want_skipped:
            problems.append(f"skipped kills {skipped}")
        if problems:
            raise AssertionError(f"fleet_failover {label}: {problems}")
        _launched(counts, f"fleet_failover {label}", "ssd_chunk")
        if kinds:
            _gate_kinds(counts, f"fleet_failover {label}", ssd=("wgmma",))
        runs[label] = {
            "routes": out["routes"], "moved": fo["moved"],
            "recovery_s": fo["recovery_s"],
            "recovery_p95_s": fo["recovery_p95_s"],
            "per_replica": out["replicas"],
            "fault_log": _wall_free(out["faults"]["log"]),
            "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
            "tokens_per_s": out["tokens_per_s"],
            "launches": _kind_counts(counts)}
        del fleet
        _release()
    params_fn.memo.clear()
    return {"arch": arch, "pages_per_replica": pages,
            "launches": dict(counters), "runs": runs}


# ----------------------------------------------------------------- tp --
def _tp_placement(fleet):
    """Per tenant of a tensor-parallel fleet: every split leaf's pieces on
    its group's devices, one a device, each 1/tp of the leaf; every
    head-split KV cache leaf (``k@r`` ...) on the group's device r with
    Hkv / tp heads, and one at least; every other leaf, cache and buffer
    on the group's first device; something split.  Returns (problems,
    each tenant's param bytes by shard)."""
    from repro_torch.distributed import tensor_parallel as tp
    bad, per = [], {}
    for srv in fleet.replicas:
        n = len(srv.group)
        for t in srv.tenants:
            leaves = tp.leaves(t.params)
            split = [x for x in leaves if tp.is_sharded(x)]
            for x in split:
                if (x.devices != srv.group or any(
                        p.numel() * n != x.shape.numel() for p in x.pieces)):
                    bad.append((t.tid, repr(x)))
            heads = t.cfg.num_kv_heads // n
            kv = {name: leaf for c in t.caches for name, leaf in c.items()
                  if "@" in name}
            for name, leaf in kv.items():
                r = int(name.partition("@")[2])
                if leaf.device != srv.group[r] or leaf.shape[2] != heads:
                    bad.append((t.tid, name, str(leaf.device),
                                tuple(leaf.shape)))
            rest = [leaf for c in t.caches for name, leaf in c.items()
                    if "@" not in name]
            off = {str(x.device) for x in leaves if not tp.is_sharded(x)}
            off |= {str(x.device) for x in _tensors([
                rest, t.token, t.index_dev, t.log, t.enc, t.prompt_dev])}
            if off != {str(srv.device)} or not split or not kv:
                bad.append((t.tid, sorted(off), len(split), len(kv)))
            per[t.tid] = tp.bytes_by_shard(t.params)
    return bad, per


def serve_tp_main_path(dev, counters, arch=None, kinds: bool = True):
    """The tensor-parallel slice's main path (:data:`SERVE_TP`): the
    reference's tp = 2 fleet at full width on one card, each group's two
    shards on cuda:0.  Gates: placement (:func:`_tp_placement`, bytes a
    shard recorded); every tenant served its budget; each replica's
    streams bitwise equal to a replay of its routed specs on a fresh
    tp = 2 group; the run repeated on a fresh fleet bitwise; a warm round
    (:func:`_fleet_round`) building nothing.  Then a tp = 1 fleet on the
    same weights, rebuilt from the same seeds after the tp = 2 ones are
    freed: with ``kinds``, tp = 2's cache_matmul gemv launches exactly
    ``tp`` times tp = 1's, every cache_matmul / block_fused_ffn launch at
    a shard's weight shape and none at a whole FFN weight's (counters
    zeroed just before each run, read just after; tp = 2's into
    ``counters``).  Warm tokens/s of both groups' rounds recorded."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh, replica_submeshes
    from repro_torch.launch.serve import (FleetServer, MultiTenantServer,
                                          _kv_reserve_pages)
    from repro_torch.models.base import get_arch
    from repro_torch.sim.driver import TenantSpec
    st = SERVE_TP
    arch = arch or st["arch"]
    cfg = get_arch(arch)
    n, tpn = st["replicas"], st["tp"]
    kw = dict(batch=st["batch"], max_len=st["max_len"],
              epoch_len=st["epoch_len"], reduced=False)
    pages = st["headroom"] + _kv_reserve_pages(cfg, st["batch"],
                                               st["prompt_len"])
    specs = [TenantSpec(arch, n_inferences=st["n_inferences"]),
             TenantSpec(arch, n_inferences=st["n_inferences"],
                        prompt_len=st["prompt_len"])]

    def fleet_of(size, params_fn):
        return FleetServer(n_replicas=n, tp=size,
                           devices=_fleet_devices(dev, n * size),
                           tenants=specs, pages_per_replica=pages,
                           params_fn=params_fn, **kw)

    # the weights kept only as placed on a group (every group is the same
    # devices), so a tenant's whole weights live only while it is split
    params_fn = _params_memo(dev, make_serving_mesh(
        1, tp=tpn, devices=_fleet_devices(dev, tpn)))
    torch.cuda.reset_peak_memory_stats()
    fleet = fleet_of(tpn, params_fn)
    bad, shard_bytes = _tp_placement(fleet)
    if bad:
        raise AssertionError(f"serve_tp: misplaced: {bad}")
    if [len(r) for r in fleet.replica_scenarios()] != [1] * n:
        raise AssertionError(f"serve_tp: routed {fleet.scenario.routes}")
    _zero_counters()
    out = fleet.run(steps=st["steps"])
    counts2 = _counters()
    counters.update(counts2)
    for tid, info in out["tenants"].items():
        if not info["departed"] or info["output"].min() < 0:
            raise AssertionError(f"serve_tp {tid}: departed "
                                 f"{info['departed']}")
    replays = []
    for r, routed in enumerate(fleet.replica_scenarios()):
        solo = MultiTenantServer([], tenants=routed, total_pages=pages,
                                 device=replica_submeshes(fleet.mesh)[r],
                                 params_fn=params_fn, **kw)
        ref = solo.run(steps=st["steps"])
        differ = _differing_outputs(ref, out)
        if differ:
            raise AssertionError(f"serve_tp r{r}: the replay differs for "
                                 f"{differ}")
        replays.append({"replica": f"r{r}", "tenants": sorted(ref["tenants"]),
                        "tokens_per_s": ref["tokens_per_s"]})
        del solo
        _release()
    captured = [srv._capture_graphs for srv in fleet.replicas]
    res = {"arch": arch, "replicas": n, "tp": tpn, "pages_per_replica": pages,
           "devices": [[str(d) for d in srv.group] for srv in fleet.replicas],
           "param_bytes_by_shard": shard_bytes, "captured": captured,
           "routes": out["routes"], "tokens_served": out["tokens_served"],
           "wall_s": out["wall_s"], "tokens_per_s": out["tokens_per_s"],
           "captures": sum(srv._captures for srv in fleet.replicas),
           "capture_s": sum(srv._capture_s for srv in fleet.replicas),
           "replays": replays}
    del fleet
    _release()
    again = fleet_of(tpn, params_fn)
    out_b = again.run(steps=st["steps"])
    if _differing_outputs(out, out_b):
        raise AssertionError(f"serve_tp: the repeat differs for "
                             f"{_differing_outputs(out, out_b)}")
    del again
    _release()
    res["round"] = _fleet_round([arch] * n, _fleet_devices(dev, n * tpn),
                                pages, params_fn, kw, tp=tpn)
    params_fn.memo.clear()
    _release()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    # tp = 1 on the same weights, rebuilt from the same seeds
    params_fn = _params_memo(dev)
    fleet = fleet_of(1, params_fn)
    _zero_counters()
    out1 = fleet.run(steps=st["steps"])
    counts1 = _counters()
    del fleet
    _release()
    res["round_tp1"] = _fleet_round([arch] * n, _fleet_devices(dev, n),
                                    pages, params_fn, kw)
    params_fn.memo.clear()
    _release()
    d, f = cfg.d_model, cfg.d_ff
    shard = {f"cache_matmul@{d}x{f // tpn}", f"cache_matmul@{f // tpn}x{d}",
             f"block_fused_ffn@{d}x{f // tpn}"}
    whole = {f"cache_matmul@{d}x{f}", f"cache_matmul@{f}x{d}",
             f"block_fused_ffn@{d}x{f}"}
    shapes = sorted(k for k, v in counts2.items() if "@" in k and v)
    # a prompt tenant's first token comes from its last prompt chunk
    decode_steps = sum(info["tokens"] // st["batch"] - (info["prompt_len"] > 0)
                       for info in out["tenants"].values())
    same = sum(int(np.array_equal(info["output"],
                                  out1["tenants"][tid]["output"]))
               for tid, info in out["tenants"].items())
    res.update({
        "launches": {k: v for k, v in counts2.items() if v},
        "launches_tp1": {k: v for k, v in counts1.items() if v},
        "gemv_per_decode_step": counts2["cache_matmul.gemv"] / decode_steps,
        "gemv_per_decode_step_tp1": (counts1["cache_matmul.gemv"]
                                     / decode_steps),
        "shapes": shapes, "tp1_tokens_per_s": out1["tokens_per_s"],
        "streams_equal_to_tp1": f"{same} of {len(out['tenants'])}"})
    if kinds:
        g2, g1 = counts2["cache_matmul.gemv"], counts1["cache_matmul.gemv"]
        if g1 <= 0 or g2 != tpn * g1:
            raise AssertionError(f"serve_tp: gemv launches {g2} at tp = "
                                 f"{tpn}, {g1} at tp = 1")
        if not set(shapes) <= shard or set(shapes) & whole:
            raise AssertionError(f"serve_tp: launches at {shapes}, want "
                                 f"only {sorted(shard)}")
    return res


def _tp_plans(cfg):
    """e2e_tp's plans: an LWM grant of 32 pages and, where the family has
    an FFN, the smallest LBM grant that lowers fused, at LANE rows."""
    from repro_torch.core.vmem import LANE, fused_ffn_pages
    from repro_torch.launch.serve import _lower_width
    plans = {"LWM": _plan(cfg, "LWM", 32, LANE)}
    if cfg.family != "ssm":
        plans["LBM"] = _plan(cfg, "LBM", fused_ffn_pages(
            LANE, cfg.d_model, _lower_width(cfg), 2), LANE)
    return plans


def _tp_run(cfg, params, dev, plans, inputs):
    """``make_prefill`` under each plan, then a prompt chunk and a
    teacher-forced decode epoch under each plan (:func:`_e2e_run`); an
    encoder-decoder's encoder runs on ``params`` first.  Logits fp32 on
    the host."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import encode
    toks, prompt, forced, prefix = inputs
    batch = {"tokens": torch.from_numpy(toks).long().to(dev)}
    enc = None
    if prefix is not None:
        batch["embeds_prefix"] = torch.from_numpy(prefix).to(dev).to(
            cfg.torch_dtype)
        if cfg.family == "encdec":
            enc = encode(params, batch["embeds_prefix"], cfg)
    prefill = M.make_prefill(cfg)
    pf = torch.stack([prefill(params, batch, p).float()
                      for p in plans.values()], 1).cpu()
    return pf, _e2e_run(cfg, params, dev, prompt, forced,
                        list(plans.values()), enc=enc)


def _decode_ms(cfg, params, dev, inputs, plan, k: int = 8, reps: int = 3):
    """One eager decode step's time under ``plan`` (ms, CUDA events over
    a ``k``-step greedy ``decode_epoch`` after a prompt chunk, the median
    of ``reps``; each repeat rewrites the same cache rows): a record of
    what tp = 2 costs on one card, not a gate."""
    import torch
    from repro_torch.models.transformer import (decode_epoch, encode,
                                                init_caches, prefill_chunk)
    _, prompt, _, prefix = inputs
    toks = torch.from_numpy(prompt).long().to(dev)
    enc = None
    if cfg.family == "encdec":
        enc = encode(params, torch.from_numpy(prefix).to(dev).to(
            cfg.torch_dtype), cfg)
    caches = init_caches(params, cfg, toks.shape[0], 64, device=dev)
    logits, caches = prefill_chunk(params, toks, caches, 0, cfg, enc)
    first = logits[:, -1].argmax(-1)[:, None]
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        decode_epoch(params, first, caches, toks.shape[1], cfg, k,
                     next_token_fn=lambda lg: lg[:, -1].argmax(-1),
                     enc_out=enc, plan=plan)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return _median(times[1:])


def e2e_tp_main_path(dev, counters, cases=None, kinds: bool = True):
    """Every family at tp = 2 against tp = 1 on one card (:data:`E2E_TP`):
    weights from one seed, placed whole and on a ``[dev, dev]`` group
    (``shard_params``; olmoe under each MoE mode), the same inputs through
    :func:`_tp_run`.  Gates: :func:`_gate` (2e-2 of the largest logit)
    on every prefill and decode logit; tp = 2 bitwise on a repeat; with
    ``kinds``, the plan kernels' launches (counters zeroed just before
    each run and read just after; tp = 2's into ``counters``): cache_matmul
    and block_fused_ffn launched, at tp = 2 twice tp = 1's on a shard's
    d_ff slice and never on a whole FFN weight, except under ``"fsdp"``,
    where each expert runs whole, once, on the shard that holds it."""
    import torch
    from repro_torch.distributed import sharding, tensor_parallel as tp
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import model as M
    from repro_torch.models.base import get_arch
    group = make_serving_mesh(1, tp=2, devices=_fleet_devices(dev, 2))
    res = {}
    for arch, mode, layers in cases or E2E_TP:
        label = arch if mode is None else f"{arch}/{mode}"
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        plans = _tp_plans(cfg)
        rng = np.random.default_rng(11)
        n_pre = {"vlm": cfg.num_patches, "encdec": cfg.enc_len}.get(cfg.family)
        inputs = (rng.integers(0, cfg.vocab_size, (2, 40)),
                  rng.integers(0, cfg.vocab_size, (2, 8)),
                  rng.integers(0, cfg.vocab_size, (2, 9)),
                  None if n_pre is None else
                  rng.standard_normal((2, n_pre, cfg.d_model)).astype(
                      np.float32))
        one = M.init_params(cfg, seed=5, device=dev)
        sharding.set_moe_mode(mode or "fsdp")
        try:
            two = tp.shard_params(one, group)
        finally:
            sharding.set_moe_mode("fsdp")
        _zero_counters()
        pf1, dec1 = _tp_run(cfg, one, dev, plans, inputs)
        c1 = _counters()
        ms1 = _decode_ms(cfg, one, dev, inputs, plans["LWM"])
        del one
        _zero_counters()
        pf2, dec2 = _tp_run(cfg, two, dev, plans, inputs)
        c2 = _counters()
        pf2b, dec2b = _tp_run(cfg, two, dev, plans, inputs)
        ms2 = _decode_ms(cfg, two, dev, inputs, plans["LWM"])
        del two
        _release()
        for k, v in c2.items():
            counters[k] = counters.get(k, 0) + v
        V = cfg.vocab_size
        rec = {"layers": layers, "moe_mode": mode,
               "plans": {k: p.describe() for k, p in plans.items()},
               "prefill": _gate(pf2[..., :V], pf1[..., :V],
                                f"e2e_tp {label} prefill"),
               "decode": _gate(dec2[..., :V], dec1[..., :V],
                               f"e2e_tp {label} decode"),
               "bitwise_repeat": bool(torch.equal(pf2, pf2b)
                                      and torch.equal(dec2, dec2b)),
               "launches": {k: v for k, v in c2.items() if v},
               "launches_tp1": {k: v for k, v in c1.items() if v},
               "decode_step_ms": ms2, "decode_step_ms_tp1": ms1}
        if not rec["bitwise_repeat"]:
            raise AssertionError(f"e2e_tp {label}: a repeat differs")
        if kinds and cfg.family != "ssm":
            d, f = cfg.d_model, cfg.d_ff
            whole = {f"cache_matmul@{d}x{f}", f"cache_matmul@{f}x{d}",
                     f"block_fused_ffn@{d}x{f}"}
            per = 1 if mode == "fsdp" else 2
            for k in ("cache_matmul", "block_fused_ffn"):
                if c1[k] <= 0 or c2[k] != per * c1[k]:
                    raise AssertionError(f"e2e_tp {label}: {k} {c2[k]} "
                                         f"launches at tp = 2, {c1[k]} at "
                                         f"tp = 1")
            hit = sorted(k for k in whole if c2[k])
            if mode != "fsdp" and hit:
                raise AssertionError(f"e2e_tp {label}: launches on a whole "
                                     f"FFN weight: {hit}")
        if kinds and cfg.family in ("ssm", "hybrid") and (
                c1["ssd_chunk"] <= 0 or c2["ssd_chunk"] != c1["ssd_chunk"]):
            raise AssertionError(f"e2e_tp {label}: ssd_chunk {c2['ssd_chunk']}"
                                 f" at tp = 2, {c1['ssd_chunk']} at tp = 1")
        res[label] = rec
    return res


def example_main_path(dev):
    """The serve example at full width in a process of its own
    (``python -m repro_torch.examples.multi_tenant_serve --full-width
    --steps 6``): gated on rc 0 and its two reports; its output goes to
    ``example.log``."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.examples.multi_tenant_serve",
           "--full-width", "--steps", "6", "--device", dev]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "example.log").write_text(proc.stdout + proc.stderr)
    lines = proc.stdout.splitlines()
    reports = [ln for ln in lines if ln.lstrip().startswith("throughput")]
    if proc.returncode != 0 or len(reports) != 2:
        raise AssertionError(f"example: rc {proc.returncode}, "
                             f"{len(reports)} reports: "
                             f"{proc.stderr[-3000:]}")
    return {"cmd": " ".join(cmd[1:]), "rc": proc.returncode,
            "report": lines}


# -------------------------------------------------------------- train --
def _median(xs):
    xs = sorted(xs)
    return xs[(len(xs) - 1) // 2]


def _plain_ssd_train(fn):
    """``fn()`` with ssd_chunk's and ssd_chunk_bwd's plain versions in
    place of the kernels (a control run: it launches neither)."""
    from repro_torch.kernels import ssd_scan as kssd
    fwd, bwd = kssd.ssd_chunk, kssd.ssd_chunk_bwd
    kssd.ssd_chunk, kssd.ssd_chunk_bwd = _ssd_plain, _ssd_bwd_plain
    try:
        return fn()
    finally:
        kssd.ssd_chunk, kssd.ssd_chunk_bwd = fwd, bwd


def _grads(cfg, params, batch, remat: bool = True):
    """(loss, the gradient of every param in tree order) of
    ``models/model.py::loss_fn`` with or without remat."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    loss, _, grads = M._value_and_grad(params, batch, cfg, remat=remat)
    return loss, adamw.tree_leaves(grads)


def _train_batch(cfg, dev, batch: int, seq_len: int, seed: int):
    """One synthetic batch (data/pipeline.py) on ``dev``."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    b = SyntheticTokens(DataConfig(cfg.vocab_size, seq_len, batch,
                                   seed=seed)).batch_at(0)
    return {k: torch.from_numpy(v).long().to(dev) for k, v in b.items()}


def _cosine(got, want) -> float:
    """Cosine of two gradient lists, each flattened into one vector."""
    import torch
    a = torch.cat([g.float().reshape(-1) for g in got])
    b = torch.cat([g.float().reshape(-1) for g in want])
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def train_grad_gates(cfg, dev):
    """The train step's gradients on the card.  At full width cut to 2
    layers in fp32 (the simt kinds), :data:`GRAD_BATCH`: the loss and
    every gradient with the kernels within :data:`TOL` (relative to each
    gradient's largest magnitude) of the same step with ssd_chunk and its
    backward swapped for their plain versions; 4 forward launches (2
    layers, again under remat) and 2 backward, of the simt kind; remat on
    == off bitwise.
    At full depth in bf16: the kernel path's 1 - cosine to the gradients
    of an fp32 copy of the weights within :data:`SSM_BF16_SPREAD` times
    the plain-path control's, or :data:`SSM_BF16_FLOOR`."""
    import torch
    from repro_torch.models import model as M
    c2 = dataclasses.replace(cfg, name=f"{cfg.name}-2layer-fp32",
                             num_layers=2, dtype="float32")
    p2 = M.init_params(c2, seed=3, device=dev)
    batch = _train_batch(c2, dev, GRAD_BATCH["batch"], GRAD_BATCH["seq_len"],
                         seed=11)
    _zero_counters()
    loss_k, g_k = _grads(c2, p2, batch)
    launched = {k: _counters()[k] for k in ("ssd_chunk", "ssd_chunk_bwd",
                                            "ssd_chunk_bwd.simt")}
    if launched != {"ssd_chunk": 4, "ssd_chunk_bwd": 2,
                    "ssd_chunk_bwd.simt": 2}:
        raise AssertionError(f"train_ssm fp32: launches {launched}")
    loss_p, g_p = _plain_ssd_train(lambda: _grads(c2, p2, batch))
    errs = [_close_scaled(a, b, TOL["float32"]) for a, b in zip(g_k, g_p)]
    loss_err = abs(float(loss_k) - float(loss_p))
    loss_off, g_off = _grads(c2, p2, batch, remat=False)
    remat_bitwise = bool(torch.equal(loss_off, loss_k) and all(
        torch.equal(a, b) for a, b in zip(g_off, g_k)))
    fp32 = {"layers": 2, "batch": GRAD_BATCH, "launches": launched,
            "loss": float(loss_k), "loss_vs_plain": loss_err,
            "max_grad_err_vs_plain": max(e for e, _ in errs),
            "tol_relative": TOL["float32"], "remat_bitwise": remat_bitwise}
    if (not all(ok for _, ok in errs) or remat_bitwise is not True
            or loss_err > TOL["float32"] * abs(float(loss_p))):
        raise AssertionError(f"train_ssm fp32 gradients: {fp32}")
    del p2, g_k, g_p, g_off
    pb = M.init_params(cfg, seed=4, device=dev)
    batch = _train_batch(cfg, dev, GRAD_BATCH["batch"], GRAD_BATCH["seq_len"],
                         seed=12)
    loss_b, g_b = _grads(cfg, pb, batch)
    loss_c, g_c = _plain_ssd_train(lambda: _grads(cfg, pb, batch))
    c32 = dataclasses.replace(cfg, dtype="float32")
    loss_32, g_32 = _grads(c32, _to_dtype(pb, torch.float32), batch)
    finite = all(bool(torch.isfinite(g).all()) for g in g_b)
    cos_k, cos_c = _cosine(g_b, g_32), _cosine(g_c, g_32)
    limit = max(SSM_BF16_SPREAD * (1.0 - cos_c), SSM_BF16_FLOOR)
    bf16 = {"layers": cfg.num_layers, "loss": float(loss_b),
            "loss_plain_control": float(loss_c), "loss_fp32": float(loss_32),
            "cosine_to_fp32": cos_k, "control_cosine_to_fp32": cos_c,
            "limit_one_minus_cosine": limit, "finite": finite}
    if not finite or 1.0 - cos_k > limit:
        raise AssertionError(f"train_ssm bf16 gradients: {bf16}")
    return {"fp32_2layer": fp32, "bf16_full_depth": bf16}


def train_ssm_main_path(cfg, dev, counters):
    """The training slice's main path: ``launch/train.py::main`` on
    full-width, full-depth mamba2 (bf16, remat, :data:`TRAIN_SSM`), its
    counters zeroed just before and read just after: 96 forward
    ssd_chunk launches a step (48 layers, again under remat), all of the
    wgmma kind, and 48 ssd_chunk_bwd, all of the wgmma kind too (the
    forward's); no other kernel.  The loss finite
    and falling, no supervisor restart.  Then the resume: the checkpoint
    of step 5 restored (``TrainSupervisor.restore``) into a fresh
    ``build`` and :data:`RESUME_STEPS` steps replayed on the batches of
    steps 5 and 6: the restored step and the losses as the first run's.
    Step ms (median host time of the steps after the first), tokens/s,
    model FLOP/s (6 x params x tokens, remat's recompute not counted) as
    a share of the bf16 peak, peak memory, one profiled step (idle share,
    ssd_chunk forward / backward shares), the checkpoint's bytes and a
    synchronous save's seconds; then :func:`train_grad_gates`.  The
    checkpoint directory is removed."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                         TrainSupervisor)
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    T, steps = TRAIN_SSM, TRAIN_SSM["steps"]
    ckpt_dir = OUT_DIR.parent / "train_ssm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = ["--arch", cfg.name, "--steps", str(steps), "--seq-len",
            str(T["seq_len"]), "--global-batch", str(T["global_batch"]),
            "--lr", str(T["lr"]), "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(T["ckpt_every"]), "--device", dev]
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_counters()
        t0 = time.perf_counter()
        run = train.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters.update(_counters())
        peak = torch.cuda.max_memory_allocated()
        losses = run["losses"]
        want = {"ssd_chunk": 2 * cfg.num_layers * steps,
                "ssd_chunk_bwd": cfg.num_layers * steps,
                "ssd_chunk_bwd.wgmma": cfg.num_layers * steps,
                "ssd_chunk_bwd.simt": 0}
        others = {k: counters[k] for k in PREFILL_KERNELS
                  + ("cache_matmul_quant",) if counters[k]}
        if (not all(math.isfinite(v) for v in losses)
                or not losses[-1] < losses[0] or run["restarts"]
                or any(counters[k] != v for k, v in want.items()) or others):
            raise AssertionError(f"train_ssm: losses {losses}, restarts "
                                 f"{run['restarts']}, launches {counters}")
        _gate_kinds(counters, "train_ssm", ssd=("wgmma",))
        ckpt_bytes = ckpt.checkpoint_bytes(ckpt_dir / f"step_{steps:08d}")
        # the resume: step 5's checkpoint, a fresh build, two steps
        resume_at = T["ckpt_every"]
        (ckpt_dir / "LATEST").write_text(f"step_{resume_at:08d}")
        opt_cfg = adamw.AdamWConfig(lr=T["lr"],
                                    warmup_steps=max(steps // 10, 1),
                                    total_steps=steps)
        _, params, opt_state, step_fn, batch_at = train.build(
            cfg.name, False, T["seq_len"], T["global_batch"], opt_cfg,
            device=dev)
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(ckpt_dir)))
        t0 = time.perf_counter()
        params, opt_state, start = sup.restore((params, opt_state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = []
        for k in range(start, start + RESUME_STEPS):
            params, opt_state, m = step_fn(params, opt_state, batch_at(k))
            resumed.append(float(m["loss"]))
        first = losses[start:start + RESUME_STEPS]
        resume = {"restored_step": start, "opt_step": int(opt_state.step),
                  "losses": resumed, "first_run_losses": first,
                  "bitwise": resumed == first, "restore_s": restore_s}
        if (start != resume_at or int(opt_state.step) != start + RESUME_STEPS
                or any(abs(a - b) > 1e-5 * abs(b)
                       for a, b in zip(resumed, first))):
            raise AssertionError(f"train_ssm resume: {resume}")
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, 0, {"params": params, "opt": opt_state},
                  extra={"step": 0})
        save_s = time.perf_counter() - t0
        batch = batch_at(start + RESUME_STEPS)
        profile = _profile(
            lambda: float(step_fn(params, opt_state, batch)[2]["loss"]),
            shares=("ssd_chunk_wgmma", "ssd_chunk_bwd"))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_params = sum(p.numel() for p in adamw.tree_leaves(params))
    del params, opt_state
    step_s = _median(run["step_seconds"][1:])
    tokens = T["global_batch"] * T["seq_len"]
    gates = train_grad_gates(cfg, dev)
    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            **T, "params": n_params, "losses": losses,
            "restarts": run["restarts"], "launches": dict(counters),
            "launches_per_step": {k: counters[k] / steps for k in want},
            "wall_s": wall, "step_seconds": run["step_seconds"],
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "model_flops_share": 6 * n_params * tokens / step_s
            / PEAK_FLOPS["bfloat16"],
            "peak_memory_bytes": peak, "allocated_at_start_bytes": base,
            "checkpoint_bytes": ckpt_bytes,
            "checkpoint_save_s": save_s, "resume": resume,
            "profile": profile, "gates": gates}


def train_100m_main_path(dev, counters):
    """``repro_torch.examples.train_100m --full`` (lm-100m: 12 layers,
    d 768, fp32) for :data:`TRAIN_100M` steps on the card, its mid-run
    preemption and resume included; counters zeroed just before and
    read just after (a dense model trains without plans, so no kernel
    launches).  Gates: the loss falls (the example asserts it), the
    resume restores the step of the preemption, no restart.  Tokens/s
    from the median step (8 x 128 tokens)."""
    from repro_torch.examples import train_100m
    steps = TRAIN_100M["steps"]
    _zero_counters()
    t0 = time.perf_counter()
    run = train_100m.main(["--full", "--steps", str(steps), "--device", dev])
    wall = time.perf_counter() - t0
    counters.update(_counters())
    if run["resumed_at"] != run["preempted_at"] or run["restarts"]:
        raise AssertionError(f"train_100m: {run}")
    step_s = _median(run["step_seconds"][1:])
    return {"arch": run["cfg"].name, "params": run["cfg"].param_count(),
            "steps": steps, "losses": [run["losses"][0], run["losses"][-1]],
            "preempted_at": run["preempted_at"],
            "resumed_at": run["resumed_at"], "wall_s": wall,
            "step_ms": step_s * 1e3, "tokens_per_s": 8 * 128 / step_s,
            "launches": {k: v for k, v in counters.items() if v}}


def train_cli_main_path(dev, counters):
    """``launch/train.py::main`` with ``--smoke`` on the card for each of
    the six families (:data:`TRAIN_CLI`): the loss falls (main asserts
    it), no restart, ssd_chunk and ssd_chunk_bwd launched by the SSM and
    hybrid configs (fp32: the simt kinds) and no kernel by the others.
    Then reduced olmoe in bf16 (registered as its own config): main
    again, and one step's expert gradients, which come through
    ``models/moe.py::_dot_f32``'s card branch (a bf16 bmm into fp32),
    finite, non-zero and in bf16."""
    import shutil
    import torch
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.base import get_arch, register
    T = TRAIN_CLI
    root = OUT_DIR.parent / "train_cli_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    bf16 = register(dataclasses.replace(
        get_arch(MOE_ARCH).reduced(), name=f"{MOE_ARCH}-smoke-bf16",
        dtype="bfloat16"))
    runs = {}
    try:
        for arch in ("yi-9b", MOE_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH,
                     VLM_ARCH):
            _zero_counters()
            t0 = time.perf_counter()
            r = train.main(["--arch", arch, "--smoke", "--steps",
                            str(T["steps"]), "--seq-len", str(T["seq_len"]),
                            "--global-batch", str(T["global_batch"]), "--lr",
                            str(T["lr"]), "--ckpt-dir", str(root / arch),
                            "--device", dev])
            launched = {k: v for k, v in _counters().items() if v}
            counters.update({f"{arch}.{k}": v for k, v in launched.items()})
            runs[arch] = {"losses": [r["losses"][0], r["losses"][-1]],
                          "restarts": r["restarts"], "launches": launched,
                          "wall_s": time.perf_counter() - t0}
            ssm = arch in (SSM_ARCH, HYBRID_ARCH)
            if r["restarts"] or (ssm and not (
                    launched.get("ssd_chunk.simt") and launched.get(
                        "ssd_chunk_bwd"))) or (not ssm and launched):
                raise AssertionError(f"train_cli {arch}: {runs[arch]}")
        _zero_counters()
        r = train.main(["--arch", bf16.name, "--steps", str(T["steps"]),
                        "--seq-len", str(T["seq_len"]), "--global-batch",
                        str(T["global_batch"]), "--lr", str(T["lr"]),
                        "--ckpt-dir", str(root / bf16.name), "--device", dev])
        params = M.init_params(bf16, seed=0, device=dev)
        _, _, grads = M._value_and_grad(
            params, _train_batch(bf16, dev, T["global_batch"], T["seq_len"],
                                 seed=3), bf16)
        experts = [g for layer in grads["layers"]
                   for g in (layer["mlp"]["gate"], layer["mlp"]["up"],
                             layer["mlp"]["down"])]
        norms = [float(g.float().norm()) for g in experts]
        runs[bf16.name] = {"losses": [r["losses"][0], r["losses"][-1]],
                           "restarts": r["restarts"],
                           "expert_grad_norms": norms,
                           "expert_grad_dtypes": sorted({_dtype_name(g.dtype)
                                                         for g in experts})}
        if (r["restarts"] or not all(math.isfinite(n) and n > 0
                                     for n in norms)
                or any(g.dtype != torch.bfloat16 for g in experts)):
            raise AssertionError(f"train_cli bf16 olmoe: {runs[bf16.name]}")
        del params, grads, experts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"runs": runs, **T}


def _dryrun_trace(cfg, shape):
    """``launch/dryrun.py``'s trace of ``shape``'s step at a (1, 1)
    group, with its argument bytes from the specs.  Gated: the trace
    launches no kernel and moves the card's allocations by nothing."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    mesh = D.ServingMesh(np.empty((1, 1), dtype=object))
    torch.cuda.synchronize()
    _zero_counters()
    before = torch.cuda.memory_allocated()
    trace = D.trace_step(cfg, shape, mesh)
    with FakeTensorMode():
        args = D.argument_bytes(cfg, shape, mesh)
    launched = {k: v for k, v in _counters().items() if v}
    moved = torch.cuda.memory_allocated() - before
    if launched or moved:
        raise AssertionError(f"dryrun: the trace of {cfg.name} launched "
                             f"{launched}, moved {moved} bytes on the card")
    return trace, args


def _tree_bytes(tree):
    from repro_torch.optim import adamw
    return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree))


def _measured(step, args, timed: int):
    """A real call of ``step`` on the card: FLOPs under
    ``FlopCounterMode`` (one call), then the peak above what was
    allocated before (one call after ``reset_peak_memory_stats``), then
    the median ms of ``timed`` calls.  ``args`` is a list: a train
    step's new params and state replace the old ones after each call."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    def call():
        out = step(*args)
        if isinstance(out, tuple) and len(out) == 3:   # a train step
            args[0], args[1] = out[0], out[1]
        return out
    with FlopCounterMode(display=False) as fc:
        call()
    torch.cuda.synchronize()
    _release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = []
    for _ in range(timed):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"flops": fc.get_total_flops(), "peak_above_args": peak,
            "ms": _median(ms), "ms_all": ms}


def _dryrun_cell(cfg, shape, trace, args_bytes, live_bytes, measured, hw):
    """The record of one traced cell beside its run on the card."""
    from repro_torch.launch import dryrun as D
    c = trace.counter
    rf = c.roofline(0, hw)
    predicted = trace.args_bytes[0] + c.peak[0]
    measured_peak = live_bytes + measured["peak_above_args"]
    return {"arch": cfg.name, "kind": shape.kind,
            "batch": shape.global_batch, "seq_len": shape.seq_len,
            "trace_s": trace.trace_s,
            "argument_bytes": args_bytes, "live_argument_bytes": live_bytes,
            "temp_bytes": c.peak[0], "predicted_peak_bytes": predicted,
            "measured_peak_bytes": measured_peak,
            "peak_ratio": predicted / measured_peak,
            "traced_flops": c.flops[0], "measured_flops": measured["flops"],
            "hbm_bytes": c.hbm_bytes[0],
            "model_flops": D._model_flops_per_chip(cfg, shape, 1),
            "bound_ms": rf.bound_s * 1e3, "bound_by": rf.dominant,
            "compute_ms": rf.compute_s * 1e3, "memory_ms": rf.memory_s * 1e3,
            "measured_ms": measured["ms"], "measured_ms_all":
            measured["ms_all"]}


def dryrun_main_path(dev, cells=None):
    """The dry run against the card (:data:`DRYRUN`; ``cells`` replaces
    its prefill and train entries, for a rehearsal at reduced widths):
    see the module docstring's ``dryrun``."""
    import os
    import shutil
    import torch
    from repro_torch.launch import cost_analysis
    from repro_torch.models import model as M
    from repro_torch.models.base import get_arch
    from repro_torch.optim import adamw
    T = {**DRYRUN, **(cells or {})}
    hw = cost_analysis.hardware(dev)
    out = {"hardware": hw}
    gen = torch.Generator(device=dev)

    def tokens(cfg, b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             dtype=torch.int32, device=dev)

    # yi-9b's plan-less prefill: every number gated
    P = T["prefill"]
    cfg = get_arch(P["arch"])
    shape = M.ShapeSpec("prefill", P["seq_len"], P["batch"], "prefill")
    trace, args_bytes = _dryrun_trace(cfg, shape)
    gen.manual_seed(0)
    params = M.init_params(cfg, seed=0, device=dev)
    args = [params, {"tokens": tokens(cfg, P["batch"], P["seq_len"]),
                     "labels": tokens(cfg, P["batch"], P["seq_len"])}]
    live = _tree_bytes(args)
    measured = _measured(M.make_prefill(cfg), args, T["timed"])
    rec = _dryrun_cell(cfg, shape, trace, args_bytes, live, measured, hw)
    del params, args
    _release()
    if (rec["argument_bytes"] != live
            or rec["traced_flops"] != rec["measured_flops"]
            or abs(rec["peak_ratio"] - 1) > T["peak_tol"]):
        raise AssertionError(f"dryrun prefill: {rec}")
    out["prefill"] = rec

    # mamba2's train step: the arguments and FLOPs gated, the rest
    # recorded
    R = T["train"]
    cfg = get_arch(R["arch"])
    shape = M.ShapeSpec("train", R["seq_len"], R["batch"], "train")
    trace, args_bytes = _dryrun_trace(cfg, shape)
    params = M.init_params(cfg, seed=0, device=dev)
    args = [params, adamw.init(params),
            {"tokens": tokens(cfg, R["batch"], R["seq_len"]),
             "labels": tokens(cfg, R["batch"], R["seq_len"])}]
    live = _tree_bytes(args)
    _zero_counters()
    measured = _measured(M.make_train_step(cfg), args, R["steps"])
    launches = {k: v for k, v in _counters().items() if v}
    rec = _dryrun_cell(cfg, shape, trace, args_bytes, live, measured, hw)
    rec["launches"] = launches
    del params, args
    _release()
    if (rec["argument_bytes"] != live
            or rec["traced_flops"] != rec["measured_flops"]):
        raise AssertionError(f"dryrun train: {rec}")
    out["train"] = rec

    # the CLI in processes of their own, then the table over its report,
    # both with their report folder in OUT_DIR
    C = T["cli"]
    reports = OUT_DIR / "dryrun_torch"
    shutil.rmtree(reports, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def cli(module, *argv):
        # the module's main with REPORT_DIR set to ``reports``
        code = (f"import sys, pathlib\nfrom repro_torch.launch import "
                f"{module} as m\nm.REPORT_DIR = pathlib.Path(sys.argv[1])\n"
                f"raise SystemExit(m.main(sys.argv[2:]))")
        return [sys.executable, "-c", code, str(reports), *argv]
    argv = ["--arch", C["arch"], "--shape", C["shape"], "--multi-pod",
            "--roofline"] + (["--device", "cpu"] if dev == "cpu" else [])
    t0 = time.perf_counter()
    run = subprocess.run(cli("dryrun", *argv), capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    cli_s = time.perf_counter() - t0
    table = subprocess.run(cli("roofline", "--mesh", "2x16x16"),
                           capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=120)
    if (run.returncode or "0 failures" not in run.stdout
            or table.returncode or C["arch"] not in table.stdout):
        raise AssertionError(f"dryrun CLI: rc {run.returncode} "
                             f"{run.stdout[-2000:]} {run.stderr[-2000:]}; "
                             f"table rc {table.returncode} {table.stdout}")
    report = json.loads((reports / f"{C['arch']}__{C['shape']}__"
                         "2x16x16.json").read_text())
    out["cli"] = {"seconds": cli_s, "stdout": run.stdout.splitlines(),
                  "table": table.stdout.splitlines(),
                  "argument_bytes": report["argument_size_in_bytes"],
                  "xla_argument_bytes": T["xla_argument_bytes"],
                  "output_bytes": report["output_size_in_bytes"],
                  "temp_bytes": report["temp_size_in_bytes"],
                  "trace_s": report["trace_s"]}
    return out


def _paper_driver(name: str):
    """``repro_torch.paper.<name>``: (its ``run(verbose=False)``, the
    CSV line its ``main()`` emits over that result with the run's wall
    time, and the wall seconds)."""
    import contextlib
    import importlib
    import io
    from repro_torch.paper import common
    mod = importlib.import_module(f"repro_torch.paper.{name}")
    t0 = time.perf_counter()
    res = mod.run(verbose=False)
    secs = time.perf_counter() - t0
    run, mod.run = mod.run, lambda verbose=True: res
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        mod.run = run
    return res, f"{name},{secs * 1e6:.0f},{common.RESULTS[name]['derived']}", secs


def _in_band(value, band) -> bool:
    want, kind, tol = band
    return abs(value - want) <= (tol * abs(want) if kind == "rel" else tol)


def paper_main_path():
    """The paper's figures from the port alone: every driver of
    :data:`PAPER` and the quickstart, then the reference's bands
    (:data:`PAPER_BANDS`).  A broken band fails the phase."""
    import os
    from repro_torch.core.cache import CacheConfig, SharedCache
    from repro_torch.core.codegen import run_candidate
    from repro_torch.core.mapping import MapperConfig, map_layer_lwm
    from repro_torch.core.nec import Nec
    from repro_torch.core.types import GemmDims, LayerKind, LayerSpec
    from repro_torch.sim.area import cache_slice_area, npu_area
    B = PAPER_BANDS
    out, results, broken = {"drivers": {}}, {}, []
    for name in PAPER:
        results[name], csv, secs = _paper_driver(name)
        out["drivers"][name] = {"seconds": secs, "csv": csv}
    t0 = time.perf_counter()
    qs = subprocess.run([sys.executable, "-m",
                         "repro_torch.examples.quickstart"],
                        capture_output=True, text=True, timeout=300,
                        env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=ROOT)
    out["quickstart"] = {"seconds": time.perf_counter() - t0,
                         "rc": qs.returncode, "lines": qs.stdout.splitlines()}
    if (qs.returncode or not qs.stdout.splitlines()
            or not qs.stdout.splitlines()[-1].startswith("Makespan")):
        broken.append(f"quickstart rc {qs.returncode}: {qs.stderr[-2000:]}")

    f7 = out["fig7"] = results["fig7_speedup"]
    lo, hi = B["speedup_avg"]
    if not (lo <= f7["avg_full"] <= hi and f7["max_full"] <= B["speedup_max"]):
        broken.append(f"fig7 speedup avg {f7['avg_full']} max "
                      f"{f7['max_full']}")
    lo, hi = B["mem_reduction"]
    if not lo <= f7["mem_reduction"] <= hi:
        broken.append(f"fig7 memory reduction {f7['mem_reduction']}")
    areas = {"npu": (npu_area(), "NPU"),
             "slice": (cache_slice_area(), "Cache Slice")}
    out["area"] = {}
    for part, (a, whole) in areas.items():
        for key, band in B[part].items():
            v = a[key] if key == whole else a[key] / a[whole]
            out["area"][f"{part}/{key}"] = v
            if not _in_band(v, band):
                broken.append(f"area {part}/{key} {v} outside {band}")
    r = results["fig3_reuse"]
    reuse = {"no_reuse": r.pct_no_reuse, "over_1mb": r.pct_distance_over(2**20),
             "over_2mb": r.pct_distance_over(2 * 2**20)}
    out["reuse"] = reuse
    for key in ("no_reuse", "over_1mb"):
        lo, hi = B[key]
        if not lo <= reuse[key] <= hi:
            broken.append(f"reuse {key} {reuse[key]} outside {B[key]}")
    if reuse["over_2mb"] > reuse["over_1mb"]:
        broken.append(f"reuse >2MB {reuse['over_2mb']} above >1MB")
    out["codegen"] = []
    for m, k, n, budget in B["codegen"]:
        layer = LayerSpec("l", LayerKind.GEMM, (GemmDims(m, n, k),),
                          input_bytes=m * k, output_bytes=m * n,
                          weight_bytes=k * n, elem_bytes=1)
        cand = map_layer_lwm(layer, budget, MapperConfig())
        cache = SharedCache(CacheConfig())
        executed = run_candidate(layer, cand, cache, Nec(cache), "t")
        out["codegen"].append({"case": [m, k, n, budget],
                               "executed": executed,
                               "analytic": cand.dram_bytes})
        if (abs(executed - cand.dram_bytes) > B["codegen_rel"]
                * cand.dram_bytes
                or cache.free_pages != cache.config.num_pages):
            broken.append(f"codegen {m}x{k}x{n}@{budget}: executed "
                          f"{executed} vs analytic {cand.dram_bytes}")
    banned = ("jax", "jaxlib", "flax", "repro", "benchmarks")
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in banned)
    if loaded:
        broken.append(f"loaded {loaded}")
    out["bands"] = {k: v for k, v in B.items() if k != "codegen"}
    if broken:
        raise AssertionError(f"paper: {broken}")
    return out


def _release():
    """Free what the last phase left before the next one starts: collect
    its reference cycles (a server and its tenants refer to each other),
    so that their device tensors go, then return the cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    (OUT_DIR / "phases.jsonl").unlink(missing_ok=True)
    from repro_torch.models.base import get_arch, register
    cfg, ssm_cfg = get_arch("yi-9b"), get_arch(SSM_ARCH)
    moe_cfg, hybrid_cfg = get_arch(MOE_ARCH), get_arch(HYBRID_ARCH)
    encdec_cfg, vlm_cfg = get_arch(ENCDEC_ARCH), get_arch(VLM_ARCH)
    kimi_cfg = get_arch(dict((l, a) for l, a, _ in MORE_ARCHS)["kimi"])
    dev = "cuda"
    report = {}
    report["device"] = _phase("device", device_info)
    report["build"] = _phase("build", build_kernels)
    report["kernels"] = _phase("kernels", check_kernels, cfg, ssm_cfg,
                               moe_cfg, hybrid_cfg, encdec_cfg, vlm_cfg,
                               kimi_cfg, dev)
    if report["kernels"]["failed"]:
        raise AssertionError(f"kernels disagree: {report['kernels']['failed']}")
    _release()
    report["e2e"] = _phase("e2e", check_e2e, cfg, dev)
    _release()
    serve_counts, prefill_counts = {}, {}
    report["serve"] = _phase("serve", serve_main_path, cfg, dev, serve_counts)
    _release()
    report["self"] = _phase("self", check_serial_pipelined, cfg, dev)
    _release()
    report["graphs"] = _phase("graphs", check_graphs, cfg, ssm_cfg, dev,
                              moe_cfg=moe_cfg, hybrid_cfg=hybrid_cfg,
                              encdec_cfg=encdec_cfg)
    _release()
    report["prefill"] = _phase("prefill", prefill_main_path, cfg, dev,
                               prefill_counts)
    _release()
    serve_kv_counts, ffn_quant_counts, found = {}, {}, {}
    report["serve_kv"] = _phase("serve_kv", serve_kv_main_path, cfg, dev,
                                serve_kv_counts, found)
    decode_plan = found["decode_plan"]
    _release()
    report["ffn_quant"] = _phase("ffn_quant", ffn_quant_main_path, cfg, dev,
                                 decode_plan, ffn_quant_counts)
    _release()
    report["e2e_ssm"] = _phase("e2e_ssm", check_e2e_ssm, ssm_cfg, dev)
    _release()
    prefill_ssm_counts, serve_ssm_counts = {}, {}
    report["prefill_ssm"] = _phase("prefill_ssm", prefill_ssm_main_path,
                                   ssm_cfg, dev, prefill_ssm_counts)
    _release()
    report["serve_ssm"] = _phase("serve_ssm", serve_ssm_main_path, ssm_cfg,
                                 dev, serve_ssm_counts)
    _release()
    report["self_ssm"] = _phase("self_ssm", check_serial_pipelined_ssm,
                                ssm_cfg, dev, {})
    _release()
    report["e2e_moe"] = _phase("e2e_moe", check_e2e_moe, moe_cfg, dev)
    _release()
    prefill_moe_counts, serve_moe_counts, serve_mix_counts = {}, {}, {}
    report["prefill_moe"] = _phase(
        "prefill_moe", prefill_main_path, moe_cfg, dev, prefill_moe_counts,
        label="prefill_moe", plans=moe_prefill_plans(moe_cfg),
        serve=("LWM/native",),
        profiled=("plain", "LBM/native", "LWM/native", "LWM/int8"))
    _release()
    report["serve_moe"] = _phase(
        "serve_moe", serve_main_path, moe_cfg, dev, serve_moe_counts,
        label="serve_moe", kernels=False, shares=(GATHER_KERNEL,),
        **SERVE_MOE)
    _release()
    report["self_moe"] = _phase("self_moe", check_serial_pipelined_moe,
                                moe_cfg, dev)
    _release()
    report["serve_mix"] = _phase("serve_mix", serve_mix_main_path, dev,
                                 serve_mix_counts)
    _release()
    report["serve_prefix"] = _phase("serve_prefix", serve_prefix_main_path,
                                    dev, {})
    _release()
    report["serve_faults"] = _phase("serve_faults", serve_faults_main_path,
                                    dev, {})
    _release()
    report["lookahead"] = _phase("lookahead", lookahead_main_path, dev, {})
    _release()
    report["e2e_hybrid"] = _phase("e2e_hybrid", check_e2e_hybrid, hybrid_cfg,
                                  dev)
    _release()
    prefill_hybrid_counts, serve_hybrid_counts = {}, {}
    report["prefill_hybrid"] = _phase(
        "prefill_hybrid", prefill_main_path, hybrid_cfg, dev,
        prefill_hybrid_counts, label="prefill_hybrid",
        plans=hybrid_prefill_plans(hybrid_cfg),
        profiled=("plain", "LBM/native", "LWM/native", "LWM/int8"))
    _release()
    report["serve_hybrid"] = _phase("serve_hybrid", serve_hybrid_main_path,
                                    hybrid_cfg, dev, serve_hybrid_counts)
    _release()
    one_group = register(dataclasses.replace(
        hybrid_cfg, name=f"{HYBRID_ARCH}-{hybrid_cfg.attn_every}layer",
        num_layers=hybrid_cfg.attn_every))
    report["self_hybrid"] = _phase("self_hybrid", check_serial_pipelined_ssm,
                                   one_group, dev, {})
    _release()
    report["e2e_encdec"] = _phase("e2e_encdec", check_e2e_encdec, encdec_cfg,
                                  dev)
    _release()
    serve_encdec_counts, prefill_vlm_counts, serve_vlm_counts = {}, {}, {}
    report["serve_encdec"] = _phase("serve_encdec", serve_encdec_main_path,
                                    encdec_cfg, dev, serve_encdec_counts)
    _release()
    report["self_encdec"] = _phase("self_encdec", check_serial_pipelined_ssm,
                                   encdec_cfg, dev, {})
    _release()
    report["e2e_vlm"] = _phase("e2e_vlm", check_e2e_vlm, vlm_cfg, dev)
    _release()
    report["prefill_vlm"] = _phase(
        "prefill_vlm", prefill_main_path, vlm_cfg, dev, prefill_vlm_counts,
        label="prefill_vlm", plans=vlm_prefill_plans(vlm_cfg),
        prefix=vlm_cfg.num_patches,
        profiled=("plain", "LBM/native", "LWM/native", "LWM/int8"))
    _release()
    report["serve_vlm"] = _phase("serve_vlm", serve_arch_main_path, vlm_cfg,
                                 dev, serve_vlm_counts)
    _release()
    more_counts = {}       # label: (prefill counts, serve counts)
    for label, arch, layers in MORE_ARCHS:
        acfg = more_arch_config(arch, layers)
        pc, sc = more_counts[label] = ({}, {})
        report[f"prefill_{label}"] = _phase(
            f"prefill_{label}", prefill_arch_main_path, acfg, dev, pc,
            f"prefill_{label}")
        _release()
        report[f"serve_{label}"] = _phase(
            f"serve_{label}", serve_arch_main_path, acfg, dev, sc,
            f"serve_{label}", one_weight_set=True)
        _release()
    serve_fleet_counts, fleet_failover_counts = {}, {}
    report["serve_fleet"] = _phase("serve_fleet", serve_fleet_main_path, dev,
                                   serve_fleet_counts)
    _release()
    report["fleet_failover"] = _phase("fleet_failover",
                                      fleet_failover_main_path, dev,
                                      fleet_failover_counts)
    _release()
    serve_tp_counts, e2e_tp_counts = {}, {}
    report["serve_tp"] = _phase("serve_tp", serve_tp_main_path, dev,
                                serve_tp_counts)
    _release()
    report["e2e_tp"] = _phase("e2e_tp", e2e_tp_main_path, dev, e2e_tp_counts)
    _release()
    report["example"] = _phase("example", example_main_path, dev)
    _release()
    train_ssm_counts, train_100m_counts, train_cli_counts = {}, {}, {}
    report["train_ssm"] = _phase("train_ssm", train_ssm_main_path, ssm_cfg,
                                 dev, train_ssm_counts)
    _release()
    report["train_100m"] = _phase("train_100m", train_100m_main_path, dev,
                                  train_100m_counts)
    _release()
    report["train_cli"] = _phase("train_cli", train_cli_main_path, dev,
                                 train_cli_counts)
    _release()
    report["dryrun"] = _phase("dryrun", dryrun_main_path, dev)
    _release()
    report["paper"] = _phase("paper", paper_main_path)

    timings = report["kernels"]["timings"]
    csrc = "src/repro_torch/csrc/"
    source = {  # name: (source, TPU kernel replaced, timing, launches)
        "cache_matmul": (csrc + "cache_matmul.cu",
                         "src/repro/kernels/cache_matmul.py:99",
                         timings["cache_matmul.up"], serve_counts),
        "block_fused_ffn": (csrc + "block_fused_ffn.cu",
                            "src/repro/kernels/block_fused_ffn.py:54",
                            timings["block_fused_ffn.prefill"], prefill_counts),
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:111",
                            timings["flash_attention"], prefill_counts),
        "flash_attention_quantized": (
            csrc + "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:173",
            timings["flash_attention_quantized"], prefill_counts),
        "cache_matmul_quant": (
            csrc + "cache_matmul_quant.cu",
            "src/repro/kernels/cache_matmul.py:73",
            report["ffn_quant"]["timings"][
                f"int8 decode {decode_plan.describe()} m2 up"],
            ffn_quant_counts),
        "ssd_chunk": (csrc + "ssd_chunk.cu",
                      "src/repro/kernels/ssd_scan.py:62",
                      timings["ssd_chunk.prefill"], prefill_ssm_counts),
        # the gradient of the same TPU kernel's function (the reference
        # has no backward kernel), with the train step's launches
        "ssd_chunk_bwd": (csrc + "ssd_chunk_bwd.cu",
                          "src/repro/kernels/ssd_scan.py:62",
                          timings["ssd_chunk_bwd.train"], train_ssm_counts)}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], "max_abs_err": t["max_abs_err"],
                **{k: t[k] for k in keys},
                **{k: t[k] for k in ("kind", "simt_ms") if k in t}}
               for name, (src, rep, t, counts) in source.items()]
    # the matmuls' prefill GEMMs (wgmma, 2048 rows) beside their decode ones
    pf = timings["cache_matmul.prefill.up"]
    kernels[0]["prefill"] = {"launches": prefill_counts["cache_matmul"],
                             "max_abs_err": pf["max_abs_err"],
                             **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the fused FFN's decode rows (gemv) with the e2e phase's LBM decode
    # launches (yi-9b, 4 layers)
    pf = timings["block_fused_ffn.decode"]
    kernels[1]["decode"] = {
        "launches": report["e2e"]["launches"]["block_fused_ffn.gemv"],
        "max_abs_err": pf["max_abs_err"],
        **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the quantized flash kernel under the fp8 plan beside the int8 one
    pf = timings["flash_attention_quantized.fp8_e4m3"]
    kernels[3]["fp8_e4m3"] = {"max_abs_err": pf["max_abs_err"],
                              **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    lwm_q = next(p for p in report["ffn_quant"]["plans"]
                 if p.startswith("prefill "))
    pf = report["ffn_quant"]["timings"][f"int8 {lwm_q} m2048 up"]
    kernels[4]["prefill"] = {
        "launches": ffn_quant_counts["cache_matmul_quant.wgmma"],
        "max_abs_err": pf["max_abs_err"],
        **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the expert GEMMs and the fused expert FFN of the MoE prefill, each
    # with the launches of the prefill_moe call that runs its shape
    moe_runs = report["prefill_moe"]["runs"]
    for i, label, run in ((0, "moe.up", "LWM/native"),
                          (0, "moe.down", "LWM/native"),
                          (0, "moe.serve.up", "serve/LWM/native"),
                          (0, "moe.serve.down", "serve/LWM/native"),
                          (1, "moe", "LBM/native")):
        kernel = kernels[i]["name"]
        pf = timings[f"{kernel}.{label}"]
        kernels[i][label] = {
            "launches": moe_runs[run]["launches"][f"{kernel}.wgmma"],
            "max_abs_err": pf["max_abs_err"],
            **{k: pf[k] for k in keys + ("kind",)}}
    # zamba2-2.7b's shapes, each with the launches of the phase that ran
    # it: the shared FFN's decode gemv (serve_hybrid), its prefill GEMM
    # and fused FFN and the SSD scan (prefill_hybrid, its four calls)
    for i, label, timing, launches in (
            (0, "hybrid", "cache_matmul.hybrid.up",
             serve_hybrid_counts["cache_matmul.gemv"]),
            (0, "hybrid.down", "cache_matmul.hybrid.down",
             serve_hybrid_counts["cache_matmul.gemv"]),
            (0, "hybrid.prefill", "cache_matmul.hybrid.prefill.up",
             prefill_hybrid_counts["cache_matmul.wgmma"]),
            (1, "hybrid", "block_fused_ffn.hybrid",
             prefill_hybrid_counts["block_fused_ffn.wgmma"]),
            (5, "hybrid", "ssd_chunk.hybrid",
             prefill_hybrid_counts["ssd_chunk.wgmma"])):
        t = timings[timing]
        kernels[i][label] = {"launches": launches,
                             "max_abs_err": t["max_abs_err"],
                             **{k: t[k] for k in keys + ("kind", "simt_ms")}}
    # whisper-tiny's and llava-next's shapes, each with the launches of
    # the phase that ran it: the decode gemv and the fused FFN's gemv
    # decode tile (serve_encdec, serve_vlm), whisper's fused FFN at 896
    # rows and hd-64 flash (e2e_encdec's calls), llava's prefill GEMM,
    # fused FFN and flash kernels at 1600 positions (prefill_vlm)
    e2e_encdec = report["e2e_encdec"]["launches"]
    for i, label, timing, launches in (
            (0, "encdec", "cache_matmul.encdec.up",
             serve_encdec_counts["cache_matmul.gemv"]),
            (0, "vlm", "cache_matmul.vlm.up",
             serve_vlm_counts["cache_matmul.gemv"]),
            (0, "vlm.down", "cache_matmul.vlm.down",
             serve_vlm_counts["cache_matmul.gemv"]),
            (0, "vlm.prefill", "cache_matmul.vlm.prefill.up",
             prefill_vlm_counts["cache_matmul.wgmma"]),
            (1, "encdec.decode", "block_fused_ffn.encdec.decode",
             serve_encdec_counts["block_fused_ffn.gemv"]),
            (1, "encdec.prefill", "block_fused_ffn.encdec.prefill",
             e2e_encdec["block_fused_ffn.wgmma"]),
            (1, "vlm", "block_fused_ffn.vlm",
             prefill_vlm_counts["block_fused_ffn.wgmma"]),
            (2, "encdec", "flash_attention.encdec",
             e2e_encdec["flash_attention.wgmma"]),
            (2, "vlm", "flash_attention.vlm",
             prefill_vlm_counts["flash_attention.wgmma"]),
            (3, "vlm", "flash_attention_quantized.vlm",
             prefill_vlm_counts["flash_attention_quantized.wgmma"])):
        t = timings[timing]
        kernels[i][label] = {"launches": launches,
                             "max_abs_err": t["max_abs_err"],
                             **{k: t[k] for k in keys + ("kind", "simt_ms")}}
    # the flash kernels at kimi-k2's hd 112 (prefill_kimi's launches) and
    # the quantized one at whisper's hd 64 (e2e_encdec's LWM/int8 call);
    # kimi's fp8 K/V timed only: its plans run none
    kimi = more_counts["kimi"][0]
    for i, label, timing, launches in (
            (2, "kimi", "flash_attention.kimi",
             kimi["flash_attention.wgmma"]),
            (3, "kimi", "flash_attention_quantized.kimi",
             kimi["flash_attention_quantized.wgmma"]),
            (3, "encdec", "flash_attention_quantized.encdec",
             e2e_encdec["flash_attention_quantized.wgmma"])):
        t = timings[timing]
        kernels[i][label] = {"launches": launches,
                             "max_abs_err": t["max_abs_err"],
                             **{k: t[k] for k in keys + ("kind", "simt_ms")}}
    t = timings["flash_attention_quantized.kimi.fp8_e4m3"]
    kernels[3]["kimi.fp8_e4m3"] = {
        "max_abs_err": t["max_abs_err"],
        **{k: t[k] for k in keys + ("kind", "simt_ms")}}
    # the training slice: ssd_chunk's backward beside its forward (the
    # train step's launches and shape), its prefill-shaped timing, and
    # the forward's launches in the train step
    pf = timings["ssd_chunk_bwd.train"]
    kernels[5]["backward"] = {"launches": train_ssm_counts["ssd_chunk_bwd"],
                              "max_abs_err": pf["max_abs_err"],
                              **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    pf = timings["ssd_chunk.train"]
    kernels[5]["train"] = {"launches": train_ssm_counts["ssd_chunk"],
                           "max_abs_err": pf["max_abs_err"],
                           **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    pf = timings["ssd_chunk_bwd.prefill"]
    kernels[6]["prefill"] = {"max_abs_err": pf["max_abs_err"],
                             **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the fleet phases' launches (no new kernel: each replica runs its
    # tenants' kernels)
    for i, name in ((0, "cache_matmul"), (5, "ssd_chunk")):
        kernels[i]["fleet_launches"] = {
            "serve_fleet": serve_fleet_counts[name],
            "fleet_failover": fleet_failover_counts[name]}
    # the tensor-parallel slice: the gemv at yi-9b's shard shapes with
    # serve_tp's launches of each, and the fused FFN at d_ff / 2 with
    # e2e_tp's yi-9b launches of that shape
    d, f = cfg.d_model, cfg.d_ff // SERVE_TP["tp"]
    for i, label, timing, launches in (
            (0, "tp.up", "cache_matmul.tp.up",
             serve_tp_counts[f"cache_matmul@{d}x{f}"]),
            (0, "tp.down", "cache_matmul.tp.down",
             serve_tp_counts[f"cache_matmul@{f}x{d}"]),
            (1, "tp.prefill", "block_fused_ffn.tp.prefill",
             report["e2e_tp"]["yi-9b"]["launches"].get(
                 f"block_fused_ffn@{d}x{f}", 0))):
        t = timings[timing]
        kernels[i][label] = {"launches": launches,
                             "max_abs_err": t["max_abs_err"],
                             **{k: t[k] for k in keys + ("kind", "simt_ms")}}
    for i, name in ((0, "cache_matmul"), (1, "block_fused_ffn"),
                    (2, "flash_attention"), (5, "ssd_chunk")):
        kernels[i]["tp_launches"] = {"serve_tp": serve_tp_counts[name],
                                     "e2e_tp": e2e_tp_counts.get(name, 0)}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
