#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and ``nvcc``;
without a card it exits non-zero before printing any result.  The port's
compiled programs (``repro_torch.compile``: the discovery group programs
and the serving decode step, captured once per key as CUDA graphs and
replayed) are on throughout, as ``jax.jit`` is in the reference; the
phases that wrap a kernel's Python call to capture its inputs run under
``compile.eager()``, and every launch count is counted through replays.
Phases, each of which fails the run (non-zero exit, no result line) if
it fails:

  1. environment: card name and power limit, torch and nvcc versions,
     the six kernel sources (``radius_counts.cu`` holds both bodies),
     ``knn_stats/csrc/radius_counts.cu``,
     ``knn_stats/csrc/knn_two_op.cu``, ``pairwise_cheb/csrc/pairwise_cheb.cu``,
     ``flash_attention/csrc/flash_attention.cu`` (the CUDA-core kernel,
     both bodies),
     ``flash_attention/csrc/flash_wgmma.cu`` (the Hopper kernel) and
     ``murmur3/csrc/murmur3_fib.cu``, one ``nvcc`` each, started together
     (seconds and ``ptxas`` register/spill/shared-memory reports); whether
     ``torch._grouped_mm`` (the MoE layers' grouped GEMM) is present;
  2. every kernel against its plain PyTorch version on the card, on the
     same inputs, required bit-equal (tolerance 0, NaN positions equal):
     radius_counts' radii, class counts and ball/tie counts, at
     main-path width (B=4096 samples × P=256) in both modes, plus
     k=1/5/8/16/17/K_MAX, widened class budgets, tie-heavy values, ragged
     masks, few-neighbour rows, P=40/512/1024/2048 and kb=32/128 batches,
     and edge rows (NaN and +-inf x or y in valid rows, duplicated points,
     -0.0 beside +0.0 codes, a NaN code, exactly k neighbours), each case
     required to reach the body ``kernel.takes_staged`` names and both
     bodies reached; pairwise_cheb's
     DX/DY/DJ at B=4096 × P=256, P=300 with ragged masks, P=512,
     exact-zero plateaus and NaN/±inf inputs; flash_attention, causal and
     not, GQA groups 1/2/4, S = 1/100/2048/2049, (Dk, Dv) = (128, 128),
     (64, 64), (192, 128) and (16, 16), float32, bfloat16 and float16,
     each case required to reach the kernel the dispatch rule names:
     bfloat16/float16 at the first three head dims the Hopper kernel,
     held against ``ref.mha_reference`` and its own plain version
     ``ref.chunked_attention(p_dtype=...)`` within one spacing
     of the output dtype + 2^-8 max|v| (per batch x head) + 2e-5 (P is
     rounded to bf16/fp16 before P·V: at most 2^-9 of itself, so the
     output moves by at most 2^-9 max|v|, bounded with a factor 2); the
     rest the CUDA-core kernel against ``ref.chunked_attention`` and
     ``ref.mha_reference``, float32 within atol 2e-5 (the two differ in
     summation order only) and 16-bit within one spacing of the plain
     version's output plus 2e-5 (both accumulate in float32 and round
     once, and near zero the float32 difference spans several
     spacings), each case also required to reach the body
     ``kernel.takes_regtile`` names (float32 at Dk, Dv <= 128 the
     register-tiled body, held within atol 2e-5 of the basic body on the
     same inputs too; the rest the basic body: float32 above 128,
     16-bit at other head dims), both bodies reached; then
     the Hopper kernel at the MoE serving path's operand layouts (GQA
     group 8: Hq 32 / Hkv 4 at head dim 128; MLA's (192, 128) with k the
     expanded rope concatenation and v a strided slice of the ``kv_up``
     output), bf16 and fp16, S = 100/2048, causal and not, each one launch
     of the Hopper kernel within its tolerance;
     knn_smallest in both modes at P = 1/2/31/255/256/257/512/
     1024/1025 and kb = 1/3/8/16/128, and ball_counts with both ``which``
     at r = 0, +inf, NaN and an existing distance, with all-invalid
     samples, ties and +-inf values, bit-equal, each case required to
     reach the body ``kernel.takes_staged_two_op`` names and all four
     bodies reached; hash_keys on the words 0, 1, 0x7FFFFFFF,
     0x80000000, 0xFFFFFFFF and random ones, n = 0/1/127/32769, scalar
     and per-element seeds, Fibonacci on and off, bit-equal to the plain
     version and to the host's numpy hashes;
  3. the main path: a C=65536-candidate TUPSK (n=256) corpus through
     ``SketchIndex.add``, then ``query_many`` with Q=16 continuous- and
     Q=16 discrete-target queries at ``min_join=24``, ``top_k=40``, cold
     then warm, with every kernel's launch count set to 0 just before and
     read just after; the planted strongest candidates must rank first;
  4. a C=1024 sub-corpus scored on the card and by the port's CPU path:
     rankings and join sizes identical, MI within rtol 1e-5 / atol 1e-5;
  5. every kernel launch of one warm pass per target dtype, captured
     with its inputs and outputs: each output held bit-equal to the
     plain version on the same inputs, then timed there (CUDA events and
     profiler device time) beside its plain version's time, its bound
     (the cheaper sorted route's operations, RC_NEED_* or RC_ROUTE_*)
     and share, the direct algorithm's bound (RC_OPS) and share, and the
     tiled body on the same inputs (held bit-equal too);
  6. times: the warm ``query_many`` wall time (host clock around a
     synchronize, median of 10 per target dtype) and one profiled warm
     pass (device time by kernel);
  7. ``DiscoveryService.submit`` over the phase-3 index with one queue
     interleaving the 16 continuous and 16 discrete queries: join sizes
     and rankings as phase 3's warm ``query_many``, MI within 1e-6, and
     its warm wall time (median of 10);
  8. ``submit_safe`` under faults, the queue plus two invalid sketches
     (a NaN value; n=128): both quarantined, the first bucket's fused
     dispatch failing once and retried, 4 NaN lanes per served query
     fenced and recomputed through the materialized estimators (the
     ``pairwise_cheb`` kernel), rankings as the clean ``submit``; then
     with every fused and phase-1 dispatch failing, the buckets descend
     to the reference rung and still rank the same;
  9. ``submit_async``: four caller threads, 8 queries each in two
     half-waves, ``pipeline_depth=2``: every handle resolves within a
     timeout with its solo ``submit`` results, buckets coalesce and
     windows overlap; the synchronising calls of one window dispatch
     are counted under ``torch.cuda.set_sync_debug_mode("warn")``;
 10. the materialized estimators on phase 5's captured samples (MixedKSG
     on the joint launch, DC-KSG on the class launches): MI within 1e-6
     of the fused results, each ``pairwise_cheb`` chunk launch held
     bit-equal to its plain version and timed beside it and its bound;
 14. the wide-buffer path: ``query_many`` per target dtype at k=32, past
     the staged body's 16-lane buffer: a first pass builds the k=32
     programs, then one replayed pass with every kernel's launch count
     set to 0 just before and read just after: every launch must reach
     the tiled body (3, none of the staged one); each launch of a pass
     held bit-equal to the plain version and timed as in phase 5; (b)
     the tiled body alone on seeded samples (``TILED_SWEEP``): at B = 1
     over P = 2048, 10,000, 40,000 and at P = 256 (B = 65536) over k, kb
     = 32, 64, 128, each bit-equal to the plain version and timed beside
     its bounds;
 15. the phase-0 containment gate on the phase-3 index (its signature
     tier, 16 keys a candidate, flushed with the sketches) at
     ``min_containment=0.1``, which separates the lake's joinable columns
     from the rest exactly: (a) the cold gated ``query_many`` per target
     dtype overflows its survivor rungs and re-runs each window ungated
     (counted); (b) the warm gated pass delivers gated, its rankings and
     join sizes equal to phase 3's warm ungated pass (MI within 1e-6),
     with exactly 3 ``radius_counts`` launches, all of the staged body,
     and the survivor and shortlist counts per group; (c) each launch of
     a warm gated pass held bit-equal to the plain version and timed as
     in phase 5; (d) gated and ungated warm ``query_many`` alternated,
     median of 10 each per dtype, one profiled pass of each (device time
     by kernel family) and the parts on their own (the signature sweep,
     the survivor-width joins, the corpus-wide joins they replace);
     (e) ``DiscoveryService.submit`` of phase 7's queue gated: rankings
     as in (b), every window delivered gated, its warm median beside the
     ungated one and the synchronising calls of one gated window
     dispatch beside an ungated one's;
 12. the two-op kNN API on phase 5's captured launches: (a)
     ``knn_with_counts`` with the radius rule ``radius_counts`` fuses (2
     kernel launches per call, counted, each of the staged body), its
     radius, class count and five counts bit-equal to the captured
     ``radius_counts`` outputs; ``knn_smallest`` and ``ball_counts`` each
     bit-equal to its plain version on the whole batch, its tiled body
     held bit-equal on the same inputs, and timed: the staged body (a
     launch where the tiled one is faster is logged as a finding; the
     dispatch rule stays), the tiled body, the plain version, the sorted
     route's bound and share (KNN_NEED_* / KNN_ROUTE_STEP, BC_NEED_*; the
     kernels' line carries it), the direct algorithm's bound (KNN_OPS,
     BC_OPS) as a ratio, and the fused kernel; (b) the same calls on the
     samples padded with invalid columns to P = 1280: each of the 2
     launches per call of the tiled body, outputs equal to (a)'s on the
     real columns, each tiled call timed (CUDA events) beside its bound
     at its own inputs; (c) (run after phase 2, while the card's memory
     is free for the plain versions) the tiled bodies alone on seeded
     samples (``TWO_OP_SWEEP``): at B = 1 over P = 2048, 10,000, 40,000
     and at P = 256 over kb = 32, 64, 128 (B cut so that the (B, P, kb)
     output fits ``TWO_OP_SWEEP_BYTES``, the cut logged), each op
     bit-equal to its plain version and timed beside its bound and share;
 13. the lake's keys hashed on the card: all C x 384 key words of phase
     3's corpus through ``hash_keys`` (the key hash, the TUPSK tuple-key
     re-hash with the key hashes as per-element seeds, and its Fibonacci
     rank; 3 launches, counted), each bit-equal to ``murmur3_32_np`` /
     ``fibonacci32_np`` on the host, timed beside the plain version and
     the byte bound;
 11. the model serving path at full width: ``internlm2-1.8b`` at its
     published widths and full depth (24 layers, 1.89 B float32
     parameters from a seeded generator, bfloat16 activations) through
     ``repro_torch.launch.serve.ContinuousBatcher``: 8 requests over 4
     slots, prompts of 2048 tokens, 32 generated tokens each, max_len
     4096.  It reports the prefill time per request, the decode time per
     step, the aggregate generated tokens/s and the peak device memory,
     and requires 24 launches of the Hopper flash kernel per admitted
     request and none of the CUDA-core one.  Then (a) one request's 24
     flash launches, captured with their inputs, each held within phase
     2's Hopper tolerance of both plain versions and timed beside its
     plain version, the CUDA-core kernel, its bound and
     ``scaled_dot_product_attention`` (the yardstick the port never
     calls; every flash time, SDPA's too, is a CUDA graph of the
     launches timed by events, ``graph_ms_per_call``, the profiler's
     device time with its kernel records and the events around eager
     launches beside it); then phase 16 (d) below; (b) that request's served logits (its prefill and its 31
     decode steps) against the port's float32 ``forward`` with the plain
     attention, over the prompt and the generated tokens, within
     ``SERVED_RTOL``; a forward whose attention drops the causal mask
     must fall outside it; (c) the float32 ``forward`` of the same
     tokens through the kernels (the CUDA-core kernel's path: 24
     launches, all of its register-tiled body, none of the Hopper
     kernel), its logits within 1e-3 relative RMS of the plain float32
     forward; the same forward through the basic body (24 launches, the
     same tolerance); then each of the 24 launches held within atol 2e-5
     of both plain versions and of the basic body on the same inputs and
     timed as in (a), the basic body timed beside it, with the
     register-tiled body's ptxas registers, spills and shared memory;
     last, one bfloat16 launch at Gemma 2 9B's attention shape
     (``GEMMA_ATTN``: q (1, 16, 2048, 256), GQA 16 / 8) through the
     dispatch to the basic body, held against both plain versions within
     one spacing + 2e-5 and timed beside SDPA and its bound at the
     tensor cores' bf16 rate (the float32 CUDA-core rate's figure beside
     it), with the basic body's ptxas report.

 16. compiled programs against ``compile.eager()``, on the phase-3 index
     and the phase-11 model: (a) warm ``query_many`` per target dtype,
     results bit-equal, ``compile_count()`` unchanged by a second warm
     pass, exactly 3 ``radius_counts`` launches a pass counted through
     replays, medians of 10 alternated, one profiled pass of each
     (device ms, busy share, the host's launch calls); (b) the same at
     ``min_containment=0.1``; (c) ``submit`` (bit-equal to its eager
     run, rankings as phase 7) and ``submit_async`` with programs on, no
     synchronising call in a window dispatch, and ``compiled_programs``,
     ``padded_lanes``, ``q_buckets``; (d) at the end of phase 11 (a), the
     captured decode step against the eager one from identical copies of
     the caches: logits and caches bit-equal, medians of 10 alternated
     and a profile of each.

 17. the paper's application: (a) on the phase-3 index, ``stacked()`` and
     ``score_batch`` for the first continuous- and discrete-target query
     (all four estimator ids): its top 40 at ``min_join=24`` equal to
     phase 3's warm ``query_many`` (MI within 1e-6), and
     ``score_batch_partitioned``, the batched executor's dense scores and
     ``query_many(executor="batched", prefilter=False)`` bit-equal to
     it; ``radius_counts`` launched; warm medians of 5 (``[adhoc]``
     lines); (b) ``score_batch_reference`` on the same lake (the
     materialized estimators: ``pairwise_cheb`` launched, join sizes equal
     to (a)'s, MI within 1e-5), its time beside (a)'s (a first call over
     60 s would cut it to the first 8192 columns, on a line of its own);
     (c) the phase-4 sub-corpus: both scorers on the card against the
     CPU path (join sizes equal, MI within 1e-5) and an
     ``AugmentedTabularPipeline`` (top_k=8, min_join=24): features equal
     and in order, ranking MI within 1e-5, feature matrices bit-equal;
     (d) the paper's synthetic data at its size (``[synthetic]`` lines):
     the quickstart (Trinomial m=512, 20,000 rows, KeyDep, MLE) through
     ``examples/quickstart_torch.main``, then CDUnif m=64 (DC-KSG) and
     Trinomial m=512 perturbed by 1e-3 on both sides (MixedKSG), KeyInd
     at 10,000 rows, 8 trials each, estimated on the TUPSK n=256 sketch
     join (the staged body) and on the full join (P = 10,000, the tiled
     body): trial 0 of each on the card within 1e-5 of the CPU path, its
     two launches bit-equal to the plain version on the bodies
     ``kernel.takes_staged`` names and timed with their bounds, a tiled
     launch counted per full join; true MI, estimates, errors and RMSE
     printed beside the paper's V-B1 claim, not held; (e) the taxi
     example (``examples/taxi_demand_augmentation_torch.main("cuda")``,
     400 days x 60 zones, 14 tables, n=512): ``demographics.population``
     and a weather column discovered, the augmented test MAE below the
     baseline (``[augment]`` lines).

 21. the discovery mesh on the phase-3 index (``[mesh]`` lines):
     ``make_host_mesh(devices=[cuda:0] * 4)`` (four shards on the one
     card), a 3-shard mesh (group buckets padded to the shard count) and
     ``make_host_mesh()`` over the visible cards: (a) ``execute``'s
     (Q, C) MI and join sizes (Q = 4 a dtype) bit-equal to the batched
     executor's; (b) ``query_many(mesh=)`` identical to the batched path
     (rankings, MI, join sizes) through the dense (Q = 4), unfused
     two-phase, fused and gated (``min_containment=0.1``) routes, cold
     and warm; (c) ``distributed_topk`` equal to the stable argsort of
     ``score_batch``; (d) ``DiscoveryService(mesh=)`` ``submit`` equal to
     a loop of mesh queries and to phase 7's submit; under
     ``dispatch@distributed`` (dense) and fused / prefilter faults it
     descends to the batched rung with the same results; the non-finite
     fence on the distributed rung launches ``pairwise_cheb``;
     ``submit(rank="hybrid")`` bit-equal to the batched service's on
     every route, on 4 and on 3 shards; (e) each
     shard's ``radius_counts`` launches of a warm fused pass, captured
     under ``eager()``, bit-equal to the plain version; (f) warm
     ``query_many`` medians of 5 (mesh and batched alternated), one
     profiled pass of each, ``radius_counts`` launches per window and
     peak memory over the resident index (replayed and eager).

 18. the MoE and MLA serving path, after phase 11 with its model freed,
     for ``qwen3-moe-30b-a3b`` (``[moe]`` lines) then
     ``deepseek-v2-lite-16b`` (``[mla]``), one at a time: (a) the
     configuration at full width cut to 4 / 3 layers (every layer kind),
     float32 parameters from a seeded generator, one request (a
     2048-token prompt, 32 tokens) served through ``ContinuousBatcher``
     (bfloat16, the Hopper flash kernel, ``torch._grouped_mm``): its
     served logits against the float32 ``forward`` with the plain
     attention and the plain grouped SwiGLU (the loop over experts)
     within its tolerance (``MOE_SERVE``), a forward without the causal mask outside
     it; for deepseek (MLA) the float32 forward also through the kernels
     (``mla_f32_forward``): 3 launches of the CUDA-core flash kernel's
     basic body at q (1, 16, 2079, 192), v (1, 16, 2079, 128) and nothing
     else, logits within ``F32_FWD_RTOL`` of the plain float32 forward,
     each launch held within atol 2e-5 of both plain versions and timed
     beside its plain version, SDPA and its bound (the basic body's
     kernels-line times); (b) the first MoE layer of that model on bfloat16 inputs at 2048
     and 4 tokens: the route equal to the plain router (float64 on the
     host) wherever the k-th / (k+1)-th probability gap exceeds
     ``ROUTE_GAP_TOL``, the grouped GEMM within ``GROUPED_RTOL`` of the
     loop on the same sorted rows (the loop over groups shifted by one
     expert outside it), timed beside the loop and its bound; (c) the
     full-depth configuration (48 / 27 layers) in bfloat16 parameters
     with phase 11's traffic: prefill and decode times, tokens/s, peak
     memory beside the predicted one, exactly one Hopper flash launch
     per layer per request, one grouped SwiGLU per MoE layer per prefill
     and decode step (counted through the replays) and nothing else, the
     first two flash launches of a request held and timed as in phase
     11 (a), a profiled prefill and decode step (device time by kernel
     family), the captured decode step against ``eager()`` from
     identical cache copies (logits and caches bit-equal), and request
     0's served logits against a bfloat16 ``forward`` of the same tokens
     within its tolerance (``MOE_SERVE``; an unmasked forward outside it).
 19. the SSM and hybrid serving path, after phase 18 with its models
     freed, for ``mamba2-370m`` (``[ssm]`` lines, whole) then
     ``jamba-1.5-large-398b`` (``[hybrid]``, its first 5 layers: 4
     Mamba2, GQA at offset 4, MoE at layers 1 and 3), one at a time:
     (a) float32 parameters from a seeded generator (jamba's check model
     with 4 of its 16 experts), one request (a 2048-token prompt, 32
     tokens) served in bfloat16 through ``ContinuousBatcher``: its logits
     against the float32 ``forward`` (tokens padded to the SSD's chunk;
     the plain attention and grouped SwiGLU) within ``SSM_SERVE``'s
     tolerance; then the same tokens served with float32 activations
     (eager, the plain grouped SwiGLU): logits against that forward and
     slot 0's SSM states against the float32 chunked prefill's within
     ``SSM_F32_RTOL``, and outside it the same served with the prompt's
     SSM states zeroed before the first decode step and jamba's float32
     forward without the causal mask (in bfloat16 both controls stay
     within the dtype policy's error, reported); (b) the first Mamba2 layer
     alone on bfloat16 inputs: the chunked SSD at 2048 tokens against the
     float64 sequential recurrence on the card within ``SSD_RTOL`` (the
     chunks run apart outside it), timed (CUDA events, profiler device
     time, kernels a call) beside its float32 FLOP bound; at 4 slots the
     recurrent update (``_ssd_step``) against one float64 step, it and
     the layer's decode timed against their byte bounds; (c) phase 11's
     traffic: mamba2 with float32 parameters (no kernel launched at all),
     jamba in bfloat16 parameters with all 16 experts (one Hopper flash
     launch per prefill, one grouped SwiGLU per MoE layer per prefill and
     decode step, nothing else; the first flash launch held and timed
     beside SDPA at GQA group 8, Hq 64); prefill and decode times,
     tokens/s, peak memory beside the prediction, profiles with an
     ``ssd`` family (the kernels inside ``_ssd_chunked`` / ``_ssd_step``),
     the captured decode step against ``eager()`` (logits, conv, ssm, k,
     v bit-equal), request 0's served logits against a bfloat16
     ``forward`` within the tolerance.

 20. the training path, after phase 19 with its models freed, for
     ``musicgen-large`` (``[train-audio]``) and ``internvl2-26b``
     (``[train-vision]``): (a) each at full width cut to 2 layers, float32
     parameters and activations, one ``TokenPipeline`` batch of 2 x 512
     (internvl2: 256 patches + 256 tokens): one train step (remat, int8
     AdamW) on the card against the same step through the port on the
     CPU (loss, every gradient leaf, the clipped norm, the update, the
     int8 moments; ``TRAIN_*`` tolerances), 4 launches of the
     register-tiled flash body (forward and remat) and nothing else;
     outside the tolerances: internvl2's loss with ``loss_mask`` ignored,
     ``patch_proj``'s gradient with the patches zeroed, and a step whose
     attention output is detached; the flash autograd Function's q/k/v
     gradients on a captured launch (float32, and bf16 through the
     Hopper kernel) against autograd through ``ref.chunked_attention``;
     ``prefill`` + one ``decode_step`` against ``forward``; then, beside
     the stubs, ``deepseek-v2-lite-16b`` (``[train-mla]``: MLA, a dense
     prefix layer and a MoE layer of 64 experts) and ``mamba2-370m``
     (``[train-ssm]``), each 2 layers at full width, float32 parameters:
     one step's gradients on the card (deepseek in bf16 activations, the
     grouped GEMM's and MLA's backward; mamba2 in float32, the SSD's)
     against the CPU's float32 step on the same batch (``TRAIN_BF16_*`` /
     ``TRAIN_*`` tolerances, the share of equal routes reported), a
     control with the attention (SSD) output detached outside them, the
     flash and grouped-GEMM launches counted, and two whole steps timed;
     (b) each at
     full width (musicgen whole, 48 layers, 3.24 B parameters;
     internvl2's first 8 of 48 layers, 4.30 B), float32 master
     parameters, bf16 activations, remat, int8 AdamW, batches of 2 x
     2048: 6 timed steps (median step ms on the host clock, tokens/s,
     ``train_mfu``, peak memory against the reckoned one, every loss
     finite), exactly 2 Hopper flash launches a layer a step, a profiled
     step by family (``flash``, the backward's recompute
     ``flash_backward_recompute``, ``gemm``, ``optimizer``, ``copy``),
     and a forward's first flash launch held and timed beside SDPA;
     (c) ``python -m repro_torch.launch.train`` on the 100M example's
     model (``olmo-100m``), B = 8, S = 128, 60 steps, checkpoints every
     20: two uninterrupted runs and one preempted at step 30 (exit 43)
     then resumed, the pipeline state and the batch after the resume
     bit-equal to an uninterrupted pipeline's, the loss falling by
     ``LAUNCH_LOSS_FALL``, the final parameters beside the uninterrupted
     run's with the two uninterrupted runs' spread.
 22. the model mesh's serving path, after phase 20 with its models freed;
     every mesh is one process over ``["cuda:0"] * 4``, four shard
     boundaries on the one card, so the transfers between cards are
     bypassed: (a) ``[mesh-cp]``: the context-parallel decode attention
     at internlm2's serve shape (B 4, S 4096, Hkv 8, H 16, Dh 128) on
     (2, 2) and (1, 4) meshes at positions 2047, 4095 and 100 (only the
     first sequence shard live) against the unsharded one, bfloat16
     within one output spacing + 2e-5 and float32 within 1e-5, the
     pieces views of the cache, the dead shard's partial exact zeros,
     both timed; (b) ``[mesh-ep]``: one MoE layer of qwen3-moe-30b-a3b at
     full width (128 experts top-8, bf16, 2048 tokens) with EP on (1, 4),
     32 experts a shard, against ``impl="gspmd"``: the route equal, the
     output within ``MESH_EP_RTOL``, 4 grouped GEMM calls against 1, both
     timed; (c) ``[mesh-serve]``: internlm2-1.8b whole with phase 11's
     weights seed and traffic, served plain and on a (2, 2) mesh (prefill,
     decode, tok/s, peak memory; 24 Hopper flash launches a prefill in
     each; the mesh run profiled), the mesh decode program bit-equal to
     ``eager()``, and the two batchers teacher-forced in lockstep, in
     bf16 (prefill logits bit-equal, decode logits within
     ``MESH_LOGIT_RTOL``, greedy tokens compared where the top-2 gap
     clears it) and in float32 activations (within
     ``MESH_F32_LOGIT_RTOL``, greedy tokens required equal there);
     (d) ``[mesh-moe]``: qwen3-moe-30b-a3b at full width cut to 8 of 48
     layers (bf16 parameters) with ``moe_impl="ep"`` on (1, 4), the same
     way (bf16 only: the grouped GEMM takes no float32) against the same
     model without a mesh (prefill logits within the tolerance too).

 23. training on the model mesh, after phase 22 with its models freed;
     every mesh is one process over ``["cuda:0"] * 4``: (a)
     ``[train-mesh-ep]``: qwen3-moe-30b-a3b at full width cut to 4 of 48
     layers (3.12 B float32 parameters, bf16 activations, remat, int8
     AdamW, batches of 2 x 2048) with ``moe_impl="ep"`` on (1, 4) beside
     the plain step: the first MoE layer's route equal, the deeper ones'
     share reported; on the plain step's routes the loss and every
     gradient leaf within the bf16 tolerances and every routed expert
     (and no other) with a gradient; 5 timed steps each (median step ms,
     tokens/s, peak memory against the reckoned one, launches); (b)
     ``[train-mesh-int8ef]``: internlm2-1.8b whole with
     ``compression="int8_ef"`` on a ("pod", "data") = (2, 2) mesh, batches
     of 4 x 2048, 4 steps against the same 4 uncompressed: the first loss
     within 1e-5, all within 5%, the compression cell on the card's
     per-pod gradients (the leaves ``MESH_INT8EF_CELL`` names) bit-equal
     to the CPU's cell, step ms and peak memory against the reckoned one
     (one pod's gradients alive); (c) ``[train-mesh-resume]``: the smoke
     configuration with int8_ef on the same mesh, 4 steps straight against
     2 + checkpoint + ``restore(shardings=)`` + 2, every leaf (both pods'
     residuals) bit-equal; then ``python -m repro_torch.launch.train
     --mesh host`` on the card; (d) ``[dryrun]``: ``python -m
     repro_torch.launch.dryrun`` on ``tests/test_dryrun.py``'s three cells
     (started at the phase's start, traced on the meta device beside
     (a)-(c)), their reports held to that test's assertions where the
     port's design allows them.
 24. the launch-shape autotuner (``repro_torch.kernels.autotune``), after
     phase 12, with ``REPRO_AUTOTUNE=on`` and ``REPRO_AUTOTUNE_CACHE`` in a
     temporary directory, both variables put back as found (checked):
     (a) every rung of every tuned body bit-equal to the default rung on
     that body's inputs (the staged ``radius_counts`` body on phase 5's
     launches, ``pairwise_cheb`` on phase 8's fence launches and a
     materialized chunk, the staged two-op bodies on phase 12's calls),
     each rung timed there, then one sweep per
     body from the main path's shape (at that launch's own P): one
     ``[autotune]`` line per body with the sweep's and the inputs'
     per-rung ms, the winner and the default; (b) after ``clear_memo()``
     in ``auto`` mode, the winners read back with zero sweeps, and a warm
     ``query_many`` pass under ``eager()``, fresh compiled programs around
     ``knn_radius_counts`` (replayed), ``knn_with_counts`` and the
     fence's ``pairwise_cheb`` bit-equal to the untuned outputs.  Its
     launches in (b) count in the kernels' line; the sweeps' launches
     (uncounted) in the record.  Phases 1-23 run untuned.  The flash
     bodies and the tiled ``radius_counts`` body are not tuned.

Phases 14, 15, 16 (a)-(c), 17, 21, 12, 24 and 13 run after phase 10 and
before phase 11, so that the serving path starts with the discovery
state freed; phases 18, 19, 20, 22 and 23 run after phase 11.
Each of phases 3, 7-9 and 11-24 sets every kernel's launch count to 0
just before it drives its path and reads the counts just after.

Near the end it prints the run's full record as one JSON line
(``{"record": ...}``; ``flash_basic`` holds the basic flash body's three
shapes: the float32 forward's, the MLA prefill's and Gemma's), then the
kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-flash-basic [SOURCE ...]

holds and times only the basic flash body of this checkout's
``flash_attention.cu`` and of each further source given (an earlier
tree's, unpacked beside it) at those three shapes, in turns on one card
(``time_flash_basic_sources``, through ``hold_flash_launches``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): the HBM rate, and the
# float32 rate outside the tensor cores, 67 TFLOP/s, which counts a fused
# multiply-add as two.  A plain float operation (subtract, abs, max,
# compare) is one instruction on one FP32 lane: half that rate.  An SM
# has half as many INT32 lanes as FP32 lanes, and issues one instruction
# per lane of the wider pipe per clock in all.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
INT32_INSTR_PER_S = FP32_INSTR_PER_S / 2

# Operations radius_counts needs, as (float, int) per valid (i, j != i)
# pair and per same-class pair: one distance evaluation, the compare
# against the running order statistic, the count compares and the adds.
#   joint/all: 2 subtractions, 2 abs, max, select compare, 4 count
#              compares (|dx|<r, |dy|<r, dx==0, dy==0); 5 adds, 1 and;
#   joint/y:   2 subtractions, 2 abs, max, select compare, |dy|<r; 1 add;
#   class/all: the class test (dx==0), 2 subtractions, 2 abs, |dx|<r,
#              |dy|<r, dy==0; 5 adds, 1 and; per same-class pair the
#              select compare and the class-count add;
#   class/y:   the class test, 1 subtraction, 1 abs, |dy|<r; 1 add; per
#              same-class pair the select compare and the class-count add.
RC_OPS = {
    ("joint", "all"): ((10, 6), (0, 0)),
    ("joint", "y"): ((7, 1), (0, 0)),
    ("class", "all"): ((8, 6), (1, 1)),
    ("class", "y"): ((4, 1), (1, 1)),
}
# RC_OPS prices the direct algorithm, which tests every pair for selection
# and for every count.  The bound in the kernels line counts instead what
# the function needs once a sample is sorted by x (by the class code in
# class mode), as (float, int):
#   the sort: log2(n!) compares a sample, the least any comparison sort
#     needs; class mode reads its runs off the sorted codes, one compare
#     a column and one add a row for cnt;
#   selection: joint mode visits the band |dx| < r of each row, the only
#     columns it could select (2 subtractions, 2 abs, max, the select
#     compare per band pair); class mode the row's own class (1
#     subtraction, 1 abs, the select compare per same-class pair);
#   the y counts per valid (i, j != i) pair: 1 subtraction, 1 abs,
#     |dy| < r and an add (with which == all also dy == 0 and an add);
#   the x counts (which == all): four binary searches a row of
#     ceil(log2(n+1)) steps (a subtraction and a compare each), and j_eq
#     over the row's x-tie range (1 subtraction, 1 abs, dy == 0, an add).
RC_NEED_Y = {"all": (4, 2), "y": (3, 1)}
RC_NEED_BAND, RC_NEED_SAME, RC_NEED_TIE = (6, 0), (3, 0), (3, 1)
RC_NEED_SEARCHES, RC_NEED_STEP = 4, (2, 0)
# The tiled body's route needs no y sweep: each sample
# is sorted twice (by y, then by x), and every count is a range of one
# order found by binary search.  As (float, int):
#   the sorts: 2 log2(n!) compares a sample;
#   selection: joint mode the band |dx| < r (RC_NEED_BAND a band pair);
#     class mode the row's run, 2 binary searches, and min(t + 1, cnt)
#     merge steps (1 subtraction, 1 abs, the compare);
#   the counts: binary searches a row of ceil(log2(n+1)) steps
#     (RC_NEED_STEP each): 2 for y_lt, and with which == all 2 for y_eq,
#     4 for the x counts and 2 for j_eq.
# A launch's bound is the lesser of the two routes' needs: either route
# computes the same outputs.
RC_ROUTE_SEARCHES = {"all": 10, "y": 2}
RC_ROUTE_RUN_SEARCHES, RC_ROUTE_MERGE = 2, (3, 0)
# Bytes per sample row: x, y f32 + mask u8 in; r f32 + cnt i32 + 5 i32 out.
RC_BYTES_PER_ROW = 9 + 28
# The two-op kernels' direct algorithm (their tiled bodies), counted from
# the code as RC_OPS is.  knn_smallest, as (float, int) per valid
# (i, j != i) pair and per same-class pair:
#   joint: 2 subtractions, 2 abs, max, the compare against the running
#          W-th smallest;
#   class: the class test per pair; per same-class pair 1 subtraction,
#          1 abs, the select compare and the class-count add.
# ball_counts per valid pair:
#   all: 2 subtractions, 2 abs, 4 count compares; 5 adds, 1 and;
#   y:   1 subtraction, 1 abs, |dy|<r; 1 add.
KNN_OPS = {"joint": ((6, 0), (0, 0)), "class": ((1, 0), (3, 1))}
BC_OPS = {"all": (8, 6), "y": (3, 1)}
# What the two ops need once a sample is sorted (the bound the kernels
# line reports, as RC_NEED_* is for radius_counts), as (float, int):
#   the sort: log2(n!) compares a sample and order (knn_smallest sorts
#     by x, or by (code, y); ball_counts by y, and with which == all by x);
#   knn_smallest, joint: the band |dx| < r of each row, r its kb-th
#     smallest distance, the only columns it could select (2
#     subtractions, 2 abs, max, the select compare per band pair); class:
#     the run read off the sorted codes (a compare a column, an add a row
#     for cnt) and one merge step (1 subtraction, 1 abs, the compare) per
#     selected same-class neighbour, min(kb, cnt) a row;
#   ball_counts: binary searches a row of ceil(log2(n+1)) steps (a
#     subtraction and a compare each): |dy| < r takes 2, and which == all
#     adds 2 for dy == 0, 4 for the x counts and 2 for j_eq.
KNN_NEED_BAND, KNN_NEED_MERGE = (6, 0), (3, 0)
# knn_smallest's two-order route (the tiled body's past a 64-lane buffer),
# as (float, int): both sorts, then in joint mode the four-stream walk up
# to each row's kb-th completion, one step per entry of the x order with
# |dx| < r and of the y order with |dy| < r (2 subtractions, 2 abs, the
# completion compare; the streams' minimum and the advance as 4 integer
# operations); in class mode the run by 2 binary searches and the merge
# steps (RC_ROUTE_RUN_SEARCHES, RC_ROUTE_MERGE).  knn_bound reports the
# lesser of this route and the one-sort route above.
KNN_ROUTE_STEP = (5, 4)
BC_NEED_SEARCHES, BC_NEED_STEP = {"all": 10, "y": 2}, (2, 0)
# Bytes per sample row: knn_smallest reads x, y f32 + mask u8 and writes
# kb f32 + cnt i32; ball_counts reads y, r f32 + mask u8 (and x f32 for
# "all") and writes 5 i32.  An invalid column's outputs are +inf / 0
# whatever its x, y or r hold, so a column of padding needs its mask byte
# (PAD_BYTES_IN) and its outputs only.
KNN_BYTES_IN, BC_BYTES_OUT, PAD_BYTES_IN = 9, 20, 1
BC_BYTES = {"all": 13 + BC_BYTES_OUT, "y": 9 + BC_BYTES_OUT}
# murmur3_fib per element: int64 key (and int64 seed when seeds are per
# element) in, int64 hash out; 20 integer operations (21 with the
# Fibonacci multiply), counted from murmur3_fib.cu.
HASH_INT_OPS = 20
# pairwise_cheb: x, y f32 + mask u8 in per row; DX, DY, DJ f32 out per pair.
PC_BYTES_PER_ROW, PC_BYTES_PER_PAIR = 9, 12

# Dense rates of one H100 SXM by operand type (NVIDIA data sheet): the
# bf16/fp16 tensor cores, and float32 outside them (an FMA counts as two).
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
               torch.float32: 67e12}

C_MAIN, N_ROWS, N_SKETCH, Q = 65536, 384, 256, 16
KEY_SEED = 3  # murmur seed of the lake's key columns
MIN_JOIN, TOP_K = 24, 40
C_CHECK = 1024
N_PLANTED = 8
WARM_REPS = 10
SEED = 0
FENCE_LANES = 4  # NaN lanes per served query in phase 8
FENCE_KEEP = 2  # phase 8's fence launches whose inputs phase 24 keeps
CALLERS, PER_CALLER = 4, 8
WIDE_K = 32  # phase 14: a k past the staged body's buffer
# Phase 15: the containment threshold.  The lake's joinable columns hold
# all of the train key universe and the rest none of it, so 0.1 separates
# them exactly and gated results must equal ungated ones.
GATE_MC = 0.1
HANDLE_TIMEOUT_S = 120.0
MI_TOL = 1e-6
# Phase 21: the discovery mesh on one card (4 shards on cuda:0, the
# card's counterpart of the reference tests' forced host devices; 3 shards
# to pad the pow-2 group buckets), the dense routes' queries per dtype
# (they score the whole lake), and the warm passes per median.
MESH_SHARDS, MESH_ODD_SHARDS, MESH_DENSE_Q, MESH_REPS = 4, 3, 2, 5
# Phase 17: warm calls per median of the ad-hoc scorers; the seed path's
# cut (a first call slower than ADHOC_REF_SLOW_S runs on the first
# ADHOC_REF_CUT columns); the synthetic cases (paper Section V-A/V-B:
# 10,000-row full joins) and trials per case; the paper's tie-breaking
# perturbation of a discrete side (benchmarks/common.py, _PERTURB).
ADHOC_REPS = 5
ADHOC_REF_SLOW_S, ADHOC_REF_CUT = 60.0, 8192
SYN_CASES = ("cdunif-dcksg", "trinomial-mixedksg")
SYN_TRIALS, SYN_ROWS = 8, 10_000
SYN_PERTURB = 1e-3

# flash_attention tolerances (see fa_within): float32 sums differ in
# order only; in bfloat16 both sides accumulate in float32 and round once.
FA_F32_ATOL = 2e-5
FA_BF16_ULPS = 1.0
# The Hopper kernel rounds P (in [0, 1]) to bf16/fp16 before P.V: at most
# 2^-9 of itself, so the output moves by at most 2^-9 max|v|; held within
# one output spacing + FA_P_VREL max|v| (per batch x head) + FA_F32_ATOL,
# a factor 2 of margin (see fa_within_p).
FA_P_VREL = 2.0 ** -8
FA_CASES = [  # (Dk, Dv) x S x group x causal, for each dtype
    (dtype, dk, dv, S, group, causal)
    for dtype in (torch.float32, torch.bfloat16, torch.float16)
    for dk, dv in ((128, 128), (64, 64), (192, 128), (16, 16))
    for S in (1, 100, 2048, 2049)
    for group in (1, 2, 4)
    for causal in (True, False)
]
FA_HKV = 2
FA_TIME_REPS = 50  # launches per CUDA-event timing of a captured flash launch
FA_PROFILE_LAUNCHES = 24  # least launches a profiled window of them holds
PROFILE_TRIES = 5  # profiler windows device_ms_per_call tries
PROFILE_WINDOWS: list = []  # device_ms_per_call's windows: records, calls, ms
# Kernel families a profiled pass's device time is summed by (a kernel
# name containing one of the words; radius_counts first, so that its
# rows never count as a sort).
PROFILE_KINDS = {
    "radius_counts": ("radius_counts",),
    "grouped_mm": ("GroupProblemShape", "grouped", "Grouped"),
    "searchsorted": ("searchsorted",),
    "gather": ("index", "gather"),
    "sort": ("sort", "Sort"),
    "scan": ("scan", "Scan"),
    "copy": ("copy", "Memcpy"),
    "flash": ("flash",),
    "gemm": ("gemm", "Gemm", "nvjet", "xmma"),
}

# Phase 11: the serving path at full width.
SERVE_ARCH = "internlm2-1.8b"
SERVE_REQUESTS, SERVE_SLOTS = 8, 4
SERVE_PROMPT, SERVE_GEN, SERVE_MAX = 2048, 32, 4096
# Served logits (bfloat16 activations, weights and KV cache cast to
# bfloat16) against the float32 forward with the plain attention, as the
# largest relative RMS error over the request's 32 logit vectors.  On an
# H100 the bfloat16 dtype policy alone comes to 0.043 (the bfloat16
# forward through the kernel), and a forward without the causal mask to
# 0.40-0.50; 0.10 sits between them with room on both sides.
SERVED_RTOL = 0.10
# The float32 forward through the CUDA-core flash kernel against the same
# forward with the plain attention: the attention outputs differ in
# summation order only (within FA_F32_ATOL), which 24 layers carry into
# the logits at a relative RMS far below this.
F32_FWD_RTOL = 1e-3
# Phase 11 (c): the basic flash body alone at Gemma 2 9B's attention shape
# (hf:google/gemma-2-9b: 16 query heads, 8 KV heads, head dim 256), bf16,
# causal: (B, Hq, Hkv, S, head dim).  No path of the port serves it; it
# times the 16-bit route off the Hopper kernel's head dims beside SDPA.
GEMMA_ATTN = (1, 16, 8, 2048, 256)


# Phase 18: the MoE and MLA serving path.  Each configuration, its tag,
# the depth of its float32 check model (as few layers as show every layer
# kind; deepseek: its dense layer 0 and two MoE layers), and the
# tolerances (relative RMS, as SERVED_RTOL) on (a)'s served logits
# against the float32 forward and on (c)'s against the bfloat16 forward.
# Each must lie above what the dtype policy costs and below what a
# forward without the causal mask moves the logits.  For qwen3
# SERVED_RTOL does both: on an H100 the policy comes to 0.052 in (a) and
# 0.017 in (c), an unmasked forward to 1.13 and 1.31.  deepseek's random
# MLA scores spread nearly evenly over the 2048-key prompt, so the 31
# keys an unmasked tail row also sees move its logits little: in (a)
# 0.037-0.056 against a policy error of 0.019 (the bfloat16 forward) and
# 0.021 (served); in (c) 0.104 against 0.065 (26 MoE layers of routing
# flips and the absorbed decode's own roundings; (a) shows the decode
# rows no further from float32 than the bfloat16 forward is).  Its
# tolerances sit between the two, a factor 1.3 from each; the runs are
# seeded and the kernels deterministic, so these errors repeat.
MOE_SERVE = (("qwen3-moe-30b-a3b", "[moe]", 4, SERVED_RTOL, SERVED_RTOL),
             ("deepseek-v2-lite-16b", "[mla]", 3, 0.028, 0.082))
# (b): the card's route (float32 logits and softmax) is held against the
# plain router in float64 wherever the k-th and (k+1)-th probabilities
# differ by more than this.  The card's float32 logits carry an error of
# about 2^-24 of a sum of 2048 products (some 1e-7 absolute), which moves
# a probability of about 1/E by some 1e-9: a gap over 1e-6 cannot flip.
ROUTE_GAP_TOL = 1e-6
# (b): torch._grouped_mm against the loop on the same bfloat16 rows, as
# the largest per-row relative RMS.  Both accumulate in float32 and round
# each GEMM's output to bfloat16 once (2^-9 relative an element); where
# the two float32 sums straddle a rounding boundary an element of the
# gate or up product moves by one spacing (2^-8), which the down GEMM
# averages over d_ff products.  2^-6 is four times the worst single
# element's 2^-8; the loop over the wrong experts lands near 1.
GROUPED_RTOL = 2.0 ** -6

# Phase 19: the SSM and hybrid serving path.  Each configuration, its tag,
# the cut of its float32 check model (a), the cut and parameter dtype of
# the model it serves with phase 11's traffic (c), and the tolerances
# (relative RMS, as SERVED_RTOL) on (a)'s served logits against the
# float32 forward and on (c)'s against the bfloat16 forward.  mamba2 runs
# whole; jamba keeps the first 5 of its 72 layers (4 Mamba2, GQA at
# offset 4, MoE at layers 1 and 3), the check model 4 of its 16 experts
# (top-2 kept: all 16 in float32 would need 89.3 GiB).  Each tolerance
# lies above what the bfloat16 dtype policy costs: on an H100, (a) 0.073
# (mamba2; its bfloat16 forward 0.070) and 0.036 (jamba); (c) 0.035 and
# 0.111 (jamba: bfloat16 weights, 16 experts, and the decode's batch of 4
# rounding its GEMMs otherwise than the forward does, flipping routes).
# In bfloat16 neither negative control clears the policy's error in these
# random-weight models: zeroing the prompt's SSM states moves the logits
# by 0.049-0.067 (mamba2) and 0.025-0.037 (jamba), dropping the causal
# mask of jamba's one attention layer in five by 0.026-0.047 ((c): 0.039).
# The D skip and the projections outweigh the decayed history, and the
# random scores spread nearly evenly over 2048 keys.  So both controls are
# held in float32 (SSM_F32_RTOL), where the policy costs nothing.
SSM_SERVE = (
    ("mamba2-370m", "[ssm]", {}, {}, SERVED_RTOL, SERVED_RTOL),
    ("jamba-1.5-large-398b", "[hybrid]", {"num_layers": 5, "num_experts": 4},
     {"num_layers": 5, "param_dtype": "bfloat16"}, SERVED_RTOL, 0.15),
)
# (a): in float32 activations (eager, the plain grouped SwiGLU): the served
# logits against the float32 forward and slot 0's SSM states after the
# served tokens against the float32 chunked prefill's over them, which
# differ in summation order only (on an H100 1.0e-5 / 1.4e-5 for mamba2,
# 1.3e-5 / 1.1e-5 for jamba); the same with the prompt's SSM states zeroed
# before the first decode step (logits up to 5.4e-4 / 7.6e-3, states
# 0.28 / 0.14) and jamba's forward without the causal mask land above it.
SSM_F32_RTOL = 5e-5
# (b): the chunked SSD's float32 sums against the sequential recurrence in
# float64, relative RMS of y and of the final state (on an H100 at most
# 2.1e-6), and the recurrent step against one float64 step (7.5e-8); the
# chunks run apart (each chunk's history dropped) land at 0.16-0.20.
SSD_RTOL = 1e-5
# The record_function range the profiles of phase 19 put around the SSD
# (``ssm._ssd_chunked`` in a prefill, ``ssm._ssd_step`` in a decode step):
# its kernels are the "ssd" family.
SSD_SPAN = "ssd"

# Phase 20: the training path.  The two stub configurations, their tags
# and the depth of their full-width runs (b): musicgen-large whole (48
# layers, 3.24 B parameters); internvl2-26b at full width cut to its
# first 8 of 48 layers (4.30 B; 48 layers would be 19.9 B, 80 GB of
# float32 parameters alone).
TRAIN_ARCHS = (("musicgen-large", "[train-audio]", 48),
               ("internvl2-26b", "[train-vision]", 8))
# (a): the check models, full width cut to 2 layers, float32 parameters
# and activations, one TokenPipeline batch of 2 x 512 (internvl2: 256
# patches + 256 tokens), one step on the card beside the same step on the
# CPU (which the CPU tests hold against the reference).
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 512
TRAIN_CHECK_LR = 1e-3
# (a)'s tolerances, card against CPU.  Both compute in float32 (TF32
# off); the card's attention forward is the CUDA-core kernel (within
# FA_F32_ATOL of the plain version), its GEMMs reduce in another order,
# and the embedding gradient accumulates with atomics.  So: the loss, a
# mean over 1024 positions, within TRAIN_LOSS_RTOL; each gradient leaf
# within TRAIN_GRAD_RTOL relative RMS (the controls land at 1: a zero
# gradient); the clipped norm within TRAIN_LOSS_RTOL.  The update (new -
# old parameters) within TRAIN_UPDATE_RTOL relative RMS: Adam's first step
# divides each element by |g| + eps, so where |g| is near eps a small
# absolute error in g becomes a large one in the update (the CPU tests
# measure up to 9.2e-4 between the two CPU packages).  The int8 moments:
# codes equal but for TRAIN_CODE_MISMATCH of them, dequantized within
# TRAIN_DEQ_RTOL.  A code flips where a moment's ratio to its row's
# abs-max lies within its own error of a midpoint, and a small element of
# a gradient carries a relative error far above the leaf's (1.5e-3 of
# internvl2's final_norm.scale codes flipped on an H100, each flip moving
# the element by 13%, its leaf 1.8e-3 relative RMS).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-2
TRAIN_CODE_MISMATCH = 1e-2
TRAIN_DEQ_RTOL = 1e-2
# (a), beside the stubs: a MoE + MLA configuration and a Mamba2 one, each
# at full width cut to TRAIN_CHECK_LAYERS layers (deepseek: its dense
# prefix layer and one MoE layer of 64 experts; mamba2: two SSD layers),
# float32 parameters, one step's gradients on the card against the CPU's
# on the same batch: the backward of torch._grouped_mm, of MLA and of the
# SSD.  The tag, and the card's activation dtype: deepseek trains in bf16
# on the card (its grouped GEMM takes no float32) against the CPU's
# float32; mamba2 in float32 on both.
TRAIN_FAMILIES = (("deepseek-v2-lite-16b", "[train-mla]", "bfloat16"),
                  ("mamba2-370m", "[train-ssm]", "float32"))
# Whole steps each family's step is timed over (the first warms up).
TRAIN_FAMILY_STEPS = 6
# The bf16 step against the float32 one: every activation rounds to bf16
# (2^-9 relative) and the MoE's grouped GEMMs and flash attention compute
# in bf16, so the loss, a mean over 1024 positions, moves by about 2^-9 of
# itself and each gradient leaf by a few 2^-8 relative RMS through two
# layers; a token whose top-6 route flips between the two (a probability
# gap under the bf16 noise) moves its experts' rows.  TRAIN_BF16_*_RTOL
# hold those and stay far below a leaf the backward misses (relative RMS
# 1: the detached control).  The routed leaves are the exception: a token
# whose top-k route differs between the two (its k-th and (k+1)-th
# probabilities closer than the bf16 noise of its logits) moves its
# gradient from one expert's rows to another's, and the router's gradient
# is the combine weights' (a dot product over d_model of the upstream
# gradient and the expert's bf16 output, which cancel) through the
# softmax's Jacobian (a second cancellation).  On an H100 at 700 W the
# expert leaves and the router of deepseek's MoE layer came to 0.074-0.076
# (PERF.md), every other leaf within 0.022, so
# TRAIN_BF16_ROUTED_RTOL holds them: it is still far below an expert or
# router whose gradient is lost (relative RMS 1) or misplaced (about 1.4).
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BF16_GRAD_RTOL = 0.05
TRAIN_BF16_ROUTED_RTOL = 0.25


def bf16_grad_tol(leaf: str) -> float:
    """The bf16 gradient tolerance of a leaf (see TRAIN_BF16_*)."""
    routed = leaf.endswith("router.w") or ".experts." in leaf
    return TRAIN_BF16_ROUTED_RTOL if routed else TRAIN_BF16_GRAD_RTOL
# (a): prefill + one decode step against the forward on the card (float32,
# relative RMS of the logits; summation order only), and the flash
# Function's q/k/v gradients against autograd through
# ref.chunked_attention on the same inputs (the same computation: 0
# expected).
TRAIN_DECODE_RTOL = 1e-4
TRAIN_FN_RTOL = 1e-6
# (b): bf16 activations, float32 master parameters, remat, int8 AdamW,
# TokenPipeline batches of 2 x 2048, TRAIN_STEPS timed steps (the first
# warms up) and one profiled step.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 6
TRAIN_LR = 3e-4
# The record_function range the profiled step puts around the optimizer
# update (its kernels are the "optimizer" family).
OPT_SPAN = "optimizer"
# (c): the launcher on the 100M example's configuration, as subprocesses.
LAUNCH_ARGS = ["--arch", "olmo-100m", "--steps", "60", "--batch", "8",
               "--seq", "128", "--lr", "3e-4", "--save-every", "20",
               "--log-every", "1", "--quantized-opt", "--device", "cuda"]
LAUNCH_PREEMPT_AT = 30
LAUNCH_TIMEOUT_S = 300
# (c): the mean loss of the last LAUNCH_LOSS_WINDOW steps must lie at
# least LAUNCH_LOSS_FALL nats below that of the first.  The stream's floor
# is about (1/8) ln V (1.30 at V = 32,000), far below what 60 steps of
# 1024 tokens reach: each of the 32,000 transitions is seen about twice.
# What falls in 60 steps is the initial logits' spread (10.52 at step 0
# against ln V = 10.37).  At lr 3e-4 an H100 run fell from 10.519 to
# 10.429; at the launcher's default 3e-3, and at 1e-3, the loss rose
# (10.519 -> 10.589 / 10.598): the lr is set here.  Single steps move by
# 0.01-0.02, hence the windows.
LAUNCH_LOSS_WINDOW = 5
LAUNCH_LOSS_FALL = 0.04


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def rc_inputs(B: int, P: int, mode: str, gen: torch.Generator):
    """Tie-heavy values, ragged masks and a share of samples with only a
    few valid rows (fewer than k neighbours)."""
    x = torch.randn(B, P, generator=gen)
    x[:, : P // 4] = torch.round(x[:, : P // 4])
    if mode == "class":
        x = torch.randint(0, 6, (B, P), generator=gen).float()
        x[:, :3] = 100.0 + torch.arange(min(3, P)).float()  # singleton classes
    y = torch.round(torch.randn(B, P, generator=gen) * 10) / 10
    keep = torch.randint(0, P + 1, (B, 1), generator=gen)
    mask = (torch.arange(P)[None, :] < keep) & (torch.rand(B, P, generator=gen) > 0.1)
    few = torch.rand(B, generator=gen) < 0.05
    mask[few] = torch.arange(P)[None, :] < 3
    return x, y, mask


def rc_edge_inputs(B: int, P: int, mode: str, k: int, gen: torch.Generator):
    """``rc_inputs`` plus the edge rows of the staged body's exactness
    argument: NaN and +-inf x or y in valid rows, a run of duplicated
    points (all-zero distances), -0.0 beside +0.0 class codes and a NaN
    class code, and a share of samples with exactly k+1 valid rows (each
    valid row has exactly k neighbours)."""
    x, y, mask = rc_inputs(B, P, mode, gen)
    special = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for v in (x, y):
        hit = torch.rand(B, P, generator=gen) < 0.015
        v[hit] = special[torch.randint(0, 3, (int(hit.sum()),), generator=gen)]
    d0 = P // 2
    d1 = min(P, d0 + max(2, P // 16))
    x[:, d0:d1] = x[:, d0:d0 + 1]
    y[:, d0:d1] = y[:, d0:d0 + 1]
    if mode == "class":
        q = max(1, P // 16)
        x[:, 3:3 + q] = -0.0
        x[:, 3 + q:3 + 2 * q] = 0.0
        x[:, P - 1] = float("nan")
    exact = torch.rand(B, generator=gen) < 0.1
    mask[exact] = torch.arange(P)[None, :] < min(P, k + 1)
    return x, y, mask


RC_CASES = [
    # name, B, P, mode, which, k, kb, kk, edge rows
    ("joint_k3", 4096, 256, "joint", "all", 3, 3, 3, False),
    ("class_k3_y", 4096, 256, "class", "y", 3, 3, 3, False),
    ("joint_k1", 4096, 256, "joint", "all", 1, 1, 1, False),
    ("joint_k8_y", 4096, 256, "joint", "y", 8, 8, 8, False),
    ("class_k8_all", 4096, 256, "class", "all", 8, 8, 8, False),
    ("class_kk6_kb8", 4096, 256, "class", "y", 3, 8, 6, False),
    ("joint_kmax", 512, 256, "joint", "all", 128, 128, 128, False),
    ("joint_p512", 1024, 512, "joint", "all", 3, 3, 3, False),
    ("class_p512", 1024, 512, "class", "y", 3, 3, 3, False),
    ("class_kb128", 1024, 256, "class", "y", 3, 128, 128, False),
    ("joint_k5", 2048, 256, "joint", "all", 5, 5, 5, False),
    ("class_kb5_all", 2048, 256, "class", "all", 3, 5, 4, False),
    ("joint_k15_p1024", 256, 1024, "joint", "all", 15, 15, 15, False),
    ("class_p1024", 256, 1024, "class", "all", 3, 3, 3, False),
    ("joint_p40", 4096, 40, "joint", "all", 3, 3, 3, False),
    ("class_p40", 4096, 40, "class", "y", 3, 3, 3, False),
    ("joint_k16", 512, 256, "joint", "all", 16, 16, 16, False),
    ("joint_k17", 512, 256, "joint", "all", 17, 17, 17, False),
    ("class_kb32", 1024, 256, "class", "all", 3, 32, 32, False),
    ("joint_p2048", 128, 2048, "joint", "all", 3, 3, 3, False),
    ("class_p2048", 128, 2048, "class", "y", 3, 3, 3, False),
    ("edge_joint_k3", 4096, 256, "joint", "all", 3, 3, 3, True),
    ("edge_joint_k3_y", 4096, 256, "joint", "y", 3, 3, 3, True),
    ("edge_class_k3_y", 4096, 256, "class", "y", 3, 3, 3, True),
    ("edge_class_kk6_all", 4096, 256, "class", "all", 3, 8, 6, True),
    ("edge_joint_p40", 4096, 40, "joint", "all", 3, 3, 3, True),
    ("edge_class_p512", 1024, 512, "class", "y", 3, 3, 3, True),
    ("edge_joint_k16", 512, 256, "joint", "all", 16, 16, 16, True),
    ("edge_joint_k17", 512, 256, "joint", "all", 17, 17, 17, True),
    ("edge_class_p2048", 128, 2048, "class", "all", 3, 3, 3, True),
]


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    same = (a == b) | (a.isnan() & b.isnan())
    if bool(same.all()):
        return 0.0
    return float((a.double() - b.double()).abs()[~same].max())


def check_radius_counts(dev) -> float:
    """Phase 2 for radius_counts: every case through the wrapper, bit-equal
    to the plain version, and each body reached by the cases the rule
    sends to it."""
    from repro_torch.kernels.knn_stats import kernel, ref

    gen = torch.Generator().manual_seed(SEED)
    worst = 0.0
    reached = {"staged": 0, "tiled": 0}
    for name, B, P, mode, which, k, kb, kk, edge in RC_CASES:
        make = (lambda: rc_edge_inputs(B, P, mode, k, gen)) if edge else (
            lambda: rc_inputs(B, P, mode, gen))
        x, y, m = (t.to(dev) for t in make())
        args = dict(k=k, kb=kb, kk=kk, mode=mode, which=which)
        body = "staged" if kernel.takes_staged(P, mode, k, kb) else "tiled"
        before = getattr(kernel, f"radius_counts_{body}").launches
        got = kernel.radius_counts(x, y, m, **args)
        want = ref.radius_counts(x, y, m, **args)
        torch.cuda.synchronize()
        if getattr(kernel, f"radius_counts_{body}").launches != before + 1:
            raise AssertionError(f"radius_counts {name} did not reach the {body} body")
        reached[body] += 1
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        log(f"[compare] radius_counts {name} ({body}): B={B} P={P} "
            f"max_abs_err={err}")
        if err != 0.0:
            raise AssertionError(f"radius_counts {name} differs from ref: {err}")
        worst = max(worst, err)
    if not all(reached.values()):
        raise AssertionError(f"a radius_counts body was not reached: {reached}")
    return worst


def pc_inputs(B: int, P: int, kind: str, gen: torch.Generator):
    x = torch.randn(B, P, generator=gen)
    y = torch.randn(B, P, generator=gen)
    mask = torch.rand(B, P, generator=gen) > 0.2
    if kind == "ragged":
        keep = torch.randint(0, P + 1, (B, 1), generator=gen)
        mask &= torch.arange(P)[None, :] < keep
    elif kind == "plateaus":  # exact-zero distances between repeats
        x = torch.round(x)
        y = torch.round(y * 2) / 2
    elif kind == "nonfinite":
        for v in (x, y):
            pick = torch.rand(B, P, generator=gen)
            v[pick < 0.02] = float("nan")
            v[(pick >= 0.02) & (pick < 0.04)] = float("inf")
            v[(pick >= 0.04) & (pick < 0.06)] = float("-inf")
    return x, y, mask


PC_CASES = [("b4096_p256", 4096, 256, "random"), ("p300_ragged", 1024, 300, "ragged"),
            ("p512", 1024, 512, "random"), ("plateaus", 2048, 256, "plateaus"),
            ("nonfinite", 1024, 256, "nonfinite")]


def check_pairwise_cheb(dev) -> float:
    from repro_torch.kernels.pairwise_cheb import kernel, ref

    gen = torch.Generator().manual_seed(SEED + 1)
    worst = 0.0
    for name, B, P, kind in PC_CASES:
        x, y, m = (t.to(dev) for t in pc_inputs(B, P, kind, gen))
        got = kernel.pairwise_cheb(x, y, m)
        want = ref.pairwise_cheb(x, y, m)
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        nan = sum(int(w.isnan().sum()) for w in want)
        log(f"[compare] pairwise_cheb {name}: B={B} P={P} max_abs_err={err} "
            f"(NaN entries {nan}, positions equal)")
        if err != 0.0:
            raise AssertionError(f"pairwise_cheb {name} differs from ref: {err}")
        if kind == "nonfinite" and nan == 0:
            raise AssertionError("the non-finite case produced no NaN")
        worst = max(worst, err)
        del got, want
    return worst


def spacing(want: torch.Tensor) -> torch.Tensor:
    """The spacing of ``want``'s 16-bit dtype at ``want`` (bfloat16: 8
    significant bits, 2^(e-8) for |want| in [2^(e-1), 2^e); float16: 11
    bits, 2^(e-11))."""
    w = want.float()
    bits = 11 if want.dtype == torch.float16 else 8
    return torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - bits) \
        .clamp_min(2.0 ** -133)


def fa_within(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float, float]:
    """(within tolerance, max abs error, worst error in bfloat16 spacings
    or nan).  float32: atol FA_F32_ATOL.  bfloat16: one spacing of the
    plain version's output plus FA_F32_ATOL, since each side rounds its
    float32 result once and the two float32 results differ by up to
    FA_F32_ATOL; near zero (outputs that come out of cancellation) that
    absolute difference spans several spacings."""
    err = _max_abs_err(got, want)
    if got.dtype == torch.float32:
        return err <= FA_F32_ATOL, err, float("nan")
    diff = (got.float() - want.float()).abs()
    ulp = spacing(want)
    ok = bool((diff <= FA_BF16_ULPS * ulp + FA_F32_ATOL).all())
    return ok, err, float((diff / ulp).max())


def fa_within_p(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor,
                group: int) -> tuple[bool, float, float]:
    """The Hopper kernel's tolerance: (within, max abs error, worst error
    in units of the bound).  The bound is one spacing of the output dtype
    at ``want`` + FA_P_VREL * max|v| over the (batch, KV head) the output
    row reads + FA_F32_ATOL."""
    vmax = v.float().abs().amax(dim=(2, 3), keepdim=True)
    tol = (spacing(want) + FA_P_VREL * vmax.repeat_interleave(group, dim=1)
           + FA_F32_ATOL)
    units = float(((got.float() - want.float()).abs() / tol).max())
    return units <= 1.0, _max_abs_err(got, want), units


def check_flash_attention(dev) -> dict:
    """Both kernels against their plain versions on synthetic cases, each
    case through the dispatching ``kernel.flash_attention`` and required
    to reach the kernel (and, for the CUDA-core kernel, the body) the rules
    name; a case of the register-tiled body is also held within atol
    FA_F32_ATOL of the basic body on the same inputs.  Returns the worst
    errors by wrapper name."""
    from functools import partial

    from repro_torch.kernels.flash_attention import kernel, ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    names = ("flash_attention_simt_regtile", "flash_attention_simt_basic",
             "flash_attention_wgmma")
    worst = dict.fromkeys(names, 0.0)
    units = dict.fromkeys(names, 0.0)
    n = dict.fromkeys(names, 0)
    body_gap = 0.0
    for dtype, dk, dv, S, group, causal in FA_CASES:
        hq = FA_HKV * group
        q = torch.randn(1, hq, S, dk, generator=gen, device=dev).to(dtype)
        k = torch.randn(1, FA_HKV, S, dk, generator=gen, device=dev).to(dtype)
        v = torch.randn(1, FA_HKV, S, dv, generator=gen, device=dev).to(dtype)
        scale = 1.0 / dk ** 0.5
        hopper = dtype != torch.float32 and (dk, dv) in kernel.WGMMA_HEAD_DIMS
        if hopper:
            name, want_launches = "flash_attention_wgmma", {"flash_attention_wgmma": 1}
        else:
            name = ("flash_attention_simt_regtile" if kernel.takes_regtile(q, k, v)
                    else "flash_attention_simt_basic")
            want_launches = {"flash_attention": 1, name: 1}
        reset_launches()
        got = kernel.flash_attention(q, k, v, scale=scale, causal=causal)
        case = (f"{str(dtype)[6:]} Dk={dk} Dv={dv} S={S} group={group} "
                f"causal={causal}")
        if read_launches() != {**{k_: 0 for k_ in wrappers()}, **want_launches}:
            raise AssertionError(f"flash_attention {case} did not reach "
                                 f"{name}: {read_launches()}")
        if hopper:
            plains = (partial(ref.chunked_attention, p_dtype=dtype),
                      ref.mha_reference)
        else:
            plains = (ref.chunked_attention, ref.mha_reference)
        for plain in plains:
            want = plain(q, k, v, scale=scale, causal=causal)
            torch.cuda.synchronize()
            if hopper:
                ok, err, u = fa_within_p(got, want, v, group)
            else:
                ok, err, u = fa_within(got, want)
            if not ok:
                raise AssertionError(f"{name} {case} differs from its plain "
                                     f"version: max_abs_err={err}, units={u}")
            worst[name] = max(worst[name], err)
            if u == u:
                units[name] = max(units[name], u)
        if name == "flash_attention_simt_regtile":
            basic = kernel.flash_attention_simt_basic(q, k, v, scale=scale,
                                                      causal=causal)
            ok, err, _ = fa_within(got, basic)
            if not ok:
                raise AssertionError(f"{name} {case} differs from the basic "
                                     f"body: max_abs_err={err}")
            body_gap = max(body_gap, err)
        n[name] += 1
        del got, want
    if not all(n.values()):
        raise AssertionError(f"a flash body was never reached: {n}")
    log(f"[compare] flash_attention_wgmma: {n['flash_attention_wgmma']} cases "
        f"(bf16/fp16 at (Dk, Dv) in {sorted(kernel.WGMMA_HEAD_DIMS)}) within 1 "
        f"spacing + {FA_P_VREL} max|v| + {FA_F32_ATOL} of mha_reference and of "
        f"chunked_attention(p_dtype): max_abs_err="
        f"{worst['flash_attention_wgmma']}, worst error in units of the bound="
        f"{units['flash_attention_wgmma']}")
    log(f"[compare] flash_attention (CUDA cores), register-tiled body: "
        f"{n['flash_attention_simt_regtile']} cases (float32, Dk and Dv <= 128) "
        f"within atol {FA_F32_ATOL} of chunked_attention, mha_reference and the "
        f"basic body: max_abs_err={worst['flash_attention_simt_regtile']}, "
        f"against the basic body {body_gap}")
    log(f"[compare] flash_attention (CUDA cores), basic body: "
        f"{n['flash_attention_simt_basic']} cases (float32 above 128, 16-bit "
        f"at other head dims; float32 within atol {FA_F32_ATOL}, 16-bit within "
        f"{FA_BF16_ULPS} spacing + {FA_F32_ATOL}) against chunked_attention and "
        f"mha_reference: max_abs_err={worst['flash_attention_simt_basic']}, "
        f"worst 16-bit error in spacings={units['flash_attention_simt_basic']}")
    return worst


def serving_layouts(dtype, S: int, gen: torch.Generator, dev) -> dict:
    """The Hopper kernel's operands as the MoE serving path makes them:
    ``qwen3-moe``'s GQA group 8 (Hq 32 / Hkv 4, head dim 128) as
    transposed views of (B, S, H, D) projections, and MLA's exact layout
    (``mla.apply``): q the nope/rope concatenation, k the expanded
    latent's nope part concatenated with the broadcast rope key, v a
    strided slice of the ``kv_up`` output (row stride H * 256)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    h = 16
    kv = rand(1, S, h, 128 + 128)  # kv_up's output, (B, S, h, dn + dv)
    k_rope = rand(1, S, 64)
    k = torch.cat([kv[..., :128], k_rope[:, :, None, :].expand(1, S, h, 64)],
                  dim=-1)
    return {
        "gqa_group8": (rand(1, S, 32, 128).transpose(1, 2),
                       rand(1, S, 4, 128).transpose(1, 2),
                       rand(1, S, 4, 128).transpose(1, 2)),
        "mla": (rand(1, S, h, 192).transpose(1, 2), k.transpose(1, 2),
                kv[..., 128:].transpose(1, 2)),
    }


def check_flash_serving_layouts(dev) -> float:
    """Phase 2, the Hopper kernel at the MoE serving path's operand
    layouts (``serving_layouts``), bf16 and fp16, causal and not: each
    case through ``kernel.flash_attention``, required to reach the Hopper
    kernel (one launch, nothing else), within its tolerance of both plain
    versions.  Returns the worst max_abs_err."""
    from functools import partial

    from repro_torch.kernels.flash_attention import kernel, ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    worst, units, n = 0.0, 0.0, 0
    for dtype in (torch.bfloat16, torch.float16):
        for S in (100, 2048):
            for name, (q, k, v) in serving_layouts(dtype, S, gen, dev).items():
                for causal in (True, False):
                    case = f"{name} {str(dtype)[6:]} S={S} causal={causal}"
                    if not kernel.takes_wgmma(q, k, v):
                        raise AssertionError(f"takes_wgmma refuses {case}: q "
                                             f"{q.stride()}, k {k.stride()}, v "
                                             f"{v.stride()}")
                    scale = 1.0 / q.shape[-1] ** 0.5
                    reset_launches()
                    got = kernel.flash_attention(q, k, v, scale=scale,
                                                 causal=causal)
                    if read_launches() != {**{k_: 0 for k_ in wrappers()},
                                           "flash_attention_wgmma": 1}:
                        raise AssertionError(f"{case} did not reach the Hopper "
                                             f"kernel alone: {read_launches()}")
                    for plain in (partial(ref.chunked_attention, p_dtype=dtype),
                                  ref.mha_reference):
                        want = plain(q, k, v, scale=scale, causal=causal)
                        ok, err, u = fa_within_p(got, want, v,
                                                 q.shape[1] // k.shape[1])
                        if not ok:
                            raise AssertionError(f"flash_attention_wgmma {case} "
                                                 f"differs from its plain version: "
                                                 f"max_abs_err={err}, units={u}")
                        worst, units = max(worst, err), max(units, u)
                    n += 1
    log(f"[compare] flash_attention_wgmma at the MoE serving layouts (GQA group "
        f"8 at head dim 128; MLA (192, 128) with v a strided slice of kv_up's "
        f"output): {n} cases, each one launch of the Hopper kernel, within 1 "
        f"spacing + {FA_P_VREL} max|v| + {FA_F32_ATOL} of both plain versions: "
        f"max_abs_err={worst}, worst error in units of the bound={units}")
    return worst


# 512: the LV2SK/PRISK 2n capacity; 1024: the staged bodies' widest
# sample; 1025 the tiled bodies'.  kb = 16 is the staged knn_smallest's
# widest buffer, 128 (K_MAX) the tiled one's.
TWO_OP_P = (1, 2, 31, 255, 256, 257, 512, 1024, 1025)
TWO_OP_KB = (1, 3, 8, 16, 128)
HASH_N = (0, 1, 127, 32769)
HASH_EDGE = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)


def two_op_inputs(B: int, P: int, mode: str, gen: torch.Generator):
    """``rc_inputs`` plus an all-invalid sample and +-inf values."""
    x, y, mask = rc_inputs(B, P, mode, gen)
    mask[0] = False
    pick = torch.rand(B, P, generator=gen)
    y[pick < 0.01] = float("inf")
    y[(pick >= 0.01) & (pick < 0.02)] = float("-inf")
    if mode == "joint":
        x[(pick >= 0.02) & (pick < 0.03)] = float("inf")
    return x, y, mask


def bit_equal(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want`` (tensors or tuples of
    them), which must be 0 (NaN positions equal)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    err = max(_max_abs_err(g, w) for g, w in zip(got, want))
    if err != 0.0:
        raise AssertionError(f"{name} differs from its plain version: {err}")
    return err


def two_op_body(name: str, P: int, kb: int = 1) -> str:
    """The body of knn_smallest / ball_counts that the rule names."""
    from repro_torch.kernels.knn_stats import kernel

    return f"{name}_{'staged' if kernel.takes_staged_two_op(P, kb) else 'tiled'}"


def check_knn_two_op(dev) -> float:
    """knn_smallest (joint and class, every P and kb) and ball_counts
    (both ``which``, r = 0, +inf, NaN, an existing distance) against their
    plain versions, bit-equal, each case through the dispatching wrapper
    and required to reach the body the rule names; every body reached."""
    from repro_torch.kernels.knn_stats import kernel, ref

    gen = torch.Generator().manual_seed(SEED + 3)
    worst, n = 0.0, 0
    reached = {f"{op}_{b}": 0 for op in ("knn_smallest", "ball_counts")
               for b in ("staged", "tiled")}

    def hold(name, body, fn, want):
        reset_launches()
        got = fn()
        if read_launches()[body] != 1:
            raise AssertionError(f"{name} did not reach {body}: {read_launches()}")
        reached[body] += 1
        return bit_equal(name, got, want)

    for mode in ("joint", "class"):
        for P in TWO_OP_P:
            B = 16 if P > 512 else 64 if P > 256 else 256
            x, y, m = (t.to(dev) for t in two_op_inputs(B, P, mode, gen))
            for kb in TWO_OP_KB:
                worst = max(worst, hold(
                    f"knn_smallest {mode} P={P} kb={kb}",
                    two_op_body("knn_smallest", P, kb),
                    lambda: kernel.knn_smallest(x, y, m, kb=kb, mode=mode),
                    ref.knn_smallest(x, y, m, kb=kb, mode=mode)))
                n += 1
            if mode == "class":
                continue
            knn, _ = ref.knn_smallest(x, y, m, kb=3, mode="joint")
            radii = {"zero": torch.zeros_like(x),
                     "inf": torch.full_like(x, float("inf")),
                     "nan": torch.full_like(x, float("nan")),
                     "distance": knn[..., 2].contiguous()}
            for rname, r in radii.items():
                for which in ("all", "y"):
                    worst = max(worst, hold(
                        f"ball_counts {which} P={P} r={rname}",
                        two_op_body("ball_counts", P),
                        lambda: kernel.ball_counts(x, y, m, r, which=which),
                        ref.ball_counts(x, y, m, r, which=which)))
                    n += 1
    if not all(reached.values()):
        raise AssertionError(f"a two-op body was not reached: {reached}")
    log(f"[compare] knn_smallest / ball_counts: {n} cases (P {TWO_OP_P}, kb "
        f"{TWO_OP_KB}, joint and class; r = 0, +inf, NaN, an existing "
        f"distance; which all and y; all-invalid samples, ties, +-inf values), "
        f"each through the body the rule names {reached}: max_abs_err={worst}")
    return worst


def check_hash_keys(dev) -> float:
    """hash_keys against its plain version on the card and the host's
    numpy hashes, bit-equal: edge words, scalar and per-element seeds,
    Fibonacci on and off."""
    from repro_torch.core import hashing
    from repro_torch.kernels.murmur3 import ops, ref

    rng = np.random.default_rng(SEED + 4)
    worst, n = 0.0, 0
    for size in HASH_N:
        words = rng.integers(0, 2**32, size=size, dtype=np.uint32)
        words[:min(size, len(HASH_EDGE))] = HASH_EDGE[:size]
        seeds = rng.integers(0, 2**32, size=size, dtype=np.uint32)
        keys = torch.from_numpy(words.astype(np.int64)).to(dev)
        for seed in (0xFFFFFFFF, torch.from_numpy(seeds.astype(np.int64)).to(dev)):
            host_seed = seed if isinstance(seed, int) else seeds
            host = hashing.murmur3_32_np(words, seed=host_seed)
            for fib in (True, False):
                got = ops.hash_keys(keys, seed, fibonacci=fib)
                worst = max(worst, bit_equal(
                    f"hash_keys n={size} fib={fib}", got,
                    ref.murmur3_fib_ref(keys, seed, fibonacci=fib)))
                on_host = hashing.fibonacci32_np(host) if fib else host
                if not np.array_equal(got.cpu().numpy(), on_host):
                    raise AssertionError(f"hash_keys n={size} fib={fib} differs "
                                         "from the host's numpy hashes")
                n += 1
    log(f"[compare] hash_keys: {n} cases (n {HASH_N}, words {HASH_EDGE}, scalar "
        f"and per-element seeds, Fibonacci on and off) against the plain version "
        f"and murmur3_32_np/fibonacci32_np: max_abs_err={worst}")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def key_words(c: int) -> np.ndarray:
    """The raw key words of lake column c: the joinable columns (c % 16
    == 1) share the train key universe 0..383, every other column has a
    range of its own."""
    if c % 16 == 1:
        return np.arange(N_ROWS, dtype=np.uint32)
    return np.arange((c + 1) * N_ROWS, (c + 2) * N_ROWS, dtype=np.uint32)


def make_corpus(C: int, seed: int = SEED):
    """A lake of C candidate columns, each a 384-row table.

    One joinable candidate in 16 shares the train key universe, with a
    graded dependence on the target; the rest have disjoint keys.  A
    quarter of all columns are discrete.  The first joinable slots hold
    the planted strongest candidates: exact copies of the target
    (continuous) and exact codes of its discretisation (discrete).
    Returns (rows, train key hashes, target y, its 8-bin edges, planted
    continuous names, planted discrete names); each row is the arguments
    of one ``SketchIndex.add`` call.
    """
    from repro_torch.core import hashing

    rng = np.random.default_rng(seed)
    keys = hashing.murmur3_32_np(key_words(1), seed=np.uint32(KEY_SEED))
    y = rng.normal(size=N_ROWS).astype(np.float32)
    edges = np.quantile(y, np.linspace(0, 1, 9)[1:-1])
    rows, planted_c, planted_d = [], [], []
    j = 0
    for c in range(C):
        name = f"t{c:05d}"
        if c % 16 == 1:
            disc = j % 4 == 0
            if j < 2 * N_PLANTED:
                v = np.digitize(y, edges).astype(np.int64) if disc else y.copy()
                (planted_d if disc else planted_c).append(name)
            else:
                a = rng.uniform(0.0, 0.9)
                v = (a * y + (1 - a) * rng.normal(size=N_ROWS)).astype(np.float32)
                if disc:
                    v = np.digitize(v, edges).astype(np.int64)
            rows.append((name, "k", "v", keys, v, disc))
            j += 1
            continue
        disc = c % 4 == 0
        kk = hashing.murmur3_32_np(key_words(c), seed=np.uint32(KEY_SEED))
        v = (rng.integers(0, 8, size=N_ROWS).astype(np.int64) if disc
             else rng.normal(size=N_ROWS).astype(np.float32))
        rows.append((name, "k", "v", kk, v, disc))
    return rows, keys, y, edges, planted_c, planted_d


def make_queries(keys, y, edges, q: int, seed: int = SEED + 1):
    """Q continuous-target and Q discrete-target train sketches: the
    target plus a little noise, and its 8-bin discretisation."""
    from repro_torch.core.sketch import build_sketch

    rng = np.random.default_rng(seed)
    cont, disc = [], []
    for _ in range(q):
        yq = (y + 0.05 * rng.normal(size=N_ROWS)).astype(np.float32)
        cont.append(build_sketch(keys, yq, n=N_SKETCH, side="train",
                                 value_is_discrete=False))
        disc.append(build_sketch(keys, np.digitize(yq, edges).astype(np.int64),
                                 n=N_SKETCH, side="train",
                                 value_is_discrete=True))
    return cont, disc


def build_index(rows, device):
    from repro_torch.core.discovery import SketchIndex

    index = SketchIndex(n=N_SKETCH, method="tupsk", device=device)
    for r in rows:
        index.add(*r)
    return index


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_pass(index, batches, device, **query_kw) -> tuple[float, list]:
    """One ``query_many`` per target dtype (``query_kw`` passed on); wall
    seconds and results."""
    t0 = time.perf_counter()
    out = [index.query_many(b, top_k=TOP_K, min_join=MIN_JOIN, **query_kw)
           for b in batches]
    sync(device)
    return time.perf_counter() - t0, out


def check_planted(results, planted_c, planted_d) -> None:
    cont_res, disc_res = results
    for res in cont_res:
        top = {m.table for m, _, _ in res[:len(planted_c)]}
        if top != set(planted_c):
            raise AssertionError(
                f"continuous target: top {len(planted_c)} {sorted(top)} are "
                f"not the planted copies {planted_c}")
    for res in disc_res:
        if res[0][0].table not in set(planted_c) | set(planted_d):
            raise AssertionError(
                f"discrete target: top result {res[0][0].table} is not planted")


def same_rankings(a, b, tol: float = 1e-5) -> None:
    """Equal join sizes and rankings, MI within rtol/atol ``tol``; two
    entries may swap only where their scores lie within tolerance."""
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            raise AssertionError(f"result lengths differ: {len(ra)} vs {len(rb)}")
        score_b = {m.table: (mi, js) for m, mi, js in rb}
        for (ma, mia, jsa), (mb, mib, jsb) in zip(ra, rb):
            if not np.isclose(mia, mib, rtol=tol, atol=tol):
                raise AssertionError(f"MI differs at {ma.table}/{mb.table}: {mia} vs {mib}")
            if ma.table != mb.table:
                if ma.table not in score_b or not np.isclose(
                        score_b[ma.table][0], mia, rtol=tol, atol=tol):
                    raise AssertionError(f"ranking differs: {ma.table} vs {mb.table}")
                continue
            if jsa != jsb:
                raise AssertionError(f"join size differs at {ma.table}: {jsa} vs {jsb}")


# ---------------------------------------------------------------------------
# Phase 5: the main path's own kernel launches
# ---------------------------------------------------------------------------

def capture_launches(index, batches, **query_kw) -> list:
    """One warm ``query_many`` per batch (``query_kw`` passed on) with
    the kernel's wrapper wrapped to keep a copy of each launch's inputs,
    arguments and outputs, exactly as the main path made it.  The wrap
    replaces the module ``ops`` dispatches through, so the wrapper itself
    (and its launch counter) stays untouched.  It runs under
    ``compile.eager()``: a replayed program makes no Python call to wrap.
    Fails on a non-finite MI."""
    from types import SimpleNamespace

    from repro_torch import compile as programs
    from repro_torch.kernels.knn_stats import kernel, ops

    seen = []

    def spy(x, y, mask, **args):
        out = kernel.radius_counts(x, y, mask, **args)
        seen.append((x.clone(), y.clone(), mask.clone(), args,
                     tuple(o.clone() for o in out)))
        return out

    ops.kernel = SimpleNamespace(radius_counts=spy)
    try:
        with programs.eager():
            for b in batches:
                res = index.query_many(b, top_k=TOP_K, min_join=MIN_JOIN,
                                       **query_kw)
                if not all(np.isfinite(mi) for r in res for _, mi, _ in r):
                    raise AssertionError(
                        f"query_many {query_kw} returned a non-finite MI")
    finally:
        ops.kernel = kernel
    torch.cuda.synchronize()
    return seen


def bound(f_ops: float, i_ops: float, nbytes: float) -> dict:
    """Least time for the work: its float and int operations at the
    issue rates, or its bytes over the HBM rate, whichever is longer."""
    t_ops = 1e3 * max((f_ops + i_ops) / FP32_INSTR_PER_S,
                      i_ops / INT32_INSTR_PER_S)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops, "bytes_ms": t_bytes,
        "float_ops": f_ops, "int_ops": i_ops, "bytes": nbytes,
    }


def bound_by(rows: list[dict]) -> str:
    """What bounds the sum of several launches."""
    return ("operations" if sum(r["ops_ms"] for r in rows)
            >= sum(r["bytes_ms"] for r in rows) else "bytes")


def pair_counts(mask: torch.Tensor, mode: str, cnt: torch.Tensor) -> tuple:
    """(valid j != i pairs, same-class pairs) of these samples."""
    n = mask.sum(-1, dtype=torch.float64)
    pairs = float((n * (n - 1)).sum())
    same = float(cnt[mask].sum(dtype=torch.float64)) if mode == "class" else 0.0
    return pairs, same


def band_pairs(x: torch.Tensor, mask: torch.Tensor, r: torch.Tensor,
               longest: bool = False):
    """Valid (i, j != i) pairs with |fl(x_i - x_j)| < r_i: the columns
    joint selection has to visit (NaN meets no condition); with
    ``longest``, also the most any one row visits."""
    B, P = x.shape
    off_diag = ~torch.eye(P, dtype=torch.bool, device=x.device)
    chunk = max(1, (1 << 26) // (P * P))
    total, most = 0, 0
    for s in range(0, B, chunk):
        xs, ms = x[s:s + chunk], mask[s:s + chunk]
        near = (xs[:, :, None] - xs[:, None, :]).abs() < r[s:s + chunk, :, None]
        per_row = (near & ms[:, :, None] & ms[:, None, :] & off_diag).sum(-1)
        total += int(per_row.sum())
        most = max(most, int(per_row.max())) if per_row.numel() else most
    return (float(total), most) if longest else float(total)


def rc_bound(x: torch.Tensor, mask: torch.Tensor, args: dict,
             want: tuple) -> dict:
    """Least time for one launch on these inputs: the operations its
    data needs at the issue rates, or its bytes over the HBM rate, by
    the cheaper of the two sorted routes (RC_NEED_*: one sort by x and a
    y sweep; RC_ROUTE_*: two sorts and binary searches).  Each route's
    bound sits beside it (``x_route_bound_ms``, ``two_order_bound_ms``),
    and the direct algorithm's (RC_OPS) as ``rc_ops_*``."""
    mode, which = args["mode"], args["which"]
    r, cnt, counts = want
    nbytes = mask.numel() * RC_BYTES_PER_ROW
    pairs, same = pair_counts(mask, mode, cnt)
    (pf, pi), (sf, si) = RC_OPS[(mode, which)]
    direct = bound(pairs * pf + same * sf, pairs * pi + same * si, nbytes)

    n = mask.sum(-1, dtype=torch.float64)
    rows = float(n.sum())
    sort = float((torch.lgamma(n + 1) / np.log(2)).sum())
    search = float((n * torch.ceil(torch.log2(n + 1))).sum())  # one a row
    f, i = sort, 0.0
    yf, yi = RC_NEED_Y[which]
    f, i = f + pairs * yf, i + pairs * yi
    route_f = 2 * sort + RC_ROUTE_SEARCHES[which] * search * RC_NEED_STEP[0]
    if mode == "joint":
        band = band_pairs(x, mask, r)
        f, i = f + band * RC_NEED_BAND[0], i + band * RC_NEED_BAND[1]
        route_f += band * RC_NEED_BAND[0]
    else:
        band = 0.0
        f, i = f + rows + same * RC_NEED_SAME[0], i + rows + same * RC_NEED_SAME[1]
        t = (torch.clamp(cnt, max=args["kk"]) - 1).clamp_(0, args["kb"] - 1)
        merge = float(torch.minimum(t + 1, cnt)[mask].sum(dtype=torch.float64))
        route_f += (RC_ROUTE_RUN_SEARCHES * search * RC_NEED_STEP[0]
                    + merge * RC_ROUTE_MERGE[0])
    ties = 0.0
    if which == "all":
        ties = float(counts[2][mask].sum(dtype=torch.float64))
        steps = RC_NEED_SEARCHES * search
        f += ties * RC_NEED_TIE[0] + steps * RC_NEED_STEP[0]
        i += ties * RC_NEED_TIE[1] + steps * RC_NEED_STEP[1]
    x_route = bound(f, i, nbytes)
    two_order = bound(route_f, 0.0, nbytes)
    best = min(x_route, two_order, key=lambda b: b["bound_ms"])
    return {**best,
            "x_route_bound_ms": x_route["bound_ms"],
            "two_order_bound_ms": two_order["bound_ms"],
            "rc_ops_bound_ms": direct["bound_ms"],
            "rc_ops_float_ops": direct["float_ops"],
            "rc_ops_int_ops": direct["int_ops"],
            "valid_pairs": pairs, "same_class_pairs": same,
            "band_pairs": band, "x_tie_pairs": ties}


def time_cuda(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_main_launches(seen: list, card: str) -> list[dict]:
    """Each captured launch against the plain version on its own inputs
    (bit-equal required), then timed there: CUDA events and profiler
    device time, beside the plain version and the bound; a staged launch
    also through the tiled body (the two-order route) on the same inputs,
    held bit-equal and timed."""
    from repro_torch.kernels.knn_stats import kernel, ref

    rows = []
    for x, y, m, args, got in seen:
        want = ref.radius_counts(x, y, m, **args)
        B, P = x.shape
        staged = kernel.takes_staged(P, args["mode"], args["k"], args["kb"])
        # The tiled body takes every launch the staged one does.
        tiled_err = max(_max_abs_err(g, w) for g, w in zip(
            kernel.radius_counts_tiled(x, y, m, **args), want)) if staged else 0.0
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        name = f"{args['mode']}/{args['which']} k={args['k']} B={B} P={P}"
        log(f"[compare] radius_counts main-path launch {name}: "
            f"max_abs_err={err} (the tiled body on the same inputs {tiled_err})")
        if err != 0.0 or tiled_err != 0.0:
            raise AssertionError(
                f"radius_counts main-path launch {name} differs from ref: "
                f"{err}, tiled body {tiled_err}")

        def launch():
            kernel.radius_counts(x, y, m, **args)

        ms = time_cuda(launch, 20)
        device_ms = device_ms_per_call([launch])
        plain_ms = time_cuda(lambda: ref.radius_counts(x, y, m, **args), 2)
        row = {"mode": args["mode"], "which": args["which"], "k": args["k"],
               "kb": args["kb"], "B": B, "P": P,
               "body": "staged" if staged else "tiled", "max_abs_err": err,
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
               **rc_bound(x, m, args, want)}
        row["bound_share"] = row["bound_ms"] / ms
        row["rc_ops_share"] = row["rc_ops_bound_ms"] / ms
        other = ""
        if staged:
            row["tiled_ms"] = time_cuda(
                lambda: kernel.radius_counts_tiled(x, y, m, **args), 10)
            other = f", the tiled body {row['tiled_ms']:.4f} ms"
        log(f"[time] radius_counts {name} ({row['body']}): {ms:.4f} ms events, "
            f"{device_ms:.4f} ms device, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {100 * row['bound_share']:.1f}%; the x route's "
            f"{row['x_route_bound_ms']:.4f} ms, two orders' "
            f"{row['two_order_bound_ms']:.4f} ms; the direct "
            f"algorithm's {row['rc_ops_bound_ms']:.4f} ms, "
            f"{100 * row['rc_ops_share']:.1f}%){other}, "
            f"plain {plain_ms:.4f} ms; card {card}")
        rows.append(row)
    return rows


def run_wide_buffer(index, batches, card: str) -> dict:
    """Phase 14: ``query_many`` per target dtype at k=WIDE_K, a buffer
    width the staged body does not take: the first pass builds the k=32
    programs, and the second, replayed, must reach the tiled body only
    (counts set to 0 just before it, read just after); then each launch
    of a pass, captured under ``eager()``, held bit-equal to the plain
    version on its own inputs and timed there."""
    from repro_torch.compile import compile_count

    n0 = compile_count()
    run_pass(index, batches, "cuda", k=WIDE_K)
    built = compile_count() - n0
    reset_launches()
    run_pass(index, batches, "cuda", k=WIDE_K)
    launches = read_launches()
    if launches["radius_counts_tiled"] != 3 or launches["radius_counts_staged"]:
        raise AssertionError(f"k={WIDE_K} warm query_many launched {launches}; "
                             "expected 3 launches of the tiled body only")
    seen = capture_launches(index, batches, k=WIDE_K)
    if len(seen) != 3:
        raise AssertionError(f"captured {len(seen)} launches at k={WIDE_K}")
    rows = check_main_launches(seen, card)
    return {"k": WIDE_K, "launches": launches, "programs_built": built,
            "rows": rows}


# Phase 14 (b): the tiled body alone, (B, P, mode, which, k, kb) on
# rc_inputs: long samples at B = 1, wide buffers at the lake's P = 256.
TILED_SWEEP = [(1, P, mode, which, 3, 3) for P in (2048, 10000, 40000)
               for mode, which in (("joint", "all"), ("class", "y"))] + [
    (C_MAIN, 256, mode, which, k if mode == "joint" else 3, k)
    for k in (32, 64, 128)
    for mode, which in (("joint", "all"), ("class", "y"))]


def run_tiled_sweep(card: str, dev) -> list[dict]:
    """Phase 14 (b): each ``TILED_SWEEP`` case through the tiled body,
    bit-equal to the plain version, timed with CUDA events beside its
    bounds (``rc_bound``)."""
    from repro_torch.kernels.knn_stats import kernel, ref

    gen = torch.Generator().manual_seed(SEED + 14)
    rows = []
    t0 = time.perf_counter()
    for B, P, mode, which, k, kb in TILED_SWEEP:
        x, y, m = (t.to(dev) for t in rc_inputs(B, P, mode, gen))
        args = dict(k=k, kb=kb, kk=kb, mode=mode, which=which)
        want = ref.radius_counts(x, y, m, **args)
        got = kernel.radius_counts_tiled(x, y, m, **args)
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        name = f"{mode}/{which} k={k} kb={kb} B={B} P={P}"
        if err != 0.0:
            raise AssertionError(f"radius_counts_tiled {name} differs from ref: {err}")
        ms = time_cuda(lambda: kernel.radius_counts_tiled(x, y, m, **args), 10)
        row = {"mode": mode, "which": which, "k": k, "kb": kb, "B": B, "P": P,
               "max_abs_err": err, "ms": ms, **rc_bound(x, m, args, want)}
        row["bound_share"] = row["bound_ms"] / ms
        log(f"[time] radius_counts_tiled sweep {name}: {ms:.4f} ms events, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{100 * row['bound_share']:.1f}%; the x route's "
            f"{row['x_route_bound_ms']:.4f} ms, "
            f"{100 * row['x_route_bound_ms'] / ms:.1f}%; two orders' "
            f"{row['two_order_bound_ms']:.4f} ms; the direct algorithm's "
            f"{row['rc_ops_bound_ms']:.4f} ms), max_abs_err={err}; card {card}")
        rows.append(row)
        del x, y, m, want, got
        torch.cuda.empty_cache()
    log(f"[time] radius_counts_tiled sweep: {len(rows)} cases bit-equal in "
        f"{time.perf_counter() - t0:.2f} s")
    return rows


# ---------------------------------------------------------------------------
# Phases 7-9: the service front end over the phase-3 index
# ---------------------------------------------------------------------------

def wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.knn_stats import kernel as rc_kernel
    from repro_torch.kernels.murmur3 import kernel as mm_kernel
    from repro_torch.kernels.pairwise_cheb import kernel as pc_kernel
    from repro_torch.models import ffn

    return {"radius_counts": rc_kernel.radius_counts,
            "radius_counts_staged": rc_kernel.radius_counts_staged,
            "radius_counts_tiled": rc_kernel.radius_counts_tiled,
            "knn_smallest": rc_kernel.knn_smallest,
            "knn_smallest_staged": rc_kernel.knn_smallest_staged,
            "knn_smallest_tiled": rc_kernel.knn_smallest_tiled,
            "ball_counts": rc_kernel.ball_counts,
            "ball_counts_staged": rc_kernel.ball_counts_staged,
            "ball_counts_tiled": rc_kernel.ball_counts_tiled,
            "pairwise_cheb": pc_kernel.pairwise_cheb,
            "murmur3_fib": mm_kernel.murmur3_fib,
            "flash_attention": fa_kernel.flash_attention_simt,
            "flash_attention_simt_regtile": fa_kernel.flash_attention_simt_regtile,
            "flash_attention_simt_basic": fa_kernel.flash_attention_simt_basic,
            "flash_attention_wgmma": fa_kernel.flash_attention_wgmma,
            # The MoE layers' grouped GEMM (torch._grouped_mm, a library
            # call): counted as the kernels are, through replays too.
            "grouped_swiglu_mm": ffn.grouped_swiglu_mm}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def by_query(queue_results, n: int) -> list:
    """Split results of the interleaved queue (cont 0, disc 0, cont 1,
    ...) back into [continuous results, discrete results]."""
    return [list(queue_results[0:2 * n:2]), list(queue_results[1:2 * n:2])]


def timed_submit(svc, queue) -> tuple[float, list]:
    t0 = time.perf_counter()
    out = svc.submit(queue, top_k=TOP_K, min_join=MIN_JOIN)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_submit(svc, queue, warm) -> dict:
    """Phase 7: the interleaved queue through ``submit``, held against
    phase 3's warm ``query_many`` results; its warm wall time."""
    reset_launches()
    _, first = timed_submit(svc, queue)
    launches = read_launches()
    if launches["radius_counts"] == 0:
        raise AssertionError("submit never launched radius_counts")
    for a, b in zip(by_query(first, Q), warm):
        same_rankings(a, b, tol=MI_TOL)
    times = [timed_submit(svc, queue)[0] for _ in range(WARM_REPS)]
    adm = svc.stats()["admission"]
    log(f"[service] submit of {len(queue)} interleaved queries: rankings and "
        f"join sizes == warm query_many (MI within {MI_TOL}); warm median "
        f"{float(np.median(times)):.4f} s (min {min(times):.4f}, max "
        f"{max(times):.4f}); launches {launches}; batches {adm['batches']}, "
        f"host_syncs {adm['host_syncs']}, fused_windows {adm['fused_windows']}")
    return {"results": first, "launches": launches, "warm_s": times,
            "warm_median_s": float(np.median(times))}


def invalid_sketches(keys, y):
    from dataclasses import replace

    from repro_torch.core.sketch import build_sketch

    sk = build_sketch(keys, y, n=N_SKETCH, side="train", value_is_discrete=False)
    vals = sk.values.copy()
    vals[3] = np.nan
    nan_sk = replace(sk, values=vals)
    small = build_sketch(keys, y, n=N_SKETCH // 2, side="train",
                         value_is_discrete=False)
    return [(nan_sk, "nonfinite_values"), (small, "capacity_mismatch")]


def run_submit_safe(svc, queue, clean, bad) -> dict:
    """Phase 8: quarantine, one retried bucket and the non-finite fence
    through ``pairwise_cheb``; then the descent to the reference rung."""
    from repro_torch.core import estimators as est
    from repro_torch.core.discovery import inject_faults

    full = queue + [sk for sk, _ in bad]
    n = len(queue)
    adm0 = dict(svc.stats()["admission"])
    seen = []  # the first fence calls' inputs, for phase 24
    op = est.pairwise_cheb

    def spy(x, y, mask):
        if len(seen) < FENCE_KEEP:
            seen.append((x, y, mask))
        return op(x, y, mask)

    reset_launches()
    t0 = time.perf_counter()
    est.pairwise_cheb = spy
    try:
        with inject_faults({"fused_dispatch": [0], "scores": FENCE_LANES},
                           seed=SEED) as plan:
            res, outs = svc.submit_safe(full, top_k=TOP_K, min_join=MIN_JOIN)
    finally:
        est.pairwise_cheb = op
    torch.cuda.synchronize()
    t_fenced = time.perf_counter() - t0
    # The kernel's own (B, P) inputs of those calls, as the op makes them,
    # copied after the timed window.
    fence = [tuple(t.to(dtype).reshape(-1, t.shape[-1]).contiguous().clone()
                   for t, dtype in ((x, torch.float32), (y, torch.float32),
                                    (m, torch.bool)))
             for x, y, m in seen]
    del seen
    launches = read_launches()
    for (sk, code), out, r in zip(bad, outs[n:], res[n:]):
        if out.status != "quarantined" or out.error != code or r is not None:
            raise AssertionError(f"invalid sketch not quarantined as {code}: {out}")
    served = outs[:n]
    if not all(o.ok and o.rung == "batched" for o in served):
        raise AssertionError(f"a served query did not deliver on the batched rung: "
                             f"{[o for o in served if not o.ok]}")
    retried = sorted({i % 2 for i, o in enumerate(served) if o.retries})
    if [o.retries for o in served[0::2]] != [1] * Q \
            or any(o.retries for o in served[1::2]):
        raise AssertionError(f"expected one retry on the first (continuous) "
                             f"bucket only: {[o.retries for o in served]}")
    if any(o.nonfinite_lanes != FENCE_LANES for o in served) \
            or plan.corrupted != FENCE_LANES * n:
        raise AssertionError(
            f"fence: {plan.corrupted} lanes corrupted, per query "
            f"{[o.nonfinite_lanes for o in served]}; expected {FENCE_LANES} each")
    adm = svc.stats()["admission"]
    if adm["nonfinite_lanes"] - adm0["nonfinite_lanes"] != plan.corrupted:
        raise AssertionError("nonfinite_lanes does not count the fenced lanes")
    if launches["pairwise_cheb"] == 0 or launches["radius_counts"] == 0:
        raise AssertionError(f"submit_safe launches {launches}: the fence must "
                             "reach pairwise_cheb and scoring radius_counts")
    for a, b in zip(res[:n], clean):
        same_rankings([a], [b], tol=MI_TOL)
    log(f"[service] submit_safe under faults: 2 quarantined "
        f"({[o.error for o in outs[n:]]}), bucket {retried} retried once, "
        f"{plan.corrupted} NaN lanes fenced through the materialized path, "
        f"rankings == clean submit (MI within {MI_TOL}); {t_fenced:.3f} s; "
        f"launches {launches}")

    reset_launches()
    t0 = time.perf_counter()
    with inject_faults({"fused_dispatch": "all", "prefilter_dispatch": "all"}):
        res2, outs2 = svc.submit_safe(full, top_k=TOP_K, min_join=MIN_JOIN)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    launches_ref = read_launches()
    if not all(o.ok and o.rung == "reference" and o.fallbacks == 1
               for o in outs2[:n]):
        raise AssertionError(f"expected every served query on the reference rung: "
                             f"{sorted({(o.status, o.rung) for o in outs2[:n]})}")
    if any(o.status != "quarantined" for o in outs2[n:]):
        raise AssertionError("invalid sketches not quarantined on the second run")
    for a, b in zip(res2[:n], clean):
        same_rankings([a], [b], tol=MI_TOL)
    log(f"[service] submit_safe with every fused and phase-1 dispatch failing: "
        f"all {n} served on the reference rung, rankings == clean submit; "
        f"{t_ref:.3f} s; launches {launches_ref}")
    return {"fenced_lanes": plan.corrupted, "fenced_s": t_fenced,
            "fence_inputs": fence,
            "launches": launches, "reference_rung_s": t_ref,
            "launches_reference_rung": launches_ref,
            "admission": svc.stats()["admission"]}


def count_dispatch_syncs(svc, queue, min_containment: float = 0.0) -> dict:
    """Synchronising calls made while one window is dispatched (staged,
    uploaded on a side stream, enqueued), under
    ``torch.cuda.set_sync_debug_mode("warn")``; the window is collected
    after the mode is reset."""
    import warnings

    side = torch.cuda.Stream()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            win = svc._window_dispatch(queue, isolate=True, top_k=TOP_K,
                                       min_join=MIN_JOIN, prefilter=None,
                                       copy_stream=side,
                                       min_containment=min_containment)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    svc._window_collect(win)
    msgs = [str(w.message) for w in caught if "ynchroniz" in str(w.message)]
    return {"count": len(msgs), "first": msgs[:3]}


def run_scheduler(svc, queue, clean) -> dict:
    """Phase 9: four caller threads, two half-waves each, through the
    micro-batch tier with double-buffered dispatch."""
    import threading

    syncs = count_dispatch_syncs(svc, queue[:2 * Q])
    log(f"[sched] synchronising calls during one window dispatch "
        f"(set_sync_debug_mode warn): {syncs['count']} {syncs['first']}")
    reset_launches()
    sched = svc.scheduler(pipeline_depth=2)
    results, errors = {}, []

    def drained():
        deadline = time.perf_counter() + HANDLE_TIMEOUT_S
        while sched._queued_count():
            if time.perf_counter() > deadline:
                raise TimeoutError("first half-wave never drained")
            time.sleep(0.0002)

    def caller(c: int):
        try:
            mine = list(range(c * PER_CALLER, (c + 1) * PER_CALLER))
            half = PER_CALLER // 2
            h1 = svc.submit_async([queue[i] for i in mine[:half]],
                                  top_k=TOP_K, min_join=MIN_JOIN)
            # The second half-wave lands while the first window is being
            # dispatched, so the loop holds it in flight and overlaps.
            drained()
            h2 = svc.submit_async([queue[i] for i in mine[half:]],
                                  top_k=TOP_K, min_join=MIN_JOIN)
            for i, h in zip(mine, h1 + h2):
                results[i] = (h.result(timeout=HANDLE_TIMEOUT_S), h.outcome())
        except Exception as e:  # noqa: BLE001 — re-raised by the phase
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=caller, args=(c,)) for c in range(CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HANDLE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    alive = any(t.is_alive() for t in threads)
    tele = sched.stats()
    svc.close()  # drains and joins the loop thread
    launches = read_launches()
    if alive or errors:
        raise AssertionError(f"scheduler callers failed: alive={alive} {errors}")
    if sorted(results) != list(range(CALLERS * PER_CALLER)):
        raise AssertionError("not every handle resolved")
    for i, (r, out) in results.items():
        if not out.ok:
            raise AssertionError(f"query {i}: {out}")
        same_rankings([r], [clean[i]], tol=MI_TOL)
    if not (tele["coalesce_ratio"] or 0) > 1 or tele["overlapped_windows"] < 1:
        raise AssertionError(f"no coalescing or no overlap: {tele}")
    if launches["radius_counts"] == 0:
        raise AssertionError("the scheduler never launched radius_counts")
    log(f"[sched] {CALLERS} callers x {PER_CALLER} queries in two half-waves: all "
        f"resolved == solo submit (MI within {MI_TOL}) in {wall:.3f} s; windows "
        f"{tele['windows']}, buckets {tele['dispatched_buckets']}, coalesce "
        f"ratio {tele['coalesce_ratio']:.2f}, overlapped windows "
        f"{tele['overlapped_windows']}; launches {launches}")
    return {"wall_s": wall, "telemetry": tele, "launches": launches,
            "dispatch_syncs": syncs}


# ---------------------------------------------------------------------------
# Phase 15: the phase-0 containment gate over the phase-3 index
# ---------------------------------------------------------------------------

def gate_groups(index, batch, dev) -> dict:
    """One warm gated batch through the executor, for what the handle
    reports per group: survivor and shortlist widths and counts."""
    from repro_torch.core.discovery import (BatchedExecutor, fused_shortlist_spec,
                                            stack_trains_host, tier_spec)

    plan = index.plan(batch[0].value_is_discrete)
    tspec = tier_spec(plan, index.tier_hints, GATE_MC)
    spec = fused_shortlist_spec(plan, index.tier_hints, MIN_JOIN)
    handle = BatchedExecutor(k=3).tiered_dispatch(
        plan, stack_trains_host(batch, dev), tspec, spec, MIN_JOIN, GATE_MC)
    handle.collect()
    return {
        "survivors": handle.survivors, "shortlisted": handle.shortlisted,
        "groups": [{"est_id": gp.est_id, "rows": gp.size, "bucket": gp.bucket,
                    "s_surv": s0, "s_bucket": min(s0, s1),
                    "survivors_max": handle.observed_t0[gp.est_id],
                    "shortlist_max": handle.observed[gp.est_id]}
                   for gp, s0, s1 in zip(plan.groups, tspec.s_survivors,
                                         spec.s_buckets)],
    }


def profile_gate_parts(index, batch, dev) -> dict:
    """Device time of the parts on one warm batch, each under the
    profiler alone: the signature sweep with its survivor compaction and
    the survivor-width exact joins (the gated path), and the corpus-wide
    join-size prefilter they replace (the ungated path)."""
    from repro_torch.core.discovery import executors as ex
    from repro_torch.core.discovery import stack_trains_host, tier_spec
    from repro_torch.core.discovery.planner import stage_min_containment

    plan = index.plan(batch[0].value_is_discrete)
    trains = stack_trains_host(batch, dev)
    tk, tm = trains["keys"], trains["mask"]
    widths = tier_spec(plan, index.tier_hints, GATE_MC).s_survivors
    mc = stage_min_containment(GATE_MC)

    def sweep():
        return [ex._containment_gate(tk, tm, gp.sig, gp.live, mc, s)
                for gp, s in zip(plan.groups, widths)]

    gates = sweep()
    return {
        "signature_sweep": profile_call(sweep),
        "survivor_joins": profile_call(lambda: [
            ex._survivor_join_sizes(tk, tm, gp.arrays, rows0)
            for gp, (rows0, _, _) in zip(plan.groups, gates)]),
        "corpus_joins": profile_call(lambda: [
            ex._join_sizes(tk, tm, gp.arrays["keys"], gp.arrays["mask"])
            for gp in plan.groups]),
    }


def run_gated(index, batches, warm, svc, queue, card: str, dev) -> dict:
    """Phase 15: the gated path at ``min_containment=GATE_MC`` on the
    phase-3 index: (a) the cold pass (survivor overflow, ungated re-run);
    (b) a warm pass equal to phase 3's warm ungated one, 3 staged
    launches; (c) each launch of a warm gated pass held bit-equal and
    timed; (d) gated and ungated warm medians alternated, and profiles;
    (e) ``DiscoveryService.submit`` gated, its windows and syncs."""
    gate = {"min_containment": GATE_MC}
    hints = index.tier_hints

    # (a) the cold gated pass overflows the MIN_SURVIVORS rungs by design
    # and re-runs each window ungated; its results are the ungated ones.
    reset_launches()
    over0 = hints.overflows
    t_cold, cold = run_pass(index, batches, dev, **gate)
    cold_launches = read_launches()
    overflows = hints.overflows - over0
    if overflows == 0:
        raise AssertionError("the cold gated pass did not overflow its survivor "
                             "rungs (MIN_SURVIVORS lanes against 4096 survivors)")
    for a, b in zip(cold, warm):
        same_rankings(a, b, tol=MI_TOL)
    log(f"[gate] cold gated query_many: {t_cold:.4f} s, {overflows} survivor "
        f"overflows, each window re-run ungated; rankings == warm ungated; "
        f"launches {cold_launches}")

    # (b) the warm gated pass delivers gated: no overflow, 3 staged launches.
    reset_launches()
    over0 = hints.overflows
    t_warm, gated = run_pass(index, batches, dev, **gate)
    launches = read_launches()
    if hints.overflows != over0:
        raise AssertionError("the warm gated pass overflowed")
    if (launches["radius_counts_staged"] != 3 or launches["radius_counts"] != 3
            or launches["radius_counts_tiled"]):
        raise AssertionError(f"warm gated pass launched {launches}; expected 3 "
                             "staged radius_counts launches and no tiled one")
    for a, b in zip(gated, warm):
        same_rankings(a, b, tol=MI_TOL)
    groups = [gate_groups(index, b, dev) for b in batches]
    log(f"[gate] warm gated query_many: {t_warm:.4f} s, rankings and join sizes "
        f"== warm ungated (MI within {MI_TOL}); launches {launches}")
    for name, g in zip(("continuous", "discrete"), groups):
        log(f"[gate]   {name}: {g['survivors']} survivors, {g['shortlisted']} "
            f"shortlisted of {Q} x {len(index)}; groups {g['groups']}")

    # (c) each launch of a warm gated pass, held bit-equal and timed.
    seen = capture_launches(index, batches, **gate)
    if len(seen) != 3:
        raise AssertionError(f"captured {len(seen)} launches of a warm gated pass")
    rows = check_main_launches(seen, card)
    if any(r["body"] != "staged" for r in rows):
        raise AssertionError("a gated launch did not reach the staged body")
    log(f"[time] radius_counts, the 3 launches of a warm gated pass: "
        f"{sum(r['ms'] for r in rows):.4f} ms events, "
        f"{sum(r['device_ms'] for r in rows):.4f} ms device, B "
        f"{[r['B'] for r in rows]}; card {card}")

    # (d) gated and ungated warm medians, alternated; profiles side by side.
    times = {(kind, dt): [] for kind in ("gated", "ungated")
             for dt in ("continuous", "discrete")}
    for _ in range(WARM_REPS):
        for dt, b in zip(("continuous", "discrete"), batches):
            times[("gated", dt)].append(run_pass(index, [b], dev, **gate)[0])
            times[("ungated", dt)].append(run_pass(index, [b], dev)[0])
    medians = {f"{kind}_{dt}_s": float(np.median(v))
               for (kind, dt), v in times.items()}
    log(f"[gate] warm query_many, median of {WARM_REPS}, alternated: "
        + ", ".join(f"{k} {v:.4f}" for k, v in medians.items())
        + "".join(f"; {kind} {dt} min {min(v):.4f} max {max(v):.4f}"
                  for (kind, dt), v in times.items()) + f"; card {card}")
    prof = {"gated": profile_pass(index, batches[0], **gate),
            "ungated": profile_pass(index, batches[0])}
    parts = profile_gate_parts(index, batches[0], dev)
    for kind, p in prof.items():
        log(f"[gate] profiled warm continuous query_many, {kind}: wall "
            f"{p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms, "
            f"{p['launches']} launches; by kind "
            + ", ".join(f"{k} {v['ms']:.3f} ms x{v['count']}"
                        for k, v in p["kinds"].items()))
    log("[gate] parts on the same batch, device ms: "
        + ", ".join(f"{k} {v['device_ms']:.3f} (searchsorted "
                    f"{v['kinds']['searchsorted']['ms']:.3f})"
                    for k, v in parts.items()))

    # (e) the service: gated windows on the interleaved queue.
    reset_launches()
    adm0 = dict(svc.stats()["admission"])
    sub = svc.submit(queue, top_k=TOP_K, min_join=MIN_JOIN, **gate)
    torch.cuda.synchronize()
    sub_launches = read_launches()
    for a, b in zip(by_query(sub, Q), warm):
        same_rankings(a, b, tol=MI_TOL)
    stats = svc.stats()
    adm = stats["admission"]
    windows = adm["gated_windows"] - adm0["gated_windows"]
    if windows != adm["batches"] - adm0["batches"] or windows == 0:
        raise AssertionError(f"gated submit delivered {windows} gated windows "
                             f"of {adm['batches'] - adm0['batches']}")
    if sub_launches["radius_counts_staged"] != 3 or sub_launches["radius_counts"] != 3:
        raise AssertionError(f"gated submit launched {sub_launches}")
    sub_times = {"gated": [], "ungated": []}
    for _ in range(WARM_REPS):
        for kind, kw in (("gated", gate), ("ungated", {})):
            t0 = time.perf_counter()
            svc.submit(queue, top_k=TOP_K, min_join=MIN_JOIN, **kw)
            torch.cuda.synchronize()
            sub_times[kind].append(time.perf_counter() - t0)
    syncs = {"gated": count_dispatch_syncs(svc, queue, GATE_MC),
             "ungated": count_dispatch_syncs(svc, queue)}
    log(f"[gate] submit of {len(queue)} interleaved queries gated: rankings == "
        f"warm query_many, {windows} gated windows, t0_selectivity "
        f"{adm['t0_selectivity']}, tiers {stats['tiers']}; warm median gated "
        f"{float(np.median(sub_times['gated'])):.4f} s, ungated "
        f"{float(np.median(sub_times['ungated'])):.4f} s; synchronising calls "
        f"per window dispatch gated {syncs['gated']['count']}, ungated "
        f"{syncs['ungated']['count']} {syncs['gated']['first']}; launches "
        f"{sub_launches}")
    return {
        "min_containment": GATE_MC, "cold_s": t_cold,
        "cold_overflows": overflows, "cold_launches": cold_launches,
        "warm_s": t_warm, "launches": launches, "groups": groups,
        "radius_counts": rows,
        "warm_times_s": {f"{k}_{d}": v for (k, d), v in times.items()},
        "warm_medians_s": medians, "profile": prof, "parts": parts,
        "submit": {"gated_windows": windows, "launches": sub_launches,
                   "admission": adm, "tiers": stats["tiers"],
                   "times_s": sub_times,
                   "median_s": {k: float(np.median(v))
                                for k, v in sub_times.items()},
                   "dispatch_syncs": syncs},
    }


# ---------------------------------------------------------------------------
# Phase 16: compiled programs against eager
# ---------------------------------------------------------------------------

def flat_results(results) -> list:
    """Ranked results as plain tuples, for an exact comparison."""
    return [[(m.table, mi, js) for m, mi, js in r] for r in results]


def host_breakdown(index, batch, dev, min_containment: float = 0.0) -> dict:
    """Where a warm fused (or gated) batch's wall time goes on the host:
    the steps of ``SketchIndex.query_many`` one at a time, each on the
    host clock, with a synchronize after the dispatch so that the
    device's share stands apart (ms)."""
    from repro_torch.core.discovery import executors as ex
    from repro_torch.core.discovery import fused_shortlist_spec, tier_spec

    torch.cuda.synchronize()
    t = [time.perf_counter()]
    staged = ex.stage_trains_host(batch, dev)
    t.append(time.perf_counter())
    trains = ex.upload_trains(staged, dev)
    t.append(time.perf_counter())
    plan = index.plan(batch[0].value_is_discrete)
    t.append(time.perf_counter())
    bx = ex.BatchedExecutor(k=3)
    if min_containment:
        hints = index.tier_hints
        handle = bx.tiered_dispatch(
            plan, trains, tier_spec(plan, hints, min_containment),
            fused_shortlist_spec(plan, hints, MIN_JOIN), MIN_JOIN,
            min_containment)
    else:
        handle = bx.fused_dispatch(
            plan, trains, fused_shortlist_spec(plan, index.shortlist_hints,
                                               MIN_JOIN), MIN_JOIN)
    t.append(time.perf_counter())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    triples = handle.collect()
    t.append(time.perf_counter())
    [index._rank(v, gi, js, TOP_K, MIN_JOIN) for v, gi, js in triples]
    t.append(time.perf_counter())
    names = ("stage", "upload", "plan", "dispatch", "device_wait", "collect",
             "rank")
    return {f"{n}_ms": 1e3 * (b - a) for n, a, b in zip(names, t, t[1:])}


def compare_programs(index, batches, dev, card, **query_kw) -> dict:
    """Phase 16 (a) / (b): warm ``query_many`` per target dtype with the
    group programs on and under ``eager()``: results bit-equal, no
    program built by a second warm pass, 3 ``radius_counts`` launches a
    pass counted through replays, medians of 10 alternated, and one
    profiled continuous pass of each."""
    from repro_torch import compile as programs

    on = run_pass(index, batches, dev, **query_kw)[1]
    with programs.eager():
        off = run_pass(index, batches, dev, **query_kw)[1]
    for a, b in zip(on, off):
        if flat_results(a) != flat_results(b):
            raise AssertionError(f"query_many {query_kw}: programs differ from "
                                 "eager()")
    n0 = programs.compile_count()
    reset_launches()
    run_pass(index, batches, dev, **query_kw)
    launches = read_launches()
    if programs.compile_count() != n0:
        raise AssertionError("a warm pass built a program")
    if launches["radius_counts"] != 3 or launches["radius_counts_staged"] != 3:
        raise AssertionError(f"a replayed warm pass launched {launches}; "
                             "expected 3 staged radius_counts launches")
    times = {(mode, dt): [] for mode in ("programs", "eager")
             for dt in ("continuous", "discrete")}
    for _ in range(WARM_REPS):
        for dt, b in zip(("continuous", "discrete"), batches):
            times[("programs", dt)].append(run_pass(index, [b], dev, **query_kw)[0])
            with programs.eager():
                times[("eager", dt)].append(run_pass(index, [b], dev, **query_kw)[0])
    medians = {f"{mode}_{dt}_s": float(np.median(v))
               for (mode, dt), v in times.items()}
    prof = {"programs": profile_pass(index, batches[0], **query_kw)}
    with programs.eager():
        prof["eager"] = profile_pass(index, batches[0], **query_kw)
    mc = query_kw.get("min_containment", 0.0)
    host = {"programs": host_breakdown(index, batches[0], dev, mc)}
    with programs.eager():
        host["eager"] = host_breakdown(index, batches[0], dev, mc)
    name = "gated" if query_kw else "ungated"
    log(f"[programs] {name} warm query_many: programs == eager() bit for bit, "
        f"compile_count steady at {n0}, {launches['radius_counts']} replayed "
        f"radius_counts launches; medians of {WARM_REPS}, alternated: "
        + ", ".join(f"{k} {v:.4f}" for k, v in medians.items())
        + "".join(f"; {m} {d} min {min(v):.4f} max {max(v):.4f}"
                  for (m, d), v in times.items()) + f"; card {card}")
    for mode, p in prof.items():
        log(f"[programs] profiled {name} continuous pass, {mode}: wall "
            f"{p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms (busy "
            f"{p['busy_share'] or 0:.2f}), {p['launches']} kernels, "
            f"{p['launch_api_calls']} host launch calls {p['launch_api']}")
    for mode, h in host.items():
        log(f"[programs] {name} continuous batch step by step, {mode}: "
            + ", ".join(f"{k} {v:.2f}" for k, v in h.items()))
    return {"bit_equal": True, "compile_count": n0, "launches": launches,
            "times_s": {f"{m}_{d}": v for (m, d), v in times.items()},
            "medians_s": medians, "profile": prof, "host_ms": host}


def run_programs_service(svc, queue, clean, card) -> dict:
    """Phase 16 (c): ``submit`` and ``submit_async`` with programs on:
    results as phases 7 and 9 (and bit-equal to ``submit`` under
    ``eager()``), no synchronising call in a window dispatch, and the
    service's program and ladder counters."""
    from repro_torch import compile as programs

    on = svc.submit(queue, top_k=TOP_K, min_join=MIN_JOIN)
    with programs.eager():
        off = svc.submit(queue, top_k=TOP_K, min_join=MIN_JOIN)
    if flat_results(on) != flat_results(off):
        raise AssertionError("submit with programs differs from eager()")
    for a, b in zip(on, clean):
        same_rankings([a], [b], tol=MI_TOL)
    syncs = count_dispatch_syncs(svc, queue)
    if syncs["count"]:
        raise AssertionError(f"a window dispatch synchronised: {syncs}")
    sched = svc.scheduler(pipeline_depth=2)
    handles = svc.submit_async(queue, top_k=TOP_K, min_join=MIN_JOIN)
    got = [h.result(timeout=HANDLE_TIMEOUT_S) for h in handles]
    tele = sched.stats()
    svc.close()
    if flat_results(got) != flat_results(on):
        raise AssertionError("submit_async with programs differs from submit")
    stats = svc.stats()
    adm = stats["admission"]
    log(f"[programs] submit and submit_async of {len(queue)} queries with "
        f"programs on: == eager() submit bit for bit, == phase 7 (MI within "
        f"{MI_TOL}); {syncs['count']} synchronising calls per window "
        f"dispatch; compiled_programs {stats['compiled_programs']}, "
        f"padded_lanes {adm['padded_lanes']}, q_buckets {adm['q_buckets']}, "
        f"windows {tele['windows']}; card {card}")
    return {"dispatch_syncs": syncs, "compiled_programs": stats["compiled_programs"],
            "padded_lanes": adm["padded_lanes"], "q_buckets": adm["q_buckets"],
            "scheduler": tele}


# ---------------------------------------------------------------------------
# Phase 10: the materialized estimators on the main path's own samples
# ---------------------------------------------------------------------------

def pc_bound(B: int, P: int) -> dict:
    nbytes = B * P * PC_BYTES_PER_ROW + B * P * P * PC_BYTES_PER_PAIR
    return {"bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes}


def check_materialized(seen: list, card: str) -> list[dict]:
    """Materialized vs fused MI on each captured launch's samples (MixedKSG
    on joint launches, DC-KSG on class launches), then the first
    ``pairwise_cheb`` chunk of each held bit-equal to its plain version
    and timed beside it and its bound."""
    from repro_torch.core import estimators as est
    from repro_torch.kernels.pairwise_cheb import kernel, ref

    rows = []
    for x, y, m, args, _ in seen:
        B, P = x.shape
        if args["mode"] == "joint":
            fn, name = est.mixed_ksg_mi, "mixed_ksg"
        else:
            fn, name = est.dc_ksg_mi, "dc_ksg"
        fused = fn(x, y, m, k=args["k"])
        before = kernel.pairwise_cheb.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mat = fn(x, y, m, k=args["k"], impl="materialized")
        torch.cuda.synchronize()
        t_mat = time.perf_counter() - t0
        n_launch = kernel.pairwise_cheb.launches - before
        diff = float((mat.double() - fused.double()).abs().max())
        exact = bool(torch.equal(mat, fused))
        if not torch.allclose(mat, fused, rtol=MI_TOL, atol=MI_TOL):
            raise AssertionError(f"materialized {name} differs from fused on "
                                 f"B={B}: max |diff| {diff}")
        chunk = min(B, max(1, est._MATERIALIZED_ELEMS // (P * P)))
        cx, cy, cm = x[:chunk].contiguous(), y[:chunk].contiguous(), m[:chunk].contiguous()
        if name == "dc_ksg":
            cx = cy  # the DC-KSG path forms DY from y against itself
        got = kernel.pairwise_cheb(cx, cy, cm)
        want = ref.pairwise_cheb(cx, cy, cm)
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        if err != 0.0:
            raise AssertionError(f"pairwise_cheb main-path chunk differs: {err}")
        del got, want
        ms = time_cuda(lambda: kernel.pairwise_cheb(cx, cy, cm), 20)
        plain_ms = time_cuda(lambda: ref.pairwise_cheb(cx, cy, cm), 5)
        # The fence's own launches are this small: a query's few NaN lanes.
        fx, fy, fm = cx[:FENCE_LANES], cy[:FENCE_LANES], cm[:FENCE_LANES]
        fence_ms = time_cuda(lambda: kernel.pairwise_cheb(fx, fy, fm), 200)
        row = {"estimator": name, "B": B, "P": P, "chunk": chunk,
               "fence_shape_ms": fence_ms,
               "fence_shape_bound_ms": pc_bound(FENCE_LANES, P)["bound_ms"],
               "pairwise_cheb_launches": n_launch, "mi_max_abs_diff": diff,
               "mi_bit_exact": exact, "materialized_s": t_mat,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               **pc_bound(chunk, P)}
        log(f"[materialized] {name} on the main path's B={B} samples: MI max "
            f"|materialized - fused| {diff:.3g} (bit-exact: {exact}), "
            f"{n_launch} pairwise_cheb launches, {t_mat:.3f} s; chunk "
            f"B={chunk} P={P}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms (bytes); B={FENCE_LANES} (a fence's "
            f"shape): {fence_ms:.4f} ms, bound {row['fence_shape_bound_ms']:.4f} "
            f"ms; card {card}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 12: the two-op kNN API on the main path's own samples
# ---------------------------------------------------------------------------

def radius_rule(args: dict, mask: torch.Tensor):
    """The radius ``radius_counts`` fuses, as a ``knn_with_counts``
    callable: the k-th smallest in joint mode, the DC-KSG clipped
    within-class extraction (budget kk, buffer kb) in class mode."""
    k, kb, kk = args["k"], args["kb"], args["kk"]
    if args["mode"] == "joint":
        return lambda knn, cnt: knn[..., k - 1]
    m = mask.to(torch.int32)

    def clipped(knn, cnt):
        idx = (torch.clamp(cnt + m - 1, max=kk) - 1).clamp(0, kb - 1)
        return knn.gather(-1, idx.to(torch.int64)[..., None])[..., 0]
    return clipped


def sort_ops(n: torch.Tensor) -> float:
    """log2(n!) summed over the samples: the compares of a sort."""
    return float((torch.lgamma(n + 1) / np.log(2)).sum())


def search_steps(n: torch.Tensor) -> float:
    """ceil(log2(n+1)) binary-search steps for each of n rows, summed."""
    return float((n * torch.ceil(torch.log2(n + 1))).sum())


def with_direct(need: dict, direct: dict) -> dict:
    """The sorted route's bound with the direct algorithm's beside it."""
    return {**need, "direct_bound_ms": direct["bound_ms"],
            "direct_float_ops": direct["float_ops"],
            "direct_int_ops": direct["int_ops"]}


def knn_bound(x, y, mask, mode, kb, knn, cnt, pad_to=None) -> dict:
    """Least time for knn_smallest on these inputs: the operations of the
    cheaper sorted route (KNN_NEED_*: one sort and the x band or the
    class merge; KNN_ROUTE_STEP: two sorts and the four-stream walk or
    the searched class run) or its bytes, each route's bound beside it
    (``one_sort_bound_ms``, ``two_order_bound_ms``), and the direct
    algorithm's (KNN_OPS).  ``pad_to``: the bytes of the same samples
    padded with invalid columns to that width, each padded column priced
    at its mask byte and its outputs (the work is the same)."""
    pairs, same = pair_counts(mask, mode, cnt)
    (pf, pi), (sf, si) = KNN_OPS[mode]
    out = 4 * kb + 4
    nbytes = padded_bytes(mask, KNN_BYTES_IN + out, PAD_BYTES_IN + out, pad_to)
    direct = bound(pairs * pf + same * sf, pairs * pi + same * si, nbytes)
    n = mask.sum(-1, dtype=torch.float64)
    sort = sort_ops(n)
    f, i = sort, 0.0
    if mode == "joint":
        r = knn[..., kb - 1].contiguous()
        band, band_max = band_pairs(x, mask, r, longest=True)
        f, i = f + band * KNN_NEED_BAND[0], i + band * KNN_NEED_BAND[1]
        walk = band + band_pairs(y, mask, r)
        route_f, route_i = 2 * sort + walk * KNN_ROUTE_STEP[0], walk * KNN_ROUTE_STEP[1]
        steps = 0.0
    else:
        band = walk = 0.0
        band_max = 0
        steps = float(cnt[mask].clamp(max=kb).sum(dtype=torch.float64))
        rows = float(n.sum())
        f = f + rows + steps * KNN_NEED_MERGE[0]
        i = i + rows + steps * KNN_NEED_MERGE[1]
        route_f = (2 * sort + RC_ROUTE_RUN_SEARCHES * search_steps(n) * RC_NEED_STEP[0]
                   + steps * RC_ROUTE_MERGE[0])
        route_i = 0.0
    one_sort, two_order = bound(f, i, nbytes), bound(route_f, route_i, nbytes)
    best = min(one_sort, two_order, key=lambda b: b["bound_ms"])
    return {**with_direct(best, direct), "one_sort_bound_ms": one_sort["bound_ms"],
            "two_order_bound_ms": two_order["bound_ms"], "band_pairs": band,
            "band_max": band_max, "walk_steps": walk, "merge_steps": steps}


def padded_bytes(mask, per_column: int, per_pad: int, pad_to=None) -> float:
    """Bytes of B samples of mask.shape[1] columns at ``per_column`` each,
    and of their padding to ``pad_to`` columns at ``per_pad`` each."""
    B, P = mask.shape
    return B * (P * per_column + ((pad_to or P) - P) * per_pad)


def bc_bound(mask, which, pad_to=None) -> dict:
    """Least time for ball_counts on these inputs: the sorted route's
    operations (BC_NEED_*) or its bytes; the direct algorithm's count
    (BC_OPS) beside it.  ``pad_to`` as in :func:`knn_bound`."""
    pairs, _ = pair_counts(mask, "joint", None)
    pf, pi = BC_OPS[which]
    nbytes = padded_bytes(mask, BC_BYTES[which], PAD_BYTES_IN + BC_BYTES_OUT,
                          pad_to)
    direct = bound(pairs * pf, pairs * pi, nbytes)
    n = mask.sum(-1, dtype=torch.float64)
    sorts = 2 if which == "all" else 1
    steps = BC_NEED_SEARCHES[which] * search_steps(n)
    f = sorts * sort_ops(n) + steps * BC_NEED_STEP[0]
    i = steps * BC_NEED_STEP[1]
    return with_direct(bound(f, i, nbytes), direct)


def direct_words(row: dict) -> str:
    """The direct algorithm's bound against the measured time: how many
    times under it the kernel runs, or its share when above."""
    ratio = row["direct_bound_ms"] / row["ms"]
    if ratio >= 1.0:
        return f"{ratio:.2f}x under the direct bound {row['direct_bound_ms']:.4f} ms"
    return (f"{100 * ratio:.1f}% of the direct bound "
            f"{row['direct_bound_ms']:.4f} ms")


# Phase 12 (b): the captured samples padded with invalid columns to this
# width, past the staged bodies' range, so that knn_with_counts takes both
# tiled bodies.
TWO_OP_PAD_P = 1280


def pad_columns(t: torch.Tensor, P: int, fill) -> torch.Tensor:
    out = torch.full((t.shape[0], P), fill, dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def time_op(kernel_fn, plain_fn, want, name: str, bnd: dict, body: str,
            tiled_fn) -> dict:
    """One op on one captured launch: the staged body's ms, the tiled
    body's on the same inputs (held bit-equal), the plain version's, the
    sorted route's bound and share, and the direct algorithm's ratio."""
    tiled_err = bit_equal(f"{name} (the tiled body)", tiled_fn(), want)
    row = {**bnd, "body": body, "tiled_max_abs_err": tiled_err,
           "ms": time_cuda(kernel_fn, 20), "tiled_ms": time_cuda(tiled_fn, 10),
           "plain_ms": time_cuda(plain_fn, 2)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["direct_ratio"] = row["direct_bound_ms"] / row["ms"]
    return row


def run_two_op(seen: list, card: str) -> dict:
    """Phase 12: (a) ``knn_with_counts`` on each launch phase 5 captured,
    with the radius rule ``radius_counts`` uses; 2 kernel launches per
    call, each of the staged body; r, cnt and all five counts bit-equal to
    the captured outputs.  Then each op against its plain version on the
    same (whole) batch, and timed: its staged body, its tiled body on the
    same inputs, the plain version, the sorted route's bound (KNN_NEED_*,
    BC_NEED_*) and the direct algorithm's (KNN_OPS, BC_OPS), and the fused
    kernel.  (b) the same calls on the samples padded with invalid columns
    to TWO_OP_PAD_P: 2 launches per call, each of the tiled body, outputs
    equal to (a)'s on the real columns."""
    from repro_torch.kernels.knn_stats import kernel, ops, ref

    def two_op(x, y, m, args):
        return ops.knn_with_counts(x, y, m, k=args["k"], k_max=args["kb"],
                                   mode=args["mode"], which=args["which"],
                                   radius=radius_rule(args, m))

    reset_launches()
    outs = [two_op(x, y, m, args) for x, y, m, args, _ in seen]
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(seen)
    want = {"knn_smallest": n, "knn_smallest_staged": n, "ball_counts": n,
            "ball_counts_staged": n}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"knn_with_counts over {n} captured launches "
                             f"made {launches}; expected {want}")
    rows = []
    for (x, y, m, args, fused), (knn, cnt, counts) in zip(seen, outs):
        B, P = x.shape
        name = f"{args['mode']}/{args['which']} k={args['k']} kb={args['kb']} B={B} P={P}"
        rule = radius_rule(args, m)
        r, counts = rule(knn, cnt), torch.stack(tuple(counts))
        two_op_err = bit_equal(f"knn_with_counts {name} against radius_counts",
                               (r, cnt, counts), fused)
        mode, which, kb = args["mode"], args["which"], args["kb"]
        rr = r.contiguous()
        knn_want = ref.knn_smallest(x, y, m, kb=kb, mode=mode)
        knn_err = bit_equal(f"knn_smallest {name}", (knn, cnt), knn_want)
        bc_want = ref.ball_counts(x, y, m, rr, which=which)
        bc_err = bit_equal(f"ball_counts {name}", counts, bc_want)
        kw = dict(k=args["k"], k_max=kb, mode=mode, which=which, radius=rule)
        row = {
            "mode": mode, "which": which, "k": args["k"], "kb": kb, "kk": args["kk"],
            "B": B, "P": P, "plain_batch": B, "two_op_vs_fused_err": two_op_err,
            "knn_smallest": {"max_abs_err": knn_err, **time_op(
                lambda: kernel.knn_smallest(x, y, m, kb=kb, mode=mode),
                lambda: ref.knn_smallest(x, y, m, kb=kb, mode=mode), knn_want,
                f"knn_smallest {name}", knn_bound(x, y, m, mode, kb, knn, cnt),
                two_op_body("knn_smallest", P, kb),
                lambda: kernel.knn_smallest_tiled(x, y, m, kb=kb, mode=mode))},
            "ball_counts": {"max_abs_err": bc_err, **time_op(
                lambda: kernel.ball_counts(x, y, m, rr, which=which),
                lambda: ref.ball_counts(x, y, m, rr, which=which), bc_want,
                f"ball_counts {name}", bc_bound(m, which),
                two_op_body("ball_counts", P),
                lambda: kernel.ball_counts_tiled(x, y, m, rr, which=which))},
            "knn_with_counts_ms": time_cuda(lambda: ops.knn_with_counts(x, y, m, **kw), 20),
            "radius_counts_ms": time_cuda(lambda: kernel.radius_counts(x, y, m, **args), 20),
        }
        for op in ("knn_smallest", "ball_counts"):
            o = row[op]
            log(f"[two-op] {op} {name} ({o['body']}): {o['ms']:.4f} ms, the tiled "
                f"body {o['tiled_ms']:.4f} ms ({o['tiled_ms'] / o['ms']:.2f}x), plain "
                f"{o['plain_ms']:.4f} ms; sorted-route bound {o['bound_ms']:.4f} ms "
                f"({o['bound_by']}, {100 * o['bound_share']:.1f}%), "
                f"{direct_words(o)}; card {card}")
            if o["tiled_ms"] <= o["ms"]:
                # A finding, not a fault: the dispatch rule stays.
                log(f"[two-op] finding: {op} {name}: the tiled body "
                    f"({o['tiled_ms']:.4f} ms) is not slower than the staged one "
                    f"({o['ms']:.4f} ms) the rule names; card {card}")
        log(f"[two-op] {name}: knn_with_counts == radius_counts (r, cnt, 5 counts), "
            f"each op and each body == its plain version on the whole batch; "
            f"knn_with_counts {row['knn_with_counts_ms']:.4f} ms against "
            f"radius_counts {row['radius_counts_ms']:.4f} ms "
            f"({row['knn_with_counts_ms'] / row['radius_counts_ms']:.2f}x); card {card}")
        rows.append(row)

    # (b) The tiled bodies through knn_with_counts: the same samples, padded.
    reset_launches()
    padded = []
    for x, y, m, args, _ in seen:
        xp, yp = (pad_columns(t, TWO_OP_PAD_P, 0.0) for t in (x, y))
        mp = pad_columns(m, TWO_OP_PAD_P, False)
        padded.append(two_op(xp, yp, mp, args))
    torch.cuda.synchronize()
    tiled_launches = read_launches()
    want = {"knn_smallest": n, "knn_smallest_tiled": n, "ball_counts": n,
            "ball_counts_tiled": n}
    if {k: v for k, v in tiled_launches.items() if v} != want:
        raise AssertionError(f"knn_with_counts at P={TWO_OP_PAD_P} made "
                             f"{tiled_launches}; expected {want}")
    tiled_err = 0.0
    for (x, y, m, args, _), out, pout in zip(seen, outs, padded):
        P = x.shape[1]
        name = f"{args['mode']}/{args['which']} padded to P={TWO_OP_PAD_P}"
        (knn, cnt, counts), (pk, pc, pcounts) = out, pout
        pcounts = torch.stack(tuple(pcounts))
        tiled_err = max(tiled_err, bit_equal(
            f"knn_with_counts {name}",
            (pk[:, :P], pc[:, :P], pcounts[:, :, :P]),
            (knn, cnt, torch.stack(tuple(counts)))))
        if not (torch.isinf(pk[:, P:]).all() and not pc[:, P:].any()
                and not pcounts[:, :, P:].any()):
            raise AssertionError(f"knn_with_counts {name}: a padded column "
                                 "is not +inf / 0")
    log(f"[two-op] (b) knn_with_counts on the {n} captured launches padded to "
        f"P={TWO_OP_PAD_P}: {tiled_launches['knn_smallest_tiled']} launches of "
        f"each tiled body, outputs == (a) on the real columns; card {card}")
    del padded
    padded_rows = time_padded(seen, outs, card)
    del outs
    return {"launches": launches, "tiled_launches": tiled_launches,
            "tiled_err": tiled_err, "rows": rows, "padded_rows": padded_rows}


def time_padded(seen: list, outs: list, card: str) -> list[dict]:
    """Phase 12 (b)'s calls timed: each tiled body on the captured samples
    padded to TWO_OP_PAD_P (CUDA events), beside its bound at those inputs
    (the real columns' work and bytes, the padding's mask and outputs,
    reckoned after the timing, so that the cache holds none of the
    bounds' temporaries while a call takes its scratch)."""
    from repro_torch.kernels.knn_stats import kernel

    rows = []
    torch.cuda.empty_cache()
    for (x, y, m, args, _), (knn, cnt, counts) in zip(seen, outs):
        mode, which, kb = args["mode"], args["which"], args["kb"]
        r = radius_rule(args, m)(knn, cnt).contiguous()
        xp, yp, rp = (pad_columns(t, TWO_OP_PAD_P, 0.0) for t in (x, y, r))
        mp = pad_columns(m, TWO_OP_PAD_P, False)
        name = (f"{mode}/{which} k={args['k']} kb={kb} B={x.shape[0]} "
                f"P={TWO_OP_PAD_P}")
        row = {"mode": mode, "which": which, "kb": kb, "B": x.shape[0],
               "P": TWO_OP_PAD_P}
        for op, fn, bnd in (
                ("knn_smallest",
                 lambda: kernel.knn_smallest_tiled(xp, yp, mp, kb=kb, mode=mode),
                 lambda: knn_bound(x, y, m, mode, kb, knn, cnt,
                                   pad_to=TWO_OP_PAD_P)),
                ("ball_counts",
                 lambda: kernel.ball_counts_tiled(xp, yp, mp, rp, which=which),
                 lambda: bc_bound(m, which, pad_to=TWO_OP_PAD_P))):
            ms = time_cuda(fn, 10)
            o = {**bnd(), "ms": ms}
            o["bound_share"] = o["bound_ms"] / o["ms"]
            row[op] = o
            log(f"[two-op] (b) {op}_tiled {name}: {o['ms']:.4f} ms events, bound "
                f"{o['bound_ms']:.4f} ms ({o['bound_by']}, "
                f"{100 * o['bound_share']:.1f}%); card {card}")
        row["ms"] = row["knn_smallest"]["ms"] + row["ball_counts"]["ms"]
        log(f"[two-op] (b) {name}: both tiled calls {row['ms']:.4f} ms; card {card}")
        rows.append(row)
        del xp, yp, rp, mp
    return rows


# Phase 12 (c): the tiled two-op bodies alone, (B, P, mode, which, kb) on
# rc_inputs: long samples at B = 1, wide buffers at the lake's P = 256,
# B cut from C_MAIN so that knn_smallest's (B, P, kb) output fits
# TWO_OP_SWEEP_BYTES (its plain version's copy beside it).
TWO_OP_SWEEP = [(1, P, mode, which, 3) for P in (2048, 10000, 40000)
                for mode, which in (("joint", "all"), ("class", "y"))] + [
    (C_MAIN, 256, mode, which, kb) for kb in (32, 64, 128)
    for mode, which in (("joint", "all"), ("class", "y"))]
TWO_OP_SWEEP_BYTES = 1 << 30


def run_two_op_sweep(card: str, dev) -> list[dict]:
    """Phase 12 (c): each ``TWO_OP_SWEEP`` case through both tiled bodies
    (``ball_counts`` at the kb-th smallest distance, with the case's
    ``which``), each bit-equal to its plain version, timed with CUDA
    events beside its bound and share (and at B = 1 profiler device
    time)."""
    from repro_torch.kernels.knn_stats import kernel, ref

    gen = torch.Generator().manual_seed(SEED + 12)
    rows = []
    t0 = time.perf_counter()
    for B, P, mode, which, kb in TWO_OP_SWEEP:
        cut = min(B, max(1, TWO_OP_SWEEP_BYTES // (P * kb * 4)))
        if cut < B:
            log(f"[two-op] (c) {mode} kb={kb} P={P}: B cut from {B} to {cut} "
                f"(the (B, P, kb) output within {TWO_OP_SWEEP_BYTES} bytes)")
        B = cut
        x, y, m = (t.to(dev) for t in rc_inputs(B, P, mode, gen))
        knn_want = ref.knn_smallest(x, y, m, kb=kb, mode=mode)
        r = knn_want[0][..., kb - 1].contiguous()
        bc_want = ref.ball_counts(x, y, m, r, which=which)
        name = f"{mode}/{which} kb={kb} B={B} P={P}"
        row = {"mode": mode, "which": which, "kb": kb, "B": B, "P": P}
        for op, fn, want, bnd in (
                ("knn_smallest",
                 lambda: kernel.knn_smallest_tiled(x, y, m, kb=kb, mode=mode),
                 knn_want, knn_bound(x, y, m, mode, kb, *knn_want)),
                ("ball_counts",
                 lambda: kernel.ball_counts_tiled(x, y, m, r, which=which),
                 bc_want, bc_bound(m, which))):
            err = bit_equal(f"{op}_tiled sweep {name}", fn(), want)
            o = {**bnd, "max_abs_err": err, "ms": time_cuda(fn, 10)}
            o["bound_share"] = o["bound_ms"] / o["ms"]
            # At B = 1 the host's enqueue can outlast the device's work.
            o["device_ms"] = device_ms_per_call([fn]) if B == 1 else None
            row[op] = o
            rows_note = (f", {int(m.sum())} valid rows, the longest band "
                         f"{o['band_max']} columns" if o.get("band_max") else "")
            if o["device_ms"] is not None:
                rows_note += f", {o['device_ms']:.4f} ms device"
            log(f"[time] {op}_tiled sweep {name}: {o['ms']:.4f} ms events, bound "
                f"{o['bound_ms']:.4f} ms ({o['bound_by']}, "
                f"{100 * o['bound_share']:.1f}%){rows_note}, max_abs_err={err}; "
                f"card {card}")
        rows.append(row)
        del x, y, m, r, knn_want, bc_want
        torch.cuda.empty_cache()
    log(f"[time] two-op tiled sweep: {len(rows)} cases, both ops bit-equal, in "
        f"{time.perf_counter() - t0:.2f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the lake's keys hashed on the card
# ---------------------------------------------------------------------------

def hash_bound(n: int, per_element_seed: bool, fib: bool) -> dict:
    return bound(0.0, float(n) * (HASH_INT_OPS + fib),
                 n * (16 + 8 * per_element_seed))


def run_hash_lake(rows: list, card: str, dev) -> dict:
    """Phase 13: every key word of the C-column lake (C x 384) through
    ``hash_keys``: the key hash (scalar seed), the TUPSK tuple-key re-hash
    (per-element seeds: the key hashes) and its Fibonacci rank, each
    bit-equal to the numpy hashes the sketches are built from."""
    from repro_torch.core import hashing
    from repro_torch.kernels.murmur3 import ops, ref

    t0 = time.perf_counter()
    raw = np.concatenate([key_words(c) for c in range(len(rows))])
    host_key = np.concatenate([r[3] for r in rows])
    col = np.repeat(np.arange(len(rows), dtype=np.int64), N_ROWS)
    j = hashing.occurrence_index((col << 32) | host_key.astype(np.int64))
    host_tuple = hashing.murmur3_32_np(j.astype(np.uint32), seed=host_key)
    host_rank = hashing.fibonacci32_np(host_tuple)
    t_host = time.perf_counter() - t0
    raw_t = torch.from_numpy(raw.astype(np.int64)).to(dev)
    j_t = torch.from_numpy(j).to(dev)
    torch.cuda.synchronize()

    reset_launches()
    key_h = ops.hash_keys(raw_t, KEY_SEED, fibonacci=False)
    tuple_h = ops.hash_keys(j_t, key_h, fibonacci=False)
    rank = ops.hash_keys(j_t, key_h)
    torch.cuda.synchronize()
    launches = read_launches()
    if {k: v for k, v in launches.items() if v} != {"murmur3_fib": 3}:
        raise AssertionError(f"hashing the lake made {launches}; expected 3 "
                             "murmur3_fib launches")
    for name, got, host in (("key hash", key_h, host_key),
                            ("tuple-key re-hash", tuple_h, host_tuple),
                            ("TUPSK rank", rank, host_rank)):
        if not np.array_equal(got.cpu().numpy(), host.astype(np.int64)):
            raise AssertionError(f"the lake's {name} differs from the host's")
    passes = {"key": (raw_t, KEY_SEED, False), "tuple": (j_t, key_h, False),
              "rank": (j_t, key_h, True)}
    out, err = {}, 0.0
    for name, (keys, seeds, fib) in passes.items():
        err = max(err, bit_equal(f"hash_keys {name} pass", ops.hash_keys(keys, seeds, fibonacci=fib),
                                 ref.murmur3_fib_ref(keys, seeds, fibonacci=fib)))
        out[name] = {
            "ms": time_cuda(lambda: ops.hash_keys(keys, seeds, fibonacci=fib), 20),
            "plain_ms": time_cuda(lambda: ref.murmur3_fib_ref(keys, seeds, fibonacci=fib), 3),
            **hash_bound(keys.numel(), not isinstance(seeds, int), fib)}
    n = raw.size
    log(f"[hash] the lake's {n} key words ({len(rows)} columns x {N_ROWS} rows): key "
        f"hash, tuple-key re-hash and TUPSK rank on the card == murmur3_32_np / "
        f"fibonacci32_np on the host (host side {t_host:.2f} s); "
        + "; ".join(f"{k} pass {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                    f"{v['bound_ms']:.4f} {v['bound_by']})" for k, v in out.items())
        + f"; card {card}")
    return {"words": n, "launches": launches, "max_abs_err": err, "host_s": t_host,
            "passes": out}


# ---------------------------------------------------------------------------
# Phase 11: the model serving path at full width
# ---------------------------------------------------------------------------

def fa_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> dict:
    """Least time for one launch: its multiply-adds (QK^T and PV over the
    live (row, key) pairs, 2 FLOP each) at the card's peak rate for the
    operand type (PEAK_FLOP_S: the tensor cores' for 16-bit inputs), or its
    bytes (q, k, v read once, o written once) over the HBM rate.
    ``cuda_cores_ms`` is the larger of the bytes' time and the same FLOPs
    at the float32 CUDA-core rate, the most a kernel that multiplies in
    float32 on the CUDA cores (the CUDA-core kernel converts 16-bit inputs)
    could reach: a figure beside the bound, never the bound."""
    B, Hq, S, Dk = q.shape
    Dv = v.shape[-1]
    pairs = S * (S + 1) / 2 if causal else S * S
    flop = 2.0 * pairs * (Dk + Dv) * Hq * B
    nbytes = (q.numel() + k.numel() + v.numel() + B * Hq * S * Dv) * q.element_size()
    t_ops = 1e3 * flop / PEAK_FLOP_S[q.dtype]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "cuda_cores_ms": max(1e3 * flop / PEAK_FLOP_S[torch.float32], t_bytes)}


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row RMS of a - b over the RMS of b."""
    a, b = a.double(), b.double()
    return (a - b).pow(2).mean(-1).sqrt() / b.pow(2).mean(-1).sqrt()


def capture_flash(fn, n: int) -> list:
    """Run ``fn`` with every flash launch of ``ops.attention`` captured
    with its inputs and output; require ``n`` launches."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen = []

    def spy(q, k, v, *, scale, causal):
        out = fa_kernel.flash_attention(q, k, v, scale=scale, causal=causal)
        seen.append((q.clone(), k.clone(), v.clone(), scale, causal, out.clone()))
        return out

    fa_ops.kernel = SimpleNamespace(flash_attention=spy)
    try:
        fn()
    finally:
        fa_ops.kernel = fa_kernel
    torch.cuda.synchronize()
    if len(seen) != n:
        raise AssertionError(f"captured {len(seen)} flash launches; expected {n}")
    return seen


def device_ms_per_call(calls: list, reps: int = 5) -> float:
    """Device time of the kernels the calls launch, per call: each call
    run ``reps`` times in one ``torch.profiler`` window.  A window that
    recorded no device time (the profiler now and then drops a short
    window's kernels) is profiled again, up to ``PROFILE_TRIES`` times.
    Each window's kernel records and calls made go to PROFILE_WINDOWS[-1]:
    a call that launches one kernel should leave one record, and a window
    with fewer records than calls lost some and reads low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kernels)
        if total_us > 0:
            PROFILE_WINDOWS.append({"calls": reps * len(calls),
                                    "records": sum(e.count for e in kernels),
                                    "ms": total_us / 1e3 / (reps * len(calls))})
            return PROFILE_WINDOWS[-1]["ms"]
    raise AssertionError(f"the profiler recorded no device time in "
                         f"{PROFILE_TRIES} windows")


def graph_ms_per_call(calls: list, reps: int) -> float:
    """Device time per call with no host time in it: the calls, ``reps``
    times over, captured into one CUDA graph, and a replay of it (after a
    first one) timed by CUDA events.  Events around eager launches read
    the host instead once its time per call exceeds the kernel's (the
    Hopper flash kernel's does), and a profiler window on the card can
    lose kernel records (up to 4 of 5 seen), which reads its time per call
    low by the lost share."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in calls:
                fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * len(calls))


def flash_build_report(body: str) -> list[str]:
    """ptxas's registers, spills and stack for each instantiation of the
    CUDA-core flash kernel's register-tiled body (``body`` "regtile") or
    basic body ("basic"), from this run's build, one line each."""
    import re

    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    types = {"f": "float32", "6__half": "float16", "13__nv_bfloat16": "bfloat16"}
    lines = fa_kernel.load_library().ptxas.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" not in line or f"flash_{body}_kernel" not in line:
            continue
        tail = " ".join(x.strip().replace("ptxas info    : ", "")
                        for x in lines[i + 1:i + 4]
                        if "Compiling" not in x and "properties" not in x)
        if body == "regtile":
            args = line.split("flash_regtile_kernelILi")[1].split("EEEv")[0]
            dk, nch = args.split("ELi")
            out.append(f"Dk={'runtime' if dk == '0' else dk}, {nch} output "
                       f"chunks a lane: {tail}")
        else:
            t, rows, nch, dk = re.search(
                r"flash_basic_kernelI(f|6__half|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                r"ELi(\d+)E", line).groups()
            out.append(f"{types[t]}, {rows} rows a block, {nch} output chunks "
                       f"a lane, Dk={'runtime' if dk == '0' else dk}: {tail}")
    return out


def hold_flash_launches(seen: list, card: str, name: str, launch=None) -> dict:
    """Each captured launch of kernel ``name`` held against both plain
    versions on its own inputs (the kernel's tolerance), then timed there
    beside its plain version, its bound, ``scaled_dot_product_attention``
    and the kernel or body it replaced on the same inputs: for the Hopper
    kernel the CUDA-core kernel, for the register-tiled body the basic body
    (held within FA_F32_ATOL of it too, and timed as the body is).
    ``launch``, where given, is held and timed in place of the wrapper
    ``name`` (another build of its body, whose outputs ``seen`` holds), and
    the build's report is left out."""
    from functools import partial

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    hopper = name == "flash_attention_wgmma"
    regtile = name == "flash_attention_simt_regtile"
    basic_body = name == "flash_attention_simt_basic" and launch is None
    launch = launch or wrappers()[name]
    basic = fa_kernel.flash_attention_simt_basic
    rows = []
    for layer, (q, k, v, scale, causal, got) in enumerate(seen):
        group = q.shape[1] // k.shape[1]
        if hopper:
            plain = partial(fa_ref.chunked_attention, p_dtype=q.dtype)
        else:
            plain = fa_ref.chunked_attention
        if regtile:
            out = launch(q, k, v, scale=scale, causal=causal)
            ok, err, _ = fa_within(out, got)
            if not ok:  # the captured launch went through the dispatch
                raise AssertionError(f"{name} launch of layer {layer} differs "
                                     f"from the dispatched one: {err}")
            got_basic = basic(q, k, v, scale=scale, causal=causal)
        units, basic_units = [], []
        for ref_fn in (plain, fa_ref.mha_reference):
            want = ref_fn(q, k, v, scale=scale, causal=causal)
            torch.cuda.synchronize()
            ok, err, u = (fa_within_p(got, want, v, group) if hopper
                          else fa_within(got, want))
            if not ok:
                raise AssertionError(f"{name} launch of layer {layer} differs "
                                     f"from its plain version: {u} units, "
                                     f"max_abs_err {err}")
            units.append((err, u))
            if regtile:
                ok, err, _ = fa_within(got_basic, want)
                if not ok:
                    raise AssertionError(f"the basic body on layer {layer}'s "
                                         f"inputs differs from its plain "
                                         f"version: max_abs_err {err}")
                basic_units.append(err)
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             enable_gqa=True, scale=scale)
        lib_err = _max_abs_err(lib, want)
        ms = time_cuda(lambda: launch(q, k, v, scale=scale, causal=causal),
                       FA_TIME_REPS)
        plain_ms = time_cuda(lambda: plain(q, k, v, scale=scale, causal=causal), 3)
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True, scale=scale),
            FA_TIME_REPS)
        row = {"layer": layer, "shape_q": list(q.shape), "shape_k": list(k.shape),
               "q_strides": list(q.stride()), "dtype": str(q.dtype),
               "max_abs_err": max(e for e, _ in units),
               "units": max(u for _, u in units),
               "max_abs_err_vs_mha": units[1][0], "event_ms": ms,
               "plain_ms": plain_ms, "library_event_ms": lib_ms,
               "library_max_abs_err": lib_err, **fa_bound(q, k, v, causal)}
        if hopper:
            row["simt_ms"] = time_cuda(lambda: fa_kernel.flash_attention_simt(
                q, k, v, scale=scale, causal=causal), 3)
        if regtile:
            row["basic_max_abs_err"] = max(basic_units)
            row["basic_gap"] = fa_within(got, got_basic)[1]
            if not fa_within(got, got_basic)[0]:
                raise AssertionError(f"{name} launch of layer {layer} differs "
                                     f"from the basic body: {row['basic_gap']}")
        rows.append(row)
    keys = (("event_ms", "plain_ms", "library_event_ms", "bound_ms",
             "cuda_cores_ms") + (("simt_ms",) if hopper else ()))
    fa = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    # The kernel's and SDPA's times ("ms", "library_ms") are a CUDA graph
    # of the launches timed by events (graph_ms_per_call): no host in them.
    # The profiler's device time, with the kernel records its window held
    # against the launches made (one kernel a launch), the events around
    # eager launches and the host's own time per call (the wrapper's
    # checks, tensor maps and ctypes call, clocked without a synchronize)
    # stay beside them.
    calls = [lambda q=q, k=k, v=v, sc=sc, c=c: launch(q, k, v, scale=sc, causal=c)
             for q, k, v, sc, c, _ in seen]
    lib_calls = [lambda q=q, k=k, v=v, sc=sc, c=c: F.scaled_dot_product_attention(
                     q, k, v, is_causal=c, enable_gqa=True, scale=sc)
                 for q, k, v, sc, c, _ in seen]
    # At least FA_PROFILE_LAUNCHES launches a graph or a profiled window:
    # a window of one or two launches has read SDPA below its own bound.
    greps = -(-FA_PROFILE_LAUNCHES // len(calls))
    reps = max(5, greps)
    fa["ms"] = graph_ms_per_call(calls, greps)
    fa["library_ms"] = graph_ms_per_call(lib_calls, greps)
    for key, fns in (("profiler", calls), ("library_profiler", lib_calls)):
        fa[f"{key}_ms"] = device_ms_per_call(fns, reps)
        fa[f"{key}_records"] = [PROFILE_WINDOWS[-1]["records"],
                                PROFILE_WINDOWS[-1]["calls"]]
    if regtile:
        basic_calls = [lambda q=q, k=k, v=v, sc=sc, c=c: basic(
                           q, k, v, scale=sc, causal=c)
                       for q, k, v, sc, c, _ in seen]
        fa["basic_ms"] = graph_ms_per_call(basic_calls, greps)
        fa["basic_profiler_ms"] = device_ms_per_call(basic_calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    fa["host_ms"] = 1e3 * (time.perf_counter() - t0) / len(calls)
    torch.cuda.synchronize()
    fa["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    fa["units"] = max(r["units"] for r in rows)
    fa["bound_by"] = rows[0]["bound_by"]
    fa["bound_share"] = fa["bound_ms"] / fa["ms"]
    fa["cuda_cores_share"] = fa["cuda_cores_ms"] / fa["ms"]
    fa["rows"] = rows
    unit = ("units of 1 spacing + 2^-8 max|v| + 2e-5" if hopper else
            ("bfloat16 spacings" if rows[0]["dtype"] != "torch.float32"
             else f"(float32, atol {FA_F32_ATOL})"))
    beside = ""
    if hopper:
        beside = f", the CUDA-core kernel {fa['simt_ms']:.4f} ms (eager events)"
    Dk, Dv = seen[0][0].shape[-1], seen[0][2].shape[-1]
    if regtile:
        fa["basic_max_abs_err"] = max(r["basic_max_abs_err"] for r in rows)
        fa["basic_gap"] = max(r["basic_gap"] for r in rows)
        fa["basic_share"] = fa["bound_ms"] / fa["basic_ms"]
        fa["smem_bytes"] = int(fa_kernel.load_library().lib
                               .flash_attention_regtile_smem(Dk, Dv))
        fa["ptxas"] = flash_build_report("regtile")
        beside = (f", the basic body on the same inputs {fa['basic_ms']:.4f} "
                  f"ms ({100 * fa['basic_share']:.1f}% of the bound; profiler "
                  f"{fa['basic_profiler_ms']:.4f} ms; within {fa['basic_gap']} "
                  f"of the register-tiled body)")
        for line in fa["ptxas"]:
            log(f"[build] flash_attention_simt_regtile {line}")
        log(f"[build] flash_attention_simt_regtile shared memory at (Dk, Dv) = "
            f"({Dk}, {Dv}): {fa['smem_bytes']} bytes a block")
    if basic_body:
        f32 = seen[0][0].dtype == torch.float32
        packed = int(fa_kernel.load_library().lib.flash_attention_basic_smem(
            Dk, Dv, int(f32)))
        fa["rows_a_block"], fa["smem_bytes"] = packed >> 32, packed & 0xFFFFFFFF
        fa["ptxas"] = flash_build_report("basic")
        for line in fa["ptxas"]:
            log(f"[build] flash_attention_simt_basic {line}")
        log(f"[build] flash_attention_simt_basic at (Dk, Dv) = ({Dk}, {Dv}), "
            f"{rows[0]['dtype']}: {fa['rows_a_block']} packed rows and "
            f"{fa['smem_bytes']} bytes of shared memory a block")
    cores = ""
    if not hopper and rows[0]["dtype"] != "torch.float32":
        cores = (f", {100 * fa['cuda_cores_share']:.1f}% of "
                 f"{fa['cuda_cores_ms']:.4f} ms at the float32 CUDA-core rate")
    timing = (f"{fa['ms']:.4f} ms (a CUDA graph of the launches timed by "
              f"events; {100 * fa['bound_share']:.1f}% of the bound{cores}; "
              f"profiler device time {fa['profiler_ms']:.4f} ms from "
              f"{fa['profiler_records'][0]} kernel records of "
              f"{fa['profiler_records'][1]} launches; CUDA events around "
              f"{FA_TIME_REPS} eager launches {fa['event_ms']:.4f} ms; host "
              f"time per call {fa['host_ms']:.4f} ms), plain "
              f"{fa['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{fa['library_ms']:.4f} ms (graph; profiler "
              f"{fa['library_profiler_ms']:.4f} from "
              f"{fa['library_profiler_records'][0]} kernel records of "
              f"{fa['library_profiler_records'][1]} calls; eager events "
              f"{fa['library_event_ms']:.4f})")
    log(f"[time] {name} at q {rows[0]['shape_q']}, k {rows[0]['shape_k']}, "
        f"{rows[0]['dtype']}, causal={seen[0][4]}, mean over the {len(rows)} "
        f"launches: " + timing
        + f"{beside}, bound {fa['bound_ms']:.4f} ms ({fa['bound_by']}); all within "
        f"tolerance of both plain versions (worst {fa['units']} {unit}, "
        f"max_abs_err {fa['max_abs_err']}); card {card}")
    return fa


def serve_traffic(cfg, params, prompts: list, card: str, tag: str = "[serve]",
                  slots: int = SERVE_SLOTS, gen_len: int = SERVE_GEN,
                  max_len: int = SERVE_MAX, mesh=None, moe_impl: str = "gspmd"):
    """``ContinuousBatcher`` (made under ``mesh``, with ``moe_impl``) over
    ``prompts`` until every request has ``gen_len`` tokens, with every
    launch count set to 0 just before and read just after; prefill and
    decode times on the host clock around a synchronize.  Request 0's
    served logits (its prefill, then each decode step while it is active)
    are kept on the card (device copies, no sync).  Returns (record,
    served logits, batcher)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import mesh_context

    served = []
    prefill_fn = T.prefill

    def prefill_capture(*args, **kw):
        logits, caches = prefill_fn(*args, **kw)
        if not served:
            served.append(logits[0, -1].clone())
        return logits, caches

    start_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mesh_context(mesh):
        batcher = serve.ContinuousBatcher(cfg, params, slots, max_len, moe_impl)
    decode_fn = batcher._decode

    def decode_capture(toks, pos):
        logits, caches = decode_fn(toks, pos)
        if batcher.active[0] and batcher.slot_req[0] == 0:
            served.append(logits[0, 0].clone())
        return logits, caches

    batcher._decode = decode_capture
    n = len(prompts)
    queue, finished, prefill_s, decode_s = list(range(n)), [], [], []
    reset_launches()
    T.prefill = prefill_capture
    try:
        t_run = time.perf_counter()
        while len(finished) < n:
            while queue:
                t0 = time.perf_counter()
                if not batcher.admit(queue[0], prompts[queue[0]]):
                    break
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t0)
                queue.pop(0)
            t0 = time.perf_counter()
            batcher.step()
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            finished += batcher.retire(gen_len)
        wall = time.perf_counter() - t_run
    finally:
        T.prefill = prefill_fn
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    outs = [batcher.outputs[r] for r in range(n)]
    if any(len(o) != gen_len for o in outs) or sorted(finished) != list(range(n)):
        raise AssertionError("not every request finished with its tokens")
    if len(served) != gen_len:
        raise AssertionError(f"captured {len(served)} served logit vectors")
    generated = sum(len(o) for o in outs)
    rec = {
        "requests": n, "slots": slots, "prompt_len": len(prompts[0]),
        "gen_len": gen_len, "max_len": max_len, "launches": launches,
        "prefill_ms": [1e3 * t for t in prefill_s],
        "prefill_ms_median": 1e3 * float(np.median(prefill_s)),
        "decode_steps": len(decode_s), "decode_ms": [1e3 * t for t in decode_s],
        "decode_ms_median": 1e3 * float(np.median(decode_s)),
        "wall_s": wall, "generated_tokens": generated,
        "generated_tok_s": generated / wall,
        "slot_tok_s": len(decode_s) * slots / wall,
        "peak_mem_bytes": peak, "start_mem_bytes": start_mem,
    }
    log(f"{tag} {n} requests x {len(prompts[0])}-token prompts over "
        f"{slots} slots, {gen_len} tokens each: prefill median "
        f"{rec['prefill_ms_median']:.2f} ms/request (min {min(rec['prefill_ms']):.2f},"
        f" max {max(rec['prefill_ms']):.2f}), decode median "
        f"{rec['decode_ms_median']:.2f} ms/step over {len(decode_s)} steps (min "
        f"{min(rec['decode_ms']):.2f}, max {max(rec['decode_ms']):.2f}); "
        f"{generated} tokens in {wall:.3f} s = {rec['generated_tok_s']:.1f} "
        f"generated tok/s ({rec['slot_tok_s']:.1f} slot-steps/s); peak device "
        f"memory {peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    return rec, served, batcher


def profile_serving(batcher, prompts: list, tag: str, spans=()) -> dict:
    """Where the time goes: one more admit (a prefill) and one decode step
    of the then full slots, each under the profiler (``spans`` as
    ``profile_call``'s)."""
    for r in range(batcher.slots - 1):
        batcher.admit(100 + r, prompts[r + 1])
    prof = {"prefill": profile_call(lambda: batcher.admit(99, prompts[0]),
                                    spans),
            "decode": profile_call(batcher.step, spans)}
    for name, pr in prof.items():
        log(f"{tag} profiled {name}: wall {pr['wall_ms']:.2f} ms, device "
            f"{pr['device_ms']:.2f} ms (busy {pr['busy_share'] or 0:.2f}), "
            f"{pr['launches']} kernel launches, {pr['launch_api_calls']} host "
            f"launch calls; by family: "
            + ", ".join(f"{k} {v['ms']:.3f} ms x{v['count']}"
                        for k, v in pr["kinds"].items() if v["count"]))
        for row in pr["top"][:8]:
            log(f"{tag}   {row['ms']:9.3f} ms x{row['count']:<5d} {row['name']}")
    return prof


def run_serving(card: str, dev: torch.device) -> dict:
    """Phase 11: ``ContinuousBatcher`` over ``internlm2-1.8b`` at full
    width, then checks (a)-(c)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = M.get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    log(f"[serve] {SERVE_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab_size}; {n_params} {cfg.param_dtype} "
        f"parameters made on the card in {t_init:.2f} s")

    run, served, batcher = serve_traffic(cfg, params, prompts, card)
    launches = run["launches"]
    expect = cfg.num_layers * SERVE_REQUESTS
    if launches != {**{k: 0 for k in launches}, "flash_attention_wgmma": expect}:
        raise AssertionError(f"serving made launches {launches}; expected "
                             f"{cfg.num_layers} of flash_attention_wgmma per "
                             f"request, {expect} in all, and nothing else")
    outs = [batcher.outputs[r] for r in range(SERVE_REQUESTS)]
    rec = {"arch": SERVE_ARCH, "params": n_params, "init_s": t_init, **run}

    # (a) One request's 24 launches, captured with their inputs.
    tok0 = torch.as_tensor(prompts[0][None, :], device=dev)
    seen = capture_flash(lambda: T.prefill(cfg, params, {"tokens": tok0},
                                           max_len=SERVE_MAX), cfg.num_layers)
    fa = hold_flash_launches(seen, card, "flash_attention_wgmma")
    del seen

    prof = profile_serving(batcher, prompts, "[serve]")
    decode16 = compare_decode(batcher, card)

    # (b) The served logits against the float32 forward with the plain
    # attention, over the prompt and the tokens fed back.
    toks = served_tokens(prompts[0], outs[0], dev)
    cfg32 = cfg.with_overrides(dtype="float32")
    got = torch.stack(served).float().cpu()

    def forward_tail(c, attention) -> torch.Tensor:
        return forward_logits(c, params, toks, attention)

    want = forward_tail(cfg32, fa_ref.mha_reference)
    err = rel_rms(got, want)
    leak = rel_rms(forward_tail(cfg, unmasked_attention), want)
    fwd_bf16 = rel_rms(forward_tail(cfg, fa_kernel.flash_attention), want)
    same_argmax = int((got.argmax(-1) == want.argmax(-1)).sum())
    rec_b = {"served_rel_rms_max": float(err.max()),
             "served_rel_rms": err.tolist(),
             "served_max_abs": float((got - want).abs().max()),
             "ref_logit_rms": float(want.pow(2).mean().sqrt()),
             "bf16_forward_rel_rms_max": float(fwd_bf16.max()),
             "unmasked_rel_rms_min": float(leak.min()),
             "unmasked_rel_rms_max": float(leak.max()),
             "argmax_agree": same_argmax, "tol": SERVED_RTOL}
    log(f"[serve] served logits of request 0 (prefill + {SERVE_GEN - 1} decode "
        f"steps) against the float32 forward with the plain attention: relative "
        f"RMS error max {rec_b['served_rel_rms_max']:.5f} (tolerance "
        f"{SERVED_RTOL}), max abs {rec_b['served_max_abs']:.5f} at logit RMS "
        f"{rec_b['ref_logit_rms']:.4f}, argmax agrees at {same_argmax}/{SERVE_GEN}; "
        f"the bfloat16 forward through the kernel: {rec_b['bf16_forward_rel_rms_max']:.5f}"
        f"; with the causal mask dropped: {rec_b['unmasked_rel_rms_min']:.5f}-"
        f"{rec_b['unmasked_rel_rms_max']:.5f}")
    if not float(err.max()) <= SERVED_RTOL:
        raise AssertionError(f"served logits differ from the float32 forward: "
                             f"relative RMS {float(err.max())} > {SERVED_RTOL}")
    if not float(leak.max()) > SERVED_RTOL:
        raise AssertionError(f"a forward without the causal mask stays within the "
                             f"tolerance ({float(leak.max())}): the check cannot "
                             "see an unmasked causal edge")

    # (c) The float32 forward through the kernels: the CUDA-core kernel's
    # path (float32 is not the Hopper kernel's), all of it through the
    # register-tiled body; then the same forward through the basic body,
    # and the 24 launches held and timed.
    reset_launches()
    f32 = forward_tail(cfg32, fa_kernel.flash_attention)
    launches_f32 = read_launches()
    if launches_f32 != {**{k: 0 for k in launches_f32},
                        "flash_attention": cfg.num_layers,
                        "flash_attention_simt_regtile": cfg.num_layers}:
        raise AssertionError(f"the float32 forward made launches {launches_f32}; "
                             f"expected {cfg.num_layers} of flash_attention, all "
                             "of the register-tiled body")
    f32_err = float(rel_rms(f32, want).max())
    log(f"[serve] float32 forward through the CUDA-core flash kernel "
        f"({launches_f32['flash_attention_simt_regtile']} launches of the "
        f"register-tiled body): logits within relative RMS {f32_err:.3e} of the "
        f"plain float32 forward (tolerance {F32_FWD_RTOL})")
    if not f32_err <= F32_FWD_RTOL:
        raise AssertionError(f"float32 forward through the kernel differs: "
                             f"relative RMS {f32_err} > {F32_FWD_RTOL}")
    reset_launches()
    f32_basic = forward_tail(cfg32, fa_kernel.flash_attention_simt_basic)
    launches_basic = read_launches()
    if launches_basic != {**{k: 0 for k in launches_basic},
                          "flash_attention_simt_basic": cfg.num_layers}:
        raise AssertionError(f"the float32 forward through the basic body made "
                             f"launches {launches_basic}")
    basic_err = float(rel_rms(f32_basic, want).max())
    log(f"[serve] the same forward through the basic body ({cfg.num_layers} "
        f"launches): logits within relative RMS {basic_err:.3e} of the plain "
        f"float32 forward")
    if not basic_err <= F32_FWD_RTOL:
        raise AssertionError(f"float32 forward through the basic body differs: "
                             f"relative RMS {basic_err} > {F32_FWD_RTOL}")
    seen = capture_flash(lambda: T.forward(cfg32, params, {"tokens": toks}),
                         cfg.num_layers)
    fa32 = hold_flash_launches(seen, card, "flash_attention_simt_regtile")
    del seen, params, batcher
    torch.cuda.empty_cache()
    gemma = flash_basic_gemma(card, dev)
    return {**rec, "flash": fa, "flash_f32": fa32,
            "flash_f32_launches": launches_f32, "f32_forward_rel_rms": f32_err,
            "flash_f32_basic_launches": launches_basic,
            "f32_basic_forward_rel_rms": basic_err,
            "flash_basic_gemma": gemma,
            "served_logits": rec_b, "profile": prof, "programs": decode16}


# The basic body's three shapes (PERF.md section 6), (name, dtype, B, Hq,
# Hkv, S, Dk, Dv), causal: the float32 forward's (phase 11 (c)), the float32
# MLA prefill's (phase 18 (a), v contiguous here) and Gemma 2 9B's.
FLASH_BASIC_SHAPES = (
    ("f32_forward", torch.float32, 1, 16, 8, 2079, 128, 128),
    ("mla", torch.float32, 1, 16, 16, 2079, 192, 128),
    ("gemma", torch.bfloat16, *GEMMA_ATTN, GEMMA_ATTN[-1]),
)


def time_flash_basic_sources(sources: list, card: str, dev) -> list[dict]:
    """``python3 chip_smoke.py --time-flash-basic [SOURCE ...]``: the basic
    body (``flash_attention_basic_launch``) of this checkout's
    ``flash_attention.cu`` and of each further source given (another
    tree's, unpacked beside this one), built here, at FLASH_BASIC_SHAPES
    on seeded inputs, each held and timed by ``hold_flash_launches`` in
    turns (this one, the others, the others, this one)."""
    import ctypes
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    libs = {}
    for src in [fa_kernel.SOURCE, *sources]:
        built = _build.build(Path(src))
        fn = built.lib.flash_attention_basic_launch
        fn.argtypes, fn.restype = fa_kernel._ARGTYPES, ctypes.c_int
        libs[str(src)] = built
        log(f"[ab] built {src} in {built.seconds:.2f} s")
    names = list(libs)
    rows = []
    for shape, dtype, B, Hq, Hkv, S, Dk, Dv in FLASH_BASIC_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)

        def rand(h, d):
            return torch.randn(B, h, S, d, generator=gen, device=dev).to(dtype)

        q, k, v = rand(Hq, Dk), rand(Hkv, Dk), rand(Hkv, Dv)
        row = {"shape": shape, "shape_q": list(q.shape), "shape_v": list(v.shape),
               "dtype": str(dtype), **fa_bound(q, k, v, True),
               "ms": {n: [] for n in names}, "max_abs_err": {}}
        for n in names + names[::-1]:
            def launch(q, k, v, *, scale, causal, built=libs[n]):
                return fa_kernel._launch(built, "flash_attention_basic_launch",
                                         q, k, v, scale, causal)

            log(f"[ab] {n} at {shape}:")
            out = launch(q, k, v, scale=Dk ** -0.5, causal=True)
            fa = hold_flash_launches([(q, k, v, Dk ** -0.5, True, out)], card,
                                     "flash_attention_simt_basic", launch)
            row["ms"][n].append(fa["ms"])
            row["max_abs_err"][n] = fa["max_abs_err"]
            row["library_ms"] = fa["library_ms"]
        rows.append(row)
    return rows


def flash_basic_gemma(card: str, dev) -> dict:
    """Phase 11 (c), last: one bfloat16 launch at Gemma 2 9B's attention
    shape (``GEMMA_ATTN``, causal, seeded inputs) through the dispatching
    ``kernel.flash_attention``, which must reach the basic body (head dim
    256 is not the Hopper kernel's); held against both plain versions and
    timed beside SDPA, its bound at the tensor cores' bf16 rate, and the
    float32 CUDA-core rate's figure beside it."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    B, Hq, Hkv, S, D = GEMMA_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def rand(h):
        return torch.randn(B, h, S, D, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rand(Hq), rand(Hkv), rand(Hkv)
    scale = D ** -0.5
    reset_launches()
    out = fa_kernel.flash_attention(q, k, v, scale=scale, causal=True)
    launches = read_launches()
    if launches != {**{k_: 0 for k_ in launches}, "flash_attention": 1,
                    "flash_attention_simt_basic": 1}:
        raise AssertionError(f"the Gemma-shape launch made launches "
                             f"{ {k_: n for k_, n in launches.items() if n} }; "
                             "expected one of the basic body")
    fa = hold_flash_launches([(q, k, v, scale, True, out)], card,
                             "flash_attention_simt_basic")
    fa["library_factor"] = fa["ms"] / fa["library_ms"]
    log(f"[time] flash_attention_simt_basic at Gemma 2 9B's attention shape "
        f"(bf16, GQA 16 / 8, head dim 256, S {S}): {fa['ms']:.4f} ms, "
        f"{100 * fa['bound_share']:.1f}% of its {fa['bound_ms']:.4f} ms bound "
        f"(bf16 operands at the tensor cores' rate; "
        f"{100 * fa['cuda_cores_share']:.1f}% of {fa['cuda_cores_ms']:.4f} ms "
        f"at the float32 CUDA-core rate the kernel multiplies at); "
        f"scaled_dot_product_attention {fa['library_ms']:.4f} ms, "
        f"{fa['library_factor']:.1f}x faster; card {card}")
    return fa


def whole(t) -> torch.Tensor:
    """A cache tensor, or a mesh cache's pieces reassembled."""
    from repro_torch.parallel.sharding import ShardedTensor, unshard

    return unshard(t) if isinstance(t, ShardedTensor) else t


def compare_decode(batcher, card: str, tag: str = "[programs]",
                   spans=()) -> dict:
    """Phase 16 (d): the batcher's captured decode step against its eager
    step, from identical copies of the caches at the same tokens and
    position: logits and caches bit-equal; then both timed at that
    position (host clock around a synchronize, alternated, median of
    10; each call rewrites the same cache row) and profiled once
    (``spans`` as ``profile_call``'s)."""
    from repro_torch import compile as programs

    active = np.flatnonzero(batcher.active)
    pos = int(batcher.pos[active].max())
    toks = np.zeros((batcher.slots, 1), np.int32)
    for s in active:
        toks[s, 0] = batcher.outputs[batcher.slot_req[s]][-1]
    toks = torch.as_tensor(toks, device=batcher.device)
    mine = batcher.caches
    twin = [{n: t.clone() for n, t in c.items()} for c in mine]  # a mesh
    # cache's clone keeps its layout: the pieces of one cloned tensor
    n0 = programs.compile_count()
    got, _ = batcher._decode(toks, pos)
    replayed = programs.compile_count() == n0
    batcher.caches = twin
    try:
        with programs.eager():
            want, _ = batcher._decode(toks, pos)
    finally:
        batcher.caches = mine
    torch.cuda.synchronize()
    caches_equal = all(torch.equal(whole(a[k]), whole(b[k]))
                       for a, b in zip(mine, twin) for k in a)
    if not (replayed and torch.equal(got, want) and caches_equal):
        raise AssertionError(f"captured decode step differs from eager: "
                             f"replayed {replayed}, logits equal "
                             f"{torch.equal(got, want)}, caches equal {caches_equal}")
    del twin, got, want

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def step():
        batcher._decode(toks, pos)

    def eager_step():
        with programs.eager():
            batcher._decode(toks, pos)

    times = {"programs": [], "eager": []}
    for _ in range(WARM_REPS):
        times["programs"].append(timed(step))
        times["eager"].append(timed(eager_step))
    prof = {"programs": profile_call(step, spans),
            "eager": profile_call(eager_step, spans)}
    med = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    log(f"{tag} decode step ({batcher.slots} slots, pos {pos}): captured "
        f"== eager bit for bit (logits and caches); median of {WARM_REPS}, "
        f"alternated: programs {med['programs']:.2f} ms, eager "
        f"{med['eager']:.2f} ms; profiled: "
        + "; ".join(f"{k} wall {p['wall_ms']:.2f} device {p['device_ms']:.2f} ms "
                    f"(busy {p['busy_share'] or 0:.2f}), {p['launches']} kernels, "
                    f"{p['launch_api_calls']} host launch calls"
                    for k, p in prof.items())
        + "".join(f"; {k}'s {s} family {p['kinds'][s]['ms']:.3f} ms "
                  f"x{p['kinds'][s]['count']}" for k, p in prof.items()
                  for s in spans) + f"; card {card}")
    return {"bit_equal": True, "pos": pos,
            "times_ms": {k: [1e3 * t for t in v] for k, v in times.items()},
            "median_ms": med, "profile": prof}


# ---------------------------------------------------------------------------
# Phase 18: the MoE and MLA serving path at full width
# ---------------------------------------------------------------------------

def first_moe_layer(cfg) -> int:
    from repro_torch.configs.base import layer_layout

    return next(i for i, s in enumerate(layer_layout(cfg)) if s.ffn == "moe")


def moe_layers(cfg) -> int:
    from repro_torch.configs.base import layer_layout

    return sum(s.ffn == "moe" for s in layer_layout(cfg))


def attention_layers(cfg) -> int:
    from repro_torch.configs.base import layer_layout

    return sum(s.mixer in ("attn", "mla") for s in layer_layout(cfg))


def mamba_layers(cfg) -> list[int]:
    from repro_torch.configs.base import layer_layout

    return [i for i, s in enumerate(layer_layout(cfg)) if s.mixer == "mamba"]


def grouped_bound(x_sorted: torch.Tensor, sizes: torch.Tensor,
                  w_gate: torch.Tensor, w_down: torch.Tensor) -> dict:
    """Least time for one grouped SwiGLU: its FLOP (three GEMMs of
    2·M·D·F) at the tensor-core rate of the operand type, or its bytes
    (the sorted rows and offsets read once, the weights of every expert
    this run's routing gives a row read once, the output written once)
    over the HBM rate."""
    M, D = x_sorted.shape
    F = w_gate.shape[-1]
    used = int((sizes > 0).sum())
    esize = x_sorted.element_size()
    flop = 3 * 2.0 * M * D * F
    nbytes = (2 * M * D * esize + sizes.numel() * 4
              + used * (3 * D * F) * w_down.element_size())
    t_ops = 1e3 * flop / PEAK_FLOP_S[x_sorted.dtype]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "experts_used": used, "rows": M}


def forward_logits(cfg, params, toks, attention, grouped=None) -> torch.Tensor:
    """``T.forward``'s logits from the prompt's last position on, with the
    attention's implementation substituted (and the grouped SwiGLU's, when
    ``grouped`` is given).  With Mamba2 layers the tokens are padded to a
    multiple of the SSD's chunk, as it requires; every layer is causal,
    so the rows kept do not change."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import ffn
    from repro_torch.models import transformer as T

    n = toks.shape[1]
    if mamba_layers(cfg):
        toks = torch.nn.functional.pad(toks, (0, -n % cfg.ssm_chunk))
    own = ffn.grouped_swiglu
    fa_ops.kernel = SimpleNamespace(flash_attention=attention)
    ffn.grouped_swiglu = grouped or own
    try:
        logits, _ = T.forward(cfg, params, {"tokens": toks})
    finally:
        fa_ops.kernel = fa_kernel
        ffn.grouped_swiglu = own
    return logits[0, SERVE_PROMPT - 1:n].float().cpu()


def unmasked_attention(q, k, v, *, scale, causal):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    return fa_kernel.flash_attention(q, k, v, scale=scale, causal=False)


def served_tokens(prompt, outs, dev) -> torch.Tensor:
    toks = np.concatenate([prompt, np.asarray(outs[:-1], np.int32)])
    return torch.as_tensor(toks[None, :], device=dev)


def expect_serving_launches(launches: dict, cfg, requests: int, steps: int,
                            what: str) -> None:
    """Exactly one Hopper flash launch per attention layer per prefill, one
    grouped SwiGLU per MoE layer per prefill and decode step (counted
    through the replays), and nothing else: no CUDA-core flash body, no
    loop."""
    want = {**{k: 0 for k in launches},
            "flash_attention_wgmma": attention_layers(cfg) * requests,
            "grouped_swiglu_mm": moe_layers(cfg) * (requests + steps)}
    if launches != want:
        raise AssertionError(f"{what} made launches "
                             f"{ {k: v for k, v in launches.items() if v} }; "
                             f"expected { {k: v for k, v in want.items() if v} }")


def moe_check_model(arch: str, tag: str, layers: int, tol: float, card: str,
                    dev) -> tuple:
    """Phase 18 (a): ``arch`` at full width cut to ``layers`` layers,
    float32 parameters from a seeded generator, one request (2048-token
    prompt, 32 tokens) served through ``ContinuousBatcher`` (bfloat16,
    the Hopper flash kernel, the grouped GEMM), its served logits held
    against the float32 ``forward`` with the plain attention and the
    plain grouped SwiGLU (the loop) within ``tol``; a forward without the
    causal mask must fall outside it.  With MLA layers the float32 forward
    also runs through the kernels (``mla_f32_forward``).  Returns (record,
    cfg, params)."""
    from repro_torch.configs.base import layer_layout
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = M.get_config(arch).with_overrides(num_layers=layers)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
    run, served, batcher = serve_traffic(cfg, params, [prompt], card,
                                         f"{tag} (a)", slots=1,
                                         max_len=SERVE_PROMPT + SERVE_GEN)
    expect_serving_launches(run["launches"], cfg, 1, run["decode_steps"],
                            f"{tag} (a) serving")
    toks = served_tokens(prompt, batcher.outputs[0], dev)
    del batcher
    got = torch.stack(served).float().cpu()
    cfg32 = cfg.with_overrides(dtype="float32")
    want = forward_logits(cfg32, params, toks, fa_ref.mha_reference,
                          ffn.grouped_swiglu_loop)
    err = rel_rms(got, want)
    fwd_bf16 = rel_rms(forward_logits(cfg, params, toks,
                                      fa_kernel.flash_attention), want)
    leak = rel_rms(forward_logits(cfg, params, toks, unmasked_attention), want)
    rec = {"layers": layers, "serve": run,
           "served_rel_rms_max": float(err.max()), "served_rel_rms": err.tolist(),
           "served_max_abs": float((got - want).abs().max()),
           "ref_logit_rms": float(want.pow(2).mean().sqrt()),
           "bf16_forward_rel_rms_max": float(fwd_bf16.max()),
           "unmasked_rel_rms_min": float(leak.min()),
           "unmasked_rel_rms_max": float(leak.max()),
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "tol": tol}
    log(f"{tag} (a) {arch} cut to {layers} layers, float32 parameters: served "
        f"logits (prefill + {SERVE_GEN - 1} decode steps) against the float32 "
        f"forward with the plain attention and the plain grouped SwiGLU: "
        f"relative RMS error max {rec['served_rel_rms_max']:.5f} (tolerance "
        f"{tol}), max abs {rec['served_max_abs']:.5f} at logit RMS "
        f"{rec['ref_logit_rms']:.4f}, argmax agrees at {rec['argmax_agree']}/"
        f"{SERVE_GEN}; the bfloat16 forward through the kernels: "
        f"{rec['bf16_forward_rel_rms_max']:.5f}; with the causal mask dropped: "
        f"{rec['unmasked_rel_rms_min']:.5f}-{rec['unmasked_rel_rms_max']:.5f}; "
        f"card {card}")
    if not rec["served_rel_rms_max"] <= tol:
        raise AssertionError(f"{tag} served logits differ from the float32 "
                             f"forward: relative RMS {rec['served_rel_rms_max']} > "
                             f"{tol}")
    if not rec["unmasked_rel_rms_max"] > tol:
        raise AssertionError(f"{tag} a forward without the causal mask stays "
                             f"within the tolerance: the check cannot see it")
    if any(s.mixer == "mla" for s in layer_layout(cfg)):
        rec["mla_f32"] = mla_f32_forward(cfg32, params, toks, want, tag, card)
    return rec, cfg, params


def mla_f32_forward(cfg32, params, toks, want, tag: str, card: str) -> dict:
    """Phase 18 (a)'s float32 MLA prefill through the kernels: the check
    model's float32 ``forward`` with ``kernel.flash_attention`` (the plain
    grouped SwiGLU: the grouped GEMM takes no float32), one launch a layer,
    all of the basic body (float32 at (Dk, Dv) = (192, 128)), its logits
    within F32_FWD_RTOL of the plain float32 forward ``want``; each launch
    captured and held against both plain versions and timed as phase 11
    (c)'s are (``hold_flash_launches``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import ffn

    seen = []

    def spy(q, k, v, *, scale, causal):
        out = fa_kernel.flash_attention(q, k, v, scale=scale, causal=causal)
        seen.append((q.clone(), k.clone(), v.clone(), scale, causal, out.clone()))
        return out

    reset_launches()
    got = forward_logits(cfg32, params, toks, spy, ffn.grouped_swiglu_loop)
    launches = read_launches()
    layers = attention_layers(cfg32)
    if launches != {**{k: 0 for k in launches}, "flash_attention": layers,
                    "flash_attention_simt_basic": layers}:
        raise AssertionError(f"{tag} (a) the float32 forward made launches "
                             f"{ {k: v for k, v in launches.items() if v} }; "
                             f"expected {layers} of the basic body and nothing "
                             "else")
    err = float(rel_rms(got, want).max())
    log(f"{tag} (a) float32 MLA forward through the CUDA-core flash kernel "
        f"({layers} launches of the basic body at q {list(seen[0][0].shape)}, "
        f"v {list(seen[0][2].shape)}): logits within relative RMS {err:.3e} of "
        f"the plain float32 forward (tolerance {F32_FWD_RTOL}); card {card}")
    if not err <= F32_FWD_RTOL:
        raise AssertionError(f"{tag} float32 forward through the basic body "
                             f"differs: relative RMS {err} > {F32_FWD_RTOL}")
    fa = hold_flash_launches(seen, card, "flash_attention_simt_basic")
    return {"launches": launches, "rel_rms": err, "flash": fa}


def moe_layer_check(cfg, params, tag: str, card: str, dev) -> dict:
    """Phase 18 (b): the first MoE layer of the check model, bfloat16
    inputs at the prefill's and the decode step's token counts: the card's
    route against the plain router (float64 on the host) wherever the
    k-th / (k+1)-th probability gap exceeds ROUTE_GAP_TOL; the grouped
    GEMM against the loop on the same sorted rows within GROUPED_RTOL
    (the loop with its groups shifted by one expert must fall outside);
    both timed, with the grouped GEMM's bound."""
    from repro_torch.models import ffn
    from repro_torch.models.common import cast_params
    from repro_torch.models.ffn import moe_ffn

    L = first_moe_layer(cfg)
    p = cast_params(params["layers"][L]["ffn"], torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    k = cfg.top_k
    out = {"layer": L}
    for shape, tokens in (("prefill", SERVE_PROMPT), ("decode", SERVE_SLOTS)):
        x = torch.randn(tokens, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        top_p, top_i, _ = moe_ffn.route(cfg, p, x)
        probs = torch.softmax(x.double().cpu() @ p["router"]["w"].double().cpu(),
                              dim=-1)
        sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
        clear = (sp[:, k - 1] - sp[:, k]) > ROUTE_GAP_TOL
        same = (top_i.cpu().sort(-1).values == si[:, :k].sort(-1).values).all(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"{tag} (b) {shape}: the card's route differs "
                                 f"from the plain router on "
                                 f"{int((~same & clear).sum())} tokens")
        seen = {}

        def spy(*args):
            seen["args"] = args
            return ffn.grouped_swiglu_mm(*args)

        own = ffn.grouped_swiglu
        ffn.grouped_swiglu = spy
        try:
            moe_ffn._dropless(cfg, p["experts"], x, top_p, top_i)
        finally:
            ffn.grouped_swiglu = own
        args = seen["args"]
        x_sorted, sizes, offs, w_gate, w_up, w_down = args
        reset_launches()
        got = ffn.grouped_swiglu_mm(*args)
        launches = read_launches()["grouped_swiglu_mm"]
        want = ffn.grouped_swiglu_loop(*args)
        err = rel_rms(got, want)
        shifted = torch.roll(sizes, 1)
        wrong = rel_rms(ffn.grouped_swiglu_loop(
            x_sorted, shifted, torch.cumsum(shifted, 0).to(torch.int32),
            w_gate, w_up, w_down), want)
        if not float(err.max()) <= GROUPED_RTOL:
            raise AssertionError(f"{tag} (b) {shape}: the grouped GEMM differs "
                                 f"from the loop: relative RMS {float(err.max())}")
        moved = float((wrong > GROUPED_RTOL).float().mean())
        if not float(wrong.max()) > GROUPED_RTOL:
            raise AssertionError(f"{tag} (b) {shape}: shifted groups stay within "
                                 f"the tolerance: the check cannot see them")
        ms = device_ms_per_call([lambda: ffn.grouped_swiglu_mm(*args)])
        event_ms = time_cuda(lambda: ffn.grouped_swiglu_mm(*args), 20)
        loop_ms = time_cuda(lambda: ffn.grouped_swiglu_loop(*args), 3)
        layer_ms = time_cuda(lambda: moe_ffn.apply(cfg, p, x[None]), 10)
        bnd = grouped_bound(x_sorted, sizes, w_gate, w_down)
        out[shape] = {"tokens": tokens, "launches": launches,
                      "route_clear": int(clear.sum()),
                      "route_tied": int((~clear).sum()),
                      "rel_rms_max": float(err.max()),
                      "shifted_rel_rms_max": float(wrong.max()),
                      "shifted_rows_outside": moved,
                      "ms": ms, "event_ms": event_ms, "plain_ms": loop_ms,
                      "layer_event_ms": layer_ms, **bnd}
        log(f"{tag} (b) one MoE layer (layer {L}) at the {shape}'s {tokens} "
            f"tokens ({bnd['rows']} sorted rows, {bnd['experts_used']} of "
            f"{cfg.num_experts} experts used): route == the plain router on "
            f"{int(clear.sum())} tokens with a k/k+1 gap over {ROUTE_GAP_TOL} "
            f"({int((~clear).sum())} within it); grouped GEMM against the loop: "
            f"relative RMS {float(err.max()):.2e} (tolerance {GROUPED_RTOL}; the "
            f"groups shifted by one expert: up to {float(wrong.max()):.3f}, "
            f"{100 * moved:.1f}% of the rows outside it); "
            f"torch._grouped_mm x3 {ms:.4f} ms device time (events {event_ms:.4f}),"
            f" the loop {loop_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}; {bnd['flop'] / 1e9:.2f} GFLOP, "
            f"{bnd['bytes'] / 1e6:.1f} MB), the whole layer {layer_ms:.4f} ms; "
            f"card {card}")
    return out


def cache_bytes(cfg, slots: int, max_len: int) -> int:
    from repro_torch.models import transformer as T

    caches = T.init_decode_caches(cfg, slots, max_len, device="meta")
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())


def serve_full_model(arch: str, tag: str, over: dict, tol: float, card: str,
                     dev, hold_unmasked: bool = True) -> dict:
    """Phase 18 (c) and 19 (c): ``arch`` at published widths, cut and
    typed by ``over``, parameters from a seeded generator, phase 11's
    traffic: launches (exactly one Hopper flash launch per attention layer
    per prefill, one grouped SwiGLU per MoE layer per prefill and decode
    step, nothing else), the first (up to two) flash launches of request 0
    held and timed, profiles (with the SSD's family where there are Mamba2
    layers), the captured decode step against ``eager()`` (logits and
    every cache bit-equal), and request 0's served logits against a
    bfloat16 ``forward`` of the same tokens within ``tol``; a forward
    without the causal mask must fall outside it if ``hold_unmasked``
    (else it is reported), and peak memory is reported beside the
    prediction."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.common import cast_params, dtype_of

    cfg = M.get_config(arch).with_overrides(**over)
    total = torch.cuda.get_device_properties(dev).total_memory
    shapes = T.init_params(cfg, None, device="meta")
    own = {id(t) for t in shapes.parameters()}
    param_bytes = tensor_bytes(list(shapes.parameters()))
    cast_bytes = tensor_bytes([t for t in tree_leaves(cast_params(
        shapes, dtype_of(cfg.dtype))) if id(t) not in own])
    kv = cache_bytes(cfg, SERVE_SLOTS, SERVE_MAX)
    predicted = param_bytes + cast_bytes + kv + cache_bytes(cfg, 1, SERVE_MAX)
    del shapes
    log(f"{tag} (c) {arch}: predicted peak {predicted / 2**30:.2f} GiB "
        f"({cfg.param_dtype} parameters {param_bytes / 2**30:.2f} GiB, their "
        f"{cfg.dtype} copies {cast_bytes / 2**30:.2f} GiB, {SERVE_SLOTS}-slot "
        f"caches {kv / 2**30:.3f} GiB, one prefill's cache, before "
        f"temporaries) of the card's {total / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    log(f"{tag} (c) {arch}: {cfg.num_layers} layers ({attention_layers(cfg)} "
        f"attention, {len(mamba_layers(cfg))} Mamba2, {moe_layers(cfg)} MoE: "
        f"{cfg.num_experts} experts top-{cfg.top_k}, {cfg.num_shared_experts} "
        f"shared, d_ff {cfg.moe_d_ff}), d_model {cfg.d_model}, vocab "
        f"{cfg.padded_vocab_size}; {n_params} {cfg.param_dtype} parameters "
        f"made on the card in {t_init:.2f} s")
    run, served, batcher = serve_traffic(cfg, params, prompts, card, f"{tag} (c)")
    expect_serving_launches(run["launches"], cfg, SERVE_REQUESTS,
                            run["decode_steps"], f"{tag} (c) serving")
    toks = served_tokens(prompts[0], batcher.outputs[0], dev)
    fa = None
    if attention_layers(cfg):
        tok0 = torch.as_tensor(prompts[0][None, :], device=dev)
        seen = capture_flash(lambda: T.prefill(cfg, params, {"tokens": tok0},
                                               max_len=SERVE_MAX),
                             attention_layers(cfg))
        fa = hold_flash_launches(seen[:2], card, "flash_attention_wgmma")
        del seen
    spans = (SSD_SPAN,) if mamba_layers(cfg) else ()
    with ssd_spans():
        prof = profile_serving(batcher, prompts, f"{tag} (c)", spans)
        programs = compare_decode(batcher, card, f"{tag} (c)", spans)
    del batcher
    got = torch.stack(served).float().cpu()
    want = forward_logits(cfg, params, toks, fa_kernel.flash_attention)
    err = rel_rms(got, want)
    leak = (rel_rms(forward_logits(cfg, params, toks, unmasked_attention), want)
            if attention_layers(cfg) else None)
    rec = {"arch": arch, "layers": cfg.num_layers, "params": n_params,
           "init_s": t_init, "predicted_peak_bytes": predicted,
           "card_bytes": total, **run, "flash": fa, "profile": prof,
           "programs": programs,
           "served_vs_forward_rel_rms_max": float(err.max()),
           "served_vs_forward_rel_rms": err.tolist(),
           "unmasked_rel_rms_max": None if leak is None else float(leak.max()),
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "tol": tol}
    log(f"{tag} (c) served logits of request 0 (prefill + {SERVE_GEN - 1} decode "
        f"steps) against the bfloat16 forward of the same tokens: relative RMS "
        f"max {rec['served_vs_forward_rel_rms_max']:.5f} (tolerance {tol}), "
        f"argmax agrees at {rec['argmax_agree']}/{SERVE_GEN}"
        + ("" if leak is None else
           f"; with the causal mask dropped: {rec['unmasked_rel_rms_max']:.5f}")
        + f"; peak {run['peak_mem_bytes'] / 2**30:.2f} GiB against the predicted "
        f"{predicted / 2**30:.2f}; card {card}")
    if not rec["served_vs_forward_rel_rms_max"] <= tol:
        raise AssertionError(f"{tag} served logits differ from the bfloat16 "
                             f"forward: {rec['served_vs_forward_rel_rms_max']}")
    if hold_unmasked and not rec["unmasked_rel_rms_max"] > tol:
        raise AssertionError(f"{tag} a forward without the causal mask stays "
                             f"within the tolerance: the check cannot see it")
    del params
    return rec


def run_moe_serving(card: str, dev) -> dict:
    """Phase 18, for each MoE configuration in turn, the card freed
    between them: (a) the depth-cut float32 check model, (b) one MoE
    layer against its plain version, (c) the full-depth model."""
    out = {}
    t_phase = time.perf_counter()
    for arch, tag, check_layers, check_tol, serve_tol in MOE_SERVE:
        t0 = time.perf_counter()
        check, cfg, params = moe_check_model(arch, tag, check_layers, check_tol,
                                             card, dev)
        layer = moe_layer_check(cfg, params, tag, card, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        full = serve_full_model(arch, tag, {"param_dtype": "bfloat16"},
                                serve_tol, card, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = {"check": check, "layer": layer, "serve": full,
                     "seconds": time.perf_counter() - t0}
        log(f"{tag} {arch}: phase 18 in {out[arch]['seconds']:.2f} s; card {card}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 19: the SSM and hybrid serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ssd_spans():
    """While entered, ``ssm._ssd_chunked`` and ``ssm._ssd_step`` run inside
    a ``record_function(SSD_SPAN)`` range (for ``profile_call``'s
    ``spans``).  Only eager calls see it; a graph replay runs no Python."""
    from repro_torch.models import ssm

    own = {name: getattr(ssm, name) for name in ("_ssd_chunked", "_ssd_step")}

    def spanned(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(SSD_SPAN):
                return fn(*args, **kw)
        return call

    for name, fn in own.items():
        setattr(ssm, name, spanned(fn))
    try:
        yield
    finally:
        for name, fn in own.items():
            setattr(ssm, name, fn)


def naive_ssd(x, dt, A, B, C):
    """The sequential recurrence (``tests/test_ssm.py::_naive_ssd``) in
    float64 on the tensors' device: state_t = exp(dt_t A) state_{t-1} +
    dt_t B_t x_t, y_t = C_t · state_t.  Returns (y, final state)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    x, dt, A = x.double(), dt.double(), A.double()
    Bh = B.double().repeat_interleave(rep, dim=2)
    Ch = C.double().repeat_interleave(rep, dim=2)
    state = torch.zeros((b, h, p, B.shape[3]), dtype=torch.float64,
                        device=x.device)
    ys = torch.empty((b, s, h, p), dtype=torch.float64, device=x.device)
    for t in range(s):
        da = torch.exp(dt[:, t] * A)
        bx = (x[:, t] * dt[:, t, :, None])[..., None] * Bh[:, t, :, None, :]
        state = state * da[..., None, None] + bx
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


def flat_rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """rel_rms over all elements at once."""
    return float(rel_rms(a.reshape(1, -1), b.reshape(1, -1))[0])


def ssd_bound(x, B, chunk: int) -> dict:
    """Least time for one chunked SSD: the FLOP of its four contractions
    as the function computes them, per head (C·Bᵀ over n, that times X over
    s, the chunk-end states, the inter-chunk output; 2 FLOP a
    multiply-add), at the float32 CUDA-core rate; or its bytes (x, dt, A,
    B, C read once, y and the final state written once) over the HBM rate."""
    b, s, h, p = x.shape
    n = B.shape[3]
    cl = min(chunk, s)
    nc = s // cl
    flop = 2.0 * b * nc * h * (cl * cl * n + cl * cl * p + 2 * cl * p * n)
    nbytes = (2 * x.numel() * x.element_size() + b * s * h * 4 + h * 4
              + 2 * B.numel() * B.element_size() + b * h * p * n * 4)
    t_ops = 1e3 * flop / PEAK_FLOP_S[torch.float32]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes}


def bytes_bound(nbytes: float) -> dict:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes}


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree (a parameter tree too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    values = tree.values() if hasattr(tree, "values") else tree
    return [t for v in values for t in tree_leaves(v)]


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def teacher_forced(cfg, params, prompt, outs, dev, drop_history=False):
    """Request 0 through a one-slot ``ContinuousBatcher`` fed the served
    tokens ``outs`` (teacher forcing), as it is configured and compiled at
    the call.  Returns (its prefill's logit row, then each decode step's,
    on the host; the batcher's caches at the end).  ``drop_history``
    zeroes every Mamba2 layer's SSM state after the prefill, before the
    first decode step."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    rows, prefill_fn = [], T.prefill

    def prefill_capture(*args, **kw):
        logits, caches = prefill_fn(*args, **kw)
        rows.append(logits[0, -1].float().cpu())
        return logits, caches

    T.prefill = prefill_capture
    try:
        batcher = serve.ContinuousBatcher(cfg, params, 1,
                                          SERVE_PROMPT + SERVE_GEN)
        batcher.admit(0, prompt)
    finally:
        T.prefill = prefill_fn
    if drop_history:
        for L in mamba_layers(cfg):
            batcher.caches[L]["ssm"].zero_()
    decode_fn = batcher._decode

    def decode_capture(toks, pos):
        logits, caches = decode_fn(toks, pos)
        rows.append(logits[0, 0].float().cpu())
        return logits, caches

    batcher._decode = decode_capture
    for i in range(SERVE_GEN - 1):
        batcher.outputs[0] = list(outs[:i + 1])
        batcher.step()
    return torch.stack(rows), batcher.caches


def state_rel_rms(cfg, caches, want) -> float:
    """The largest relative RMS over the Mamba2 layers of slot 0's SSM
    state in ``caches`` against ``want``'s."""
    return max(flat_rel_rms(caches[L]["ssm"][:1], want[L]["ssm"][:1])
               for L in mamba_layers(cfg))


def ssm_check_model(arch: str, tag: str, over: dict, tol: float, card: str,
                    dev) -> tuple:
    """Phase 19 (a): ``arch`` at full width, cut by ``over``, float32
    parameters from a seeded generator, one request (2048-token prompt, 32
    tokens) served through ``ContinuousBatcher`` in bfloat16: its served
    logits against the float32 ``forward`` (the plain attention and the
    plain grouped SwiGLU), and a forward without the causal mask (jamba);
    then the same tokens served (teacher-forced, eager, the plain grouped
    SwiGLU) with float32 activations, and again with the prompt's SSM
    states zeroed before the first decode step; slot 0's SSM states after
    each run against the float32 chunked prefill's over the same tokens.
    ``hold_ssm_check`` holds the result.  Returns (record, cfg, params)."""
    from repro_torch import compile as programs
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = M.get_config(arch).with_overrides(**over)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
    run, served, batcher = serve_traffic(cfg, params, [prompt], card,
                                         f"{tag} (a)", slots=1,
                                         max_len=SERVE_PROMPT + SERVE_GEN)
    expect_serving_launches(run["launches"], cfg, 1, run["decode_steps"],
                            f"{tag} (a) serving")
    outs = list(batcher.outputs[0])
    toks = served_tokens(prompt, outs, dev)
    served_caches = batcher.caches
    del batcher
    got = torch.stack(served).float().cpu()
    cfg32 = cfg.with_overrides(dtype="float32")
    want = forward_logits(cfg32, params, toks, fa_ref.mha_reference,
                          ffn.grouped_swiglu_loop)
    err = rel_rms(got, want)
    fwd_bf16 = rel_rms(forward_logits(cfg, params, toks,
                                      fa_kernel.flash_attention), want)
    dropped = rel_rms(teacher_forced(cfg, params, prompt, outs, dev,
                                     drop_history=True)[0], want)
    leak = leak32 = None
    if attention_layers(cfg):
        leak = rel_rms(forward_logits(cfg, params, toks, unmasked_attention),
                       want)
        leak32 = rel_rms(forward_logits(cfg32, params, toks, unmasked_attention,
                                        ffn.grouped_swiglu_loop), want)
    own = ffn.grouped_swiglu
    ffn.grouped_swiglu = ffn.grouped_swiglu_loop
    reset_launches()
    try:
        with programs.eager():
            rows32, caches32 = teacher_forced(cfg32, params, prompt, outs, dev)
            rows0, caches0 = teacher_forced(cfg32, params, prompt, outs, dev,
                                            drop_history=True)
            # The SSM states after the served tokens, from the float32
            # chunked prefill over all of them (a chunk that divides their
            # count: the SSD does not depend on it).
            n = toks.shape[1]
            chunk = max(d for d in range(1, cfg.ssm_chunk + 1) if n % d == 0)
            _, want_states = T.prefill(cfg32.with_overrides(ssm_chunk=chunk),
                                       params, {"tokens": toks}, max_len=n)
    finally:
        ffn.grouped_swiglu = own
    launches32 = read_launches()
    err32, dropped32 = rel_rms(rows32, want), rel_rms(rows0, want)
    states = {"bf16_served": state_rel_rms(cfg, served_caches, want_states),
              "f32_served": state_rel_rms(cfg, caches32, want_states),
              "f32_history_dropped": state_rel_rms(cfg, caches0, want_states),
              "reference_chunk": chunk}
    del served_caches, caches32, caches0, want_states
    rec = {"layers": cfg.num_layers, "experts": cfg.num_experts,
           "params": n_params, "serve": run,
           "served_rel_rms_max": float(err.max()), "served_rel_rms": err.tolist(),
           "served_max_abs": float((got - want).abs().max()),
           "ref_logit_rms": float(want.pow(2).mean().sqrt()),
           "bf16_forward_rel_rms_max": float(fwd_bf16.max()),
           "history_dropped_bf16_rel_rms": dropped.tolist(),
           "unmasked_rel_rms_min": None if leak is None else float(leak.min()),
           "unmasked_rel_rms_max": None if leak is None else float(leak.max()),
           "f32_unmasked_rel_rms_max": (None if leak32 is None
                                        else float(leak32.max())),
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "f32_served_rel_rms": err32.tolist(),
           "f32_served_rel_rms_max": float(err32.max()),
           "f32_history_dropped_rel_rms": dropped32.tolist(),
           "f32_history_dropped_rel_rms_max": float(dropped32.max()),
           "ssm_state_rel_rms": states,
           "f32_launches": launches32, "tol": tol, "f32_tol": SSM_F32_RTOL}
    log(f"{tag} (a) {arch} at full width, {cfg.num_layers} layers, "
        f"{cfg.num_experts} experts, {n_params} float32 parameters: served "
        f"logits (bfloat16; prefill + {SERVE_GEN - 1} decode steps) against "
        f"the float32 forward: relative RMS error max "
        f"{rec['served_rel_rms_max']:.5f} (tolerance {tol}), max abs "
        f"{rec['served_max_abs']:.5f} at logit RMS {rec['ref_logit_rms']:.4f}, "
        f"argmax agrees at {rec['argmax_agree']}/{SERVE_GEN}; the bfloat16 "
        f"forward: {rec['bf16_forward_rel_rms_max']:.5f}; the prompt's SSM "
        f"states zeroed: {float(dropped[1:].min()):.5f}-{float(dropped.max()):.5f}"
        + ("" if leak is None else
           f"; with the causal mask dropped: {rec['unmasked_rel_rms_min']:.5f}-"
           f"{rec['unmasked_rel_rms_max']:.5f}") + f"; card {card}")
    log(f"{tag} (a) the same tokens served with float32 activations (eager, "
        f"the plain grouped SwiGLU): relative RMS error max "
        f"{rec['f32_served_rel_rms_max']:.3e} (tolerance {SSM_F32_RTOL}); the "
        f"prompt's SSM states zeroed before the first decode step: decode rows "
        f"{float(dropped32[1:].min()):.3e}-{rec['f32_history_dropped_rel_rms_max']:.3e}"
        + ("" if leak32 is None else
           f"; the float32 forward without the causal mask: "
           f"{rec['f32_unmasked_rel_rms_max']:.3e}")
        + f"; launches {launch_words(launches32)}")
    log(f"{tag} (a) slot 0's SSM states after the {n} tokens against the "
        f"float32 chunked prefill over them (chunk {chunk}), largest relative "
        f"RMS over the Mamba2 layers: bfloat16 served {states['bf16_served']:.3e}"
        f", float32 served {states['f32_served']:.3e}, float32 with the prompt's "
        f"states zeroed {states['f32_history_dropped']:.3e}")
    return rec, cfg, params


def hold_ssm_check(rec: dict, tag: str) -> None:
    """Phase 19 (a)'s holds: the bfloat16-served logits within their
    tolerance; in float32 the served logits and SSM states within
    SSM_F32_RTOL, and outside it the logits and states served with the
    prompt's SSM states zeroed and jamba's forward without the causal
    mask."""
    tol, st = rec["tol"], rec["ssm_state_rel_rms"]
    if not rec["served_rel_rms_max"] <= tol:
        raise AssertionError(f"{tag} served logits differ from the float32 "
                             f"forward: relative RMS {rec['served_rel_rms_max']} > "
                             f"{tol}")
    within = {"float32-served logits": rec["f32_served_rel_rms_max"],
              "float32-served SSM states": st["f32_served"]}
    outside = {"logits served with the prompt's SSM states zeroed":
               rec["f32_history_dropped_rel_rms_max"],
               "SSM states served with the prompt's SSM states zeroed":
               st["f32_history_dropped"]}
    if rec["f32_unmasked_rel_rms_max"] is not None:
        outside["the forward without the causal mask"] = (
            rec["f32_unmasked_rel_rms_max"])
    for what, err in within.items():
        if not err <= SSM_F32_RTOL:
            raise AssertionError(f"{tag} {what} differ from the float32 "
                                 f"reference: {err} > {SSM_F32_RTOL}")
    for what, err in outside.items():
        if not err > SSM_F32_RTOL:
            raise AssertionError(f"{tag} {what} stay within {SSM_F32_RTOL} "
                                 f"({err}): the check cannot see it")


def ssm_layer_check(cfg, params, tag: str, card: str, dev) -> dict:
    """Phase 19 (b): the check model's first Mamba2 layer alone, cast to
    bfloat16, on bfloat16 inputs.  Prefill (2048 tokens): the chunked SSD on
    the inputs the layer gives it, its bfloat16 output the float32 sums
    rounded once, held against the float64 sequential recurrence within
    SSD_RTOL (y and the final state; the chunks run apart outside it),
    timed with CUDA events and profiler device time beside its bound and
    the recurrence.  Decode at SERVE_SLOTS slots: the recurrent update
    (``_ssd_step``) held against one float64 step, and it and the whole
    layer's ``mamba.decode`` timed against their byte bounds."""
    from repro_torch.models import ssm
    from repro_torch.models.common import cast_params

    L = mamba_layers(cfg)[0]
    p = cast_params(params["layers"][L]["mixer"], torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(1, SERVE_PROMPT, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    seen = {}
    own_chunked, own_step = ssm._ssd_chunked, ssm._ssd_step

    def spy_chunked(*args, **kw):
        seen["chunked"] = args
        return own_chunked(*args, **kw)

    def spy_step(*args):
        seen["step"] = tuple(a.clone() for a in args)
        return own_step(*args)

    ssm._ssd_chunked, ssm._ssd_step = spy_chunked, spy_step
    try:
        _, states = ssm.mamba.apply(cfg, p, x, None)
        cache = ssm.mamba.init_cache(cfg, SERVE_SLOTS, torch.bfloat16, dev)
        cache["ssm"].copy_(torch.randn(cache["ssm"].shape, generator=gen,
                                       device=dev) * 0.1)
        x4 = torch.randn(SERVE_SLOTS, 1, cfg.d_model, generator=gen,
                         device=dev).to(torch.bfloat16)
        ssm.mamba.decode(cfg, p, x4, cache, SERVE_PROMPT)
    finally:
        ssm._ssd_chunked, ssm._ssd_step = own_chunked, own_step
    xs, dt, A, Bm, Cm, chunk = seen["chunked"]
    y, final = own_chunked(xs, dt, A, Bm, Cm, chunk)
    y32, final32 = own_chunked(xs.float(), dt, A, Bm, Cm, chunk)
    if not (torch.equal(y, y32.to(y.dtype)) and torch.equal(final, final32)
            and torch.equal(final, states["ssm"])):
        raise AssertionError(f"{tag} (b) the bfloat16 SSD is not its float32 "
                             "sums rounded once")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y64, st64 = naive_ssd(xs, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    naive_ms = 1e3 * (time.perf_counter() - t0)
    err_y, err_st = flat_rel_rms(y32, y64), flat_rel_rms(final32, st64)
    b, s, h, hp = xs.shape
    cl = min(chunk, s)
    nc = s // cl
    apart, _ = own_chunked(
        xs.float().reshape(b * nc, cl, h, hp), dt.reshape(b * nc, cl, h), A,
        Bm.reshape(b * nc, cl, *Bm.shape[2:]), Cm.reshape(b * nc, cl, *Cm.shape[2:]),
        chunk)
    err_apart = flat_rel_rms(apart.reshape(y32.shape), y64)

    def ssd():
        own_chunked(xs, dt, A, Bm, Cm, chunk)

    ms = device_ms_per_call([ssd])
    event_ms = time_cuda(ssd, 10)
    prof = profile_call(ssd)
    bnd = ssd_bound(xs, Bm, chunk)
    prefill = {"tokens": SERVE_PROMPT, "chunk": cl, "chunks": nc,
               "y_rel_rms": err_y, "state_rel_rms": err_st,
               "chunks_apart_rel_rms": err_apart, "ms": ms, "event_ms": event_ms,
               "plain_ms": naive_ms, "launches_per_call": prof["launches"],
               "launch_api_calls": prof["launch_api_calls"],
               "wall_ms": prof["wall_ms"], "top": prof["top"][:8], **bnd}
    log(f"{tag} (b) one Mamba2 layer (layer {L}; h {h}, p {hp}, n "
        f"{Bm.shape[3]}) at the prefill's {SERVE_PROMPT} tokens: the chunked "
        f"SSD ({nc} chunks of {cl}) against the float64 sequential recurrence: "
        f"relative RMS y {err_y:.2e}, final state {err_st:.2e} (tolerance "
        f"{SSD_RTOL}; the chunks run apart: {err_apart:.3f}); {ms:.4f} ms device "
        f"time (events {event_ms:.4f}), {prof['launches']} kernels and "
        f"{prof['launch_api_calls']} host launch calls a call, profiled wall "
        f"{prof['wall_ms']:.2f} ms; bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}; {bnd['flop'] / 1e9:.2f} GFLOP at the float32 "
        f"CUDA-core rate); the float64 recurrence {naive_ms:.1f} ms; card {card}")
    for row in prof["top"][:6]:
        log(f"{tag} (b)   {row['ms']:9.4f} ms x{row['count']:<4d} {row['name']}")

    state, xd, dtd, Ad, Bd, Cd, Dd = seen["step"]
    got_y, got_state = own_step(state, xd, dtd, Ad, Bd, Cd, Dd)
    da = torch.exp(dtd.double() * Ad.double()[None, :])
    want_state = (state.double() * da[..., None, None]
                  + (xd.double() * dtd.double()[..., None])[..., None]
                  * Bd.double()[:, :, None, :])
    want_y = (torch.einsum("bhpn,bhn->bhp", want_state, Cd.double())
              + Dd.double()[None, :, None] * xd.double())
    step_err = max(flat_rel_rms(got_y, want_y), flat_rel_rms(got_state, want_state))
    step_bytes = 2 * tensor_bytes(state) + tensor_bytes([xd, dtd, Ad, Bd, Cd, Dd,
                                                         got_y])
    weights = tensor_bytes(p)
    layer_bytes = (step_bytes + weights + 2 * tensor_bytes(cache["conv"])
                   + 2 * tensor_bytes(x4))

    def step():
        own_step(state, xd, dtd, Ad, Bd, Cd, Dd)

    def layer():
        ssm.mamba.decode(cfg, p, x4, cache, SERVE_PROMPT)

    decode = {"slots": SERVE_SLOTS, "step_rel_rms": step_err,
              "step_ms": device_ms_per_call([step]),
              "step_event_ms": time_cuda(step, 20),
              "layer_ms": device_ms_per_call([layer]),
              "layer_event_ms": time_cuda(layer, 20),
              "layer_launches_per_call": profile_call(layer)["launches"],
              "step_bound": bytes_bound(step_bytes),
              "layer_bound": bytes_bound(layer_bytes), "weight_bytes": weights}
    log(f"{tag} (b) decode at {SERVE_SLOTS} slots: the recurrent update "
        f"(_ssd_step) within {step_err:.2e} of one float64 step; "
        f"{decode['step_ms']:.4f} ms device time (events "
        f"{decode['step_event_ms']:.4f}) against a byte bound of "
        f"{decode['step_bound']['bound_ms']:.4f} ms (the float32 state "
        f"{tensor_bytes(state) / 1e6:.2f} MB read and written); the whole "
        f"layer's decode {decode['layer_ms']:.4f} ms (events "
        f"{decode['layer_event_ms']:.4f}, {decode['layer_launches_per_call']} "
        f"kernels) against {decode['layer_bound']['bound_ms']:.4f} ms (its "
        f"{weights / 1e6:.1f} MB of weights too); card {card}")
    if not max(err_y, err_st) <= SSD_RTOL:
        raise AssertionError(f"{tag} (b) the SSD differs from the float64 "
                             f"recurrence: y {err_y}, state {err_st}")
    if not err_apart > SSD_RTOL:
        raise AssertionError(f"{tag} (b) the chunks run apart stay within the "
                             "tolerance: the check cannot see a dropped history")
    if not step_err <= SSD_RTOL:
        raise AssertionError(f"{tag} (b) the recurrent step differs from float64: "
                             f"{step_err}")
    return {"layer": L, "prefill": prefill, "decode": decode}


def run_ssm_serving(card: str, dev) -> dict:
    """Phase 19, for each SSM configuration in turn, the card freed
    between them: (a) the float32 check model, (b) one Mamba2 layer
    against its plain version, (c) the served model with phase 11's
    traffic."""
    out = {}
    t_phase = time.perf_counter()
    for arch, tag, check_over, serve_over, check_tol, serve_tol in SSM_SERVE:
        t0 = time.perf_counter()
        check, cfg, params = ssm_check_model(arch, tag, check_over, check_tol,
                                             card, dev)
        hold_ssm_check(check, tag)
        layer = ssm_layer_check(cfg, params, tag, card, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # In bfloat16 the unmasked forward stays within the policy's error
        # here (SSM_SERVE): reported; (a) holds it in float32.
        full = serve_full_model(arch, tag, serve_over, serve_tol, card, dev,
                                hold_unmasked=False)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = {"check": check, "layer": layer, "serve": full,
                     "seconds": time.perf_counter() - t0}
        log(f"{tag} {arch}: phase 19 in {out[arch]['seconds']:.2f} s; card {card}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 6: end-to-end timing
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 17: the paper's application (the ad-hoc scoring API, synthetic
# data with a known MI, AugmentedTabularPipeline and the taxi example)
# ---------------------------------------------------------------------------

def median_call_s(fn, reps: int = ADHOC_REPS) -> tuple[float, list]:
    """Median wall seconds of ``reps`` warm calls of ``fn``, each ended
    by a synchronize (after one call that is not timed)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def spy_radius_counts(fn) -> tuple[object, list]:
    """``fn()`` with ``radius_counts``' Python call wrapped, as in
    ``capture_launches``, to keep each launch's inputs, arguments and
    outputs; returns (fn's result, the launches)."""
    from types import SimpleNamespace

    from repro_torch.kernels.knn_stats import kernel, ops

    seen = []

    def spy(x, y, mask, **args):
        out = kernel.radius_counts(x, y, mask, **args)
        seen.append((x.clone(), y.clone(), mask.clone(), args,
                     tuple(o.clone() for o in out)))
        return out

    ops.kernel = SimpleNamespace(radius_counts=spy)
    try:
        out = fn()
    finally:
        ops.kernel = kernel
    torch.cuda.synchronize()
    return out, seen


def launch_words(launches: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none"


def run_adhoc(index, sks, warm_first, card: str) -> dict:
    """Phase 17 (a): ``stacked`` and ``score_batch`` over the whole lake for
    the first continuous- and discrete-target query; the top ``TOP_K`` at
    ``MIN_JOIN`` as phase 3's warm ``query_many`` (MI within 1e-6);
    ``score_batch_partitioned``, the batched executor's dense scores and
    ``query_many(executor="batched", prefilter=False)`` bit-equal to
    ``score_batch``; medians of ``ADHOC_REPS`` warm calls each."""
    from repro_torch.core.discovery import (
        BatchedExecutor,
        score_batch,
        score_batch_partitioned,
    )

    C = len(index)
    t0 = time.perf_counter()
    stacked = {y_disc: index.stacked(y_disc) for y_disc in (False, True)}
    torch.cuda.synchronize()
    t_stack = time.perf_counter() - t0
    log(f"[adhoc] stacked() of C={C} candidates x 2 target dtypes (the stacked "
        f"store's first flush): {t_stack:.3f} s; ingest {index.ingest_stats}")
    out = {"stacked_s": t_stack, "dtypes": {}}
    for sk, warm_res in zip(sks, warm_first):
        y_disc = bool(sk.value_is_discrete)
        name = "discrete" if y_disc else "continuous"
        train, cands = index.train_arrays(sk), stacked[y_disc]
        est = sorted(set(cands["est_id"].tolist()))
        reset_launches()
        mi, js = score_batch(train, cands)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches["radius_counts"] == 0:
            raise AssertionError(f"score_batch ({name}) launched no radius_counts")
        mi_h, js_h = mi.cpu().numpy(), js.cpu().numpy()
        if not np.isfinite(mi_h).all():
            raise AssertionError(f"score_batch ({name}) gave a non-finite MI")
        ranked = index._rank(mi_h, np.arange(C), js_h, TOP_K, MIN_JOIN)
        same_rankings([ranked], [warm_res], tol=MI_TOL)
        part = score_batch_partitioned(train, cands)
        dense = BatchedExecutor().execute(index.plan(y_disc), train)
        qm = index.query_many([sk], top_k=TOP_K, min_join=MIN_JOIN,
                              executor="batched", prefilter=False)[0]
        if not (torch.equal(part[0], mi) and torch.equal(part[1], js)):
            raise AssertionError(f"score_batch_partitioned ({name}) differs from "
                                 "score_batch")
        if not (np.array_equal(dense[0][0], mi_h) and np.array_equal(dense[1][0], js_h)):
            raise AssertionError(f"the batched executor's dense scores ({name}) "
                                 "differ from score_batch")
        if flat_results([qm]) != flat_results([ranked]):
            raise AssertionError(f"query_many(executor='batched') ({name}) differs "
                                 "from score_batch")
        times = {
            "score_batch": median_call_s(lambda: score_batch(train, cands)),
            "score_batch_partitioned": median_call_s(
                lambda: score_batch_partitioned(train, cands)),
            "query_many_executor_batched": median_call_s(
                lambda: index.query_many([sk], top_k=TOP_K, min_join=MIN_JOIN,
                                         executor="batched", prefilter=False)),
        }
        log(f"[adhoc] {name} q0 over C={C} (est_id {est}): score_batch's top "
            f"{TOP_K} at min_join={MIN_JOIN} == phase 3's warm query_many (MI within "
            f"{MI_TOL}); score_batch_partitioned, the batched executor and "
            f"query_many(executor='batched', prefilter=False) bit-equal to "
            f"score_batch; launches: {launch_words(launches)}")
        log(f"[adhoc] {name} warm medians of {ADHOC_REPS}: "
            + ", ".join(f"{k} {1e3 * v[0]:.2f} ms" for k, v in times.items())
            + f"; card {card}")
        prof = profile_call(lambda: score_batch(train, cands))
        log(f"[adhoc] profiled {name} score_batch: wall {prof['wall_ms']:.2f} ms, "
            f"device {prof['device_ms']:.2f} ms (busy {prof['busy_share'] or 0:.2f}), "
            f"{prof['launches']} kernels; by family: "
            + ", ".join(f"{k} {v['ms']:.2f}" for k, v in prof["kinds"].items()))
        out["dtypes"][name] = {"est_ids": est, "launches": launches,
                               "median_s": {k: v[0] for k, v in times.items()},
                               "times_s": {k: v[1] for k, v in times.items()},
                               "profile": prof, "mi": mi, "js": js}
    return out


def run_adhoc_reference(index, sks, adhoc: dict, card: str) -> dict:
    """Phase 17 (b): ``score_batch_reference`` (the materialized estimators)
    on the same stacked lake: join sizes equal to (a)'s, MI within 1e-5,
    ``pairwise_cheb`` launched; its time beside (a)'s.  A first call over
    ``ADHOC_REF_SLOW_S`` cuts the lake to its first ``ADHOC_REF_CUT``
    columns."""
    from repro_torch.core.discovery import score_batch_reference

    out = {}
    for sk in sks:
        y_disc = bool(sk.value_is_discrete)
        name = "discrete" if y_disc else "continuous"
        a = adhoc["dtypes"][name]
        train, cands = index.train_arrays(sk), index.stacked(y_disc)
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        mi, js = score_batch_reference(train, cands)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
        C = len(index)
        if first_s > ADHOC_REF_SLOW_S:
            C = ADHOC_REF_CUT
            log(f"[adhoc] cut: score_batch_reference took {first_s:.1f} s over the "
                f"whole lake; held and timed on its first {C} columns")
            cands = {k: v[:C] for k, v in cands.items()}
            reset_launches()
            mi, js = score_batch_reference(train, cands)
            torch.cuda.synchronize()
            launches = read_launches()
        if launches["pairwise_cheb"] == 0:
            raise AssertionError(f"score_batch_reference ({name}) launched no "
                                 "pairwise_cheb")
        if not torch.equal(js, a["js"][:C]):
            raise AssertionError(f"score_batch_reference ({name}) join sizes differ "
                                 "from score_batch")
        err = float((mi - a["mi"][:C]).abs().max())
        if not torch.allclose(mi, a["mi"][:C], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"score_batch_reference ({name}) MI differs from "
                                 f"score_batch by {err}")
        med, times = median_call_s(lambda: score_batch_reference(train, cands), 3)
        fused = a["median_s"]["score_batch"]
        log(f"[adhoc] {name} score_batch_reference over C={C}: join sizes == (a), "
            f"MI within 1e-5 (max |diff| {err:.3g}); launches: "
            f"{launch_words(launches)}; first call {first_s:.3f} s, warm median of 3 "
            f"{1e3 * med:.2f} ms against score_batch's {1e3 * fused:.2f} ms over "
            f"C={len(index)} (the seed path's time / the fused path's: "
            f"{med / fused:.2f}x, reported, not claimed); card {card}")
        out[name] = {"C": C, "launches": launches, "first_s": first_s,
                     "median_s": med, "times_s": times, "max_abs_diff": err}
    return out


def run_adhoc_subcorpus(gpu_sub, cpu_sub, sks, rows, keys, y, card: str) -> dict:
    """Phase 17 (c): the phase-4 sub-corpus on the card against the port's
    CPU path: ``score_batch`` and ``score_batch_reference`` (join sizes
    equal, MI within rtol/atol 1e-5), then ``AugmentedTabularPipeline``
    (top_k=8, min_join=24): feature names (table and column) equal and in
    order, the ranking MI within 1e-5, feature matrices bit-equal."""
    from repro_torch.core.discovery import score_batch, score_batch_reference
    from repro_torch.core.sketch import build_sketch
    from repro_torch.data.pipeline import AugmentedTabularPipeline

    reset_launches()
    for sk in sks:
        name = "discrete" if sk.value_is_discrete else "continuous"
        for fn in (score_batch, score_batch_reference):
            got, want = (fn(ix.train_arrays(sk), ix.stacked(sk.value_is_discrete))
                         for ix in (gpu_sub, cpu_sub))
            if not torch.equal(got[1].cpu(), want[1]):
                raise AssertionError(f"{fn.__name__} ({name}): card join sizes "
                                     "differ from the CPU path")
            if not torch.allclose(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{fn.__name__} ({name}): card MI differs "
                                     "from the CPU path")
    tables = {(r[0], r[2]): (r[3], r[4]) for r in rows[:len(cpu_sub)]}
    t0 = time.perf_counter()
    built = {}
    for dev, ix in (("cuda", gpu_sub), ("cpu", cpu_sub)):
        pipe = AugmentedTabularPipeline(index=ix, tables=tables, top_k=8,
                                        min_join=MIN_JOIN)
        built[dev] = pipe.build(keys, y)
    t_pipe = time.perf_counter() - t0
    launches = read_launches()
    (xg, ng), (xc, nc) = built["cuda"], built["cpu"]
    cols_g = [n.split("|mi=")[0] for n in ng]
    if cols_g != [n.split("|mi=")[0] for n in nc] or not cols_g:
        raise AssertionError(f"pipeline features differ: {ng} vs {nc}")
    sk = build_sketch(keys, y, n=N_SKETCH, side="train", value_is_discrete=False)
    same_rankings([gpu_sub.query(sk, top_k=8, min_join=MIN_JOIN)],
                  [cpu_sub.query(sk, top_k=8, min_join=MIN_JOIN)])
    if not np.array_equal(xg, xc):
        raise AssertionError("pipeline feature matrices differ between the card "
                             "and the CPU path")
    log(f"[augment] C={len(cpu_sub)} sub-corpus: score_batch and "
        f"score_batch_reference, card == CPU path (join sizes; MI within 1e-5); "
        f"AugmentedTabularPipeline(top_k=8, min_join={MIN_JOIN}) features "
        f"{cols_g} equal, ranking MI within 1e-5, feature matrix {xg.shape} "
        f"bit-equal; both builds {t_pipe:.3f} s; launches: "
        f"{launch_words(launches)}; card {card}")
    return {"features": ng, "launches": launches, "pipeline_s": t_pipe}


def quiet(fn, *args, **kwargs):
    """``fn``'s result and its printed lines."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def synthetic_case(case: str, trial: int):
    """One generated pair of phase 17 (d), decomposed: (true MI, train
    dict, candidate dict, x discrete, y discrete)."""
    from repro_torch.core import synthetic

    rng = np.random.default_rng([SEED, SYN_CASES.index(case), trial])
    if case == "cdunif-dcksg":
        pair = synthetic.gen_cdunif(SYN_ROWS, 64, rng)
        train, cand = synthetic.decompose(pair, "keyind", rng)
        return pair.true_mi, train, cand, True, False
    pair = synthetic.gen_trinomial(SYN_ROWS, 512, rng.uniform(0.5, 2.5), rng)
    train, cand = synthetic.decompose(pair, "keyind", rng)
    # The paper's tie-breaking perturbation of both discrete sides
    # (benchmarks/common.py, _PERTURB = 1e-3), so MixedKSG applies.
    for d in (train, cand):
        d["values"] = (d["values"] + rng.normal(scale=SYN_PERTURB, size=SYN_ROWS)
                       ).astype(np.float32)
    return pair.true_mi, train, cand, False, False


def synthetic_estimates(case: str, trial: int, dev) -> dict:
    """The TUPSK n=256 sketch join's and the full join's estimate of one
    generated pair on ``dev``."""
    from repro_torch.core.estimators import estimate_mi
    from repro_torch.core.join import full_left_join, sketch_join
    from repro_torch.core.sketch import build_sketch

    true_mi, train, cand, x_disc, y_disc = synthetic_case(case, trial)
    st = build_sketch(train["key_hashes"], train["values"], n=N_SKETCH,
                      side="train", value_is_discrete=y_disc)
    sc = build_sketch(cand["key_hashes"], cand["values"], n=N_SKETCH,
                      side="cand", value_is_discrete=x_disc)
    out = {"true_mi": true_mi}
    for name, j in (("sketch", sketch_join(st, sc)),
                    ("full", full_left_join(train["key_hashes"], train["values"],
                                            cand["key_hashes"], cand["values"]))):
        args = [torch.as_tensor(a, device=dev)[None] for a in (j.x, j.y, j.mask)]
        out[name] = float(estimate_mi(*args, x_discrete=x_disc,
                                      y_discrete=y_disc)[0])
        out[f"{name}_P"] = int(args[0].shape[-1])
        out[f"{name}_size"] = j.size
    return out


def run_synthetic(card: str, dev) -> dict:
    """Phase 17 (d): the paper's synthetic data at its size.  The
    quickstart scenario (Trinomial m=512, 20,000 rows, KeyDep; MLE on the
    sketch and the full join) through ``examples/quickstart_torch.main``;
    CDUnif m=64 (KeyInd; DC-KSG) and Trinomial m=512 with both sides
    perturbed (KeyInd; MixedKSG) at 10,000 rows, ``SYN_TRIALS`` trials
    each, on the TUPSK n=256 sketch join (the staged body) and on the full
    join (P = 10,000: the tiled body).  Held: trial 0 of each case on the
    card within rtol/atol 1e-5 of the port's CPU path, the tiled body
    reached and each launch of trial 0 bit-equal to the plain version (and
    timed there with its bound).  Printed, not held: true MI, estimates,
    errors and RMSE beside the paper's V-B1 claim."""
    import quickstart_torch

    t0 = time.perf_counter()
    reset_launches()
    qs, lines = quiet(quickstart_torch.main, str(dev), seed=SEED)
    qs_cpu, _ = quiet(quickstart_torch.main, "cpu", seed=SEED)
    for line in lines:
        log(f"[synthetic] quickstart: {line}")
    if qs["true_mi"] != qs_cpu["true_mi"] or \
            (qs["sketch_join_size"], qs["full_join_size"]) != \
            (qs_cpu["sketch_join_size"], qs_cpu["full_join_size"]):
        raise AssertionError(f"quickstart: card {qs} vs CPU {qs_cpu}")
    for key in ("sketch_mi", "full_mi"):
        if not np.isclose(qs[key], qs_cpu[key], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"quickstart {key}: card {qs[key]} vs CPU "
                                 f"{qs_cpu[key]}")
    out = {"quickstart": qs, "cases": {}}
    captured = {}
    for case in SYN_CASES:
        trials = []
        for trial in range(SYN_TRIALS):
            if trial == 0:
                est, captured[case] = spy_radius_counts(
                    lambda: synthetic_estimates(case, 0, dev))
                cpu = synthetic_estimates(case, 0, "cpu")
                for key in ("sketch", "full"):
                    if not np.isclose(est[key], cpu[key], rtol=1e-5, atol=1e-5):
                        raise AssertionError(f"{case} {key} join: card {est[key]} "
                                             f"vs CPU {cpu[key]}")
            else:
                est = synthetic_estimates(case, trial, dev)
            trials.append(est)
        out["cases"][case] = {"trials": trials}
    launches = read_launches()
    n_joins = len(SYN_CASES) * SYN_TRIALS
    if (launches["radius_counts_staged"], launches["radius_counts_tiled"]) != \
            (n_joins, n_joins):
        raise AssertionError(f"phase 17 (d) launched {launches}; expected one "
                             f"staged (sketch join) and one tiled (full join) "
                             f"launch for each of the {n_joins} pairs")
    log(f"[synthetic] quickstart card == CPU path within 1e-5; phase 17 (d) "
        f"launches: {launch_words(launches)}; {time.perf_counter() - t0:.2f} s")
    for case, res in out["cases"].items():
        trials = res["trials"]
        # check_main_launches names each launch's body by kernel.takes_staged.
        rows = check_main_launches(captured[case], card)
        bodies = [(r["P"], r["body"]) for r in rows]
        if bodies != [(N_SKETCH, "staged"), (SYN_ROWS, "tiled")]:
            raise AssertionError(f"{case} trial 0 launched {bodies}; expected the "
                                 "sketch join on the staged body and the full "
                                 "join on the tiled one")
        rmse = {key: float(np.sqrt(np.mean([(t[key] - t["true_mi"]) ** 2
                                            for t in trials])))
                for key in ("sketch", "full")}
        for i, t in enumerate(trials):
            log(f"[synthetic] {case} trial {i}: true MI {t['true_mi']:.4f}; sketch "
                f"join ({t['sketch_size']} rows) {t['sketch']:.4f} (error "
                f"{t['sketch'] - t['true_mi']:+.4f}); full join ({t['full_size']} "
                f"rows) {t['full']:.4f} (error {t['full'] - t['true_mi']:+.4f})")
        log(f"[synthetic] {case}: RMSE over {SYN_TRIALS} trials, sketch join "
            f"{rmse['sketch']:.4f}, full join {rmse['full']:.4f} (paper V-B1: full "
            f"join RMSE < 0.07; reported, not held); trial 0 card == CPU path "
            f"within 1e-5")
        res.update(rmse=rmse, launches=rows)
    tiled = [r for c in out["cases"].values() for r in c["launches"]
             if r["body"] == "tiled"]
    log(f"[time] radius_counts_tiled at P={tiled[0]['P']} (the full joins, "
        f"{len(tiled)} captured launches): "
        + "; ".join(f"{r['mode']}/{r['which']} {r['ms']:.4f} ms events, "
                    f"{r['device_ms']:.4f} ms device, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}, {100 * r['bound_share']:.1f}%), plain "
                    f"{r['plain_ms']:.4f} ms" for r in tiled)
        + f"; card {card}")
    out["launches"] = launches
    out["tiled_rows"] = tiled
    out["seconds"] = time.perf_counter() - t0
    return out


def run_taxi(card: str, dev) -> dict:
    """Phase 17 (e): ``examples/taxi_demand_augmentation_torch.main("cuda")``
    at the example's own size (400 days x 60 zones, 14 tables, n=512,
    agg="avg"): ``demographics.population`` and a weather column among the
    discovered features, and a lower test MAE with the augmentation."""
    import taxi_demand_augmentation_torch as taxi

    t0 = time.perf_counter()
    reset_launches()
    res, lines = quiet(taxi.main, str(dev))
    launches = read_launches()
    seconds = time.perf_counter() - t0
    for line in lines:
        if line.strip():
            log(f"[augment] taxi: {line.strip()}")
    cols = [n.split("|mi=")[0] for n in res["names"]]
    if "demographics.population" not in cols or not any(
            c.startswith("weather.") for c in cols):
        raise AssertionError(f"taxi example discovered {cols}")
    if launches["radius_counts"] == 0:
        raise AssertionError("the taxi example launched no radius_counts")
    log(f"[augment] taxi example on the card: features {cols}, test MAE "
        f"{res['mae_base']:.4f} without augmentation, {res['mae_aug']:.4f} with; "
        f"{seconds:.2f} s; launches: {launch_words(launches)}; card {card}")
    return {**res, "launches": launches, "seconds": seconds}


def run_application(index, sks, warm_first, gpu_sub, cpu_sub, rows, keys, y,
                    card: str, dev) -> dict:
    """Phase 17 (a)-(e), each with its own launch counts."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    t0 = time.perf_counter()
    adhoc = run_adhoc(index, sks, warm_first, card)
    ref = run_adhoc_reference(index, sks, adhoc, card)
    sub = run_adhoc_subcorpus(gpu_sub, cpu_sub, sks, rows, keys, y, card)
    syn = run_synthetic(card, dev)
    taxi = run_taxi(card, dev)
    for d in adhoc["dtypes"].values():  # the score tensors stay here
        del d["mi"], d["js"]
    seconds = time.perf_counter() - t0
    log(f"[adhoc] phase 17 (a)-(e): {seconds:.2f} s; card {card}")
    return {"adhoc": adhoc, "adhoc_reference": ref, "subcorpus": sub,
            "synthetic": syn, "taxi": taxi, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 20: the training path (the stubs, lm_loss, the flash kernel's
# autograd Function, int8 AdamW, the train step, checkpoints, the
# launcher)
# ---------------------------------------------------------------------------

def spanned_optimizer(opt):
    """``opt`` with its ``update`` inside a ``record_function(OPT_SPAN)``
    range (for ``profile_call``'s ``spans``)."""
    from repro_torch.train import optimizer as O

    def update(*args, **kw):
        with torch.profiler.record_function(OPT_SPAN):
            return opt.update(*args, **kw)

    return O.Optimizer(init=opt.init, update=update)


def leaf_rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative RMS of ``got`` against ``want`` over the whole tensor (the
    absolute RMS where ``want`` is 0), in float64 on ``got``'s device."""
    a = got.detach().double()
    b = want.detach().to(a.device).double()
    den = b.pow(2).mean().sqrt()
    diff = (a - b).pow(2).mean().sqrt()
    return float(diff / den) if float(den) > 0 else float(diff)


def detached_attention():
    """While entered, the models' attention output is detached: the bug
    the flash Function fixes (a ctypes launch records nothing for
    autograd), as a control."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn

    def cut(*args, **kw):
        return fa_ops.attention(*args, **kw).detach()

    return _patched(attn, "flash_attention", cut)


@contextlib.contextmanager
def _patched(module, name, value):
    own = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, own)


def check_function_grads(q, k, v, scale, causal, dtype) -> dict:
    """The flash Function on the card (inputs cast to ``dtype``): its
    forward through the kernel the dispatch rule names, and its q/k/v
    gradients against autograd through ``ref.chunked_attention`` on the
    same inputs and upstream gradient."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
    before = read_launches()
    out = fa_ops.attention(*leaves, scale=scale, causal=causal)
    after = read_launches()
    wgmma = fa_kernel.takes_wgmma(*leaves)
    name = "flash_attention_wgmma" if wgmma else "flash_attention"
    if after[name] - before[name] != 1 or type(out.grad_fn).__name__ != \
            "FlashAttentionBackward":
        raise AssertionError(f"ops.attention under grad at {dtype} did not "
                             f"launch {name} through the Function")
    g = torch.randn(out.shape, generator=torch.Generator(device=out.device)
                    .manual_seed(SEED), device=out.device).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    want_out = fa_ref.chunked_attention(*leaves, scale=scale, causal=causal)
    want = torch.autograd.grad(want_out, leaves, g)
    torch.cuda.synchronize()
    errs = [leaf_rel_rms(a, b) for a, b in zip(got, want)]
    zero = [float(a.abs().max()) == 0.0 for a in got]
    if max(errs) > TRAIN_FN_RTOL or any(zero):
        raise AssertionError(f"the flash Function's q/k/v gradients at {dtype} "
                             f"differ from autograd through the plain version "
                             f"(relative RMS {errs}) or are zero ({zero})")
    return {"dtype": str(dtype), "kernel": name, "grad_rel_rms": errs,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "shape_q": list(q.shape), "shape_k": list(k.shape)}


def decode_against_forward(cfg, params, batch: dict, dev) -> float:
    """Prefill on all but the last position and one decode step of it,
    against the forward over the whole batch (the logits of the two last
    positions), on the card: the largest relative RMS."""
    from repro_torch.models import transformer as T

    with torch.no_grad():
        full, _ = T.forward(cfg, params, batch)
        key = "frame_embeds" if cfg.modality == "audio_stub" else "tokens"
        prompt = dict(batch, **{key: batch[key][:, :-1]})
        S = full.shape[1]
        pre, caches = T.prefill(cfg, params, prompt, max_len=S)
        nxt, _ = T.decode_step(cfg, params, caches, batch[key][:, -1:], S - 1)
    return max(leaf_rel_rms(pre[:, 0], full[:, S - 2]),
               leaf_rel_rms(nxt[:, 0], full[:, S - 1]))


def train_check_model(arch: str, tag: str, card: str, dev) -> dict:
    """Phase 20 (a): one float32 train step of the 2-layer full-width
    check model on the card against the same step through the port on
    the CPU, with the controls, the flash Function's gradients and the
    stub's decode against its forward."""
    import copy

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    t_start = time.perf_counter()
    cfg = M.get_config(arch).with_overrides(
        num_layers=TRAIN_CHECK_LAYERS, dtype="float32", param_dtype="float32")
    np_batch = TokenPipeline(cfg, batch=TRAIN_CHECK_B, seq=TRAIN_CHECK_S,
                             seed=SEED).next_batch()
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                               device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(dev)
    opt = O.adamw(quantized=True)
    step = TS.build_train_step(cfg, opt, O.warmup_cosine(TRAIN_CHECK_LR, 0, 10))
    states, grads, mets, secs = {}, {}, {}, {}
    for where, params in (("cpu", cpu_params), ("gpu", gpu_params)):
        states[where] = TS.init_train_state(cfg, opt, None, params=params)
        batch = TS.batch_to_device(np_batch, params["embedding"]["table"].device)
        if where == "gpu":
            gpu_batch = batch
            reset_launches()
        t0 = time.perf_counter()
        grads[where], mets[where] = step.grads_and_metrics(params, batch)
        if where == "gpu":
            torch.cuda.synchronize()
            launches = read_launches()
        secs[where] = time.perf_counter() - t0
    want_fa = {"flash_attention_simt_regtile": 2 * TRAIN_CHECK_LAYERS}
    seen = {k: v for k, v in launches.items() if v}
    if seen != dict(want_fa, flash_attention=2 * TRAIN_CHECK_LAYERS):
        raise AssertionError(f"{tag} (a) the card's step launched {seen}; "
                             f"expected {2 * TRAIN_CHECK_LAYERS} of the "
                             "register-tiled flash body (forward and remat)")
    loss = {w: float(m["loss"]) for w, m in mets.items()}
    loss_err = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    grad_err = {n: leaf_rel_rms(grads["gpu"][n], grads["cpu"][n])
                for n in grads["cpu"]}
    worst = max(grad_err, key=grad_err.get)

    controls = {}
    with torch.no_grad():
        logits, aux = T.forward(cfg, gpu_params, gpu_batch["batch"])
        if cfg.modality == "vision_stub":
            unmasked = T.lm_loss(cfg, logits, gpu_batch["labels"]) + aux
            controls["loss_mask_ignored"] = abs(float(unmasked) - loss["gpu"]) \
                / abs(loss["gpu"])
    del logits
    if cfg.modality == "vision_stub":
        zeroed = dict(gpu_batch, batch=dict(
            gpu_batch["batch"],
            patch_embeds=torch.zeros_like(gpu_batch["batch"]["patch_embeds"])))
        g0, _ = step.grads_and_metrics(gpu_params, zeroed)
        controls["patch_proj_grad_patches_zeroed"] = leaf_rel_rms(
            g0["patch_proj.w"], grads["gpu"]["patch_proj.w"])
        del g0
    with detached_attention():
        gd, _ = step.grads_and_metrics(gpu_params, gpu_batch)
    controls["attention_detached"] = leaf_rel_rms(
        gd["layers.0.mixer.wq.w"], grads["gpu"]["layers.0.mixer.wq.w"])
    del gd
    inside = {k: v for k, v in controls.items()
              if v <= (TRAIN_LOSS_RTOL if k == "loss_mask_ignored"
                       else TRAIN_GRAD_RTOL)}
    if (loss_err > TRAIN_LOSS_RTOL or grad_err[worst] > TRAIN_GRAD_RTOL
            or inside):
        raise AssertionError(
            f"{tag} (a) card against CPU: loss {loss_err}, worst gradient "
            f"{worst} {grad_err[worst]}; controls inside the tolerance: "
            f"{inside}")

    # The flash Function on a captured launch of this model, in float32
    # (the CUDA-core kernel) and bfloat16 (the Hopper kernel at this GQA
    # group and head dim).
    with torch.no_grad():
        captured = capture_flash(
            lambda: T.forward(cfg, gpu_params, gpu_batch["batch"]),
            TRAIN_CHECK_LAYERS)
    q, k, v, scale, causal, _ = captured[0]
    fn = [check_function_grads(q, k, v, scale, causal, dt)
          for dt in (torch.float32, torch.bfloat16)]
    del captured
    decode_err = decode_against_forward(cfg, gpu_params, gpu_batch["batch"], dev)
    if decode_err > TRAIN_DECODE_RTOL:
        raise AssertionError(f"{tag} (a) prefill + decode against the forward "
                             f"on the card: {decode_err}")

    # The rest of the step: clip, schedule, int8 AdamW.
    before = {w: {n: p.detach().clone() for n, p in s.params.named_parameters()}
              for w, s in states.items()}
    after = {}
    for where in ("cpu", "gpu"):
        t0 = time.perf_counter()
        states[where], mets[where] = step.apply_gradients(
            states[where], grads[where], mets[where])
        if where == "gpu":
            torch.cuda.synchronize()
        secs[where + "_update"] = time.perf_counter() - t0
        after[where] = dict(states[where].params.named_parameters())
    del grads
    norm_err = abs(float(mets["gpu"]["grad_norm"]) - float(mets["cpu"]["grad_norm"])) \
        / float(mets["cpu"]["grad_norm"])
    update_err, code_frac, deq_err = {}, {}, {}
    for n, p in after["gpu"].items():
        update_err[n] = leaf_rel_rms(p - before["gpu"][n],
                                     after["cpu"][n] - before["cpu"][n])
        for kind, deq in (("mu", O._dequantize_signed),
                          ("nu", O._dequantize_log_unsigned)):
            mine = getattr(states["gpu"].opt_state, kind)[n]
            theirs = getattr(states["cpu"].opt_state, kind)[n]
            code_frac[(n, kind)] = float(
                (mine["q"].cpu() != theirs["q"]).double().mean())
            deq_err[(n, kind)] = leaf_rel_rms(
                deq(mine["q"], mine["s"], p.shape),
                deq(theirs["q"], theirs["s"], p.shape))
    worst_u = max(update_err, key=update_err.get)
    worst_c = max(code_frac, key=code_frac.get)
    worst_d = max(deq_err, key=deq_err.get)
    if (norm_err > TRAIN_LOSS_RTOL or update_err[worst_u] > TRAIN_UPDATE_RTOL
            or code_frac[worst_c] > TRAIN_CODE_MISMATCH
            or deq_err[worst_d] > TRAIN_DEQ_RTOL):
        raise AssertionError(
            f"{tag} (a) after the update, card against CPU: clipped norm "
            f"{norm_err}, update {worst_u} {update_err[worst_u]}, codes "
            f"{worst_c} {code_frac[worst_c]}, dequantized {worst_d} "
            f"{deq_err[worst_d]}")
    rec = {"layers": TRAIN_CHECK_LAYERS, "batch": [TRAIN_CHECK_B, TRAIN_CHECK_S],
           "loss": loss, "loss_rel_err": loss_err,
           "grad_rel_rms_max": grad_err[worst], "grad_worst_leaf": worst,
           "grad_rel_rms": grad_err, "grad_norm": {
               w: float(m["grad_norm"]) for w, m in mets.items()},
           "grad_norm_rel_err": norm_err,
           "update_rel_rms_max": update_err[worst_u], "update_worst_leaf": worst_u,
           "code_mismatch_max": code_frac[worst_c],
           "code_worst": list(worst_c), "deq_rel_rms_max": deq_err[worst_d],
           "controls": controls, "function": fn, "decode_rel_rms": decode_err,
           "launches": launches, "step_s": secs,
           "seconds": time.perf_counter() - t_start}
    fn_words = "; ".join(
        f"{f['dtype']} via {f['kernel']} {max(f['grad_rel_rms']):.2e}"
        f"{' (bit-equal)' if f['bit_equal'] else ''}" for f in fn)
    log(f"{tag} (a) {arch}, {TRAIN_CHECK_LAYERS} layers at full width, float32, "
        f"batch {TRAIN_CHECK_B} x {TRAIN_CHECK_S}: card gradients "
        f"{secs['gpu']:.2f} s + update {secs['gpu_update']:.2f} s (the CPU's "
        f"{secs['cpu']:.2f} + {secs['cpu_update']:.2f} s); loss {loss['gpu']:.6f} / CPU "
        f"{loss['cpu']:.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_RTOL}); "
        f"gradients worst {worst} {grad_err[worst]:.2e} (tol {TRAIN_GRAD_RTOL}); "
        f"clipped norm rel {norm_err:.2e}; update worst {worst_u} "
        f"{update_err[worst_u]:.2e} (tol {TRAIN_UPDATE_RTOL}); int8 codes "
        f"differ at {code_frac[worst_c]:.2e} worst ({worst_c[0]} {worst_c[1]}), "
        f"dequantized {deq_err[worst_d]:.2e}; {launches['flash_attention']} "
        f"flash launches (forward + remat)")
    log(f"{tag} (a) controls (must lie outside): "
        + ", ".join(f"{k} {v:.3e}" for k, v in controls.items())
        + f"; the flash Function's q/k/v gradients against autograd through "
        f"the plain version: {fn_words}; prefill + decode against the "
        f"forward {decode_err:.2e} (tol {TRAIN_DECODE_RTOL}); card {card}")
    return rec


@contextlib.contextmanager
def recorded_routes(out: list):
    """While entered, every MoE route's expert ids (T, k) are appended to
    ``out``, copied to the host."""
    from repro_torch.models.ffn import moe_ffn

    own = moe_ffn.route

    def spy(*args, **kw):
        r = own(*args, **kw)
        out.append(r[1].detach().to("cpu", copy=True))
        return r

    moe_ffn.route = staticmethod(spy)
    try:
        yield out
    finally:
        moe_ffn.route = staticmethod(own)


@contextlib.contextmanager
def forced_routes(ids: list, own: list):
    """While entered, the i-th MoE route computes its own expert ids
    (appended to ``own``, on the host) and then takes ``ids[i]`` in their
    place, its probabilities and aux loss taken from its own router at
    those ids (``moe_ffn.route``'s arithmetic): two runs whose inputs
    differ by rounding then route every token alike."""
    from repro_torch.models.common import cast
    from repro_torch.models.ffn import moe_ffn

    real = moe_ffn.route

    def spy(cfg, p, x_flat):
        _, top_i, _ = real(cfg, p, x_flat)
        own.append(top_i.detach().to("cpu", copy=True))
        want = ids[len(own) - 1].to(top_i.device)
        probs = torch.softmax(x_flat.float() @ cast(p["router"]["w"],
                                                    torch.float32), dim=-1)
        top_p = probs.gather(1, want)
        if cfg.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        E = cfg.num_experts
        counts = torch.zeros(E, dtype=torch.float32, device=x_flat.device)
        counts.scatter_add_(0, want[:, 0], torch.ones_like(top_p[:, 0]))
        aux = E * (counts / x_flat.shape[0] * probs.mean(dim=0)).sum()
        return top_p, want, aux

    moe_ffn.route = staticmethod(spy)
    try:
        yield own
    finally:
        moe_ffn.route = staticmethod(real)


def route_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of tokens routed to the same set of experts."""
    same = torch.sort(a, dim=-1).values == torch.sort(b, dim=-1).values
    return float(same.all(dim=-1).double().mean())


def detached_ssd():
    """While entered, the SSD's output and final state are detached: a
    Mamba2 layer whose SSD backward is missing, as a control."""
    from repro_torch.models import ssm

    own = ssm._ssd_chunked

    def cut(*args, **kw):
        y, state = own(*args, **kw)
        return y.detach(), state.detach()

    return _patched(ssm, "_ssd_chunked", cut)


def train_family_check(arch: str, tag: str, act: str, card: str, dev) -> dict:
    """Phase 20 (a) for a MoE + MLA or Mamba2 configuration: one step's
    gradients of the 2-layer full-width model on the card (activations in
    ``act``) against the CPU's float32 step on the same batch and weights,
    with a control whose attention (or SSD) output is detached; then the
    whole step (gradients, clipping, int8 AdamW) on the card, timed."""
    import copy

    from repro_torch.configs.base import layer_layout
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    t_start = time.perf_counter()
    base = M.get_config(arch).with_overrides(
        num_layers=TRAIN_CHECK_LAYERS, dtype="float32", param_dtype="float32")
    cfg = base.with_overrides(dtype=act)
    bf16 = act == "bfloat16"
    loss_tol = TRAIN_BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL

    def grad_tol(leaf: str) -> float:
        return bf16_grad_tol(leaf) if bf16 else TRAIN_GRAD_RTOL

    np_batch = TokenPipeline(cfg, batch=TRAIN_CHECK_B, seq=TRAIN_CHECK_S,
                             seed=SEED).next_batch()
    cpu_params = TS.trainable(T.init_params(
        base, torch.Generator().manual_seed(SEED), device="cpu"))
    gpu_params = TS.trainable(copy.deepcopy(cpu_params).to(dev))
    opt = O.adamw(quantized=True)
    sched = O.warmup_cosine(TRAIN_CHECK_LR, 0, 10)
    routes = {"cpu": [], "gpu": []}
    t0 = time.perf_counter()
    with recorded_routes(routes["cpu"]):
        want, want_met = TS.build_train_step(base, opt, sched).grads_and_metrics(
            cpu_params, TS.batch_to_device(np_batch, "cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_params
    step = TS.build_train_step(cfg, opt, sched)
    batch = TS.batch_to_device(np_batch, dev)
    reset_launches()
    t0 = time.perf_counter()
    with recorded_routes(routes["gpu"]):
        got, met = step.grads_and_metrics(gpu_params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    shares = [route_share(a, b) for a, b in zip(routes["cpu"], routes["gpu"])]
    launches = {k: v for k, v in read_launches().items() if v}
    loss = {"gpu": float(met["loss"]), "cpu": float(want_met["loss"])}
    loss_err = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    grad_err = {n: leaf_rel_rms(got[n], want[n]) for n in want}
    worst = max(grad_err, key=lambda n: grad_err[n] / grad_tol(n))
    del want
    layout = layer_layout(cfg)
    attn = sum(spec.mixer != "mamba" for spec in layout)
    moe = sum(spec.ffn == "moe" for spec in layout)
    want_launches = {}
    if attn:
        want_launches["flash_attention_wgmma" if bf16 else "flash_attention"] \
            = 2 * attn
        if not bf16:
            want_launches["flash_attention_simt_regtile"] = 2 * attn
    if moe:
        want_launches["grouped_swiglu_mm"] = 2 * moe
    if launches != want_launches:
        raise AssertionError(f"{tag} (a) the card's step launched {launches}; "
                             f"expected {want_launches} (forward and remat)")
    control_leaf = ("layers.0.mixer.A_log" if not attn
                    else "layers.0.mixer.wq.w")
    with (detached_ssd() if not attn else detached_attention()):
        gd, _ = step.grads_and_metrics(gpu_params, batch)
    control = leaf_rel_rms(gd[control_leaf], got[control_leaf])
    del gd, got
    if (loss_err > loss_tol or grad_err[worst] > grad_tol(worst)
            or control <= grad_tol(control_leaf)):
        raise AssertionError(
            f"{tag} (a) card ({act}) against the CPU (float32): loss "
            f"{loss_err} (tol {loss_tol}), worst gradient {worst} "
            f"{grad_err[worst]} (tol {grad_tol(worst)}); control "
            f"{control_leaf} {control} must lie outside; all "
            f"{sorted(grad_err.items(), key=lambda kv: -kv[1])[:6]}")
    # The whole step on the card, TRAIN_FAMILY_STEPS times: the first
    # warms up, the median of the others is the step's time.
    state = TS.init_train_state(cfg, opt, None, params=gpu_params)
    times = []
    reset_launches()
    for _ in range(TRAIN_FAMILY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_launches = {k: v for k, v in read_launches().items() if v}
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"{tag} (a) loss {float(m['loss'])}")
    rec = {"layers": TRAIN_CHECK_LAYERS, "step_launches": step_launches,
           "route_share": shares, "batch": [TRAIN_CHECK_B, TRAIN_CHECK_S],
           "activations": act, "loss": loss, "loss_rel_err": loss_err,
           "loss_tol": loss_tol, "grad_rel_rms_max": grad_err[worst],
           "grad_worst_leaf": worst, "grad_tol": grad_tol(worst),
           "grad_rel_rms": grad_err, "control": {control_leaf: control},
           "launches": launches, "first_grads_s": first_s, "cpu_grads_s": cpu_s,
           "step_s": times, "step_s_median": float(np.median(times[1:])),
           "params": sum(p.numel() for p in
                                          state.params.parameters()),
           "seconds": time.perf_counter() - t_start}
    log(f"{tag} (a) {arch}, {TRAIN_CHECK_LAYERS} layers at full width "
        f"({rec['params']:,} parameters), float32 parameters, {act} "
        f"activations on the card against float32 on the CPU, batch "
        f"{TRAIN_CHECK_B} x {TRAIN_CHECK_S}: loss {loss['gpu']:.6f} / CPU "
        f"{loss['cpu']:.6f} (rel {loss_err:.2e}, tol {loss_tol}); gradients "
        f"worst {worst} {grad_err[worst]:.2e} (tol {grad_tol(worst)}; the "
        f"largest {[(n, round(e, 5)) for n, e in sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]]}); control "
        f"({'SSD' if not attn else 'attention'} output detached) "
        f"{control_leaf} {control:.3e}; routes equal to the CPU's on "
        f"{[round(x, 5) for x in shares]} of tokens (forward, remat); "
        f"launches {launches}; step {1e3 * rec['step_s_median']:.1f} ms, "
        f"the median of {len(times) - 1} warm steps (range "
        f"{1e3 * min(times[1:]):.1f}-{1e3 * max(times[1:]):.1f} ms; first "
        f"{1e3 * times[0]:.1f} ms; the CPU's gradients {cpu_s:.1f} s); card "
        f"{card}")
    del state, batch, gpu_params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def matmul_params(cfg, params) -> int:
    """Parameters that multiply activations (all but the token table: a
    gather for the vision stub, unused by the audio stub)."""
    return sum(p.numel() for n, p in params.named_parameters()
               if n != "embedding.table")


def train_flops(cfg, n_mm: int, tokens: int) -> float:
    """FLOPs a training step needs: 6 N T for the matmuls' forward and
    backward, 2 N T for remat's second forward, and the causal attention
    (its QK^T and PV over the live pairs) four times (forward, remat's
    forward, a backward of twice the forward)."""
    S = TRAIN_S
    pairs = S * (S + 1) / 2
    attn = 2.0 * pairs * 2 * cfg.head_dim * cfg.num_heads * TRAIN_B
    return 8.0 * n_mm * tokens + 4.0 * attn * cfg.num_layers


def predicted_train_bytes(cfg, n_params: int) -> dict:
    """The reckoned peak (PERF.md, §6): float32 parameters and
    gradients, int8 moments with their float32 row scales, the logits in
    bf16 and their float32 copy, the largest leaf's blocked update."""
    V = cfg.padded_vocab_size * max(cfg.num_codebooks, 1)
    logits = TRAIN_B * TRAIN_S * V * (2 + 4 + 4)
    return {"params": 4 * n_params, "grads": 4 * n_params,
            "moments": 2 * n_params, "logits": logits,
            "total": 10 * n_params + logits}


def train_full_model(arch: str, tag: str, layers: int, card: str, dev) -> dict:
    """Phase 20 (b): the configuration at full width (``layers`` deep),
    float32 master parameters, bf16 activations, remat, int8 AdamW,
    TokenPipeline batches of TRAIN_B x TRAIN_S: TRAIN_STEPS timed steps,
    one profiled step, the flash launches counted, the first launch of a
    forward held and timed."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention.ops import BACKWARD_SPAN
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    t_start = time.perf_counter()
    cfg = M.get_config(arch).with_overrides(num_layers=layers,
                                            param_dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    n_mm = matmul_params(cfg, params)
    predicted = predicted_train_bytes(cfg, n_params)
    log(f"{tag} (b) {arch}: {layers} layers at full width, {n_params:,} "
        f"parameters ({n_mm:,} in matmuls); predicted peak "
        f"{predicted['total'] / 2**30:.2f} GiB before activations (parameters "
        f"{predicted['params'] / 2**30:.2f}, gradients "
        f"{predicted['grads'] / 2**30:.2f}, int8 moments "
        f"{predicted['moments'] / 2**30:.2f}, logits "
        f"{predicted['logits'] / 2**30:.2f}) of {total_mem / 2**30:.2f}")
    pipe = TokenPipeline(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
    opt = spanned_optimizer(O.adamw(quantized=True))
    step = TS.build_train_step(cfg, opt, O.warmup_cosine(TRAIN_LR, 0,
                                                         TRAIN_STEPS + 1))
    state = TS.init_train_state(cfg, opt, None, params=params)
    del params
    times, losses = [], []
    reset_launches()
    for _ in range(TRAIN_STEPS):
        batch = TS.batch_to_device(pipe.next_batch(), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = read_launches()
    # One step in its two halves, each ending in a synchronize: the
    # forward and backward, then clipping and the optimizer.
    batch = TS.batch_to_device(pipe.next_batch(), dev)
    t0 = time.perf_counter()
    grads, met = step.grads_and_metrics(state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, met = step.apply_gradients(state, grads, met)
    torch.cuda.synchronize()
    halves = {"grads_s": t1 - t0, "update_s": time.perf_counter() - t1}
    losses.append(float(met["loss"]))
    del grads
    holder = [state]
    batch = TS.batch_to_device(pipe.next_batch(), dev)

    def one_step():
        holder[0], m = step(holder[0], batch)
        losses.append(float(m["loss"]))

    prof = profile_call(one_step, spans=(BACKWARD_SPAN, OPT_SPAN))
    state = holder[0]
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_wgmma": 2 * layers * TRAIN_STEPS}
    seen = {k: v for k, v in launches.items() if v}
    if seen != want:
        raise AssertionError(f"{tag} (b) {TRAIN_STEPS} steps launched {seen}; "
                             f"expected {want} (forward and remat, a layer a "
                             "step, all of the Hopper kernel)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} (b) losses {losses}")
    if peak >= total_mem:
        raise AssertionError(f"{tag} (b) peak {peak} over the card's {total_mem}")
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, n_mm, tokens)
    mfu = flops / step_s / PEAK_FLOP_S[torch.bfloat16]
    # The first flash launch of a forward, held against both plain
    # versions and timed beside SDPA and its bound.
    with torch.no_grad():
        seen_fa = capture_flash(lambda: T.forward(cfg, state.params,
                                                  batch["batch"]), layers)
    fa = hold_flash_launches(seen_fa[:1], card, "flash_attention_wgmma")
    del seen_fa
    kinds = prof["kinds"]
    rec = {"layers": layers, "params": n_params, "matmul_params": n_mm,
           "batch": [TRAIN_B, TRAIN_S], "steps": TRAIN_STEPS,
           "step_s": times, "step_s_median": step_s, "halves": halves,
           "tokens_per_s": tokens / step_s, "flops_per_step": flops,
           "train_mfu": mfu, "losses": losses, "peak_bytes": peak,
           "predicted_bytes": predicted, "card_bytes": total_mem,
           "launches": launches, "profile": prof, "flash": fa,
           "seconds": time.perf_counter() - t_start}
    log(f"{tag} (b) {arch}: step {1e3 * step_s:.1f} ms (median of "
        f"{TRAIN_STEPS - 1} after the first; host clock around a step ending "
        f"in a synchronize; all {[round(1e3 * t, 1) for t in times]}; one "
        f"more in halves: forward and backward {1e3 * halves['grads_s']:.1f} "
        f"ms, clipping and the optimizer {1e3 * halves['update_s']:.1f} ms), "
        f"{tokens / step_s:,.0f} tokens/s, train_mfu {100 * mfu:.1f}% "
        f"({flops / 1e12:.1f} TFLOP a step at 989 TFLOP/s); peak "
        f"{peak / 2**30:.2f} GiB (predicted {predicted['total'] / 2**30:.2f} "
        f"before activations); losses (a fresh batch each step) "
        f"{[round(l, 4) for l in losses]}; "
        f"{launches['flash_attention_wgmma']} Hopper flash launches; card {card}")
    log(f"{tag} (b) profiled step: wall {prof['wall_ms']:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms (busy {100 * (prof['busy_share'] or 0):.0f}%), "
        f"{prof['launch_api_calls']} host launch calls; by family: "
        + ", ".join(f"{k} {v['ms']:.1f} ({v['count']})"
                    for k, v in kinds.items() if v["count"]))
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def launcher_losses(stdout: str) -> dict:
    """{step: loss} from a launcher's ``[train] step=N loss=X`` lines."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("[train] step="):
            parts = dict(p.split("=") for p in line.split()[1:3])
            out[int(parts["step"])] = float(parts["loss"])
    return out


def checkpoint_leaves(path: str, step: int) -> tuple[dict, dict]:
    """(manifest, {leaf name: array}) of a launcher checkpoint."""
    final = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(final, "MANIFEST.json")) as f:
        manifest = json.load(f)
    return manifest, {e["name"]: np.load(os.path.join(final, e["file"]))
                      for e in manifest["leaves"]}


def param_spread(a: dict, b: dict) -> dict:
    """Max |a - b| and the largest relative RMS over the parameter
    leaves of two checkpoints."""
    names = [n for n in a if n.startswith("params/")]
    diff = max(float(np.abs(a[n].astype(np.float64) - b[n]).max()) for n in names)
    rel = max(float(np.sqrt(((a[n].astype(np.float64) - b[n]) ** 2).mean()
                            / max((b[n].astype(np.float64) ** 2).mean(), 1e-300)))
              for n in names)
    return {"max_abs": diff, "rel_rms_max": rel,
            "bit_equal": all(np.array_equal(a[n], b[n]) for n in a)}


def run_launcher(card: str) -> dict:
    """Phase 20 (c): ``python -m repro_torch.launch.train`` on the card on
    the 100M example's configuration: two uninterrupted runs, and one
    preempted at LAUNCH_PREEMPT_AT (exit 43) and resumed."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import get_config

    t_start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    steps = int(LAUNCH_ARGS[LAUNCH_ARGS.index("--steps") + 1])

    def start(ckpt: str, *extra) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
             "--ckpt-dir", os.path.join(work, ckpt), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=ROOT)

    def finish(name: str, proc: subprocess.Popen, code: int, t0: float) -> str:
        try:
            out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        finally:
            proc.kill()  # a no-op once it has exited
        if proc.returncode != code:
            raise AssertionError(f"[launch] {name} run exited {proc.returncode}, "
                                 f"expected {code}: {out[-1500:]} {err[-1500:]}")
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "losses": launcher_losses(out),
                      "tail": out.splitlines()[-2:]}
        log(f"[launch] {name} run: exit {code} in {runs[name]['seconds']:.1f} s")
        return out

    runs = {}
    procs = []
    try:
        # The two uninterrupted runs and the preempted one are independent:
        # they run together (one card, 2-3 GB each); the resume follows.
        t0 = time.perf_counter()
        procs = [("uninterrupted", start("a"), 0), ("again", start("b"), 0),
                 ("preempted", start("c", "--simulate-preemption-at",
                                     str(LAUNCH_PREEMPT_AT)), 43)]
        for name, proc, code in procs:
            finish(name, proc, code, t0)
        manifest, _ = checkpoint_leaves(os.path.join(work, "c"),
                                        LAUNCH_PREEMPT_AT)
        runs["preempted"]["pipeline"] = manifest["extra"]["pipeline"]
        t0 = time.perf_counter()
        procs = [("resumed", start("c"), 0)]
        out = finish("resumed", procs[0][1], 0, t0)
        if (f"resumed from step {LAUNCH_PREEMPT_AT} (pipeline step "
                f"{LAUNCH_PREEMPT_AT})") not in out:
            raise AssertionError(f"[launch] no resume: {out[:600]}")
        # The pipeline state of the preemption checkpoint, and the batch a
        # resumed run draws first, against an uninterrupted pipeline's.
        cfg = get_config("olmo-100m")
        kw = dict(batch=int(LAUNCH_ARGS[LAUNCH_ARGS.index("--batch") + 1]),
                  seq=int(LAUNCH_ARGS[LAUNCH_ARGS.index("--seq") + 1]), seed=0)
        straight = TokenPipeline(cfg, **kw)
        for _ in range(LAUNCH_PREEMPT_AT):
            straight.next_batch()
        resumed = TokenPipeline(cfg, **kw)
        resumed.load_state_dict(runs["preempted"]["pipeline"])
        a, b = straight.next_batch(), resumed.next_batch()
        batch_equal = (resumed.step == straight.step and all(
            np.array_equal(a[k] if k != "batch" else a[k]["tokens"],
                           b[k] if k != "batch" else b[k]["tokens"])
            for k in a))
        if runs["preempted"]["pipeline"] != {"step": LAUNCH_PREEMPT_AT,
                                             "seed": 0} or not batch_equal:
            raise AssertionError(f"[launch] pipeline after resume: "
                                 f"{runs['preempted']['pipeline']}, batch equal "
                                 f"{batch_equal}")
        finals = {n: checkpoint_leaves(os.path.join(work, d), steps)[1]
                  for n, d in (("uninterrupted", "a"), ("again", "b"),
                               ("resumed", "c"))}
        spread = param_spread(finals["again"], finals["uninterrupted"])
        resumed_gap = param_spread(finals["resumed"], finals["uninterrupted"])
        del finals
        losses = runs["uninterrupted"]["losses"]
        w = LAUNCH_LOSS_WINDOW
        fall = (np.mean([losses[s] for s in range(w)])
                - np.mean([losses[s] for s in range(steps - w, steps)]))
        joined = {**runs["preempted"]["losses"], **runs["resumed"]["losses"]}
        loss_gap = max(abs(joined[s] - losses[s]) for s in losses)
        if fall < LAUNCH_LOSS_FALL or set(joined) != set(losses):
            raise AssertionError(f"[launch] loss {losses[0]} -> "
                                 f"{losses[steps - 1]} (fall of the {w}-step "
                                 f"means {fall}, at least {LAUNCH_LOSS_FALL}); "
                                 f"steps logged "
                                 f"{sorted(set(joined) ^ set(losses))} apart")
    finally:
        for _, proc, _ in procs:
            proc.kill()
        shutil.rmtree(work, ignore_errors=True)
    rec = {"runs": runs, "spread": spread, "resumed_gap": resumed_gap,
           "loss_fall": fall, "loss_gap_max": loss_gap,
           "batch_after_resume_equal": batch_equal,
           "seconds": time.perf_counter() - t_start}
    log(f"[launch] python -m repro_torch.launch.train {' '.join(LAUNCH_ARGS)}: "
        f"uninterrupted {runs['uninterrupted']['seconds']:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[steps - 1]:.4f} (the {LAUNCH_LOSS_WINDOW}-step "
        f"means fall {fall:.4f}, at least {LAUNCH_LOSS_FALL}); preempted at {LAUNCH_PREEMPT_AT} (exit 43, "
        f"{runs['preempted']['seconds']:.1f} s), resumed from its checkpoint "
        f"(pipeline step {runs['preempted']['pipeline']['step']}, its next batch "
        f"bit-equal to an uninterrupted pipeline's) in "
        f"{runs['resumed']['seconds']:.1f} s; final parameters against the "
        f"uninterrupted run's: resumed max|d| {resumed_gap['max_abs']:.3e} "
        f"(rel RMS {resumed_gap['rel_rms_max']:.3e}, bit-equal "
        f"{resumed_gap['bit_equal']}), a second uninterrupted run "
        f"{spread['max_abs']:.3e} ({spread['rel_rms_max']:.3e}, bit-equal "
        f"{spread['bit_equal']}); logged losses within {loss_gap:.3e}; card {card}")
    return rec


def grouped_mm_backward(dev) -> dict:
    """Whether the card's ``torch._grouped_mm`` (the MoE layers' grouped
    GEMM) has a backward: gradients of a small bf16 call against the
    per-group products'."""
    x = torch.randn(32, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(2, 64, 48, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    offs = torch.tensor([16, 32], dtype=torch.int32, device=dev)
    try:
        gx, gw = torch.autograd.grad(torch._grouped_mm(x, w, offs=offs).float()
                                     .sum(), (x, w))
    except (RuntimeError, NotImplementedError) as err:
        return {"backward": False, "error": str(err)[:200]}
    ref_x, ref_w = torch.autograd.grad(
        torch.cat([x[:16] @ w[0], x[16:] @ w[1]]).float().sum(), (x, w))
    return {"backward": True,
            "max_abs_err": max(_max_abs_err(gx, ref_x), _max_abs_err(gw, ref_w))}


def run_training(card: str, dev) -> dict:
    """Phase 20: (a) the check models (the stubs, then the MoE + MLA and
    Mamba2 families), (b) the full-width runs, (c) the launcher, the card
    freed between them; and whether the grouped GEMM of the MoE layers
    has a backward."""
    out = {"check": {}, "full": {}, "grouped_mm": grouped_mm_backward(dev)}
    log(f"[train] torch._grouped_mm under autograd: {out['grouped_mm']}")
    t_phase = time.perf_counter()
    for arch, tag, _ in TRAIN_ARCHS:
        out["check"][arch] = train_check_model(arch, tag, card, dev)
        gc.collect()
        torch.cuda.empty_cache()
    out["families"] = {arch: train_family_check(arch, tag, act, card, dev)
                       for arch, tag, act in TRAIN_FAMILIES}
    for arch, tag, layers in TRAIN_ARCHS:
        out["full"][arch] = train_full_model(arch, tag, layers, card, dev)
    out["launcher"] = run_launcher(card)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 20 in {out['seconds']:.2f} s; card {card}")
    return out


def _subtree_kernels(evt) -> list:
    """The kernels a profiled host event launched, its children's too."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _subtree_kernels(child)
    return out


def profile_call(fn, spans=()) -> dict:
    """Device time by kernel name over one call of ``fn`` under
    ``torch.profiler``, and the device's busy share of that window.  The
    profiler's own overhead lengthens the window, so the busy share is a
    lower bound; unprofiled wall times are measured separately.  Each name
    in ``spans`` is a ``record_function`` range: the kernels launched
    inside it make a family of that name, taken out of the families their
    kernel names give."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator's row repeats its kernels' time, and a
    # span's device-side annotation row spans its kernels.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in spans
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # The host's launch calls (kernel and graph launches, the `cuda*` and
    # `cu*` API entries), as the profiler's CPU rows count them.
    api = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("cu")
           and "Launch" in e.key}
    kinds = {kind: {"ms": 0.0, "count": 0}
             for kind in (*spans, *PROFILE_KINDS, "other")}

    def family(name: str) -> str:
        return next((k for k, words in PROFILE_KINDS.items()
                     if any(w in name for w in words)), "other")

    for name, ms, count in rows:
        kinds[family(name)]["ms"] += ms
        kinds[family(name)]["count"] += count
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            for k in _subtree_kernels(e):
                kinds[family(k.name)]["ms"] -= k.duration / 1e3
                kinds[family(k.name)]["count"] -= 1
                kinds[e.name]["ms"] += k.duration / 1e3
                kinds[e.name]["count"] += 1
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if device_ms else None,
        "launches": sum(r[2] for r in rows),
        "launch_api_calls": sum(api.values()),
        "launch_api": api,
        "kinds": kinds,
        "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:12]],
        "cpu_top": [{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
                     "count": e.count}
                    for e in sorted((e for e in prof.key_averages()
                                     if e.device_type == DeviceType.CPU),
                                    key=lambda e: -e.self_cpu_time_total)[:12]],
    }


def profile_pass(index, batch, **query_kw) -> dict:
    """One warm ``query_many`` under the profiler."""
    return profile_call(lambda: index.query_many(batch, top_k=TOP_K,
                                                 min_join=MIN_JOIN, **query_kw))


# ---------------------------------------------------------------------------
# Phase 21: the discovery mesh
# ---------------------------------------------------------------------------

def equal_or_raise(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """Bit-equality of two host arrays (NaN positions equal), with the
    largest difference in the message when they differ."""
    if got.shape != want.shape or not np.array_equal(got, want, equal_nan=True):
        diff = (np.nanmax(np.abs(got.astype(np.float64) - want.astype(np.float64)))
                if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: mesh differs from the batched path "
                             f"(max abs difference {diff})")


def mesh_routes(index, batches, mesh, dense_q: int) -> dict:
    """(b): ``query_many`` on the mesh and on the batched path through
    each route, per target dtype; the dense route on the first
    ``dense_q`` queries (it scores the whole lake).  Each route runs
    twice on the mesh (the first window's per-shard rungs start at their
    floor and overflow into the host boundary), and every pass must equal
    the batched one exactly."""
    routes = {"dense": {"prefilter": False}, "two_phase": {"fused": False},
              "fused": {}, "gated": {"min_containment": GATE_MC}}
    out = {}
    for route, kw in routes.items():
        for b in batches:
            qs = b[:dense_q] if route == "dense" else b
            want = flat_results(index.query_many(qs, top_k=TOP_K,
                                                 min_join=MIN_JOIN, **kw))
            for rep in range(2):
                got = flat_results(index.query_many(qs, top_k=TOP_K,
                                                    min_join=MIN_JOIN,
                                                    mesh=mesh, **kw))
                if got != want:
                    raise AssertionError(
                        f"query_many(mesh={mesh}) {route} pass {rep} differs "
                        f"from the batched path")
            out[route] = len(qs)
    return out


def mesh_hybrid(index, queue: list, small: list, mesh) -> dict:
    """(d): ``submit(rank="hybrid")`` on the mesh against the batched
    service, bit for bit, on every route (the dense one on ``small``):
    the shard programs weight by join size / train size before their
    top-k (``executors._hybrid``)."""
    from repro_torch.core.discovery import DiscoveryService

    routes = {"dense": {"prefilter": False}, "two_phase": {"fused": False},
              "fused": {}, "gated": {"min_containment": GATE_MC}}
    msvc = DiscoveryService(index=index, k=3, mesh=mesh)
    bsvc = DiscoveryService(index=index, k=3)
    out = {}
    for route, kw in routes.items():
        qs = small if route == "dense" else queue
        kw = dict(top_k=TOP_K, min_join=MIN_JOIN, rank="hybrid", **kw)
        got = flat_results(msvc.submit(qs, **kw))
        if got != flat_results(bsvc.submit(qs, **kw)):
            raise AssertionError(f"hybrid submit on {mesh}, {route} route, "
                                 "differs from the batched service")
        out[route] = len(qs)
    return out


def mesh_launch_samples(index, batches, mesh) -> list:
    """(e): one warm fused mesh pass per target dtype under ``eager()``
    with ``radius_counts``' Python call wrapped (as ``capture_launches``):
    every launch with its inputs, arguments and outputs."""
    from repro_torch import compile as programs

    seen = []
    for b in batches:
        with programs.eager():
            _, s = spy_radius_counts(lambda b=b: index.query_many(
                b, top_k=TOP_K, min_join=MIN_JOIN, mesh=mesh))
        seen += s
    return seen


def run_mesh(index, batches, svc_queue, clean, card: str, dev) -> dict:
    """Phase 21: the discovery mesh over the phase-3 index, 4 shards on
    one card (``make_host_mesh(devices=[cuda:0] * 4)``), a 3-shard mesh
    (its group buckets padded to the shard count) and the mesh over the
    visible cards.  (a) ``execute`` bit-equal to the batched executor;
    (b) ``query_many(mesh=)`` equal to the batched path on every route;
    (c) ``distributed_topk`` against ``score_batch``'s argsort; (d) the
    service on the mesh, its fault descent, the non-finite fence and
    ``rank="hybrid"`` on every route (4 and 3 shards); (e)
    each shard's ``radius_counts`` launches bit-equal to the plain
    version; (f) warm wall and device times, launches and peak memory
    beside the batched path's."""
    from repro_torch import compile as programs
    from repro_torch.core.discovery import (
        BatchedExecutor,
        DiscoveryService,
        distributed_topk,
        inject_faults,
        score_batch,
        stack_trains_host,
    )
    from repro_torch.kernels.knn_stats import kernel, ref
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    mesh = make_host_mesh(devices=[dev] * MESH_SHARDS)
    odd = make_host_mesh(devices=[dev] * MESH_ODD_SHARDS)
    card0 = mesh.axis_devices("data")[0]
    visible = make_host_mesh()
    rec = {"shards": MESH_SHARDS, "odd_shards": MESH_ODD_SHARDS,
           "visible_cards": visible.shape["data"],
           "memory_at_start": {"allocated": torch.cuda.memory_allocated(),
                               "reserved": torch.cuda.memory_reserved()}}
    log(f"[mesh] device memory at the start: "
        f"{rec['memory_at_start']['allocated'] / 2**30:.2f} GiB allocated, "
        f"{rec['memory_at_start']['reserved'] / 2**30:.2f} GiB reserved")

    # (a) execute against the batched executor, both target dtypes.
    reset_launches()
    for b in batches:
        y_disc = bool(b[0].value_is_discrete)
        plan = index.plan(y_disc)
        trains = stack_trains_host(b[:MESH_DENSE_Q], dev)
        for m in (mesh, odd):
            mi, js = index._distributed_executor(m).execute(plan, trains)
            want = BatchedExecutor().execute(plan, trains)
            equal_or_raise(f"execute {m} MI (y_discrete={y_disc})", mi, want[0])
            equal_or_raise(f"execute {m} join sizes", js, want[1])
    rec["execute_launches"] = read_launches()
    rec["memory_after_execute"] = {"allocated": torch.cuda.memory_allocated(),
                                   "reserved": torch.cuda.memory_reserved()}
    if rec["execute_launches"]["radius_counts"] == 0:
        raise AssertionError("mesh execute never launched radius_counts")
    log(f"[mesh] (a) execute on {MESH_SHARDS} and {MESH_ODD_SHARDS} shards of "
        f"{card0}, Q={MESH_DENSE_Q} per dtype over C={len(index)}: (Q, C) MI and "
        f"join sizes bit-equal to the batched executor; launches "
        f"{launch_words(rec['execute_launches'])}; device memory "
        f"{rec['memory_after_execute']['allocated'] / 2**30:.2f} GiB allocated, "
        f"{rec['memory_after_execute']['reserved'] / 2**30:.2f} GiB reserved")

    # (b) every route on 4 shards and on the visible cards; the 3-shard
    # mesh runs its routes at the end of the phase, since meshes share
    # the index's per-shard rungs (keyed on sharding, not on the shard
    # count) and its shards hold more rows each.
    t0 = time.perf_counter()
    rec["routes"] = {str(mesh): mesh_routes(index, batches, mesh, MESH_DENSE_Q),
                     str(visible): mesh_routes(index, batches[:1], visible,
                                               MESH_DENSE_Q)}
    live = {f"y_discrete={y}": [[int(l.sum()) for l in sg.lives] for sg in
                                index._distributed_executor(mesh)._groups(
                                    index.plan(y))]
            for y in (False, True)}
    rec["live_rows_per_shard"] = live
    log(f"[mesh] (b) query_many(mesh=) == the batched path (rankings, MI and "
        f"join sizes exactly) through the dense (Q={MESH_DENSE_Q}), two-phase, "
        f"fused and gated (min_containment={GATE_MC}) routes, cold and warm, on "
        f"{MESH_SHARDS} shards, and every route on make_host_mesh() "
        f"({visible.shape['data']} card(s), continuous target); "
        f"{time.perf_counter() - t0:.2f} s; live rows per shard, by group: {live}")

    # (c) distributed_topk against score_batch's argsort.
    for b in batches:
        sk = b[0]
        train, cands = index.train_arrays(sk), index.stacked(sk.value_is_discrete)
        mi, js = (t.cpu().numpy() for t in score_batch(train, cands))
        v, gi, jz = distributed_topk(train, cands, mesh, TOP_K)
        order = np.argsort(-mi, kind="stable")[:TOP_K]
        equal_or_raise("distributed_topk values", v, mi[order])
        equal_or_raise("distributed_topk ids", gi, order.astype(gi.dtype))
        equal_or_raise("distributed_topk join sizes", jz, js[order])
    log(f"[mesh] (c) distributed_topk(top_k={TOP_K}) on {MESH_SHARDS} shards == "
        f"the stable argsort of score_batch (values, ids, join sizes), both dtypes")

    # (d) the service on the mesh.
    msvc = DiscoveryService(index=index, k=3, mesh=mesh)
    reset_launches()
    got = msvc.submit(svc_queue, top_k=TOP_K, min_join=MIN_JOIN)
    loop = [index.query(sk, top_k=TOP_K, min_join=MIN_JOIN, mesh=mesh)
            for sk in svc_queue]
    if flat_results(got) != flat_results(loop) or \
            flat_results(got) != flat_results(clean):
        raise AssertionError("mesh submit differs from its looped mesh queries "
                             "or from phase 7's submit")
    small = svc_queue[:2 * MESH_DENSE_Q]
    dense = {"prefilter": False}
    want = msvc.submit(small, top_k=TOP_K, min_join=MIN_JOIN, **dense)
    with inject_faults({"dispatch@distributed": "all"}):
        res, outs = msvc.submit_safe(small, top_k=TOP_K, min_join=MIN_JOIN,
                                     **dense)
    if flat_results(res) != flat_results(want) or \
            {o.rung for o in outs} != {"batched"}:
        raise AssertionError(f"dispatch@distributed: expected the batched rung "
                             f"with the same results; rungs {[o.rung for o in outs]}")
    with inject_faults({"fused_dispatch@distributed": "all",
                        "prefilter_dispatch@distributed": "all"}):
        res2, outs2 = msvc.submit_safe(svc_queue, top_k=TOP_K, min_join=MIN_JOIN)
    if flat_results(res2) != flat_results(got) or \
            {o.rung for o in outs2} != {"batched"}:
        raise AssertionError("fused faults on the mesh: expected the batched rung")
    reset_launches()
    with inject_faults({"scores": FENCE_LANES}, seed=SEED) as fplan:
        res3, outs3 = msvc.submit_safe(svc_queue, top_k=TOP_K, min_join=MIN_JOIN)
    fence_launches = read_launches()
    if {o.rung for o in outs3} != {"distributed"} or fplan.corrupted != \
            FENCE_LANES * len(svc_queue) or fence_launches["pairwise_cheb"] == 0:
        raise AssertionError(f"mesh fence: rungs {sorted({o.rung for o in outs3})}, "
                             f"{fplan.corrupted} lanes, launches {fence_launches}")
    for a, b in zip(res3, got):
        same_rankings([a], [b], tol=MI_TOL)
    rec["service"] = {"admission": msvc.stats()["admission"],
                      "fence_launches": fence_launches}
    rec["hybrid"] = {str(mesh): mesh_hybrid(index, svc_queue, small, mesh)}
    log(f"[mesh] (d) DiscoveryService(mesh=) submit of {len(svc_queue)} queries "
        f"== looped mesh queries == phase 7's submit; dispatch@distributed "
        f"(dense, {len(small)} queries) and fused/prefilter@distributed faults "
        f"descend to the batched rung with the same results; the fence on the "
        f"distributed rung: {fplan.corrupted} NaN lanes, launches "
        f"{launch_words(fence_launches)}; submit(rank='hybrid') == the "
        f"batched service on every route {rec['hybrid'][str(mesh)]}")

    # (e) each shard's radius_counts launches against the plain version.
    reset_launches()
    seen = mesh_launch_samples(index, batches, mesh)
    counted = read_launches()["radius_counts"]
    if counted != len(seen) or len(seen) % MESH_SHARDS:
        raise AssertionError(f"{len(seen)} captured launches, {counted} counted; "
                             f"expected a multiple of {MESH_SHARDS} shards")
    rows = []
    for i, (x, y, m, args, out_k) in enumerate(seen):
        group, shard = divmod(i, MESH_SHARDS)
        err = bit_equal(f"radius_counts, group {group} shard {shard}", out_k,
                        ref.radius_counts(x, y, m, **args))
        staged = kernel.takes_staged(x.shape[1], args["mode"], args["k"],
                                     args["kb"])
        rows.append({"group": group, "shard": shard, "mode": args["mode"],
                     "which": args["which"], "B": int(x.shape[0]),
                     "P": int(x.shape[1]),
                     "body": "staged" if staged else "tiled",
                     "max_abs_err": err})
    max_err = max((r["max_abs_err"] for r in rows), default=0.0)
    rec["shard_launches"] = rows
    log(f"[mesh] (e) {len(seen)} radius_counts launches of a warm fused pass per "
        f"dtype ({len(seen) // MESH_SHARDS} groups x {MESH_SHARDS} shards), each "
        f"bit-equal to ref.radius_counts on its shard's samples; bodies "
        f"{sorted({r['body'] for r in rows})}; B per launch "
        f"{[r['B'] for r in rows]}")

    # (f) warm times, launches per window, peak memory: mesh and batched
    # alternated, each pass both target dtypes.
    def one(m):
        return run_pass(index, batches, dev, **({"mesh": m} if m else {}))[0]

    times = {"mesh": [], "batched": []}
    for _ in range(MESH_REPS):
        times["mesh"].append(one(mesh))
        times["batched"].append(one(None))
    launches, peak, peak_eager, prof = {}, {}, {}, {}
    for name, m in (("mesh", mesh), ("batched", None)):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one(m)
        launches[name] = read_launches()["radius_counts"]
        peak[name] = torch.cuda.max_memory_allocated() - base
        # The working set of the computation itself: a replay allocates
        # only its outputs' copies (its temporaries live in the graphs'
        # pool), an eager pass allocates every temporary.
        torch.cuda.reset_peak_memory_stats()
        with programs.eager():
            one(m)
        peak_eager[name] = torch.cuda.max_memory_allocated() - base
        prof[name] = profile_call(lambda m=m: one(m))
    if launches["mesh"] != MESH_SHARDS * launches["batched"]:
        raise AssertionError(f"warm window launches {launches}: each shard "
                             "should launch once per KSG group")
    med = {k: float(np.median(v)) for k, v in times.items()}
    rec.update(times_s=times, median_s=med, launches_per_window=launches,
               peak_bytes_over_base=peak, peak_eager_bytes_over_base=peak_eager,
               profile={k: {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"],
                            "busy_share": p["busy_share"],
                            "launches": p["launches"]}
                        for k, p in prof.items()},
               max_abs_err=max_err)
    for k in ("mesh", "batched"):
        log(f"[mesh] (f) warm query_many, {k}: median {1e3 * med[k]:.2f} ms of "
            f"{MESH_REPS} (both dtypes, Q={Q} each), profiled wall "
            f"{prof[k]['wall_ms']:.2f} ms, device {prof[k]['device_ms']:.2f} ms "
            f"(busy {prof[k]['busy_share'] or 0:.2f}); radius_counts launches per "
            f"window {launches[k]}; peak over the resident index "
            f"{peak[k] / 2**20:.1f} MiB replayed, {peak_eager[k] / 2**20:.1f} "
            f"MiB eager; card {card}")

    # (b) on the 3-shard mesh (group buckets padded to the shard count).
    t0 = time.perf_counter()
    rec["routes"][str(odd)] = mesh_routes(index, batches, odd, MESH_DENSE_Q)
    rec["hybrid"][str(odd)] = mesh_hybrid(index, svc_queue, small, odd)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] (b) the same routes on {MESH_ODD_SHARDS} shards == the batched "
        f"path, and (d)'s hybrid submit on every route; "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"[mesh] phase 21 in {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 22: the model mesh (serving), one process over four shards of the
# one card
# ---------------------------------------------------------------------------

# Every phase-22 mesh is ["cuda:0"] * 4: four shard boundaries on one
# card, so the shards' pieces are views of one tensor and nothing crosses
# between cards (the mesh's transfers between cards are bypassed).
MESH_DEVICES = ["cuda:0"] * 4
MESH_SHAPES = ((2, 2), (1, 4))
# (a): the last row of a 2048-token prompt, the last row of the cache, and
# a position where only the first sequence shard holds live rows (on
# both meshes: 2 shards of 2048 rows, 4 of 1024).
MESH_DECODE_POS = (2047, 4095, 100)
MESH_DECODE_REPS = 20
# The CP decode attention in float32 against the unsharded one: the merge
# reorders float32 sums, the reference's own mesh tests hold 1e-5.
MESH_F32_ATOL = 1e-5
# (b) one MoE layer of qwen3 at full width on (1, 4), 32 experts a shard,
# bfloat16, at a prefill's token count: EP against impl="gspmd" as a
# relative RMS per token.  EP sums each shard's (top-8 combine of its own
# experts) in bfloat16 where the plain path sums all 8 in one pass, so the
# two differ by bfloat16 rounding of a sum of up to 8 terms (a few
# 2^-8); GROUPED_RTOL (2^-6) sits above that and far below a wrong expert.
MESH_EP_ARCH = "qwen3-moe-30b-a3b"
MESH_EP_SHAPE = (1, 4)
MESH_EP_RTOL = GROUPED_RTOL
# (c) internlm2 whole on (2, 2); (d) qwen3 with moe_impl="ep" on (1, 4),
# cut to its first 8 of 48 layers, bf16 parameters.  The last field: also
# held in float32 activations (the grouped GEMM takes bf16 / fp16 only,
# so the MoE model is held in bf16 alone).
MESH_SERVE = (("internlm2-1.8b", "[mesh-serve]", (2, 2), "gspmd", {}, True),
              ("qwen3-moe-30b-a3b", "[mesh-moe]", (1, 4), "ep",
               {"num_layers": 8, "param_dtype": "bfloat16"}, False))
# Teacher-forced logits of the mesh batcher against the plain batcher's,
# relative RMS per slot and step.  In bf16 the sharded decode attention
# (and EP's sums) round from float32 sums taken in another order; the
# flipped roundings grow through the layers: 0.038 max / 0.025 median
# (internlm2) and 0.024 / 0.006 (qwen3) on an H100 at 700 W (PERF.md), the
# same kind and size as the dtype policy's own error (0.043 against the
# float32 forward, phase 11), so phase 11's SERVED_RTOL holds them; an
# unmasked forward moves the logits 0.40-0.50.  The greedy tokens are
# compared where the plain logits' top-2 gap exceeds the tolerance times
# their RMS and reported: in bf16 a flip there is a rounding, not a fault.
MESH_LOGIT_RTOL = SERVED_RTOL
# The same in float32 activations (internlm2): the only difference left
# is the CP merge's float32 order (about 1e-7 of an attention output), so
# the logits must agree within 1e-4 and the greedy tokens must be equal
# wherever the top-2 gap exceeds 1e-4 of the logits' RMS.
MESH_F32_LOGIT_RTOL = 1e-4


def mesh_cp_decode(card: str, dev) -> dict:
    """(a): the CP decode attention at internlm2's serve shape against the
    unsharded ``decode_attention`` on the same inputs, bfloat16 (the
    serving dtype: within one output spacing + FA_F32_ATOL) and float32
    (within MESH_F32_ATOL); the pieces are views of the cache; a shard
    with no live row gives exact zeros; both timed (CUDA events)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import decode_attention as DA
    from repro_torch.parallel.sharding import NamedSharding, shard_tensor

    cfg = M.get_config(SERVE_ARCH)
    B, S = SERVE_SLOTS, SERVE_MAX
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    q32 = torch.randn(B, H, Dh, generator=gen, device=dev)
    k32 = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev)
    v32 = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev)
    out = {}
    for shape in MESH_SHAPES:
        mesh = make_host_mesh(*shape, devices=MESH_DEVICES)
        spec = DA.cache_spec(mesh, B, S)
        rows = []
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            sh = NamedSharding(mesh, spec)
            ks, vs = shard_tensor(k, sh), shard_tensor(v, sh)
            views = all(p.untyped_storage().data_ptr()
                        == t.untyped_storage().data_ptr()
                        for t, st in ((k, ks), (v, vs))
                        for p in st.local_tensors())
            if not views:
                raise AssertionError("[mesh-cp] a piece on the repeated card "
                                     "is not a view of the cache")
            for pos in MESH_DECODE_POS:
                pos_t = torch.full((), pos, dtype=torch.int32, device=dev)
                want = DA.decode_attention(q, k, v, pos_t, scale=scale)
                got = DA.decode_attention(q, ks, vs, pos_t, scale=scale)
                if dt == torch.float32:
                    err = _max_abs_err(got, want)
                    ok, ulps = err <= MESH_F32_ATOL, float("nan")
                else:
                    ok, err, ulps = fa_within(got, want)
                row = {"dtype": str(dt), "pos": pos, "max_abs_err": err,
                       "ulps": ulps, "ok": ok}
                if dt == torch.bfloat16 and pos == MESH_DECODE_POS[-1]:
                    Sl = ks.block_shape[1]
                    b1 = ks.block((0, 1, 0, 0)), vs.block((0, 1, 0, 0))
                    _m, l1, o1 = DA._local_decode(
                        q[:ks.block_shape[0]], *b1, pos_t, scale,
                        global_offset=Sl, axis_names=("model",))
                    row["dead_shard_zero"] = not (l1.any() or o1.any())
                    if not row["dead_shard_zero"]:
                        raise AssertionError("[mesh-cp] a shard with no live "
                                             "row contributed non-zeros")
                if dt == torch.bfloat16:
                    row["ms"] = time_cuda(lambda: DA.decode_attention(
                        q, ks, vs, pos_t, scale=scale), MESH_DECODE_REPS)
                    row["whole_ms"] = time_cuda(lambda: DA.decode_attention(
                        q, k, v, pos_t, scale=scale), MESH_DECODE_REPS)
                rows.append(row)
                if not ok:
                    raise AssertionError(f"[mesh-cp] {shape} {dt} pos {pos}: "
                                         f"CP decode differs from the unsharded "
                                         f"one: {err} ({ulps} spacings)")
        out[str(shape)] = {"spec": repr(spec), "rows": rows}
        log(f"[mesh-cp] {shape} mesh on 4 x cuda:0, cache spec {spec}, q "
            f"({B}, {H}, {Dh}), cache ({B}, {S}, {Hkv}, {Dh}); against the "
            f"unsharded decode attention: "
            + "; ".join(f"{r['dtype'].split('.')[-1]} pos {r['pos']} max abs "
                        f"{r['max_abs_err']:.3e}"
                        + (f" ({r['ulps']:.2f} spacings), {r['ms']:.4f} ms "
                           f"against {r['whole_ms']:.4f} ms whole"
                           if "ms" in r else "") for r in rows)
            + f"; pieces are views; the dead shard contributes zeros; card {card}")
    return out


def mesh_ep_layer(card: str, dev) -> dict:
    """(b): one MoE layer of qwen3 at full width (bf16 weights, 128 experts
    top-8), 2048 tokens, EP on (1, 4) against ``impl="gspmd"``: the route
    equal, the output within MESH_EP_RTOL relative RMS per token, both
    timed (CUDA events) with their grouped-GEMM launches."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.common import cast_params
    from repro_torch.models.ffn import moe_ffn
    from repro_torch.parallel.sharding import mesh_context

    cfg = M.get_config(MESH_EP_ARCH).with_overrides(param_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    p = cast_params(moe_ffn.init(cfg, gen, dev), torch.bfloat16)
    x = torch.randn(1, SERVE_PROMPT, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    mesh = make_host_mesh(*MESH_EP_SHAPE, devices=MESH_DEVICES)
    routes = []
    route_fn = moe_ffn.route

    def spy(*a, **kw):
        out = route_fn(*a, **kw)
        routes.append(out)
        return out

    moe_ffn.route = staticmethod(spy)
    try:
        reset_launches()
        want, _ = moe_ffn.apply(cfg, p, x, impl="gspmd")
        n_plain = read_launches()["grouped_swiglu_mm"]
        reset_launches()
        with mesh_context(mesh):
            got, _ = moe_ffn.apply(cfg, p, x, impl="ep")
        n_ep = read_launches()["grouped_swiglu_mm"]
    finally:
        moe_ffn.route = staticmethod(route_fn)
    same_route = all(torch.equal(a, b) for a, b in zip(routes[0][:2],
                                                       routes[1][:2]))
    err = rel_rms(got[0], want[0])
    n_model = mesh.shape["model"]
    if not same_route:
        raise AssertionError("[mesh-ep] the EP route differs from gspmd's")
    if not float(err.max()) <= MESH_EP_RTOL:
        raise AssertionError(f"[mesh-ep] EP differs from gspmd: relative RMS "
                             f"{float(err.max())} > {MESH_EP_RTOL}")
    if (n_plain, n_ep) != (1, n_model):
        raise AssertionError(f"[mesh-ep] grouped GEMM launches {n_plain} / "
                             f"{n_ep}; expected 1 / {n_model}")
    with mesh_context(mesh):
        ep_ms = time_cuda(lambda: moe_ffn.apply(cfg, p, x, impl="ep"), 5)
    plain_ms = time_cuda(lambda: moe_ffn.apply(cfg, p, x, impl="gspmd"), 5)
    rec = {"tokens": SERVE_PROMPT, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "experts_per_shard": cfg.num_experts // n_model,
           "route_equal": same_route, "rel_rms_max": float(err.max()),
           "rel_rms_mean": float(err.mean()), "tol": MESH_EP_RTOL,
           "grouped_launches": {"gspmd": n_plain, "ep": n_ep},
           "ep_ms": ep_ms, "gspmd_ms": plain_ms}
    log(f"[mesh-ep] {MESH_EP_ARCH} one MoE layer, {SERVE_PROMPT} tokens, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, bf16, EP on "
        f"{MESH_EP_SHAPE} ({rec['experts_per_shard']} experts a shard): route "
        f"equal to gspmd's, output relative RMS max {rec['rel_rms_max']:.3e} "
        f"(mean {rec['rel_rms_mean']:.3e}, tolerance {MESH_EP_RTOL}); "
        f"{n_ep} grouped GEMM calls against {n_plain}; EP {ep_ms:.4f} ms, "
        f"gspmd {plain_ms:.4f} ms (CUDA events, mean of 5); card {card}")
    return rec


def mesh_lockstep(cfg, params, prompts: list, mesh, impl: str, tag: str,
                  exact_prefill: bool, tol: float, gate_tokens: bool) -> dict:
    """The mesh batcher against the plain one on the same weights and
    prompts, teacher-forced (after every admit and step the mesh
    batcher's tokens are overwritten with the plain one's): prefill logits
    (bit-equal where ``exact_prefill``: no EP, so the prefill is the same
    computation) and every active slot's decode logits within ``tol``
    relative RMS; greedy tokens compared wherever the plain logits' top-2
    gap exceeds ``tol`` times their RMS, required equal there if
    ``gate_tokens``."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import mesh_context

    a = serve.ContinuousBatcher(cfg, params, SERVE_SLOTS, SERVE_MAX, impl)
    with mesh_context(mesh):
        b = serve.ContinuousBatcher(cfg, params, SERVE_SLOTS, SERVE_MAX, impl)
    pre = {"a": [], "b": []}
    dec = {"a": [], "b": []}
    prefill_fn = T.prefill
    who = ["a"]

    def prefill_capture(*args, **kw):
        logits, caches = prefill_fn(*args, **kw)
        pre[who[0]].append(logits[0, -1].float())
        return logits, caches

    for name, bt in (("a", a), ("b", b)):
        fn = bt._decode

        def capture(toks, pos, fn=fn, name=name):
            logits, caches = fn(toks, pos)
            dec[name].append(logits[:, 0].float())
            return logits, caches

        bt._decode = capture
    n = len(prompts)
    queue, finished, actives = list(range(n)), [], []
    T.prefill = prefill_capture
    try:
        while len(finished) < n:
            while queue:
                who[0] = "a"
                if not a.admit(queue[0], prompts[queue[0]]):
                    break
                who[0] = "b"
                rid = queue.pop(0)
                if not b.admit(rid, prompts[rid]):
                    raise AssertionError(f"{tag} the mesh batcher refused "
                                         f"request {rid}")
                b.outputs[rid] = list(a.outputs[rid])
            actives.append(np.flatnonzero(a.active))
            a.step()
            b.step()
            for rid, toks in a.outputs.items():
                b.outputs[rid] = list(toks)
            done = a.retire(SERVE_GEN)
            if b.retire(SERVE_GEN) != done:
                raise AssertionError(f"{tag} the batchers retired differently")
            finished += done
    finally:
        T.prefill = prefill_fn
    pa, pb = torch.stack(pre["a"]), torch.stack(pre["b"])
    pre_err = float(rel_rms(pb, pa).max())
    errs, checked, agree = [], 0, 0
    for act, la, lb in zip(actives, dec["a"], dec["b"]):
        la, lb = la[act], lb[act]
        errs.append(rel_rms(lb, la))
        top2 = la.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        clear = gap > tol * la.pow(2).mean(-1).sqrt()
        same = la.argmax(-1) == lb.argmax(-1)
        checked += int(clear.sum())
        agree += int((same & clear).sum())
    err = torch.cat(errs)
    rec = {"prefill_rel_rms_max": pre_err,
           "prefill_bit_equal": bool(torch.equal(pa, pb)),
           "decode_rel_rms_max": float(err.max()),
           "decode_rel_rms_median": float(err.median()),
           "decode_rows": int(err.numel()), "tokens_checked": checked,
           "tokens_agree": agree, "tol": tol, "dtype": cfg.dtype}
    log(f"{tag} {cfg.dtype} teacher-forced against the plain batcher: "
        f"prefill logits "
        + ("bit-equal" if rec["prefill_bit_equal"] else
           f"relative RMS max {pre_err:.3e}")
        + f"; decode logits ({rec['decode_rows']} slot-steps) relative RMS max "
        f"{rec['decode_rel_rms_max']:.3e} (median "
        f"{rec['decode_rel_rms_median']:.3e}, tolerance {tol}); greedy tokens "
        f"equal at {agree}/{checked} slot-steps whose top-2 gap clears the "
        f"tolerance" + ("" if gate_tokens else " (reported, not held)"))
    if exact_prefill and not rec["prefill_bit_equal"]:
        raise AssertionError(f"{tag} the mesh prefill differs from the plain "
                             f"one ({pre_err})")
    if not (pre_err <= tol and rec["decode_rel_rms_max"] <= tol):
        raise AssertionError(f"{tag} mesh logits differ from the plain "
                             f"batcher's beyond {tol}")
    if gate_tokens and agree != checked:
        raise AssertionError(f"{tag} greedy tokens differ at "
                             f"{checked - agree} clear slot-steps")
    return rec


def mesh_serve(arch: str, tag: str, shape: tuple, impl: str, over: dict,
               f32: bool, serving: dict | None, card: str, dev) -> dict:
    """(c) / (d): ``arch`` at published widths (cut by ``over``), phase 11's
    weights seed, prompts and traffic, served by the plain batcher and by
    the batcher under a ``shape`` mesh on 4 x cuda:0 (times, tokens/s,
    peak memory, launches: one flash launch per attention layer per
    prefill, one grouped SwiGLU per MoE layer per prefill and decode step
    and shard); the mesh decode program against ``eager()``; the
    teacher-forced comparison (:func:`mesh_lockstep`) in bf16, and in
    float32 activations where ``f32``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import ShardedTensor

    cfg = M.get_config(arch).with_overrides(**over)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT)
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    mesh = make_host_mesh(*shape, devices=MESH_DEVICES)
    n_model = mesh.shape["model"] if impl == "ep" else 1
    log(f"{tag} {arch}: {cfg.num_layers} layers, {cfg.param_dtype} "
        f"parameters, moe_impl {impl}; phase 11's traffic, plain then on a "
        f"{shape} mesh of 4 x cuda:0 (every shard on the one card: no "
        f"transfer between cards)")
    plain, _, pb = serve_traffic(cfg, params, prompts, card, f"{tag} plain",
                                 moe_impl=impl)
    del pb
    gc.collect()
    torch.cuda.empty_cache()
    run, _, batcher = serve_traffic(cfg, params, prompts, card, f"{tag} mesh",
                                    mesh=mesh, moe_impl=impl)
    for what, r, shards in (("plain", plain, 1), ("mesh", run, n_model)):
        want = {**{k: 0 for k in r["launches"]},
                "flash_attention_wgmma": attention_layers(cfg) * SERVE_REQUESTS,
                "grouped_swiglu_mm": moe_layers(cfg) * shards
                * (SERVE_REQUESTS + r["decode_steps"])}
        if r["launches"] != want:
            raise AssertionError(f"{tag} {what} serving made launches "
                                 f"{ {k: v for k, v in r['launches'].items() if v} }"
                                 f"; expected { {k: v for k, v in want.items() if v} }")
    sharded = sum(isinstance(c.get("k"), ShardedTensor) for c in batcher.caches)
    if sharded != attention_layers(cfg):
        raise AssertionError(f"{tag} {sharded} sharded caches; expected one "
                             "per attention layer")
    prof = profile_serving(batcher, prompts, f"{tag} mesh")
    programs = compare_decode(batcher, card, f"{tag} mesh")
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    lock = {"bf16": mesh_lockstep(cfg, params, prompts, mesh, impl, tag,
                                  impl != "ep", MESH_LOGIT_RTOL, False)}
    if f32:
        gc.collect()
        torch.cuda.empty_cache()
        lock["f32"] = mesh_lockstep(cfg.with_overrides(dtype="float32"),
                                    params, prompts, mesh, impl, tag,
                                    impl != "ep", MESH_F32_LOGIT_RTOL, True)
    ratio = run["decode_ms_median"] / plain["decode_ms_median"]
    rec = {"arch": arch, "layers": cfg.num_layers, "mesh": list(shape),
           "moe_impl": impl, "plain": plain, "mesh_run": run,
           "profile": prof, "programs": programs, "lockstep": lock,
           "decode_ratio": ratio,
           "prefill_ratio": run["prefill_ms_median"] / plain["prefill_ms_median"]}
    ref11 = ""
    if serving is not None:
        ref11 = (f"; phase 11 (plain, earlier in this run): prefill "
                 f"{serving['prefill_ms_median']:.2f} ms, decode "
                 f"{serving['decode_ms_median']:.2f} ms, "
                 f"{serving['generated_tok_s']:.1f} tok/s, peak "
                 f"{serving['peak_mem_bytes'] / 2**30:.2f} GiB")
    log(f"{tag} mesh against plain: prefill {run['prefill_ms_median']:.2f} / "
        f"{plain['prefill_ms_median']:.2f} ms, decode "
        f"{run['decode_ms_median']:.2f} / {plain['decode_ms_median']:.2f} ms "
        f"({ratio:.2f}x), {run['generated_tok_s']:.1f} / "
        f"{plain['generated_tok_s']:.1f} tok/s, peak "
        f"{run['peak_mem_bytes'] / 2**30:.2f} / "
        f"{plain['peak_mem_bytes'] / 2**30:.2f} GiB{ref11}; card {card}")
    del params
    return rec


def run_model_mesh(serving: dict | None, card: str, dev) -> dict:
    """Phase 22: (a) the CP decode attention, (b) one EP MoE layer, (c)
    internlm2 served whole on a (2, 2) mesh, (d) qwen3 with EP on (1, 4),
    each mesh four shards on cuda:0."""
    t0 = time.perf_counter()
    out = {"cp_decode": mesh_cp_decode(card, dev),
           "ep_layer": mesh_ep_layer(card, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    for arch, tag, shape, impl, over, f32 in MESH_SERVE:
        out[arch] = mesh_serve(arch, tag, shape, impl, over, f32,
                               serving if arch == SERVE_ARCH else None,
                               card, dev)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[mesh-serve] phase 22 in {out['seconds']:.2f} s; card {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 23: training on the model mesh (four shards of the one card) and
# the dry run
# ---------------------------------------------------------------------------

# (a) qwen3-moe at full width cut to MESH_TRAIN_EP_LAYERS of 48 layers
# (3.12 B parameters), float32 master parameters, bf16 activations, remat,
# int8 AdamW, phase 20 (b)'s batches (TRAIN_B x TRAIN_S): EP on (1, 4)
# against the plain step (moe_impl "gspmd"), MESH_TRAIN_STEPS timed steps
# each.  The first MoE layer sees the same input in both, so its route
# must be equal; deeper, EP's other bf16 summation order flips the routes
# of near-tied tokens (random weights route many tokens to few experts),
# so the gradients are compared with EP on the plain step's routes
# (``forced_routes``), where only that order differs: phase 20 (a)'s bf16
# tolerances.
MESH_TRAIN_EP = ("qwen3-moe-30b-a3b", 4, (1, 4))
MESH_TRAIN_STEPS = 5
# (b) internlm2 whole, int8_ef on a ("pod", "data") = (2, 2) mesh, batches
# of MESH_INT8EF_B x TRAIN_S, MESH_INT8EF_STEPS steps, against the same
# steps uncompressed: the first loss (computed before any compression)
# within INT8EF_FIRST_RTOL, every loss within INT8EF_TRACK_RTOL (the
# reference's TestInt8EfMultiPod criteria).  The compression cell's
# outputs on the card's per-pod gradients (the leaves MESH_INT8EF_CELL
# names) bit-equal to the CPU's cell on the same inputs: it is IEEE
# arithmetic (an abs-max, a division, round half to even) on both.
MESH_INT8EF = ("internlm2-1.8b", (2, 2))
MESH_INT8EF_B, MESH_INT8EF_STEPS = 4, 4
INT8EF_FIRST_RTOL = 1e-5
INT8EF_TRACK_RTOL = 0.05
MESH_INT8EF_CELL = ("embedding.table", "lm_head.w", "final_norm.scale",
                    "layers.0.", "layers.23.")
# (c) the smoke configuration of internlm2, int8_ef on the same mesh, run
# MESH_RESUME_STEPS straight and preempted after half of them.
MESH_RESUME_STEPS = 4
# (d) the dry run's cells (tests/test_dryrun.py's), one process each.
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False),
                ("olmo-1b", "decode_32k", True),
                ("olmo-1b", "long_500k", False))
DRYRUN_TIMEOUT_S = 600


def pod_mesh():
    from repro_torch.launch.mesh import Mesh

    return Mesh(np.array(MESH_DEVICES, dtype=object).reshape(2, 2),
                ("pod", "data"))


def mesh_train_ep(card: str, dev) -> dict:
    """(a): qwen3 EP training on (1, 4) against the plain step: the first
    MoE layer's route equal (the deeper ones' share reported); on the
    plain step's routes, the loss and every gradient leaf within the bf16
    tolerances (TRAIN_BF16_GRAD_RTOL for every leaf) and every routed
    expert (and no other) with a gradient;
    MESH_TRAIN_STEPS timed steps each, on their own routes, with their
    launches and peak memory."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    arch, layers, shape = MESH_TRAIN_EP
    tag = "[train-mesh-ep]"
    t_start = time.perf_counter()
    cfg = M.get_config(arch).with_overrides(num_layers=layers,
                                            param_dtype="float32")
    torch.cuda.empty_cache()
    # What earlier phases still hold: the peaks below are reported less it.
    held = torch.cuda.memory_allocated()
    params = TS.trainable(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    predicted = predicted_train_bytes(cfg, n_params)
    mesh = make_host_mesh(*shape, devices=MESH_DEVICES)
    n_model = mesh.shape["model"]
    pipe = TokenPipeline(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
    batch = TS.batch_to_device(pipe.next_batch(), dev)
    opt = O.adamw(quantized=True)
    sched = O.warmup_cosine(TRAIN_LR, 0, 2 * MESH_TRAIN_STEPS + 1)
    steps = {"plain": TS.build_train_step(cfg, opt, sched, moe_impl="gspmd"),
             "ep": TS.build_train_step(cfg, opt, sched, moe_impl="ep",
                                       mesh=mesh)}
    log(f"{tag} {arch}: {layers} of 48 layers at full width, {n_params:,} "
        f"float32 parameters, bf16 activations, remat, int8 AdamW, batch "
        f"{TRAIN_B} x {TRAIN_S}; EP on a {shape} mesh of 4 x cuda:0 "
        f"({cfg.num_experts // n_model} experts a shard) against the plain "
        f"step; predicted peak {predicted['total'] / 2**30:.2f} GiB before "
        "activations")
    # The plain step records its routes; EP recomputes its own (their
    # share of equal tokens reported, the first MoE layer's required equal)
    # and takes the plain step's, so that the gradients differ only by
    # EP's bf16 summation order.
    routes = {"plain": [], "ep": []}
    grads, mets, launches = {}, {}, {}
    for name in ("plain", "ep"):
        reset_launches()
        spy = (recorded_routes(routes["plain"]) if name == "plain"
               else forced_routes(routes["plain"], routes["ep"]))
        with spy, mesh_context(mesh if name == "ep" else None):
            grads[name], mets[name] = steps[name].grads_and_metrics(params,
                                                                    batch)
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in read_launches().items() if v}
    first_equal = torch.equal(routes["plain"][0], routes["ep"][0])
    deeper = [route_share(a, b) for a, b in zip(routes["plain"][1:layers],
                                                routes["ep"][1:layers])]
    loss = {k: float(m["loss"]) for k, m in mets.items()}
    loss_err = abs(loss["ep"] - loss["plain"]) / abs(loss["plain"])
    grad_err = {n: leaf_rel_rms(grads["ep"][n], grads["plain"][n])
                for n in grads["plain"]}
    # On the plain step's routes no route flips, so no leaf needs the
    # routed tolerance (bf16_grad_tol): every leaf, the experts' and the
    # router's too, is held to TRAIN_BF16_GRAD_RTOL.
    worst = max(grad_err, key=grad_err.get)
    # Every expert with tokens receives a gradient, and no other: by the
    # routes both steps took (the forward's, one a layer).
    reach = {}
    for layer, top_i in enumerate(routes["plain"][:layers]):
        routed = torch.zeros(cfg.num_experts, dtype=torch.bool)
        routed[top_i.flatten()] = True
        for leaf in ("w_gate", "w_up", "w_down"):
            n = f"layers.{layer}.ffn.experts.{leaf}"
            for name in ("plain", "ep"):
                got = (grads[name][n].flatten(1).abs().amax(dim=1) > 0).cpu()
                reach[(name, n)] = int((got != routed).sum())
        reach[("routed", layer)] = int(routed.sum())
    unreached = {f"{k[0]} {k[1]}": v for k, v in reach.items()
                 if k[0] != "routed" and v}
    del grads
    gc.collect()
    want = {"flash_attention_wgmma": 2 * layers}
    diag = (f"first route equal {first_equal}, deeper routes' shares "
            f"{[round(d, 5) for d in deeper]}, loss {loss_err} (tol "
            f"{TRAIN_BF16_LOSS_RTOL}), worst gradient {worst} {grad_err[worst]} "
            f"(tol {TRAIN_BF16_GRAD_RTOL}; the largest "
            f"{[(n, round(e, 5)) for n, e in sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]]}), "
            f"experts whose gradient disagrees with their routing {unreached}, "
            f"launches {launches}")
    if (not first_equal or loss_err > TRAIN_BF16_LOSS_RTOL
            or grad_err[worst] > TRAIN_BF16_GRAD_RTOL or unreached
            or launches["plain"] != dict(want, grouped_swiglu_mm=2 * layers)
            or launches["ep"] != dict(want,
                                      grouped_swiglu_mm=2 * layers * n_model)):
        raise AssertionError(f"{tag} EP against plain: {diag}")
    log(f"{tag} gradients, EP on the plain step's routes: loss EP "
        f"{loss['ep']:.6f} / plain {loss['plain']:.6f}; {diag}; experts "
        f"routed a layer {[reach[('routed', i)] for i in range(layers)]} of "
        f"{cfg.num_experts}, each with a gradient in both steps and no other")
    state = TS.init_train_state(cfg, opt, None, params=params)
    del params
    runs = {}
    for name in ("plain", "ep"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times, losses = [], []
        for _ in range(MESH_TRAIN_STEPS):
            b = TS.batch_to_device(pipe.next_batch(), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[name](state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        step_s = float(np.median(times[1:]))
        runs[name] = {"step_s": times, "step_s_median": step_s,
                      "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                      "losses": losses,
                      "peak_bytes": torch.cuda.max_memory_allocated() - held,
                      "launches": {k: v for k, v in read_launches().items()
                                   if v}}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag} {name} losses {losses}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"arch": arch, "layers": layers, "mesh": list(shape),
           "params": n_params, "batch": [TRAIN_B, TRAIN_S],
           "loss": loss, "loss_rel_err": loss_err,
           "grad_rel_rms_max": grad_err[worst], "grad_worst_leaf": worst,
           "grad_rel_rms": grad_err, "first_route_equal": first_equal, "deeper_route_equal": deeper,
           "grad_launches": launches, "runs": runs, "predicted_bytes": predicted,
           "held_by_earlier_phases_bytes": held,
           "seconds": time.perf_counter() - t_start}
    log(f"{tag} {MESH_TRAIN_STEPS} steps each (median after the first, host "
        f"clock around a step ending in a synchronize): plain "
        f"{1e3 * runs['plain']['step_s_median']:.1f} ms "
        f"({runs['plain']['tokens_per_s']:,.0f} tokens/s, peak "
        f"{runs['plain']['peak_bytes'] / 2**30:.2f} GiB), EP "
        f"{1e3 * runs['ep']['step_s_median']:.1f} ms "
        f"({runs['ep']['tokens_per_s']:,.0f} tokens/s, peak "
        f"{runs['ep']['peak_bytes'] / 2**30:.2f} GiB; peaks less the "
        f"{held / 2**30:.2f} GiB earlier phases hold); predicted "
        f"{predicted['total'] / 2**30:.2f} GiB before activations; launches "
        f"plain {runs['plain']['launches']}, EP {runs['ep']['launches']}; "
        f"card {card}")
    return rec


def mesh_train_int8ef(card: str, dev) -> dict:
    """(b): internlm2 whole with int8_ef across the two pods of a (2, 2)
    mesh against the same steps uncompressed; the compression cell on the
    card's per-pod gradients against the CPU's cell; times and peak
    memory against the reckoned peak."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    arch, shape = MESH_INT8EF
    tag = "[train-mesh-int8ef]"
    t_start = time.perf_counter()
    cfg = M.get_config(arch).with_overrides(param_dtype="float32")
    mesh = pod_mesh()
    pipe = TokenPipeline(cfg, batch=MESH_INT8EF_B, seq=TRAIN_S, seed=SEED)
    batches = [pipe.next_batch() for _ in range(MESH_INT8EF_STEPS)]
    opt = O.adamw(weight_decay=0.01, quantized=True)
    sched = O.warmup_cosine(TRAIN_LR, 2, 20)
    runs, cell = {}, {}
    for comp in (None, "int8_ef"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' leftovers
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
        n = sum(p.numel() for p in params.parameters())
        state = TS.init_train_state(cfg, opt, None, params=params,
                                    compression=comp, mesh=mesh)
        del params
        step = TS.build_train_step(cfg, opt, sched, compression=comp, mesh=mesh)
        spy_ctx = contextlib.nullcontext()
        if comp:
            spy_ctx = spy_compression(state, cell)
        reset_launches()
        times, losses = [], []
        for i, b in enumerate(batches):
            b = TS.batch_to_device(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (spy_ctx if i == 0 else contextlib.nullcontext()):
                state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        key = comp or "uncompressed"
        runs[key] = {"step_s": times, "losses": losses,
                     # Step 0 carries the cell's capture (int8_ef).
                     "step_s_median": float(np.median(times[1:])),
                     "peak_bytes": torch.cuda.max_memory_allocated() - held,
                     "held_by_earlier_phases_bytes": held,
                     "launches": {k: v for k, v in read_launches().items() if v}}
        if comp:
            runs[key]["residual_abs_max"] = max(
                float(e.abs().max()) for pod in state.err_fb
                for e in pod.values())
        del state
        gc.collect()
    predicted = {"params": 4 * n, "moments": 2 * n, "residuals": 8 * n,
                 "one_pod_grads": 4 * n, "code_sums": 4 * n, "total": 22 * n}
    l_c, l_u = runs["int8_ef"]["losses"], runs["uncompressed"]["losses"]
    first_err = abs(l_c[0] - l_u[0]) / abs(l_u[0])
    track = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_u))
    cell_equal = all(cell[k]["equal"] for k in cell)
    # Forward and remat a layer a step; int8_ef runs them once a pod.
    per_run = 2 * cfg.num_layers * MESH_INT8EF_STEPS
    bad_launch = [k for k, r in runs.items() if r["launches"] != {
        "flash_attention_wgmma": per_run * (2 if k == "int8_ef" else 1)}]
    if (first_err > INT8EF_FIRST_RTOL or track > INT8EF_TRACK_RTOL
            or not cell_equal or not cell or bad_launch
            or not runs["int8_ef"]["residual_abs_max"] > 0):
        raise AssertionError(
            f"{tag} first loss rel {first_err} (tol {INT8EF_FIRST_RTOL}), "
            f"losses within {track} (tol {INT8EF_TRACK_RTOL}), cell bit-equal "
            f"{ {k: c['equal'] for k, c in cell.items()} }, launches "
            f"{ {k: r['launches'] for k, r in runs.items()} }")
    rec = {"arch": arch, "mesh": {"pod": 2, "data": 2}, "params": n,
           "batch": [MESH_INT8EF_B, TRAIN_S], "runs": runs,
           "first_loss_rel_err": first_err, "loss_track_max": track,
           "cell": cell,
           "predicted_bytes": predicted,
           "seconds": time.perf_counter() - t_start}
    log(f"{tag} {arch} whole ({n:,} parameters), int8_ef on a (pod 2, data 2) "
        f"mesh of 4 x cuda:0, batch {MESH_INT8EF_B} x {TRAIN_S} (a pod's block "
        f"{MESH_INT8EF_B // 2} x {TRAIN_S}), {MESH_INT8EF_STEPS} steps: losses "
        f"{[round(l, 5) for l in l_c]} against uncompressed "
        f"{[round(l, 5) for l in l_u]} (first rel {first_err:.2e}, tol "
        f"{INT8EF_FIRST_RTOL}; all within {track:.2e}, tol {INT8EF_TRACK_RTOL}); "
        f"the cell on {len(cell)} captured (pod, leaf) inputs bit-equal to the "
        f"CPU's (codes, scales, residuals); step "
        f"{1e3 * runs['int8_ef']['step_s_median']:.1f} ms against "
        f"{1e3 * runs['uncompressed']['step_s_median']:.1f} uncompressed "
        f"(median of steps 2-{MESH_INT8EF_STEPS}); peak "
        f"{runs['int8_ef']['peak_bytes'] / 2**30:.2f} GiB (reckoned "
        f"{predicted['total'] / 2**30:.2f} GiB before activations: one pod's "
        f"gradients alive) against {runs['uncompressed']['peak_bytes'] / 2**30:.2f}"
        f" uncompressed (peaks less the {held / 2**30:.2f} GiB earlier phases "
        f"hold); card {card}")
    return rec


@contextlib.contextmanager
def spy_compression(state, cell: dict):
    """While entered, each call of ``train_step.compress_residual`` on a
    leaf MESH_INT8EF_CELL names is recorded: its inputs and outputs copied
    to the host, and the CPU's cell run on the inputs
    (``cell[(pod, leaf)]["equal"]``: codes, scales and new residual
    bit-equal)."""
    from repro_torch.train import train_step as TS

    owner = {id(e): (p, name) for p, pod in enumerate(state.err_fb)
             for name, e in pod.items()
             if any(name == w or (w.endswith(".") and name.startswith(w))
                    for w in MESH_INT8EF_CELL)}
    real = TS.compress_residual

    def spy(g, e):
        who = owner.get(id(e))
        if who is None:
            return real(g, e)
        g_cpu, e_cpu = g.to("cpu", copy=True), e.to("cpu", copy=True)
        q, safe = real(g, e)
        q2, safe2 = real(g_cpu, e_cpu)
        cell[f"pod{who[0]}:{who[1]}"] = {"numel": g.numel(),
                     "equal": bool(torch.equal(q.cpu(), q2)
                                   and torch.equal(safe.cpu(), safe2)
                                   and torch.equal(e.cpu(), e_cpu)),
                     "codes_equal": bool(torch.equal(q.cpu(), q2))}
        return q, safe

    with _patched(TS, "compress_residual", spy):
        yield


def mesh_train_resume(card: str, dev) -> dict:
    """(c): the smoke configuration with int8_ef on the (2, 2) pod mesh,
    MESH_RESUME_STEPS steps straight, and preempted after half of them:
    checkpointed, restored with ``shardings=`` into a fresh state and
    resumed; parameters, moments and every pod's residual bit-equal.  Then
    ``python -m repro_torch.launch.train --mesh host`` on the card."""
    import tempfile

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.tree import named_leaves

    tag = "[train-mesh-resume]"
    t_start = time.perf_counter()
    cfg = M.get_config(MESH_INT8EF[0], smoke=True)
    mesh = pod_mesh()
    pipe = TokenPipeline(cfg, batch=4, seq=32, seed=SEED)
    batches = [TS.batch_to_device(pipe.next_batch(), dev)
               for _ in range(MESH_RESUME_STEPS)]
    opt = O.adamw(weight_decay=0.01, quantized=True)
    step = TS.build_train_step(cfg, opt, O.warmup_cosine(1e-2, 0, 10),
                               compression="int8_ef", mesh=mesh)

    def fresh():
        return TS.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(SEED),
            compression="int8_ef", device=dev, mesh=mesh)

    reset_launches()
    straight = fresh()
    for b in batches:
        straight, _ = step(straight, b)
    half = MESH_RESUME_STEPS // 2
    first = fresh()
    for b in batches[:half]:
        first, _ = step(first, b)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as work:
        ckpt.save(work, half, first)
        like = fresh()
        resumed, _ = ckpt.restore(work, half, like,
                                  shardings=TS.state_shardings(like, mesh))
    for b in batches[half:]:
        resumed, _ = step(resumed, b)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    a, b = named_leaves(straight), named_leaves(resumed)
    unequal = [pa for (pa, x), (pb, y) in zip(a, b)
               if pa != pb or not torch.equal(x, y)]
    if unequal or len(a) != len(b):
        raise AssertionError(f"{tag} resumed run differs from the "
                             f"uninterrupted one at {unequal[:5]}")
    n_resid = sum(1 for pa, _ in a if pa[0] == "err_fb")
    # The launcher on the card: --mesh host (every visible card).
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         MESH_INT8EF[0], "--smoke", "--steps", "4", "--batch", "4", "--seq",
         "32", "--log-every", "1", "--mesh", "host", "--compression", "int8_ef",
         "--quantized-opt"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=LAUNCH_TIMEOUT_S)
    launcher_s = time.perf_counter() - t0
    n_cards = torch.cuda.device_count()
    mesh_line = f"mesh={{'data': {n_cards}, 'model': 1}}"
    if proc.returncode != 0 or mesh_line not in proc.stdout \
            or "done: 4 steps" not in proc.stdout:
        raise AssertionError(f"{tag} train --mesh host exited {proc.returncode}: "
                             f"{proc.stdout[-800:]} {proc.stderr[-1500:]}")
    rec = {"steps": MESH_RESUME_STEPS, "preempted_after": half,
           "leaves": len(a), "residual_leaves": n_resid, "bit_equal": True,
           "launches": launches, "launcher_s": launcher_s,
           "launcher_tail": proc.stdout.splitlines()[-3:],
           "seconds": time.perf_counter() - t_start}
    log(f"{tag} {cfg.name} smoke, int8_ef on (pod 2, data 2) of 4 x cuda:0: "
        f"{MESH_RESUME_STEPS} steps straight against {half} + checkpoint + "
        f"restore(shardings=) + {MESH_RESUME_STEPS - half}: all {len(a)} "
        f"leaves bit-equal ({n_resid} of them the two pods' residuals); "
        f"launches {launches}; train --mesh host ({mesh_line}) in "
        f"{launcher_s:.1f} s: {proc.stdout.splitlines()[-1]}; card {card}")
    return rec


def start_dryrun() -> list:
    """(d): ``python -m repro_torch.launch.dryrun`` on each DRYRUN_CELLS
    cell, one process each, started together (CPU only: the cells are
    traced on the meta device)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        args = ["--arch", arch, "--shape", shape, "--force", "--tag", "smoke"]
        procs.append(((arch, shape, multi), time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             *(["--multi-pod"] if multi else [])], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)))
    return procs


def finish_dryrun(procs: list, card: str) -> dict:
    """(d): each cell's exit, its report and the reference test's
    assertions where the port's design allows them."""
    from repro_torch.launch import dryrun as D

    out = {}
    try:
        for (arch, shape, multi), t0, proc in procs:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"[dryrun] {arch} {shape} exited "
                                     f"{proc.returncode}: {stderr[-1500:]}")
            with open(D.cell_path(arch, shape, multi, "smoke")) as f:
                rep = json.load(f)
            label = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"
            out[label] = dict(rep, wall_s=wall)
    finally:
        for _, _, proc in procs:
            proc.kill()
    train = out["internlm2-1.8b__train_4k__16x16"]
    decode = out["olmo-1b__decode_32k__2x16x16"]
    skip = out["olmo-1b__long_500k__16x16"]
    ok = (train["status"] == "ok" and train["mesh"] == {"data": 16, "model": 16}
          and train["cost_analysis"]["flops"] > 1e12
          and train["param_bytes_per_device"] < 40e6
          and train["num_collectives"] == 0
          and decode["status"] == "ok"
          and decode["mesh"] == {"pod": 2, "data": 16, "model": 16}
          and decode["collectives"]["all-reduce"]["count"] > 0
          and skip["status"] == "skipped" and "sub-quadratic" in skip["reason"])
    if not ok:
        raise AssertionError(f"[dryrun] reports: {out}")
    for label, rep in out.items():
        words = (f"{rep['status']}, traced in {rep.get('trace_s')} s "
                 f"(process {rep['wall_s']:.1f} s), flops "
                 f"{rep['cost_analysis']['flops']:.4e}, param bytes/device "
                 f"{rep['param_bytes_per_device']:,.0f}, argument bytes/device "
                 f"{rep['memory_analysis']['argument_size_in_bytes']:,.0f} "
                 f"(first device {rep['memory_analysis']['first_device_argument_bytes']:,.0f}), "
                 f"collectives {rep['collectives']}"
                 if rep["status"] == "ok" else f"skipped ({rep['reason']})")
        log(f"[dryrun] {label}: {words}")
    return out


def run_train_mesh(card: str, dev) -> dict:
    """Phase 23: (d)'s dry-run processes started, then (a) EP training,
    (b) int8_ef across pods, (c) the preempted mesh run, and (d)'s
    reports, the card freed between them."""
    t0 = time.perf_counter()
    procs = start_dryrun()
    try:
        out = {"ep": mesh_train_ep(card, dev)}
        gc.collect()
        torch.cuda.empty_cache()
        out["int8_ef"] = mesh_train_int8ef(card, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["resume"] = mesh_train_resume(card, dev)
        out["dryrun"] = finish_dryrun(procs, card)
    finally:
        for *_, proc in procs:
            proc.kill()  # a no-op once it has exited
    out["seconds"] = time.perf_counter() - t0
    log(f"[train-mesh] phase 23 in {out['seconds']:.2f} s; card {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the launch-shape autotuner
# ---------------------------------------------------------------------------

TUNE_ENV = ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")


@contextlib.contextmanager
def tuning(mode: str, path: str):
    """``REPRO_AUTOTUNE=mode`` with the cache at ``path`` for the block
    and the tuner's memo cleared on entry and on exit; both variables are
    put back as they were found (a variable that was unset is unset
    again), which the block's end checks."""
    from repro_torch.kernels import autotune

    saved = {k: os.environ.get(k) for k in TUNE_ENV}
    os.environ.update({"REPRO_AUTOTUNE": mode, "REPRO_AUTOTUNE_CACHE": path})
    autotune.clear_memo()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.clear_memo()
    if {k: os.environ.get(k) for k in TUNE_ENV} != saved or autotune._memo:
        raise AssertionError("the tuning environment was not put back")


def cache_entries(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)["entries"]


def tune_body(name: str, ladder, default: int, cases: list, path: str,
              card: str) -> dict:
    """Phase 24 (a) for one tuned body, in ``on`` mode: each case is
    ``(label, run)``, ``run(rung)`` the body's outputs at that rung on
    one of the main path's input sets.  Every rung bit-equal to the
    default rung on every case, each rung timed on the first case (CUDA
    events); then the first case with ``rung=None`` sweeps (one sweep, one
    new cache entry), and its output, at the winner, bit-equal too."""
    from repro_torch.kernels import autotune

    wants = []
    for label, run in cases:
        want = run(default)
        for rung in ladder:
            bit_equal(f"{name} rung {rung} on {label}", run(rung), want)
        wants.append(want)
    ms = {str(r): time_cuda(lambda r=r: cases[0][1](r), 10) for r in ladder}
    before, sweeps, launches = (set(cache_entries(path)), autotune.sweeps,
                                autotune.sweep_launches)
    got = cases[0][1](None)
    new = [k for k in cache_entries(path) if k not in before]
    if autotune.sweeps != sweeps + 1 or len(new) != 1:
        raise AssertionError(f"{name}: {autotune.sweeps - sweeps} sweeps and "
                             f"new cache entries {new}; expected one of each")
    entry = cache_entries(path)[new[0]]
    bit_equal(f"{name} at its winner {entry['block']}", got, wants[0])
    row = {"body": name, "key": new[0], "ladder": list(ladder),
           "default": default, "winner": entry["block"],
           "sweep_ms": {r: 1e3 * s for r, s in entry["seconds"].items()},
           "main_path_ms": ms, "cases": [label for label, _ in cases],
           "sweep_launches": autotune.sweep_launches - launches}
    log(f"[autotune] {name} ({new[0]}): sweep ms "
        f"{ {r: round(t, 4) for r, t in row['sweep_ms'].items()} }; on "
        f"{cases[0][0]} ms { {r: round(t, 4) for r, t in ms.items()} }; "
        f"winner {row['winner']}, default {default}; every rung bit-equal on "
        f"{len(cases)} input sets; {row['sweep_launches']} sweep launches "
        f"(uncounted); card {card}")
    return row


def read_back(rows: list, path: str, checks: list) -> dict:
    """Phase 24 (b), in ``auto`` mode after ``clear_memo()``: each check
    ``(label, fn, want)`` runs with the tuned rungs (read from the cache,
    no sweep) and must give ``want`` exactly; the tuner's memo then holds
    each body's winner; launches counted as usual."""
    from repro_torch.kernels import autotune

    sweeps = autotune.sweeps
    reset_launches()
    for label, fn, want in checks:
        if isinstance(want, list):  # ranked results
            if [flat_results(r) for r in fn()] != want:
                raise AssertionError(f"{label} with the tuned rungs differs "
                                     "from the untuned pass")
        else:
            bit_equal(f"{label} with the tuned rungs", fn(), want)
    torch.cuda.synchronize()
    launches = read_launches()
    if autotune.sweeps != sweeps:
        raise AssertionError(f"{autotune.sweeps - sweeps} sweeps in auto mode")
    memo = {"|".join(map(str, k)): v for k, v in autotune._memo.items()}
    for row in rows:
        if memo.get(row["key"]) != row["winner"]:
            raise AssertionError(f"{row['key']} read back {memo.get(row['key'])}"
                                 f", not the winner {row['winner']}")
    log(f"[autotune] read back in auto mode after clear_memo(): "
        f"{[(r['body'], r['winner']) for r in rows]}, 0 sweeps; "
        f"{[label for label, _, _ in checks]} bit-equal to the untuned "
        f"results; launches {({k: v for k, v in launches.items() if v})}")
    return {"launches": launches, "checks": [label for label, _, _ in checks]}


def program_of(fn, n_out: int, anchor: torch.Tensor):
    """A fresh compiled program around ``fn`` (three tensors in, a tuple
    of ``n_out`` tensors out), so that its capture takes the tuned rungs.
    ``anchor`` is a resident argument it never reads: once the caller
    drops it, the program is stale and the next capture destroys it, so
    that it does not hold the stream's graph memory pool for the phases
    after it."""
    from repro_torch import compile as programs

    def body(a, b, c, anchor):
        out = fn(a, b, c)
        return tuple(out[i] for i in range(n_out))

    prog = programs.program(body, resident=("anchor",))
    return lambda *inputs: prog(*inputs, anchor)


def replayed(fn, *inputs):
    """``fn``'s second call: the first builds (warm-up and capture), the
    second replays the captured graph."""
    fn(*inputs)
    return fn(*inputs)


def run_autotune(index, batches, seen: list, fence: list, card: str,
                 dev) -> dict:
    """Phase 24 (after phase 12): with ``REPRO_AUTOTUNE=on`` and a
    temporary cache, (a) each tuned body on the main path's inputs: the
    staged ``radius_counts`` body on phase 5's captured launches, the
    ``pairwise_cheb`` body on phase 8's fence launches and a
    materialized chunk of phase 5's samples, the staged two-op bodies on
    phase 12's calls; then (b) in ``auto`` mode: a warm ``query_many``
    pass under ``eager()`` equal to the same pass untuned (``off``), a
    fresh compiled program around ``knn_radius_counts`` replayed on each
    captured launch, phase 12's ``knn_with_counts`` (also padded to
    TWO_OP_PAD_P, through the tiled bodies, which take no rung) and the
    fence's ``pairwise_cheb`` through the
    public ops, all bit-equal to the untuned outputs."""
    import tempfile

    from repro_torch import compile as programs
    from repro_torch.core import estimators as est
    from repro_torch.kernels.knn_stats import kernel, ops
    from repro_torch.kernels.pairwise_cheb import kernel as pc
    from repro_torch.kernels.pairwise_cheb import ops as pc_ops

    t0 = time.perf_counter()
    padded = [tuple(pad_columns(t, TWO_OP_PAD_P, f) for t, f in
                    ((x, 0.0), (y, 0.0), (m, False))) for x, y, m, _, _ in seen]
    x0, _, m0, a0, _ = seen[0]
    chunk = min(x0.shape[0], est._MATERIALIZED_ELEMS // (x0.shape[1] ** 2))
    cheb_in = [("the fence's launch " + str(i), f) for i, f in enumerate(fence)]
    cheb_in.append(("a materialized chunk", (x0[:chunk].contiguous(),
                                             seen[0][1][:chunk].contiguous(),
                                             m0[:chunk].contiguous())))

    def rc(body, x, y, m, args):
        return lambda g: body(x, y, m, **args, rung=g)

    def two_op(knn_body, bc_body, x, y, m, args, r):
        return lambda g: (*knn_body(x, y, m, kb=args["kb"], mode=args["mode"],
                                    rung=g),
                          bc_body(x, y, m, r, which=args["which"], rung=g))

    def label(x, args, P):
        return f"{args['mode']}/{args['which']} B={x.shape[0]} P={P}"

    specs = [
        ("radius_counts_staged", kernel.STAGED_WARPS,
         [(f"phase 5's {label(x, a, x.shape[1])}",
           rc(kernel.radius_counts_staged, x, y, m, a))
          for x, y, m, a, _ in seen]),
        ("knn_two_op_staged", kernel.STAGED_WARPS,
         [(f"phase 12's {label(x, a, x.shape[1])}",
           two_op(kernel.knn_smallest_staged, kernel.ball_counts_staged,
                  x, y, m, a, out[0]))
          for x, y, m, a, out in seen]),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune_cache.json")
        with tuning("on", path):
            rows = [tune_body(name, ladder, kernel.TUNED[name][1], cases, path,
                              card) for name, ladder, cases in specs]
            rows.append(tune_body(
                "pairwise_cheb", pc.ROW_STEPS, pc.ROW_STEP_DEFAULT,
                [(lab, lambda g, f=f: pc.pairwise_cheb(*f, rung=g))
                 for lab, f in cheb_in], path, card))
            cheb_want = [pc.pairwise_cheb(*f, rung=pc.ROW_STEP_DEFAULT)
                         for _, f in cheb_in[:len(fence)]]

        def query_pass():
            with programs.eager():
                return run_pass(index, batches, dev)[1]

        def fused(x, y, m, args):
            r, cnt, c = ops.knn_radius_counts(x, y, m, k=args["k"],
                                              k_max=args["kb"], kk=args["kk"],
                                              mode=args["mode"],
                                              which=args["which"])
            return r, cnt, torch.stack(tuple(c))

        def with_counts(x, y, m, args):
            knn, cnt, c = ops.knn_with_counts(
                x, y, m, k=args["k"], k_max=args["kb"], mode=args["mode"],
                which=args["which"], radius=radius_rule(args, m))
            return radius_rule(args, m)(knn, cnt), cnt, torch.stack(tuple(c))

        with tuning("off", path):
            untuned = [flat_results(w) for w in query_pass()]
        checks = [("warm query_many (eager)", query_pass, untuned)]
        anchor = torch.empty(1, device=dev)
        for i, ((x, y, m, a, out), pad) in enumerate(zip(seen, padded)):
            prog = program_of(lambda x, y, m, a=a: fused(x, y, m, a), 3, anchor)
            checks.append((f"a replayed program of knn_radius_counts ({i})",
                           lambda p=prog, x=x, y=y, m=m: replayed(p, x, y, m),
                           out))
            checks.append((f"knn_with_counts ({i})",
                           lambda x=x, y=y, m=m, a=a: with_counts(x, y, m, a),
                           out))
            checks.append((f"knn_with_counts padded to P={TWO_OP_PAD_P} ({i})",
                           lambda pad=pad, a=a, P=x.shape[1]: tuple(
                               t[..., :P] for t in with_counts(*pad, a)),
                           out))
        for (lab, f), want in zip(cheb_in, cheb_want):
            checks.append((f"pairwise_cheb on {lab}",
                           lambda f=f: pc_ops.pairwise_cheb(*f), want))
        with tuning("auto", path):
            back = read_back(rows, path, checks)
        del checks, anchor  # the programs' anchors: stale from here on
    rec = {"rows": rows, **back, "s": time.perf_counter() - t0}
    log(f"[autotune] {len(rows)} bodies in {rec['s']:.2f} s; card {card}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import compile as programs
    from repro_torch.convert import index_from_numpy
    from repro_torch.core.discovery import DiscoveryService
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.knn_stats import kernel
    from repro_torch.kernels.murmur3 import kernel as mm_kernel
    from repro_torch.kernels.pairwise_cheb import kernel as pc_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # Full float32 in the plain versions' products (PyTorch's defaults,
    # set here so that no reference check runs in TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernel.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc}")
    if sys.argv[1:2] == ["--time-flash-basic"]:
        print(json.dumps({"flash_basic_ab": time_flash_basic_sources(
            sys.argv[2:], card, dev)}))
        print(card)
        return 0
    log(f"[env] torch._grouped_mm (the MoE layers' grouped GEMM): "
        f"{'present' if hasattr(torch, '_grouped_mm') else 'missing'}")
    # One nvcc per source, started together.
    loaders = {"radius_counts": kernel.load_library,
               "knn_two_op": kernel.load_two_op_library,
               "pairwise_cheb": pc_kernel.load_library,
               "flash_attention": fa_kernel.load_library,
               "flash_attention_wgmma": fa_kernel.load_wgmma_library,
               "murmur3_fib": mm_kernel.load_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        futures = {name: pool.submit(fn) for name, fn in loaders.items()}
        builds = {name: f.result() for name, f in futures.items()}
    t_build = time.perf_counter() - t0
    for name, b in builds.items():
        log(f"[build] {name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.ptxas.splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill",
                                       "setmaxnreg", "warning")):
                log(f"[build] {line.strip()}")
    log(f"[build] all {len(builds)} sources built in {t_build:.2f} s")

    # Phase 2: kernels vs plain, bit-equal, on synthetic edge cases.
    max_err = check_radius_counts(dev)
    pc_max_err = check_pairwise_cheb(dev)
    fa_err = check_flash_attention(dev)
    fa_err["flash_attention_wgmma"] = max(fa_err["flash_attention_wgmma"],
                                          check_flash_serving_layouts(dev))
    two_op_err = check_knn_two_op(dev)
    hash_err = check_hash_keys(dev)
    # Phase 12 (c) runs here, before the lake exists: its plain versions at
    # P = 40,000 take ~30 GB, which phase 12 proper no longer has free.
    two_op_sweep = run_two_op_sweep(card, dev)
    torch.cuda.empty_cache()

    # Phase 3: main path at lake scale.
    t0 = time.perf_counter()
    rows, keys, y, edges, planted_c, planted_d = make_corpus(C_MAIN)
    cont, disc = make_queries(keys, y, edges, Q)
    index = build_index(rows, dev)
    t_ingest = time.perf_counter() - t0
    log(f"[main] corpus C={len(index)} built and added in {t_ingest:.2f} s")

    # The first plan per target dtype flushes the host sketches into the
    # device stores; timed apart from the queries.
    t0 = time.perf_counter()
    index.plan(False)
    index.plan(True)
    sync(dev)
    t_flush = time.perf_counter() - t0
    log(f"[main] device flush of {len(index)} candidates x 2 dtypes: "
        f"{t_flush:.2f} s")

    reset_launches()
    c0 = programs.compile_stats()
    t_cold, cold = run_pass(index, [cont, disc], dev)
    c1 = programs.compile_stats()
    cold_build = {"programs": c1["built"] - c0["built"],
                  "build_s": c1["build_s"] - c0["build_s"]}
    launches_cold = kernel.radius_counts.launches
    t_warm, warm = run_pass(index, [cont, disc], dev)
    launches = kernel.radius_counts.launches
    main_launches = read_launches()
    off_path = {k: v for k, v in main_launches.items()
                if v and k not in ("radius_counts", "radius_counts_staged")}
    if off_path:
        raise AssertionError(f"query_many launched {off_path} (the fused path's "
                             "staged body only)")
    if main_launches["radius_counts_staged"] != launches:
        raise AssertionError(f"query_many launched {main_launches}; every "
                             "radius_counts launch must reach the staged body")
    log(f"[main] query_many cold {t_cold:.4f} s ({launches_cold} launches; "
        f"{cold_build['programs']} programs built in {cold_build['build_s']:.3f} s "
        f"of it), warm {t_warm:.4f} s ({launches - launches_cold} launches, "
        f"replayed); ingest {index.ingest_stats}")
    if launches == 0:
        raise AssertionError("the main path never launched radius_counts")
    check_planted(cold, planted_c, planted_d)
    check_planted(warm, planted_c, planted_d)
    if not 0 < launches - launches_cold <= 3:
        raise AssertionError(
            f"warm pass made {launches - launches_cold} launches; expected one "
            "per KSG-family group (MixedKSG + DC-KSG, then DC-KSG)")
    for a, b in zip(cold, warm):
        same_rankings(a, b)
    top = warm[0][0][:3]
    log(f"[main] continuous q0 top-3: "
        f"{[(m.table, round(mi, 4), js) for m, mi, js in top]}")

    # Phase 4: sub-corpus on the card against the port's CPU path.
    sub = {
        "n": N_SKETCH, "method": "tupsk", "agg": "first",
        "keys": np.stack(index._keys[:C_CHECK]),
        "vals_f": np.stack(index._vals_f[:C_CHECK]),
        "vals_u": np.stack(index._vals_u[:C_CHECK]),
        "masks": np.stack(index._masks[:C_CHECK]),
        "meta": [(mt.table, mt.key_column, mt.value_column, mt.value_is_discrete)
                 for mt in index.meta[:C_CHECK]],
    }
    gpu_sub = index_from_numpy(sub, device="cuda")
    cpu_sub = index_from_numpy(sub, device="cpu")
    for batch in (cont[:4], disc[:4]):
        same_rankings(
            gpu_sub.query_many(batch, top_k=TOP_K, min_join=MIN_JOIN),
            cpu_sub.query_many(batch, top_k=TOP_K, min_join=MIN_JOIN),
        )
    log(f"[check] C={C_CHECK} sub-corpus: card == CPU path (rankings, join "
        f"sizes; MI within 1e-5)")

    # Phase 5: the warm pass's own launches, against the plain version and
    # timed on their inputs.
    seen = capture_launches(index, [cont, disc])
    if len(seen) != launches - launches_cold:
        raise AssertionError(
            f"captured {len(seen)} launches; the warm pass made "
            f"{launches - launches_cold}")
    rc = check_main_launches(seen, card)
    max_err = max([max_err] + [r["max_abs_err"] for r in rc])
    rc_ms = sum(r["ms"] for r in rc)
    rc_plain = sum(r["plain_ms"] for r in rc)
    rc_bound_ms = sum(r["bound_ms"] for r in rc)
    rc_by = bound_by(rc)
    rc_device = sum(r["device_ms"] for r in rc)
    rc_tiled = sum(r["tiled_ms"] for r in rc)
    rc_direct = sum(r["rc_ops_bound_ms"] for r in rc)
    log(f"[time] radius_counts, the {len(rc)} launches of one warm pass: "
        f"{rc_ms:.4f} ms events, {rc_device:.4f} ms device, bound "
        f"{rc_bound_ms:.4f} ms ({rc_by}, {100 * rc_bound_ms / rc_ms:.1f}%; the "
        f"direct algorithm's {rc_direct:.4f} ms, {100 * rc_direct / rc_ms:.1f}%), "
        f"the tiled body on the same inputs {rc_tiled:.4f} ms, plain "
        f"{rc_plain:.4f} ms; card {card}")

    # Phase 6: warm-pass wall time per dtype, host clock around a
    # synchronize, and one profiled warm pass.
    warm_c = [run_pass(index, [cont], dev)[0] for _ in range(WARM_REPS)]
    warm_d = [run_pass(index, [disc], dev)[0] for _ in range(WARM_REPS)]
    t_warm_c, t_warm_d = float(np.median(warm_c)), float(np.median(warm_d))
    log(f"[main] warm query_many, median of {WARM_REPS}: continuous "
        f"{t_warm_c:.4f} s (min {min(warm_c):.4f}, max {max(warm_c):.4f}), "
        f"discrete {t_warm_d:.4f} s (min {min(warm_d):.4f}, max "
        f"{max(warm_d):.4f}); Q={Q} queries each")
    prof_c = profile_pass(index, cont)
    log(f"[main] profiled warm continuous query_many: wall "
        f"{prof_c['wall_ms']:.2f} ms, device {prof_c['device_ms']:.2f} ms")
    for row in prof_c["top"][:8]:
        log(f"[main]   {row['ms']:9.3f} ms x{row['count']:<4d} {row['name']}")

    # Phases 7-9: the service front end over the same index.
    svc = DiscoveryService(index=index, k=3)
    queue = [sk for pair in zip(cont, disc) for sk in pair]
    submit = run_submit(svc, queue, warm)
    clean = submit.pop("results")
    safe = run_submit_safe(svc, queue, clean, invalid_sketches(keys, y))
    fence = safe.pop("fence_inputs")
    sched = run_scheduler(svc, queue, clean)

    # Phase 10: the materialized estimators on phase 5's samples.
    mat = check_materialized(seen, card)
    pc_max_err = max([pc_max_err] + [r["max_abs_err"] for r in mat])
    pc_ms = float(np.mean([r["ms"] for r in mat]))
    pc_plain = float(np.mean([r["plain_ms"] for r in mat]))
    pc_bound_ms = float(np.mean([r["bound_ms"] for r in mat]))
    log(f"[time] pairwise_cheb, one launch at the materialized chunk "
        f"(B={mat[0]['chunk']}, P={mat[0]['P']}), mean over {len(mat)} main-path "
        f"sample sets: {pc_ms:.4f} ms, plain {pc_plain:.4f} ms, bound "
        f"{pc_bound_ms:.4f} ms (bytes); card {card}")

    # Phase 14: the wide-buffer path (k=WIDE_K) through the tiled body,
    # then (b) the tiled body's sweep.
    wide = run_wide_buffer(index, [cont, disc], card)
    wide["sweep"] = run_tiled_sweep(card, dev)
    wide_rows = wide["rows"]
    log(f"[time] radius_counts_tiled, the {len(wide_rows)} launches of a k="
        f"{WIDE_K} warm pass: {sum(r['ms'] for r in wide_rows):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in wide_rows):.4f} ms (the direct algorithm's "
        f"{sum(r['rc_ops_bound_ms'] for r in wide_rows):.4f} ms); card {card}")

    # Phase 15: the phase-0 containment gate on the same index.
    gated = run_gated(index, [cont, disc], warm, DiscoveryService(index=index, k=3),
                      queue, card, dev)

    # Phase 16 (a)-(c): the group programs against eager(), ungated and
    # gated, and the service with programs on.
    prog = {"ungated": compare_programs(index, [cont, disc], dev, card),
            "gated": compare_programs(index, [cont, disc], dev, card,
                                      min_containment=GATE_MC),
            "service": run_programs_service(DiscoveryService(index=index, k=3),
                                            queue, clean, card),
            "discovery_peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "compile": programs.compile_stats()}
    log(f"[programs] discovery phases 3-16: {prog['compile']['built']} programs "
        f"built ({prog['compile']['alive']} alive) in "
        f"{prog['compile']['build_s']:.2f} s of warm-up and capture; peak device "
        f"memory {prog['discovery_peak_mem_bytes'] / 2**30:.2f} GiB; card {card}")

    # Phase 17: the paper's application over the same index and the
    # phase-4 sub-corpus, then its synthetic data and the taxi example.
    app = run_application(index, [cont[0], disc[0]], [warm[0][0], warm[1][0]],
                          gpu_sub, cpu_sub, rows, keys, y, card, dev)

    # Phase 21: the discovery mesh over the same index.
    mesh = run_mesh(index, [cont, disc], queue, clean, card, dev)

    # Phase 12: the two-op kNN API on phase 5's samples; phase 13: the
    # lake's keys hashed on the card.  Both run before phase 11, so that
    # the serving path starts with the discovery state freed.
    two_op = run_two_op(seen, card)
    two_op["sweep"] = two_op_sweep
    # Phase 24: the tuned bodies swept and read back on phases 3, 5, 8
    # and 12's inputs.
    tune = run_autotune(index, [cont, disc], seen, fence, card, dev)
    n_index = len(index)
    del seen, fence, index, svc, gpu_sub, cpu_sub
    lake_hash = run_hash_lake(rows, card, dev)
    del rows
    gc.collect()  # the index sits in reference cycles; free its stores now
    torch.cuda.empty_cache()
    knn_rows = [r["knn_smallest"] for r in two_op["rows"]]
    bc_rows = [r["ball_counts"] for r in two_op["rows"]]
    for op, op_rows in (("knn_smallest", knn_rows), ("ball_counts", bc_rows)):
        tot = {k: sum(r[k] for r in op_rows)
               for k in ("ms", "tiled_ms", "plain_ms", "bound_ms", "direct_bound_ms")}
        log(f"[time] {op}, phase 12's {len(op_rows)} launches: staged "
            f"{tot['ms']:.4f} ms, the tiled body on the same inputs "
            f"{tot['tiled_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms; "
            f"sorted-route bound {tot['bound_ms']:.4f} ms ({bound_by(op_rows)}, "
            f"{100 * tot['bound_ms'] / tot['ms']:.1f}%), {direct_words(tot)}; "
            f"card {card}")
        pad = [r[op] for r in two_op["padded_rows"]]
        pad_ms, pad_bound = sum(o["ms"] for o in pad), sum(o["bound_ms"] for o in pad)
        log(f"[time] {op}_tiled, phase 12 (b)'s {len(pad)} calls at P="
            f"{TWO_OP_PAD_P}: {pad_ms:.4f} ms, bound {pad_bound:.4f} ms "
            f"({bound_by(pad)}, {100 * pad_bound / pad_ms:.1f}%); card {card}")

    # Phase 11: the model serving path, with the discovery state freed.
    serving = run_serving(card, dev)
    gc.collect()  # the batcher's capture hooks sit in reference cycles
    torch.cuda.empty_cache()
    # Phase 18: the MoE and MLA serving path, with phase 11's model freed.
    moe = run_moe_serving(card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 19: the SSM and hybrid serving path, with phase 18's freed.
    ssm_serving = run_ssm_serving(card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 20: the training path, with phase 19's models freed.
    training = run_training(card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 22: the model mesh's serving path, four shards on the card.
    model_mesh = run_model_mesh(serving, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 23: training on the model mesh, and the dry run.
    train_mesh = run_train_mesh(card, dev)
    # Every flash launch of phase 20 (a)'s MoE + MLA / Mamba2 checks and of
    # phase 23's runs, by kernel counter.
    train_launches = [f[k] for f in training["families"].values()
                      for k in ("launches", "step_launches")]
    train_launches += [train_mesh["ep"]["grad_launches"][k]
                       for k in ("plain", "ep")]
    train_launches += [r["launches"] for r in train_mesh["ep"]["runs"].values()]
    train_launches += [r["launches"] for r in train_mesh["int8_ef"]["runs"].values()]
    train_launches.append(train_mesh["resume"]["launches"])

    def more(name: str) -> int:
        return sum(d.get(name, 0) for d in train_launches)

    # Phase 24 (b)'s launches with the tuned rungs (its sweeps' launches
    # are uncounted and stand apart, in the record and the [autotune]
    # lines).
    from repro_torch.kernels import autotune

    tune["sweeps"], tune["sweep_launches"] = (autotune.sweeps,
                                              autotune.sweep_launches)

    def tuned(name: str) -> int:
        return tune["launches"][name]

    mesh_runs = [model_mesh[arch][run] for arch, *_ in MESH_SERVE
                 for run in ("plain", "mesh_run")]
    train_checks = list(training["check"].values())
    train_full = list(training["full"].values())
    moe_full = [moe[arch]["serve"] for arch, *_ in MOE_SERVE]
    ssm_full = [ssm_serving[arch]["serve"] for arch, *_ in SSM_SERVE]
    hybrid_flash = [r["flash"] for r in ssm_full if r["flash"]]
    fa32 = serving["flash_f32"]
    # Phase 18 (a)'s float32 MLA forwards (deepseek's) through the basic
    # body, and phase 11 (c)'s Gemma-shape launch.
    mla_checks = [moe[arch]["check"]["mla_f32"] for arch, *_ in MOE_SERVE
                  if "mla_f32" in moe[arch]["check"]]
    mla32 = mla_checks[0]["flash"]
    gemma = serving["flash_basic_gemma"]
    flash_basic = {
        "f32_forward": {"ms": fa32["basic_ms"], "bound_ms": fa32["bound_ms"],
                        "share": fa32["basic_share"],
                        "library_ms": fa32["library_ms"],
                        "plain_ms": fa32["plain_ms"],
                        "shape_q": fa32["rows"][0]["shape_q"]},
        **{name: {"ms": f["ms"], "bound_ms": f["bound_ms"],
                  "share": f["bound_share"],
                  "cuda_cores_ms": f["cuda_cores_ms"],
                  "cuda_cores_share": f["cuda_cores_share"],
                  "library_ms": f["library_ms"], "plain_ms": f["plain_ms"],
                  "profiler_ms": f["profiler_ms"],
                  "profiler_records": f["profiler_records"],
                  "shape_q": f["rows"][0]["shape_q"],
                  "dtype": f["rows"][0]["dtype"]}
           for name, f in (("mla", mla32), ("gemma", gemma))}}
    log("[time] flash_attention_simt_basic, ms / bound ms (share) / "
        "scaled_dot_product_attention ms (CUDA graphs timed by events): "
        + "; ".join(f"{name} q {r['shape_q']}: {r['ms']:.4f} / {r['bound_ms']:.4f} "
                    f"({100 * r['share']:.1f}%) / {r['library_ms']:.4f}"
                    for name, r in flash_basic.items())
        + f" (Gemma at the float32 CUDA-core rate: "
        f"{flash_basic['gemma']['cuda_cores_ms']:.4f} ms, "
        f"{100 * flash_basic['gemma']['cuda_cores_share']:.1f}%); card {card}")
    short = [w for w in PROFILE_WINDOWS if w["records"] < w["calls"]]
    log(f"[time] profiler windows: {len(PROFILE_WINDOWS)}, {len(short)} of them "
        f"with fewer kernel records than calls made: " + "; ".join(
            f"{w['records']}/{w['calls']}" for w in short))
    fa_err = {"flash_attention_simt_regtile": max(
                  fa_err["flash_attention_simt_regtile"], fa32["max_abs_err"]),
              "flash_attention_simt_basic": max(
                  fa_err["flash_attention_simt_basic"], fa32["basic_max_abs_err"],
                  mla32["max_abs_err"], gemma["max_abs_err"]),
              "flash_attention_wgmma": max(
                  [fa_err["flash_attention_wgmma"], serving["flash"]["max_abs_err"]]
                  + [r["flash"]["max_abs_err"] for r in moe_full]
                  + [f["max_abs_err"] for f in hybrid_flash]
                  + [r["flash"]["max_abs_err"] for r in train_full])}

    record = {
        "card": card, "torch": torch.__version__, "nvcc": nvcc,
        "build_s": {name: b.seconds for name, b in builds.items()},
        "build_wall_s": t_build, "C": n_index, "Q": Q,
        "min_join": MIN_JOIN, "top_k": TOP_K, "ingest_s": t_ingest, "flush_s": t_flush,
        "query_many_cold_s": t_cold, "query_many_warm_s": t_warm,
        "query_many_cold_build": cold_build, "programs": prog,
        "query_many_warm_continuous_s": warm_c,
        "query_many_warm_discrete_s": warm_d,
        "launches_cold": launches_cold, "launches_warm": launches - launches_cold,
        "profile_warm_continuous": prof_c,
        "radius_counts": rc, "radius_counts_wide": wide, "gated": gated,
        "submit": submit, "submit_safe": safe,
        "scheduler": sched, "materialized": mat, "two_op": two_op,
        "lake_hash": lake_hash, "serving": serving, "moe_serving": moe,
        "ssm_serving": ssm_serving, "training": training,
        "flash_basic": flash_basic, "profile_windows": PROFILE_WINDOWS,
        "application": app, "mesh": mesh, "model_mesh": model_mesh,
        "train_mesh": train_mesh, "autotune": tune,
        "compile_end": programs.compile_stats(),
        "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"record": record}))
    print(json.dumps({"kernels": [{
        "name": "radius_counts",
        "route": "cuda",
        "source": "src/repro_torch/kernels/knn_stats/csrc/radius_counts.cu",
        "replaces": "src/repro/kernels/knn_stats/kernel.py:481",
        # Phase 3's warm pass and phase 21's warm mesh window.
        "launches": main_launches["radius_counts_staged"]
        + mesh["launches_per_window"]["mesh"] + tuned("radius_counts_staged"),
        "max_abs_err": max(max_err, mesh["max_abs_err"]),
        "ms": rc_ms,
        "plain_ms": rc_plain,
        "bound_ms": rc_bound_ms,
        "bound_by": rc_by,
        "library_ms": None,
    }, {
        "name": "radius_counts_tiled",
        "route": "cuda",
        "source": "src/repro_torch/kernels/knn_stats/csrc/radius_counts.cu",
        "replaces": "src/repro/kernels/knn_stats/kernel.py:481",
        "launches": wide["launches"]["radius_counts_tiled"]
        + tuned("radius_counts_tiled"),
        "max_abs_err": max([max_err] + [r["max_abs_err"]
                                        for r in wide_rows + wide["sweep"]]),
        "ms": sum(r["ms"] for r in wide_rows),
        "plain_ms": sum(r["plain_ms"] for r in wide_rows),
        "bound_ms": sum(r["bound_ms"] for r in wide_rows),
        "bound_by": bound_by(wide_rows),
        "library_ms": None,
    }, {
        "name": "pairwise_cheb",
        "route": "cuda",
        "source": "src/repro_torch/kernels/pairwise_cheb/csrc/pairwise_cheb.cu",
        "replaces": "src/repro/kernels/pairwise_cheb/kernel.py:59",
        # The fences of phase 8 and of phase 21 (d) (the distributed rung).
        "launches": safe["launches"]["pairwise_cheb"]
        + mesh["service"]["fence_launches"]["pairwise_cheb"]
        + tuned("pairwise_cheb"),
        "max_abs_err": pc_max_err,
        "ms": pc_ms,
        "plain_ms": pc_plain,
        "bound_ms": pc_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, *[{
        # flash_attention: the CUDA-core entry (flash_attention_simt); its
        # register-tiled body's times are phase 11 (c)'s 24 launches, the
        # basic body's phase 18 (a)'s float32 MLA prefill (3 launches).
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "launches": launches,
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    } for name, launches, err, times in (
        # Phase 11 (c)'s float32 forward, phase 18 (a)'s float32 MLA
        # forward, phase 20 (a)'s float32 train steps (forward and remat)
        # on the card and phase 23 (c)'s float32 smoke-size mesh steps.
        ("flash_attention", serving["flash_f32_launches"]["flash_attention"]
         + sum(c["launches"]["flash_attention"] for c in mla_checks)
         + sum(r["launches"]["flash_attention"] for r in train_checks)
         + more("flash_attention"),
         max(fa_err["flash_attention_simt_regtile"],
             fa_err["flash_attention_simt_basic"]), fa32),
        ("flash_attention_simt_regtile",
         serving["flash_f32_launches"]["flash_attention_simt_regtile"]
         + sum(r["launches"]["flash_attention_simt_regtile"]
               for r in train_checks) + more("flash_attention_simt_regtile"),
         fa_err["flash_attention_simt_regtile"], fa32),
        # Phase 18 (a)'s float32 MLA forward and phase 11 (c)'s forward
        # forced through the basic body.
        ("flash_attention_simt_basic",
         serving["flash_f32_basic_launches"]["flash_attention_simt_basic"]
         + sum(c["launches"]["flash_attention_simt_basic"] for c in mla_checks)
         + more("flash_attention_simt_basic"),
         fa_err["flash_attention_simt_basic"], mla32))],
    {
        "name": "flash_attention_wgmma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        # The serving runs of phase 11, phase 18 (c), phase 19 (c) and
        # phase 22 (c), (d) (plain and on the mesh) and the training runs
        # of phase 20 (a) (deepseek, bf16), (b) and phase 23 (a), (b)
        # (plain, EP, int8_ef); the times are phase 11's launches, at the
        # internlm2 shape.
        "launches": serving["launches"]["flash_attention_wgmma"] + sum(
            r["launches"]["flash_attention_wgmma"]
            for r in moe_full + ssm_full + train_full + mesh_runs)
        + more("flash_attention_wgmma"),
        "max_abs_err": fa_err["flash_attention_wgmma"],
        "ms": serving["flash"]["ms"],
        "plain_ms": serving["flash"]["plain_ms"],
        "bound_ms": serving["flash"]["bound_ms"],
        "bound_by": serving["flash"]["bound_by"],
        "library_ms": serving["flash"]["library_ms"],
    }, *[{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/knn_stats/csrc/knn_two_op.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max([two_op_err, two_op["tiled_err"]]
                           + [r[err] for r in op_rows]),
        "ms": sum(r[ms] for r in op_rows),
        "plain_ms": sum(r["plain_ms"] for r in op_rows),
        "bound_ms": sum(r["bound_ms"] for r in op_rows),
        "bound_by": bound_by(op_rows),
        "library_ms": None,
    } for name, replaces, op_rows, launches, ms, err in (
        # The staged bodies: phase 12 (a)'s launches; the tiled bodies:
        # phase 12 (b)'s, timed on (a)'s inputs (the same function, the
        # same bound).
        ("knn_smallest", "src/repro/kernels/knn_stats/kernel.py:381", knn_rows,
         two_op["launches"]["knn_smallest_staged"]
         + tuned("knn_smallest_staged"), "ms", "max_abs_err"),
        ("knn_smallest_tiled", "src/repro/kernels/knn_stats/kernel.py:381",
         knn_rows, two_op["tiled_launches"]["knn_smallest_tiled"]
         + tuned("knn_smallest_tiled"), "tiled_ms", "tiled_max_abs_err"),
        ("ball_counts", "src/repro/kernels/knn_stats/kernel.py:426", bc_rows,
         two_op["launches"]["ball_counts_staged"]
         + tuned("ball_counts_staged"), "ms", "max_abs_err"),
        ("ball_counts_tiled", "src/repro/kernels/knn_stats/kernel.py:426",
         bc_rows, two_op["tiled_launches"]["ball_counts_tiled"]
         + tuned("ball_counts_tiled"), "tiled_ms", "tiled_max_abs_err"))],
    {
        "name": "murmur3_fib",
        "route": "cuda",
        "source": "src/repro_torch/kernels/murmur3/csrc/murmur3_fib.cu",
        "replaces": "src/repro/kernels/murmur3/kernel.py:63",
        "launches": lake_hash["launches"]["murmur3_fib"],
        "max_abs_err": max(hash_err, lake_hash["max_abs_err"]),
        "ms": sum(p["ms"] for p in lake_hash["passes"].values()),
        "plain_ms": sum(p["plain_ms"] for p in lake_hash["passes"].values()),
        "bound_ms": sum(p["bound_ms"] for p in lake_hash["passes"].values()),
        "bound_by": bound_by(list(lake_hash["passes"].values())),
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
