#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (and on four, phase 15).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):
  0. device: requires CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them;
  1. build: compiles every kernel source in csrc/ with nvcc, one process
     per source, all at once; prints each source's seconds and ptxas's
     registers, spills and serialized wgmma of the experiment forwards, the
     tensor-core backwards (kv-outer and q-outer, each also in the split
     pair's form), the banded walks of the tensor-core forward (banded_fwd
     and window_fwd), prefill and decode, and any kernel that spills (a spill of the tensor-core decode
     body fails);
  2. kernels: each of the four serving kernels against its plain PyTorch
     version on the card, at the serving slice's shapes (int8 cache, 8 kv
     heads, d 128, page 256, chunk 512, 16 slots), plus a GQA (8 q / 2 kv)
     case and an unquantized bf16 case; the KV writes (the chunk write on
     the projection's transposed K/V; the append at one token a slot and at
     gamma 4 in one launch) must match bit for bit outside the trash page,
     lengths included, on the body native.kv_write_body names as the launch
     reports it (each line also prints entry_ms, the public entry's CUDA-event
     time, and the bf16 case one Tensor.index_put_ of the same rows into the
     K and V pages as the writes' library time), the attention kernels within
     2 bf16 ulps at the output's scale, no floor; prints errors, median times (CUDA
     events), each kernel's own device time from torch.profiler
     (kernel_ms: no host launch cost in it) and bounds, and the body each
     paged_prefill and decode launch ran (it must be the one
     native.prefill_body / native.decode_body names: the tensor cores for
     bf16 activations at head_dim_store 128 on pages of a multiple of 64,
     and for the decodes also pages of 16 or 32), with the decodes' splits
     and CTAs; two calls of each decode must give bit-equal outputs; the
     attention kernels' library yardstick is one
     scaled_dot_product_attention on the K/V gathered and widened to bf16
     beforehand, with the causal offset mask (the prefill's on the tensor-core
     body; the decodes' on every slot, padded to the longest, a causal bound
     a query row); the chunk write and the prefill take their scalars as a
     device int32 meta vector, built once before they are timed;
  2b. the same for fp8 e4m3, fp8 e5m2 and int4 caches (int4 also at page
     512), and paged_multitoken_decode at gamma 4 on int8, bf16, fp8 e4m3
     and int4 caches, at 8/8 heads and GQA 8 q / 2 kv; then shapes the JAX
     package takes that the kernels once refused: GQA 16/2 at gamma 4 (32 query
     rows a kv head), head_dim 384 (all four kernels; and the bf16 gamma 4
     decode), page 16;
  2(r). one chunk write and one prefill captured together as a CUDA graph
     with their (slot, start, true_len) in a device vector, run eagerly at
     one triple and replayed at two more: writes and lengths bit for bit,
     the prefill within 2 bf16 ulps, against the plain versions at each
     triple (the kernels read their scalars on the device);
  3. engine: the 168M decoder (vocab 32768, d_model 1024, 8 layers, 8/8
     heads, d_head 128, d_ff 4096, bf16) with random weights from the seed
     serves 18 requests (prompts of 300-1900 tokens, two sharing a
     page-aligned prefix, 32 greedy tokens each) on 16 slots; checks the
     outputs, the prefix-cache hit and that its four kernels launched; every
     engine run (3-3e) names its prefill's body and prints its prefill
     tokens/s beside the rate on the scalar prefill; then the CUDA kernels
     its second and third prefill chunk and decode step launch
     (utils/serving_census.py, "census engine"; 3b and 3e(b)'s cp engines
     print theirs, the speculative ones for the speculative step), no claim;
  3b. the same engine with speculative_tokens=3 serves those 18 requests,
     2 whose prompts repeat a 64-token pattern and 2 sampled ones
     (temperature 0.8, top-k 50); paged_multitoken_decode and kv_append
     must launch; prints spec_stats, tokens per step and the share of
     greedy requests equal to phase 3's;
  3c. the same model on an fp8 e4m3 cache (page 256) and on an int4 cache
     (page 512, 81 pages, 8 a sequence) with and without speculation, 8
     requests each; every run must launch its kernels on its payload;
  3d. a lossless gate: 2 layers at the 168M width in float32, unquantized
     cache, with and without speculation, with every draft right and with
     every draft wrong: the greedy tokens must agree up to each request's
     first top-2 logit tie (gap under 1e-3);
  3e. context-parallel serving, 4 shards on the card (a mesh of cuda:0
     repeated): (a) the sequence-sharded variants (paged_decode causal and
     in a window of 1024, paged_multitoken_decode at gamma 4, paged_prefill
     on a 512-token chunk at 12,288, each with its (l, m) outputs, page
     stride and offset; kv_chunk_write on int8 and int4, and kv_append with
     its owner test at one token and at gamma 4) on every shard
     against their plain versions, at 16 slots, int8, page 256, global
     lengths 1,000-16,000, 8/8 heads and GQA 8 q / 2 kv; the merge of the
     4 shards against the flat kernel on the same tokens; two calls of each
     decode variant bit-equal on every shard, its body the one
     native.decode_body names; shard 0's times with kernel_ms; (b) the 168M
     engine with cp = 4 (int8, page 256, 8 slots, 16 local pages a
     sequence, 129 pages a shard) on 8 requests of 4,000-15,000 prompt
     tokens, and with speculation on 4 pattern prompts, against the flat
     engine on the same requests (the last prompt token's logits within
     the bf16 tolerance of phase 4); it must launch every variant; (c) a
     float32 gate: all 8 layers, unquantized cache, 4 prompts of
     4,000-15,000 tokens, cp = 4 with and without speculation against the
     flat engine: the last prompt token's logits within half the tie gap,
     equal greedy tokens up to each request's first top-2 logit tie; each
     attention variant of (a) also timed beside its library yardstick, one
     aten._scaled_dot_product_efficient_attention with compute_log_sumexp
     on shard 0's own keys gathered beforehand (masked by global
     position), and kv_chunk_write[cp] beside one index_put_ of shard 0's
     owned rows into bf16 pages;
  3f. sliding-window serving: (a) the serving kernels on rolled page
     tables: 16 slots, page 256, 10 table slots a sequence (2,560 tokens),
     slot lengths 3,600-12,000, every table slot below a slot's window at
     the trash page (the payload's largest values at scales of 1,000),
     int8 and int4 caches, LocalRule(1024) and the strided LocalRule(256,
     2): paged_decode, paged_multitoken_decode (gamma 4) and paged_prefill
     (a 512-token chunk at 3,000 or more) against their plain versions
     (attn_tol) and against a dense windowed oracle on the live K/V
     gathered by position (oracle_tol), each on the body native names;
     kv_chunk_write and kv_append (one token, then 4) bit for bit with
     lengths; paged_decode[cp] at cp = 4 on rolled local tables, each shard
     against its plain version and the shards' merge against the oracle;
     (b) the 168M decoder with LocalRule(1024) served (int8, page 256, chunk
     512, 16 slots, 10 table slots, 161 pages): 16 requests of 1,000-6,000
     prompt tokens with 64 greedy tokens and one of 4,000 with 1,400, then
     speculation (3 drafts) on pattern prompts, then an int4 cache; each
     run must launch its kernels on their Hopper bodies, evict, keep
     pages_in_use_peak within the page cap times the slots, complete the
     long request, and (int8) give each last prompt token the logits of the
     model's forward over the whole prompt within LOGIT_ATOL; prints the
     rates and the window engine's census; (c) a float32 gate: 2 layers,
     window 1,024, unquantized cache, 4 prompts of 2,000-5,000 tokens, 48
     new tokens, flat and cp = 4 (4 local table slots: the shards' tables
     roll), each with and without speculation: the greedy tokens are the
     argmax of a teacher-forced forward over each final sequence up to
     each request's first top-2 tie;
  3g. the bucketed prefill (buckets 512 and 2,048) on phase 3's requests:
     the forward kernel the route picks launches once per layer and
     prompt; last prompt token's logits within LOGIT_ATOL of phase 3's
     chunked engine's; prints its prefill rate beside phase 3's;
  3h. tensor-parallel serving, a model axis of 4 on the card (cuda:0 four
     times): (a) phase 2's kernel_case at a head shard's heads, 2 q / 2 KV
     and 4 / 4, int8 and int4, the four kernels and gamma 4, every decode
     and prefill launch on the tensor-core body, each kernel's kernel_ms and
     CTAs printed beside phase 2's at 8 / 8; sharded_paged_decode at tp = 4
     against the flat paged_decode at 8 KV heads on the same pages: bit-equal
     where both launches cut a slot into the same runs (2 table slots),
     within attn_tol where the shards' smaller grids cut more runs (phase
     2's table: 16 runs against 4); (b) the 168M engine with that mesh
     (2 KV heads a shard, int8) on phase 3's 18 requests and 32 greedy
     tokens, then with 3 drafts on two pattern prompts and six of phase
     3's: every serving launch on its fast body (tensor cores; the writes'
     vector body), each request's last prompt token's logits within
     LOGIT_ATOL of phase 3's, the requests equal to phase 3's, the rates and
     the census; (c) a float32 gate: 2 layers, unquantized cache, 4 prompts
     of 1,000-4,000 tokens, 48 new tokens, tp = 2 and model 2 x seq 2, each
     with and without speculation: tokens equal to a teacher-forced
     forward's argmax up to each request's first tie (float32 activations
     run the scalar bodies, which it prints);
  3i. MoE serving (4 top-1 experts a layer, float32 router and experts):
     (a) a float32 gate, 2 layers at the 168M width, unquantized and int8
     caches, 4 slots, 3 requests (one retiring early from slot 0, slot 3
     idle throughout), without and with 3 drafts: the card's greedy tokens
     equal to the port's CPU engine's up to each request's first tie (a
     top-2 logit gap under GAP_TIE or a top-2 router probability gap under
     ROUTER_TIE in a model call the request takes part in), every idle
     slot's decode output exactly 0 on the card; (b) the bf16 168M decoder
     with 4 experts serves phase 3's 18 requests on phase 3's engine
     configuration, then with 3 drafts: requests complete, the serving
     kernels launch on the bodies native.*_body names, rates beside phase
     3's and 3b's;
  4. the same weights on the CPU (plain versions) and on the card: the
     logits of a 512-token prompt's last token must agree;
  5. the op path's ten kernels (the table-driven forward, kv-outer and
     q-outer fused backward and split dQ / dK-dV pair; the banded and
     resident forward and the banded fused backward; the single-window
     forward and fused backward) driven through the public functions on
     the routes the JAX package takes, each case's outputs and gradients
     held against the plain path on the card, each case's launches counted
     on its own: (a) the training slice (B*H, S, d) = (64, 2048, 128) bf16
     causal (banded); (b) the same with FA_FUSED_BWD=0 (the split pair);
     (c) GQA 8 q / 2 kv heads through mha; (d) fp32 local_1d (window 5,
     stride 2, causal, scale_front) with q != k lengths (window); (e) fp16
     local_2d (scale_end) with d != v_d (window forward); (o), (p) the
     JAX package's window sweep (tools/exp_window_sweep.py, bf16, B 8,
     D 128): local_1d at 8,192 tokens, a causal window of 512, and local_2d
     on a 64 x 64 image, a causal window of 8 (window forward and backward,
     both on the tensor-core bodies; each window launch of (e), (o) and
     (p), as that case's own run records it, must report that body); (f)
     the slice with the band routes switched off (the table kernels); (g) the slice with FA_RESIDENT=1;
     (i) d = v_d = 384, (16, 1024) bf16 causal (the tensor-core forward's
     widest class below 512, the backward's third tile class); (j), (k)
     fp16 causal at (16, 1024, 128), banded and table; (l) bf16 causal at
     d = 576, v_d = 64, (8, 1024), banded and resident (d past the
     tensor-core classes: the scalar forward); (m) the resident route on
     fp16 at (16, 1024, 128); (n) a custom mask rule (causal on a
     checkerboard of 32-position squares, every tile live and none fully
     visible: the kernels read its granule mask, kind 3) on every route it
     takes, bf16 at (8, 1024, 128) auto, table, split and resident, float32
     at (4, 1024, 64) auto and table, and the bf16 q-outer backward; (h) the
     q-outer backward, which only a direct call with fused="q" reaches, as
     in the JAX package (bf16 at d 128: the tensor-core q-outer body, as
     its launch reports it), timed at (h)'s shape beside flash_bwd_fused and
     scaled_dot_product_attention(enable_gqa=True) forward + backward; then
     each kernel's median CUDA-event time against
     its plain version, with useful TFLOP/s priced from flops.py's
     schedule by the products each kernel computes (flash_fwd, banded_fwd
     and resident_fwd on bf16 run the tensor-core forward, resident_fwd as
     persistent CTAs walking the rows in order by groups: its row prints
     the grid, the work items and the rows a group its launch reports and
     is set beside banded_fwd;
     flash_bwd_fused, banded_bwd and flash_bwd_qouter the tensor-core
     backwards: each row names its body; the split pair flash_bwd_dq and
     flash_bwd_dkv the q-outer body without dK and dV and the kv-outer body
     without dQ, each launched on its own at the slice first: within
     op_tol of the plain split backward, two launches bit-equal, on the
     body bwd_body names as the launch reports it; the pair's sum beside
     the library's forward + backward and its factor), banded_bwd once
     more without dQ (what dQ's product and its reduction into the float32
     accumulator cost), and the accumulator's zero fill and scale-and-cast
     passes; the window kernels at case (d)'s float32 shape (the scalar
     bodies), and at (o) and (p)'s shapes each binding alone: against its
     plain version, two launches' dK and dV bit-equal, on the tensor-core
     body as the launch reports it, timed by events and kernel_ms
     (torch.profiler) beside its bound, plain version, one
     scaled_dot_product_attention with the dense boolean mask (forward +
     backward for the backward) and the route FA_WINDOW=0 / FA_WINDOW_BWD=0
     takes at the same shape (local1d_w512's numbers head the kernels
     line; each shape's under "shapes");
  5q. float64 through the chunked path (ops/chunked.py): causal_1d and
     local_1d (a causal window of 256) at (2, 4, 64, 4096), outputs and
     gradients within 1e-9 * 4096 * 10 of the float64 dense oracle
     (implementation="xla"), with the forward, forward + backward and the
     oracle's ms; the JAX package's 16k case (S 16,384, D 8, a causal
     window of 64, blocks 512): peak device memory above its inputs under
     1/8 of the 2 GiB score tensor a dense path holds, row 12,345 against a
     float64 oracle on the host; then the reference harness (python -m
     tf_flash_attention_tpu_torch.testing) in three processes: verify a 1d
     and a 2d case, benchmark one, their lines printed;
  6. training at full width: the same 168M decoder (fp32 parameters, bf16
     compute) takes 5 AdamW steps on one seeded batch of 8 x 2048 tokens;
     the first step's loss and gradient norm must match the plain path on
     the card, the loss must fall, and the five steps must launch the
     banded kernels; prints step ms and tokens/s;
  6b. training parallelism, single-controller on the one card (every
     shard on cuda:0, one after another: no communication is measured):
     (a) the ring (CausalRule, FullRule, LocalRule(1024, is_causal=True))
     and Ulysses (CausalRule) on a context axis of 4 at (b, h, S, d) =
     (4, 8, 8192, 128) bf16, the callables' eager functions (``.eager``;
     phase 12 replays their graphs): outputs and dQ/dK/dV against
     single-device mha within op_tol and against the same function on the
     plain versions within attn_tol; prints the forward and forward +
     backward ms, the ring steps visited and the launches by kernel; (b)
     the same 168M decoder on phase 6's batch, 3 AdamW steps (capturable)
     of make_sharded_train_step's eager step (``.eager``; phase 12 its
     graph) on (data 2, model 4) and, with context_parallel=True, on (data 2,
     model 2, context 2): the first step's loss and gradient norm within
     TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL of phase 6's plain path, falling
     losses, one attention launch a (data, model) block, layer and step
     (under cp one a ring pair: 3 a ring of 2); prints step ms and
     tokens/s;
  6c. MoE training: the 168M decoder with 4 experts (fp32 parameters, bf16
     compute, float32 experts) on phase 6's batch, 3 AdamW steps, then 3
     of make_sharded_train_step's eager step on (data 2, model 4), one expert a model
     shard: the first step's loss and gradient norm within
     TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL of the plain path, falling losses,
     one banded_fwd and banded_bwd a (data, model) block, layer and step;
     prints step ms, tokens/s and the launches;
  6d. the GPipe step (make_pipeline_train_step's eager step): phase 6's
     model, weights and batch on (data 2, pipe
     4), 2 layers a stage, 4 microbatches: the first step's loss and
     gradient norm within the same tolerances of phase 6's plain path,
     falling losses, exactly 64 launches each of banded_fwd and banded_bwd
     a step (a stage only on its live ticks); prints the ticks, step ms
     and tokens/s;
  7. one step of the same model at 1 x 512 tokens on the CPU (plain
     versions) and on the card (kernels): the losses must agree;
  8. the experiment tools' kernels (experiments/), every instantiation the
     tools run at the tools' own shapes, driven once through the modules'
     wrappers with the launch counts reset just before: exp_resident's
     seven (block_q, block_kv) pairs, exp_vpu_attrib's six rungs,
     exp_kv_unroll's four variants ((8, 4096, 128) bf16), exp_int4_unpack's
     six kernels (16 rows x 8 kv heads x 8 queries over 8192 shared tokens)
     and exp_decode's five variants (16 slots x 8192 tokens, int8, page
     512); each held against its plain version (2 bf16 ulps at the output's
     scale, bitcast 3; int8mm's q codes, integer scores and p codes bit for
     bit) and timed beside its plain version, its bound and, for the
     forwards, one scaled_dot_product_attention call; exp_int4_unpack's
     kernels also by their own device time (torch.profiler), beside one
     scaled_dot_product_attention of the 16 rows over the shared int8 or
     int4 K/V dequantized to bf16 beforehand (enable_gqa), and beside them
     paged_decode (the serving body) is timed on the same int4 and int8
     K/V as a 16-slot cache whose slots share the pages (a yardstick, not a
     port; held against s32's and int8ref's plain versions); exp_decode's
     variants also by their own device time, beside one
     scaled_dot_product_attention on every slot's K/V dequantized to bf16
     and gathered beforehand; every decode site of the tools (the six of
     exp_int4_unpack, the five variants of exp_decode) must run the
     decode's tensor-core body and prints its splits and CTAs; the
     forwards name their body (exp_resident on the resident tensor-core forward: each pair timed
     through the tool's entry, its prescale included, and its kernel alone
     on the prescaled q, with the items and CTAs its launch reports, and
     held against the dense causal oracle within 1e-2 as well); then, at
     the tool's shape, resident_fwd and exp_resident_fwd at 128-row items
     and 128-key merges, each timed in windows of 2 and of 20 calls;
  9. weight-only int8 projections: int8_matmul (torch._int_mm on the card)
     at each 168M projection shape on 256 seeded bf16 rows, its weight and
     row codes and scales, int32 accumulators and outputs bit-equal between
     the card and the CPU; forward with quantize_model_weights at 1 x 2,048
     tokens (every projection one torch._int_mm on the card) within
     INT8_NOISE_FACTOR times the CPU forward's own response to a 2**-9
     nudge of its norm scales (at least LOGIT_ATOL) of the CPU's plain
     path; prints the error and top-1 agreement against the dense weights'
     forward, and both forwards' ms;
  10. the rest of the package (no kernel of its own): (a) checkpointing
     (utils/checkpoint.py): phase 6's model on its batch takes 2 AdamW
     steps, is saved, and restored through ``target`` into a fresh model
     and optimizer (its AdamW state made by one step on zero gradients, so
     the target places every moment too); every restored tensor on its
     target leaf's device and dtype and bit-equal to the saved one, steps
     3 and 4 of the restored run within TRAIN_LOSS_ATOL of the unbroken
     run's (the dQ reduce-add is not bit-deterministic: the differences are
     printed); prints the checkpoint's bytes and its save and restore
     seconds; (b) the C++ host classifier (csrc/fa_native.cc, built with
     the host compiler) equal to the NumPy spec on every schedule the run
     built up to here (phase 5's: the slice, the window shapes, the float32
     and float64 cases; a custom rule has no C++ kind and takes the spec),
     each one's host ms beside the NumPy ms; (c) graft_entry.entry()'s
     forward on the card within LOGIT_ATOL of the CPU's, on its zero tokens
     and on seeded random ones, then
     dryrun_multichip(8) over 8 shards of cuda:0 with its own checks; (d)
     the four examples (examples/torch_*.py) on the card, their wall
     seconds and invariants;
  11. the compiled steps: every engine above replays CUDA graphs of its
     decode, speculative and chunked-prefill steps (DecodeEngine._compile;
     3i(a)'s traced gate runs the impls eagerly); here each layout (flat
     int8 on phase 3's 18 requests, speculative on 3b's 22, cp = 4 on 4
     requests of 4,000-9,000 tokens, tp = 4 and MoE on 8 of phase 3's,
     the window engine on 8 requests of 1,000-6,000 tokens with 64 new)
     runs eager (its steps set back to their _*_impl methods), graphed,
     graphed, eager, eager, graphed on the same requests, each run after
     one warm-up request (which captures the graphs): the tokens must be
     equal in all six runs; prints each run's prefill and decode tokens/s,
     median wall ms of an engine step and of a prefill chunk, host ms
     inside a step and a chunk call, the calls' CUDA-event spans (a
     graph's replay: its kernels back to back) and its graphs (the
     graph's kernel nodes, the wrappers' launches, the pool's bytes), and
     each layout's medians with the busy shares (the graphed spans over
     each kind's median step and chunk);
  12. the rest of jax.jit: (a) each training-step factory eager
     (``step.eager``) and graphed (the CUDA graph of forward, backward and
     the capturable AdamW's step) from the same weights, 3 steps each on
     phase 6's batch: a 1-device mesh (the JAX train demo's layout),
     (data 2, model 4), (data 2, model 2, context 2), the MoE decoder on
     (data 2, model 4) and the GPipe step on (data 2, pipe 4) with M = 4;
     every graphed step's loss within TRAIN_LOSS_ATOL of the eager run's,
     the first step's gradient norm within TRAIN_GNORM_RTOL; prints each
     run's median step ms (steps 2-3), host ms inside the call, the call's
     CUDA-event span, the busy share (span over wall), the graph's kernel
     and copy nodes, the pool's bytes and the banded launches it holds;
     (b) ring_flash_attention, ulysses_flash_attention (a context axis of
     4) and sharded_flash_attention (a model axis of 4) at (4, 8, 8192, 128)
     bf16, forward + backward eager and graphed (a forward and a backward
     graph): a replay's output and gradients within attn_tol of the eager
     call's; prints both ms and the graphs; (c) phase 3g's bucketed engine
     eager and graphed (a graph a bucket, the first-token sampler's graph
     drawing from the engine's generator), after two warm-up requests (the
     captures), on phase 3's 18 requests and 2 sampled ones: every token
     equal, the last prompt token's logits within LOGIT_ATOL of phase 3's
     chunked engine; prints both prefill rates;
  13. serving over a process group, one process a mesh slot: (a) four
     ranks (torch.multiprocessing spawn) on cuda:0 joined by a gloo group
     (NCCL refuses ranks that share a card; gloo's collectives of CUDA
     tensors go through the host, so a graphed step refuses and the ranks
     run eagerly) serve phase 3's 18 requests at the 168M configuration on
     tp = 4, cp = 4 and model 2 x seq 2 meshes (weights from a CUDA
     generator, the same in every process), and run the four standalone
     callables, beside the same on single-controller meshes of cuda:0 in
     this process: tokens equal up to each request's first top-2 tie,
     every rank's equal, logits within LOGIT_ATOL, the callables within
     attn_tol; prints the requests equal in full, the largest differences,
     the launches and collective calls over the ranks and each rank's
     wall; (b) a world-size-1 NCCL group in this process: the flat engine
     on its mesh, graphed with the collectives inside, gives phase 3's
     tokens up to the first tie, its decode graph's nodes printed beside
     phase 11's; then each callable graphed on cuda:0 four times, called
     with two caches of one shape in turn, equal to the eager call on its
     own cache, two graphs of one replay each (nodes and replays printed).
  14. training over a process group, one process a mesh slot: (a) four
     spawned ranks on cuda:0 over gloo, each holding its slot of the 168M
     decoder (slot_params / slot_stages), take 2 eager AdamW steps on
     phase 6's batch on dense sp (data 2, model 2), cp (data 1, model 2,
     context 2), MoE (4 experts, data 2, model 2) and GPipe (data 2, pipe
     2, M 2), and run the ring, Ulysses and sharded callables at 6b(a)'s
     shape forward and backward; this process runs the same on
     single-controller meshes of cuda:0 first: every rank's losses equal
     and its gathered parameters bit-equal, the first loss and gathered
     gradient norm within phase 6's gates of the single process's, the
     parameters after the steps within TRAIN_PG_UPDATE_RTOL, the
     callables within attn_tol; prints each rank's step walls, collective
     calls and banded launches; (b) a world-size-1 NCCL group: the graphed
     step on its one-slot mesh against phase 12(a)'s 1-device graph, its
     collectives captured, and a graphed ring on it.
  15. the four cards of one host, only where four cards are (on one card
     a line saying that it needs a host of four cards): (a) one process
     drives cuda:0..3: the tp = 4, cp = 4 and model 2 x seq 2 engines of
     phase 13 on phase 3's requests, graphed (one graph a step across the
     cards) and eager, tokens and logits bit-equal to the same layout on
     cuda:0 four times, a quarter of a profiled replay's decode and append
     kernels on each card, the four serving callables bit-equal too; (b)
     dryrun_multichip(4) on the four cards; (c) four NCCL ranks, rank k on
     cuda:k, started by maybe_init_distributed() under torchrun's
     variables: the engines and callables graphed, bit-equal to (a)'s, and
     phase 14(a)'s layouts and callables graphed within its gates against
     the single process on cuda:0; prints walls, busy shares, graph nodes
     and collective calls beside (a)'s; (d) one process drives cuda:0..3
     in training: phase 14(a)'s four layouts (a slot a card) and phase
     12(a)'s (data 2, model 4) (two slots a card) take MC_TRAIN_STEPS
     AdamW (capturable) steps on phase 6's batch, each step one CUDA graph
     across the four cards (forward, backward in the capturing thread,
     optimizer), and the ring, Ulysses and sharded callables run a forward
     and a backward graph each across them; the first loss bit-equal to
     the eager step's on the same cards, the rest within phase 14(a)'s
     gates of the eager step and of the single process on cuda:0, the
     callables within attn_tol of both, each card running its own shard's
     attention kernels in a profiled replay; prints walls, host ms, spans,
     busy shares, nodes and pool bytes by card beside (c)'s and 12(a)'s.

The kernels' JSON line gives each kernel's launches from the run of the
path that takes it by default ("path": the engine, the speculative engine,
the training steps or the op path's public calls), its error, its times,
its bound (the larger of its bytes over 3.35 TB/s and its products over
the peak of their type) and the time of one PyTorch call computing the same
function (null where there is none); the serving kernels add the payloads
held against their plain versions, each payload's time, and their launches
in phase 3c, the window engine's launches (3f(b)), the rolled tables'
errors (3f(a)), the tp engine's launches (3h(b)) and their numbers at a
head shard's heads (3h(a)); the op kernels the ring and the sharded step
can take (flash_fwd, banded_fwd, window_fwd, resident_fwd,
flash_bwd_fused, window_bwd, banded_bwd) add their launches in phase 6b's
runs under test ("ring train (6b)"; the mha and plain references left
out); banded_fwd and banded_bwd add their launches in the MoE steps ("moe
train (6c)") and the pipeline's ("pipeline train (6d)"), the op kernels
phase 12's graphed runs launched, the wrappers' (eager first calls and
captures) and the replays' apart ("compiled (12)"), and the serving
kernels theirs in the MoE engine's runs ("moe engine (3i)") and in
phase 13 ("process group (13)": the ranks' eager engines summed over the
ranks, and the NCCL engine's wrapper launches and graph replays);
banded_fwd and banded_bwd add the ranks' training steps of phase 14(a)
("process group (14)").  The four sequence-sharded variants follow as kernels of
their own ("paged_decode[cp]", ...; launches from the cp engine of phase
3e, times and library yardsticks from 3e(a) on shard 0), then the ten
experiment kernels (phase 8; the
numbers of each tool's first variant, every variant's under "variants").
The last lines are that JSON object, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# bf16 activations: a logit differs by a few bf16 ulps between two matmul
# orders; 8 layers of bf16 residual rounding bound the CPU-vs-card drift
LOGIT_ATOL = 0.1
# serving attention (phases 2-3e): kernel and plain version round q and p
# to bf16 at the same points and sum in other orders, so an output element
# parts by a rounding flip, one bf16 ulp of its own magnitude (at most 2**-7
# of the largest): allow 2 ulps at the output's magnitude, with no floor
# (the random caches give outputs well below 1)
def attn_tol(ref):
    return 2 * 2.0 ** -8 * float(ref.abs().max())


# op kernels (phase 5): float32 differs from its plain version by summation
# order only, 1e-5 at the output's scale (the reference model allows
# 1e-6 * k_len, 2e-3 at k_len 2000); half outputs are rounded once by both
# sides from float32: 2 ulps of the output type at the tensor's scale (the
# reference model allows 1e-3 * k_len)
def op_tol(dtype, ref):
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    return 2 * ulp * max(1.0, float(ref.float().abs().max()))


# lossless gate (phase 3d): a top-2 logit gap under this is a tie, where
# two float32 runs that sum in other orders may pick either token
GAP_TIE = 1e-3
# sequence-sharded variants (phase 3e): l sums the same float32 p, and m is
# the maximum of the same float32 logits, as their plain versions; they part
# by summation order only: l within this relative error, m within it times
# max(1, |m|)
LM_RTOL = 1e-5
# context-parallel float32 gate (phase 3e(c)): cp and flat compute the same
# float32 attention and part by the merge's summation order only (~1e-6 of
# a logit through 8 layers); a logit error under half the tie gap cannot
# flip a greedy token that is not a tie, while a lost or mis-weighted shard
# moves the logits by far more
CP_F32_LOGIT_ATOL = GAP_TIE / 2

# training (phase 6): kernels and plain path both compute attention in
# float32 and round o to bf16, so they part only where a rounding flips (one
# bf16 ulp); through 8 bf16 layers that moves the mean loss (~10.4) by far
# less than 2e-3, and the gradient norm by less than 1%
TRAIN_LOSS_ATOL = 2e-3
TRAIN_GNORM_RTOL = 1e-2
# the step's median before the experiment forwards moved to the tensor
# cores (H100 80GB HBM3 at 700 W; PERF.md section 5), which the step should
# not move: printed beside this run's
STEP_MS_BEFORE = 88.142
# the engines' prefill rates before paged_prefill moved to the tensor cores
# (tokens/s, wall clock, which moves by tens of percent from run to run; H100
# 80GB HBM3 at 700 W; PERF.md section 5): printed beside this run's
PREFILL_TOKS_BEFORE = {"engine": 43432.9, "speculative": 43340.6, "e4m3": 44052.6,
                       "int4 speculative": 47078.3, "int4": 40867.0, "cp engine": 18781.4,
                       "cp engine speculative": 17767.2, "flat engine": 22850.6,
                       "flat engine speculative": 21290.3}
# int8 forward, CPU vs card (phase 9): a rounding that moves a projection's
# input across a code boundary moves it by a whole step (1/127 of its row's
# largest value), and the flips cascade through the layers; so the int8
# forward's logits respond to any rounding difference by far more than the
# dense forward's, past LOGIT_ATOL.  The card may differ from the CPU by
# twice the CPU forward's own response to a 2**-9 nudge of its norm scales,
# measured in the run
INT8_NOISE_FACTOR = 2
# CPU vs card (phase 7): bf16 matmuls accumulate in other orders on the two
# devices; the mean of 512 token losses agrees to well under 1e-2
CPU_LOSS_ATOL = 1e-2


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n=20):
    """Median device time of ``fn()`` in ms: CUDA events around 5 windows of
    ``n // 5`` back-to-back calls after a warm-up (the port's
    ``utils/profiling.device_time``)."""
    from tf_flash_attention_tpu_torch.utils.profiling import device_time
    return device_time(fn, (), n=max(1, n // 5), reps=5) * 1e3


def kernel_ms(fn, names, n=20):
    """The kernels' own device time per ``fn()`` in ms: torch.profiler's
    device time of the kernels whose names contain one of ``names``, summed
    over ``n`` calls after a warm-up, over ``n``.  None where the profiler
    saw none of them (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in names))
    return total / 1e3 / n if total else None


#: the CUDA kernels of each serving wrapper, by name, as the profiler lists them
SERVING_KERNEL_NAMES = {"paged_decode": ("decode_tc_kernel", "paged_decode_kernel"),
                        "paged_prefill": ("prefill_tc_kernel", "paged_prefill_kernel"),
                        "kv_chunk_write": ("kv_chunk_write_kernel",),
                        "kv_append": ("kv_append_kernel",)}
SERVING_KERNEL_NAMES["paged_multitoken_decode"] = SERVING_KERNEL_NAMES["paged_decode"]


def bound(n_bytes, n_ops, ops_type):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak of their type, at the H100 SXM's published
    rates (``utils/profiling.H100_SXM``)."""
    from tf_flash_attention_tpu_torch.utils.profiling import H100_SXM
    peak = {"bf16": H100_SXM.mxu_bf16_flops, "f32": H100_SXM.mxu_fp32_flops,
            "int8": H100_SXM.mxu_int8_ops}[ops_type]
    t_bytes = n_bytes / H100_SXM.hbm_bytes * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# cache payloads by name: the quant_dtype, or None for an unquantized bf16 cache
PAYLOADS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
            "int4": "int4", "bf16": None}


def payload_cfg(payload, **kw):
    from tf_flash_attention_tpu_torch.serving.kv_cache import KVCacheConfig
    qd = PAYLOADS[payload]
    return KVCacheConfig(quantized=qd is not None, quant_dtype=torch.int8 if qd is None else qd,
                         dtype=torch.bfloat16, **kw)


def token_bytes(cfg):
    """Stored bytes of one token of one kv head: payload and scale."""
    if not cfg.quantized:
        return cfg.head_dim_store * cfg.payload_dtype.itemsize
    return cfg.head_dim_store / cfg.tok_pack + 4


def make_cache(cfg, dev, gen, lengths, mapped=8):
    """A cache with random contents: ``mapped`` pages per slot, given lengths."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache
    cache = PagedKVCache.create(cfg, dev)
    fill_random(cache, cfg, dev, gen)
    S = cfg.max_seqs
    perm = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)[:S * mapped]
    cache.page_tables[:, :mapped] = perm.reshape(S, mapped).to(torch.int32)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    return cache


def fill_random(cache, cfg, dev, gen):
    """Random pages and scales: quantized payloads span their type's range;
    scales bring every payload to values of the same size as int8's."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _quant_max
    for pages in (cache.k_pages, cache.v_pages):
        if cfg.is_int4:
            pages.copy_(torch.randint(-128, 128, pages.shape, generator=gen, device=dev))
        elif cfg.quantized and cfg.quant_dtype == torch.int8:
            pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, device=dev))
        elif cfg.quantized:
            qmax = _quant_max(cfg.quant_dtype)
            x = torch.randn(pages.shape, generator=gen, device=dev) * (qmax / 8)
            pages.copy_(x.clamp(-qmax, qmax))
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    if cfg.quantized:
        unit = 127.0 / _quant_max(cfg.quant_dtype)
        for sc in (cache.k_scales, cache.v_scales):
            sc.copy_((0.005 + 0.02 * torch.rand(sc.shape, generator=gen, device=dev)) * unit)


def clone_cache(c):
    return dataclasses.replace(c, **{f.name: (None if getattr(c, f.name) is None
                                              else getattr(c, f.name).clone())
                                     for f in dataclasses.fields(c)})


def _raw(x):
    """One-byte payloads as their bytes: fp8 compares bit for bit."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


def diff_outside_trash(a, b, trash):
    """Names and mismatch counts of the cache tensors that differ."""
    diffs = []
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None and not torch.equal(_raw(x[:, :trash]), _raw(y[:, :trash])):
            diffs.append(f"{name}: {int((_raw(x[:, :trash]) != _raw(y[:, :trash])).sum())} "
                         f"elements")
    return diffs


def kernel_case(name, n_q, n_kv, payload, dev, gen, page_size=256, gamma=None, d=128):
    """Phase 2 for one configuration, at the serving slice's shapes (d 128, 16
    slots of up to 2048 tokens, chunk 512): the four kernels, or with
    ``gamma`` only paged_multitoken_decode.  Returns {kernel: {err, ms,
    plain_ms, bound_ms, bound_by}}; bounds count this case's data (live
    tokens, visible pairs)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill

    S, chunk, mapped = 16, 512, 2048 // page_size
    cfg = payload_cfg(payload, n_kv_heads=n_kv, head_dim=d, page_size=page_size,
                      n_pages=S * mapped + S + 1, max_seqs=S, max_pages_per_seq=2 * mapped)
    trash = cfg.n_pages - 1
    lengths = torch.randint(1, 2048, (S,), generator=gen, device=dev).tolist()
    lengths[3] = 0          # an empty slot: decode gives exact zeros
    lengths[5] = 512        # a length on a page boundary
    cache = make_cache(cfg, dev, gen, lengths, mapped)
    bf = torch.bfloat16
    tok = token_bytes(cfg)
    act = 2                 # bf16 activations
    scale = 1.0 / d ** 0.5
    rule = CausalRule()
    out = {}

    def record(kernel, err, kern, plain, n_bytes, n_ops):
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        out[kernel] = dict(err=err, ms=time_ms(kern),
                           kernel_ms=kernel_ms(kern, SERVING_KERNEL_NAMES[kernel]),
                           plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by)

    def check_decode(kernel, fn, ref, q_rows):
        """A decode case on the card: within attn_tol of its plain version,
        the empty slot exact zeros, two calls bit-equal, the body
        native.decode_body names; then the library yardstick, one
        scaled_dot_product_attention on every slot's K/V gathered and
        widened to bf16 beforehand with the per-row causal offset mask."""
        o = fn()
        err = check_attn(kernel, o, ref)
        if not torch.equal(o[3], torch.zeros_like(o[3])):
            fail(f"{name}: {kernel} empty slot is not zero")
        if not torch.equal(fn(), o):
            fail(f"{name}: two calls of {kernel} differ")
        ran = decode_ran(kernel, cfg, name)
        lib, lib_o = decode_library(q_rows, cache, cfg, lengths)
        lib_o = lib_o.reshape(ref.shape)
        live = torch.tensor([n > 0 for n in lengths], device=dev)
        ran.update(deterministic=True, library_ms=time_ms(lib),
                   library_err=float((lib_o[live].float() - ref[live].float()).abs().max()))
        return err, ran

    def check_attn(kernel, o, ref):
        torch.cuda.synchronize()
        err = float((o.float() - ref.float()).abs().max())
        if not torch.isfinite(o).all() or err > attn_tol(ref):
            fail(f"{name}: {kernel} max error {err} > {attn_tol(ref)}")
        return err

    if gamma is not None:
        # K5 paged_multitoken_decode: every live slot's lengths count gamma drafts
        q = torch.randn((S, gamma, n_q, d), generator=gen, device=dev).to(bf)
        ref = decode._paged_multitoken_decode_plain(q, cache, cfg, scale, rule)
        err, ran = check_decode("paged_multitoken_decode",
                                lambda: decode.paged_multitoken_decode(q, cache, cfg), ref, q)
        live = sum(lengths)
        pairs = sum(n - gamma + i + 1 for n in lengths if n for i in range(gamma))
        record("paged_multitoken_decode", err,
               lambda: native.paged_multitoken_decode(q, cache, cfg, scale * LOG2E, rule),
               lambda: decode._paged_multitoken_decode_plain(q, cache, cfg, scale, rule),
               2 * n_kv * live * tok + 2 * q.numel() * act, 4 * n_q * d * pairs)
        out["paged_multitoken_decode"].update(ran)
    else:
        # K3 kv_chunk_write: the projection's (chunk, n_kv, d) K/V transposed
        # (strided, as the engine passes it), a chunk crossing pages, with
        # padding rows (an odd true_len: an int4 byte row half padding)
        start, true_len = 1100, 451
        k = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
        v = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
        ck, cp = clone_cache(cache), clone_cache(cache)
        kv_cache.write_tokens_at(ck, cfg, 0, start, k, v, true_len, trash)
        ran = kv_ran("kv_chunk_write", k, v, cfg, name)
        # the kernel's scalars: a device meta vector, built once here
        wmeta = kv_cache.chunk_write_meta(0, start, true_len, trash, 1, dev)[0]
        kv_cache._write_tokens_plain(cp, cfg, wmeta, k, v)
        torch.cuda.synchronize()
        diffs = diff_outside_trash(ck, cp, trash)
        if diffs or not torch.equal(ck.lengths, cp.lengths):
            fail(f"{name}: kv_chunk_write differs from its plain version: {diffs}")
        record("kv_chunk_write", 0.0,
               lambda: native.kv_chunk_write(ck, cfg, wmeta, k, v),
               lambda: kv_cache._write_tokens_plain(cp, cfg, wmeta, k, v),
               2 * n_kv * true_len * (d * act + tok), 0)
        out["kv_chunk_write"].update(ran, entry_ms=time_ms(
            lambda: kv_cache.write_tokens_at(ck, cfg, 0, start, k, v, true_len, trash)))
        if not cfg.quantized and d == cfg.head_dim_store:
            # the library yardstick: index_put_ of the same rows into the K
            # and V pages (one call each), at the bf16 cache the rows are
            pos = start + torch.arange(true_len, device=dev)
            at = (torch.arange(n_kv, device=dev)[:, None],
                  cache.page_tables[0].long()[(pos // page_size) % cfg.max_pages_per_seq][None],
                  (pos % page_size)[None])
            cl = clone_cache(cache)
            lib = lambda: (cl.k_pages.index_put_(at, k[:, :true_len]),
                           cl.v_pages.index_put_(at, v[:, :true_len]))
            lib()
            out["kv_chunk_write"].update(library_ms=time_ms(lib),
                                         library_same=not diff_outside_trash(cl, ck, trash))

        # K4 kv_append: one token a slot, twice (int4 lengths land on both
        # nibbles), then gamma 4 tokens a slot in one launch (the speculative
        # step's); two inactive slots
        kn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
        vn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
        kg = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
        vg = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
        active = torch.ones(S, dtype=torch.bool, device=dev)
        active[3] = active[7] = False
        ck, cp = clone_cache(cache), clone_cache(cache)
        bodies = []
        for kk, vv in ((kn, vn), (kn, vn), (kg, vg)):
            kv_cache.append_tokens_batched(ck, cfg, kk, vv, active, trash)
            bodies.append(kv_ran("kv_append", kk, vv, cfg, name)["body"])
            kv_cache._append_tokens_plain(cp, cfg, kk if kk.dim() == 4 else kk[:, None],
                                          vv if vv.dim() == 4 else vv[:, None], active, trash)
            torch.cuda.synchronize()
            diffs = diff_outside_trash(ck, cp, trash)
            if diffs or not torch.equal(ck.lengths, cp.lengths):
                fail(f"{name}: kv_append (T {kk.shape[1] if kk.dim() == 4 else 1}) differs "
                     f"from its plain version: {diffs}")
        # bytes the kernel must move: the active slots' K/V rows read, their
        # payload and scales written (an inactive slot loads nothing)
        n_act = int(active.sum())
        row_bytes = 2 * n_act * n_kv * (d * act + tok)
        record("kv_append", 0.0, lambda: native.kv_append(ck, cfg, kn, vn, active),
               lambda: kv_cache._append_plain(cp, cfg, kn, vn, active, trash), row_bytes, 0)
        out["kv_append"].update(
            body=bodies[0], body_gamma4=bodies[2], entry_ms=time_ms(
                lambda: kv_cache.append_tokens_batched(ck, cfg, kn, vn, active, trash)),
            kernel_ms_gamma4=kernel_ms(lambda: native.kv_append(ck, cfg, kg, vg, active),
                                       SERVING_KERNEL_NAMES["kv_append"]),
            bound_ms_gamma4=bound(4 * row_bytes, 0, "bf16")[0])
        if not cfg.quantized and d == cfg.head_dim_store:
            # the library yardstick: index_put_ of the active slots' rows at
            # their lengths (positions taken once, beforehand)
            live = active.nonzero()[:, 0]
            lens = ck.lengths.long()[live]
            at = (torch.arange(n_kv, device=dev)[None],
                  ck.page_tables.long()[live, (lens // page_size) % cfg.max_pages_per_seq][:, None],
                  (lens % page_size)[:, None])
            k_live, v_live = kn[live], vn[live]
            lib = lambda: (ck.k_pages.index_put_(at, k_live), ck.v_pages.index_put_(at, v_live))
            out["kv_append"].update(library_ms=time_ms(lib))

        # K1 paged_decode
        q = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
        ref = decode._paged_decode_plain(q, cache, cfg, scale, rule)
        err, ran = check_decode("paged_decode",
                                lambda: decode.paged_decode_attention(q, cache, cfg), ref,
                                q[:, None])
        live = sum(lengths)
        record("paged_decode", err,
               lambda: native.paged_decode(q, cache, cfg, scale * LOG2E, rule),
               lambda: decode._paged_decode_plain(q, cache, cfg, scale, rule),
               2 * n_kv * live * tok + 2 * q.numel() * act, 4 * n_q * d * live)
        out["paged_decode"].update(ran)

        # K2 paged_prefill: a chunk at position 1024 of slot 0 (a cached prefix)
        start, true_len = 1024, 512
        qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
        o = prefill.paged_prefill_attention(qp, cache, cfg, 0, start, true_len)
        ran = prefill_ran("paged_prefill", cfg, name)
        qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
        pmeta = prefill.prefill_meta(cfg, 0, start, true_len, rule, 1, dev)[0]
        ref = prefill._paged_prefill_plain(qs, cache, cfg, pmeta, rule)
        err = check_attn("paged_prefill", o[:true_len], ref[:true_len])
        total = start + true_len
        pairs = sum(start + i + 1 for i in range(true_len))
        record("paged_prefill", err,
               lambda: native.paged_prefill(qs, cache, cfg, pmeta, rule),
               lambda: prefill._paged_prefill_plain(qs, cache, cfg, pmeta, rule),
               2 * n_kv * total * tok + 2 * qp.numel() * act, 4 * n_q * d * pairs)
        out["paged_prefill"].update(ran)
        if ran["body"] == "tensor-core":
            # the library yardstick: one scaled_dot_product_attention on the
            # chunk's K/V gathered and widened to bf16 beforehand, with the
            # causal offset mask (the lowest time a library route could reach)
            k_all, v_all = gathered_kv(cache, cfg, 0, total)
            q4 = qp.permute(1, 0, 2).unsqueeze(0)
            mask = (torch.arange(total, device=dev)[None, :]
                    <= start + torch.arange(chunk, device=dev)[:, None])
            gqa = dict(enable_gqa=True) if n_q != n_kv else {}
            lib = lambda: F.scaled_dot_product_attention(q4, k_all[None], v_all[None],
                                                         attn_mask=mask, **gqa)
            lib_o = lib()[0].permute(1, 0, 2)
            out["paged_prefill"].update(library_ms=time_ms(lib),
                                        library_err=float((lib_o.float() - ref.float())
                                                          .abs().max()))
    for kname, r in out.items():
        extra = "".join(f" {x}={json.dumps(r[x])}" for x in KERNEL_EXTRAS if x in r)
        print(f"kernel {name} {kname}: max_abs_err={r['err']} ms={r['ms']} "
              f"kernel_ms={json.dumps(r['kernel_ms'])} plain_ms={r['plain_ms']} "
              f"bound_ms={r['bound_ms']} ({r['bound_by']}){extra}", flush=True)
    return out


#: the measurements a phase 2 kernel line prints beside its times and bound
KERNEL_EXTRAS = ("body", "splits", "ctas", "library_ms", "library_err", "library_same",
                 "entry_ms", "body_gamma4", "kernel_ms_gamma4", "bound_ms_gamma4")


def kv_ran(kernel, k, v, cfg, label):
    """The body the last launch of a KV write (``kv_chunk_write``, its
    ``[cp]`` variant or ``kv_append``) ran, as the launch reports it; fails
    unless it is the one ``native.kv_write_body`` names for these K/V."""
    from tf_flash_attention_tpu_torch import native
    body, want = native.WALKS[kernel]["body"], native.kv_write_body(k, v, cfg)
    if body != want:
        fail(f"{label}: {kernel} ran the {body} body, kv_write_body names {want}")
    return dict(body=body)


def prefill_ran(kernel, cfg, label, act=torch.bfloat16):
    """The body the last launch of ``kernel`` (paged_prefill or its [cp]
    variant) ran, as the launch reports it; fails unless it is the one
    ``native.prefill_body`` names for these activations and cache."""
    from tf_flash_attention_tpu_torch import native
    ran = dict(native.WALKS[kernel])
    if ran["body"] != native.prefill_body(act, cfg):
        fail(f"{label}: {kernel} ran the {ran['body']} body, prefill_body names "
             f"{native.prefill_body(act, cfg)}")
    return ran


def decode_ran(kernel, cfg, label, act=torch.bfloat16):
    """What the last launch of a decode kernel (or its [cp] variant)
    reported: its body, splits and CTAs; fails unless the body is the one
    ``native.decode_body`` names for these activations and cache."""
    from tf_flash_attention_tpu_torch import native
    ran = dict(native.WALKS[kernel])
    if ran["body"] != native.decode_body(act, cfg):
        fail(f"{label}: {kernel} ran the {ran['body']} body, decode_body names "
             f"{native.decode_body(act, cfg)}")
    return ran


def decode_library(q, cache, cfg, lengths):
    """The decode's library yardstick: one scaled_dot_product_attention on
    every slot's K/V gathered and widened to bf16 beforehand (padded to the
    longest slot), query row i of a slot of length n seeing keys up to n -
    gamma + i.  q (S, gamma, n_q, d).  Returns (the call, its output as (S,
    gamma, n_q, d)); an empty slot's rows are NaN there."""
    S, gamma, n_q, d = q.shape
    top = max(lengths)
    k_all = torch.zeros((S, cfg.n_kv_heads, top, d), dtype=torch.bfloat16, device=q.device)
    v_all = torch.zeros_like(k_all)
    for b, n in enumerate(lengths):
        if n:
            k_all[b, :, :n], v_all[b, :, :n] = gathered_kv(cache, cfg, b, n)
    n_t = torch.tensor(lengths, device=q.device)
    mask = (torch.arange(top, device=q.device)[None, None, :]
            <= (n_t[:, None, None] - gamma + torch.arange(gamma, device=q.device)[None, :, None]))
    q4 = q.permute(0, 2, 1, 3)                        # (S, n_q, gamma, d)
    gqa = dict(enable_gqa=True) if n_q != cfg.n_kv_heads else {}
    lib = lambda: F.scaled_dot_product_attention(q4, k_all, v_all, attn_mask=mask[:, None],
                                                 **gqa)
    return lib, lib().permute(0, 2, 1, 3)


def int4_tool_library(q, k, ks, v, vs):
    """The int4 unpack tool's library yardstick: one
    scaled_dot_product_attention of its B rows over the K/V they share
    (k, v (n_kv, pages, rows, d) int8 or int4 pairs, scales (n_kv, pages,
    pack, rows)), dequantized and widened to bf16 beforehand, each row a
    query position of the n_kv G heads (``enable_gqa``).  q (B, n_kv, G, d)
    bf16.  Returns the call."""
    from tf_flash_attention_tpu_torch.experiments.exp_int4_unpack import _tokens
    B, n_kv, G, d = q.shape
    pack = ks.shape[2]
    kv = []
    for pages, scales in ((k, ks), (v, vs)):
        vals, sc = _tokens(pages, scales, pack)
        kv.append((vals * sc[..., None]).reshape(1, n_kv, -1, d).to(torch.bfloat16).contiguous())
    q4 = q.permute(1, 2, 0, 3).reshape(1, n_kv * G, B, d)
    return lambda: F.scaled_dot_product_attention(q4, *kv, enable_gqa=True)


def gathered_kv(cache, cfg, slot, total):
    """K and V of a slot's first ``total`` tokens on the card, dequantized and
    widened to bf16, (n_kv, total, head_dim): the library yardstick's input."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _page_tokens
    phys = cache.page_tables[slot, :-(-total // cfg.page_size)].long()
    out = []
    for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
        x, sc = _page_tokens(pages[:, phys], None if scales is None else scales[:, phys], cfg)
        if sc is not None:
            x = x * sc[..., None]
        out.append(x.reshape(cfg.n_kv_heads, -1, x.shape[-1])[:, :total, :cfg.head_dim]
                   .to(torch.bfloat16).contiguous())
    return out


def banded_tc_fwd(name):
    """Whether a kernel (demangled, or mangled where no cu++filt is at
    hand) is the banded walk of the tensor-core forward, WALK kBanded (1):
    the body of banded_fwd and window_fwd."""
    return re.search(r"fwd_tc_kernel(<[^,>]+, (\(int\))?1,|I(13__nv_bfloat16|6__half)Li1E)",
                     name) is not None


def build_report(native):
    """Each source's nvcc seconds and ptxas's report: every kernel of the
    experiment forwards, the tensor-core backwards (kv-outer and q-outer,
    with and without the split pair's halves), the banded walks of the
    tensor-core forward (banded_fwd and window_fwd), prefill and decode, and any other that spills or
    whose wgmma ptxas serializes."""
    for src, log in sorted(native.BUILD_LOG.items(), key=lambda kv: -kv[1]["seconds"]):
        kernels = native.ptxas_summary(src)
        print(f"build {src}: {log['seconds']:.3f} s, {len(kernels)} kernels, at most "
              f"{max((k['registers'] for k in kernels), default=0)} registers", flush=True)
        for k in kernels:
            if (src == "exp_forward_kernels.cu" or k["spill_stores"] or k["warnings"]
                    or banded_tc_fwd(k["name"])
                    or any(b in k["name"] for b in ("qouter_tc", "bwd_tc_kernel", "prefill_tc",
                                                    "decode_tc"))):
                print(f"  ptxas {k['name']}: {k['registers']} registers, spill stores "
                      f"{k['spill_stores']} B, loads {k['spill_loads']} B; "
                      f"{'; '.join(k['warnings']) or 'no warnings'}", flush=True)
        kv = [k for k in kernels if any(w in k["name"] for w in ("kv_chunk_write", "kv_append"))]
        if kv:
            print(f"  ptxas KV writes: {len(kv)} kernels, at most "
                  f"{max(k['registers'] for k in kv)} registers, spill stores "
                  f"{sum(k['spill_stores'] for k in kv)} B, loads "
                  f"{sum(k['spill_loads'] for k in kv)} B", flush=True)
        spilled = [k["name"] for k in kernels if "decode_tc" in k["name"]
                   and (k["spill_stores"] or k["spill_loads"])]
        if spilled:
            fail(f"the tensor-core decode body spills: {spilled}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # ---- 0: device ----
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {smi.stdout.strip().splitlines()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    # ---- 1: build (one nvcc per source, all at once) ----
    t0 = time.perf_counter()
    libs = native.build()
    for src in libs:
        native.library(src)
    print(f"build: {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    build_report(native)
    t0 = time.perf_counter()
    host = native.get_lib()
    print(f"build: host runtime {os.path.basename(host._name)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    built_schedules = record_schedules()

    # ---- 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cases = {"int8": kernel_case("int8_8q8kv", 8, 8, "int8", dev, gen)}
    kernel_case("int8_gqa_8q2kv", 8, 2, "int8", dev, gen)
    cases["bf16"] = kernel_case("bf16_8q8kv", 8, 8, "bf16", dev, gen)
    # ---- 2b: the fp8 and int4 payloads, and the gamma 4 multi-token decode ----
    for payload in ("e4m3", "e5m2", "int4"):
        cases[payload] = kernel_case(f"{payload}_8q8kv", 8, 8, payload, dev, gen)
    cases["int4_page512"] = kernel_case("int4_8q8kv_page512", 8, 8, "int4", dev, gen,
                                        page_size=512)
    for payload in ("int8", "bf16", "e4m3", "int4"):
        mt = kernel_case(f"{payload}_8q8kv_gamma4", 8, 8, payload, dev, gen, gamma=4)
        cases[payload].update(mt)
    # 16 query rows a block; int4 at page 512 is the largest shared memory
    kernel_case("int8_gqa_8q2kv_gamma4", 8, 2, "int8", dev, gen, gamma=4)
    kernel_case("int4_gqa_8q2kv_gamma4_page512", 8, 2, "int4", dev, gen, page_size=512,
                gamma=4)
    # shapes the JAX package takes that the kernels refused before: GQA 8 at
    # gamma 4 (32 query rows a kv head: two row groups), head_dim_store 384,
    # and pages of 16 tokens (below the prefill's 32-key sub-tile)
    kernel_case("int8_gqa_16q2kv_gamma4", 16, 2, "int8", dev, gen, gamma=4)
    kernel_case("int8_8q8kv_d384", 8, 8, "int8", dev, gen, d=384)
    kernel_case("bf16_8q8kv_d384_gamma4", 8, 8, "bf16", dev, gen, gamma=4, d=384)
    kernel_case("int8_8q8kv_page16", 8, 8, "int8", dev, gen, page_size=16)
    # ---- 2(r): the chunk kernels' scalars on the device, through a graph ----
    meta_replay_case(dev, gen)

    # ---- 3: the engine at the 168M configuration ----
    mcfg = ModelConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                       d_head=128, d_ff=4096, dtype=torch.bfloat16)
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=True, prefill_chunk=512)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    cpu_model = init_params(mcfg, cpu_gen, device="cpu")
    n_params = sum(p.numel() for p in cpu_model.parameters())
    print(f"model: {n_params} params, init {time.perf_counter() - t0:.3f} s", flush=True)
    prompt_gen = torch.Generator().manual_seed(args.seed + 1)

    def prompt(n):
        return torch.randint(1, mcfg.vocab, (n,), generator=prompt_gen).tolist()

    lens = torch.randint(300, 1901, (18,), generator=prompt_gen).tolist()
    prompts = [prompt(n) for n in lens]
    shared = prompt(512)                      # two full pages
    prompts[4] = shared + prompt(300)
    prompts[5] = shared + prompt(700)
    n_new = 32

    eng = DecodeEngine(mcfg, cpu_model, ecfg, device=dev)   # casts its own copy
    chunked_logits = record_prompt_logits(eng)
    results, launches = serve("engine", eng, [(p, None) for p in prompts], n_new, mcfg.vocab)
    chunked_logits, chunked_rate = dict(chunked_logits), eng.rates[0]   # the census's stay out
    replayed_3 = eng.replayed
    dense_rates = {"engine": eng.rates}
    if eng.prefix_cache.hits < 1:
        fail("the prefix cache never hit")
    kernels_3 = ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")
    if min(launches[k] for k in kernels_3) < 1:
        fail(f"a kernel of the path never launched: {launches}")
    greedy_3 = [results[r] for r in range(len(prompts))]
    census("engine", eng, args.seed)
    del eng
    torch.cuda.empty_cache()

    # ---- 3b: speculative serving at full width ----
    pattern = prompt(64)
    reqs = [(p, None) for p in prompts] + [(pattern * 8, None), (pattern * 12, None)]
    sampled = SamplingParams(temperature=0.8, top_k=50)
    reqs += [(prompt(700), sampled), (prompt(1200), sampled)]
    eng = DecodeEngine(mcfg, cpu_model, dataclasses.replace(ecfg, speculative_tokens=3),
                       device=dev)
    results, spec_launches = serve("speculative", eng, reqs, n_new, mcfg.vocab)
    if spec_launches["paged_multitoken_decode"] < 1 or spec_launches["kv_append"] < 1:
        fail(f"speculative serving did not run its kernels: {spec_launches}")
    same = sum(results[r] == greedy_3[r] for r in range(len(prompts)))
    print(f"speculative: spec_stats {json.dumps(eng.spec_stats)}; "
          f"{eng.stats['decode_tokens'] / eng.stats['steps']:.3f} tokens per step; greedy "
          f"requests equal to phase 3's: {same} of {len(prompts)} = {same / len(prompts)}",
          flush=True)
    launches["paged_multitoken_decode"] = spec_launches["paged_multitoken_decode"]
    dense_rates["speculative"] = eng.rates
    census("speculative", eng, args.seed)
    del eng
    torch.cuda.empty_cache()

    # ---- 3c: fp8 and int4 caches at full width ----
    payload_launches = quantized_engines(mcfg, cpu_model, ecfg, prompts[:8], n_new, dev)

    # ---- 3d: the speculative engine is lossless on the card ----
    lossless_gate(mcfg, args.seed, prompts[:8] + [pattern * 8], n_new, dev)

    # ---- 3e: context-parallel serving, 4 shards on the card ----
    cp_measured, cp_launches = cp_phase(mcfg, cpu_model, args.seed, n_new, dev)

    # ---- 3f: sliding-window serving ----
    # (a) the serving kernels on rolled page tables
    t0 = time.perf_counter()
    rolled = {p: rolled_case(f"rolled_{p}", p, dev, gen) for p in ("int8", "int4")}
    print(f"phase 3f(a): {time.perf_counter() - t0:.3f} s", flush=True)
    # (b) the window engine at full width; (c) a float32 gate, flat and cp = 4
    window_launches = window_engine_phase(mcfg, cpu_model, args.seed, dev)
    window_gate(mcfg, args.seed, dev)

    # ---- 3g: the bucketed prefill on phase 3's requests ----
    bucketed_phase(mcfg, cpu_model, ecfg, prompts, n_new, chunked_logits, chunked_rate, dev)

    # ---- 3h: tensor-parallel serving, a model axis of 4 on the card ----
    tp_heads = tp_kernel_phase(cases, dev, gen)
    tp_launches = tp_engine_phase(mcfg, cpu_model, ecfg, prompts, pattern, n_new, greedy_3,
                                  chunked_logits, args.seed, dev)
    tp_gate(mcfg, args.seed, dev)

    # ---- 3i: MoE serving: a float32 gate, then the 168M decoder with 4 experts ----
    t0 = time.perf_counter()
    moe_gate(mcfg, args.seed, dev)
    moe_launches = moe_engine_phase(mcfg, ecfg, prompts, n_new, dense_rates, args.seed, dev)
    print(f"phase 3i: {time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 4: logits on the CPU (plain versions) against the card ----
    small = EngineConfig(max_seqs=1, page_size=256, n_pages=18, max_pages_per_seq=16,
                         quantized_kv=True, prefill_chunk=512)
    p = prompt(512)
    n_follow = 16
    outs = {}
    for where in ("cpu", "cuda"):
        e = DecodeEngine(mcfg, cpu_model, small, device=where)
        rid = e.submit(p, max_new_tokens=n_follow)
        e.step()
        logits = e.last_prefill_logits.float().cpu()
        outs[where] = (logits, e.run(max_steps=100)[rid][len(p):])
    err = float((outs["cpu"][0] - outs["cuda"][0]).abs().max())
    if not torch.isfinite(outs["cuda"][0]).all() or err > LOGIT_ATOL:
        fail(f"CPU-vs-card logits differ by {err} > {LOGIT_ATOL}")
    agree = sum(a == b for a, b in zip(outs["cpu"][1], outs["cuda"][1])) / n_follow
    print(f"logits: CPU vs card max_abs_err={err} (tol {LOGIT_ATOL}), "
          f"max |logit| {float(outs['cpu'][0].abs().max())}; "
          f"greedy tokens agreeing {agree}", flush=True)

    # ---- 5: the op path's kernels against the plain path ----
    torch.manual_seed(args.seed)
    op, op_launches = op_phase(dev)
    # ---- 5q: float64 through the chunked path, and the reference harness ----
    float64_phase(dev, args.seed)

    # ---- 6: training at full width ----
    train_launches, train_tokens, loss_plain, gnorm_plain = train_phase(mcfg, cpu_model, dev,
                                                                        args.seed)
    # ---- 6b: ring and Ulysses at the op level, the sharded step at full width ----
    t0 = time.perf_counter()
    ring_launches = ring_op_phase(dev, args.seed)
    _add_launches(ring_launches, ring_train_phase(mcfg, cpu_model, dev, train_tokens,
                                                  loss_plain, gnorm_plain))
    print(f"phase 6b: {time.perf_counter() - t0:.3f} s; launches {json.dumps(ring_launches)}",
          flush=True)
    # ---- 6c: MoE training (and expert parallelism); 6d: the GPipe step ----
    moe_train_launches = moe_train_phase(mcfg, dev, train_tokens, args.seed)
    pipe_launches = pipeline_phase(mcfg, cpu_model, dev, train_tokens, loss_plain, gnorm_plain)
    # each kernel's count from the run of the path that takes it by default:
    # the training step's (banded) kernels from phase 6, the others from the
    # op path's public calls in phase 5
    path_of = {k: "engine (phase 3)" for k in native.SERVING_KERNELS}
    for k in native.ATTENTION_KERNELS:
        if train_launches.get(k):
            path_of[k], launches[k] = "train step (phase 6)", train_launches[k]
        else:
            path_of[k], launches[k] = "op path (phase 5)", op_launches[k]
    path_of["flash_bwd_qouter"] = "direct call with fused='q' (phase 5h; no public route)"

    # ---- 7: one training step on the CPU (plain versions) and on the card ----
    cpu_card_phase(mcfg, cpu_model, dev, args.seed)

    # ---- 8: the experiment tools' kernels at the tools' shapes ----
    exp_entries, exp_launches = experiment_phase(dev, args.seed)

    # ---- 9: weight-only int8 projections ----
    quant_phase(mcfg, cpu_model, dev, args.seed)

    # ---- 10: the rest of the package ----
    t0 = time.perf_counter()
    checkpoint_phase(mcfg, cpu_model, dev, train_tokens)
    classifier_phase(built_schedules)
    graft_phase(dev)
    examples_phase()
    print(f"phase 10: {time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 11: the compiled steps, graphed against eager, every layout ----
    compiled_11 = compiled_phase(mcfg, cpu_model, ecfg, prompts, pattern, args.seed, dev)

    # ---- 12: the rest of jax.jit: the training steps, the parallel
    # attention callables and the bucketed prefill, graphed against eager ----
    t0 = time.perf_counter()
    compiled, graphed_12a, figures_12a = compiled_train_phase(mcfg, cpu_model, dev, train_tokens,
                                                              args.seed)
    del train_tokens
    compiled_callables_phase(dev, args.seed, compiled)
    compiled_bucketed_phase(mcfg, cpu_model, ecfg, prompts, chunked_logits, args.seed, dev)
    print(f"phase 12: {time.perf_counter() - t0:.3f} s; op kernels of the graphed runs "
          f"{json.dumps(compiled)}", flush=True)

    # ---- 13: serving over a process group: (a) four ranks on the card over
    # gloo, (b) one rank over NCCL with its collectives in the graphs, and
    # the standalone callables' graphs keyed by their caches ----
    t0 = time.perf_counter()
    pg_launches = process_group_phase(mcfg, ecfg, prompts, n_new, args.seed, dev)
    nccl_launches = nccl_phase(mcfg, cpu_model, ecfg, prompts, greedy_3,
                               compiled_11["flat"]["graphs"], args.seed, dev)
    graph_keys_phase(dev, args.seed)
    print(f"phase 13: {time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 14: training over a process group: (a) four ranks on the card over
    # gloo, each holding its slot, (b) one rank over NCCL with its
    # collectives in the step's graph ----
    t0 = time.perf_counter()
    train_pg_launches = train_pg_phase(mcfg, args.seed, dev)
    train_nccl_phase(mcfg, cpu_model, graphed_12a, args.seed, dev)
    print(f"phase 14: {time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 15: the port across the four cards of one host: (a) one process
    # driving cuda:0..3, its engines graphed across them, (b)
    # dryrun_multichip(4), (c) four NCCL ranks, a card each, graphed, (d)
    # one process training across cuda:0..3, graphed ----
    if torch.cuda.device_count() >= CARDS:
        multicard_phases(mcfg, ecfg, prompts, n_new, args.seed, dev, compiled_11, figures_12a)
    else:
        print(f"phase 15: not run here: it needs {CARDS} cards of one host and this one has "
              f"{torch.cuda.device_count()}; run `python3 chip_smoke.py` on a host with {CARDS} "
              f"cards", flush=True)

    csrc = "tf_flash_attention_tpu_torch/csrc/"
    replaces = {
        "paged_decode": "tf_flash_attention_tpu/serving/decode.py:113",
        "paged_multitoken_decode": "tf_flash_attention_tpu/serving/decode.py:113 "
                                   "(gamma > 1, call :477)",
        "paged_prefill": "tf_flash_attention_tpu/serving/prefill.py:49",
        "kv_chunk_write": "tf_flash_attention_tpu/serving/kv_cache.py:286",
        "kv_append": "tf_flash_attention_tpu/serving/kv_cache.py:548",
        "flash_fwd": "tf_flash_attention_tpu/ops/forward.py:57",
        "flash_bwd_fused": "tf_flash_attention_tpu/ops/backward.py:255",
        "flash_bwd_dq": "tf_flash_attention_tpu/ops/backward.py:104",
        "flash_bwd_dkv": "tf_flash_attention_tpu/ops/backward.py:174",
        "banded_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:65",
        "banded_bwd": "tf_flash_attention_tpu/ops/backward.py:457",
        "window_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:165",
        "window_bwd": "tf_flash_attention_tpu/ops/backward.py:377",
        "resident_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:326",
        "flash_bwd_qouter": "tf_flash_attention_tpu/ops/backward.py:541",
    }
    path_of["paged_multitoken_decode"] = "speculative engine (phase 3b)"
    # serving kernels: time and bound of the int8 slice case (phase 2), each
    # payload's beside it; the attention kernels' library time is phase 2's
    # scaled_dot_product_attention on the gathered K/V (the writes have none)
    measured = {k: {"library_ms": None, **cases["int8"][k]} for k in native.SERVING_KERNELS}
    # the KV writes' library time: index_put_ of the same rows at the bf16
    # cache (phase 2's bf16 case), where a write is a cast and a scatter
    for k in ("kv_chunk_write", "kv_append"):
        measured[k].update(library_ms=cases["bf16"][k]["library_ms"], library_payload="bf16")
    measured.update(op)
    lines = []
    for k in replaces:
        m = measured[k]
        entry = {"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                 "replaces": replaces[k], "launches": launches[k], "path": path_of[k],
                 "max_abs_err": m["err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                 "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                 "library_ms": m["library_ms"],
                 **{x: m[x] for x in ("body", "splits", "ctas", "deterministic", "library_err",
                                      "ms_without_dq", "grid", "items", "group_rows",
                                      "kernel_ms", "gqa", "pair", "entry_ms",
                                      "kernel_ms_gamma4", "bound_ms_gamma4",
                                      "library_payload", "shapes") if x in m}}
        if k in ("banded_fwd", "banded_bwd"):
            # the MoE steps (6c, unsharded and expert-parallel) and the
            # pipeline's (6d)
            entry["moe train (6c)"] = moe_train_launches.get(k, 0)
            entry["pipeline train (6d)"] = pipe_launches[k]
            # phase 14(a): the ranks' eager steps over gloo, every layout
            entry["process group (14)"] = {
                "path": f"14(a): {', '.join(l for l, _, _, _ in TRAIN_PG_LAYOUTS)} steps, "
                        f"{PG_WORLD} ranks on the card over {PG_BACKEND}, eager",
                "launches": train_pg_launches.get(k, 0)}
        if k in compiled:
            # phase 12's graphed steps and callables: the wrappers' launches
            # (eager first calls, captures) and the graphs' replays apart
            entry["compiled (12)"] = compiled[k]
        if k in RING_KERNELS:
            entry["ring_train"] = {"path": "ring train (6b): the ring and Ulysses on a context "
                                           "axis of 4, and the 168M sharded step on (data 2, "
                                           "model 4) and (data 2, model 2, context 2)",
                                   "launches": ring_launches.get(k, 0)}
        if k in native.SERVING_KERNELS:
            # the launches phase 3's graph replays made beside its wrappers'
            entry["replayed (phase 3)"] = replayed_3.get(k, 0)
            # the MoE engine's runs (phase 3i(b), with and without speculation)
            entry["moe engine (3i)"] = moe_launches.get(k, 0)
            # the window engine's run (phase 3f(b)) and the rolled tables'
            # errors against the plain versions and the dense oracle (3f(a))
            entry["window_engine"] = {"path": "window engine (phase 3f(b): int8, with and "
                                              "without speculation)",
                                      "launches": window_launches[k]}
            entry["rolled_tables"] = {p: r[k] for p, r in rolled.items()}
            # the tp engine's run (phase 3h(b)) and the kernels at a head
            # shard's heads (3h(a))
            entry["tp_engine"] = {"path": f"tp engine (phase 3h(b): a model axis of {TP} on "
                                          f"the card, int8, with and without speculation)",
                                  "launches": tp_launches[k]}
            entry["tp_heads"] = {name: r[k] for name, r in tp_heads.items() if k in r}
            # phase 13: the ranks' engines (13(a), eager, the three layouts
            # over the four ranks) and the NCCL rank's graphed engine (13(b))
            entry["process group (13)"] = {
                "path": f"13(a): tp = 4, cp = 4 and model 2 x seq 2 engines, {PG_WORLD} ranks "
                        f"on the card over {PG_BACKEND}, eager; 13(b): the flat engine on a "
                        f"world-size-1 NCCL group, graphed (wrapper launches)",
                "launches": pg_launches.get(k, 0),
                "nccl_engine": nccl_launches.get(k, {"launches": 0, "replayed": 0})}
            entry["payloads_held"] = [pl for pl, c in cases.items() if k in c]
            entry["ms_by_payload"] = {pl: c[k]["ms"] for pl, c in cases.items() if k in c}
            entry["launches_by_payload"] = {pl: n[k] for pl, n in payload_launches.items()}
        lines.append(entry)
    # the sequence-sharded variants: times and bounds of phase 3e(a) on shard
    # 0 (8 q / 8 kv heads), launches of the cp engine (phase 3e(b))
    cp_replaces = {
        "paged_decode[cp]": replaces["paged_decode"] + " (returning_l_m, page_stride, "
                                                       "global_lengths; call :341)",
        "paged_multitoken_decode[cp]": replaces["paged_multitoken_decode"]
        + " (returning_l_m, page_stride, global_lengths)",
        "paged_prefill[cp]": replaces["paged_prefill"] + " (returning_l_m, page_stride; "
                                                         "call :304)",
        "kv_chunk_write[cp]": replaces["kv_chunk_write"] + " (page_stride, _phys :356-365; "
                                                           "call :395)",
    }
    for k in native.CP_VARIANTS:
        m = cp_measured[k]
        lines.append({"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                      "replaces": cp_replaces[k], "launches": cp_launches[k],
                      "path": "cp engine (phase 3e)", "max_abs_err": m["err"], "ms": m["ms"],
                      "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"], "library_ms": m.get("library_ms"),
                      **({"rolled_tables": {p: r[k] for p, r in rolled.items()}}
                         if k == "paged_decode[cp]" else {}),
                      "process group (13)": {"path": f"13(a) engines over {PG_WORLD} ranks",
                                             "launches": pg_launches.get(k, 0)},
                      **{x: m[x] for x in ("body", "splits", "ctas", "deterministic",
                                           "kernel_ms", "l_err", "m_err", "merge_err",
                                           "cp_step_ms", "flat_ms", "entry_ms", "library_call",
                                           "library_err") if x in m}})
    # the experiment tools' kernels: the numbers of each tool's first
    # variant, every variant's under "variants" (phase 8)
    for k in native.EXPERIMENT_KERNELS:
        m = exp_entries[k]
        lines.append({"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                      "replaces": EXP_REPLACES[k], "launches": exp_launches[k],
                      "path": "experiment tools (phase 8)", "max_abs_err": m["err"],
                      "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                      **{x: m[x] for x in ("body", "splits", "ctas", "kernel_ms", "yardstick")
                         if x in m},
                      "variants": m["variants"]})
    print(json.dumps({"kernels": lines}))
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def serve(label, eng, reqs, n_new, vocab):
    """Run ``reqs`` [(prompt, SamplingParams or None[, new tokens])] through
    ``eng`` with the launch counts reset just before; checks every request
    returns its prompt and its new tokens (``n_new`` unless the request
    says) of the vocabulary, prints the stats and the rates (wall clock;
    prefill timed around each admission's prefill), which it also leaves in
    ``eng.rates`` as (prefill, decode) tokens/s, and the launches that
    graph replays made in ``eng.replayed``.  Returns ({rid: tokens},
    {kernel: launches in this run}: the wrappers', where a graph's capture
    counts its kernels once)."""
    from tf_flash_attention_tpu_torch import native

    prefill_s = [0.0]
    inner = eng._prefill

    def timed_prefill(p, slot):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner(p, slot)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return r

    eng._prefill = timed_prefill
    news = [r[2] if len(r) > 2 else n_new for r in reqs]
    rids = [eng.submit(p, max_new_tokens=n, **({} if sp is None else {"sampling": sp}))
            for (p, sp, *_), n in zip(reqs, news)]
    native.reset_launch_counts()
    st0 = dict(eng.stats)           # an engine that served before counts on
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    eng.replayed = {k: n for k, n in native.REPLAYED.items() if n}
    for rid, (p, *_), n in zip(rids, reqs, news):
        got = results.get(rid, [])
        if len(got) != len(p) + n or got[:len(p)] != p:
            fail(f"{label}: request {rid} returned {len(got)} tokens, expected {len(p) + n}")
        if not all(0 <= t < vocab for t in got[len(p):]):
            fail(f"{label}: request {rid} produced a token outside the vocabulary")
    decode_s = wall - prefill_s[0]
    st = {k: v if k == "pages_in_use_peak" else v - st0[k] for k, v in eng.stats.items()}
    # the body of the run's prefill launches (one shape rule for them all:
    # the last launch's report stands for the run's)
    bodies = {k: prefill_ran(k, eng.ccfg, label, eng.mcfg.dtype)
              for k in ("paged_prefill", "paged_prefill[cp]") if launches[k]}
    bodies.update({k: decode_ran(k, eng.ccfg, label, eng.mcfg.dtype)
                   for k in ("paged_decode", "paged_decode[cp]", "paged_multitoken_decode",
                             "paged_multitoken_decode[cp]") if launches[k]})
    print(f"{label}: {len(rids)} requests, stats {json.dumps(st)}, prefix hits "
          f"{eng.prefix_cache.hits if eng.prefix_cache else None}, launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}, replayed "
          f"{json.dumps(eng.replayed)}, attention bodies "
          f"{json.dumps(bodies)}", flush=True)
    # the bucketed prefill counts no chunks: its tokens are the prompts'
    n_prefill = (st["prefill_tokens"] if eng.ecfg.prefill_mode == "chunked"
                 else sum(len(r[0]) for r in reqs))
    eng.rates = (n_prefill / prefill_s[0], st["decode_tokens"] / decode_s)
    before = PREFILL_TOKS_BEFORE.get(label)
    beside = "" if before is None else f" (on the scalar prefill: {before}, {eng.rates[0] / before:.3f}x)"
    print(f"{label}: wall {wall:.3f} s; prefill {n_prefill} tokens in "
          f"{prefill_s[0]:.3f} s = {eng.rates[0]:.1f} tokens/s{beside}; "
          f"decode {st['decode_tokens']} tokens in {decode_s:.3f} s over {st['steps']} steps "
          f"= {eng.rates[1]:.1f} tokens/s", flush=True)
    return results, launches


def census(label, eng, seed):
    """Prints the CUDA kernels that ``eng``'s second and third prefill chunks
    and decode (or speculative) steps launch while it serves 4 prompts of
    1,100 tokens (3 chunks) from the seed (``utils/serving_census.py``; no
    claim: the parent's counts come from that script's own runs)."""
    from tf_flash_attention_tpu_torch.utils.serving_census import step_census
    gen = torch.Generator().manual_seed(seed + 13)
    prompts = [torch.randint(1, eng.mcfg.vocab, (1100,), generator=gen).tolist()
               for _ in range(4)]
    print(f"census {label}: {json.dumps(step_census(eng, prompts))}", flush=True)


def quantized_engines(mcfg, cpu_model, ecfg, prompts, n_new, dev):
    """Phase 3c: the 168M engine on an fp8 e4m3 cache (page 256) and on an
    int4 cache (page 512, 81 pages, 8 a sequence) with speculation, each
    serving 8 requests; an int4 run without speculation adds paged_decode.
    Each run must launch its kernels on its payload.  Returns {payload:
    {kernel: launches}}."""
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    int4 = dataclasses.replace(ecfg, kv_quant_dtype="int4", page_size=512, n_pages=81,
                               max_pages_per_seq=8)
    runs = [("e4m3", dataclasses.replace(ecfg, kv_quant_dtype=torch.float8_e4m3fn),
             ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")),
            ("int4 speculative", dataclasses.replace(int4, speculative_tokens=3),
             ("paged_multitoken_decode", "paged_prefill", "kv_chunk_write", "kv_append")),
            ("int4", int4, ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append"))]
    counts, outs = {}, {}
    reqs = [(p, None) for p in prompts]
    for label, cfg, kernels in runs:
        eng = DecodeEngine(mcfg, cpu_model, cfg, device=dev)
        results, launches = serve(label, eng, reqs, n_new, mcfg.vocab)
        if min(launches[k] for k in kernels) < 1:
            fail(f"{label}: a kernel of the path never launched: {launches}")
        counts[label] = launches
        outs[label] = [results[r] for r in range(len(prompts))]
        if label == "int4 speculative":
            print(f"int4 speculative: spec_stats {json.dumps(eng.spec_stats)}", flush=True)
        del eng
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(outs["int4 speculative"], outs["int4"]))
    print(f"int4: requests equal with and without speculation: {same} of {len(prompts)}",
          flush=True)
    return counts


def top2_gaps(cfg, model, prompts, outs, dev):
    """The top-2 gap of each generated token's logits, and the argmax: a
    teacher-forced forward of the model over each output sequence, on the
    card.  Returns (gaps, argmaxes), a list of each per request."""
    from tf_flash_attention_tpu_torch.models import transformer as tf

    card_model = copy.deepcopy(model).to(dev)
    gaps, best = [], []
    with torch.no_grad():
        for p, full in zip(prompts, outs):
            logits = tf.forward(cfg, card_model, torch.tensor([full[:-1]], device=dev))[0]
            top2 = logits[len(p) - 1:].topk(2, dim=-1)
            gaps.append((top2.values[:, 0] - top2.values[:, 1]).cpu().tolist())
            best.append(top2.indices[:, 0].cpu().tolist())
    del card_model
    torch.cuda.empty_cache()
    return gaps, best


def check_to_tie(label, prompts, want, got, gaps):
    """Fail unless each request's generated tokens equal ``want``'s up to its
    first top-2 logit gap under GAP_TIE (a tie, not a fault)."""
    for i, (p, w, g, gap) in enumerate(zip(prompts, want, got, gaps)):
        tie = next((j for j, x in enumerate(gap) if x < GAP_TIE), len(gap))
        if g[len(p):][:tie] != w[len(p):][:tie]:
            fail(f"{label}: request {i} differs before its first tie (position {tie}, gap "
                 f"{min(gap)}): {g[len(p):]} vs {w[len(p):]}")


def lossless_gate(mcfg, seed, prompts, n_new, dev):
    """Phase 3d: 2 layers at the 168M width in float32 (TF32 off), unquantized
    cache.  Speculative greedy tokens must equal the non-speculative ones up
    to the first position where the non-speculative continuation's top-2
    logit gap is under GAP_TIE (a tie, not a fault), with the n-gram
    proposer, with drafts that are the continuation itself (all accepted),
    and with drafts that are all wrong (none accepted)."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 4), device="cpu")
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=False, prefill_chunk=512)

    def run(spec, propose=None):
        eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec),
                           device=dev)
        if propose is not None:
            eng._propose = propose
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        res = eng.run(max_steps=10_000)
        return [res[r] for r in rids], eng.stats, eng.spec_stats

    base, _, _ = run(0)
    torch.cuda.empty_cache()
    gaps, _ = top2_gaps(cfg, model, prompts, base, dev)

    def oracle(shift):
        def propose(hist, n_draft):
            for full in base:
                if hist == full[:len(hist)] and len(full) > len(hist):
                    cont = [(t + shift) % cfg.vocab for t in full[len(hist):len(hist) + n_draft]]
                    return cont + [cont[-1]] * (n_draft - len(cont))
            return [(hist[-1] + shift) % cfg.vocab] * n_draft
        return propose

    for label, propose in (("n-gram drafts", None), ("every draft right", oracle(0)),
                           ("every draft wrong", oracle(1))):
        out, stats, spec = run(3, propose)
        check_to_tie(f"lossless gate ({label})", prompts, base, out, gaps)
        ties = [(i, j, x) for i, gap in enumerate(gaps) for j, x in enumerate(gap) if x < GAP_TIE]
        same = sum(a == b for a, b in zip(out, base))
        print(f"lossless gate ({label}): {same} of {len(prompts)} requests equal in full; "
              f"spec_stats {json.dumps(spec)}; {stats['decode_tokens'] / stats['steps']:.3f} "
              f"tokens per step; ties (request, position, gap) {ties}; smallest gap "
              f"{min(min(g) for g in gaps)}", flush=True)
        if propose is not None and label.endswith("right") and spec["accepted"] < 1:
            fail(f"lossless gate: no right draft was accepted: {spec}")
        if label.endswith("wrong") and spec["accepted"] > spec["proposed"] // 20:
            fail(f"lossless gate: wrong drafts were accepted: {spec}")


N_SHARDS = 4


def lm_errors(got, want):
    """(max relative error of l, max error of m over max(1, |m|)) of the
    sharded variants' statistics against their plain versions."""
    (_, gl, gm), (_, wl, wm) = got, want
    l_err = float(((gl - wl).abs() / wl.abs().clamp_min(1e-30)).max())
    if bool(((wl == 0) & (gl != 0)).any()):
        l_err = math.inf
    m_err = float(((gm - wm).abs() / wm.abs().clamp_min(1.0)).max())
    return l_err, m_err


def cp_kernel_case(label, n_q, n_kv, dev, gen, timed):
    """Phase 3e(a) for one head layout: 4 shards on the card, 16 slots, int8
    cache, page 256, global lengths 1,000-16,000 (slot 0 16,000).  Every
    shard's variant against its plain version, and the merge of the 4
    shards against the flat kernel on the same tokens in one flat cache.
    Returns {variant: {err, l_err, m_err, and with ``timed`` ms, plain_ms,
    bound_ms, bound_by}} (times on shard 0)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill
    from tf_flash_attention_tpu_torch.serving.seq_sharded_decode import (
        _merge_partials, decode_merged)

    n, S, d, ps = N_SHARDS, 16, 128, 256
    owned = lambda total, r: kv_cache._owned_token_count(total, ps, n, r)
    flat_cfg = payload_cfg("int8", n_kv_heads=n_kv, head_dim=d, page_size=ps,
                           n_pages=S * 64 + 1, max_seqs=S, max_pages_per_seq=64)
    cfg = dataclasses.replace(flat_cfg, n_pages=S * 16 + 1, max_pages_per_seq=16)
    lengths = torch.randint(1000, 16001, (S,), generator=gen, device=dev).tolist()
    lengths[0] = 16000
    glob = torch.tensor(lengths, dtype=torch.int32, device=dev)
    flat = kv_cache.PagedKVCache.create(flat_cfg, dev)
    fill_random(flat, flat_cfg, dev, gen)
    perm = torch.randperm(S * 64, generator=gen, device=dev).reshape(S, 64).to(torch.int32)
    flat.page_tables.copy_(perm)
    flat.lengths.copy_(glob)
    # shard r holds global pages r, r + 4, ... of every slot: the flat pages
    # copied to its pages 16 s .. 16 s + 15
    shards = []
    for r in range(n):
        sc = kv_cache.PagedKVCache.create(cfg, dev)
        idx = perm[:, r::n].reshape(-1).long()
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            getattr(sc, name)[:, :S * 16] = getattr(flat, name)[:, idx]
        sc.page_tables.copy_(torch.arange(S * 16, device=dev, dtype=torch.int32).reshape(S, 16))
        sc.lengths.copy_(torch.tensor([owned(x, r) for x in lengths], dtype=torch.int32,
                                      device=dev))
        shards.append(sc)
    bf, scale, tok, act = torch.bfloat16, d ** -0.5, token_bytes(cfg), 2
    shard = lambda r: dict(returning_l_m=True, page_stride=n, page_offset=r)
    out = {}

    def check(variant, got, want, ref_o):
        torch.cuda.synchronize()
        err = float((got[0].float() - want[0].float()).abs().max())
        l_err, m_err = lm_errors(got, want)
        if (not torch.isfinite(got[0]).all() or err > attn_tol(ref_o) or l_err > LM_RTOL
                or m_err > LM_RTOL):
            fail(f"{label}: {variant} o error {err} (tol {attn_tol(ref_o)}), l relative "
                 f"error {l_err}, m error {m_err} (tol {LM_RTOL})")
        r = out.setdefault(variant, dict(err=0.0, l_err=0.0, m_err=0.0))
        r.update(err=max(r["err"], err), l_err=max(r["l_err"], l_err),
                 m_err=max(r["m_err"], m_err))

    def check_merge(variant, parts, flat_o):
        merged = _merge_partials(parts, dev).to(flat_o.dtype)
        torch.cuda.synchronize()
        err = float((merged.float() - flat_o.float()).abs().max())
        if not torch.isfinite(merged).all() or err > attn_tol(flat_o):
            fail(f"{label}: merged {variant} differs from the flat kernel by {err} > "
                 f"{attn_tol(flat_o)}")
        out[variant]["merge_err"] = max(out[variant].get("merge_err", 0.0), err)

    # paged_decode[cp], causal and in a window of 1024; paged_multitoken_decode[cp]
    q = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
    qm = torch.randn((S, 4, n_q, d), generator=gen, device=dev).to(bf)
    for variant, qq, rules in (("paged_decode[cp]", q, (CausalRule(), LocalRule(1024, 0, True))),
                               ("paged_multitoken_decode[cp]", qm, (CausalRule(),))):
        fn = decode.paged_decode_attention if qq.dim() == 3 else decode.paged_multitoken_decode
        plain = (decode._paged_decode_plain if qq.dim() == 3
                 else decode._paged_multitoken_decode_plain)
        for rule in rules:
            parts = []
            for r, sc in enumerate(shards):
                got = fn(qq, sc, cfg, rule=rule, global_lengths=glob, **shard(r))
                ran = decode_ran(variant, cfg, label)
                again = fn(qq, sc, cfg, rule=rule, global_lengths=glob, **shard(r))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{label}: two calls of {variant} (shard {r}) differ")
                want = plain(qq, sc, cfg, scale, rule, True, n, r, glob)
                check(variant, got, want, want[0])
                out[variant].update(ran, deterministic=True)
                parts.append(got)
            check_merge(variant, parts, fn(qq, flat, flat_cfg, rule=rule))
    # paged_prefill[cp]: a 512-token chunk at 12,288 of slot 0
    start, chunk = 12288, 512
    qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
    qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
    parts = []
    for r, sc in enumerate(shards):
        got = prefill.paged_prefill_attention(qp, sc, cfg, 0, start, chunk, **shard(r))
        ran = prefill_ran("paged_prefill[cp]", cfg, label)
        want = prefill._paged_prefill_plain(
            qs, sc, cfg, prefill.prefill_meta(cfg, 0, start, chunk, CausalRule(), n, dev)[r],
            CausalRule(), True, n)
        check("paged_prefill[cp]", got, want, want[0])
        out["paged_prefill[cp]"].update(ran)
        parts.append(got)
    check_merge("paged_prefill[cp]", parts,
                prefill.paged_prefill_attention(qp, flat, flat_cfg, 0, start, chunk))
    # kv_chunk_write[cp] on int8 and int4: the projection's K/V transposed, a
    # chunk crossing pages 4-6 (shards 0-2), an odd true_len (an int4 byte
    # row half padding)
    w_start, w_len = 1100, 451
    k = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    v = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    cfg4 = payload_cfg("int4", n_kv_heads=n_kv, head_dim=d, page_size=ps, n_pages=S * 16 + 1,
                       max_seqs=S, max_pages_per_seq=16)
    int4 = kv_cache.PagedKVCache.create(cfg4, dev)
    fill_random(int4, cfg4, dev, gen)
    int4.page_tables.copy_(shards[0].page_tables)
    for c, ccfg in ((shards, cfg), ([int4] * n, cfg4)):
        for r in range(n):
            ck, cpl = clone_cache(c[r]), clone_cache(c[r])
            kv_cache.write_tokens_at(ck, ccfg, 1, w_start, k, v, w_len, ccfg.n_pages - 1,
                                     n, r)
            out.setdefault("kv_chunk_write[cp]", dict(err=0.0)).update(
                kv_ran("kv_chunk_write[cp]", k, v, ccfg, label))
            kv_cache._write_tokens_plain(cpl, ccfg, kv_cache.chunk_write_meta(
                1, w_start, w_len, ccfg.n_pages - 1, n, dev)[r], k, v, n)
            torch.cuda.synchronize()
            diffs = diff_outside_trash(ck, cpl, ccfg.n_pages - 1)
            if diffs or not torch.equal(ck.lengths, cpl.lengths):
                fail(f"{label}: kv_chunk_write[cp] ({ccfg.quant_dtype}, shard {r}) differs "
                     f"from its plain version: {diffs}")
            del ck, cpl
    # kv_append with the owner test on int8 and int4: one token a slot, then
    # gamma 4 (the speculative step's), slot 5 inactive, on every shard
    # against T ordered plain appends with the owner masks
    kn = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
    vn = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
    live = torch.ones(S, dtype=torch.bool, device=dev)
    live[5] = False
    for c, ccfg in ((shards, cfg), ([int4] * n, cfg4)):
        for r in range(n):
            ck, cpl = clone_cache(c[r]), clone_cache(c[r])
            for x in (ck, cpl):
                x.lengths.copy_(torch.tensor([owned(g, r) for g in lengths], dtype=torch.int32))
            g = glob.clone()
            for T in (1, 4):
                kv_cache.append_tokens_batched(ck, ccfg, kn[:, :T], vn[:, :T], live,
                                               ccfg.n_pages - 1, global_lengths=g,
                                               page_stride=n, page_offset=r)
                kv_ran("kv_append", kn[:, :T], vn[:, :T], ccfg, label)
                kv_cache._append_tokens_plain(cpl, ccfg, kn[:, :T], vn[:, :T], live,
                                              ccfg.n_pages - 1, g, n, r)
                torch.cuda.synchronize()
                diffs = diff_outside_trash(ck, cpl, ccfg.n_pages - 1)
                if diffs or not torch.equal(ck.lengths, cpl.lengths):
                    fail(f"{label}: sharded kv_append ({ccfg.quant_dtype}, shard {r}, T {T}) "
                         f"differs from its plain version: {diffs}")
                g += T * live.to(torch.int32)
            del ck, cpl
    if not timed:
        return out

    # times on shard 0 (the other shards' launches are alike), bounds from
    # shard 0's data: its live tokens, and the (query, key) pairs it holds
    sc = shards[0]
    live = sum(owned(x, 0) for x in lengths)
    lm = lambda rows: 2 * rows * 4                     # l and m, float32
    pairs0 = sum(owned(start + i + 1, 0) for i in range(chunk))
    own_rows = sum(1 for t in range(w_len) if ((w_start + t) // ps) % n == 0)   # 180
    pmeta0 = prefill.prefill_meta(cfg, 0, start, chunk, CausalRule(), n, dev)[0]
    wmeta0 = kv_cache.chunk_write_meta(1, w_start, w_len, cfg.n_pages - 1, n, dev)[0]
    runs = {
        "paged_decode[cp]": (
            lambda: native.paged_decode(q, sc, cfg, scale * LOG2E, CausalRule(), True, n, 0,
                                        glob),
            lambda: decode._paged_decode_plain(q, sc, cfg, scale, CausalRule(), True, n, 0, glob),
            2 * n_kv * live * tok + 2 * q.numel() * act + lm(S * n_q), 4 * n_q * d * live),
        "paged_multitoken_decode[cp]": (
            lambda: native.paged_multitoken_decode(qm, sc, cfg, scale * LOG2E, CausalRule(), True,
                                                   n, 0, glob),
            lambda: decode._paged_multitoken_decode_plain(qm, sc, cfg, scale, CausalRule(), True,
                                                          n, 0, glob),
            2 * n_kv * live * tok + 2 * qm.numel() * act + lm(S * 4 * n_q),
            4 * n_q * d * 4 * live),
        "paged_prefill[cp]": (
            lambda: native.paged_prefill(qs, sc, cfg, pmeta0, CausalRule(), True, n),
            lambda: prefill._paged_prefill_plain(qs, sc, cfg, pmeta0, CausalRule(), True, n),
            2 * n_kv * owned(start + chunk, 0) * tok + 2 * qp.numel() * act + lm(chunk * n_q),
            4 * n_q * d * pairs0),
        "kv_chunk_write[cp]": (
            lambda: native.kv_chunk_write(sc, cfg, wmeta0, k, v, n),
            lambda: kv_cache._write_tokens_plain(sc, cfg, wmeta0, k, v, n),
            2 * n_kv * own_rows * (d * act + tok), 0),
    }
    # the library yardsticks on shard 0 (before the timed chunk writes change
    # slot 1): one memory-efficient attention with its log-sum-exp (the
    # content of the (l, m) pair) on the shard's own keys gathered
    # beforehand, for the attention variants; one index_put_ of the shard's
    # owned rows into bf16 pages (K, then V) for the chunk write (below)
    arange = lambda m: torch.arange(m, device=dev)
    libs = {"paged_decode[cp]": (q[:, :, None], range(S), lengths, (glob - 1)[:, None],
                                 lambda o: o[:, :, None]),
            "paged_multitoken_decode[cp]": (qm.permute(0, 2, 1, 3), range(S), lengths,
                                            glob[:, None] - 4 + arange(4),
                                            lambda o: o.permute(0, 2, 1, 3)),
            "paged_prefill[cp]": (qp.permute(1, 0, 2)[None], [0], [start + chunk],
                                  (start + arange(chunk))[None],
                                  lambda o: o.permute(1, 0, 2)[None])}
    for variant, (q4, slots, totals, q_pos, as_rows) in libs.items():
        lib, lib_o = cp_library(q4.contiguous(), sc, cfg, list(slots), totals, q_pos, 0, n)
        got = as_rows(runs[variant][0]()[0])
        out[variant].update(library_ms=time_ms(lib), library_call="aten._scaled_dot_product_"
                            "efficient_attention(compute_log_sumexp=True)",
                            library_err=float((lib_o.float() - got.float()).abs().max()))
    for variant, (kern, plain, n_bytes, n_ops) in runs.items():
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        out[variant].update(ms=time_ms(kern),
                            kernel_ms=kernel_ms(kern, SERVING_KERNEL_NAMES[variant[:-4]]),
                            plain_ms=time_ms(plain, n=5), bound_ms=b_ms, bound_by=b_by)
        out[variant].update(native.WALKS[variant])   # the timed launch's (shard 0, causal)
    out["kv_chunk_write[cp]"]["entry_ms"] = time_ms(
        lambda: kv_cache.write_tokens_at(sc, cfg, 1, w_start, k, v, w_len, cfg.n_pages - 1, n, 0))
    mine = [t for t in range(w_len) if ((w_start + t) // ps) % n == 0]
    pos = w_start + torch.tensor(mine, device=dev)
    at = (arange(n_kv)[:, None],
          sc.page_tables[1].long()[(pos // ps // n) % cfg.max_pages_per_seq][None],
          (pos % ps)[None])
    k_own, v_own = k[:, mine].contiguous(), v[:, mine].contiguous()
    bf_k = torch.zeros((n_kv, cfg.n_pages, ps, d), dtype=bf, device=dev)
    bf_v = torch.zeros_like(bf_k)
    out["kv_chunk_write[cp]"].update(
        library_ms=time_ms(lambda: (bf_k.index_put_(at, k_own), bf_v.index_put_(at, v_own))),
        library_call="Tensor.index_put_ of the owned rows into bf16 K and V pages")
    # the whole context-parallel decode (4 launches and the merge) against
    # the flat kernel over the same tokens
    out["paged_decode[cp]"]["cp_step_ms"] = time_ms(
        lambda: decode_merged(q, shards, cfg, glob))
    out["paged_decode[cp]"]["flat_ms"] = time_ms(
        lambda: native.paged_decode(q, flat, flat_cfg, scale * LOG2E, CausalRule()))
    for variant, r in out.items():
        print(f"kernel cp {label} {variant}: {json.dumps(r)}", flush=True)
    return out


def cp_library(q4, sc, cfg, slots, totals, q_pos, r, n):
    """The sequence-sharded attention's library yardstick: one
    ``_scaled_dot_product_efficient_attention`` with ``compute_log_sumexp``
    (o and the rows' log-sum-exp, what the (l, m) pair holds) of query rows
    ``q4`` (B, n_q, rows, d) over shard ``r``'s own keys of ``slots`` (each
    up to global length ``totals[i]``), gathered and widened to bf16
    beforehand and masked by global position (a key at or before its row,
    ``q_pos`` (B, rows)).  Returns (the call, its o (B, n_q, rows, d))."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _owned_token_count
    ps, dev = cfg.page_size, q4.device
    B, H, R, d = q4.shape
    if H != cfg.n_kv_heads:
        fail(f"cp library yardstick: {H} q heads over {cfg.n_kv_heads} kv heads")
    owned = [_owned_token_count(t, ps, n, r) for t in totals]
    top = max(owned)
    k_all = torch.zeros((B, H, top, d), dtype=torch.bfloat16, device=dev)
    v_all = torch.zeros_like(k_all)
    for i, (b, m) in enumerate(zip(slots, owned)):
        if m:
            k_all[i, :, :m], v_all[i, :, :m] = gathered_kv(sc, cfg, b, m)
    j = torch.arange(top, device=dev)
    gpos = ((j // ps) * n + r) * ps + j % ps
    live = j[None, :] < torch.tensor(owned, device=dev)[:, None]
    vis = live[:, None, :] & (gpos[None, None, :] <= q_pos[:, :, None])      # (B, rows, keys)
    # the bias rows start on 16-element boundaries, as the kernel wants
    bias = torch.full((B, H, R, -(-top // 16) * 16), -math.inf, dtype=torch.bfloat16,
                      device=dev)[..., :top]
    bias.masked_fill_(vis[:, None], 0.0)
    lib = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q4, k_all, v_all, bias,
                                                                         True)
    return lib, lib()[0]


def cp_phase(mcfg, cpu_model, seed, n_new, dev):
    """Phase 3e: context-parallel serving on the card.  (a) the four
    sequence-sharded variants against their plain versions and the merge
    against the flat kernels; (b) the 168M engine with cp = 4 on the card
    (the shards share it) against the flat engine; (c) a float32 gate.
    Returns ({variant: measurements}, {variant: launches in (b)})."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    measured = cp_kernel_case("int8_8q8kv", 8, 8, dev, gen, timed=True)
    for variant, r in cp_kernel_case("int8_gqa_8q2kv", 8, 2, dev, gen, timed=False).items():
        measured[variant]["err"] = max(measured[variant]["err"], r["err"])
    torch.cuda.empty_cache()

    # (b) the engine at full width: 8 requests of 4,000-15,000 prompt tokens,
    # then speculation on 4 requests whose prompts repeat a 64-token pattern
    mesh = make_mesh((N_SHARDS,), ("seq",), [dev] * N_SHARDS)
    # no prefix caching (the cp engine has none): both engines prefill alike
    cp_cfg = EngineConfig(max_seqs=8, page_size=256, n_pages=129, max_pages_per_seq=16,
                          quantized_kv=True, prefill_chunk=512, prefix_caching=False)
    flat_cfg = dataclasses.replace(cp_cfg, n_pages=513, max_pages_per_seq=64)
    pgen = torch.Generator().manual_seed(seed + 5)
    lens = torch.randint(4000, 15001, (8,), generator=pgen).tolist()
    prompts = [torch.randint(1, mcfg.vocab, (n,), generator=pgen).tolist() for n in lens]
    pattern = torch.randint(1, mcfg.vocab, (64,), generator=pgen).tolist()
    spec_prompts = [pattern * (n // 64) for n in lens[:4]]
    runs, logits = {}, {}
    for label, cfg, kw in (("cp engine", cp_cfg, dict(mesh=mesh)),
                           ("flat engine", flat_cfg, dict(device=dev))):
        for spec, reqs in ((0, prompts), (3, spec_prompts)):
            eng = DecodeEngine(mcfg, cpu_model,
                               dataclasses.replace(cfg, speculative_tokens=spec), **kw)
            name = label + (" speculative" if spec else "")
            logits[name] = record_prompt_logits(eng)
            results, launches = serve(name, eng, [(p, None) for p in reqs], n_new, mcfg.vocab)
            runs[name] = ([results[r] for r in range(len(reqs))], launches)
            if label == "cp engine":
                logits[name] = dict(logits[name])     # the census prompts stay out
                census(name, eng, seed)
            del eng
            torch.cuda.empty_cache()
    cp_launches = {v: runs["cp engine"][1][v] + runs["cp engine speculative"][1][v]
                   for v in native.CP_VARIANTS}
    if min(cp_launches.values()) < 1:
        fail(f"the cp engine did not launch every sequence-sharded variant: {cp_launches}")
    for name in ("", " speculative"):
        cp_out, flat_out = runs["cp engine" + name][0], runs["flat engine" + name][0]
        same = sum(a == b for a, b in zip(cp_out, flat_out))
        err = logits_err(f"cp engine{name}", logits["cp engine" + name],
                         logits["flat engine" + name], LOGIT_ATOL)
        print(f"cp engine{name}: requests equal to the flat engine's: {same} of {len(cp_out)}; "
              f"last prompt token's logits against the flat engine's: max_abs_err {err} (tol "
              f"{LOGIT_ATOL})", flush=True)
    # where a decode step's time goes, cp against flat
    for label, cfg, kw in (("cp engine", cp_cfg, dict(mesh=mesh)),
                           ("flat engine", flat_cfg, dict(device=dev))):
        step_profile(label, DecodeEngine(mcfg, cpu_model, cfg, **kw), prompts)
        torch.cuda.empty_cache()

    # (c) float32 gate: 8 layers, unquantized cache, cp = 4 against flat
    cp_gate(mcfg, seed, mesh, dev)
    print(f"phase 3e: {time.perf_counter() - t0:.3f} s", flush=True)
    return measured, cp_launches


def timed_step_calls(eng, attr):
    """Wrap ``eng``'s step ``attr`` (``_decode_step`` or ``_spec_step``) so
    each call records the host's seconds inside it (the enqueue: no sync)
    and a CUDA-event pair around it on the current stream, whose span is
    the step's device time where its kernels run back to back (a graph's
    replay); returns (host seconds list, event pairs list)."""
    inner, host, events = getattr(eng, attr), [], []

    def step(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        out = inner(*args)
        host.append(time.perf_counter() - t)
        b.record()
        events.append((a, b))
        return out

    setattr(eng, attr, step)
    return host, events


def step_profile(label, eng, prompts, n_steps=3):
    """Decode steps of ``eng`` with ``prompts`` admitted: the wall time of
    ``n_steps`` steps, with the host's ms inside each step call and the
    CUDA-event span of the call (the device time of a graph's replay, its
    kernels back to back), then the device time of ``n_steps`` more by
    kernel class from torch.profiler, and the device's busy share of the
    step's wall time (and of the profiled wall, which the profiler
    stretches).  Where the profiler sees no device event (a graph's replay
    shown only as its launch), the busy share is the event span's."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=2 * n_steps + 2)
    eng.step()                                   # prefill, and one token each
    torch.cuda.synchronize()
    graphed = hasattr(eng._decode_step, "graphs")
    host, events = timed_step_calls(eng, "_decode_step")
    t = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / n_steps * 1e3
    span = statistics.median(a.elapsed_time(b) for a, b in events)
    host_ms = statistics.median(host) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) / n_steps * 1e3
    classes = {}
    for e in prof.events():             # the kernels themselves, each once
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("paged_decode", "kv_append")
                     if any(n in e.name for n in SERVING_KERNEL_NAMES[k])),
                    "matmul" if any(s in e.name.lower() for s in ("gemm", "nvjet", "cutlass"))
                    else "other")
        classes[name] = classes.get(name, 0.0) + e.device_time_total / 1e3 / n_steps
    busy = sum(classes.values())
    head = (f"step profile {label} ({'graphed' if graphed else 'eager'}): step {wall:.3f} ms "
            f"wall; host {host_ms:.3f} ms inside the step call; the call's CUDA-event span "
            f"{span:.3f} ms")
    if busy == 0:
        print(f"{head}; the profiler saw no device events: device busy taken as the event "
              f"span, {span / wall:.3f} of the step's wall", flush=True)
        return
    print(f"{head}; device busy {busy:.3f} ms a step ({busy / wall:.3f} of the step's wall, "
          f"{busy / prof_wall:.3f} of the profiled {prof_wall:.3f} ms); "
          f"device ms a step by class {json.dumps({k: round(v, 4) for k, v in classes.items()})}",
          flush=True)


def record_prompt_logits(eng):
    """{prompt as a tuple: float32 logits of its last token}, filled as
    ``eng`` admits its requests."""
    out, inner = {}, eng._prefill

    def prefill(p, slot):
        r = inner(p, slot)
        # a copy: a graphed chunk's logits are overwritten by its next replay
        out[tuple(p)] = r[0].float().clone()
        return r

    eng._prefill = prefill
    return out


def logits_err(label, got, want, tol):
    """Max abs difference of two engines' last-prompt-token logits over the
    same requests; fails past ``tol``."""
    if got.keys() != want.keys():
        fail(f"{label}: the engines admitted different prompts")
    err = max(float((got[p] - want[p]).abs().max()) for p in want)
    if not all(torch.isfinite(x).all() for x in got.values()) or err > tol:
        fail(f"{label}: last prompt token's logits differ by {err} > {tol}")
    return err


def cp_gate(mcfg, seed, mesh, dev):
    """Phase 3e(c): the 168M decoder (all 8 layers) in float32, unquantized
    cache, on 4 prompts of 4,000-15,000 tokens, as many local pages a shard
    as (b): cp = 4 with and without speculation against the flat engine.
    The last prompt token's logits must agree within CP_F32_LOGIT_ATOL, and
    the greedy tokens up to each request's first top-2 logit tie
    (GAP_TIE)."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = dataclasses.replace(mcfg, dtype=torch.float32)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 6), device="cpu")
    pgen = torch.Generator().manual_seed(seed + 7)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=pgen).tolist()
               for n in torch.randint(4000, 15001, (4,), generator=pgen).tolist()]
    n_new = 16
    cp_cfg = EngineConfig(max_seqs=4, page_size=256, n_pages=4 * 16 + 1, max_pages_per_seq=16,
                          quantized_kv=False, prefill_chunk=512, prefix_caching=False)
    flat_cfg = dataclasses.replace(cp_cfg, n_pages=4 * 64 + 1, max_pages_per_seq=64)

    def run(ecfg, spec, **kw):
        eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec), **kw)
        logits = record_prompt_logits(eng)
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        res = eng.run(max_steps=10_000)
        del eng
        torch.cuda.empty_cache()
        return [res[r] for r in rids], logits

    base, base_logits = run(flat_cfg, 0, device=dev)
    gaps, _ = top2_gaps(cfg, model, prompts, base, dev)
    for spec in (0, 3):
        out, out_logits = run(cp_cfg, spec, mesh=mesh)
        label = f"cp gate (speculative_tokens={spec}, against the flat engine)"
        err = logits_err(label, out_logits, base_logits, CP_F32_LOGIT_ATOL)
        check_to_tie(label, prompts, base, out, gaps)
        same = sum(a == b for a, b in zip(out, base))
        print(f"cp gate (float32, speculative_tokens={spec}): {same} of {len(prompts)} "
              f"requests equal to the flat engine's in full; last prompt token's logits "
              f"max_abs_err {err} (tol {CP_F32_LOGIT_ATOL}); prompt lengths "
              f"{[len(p) for p in prompts]}; smallest top-2 gap {min(min(g) for g in gaps)}",
              flush=True)


# ---- phases 3f and 3g: sliding-window serving and the bucketed prefill ----

# the window phases' rules: a window of 1,024 and a strided one of the same
# reach (256 positions of stride 4)
def window_rules():
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    return (LocalRule(1024, 0, True), LocalRule(256, 2, True))


# the dense windowed oracle (phase 3f(a)): float32 attention on the live K/V
# gathered by position, against kernels that round q, K, V and p to bf16:
# a p rounding moves an output element by at most 2**-9 of the largest
# value, and the outputs are means over hundreds of keys; 8 bf16 ulps at the
# output's scale, while a page read from the wrong table slot or skipped
# moves an output by a sizeable share of it
def oracle_tol(ref):
    return 8 * 2.0 ** -8 * float(ref.abs().max())


def live_kv(cache, cfg, slot, lo, hi):
    """K and V of positions [lo, hi) of ``slot``, gathered by position
    through its (rolled) page table and dequantized: float32 (n_kv, hi - lo,
    head_dim)."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _page_tokens
    ps, mp = cfg.page_size, cfg.max_pages_per_seq
    g0, g1 = lo // ps, (hi - 1) // ps + 1
    phys = cache.page_tables[slot].long()[torch.arange(g0, g1, device=cache.page_tables.device) % mp]
    out = []
    for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
        x, sc = _page_tokens(pages[:, phys], None if scales is None else scales[:, phys], cfg)
        if sc is not None:
            x = x * sc[..., None]
        x = x.reshape(cfg.n_kv_heads, -1, x.shape[-1])
        out.append(x[:, lo - g0 * ps:hi - g0 * ps, :cfg.head_dim].float())
    return out


def window_oracle(q, q_pos, cache, cfg, slot, total, rule, scale):
    """Dense windowed attention of query rows ``q`` (rows, n_q, d) at
    positions ``q_pos`` (rows,) of ``slot`` over its keys below ``total``
    that ``rule`` lets them see, on K/V gathered by position (``live_kv``);
    float32 (rows, n_q, d)."""
    from tf_flash_attention_tpu_torch.serving.decode import _rule_visible
    lo = max(0, int(q_pos.min()) - (rule.strided_window_size - 1))
    k, v = live_kv(cache, cfg, slot, lo, total)
    rows, n_q, d = q.shape
    g = n_q // cfg.n_kv_heads
    kv_pos = torch.arange(lo, total, device=q.device)
    vis = _rule_visible(rule, q_pos[:, None].long(), kv_pos[None, :])    # (rows, keys)
    qh = q.float().reshape(rows, cfg.n_kv_heads, g, d).permute(1, 2, 0, 3)  # (n_kv, g, rows, d)
    s = (qh @ k[:, None].transpose(-1, -2)) * scale                      # (n_kv, g, rows, keys)
    s = s.masked_fill(~vis, -math.inf)
    o = torch.softmax(s, dim=-1) @ v[:, None]                            # (n_kv, g, rows, d)
    return o.permute(2, 0, 1, 3).reshape(rows, n_q, d)


def rolled_cache(cfg, dev, gen, lengths, reach):
    """A cache with random contents whose slot s maps the global pages from
    ``reach[s]`` up to the page of position ``lengths[s] + 4`` at table slot
    ``g % max_pages_per_seq`` (the engine's rolled table), every other table
    slot at the trash page, which holds the payload's largest values at
    scales of 1,000: a kernel that reads a rolled-over slot is far off."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache
    ps, mp, trash = cfg.page_size, cfg.max_pages_per_seq, cfg.n_pages - 1
    cache = PagedKVCache.create(cfg, dev)
    fill_random(cache, cfg, dev, gen)
    for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
        if cfg.is_int4:
            pages[:, trash] = 0x77
        elif cfg.quantized:
            pages[:, trash] = 127
        else:
            pages[:, trash] = 1e3
        if scales is not None:
            scales[:, trash] = 1e3
    table = torch.full((cfg.max_seqs, mp), trash, dtype=torch.int32)
    free = iter(torch.randperm(trash, generator=torch.Generator().manual_seed(len(lengths))).tolist())
    for s, (n, lo) in enumerate(zip(lengths, reach)):
        g0, g1 = lo // ps, (n + 4) // ps + 1
        if g1 - g0 > mp:
            fail(f"rolled case: slot {s} needs {g1 - g0} live pages, the table holds {mp}")
        for g in range(g0, g1):
            table[s, g % mp] = next(free)
    cache.page_tables.copy_(table)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def rolled_case(label, payload, dev, gen):
    """Phase 3f(a) for one payload: 16 slots, page 256, max_pages_per_seq 10
    (the table reaches 2,560 tokens), slot lengths 3,000-12,000, 8 q / 8 kv
    heads, d 128; every slot's table rolled, the slots below its window at
    the trash page (``rolled_cache``).  For each window rule: paged_decode,
    paged_multitoken_decode (gamma 4) and paged_prefill (a 512-token chunk at
    3,000 or more) against their plain versions (attn_tol) and against the
    dense windowed oracle (oracle_tol), each on the body native names;
    kv_chunk_write and kv_append (one token, then gamma 4) bit for bit with
    lengths; paged_decode[cp] at cp = 4 on shards whose local tables roll,
    each shard against its plain version and the shards' merge against the
    oracle.  Returns {kernel: {err, oracle_err, ...}}."""
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill
    from tf_flash_attention_tpu_torch.serving.seq_sharded_decode import _merge_partials

    S, ps, mp, d, n_q, n_kv, chunk = 16, 256, 10, 128, 8, 8, 512
    cfg = payload_cfg(payload, n_kv_heads=n_kv, head_dim=d, page_size=ps,
                      n_pages=S * mp + 1, max_seqs=S, max_pages_per_seq=mp)
    trash = cfg.n_pages - 1
    lengths = torch.randint(3600, 12001, (S,), generator=gen, device=dev).tolist()
    lengths[1] = 36 * 256          # a length on a page boundary
    # the oldest row any kernel below runs: the prefill chunk's first
    reach = [max(0, n - chunk - 1023) for n in lengths]
    cache = rolled_cache(cfg, dev, gen, lengths, reach)
    glob = torch.tensor(lengths, dtype=torch.int32, device=dev)
    bf, scale = torch.bfloat16, d ** -0.5
    out = {}

    def check(kernel, rule, got, want, oracle):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        o_err = float((got.float() - oracle).abs().max())
        if not torch.isfinite(got).all() or err > attn_tol(want) or o_err > oracle_tol(oracle):
            fail(f"{label}: {kernel} ({rule}) on rolled tables: error {err} against its plain "
                 f"version (tol {attn_tol(want)}), {o_err} against the dense windowed oracle "
                 f"(tol {oracle_tol(oracle)})")
        r = out.setdefault(kernel, {})
        r.update(err=max(r.get("err", 0.0), err), oracle_err=max(r.get("oracle_err", 0.0), o_err))

    q1 = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
    q4 = torch.randn((S, 4, n_q, d), generator=gen, device=dev).to(bf)
    start = lengths[0] - chunk
    qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
    qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
    for rule in window_rules():
        name = f"LocalRule({rule.window_size}, {rule.log2_stride_size})"
        for kernel, q in (("paged_decode", q1), ("paged_multitoken_decode", q4)):
            gamma = 1 if q.dim() == 3 else 4
            fn = (decode.paged_decode_attention if gamma == 1 else decode.paged_multitoken_decode)
            plain = (decode._paged_decode_plain if gamma == 1
                     else decode._paged_multitoken_decode_plain)
            got = fn(q, cache, cfg, rule=rule)
            out.setdefault(kernel, {}).update(decode_ran(kernel, cfg, label))
            want = plain(q, cache, cfg, scale, rule)
            qq = q.reshape(S, gamma, n_q, d)
            oracle = torch.stack([
                window_oracle(qq[b], torch.arange(n - gamma, n, device=dev), cache, cfg, b, n,
                              rule, scale) for b, n in enumerate(lengths)]).reshape(q.shape)
            check(kernel, name, got, want, oracle)
        got = prefill.paged_prefill_attention(qp, cache, cfg, 0, start, chunk, rule=rule)
        out.setdefault("paged_prefill", {}).update(prefill_ran("paged_prefill", cfg, label))
        want = prefill._paged_prefill_plain(
            qs, cache, cfg, prefill.prefill_meta(cfg, 0, start, chunk, rule, 1, dev)[0], rule)
        oracle = window_oracle(qs.float() / (scale * LOG2E), torch.arange(start, start + chunk,
                               device=dev), cache, cfg, 0, start + chunk, rule, scale)
        check("paged_prefill", name, got, want, oracle)

    # the KV writes on rolled tables: a chunk of 451 real rows at an even
    # start 512 or 513 tokens below slot 2's length, then appends at every
    # slot's length, one token and then 4 (slot 5 inactive)
    w_start = (lengths[2] - chunk) & ~1
    k = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    v = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    ck, cpl = clone_cache(cache), clone_cache(cache)
    kv_cache.write_tokens_at(ck, cfg, 2, w_start, k, v, 451, trash)
    out["kv_chunk_write"] = dict(err=0.0, **kv_ran("kv_chunk_write", k, v, cfg, label))
    kv_cache._write_tokens_plain(cpl, cfg, kv_cache.chunk_write_meta(2, w_start, 451, trash, 1,
                                                                     dev)[0], k, v)
    torch.cuda.synchronize()
    diffs = diff_outside_trash(ck, cpl, trash)
    if diffs or not torch.equal(ck.lengths, cpl.lengths):
        fail(f"{label}: kv_chunk_write on a rolled table differs from its plain version: {diffs}")
    kn = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
    vn = torch.randn((S, 4, n_kv, d), generator=gen, device=dev).to(bf)
    act = torch.ones(S, dtype=torch.bool, device=dev)
    act[5] = False
    ck, cpl = clone_cache(cache), clone_cache(cache)
    for T in (1, 4):
        kv_cache.append_tokens_batched(ck, cfg, kn[:, :T], vn[:, :T], act, trash)
        out["kv_append"] = dict(err=0.0, **kv_ran("kv_append", kn[:, :T], vn[:, :T], cfg, label))
        kv_cache._append_tokens_plain(cpl, cfg, kn[:, :T], vn[:, :T], act, trash)
        torch.cuda.synchronize()
        diffs = diff_outside_trash(ck, cpl, trash)
        if diffs or not torch.equal(ck.lengths, cpl.lengths):
            fail(f"{label}: kv_append (T {T}) on a rolled table differs from its plain version: "
                 f"{diffs}")
    del ck, cpl

    # paged_decode[cp]: shard r holds global pages r, r + 4, ... of every
    # slot, local page j at its table slot j % 10; the live ones copied from
    # the flat cache, the rolled-over ones at the trash page
    n = N_SHARDS
    shards = []
    for r in range(n):
        sc = kv_cache.PagedKVCache.create(cfg, dev)
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            if getattr(sc, name) is not None:
                getattr(sc, name)[:, trash] = getattr(cache, name)[:, trash]
        table = torch.full((S, mp), trash, dtype=torch.int32)
        nxt = 0
        for b, L in enumerate(lengths):
            for g in range(reach[b] // ps, -(-L // ps)):
                if g % n != r:
                    continue
                src = int(cache.page_tables[b, g % mp])
                for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
                    if getattr(sc, name) is not None:
                        getattr(sc, name)[:, nxt] = getattr(cache, name)[:, src]
                table[b, (g // n) % mp] = nxt
                nxt += 1
        sc.page_tables.copy_(table)
        sc.lengths.copy_(torch.tensor([kv_cache._owned_token_count(L, ps, n, r) for L in lengths],
                                      dtype=torch.int32))
        shards.append(sc)
    for rule in window_rules():
        parts = []
        for r, sc in enumerate(shards):
            got = decode.paged_decode_attention(q1, sc, cfg, rule=rule, returning_l_m=True,
                                                page_stride=n, page_offset=r, global_lengths=glob)
            ran = decode_ran("paged_decode[cp]", cfg, label)
            want = decode._paged_decode_plain(q1, sc, cfg, scale, rule, True, n, r, glob)
            torch.cuda.synchronize()
            err = float((got[0].float() - want[0].float()).abs().max())
            l_err, m_err = lm_errors(got, want)
            if err > attn_tol(want[0]) or l_err > LM_RTOL or m_err > LM_RTOL:
                fail(f"{label}: paged_decode[cp] shard {r} on a rolled table: o error {err}, l "
                     f"{l_err}, m {m_err}")
            parts.append(got)
            rec = out.setdefault("paged_decode[cp]", dict(err=0.0, oracle_err=0.0))
            rec.update(ran, err=max(rec["err"], err))
        merged = _merge_partials(parts, dev)
        oracle = torch.stack([window_oracle(q1[b][None], torch.tensor([L - 1], device=dev), cache,
                                            cfg, b, L, rule, scale)[0]
                              for b, L in enumerate(lengths)])
        o_err = float((merged - oracle).abs().max())
        if not torch.isfinite(merged).all() or o_err > oracle_tol(oracle):
            fail(f"{label}: the merged paged_decode[cp] on rolled tables differs from the dense "
                 f"windowed oracle by {o_err} > {oracle_tol(oracle)}")
        out["paged_decode[cp]"]["oracle_err"] = max(out["paged_decode[cp]"]["oracle_err"], o_err)
    print(f"rolled tables {label}: lengths {lengths}; {json.dumps(out)}", flush=True)
    return out


def kv_bodies(label):
    """Fail unless the last launches of the KV writes ran the vector row
    body (the one native.kv_write_body names for the projection's K/V at
    head_dim_store 128)."""
    from tf_flash_attention_tpu_torch import native
    for k in ("kv_chunk_write", "kv_append"):
        if native.LAUNCHES[k] and native.WALKS[k]["body"] != "vector":
            fail(f"{label}: {k} ran the {native.WALKS[k]['body']} body")


def window_forward_logits(cfg, model, prompts, dev):
    """{prompt: float32 logits of its last token} from one ``forward`` of
    the model over each whole prompt on the card (the op path's window
    kernels)."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    card_model = copy.deepcopy(model).to(dev)
    out = {}
    with torch.no_grad():
        for p in prompts:
            out[tuple(p)] = tf.forward(cfg, card_model, torch.tensor([p], device=dev))[0, -1]
    del card_model
    torch.cuda.empty_cache()
    return out


def window_engine_phase(mcfg, cpu_model, seed, dev):
    """Phase 3f(b): the 168M decoder with a causal window of 1,024 served by
    the engine (int8 cache, page 256, chunk 512, 16 slots, 10 table slots a
    sequence, 161 pages): 16 requests of 1,000-6,000 prompt tokens with 64
    greedy tokens each and one of 4,000 with 1,400 (5,400 tokens, more than
    twice the table's reach); then speculation (3 drafts) on pattern
    prompts, and an int4 cache.  Each run must launch its kernels on their
    Hopper bodies, evict, stay within its page cap, complete the long
    request, and give each request's last prompt token the logits of the
    model's forward over the whole prompt within LOGIT_ATOL (int8; the int4
    run's are printed).  Returns {kernel: launches} of the int8 runs."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, rule=LocalRule(window_size=1024, is_causal=True))
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=161, max_pages_per_seq=10,
                        quantized_kv=True, prefill_chunk=512)
    pgen = torch.Generator().manual_seed(seed + 8)
    lens = [4000] + torch.randint(1000, 6001, (16,), generator=pgen).tolist()
    news = [1400] + [64] * 16
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=pgen).tolist() for n in lens]
    pattern = torch.randint(1, cfg.vocab, (64,), generator=pgen).tolist()
    pattern_prompts = [(pattern * (n // 64 + 1))[:n] for n in lens]
    want = window_forward_logits(cfg, cpu_model, prompts + pattern_prompts, dev)
    launches = {}
    for label, ecfg_run, reqs_prompts, kernels in (
            ("window engine", ecfg, prompts,
             ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")),
            ("window engine speculative", dataclasses.replace(ecfg, speculative_tokens=3),
             pattern_prompts, ("paged_multitoken_decode", "paged_prefill", "kv_chunk_write",
                               "kv_append")),
            ("window engine int4", dataclasses.replace(ecfg, kv_quant_dtype="int4"), prompts,
             ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append"))):
        eng = DecodeEngine(cfg, cpu_model, ecfg_run, device=dev)
        logits = record_prompt_logits(eng)
        results, ran = serve(label, eng, [(p, None, n) for p, n in zip(reqs_prompts, news)], None,
                             cfg.vocab)
        kv_bodies(label)
        if min(ran[k] for k in kernels) < 1:
            fail(f"{label}: a kernel of the path never launched: {ran}")
        st, cap = eng.stats, eng._pages_cap * ecfg_run.max_seqs
        if st["pages_evicted"] < 1 or st["pages_in_use_peak"] > cap:
            fail(f"{label}: pages_evicted {st['pages_evicted']}, pages_in_use_peak "
                 f"{st['pages_in_use_peak']} (cap {cap})")
        err = max(float((logits[tuple(p)] - want[tuple(p)]).abs().max()) for p in reqs_prompts)
        if label != "window engine int4" and (
                err > LOGIT_ATOL or not all(torch.isfinite(x).all() for x in logits.values())):
            fail(f"{label}: last prompt token's logits differ from the windowed forward's by "
                 f"{err} > {LOGIT_ATOL}")
        print(f"{label}: pages_in_use_peak {st['pages_in_use_peak']} of cap {cap}, "
              f"pages_evicted {st['pages_evicted']}, long request {len(results[0])} tokens; "
              f"last prompt token's logits against the windowed forward: max_abs_err {err} "
              f"(tol {LOGIT_ATOL}{', not gated: int4 cache' if 'int4' in label else ''})"
              + (f"; spec_stats {json.dumps(eng.spec_stats)}" if eng.ecfg.speculative_tokens
                 else ""), flush=True)
        if label != "window engine int4":
            for k in native.SERVING_KERNELS:
                launches[k] = launches.get(k, 0) + ran[k]
        if label == "window engine":
            census(label, eng, seed)
        del eng
        torch.cuda.empty_cache()
    print(f"phase 3f(b): {time.perf_counter() - t0:.3f} s", flush=True)
    return launches


def teacher_check(label, cfg, model, prompts, outs, dev):
    """Fail unless each request's generated tokens are the argmax of one
    teacher-forced forward over its final sequence, up to its first top-2
    logit tie (gap under GAP_TIE).  Returns (requests equal in full, the
    ties as (request, position, gap))."""
    gaps, best = top2_gaps(cfg, model, prompts, outs, dev)
    want = [p + b for p, b in zip(prompts, best)]
    check_to_tie(label, prompts, want, outs, gaps)
    ties = [(i, j, x) for i, gap in enumerate(gaps) for j, x in enumerate(gap) if x < GAP_TIE]
    return sum(a == b for a, b in zip(outs, want)), ties


def window_gate(mcfg, seed, dev):
    """Phase 3f(c): 2 layers at the 168M width in float32 with a causal
    window of 1,024, unquantized cache, 4 prompts of 2,000-5,000 tokens and
    48 new tokens each; flat (10 table slots a sequence) and cp = 4 (a mesh
    of the card repeated, 4 local table slots: the shards' tables roll),
    each with and without speculation: every run's greedy tokens must be
    the argmax of one teacher-forced forward over its final sequence, up to
    each request's first top-2 tie."""
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32,
                              rule=LocalRule(window_size=1024, is_causal=True))
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 9), device="cpu")
    pgen = torch.Generator().manual_seed(seed + 10)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=pgen).tolist()
               for n in torch.randint(2000, 5001, (4,), generator=pgen).tolist()]
    flat = EngineConfig(max_seqs=4, page_size=256, n_pages=4 * 10 + 1, max_pages_per_seq=10,
                        quantized_kv=False, prefill_chunk=512)
    cp = dataclasses.replace(flat, n_pages=4 * 6 + 1, max_pages_per_seq=4)
    mesh = make_mesh((N_SHARDS,), ("seq",), [dev] * N_SHARDS)
    for name, ecfg, kw in (("flat", flat, dict(device=dev)), ("cp = 4", cp, dict(mesh=mesh))):
        for spec in (0, 3):
            eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec), **kw)
            rids = [eng.submit(p, max_new_tokens=48) for p in prompts]
            res = eng.run(max_steps=10_000)
            outs = [res[r] for r in rids]
            label = f"window gate ({name}, speculative_tokens={spec})"
            if [len(o) for o in outs] != [len(p) + 48 for p in prompts]:
                fail(f"{label}: requests returned {[len(o) for o in outs]} tokens")
            full, ties = teacher_check(label, cfg, model, prompts, outs, dev)
            print(f"{label}: {full} of {len(prompts)} requests equal the teacher-forced argmax in "
                  f"full; ties (request, position, gap) {ties}; pages_evicted "
                  f"{eng.stats['pages_evicted']}, pages_in_use_peak "
                  f"{eng.stats['pages_in_use_peak']}"
                  + (f"; spec_stats {json.dumps(eng.spec_stats)}" if spec else ""), flush=True)
            del eng
            torch.cuda.empty_cache()
    print(f"phase 3f(c): {time.perf_counter() - t0:.3f} s; prompt lengths "
          f"{[len(p) for p in prompts]}", flush=True)


#: the op path's forward kernels (the bucketed prefill runs one of them)
FORWARD_KERNELS = ("flash_fwd", "banded_fwd", "window_fwd", "resident_fwd")


def bucketed_phase(mcfg, cpu_model, ecfg, prompts, n_new, chunked_logits, chunked_rate, dev):
    """Phase 3g: the engine with prefill_mode="bucketed" (buckets 512 and
    2,048) on phase 3's requests: the forward kernel the route picks must
    launch once per layer and prompt (a bucket's graph counts its eager
    first call and its capture in the wrappers' launches, each replay in
    native.REPLAYED), and no other op kernel; each
    request's last prompt token's logits within LOGIT_ATOL of phase 3's
    chunked engine's.  Prints the prefill rate beside phase 3's."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    eng = DecodeEngine(mcfg, cpu_model, dataclasses.replace(
        ecfg, prefill_mode="bucketed", prefill_buckets=(512, 2048)), device=dev)
    logits = record_prompt_logits(eng)
    _, ran = serve("bucketed engine", eng, [(p, None) for p in prompts], n_new, mcfg.vocab)
    ran = {k: n + eng.replayed.get(k, 0) for k, n in ran.items()}
    fwd = {k: ran[k] for k in FORWARD_KERNELS if ran[k]}
    others = {k: ran[k] for k in native.ATTENTION_KERNELS if ran[k] and k not in FORWARD_KERNELS}
    captures = len(getattr(eng._bucket_prefill, "graphs", {}))
    want = mcfg.n_layers * (len(prompts) + captures)
    if len(fwd) != 1 or sum(fwd.values()) != want or others:
        fail(f"bucketed engine: forward launches {fwd} (replays included), other op kernels "
             f"{others}; expected one forward kernel {want} times ({captures} captures)")
    err = logits_err("bucketed engine", logits, chunked_logits, LOGIT_ATOL)
    print(f"bucketed engine: forward launches {json.dumps(fwd)} ({mcfg.n_layers} layers x "
          f"{len(prompts)} prompts and {captures} bucket captures); last prompt token's "
          f"logits against the chunked engine's "
          f"(phase 3): max_abs_err {err} (tol {LOGIT_ATOL}); prefill {eng.rates[0]:.1f} tokens/s "
          f"against the chunked engine's {chunked_rate:.1f} (phase 3, {eng.rates[0] / chunked_rate:.3f}x)",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return fwd


# ---- phase 3h: tensor-parallel serving (a model axis on the one card) ----

# the model axis of the 168M engine on the card: 8 KV heads over 4 shards
TP = 4


def fast_bodies(label, launches):
    """Fail unless the last launch of each serving kernel in ``launches``
    ran its fast body: the tensor cores for the attention kernels, the
    vector row body for the KV writes (every launch of a run has the shapes
    of its last)."""
    from tf_flash_attention_tpu_torch import native
    for k in native.SERVING_KERNELS:
        want = "vector" if k.startswith("kv_") else "tensor-core"
        if launches.get(k) and native.WALKS[k]["body"] != want:
            fail(f"{label}: {k} ran the {native.WALKS[k]['body']} body, not the {want} one")


def tp_kernel_phase(cases, dev, gen):
    """Phase 3h(a): phase 2's kernel_case at a head shard's heads (2 q / 2
    KV and 4 / 4, int8 and int4, the four kernels and gamma 4), every
    attention launch on the tensor-core body; each kernel's kernel_ms and
    CTAs printed beside phase 2's at 8 / 8; then sharded_paged_decode at
    tp = 4 against the flat paged_decode (``sharded_decode_check``).
    Returns {"payload_heads": {kernel: measurements}}."""
    t0 = time.perf_counter()
    out = {}
    for payload in ("int8", "int4"):
        for h in (2, 4):
            label = f"tp_{payload}_{h}q{h}kv"
            r = kernel_case(label, h, h, payload, dev, gen)
            r.update(kernel_case(label + "_gamma4", h, h, payload, dev, gen, gamma=4))
            for k in ("paged_decode", "paged_multitoken_decode", "paged_prefill"):
                if r[k]["body"] != "tensor-core":
                    fail(f"{label}: {k} ran the {r[k]['body']} body")
            for k, m in r.items():
                ref = cases[payload][k]
                print(f"tp kernels {label} {k}: kernel_ms {json.dumps(m['kernel_ms'])} ctas "
                      f"{m.get('ctas')} ms {m['ms']} (phase 2 at 8 q / 8 kv: kernel_ms "
                      f"{json.dumps(ref['kernel_ms'])} ctas {ref.get('ctas')} ms {ref['ms']})",
                      flush=True)
            out[f"{payload}_{h}kv"] = {k: {x: m.get(x) for x in ("kernel_ms", "ctas", "splits",
                                                                 "ms", "err", "body")}
                                       for k, m in r.items()}
    sharded_decode_check(dev, gen)
    print(f"phase 3h(a): {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def sharded_decode_check(dev, gen):
    """sharded_paged_decode at tp = 4 (the card four times) against the flat
    paged_decode at 8 KV heads on the same pages (int8, 16 slots, page 256,
    bf16): at phase 2's table (16 slots a sequence) and at 4 table slots.
    Heads are independent, so where the two launches cut a slot's pages
    into the same runs (``native.decode_plan``'s splits) the outputs must be
    bit-equal; where the shards' smaller grids cut more runs, the runs'
    merge sums in another order and the outputs may part by rounding:
    within attn_tol.  Both launches on the tensor-core body."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving import decode
    from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                     sharded_paged_decode)
    mesh = make_mesh((TP,), ("model",), [dev] * TP)
    S = 16
    checked = False
    # a slot's pages are cut into at most a run a page: with 2 table slots
    # both grids cut every slot into 2 runs, and the outputs are bit-equal
    for table, mapped, slots in (("phase 2's table", 8, 16), ("2 table slots", 2, 2)):
        cfg = payload_cfg("int8", n_kv_heads=8, head_dim=128, page_size=256,
                          n_pages=S * mapped + S + 1, max_seqs=S, max_pages_per_seq=slots)
        lengths = torch.randint(1, 256 * mapped, (S,), generator=gen, device=dev).tolist()
        lengths[3] = 0
        cache = make_cache(cfg, dev, gen, lengths, mapped)
        q = torch.randn((S, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
        native.reset_launch_counts()
        flat = decode.paged_decode_attention(q, cache, cfg)
        flat_ran = decode_ran("paged_decode", cfg, "tp decode (flat)")
        shards = shard_cache_heads(cache, cfg, mesh)
        # the eager call (on one card the callable is a graph: phase 13(b))
        got = sharded_paged_decode(mesh, cfg).eager(q, shards)
        torch.cuda.synchronize()
        shard_ran = decode_ran("paged_decode", cfg, "tp decode (shard)")
        launches = native.LAUNCHES["paged_decode"]
        if launches != 1 + TP:
            fail(f"tp decode: {launches} paged_decode launches, expected {1 + TP}")
        if "tensor-core" != flat_ran["body"] or "tensor-core" != shard_ran["body"]:
            fail(f"tp decode: bodies {flat_ran['body']} (flat), {shard_ran['body']} (shard)")
        equal = torch.equal(got, flat)
        err = float((got.float() - flat.float()).abs().max())
        if flat_ran["splits"] == shard_ran["splits"]:
            checked = True
            if not equal:
                fail(f"tp decode ({table}): the shards cut the same runs as the flat launch "
                     f"({flat_ran['splits']}) but differ from it by {err}")
        if not torch.isfinite(got).all() or err > attn_tol(flat):
            fail(f"tp decode ({table}): the shards differ from the flat decode by {err} > "
                 f"{attn_tol(flat)}")
        print(f"tp decode ({table}: {cfg.max_pages_per_seq} pages a sequence): "
              f"sharded_paged_decode at tp = {TP} {'bit-equal to' if equal else 'within attn_tol of'}"
              f" the flat paged_decode (max_abs_err {err}, tol {attn_tol(flat)}); flat splits "
              f"{flat_ran['splits']} ctas {flat_ran['ctas']}, a shard's splits "
              f"{shard_ran['splits']} ctas {shard_ran['ctas']}; both tensor-core", flush=True)
    if not checked:
        fail("tp decode: no case cut the same runs flat and sharded (no bit-equal check ran)")


def tp_engine_phase(mcfg, cpu_model, ecfg, prompts, pattern, n_new, greedy_3, chunked_logits,
                    seed, dev):
    """Phase 3h(b): the 168M engine with a model axis of TP (the card four
    times: 2 KV heads a shard), int8, phase 3's 18 requests and greedy
    tokens; every serving launch on its fast body; each request's last
    prompt token's logits within LOGIT_ATOL of phase 3's flat engine; then
    speculation (3 drafts) on two pattern prompts and six of phase 3's.
    Prints the requests equal to phase 3's, the rates and a decode step's
    census.  Returns {kernel: launches in both runs}."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    t0 = time.perf_counter()
    mesh = make_mesh((TP,), ("model",), [dev] * TP)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    eng = DecodeEngine(mcfg, cpu_model, ecfg, mesh=mesh)
    # the engine holds its shards' slices (one set of layers), the replicated
    # embedding and norms and its caches, and no full copy of the layers
    held = torch.cuda.memory_allocated(dev) - base
    unique = lambda ts: sum({t.data_ptr(): t.numel() * t.element_size() for t in ts}.values())
    layer_bytes = unique(p for s in eng._params for p in s.layers.parameters())
    rest = unique(list(eng.model.parameters()) + [
        t for c in (c for layers in eng.shards for c in layers)
        for t in vars(c).values() if torch.is_tensor(t)])
    print(f"tp engine: {held} bytes on the card after construction: the shards' layers "
          f"{layer_bytes}, embedding, norms and caches {rest}", flush=True)
    # a full copy beside the shards would add layer_bytes again; half of it
    # leaves room for the allocator's rounding and small buffers
    if len(eng.model.layers) or held >= rest + 1.5 * layer_bytes:
        fail(f"the tp engine holds {held} bytes, 1.5x its shards' layers {layer_bytes} or "
             f"more beside the rest {rest}: a full copy of the layers stayed")
    logits = record_prompt_logits(eng)
    results, launches = serve("tp engine", eng, [(p, None) for p in prompts], n_new, mcfg.vocab)
    logits = dict(logits)                   # the census prompts stay out
    fast_bodies("tp engine", launches)
    err = logits_err("tp engine", logits, chunked_logits, LOGIT_ATOL)
    same = sum(results[r] == greedy_3[r] for r in range(len(prompts)))
    print(f"tp engine (tp = {TP}, {eng.ccfg.n_kv_heads // TP} KV heads a shard): requests equal "
          f"to phase 3's: {same} of {len(prompts)}; prefix hits {eng.prefix_cache.hits}; last "
          f"prompt token's logits against phase 3's: max_abs_err {err} (tol {LOGIT_ATOL})",
          flush=True)
    census("tp engine", eng, seed)
    del eng
    torch.cuda.empty_cache()

    eng = DecodeEngine(mcfg, cpu_model, dataclasses.replace(ecfg, speculative_tokens=3),
                       mesh=mesh)
    reqs = [(pattern * 8, None), (pattern * 12, None)] + [(p, None) for p in prompts[:6]]
    _, spec_launches = serve("tp engine speculative", eng, reqs, n_new, mcfg.vocab)
    fast_bodies("tp engine speculative", spec_launches)
    print(f"tp engine speculative: spec_stats {json.dumps(eng.spec_stats)}; "
          f"{eng.stats['decode_tokens'] / eng.stats['steps']:.3f} tokens per step", flush=True)
    census("tp engine speculative", eng, seed)
    del eng
    torch.cuda.empty_cache()
    total = {k: launches[k] + spec_launches[k] for k in native.SERVING_KERNELS}
    if min(total.values()) < 1:
        fail(f"the tp engine did not launch every serving kernel: {total}")
    print(f"phase 3h(b): {time.perf_counter() - t0:.3f} s", flush=True)
    return total


def tp_gate(mcfg, seed, dev):
    """Phase 3h(c): 2 layers at the 168M width in float32, unquantized
    cache, 4 prompts of 1,000-4,000 tokens and 48 new tokens each; tp = 2,
    then model 2 x seq 2, each with and without speculation: the greedy
    tokens must be the argmax of one teacher-forced forward over each final
    sequence up to each request's first top-2 tie.  Float32 activations run
    the serving kernels' scalar bodies (``native.decode_body``), which the
    run prints."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 11), device="cpu")
    pgen = torch.Generator().manual_seed(seed + 12)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=pgen).tolist()
               for n in torch.randint(1000, 4001, (4,), generator=pgen).tolist()]
    flat = EngineConfig(max_seqs=4, page_size=256, n_pages=4 * 17 + 1, max_pages_per_seq=17,
                        quantized_kv=False, prefill_chunk=512)
    sharded = dataclasses.replace(flat, n_pages=4 * 9 + 1, max_pages_per_seq=9)
    runs = (("tp = 2", flat, make_mesh((2,), ("model",), [dev] * 2)),
            ("model 2 x seq 2", sharded, make_mesh((2, 2), ("model", "seq"), [dev] * 4)))
    for name, ecfg, mesh in runs:
        for spec in (0, 3):
            eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec),
                               mesh=mesh)
            rids = [eng.submit(p, max_new_tokens=48) for p in prompts]
            native.reset_launch_counts()
            res = eng.run(max_steps=10_000)
            outs = [res[r] for r in rids]
            label = f"tp gate ({name}, speculative_tokens={spec})"
            if [len(o) for o in outs] != [len(p) + 48 for p in prompts]:
                fail(f"{label}: requests returned {[len(o) for o in outs]} tokens")
            full, ties = teacher_check(label, cfg, model, prompts, outs, dev)
            bodies = {k: native.WALKS[k]["body"] for k, n in native.LAUNCHES.items()
                      if n and k in native.WALKS}
            print(f"{label}: {full} of {len(prompts)} requests equal the teacher-forced argmax "
                  f"in full; ties (request, position, gap) {ties}; bodies {json.dumps(bodies)}"
                  + (f"; spec_stats {json.dumps(eng.spec_stats)}" if spec else ""), flush=True)
            del eng
            torch.cuda.empty_cache()
    print(f"phase 3h(c): {time.perf_counter() - t0:.3f} s; prompt lengths "
          f"{[len(p) for p in prompts]}", flush=True)


# ---- phase 3i: MoE serving ----

MOE_EXPERTS = 4
# MoE float32 gate (phase 3i(a)): the card's and the CPU's float32
# activations part by summation order (cuBLAS against the CPU's products,
# the serving kernels' float32 scalar bodies against their plain versions:
# ~1e-6 of an activation through 2 layers), so router logits (d_model 1,024
# against weights of scale 1/32) and the probabilities near 1/4 part by
# ~1e-6 too.  Two top probabilities closer than ROUTER_TIE (ten times that)
# may swap which expert a row takes, and with the expert the row's queue
# place ahead of every later row of its call (capacity couples them): such
# a call is a tie, like a top-2 logit gap under GAP_TIE.  A lost or
# misplaced row moves the tokens far from any tie
ROUTER_TIE = 1e-5


@contextlib.contextmanager
def moe_trace(eng, check_idle=False):
    """Trace ``eng``'s MoE run: each request's first tie (``trace["tie"]``,
    {rid: generated tokens before the first model call that had a router
    top-2 gap under ROUTER_TIE among its real rows, or a top-2 logit gap
    under GAP_TIE for the request's own row}) and, with ``check_idle``,
    fail unless every idle slot's decode attention output is exactly 0
    (``trace["idle_rows"]`` counts them).  Requests are admitted in
    submission order (the scheduler is FIFO).  The trace reads the router's
    gaps and the idle rows inside each step, on the host: the engine runs
    its step impls eagerly meanwhile (a graph would run them at capture
    only); phase 11 holds the graphed MoE engine to the eager one."""
    from tf_flash_attention_tpu_torch.serving import engine as engine_mod

    trace = {"tie": {}, "idle_rows": 0}
    call, plen = {}, {}
    moe_ffn, decode_merged = engine_mod.moe_ffn, engine_mod.decode_merged
    inner = {k: getattr(eng, k) for k in ("_prefill", "_chunk_prefill", "_decode_step",
                                          "_spec_step", "_logits")}
    eager = {k: getattr(eng, k + "_impl") for k in ("_chunk_prefill", "_decode_step",
                                                     "_spec_step")}

    def gap2(x):
        top = x.float().topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]

    def traced_moe(cfg, params, x):
        probs = torch.softmax(x.float() @ params.router.float(), dim=-1)[0, :call.get("rows")]
        call["router"] = min(call.get("router", math.inf), float(gap2(probs).min()))
        return moe_ffn(cfg, params, x)

    def traced_decode(q, caches, ccfg, glob, **kw):
        o = decode_merged(q, caches, ccfg, glob, **kw)
        idle = [i for i, st in enumerate(eng._slots) if st is None]
        if check_idle and idle:
            rows = o[idle]
            if not bool((rows == 0).all()):
                fail(f"3i: an idle slot's decode output is not 0 (max |o| "
                     f"{float(rows.float().abs().max())})")
            trace["idle_rows"] += len(idle)
        return o

    def logits(x):
        call["logits"] = inner["_logits"](x)
        return call["logits"]

    def tie(rid, generated, logit_gap):
        if call.get("router", math.inf) < ROUTER_TIE or logit_gap < GAP_TIE:
            trace["tie"][rid] = min(trace["tie"].get(rid, generated), generated)

    def prefill(prompt, slot):
        rid = len(plen)
        plen[rid] = len(prompt)
        call.clear()
        out = inner["_prefill"](prompt, slot)
        tie(rid, 0, float(gap2(call["logits"])))
        return out

    def chunk(tokens, meta):
        call["rows"] = int(meta[2])
        return eager["_chunk_prefill"](tokens, meta)

    def step(name):
        def run(tokens, active):
            # each live slot's request and its tokens generated before the call
            live = {s: (st["rid"], len(eng._results[st["rid"]]) - plen[st["rid"]])
                    for s, st in enumerate(eng._slots) if st is not None}
            call.clear()
            out = eager[name](tokens, active)
            gaps = gap2(call["logits"])
            for s, (rid, generated) in live.items():
                tie(rid, generated, float(gaps[s].min()))
            return out
        return run

    eng._prefill, eng._chunk_prefill, eng._logits = prefill, chunk, logits
    eng._decode_step, eng._spec_step = step("_decode_step"), step("_spec_step")
    engine_mod.moe_ffn, engine_mod.decode_merged = traced_moe, traced_decode
    try:
        yield trace
    finally:
        engine_mod.moe_ffn, engine_mod.decode_merged = moe_ffn, decode_merged
        for k, f in inner.items():
            setattr(eng, k, f)


def moe_gate(mcfg, seed, dev):
    """Phase 3i(a): 2 layers at the 168M width with MOE_EXPERTS experts in
    float32 (TF32 off), unquantized and int8 caches, 4 slots: 3 requests of
    different lengths (request 0 retires early from slot 0, whose idle row
    then routes ahead of the others'; slot 3 is idle throughout), without
    and with speculation (3 drafts).  The card's greedy tokens must equal
    the port's CPU engine's (plain versions) on the same weights up to each
    request's first tie (``moe_trace``: the CPU run's ties; a speculative
    step routes S x gamma rows as one pool, so each speculative engine is
    held against its CPU twin), and every idle slot's decode output on the
    card must be exactly 0."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32, n_experts=MOE_EXPERTS)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 22), device="cpu")
    gen = torch.Generator().manual_seed(seed + 23)
    reqs = [(torch.randint(1, cfg.vocab, (n,), generator=gen).tolist(), m)
            for n, m in ((128, 4), (300, 12), (520, 12))]
    for quantized in (False, True):
        for spec in (0, 3):
            ecfg = EngineConfig(max_seqs=4, page_size=256, n_pages=4 * 8 + 1, max_pages_per_seq=8,
                                quantized_kv=quantized, prefill_chunk=512,
                                speculative_tokens=spec)
            label = (f"3i(a) {'int8' if quantized else 'unquantized'}"
                     f"{' speculative' if spec else ''}")
            runs = {}
            for card, where in ((False, "cpu"), (True, dev)):
                eng = DecodeEngine(cfg, model, ecfg, device=where)
                with moe_trace(eng, check_idle=card) as trace:
                    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
                    res = eng.run(max_steps=1000)
                runs[card] = ([res[r] for r in rids], trace, dict(eng.stats),
                                      dict(eng.spec_stats), eng.ccfg)
                del eng
            (want, ref, _, spec_cpu, ccfg), (got, card, stats, spec_card, _) = runs[False], runs[True]
            for i, ((p, m), w, g) in enumerate(zip(reqs, want, got)):
                tie = ref["tie"].get(i, m)
                if g[len(p):][:tie] != w[len(p):][:tie]:
                    fail(f"{label}: request {i} differs from the CPU engine before its first "
                         f"tie (position {tie}): {g[len(p):]} vs {w[len(p):]}")
            if card["idle_rows"] < 1:
                fail(f"{label}: no idle slot row was checked")
            same = sum(a == b for a, b in zip(want, got))
            print(f"{label}: {same} of {len(reqs)} requests equal to the CPU engine's in full; "
                  f"first ties (request: position) {json.dumps(ref['tie'])}; idle slot rows "
                  f"exactly 0 on the card: {card['idle_rows']}; stats {json.dumps(stats)}"
                  + (f"; spec_stats card {json.dumps(spec_card)}, CPU {json.dumps(spec_cpu)}"
                     if spec else "")
                  + f"; bodies decode {native.decode_body(torch.float32, ccfg)}, prefill "
                  f"{native.prefill_body(torch.float32, ccfg)}", flush=True)
    print(f"phase 3i(a): {time.perf_counter() - t0:.3f} s", flush=True)


def moe_engine_phase(mcfg, ecfg, prompts, n_new, dense_rates, seed, dev):
    """Phase 3i(b): the bf16 168M decoder with MOE_EXPERTS experts (random
    weights from the seed) on phase 3's engine configuration and 18
    requests, then with 3 drafts: every request completes, the serving
    kernels launch on the bodies native.*_body names, and the rates print
    beside phase 3's and 3b's dense ones.  Returns {kernel: launches} of
    both runs."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_experts=MOE_EXPERTS)
    model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 24), device=dev)
    print(f"3i(b) model: {sum(p.numel() for p in model.parameters())} params "
          f"({MOE_EXPERTS} experts of d_ff {cfg.d_ff} a layer, float32)", flush=True)
    total = {}
    for label, spec, dense in (("moe engine", 0, "engine"),
                               ("moe engine speculative", 3, "speculative")):
        eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec),
                           device=dev)
        _, launches = serve(label, eng, [(p, None) for p in prompts], n_new, cfg.vocab)
        kv_bodies(label)
        kernels = ("paged_multitoken_decode" if spec else "paged_decode", "paged_prefill",
                   "kv_chunk_write", "kv_append")
        if min(launches[k] for k in kernels) < 1:
            fail(f"{label}: a kernel of the path never launched: {launches}")
        _add_launches(total, {k: v for k, v in launches.items() if v})
        (pre, dec), (pre0, dec0) = eng.rates, dense_rates[dense]
        print(f"{label}: prefill {pre:.1f} tokens/s = {pre / pre0:.3f}x the dense {dense}'s "
              f"{pre0:.1f}; decode {dec:.1f} tokens/s = {dec / dec0:.3f}x its {dec0:.1f}"
              + (f"; spec_stats {json.dumps(eng.spec_stats)}" if spec else ""), flush=True)
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    print(f"phase 3i(b): {time.perf_counter() - t0:.3f} s; launches {json.dumps(total)}",
          flush=True)
    return total


# ---- phase 5q: float64 (the chunked path) and the reference harness ----

# float64 against its dense oracle: the reference's float64 class, 1e-9 of
# the reduction length, with the JAX chunked tests' factor of 10
def f64_tol(n):
    return 1e-9 * n * 10


# the second float64 limit, from the readings (at most 2.7e-14 at K = 4096 on
# the H100): f64_tol would pass a float32 computation (about 1e-7 off), so a
# control runs the same inputs in float32 and must fail this one
F64_READ_TOL = 1e-11


def float64_phase(dev, seed):
    """Phase 5q: causal_1d and local_1d in float64 at (2, 4, 64, 4096),
    forward and gradients against the float64 dense oracle
    (implementation="xla") within f64_tol and F64_READ_TOL, with a float32
    control on the same inputs that must fail F64_READ_TOL; the JAX package's 16k case
    (S 16,384, D 8, a causal window of 64) with the peak memory above its
    inputs under 1/8 of the 2 GiB score tensor a dense path would hold, and
    row 12,345 against a float64 oracle on the host; then the reference
    harness's CLI in subprocesses: verify one 1d and one 2d case, benchmark
    one.  Prints the float64 calls' ms."""
    import numpy as np
    import tf_flash_attention_tpu_torch.api as ta
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.ops.chunked import flash_attention_xla
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    f64 = torch.float64
    rand = lambda shape, lo=-2.0: torch.rand(shape, dtype=f64, generator=gen,
                                              device=dev) * (-2 * lo) + lo
    calls = {"causal_1d": lambda *x, **kw: ta.causal_1d(*x, sync_mode="none_front", **kw),
             "local_1d": lambda *x, **kw: ta.local_1d(*x, window_size=256, log2_stride_size=0,
                                                      is_causal=True, sync_mode="none_front",
                                                      **kw)}
    shape = (2, 4, 64, 4096)
    for name, fn in calls.items():
        Q, K, V, dO = (rand(shape) for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (Q, K, V)]
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, dO)
        o_ref = fn(*leaves, implementation="xla")
        refs = torch.autograd.grad(o_ref, leaves, dO)
        tol = min(f64_tol(shape[-1]), F64_READ_TOL)
        errs = {n: float((a - b).detach().abs().max()) for n, a, b in zip(
            ("O", "dQ", "dK", "dV"), (o,) + grads, (o_ref,) + refs)}
        if o.dtype != f64 or any(not (e <= tol) for e in errs.values()):
            fail(f"5q {name} float64: errors {errs} (tol {tol}), dtype {o.dtype}")
        # the control: the same inputs through the chunked path in float32
        # must fail F64_READ_TOL
        leaves32 = [x.detach().float().requires_grad_(True) for x in (Q, K, V)]
        o32 = fn(*leaves32, implementation="xla_flash")
        ctrl = {n: float((a.double() - b).detach().abs().max()) for n, a, b in zip(
            ("O", "dQ", "dK", "dV"), (o32,) + torch.autograd.grad(o32, leaves32, dO.float()),
            (o_ref,) + refs)}
        if o32.dtype != torch.float32 or any(not (e > F64_READ_TOL) for e in ctrl.values()):
            fail(f"5q {name}: the float32 control {ctrl} passed the float64 limit "
                 f"{F64_READ_TOL}")
        del o, grads, o_ref, refs, o32, leaves32
        with torch.no_grad():
            ms = time_ms(lambda: fn(Q, K, V), n=5)
            oracle_ms = time_ms(lambda: fn(Q, K, V, implementation="xla"), n=5)
        fb_ms = time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, dO), n=5)
        print(f"5q {name} float64 {shape}: max_abs_err {json.dumps(errs)} (tol "
              f"{f64_tol(shape[-1])} and {F64_READ_TOL}); the float32 control's "
              f"{json.dumps(ctrl)} (must exceed {F64_READ_TOL}); "
              f"forward {ms} ms, forward + backward {fb_ms} ms, the dense oracle's forward "
              f"{oracle_ms} ms", flush=True)
        torch.cuda.empty_cache()

    S, D = 16384, 8
    q, k, v = (rand((1, S, D), lo=-1.0) for _ in range(3))
    pack = make_sync_pack("none_front", (S,), (S,))
    rule = LocalRule(window_size=64, log2_stride_size=0, is_causal=True)
    run = lambda: flash_attention_xla(q, k, v, pack=pack, rule=rule, block_q=512,
                                      block_kv=512)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with torch.no_grad():
        o, l, m = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    gate = S * S * 8 // 8
    if o.shape != (1, S, D) or not torch.isfinite(o).all() or not bool((l > 0).all()):
        fail("5q 16k float64: bad output")
    if peak >= gate:
        fail(f"5q 16k float64: peak {peak} bytes above the inputs >= {gate}")
    row = 12345
    qn, kn, vn = (x[0].cpu().numpy() for x in (q, k, v))
    s = kn[row - 63:row + 1] @ qn[row] / np.sqrt(D)
    p = np.exp(s - s.max())
    o_row = p @ vn[row - 63:row + 1] / p.sum()
    err = float(np.abs(o[0, row].cpu().numpy() - o_row).max())
    if not err <= min(1e-9 * S, F64_READ_TOL):
        fail(f"5q 16k float64: row {row} differs from the host oracle by {err}")
    with torch.no_grad():
        o32 = flash_attention_xla(q.float(), k.float(), v.float(), pack=pack, rule=rule,
                                  block_q=512, block_kv=512)[0]
    ctrl = float(np.abs(o32[0, row].double().cpu().numpy() - o_row).max())
    if not ctrl > F64_READ_TOL:
        fail(f"5q 16k: the float32 control's row {row} ({ctrl}) passed the float64 limit")
    del o32
    with torch.no_grad():
        ms = time_ms(lambda: run(), n=5)
    print(f"5q 16k float64 (S {S}, D {D}, LocalRule(64, 0, True), blocks 512): peak "
          f"{peak} bytes above the inputs (gate {gate}, 1/8 of the dense score tensor); row "
          f"{row} against the host oracle: max_abs_err {err} (tol {1e-9 * S} and "
          f"{F64_READ_TOL}; the float32 control's {ctrl}); {ms} ms", flush=True)
    del q, k, v, o, l, m
    torch.cuda.empty_cache()

    # the reference harness, each command in a process of its own, all at once
    here = os.path.dirname(os.path.abspath(__file__))
    cmds = [(("verify",), "CausalAttentionSyncModeScaleFront"),
            (("verify", "2d"), "LocalStrideAndCausalAttentionSyncModeScaleEnd"),
            (("benchmark",), "LocalAndCausalAttentionSyncModeNoneFront")]
    procs = []
    for args, case in cmds:
        env = dict(os.environ, TESTCASE=case, FA_RUNS="1", FA_SEED=str(seed))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tf_flash_attention_tpu_torch.testing", *args],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for (args, case), proc in zip(cmds, procs):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"5q testing {' '.join(args)} ({case}) timed out")
        for line in out.strip().splitlines():
            print(f"5q testing {' '.join(args)}: {line}", flush=True)
        if proc.returncode != 0 or (args[0] == "verify" and out.strip().splitlines()[-1:] != ["OK"]):
            fail(f"5q testing {' '.join(args)} ({case}) exited {proc.returncode}: {err[-2000:]}")
    print(f"phase 5q: {time.perf_counter() - t0:.3f} s", flush=True)


def quant_phase(mcfg, cpu_model, dev, seed):
    """Phase 9: weight-only int8 projections.  int8_matmul on seeded bf16
    inputs of 256 rows at each 168M projection shape: weight codes and
    scales, row codes and scales, int32 accumulators and outputs bit-equal
    between the card and the CPU.  Then forward with quantize_model_weights
    at 1 x 2,048 tokens: every projection one torch._int_mm on the card,
    and the card's logits within INT8_NOISE_FACTOR times the CPU forward's
    own response to a 2**-9 nudge of its norm scales (at least LOGIT_ATOL)
    of the CPU's plain path; prints the error and top-1 agreement against
    the dense weights' forward on the card, and both forwards' ms."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.ops import quant

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 11)
    for name, (d_in, d_out) in mcfg.proj_shapes().items():
        x = torch.randn((256, d_in), generator=gen).to(torch.bfloat16)
        w = torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)
        qw, qw_card = quant.quantize_weight_int8(w), quant.quantize_weight_int8(w.to(dev))
        cpu = quant.int8_matmul(x, qw, return_parts=True)
        card = quant.int8_matmul(x.to(dev), qw_card, return_parts=True)
        pairs = {"weight codes": (qw.values, qw_card.values),
                 "weight scales": (qw.scales, qw_card.scales),
                 "row codes": (cpu[1].values, card[1].values),
                 "row scales": (cpu[1].scales, card[1].scales),
                 "accumulators": (cpu[2], card[2]), "outputs": (cpu[0], card[0])}
        bad = [k for k, (a, b) in pairs.items() if not torch.equal(a, b.cpu())]
        if bad:
            fail(f"phase 9: int8_matmul at {name} ({d_in} x {d_out}): the card's {bad} differ "
                 f"from the CPU's")
    print(f"phase 9: int8_matmul bit-equal between the card and the CPU at "
          f"{json.dumps(mcfg.proj_shapes())} (256 rows, bf16)", flush=True)
    tokens = torch.randint(1, mcfg.vocab, (1, 2048), generator=gen)
    card_model = copy.deepcopy(cpu_model).to(dev)
    q_card = tf.quantize_model_weights(card_model)
    q_cpu = tf.quantize_model_weights(cpu_model)
    products = []
    inner = quant._int8_product

    def counted(a, b):
        products.append(a.device.type)
        return inner(a, b)

    quant._int8_product = counted
    with torch.no_grad():
        want = tf.forward(mcfg, q_cpu, tokens)
        # the int8 forward's own rounding sensitivity: the same forward with
        # every ln1 scale nudged by 2**-9 (below a bf16 ulp), on the CPU
        nudged = copy.deepcopy(q_cpu)
        for block in nudged.layers:
            block.ln1.mul_(1 + 2.0 ** -9)
        noise = float((tf.forward(mcfg, nudged, tokens) - want).abs().max())
        tol = max(LOGIT_ATOL, INT8_NOISE_FACTOR * noise)
        products.clear()
        tok = tokens.to(dev)
        got = tf.forward(mcfg, q_card, tok)
        ran = list(products)
        dense = tf.forward(mcfg, card_model, tok)
        err = float((got.cpu() - want).abs().max())
        last_err = float((got[0, -1].cpu() - want[0, -1]).abs().max())
        if ran != ["cuda"] * (7 * mcfg.n_layers):
            fail(f"phase 9: the int8 forward on the card ran {ran.count('cuda')} int8 products "
                 f"on the card, {len(ran)} in all; expected {7 * mcfg.n_layers}")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"phase 9: the int8 forward's logits on the card differ from the CPU's by {err} "
                 f"> {tol} (the CPU forward's response to a nudge: {noise})")
        dense_err = float((got - dense).abs().max())
        top1 = float((got.argmax(-1) == dense.argmax(-1)).float().mean())
        card_cpu_top1 = float((got.argmax(-1).cpu() == want.argmax(-1)).float().mean())
        q_ms = time_ms(lambda: tf.forward(mcfg, q_card, tok), n=5)
        d_ms = time_ms(lambda: tf.forward(mcfg, card_model, tok), n=5)
    quant._int8_product = inner
    print(f"phase 9: int8 forward at 1 x 2048 ({7 * mcfg.n_layers} torch._int_mm products on "
          f"the card): card vs CPU logits max_abs_err {err}, last token {last_err}, top-1 "
          f"agreement {card_cpu_top1} (tol {tol}: {INT8_NOISE_FACTOR} x the CPU forward's "
          f"response {noise} to a 2**-9 nudge of its norm scales, at least {LOGIT_ATOL}); against "
          f"the dense-weight forward on the card: max_abs_err {dense_err}, top-1 agreement "
          f"{top1}; forward {q_ms:.4f} ms int8, {d_ms:.4f} ms dense; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    del card_model, q_card
    torch.cuda.empty_cache()
    return dict(err=err, noise=noise, dense_err=dense_err, top1=top1, int8_ms=q_ms,
                dense_ms=d_ms)


@contextlib.contextmanager
def plain_attention(fused="kv"):
    """The attention core on its plain versions, on any device: the plain
    path the kernels are held against (``fused=False``: the split pair's),
    in ``ops/attend.py`` and in the ring (``parallel/ring.py``)."""
    from tf_flash_attention_tpu_torch.ops import attend, backward, forward
    from tf_flash_attention_tpu_torch.parallel import ring

    def fwd(q, k, v, *, pack, rule, config, scale):
        return forward._flash_forward_plain(forward.prescale(q, scale), k, v, pack, rule)

    def bwd(q, k, v, o, l, m, do, *, pack, rule, config, scale):
        lse2, delta = backward.backward_stats(o, l, m, do)
        return backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, scale,
                                              fused)

    saved = {mod: (mod.flash_forward, mod.flash_backward) for mod in (attend, ring)}
    for mod in saved:
        mod.flash_forward, mod.flash_backward = fwd, bwd
    try:
        yield
    finally:
        for mod, (f, b) in saved.items():
            mod.flash_forward, mod.flash_backward = f, b


# the JAX package's route switches, read by the port as by the package
TABLE_ONLY = {v: "0" for v in ("FA_BANDED", "FA_WINDOW", "FA_BANDED_BWD", "FA_WINDOW_BWD")}
SPLIT = {"FA_FUSED_BWD": "0"}
RESIDENT = {"FA_RESIDENT": "1"}


@contextlib.contextmanager
def switches(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def compare(label, names, got, want, dtypes):
    """Max abs error of each output; fails past op_tol.  Returns the max."""
    worst = 0.0
    for name, a, b, dt in zip(names, got, want, dtypes):
        err = float((a.float() - b.float()).abs().max())
        tol = op_tol(dt, b)
        if not torch.isfinite(a.float()).all() or err > tol:
            fail(f"{label}: {name} max error {err} > {tol}")
        worst = max(worst, err)
    return worst


def drive(fn, inputs, cotangent, env=None):
    """Outputs and input gradients of a public function under the route
    switches ``env``: kernels, then the plain path.  Returns (kernel_outs,
    plain_outs, launches, bodies), each outs list outputs + grads; launches
    counts the kernels' run only, bodies the body each kernel of that run
    that reports one (``native.WALKS``) ran at its last launch there."""
    from tf_flash_attention_tpu_torch import native
    env = env or {}
    res = []
    for kernels in (True, False):
        ctx = contextlib.nullcontext() if kernels else plain_attention(
            False if env == SPLIT else "kv")
        with ctx, switches(env):
            if kernels:
                native.reset_launch_counts()
            xs = [x.detach().requires_grad_(True) for x in inputs]
            outs = fn(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = torch.autograd.grad(outs[0], xs, cotangent)
            res.append([o.detach() for o in outs] + list(grads))
            if kernels:
                torch.cuda.synchronize()
                launches = {k: v for k, v in native.LAUNCHES.items() if v}
                bodies = {k: native.WALKS[k]["body"] for k in launches
                          if "body" in native.WALKS.get(k, {})}
    torch.cuda.synchronize()
    return res[0], res[1], launches, bodies


def op_phase(dev):
    """Phase 5.  Returns ({kernel: {err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}, {kernel: launches in the op path's run})."""
    from tf_flash_attention_tpu_torch import api, native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.flops import matmul_flops_forward
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule, MaskRule
    from tf_flash_attention_tpu_torch.ops import backward, forward
    from tf_flash_attention_tpu_torch.parallel.sharded import mha
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    bf, f32, h = torch.bfloat16, torch.float32, torch.float16
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cf = lambda x: x.transpose(1, 2)          # sequence-major -> channel-first
    BH, S, d = 64, 2048, 128
    q, k, v, do = (randn((BH, S, d), bf) for _ in range(4))
    causal = lambda Q, K, V: api.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
    err, per_case, case_bodies = {}, {}, {}

    def case(label, fn, inputs, cotangent, types, env=None):
        got, want, launches, case_bodies[label] = drive(fn, inputs, cotangent, env)
        per_case[label] = launches
        n_out = len(got) - 3
        names = ("o", "l", "m")[:n_out] + ("dq", "dk", "dv")
        fwd_err = compare(label, names[:n_out], got[:n_out], want[:n_out], types[:n_out])
        bwd_err = compare(label, names[n_out:], got[n_out:], want[n_out:], types[n_out:])
        fwd_k = [k for k in launches if k.endswith("_fwd")]
        bwd_k = [k for k in launches if not k.endswith("_fwd")]
        for kn in fwd_k:
            err[kn] = max(err.get(kn, 0.0), fwd_err)
        for kn in bwd_k:
            err[kn] = max(err.get(kn, 0.0), bwd_err)
        print(f"op {label}: launches {json.dumps(launches)}; max_abs_err fwd {fwd_err} "
              f"bwd {bwd_err}", flush=True)

    # (a) the training slice through causal_1d: the JAX routes, banded
    # forward and banded fused backward
    slice_types = (bf, f32, bf, bf, bf, bf)
    native.reset_launch_counts()
    case("(a) causal bf16", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types)
    # (b) the same with the deterministic split pair (FA_FUSED_BWD=0)
    case("(b) causal bf16 split", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types, SPLIT)
    # (c) GQA 8 q / 2 kv heads through mha, at the slice's width
    qg = randn((8, 8, S, d), bf)
    kg, vg = randn((8, 2, S, d), bf), randn((8, 2, S, d), bf)
    rule = CausalRule()

    case("(c) gqa 8/2 bf16", lambda Q, K, V: mha(Q, K, V, rule=rule), (qg, kg, vg),
         randn((8, 8, S, d), bf), (bf,) * 4)
    # (d) fp32 local_1d, q != k lengths: the window kernels
    Qd, Kd, Vd = (randn((4, 64, n), f32) for n in (1500, 2000, 2000))
    local = lambda Q, K, V: api.local_1d(Q, K, V, 5, 1, True, "scale_front", returning_l_m=True)
    dOd = randn((4, 64, 1500), f32)
    case("(d) local_1d f32", local, (Qd, Kd, Vd), dOd, (f32,) * 6)
    # (e) fp16 local_2d (scale_end), d 64 != v_d 96: window forward, banded
    # backward
    Q, K, V = randn((2, 4, 64, 32, 48), h), randn((2, 4, 64, 48, 32), h), \
        randn((2, 4, 96, 48, 32), h)
    case("(e) local_2d f16", lambda Q, K, V: api.local_2d(Q, K, V, 7, 0, False, "scale_end",
                                                          returning_l_m=True),
         (Q, K, V), randn((2, 4, 96, 32, 48), h), (h, f32, h, h, h, h))
    # (o), (p) the window sweep's bf16 shapes (tools/exp_window_sweep.py:33-50,
    # B 8, D 128): 8,192 tokens at a causal window of 512, and a 64 x 64
    # image at a causal 2-d window of 8, on the tensor-core window walks
    win_types = (bf, f32, bf, bf, bf, bf)
    Qo, Ko, Vo, dOo = (randn((8, 128, 8192), bf) for _ in range(4))
    case("(o) local_1d bf16 w512", lambda Q, K, V: api.local_1d(Q, K, V, 512, 0, True,
                                                                 "none_front", returning_l_m=True),
         (Qo, Ko, Vo), dOo, win_types)
    Qp, Kp, Vp, dOp = (randn((8, 128, 64, 64), bf) for _ in range(4))
    case("(p) local_2d bf16 w8", lambda Q, K, V: api.local_2d(Q, K, V, 8, 0, True, "none_front",
                                                               returning_l_m=True),
         (Qp, Kp, Vp), dOp, win_types)
    for label in ("(e) local_2d f16", "(o) local_1d bf16 w512", "(p) local_2d bf16 w8"):
        if not per_case[label].get("window_fwd"):
            fail(f"{label}: window_fwd did not launch: {per_case[label]}")
        if case_bodies[label].get("window_fwd") != "tensor-core":
            fail(f"{label}: window_fwd ran the {case_bodies[label].get('window_fwd')} body")
    for label in ("(o) local_1d bf16 w512", "(p) local_2d bf16 w8"):
        if not per_case[label].get("window_bwd"):
            fail(f"{label}: window_bwd did not launch: {per_case[label]}")
        if case_bodies[label].get("window_bwd") != "tensor-core":
            fail(f"{label}: window_bwd ran the {case_bodies[label].get('window_bwd')} body")
    # (f) the slice with the band routes switched off: the table kernels
    case("(f) causal bf16 table", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types,
         TABLE_ONLY)
    # (g) the slice with the opt-in resident forward (FA_RESIDENT=1)
    case("(g) causal bf16 resident", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types,
         RESIDENT)
    # (i) wide heads, d = v_d = 384 (the tensor-core forward's 32-key
    # stages, the backward's third tile class), bf16 causal, 16 rows of 1024
    qw, kw, vw, dow = (randn((16, 1024, 384), bf) for _ in range(4))
    case("(i) causal bf16 d 384", causal, (cf(qw), cf(kw), cf(vw)), cf(dow), slice_types)
    # (j), (k) fp16 on the tensor-core forward's two routes: banded, and the
    # table with the band routes off (16 rows of 1024, d 128)
    q16, k16, v16, do16 = (randn((16, 1024, 128), h) for _ in range(4))
    f16_types = (h, f32, h, h, h, h)
    case("(j) causal f16", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types)
    case("(k) causal f16 table", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types,
         TABLE_ONLY)
    # (l) d = 576, v_d = 64 (an MLA head width) bf16 causal, 8 rows of 1024:
    # past the tensor-core forward's classes, the scalar forward on the
    # banded and the resident route
    q5, k5 = randn((8, 1024, 576), bf), randn((8, 1024, 576), bf)
    v5, do5 = randn((8, 1024, 64), bf), randn((8, 1024, 64), bf)
    for label, env, want_fwd in (("(l) causal bf16 d 576", None, "banded_fwd"),
                                 ("(l) causal bf16 d 576 resident", RESIDENT, "resident_fwd")):
        case(label, causal, (cf(q5), cf(k5), cf(v5)), cf(do5), slice_types, env)
        if not per_case[label].get(want_fwd):
            fail(f"{label}: {want_fwd} did not launch: {per_case[label]}")
    # (m) the resident route on fp16 (the tensor-core body's fp16 walk)
    case("(m) causal f16 resident", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types,
         RESIDENT)

    # (n) a custom mask rule, causal on a checkerboard of 32-position squares
    # with conservative tile tests (every tile live, none fully visible): its
    # check reaches the op bodies through its granule mask (kind 3) on every
    # route it takes (auto, the table kernels, the split pair, the resident
    # forward, and below the q-outer backward), bf16 at d 128 (the
    # tensor-core bodies) and float32 (the scalar bodies)
    class Checker(MaskRule):
        def check(self, pack, q_coords, k_coords, q_flat, k_flat):
            return (q_flat >= k_flat) & ((q_flat // 32 + k_flat // 32) % 2 == 0)

        def tile_live(self, pack, *bounds):
            return bounds[-1] == bounds[-1]

        def tile_fully_visible(self, pack, *bounds):
            return bounds[-1] != bounds[-1]

    checker = Checker()
    if native.fa_rule(make_sync_pack("none_front", (64,), (64,)), checker,
                      dev).kind != native.CUSTOM_KIND:
        fail("(n): a custom rule is not the kernels' custom kind")
    custom = lambda Q, K, V: api.flash_attention(Q, K, V, rule=checker, returning_l_m=True)
    qn, kn, vn, don = (randn((8, 1024, 128), bf) for _ in range(4))
    for env_name, env in (("auto", None), ("table", TABLE_ONLY), ("split", SPLIT),
                          ("resident", RESIDENT)):
        case(f"(n) custom bf16 {env_name}", custom, (cf(qn), cf(kn), cf(vn)), cf(don),
             slice_types, env)
    qc, kc, vc, doc = (randn((4, 1024, 64), f32) for _ in range(4))
    for env_name, env in (("auto", None), ("table", TABLE_ONLY)):
        case(f"(n) custom f32 {env_name}", custom, (cf(qc), cf(kc), cf(vc)), cf(doc),
             (f32,) * 6, env)
    pack_n = make_sync_pack("none_front", (1024,), (1024,))
    cfg_n = choose_block_config(128, 128)
    on, ln, mn = forward.flash_forward(qn, kn, vn, pack=pack_n, rule=checker, config=cfg_n)
    native.reset_launch_counts()
    got = backward.flash_backward(qn, kn, vn, on, ln, mn, don, pack=pack_n, rule=checker,
                                  config=cfg_n, fused="q")
    torch.cuda.synchronize()
    if not native.LAUNCHES["flash_bwd_qouter"]:
        fail("(n) custom q-outer: flash_bwd_qouter did not launch")
    lse2n, deltan = backward.backward_stats(on, ln, mn, don)
    want = backward._flash_backward_plain(qn, kn, vn, don, lse2n, deltan, pack_n, checker,
                                          128 ** -0.5, True)
    e_n = compare("(n) custom bf16 q-outer", ("dq", "dk", "dv"), got, want, (bf,) * 3)
    print(f"op (n) custom bf16 q-outer (direct call): body "
          f"{native.WALKS['flash_bwd_qouter']['body']}; max_abs_err bwd {e_n}", flush=True)
    op_launches = {}
    for launches in per_case.values():
        for kn, n in launches.items():
            op_launches[kn] = op_launches.get(kn, 0) + n
    # (h) the q-outer fused backward: as in the JAX package, only a direct
    # call with fused="q" reaches it (here the GQA 8/2 case, sequence-major)
    pack, cfg = make_sync_pack("none_front", (S,), (S,)), choose_block_config(d, d)
    qh, kh, vh = qg.reshape(64, S, d), kg.reshape(16, S, d), vg.reshape(16, S, d)
    doh = randn((64, S, d), bf)
    oh, lh, mh = forward.flash_forward(qh, kh, vh, pack=pack, rule=rule, config=cfg)
    native.reset_launch_counts()
    got = backward.flash_backward(qh, kh, vh, oh, lh, mh, doh, pack=pack, rule=rule, config=cfg,
                                  fused="q")
    torch.cuda.synchronize()
    qouter_launches = {k: v for k, v in native.LAUNCHES.items() if v}
    lse2h, deltah = backward.backward_stats(oh, lh, mh, doh)
    want = backward._flash_backward_plain(qh, kh, vh, doh, lse2h, deltah, pack, rule, d ** -0.5,
                                          True)
    err["flash_bwd_qouter"] = compare("(h) gqa 8/2 bf16 q-outer", ("dq", "dk", "dv"), got, want,
                                      (bf,) * 3)
    qouter_body = native.WALKS["flash_bwd_qouter"]["body"]
    if qouter_body != native.bwd_body(bf, d, d):
        fail(f"(h): flash_bwd_qouter ran the {qouter_body} body, bwd_body names "
             f"{native.bwd_body(bf, d, d)}")
    print(f"op (h) gqa 8/2 bf16 q-outer (direct call): launches {json.dumps(qouter_launches)}; "
          f"body {qouter_body}; max_abs_err bwd {err['flash_bwd_qouter']}", flush=True)
    op_launches["flash_bwd_qouter"] = qouter_launches.get("flash_bwd_qouter", 0)
    missing = [kn for kn in native.ATTENTION_KERNELS if not op_launches.get(kn)]
    if missing:
        fail(f"op path: kernels never launched: {missing} ({op_launches})")

    # kernel, plain and library times (these launches are not counted in any
    # path), and each kernel's bound: the bytes of its inputs and outputs, and
    # its products over the visible (query, key) pairs of the rule
    from tf_flash_attention_tpu_torch.ops.reference import build_mask
    times = {}

    def sdpa(q4, k4, v4, do4=None, **kw):
        """One scaled_dot_product_attention call (forward, or with ``do4``
        forward and backward) on (1, B, S, d) views."""
        if do4 is None:
            return lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)

        def fwd_bwd():
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            torch.autograd.grad(F.scaled_dot_product_attention(*xs, **kw), xs, do4)
        return fwd_bwd

    def slice_routes(env):
        with switches(env):
            return (forward.forward_route(pack, rule, cfg, d, d),
                    backward.backward_route(pack, rule, cfg, 1, "kv")[0],
                    backward.backward_route(pack, rule, cfg, 1, False))

    scale = d ** -0.5
    q_s, k_s = forward.prescale(q, scale), forward.prescale(k, scale)
    fb, bb, _ = slice_routes({})
    ft, bt, (rdq, rdkv) = slice_routes(TABLE_ONLY)
    fr = slice_routes(RESIDENT)[0]
    (bq,) = backward.backward_route(pack, rule, cfg, 1, "q")
    if (fb.kernel, bb.kernel, ft.kernel, bt.kernel, fr.kernel) != (
            "banded_fwd", "banded_bwd", "flash_fwd", "flash_bwd_fused", "resident_fwd"):
        fail(f"unexpected slice routes {fb.kernel} {bb.kernel} {ft.kernel} {bt.kernel} "
             f"{fr.kernel}")
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)
    lse2, delta = backward.backward_stats(o, l, m, do)
    tabs = lambda r: r.tables(pack, rule, dev)
    rule_c = native.fa_rule(pack, rule)
    plain_fwd = lambda: forward._flash_forward_plain(q_s, k, v, pack, rule)
    plain_fused = lambda: backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule,
                                                         scale, "kv")
    plain_split = lambda: backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule,
                                                         scale, False)
    area2 = matmul_flops_forward(rule, "none_front", (S,), (S,), d, d, BH) / (2 * d)
    pairs = BH * int(build_mask(pack, rule).sum())
    q4, k4, v4, do4 = (x.unsqueeze(0) for x in (q, k, v, do))
    lib_fwd = sdpa(q4, k4, v4, is_causal=True)
    lib_bwd = sdpa(q4, k4, v4, do4, is_causal=True)
    tensor = q.numel() * q.element_size()             # q, k, v, do, o, dq, dk, dv alike
    stats = BH * S * 4                                 # l, m, lse2, delta (float32)
    # forward: q, k, v in, o, l, m out; backward: q, k, v, do, lse2, delta in
    fwd_bytes = bwd_bytes = 4 * tensor + 2 * stats
    # products per kernel (each 2 * area * width): forward S, PV; fused
    # backward S, dP, dV, dK, dQ; split dQ S, dP, dQ; split dK/dV S, dP, dV, dK;
    # and the bytes each reads and writes
    launch = {
        "flash_fwd": (lambda: native.flash_fwd(q_s, k, v, rule_c, tabs(ft), 128, 128),
                      plain_fwd, 2, fwd_bytes, lib_fwd),
        "banded_fwd": (lambda: native.banded_fwd(q_s, k, v, rule_c, tabs(fb)[0], 128, 128),
                       plain_fwd, 2, fwd_bytes, lib_fwd),
        "resident_fwd": (lambda: native.resident_fwd(q_s, k, v, rule_c, tabs(fr)[0], 128, 128),
                         plain_fwd, 2, fwd_bytes, lib_fwd),
        "flash_bwd_fused": (
            lambda: native.flash_bwd_fused(q_s, k, v, do, lse2, delta, rule_c, tabs(bt), 128,
                                           128, 1.0 / math.log2(math.e)), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "banded_bwd": (
            lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs(bb)[0], 128,
                                      128, 1.0 / math.log2(math.e)), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "flash_bwd_qouter": (
            lambda: native.flash_bwd_qouter(q_s, k, v, do, lse2, delta, rule_c, tabs(bq), 128,
                                            128, scale), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "flash_bwd_dq": (
            lambda: native.flash_bwd_dq(q_s, k, v, do, lse2, delta, rule_c, tabs(rdq), 128, 128,
                                        scale), plain_split, 3, bwd_bytes + tensor, None),
        "flash_bwd_dkv": (
            lambda: native.flash_bwd_dkv(q, k_s, v, do, lse2, delta, rule_c, tabs(rdkv), 128,
                                         128, scale), plain_split, 4,
            bwd_bytes + 2 * tensor, None),
    }
    # the split pair at the slice, each kernel launched on its own: within
    # op_tol of the plain split backward, two launches bit-equal (the route
    # is deterministic), on the body bwd_body names, as each launch reports it
    want_split = plain_split()
    split = {}
    for kn, outs in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
        runs = []
        for _ in range(2):
            got = launch[kn][0]()
            runs.append(got if isinstance(got, tuple) else (got,))
        torch.cuda.synchronize()
        want = [want_split[("dq", "dk", "dv").index(o)] for o in outs]
        err[kn] = max(err.get(kn, 0.0), compare(f"{kn} (slice)", outs, runs[0], want,
                                                (bf,) * len(outs)))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"{kn} (slice): two launches on the same inputs differ")
        body = native.WALKS[kn]["body"]
        if body != native.bwd_body(bf, d, d):
            fail(f"{kn} (slice): the launch ran the {body} body, bwd_body names "
                 f"{native.bwd_body(bf, d, d)}")
        split[kn] = dict(body=body, deterministic=True)
    for kn, (kern, plain, products, n_bytes, lib) in launch.items():
        ms, plain_ms = time_ms(kern, n=10), time_ms(plain, n=5)
        lib_ms = None if lib is None else time_ms(lib, n=10)
        b_ms, b_by = bound(n_bytes, products * 2 * pairs * d, "bf16")
        times[kn] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by)
        times[kn]["body"] = (native.fwd_body(bf, d, d) if kn.endswith("_fwd")
                             else native.bwd_body(bf, d, d))
        times[kn].update(split.get(kn, {}))
        extra = " deterministic=True" if kn in split else ""
        if kn == "resident_fwd":   # the persistent walk, as its last launch reports it
            walk = native.WALKS[kn]
            if walk["body"] != times[kn]["body"]:
                fail(f"phase 5: resident_fwd ran the {walk['body']} body, fwd_body names "
                     f"{times[kn]['body']}")
            times[kn].update({x: walk[x] for x in ("grid", "items", "group_rows")})
            extra = (f" grid={walk['grid']} items={walk['items']} rows in flight: one or two "
                     f"groups of {walk['group_rows']}")
        print(f"kernel {kn} (slice): body={times[kn]['body']}{extra} ms={ms} plain_ms={plain_ms} "
              f"library_ms={lib_ms} bound_ms={b_ms} ({b_by}) useful TFLOP/s="
              f"{products * area2 * d / ms / 1e9:.3f}", flush=True)
    res, band = times["resident_fwd"], times["banded_fwd"]
    print(f"resident_fwd beside banded_fwd (slice): {res['ms']} vs {band['ms']} ms = "
          f"{res['ms'] / band['ms']:.3f}x; library {res['library_ms']} ms = "
          f"{res['ms'] / res['library_ms']:.3f}x; bound share {res['bound_ms'] / res['ms']:.4f}",
          flush=True)
    # the q-outer backward at (h)'s GQA 8/2 shape beside the kv-outer table
    # kernel and the library's GQA forward + backward, each kernel alone
    # (its wrapper's accumulator zero fills included, the casts not)
    qh_s = forward.prescale(qh, scale)
    g_pairs = 64 * int(build_mask(pack, rule).sum())
    g_bytes = 3 * qh.numel() * 2 + 4 * kh.numel() * 2 + 2 * 64 * S * 4
    gqa = dict(ms=time_ms(lambda: native.flash_bwd_qouter(qh_s, kh, vh, doh, lse2h, deltah,
                                                           rule_c, tabs(bq), 128, 128, scale),
                          n=10),
               flash_bwd_fused_ms=time_ms(lambda: native.flash_bwd_fused(
                   qh_s, kh, vh, doh, lse2h, deltah, rule_c, tabs(bt), 128, 128,
                   1.0 / math.log2(math.e)), n=10),
               library_ms=time_ms(sdpa(qg, kg, vg, doh.reshape(qg.shape), is_causal=True,
                                       enable_gqa=True), n=10))
    gqa["bound_ms"], gqa["bound_by"] = bound(g_bytes, 5 * 2 * g_pairs * d, "bf16")
    times["flash_bwd_qouter"]["gqa"] = gqa
    print(f"kernel flash_bwd_qouter ((h) gqa 8/2, 64 q / 16 kv heads): body={qouter_body} "
          f"ms={gqa['ms']} flash_bwd_fused ms={gqa['flash_bwd_fused_ms']} "
          f"({gqa['ms'] / gqa['flash_bwd_fused_ms']:.3f}x) library_ms={gqa['library_ms']} "
          f"bound_ms={gqa['bound_ms']} ({gqa['bound_by']})", flush=True)
    # what dQ costs the tensor-core backward: banded_bwd without the dS^T
    # tile, the dQ product and its reduction (not counted in any path)
    no_dq_ms = time_ms(lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs(bb)[0],
                                                 128, 128, 1.0 / math.log2(math.e),
                                                 with_dq=False), n=10)
    times["banded_bwd"]["ms_without_dq"] = no_dq_ms
    print(f"kernel banded_bwd without dQ (slice): ms={no_dq_ms}; dQ's product and reduction "
          f"{times['banded_bwd']['ms'] - no_dq_ms:.4f} ms of {times['banded_bwd']['ms']}",
          flush=True)
    # the two torch passes around a fused backward's launch (ops/backward.py,
    # native.py): the zero fill of the float32 dQ accumulator and dQ's
    # scale-and-cast
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    zero_ms = time_ms(lambda: torch.zeros(q.shape, dtype=torch.float32, device=dev), n=10)
    cast_ms = time_ms(lambda: (dq_acc * scale).to(bf), n=10)
    print(f"dq_acc passes (slice): zero fill ms={zero_ms} scale-and-cast ms={cast_ms}",
          flush=True)
    # the pair computes what one scaled_dot_product_attention backward does:
    # its yardstick is the library's forward + backward (lib_bwd), as for
    # the fused rows
    split_ms = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkv"]["ms"]
    pair_lib_ms = time_ms(lib_bwd, n=10)
    pair = dict(ms=split_ms, library_ms=pair_lib_ms, factor=split_ms / pair_lib_ms)
    for kn in ("flash_bwd_dq", "flash_bwd_dkv"):
        times[kn]["pair"] = pair
    print(f"kernel split pair (slice): {split_ms} ms for one backward = "
          f"{5 * area2 * d / split_ms / 1e9:.3f} useful TFLOP/s; library (SDPA forward + "
          f"backward) {pair_lib_ms} ms: the pair {pair['factor']:.3f}x; the plain_ms of each "
          f"of the pair is the whole plain split backward", flush=True)

    # the window kernels at case (d)'s shape (fp32, d = v_d = 64)
    local_rule = LocalRule(5, 1, True)
    pack_d = make_sync_pack("scale_front", (1500,), (2000,))
    qd, kd, vd, dod = cf(Qd).contiguous(), cf(Kd).contiguous(), cf(Vd).contiguous(), \
        cf(dOd).contiguous()
    scale_d = 64 ** -0.5
    cfg_d = choose_block_config(64, 64)
    fw = forward.forward_route(pack_d, local_rule, cfg_d, 64, 64)
    (bw,) = backward.backward_route(pack_d, local_rule, cfg_d, 1, "kv")
    if (fw.kernel, bw.kernel) != ("window_fwd", "window_bwd"):
        fail(f"case (d) routes to {fw.kernel}, {bw.kernel}, not the window kernels")
    qd_s = forward.prescale(qd, scale_d)
    rc_d = native.fa_rule(pack_d, local_rule)
    od, ld, md = forward.flash_forward(qd, kd, vd, pack=pack_d, rule=local_rule, config=cfg_d)
    lse2_d, delta_d = backward.backward_stats(od, ld, md, dod)
    area2_d = matmul_flops_forward(local_rule, "scale_front", (1500,), (2000,), 64, 64, 4) / 128
    tabs_q, tabs_k = fw.tables(pack_d, local_rule, dev), bw.tables(pack_d, local_rule, dev)
    mask_d = torch.from_numpy(build_mask(pack_d, local_rule).reshape(1500, 2000).copy()).to(dev)
    pairs_d = 4 * int(mask_d.sum())
    qd4, kd4, vd4, dod4 = (x.unsqueeze(0) for x in (qd, kd, vd, dod))
    q_bytes, k_bytes, stats_d = qd.numel() * 4, kd.numel() * 4, 4 * 1500 * 4
    window = {
        "window_fwd": (lambda: native.window_fwd(qd_s, kd, vd, rc_d, *tabs_q, fw.band, fw.sub,
                                                 fw.masked),
                       lambda: forward._flash_forward_plain(qd_s, kd, vd, pack_d, local_rule),
                       2, 2 * q_bytes + 2 * k_bytes + 2 * stats_d,
                       sdpa(qd4, kd4, vd4, attn_mask=mask_d)),
        "window_bwd": (lambda: native.window_bwd(qd_s, kd, vd, dod, lse2_d, delta_d, rc_d,
                                                 *tabs_k, bw.band, bw.sub,
                                                 1.0 / math.log2(math.e)),
                       lambda: backward._flash_backward_plain(qd, kd, vd, dod, lse2_d, delta_d,
                                                              pack_d, local_rule, scale_d, "kv"),
                       5, 3 * q_bytes + 4 * k_bytes + 2 * stats_d,
                       sdpa(qd4, kd4, vd4, dod4, attn_mask=mask_d)),
    }
    case_d = {}
    for kn, (kern, plain, products, n_bytes, lib) in window.items():
        ms, plain_ms, lib_ms = time_ms(kern, n=10), time_ms(plain, n=5), time_ms(lib, n=10)
        body = native.WALKS[kn]["body"]
        b_ms, b_by = bound(n_bytes, products * 2 * pairs_d * 64, "f32")
        case_d[kn] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, body=body)
        print(f"kernel {kn} (case d, band {fw.band if kn == 'window_fwd' else bw.band}): "
              f"body={body} ms={ms} plain_ms={plain_ms} library_ms={lib_ms} bound_ms={b_ms} "
              f"({b_by}) useful TFLOP/s (128-tile schedule)="
              f"{products * area2_d * 64 / ms / 1e9:.3f}", flush=True)
    # the window kernels at the sweep's bf16 shapes, (o) and (p): the main
    # numbers of their rows are local1d_w512's
    shapes = {"local1d_w512": window_shape(dev, err, "local1d_w512", Qo, Ko, Vo, dOo),
              "local2d_w8": window_shape(dev, err, "local2d_w8", Qp, Kp, Vp, dOp)}
    for kn in window:
        times[kn] = dict(shapes["local1d_w512"][kn], shapes={
            "local1d_w512": shapes["local1d_w512"][kn], "local2d_w8": shapes["local2d_w8"][kn],
            "case_d_f32": case_d[kn]})
    return {kn: dict(times[kn], err=err[kn]) for kn in native.ATTENTION_KERNELS}, op_launches


#: (rule arguments, sequence shape) of the window sweep's shapes
WINDOW_SHAPES = {"local1d_w512": ((512, 0, True), (8192,)), "local2d_w8": ((8, 0, True), (64, 64))}
#: each op kernel's CUDA kernels by body, as the profiler lists them
OP_KERNEL_NAMES = {"fwd": {"tensor-core": ("fwd_tc_kernel",),
                           "scalar": ("window_fwd_kernel", "flash_fwd_kernel")},
                   "bwd": {"tensor-core": ("bwd_tc_kernel",), "scalar": ("flash_bwd_kv_kernel",)}}


def window_shape(dev, err, shape, Q, K, V, dO):
    """The window kernels at one of the sweep's bf16 shapes (channel-first
    Q, K, V, dO of the op case that drove them): each binding against its
    plain version (op_tol; dK and dV of two launches bit-equal), on the body
    fwd_body / bwd_body names as its launch reports it, then its CUDA-event
    ms, kernel_ms, plain_ms, library_ms (scaled_dot_product_attention with
    the dense boolean mask; forward + backward for the backward), bound
    (the forward's bytes: q, k, v, o and the stats; the backward's: q, k, v,
    dO, the stats, dK, dV and the float32 dQ accumulator written once;
    the products over the visible pairs) and the route FA_WINDOW=0 /
    FA_WINDOW_BWD=0 takes at the same shape, timed the same way.  Returns
    {kernel: numbers}."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.ops import backward, forward
    from tf_flash_attention_tpu_torch.ops.reference import build_mask
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    bf = torch.bfloat16
    (window, stride, causal), seq = WINDOW_SHAPES[shape]
    rule, pack = LocalRule(window, stride, causal), make_sync_pack("none_front", seq, seq)
    B, D, S = Q.shape[0], Q.shape[1], math.prod(seq)
    sm = lambda x: x.reshape(B, D, S).transpose(1, 2).contiguous()   # sequence-major
    q, k, v, do = (sm(x) for x in (Q, K, V, dO))
    cfg, scale = choose_block_config(D, D), D ** -0.5
    routes = {}
    for env_name, env in (("window", {}), ("off", {"FA_WINDOW": "0", "FA_WINDOW_BWD": "0"})):
        with switches(env):
            routes[env_name] = (forward.forward_route(pack, rule, cfg, D, D),
                                backward.backward_route(pack, rule, cfg, 1, "kv")[0])
    fw, bw = routes["window"]
    if (fw.kernel, bw.kernel) != ("window_fwd", "window_bwd"):
        fail(f"{shape}: routes to {fw.kernel}, {bw.kernel}, not the window kernels")
    q_s, rule_c = forward.prescale(q, scale), native.fa_rule(pack, rule, dev)
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)
    lse2, delta = backward.backward_stats(o, l, m, do)
    dk_scale = 1.0 / math.log2(math.e)

    def bind(route):
        tabs = route.tables(pack, rule, dev)
        if route.kernel == "window_fwd":
            return lambda: native.window_fwd(q_s, k, v, rule_c, *tabs, route.band, route.sub,
                                             route.masked)
        if route.kernel == "window_bwd":
            return lambda: native.window_bwd(q_s, k, v, do, lse2, delta, rule_c, *tabs,
                                             route.band, route.sub, dk_scale)
        if route.kernel == "banded_fwd":
            return lambda: native.banded_fwd(q_s, k, v, rule_c, tabs[0], route.block_q,
                                             route.block_kv)
        if route.kernel == "banded_bwd":
            return lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs[0],
                                             route.block_q, route.block_kv, dk_scale)
        fail(f"{shape}: the FA_WINDOW=0 route is {route.kernel}, which this phase does not time")

    mask = torch.from_numpy(build_mask(pack, rule).reshape(S, S).copy()).to(dev)
    pairs = B * int(mask.sum())
    q4, k4, v4, do4 = (x.unsqueeze(0) for x in (q, k, v, do))

    def lib_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def lib_fwd_bwd():
        xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        torch.autograd.grad(F.scaled_dot_product_attention(*xs, attn_mask=mask), xs, do4)

    tensor, stats = q.numel() * q.element_size(), 2 * B * S * 4
    plain_fwd = lambda: forward._flash_forward_plain(q_s, k, v, pack, rule)
    plain_bwd = lambda: backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule,
                                                       scale, True)
    out = {}
    for kn, alt, plain, lib, products, n_bytes, side in (
            ("window_fwd", routes["off"][0], plain_fwd, lib_fwd, 2, 4 * tensor + stats, "fwd"),
            ("window_bwd", routes["off"][1], plain_bwd, lib_fwd_bwd, 5,
             6 * tensor + stats + 2 * tensor, "bwd")):
        kern = bind(fw if kn == "window_fwd" else bw)
        runs = [kern(), kern()]
        want = plain()
        torch.cuda.synchronize()
        if kn == "window_fwd":
            names, types, got = ("o", "l", "m"), (bf, torch.float32, torch.float32), runs[0]
        else:
            names, types = ("dq", "dk", "dv"), (bf, bf, bf)
            got = ((runs[0][0] * scale).to(bf),) + runs[0][1:]
            if not (torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])):
                fail(f"{kn} ({shape}): dK or dV of two launches differ")
        e = compare(f"{kn} ({shape})", names, got, want, types)
        err[kn] = max(err.get(kn, 0.0), e)
        body = native.WALKS[kn]["body"]
        want_body = native.fwd_body(bf, D, D) if side == "fwd" else native.bwd_body(bf, D, D)
        if body != want_body or body != "tensor-core":
            fail(f"{kn} ({shape}): the launch ran the {body} body, the rule names {want_body}")
        b_ms, b_by = bound(n_bytes, products * 2 * pairs * D, "bf16")
        alt_fn = bind(alt)
        m_ = dict(ms=time_ms(kern, n=10), kernel_ms=kernel_ms(kern, OP_KERNEL_NAMES[side][body]),
                  plain_ms=time_ms(plain, n=5), library_ms=time_ms(lib, n=10), bound_ms=b_ms,
                  bound_by=b_by, body=body, max_abs_err=e, band=(fw if side == "fwd" else bw).band,
                  window_off=dict(kernel=alt.kernel, body=want_body, ms=time_ms(alt_fn, n=10),
                                  kernel_ms=kernel_ms(alt_fn, OP_KERNEL_NAMES[side][want_body])))
        out[kn] = m_
        print(f"kernel {kn} ({shape} bf16, B {B}, D {D}, band {m_['band']}): body={body} "
              f"ms={m_['ms']} kernel_ms={m_['kernel_ms']} plain_ms={m_['plain_ms']} "
              f"library_ms={m_['library_ms']} bound_ms={b_ms} ({b_by}); FA_WINDOW=0 route "
              f"{alt.kernel} ({want_body}) ms={m_['window_off']['ms']} kernel_ms="
              f"{m_['window_off']['kernel_ms']}; max_abs_err {e}", flush=True)
    return out


def grad_norm(model):
    return math.sqrt(sum(float((p.grad.float() ** 2).sum()) for p in model.parameters()))


def train_phase(mcfg, cpu_model, dev, seed):
    """Phase 6: 5 AdamW steps of the 168M decoder at 8 x 2048 tokens.
    Returns ({kernel: launches in the 5 steps}, the batch, and the plain
    path's first-step loss and gradient norm, which phase 6b reuses)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf

    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, mcfg.vocab, (8, 2049), generator=gen).to(dev)

    model = copy.deepcopy(cpu_model).to(dev)
    with plain_attention():
        loss = tf.loss_fn(mcfg, model, tokens)
        loss.backward()
        loss_plain, gnorm_plain = float(loss.detach()), grad_norm(model)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)   # optax.adamw's defaults
    losses, step_s = [], []
    native.reset_launch_counts()
    for step in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tf.train_step(mcfg, model, tokens, optimizer=opt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if step == 0:
            gnorm = grad_norm(model)
    launches = {k: v for k, v in native.LAUNCHES.items() if v}
    if not launches.get("banded_fwd") or not launches.get("banded_bwd"):
        fail(f"the training step did not run the banded kernels: {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"training losses {losses} are not finite and falling")
    if abs(losses[0] - loss_plain) > TRAIN_LOSS_ATOL:
        fail(f"first-step loss {losses[0]} vs plain path {loss_plain}: > {TRAIN_LOSS_ATOL}")
    if abs(gnorm - gnorm_plain) > TRAIN_GNORM_RTOL * gnorm_plain:
        fail(f"first-step grad norm {gnorm} vs plain path {gnorm_plain}: "
             f"> {TRAIN_GNORM_RTOL} relative")
    ms = statistics.median(step_s[1:]) * 1e3
    print(f"train: losses {losses}; first step loss {losses[0]} vs plain {loss_plain} "
          f"(tol {TRAIN_LOSS_ATOL}), grad norm {gnorm} vs plain {gnorm_plain} (rtol "
          f"{TRAIN_GNORM_RTOL}); step ms {[round(s * 1e3, 3) for s in step_s]}, median of "
          f"steps 2-5 {ms:.3f} ms = {8 * 2048 / ms * 1e3:.1f} tokens/s ({ms / STEP_MS_BEFORE:.4f}"
          f"x the {STEP_MS_BEFORE} ms before); launches in the 5 steps {json.dumps(launches)}",
          flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return launches, tokens, loss_plain, gnorm_plain


# phase 6b: a context axis of 4 on the card at the op level; the rows of
# PERF.md's kernel table that the ring and the sharded step can take
RING_SHAPE = (4, 8, 8192, 128)
RING_AXES = ("data", "model", "context")
RING_KERNELS = ("flash_fwd", "banded_fwd", "window_fwd", "resident_fwd", "flash_bwd_fused",
                "window_bwd", "banded_bwd")


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def ring_op_phase(dev, seed):
    """Phase 6b(a): the ring (causal, full, a causal window of 1024) and
    Ulysses (causal) on a context axis of 4 (cuda:0 four times) at
    RING_SHAPE bf16: outputs and dQ/dK/dV against single-device mha within
    op_tol and against the same function on the plain versions within
    attn_tol.  Returns {kernel: launches} of the four runs under test."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, FullRule, LocalRule
    from tf_flash_attention_tpu_torch.parallel import (make_mesh, mha, ring, ring_flash_attention,
                                                       ulysses_flash_attention)

    bf = torch.bfloat16
    b, h, S, d = RING_SHAPE
    n = 4
    mesh = make_mesh((1, 1, n), RING_AXES, [dev] * n)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=dev).to(bf) for _ in range(4))
    window = LocalRule(1024, is_causal=True)
    # the eager functions: phase 12(b) replays the callables' graphs
    cases = [("ring causal", CausalRule(), ring_flash_attention(mesh, rule=CausalRule()).eager),
             ("ring full", FullRule(), ring_flash_attention(mesh, rule=FullRule()).eager),
             ("ring local w1024 causal", window, ring_flash_attention(mesh, rule=window).eager),
             ("ulysses causal", CausalRule(), ulysses_flash_attention(mesh, CausalRule()).eager)]

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do)]

    names = ("o", "dq", "dk", "dv")
    total = {}
    for label, rule, fn in cases:
        native.reset_launch_counts()
        got = run(fn)
        torch.cuda.synchronize()
        launches = {kk: vv for kk, vv in native.LAUNCHES.items() if vv}
        _add_launches(total, launches)
        mha_err = compare(f"6b {label} vs mha", names, got,
                          run(lambda Q, K, V: mha(Q, K, V, rule=rule)), (bf,) * 4)
        with plain_attention():
            want = run(fn)
        plain_err = 0.0
        for name, a, ref in zip(names, got, want):
            err, tol = float((a.float() - ref.float()).abs().max()), attn_tol(ref)
            if not torch.isfinite(a.float()).all() or err > tol:
                fail(f"6b {label}: {name} max error {err} against the plain versions > {tol}")
            plain_err = max(plain_err, err)
        del want
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fn(q, k, v), n=10)
        fb_ms = time_ms(lambda: run(fn), n=10)
        if label.startswith("ring"):
            steps = ([t for t, _, _ in ring._local_live_steps(rule, n, S // n)]
                     if isinstance(rule, LocalRule) else list(range(n)))
            visited = (f"ring steps visited {steps}, shard pairs "
                       f"{sum(vv for kk, vv in launches.items() if kk.endswith('_fwd'))} of "
                       f"{n * n}")
        else:
            visited = "all-to-all, one local attention a head group"
        print(f"6b(a) {label} (b, h, S, d) {RING_SHAPE} bf16, context {n} on the card: "
              f"{visited}; launches {json.dumps(launches)}; max_abs_err vs mha {mha_err} "
              f"(op_tol), vs plain versions {plain_err} (attn_tol); forward {fwd_ms:.4f} ms, "
              f"forward + backward {fb_ms:.4f} ms", flush=True)
        del got
        torch.cuda.empty_cache()
    return total


def train_step_profile(label, step, phase="6b(b)"):
    """One training step ``step()`` under torch.profiler: its wall ms, the
    device's busy ms (each CUDA kernel and copy once) and share of the
    wall, the kernels it launched, and the device ms by class."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    classes, n = {}, 0
    names = sum((v for d in OP_KERNEL_NAMES.values() for v in d.values()), ())
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        cls = ("attention" if any(k in e.name for k in names) else "matmul"
               if any(k in e.name.lower() for k in ("gemm", "nvjet", "cutlass")) else "other")
        classes[cls] = classes.get(cls, 0.0) + e.device_time_total / 1e3
    busy = sum(classes.values())
    print(f"{phase} step profile {label}: {wall:.3f} ms wall (profiled); "
          + (f"device busy {busy:.3f} ms = {busy / wall:.4f} of the wall; {n} kernels and "
             f"copies; device ms by class {json.dumps({k: round(v, 3) for k, v in classes.items()})}"
             if busy else "device time not measured (the profiler saw no device events)"),
          flush=True)


def ring_train_phase(mcfg, cpu_model, dev, tokens, loss_plain, gnorm_plain):
    """Phase 6b(b): 3 AdamW steps of the 168M decoder on phase 6's batch
    through make_sharded_train_step on (data 2, model 4) and, with
    context_parallel, on (data 2, model 2, context 2), each mesh cuda:0
    repeated: first-step loss and gradient norm against phase 6's plain
    path, falling losses, the ring's pairs launched; then one more step of
    each, and one of phase 6's unsharded step for comparison, under
    torch.profiler (``train_step_profile``).  Returns {kernel: launches} of
    the two sharded runs' first 3 steps."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel import make_mesh

    total = {}
    b, s = tokens.shape[0], tokens.shape[1] - 1

    def adamw(model):   # phase 6's, capturable (the factory's step on one card is a graph)
        return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4, capturable=True)

    model = copy.deepcopy(cpu_model).to(dev)
    opt = adamw(model)
    tf.train_step(mcfg, model, tokens, optimizer=opt)       # warm
    train_step_profile("unsharded (phase 6's step)",
                       lambda: tf.train_step(mcfg, model, tokens, optimizer=opt))
    del model, opt
    for label, cfg, shape, axes in (
            ("tp", mcfg, (2, 4), ("data", "model")),
            ("cp", dataclasses.replace(mcfg, context_parallel=True), (2, 2, 2), RING_AXES)):
        mesh = make_mesh(shape, axes, [dev] * math.prod(shape))
        model = copy.deepcopy(cpu_model).to(dev)
        opt = adamw(model)
        step = tf.make_sharded_train_step(cfg, mesh, opt).eager    # phase 12: its graph
        losses, step_s = [], []
        native.reset_launch_counts()
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(model, tokens)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:
                gnorm = grad_norm(model)
        launches = {k: v for k, v in native.LAUNCHES.items() if v}
        _add_launches(total, launches)
        # one attention call a (data, model) block, layer and step; under cp a
        # ring over 2 shards whose causal pairs are 3 of 4
        blocks = shape[0] * shape[1] * mcfg.n_layers * 3
        pairs = blocks * (3 if label == "cp" else 1)
        n_fwd = sum(v for k, v in launches.items() if k.endswith("_fwd"))
        n_bwd = sum(v for k, v in launches.items() if k in native.ATTENTION_KERNELS
                    and not k.endswith("_fwd"))
        if n_fwd != pairs or n_bwd != pairs:
            fail(f"6b(b) {label}: {n_fwd} forward and {n_bwd} backward launches, "
                 f"{pairs} expected: {launches}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"6b(b) {label}: training losses {losses} are not finite and falling")
        if abs(losses[0] - loss_plain) > TRAIN_LOSS_ATOL:
            fail(f"6b(b) {label}: first-step loss {losses[0]} vs plain path {loss_plain}: "
                 f"> {TRAIN_LOSS_ATOL}")
        if abs(gnorm - gnorm_plain) > TRAIN_GNORM_RTOL * gnorm_plain:
            fail(f"6b(b) {label}: first-step grad norm {gnorm} vs plain path {gnorm_plain}: "
                 f"> {TRAIN_GNORM_RTOL} relative")
        ms = statistics.median(step_s[1:]) * 1e3
        print(f"6b(b) sharded train {label}, mesh {dict(zip(axes, shape))} on cuda:0 x "
              f"{math.prod(shape)} (the shards run one after another on the one card; no "
              f"communication is measured): losses {losses}; first step loss {losses[0]} vs "
              f"plain {loss_plain} (tol {TRAIN_LOSS_ATOL}), grad norm {gnorm} vs plain "
              f"{gnorm_plain} (rtol {TRAIN_GNORM_RTOL}); step ms "
              f"{[round(x * 1e3, 3) for x in step_s]}, median of steps 2-3 {ms:.3f} ms = "
              f"{b * s / ms * 1e3:.1f} tokens/s; launches in the 3 steps {json.dumps(launches)}",
              flush=True)
        train_step_profile(f"{label} {dict(zip(axes, shape))}", lambda: step(model, tokens))
        del model, opt, step
        torch.cuda.empty_cache()
    return total


def timed_steps(step, model, n=3):
    """``n`` calls of ``step()`` (each returns its loss) with the launch
    counts reset just before: (losses, each step's seconds, ``model``'s
    gradient norm after the first step, {kernel: launches})."""
    from tf_flash_attention_tpu_torch import native

    losses, step_s = [], []
    native.reset_launch_counts()
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            gnorm = grad_norm(model)
    return losses, step_s, gnorm, {k: v for k, v in native.LAUNCHES.items() if v}


def check_train(label, losses, gnorm, loss_plain, gnorm_plain):
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{label}: training losses {losses} are not finite and falling")
    if abs(losses[0] - loss_plain) > TRAIN_LOSS_ATOL:
        fail(f"{label}: first-step loss {losses[0]} vs plain path {loss_plain}: "
             f"> {TRAIN_LOSS_ATOL}")
    if abs(gnorm - gnorm_plain) > TRAIN_GNORM_RTOL * gnorm_plain:
        fail(f"{label}: first-step grad norm {gnorm} vs plain path {gnorm_plain}: "
             f"> {TRAIN_GNORM_RTOL} relative")


def moe_train_phase(mcfg, dev, tokens, seed):
    """Phase 6c: the 168M decoder with MOE_EXPERTS experts (fp32
    parameters, bf16 compute, the experts in float32) on phase 6's batch:
    3 AdamW steps, then 3 of make_sharded_train_step on (data 2, model 4),
    one expert a model shard, each from the same initial weights; the
    first step's loss (cross entropy plus the aux) and gradient norm
    within TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL of the plain path on the card
    and falling losses.  The tolerances hold through the routing: a route
    that bf16 rounding flips between the kernels and the plain path moves
    one token's MLP output, and its place in its expert's queue, by O(1);
    that token's loss moves by about 1e-2, the mean over 16,384 tokens by
    about 1e-6 a flipped route, so even a few hundred flips stay far under
    2e-3 (the printed loss differences are the check).  Returns {kernel:
    launches} of the 6 steps."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, n_experts=MOE_EXPERTS)
    init = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 21), device=dev)
    b, s = tokens.shape[0], tokens.shape[1] - 1
    model = copy.deepcopy(init)
    with plain_attention():
        loss = tf.loss_fn(cfg, model, tokens)
        loss.backward()
        loss_plain, gnorm_plain = float(loss.detach()), grad_norm(model)
    del model, loss
    total = {}
    for label, shape in (("6c moe train", None), ("6c moe train ep", (2, 4))):
        model = copy.deepcopy(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, capturable=True)   # phase 6's
        if shape is None:
            run = lambda: tf.train_step(cfg, model, tokens, optimizer=opt)
            blocks = cfg.n_layers
        else:
            mesh = make_mesh(shape, ("data", "model"), [dev] * math.prod(shape))
            # the eager step: phase 12 its graph
            run = lambda step=tf.make_sharded_train_step(cfg, mesh, opt).eager: step(model,
                                                                                    tokens)
            blocks = math.prod(shape) * cfg.n_layers
        losses, step_s, gnorm, launches = timed_steps(run, model)
        _add_launches(total, launches)
        check_train(label, losses, gnorm, loss_plain, gnorm_plain)
        if launches.get("banded_fwd") != 3 * blocks or launches.get("banded_bwd") != 3 * blocks:
            fail(f"{label}: {launches} launches, {3 * blocks} each of banded_fwd and "
                 f"banded_bwd expected")
        ms = statistics.median(step_s[1:]) * 1e3
        print(f"{label}{'' if shape is None else ' (data 2, model 4) on cuda:0 x 8'}: losses "
              f"{losses}; first step loss {losses[0]} vs plain {loss_plain} (diff "
              f"{abs(losses[0] - loss_plain)}, tol {TRAIN_LOSS_ATOL}), grad norm {gnorm} vs "
              f"plain {gnorm_plain} (rtol {TRAIN_GNORM_RTOL}); step ms "
              f"{[round(x * 1e3, 3) for x in step_s]}, median of steps 2-3 {ms:.3f} ms = "
              f"{b * s / ms * 1e3:.1f} tokens/s; launches in the 3 steps {json.dumps(launches)}",
              flush=True)
        train_step_profile(label[3:], run, phase="6c")
        del model, opt, run
        torch.cuda.empty_cache()
    print(f"phase 6c: {time.perf_counter() - t0:.3f} s; "
          f"{sum(p.numel() for p in init.parameters())} params", flush=True)
    del init
    torch.cuda.empty_cache()
    return total


PIPE_SHAPE = (2, 4)      # (data, pipe)
PIPE_MICROBATCHES = 4


def pipeline_phase(mcfg, cpu_model, dev, tokens, loss_plain, gnorm_plain):
    """Phase 6d: phase 6's dense model, weights and batch through
    make_pipeline_train_step on (data 2, pipe 4), 2 layers a stage, M = 4
    microbatches of one sequence: 3 AdamW steps, the first step's loss and
    gradient norm within TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL of phase 6's
    plain path (the same loss), falling losses, and in every step exactly
    n_layers x M x dp launches each of banded_fwd and banded_bwd (a stage
    runs only on its M live ticks).  Returns {kernel: launches} of the 3
    steps."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    dp, S = PIPE_SHAPE
    M = PIPE_MICROBATCHES
    b, s = tokens.shape[0], tokens.shape[1] - 1
    mesh = make_mesh(PIPE_SHAPE, ("data", pipeline.AXIS_PIPE), [dev] * (dp * S))
    staged = pipeline.stack_stage_params(mcfg, copy.deepcopy(cpu_model).to(dev), S)
    opt = torch.optim.AdamW(staged.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, capturable=True)   # phase 6's
    step = pipeline.make_pipeline_train_step(mcfg, mesh, opt, M)[0].eager   # 12: its graph
    per_step = mcfg.n_layers * M * dp
    counts = []

    def run():
        native.reset_launch_counts()
        loss = step(staged, tokens)
        counts.append((native.LAUNCHES["banded_fwd"], native.LAUNCHES["banded_bwd"]))
        return loss

    losses, step_s, gnorm, _ = timed_steps(run, staged)
    check_train("6d pipeline", losses, gnorm, loss_plain, gnorm_plain)
    if any(c != (per_step, per_step) for c in counts):
        fail(f"6d pipeline: banded_fwd/banded_bwd launches a step {counts}, {per_step} each "
             f"expected (n_layers x M x dp)")
    ms = statistics.median(step_s[1:]) * 1e3
    print(f"6d pipeline (data {dp}, pipe {S}) on cuda:0 x {dp * S}, {mcfg.n_layers // S} layers "
          f"a stage, M = {M} microbatches of {b // dp // M} x {s}: {M + S - 1} ticks; losses "
          f"{losses}; first step loss {losses[0]} vs phase 6's plain {loss_plain} (diff "
          f"{abs(losses[0] - loss_plain)}, tol {TRAIN_LOSS_ATOL}), grad norm {gnorm} vs plain "
          f"{gnorm_plain} (rtol {TRAIN_GNORM_RTOL}); banded_fwd/banded_bwd a step {counts}; "
          f"step ms {[round(x * 1e3, 3) for x in step_s]}, median of steps 2-3 {ms:.3f} ms = "
          f"{b * s / ms * 1e3:.1f} tokens/s ({ms / STEP_MS_BEFORE:.4f}x phase 6's "
          f"{STEP_MS_BEFORE} ms before)", flush=True)
    launches = {"banded_fwd": sum(c[0] for c in counts), "banded_bwd": sum(c[1] for c in counts)}
    train_step_profile("pipeline", lambda: step(staged, tokens), phase="6d")
    del staged, opt, step
    torch.cuda.empty_cache()
    print(f"phase 6d: {time.perf_counter() - t0:.3f} s", flush=True)
    return launches


def cpu_card_phase(mcfg, cpu_model, dev, seed):
    """Phase 7: one step at 1 x 512 tokens, plain versions on the CPU and
    kernels on the card; the losses must agree."""
    from tf_flash_attention_tpu_torch.models import transformer as tf

    tokens = torch.randint(0, mcfg.vocab, (1, 513), generator=torch.Generator().manual_seed(seed + 3))
    losses = {}
    for where in ("cpu", dev):
        model = copy.deepcopy(cpu_model).to(where)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
        losses[str(where)] = float(tf.train_step(mcfg, model, tokens.to(where), optimizer=opt))
        del model, opt
    a, b = losses["cpu"], losses[str(dev)]
    if not math.isfinite(b) or abs(a - b) > CPU_LOSS_ATOL:
        fail(f"CPU-vs-card training loss differs: {a} vs {b} (tol {CPU_LOSS_ATOL})")
    print(f"train CPU vs card: loss {a} vs {b}, diff {abs(a - b)} (tol {CPU_LOSS_ATOL})",
          flush=True)


# experiment kernels (phase 8): kernel and plain version round p and o at
# the same points and sum in other orders, so an output element parts by a
# rounding flip, one bf16 ulp of its own magnitude.  A bf16 ulp of x is at
# most 2**-7 |x|, so 2 * 2**-8 of the largest output magnitude is at least
# one ulp of any element (``ulps`` = 2).  No floor: the decode sites'
# outputs are ~0.005 (at most ~0.03), and a floor of 1 would let a limit
# exceed the values it compares.  bitcast rounds each half of o to bf16 and
# sums the halves in bf16, three roundings against the others' one: 3
def exp_tol(ref, ulps=2):
    return ulps * 2.0 ** -8 * float(ref.float().abs().max())


def bitcast_tol(ref):
    return exp_tol(ref, 3)


EXP_REPLACES = {
    "exp_resident_fwd": "tools/exp_resident.py:96",
    "exp_int4_int8ref": "tools/exp_int4_unpack.py:254",
    "exp_int4_s32": "tools/exp_int4_unpack.py:264",
    "exp_int4_twopage": "tools/exp_int4_unpack.py:274",
    "exp_int4_fourpage": "tools/exp_int4_unpack.py:284",
    "exp_int4_int8_2pg": "tools/exp_int4_unpack.py:294",
    "exp_int4_bitcast": "tools/exp_int4_unpack.py:314",
    "exp_vpu_ladder": "tools/exp_vpu_attrib.py:96",
    "exp_paged_decode": "tools/exp_decode.py:159",
    "exp_kv_unroll": "tools/exp_kv_unroll.py:115",
}


def experiment_phase(dev, seed):
    """Phase 8: the experiment tools' kernels at the tools' own shapes.  Every
    instantiation the tools run is driven once through its module's wrapper
    with the launch counts reset just before (the counts are read just
    after), then held against its plain version on the card and timed with
    its plain version, its bound and, for the forwards, one
    scaled_dot_product_attention call.  Returns ({kernel: entry}, {kernel:
    launches}); an entry's numbers are those of the tool's first variant,
    every variant's beside them under "variants"."""

    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.experiments import (exp_decode, exp_int4_unpack,
                                                          exp_kv_unroll, exp_resident,
                                                          exp_vpu_attrib)
    from tf_flash_attention_tpu_torch.serving import decode
    from tf_flash_attention_tpu_torch.serving.kv_cache import (KVCacheConfig, PageAllocator,
                                                               PagedKVCache, write_prompt)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    uni = lambda shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    bf = torch.bfloat16
    # (kernel, variant, fn, plain, n_bytes, n_ops, ops_type, library call or
    # None, tolerance, the int8mm arguments whose codes must match or None)
    runs = []

    # sites 1, 8, 10: the forwards, (8, 4096, 128) bf16
    B, S, D = 8, 4096, 128
    q, k, v = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    fwd_bytes = 4 * q.numel() * 2                                     # q, k, v in, o out
    # exp_resident is timed through the tool's entry (its prescale pass
    # included: the span of earlier runs) and, beside it, its kernel alone on
    # the prescaled q
    q_res = exp_resident._prescale(q, None)
    kernel_only = {}
    for bq, bkv in exp_resident.PAIRS:
        kernel_only["exp_resident_fwd", f"{bq}x{bkv}"] = (
            lambda bq=bq, bkv=bkv: native.exp_resident_fwd(q_res, k, v, bq, bkv))
        runs.append(("exp_resident_fwd", f"{bq}x{bkv}",
                     lambda bq=bq, bkv=bkv: exp_resident.resident_forward(
                         q, k, v, block_q=bq, block_kv=bkv),
                     lambda bq=bq, bkv=bkv: exp_resident.resident_forward_plain(
                         q, k, v, block_q=bq, block_kv=bkv),
                     fwd_bytes, 4 * B * D * S * (S + 1) // 2, "bf16",
                     lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                     exp_tol, None))
    qv = uni((B, S, D)).to(bf) * torch.tensor(1.0 / math.sqrt(D) * 1.4426950408889634,
                                             dtype=bf, device=dev)
    kv_, vv = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    blk = exp_vpu_attrib.BQ
    block_causal = (torch.arange(S, device=dev)[None, :] // blk
                    <= torch.arange(S, device=dev)[:, None] // blk)
    for rung in exp_vpu_attrib.RUNGS:
        runs.append(("exp_vpu_ladder", rung,
                     lambda rung=rung: exp_vpu_attrib.ladder(rung, qv, kv_, vv),
                     lambda rung=rung: exp_vpu_attrib.ladder_plain(rung, qv, kv_, vv),
                     fwd_bytes, 4 * B * blk * blk * D * exp_vpu_attrib.live_tiles(), "bf16",
                     (lambda: F.scaled_dot_product_attention(
                         qv.unsqueeze(0), kv_.unsqueeze(0), vv.unsqueeze(0),
                         attn_mask=block_causal, scale=1.0)) if rung == "prod" else None,
                     exp_tol, None))
    qu, kkv = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    for name, nkv, fused in exp_kv_unroll.VARIANTS:
        runs.append(("exp_kv_unroll", name,
                     lambda nkv=nkv, fused=fused: exp_kv_unroll.kv_unroll(
                         qu, kkv, kkv, nkv=nkv, fused=fused),
                     lambda nkv=nkv, fused=fused: exp_kv_unroll.kv_unroll_plain(
                         qu, kkv, kkv, nkv=nkv, fused=fused),
                     3 * qu.numel() * 2, 4 * B * S * S * D, "bf16",
                     lambda: F.scaled_dot_product_attention(qu.unsqueeze(0), kkv.unsqueeze(0),
                                                            kkv.unsqueeze(0)),
                     exp_tol, None))

    # sites 2-7: exp_int4_unpack at its shapes (the shared K/V read once)
    iq, (k4_, ks4, v4_, vs4, _, _, k8, ks8, v8, vs8) = exp_int4_unpack.build(gen, dev)
    rows = iq.numel() // D                                           # 1024 query rows
    ib, ctx = exp_int4_unpack.B, exp_int4_unpack.CTX
    # the library yardstick of each payload: one scaled_dot_product_attention
    # on the shared K/V dequantized to bf16 beforehand
    int4_lib = {8: int4_tool_library(iq, k8, ks8, v8, vs8),
                4: int4_tool_library(iq, k4_, ks4, v4_, vs4)}
    for name, kernel in exp_int4_unpack.KERNELS.items():
        bits = 8 if kernel.startswith("exp_int4_int8") else 4
        args = (iq, k8, ks8, v8, vs8) if bits == 8 else (iq, k4_, ks4, v4_, vs4)
        n_bytes = sum(t.numel() * t.element_size() for t in args) + iq.numel() * 2
        runs.append((kernel, name,
                     lambda kernel=kernel, args=args: exp_int4_unpack.int4_decode(kernel, *args),
                     lambda kernel=kernel, args=args: exp_int4_unpack.int4_decode_plain(
                         kernel, *args),
                     n_bytes, 4 * rows * ctx * D, "bf16", int4_lib[bits],
                     bitcast_tol if name == "bitcast" else exp_tol, None))

    # site 9: exp_decode's paged int8 cache, written by the port's cache code
    max_seqs, seq_len, n_kv, page = 16, 8192, 8, 512
    pps = seq_len // page
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=D, page_size=page,
                        n_pages=max_seqs * pps + 1, max_seqs=max_seqs, max_pages_per_seq=pps,
                        quantized=True)
    cache = PagedKVCache.create(cfg, dev)
    alloc = PageAllocator(cfg.n_pages - 1)
    for slot in range(max_seqs):
        write_prompt(cache, cfg, slot, alloc.alloc(slot, pps), uni((n_kv, seq_len, D)).to(bf),
                     uni((n_kv, seq_len, D)).to(bf))
    dq = uni((max_seqs, n_kv, D)).to(bf)
    live = int(cache.lengths.sum())
    page_major = (exp_decode.page_major(cache.k_scales), exp_decode.page_major(cache.v_scales))
    # the library yardstick: one scaled_dot_product_attention on every
    # slot's K/V dequantized to bf16 and gathered beforehand
    dec_lib, _ = decode_library(dq.unsqueeze(1), cache, cfg, cache.lengths.tolist())
    for variant in ("postscale_t", "int8mm_t", "current", "postscale", "int8mm"):
        scales = (cache.k_scales, cache.v_scales) if variant.endswith("_t") else page_major
        args = (variant, dq, cache.k_pages, cache.v_pages, *scales, cache.page_tables,
                cache.lengths)
        runs.append(("exp_paged_decode", variant,
                     lambda args=args: exp_decode.paged_decode(*args),
                     lambda args=args: exp_decode.paged_decode_plain(*args),
                     live * n_kv * (2 * D + 2 * 4) + 2 * dq.numel() * 2,
                     4 * dq.shape[1] * D * live, "int8" if "int8mm" in variant else "bf16",
                     dec_lib, exp_tol, args if variant.startswith("int8mm") else None))

    # the tools' entry points, each instantiation once, counted; every decode
    # site's report of the body it ran (the decode's tensor-core body, or the
    # phase fails), with its splits and CTAs
    native.reset_launch_counts()
    torch.cuda.synchronize()
    outs, dc_walks = [], {}
    for kernel, variant, fn, *_ in runs:
        outs.append(fn())
        if kernel in native.INT4_TC_UNPACK or kernel == "exp_paged_decode":
            dc_walks[kernel, variant] = dict(native.WALKS[kernel])
    torch.cuda.synchronize()
    launches = {kn: native.LAUNCHES[kn] for kn in native.EXPERIMENT_KERNELS}
    if min(launches.values()) < 1:
        fail(f"phase 8: an experiment kernel never launched: {launches}")
    for (kernel, variant), walk in dc_walks.items():
        if walk["body"] != "tensor-core":
            fail(f"phase 8: {kernel} {variant} ran the {walk['body']} body")

    entries, oracle = {}, None
    for (kernel, variant, fn, plain, n_bytes, n_ops, ops_type, lib, tol, codes), o in zip(runs,
                                                                                      outs):
        ref = plain()
        torch.cuda.synchronize()
        err, limit = float((o.float() - ref.float()).abs().max()), tol(ref)
        if not torch.isfinite(o).all() or o.shape != ref.shape or err > limit:
            fail(f"phase 8: {kernel} {variant} max error {err} > {limit}")
        extra = {"body": native.EXP_FWD_BODY[kernel]} if kernel in native.EXP_FWD_BODY else {}
        if kernel == "exp_resident_fwd":   # exact causal attention (the tool's own check)
            if oracle is None:
                oracle = exp_resident.causal_oracle(q, k, v).float()
            oracle_err = float((o.float() - oracle).abs().max())
            if oracle_err >= 1e-2:
                fail(f"phase 8: {kernel} {variant} differs from the dense causal oracle by "
                     f"{oracle_err}")
            extra["oracle_err"] = oracle_err
        if codes is not None:   # int8mm: q codes, integer scores and p codes bit for bit
            got = exp_decode.paged_decode(*codes, codes=True)
            want = exp_decode.paged_decode_plain(*codes, codes=True)
            for cname, a, b in zip(("q_codes", "scores", "p_codes"), got[1:], want[1:]):
                if not torch.equal(a, b):
                    fail(f"phase 8: {kernel} {variant} {cname} differ in {int((a != b).sum())} "
                         f"places")
            extra["codes_equal"] = True
        ms = time_ms(fn, n=10)
        if (kernel, variant) in dc_walks:   # its own device time, the body, splits and CTAs
            extra["kernel_ms"] = kernel_ms(fn, ("decode_tc_kernel",))
            extra.update(dc_walks[kernel, variant])
        if kernel in native.EXP_FWD_BODY:   # the variant's walk, as its launches report it
            walk = native.WALKS[kernel]
            if walk["body"] != extra["body"]:
                fail(f"phase 8: {kernel} {variant} ran the {walk['body']} body")
            extra.update(items=walk["items"], grid=walk["grid"])
        if (kernel, variant) in kernel_only:
            extra["kernel_ms"] = time_ms(kernel_only[kernel, variant], n=10)
        plain_ms = time_ms(plain, n=5)
        lib_ms = None if lib is None else time_ms(lib, n=10)
        b_ms, b_by = bound(n_bytes, n_ops, ops_type)
        r = dict(err=err, tol=limit, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms, **extra)
        if kernel in ("exp_resident_fwd", "exp_vpu_ladder", "exp_kv_unroll"):
            rate = f"{n_ops / ms / 1e9:.3f} useful TFLOP/s"
        elif kernel == "exp_paged_decode":
            rate = f"{max_seqs / ms * 1e3:,.0f} tok/s"
        else:   # exp_int4_unpack.py:335 counts the shared K/V once per row
            kvb = ib * ctx * exp_int4_unpack.N_KV * (D * (2.0 if "int8" in variant else 1.0) / 2
                                                      + 8)
            rate = (f"{kvb / ms / 1e6:.0f} GB/s as the tool counts (the shared K/V once per "
                    f"row: {ib}x the bytes of the bound)")
        body = "".join(f" {x}={extra[x]}" for x in ("body", "items", "grid", "splits", "ctas")
                       if x in extra)
        if "kernel_ms" in extra:
            body += (f" kernel_ms (prescaled q)={extra['kernel_ms']}"
                     if kernel == "exp_resident_fwd" else f" kernel_ms={extra['kernel_ms']}")
        print(f"kernel {kernel} {variant}:{body} max_abs_err={err} (tol {limit}) ms={ms} "
              f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) library_ms={lib_ms}; {rate}",
              flush=True)
        entry = entries.setdefault(kernel, dict(r, variants={}))
        entry["err"] = max(entry["err"], err)
        entry["variants"][variant] = r
    # the yardstick beside the int4 unpack tool's sites: paged_decode, the
    # serving decode's body and unpack, on the same K/V laid out as a
    # 16-slot cache whose slots share pages 0-31 (int4: s32's function;
    # int8: int8ref's, the card body's int8 control), timed as they are
    for label, ref_kernel, kv in (("int4", "exp_int4_s32", (k4_, ks4, v4_, vs4)),
                                  ("int8", "exp_int4_int8ref", (k8, ks8, v8, vs8))):
        ycache, ycfg = exp_int4_unpack.shared_cache(*kv, ib)
        yq = iq.reshape(ib, -1, D)
        yfn = lambda ycache=ycache, ycfg=ycfg: decode.paged_decode_attention(yq, ycache, ycfg)
        yo = yfn().reshape(iq.shape)
        ref = exp_int4_unpack.int4_decode_plain(ref_kernel, iq, *kv)
        torch.cuda.synchronize()
        err, limit = float((yo.float() - ref.float()).abs().max()), exp_tol(ref)
        if not torch.isfinite(yo).all() or err > limit:
            fail(f"phase 8: paged_decode on the tool's {label} pages: max error {err} > {limit}")
        yard = dict(err=err, tol=limit, ms=time_ms(yfn, n=10),
                    kernel_ms=kernel_ms(yfn, SERVING_KERNEL_NAMES["paged_decode"]),
                    body=native.WALKS["paged_decode"]["body"],
                    splits=native.WALKS["paged_decode"]["splits"],
                    ctas=native.WALKS["paged_decode"]["ctas"])
        print(f"yardstick paged_decode on the tool's {label} pages (16 slots sharing them): "
              f"{json.dumps(yard)}", flush=True)
        for kernel, entry in entries.items():
            if kernel.startswith("exp_int4") and ("int8" in kernel) == (label == "int8"):
                entry["yardstick"] = yard
                for r in entry["variants"].values():
                    r["yardstick"] = yard
    rungs = entries["exp_vpu_ladder"]["variants"]
    print(f"exp_vpu_ladder: prod - nomax (the first pass for each group's maximum) = "
          f"{rungs['prod']['ms'] - rungs['nomax']['ms']} ms", flush=True)
    resident_timer_check(q_res, k, v)
    print(f"phase 8: {time.perf_counter() - t0:.3f} s", flush=True)
    return entries, launches


def resident_timer_check(q_res, k, v):
    """One body, two merges and two timer windows at the tool's shape: the
    op path's resident_fwd and exp_resident_fwd at 128-row items and
    128-key merges (not a pair of the tool) on the same prescaled q, each
    timed in windows of 2 calls (phase 8's) and of 20 (uncounted)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops import forward
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    S, d = q_res.shape[1], q_res.shape[2]
    pack, rule = make_sync_pack("none_front", (S,), (S,)), CausalRule()
    with switches(RESIDENT):
        route = forward.forward_route(pack, rule, choose_block_config(d, d), d, d)
    if route.kernel != "resident_fwd":
        fail(f"phase 8: the resident route at the tool's shape is {route.kernel}")
    (seg,) = route.tables(pack, rule, q_res.device)
    rule_c = native.fa_rule(pack, rule)
    fns = {"resident_fwd": lambda: native.resident_fwd(q_res, k, v, rule_c, seg, 128, 128),
           "exp_resident_fwd 128x128": lambda: native.exp_resident_fwd(q_res, k, v, 128, 128)}
    out = {name: {f"ms_{n // 5}_call_windows": time_ms(fn, n=n) for n in (10, 100)}
           for name, fn in fns.items()}
    print(f"resident timer check (8, {S}, {d}) bf16 causal: {json.dumps(out)}", flush=True)


# ---- phase 10: the rest of the package ----

def record_schedules():
    """From here on, record every (pack, rule, block_q, block_kv) the port's
    schedule builder classifies (its ``_classes``, behind its cache), for
    phase 10(b).  Returns the dict that fills."""
    from tf_flash_attention_tpu_torch import schedule

    built, classes = {}, schedule._classes

    def recording(pack, rule, block_q, block_kv, use_native):
        built.setdefault((pack, rule, block_q, block_kv), None)
        return classes(pack, rule, block_q, block_kv, use_native)

    schedule._classes = recording
    return built


def checkpoint_phase(mcfg, cpu_model, dev, tokens):
    """Phase 10(a): 2 AdamW steps of the 168M decoder on phase 6's batch,
    save_checkpoint, restore_checkpoint through ``target`` into a fresh
    model and optimizer: every restored tensor bit-equal, then steps 3 and
    4 of both runs within TRAIN_LOSS_ATOL."""
    import tempfile

    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                                               save_checkpoint)

    def adamw(model):
        return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)   # phase 6's

    def tensors(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in tensors(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    model = copy.deepcopy(cpu_model).to(dev)
    opt = adamw(model)
    losses = [float(tf.train_step(mcfg, model, tokens, optimizer=opt)) for _ in range(2)]
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, 2, {"params": model.state_dict(),
                                         "opt_state": opt.state_dict(), "step": 2})
        save_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        fresh = tf.init_params(mcfg, torch.Generator(device=dev).manual_seed(99), dev)
        fresh_opt = adamw(fresh)
        # AdamW makes its state at its first step: one on zero gradients
        # gives the target every moment and step leaf, as AdamW places them
        for p in fresh.parameters():
            p.grad = torch.zeros_like(p)
        fresh_opt.step()
        fresh_opt.zero_grad(set_to_none=True)
        target = {"params": fresh.state_dict(), "opt_state": fresh_opt.state_dict(), "step": 0}
        t0 = time.perf_counter()
        state = restore_checkpoint(ckpt, target=target)
        torch.cuda.synchronize()
        placed_s = time.perf_counter() - t0
        misplaced = sum(not (a.device == b.device and a.dtype == b.dtype)
                        for a, b in zip(tensors(state), tensors(target), strict=True))
        if misplaced:
            fail(f"checkpoint: {misplaced} restored tensors not on their target leaf's device "
                 f"and dtype")
        t0 = time.perf_counter()
        fresh.load_state_dict(state["params"])
        fresh_opt.load_state_dict(state["opt_state"])
        torch.cuda.synchronize()
        restore_s = placed_s + time.perf_counter() - t0
        if latest_step(ckpt) != 2 or state["step"] != 2:
            fail(f"checkpoint: latest step {latest_step(ckpt)}, restored step {state['step']}")
    pairs = list(zip(tensors(fresh.state_dict()) + tensors(fresh_opt.state_dict()["state"]),
                     tensors(model.state_dict()) + tensors(opt.state_dict()["state"])))
    unequal = sum(not (a.dtype == b.dtype and a.device == b.device and torch.equal(a, b))
                  for a, b in pairs)
    if unequal or len(pairs) != len(list(model.parameters())) * 4:
        fail(f"checkpoint: {unequal} of {len(pairs)} restored tensors differ from the saved ones")
    after = [[float(tf.train_step(mcfg, m, tokens, optimizer=o)) for _ in range(2)]
             for m, o in ((model, opt), (fresh, fresh_opt))]
    diffs = [abs(a - b) for a, b in zip(*after)]
    if not all(map(math.isfinite, losses + after[0] + after[1])) or max(diffs) > TRAIN_LOSS_ATOL:
        fail(f"checkpoint: steps 3-4 unbroken {after[0]} vs restored {after[1]}: "
             f"> {TRAIN_LOSS_ATOL}")
    print(f"checkpoint: 168M decoder + AdamW, {n_bytes} bytes, save {save_s:.3f} s, restore "
          f"(restore_checkpoint + load_state_dict, onto the card) {restore_s:.3f} s; "
          f"{len(pairs)} tensors restored bit-equal, each placed by target; losses steps 1-2 {losses}, steps 3-4 "
          f"unbroken {after[0]} restored {after[1]}: |diff| {diffs} (tol {TRAIN_LOSS_ATOL})",
          flush=True)
    del model, opt, fresh, fresh_opt, state, target
    torch.cuda.empty_cache()


def classifier_phase(built):
    """Phase 10(b): the C++ tile classifier against the NumPy spec on every
    schedule recorded since phase 1, each timed on the host (median of 5)."""
    from tf_flash_attention_tpu_torch import native, schedule

    def host_ms(fn, n=5):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times) * 1e3

    if not built:
        fail("classifier: the run built no schedule")
    totals, n_custom = [0.0, 0.0], 0
    for (pack, rule, bq, bk) in built:
        want, numpy_ms = host_ms(lambda: schedule._tile_classes_python(pack, rule, bq, bk))
        got, cxx_ms = host_ms(lambda: native.native_tile_classes(pack, rule, bq, bk))
        label = (f"{type(rule).__name__}{getattr(rule, 'window_size', '')} "
                 f"q{tuple(pack.q.shape)} k{tuple(pack.k.shape)} {bq}x{bk}")
        if got is None:
            # a custom rule has no C++ kind: build_schedule takes the spec
            if type(rule).__name__ in ("FullRule", "CausalRule", "LocalRule"):
                fail(f"classifier {label}: the C++ classifier declined a built-in rule")
            n_custom += 1
            print(f"classifier {label}: custom rule, NumPy spec {numpy_ms:.4f} ms", flush=True)
            continue
        if not all((g == w).all() for g, w in zip(got, want)):
            fail(f"classifier {label}: the C++ tile classes differ from the NumPy spec")
        totals[0] += cxx_ms
        totals[1] += numpy_ms
        print(f"classifier {label}: equal; C++ {cxx_ms:.4f} ms, NumPy {numpy_ms:.4f} ms "
              f"({numpy_ms / cxx_ms:.1f}x)", flush=True)
    print(f"classifier: {len(built)} schedules ({n_custom} custom), the C++ classes equal the "
          f"NumPy spec's on all the others; host ms summed C++ {totals[0]:.3f}, NumPy "
          f"{totals[1]:.3f}", flush=True)


def graft_phase(dev):
    """Phase 10(c): graft_entry.entry()'s forward on the card against the
    CPU's within LOGIT_ATOL, on entry()'s zero tokens and on seeded random
    ones (zero tokens give every position the same input, so attention
    returns v whatever it masks), then dryrun_multichip(8) over 8 shards of
    the card."""
    from tf_flash_attention_tpu_torch import graft_entry

    t0 = time.perf_counter()
    fn, (params, tokens) = graft_entry.entry()
    cpu_params = copy.deepcopy(params).cpu()
    random_tokens = torch.randint(0, params.cfg.vocab, tuple(tokens.shape),
                                  generator=torch.Generator().manual_seed(10))
    errs = []
    for name, toks in (("zero", tokens.cpu()), ("random", random_tokens)):
        with torch.no_grad():
            card = fn(params, toks.to(tokens.device)).cpu()
            cpu = fn(cpu_params, toks)
        errs.append(float((card - cpu).abs().max()))
        if card.shape != (2, 256, 1024) or not torch.isfinite(card).all() or errs[-1] > LOGIT_ATOL:
            fail(f"graft entry, {name} tokens: card logits {tuple(card.shape)}, CPU-vs-card "
                 f"{errs[-1]} > {LOGIT_ATOL}")
    print(f"graft entry: forward {tuple(card.shape)} {card.dtype}, CPU vs card max_abs_err "
          f"{errs[0]} on entry()'s zero tokens, {errs[1]} on seeded random tokens "
          f"(tol {LOGIT_ATOL}), {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    try:
        graft_entry.dryrun_multichip(8)
    except (AssertionError, ValueError, RuntimeError) as e:
        fail(f"graft entry: dryrun_multichip(8) failed: {e!r}")
    print(f"graft entry: dryrun_multichip(8) over 8 shards of cuda:0 in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def examples_phase():
    """Phase 10(d): the four examples (examples/torch_*.py) on the card, with
    their JAX counterparts' invariants and their wall seconds."""
    import importlib.util

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")

    def run(name):
        spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                      os.path.join(root, f"torch_{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = module.main()
        except (AssertionError, ValueError, RuntimeError) as e:
            fail(f"example torch_{name}.py failed: {e!r}")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    seconds = {}
    out, seconds["basic_usage"] = run("basic_usage")
    if (out["local_1d"], out["local_2d"], out["grad"], out["mha"]) != (
            (8, 16, 1024), (2, 4, 16, 32, 32), (8, 32, 1024), (2, 8, 1024, 128)):
        fail(f"example basic_usage: shapes {out}")
    out, seconds["serving_demo"] = run("serving_demo")
    if out["prefix_hits"] < 1 or len(out["results"]) != 5 or any(
            len(t) < 12 for t in out["results"].values()):
        fail(f"example serving_demo: {out}")
    out, seconds["sliding_window_serving"] = run("sliding_window_serving")
    s = out["stats"]
    if len(out["tokens"]) != 700 or not s["pages_evicted"] or \
            s["pages_in_use_peak"] > out["pages_cap"] * 2:
        fail(f"example sliding_window_serving: {s}")
    out, seconds["train_demo"] = run("train_demo")
    if out["mesh"] != {"data": 2, "model": 4} or not all(map(math.isfinite, out["losses"])):
        fail(f"example train_demo: {out}")
    print(f"examples on the card: wall seconds {json.dumps(seconds)}", flush=True)


# ---- phase 2(r) and phase 11: the engine's compiled steps ----

def meta_replay_case(dev, gen):
    """Phase 2(r): one chunk write and one prefill captured together as a
    CUDA graph (the engine's ``serving.graphs.GraphedStep``) with their
    (slot, start, true_len) in an int32 device vector, as the engine's
    chunk step takes them, run at three triples: the first call eager (then
    the capture), the next two replays.  Each against the plain versions at
    its own triple: the writes bit for bit with the lengths, the prefill
    within attn_tol.  A replay runs the captured launches as they are, so
    right answers at other triples show that the kernels read their
    scalars on the device.  Phase 2's int8 case (16 slots, page 256, chunk
    512, 8 q / 8 kv heads, d 128)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import kv_cache, prefill
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedStep

    S, chunk, n_q, n_kv, d, ps = 16, 512, 8, 8, 128, 256
    mapped = 2048 // ps
    cfg = payload_cfg("int8", n_kv_heads=n_kv, head_dim=d, page_size=ps,
                      n_pages=S * mapped + S + 1, max_seqs=S, max_pages_per_seq=2 * mapped)
    trash, rule, bf = cfg.n_pages - 1, CausalRule(), torch.bfloat16
    cache = make_cache(cfg, dev, gen, torch.randint(1, 2048, (S,), generator=gen,
                                                    device=dev).tolist(), mapped)
    plain = clone_cache(cache)
    k = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    v = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    q = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
    qs = (q.float() * torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)).to(bf)
    meta = torch.zeros(3, dtype=torch.int32, device=dev)

    def chunk_step(meta):
        slot, start, true_len = meta[0], meta[1], meta[2]
        kv_cache.write_tokens_meta(
            cache, cfg, kv_cache.chunk_write_meta(slot, start, true_len, trash, 1, dev)[0], k, v)
        return (prefill.prefill_with_meta(
            q, cache, cfg, prefill.prefill_meta(cfg, slot, start, true_len, rule, 1, dev)[0],
            rule=rule),)

    step = GraphedStep(chunk_step, 1, (torch.cuda.Stream(dev),), torch.cuda.graph_pool_handle())
    errs = []
    for slot, start, true_len in ((0, 1100, 451), (5, 512, 512), (9, 256, 77)):
        meta.copy_(torch.tensor([slot, start, true_len], dtype=torch.int32))
        o, = step(meta)
        kv_cache._write_tokens_plain(plain, cfg, kv_cache.chunk_write_meta(
            slot, start, true_len, trash, 1, dev)[0], k, v)
        ref = prefill._paged_prefill_plain(qs, plain, cfg, prefill.prefill_meta(
            cfg, slot, start, true_len, rule, 1, dev)[0], rule)[:true_len]
        torch.cuda.synchronize()
        diffs = diff_outside_trash(cache, plain, trash)
        if diffs or not torch.equal(cache.lengths, plain.lengths):
            fail(f"2(r): the graphed chunk write at {(slot, start, true_len)} differs from its "
                 f"plain version: {diffs}")
        errs.append(float((o[:true_len].float() - ref.float()).abs().max()))
        if not torch.isfinite(o[:true_len]).all() or errs[-1] > attn_tol(ref):
            fail(f"2(r): the graphed prefill at {(slot, start, true_len)}: max error "
                 f"{errs[-1]} > {attn_tol(ref)}")
    g = next(iter(step.graphs.values()))
    if len(step.graphs) != 1 or g.replays != 2 or set(g.launches) != {"kv_chunk_write",
                                                                        "paged_prefill"}:
        fail(f"2(r): expected one graph of the two kernels replayed twice: {len(step.graphs)} "
             f"graphs, {g.replays} replays, launches {g.launches}")
    print(f"phase 2(r): a chunk write and a prefill in one CUDA graph, at (0, 1100, 451) "
          f"eager then captured, replayed at (5, 512, 512) and (9, 256, 77): writes and lengths "
          f"bit-equal to the plain versions at each; prefill max_abs_err {errs}; the graph's "
          f"nodes {json.dumps(g.nodes)}, wrapper launches captured {json.dumps(g.launches)}, "
          f"pool {g.pool_bytes} bytes; LAUNCHES {native.LAUNCHES['kv_chunk_write']} + "
          f"{native.LAUNCHES['paged_prefill']}, REPLAYED "
          f"{native.REPLAYED['kv_chunk_write']} + {native.REPLAYED['paged_prefill']}",
          flush=True)


def set_eager(eng):
    """Set ``eng``'s compiled steps back to their impls: the eager engine."""
    for name in ("_decode_step", "_spec_step", "_chunk_prefill"):
        setattr(eng, name, getattr(eng, name + "_impl"))
    eng._bucket_prefill, eng._sample1 = eng._prefill_impl, eng._sample1_impl
    return eng


def compiled_run(label, make, reqs, n_new, vocab, graphed, inspect=None):
    """One run of phase 11: a fresh engine from ``make()``, eager or
    graphed, first serving one warm-up request (``reqs[0]``'s first 600
    tokens, 4 new: it captures a graphed engine's graphs, and its figures
    are left out), then ``reqs`` (``serve``).  Returns every token and the
    run's figures: prefill and decode tokens/s (wall clock), the median
    wall ms of an engine step (``step()``: its host loop and the decode or
    speculative step, which ends in a sync, reading its tokens; the
    admissions are the outliers the median leaves out) and of a prefill
    chunk (the prefill's wall over its chunks), the host's ms inside a step
    and a chunk call (medians: the enqueue, no sync), the calls'
    CUDA-event spans (medians: a graph's replay, its kernels back to back),
    and for a graphed engine its graphs (nodes, wrapper launches, pool
    bytes, replays); ``inspect(eng)``, where given, runs after the requests
    and its result is the figures' ``inspect``."""
    eng = make()
    if not graphed:
        set_eager(eng)
    serve(f"{label} warm-up", eng, [(reqs[0][0][:600], None)], 4, vocab)
    step = "_spec_step" if eng.ecfg.speculative_tokens else "_decode_step"
    report_of = {k: getattr(eng, k) for k in ("_decode_step", "_spec_step", "_chunk_prefill")}
    host, events = timed_step_calls(eng, step)
    chunk_host, chunk_events = timed_step_calls(eng, "_chunk_prefill")
    stats0 = dict(eng.stats)
    walls, inner_step = [], eng.step

    def timed_step():
        t = time.perf_counter()
        out = inner_step()
        walls.append(time.perf_counter() - t)
        return out

    eng.step = timed_step
    results, launches = serve(f"{label} {'graphed' if graphed else 'eager'}", eng, reqs, n_new,
                              vocab)
    graphs = {}
    for name, fn in report_of.items():
        for g in getattr(fn, "graphs", {}).values():
            graphs[name] = {"nodes": g.nodes, "wrapper_launches": sum(g.launches.values()),
                            "pool_bytes": g.pool_bytes, "replays": g.replays}
    span = lambda ev: statistics.median(a.elapsed_time(b) for a, b in ev)
    prefill_s = (eng.stats["prefill_tokens"] - stats0["prefill_tokens"]) / eng.rates[0]
    fig = dict(prefill_tps=eng.rates[0], decode_tps=eng.rates[1],
               step_ms=statistics.median(walls) * 1e3,
               host_ms=statistics.median(host) * 1e3, span_ms=span(events),
               chunk_ms=prefill_s / (eng.stats["prefill_chunks"] - stats0["prefill_chunks"]) * 1e3,
               chunk_host_ms=statistics.median(chunk_host) * 1e3, chunk_span_ms=span(chunk_events),
               graphs=graphs)
    if inspect is not None:
        fig["inspect"] = inspect(eng)
    tokens = [results[r] for r in sorted(results)]
    del eng, report_of, inner_step
    gc.collect()             # the wrappers above hold the engine in cycles
    torch.cuda.empty_cache()
    return tokens, fig, launches


def compiled_phase(mcfg, cpu_model, ecfg, prompts, pattern, seed, dev):
    """Phase 11: each engine layout run eager (its compiled steps set back
    to their ``_*_impl`` methods) and graphed (``DecodeEngine._compile``'s
    CUDA graphs) on the same requests, in three alternating pairs (eager,
    graphed, graphed, eager, eager, graphed).  Gate: every run's tokens
    equal in full (the same kernels run in the same order, so a replay must
    not change a bit).  Prints each run's figures (``compiled_run``) and a
    layout's summary: the medians of each figure over its three eager and
    three graphed runs, the busy share of a step and of a chunk (the
    graphed replay's event span, which is the device work run back to back,
    over each kind's median wall ms), the graphs and their kernels.  Layouts: flat
    int8 (phase 3's 18 requests), speculative (3b's 22, two sampled), cp = 4
    (4 of 3e(b)'s 8 requests: 4,000-9,000 tokens), tp = 4 (8 of phase 3's),
    the window engine (8 of 3f(b)'s, 64 new tokens each) and the MoE engine
    (8 of phase 3's); 32 new tokens where not said."""
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    t0 = time.perf_counter()
    pgen = torch.Generator().manual_seed(seed + 31)
    tok = lambda n: torch.randint(1, mcfg.vocab, (n,), generator=pgen).tolist()
    sampled = SamplingParams(temperature=0.8, top_k=50)
    spec_reqs = ([(p, None) for p in prompts] + [(pattern * 8, None), (pattern * 12, None)]
                 + [(tok(700), sampled), (tok(1200), sampled)])
    cp_cfg = EngineConfig(max_seqs=8, page_size=256, n_pages=129, max_pages_per_seq=16,
                          quantized_kv=True, prefill_chunk=512, prefix_caching=False)
    wcfg = dataclasses.replace(mcfg, rule=LocalRule(window_size=1024, is_causal=True))
    w_ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=161, max_pages_per_seq=10,
                          quantized_kv=True, prefill_chunk=512)
    moe_cfg = dataclasses.replace(mcfg, n_experts=MOE_EXPERTS)
    moe_model = tf.init_params(moe_cfg, torch.Generator(device=dev).manual_seed(seed + 24),
                               device=dev)
    seq4 = make_mesh((N_SHARDS,), ("seq",), [dev] * N_SHARDS)
    model4 = make_mesh((TP,), ("model",), [dev] * TP)
    layouts = [
        ("flat", lambda: DecodeEngine(mcfg, cpu_model, ecfg, device=dev),
         [(p, None) for p in prompts], 32),
        ("speculative", lambda: DecodeEngine(
            mcfg, cpu_model, dataclasses.replace(ecfg, speculative_tokens=3), device=dev),
         spec_reqs, 32),
        ("cp = 4", lambda: DecodeEngine(mcfg, cpu_model, cp_cfg, mesh=seq4),
         [(tok(n), None) for n in (4000, 5500, 7000, 9000)], 32),
        ("tp = 4", lambda: DecodeEngine(mcfg, cpu_model, ecfg, mesh=model4),
         [(p, None) for p in prompts[:8]], 32),
        ("window", lambda: DecodeEngine(wcfg, cpu_model, w_ecfg, device=dev),
         [(tok(n), None) for n in (1000, 1800, 2600, 3400, 4200, 5000, 5800, 6000)], 64),
        ("moe", lambda: DecodeEngine(moe_cfg, moe_model, ecfg, device=dev),
         [(p, None) for p in prompts[:8]], 32),
    ]
    summary = {}
    for label, make, reqs, n_new in layouts:
        runs = {False: [], True: []}
        want = None
        for graphed in (False, True, True, False, False, True):
            tokens, fig, _ = compiled_run(f"11 {label}", make, reqs, n_new, mcfg.vocab, graphed)
            if want is None:
                want = tokens
            elif tokens != want:
                diff = sum(a != b for a, b in zip(tokens, want))
                fail(f"11 {label}: the {'graphed' if graphed else 'eager'} engine's tokens "
                     f"differ from the first run's in {diff} of {len(want)} requests")
            if graphed and not fig["graphs"]:
                fail(f"11 {label}: the graphed engine captured no graph")
            runs[graphed].append(fig)
            print(f"11 {label} {'graphed' if graphed else 'eager'}: {json.dumps(fig)}",
                  flush=True)
        med = {kind: {k: statistics.median(f[k] for f in runs[g])
                      for k in ("prefill_tps", "decode_tps", "step_ms", "host_ms", "span_ms",
                                "chunk_ms", "chunk_host_ms", "chunk_span_ms")}
               for kind, g in (("eager", False), ("graphed", True))}
        for kind in med:
            med[kind]["busy_share"] = med["graphed"]["span_ms"] / med[kind]["step_ms"]
            med[kind]["chunk_busy_share"] = (med["graphed"]["chunk_span_ms"]
                                             / med[kind]["chunk_ms"])
        summary[label] = dict(med, graphs=runs[True][-1]["graphs"],
                              decode_speedup=med["graphed"]["decode_tps"]
                              / med["eager"]["decode_tps"],
                              prefill_speedup=med["graphed"]["prefill_tps"]
                              / med["eager"]["prefill_tps"])
        print(f"11 {label}: tokens equal in all 6 runs ({len(want)} requests); medians "
              f"{json.dumps(summary[label])}", flush=True)
    del moe_model
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t0:.3f} s", flush=True)
    return summary


# ---- phase 12: the rest of jax.jit: the training steps, the parallel
# attention callables and the bucketed prefill as CUDA graphs ----

def graph_report(g):
    """A captured graph's figures: its nodes, the wrappers' launches into it
    by kernel, the bytes its capture reserved and its replays so far."""
    return {"nodes": g.nodes, "launches": g.launches, "pool_bytes": g.pool_bytes,
            "replays": g.replays}


def count_compiled(total, launches=None):
    """Add this run's wrapper launches and graph replays (native.LAUNCHES and
    native.REPLAYED) of the op kernels to ``total`` ({kernel: {"launches",
    "replayed"}})."""
    from tf_flash_attention_tpu_torch import native

    for k in native.ATTENTION_KERNELS:
        n, r = native.LAUNCHES[k], native.REPLAYED[k]
        if n or r:
            t = total.setdefault(k, {"launches": 0, "replayed": 0})
            t["launches"] += n
            t["replayed"] += r
    return total


def timed_train_calls(fn, params, tokens, n=3):
    """``n`` calls of ``fn(params, tokens)`` (each returns its loss), each
    timed by the host clock to a sync (wall), by the host clock around the
    call alone (the enqueue) and by CUDA events around it (on a replay: the
    graph's kernels back to back).  Returns (losses, wall s, host s, event
    ms, the gradient norm after the first call)."""
    losses, walls, hosts, spans = [], [], [], []
    for i in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        loss = fn(params, tokens)
        hosts.append(time.perf_counter() - t0)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(a.elapsed_time(b))
        losses.append(float(loss))
        if i == 0:
            gnorm = grad_norm(params)
    return losses, walls, hosts, spans, gnorm


def compiled_train_phase(mcfg, cpu_model, dev, tokens, seed):
    """Phase 12(a): each training-step factory on phase 6's batch, from the
    same initial weights (a deepcopy each run), 3 AdamW (capturable) steps
    of its eager step (``step.eager``) and 3 of its CUDA graph (the first
    call eager, then the capture; then two replays): a 1-device mesh, (data
    2, model 4), (data 2, model 2, context 2), the MoE decoder (phase 6c's
    weights) on (data 2, model 4) and the GPipe step on (data 2, pipe 4), M
    = 4.  Gate: every graphed loss within TRAIN_LOSS_ATOL of the eager
    run's at the same step, the first gradient norm within
    TRAIN_GNORM_RTOL, one graph replayed twice.  Prints each run's figures
    and the graph's; the busy share is the graphed replay's event span over
    each kind's median wall (steps 2-3).  Returns ({kernel: {"launches",
    "replayed"}} of the graphed runs, the 1-device mesh's graphed figures:
    phase 14(b)'s reference, {layout: {"eager", "graphed"}: its figures}:
    phase 15(d)'s one-card yardstick)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel import make_mesh
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedTrainStep

    t0 = time.perf_counter()
    b, s = tokens.shape[0], tokens.shape[1] - 1
    dense = copy.deepcopy(cpu_model).to(dev)
    moe_cfg = dataclasses.replace(mcfg, n_experts=MOE_EXPERTS)
    moe = tf.init_params(moe_cfg, torch.Generator(device=dev).manual_seed(seed + 21),
                         device=dev)                                  # phase 6c's

    def adamw(params):   # phase 6's, capturable
        return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4, capturable=True)

    def mesh(shape, axes):
        return make_mesh(shape, axes, [dev] * math.prod(shape))

    def sharded(cfg, init, shape, axes):
        def make():
            model = copy.deepcopy(init)
            return model, tf.make_sharded_train_step(cfg, mesh(shape, axes),
                                                     adamw(model.parameters()))
        return make

    def piped():
        staged = pipeline.stack_stage_params(mcfg, copy.deepcopy(dense), PIPE_SHAPE[1])
        step, _ = pipeline.make_pipeline_train_step(
            mcfg, mesh(PIPE_SHAPE, ("data", pipeline.AXIS_PIPE)), adamw(staged.parameters()),
            PIPE_MICROBATCHES)
        return staged, step

    layouts = [
        ("1-device mesh", sharded(mcfg, dense, (1, 1), ("data", "model"))),
        ("(data 2, model 4)", sharded(mcfg, dense, (2, 4), ("data", "model"))),
        ("(data 2, model 2, context 2)", sharded(dataclasses.replace(mcfg, context_parallel=True),
                                                 dense, (2, 2, 2), RING_AXES)),
        ("moe (data 2, model 4)", sharded(moe_cfg, moe, (2, 4), ("data", "model"))),
        (f"gpipe (data 2, pipe 4), M {PIPE_MICROBATCHES}", piped),
    ]
    total, figures = {}, {}
    for label, make in layouts:
        runs = figures[label] = {}
        for graphed in (False, True):
            model, step = make()
            if not isinstance(step, GraphedTrainStep):
                fail(f"12(a) {label}: the factory returned {type(step).__name__} on one card, "
                     f"not a GraphedTrainStep")
            native.reset_launch_counts()
            losses, walls, hosts, spans, gnorm = timed_train_calls(
                step if graphed else step.eager, model, tokens)
            fig = {"losses": losses, "gnorm": gnorm,
                   "step_ms": [round(w * 1e3, 3) for w in walls],
                   "median_ms": statistics.median(walls[1:]) * 1e3,
                   "host_ms": statistics.median(hosts[1:]) * 1e3,
                   "span_ms": statistics.median(spans[1:])}
            if graphed:
                if len(step.graphs) != 1:
                    fail(f"12(a) {label}: {len(step.graphs)} graphs, one expected")
                g = next(iter(step.graphs.values()))
                if g.replays != 2 or not g.launches.get("banded_fwd") and not g.launches.get(
                        "flash_fwd"):
                    fail(f"12(a) {label}: the graph replayed {g.replays} times (2 expected), "
                         f"holding {g.launches}")
                fig["graph"] = graph_report(g)
                count_compiled(total)
            runs[graphed] = fig
            del model, step
            gc.collect()
            torch.cuda.empty_cache()
        eager, graphed = runs[False], runs[True]
        if label == "1-device mesh":
            one_device = graphed          # phase 14(b)'s reference
        for i, (a, ref) in enumerate(zip(graphed["losses"], eager["losses"])):
            if not math.isfinite(a) or abs(a - ref) > TRAIN_LOSS_ATOL:
                fail(f"12(a) {label}: graphed step {i + 1}'s loss {a} vs eager {ref}: > "
                     f"{TRAIN_LOSS_ATOL}")
        if abs(graphed["gnorm"] - eager["gnorm"]) > TRAIN_GNORM_RTOL * eager["gnorm"]:
            fail(f"12(a) {label}: graphed first-step grad norm {graphed['gnorm']} vs eager "
                 f"{eager['gnorm']}: > {TRAIN_GNORM_RTOL} relative")
        for fig in runs.values():
            fig["busy_share"] = graphed["span_ms"] / fig["median_ms"]
            fig["tokens_per_s"] = b * s / fig["median_ms"] * 1e3
        print(f"12(a) train step {label} on cuda:0: eager {json.dumps(eager)}; graphed "
              f"{json.dumps(graphed)}; loss diffs "
              f"{[abs(a - r) for a, r in zip(graphed['losses'], eager['losses'])]} (tol "
              f"{TRAIN_LOSS_ATOL}); graphed {eager['median_ms'] / graphed['median_ms']:.3f}x "
              f"eager (median step ms)", flush=True)
    del dense, moe
    torch.cuda.empty_cache()
    print(f"phase 12(a): {time.perf_counter() - t0:.3f} s", flush=True)
    return total, one_device, figures


def compiled_callables_phase(dev, seed, total):
    """Phase 12(b): ring_flash_attention and ulysses_flash_attention on a
    context axis of 4 and sharded_flash_attention on a model axis of 4
    (each cuda:0 four times, causal), at 6b(a)'s RING_SHAPE bf16 inputs:
    forward + backward through the eager function (``.eager``), then the
    graphed callable twice (the first call eager, then its captures; the
    second replays the forward and the backward graph).  Gate: the replay's
    output and dQ/dK/dV within attn_tol of the eager call's.  Prints both
    forward + backward ms (CUDA events) and the graphs; adds the graphed
    runs' launches to ``total``."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.parallel import (make_mesh, ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedFunction

    t0 = time.perf_counter()
    bf, n = torch.bfloat16, 4
    ctx = make_mesh((1, 1, n), RING_AXES, [dev] * n)
    heads = make_mesh((1, n), ("data", "model"), [dev] * n)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)           # 6b(a)'s inputs
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=dev).to(bf) for _ in range(4))
    cases = [("ring causal, context 4", ring_flash_attention(ctx, rule=CausalRule())),
             ("ulysses causal, context 4", ulysses_flash_attention(ctx, CausalRule())),
             ("sharded causal, model 4", sharded_flash_attention(heads, CausalRule()))]

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do)]

    for label, fn in cases:
        if not isinstance(fn, GraphedFunction):
            fail(f"12(b) {label}: the callable is {type(fn).__name__} on one card, not a "
                 f"GraphedFunction")
        want = run(fn.eager)
        native.reset_launch_counts()
        run(fn)
        got = run(fn)
        torch.cuda.synchronize()
        count_compiled(total)
        errs = {}
        for name, a, ref in zip(("o", "dq", "dk", "dv"), got, want):
            errs[name] = float((a.float() - ref.float()).abs().max())
            if not torch.isfinite(a.float()).all() or errs[name] > attn_tol(ref):
                fail(f"12(b) {label}: the replay's {name} differs from the eager call's by "
                     f"{errs[name]} > {attn_tol(ref)}")
        del got, want
        eager_ms = time_ms(lambda: run(fn.eager), n=10)
        graphed_ms = time_ms(lambda: run(fn), n=10)
        sig = next(iter(fn.graphs.values()))
        print(f"12(b) {label} {RING_SHAPE} bf16 on cuda:0: replay vs eager max_abs_err "
              f"{json.dumps(errs)} (attn_tol); forward + backward eager {eager_ms:.4f} ms, "
              f"graphed {graphed_ms:.4f} ms ({eager_ms / graphed_ms:.3f}x); forward graph "
              f"{json.dumps(graph_report(sig.fwd))}, backward graph "
              f"{json.dumps(graph_report(sig.bwd))}", flush=True)
        del fn, sig
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 12(b): {time.perf_counter() - t0:.3f} s", flush=True)
    return total


def compiled_bucketed_phase(mcfg, cpu_model, ecfg, prompts, chunked_logits, seed, dev):
    """Phase 12(c): phase 3g's bucketed engine (buckets 512 and 2,048) eager
    (``set_eager``) and graphed (a graph a bucket, and the first-token
    sampler's graph drawing from the engine's generator), each first
    serving two warm-up requests (300 tokens sampled, 1,000 greedy, 4 new
    tokens: a graphed engine captures its three graphs there, so the rates
    are the steady state's), then phase 3's 18 requests and 2 sampled ones
    (temperature 0.8, top-k 50; 700 and 1,200 tokens).  Gate: every
    request's tokens equal between the two engines, sampled ones and the
    warm-up's included (the same seed), and each of phase 3's prompts'
    last-token logits within LOGIT_ATOL of phase 3's chunked engine's.
    Prints both prefill rates and the graphs."""
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    t0 = time.perf_counter()
    bcfg = dataclasses.replace(ecfg, prefill_mode="bucketed", prefill_buckets=(512, 2048))
    pgen = torch.Generator().manual_seed(seed + 41)
    sampled = SamplingParams(temperature=0.8, top_k=50)
    tok = lambda n: torch.randint(1, mcfg.vocab, (n,), generator=pgen).tolist()
    warm = [(tok(300), sampled), (tok(1000), None)]
    reqs = [(p, None) for p in prompts] + [(tok(n), sampled) for n in (700, 1200)]
    runs = {}
    for graphed in (False, True):
        label = f"12(c) bucketed engine {'graphed' if graphed else 'eager'}"
        eng = DecodeEngine(mcfg, cpu_model, bcfg, device=dev)
        if not graphed:
            set_eager(eng)
        serve(f"{label} warm-up", eng, warm, 4, mcfg.vocab)
        logits = record_prompt_logits(eng)
        results, _ = serve(label, eng, reqs, 32, mcfg.vocab)
        err = logits_err(label, {p: x for p, x in logits.items() if p in chunked_logits},
                         chunked_logits, LOGIT_ATOL)
        graphs = {name: [graph_report(g) for g in getattr(getattr(eng, name), "graphs",
                                                           {}).values()]
                  for name in ("_bucket_prefill", "_sample1")}
        if graphed and (len(graphs["_bucket_prefill"]) != 2 or len(graphs["_sample1"]) != 1):
            fail(f"12(c): the graphed engine captured {graphs}: two buckets and one sampler "
                 f"expected")
        runs[graphed] = dict(tokens=[results[r] for r in sorted(results)], err=err,
                             prefill_tps=eng.rates[0], decode_tps=eng.rates[1], graphs=graphs)
        del eng, logits
        gc.collect()
        torch.cuda.empty_cache()
    if runs[True]["tokens"] != runs[False]["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(runs[True]["tokens"], runs[False]["tokens"]))
                if a != b]
        fail(f"12(c): the graphed bucketed engine's tokens differ from the eager engine's in "
             f"requests {diff} (0 and 20, 21 sampled)")
    print(f"12(c) bucketed engine: tokens equal eager and graphed in all {len(reqs) + 2} "
          f"requests (3 sampled, 2 of them warm-up); last prompt token's logits against "
          f"phase 3's chunked engine: eager {runs[False]['err']}, graphed {runs[True]['err']} (tol {LOGIT_ATOL}); prefill "
          f"{runs[False]['prefill_tps']:.1f} tokens/s eager, {runs[True]['prefill_tps']:.1f} "
          f"graphed ({runs[True]['prefill_tps'] / runs[False]['prefill_tps']:.3f}x); decode "
          f"{runs[False]['decode_tps']:.1f}, {runs[True]['decode_tps']:.1f}; graphs "
          f"{json.dumps(runs[True]['graphs'])}", flush=True)
    print(f"phase 12(c): {time.perf_counter() - t0:.3f} s", flush=True)


# ---- phase 13: serving over a process group, one process a mesh slot ----

PG_WORLD = 4
# the engines' layouts over the four ranks: (label, mesh shape, axes)
PG_LAYOUTS = (("tp = 4", (4,), ("model",)), ("cp = 4", (4,), ("seq",)),
              ("model 2 x seq 2", (2, 2), ("model", "seq")))
# four ranks share cuda:0, and NCCL takes one rank a device: the group of
# 13(a) is gloo, whose collectives of CUDA tensors go through the host
# (collectives.py copies them out and back explicitly)
PG_BACKEND = "gloo"


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pg_model(mcfg, dev, seed):
    """Phase 13(a)'s weights: the 168M decoder drawn on the card from a CUDA
    generator, the same in every process."""
    from tf_flash_attention_tpu_torch.models.transformer import init_params
    return init_params(mcfg, torch.Generator(device=dev).manual_seed(seed + 51), device=dev)


def pg_serve(eng, prompts, n_new):
    """``eng``'s steps set eager, ``prompts`` served with the launch counts
    reset just before: (tokens, the last prompt token's float32 logits as
    numpy by request, launches, collective calls, wall seconds)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel import collectives

    set_eager(eng)
    logits = record_prompt_logits(eng)
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    native.reset_launch_counts()
    collectives.CALLS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=[res[r] for r in rids],
                logits={i: logits[tuple(p)].cpu().numpy() for i, p in enumerate(prompts)},
                launches={k: n for k, n in native.LAUNCHES.items() if n},
                collectives=dict(collectives.CALLS), wall=wall)


def pg_caches(dev, gen, seed_shift=0):
    """Phase 13's callable inputs from ``gen``: a full int8 cache (8 KV heads,
    8 slots of 300-3,000 tokens, page 256) with bf16 decode queries, and 4
    slots' prompts of 1,000-3,500 tokens (K/V bf16) for a 4-shard cache,
    with decode queries, one append a slot and a 512-row prefill chunk."""
    cfg = payload_cfg("int8", n_kv_heads=8, head_dim=128, page_size=256, n_pages=129,
                      max_seqs=8, max_pages_per_seq=16)
    lengths = torch.randint(300, 3001, (8,), generator=gen, device=dev).tolist()
    bf = torch.bfloat16
    full = make_cache(cfg, dev, gen, lengths, mapped=12)
    tp_q = torch.randn((8, 8, 128), generator=gen, device=dev).to(bf)
    totals = [t + (t % 256 == 0) for t in
              torch.randint(1000, 3501, (4,), generator=gen, device=dev).tolist()]
    kv = [(torch.randn((8, t, 128), generator=gen, device=dev).to(bf),
           torch.randn((8, t, 128), generator=gen, device=dev).to(bf)) for t in totals]
    return dict(cfg=cfg, full=full, tp_q=tp_q, totals=totals, kv=kv,
                q=torch.randn((4, 8, 128), generator=gen, device=dev).to(bf),
                k_new=torch.randn((4, 8, 128), generator=gen, device=dev).to(bf),
                qp=torch.randn((512, 8, 128), generator=gen, device=dev).to(bf))


def pg_seq_caches(inputs, mesh):
    """The 4-shard cache of ``pg_caches``' prompts, the shards this process
    drives (slot s on pages 4s .. 4s + 3 of every shard)."""
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    cfg = dataclasses.replace(inputs["cfg"], n_pages=17, max_seqs=4, max_pages_per_seq=4)
    caches = tsd.create_seq_sharded_cache(cfg, mesh, "seq")
    for s, (k, v) in enumerate(inputs["kv"]):
        tsd.write_prompt_seq_sharded(caches, cfg, mesh, "seq", s, [range(4 * s, 4 * s + 4)] * 4,
                                     k, v)
    return cfg, caches


def pg_callables(dev, seed, devices=None, graphed=False):
    """The four callables on meshes of ``devices`` (cuda:0 four times by
    default): single-controller where no process group is up, one shard a
    rank where one is.  ``sharded_paged_decode`` at tp 4 on ``pg_caches``'
    full cache; on a seq axis of 4: a decode, one append a slot, a decode
    and a prefill chunk over slot 0's last 512 tokens.  Eagerly
    (``.eager``), or ``graphed``: each decode and the prefill called twice,
    the second call's output kept (a replay; the decode after the append
    replays the first decode's graph on the appended caches), the append
    once (its first call runs it, then captures it).  Returns the outputs
    on the CPU (whole on every process), each launch count and the
    callables' graphs (``graph_report``; none eagerly)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                     sharded_paged_decode)

    devices = devices or [dev] * PG_WORLD
    fns = []

    def take(fn):
        fns.append(fn)
        return fn if graphed else getattr(fn, "eager", fn)

    def call(fn, *args):
        out = fn(*args)
        return fn(*args) if graphed else out

    inputs = pg_caches(dev, torch.Generator(device=dev).manual_seed(seed + 53))
    native.reset_launch_counts()
    heads = make_mesh((PG_WORLD,), ("model",), devices)
    out = {"sharded_decode": call(take(sharded_paged_decode(heads, inputs["cfg"])),
                                  inputs["tp_q"],
                                  shard_cache_heads(inputs["full"], inputs["cfg"], heads))}
    seq = make_mesh((PG_WORLD,), ("seq",), devices)
    cfg, caches = pg_seq_caches(inputs, seq)
    decode = take(tsd.seq_sharded_paged_decode(seq, cfg, "seq"))
    out["decode"] = call(decode, inputs["q"], caches)
    take(tsd.seq_sharded_append(seq, cfg, "seq", trash_page=cfg.n_pages - 1))(
        caches, inputs["k_new"], -inputs["k_new"], torch.ones(4, dtype=torch.bool, device=dev))
    out["decode_after"] = decode(inputs["q"], caches)
    total = inputs["totals"][0] + 1
    out["prefill"] = call(take(tsd.seq_sharded_paged_prefill(seq, cfg, "seq")),
                          inputs["qp"], caches, 0, total - 512, 512)
    torch.cuda.synchronize()
    return ({k: v.float().cpu() for k, v in out.items()},
            {k: n for k, n in native.LAUNCHES.items() if n},
            [graph_report(g) for fn in fns for g in getattr(fn, "graphs", {}).values()])


def pg_rank(rank, port, dev, mcfg, ecfg, prompts, n_new, seed, out):
    """One rank of phase 13(a): joins the gloo group, serves ``prompts`` on
    each of PG_LAYOUTS' meshes (``dev`` for every rank) with the engine's
    steps eager, runs the four callables, and puts its results (or its
    traceback) on ``out``.  A failure also exits non-zero."""
    import traceback

    import torch.distributed as dist
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(PG_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=PG_WORLD, rank=rank)
        model = pg_model(mcfg, dev, seed)
        engines = {}
        for label, shape, axes in PG_LAYOUTS:
            mesh = make_mesh(shape, axes, [dev] * PG_WORLD)
            at = dict(zip(axes, divmod(rank, 2) if len(shape) == 2 else (rank,)))
            if not mesh.process_group or mesh.coords() != at:
                raise RuntimeError(f"rank {rank}: the mesh {mesh} is not the process group's")
            eng = DecodeEngine(mcfg, model, ecfg, mesh=mesh)
            # a gloo group's collectives cannot be captured: the graphed step
            # refuses when it would capture, before running anything
            try:
                eng._decode_step(eng._in_tokens, eng._in_active)
            except RuntimeError as e:
                if "gloo" not in str(e):
                    raise
            else:
                if dev.type == "cuda":
                    raise RuntimeError(f"rank {rank}: a graphed step over gloo did not refuse")
            engines[label] = pg_serve(eng, prompts, n_new)
            engines[label]["held"] = (len(eng._params), len(eng.shards))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        outs, launches, _ = pg_callables(dev, seed)
        out.put((rank, None, dict(engines=engines,
                                  callables={k: v.numpy() for k, v in outs.items()},
                                  callable_launches=launches)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def process_group_phase(mcfg, ecfg, prompts, n_new, seed, dev):
    """Phase 13(a): four ranks (``torch.multiprocessing`` spawn) on cuda:0
    joined by a PG_BACKEND group serve phase 3's requests at the 168M
    configuration (full width and depth, int8 cache; weights from a CUDA
    generator) on each of PG_LAYOUTS eagerly, and run the four callables;
    meanwhile this process runs the same on single-controller meshes of
    cuda:0 four times.  Gates, for every layout and rank: each request's
    tokens equal the single-process engine's up to its first top-2 logit
    tie (GAP_TIE, teacher-forced over the single-process tokens), every
    rank's tokens equal rank 0's, the last prompt token's logits within
    LOGIT_ATOL of the single-process engine's, and every callable's output
    within attn_tol of the single-process call's; a rank that fails, or
    exits non-zero, fails the phase.  Prints the requests equal in full,
    the largest differences (0 where the sums run in one order), each
    layout's launches over the ranks, collective calls and wall seconds.
    Returns {kernel: launches of the ranks' engine runs}."""
    import queue

    import torch.multiprocessing as mp
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=pg_rank, args=(r, port, dev, mcfg, ecfg, prompts, n_new, seed,
                                               results))
             for r in range(PG_WORLD)]
    for p in procs:
        p.start()
    # the single-process references meanwhile, on the same card
    model = pg_model(mcfg, dev, seed)
    want = {}
    for label, shape, axes in PG_LAYOUTS:
        eng = DecodeEngine(mcfg, model, ecfg, mesh=make_mesh(shape, axes, [dev] * PG_WORLD))
        want[label] = pg_serve(eng, prompts, n_new)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    gaps = {label: top2_gaps(mcfg, model, prompts, w["tokens"], dev)[0]
            for label, w in want.items()}
    want_calls, _, _ = pg_callables(dev, seed)
    del model
    torch.cuda.empty_cache()
    ranks, errors = {}, []
    try:
        for _ in procs:
            rank, err, value = results.get(timeout=600)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            ranks[rank] = value
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(PG_WORLD)) - set(ranks))} sent nothing in 600 s")
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
        if p.exitcode != 0:
            errors.append(f"a rank exited with code {p.exitcode}")
    if errors:
        fail("13(a): " + "\n".join(errors))
    total = {}
    for label, _, _ in PG_LAYOUTS:
        w = want[label]
        first = ranks[0]["engines"][label]
        launches, err, calls, walls = {}, 0.0, {}, []
        for rank in range(PG_WORLD):
            got = ranks[rank]["engines"][label]
            name = f"13(a) {label}, rank {rank} of {PG_WORLD} ({PG_BACKEND})"
            check_to_tie(name, prompts, w["tokens"], got["tokens"], gaps[label])
            if got["tokens"] != first["tokens"]:
                fail(f"{name}: its tokens differ from rank 0's")
            if got["held"] != (1, 1):
                fail(f"{name}: holds {got['held']} (param shards, cache shards), not its own")
            as_tensors = lambda d: {i: torch.from_numpy(x) for i, x in d.items()}
            err = max(err, logits_err(name, as_tensors(got["logits"]), as_tensors(w["logits"]),
                                      LOGIT_ATOL))
            for k, n in got["launches"].items():
                launches[k] = launches.get(k, 0) + n
            for k, n in got["collectives"].items():
                calls[k] = calls.get(k, 0) + n
            walls.append(got["wall"])
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        same = sum(a == b for a, b in zip(first["tokens"], w["tokens"]))
        print(f"13(a) {label}: {PG_WORLD} ranks on {dev} over {PG_BACKEND}, eager: every "
              f"rank's tokens equal; {same} of {len(prompts)} requests equal to the "
              f"single-process engine's in full; last prompt token's logits max_abs_err {err} "
              f"(tol {LOGIT_ATOL}); smallest top-2 gap {min(min(g) for g in gaps[label])}; "
              f"launches over the ranks {json.dumps(launches)} (single process "
              f"{json.dumps(w['launches'])}); collective calls over the ranks "
              f"{json.dumps(calls)}; wall s by rank {walls} (single process {w['wall']:.3f})",
              flush=True)
    errs = {}
    for name, ref in want_calls.items():
        for rank in range(PG_WORLD):
            got = torch.from_numpy(ranks[rank]["callables"][name])
            e = float((got - ref).abs().max())
            errs[name] = max(errs.get(name, 0.0), e)
            if not torch.isfinite(got).all() or e > attn_tol(ref):
                fail(f"13(a) {name} on rank {rank}: differs from the single-process call by "
                     f"{e} > {attn_tol(ref)}")
    launches = {}
    for rank in range(PG_WORLD):
        for k, n in ranks[rank]["callable_launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"13(a) callables over the {PG_WORLD} ranks against the single-process calls: "
          f"max_abs_err {json.dumps(errs)} (attn_tol); launches over the ranks "
          f"{json.dumps(launches)}", flush=True)
    print(f"phase 13(a): {time.perf_counter() - t0:.3f} s", flush=True)
    return total


def nccl_phase(mcfg, cpu_model, ecfg, prompts, greedy_3, flat_graphs, seed, dev):
    """Phase 13(b): a world-size-1 NCCL group in this process and the flat
    168M engine on its process-group mesh (seq 1 x model 1), graphed, on
    phase 3's requests after one warm-up request: its graphs capture the
    NCCL collectives (the model axis's two sums a layer, the seq axis's
    lengths).  Gate: each request's tokens equal phase 3's graphed engine's
    up to its first top-2 tie (GAP_TIE), collectives ran at the capture,
    and the decode graph holds more nodes than phase 11's flat one
    (``flat_graphs``), whose nodes it prints beside its own.  Returns
    {kernel: {"launches": the wrappers', "replayed": the graphs'}} of the
    run after the warm-up."""
    import torch.distributed as dist
    from tf_flash_attention_tpu_torch.parallel import collectives
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("seq", "model"))
        if not mesh.process_group or mesh.device != dev or mesh.capture_refusal():
            fail(f"13(b): the NCCL mesh is {mesh} on {mesh.device}, refusal "
                 f"{mesh.capture_refusal()}")
        eng = DecodeEngine(mcfg, cpu_model, ecfg, mesh=mesh)
        collectives.CALLS.clear()
        serve("13(b) nccl warm-up", eng, [(prompts[0][:600], None)], 4, mcfg.vocab)
        captured = dict(collectives.CALLS)
        results, launches = serve("13(b) nccl", eng, [(p, None) for p in prompts], 32,
                                  mcfg.vocab)
        tokens = [results[r] for r in sorted(results)][1:]
        graphs = {name: graph_report(g) for name in ("_decode_step", "_chunk_prefill")
                  for g in getattr(eng, name).graphs.values()}
        replayed = eng.replayed
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gaps, _ = top2_gaps(mcfg, cpu_model, prompts, greedy_3, dev)
    check_to_tie("13(b) nccl engine against phase 3's", prompts, greedy_3, tokens, gaps)
    if not captured.get("psum"):
        fail(f"13(b): no collective ran in the warm-up's captures: {captured}")
    # one rank's NCCL gather is a copy, not a kernel: the graph holds more
    # nodes than the flat engine's, whose sums of one part are no work
    mine, flat = graphs["_decode_step"]["nodes"], flat_graphs["_decode_step"]["nodes"]
    if mine is not None and flat is not None and sum(mine.values()) <= sum(flat.values()):
        fail(f"13(b): the decode graph holds {mine} nodes, no more than phase 11's flat "
             f"{flat}: the NCCL collectives were not captured")
    same = sum(a == b for a, b in zip(tokens, greedy_3))
    print(f"13(b) flat engine on a world-size-1 NCCL group, graphed: {same} of {len(prompts)} "
          f"requests equal to phase 3's in full; collective calls at capture "
          f"{json.dumps(captured)}; decode graph nodes {json.dumps(mine)} beside phase 11's "
          f"flat {json.dumps(flat)}; graphs {json.dumps(graphs)}; replayed "
          f"{json.dumps(replayed)}", flush=True)
    print(f"phase 13(b) engine: {time.perf_counter() - t0:.3f} s", flush=True)
    return {k: {"launches": launches[k], "replayed": replayed.get(k, 0)}
            for k in launches if launches[k] or replayed.get(k)}


def graph_keys_phase(dev, seed):
    """Phase 13(b), the callables' graphs: on single-controller meshes of
    cuda:0 four times, each of the four callables is a ``GraphedCall``
    called with two different caches of one shape in turn (A, B, A, B: two
    captures, then a replay of each).  Gate: every call equals the eager
    function on its own cache (bit for bit: the same kernels), A's result
    differs from B's, each callable holds two graphs replayed once each;
    the appends leave each cache as two eager appends leave a copy of it.
    Prints each graph's nodes and replays."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving import seq_sharded_decode as tsd
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedCall
    from tf_flash_attention_tpu_torch.serving.sharded_decode import (shard_cache_heads,
                                                                     sharded_paged_decode)

    t0 = time.perf_counter()
    heads = make_mesh((PG_WORLD,), ("model",), [dev] * PG_WORLD)
    seq = make_mesh((PG_WORLD,), ("seq",), [dev] * PG_WORLD)
    a, b = (pg_caches(dev, torch.Generator(device=dev).manual_seed(seed + s)) for s in (61, 62))
    (cfg, sa), (_, sb) = pg_seq_caches(a, seq), pg_seq_caches(b, seq)
    ha, hb = (shard_cache_heads(x["full"], x["cfg"], heads) for x in (a, b))
    total = min(a["totals"][0], b["totals"][0])
    cases = [("sharded_paged_decode", sharded_paged_decode(heads, a["cfg"]),
              (a["tp_q"], ha), (a["tp_q"], hb)),
             ("seq_sharded_paged_decode", tsd.seq_sharded_paged_decode(seq, cfg, "seq"),
              (a["q"], sa), (a["q"], sb)),
             ("seq_sharded_paged_prefill", tsd.seq_sharded_paged_prefill(seq, cfg, "seq"),
              (a["qp"], sa, 0, total - 512, 512), (a["qp"], sb, 0, total - 512, 512))]
    report = {}
    for name, fn, args_a, args_b in cases:
        if not isinstance(fn, GraphedCall):
            fail(f"13(b) {name}: {type(fn).__name__} on one card, not a GraphedCall")
        want = [fn.eager(*args_a), fn.eager(*args_b)]
        got = [fn(*args_a), fn(*args_b), fn(*args_a), fn(*args_b)]
        torch.cuda.synchronize()
        for i, g in enumerate(got):
            if not torch.equal(g, want[i % 2]):
                fail(f"13(b) {name}: call {i} ({'AB'[i % 2]}) differs from the eager call on "
                     f"its cache by {float((g.float() - want[i % 2].float()).abs().max())}")
        if torch.equal(want[0], want[1]):
            fail(f"13(b) {name}: the two caches give one result")
        if sorted(g.replays for g in fn.graphs.values()) != [1, 1]:
            fail(f"13(b) {name}: graphs {[g.replays for g in fn.graphs.values()]}, two of one "
                 f"replay each expected")
        report[name] = [dict(nodes=g.nodes, replays=g.replays) for g in fn.graphs.values()]
    # the append updates its caches in place: against two eager appends on copies
    fn = tsd.seq_sharded_append(seq, cfg, "seq", trash_page=cfg.n_pages - 1)
    copies = [[clone_cache(c) for c in s] for s in (sa, sb)]
    active = torch.ones(4, dtype=torch.bool, device=dev)
    for _ in range(2):
        for caches, src in ((copies[0], a), (copies[1], b)):
            fn.eager(caches, src["k_new"], -src["k_new"], active)
        for caches, src in ((sa, a), (sb, b)):
            if fn(caches, src["k_new"], -src["k_new"], active) is not caches:
                fail("13(b) seq_sharded_append: the call returned other caches than its own")
    torch.cuda.synchronize()
    for got, want in ((sa, copies[0]), (sb, copies[1])):
        for g, w in zip(got, want):
            d = diff_outside_trash(g, w, cfg.n_pages - 1)
            if not torch.equal(g.lengths, w.lengths):
                d.append("lengths")
            if d:
                fail(f"13(b) seq_sharded_append: a graphed append differs from the eager one: "
                     f"{d}")
    if sorted(g.replays for g in fn.graphs.values()) != [1, 1]:
        fail(f"13(b) seq_sharded_append: graphs {[g.replays for g in fn.graphs.values()]}")
    report["seq_sharded_append"] = [dict(nodes=g.nodes, replays=g.replays)
                                    for g in fn.graphs.values()]
    print(f"13(b) callables graphed on cuda:0, two caches of one shape in turn: every call "
          f"equal to the eager call on its own cache; graphs {json.dumps(report)}", flush=True)
    print(f"phase 13(b) callables: {time.perf_counter() - t0:.3f} s", flush=True)


# ---- phase 14: training over a process group, one process a mesh slot ----

# the layouts of 14(a) over the four ranks: (label, mesh shape, axes, what
# the config adds); the pipeline's M
TRAIN_PG_LAYOUTS = (("dense sp", (2, 2), ("data", "model"), {}),
                    ("cp", (1, 2, 2), RING_AXES, dict(context_parallel=True)),
                    ("moe", (2, 2), ("data", "model"), dict(n_experts=MOE_EXPERTS)),
                    ("gpipe", (2, 2), ("data", "pipe"), {}))
TRAIN_PG_MICROBATCHES = 2
TRAIN_PG_STEPS = 2
# the callables of 14(a): (label, mesh shape over RING_AXES, kind)
TRAIN_PG_CALLABLES = (("ring causal", (1, 1, 4), "ring"), ("ulysses causal", (1, 1, 4), "ulysses"),
                      ("sharded causal", (2, 2, 1), "sharded"))
# the gathered parameters after TRAIN_PG_STEPS AdamW steps against the
# single process's: in its first steps AdamW moves an element by at most lr
# (|m_hat / sqrt(v_hat)| <= 1), so two runs part by at most 2 lr a step
# wherever their gradients differ, however little (an element whose
# gradient is near 0 flips its step's sign at a bf16 rounding); that bound
# holds for any two runs, so the gate that has teeth is the mean: the mean
# |difference| over the mean |update| of the single process.  A lost or
# doubled shard's gradient changes the sign of a large share of the
# updates (a share of 0.3 or more), bf16 roundings only the steps of
# near-zero gradients; 0.1
TRAIN_PG_UPDATE_RTOL = 0.1


def pg_train_model(cfg, dev, seed, pipe=None):
    """14(a)'s initial weights, the same in every process: the 168M decoder
    drawn on the card from a CUDA generator (phase 6c's draw for the MoE
    model), as a ``StagedTransformer`` of ``pipe`` stages where given."""
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.models.transformer import init_params

    gen = torch.Generator(device=dev).manual_seed(seed + (21 if cfg.n_experts else 71))
    model = init_params(cfg, gen, device=dev)
    return model if pipe is None else pipeline.stack_stage_params(cfg, model, pipe)


def pg_train_tokens(cfg, dev, seed):
    """Phase 6's batch (8 x 2,049 tokens from its generator)."""
    gen = torch.Generator().manual_seed(seed + 2)
    return torch.randint(0, cfg.vocab, (8, 2049), generator=gen).to(dev)


def pg_train_step(label, cfg, params, mesh):
    """(step, the parameters it takes) of a 14(a) layout on ``mesh``: the
    factory's step over ``params`` (the whole model or its stages), on a
    process-group mesh over the rank's slot of them; phase 6's AdamW,
    capturable (on one card the factory returns a ``GraphedTrainStep``)."""
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.models import transformer as tf

    adamw = lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4, capturable=True)
    if label == "gpipe":
        slot = pipeline.slot_stages(params, mesh)
        step, _ = pipeline.make_pipeline_train_step(cfg, mesh, adamw(slot.parameters()),
                                                    TRAIN_PG_MICROBATCHES)
    else:
        slot = tf.slot_params(cfg, params, mesh)
        step = tf.make_sharded_train_step(cfg, mesh, adamw(slot.parameters()))
    return step, slot


def pg_gathered(label, cfg, slot, mesh, grads=False):
    """The whole parameters (or gradients) as {name: tensor}."""
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.models import transformer as tf

    whole = (pipeline.gather_stages(slot, mesh, grads=grads) if label == "gpipe"
             else tf.gather_params(cfg, slot, mesh, grads=grads))
    return {n: p.detach() for n, p in whole.named_parameters()}


def pg_callable_inputs(dev, seed):
    """6b(a)'s q, k, v and output cotangent at RING_SHAPE, bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    return [torch.randn(RING_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(4)]


def pg_callables_run(mesh_of, dev, seed, graphed=False):
    """TRAIN_PG_CALLABLES (causal) eagerly on ``mesh_of(shape)``: {label:
    [o, dq, dk, dv]} (whole), their launches and their graphs
    (``graph_report``; none eagerly); ``graphed``: each called twice,
    forward and backward (its eager first call and captures, then a replay
    of each graph), the replay's kept."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.parallel import (ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)

    *qkv, do = pg_callable_inputs(dev, seed)
    out, graphs = {}, {}
    native.reset_launch_counts()
    for label, shape, kind in TRAIN_PG_CALLABLES:
        mesh = mesh_of(shape)
        fn = {"ring": lambda: ring_flash_attention(mesh, rule=CausalRule()),
              "ulysses": lambda: ulysses_flash_attention(mesh, CausalRule()),
              "sharded": lambda: sharded_flash_attention(mesh, CausalRule())}[kind]()
        for _ in range(2 if graphed else 1):
            xs = [x.detach().requires_grad_(True) for x in qkv]
            o = (fn if graphed else getattr(fn, "eager", fn))(*xs)
            out[label] = [o.detach(), *torch.autograd.grad(o, xs, do)]
        if graphed:
            sig = next(iter(fn.graphs.values()))
            graphs[label] = {"forward": graph_report(sig.fwd), "backward": graph_report(sig.bwd)}
    torch.cuda.synchronize()
    return out, {k: n for k, n in native.LAUNCHES.items() if n}, graphs


def pg_train_rank(rank, port, dev, mcfg, seed, refdir, ready, out):
    """One rank of phase 14(a): joins the gloo group, waits for the parent's
    references (``ready``), and on each of TRAIN_PG_LAYOUTS: its slot of the
    initial weights, a check that the factory's step refuses to capture
    over gloo, TRAIN_PG_STEPS eager steps timed, the gathered gradient
    norm after the first, the gathered parameters after the last against
    the parent's (``refdir``); then the callables eagerly against the
    parent's.  Puts its figures (or its traceback) on ``out``."""
    import traceback

    import torch.distributed as dist
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import pipeline
    from tf_flash_attention_tpu_torch.parallel import collectives
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(dev)
    try:
        dist.init_process_group(PG_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=PG_WORLD, rank=rank)
        if not ready.wait(timeout=900):
            raise RuntimeError("the parent's references did not come")
        figures = {}
        for label, shape, axes, extra in TRAIN_PG_LAYOUTS:
            cfg = dataclasses.replace(mcfg, **extra)
            mesh = make_mesh(shape, axes, [dev] * PG_WORLD)
            tokens = pg_train_tokens(cfg, dev, seed)
            init = pg_train_model(cfg, dev, seed, shape[1] if label == "gpipe" else None)
            step, slot = pg_train_step(label, cfg, init, mesh)
            try:
                step(slot, tokens)
            except RuntimeError as e:
                if "gloo" not in str(e):
                    raise
            else:
                raise RuntimeError(f"rank {rank} {label}: a graphed step over gloo did not "
                                   f"refuse")
            losses, walls, calls, launches = [], [], [], []
            for i in range(TRAIN_PG_STEPS):
                collectives.CALLS.clear()
                native.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step.eager(slot, tokens)))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                calls.append(dict(collectives.CALLS))
                launches.append({k: native.LAUNCHES[k] for k in ("banded_fwd", "banded_bwd")})
                if i == 0:
                    grads = pg_gathered(label, cfg, slot, mesh, grads=True)
                    gnorm = math.sqrt(sum(float((g.float() ** 2).sum()) for g in grads.values()))
                    del grads
            after = pg_gathered(label, cfg, slot, mesh)
            start = dict(init.named_parameters())
            ref = torch.load(os.path.join(refdir, f"{label}.pt"), mmap=True)
            worst, diff, moved, sums = 0.0, 0.0, 0.0, []
            for name, p in after.items():
                want = ref[name].to(dev)
                d = (p.detach() - want).abs()
                worst = max(worst, float(d.max()))
                diff += float(d.double().sum())
                moved += float((want - start[name].detach()).abs().double().sum())
                sums.append(int(p.detach().view(torch.int32).sum(dtype=torch.int64)))
            figures[label] = dict(losses=losses, walls=walls, calls=calls, launches=launches,
                                  gnorm=gnorm, worst=worst, update_err=diff / moved,
                                  checksums=sums,
                                  held=sum(p.numel() for p in slot.parameters()),
                                  whole=sum(p.numel() for p in after.values()))
            del init, step, slot, after, start, ref
            gc.collect()
            torch.cuda.empty_cache()
        collectives.CALLS.clear()
        outs, launches, _ = pg_callables_run(
            lambda shape: make_mesh(shape, RING_AXES, [dev] * PG_WORLD), dev, seed)
        calls = dict(collectives.CALLS)
        ref = torch.load(os.path.join(refdir, "callables.pt"), mmap=True)
        errs = {}
        for label, got in outs.items():
            errs[label] = []
            for a, want in zip(got, ref[label]):
                want = want.to(dev)
                e, tol = float((a.float() - want.float()).abs().max()), attn_tol(want)
                if not torch.isfinite(a.float()).all() or e > tol:
                    raise RuntimeError(f"rank {rank} {label}: differs from the single-process "
                                       f"call by {e} > {tol}")
                errs[label].append(e)
        out.put((rank, None, dict(layouts=figures, callable_errs=errs,
                                  callable_launches=launches, callable_calls=calls)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_pg_references(mcfg, seed, dev, refdir, n_steps, layouts=TRAIN_PG_LAYOUTS,
                        callables=True):
    """The single-process references of ``layouts`` (TRAIN_PG_LAYOUTS) and
    TRAIN_PG_CALLABLES on single-controller meshes of ``dev`` (a slot each),
    eager: each layout's ``n_steps`` steps (losses, walls, the first step's
    gradient norm) and its final parameters (saved in ``refdir`` as
    ``<label>.pt``), the callables' outputs (``callables.pt``; none without
    ``callables``).  Returns ({label: figures}, the callables' launches)."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    want = {}
    for label, shape, axes, extra in layouts:
        cfg = dataclasses.replace(mcfg, **extra)
        mesh = make_mesh(shape, axes, [dev] * math.prod(shape))
        tokens = pg_train_tokens(cfg, dev, seed)
        init = pg_train_model(cfg, dev, seed, shape[1] if label == "gpipe" else None)
        step, params = pg_train_step(label, cfg, init, mesh)
        losses, walls, _, _, gnorm = timed_train_calls(step.eager, params, tokens, n=n_steps)
        want[label] = dict(losses=losses, walls=walls, gnorm=gnorm)
        torch.save({n: p.detach().cpu() for n, p in params.named_parameters()},
                   os.path.join(refdir, f"{label}.pt"))
        del step, params, init
        gc.collect()
        torch.cuda.empty_cache()
    if not callables:
        return want, {}
    outs, launches, _ = pg_callables_run(
        lambda shape: make_mesh(shape, RING_AXES, [dev] * PG_WORLD), dev, seed)
    torch.save({k: [x.cpu() for x in v] for k, v in outs.items()},
               os.path.join(refdir, "callables.pt"))
    del outs
    torch.cuda.empty_cache()
    return want, launches


def train_pg_phase(mcfg, seed, dev):
    """Phase 14(a): four ranks (``torch.multiprocessing`` spawn) on cuda:0
    joined by a PG_BACKEND group train the 168M decoder at full width and
    depth on phase 6's batch (8 x 2,048 tokens) on each of TRAIN_PG_LAYOUTS,
    TRAIN_PG_STEPS AdamW steps eagerly (phase 6's settings), each rank
    holding its slot of the weights, and run TRAIN_PG_CALLABLES at
    RING_SHAPE bf16 forward and backward.  While they start, this process
    runs the same on single-controller meshes of cuda:0 four times and
    leaves its final parameters and outputs in a temporary folder.  Gates:
    every rank's losses are equal, and its gathered parameters bit-equal
    (checksums); the first loss within TRAIN_LOSS_ATOL and the gathered
    gradient norm within TRAIN_GNORM_RTOL of the single process's; the
    gathered parameters after the steps within TRAIN_PG_UPDATE_RTOL
    (mean) of the single process's; each callable's output and dQ/dK/dV
    within attn_tol of the single-process call's; rows 2 and 7 launched in
    every layout.  Prints each rank's step walls, collective calls and
    launches of banded_fwd and banded_bwd.  Returns {kernel: launches over
    the ranks' steps}."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results, ready = ctx.Queue(), ctx.Event()
    port = free_port()
    with tempfile.TemporaryDirectory() as refdir:
        procs = [ctx.Process(target=pg_train_rank,
                             args=(r, port, dev, mcfg, seed, refdir, ready, results))
                 for r in range(PG_WORLD)]
        for p in procs:
            p.start()
        # the single-process references meanwhile (the ranks wait for them)
        want, single_launches = train_pg_references(mcfg, seed, dev, refdir, TRAIN_PG_STEPS)
        print(f"14(a) single-process references: {time.perf_counter() - t0:.3f} s", flush=True)
        ready.set()
        ranks, errors = {}, []
        try:
            for _ in procs:
                rank, err, value = results.get(timeout=900)
                if err:
                    errors.append(f"rank {rank}:\n{err}")
                ranks[rank] = value
        except queue.Empty:
            errors.append(f"ranks {sorted(set(range(PG_WORLD)) - set(ranks))} sent nothing in "
                          f"900 s")
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
            if p.exitcode != 0:
                errors.append(f"a rank exited with code {p.exitcode}")
    if errors:
        fail("14(a): " + "\n".join(errors))
    total = {}
    for label, shape, axes, _ in TRAIN_PG_LAYOUTS:
        w, first = want[label], ranks[0]["layouts"][label]
        name = f"14(a) {label} {dict(zip(axes, shape))}"
        for rank in range(PG_WORLD):
            got = ranks[rank]["layouts"][label]
            if got["losses"] != first["losses"] or got["checksums"] != first["checksums"]:
                fail(f"{name}: rank {rank}'s losses {got['losses']} or gathered parameters "
                     f"differ from rank 0's ({first['losses']})")
            for launches in got["launches"]:
                if not launches["banded_fwd"] or not launches["banded_bwd"]:
                    fail(f"{name}: rank {rank} launched {launches} in a step")
                for k, n in launches.items():
                    total[k] = total.get(k, 0) + n
        check_train(name, first["losses"], first["gnorm"], w["losses"][0], w["gnorm"])
        walls = [[round(x, 3) for x in ranks[r]["layouts"][label]["walls"]]
                 for r in range(PG_WORLD)]
        if first["update_err"] > TRAIN_PG_UPDATE_RTOL:
            fail(f"{name}: the gathered parameters after {TRAIN_PG_STEPS} steps part from the "
                 f"single process's by {first['update_err']} of its mean update > "
                 f"{TRAIN_PG_UPDATE_RTOL} (largest element {first['worst']})")
        print(f"{name}, {PG_WORLD} ranks on {dev} over {PG_BACKEND}, eager: losses "
              f"{first['losses']} on every rank (single process {w['losses']}, first-step diff "
              f"{abs(first['losses'][0] - w['losses'][0])}, tol {TRAIN_LOSS_ATOL}); gathered "
              f"grad norm {first['gnorm']} vs {w['gnorm']} (rtol {TRAIN_GNORM_RTOL}); "
              f"parameters after {TRAIN_PG_STEPS} steps: mean |diff| / mean |update| "
              f"{first['update_err']} (tol {TRAIN_PG_UPDATE_RTOL}), largest {first['worst']}, "
              f"bit-equal on every rank; a rank holds {first['held']} of {first['whole']} "
              f"parameters; step wall s by rank {walls} (single process "
              f"{[round(x, 3) for x in w['walls']]}); collective calls a "
              f"step by rank {[ranks[r]['layouts'][label]['calls'] for r in range(PG_WORLD)]}; "
              f"banded_fwd/banded_bwd a step by rank "
              f"{[ranks[r]['layouts'][label]['launches'] for r in range(PG_WORLD)]}",
              flush=True)
    errs = {label: max(max(ranks[r]["callable_errs"][label]) for r in range(PG_WORLD))
            for label, _, _ in TRAIN_PG_CALLABLES}
    launches = {}
    for rank in range(PG_WORLD):
        for k, n in ranks[rank]["callable_launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"14(a) callables at {RING_SHAPE} bf16 over the {PG_WORLD} ranks, forward and "
          f"backward, against the single-process calls: max_abs_err of o, dq, dk, dv "
          f"{json.dumps(errs)} (attn_tol); launches over the ranks {json.dumps(launches)} "
          f"(single process {json.dumps(single_launches)}); collective calls by rank "
          f"{[ranks[r]['callable_calls'] for r in range(PG_WORLD)]}", flush=True)
    print(f"phase 14(a): {time.perf_counter() - t0:.3f} s", flush=True)
    return total


def train_nccl_phase(mcfg, cpu_model, graphed_12a, seed, dev):
    """Phase 14(b): a world-size-1 NCCL group in this process.
    make_sharded_train_step on its one-slot mesh (data 1 x model 1) is a
    GraphedTrainStep whose graph captures the step's collectives; three
    calls (eager and capture, two replays) from phase 6's weights on its
    batch, gated against phase 12(a)'s 1-device graphed step
    (``graphed_12a``: its losses and gradient norm) within TRAIN_LOSS_ATOL
    and TRAIN_GNORM_RTOL, with collectives run at the capture.  Then
    ring_flash_attention on the one-slot mesh (data, model, context 1),
    graphed: two calls, the replay's output and dQ/dK/dV within attn_tol of
    the eager function's.  Prints both graphs' nodes."""
    import torch.distributed as dist
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.parallel import collectives, ring_flash_attention
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedFunction, GraphedTrainStep

    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        if not mesh.process_group or mesh.device != dev or mesh.capture_refusal():
            fail(f"14(b): the NCCL mesh is {mesh} on {mesh.device}, refusal "
                 f"{mesh.capture_refusal()}")
        tokens = pg_train_tokens(mcfg, dev, seed)
        slot = tf.slot_params(mcfg, copy.deepcopy(cpu_model).to(dev), mesh)
        opt = torch.optim.AdamW(slot.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, capturable=True)     # phase 6's
        step = tf.make_sharded_train_step(mcfg, mesh, opt)
        if not isinstance(step, GraphedTrainStep):
            fail(f"14(b): the factory returned {type(step).__name__} on the NCCL rank")
        collectives.CALLS.clear()
        losses, walls, _, spans, gnorm = timed_train_calls(step, slot, tokens)
        captured = dict(collectives.CALLS)
        g = next(iter(step.graphs.values()))
        train_graph = graph_report(g)
        del slot, opt, step, g
        gc.collect()
        torch.cuda.empty_cache()
        ctx = make_mesh((1, 1, 1), RING_AXES)
        ring = ring_flash_attention(ctx, rule=CausalRule())
        if not isinstance(ring, GraphedFunction):
            fail(f"14(b): ring_flash_attention is {type(ring).__name__} on the NCCL rank")
        *qkv, do = pg_callable_inputs(dev, seed)

        def run(fn):
            xs = [x.detach().requires_grad_(True) for x in qkv]
            o = fn(*xs)
            return [o.detach(), *torch.autograd.grad(o, xs, do)]

        want = run(ring.eager)
        run(ring)                      # the eager first call and the captures
        got = run(ring)                # the replays
        torch.cuda.synchronize()
        ring_err = 0.0
        for name, a, ref in zip(("o", "dq", "dk", "dv"), got, want):
            e, tol = float((a.float() - ref.float()).abs().max()), attn_tol(ref)
            if not torch.isfinite(a.float()).all() or e > tol:
                fail(f"14(b) ring graphed at world size 1: {name} differs from the eager call "
                     f"by {e} > {tol}")
            ring_err = max(ring_err, e)
        sig = next(iter(ring.graphs.values()))
        ring_graphs = {"forward": graph_report(sig.fwd), "backward": graph_report(sig.bwd)}
        del ring, sig, got, want
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ref = graphed_12a
    for i, (a, b) in enumerate(zip(losses, ref["losses"])):
        if not math.isfinite(a) or abs(a - b) > TRAIN_LOSS_ATOL:
            fail(f"14(b): step {i + 1}'s loss {a} vs phase 12(a)'s 1-device graphed {b}: > "
                 f"{TRAIN_LOSS_ATOL}")
    if abs(gnorm - ref["gnorm"]) > TRAIN_GNORM_RTOL * ref["gnorm"]:
        fail(f"14(b): first-step grad norm {gnorm} vs phase 12(a)'s {ref['gnorm']}: > "
             f"{TRAIN_GNORM_RTOL} relative")
    if not captured.get("psum"):
        fail(f"14(b): no collective ran in the step's capture: {captured}")
    print(f"14(b) make_sharded_train_step on a world-size-1 NCCL group (data 1 x model 1), "
          f"graphed: losses {losses} vs phase 12(a)'s 1-device graphed {ref['losses']} (diffs "
          f"{[abs(a - b) for a, b in zip(losses, ref['losses'])]}, equal: "
          f"{losses == ref['losses']}); grad norm {gnorm} vs {ref['gnorm']}; collective calls "
          f"of the eager step and the capture {json.dumps(captured)}; step ms "
          f"{[round(w * 1e3, 3) for w in walls]} (replay spans ms {[round(s, 3) for s in spans]}"
          f"); graph {json.dumps(train_graph)}; phase 12(a)'s 1-device graph "
          f"{json.dumps(ref['graph'])}", flush=True)
    print(f"14(b) ring_flash_attention causal at {RING_SHAPE} bf16 on the one-slot NCCL mesh, "
          f"graphed: replay vs eager max_abs_err {ring_err} (attn_tol); graphs "
          f"{json.dumps(ring_graphs)}", flush=True)
    print(f"phase 14(b): {time.perf_counter() - t0:.3f} s", flush=True)


# ---- phase 15: the port across the four cards of one host ----

CARDS = 4
# 15(c)'s training steps a layout (the first eager and captured, then replays)
MC_TRAIN_STEPS = 3


def cards():
    return [torch.device("cuda", i) for i in range(CARDS)]


def sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def card_kernel_counts(eng, prompts):
    """One decode step of ``eng`` under torch.profiler, after ``prompts``
    were admitted and stepped once: {kernel: {device index: kernels the
    profiler saw}} of the decode and the append (SERVING_KERNEL_NAMES); a
    graphed engine's step is one replay."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    eng.step()
    sync_cards()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step()
        sync_cards()
    counts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in ("paged_decode", "kv_append"):
            if any(n in e.name for n in SERVING_KERNEL_NAMES[k]):
                c = counts.setdefault(k, {})
                c[e.device_index] = c.get(e.device_index, 0) + 1
    return counts


def multicard_serve(label, mcfg, model, ecfg, prompts, n_new, mesh, graphed, profile=False):
    """``compiled_run`` of the engine of ``model`` on ``mesh`` over
    ``prompts``: {"tokens", "logits" (the last prompt token's float32 logits
    by request, on the CPU), "fig"}; with ``profile`` the figures'
    ``inspect`` holds ``card_kernel_counts`` of a step over four more
    prompts."""
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    held = {}

    def make():
        eng = DecodeEngine(mcfg, model, ecfg, mesh=mesh)
        held["logits"] = record_prompt_logits(eng)
        return eng

    more = [[7] * 200 + p[:100] for p in prompts[:4]]
    inspect = (lambda eng: card_kernel_counts(eng, more)) if profile else None
    tokens, fig, _ = compiled_run(label, make, [(p, None) for p in prompts], n_new, mcfg.vocab,
                                  graphed, inspect)
    return dict(tokens=tokens[1:],
                logits={i: held["logits"][tuple(p)].cpu() for i, p in enumerate(prompts)},
                fig=fig)


def serve_figures(fig):
    """A run's step and chunk figures (``compiled_run``), rounded for a
    line, with the busy shares: the event span over the wall."""
    out = {k: round(fig[k], 4) for k in ("step_ms", "host_ms", "span_ms", "chunk_ms",
                                         "chunk_host_ms", "chunk_span_ms", "decode_tps",
                                         "prefill_tps")}
    out["busy"] = round(fig["span_ms"] / fig["step_ms"], 4)
    out["chunk_busy"] = round(fig["chunk_span_ms"] / fig["chunk_ms"], 4)
    return out


def multicard_engines_phase(mcfg, ecfg, prompts, n_new, seed, dev, compiled_11=None):
    """Phase 15(a): one process drives the shards on cuda:0..3.  For each of
    PG_LAYOUTS (tp = 4, cp = 4, model 2 x seq 2) at the 168M configuration
    on phase 3's requests (phase 13's weights): the engine on cuda:0 four
    times, graphed; on cuda:0..3, graphed (each step one graph across the
    four cards); on cuda:0..3 eager.  Gates: the four-card engines' tokens
    and last prompt token's logits bit-equal to the one-card engine's (the
    same kernels on the same shapes, sums in shard order on cuda:0), the
    four-card graphs replayed, and in one profiled decode step (a replay)
    each card running a quarter of the decode and append kernels.  Then the
    four serving callables graphed on cuda:0..3 against cuda:0 four times
    and against their eager calls on the four cards, bit for bit.  Prints
    each run's figures (step and chunk walls, host ms in the calls, event
    spans, busy shares) beside the one-card run's and phase 11's.  Returns
    ({layout: the four-card run}, the callables' four-card outputs)."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    model = pg_model(mcfg, dev, seed)
    out = {}
    for label, shape, axes in PG_LAYOUTS:
        runs = {}
        for run, devices, graphed in (("one card", [dev] * CARDS, True),
                                      ("four cards", cards(), True),
                                      ("four cards eager", cards(), False)):
            runs[run] = multicard_serve(f"15(a) {label} {run}", mcfg, model, ecfg, prompts,
                                        n_new, make_mesh(shape, axes, devices), graphed,
                                        profile=run == "four cards")
        want = runs["one card"]
        for run in ("four cards", "four cards eager"):
            got = runs[run]
            if got["tokens"] != want["tokens"]:
                fail(f"15(a) {label} {run}: tokens differ from the one-card engine's in "
                     f"{sum(a != b for a, b in zip(got['tokens'], want['tokens']))} of "
                     f"{len(prompts)} requests")
            bad = [i for i in want["logits"] if not torch.equal(got["logits"][i],
                                                                 want["logits"][i])]
            if bad:
                i = bad[0]
                fail(f"15(a) {label} {run}: the last prompt token's logits of {len(bad)} "
                     f"requests differ from the one-card engine's (request {i}: max_abs_err "
                     f"{float((got['logits'][i] - want['logits'][i]).abs().max())})")
        four = runs["four cards"]["fig"]
        for name in ("_decode_step", "_chunk_prefill"):
            if not four["graphs"].get(name, {}).get("replays"):
                fail(f"15(a) {label}: the four-card engine's {name} was not replayed: "
                     f"{four['graphs']}")
        counts = four["inspect"]
        for k in ("paged_decode", "kv_append"):
            c = counts.get(k, {})
            if sorted(c) != list(range(CARDS)) or any(n * CARDS != sum(c.values())
                                                      for n in c.values()):
                fail(f"15(a) {label}: a profiled four-card decode step ran {k} on cards "
                     f"{c}, not a quarter on each of {CARDS}")
        figs = {run: serve_figures(r["fig"]) for run, r in runs.items()}
        p11 = (compiled_11 or {}).get(label, {}).get("graphed")
        print(f"15(a) {label} single-controller on cuda:0..{CARDS - 1}: tokens and logits of "
              f"the {len(prompts)} requests bit-equal to cuda:0 x {CARDS}, graphed and eager; "
              f"kernels of a profiled decode step by card {json.dumps(counts)}; figures "
              f"{json.dumps(figs)}; phase 11's one-card graphed medians "
              f"{json.dumps(p11) if p11 else 'n/a'}; four-card graphs "
              f"{json.dumps(four['graphs'])}", flush=True)
        out[label] = runs["four cards"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    want, _, one_graphs = pg_callables(dev, seed, [dev] * CARDS, graphed=True)
    got, launches, graphs = pg_callables(dev, seed, cards(), graphed=True)
    eager, _, _ = pg_callables(dev, seed, cards())
    for name, ref in want.items():
        for run, outs in (("graphed", got), ("eager", eager)):
            if not torch.equal(outs[name], ref):
                fail(f"15(a) {name} on cuda:0..{CARDS - 1} {run}: differs from the graphed call "
                     f"on cuda:0 x {CARDS} by {float((outs[name] - ref).abs().max())}")
    print(f"15(a) the four serving callables graphed on cuda:0..{CARDS - 1}: bit-equal to cuda:0 "
          f"x {CARDS} and to their eager calls on the four cards; launches {json.dumps(launches)};"
          f" graphs {json.dumps(graphs)} (one card {json.dumps(one_graphs)})", flush=True)
    print(f"phase 15(a): {time.perf_counter() - t0:.3f} s", flush=True)
    return out, got


def multicard_rank(rank, port, mcfg, ecfg, prompts, n_new, seed, refdir, ready, out):
    """One rank of phase 15(c), on cuda:{rank}: started as torchrun starts a
    process (MASTER_ADDR, MASTER_PORT, RANK, LOCAL_RANK, WORLD_SIZE) by
    ``maybe_init_distributed()`` alone; serves phase 3's requests on each of
    PG_LAYOUTS graphed (NCCL collectives inside its graphs), runs the four
    serving callables graphed, then (after the parent's references,
    ``ready``) each of TRAIN_PG_LAYOUTS graphed for MC_TRAIN_STEPS steps and
    TRAIN_PG_CALLABLES graphed.  Puts its figures (or its traceback) on
    ``out``."""
    import traceback

    import torch.distributed as dist
    from tf_flash_attention_tpu_torch.parallel import collectives
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedTrainStep

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(CARDS), LOCAL_WORLD_SIZE=str(CARDS))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        if not maybe_init_distributed():
            raise RuntimeError("maybe_init_distributed started no group")
        dev = torch.device("cuda", rank)
        if torch.cuda.current_device() != rank or dist.get_backend() != "nccl":
            raise RuntimeError(f"rank {rank}: on cuda:{torch.cuda.current_device()} over "
                               f"{dist.get_backend()}")
        started = time.perf_counter() - t0
        model = pg_model(mcfg, dev, seed)
        serving = {}
        for label, shape, axes in PG_LAYOUTS:
            mesh = make_mesh(shape, axes)
            if not mesh.process_group or mesh.device != dev or mesh.capture_refusal():
                raise RuntimeError(f"rank {rank}: the mesh is on {mesh.device}, refusal "
                                   f"{mesh.capture_refusal()}")
            collectives.CALLS.clear()
            r = multicard_serve(f"15(c) {label} rank {rank}", mcfg, model, ecfg, prompts, n_new,
                                mesh, True)
            serving[label] = dict(tokens=r["tokens"],
                                  logits={i: x.numpy() for i, x in r["logits"].items()},
                                  fig=serve_figures(r["fig"]), graphs=r["fig"]["graphs"],
                                  calls=dict(collectives.CALLS))
            gc.collect()
            torch.cuda.empty_cache()
        del model
        collectives.CALLS.clear()
        outs, launches, graphs = pg_callables(dev, seed, cards(), graphed=True)
        callables = dict(outs={k: v.numpy() for k, v in outs.items()}, launches=launches,
                         graphs=graphs, calls=dict(collectives.CALLS))
        if not ready.wait(timeout=900):
            raise RuntimeError("the parent's references did not come")
        training = {}
        for label, shape, axes, extra in TRAIN_PG_LAYOUTS:
            cfg = dataclasses.replace(mcfg, **extra)
            mesh = make_mesh(shape, axes)
            tokens = pg_train_tokens(cfg, dev, seed)
            init = pg_train_model(cfg, dev, seed, shape[1] if label == "gpipe" else None)
            step, slot = pg_train_step(label, cfg, init, mesh)
            if not isinstance(step, GraphedTrainStep) or step.refuse:
                raise RuntimeError(f"rank {rank} {label}: the factory returned "
                                   f"{type(step).__name__}, refusal {getattr(step, 'refuse', '')}")
            losses, walls, calls = [], [], []
            for i in range(MC_TRAIN_STEPS):
                collectives.CALLS.clear()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses.append(float(step(slot, tokens)))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
                calls.append(dict(collectives.CALLS))
                if i == 0:
                    grads = pg_gathered(label, cfg, slot, mesh, grads=True)
                    gnorm = math.sqrt(sum(float((g.float() ** 2).sum()) for g in grads.values()))
                    del grads
            after = pg_gathered(label, cfg, slot, mesh)
            start = dict(init.named_parameters())
            ref = torch.load(os.path.join(refdir, f"{label}.pt"), mmap=True)
            worst, diff, moved, sums = 0.0, 0.0, 0.0, []
            for name, p in after.items():
                want = ref[name].to(dev)
                d = (p.detach() - want).abs()
                worst = max(worst, float(d.max()))
                diff += float(d.double().sum())
                moved += float((want - start[name].detach()).abs().double().sum())
                sums.append(int(p.detach().view(torch.int32).sum(dtype=torch.int64)))
            g = next(iter(step.graphs.values()))
            training[label] = dict(losses=losses, walls=walls, calls=calls, gnorm=gnorm,
                                   worst=worst, update_err=diff / moved, checksums=sums,
                                   graph=dict(nodes=g.nodes, replays=g.replays,
                                              wrapper_launches=sum(g.launches.values())))
            del init, step, slot, after, start, ref, g
            gc.collect()
            torch.cuda.empty_cache()
        collectives.CALLS.clear()
        outs, _, train_graphs = pg_callables_run(lambda shape: make_mesh(shape, RING_AXES), dev,
                                                 seed, graphed=True)
        train_calls = dict(collectives.CALLS)
        ref = torch.load(os.path.join(refdir, "callables.pt"), mmap=True)
        errs = {}
        for label, got in outs.items():
            errs[label] = []
            for a, want in zip(got, ref[label]):
                want = want.to(dev)
                e, tol = float((a.float() - want.float()).abs().max()), attn_tol(want)
                if not torch.isfinite(a.float()).all() or e > tol:
                    raise RuntimeError(f"rank {rank} {label} graphed: differs from the "
                                       f"single-process call by {e} > {tol}")
                errs[label].append(e)
        out.put((rank, None, dict(started=started, serving=serving, callables=callables,
                                  training=training, train_callables=dict(
                                      errs=errs, graphs=train_graphs, calls=train_calls))))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise
    finally:
        # NCCL keeps a communicator while a graph that captured it lives:
        # the graphs go first
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()


def multicard_pg_phase(mcfg, ecfg, prompts, n_new, seed, dev, serving_want, callables_want,
                       refdir):
    """Phase 15(c): CARDS ranks (``torch.multiprocessing`` spawn), rank k on
    cuda:k, joined by NCCL through ``maybe_init_distributed()`` under
    torchrun's environment, every step graphed with its collectives inside:
    the engines of 15(a)'s layouts on phase 3's requests, the four serving
    callables, then (while they serve, this process computes 14(a)'s
    single-process references on cuda:0 four times, eager, MC_TRAIN_STEPS
    steps) each of TRAIN_PG_LAYOUTS for MC_TRAIN_STEPS steps and the three
    training callables.  Gates: every rank's engine tokens and last prompt
    token's logits bit-equal to 15(a)'s four-card single-controller engine
    (``serving_want``), the serving callables within attn_tol of 15(a)'s
    (``callables_want``); in training, as 14(a): every rank's losses equal
    and gathered parameters bit-equal, the first loss and the gathered
    gradient norm within TRAIN_LOSS_ATOL and TRAIN_GNORM_RTOL of the single
    process's, the parameters after the steps within TRAIN_PG_UPDATE_RTOL;
    the callables within attn_tol; the ring's and GPipe's point-to-point
    calls ran.  Prints a rank's walls beside the single process's, its
    graphs' nodes and its collective calls.  The references' parameters
    and callables' outputs stay in ``refdir`` (phase 15(d) reads them);
    returns (their figures by layout, rank 0's training figures by
    layout)."""
    import queue

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results, ready = ctx.Queue(), ctx.Event()
    port = free_port()
    procs = [ctx.Process(target=multicard_rank, args=(r, port, mcfg, ecfg, prompts, n_new,
                                                      seed, refdir, ready, results))
             for r in range(CARDS)]
    for p in procs:
        p.start()
    want, _ = train_pg_references(mcfg, seed, dev, refdir, MC_TRAIN_STEPS)
    print(f"15(c) single-process training references: {time.perf_counter() - t0:.3f} s",
          flush=True)
    ready.set()
    ranks, errors = {}, []
    try:
        for _ in procs:
            rank, err, value = results.get(timeout=900)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            ranks[rank] = value
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(CARDS)) - set(ranks))} sent nothing in "
                      f"900 s")
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
        if p.exitcode != 0:
            errors.append(f"a rank exited with code {p.exitcode}")
    if errors:
        fail("15(c): " + "\n".join(errors))
    for label, _, _ in PG_LAYOUTS:
        w = serving_want[label]
        for rank in range(CARDS):
            got = ranks[rank]["serving"][label]
            name = f"15(c) {label}, rank {rank} of {CARDS} on cuda:{rank} (nccl)"
            if got["tokens"] != w["tokens"]:
                fail(f"{name}: tokens differ from 15(a)'s four-card engine's")
            for i, x in w["logits"].items():
                mine = torch.from_numpy(got["logits"][i])
                if not torch.equal(mine, x):
                    fail(f"{name}: request {i}'s last prompt token's logits differ from 15(a)'s "
                         f"by {float((mine - x).abs().max())}")
        r0 = ranks[0]["serving"][label]
        figs = [ranks[r]["serving"][label]["fig"] for r in range(CARDS)]
        print(f"15(c) {label}: {CARDS} NCCL ranks, a card each, graphed: tokens and logits of "
              f"every rank bit-equal to 15(a)'s single-controller engine on cuda:0..{CARDS - 1}; "
              f"rank figures {json.dumps(figs)} beside 15(a)'s "
              f"{json.dumps(serve_figures(w['fig']))}; rank 0's graphs "
              f"{json.dumps(r0['graphs'])} (15(a)'s {json.dumps(w['fig']['graphs'])}); collective "
              f"calls of rank 0's run {json.dumps(r0['calls'])}", flush=True)
    errs = {}
    for rank in range(CARDS):
        for name, x in ranks[rank]["callables"]["outs"].items():
            ref, x = callables_want[name], torch.from_numpy(x)
            e = float((x - ref).abs().max())
            errs[name] = max(errs.get(name, 0.0), e)
            if not torch.isfinite(x).all() or e > attn_tol(ref):
                fail(f"15(c) {name} on rank {rank}: differs from 15(a)'s four-card call by "
                     f"{e} > {attn_tol(ref)}")
    c0 = ranks[0]["callables"]
    print(f"15(c) serving callables graphed over the {CARDS} NCCL ranks against 15(a)'s: "
          f"max_abs_err {json.dumps(errs)} (attn_tol); rank 0's graphs {json.dumps(c0['graphs'])},"
          f" collective calls {json.dumps(c0['calls'])}", flush=True)
    for label, shape, axes, _ in TRAIN_PG_LAYOUTS:
        w, first = want[label], ranks[0]["training"][label]
        name = f"15(c) {label} {dict(zip(axes, shape))}"
        for rank in range(CARDS):
            got = ranks[rank]["training"][label]
            if got["losses"] != first["losses"] or got["checksums"] != first["checksums"]:
                fail(f"{name}: rank {rank}'s losses {got['losses']} or gathered parameters "
                     f"differ from rank 0's ({first['losses']})")
            if got["graph"]["replays"] != MC_TRAIN_STEPS - 1:
                fail(f"{name}: rank {rank}'s graph replayed {got['graph']['replays']} times")
        check_train(name, first["losses"], first["gnorm"], w["losses"][0], w["gnorm"])
        if first["update_err"] > TRAIN_PG_UPDATE_RTOL:
            fail(f"{name}: the gathered parameters after {MC_TRAIN_STEPS} steps part from the "
                 f"single process's by {first['update_err']} of its mean update > "
                 f"{TRAIN_PG_UPDATE_RTOL} (largest element {first['worst']})")
        if label == "gpipe" and not first["calls"][0].get("ppermute"):
            fail(f"{name}: no point-to-point hand-off ran: {first['calls'][0]}")
        walls = [[round(x, 4) for x in ranks[r]["training"][label]["walls"]]
                 for r in range(CARDS)]
        print(f"{name}, {CARDS} NCCL ranks, a card each, graphed: losses {first['losses']} on "
              f"every rank (single process {w['losses']}, first-step diff "
              f"{abs(first['losses'][0] - w['losses'][0])}, tol {TRAIN_LOSS_ATOL}); gathered "
              f"grad norm {first['gnorm']} vs {w['gnorm']} (rtol {TRAIN_GNORM_RTOL}); "
              f"parameters after {MC_TRAIN_STEPS} steps: mean |diff| / mean |update| "
              f"{first['update_err']} (tol {TRAIN_PG_UPDATE_RTOL}), largest {first['worst']}, "
              f"bit-equal on every rank; step wall s by rank {walls} (the first eager and "
              f"captured, then replays; single process on cuda:0, eager "
              f"{[round(x, 4) for x in w['walls']]}); collective calls a step on rank 0 "
              f"{json.dumps(first['calls'])}; rank 0's graph {json.dumps(first['graph'])}",
              flush=True)
    terrs = {label: max(max(ranks[r]["train_callables"]["errs"][label]) for r in range(CARDS))
             for label, _, _ in TRAIN_PG_CALLABLES}
    tc = ranks[0]["train_callables"]
    if not tc["calls"].get("ppermute"):
        fail(f"15(c): the ring callable ran no point-to-point exchange: {tc['calls']}")
    print(f"15(c) training callables at {RING_SHAPE} bf16, graphed over the {CARDS} NCCL ranks "
          f"(forward and backward replays) against the single-process calls: max_abs_err of o, "
          f"dq, dk, dv {json.dumps(terrs)} (attn_tol); rank 0's collective calls "
          f"{json.dumps(tc['calls'])}, graphs {json.dumps(tc['graphs'])}; ranks up in "
          f"{[round(ranks[r]['started'], 3) for r in range(CARDS)]} s", flush=True)
    print(f"phase 15(c): {time.perf_counter() - t0:.3f} s", flush=True)
    return want, {label: ranks[0]["training"][label] for label, _, _, _ in TRAIN_PG_LAYOUTS}


# ---- phase 15(d): one process training across the four cards, graphed ----

# the layouts of 15(d): TRAIN_PG_LAYOUTS, a slot a card, and 12(a)'s (data 2,
# model 4), two slots a card (the mesh's slots on cuda:0..3 in turn)
MC_GRAPH_LAYOUTS = TRAIN_PG_LAYOUTS + (("dense (2, 4)", (2, 4), ("data", "model"), {}),)
# the 12(a) layout on one card printed beside each (its nearest: 12(a) has
# no four-slot layouts)
MC_NEAR_12A = {"dense sp": "(data 2, model 4)", "cp": "(data 2, model 2, context 2)",
               "moe": "moe (data 2, model 4)", "gpipe": f"gpipe (data 2, pipe 4), M {PIPE_MICROBATCHES}",
               "dense (2, 4)": "(data 2, model 4)"}
# the op kernels' tensor-core bodies as torch.profiler names them, and the
# wrappers that launch each (bf16 at max(d, v_d) <= 128)
TC_BODIES = {"fwd_tc_kernel": ("banded_fwd", "flash_fwd", "window_fwd", "resident_fwd"),
             "bwd_tc_kernel": ("banded_bwd", "flash_bwd_fused", "window_bwd", "flash_bwd_dkv")}


def spread(devices_of_slots):
    """A mesh's slots on cuda:0..CARDS-1 in turn."""
    return [cards()[i % CARDS] for i in range(devices_of_slots)]


def spans_cards(wrapper):
    """Whether a graph wrapper captures across cuda:0..CARDS-1, cuda:0 first."""
    return tuple(x.device for x in wrapper.streams) == tuple(cards())


def launches_by_card(run):
    """``run()`` with every wrapper launch tallied: {(kernel, card index):
    launches}."""
    from tf_flash_attention_tpu_torch import native

    tally, launch = {}, native._launch

    def spy(source, name, *args):
        launch(source, name, *args)
        key = (name[3:], next(a.device for a in args if isinstance(a, torch.Tensor)).index)
        tally[key] = tally.get(key, 0) + 1

    native._launch = spy
    try:
        run()
    finally:
        native._launch = launch
    return tally


def tc_kernels_by_card(run, device_ms=None):
    """``run()`` under torch.profiler: {TC_BODIES name: {card index: the
    kernels of that body the profiler saw there}}; ``device_ms``, where
    given, gets each card's device ms (its kernels', copies' and sets'
    durations summed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        sync_cards()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if device_ms is not None:
            device_ms[e.device_index] = (device_ms.get(e.device_index, 0.0)
                                         + e.time_range.elapsed_us() / 1e3)
        for body in TC_BODIES:
            if body in e.name:
                c = out.setdefault(body, {})
                c[e.device_index] = c.get(e.device_index, 0) + 1
    return out


def check_own_shards(name, tally, seen):
    """Fail unless banded_fwd and banded_bwd launched on every card in the
    eager run (``tally``) and a profiled replay ran on each card exactly the
    tensor-core kernels the eager run's wrappers launched there (``seen``):
    each card its own shard's, none of another's.  Returns the counts by
    body and card."""
    for k in ("banded_fwd", "banded_bwd"):
        if any(not tally.get((k, d)) for d in range(CARDS)):
            fail(f"{name}: {k} did not launch on every card: {tally}")
    want = {}
    for body, kernels in TC_BODIES.items():
        by = {d: sum(tally.get((k, d), 0) for k in kernels) for d in range(CARDS)}
        by = {d: n for d, n in by.items() if n}
        if by:
            want[body] = by
    if seen != want:
        fail(f"{name}: a profiled replay ran the tensor-core kernels {seen} by card, the eager "
             f"run's wrappers launched {want}")
    return seen


def update_err(got, want, start):
    """The mean |got - want| over the mean |want - start| of a step's
    parameters ({name: tensor})."""
    diff = sum(float((got[n] - want[n].to(got[n].device)).abs().double().sum()) for n in got)
    moved = sum(float((want[n].to(start[n].device) - start[n]).abs().double().sum())
                for n in got)
    return diff / moved


def multicard_train_layout(layout, mcfg, seed, dev, refdir, ref, rank_15c, compiled_12a):
    """One of MC_GRAPH_LAYOUTS in 15(d): MC_TRAIN_STEPS eager and
    MC_TRAIN_STEPS graphed steps across cuda:0..3 from the same weights,
    gated against each other and against the single process on ``dev``
    (``ref``, its parameters in ``refdir``); one more replay profiled.  A
    second eager run measures how far two eager runs on the same cards
    part (dQ's accumulation is not bit-reproducible), printed beside the
    gates.  Returns the launches by (kernel, card) of an eager step."""
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedTrainStep

    label, shape, axes, extra = layout
    cfg = dataclasses.replace(mcfg, **extra)
    mesh = make_mesh(shape, axes, spread(math.prod(shape)))
    tokens = pg_train_tokens(cfg, dev, seed)
    b, s = tokens.shape[0], tokens.shape[1] - 1
    name = f"15(d) {label} {dict(zip(axes, shape))} on cuda:0..{CARDS - 1}"
    runs = {}
    for run in ("eager", "again", "graphed"):
        init = pg_train_model(cfg, dev, seed, shape[1] if label == "gpipe" else None)
        if run == "eager":
            start = {n: p.detach().clone() for n, p in init.named_parameters()}
        step, params = pg_train_step(label, cfg, init, mesh)
        if not isinstance(step, GraphedTrainStep) or not spans_cards(step):
            fail(f"{name}: the factory returned {type(step).__name__} over "
                 f"{[str(x.device) for x in getattr(step, 'streams', ())]}, not a "
                 f"GraphedTrainStep over the {CARDS} cards")
        fn = step if run == "graphed" else step.eager
        fig = {"losses": [], "gnorms": [], "walls": [], "hosts": [], "spans": []}
        for i in range(MC_TRAIN_STEPS):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync_cards()
            a.record()
            t1 = time.perf_counter()
            if i == 0 and run == "eager":
                out = []
                fig["tally"] = launches_by_card(lambda: out.append(fn(params, tokens)))
                loss = out[0]
            else:
                loss = fn(params, tokens)
            fig["hosts"].append(time.perf_counter() - t1)
            z.record()
            sync_cards()
            fig["walls"].append(time.perf_counter() - t1)
            fig["spans"].append(a.elapsed_time(z))
            fig["losses"].append(float(loss))
            fig["gnorms"].append(grad_norm(params))
        fig["after"] = {n: p.detach().clone() for n, p in params.named_parameters()}
        if run == "graphed":
            if len(step.graphs) != 1:
                fail(f"{name}: {len(step.graphs)} graphs, one expected")
            g = next(iter(step.graphs.values()))
            if g.replays != MC_TRAIN_STEPS - 1:
                fail(f"{name}: {MC_TRAIN_STEPS - 1} steps after the capture made {g.replays} "
                     f"replays")
            fig["graph"] = dict(graph_report(g), pool_by_card=g.pool_by_device)
            fig["device_ms"] = {}
            fig["cards"] = check_own_shards(
                name, runs["eager"]["tally"],
                tc_kernels_by_card(lambda: step(params, tokens), fig["device_ms"]))
        runs[run] = fig
        del step, params, init
        gc.collect()
        torch.cuda.empty_cache()
    eager, again, graphed = runs["eager"], runs["again"], runs["graphed"]
    noise = {"loss_diffs": [abs(a - b) for a, b in zip(again["losses"], eager["losses"])],
              "update_err": update_err(again["after"], eager["after"], start)}
    if graphed["losses"][0] != eager["losses"][0]:
        fail(f"{name}: the first loss {graphed['losses'][0]} is not the eager step's "
             f"{eager['losses'][0]} bit for bit")
    ref_after = torch.load(os.path.join(refdir, f"{label}.pt"), mmap=True)
    errs = {}
    for other, want, want_after in (("eager on the same cards", eager, eager["after"]),
                                    (f"the single process on {dev}",
                                     dict(losses=ref["losses"], gnorms=[ref["gnorm"]]),
                                     ref_after)):
        for i, (x, w) in enumerate(zip(graphed["losses"], want["losses"])):
            if not math.isfinite(x) or abs(x - w) > TRAIN_LOSS_ATOL:
                fail(f"{name}: step {i + 1}'s loss {x} vs {other}'s {w}: > {TRAIN_LOSS_ATOL} "
                     f"(two eager runs on the same cards part by {json.dumps(noise)})")
        for i, (x, w) in enumerate(zip(graphed["gnorms"], want["gnorms"])):
            if abs(x - w) > TRAIN_GNORM_RTOL * w:
                fail(f"{name}: step {i + 1}'s grad norm {x} vs {other}'s {w}: > "
                     f"{TRAIN_GNORM_RTOL} relative (two eager runs on the same cards part by "
                     f"{json.dumps(noise)})")
        errs[other] = update_err(graphed["after"], want_after, start)
        if errs[other] > TRAIN_PG_UPDATE_RTOL:
            fail(f"{name}: the parameters after {MC_TRAIN_STEPS} steps part from {other}'s by "
                 f"{errs[other]} of its mean update > {TRAIN_PG_UPDATE_RTOL}")
    if not graphed["losses"][-1] < graphed["losses"][0]:
        fail(f"{name}: losses {graphed['losses']} do not fall")
    figs = {}
    for run, fig in (("eager", eager), ("graphed", graphed)):
        median = statistics.median(fig["walls"][1:]) * 1e3
        figs[run] = {"step_ms": [round(w * 1e3, 3) for w in fig["walls"]], "median_ms": median,
                     "host_ms": statistics.median(fig["hosts"][1:]) * 1e3,
                     "span_ms": statistics.median(fig["spans"][1:]),
                     "busy_share": statistics.median(graphed["spans"][1:]) / median,
                     "tokens_per_s": b * s / median * 1e3}
    near = MC_NEAR_12A[label]
    p12 = (compiled_12a or {}).get(near, {}).get(True)
    p12 = {k: p12[k] for k in ("median_ms", "host_ms", "span_ms", "busy_share", "graph")
           } if p12 else "n/a"
    c = {k: rank_15c[k] for k in ("walls", "graph")} if rank_15c else "n/a"
    print(f"{name}, one process, graphed (one graph a step across the cards): losses "
          f"{graphed['losses']} (eager on the same cards {eager['losses']}, the first bit-equal;"
          f" single process on {dev} {ref['losses']}); grad norms {graphed['gnorms']} (eager "
          f"{eager['gnorms']}, single process's first {ref['gnorm']}); parameters after "
          f"{MC_TRAIN_STEPS} steps: mean |diff| / mean |update| {json.dumps(errs)} (tol "
          f"{TRAIN_PG_UPDATE_RTOL}); two eager runs on the same cards part by "
          f"{json.dumps(noise)}; figures {json.dumps(figs)}; graph "
          f"{json.dumps(graphed['graph'])}; tensor-core kernels of a profiled replay by card "
          f"{json.dumps(graphed['cards'])}, its device ms by card (kernels, copies and sets "
          f"summed) {json.dumps(graphed['device_ms'])}; 15(c)'s NCCL rank 0 {json.dumps(c)}; "
          f"12(a)'s "
          f"one-card graphed {near} {json.dumps(p12)}", flush=True)
    return eager["tally"]


def multicard_train_callables(seed, dev, refdir):
    """15(d)'s callables: each of TRAIN_PG_CALLABLES on cuda:0..3 (a slot a
    card) at RING_SHAPE bf16, eager and graphed (the first call eager and
    its captures, then a replay of the forward and of the backward graph),
    the replay's output and dQ/dK/dV within attn_tol of the eager call's on
    the same cards and of the single process's on ``dev`` (``refdir``),
    one more call profiled."""
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.parallel import (ring_flash_attention,
                                                       sharded_flash_attention,
                                                       ulysses_flash_attention)
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.graphs import GraphedFunction

    *qkv, do = pg_callable_inputs(dev, seed)
    ref = torch.load(os.path.join(refdir, "callables.pt"), mmap=True)

    def run(f):
        xs = [x.detach().requires_grad_(True) for x in qkv]
        o = f(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do)]

    def timed(f):
        sync_cards()
        t1 = time.perf_counter()
        out = run(f)
        sync_cards()
        return out, (time.perf_counter() - t1) * 1e3

    for label, shape, kind in TRAIN_PG_CALLABLES:
        mesh = make_mesh(shape, RING_AXES, spread(math.prod(shape)))
        fn = {"ring": lambda: ring_flash_attention(mesh, rule=CausalRule()),
              "ulysses": lambda: ulysses_flash_attention(mesh, CausalRule()),
              "sharded": lambda: sharded_flash_attention(mesh, CausalRule())}[kind]()
        name = f"15(d) {label} {dict(zip(RING_AXES, shape))} on cuda:0..{CARDS - 1}"
        if not isinstance(fn, GraphedFunction) or not spans_cards(fn):
            fail(f"{name}: the factory returned {type(fn).__name__}, not a GraphedFunction "
                 f"over the {CARDS} cards")
        tally = launches_by_card(lambda: run(fn.eager))
        want, eager_ms = timed(fn.eager)
        run(fn)                                  # the eager first call and the captures
        got, graphed_ms = timed(fn)              # a replay of each graph
        errs = []
        for part, a, w, r in zip(("o", "dq", "dk", "dv"), got, want, ref[label]):
            for other, x in (("the eager call on the same cards", w),
                             (f"the single process on {dev}", r.to(dev))):
                e, tol = float((a.float() - x.float()).abs().max()), attn_tol(x)
                if not torch.isfinite(a.float()).all() or e > tol:
                    fail(f"{name}: the replay's {part} differs from {other}'s by {e} > {tol}")
                errs.append(e)
        sig = next(iter(fn.graphs.values()))
        if (sig.fwd.replays, sig.bwd.replays) != (1, 1):
            fail(f"{name}: the forward and backward graphs replayed "
                 f"{(sig.fwd.replays, sig.bwd.replays)} times, (1, 1) expected")
        seen = check_own_shards(name, tally, tc_kernels_by_card(lambda: run(fn)))
        graphs = {part: dict(graph_report(g), pool_by_card=g.pool_by_device)
                  for part, g in (("forward", sig.fwd), ("backward", sig.bwd))}
        print(f"{name}, forward and backward, graphed: max_abs_err against the eager call and "
              f"the single process {max(errs)} (attn_tol); ms eager {eager_ms:.3f}, replays "
              f"{graphed_ms:.3f}; graphs {json.dumps(graphs)}; tensor-core kernels of a "
              f"profiled call by card {json.dumps(seen)}", flush=True)
        del fn, sig
        gc.collect()
        torch.cuda.empty_cache()


def multicard_train_phase(mcfg, seed, dev, refs=None, ranks_15c=None, compiled_12a=None):
    """Phase 15(d): one process drives cuda:0..3 in training.  Each of
    MC_GRAPH_LAYOUTS (TRAIN_PG_LAYOUTS a slot a card, and (data 2, model 4)
    two slots a card) at the 168M configuration on phase 6's batch (8 x
    2,048 tokens) with phase 6's AdamW (capturable): MC_TRAIN_STEPS eager
    steps on the four cards and MC_TRAIN_STEPS of the factory's
    GraphedTrainStep over them (the first eager, then one graph across the
    cards, its backward in the capturing thread; then replays).  Gates: the
    factory's step spans the four cards; the first loss bit-equal to the
    eager step's; every loss, every gradient norm and the parameters after
    the steps within TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL and
    TRAIN_PG_UPDATE_RTOL of the eager steps and of the single process on
    ``dev`` (``train_pg_references``: ``refs``, 15(c)'s (folder, figures),
    or made here); every step after the capture a replay; a profiled replay
    runs on each card the tensor-core kernels the eager step launched there.
    Then TRAIN_PG_CALLABLES (``multicard_train_callables``).  Prints the
    walls, host ms, spans, busy shares, graph nodes, pool bytes by card and
    the profiled replay's device ms by card
    beside 15(c)'s NCCL rank (``ranks_15c``) and phase 12(a)'s one-card
    graphs (``compiled_12a``)."""
    import tempfile

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if refs is None:
            refdir = stack.enter_context(tempfile.TemporaryDirectory())
            want, _ = train_pg_references(mcfg, seed, dev, refdir, MC_TRAIN_STEPS)
        else:
            refdir, want = refs[0], dict(refs[1])
        more, _ = train_pg_references(mcfg, seed, dev, refdir, MC_TRAIN_STEPS,
                                      [x for x in MC_GRAPH_LAYOUTS if x[0] not in want],
                                      callables=False)
        want.update(more)
        print(f"15(d) single-process references on {dev}: {time.perf_counter() - t0:.3f} s",
              flush=True)
        for layout in MC_GRAPH_LAYOUTS:
            multicard_train_layout(layout, mcfg, seed, dev, refdir, want[layout[0]],
                                   (ranks_15c or {}).get(layout[0]), compiled_12a)
        multicard_train_callables(seed, dev, refdir)
    print(f"phase 15(d): {time.perf_counter() - t0:.3f} s", flush=True)


def multicard_phases(mcfg, ecfg, prompts, n_new, seed, dev, compiled_11=None, compiled_12a=None):
    """Phase 15 on a host of CARDS cards or more: (a) the single-controller
    engines and serving callables graphed across cuda:0..3, (b)
    ``dryrun_multichip(4)`` on cuda:0..3, (c) CARDS NCCL ranks, a card each,
    graphed, (d) the single-controller training steps and callables graphed
    across cuda:0..3 (``multicard_engines_phase``, ``multicard_pg_phase``,
    ``multicard_train_phase``)."""
    import tempfile

    from tf_flash_attention_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"phase 15 cards: {json.dumps(smi.stdout.strip().splitlines())}", flush=True)
    serving, callables = multicard_engines_phase(mcfg, ecfg, prompts, n_new, seed, dev,
                                                 compiled_11)
    t1 = time.perf_counter()
    dryrun_multichip(CARDS)
    print(f"phase 15(b) dryrun_multichip({CARDS}) on cuda:0..{CARDS - 1}: "
          f"{time.perf_counter() - t1:.3f} s", flush=True)
    with tempfile.TemporaryDirectory() as refdir:
        want, ranks = multicard_pg_phase(mcfg, ecfg, prompts, n_new, seed, dev, serving,
                                         callables, refdir)
        multicard_train_phase(mcfg, seed, dev, (refdir, want), ranks, compiled_12a)
    print(f"phase 15: {time.perf_counter() - t0:.3f} s", flush=True)


if __name__ == "__main__":
    main()
