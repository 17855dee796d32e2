#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
repository's ``src/`` beside this file; imports nothing of JAX or of the
JAX package.  Every path runs in the card's default step mode, "scan"
(each client step, vectorized bucket step, KD step and decode chunk a
captured CUDA graph, src/repro_torch/core/step_graph.py); each profiled
window of phases 5, 8, 11, 14 and 17 runs once under "scan" and once under
"stepped" (REPRO_ENGINE_STEP_MODE), then one line sets the two side by
side.  The training phases 8, 11 and 14 fail if round 2 captures a graph,
the serving phase 5 if the served batch does after the warm-up.

A step program's replays launch its kernels with no wrapper running, so
every launch count checked below is the wrappers' eager launches plus those
the card counted itself: a wrapper whose launch a capture records records
beside it an increment of its slot in a counter on the card, which each
replay runs (repro_torch.kernels.counted).  Each wrapper's eager count
must be above 0 in the same run.  The serving phases 5 and 17 read the
launches from a third batch.

The program contracts (src/repro_torch/analysis): phases 5, 8, 11, 14, 18
and 35 each hold one steady-state scope under TraceGuard and sync_contract
(the card's sync debug mode "error" and the funnel over torch.Tensor's
materialisations) and print a "contracts" line; the run fails unless the
scope captured no graph, built or loaded no kernel, made no un-annotated
device->host sync and launched each kernel of its path: phase 5 the
third batch's first step (8 admissions and a decode chunk, kernel 1),
phases 8 and 11 round 2 (kernels 2-4, and 5 on the vectorized engine),
phase 14 round 2 (kernels 9-10), phase 18 round 3 of each async and
fused run (kernels 2-4, and 5 vectorized), phase 35 round 2 of the vmap
and the shard_map run (kernels 2-5).  The launches are
kernels.Snapshot copies on either side of the scope (no host wait; in
phase 18 they also wait for the KD lane on the card, not on the host).
Before phase 5 two planted violations must raise: a .item() inside a
contract (through the funnel, and through the card layer with the funnel
bypassed), and a step program fed a new shape inside a TraceGuard, which
must name it.  Every bound is utils/hlo.roofline's over H100Spec.
Phases, each of which fails the run if it fails:

  1. card      name and power limit (nvidia-smi); TF32 off for matmul/cuDNN
  2. build     every kernel under src/repro_torch/kernels/csrc, one nvcc each,
               all started together; the HGMMA count of each bf16 instance
               of kernel 12 and of each instance of kernels 9 and 10's
               shared GEMM in the built SASS (cuobjdump -sass from nvcc's
               toolkit): an instance with none, a kernel with no instance,
               or no cuobjdump fails the run
  3. kernel    paged_decode against its plain version at the Qwen2.5-14B
               shapes (B=8, Hkv=8, G=5, dh=128, bs=16; ragged lens with 0, 1,
               bs, bs+1 and 2048; a windowed case), Gemma's (Hkv=1, G=8,
               dh=256), StableLM-3B's (Hkv=32, G=1, dh=80) and
               StarCoder2-3B's (Hkv=2, G=12, dh=128, lens 0 to 20,512 on
               both sides of its window, with window 4,096 and without),
               f32 and bf16, with CUDA-event timings; then the edges of its
               split-K at starcoder2-3b's and qwen2.5-14b's shapes: seq_len
               0, 1, 16k +- 1, live ranges ending on a split boundary, lo
               inside a block, first blocks wholly before the window, and
               tables far longer than every row (empty splits); and at the
               last families' shapes: llama4-maverick's (Hkv=8, G=5, dh=128,
               window 8,192, lens 0, 1, 8,191, 8,192, 8,193 and 10,240) and
               llava's (Hkv=8, G=4, dh=128, no window), each timed
  4. f32/2     qwen2.5-14b at full width, 2 layers, f32: ContinuousEngine and
               generate_static give identical greedy tokens
  5. bf16/48   qwen2.5-14b as configured (48 layers, bf16, random weights
               made on the card): ContinuousEngine serves 16 requests; checks
               token counts, the drained pool, 48 kernel launches per decode
               micro-step (over 8 more requests, counted), and one decode
               step's logits kernel vs plain;
               then one chunk with every lane busy under torch.profiler:
               wall and device ms per micro-step, idle share, kernel times,
               kernel 1's share of the device time and the kernel launches
               per micro-step beside the 3,429 of kernel 1's one-CTA-per-
               head design
  6. KD       ensemble_softmax, kd_loss_fwd and kd_loss_bwd against their
               plain versions, f32 and bf16: at the FedSDD round's own shapes
               (M = K·R = 8 teachers over 8 server batches of 256, V = 10),
               at the reference's sweep, at V = 152,064 (Qwen2.5's
               vocabulary) with M = 4, B = 256, and at V = 256,000
               (gemma-2b's, the LM task's dense path) with M = 8, B = 512;
               CUDA-event timings beside the HBM bound and a library
               composition, and launch_floor_ms, one launch of an empty
               kernel (torch.cuda._sleep(0)) under the same timer
  7. f32 round ResNet-20 (classification_task, 8 clients), fedsdd K=4 R=2,
               2 rounds, twice from the same weights made on the card: with
               the kernels and with the three wrappers patched to their plain
               versions; cuDNN deterministic.  Main model within 2e-4, models
               k>0 bit-identical (KD never touches them)
  8. ResNet-56 the paper's model at full depth and width: fedsdd K=4 R=2 over
               20 clients (participation 0.4, CIFAR-10's 50,000 training
               images as the data scale), local_epochs=1, distill_steps=200,
               2 rounds through make_runner(...).run; checks the history, 8
               teachers, the kernels' launch counts (2 / 400 / 400) and that
               models k>0 differ from the main one; then 10 client steps and 10
               KD steps under torch.profiler; the KD kernels' rows at the
               round's own inputs, each with phase 6's launch floor and its
               f32 time at gemma-2b's vocabulary (lm_ms, lm_bound_ms)
  9. weight_avg multi_weighted_average (kernel 5) against its plain version
               at G = 4, N = 2 for every ResNet-56 leaf and the leaves
               flattened to D = 855,578, the reference sweep (3, 5, 517) and
               (4, 8, 16,777,219); the ResNet-56 tree (169 leaves) in one
               launch through group_weighted_average_pytree, with one
               einsum a leaf and one einsum over the leaves flattened as
               yardsticks; weighted_average (kernel 6) at N = 32, D =
               16,777,219; f32 and bf16, CUDA-event timings beside the HBM
               bound and torch.einsum as the library yardstick
 10. vec CNN   classification_task(model="cnn"), 8 clients, fedsdd K=4 R=2,
               2 rounds on the vectorized and the sequential engine from the
               same weights made on the card, cuDNN deterministic: all K
               models within 2e-4; kernel 5 launched once a round
 11. vec R-56  phase 8's configuration with execution="vectorized": per round
               t_local, t_kd, real and padded client steps, peak memory;
               kernel 5 launched once a round (169 leaves in one table), the
               KD kernels 2 / 400 / 400; kernel 5 at the last round's own
               Eq. 2 inputs through the tree call, beside the same inputs
               one launch a leaf (the "before" row); then one bucket's 10
               vmapped steps under torch.profiler
 12. Flash-KD  kernels 7-10 (flash_kd.cu) against their plain versions: 7/8 at
               rows 1, 5, 512 x V 517, 50,304, 256,000, f32 and bf16 caches,
               teacher lse on and off; 9/10 at D = 2,048 over the same rows and
               V with gemma-2b's tied head, and every option (untied, bias, f32
               cache, no lse) at (5, 50,304) and (512, 517), a bf16 head at two
               shapes; CUDA-event timings at 512 x 2,048 x 256,000 beside the
               bound, the plain version and a library composition, and the
               same for kernels 9 and 10 at deepseek-v2-lite-16b's untied head
               (512 x 2,048 x 102,400) and at the last families' untied
               heads, llama4-maverick's 512 x 5,120 x 202,048 (W 4.1 GB in
               f32), hubert-xlarge's 512 x 1,280 x 504 and llava's 512 x
               4,096 x 32,000; kernels
               9 and 10's bounds count the bf16 tensor-core products they
               run (3 and 9 with an f32 head: each product as hi·hi + hi·lo
               + lo·hi), with the f32 CUDA-core bound and the one-product
               bound beside each
 13. LM f32    gemma-2b reduced with V = 50,304, lm_task (8 clients, 512 KD
               rows), fedsdd K=4 R=2, 2 rounds from the same weights made on
               the card, deterministic algorithms on: head-fused and unfused
               Flash-KD (f32 cache) with the kernels and with the four wrappers
               patched to their plain versions, the head-fused run with the
               default bf16 cache both ways, and the dense KD kernels 2-4; main
               model within 2e-4 and models k>0 bit-identical for each pair and
               against dense (k>0 are never distilled: that shows the client
               side repeats); kernels 7/8 or 9/10 launched 20 x 2 times; the
               same rounds without KD give the main model's KD change, printed
               beside the tolerance
 14. gemma-2b  full width (d_model 2,048, 8 heads of 256, 1 KV head, d_ff
               16,384 GeGLU, V 256,000, tied), 2 of 18 layers, f32: lm_task(8
               clients x 8 docs of 128 tokens, 2 server batches of 4), fedsdd
               K=4 R=2, distill_steps 20, head-fused Flash-KD with the default
               bf16 cache, the teacher ring stored in bf16; per round t_local,
               t_kd, the cache build, peak memory, the CUDA graphs' pool
               and kernels 9/10's launches (20 each); then the round's own
               KD program (20 steps) under torch.profiler, kernels 9 and
               10's device time and share of the step, beside the same
               profile with kernel 9 on the f32 CUDA cores
 15. flash     kernels 11-12 (flash_attention.cu): first their own path, the
               reference's kernel bench and tests through the public ops
               (counts zeroed before, read after); then against their plain
               versions: the reference sweep, dh 80 and dh 256, f32 and
               bf16; the four registered configs' full widths at S =
               4,096, causal, f32 and bf16; starcoder2-3b's window 4,096 at
               S = 16,384; one
               backward at qwen2.5-14b's width; decode at the bench shape and
               at qwen2.5-14b's decode_32k per card, cache_len 0 (the mean of
               V), 1, 700, S - 1, S; CUDA-event timings beside the bound, the
               plain version and scaled_dot_product_attention
 16. sc2 f32   starcoder2-3b at full width, 2 layers, f32: ContinuousEngine
               == generate_static within the window; a 20,480-token prompt
               (block-local sliding_attention prefill) served through kernel
               1 and through its plain version with identical tokens
 17. sc2 bf16  starcoder2-3b as configured (30 layers, bf16): ContinuousEngine
               serves 8 requests, prompts 32-2,048 tokens and one of 20,480;
               token counts, the drained pool, 30 launches of kernel 1 per
               decode micro-step; tokens/s, TTFT p50, the long prefill, peak
               memory; a profiled decode chunk as in phase 5 (launches per
               micro-step beside the earlier design's 2,360)
 18. overlap   phases 8 and 11's FedSDD configuration, 3 rounds from the
               same weights under sequential off and async on ResNet-56, and
               sequential off and vectorized off, async and fused on
               ResNet-20 (the depth cut to keep the run within its time
               limit) (overlap=..., core/round_plan.py), cuDNN
               deterministic: per round t_round and t_local (t_kd under off),
               captures and paired-program captures, the drain's seconds,
               launches (kernels 2 / 3 / 4: 3 / 600 / 600 in every mode,
               kernel 5 once a round vectorized), peak memory; the drained
               models against off: sequential within 2e-4; vectorized
               printed beside the two engines' own spread (vectorized off
               against sequential off), fused within 2e-4 of async, and
               phase 10's CNN 3 rounds vectorized under off, async and
               fused within 2e-4; overlap_summary (the port's
               scheduler) of off's round-3 t_local and t_kd against the
               mode's round-3 t_round; after each async run, its own KD
               step program and client (bucket) step program timed with
               CUDA events alone, issued together on the two streams and,
               vectorized, as paired programs: the milliseconds hidden (the
               two alone less together; it must be above 0)
 19. legacy    one round of that configuration with kd_pipeline="legacy"
               (the host-loop oracle: kernel 2 once a server batch, kernels
               3-4 eagerly) against the fused pipeline within 2e-4; paper
               Table 5's metric on phase 18's sequential off run after 3
               rounds: the K*R = 8 teacher ensemble's accuracy on the task's
               test set (ensemble_eval_fn), beside the main model's
 20. robust    seeded faults (FaultPlan: dropout 0.2, stragglers 0.3,
               corruption 0.1, sign-flip attacks 0.15 at scale 10, spill
               failures 0.5), aggregator="trimmed_mean", clip_norm=2.0,
               teacher_trust, the spilling store, cuDNN deterministic:
               (a) phase 10's CNN, 3 rounds on each engine from the same
               weights: fault fields equal across engines and to the host's
               own draws, models within 2e-4, no capture in rounds 2-3, I/O
               retries fired, a vectorized save_state's npz within 1% (plus
               4 KB) of its leaves' bytes; (b) phase 8's ResNet-56
               configuration, sequential, 2 rounds: trust weights summing to
               1, kernel 2 over the weighted M = 1 stack against its plain
               version (the KD tolerance), launches 2 / 400 / 400, the last
               round's robust Eq. 2 on the card against the port's CPU run of
               the same stacked updates (rtol 1e-6, atol 1e-7), Krum's score
               gap printed; (c) kill and restart, on ResNet-20 (the depth
               cut to keep the run within its time limit): sequential,
               overlap="async", SCAFFOLD, the spilling store, the ring in
               bf16; 3 rounds
               uninterrupted against 2 rounds, save_state with the KD job in
               flight, a fresh runner restored, round 3 and the drain: models
               and c_global bit for bit; save and restore seconds, the
               checkpoint's and the pending spill's bytes
 21. FedBE+sec phase 8's ResNet-56 configuration, sequential, one round each:
               fedbe (FedDF's 8 client teachers, 10 posterior samples and the
               main aggregate: 19 teachers counted; every sample's draws
               standardised by the stated Gaussian, mean and variance within
               1e-2 of N(0, 1) over all elements) and fedsdd K=4 R=2 with
               secure_aggregation (each group's masked mean against plain
               Eq. 2 at the reference's rtol 1e-3 / atol 1e-4, every upload
               more than 1.0 from its raw model); t_local of both; kernels
               2-4 launched
 22. ds f32/2  deepseek-v2-lite-16b at full width (MLA + MoE: 16 heads of
               192 / 128, rank 512, 64 experts top-6 + 2 shared), 2 layers
               (dense layer 0, one MoE layer), f32, capacity factor 64 (no
               drops): generate_static's greedy tokens equal the argmax of
               a full forward over the same tokens, and the absorbed MLA
               decode's logits within 1e-4 of the logits' scale of the
               expanded form's; its tokens under "scan" (the decode step one
               captured graph, src/repro_torch/serve/static.py) equal those
               under "stepped", and a second parameter set of the same
               shapes served under "scan" gets its own stepped tokens (the
               program rebuilt for it and again for the first: 2 captures)
 23. ds bf16   deepseek-v2-lite-16b as configured (27 layers, bf16, 15.7 B
               parameters, random weights made on the card): the static path
               serves 8 prompts of 256 tokens, 32 new tokens each (MLA has no
               paged path); tokens/s, TTFT, peak memory; one decode step's
               wall, device and idle share and the device ms of the MoE FFNs
               and MLA decodes (named ranges under torch.profiler), beside
               its bytes bound (all weights but the embedding, and the
               expert banks alone: a group of 8 tokens has capacity 8 in
               every one of the 64 experts); then the static decode under
               "scan" and "stepped" (static_modes, 8 new tokens)
 24. ds FedSDD deepseek-v2-lite-16b reduced, f32: 2 head-fused Flash-KD rounds
               with kernels 9/10 and with their plain versions from the same
               weights, deterministic algorithms (as phase 13), within 2e-4;
               then at full width, 2 layers, f32: fedsdd K=2 R=2 over 4
               clients, 2 rounds, head-fused Flash-KD, the ring in bf16, as
               phase 14 drives gemma-2b: t_local, t_kd, the cache build, peak
               memory (under 76 GB), captures, kernels 9/10's launches (20 a
               round), a profiled KD step; then one vectorized round (K=2, 2
               clients, its client engine stepped: the bucket program's
               static buffers and graph pool for a 2-client stack of 4.34 GB
               models do not fit beside the round) whose Eq. 2 launches
               kernel 5 over the MoE tree, and kernel 5 against its plain
               version over that tree at G = 2, N = 2, timed
 25. xl f32/8  xlstm-1.3b at full width (d_model 2,048, 4 heads of 512, V
               50,304 untied), 8 layers (two superblocks of three mLSTM and
               one sLSTM), f32: decode token by token from an empty state
               equals a full forward over the same 128 tokens, and a prefill
               of the first 64 (one chunk) followed by decode of the rest
               equals the forward on the back half, both within 5e-4 of the
               logits' scale (the reference's decode-consistency check); the
               states f32; generate_static over 48 + 16 tokens gives the
               same tokens under "scan" and "stepped"
 26. xl bf16   xlstm-1.3b as configured (48 layers, bf16, random weights made
               on the card): the static path serves 8 prompts of 224 tokens,
               32 new tokens each (L + new = 256, a multiple of the chunk 64;
               the recurrent families have no paged path); tokens/s, TTFT
               (the padded prefill), peak memory; one decode step's wall,
               device and idle share and the device ms of the mLSTM and
               sLSTM decodes (named ranges under torch.profiler), beside the
               step's bytes bound (the weights but the embedding, each state
               read and written once); then the static decode under "scan"
               and "stepped" (static_modes, 184 + 8 tokens)
 27. xl FedSDD (a) xlstm-1.3b reduced, f32: 2 head-fused Flash-KD rounds with
               kernels 9/10 and with their plain versions from the same
               weights, deterministic algorithms, within 2e-4; (c) full
               width, 24 layers, f32: one vectorized round (K=2, 2 of 4
               clients, no KD steps, the bucket step captured) whose Eq. 2
               launches kernel 5 over the xLSTM tree, and kernel 5 against
               its plain version over that tree at G = 2, N = 2, timed; (d)
               kernels 9/10 against their plain versions at xlstm's head (512
               x 2,048 x 50,304, untied, f32 head, bf16 cache), timed; (b) full
               width, f32, 24 layers (the depth cut to keep the run within
               its time limit; the peak reckoned from phase 24's peak per
               model byte): fedsdd K=2 R=2 over 4 clients, 2 rounds, lm_task
               of 8 docs of 128 tokens, head-fused Flash-KD, the ring in bf16:
               t_local, t_kd, the cache build, peak memory (under 76 GB),
               captures (none in round 2), kernels 9/10's launches (20 a
               round)
 28. jb f32/2  jamba-1.5-large-398b at full width (d_model 8,192, d_inner
               16,384, d_state 16, 64 heads / 8 KV, 16 experts top-2 of
               24,576), 2 layers with attn_period 2 ((Mamba, dense), (GQA,
               MoE); 11.9 B parameters, 47.6 GB), f32, capacity factor 8
               (each expert's capacity is the group's token count: no
               drops): decode from an empty state over 128 tokens (one
               chunk) equals the full forward within 5e-4 of the logits'
               scale; generate_static over 112 + 16 tokens gives the same
               tokens under "scan" and "stepped"
 29. jb bf16   jamba at full width cut to the reference's reduced() schedule
               (4 layers, attn_period 4: Mamba/dense, Mamba/MoE, Mamba/dense,
               GQA/MoE; 23.0 B parameters, 46 GB), bf16, capacity factor 8:
               the bf16 decode over the first 128 tokens against the forward
               (printed; phase 28 checks the f32 one); the static path serves
               4 prompts of 224 + 32 new tokens (256, a multiple of the chunk
               128); tokens/s, TTFT, peak memory; a decode step's wall,
               device, idle share, the Mamba and MoE ranges, beside its bytes
               bound (every weight but the embedding, the states read and
               written once, the live K/V read once); then the static decode
               under "scan" and "stepped" (static_modes, 120 + 8 tokens)
 30. jb FedSDD jamba reduced, f32: 2 head-fused Flash-KD rounds, kernels 9/10
               against their plain versions, as phase 27 (a)
 31. l4 f32/2  llama4-maverick-400b-a17b at full width (d_model 5,120, 40
               heads / 8 KV of 128, window 8,192, V 202,048, top-1 + 1
               shared expert of 8,192), 2 layers (MoE at layer 0, dense at
               1), f32, 32 of its 128 experts (6.5 B parameters, 26 GB; 128
               would be 74 GB), capacity factor 32 (no drops): decode from
               an empty cache over 128 tokens equals the full forward within
               5e-4 of the logits' scale; generate_static's tokens under
               "scan" equal "stepped"'s; the ContinuousEngine's (kernel 1)
               equal generate_static's for 6 requests within the window
 32. l4 bf16   llama4-maverick at full width, 2 layers, all 128 experts (18.5
               B parameters, 37 GB), bf16, capacity factor 1.25: the
               ContinuousEngine serves 8 requests of 32-2,048 tokens and one
               of 10,240 (past the window); token counts, the drained pool,
               2 launches of kernel 1 per micro-step (counted), tokens/s,
               TTFT p50, peak memory; a profiled chunk under each step mode
               (the MoE FFN's named range in the eager one) beside the
               micro-step's bytes bound (every weight but the embedding);
               then static_modes (8 prompts of 256 + 8)
 33. llava     llava-next-mistral-7b as configured (32 layers, bf16, 7.3 B
               parameters): the ContinuousEngine serves 16 text requests;
               32 launches of kernel 1 per micro-step, tokens/s, TTFT, a
               profiled chunk beside its bytes bound; one prefill over the
               prefix budget (2,880 patch embeddings + 128 text tokens),
               timed, finite logits; then static_modes
 34. frontends (a) llama4-maverick, hubert-xlarge and llava reduced, f32: 2
               head-fused Flash-KD rounds with kernels 9/10 and with their
               plain versions, within 2e-4 (as phase 27 (a)); (b)
               hubert-xlarge at full depth and width (48 layers, f32, 0.95 B
               parameters; peak reckoned at phase 24's 12.2 GB a model GB):
               fedsdd K=2 R=2 over 4 clients, 2 rounds of 8 docs of 128
               frames, head-fused Flash-KD, bf16 ring: t_local, t_kd, the
               cache build, peak (under 76 GB), no capture in round 2,
               kernels 9/10 20 times a round; before them one vectorized
               round of 2 clients (its client engine stepped, as phase 24's)
               whose Eq. 2 launches kernel 5 over hubert's tree, and kernel 5
               against its plain version over it, timed; (c) llava
               at full width, 2 layers, f32: the same rounds over 2 docs a
               client of 3,072 tokens, client batch 2, one doc a server
               batch (1,536 spliced patch embeddings a doc; the loss scores
               positions 2,880-3,071, so the client loss is above 0)
 35. shard_map ResNet-20 FedSDD (phase 8's 20 clients at participation 0.4,
               K=4 R=2, 200 KD steps), execution="vectorized", 2 rounds from
               the same weights made on the card, cuDNN deterministic, with
               client_sharding="vmap" and "shard_map" over a one-rank NCCL
               group (a FileStore in a temporary directory: no network):
               models k>0 bit for bit, the main model within 2e-4 (the
               sharded teacher pass sums the members before kernel 2, on an
               M = 1 stack), launches 2 / 400 / 400 and kernel 5 2 in both;
               round 2 of each under the contracts; a "collectives" line a
               round (collective_stats: the engine's all-gathers, and the
               teacher all-reduce of the server set's 8 x 256 x 10 f32 logit
               sum, 81,920 bytes); t_local and t_kd of both runs
 36. round fn  core/distributed.py at gemma-2b's full width, 2 of 18 layers,
               f32: make_fedsdd_round_fn with K=2 groups of N=2 clients (a 1 x
               512-token batch each, one local step) and a 4 x 512-token
               server batch (kernels 2/3/4 over 2,048 rows x V 256,000), then
               make_distill_step_fn over M = 4 teachers, each with the kernels
               and with the three wrappers patched to their plain versions,
               deterministic algorithms: models k>0 bit for bit, the main
               model (and the distilled student) within 2e-4, and each
               step's update (new - old parameters) the same in both runs
               within 1e-5 of its largest value beyond one ulp of the new
               parameter, where a step that moved nothing would show at
               least 1e-3 (the update's size printed); kernels 2/3/4 against their plain versions on the
               path's own tensors (the M = 2 and M = 4 teachers' logits and
               the student's over the 2,048 server rows, phase 6's
               tolerances); kernels 2/3/4 launched 1/1/1 a call; CUDA-event
               ms of each call (after one warm-up call of each) and its peak
               beside the peak reckoned before the run (under 76 GB)
 37. dry run   (b) gemma-2b at full width, 2 layers, f32: the train step of
               launch/steps.py (remat=True) at 2 x 4,096 tokens counted by
               launch/dryrun.py on a one-rank fake world, then run on the
               card from random weights: the counted FLOPs, bytes and peak,
               the bound (H100Spec, f32), the warm CUDA-event ms and the
               bound's share of it, max_memory_allocated against the
               counted peak; (a) python -m repro_torch.launch.dryrun --arch
               gemma-2b --shape train_4k in a subprocess with no card
               visible (300 s limit): the pod1 record's FLOPs, bytes,
               collective bytes, peak and seconds under this machine's torch
 38. kernels   one JSON line per the port's kernel contract; kernel 12's
               entry is its bf16 row at qwen2.5-14b's width (the configs'
               dtype), with the f32 row beside it under "f32"; kernel 1's
               also gives "starcoder2_ms", its times in the two starcoder2-3b
               bf16 cases its split-K was designed for; kernels 2, 3 and
               4's add "launch_floor_ms" and their f32 time at gemma-2b's
               vocabulary ("lm_ms", "lm_bound_ms", "lm_library_ms"); kernel
               5's is the tree call at the round's inputs, with the einsum
               over the leaves flattened ("flat_library_ms") and the same
               inputs one launch a leaf ("before_loop_ms"), and under
               "deepseek" its row over deepseek-v2-lite-16b's 2-layer tree
               (phase 24); kernels 9 and 10's add "deepseek", their rows at
               deepseek-v2-lite-16b's head (phase 12); kernel 5's "xlstm"
               is its row over the 24-layer xLSTM tree and its launch in
               that vectorized round, kernels 9 and 10's "xlstm" their rows
               at xlstm-1.3b's head and their launches in phase 27 (b)'s
               rounds (and (a)'s, "reduced_launches"); kernel 1's
               "llama4" and "llava" its bf16 rows of phase 3 at their shapes
               and its launches on phases 32 and 33's counted batches;
               kernels 9 and 10's "llama4", "hubert" and "llava" their rows at
               those heads (phase 12) and their launches in phase 34 (llama4:
               its reduced rounds); kernel 5's "hubert" its row over hubert's
               tree and its launch in that vectorized round; kernel 5's
               "shard_map_launches" and kernels 2-4's "shard_map_launches",
               "round_fn_launches" and "distill_step_launches" their launches
               on phases 35 and 36's paths; every entry's "host_ms" is its
               wrapper's host time a call
 39. ok        {"ok": true, "device": {...}} as the last line

Static decode (phases 22-29).  The static path's default on a card is
"scan": the prefill eager, then each decode step one replay of a captured
graph.  static_modes runs the same prompts under each mode: a warm call of
the same shape, a timed call (TTFT, the decode's wall per step, tokens/s,
the graphs captured, which must be 0), and a call whose decode runs under
torch.profiler (device and busy ms per step, the idle share against the
timed wall, the kernels the card ran and the kernel and graph launches the
host made per step); one "scan vs stepped: static decode <arch>" line sets
them side by side with the tokens on which the two modes agree (bf16: only
printed; the f32 phases 22, 25 and 28 check them equal).  Phases 22, 23,
25, 26, 28 and 29 each end with "released": once the phase has dropped its
model, the card's allocated memory is within 0.25 GB of its value before
the phase and no static decode program is left (the programs go with
their model).

Tolerances, the recurrent families (phases 25-29): decode against the
full forward within 5e-4 of the logits' largest magnitude, the reference's
5e-4 at its reduced models' O(1) logits; f32 only: a bf16 decode from an
empty state runs Mamba's conv in f32 (the state's dtype, as the reference
promotes) where the forward runs it in bf16, so the two round apart by
far more than 5e-4.

Tolerances, paged_decode: f32 kernel vs plain at rtol = atol = 1e-5 (only
the order of summation differs).  bf16 per (request, query head) row: the row's max
|kernel - plain| is at most 1.6e-2 of its max |plain|, four bf16 ulps at
that value.  The plain version rounds the scaled query and its
probabilities to bf16 before P·V (as the reference's decode_attention
does), the kernel keeps both in f32, and both round the output once.  A
long row averages many values down to a small output, so the bound
follows each row's own scale: one tile of a 2048-token row left out
moves the row by several percent of it.

Tolerances, the KD kernels (both sides compute in f32 from the same
inputs): f32 per row, max |kernel - plain| at most 1e-5 of the row's max
|plain|, probabilities from bf16 teacher logits too (the same f32
arithmetic on the same bf16 values; the reference's atol 2e-3 is hundreds
of times a probability at an LM's V); the loss at rtol 1e-4; a bf16
gradient per row at 8e-3 of its max |plain| (two bf16 ulps: both sides
round once).  A gradient
row also gets 1e-6·|g|·τ/B absolute: it is (p − t)·g·τ/B with p, t ≤ 1,
so f32 leaves about 1e-7 of that scale as noise, and a row the student
already matches (the distilled model's, at the round's own inputs) has a
max |plain| near that noise.

Tolerances, weight_avg (both sides sum the same f32 products in another
order): f32 at rtol 1e-5, atol 1e-6, the reference's own; bf16 within one
bf16 ulp of the plain result plus 2^-22 of sum_n |w_hat_n x_n| (the two f32
sums differ by a few f32 ulps of their terms, which a result much smaller
than its terms does not absorb).  The vectorized CNN round against the
sequential one: every model within 2e-4, the port's runner-parity
tolerance.

Tolerances, flash attention (kernels 11-12; both sides compute in f32 from
the same inputs and round the output once): f32 at rtol = atol = 1e-5; bf16
within one bf16 ulp of each row's max |plain| plus 2e-5.  The backward
recomputes through the plain chunked attention, held against autograd of
the plain version at 1e-4 (the reference's gradient test) of the largest
gradient, or absolute below 1.

Tolerances, Flash-KD (both sides compute in f32 from the same inputs, in
other orders): the loss at rtol 1e-5 (kernel 7) or 1e-4 (kernel 9, whose
student logits are sums of D = 2,048 products formed in the kernel) plus
2^-22·tau^2·max|lse| (KL = cross - lse_t + lse_s cancels terms of size
|lse|); the normalisers at rtol 1e-5 plus 2^-22·max|lse|; a logit gradient
within 1e-5 of (|q| + |p|)·|g|·tau/B per element, the magnitude of what it
subtracts, plus one bf16 ulp in bf16; the head's gradients within 2^-14 of
the sum of the magnitudes of the products each element adds up (up to
256,000 of them: u·sqrt(K) for K up to a million), plus one bf16 ulp in bf16.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

# the H100 SXM's roofline constants, from repro_torch.utils.hlo.H100Spec
# (use_h100_spec, once src/ is importable): HBM's rate and the peak rate
# for each type, f32 on the CUDA cores and bf16 on the tensor cores (dense)
SPEC = None
HBM_BYTES_PER_S: float = 0.0
PEAK_FLOPS: dict = {}
PAGED_DECODE_TPU = "src/repro/kernels/flash_attention/kernel.py:226"
F32_TOL = 1e-5                                 # rtol = atol, elementwise
BF16_ROW_TOL = 1.6e-2                          # of each row's max |plain|
KD_TPU = {"ensemble_softmax": "src/repro/kernels/kd_loss/kernel.py:57",
          "kd_loss_fwd": "src/repro/kernels/kd_loss/kernel.py:88",
          "kd_loss_bwd": "src/repro/kernels/kd_loss/kernel.py:120"}
KD_SOURCE = "src/repro_torch/kernels/csrc/kd_loss.cu"
KD_F32_ROW_TOL = 1e-5                          # of each row's max |plain|
KD_LOSS_RTOL = 1e-4
KD_BF16_GRAD_ROW_TOL = 8e-3                    # of each row's max |plain|
KD_GRAD_ATOL = 1e-6                            # × |g|·τ/B, the gradient's own scale
ROUND_TOL = 2e-4                               # main model, kernels vs plain
KD_PATH = ("ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd")   # kernels 2-4 on a round
WA_TPU = {"multi_weighted_average": "src/repro/kernels/weight_avg/kernel.py:53",
          "weighted_average": "src/repro/kernels/weight_avg/kernel.py:29"}
WA_SOURCE = "src/repro_torch/kernels/csrc/weight_avg.cu"
WA_RTOL, WA_ATOL = 1e-5, 1e-6
FLASH_TPU = {"flash_kd_fwd": "src/repro/kernels/kd_loss/flash.py:438",
             "flash_kd_bwd": "src/repro/kernels/kd_loss/flash.py:500",
             "flash_kd_head_fwd": "src/repro/kernels/kd_loss/flash.py:608",
             "flash_kd_head_bwd": "src/repro/kernels/kd_loss/flash.py:698"}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_kd.cu"
FLASH_LOSS_RTOL = 1e-5                         # kernel 7
FLASH_HEAD_LOSS_RTOL = 1e-4                    # kernel 9: its logits are sums of D products
FLASH_LSE_RTOL = 1e-5
FLASH_GRAD_TOL = 1e-5                          # of (|q| + |p|)·|g|·τ/B
ULP_LSE = 2.0 ** -22                           # × τ²·max|lse| for the loss
SUM_TOL = 2.0 ** -14                           # of the summed magnitudes (head gradients)
FA_TPU = {"flash_forward": "src/repro/kernels/flash_attention/kernel.py:87",
          "flash_decode": "src/repro/kernels/flash_attention/kernel.py:151"}
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_F32_TOL = 1e-5                              # rtol = atol, elementwise
FA_GRAD_TOL = 1e-4                             # the reference's gradient test
DEV = "cuda"


def use_h100_spec() -> None:
    """Every bound below from ``repro_torch.utils.hlo``: ``H100Spec``'s
    constants and ``roofline``'s terms (``_bound``)."""
    global SPEC, HBM_BYTES_PER_S, PEAK_FLOPS
    from repro_torch.utils.hlo import H100Spec
    SPEC = H100Spec()
    HBM_BYTES_PER_S = SPEC.hbm_bandwidth
    PEAK_FLOPS = {torch.float32: SPEC.peak_flops_f32, torch.bfloat16: SPEC.peak_flops_bf16}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


T_START = time.perf_counter()


def phase(name: str) -> None:
    gc.collect()            # what the last phase left in cycles goes before the next
    mem = (f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
           f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved"
           if torch.cuda.is_initialized() else "")
    print(f"\n== {name} (at {time.perf_counter() - T_START:.1f} s{mem})", flush=True)


RELEASE_SLACK_GB = 0.25   # a new stream's cuBLAS workspace and the like stay


def holding() -> tuple:
    """What the card holds now: allocated bytes and static decode programs."""
    return torch.cuda.memory_allocated(), static_programs()


def released(before: tuple, label: str) -> None:
    """Once a phase has dropped its model: the card's allocated memory is
    back near its value before the phase (``before``, from ``holding``) and
    no static decode program (graph pool, buffers) outlived the model."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0, progs0 = before
    left = (torch.cuda.memory_allocated() - mem0) / 1e9
    progs = static_programs() - progs0
    print(json.dumps({"phase": f"released: {label}", "allocated_gb_over_start": left,
                      "graph_pool_gb": graph_pool_gb(), "static_programs_left": progs}),
          flush=True)
    check(left < RELEASE_SLACK_GB and progs == 0,
          f"{label}: {left:.3f} GB still allocated after the phase dropped its model, "
          f"{progs} static decode programs left")


def static_programs() -> int:
    """Static decode programs alive in the process (``serve/static.py``)."""
    from repro_torch.serve import static
    return sum(len(g.programs) for g in static._sets.values())


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


HOST_LEAD_MS = 0.2            # the least spin before a timed call
_CYCLES_PER_MS: list[float] = []


def _spin(ms: float) -> None:
    """Keep the card busy for about ``ms`` (torch.cuda._sleep counts clock
    cycles; the rate is measured once)."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(2_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def time_call(fn, reps: int = 25) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``.

    Host: the median wall time for ``fn()`` to return on an idle card (its
    enqueue, or all of it where ``fn`` waits for the card).  Device: the
    median CUDA-event time over ``reps`` runs, each after a write of 256 MB
    that evicts the 50 MB L2, as a decode step's attention finds it after
    the layer's weight reads.  The card then spins for twice the host time
    (at least ``HOST_LEAD_MS``, at most 20 ms) so that the host has
    enqueued ``fn``'s launches before the start event runs: the device time
    holds no gap the wrapper's host work would leave."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=DEV)
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    host_ms = statistics.median(host)
    lead = min(max(HOST_LEAD_MS, 2 * host_ms), 20.0)
    times = []
    for _ in range(reps):
        flush.zero_()
        _spin(lead)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), host_ms


def time_ms(fn, reps: int = 25) -> float:
    return time_call(fn, reps)[0]


STEP_MODES = ("scan", "stepped")        # the card's default, then the oracle


@contextmanager
def step_mode(mode: str):
    """``REPRO_ENGINE_STEP_MODE=mode`` for the block: the reference's override
    of every loop's step mode, read at each step program's call."""
    old = os.environ.get("REPRO_ENGINE_STEP_MODE")
    os.environ["REPRO_ENGINE_STEP_MODE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_ENGINE_STEP_MODE"]
        else:
            os.environ["REPRO_ENGINE_STEP_MODE"] = old


def graph_pool_gb() -> float:
    """GB the caching allocator holds in CUDA graphs' private pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


@contextmanager
def card_launches():
    """The block's kernel launches by wrapper as the card ran them: the
    wrappers' eager launches and those a step program's replays ran, which
    the card counted (``kernels.counted``).  Yields a Counter, filled when
    the block ends."""
    from repro_torch import kernels
    before = kernels.counted()
    out = Counter()
    yield out
    out.update(kernels.counted() - before)


def captured() -> int:
    """CUDA graphs captured so far by the port's step programs."""
    from repro_torch.core.step_graph import captures
    return sum(captures.values())


@contextmanager
def contracts(label: str, owners, expect: tuple, streams=()):
    """One steady-state round or decode chunk under the port's program
    contracts: ``TraceGuard`` (no capture, no kernel build; ``owners``' step
    programs watched) and ``sync_contract`` (the card's sync debug mode and
    the funnel: an un-annotated sync raises where it happens).  The
    scope's launches are ``kernels.Snapshot``s on either side, taken
    without a host wait once ``streams`` (the current one by default; the
    KD lane too where the KD runs there) reach the scope's edge.  Yields a
    dict that ``contracts_line`` prints and checks after the caller's own
    wait for the card: ``expect`` are the path's kernels, each launched in
    the scope."""
    from repro_torch import kernels
    from repro_torch.analysis import TraceGuard, sync_contract
    tg = TraceGuard(label)
    for owner in owners:
        tg.watch_programs(owner)
    out = {"label": label, "expect": expect, "guard": tg,
           "before": kernels.Snapshot(*streams)}
    with tg, sync_contract(label) as scope:
        yield out
    out.update(scope=scope, after=kernels.Snapshot(*streams))


def run_owners(runner) -> list:
    """A runner's step-program owners: its set (client and bucket programs,
    and the KD's when they share it), the KD pipeline and the fused pairs."""
    pairs = runner._executor()._pairs
    return [runner.graphs, runner._kd_pipeline(), *([pairs] if pairs is not None else [])]


def contracts_line(res: dict, card: str) -> dict:
    """Print a ``contracts`` scope's line (the card waited for first) and
    fail the run unless it captured, built and synced nothing and launched
    each of its path's kernels."""
    torch.cuda.synchronize()
    tg, ran = res["guard"], res["after"].read() - res["before"].read()
    line = {"phase": f"contracts: {res['label']}", "card": card, "captures": tg.traces,
            "kernel_builds": sum(tg.built().values()),
            "unannotated_syncs": len(res["scope"].violations), "launches": dict(ran),
            "path_kernels": list(res["expect"]), "watched_programs": len(tg.cache_growth()),
            "captured": tg.captured(), "cache_growth": tg.report()["cache_growth"]}
    print(json.dumps(line), flush=True)
    tg.assert_steady_state()
    check(line["unannotated_syncs"] == 0 and all(ran.get(k, 0) > 0 for k in res["expect"]),
          f"contracts {res['label']}: {line}")
    return line


def planted_contracts(card: str) -> dict:
    """The contracts catch what they exist for, on the card: a ``.item()``
    inside ``sync_contract`` raises ``SyncViolation`` through the funnel
    and, with the funnel bypassed (``TensorBase.item``, the C method it
    wraps), through the card's sync debug mode; a step program fed a new
    shape inside a ``TraceGuard`` raises ``TraceViolation`` naming it."""
    from repro_torch.analysis import SyncViolation, TraceGuard, TraceViolation, sync_contract
    from repro_torch.core.step_graph import StepGraphs
    x = torch.ones(4, device=DEV)
    caught = {}
    for layer, pull in (("funnel", lambda: x.sum().item()),
                        ("card", lambda: torch._C.TensorBase.item(x.sum()))):
        caught[layer] = None
        try:
            with sync_contract(f"planted {layer}"):
                pull()
        except SyncViolation as e:
            caught[layer] = str(e).splitlines()[0]
    graphs = StepGraphs("scan")

    def program(n: int):
        def build():
            buf = {"x": torch.zeros(n, device=DEV)}
            return (lambda: buf["x"].add_(1)), buf
        return graphs.program("planted/step", (n,), build)

    program(4)()                        # the warm shape: captured here
    with TraceGuard("planted").watch_programs(graphs) as tg:
        program(4)()                    # a replay
        program(8)()                    # a new shape: a capture
    trace = None
    try:
        tg.assert_steady_state()
    except TraceViolation as e:
        trace = str(e).splitlines()[0]
    line = {"phase": "contracts: planted violations", "card": card,
            "sync_funnel": caught["funnel"], "sync_card_layer": caught["card"],
            "trace_guard": trace}
    print(json.dumps(line), flush=True)
    check(caught["funnel"] is not None and "(item)" in caught["funnel"],
          f"planted .item(): the funnel did not raise ({caught})")
    check(caught["card"] is not None and "card layer" in caught["card"],
          f"planted .item() past the funnel: the card layer did not raise ({caught})")
    check(trace is not None and "planted/step" in trace,
          f"planted new shape: TraceGuard did not name the program ({trace})")
    return line


def union_ms(events) -> float:
    """Milliseconds in which at least one of the profiled kernels ``events``
    ran: the union of their intervals.  Kernels of one CUDA graph may run
    side by side, and then their summed times exceed the card's busy time."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in events):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def busy_ms_of(prof) -> float:
    from torch.autograd import DeviceType
    return union_ms([e for e in prof.events() if e.device_type == DeviceType.CUDA])


def mode_windows(label: str, windows: dict, card: str, **extra) -> None:
    """One line beside a phase's profiled windows: each step mode's wall,
    device and idle share for the same steps (and ``extra`` as it is)."""
    keys = [k for k in ("wall_ms_per_step", "wall_ms_per_micro_step", "device_ms_per_step",
                        "device_ms_per_micro_step", "idle_share", "busy_ms_per_step",
                        "busy_ms_per_micro_step", "busy_idle_share", "kernel_launches_per_step",
                        "kernel_launches_per_micro_step", "host_launches_per_step",
                        "tokens_per_s", "ttft_s", "captures_in_timed_call")
            if k in windows["scan"]]
    print(json.dumps({"phase": f"scan vs stepped: {label}", "card": card,
                      **{k: {m: w[k] for m, w in windows.items()} for k in keys}, **extra}),
          flush=True)


def kernel_times(fn, reps: int = 25) -> dict:
    """A kernel wrapper's ``ms`` (device) and ``host_ms`` (its host time a call)."""
    ms, host_ms = time_call(fn, reps)
    return {"ms": ms, "host_ms": host_ms}


# ---------------------------------------------------------------- phase 2
def _cuobjdump(build) -> str:
    """cuobjdump beside the nvcc that built the kernels (the same toolkit)."""
    tool = Path(build.nvcc_path()).resolve().parent / "cuobjdump"
    check(tool.exists(), f"cuobjdump not found beside nvcc ({tool})")
    return str(tool)


# library: {kernel: the substrings that each of its tensor-core instances'
# mangled names holds}.  Kernels 9 and 10 share split_gemm::gemm3; an
# instance's epilogue (k9::EpiState, or one of k10's) says whose it is.
SASS_WGMMA = {"flash_attention": {"flash_forward": ("flash_fwd_wgmma",)},
              "flash_kd": {"flash_kd_head_fwd": ("10split_gemm5gemm3", "2k98EpiState"),
                           "flash_kd_head_bwd": ("10split_gemm5gemm3", "3k10")}}


def sass_phase(build) -> None:
    """Whether kernel 12's bf16 path and kernels 9 and 10's GEMM passes run
    on the tensor cores: the HGMMA instructions in the SASS of each of their
    instances in the built libraries (cuobjdump -sass).  Fails the run if
    an instance holds none, if a kernel has no instance, or if cuobjdump is
    missing from nvcc's toolkit."""
    tool = _cuobjdump(build)
    for lib, kernels in SASS_WGMMA.items():
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts, fn = {k: {} for k in kernels}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                for k, parts in kernels.items():
                    if all(p in fn for p in parts):
                        counts[k][fn] = 0
            elif fn is not None and "HGMMA" in line:
                for per_fn in counts.values():
                    if fn in per_fn:
                        per_fn[fn] += 1
        print(json.dumps({"phase": f"{lib} tensor-core SASS", "tool": tool,
                          "hgmma_per_function": counts}), flush=True)
        for k, per_fn in counts.items():
            check(len(per_fn) > 0 and all(n > 0 for n in per_fn.values()),
                  f"{lib}: {k}'s tensor-core instances hold no HGMMA: {per_fn}")


# ---------------------------------------------------------------- phase 3
def paged_case(gen, *, B, Hkv, G, dh, bs, lens, dtype, nbmax=None):
    """A shuffled pool holding ``lens[b]`` tokens for request b."""
    nbmax = nbmax or max(1, math.ceil(max(lens) / bs))
    need = [math.ceil(n / bs) for n in lens]
    nb = 1 + sum(need)
    ids = (1 + torch.randperm(nb - 1, generator=gen, device=DEV)).to(torch.int32)
    bt = torch.zeros((B, nbmax), dtype=torch.int32, device=DEV)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[at:at + n]
        at += n
    pool = lambda: torch.randn((nb, bs, Hkv, dh), generator=gen, device=DEV).to(dtype)  # noqa: E731
    q = torch.randn((B, 1, Hkv * G, dh), generator=gen, device=DEV).to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    return q, pool(), pool(), bt, sl


def paged_bound(q, k_pool, bt, sl, window: int):
    """(bound_ms, bound_by): live K/V rows read once, q/tables read once,
    the output written once, over HBM bandwidth vs 4·G·dh flops per live
    row and KV head over the dtype's peak rate."""
    B, _, H, dh = q.shape
    _, _, Hkv, _ = k_pool.shape
    live = sl.clamp(max=window) if window > 0 else sl
    rows = int(live.sum())
    elt = q.element_size()
    nbytes = (rows * Hkv * dh * 2 * elt + 2 * q.numel() * elt
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * rows * H * dh
    return _bound(nbytes, flops, q.dtype)


def library_call(q, k_pool, v_pool, bt, sl, window: int = 0):
    """Yardstick only, never called by the port: gather the table, then
    torch's scaled_dot_product_attention with a length (and window) mask."""
    B, _, H, dh = q.shape
    _, bs, Hkv, _ = k_pool.shape
    S = bt.shape[1] * bs
    kg = k_pool[bt.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    vg = v_pool[bt.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < sl[:, None]
    if window > 0:
        mask &= pos >= sl[:, None] - window
    mask = mask[:, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True)


def compare_kernel(ops, args, window: int, label: str, timed: bool):
    q = args[0]
    out = ops.paged_decode(*args, window=window).float()
    ref = ops.paged_decode_ref(*args, window=window).float()
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err = float(err.max())
    if q.dtype == torch.float32:
        tol = F32_TOL
        ok = bool((err <= tol + tol * ref.abs()).all())
        row_rel = None
    else:                                   # per (b, h) row, against its scale
        tol = BF16_ROW_TOL
        row_err, row_scale = err.amax(-1), ref.abs().amax(-1)
        ok = bool((row_err <= tol * row_scale).all())
        row_rel = float((row_err / row_scale.clamp(min=1e-30)).max())
    ok = ok and bool(out.isfinite().all())
    empty = (args[4] == 0)
    if empty.any():
        ok = ok and not bool(out[empty].any())   # seq_len 0 rows are zeros
    row = {"case": label, "max_abs_err": max_err, "max_row_rel_err": row_rel, "tol": tol}
    if timed:
        bound, by = paged_bound(q, args[1], args[3], args[4], window)
        row.update(**kernel_times(lambda: ops.paged_decode(*args, window=window)),
                   plain_ms=time_ms(lambda: ops.paged_decode_ref(*args, window=window)),
                   library_ms=time_ms(lambda: library_call(*args, window)),
                   bound_ms=bound, bound_by=by)
    print(json.dumps(row), flush=True)
    check(ok, f"paged_decode disagrees with its plain version ({label}): "
              f"max_abs_err {max_err}, max_row_rel_err {row_rel}, tol {tol}")
    return row


STARCODER_WINDOW = 4096
STARCODER_LENS = [0, 1, 4095, 4096, 4097, 9000, 16384, 20512]
LLAMA4_WINDOW = 8192
LLAMA4_LENS = [0, 1, 8191, 8192, 8193, 10240]   # both sides of the window, phase 32's long prompt
# the timed bf16 rows of the last families (kernel 1's "llama4" and "llava")
PAGED_TIMED_NEW = {"llama4": f"llama4 bfloat16 window={LLAMA4_WINDOW}", "llava": "llava bfloat16"}
QWEN_WINDOW = 256
# the starcoder2-3b cases kernel 1's split-K was designed for
STARCODER_TIMED = ("starcoder2 bfloat16 window=4096", "starcoder2 bfloat16")


def split_edge_lens(ops, B, Hkv, G, dh, nbmax, window, dtype):
    """Eight lengths at the edges of kernel 1's split-K at these shapes:
    seq_len 0, 1 and 16·k ± 1; lengths whose live range ends on a split
    boundary; with a window, rows whose lo falls inside a block and whose
    first blocks lie wholly before the window."""
    meta = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    plan = ops.paged_plan(meta(B, 1, Hkv * G, dh), meta(1, 16, Hkv, dh),
                          torch.empty((B, nbmax), dtype=torch.int32, device="meta"), window)
    c, top = plan["chunk"], nbmax * 16
    if window > 0:
        lens = [0, 1, c, 2 * c - 1, window + 7, window + c + 16, 3 * window + 5, top]
    else:
        lens = [0, 1, 16 * 5 - 1, 16 * 5 + 1, c, 2 * c, 3 * c + 1, top]
    return [min(n, top) for n in lens], plan


def kernel_phase(ops, seed: int) -> dict:
    """Returns the timed starcoder2-3b, llama4 and llava rows by case."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lens = [0, 1, 16, 17, 2048, 300, 777, 1500]
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        qwen = paged_case(gen, B=8, Hkv=8, G=5, dh=128, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, qwen, 0, f"qwen {name}", timed=True)
        compare_kernel(ops, qwen, QWEN_WINDOW, f"qwen {name} window={QWEN_WINDOW}", timed=False)
        gemma = paged_case(gen, B=8, Hkv=1, G=8, dh=256, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, gemma, 0, f"gemma {name}", timed=True)
        stablelm = paged_case(gen, B=8, Hkv=32, G=1, dh=80, bs=16, lens=lens, dtype=dtype)
        compare_kernel(ops, stablelm, 0, f"stablelm dh=80 {name}", timed=True)
        # starcoder2-3b's decode as phases 16-17 serve it: G 12 and lengths
        # on both sides of its window, up to the long prompt's
        starcoder = paged_case(gen, B=8, Hkv=2, G=12, dh=128, bs=16, lens=STARCODER_LENS,
                               dtype=dtype)
        for window in (STARCODER_WINDOW, 0):
            label = f"starcoder2 {name}" + (f" window={window}" if window else "")
            timed[label] = compare_kernel(ops, starcoder, window, label, timed=True)
        # llama4-maverick's windowed decode (G 5, window 8,192) and llava's (G 4)
        llama4 = paged_case(gen, B=len(LLAMA4_LENS), Hkv=8, G=5, dh=128, bs=16,
                            lens=LLAMA4_LENS, dtype=dtype)
        label = f"llama4 {name} window={LLAMA4_WINDOW}"
        timed[label] = compare_kernel(ops, llama4, LLAMA4_WINDOW, label, timed=True)
        llava = paged_case(gen, B=8, Hkv=8, G=4, dh=128, bs=16, lens=lens, dtype=dtype)
        timed[f"llava {name}"] = compare_kernel(ops, llava, 0, f"llava {name}", timed=True)
        # the split-K's edges at starcoder2-3b's and qwen2.5-14b's shapes:
        # the long prompt's table and qwen's serve-run table, each with a
        # window and without, and tables far longer than every row (empty
        # splits)
        for shape, nbmax, window, sparse in (
                ((8, 2, 12, 128), 1282, 0, False), ((8, 2, 12, 128), 1282, STARCODER_WINDOW, False),
                ((8, 2, 12, 128), 1282, 0, True), ((8, 8, 5, 128), 36, 0, False),
                ((8, 8, 5, 128), 36, QWEN_WINDOW, False), ((8, 8, 5, 128), 400, 0, True)):
            B, Hkv, G, dh = shape
            edge, plan = split_edge_lens(ops, B, Hkv, G, dh, nbmax, window, dtype)
            if sparse:
                edge = [0, 1, 15, 17, 31, 33, 300, 600]
            args = paged_case(gen, B=B, Hkv=Hkv, G=G, dh=dh, bs=16, lens=edge, dtype=dtype,
                              nbmax=nbmax)
            compare_kernel(ops, args, window,
                           f"split edges G={G} nbmax={nbmax} window={window} {name} "
                           f"(chunk {plan['chunk']}, splits {plan['splits']}, lens {edge})",
                           timed=False)
    return timed


# ------------------------------------------------------------- phases 4-5
def make_requests(Request, vocab: int, n: int, rng, len_range, new_range):
    lens = rng.integers(len_range[0], len_range[1] + 1, n)
    news = rng.integers(new_range[0], new_range[1] + 1, n)
    return [Request(rid=i, tokens=rng.integers(0, vocab, int(lens[i])).astype(np.int32),
                    max_new_tokens=int(news[i])) for i in range(n)]


def drive(engine, requests):
    """``engine.run`` step by step: returns the results and the host tables
    at the busiest chunk boundary (the main path's decode inputs)."""
    for r in requests:
        engine.submit(r)
    out, busiest = [], None
    while not engine.idle:
        out.extend(engine.step())
        if engine.num_active and (busiest is None
                                  or engine.num_active >= busiest[0]):
            busiest = (engine.num_active, engine.block_tables.copy(),
                       engine.seq_lens.copy())
    return out, busiest


def f32_depth2_phase(serve, zoo, get_config, seed: int):
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    rng = np.random.default_rng(seed)
    reqs = make_requests(serve.Request, cfg.vocab_size, 8, rng, (16, 200), (4, 24))
    engine = serve.ContinuousEngine(model, params, max_batch=4, num_blocks=128,
                                    block_size=16, max_seq_len=224, chunk_steps=4)
    from repro_torch import kernels
    kernels.launches.clear()
    with card_launches() as ran:
        results, _ = drive(engine, reqs)
    launches, host = ran["paged_decode"], kernels.launches["paged_decode"]
    got = {r.rid: r.tokens for r in results}
    for r in reqs:
        ref = serve.generate_static(model, params, r.tokens[None], r.max_new_tokens)
        ref = ref[0].cpu().tolist()
        check(got[r.rid] == ref, f"f32 depth-2: request {r.rid} engine {got[r.rid]} "
                                 f"!= static {ref}")
    check(launches == cfg.num_layers * engine.steps and host > 0,
          f"f32 depth-2: {launches} launches on the card ({host} by the wrapper) for "
          f"{engine.steps} micro-steps")
    print(json.dumps({"phase": "f32 depth 2, full width", "requests": len(reqs),
                      "tokens": sum(len(v) for v in got.values()),
                      "identical_tokens": True, "paged_decode_launches": launches,
                      "paged_decode_wrapper_launches": host,
                      "micro_steps": engine.steps}), flush=True)
    del engine, params, model
    torch.cuda.empty_cache()


def _named(label: str, fn):
    """``fn`` inside a ``record_function`` range named ``label``."""
    from torch.profiler import record_function

    def run(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return run


def range_ms(prof, ranges) -> dict:
    """Device ms of the profiled kernels by named range: the named ranges
    show on the device as spans of their own, and each kernel goes to the
    range whose span holds its start."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name in ranges]
    by_range = dict.fromkeys(ranges, 0.0)
    for e in events:
        if e.name in ranges:
            continue
        for name, lo, hi in spans:
            if lo <= e.time_range.start < hi:
                by_range[name] += (e.time_range.end - e.time_range.start) / 1e3
                break
    return by_range


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "pagedrows" in low:              # kernel 1: splitk::decode_kernel<..., PagedRows>
        return "paged_decode"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_chunk(engine, serve, vocab: int, rng, before_launches: int,
                  ranges: dict | None = None) -> dict:
    """Where a decode micro-step's time goes, with every lane busy: one
    chunk timed on the host clock, then the next chunk under torch.profiler
    for the device time by kernel (the profiler's own host cost would
    inflate that chunk's wall).  The idle share is 1 - device / wall;
    kernel 1's share is its device time over the micro-step's.  The kernel
    launches per micro-step stand beside ``before_launches``, the count
    with kernel 1's one-CTA-per-head design (one launch a layer then, as
    now).  ``ranges`` ({name: its module}): each function in a named range
    and its device ms per micro-step (``device_ms_by_range``); only an
    eager ("stepped") chunk shows the ranges, a replayed graph has none."""
    from contextlib import ExitStack
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ranges = ranges or {}
    k = engine.chunk_steps
    reqs = make_requests(serve.Request, vocab, engine.max_batch, rng, (32, 512),
                         (1 + 3 * k, 1 + 3 * k))
    for r in reqs:
        engine.submit(r)
    engine.step()                           # prefills and the first chunk
    check(engine.num_active == engine.max_batch, "profile: not every lane is busy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / k
    with ExitStack() as stack:
        for name, mod in ranges.items():
            stack.enter_context(mock.patch.object(mod, name, _named(name, getattr(mod, name))))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]))
        engine.step()                       # the last chunk, then eviction
        torch.cuda.synchronize()
    check(engine.idle, "profile: requests left after their last chunk")
    by_range = {name: ms / k for name, ms in range_ms(prof, ranges).items()}
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / k
    span_ms = busy_ms_of(prof) / k
    groups = dict.fromkeys(("matmul", "paged_decode", "other"), 0.0)
    for e in kern:
        groups[_kernel_group(e.key)] += e.self_device_time_total / 1e3 / k
    check(not kern or groups["paged_decode"] > 0,
          f"profile: no device time found for kernel 1 (paged_decode): {groups}")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": "decode micro-step profile", "lanes": engine.max_batch,
            "wall_ms_per_micro_step": wall_ms,
            "device_ms_per_micro_step": busy_ms if kern else None,
            "idle_share": 1 - busy_ms / wall_ms if kern else None,
            "busy_ms_per_micro_step": span_ms, "busy_idle_share": 1 - span_ms / wall_ms,
            "device_ms_by_group": groups,
            "paged_decode_share_of_device": groups["paged_decode"] / busy_ms if kern else None,
            "kernel_launches_per_micro_step": sum(e.count for e in kern) / k,
            "kernel_launches_per_micro_step_before": before_launches,
            **({"device_ms_by_range": by_range} if ranges else {}),
            "top_kernels": [{"name": e.key[:80], "per_micro_step": e.count / k,
                             "ms_per_micro_step": e.self_device_time_total / 1e3 / k}
                            for e in top]}


def profile_modes(engine, serve, vocab: int, rng, before_launches: int, label: str,
                  card: str, ranges: dict | None = None) -> dict:
    """``profile_chunk`` under each step mode, then the two side by side;
    returns the windows by mode."""
    windows = {}
    for mode in STEP_MODES:
        with step_mode(mode):
            windows[mode] = {**profile_chunk(engine, serve, vocab, rng, before_launches,
                                             ranges), "step_mode": mode}
        print(json.dumps(windows[mode]), flush=True)
    mode_windows(label, windows, card)
    return windows


def serve_phase(serve, zoo, ops, get_config, seed: int, card: str):
    from unittest import mock

    from repro_torch import kernels
    cfg = get_config("qwen2.5-14b")
    model = zoo.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} "
          f"weights in {init_s:.2f} s", flush=True)

    rng = np.random.default_rng(seed)
    engine = serve.ContinuousEngine(model, params, max_batch=8, num_blocks=512,
                                    block_size=16, max_seq_len=576, chunk_steps=8)
    warm = make_requests(serve.Request, cfg.vocab_size, 2, rng, (32, 64), (8, 8))
    kernels.launches.clear()
    drive(engine, warm)                       # cuBLAS handles, allocator, the chunk's graph
    reqs = make_requests(serve.Request, cfg.vocab_size, 16, rng, (32, 512), (8, 64))
    steps0, captures0 = engine.steps, captured()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, busiest = drive(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    micro = engine.steps - steps0
    # the kernel's launches, counted over a third batch of short prompts
    counted = make_requests(serve.Request, cfg.vocab_size, 8, rng, (32, 512), (8, 24))
    steps1 = engine.steps
    with card_launches() as ran:
        for r in counted:
            engine.submit(r)
        # its first step (8 admissions, one decode chunk) under the contracts
        with contracts("qwen2.5-14b admission and decode chunk", [engine],
                       ("paged_decode",)) as held:
            engine.step()
        drive(engine, [])
    contracts_line(held, card)
    launches, counted_micro = ran["paged_decode"], engine.steps - steps1
    host = kernels.launches["paged_decode"]
    check(captured() == captures0, f"serve: {captured() - captures0} captures after the warm-up")

    check(len(results) == len(reqs), f"{len(results)} results for {len(reqs)} requests")
    by_rid = {r.rid: r for r in results}
    for r in reqs:
        res = by_rid[r.rid]
        check(not res.cancelled and len(res.tokens) == r.max_new_tokens,
              f"request {r.rid}: {len(res.tokens)} tokens for {r.max_new_tokens}")
    check(engine.alloc.used_blocks == 0 and engine.reserved_tokens == 0,
          "pool not free after the drain")
    check(host > 0 and launches > 0 and launches == cfg.num_layers * counted_micro,
          f"{launches} paged_decode launches on the card ({host} by the wrapper) for "
          f"{counted_micro} micro-steps x {cfg.num_layers}")
    ntok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft for r in results)
    lat = sorted(r.latency for r in results)
    summary = {"phase": "bf16 full depth, full width", "card": card,
               "requests": len(results), "generated_tokens": ntok,
               "prompt_tokens": int(sum(len(r.tokens) for r in reqs)),
               "wall_s": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
               "latency_p50_ms": lat[len(lat) // 2] * 1e3,
               "micro_steps": micro, "counted_micro_steps": counted_micro,
               "paged_decode_launches": launches,
               "paged_decode_launches_per_micro_step": launches / counted_micro,
               "paged_decode_wrapper_launches": host,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(summary), flush=True)
    profile_modes(engine, serve, cfg.vocab_size, rng, 3429, "qwen2.5-14b decode micro-step",
                  card)

    # one decode step's logits through the kernel vs the plain version, on
    # four fresh requests scattered into a small pool
    probe = make_requests(serve.Request, cfg.vocab_size, 4, rng, (40, 300), (2, 2))
    pool = model.init_paged_cache(1 + 4 * 20, 16, device=DEV)
    bt = np.zeros((4, 20), np.int32)
    first = []
    with torch.inference_mode():
        at = 1
        for b, r in enumerate(probe):
            L = len(r.tokens)
            lpad = math.ceil(L / 16) * 16
            toks = np.zeros((1, lpad), np.int32)
            toks[0, :L] = r.tokens
            logits, ctg = model.prefill(params, {"tokens": torch.from_numpy(toks).to(DEV)},
                                        last=[L - 1])
            serve.scatter_prefill(pool, ctg, list(range(at, at + lpad // 16)))
            bt[b, :math.ceil((L + 1) / 16)] = range(at, at + math.ceil((L + 1) / 16))
            at += math.ceil((L + 1) / 16)
            first.append(int(logits.argmax(-1)[0]))
        tok = torch.tensor(first, dtype=torch.int32, device=DEV)[:, None]
        btd = torch.from_numpy(bt).to(DEV)
        sl = torch.tensor([len(r.tokens) for r in probe], dtype=torch.int32, device=DEV)
        lk, _ = model.paged_decode_step(params, tok, pool, btd, sl)
        with mock.patch.object(ops, "paged_decode", ops.paged_decode_ref):
            lp, _ = model.paged_decode_step(params, tok, pool, btd, sl)
    rel = float((lk.float() - lp.float()).norm() / lp.float().norm())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(json.dumps({"phase": "bf16 decode-step logits, kernel vs plain",
                      "rel_l2_err": rel, "max_abs_err": float((lk.float() - lp.float()).abs().max()),
                      "argmax_agreement": agree, "tol_rel_l2": 5e-2}), flush=True)
    check(bool(lk.isfinite().all()), "non-finite logits")
    check(rel <= 5e-2, f"bf16 decode-step logits: kernel vs plain rel L2 {rel} > 5e-2")

    # the kernel's line: its wrapper at the main path's busiest decode
    # inputs (the pool as it stands, the host tables of that chunk boundary)
    _, bt_host, sl_host = busiest
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    q = torch.randn((8, 1, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=DEV).to(cfg.cdtype)
    kp, vp = engine.pool["blocks"]["b0"]["k"][0], engine.pool["blocks"]["b0"]["v"][0]
    sl_attn = np.where(sl_host > 0, sl_host + 1, 0).astype(np.int32)
    args = (q, kp, vp, torch.from_numpy(bt_host).to(DEV), torch.from_numpy(sl_attn).to(DEV))
    print(f"kernel at the main path's inputs: seq_lens {sl_attn.tolist()}", flush=True)
    row = compare_kernel(ops, args, 0, "qwen bf16, serve-run inputs", timed=True)
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": PAGED_DECODE_TPU, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "host_ms": row["host_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


# ---------------------------------------------------------------- phase 6
def rows_within(out, ref, rel: float, atol: float = 0.0) -> bool:
    """Every row's max |out - ref| at most ``rel`` of its max |ref| plus ``atol``."""
    out, ref = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    return bool(((out - ref).abs().amax(-1) <= rel * ref.abs().amax(-1) + atol).all())


def kd_bound(name: str, M: int, B: int, V: int, elt: int):
    """(bound_ms, bound_by): each input read once and each output written
    once over HBM bandwidth, vs the f32 operations over the f32 peak."""
    if name == "ensemble_softmax":              # x (M,B,V) -> probs (B,V) f32
        nbytes, ops = M * B * V * elt + B * V * 4, 2 * M * B * V + 4 * B * V
    elif name == "kd_loss_fwd":                 # s, t -> kl (B,)
        nbytes, ops = B * V * (elt + 4) + B * 4, 8 * B * V
    else:                                       # s, t, g -> grad (B,V) in s's type
        nbytes, ops = B * V * (2 * elt + 4) + 4, 6 * B * V
    return _bound(nbytes, ops)


def kd_plain(kd_ref) -> dict:
    """The KD kernels' plain versions by name; each takes its kernel
    wrapper's arguments, tau last."""
    return {"ensemble_softmax": kd_ref.ensemble_softmax_ref,
            "kd_loss_fwd": kd_ref.kd_loss_ref,
            "kd_loss_bwd": lambda s, t, g, tau: (kd_ref.kd_loss_grad_ref(s, t, tau) * g)
            .to(s.dtype)}


LIBRARY = {   # yardsticks only, never called by the port: the shortest compositions
    "ensemble_softmax": ("softmax(x.float().mean(0) / tau)",
                         lambda x, tau: torch.softmax(x.float().mean(0) / tau, -1)),
    "kd_loss_fwd": ("kl_div(log_softmax(s / tau), t, 'sum') / B * tau^2",
                    lambda s, t, tau: torch.nn.functional.kl_div(
                        torch.log_softmax(s.float() / tau, -1), t, reduction="sum")
                    / s.shape[0] * tau ** 2),
    "kd_loss_bwd": ("(softmax(s / tau) - t) * g * tau / B",
                    lambda s, t, g, tau: ((torch.softmax(s.float() / tau, -1) - t)
                                          * (g * tau / s.shape[0])).to(s.dtype)),
}


def kd_check(kd_ops, kd_ref, label: str, x, s, t, g, tau: float, timed: bool) -> dict:
    """The three KD kernels against their plain versions on (x, s, t, g);
    returns one row per kernel (and checks each)."""
    plain = kd_plain(kd_ref)
    args = {"ensemble_softmax": (x, tau), "kd_loss_fwd": (s, t, tau),
            "kd_loss_bwd": (s, t, g, tau)}
    rows = {}
    for name, a in args.items():
        kern = getattr(kd_ops, name)
        out, ref = kern(*a), plain[name](*a)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        bf16 = a[0].dtype == torch.bfloat16
        if name == "kd_loss_fwd":
            tol, ok = KD_LOSS_RTOL, err <= KD_LOSS_RTOL * abs(float(ref))
        elif name == "ensemble_softmax":
            tol, ok = KD_F32_ROW_TOL, rows_within(out, ref, KD_F32_ROW_TOL)
        else:
            tol = KD_BF16_GRAD_ROW_TOL if bf16 else KD_F32_ROW_TOL
            ok = rows_within(out, ref, tol, KD_GRAD_ATOL * abs(float(g)) * tau / s.shape[0])
        ok = ok and bool(out.isfinite().all()) and out.dtype == ref.dtype
        M, B, V = x.shape if name == "ensemble_softmax" else (1, *s.shape)
        row = {"case": label, "kernel": name, "shape": [M, B, V] if name == "ensemble_softmax"
               else [B, V], "dtype": str(a[0].dtype).removeprefix("torch."), "tau": tau,
               "max_abs_err": err, "tol": tol}
        if name == "ensemble_softmax":      # the reading that the row tolerance bounds
            row["row_rel_err"] = float(((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
        if timed:
            bound, by = kd_bound(name, M, B, V, a[0].element_size())
            library, library_fn = LIBRARY[name]
            row.update(**kernel_times(lambda: kern(*a)),
                       plain_ms=time_ms(lambda: plain[name](*a)),
                       library_ms=time_ms(lambda: library_fn(*a)), library=library,
                       bound_ms=bound, bound_by=by)
        print(json.dumps(row), flush=True)
        check(ok, f"{name} disagrees with its plain version ({label}): {row}")
        rows[name] = row
    return rows


KD_LM_CASE = "gemma-2b vocabulary"


def kd_phase(kd_ops, kd_ref, seed: int) -> dict:
    """Phase 6; returns the launch floor and the f32 rows of kernels 3 and 4
    at gemma-2b's vocabulary (512 x 256,000)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cases = [("FedSDD round (K=4, R=2, 8x256 server rows)", 8, 2048, 256, 10, 4.0, True),
             ("sweep", 1, 4, 4, 128, 1.0, False), ("sweep", 4, 8, 8, 1000, 4.0, False),
             ("sweep", 8, 4, 4, 257, 2.0, False), ("sweep", 2, 16, 16, 4096, 4.0, False),
             ("Qwen2.5 vocabulary", 4, 256, 256, 152064, 4.0, True),
             (KD_LM_CASE, 8, 512, 512, 256000, 4.0, True)]
    floor = time_ms(lambda: torch.cuda._sleep(0))
    print(json.dumps({"launch_floor_ms": floor, "what": "torch.cuda._sleep(0): one launch "
                      "of a kernel that returns at once, under time_call"}), flush=True)
    g = torch.tensor(1.5, device=DEV)
    lm = {}
    for label, M, N, B, V, tau, timed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, N, V), generator=gen, device=DEV) * 3).to(dtype)
            s = (torch.randn((B, V), generator=gen, device=DEV) * 3).to(dtype)
            t = torch.softmax(torch.randn((B, V), generator=gen, device=DEV) * 2, -1)
            rows = kd_check(kd_ops, kd_ref, label, x, s, t, g, tau, timed)
            if label == KD_LM_CASE and dtype == torch.float32:
                lm = rows
            del x, s, t
            torch.cuda.empty_cache()
    return {"launch_floor_ms": floor, "lm": lm}


# ---------------------------------------------------------------- phase 7
def plain_kd(kd_ops, kd_ref):
    """The three KD wrappers patched to their plain versions."""
    from contextlib import ExitStack
    from unittest import mock
    stack = ExitStack()
    for name, fn in kd_plain(kd_ref).items():
        stack.enter_context(mock.patch.object(kd_ops, name, fn))
    return stack


def f32_round_phase(fed, kd_ops, kd_ref, seed: int) -> None:
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map
    torch.backends.cudnn.deterministic = True
    task = classification_task(model="resnet20", num_clients=8, num_train=2000,
                               num_server=512, server_batch=256, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, distill_steps=20,
              client_lr=0.05, server_lr=0.05, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {}
    for mode in ("kernels", "plain"):
        runner = fed.make_runner("fedsdd", task, device=DEV, **kw)
        state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                             ensemble=fed.TeacherBank(4, 2))
        kernels.launches.clear()
        with plain_kd(kd_ops, kd_ref) if mode == "plain" else nullcontext(), \
                card_launches() as ran:
            state = runner.run(2, state=state)
        runs[mode] = (state, dict(ran), dict(kernels.launches))
    torch.backends.cudnn.deterministic = False
    (st_k, launches, host), (st_p, plain_launches, plain_host) = runs["kernels"], runs["plain"]
    main_ok = all(torch.allclose(a, b, rtol=ROUND_TOL, atol=ROUND_TOL) for a, b in
                  zip(_leaves(st_k.global_models[0]), _leaves(st_p.global_models[0])))
    rest_same = all(torch.equal(a, b) for k in range(1, 4) for a, b in
                    zip(_leaves(st_k.global_models[k]), _leaves(st_p.global_models[k])))
    print(json.dumps({"phase": "f32 ResNet-20 round, kernels vs plain",
                      "main_max_abs_err": _tree_err(st_k.global_models[0], st_p.global_models[0]),
                      "tol": ROUND_TOL, "models_k>0_bit_identical": rest_same,
                      "kd_loss_last": [r["kd_loss_last"] for r in st_k.history],
                      "kd_loss_last_plain": [r["kd_loss_last"] for r in st_p.history],
                      "launches": launches, "wrapper_launches": host,
                      "launches_plain": plain_launches}), flush=True)
    check(main_ok, "f32 round: main model, kernels vs plain, beyond 2e-4")
    check(rest_same, "f32 round: models k>0 differ between the kernel and plain runs")
    check(launches == {"ensemble_softmax": 2, "kd_loss_fwd": 40, "kd_loss_bwd": 40}
          and all(host.get(k) for k in launches),
          f"f32 round: launches {launches} on the card, {host} by the wrappers")
    check(not plain_launches and not any(plain_host.values()),
          f"plain run launched kernels: {plain_launches} on the card, {plain_host}")


def _leaves(tree):
    from repro_torch.utils.pytree import tree_leaves
    return tree_leaves(tree)


def _tree_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(_leaves(a), _leaves(b)))


# ---------------------------------------------------------------- phase 8
def _train_group(name: str) -> str:
    low = name.lower()
    if "ensemble_softmax" in low:
        return "ensemble_softmax"
    if "kd_small" in low or "kd_finish" in low:                  # kernel 3's one-CTA paths
        return "kd_loss_fwd"
    if "kd_staged<" in low or "kd_rows<" in low:                  # <T, true>: kernel 3
        return "kd_loss_fwd" if ", true>" in low else "kd_loss_bwd"
    if "multi_tensor" in low or "foreach" in low:
        return "optimiser"
    if "index" in low:
        return "gather"
    if any(k in low for k in ("norm", "moments", "fusedparams", "gammabeta",
                              "internalgradients")):
        return "norm"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "wgrad", "dgrad", "fprop",
                              "gemm", "gemv", "cutlass", "nvjet")):
        return "conv"
    if "elementwise" in low or "reduce" in low:
        return "elementwise"
    return "other"


def profile_window(label: str, fn, steps: int) -> dict:
    """``fn`` (``steps`` training steps) once to warm, once on the host clock,
    once under torch.profiler for device time by kernel group; the idle
    share is 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    span_ms = busy_ms_of(prof) / steps
    groups = dict.fromkeys(("conv", "norm", "elementwise", "optimiser", "gather",
                            "ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd", "other"), 0.0)
    for e in kern:
        groups[_train_group(e.key)] += e.self_device_time_total / 1e3 / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"phase": f"profile: {label}", "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": busy_ms if kern else None,
            "idle_share": 1 - busy_ms / wall_ms if kern else None,
            "busy_ms_per_step": span_ms, "busy_idle_share": 1 - span_ms / wall_ms,
            "device_ms_by_group": groups,
            "kernel_launches_per_step": sum(e.count for e in kern) / steps,
            "top_kernels": [{"name": e.key[:80], "per_step": e.count / steps,
                             "ms_per_step": e.self_device_time_total / 1e3 / steps}
                            for e in top]}


def profile_window_modes(label: str, fn, steps: int, card: str) -> None:
    """``profile_window`` under each step mode, then the two side by side."""
    windows = {}
    for mode in STEP_MODES:
        with step_mode(mode):
            windows[mode] = {**profile_window(label, fn, steps), "step_mode": mode,
                             "card": card}
        print(json.dumps(windows[mode]), flush=True)
    mode_windows(label, windows, card)


def resnet56_phase(fed, kd_ops, kd_ref, seed: int, card: str, kd6: dict) -> list[dict]:
    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.distill import KDPipeline
    t0 = time.perf_counter()
    task = classification_task(model="resnet56", num_clients=20, alpha=0.1, num_train=50000,
                               num_server=2048, server_batch=256, seed=seed, device=DEV)
    tau, steps_kd = 4.0, 200
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=20, participation=0.4,
                             client_batch=64, client_lr=0.05, server_lr=0.05,
                             temperature=tau, local_epochs=1, distill_steps=steps_kd,
                             seed=seed)
    state = runner.init_state()
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(state.global_models[0]))
    print(f"task and init: {time.perf_counter() - t0:.1f} s; {n_params:,} parameters "
          f"per model", flush=True)
    client_steps = [0]
    make_batch = task.make_batch

    def counted(ds, idx):
        client_steps[0] += 1
        return make_batch(ds, idx)

    task.make_batch = counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.launches.clear()
    rounds, launches = [], Counter()
    for i in range(2):
        before, t0, captures0 = client_steps[0], time.perf_counter(), captured()
        with card_launches() as ran:
            if i == 0:
                state = runner.run(1, state=state)
            else:       # round 2, the steady state, under the contracts
                with contracts("ResNet-56 round 2, sequential", run_owners(runner),
                               KD_PATH) as held:
                    state = runner.run(1, state=state)
        launches.update(ran)
        rec = state.history[-1]
        n = client_steps[0] - before
        rounds.append({"round": rec["round"], "active": rec["active"], "client_steps": n,
                       "captures": captured() - captures0,
                       "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                       "t_kd_s": rec["t_kd"], "acc_main": rec["acc_main"],
                       "client_steps_per_s": n / rec["t_local"],
                       "kd_steps_per_s": steps_kd / rec["t_kd"],
                       "kd_loss_first": rec["kd_loss_first"],
                       "kd_loss_last": rec["kd_loss_last"]})
    launches, host = dict(launches), dict(kernels.launches)
    task.make_batch = make_batch
    peak = torch.cuda.max_memory_allocated() / 1e9
    contracts_line(held, card)
    for r in rounds:
        print(json.dumps({"phase": "ResNet-56 FedSDD round", "card": card, **r}), flush=True)
    print(json.dumps({"phase": "ResNet-56 FedSDD run", "card": card, "rounds": 2,
                      "launches": launches, "wrapper_launches": host,
                      "teachers": state.ensemble.num_members,
                      "rounds_held": state.ensemble.rounds_held(),
                      "peak_mem_gb": peak}), flush=True)
    check(len(state.history) == 2, "ResNet-56: two history records")
    check(rounds[1]["captures"] == 0, f"ResNet-56: round 2 captured {rounds[1]['captures']}")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"ResNet-56: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "ResNet-56: the ring does not hold 8 teachers")
    check(launches.get("ensemble_softmax") == 2 and launches.get("kd_loss_fwd") == 2 * steps_kd
          and launches.get("kd_loss_bwd") == 2 * steps_kd
          and all(host.get(k) for k in ("ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd")),
          f"ResNet-56: launches {launches} on the card, {host} by the wrappers")
    check(all(_tree_err(state.global_models[k], state.global_models[0]) > 0
              for k in range(1, 4)), "ResNet-56: a model k>0 equals the main model")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "ResNet-56: non-finite weights")

    # where a step's time goes: 10 client steps (the largest client's first
    # 640 examples, ~2,500 at full size) and 10 KD steps over round 2's teacher cache
    sizes = [len(y) for _, y in task.client_data]
    cid = int(np.argmax(sizes))
    rows = (np.arange(640) % sizes[cid]).reshape(10, 64)
    pipe = runner._kd_pipeline()
    batches = pipe.batches_for(task.server_batches)
    teachers = state.ensemble.member_views()
    cache = pipe.precompute_cache(teachers, batches)
    pipe10 = KDPipeline(task.logits_fn, steps=10, lr=0.05, temperature=tau, device=DEV)
    for label, fn in (
            ("10 client steps, ResNet-56, batch 64",
             lambda: runner._local_train_scheduled(state.global_models[1], cid, state, rows)),
            ("10 KD steps, ResNet-56, batch 256, 8 teachers",
             lambda: pipe10._run(state.global_models[0], batches, cache))):
        profile_window_modes(label, fn, 10, card)

    # the kernels at the round's own inputs: round 2's teacher logits over
    # the 8 server batches, and the distilled main model on batch 0
    with torch.no_grad():
        M, nB = len(teachers), batches["x"].shape[0]
        x = torch.stack([torch.stack([task.logits_fn(member, {"x": batches["x"][b]})
                                      for b in range(nB)]) for member in teachers])
        x = x.reshape(M, -1, x.shape[-1])
        s = task.logits_fn(state.global_models[0], {"x": batches["x"][0]})
    t = kd_ref.ensemble_softmax_ref(x, tau)[:s.shape[0]].contiguous()
    g = torch.ones((), device=DEV)
    rows = kd_check(kd_ops, kd_ref, "ResNet-56 round inputs", x, s, t, g, tau, timed=True)
    entries = [{"name": name, "route": "cuda", "source": KD_SOURCE, "replaces": KD_TPU[name],
                "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "host_ms": r["host_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
               for name, r in rows.items()]
    for e in entries:                                   # kernels 2, 3 and 4
        lm = kd6["lm"][e["name"]]
        e.update(launch_floor_ms=kd6["launch_floor_ms"],
                 lm_case=f"{'x'.join(map(str, lm['shape']))} float32",
                 lm_ms=lm["ms"], lm_bound_ms=lm["bound_ms"], lm_library_ms=lm["library_ms"])
    return entries, rounds


# ---------------------------------------------------------------- phase 9
def wa_within(out, ref, x, w) -> bool:
    """Kernel 5/6 output against the plain version; ``x`` (G, N, D) and ``w``
    (G, N) are the inputs (see the module docstring for the bounds)."""
    if out.dtype == torch.float32:
        return bool(((out - ref).abs() <= WA_ATOL + WA_RTOL * ref.abs()).all())
    want = ref.float()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2 ** -126))) - 7)
    w_hat = w / w.sum(-1, keepdim=True)
    terms = (x.float().abs() * w_hat[..., None]).sum(-2)
    return bool(((out.float() - want).abs() <= ulp + 2.0 ** -22 * terms).all())


def wa_bound(G: int, N: int, D: int, elt: int):
    """(bound_ms, bound_by): x read once, the weights read once, the output
    written once over HBM bandwidth, vs 2·G·N·D f32 operations."""
    return _bound(G * N * D * elt + G * N * 4 + G * D * elt, 2 * G * N * D)


def wa_library(x, w):
    """Yardstick only, never called by the port: the normalised weights and
    one batched product, ``einsum("gn,gnd->gd")``."""
    return torch.einsum("gn,gnd->gd", (w / w.sum(1, keepdim=True)).to(x.dtype), x)


def wa_check(wa_ops, wa_ref, label: str, x, w, timed: bool) -> dict:
    """Kernel 5 on x (G, N, D), or kernel 6 when ``x`` is (N, D)."""
    single = x.ndim == 2
    kern = wa_ops.weighted_average if single else wa_ops.group_weighted_average
    plain = wa_ref.weighted_average_ref if single else wa_ref.group_weighted_average_ref
    out, ref = kern(x, w), plain(x, w)
    torch.cuda.synchronize()
    x3, w2 = (x[None], w[None]) if single else (x, w)
    ok = (wa_within(out.reshape(ref.shape), ref, x3, w2) and out.dtype == x.dtype
          and bool(out.isfinite().all()))
    G, N, D = x3.shape
    row = {"case": label, "kernel": "weighted_average" if single else "multi_weighted_average",
           "shape": [G, N, D] if not single else [N, D],
           "dtype": str(x.dtype).removeprefix("torch."),
           "max_abs_err": float((out.float() - ref.float()).abs().max())}
    if timed:
        bound, by = wa_bound(G, N, D, x.element_size())
        lib = (lambda: wa_library(x3, w2)[0]) if single else (lambda: wa_library(x, w))
        row.update(**kernel_times(lambda: kern(x, w)), plain_ms=time_ms(lambda: plain(x, w)),
                   library_ms=time_ms(lib), bound_ms=bound, bound_by=by)
    print(json.dumps(row), flush=True)
    check(ok, f"{row['kernel']} disagrees with its plain version ({label}): {row}")
    return row


def wa_tree_check(wa_ops, wa_ref, label: str, tree, w, timed: bool = True) -> dict:
    """Kernel 5 over a tree of (G, N, ...) leaves in one call of
    ``group_weighted_average_pytree`` (one launch a dtype), each leaf held
    against the plain version; timed beside the bytes bound, the plain
    version a leaf, one einsum a leaf and one einsum over the leaves
    flattened (``flat_library_ms``)."""
    from repro_torch import kernels
    leaves = _leaves(tree)
    G, N = w.shape
    flat = [x.reshape(G, N, -1) for x in leaves]
    before = kernels.launches["multi_weighted_average"]
    out = _leaves(wa_ops.group_weighted_average_pytree(tree, w))
    launches = kernels.launches["multi_weighted_average"] - before
    torch.cuda.synchronize()
    worst = 0.0
    for x, o in zip(flat, out):
        ref = wa_ref.group_weighted_average_ref(x, w)
        check(wa_within(o.reshape(G, -1), ref, x, w) and o.dtype == x.dtype
              and bool(o.isfinite().all()), f"multi_weighted_average ({label}), leaf {x.shape}")
        worst = max(worst, float((o.reshape(G, -1).float() - ref.float()).abs().max()))
    check(len({o.untyped_storage().data_ptr() for o in out}) == 1,
          f"multi_weighted_average ({label}): the leaves are not views of one allocation")
    D = sum(x.shape[2] for x in flat)
    row = {"case": label, "kernel": "multi_weighted_average", "leaves": len(leaves),
           "shape": [G, N, D], "dtype": str(leaves[0].dtype).removeprefix("torch."),
           "launches_a_call": launches, "max_abs_err": worst}
    if timed:
        cat = torch.cat(flat, dim=2)
        bound, by = wa_bound(G, N, D, leaves[0].element_size())
        row.update(**kernel_times(lambda: wa_ops.group_weighted_average_pytree(tree, w)),
                   plain_ms=time_ms(lambda: [wa_ref.group_weighted_average_ref(x, w)
                                             for x in flat]),
                   library_ms=time_ms(lambda: [wa_library(x, w) for x in flat]),
                   library="one einsum a leaf",
                   flat_library_ms=time_ms(lambda: wa_library(cat, w)),
                   bound_ms=bound, bound_by=by)
        del cat
    print(json.dumps(row), flush=True)
    check(launches == 1, f"multi_weighted_average ({label}): {launches} launches for one tree")
    return row


def weight_avg_phase(wa_ops, wa_ref, seed: int) -> dict:
    """Kernels 5 and 6 against their plain versions; returns kernel 6's row
    at N = 32, D = 16,777,219, f32."""
    from repro_torch.configs.resnet_cifar import get_resnet_config
    from repro_torch.models.resnet import init_resnet
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shapes = [tuple(x.shape) for x in
              _leaves(init_resnet(torch.Generator(device=DEV).manual_seed(seed),
                                  get_resnet_config("resnet56")))]
    w = torch.randint(1, 7000, (4, 2), generator=gen, device=DEV).float()
    single = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        worst = 0.0
        for shp in shapes:              # every ResNet-56 leaf, G = 4 groups of N = 2
            x = torch.randn((4, 2, math.prod(shp)), generator=gen, device=DEV).to(dtype)
            out, ref = wa_ops.group_weighted_average(x, w), wa_ref.group_weighted_average_ref(x, w)
            check(wa_within(out, ref, x, w), f"multi_weighted_average, leaf {shp} {name}")
            worst = max(worst, float((out.float() - ref.float()).abs().max()))
        print(json.dumps({"case": f"every ResNet-56 leaf (G=4, N=2) {name}", "leaves": len(shapes),
                          "max_abs_err": worst}), flush=True)
        cases = [("ResNet-56 flattened (G=4, N=2)", (4, 2, 855_578), w, True),
                 ("sweep", (3, 5, 517), None, False),
                 ("large, odd D", (4, 8, 16_777_219), None, True)]
        for label, shape, wc, timed in cases:
            x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            if wc is None:
                wc = torch.randint(1, 40, shape[:2], generator=gen, device=DEV).float()
            wa_check(wa_ops, wa_ref, f"{label} {name}", x, wc, timed)
            del x
        tree = [torch.randn((4, 2) + shp, generator=gen, device=DEV).to(dtype) for shp in shapes]
        wa_tree_check(wa_ops, wa_ref, f"ResNet-56 tree (G=4, N=2) {name}", tree, w)
        del tree
        x = torch.randn((32, 16_777_219), generator=gen, device=DEV).to(dtype)
        w1 = torch.randint(1, 40, (32,), generator=gen, device=DEV).float()
        row = wa_check(wa_ops, wa_ref, f"kernel 6, N=32, odd D {name}", x, w1, timed=True)
        single = single or row
        del x
    torch.cuda.empty_cache()
    return single


# ---------------------------------------------------------------- phase 10
def vectorized_cnn_phase(fed, seed: int) -> None:
    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map
    torch.backends.cudnn.deterministic = True
    task = classification_task(model="cnn", num_clients=8, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, distill_steps=20,
              client_lr=0.05, server_lr=0.05, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {}
    for execution in ("vectorized", "sequential"):
        runner = fed.make_runner("fedsdd", task, device=DEV, execution=execution, **kw)
        state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                             ensemble=fed.TeacherBank(4, 2))
        kernels.launches.clear()
        state = runner.run(2, state=state)
        torch.cuda.synchronize()
        runs[execution] = (state, dict(kernels.launches))
    torch.backends.cudnn.deterministic = False
    (vec, launches), (seq, seq_launches) = runs["vectorized"], runs["sequential"]
    errs = [_tree_err(a, b) for a, b in zip(vec.global_models, seq.global_models)]
    n_leaves = len(_leaves(init[0]))
    print(json.dumps({"phase": "f32 CNN round, vectorized vs sequential", "models_max_abs_err": errs,
                      "tol": ROUND_TOL, "launches": launches, "launches_sequential": seq_launches,
                      "leaves": n_leaves,
                      "acc_main": [r["acc_main"] for r in vec.history],
                      "acc_main_sequential": [r["acc_main"] for r in seq.history]}), flush=True)
    check(all(torch.allclose(a, b, rtol=ROUND_TOL, atol=ROUND_TOL)
              for m, n in zip(vec.global_models, seq.global_models)
              for a, b in zip(_leaves(m), _leaves(n))),
          f"vectorized CNN round: models beyond 2e-4 of the sequential run ({errs})")
    check(launches.get("multi_weighted_average") == 2,
          f"vectorized CNN round: launches {launches}, want one a round ({n_leaves} leaves)")
    check(not seq_launches.get("multi_weighted_average"),
          f"sequential CNN round launched kernel 5: {seq_launches}")


# ---------------------------------------------------------------- phase 11
def resnet56_vectorized_phase(fed, wa_ops, wa_ref, seed: int, card: str,
                              sequential_rounds: list[dict]) -> dict:
    import dataclasses
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map, tree_stack
    task = classification_task(model="resnet56", num_clients=20, alpha=0.1, num_train=50000,
                               num_server=2048, server_batch=256, seed=seed, device=DEV)
    tau, steps_kd = 4.0, 200
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=20,
                             participation=0.4, client_batch=64, client_lr=0.05,
                             server_lr=0.05, temperature=tau, local_epochs=1,
                             distill_steps=steps_kd, seed=seed, execution="vectorized")
    state = runner.init_state()
    eng = runner._make_engine()
    plans, agg_inputs = [], []
    train_round, aggregate_groups = eng.train_round, fed.aggregate_groups

    def recording_train_round(rplan, *a, **k):
        plans.append(rplan.plans)
        return train_round(rplan, *a, **k)

    def recording_aggregate(stacked, sizes, gids, K):
        agg_inputs[:] = [(stacked, sizes, gids, K)]
        return aggregate_groups(stacked, sizes, gids, K)

    eng.train_round = recording_train_round
    torch.cuda.synchronize()
    kernels.launches.clear()
    rounds, launches = [], Counter()
    with mock.patch.object(fed, "aggregate_groups", recording_aggregate):
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            t0, captures0 = time.perf_counter(), captured()
            with card_launches() as ran:
                if i == 0:
                    state = runner.run(1, state=state)
                else:   # round 2, the steady state, under the contracts
                    with contracts("ResNet-56 round 2, vectorized", run_owners(runner),
                                   (*KD_PATH, "multi_weighted_average")) as held:
                        state = runner.run(1, state=state)
            launches.update(ran)
            rec = state.history[-1]
            real = int(sum(p.num_steps.sum() for p in plans[-1]))
            padded = int(sum(p.step_mask.numel() for p in plans[-1]))
            rounds.append({"round": rec["round"], "active": rec["active"],
                           "captures": captured() - captures0,
                           "buckets": [[len(p.cids), int(p.step_mask.shape[1]), p.batch_size]
                                       for p in plans[-1]],
                           "real_client_steps": real, "padded_client_steps": padded,
                           "host_steps": int(sum(p.step_mask.shape[1] for p in plans[-1])),
                           "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                           "t_kd_s": rec["t_kd"], "acc_main": rec["acc_main"],
                           "client_steps_per_s": real / rec["t_local"],
                           "kd_steps_per_s": steps_kd / rec["t_kd"],
                           "kd_loss_first": rec["kd_loss_first"],
                           "kd_loss_last": rec["kd_loss_last"],
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    launches, host = dict(launches), dict(kernels.launches)
    eng.train_round = train_round
    peak = max(r["peak_mem_gb"] for r in rounds)
    contracts_line(held, card)
    for r, seq in zip(rounds, sequential_rounds):
        print(json.dumps({"phase": "ResNet-56 FedSDD round, vectorized", "card": card, **r,
                          "sequential_t_local_s": seq["t_local_s"],
                          "sequential_client_steps": seq["client_steps"]}), flush=True)
    n_leaves = len(_leaves(state.global_models[0]))
    print(json.dumps({"phase": "ResNet-56 FedSDD run, vectorized", "card": card, "rounds": 2,
                      "launches": launches, "wrapper_launches": host, "leaves": n_leaves,
                      "teachers": state.ensemble.num_members, "peak_mem_gb": peak}), flush=True)
    check(len(state.history) == 2, "vectorized ResNet-56: two history records")
    check(rounds[1]["captures"] == 0,
          f"vectorized ResNet-56: round 2 captured {rounds[1]['captures']}")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"vectorized ResNet-56: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "vectorized ResNet-56: the ring does not hold 8 teachers")
    check(host.get("multi_weighted_average") == 2 and n_leaves > 0,
          f"vectorized ResNet-56: kernel 5 launches {host}, want one a round "
          f"({n_leaves} leaves)")
    check(launches.get("ensemble_softmax") == 2 and launches.get("kd_loss_fwd") == 2 * steps_kd
          and launches.get("kd_loss_bwd") == 2 * steps_kd
          and all(host.get(k) for k in ("ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd")),
          f"vectorized ResNet-56: KD launches {launches} on the card, {host} by the wrappers")
    check(all(_tree_err(state.global_models[k], state.global_models[0]) > 0
              for k in range(1, 4)), "vectorized ResNet-56: a model k>0 equals the main model")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "vectorized ResNet-56: non-finite weights")

    # where a vmapped step's time goes: the last round's bucket, its first 10 steps
    plan = max(plans[-1], key=lambda p: len(p.cids))
    plan10 = dataclasses.replace(plan, indices=plan.indices[:, :10],
                                 step_mask=plan.step_mask[:, :10],
                                 num_steps=np.minimum(plan.num_steps, 10))
    gid = torch.from_numpy(plan.group_of).to(DEV)
    stacked_k = tree_stack(state.global_models)
    w0 = tree_map(lambda x: x[gid], stacked_k)
    s0 = eng.optimizer.init(w0)
    label = (f"10 vmapped client steps, ResNet-56, {len(plan.cids)} clients x batch "
             f"{plan.batch_size} (conv = cuDNN grouped convolutions, groups = clients)")
    profile_window_modes(label, lambda: eng.train_bucket(plan10, w0, s0), 10, card)

    # kernel 5 at the last round's own Eq. 2 inputs: the (8, ...) client stack
    # in group-major order, viewed as (K=4, 2, ...) per leaf, as
    # fedavg_aggregate_grouped hands it to the tree call
    stacked, sizes, gids, K = agg_inputs[0]
    n = len(sizes) // K
    check(len(sizes) == K * n and bool((np.diff(gids) >= 0).all()),
          "vectorized ResNet-56: the round's groups are not uniform")
    w = torch.as_tensor(np.asarray(sizes, np.float64).reshape(K, n), dtype=torch.float32,
                        device=DEV)
    regrouped = tree_map(lambda x: x.reshape((K, n) + tuple(x.shape[1:])), stacked)
    row = wa_tree_check(wa_ops, wa_ref, "ResNet-56 round inputs, one launch for the tree",
                        regrouped, w)
    flat = [x.reshape(K, n, -1) for x in _leaves(stacked)]
    before = {"case": "before: the same inputs one launch a leaf (the per-leaf loop)",
              "launches_a_call": len(flat),
              **kernel_times(lambda: [wa_ops.group_weighted_average(x, w) for x in flat])}
    print(json.dumps(before), flush=True)
    return {"name": "multi_weighted_average", "route": "cuda", "source": WA_SOURCE,
            "replaces": WA_TPU["multi_weighted_average"],
            "launches": host["multi_weighted_average"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "flat_library_ms": row["flat_library_ms"], "before_loop_ms": before["ms"],
            "before_loop_host_ms": before["host_ms"]}, host


# ---------------------------------------------------------------- phase 12
def flash_plain(flash) -> dict:
    """The Flash-KD kernels' plain versions by wrapper name."""
    return {"flash_kd_fwd": flash.flash_kd_fwd_tiled, "flash_kd_bwd": flash.flash_kd_bwd_ref,
            "flash_kd_head_fwd": flash.flash_kd_head_fwd_tiled,
            "flash_kd_head_bwd": flash.flash_kd_head_bwd_tiled}


def plain_flash(kd_ops, flash):
    """The four Flash-KD wrappers patched to their plain versions."""
    from contextlib import ExitStack
    from unittest import mock
    plain = flash_plain(flash)
    fns = {"flash_kd_fwd": lambda s, t, tau=1.0, tile_v=None, teacher_lse=None:
           plain["flash_kd_fwd"](s, t, tau, tile_v or flash.DEFAULT_TILE_V_HOST,
                                 teacher_lse=teacher_lse),
           "flash_kd_bwd": plain["flash_kd_bwd"],
           "flash_kd_head_fwd": lambda h, w, b, t, tau=1.0, tile_v=None, teacher_lse=None:
           plain["flash_kd_head_fwd"](h, w, b, t, tau, tile_v or flash.DEFAULT_TILE_V_HOST,
                                      teacher_lse=teacher_lse),
           "flash_kd_head_bwd": lambda h, w, b, t, ls, lt, g, tau=1.0, tile_v=None:
           plain["flash_kd_head_bwd"](h, w, b, t, ls, lt, g, tau,
                                      tile_v or flash.DEFAULT_TILE_V_HOST)}
    stack = ExitStack()
    for name, fn in fns.items():
        stack.enter_context(mock.patch.object(kd_ops, name, fn))
    return stack


def _bound(nbytes: float, ops: float, dtype: torch.dtype = torch.float32):
    """(bound_ms, bound_by): the larger of ``roofline``'s memory term for
    ``nbytes`` and its compute term for ``ops`` on ``dtype`` (one card)."""
    from repro_torch.utils.hlo import roofline
    t = roofline(ops, nbytes, 0.0, 1, spec=SPEC, dtype=str(dtype).removeprefix("torch."))
    t_bytes, t_ops = t.memory_s * 1e3, t.compute_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def head_products(name: str, es: int) -> int:
    """bf16 tensor-core products per 2·B·D·V that kernels 9 and 10's
    functions need to hold phase 12's bounds.  Kernel 10 splits each f32
    operand into bf16 hi and lo and runs a product as hi·hi + hi·lo +
    lo·hi, 3 for each of its 3 GEMMs, since one product misses its bound; a
    bf16 head has no lo half (dW 2, dh 2, logits 1).  Kernel 9 runs the
    same three for its logits, but one product holds its bounds and, through
    lse_s, kernel 10's (tests/test_torch_flash_kd.py, section (g)), so its
    bound counts one."""
    if name == "flash_kd_head_fwd":
        return 1
    return 9 if es == 4 else 5


def flash_bound(name: str, B: int, V: int, D: int, es: int, et: int, bias: bool, lse: bool):
    """(bound_ms, bound_by): every input read once and every output written
    once over HBM, vs the operations over their peak: kernels 7 and 8 in
    f32 on the CUDA cores (about 10 per (row, column) for the streaming
    epilogue); kernels 9 and 10 the bf16 tensor-core products their
    functions need (``head_products``) at the bf16 dense peak.
    ``head_bounds`` gives the others for comparison."""
    rows = B * 4 * (2 if name.endswith("bwd") else 1) + (B * 4 if lse else 0) + 12
    if name == "flash_kd_fwd":                  # s, t -> loss, lse_s, lse_t
        return _bound(B * V * (es + et) + rows, 10 * B * V)
    if name == "flash_kd_bwd":                  # s, t, lse_s, lse_t, g -> ds
        return _bound(B * V * (2 * es + et) + rows, 8 * B * V)
    head = D * V * es + B * D * es + (V * es if bias else 0) + B * V * et + rows
    ops = head_products(name, es) * 2 * B * D * V
    if name == "flash_kd_head_fwd":             # h, W, b, t -> loss, lse_s, lse_t
        return _bound(head, ops, torch.bfloat16)
    return _bound(head + D * V * es + B * D * es + (V * es if bias else 0),   # + dh, dW, db
                  ops, torch.bfloat16)


def head_bounds(name: str, B: int, V: int, D: int, es: int) -> dict:
    """Kernel 9's or 10's operation bounds beside the one it reports: kernel
    9's logits as the products it runs (three on an f32 head), kernel 10's
    GEMMs as one bf16 product each (which misses its bound), and both in
    f32 on the CUDA cores (their earlier design)."""
    gemms = 1 if name == "flash_kd_head_fwd" else 3
    one = gemms * 2 * B * D * V / PEAK_FLOPS[torch.bfloat16] * 1e3
    f32 = (gemms * 2 * B * D * V + 10 * B * V) / PEAK_FLOPS[torch.float32] * 1e3
    if name == "flash_kd_head_fwd":
        return {"bound_as_run_ms": one * (3 if es == 4 else 1), "bound_f32_cuda_cores_ms": f32}
    return {"bound_one_bf16_product_ms": one, "bound_f32_cuda_cores_ms": f32}


FLASH_LIBRARY = {   # yardsticks only, never called by the port
    "flash_kd_fwd": "kl_div(log_softmax(s / tau), softmax(t / tau), 'batchmean') * tau^2",
    "flash_kd_bwd": "its backward through autograd",
    "flash_kd_head_fwd": "h @ W (+ b), then the kl_div composition",
    "flash_kd_head_bwd": "its backward to h, W (and b) through autograd",
}


def _library_loss(s, t, tau):
    return torch.nn.functional.kl_div(torch.log_softmax(s.float() / tau, -1),
                                      torch.softmax(t.float() / tau, -1),
                                      reduction="batchmean") * tau ** 2


def _ulp(ref):
    return 2.0 ** (torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126))) - 7)


def flash_check(kd_ops, flash, label, s=None, h=None, w=None, b=None, z=None, tau=4.0,
                lse=True, timed=False) -> dict:
    """One kernel pair (7/8 with ``s``, 9/10 with ``h, w``) against its plain
    versions on the same inputs; returns {name: row} and checks each (see
    the module docstring for the bounds)."""
    head = s is None
    fwd, bwd = ("flash_kd_head_fwd", "flash_kd_head_bwd") if head else ("flash_kd_fwd",
                                                                      "flash_kd_bwd")
    plain = flash_plain(flash)
    tl = kd_ops.teacher_cache_lse(z, tau) if lse else None
    g = torch.tensor(1.5, device=DEV)
    if head:
        fargs = (h, w, b, z, tau)
        got = kd_ops.flash_kd_head_fwd(*fargs, teacher_lse=tl)
        want = plain[fwd](*fargs, teacher_lse=tl)
        bargs = (h, w, b, z, want[1], want[2], g, tau)
    else:
        fargs = (s, z, tau)
        got = kd_ops.flash_kd_fwd(*fargs, teacher_lse=tl)
        want = plain[fwd](*fargs, teacher_lse=tl)
        bargs = (s, z, want[1], want[2], g, tau)
    gk = getattr(kd_ops, bwd)(*bargs)
    gp = plain[bwd](*bargs)
    torch.cuda.synchronize()
    B, V = z.shape
    lse_scale = float(torch.maximum(want[1].abs().max(), want[2].abs().max()))
    loss_err = abs(float(got[0]) - float(want[0]))
    loss_tol = ((FLASH_HEAD_LOSS_RTOL if head else FLASH_LOSS_RTOL) * abs(float(want[0]))
                + ULP_LSE * tau ** 2 * lse_scale)
    lse_err = max(float((a - c).abs().max()) for a, c in zip(got[1:], want[1:]))
    fwd_ok = (loss_err <= loss_tol and bool(got[0].isfinite())
              and all(bool(((a - c).abs() <= FLASH_LSE_RTOL * c.abs() + ULP_LSE * lse_scale)
                           .all()) for a, c in zip(got[1:], want[1:])))
    c = 1.5 * tau / B
    st = (h.float() @ w.float() + (0 if b is None else b.float())) if head else s.float()
    mag = (torch.exp(st / tau - want[1][:, None]) + torch.exp(z.float() / tau - want[2][:, None])) * c
    if head:
        bounds = [mag @ w.float().abs().T, h.float().abs().T @ mag, mag.sum(0)]
        pairs = [(x, y, SUM_TOL * bd) for x, y, bd in zip(gk, gp, bounds) if x is not None]
        bwd_ok = gk[1].stride() == w.stride() and (gk[2] is None) == (b is None)
    else:
        pairs = [(gk, gp, FLASH_GRAD_TOL * mag + c * 2.0 ** -126)]
        bwd_ok = True
    bwd_err = 0.0
    for x, y, bound in pairs:
        bound = bound + (_ulp(y) if x.dtype == torch.bfloat16 else 0)
        diff = (x.float() - y.float()).abs()
        bwd_ok = bwd_ok and x.dtype == y.dtype and bool((diff <= bound).all()) \
            and bool(x.isfinite().all())
        bwd_err = max(bwd_err, float(diff.max()))
    del st, mag
    es = (h if head else s).element_size()
    D = h.shape[1] if head else 0
    case = {"case": label, "shape": [B, D, V] if head else [B, V],
            "dtype": str((h if head else s).dtype).removeprefix("torch."),
            "cache": str(z.dtype).removeprefix("torch."), "teacher_lse": lse,
            "bias": b is not None, "tied": bool(head and w.stride(0) == 1), "tau": tau}
    rows = {fwd: {**case, "kernel": fwd, "max_abs_err": loss_err, "tol": loss_tol,
                  "lse_max_abs_err": lse_err},
            bwd: {**case, "kernel": bwd, "max_abs_err": bwd_err}}
    if timed:
        rows[fwd].update(**kernel_times(lambda: getattr(kd_ops, fwd)(*fargs, teacher_lse=tl)),
                         plain_ms=time_ms(lambda: plain[fwd](*fargs, teacher_lse=tl)))
        rows[bwd].update(**kernel_times(lambda: getattr(kd_ops, bwd)(*bargs)),
                         plain_ms=time_ms(lambda: plain[bwd](*bargs)))
        leaves = [x.detach().requires_grad_(True) for x in ((h, w) if head else (s,))]
        if head and b is not None:
            leaves.append(b.detach().requires_grad_(True))

        def lib_fwd():
            st = (leaves[0] @ leaves[1] + (leaves[2] if len(leaves) > 2 else 0)) if head \
                else leaves[0]
            return _library_loss(st, z, tau)

        with torch.no_grad():
            rows[fwd]["library_ms"] = time_ms(lib_fwd)
        loss = lib_fwd()
        rows[bwd]["library_ms"] = time_ms(lambda: torch.autograd.grad(loss, leaves,
                                                                      retain_graph=True))
        del loss
        for name in (fwd, bwd):
            rows[name]["bound_ms"], rows[name]["bound_by"] = flash_bound(
                name, B, V, D, es, z.element_size(), b is not None, lse)
            rows[name]["library"] = FLASH_LIBRARY[name]
        if head:
            for name in (fwd, bwd):
                rows[name].update(head_bounds(name, B, V, D, es))
    for name in (fwd, bwd):
        print(json.dumps(rows[name]), flush=True)
    check(fwd_ok, f"{fwd} disagrees with its plain version ({label}): {rows[fwd]}")
    check(bwd_ok, f"{bwd} disagrees with its plain version ({label}): {rows[bwd]}")
    return rows


# the last families' heads, D x V: (key on the kernels line, model)
FRONTEND_HEADS = (("llama4", "llama4-maverick-400b-a17b", 5120, 202048),
                  ("hubert", "hubert-xlarge", 1280, 504),
                  ("llava", "llava-next-mistral-7b", 4096, 32000))


def flash_phase(kd_ops, flash, seed: int) -> dict:
    """Kernels 7-10 against their plain versions; returns the rows timed at
    the LM path's shapes: 512 rows, V = 256,000 (gemma-2b), D = 2,048,
    f32 student or head, bf16 cache with its lse, the tied head; and under
    "deepseek" kernels 9 and 10's rows at deepseek-v2-lite-16b's untied head
    (V = 102,400), under "llama4", "hubert" and "llava" theirs at those
    models' untied heads (``FRONTEND_HEADS``: D x V)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    timed = {}

    def rnd(shape, scale, dtype=f32):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    # kernels 7/8: every (rows, V), both caches, teacher lse on and off
    for B in (1, 5, 512):
        for V in (517, 50304, 256000):
            for cache in (f32, bf16):
                for lse in (True, False):
                    main = (B, V, cache, lse) == (512, 256000, bf16, True)
                    rows = flash_check(kd_ops, flash, f"{B}x{V}", s=rnd((B, V), 3),
                                       z=rnd((B, V), 3, cache), lse=lse, timed=main)
                    if main:
                        timed.update(rows)
    torch.cuda.empty_cache()
    # kernels 9/10 at D = 2,048: the path's options at every (rows, V) ...
    D = 2048
    for V in (517, 50304, 256000):
        embed = rnd((V, D), 0.02)
        for B in (1, 5, 512):
            main = (B, V) == (512, 256000)
            rows = flash_check(kd_ops, flash, f"{B}x{D}x{V} tied", h=rnd((B, D), 1),
                               w=embed.T, z=rnd((B, V), 3, bf16), timed=main)
            if main:
                timed.update(rows)
        del embed
        torch.cuda.empty_cache()
    # deepseek-v2-lite-16b's head: untied, V = 102,400, timed; then the last
    # families' heads (llama4-maverick, hubert-xlarge, llava), untied, timed
    for key, model, Dh, V in (("deepseek", "deepseek-v2-lite-16b", D, 102400),
                              *FRONTEND_HEADS):
        w = rnd((Dh, V), 0.02)
        timed[key] = flash_check(kd_ops, flash, f"512x{Dh}x{V} untied ({model})",
                                 h=rnd((512, Dh), 1), w=w, z=rnd((512, V), 3, bf16),
                                 timed=True)
        del w
        torch.cuda.empty_cache()
    # ... and every option where it is cheap: untied, bias, f32 cache, no lse
    for B, V in ((5, 50304), (512, 517)):
        for tied in (True, False):
            w = rnd((V, D), 0.02).T if tied else rnd((D, V), 0.02)
            for bias in (False, True):
                for cache in (f32, bf16):
                    for lse in (True, False):
                        flash_check(kd_ops, flash, f"{B}x{D}x{V} options", h=rnd((B, D), 1),
                                    w=w, b=rnd((V,), 0.5) if bias else None,
                                    z=rnd((B, V), 3, cache), lse=lse)
    # a bf16 head and features
    for B, V in ((5, 517), (512, 50304)):
        flash_check(kd_ops, flash, f"{B}x{D}x{V} bf16 head", h=rnd((B, D), 1, bf16),
                    w=rnd((V, D), 0.02, bf16).T, b=rnd((V,), 0.5, bf16), z=rnd((B, V), 3, bf16))
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------- phase 13
def lm_round_phase(fed, kd_ops, flash, seed: int) -> dict:
    """Returns the launches of the unfused flash run (kernels 7/8's path)."""
    import dataclasses
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    from repro_torch.utils.pytree import tree_map
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), vocab_size=50304)
    task = lm_task(cfg, num_clients=8, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    kw = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, client_batch=4,
              distill_steps=20, client_lr=0.01, server_lr=0.01, seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    runs = {
        "head-fused, kernels": dict(kd_kernel="flash", kd_head_fusion=True,
                                    teacher_cache_dtype="float32"),
        "head-fused, plain": dict(kd_kernel="flash", kd_head_fusion=True,
                                  teacher_cache_dtype="float32"),
        "flash, kernels": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
        "flash, plain": dict(kd_kernel="flash", teacher_cache_dtype="float32"),
        "dense, kernels 2-4": dict(kd_kernel="dense"),
        "head-fused bf16 cache, kernels": dict(kd_kernel="flash", kd_head_fusion=True),
        "head-fused bf16 cache, plain": dict(kd_kernel="flash", kd_head_fusion=True),
        # the same rounds without KD: how far the 20 KD steps a round move the
        # main model, beside the tolerance the pairs below are held to
        "no KD": dict(kd_kernel="flash", distill_steps=0),
    }
    # the client steps must repeat bit for bit (the embedding's backward
    # accumulates with atomics unless asked not to)
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for label, opts in runs.items():
            runner = fed.make_runner("fedsdd", task, device=DEV, **{**kw, **opts})
            state = fed.FedState(round=0,
                                 global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(4, 2))
            kernels.launches.clear()
            with plain_flash(kd_ops, flash) if label.endswith("plain") else nullcontext(), \
                    card_launches() as ran:
                state = runner.run(2, state=state)
            out[label] = (state, dict(ran), dict(kernels.launches))
    finally:
        torch.use_deterministic_algorithms(False)
    steps = 2 * kw["distill_steps"]
    summary = {"phase": "f32 LM rounds (gemma-2b reduced, V=50,304), kernels vs plain",
               "tol": ROUND_TOL, "launches": {k: v[1] for k, v in out.items()},
               "wrapper_launches": {k: v[2] for k, v in out.items()},
               "kd_change_main_max_abs": {
                   k: _tree_err(v[0].global_models[0], out["no KD"][0].global_models[0])
                   for k, v in out.items() if k.endswith("kernels") or "kernels 2-4" in k}}
    pairs = (("head-fused, kernels", "head-fused, plain"), ("flash, kernels", "flash, plain"),
             ("head-fused bf16 cache, kernels", "head-fused bf16 cache, plain"),
             ("head-fused, kernels", "dense, kernels 2-4"), ("flash, kernels",
                                                            "dense, kernels 2-4"))
    for a, b in pairs:
        sa, sb = out[a][0], out[b][0]
        err = _tree_err(sa.global_models[0], sb.global_models[0])
        rest = all(torch.equal(x, y) for k in range(1, 4) for x, y in
                   zip(_leaves(sa.global_models[k]), _leaves(sb.global_models[k])))
        summary[f"{a} vs {b}"] = {"main_max_abs_err": err, "models_k>0_bit_identical": rest,
                                  "kd_loss_last": [r["kd_loss_last"] for r in sa.history],
                                  "kd_loss_last_other": [r["kd_loss_last"] for r in sb.history]}
    print(json.dumps(summary), flush=True)
    for a, b in pairs:
        sa, sb = out[a][0], out[b][0]
        check(all(torch.allclose(x, y, rtol=ROUND_TOL, atol=ROUND_TOL) for x, y in
                  zip(_leaves(sa.global_models[0]), _leaves(sb.global_models[0]))),
              f"LM rounds: main model, {a} vs {b}, beyond 2e-4")
        check(summary[f"{a} vs {b}"]["models_k>0_bit_identical"],
              f"LM rounds: models k>0 differ between {a} and {b}")
        check(all(bool(x.isfinite().all()) for x in _leaves(sa.global_models[0])),
              f"LM rounds: non-finite main model ({a})")
    want = {"head-fused, kernels": {"flash_kd_head_fwd": steps, "flash_kd_head_bwd": steps},
            "head-fused bf16 cache, kernels": {"flash_kd_head_fwd": steps,
                                               "flash_kd_head_bwd": steps},
            "flash, kernels": {"flash_kd_fwd": steps, "flash_kd_bwd": steps},
            "dense, kernels 2-4": {"ensemble_softmax": 2, "kd_loss_fwd": steps,
                                   "kd_loss_bwd": steps}}
    for label, (_, launches, host) in out.items():
        check(launches == want.get(label, {}) and all(host.get(k) for k in launches)
              and set(k for k, n in host.items() if n) <= set(launches),
              f"LM rounds ({label}): launches {launches} on the card, {host} by the wrappers")
    return out["flash, kernels"][1]


# ---------------------------------------------------------------- phase 14
def _kd_groups(kern) -> dict:
    """Device ms of the profiled kernels ``kern`` by group: kernels 9 and 10
    own their GEMM and reduction passes through their namespaces (k9::,
    k10::; the GEMM through its epilogue's type).  The W/h split pass
    (split_gemm::split_planes) is shared, and each of its launches goes to
    the kernel whose pass runs next on the stream."""
    groups = dict.fromkeys(("flash_kd_head_fwd", "flash_kd_head_bwd", "backbone"), 0.0)
    pending = 0.0
    for e in sorted(kern, key=lambda e: e.time_range.start):
        low = e.name.lower()
        ms = e.self_device_time_total / 1e3
        if "split_planes" in low:
            pending += ms
        elif "k9::" in low or "flash_combine" in low:   # kernel 7's combine is not on this path
            groups["flash_kd_head_fwd"] += ms + pending
            pending = 0.0
        elif "k10::" in low:
            groups["flash_kd_head_bwd"] += ms + pending
            pending = 0.0
        else:
            groups["backbone"] += ms
    groups["backbone"] += pending
    return groups


# the same profile with kernel 9 on the f32 CUDA cores and kernel 10 on its
# bf16 GEMM (PERF.md §5, the profile before kernel 9's redesign; NVIDIA H100
# 80GB HBM3, 700 W): device ms of a head-fused KD step and kernels 9 and
# 10's shares of it, printed beside this run's for comparison only
CUDA_CORE_KERNEL_9_KD_STEP = {"device_ms_per_step": 67.2, "flash_kd_head_fwd": 27.4 / 67.2,
                              "flash_kd_head_bwd": 9.32 / 67.2}


def gemma_phase(fed, seed: int, card: str) -> dict:
    """gemma-2b at full width, 2 of 18 layers, f32: FedSDD with head-fused
    Flash-KD; returns the launches of the run."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    t0 = time.perf_counter()
    task = lm_task(cfg, num_clients=8, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    steps_kd, tau = 20, 4.0
    # the ring in bf16 (teacher_dtype, the reference's option; the teachers
    # still forward in f32): with an f32 ring, round 2 peaked at 79.1 GB
    # (4 old and 4 new globals, 8 client models and 8 teachers, 2.98 GB each)
    runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2, num_clients=8,
                             participation=1.0, client_batch=4, local_epochs=1,
                             distill_steps=steps_kd, client_lr=0.01, server_lr=0.01,
                             temperature=tau, kd_kernel="flash", kd_head_fusion=True,
                             teacher_dtype="bfloat16", seed=seed)
    state = runner.init_state()
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(state.global_models[0]))
    print(f"task and init: {time.perf_counter() - t0:.1f} s; {n_params:,} parameters per "
          f"model ({n_params * 4 / 1e9:.2f} GB f32)", flush=True)
    pipe = runner._kd_pipeline()
    check(pipe.head_fused and pipe.cache_dtype == torch.bfloat16,
          "gemma-2b: the KD pipeline is not head-fused with a bf16 cache")
    cache_ev = []
    build_cache = pipe.precompute_cache

    def timed_cache(*a, **k):       # CUDA events: no host wait inside the round
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = build_cache(*a, **k)
        ev[1].record()
        cache_ev.append(ev)
        return out

    pipe.precompute_cache = timed_cache
    rounds = []
    torch.cuda.synchronize()
    kernels.launches.clear()
    launches = Counter()
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0, captures0 = time.perf_counter(), captured()
        with card_launches() as ran:
            if i == 0:
                state = runner.run(1, state=state)
            else:       # round 2, the steady state, under the contracts
                with contracts("gemma-2b round 2, head-fused Flash-KD", run_owners(runner),
                               ("flash_kd_head_fwd", "flash_kd_head_bwd")) as held:
                    state = runner.run(1, state=state)
        launches.update(ran)
        rec = state.history[-1]
        rounds.append({"round": rec["round"], "active": rec["active"],
                       "captures": captured() - captures0,
                       "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                       "t_kd_s": rec["t_kd"],
                       "t_cache_s": cache_ev[-1][0].elapsed_time(cache_ev[-1][1]) / 1e3,
                       "kd_steps_per_s": steps_kd / rec["t_kd"],
                       "kd_loss_first": rec["kd_loss_first"], "kd_loss_last": rec["kd_loss_last"],
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "graph_pool_gb": graph_pool_gb(),
                       "launches": dict(ran)})
    launches, host = dict(launches), dict(kernels.launches)
    pipe.precompute_cache = build_cache
    contracts_line(held, card)
    for r in rounds:
        print(json.dumps({"phase": "gemma-2b FedSDD round, head-fused Flash-KD", "card": card,
                          **r}), flush=True)
    print(json.dumps({"phase": "gemma-2b FedSDD run", "card": card, "rounds": 2,
                      "launches": launches, "wrapper_launches": host,
                      "teachers": state.ensemble.num_members,
                      "teacher_bank_gb": state.ensemble.nbytes() / 1e9,
                      "cache_mb": pipe.cache_nbytes(state.ensemble.member_views(),
                                                    pipe.batches_for(task.server_batches)) / 1e6,
                      "peak_mem_gb": max(r["peak_mem_gb"] for r in rounds)}), flush=True)
    check(len(state.history) == 2, "gemma-2b: two history records")
    check(rounds[1]["captures"] == 0, f"gemma-2b: round 2 captured {rounds[1]['captures']}")
    check(all(math.isfinite(r["kd_loss_first"]) and math.isfinite(r["kd_loss_last"])
              for r in rounds), f"gemma-2b: non-finite KD losses {rounds}")
    check(state.ensemble.num_members == 8, "gemma-2b: the ring does not hold 8 teachers")
    check(all(r["launches"].get("flash_kd_head_fwd") == steps_kd
              and r["launches"].get("flash_kd_head_bwd") == steps_kd for r in rounds)
          and host.get("flash_kd_head_fwd") and host.get("flash_kd_head_bwd"),
          f"gemma-2b: kernels 9/10 not launched {steps_kd} times a round on the card: "
          f"{[r['launches'] for r in rounds]}; by the wrappers {host}")
    check(not any(launches.get(k) for k in ("flash_kd_fwd", "flash_kd_bwd", "kd_loss_fwd",
                                            "kd_loss_bwd", "ensemble_softmax")),
          f"gemma-2b: another KD kernel ran: {launches}")
    check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          "gemma-2b: non-finite weights")
    check(_tree_err(state.global_models[1], state.global_models[0]) > 0,
          "gemma-2b: model 1 equals the main model")

    # where a KD step's time goes: the round's own KD program (its 20
    # head-fused steps) over the last round's cache (rebuilt in the
    # program's cache buffer), under each step mode
    batches = pipe.batches_for(task.server_batches)
    student = state.global_models[0]
    cache = pipe._cache(student, state.ensemble.member_views(), batches)
    n = steps_kd
    windows = {}
    for mode in STEP_MODES:
        with step_mode(mode):
            pipe._run(student, batches, cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe._run(student, batches, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pipe._run(student, batches, cache)
                torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n
        span_ms = busy_ms_of(prof) / n
        groups = {k: ms / n for k, ms in _kd_groups(
            [e for e in prof.events() if e.device_type == DeviceType.CUDA]).items()}
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        share = {k: groups[k] / busy_ms for k in ("flash_kd_head_fwd", "flash_kd_head_bwd")} \
            if kern else None
        windows[mode] = {
            "phase": f"profile: {n} head-fused KD steps, gemma-2b full width, 512 rows",
            "card": card, "step_mode": mode, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": busy_ms if kern else None,
            "idle_share": 1 - busy_ms / wall_ms if kern else None,
            "busy_ms_per_step": span_ms, "busy_idle_share": 1 - span_ms / wall_ms,
            "device_ms_by_group": groups, "device_share": share,
            "device_share_cuda_core_kernel_9": CUDA_CORE_KERNEL_9_KD_STEP,
            "kernel_launches_per_step": sum(e.count for e in kern) / n,
            "peak_mem_gb_so_far": peak_gb,
            "top_kernels": [{"name": e.key[:80], "per_step": e.count / n,
                             "ms_per_step": e.self_device_time_total / 1e3 / n}
                            for e in top]}
        print(json.dumps(windows[mode]), flush=True)
        check(bool(kern) and groups["flash_kd_head_fwd"] > 0 and groups["flash_kd_head_bwd"] > 0,
              f"gemma-2b profile ({mode}): no device time for kernels 9/10: {groups}")
    mode_windows("gemma-2b head-fused KD step", windows, card)
    del state, runner, pipe, cache, student, task
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- phase 15
# (name, H, Hkv, dh) of the registered configs at full width
FA_CONFIGS = [("qwen2.5-14b", 40, 8, 128), ("gemma-2b", 8, 1, 256),
              ("stablelm-3b", 32, 32, 80), ("starcoder2-3b", 24, 2, 128)]
FA_SWEEP = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 256, 4, 4, 128)]
FA_MODES = [(True, 0), (True, 64), (False, 0)]
FA_DECODE_SWEEP = [(2, 1024, 4, 2, 64, 700), (1, 512, 8, 1, 32, 512), (2, 512, 4, 4, 128, 1)]
# dh 80 (stablelm-3b: the bf16 kernel pads it to 128) and dh 256 (gemma-2b),
# a ragged Sq below one Pallas block for each
FA_WIDE_HEADS = [(1, 384, 4, 4, 80), (1, 100, 2, 1, 80), (1, 256, 4, 2, 256),
                 (1, 100, 2, 1, 256)]
FA_FULL_S = 4096                      # the configs' forward at full width
FA_WINDOW_CASE = (16384, 4096)        # starcoder2-3b: S, its window
FA_BWD = (4096, 40, 8, 128)           # S, H, Hkv, dh: qwen2.5-14b's width
FA_DECODE = [("bench", 8, 4096, 8, 8, 64, torch.float32),      # label, B, S, H, Hkv, dh
             ("qwen2.5-14b decode_32k", 8, 32768, 40, 8, 128, torch.bfloat16)]


def fa_close(out, ref) -> tuple[float, bool]:
    """f32 at rtol = atol = FA_F32_TOL; bf16 within one bf16 ulp of each
    row's max |plain| plus 2e-5 (both sides round one f32 result once)."""
    out_f, ref_f = out.float(), ref.float()
    err = (out_f - ref_f).abs()
    if ref.dtype == torch.float32:
        ok = bool((err <= FA_F32_TOL + FA_F32_TOL * ref_f.abs()).all())
    else:
        ok = bool((err <= _ulp(ref_f.abs().amax(-1, keepdim=True)) + 2e-5).all())
    return float(err.max()), ok and bool(out_f.isfinite().all())


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def band_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head's band allows."""
    q = torch.arange(Sq, dtype=torch.int64)
    hi = q.clamp(max=Skv - 1) if causal else torch.full_like(q, Skv - 1)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def fa_forward_bound(q, k, causal: bool, window: int):
    """(bound_ms, bound_by): q, k, v read once and the output written once
    over HBM, vs 4·dh operations per allowed pair and head over the peak
    for the inputs' type (f32 CUDA cores, or bf16 tensor cores)."""
    B, Sq, H, dh = q.shape
    ops = 4 * B * H * band_pairs(Sq, k.shape[1], causal, window) * dh
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return _bound(nbytes, ops, q.dtype)


def fa_decode_bound(q1, k, live: int):
    """(bound_ms, bound_by): the ``live`` K and V rows read once, q read
    and the output written once, vs 4·dh operations per live key and query
    head over the peak for the inputs' type."""
    B, _, H, dh = q1.shape
    Hkv, elt = k.shape[2], q1.element_size()
    nbytes = 2 * B * live * Hkv * dh * elt + 2 * q1.numel() * elt
    return _bound(nbytes, 4 * B * H * live * dh, q1.dtype)


def fa_library(q, k, v, causal: bool, window: int):
    """Yardstick only, never called by the port: scaled_dot_product_attention
    with enable_gqa over (B, H, S, dh) views, and a band mask built once
    when there is a window."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        pos = torch.arange(q.shape[1], device=DEV)
        rel = pos[:, None] - pos[None, :]
        mask = (rel < window) & ((rel >= 0) if causal else True)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def fa_check(label: str, fn, plain, *, bound=None, library=None, plain_reps: int = 25) -> dict:
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    err, ok = fa_close(out, ref)
    del out, ref
    row = {"case": label, "max_abs_err": err}
    if bound is not None:
        row.update(**kernel_times(fn), plain_ms=time_ms(plain, reps=plain_reps),
                   library_ms=time_ms(library) if library else None,
                   bound_ms=bound[0], bound_by=bound[1])
    print(json.dumps(row), flush=True)
    check(ok, f"{label}: kernel disagrees with its plain version, max_abs_err {err}")
    return row


def flash_path(ops, gen) -> dict:
    """The path the JAX package gives kernels 11-12: its kernel bench
    (benchmarks/bench_kernels.py:56-76: a causal forward at B 1, S 1,024,
    8 heads of 64; a decode at B 8, S 4,096, 8 heads of 64, the cache
    full) and its tests (tests/test_kernels.py:88-160: the forward sweep,
    the dtypes, the decode sweep and a gradient), through the public ops.
    Counts are zeroed before and read after; the outputs are then held
    against the plain versions."""
    from repro_torch import kernels
    calls = []
    torch.cuda.synchronize()
    kernels.launches.clear()
    q, k, v = (_rand(gen, (1, 1024, 8, 64), torch.float32) for _ in range(3))
    calls.append(("bench forward", (q, k, v, True, 0), ops.flash_attention(q, k, v, True, 0)))
    q1 = _rand(gen, (8, 1, 8, 64), torch.float32)
    kc, vc = (_rand(gen, (8, 4096, 8, 64), torch.float32) for _ in range(2))
    calls.append(("bench decode", (q1, kc, vc, 4096), ops.flash_decode(q1, kc, vc, 4096)))
    for B, S, H, Hkv, dh in FA_SWEEP:
        for causal, window in FA_MODES:
            q = _rand(gen, (B, S, H, dh), torch.float32)
            k, v = (_rand(gen, (B, S, Hkv, dh), torch.float32) for _ in range(2))
            calls.append((f"sweep {B}x{S}x{H}x{Hkv}x{dh} causal={causal} window={window}",
                          (q, k, v, causal, window), ops.flash_attention(q, k, v, causal, window)))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_rand(gen, (1, 128, 2, 64), dtype) for _ in range(3))
        calls.append((f"dtype {dtype}", (q, k, v, True, 0), ops.flash_attention(q, k, v, True, 0)))
    for B, S, H, Hkv, dh, clen in FA_DECODE_SWEEP:
        q1 = _rand(gen, (B, 1, H, dh), torch.float32)
        kc, vc = (_rand(gen, (B, S, Hkv, dh), torch.float32) for _ in range(2))
        calls.append((f"decode sweep {B}x{S}x{H}x{Hkv}x{dh} len={clen}", (q1, kc, vc, clen),
                      ops.flash_decode(q1, kc, vc, clen)))
    qkv = [_rand(gen, (1, 128, 2, 32), torch.float32).requires_grad_(True) for _ in range(3)]
    (ops.flash_attention(*qkv, True, 0) ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = {n: kernels.launches[n] for n in ("flash_forward", "flash_decode")}
    check(launches["flash_forward"] == 1 + 9 + 2 + 1 and launches["flash_decode"] == 1 + 3,
          f"flash path: launches {launches}")
    worst = 0.0
    for label, args, out in calls:
        plain = (ops.flash_forward_ref(*args[:3], causal=args[3], window=args[4])
                 if len(args) == 5 else ops.flash_decode_ref(*args))
        err, ok = fa_close(out, plain)
        check(ok, f"flash path, {label}: output disagrees with the plain version ({err})")
        worst = max(worst, err)
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    (ops.flash_forward_ref(*ref, causal=True) ** 2).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max()) for a, b in zip(qkv, ref))
    check(grad_err <= FA_GRAD_TOL, f"flash path: gradient off by {grad_err}")
    print(json.dumps({"phase": "flash kernels' path (reference bench and tests)",
                      "calls": len(calls) + 1, "launches": launches,
                      "max_abs_err": worst, "grad_max_abs_err": grad_err}), flush=True)
    return launches


def flash_attention_phase(ops, seed: int) -> tuple[dict, dict, dict]:
    """Returns (the path's launches, kernel 12's row, kernel 11's row)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    launches = flash_path(ops, gen)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for B, S, H, Hkv, dh in FA_SWEEP + FA_WIDE_HEADS:
            q = _rand(gen, (B, S, H, dh), dtype)
            k, v = (_rand(gen, (B, S, Hkv, dh), dtype) for _ in range(2))
            for causal, window in FA_MODES:
                fa_check(f"flash_forward {B}x{S}x{H}x{Hkv}x{dh} causal={causal} "
                         f"window={window} {name}",
                         lambda: ops.flash_attention(q, k, v, causal, window),
                         lambda: ops.flash_forward_ref(q, k, v, causal=causal, window=window))
    rows = {}
    S = FA_FULL_S
    for cfg_name, H, Hkv, dh in FA_CONFIGS:        # full widths, causal
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q = _rand(gen, (1, S, H, dh), dtype)
            k, v = (_rand(gen, (1, S, Hkv, dh), dtype) for _ in range(2))
            row = fa_check(f"flash_forward {cfg_name} S={S} causal {name}",
                           lambda: ops.flash_attention(q, k, v, True, 0),
                           lambda: ops.flash_forward_ref(q, k, v, causal=True),
                           bound=fa_forward_bound(q, k, True, 0),
                           library=fa_library(q, k, v, True, 0), plain_reps=5)
            if cfg_name == "qwen2.5-14b":
                rows[name] = row
            del q, k, v
    S, W = FA_WINDOW_CASE                          # starcoder2-3b's own window
    q = _rand(gen, (1, S, 24, 128), torch.bfloat16)
    k, v = (_rand(gen, (1, S, 2, 128), torch.bfloat16) for _ in range(2))
    fa_check(f"flash_forward starcoder2-3b S={S} window={W} bfloat16",
             lambda: ops.flash_attention(q, k, v, True, W),
             lambda: ops.flash_forward_ref(q, k, v, causal=True, window=W),
             bound=fa_forward_bound(q, k, True, W),
             library=fa_library(q, k, v, True, W), plain_reps=3)
    del q, k, v
    torch.cuda.empty_cache()

    # one backward at qwen2.5-14b's width: recompute through the plain
    # chunked attention against autograd of the plain version
    S, H, Hkv, dh = FA_BWD
    qkv = [_rand(gen, (1, S, n, dh), torch.float32).requires_grad_(True) for n in (H, Hkv, Hkv)]
    (ops.flash_attention(*qkv, True, 0) ** 2).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    (ops.flash_forward_ref(*ref, causal=True) ** 2).sum().backward()
    torch.cuda.synchronize()
    errs = [float((a.grad - b.grad).abs().max()) for a, b in zip(qkv, ref)]
    scale = max(float(b.grad.abs().max()) for b in ref)
    print(json.dumps({"case": f"flash_attention backward qwen2.5-14b S={S} f32",
                      "grad_max_abs_err": errs, "grad_max_abs": scale,
                      "tol": FA_GRAD_TOL}), flush=True)
    check(all(e <= FA_GRAD_TOL * max(1.0, scale) for e in errs),
          f"flash_attention backward at qwen width: errors {errs} (scale {scale})")
    del qkv, ref
    torch.cuda.empty_cache()

    dec_row = None
    for label, B, S, H, Hkv, dh, dtype in FA_DECODE:
        name = str(dtype).removeprefix("torch.")
        q1 = _rand(gen, (B, 1, H, dh), dtype)
        kc, vc = (_rand(gen, (B, S, Hkv, dh), dtype) for _ in range(2))
        kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        for clen in (0, 1, 700, S - 1, S):             # 0: no valid position, the mean of V
            timed = clen == S
            row = fa_check(f"flash_decode {label} B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
                           f"cache_len={clen} {name}",
                           lambda: ops.flash_decode(q1, kc, vc, clen),
                           lambda: ops.flash_decode_ref(q1, kc, vc, clen),
                           bound=fa_decode_bound(q1, kc, clen) if timed else None,
                           library=(lambda: torch.nn.functional.scaled_dot_product_attention(
                               q1.transpose(1, 2), kt, vt, enable_gqa=True)) if timed else None)
            if timed and label != "bench":
                dec_row = row
        del q1, kc, vc, kt, vt
    torch.cuda.empty_cache()
    # kernel 12's entry: the bf16 row (every config's dtype), f32 beside it
    fwd_row = {**rows["bfloat16"],
               "f32": {key: rows["float32"][key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")}}
    return launches, fwd_row, dec_row


# ---------------------------------------------------------- phases 16-17
LONG_PROMPT = 20480          # > 4·window and a multiple of 512: block-local prefill


def starcoder_f32_phase(serve, zoo, ops, get_config, seed: int) -> None:
    """starcoder2-3b at full width, 2 layers, f32: engine == static within
    the window; one 20,480-token prompt, prefilled through
    sliding_attention, served through kernel 1 and through its plain
    version with identical tokens."""
    import dataclasses
    from unittest import mock

    from repro_torch import kernels
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device=DEV)
    rng = np.random.default_rng(seed)
    reqs = make_requests(serve.Request, cfg.vocab_size, 6, rng,
                         (16, min(1000, cfg.sliding_window // 4)), (4, 24))
    check(all(len(r.tokens) + r.max_new_tokens <= cfg.sliding_window for r in reqs),
          "starcoder2 f32: a request outgrows the window")
    engine = serve.ContinuousEngine(model, params, max_batch=4, num_blocks=400,
                                    block_size=16, max_seq_len=1040, chunk_steps=4)
    kernels.launches.clear()
    with card_launches() as ran:
        results, _ = drive(engine, reqs)
    launches, host = ran["paged_decode"], kernels.launches["paged_decode"]
    got = {r.rid: r.tokens for r in results}
    for r in reqs:
        ref = serve.generate_static(model, params, r.tokens[None], r.max_new_tokens)[0]
        check(got[r.rid] == ref.cpu().tolist(),
              f"starcoder2 f32: request {r.rid} engine {got[r.rid]} != static {ref.tolist()}")
    check(launches == cfg.num_layers * engine.steps and host > 0,
          f"starcoder2 f32: {launches} launches on the card ({host} by the wrapper) for "
          f"{engine.steps} micro-steps")

    long = serve.Request(rid=99, tokens=rng.integers(0, cfg.vocab_size, LONG_PROMPT)
                         .astype(np.int32), max_new_tokens=6)
    long_tokens = {}
    for label, fn in (("kernel", ops.paged_decode), ("plain", ops.paged_decode_ref)):
        eng = serve.ContinuousEngine(model, params, max_batch=1,
                                     num_blocks=LONG_PROMPT // 16 + 4,
                                     block_size=16, max_seq_len=LONG_PROMPT + 16, chunk_steps=4)
        calls = []
        real = zoo.attn.sliding_attention
        with mock.patch.object(ops, "paged_decode", fn), \
                mock.patch.object(zoo.attn, "sliding_attention",
                                  lambda *a, **k: calls.append(1) or real(*a, **k)):
            long_tokens[label] = eng.run([long])[0].tokens
        check(len(calls) == cfg.num_layers,
              f"starcoder2 f32: the long prefill took sliding_attention {len(calls)} times")
    check(long_tokens["kernel"] == long_tokens["plain"],
          f"starcoder2 f32, {LONG_PROMPT}-token prompt: kernel {long_tokens['kernel']} "
          f"!= plain {long_tokens['plain']}")
    print(json.dumps({"phase": "starcoder2-3b f32 depth 2, full width", "requests": len(reqs),
                      "identical_tokens": True, "paged_decode_launches": launches,
                      "paged_decode_wrapper_launches": host,
                      "micro_steps": engine.steps, "long_prompt": LONG_PROMPT,
                      "long_tokens_kernel_eq_plain": True,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    del engine, params, model
    torch.cuda.empty_cache()


def starcoder_serve_phase(serve, zoo, get_config, seed: int, card: str) -> None:
    """starcoder2-3b as configured (30 layers, bf16, random weights made on
    the card): ContinuousEngine serves 8 requests, prompts of 32-2,048
    tokens and one of 20,480; then where the time goes: one decode chunk
    with every lane busy under torch.profiler, and the long prefill with
    its sliding_attention calls timed apart."""
    from unittest import mock

    cfg = get_config("starcoder2-3b")
    model = zoo.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} weights "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    _, reqs = engine_serve(
        serve, model, params, cfg,
        lambda: [*make_requests(serve.Request, cfg.vocab_size, 7, rng, (32, 2048), (8, 64)),
                 serve.Request(rid=7, tokens=rng.integers(0, cfg.vocab_size, LONG_PROMPT)
                               .astype(np.int32), max_new_tokens=32)],
        rng, "starcoder2-3b bf16 full depth, full width", card, num_blocks=2600,
        max_seq_len=max(LONG_PROMPT, 2048) + 64, before_launches=2360)

    spent = [0.0]
    real = zoo.attn.sliding_attention

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    toks = torch.from_numpy(reqs[-1].tokens[None]).to(DEV)
    with mock.patch.object(zoo.attn, "sliding_attention", timed), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, last=[LONG_PROMPT - 1])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    print(json.dumps({"phase": f"starcoder2-3b prefill of {LONG_PROMPT} tokens", "card": card,
                      "prefill_s": prefill_s, "sliding_attention_s": spent[0],
                      "sliding_attention_share": spent[0] / prefill_s}), flush=True)
    del params, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 18
RESNET56_RUN = dict(K=4, R=2, num_clients=20, participation=0.4, client_batch=64,
                    client_lr=0.05, server_lr=0.05, temperature=4.0, local_epochs=1,
                    distill_steps=200)
# (engine, overlap, model): the vectorized runs, and the sequential off run
# they are spread against, at ResNet-20 (the depth cut to keep the whole run
# within its time limit; at ResNet-56 they took about 150 s)
OVERLAP_RUNS = (("sequential", "off", "resnet56"), ("sequential", "async", "resnet56"),
                ("sequential", "off", "resnet20"), ("vectorized", "off", "resnet20"),
                ("vectorized", "async", "resnet20"), ("vectorized", "fused", "resnet20"))
OVERLAP_ROUNDS = 3               # round 1 captures, round 2 the KD's and the pairs', 3 steady
OVERLAP_TOL = ROUND_TOL          # drained models against off
PAIR = "fused/kd+bucket"


def resnet_task(seed: int, model: str = "resnet56"):
    """Phases 8 and 11's task: 20 clients over 50,000 images, ResNet-56 (or
    another depth of the family)."""
    from repro_torch.core.tasks import classification_task
    return classification_task(model=model, num_clients=20, alpha=0.1, num_train=50000,
                               num_server=2048, server_batch=256, seed=seed, device=DEV)


def _replays(prog, n: int, counter=None, period: int = 0) -> None:
    """``n`` calls of a step program; a step counter in its buffers restarts
    every ``period`` calls (a schedule's length), as its loop restarts it."""
    for i in range(n):
        if counter is not None and i % period == 0:
            counter.zero_()
        prog()


def replay_probe(runner, execution: str, reps: int = 3) -> dict:
    """What two step programs gain from running at once on one card, timed
    with CUDA events (median of ``reps``): the run's KD step program alone
    on the KD stream, its client step program (sequential) or largest
    bucket step program (vectorized) alone, both issued together on the two
    streams, and, vectorized, one KD step and one bucket step a paired
    program.  ``hidden_ms`` = alone + alone - together.  (torch.profiler
    cannot show this: under its tracing two streams' graphs never ran at
    once.)"""
    from repro_torch.core.step_graph import StepGraphs
    pipe = runner._kd_pipeline()
    kd = next(p for (n, _), p in pipe.graphs.programs.items() if n == "kd/step")
    name = "client/step" if execution == "sequential" else "engine/bucket"
    cl = max((p for (n, _), p in runner.graphs.programs.items() if n == name),
             key=lambda p: _leaves(p.buf["params"])[0].shape[0])
    lane, cur = pipe.lane(), torch.cuda.current_stream()
    n_kd, n_cl = (40, 100) if execution == "sequential" else (16, 16)
    kd_run = (kd, n_kd, kd.buf["s"], pipe.steps)
    cl_run = (cl, n_cl, *((cl.buf["si"], cl.buf["capacity"][0]) if "si" in cl.buf else ()))

    def both():
        lane.wait_stream(cur)
        with torch.cuda.stream(lane):
            _replays(*kd_run)
        _replays(*cl_run)
        cur.wait_stream(lane)

    def timed(fn) -> float:
        out = []
        for _ in range(reps + 1):               # the first is a warm-up
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out[1:])

    res = {"kd_steps": n_kd, f"{name}_steps": n_cl,
           "kd_alone_ms": timed(lambda: _replays(*kd_run)),
           "client_alone_ms": timed(lambda: _replays(*cl_run)), "together_ms": timed(both)}
    res["hidden_ms"] = res["kd_alone_ms"] + res["client_alone_ms"] - res["together_ms"]
    res["hidden_share_of_kd"] = res["hidden_ms"] / res["kd_alone_ms"]
    if execution == "vectorized":
        pair = StepGraphs().pair(PAIR, kd, cl)

        def paired():
            for i in range(n_kd):
                if i % pipe.steps == 0:
                    kd.buf["s"].zero_()
                if i % cl.buf["capacity"][0] == 0:
                    cl.buf["si"].zero_()
                pair()

        res["paired_ms"] = timed(paired)
        res["paired_hidden_ms"] = res["kd_alone_ms"] + res["client_alone_ms"] - res["paired_ms"]
    return res


CNN_RUN = dict(K=4, R=2, num_clients=8, participation=1.0, local_epochs=1, distill_steps=20,
               client_lr=0.05, server_lr=0.05)


def vectorized_cnn_overlap(fed, seed: int) -> dict:
    """Phase 10's CNN configuration, 3 rounds on the vectorized engine under
    off, async and fused from the same weights, cuDNN deterministic: the
    drained models' max abs difference from off, held at 2e-4."""
    from repro_torch.core.tasks import classification_task
    from repro_torch.utils.pytree import tree_map
    task = classification_task(model="cnn", num_clients=8, seed=seed, device=DEV)
    init = fed.make_runner("fedsdd", task, device=DEV, seed=seed,
                           **CNN_RUN).init_state().global_models
    states = {}
    for mode in ("off", "async", "fused"):
        runner = fed.make_runner("fedsdd", task, device=DEV, seed=seed, overlap=mode,
                                 execution="vectorized", **CNN_RUN)
        state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                             ensemble=fed.TeacherBank(4, 2))
        states[mode] = runner.run(OVERLAP_ROUNDS, state=state)
    return {mode: max(_tree_err(a, b) for a, b in zip(st.global_models,
                                                      states["off"].global_models))
            for mode, st in states.items() if mode != "off"}


def overlap_phase(fed, task, seed: int, card: str):
    """FedSDD in phases 8 and 11's configuration (``task``, ResNet-56; the
    vectorized runs at ResNet-20, ``OVERLAP_RUNS``), 3 rounds under each
    engine and overlap mode from the same weights for each model, cuDNN
    deterministic; each overlapped run drained by finalize and held against
    its engine's off run.  Returns the sequential ResNet-56 off run's runner
    and state (its ring holds K·R = 8 teachers)."""
    from repro_torch import kernels
    from repro_torch.core import step_graph
    from repro_torch.core.scheduler import overlap_summary
    from repro_torch.utils.pytree import tree_map
    tasks = {"resnet56": task, "resnet20": resnet_task(seed, "resnet20")}
    init = {model: fed.make_runner("fedsdd", t, device=DEV, seed=seed,
                                   **RESNET56_RUN).init_state().global_models
            for model, t in tasks.items()}
    torch.backends.cudnn.deterministic = True
    results = {}
    try:
        for execution, mode, model in OVERLAP_RUNS:
            gc.collect()
            runner = fed.make_runner("fedsdd", tasks[model], device=DEV, seed=seed,
                                     overlap=mode, execution=execution, **RESNET56_RUN)
            state = fed.FedState(round=0,
                                 global_models=[tree_map(torch.clone, m) for m in init[model]],
                                 ensemble=fed.TeacherBank(4, 2))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.launches.clear()
            rounds, held = [], None
            with card_launches() as ran:
                t_run = time.perf_counter()
                for i in range(OVERLAP_ROUNDS):
                    c0, p0 = captured(), step_graph.captures[PAIR]
                    if mode == "off" or i < OVERLAP_ROUNDS - 1:
                        state = runner.run_round(state)
                    else:   # the steady round under the contracts; the
                        # launch snapshots wait for the KD lane, not the host
                        path = KD_PATH + (("multi_weighted_average",)
                                          if execution == "vectorized" else ())
                        streams = (torch.cuda.current_stream(), runner._kd_pipeline().lane())
                        with contracts(f"{model} round {i + 1}, {execution} {mode}",
                                       run_owners(runner), path, streams) as held:
                            state = runner.run_round(state)
                    rounds.append({"round": state.round, "captures": captured() - c0,
                                   "paired_captures": step_graph.captures[PAIR] - p0,
                                   **{k: state.history[-1][k] for k in
                                      ("t_round", "t_local", "t_kd")
                                      if k in state.history[-1]}})
                t0 = time.perf_counter()
                state = runner.finalize(state)
                torch.cuda.synchronize()
                t_drain, t_run = time.perf_counter() - t0, time.perf_counter() - t_run
            peak, host = torch.cuda.max_memory_allocated() / 1e9, dict(kernels.launches)
            if held is not None:
                contracts_line(held, card)
            probe = replay_probe(runner, execution) if mode == "async" else {}
            results[execution, mode, model] = {
                "runner": runner, "state": state, "rounds": rounds, "launches": dict(ran),
                "wrapper_launches": host, "peak_mem_gb": peak,
                "t_drain_s": t_drain, "t_run_s": t_run, "probe": probe,
                "pairs": (len(runner._executor()._pairs.pairs)
                          if runner._executor()._pairs is not None else 0)}
            del runner, probe
    finally:
        torch.backends.cudnn.deterministic = False
    steps_kd = RESNET56_RUN["distill_steps"]

    def drained_err(a, b) -> float:
        return max(_tree_err(x, y) for x, y in zip(results[a]["state"].global_models,
                                                   results[b]["state"].global_models))

    # the two engines' own spread on this configuration: the vectorized off
    # run against the sequential one.  Overlapped, the vectorized engine
    # trains the k>0 and main subsets as buckets of 6 and 2 clients, whose
    # vmapped convolutions round otherwise than one of 8; these ResNet-56
    # rounds carry such roundings far (the engines part by as much), so the
    # vectorized runs are held at 2e-4 on phase 10's CNN instead, and the
    # two overlapped vectorized modes against each other here
    engines = drained_err(("vectorized", "off", "resnet20"), ("sequential", "off", "resnet20"))
    fused_vs_async = drained_err(("vectorized", "fused", "resnet20"),
                                 ("vectorized", "async", "resnet20"))
    cnn = vectorized_cnn_overlap(fed, seed)
    print(json.dumps({"phase": "overlapped: drained models (vectorized at ResNet-20)",
                      "card": card,
                      "vectorized_off_vs_sequential_off": engines,
                      "vectorized_fused_vs_async": fused_vs_async,
                      "cnn_vectorized_vs_off": cnn, "tol": OVERLAP_TOL}), flush=True)
    check(fused_vs_async <= OVERLAP_TOL,
          f"overlap: vectorized fused and async drained {fused_vs_async} apart")
    check(all(e <= OVERLAP_TOL for e in cnn.values()),
          f"overlap: vectorized CNN rounds drained {cnn} from off (tol {OVERLAP_TOL})")
    tols = {"sequential": OVERLAP_TOL, "vectorized": None}
    for (execution, mode, model), r in results.items():
        off = results[execution, "off", model]
        err = drained_err((execution, mode, model), (execution, "off", model))
        o3 = off["rounds"][-1]
        summary = overlap_summary(o3["t_local"], o3["t_kd"], r["rounds"][-1]["t_round"])
        line = {"phase": "FedSDD, overlapped", "card": card, "model": model,
                "engine": execution, "overlap": mode, "rounds": r["rounds"], "t_drain_s": r["t_drain_s"],
                "t_run_s": r["t_run_s"], "drained_max_abs_err_vs_off": err,
                "tol": tols[execution], "overlap_summary_round3": summary,
                "paired_programs": r["pairs"], "launches": r["launches"],
                "wrapper_launches": r["wrapper_launches"], "peak_mem_gb": r["peak_mem_gb"],
                "replay_probe": r["probe"] or None,
                "acc_main": [h["acc_main"] for h in r["state"].history],
                "kd_loss_last": [h["kd_loss_last"] for h in r["state"].history],
                "cudnn_deterministic": True}
        print(json.dumps(line), flush=True)
        hist = r["state"].history
        check(len(hist) == OVERLAP_ROUNDS and r["state"].pending_kd is None
              and all(h.get("kd_steps") == steps_kd and math.isfinite(h["kd_loss_last"])
                      for h in hist), f"overlap {execution}/{mode}: history {hist}")
        check(math.isfinite(err) and (tols[execution] is None or err <= tols[execution]),
              f"overlap {execution}/{mode}: drained models {err} from off "
              f"(tol {tols[execution]})")
        check(r["launches"].get("ensemble_softmax") == OVERLAP_ROUNDS
              and r["launches"].get("kd_loss_fwd") == OVERLAP_ROUNDS * steps_kd
              and r["launches"].get("kd_loss_bwd") == OVERLAP_ROUNDS * steps_kd,
              f"overlap {execution}/{mode}: KD launches {r['launches']}")
        check(execution == "sequential" or r["wrapper_launches"].get("multi_weighted_average")
              == OVERLAP_ROUNDS, f"overlap {execution}/{mode}: kernel 5 {r['wrapper_launches']}")
        check(r["rounds"][-1]["captures"] == off["rounds"][-1]["captures"],
              f"overlap {execution}/{mode}: round 3 captured {r['rounds'][-1]['captures']}, "
              f"off {off['rounds'][-1]['captures']} (a bucket outgrowing its capacity)")
        check(mode != "off" or all("t_kd" in x for x in r["rounds"]),
              f"overlap {execution}/{mode}: off rounds lack t_kd")
        check(mode == "off" or not any("t_kd" in x for x in r["rounds"][1:]),
              f"overlap {execution}/{mode}: an overlapped round recorded t_kd")
        check((mode == "fused") == (r["pairs"] > 0 and sum(x["paired_captures"]
                                                          for x in r["rounds"]) > 0),
              f"overlap {execution}/{mode}: paired programs {r['pairs']}")
        if mode == "async":
            check(r["probe"]["hidden_ms"] > 0, f"overlap {execution}/async: KD and client step "
                  f"programs on two streams took no less than one after the other "
                  f"({r['probe']})")
    off = results["sequential", "off", "resnet56"]
    return off["runner"], off["state"]


# ---------------------------------------------------------------- phase 19
def legacy_phase(fed, task, seed: int, card: str, runner3, state3) -> None:
    """One ResNet-56 round with the legacy host-loop KD oracle against the
    fused pipeline from the same weights (cuDNN deterministic), then paper
    Table 5's metric on phase 18's sequential off run after 3 rounds: the
    K·R = 8 teacher ensemble's accuracy on the task's test set through
    ensemble_eval_fn, beside the main model's."""
    from repro_torch.data.synthetic import SyntheticClassification
    from repro_torch.utils.pytree import tree_map
    init = fed.make_runner("fedsdd", task, device=DEV, seed=seed,
                           **RESNET56_RUN).init_state().global_models
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for pipeline in ("legacy", "fused"):
            runner = fed.make_runner("fedsdd", task, device=DEV, seed=seed, kd_pipeline=pipeline,
                                     **RESNET56_RUN)
            state = fed.FedState(round=0,
                                 global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(4, 2))
            with card_launches() as ran:
                state = runner.run(1, state=state)
            runs[pipeline] = (runner, state, dict(ran))
    finally:
        torch.backends.cudnn.deterministic = False
    (runner, leg, leg_launches), (_, fus, fus_launches) = runs["legacy"], runs["fused"]
    err = max(_tree_err(a, b) for a, b in zip(leg.global_models, fus.global_models))
    x_te, y_te = SyntheticClassification(num_train=50000, num_server=2048, seed=seed).test()
    # the task's own test set (classification_task's SyntheticClassification)
    ens = runner3.ensemble_eval_fn(state3)
    hits = 0
    for i in range(0, len(x_te), 500):
        pred = ens({"x": torch.from_numpy(x_te[i:i + 500]).to(DEV)})
        hits += int((pred.cpu().numpy() == y_te[i:i + 500]).sum())
    ens_acc = hits / len(x_te)
    rec = leg.history[-1]
    print(json.dumps({"phase": "ResNet-56 FedSDD round, legacy KD oracle vs fused", "card": card,
                      "models_max_abs_err": err, "tol": ROUND_TOL,
                      "kd_loss_last": rec["kd_loss_last"],
                      "kd_loss_last_fused": fus.history[-1]["kd_loss_last"],
                      "t_kd_s": rec["t_kd"], "t_kd_fused_s": fus.history[-1]["t_kd"],
                      "launches_legacy": leg_launches, "launches_fused": fus_launches,
                      "table5_rounds": state3.round,
                      "table5_teachers": state3.ensemble.num_members,
                      "ensemble_acc_table5": ens_acc,
                      "acc_main_table5": state3.history[-1]["acc_main"],
                      "test_images": len(x_te), "cudnn_deterministic": True}), flush=True)
    check(err <= ROUND_TOL, f"legacy vs fused: models {err} apart (tol {ROUND_TOL})")
    n_batches = len(task.server_batches)
    check(leg_launches.get("kd_loss_fwd") == RESNET56_RUN["distill_steps"]
          and leg_launches.get("ensemble_softmax") == n_batches,
          f"legacy: launches {leg_launches}, want {RESNET56_RUN['distill_steps']} of kernel 3 "
          f"and one of kernel 2 a server batch ({n_batches})")
    check(state3.ensemble.num_members == 8 and math.isfinite(ens_acc),
          f"Table 5 ensemble: accuracy {ens_acc}, {state3.ensemble.num_members} teachers")


# ---------------------------------------------------------------- phase 20
ROBUST_PLAN = dict(seed=0, dropout=0.2, straggler=0.3, corrupt=0.1, attack="sign_flip",
                   attack_rate=0.15, attack_scale=10.0, spill_fail=0.5)
ROBUST_RUN = dict(aggregator="trimmed_mean", clip_norm=2.0, teacher_trust=True,
                  client_store="spilling")
ROBUST_RTOL, ROBUST_ATOL = 1e-6, 1e-7    # the card's robust Eq. 2 against the CPU's
FAULT_KEYS = ("survivors", "dropped", "stragglers", "rejected", "attacked", "degraded_groups")


def _fault_trace(state) -> list:
    return [{k: r.get(k) for k in FAULT_KEYS} for r in state.history]


@contextmanager
def io_attempts():
    """The block's fedckpt I/O attempts (a list of attempt numbers): the
    installed injector, counted; the hook is cleared afterwards."""
    from repro_torch.fedckpt import checkpointer as fedckpt
    inner, seen = fedckpt._io_fault_injector, []

    def counting(path, attempt):
        seen.append(attempt)
        if inner is not None:
            inner(path, attempt)

    fedckpt.set_io_fault_injector(counting)
    try:
        yield seen
    finally:
        fedckpt.set_io_fault_injector(None)


def robust_cnn_part(fed, seed: int, tmp: str) -> dict:
    """(a) Phase 10's CNN, 3 faulted rounds on each engine from the same
    weights: the fault fields against each other and against the host's
    own draws, the models within 2e-4, no capture in rounds 2-3, the I/O
    retries, and a vectorized save_state's bytes against its leaves'."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.tasks import classification_task
    from repro_torch.fedckpt.checkpointer import Checkpointer
    from repro_torch.utils.pytree import tree_map
    task = classification_task(model="cnn", num_clients=8, seed=seed, device=DEV)
    plan = FaultPlan(**ROBUST_PLAN)
    init = fed.make_runner("fedsdd", task, device=DEV, seed=seed,
                           **CNN_RUN).init_state().global_models
    runs = {}
    for execution in ("sequential", "vectorized"):
        runner = fed.make_runner("fedsdd", task, device=DEV, seed=seed, execution=execution,
                                 faults=plan, client_store_dir=os.path.join(tmp, execution),
                                 **ROBUST_RUN, **CNN_RUN)
        with io_attempts() as attempts:
            state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(4, 2))
            caps = []
            for _ in range(OVERLAP_ROUNDS):
                c0 = captured()
                state = runner.run_round(state)
                caps.append(captured() - c0)
            state = runner.finalize(state)
            ck = Checkpointer(os.path.join(tmp, f"ckpt_{execution}"), prefix="state")
            path = runner.save_state(ck, state)
        torch.cuda.synchronize()
        tree_bytes = (sum(x.numel() * 4 for m in state.global_models for x in _leaves(m))
                      + sum(x.numel() * 4 for x in _leaves(state.ensemble.export_state()[0])))
        runs[execution] = {"state": state, "captures": caps, "retries": attempts.count(1),
                           "attempts": len(attempts), "npz_bytes": os.path.getsize(path),
                           "leaf_bytes": tree_bytes}
        del runner
    seq, vec = runs["sequential"]["state"], runs["vectorized"]["state"]
    host = []
    for t in range(1, OVERLAP_ROUNDS + 1):       # participation 1: every client sampled
        draws = {c: plan.client_faults(t, c) for c in range(CNN_RUN["num_clients"])}
        host.append({"dropped": sorted(c for c, d in draws.items() if d[0]),
                     "attacked": sorted(c for c, d in draws.items() if d[3]),
                     "straggled": sorted(c for c, d in draws.items() if d[1])})
    errs = [_tree_err(a, b) for a, b in zip(seq.global_models, vec.global_models)]
    v = runs["vectorized"]
    out = {"trace": _fault_trace(seq), "models_max_abs_err": errs, "tol": ROUND_TOL,
           **{f"{e}_{k}": runs[e][k] for e in runs
              for k in ("captures", "retries", "attempts", "npz_bytes", "leaf_bytes")},
           "teacher_trust": [r.get("teacher_trust") for r in seq.history]}
    check(_fault_trace(seq) == _fault_trace(vec),
          f"robust CNN: fault traces differ across engines {_fault_trace(seq)} {_fault_trace(vec)}")
    for rec, h in zip(_fault_trace(seq), host):
        check(rec["dropped"] == h["dropped"] and rec["attacked"] == h["attacked"]
              and set(rec["stragglers"]) <= set(h["straggled"]),
              f"robust CNN: trace {rec} is not the host's draws {h}")
    check(any(r["dropped"] or r["rejected"] or r["attacked"] for r in _fault_trace(seq)),
          f"robust CNN: no fault fired {_fault_trace(seq)}")
    check(max(errs) <= ROUND_TOL, f"robust CNN: engines' models {errs} apart (tol {ROUND_TOL})")
    for e, r in runs.items():
        check(not any(r["captures"][1:]), f"robust CNN {e}: rounds 2-3 captured {r['captures']}")
        check(r["retries"] > 0, f"robust CNN {e}: no I/O retry fired ({r['attempts']} attempts)")
    check(v["leaf_bytes"] <= v["npz_bytes"] <= 1.01 * v["leaf_bytes"] + 4096,
          f"robust CNN: vectorized save_state wrote {v['npz_bytes']} bytes for "
          f"{v['leaf_bytes']} of leaves")
    return out


def robust_resnet56_part(fed, kd_ops, kd_ref, task, seed: int, tmp: str) -> dict:
    """(b) Phase 8's ResNet-56 configuration, sequential, faulted, with the
    trimmed mean, clipping, trust-weighted teachers and the spilling store,
    2 rounds: the trust weights, kernel 2 over the weighted M = 1 stack
    against its plain version, the card's robust Eq. 2 against the port's
    CPU run of the same stacked updates, and Krum's score gap."""
    from repro_torch.core import robust_agg as ra
    from repro_torch.core.faults import FaultPlan
    from repro_torch.utils.pytree import tree_map
    calls = []
    real = fed.robust_aggregate_grouped

    def recording(stacked, sizes, gids, K, **kw):
        agg, deg = real(stacked, sizes, gids, K, **kw)
        calls.append((stacked, sizes, gids, K, kw, agg, deg))
        return agg, deg

    runner = fed.make_runner("fedsdd", task, device=DEV, seed=seed, faults=FaultPlan(**ROBUST_PLAN),
                             client_store_dir=os.path.join(tmp, "r56"), **ROBUST_RUN,
                             **RESNET56_RUN)
    fed.robust_aggregate_grouped = recording
    try:
        with io_attempts(), card_launches() as ran:
            t0 = time.perf_counter()
            state = runner.run(2)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
    finally:
        fed.robust_aggregate_grouped = real
    trust = [r["teacher_trust"] for r in state.history]
    # kernel 2 over the round's weighted M = 1 stack, against its plain version
    pipe = runner._kd_pipeline()
    teachers = state.ensemble.member_views()
    w = runner._teacher_trust_weights(state, teachers)
    batches = pipe.batches_for(task.server_batches)
    wsum = pipe.precompute_weighted_logits(teachers, batches, w)
    V = wsum.shape[-1]
    probs = kd_ops.ensemble_softmax_many(wsum[None], pipe.temperature)
    plain = kd_ref.ensemble_softmax_ref(wsum.reshape(1, -1, V), pipe.temperature)
    m1_ok = rows_within(probs.reshape(-1, V), plain, KD_F32_ROW_TOL)
    m1_err = float((probs.reshape(-1, V) - plain).abs().max())
    # the last round's robust Eq. 2 on the card against the CPU's
    stacked, sizes, gids, K, kw, agg, deg = calls[-1]
    def cpu(tree):
        return tree_map(lambda t: t.detach().cpu(), tree)

    agg_cpu, deg_cpu = ra.robust_aggregate_grouped(
        cpu(stacked), sizes, gids, K, **{**kw, "fallback_stacked": cpu(kw["fallback_stacked"])})
    rel = max(float(((a.cpu() - b).abs() / (b.abs() + ROBUST_ATOL / ROBUST_RTOL)).max())
              for a, b in zip(_leaves(agg), _leaves(agg_cpu)))
    agg_ok = deg == deg_cpu and all(
        torch.allclose(a.cpu(), b, rtol=ROBUST_RTOL, atol=ROBUST_ATOL)
        for a, b in zip(_leaves(agg), _leaves(agg_cpu)))
    # Krum's scores over the round's survivors taken as one group (a group
    # of this configuration has 2 clients, where Krum's scores tie): the gap
    # between the two best, beside the attacked rows
    mask = kw["survivor_mask"]
    rows = torch.from_numpy(np.nonzero(mask)[0]).to(DEV)
    sub = tree_map(lambda x: x.index_select(0, rows), stacked)
    f = ra._byzantine_f(runner.cfg.trim_frac, len(rows))
    scores = ra.krum_scores(ra._flatten_rows(sub), f)
    scores_cpu = ra.krum_scores(ra._flatten_rows(cpu(sub)), f)
    srt = torch.sort(scores).values.tolist()
    out = {"t_run_s": t_run, "rounds": [{k: r.get(k) for k in ("t_local", "t_kd", "t_round")}
                                        for r in state.history],
           "trace": _fault_trace(state), "teacher_trust": trust,
           "launches": dict(ran), "weighted_m1_max_abs_err": m1_err,
           "weighted_m1_rows": int(probs.numel() // V), "robust_eq2_max_rel_err": rel,
           "robust_eq2_rtol": ROBUST_RTOL, "robust_eq2_atol": ROBUST_ATOL,
           "krum_survivors": len(rows), "krum_scores_sorted": srt,
           "krum_gap": (srt[1] - srt[0]) if len(srt) > 1 else None,
           "krum_argmin_card": int(torch.argmin(scores)),
           "krum_argmin_cpu": int(torch.argmin(scores_cpu))}
    steps = RESNET56_RUN["distill_steps"]
    check(all(abs(sum(t) - 1.0) < 1e-3 for t in trust), f"robust ResNet-56: trust weights {trust}")
    check(m1_ok, f"robust ResNet-56: kernel 2 over the weighted M = 1 stack {m1_err} from plain")
    check(ran.get("ensemble_softmax") == 2 and ran.get("kd_loss_fwd") == 2 * steps
          and ran.get("kd_loss_bwd") == 2 * steps, f"robust ResNet-56: launches {dict(ran)}")
    check(agg_ok, f"robust ResNet-56: card's robust Eq. 2 vs the CPU's: rel {rel}, "
          f"degraded {deg} / {deg_cpu}")
    return out


def kill_restart_part(fed, task, seed: int, tmp: str) -> dict:
    """(c) ``task`` (phase 8's configuration at ResNet-20: the depth cut to
    keep the run within its time limit), sequential, overlap="async",
    SCAFFOLD, the spilling store, the ring in bf16, cuDNN deterministic: 3
    rounds uninterrupted against 2 rounds, save_state with the round-2 KD
    job dispatched on the KD stream, the runner dropped, a fresh runner
    restored, round 3 and the drain.  Models and c_global bit for bit."""
    from repro_torch.fedckpt.checkpointer import Checkpointer
    cfg = dict(RESNET56_RUN, overlap="async", local_algo="scaffold", client_store="spilling",
               teacher_dtype="bfloat16", seed=seed)
    whole = fed.make_runner("fedsdd", task, device=DEV,
                            client_store_dir=os.path.join(tmp, "store_a"), **cfg)
    sa = whole.init_state()
    for _ in range(3):
        sa = whole.run_round(sa)
    sa = whole.finalize(sa)
    torch.cuda.synchronize()
    del whole
    ckpt_dir = os.path.join(tmp, "ckpt")
    rb = fed.make_runner("fedsdd", task, device=DEV, client_store_dir=os.path.join(tmp, "store_b"),
                         **cfg)
    sb = rb.init_state()
    for _ in range(2):
        sb = rb.run_round(sb)
    in_flight = sb.pending_kd is not None and sb.pending_kd.dispatched is not None
    t0 = time.perf_counter()
    path = rb.save_state(Checkpointer(ckpt_dir, prefix="state"), sb)
    t_save = time.perf_counter() - t0
    # the "killed" process's KD still drains (no graph may go while the
    # card replays it); nothing of it reaches the checkpoint directory
    rb.finalize(sb)
    torch.cuda.synchronize()
    del rb, sb
    gc.collect()
    rc = fed.make_runner("fedsdd", task, device=DEV, client_store_dir=os.path.join(tmp, "store_b"),
                         **cfg)
    t0 = time.perf_counter()
    sc = rc.restore_state(Checkpointer(ckpt_dir, prefix="state"))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    restored_round, restored_pending = sc.round, sc.pending_kd is not None
    sc = rc.finalize(rc.run_round(sc))
    torch.cuda.synchronize()
    pend = os.path.join(ckpt_dir, "pending_kd_r00002.npz")
    errs = [_tree_err(a, b) for a, b in zip(sa.global_models, sc.global_models)]
    c_err = _tree_err(sa.scaffold_c_global, sc.scaffold_c_global)
    same = (all(torch.equal(x, y) for a, b in zip(sa.global_models, sc.global_models)
                for x, y in zip(_leaves(a), _leaves(b)))
            and all(torch.equal(x, y) for x, y in zip(_leaves(sa.scaffold_c_global),
                                                      _leaves(sc.scaffold_c_global))))
    out = {"in_flight_at_save": in_flight, "t_save_s": t_save, "t_restore_s": t_restore,
           "checkpoint_bytes": os.path.getsize(path),
           "pending_spill_bytes": os.path.getsize(pend) if os.path.exists(pend) else None,
           "restored_round": restored_round, "models_max_abs_err": errs,
           "c_global_max_abs_err": c_err, "bit_identical": same,
           "kd_loss_last": [r.get("kd_loss_last") for r in sc.history],
           "kd_loss_last_uninterrupted": [r.get("kd_loss_last") for r in sa.history]}
    check(in_flight and restored_round == 2 and restored_pending,
          f"kill and restart: in flight {in_flight}, restored round {restored_round}, "
          f"pending {restored_pending}")
    check(same, f"kill and restart: models {errs}, c_global {c_err} from the uninterrupted run")
    return out


def robust_phase(fed, kd_ops, kd_ref, task, seed: int, card: str) -> dict:
    """Phase 20: seeded faults, Byzantine-robust Eq. 2, trust-weighted
    teachers, the spilling store and kill-and-restart (parts a-c above);
    the kernels' launches counted over the phase."""
    import tempfile
    from repro_torch import kernels
    line = {"phase": "robustness and checkpoints", "card": card, "plan": ROBUST_PLAN,
            **ROBUST_RUN, "cudnn_deterministic": True}
    kernels.reset()
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-robust-") as tmp, \
                card_launches() as ran:
            t0 = time.perf_counter()
            line["cnn"] = robust_cnn_part(fed, seed, tmp)
            t1 = time.perf_counter()
            line["resnet56"] = robust_resnet56_part(fed, kd_ops, kd_ref, task, seed, tmp)
            t2 = time.perf_counter()
            line["kill_restart"] = kill_restart_part(fed, resnet_task(seed, "resnet20"), seed,
                                                     tmp)
            line["seconds"] = {"cnn": t1 - t0, "resnet56": t2 - t1,
                               "kill_restart": time.perf_counter() - t2}
    finally:
        torch.backends.cudnn.deterministic = False
    line["launches"] = dict(ran)
    print(json.dumps(line), flush=True)
    check(all(ran.get(n, 0) > 0 for n in ("ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd")),
          f"robust phase: a kernel of its path did not run: {dict(ran)}")
    return dict(ran)


# ---------------------------------------------------------------- phase 21
FEDBE_SAMPLES = 10               # the fedbe preset's ensemble_extra_sampled
SECURE_RTOL, SECURE_ATOL = 1e-3, 1e-4   # the reference's secure-aggregation test


def fedbe_secure_phase(fed, task, seed: int, card: str) -> dict:
    """Phase 21: one FedBE round and one secure fedsdd round on ResNet-56,
    sequential engine; returns the kernels' launches over the phase."""
    from repro_torch import kernels
    from repro_torch.core import aggregation
    kw = dict(num_clients=20, participation=0.4, client_batch=64, client_lr=0.05,
              server_lr=0.05, temperature=4.0, local_epochs=1, distill_steps=200, seed=seed)
    line = {"phase": "FedBE and secure aggregation, ResNet-56, one round each", "card": card}
    kernels.reset()
    with card_launches() as ran:
        # (a) FedBE: the 8 clients, 10 posterior samples and the main aggregate teach
        runner = fed.make_runner("fedbe", task, device=DEV, **kw)
        drawn, counts = [], []
        sample = runner._sample_posterior
        distill = runner._distill_models

        def recording_sample(models, sizes, n, s):
            out = sample(models, sizes, n, s)
            drawn.append((models, sizes, out))
            return out

        def counting_distill(new_globals, teachers, **k):
            counts.append(len(teachers))
            return distill(new_globals, teachers, **k)

        runner._sample_posterior, runner._distill_models = recording_sample, counting_distill
        state = runner.run(1)
        del runner._sample_posterior, runner._distill_models
        rec = state.history[-1]
        models, sizes, samples = drawn[0]
        # each sample's draws standardised by the stated Gaussian: N(0, 1)
        mean = aggregation.fedavg_aggregate(models, sizes)
        z_sum = z_sq = n_el = 0.0
        for s in samples:
            for m, xs, x in zip(_leaves(mean), zip(*[_leaves(mm) for mm in models]), _leaves(s)):
                var = sum((y - m) ** 2 for y in xs) / max(1, len(xs) - 1)
                live = var > 0
                z = ((x - m)[live] / var[live].sqrt()).double()
                z_sum, z_sq, n_el = z_sum + float(z.sum()), z_sq + float((z * z).sum()), \
                    n_el + z.numel()
        z_mean = z_sum / n_el
        z_var = z_sq / n_el - z_mean ** 2
        line["fedbe"] = {"teachers": counts, "clients": len(models),
                         "samples": len(samples), "t_local_s": rec["t_local"],
                         "t_kd_s": rec["t_kd"], "acc_main": rec["acc_main"],
                         "kd_loss_last": rec["kd_loss_last"],
                         "standardised_draws": {"n": n_el, "mean": z_mean, "var": z_var,
                                                "stated": "N(0, 1)"}}
        check(counts == [len(models) + FEDBE_SAMPLES + 1] and len(models) == 8,
              f"FedBE: {counts} teachers for {len(models)} clients")
        check(abs(z_mean) < 1e-2 and abs(z_var - 1) < 1e-2,
              f"FedBE: posterior draws standardise to mean {z_mean}, var {z_var}")
        check(math.isfinite(rec["kd_loss_last"]), "FedBE: non-finite KD loss")
        del runner, state, drawn, models, samples, mean

        # (b) fedsdd with secure aggregation: every group's masked mean
        # against plain Eq. 2 over the same client models
        calls = []
        secure = fed.secure_aggregate

        def checked_secure(models, sizes, seed=0):
            out, uploads = secure(models, sizes, seed=seed)
            plain = aggregation.fedavg_aggregate(models, sizes)
            calls.append({
                "clients": len(models),
                "max_abs_err_vs_plain": _tree_err(out, plain),
                "within_tol": all(torch.allclose(a, b, rtol=SECURE_RTOL, atol=SECURE_ATOL)
                                  for a, b in zip(_leaves(out), _leaves(plain))),
                "min_upload_distance": min(_tree_err(u, m) for u, m in zip(uploads, models))})
            return out, uploads

        fed.secure_aggregate = checked_secure
        try:
            runner = fed.make_runner("fedsdd", task, device=DEV, K=4, R=2,
                                     secure_aggregation=True, **kw)
            state = runner.run(1)
        finally:
            fed.secure_aggregate = secure
        rec = state.history[-1]
        line["secure"] = {"groups": calls, "t_local_s": rec["t_local"], "t_kd_s": rec["t_kd"],
                          "acc_main": rec["acc_main"], "kd_loss_last": rec["kd_loss_last"],
                          "rtol": SECURE_RTOL, "atol": SECURE_ATOL}
        check(len(calls) == 4 and all(c["within_tol"] for c in calls),
              f"secure aggregation: the aggregate is not plain Eq. 2: {calls}")
        check(all(c["min_upload_distance"] > 1.0 for c in calls),
              f"secure aggregation: an upload is near its raw model: {calls}")
        check(all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
              "secure aggregation: non-finite weights")
        del runner, state
    line["launches"] = dict(ran)
    print(json.dumps(line), flush=True)
    check(all(ran.get(n, 0) > 0 for n in ("ensemble_softmax", "kd_loss_fwd", "kd_loss_bwd")),
          f"FedBE / secure phase: a kernel of its path did not run: {dict(ran)}")
    torch.cuda.empty_cache()
    return dict(ran)


# ---------------------------------------------------------------- phase 22
DEEPSEEK = "deepseek-v2-lite-16b"
NO_DROPS = 64.0                  # capacity factor of tests/test_decode_consistency.py
PEAK_LIMIT_GB = 76.0             # the training phases' peak on an 80 GB card


def _decode_all(model, params, toks, cache, start: int = 0):
    """Logits of ``decode_step`` over ``toks`` from position ``start``."""
    return torch.stack([model.decode_step(params, toks[:, t:t + 1], cache, start + t)[0]
                        for t in range(toks.shape[1])], dim=1)


def deepseek_f32_phase(zoo, get_config, serve, seed: int) -> None:
    """Phase 22: deepseek-v2-lite-16b at full width, f32, 2 layers, no
    drops: the static path's greedy tokens are the argmax of a full forward
    over the prompt and the tokens before, and its absorbed MLA decode
    within f32 noise of the expanded form (the forward's logits)."""
    import dataclasses
    base = get_config(DEEPSEEK)
    cfg = dataclasses.replace(base, num_layers=2, param_dtype="float32",
                              compute_dtype="float32",
                              moe=dataclasses.replace(base.moe, capacity_factor=NO_DROPS))
    before = holding()
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    B, L, new = 2, 32, 16
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=DEV,
                            dtype=torch.int32)
    out = serve.generate_static(model, params, prompts, new, step_mode="scan")
    stepped = serve.generate_static(model, params, prompts, new, step_mode="stepped")
    # a second parameter set of the same shapes (the next round's checkpoint)
    # gets its own tokens: the program is rebuilt for it, then for the first
    params2 = model.init(seed + 1, device=DEV)
    caps = captured()
    out2 = serve.generate_static(model, params2, prompts, new, step_mode="scan")
    again = serve.generate_static(model, params, prompts, new, step_mode="scan")
    caps = captured() - caps
    stepped2 = serve.generate_static(model, params2, prompts, new, step_mode="stepped")
    del params2
    with torch.no_grad():
        seq = torch.cat([prompts, out[:, :-1]], dim=1)
        full, _ = model.logits(params, {"tokens": seq})
        want = full[:, L - 1:].argmax(-1).to(torch.int32)
        # the absorbed decode's logits over the same tokens
        cache = model.init_cache(B, L + new, device=DEV)
        dec = _decode_all(model, params, seq, cache)
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    row = {"phase": "deepseek-v2-lite-16b full width, f32, 2 layers, no drops",
           "schedule": [f"{k.mixer}/{k.ffn}" for k in model.schedule],
           "prefix_period": list(model.prefix_period), "tokens": B * new,
           "identical_tokens": bool(torch.equal(out, want)),
           "scan_equals_stepped": bool(torch.equal(out, stepped)),
           "second_set_scan_equals_stepped": bool(torch.equal(out2, stepped2)),
           "first_set_again_equals_stepped": bool(torch.equal(again, stepped)),
           "sets_differ": not bool(torch.equal(out2, stepped)),
           "captures_for_the_two_sets": caps,
           "decode_vs_forward_max_abs_err": err, "logit_scale": scale,
           "tol": 1e-4 * scale}
    print(json.dumps(row), flush=True)
    check(row["identical_tokens"], f"deepseek f32: static tokens {out.tolist()} != forward "
                                   f"argmax {want.tolist()}")
    check(row["scan_equals_stepped"] and row["second_set_scan_equals_stepped"]
          and row["first_set_again_equals_stepped"] and row["sets_differ"] and caps == 2,
          f"deepseek f32: scan against stepped over two parameter sets {row}")
    check(err <= 1e-4 * scale, f"deepseek f32: absorbed decode {err} from the expanded "
                               f"form (scale {scale})")
    del params, model, full, dec, cache
    torch.cuda.empty_cache()
    released(before, "phase 22")


# ---------------------------------------------------------------- phase 23
HBM_EXPERT_NOTE = "every step reads all 64 experts' weights: capacity 8 a group of 8 tokens"


def _timed_static(serve, model, params, prompts, new: int) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.generate_static(model, params, prompts, new)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _timed_prefill(model, params, prompts, new: int) -> float:
    """Seconds to the first token on the static path: its prefill of the
    prompts right-padded by ``new``, logits read at the last prompt token."""
    B, L = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.nn.functional.pad(prompts, (0, new))},
                                  last=torch.full((B,), L - 1, device=prompts.device))
        logits.argmax(-1).cpu()
    return time.perf_counter() - t0


def profiled_decode_step(model, params, tok, cache, pos: int, ranges: dict) -> dict:
    """One decode step at ``pos``: wall on the host clock (the mean of 4
    after a warm one), then a profiled step with each function of
    ``ranges`` ({name: its module}) in a named range; the named ranges show
    on the device as spans of their own, and each kernel goes to the range
    whose span holds its start."""
    from contextlib import ExitStack
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.decode_step(params, tok, cache, pos)
        torch.cuda.synchronize()
        reps = 4
        t0 = time.perf_counter()
        for i in range(reps):
            model.decode_step(params, tok, cache, pos + 1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        with ExitStack() as stack:
            for name, mod in ranges.items():
                stack.enter_context(mock.patch.object(mod, name, _named(name, getattr(mod, name))))
            prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                           ProfilerActivity.CUDA]))
            model.decode_step(params, tok, cache, pos + 1 + reps)
            torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in ranges]
    by_range = range_ms(prof, ranges)
    device_ms = sum(e.time_range.end - e.time_range.start for e in kern) / 1e3
    busy_ms = union_ms(kern)
    avg = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.key not in ranges]
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:8]
    return {"decode_step_wall_ms": wall_ms, "decode_step_device_ms": device_ms,
            "decode_step_busy_ms": busy_ms, "decode_step_idle_share": 1 - busy_ms / wall_ms,
            "device_ms_by_range": by_range, "kernel_launches": sum(e.count for e in avg),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3} for e in top]}


HOST_LAUNCH_APIS = ("LaunchKernel", "GraphLaunch")   # cudaLaunchKernel(ExC), cuLaunchKernel(Ex),
#                                                     cudaGraphLaunch: what the host enqueues
STATIC_NEW = 8                   # the modes' window: 7 decode steps after the first token


def _host_launches(prof) -> int:
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and any(api in e.name for api in HOST_LAUNCH_APIS))


def static_modes(serve, model, params, prompts, new: int, label: str, card: str) -> dict:
    """``generate_static`` under "scan" and "stepped" on the same prompts.
    For each mode: a warm call of the same shape (scan captures its decode
    program there), a timed call (TTFT: the prefill and the first token, up
    to the decode; the decode's wall per step; tokens/s over the call;
    the graphs captured, which must be 0), then a call whose decode runs
    under torch.profiler (device ms and busy ms per step, the idle share
    against the timed wall, the kernels the card ran and the launches the
    host made per step).  Prints each mode's row and the two side by side
    with how many tokens agree; returns {mode: tokens}."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import static
    steps = new - 1
    windows, outs = {}, {}
    for mode in STEP_MODES:
        fn = getattr(static, f"decode_{mode}")
        seen: dict = {}

        def decode(*a, _fn=fn, _seen=seen):
            torch.cuda.synchronize()
            _seen["enter"] = time.perf_counter()
            if _seen.get("profile"):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = _fn(*a)
                    torch.cuda.synchronize()
                _seen["prof"] = prof
            else:
                out = _fn(*a)
                torch.cuda.synchronize()
            _seen["exit"] = time.perf_counter()
            return out

        def call():
            return serve.generate_static(model, params, prompts, new, step_mode=mode)

        with mock.patch.object(static, f"decode_{mode}", decode):
            call()
            torch.cuda.synchronize()
            caps = captured()
            t0 = time.perf_counter()
            outs[mode] = call()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            caps = captured() - caps
            wall_ms = (seen["exit"] - seen["enter"]) * 1e3 / steps
            ttft = seen["enter"] - t0
            seen["profile"] = True
            call()
        prof = seen["prof"]
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.time_range.end - e.time_range.start for e in kern) / 1e3 / steps
        busy_ms = union_ms(kern) / steps
        windows[mode] = {"phase": f"static decode {label}", "step_mode": mode, "card": card,
                         "batch": prompts.shape[0], "prompt_tokens": prompts.shape[1],
                         "new_tokens": new, "decode_steps": steps,
                         "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                         "idle_share": 1 - device_ms / wall_ms, "busy_ms_per_step": busy_ms,
                         "busy_idle_share": 1 - busy_ms / wall_ms,
                         "kernel_launches_per_step": len(kern) / steps,
                         "host_launches_per_step": _host_launches(prof) / steps,
                         "tokens_per_s": prompts.shape[0] * new / total, "ttft_s": ttft,
                         "total_s": total, "captures_in_timed_call": caps}
        print(json.dumps(windows[mode]), flush=True)
        check(caps == 0, f"static decode {label}: {caps} graphs captured in the timed "
                         f"{mode} call after a warm call of the same shape")
        check(bool(kern), f"static decode {label}: no device time under {mode}")
    agree = int((outs["scan"] == outs["stepped"]).sum())
    mode_windows(f"static decode {label}", windows, card, tokens_agreeing=agree,
                 tokens=outs["scan"].numel())
    return outs


def deepseek_serve_phase(zoo, get_config, serve, seed: int, card: str) -> None:
    """Phase 23: deepseek-v2-lite-16b as configured (27 layers, bf16) serves
    8 prompts of 256 tokens through the static path, 32 new tokens each."""
    cfg = get_config(DEEPSEEK)
    before = holding()
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    moe_layers = sum(cfg.moe_layer_flags())
    expert_bytes = sum(x.numel() * x.element_size()         # the 26 layers' banks, stacked
                       for k, x in params["blocks"]["b0"]["moe"].items()
                       if k in ("w_in", "w_gate", "w_out"))
    B, L, new = 8, 256, 32
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=DEV,
                            dtype=torch.int32)
    _timed_static(serve, model, params, prompts[:, :16], 2)          # warm the kernels
    _, ttft = _timed_static(serve, model, params, prompts, 1)       # prefill + first token
    out, total = _timed_static(serve, model, params, prompts, new)
    check(tuple(out.shape) == (B, new) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, f"deepseek serve: tokens {tuple(out.shape)}")

    # one decode step at the end of those sequences: wall on the host clock,
    # device time by kernel under torch.profiler with the MoE FFN and the MLA
    # decode in named ranges
    with torch.no_grad():
        seq = torch.cat([prompts, out], dim=1)
        logits, cache = model.prefill(params, {"tokens": torch.nn.functional.pad(seq, (0, 8))},
                                      last=torch.full((B,), L + new - 1, device=DEV))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
    step = profiled_decode_step(model, params, tok, cache, L + new,
                                {"moe_ffn": zoo.moe_lib, "mla_decode": zoo.attn})
    bound_ms = (nbytes - params["embed"].numel() * params["embed"].element_size()) \
        / HBM_BYTES_PER_S * 1e3
    ranges = step.pop("device_ms_by_range")
    row = {"phase": "deepseek-v2-lite-16b as configured, bf16, 27 layers: static serve",
           "card": card, "params": sum(x.numel() for x in _leaves(params)),
           "weights_gb": nbytes / 1e9, "init_s": init_s, "requests": B, "prompt_tokens": L,
           "new_tokens": new, "tokens_per_s": B * new / total, "ttft_s": ttft,
           "total_s": total, **step,
           "device_ms_moe_layers": ranges["moe_ffn"],
           "device_ms_mla_layers": ranges["mla_decode"],
           "moe_layers": moe_layers, "expert_weights_gb": expert_bytes / 1e9,
           "expert_bytes_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
           "decode_step_bytes_bound_ms": bound_ms, "bound_note": HBM_EXPERT_NOTE,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(row), flush=True)
    check(row["device_ms_moe_layers"] and row["device_ms_mla_layers"],
          f"deepseek serve: no device time in the MoE or MLA ranges: {ranges}")
    check(bool(logits.isfinite().all()), "deepseek serve: non-finite logits")
    del cache, logits
    static_modes(serve, model, params, prompts, STATIC_NEW, DEEPSEEK, card)
    del params, model
    torch.cuda.empty_cache()
    released(before, "phase 23")


# ---------------------------------------------------------------- phase 24
def head_fused_rounds_phase(fed, kd_ops, flash, seed: int, arch: str = "deepseek-v2-lite-16b"
                            ) -> dict:
    """``arch``'s ``reduced()``, f32: 2 head-fused Flash-KD rounds with the
    kernels and with their plain versions from the same weights, under
    deterministic algorithms (as phase 13 for gemma-2b); phases 24, 27 and
    30."""
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    from repro_torch.utils.pytree import tree_map
    task = lm_task(get_config(arch).reduced(), num_clients=4, docs_per_client=8, seq=128,
                   server_batches_n=2, server_batch=4, seed=seed, device=DEV)
    kw = dict(K=2, R=2, num_clients=4, participation=1.0, local_epochs=1, client_batch=4,
              distill_steps=20, client_lr=0.01, server_lr=0.01, kd_kernel="flash",
              kd_head_fusion=True, teacher_cache_dtype="float32", seed=seed)
    init = fed.make_runner("fedsdd", task, device=DEV, **kw).init_state().global_models
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for label in ("kernels", "plain"):
            runner = fed.make_runner("fedsdd", task, device=DEV, **kw)
            state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(2, 2))
            kernels.reset()
            with plain_flash(kd_ops, flash) if label == "plain" else nullcontext(), \
                    card_launches() as ran:
                state = runner.run(2, state=state)
            out[label] = (state, dict(ran))
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = out["kernels"][0], out["plain"][0]
    err = _tree_err(a.global_models[0], b.global_models[0])
    rest = all(torch.equal(x, y) for x, y in zip(_leaves(a.global_models[1]),
                                                 _leaves(b.global_models[1])))
    steps = 2 * kw["distill_steps"]
    row = {"phase": f"f32 LM rounds ({arch} reduced), kernels vs plain",
           "tol": ROUND_TOL, "main_max_abs_err": err, "model_1_bit_identical": rest,
           "launches": {k: v[1] for k, v in out.items()},
           "kd_loss_last": [r["kd_loss_last"] for r in a.history],
           "kd_loss_last_plain": [r["kd_loss_last"] for r in b.history]}
    print(json.dumps(row), flush=True)
    check(err <= ROUND_TOL and rest, f"{arch} reduced rounds: kernels vs plain {row}")
    check(out["kernels"][1] == {"flash_kd_head_fwd": steps, "flash_kd_head_bwd": steps}
          and out["plain"][1] == {}, f"{arch} reduced rounds: launches {row['launches']}")
    return out["kernels"][1]


def vectorized_kernel5_round(fed, wa_ops, wa_ref, task, kw: dict, label: str, seed: int,
                             card: str) -> tuple[dict, dict]:
    """One vectorized round (K=2, 2 of 4 clients, no KD steps) whose Eq. 2
    launches kernel 5 over the model's tree, then kernel 5 against its plain
    version over that tree at G = 2, N = 2 (the round's two new globals),
    timed.  Returns (the round's line, kernel 5's row)."""
    from repro_torch import kernels
    from repro_torch.utils.pytree import tree_map
    runner = fed.make_runner("fedsdd", task, device=DEV, K=2, R=1, participation=0.5,
                             execution="vectorized", distill_steps=0, **kw)
    state = runner.init_state()
    kernels.reset()
    torch.cuda.reset_peak_memory_stats()
    captures0 = captured()
    with card_launches() as ran:
        state = runner.run(1, state=state)
    rec = state.history[-1]
    line = {"active": rec["active"], "t_local_s": rec["t_local"],
            "captures": captured() - captures0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": dict(ran)}
    print(json.dumps({"phase": f"{label} vectorized round", "card": card, **line}), flush=True)
    check(ran.get("multi_weighted_average") == 1, f"{label} vectorized round: launches {line}")
    check(line["peak_mem_gb"] < PEAK_LIMIT_GB, f"{label} vectorized round: {line}")
    g0, g1 = state.global_models
    del runner, state
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    tree = tree_map(lambda a, b: torch.stack([torch.stack([a, b]), torch.stack([b, a])]), g0, g1)
    del g0, g1
    w = torch.randint(1, 100, (2, 2), generator=gen, device=DEV).float()
    row = wa_tree_check(wa_ops, wa_ref, f"{label} tree (G=2, N=2)", tree, w)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return line, row


def sequential_fedsdd_rounds(fed, task, kw: dict, steps_kd: int, label: str, card: str):
    """fedsdd K=2 R=2 over 4 clients, sequential, 2 rounds with head-fused
    Flash-KD and the ring in bf16 (as phase 14 drives gemma-2b): per round
    t_local, t_kd, the cache build, peak memory, captures and launches;
    checks no capture in round 2, kernels 9/10 ``steps_kd`` times a round,
    finite losses and weights, 4 teachers and the peak under 76 GB.
    Returns (rounds, state, the runner's KD pipeline, init seconds)."""
    from repro_torch import kernels
    t0 = time.perf_counter()
    runner = fed.make_runner("fedsdd", task, device=DEV, K=2, R=2, participation=1.0,
                             distill_steps=steps_kd, **kw)
    state = runner.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = runner._kd_pipeline()
    check(pipe.head_fused and pipe.cache_dtype == torch.bfloat16,
          f"{label}: the KD pipeline is not head-fused with a bf16 cache")
    cache_s = []
    build_cache = pipe.precompute_cache

    def timed_cache(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = build_cache(*a, **k)
        torch.cuda.synchronize()
        cache_s.append(time.perf_counter() - t)
        return r

    pipe.precompute_cache = timed_cache
    rounds = []
    kernels.reset()
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0, captures0 = time.perf_counter(), captured()
        with card_launches() as ran:
            state = runner.run(1, state=state)
        rec = state.history[-1]
        rounds.append({"round": rec["round"], "captures": captured() - captures0,
                       "t_round_s": time.perf_counter() - t0, "t_local_s": rec["t_local"],
                       "t_kd_s": rec["t_kd"], "t_cache_s": cache_s[-1],
                       "kd_loss_first": rec["kd_loss_first"], "kd_loss_last": rec["kd_loss_last"],
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "graph_pool_gb": graph_pool_gb(), "launches": dict(ran)})
        print(json.dumps({"phase": f"{label} FedSDD round, head-fused Flash-KD", "card": card,
                          **rounds[-1]}), flush=True)
    del pipe.precompute_cache, timed_cache, build_cache     # no pipeline kept past the phase
    check(rounds[1]["captures"] == 0, f"{label}: round 2 captured {rounds[1]['captures']}")
    check(all(r["launches"].get("flash_kd_head_fwd") == steps_kd
              and r["launches"].get("flash_kd_head_bwd") == steps_kd for r in rounds),
          f"{label}: kernels 9/10 not launched {steps_kd} times a round on the card: "
          f"{[r['launches'] for r in rounds]}")
    check(all(math.isfinite(r["kd_loss_last"]) for r in rounds)
          and all(bool(x.isfinite().all()) for m in state.global_models for x in _leaves(m)),
          f"{label}: non-finite KD losses or weights {rounds}")
    check(state.ensemble.num_members == 4, f"{label}: the ring does not hold 4 teachers")
    check(max(r["peak_mem_gb"] for r in rounds) < PEAK_LIMIT_GB,
          f"{label}: peak above {PEAK_LIMIT_GB} GB {rounds}")
    return rounds, state, pipe, init_s


def deepseek_fedsdd_phase(fed, wa_ops, wa_ref, seed: int, card: str) -> dict:
    """Phase 24: deepseek-v2-lite-16b at full width, 2 layers (the dense
    layer 0 and one MoE layer), f32.  First one vectorized round (K=2, 2 of
    4 clients, no KD steps, its client engine stepped) whose Eq. 2 launches
    kernel 5 over the MoE tree, and kernel 5 against its plain version over
    that tree at G = 2, N = 2; then FedSDD with head-fused Flash-KD and the
    ring in bf16, sequential (K=2, R=2, 4 clients, 2 rounds), and the
    round's KD program profiled.  Returns the phase's line."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    n_params = cfg.num_params()
    # the reckoning before the run: K old and K new globals and the 4 clients
    # in f32, the K·R ring in bf16
    line = {"phase": "deepseek-v2-lite-16b full width, 2 layers, FedSDD", "card": card,
            "params_per_model": n_params, "model_gb_f32": n_params * 4 / 1e9,
            "reckoned_gb": (8 * n_params * 4 + 4 * n_params * 2) / 1e9}
    task = lm_task(cfg, num_clients=4, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    steps_kd = 20
    kw = dict(num_clients=4, client_batch=4, local_epochs=1, client_lr=0.01, server_lr=0.01,
              kd_kernel="flash", kd_head_fusion=True, teacher_dtype="bfloat16", seed=seed)

    # (1) the vectorized round, its client engine stepped (the bucket
    # program's static buffers, graph pool and clones of the 2-client stack,
    # or a KD beside the round's stacks, do not fit)
    with step_mode("stepped"):
        line["vectorized"], line["kernel_5_moe_tree"] = vectorized_kernel5_round(
            fed, wa_ops, wa_ref, task, kw, "deepseek-v2-lite-16b 2-layer", seed, card)

    # (2) the sequential rounds with head-fused Flash-KD
    line["sequential"], state, pipe, line["init_s"] = sequential_fedsdd_rounds(
        fed, task, kw, steps_kd, "deepseek-v2-lite-16b", card)
    print(json.dumps(line), flush=True)

    # where a KD step's time goes: the round's own KD program (20 steps)
    batches = pipe.batches_for(task.server_batches)
    student = state.global_models[0]
    cache = pipe._cache(student, state.ensemble.member_views(), batches)
    pipe._run(student, batches, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe._run(student, batches, cache)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps_kd
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe._run(student, batches, cache)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups = {k: ms / steps_kd for k, ms in _kd_groups(kern).items()}
    busy = busy_ms_of(prof) / steps_kd
    line["kd_step"] = {"rows": 512, "wall_ms": wall_ms, "busy_ms": busy,
                       "idle_share": 1 - busy / wall_ms, "device_ms_by_group": groups}
    print(json.dumps({"phase": "profile: 20 head-fused KD steps, deepseek-v2-lite-16b "
                      "full width, 512 rows", "card": card, **line["kd_step"]}), flush=True)
    check(groups["flash_kd_head_fwd"] > 0 and groups["flash_kd_head_bwd"] > 0,
          f"deepseek profile: no device time for kernels 9/10: {groups}")
    del cache, student, pipe, state, kern, prof
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------- phase 25
XLSTM = "xlstm-1.3b"
JAMBA = "jamba-1.5-large-398b"
DECODE_TOL = 5e-4                # of the logits' scale: tests/test_decode_consistency.py
XLSTM_F32_LAYERS = 8             # two superblocks: six mLSTM, two sLSTM


def xlstm_f32_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 25: xlstm-1.3b at full width, 8 layers, f32: decode token by
    token from an empty state equals a full forward over the same 128
    tokens within 5e-4 of the logits' scale, and a prefill of the first 64
    tokens (one chunk) followed by decode of the rest equals the forward on
    the back half."""
    import dataclasses
    cfg = dataclasses.replace(get_config(XLSTM), num_layers=XLSTM_F32_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    before = holding()
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    B, S = 4, 128
    gen = torch.Generator(device=DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV, dtype=torch.int32)
    half = cfg.ssm.chunk_size
    # the static path: 48 + 16 tokens, one chunk
    scan = serve.generate_static(model, params, toks[:, :48], 16, step_mode="scan")
    stepped = serve.generate_static(model, params, toks[:, :48], 16, step_mode="stepped")
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        dec = _decode_all(model, params, toks, model.init_cache(B, S, device=DEV))
        first, cache = model.prefill(params, {"tokens": toks[:, :half]})
        rest = _decode_all(model, params, toks[:, half:], cache, half)
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    err_half = max(float((first - full[:, half - 1]).abs().max()),
                   float((rest - full[:, half:]).abs().max()))
    dtypes = sorted({str(v.dtype) for v in _leaves(cache)})
    row = {"phase": "xlstm-1.3b full width, f32, 8 layers: decode == forward", "card": card,
           "schedule": [k.mixer for k in model.schedule], "tokens": B * S,
           "logit_scale": scale, "tol": DECODE_TOL * scale,
           "decode_vs_forward_max_abs_err": err,
           "prefill_then_decode_max_abs_err": err_half, "state_dtypes": dtypes,
           "static_scan_equals_stepped": bool(torch.equal(scan, stepped))}
    print(json.dumps(row), flush=True)
    check(row["static_scan_equals_stepped"],
          f"xlstm f32: static tokens under scan {scan.tolist()} != stepped {stepped.tolist()}")
    check(err <= DECODE_TOL * scale and err_half <= DECODE_TOL * scale,
          f"xlstm f32: decode parts from the forward {row}")
    check(dtypes == ["torch.float32"], f"xlstm f32: state dtypes {dtypes}")
    del params, model, full, dec, cache
    torch.cuda.empty_cache()
    released(before, "phase 25")
    return row


# ---------------------------------------------------------------- phase 26
def xlstm_serve_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 26: xlstm-1.3b as configured (48 layers, bf16, random weights
    made on the card) serves 8 prompts of 224 tokens through the static
    path, 32 new tokens each (L + new = 256, a multiple of the chunk 64)."""
    cfg = get_config(XLSTM)
    before = holding()
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    B, L, new = 8, 224, 32
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=DEV,
                            dtype=torch.int32)
    _timed_static(serve, model, params, prompts[:, :48], 16)        # warm: 64 tokens
    ttft = _timed_prefill(model, params, prompts, new)
    out, total = _timed_static(serve, model, params, prompts, new)
    check(tuple(out.shape) == (B, new) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, f"xlstm serve: tokens {tuple(out.shape)}")
    # one decode step after those sequences (a prefill of 256 tokens)
    with torch.no_grad():
        seq = torch.cat([prompts, out], dim=1)
        logits, cache = model.prefill(params, {"tokens": seq})
        tok = logits.argmax(-1).to(torch.int32)[:, None]
    step = profiled_decode_step(model, params, tok, cache, L + new,
                                {"mlstm_decode": zoo.ssm_lib, "slstm_decode": zoo.ssm_lib})
    sbytes = sum(x.numel() * x.element_size() for x in _leaves(cache))
    # the step's least bytes: every weight but the embedding table (one row
    # a token), and each state read once and written once
    bound_ms = (nbytes - params["embed"].numel() * params["embed"].element_size()
                + 2 * sbytes) / HBM_BYTES_PER_S * 1e3
    row = {"phase": "xlstm-1.3b as configured, bf16, 48 layers: static serve", "card": card,
           "params": sum(x.numel() for x in _leaves(params)), "weights_gb": nbytes / 1e9,
           "state_gb": sbytes / 1e9, "init_s": init_s, "requests": B, "prompt_tokens": L,
           "new_tokens": new, "tokens_per_s": B * new / total, "ttft_s": ttft,
           "total_s": total, **step, "decode_step_bytes_bound_ms": bound_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(row), flush=True)
    check(all(step["device_ms_by_range"].values()),
          f"xlstm serve: no device time in a mixer's range: {step['device_ms_by_range']}")
    check(bool(logits.isfinite().all()), "xlstm serve: non-finite logits")
    check(all(x.dtype == torch.float32 for x in _leaves(cache)), "xlstm serve: bf16 states")
    del cache, logits
    # 184 + 8 = 192 tokens, three chunks
    static_modes(serve, model, params, prompts[:, :184], STATIC_NEW, XLSTM, card)
    del params, model
    torch.cuda.empty_cache()
    released(before, "phase 26")
    return row


# ---------------------------------------------------------------- phase 27
# peak / model bytes of phase 24's sequential FedSDD run (deepseek 2 layers,
# K=2 R=2, 4 clients, f32, bf16 ring: 53.0 GB for 4.34 GB models, PERF.md)
FEDSDD_PEAK_PER_MODEL = 53.0 / 4.34
# both full-width rounds' depth: the vectorized one's 2-client stack under
# scan fits at 24; the sequential run fit at all 48 (peak 60.7 GB) but took
# 69 s of the whole run's time limit (PERF.md §7)
XLSTM_FED_LAYERS = 24


def _xlstm_cfg(get_config, layers: int):
    import dataclasses
    return dataclasses.replace(get_config(XLSTM), num_layers=layers, param_dtype="float32",
                               compute_dtype="float32")


def xlstm_param_count(cfg) -> int:
    """Parameters of an xLSTM model as ``init`` makes them (the reference's
    ``num_params`` counts its blocks with another formula)."""
    D, V, nh = cfg.d_model, cfg.vocab_size, cfg.num_heads
    mlstm = 5 * D * D + 2 * D * nh + nh + D                  # q k v z out, gates, norm
    slstm = 4 * D * D + 4 * D * D // nh + 4 * D + D * D + D   # w_in, r, b, out, norm
    r = cfg.ssm.xlstm_slstm_ratio
    n_s = cfg.num_layers // r if r else 0
    return (cfg.num_layers - n_s) * mlstm + n_s * slstm + 2 * V * D + D


def xlstm_fedsdd_phase(fed, wa_ops, wa_ref, kd_ops, flash, seed: int, card: str) -> dict:
    """Phase 27 (b)-(d): xlstm-1.3b at full width, f32.  (c) one vectorized
    round (K=2, 2 of 4 clients, no KD steps, the bucket step captured) at
    24 layers whose Eq. 2 launches kernel 5 over the xLSTM tree, and kernel
    5 against its plain version over that tree at G = 2, N = 2; (d) kernels
    9/10 against their plain versions at xlstm's head (512 x 2,048 x 50,304,
    untied, f32 head, bf16 cache), timed; (b) fedsdd K=2 R=2 over 4 clients,
    2 rounds, lm_task of 8 docs of 128 tokens, head-fused Flash-KD, the
    ring in bf16, sequential; both rounds at ``XLSTM_FED_LAYERS``, the
    sequential run's peak reckoned from phase 24's before it.  Returns the
    phase's line."""
    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    layers = XLSTM_FED_LAYERS
    cfg = _xlstm_cfg(get_config, layers)
    n_params = xlstm_param_count(cfg)
    line = {"phase": f"xlstm-1.3b full width, {layers} of 48 layers, FedSDD", "card": card,
            "layers": layers, "params_per_model": n_params, "model_gb_f32": n_params * 4 / 1e9,
            "reckoned_peak_gb": FEDSDD_PEAK_PER_MODEL * n_params * 4 / 1e9}
    check(line["reckoned_peak_gb"] < PEAK_LIMIT_GB, f"xlstm: reckoned {line}")
    kw = dict(num_clients=4, client_batch=4, local_epochs=1, client_lr=0.01, server_lr=0.01,
              kd_kernel="flash", kd_head_fusion=True, teacher_dtype="bfloat16", seed=seed)
    task = lm_task(cfg, num_clients=4, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)

    # (c) the vectorized round, its bucket step a captured program
    line["vectorized"], line["kernel_5_xlstm_tree"] = vectorized_kernel5_round(
        fed, wa_ops, wa_ref, task, kw, f"xlstm-1.3b {layers}-layer", seed, card)
    line["vectorized"]["layers"] = layers

    # (d) kernels 9/10 at xlstm's head
    gen = torch.Generator(device=DEV).manual_seed(seed)
    D, V = cfg.d_model, cfg.vocab_size
    rnd = lambda shape, scale, dt=torch.float32: (  # noqa: E731
        torch.randn(shape, generator=gen, device=DEV) * scale).to(dt)
    line["head"] = flash_check(kd_ops, flash, f"512x{D}x{V} untied (xlstm-1.3b)",
                               h=rnd((512, D), 1), w=rnd((D, V), 0.02),
                               z=rnd((512, V), 3, torch.bfloat16), timed=True)
    torch.cuda.empty_cache()

    # (b) the sequential rounds with head-fused Flash-KD
    line["sequential"], state, pipe, line["init_s"] = sequential_fedsdd_rounds(
        fed, task, kw, 20, f"xlstm-1.3b {layers}-layer", card)
    print(json.dumps({k: v for k, v in line.items() if k != "head"}), flush=True)
    del pipe, state, task
    gc.collect()
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------- phase 28
JAMBA_NO_DROPS = 8.0             # capacity = tokens a group x 8 x top-2 / 16 experts: no drops


def _jamba_cfg(get_config, **changes):
    import dataclasses
    base = get_config(JAMBA)
    return dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                             capacity_factor=JAMBA_NO_DROPS),
                               **changes)


def jamba_f32_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 28: jamba-1.5-large-398b at full width, f32, 2 layers (attn_period
    2: (Mamba, dense), (GQA, MoE); 11.9 B parameters, 47.6 GB): decode from
    an empty state over 128 tokens equals the full forward within 5e-4 of
    the logits' scale."""
    import dataclasses
    base = get_config(JAMBA)
    cfg = _jamba_cfg(get_config, num_layers=2, param_dtype="float32", compute_dtype="float32",
                     ssm=dataclasses.replace(base.ssm, attn_period=2))
    before = holding()
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    B, S = 2, cfg.ssm.chunk_size
    gen = torch.Generator(device=DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV, dtype=torch.int32)
    # the static path: 112 + 16 tokens, one chunk
    scan = serve.generate_static(model, params, toks[:, :112], 16, step_mode="scan")
    stepped = serve.generate_static(model, params, toks[:, :112], 16, step_mode="stepped")
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        cache = model.init_cache(B, S, device=DEV)
        dec = _decode_all(model, params, toks, cache)
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    row = {"phase": "jamba-1.5-large-398b full width, f32, 2 layers: decode == forward",
           "card": card,
           "schedule": [f"{k.mixer}/{k.ffn}" for k in model.schedule],
           "params": sum(x.numel() for x in _leaves(params)), "tokens": B * S,
           "capacity_factor": JAMBA_NO_DROPS, "logit_scale": scale, "tol": DECODE_TOL * scale,
           "decode_vs_forward_max_abs_err": err,
           "state_dtypes": {k: str(v.dtype) for k, v in cache["prefix"][0].items()}
           if cache["prefix"] else {k: str(v.dtype) for k, v in cache["blocks"]["b0"].items()},
           "static_scan_equals_stepped": bool(torch.equal(scan, stepped))}
    print(json.dumps(row), flush=True)
    check(err <= DECODE_TOL * scale, f"jamba f32: decode parts from the forward {row}")
    check(row["static_scan_equals_stepped"],
          f"jamba f32: static tokens under scan {scan.tolist()} != stepped {stepped.tolist()}")
    del params, model, full, dec, cache
    torch.cuda.empty_cache()
    released(before, "phase 28")
    return row


# ---------------------------------------------------------------- phase 29
def jamba_serve_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 29: jamba at full width cut to the reference's reduced()
    schedule (4 layers, attn_period 4: (Mamba, dense), (Mamba, MoE), (Mamba,
    dense), (GQA, MoE); 23.0 B parameters), bf16, random weights made on the
    card: 4 prompts of 224 tokens + 32 new through the static path (256, a
    multiple of the chunk 128); the bf16 decode from an empty state over
    the first 128 tokens against the forward, printed beside phase 28's f32
    check; a decode step's wall, device, idle share and bytes bound."""
    import dataclasses
    base = get_config(JAMBA)
    cfg = _jamba_cfg(get_config, num_layers=4, ssm=dataclasses.replace(base.ssm, attn_period=4))
    before = holding()
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    B, L, new = 4, 224, 32
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=DEV,
                            dtype=torch.int32)
    S = cfg.ssm.chunk_size
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": prompts[:, :S]})
        dec = _decode_all(model, params, prompts[:, :S], model.init_cache(B, S, device=DEV))
    scale = float(full.abs().max())
    bf16_err = float((dec.float() - full.float()).abs().max())
    del full, dec
    _timed_static(serve, model, params, prompts[:, :112], 16)       # warm: 128 tokens
    ttft = _timed_prefill(model, params, prompts, new)
    out, total = _timed_static(serve, model, params, prompts, new)
    check(tuple(out.shape) == (B, new) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, f"jamba serve: tokens {tuple(out.shape)}")
    with torch.no_grad():
        seq = torch.cat([prompts, out], dim=1)
        logits, cache = model.prefill(params, {"tokens": torch.nn.functional.pad(seq, (0, S))},
                                      last=torch.full((B,), L + new - 1, device=DEV))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
    step = profiled_decode_step(model, params, tok, cache, L + new,
                                {"mamba_decode": zoo.ssm_lib, "moe_ffn": zoo.moe_lib})
    blocks = [*cache["prefix"], *cache["blocks"].values()]      # stacked: every layer
    sbytes = sum(x.numel() * x.element_size() for blk in blocks for k, x in blk.items()
                 if k not in ("k", "v"))
    n_attn = sum(k.mixer == "gqa" for k in model.schedule)
    kv_live = n_attn * 2 * B * (L + new + 1) * cfg.num_kv_heads * cfg.head_dim * 2
    # every weight but the embedding (a group of 4 tokens has capacity 8 in
    # each of the 16 experts, so the batched products read every bank), the
    # states read and written once, the live K/V read once
    bound_ms = (nbytes - params["embed"].numel() * params["embed"].element_size()
                + 2 * sbytes + kv_live) / HBM_BYTES_PER_S * 1e3
    row = {"phase": "jamba-1.5-large-398b full width, bf16, 4 layers: static serve",
           "card": card, "schedule": [f"{k.mixer}/{k.ffn}" for k in model.schedule],
           "params": sum(x.numel() for x in _leaves(params)), "weights_gb": nbytes / 1e9,
           "init_s": init_s, "capacity_factor": JAMBA_NO_DROPS, "requests": B,
           "prompt_tokens": L, "new_tokens": new, "tokens_per_s": B * new / total,
           "ttft_s": ttft, "total_s": total,
           "bf16_decode_vs_forward_max_abs_err": bf16_err, "logit_scale": scale,
           **step, "decode_step_bytes_bound_ms": bound_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(row), flush=True)
    check(all(step["device_ms_by_range"].values()),
          f"jamba serve: no device time in a range: {step['device_ms_by_range']}")
    check(bool(logits.isfinite().all()) and math.isfinite(bf16_err),
          "jamba serve: non-finite logits")
    check(row["peak_mem_gb"] < 80.0, f"jamba serve: peak {row['peak_mem_gb']} GB")
    del cache, logits, blocks
    # 120 + 8 = 128 tokens, one chunk
    static_modes(serve, model, params, prompts[:, :120], STATIC_NEW, JAMBA, card)
    del params, model
    torch.cuda.empty_cache()
    released(before, "phase 29")
    return row


# ---------------------------------------------------------------- phase 31
LLAMA4 = "llama4-maverick-400b-a17b"
HUBERT = "hubert-xlarge"
LLAVA = "llava-next-mistral-7b"
LLAMA4_F32_EXPERTS = 32          # of 128: 6.5 B parameters, 26 GB in f32 (128 would be 74)
LLAMA4_F32_CAPACITY = 32.0       # capacity = a group's tokens x 32 / 32 experts: no drops


def _llama4_cfg(get_config, **changes):
    """llama4-maverick at full width, 2 layers (MoE at layer 0, dense at 1)."""
    import dataclasses
    return dataclasses.replace(get_config(LLAMA4), num_layers=2, **changes)


def llama4_f32_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 31: llama4-maverick at full width, 2 layers, f32, 32 of its 128
    experts, capacity factor 32 (no drops): decode from an empty cache over
    128 tokens equals the full forward within 5e-4 of the logits' scale;
    generate_static's tokens under "scan" equal those under "stepped"; the
    ContinuousEngine's tokens (kernel 1, window 8,192) equal
    generate_static's for requests within the window."""
    import dataclasses
    base = get_config(LLAMA4)
    cfg = _llama4_cfg(get_config, param_dtype="float32", compute_dtype="float32",
                      moe=dataclasses.replace(base.moe, num_experts=LLAMA4_F32_EXPERTS,
                                              capacity_factor=LLAMA4_F32_CAPACITY))
    before = holding()
    model = zoo.build_model(cfg)
    params = model.init(seed, device=DEV)
    B, S = 2, 128
    gen = torch.Generator(device=DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=DEV, dtype=torch.int32)
    scan = serve.generate_static(model, params, toks[:, :48], 16, step_mode="scan")
    stepped = serve.generate_static(model, params, toks[:, :48], 16, step_mode="stepped")
    with torch.no_grad():
        full, _ = model.logits(params, {"tokens": toks})
        dec = _decode_all(model, params, toks, model.init_cache(B, S, device=DEV))
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    del full, dec
    # the engine against the static path, every request within the window
    from repro_torch import kernels
    rng = np.random.default_rng(seed)
    reqs = make_requests(serve.Request, cfg.vocab_size, 6, rng, (16, 400), (4, 24))
    check(all(len(r.tokens) + r.max_new_tokens <= cfg.sliding_window for r in reqs),
          "llama4 f32: a request outgrows the window")
    engine = serve.ContinuousEngine(model, params, max_batch=4, num_blocks=200,
                                    block_size=16, max_seq_len=432, chunk_steps=4)
    kernels.launches.clear()
    with card_launches() as ran:
        results, _ = drive(engine, reqs)
    launches, host = ran["paged_decode"], kernels.launches["paged_decode"]
    got = {r.rid: r.tokens for r in results}
    static = {r.rid: serve.generate_static(model, params, r.tokens[None],
                                           r.max_new_tokens)[0].cpu().tolist() for r in reqs}
    row = {"phase": "llama4-maverick full width, f32, 2 layers", "card": card,
           "schedule": [f"{k.mixer}/{k.ffn}" for k in model.schedule],
           "prefix_period": list(model.prefix_period),
           "params": sum(x.numel() for x in _leaves(params)),
           "experts": LLAMA4_F32_EXPERTS, "capacity_factor": LLAMA4_F32_CAPACITY,
           "tokens": B * S, "logit_scale": scale, "tol": DECODE_TOL * scale,
           "decode_vs_forward_max_abs_err": err,
           "static_scan_equals_stepped": bool(torch.equal(scan, stepped)),
           "engine_requests": len(reqs),
           "engine_equals_static": [got[r.rid] == static[r.rid] for r in reqs],
           "paged_decode_launches": launches, "paged_decode_wrapper_launches": host,
           "micro_steps": engine.steps}
    print(json.dumps(row), flush=True)
    check(err <= DECODE_TOL * scale, f"llama4 f32: decode parts from the forward {row}")
    check(row["static_scan_equals_stepped"],
          f"llama4 f32: static tokens under scan {scan.tolist()} != stepped {stepped.tolist()}")
    check(all(row["engine_equals_static"]), f"llama4 f32: engine against static {got} {static}")
    check(launches == cfg.num_layers * engine.steps and host > 0,
          f"llama4 f32: {launches} launches on the card ({host} by the wrapper) for "
          f"{engine.steps} micro-steps")
    del engine, params, model
    torch.cuda.empty_cache()
    released(before, "phase 31")
    return row


# ------------------------------------------------------------- phases 32-33
def engine_serve(serve, model, params, cfg, make_reqs, rng, label: str, card: str, *,
                 num_blocks: int, max_seq_len: int, before_launches: int,
                 ranges: dict | None = None, weights_bound: bool = False) -> tuple:
    """``ContinuousEngine(max_batch=8, block_size=16, chunk_steps=8)`` serves
    ``make_reqs()`` after a warm-up of 2 short requests (every batch drawn
    from ``rng``): token counts, the drained pool, tokens/s, TTFT p50, the
    longest prompt's prefill, peak memory; kernel 1's launches counted over
    a third batch of 8 short requests (one a layer a micro-step); then one
    chunk profiled under each step mode (``profile_modes``), with ``ranges``
    and, with ``weights_bound``, a micro-step's bytes bound: every weight
    but the embedding read once (a MoE layer's 8 tokens a micro-step have
    capacity 8 in every expert, so the batched products read every bank).
    Phases 17, 32 and 33.  Returns (the line, the requests)."""
    from repro_torch import kernels
    engine = serve.ContinuousEngine(model, params, max_batch=8, num_blocks=num_blocks,
                                    block_size=16, max_seq_len=max_seq_len, chunk_steps=8)
    kernels.launches.clear()
    drive(engine, make_requests(serve.Request, cfg.vocab_size, 2, rng, (32, 64), (8, 8)))
    reqs = make_reqs()
    steps0, captures0 = engine.steps, captured()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, _ = drive(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    micro = engine.steps - steps0
    steps1 = engine.steps
    with card_launches() as ran:
        drive(engine, make_requests(serve.Request, cfg.vocab_size, 8, rng, (32, 512), (8, 24)))
    launches, counted_micro = ran["paged_decode"], engine.steps - steps1
    host = kernels.launches["paged_decode"]
    by_rid = {r.rid: r for r in results}
    check(len(results) == len(reqs), f"{label}: {len(results)} results for {len(reqs)}")
    for r in reqs:
        check(not by_rid[r.rid].cancelled and len(by_rid[r.rid].tokens) == r.max_new_tokens,
              f"{label}: request {r.rid}: {len(by_rid[r.rid].tokens)} tokens")
    check(engine.alloc.used_blocks == 0 and engine.reserved_tokens == 0,
          f"{label}: pool not free after the drain")
    check(host > 0 and launches > 0 and launches == cfg.num_layers * counted_micro,
          f"{label}: {launches} paged_decode launches on the card ({host} by the wrapper) "
          f"for {counted_micro} micro-steps x {cfg.num_layers}")
    ntok = sum(len(r.tokens) for r in results)
    ttft = sorted(r.ttft for r in results)
    longest = by_rid[max(reqs, key=lambda r: len(r.tokens)).rid]
    line = {"phase": f"{label} serve", "card": card, "requests": len(results),
            "generated_tokens": ntok, "prompt_tokens": int(sum(len(r.tokens) for r in reqs)),
            "wall_s": wall, "tokens_per_s": ntok / wall,
            "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
            "longest_prompt": max(len(r.tokens) for r in reqs),
            "longest_prefill_s": longest.t_first - longest.t_admit, "micro_steps": micro,
            "captures_after_warm_up": captured() - captures0,
            "counted_micro_steps": counted_micro, "paged_decode_launches": launches,
            "paged_decode_launches_per_micro_step": launches / counted_micro,
            "paged_decode_wrapper_launches": host,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if weights_bound:
        nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
        nbytes -= params["embed"].numel() * params["embed"].element_size()
        line["micro_step_weights_gb"] = nbytes / 1e9
        line["micro_step_bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(json.dumps(line), flush=True)
    line["profile"] = profile_modes(engine, serve, cfg.vocab_size, rng, before_launches,
                                    f"{label} decode micro-step", card, ranges)
    if ranges:
        check(all(line["profile"]["stepped"]["device_ms_by_range"].values()),
              f"{label}: no device time in a range: {line['profile']['stepped']}")
    return line, reqs


def llama4_serve_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 32: llama4-maverick at full width, 2 layers (MoE, dense), all
    128 experts, bf16, the configured capacity factor 1.25, random weights
    made on the card: the ContinuousEngine serves 8 requests of 32-2,048
    tokens and one of 10,240 (past the 8,192 window); kernel 1 twice a
    micro-step; a profiled chunk with the MoE FFN's range beside the
    micro-step's bytes bound; then the static decode under both step modes."""
    cfg = _llama4_cfg(get_config)
    before = holding()
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} weights "
          f"in {init_s:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    line, _ = engine_serve(
        serve, model, params, cfg,
        lambda: [*make_requests(serve.Request, cfg.vocab_size, 8, rng, (32, 2048), (8, 64)),
                 serve.Request(rid=8, tokens=rng.integers(0, cfg.vocab_size, LLAMA4_LENS[-1])
                               .astype(np.int32), max_new_tokens=32)],
        rng, "llama4-maverick 2-layer bf16", card, num_blocks=2000,
        max_seq_len=max(LLAMA4_LENS[-1], 2048) + 64, before_launches=0,
        ranges={"moe_ffn": zoo.moe_lib}, weights_bound=True)
    line.update(params=sum(x.numel() for x in _leaves(params)), init_s=init_s)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (8, 256), generator=gen, device=DEV,
                            dtype=torch.int32)
    static_modes(serve, model, params, prompts, STATIC_NEW, LLAMA4, card)
    del params, model
    torch.cuda.empty_cache()
    released(before, "phase 32")
    return line


def llava_serve_phase(zoo, get_config, serve, seed: int, card: str) -> dict:
    """Phase 33: llava-next-mistral-7b as configured (32 layers, bf16, random
    weights made on the card): the ContinuousEngine serves 16 text requests
    (the engines take tokens, as the reference's); kernel 1 once a layer a
    micro-step; a profiled chunk; one prefill over the configured prefix
    budget, 2,880 patch embeddings + 128 text tokens, timed; then the
    static decode under both step modes."""
    cfg = get_config(LLAVA)
    before = holding()
    model = zoo.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init: {serve.pool_bytes(params) / 1e9:.2f} GB of {cfg.param_dtype} weights "
          f"in {init_s:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    line, _ = engine_serve(
        serve, model, params, cfg,
        lambda: make_requests(serve.Request, cfg.vocab_size, 16, rng, (32, 512), (8, 64)),
        rng, "llava-next-mistral-7b bf16", card, num_blocks=1024, max_seq_len=640,
        before_launches=0, weights_bound=True)
    # the prefix budget: 2,880 projected patch embeddings spliced over the
    # first positions, then 128 text tokens
    P, text = cfg.num_prefix_embeds, 128
    gen = torch.Generator(device=DEV).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, P + text), generator=gen,
                                     device=DEV, dtype=torch.int32),
             "embeds": torch.randn((1, P, cfg.frontend_dim), generator=gen, device=DEV)}
    with torch.no_grad():
        model.prefill(params, batch)                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    line.update(params=sum(x.numel() for x in _leaves(params)), init_s=init_s,
                prefix_prefill={"patch_embeds": P, "text_tokens": text, "prefill_s": prefill_s,
                                "cache_seq": caches["blocks"]["b0"]["k"].shape[2]})
    print(json.dumps({"phase": "llava prefill over the prefix budget", "card": card,
                      **line["prefix_prefill"]}), flush=True)
    check(bool(logits.isfinite().all()) and tuple(logits.shape) == (1, cfg.vocab_size),
          f"llava prefill: logits {tuple(logits.shape)}")
    del logits, caches, batch
    prompts = torch.randint(0, cfg.vocab_size, (8, 256), generator=gen, device=DEV,
                            dtype=torch.int32)
    static_modes(serve, model, params, prompts, STATIC_NEW, LLAVA, card)
    del params, model
    torch.cuda.empty_cache()
    released(before, "phase 33")
    return line


# ---------------------------------------------------------------- phase 34
LLAVA_ROUND_SEQ = 3072           # past the 2,880-position prefix budget the loss masks out


def frontends_fedsdd_phase(fed, wa_ops, wa_ref, kd_ops, flash, seed: int, card: str) -> dict:
    """Phase 34.  (a) llama4-maverick, hubert-xlarge and llava reduced, f32:
    2 head-fused Flash-KD rounds with kernels 9/10 and with their plain
    versions from the same weights, within 2e-4; (b) hubert-xlarge at full
    depth and width (48 layers, f32): fedsdd K=2 R=2 over 4 clients, 2
    rounds, lm_task of 8 docs of 128 frames, head-fused Flash-KD, the ring
    in bf16, after one vectorized round of 2 clients (its client engine
    stepped) whose Eq. 2 launches kernel 5 over hubert's tree, and kernel
    5 against its plain version over it; (c) llava at full width, 2 layers,
    f32: the same rounds over 2 docs a client of 3,072 tokens, client batch
    2, one doc a server batch (3,072 KD rows; 1,536 spliced patch
    embeddings a doc, the loss over positions 2,880-3,071).  Returns the
    phase's line."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tasks import lm_task
    line = {"phase": "the frontends and llama4 FedSDD", "card": card,
            "reduced": {arch: head_fused_rounds_phase(fed, kd_ops, flash, seed, arch)
                        for arch in (LLAMA4, HUBERT, LLAVA)}}
    kw = dict(num_clients=4, client_batch=4, local_epochs=1, client_lr=0.01, server_lr=0.01,
              kd_kernel="flash", kd_head_fusion=True, teacher_dtype="bfloat16", seed=seed)

    # (b) hubert-xlarge at full depth and width
    cfg = dataclasses.replace(get_config(HUBERT), param_dtype="float32",
                              compute_dtype="float32")
    n_params = cfg.num_params()
    hub = {"params_per_model": n_params, "model_gb_f32": n_params * 4 / 1e9,
           "reckoned_peak_gb": FEDSDD_PEAK_PER_MODEL * n_params * 4 / 1e9}
    check(hub["reckoned_peak_gb"] < PEAK_LIMIT_GB, f"hubert: reckoned {hub}")
    task = lm_task(cfg, num_clients=4, docs_per_client=8, seq=128, server_batches_n=2,
                   server_batch=4, seed=seed, device=DEV)
    # the vectorized round first, its client engine stepped, as phase 24
    # runs deepseek's: under scan the bucket program's static buffers and
    # graph pool for a 2-client stack of 3.8 GB models held 35.7 GB and the
    # round ran out of memory (PERF.md, §6)
    with step_mode("stepped"):
        hub["vectorized"], hub["kernel_5_hubert_tree"] = vectorized_kernel5_round(
            fed, wa_ops, wa_ref, task, kw, "hubert-xlarge 48-layer", seed, card)
    hub["sequential"], state, pipe, hub["init_s"] = sequential_fedsdd_rounds(
        fed, task, kw, 20, "hubert-xlarge 48-layer", card)
    del pipe, state, task
    gc.collect()
    torch.cuda.empty_cache()
    hub["allocated_gb_after"] = torch.cuda.memory_allocated() / 1e9
    line["hubert"] = hub

    # (c) llava at full width, 2 layers, docs past the prefix budget
    cfg = dataclasses.replace(get_config(LLAVA), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    task = lm_task(cfg, num_clients=4, docs_per_client=2, seq=LLAVA_ROUND_SEQ,
                   server_batches_n=2, server_batch=1, seed=seed, device=DEV)
    lv = {"params_per_model": cfg.num_params(), "seq": LLAVA_ROUND_SEQ,
          "patch_embeds_per_doc": task.client_data[0]["embeds"].shape[1]}
    lv["sequential"], state, pipe, lv["init_s"] = sequential_fedsdd_rounds(
        fed, task, dict(kw, client_batch=2), 20, "llava 2-layer", card)
    with torch.no_grad():
        loss, _ = task.loss_fn(state.global_models[0],
                               task.make_batch(task.client_data[0], [0, 1]))
    lv["client_loss"] = float(loss)
    check(lv["client_loss"] > 0 and math.isfinite(lv["client_loss"]),
          f"llava round: client loss {lv['client_loss']} (0 would mean no scored position)")
    del pipe, state, task
    gc.collect()
    torch.cuda.empty_cache()
    line["llava"] = lv
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------- phase 35
SHARD_ROUNDS = 2
TEACHER_ALL_REDUCE_BYTES = 8 * 256 * 10 * 4     # the server set's (nB, B, V) f32 logit sum


def shard_map_phase(fed, seed: int, card: str) -> dict:
    """FedSDD on the vectorized engine with client_sharding="shard_map" over
    a one-rank NCCL group, against "vmap" from the same weights: models k>0
    bit for bit, the main model within 2e-4 (the teacher pass sums its
    members before kernel 2, on an M = 1 stack), the same launches; round 2
    of each under the contracts; the collectives of every round."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.analysis import collective_stats
    from repro_torch.utils.pytree import tree_map
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-store-")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    torch.backends.cudnn.deterministic = True
    try:
        check(dist.get_backend() == "nccl", f"shard_map: backend {dist.get_backend()}")
        task = resnet_task(seed, "resnet20")
        init = fed.make_runner("fedsdd", task, device=DEV, seed=seed,
                               **RESNET56_RUN).init_state().global_models
        runs = {}
        for sharding in ("vmap", "shard_map"):
            gc.collect()
            runner = fed.make_runner("fedsdd", task, device=DEV, seed=seed,
                                     execution="vectorized", client_sharding=sharding,
                                     **RESNET56_RUN)
            eng = runner._make_engine()
            check(eng._use_shard_map() == (sharding == "shard_map")
                  and runner._kd_pipeline()._shard_teachers() == (sharding == "shard_map")
                  and eng.mesh.size == 1 and eng.mesh.group is not None,
                  f"shard_map: the {sharding} runner's mesh {eng.mesh}")
            state = fed.FedState(round=0, global_models=[tree_map(torch.clone, m) for m in init],
                                 ensemble=fed.TeacherBank(4, 2))
            torch.cuda.synchronize()
            kernels.launches.clear()
            rounds = []
            with card_launches() as ran:
                for i in range(SHARD_ROUNDS):
                    with collective_stats() as coll:
                        if i == 0:
                            state = runner.run_round(state)
                        else:
                            with contracts(f"ResNet-20 round 2, vectorized {sharding}",
                                           run_owners(runner),
                                           (*KD_PATH, "multi_weighted_average")) as held:
                                state = runner.run_round(state)
                    rec = state.history[-1]
                    rounds.append({"round": rec["round"], "t_local_s": rec["t_local"],
                                   "t_kd_s": rec["t_kd"], "kd_loss_last": rec["kd_loss_last"],
                                   "collective_count": dict(coll.count_by_kind),
                                   "collective_bytes": dict(coll.bytes_by_kind)})
            contracts_line(held, card)
            runs[sharding] = {"state": state, "rounds": rounds, "launches": dict(ran),
                              "wrapper_launches": dict(kernels.launches)}
            del runner, eng
        for sharding, r in runs.items():
            for rd in r["rounds"]:
                print(json.dumps({"phase": f"collectives: ResNet-20 round {rd['round']}, "
                                           f"vectorized {sharding}", "card": card,
                                  "backend": "nccl", "ranks": 1,
                                  "count": rd["collective_count"],
                                  "bytes": rd["collective_bytes"]}), flush=True)
        a, b = runs["vmap"]["state"], runs["shard_map"]["state"]
        rest_same = all(torch.equal(x, y) for k in range(1, 4) for x, y in
                        zip(_leaves(a.global_models[k]), _leaves(b.global_models[k])))
        main_err = _tree_err(a.global_models[0], b.global_models[0])
        print(json.dumps({"phase": "ResNet-20 FedSDD, vectorized: shard_map (one NCCL rank) "
                                   "vs vmap", "card": card, "main_max_abs_err": main_err,
                          "tol": ROUND_TOL, "models_k>0_bit_identical": rest_same,
                          **{f"{k}_rounds": [{x: rd[x] for x in ("round", "t_local_s", "t_kd_s",
                                                                  "kd_loss_last")}
                                             for rd in r["rounds"]]
                             for k, r in runs.items()},
                          "launches": {k: r["launches"] for k, r in runs.items()},
                          "wrapper_launches": {k: r["wrapper_launches"]
                                               for k, r in runs.items()}}), flush=True)
        steps_kd = RESNET56_RUN["distill_steps"]
        want = {"ensemble_softmax": SHARD_ROUNDS, "kd_loss_fwd": SHARD_ROUNDS * steps_kd,
                "kd_loss_bwd": SHARD_ROUNDS * steps_kd, "multi_weighted_average": SHARD_ROUNDS}
        check(rest_same, "shard_map: models k>0 differ from vmap's")
        check(all(torch.allclose(x, y, rtol=ROUND_TOL, atol=ROUND_TOL) for x, y in
                  zip(_leaves(a.global_models[0]), _leaves(b.global_models[0]))),
              f"shard_map: the main model is {main_err} from vmap's, beyond 2e-4")
        check(all(r["launches"] == want and all(r["wrapper_launches"].get(k) for k in want)
                  for r in runs.values()),
              f"shard_map: launches {[r['launches'] for r in runs.values()]}, want {want}")
        check(all(not rd["collective_count"] for rd in runs["vmap"]["rounds"]),
              "shard_map: the vmap run issued a collective")
        check(all(rd["collective_count"].get("all-reduce") == 1
                  and rd["collective_bytes"].get("all-reduce") == TEACHER_ALL_REDUCE_BYTES
                  and rd["collective_count"].get("all-gather", 0) >= 1
                  for rd in runs["shard_map"]["rounds"]),
              f"shard_map: collectives {[rd['collective_bytes'] for rd in runs['shard_map']['rounds']]}")
        check(all(bool(x.isfinite().all()) for m in b.global_models for x in _leaves(m)),
              "shard_map: non-finite weights")
        return {k: r["launches"] for k, r in runs.items()}
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()


# ---------------------------------------------------------------- phase 36
GEMMA_ROUND = dict(K=2, N=2, client_rows=1, server_rows=4, seq=512, teachers=4)
# reckoned before the run (PERF.md §6): the round's client step holds the two
# globals, four clients' gradients and new params (2.98 GB a model) and the
# clients' 512-row logits, their log-softmax and gradient (2.1 GB each);
# the distill step its four teachers, the round's outputs and the 2,048-row
# logits of four teachers, the probabilities and the student's
GEMMA_ROUND_PEAK_GB = (30.0, 56.0)
# kernels vs plain on a step's update (new - old): its disagreement beyond
# one ulp of the new parameter (the f32 subtraction's own rounding, half an
# ulp in each run), over the update's largest value; phase 6's f32 row
# tolerance of kernels 2-4, which the backward carries through linearly
UPDATE_TOL = KD_F32_ROW_TOL
# the gap_rel that a step leaving the parameters as they were would show
# must stand this far above the tolerance, so that the check could fail
UPDATE_MIN_MISSING = 100 * UPDATE_TOL


def _update_gap(new_k, new_p, old) -> dict:
    """A step's update, kernels against plain, over the leaves: ``gap_rel``
    the largest |Δ_k - Δ_p| beyond one ulp of the larger new value, over
    ``size``, the largest |Δ_p|; ``missing_rel`` the largest |Δ_p| beyond
    that ulp, over ``size``: the gap_rel of a step that moved nothing."""
    gap = size = miss = 0.0
    for a, b, o in zip(_leaves(new_k), _leaves(new_p), _leaves(old)):
        a, b, o = a.float(), b.float(), o.float()
        top = torch.maximum(a.abs(), b.abs())
        ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
        d = (b - o).abs()
        size = max(size, float(d.max()))
        miss = max(miss, float((d - ulp).clamp_min(0).max()))
        gap = max(gap, float(((a - b).abs() - ulp).clamp_min(0).max()))
        del a, b, o, top, ulp, d
    inf = float("inf")
    return {"gap_rel": gap / size if size else inf, "size": size,
            "missing_rel": miss / size if size else 0.0}


def _member_logits(logits_fn, stacked, server) -> torch.Tensor:
    """(M, rows, V) f32 logits of a stacked model tree on the server batch,
    one member at a time (the tensors kernel 2 takes on the path)."""
    from repro_torch.utils.pytree import tree_map
    M = _leaves(stacked)[0].shape[0]
    out = None
    with torch.no_grad():
        for m in range(M):
            lg = logits_fn(tree_map(lambda x: x[m], stacked), server)
            lg = lg.reshape(-1, lg.shape[-1])
            if out is None:
                out = torch.empty((M,) + tuple(lg.shape), dtype=lg.dtype, device=lg.device)
            out[m] = lg
            del lg
    return out


def gemma_round_fn_phase(kd_ops, kd_ref, seed: int, card: str) -> dict:
    """core/distributed.py at gemma-2b's full width, 2 of 18 layers, f32:
    make_fedsdd_round_fn (K=2 groups of N=2 clients, a 1 x 512-token batch
    a client, one local step; the server batch 4 x 512: kernels 2/3/4 over
    2,048 rows x V 256,000), then make_distill_step_fn over M = 4 teachers,
    each with the kernels and with the three wrappers patched to their
    plain versions, deterministic algorithms on (the embedding's backward
    accumulates with atomics unless asked not to); each timed call warm."""
    import dataclasses
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import make_distill_step_fn, make_fedsdd_round_fn
    from repro_torch.data.synthetic import make_model_batch
    from repro_torch.device import to_device
    from repro_torch.models.model_zoo import build_model
    from repro_torch.utils.pytree import tree_map
    g = GEMMA_ROUND
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg)
    K, N, S = g["K"], g["N"], g["seq"]
    stacked = tree_map(lambda *xs: torch.stack(xs),
                       *[model.init(seed + k, device=DEV) for k in range(K)])
    n_params = sum(x[0].numel() for x in _leaves(stacked))
    docs = make_model_batch(cfg, K * N * g["client_rows"], S, seed=seed)
    client_batches = {k: to_device(v.reshape((K, N, g["client_rows"], S)), torch.device(DEV))
                      for k, v in docs.items() if k in ("tokens", "labels")}
    server = {"tokens": to_device(make_model_batch(cfg, g["server_rows"], S,
                                                   seed=seed + 1)["tokens"], torch.device(DEV))}
    weights = torch.tensor([[3.0, 1.0], [2.0, 2.0]], device=DEV)
    V, rows = cfg.vocab_size, g["server_rows"] * S
    print(json.dumps({"phase": "gemma-2b round fn: the peak reckoned before the run",
                      "parameters": n_params, "model_gb": n_params * 4 / 1e9,
                      "peak_reckoned_gb": GEMMA_ROUND_PEAK_GB, "kd_rows": rows, "V": V,
                      "logits_gb_a_teacher": rows * V * 4 / 1e9}), flush=True)
    round_fn = make_fedsdd_round_fn(lambda p, b: model.loss(p, b)[0],
                                    lambda p, b: model.logits(p, b)[0], client_lr=0.01,
                                    server_lr=0.01, temperature=4.0, local_steps=1)
    distill_fn = make_distill_step_fn(lambda p, b: model.logits(p, b)[0], server_lr=0.01,
                                      temperature=4.0)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        # a warm-up call of each (cuBLAS handles, the kernels' first launches)
        distill_fn(tree_map(lambda x: x[0], stacked), round_fn(stacked, client_batches, weights,
                                                                server), server)
        for mode in ("kernels", "plain"):
            for name in ("round", "distill"):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                kernels.launches.clear()
                if name == "round":
                    args = (stacked, client_batches, weights, server)
                    fn = round_fn
                else:   # M = 4 teachers: the round's two outputs and its two inputs
                    teachers = tree_map(lambda a, b: torch.cat([a, b]), out["kernels", "round"][0],
                                        stacked)
                    args = (tree_map(lambda x: x[0], stacked), teachers, server)
                    fn = distill_fn
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                with plain_kd(kd_ops, kd_ref) if mode == "plain" else nullcontext(), \
                        card_launches() as ran:
                    start.record()
                    res = fn(*args)
                    end.record()
                    torch.cuda.synchronize()
                out[mode, name] = (res, dict(ran), dict(kernels.launches),
                                   start.elapsed_time(end),
                                   torch.cuda.max_memory_allocated() / 1e9, base / 1e9)
                del args, fn
                if name == "distill":
                    del teachers
    finally:
        torch.use_deterministic_algorithms(False)
    rnd_k, rnd_p = out["kernels", "round"][0], out["plain", "round"][0]
    dst_k, dst_p = out["kernels", "distill"][0], out["plain", "distill"][0]
    rest_same = all(torch.equal(x[1:], y[1:]) for x, y in zip(_leaves(rnd_k), _leaves(rnd_p)))
    main_err = max(float((x[0] - y[0]).abs().max()) for x, y in
                   zip(_leaves(rnd_k), _leaves(rnd_p)))
    distill_err = _tree_err(dst_k, dst_p)
    moved = max(float((x[0] - y[0]).abs().max()) for x, y in zip(_leaves(rnd_k), _leaves(stacked)))
    student = tree_map(lambda x: x[0], stacked)
    upd = {"round": _update_gap(tree_map(lambda x: x[0], rnd_k),
                                tree_map(lambda x: x[0], rnd_p), student),
           "distill": _update_gap(dst_k, dst_p, student)}
    line = {"phase": "gemma-2b full width, 2 layers, f32: core/distributed.py, kernels vs plain",
            "card": card, "tol": ROUND_TOL, "round_main_max_abs_err": main_err,
            "round_models_k>0_bit_identical": rest_same, "round_main_moved": moved,
            "distill_max_abs_err": distill_err, "update_tol": UPDATE_TOL,
            "update_min_missing": UPDATE_MIN_MISSING, "round_main_update": upd["round"],
            "distill_update": upd["distill"]}
    for (mode, name), (_, ran, host, ms, peak, base) in out.items():
        line[f"{name} {mode}"] = {"ms": ms, "peak_gb": peak, "held_before_gb": base,
                                  "launches": ran, "wrapper_launches": host}
    print(json.dumps(line), flush=True)
    check(rest_same, "gemma round fn: models k>0 differ between the kernel and plain runs")
    check(all(torch.allclose(x[0], y[0], rtol=ROUND_TOL, atol=ROUND_TOL)
              for x, y in zip(_leaves(rnd_k), _leaves(rnd_p))),
          f"gemma round fn: the main model, kernels vs plain, {main_err} beyond 2e-4")
    check(all(torch.allclose(x, y, rtol=ROUND_TOL, atol=ROUND_TOL)
              for x, y in zip(_leaves(dst_k), _leaves(dst_p))),
          f"gemma distill step: kernels vs plain, {distill_err} beyond 2e-4")
    one_each = {"ensemble_softmax": 1, "kd_loss_fwd": 1, "kd_loss_bwd": 1}
    for (mode, name), (res, ran, host, _, peak, _) in out.items():
        if mode == "kernels":
            check(ran == one_each and all(host.get(k) for k in one_each),
                  f"gemma {name}: launches {ran} on the card, {host} by the wrappers")
        else:
            check(not ran and not any(host.values()), f"gemma {name} plain launched {ran}")
        check(peak < PEAK_LIMIT_GB, f"gemma {name} {mode}: peak {peak:.1f} GB")
        check(all(bool(x.isfinite().all()) for x in _leaves(res)),
              f"gemma {name} {mode}: non-finite weights")
    check(moved > 0, "gemma round fn: the round left the main model as it was")
    for name, u in upd.items():
        check(u["missing_rel"] >= UPDATE_MIN_MISSING and u["gap_rel"] <= UPDATE_TOL,
              f"gemma {name}: the update, kernels vs plain, {u} (tol {UPDATE_TOL}; a step "
              f"that moved nothing must show at least {UPDATE_MIN_MISSING})")
    # kernels 2/3/4 on the path's own tensors: the round's M = 2 and the
    # distill step's M = 4 teachers' logits over the 2,048 server rows, the
    # student's logits and dL/dloss = 1 (launches outside the counted runs)
    teacher_stacks = {"round fn, M = 2": rnd_k,
                      "distill step, M = 4": tree_map(lambda a, b: torch.cat([a, b]), rnd_k,
                                                      stacked)}
    runs = {name: out["kernels", name][1] for name in ("round", "distill")}
    del out, rnd_p, dst_k, dst_p
    gc.collect()
    logits_fn = lambda p, b: model.logits(p, b)[0]  # noqa: E731
    s_logits = _member_logits(logits_fn, tree_map(lambda x: x[:1], stacked), server)[0]
    one = torch.tensor(1.0, device=DEV)
    for label, stack in teacher_stacks.items():
        x = _member_logits(logits_fn, stack, server)
        t = kd_ref.ensemble_softmax_ref(x, 4.0)
        kd_check(kd_ops, kd_ref, f"gemma-2b {label}, the path's tensors", x, s_logits, t,
                 one, 4.0, False)
        del x, t
    del teacher_stacks, s_logits
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 37
DRYRUN_TIMEOUT_S = 300           # (a): the whole gemma-2b train_4k dry run on the CPU
DRYRUN_BATCH = (2, 4096)         # (b): the counted and measured step's (rows, tokens)
DRYRUN_REPS = 3


def dryrun_phase(seed: int, card: str) -> dict:
    """launch/dryrun.py on the card's machine (its torch), and its count of
    one train step held against the card.

    (b) In this process, on a one-rank (1, 1) fake world (destroyed before
    (a)): gemma-2b at full width, 2 layers, f32, the train step of
    launch/steps.py (remat=True) at 2 x 4,096 tokens, counted; then the
    same step on the card from random weights: warm CUDA-event ms against
    the count's bound (utils/hlo.roofline over H100Spec, f32 on the CUDA
    cores: TF32 is off), and max_memory_allocated over the step against
    the counted peak.  On a one-rank world the model takes the DTensor
    branches of sharding/local.py (the cross-entropy as max, exp-sum and
    gather), the card its plain ops.
    (a) python -m repro_torch.launch.dryrun --arch gemma-2b --shape
    train_4k in a subprocess with no card visible, to a temporary --out:
    the pod1 record's FLOPs, bytes, collective bytes and peak a rank."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_model_batch
    from repro_torch.device import to_device
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.model_zoo import build_model
    from repro_torch.utils.hlo import roofline
    check(not torch.distributed.is_initialized(), "a process group is live before the dry run")
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    rows, seq = DRYRUN_BATCH
    t0 = time.perf_counter()
    rec = dryrun.lower_one("gemma-2b", "train_4k", cfg_override=lambda c: cfg,
                           mesh_shape={"data": 1, "model": 1},
                           shape_override=InputShape("train_4k", seq, rows, "train"))
    count_s = time.perf_counter() - t0
    check(not torch.distributed.is_initialized(), "the fake world outlived its count")
    mem = rec["memory_analysis"]
    terms = roofline(rec["flops_per_chip"], rec["hbm_bytes_per_chip"], 0.0, 1, spec=SPEC,
                     dtype="float32")
    model = build_model(cfg)
    params = model.init(seed, device=DEV)
    batch = {k: to_device(v, torch.device(DEV))
             for k, v in make_model_batch(cfg, rows, seq, seed=seed).items()}
    step = steps.make_train_step(model)
    loss, new = step(params, batch)
    del new
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DRYRUN_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, new = step(params, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        check(bool(torch.isfinite(loss)) and all(bool(x.isfinite().all()) for x in _leaves(new)),
              "dry run (b): the card's train step gave non-finite values")
        del new
    peak = torch.cuda.max_memory_allocated()
    measured = statistics.median(ms)
    b = {"phase": "dry run (b): gemma-2b 2 layers f32, train step at 2 x 4,096 tokens, "
                  "counted on a (1, 1) fake world vs the card",
         "counted": {"flops": rec["flops_per_chip"], "hbm_bytes": rec["hbm_bytes_per_chip"],
                     "peak_gb": mem["peak_size_in_bytes"] / 1e9,
                     "argument_gb": mem["argument_size_in_bytes"] / 1e9, "seconds": count_s},
         "bound_ms": terms.bound_s * 1e3,
         "bound_by": "operations" if terms.compute_s >= terms.memory_s else "bytes",
         "measured_ms": measured, "measured_ms_each": ms,
         "bound_share": terms.bound_s * 1e3 / measured,
         "card_peak_gb": peak / 1e9, "card_held_before_gb": base / 1e9,
         "loss": float(loss), "card": card}
    print(json.dumps(b), flush=True)
    del params, batch, step, model, loss
    gc.collect()
    torch.cuda.empty_cache()
    src = str(Path(__file__).resolve().parent / "src")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b",
             "--shape", "train_4k", "--out", out],
            env={**os.environ, "PYTHONPATH": src, "CUDA_VISIBLE_DEVICES": ""},
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"dry run (a) exited {run.returncode}: {run.stderr[-3000:]}")
        with open(Path(out) / "gemma-2b__train_4k__pod1.json") as f:
            full = json.load(f)
    check(full["supported"] and full["chips"] == 256 and full["flops_per_chip"] > 0
          and full["counted"] == "plain ops", f"dry run (a): record {full}")
    a = {"phase": "dry run (a): python -m repro_torch.launch.dryrun --arch gemma-2b "
                  "--shape train_4k (pod1, 256 fake ranks, on the CPU)",
         "torch": torch.__version__, "seconds": wall,
         "flops_per_chip": full["flops_per_chip"],
         "hbm_bytes_per_chip": full["hbm_bytes_per_chip"],
         "collective_bytes_per_chip": full["collective_bytes_per_chip"],
         "collectives": full["collectives"],
         "peak_gb_per_chip": full["memory_analysis"]["peak_size_in_bytes"] / 1e9,
         "terms_s": [full["compute_s"], full["memory_s"], full["collective_s"]],
         "dominant": full["dominant"], "useful_flops_ratio": full["useful_flops_ratio"]}
    print(json.dumps(a), flush=True)
    return {"a": a, "b": b}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    # cuBLAS repeats its sums bit for bit under phase 13's deterministic
    # algorithms only with a fixed workspace; set before the first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    use_h100_spec()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch import serve
    from repro_torch.core import fedsdd as fed
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.kd_loss import ref as kd_ref
    from repro_torch.kernels.weight_avg import ops as wa_ops
    from repro_torch.kernels.weight_avg import ref as wa_ref

    phase("1. card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    secs = build.build_all()
    for name, s in secs.items():
        print(f"built {name} in {s:.1f} s", flush=True)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("  " + line.strip(), flush=True)
    sass_phase(build)

    phase("3. paged_decode vs plain")
    paged_rows = kernel_phase(ops, args.seed)

    phase("4. qwen2.5-14b full width, f32, 2 layers: engine == static")
    f32_depth2_phase(serve, zoo, get_config, args.seed)

    phase("5. qwen2.5-14b full width, bf16, 48 layers: serve 16 requests")
    planted_contracts(card)
    entry = serve_phase(serve, zoo, ops, get_config, args.seed, card)
    # kernel 1 at the starcoder2-3b cases its split-K was designed for
    entry["starcoder2_ms"] = {case: paged_rows[case]["ms"] for case in STARCODER_TIMED}

    torch.cuda.empty_cache()

    phase("6. KD kernels vs plain")
    kd6 = kd_phase(kd_ops, kd_ref, args.seed)

    phase("7. f32 ResNet-20 FedSDD round: kernels vs plain")
    f32_round_phase(fed, kd_ops, kd_ref, args.seed)

    phase("8. ResNet-56 FedSDD, K=4 R=2, 2 rounds at full depth and width")
    kd_entries, seq_rounds = resnet56_phase(fed, kd_ops, kd_ref, args.seed, card, kd6)

    phase("9. weight_avg (kernels 5 and 6) vs plain")
    single = weight_avg_phase(wa_ops, wa_ref, args.seed)

    phase("10. f32 CNN FedSDD round: vectorized vs sequential engine")
    vectorized_cnn_phase(fed, args.seed)

    phase("11. ResNet-56 FedSDD, K=4 R=2, 2 rounds on the vectorized engine")
    wa_entry, vec_launches = resnet56_vectorized_phase(fed, wa_ops, wa_ref, args.seed, card,
                                                       seq_rounds)
    single_entry = {"name": "weighted_average", "route": "cuda", "source": WA_SOURCE,
                    "replaces": WA_TPU["weighted_average"],
                    "launches": vec_launches.get("weighted_average", 0),
                    "max_abs_err": single["max_abs_err"], "ms": single["ms"],
                    "host_ms": single["host_ms"],
                    "plain_ms": single["plain_ms"], "bound_ms": single["bound_ms"],
                    "bound_by": single["bound_by"], "library_ms": single["library_ms"]}

    phase("12. Flash-KD kernels (7-10) vs plain")
    from repro_torch.kernels.kd_loss import flash
    flash_rows = flash_phase(kd_ops, flash, args.seed)

    phase("13. f32 LM FedSDD rounds (gemma-2b reduced, V = 50,304): kernels vs plain")
    unfused_launches = lm_round_phase(fed, kd_ops, flash, args.seed)

    phase("14. gemma-2b full width, FedSDD with head-fused Flash-KD")
    fused_launches = gemma_phase(fed, args.seed, card)
    path_launches = {**unfused_launches, **fused_launches}
    deepseek_rows = flash_rows.pop("deepseek")
    frontend_rows = {key: flash_rows.pop(key) for key, *_ in FRONTEND_HEADS}
    flash_entries = [{"name": name, "route": "cuda", "source": FLASH_SOURCE,
                      "replaces": FLASH_TPU[name], "launches": path_launches.get(name, 0),
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"], "host_ms": r["host_ms"],
                      "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]} for name, r in flash_rows.items()]
    for e in flash_entries:     # kernels 9 and 10 at deepseek-v2-lite-16b's head
        if e["name"] in deepseek_rows:
            r = deepseek_rows[e["name"]]
            e["deepseek"] = {k: r[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}
    check(all(e["launches"] > 0 for e in flash_entries),
          f"a Flash-KD kernel did not run on its path: {path_launches}")

    phase("15. flash attention kernels (11-12) vs plain")
    fa_launches, fwd_row, dec_row = flash_attention_phase(ops, args.seed)
    fa_entries = [{"name": name, "route": "cuda", "source": FA_SOURCE, "replaces": FA_TPU[name],
                   "launches": fa_launches[name], "max_abs_err": r["max_abs_err"],
                   "ms": r["ms"], "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "case": r["case"],
                   **({"f32": r["f32"]} if "f32" in r else {})}
                  for name, r in (("flash_forward", fwd_row), ("flash_decode", dec_row))]

    phase("16. starcoder2-3b full width, f32, 2 layers: engine == static, long prompt")
    starcoder_f32_phase(serve, zoo, ops, get_config, args.seed)

    phase("17. starcoder2-3b full width, bf16, 30 layers: serve 8 requests")
    starcoder_serve_phase(serve, zoo, get_config, args.seed, card)

    phase("18. FedSDD, overlapped rounds: off, async (both engines), fused; ResNet-56 "
          "sequential, ResNet-20 vectorized")
    r56 = resnet_task(args.seed)
    runner3, state3 = overlap_phase(fed, r56, args.seed, card)

    phase("19. ResNet-56 FedSDD round: legacy KD oracle vs fused; Table 5 ensemble accuracy")
    legacy_phase(fed, r56, args.seed, card, runner3, state3)
    del runner3, state3

    phase("20. robustness: faults, robust Eq. 2, trust-weighted teachers, kill and restart")
    robust_phase(fed, kd_ops, kd_ref, r56, args.seed, card)

    phase("21. FedBE and secure aggregation on ResNet-56, one round each")
    fedbe_secure_phase(fed, r56, args.seed, card)
    del r56

    phase("22. deepseek-v2-lite-16b full width, f32, 2 layers: static == forward argmax")
    deepseek_f32_phase(zoo, get_config, serve, args.seed)

    phase("23. deepseek-v2-lite-16b full width, bf16, 27 layers: static serve")
    deepseek_serve_phase(zoo, get_config, serve, args.seed, card)

    phase("24. deepseek-v2-lite-16b full width, 2 layers, FedSDD with head-fused Flash-KD")
    head_fused_rounds_phase(fed, kd_ops, flash, args.seed)
    ds = deepseek_fedsdd_phase(fed, wa_ops, wa_ref, args.seed, card)
    wa_entry["deepseek"] = {k: ds["kernel_5_moe_tree"][k]
                            for k in ("case", "leaves", "shape", "max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
    wa_entry["deepseek"]["launches"] = ds["vectorized"]["launches"]["multi_weighted_average"]

    phase("25. xlstm-1.3b full width, f32, 8 layers: decode == forward")
    xlstm_f32_phase(zoo, get_config, serve, args.seed, card)

    phase("26. xlstm-1.3b as configured, bf16, 48 layers: static serve")
    xlstm_serve_phase(zoo, get_config, serve, args.seed, card)

    phase("27. xlstm-1.3b FedSDD: reduced kernels vs plain, full width rounds, kernel 5, head")
    xlstm_rounds = head_fused_rounds_phase(fed, kd_ops, flash, args.seed, XLSTM)
    xl = xlstm_fedsdd_phase(fed, wa_ops, wa_ref, kd_ops, flash, args.seed, card)
    wa_entry["xlstm"] = {k: xl["kernel_5_xlstm_tree"][k]
                         for k in ("case", "leaves", "shape", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
    wa_entry["xlstm"]["launches"] = xl["vectorized"]["launches"]["multi_weighted_average"]
    for e in flash_entries:     # kernels 9 and 10 at xlstm-1.3b's head and on its rounds
        if e["name"] in xl["head"]:
            r = xl["head"][e["name"]]
            e["xlstm"] = {k: r[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")}
            e["xlstm"]["launches"] = sum(rd["launches"].get(e["name"], 0)
                                         for rd in xl["sequential"])
            e["xlstm"]["reduced_launches"] = xlstm_rounds.get(e["name"], 0)

    phase("28. jamba-1.5-large-398b full width, f32, 2 layers: decode == forward")
    jamba_f32_phase(zoo, get_config, serve, args.seed, card)

    phase("29. jamba-1.5-large-398b full width, bf16, 4 layers: static serve")
    jamba_serve_phase(zoo, get_config, serve, args.seed, card)

    phase("30. jamba-1.5-large-398b reduced, f32: head-fused rounds, kernels vs plain")
    head_fused_rounds_phase(fed, kd_ops, flash, args.seed, JAMBA)

    phase("31. llama4-maverick full width, f32, 2 layers, 32 experts: decode == forward, "
          "engine == static")
    llama4_f32_phase(zoo, get_config, serve, args.seed, card)

    phase("32. llama4-maverick full width, bf16, 2 layers, 128 experts: serve 9 requests")
    l4 = llama4_serve_phase(zoo, get_config, serve, args.seed, card)

    phase("33. llava-next-mistral-7b as configured, bf16, 32 layers: serve 16 requests")
    lv = llava_serve_phase(zoo, get_config, serve, args.seed, card)
    for key, line in (("llama4", l4), ("llava", lv)):     # kernel 1 at their shapes and paths
        r = paged_rows[PAGED_TIMED_NEW[key]]
        entry[key] = {k: r[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
        entry[key]["launches"] = line["paged_decode_launches"]

    phase("34. llama4-maverick, hubert-xlarge and llava FedSDD: reduced kernels vs plain, "
          "full-size rounds, kernel 5")
    fr = frontends_fedsdd_phase(fed, wa_ops, wa_ref, kd_ops, flash, args.seed, card)
    hub = fr["hubert"]
    wa_entry["hubert"] = {k: hub["kernel_5_hubert_tree"][k]
                          for k in ("case", "leaves", "shape", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}
    wa_entry["hubert"]["launches"] = hub["vectorized"]["launches"]["multi_weighted_average"]
    # launches on each model's largest round: llama4 has only its reduced one
    round_launches = {"hubert": hub["sequential"], "llava": fr["llava"]["sequential"]}
    reduced = dict(zip(("llama4", "hubert", "llava"), fr["reduced"].values()))
    for e in flash_entries:     # kernels 9 and 10 at the three heads and on their rounds
        if e["name"] not in frontend_rows["llama4"]:
            continue
        for key, rows in frontend_rows.items():
            r = rows[e["name"]]
            e[key] = {k: r[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
            e[key]["reduced_launches"] = reduced[key].get(e["name"], 0)
            e[key]["launches"] = (sum(rd["launches"].get(e["name"], 0)
                                      for rd in round_launches[key])
                                  if key in round_launches else e[key]["reduced_launches"])

    phase("35. shard_map on one card: the client axis over a one-rank NCCL group")
    sharded = shard_map_phase(fed, args.seed, card)["shard_map"]
    wa_entry["shard_map_launches"] = sharded.get("multi_weighted_average", 0)

    phase("36. gemma-2b full width, 2 layers, f32: core/distributed.py's round and distill "
          "step")
    round_fn = gemma_round_fn_phase(kd_ops, kd_ref, args.seed, card)
    for e in kd_entries:        # kernels 2-4 on the two new paths
        e["shard_map_launches"] = sharded.get(e["name"], 0)
        e["round_fn_launches"] = round_fn["round"].get(e["name"], 0)
        e["distill_step_launches"] = round_fn["distill"].get(e["name"], 0)

    phase("37. the dry run: launch/dryrun.py on this machine's torch; its count of a "
          "gemma-2b train step vs the card")
    dryrun_phase(args.seed, card)

    phase("38. kernels")
    print(f"total {time.perf_counter() - T_START:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry, *kd_entries, wa_entry, single_entry,
                                  *flash_entries, *fa_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
