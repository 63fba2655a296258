#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each; any failure raises and the exit code is not
0. Without a CUDA device, or without the repository around it, the
script fails before it prints a result.

1. device     the card, torch and CUDA versions, the TF32 switches (both
              off: they stay off for ``torch.matmul`` and cuDNN, while K3
              runs 3xTF32 inside its own code), nvidia-smi's name and
              power limit (also printed as its own line before the last).
2. build      one nvcc per kernel source in ``src/repro_torch/csrc``,
              all started together: K1 ``warehouse_agg.cu``, K2
              ``frame_preproc.cu``, K3 ``flash_attention.cu`` (float32),
              ``flash_attention_bf16.cu`` (bfloat16) and its
              backward ``flash_attention_bwd.cu``, K4 ``ssd_scan.cu`` and
              its backward ``ssd_scan_bwd.cu`` (K3 and K4 include the
              shared ``hopper.cuh``).
3. kernel     K1 against its plain version on the same CUDA tensors over
              the test matrix at 1M rows (shared- and global-memory
              accumulators), and against a float64 host oracle; then
              the vector path's edges: column views whose base is not
              16-byte aligned, the standing fold's delta blocks [lo:lo+n]
              (lo % 4 of 1 to 3, n of 0, 1, 3 and 4,093), 1, 3, 5 and
              4k+3 rows, warps whose rows fall in 32 groups or in one, max
              and min over +-0 and +-inf in both modes.
4. kernel_k2  K2 against its plain version: factors 2, 3 and 4, 3-D and
              4-D frames, float32 and bfloat16, a strided frame axis,
              and the Transform's (30, 720, 1280, 3) segment.
5. kernel_k3  K3 against its plain version within
              ``kernels.flash_attention.error_bound``: causal and not,
              windows 32 to 256, G < H, ragged Sq and Skv, head dims 8
              to 128 (a D = 128 ragged window), hymba-1.5b's prefill
              (B=4, S=2048, 25 heads over 5 kv heads, D=64) with its
              window of 1,024 and causal, and a stress case with |q|, |k|
              up to 8; then bfloat16 q, k, v through the bfloat16
              kernel (``K3_BF16_CASES``: the serve prefills,
              qwen1.5-110b's local one at (1, 4), GQA, a window, D = 128
              with a ragged Skv over B > 1, D = 8 and 12, bases off 16
              bytes, one query against 1,500 keys, the log-sum-exp held
              to ``lse_error_bound``), the output in bfloat16 against
              the plain version on the widened inputs, each case's
              ``of_bound`` and launch shape printed; mixtral-8x7b's
              prefill (B=4, S=2048, 32 heads over 8 kv heads, D=128,
              window 4,096) in both dtypes.
5a. kernel_k3_bwd  K3's backward (``csrc/flash_attention_bwd.cu``)
              against its plain version ``flash_attention_bwd_ref`` run in
              float64 on the same CUDA tensors and the forward's own o
              and log-sum-exp, within ``bwd_error_bound``, float32 and
              bfloat16: qwen1.5-0.5b's training shape (B=4, S=2,048,
              H=G=16, D=64, causal), hymba-1.5b's (25 heads over 5, a
              window of 1,024, and global), mixtral-8x7b's (32 over 8,
              D=128, window 4,096), whisper-large-v3's encoder (1,500 x
              1,500) and cross attention (440 x 1,500), not causal, rows
              that see no key, and ``_k3_cases``' uneven shapes; the
              forward's log-sum-exp within ``lse_error_bound`` of the
              float64 plain one (+inf exactly where a row sees no key);
              each case launched twice, the same bits both times; one
              finite-difference check of the float32 gradient.
5b. kernel_k4 K4 (five passes) against its plain version run in
              float64 within ``kernels.ssd.error_bound``, and each pass
              against its own plain version within the bound
              ``kernels.ssd.pass_errors`` states for it: G = 1 and
              G > 1, S past and short of a multiple of the chunk, S below
              the chunk, chunks 8 to 256, P 8 to 64, N 16 and 128, with
              and without ``init_state``, and the mamba2-370m serve
              prefill (B=4, S=2048, H=32, P=64, G=1, N=128, Q=256) and
              hymba-1.5b's (B=4, S=2048, H=25, P=64, G=1, N=16, Q=256); y and
              the final state, the largest error printed as a share of
              its bound. Inputs drawn as the model draws them:
              dt = softplus(dt_bias + z) with dt_bias from the ``dt_bias``
              init range, A = -exp(A_log) from the ``ssm_a`` range. Then
              bfloat16 x, B and C (dt in bfloat16 as the model passes it,
              or float32; a bfloat16 state in): both serve prefills, a
              state in, S % Q != 0, G > 1, Q 16, and P 12, N 20; y in
              bfloat16, the state in float32.
5c. kernel_k4_bwd  K4's backward (``csrc/ssd_scan_bwd.cu``, nine
              passes, 3xTF32 ``wgmma``) on the forward kernels' own
              scratch against its
              plain version ``ssd_scan_bwd_ref`` run in float64 on the
              same CUDA tensors, dx, ddt, dA, dB, dC and d(init_state)
              each within ``bwd_error_bound`` and in its operand's
              dtype: mamba2-370m's training shape (B=4, S=2,048, H=32,
              P=64, G=1, N=128, Q=256) and hymba-1.5b's (B=1, H=25,
              N=16), S % Q != 0, S < Q, G > 1, R = 25 heads a group, Q 8
              to 256, P 8 to 64, N 16 to 128, with and without a state
              in and a d(final state); then bfloat16 x, B, C and dy (dt
              in bfloat16 or float32, a bfloat16 state in); each case
              launched twice, the same bits both times; one
              finite-difference check of the float32 gradient through
              ``ssd_scan`` as a model takes it.
6. main       the single-stream main path at full size, with the launch
              counts set to 0 just before it and read just after:
              ``fit(COVID, n_cores=8, days_unlabeled=2.0)``, a 1-day
              fused run (43,200 segments) into a ``SegmentStore``, the
              store filled to 256 camera-days (11,059,200 rows), and the
              README plans plus a window x category ``MultiGroupBy`` on
              ``out`` and a camera x window one (73,728 groups, global
              accumulators). Every aggregating query must have taken the
              kernel, in both accumulator modes. A ``StandingQueries``
              registry is attached before camera 0's run, with the five
              plans and one subscription (a camera's cloud spend at 90%
              of its budget) registered, so that camera 0's run and each
              of the fill's 255 ingests fold their rows through K1 (one
              call per query and ingest, counted apart from the
              queries'); after the fill one more plan (on-prem seconds
              per knob configuration) backfills over all 11,059,200
              rows. The fused run carries the flight recorder
              (``telemetry=True``); the store's counters are printed.
7. check      the run against the port's own CPU run (k and c traces
              exact, floats to 1e-5); its seven flight-recorder counters
              and their window snapshots against the CPU run's and
              ``obs.telemetry_ref`` of its own rows, bit for bit; the
              store's counters (rows, ingests, lag, standing queries and
              refreshes); each query's result against the
              engine path's masks, and K1's wrapper against its plain
              version and a float64 host oracle at each query's shape.
7b. standing  every standing answer against ``store.query`` and its
              accumulators against the float64 oracle; the alert mask
              against its predicate; ``answer``'s and ``store.query``'s
              wall milliseconds per plan; the fill of cameras 1..255 timed
              on fresh stores with and without a registry, in turns
              (bare, registry, registry, bare), and the fold's cost per
              ingest.
7c. compare   the paper's comparisons on the main fit and camera 0's
              day, every kernel's count set to 0 just before and read
              just after (no kernel is on this path): the per-window
              loop ``run_skyscraper`` (plan_days 0.25, cloud budget
              15,000 core-s; forecast, LP and window runs on the card),
              Static at ``best_static_config``, VideoStorm-like,
              Chameleon* (host numpy) and ``run_optimum`` (its LP at
              43,200 rows on the card), one line each with quality,
              core-s, buffer peak, overflow and dollars as
              ``benchmarks/cost_quality.py`` reckons them; the loop's
              traces and the optimum's selection against the card
              machine's CPU run, and Skyscraper's buffer and budget.
8. transform  the Transform path, counts set to 0 just before it:
              ``Skyscraper`` + ``BackboneVETL`` (qwen1.5-0.5b at the
              reference's SIZES) through ``fit`` on 40 segments and 60
              ``process`` calls, with the knob domains of
              ``examples/serve_vetl.py``. A segment is 30 frames of
              720x1280x3 float32 (2 s of a 720p camera at 15 fps) and
              (30, 16) tokens, made on the card from a seeded generator.
              K2 and K3 must both launch; ``proc_fn``'s share of the
              process time is printed; the card's qualities are held
              against the same job on the CPU (plain versions).
9. serve      the serving path, counts set to 0 just before it:
              ``Model(get("qwen1.5-0.5b"))`` at the published config in
              float32 answers 2 batches of 4 requests through the port's
              serve loop (prefill of 2,048 tokens, cache 2,056, 8 tokens
              generated per request). Then one batch's logits against
              the same model with K3's plain version on the card. Then
              the model at its default RunOptions (bfloat16 compute): one
              warm prefill, counted and timed, 7 decode steps from its
              cache, the prefill with K3's plain version, and the logits
              against the plain-attention model in bfloat16. Then the
              float8 kv cache (``kv_cache_dtype="float8_e4m3fn"``): one
              warm bfloat16 prefill, K3 counted once per layer, its k and
              v codes against the float8 cast of the bfloat16 cache's on
              this card, bit for bit, and 7 decode steps from each cache
              (the share of equal generated tokens reported, not held).
9b. serve_ssm the same serving path for the SSM family, counts set to 0
              just before it: ``Model(get("mamba2-370m"))`` at the
              published config (48 layers, d_model 1024, d_inner 2048, 32
              heads of 64, d_state 128) in float32, random weights from
              seed 0, through ``serve`` with the same requests. K4 must
              launch once per layer and prefill; then one batch's logits
              against the same model with K4's plain version on the card;
              then the bfloat16 prefill and check as for qwen.
9c. serve_hybrid  the same serving path for the hybrid family, counts
              set to 0 just before it: ``Model(get("hymba-1.5b"))`` at
              the published config (32 layers, d_model 1600, 25 heads
              over 5 kv heads of 64, window 1,024 with layers 0, 15 and
              31 global, an SSM branch of 25 heads of 64 with d_state 16;
              d_ff 5,504, vocab 32,001) in float32, random weights from
              seed 0. K3 and K4 must launch once per layer and prefill,
              K3 with the window in 29 layers of 32; then one batch's
              logits against the same model with both plain versions on
              the card, that prefill's time, and the bfloat16 prefill,
              decode and check as for qwen. Prints the phase's wall
              time, the prompt draw, each prefill and the decode steps,
              and peak memory.
9d. serve_moe the same serving path for the MoE family, counts set to 0
              just before it: ``get("mixtral-8x7b")`` at its published
              width (d_model 4,096, 32 heads over 8 kv heads of 128,
              window 4,096, 8 experts top-2 of d_ff 14,336, vocab
              32,000), its 32 layers cut to 4 (the whole model is 187
              GB in float32), float32, random weights from seed 0. K3
              must launch once per layer and prefill, every launch
              windowed; then one batch's logits against the same model
              with K3's plain version, that model routing every token
              to the experts the kernel model chose (a top-k choice can
              flip on a last-bit change; the free-running difference
              and each layer's share of equal choices are printed), and
              the bfloat16 prefill, decode and check as for qwen.
9e. serve_encdec the same serving path for the encoder-decoder family,
              counts set to 0 just before it: ``get("whisper-large-v3")``
              at its published config, full depth (32 encoder and 32
              decoder layers, d_model 1,280, 20 heads of 64, d_ff 5,120,
              vocab 51,866; 1.6B parameters, 6.4 GB in float32), float32,
              random weights from seed 0; each batch's (4, 1,500, 1,280)
              encoder frames from a generator seeded by its first
              request (the audio frontend is a stub), prompts of 440
              tokens and 8 generated (448 = max_target_len). K3 must
              launch 96 times a prefill (the encoder's self-attention and
              the prefill's cross-attention over the 1,500 frames, not
              causal; the decoder's causal self-attention) and 32 times a
              decode step (one query against the frames), none windowed:
              640 in the loop. Then one batch's logits against the
              plain-attention model, that prefill's time, and the
              bfloat16 prefill, decode and check as for qwen (the logits
              from the weights cast as the prefill casts them).
9f. train     training, counts set to 0 just before the steps and read
              just after: qwen1.5-0.5b at its published config (24
              layers, d_model 1,024, 16 heads of 64, vocab 151,936, tied
              embeddings; 464M parameters) from random weights, through
              the launcher's step (``launch.train.train_options``: remat
              none, float32; AdamW, the clip and the warmup-cosine
              schedule at a peak rate of 1e-2) at batch 4 x 2,048 tokens
              for 8 steps. K3's forward and backward kernels must each
              launch once per layer and step; the loss must be finite and
              fall from the first step to the last. Prints the losses,
              each step's time, the tokens per second (the first step
              apart), the peak device memory. Then the first step's loss
              and per-leaf gradients at full width cut to 4 layers
              against the same step with the attention on its plain
              version (autograd through it), and a reduced config's train
              state saved at step 4 and restored bit for bit, then
              resumed by the launcher to step 6.
9g. train_ssm  the same for the SSM family: mamba2-370m at its
              published config (48 layers, d_model 1,024, d_inner 2,048,
              32 heads of 64, d_state 128, chunk 256, vocab 50,280) from
              random weights, 8 steps at 4 x 2,048 tokens, K4's forward
              and backward kernels once per layer and step; the 4-layer
              gradient check against the plain-SSD model's (autograd
              through ``ssd_scan_ref`` on the card). Prints the losses,
              each step's time, tokens per second and peak memory.
9h. train_hybrid  the same for the hybrid family: hymba-1.5b at its
              published config, full depth (32 layers, window 1,024 with
              layers 0, 15 and 31 global), 8 steps at 1 x 2,048 tokens at
              the launcher's default peak rate of 3e-4 (at 1e-2 the
              loss spikes, on the plain versions too), K3 (windowed in
              29 layers) and K4 both ways once per layer
              and step; the 4-layer gradient check against the model
              with both plain versions.
9i. train_families  one train step each of reduced whisper-large-v3,
              mixtral-8x7b (a window of 32 over 64 tokens, the aux loss),
              internvl2-26b (``embeds``), mamba2-370m and hymba-1.5b on
              the card against the same step on the card machine's CPU,
              each family's kernels launched both ways.
10. time      CUDA-event medians of device time (the card spins while
              the host enqueues each timed call): K1, its plain version
              and one ``index_add_``/``scatter_reduce_`` call per
              main-path query, with kernel_ms / library_ms,
              beside the byte bound at 3.35 TB/s; K2 on (30,720,1280,3)
              at factor 2 beside its byte bound, its plain version and
              ``F.avg_pool2d`` on an NCHW copy; K3 at B=4, S=2048,
              H=G=16, D=64, causal and at the Transform's B=30,
              Sq=Skv=16, H=G=4, D=8, causal beside both operation bounds
              (3xTF32 at the dense TF32 peak, the kernel's; FP32
              CUDA-core peak, a float32 kernel's), its plain version and
              ``F.scaled_dot_product_attention``, and at the serve
              prefill in bfloat16 beside the dense bf16 bound and the
              bfloat16 kernel's own (1.5 times: three bf16 products
              where the function needs two) and its launch shape; K4 at the
              mamba2-370m
              serve prefill beside both operation bounds (3xTF32, its
              arithmetic and its bound; FP32) and its plain version (no
              PyTorch call computes the SSD scan), each of its five
              passes alone and the bytes of its scratch, and in bfloat16
              beside the dense bf16 bound; then K3 at hymba-1.5b's
              prefill with its window and in its global layers (SDPA
              given the same band as a boolean mask, with
              ``enable_gqa``) and K4 at its prefill, in float32 and
              bfloat16, each beside its bounds; then (``time_moe``) K3
              at mixtral-8x7b's prefill in both dtypes beside SDPA
              (``enable_gqa``, causal: the window covers the prompt) and
              the bounds; then (``time_encdec``) K3 at whisper-large-v3's
              four shapes in both dtypes: the encoder's self-attention
              (B=4, 1,500 x 1,500, 20 heads of 64), the decoder's causal
              self-attention (440 x 440), the prefill's cross-attention
              (440 x 1,500) and one decode query against the frames (1 x
              1,500), each beside SDPA and the bounds, and their sum over
              one served batch (each time by its launches there); then
              llama3-8b at its published width (d_model 4,096, 32 heads
              over 8 kv heads of 128, vocab 128,256), 2 of its 32 layers,
              one bfloat16 prefill of the serve batch, K3 once per layer
              at head dim 128 with no window, its logits against the
              plain-attention model; then (``time_k3_bwd``) K3's
              backward at qwen1.5-0.5b's training shape, whisper's
              encoder shape and mixtral-8x7b's (D = 128, window 4,096)
              in both dtypes, beside its launches per train step, its
              plain version, the backward alone of
              ``F.scaled_dot_product_attention`` and its bound (the five
              products of the gradient at 3xTF32's rate for float32, the
              dense bf16 rate for bfloat16); then (``time_k4_bwd``) K4's
              backward at mamba2-370m's and hymba-1.5b's training shapes
              (B=4 and B=1, S=2,048) in both dtypes, the nine passes
              together and each alone, beside its launches per train
              step, its plain version and its bound (the gradient's
              products at 3xTF32's rate for float32, the dense bf16 rate
              for bfloat16, or its bytes; the same products at the FP32
              CUDA-core peak beside it; no PyTorch call computes it).
              Every timed K3 output
              and K4 gradient is held against its plain version on the
              same inputs. The library calls are yardsticks the port
              never calls.
11. multi     the multi-stream path, K1's counts set to 0 just before
              it: ``run_skyscraper_multi`` over 256 COVID streams of
              10,800 segments (the main fit, one joint LP of 1,024 rows
              per 2,160-segment window, the flight recorder on) into a
              store with a registry (the five main plans and one
              subscription), so its one ingest folds 2,764,800 rows
              through K1 once per plan; then the main plans as queries.
11b. multi_check  the same call on the card machine's CPU: rows and
              per-stream counters bit for bit, the counters against
              ``obs.telemetry_ref``; each standing query's folded
              accumulators and each query's answer against the float64
              oracle of the store's rows, and each standing answer
              against ``store.query``'s.
12. pool      ``SkyscraperPool`` over the transform phase's job fitted
              again with pinned runtimes (the same configs every run),
              segments standing for categories: 200 ticks through slot
              caps 512, 1,024 and 2,048 with churn, then the capacity
              squeezed to 60% of the demand under the joint plan with 4
              priority bands; a sink with a shed-watch subscription, so
              K1 folds each tick's rows.
12b. pool_check  the script replayed on the CPU: statuses, counters and
              sink rows bit for bit; the shed-watch's accumulators,
              answer and alerts against the CPU registry's and the
              float64 oracle, exactly (a min); then, plans pinned, each
              stream of a small pool against ``switch_step`` alone.
12c. sharded  the sharded warehouse, K1's counts set to 0 just before
              each of its two driven parts: an 8-shard ``ShardedStore``
              of the main phase's 256 camera-days (32 a shard), landed
              camera by camera with the main plans and subscription
              registered, so each ingest folds its rows through K1 on
              their shard; the five plans through ``execute_sharded`` (8
              K1 partials each) held against the single store's answers
              and the float64 oracle, a compressed sum of ``out`` within
              S (max|ref| / 127 + 1e-3), a row TopK and a row plan equal
              to the single store's rows; the standing answers against
              the main registry's; ``rebalance`` to 4 shards (each new
              shard the old shards' rows in order, bit for bit; plans and
              the replayed registry); the multi phase's run landed again
              in an 8-shard sink and the pool script run again into a
              4-shard sink, each shard the single sink's rows of its
              streams in order, the pool's statuses and alerts equal; a
              ``TieredStore`` of 8 camera-days saved and loaded (every
              array bit for bit, the answers bit for bit on the CPU's
              plain path); then a ``ShardedTieredStore`` with one
              camera-day hot per shard, the plans over its view within
              the quantization bound, the standing answers unchanged.
              K1 timed as one shard's partial (1,382,400 rows).
12d. dist     the sharded warehouse across cards: one NCCL rank per
              visible card (as many as divide the 8 shards; one on a
              one-card machine), spawned under a deadline
              (``launch.mesh.spawn_world``), each loading the K1 library
              the build phase made and holding its block of the 8
              shards on its card; K1's counts set to 0 in each rank just
              before its fill and read after its queries, and again
              around the two-tier view. The ranks land the 256
              camera-days with the main plans and subscription
              registered, run the five plans (each rank's shards'
              partials through K1, every shard's gathered in shard
              order), the compressed sum, the row TopK and row plan, the
              poll and standing answers, ``rebalance`` to 4 shards and a
              ``ShardedTieredStore`` spill, and are held against the
              ``sharded`` phase's stacked store: every answer the same on
              every rank, bit for bit; stored rows, counts, capacity, TopK
              rows with their global ids, the row plan, alert masks, the
              rebalanced rows and every cold array bit for bit; counts,
              keys, max and min exact and float sums within the
              ``sharded`` phase's tolerance where they are not bit-equal
              (K1 adds with atomics, so a second launch of the stacked
              store's own partials may round them otherwise; the share
              bit-equal is printed). Prints the world size, fill, each
              plan's ms (median of 5), rebalance and spill seconds, K1's
              launches and the bytes gathered per plan per rank, peak
              memory, and the card's name and power limit.
12e. train_dist  training across cards: one NCCL rank per visible card
              (as many as divide the global batch of 4 rows; one on a
              one-card machine), spawned under a deadline, each loading
              the K3 and K4 libraries the build phase made, laying the
              world out as (world, 1) over ("data", "model") and keeping
              its blocks of the train state (ZeRO-3 over "data"); its
              rows of each global batch through the launcher's step with
              ``mesh=`` (each leaf gathered at use a layer at a time, the
              gradients reduce-scattered), K3's and K4's counts set to 0
              just before each part's steps and read just after. (a)
              llama3-8b at its published width cut to 4 of 32 layers
              (1.9B parameters), float32, 3 steps at 4 x 2,048 tokens
              from CPU draws, then the same steps without a mesh on each
              card from the same draws; (b) with four cards, llama3-8b at
              full depth (8.03B parameters, 128 GB of float32 state),
              each leaf drawn on the card and cut; on fewer cards it
              prints that it is skipped and why; (c) mamba2-370m cut to 4
              of 48 layers, as (a), K4 both ways. (d) the model axis
              computed: two ranks on card 0 joined through gloo (NCCL
              refuses a card twice) laid out as (1, 2), llama3-8b cut to
              2 layers, each rank its own 16 of 32 heads (K3 both ways
              at H = 16, G = 4), half the hidden columns and the vocab
              rows, joined by the all-reduces of f and g, against the
              same steps without a mesh (one rank at a time). With four
              cards also (a) and (c) at (1, 4) and (2, 2), (e)
              mixtral-8x7b cut to 2 layers at (1, 4) under
              moe_sharding="ep" (each rank 2 of 8 experts), and (b) at
              (2, 2). Prints each part's losses, seconds a step (the
              first apart), tokens per second, peak memory and bytes
              gathered, reduced and moved over "model" a step per rank,
              and the launches per rank. Then ``time_split``: K3 and K4,
              both ways, at the split's local shapes (llama3-8b at m = 4:
              B 4, S 2,048, H 8, G 2, D 128; mamba2-370m's 8 of 32
              heads), each held against its plain version, beside its
              plain version's time, the library call's and the bound;
              and K3 in bfloat16 at qwen1.5-110b's local prefill shape
              at (1, 4) (B 4, S 2,048, H 16, G 2, D 128) beside SDPA and
              both bounds.
12f. serve_dist  serving across ranks: two gloo ranks on card 0 laid
              out as (1, 2) over ("data", "model"), each serving one
              batch of 4 x 2,048-token prompts and 8 generated tokens
              through the prefill and decode steps with the mesh,
              ``init_params`` drawing each layer slice on the card and
              keeping this rank's block, K3's and K4's counts set to 0
              just before each part's prefill and read after its last
              decode step. (a) llama3-8b at its published width cut to 2
              layers, then mamba2-370m at full width, bfloat16: each rank
              K3 (16 of 32 heads over 4 of 8 kv heads) or K4 (16 of 32
              heads) on its heads, k and v moved to its half of the
              cache's slots by one all-to-all, each decode step's q, k
              and v gathered, its slots attended and the softmax merged
              over "model", the next token over the vocab split; against
              one card's serve from the same draws. Prints seconds, peak
              memory and bytes a rank for the prefill and a decode step,
              and the launches a rank.
13. tiers     the main store in a ``TieredStore``, all but the newest
              camera-day spilled to int8; the main plans over the
              two-tier view through K1, against the float64 oracle of
              the view and within the quantization bound of the
              unspilled answers; the standing answers unchanged.
14. time_many K1 at these paths' shapes, each call also held against
              its plain version and the oracle: the main plans over the
              multi-stream store and the two-tier view, and the pool's
              fold of one tick's rows into 2,048 min accumulators (each
              section's last tick), beside its plain version, the
              library call and the byte bound.
15. obs       the dispatch tracer (``repro_torch.obs.run_obs``, 3 warm
              calls) over the port's 54 engines, the reference tracer's
              at its examples' tiny sizes: a valid Chrome trace, the
              report clean against itself, no warm library load, no
              skipped engine, K1 launched by every ``*pallas*`` engine;
              each engine's warm span, host synchronisations (under
              ``torch.cuda.set_sync_debug_mode("warn")``) and device idle
              share (one warm call each in one ``torch.profiler``
              session, inside a ``record_function`` range of its name:
              1 - the device time of the kernels in its range over the
              median warm span, as ``scripts/chip_profile.py`` takes
              it), and the five largest spans.

Tolerances. K1: counts, max, min and integer-valued sums are exact.
Float sums and means: K1 within 1e-4 of each group's sum of magnitudes
of its plain version run on the same inputs with the value column in
float64 (``fused_segment_agg_ref`` then accumulates in float64), and of
a float64 numpy oracle. The 1e-4 is the worst-case bound n * 2^-24 of a
float32 sum of n = 1,600 terms, about what one shared accumulator of K1
takes before the block-ordered fold (the measured errors are printed
and far smaller). The plain version is run in float64 for the check
because its float32 ``index_add_`` (the reference's row-order
semantics) drifts by about 2% from float64 on groups of millions of
rows; its float32 form is what ``plain_ms`` times.
K2: float32 within f^2 * 2^-24 * max|x| (reordering a sum of f^2
terms), bfloat16 within one bfloat16 ulp (2^-7 relative) of the plain
version. K3: within ``kernels.flash_attention.error_bound`` of the plain version:
the worst case of reordering float32 sums over Skv keys, Skv * 2^-24 *
max|v| (the bound of the FP32 kernel before it), plus the 3xTF32 terms,
3 * 2^-22 of the scaled sum of |q_d k_d| on each score carried through
the softmax (with the float32 score sums over D) and of max|v| on each
output; for bfloat16 q, k, v the bfloat16 kernel's own terms (exact
products: (2 D + 1) 2^-24 of that sum on a score; P in two bfloat16
parts: 2^-16 max|v| on an output) and the output's rounding. K4: y and the
final state within ``kernels.ssd.error_bound`` of the plain version in
float64: 2^-24 * (N + 3 S' + 32 Lambda + 16 + 24) times the largest sum
of magnitudes of one output (S' the padded length, Lambda the largest
sum of |dt * A| over a chunk; the bound follows the float32 sums'
lengths, the cumsum's roundings inside each decay exponent and, the
24, two 3xTF32 products in a row at 3 * 2^-22 each); each pass within
its own bound of the same kind (``kernels.ssd.pass_errors``). Transform
qualities: 1e-5 against the CPU run. Serve: logits within 1e-3 of the
plain-attention model (3xTF32 attention summed in another order moves
each layer by about 1e-6 relative, as float32 did; 24 layers and the
head leave that far below 1e-3), and at least 99% of next tokens equal; the same limits
for mamba2-370m against the plain-SSD model and for hymba-1.5b against
the model with both plain versions, and for mixtral-8x7b against the
plain-attention model on the same expert choices (each layer's
free-running choices agreeing on at least 97% of tokens), and for
whisper-large-v3 (64 layers in all) against the plain-attention model.
The float8 cache: its codes bit for bit against the float8 cast of the
bfloat16 cache's. The
comparisons: the loop's traces and the optimum's selection bit for bit
against the CPU, its sums within 1e-5. The flight recorder: bit for bit. bfloat16: K3 and K4 within
their bound on the widened inputs plus the rounding of the output to
bfloat16, half an ulp (2^-8) of the value; the bfloat16 logits within
``models.options.bf16_logit_tolerance``, (L + 2) bfloat16 ulps (2^-7)
of the largest |logit| (one ulp per layer boundary and for the logits'
own rounding; derived in its docstring), where an encoder-decoder
model's L also counts the encoder's layers and two more roundings
(``models.options.bf16_boundaries``: 66 for whisper-large-v3).
Standing answers: their
accumulators within FLOAT_TOL of the float64 oracle, as K1's; their
tables within twice that of ``store.query``'s, max and min exactly.
K3's backward: within ``kernels.flash_attention.bwd_error_bound`` of
its plain version in float64: per element, the float32 sums' lengths
(Sq R terms for dk and dv, Skv for dq) times their sums of magnitudes,
plus the error of each recomputed P (the D-term score sums, expf's 2
ulp) and dS carried through them; bfloat16 adds the outputs' rounding.
K4's backward: within ``kernels.ssd.bwd_error_bound`` of its plain
version in float64, per element: 2^-24 times the gradient's sum of
magnitudes times L, the longest chain of float32 roundings (the forward
scratch's and the backward's sums over Q, N, P, the R heads and the
chunks, the decays' exponents); bfloat16 adds the outputs' rounding.
Training: the full-width 4-layer step against the plain-attention step,
the loss within 1e-5 relative and each gradient leaf within 1e-3 of its
largest magnitude (``TRAIN_GRAD_TOL``: both kernels' float32 sums over
2,048 terms, 1.2e-4 each, through 4 layers), and so mamba2's against
the plain-SSD step and hymba's against both plain versions; the reduced
families on the card against the CPU within 1e-5 (the CPU parity
tests' tolerance of ``Model.loss``).
Training across cards: at one rank every collective is the identity,
so the sharded steps equal the steps without a mesh bit for bit (the
losses, the norms, every param and both AdamW moments); at more, the
losses and norms within 1e-5 relative (``TRAIN_LOSS_TOL``: the
gradients' float32 sums over W partial batches in another order, and
cuBLAS's products over fewer rows), every rank's blocks of the AdamW
moments within 1e-3 of each leaf's largest magnitude for m and 2e-3 for
v (``DIST_MOMENT_TOL``: m is linear in the steps' gradients and v in
their squares, so a gradient block summed or placed wrongly shows
there), and every param within one float32 ulp of its leaf's largest
magnitude an update plus the sum over the updates of ``_update_bound``:
how far an AdamW step may move when the moments are within their
tolerances.
Serving across ranks: the ranks' logits (bfloat16 compute) within
``bf16_logit_tolerance`` of ``bf16_boundaries`` of one card's from the
same draws, each decode step of the one card fed the ranks' tokens; a
token may differ from the one card's argmax only where its top two
logits lie within that tolerance (the row-parallel products' parts
added by an all-reduce, K3 and K4 at half the heads and the decode's
softmax merged over the ranks' slots are other float32 sums of the same
terms, rounded to bfloat16 at the same layer boundaries).
"""
from __future__ import annotations

import gc
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
FLOAT_TOL = 1e-4                    # of the group's sum of magnitudes
KERNEL_ROWS = 1 << 20
CAMERAS = 256
RUN_DAYS = 1.0                      # 43,200 segments of 2 s
ROTATE = 169                        # segments between cameras' clocks
FP32_FLOP_PER_S = 67e12             # H100 SXM FP32 CUDA cores (data sheet)
TF32_FLOP_PER_S = 495e12            # H100 SXM dense TF32 tensor cores
BF16_FLOP_PER_S = 989e12            # H100 SXM dense bf16 tensor cores
SEGMENT = (30, 720, 1280, 3)        # 2 s of a 720p camera at 15 fps
TOKENS = (30, 16)
FIT_SEGMENTS = 40
PROCESS_SEGMENTS = 60
QUALITY_TOL = 1e-5
LOGIT_TOL = 1e-3
TOKEN_AGREEMENT = 0.99
SERVE = dict(requests=8, batch=4, prompt_len=2048, gen=8)
ATTN_TIME = (4, 2048, 16, 64)       # B, S, H = G, D of the serve prefill
ATTN_SMALL = (30, 16, 4, 8)         # the Transform's calls (model small)
SSD_TIME = (4, 2048, 32, 64, 1, 128, 256)   # B, S, H, P, G, N, Q: mamba2
HYMBA_ATTN = (4, 2048, 25, 5, 64, 1024)     # B, S, H, G, D, window: hymba
HYMBA_SSD = (4, 2048, 25, 64, 1, 16, 256)   # B, S, H, P, G, N, Q: hymba
MOE_LAYERS = 4                      # mixtral-8x7b's 32 layers cut to 4
MOE_ATTN = (4, 2048, 32, 8, 128, 4096)      # B, S, H, G, D, window: mixtral
ROUTE_AGREEMENT = 0.97              # float32 free-running expert choices
FP8 = "float8_e4m3fn"               # the float8 kv cache's dtype
# whisper-large-v3: 2 batches of 4, prompts of 440 tokens and 8 generated,
# 448 = max_target_len; each request's 1,500 encoder frames
WHISPER_SERVE = dict(requests=8, batch=4, prompt_len=440, gen=8)
# K3 at whisper's shapes (B, Sq, Skv, H = G, D, causal) and its launches
# per layer in one served batch of WHISPER_SERVE
WHISPER_ATTN = {
    "encoder_self": ((4, 1500, 1500, 20, 64, False), 1),
    "decoder_self": ((4, 440, 440, 20, 64, True), 1),
    "prefill_cross": ((4, 440, 1500, 20, 64, False), 1),
    "decode_cross": ((4, 1, 1500, 20, 64, False), WHISPER_SERVE["gen"] - 1),
}
LLAMA_LAYERS = 2                    # llama3-8b's 32 layers cut to 2
# training: qwen1.5-0.5b at its published config, the launcher's step
TRAIN = dict(batch=4, seq=2048, steps=8, lr=1e-2)
TRAIN_SSM = 4                       # mamba2-370m's batch of 2,048 tokens
TRAIN_HYBRID = 1                    # hymba-1.5b's
# hymba-1.5b's peak rate: the launcher's default (``--lr``). At TRAIN's
# 1e-2 its loss spikes within 8 steps of one sequence, through the plain
# versions just as through the kernels
TRAIN_HYBRID_LR = 3e-4
K4_BWD_TIME = {                     # B, S, H, P, G, N, Q of train_*
    "mamba2_train": (TRAIN_SSM, 2048, 32, 64, 1, 128, 256),
    "hymba_train": (TRAIN_HYBRID, 2048, 25, 64, 1, 16, 256),
}
TRAIN_CHECK_LAYERS = 4              # the gradient check's cut of 24 layers
# of each leaf's largest |gradient|: the backward's float32 sums over
# Sq R = 2,048 terms (bwd_error_bound) and the forward's over Skv = 2,048
# keys (error_bound) are each about 2,048 * 2^-24 = 1.2e-4 of their sums
# of magnitudes; each of the 4 layers hands both on to the layers below
# at a gain of about one: 4 x 2 x 1.2e-4 ~ 1e-3
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-5               # relative, kernel vs plain attention
FAMILY_TOL = 1e-5                   # the CPU parity tests' Model.loss tolerance
FAMILY_SEQ = 64                     # past reduced mixtral's window of 32
# the backward timed at the training shapes, with its launches per step
# at the published depth (train_families' reduced configs launch fewer)
K3_BWD_TIME = {
    "qwen_train": ((4, 2048, 2048, 16, 16, 64, True, None), 24),
    "whisper_encoder": ((4, 1500, 1500, 20, 20, 64, False, None), 32),
    "mixtral_train": ((4, 2048, 2048, 32, 8, 128, True, 4096), 32),
}
COMPARE_PLAN_DAYS = 0.25            # the paper's loop: 4 windows of 10,800
SPIN_CYCLES = 40_000_000            # ~20 ms of the card's clock per timing
WINDOW = 150                        # segments in a 5-minute window
ALERT_CLOUD_S = 13_500.0            # 90% of a camera-day's cloud budget
MULTI_STREAMS = 256                 # as many camera-days as the main store
MULTI_DAYS = 0.25                   # 10,800 segments per stream
MULTI_PLAN_DAYS = 0.05              # 5 planning windows of 2,160
POOL_BUCKETS = (384, 512, 513, 1100)  # live streams: slot caps 512-2048
POOL_TICKS = (40, 30, 40, 30, 60)   # per section; the last is the squeeze
POOL_SQUEEZE = 0.6                  # capacity, of the unconstrained demand
POOL_BANDS = 4                      # priority bands 1..4
POOL_PINNED = (24, 30)              # streams, ticks of the oracle check
SHARDS = 8                          # the sharded store: 32 cameras a shard
REBALANCE_SHARDS = 4
POOL_SHARDS = 4                     # the pool's sharded sink
CKPT_DAYS = 8                       # camera-days in the saved warehouse
DIST_TIMEOUT = 120                  # s a collective of the dist phase waits
DIST_DEADLINE = 300                 # s before its world of ranks is killed
# llama3-8b's batch, 4 of its 32 layers, the launcher's default peak rate
TRAIN_DIST = dict(batch=4, seq=2048, steps=3, layers=4, lr=3e-4)
TRAIN_DIST_FULL = 4                 # ranks part (b) needs (128 GB of state)
# of a leaf's largest |m| (twice that for v, the gradients' squares): a
# gradient's float32 sum over the batch's 8,192 tokens in another order
# (W partial sums added by the collectives) may move by up to 8,192 x
# 2^-24 = 4.9e-4 of its terms' sum of magnitudes, above the sum itself
# where they cancel, and cuBLAS's products over fewer rows add their own
# (TRAIN_GRAD_TOL's reasoning); the CPU tests' 1e-5 at reduced size is
# not enough at full width (mamba2's m at four cards: 1.6e-5)
DIST_MOMENT_TOL = 1e-3
TRAIN_DIST_DEADLINE = 900           # s before the train_dist world is killed
# the model axis's split: part (d), llama3-8b cut to 2 layers at (1, 2),
# two gloo ranks on one card (NCCL refuses a card twice); with four
# cards, part (e), mixtral-8x7b cut to 2 layers at (1, 4) under
# moe_sharding="ep"
TRAIN_DIST_SPLIT_LAYERS = 2
TRAIN_DIST_SHARED = 2               # ranks on the one card of part (d)
# part (b)'s mesh: at (1, 4) a rank would hold 32.1 GB of state and the
# activations of all 4 rows at a quarter of the width (reckoned 1.43 GB a
# layer, 45.9 GB for 32, over 80 GB with the logits: PERF.md, PR 30)
TRAIN_DIST_B_MESH = (2, 2)
# the sequence-split parts and the part each is held against, from the
# same draws: (d seq) llama3-8b 2 layers at (1, 2) on one card; with
# four cards (b seq) at (2, 2) and (f), all 32 layers at (1, 4)
SEQ_BASE = {"d seq": "d", "b seq": "b", "f": "b"}
LAST_PARTS: dict = {}               # the last train_dist phase's parts
# K3 and K4 (forward and backward) at the split's local shapes: llama3-8b
# at m = 4 (B, S, H, G, D) and mamba2-370m's 8 of 32 heads (B, S, H, P,
# G, N, Q)
SPLIT_K3 = (4, 2048, 8, 2, 128)
SPLIT_K4 = (4, 2048, 8, 64, 1, 128, 256)
# B, S, H, G, D: qwen1.5-110b's local prefill at (1, 4) (64 heads over 8
# kv heads of 128, cut by m = 4), bfloat16: serve_dist's part (c)
SERVE_SPLIT_K3 = (4, 2048, 16, 2, 128)
# serving across ranks (``serve_dist``): one batch of 4 prompts of 2,048
# tokens and 8 generated; part (a), llama3-8b cut to 2 of its 32 layers
# and mamba2-370m at full depth over two gloo ranks on card 0
SERVE_DIST = dict(batch=4, prompt_len=2048, gen=8)
SERVE_DIST_LAYERS = 2
SERVE_DIST_SHARED = 2
SERVE_DIST_DEADLINE = 600           # s before the serve_dist world is killed


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` warm runs of ``fn`` timed with CUDA events. The
    card first spins for about 20 ms (``torch.cuda._sleep``), so the
    host has enqueued the first event and ``fn``'s launches before the
    card reaches them: the events time the device work alone, not the
    wrapper's host-side work in front of an idle card."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# float64 host oracle of one aggregation
# ---------------------------------------------------------------------------

def _np_mask(cols, n, filters):
    mask = np.ones(n, bool)
    ops = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
           "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}
    for f in filters:
        x = cols[f.column][:n]
        if np.issubdtype(x.dtype, np.integer):
            mask &= ops[f.op](x.astype(np.float64), np.float64(f.value))
        else:
            mask &= ops[f.op](x, np.float32(f.value))
    return mask


def oracle(cols, n, filters, keys, value, agg):
    """(acc, cnt, scale) in float64: the group sums (or max/min), counts
    and sums of magnitudes of rows [0, n) under ``filters``."""
    mask = _np_mask(cols, n, filters)
    gid, num = None, 1
    for col, k_num, window in keys:
        ids = cols[col][:n].astype(np.int64)
        if window > 1:
            ids = ids // window
        ids = np.clip(ids, 0, k_num - 1)
        gid = ids if gid is None else gid * k_num + ids
        num *= k_num
    ids = gid[mask]
    v = cols[value][:n][mask].astype(np.float64)
    cnt = np.bincount(ids, minlength=num).astype(np.float64)
    if agg in ("max", "min"):
        acc = np.full(num, -np.inf if agg == "max" else np.inf)
        (np.maximum if agg == "max" else np.minimum).at(acc, ids, v)
        return acc, cnt, np.abs(acc)
    if v.ndim == 1:
        acc = np.bincount(ids, weights=v, minlength=num)
        scale = np.bincount(ids, weights=np.abs(v), minlength=num)
    else:
        acc = np.stack([np.bincount(ids, weights=v[:, d], minlength=num)
                        for d in range(v.shape[1])], 1)
        scale = np.stack([np.bincount(ids, weights=np.abs(v[:, d]),
                                      minlength=num)
                          for d in range(v.shape[1])], 1)
    return acc, cnt, scale


def host_partial(part):
    """A partial ``{acc, cnt}`` as host float64 arrays."""
    return (part["acc"].double().cpu().numpy(),
            part["cnt"].double().cpu().numpy())


def check_partial(what, got, want, agg, slack, exact_sums=False):
    """Max abs error of the partial ``got`` against ``want`` (host
    ``(acc, cnt)`` pairs); raise unless counts, max/min and integer sums
    are equal and float sums lie within ``slack`` (elementwise)."""
    (g_acc, g_cnt), (w_acc, w_cnt) = got, want
    if not np.array_equal(g_cnt, w_cnt):
        raise AssertionError(f"{what}: counts differ by "
                             f"{np.abs(g_cnt - w_cnt).max()}")
    finite = np.isfinite(w_acc)
    if not np.array_equal(np.isfinite(g_acc), finite):
        raise AssertionError(f"{what}: sentinels differ")
    diff = np.abs(g_acc[finite] - w_acc[finite])
    err = float(diff.max(initial=0.0))
    if agg in ("max", "min") or exact_sums:
        if not np.array_equal(g_acc, w_acc):
            raise AssertionError(f"{what}: {agg} must be exact; max error "
                                 f"{err}")
        return err
    if not np.all(diff <= slack[finite]):
        worst = float((diff / slack[finite]).max())
        raise AssertionError(f"{what}: {agg} off by {worst:.3g}x its "
                             f"tolerance (max error {err})")
    return err


def plain64(K, cols, n, fvals, spec):
    """K1's plain version on the same inputs, the value column in
    float64, so its sums carry no float32 rounding."""
    return K.fused_segment_agg_ref(
        {**cols, spec.value: cols[spec.value][:n].double()}, n, fvals, spec)


def hold(name, kernel, plain, oracle_out, agg, exact_sums=False):
    """The kernel's partial against its plain version in float64 and
    against the float64 numpy oracle, each within FLOAT_TOL of the
    group's sum of magnitudes. Returns the max abs errors."""
    acc, cnt, scale = oracle_out
    k, p = host_partial(kernel), host_partial(plain)
    tol = FLOAT_TOL * scale + 1e-6
    return {
        "vs_plain": check_partial(f"{name}: kernel vs plain", k, p, agg,
                                  tol, exact_sums),
        "vs_f64": check_partial(f"{name}: kernel vs float64", k,
                                (acc, cnt), agg, tol, exact_sums),
    }


def partial_bytes(cols, n, kept, spec) -> int:
    """Least bytes one aggregation must move: the filter columns of
    every live row, the key and value columns of the rows that pass
    (rows the filter drops need no key or value), the accumulators out."""
    fcols = {c for c, _, _ in spec.filters}
    total = 0
    for name in spec.columns():
        col = cols[name]
        row = col.element_size() * (col.shape[1] if col.ndim == 2 else 1)
        total += row * (n if name in fcols else kept)
    width = cols[spec.value].shape[1] if cols[spec.value].ndim == 2 else 1
    return total + spec.num_groups * (width + 1) * 4


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = nvidia_smi()
    props = torch.cuda.get_device_properties(0)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), sms=props.multi_processor_count,
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
         nvidia_smi=smi)
    return smi


def phase_build():
    from repro_torch.kernels import build
    _, secs = timed(lambda: build.load_all(build.sources()))
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
             for n, log in build.BUILD_LOG.items()}
    emit("build", sources=list(build.sources()), seconds=secs, ptxas=ptxas)


def _kernel_cols(n, dev, seed=0, D=9):
    rng = np.random.default_rng(seed)
    host = {
        "stream_id": rng.integers(0, 256, n).astype(np.int32),
        "t": np.sort(rng.integers(0, 43_200, n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, D, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20 - 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 600).astype(np.float32),
        "out": rng.random((n, D)).astype(np.float32),
    }
    return host, {k: torch.as_tensor(v, device=dev) for k, v in host.items()}


def _kernel_cases():
    from repro_torch.warehouse import Filter, GroupBy, MultiGroupBy, WindowAgg
    aggs = ("sum", "mean", "count", "max", "min")
    for agg in aggs:
        yield (Filter("quality", "ge", 0.3),
               GroupBy("category", "on_core_s", agg=agg, num_groups=4))
        yield (Filter("stream_id", "lt", 99.5), Filter("k", "ne", 3),
               GroupBy("stream_id", "buffer_s", agg=agg, num_groups=256))
        yield (WindowAgg(window=150, value="quality", agg=agg,
                         num_windows=288),)
        # 73,728 groups: global-memory accumulators
        yield (Filter("quality", "ge", 0.1),
               MultiGroupBy(keys=("stream_id", "t"), value="on_core_s",
                            agg=agg, nums=(256, 288), windows=(0, 150)))
    for agg in ("sum", "mean", "count"):
        yield (Filter("k", "le", 6),
               MultiGroupBy(keys=("t", "category"), value="out", agg=agg,
                            nums=(288, 4), windows=(150, 0)))
        # 8,640 groups of 9 lanes: global-memory accumulators
        yield (MultiGroupBy(keys=("t", "category"), value="out", agg=agg,
                            nums=(2160, 4), windows=(20, 0)),)
    yield (GroupBy("category", "k", agg="sum", num_groups=4),)   # integer
    for v in (-2.0 ** 31 - 0.7, -0.5, 0.0, 6.999, 2.0 ** 31,
              float("-inf"), float("inf")):
        for op in ("lt", "ge", "eq", "ne"):
            yield (Filter("k", op, v),
                   GroupBy("category", "quality", agg="count",
                           num_groups=4))


def _width(cols, spec) -> int:
    v = cols[spec.value]
    return int(v.shape[1]) if v.ndim == 2 else 0


def _spec_of(plan, cols):
    """K1's spec, the hoisted filter operands and the Filter nodes of
    an aggregating plan."""
    from repro_torch.warehouse import Filter
    from repro_torch.warehouse import query as Q
    spec, fvals = Q.normalize(plan)
    pre, node, _ = Q.split_plan(spec)
    aspec = Q._kernel_spec(pre, node, cols)
    if aspec is None:
        raise AssertionError(f"no kernel spec for {plan!r}")
    return aspec, fvals, [nd for nd in plan if isinstance(nd, Filter)]


def phase_kernel(dev):
    """K1 vs its plain version (and a float64 oracle) at 1M rows."""
    from repro_torch.kernels import warehouse_agg as K
    host, cols = _kernel_cols(KERNEL_ROWS, dev)
    worst = {"vs_plain": 0.0, "vs_f64": 0.0}
    cases, modes = 0, {"shared": 0, "global": 0}
    for n in (KERNEL_ROWS, KERNEL_ROWS - 12_345, 0):
        for plan in _kernel_cases():
            spec, fvals, filters = _spec_of(plan, cols)
            got = K.fused_segment_agg(cols, n, fvals, spec)
            plain = plain64(K, cols, n, fvals, spec)
            modes[K.accumulator_mode(spec, _width(cols, spec))] += 1
            errs = hold(f"{plan!r} n={n}", got, plain,
                        oracle(host, n, filters, spec.keys, spec.value,
                               spec.agg),
                        spec.agg, exact_sums=spec.value == "k")
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
            cases += 1
    edges, edge_err = _k1_edge_checks(K, dev)
    worst["vs_plain"] = max(worst["vs_plain"], edge_err)
    emit("kernel", rows=KERNEL_ROWS, cases=cases, modes=modes,
         edge_cases=edges, launches=K.LAUNCHES, max_abs_err=worst)
    return worst


def _k1_edge_checks(K, dev):
    """K1 against its plain version (float64) where the kernel's vector
    path has edges: column views whose base is not 16-byte aligned (a
    scalar head, and columns no row can align together), the standing
    fold's delta blocks [lo:lo + n] (lo % 4 of 1 to 3, n of 0 to 4,093;
    n = 0 gives the identities), row counts that
    leave a scalar tail on columns holding exactly those rows, warps whose
    rows fall in 32 groups or in one, and max/min over +-0 and +-inf in
    shared and global mode. Returns (cases, max abs error)."""
    none = ((), (), (), ())
    _, cols = _kernel_cols(1 << 16, dev, seed=7)
    from repro_torch.warehouse import query as Q
    from repro_torch.warehouse import Filter
    _, f03 = Q.normalize((Filter("quality", "ge", 0.3),))
    filt = (("quality", "ge", 0),)
    runs = []
    for shift in (1, 2, 3):
        view = {k: v[shift:] for k, v in cols.items()}
        n = (1 << 16) - shift
        for agg in ("sum", "max", "min", "count"):
            runs.append((view, n, f03, K.FusedAggSpec(
                filt, (("category", 4, 0),), "buffer_s", agg)))
        runs.append((view, n, f03, K.FusedAggSpec(
            filt, (("t", 288, 150), ("category", 4, 0)), "out", "mean")))
    # the standing fold's delta blocks: every column sliced [lo:lo + n]
    for lo in (1, 2, 3):
        for n in (0, 1, 3, 4093):
            block = {k: v[lo:lo + n] for k, v in cols.items()}
            for agg in ("sum", "max", "min"):
                runs.append((block, n, f03, K.FusedAggSpec(
                    filt, (("category", 4, 0),), "buffer_s", agg)))
            runs.append((block, n, f03, K.FusedAggSpec(
                filt, (("t", 288, 150), ("category", 4, 0)), "out", "sum")))
    mixed = {**cols, "buffer_s": cols["buffer_s"][1:]}
    runs.append((mixed, 50_000, none, K.FusedAggSpec(
        (), (("stream_id", 256, 0),), "buffer_s", "max")))
    for n in (1, 3, 5, 4 * 5000 + 3):
        exact = {k: v[:n].clone() for k, v in cols.items()}
        for agg in ("sum", "min"):
            runs.append((exact, n, f03, K.FusedAggSpec(
                filt, (("stream_id", 256, 0),), "on_core_s", agg)))
        runs.append((exact, n, none, K.FusedAggSpec(
            (), (("category", 4, 0),), "out", "sum")))
    n = 1 << 14
    rng = np.random.default_rng(8)
    pattern = {"g_all": torch.arange(n, dtype=torch.int32, device=dev),
               "g_one": torch.zeros(n, dtype=torch.int32, device=dev),
               "x": torch.as_tensor(rng.normal(0, 1, n).astype(np.float32),
                                    device=dev),
               "w": torch.as_tensor(rng.normal(0, 1, (n, 5))
                                    .astype(np.float32), device=dev)}
    for key, num in (("g_all", n), ("g_one", 1)):
        for agg in ("sum", "max"):
            runs.append((pattern, n, none, K.FusedAggSpec(
                (), ((key, num, 0),), "x", agg)))
        runs.append((pattern, n, none, K.FusedAggSpec(
            (), ((key, num, 0),), "w", "sum")))
    signs = np.resize(np.array([-0.0, 0.0, -np.inf, np.inf, -3.5, 2.5],
                               np.float32), 6000)
    for num in (6, 70_000):
        g = (np.arange(6000) % 6) * (num // 6)
        zs = {"g": torch.as_tensor(g.astype(np.int32), device=dev),
              "x": torch.as_tensor(signs, device=dev)}
        for agg in ("max", "min"):
            runs.append((zs, 6000, none, K.FusedAggSpec(
                (), (("g", num, 0),), "x", agg)))
    worst = 0.0
    for c, n, fv, spec in runs:
        got = host_partial(K.fused_segment_agg(c, n, fv, spec))
        plain = host_partial(plain64(K, c, n, fv, spec))
        scale = host_partial(K.fused_segment_agg_ref(
            {**c, spec.value: c[spec.value][:n].double().abs()}, n, fv,
            spec))[0]
        slack = FLOAT_TOL * np.where(np.isfinite(scale), scale, 0) + 1e-6
        worst = max(worst, check_partial(f"K1 edge {spec} n={n}", got,
                                         plain, spec.agg, slack))
    return len(runs), worst


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def k2_tolerance(plain, frame, factor) -> float:
    """float32: reordering a sum of f^2 terms moves it by at most
    f^2 * 2^-24 * max|x|; bfloat16: one bfloat16 ulp of the value."""
    bound = factor * factor * 2.0 ** -24 * float(frame.float().abs().max())
    if plain.dtype == torch.bfloat16:
        bound += 2.0 ** -7 * float(plain.float().abs().max())
    return bound + 1e-7


def _k2_cases(dev, gen):
    """(name, frames, factor): 3-D and 4-D, float32 and bfloat16,
    factors 2 to 4, a strided frame axis, and the Transform's segment."""
    seg = torch.randn(SEGMENT, generator=gen, device=dev)
    yield "segment_f2", seg, 2
    yield "segment_f2_bf16", seg.to(torch.bfloat16), 2
    yield "segment_every2_f2", seg[::2], 2
    yield "segment_every4_f4", seg[::4], 4
    yield "frame3d_f4", seg[0], 4
    small = torch.randn((8, 96, 96, 3), generator=gen, device=dev)
    for f in (2, 3, 4):
        yield f"b8_96_f{f}", small, f
        yield f"b8_96_f{f}_bf16", small.to(torch.bfloat16), f
        yield f"hw_96_f{f}", small[3], f
    yield "odd_60x36x5_f3", torch.randn((2, 60, 36, 5), generator=gen,
                                         device=dev), 3


def phase_kernel_k2(dev):
    """K2 vs its plain version on the same CUDA tensors."""
    from repro_torch.kernels import frame_preproc as FP
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, before = {}, FP.LAUNCHES
    for name, frames, f in _k2_cases(dev, gen):
        got = FP.downsample(frames, f)
        sync()
        want = FP.downsample_ref(frames, f)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K2 {name}: {got.shape} {got.dtype} vs "
                                 f"{want.shape} {want.dtype}")
        err, tol = _max_err(got, want), k2_tolerance(want, frames, f)
        if not err <= tol:
            raise AssertionError(f"K2 {name}: max error {err} > {tol}")
        errs[name] = err
    emit("kernel_k2", cases=len(errs), launches=FP.LAUNCHES - before,
         max_abs_err=errs)
    return max(errs.values())


def _k3_cases():
    """(B, Sq, Skv, H, G, D, causal, window); every row sees a key."""
    yield 2, 2048, 2048, 16, 16, 64, True, None       # serve prefill
    yield 2, 300, 300, 8, 2, 64, True, None           # GQA, ragged
    yield 2, 200, 333, 4, 4, 16, False, None          # Sq != Skv
    yield 1, 130, 197, 4, 2, 64, True, None           # causal, Sq < Skv
    yield 1, 500, 500, 8, 4, 64, True, 32             # window 32
    yield 1, 1000, 1000, 4, 2, 64, True, 256          # window 256
    yield 2, 100, 160, 4, 4, 64, True, 40             # window, Sq < Skv
    yield 4, 77, 77, 4, 4, 12, False, 32              # window, not causal
    yield 3, 130, 130, 4, 1, 128, True, None          # MQA, D = 128
    yield 30, 16, 16, 4, 4, 8, True, None             # Transform sizes
    yield 15, 16, 16, 4, 4, 12, True, None
    yield 8, 16, 16, 4, 4, 16, True, None
    yield 2, 1, 9, 4, 4, 64, False, None              # one query
    yield 1, 300, 333, 4, 2, 128, True, 100           # D = 128, ragged window
    yield 4, 2048, 2048, 25, 5, 64, True, 1024        # hymba-1.5b, window
    yield 4, 2048, 2048, 25, 5, 64, True, None        # hymba-1.5b, global
    yield 4, 2048, 2048, 32, 8, 128, True, 4096       # mixtral-8x7b


K3_STRESS = (1, 256, 256, 4, 2, 64, True, None)     # |q|, |k| up to 8
# bfloat16 q, k, v (the models' default compute dtype), the bfloat16
# kernel: the serve prefill, hymba-1.5b's windowed and global prefill,
# mixtral-8x7b's prefill, qwen1.5-110b's local prefill at (1, 4) (two
# warpgroups at D = 128), GQA, windows, D = 128 (ragged Skv with B > 1:
# TMA's zero fill must stay in its batch row), the Transform's D = 8
# (cp.async), D = 12 (through registers; also at G = 1), one query against
# 1,500 keys; a trailing "shift" starts q, k and v one value past an
# aligned base (no TMA, no 16-byte loads), "lse" runs the forward with
# its log-sum-exp, held to lse_error_bound
K3_BF16_CASES = (
    (2, 2048, 2048, 16, 16, 64, True, None),
    (4, 2048, 2048, 25, 5, 64, True, 1024),
    (4, 2048, 2048, 25, 5, 64, True, None),
    (4, 2048, 2048, 32, 8, 128, True, 4096),
    (4, 2048, 2048, 16, 2, 128, True, None),
    (2, 300, 300, 8, 2, 64, True, None),
    (1, 500, 500, 8, 4, 64, True, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (3, 300, 157, 4, 2, 128, False, None),
    (30, 16, 16, 4, 4, 8, True, None),
    (4, 77, 77, 4, 4, 12, False, 32),
    (2, 90, 90, 4, 1, 12, True, None),
    (2, 1, 9, 4, 4, 64, False, None),
    (4, 1, 1500, 20, 20, 64, False, None),
    (2, 100, 120, 4, 2, 64, True, None, "shift"),
    (2, 300, 333, 8, 2, 128, True, 100, "lse"),
)


def phase_kernel_k3(dev):
    """K3 vs its plain version on the same CUDA tensors."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(3)
    errs, before = {}, FA.LAUNCHES
    for case in [*_k3_cases(), K3_STRESS + ("stress",)]:
        B, Sq, Skv, H, G, D, causal, window = case[:8]
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        k = torch.randn((B, Skv, G, D), generator=gen, device=dev)
        v = torch.randn((B, Skv, G, D), generator=gen, device=dev)
        if case[8:]:
            q = 16 * torch.rand(q.shape, generator=gen, device=dev) - 8
            k = 16 * torch.rand(k.shape, generator=gen, device=dev) - 8
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        sync()
        want = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
        name = (f"B{B}_Sq{Sq}_Skv{Skv}_H{H}_G{G}_D{D}"
                f"{'_causal' if causal else ''}"
                f"{f'_w{window}' if window else ''}"
                f"{'_stress' if case[8:] else ''}")
        err = _max_err(got, want)
        bound = FA.error_bound(q, k, v, causal=causal, window=window)
        ratio = float(((got - want).abs() / bound).max())
        if not ratio <= 1.0:
            raise AssertionError(f"K3 {name}: max error {err}, "
                                 f"{ratio:.3g}x error_bound")
        errs[name] = {"err": err, "of_bound": ratio}
        del q, k, v, got, want, bound
    bf16_errs, bf16_before = {}, FA.BF16_LAUNCHES
    for B, Sq, Skv, H, G, D, causal, window, *extra in K3_BF16_CASES:
        shift = 1 if "shift" in extra else 0
        q, k, v = (torch.randn(math.prod(shape) + shift, generator=gen,
                               device=dev).to(torch.bfloat16)[shift:]
                   .view(shape) for shape in
                   ((B, Sq, H, D), (B, Skv, G, D), (B, Skv, G, D)))
        if "lse" in extra:
            got, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                                  window=window)
        else:
            got = FA.flash_attention(q, k, v, causal=causal, window=window)
        sync()
        want = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal, window=window)
        name = (f"B{B}_Sq{Sq}_Skv{Skv}_H{H}_G{G}_D{D}"
                f"{'_causal' if causal else ''}"
                f"{f'_w{window}' if window else ''}_bf16"
                + "".join(f"_{e}" for e in extra))
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"K3 {name}: output in {got.dtype}")
        err = _max_err(got, want)
        bound = FA.error_bound(q, k, v, causal=causal, window=window,
                               ref=want)
        ratio = float(((got.float() - want).abs() / bound).max())
        if not ratio <= 1.0:
            raise AssertionError(f"K3 {name}: max error {err}, "
                                 f"{ratio:.3g}x error_bound")
        bf16_errs[name] = {"err": err, "of_bound": ratio,
                           "launch": FA.bf16_launch_shape(q, k, v)}
        if "lse" in extra:
            l64 = FA.lse_ref(q.double(), k.double(), causal=causal,
                             window=window)
            lb = FA.lse_error_bound(q.float(), k.float(), l64,
                                    causal=causal, window=window)
            fin = torch.isfinite(l64)
            lse_ratio = float(((lse.double() - l64).abs()[fin]
                               / lb[fin]).max())
            if not (torch.equal(fin, torch.isfinite(lse))
                    and lse_ratio <= 1.0):
                raise AssertionError(f"K3 {name}: log-sum-exp "
                                     f"{lse_ratio:.3g}x lse_error_bound")
            bf16_errs[name]["lse_of_bound"] = lse_ratio
        del q, k, v, got, want, bound
    if FA.BF16_LAUNCHES - bf16_before != len(K3_BF16_CASES):
        raise AssertionError(f"K3: {FA.BF16_LAUNCHES - bf16_before} of "
                             f"{len(K3_BF16_CASES)} bfloat16 cases took "
                             "the bfloat16 kernel")
    emit("kernel_k3", cases=len(errs) + len(bf16_errs),
         launches=FA.LAUNCHES - before, max_abs_err={**errs, **bf16_errs})
    return (max(e["err"] for e in errs.values()),
            max(e["err"] for e in bf16_errs.values()))


def _k3_bwd_cases():
    """(B, Sq, Skv, H, G, D, causal, window, shift): the training shapes
    of the K3 models, rows that see no key, inputs whose rows take no
    16-byte copies, and ``_k3_cases``' uneven shapes; q, k, v and dO
    start ``shift`` values past an aligned base (0 where not given)."""
    yield 4, 2048, 2048, 16, 16, 64, True, None       # qwen1.5-0.5b train
    yield 4, 2048, 2048, 25, 5, 64, True, 1024        # hymba-1.5b, window
    yield 4, 2048, 2048, 25, 5, 64, True, None        # hymba-1.5b, global
    yield 4, 2048, 2048, 32, 8, 128, True, 4096       # mixtral-8x7b
    yield 4, 1500, 1500, 20, 20, 64, False, None      # whisper encoder
    yield 4, 440, 1500, 20, 20, 64, False, None       # whisper cross
    yield 1, 90, 20, 2, 1, 32, False, 8               # rows 27.. see no key
    yield 1, 70, 50, 4, 2, 10, True, None             # D = 10
    yield 2, 100, 120, 4, 2, 64, True, None, 1        # bases off 16 bytes
    for case in _k3_cases():
        if case[1] != 2048:
            yield case


def _ratio(err, bound):
    """The largest err / bound, 0 where both are 0 (a row that sees no
    key: no gradient on either side)."""
    return float(torch.where(err == 0, torch.zeros_like(err),
                             err / bound).max())


def _k3_bwd_fd(FA, dev):
    """The float32 kernel's gradient, through ``flash_attention`` as a
    model takes it, against central differences of the plain forward in
    float64 at a tiny shape, along 4 random directions: |finite
    difference - <grad, direction>| within 1e-5 of sum |grad| |direction|
    (the kernel's float32 sums over at most 24 terms are about 1e-6 of
    it; the float64 difference with step 1e-4 is off by about 1e-8)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = ((1, 24, 4, 16), (1, 24, 2, 16), (1, 24, 2, 16))
    x = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    w = torch.randn(shapes[0], generator=gen, device=dev)
    t = [a.clone().requires_grad_(True) for a in x]
    o = FA.flash_attention(*t, causal=True, window=10)
    grads = torch.autograd.grad((o * w).sum(), t)
    x64 = [a.double() for a in x]

    def f(xs):
        return float((FA.flash_attention_ref(*xs, causal=True, window=10)
                      * w.double()).sum())
    worst, eps = 0.0, 1e-4
    for _ in range(4):
        d = [torch.randn(a.shape, generator=gen, device=dev).double()
             for a in x]
        fd = (f([a + eps * b for a, b in zip(x64, d)])
              - f([a - eps * b for a, b in zip(x64, d)])) / (2 * eps)
        an = sum(float((g.double() * b).sum()) for g, b in zip(grads, d))
        mag = sum(float((g.double().abs() * b.abs()).sum())
                  for g, b in zip(grads, d))
        worst = max(worst, abs(fd - an) / mag)
    if not worst <= 1e-5:
        raise AssertionError(f"K3 backward: finite differences off by "
                             f"{worst:.3g} of sum |grad||direction|")
    return worst


def phase_kernel_k3_bwd(dev):
    """K3's backward against its plain version ``flash_attention_bwd_ref``
    run in float64 on the same CUDA tensors (q, k, v, dO and the
    forward's o and log-sum-exp), within ``bwd_error_bound``, float32 and
    bfloat16 (bfloat16: on the widened inputs, the rounding of dq, dk and
    dv added); the forward's log-sum-exp against ``lse_ref`` in float64
    within ``lse_error_bound`` (+inf exactly where a row sees no key);
    each case launched twice, the same bits both times (no atomics); then
    one finite-difference check of the float32 gradient."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(12)
    errs, before = {}, FA.BWD_LAUNCHES
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, G, D, causal, window, *sh in _k3_bwd_cases():
            shift = sh[0] if sh else 0

            def randn(shape, shift=shift, dtype=dtype):
                n = int(np.prod(shape))
                return torch.randn(n + shift, generator=gen, device=dev) \
                    .to(dtype)[shift:].view(shape)
            q, do = randn((B, Sq, H, D)), randn((B, Sq, H, D))
            k, v = randn((B, Skv, G, D)), randn((B, Skv, G, D))
            o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                                window=window)
            got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window)
            again = FA.flash_attention_bwd(q, k, v, o, do, lse,
                                           causal=causal, window=window)
            sync()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            name = (f"B{B}_Sq{Sq}_Skv{Skv}_H{H}_G{G}_D{D}"
                    f"{'_causal' if causal else ''}"
                    f"{f'_w{window}' if window else ''}"
                    f"{f'_shift{shift}' if shift else ''}"
                    f"{'_bf16' if dtype == torch.bfloat16 else ''}")
            l64 = FA.lse_ref(q.double(), k.double(), causal=causal,
                             window=window)
            fin = torch.isfinite(l64)
            if not bool((torch.isinf(lse) == ~fin).all()):
                raise AssertionError(f"K3 {name}: lse is not +inf exactly "
                                     f"where a row sees no key")
            lse_ratio = _ratio((lse.double() - l64).abs().where(fin, 0.0),
                               FA.lse_error_bound(q.float(), k.float(), l64,
                                                  causal=causal,
                                                  window=window))
            want = FA.flash_attention_bwd_ref(
                *(x.double() for x in (q, k, v, o, do)), lse.double(),
                causal=causal, window=window)
            bound = FA.bwd_error_bound(
                q.float(), k.float(), v.float(), o.float(), do.float(), lse,
                causal=causal, window=window,
                refs=want if dtype == torch.bfloat16 else None)
            ratios = [_ratio((a.double() - b).abs(), c)
                      for a, b, c in zip(got, want, bound)]
            err = max(float((a.double() - b).abs().max())
                      for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            if not (finite and same and lse_ratio <= 1.0
                    and max(ratios) <= 1.0) \
                    or any(a.dtype != dtype for a in got):
                raise AssertionError(
                    f"K3 backward {name}: finite={finite} same bits on a "
                    f"second launch={same} lse {lse_ratio:.3g}x its bound, "
                    f"dq dk dv {[round(r, 4) for r in ratios]}x "
                    f"bwd_error_bound")
            errs[name] = {"err": err, "of_bound": max(ratios),
                          "lse_of_bound": lse_ratio}
            del q, k, v, do, o, lse, got, want, bound, l64
    fd = _k3_bwd_fd(FA, dev)
    emit("kernel_k3_bwd", cases=len(errs),
         launches=FA.BWD_LAUNCHES - before, finite_difference=fd,
         phase_s=time.perf_counter() - t0, max_abs_err=errs)
    return max(e["err"] for e in errs.values())


def _k4_cases():
    """(B, S, H, P, G, N, chunk, init_state)."""
    yield SSD_TIME + (False,)                        # serve prefill
    yield HYMBA_SSD + (False,)                       # hymba-1.5b's prefill
    yield 2, 2048, 32, 64, 1, 128, 256, True         # with a state in
    yield 2, 1000, 8, 64, 1, 128, 256, False         # S % Q != 0
    yield 2, 100, 8, 64, 2, 128, 256, True           # S < Q, G > 1
    yield 1, 777, 12, 16, 4, 16, 64, True            # Q 64, P 16, N 16
    yield 2, 300, 6, 64, 3, 128, 16, False           # Q 16
    yield 1, 513, 4, 64, 1, 16, 256, False
    yield 3, 33, 3, 8, 3, 16, 8, True                # test_kernels' uneven


def _k4_bf16_cases():
    """(B, S, H, P, G, N, chunk, init_state, dt dtype) with bfloat16 x, B
    and C (and state in): the serve prefills of mamba2-370m and
    hymba-1.5b as the model passes them (dt in bfloat16), a state in, S % Q != 0 with dt in float32, G > 1, Q 16, and
    P = 12, N = 20 (no 16-byte loads)."""
    yield SSD_TIME + (False, "bfloat16")
    yield HYMBA_SSD + (False, "bfloat16")
    yield 2, 2048, 32, 64, 1, 128, 256, True, "bfloat16"
    yield 2, 1000, 8, 64, 1, 128, 256, False, "float32"
    yield 2, 100, 8, 64, 2, 128, 256, True, "bfloat16"
    yield 2, 300, 6, 64, 3, 128, 16, False, "bfloat16"
    yield 2, 200, 4, 12, 2, 20, 64, True, "bfloat16"


def ssd_inputs(B, S, H, P, G, N, gen, dev):
    """x, dt, A, Bm, Cm and a state drawn as the model draws them:
    dt = softplus(dt_bias + z) with dt_bias the inverse softplus of
    U[1e-3, 1e-1], A = -U[1, 16] (= -exp(A_log))."""
    import torch.nn.functional as F

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dt_bias = torch.log(torch.expm1(1e-3 + (1e-1 - 1e-3) * rand(H)))
    dt = F.softplus(dt_bias + randn(B, S, H))
    A = -(1.0 + 15.0 * rand(H))
    return (randn(B, S, H, P), dt, A, randn(B, S, G, N), randn(B, S, G, N),
            randn(B, H, P, N) * 0.5)


def phase_kernel_k4(dev):
    """K4 vs its plain version in float64 on the same CUDA tensors, and
    each of its passes vs its own plain version."""
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device=dev).manual_seed(4)
    errs, before = {}, SSD.LAUNCHES
    for B, S, H, P, G, N, chunk, with_init in _k4_cases():
        *args, init = ssd_inputs(B, S, H, P, G, N, gen, dev)
        init = init if with_init else None
        passes = SSD.pass_errors(*args, chunk=chunk, init_state=init)
        y, state = SSD.ssd_scan(*args, chunk=chunk, init_state=init)
        sync()
        want_y, want_state = SSD.ssd_scan_ref(
            *[a.double() for a in args], chunk=chunk,
            init_state=None if init is None else init.double())
        tol_y, tol_state = SSD.error_bound(*args, chunk=chunk,
                                           init_state=init)
        name = (f"B{B}_S{S}_H{H}_P{P}_G{G}_N{N}_Q{chunk}"
                f"{'_init' if with_init else ''}")
        err_y, err_state = _max_err(y.double(), want_y), \
            _max_err(state.double(), want_state)
        if not (err_y <= tol_y and err_state <= tol_state):
            raise AssertionError(f"K4 {name}: max error y {err_y} > {tol_y} "
                                 f"or state {err_state} > {tol_state}")
        bad = {k: v for k, v in passes.items() if not v <= 1.0}
        if bad:
            raise AssertionError(f"K4 {name}: passes beyond their bounds "
                                 f"(shares) {bad}")
        errs[name] = {"y": err_y, "state": err_state, "tol_y": tol_y,
                      "tol_state": tol_state,
                      "of_bound": max(err_y / tol_y, err_state / tol_state),
                      "passes_of_bound": passes}
        del args, init, y, state, want_y, want_state
    for B, S, H, P, G, N, chunk, with_init, dt_type in _k4_bf16_cases():
        x, dt, A, Bm, Cm, init = ssd_inputs(B, S, H, P, G, N, gen, dev)
        bf = torch.bfloat16
        x, Bm, Cm = x.to(bf), Bm.to(bf), Cm.to(bf)
        dt = dt.to(getattr(torch, dt_type))
        init = init.to(bf) if with_init else None
        y, state = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                init_state=init)
        sync()
        wide = [t.float() for t in (x, dt, A, Bm, Cm)]
        init_w = None if init is None else init.float()
        want_y, want_state = SSD.ssd_scan_ref(
            *[t.double() for t in wide], chunk=chunk,
            init_state=None if init_w is None else init_w.double())
        tol_y, tol_state = SSD.error_bound(*wide, chunk=chunk,
                                           init_state=init_w, ref_y=want_y)
        name = (f"B{B}_S{S}_H{H}_P{P}_G{G}_N{N}_Q{chunk}"
                f"{'_init' if with_init else ''}_bf16_dt_{dt_type}")
        if y.dtype != bf or state.dtype != torch.float32:
            raise AssertionError(f"K4 {name}: y {y.dtype}, state "
                                 f"{state.dtype}")
        err_y, err_state = _max_err(y.double(), want_y), \
            _max_err(state.double(), want_state)
        of_y = float(((y.double() - want_y).abs() / tol_y).max())
        if not (of_y <= 1.0 and err_state <= tol_state):
            raise AssertionError(f"K4 {name}: y at {of_y:.3g}x its bound "
                                 f"or state {err_state} > {tol_state}")
        errs[name] = {"y": err_y, "state": err_state,
                      "tol_state": tol_state,
                      "of_bound": max(of_y, err_state / tol_state)}
        del x, dt, A, Bm, Cm, init, wide, y, state, want_y, want_state, tol_y
    emit("kernel_k4", cases=len(errs), launches=SSD.LAUNCHES - before,
         max_of_bound=max(e["of_bound"] for e in errs.values()),
         max_pass_of_bound=max(max(e["passes_of_bound"].values())
                               for e in errs.values()
                               if "passes_of_bound" in e),
         max_abs_err=errs)
    return max(max(e["y"], e["state"]) for e in errs.values())


def _k4_bwd_cases():
    """(B, S, H, P, G, N, chunk, init_state, d(final state), dt dtype or
    None for float32 operands): the training shapes of mamba2-370m and
    hymba-1.5b, S % Q != 0, S < Q, G > 1, G = 1 with R = 25 heads, Q 16
    and 64, P 8 and 12, N 16, 20 and 128, with and without a state in
    and a d(final state); then bfloat16 x, B, C and dy (dt in bfloat16 as
    the model passes it, or float32; a bfloat16 state in)."""
    yield 4, 2048, 32, 64, 1, 128, 256, False, False, None   # mamba2 train
    yield 1, 2048, 25, 64, 1, 16, 256, False, False, None    # hymba train
    yield 2, 1000, 8, 64, 1, 128, 256, True, True, None      # S % Q != 0
    yield 2, 100, 8, 64, 2, 128, 256, True, False, None      # S < Q, G > 1
    yield 1, 777, 25, 64, 1, 16, 64, False, True, None       # R = 25
    yield 2, 300, 6, 64, 3, 128, 16, True, True, None        # Q 16
    yield 2, 200, 4, 12, 2, 20, 64, True, False, None        # P 12, N 20
    yield 3, 33, 3, 8, 3, 16, 8, True, True, None            # uneven
    yield 4, 2048, 32, 64, 1, 128, 256, False, False, "bfloat16"
    yield 1, 2048, 25, 64, 1, 16, 256, False, False, "bfloat16"
    yield 2, 1000, 8, 64, 1, 128, 256, True, True, "float32"
    yield 1, 777, 25, 64, 1, 16, 64, True, True, "bfloat16"
    yield 2, 200, 4, 12, 2, 20, 64, True, False, "bfloat16"


def _k4_bwd_fd(SSD, dev):
    """The float32 kernels' gradient, through ``ssd_scan`` as a model
    takes it (``SsdScanFn``: the forward passes, then the backward
    kernel), against central differences of the plain forward in float64
    at a tiny shape with a state in and both outputs used, along 4 random
    directions: |finite difference - <grad, direction>| within 1e-5 of
    sum |grad| |direction| (the kernels' float32 sums over at most 40
    terms are about 1e-6 of it; the float64 difference with step 1e-4 is
    off by about 1e-8)."""
    gen = torch.Generator(device=dev).manual_seed(15)
    *x, init = ssd_inputs(1, 40, 4, 8, 2, 16, gen, dev)
    x.append(init)
    wy = torch.randn(x[0].shape, generator=gen, device=dev)
    ws = torch.randn(init.shape, generator=gen, device=dev)
    t = [a.clone().requires_grad_(True) for a in x]
    b0 = SSD.BWD_LAUNCHES
    y, state = SSD.ssd_scan(*t[:5], chunk=16, init_state=t[5])
    grads = torch.autograd.grad((y * wy).sum() + (state * ws).sum(), t)
    if SSD.BWD_LAUNCHES != b0 + 1:
        raise AssertionError("K4's gradient did not come from its kernel")
    x64 = [a.double() for a in x]

    def f(xs):
        y, s = SSD.ssd_scan_ref(*xs[:5], chunk=16, init_state=xs[5])
        return float((y * wy.double()).sum() + (s * ws.double()).sum())
    worst, eps = 0.0, 1e-4
    for _ in range(4):
        d = [torch.randn(a.shape, generator=gen, device=dev).double()
             for a in x]
        fd = (f([a + eps * b for a, b in zip(x64, d)])
              - f([a - eps * b for a, b in zip(x64, d)])) / (2 * eps)
        an = sum(float((g.double() * b).sum()) for g, b in zip(grads, d))
        mag = sum(float((g.double().abs() * b.abs()).sum())
                  for g, b in zip(grads, d))
        worst = max(worst, abs(fd - an) / mag)
    if not worst <= 1e-5:
        raise AssertionError(f"K4 backward: finite differences off by "
                             f"{worst:.3g} of sum |grad||direction|")
    return worst


def phase_kernel_k4_bwd(dev):
    """K4's backward (``csrc/ssd_scan_bwd.cu``, its nine passes) on the
    forward kernels' own scratch against its plain version
    ``ssd_scan_bwd_ref`` run in float64 on the same CUDA tensors, every
    gradient (dx, ddt, dA, dB, dC, d(init_state)) within
    ``bwd_error_bound`` at every element and in its operand's dtype (dA
    float32), each case launched twice, the same bits both times (no
    atomics); then one finite-difference check of the float32 gradient
    (``_k4_bwd_fd``)."""
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device=dev).manual_seed(14)
    errs, before = {}, SSD.BWD_LAUNCHES
    t0 = time.perf_counter()
    names = ("dx", "ddt", "dA", "dB", "dC", "dinit")

    def f64(a):
        return None if a is None else a.double()
    for B, S, H, P, G, N, chunk, with_init, with_dfinal, dt_type in \
            _k4_bwd_cases():
        x, dt, A, Bm, Cm, init = ssd_inputs(B, S, H, P, G, N, gen, dev)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        dfinal = (torch.randn(init.shape, generator=gen, device=dev)
                  if with_dfinal else None)
        init = init if with_init else None
        if dt_type is not None:
            bf = torch.bfloat16
            x, Bm, Cm, dy = (a.to(bf) for a in (x, Bm, Cm, dy))
            dt = dt.to(getattr(torch, dt_type))
            init = None if init is None else init.to(bf)
        _, _, scr = SSD._forward(x, dt, A, Bm, Cm, init, chunk)
        got = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfinal, scr,
                               chunk=chunk, init_state=init)
        again = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfinal, scr,
                                 chunk=chunk, init_state=init)
        sync()
        same = all(a is None or torch.equal(a, b)
                   for a, b in zip(got, again))
        del again, scr
        want = SSD.ssd_scan_bwd_ref(*map(f64, (x, dt, A, Bm, Cm, dy, dfinal)),
                                    chunk=chunk, init_state=f64(init))
        bound = SSD.bwd_error_bound(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                    init_state=init, refs=want)
        ratios = {n: _ratio((g.double() - w).abs(), b)
                  for n, g, w, b in zip(names, got, want, bound)
                  if g is not None}
        dtypes = [x.dtype, dt.dtype, torch.float32, x.dtype, x.dtype,
                  None if init is None else init.dtype]
        ok_types = all((g is None and t is None) or g.dtype == t
                       for g, t in zip(got, dtypes))
        finite = all(bool(torch.isfinite(g).all()) for g in got
                     if g is not None)
        name = (f"B{B}_S{S}_H{H}_P{P}_G{G}_N{N}_Q{chunk}"
                f"{'_init' if with_init else ''}"
                f"{'_dfinal' if with_dfinal else ''}"
                f"{f'_bf16_dt_{dt_type}' if dt_type else ''}")
        if not (finite and same and ok_types
                and max(ratios.values()) <= 1.0):
            raise AssertionError(
                f"K4 backward {name}: finite={finite} same bits on a second "
                f"launch={same} dtypes={ok_types}, of bwd_error_bound "
                f"{ {k: round(v, 4) for k, v in ratios.items()} }")
        errs[name] = {"err": max(float((g.double() - w).abs().max())
                                 for g, w in zip(got, want)
                                 if g is not None),
                      "of_bound": max(ratios.values()),
                      "of_bound_by_gradient": ratios}
        del x, dt, A, Bm, Cm, init, dy, dfinal, got, want, bound
    fd = _k4_bwd_fd(SSD, dev)
    torch.cuda.empty_cache()
    emit("kernel_k4_bwd", cases=len(errs),
         launches=SSD.BWD_LAUNCHES - before, finite_difference=fd,
         max_of_bound=max(e["of_bound"] for e in errs.values()),
         phase_s=time.perf_counter() - t0, max_abs_err=errs)
    return max(e["err"] for e in errs.values())


def main_plans(nw):
    """The main path's plans over a store of ``nw`` 5-minute windows."""
    from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy, TopK,
                                       WindowAgg)
    return {
        # README: the worst five 5-minute windows by mean quality
        "window_topk": (Filter("quality", "ge", 0.6),
                        WindowAgg(window=150, value="quality", agg="mean",
                                  num_windows=nw),
                        TopK(5, by="quality", largest=False)),
        # README standing query: mean quality per content category
        "category_mean": (Filter("quality", "ge", 0.6),
                          GroupBy("category", "quality", agg="mean",
                                  num_groups=4)),
        # window x category over the (T, D) measured-quality vectors
        "window_x_category": (MultiGroupBy(keys=("t", "category"),
                                           value="out", agg="mean",
                                           nums=(nw, 4), windows=(150, 0)),),
        # the peak buffer fill of every camera
        "camera_buffer_peak": (GroupBy("stream_id", "buffer_s", agg="max",
                                       num_groups=CAMERAS),),
        # camera x 5-minute window mean quality, a per-camera heatmap:
        # 73,728 groups, past shared memory
        "camera_x_window": (MultiGroupBy(keys=("stream_id", "t"),
                                         value="quality", agg="mean",
                                         nums=(CAMERAS, nw),
                                         windows=(0, 150)),),
    }


def store_plans(store):
    from repro_torch.warehouse import windows_for
    return main_plans(windows_for(store, WINDOW))


def standing_extra(n_configs):
    """The standing subscription (a camera's cloud spend over the day at
    ALERT_CLOUD_S or more) and the plan registered after the fill
    (on-prem core-seconds per knob configuration over kept segments)."""
    from repro_torch.warehouse import Filter, GroupBy
    sub = (GroupBy("stream_id", "cloud_core_s", agg="sum",
                   num_groups=CAMERAS),)
    late = (Filter("quality", "ge", 0.6),
            GroupBy("k", "on_core_s", agg="sum", num_groups=n_configs))
    return sub, Filter("cloud_core_s", "ge", ALERT_CLOUD_S), late


def plan_modes(store):
    """K1's accumulator mode for each main-path plan."""
    from repro_torch.kernels import warehouse_agg as K
    modes = {}
    for name, plan in store_plans(store).items():
        spec, _, _ = _spec_of(plan, store.columns)
        modes[name] = K.accumulator_mode(spec, _width(store.columns, spec))
    return modes


_RUN_COLUMNS = (("c", "category"), ("k", "k"), ("qual", "quality"),
                ("on_s", "on_core_s"), ("cl_s", "cloud_core_s"),
                ("buffer_s", "buffer_s"))


def fill(store, day, cameras=None):
    """Cameras 1..cameras-1 (CAMERAS by default): camera 0's day
    (``day``, its rows), each on a clock rotated by ROTATE segments more,
    landed as that camera's fused run."""
    for cam in range(1, cameras or CAMERAS):
        r = cam * ROTATE
        traces = {src: day[dst].roll(r) for src, dst in _RUN_COLUMNS}
        store.ingest_fused(traces, day["out"].roll(r, 0), stream_id=cam)


def phase_main(dev):
    """The main path, counted: returns what the checks need. A
    ``StandingQueries`` registry is attached to the store before camera
    0's run, with every main plan and one subscription registered, so
    every ingest folds its rows through K1; after the fill one more plan
    registers (a backfill over every row)."""
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.ingest import run_skyscraper_fused
    from repro_torch.core.offline import fit
    from repro_torch.data.stream import generate
    from repro_torch.kernels import warehouse_agg as K
    from repro_torch.warehouse import SegmentStore, StandingQueries
    from repro_torch.warehouse import query as Q
    from repro_torch.warehouse import standing as ST

    K.LAUNCHES = 0
    Q.PATHS.update(kernel=0, engine=0)
    ST.FOLDS.update(kernel=0, engine=0)
    torch.cuda.reset_peak_memory_stats()
    fitted, fit_s = timed(lambda: fit(COVID, n_cores=8, days_unlabeled=2.0,
                                      device=dev))
    stream = generate(COVID, days=RUN_DAYS, seed=99)
    T = stream.n_segments
    store = SegmentStore(out_dim=len(fitted.configs), device=dev)
    reg = StandingQueries(store)
    plans = main_plans((T - 1) // WINDOW + 1)
    handles = {name: reg.register(plan) for name, plan in plans.items()}
    sub_plan, predicate, late_plan = standing_extra(len(fitted.configs))
    sid = reg.subscribe(sub_plan, predicate, name="cloud_spend")
    kw = dict(n_cores=8, cloud_budget_core_s=15_000.0)
    res, run_s = timed(lambda: run_skyscraper_fused(
        fitted, stream, sink=store, telemetry=True, device=dev, **kw))
    day = {k: v[:T].clone() for k, v in store.columns.items()}
    _, fill_s = timed(lambda: fill(store, day))
    late, backfill_s = timed(lambda: reg.register(late_plan, name="late"))
    alerts = reg.poll()
    fold_launches = K.LAUNCHES          # every K1 launch so far is a fold
    results, query_s = {}, {}
    for name, plan in store_plans(store).items():
        results[name], query_s[name] = timed(lambda p=plan: store.query(p))
    launches, paths, folds = K.LAUNCHES, dict(Q.PATHS), dict(ST.FOLDS)
    query_launches = launches - fold_launches
    peak = torch.cuda.max_memory_allocated()
    modes = plan_modes(store)
    emit("main", segments=T, rows=store.n_rows, capacity=store.capacity,
         fit_s=fit_s, fused_run_s=run_s, fill_s=fill_s, query_s=query_s,
         standing_backfill_s=backfill_s, launches=launches,
         query_launches=query_launches, fold_launches=fold_launches,
         paths=paths, standing_folds=folds, modes=modes, peak_mem_bytes=peak,
         quality_pct=res.quality_pct, cloud_core_s=res.cloud_core_s,
         telemetry=res.telemetry.summary(),
         store_telemetry=store.telemetry().summary(),
         run_alerts=[a.n_fired for a in res.alerts],
         forecast_val_mse=fitted.forecast_metrics["val_mse"])
    if launches == 0:
        raise AssertionError("the main path launched no kernel")
    # the standing folds: one K1 call per registered query and ingest
    # (camera 0's run and the 255 cameras of the fill), and the late
    # plan's backfill
    want_folds = CAMERAS * (len(plans) + 1) + 1
    if folds != {"kernel": want_folds, "engine": 0} \
            or fold_launches != folds["kernel"]:
        raise AssertionError(f"the standing folds did not all take K1 "
                             f"once per query and ingest: {folds}, "
                             f"{fold_launches} launches, {want_folds} "
                             f"expected")
    if paths != {"kernel": len(results), "engine": 0} \
            or query_launches != paths["kernel"]:
        raise AssertionError(f"main-path queries did not all take the "
                             f"kernel: paths={paths} "
                             f"launches={query_launches}")
    if len(res.alerts) != 1 or [a.sub for a in alerts] != [sid]:
        raise AssertionError("the subscription was not polled after the "
                             "fused run and after the fill")
    if set(modes.values()) != {"shared", "global"}:
        raise AssertionError(f"the main path must run both accumulator "
                             f"modes: {modes}")
    if store.n_rows != CAMERAS * T:
        raise AssertionError(f"store holds {store.n_rows} rows")
    handles.update(cloud_spend=reg._subs[sid].handle, late=late)
    return dict(fitted=fitted, stream=stream, store=store, res=res, kw=kw,
                results=results, launches=launches, reg=reg,
                handles=handles, alerts=alerts, fill_s=fill_s, day=day,
                folds=folds["kernel"],
                standing_plans={**plans, "cloud_spend": sub_plan,
                                "late": late_plan})


def phase_check(m):
    from repro_torch.core.ingest import run_skyscraper_fused
    from repro_torch.kernels import warehouse_agg as K

    # --- the card's run against the port's own CPU run ------------------
    res = m["res"]
    cpu, cpu_s = timed(lambda: run_skyscraper_fused(
        m["fitted"].to("cpu"), m["stream"], telemetry=True, device="cpu",
        **m["kw"]))
    if not (np.array_equal(res.k_trace, cpu.k_trace)
            and np.array_equal(res.c_trace, cpu.c_trace)):
        raise AssertionError(
            f"k/c traces differ from the CPU run at "
            f"{int(np.sum(res.k_trace != cpu.k_trace))} steps")
    run_err = 0.0
    for a, b in [(res.buffer_trace, cpu.buffer_trace)] + \
            [(x, y) for p, q in zip(res.plans, cpu.plans)
             for x, y in zip(p, q)]:
        run_err = max(run_err, float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for key in ("quality_sum", "onprem_core_s", "cloud_core_s",
                "buffer_peak_s"):
        np.testing.assert_allclose(getattr(res, key), getattr(cpu, key),
                                   rtol=1e-5)

    # --- the store's rows --------------------------------------------------
    store = m["store"]
    host = store.host_rows()
    T = m["stream"].n_segments
    if not (np.array_equal(host["k"][:T], res.k_trace)
            and np.array_equal(host["category"][:T], res.c_trace)
            and np.array_equal(host["stream_id"][T:2 * T], np.ones(T))):
        raise AssertionError("the store's rows are not the run's")

    # --- every main-path query: kernel vs engine path vs float64 -----------
    errs = {}
    cols = store.columns
    for name, plan in store_plans(store).items():
        table, mask = m["results"][name]
        spec, fvals, filters = _spec_of(plan, cols)
        eng, emask = store.query(plan, use_kernel=False)
        if not torch.equal(mask.cpu(), emask.cpu()):
            raise AssertionError(f"{name}: masks differ from the engine")
        for t in (table, eng):
            for col, x in t.items():
                if not bool(torch.isfinite(x.float()).all()):
                    raise AssertionError(f"{name}: non-finite {col}")
        # the wrapper against its plain version at this query's shape
        got = K.fused_segment_agg(cols, store.n_rows, fvals, spec)
        plain = plain64(K, cols, store.n_rows, fvals, spec)
        acc, cnt, scale = oracle(host, store.n_rows, filters, spec.keys,
                                 spec.value, spec.agg)
        errs[name] = {**hold(name, got, plain, (acc, cnt, scale),
                             spec.agg),
                      "groups": spec.num_groups,
                      "kept_rows": int(cnt.sum())}
        if name == "window_topk":
            k = len(table["window"])
            if k != 5 or not bool(mask.all()):
                raise AssertionError("window_topk must give 5 windows")
            full = (cnt > 0)
            means = np.where(full, acc / np.maximum(cnt, 1), np.inf)
            worst5 = np.sort(means)[:5]
            np.testing.assert_allclose(
                np.sort(table["quality"].double().cpu().numpy()), worst5,
                rtol=FLOAT_TOL)
    tel = check_telemetry(m, res, cpu)
    emit("check", cpu_run_s=cpu_s, run_max_abs_err=run_err,
         traces_equal=True, telemetry=tel, queries=errs)
    return errs


def check_telemetry(m, res, cpu):
    """The card run's flight-recorder counters against ``telemetry_ref``
    of its own traces (camera 0's rows in the store: k, buffer, on-prem
    and cloud seconds; no segment dropped) and against the CPU run's,
    bit for bit, the window snapshots included; and the store's
    counters."""
    from repro_torch.obs import TEL_KEYS, telemetry_ref
    tel, day, T = res.telemetry, m["day"], m["stream"].n_segments
    if tel.dropped != 0.0 or tel.segments != T:
        raise AssertionError(f"telemetry: {tel.summary()}")
    replay = telemetry_ref(
        {"k": day["k"].cpu().numpy(), "dropped": np.zeros(T, np.float32),
         "buffer_s": day["buffer_s"].cpu().numpy(),
         "on_s": day["on_core_s"].cpu().numpy(),
         "cl_s": day["cloud_core_s"].cpu().numpy()},
        int(np.argmax(m["fitted"].power)))
    for key in TEL_KEYS:
        if not (np.array_equal(tel.counters[key], replay[key])
                and np.array_equal(tel.per_window[key],
                                   cpu.telemetry.per_window[key])):
            raise AssertionError(f"telemetry {key}: card "
                                 f"{tel.counters[key]}, replay "
                                 f"{replay[key]}, CPU "
                                 f"{cpu.telemetry.counters[key]}")
    stel = m["store"].telemetry()
    want = dict(n_rows=CAMERAS * T, ingest_dispatches=CAMERAS,
                lag_max_ticks=T - 1, standing_queries=len(
                    m["standing_plans"]),
                standing_refreshes=CAMERAS)
    got = {k: getattr(stel, k) for k in want}
    if got != want:
        raise AssertionError(f"store telemetry {got}, expected {want}")
    return {"counters": {k: float(v) for k, v in tel.counters.items()},
            "windows": len(tel.per_window["seg_total"]),
            "bit_exact_vs_replay_and_cpu": True, "store": stel.summary()}


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``reps`` warm calls of ``fn``, each
    ending in a synchronise: what a caller waits for the result."""
    fn()
    return statistics.median(timed(fn)[1] * 1e3 for _ in range(reps))


def hold_table(name, got, want, node, acc, cnt, scale):
    """A standing answer ``got`` against ``store.query``'s ``want`` (both
    (table, mask)): masks, counts and group keys equal; max and min
    exact; sums and means within 2 FLOAT_TOL of the group's sum of
    magnitudes (per row for a mean), since each is within FLOAT_TOL of
    the float64 oracle; after a TopK, the selected values sorted."""
    (gt, gm), (wt, wm) = got, want
    if not torch.equal(gm.cpu(), wm.cpu()):
        raise AssertionError(f"{name}: masks differ")
    g = {k: v.double().cpu().numpy() for k, v in gt.items()}
    w = {k: v.double().cpu().numpy() for k, v in wt.items()}
    if "index" in g:                        # a TopK after the reducer
        a, b = np.sort(g[node.value]), np.sort(w[node.value])
        if not np.allclose(a, b, rtol=2 * FLOAT_TOL, atol=2e-6):
            raise AssertionError(f"{name}: top values {a} vs {b}")
        return float(np.abs(a - b).max())
    for k in g:
        if k != node.value and not np.array_equal(g[k], w[k]):
            raise AssertionError(f"{name}: column {k} differs")
    if node.agg in ("max", "min", "count"):
        if not np.array_equal(g[node.value], w[node.value]):
            raise AssertionError(f"{name}: {node.agg} not exact")
        return 0.0
    if node.agg == "mean":
        c = np.maximum(cnt, 1)
        scale = scale / (c if scale.ndim == 1 else c[:, None])
    diff = np.abs(g[node.value] - w[node.value])
    if not np.all(diff <= 2 * FLOAT_TOL * scale + 2e-6):
        raise AssertionError(f"{name}: {node.agg} off by "
                             f"{float(diff.max())}")
    return float(diff.max())


def phase_standing(m):
    """Every standing answer against ``store.query`` and against the
    float64 oracle (its accumulators), the subscription's alerts, the
    answer's time against the query's, and the fill's time with and
    without a registry attached (bare, registry, registry, bare)."""
    from repro_torch.warehouse import SegmentStore, StandingQueries
    from repro_torch.warehouse import query as Q
    store, reg = m["store"], m["reg"]
    host, n, cols = store.host_rows(), store.n_rows, store.columns
    per = {}
    for name, plan in m["standing_plans"].items():
        h = m["handles"][name]
        q = reg._queries[h]
        g = reg._group_of(q)
        state = {k: v[q.slot] for k, v in g.state.items()}
        spec, fvals, filters = _spec_of(plan, cols)
        acc, cnt, scale = oracle(host, n, filters, spec.keys, spec.value,
                                 spec.agg)
        err_f64 = check_partial(f"standing {name} vs float64",
                                host_partial(state), (acc, cnt), spec.agg,
                                FLOAT_TOL * scale + 1e-6)
        _, node, _ = Q.split_plan(plan)
        want = m["results"].get(name) or store.query(plan)
        err_q = hold_table(f"standing {name} vs query", reg.answer(h), want,
                           node, acc, cnt, scale)
        per[name] = {"groups": spec.num_groups, "agg": spec.agg,
                     "vs_f64": err_f64, "vs_query": err_q,
                     "answer_ms": wall_ms(lambda: reg.answer(h), 20),
                     "query_ms": wall_ms(lambda: store.query(plan), 20)}
    # the subscription: fired where the answer's spend reaches the mark
    (alert,) = m["alerts"]
    sub = reg._subs[alert.sub]
    spend = alert.table["cloud_core_s"].astype(np.float64)
    if not np.array_equal(alert.fired, (alert.table["count"] > 0)
                          & (spend >= sub.predicate.value)):
        raise AssertionError("the alert mask is not the predicate's")

    day, T = m["day"], m["stream"].n_segments

    def fresh(with_registry):
        s = SegmentStore(out_dim=store.out_dim, device=store.device)
        s.ingest_fused({src: day[dst] for src, dst in _RUN_COLUMNS},
                       day["out"], stream_id=0)
        if with_registry:
            r = StandingQueries(s)
            for name, plan in m["standing_plans"].items():
                if name != "late":
                    r.register(plan)
        _, secs = timed(lambda: fill(s, day))
        if s.n_rows != CAMERAS * T:
            raise AssertionError("the timed fill landed the wrong rows")
        del s
        torch.cuda.empty_cache()
        return secs

    turns = [fresh(w) for w in (False, True, True, False)]
    bare = statistics.mean(turns[0::3])
    folded = statistics.mean(turns[1:3])
    emit("standing", queries=per, plans=len(per),
         fold_launches=m["folds"], alerts_fired=alert.n_fired,
         alerts_checked=store.obs["alerts_checked"],
         standing_refreshes=store.obs["standing_refreshes"],
         main_fill_s=m["fill_s"], fill_turns_s=turns,
         fill_bare_s=bare, fill_registry_s=folded,
         fold_s_per_ingest=(folded - bare) / (CAMERAS - 1))
    return per


def _all_kernels():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import frame_preproc as FP
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import warehouse_agg as K
    return {"fused_segment_agg": K, "downsample": FP,
            "flash_attention": FA, "ssd_scan": SSD}


def phase_compare(dev, m):
    """The paper's comparisons (Fig. 4 / Table 2, §5.3, ablation 2c) on
    the main fit and camera 0's day (43,200 segments, seed 99), every
    kernel's count set to 0 just before and read just after (none is on
    this path: no sink): the per-window loop ``run_skyscraper`` at
    ``plan_days`` 0.25 (4 windows; forecast, LP and window runs on the
    card) with the main run's cloud budget, Static at
    ``best_static_config``, VideoStorm-like, Chameleon* (the baselines
    host numpy, without cloud budget, as ``benchmarks/cost_quality.py``
    runs them) and ``run_optimum`` (its LP at 43,200 rows on the card).
    One line per method: quality, core-s on-prem and in the cloud, the
    buffer's peak, overflow and dollars as ``benchmarks/cost_quality.py``
    reckons them (8 cores at the server grid's price over the stream's
    hours, less the on-prem discount, plus the cloud core-s). Held: the
    loop's k and c traces and ``k_hist`` equal to the same call on the
    card machine's CPU, its sums within 1e-5; the optimum's ``k_hist``
    equal to the CPU's; Skyscraper's buffer peak within the buffer, its
    cloud spend within the budget, and no overflow."""
    from repro_torch.configs.workloads import (CLOUD_COST_PER_CORE_S,
                                               ONPREM_DISCOUNT, SERVER_GRID)
    from repro_torch.core import ingest as IG

    fitted, stream = m["fitted"], m["stream"]
    cores, budget = m["kw"]["n_cores"], m["kw"]["cloud_budget_core_s"]
    kw = dict(n_cores=cores, cloud_budget_core_s=budget)
    kernels = _all_kernels()
    _zero(kernels)
    k_static = IG.best_static_config(fitted, cores)
    drive = {
        "skyscraper": lambda: IG.run_skyscraper(
            fitted, stream, plan_days=COMPARE_PLAN_DAYS, device=dev, **kw),
        "static": lambda: IG.run_static(fitted, stream, k_static,
                                        n_cores=cores),
        "videostorm": lambda: IG.run_videostorm_like(fitted, stream,
                                                     n_cores=cores),
        "chameleon*": lambda: IG.run_chameleon_star(fitted, stream,
                                                    n_cores=cores),
        "optimum": lambda: IG.run_optimum(fitted, stream, device=dev, **kw),
    }
    runs, secs = {}, {}
    for name, fn in drive.items():
        runs[name], secs[name] = timed(fn)
    launches = _counts(kernels)
    cpu_fit = fitted.to("cpu")
    sky_cpu, cpu_s = timed(lambda: IG.run_skyscraper(
        cpu_fit, stream, plan_days=COMPARE_PLAN_DAYS, device="cpu", **kw))
    opt_cpu, opt_cpu_s = timed(lambda: IG.run_optimum(
        cpu_fit, stream, device="cpu", **kw))

    tau = fitted.workload.segment_seconds
    hours = stream.n_segments * tau / 3600
    server_usd = dict(SERVER_GRID)[cores] * hours / ONPREM_DISCOUNT
    for name, res in runs.items():
        cloud_usd = res.cloud_core_s * CLOUD_COST_PER_CORE_S
        emit("compare", method=name, quality_pct=res.quality_pct,
             onprem_core_s=res.onprem_core_s, cloud_core_s=res.cloud_core_s,
             buffer_peak_s=res.buffer_peak_s, overflow=res.overflow,
             server_usd=server_usd, cloud_usd=cloud_usd,
             usd=server_usd + cloud_usd, seconds=secs[name],
             k_hist=res.k_hist.tolist())

    sky, cap_s = runs["skyscraper"], 4.0 * 1e9 / 90e3
    if not (np.array_equal(sky.k_trace, sky_cpu.k_trace)
            and np.array_equal(sky.c_trace, sky_cpu.c_trace)
            and np.array_equal(sky.k_hist, sky_cpu.k_hist)):
        raise AssertionError(
            f"the loop's traces differ from the CPU run at "
            f"{int(np.sum(sky.k_trace != sky_cpu.k_trace))} steps")
    for key in ("quality_sum", "onprem_core_s", "cloud_core_s",
                "buffer_peak_s"):
        np.testing.assert_allclose(getattr(sky, key), getattr(sky_cpu, key),
                                   rtol=1e-5)
    if not np.array_equal(runs["optimum"].k_hist, opt_cpu.k_hist):
        raise AssertionError("the optimum's selection differs from the "
                             "CPU's")
    if sky.overflow or not sky.buffer_peak_s <= cap_s + 1e-3 \
            or not sky.cloud_core_s <= budget + 1e-3:
        raise AssertionError(f"Skyscraper broke its guarantee: overflow="
                             f"{sky.overflow} peak={sky.buffer_peak_s} "
                             f"cloud={sky.cloud_core_s}")
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the comparisons' path: "
                             f"{launches}")
    emit("compare_check", segments=stream.n_segments,
         windows=len(sky.plans), loop_s=secs["skyscraper"],
         loop_ms_per_step=secs["skyscraper"] / stream.n_segments * 1e3,
         cpu_loop_s=cpu_s, optimum_s=secs["optimum"],
         cpu_optimum_s=opt_cpu_s, traces_equal=True,
         buffer_cap_s=cap_s, cloud_budget_core_s=budget,
         launches=launches, static_config=k_static)
    return {"runs": runs, "seconds": secs}


def _segments(n, seed, dev):
    """n Transform segments made on the card from one seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{"frames": torch.randn(SEGMENT, generator=gen, device=dev),
             "tokens": torch.randint(0, 200, TOKENS, generator=gen,
                                     device=dev)} for _ in range(n)]


def _skyscraper(dev):
    """The handle of ``examples/serve_vetl.py``: its resources and knob
    domains."""
    from repro_torch.core.api import Skyscraper
    sky = Skyscraper(segment_seconds=1.0, n_categories=3, device=dev)
    sky.set_resources(num_cores=2, buffer_gb=0.5)
    sky.register_knob("sample_every", [1, 2, 4])
    sky.register_knob("resolution", [1, 2])
    sky.register_knob("model_size", ["small", "medium", "large"])
    return sky


def phase_transform(dev):
    """The Transform path, counted: fit + 60 process calls."""
    from repro_torch.core.vetl_serving import BackboneVETL
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import frame_preproc as FP

    job = BackboneVETL(arch="qwen1.5-0.5b", device=dev)
    unlabeled = _segments(FIT_SEGMENTS, 11, dev)
    FP.LAUNCHES = FA.LAUNCHES = 0
    sky, fit_s = timed(lambda: _skyscraper(dev).fit(
        unlabeled, job.proc_fn, plan_segments=25))
    del unlabeled
    proc_s = [0.0]

    def proc_fn(segment, knobs):
        t0 = time.perf_counter()
        out = job.proc_fn(segment, knobs)       # ends in a host read
        proc_s[0] += time.perf_counter() - t0
        return out

    sky.proc_fn = proc_fn
    trace, process_s = [], 0.0
    gen = torch.Generator(device=dev).manual_seed(12)
    for _ in range(PROCESS_SEGMENTS):
        seg = {"frames": torch.randn(SEGMENT, generator=gen, device=dev),
               "tokens": torch.randint(0, 200, TOKENS, generator=gen,
                                       device=dev)}
        sync()
        (info, out), secs = timed(lambda: sky.process(seg))
        process_s += secs
        # the check reads the tokens; one frame keeps the trace small
        trace.append((info, {"frames": seg["frames"][:1].clone(),
                             "tokens": seg["tokens"]}))
    launches = {"downsample": FP.LAUNCHES, "flash_attention": FA.LAUNCHES}
    sizes = [info["config"]["model_size"] for info, _ in trace]
    emit("transform", fit_s=fit_s, process_s=process_s,
         proc_fn_share=proc_s[0] / process_s, launches=launches,
         configs=len(sky.configs), cost_core_s=sky.cost.tolist(),
         model_sizes={v: sizes.count(v) for v in sorted(set(sizes))},
         resolutions=[info["config"]["resolution"] for info, _ in trace],
         mean_quality=float(np.mean([i["quality"] for i, _ in trace])))
    if min(launches.values()) == 0:
        raise AssertionError(f"the Transform path missed a kernel: "
                             f"{launches}")
    return dict(job=job, trace=trace, launches=launches, sky=sky)


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def phase_transform_check(t):
    """Each process call's quality against the same job on the CPU,
    where K3 is its plain version. The quality reads the tokens only, so
    the CPU job gets one frame at resolution 1 (K2 is held against its
    plain version in phase kernel_k2)."""
    from repro_torch.core.vetl_serving import BackboneVETL
    cpu = BackboneVETL(arch="qwen1.5-0.5b", device="cpu")
    for name, (model, params) in t["job"].models.items():
        cpu.models[name] = (model, _tree_to(params, "cpu"))
    err = 0.0
    for info, seg in t["trace"]:
        one_frame = {k: v.cpu() for k, v in seg.items()}
        _, q = cpu.proc_fn(one_frame, {**info["config"], "resolution": 1})
        err = max(err, abs(q - info["quality"]))
        if not (0.0 < info["quality"] <= 1.0 and abs(q - info["quality"])
                <= QUALITY_TOL):
            raise AssertionError(f"Transform quality {info['quality']} vs "
                                 f"CPU {q}")
    emit("transform_check", segments=len(t["trace"]), max_abs_err=err)
    return err


class plain_attention:
    """Within the block, the model's attention calls K3's plain version
    on the card instead of the kernel (the serve check's comparison)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models import attention as A
        self._kernel = A.flash_attention
        A.flash_attention = FA.flash_attention_ref

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        A.flash_attention = self._kernel


class plain_ssd:
    """Within the block, the model's SSD scan calls K4's plain version on
    the card instead of the kernel (the serve_ssm check's comparison)."""

    def __enter__(self):
        from repro_torch.kernels import ssd as SSD
        from repro_torch.models import ssd as S
        self._kernel = S.ssd_scan
        S.ssd_scan = SSD.ssd_scan_ref

    def __exit__(self, *exc):
        from repro_torch.models import ssd as S
        S.ssd_scan = self._kernel


class plain_hybrid:
    """Both swaps at once: the hybrid's attention and SSD branches on
    their plain versions (the serve_hybrid check's comparison)."""

    def __enter__(self):
        self._parts = (plain_attention(), plain_ssd())
        for part in self._parts:
            part.__enter__()

    def __exit__(self, *exc):
        for part in reversed(self._parts):
            part.__exit__(*exc)


def _inputs(toks):
    """The batch ``Model`` takes: the prompts ``toks``, or a dict that
    holds them already (whisper's ``{"frames", "tokens"}``)."""
    return toks if isinstance(toks, dict) else {"tokens": toks}


def first_batch(corpus, params):
    """The serve loop's first batch of prompts, on the params' device."""
    return torch.as_tensor(corpus.batch(SERVE["batch"], SERVE["prompt_len"],
                                        0), device=params["embed"].device)


def routed(model, params, toks, pinned=None):
    """The logits of the prompts ``toks`` and each MoE layer's expert
    choices, (B, S, K) indices a layer; with ``pinned`` (such a list)
    every layer's router takes those choices instead, its gates its own
    probabilities at them."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def hook(probs, k):
        if pinned is None:
            vals, idx = route(probs, k)
        else:
            idx = pinned[len(seen)]
            vals = torch.gather(probs, -1, idx)
        seen.append(idx)
        return vals, idx

    moe.route = hook
    try:
        logits = model.forward_logits(params, _inputs(toks))
    finally:
        moe.route = route
    return logits, seen


def logit_pair(model, params, toks, plain):
    """The logits of the prompts ``toks`` through the kernels and inside
    ``plain`` (a block that swaps a kernel for its plain version). For a
    MoE model the plain run takes the kernel run's expert choices: a
    router's top-k is a discrete choice that a last-bit change can flip,
    moving a token's FFN output by a whole expert's, so the pair is
    compared where only the kernels differ. Then also the plain run's
    free-running logits (their max difference) and each layer's share of
    tokens whose experts agree free-running."""
    if model.cfg.moe is None:
        logits = model.forward_logits(params, _inputs(toks))
        with plain():
            ref = model.forward_logits(params, _inputs(toks))
        return logits, ref, {}
    logits, routes = routed(model, params, toks)
    with plain():
        ref, _ = routed(model, params, toks, pinned=routes)
        free, free_routes = routed(model, params, toks)
    err_free = float((logits.float() - free.float()).abs().max())
    del free
    same = [float((a.sort(-1).values == b.sort(-1).values).all(-1)
                  .float().mean()) for a, b in zip(routes, free_routes)]
    return logits, ref, {"logits_free_max_abs_err": err_free,
                         "route_agreement": same}


def serve_check(cfg, model, params, toks, plain):
    """The logits of the prompts ``toks`` against the same model inside
    ``plain`` (``logit_pair``): the max error, the largest |logit|, the
    share of equal next tokens and, for a MoE model, the free-running
    comparison; raise past LOGIT_TOL, below TOKEN_AGREEMENT or, for a
    MoE model, below ROUTE_AGREEMENT in a layer."""
    with torch.no_grad():
        logits, ref, extra = logit_pair(model, params, toks, plain)
        k_next = logits.argmax(-1)
        finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        err = float((logits - ref).abs().max())
        scale = float(ref[..., :cfg.vocab].abs().max())
        agree = float((k_next == ref.argmax(-1)).float().mean())
    del logits, ref
    routes_ok = min(extra.get("route_agreement", [1.0])) >= ROUTE_AGREEMENT
    if not finite or not err <= LOGIT_TOL or agree < TOKEN_AGREEMENT \
            or not routes_ok:
        raise AssertionError(f"{cfg.name} logits: finite={finite} err={err} "
                             f"agreement={agree} {extra}")
    return err, scale, agree, extra


def _counts(kernels):
    """The launches of each of ``kernels`` ({name: wrapper module}), K3's
    windowed ones also apart."""
    out = {name: k.LAUNCHES for name, k in kernels.items()}
    if "flash_attention" in kernels:
        out["flash_attention_window"] = kernels[
            "flash_attention"].WINDOW_LAUNCHES
    return out


def _zero(kernels):
    for k in kernels.values():
        k.LAUNCHES = 0
        if hasattr(k, "WINDOW_LAUNCHES"):
            k.WINDOW_LAUNCHES = 0
        if hasattr(k, "BF16_LAUNCHES"):
            k.BF16_LAUNCHES = 0


def _bf16_k3(kernels, launches, what):
    """K3's launches of a bfloat16 run (its count set to 0 with the
    others just before), each of which must have taken the bfloat16
    kernel (``csrc/flash_attention_bf16.cu``): the count, 0 without K3."""
    if "flash_attention" not in kernels:
        return 0
    n = kernels["flash_attention"].BF16_LAUNCHES
    if n != launches["flash_attention"]:
        raise AssertionError(f"{what}: {n} of {launches['flash_attention']} "
                             f"K3 launches took the bfloat16 kernel")
    return n


def serve_bf16(cfg, params, toks, plain, kernels, want, sv=SERVE):
    """The same model at the default RunOptions (bfloat16 compute): one
    warm prefill of the prompts ``toks``, counted (the ``kernels``'
    launches set to 0 just before it, held to ``want``) and timed, then
    decode steps from its cache (tokens in the vocabulary), then the
    prefill with the plain version (``plain``); the logits against the
    plain-version model's, on the card in bfloat16, within
    ``bf16_logit_tolerance`` of ``bf16_boundaries`` (a MoE model's plain
    run on the kernel run's expert choices: ``logit_pair``). An
    encoder-decoder model's ``forward_logits`` leaves its float32 weights
    uncast, as the reference's does, so its logits are taken from the
    weights cast as its prefill casts them: the prefill's bfloat16
    arithmetic, K3 on bfloat16 operands. ``sv`` gives the prompt and
    generation lengths."""
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.models.options import (RunOptions, bf16_boundaries,
                                            bf16_logit_tolerance)
    model = Model(cfg, RunOptions())
    if model.opts.compute_dtype != "bfloat16":
        raise AssertionError("the default compute dtype is not bfloat16")
    batch = _inputs(toks)
    n_req = batch["tokens"].shape[0]

    def prefill(keep=None):
        nxt, cache = model.prefill(params, batch, cache_len=sv[
            "prompt_len"] + sv["gen"])
        if keep is not None:
            keep.append(cache)
        return nxt.cpu()

    def decode(nxt, cache):
        out = [nxt]
        for _ in range(sv["gen"] - 1):
            nxt, cache = model.decode_step(params, cache, nxt)
            out.append(nxt)
        return torch.stack(out, 1).cpu()

    with torch.no_grad():
        prefill()
        _zero(kernels)
        caches = []
        nxt, prefill_s = timed(lambda: prefill(caches))
        launches = _counts(kernels)
        k3_bf16 = _bf16_k3(kernels, launches, f"{cfg.name} bfloat16")
        gen, decode_s = timed(lambda: decode(
            nxt.to(params["embed"].device), caches.pop()))
        with plain():
            prefill()
            nxt_plain, plain_s = timed(prefill)
        lp = (transformer._compute_params(params, torch.bfloat16)
              if cfg.family == "encdec" else params)
        logits, ref, extra = logit_pair(model, lp, toks, plain)
        del lp
        logits, ref = logits[..., :cfg.vocab], ref[..., :cfg.vocab]
        finite = bool(torch.isfinite(logits).all())
        err = float((logits.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del logits, ref
    tol = bf16_logit_tolerance(bf16_boundaries(cfg), scale)
    in_vocab = bool(((gen >= 0) & (gen < cfg.vocab)).all())
    if launches != want or not finite or not err <= tol \
            or not in_vocab or gen.shape != (n_req, sv["gen"]):
        raise AssertionError(f"{cfg.name} bfloat16: launches={launches} "
                             f"finite={finite} err={err} tol={tol} "
                             f"decoded {tuple(gen.shape)} in "
                             f"vocabulary={in_vocab}")
    return {"prefill_bf16_s": prefill_s, "prefill_bf16_plain_s": plain_s,
            "decode_bf16_s": decode_s, "decode_bf16_steps": sv["gen"] - 1,
            "generated_bf16_first": gen[0].tolist(),
            "launches_bf16": launches, "launches_bf16_kernel": k3_bf16,
            "logits_bf16_max_abs_err": err,
            "logits_bf16_tol": tol, "logits_bf16_max_abs": scale,
            "next_token_agreement_bf16": agree,
            "prefill_bf16_next_equal": float((nxt == nxt_plain).float()
                                             .mean()),
            **{f"{k}_bf16": v for k, v in extra.items()}}


def _check_outputs(cfg, stats, sv=SERVE):
    out = np.concatenate(stats["outputs"])
    if out.shape != (sv["requests"], sv["gen"]) or \
            not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"{cfg.name}: bad generated tokens {out.shape}")
    return out


def serve_split(model, params, toks, stats, sv=SERVE):
    """The serve time's parts: drawing prompts on the host (the card idle),
    one warm prefill of the prompts ``toks`` alone, ending in a host read
    of its tokens, and the decode steps from its cache."""
    with torch.no_grad():
        (nxt, cache), prefill_s = timed(lambda: model.prefill(
            params, _inputs(toks), cache_len=sv["prompt_len"] + sv["gen"]))

        def decode():
            n, c = nxt, cache
            for _ in range(sv["gen"] - 1):
                n, c = model.decode_step(params, c, n)
            return n.cpu()
        _, decode_s = timed(decode)
    return {"draw_s": stats["draw_seconds"], "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": sv["gen"] - 1}


def _n_params(params) -> int:
    return sum(_n_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


def phase_serve(dev):
    """The serving path at the published config, counted, then one
    batch's logits against the plain-attention model."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions

    cfg = get("qwen1.5-0.5b")
    model = Model(cfg, RunOptions(remat="none", layer_loop="scan",
                                  compute_dtype="float32", q_chunk=64,
                                  kv_chunk=64))
    params, init_s = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    corpus = SyntheticCorpus(cfg.vocab, 0)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    FA.LAUNCHES = 0
    stats = serve(model, params, corpus, log=lambda line: None, **SERVE)
    launches = FA.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches == 0:
        raise AssertionError("the serve path launched no attention kernel")
    out = _check_outputs(cfg, stats)
    toks = first_batch(corpus, params)
    split = serve_split(model, params, toks, stats)
    err, scale, agree, _ = serve_check(cfg, model, params, toks,
                                    plain_attention)
    bf16 = serve_bf16(cfg, params, toks, plain_attention,
                      {"flash_attention": FA},
                      {"flash_attention": cfg.n_layers,
                       "flash_attention_window": 0})
    fp8 = serve_fp8(cfg, params, toks)
    emit("serve", layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params=_n_params(params),
         init_s=init_s, seconds=stats["seconds"], tokens=stats["tokens"],
         tok_per_s=stats["tokens"] / stats["seconds"], **split,
         launches=launches, mem_at_start_bytes=mem0, peak_mem_bytes=peak,
         generated_first=out[0].tolist(),
         logits_max_abs_err=err, logits_max_abs=scale,
         next_token_agreement=agree, **bf16, **fp8)
    return dict(launches=launches, err=err,
                k3_bf16=bf16["launches_bf16_kernel"] + fp8["launches_fp8"])


def serve_fp8(cfg, params, toks):
    """The model at the default RunOptions with ``kv_cache_dtype``
    float8_e4m3fn: one warm bfloat16 prefill of the prompts ``toks``,
    K3's count set to 0 just before it and held to once per layer, timed;
    its k and v codes against the float8 cast of the bfloat16 cache's
    prefill on this card, bit for bit (the cast is the only difference);
    then SERVE["gen"] - 1 decode steps from each cache, and the share of
    generated tokens the two agree on, reported and not held (a float8
    cache is another result, not a faster one)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    fp8 = getattr(torch, FP8)
    cache_len = SERVE["prompt_len"] + SERVE["gen"]

    def run(model, keep):
        nxt, cache = model.prefill(params, {"tokens": toks},
                                   cache_len=cache_len)
        keep.append(cache)
        return nxt

    def decode(model, nxt, cache):
        out = [nxt]
        for _ in range(SERVE["gen"] - 1):
            nxt, cache = model.decode_step(params, cache, nxt)
            out.append(nxt)
        return torch.stack(out, 1).cpu()

    wide, narrow = Model(cfg, RunOptions()), Model(cfg, RunOptions(
        kv_cache_dtype=FP8))
    with torch.no_grad():
        caches = []
        nxt_w = run(wide, caches)
        run(narrow, [])
        _zero({"flash_attention": FA})
        nxt_n, prefill_s = timed(lambda: run(narrow, caches))
        launches = FA.LAUNCHES
        _bf16_k3({"flash_attention": FA}, {"flash_attention": launches},
                 f"{cfg.name} float8 cache")
        cache_w, cache_n = caches
        codes = {name: cache_n["layers"][name].dtype == fp8 and torch.equal(
            cache_n["layers"][name].view(torch.uint8),
            cache_w["layers"][name].to(fp8).view(torch.uint8))
            for name in ("k", "v")}
        nbytes = sum(cache_n["layers"][n].numel() for n in ("k", "v"))
        gen_n, decode_s = timed(lambda: decode(narrow, nxt_n, cache_n))
        gen_w = decode(wide, nxt_w, cache_w)
    del caches, cache_w, cache_n
    if launches != cfg.n_layers or not all(codes.values()):
        raise AssertionError(f"{cfg.name} float8 cache: launches={launches}"
                             f" codes equal={codes}")
    return {"prefill_fp8_s": prefill_s, "decode_fp8_s": decode_s,
            "launches_fp8": launches, "kv_fp8_bytes": nbytes,
            "kv_fp8_codes_equal": codes,
            "generated_fp8_agreement": float((gen_n == gen_w).float()
                                             .mean()),
            "generated_fp8_first": gen_n[0].tolist()}


def phase_serve_ssm(dev):
    """The serving path for mamba2-370m at the published config,
    counted, then one batch's logits against the plain-SSD model."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions

    cfg = get("mamba2-370m")
    model = Model(cfg, RunOptions(remat="none", layer_loop="scan",
                                  compute_dtype="float32"))
    params, init_s = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    corpus = SyntheticCorpus(cfg.vocab, 0)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    SSD.LAUNCHES = 0
    stats = serve(model, params, corpus, log=lambda line: None, **SERVE)
    launches = SSD.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    batches = -(-SERVE["requests"] // SERVE["batch"])
    if launches != cfg.n_layers * batches:
        raise AssertionError(f"the mamba2 serve path launched K4 {launches} "
                             f"times, not once per layer and prefill")
    out = _check_outputs(cfg, stats)
    toks = first_batch(corpus, params)
    split = serve_split(model, params, toks, stats)
    err, scale, agree, _ = serve_check(cfg, model, params, toks, plain_ssd)
    bf16 = serve_bf16(cfg, params, toks, plain_ssd, {"ssd_scan": SSD},
                      {"ssd_scan": cfg.n_layers})
    emit("serve_ssm", layers=cfg.n_layers, d_model=cfg.d_model,
         d_inner=cfg.d_inner, heads=cfg.ssm_heads, d_state=cfg.ssm.d_state,
         vocab=cfg.vocab, params=_n_params(params), init_s=init_s,
         seconds=stats["seconds"], tokens=stats["tokens"],
         tok_per_s=stats["tokens"] / stats["seconds"], **split,
         launches=launches, mem_at_start_bytes=mem0, peak_mem_bytes=peak,
         generated_first=out[0].tolist(),
         logits_max_abs_err=err, logits_max_abs=scale,
         next_token_agreement=agree, **bf16)
    return dict(launches=launches + bf16["launches_bf16"]["ssd_scan"],
                err=err)


def phase_serve_hybrid(dev):
    """The serving path for hymba-1.5b at the published config, counted:
    K3 and K4 once per layer and prefill, K3 with the window in every
    layer but the three global ones; then one batch's logits against the
    same model with both plain versions on the card, the prefill with
    them, and the bfloat16 prefill and check."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    from repro_torch.models.transformer import _layer_window

    t0 = time.perf_counter()
    cfg = get("hymba-1.5b")
    model = Model(cfg, RunOptions(remat="none", layer_loop="scan",
                                  compute_dtype="float32"))
    params, init_s = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    corpus = SyntheticCorpus(cfg.vocab, 0)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kernels = {"flash_attention": FA, "ssd_scan": SSD}
    _zero(kernels)
    stats = serve(model, params, corpus, log=lambda line: None, **SERVE)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    windowed = sum(_layer_window(cfg, li) is not None
                   for li in range(cfg.n_layers))
    per_prefill = {"flash_attention": cfg.n_layers,
                   "flash_attention_window": windowed,
                   "ssd_scan": cfg.n_layers}
    batches = -(-SERVE["requests"] // SERVE["batch"])
    if launches != {k: v * batches for k, v in per_prefill.items()}:
        raise AssertionError(f"the hymba serve path launched {launches}, "
                             f"not {per_prefill} per prefill")
    out = _check_outputs(cfg, stats)
    toks = first_batch(corpus, params)
    split = serve_split(model, params, toks, stats)
    err, scale, agree, _ = serve_check(cfg, model, params, toks, plain_hybrid)
    with torch.no_grad(), plain_hybrid():
        def prefill():
            return model.prefill(params, {"tokens": toks}, cache_len=SERVE[
                "prompt_len"] + SERVE["gen"])[0].cpu()
        prefill()
        _, plain_s = timed(prefill)
    bf16 = serve_bf16(cfg, params, toks, plain_hybrid, kernels, per_prefill)
    emit("serve_hybrid", layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, window=cfg.window,
         global_layers=list(cfg.global_layers), windowed_layers=windowed,
         ssm_heads=cfg.n_heads * cfg.hd // cfg.ssm.head_dim,
         d_state=cfg.ssm.d_state, vocab=cfg.vocab, params=_n_params(params),
         param_count=cfg.param_count(), init_s=init_s,
         seconds=stats["seconds"], tokens=stats["tokens"],
         tok_per_s=stats["tokens"] / stats["seconds"], **split,
         prefill_plain_s=plain_s, launches=launches,
         launches_per_prefill=per_prefill, mem_at_start_bytes=mem0,
         peak_mem_bytes=peak, generated_first=out[0].tolist(),
         logits_max_abs_err=err, logits_max_abs=scale,
         next_token_agreement=agree, **bf16,
         phase_s=time.perf_counter() - t0)
    k3_window = launches["flash_attention_window"]
    return dict(k3_window=k3_window,
                k3_global=launches["flash_attention"] - k3_window,
                k3_bf16=bf16["launches_bf16_kernel"],
                k4=launches["ssd_scan"] + bf16["launches_bf16"]["ssd_scan"],
                err=err)


def phase_serve_moe(dev):
    """The serving path for the MoE family, counted: mixtral-8x7b at its
    published width (d_model 4,096, 32 heads over 8 kv heads of 128,
    window 4,096, 8 experts top-2 of d_ff 14,336, vocab 32,000), its 32
    layers cut to MOE_LAYERS (46.7B parameters are 187 GB in float32),
    random weights from seed 0, float32, through ``serve``. K3 must launch
    once per layer and prefill, every launch with the window; then one
    batch's logits against the same model with K3's plain version on the
    kernel model's expert choices (``logit_pair``), that prefill's time,
    and the bfloat16 prefill, decode and check as for qwen."""
    import dataclasses

    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = get("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    model = Model(cfg, RunOptions(remat="none", layer_loop="scan",
                                  compute_dtype="float32"))
    params, init_s = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    corpus = SyntheticCorpus(cfg.vocab, 0)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kernels = {"flash_attention": FA}
    _zero(kernels)
    stats = serve(model, params, corpus, log=lambda line: None, **SERVE)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    per_prefill = {"flash_attention": cfg.n_layers,
                   "flash_attention_window": cfg.n_layers}
    batches = -(-SERVE["requests"] // SERVE["batch"])
    if launches != {k: v * batches for k, v in per_prefill.items()}:
        raise AssertionError(f"the mixtral serve path launched {launches}, "
                             f"not {per_prefill} per prefill")
    out = _check_outputs(cfg, stats)
    toks = first_batch(corpus, params)
    split = serve_split(model, params, toks, stats)
    err, scale, agree, routing = serve_check(cfg, model, params, toks,
                                             plain_attention)
    with torch.no_grad(), plain_attention():
        def prefill():
            return model.prefill(params, {"tokens": toks}, cache_len=SERVE[
                "prompt_len"] + SERVE["gen"])[0].cpu()
        prefill()
        _, plain_s = timed(prefill)
    bf16 = serve_bf16(cfg, params, toks, plain_attention, kernels,
                      per_prefill)
    emit("serve_moe", layers=cfg.n_layers, published_layers=full.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.hd, window=cfg.window, experts=cfg.moe.n_experts,
         top_k=cfg.moe.top_k, d_ff=cfg.d_ff, vocab=cfg.vocab,
         capacity_factor=model.opts.capacity_factor,
         params=_n_params(params), param_count=cfg.param_count(),
         published_param_count=full.param_count(), init_s=init_s,
         seconds=stats["seconds"], tokens=stats["tokens"],
         tok_per_s=stats["tokens"] / stats["seconds"], **split,
         prefill_plain_s=plain_s, launches=launches,
         launches_per_prefill=per_prefill, mem_at_start_bytes=mem0,
         peak_mem_bytes=peak, generated_first=out[0].tolist(),
         logits_max_abs_err=err, logits_max_abs=scale,
         next_token_agreement=agree, **routing, **bf16,
         peak_mem_phase_bytes=torch.cuda.max_memory_allocated(),
         phase_s=time.perf_counter() - t0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["flash_attention"], err=err,
                k3_bf16=bf16["launches_bf16_kernel"])


def whisper_frames(b, row0, dev):
    """The encoder frames of ``b`` requests from request ``row0``: (b,
    1,500, d_model) float32 on ``dev``, drawn from a generator seeded with
    ``row0`` (the audio frontend is a stub: frames are the input)."""
    from repro_torch.configs.base import get
    from repro_torch.models.model import WHISPER_ENC_FRAMES
    gen = torch.Generator(device=dev).manual_seed(row0)
    return torch.randn((b, WHISPER_ENC_FRAMES, get("whisper-large-v3")
                        .d_model), generator=gen, device=dev)


def phase_serve_encdec(dev):
    """The serving path for the encoder-decoder family, counted:
    whisper-large-v3 at its published config, full depth (32 encoder and
    32 decoder layers, d_model 1,280, 20 heads of 64, d_ff 5,120, vocab
    51,866), random weights from seed 0, float32, through ``serve`` with
    each batch's 1,500 encoder frames (``whisper_frames``): 2 batches of
    4 requests, prompts of 440 tokens, 8 tokens generated. K3 launches
    96 times a prefill (the encoder's self-attention over the frames, the
    decoder's causal self-attention and its cross-attention over the
    frames, all but the decoder's self non-causal) and 32 times a decode
    step (one query against the frames), none windowed. Then one batch's
    logits against the same model with K3's plain version, that
    prefill's time, and the bfloat16 prefill, decode and check."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sv = WHISPER_SERVE
    cfg = get("whisper-large-v3")
    model = Model(cfg, RunOptions(remat="none", layer_loop="scan",
                                  compute_dtype="float32"))
    params, init_s = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    corpus = SyntheticCorpus(cfg.vocab, 0)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kernels = {"flash_attention": FA}
    _zero(kernels)
    stats = serve(model, params, corpus, log=lambda line: None,
                  frames=lambda b, r0: whisper_frames(b, r0, dev), **sv)
    launches = _counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    per_prefill = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                   "flash_attention_window": 0}
    batches = -(-sv["requests"] // sv["batch"])
    want = {"flash_attention": batches * (
        per_prefill["flash_attention"] + (sv["gen"] - 1) * cfg.n_layers),
        "flash_attention_window": 0}
    if launches != want:
        raise AssertionError(f"the whisper serve path launched {launches}, "
                             f"not {want}")
    out = _check_outputs(cfg, stats, sv)
    batch = {"frames": whisper_frames(sv["batch"], 0, dev),
             "tokens": torch.as_tensor(corpus.batch(
                 sv["batch"], sv["prompt_len"], 0), device=dev)}
    split = serve_split(model, params, batch, stats, sv)
    err, scale, agree, _ = serve_check(cfg, model, params, batch,
                                       plain_attention)
    with torch.no_grad(), plain_attention():
        def prefill():
            return model.prefill(params, batch, cache_len=sv[
                "prompt_len"] + sv["gen"])[0].cpu()
        prefill()
        _, plain_s = timed(prefill)
    bf16 = serve_bf16(cfg, params, batch, plain_attention, kernels,
                      per_prefill, sv)
    emit("serve_encdec", layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.hd,
         d_ff=cfg.d_ff, vocab=cfg.vocab,
         enc_frames=int(batch["frames"].shape[1]),
         max_target_len=cfg.max_target_len, params=_n_params(params),
         param_count=cfg.param_count(), init_s=init_s,
         seconds=stats["seconds"], tokens=stats["tokens"],
         tok_per_s=stats["tokens"] / stats["seconds"], **split,
         prefill_plain_s=plain_s, launches=launches,
         launches_per_prefill=per_prefill,
         launches_per_decode_step=cfg.n_layers, mem_at_start_bytes=mem0,
         peak_mem_bytes=peak, generated_first=out[0].tolist(),
         logits_max_abs_err=err, logits_max_abs=scale,
         next_token_agreement=agree, **bf16,
         peak_mem_phase_bytes=torch.cuda.max_memory_allocated(),
         phase_s=time.perf_counter() - t0)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["flash_attention"], err=err,
                k3_bf16=bf16["launches_bf16_kernel"])


def _library_call(cols, n, spec, fvals):
    """One PyTorch call computing the same masked group aggregate, on
    group ids and masked values prepared beforehand (the yardstick)."""
    from repro_torch.kernels import warehouse_agg as K
    mask = torch.ones(n, dtype=torch.bool, device=cols["t"].device)
    for col, op, idx in spec.filters:
        mask &= K.filter_pred(cols[col][:n], op, idx, fvals)
    ids = K.group_ids(cols, n, spec.keys)
    v = cols[spec.value][:n].float()
    num = spec.num_groups
    if spec.agg in ("max", "min"):
        fill = float("-inf") if spec.agg == "max" else float("inf")
        vals = torch.where(mask, v, fill)
        acc = torch.full((num,), fill, device=v.device)
        red = "amax" if spec.agg == "max" else "amin"
        return lambda: acc.scatter_reduce_(0, ids, vals, red)
    vals = torch.where(mask if v.ndim == 1 else mask[:, None], v, 0.0)
    acc = torch.zeros((num,) + tuple(v.shape[1:]), device=v.device)
    return lambda: acc.index_add_(0, ids, vals)


def phase_time(m, errs):
    from repro_torch.kernels import warehouse_agg as K
    store = m["store"]
    cols, n = store.columns, store.n_rows
    per = {}
    for name, plan in store_plans(store).items():
        spec, fvals, _ = _spec_of(plan, cols)
        kernel_ms = cuda_ms(lambda: K.fused_segment_agg(cols, n, fvals,
                                                        spec), 20)
        plain_ms = cuda_ms(lambda: K.fused_segment_agg_ref(cols, n, fvals,
                                                           spec), 5)
        library_ms = cuda_ms(_library_call(cols, n, spec, fvals), 10)
        nbytes = partial_bytes(cols, n, errs[name]["kept_rows"], spec)
        per[name] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "kernel_over_library": kernel_ms / library_ms,
                     "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "groups": spec.num_groups, "agg": spec.agg,
                     "mode": K.accumulator_mode(spec, _width(cols, spec))}
    emit("time", rows=n, queries=per)
    return per



def phase_time_k2_k3(dev):
    """K2 and K3 at the main paths' shapes: kernel, plain version and
    the library yardstick, CUDA-event medians, beside their bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import frame_preproc as FP
    gen = torch.Generator(device=dev).manual_seed(5)

    seg = torch.randn(SEGMENT, generator=gen, device=dev)
    nchw = seg.permute(0, 3, 1, 2).contiguous()
    out_bytes = seg.numel() // 4 * seg.element_size()
    k2_bytes = seg.numel() * seg.element_size() + out_bytes
    k2 = {"kernel_ms": cuda_ms(lambda: FP.downsample(seg, 2), 50),
          "plain_ms": cuda_ms(lambda: FP.downsample_ref(seg, 2), 10),
          "library_ms": cuda_ms(lambda: F.avg_pool2d(nchw, 2), 50),
          "shape": list(SEGMENT), "factor": 2, "bytes": k2_bytes,
          "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    del nchw

    k3 = _time_k3(FA, F, ATTN_TIME, gen, dev, reps=20)
    k3["transform_shape"] = _time_k3(FA, F, ATTN_SMALL, gen, dev, reps=200)
    k3["bf16"] = _time_k3(FA, F, ATTN_TIME, gen, dev, reps=20,
                          dtype=torch.bfloat16)
    emit("time_k2_k3", downsample=k2, flash_attention=k3)
    return k2, k3


def _time_k3(FA, F, shape, gen, dev, reps, dtype=torch.float32, *,
             kv_heads=None, window=None, skv=None, causal=True):
    """K3, its plain version and SDPA at (B, S, H, D) with ``kv_heads``
    kv heads (H by default), ``skv`` keys (S by default), causal unless
    ``causal`` is False, with ``window`` if given, beside
    both bounds: 3xTF32 (three TF32 products per float32 one, on the
    tensor cores: the kernel's arithmetic, and its bound) and the FP32
    CUDA-core bound of a kernel in float32 products. For bfloat16
    operands the bound is the dense bf16 peak's (the least time the card
    could take for the same function), beside the 3xTF32 one. SDPA gets
    the same band: ``is_causal`` without a window, no mask where K3 sees
    every key, else the band as a boolean ``attn_mask``, with
    ``enable_gqa`` for fewer kv heads (a window of S or more is the
    causal mask, and SDPA gets ``is_causal``).
    The kernel's output on the timed inputs is held against the plain
    version's within ``error_bound`` (bfloat16: the bfloat16 kernel's
    bound, against the plain version on the widened inputs, the
    output's rounding added), and SDPA's distance from the plain
    version is reported (SDPA in bfloat16 runs P in one bfloat16 part,
    the bfloat16 kernel in two). For bfloat16 also the bfloat16
    kernel's own floor, ``bound_design_ms``: its three bf16 products
    where the function needs two (1.5 times the operations), and the
    launch it makes (``FA.bf16_launch_shape``)."""
    B, S, H, D = shape
    G, Skv = kv_heads or H, skv or S
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Skv, G, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    band = FA._visible(S, Skv, causal, window, dev)
    visible = int(band.sum())                   # (q, k) pairs seen
    flops = 4 * D * visible * B * H             # QK^T and PV, 2 flop a MAC
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    least_ms = (flops / BF16_FLOP_PER_S * 1e3 if dtype == torch.bfloat16
                else tf32_ms)
    if window is not None and window < S:
        sdpa = {"attn_mask": band}
    else:
        sdpa = {"is_causal": True} if causal else {}
    if G != H:
        sdpa["enable_gqa"] = True
    qf, kf, vf = q.float(), k.float(), v.float()
    want = FA.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    bf16 = dtype == torch.bfloat16
    bound = FA.error_bound(q, k, v, causal=causal, window=window,
                           ref=want if bf16 else None)
    ratio = float(((got.float() - want).abs() / bound).max())
    if not ratio <= 1.0:
        raise AssertionError(f"K3 at {list(shape)} Skv={Skv} G={G} "
                             f"w={window} causal={causal} {dtype}: "
                             f"{ratio:.3g}x error_bound")
    lib = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    held = {"max_abs_err": _max_err(got, want), "of_bound": ratio,
            "library_max_abs_err": _max_err(lib.transpose(1, 2), want)}
    if bf16:
        held["bound_design_ms"] = max(1.5 * least_ms, byte_ms)
        held["launch"] = FA.bf16_launch_shape(q, k, v)
    del qf, kf, vf, want, got, bound, lib
    return {"dtype": str(dtype).replace("torch.", ""), **held,
            "kernel_ms": cuda_ms(lambda: FA.flash_attention(
                q, k, v, causal=causal, window=window), reps),
            "plain_ms": cuda_ms(lambda: FA.flash_attention_ref(
                q, k, v, causal=causal, window=window), max(5, reps // 4)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa), reps),
            "shape": [B, S, H, G, D] if skv is None else [B, S, Skv, H, G, D],
            "causal": causal, "window": window,
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(least_ms, byte_ms),
            "bound_by": "operations" if least_ms > byte_ms else "bytes",
            "bound_3xtf32_ms": max(tf32_ms, byte_ms),
            "bound_fp32_ms": max(fp32_ms, byte_ms)}


def ssd_work(B, S, H, P, G, N, Q, width=4):
    """(FLOPs, bytes) the SSD scan needs at a shape whose S is a multiple
    of Q, with no state in: the causal half of C.B^T once per (b, g,
    chunk), the causal half of the scores times x, C . state and the
    state update per head (2 FLOPs a MAC); x and y, B and C, dt (``width``
    bytes each: 4 for float32, 2 for bfloat16), A and the final state
    (float32), each moved once."""
    nc, pairs = S // Q, Q * (Q + 1) // 2
    flops = (2 * N * pairs * B * G * nc + 2 * P * pairs * B * H * nc
             + 2 * 2 * Q * N * P * B * H * nc)
    nbytes = (width * (2 * B * S * H * P + 2 * B * S * G * N + B * S * H)
              + 4 * (H + B * H * P * N))
    return flops, nbytes


def _time_ssd(SSD, args, shape, reps=20):
    """K4 and its plain version at ``shape`` (B, S, H, P, G, N, Q) on
    ``args`` (x, dt, A, B, C in float32), then on bfloat16 x, dt, B and C
    as the model passes them at its defaults, CUDA-event medians beside
    the bounds: float32 at both operation bounds (3xTF32 at the dense
    TF32 peak, the kernels' arithmetic and their bound; FP32 CUDA cores)
    and the byte bound; bfloat16 at the dense bf16 peak (the least time
    for the same function) and its bytes."""
    B, S, H, P, G, N, Q = shape
    flops, nbytes = ssd_work(B, S, H, P, G, N, Q)
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"kernel_ms": cuda_ms(lambda: SSD.ssd_scan(*args, chunk=Q), reps),
           "plain_ms": cuda_ms(lambda: SSD.ssd_scan_ref(*args, chunk=Q), 5),
           "library_ms": None, "shape": list(shape), "flops": flops,
           "bytes": nbytes, "bound_ms": max(tf32_ms, byte_ms),
           "bound_by": "operations" if tf32_ms > byte_ms else "bytes",
           "bound_3xtf32_ms": max(tf32_ms, byte_ms),
           "bound_fp32_ms": max(fp32_ms, byte_ms)}
    bf = [a.to(torch.bfloat16) if i != 2 else a for i, a in enumerate(args)]
    flops, nbytes = ssd_work(B, S, H, P, G, N, Q, width=2)
    least_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out["bf16"] = {
        "kernel_ms": cuda_ms(lambda: SSD.ssd_scan(*bf, chunk=Q), reps),
        "plain_ms": cuda_ms(lambda: SSD.ssd_scan_ref(*bf, chunk=Q), 5),
        "library_ms": None, "bytes": nbytes,
        "bound_ms": max(least_ms, byte_ms),
        "bound_by": "operations" if least_ms > byte_ms else "bytes",
        "bound_3xtf32_ms": out["bound_3xtf32_ms"]}
    return out


def phase_time_k4(dev):
    """K4 at the mamba2-370m serve prefill (``_time_ssd``), and each of
    its five passes alone, with the bytes of its scratch."""
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S, H, P, G, N, Q = SSD_TIME
    *args, _ = ssd_inputs(B, S, H, P, G, N, gen, dev)
    x, Bm = args[0], args[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), device=dev)
    scr = SSD.scratch(x, Bm, Q)
    for name in SSD.PASSES:              # the scratch holds every input
        SSD.launch(name, *args, None, y, state, scr, Q)
    passes = {name: cuda_ms(lambda: SSD.launch(
        name, *args, None, y, state, scr, Q), 20) for name in SSD.PASSES}
    k4 = _time_ssd(SSD, args, SSD_TIME)
    k4.update(pass_ms=passes,
              scratch_bytes=sum(t.numel() * t.element_size()
                                for t in scr.values()))
    emit("time_k4", ssd_scan=k4)
    return k4


def phase_time_hybrid(dev):
    """K3 with hymba-1.5b's window and in its global layers, and K4, at
    its serve prefill, in float32 and bfloat16: kernel, plain version
    and (K3) SDPA given the same band, beside their bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device=dev).manual_seed(8)
    B, S, H, G, D, W = HYMBA_ATTN
    k3 = {}
    for name, window in (("window", W), ("global", None)):
        k3[name] = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20,
                            kv_heads=G, window=window)
        k3[name]["bf16"] = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20,
                                    dtype=torch.bfloat16, kv_heads=G,
                                    window=window)
    B, S, H, P, G, N, Q = HYMBA_SSD
    *args, _ = ssd_inputs(B, S, H, P, G, N, gen, dev)
    k4 = _time_ssd(SSD, args, HYMBA_SSD)
    emit("time_hybrid", flash_attention=k3, ssd_scan=k4)
    return k3, k4


def phase_time_moe(dev):
    """K3 at mixtral-8x7b's serve prefill (B=4, S=2048, 32 heads over 8
    kv heads of 128, window 4,096: every key of the prompt, the causal
    half), float32 and bfloat16: kernel, plain version and SDPA
    (``enable_gqa``, causal), each kernel output held against the plain
    version, beside the bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(9)
    B, S, H, G, D, W = MOE_ATTN
    k3 = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20, kv_heads=G,
                  window=W)
    k3["bf16"] = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20,
                          dtype=torch.bfloat16, kv_heads=G, window=W)
    emit("time_moe", flash_attention=k3)
    return k3


def phase_time_encdec(dev):
    """K3 at whisper-large-v3's shapes (``WHISPER_ATTN``: the encoder's
    self-attention over 1,500 frames, the decoder's causal
    self-attention over a 440-token prompt, the prefill's cross-attention
    over the frames, one decode query against them), float32 and
    bfloat16: kernel, plain version and SDPA, each kernel output held
    against the plain version, beside the bounds; then the per-batch sum
    (each shape's time times its launches in one served batch). Then
    ``llama_prefill``: K3 at head dim 128 with no window on a model
    path."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get
    from repro_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(10)
    layers = get("whisper-large-v3").n_layers
    k3, batch = {}, {"launches": 0}
    for name, ((B, Sq, Skv, H, D, causal), per_layer) in WHISPER_ATTN.items():
        k3[name] = _time_k3(FA, F, (B, Sq, H, D), gen, dev, reps=20, skv=Skv,
                            causal=causal)
        k3[name]["bf16"] = _time_k3(FA, F, (B, Sq, H, D), gen, dev, reps=20,
                                    dtype=torch.bfloat16, skv=Skv,
                                    causal=causal)
        n = layers * per_layer
        k3[name]["launches_per_batch"] = n
        batch["launches"] += n
        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
            batch[key] = batch.get(key, 0.0) + n * k3[name][key]
    batch["max_abs_err"] = max(max(e["max_abs_err"], e["bf16"]["max_abs_err"])
                               for e in k3.values())
    ops = sum(e["launches_per_batch"] * e["bound_ms"] for e in k3.values()
              if e["bound_by"] == "operations")
    batch["bound_by"] = ("operations" if ops > batch["bound_ms"] / 2
                         else "bytes")
    llama = llama_prefill(dev)
    emit("time_encdec", flash_attention=k3, per_batch=batch,
         llama3_8b=llama, phase_s=time.perf_counter() - t0)
    return batch


def llama_prefill(dev):
    """llama3-8b at its published width (d_model 4,096, 32 heads over 8
    kv heads of 128, d_ff 14,336, vocab 128,256, RoPE theta 500,000), its
    32 layers cut to LLAMA_LAYERS, random weights from seed 0, at the
    default RunOptions: ``serve_bf16`` on the serve loop's first batch
    (4 x 2,048 tokens), K3 once per layer with no window, its logits
    against the plain-attention model within ``bf16_logit_tolerance``."""
    import dataclasses

    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.model import Model
    gc.collect()
    torch.cuda.empty_cache()
    full = get("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=LLAMA_LAYERS)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = first_batch(SyntheticCorpus(cfg.vocab, 0), params)
    out = serve_bf16(cfg, params, toks, plain_attention,
                     {"flash_attention": FA},
                     {"flash_attention": cfg.n_layers,
                      "flash_attention_window": 0})
    out.update(layers=cfg.n_layers, published_layers=full.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, vocab=cfg.vocab,
               params=_n_params(params))
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# many streams: the multi-stream run, the serving pool, the cold tier
# ---------------------------------------------------------------------------

def _leaf_errs(got, want):
    """Per leaf (in ``optim.adamw.leaves`` order): max |got - want| as a
    share of max |want|."""
    return [float((a.float().cpu() - b.float().cpu()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30).cpu())
            for a, b in zip(got, want)]


def _train_step(step_fn, state, batch):
    """One train step, ending in a host read of its loss."""
    state, met = step_fn(state, batch)
    return state, {k: float(v) for k, v in met.items()}


def _train_steps(dev, cfg, batch, seq, kernels, lr=TRAIN["lr"]):
    """TRAIN["steps"] steps of the launcher's train step
    (``launch.train.train_options``: remat none, float32; AdamW, the clip
    and the warmup-cosine schedule at peak rate ``lr``) on ``cfg`` from
    random weights (seed 0) at ``batch`` x ``seq`` tokens, the launches
    of ``kernels`` ({name: wrapper module}: the forward's LAUNCHES and the
    backward's BWD_LAUNCHES) set to 0 just before the steps and read
    after each. Returns the run's numbers; the state is dropped."""
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import init_train_state, make_train_step

    model = Model(cfg, LT.train_options(seq))
    state, init_s = timed(lambda: init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = _n_params(state["params"])
    step_fn = make_train_step(model, peak_lr=lr, warmup=LT.WARMUP,
                              total_steps=TRAIN["steps"])
    it = make_batch_iter(cfg, global_batch=batch, seq_len=seq, seed=0,
                         device=dev)
    batches = [next(it) for _ in range(TRAIN["steps"])]

    def counts():
        return [n for k in kernels.values()
                for n in (k.LAUNCHES, k.BWD_LAUNCHES)]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.LAUNCHES = k.BWD_LAUNCHES = 0
        if hasattr(k, "WINDOW_LAUNCHES"):
            k.WINDOW_LAUNCHES = 0
    metrics, secs, per_step = [], [], []
    for b in batches:
        c0 = counts()
        (state, met), sec = timed(lambda: _train_step(step_fn, state, b))
        metrics.append(met)
        secs.append(sec)
        per_step.append([n - m for n, m in zip(counts(), c0)])
    totals = counts()
    peak = torch.cuda.max_memory_allocated()
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    step_s = statistics.median(secs[1:])
    return {"params": n_params, "init_s": init_s,
            "losses": [m["loss"] for m in metrics],
            "gnorms": [m["gnorm"] for m in metrics],
            "lrs": [m["lr"] for m in metrics], "step_s": secs,
            "first_step_s": secs[0], "step_s_median": step_s,
            "tok_per_s": batch * seq / step_s, "peak_mem_bytes": peak,
            "per_step": per_step, "totals": totals}


def _check_train(what, run, per_layer):
    """The losses finite and falling from the first step to the last,
    and each step's launches ``per_layer``."""
    losses = run["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
            or any(p != per_layer for p in run["per_step"]):
        raise AssertionError(f"{what}: losses {losses}, launches per step "
                             f"{run['per_step']} (want {per_layer})")


def phase_train(dev):
    """Training on the card, counts set to 0 just before the steps and
    read just after: qwen1.5-0.5b at its published config (24 layers,
    d_model 1,024, 16 heads of 64, vocab 151,936, tied embeddings),
    random weights from a seed, through the launcher's step
    (``launch.train.train_options``: remat none, float32) at batch 4 x
    2,048 tokens for TRAIN["steps"] steps, each K3's forward and its
    backward kernel once per layer. Then ``train_grad_check`` and
    ``train_resume``."""
    from repro_torch.configs.base import get
    from repro_torch.kernels import flash_attention as FA

    t0 = time.perf_counter()
    cfg = get("qwen1.5-0.5b")
    run = _train_steps(dev, cfg, TRAIN["batch"], TRAIN["seq"],
                       {"flash_attention": FA})
    _check_train("train", run, [cfg.n_layers, cfg.n_layers])
    fwd, bwd = run["totals"]
    grads = train_grad_check(dev, cfg)
    resume = train_resume(dev)
    emit("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab, params=run["params"], batch=TRAIN["batch"],
         seq=TRAIN["seq"], microbatches=1, remat="none",
         compute_dtype="float32", lr=TRAIN["lr"], init_s=run["init_s"],
         losses=run["losses"], gnorms=run["gnorms"], lrs=run["lrs"],
         step_s=run["step_s"], first_step_s=run["first_step_s"],
         step_s_median=run["step_s_median"], tok_per_s=run["tok_per_s"],
         peak_mem_bytes=run["peak_mem_bytes"],
         k3_launches_per_step=run["per_step"], k3_fwd_launches=fwd,
         k3_bwd_launches=bwd, grad_check=grads, resume=resume,
         phase_s=time.perf_counter() - t0)
    return {"fwd_launches": fwd, "bwd_launches": bwd,
            "step_s": run["step_s_median"]}


def train_grad_check(dev, cfg, batch=TRAIN["batch"], plain=None,
                     kernels=None):
    """The first step's loss and per-leaf gradients at full width cut to
    TRAIN_CHECK_LAYERS layers, through the kernels both ways, against the
    same step with them on their plain versions (``plain``, by default
    ``plain_attention``; autograd through them): the loss within
    TRAIN_LOSS_TOL relative, each leaf within TRAIN_GRAD_TOL of its
    largest magnitude, each backward kernel of ``kernels`` (by default
    K3's) launched once per layer."""
    import dataclasses
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import value_and_grad

    plain = plain or plain_attention
    kernels = kernels or {"flash_attention": FA}
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    model = Model(cut, LT.train_options(TRAIN["seq"]))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = next(make_batch_iter(cut, global_batch=batch,
                                 seq_len=TRAIN["seq"], seed=0, device=dev))
    b0 = {n: k.BWD_LAUNCHES for n, k in kernels.items()}
    loss, grads = value_and_grad(model, params, batch)
    launches = {n: k.BWD_LAUNCHES - b0[n] for n, k in kernels.items()}
    with plain():
        loss_p, grads_p = value_and_grad(model, params, batch)
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    errs = _leaf_errs(grads, grads_p)
    del params, grads, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    if any(n != TRAIN_CHECK_LAYERS for n in launches.values()) \
            or not rel <= TRAIN_LOSS_TOL or not max(errs) <= TRAIN_GRAD_TOL:
        raise AssertionError(f"{cfg.name} train grads vs plain versions: "
                             f"loss rel {rel}, leaves {errs}, backward "
                             f"launches {launches}")
    return {"layers": TRAIN_CHECK_LAYERS, "loss": float(loss),
            "loss_rel_err": rel, "grad_rel_err_max": max(errs),
            "grad_rel_err": errs, "tol": TRAIN_GRAD_TOL,
            "bwd_launches": launches}


def phase_train_ssm(dev):
    """Training the SSM family on the card, counts set to 0 just before
    the steps and read after each: mamba2-370m at its published config
    (48 layers, d_model 1,024, d_inner 2,048, 32 heads of 64, d_state
    128, chunk 256, vocab 50,280), random weights from a seed, through
    the launcher's step at batch TRAIN_SSM x 2,048 tokens for
    TRAIN["steps"] steps, K4's forward and its backward kernel once per
    layer and step. Then the 4-layer gradient check against the step with
    the SSD scan on its plain version (autograd through
    ``ssd_scan_ref`` on the card)."""
    from repro_torch.configs.base import get
    from repro_torch.kernels import ssd as SSD

    t0 = time.perf_counter()
    cfg = get("mamba2-370m")
    run = _train_steps(dev, cfg, TRAIN_SSM, TRAIN["seq"], {"ssd_scan": SSD})
    _check_train("train_ssm", run, [cfg.n_layers, cfg.n_layers])
    grads = train_grad_check(dev, cfg, TRAIN_SSM, plain_ssd,
                             {"ssd_scan": SSD})
    fwd, bwd = run["totals"]
    emit("train_ssm", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, d_inner=cfg.ssm.d_inner,
         ssm_heads=cfg.ssm.d_inner // cfg.ssm.head_dim,
         d_state=cfg.ssm.d_state, chunk=cfg.ssm.chunk, vocab=cfg.vocab,
         batch=TRAIN_SSM, seq=TRAIN["seq"], remat="none",
         compute_dtype="float32", lr=TRAIN["lr"],
         k4_launches_per_step=run.pop("per_step"), k4_fwd_launches=fwd,
         k4_bwd_launches=bwd, **run, grad_check=grads,
         phase_s=time.perf_counter() - t0)
    return {"fwd_launches": fwd, "bwd_launches": bwd}


def phase_train_hybrid(dev):
    """Training the hybrid family on the card, counts set to 0 just
    before the steps and read after each: hymba-1.5b at its published
    config (32 layers, d_model 1,600, 25 heads over 5 kv heads of 64,
    window 1,024 with layers 0, 15 and 31 global, an SSM branch of 25
    heads of 64 with d_state 16; vocab 32,001), full depth, random
    weights from a seed, through the launcher's step at TRAIN_HYBRID x
    2,048 tokens for TRAIN["steps"] steps at peak rate TRAIN_HYBRID_LR:
    K3 both ways (windowed in 29 layers) and K4 both ways, each once per
    layer and step. Then the
    4-layer gradient check against the step with both on their plain
    versions."""
    from repro_torch.configs.base import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models.transformer import _layer_window

    t0 = time.perf_counter()
    cfg = get("hymba-1.5b")
    run = _train_steps(dev, cfg, TRAIN_HYBRID, TRAIN["seq"],
                       {"flash_attention": FA, "ssd_scan": SSD},
                       lr=TRAIN_HYBRID_LR)
    _check_train("train_hybrid", run, [cfg.n_layers] * 4)
    windowed = sum(_layer_window(cfg, li) is not None
                   for li in range(cfg.n_layers))
    if FA.WINDOW_LAUNCHES != windowed * TRAIN["steps"]:
        raise AssertionError(f"train_hybrid: {FA.WINDOW_LAUNCHES} windowed "
                             f"K3 launches, not {windowed} a step")
    grads = train_grad_check(dev, cfg, TRAIN_HYBRID, plain_hybrid,
                             {"flash_attention": FA, "ssd_scan": SSD})
    k3_fwd, k3_bwd, k4_fwd, k4_bwd = run["totals"]
    emit("train_hybrid", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         window=cfg.window, global_layers=list(cfg.global_layers),
         windowed_layers=windowed, d_state=cfg.ssm.d_state,
         vocab=cfg.vocab, batch=TRAIN_HYBRID, seq=TRAIN["seq"],
         remat="none", compute_dtype="float32", lr=TRAIN_HYBRID_LR,
         launches_per_step=run.pop("per_step"),
         launches_order=["k3_fwd", "k3_bwd", "k4_fwd", "k4_bwd"],
         k3_window_launches=FA.WINDOW_LAUNCHES, **run, grad_check=grads,
         phase_s=time.perf_counter() - t0)
    return {"k3_fwd": k3_fwd, "k3_bwd": k3_bwd, "k4_fwd": k4_fwd,
            "k4_bwd": k4_bwd}


def train_resume(dev):
    """A reduced qwen1.5-0.5b train state after 4 of the launcher's steps
    on the card, saved under ``build/`` and restored: every leaf equal,
    dtype and bits; then the launcher resumes from it to step 6."""
    import contextlib
    import io
    import shutil
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime.steps import init_train_state, make_train_step

    d = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(d, ignore_errors=True)
    cfg = get("qwen1.5-0.5b").reduced()
    model = Model(cfg, LT.train_options(64))
    state = init_train_state(model, torch.Generator().manual_seed(0), dev)
    step_fn = make_train_step(model, peak_lr=TRAIN["lr"], warmup=LT.WARMUP,
                              total_steps=6)
    it = make_batch_iter(cfg, global_batch=4, seq_len=64, seed=0, device=dev)
    for _ in range(4):
        state, _ = step_fn(state, next(it))
    CK.save(str(d), state, step=4)
    back = CK.restore(str(d), 4, device=dev)
    a, b = leaves(state), leaves(back)
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = LT.main(["--device", str(dev), "--arch", "qwen1.5-0.5b",
                          "--reduced", "--steps",
                          "6", "--batch", "4", "--seq", "64", "--lr",
                          str(TRAIN["lr"]), "--ckpt-dir", str(d),
                          "--ckpt-every", "2", "--log-every", "1"])
    log = out.getvalue()
    final = CK.restore(str(d), 6, device=dev)
    if not same or "resumed from step 4" not in log or len(losses) != 2 \
            or not all(np.isfinite(losses)) or int(final["step"]) != 6 \
            or int(final["opt"]["count"]) != 6:
        raise AssertionError(f"train resume: restored equal={same}, "
                             f"log {log!r}")
    shutil.rmtree(d, ignore_errors=True)
    return {"leaves": len(a), "restored_bit_equal": same,
            "resumed_losses": losses}


def phase_train_families(dev):
    """One train step each of reduced whisper-large-v3 (K3 non-causal in
    the encoder and the cross attention, both ways), mixtral-8x7b (a
    window of 32 over 64 tokens, the MoE aux loss), internvl2-26b
    (``embeds``), mamba2-370m (K4 both ways) and hymba-1.5b (K3 and K4
    both ways) on the card against the same step on the card machine's
    CPU (plain versions), weights from one seed on the CPU: the loss, and
    the step's loss and clipped norm, within FAMILY_TOL relative, each
    gradient leaf within FAMILY_TOL of its largest magnitude, each of the
    family's kernels launched both ways."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import (init_train_state, make_train_step,
                                           value_and_grad)
    cpu = torch.device("cpu")
    out = {}
    for arch, kernels in (("whisper-large-v3", {"k3": FA}),
                          ("mixtral-8x7b", {"k3": FA}),
                          ("internvl2-26b", {"k3": FA}),
                          ("mamba2-370m", {"k4": SSD}),
                          ("hymba-1.5b", {"k3": FA, "k4": SSD})):
        cfg = get(arch).reduced()
        model = Model(cfg, LT.train_options(FAMILY_SEQ))
        runs = []
        for d in (cpu, dev):
            state = init_train_state(model, torch.Generator().manual_seed(0),
                                     d)
            batch = next(make_batch_iter(cfg, global_batch=2,
                                         seq_len=FAMILY_SEQ, seed=0,
                                         device=d))
            c0 = {n: (k.LAUNCHES, k.BWD_LAUNCHES) for n, k in kernels.items()}
            loss, grads = value_and_grad(model, state["params"], batch)
            _, met = _train_step(make_train_step(
                model, peak_lr=TRAIN["lr"], warmup=LT.WARMUP,
                total_steps=10), state, batch)
            runs.append((float(loss), grads, met, {
                n: [k.LAUNCHES - c0[n][0], k.BWD_LAUNCHES - c0[n][1]]
                for n, k in kernels.items()}))
        (lc, gc_, mc, _), (lg, gg, mg, launches) = runs
        rel = max(abs(lg - lc) / abs(lc),
                  *(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss",
                                                             "gnorm")))
        errs = _leaf_errs(gg, gc_)
        if not rel <= FAMILY_TOL or not max(errs) <= FAMILY_TOL \
                or min(min(v) for v in launches.values()) == 0:
            raise AssertionError(f"train {arch}: rel {rel}, leaves {errs}, "
                                 f"launches {launches}")
        out[arch] = {"loss": lg, "loss_cpu": lc, "rel_err": rel,
                     "grad_rel_err_max": max(errs), "gnorm": mg["gnorm"],
                     **{f"{n}_launches": v for n, v in launches.items()}}
    emit("train_families", tol=FAMILY_TOL, seq=FAMILY_SEQ, families=out)
    return out


def phase_time_k3_bwd(dev, fam):
    """K3's backward at the training shapes (``K3_BWD_TIME``: qwen1.5-0.5b,
    whisper-large-v3's encoder, mixtral-8x7b at D = 128), float32 and
    bfloat16: the kernel, its plain version and the library's backward
    (``scaled_dot_product_attention``'s, through ``torch.autograd.grad``),
    CUDA-event medians, beside its launches per train step at the
    published depth (mixtral's also as counted in ``train_families``,
    ``fam``) and its bound: the five products of the gradient (2.5 times
    the forward's QK^T and PV) over the pairs the mask lets through, 2
    flops a MAC, at the card's peak for the operands' type (float32 at
    3xTF32, three TF32 products for each float32 one on the tensor cores,
    the kernel's arithmetic; bfloat16 at the dense bf16 rate), or its
    bytes (q, k, v, o, dO and lse read once, dq, dk and dv written once)
    at HBM bandwidth, whichever is larger."""
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, (shape, per_step) in K3_BWD_TIME.items():
        for dtype in (torch.float32, torch.bfloat16):
            e = _time_k3_bwd(shape, gen, dev, dtype)
            e["launches_per_step"] = per_step
            e["per_step_ms"] = per_step * e["kernel_ms"]
            if name == "mixtral_train":
                e["train_families_launches_per_step"] = \
                    fam["mixtral-8x7b"]["k3_launches"][1]
            out[name if dtype == torch.float32 else name + "_bf16"] = e
    emit("time_k3_bwd", flash_attention_bwd=out)
    return out["qwen_train"]


def _time_k3_bwd(shape, gen, dev, dtype):
    """K3's backward at ``shape`` (B, Sq, Skv, H, G, D, causal, window)
    in ``dtype`` (``phase_time_k3_bwd``'s account): kernel, plain version
    and SDPA's backward, CUDA-event medians, beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, Sq, Skv, H, G, D, causal, window = shape
    q, do = (torch.randn((B, Sq, H, D), generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Skv, G, D), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    visible = int(FA._visible(Sq, Skv, causal, window, dev).sum())
    flops = 10 * D * visible * B * H
    nbytes = (3 * q.numel() + 2 * k.numel()) * q.element_size() \
        + (q.numel() + 2 * k.numel()) * q.element_size() \
        + lse.numel() * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = (3 * flops / TF32_FLOP_PER_S if dtype == torch.float32
             else flops / BF16_FLOP_PER_S) * 1e3
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    lib_o = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=G != H)
    lib_do = do.transpose(1, 2).contiguous()
    return {"dtype": str(dtype).replace("torch.", ""),
            "shape": [B, Sq, Skv, H, G, D], "causal": causal,
            "kernel_ms": cuda_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, do, lse, causal=causal, window=window), 20),
            "plain_ms": cuda_ms(lambda: FA.flash_attention_bwd_ref(
                q, k, v, o, do, lse, causal=causal, window=window), 5),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), lib_do, retain_graph=True), 20),
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes"}


def ssd_bwd_work(B, S, H, P, G, N, Q, width=4):
    """(FLOPs, bytes) the SSD scan's gradient needs at a shape whose S is
    a multiple of Q, with no state in or out: per (b, chunk), 2 FLOPs a
    MAC, the causal half of D = dy . x and of dx's intra term per head (P
    per pair of positions each), dstates, dC's inter term, dB's state
    term and dx's state term per head (Q P N each), and the causal half
    of dcb times B and times C per group (N per pair each); x, dy and dx,
    B, C, dB and dC, dt and ddt (``width`` bytes each), A and dA
    (float32), each moved once."""
    nc, pairs = S // Q, Q * (Q + 1) // 2
    macs = (H * (4 * Q * P * N + 2 * P * pairs) + G * 2 * N * pairs) * B * nc
    nbytes = (width * (3 * B * S * H * P + 4 * B * S * G * N + 2 * B * S * H)
              + 4 * 2 * H)
    return 2 * macs, nbytes


def phase_time_k4_bwd(dev, ssm, hybrid):
    """K4's backward at the training shapes (``K4_BWD_TIME``: mamba2-370m
    at B=4 and hymba-1.5b at B=1, S=2,048, as ``train_ssm`` and
    ``train_hybrid`` run them), float32 and bfloat16 operands: the nine
    passes together (``ssd_scan_bwd``) and each alone (by name, as
    ``BWD_PASSES`` lists them) on the same scratch, and the plain version
    ``ssd_scan_bwd_ref``, CUDA-event medians, beside the launches per
    train step (as counted in ``train_ssm`` and ``train_hybrid``) and the
    bound: the products of ``ssd_bwd_work`` at the card's peak for the
    operands' type (float32 at 3xTF32, three TF32 products for each
    float32 one on the tensor cores; bfloat16 at the dense bf16 rate), as
    ``time_k3_bwd`` counts them, or its bytes at HBM bandwidth, whichever
    is larger. The same products at the FP32 CUDA-core peak stand beside
    it as ``fp32_core_ms`` (the floor of a kernel that keeps them off the
    tensor cores). No one PyTorch call computes this gradient: library_ms
    is null. Every timed gradient is held against the plain version's
    within ``bwd_error_bound``
    (``err_of_bwd_error_bound``, the largest share of it)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    per_step = {"mamba2_train": ssm["bwd_launches"] // TRAIN["steps"],
                "hymba_train": hybrid["k4_bwd"] // TRAIN["steps"]}
    out = {}
    for name, shape in K4_BWD_TIME.items():
        for dtype in (torch.float32, torch.bfloat16):
            e = _time_k4_bwd(name, shape, gen, dev, dtype)
            e["launches_per_step"] = per_step[name]
            e["per_step_ms"] = per_step[name] * e["kernel_ms"]
            out[name if dtype == torch.float32 else name + "_bf16"] = e
    torch.cuda.empty_cache()
    emit("time_k4_bwd", ssd_scan_bwd=out)
    return out


def _time_k4_bwd(name, shape, gen, dev, dtype):
    """K4's backward at ``shape`` (B, S, H, P, G, N, Q) in ``dtype``
    (``phase_time_k4_bwd``'s account): the nine passes together and each
    alone, the plain version, CUDA-event medians, beside the bound; the
    gradient held against the plain version's in float64 within
    ``bwd_error_bound``."""
    from repro_torch.kernels import ssd as SSD
    B, S, H, P, G, N, Q = shape
    x, dt, A, Bm, Cm, _ = ssd_inputs(B, S, H, P, G, N, gen, dev)
    dy = torch.randn(x.shape, generator=gen, device=dev)
    args = [x, dt, A, Bm, Cm, dy]
    if dtype == torch.bfloat16:
        args = [a.to(dtype) if i != 2 else a for i, a in enumerate(args)]
    _, _, scr = SSD._forward(*args[:5], None, Q)
    got = SSD.ssd_scan_bwd(*args, None, scr, chunk=Q)
    want = SSD.ssd_scan_bwd_ref(*(a.double() for a in args), chunk=Q)
    bound = SSD.bwd_error_bound(*args, chunk=Q, refs=want)
    err_share = max(_ratio((g.double() - w).abs(), b)
                    for g, w, b in zip(got, want, bound) if g is not None)
    if not err_share <= 1.0:
        raise AssertionError(f"time_k4_bwd {name}: the gradient at "
                             f"{err_share:.3g}x its bound")
    del want, bound
    work = SSD.bwd_scratch(args[0], args[3], Q)
    passes = {p: cuda_ms(lambda p=p: SSD.launch_bwd(
        p, *args, None, scr, got, work, Q), 10) for p in SSD.BWD_PASSES}
    flops, nbytes = ssd_bwd_work(B, S, H, P, G, N, Q, width=dtype.itemsize)
    op_ms = (3 * flops / TF32_FLOP_PER_S if dtype == torch.float32
             else flops / BF16_FLOP_PER_S) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"dtype": str(dtype).replace("torch.", ""),
            "shape": [B, S, H, P, G, N, Q],
            "kernel_ms": cuda_ms(lambda: SSD.ssd_scan_bwd(
                *args, None, scr, chunk=Q), 20),
            "plain_ms": cuda_ms(lambda: SSD.ssd_scan_bwd_ref(
                *args, chunk=Q), 5),
            "library_ms": None, "pass_ms": passes,
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "fp32_core_ms": flops / FP32_FLOP_PER_S * 1e3,
            "err_of_bwd_error_bound": err_share}

def _k1_counts():
    from repro_torch.kernels import warehouse_agg as K
    from repro_torch.warehouse import query as Q
    from repro_torch.warehouse import standing as ST
    return K.LAUNCHES, dict(Q.PATHS), dict(ST.FOLDS)


def _k1_zero():
    from repro_torch.kernels import warehouse_agg as K
    from repro_torch.warehouse import query as Q
    from repro_torch.warehouse import standing as ST
    K.LAUNCHES = 0
    Q.PATHS.update(kernel=0, engine=0)
    ST.FOLDS.update(kernel=0, engine=0)


def _keep_multi_ingest(store):
    """Keep what the run hands ``store.ingest_fused_multi`` (its traces,
    output vectors and stream base), which the sharded phase lands again
    in a sharded sink; the ingest itself runs as before."""
    kept = {}
    ingest = store.ingest_fused_multi

    def keep(traces, out_vecs, **kw):
        kept.update(traces=traces, out_vecs=out_vecs, kw=kw)
        return ingest(traces, out_vecs, **kw)
    store.ingest_fused_multi = keep
    return kept


def _multi_run(fitted, streams, dev, sink):
    from repro_torch.core.ingest import run_skyscraper_multi
    return run_skyscraper_multi(
        [fitted] * len(streams), streams, n_cores_each=8,
        cloud_budget_core_s=len(streams) * 15_000.0 / 4,
        plan_days=MULTI_PLAN_DAYS, sink=sink, telemetry=True, device=dev)


def phase_multi(dev, m):
    """The multi-stream path, counted: ``run_skyscraper_multi`` over 256
    COVID streams of 10,800 segments (the main phase's fit, one joint
    plan per 2,160-segment window, the flight recorder on) into a store
    with a standing registry (the main plans and one subscription), so
    its one ingest folds 2,764,800 rows through K1; then the main plans
    as queries."""
    from repro_torch.configs.workloads import COVID
    from repro_torch.data.stream import generate
    from repro_torch.warehouse import SegmentStore, StandingQueries
    streams = [generate(COVID, days=MULTI_DAYS, seed=1000 + v)
               for v in range(MULTI_STREAMS)]
    T = min(s.n_segments for s in streams)
    fitted = m["fitted"]
    store = SegmentStore(out_dim=len(fitted.configs), device=dev)
    reg = StandingQueries(store)
    plans = main_plans((T - 1) // WINDOW + 1)
    handles = _registered(reg, plans, len(fitted.configs))
    plans["cloud_spend"] = standing_extra(len(fitted.configs))[0]
    kept = _keep_multi_ingest(store)
    _k1_zero()
    torch.cuda.reset_peak_memory_stats()
    out, run_s = timed(lambda: _multi_run(fitted, streams, dev, store))
    fold_launches, _, folds = _k1_counts()
    results = {}
    for name, plan in main_plans((T - 1) // WINDOW + 1).items():
        results[name] = store.query(plan)
    launches, paths, _ = _k1_counts()
    peak = torch.cuda.max_memory_allocated()
    pct = np.asarray(out["per_stream_pct"])
    tel = out["telemetry"]
    emit("multi", streams=MULTI_STREAMS, segments=T, rows=store.n_rows,
         windows=-(-T // int(MULTI_PLAN_DAYS * 86400 /
                             COVID.segment_seconds)),
         run_s=run_s, s_per_step=run_s / T, launches=launches,
         fold_launches=fold_launches, query_launches=launches -
         fold_launches, standing_folds=folds, paths=paths,
         peak_mem_bytes=peak, quality_pct=out["quality_pct"],
         per_stream_pct={"min": float(pct.min()), "max": float(pct.max()),
                         "std": float(pct.std())},
         telemetry=tel.summary(), store_telemetry=store.telemetry().summary(),
         alerts=[a.n_fired for a in out.get("alerts", [])])
    if store.n_rows != MULTI_STREAMS * T:
        raise AssertionError(f"the multi store holds {store.n_rows} rows")
    if fold_launches == 0 or folds != {"kernel": len(plans), "engine": 0} \
            or fold_launches != len(plans):
        raise AssertionError(f"the multi-stream ingest did not fold once "
                             f"per registered plan through K1: {folds}, "
                             f"{fold_launches} launches")
    if paths != {"kernel": len(results), "engine": 0} \
            or launches - fold_launches != len(results):
        raise AssertionError(f"multi-stream queries did not all take K1: "
                             f"{paths}")
    return dict(out=out, store=store, reg=reg, handles=handles, plans=plans,
                streams=streams, T=T, run_s=run_s, launches=launches,
                results=results, fitted=fitted, kept=kept)


def phase_multi_check(mm):
    """The card's multi-stream run against the same call on the card
    machine's CPU: every stored row (k, c, buffer, spend, quality) and
    every per-stream counter bit for bit; the counters against
    ``obs.telemetry_ref`` of each stream's rows. Then K1 on this path
    against the float64 oracle of the store's rows: each standing
    query's accumulators (the ingest's folds), each counted query's
    answer, and each standing answer against ``store.query``'s.
    Returns the largest error against the oracle."""
    from repro_torch.obs import TEL_KEYS, telemetry_ref
    from repro_torch.warehouse import SegmentStore
    from repro_torch.warehouse import query as Q
    store, out, T = mm["store"], mm["out"], mm["T"]
    V = MULTI_STREAMS
    cpu_store = SegmentStore(out_dim=store.out_dim, device="cpu")
    cpu, cpu_s = timed(lambda: _multi_run(mm["fitted"].to("cpu"),
                                          mm["streams"], "cpu", cpu_store))
    host, chost = store.host_rows(), cpu_store.host_rows()
    for k in host:
        if not np.array_equal(host[k], chost[k]):
            raise AssertionError(f"multi: column {k} differs from the CPU "
                                 f"run at {int(np.sum(host[k] != chost[k]))}"
                                 f" rows")
    tel, ctel = out["telemetry"], cpu["telemetry"]
    if tel.dropped != 0.0:
        raise AssertionError(f"multi: {tel.summary()}")
    replay = telemetry_ref(
        {"k": host["k"].reshape(V, T),
         "dropped": np.zeros((V, T), np.float32),
         "buffer_s": host["buffer_s"].reshape(V, T),
         "on_s": host["on_core_s"].reshape(V, T),
         "cl_s": host["cloud_core_s"].reshape(V, T)},
        int(np.argmax(mm["fitted"].power)))
    for key in TEL_KEYS:
        if not (np.array_equal(tel.counters[key], ctel.counters[key])
                and np.array_equal(tel.per_window[key], ctel.per_window[key])
                and np.array_equal(tel.counters[key], replay[key])):
            raise AssertionError(f"multi telemetry {key} differs")
    if out["per_stream_pct"] != cpu["per_stream_pct"]:
        raise AssertionError("multi: per-stream qualities differ")
    n, cols, reg = store.n_rows, store.columns, mm["reg"]
    errs = {}
    for name, plan in mm["plans"].items():
        spec, _, filters = _spec_of(plan, cols)
        acc, cnt, scale = oracle(host, n, filters, spec.keys, spec.value,
                                 spec.agg)
        _, node, post = Q.split_plan(plan)
        q = reg._queries[mm["handles"][name]]
        state = {k: v[q.slot] for k, v in reg._group_of(q).state.items()}
        e = {"fold_vs_f64": check_partial(
            f"multi {name}: folded state vs float64", host_partial(state),
            (acc, cnt), spec.agg, FLOAT_TOL * scale + 1e-6)}
        if name in mm["results"]:
            e["query_vs_f64"] = hold_oracle(
                f"multi {name}: query vs float64", mm["results"][name],
                node, post, acc, cnt, scale)
        want = mm["results"].get(name) or store.query(plan)
        e["standing_vs_query"] = hold_table(
            f"multi standing {name} vs query",
            reg.answer(mm["handles"][name]), want, node,
            acc, cnt, scale)
        errs[name] = e
    emit("multi_check", cpu_run_s=cpu_s, rows_equal=True,
         telemetry_bit_exact=True, k1_vs_f64=errs)
    return max(max(e["fold_vs_f64"], e.get("query_vs_f64", 0.0))
               for e in errs.values())


_MODEL_COST = {"small": 1.0, "medium": 2.0, "large": 4.0}


def _pinned_runtime(knobs) -> float:
    """A fixed model of one Transform call's seconds: the frames it
    keeps, their pixels and the backbone's relative size."""
    return (1e-3 * _MODEL_COST[knobs["model_size"]]
            / knobs["sample_every"] / knobs["resolution"] ** 2)


def _pinned_fit(job, dev):
    """The transform phase's fit again (its job, its 40 seeded segments,
    ``plan_segments=25``), each config's profiled runtime pinned to
    ``_pinned_runtime``: the port's ``fit`` times ``proc_fn`` on the
    wall clock, and a clock that advances only by the pinned runtimes
    makes the Pareto filter keep the same configs in every run."""
    from unittest import mock
    from repro_torch.core import api as A

    class Clock:
        now = 0.0

        def perf_counter(self):
            return self.now

    clock = Clock()

    def proc(seg, knobs):
        clock.now += _pinned_runtime(knobs)
        return job.proc_fn(seg, knobs)

    unlabeled = _segments(FIT_SEGMENTS, 11, dev)
    with mock.patch.object(A, "time", clock):
        sky = _skyscraper(dev).fit(unlabeled, proc, plan_segments=25)
    del unlabeled
    torch.cuda.empty_cache()
    return sky


def _profile_proc(sky):
    """The pool's Transform stand-in: a segment is a content category,
    and the quality of a config on it is the fitted profile's
    (``sky.centers``), so the host does no Transform work."""
    index = {tuple(sorted(c.items())): k for k, c in enumerate(sky.configs)}
    centers = np.asarray(sky.centers, np.float32)

    def proc(seg, knobs):
        return None, float(centers[seg, index[tuple(sorted(knobs.items()))]])
    return proc


def _sky_on(sky, dev):
    """The same fitted handle on ``dev`` (its state installed as it is),
    with the profile's qualities as its Transform."""
    from repro_torch.core.api import Skyscraper
    out = Skyscraper(fps=sky.fps, segment_seconds=sky.tau,
                     n_categories=sky.n_categories, seed=sky.seed,
                     device=dev)
    out.set_resources(num_cores=sky.num_cores, buffer_gb=sky.buffer_gb,
                      cloud_budget_core_s=sky.cloud_budget)
    out.knobs = dict(sky.knobs)
    out._install(configs=sky.configs, cost=sky.cost,
                 power=sky.tables.power.cpu().numpy(), centers=sky.centers,
                 forecaster=_tree_to(sky.forecaster, dev),
                 n_split=sky.n_split, interval=sky.interval,
                 proc_fn=_profile_proc(sky), plan_segments=sky._plan_every)
    return out


def _prio(sid):
    return float(1 + sid % POOL_BANDS)


def pool_script(sky, dev, sink):
    """The pool's script: 384 streams, 512, then churn to 513 and 1,100
    live streams (every seventh admission retires the oldest stream),
    through slot caps 512, 1,024 and 2,048; then the capacity squeezed to
    60% of the last tick's demand under the joint plan. Each tick's
    segments are categories drawn per stream from one seeded generator.
    Returns (log of statuses per tick, pool, per-section seconds and
    ticks, the squeeze's capacity)."""
    from repro_torch.core.api import SkyscraperPool
    C = sky.centers.shape[0]
    pool = SkyscraperPool(sky, n_streams=POOL_BUCKETS[0], sink=sink,
                          telemetry=True, device=dev,
                          priorities=[_prio(v) for v in
                                      range(POOL_BUCKETS[0])])
    rng = np.random.default_rng(2024)
    nxt, admitted = [POOL_BUCKETS[0]], [POOL_BUCKETS[0]]
    log, sections, capacity = [], [], None

    def grow_to(live):
        while pool.V < live:
            pool.admit(nxt[0], priority=_prio(nxt[0]))
            nxt[0] += 1
            admitted[0] += 1
            if admitted[0] % 7 == 0:
                pool.retire(pool.streams[0])

    def ticks(n):
        t0 = time.perf_counter()
        for _ in range(n):
            log.append(pool.process(list(rng.integers(0, C, pool.V)))[0])
        return time.perf_counter() - t0

    for live, n in zip(POOL_BUCKETS, POOL_TICKS):
        grow_to(live)
        secs = ticks(n - 1)
        # the demand of the section's last tick (the squeeze's base)
        before = pool._tel.counters["onprem_core_s"].astype(np.float64).sum()
        secs += ticks(1)
        sections.append({"live": pool.V, "cap": pool.cap, "ticks": n,
                         "seconds": secs})
    demand = pool._tel.counters["onprem_core_s"].astype(np.float64).sum() \
        - before
    capacity = POOL_SQUEEZE * demand
    pool.capacity_core_s = capacity
    pool.joint_plan = True
    sections.append({"live": pool.V, "cap": pool.cap,
                     "ticks": POOL_TICKS[-1],
                     "seconds": ticks(POOL_TICKS[-1])})
    return log, pool, sections, capacity, admitted[0]


def _replan_ms(pool, joint):
    from repro_torch.core import api as PA
    sky = pool.sky
    budget = sky._f32(sky.num_cores * sky.tau)
    if joint:
        fn = lambda: PA._pool_replan_stacked(                   # noqa: E731
            sky.forecaster, pool._bufs, pool._centers, sky.tables.cost,
            sky._f32(pool.capacity_core_s), True, pool._active,
            pool._priority, n_split=sky.n_split, interval=sky.interval)
    else:
        fn = lambda: PA._pool_replan(                           # noqa: E731
            sky.forecaster, pool._bufs, pool._centers, sky.tables.cost,
            budget, True, n_split=sky.n_split, interval=sky.interval)
    return wall_ms(fn, 5)


def phase_pool(dev, t):
    """The serving pool, counted: ``SkyscraperPool`` over the transform
    phase's job fitted with pinned runtimes (``_pinned_fit``) through
    ``pool_script`` (200 ticks) with the flight recorder and a sink
    store carrying a standing subscription, so every tick folds its rows
    through K1."""
    from repro_torch.warehouse import SegmentStore
    fitted, fit_s = timed(lambda: _pinned_fit(t["job"], dev))
    sky = _sky_on(fitted, dev)
    sink = SegmentStore(out_dim=len(sky.configs), device=dev)
    reg, watch, handle = _shed_watch(sink)
    _k1_zero()
    torch.cuda.reset_peak_memory_stats()
    (log, pool, sections, capacity, admitted), secs = timed(
        lambda: pool_script(sky, dev, sink))
    launches, _, folds = _k1_counts()
    peak = torch.cuda.max_memory_allocated()
    replan_ms = {"independent": _replan_ms(pool, False),
                 "joint": _replan_ms(pool, True)}
    # the squeeze: shed share per band, and no band shed above a kept one
    squeeze = log[-POOL_TICKS[-1]:]
    bands = {b: [0, 0] for b in range(1, POOL_BANDS + 1)}
    for tick in squeeze:
        shed = [s["stream_id"] for s in tick if s["shed"]]
        kept = [s["stream_id"] for s in tick if not s["dropped"]]
        if shed and kept and max(_prio(x) for x in shed) > \
                min(_prio(x) for x in kept):
            raise AssertionError("a higher band was shed while a lower "
                                 "one was kept")
        for s in tick:
            bands[int(_prio(s["stream_id"]))][0] += s["shed"]
            bands[int(_prio(s["stream_id"]))][1] += 1
    n_ticks = len(log)
    emit("pool", fit_s=fit_s, configs=len(sky.configs),
         cost_core_s=sky.cost.tolist(), ticks=n_ticks, seconds=secs,
         admitted=admitted,
         sections=[{**sec, "ticks_per_s": sec["ticks"] / sec["seconds"]}
                   for sec in sections],
         replan_ms=replan_ms, capacity_core_s=capacity,
         shed_share={b: v[0] / max(v[1], 1) for b, v in bands.items()},
         rows=sink.n_rows, launches=launches, fold_launches=folds["kernel"],
         peak_mem_bytes=peak, telemetry=pool.telemetry().summary(),
         alerts_fired=[a.n_fired for a in pool.alerts])
    caps = sorted({sec["cap"] for sec in sections})
    if n_ticks != sum(POOL_TICKS) or len(caps) != 3:
        raise AssertionError(f"pool: {n_ticks} ticks through caps {caps}")
    if not sum(v[0] for v in bands.values()):
        raise AssertionError("the squeeze shed nothing")
    if folds != {"kernel": n_ticks, "engine": 0} or launches != n_ticks:
        raise AssertionError(f"the pool's ticks did not each fold once "
                             f"through K1: {folds}, {launches}")
    return dict(log=log, pool=pool, sink=sink, sky=fitted, reg=reg,
                handle=handle, launches=launches, watch=watch)


def _shed_watch(sink):
    """A registry on ``sink`` with the pool's one subscription: each
    stream's lowest quality, fired where a segment was shed. Returns
    (registry, plan, the plan's handle)."""
    from repro_torch.warehouse import Filter, GroupBy, StandingQueries
    reg = StandingQueries(sink)
    watch = (GroupBy("stream_id", "quality", agg="min", num_groups=2048),)
    sid = reg.subscribe(watch, Filter("quality", "le", 0.0),
                        name="shed-watch")
    return reg, watch, reg._subs[sid].handle


def phase_pool_check(pp, dev):
    """The pool's script replayed on the CPU: every status, every
    flight-recorder counter and every sink row bit for bit; then, plans
    pinned, each stream's trajectory in a small pool on the card against
    the single-stream ``switch_step`` run alone. K1 on this path: the
    shed-watch's accumulators, folded by K1 once per tick, against the
    CPU registry's (plain versions) and the float64 oracle of the sink's
    rows, exactly (a min), and its alerts against the CPU's. Returns the
    largest error against the oracle."""
    from repro_torch.core.api import SkyscraperPool
    from repro_torch.core.switcher import init_state, switch_step
    from repro_torch.warehouse import SegmentStore
    sky = _sky_on(pp["sky"], "cpu")
    cpu_sink = SegmentStore(out_dim=len(sky.configs), device="cpu")
    cpu_reg, _, cpu_handle = _shed_watch(cpu_sink)
    (log, pool, _, _, _), cpu_s = timed(
        lambda: pool_script(sky, "cpu", cpu_sink))
    if log != pp["log"]:
        bad = next(i for i, (a, b) in enumerate(zip(log, pp["log"]))
                   if a != b)
        raise AssertionError(f"pool: tick {bad} differs from the CPU")
    a, b = pp["pool"]._tel.counters, pool._tel.counters
    for key in a:
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"pool telemetry {key} differs")
    ha, hb = pp["sink"].host_rows(), cpu_sink.host_rows()
    for key in ha:
        if not np.array_equal(ha[key], hb[key]):
            raise AssertionError(f"pool sink column {key} differs")
    fold_err = _hold_shed_watch(pp, ha, cpu_reg, cpu_handle, pool)
    # pinned plans: each stream alone through the single-stream switch
    card = _sky_on(pp["sky"], dev)
    card._plan_every = 10 ** 9
    V, n_ticks = POOL_PINNED
    small = SkyscraperPool(card, n_streams=V, slot_chunk=8, device=dev)
    state = {v: init_state(card.tables) for v in range(V)}
    pending = {v: None for v in range(V)}
    rng = np.random.default_rng(5)
    steps = 0
    for tick in range(n_ticks):
        if tick % 5 == 4:
            sid = 1000 + tick
            small.admit(sid, priority=_prio(sid))
            state[sid], pending[sid] = init_state(card.tables), None
        if tick % 7 == 6:
            gone = small.streams[tick % small.V]
            small.retire(gone)
            del state[gone], pending[gone]
        mults = {s: float(np.float32(0.5 + rng.random()))
                 for s in small.streams}
        segs = {s: int(rng.integers(0, card.centers.shape[0]))
                for s in small.streams}
        statuses, _ = small.process(segs, arrival_mults=mults)
        for st in statuses:
            sid = st["stream_id"]
            cur = dict(state[sid])
            if pending[sid] is not None:
                cur["qual_prev"] = card._f32(pending[sid])
            cur, o = switch_step(cur, torch.zeros(len(card.configs),
                                                  device=dev),
                                 card._f32(mults[sid]), card.alpha,
                                 card.tables)
            state[sid] = cur
            if (st["k"], st["category"], st["dropped"]) != (
                    int(o["k"]), int(o["c"]), bool(o["dropped"])) or \
                    np.float32(st["buffer_s"]) != \
                    o["buffer_s"].cpu().numpy():
                raise AssertionError(f"pool stream {sid} left its "
                                     f"single-stream trajectory")
            pending[sid] = None if st["dropped"] else st["quality"]
            steps += 1
    emit("pool_check", cpu_s=cpu_s, statuses_equal=True,
         telemetry_bit_exact=True, sink_rows_equal=True,
         shed_watch_vs_f64=fold_err, pinned_oracle_steps=steps)
    return fold_err


def _hold_shed_watch(pp, host, cpu_reg, cpu_handle, cpu_pool):
    """The card's shed-watch (K1 folds) against the CPU's (plain-version
    folds) and the float64 oracle of the sink's rows: accumulators,
    counts and answer equal, and the last tick's alerts the same."""
    reg, sink = pp["reg"], pp["sink"]
    q = reg._queries[pp["handle"]]
    state = {k: v[q.slot] for k, v in reg._group_of(q).state.items()}
    cq = cpu_reg._queries[cpu_handle]
    cstate = {k: v[cq.slot] for k, v in cpu_reg._group_of(cq).state.items()}
    spec, _, filters = _spec_of(pp["watch"], sink.columns)
    acc, cnt, scale = oracle(host, sink.n_rows, filters, spec.keys,
                             spec.value, spec.agg)
    err = check_partial("pool shed-watch vs float64", host_partial(state),
                        (acc, cnt), spec.agg, FLOAT_TOL * scale + 1e-6)
    check_partial("pool shed-watch vs the CPU's", host_partial(state),
                  host_partial(cstate), spec.agg, np.zeros_like(scale))
    (t1, m1), (t0, m0) = reg.answer(pp["handle"]), cpu_reg.answer(cpu_handle)
    if not (torch.equal(m1.cpu(), m0) and all(torch.equal(t1[c].cpu(), t0[c])
                                              for c in t0)):
        raise AssertionError("pool shed-watch: answer differs from the CPU")
    card_alerts, cpu_alerts = pp["pool"].alerts, cpu_pool.alerts
    if [a.name for a in card_alerts] != [a.name for a in cpu_alerts] or \
            not all(np.array_equal(a.fired, b.fired)
                    for a, b in zip(card_alerts, cpu_alerts)):
        raise AssertionError("pool shed-watch: alerts differ from the CPU")
    if int(cnt.sum()) != sink.n_rows or not card_alerts:
        raise AssertionError("pool shed-watch: the squeeze fired nothing")
    return err


def wide_plan():
    """The compressed sum's plan: ``out`` summed per category."""
    from repro_torch.warehouse import GroupBy
    return (GroupBy("category", "out", agg="sum", num_groups=4),)


def row_plans():
    """A row TopK and a row plan over camera 7."""
    from repro_torch.warehouse import Filter, Project, TopK
    return {"topk": (Filter("stream_id", "eq", 7), TopK(16, by="on_core_s")),
            "rows": (Filter("stream_id", "eq", 7), Filter("t", "lt", 600),
                     Project(("t", "k", "quality", "buffer_s")))}


def _registered(reg, plans, n_configs):
    """Register ``plans`` and the cloud-spend subscription on ``reg``;
    returns their handles by name."""
    handles = {name: reg.register(plan) for name, plan in plans.items()}
    sub_plan, predicate, _ = standing_extra(n_configs)
    sid = reg.subscribe(sub_plan, predicate, name="cloud_spend")
    handles["cloud_spend"] = reg._subs[sid].handle
    return handles


def _land_days(store, day, cameras):
    """Cameras 0..cameras-1: camera 0's day, then ``fill``."""
    store.ingest_fused({src: day[dst] for src, dst in _RUN_COLUMNS},
                       day["out"], stream_id=0)
    fill(store, day, cameras)


def _same_layout(what, got, want_cols, want_counts, rows_of):
    """Each shard of ``got`` holds, bit for bit and in order, the rows
    ``rows_of(s)`` (a device index) of ``want_cols``."""
    for s in range(got.n_shards):
        idx = rows_of(s)
        if int(got.n_rows_by_shard[s]) != len(idx):
            raise AssertionError(f"{what}: shard {s} holds "
                                 f"{got.n_rows_by_shard[s]} rows, "
                                 f"{len(idx)} expected")
        for k, col in got.columns.items():
            if not torch.equal(col[s, :len(idx)],
                               want_cols[k].index_select(0, idx)):
                raise AssertionError(f"{what}: shard {s} column {k} "
                                     "differs")
    if int(np.sum(got.n_rows_by_shard)) != want_counts:
        raise AssertionError(f"{what}: {got.n_rows} rows, {want_counts} "
                             "expected")


def _shard_view_host(cols, counts):
    """A stacked view's live rows, shard-major, as host numpy."""
    return {k: np.concatenate([v[s, :n].cpu().numpy()
                               for s, n in enumerate(counts)])
            for k, v in cols.items()}


def phase_sharded(dev, m, mm, pp):
    """The sharded warehouse, K1's counts set to 0 just before each of
    its two driven parts and read just after: an 8-shard
    ``ShardedStore`` of the main phase's 256 camera-days (32 cameras a
    shard), the main plans and subscription registered first so each
    ingest folds through K1; the five plans through ``execute_sharded``
    (one K1 partial per shard), a compressed sum, a row TopK and a row
    plan; ``rebalance`` to 4 shards; the multi phase's kept run landed in
    an 8-shard sink and the pool script again into a 4-shard sink; a
    ``TieredStore`` of 8 camera-days saved and loaded; then (the second
    part) a ``ShardedTieredStore`` keeping one camera-day hot per shard
    and the plans over its two-tier view. Everything is held, and timed,
    outside the counted parts."""
    from repro_torch.runtime.elastic import rebalance
    from repro_torch.warehouse import (SegmentStore, ShardedStore,
                                       ShardedTieredStore, StandingQueries,
                                       TieredStore, load_warehouse,
                                       save_warehouse, to_host)
    from repro_torch.warehouse import query as Q
    t_phase = time.perf_counter()
    main, day, T = m["store"], m["day"], m["stream"].n_segments
    D = main.out_dim
    plans = main_plans((T - 1) // WINDOW + 1)
    sec = {}
    # -- the first counted part ------------------------------------------
    store = ShardedStore(out_dim=D, n_shards=SHARDS, device=dev)
    reg = StandingQueries(store)
    handles = _registered(reg, plans, D)
    _k1_zero()
    torch.cuda.reset_peak_memory_stats()
    _, sec["fill"] = timed(lambda: _land_days(store, day, CAMERAS))
    fold_launches, _, folds = _k1_counts()
    results = {name: store.query(plan) for name, plan in plans.items()}
    query_launches = _k1_counts()[0] - fold_launches
    compressed = store.query(wide_plan(), compressed=True, seed=1)
    row_answers = {k: store.query(p) for k, p in row_plans().items()}
    alerts = reg.poll()
    new, sec["rebalance"] = timed(lambda: rebalance(store, REBALANCE_SHARDS,
                                                    device=dev))
    re_results = {name: new.query(plan) for name, plan in plans.items()}
    msink = ShardedStore(out_dim=mm["store"].out_dim, n_shards=SHARDS,
                         device=dev)
    kept = mm.pop("kept")
    _, sec["multi_sink"] = timed(lambda: msink.ingest_fused_multi(
        kept["traces"], kept["out_vecs"], **kept["kw"]))
    psink = ShardedStore(out_dim=pp["sink"].out_dim, n_shards=POOL_SHARDS,
                         device=dev)
    preg, _, phandle = _shed_watch(psink)
    (plog, ppool, _, _, _), sec["pool"] = timed(
        lambda: pool_script(_sky_on(pp["sky"], dev), dev, psink))
    small = SegmentStore(out_dim=D, device=dev)
    _land_days(small, day, CKPT_DAYS)
    ts = TieredStore(small, seed=0, device=dev)
    ts.spill(keep_hot=T)
    path = ROOT / "build" / "chip_smoke_warehouse.rsk"
    _, sec["save"] = timed(lambda: save_warehouse(str(path), ts))
    back, sec["load"] = timed(lambda: load_warehouse(str(path), device=dev))
    ck_card = {name: (ts.query(p), back.query(p))
               for name, p in plans.items()}
    launches, paths, _ = _k1_counts()
    host, n = store.host_rows(), store.n_rows
    counts = store.n_rows_by_shard.copy()
    answers = {name: reg.answer(h) for name, h in handles.items()}
    answers = {k: ({c: v.clone() for c, v in t.items()}, mk.clone())
               for k, (t, mk) in answers.items()}
    plan_ms = {name: {"sharded": wall_ms(lambda p=p: store.query(p), 5),
                      "single": wall_ms(lambda p=p: main.query(p), 5),
                      "rebalanced": wall_ms(lambda p=p: new.query(p), 5)}
               for name, p in plans.items()}
    k1 = time_shards(store, plans, host)
    # rebalance: new shard j holds old shards j, j + 4, ... in order
    cap = store.capacity
    _same_layout("rebalance", new,
                 {k: v.reshape((-1,) + v.shape[2:])
                  for k, v in store.columns.items()}, n,
                 lambda j: torch.cat([
                     torch.arange(s * cap, s * cap + int(counts[s]),
                                  device=dev)
                     for s in range(j, SHARDS, REBALANCE_SHARDS)]))
    # -- the second counted part: the two-tier view ----------------------
    tiered = ShardedTieredStore(store, seed=0, device=dev)
    _k1_zero()
    spilled, sec["spill"] = timed(lambda: tiered.spill(keep_hot=T))
    (vcols, vcounts), sec["view"] = timed(tiered.shard_source)
    tier_results = {name: tiered.query(plan) for name, plan in plans.items()}
    tier_launches, tier_paths, _ = _k1_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, p in plans.items():
        plan_ms[name]["two_tier"] = wall_ms(lambda p=p: tiered.query(p), 5)
    file_bytes = path.stat().st_size

    # -- hold ------------------------------------------------------------
    errs = {}
    want_folds = CAMERAS * len(handles)
    if folds != {"kernel": want_folds, "engine": 0} \
            or fold_launches != want_folds:
        raise AssertionError(f"sharded: the ingests did not each fold "
                             f"once per query through K1: {folds}, "
                             f"{fold_launches} launches")
    if query_launches != SHARDS * len(plans) \
            or tier_launches != SHARDS * len(plans) \
            or tier_paths != {"kernel": len(plans), "engine": 0}:
        raise AssertionError(f"sharded: {query_launches} and "
                             f"{tier_launches} K1 launches for "
                             f"{len(plans)} plans over {SHARDS} shards")
    if not (n == main.n_rows == CAMERAS * T
            and np.all(counts == CAMERAS // SHARDS * T)):
        raise AssertionError(f"sharded: {store!r}")
    shard0 = {k: v[0] for k, v in store.columns.items()}
    oracles = {}
    for name, plan in {**plans, "cloud_spend": m["standing_plans"][
            "cloud_spend"]}.items():
        spec, _, filters = _spec_of(plan, shard0)
        oracles[name] = oracle(host, n, filters, spec.keys, spec.value,
                               spec.agg)
    for name, plan in plans.items():
        _, node, post = Q.split_plan(plan)
        acc, cnt, scale = oracles[name]
        errs[name] = {
            "vs_f64": hold_oracle(f"sharded {name} vs float64",
                                  results[name], node, post, acc, cnt,
                                  scale),
            "vs_single": hold_table(f"sharded {name} vs the single store",
                                    results[name], m["results"][name], node,
                                    acc, cnt, scale),
            "rebalanced_vs_f64": hold_oracle(
                f"rebalanced {name} vs float64", re_results[name], node,
                post, acc, cnt, scale)}
    for name, h in handles.items():
        _, node, _ = Q.split_plan(m["standing_plans"][name])
        acc, cnt, scale = oracles[name]
        errs.setdefault(name, {})["standing_vs_single"] = hold_table(
            f"sharded standing {name} vs the single registry",
            answers[name], m["reg"].answer(m["handles"][name]), node, acc,
            cnt, scale)
        errs[name]["rebalanced_standing"] = hold_table(
            f"rebalanced standing {name}", new.standing.answer(h),
            answers[name], node, acc, cnt, scale)
        t1, m1 = reg.answer(h)                    # after the spill
        t0, m0 = answers[name]
        if not (torch.equal(m0, m1) and all(torch.equal(t0[c], t1[c])
                                            for c in t0)):
            raise AssertionError(f"sharded tiers: the standing answer "
                                 f"{name} moved")
    (alert,) = alerts
    spend = alert.table["cloud_core_s"].astype(np.float64)
    if not np.array_equal(alert.fired, (alert.table["count"] > 0)
                          & (spend >= reg._subs[alert.sub].predicate.value)):
        raise AssertionError("sharded: the alert mask is not the predicate's")
    # the compressed sum: counts exact, within S (max|ref| / 127 + 1e-3)
    oracles["wide"] = oracle(host, n, [], (("category", 4, 0),), "out",
                             "sum")
    acc, cnt, _ = oracles["wide"]
    ct = compressed[0]
    if not np.array_equal(ct["count"].cpu().numpy(), cnt):
        raise AssertionError("sharded: compressed counts differ")
    comp_err = float(np.abs(ct["out"].double().cpu().numpy() - acc).max())
    comp_bound = SHARDS * (float(np.abs(acc).max()) / 127 + 1e-3)
    if comp_err > comp_bound:
        raise AssertionError(f"sharded: compressed sum off by {comp_err} "
                             f"(bound {comp_bound})")
    # the row TopK and the row plan: the single store's rows exactly
    for what, plan in row_plans().items():
        got, want = to_host(*row_answers[what]), to_host(*main.query(plan))
        for k in want:
            if k != "index" and not np.array_equal(got[k], want[k]):
                raise AssertionError(f"sharded {what}: column {k} differs")
    # the two-tier view: within the quantization bound, the counters
    bound = tiered.max_cold_scale()
    view = _shard_view_host(vcols, vcounts)
    vshard = {k: v[0] for k, v in vcols.items()}
    tier_errs = {name: _tier_answer(f"sharded {name}", plan,
                                    tier_results[name], results[name],
                                    vshard, view, host, n, bound)
                 for name, plan in plans.items()}
    tel = tiered.telemetry()
    if (tel.spill_events, tel.spilled_rows, tel.dequantize_events,
            tel.n_rows) != (1, spilled, 1, n) or \
            spilled < n - SHARDS * (T + store.chunk_rows):
        raise AssertionError(f"sharded tier counters: {tel.summary()}")
    # the multi sink: shard s holds streams s, s + 8, ... in order
    MT = mm["T"]
    _same_layout("multi sink", msink,
                 {k: v[:mm["store"].n_rows]
                  for k, v in mm["store"].columns.items()},
                 mm["store"].n_rows, lambda s: torch.cat([
                     torch.arange(v * MT, (v + 1) * MT, device=dev)
                     for v in range(s, MULTI_STREAMS, SHARDS)]))
    # the pool sink: the same statuses, each shard the single sink's rows
    # of its streams in order, the same alerts and shed-watch answer
    if plog != pp["log"]:
        raise AssertionError("sharded pool: statuses differ")
    ph = pp["sink"].host_rows()
    owner = ph["stream_id"] % POOL_SHARDS
    _same_layout("pool sink", psink,
                 {k: torch.as_tensor(v, device=dev) for k, v in ph.items()},
                 pp["sink"].n_rows,
                 lambda s: torch.as_tensor(np.flatnonzero(owner == s),
                                           device=dev))
    card_alerts = pp["pool"].alerts
    if [a.name for a in ppool.alerts] != [a.name for a in card_alerts] or \
            not all(np.array_equal(a.fired, b.fired)
                    for a, b in zip(ppool.alerts, card_alerts)):
        raise AssertionError("sharded pool: alerts differ")
    (t1, m1), (t0, m0) = preg.answer(phandle), pp["reg"].answer(pp["handle"])
    if not (torch.equal(m1, m0) and all(torch.equal(t1[c], t0[c])
                                        for c in t0)):
        raise AssertionError("sharded pool: the shed-watch differs")
    # the checkpoint: every array bit for bit, the answers on the card
    # within tolerance, and bit for bit on the CPU's plain path
    for mine, theirs in ((back.hot.columns, ts.hot.columns),
                         (back.cold_q, ts.cold_q),
                         (back.cold_scales, ts.cold_scales),
                         (back.cold_int, ts.cold_int)):
        for k, v in theirs.items():
            if not torch.equal(mine[k], v):
                raise AssertionError(f"checkpoint: {k} differs")
    if (back.n_cold, back.hot.n_rows, back.hot.t_max) != (
            ts.n_cold, ts.hot.n_rows, ts.hot.t_max):
        raise AssertionError("checkpoint: the tier's counts differ")
    cpu_back = load_warehouse(str(path), device="cpu")
    path.unlink()
    vc, vn = ts.materialize()
    cpu_view = ({k: v.cpu() for k, v in vc.items()}, vn)
    vhost = {k: v[:vn].numpy() for k, v in cpu_view[0].items()}
    for name, plan in plans.items():
        spec, _, filters = _spec_of(plan, small.columns)
        acc, cnt, scale = oracle(vhost, vn, filters, spec.keys, spec.value,
                                 spec.agg)
        _, node, _ = Q.split_plan(plan)
        a0, a1 = ck_card[name]
        hold_table(f"checkpoint {name} on the card", a1, a0, node, acc, cnt,
                   scale)
        (g, gm), (w, wm) = cpu_back.query(plan), Q.execute(cpu_view, plan)
        if not (torch.equal(gm, wm) and all(torch.equal(g[c], w[c])
                                            for c in w)):
            raise AssertionError(f"checkpoint {name}: not bit-identical")
    stel = store.telemetry()
    emit("sharded", phase_s=time.perf_counter() - t_phase, shards=SHARDS,
         rows=n, rows_by_shard=counts.tolist(),
         imbalance=float(np.max(counts) / np.mean(counts)),
         capacity=store.capacity, seconds=sec,
         fill_s_per_ingest=sec["fill"] / CAMERAS, main_fill_s=m["fill_s"],
         launches=launches + tier_launches, fold_launches=fold_launches,
         query_launches=query_launches, tier_launches=tier_launches,
         paths=paths, plan_ms=plan_ms, errors=errs, tier_errors=tier_errs,
         compressed={"max_abs_err": comp_err, "bound": comp_bound},
         spilled_rows=spilled, max_cold_scale=bound,
         rebalanced={"shards": REBALANCE_SHARDS, "capacity": new.capacity,
                     "rows_by_shard": new.n_rows_by_shard.tolist()},
         multi_sink_rows=msink.n_rows_by_shard.tolist(),
         pool_sink_rows=psink.n_rows_by_shard.tolist(),
         checkpoint={"rows": ts.n_rows, "cold_rows": ts.n_cold,
                     "file_bytes": file_bytes, "save_s": sec["save"],
                     "load_s": sec["load"]},
         peak_mem_bytes=peak, store_telemetry=stel.summary(),
         tier_telemetry=tel.summary(), alerts_fired=alert.n_fired,
         k1_shard=k1)
    worst = max(max(e.get("vs_f64", 0.0), e.get("rebalanced_vs_f64", 0.0))
                for e in errs.values())
    want = {"plans": _on_host(results), "compressed": _on_host(compressed),
            "rows": {k: to_host(*a) for k, a in row_answers.items()},
            "alerts": [(a.name, a.fired) for a in alerts],
            "standing": _on_host(answers), "oracles": oracles,
            "store": {"counts": counts, "capacity": store.capacity,
                      "digests": _host_digests(host, counts)},
            "rebalanced": {"plans": _on_host(re_results),
                           "standing": _on_host({
                               name: new.standing.answer(h)
                               for name, h in handles.items()}),
                           "counts": new.n_rows_by_shard.copy(),
                           "capacity": new.capacity,
                           "digests": _shard_digests(new)},
            "tier": {"plans": _on_host(tier_results), "spilled": spilled,
                     "digests": _cold_digests(tiered),
                     "max_cold_scale": bound}}
    del new, msink, psink, tiered, vcols
    torch.cuda.empty_cache()
    return dict(launches=launches + tier_launches, k1=k1,
                err=max(worst, k1["max_abs_err"],
                        max(e[0] for e in tier_errs.values())), want=want)


def _on_host(answers):
    """Query answers ``{name: (table, mask)}`` (or one answer) as CPU
    tensors."""
    if isinstance(answers, tuple):
        table, mask = answers
        return {k: v.cpu() for k, v in table.items()}, mask.cpu()
    return {k: _on_host(a) for k, a in answers.items()}


def _digest(x) -> str:
    """sha256 of a tensor's or an array's bytes."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _host_digests(host, counts):
    """``{shard: {column: digest}}`` of shard-major host rows."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    return {s: {k: _digest(v[starts[s]:starts[s + 1]])
                for k, v in host.items()} for s in range(len(counts))}


def _shard_digests(store):
    """``{shard: {column: digest of its live rows}}`` for the shards this
    process holds."""
    return {s: {k: _digest(v[j, :int(store.n_rows_by_shard[s])])
                for k, v in store.columns.items()}
            for j, s in enumerate(store.shards)}


def _cold_digests(tiered):
    """``{shard: {array: digest}}`` of a tier's cold codes, scales and
    integer columns (the rows past a shard's depth too) and hot columns,
    for the shards this process holds."""
    arrays = {**{f"q.{k}": v for k, v in tiered.cold_q.items()},
              **{f"scale.{k}": v for k, v in tiered.cold_scales.items()},
              **{f"int.{k}": v for k, v in tiered.cold_int.items()},
              **{f"hot.{k}": v for k, v in tiered.hot.columns.items()}}
    return {s: {k: _digest(v[j]) for k, v in arrays.items()}
            for j, s in enumerate(tiered.shards)}


def _dist_world(n_split: int = SHARDS) -> int:
    """One rank per visible card: the most cards, at least one, whose
    count divides ``n_split`` (the shards, or a global batch's rows)."""
    n = torch.cuda.device_count()
    return max(w for w in range(1, n + 1) if n_split % w == 0)


def _dist_rank(rank, world, tmp, T):
    """One rank of the ``dist`` phase, in its own process (spawned): it
    joins the NCCL group through a file under ``tmp``, drives the
    sharded warehouse on its card and writes what it saw to
    ``tmp/rank<r>.pt``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group
    tmp = Path(tmp)
    dev = init_shard_group(init_method=f"file://{tmp / 'pg_init'}",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        torch.save(_dist_drive(dev, world, tmp, T), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_drive(dev, world, tmp, T):
    """The ``sharded`` phase's first counted part and its two-tier view
    on a store spread over the ranks: K1's counts set to 0 just before
    the fill and read after the queries, and again around the view's
    queries. Returns host copies, digests, counts and times."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.runtime.elastic import rebalance
    from repro_torch.warehouse import (ShardedStore, ShardedTieredStore,
                                       StandingQueries, to_host)
    group = dist.group.WORLD
    day = {k: v.to(dev) for k, v in torch.load(tmp / "day.pt").items()}
    D = day["out"].shape[1]
    plans = main_plans((T - 1) // WINDOW + 1)
    sec = {}
    store = ShardedStore(out_dim=D, n_shards=SHARDS, device=dev, group=group)
    reg = StandingQueries(store)
    handles = _registered(reg, plans, D)
    torch.cuda.reset_peak_memory_stats()
    _k1_zero()
    _, sec["fill"] = timed(lambda: _land_days(store, day, CAMERAS))
    fold_launches, _, folds = _k1_counts()
    results, gathered = {}, {}
    for name, plan in plans.items():
        mesh.GATHERED.update(calls=0, bytes=0)
        results[name] = store.query(plan)
        gathered[name] = dict(mesh.GATHERED)
    query_launches = _k1_counts()[0] - fold_launches
    compressed = store.query(wide_plan(), compressed=True, seed=1)
    row_answers = {k: store.query(p) for k, p in row_plans().items()}
    alerts = reg.poll()
    answers = {name: reg.answer(h) for name, h in handles.items()}
    plan_ms = {name: wall_ms(lambda p=p: store.query(p), 5)
               for name, p in plans.items()}
    again = {name: _same_answer(store.query(p), results[name])
             for name, p in plans.items()}
    host, counts = store.host_rows(), store.n_rows_by_shard.copy()
    telemetry = store.telemetry().summary()
    g4 = group if REBALANCE_SHARDS % world == 0 else dist.new_group(
        list(range(REBALANCE_SHARDS)))
    new, sec["rebalance"] = timed(lambda: rebalance(
        store, REBALANCE_SHARDS, device=dev, group=g4))
    rebalanced = None if new is None else {
        "plans": _on_host({n: new.query(p) for n, p in plans.items()}),
        "standing": _on_host({n: new.standing.answer(h)
                              for n, h in handles.items()}),
        "counts": new.n_rows_by_shard.copy(), "capacity": new.capacity,
        "digests": _shard_digests(new)}
    del new
    tiered = ShardedTieredStore(store, seed=0, device=dev)
    _k1_zero()
    spilled, sec["spill"] = timed(lambda: tiered.spill(keep_hot=T))
    tier_results = {n: tiered.query(p) for n, p in plans.items()}
    tier_launches = _k1_counts()[0]
    return {
        "shards": store.shards, "counts": counts,
        "capacity": store.capacity, "digests": _host_digests(host, counts),
        "plans": _on_host(results), "again": again,
        "compressed": _on_host(compressed),
        "rows": {k: to_host(*a) for k, a in row_answers.items()},
        "alerts": [(a.name, a.fired) for a in alerts],
        "standing": _on_host(answers), "rebalanced": rebalanced,
        "tier": {"plans": _on_host(tier_results), "spilled": spilled,
                 "digests": _cold_digests(tiered),
                 "max_cold_scale": tiered.max_cold_scale()},
        "launches": {"folds": fold_launches, "fold_paths": folds,
                     "queries": query_launches, "tier": tier_launches},
        "gathered": gathered, "plan_ms": plan_ms, "seconds": sec,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "telemetry": telemetry}


def _same_answer(a, b) -> bool:
    """Two answers ``(table, mask)`` bit for bit."""
    (ta, ma), (tb, mb) = a, b
    return torch.equal(ma.cpu(), mb.cpu()) and set(ta) == set(tb) and all(
        torch.equal(ta[k].cpu().view(torch.uint8) if ta[k].is_floating_point()
                    else ta[k].cpu(),
                    tb[k].cpu().view(torch.uint8) if tb[k].is_floating_point()
                    else tb[k].cpu()) for k in ta)


def phase_dist(m, sd, smi):
    """The sharded warehouse across cards: one NCCL rank per visible card
    (``_dist_world``), spawned under a deadline, each holding its block
    of the 8 shards. The ranks land the ``sharded`` phase's 256
    camera-days with its plans and subscription registered, so each
    ingest folds through K1 on the rank that owns its shard; then the
    five plans (each rank gathers every shard's partial in shard order),
    the compressed sum, the row TopK and row plan, the alerts and
    standing answers, ``rebalance`` to 4 shards and the two-tier view.

    Held, against the ``sharded`` phase's stacked store: every answer
    the same on every rank, bit for bit; every stored row, the counts
    and capacity, the row TopK (its global row ids) and row plan, the
    alert masks, the rebalanced rows and every cold array bit for bit;
    counts, keys, masks, max and min of every answer exactly, and float
    sums bit for bit or, where K1's atomics added a shard's rows in
    another order than the stacked store's launch did, within the
    ``sharded`` phase's own tolerance (``hold_table``); each rank's K1
    launches (its own shards' folds and partials). Prints the world,
    the fill, each plan's ms (median of 5), the rebalance seconds, K1's
    launches and the bytes gathered per plan per rank, the card."""
    import shutil
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.warehouse import query as Q
    t_phase = time.perf_counter()
    want, T = sd["want"], m["stream"].n_segments
    world = _dist_world()
    tmp = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save({k: v.cpu() for k, v in m["day"].items()}, tmp / "day.pt")
    _, spawn_s = timed(lambda: spawn_world(
        _dist_rank, world, (world, str(tmp), T), deadline=DIST_DEADLINE))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    shutil.rmtree(tmp)
    plans = main_plans((T - 1) // WINDOW + 1)
    oracles, k = want["oracles"], SHARDS // world
    names = list(want["standing"])
    bit_equal, errs = {}, {}
    for r, got in enumerate(ranks):
        if (got["shards"] != range(r * k, (r + 1) * k)
                or not np.array_equal(got["counts"], want["store"]["counts"])
                or got["capacity"] != want["store"]["capacity"]
                or got["digests"] != want["store"]["digests"]):
            raise AssertionError(f"dist: rank {r}'s rows differ from the "
                                 "stacked store's")
        for part in ("plans", "compressed", "standing"):
            first = ranks[0][part]
            pairs = ({"wide": (got[part], first)} if part == "compressed"
                     else {n: (got[part][n], first[n]) for n in first})
            for n, (a, b) in pairs.items():
                if not _same_answer(a, b):
                    raise AssertionError(f"dist: rank {r}'s {part} {n} "
                                         "differs from rank 0's")
        for what, rows in want["rows"].items():
            g = got["rows"][what]
            if set(g) != set(rows) or not all(
                    np.array_equal(g[c], rows[c]) for c in rows):
                raise AssertionError(f"dist: rank {r}'s {what} differs")
        if [(a, f.tolist()) for a, f in got["alerts"]] != \
                [(a, f.tolist()) for a, f in want["alerts"]]:
            raise AssertionError(f"dist: rank {r}'s alerts differ")
        lc = got["launches"]
        want_folds = CAMERAS // world * len(names)
        if (lc["folds"] != want_folds
                or lc["fold_paths"] != {"kernel": want_folds, "engine": 0}
                or lc["queries"] != k * len(plans)
                or lc["tier"] != k * len(plans)):
            raise AssertionError(f"dist: rank {r}'s K1 launches {lc}")
        if got["tier"]["spilled"] != want["tier"]["spilled"] or \
                got["tier"]["max_cold_scale"] != want["tier"]["max_cold_scale"]:
            raise AssertionError(f"dist: rank {r}'s spill differs")
    got = ranks[0]
    for name, plan in plans.items():
        _, node, _ = Q.split_plan(plan)
        acc, cnt, scale = oracles[name]
        for what, a, b in (
                ("plan", got["plans"][name], want["plans"][name]),
                ("rebalanced", ranks[0]["rebalanced"]["plans"][name],
                 want["rebalanced"]["plans"][name]),
                ("tier", got["tier"]["plans"][name],
                 want["tier"]["plans"][name])):
            bit_equal[f"{what} {name}"] = _same_answer(a, b)
            errs[f"{what} {name}"] = hold_table(
                f"dist {what} {name} vs the stacked store", a, b, node, acc,
                cnt, scale)
    for name in names:
        _, node, _ = Q.split_plan(m["standing_plans"][name])
        acc, cnt, scale = oracles[name]
        for what, a, b in (
                ("standing", got["standing"][name], want["standing"][name]),
                ("rebalanced standing",
                 ranks[0]["rebalanced"]["standing"][name],
                 want["rebalanced"]["standing"][name])):
            bit_equal[f"{what} {name}"] = _same_answer(a, b)
            errs[f"{what} {name}"] = hold_table(
                f"dist {what} {name} vs the stacked store", a, b, node, acc,
                cnt, scale)
    # the compressed sum: counts exact, within S (max|ref| / 127 + 1e-3)
    acc, cnt, _ = oracles["wide"]
    ct = got["compressed"][0]
    comp_err = float(np.abs(ct["out"].double().numpy() - acc).max())
    comp_bound = SHARDS * (float(np.abs(acc).max()) / 127 + 1e-3)
    if not np.array_equal(ct["count"].numpy(), cnt) or comp_err > comp_bound:
        raise AssertionError(f"dist: compressed sum off by {comp_err} "
                             f"(bound {comp_bound})")
    bit_equal["compressed"] = _same_answer(got["compressed"],
                                           want["compressed"])
    # the rebalanced rows and the cold arrays: every shard, bit for bit
    members = [g for g in ranks if g["rebalanced"] is not None]
    for what, key, mine in (
            ("rebalanced rows", "rebalanced",
             {s: d for g in members
              for s, d in g["rebalanced"]["digests"].items()}),
            ("cold arrays", "tier",
             {s: d for g in ranks for s, d in g["tier"]["digests"].items()})):
        if mine != want[key]["digests"]:
            raise AssertionError(f"dist: the {what} differ")
    for g in members:
        if not (np.array_equal(g["rebalanced"]["counts"],
                               want["rebalanced"]["counts"])
                and g["rebalanced"]["capacity"]
                == want["rebalanced"]["capacity"]):
            raise AssertionError("dist: the rebalanced layout differs")
    emit("dist", phase_s=time.perf_counter() - t_phase, world=world,
         backend="nccl", shards=SHARDS, shards_per_rank=k,
         rows=int(np.sum(want["store"]["counts"])), spawn_s=spawn_s,
         seconds=[g["seconds"] for g in ranks],
         fill_s_per_ingest=[g["seconds"]["fill"] / CAMERAS for g in ranks],
         plan_ms=[g["plan_ms"] for g in ranks],
         k1_launches=[g["launches"] for g in ranks],
         gathered_per_plan=[g["gathered"] for g in ranks],
         bit_equal=bit_equal,
         bit_equal_float=sum(bit_equal.values()),
         answers_held=len(bit_equal),
         rerun_bit_equal=[g["again"] for g in ranks],
         errors=errs, compressed={"max_abs_err": comp_err,
                                  "bound": comp_bound},
         peak_mem_bytes=[g["peak_mem_bytes"] for g in ranks],
         telemetry=got["telemetry"], nvidia_smi=smi)
    return {"launches": sum(g["launches"]["folds"] + g["launches"]["queries"]
                            + g["launches"]["tier"] for g in ranks)}


def _train_dist_rank(rank, world, tmp):
    """One rank of the ``train_dist`` phase, in its own process
    (spawned): it joins the NCCL group through a file under ``tmp``,
    runs the phase's parts on its card and writes what it saw to
    ``tmp/rank<r>.pt``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group
    tmp = Path(tmp)
    dev = init_shard_group(init_method=f"file://{tmp / 'pg_init'}",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        torch.save(_train_dist_drive(dev, world), tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _train_dist_drive(dev, world):
    """Parts (a) and (c) at (W, 1) on every machine; with TRAIN_DIST_FULL
    ranks or more, (a) and (c) again at (1, 4) and (2, 2) (the model
    axis split), (e), (b), (b) sequence-split and (f): llama3-8b at full
    depth at (1, 4), sequence-split, from (b)'s draws (or, where it does
    not fit, its peak and the allocator's summary)."""
    import dataclasses
    import datetime
    from repro_torch.configs.base import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch.mesh import make_host_mesh
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT)
    mesh = make_host_mesh(1, dev, timeout)
    llama, mamba = get("llama3-8b"), get("mamba2-370m")
    cut = TRAIN_DIST["layers"]
    llama_cut = dataclasses.replace(llama, n_layers=cut)
    mamba_cut = dataclasses.replace(mamba, n_layers=cut)
    out = {"rank": mesh.rank, "shape": list(mesh.devices.shape)}
    out["a"] = _dist_part(mesh, llama_cut, TRAIN_DIST["batch"], {"k3": FA},
                          compare=True)
    out["c"] = _dist_part(mesh, mamba_cut, TRAIN_SSM, {"k4": SSD},
                          compare=True)
    if world >= TRAIN_DIST_FULL:
        for m in (4, 2):
            split = make_host_mesh(m, dev, timeout)
            at = tuple(split.devices.shape)
            out[f"a {at}"] = _dist_part(split, llama_cut, TRAIN_DIST["batch"],
                                        {"k3": FA}, compare=True)
            out[f"c {at}"] = _dist_part(split, mamba_cut, TRAIN_SSM,
                                        {"k4": SSD}, compare=True)
        out["e"] = _dist_part(
            make_host_mesh(4, dev, timeout),
            dataclasses.replace(get("mixtral-8x7b"),
                                n_layers=TRAIN_DIST_SPLIT_LAYERS),
            TRAIN_DIST["batch"], {"k3": FA}, compare=True, moe="ep")
        b_mesh = make_host_mesh(TRAIN_DIST_B_MESH[1], dev, timeout)
        out["b"] = _dist_part(b_mesh, llama, TRAIN_DIST["batch"], {"k3": FA},
                              compare=False)
        out["b seq"] = _dist_part(b_mesh, llama, TRAIN_DIST["batch"],
                                  {"k3": FA}, compare=False, seq_split=True)
        try:
            out["f"] = _dist_part(make_host_mesh(4, dev, timeout), llama,
                                  TRAIN_DIST["batch"], {"k3": FA},
                                  compare=False, seq_split=True)
        except torch.cuda.OutOfMemoryError as e:
            out["f"] = {"oom": str(e)[:400],
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                        "memory_summary": torch.cuda.memory_summary(
                            abbreviated=True)}
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _train_dist_shared_rank(rank, world, tmp):
    """One rank of part (d), in its own process (spawned): ``world``
    ranks on card 0 joined through gloo (NCCL refuses a card twice),
    laid out as (1, world) over ("data", "model"), llama3-8b cut to
    TRAIN_DIST_SPLIT_LAYERS layers; then (d seq), the same steps
    sequence-split (``seq_shard_activations``) from the same draws, its
    moments held against (d)'s; what it saw goes to
    ``tmp/rank<r>.pt``."""
    import dataclasses
    import datetime
    import torch.distributed as dist
    from repro_torch.configs.base import get
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import TrainMesh, init_shard_group
    tmp = Path(tmp)
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT)
    dev = init_shard_group(init_method=f"file://{tmp / 'pg_init'}",
                           rank=rank, world_size=world, timeout=timeout,
                           backend="gloo")
    try:
        mesh = TrainMesh((1, world), ("data", "model"), device=dev,
                         timeout=timeout, backend="gloo")
        cfg = dataclasses.replace(get("llama3-8b"),
                                  n_layers=TRAIN_DIST_SPLIT_LAYERS)
        d = _dist_part(mesh, cfg, TRAIN_DIST["batch"], {"k3": FA},
                       compare=True, turns=True, keep=True)
        d_seq = _dist_part(mesh, cfg, TRAIN_DIST["batch"], {"k3": FA},
                           compare=False, seq_split=True,
                           against=d.pop("moments"))
        torch.save({"rank": mesh.rank, "shape": [1, world], "d": d,
                    "d seq": d_seq}, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_part(mesh, cfg, batch, kernels, *, compare, moe=None,
               turns=False, seq_split=False, keep=False, against=None):
    """``TRAIN_DIST["steps"]`` sharded steps of the launcher's step on
    ``cfg`` at ``batch`` x 2,048 tokens over ``mesh``, this rank's rows,
    the counts of ``kernels`` set to 0 just before the steps and read
    just after. With ``compare`` the weights are drawn on the CPU (seed
    0) and the same steps run after without a mesh on this card, from the
    same draws: the losses, norms and this rank's blocks of the params
    and the AdamW moments are compared (``_dist_compare``; with ``turns``,
    where the ranks share a card, one rank at a time). Without it each
    leaf is drawn whole on the card (``torch.Generator("cuda")``, seed 0:
    other draws than the CPU's) and this rank keeps its block. ``moe``:
    the run options' ``moe_sharding``; ``seq_split``: their
    ``seq_shard_activations``. ``keep``: the run also returns this
    rank's blocks of the moments (``"moments"``, on the host);
    ``against``: such blocks of another run from the same CPU draws,
    which this one's are held to instead of the steps without a mesh
    (``_moments_vs``)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.data.tokens import local_rows, make_batch_iter
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import train as LT
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import adamw_init, leaves
    from repro_torch.runtime.steps import init_train_state, make_train_step

    dev, steps, seq = mesh.device, TRAIN_DIST["steps"], TRAIN_DIST["seq"]
    cpu_draws = compare or against is not None
    opts = dataclasses.replace(LT.train_options(seq),
                               seq_shard_activations=seq_split)
    if moe is not None:
        opts = dataclasses.replace(opts, moe_sharding=moe)
    model = Model(cfg, opts)
    axes = model.batch_axes(mesh)
    rows = torch.as_tensor(local_rows(batch, mesh.index(axes),
                                      mesh.axis_size(axes)), device=dev)
    it = make_batch_iter(cfg, global_batch=batch, seq_len=seq, seed=0,
                         device=dev)
    batches = [next(it) for _ in range(steps)]
    t0 = time.perf_counter()
    if cpu_draws:
        full = model.init(torch.Generator().manual_seed(0), "cpu")
        params = shd.shard_tree(full, model.param_shardings(mesh))
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
    else:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), dev, mesh)
    sync()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(model, peak_lr=TRAIN_DIST["lr"],
                              warmup=LT.WARMUP, total_steps=steps,
                              mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.LAUNCHES = k.BWD_LAUNCHES = 0
    metrics, secs = [], []
    for b in batches:
        rb = {k: v.index_select(0, rows) for k, v in b.items()}
        (state, met), sec = timed(lambda: _train_step(step_fn, state, rb))
        metrics.append(met)
        secs.append(sec)
    launches = {n: [k.LAUNCHES, k.BWD_LAUNCHES] for n, k in kernels.items()}
    run = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": batch, "seq": seq, "mesh": list(mesh.devices.shape),
           "moe": moe,
           "seq_split": seq_split, "rows": len(rows),
           "params": _n_params(full) if cpu_draws else None,
           "init_s": init_s, "metrics": metrics,
           "step_s": secs, "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "bytes_per_step": {k: v / steps
                              for k, v in step_fn.layout.bytes.items()},
           "local_param_bytes": sum(x.numel() * x.element_size()
                                    for x in leaves(state["params"]))}
    mine = ({k: [x.cpu() for x in leaves(t)] for k, t in (
        ("params", state["params"]), ("m", state["opt"]["m"]),
        ("v", state["opt"]["v"]))} if cpu_draws else None)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    if against is not None:
        run["vs"] = _moments_vs(mine, against)
    if keep:
        run["moments"] = {k: mine[k] for k in ("m", "v")}
    if compare and turns:
        for r in range(mesh.size):
            if r == mesh.rank:
                run["plain"] = _dist_compare(model, mesh, full, batches,
                                             mine)
            dist.barrier()
    elif compare:
        run["plain"] = _dist_compare(model, mesh, full, batches, mine)
    return run


def _moments_vs(mine, want):
    """This rank's blocks of the moments (``mine``) against another
    run's from the same draws (``want``), on the host: each kind's
    largest error over its tolerance (DIST_MOMENT_TOL of the leaf's
    largest magnitude for m, twice that for v, as ``_dist_compare``)
    and its largest absolute error."""
    worst, err = {}, {}
    for kind, scale in (("m", 1.0), ("v", 2.0)):
        worst[kind] = err[kind] = 0.0
        for got, w in zip(mine[kind], want[kind]):
            e = float((got - w).abs().max())
            top = float(w.abs().max())
            err[kind] = max(err[kind], e)
            worst[kind] = max(worst[kind],
                              e / max(scale * DIST_MOMENT_TOL * top, 1e-30))
    return {"err_over_tol": worst, "abs_err": err}


def seq_model_bytes(layers, rows, seq, d, elt=4):
    """The bytes over ``"model"`` a rank counts in one sequence-split
    train step of a dense model whose vocab splits (remat none), as
    ``StepLayout.bytes`` counts them: X = rows x seq x d x ``elt`` for
    each collective of the (rows, seq, d) stream, a reduce-scatter by
    its input, an all-gather by its output. Forward: the embedding's
    ``g`` (a reduce-scatter), each layer's attention and FFN ``f``
    (gathers) and ``g`` (reduce-scatters), the head's ``f``: 4 L + 2.
    Backward: their adjoints, 4 L + 2, and the gathers again of each
    saved input kept as this rank's rows (each layer's two normed inputs
    and the head's), 2 L + 1. So X (10 L + 5), plus the vocab-parallel
    cross entropy's three float32 all-reduces of (rows, seq - 1)."""
    X = rows * seq * d * elt
    return X * (10 * layers + 5) + 3 * 4 * rows * (seq - 1)


def _held_seq(what, runs, base):
    """A sequence-split part's runs against the same part without the
    flag (``base``, every rank's, from the same draws): the losses and
    norms within TRAIN_LOSS_TOL relative, every rank's moments within
    their tolerances (``_moments_vs``, where the run holds them), the
    bytes over ``"model"`` a rank a step equal to ``seq_model_bytes``.
    Returns what to add to the part's summary."""
    first, b0 = runs[0], base[0]
    rel = max(abs(m[k] - p[k]) / abs(p[k]) for m, p in
              zip(first["metrics"], b0["metrics"]) for k in ("loss",
                                                             "gnorm"))
    worst = ({k: max(r["vs"]["err_over_tol"][k] for r in runs)
              for k in ("m", "v")} if "vs" in first else None)
    want = seq_model_bytes(first["layers"], first["rows"], first["seq"],
                           first["d_model"])
    got = [r["bytes_per_step"]["model"] for r in runs]
    out = {"vs_flag_off": {
        "losses_off": [m["loss"] for m in b0["metrics"]],
        "metrics_rel_err": rel, "tol": TRAIN_LOSS_TOL,
        "moments_err_over_tol": worst,
        "model_bytes_reckoned": want,
        "step_s_median_off": statistics.median(
            [s for r in base for s in r["step_s"][1:]]),
        "peak_mem_bytes_off": [r["peak_mem_bytes"] for r in base],
        "bytes_per_step_off": [r["bytes_per_step"] for r in base]}}
    if rel > TRAIN_LOSS_TOL or (worst and max(worst.values()) > 1.0) or \
            any(g != want for g in got):
        raise AssertionError(f"train_dist {what} vs the same steps without "
                             f"the sequence split: metrics rel {rel}, "
                             f"moments over their tolerance {worst}, bytes "
                             f"over model {got} (reckoned {want})")
    return out


def _update_bound(m, v, count, lr):
    """Per element, how far one AdamW update (b1 0.9, b2 0.95, eps 1e-8)
    at rate ``lr`` may move from this one when the moments, ``m`` and
    ``v`` after step ``count``, are within DIST_MOMENT_TOL and twice that
    of their leaf's largest magnitude: the update is p - lr (s + wd p), s = m^ /
    (sqrt(v^) + eps) with m^ and v^ the moments over their bias
    corrections bc1 and bc2, so s moves by at most (t_m / bc1 + |m^|
    sqrt(t_v / bc2) / d) / d, d = max(sqrt(v^) - sqrt(t_v / bc2), 0) +
    eps (the CPU tests' ``update_bound``). Where sqrt(v^) is about eps (a
    gradient of 1e-8) this allows about lr: there the step follows the
    gradient's size, which sums in another order move by a large
    share."""
    bc1, bc2 = 1 - 0.9 ** count, 1 - 0.95 ** count
    t_m = DIST_MOMENT_TOL * float(m.abs().max()) / bc1
    t_s = math.sqrt(2 * DIST_MOMENT_TOL * float(v.abs().max()) / bc2)
    d = (torch.sqrt(v / bc2) - t_s).clamp_min(0.0) + 1e-8
    return lr * (t_m + (m / bc1).abs() * t_s / d) / d


def _dist_compare(model, mesh, full, batches, mine):
    """The same steps without a mesh on this card from the CPU draws
    ``full``, and this rank's blocks of their params and moments held
    against the sharded run's (``mine``: ``leaves`` order each, on the
    host), leaf by leaf on the card: bit for bit, each leaf's largest
    error and, with more than one rank, each kind's largest error over
    its tolerance (DIST_MOMENT_TOL of the leaf's largest magnitude for m,
    twice that for v; for the params one float32 ulp of the leaf's
    largest magnitude a step, their rounding, plus the sum of
    ``_update_bound`` over the steps, this rank's block of it summed on the host as the steps
    run: a whole leaf's sum on the card would not fit beside the step at
    one rank, where the check is bit for bit alone)."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import train as LT
    from repro_torch.optim.adamw import adamw_init, leaves, tree_map
    from repro_torch.runtime.steps import make_train_step
    dev, held = mesh.device, mesh.size > 1
    params = tree_map(lambda x: x.to(dev), full)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step_fn = make_train_step(model, peak_lr=TRAIN_DIST["lr"],
                              warmup=LT.WARMUP,
                              total_steps=TRAIN_DIST["steps"])
    metrics = []
    specs = shd.tree_leaves(model.param_specs(mesh))
    bound = [torch.zeros(x.shape) for x in mine["params"]] if held else None
    for t, b in enumerate(batches, 1):
        state, met = _train_step(step_fn, state, b)
        metrics.append(met)
        if held:
            with torch.no_grad():
                for acc, spec, m, v in zip(bound, specs,
                                           leaves(state["opt"]["m"]),
                                           leaves(state["opt"]["v"])):
                    acc += shd.shard_tensor(
                        _update_bound(m, v, t, met["lr"]), spec,
                        mesh).cpu()
            torch.cuda.empty_cache()
    want = {"params": leaves(state["params"]), "m": leaves(state["opt"]["m"]),
            "v": leaves(state["opt"]["v"])}
    same, errs = True, {}
    worst = {k: 0.0 for k in want} if held else None
    for kind, xs in want.items():
        errs[kind] = []
        for i, (x, spec, got) in enumerate(zip(xs, specs, mine[kind])):
            block, got = shd.shard_tensor(x, spec, mesh), got.to(dev)
            same = same and torch.equal(got.view(torch.uint8),
                                        block.view(torch.uint8))
            err = (got - block).abs()
            errs[kind].append(float(err.max()))
            if held:
                top = float(x.abs().max())
                tol = max({"m": DIST_MOMENT_TOL * top,
                           "v": 2 * DIST_MOMENT_TOL * top,
                           "params": len(batches) * 2.0 ** -23 * top}[kind],
                          1e-30)
                if kind == "params":
                    tol = bound[i].to(dev) + tol
                worst[kind] = max(worst[kind], float((err / tol).max()))
            del block, got, err
    del state, step_fn, params, bound, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"metrics": metrics, "bit_equal": same, "abs_err": errs,
            "err_over_tol": worst}


def _held_dist(what, world, runs):
    """A part's runs on every rank: the same metrics on every rank, K3 or
    K4 launched once per layer and step both ways, finite losses; against
    the steps without a mesh, bit for bit at one rank (metrics, params
    and moments), else the losses and norms within TRAIN_LOSS_TOL
    relative and every rank's params and moments within their
    tolerances (``_dist_compare``). Returns the part's summary."""
    first = runs[0]
    per = first["layers"] * TRAIN_DIST["steps"]
    for r, run in enumerate(runs):
        if run["metrics"] != first["metrics"] or any(
                v != [per, per] for v in run["launches"].values()) \
                or not all(np.isfinite(m["loss"]) for m in run["metrics"]):
            raise AssertionError(f"train_dist {what}: rank {r}: metrics "
                                 f"{run['metrics']}, launches "
                                 f"{run['launches']} (want {per} each way)")
    out = {"arch": first["arch"], "layers": first["layers"],
           "batch": first["batch"], "seq": first["seq"],
           "rows_per_rank": first["rows"], "params": first["params"],
           "losses": [m["loss"] for m in first["metrics"]],
           "gnorms": [m["gnorm"] for m in first["metrics"]],
           "lrs": [m["lr"] for m in first["metrics"]],
           "init_s": [r["init_s"] for r in runs],
           "step_s": [r["step_s"] for r in runs],
           "step_s_median": statistics.median(
               [s for r in runs for s in r["step_s"][1:]]),
           "peak_mem_bytes": [r["peak_mem_bytes"] for r in runs],
           "local_param_bytes": [r["local_param_bytes"] for r in runs],
           "bytes_per_step": [r["bytes_per_step"] for r in runs],
           "launches": [r["launches"] for r in runs]}
    out["tok_per_s"] = (first["batch"] * first["seq"]
                        / out["step_s_median"])
    if "plain" not in first:
        return out
    plain = first["plain"]["metrics"]
    rel = max(abs(m[k] - p[k]) / abs(p[k]) for m, p in
              zip(first["metrics"], plain) for k in ("loss", "gnorm"))
    worst = ({k: max(r["plain"]["err_over_tol"][k] for r in runs)
              for k in ("params", "m", "v")} if world > 1 else None)
    err = {k: max(e for r in runs for e in r["plain"]["abs_err"][k])
           for k in ("params", "m", "v")}
    bit = all(r["plain"]["bit_equal"] for r in runs) and \
        first["metrics"] == plain
    if (world == 1 and not bit) or rel > TRAIN_LOSS_TOL or \
            (worst and max(worst.values()) > 1.0):
        raise AssertionError(f"train_dist {what} vs the steps without a "
                             f"mesh: bit-equal {bit}, metrics rel {rel}, "
                             f"largest error over its tolerance {worst}, "
                             f"abs {err}")
    out.update(plain_losses=[m["loss"] for m in plain], bit_equal=bit,
               metrics_rel_err=rel, tol=TRAIN_LOSS_TOL,
               moment_tol=DIST_MOMENT_TOL, abs_err=err, err_over_tol=worst)
    return out


def phase_train_dist(smi):
    """Training across cards: one NCCL rank per visible card
    (``_dist_world``: as many as divide the global batch of 4 rows),
    spawned under a deadline, each loading the K3 and K4 libraries the
    build phase made. Each rank lays the world out as (world, 1) over
    ``("data", "model")`` (``make_host_mesh``), keeps its blocks of the
    train state (ZeRO-3 over ``"data"``) and runs its rows of each
    global batch through the launcher's step with ``mesh=``; the kernels'
    counts are set to 0 just before each part's steps and read just
    after.

    (a) llama3-8b at its published width (d_model 4,096, 32 heads over 8
        kv heads of 128, d_ff 14,336, vocab 128,256) cut to 4 of its 32
        layers (1.9B parameters), float32, weights drawn on the CPU from
        seed 0, 3 steps at 4 x 2,048 tokens at the launcher's default
        peak rate of 3e-4; then the same steps without a mesh on each
        rank's card from the same draws. K3 once per layer and step both
        ways on every rank.
    (b) with 4 or more cards: all 32 layers (8.03B parameters, 128 GB of
        float32 parameters, gradients and moments: more than one card
        holds), each leaf drawn on the card and cut, 3 steps; on fewer
        cards it prints that it is skipped and why.
    (c) mamba2-370m at its published width cut to 4 of 48 layers, 3 steps
        at 4 x 2,048 tokens against the steps without a mesh, K4 once per
        layer and step both ways.
    (d) the model axis computed (``sharding.ModelSplit``): a second world
        of TRAIN_DIST_SHARED ranks on card 0 through gloo (which carries
        CUDA tensors through the host; NCCL refuses a card twice), laid
        out as (1, 2): llama3-8b cut to 2 layers, each rank its own heads
        (K3 both ways at 16 of 32 query heads over 4 of 8 kv heads),
        hidden columns and vocab rows, 3 steps against the steps without
        a mesh (the ranks take turns on the card). Its seconds a step
        are two processes sharing one card and the host's copies of
        every all-reduce: not a speed. Then (d seq): the same steps from
        the same draws with ``seq_shard_activations`` (the residual
        stream's rows split over ``"model"``, f and g as gathers and
        scatters of rows), held against (d) (``_held_seq``: losses and
        norms within TRAIN_LOSS_TOL, moments within DIST_MOMENT_TOL, the
        bytes over ``"model"`` a step equal to ``seq_model_bytes``).
    With four cards also (a) and (c) at (1, 4) and (2, 2) (the split
    over 4 and over 2 ranks with ZeRO-3 over 2), (e) mixtral-8x7b cut
    to 2 layers at (1, 4) under ``moe_sharding="ep"`` against the steps
    without a mesh, (b) at TRAIN_DIST_B_MESH, (b seq) the same
    sequence-split, and (f) llama3-8b at full depth at (1, 4),
    sequence-split, both held against (b) from the same draws as (d
    seq) is against (d) but for the moments (not kept at full depth).

    Held: every rank's losses and norms the same; at one rank the sharded
    steps bit for bit the steps without a mesh (losses, norms, every
    param and moment); at more, the losses and norms within
    TRAIN_LOSS_TOL relative and every rank's blocks of the moments and
    params within their tolerances (``_dist_compare``); K3 or K4 once a
    layer and step both ways on every rank. Prints each part's losses,
    seconds a step (the first apart), tokens per second, peak memory,
    bytes gathered, reduced and moved over ``"model"`` per step, and the
    launches per rank; the card's name and power limit."""
    import shutil
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    world = _dist_world(TRAIN_DIST["batch"])
    parts, misses, k3, k4 = {}, [], [0, 0], [0, 0]
    all_runs = {}
    spawn_s = {}
    for name, fn, n in (("nccl", _train_dist_rank, world),
                        ("gloo", _train_dist_shared_rank,
                         TRAIN_DIST_SHARED)):
        tmp = ROOT / "build" / f"chip_smoke_train_dist_{name}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        _, spawn_s[name] = timed(lambda: spawn_world(
            fn, n, (n, str(tmp)), deadline=TRAIN_DIST_DEADLINE))
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(n)]
        shutil.rmtree(tmp)
        for p in ranks[0]:
            if p in ("rank", "shape"):
                continue
            runs = [g[p] for g in ranks]
            if "oom" in runs[0]:
                parts[p] = {"oom": runs[0]["oom"], "peak_mem_bytes": [
                    r["peak_mem_bytes"] for r in runs],
                    "memory_summary": runs[0]["memory_summary"]}
                misses.append(f"train_dist {p}: out of memory, peak "
                              f"{parts[p]['peak_mem_bytes']}")
                continue
            all_runs[p] = runs
            for g in runs:
                for i in (0, 1):
                    k3[i] += g["launches"].get("k3", [0, 0])[i]
                    k4[i] += g["launches"].get("k4", [0, 0])[i]
            try:
                parts[p] = _held_dist(p, n, runs)
                base = SEQ_BASE.get(p)
                if base is not None:
                    parts[p].update(_held_seq(p, runs, all_runs[base]))
            except AssertionError as e:     # raised below, after the line
                misses.append(str(e))
                parts[p] = {"miss": str(e)}
            parts[p]["mesh"] = runs[0]["mesh"]
            parts[p]["backend"] = name
    if world < TRAIN_DIST_FULL:
        parts["b"] = {"skipped": (
            f"{world} card(s): llama3-8b's 32 layers hold 8.03B parameters, "
            "128 GB of float32 parameters, gradients and AdamW moments; "
            f"the part needs {TRAIN_DIST_FULL} cards (32 GB of state each)")}
        print(f"train_dist (b): skipped, {parts['b']['skipped']}",
              flush=True)
    LAST_PARTS.clear()
    LAST_PARTS.update(parts)
    emit("train_dist", world=world, backend="nccl; (d) gloo, "
         f"{TRAIN_DIST_SHARED} ranks on card 0", spawn_s=spawn_s,
         phase_s=time.perf_counter() - t_phase, parts=parts,
         nvidia_smi=smi)
    if misses:
        raise AssertionError("; ".join(misses))
    return {"k3_fwd": k3[0], "k3_bwd": k3[1], "k4_fwd": k4[0],
            "k4_bwd": k4[1],
            "split": {p: parts[p]["launches"][0]
                      for p in ("d", "a (1, 4)", "c (1, 4)") if p in parts}}


def phase_time_split(dev, td):
    """K3 and K4, forward and backward, at the model axis's local shapes
    (``SPLIT_K3``: llama3-8b's 32 heads over 8 kv heads cut by m = 4, B
    = 4, S = 2,048, D = 128, causal; ``SPLIT_K4``: mamba2-370m's 8 of 32
    heads), float32: kernel, plain version and library call (SDPA and
    its backward; none for K4), CUDA-event medians, each output held
    against its plain version (``_time_k3``, ``_time_ssd``,
    ``_time_k3_bwd``, ``_time_k4_bwd``), beside the bounds and the
    launches a rank in ``train_dist``'s split parts (``td["split"]``:
    (d) at m = 2 on one card, and (a) and (c) at (1, 4) with four
    cards). Then K3 in bfloat16 at qwen1.5-110b's local prefill shape
    (``SERVE_SPLIT_K3``, serve_dist's (c)) beside SDPA and both bounds:
    the bfloat16 kernel at two warpgroups and D = 128."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    gen = torch.Generator(device=dev).manual_seed(30)
    B, S, H, G, D = SPLIT_K3
    k3 = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20, kv_heads=G)
    k3_bwd = _time_k3_bwd((B, S, S, H, G, D, True, None), gen, dev,
                          torch.float32)
    *args, _ = ssd_inputs(*SPLIT_K4[:6], gen, dev)
    k4 = _time_ssd(SSD, args, SPLIT_K4)
    del args
    k4_bwd = _time_k4_bwd("split", SPLIT_K4, gen, dev, torch.float32)
    B, S, H, G, D = SERVE_SPLIT_K3
    k3_serve = _time_k3(FA, F, (B, S, H, D), gen, dev, reps=20, kv_heads=G,
                        dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    out = {"flash_attention": k3, "flash_attention_bwd": k3_bwd,
           "ssd_scan": k4, "ssd_scan_bwd": k4_bwd,
           "flash_attention_serve_bf16": k3_serve,
           "launches_per_rank": td["split"]}
    emit("time_split", **out)
    return out


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

def _serve_dist_part(mesh, cfg, opts, name, profile=False):
    """One batch of SERVE_DIST through the prefill and decode steps of
    ``runtime.steps`` across ``mesh`` (this rank's rows and blocks; the
    params drawn a layer slice at a time on the card from
    ``torch.Generator("cuda")``, seed 0, ``init_params``): a warm-up
    prefill and decode step first (the groups' first collectives set up
    their communicators), then K3's and K4's counts and the steps' byte
    counts set to 0, the timed prefill and decode steps, the counts read
    after the last. With ``profile`` one more decode step under
    ``torch.profiler`` (``_profile_step``). Returns this rank's seconds,
    peak memory, bytes a step and launches, and (rank 0) every step's
    tokens and whole logits over the vocabulary."""
    import torch.distributed as dist
    from repro_torch.data.tokens import SyntheticCorpus, local_rows
    from repro_torch.distribution.sharding import _all_gather
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import (init_params, make_decode_step,
                                           make_prefill_step)
    B, S, n_gen = (SERVE_DIST[k] for k in ("batch", "prompt_len", "gen"))
    model = Model(cfg, opts)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_s = timed(lambda: init_params(
        model, torch.Generator(device=dev).manual_seed(0), mesh=mesh))
    axes = model.batch_axes(mesh)
    n = mesh.axis_size(axes)
    toks = SyntheticCorpus(cfg.vocab, 0).batch(B, S, 0)
    rows = local_rows(B, mesh.index(axes), n) if n > 1 else slice(None)
    batch = {"tokens": torch.as_tensor(toks[rows], device=dev)}
    prefill = make_prefill_step(model, mesh, logits=True)
    decode = make_decode_step(model, mesh, logits=True)

    def whole(x):
        x = _all_gather(x, 0, mesh.group(axes), n) if n > 1 else x
        return x[:, :cfg.vocab].float().cpu().numpy() if x.dim() > 1 \
            else x.cpu().numpy()
    with torch.no_grad():
        tok, cache, _ = prefill(params, batch, cache_len=S + n_gen)
        decode(params, cache, tok)
        del tok, cache
    for step in (prefill, decode):
        step.layout.bytes.update(dict.fromkeys(step.layout.bytes, 0))
    FA.LAUNCHES = FA.WINDOW_LAUNCHES = FA.BF16_LAUNCHES = SSD.LAUNCHES = 0
    with torch.no_grad():
        (tok, cache, lg), prefill_s = timed(lambda: prefill(
            params, batch, cache_len=S + n_gen))
        steps = [(whole(tok), whole(lg))]
        t0 = time.perf_counter()
        for _ in range(n_gen - 1):
            tok, cache, lg = decode(params, cache, tok)
            steps.append((whole(tok), whole(lg)))
        sync()
        decode_s = time.perf_counter() - t0
    launches = {"k3": FA.LAUNCHES, "k3_bf16": FA.BF16_LAUNCHES,
                "k4": SSD.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    prof = (_profile_step(lambda: decode(params, cache, tok)) if profile
            else None)
    del params, cache
    torch.cuda.empty_cache()
    dist.barrier()
    lead = mesh.rank == 0
    return {"part": name, "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": list(mesh.devices.shape), "rows": B, "prompt": S,
            "gen": n_gen, "init_s": init_s, "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_step_s": decode_s / (n_gen - 1),
            "tok_per_s": B * n_gen / (prefill_s + decode_s),
            "peak_mem_bytes": peak,
            "bytes_prefill": dict(prefill.layout.bytes),
            "bytes_decode_step": {k: v / (n_gen - 1) for k, v in
                                  decode.layout.bytes.items()},
            "launches": launches, "profile_decode_step": prof,
            "tokens": np.stack([t for t, _ in steps], 1),
            "logits": [g for _, g in steps] if lead else None}


def _profile_step(fn, top=8):
    """``fn`` once under ``torch.profiler`` (CPU and CUDA activities):
    the host's wall ms, the CUDA events' device ms summed (``device_type``
    CUDA only: the aten ops that launched them report it again), and the
    ``top`` ops by self CPU ms and the ``top`` kernels by device ms."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ev = p.key_averages()
    cuda = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(dev_us(e) for e in cuda) / 1e3,
            "top_cpu": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                        for e in sorted(ev, key=lambda e:
                                        -e.self_cpu_time_total)[:top]],
            "top_device": [[e.key, dev_us(e) / 1e3, e.count]
                           for e in sorted(cuda, key=lambda e:
                                           -dev_us(e))[:top]]}


def _serve_plain(cfg, opts, tokens, dev):
    """The same batch on one card without a mesh from the same draws
    (``init_params`` without a mesh), each decode step fed the tokens
    the ranks chose (``tokens``, (B, gen)): every step's logits over the
    vocabulary."""
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import (init_params, make_decode_step,
                                           make_prefill_step)
    B, S, n_gen = (SERVE_DIST[k] for k in ("batch", "prompt_len", "gen"))
    model = Model(cfg, opts)
    params = init_params(model, torch.Generator(device=dev).manual_seed(0),
                         dev)
    toks = torch.as_tensor(SyntheticCorpus(cfg.vocab, 0).batch(B, S, 0),
                           device=dev)
    prefill, decode = (make_prefill_step(model, logits=True),
                       make_decode_step(model, logits=True))
    with torch.no_grad():
        _, cache, lg = prefill(params, {"tokens": toks}, cache_len=S + n_gen)
        out = [lg[:, :cfg.vocab].float().cpu().numpy()]
        for i in range(n_gen - 1):
            fed = torch.as_tensor(tokens[:, i], device=dev)
            _, cache, lg = decode(params, cache, fed)
            out.append(lg[:, :cfg.vocab].float().cpu().numpy())
    del params, cache
    torch.cuda.empty_cache()
    return out


def _held_serve(run, plain, cfg):
    """The ranks' logits against one card's within
    ``bf16_logit_tolerance`` of ``bf16_boundaries(cfg)`` at the one
    card's largest |logit|; each chosen token the one card's argmax
    except where its top two logits lie within that tolerance."""
    from repro_torch.models.options import (bf16_boundaries,
                                            bf16_logit_tolerance)
    scale = max(float(np.abs(p).max()) for p in plain)
    tol = bf16_logit_tolerance(bf16_boundaries(cfg), scale)
    err = max(float(np.abs(g - p).max())
              for g, p in zip(run["logits"], plain))
    flips, near = 0, 0
    for i, p in enumerate(plain):
        top2 = np.sort(p, -1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        diff = run["tokens"][:, i] != p.argmax(-1)
        flips += int(diff.sum())
        near += int((diff & (gap > tol)).sum())
    finite = all(np.isfinite(g).all() for g in run["logits"])
    held = {"logits_max_abs_err": err, "logits_tol": tol,
            "logits_max_abs": scale, "token_flips": flips,
            "token_flips_past_tol": near, "finite": finite}
    if not (err <= tol and near == 0 and finite):
        raise AssertionError(f"{run['part']} {cfg.name} at {run['mesh']}: "
                             f"{held}")
    return held


def _serve_dist_summary(run):
    return {k: v for k, v in run.items() if k not in ("tokens", "logits")}


def _serve_dist_shared_rank(rank, world, tmp):
    """One rank of ``serve_dist``, in its own process (spawned): ``world``
    ranks on card 0 joined through gloo (NCCL refuses a card twice),
    laid out as (1, world): the parts of ``_serve_dist_a``; what it saw
    goes to ``tmp/rank<r>.pt``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import TrainMesh, init_shard_group
    tmp = Path(tmp)
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT)
    dev = init_shard_group(init_method=f"file://{tmp / 'pg_init'}",
                           rank=rank, world_size=world, timeout=timeout,
                           backend="gloo")
    try:
        mesh = TrainMesh((1, world), ("data", "model"), device=dev,
                         timeout=timeout, backend="gloo")
        torch.save([_serve_dist_part(mesh, cfg, opts, name)
                    for name, cfg, opts in _serve_dist_a()],
                   tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _serve_dist_a():
    """Part (a)'s runs, (name, config, run options): llama3-8b at its
    published width cut to SERVE_DIST_LAYERS layers, mamba2-370m at
    full width, bfloat16 params and compute; then llama3-8b's prefill
    sequence-split (``seq_shard_activations``; its decode steps ignore
    the flag)."""
    import dataclasses
    from repro_torch.configs.base import get
    from repro_torch.models.options import RunOptions
    opts = RunOptions(param_dtype="bfloat16")
    llama = dataclasses.replace(get("llama3-8b"), n_layers=SERVE_DIST_LAYERS)
    return [("a", llama, opts), ("a", get("mamba2-370m"), opts),
            ("a seq", llama, dataclasses.replace(
                opts, seq_shard_activations=True))]


def phase_serve_dist(smi):
    """Serving across ranks on one card: SERVE_DIST_SHARED gloo ranks
    on card 0 (as ``train_dist``'s part (d)), laid out as (1, 2) over
    ``("data", "model")``, each serving one batch of 4 x 2,048-token
    prompts and 8 generated tokens through ``make_prefill_step`` /
    ``make_decode_step`` with the mesh (``launch/serve.py``'s steps):

    (a) llama3-8b at its published width (d_model 4,096, 32 heads over 8
        kv heads of 128, d_ff 14,336, vocab 128,256) cut to 2 layers, then
        mamba2-370m at its published width (48 layers, 32 SSM heads),
        bfloat16 params and compute, drawn a layer slice at a time on the
        card (``init_params``); then llama3-8b again with its prefill
        sequence-split (``seq_shard_activations``: each rank's half of
        the rows between the blocks), held as the first. Each rank runs K3 at 16 of 32 query heads
        over 4 of 8 kv heads, or K4 at 16 of 32 heads, on its half of the
        prompt's heads; moves k and v from heads to its half of the
        cache's slots (one all-to-all); in each decode step gathers the
        new token's q, k and v, attends over its own slots and merges
        the softmax over ``"model"``; takes the next token over the
        vocab split.

    Held: every rank's tokens the same; the ranks' logits against one
    card's (``_serve_plain``: the same draws without a mesh, each decode
    step fed the ranks' tokens) within ``bf16_logit_tolerance``, the
    tokens the one card's argmax except where its top two logits lie
    within it (``_held_serve``); K3 (llama) or K4 (mamba2) once a layer
    and prefill on every rank. Prints each part's seconds (init,
    prefill, decode; two processes sharing one card and the host's
    copies of every collective: not a speed), peak memory a rank, the
    bytes a rank gathered, reduced and moved over ``"model"`` for the
    prefill and a decode step, and the launches a rank; the card's name
    and power limit."""
    import shutil
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    n = SERVE_DIST_SHARED
    tmp = ROOT / "build" / "chip_smoke_serve_dist"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    _, spawn_s = timed(lambda: spawn_world(
        _serve_dist_shared_rank, n, (n, str(tmp)),
        deadline=SERVE_DIST_DEADLINE))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(n)]
    shutil.rmtree(tmp)
    parts, k3, k4 = [], 0, 0
    for i, (_, cfg, opts) in enumerate(_serve_dist_a()):
        runs = [r[i] for r in ranks]
        for r in runs[1:]:
            if not np.array_equal(r["tokens"], runs[0]["tokens"]):
                raise AssertionError(f"serve_dist {cfg.name}: the ranks' "
                                     "tokens differ")
        want = cfg.n_layers if cfg.family == "ssm" else 0
        for r in runs:
            got = r["launches"]
            if (cfg.family == "ssm" and got["k4"] != want) or (
                    cfg.family != "ssm" and got["k3"] != cfg.n_layers) or \
                    got["k3_bf16"] != got["k3"]:
                raise AssertionError(f"serve_dist {cfg.name}: launches "
                                     f"{got} a rank")
            k3 += got["k3"]
            k4 += got["k4"]
        plain = _serve_plain(cfg, opts, runs[0]["tokens"],
                             torch.device("cuda", 0))
        parts.append({**_serve_dist_summary(runs[0]),
                      **_held_serve(runs[0], plain, cfg),
                      "per_rank": [_serve_dist_summary(r) for r in runs]})
    emit("serve_dist", ranks=n, backend="gloo, two ranks on card 0",
         spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase,
         parts=parts, nvidia_smi=smi)
    return {"k3": k3, "k4": k4}


def _serve_dist_rank(rank, world, tmp):
    """One rank of ``scripts/chip_serve_dist.py``'s four-card parts, in
    its own process (spawned): one NCCL rank a card. (b) llama3-8b at
    full depth, bfloat16, at (1, 4) and (2, 2); (c) qwen1.5-110b at its
    published width with a float8 kv cache, its first SERVE_DIST_LAYERS
    layers at (1, 4), then all 80 at (1, 4). What it saw goes to
    ``tmp/rank<r>.pt``."""
    import dataclasses
    import datetime
    import torch.distributed as dist
    from repro_torch.configs.base import get
    from repro_torch.launch.mesh import init_shard_group, make_host_mesh
    from repro_torch.models.options import RunOptions
    tmp = Path(tmp)
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT)
    dev = init_shard_group(init_method=f"file://{tmp / 'pg_init'}",
                           rank=rank, world_size=world, timeout=timeout)
    try:
        bf16 = RunOptions(param_dtype="bfloat16")
        fp8 = RunOptions(param_dtype="bfloat16", kv_cache_dtype=FP8)
        qwen = get("qwen1.5-110b")
        out = []
        for m in (4, 2):
            out.append(_serve_dist_part(make_host_mesh(m, dev, timeout),
                                        get("llama3-8b"), bf16, "b",
                                        profile=m == 4))
        mesh = make_host_mesh(4, dev, timeout)
        out.append(_serve_dist_part(mesh, dataclasses.replace(
            qwen, n_layers=SERVE_DIST_LAYERS), fp8, "c cut"))
        out.append(_serve_dist_part(mesh, qwen, fp8, "c"))
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_serve_dist_cards(smi):
    """``scripts/chip_serve_dist.py``'s four-card parts (``_serve_dist_rank``):
    (b) llama3-8b at full depth (8.03B parameters, 16 GB in bfloat16) at
    (1, 4) and (2, 2), held against one card's serve from the same draws
    (``_held_serve``); (c) qwen1.5-110b at its published width (80
    layers, d_model 8,192, 64 heads over 8 kv heads of 128, d_ff 49,152,
    vocab 152,064; 111.2B parameters, 222 GB in bfloat16) with a float8
    kv cache: its first 2 layers at (1, 4) held against one card, then
    all 80 at (1, 4), which no one card holds: every rank's tokens the
    same and every logit finite. K3 once a layer and prefill on every
    rank. Prints each part as ``serve_dist`` does."""
    import dataclasses
    import shutil
    from repro_torch.configs.base import get
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models.options import RunOptions
    t_phase = time.perf_counter()
    n = 4
    tmp = ROOT / "build" / "chip_smoke_serve_dist_cards"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    _, spawn_s = timed(lambda: spawn_world(
        _serve_dist_rank, n, (n, str(tmp)), deadline=SERVE_DIST_DEADLINE))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(n)]
    shutil.rmtree(tmp)
    bf16 = RunOptions(param_dtype="bfloat16")
    fp8 = RunOptions(param_dtype="bfloat16", kv_cache_dtype=FP8)
    qwen = get("qwen1.5-110b")
    plan = [(get("llama3-8b"), bf16, True), (get("llama3-8b"), bf16, True),
            (dataclasses.replace(qwen, n_layers=SERVE_DIST_LAYERS), fp8,
             True), (qwen, fp8, False)]
    parts, misses, k3 = [], [], 0
    dev = torch.device("cuda", 0)
    for i, (cfg, opts, compare) in enumerate(plan):
        runs = [r[i] for r in ranks]
        part = {**_serve_dist_summary(runs[0]),
                "per_rank": [_serve_dist_summary(r) for r in runs]}
        try:
            for r in runs:
                if not np.array_equal(r["tokens"], runs[0]["tokens"]):
                    raise AssertionError(f"{r['part']}: the ranks' tokens "
                                         "differ")
                if r["launches"]["k3"] != cfg.n_layers:
                    raise AssertionError(f"{r['part']}: K3 launched "
                                         f"{r['launches']} a rank")
                k3 += r["launches"]["k3"]
            if compare:
                part.update(_held_serve(runs[0], _serve_plain(
                    cfg, opts, runs[0]["tokens"], dev), cfg))
            elif not all(np.isfinite(g).all() for g in runs[0]["logits"]):
                raise AssertionError(f"{cfg.name}: a logit is not finite")
        except AssertionError as e:
            misses.append(str(e))
            part["miss"] = str(e)
        parts.append(part)
    emit("serve_dist_cards", ranks=n, backend="nccl", spawn_s=spawn_s,
         phase_s=time.perf_counter() - t_phase, parts=parts,
         nvidia_smi=smi)
    if misses:
        raise AssertionError("; ".join(misses))
    return {"k3": k3, "parts": parts}


def time_shards(store, plans, host):
    """K1 as one shard's partial at the main plans' shape: every shard's
    five partials timed together (kernel only; the median over the
    shards is the kernel's ms), and shard 0's held against its plain
    version and the float64 oracle with its plain-version, library and
    byte-bound times (``time_k1``)."""
    from repro_torch.kernels import warehouse_agg as K
    per_shard = []
    for s in range(store.n_shards):
        cols = {k: v[s] for k, v in store.columns.items()}
        n = int(store.n_rows_by_shard[s])
        calls = [_spec_of(plan, cols)[:2] for plan in plans.values()]
        per_shard.append(cuda_ms(lambda: [K.fused_segment_agg(
            cols, n, fvals, spec) for spec, fvals in calls], 20))
    n0 = int(store.n_rows_by_shard[0])
    shard0 = time_k1({k: v[0] for k, v in store.columns.items()}, n0, plans,
                     {k: v[:n0] for k, v in host.items()})
    return {**shard0, "kernel_ms": statistics.median(per_shard),
            "shard_kernel_ms": per_shard, "shard_rows": n0}


def phase_tiers(m):
    """The main store (11,059,200 rows, its registry attached) wrapped
    in a ``TieredStore``: everything but the newest camera-day spilled
    to int8, the main plans over the two-tier view through K1, each
    answer within the quantization bound of the unspilled one (the
    largest chunk scale times the rows a group sums, plus K1's own
    FLOAT_TOL), the standing answers unchanged bit for bit, and the
    tier's counters."""
    from repro_torch.warehouse import TieredStore
    from repro_torch.warehouse import query as Q
    store, reg, T = m["store"], m["reg"], m["stream"].n_segments
    host, n = store.host_rows(), store.n_rows
    before = {name: reg.answer(h) for name, h in m["handles"].items()}
    before = {k: ({c: v.clone() for c, v in t.items()}, mk.clone())
              for k, (t, mk) in before.items()}
    tiered = TieredStore(store, seed=0, device=store.device)
    _k1_zero()
    torch.cuda.reset_peak_memory_stats()
    spilled, spill_s = timed(lambda: tiered.spill(keep_hot=T))
    (cols, rows), mat_s = timed(tiered.materialize)
    plans = main_plans((T - 1) // WINDOW + 1)
    results, plan_ms = {}, {}
    for name, plan in plans.items():
        results[name], secs = timed(lambda p=plan: tiered.query(p))
        plan_ms[name] = secs * 1e3
    launches, paths, _ = _k1_counts()
    peak = torch.cuda.max_memory_allocated()
    bound = tiered.max_cold_scale()
    view = {k: v[:rows].cpu().numpy() for k, v in cols.items()}
    errs, oracle_errs = {"elements": _tier_elements(tiered, view, host)}, {}
    for name, plan in plans.items():
        oracle_errs[name], errs[name] = _tier_answer(
            name, plan, results[name], m["results"][name], cols, view, host,
            n, bound)
    for name, h in m["handles"].items():
        t1, m1 = reg.answer(h)
        t0, m0 = before[name]
        if not (torch.equal(m0, m1) and all(torch.equal(t0[c], t1[c])
                                            for c in t0)):
            raise AssertionError(f"tiers: the standing answer {name} moved")
    tel = tiered.telemetry()
    want = dict(spill_events=1, spilled_rows=spilled, dequantize_events=1,
                n_rows=n)
    got = {k: getattr(tel, k) for k in want}
    if got != want or spilled < n - T - store.chunk_rows:
        raise AssertionError(f"tier counters {got}, expected {want}")
    if paths != {"kernel": len(plans), "engine": 0} \
            or launches != len(plans):
        raise AssertionError(f"two-tier queries did not all take K1: "
                             f"{paths}")
    cold_bytes = sum(v.numel() * v.element_size() for d in
                     (tiered.cold_q, tiered.cold_scales, tiered.cold_int)
                     for v in d.values())
    emit("tiers", rows=n, spilled_rows=spilled, hot_rows=tiered.hot.n_rows,
         spill_s=spill_s, materialize_s=mat_s, plan_ms=plan_ms,
         max_cold_scale=bound, vs_unspilled=errs, vs_f64=oracle_errs,
         cold_bytes=cold_bytes,
         launches=launches, peak_mem_bytes=peak,
         store_telemetry=tel.summary(), standing_unchanged=True)
    return dict(tiered=tiered, launches=launches, cols=cols, rows=rows,
                err=max(oracle_errs.values()))


def _tier_elements(tiered, view, host):
    """Every cold value within its chunk's scale of the value it
    replaced; integer columns and hot rows unchanged. Returns the
    largest error as a share of its scale."""
    chunk, n_cold = tiered.hot.chunk_rows, tiered.n_cold
    worst = 0.0
    for name, orig in host.items():
        got = view[name]
        if name not in tiered.cold_scales:
            if not np.array_equal(got, orig):
                raise AssertionError(f"tiers: integer column {name} moved")
            continue
        if not np.array_equal(got[n_cold:], orig[n_cold:]):
            raise AssertionError(f"tiers: hot rows of {name} moved")
        sc = tiered.cold_scales[name].cpu().numpy().astype(np.float64)
        row_scale = np.repeat(sc, chunk)
        if orig.ndim == 2:
            row_scale = row_scale[:, None]
        err = np.abs(got[:n_cold].astype(np.float64) - orig[:n_cold])
        share = float((err / row_scale).max())
        if share > 1.0 + 2.0 ** -20:
            raise AssertionError(f"tiers: {name} off by {share} scales")
        worst = max(worst, share)
    return worst


def _oracle_table(node, acc, cnt):
    """The plan's answer column from the float64 oracle's partials."""
    if node.agg == "count":
        return cnt.astype(np.float64)
    if node.agg == "mean":
        c = np.maximum(cnt, 1)
        return acc / (c if acc.ndim == 1 else c[:, None])
    return acc


def hold_oracle(what, got, node, post, acc, cnt, scale):
    """A query's answer ``got`` (table, mask) against the float64
    oracle's partials of the same rows: the mask and counts exact, max
    and min exact, sums within FLOAT_TOL of the group's sum of
    magnitudes (per row for a mean); after a TopK, the selected values
    against the oracle's lowest. Returns the max abs error."""
    from repro_torch.warehouse import TopK
    gt, gm = got
    want = _oracle_table(node, acc, cnt)
    g = gt[node.value].double().cpu().numpy()
    if any(isinstance(nd, TopK) for nd in post):
        worst = np.sort(np.where(cnt > 0, want, np.inf))[:len(g)]
        if not np.allclose(np.sort(g), worst, rtol=FLOAT_TOL, atol=1e-6):
            raise AssertionError(f"{what}: top values vs the oracle")
        return float(np.abs(np.sort(g) - worst).max())
    mask = gm.cpu().numpy()
    if not np.array_equal(mask, cnt > 0):
        raise AssertionError(f"{what}: mask vs the oracle")
    c = np.maximum(cnt, 1).astype(np.float64)
    if acc.ndim == 2:
        c = c[:, None]
    tol = FLOAT_TOL * (scale / c if node.agg == "mean" else scale) + 1e-6
    if node.agg in ("count", "max", "min"):
        tol = np.zeros_like(scale)
    diff = np.abs(g - want)[mask]
    if not np.all(diff <= np.broadcast_to(tol, want.shape)[mask]):
        raise AssertionError(f"{what}: {node.agg} off the oracle by "
                             f"{float(diff.max())}")
    return float(diff.max(initial=0.0))


def _tier_answer(name, plan, got, unspilled, cols, view, host, n, bound):
    """One plan over the two-tier view: against the float64 oracle of
    the view's rows (``hold_oracle``), and, where no filter reads a
    quantized column, against the unspilled answer within the
    quantization bound: the largest chunk scale per summed row for a
    sum, one scale for a mean, max or min, none for a count. Returns the
    error against the oracle and the largest difference to the unspilled
    answer."""
    from repro_torch.warehouse import TopK
    from repro_torch.warehouse import query as Q
    (gt, gm), (ut, um) = got, unspilled
    spec, _, filters = _spec_of(plan, cols)
    _, node, post = Q.split_plan(plan)
    acc, cnt, scale = oracle(view, n, filters, spec.keys, spec.value,
                             spec.agg)
    oracle_err = hold_oracle(f"tiers {name} vs the view's oracle", got,
                             node, post, acc, cnt, scale)
    g = gt[node.value].double().cpu().numpy()
    c = np.maximum(cnt, 1).astype(np.float64)
    if acc.ndim == 2:
        c = c[:, None]
    quantized = [f for f in filters if view[f.column].dtype == np.float32]
    u = ut[node.value].double().cpu().numpy()
    if any(isinstance(nd, TopK) for nd in post):
        g, u = np.sort(g), np.sort(u)
    diff = float(np.abs(g - u).max())
    if not quantized:
        if not torch.equal(gm.cpu(), um.cpu()):
            raise AssertionError(f"tiers {name}: masks differ")
        per = {"sum": c, "count": 0.0}.get(node.agg, 1.0)
        _, _, uscale = oracle(host, n, filters, spec.keys, spec.value,
                              spec.agg)
        mag = uscale / c if node.agg == "mean" else uscale
        tol = bound * per + 2 * FLOAT_TOL * mag + 1e-6
        if not np.all(np.abs(g - u) <= tol):
            raise AssertionError(f"tiers {name}: {diff} off the unspilled "
                                 f"answer")
    return oracle_err, diff


def time_k1(cols, n, plans, host):
    """K1 over ``plans`` on (cols, n), each held against its plain
    version in float64 and the float64 oracle (``hold``): summed kernel,
    plain-version and library milliseconds beside the byte bound, as
    ``phase_time``, and the largest error against the plain version."""
    from repro_torch.kernels import warehouse_agg as K
    tot = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0}
    for name, plan in plans.items():
        spec, fvals, filters = _spec_of(plan, cols)
        acc, cnt, scale = oracle(host, n, filters, spec.keys, spec.value,
                                 spec.agg)
        kept = int(cnt.sum())
        err = hold(name, K.fused_segment_agg(cols, n, fvals, spec),
                   plain64(K, cols, n, fvals, spec), (acc, cnt, scale),
                   spec.agg)
        tot["max_abs_err"] = max(tot["max_abs_err"], err["vs_plain"])
        tot["kernel_ms"] += cuda_ms(lambda: K.fused_segment_agg(
            cols, n, fvals, spec), 20)
        tot["plain_ms"] += cuda_ms(lambda: K.fused_segment_agg_ref(
            cols, n, fvals, spec), 5)
        tot["library_ms"] += cuda_ms(_library_call(cols, n, spec, fvals),
                                     10)
        tot["bound_ms"] += partial_bytes(cols, n, kept, spec) \
            / HBM_BYTES_PER_S * 1e3
    return tot


def _tick_blocks(sink):
    """Each pool section's last tick as the fold saw it: its rows of the
    sink, a (columns, rows) block. Tick t landed its rows together, with
    ``t`` in their column."""
    t = sink.host_rows()["t"]
    blocks = []
    for tick in np.cumsum(POOL_TICKS) - 1:
        rows = np.flatnonzero(t == tick)
        lo, n = int(rows[0]), len(rows)
        blocks.append(({k: v[lo:lo + n] for k, v in sink.columns.items()},
                       n, lo))
    return blocks


def phase_time_many(mm, pp, tt):
    """K1 at the new paths' shapes, each call held against its plain
    version and the float64 oracle: the main plans over the multi-stream
    store and over the two-tier view, and the pool's fold at the shape it
    runs, one tick's new rows into the shed-watch's 2,048 min
    accumulators (the last tick of each of the five sections: the mean
    of their times)."""
    store = mm["store"]
    per = {"multi": time_k1(store.columns, store.n_rows,
                            main_plans((mm["T"] - 1) // WINDOW + 1),
                            store.host_rows())}
    hot = tt["tiered"]
    host = {k: v[:tt["rows"]].cpu().numpy() for k, v in tt["cols"].items()}
    per["tiers"] = time_k1(tt["cols"], tt["rows"],
                           main_plans(hot.t_max // WINDOW + 1), host)
    ticks = []
    for cols, n, lo in _tick_blocks(pp["sink"]):
        host = {k: v.cpu().numpy() for k, v in cols.items()}
        ticks.append({"rows": n, "lo": lo,
                      **time_k1(cols, n, {"watch": pp["watch"]}, host)})
    per["pool"] = {k: statistics.mean(x[k] for x in ticks)
                   for k in ("kernel_ms", "plain_ms", "library_ms",
                             "bound_ms", "rows")}
    per["pool"].update(max_abs_err=max(x["max_abs_err"] for x in ticks),
                       ticks=ticks)
    emit("time_many", queries=per)
    return per


def idle_shares(calls, walls_us, dev):
    """Each ``calls[name]()`` once under one ``torch.profiler`` session,
    inside a ``record_function`` range of its name: 1 - the device time
    of the kernels and copies that start inside its range over
    ``walls_us[name]``, its unprofiled wall time (one stream: the
    kernels do not overlap; each call ends in a synchronisation, so its
    device work ends inside its range). Read from the raw profiler
    events: building the profiler's event tree for these calls takes
    longer than the calls."""
    import bisect
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for name, call in calls.items():
            with record_function(f"obs::{name}"):
                call()
    cpu = torch.autograd.DeviceType.CPU
    raw = list(prof.profiler.kineto_results.events())
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.name()[5:]) for e in raw
                    if e.name().startswith("obs::") and e.device_type() == cpu)
    starts = [r[0] for r in ranges]
    busy_ns = dict.fromkeys(calls, 0)
    for e in raw:
        if e.device_type() == cpu or e.is_user_annotation():
            continue
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i >= 0 and e.start_ns() < ranges[i][1]:
            busy_ns[ranges[i][2]] += e.duration_ns()
    if dev.type == "cuda" and not any(busy_ns.values()):
        raise AssertionError("obs: the profiler recorded no device time")
    return {n: 1.0 - busy_ns[n] / 1e3 / walls_us[n] for n in calls}


def phase_obs(dev):
    """The dispatch tracer over every engine of ``obs.engines``, its
    gates, and each engine's host syncs and device idle share."""
    from repro_torch.obs import engines as E
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.obs.run import compare, run_obs
    (report, trace), secs = timed(lambda: run_obs(device=dev, reps=3))
    problems = validate_chrome_trace(trace)
    if problems:
        raise AssertionError(f"obs: the Chrome trace is invalid: "
                             f"{problems[:5]}")
    if compare(report, report):
        raise AssertionError("obs: the report fails against itself")
    recs = report["engines"]
    skipped = sorted(n for n, r in recs.items() if "skipped" in r)
    if skipped:
        raise AssertionError(f"obs: engines skipped on the card: {skipped}")
    if set(recs) != set(E.ENGINES):
        raise AssertionError("obs: the report misses engines")
    for name, rec in recs.items():
        if rec["recompiles"]:
            raise AssertionError(f"obs: {name} loaded a library warm")
        if "pallas" in name and rec["launches"].get("K1", 0) < 1:
            raise AssertionError(f"obs: {name} launched no K1: "
                                 f"{rec['launches']}")
    calls = {}
    for name in recs:
        ex = E.build(name, dev)

        def call(ex=ex):
            ex.fn(*ex.args, **ex.kwargs)
            sync()
        call()                                       # warm
        calls[name] = call
    t0 = time.perf_counter()
    idle = idle_shares(calls, {n: r["span_us"] for n, r in recs.items()},
                       dev)
    profile_secs = time.perf_counter() - t0
    per = {n: {"span_us": r["span_us"], "host_syncs": r["host_transfers"],
               "idle_share": idle[n], "launches": r["launches"]}
           for n, r in recs.items()}
    top = sorted(per, key=lambda n: -per[n]["span_us"])[:5]
    emit("obs", seconds=secs, profile_seconds=profile_secs,
         traced=len(recs) - len(skipped),
         skipped=skipped, topology=report["topology"],
         warm_span_sum_us=sum(p["span_us"] for p in per.values()),
         host_syncs_sum=sum(p["host_syncs"] for p in per.values()),
         largest=[[n, per[n]["span_us"]] for n in top], engines=per)
    return per


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(torch.device("cuda"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev) -> None:
    """Every phase on ``dev``, then the card's name and power limit and
    the kernels line."""
    smi = phase_device()
    phase_build()
    k1_err = phase_kernel(dev)
    k2_err = phase_kernel_k2(dev)
    k3_err, k3_bf16_err = phase_kernel_k3(dev)
    k3b_err = phase_kernel_k3_bwd(dev)
    k4_err = phase_kernel_k4(dev)
    k4b_err = phase_kernel_k4_bwd(dev)
    m = phase_main(dev)
    errs = phase_check(m)
    phase_standing(m)
    phase_compare(dev, m)
    t = phase_transform(dev)
    phase_transform_check(t)
    sv = phase_serve(dev)
    ss = phase_serve_ssm(dev)
    sh = phase_serve_hybrid(dev)
    sm = phase_serve_moe(dev)
    se = phase_serve_encdec(dev)
    tr = phase_train(dev)
    tssm = phase_train_ssm(dev)
    thyb = phase_train_hybrid(dev)
    fam = phase_train_families(dev)
    per = phase_time(m, errs)
    k2, k3 = phase_time_k2_k3(dev)
    k4 = phase_time_k4(dev)
    h3, h4 = phase_time_hybrid(dev)
    m3 = phase_time_moe(dev)
    e3 = phase_time_encdec(dev)
    k3b = phase_time_k3_bwd(dev, fam)
    k4b = phase_time_k4_bwd(dev, tssm, thyb)
    mm = phase_multi(dev, m)
    multi_err = phase_multi_check(mm)
    pp = phase_pool(dev, t)
    pool_err = phase_pool_check(pp, dev)
    sd = phase_sharded(dev, m, mm, pp)
    gc.collect()            # its stores and registries refer to each other
    phase_dist(m, sd, smi)
    td = phase_train_dist(smi)
    phase_time_split(dev, td)
    sdp = phase_serve_dist(smi)
    tt = phase_tiers(m)
    many = phase_time_many(mm, pp, tt)
    phase_obs(dev)
    # each K1 path's error: its calls against the plain version at the
    # path's shapes, and its folds and answers against the float64 oracle
    path_err = {"multi": max(many["multi"]["max_abs_err"], multi_err),
                "pool": max(many["pool"]["max_abs_err"], pool_err),
                "tiers": max(many["tiers"]["max_abs_err"], tt["err"])}
    tot = {k: sum(q[k] for q in per.values())
           for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    k1_max = max([k1_err["vs_plain"]]
                 + [e["vs_plain"] for e in errs.values()])
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_segment_agg",
        "route": "cuda",
        "source": "src/repro_torch/csrc/warehouse_agg.cu",
        "replaces": "src/repro/kernels/warehouse_agg.py:192",
        "launches": m["launches"],
        "max_abs_err": k1_max,
        "ms": tot["kernel_ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes",
        "library_ms": tot["library_ms"],
    }, {
        "name": "downsample",
        "route": "cuda",
        "source": "src/repro_torch/csrc/frame_preproc.cu",
        "replaces": "src/repro/kernels/frame_preproc.py:26",
        "launches": t["launches"]["downsample"],
        "max_abs_err": k2_err,
        "ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "launches": (t["launches"]["flash_attention"] + sv["launches"]
                     + tr["fwd_launches"] + td["k3_fwd"]),
        "max_abs_err": k3_err,
        "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }, {
        "name": "flash_attention[bf16]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "launches": (sv["k3_bf16"] + sh["k3_bf16"] + sm["k3_bf16"]
                     + se["k3_bf16"] + sdp["k3"]),
        "max_abs_err": k3_bf16_err,
        "ms": k3["bf16"]["kernel_ms"],
        "plain_ms": k3["bf16"]["plain_ms"],
        "bound_ms": k3["bf16"]["bound_ms"],
        "bound_by": k3["bf16"]["bound_by"],
        "library_ms": k3["bf16"]["library_ms"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd.py:63",
        "launches": (ss["launches"] + tssm["fwd_launches"] + td["k4_fwd"]
                     + sdp["k4"]),
        "max_abs_err": k4_err,
        "ms": k4["kernel_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": ("XLA's gradient of src/repro/models/attention.py:50 "
                     "(no Pallas kernel)"),
        "launches": tr["bwd_launches"] + td["k3_bwd"],
        "max_abs_err": k3b_err,
        "ms": k3b["kernel_ms"],
        "plain_ms": k3b["plain_ms"],
        "bound_ms": k3b["bound_ms"],
        "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"],
    }] + [{
        "name": f"ssd_scan_bwd{suffix}",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": ("XLA's gradient of src/repro/models/ssd.py:53 "
                     "(no Pallas kernel)"),
        "launches": launches,
        "max_abs_err": k4b_err,
        "ms": k4b[shape]["kernel_ms"],
        "plain_ms": k4b[shape]["plain_ms"],
        "bound_ms": k4b[shape]["bound_ms"],
        "bound_by": k4b[shape]["bound_by"],
        "library_ms": k4b[shape]["library_ms"],
    } for suffix, shape, launches in (
        ("", "mamba2_train", tssm["bwd_launches"] + td["k4_bwd"]),
        ("[hymba-1.5b]", "hymba_train", thyb["k4_bwd"]))] + [{
        "name": f"flash_attention[hymba-1.5b {kind}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "launches": sh[f"k3_{kind}"],
        "max_abs_err": k3_err,
        "ms": h3[kind]["kernel_ms"],
        "plain_ms": h3[kind]["plain_ms"],
        "bound_ms": h3[kind]["bound_ms"],
        "bound_by": h3[kind]["bound_by"],
        "library_ms": h3[kind]["library_ms"],
    } for kind in ("window", "global")] + [{
        "name": "flash_attention[mixtral-8x7b]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "launches": sm["launches"],
        "max_abs_err": max(m3["max_abs_err"], m3["bf16"]["max_abs_err"]),
        "ms": m3["kernel_ms"],
        "plain_ms": m3["plain_ms"],
        "bound_ms": m3["bound_ms"],
        "bound_by": m3["bound_by"],
        "library_ms": m3["library_ms"],
    }] + [{
        "name": "flash_attention[encdec]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67",
        "launches": se["launches"],
        "max_abs_err": e3["max_abs_err"],
        "ms": e3["kernel_ms"],
        "plain_ms": e3["plain_ms"],
        "bound_ms": e3["bound_ms"],
        "bound_by": e3["bound_by"],
        "library_ms": e3["library_ms"],
    }] + [{
        "name": "ssd_scan[hymba-1.5b]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd.py:63",
        "launches": sh["k4"],
        "max_abs_err": k4_err,
        "ms": h4["kernel_ms"],
        "plain_ms": h4["plain_ms"],
        "bound_ms": h4["bound_ms"],
        "bound_by": h4["bound_by"],
        "library_ms": h4["library_ms"],
    }] + [{
        "name": f"fused_segment_agg[{path}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/warehouse_agg.cu",
        "replaces": "src/repro/kernels/warehouse_agg.py:192",
        "launches": launches,
        "max_abs_err": path_err[path],
        "ms": many[path]["kernel_ms"],
        "plain_ms": many[path]["plain_ms"],
        "bound_ms": many[path]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": many[path]["library_ms"],
    } for path, launches in (("multi", mm["launches"]),
                             ("pool", pp["launches"]),
                             ("tiers", tt["launches"]))] + [{
        "name": "fused_segment_agg[sharded]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/warehouse_agg.cu",
        "replaces": "src/repro/kernels/warehouse_agg.py:192",
        "launches": sd["launches"],
        "max_abs_err": sd["err"],
        "ms": sd["k1"]["kernel_ms"],
        "plain_ms": sd["k1"]["plain_ms"],
        "bound_ms": sd["k1"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": sd["k1"]["library_ms"],
    }]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
