"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions.
2. Builds every hand-written kernel from `streamchat_tpu_torch/csrc/` (one
   nvcc per source, in parallel) and prints the build seconds.
3. Builds the pipeline at full LongVA-7B width on random weights (seeded)
   and writes its three models in a temporary directory as HF
   checkpoints (`write_checkpoint`, the script's own safetensors writer:
   an 8-byte header length, the JSON header, the raw bytes; HF names and
   the [out, in] layout): LongVA-7B as llava_qwen (Qwen2-7B's config
   fields, bf16 shards of at most 5 GB and model.safetensors.index.json),
   mxbai-colbert-large (f32, under a "bert." prefix) and MiniLM-L6 (f32,
   without), printing the free space before each write and raising when it
   is short. Then builds the pipeline from the three paths with
   `build_pipeline` (`LongVA.from_pretrained` with the byte tokenizer, the
   checkpoints carrying none, and two `TextEmbedder.from_pretrained`), and
   holds every leaf and config of the loaded models to the written ones,
   bit for bit, before the written trees are freed. Prints the seconds and
   GB/s of the write and of the load, a raw read of the same files' bytes
   before the load (its yardstick), host peak RSS before the write, after
   it, after the raw read and after the load, the device peak of the
   build phase and the bytes on disk. Three planted writer faults, each in a checkpoint of the written
   decoder cut to two layers and 4,096 vocabulary rows, must fail the leaf
   check (layer 1's q and k projections swapped, layer 0's o projection
   without its transpose, layer 1's down projection's BF16 bytes under an
   F16 header) and the same checkpoint without a fault must pass. Every
   later phase runs from the loaded weights.
4. Holds each of the nineteen kernels against its plain PyTorch twin at
   main-path shapes, tolerance |kernel - plain| <= 3e-2 + 2e-2 |plain|
   (bf16 storage, f32 accumulation in both, different summation order),
   and times both (ms: device time per call, the summed device events
   torch.profiler records; wall_ms: back-to-back calls timed with CUDA
   events, which for a kernel shorter than its wrapper's host work is the
   host's pace): K1 ViT layer (the ingest's folded, one-pass, clamp form,
   timed, with the device time of each of its seven launches; the exact
   unfolded form, folded + exact, and erf-GELU; its four products through
   the wgmma GEMM on its own at K1's shapes and epilogues, with the four
   torch.matmul calls at those shapes timed beside them), K2
   projector MLP, K3 flash attention (causal at S = 23,168 with a ragged
   kv_length, timed, at S = 4,096 with its own bound and library time, and
   at S = 300), K4
   paged decode (timed over four pools in turn, so that each call reads
   its 47.7 MB cold from HBM, and at B = 2 on a 364-page partitioned
   pool), W8 int8 GEMV (gate, down, and the lm_head with f32
   output), K10 int4 GEMV (o and down), K11 fused int4 GEMV (the q/k/v
   triple, the gate/up pair), K10 and K11 each at 1 and 5 rows over enough
   layers' weights in turn to read them cold, K6 paged decode over int8 pages (timed over
   four pools in turn, and at 1,444 tokens beside K4's), K5 partial flash
   attention (the last 3,072-token
   chunk of a 23,552-token caption prefill, global offset 20,480), K7 and
   K7′ (five in-flight queries against 23,105 pool tokens, bf16 and int8
   pages, four pools in turn; and ten, 70 folded rows a kv head in two
   64-row tiles, checked and timed with their own bound), K8 and K9 (one decode
   token of three rows of 23,105, 11,905 and 1 tokens through a page table
   over a shared 288-page pool in a seeded permutation, -1 past each
   row's pages and once inside a row's length, NaN in the pages no slot
   maps; ms_row0 times the 23,105-token row alone, beside K4; and at the
   caller pool's shape, two rows of 6,100 and 3,050 tokens on a 98-page
   pool through 50 slots, timed over four pools in turn), K12
   scene-change dedup (frame descriptors [60, 3584] f32, every third
   frame a near-repeat; similarities within 1e-5 of the twin and equal
   keep masks; timed beside an empty kernel's device time, the launch
   floor, at one block and at K12's grid), K13 the LN-attention half of ViT layer 0 (x [16, 577,
   1024], clamp and exact softmax, unfolded and folded with the one-pass
   LayerNorm), K14 non-causal ViT attention ([16, 16, 577, 64]), and the
   probe kernels: K15 the int4 GEMV probe (3584 x 18944, n = 1; its five
   variants at block_out 1024, gpb 16, and cur / xor32 / xor8 at the nine
   sweep points; dma exactly), K16 the ViT-layer probe (its five variants
   at [128, 577, 1024]) and K17 the dot probe (qk64, qk128, pv64, pv128).
   All but K1, K2, K12 and K16 are also held to a relative L2 error of 1e-2 per
   output row (the partial kernels through acc / l, and m and l
   elementwise), and planted faults must fail that same check (K12's its
   own): a key tile or a 4-page chunk zeroed, the
   valid length ignored or 128 past its end, a 128-row slice of an int8
   weight zeroed, int4 nibble halves swapped, one group's scale ignored,
   K10 / K11 with the last block's last warp range of groups, one cluster
   rank's whole range or (q/k/v) the k part's last column tile zeroed,
   int8 page scales replaced by 1, K3 run non-causal on the causal S = 300
   case, K5's offsets swapped, its q_offset shifted by 37 on the
   rows-without-keys case or its m left unclamped, K7's row fold
   transposed or its pool length counting the block, K4 without the last
   page of one split range, K4 and K7 with NaN in V past the length and
   V's rows there not zeroed before P V (the kernels are also held to
   their twins on that NaN pool), K6 and K7′ with the int8 V past the
   length not zeroed (its inf scale multiplied into p = 0) or k_scale
   applied after the mask (-inf times a NaN scale), K7 and K7′ at T 10
   with the second row tile dropped, K8 / K9's table
   ignored (pool order), -1 read as page 0, the
   length ignored, one table entry off by one, a hole inside a row's
   length walked as a key (its page read as zeros, as TMA reads page -1),
   the last live page taken as full, V's rows past the length not zeroed
   (NaN there on bf16 pages, an inf scale on int8), K12's roll reversed or its
   rows left unnormalized, K13 without the residual, K14 with its last key
   masked or its last key tile (keys 512-576) dropped, K1's GEMM with its
   last 64-deep k-slab skipped or its residual dropped, K15's xor algebra
   without its -8 sum(x_g) term and its cur unpack on swapped nibbles or
   the last row range or column sub-tile of its card split dropped, K16's
   folded weights run unfolded, K17 with one dot dropped or the last
   column of the operand its threads load into shared memory skipped
   (qk64, pv64). Keys, values and scales past
   the valid length hold large garbage (NaN and inf for the int8 scales),
   as stale cache slots may.
   Each row carries the kernel's bound (the larger of its FLOPs at 989
   TFLOP/s, 67 for K12's f32 arithmetic, and its bytes at 3.35 TB/s, each
   input read and each output written once) and, where one PyTorch call
   computes the same function, that call's device time (`library_ms`:
   SDPA for K3, K5 and K14, a bf16 matmul on the dequantized weight for
   W8, K10, K11 and K15, `F.cosine_similarity` against the rolled rows for
   K12, one matmul for K17's qk kinds and a matmul and a sum for its pv
   kinds). The Hopper kernels' rows (K3, K5, and since the ViT runs them
   K1, K2, K13, K14, K16; K15 and K17; K10 and K11, each case with its
   blocks, GB/s and host time per call) also carry their share of the bound
   and the compiled kernels' registers, spill bytes and shared bytes
   (`sc_flash_prefill_attributes`, `sc_gemm_attributes`, `sc_int4_gemv_attributes`,
   `sc_int4_probe_attributes`, `sc_dotk_attributes`,
   `sc_paged_decode_attributes` for K4 / K7, K6 / K7′, K8 and K9 with their
   resident blocks per SM); K15's row the blocks each sweep point launches
   and its dma-to-cur time ratio, K17's each kind's blocks, K4's, K6's,
   K7's, K7′'s, K8's and K9's their split (`paged_split`), the device time
   of each of their two launches, GB/s and the wrapper's host time per call
   (K8 and K9 at both shapes).
5. Checks the composed paths on small inputs: two frames through
   `encode_images` (the fused tower, folded on that first call) against
   the plain twin chain of the same form and against the exact unfolded
   chain (per-token cosine >= 0.99 after 23 bf16 layers), the random
   tower's attention logit bounds inside the clamp softmax's domain
   (-87, 80]; one 28-layer decode step through K4 against the
   page-table gather path; one 28-layer decode step of the int8 tree (W8)
   and of the int4 tree (K10/K11) each against the same step on its
   dequantized bf16 tree; and one 28-layer verify step of five
   teacher-forced tokens (K7, bf16 and int8 pages) against five vanilla
   decode steps (K4 / K6), and one of four tokens of each of two rows on a
   partitioned pool against four vanilla steps at B = 2; one 28-layer
   decode step of three rows on a shared pool through K8 and K9 against the
   same step through the plain gather. Logits are held to a relative L2
   error of 5e-2 (one bf16 rounding difference per layer compounds through
   the stack).
6. Times the chunk-40 caption prefill (23,441 tokens, bf16 weights) in one
   pass (K3 only, the port before chunked prefill) and through the chunked
   dispatch (K3 for chunk 0, K5 for chunks 1-5), in turns.
7. Runs the probes, the main paths of K15-K17, with the launch
   counters zeroed before and read after: `utils.probe_vit_variants.main`
   (the five layer variants chained at [128, 577, 1024], then the four dot
   kinds) and `utils.probe_int4.main` (the five variants, then the
   nine-point sweep on the fastest unpack). Each must launch its kernel in
   every variant or kind.
   Then drives `generate_paged` on a caller-sized pool, the path of K8 and K9,
   with the launch counters zeroed before it and read after it: two rows of
   6,100 and 3,050 tokens, 64 new tokens, a 98-page pool that the allocator
   fills mid-decode, bf16 pages (K8) and int8 pages (K9); the same rows on
   the split path (K4 / K6) give the reference first-step logits (relative
   L2 <= 5e-2) and greedy agreement, and a 97-page pool must raise
   RuntimeError. Then `generate_paged` with spec_tokens 9 over int8 pages
   (one 3,050-token row, 32 new tokens, counters zeroed before and read
   after): K7′ must launch, every time with 70 folded rows a kv head (two
   row tiles), and the first verify step's logits are held to ten vanilla
   int8 decode steps (K6) teacher-forced with its tokens from a copy of the
   pool it started from (relative L2 <= 5e-2).
8. Runs `StreamChatPipeline.process_video` (off-line, canonical v0.3
   memory settings) on a 600-frame 360x640 synthetic video seven times on
   one model build, the launch counters zeroed before each run and read
   after it: (1) bf16 weights, breakpoint at 10 s; (2) int8 weights, the
   CLI default, breakpoints at 10 s and 20 s; (3) int4 weights with int8 KV
   pages, breakpoint at 10 s; (4) int8 weights with spec_tokens = 4,
   breakpoint at 10 s; (5) int4 weights, int8 KV pages and spec_tokens = 4,
   breakpoint at 10 s (the run that drives K7′); (6) int8 weights with
   caption_batch = 2 and (7) int4 weights with int8 KV pages and
   caption_batch = 2, each with its breakpoint at 10 s, whose two chunk
   captions (23,441 and 11,921 tokens) form one 2-row group: the shorter
   row's prefill takes the re-run branch and decode reads the partitioned
   pool at B = 2 (K4 / K6). Runs 1 and 3-7 answer in at most 64 tokens
   (run 2 and the on-line runs in the default 256). Each quantized tree is
   made from the bf16 tree and freed before the next. A run fails if one
   of its kernels was not launched, an answer is missing, no token was
   generated or no caption prompt passed 23,000 tokens, and runs 6 and 7
   fail unless a 2-row group decoded at B = 2 with a re-run. Every run's
   K1 launches must all be of the ingest's form (folded, one-pass LN,
   clamp softmax; `kernels.launch_modes`). Prints decode
   ms/step and per emitted token, accepted tokens per verify step, caption
   seconds per caption, peak memory, and the weight and KV bytes a decode
   token reads.
9. Right after the bf16 run (1), from the generator states it started
   from, runs it again through a pipeline whose memory config takes
   --offload_chunks --offload_residents as `config_from_args` parses them:
   each raw chunk goes to pinned host memory as it is cut and back right
   before its caption, and the ViT, projector and both embedders are parked
   in pinned host memory for the caption loop. Its captions' and answer's
   token ids must equal the bf16 run's; at the first caption the boxed
   feature stack must be gone and the trees parked, the device's allocated
   bytes down from update_memory's entry by at least the stack's and the
   trees' bytes less what stays on the card (the caption's chunk, the short
   memory, the tree's nodes; 16 MiB of slack), and every tree must come back
   on the card bit for bit (planted: a restore that skips the bank
   embedder). Prints the bytes allocated at the entry, at the first caption
   and after the restore, the host pinned bytes, and the seconds and GB/s
   of each direction for the chunks and the trees. Then, on 64 frames of
   the video (every ninth): S2 ingest at scales (336, 672), 64 + 256 tiles
   through K1 (46 launches) and a 2048 -> 3584 mlp2x_gelu through K2 (one
   launch), held to the chain of plain twins (min token cosine 0.99), its
   first 256-tile K1 launch and its K2 launch each to its twin at the
   kernels' tolerance, and timed against single-scale ingest (frames/s);
   anyres on one 360x640 frame with LLaVA-NeXT's grid pinpoints (best
   resolution 672 x 672, a 2 x 2 grid, five tiles with the overview) and
   its tiles through `encode_images`, held to the twin chain; the host
   frameproc built from the checkout's C++ copy (g++, forced) against the
   card's `preprocess_frames` (interior mean difference under 0.08, the JAX
   package's bound; frames/s of each); and, each on the card in f32
   against the same code in float64 on the host (relative error 1e-4):
   the Perceiver (dim 1024, depth 6, 64 latents) and the Q-Former
   (bert-base, 32 queries, vision width 1024) over 16 x 576 features,
   optical flow over the 32 first frames each shown twice (a keep mask
   equal to the host's at a threshold in the widest gap of the
   magnitudes), k-means over 16 blobs (labels equal), knn with planted
   exact ties (the lower indices first) and pairwise soft-DTW. Then the
   traced run: `process_video` in bf16 at full depth over the 10 s
   breakpoint, generations cut to 16 new tokens, under
   `utils.profiling.maybe_device_trace` (torch.profiler, CPU and CUDA
   activity; the runner's phases are `record_function` windows that
   enclose their device synchronize), read back with `utils.traceparse`:
   per phase wall_s, device_s, host_gap_s, device_events and the idle
   share 1 - device_s / wall_s, the top ten device ops and the trace's
   size. Held: device_s <= wall_s in every phase; ingest, caption and
   answer show device events; the trace's K1 launches (its attention, the
   flash_prefill_kernel at head dim 64) equal the ViT's blocks run x frame
   batches and the K1 counter, its K3 launches (head dim 128, not partial)
   the decoder's 28 layers x one-pass prefills and the K3 counter, K5's and
   K4's their counters. A trace that lost events is taken again, five runs
   at most, then the phase fails. Planted: a copy of the trace with a
   `gpu_user_annotation` over the caption windows must leave caption's
   device_s unchanged.
10. Runs `process_video_online` (`--mode on_line`: a worker thread captions
   while the caller ingests, a short-term FIFO across the stream) twice on
   the int8 tree, counters zeroed before each: over both breakpoints, where
   it must make as many captions as the off-line int8 run, and with
   `dedup_threshold` set to the median scene-change score of the first
   segment's frames over the first breakpoint, where K12 must run, drop
   some frames and keep others, and one caption must be made per 40 kept
   frames of the segment, rounded up. Both must launch K1-K5, W8 and K4.
   Prints each ask's seconds, the worker's caption seconds and the seconds
   in which they overlapped the caller's ingest (host clock, measured from
   outside: the on-line path times no phases), and peak memory.
11. Runs stage 1's answer and memory options on the int8 tree, the
   launch counters zeroed before each run and read after it, each config
   switched for its run (`configured`): (1) `process_video` with the
   uni-modal answer (the CLI's default, no --multi_modal_memory), --ppl and
   interval 2, breakpoint at 10 s: the two chunk captions merge into a
   depth-1 root, so `search_features` descends it at full width with the
   query [question token embeddings | short memory]; its walk is held to a
   float64 host recomputation (the same node tensors, each level's scores
   within 1e-5 relative), and the answer's NLL pass (one K3 pass a layer
   over prompt + target, 28 launches) is recomputed from its recorded
   inputs on the kernels and on their plain twins (K3's by kv head and by
   2,048-query blocks): the hidden rows that predict the targets and their
   logits within a relative L2 of 5e-2 a row, the per-target log-probs
   within the kernels' tolerance and a relative L2 of 1e-2, the run's mean
   NLL reproduced; the logits 10% too large and the log-probs read at the
   targets shifted by one position (both planted) must fail; (2) `process_video_online` with --ppl and max_visual_tokens
   1,024 (the on-line session, as the JAX package's, never pools: its
   captions stay chunk-40 prompts of 23k tokens), breakpoint at 10 s; (3)
   `process_video` at compress_rate 2 with --ppl and the same budget: the
   24 x 24 patch grid pooled to 12 x 12, 6.2k-token chunk-40 captions in
   one K3 pass each, and K5 must not launch. Runs 2 and 3 must answer
   through `StreamChatPipeline._answer`, carry nll / ppl in every record,
   score the answer's own prompt, and keep no level beyond the finest past
   the budget. Each answer decodes at most 64 tokens, each summary 32.
   Then MaxSim and the one-shot trees at
   mxbai-colbert-large width: run 1's tree rebuilt with `from_state` on the
   card with `embed_tokens_fn`, its texts token-embedded (a text without
   tokens, as the random decoder's byte-decoded captions mostly are, gets a
   fixed caption), `search_maxsim` against a float64 host MaxSim (the same
   captions and nodes); `build_top_down` over the first segment's 60 frames
   (two depth-0 nodes: `search_features` finds nothing, as on the host)
   and `build_bottom_up` (interval 2) over run 1's two leaves and those two
   nodes (a depth-2 root: a three-level search), each searched with run
   1's query against the float64 host recomputation. Prints each run's
   report, the answer prompt, the path, the NLL / PPL, the NLL pass's
   seconds on the kernels and on the twins, and the visual tokens kept.
12. Runs H2O eviction (`LongVA.kv_budget_tokens`) on the int8 tree through
   `generate_with_image_embedding`, greedy, the counters zeroed before each
   run and read after it: budget 8,192 on a chunk-40 caption prompt (40
   frames of the video, a 23,552-token bucket: compressed to 6,144 slots
   right after its chunked dense prefill, K3 + K5) with 128 new tokens, and
   budget 512 on a one-frame caption prompt (compressed at prefill) with
   300 new tokens, over which the loop compresses again at least twice.
   Each budgeted step must rope at its global position and see a pool of
   at most cap / 128 pages; a step must collect mass through the plain
   gather exactly while a later compression is to come (adding g = 7 of
   mass a (layer, kv head)) and run K4 after the last one; the prompt's
   seeded mass (first and last layer) and one step's layer-0 mass are held
   to float64 host recomputations (relative L2 1e-4 a kv head).
   `compress_kv` on the card is held to the CPU's on the same inputs (the
   8,192 run's prefill: 112 heads of 23,552 slots, its scores and tied
   integer scores: equal kept slots, bit-equal K / V / scores; the merges
   at the 512 run's prefill on integer keys, within 1e-5). Planted faults:
   ties broken toward the higher slot, and the step after a compression
   roped at the cache length. Then an 8-frame prompt under budget 8,192
   (5,120 tokens; no compression fires, so every step runs K4) against the
   same prompt without a budget: the first 16 steps' logits within 5e-2 a
   row while their tokens agree; and one collect_mass step against one K4
   step on copies of the same 64-page pool (logits within 5e-2 a row).
   Prints prefill s, decode ms/step with and without collect_mass, the
   compressions and peak memory.
13. Runs the memory-free baseline (`pipeline/baseline.py`, prefix and ego
   modes) and the cross-benchmark runners (`pipeline/bench_runners.py`:
   videoqa at 8 and at 128 frames, videobench, seedbench) through their
   `main(argv)` with `--model_name` at the written LongVA-7B checkpoint
   (loaded in bf16 with the byte tokenizer), over an mp4 of the video's
   first 10 s, annotations and two PNG frames written by the script, 16
   new tokens an answer, the counters zeroed before each run and read
   after it. Each output file must hold the JAX CLI's records and keys,
   each answer must emit a token, K1, K3 and K4 must launch (seedbench: K1
   and K3), K5 at 128 frames (a 73.8k-token prompt); seedbench's eight
   NLLs are held to the plain twins' within |d| <= 3e-2 + 2e-2 |plain| and
   its accuracy summary is written as JSON. Prints seconds per item.
   Then the StreamBench tools' CLI (`tools/streambench.py`) over that mp4
   and annotation file: stats, resample, check-videos (opening the video;
   a wrong video root must report it missing) and extract-frames at 1 fps
   (ten frames of 300).
14. Frees LongVA's trees and checkpoints, writes LLaMA-3-8B at full width
   and depth (32 layers, d 4096, 32 / 8 heads, ffn 14,336, vocab 128,256;
   random weights, seeded) as an HF llama checkpoint (an eos list
   [128001, 128009], no pad token, an untied head; 16.06 GB of bf16
   shards), loads it with `TextLM.from_pretrained` (the byte tokenizer),
   holds every leaf and the config to the written ones and prints the
   same load figures, frees the written tree and the directory, and runs
   stages 2 and 3 of the v0.3 run from the loaded weights:
   `eval.judge.judge_predictions`
   with `TextLM.generate_batch` (batch 8, 64 new tokens, the judge CLI's
   defaults) over the first 8 stage-1 predictions of the runs above
   (repeated to 8 when fewer), three times on one build: bf16, `--int8`
   (the tree quantized, the bf16 tree freed) and `--int8 --spec_tokens 4`,
   the launch counters zeroed before each run and read after it; then
   `eval.scoring.main` over each run's JSONL. Each run must launch K3 once
   a layer and prefill at 4 query heads a kv head; the int8 run W8 at 8 rows
   at every decode shape (q / o, k / v, gate / up, down, and the head with
   f32 out); the spec run K7 at 20 folded rows a kv head, 8 kv heads, B 8.
   Each run's first decode (or verify) step is held to the same step on the
   kernels' plain twins from the same prompts (prefill included): logits
   (row relative L2) and the K/V the step wrote at each row's positions
   (the dense step's one slot at its length, the verify step's five from
   its length; relative L2 a row), both within 5e-2; a decode step whose
   appends all land at row 0's length and a verify step whose writes do
   (planted) must fail it. Prints each
   run's prefill s, decode ms/step and per emitted token, emitted tokens a
   row a verify step, peak memory, the weight bytes a decode step reads and
   their bound at 3.35 TB/s, and the scores.
15. Multi-GPU (tensor parallelism, one process a rank; before the judge's
   checkpoint is written, the LongVA part, after it the judge part): the
   runner (int8, one breakpoint over the video's first 2 s: 6 frames,
   chunk 4, 16-token captions and answers, from the written checkpoints)
   run unsharded here as the reference, off-line and on-line; then rank
   processes (`torch.multiprocessing`, spawn) that share the card over a
   gloo group the script sets up (gloo aborts on CUDA tensors in this
   torch build: each all_reduce is staged through a pinned host buffer),
   the card's free bytes printed first: `runner.main --shard` off-line at
   tp 4 and `--mode on_line --shard` at tp 2 (the ranks build in turn:
   load, quantize, shard), and the int8 judge with `TextLM.shard` at tp 4
   over the 8 predictions (rank 0's whole tree judges first: the
   reference). Held: every rank's tokens equal (an all_reduce of a token
   hash), the first decode step's logits within 1e-2 row relative L2 of
   the unsharded model's on the same prompt, the first token equal, rank 0
   alone writing the results, the path's kernels launched in every rank.
   Printed: each rank's device bytes after `shard`, the leading tokens
   equal to the unsharded run, and every rank's all_reduce calls, bytes
   and host seconds by label. Then each kernel at a tp-4 rank's shapes
   against its twin (K3 / K5 at 7 / 1 heads and K3 at LLaMA's 8 / 2, K4 /
   K6 / K7 / K7′ / K8 / K9 over one kv head, W8 at the shards' widths, K10
   / K11 at the rank's widths), and the sequence-parallel ops for four
   ranks emulated in this process through their per-step functions (ring
   with a ragged kv_length, zigzag, stripe, Ulysses, USP 2 x 2 at 28 / 4
   heads, S = 16,384, B = 2), each held to K3 over the whole sequence and
   to the plain twin; planted: a rotation skipped, a block's k_offset one
   shard late, zigzag's inverse permutation left out, Ulysses' all-to-all
   with split and concat axes swapped. Before those two, the data axis:
   `runner.main --shard` off-line, int8, over 8 ranks on the card (gloo),
   which `make_mesh` lays out as the 2 x 4 (data, model) mesh an 8-card
   user gets at Qwen2-7B's 4 kv heads, every rank given the same output
   paths, over two annotations (one breakpoint and one video each): each
   replica's ranks must emit the same tokens, equal to a tp-4 runner run
   of its `--num_chunks 2 --chunk_idx d` share (replica 0's: the tp-4
   off-line phase, the same annotation; replica 1's: a tp-4 phase run for
   it), and its first token and first decode step (within 1e-2) those of
   the unsharded runner run of that share (run here first); rank r must sit
   at (r // 4, r % 4); `--save_file` must hold both replicas' records in
   annotation order, equal to the tp-4 runs' records; rank 0 writes it and
   replica 0's bank file, rank 4 replica 1's, no other rank anything. Printed: each rank's coordinates, bytes
   after `shard`, all_reduce calls / bytes / host seconds, and the phase's
   seconds. Planted: replica 1 having run replica 0's annotation, and a
   rank in the other replica's model group. Where the machine has a card a
   rank, the off-line TP runner and the SP ops run again over NCCL through
   their real transports (the data-axis phase where there are eight
   cards); on one card one line says they did not run.
16. Prints the kernels JSON line, then the device JSON line last.

Any failure raises: the script then exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import torch

from streamchat_tpu_torch.ops.fused_vit import SOFTMAX, SOFTMAX_CLAMP_BF16, layer_mode
from streamchat_tpu_torch.utils.profiling import device_launches, device_ms, host_us

ATOL, RTOL = 3e-2, 2e-2
ROW_REL_L2 = 1e-2
STEP_REL_L2 = 5e-2
CAPTION_TOKENS_MIN = 23000

# Published peaks of one H100 SXM (dense bf16 tensor cores, f32 outside the
# tensor cores, HBM3).
PEAK_FLOPS, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
SPEC_TOKENS = 4
# The earlier slices' one-breakpoint runs answer in 64 tokens, not the
# default 256 (decode depth cut to keep the script short; their captions
# keep their 128): the two-breakpoint int8 run and the on-line runs keep 256.
SHORT_ANSWER = dict(max_answer_tokens=64)
# K12's similarities (f32 descriptors) are held to their twin's within this.
SIM_ATOL = 1e-5
# The form every pipeline run's ingest launches K1 in (ops/fused_vit.layer_mode).
INGEST_K1_MODE = layer_mode("clamp", folded=True, ln_onepass=True, activation="quick_gelu")
# K1's launch sequence (csrc/fused_vit.cu sc_fused_vit_layer), in order.
K1_LAUNCHES = ("LN1", "QKV GEMM", "attention", "O GEMM + residual", "LN2",
               "fc1 GEMM + activation", "fc2 GEMM + residual")
K1_GEMMS = ("QKV GEMM", "O GEMM + residual", "fc1 GEMM + activation", "fc2 GEMM + residual")

# Kernels each process_video run must launch (wrapper names): every run
# prefills its 23k-token captions in chunks (K3 + K5).
PREFILL = ("fused_vit_layer", "fused_ln_mlp", "flash_attention", "flash_attention_partial")
INT4 = ("qmatvec_int4", "qmatvec_int4_fused", "qmatvec_int8")
RUNS = {
    "bf16": PREFILL + ("paged_decode_attention_seq",),
    "int8": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8"),
    "int4_kv_int8": PREFILL + ("paged_decode_attention_seq_int8",) + INT4,
    "int8_spec": PREFILL + ("paged_seq_attention_partial", "qmatvec_int8"),
    "int4_kv_int8_spec": PREFILL + ("paged_seq_attention_partial_int8",) + INT4,
    "int8_cb2": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8"),
    "int4_kv_int8_cb2": PREFILL + ("paged_decode_attention_seq_int8",) + INT4,
    # process_video_online (--mode on_line), and with dedup (K12).
    "online_int8": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8"),
    "online_int8_dedup": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8",
                                    "select_changed_frames"),
    # generate_paged on a caller-sized pool (the allocator maps pages mid-decode).
    "caller_pool_bf16": ("paged_decode_attention_table",),
    "caller_pool_kv_int8": ("paged_decode_attention_table_int8",),
    # generate_paged with spec_tokens 9 over int8 pages (two row tiles).
    "spec9_kv_int8": ("paged_seq_attention_partial_int8",),
    # Stage 1's answer and memory options: the uni-modal answer with --ppl
    # (interval 2), the on-line mode with --ppl and a visual-token budget,
    # and compress_rate 2 (5.9k-token captions: K3 in one pass, no K5).
    "int8_unimodal_ppl": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8"),
    "online_int8_ppl": PREFILL + ("paged_decode_attention_seq", "qmatvec_int8"),
    "int8_compress2_ppl": ("fused_vit_layer", "fused_ln_mlp", "flash_attention",
                           "paged_decode_attention_seq", "qmatvec_int8"),
    # H2O eviction on the int8 tree: the budget-8192 run's 23k-token prompt
    # prefills in chunks; a step attends through the plain gather while a
    # later compression is to come, and through K4 after the last one.
    "h2o_budget_large": ("flash_attention", "flash_attention_partial", "qmatvec_int8",
                         "paged_decode_attention_seq"),
    "h2o_budget_small": ("flash_attention", "qmatvec_int8", "paged_decode_attention_seq"),
    # The bf16 run again with --offload_chunks --offload_residents.
    "bf16_offload": PREFILL + ("paged_decode_attention_seq",),
    # Stage 2: the LLaMA-3-8B judge, bf16, --int8, --int8 --spec_tokens 4.
    "judge_bf16": ("flash_attention",),
    "judge_int8": ("flash_attention", "qmatvec_int8"),
    "judge_int8_spec4": ("flash_attention", "paged_seq_attention_partial"),
    # Tensor parallelism: runner --shard at int8 (tp 4 off-line, tp 2
    # on-line) and the int8 judge sharded over 4 ranks, each rank's launches.
    "tp4_runner_offline": ("fused_vit_layer", "fused_ln_mlp", "flash_attention",
                           "paged_decode_attention_seq", "qmatvec_int8"),
    "tp2_runner_online": ("fused_vit_layer", "fused_ln_mlp", "flash_attention",
                          "paged_decode_attention_seq", "qmatvec_int8"),
    "tp4_judge_int8": ("flash_attention", "qmatvec_int8"),
    # The (data, model) mesh: runner --shard over 8 ranks, dp 2 x tp 4, and
    # its replica 1's tp-4 reference (--num_chunks 2 --chunk_idx 1).
    "dp2_tp4_runner": ("fused_vit_layer", "fused_ln_mlp", "flash_attention",
                       "paged_decode_attention_seq", "qmatvec_int8"),
    "tp4_runner_chunk1": ("fused_vit_layer", "fused_ln_mlp", "flash_attention",
                          "paged_decode_attention_seq", "qmatvec_int8"),
    # One off-line breakpoint in bf16 at full depth under a torch.profiler trace.
    "traced_bf16": PREFILL + ("paged_decode_attention_seq",),
}
SOURCES = {
    "fused_vit_layer": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                        "streamchat_tpu/ops/fused_vit.py:358"),
    "fused_ln_mlp": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                     "streamchat_tpu/ops/fused_vit.py:159"),
    "flash_attention": ("streamchat_tpu_torch/csrc/flash_prefill.cu",
                        "streamchat_tpu/ops/attention.py:173"),
    "paged_decode_attention_seq": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                   "streamchat_tpu/ops/paged_attention.py:382"),
    "qmatvec_int8": ("streamchat_tpu_torch/csrc/w8a16_gemv.cu",
                     "streamchat_tpu/ops/quant.py:203"),
    "qmatvec_int4": ("streamchat_tpu_torch/csrc/int4_gemv.cu",
                     "streamchat_tpu/ops/int4_matmul.py:145"),
    "qmatvec_int4_fused": ("streamchat_tpu_torch/csrc/int4_gemv.cu",
                           "streamchat_tpu/ops/int4_matmul.py:203"),
    "paged_decode_attention_seq_int8": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                        "streamchat_tpu/ops/paged_attention.py:423"),
    "flash_attention_partial": ("streamchat_tpu_torch/csrc/flash_prefill.cu",
                                "streamchat_tpu/ops/attention.py:470"),
    "paged_seq_attention_partial": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                    "streamchat_tpu/ops/paged_attention.py:454"),
    "paged_seq_attention_partial_int8": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                         "streamchat_tpu/ops/paged_attention.py:485"),
    "paged_decode_attention_table": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                     "streamchat_tpu/ops/paged_attention.py:135"),
    "paged_decode_attention_table_int8": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                          "streamchat_tpu/ops/paged_attention.py:698"),
    "select_changed_frames": ("streamchat_tpu_torch/csrc/dedup.cu",
                              "streamchat_tpu/ops/dedup.py:39"),
    "fused_ln_attn": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                      "streamchat_tpu/ops/fused_vit.py:442"),
    "vit_attention": ("streamchat_tpu_torch/csrc/flash_prefill.cu",
                      "streamchat_tpu/ops/vit_attention.py:67"),
    "matvec": ("streamchat_tpu_torch/csrc/int4_probe.cu", "scripts/probe_int4_kernel.py:101"),
    "probe_layer": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                    "scripts/probe_vit_variants.py:142"),
    "dotk": ("streamchat_tpu_torch/csrc/dotk.cu", "scripts/probe_vit_variants.py:259"),
    # The decode step's glue: no Pallas source (XLA fuses it into the step).
    "add_rmsnorm": ("streamchat_tpu_torch/csrc/decode_glue.cu",
                    "none: XLA's fusion in streamchat_tpu/models/paged_kv.py:262"),
    "bias_rope_append": ("streamchat_tpu_torch/csrc/decode_glue.cu",
                         "none: XLA's fusion in streamchat_tpu/models/paged_kv.py:262"),
    "silu_mul": ("streamchat_tpu_torch/csrc/decode_glue.cu",
                 "none: XLA's fusion in streamchat_tpu/models/paged_kv.py:262"),
}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _time_ms(fn, iters: int) -> float:
    """Wall time per call of back-to-back calls (CUDA events): for a kernel
    shorter than its wrapper's host work this is the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timings(kernel, plain, iters, plain_iters):
    """-> ms / plain_ms (device time per call) and wall_ms / plain_wall_ms."""
    return dict(ms=device_ms(kernel, iters), plain_ms=device_ms(plain, plain_iters),
                wall_ms=_time_ms(kernel, iters), plain_wall_ms=_time_ms(plain, plain_iters))


def _rotating(fn, arg_sets):
    """A call of fn on the next argument set in turn (distinct layers'
    weights, so one call's bytes are not in L2 from the call before)."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def _gbs(nbytes, ms):
    return nbytes / (ms * 1e-3) / 1e9


def _bound(flops, nbytes, peak=PEAK_FLOPS):
    """The least time the card could take: the larger of the FLOPs at the
    peak of their type (the bf16 tensor cores unless `peak` says otherwise)
    and the bytes (each input read once, each output written once) at the
    memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _causal_pairs(sq, q_off, kv_len):
    """(query, key) pairs a causal pass computes: row r sees min(q_off + r + 1,
    kv_len) keys."""
    return sum(min(q_off + r + 1, kv_len) for r in range(sq))


def _sdpa(q, k, v, **kw):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


def _errors(got, ref, row_rel):
    """-> (max abs error, max per-row relative L2 error or None, within
    tolerance). Rows are the last dim; a zero reference row counts its
    error against 1e-6."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and not bool((err > ATOL + RTOL * ref.abs()).any())
    rel = None
    if row_rel:
        d = ref.shape[-1]
        rel = ((got - ref).reshape(-1, d).norm(dim=-1)
               / ref.reshape(-1, d).norm(dim=-1).clamp_min(1e-6)).max().item()
        ok = ok and rel <= ROW_REL_L2
    return err.max().item(), rel, ok


def _compare(name, got, ref, row_rel=False):
    abs_err, rel, ok = _errors(got, ref, row_rel)
    if not ok:
        raise AssertionError(f"{name}: max abs err {abs_err}, max row relative L2 "
                             f"err {rel}: past atol {ATOL} + rtol {RTOL} * |plain|"
                             + (f" or row relative L2 {ROW_REL_L2}" if row_rel else ""))
    return abs_err, rel


def _planted(name, got, ref):
    """A deliberately wrong kernel output must fail the row-L2 kernel check."""
    abs_err, rel, ok = _errors(got, ref, row_rel=True)
    if ok:
        raise AssertionError(f"planted fault '{name}' passed the check (max abs "
                             f"err {abs_err}, max row relative L2 err {rel})")
    return rel


def _garbage_tail(k, v, valid, seq_dim):
    """Keys and values at and past `valid` along `seq_dim` set to large
    values: a kernel that reads past the valid length shows it."""
    k.narrow(seq_dim, valid, k.shape[seq_dim] - valid).fill_(8.0)
    v.narrow(seq_dim, valid, v.shape[seq_dim] - valid).fill_(100.0)


def _pool_tail(kp, vp, length, k_val, v_val):
    """K and V of a one-row pool [pages, Hkv, page_size, D] set to k_val /
    v_val at and past `length` (the last valid page is partly filled)."""
    ps = kp.shape[2]
    for t, val in ((kp, k_val), (vp, v_val)):
        t[length // ps, :, length % ps:] = val
        t[length // ps + 1:] = val


def _v_unzeroed(q, kp, vp, length):
    """(acc, m, l) of q [1, Hq, T, D] against a one-row pool with its keys
    at and past `length` masked but V's rows there left as they are, as a
    kernel that skipped the zeroing of its boundary tile would compute:
    P V then meets 0 * NaN wherever NaN sits there."""
    _, hq, t, d = q.shape
    hkv = kp.shape[1]
    k = kp.transpose(0, 1).reshape(hkv, -1, d).float()
    v = vp.transpose(0, 1).reshape(hkv, -1, d).float()
    s = torch.einsum("hrd,hld->hrl", q.reshape(hkv, -1, d).float(), k) * d ** -0.5
    s[..., length:] = float("-inf")
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("hrl,hld->hrd", p, v)
    return (acc.reshape(1, hq, t, d), m.clamp_min(-1e30).reshape(1, hq, t),
            p.sum(-1).reshape(1, hq, t))


def _int8_pool(g, pages, hkv, length):
    """A one-row int8 pool [pages, Hkv, 128, 128] with f32 scales -> (k, v,
    k_scale, v_scale): random int8 values everywhere, scales NaN (k) and inf
    (v) at and past `length`, as stale slots may hold."""
    kp, vp = (torch.randint(-127, 128, (pages, hkv, 128, 128), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(pages, hkv, 128, generator=g, device="cuda") * 0.04 + 0.01
              for _ in range(2))
    for t, bad in ((ks, float("nan")), (vs, float("inf"))):
        t[length // 128, :, length % 128:] = bad
        t[length // 128 + 1:] = bad
    return kp, vp, ks, vs


# Faults of an int8-page kernel, emulated by `_int8_faulty`.
_INT8_FAULTS = {"v_scale": "V past the length not zeroed, its inf scale multiplied",
                "k_scale": "k_scale applied after the mask"}


def _int8_faulty(q, kp, vp, ks, vs, length, fault):
    """(acc, m, l) of q [1, Hq, T, D] against a one-row int8 pool as a kernel
    with `fault` would compute them: "v_scale" multiplies p (0 past the
    length) by V's values and scales there (inf) instead of selecting 0;
    "k_scale" masks the keys before it scales them (-inf times a NaN
    scale)."""
    _, hq, t, d = q.shape
    hkv = kp.shape[1]
    k, v = (x.transpose(0, 1).reshape(hkv, -1, d).float() for x in (kp, vp))
    ksc, vsc = (x.transpose(0, 1).reshape(hkv, -1) for x in (ks, vs))
    s = torch.einsum("hrd,hld->hrl", q.reshape(hkv, -1, d).float(), k) * d ** -0.5
    if fault == "k_scale":
        s[..., length:] = float("-inf")
        s = s * ksc[:, None, :]
    else:
        s = s * ksc[:, None, :]
        s[..., length:] = float("-inf")
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    v = v * vsc[..., None]
    if fault != "v_scale":
        v[:, length:] = 0.0
    acc = torch.einsum("hrl,hld->hrd", p, v)
    return (acc.reshape(1, hq, t, d), m.clamp_min(-1e30).reshape(1, hq, t),
            p.sum(-1).reshape(1, hq, t))


def _second_tile_dropped(res, g, t):
    """(acc, m, l) of [1, Hq, T] queries with the folded rows of each kv head
    past the first 64-row tile (row g_i * T + t_i) left as a block with no
    key writes them (acc 0, m -1e30, l 0): a kernel that served one tile."""
    acc, m, l = (x.clone() for x in res)
    hq = acc.shape[1]
    fold = (torch.arange(hq, device=acc.device) % g)[:, None] * t + torch.arange(
        t, device=acc.device)[None]
    past = fold >= 64                                               # [Hq, T]
    acc[0][past], m[0][past], l[0][past] = 0.0, -1e30, 0.0
    return acc, m, l


def prefill_attributes(partial: bool, d: int = 128, softmax: int = SOFTMAX["exact"]) -> dict:
    """The compiled attention kernel's registers per thread, local (spill)
    bytes per thread and shared bytes (cudaFuncGetAttributes): K3 / K5, or
    the ViT's attention in softmax mode `softmax` (partial False)."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    out = (ctypes.c_int * 4)()
    err = library().sc_flash_prefill_attributes(d, int(partial), softmax, out)
    if err:
        raise RuntimeError(f"sc_flash_prefill_attributes: CUDA error {err}")
    return dict(num_regs=out[0], local_bytes=out[1], static_shared_bytes=out[2],
                dynamic_shared_bytes=out[3])


def _gemm_attributes(bn: int, m: int = 0, n: int = 128) -> dict:
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    out = (ctypes.c_int * 5)()
    err = library().sc_gemm_attributes(bn, m, n, out)
    if err:
        raise RuntimeError(f"sc_gemm_attributes: CUDA error {err}")
    return dict(num_regs=out[0], local_bytes=out[1], static_shared_bytes=out[2],
                dynamic_shared_bytes=out[3], tile_n=out[4])


def gemm_tile(m: int, n: int) -> int:
    """The tile width the GEMM picks for an [m, n] output (128 or 256)."""
    return _gemm_attributes(128, m, n)["tile_n"]


def gemm_attributes() -> dict:
    """The compiled GEMM kernel's registers per thread, local (spill) bytes
    per thread and shared bytes at each tile width (sc_gemm_attributes)."""
    return {f"bn{bn}": {k: v for k, v in _gemm_attributes(bn).items() if k != "tile_n"}
            for bn in (128, 256)}


def check_kernels(model, g):
    """K1-K4 against their plain twins at main-path shapes -> report rows."""
    from streamchat_tpu_torch.ops import attention, fused_vit, paged_attention

    bf, dev = torch.bfloat16, "cuda"
    rows = {}

    # K1: one ViT-L layer over an ingest batch of 16 frames, in the
    # ingest's form (folded, one-pass LN, clamp softmax: timed), the exact
    # unfolded form, folded + exact, and with the erf-GELU activation.
    p = model.vit_params["layers"][0]
    heads = model.vit_cfg.num_heads
    args = [p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
            p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
            p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], p["mlp"]["fc2"]["w"],
            p["mlp"]["fc2"]["b"]]
    fargs = list(args)
    fargs[2], fargs[3], fargs[8], fargs[9] = fused_vit.fold_vit_layer_params(
        *(args[i] for i in (0, 1, 2, 3, 6, 7, 8, 9)), num_heads=heads)
    x = torch.randn(16, 577, 1024, generator=g, device=dev).to(bf)
    cases, errs, planted = {}, [], {}
    for label, a, kw in (
            ("ingest: clamp, folded, one-pass", fargs,
             dict(folded=True, ln_onepass=True)),
            ("exact, unfolded", args, dict(softmax_mode="exact")),
            ("exact, folded", fargs, dict(softmax_mode="exact", folded=True)),
            ("clamp, unfolded, erf-GELU", args, dict(activation="gelu"))):
        kw = dict(num_heads=heads, frame_tile=4, **kw)
        k1 = lambda a=a, kw=kw: fused_vit.fused_vit_layer(x, *a, **kw)  # noqa: E731
        e = _compare(f"K1 fused_vit_layer {label}", k1(),
                     fused_vit.fused_vit_layer_plain(x, *a, **kw))[0]
        errs.append(e)
        cases[label] = dict(max_abs_err=e, ms=device_ms(k1, 20))
        if label.startswith("ingest"):
            timed = _timings(k1, lambda a=a, kw=kw: fused_vit.fused_vit_layer_plain(x, *a, **kw),
                             20, 5)
            launches = device_launches(k1, 20)
    del fargs
    n, dm, ff, dh = 16 * 577, 1024, 4096, 1024 // heads
    if len(launches) != len(K1_LAUNCHES):
        raise AssertionError(f"K1: {len(launches)} device launches per call, expected "
                             f"{len(K1_LAUNCHES)}: {[name for name, _ in launches]}")
    launch_ms = {label: ms for label, (_, ms) in zip(K1_LAUNCHES, launches)}

    # K1's four products through the GEMM on its own, at K1's shapes and
    # epilogues, against the twin; two planted faults (the last 64-deep
    # k-slab skipped, the residual dropped); and the four torch.matmul calls
    # at the same shapes, timed and never used.
    h = torch.randn(n, dm, generator=g, device=dev).to(bf)
    mid = (torch.randn(n, ff, generator=g, device=dev) * 0.5).to(bf)
    products = {
        "QKV GEMM": (h, args[2], args[3], None, "none", bf),
        "O GEMM + residual": (h, args[4], args[5], x.reshape(n, dm), "none", torch.float32),
        "fc1 GEMM + activation": (h, args[8], args[9], None, "quick_gelu", bf),
        "fc2 GEMM + residual": (mid, args[10], args[11],
                                torch.randn(n, dm, generator=g, device=dev), "none", bf),
    }
    gemm_cases, gemm_flops = {}, 0
    for label, (a, w, b, r, act, odt) in products.items():
        kw = dict(activation=act, out_dtype=odt)
        ref = fused_vit.gemm_plain(a, w, b, r, **kw)
        e, rel = _compare(f"K1 {label} (fused_vit.gemm)", fused_vit.gemm(a, w, b, r, **kw), ref,
                          row_rel=True)
        errs.append(e)
        gemm_flops += 2 * n * w.shape[0] * w.shape[1]
        gemm_cases[label] = dict(max_abs_err=e, max_row_rel_l2=rel,
                                 tile_n=gemm_tile(n, w.shape[1]), ms=launch_ms[label])
        if label == "fc2 GEMM + residual":
            planted["K1 GEMM last k-slab skipped (fc2, K 4096)"] = _planted(
                "K1 GEMM last k-slab skipped", fused_vit.gemm(a[:, :-64], w[:-64], b, r, **kw),
                ref)
        if label == "O GEMM + residual":
            planted["K1 GEMM residual dropped (O)"] = _planted(
                "K1 GEMM residual dropped", fused_vit.gemm(a, w, b, None, **kw), ref)
        del ref
    gemm_ms = sum(launch_ms[label] for label in K1_GEMMS)
    gemm_library_ms = device_ms(lambda: [torch.matmul(a, w) for a, w, *_ in products.values()],
                                20)
    del h, mid, products
    qa, ka, va = (torch.randn(16, heads, 577, dh, generator=g, device=dev).to(bf)
                  for _ in range(3))
    bound = _bound(2 * n * (4 * dm * dm + 2 * dm * ff) + 4 * 16 * heads * 577 * 577 * dh,
                   _nbytes(*args) + 2 * _nbytes(x))
    attention_library_ms = device_ms(lambda: _sdpa(qa, ka, va), 20)
    rows["fused_vit_layer"] = dict(
        shapes="x [16, 577, 1024] bf16, ViT-L layer; timed: the ingest's form (clamp, "
               "folded, one-pass)",
        max_abs_err=max(errs), cases=cases, **timed, **bound,
        share_of_bound=bound["bound_ms"] / timed["ms"],
        library_ms=None, library="none for the whole layer; attention_library_ms: "
        "SDPA of its attention alone, q/k/v [16, 16, 577, 64]; gemm_library_ms: its four "
        "products as four torch.matmul calls",
        launch_ms=launch_ms, launch_kernels=[name for name, _ in launches],
        gemm_ms=gemm_ms, gemm_tflops=gemm_flops / (gemm_ms * 1e-3) / 1e12,
        gemm_bound_ms=1e3 * gemm_flops / PEAK_FLOPS, gemm_library_ms=gemm_library_ms,
        gemm_cases=gemm_cases, attention_ms=launch_ms["attention"],
        attention_bound_ms=_bound(4 * 16 * heads * 577 * 577 * dh, 4 * _nbytes(qa))["bound_ms"],
        attention_library_ms=attention_library_ms,
        attributes=dict(gemm=gemm_attributes(),
                        attention=prefill_attributes(False, dh, SOFTMAX["clamp"])))
    del qa, ka, va

    # K2: the projector over 16 frames of patch features.
    pp = model.proj_params
    f = torch.randn(16 * 576, 1024, generator=g, device=dev).to(bf)
    kw = dict(activation="gelu", layernorm=False, residual=False)
    k2 = lambda: fused_vit.fused_ln_mlp(  # noqa: E731
        f, None, None, pp["fc1"]["w"], pp["fc1"]["b"], pp["fc2"]["w"], pp["fc2"]["b"], **kw)
    p2 = lambda: fused_vit.fused_ln_mlp_plain(  # noqa: E731
        f, None, None, pp["fc1"]["w"], pp["fc1"]["b"], pp["fc2"]["w"], pp["fc2"]["b"], **kw)
    rows["fused_ln_mlp"] = dict(
        shapes="x [9216, 1024] bf16 -> 3584 -> 3584, erf-GELU",
        max_abs_err=_compare("K2 fused_ln_mlp", k2(), p2())[0],
        **_timings(k2, p2, 20, 5),
        **_bound(2 * 9216 * (1024 * 3584 + 3584 * 3584),
                 _nbytes(f, pp["fc1"]["w"], pp["fc1"]["b"], pp["fc2"]["w"], pp["fc2"]["b"])
                 + 9216 * 3584 * 2),
        library_ms=None, library="none (two GEMMs and a GELU are three calls)",
        attributes=dict(gemm=gemm_attributes(), tile_n=gemm_tile(9216, 3584)))
    rows["fused_ln_mlp"]["share_of_bound"] = (rows["fused_ln_mlp"]["bound_ms"]
                                              / rows["fused_ln_mlp"]["ms"])

    # K3: causal GQA prefill, 28 query heads over 4 kv heads, dh 128, at
    # S = 4096 (chunk 0 of every chunked prefill) and at the chunk-40
    # caption bucket S = 23168 with a ragged kv_length. The plain twin runs
    # one head at a time so S^2 scores fit. Every row is compared, those
    # past kv_length included.
    hq, hkv = model.dec_cfg.num_heads, model.dec_cfg.num_kv_heads
    grp = hq // hkv
    errs, rels, times, bounds, library = [], [], {}, {}, {}
    for s, valid in ((4096, None), (23168, 23105)):
        q = torch.randn(1, hq, s, 128, generator=g, device=dev).to(bf)
        k = torch.randn(1, hkv, s, 128, generator=g, device=dev).to(bf)
        v = torch.randn(1, hkv, s, 128, generator=g, device=dev).to(bf)
        kl = None
        if valid is not None:
            kl = torch.tensor([valid], dtype=torch.int32, device=dev)
            _garbage_tail(k, v, valid, seq_dim=2)
        out = attention.flash_attention(q, k, v, kl, causal=True)

        def plain_heads(q=q, k=k, v=v, kl=kl):
            return [attention.flash_attention_plain(
                q[:, h:h + 1], k[:, h // grp:h // grp + 1], v[:, h // grp:h // grp + 1],
                kl, causal=True) for h in range(hq)]

        ref = torch.cat(plain_heads(), dim=1)
        err, rel = _compare(f"K3 flash_attention S={s}", out, ref, row_rel=True)
        errs.append(err)
        rels.append(rel)
        if valid is not None:
            planted["K3 kv_length ignored"] = _planted(
                "K3 kv_length ignored", attention.flash_attention(q, k, v, None, causal=True),
                ref)
            k0, v0 = k.clone(), v.clone()
            k0[:, :, 8192:8256] = 0
            v0[:, :, 8192:8256] = 0
            planted["K3 key tile 8192:8256 zeroed"] = _planted(
                "K3 key tile zeroed", attention.flash_attention(q, k0, v0, kl, causal=True),
                ref)
            del k0, v0
        del ref
        times[s] = _timings(lambda: attention.flash_attention(q, k, v, kl, causal=True),
                            plain_heads, 5, 1)
        bounds[s] = _bound(4 * 128 * hq * _causal_pairs(s, 0, valid or s), 2 * _nbytes(q, k))
        # SDPA's is_causal masks keys past kv_length for every row but the
        # 63 padding rows at and past it.
        library[s] = device_ms(lambda: _sdpa(q, k, v, is_causal=True, enable_gqa=True), 5)
    # A causal S = 300 case (two query tiles, the second crossing the
    # diagonal mid-tile) run non-causal must fail: the boundary tiles mask.
    qc, kc, vc = (torch.randn(1, h_, 300, 128, generator=g, device=dev).to(bf)
                  for h_ in (hq, hkv, hkv))
    ref = attention.flash_attention_plain(qc, kc, vc, None, causal=True)
    err, rel = _compare("K3 flash_attention S=300", attention.flash_attention(qc, kc, vc),
                        ref, row_rel=True)
    errs.append(err)
    rels.append(rel)
    planted["K3 run non-causal (S=300)"] = _planted(
        "K3 run non-causal", attention.flash_attention(qc, kc, vc, None, causal=False), ref)
    del qc, kc, vc, ref
    rows["flash_attention"] = dict(
        shapes="q [1, 28, S, 128], k/v [1, 4, S, 128] bf16 causal; S=23168 "
               "with kv_length 23105 (timed), S=4096 (own bound and library call) and S=300",
        max_abs_err=max(errs), max_row_rel_l2=max(rels), **times[23168], **bounds[23168],
        share_of_bound=bounds[23168]["bound_ms"] / times[23168]["ms"],
        library_ms=library[23168],
        library="F.scaled_dot_product_attention(is_causal, enable_gqa) on the same q/k/v",
        ms_s4096=times[4096]["ms"], plain_ms_s4096=times[4096]["plain_ms"],
        bound_ms_s4096=bounds[4096]["bound_ms"], library_ms_s4096=library[4096],
        share_of_bound_s4096=bounds[4096]["bound_ms"] / times[4096]["ms"],
        attributes=prefill_attributes(partial=False))

    # K4: one decode token against a 23,105-token context (one layer's pool
    # of 182 pages; the last valid page is partly filled), timed over four
    # pools in turn so that one call's 47.7 MB are not in L2 (50 MB) from
    # the call before, as in a decode step over 28 layers; the check and the
    # planted faults on the first pool.
    pages, length, ps = -(-(23168 + 128) // 128), 23105, 128
    q = torch.randn(1, hq, 1, 128, generator=g, device=dev).to(bf)
    pools = []
    for _ in range(4):
        kp = torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
        vp = torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
        _pool_tail(kp, vp, length, 8.0, 100.0)
        pools.append((kp, vp))
    kp, vp = pools[0]
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    k4, p4 = (paged_attention.paged_decode_attention_seq,
              paged_attention.paged_decode_attention_seq_plain)
    ref = p4(q, kp, vp, ln)
    err, rel = _compare("K4 paged_decode_attention_seq", k4(q, kp, vp, ln), ref, row_rel=True)
    planted["K4 length + 128"] = _planted("K4 length + 128", k4(q, kp, vp, ln + 128), ref)
    k0, v0 = kp.clone(), vp.clone()
    k0[80:84] = 0
    v0[80:84] = 0
    planted["K4 pages 80:84 zeroed"] = _planted("K4 4-page chunk zeroed", k4(q, k0, v0, ln), ref)
    # The last page of the split range that holds page 80 dropped: the
    # kernel's output over the pool without that page (all of whose keys are
    # live).
    drop = next(end for _, _, first, end, _, _ in paged_attention.paged_blocks(1, hkv, pages)
                if first <= 80 < end) - 1
    keep = torch.arange(pages, device=dev) != drop
    planted["K4 last page of a split range dropped"] = _planted(
        "K4 last page of a split range dropped", k4(q, kp[keep], vp[keep], ln - ps), ref)
    # NaN in K and V at and past the length: the kernel masks the keys and
    # zeroes V's rows there before P V; without the zeroing, 0 * NaN reaches
    # every row.
    k0.copy_(kp)
    v0.copy_(vp)
    _pool_tail(k0, v0, length, float("nan"), float("nan"))
    err_n, rel_n = _compare("K4 NaN past the length", k4(q, k0, v0, ln), ref, row_rel=True)
    acc, _, l = _v_unzeroed(q, k0, v0, length)
    planted["K4 V past the length not zeroed (NaN there)"] = _planted(
        "K4 V past the length not zeroed", (acc / l[..., None]).to(bf), ref)
    del k0, v0, keep, acc, l
    args = [(q, *pool, ln) for pool in pools]
    t = _timings(_rotating(k4, args), _rotating(p4, args), 50, 10)
    nbytes = length * hkv * 128 * 2 * 2
    rows["paged_decode_attention_seq"] = dict(
        shapes="q [1, 28, 1, 128], pages [182, 4, 128, 128] bf16, length 23105 (4 pools in "
               "turn); B = 2: pages [364, 4, 128, 128], lengths 23105 and 22000",
        max_abs_err=max(err, err_n), max_row_rel_l2=max(rel, rel_n), **t,
        **_bound(4 * hq * length * 128, nbytes + 2 * _nbytes(q)),
        gbs=_gbs(nbytes, t["ms"]), plain_gbs=_gbs(nbytes, t["plain_ms"]),
        host_us=host_us(_rotating(k4, args), 100),
        blocks=paged_attention.paged_split(1, hkv, pages, hq // hkv),
        launch_ms=[ms for _, ms in device_launches(_rotating(k4, args), 50)],
        attributes=paged_attention.attributes(128),
        library_ms=None, library="none (no PyTorch call reads a page pool)")
    rows["paged_decode_attention_seq"]["share_of_bound"] = (
        rows["paged_decode_attention_seq"]["bound_ms"] / t["ms"])
    rows["paged_decode_attention_seq"]["ms_length_1444"] = device_ms(
        _rotating(k4, [(q, *pool, torch.full_like(ln, 1444)) for pool in pools]), 50)
    del pools, args
    # B = 2 on a partitioned pool of twice the pages (the caption_batch 2
    # decode), four pools in turn.
    lengths = (length, 22000)
    q2 = torch.randn(2, hq, 1, 128, generator=g, device=dev).to(bf)
    ln2 = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = []
    for _ in range(4):
        kp = torch.randn(2 * pages, hkv, ps, 128, generator=g, device=dev).to(bf)
        vp = torch.randn(2 * pages, hkv, ps, 128, generator=g, device=dev).to(bf)
        for r, n in enumerate(lengths):
            _pool_tail(kp[r * pages:(r + 1) * pages], vp[r * pages:(r + 1) * pages], n,
                       8.0, 100.0)
        args.append((q2, kp, vp, ln2))
    err2, rel2 = _compare("K4 B = 2", k4(*args[0]), p4(*args[0]), row_rel=True)
    t2 = _timings(_rotating(k4, args), _rotating(p4, args), 50, 5)
    nbytes2 = sum(lengths) * hkv * 128 * 2 * 2
    row = rows["paged_decode_attention_seq"]
    row.update(max_abs_err=max(row["max_abs_err"], err2),
               max_row_rel_l2=max(row["max_row_rel_l2"], rel2),
               b2_ms=t2["ms"], b2_plain_ms=t2["plain_ms"], b2_wall_ms=t2["wall_ms"],
               b2_bound_ms=_bound(4 * hq * sum(lengths) * 128,
                                  nbytes2 + 2 * _nbytes(q2))["bound_ms"],
               b2_blocks=paged_attention.paged_split(2, hkv, pages, hq // hkv))
    del args
    return rows, planted


# The keys a GEMV row takes from its timed case.
_GATE_KEYS = ("ms", "plain_ms", "wall_ms", "plain_wall_ms", "gbs", "bound_ms", "bound_by",
              "flops", "bytes", "library_ms")


def _int8_bytes(q):
    return q["w_i8"].numel() + 4 * q["scale"].numel()


def _int4_bytes(q):
    return q["w_i4p"].numel() + 4 * q["scale"].numel()


def _swap_nibbles(p):
    b = p.to(torch.int32) & 0xFF
    b = ((b & 0xF) << 4) | (b >> 4)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def _layer_weight(p, name):
    """A decoder layer's bf16 weight of projection `name`."""
    return p["attn"][name]["w"] if name in ("q", "k", "v", "o") else p["mlp"][name]


def _int4_case(kernel, label, n, qs, g):
    """K10 (`qmatvec_int4`) or K11 (`qmatvec_int4_fused`) at one path
    shape: qs holds each layer's quantized parts. The first layer's call is
    held to the plain twin; calls over the layers in turn are timed (cold
    weights) beside the twin and one torch.matmul on the dequantized bf16
    weight -> (report case, planted faults: for K10 nibble halves swapped
    and one group's scale ignored (n = 1); the last warp's group range of
    the last block, one cluster rank's whole range, and for K11 at q/k/v the
    k part's last column tile, each zeroed in the weight: n = 1)."""
    from streamchat_tpu_torch.ops import int4_matmul, quant

    bf = torch.bfloat16
    kin = qs[0][0]["w_i4p"].shape[0]
    widths = tuple(q["w_i4p"].shape[1] for q in qs[0])
    x = torch.randn(n, kin, generator=g, device="cuda").to(bf)
    fused = kernel == "qmatvec_int4_fused"
    k_fn, p_fn = ((int4_matmul.qmatvec_int4_fused, int4_matmul.qmatvec_int4_fused_plain)
                  if fused else (int4_matmul.qmatvec_int4, int4_matmul.qmatvec_int4_plain))

    def run(fn, parts):
        flat = [t for q in parts for t in (q["w_i4p"], q["scale"])]
        out = fn(x, *flat, out_dtype=bf)
        return torch.cat(out, 1) if fused else out

    name = f"{'K11' if fused else 'K10'} {label} n{n}"
    ref = run(p_fn, qs[0])
    err, rel = _compare(name, run(k_fn, qs[0]), ref, row_rel=True)
    faults = {}

    def plant(fault, parts):
        faults[f"{name}: {fault}"] = _planted(f"{name}: {fault}", run(k_fn, parts), ref)

    plan = int4_matmul.launch_plan(n, kin, widths)
    blocks = int4_matmul.plan_blocks(n, kin, widths)
    if n == 1:
        def zeroed(part, cols, groups):
            parts = [dict(q) for q in qs[0]]
            w = parts[part]["w_i4p"].clone()
            w[groups[0] * 128:groups[1] * 128, cols[0]:cols[1]] = 0
            parts[part]["w_i4p"] = w
            return parts

        part, (c0, c1), _, warps = blocks[-1]
        h0, h1 = warps[-1]
        plant(f"the last block's last warp range (groups {h0}:{h1}, packed columns "
              f"{c0}:{c1}) dropped", zeroed(part, (c0, c1), (h0, h1)))
        rank = min(3, plan.cluster - 1)
        part, cols, groups, _ = blocks[rank]
        plant(f"cluster rank {rank} of the first tile (groups {groups[0]}:{groups[1]}) "
              "skipped", zeroed(part, cols, groups))
        if label == "qkv":
            _, cols, _, _ = [b for b in blocks if b[0] == 1][-1]
            plant(f"the k part's last column tile ({cols[0]}:{cols[1]}) dropped",
                  zeroed(1, cols, (0, plan.groups)))
        if not fused:
            swapped = [dict(qs[0][0], w_i4p=_swap_nibbles(qs[0][0]["w_i4p"]))]
            plant("nibble halves swapped", swapped)
            one = qs[0][0]["scale"].clone()
            one[5] = 1.0
            plant("group 5's scale ignored", [dict(qs[0][0], scale=one)])
    t = _timings(_rotating(lambda *p: run(k_fn, p), qs), _rotating(lambda *p: run(p_fn, p), qs),
                 40, 5)
    deq = [torch.cat([quant.dequantize_weight_int4(q, bf) for q in parts], 1)
           for parts in qs[:3]]
    library_ms = device_ms(_rotating(lambda w: torch.matmul(x, w), [(w,) for w in deq]), 40)
    del deq
    nbytes = sum(_int4_bytes(q) for q in qs[0])
    kout = 2 * sum(widths)
    case = dict(shape=[kin, kout], n=n, max_abs_err=err, max_row_rel_l2=rel, **t,
                gbs=_gbs(nbytes, t["ms"]), plain_gbs=_gbs(nbytes, t["plain_ms"]),
                **_bound(2 * n * kin * kout, nbytes + _nbytes(x) + 2 * n * kout),
                library_ms=library_ms,
                host_us=host_us(_rotating(lambda *p: run(k_fn, p), qs), 100),
                blocks=dict(blocks=plan.blocks, cluster=plan.cluster, wave=plan.wave),
                attributes=int4_matmul.attributes(all(w % 16 == 0 for w in widths)))
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    return case, faults


def check_quant_kernels(model, g):
    """W8, K10, K11 and K6 against their plain twins at main-path shapes ->
    (report rows, planted faults). Weights are the model's, quantized."""
    from streamchat_tpu_torch.ops import paged_attention, quant

    bf, dev = torch.bfloat16, "cuda"
    layers = model.dec_params["layers"]
    rows, planted = {}, {}

    def x_for(kin):
        return torch.randn(1, kin, generator=g, device=dev).to(bf)

    # W8: gate [3584, 18944], down [18944, 3584] (bf16 out), lm_head
    # [3584, 152064] (f32 out). Timed over 4 layers' weights in turn.
    cases = {}
    for label, ws, out_dtype in (
            ("gate", [p["mlp"]["gate"] for p in layers[:4]], bf),
            ("down", [p["mlp"]["down"] for p in layers[:4]], bf),
            ("lm_head", [model.dec_params["lm_head"]], torch.float32)):
        qs = [quant.quantize_weight(w) for w in ws]
        q0, x = qs[0], x_for(ws[0].shape[0])
        ref = quant.qmatvec_int8_plain(x, q0["w_i8"], q0["scale"], out_dtype)
        got = quant.qmatvec_int8(x, q0["w_i8"], q0["scale"], out_dtype)
        if got.dtype != out_dtype:
            raise AssertionError(f"W8 {label}: output {got.dtype}, expected {out_dtype}")
        err, rel = _compare(f"W8 qmatvec_int8 {label}", got, ref, row_rel=True)
        bad = q0["w_i8"].clone()
        r0 = bad.shape[0] // 2 // 128 * 128
        bad[r0:r0 + 128] = 0
        name = f"W8 {label} weight rows {r0}:{r0 + 128} zeroed"
        planted[name] = _planted(name, quant.qmatvec_int8(x, bad, q0["scale"], out_dtype), ref)
        del bad
        args = [(x, q["w_i8"], q["scale"], out_dtype) for q in qs]
        t = _timings(_rotating(quant.qmatvec_int8, args),
                     _rotating(quant.qmatvec_int8_plain, args), 40, 10)
        kin, kout = q0["w_i8"].shape
        deq = [(x, quant.dequantize_weight(q, bf)) for q in qs]
        cases[label] = dict(shape=list(q0["w_i8"].shape), max_abs_err=err, max_row_rel_l2=rel,
                            **t, gbs=_gbs(_int8_bytes(q0), t["ms"]),
                            plain_gbs=_gbs(_int8_bytes(q0), t["plain_ms"]),
                            **_bound(2 * kin * kout, _int8_bytes(q0) + _nbytes(x)
                                     + kout * torch.finfo(out_dtype).bits // 8),
                            library_ms=device_ms(_rotating(torch.matmul, deq), 40))
        del qs, args, deq
    rows["qmatvec_int8"] = dict(
        shapes="x [1, in] bf16, w_i8 gate [3584, 18944] / down [18944, 3584] (bf16 out), "
               "lm_head [3584, 152064] (f32 out); ms = gate",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        max_row_rel_l2=max(c["max_row_rel_l2"] for c in cases.values()),
        **{k: cases["gate"][k] for k in _GATE_KEYS}, cases=cases,
        library="torch.matmul(x, W) on the dequantized bf16 weight")

    # K10 at its path's shapes, o (3584 -> 3584, timed over 10 layers: 68 MB
    # past the 50 MB L2) and down (18944 -> 3584, 148 groups; 3 layers), and
    # K11 at q/k/v (3584 -> 3584 + 512 + 512; 8 layers) and gate/up (3584 ->
    # 18944 x 2; 2 layers), each at 1 row (decode) and 5 (a spec-4 verify
    # step), bf16 out as the decoder calls them.
    for kernel, shapes in (("qmatvec_int4", (("o", ("o",), 10), ("down", ("down",), 3))),
                           ("qmatvec_int4_fused", (("qkv", ("q", "k", "v"), 8),
                                                   ("gate_up", ("gate", "up"), 2)))):
        cases = {}
        for label, names, n_layers in shapes:
            qs = [[quant.quantize_weight_int4(_layer_weight(p, name)) for name in names]
                  for p in layers[:n_layers]]
            for n in (1, 5):
                case, faults = _int4_case(kernel, label, n, qs, g)
                cases[f"{label} n{n}"] = case
                planted.update(faults)
            del qs
            torch.cuda.empty_cache()
        head = cases["down n1" if kernel == "qmatvec_int4" else "gate_up n1"]
        rows[kernel] = dict(
            shapes=("x [n, in] bf16, bf16 out, n 1 and 5; " + (
                "packed o [3584, 1792] and down [18944, 1792] (148 groups); ms = down n1"
                if kernel == "qmatvec_int4" else
                "q/k/v (3584 -> 3584, 512, 512) and gate/up (3584 -> 18944 x 2); "
                "ms = gate/up n1")),
            max_abs_err=max(c["max_abs_err"] for c in cases.values()),
            max_row_rel_l2=max(c["max_row_rel_l2"] for c in cases.values()),
            **{k: head[k] for k in _GATE_KEYS + ("share_of_bound", "host_us", "blocks",
                                                "attributes")},
            cases=cases,
            library="torch.matmul(x, W) on the dequantized bf16 weight"
                    + ("" if kernel == "qmatvec_int4" else "s, concatenated"))

    # K6: one decode token over int8 pages, 23,105 valid tokens of 182 pages
    # (4 pools in turn for the timing); past the length, random int8 pages
    # and NaN / inf scales.
    hq, hkv = model.dec_cfg.num_heads, model.dec_cfg.num_kv_heads
    pages, length, ps = -(-(23168 + 128) // 128), 23105, 128
    q = torch.randn(1, hq, 1, 128, generator=g, device=dev).to(bf)
    pools = [_int8_pool(g, pages, hkv, length) for _ in range(4)]
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    kp, vp, ks, vs = pools[0]
    k6, p6 = (paged_attention.paged_decode_attention_seq_int8,
              paged_attention.paged_decode_attention_seq_int8_plain)
    ref = p6(q, kp, vp, ks, vs, ln)
    err, rel = _compare("K6 paged_decode_attention_seq_int8", k6(q, kp, vp, ks, vs, ln), ref,
                        row_rel=True)
    planted["K6 length + 128"] = _planted("K6 length + 128", k6(q, kp, vp, ks, vs, ln + 128), ref)
    k0, v0 = kp.clone(), vp.clone()
    k0[80:84] = 0
    v0[80:84] = 0
    planted["K6 pages 80:84 zeroed"] = _planted("K6 4-page chunk zeroed",
                                                k6(q, k0, v0, ks, vs, ln), ref)
    del k0, v0
    planted["K6 scales replaced by 1"] = _planted(
        "K6 scales replaced by 1", k6(q, kp, vp, torch.ones_like(ks), torch.ones_like(vs), ln),
        ref)
    for fault, label in _INT8_FAULTS.items():
        acc, _, l = _int8_faulty(q, kp, vp, ks, vs, length, fault)
        planted[f"K6 {label}"] = _planted(f"K6 {label}", (acc / l[..., None]).to(bf), ref)
    args = [(q,) + pool + (ln,) for pool in pools]
    t = _timings(_rotating(k6, args), _rotating(p6, args), 50, 10)
    nbytes = length * hkv * 2 * (128 + 4)
    rows["paged_decode_attention_seq_int8"] = dict(
        shapes="q [1, 28, 1, 128] bf16, pages [182, 4, 128, 128] int8, scales "
               "[182, 4, 128] f32, length 23105 (4 pools in turn)",
        max_abs_err=err, max_row_rel_l2=rel, **t,
        gbs=_gbs(nbytes, t["ms"]), plain_gbs=_gbs(nbytes, t["plain_ms"]),
        **_bound(4 * hq * length * 128, nbytes + 2 * _nbytes(q)),
        host_us=host_us(_rotating(k6, args), 100),
        blocks=paged_attention.paged_split(1, hkv, pages, hq // hkv),
        launch_ms=[ms for _, ms in device_launches(_rotating(k6, args), 50)],
        attributes=paged_attention.attributes(128, int8=True),
        library_ms=None, library="none (no PyTorch call reads int8 pages with scales)")
    rows["paged_decode_attention_seq_int8"]["share_of_bound"] = (
        rows["paged_decode_attention_seq_int8"]["bound_ms"] / t["ms"])
    # The same pools at 1,444 tokens (12 pages: 5 of the 66 ranges a head
    # hold keys): the time a block's steps take, beside the bytes'.
    rows["paged_decode_attention_seq_int8"]["ms_length_1444"] = device_ms(
        _rotating(k6, [(q,) + pool + (torch.full_like(ln, 1444),) for pool in pools]), 50)
    return rows, planted


def _partial_errors(got, ref):
    """(acc, m, l) against the twin's -> (max abs err and max row relative L2
    err of acc / l, max abs err of m and of l, within tolerance): acc / l
    (0 where l == 0) under the row bound, m and l elementwise and finite."""
    acc, m, l = got
    racc, rm, rl = ref

    def norm(a, n):
        return a / torch.where(n == 0, torch.ones_like(n), n)[..., None]

    err, rel, ok = _errors(norm(acc, l), norm(racc, rl), row_rel=True)
    m_err, _, m_ok = _errors(m, rm, row_rel=False)
    l_err, _, l_ok = _errors(l, rl, row_rel=False)
    return err, rel, m_err, l_err, ok and m_ok and l_ok


def _compare_partial(name, got, ref):
    err, rel, m_err, l_err, ok = _partial_errors(got, ref)
    if not ok:
        raise AssertionError(f"{name}: acc / l max abs err {err}, max row relative L2 err "
                             f"{rel}, m err {m_err}, l err {l_err}: past atol {ATOL} + rtol "
                             f"{RTOL} * |plain| or row relative L2 {ROW_REL_L2}")
    return err, rel


def _planted_partial(name, got, ref):
    """A deliberately wrong (acc, m, l) must fail the partial check -> the
    largest of its row relative L2 error and its m error."""
    err, rel, m_err, l_err, ok = _partial_errors(got, ref)
    if ok:
        raise AssertionError(f"planted fault '{name}' passed the check (row relative L2 "
                             f"{rel}, m err {m_err}, l err {l_err})")
    return max(rel, m_err)


def check_partial_kernels(model, g):
    """K5, K7 and K7′ against their plain twins at main-path shapes ->
    (report rows, planted faults)."""
    from torch.nn.attention.bias import causal_lower_right

    from streamchat_tpu_torch.ops import attention, paged_attention

    bf, dev = torch.bfloat16, "cuda"
    hq, hkv = model.dec_cfg.num_heads, model.dec_cfg.num_kv_heads
    grp = hq // hkv
    rows, planted = {}, {}

    # K5: the last chunk of a chunk-40 caption prefill (23,552 padded tokens
    # in chunks of 4,096): 3,072 queries at global offset 20,480 against the
    # whole cache view. The twin runs one head at a time.
    sk, off, width = 23552, 20480, 3072
    q = torch.randn(1, hq, width, 128, generator=g, device=dev).to(bf)
    k = torch.randn(1, hkv, sk, 128, generator=g, device=dev).to(bf)
    v = torch.randn(1, hkv, sk, 128, generator=g, device=dev).to(bf)
    kl = torch.tensor([sk], dtype=torch.int32, device=dev)

    def k5(q=q, k=k, v=v, q_off=off, k_off=0):
        return attention.flash_attention_partial(q, k, v, q_off, k_off, kl)

    def p5():
        parts = [attention.flash_attention_partial_plain(
            q[:, h:h + 1], k[:, h // grp:h // grp + 1], v[:, h // grp:h // grp + 1], off, 0, kl)
            for h in range(hq)]
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))

    ref = p5()
    err, rel = _compare_partial("K5 flash_attention_partial", k5(), ref)
    planted["K5 offsets swapped"] = _planted_partial("K5 offsets swapped",
                                                     k5(q_off=0, k_off=off), ref)
    del ref
    # Rows with no visible key (q_offset < k_offset), NaN in V past kv_length.
    qs = torch.randn(1, hq, 512, 128, generator=g, device=dev).to(bf)
    ks = torch.randn(1, hkv, 1024, 128, generator=g, device=dev).to(bf)
    vs = torch.randn(1, hkv, 1024, 128, generator=g, device=dev).to(bf)
    vs[:, :, 900:] = float("nan")
    kls = torch.tensor([900], dtype=torch.int32, device=dev)
    got = attention.flash_attention_partial(qs, ks, vs, 0, 256, kls)
    ref = attention.flash_attention_partial_plain(qs, ks, vs, 0, 256, kls)
    err_m, rel_m = _compare_partial("K5 rows without keys", got, ref)
    if not (ref[2] == 0).any():
        raise AssertionError("K5 masked-rows case has no row without keys")
    acc, m, l = got
    planted["K5 m left unclamped"] = _planted_partial(
        "K5 m left unclamped", (acc, torch.where(m <= -1e30, float("-inf"), m), l), ref)
    planted["K5 q_offset + 37 (rows without keys)"] = _planted_partial(
        "K5 q_offset + 37", attention.flash_attention_partial(qs, ks, vs, 37, 256, kls), ref)
    xk, xv = k.repeat_interleave(grp, 1), v.repeat_interleave(grp, 1)
    bias = causal_lower_right(width, sk)
    rows["flash_attention_partial"] = dict(
        shapes="q [1, 28, 3072, 128], k/v [1, 4, 23552, 128] bf16, q_offset 20480, "
               "k_offset 0, kv_length 23552 (timed); q [1, 28, 512, 128] vs k/v "
               "[1, 4, 1024, 128], k_offset 256, kv_length 900 (rows without keys)",
        max_abs_err=max(err, err_m), max_row_rel_l2=max(rel, rel_m), **_timings(k5, p5, 5, 1),
        **_bound(4 * 128 * hq * _causal_pairs(width, off, sk),
                 _nbytes(q, k, v) + hq * width * (128 + 2) * 4),
        library_ms=device_ms(lambda: _sdpa(q, xk, xv, attn_mask=bias), 5),
        library="F.scaled_dot_product_attention with causal_lower_right (offset 20480) over "
                "K/V expanded to 28 heads beforehand; normalized output",
        attributes=prefill_attributes(partial=True))
    row = rows["flash_attention_partial"]
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del q, k, v, xk, xv, qs, ks, vs

    # K7: five in-flight queries against a 23,105-token pool (182 pages),
    # bf16 and int8 pages, four pools in turn for the timing; then ten (70
    # folded rows a kv head: two row tiles) on the first pool, also timed.
    t, pages, length, ps = SPEC_TOKENS + 1, -(-(23168 + 128) // 128), 23105, 128
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    q = torch.randn(1, hq, t, 128, generator=g, device=dev).to(bf)
    q10 = torch.randn(1, hq, 10, 128, generator=g, device=dev).to(bf)
    # The same queries folded token-major (row t_i * g + g_i) where the
    # kernel folds head-major (row g_i * T + t_i).
    q_tm = q.reshape(1, hkv, grp, t, 128).transpose(2, 3).reshape(1, hq, t, 128)
    for label, int8 in (("paged_seq_attention_partial", False),
                        ("paged_seq_attention_partial_int8", True)):
        pools = []
        for _ in range(4):
            if int8:
                pools.append(_int8_pool(g, pages, hkv, length))
            else:
                kp, vp = (torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
                          for _ in range(2))
                _pool_tail(kp, vp, length, 8.0, 100.0)
                pools.append((kp, vp))
        fn = getattr(paged_attention, label)
        plain = getattr(paged_attention, label + "_plain")
        name = "K7′" if int8 else "K7"
        ref = plain(q, *pools[0], ln)
        err, rel = _compare_partial(f"{name} {label}", fn(q, *pools[0], ln), ref)
        planted[f"{name} row fold transposed"] = _planted_partial(
            f"{name} row fold transposed", fn(q_tm, *pools[0], ln), ref)
        planted[f"{name} pool length counts the block"] = _planted_partial(
            f"{name} pool length counts the block", fn(q, *pools[0], ln + t), ref)
        if int8:
            for fault, text in _INT8_FAULTS.items():
                planted[f"{name} {text}"] = _planted_partial(
                    f"{name} {text}", _int8_faulty(q, *pools[0], length, fault), ref)
        else:
            # NaN in K and V at and past the length: the kernel masks the
            # keys and zeroes V's rows there; without the zeroing, 0 * NaN.
            kn, vn = (x.clone() for x in pools[0])
            _pool_tail(kn, vn, length, float("nan"), float("nan"))
            err_n, rel_n = _compare_partial(f"{name} NaN past the length", fn(q, kn, vn, ln),
                                            ref)
            err, rel = max(err, err_n), max(rel, rel_n)
            planted[f"{name} V past the length not zeroed (NaN there)"] = _planted_partial(
                f"{name} V past the length not zeroed", _v_unzeroed(q, kn, vn, length), ref)
            del kn, vn
        # T 10: 70 rows a kv head, two 64-row tiles.
        ref10 = plain(q10, *pools[0], ln)
        got10 = fn(q10, *pools[0], ln)
        err10, rel10 = _compare_partial(f"{name} T 10 (70 rows)", got10, ref10)
        planted[f"{name} T 10, second row tile dropped"] = _planted_partial(
            f"{name} T 10, second row tile dropped", _second_tile_dropped(got10, grp, 10), ref10)
        args = [(q,) + pool + (ln,) for pool in pools]
        row_bytes = 128 + 4 if int8 else 2 * 128
        kv_bytes = length * hkv * 2 * row_bytes
        rows[label] = dict(
            shapes=f"q [1, 28, {t}, 128] bf16, pages [182, 4, 128, 128] "
                   + ("int8, scales [182, 4, 128] f32" if int8 else "bf16")
                   + ", length 23105 (4 pools in turn); T 10 on the first pool",
            max_abs_err=max(err, err10), max_row_rel_l2=max(rel, rel10),
            **_timings(_rotating(fn, args), _rotating(plain, args), 50, 10),
            **_bound(4 * hq * t * length * 128,
                     kv_bytes + _nbytes(q) + hq * t * (128 + 2) * 4),
            blocks=paged_attention.paged_split(1, hkv, pages, grp * t),
            launch_ms=[ms for _, ms in device_launches(_rotating(fn, args), 50)],
            attributes=paged_attention.attributes(128, int8=int8),
            host_us=host_us(_rotating(fn, args), 100),
            library_ms=None, library="none (no PyTorch call reads a page pool)")
        row = rows[label]
        row["gbs"] = _gbs(kv_bytes, row["ms"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        # T 10 over the four pools in turn; its bound reads each pool once,
        # though both row tiles' blocks read it.
        t10 = device_ms(_rotating(fn, [(q10,) + pool + (ln,) for pool in pools]), 50)
        b10 = _bound(4 * hq * 10 * length * 128,
                     kv_bytes + _nbytes(q10) + hq * 10 * (128 + 2) * 4)["bound_ms"]
        row.update(t10_ms=t10, t10_bound_ms=b10, t10_share_of_bound=b10 / t10,
                   t10_blocks=paged_attention.paged_split(1, hkv, pages, grp * 10))
        del pools, args, ref10, got10
    return rows, planted


def _shared_table(g, lengths, ps, maxp, pages, hole):
    """A shared pool's table: row r's first ceil(length / ps) slots map pool
    pages 1.. in a seeded permutation, -1 past them and at row 0's slot
    `hole` (inside its length) -> (table [B, maxp] int32, mask of the pool
    pages no slot maps, page 0 among them)."""
    perm = 1 + torch.randperm(pages - 1, generator=g, device="cuda").to(torch.int32)
    table = torch.full((len(lengths), maxp), -1, dtype=torch.int32, device="cuda")
    i = 0
    for r, n in enumerate(lengths):
        need = -(-n // ps)
        table[r, :need] = perm[i:i + need]
        i += need
    table[0, hole] = -1
    free = torch.ones(pages, dtype=torch.bool, device="cuda")
    free[table[table >= 0].long()] = False
    return table, free


def _table_v_unzeroed(q, kp, vp, ks, vs, table, length):
    """K8 / K9's output (ks / vs None for K8) with V's rows past each row's
    length in its last 64-key tile left as they are, as a kernel that
    skipped their zeroing would compute: 0 * NaN (0 * inf for an int8 scale)
    reaches the row."""
    from streamchat_tpu_torch.ops import paged_attention as pa

    b, hq, _, d = q.shape
    hkv, ps = kp.shape[1], kp.shape[2]
    valid = pa._table_valid(table, length, ps)[:, None]
    read = pa._table_valid(table, (length + 63) // 64 * 64, ps)[:, None]
    s = torch.einsum("bhgd,bhld->bhgl", q.reshape(b, hkv, hq // hkv, d).float(),
                     pa._table_rows(kp, table).float())
    if ks is not None:
        s = s * pa._table_rows(ks, table)[:, :, None, :]
    s = (s * d ** -0.5).masked_fill(~valid[:, :, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    v = pa._table_rows(vp, table).float()
    if vs is not None:
        v = v * pa._table_rows(vs, table)[..., None]
    o = torch.einsum("bhgl,bhld->bhgd", p, torch.where(read[..., None], v, 0.0))
    return (o / p.sum(-1, keepdim=True)).reshape(b, hq, 1, d).to(q.dtype)


def _caller_pools(g, hkv, int8, lengths, n=4):
    """`n` one-layer pools [98, Hkv, 128, 128] laid out as `generate_paged`
    pages drive_caller_pool's rows (row r: pages [48 r, 48 r + 48)): large
    values past each row's length in its last page (NaN / inf scales on
    int8 pages), NaN (NaN / inf scales) in every later page of the row and
    in pages 96-97, which no slot maps."""
    pools = []
    for _ in range(n):
        if int8:
            pool = tuple(torch.randint(-127, 128, (98, hkv, 128, 128), generator=g,
                                       device="cuda", dtype=torch.int8) for _ in range(2)) + tuple(
                torch.rand(98, hkv, 128, generator=g, device="cuda") * 0.04 + 0.01
                for _ in range(2))
            tails = ((pool[2], float("nan"), float("nan")), (pool[3], float("inf"), float("inf")))
        else:
            pool = tuple(torch.randn(98, hkv, 128, 128, generator=g, device="cuda"
                                     ).to(torch.bfloat16) for _ in range(2))
            tails = ((pool[0], 8.0, float("nan")), (pool[1], 100.0, float("nan")))
        for t, tail, stale in tails:
            for r, length in enumerate(lengths):
                last = 48 * r + length // 128
                t[last, :, length % 128:] = tail
                t[last + 1:48 * r + 48] = stale
            t[96:] = stale
        pools.append(pool)
    return pools


def check_table_kernels(model, g):
    """K8 and K9 against their plain twins -> (report rows, planted faults).
    At the smoke's shape: B = 3 rows of 23,105, 11,905 and 1 tokens in
    128-token pages spread over a 288-page pool by a seeded permutation, -1
    past each row's pages and at one slot inside row 0's length; NaN in the
    pages no slot maps (NaN / inf scales for K9) and large values past each
    row's length in its last page. At the caller pool's shape
    (drive_caller_pool's first decode step, one layer): two rows of 6,100
    and 3,050 tokens on a 98-page pool, 50 slots (`_caller_pools`), timed
    over four pools in turn, and with a hole inside row 1's length (cut to
    300 tokens)."""
    from streamchat_tpu_torch.ops import paged_attention as pa

    bf, dev = torch.bfloat16, "cuda"
    hq, hkv = model.dec_cfg.num_heads, model.dec_cfg.num_kv_heads
    lengths, ps, maxp, pages, hole = (23105, 11905, 1), 128, 184, 288, 50
    table, free = _shared_table(g, lengths, ps, maxp, pages, hole)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(3, hq, 1, 128, generator=g, device=dev).to(bf)
    live = sum(lengths) - ps                 # the keys the kernel must read
    cl = (6100, 3050)
    ctab = torch.full((2, 50), -1, dtype=torch.int32, device=dev)
    ctab[:, :48] = torch.arange(96, dtype=torch.int32, device=dev).view(2, 48)
    cln = torch.tensor(cl, dtype=torch.int32, device=dev)
    qc = torch.randn(2, hq, 1, 128, generator=g, device=dev).to(bf)
    rows, planted = {}, {}
    for label, int8 in (("paged_decode_attention_table", False),
                        ("paged_decode_attention_table_int8", True)):
        if int8:
            kp, vp = (torch.randint(-127, 128, (pages, hkv, ps, 128), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(pages, hkv, ps, generator=g, device=dev) * 0.04 + 0.01
                      for _ in range(2))
            garbage = ((ks, float("nan")), (vs, float("inf")))
            pool = (kp, vp, ks, vs)
        else:
            kp, vp = (torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
                      for _ in range(2))
            garbage = ((kp, 8.0), (vp, 100.0))
            pool = (kp, vp)
        for t, val in garbage:
            t[free] = float("nan") if not int8 else val
            for r, n in enumerate(lengths):
                if n % ps:
                    t[table[r, (n - 1) // ps].long(), :, n % ps:] = val
        fn, plain = getattr(pa, label), getattr(pa, label + "_plain")
        name = "K9" if int8 else "K8"
        ref = plain(q, *pool, table, ln)
        err, rel = _compare(f"{name} {label}", fn(q, *pool, table, ln), ref, row_rel=True)
        ident = torch.arange(maxp, dtype=torch.int32, device=dev)[None].expand(3, maxp)
        off = table.clone()
        off[1, 10] = (off[1, 10] + 1) % pages
        for fault, args in (
                ("table ignored (pool order)", (ident.contiguous(), ln)),
                ("-1 read as page 0", (table.clamp_min(0), ln)),
                ("length ignored", (table, torch.full_like(ln, maxp * ps))),
                ("one table entry off by one", (off, ln))):
            planted[f"{name} {fault}"] = _planted(f"{name} {fault}", fn(q, *pool, *args), ref)
        row_bytes = 128 + 4 if int8 else 2 * 128
        call = lambda: fn(q, *pool, table, ln)  # noqa: E731
        rows[label] = dict(
            shapes=f"q [3, 28, 1, 128] bf16, pool [288, 4, 128, 128] "
                   + ("int8, scales [288, 4, 128] f32" if int8 else "bf16")
                   + ", table [3, 184] int32 (a seeded permutation, one -1 inside row 0), "
                     "lengths 23105 / 11905 / 1; caller pool: q [2, 28, 1, 128], pool [98, 4, "
                     "128, 128], table [2, 50] (rows on pages 0-47 / 48-95), lengths 6100 / "
                     "3050, four pools in turn",
            max_abs_err=err, max_row_rel_l2=rel,
            **_timings(call, lambda: plain(q, *pool, table, ln), 50, 5),
            ms_row0=device_ms(lambda: fn(q[:1], *pool, table[:1], ln[:1]), 50),
            launch_ms=[ms for _, ms in device_launches(call, 50)],
            host_us=host_us(call, 100),
            blocks=pa.paged_split(3, hkv, maxp, hq // hkv),
            attributes=pa.attributes(128, int8=int8, table=True),
            **_bound(4 * hq * live * 128, live * hkv * 2 * row_bytes + 2 * _nbytes(q)
                     + _nbytes(table, ln)),
            library_ms=None, library="none (no PyTorch call reads a page table)")
        row = rows[label]
        row["gbs"] = _gbs(live * hkv * 2 * row_bytes, row["ms"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        del pool, ref

        # The caller pool's shape: checked, timed over four pools in turn.
        pools = _caller_pools(g, hkv, int8, cl)
        cargs = [(qc, *pc, ctab, cln) for pc in pools]
        cref = plain(*cargs[0])
        cerr, crel = _compare(f"{name} caller pool", fn(*cargs[0]), cref, row_rel=True)
        t = _timings(_rotating(fn, cargs), _rotating(plain, cargs), 50, 5)
        clive = sum(cl)
        cbytes = clive * hkv * 2 * row_bytes
        cbound = _bound(4 * hq * clive * 128, cbytes + 2 * _nbytes(qc) + _nbytes(ctab, cln))
        row.update(max_abs_err=max(err, cerr), max_row_rel_l2=max(rel, crel),
                   caller_ms=t["ms"], caller_plain_ms=t["plain_ms"],
                   caller_wall_ms=t["wall_ms"], caller_bound_ms=cbound["bound_ms"],
                   caller_share_of_bound=cbound["bound_ms"] / t["ms"],
                   caller_gbs=_gbs(cbytes, t["ms"]),
                   caller_launch_ms=[ms for _, ms in device_launches(_rotating(fn, cargs), 50)],
                   caller_host_us=host_us(_rotating(fn, cargs), 100),
                   caller_blocks=pa.paged_split(2, hkv, 50, hq // hkv))
        # The faults of the table walk, on the first pool. A hole inside row
        # 1's length, cut to 300 tokens so that a hole's 128 keys weigh: the
        # kernel skips them as the twin does; a kernel that walked the hole
        # would read page -1, which TMA fills with zeros (a zero page 97
        # here, unit scales).
        pc = pools[0]
        holed, hln = ctab.clone(), torch.tensor((6100, 300), dtype=torch.int32, device=dev)
        holed[1, 1] = -1
        href = plain(qc, *pc, holed, hln)
        _compare(f"{name} caller pool, a hole inside row 1", fn(qc, *pc, holed, hln), href,
                 row_rel=True)
        zpool = tuple(x.clone() for x in pc)
        for x in zpool[:2]:
            x[97] = 0
        for x in zpool[2:]:
            x[97] = 1.0
        walked = holed.clone()
        walked[1, 1] = 97
        planted[f"{name} a hole walked as a key (read as zeros)"] = _planted(
            f"{name} hole walked", plain(qc, *zpool, walked, hln), href)
        full = (cln + ps - 1) // ps * ps
        planted[f"{name} the last live page taken as full"] = _planted(
            f"{name} last page full", plain(qc, *pc, ctab, full), cref)
        if int8:
            vref, unzeroed = cref, _table_v_unzeroed(qc, *pc, ctab, cln)
        else:
            # V past each length NaN: the kernel zeroes those rows before P V.
            v0 = pc[1].clone()
            for r, n in enumerate(cl):
                v0[48 * r + n // ps, :, n % ps:] = float("nan")
            vref = plain(qc, pc[0], v0, ctab, cln)
            _compare(f"{name} caller pool, NaN in V past the length",
                     fn(qc, pc[0], v0, ctab, cln), vref, row_rel=True)
            unzeroed = _table_v_unzeroed(qc, pc[0], v0, None, None, ctab, cln)
        planted[f"{name} V rows past the length not zeroed"] = _planted(
            f"{name} V not zeroed", unzeroed, vref)
        del pools, cargs, zpool
    return rows, planted


def check_glue_kernels(model, g):
    """The paged decode step's glue kernels (`ops/decode_glue.py`) against
    their plain twins at LongVA-7B's batch-1 decode shapes -> (report rows,
    planted faults): add_rmsnorm on the residual stream [1, 1, 3584] with an
    o product's delta (the add bit-equal, the norm within the tolerance);
    bias_rope_append with q/k/v biases at position 6,800 into bf16 pages
    (within one bf16 ulp) and int8 pages (values and scales equal); silu_mul
    on gate and up products [1, 1, 18944]. Device ms by torch.profiler over
    calls on four sets of inputs in turn; bound: each input byte read and
    each output byte written once at 3.35 TB/s. Each row's launches a step
    come later, from `drive_glue_steps`' counters."""
    from streamchat_tpu_torch.ops import decode_glue

    cfg, layers = model.dec_cfg, model.dec_params["layers"]
    d, f, hq, hkv, dh, eps = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.rms_eps)
    bf, dev = torch.bfloat16, "cuda"
    rows, planted = {}, {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def ulps(a, b):
        def ordered(t):
            i = t.contiguous().view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)
        return int((ordered(a) - ordered(b)).abs().max())

    # add_rmsnorm: the post-attention norm of four layers in turn.
    args = [(rnd(1, 1, d, scale=4.0), rnd(1, 1, d), p["post_norm"], eps) for p in layers[:4]]
    x, delta, scale, _ = args[0]
    ref_x, ref_h = decode_glue.add_rmsnorm_plain(x.clone(), delta, scale, eps)
    got_x, got_h = decode_glue.add_rmsnorm(x.clone(), delta, scale, eps)
    if not torch.equal(got_x, ref_x):
        raise AssertionError("add_rmsnorm: the residual add differs from the plain twin's")
    err, rel = _compare("add_rmsnorm", got_h, ref_h, row_rel=True)
    name = "add_rmsnorm without its residual add"
    planted[name] = _planted(name, decode_glue.add_rmsnorm(x.clone(), None, scale, eps)[1],
                             ref_h)
    t = _timings(_rotating(decode_glue.add_rmsnorm, args),
                 _rotating(decode_glue.add_rmsnorm_plain, args), 200, 50)
    nbytes = 5 * d * 2
    rows["add_rmsnorm"] = dict(
        shapes=f"x, delta [1, 1, {d}] bf16, scale [{d}] bf16 (x updated in place, h out)",
        max_abs_err=err, max_row_rel_l2=rel, **t, **_bound(4 * d, nbytes),
        host_us=host_us(_rotating(decode_glue.add_rmsnorm, args), 200),
        library_ms=None, library="none")

    # bias_rope_append: q/k/v products with biases at 6,800 tokens, bf16 and
    # int8 pages (64 pages of 128 slots, the row's table in pool order).
    length = torch.tensor([6800], dtype=torch.int32, device=dev)
    table = torch.arange(64, dtype=torch.int32, device=dev)[None]
    cases = {}
    for label in ("bf16", "int8"):
        shape = (64, hkv, 128, dh)
        if label == "int8":
            pools = [torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                                   generator=g) for _ in range(2)]
            pools += [torch.rand(shape[:3], device=dev, generator=g) for _ in range(2)]
        else:
            pools = [rnd(*shape), rnd(*shape), None, None]
        args = [(rnd(1, 1, hq * dh, scale=2.0), rnd(1, 1, hkv * dh, scale=2.0),
                 rnd(1, 1, hkv * dh, scale=2.0),
                 tuple(rnd(h * dh, scale=0.5) for h in (hq, hkv, hkv)), None, cfg.rope_theta,
                 *pools, table, length) for _ in range(4)]
        twin = [None if t is None else t.clone() for t in pools]
        ref = decode_glue.bias_rope_append_plain(*args[0][:6], *twin, table, length)
        got = decode_glue.bias_rope_append(*args[0])
        q_ulps = ulps(got, ref)
        if label == "int8":
            pools_ok = all(torch.equal(a, b) for a, b in zip(pools, twin))
        else:
            pools_ok = ulps(pools[0], twin[0]) <= 1 and ulps(pools[1], twin[1]) <= 1
        if q_ulps > 1 or not pools_ok:
            raise AssertionError(f"bias_rope_append ({label} pages): q {q_ulps} ulps from the "
                                 f"plain twin's, pools as the twin's {pools_ok}")
        name = f"bias_rope_append ({label} pages) at position + 1"
        planted[name] = _planted(name, decode_glue.bias_rope_append(
            *args[0][:4], length + 1, *args[0][5:]), ref)
        t = _timings(_rotating(decode_glue.bias_rope_append, args),
                     _rotating(decode_glue.bias_rope_append_plain, args), 200, 50)
        kv_bytes = 2 * hkv * dh * (1 if label == "int8" else 2) + (
            2 * hkv * 4 if label == "int8" else 0)
        nbytes = 2 * (2 * (hq + 2 * hkv) * dh) + dh // 2 * 4 + 8 + 2 * hq * dh + kv_bytes
        cases[label] = dict(q_ulps=q_ulps, max_abs_err=(got.float() - ref.float()).abs().max()
                            .item(), **t, **_bound(6 * (hq + hkv) * dh, nbytes),
                            host_us=host_us(_rotating(decode_glue.bias_rope_append, args), 200))
    rows["bias_rope_append"] = dict(
        shapes=f"q [1, 1, {hq * dh}], k / v [1, 1, {hkv * dh}] bf16 with biases, position "
               f"6800, pages [64, {hkv}, 128, {dh}] bf16 / int8 (+ scales); ms = bf16",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()), max_row_rel_l2=None,
        cases=cases,
        **{k: cases["bf16"][k] for k in ("ms", "plain_ms", "wall_ms", "plain_wall_ms",
                                         "bound_ms", "bound_by", "flops", "bytes")},
        library_ms=None, library="none")

    # silu_mul: the gate and up products (separate W8 outputs) of four layers.
    args = [(rnd(1, 1, f, scale=3.0), rnd(1, 1, f)) for _ in range(4)]
    ref = decode_glue.silu_mul_plain(*args[0])
    err, rel = _compare("silu_mul", decode_glue.silu_mul(*args[0]), ref, row_rel=True)
    name = "silu_mul with gate and up swapped"
    planted[name] = _planted(name, decode_glue.silu_mul(*args[0][::-1]), ref)
    t = _timings(_rotating(decode_glue.silu_mul, args),
                 _rotating(decode_glue.silu_mul_plain, args), 200, 50)
    rows["silu_mul"] = dict(
        shapes=f"gate, up [1, 1, {f}] bf16", max_abs_err=err, max_row_rel_l2=rel, **t,
        **_bound(5 * f, 3 * f * 2),
        host_us=host_us(_rotating(decode_glue.silu_mul, args), 200),
        library_ms=None, library="none")
    return rows, planted


def check_composed_spec(model, g):
    """One 28-layer verify step (K7) of teacher-forced tokens against as many
    vanilla decode steps (K4 / K6) from one prefilled, statically
    partitioned pool, bf16 and int8 pages: five tokens of one row, and four
    tokens of each of two rows -> per case the largest row relative L2
    error of the logits and the greedy agreement."""
    from streamchat_tpu_torch.models import decoder, paged_kv, spec_decode

    dcfg, dp = model.dec_cfg, model.dec_params
    out = {}
    for lengths, t in (([250], SPEC_TOKENS + 1), ([250, 181], 4)):
        b, s = len(lengths), 256
        embeds = (torch.randn(b, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
                  ).to(torch.bfloat16)
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        dense = decoder.KVCache.create(dcfg, b, s, dtype=embeds.dtype, device="cuda")
        logits, dense = decoder.prefill(dp, dcfg, embeds, dense, length)
        for label, page, step in (("bf16", paged_kv.from_contiguous,
                                   paged_kv.decode_step_paged),
                                  ("int8", paged_kv.from_contiguous_int8,
                                   paged_kv.decode_step_paged_int8)):
            vanilla, spec = (page(dense, 3 * b, 3, partitioned=True) for _ in range(2))
            tokens, ref, lg = [], [], logits
            for _ in range(t):
                tokens.append(torch.argmax(lg, -1))
                lg, vanilla = step(dp, dcfg, tokens[-1], vanilla, sequential_pages=True)
                ref.append(lg)
            got, _ = spec_decode.decode_step_spec(
                dp, dcfg, torch.stack(tokens, 1), spec,
                length[:, None] + torch.arange(t, device="cuda")[None])
            ref = torch.stack(ref, 1)                            # [B, T, V]
            rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
            case = f"{label}_b{b}_t{t}"
            if not torch.isfinite(got).all() or rel > STEP_REL_L2:
                raise AssertionError(f"verify step ({case}) vs {t} decode steps: row "
                                     f"relative L2 error {rel} past {STEP_REL_L2}")
            agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
            out[case] = {"row_rel_l2": rel, "greedy_agreement": f"{agree}/{b * t}"}
    return out


def check_composed_table(model, g):
    """One 28-layer decode step of three rows (250, 130 and 20 tokens, paged
    with `from_contiguous` into a shared pool, so the rows' pages are not
    their partitions) through K8 and K9 against the same step with the
    plain twin gathering through the table -> per page type the relative L2
    error of the logits and the launches."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import decoder, paged_kv
    from streamchat_tpu_torch.ops import paged_attention as pa

    dcfg, dp = model.dec_cfg, model.dec_params
    s = 256
    embeds = (torch.randn(3, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    length = torch.tensor([250, 130, 20], dtype=torch.int32, device="cuda")
    dense = decoder.KVCache.create(dcfg, 3, s, dtype=embeds.dtype, device="cuda")
    logits, dense = decoder.prefill(dp, dcfg, embeds, dense, length)
    tok = torch.argmax(logits, -1)
    out = {}
    for label, page, step, name in (
            ("bf16", paged_kv.from_contiguous, paged_kv.decode_step_paged,
             "paged_decode_attention_table"),
            ("int8", paged_kv.from_contiguous_int8, paged_kv.decode_step_paged_int8,
             "paged_decode_attention_table_int8")):
        cache, twin = page(dense, 8, 4), page(dense, 8, 4)
        kernels.reset_launch_counts()
        got, _ = step(dp, dcfg, tok, cache)
        launches = kernels.launch_counts()[name]
        scales = (lambda i: (twin.k_scale[i], twin.v_scale[i])) if label == "int8" else (
            lambda i: ())
        plain = getattr(pa, name + "_plain")
        ref, _ = paged_kv._decode_step(
            dp, dcfg, tok, twin,
            lambda q, i, ln: plain(q, twin.k_pages[i], twin.v_pages[i], *scales(i),
                                   twin.page_table, ln))
        rel = ((got - ref).norm() / ref.norm()).item()
        if not torch.isfinite(got).all() or rel > STEP_REL_L2 or launches != dcfg.num_layers:
            raise AssertionError(f"B = 3 decode step through {name} vs the plain gather: "
                                 f"relative L2 error {rel} (limit {STEP_REL_L2}), "
                                 f"{launches} launches")
        out[label] = {"logits_rel_l2": rel, "launches": launches}
    return out


def drive_spec_rows(model, g):
    """`generate_paged` with spec_tokens 9 over int8 pages at full width, the
    path that needs more than one 64-row tile (7 query heads x 10 tokens =
    70 folded rows a kv head): one 3,050-token prompt (3,072 padded), 32
    new tokens, greedy, the launch counters zeroed before it and read after
    it. K7' must launch, every time with 70 rows; the first verify step's
    logits are held against ten vanilla int8 decode steps (K6),
    teacher-forced with its tokens from a copy of the pool it started from
    (row relative L2 <= STEP_REL_L2) -> (report, counts)."""
    import dataclasses

    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import generate_paged as gp
    from streamchat_tpu_torch.models import paged_kv, spec_decode

    dcfg, dp = model.dec_cfg, model.dec_params
    spec, length, s = 9, 3050, 3072
    embeds = (torch.randn(1, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    ln = torch.tensor([length], dtype=torch.int32, device="cuda")
    step, partial = spec_decode.decode_step_spec, spec_decode.paged_seq_attention_partial_int8
    first, rows = [], []

    def recording_step(params, cfg, token_ids, cache, positions):
        if not first:
            pool = dataclasses.replace(cache, **{
                f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)})
            first.append((token_ids.clone(), pool))
        logits, cache = step(params, cfg, token_ids, cache, positions)
        if len(first) == 1:
            first.append(logits.float().clone())
        return logits, cache

    def recording_partial(q, *a):
        rows.append(q.shape[1] // a[0].shape[1] * q.shape[2])
        return partial(q, *a)

    spec_decode.decode_step_spec = recording_step
    spec_decode.paged_seq_attention_partial_int8 = recording_partial
    try:
        stats = {}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, count = gp.generate_paged(dp, dcfg, embeds, ln, max_new_tokens=32, kv_int8=True,
                                        spec_tokens=spec, stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        spec_decode.decode_step_spec = step
        spec_decode.paged_seq_attention_partial_int8 = partial
    (tokens, pool), got = first[0], first[1]
    ref = []
    for i in range(spec + 1):
        lg, pool = paged_kv.decode_step_paged_int8(dp, dcfg, tokens[:, i], pool,
                                                   sequential_pages=True)
        ref.append(lg.float())
    ref = torch.stack(ref, 1)                                        # [1, T, V]
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    report = dict(seconds=seconds, verify_steps=stats["verify_steps"],
                  accepted_tokens=stats["accepted_tokens"],
                  generated_tokens=stats["generated_tokens"],
                  decode_ms_per_step=1e3 * stats["decode_s"] / stats["decode_steps"],
                  k7_int8_rows=sorted(set(rows)), first_step_logits_rel_l2=rel,
                  greedy_agreement=f"{int((got.argmax(-1) == ref.argmax(-1)).sum())}/{spec + 1}",
                  launches={n: c for n, c in counts.items() if c})
    print(f"generate_paged spec_tokens {spec} [kv_int8]: {json.dumps(report)}", flush=True)
    want = dcfg.num_heads // dcfg.num_kv_heads * (spec + 1)
    if (counts.get("paged_seq_attention_partial_int8", 0) == 0 or set(rows) != {want}
            or not torch.isfinite(got).all() or rel > STEP_REL_L2 or int(count.sum()) == 0):
        raise AssertionError(f"spec_tokens {spec} over int8 pages: K7' rows {set(rows)} "
                             f"(want {want}), first-step logits relative L2 {rel} past "
                             f"{STEP_REL_L2}, or no token")
    return report, counts


def drive_caller_pool(model, g, kv_int8: bool):
    """`generate_paged` at full width on a caller-sized pool, the main path of
    the table kernels: two rows of 6,100 and 3,050 valid tokens (6,144
    padded), 64 new tokens, 98 pages of 128 tokens and 50 table slots per
    row (the rows' prompts take 96 pages; each row crosses into one more
    page mid-decode, mapped by the allocator). The launch counters are
    zeroed before it and read after it. The same rows then run on the split
    path (K4 / K6); the first decode step's logits are compared, greedy
    agreement reported, and a 97-page pool must raise RuntimeError ->
    (report, counts)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import generate_paged as gp

    dcfg, dp = model.dec_cfg, model.dec_params
    lengths, s, new = [6100, 3050], 6144, 64
    embeds = (torch.randn(2, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    label = "caller_pool_kv_int8" if kv_int8 else "caller_pool_bf16"
    step_name = "decode_step_paged_int8" if kv_int8 else "decode_step_paged"
    step = getattr(gp, step_name)
    first = []

    def recording(*a, **kw):
        logits, cache = step(*a, **kw)
        if not first:
            first.append(logits.float().clone())
        return logits, cache

    kw = dict(max_new_tokens=new, kv_int8=kv_int8)
    setattr(gp, step_name, recording)
    try:
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks, _ = gp.generate_paged(dp, dcfg, embeds, ln, num_pages=98, max_pages_per_seq=50,
                                    stats=stats, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        caller_first = first.pop()
        ref_toks, _ = gp.generate_paged(dp, dcfg, embeds, ln, **kw)
        split_first = first.pop()
    finally:
        setattr(gp, step_name, step)
    try:
        gp.generate_paged(dp, dcfg, embeds, ln, num_pages=97, max_pages_per_seq=50, **kw)
    except RuntimeError as e:
        undersized = str(e)[:60]
    else:
        raise AssertionError(f"{label}: a 97-page pool did not raise RuntimeError")
    rel = ((caller_first - split_first).norm(dim=-1) / split_first.norm(dim=-1)).max().item()
    report = dict(seconds=seconds, decode_ms_per_step=1e3 * stats["decode_s"]
                  / stats["decode_steps"], prefill_s=stats["prefill_s"], peak_gib=peak,
                  first_step_logits_rel_l2_vs_split=rel,
                  greedy_agreement=f"{int((toks == ref_toks).sum())}/{toks.size}",
                  undersized_pool_raised=undersized,
                  launches={n: c for n, c in counts.items() if c})
    print(f"generate_paged caller-sized pool [{label}]: {json.dumps(report)}", flush=True)
    missing = [n for n in RUNS[label] if counts.get(n, 0) == 0]
    if missing or not torch.isfinite(caller_first).all() or rel > STEP_REL_L2:
        raise AssertionError(f"{label}: kernels never launched {missing}, or first-step "
                             f"logits relative L2 {rel} past {STEP_REL_L2}")
    return report, counts


def compare_prefill(model, g):
    """The chunk-40 caption prefill (23,441 valid of 23,552 tokens, bf16
    weights) in one pass (K3) and through the chunked dispatch (K3 + K5),
    in turns (one, chunked, chunked, one) -> seconds, peak GiB, K5 launches
    and the logits' relative L2 difference."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import decoder, generate

    dcfg, dp = model.dec_cfg, model.dec_params
    s, valid = 23552, 23441
    embeds = (torch.randn(1, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    ln = torch.tensor([valid], dtype=torch.int32, device="cuda")
    fns = {"one_pass": decoder.prefill, "chunked": generate._prefill_inline}
    res = {n: {"seconds": [], "peak_gib": []} for n in fns}
    logits = {}
    for name in ("one_pass", "chunked", "chunked", "one_pass"):
        cache = decoder.KVCache.create(dcfg, 1, s, dtype=embeds.dtype, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits[name], _ = fns[name](dp, dcfg, embeds, cache, ln)
        torch.cuda.synchronize()
        res[name]["seconds"].append(time.perf_counter() - t0)
        res[name]["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
        res[name]["k5_launches"] = kernels.launch_counts()["flash_attention_partial"]
        del cache
    if res["chunked"]["k5_launches"] != 5 * dcfg.num_layers:
        raise AssertionError(f"chunked prefill launched K5 {res['chunked']['k5_launches']} "
                             f"times, expected {5 * dcfg.num_layers}")
    a, b = logits["chunked"], logits["one_pass"]
    res["logits_rel_l2"] = ((a - b).norm() / b.norm()).item()
    for name in fns:
        res[name]["tokens_per_s"] = [s / x for x in res[name]["seconds"]]
    return res


def _dequantized(params):
    """The bf16 tree a quantized decoder tree stands for."""
    from streamchat_tpu_torch.ops import quant

    def deq(p):
        if "w_i4p" in p:
            w = quant.dequantize_weight_int4(p, torch.bfloat16)
        else:
            w = quant.dequantize_weight(p, torch.bfloat16)
        return dict({"w": w}, **({"b": p["b"]} if "b" in p else {}))

    out = dict(params)
    out["layers"] = [{
        "input_norm": p["input_norm"], "post_norm": p["post_norm"],
        "attn": {n: deq(p["attn"][n]) for n in ("q", "k", "v", "o")},
        "mlp": {n: deq(p["mlp"][n])["w"] for n in ("gate", "up", "down")},
    } for p in params["layers"]]
    out["lm_head"] = deq(params["lm_head"])["w"]
    return out


def check_composed_quant(model, g, label, expected):
    """One 28-layer decode step of the model's quantized tree (the GEMV
    kernels `expected`) against the same step on its dequantized bf16
    tree, from one prefilled cache -> relative L2 error of the logits."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import decoder, paged_kv

    dcfg, qp = model.dec_cfg, model.dec_params
    deq = _dequantized(qp)
    s = 256
    embeds = (torch.randn(1, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    length = torch.tensor([250], dtype=torch.int32, device="cuda")
    dense = decoder.KVCache.create(dcfg, 1, s, dtype=embeds.dtype, device="cuda")
    logits, dense = decoder.prefill(deq, dcfg, embeds, dense, length)
    tok = torch.argmax(logits, -1)
    kernels.reset_launch_counts()
    got, _ = paged_kv.decode_step_paged(qp, dcfg, tok, paged_kv.from_contiguous(dense, 3, 3),
                                        sequential_pages=True)
    counts = kernels.launch_counts()
    ref, _ = paged_kv.decode_step_paged(deq, dcfg, tok, paged_kv.from_contiguous(dense, 3, 3),
                                        sequential_pages=True)
    del deq
    rel = ((got - ref).norm() / ref.norm()).item()
    if not torch.isfinite(got).all() or rel > STEP_REL_L2:
        raise AssertionError(f"{label} decode step vs its dequantized bf16 tree: relative "
                             f"L2 error {rel} past {STEP_REL_L2}")
    missing = [n for n in expected if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"{label} decode step launched no {missing}: {counts}")
    return rel


def _decode_weight_bytes(params) -> int:
    """Bytes of weights one decode token reads: every layer tensor, the
    head and one embedding row."""
    def size(t):
        if isinstance(t, dict):
            return sum(size(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(size(v) for v in t)
        return t.numel() * t.element_size()

    emb = params["embed"]
    emb = emb["w_i8"] if isinstance(emb, dict) else emb
    return (size(params["layers"]) + size(params["final_norm"]) + size(params["lm_head"])
            + emb.shape[1] * emb.element_size())


def _kv_bytes_per_token(cfg, context: int, kv_int8: bool) -> int:
    """KV bytes a decode token reads at `context` (K and V, every layer)."""
    row = cfg.head_dim + 4 if kv_int8 else 2 * cfg.head_dim
    return context * cfg.num_layers * cfg.num_kv_heads * 2 * row


def _sim_check(name, got, ref, planted=False):
    """K12: max |sim - plain sim| within SIM_ATOL (and finite); a planted
    fault must fail it -> the max error."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= SIM_ATOL
    if ok == planted:
        raise AssertionError(f"{'planted fault ' if planted else ''}{name}: max |sim - plain| "
                             f"{err} (limit {SIM_ATOL})")
    return err


def dedup_attributes() -> dict:
    """K12's compiled instantiations (f32 / bf16, 16-byte / scalar loads):
    registers, local (spill) bytes and static shared bytes a thread / block
    (sc_dedup_attributes)."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    out = {}
    for dtype, dname in ((1, "f32"), (0, "bf16")):
        for vec in (1, 0):
            a = (ctypes.c_int * 3)()
            err = library().sc_dedup_attributes(dtype, vec, a)
            if err:
                raise RuntimeError(f"sc_dedup_attributes: CUDA error {err}")
            out[f"{dname}_{'vec16' if vec else 'scalar'}"] = dict(
                num_regs=a[0], local_bytes=a[1], static_shared_bytes=a[2])
    return out


def launch_floor(blocks: int, threads: int) -> dict:
    """Device time of an empty kernel (sc_empty_kernel) of one block of 32
    threads and of K12's grid size: the floor a kernel as short as K12 is
    read against."""
    from streamchat_tpu_torch.kernels.build import call

    def empty(b, t):
        return lambda: call("sc_empty_kernel", b, t, torch.cuda.current_stream().cuda_stream)

    return dict(launch_floor_ms=device_ms(empty(1, 32), 50, kernel="empty_kernel"),
                launch_floor_grid_ms=device_ms(empty(blocks, threads), 50,
                                               kernel="empty_kernel"))


def check_vit_kernels(model, g):
    """K12, K13 and K14 against their plain twins at main-path shapes ->
    report rows and planted faults."""
    from streamchat_tpu_torch.ops import dedup, fused_vit, vit_attention

    bf, dev = torch.bfloat16, model.device
    rows, planted = {}, {}

    # K12: one segment's frame descriptors, [60, 3584] f32, every third frame
    # a near-repeat of the one before it (1 - sim ~ 1e-3 there, ~1 elsewhere).
    n, d, thr = 60, model.dec_cfg.hidden_size, 0.18
    x = torch.randn(n, d, generator=g, device=dev)
    x[1::3] = x[0::3] + 0.05 * torch.randn(n // 3, d, generator=g, device=dev)
    keep, sim = dedup.select_changed_frames(x, threshold=thr, return_similarity=True)
    pkeep, psim = dedup.select_changed_frames_plain(x, threshold=thr, return_similarity=True)
    err = _sim_check("K12 select_changed_frames", sim, psim)
    if not torch.equal(keep, pkeep) or not 0 < int(keep.sum()) < n:
        raise AssertionError(f"K12 keep mask {keep.tolist()} vs plain {pkeep.tolist()}")
    _, rev = dedup.select_changed_frames(x.flip(0), threshold=thr, return_similarity=True)
    planted["K12 roll reversed (row i against i + 1)"] = _sim_check(
        "K12 roll reversed", rev.flip(0), psim, planted=True)
    norms = x.norm(dim=1)
    planted["K12 unnormalized (dot products)"] = _sim_check(
        "K12 unnormalized", sim * norms * norms.roll(1, 0), psim, planted=True)
    k12 = lambda: dedup.select_changed_frames(x, threshold=thr)  # noqa: E731
    p12 = lambda: dedup.select_changed_frames_plain(x, threshold=thr)  # noqa: E731
    t12 = _timings(k12, p12, 50, 20)
    t12.update(wrapper_ms=t12["ms"], ms=device_ms(k12, 50, kernel="dedup_kernel"))
    plan = dedup.launch_plan(n, d, x.element_size())
    rows["select_changed_frames"] = dict(
        shapes=f"descriptors [{n}, {d}] f32, threshold {thr}, {int(keep.sum())} kept",
        max_abs_err=err, **t12,
        **_bound(6 * n * d, _nbytes(x) + 4 * n, peak=PEAK_F32),
        library_ms=device_ms(lambda: torch.nn.functional.cosine_similarity(
            x, x.roll(1, 0)), 50),
        library="F.cosine_similarity(x, x.roll(1, 0)); ms is the kernel alone, "
                "wrapper_ms adds the keep mask's two small torch ops",
        blocks=dict(plan, threads=dedup.THREADS),
        attributes=dedup_attributes(),
        **launch_floor(plan["blocks"], dedup.THREADS))
    rows["select_changed_frames"]["share_of_bound"] = (
        rows["select_changed_frames"]["bound_ms"] / rows["select_changed_frames"]["ms"])

    # K13: the attention half of ViT layer 0 over an ingest batch of 16
    # frames, both softmax modes, unfolded and folded (exp2, one-pass LN).
    p = model.vit_params["layers"][0]
    heads, dm = model.vit_cfg.num_heads, model.vit_cfg.hidden_size
    s, dh = model.vit_cfg.num_patches + 1, dm // heads
    xs = torch.randn(16, s, dm, generator=g, device=dev).to(bf)
    w = [p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
         p["attn"]["o"]["w"], p["attn"]["o"]["b"]]
    fw, fb = fused_vit.fold_vit_attn_params(*w[:4], num_heads=heads)
    wf = [w[0], w[1], fw, fb, w[4], w[5]]
    cases, errs = {}, []
    for mode in ("clamp", "exact"):
        for folded in (False, True):
            args = wf if folded else w
            kw = dict(num_heads=heads, softmax_mode=mode, folded=folded, ln_onepass=folded)
            k13 = lambda args=args, kw=kw: fused_vit.fused_ln_attn(xs, *args, **kw)  # noqa: E731
            ref = fused_vit.fused_ln_attn_plain(xs, *args, **kw)
            label = f"{mode}{', folded + ln_onepass' if folded else ''}"
            e, rel = _compare(f"K13 fused_ln_attn {label}", k13(), ref, row_rel=True)
            errs.append(e)
            cases[label] = dict(max_abs_err=e, max_row_rel_l2=rel, ms=device_ms(k13, 20))
            if (mode, folded) == ("clamp", False):
                planted["K13 without the residual"] = _planted(
                    "K13 without the residual", k13() - xs, ref)
                timed = _timings(k13, lambda: fused_vit.fused_ln_attn_plain(xs, *w, **kw), 20, 5)
                rel0 = rel
            del ref
    qa, ka, va = (torch.randn(16, heads, s, dh, generator=g, device=dev).to(bf)
                  for _ in range(3))
    rows["fused_ln_attn"] = dict(
        shapes=f"x [16, {s}, {dm}] bf16, ViT layer 0's attention half; timed: clamp, "
               "unfolded (the default)",
        max_abs_err=max(errs), max_row_rel_l2=rel0, cases=cases, **timed,
        **_bound(2 * 16 * s * dm * 4 * dm + 4 * 16 * heads * s * s * dh,
                 _nbytes(*w) + 2 * _nbytes(xs)),
        library_ms=None, library="none for LN + QKV + attention + O; attention_library_ms: "
        f"SDPA of its attention alone, q/k/v [16, {heads}, {s}, {dh}]",
        attention_library_ms=device_ms(lambda: _sdpa(qa, ka, va), 20),
        attributes=dict(gemm=gemm_attributes(),
                        attention_clamp=prefill_attributes(False, dh, SOFTMAX["clamp"]),
                        attention_exact=prefill_attributes(False, dh, SOFTMAX["exact"])))
    rows["fused_ln_attn"]["share_of_bound"] = (rows["fused_ln_attn"]["bound_ms"]
                                               / rows["fused_ln_attn"]["ms"])

    # K14: non-causal ViT attention, [16, 16, 577, 64] bf16 at ViT-L, no pad.
    k14 = lambda: vit_attention.vit_attention(qa, ka, va)  # noqa: E731
    p14 = lambda: vit_attention.vit_attention_plain(qa, ka, va)  # noqa: E731
    ref = p14()
    err, rel = _compare("K14 vit_attention", k14(), ref, row_rel=True)
    planted[f"K14 key {s - 1} masked"] = _planted(
        "K14 last key masked", vit_attention.vit_attention(qa, ka[:, :, :-1], va[:, :, :-1]),
        ref)
    planted[f"K14 last key tile (keys 512-{s - 1}) dropped"] = _planted(
        "K14 last key tile dropped",
        vit_attention.vit_attention(qa, ka[:, :, :512], va[:, :, :512]), ref)
    del ref
    rows["vit_attention"] = dict(
        shapes=f"q/k/v [16, {heads}, {s}, {dh}] bf16, non-causal", max_abs_err=err,
        max_row_rel_l2=rel, **_timings(k14, p14, 20, 5),
        **_bound(4 * 16 * heads * s * s * dh, 4 * _nbytes(qa)),
        library_ms=device_ms(lambda: _sdpa(qa, ka, va), 20),
        library="F.scaled_dot_product_attention (non-causal) on the same q/k/v",
        attributes=prefill_attributes(False, dh, SOFTMAX["exact"]))
    rows["vit_attention"]["share_of_bound"] = (rows["vit_attention"]["bound_ms"]
                                               / rows["vit_attention"]["ms"])
    return rows, planted


def _xor_without_sum_term(got, x, scale):
    """A K15 xor32 / xor8 output as if the kernel had dropped the -8 sum(x_g)
    term of the low half: y_lo + 8 sum_g scale[g, 0] sum(x_g)."""
    oh = scale.shape[2]
    sx = x.float().reshape(x.shape[0], scale.shape[0], -1).sum(-1)       # [n, g]
    bad = got.clone()
    bad[:, :oh] += 8.0 * sx @ scale[:, 0]
    return bad


def check_probe_kernels(g):
    """K15, K16 and K17 against their plain twins at the probes' shapes ->
    report rows and planted faults."""
    from streamchat_tpu_torch.ops import quant
    from streamchat_tpu_torch.utils import probe_int4, probe_vit_variants as pvv

    bf, dev = torch.bfloat16, "cuda"
    rows, planted = {}, {}

    # K15: the five variants at (1024, 16) and the nine sweep points of the
    # three unpacks, 3584 x 18944, n = 1; timed over three weight copies.
    weights, wd = probe_int4.make_weights(g)
    x = torch.randn(1, probe_int4.DIN, generator=g, device=dev).to(bf)
    w0, s0 = weights[0]
    cases, errs, rels = {}, [], []
    for variant in probe_int4.VARIANTS:
        for bo, gpb in ((1024, 16),) + (probe_int4.SWEEP if variant in probe_int4.UNPACKS
                                        else ()):
            got = probe_int4.matvec(x, w0, s0, variant=variant, block_out=bo, gpb=gpb)
            ref = probe_int4.matvec_plain(x, w0, s0, variant, bo, gpb)
            if variant == "dma":
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError("K15 dma: the byte sums differ from the twin's")
                e = 0.0
            else:
                e, rel = _compare(f"K15 matvec {variant} {bo}x{gpb}", got, ref, row_rel=True)
                rels.append(rel)
            errs.append(e)
            if (bo, gpb) == (1024, 16):
                fn = probe_int4._rotating(x, weights, variant=variant)
                cases[variant] = dict(max_abs_err=e, ms=device_ms(fn, 40))
                cases[variant]["gbs"] = _gbs(_int4_bytes({"w_i4p": w0, "scale": s0}),
                                             cases[variant]["ms"])
    got = probe_int4.matvec(x, w0, s0, variant="xor32")
    ref = probe_int4.matvec_plain(x, w0, s0, "xor32")
    planted["K15 xor32 without the -8 sum(x_g) term"] = _planted(
        "K15 xor32 without the -8 sum(x_g) term", _xor_without_sum_term(got, x, s0), ref)
    ref = probe_int4.matvec_plain(x, w0, s0, "cur")
    planted["K15 cur, nibble halves swapped"] = _planted(
        "K15 cur, nibble halves swapped",
        probe_int4.matvec(x, _swap_nibbles(w0), s0, variant="cur"), ref)
    # The card's split at (1024, 16): the last block's row range (groups) and
    # column sub-tile, each dropped (their packed bytes read as zeros).
    oh, groups = w0.shape[1], s0.shape[0]
    _, (c0, c1), (g0, g1) = probe_int4.card_blocks(oh, groups, 16)[-1]
    for label, rows_, cols_ in (("row range", slice(g0 * probe_int4.GROUP, g1 * probe_int4.GROUP),
                                 slice(None)), ("column sub-tile", slice(None), slice(c0, c1))):
        dropped = w0.clone()
        dropped[rows_, cols_] = 0
        name = f"K15 cur, last {label} of the card's split dropped"
        planted[name] = _planted(name, probe_int4.matvec(x, dropped, s0, variant="cur"), ref)
        del dropped
    t = _timings(probe_int4._rotating(x, weights, variant="cur"),
                 lambda: probe_int4.matvec_plain(x, w0, s0, "cur"), 40, 5)
    kin, kout = w0.shape[0], 2 * w0.shape[1]
    rows["matvec"] = dict(
        shapes=f"x [1, {kin}] bf16, packed w [{kin}, {kout // 2}], {s0.shape[0]} groups, "
               "f32 out; "
               "timed: cur at block_out 1024, gpb 16; checked: 5 variants at (1024, 16) and "
               "cur / xor32 / xor8 at the 9 sweep points",
        max_abs_err=max(errs), max_row_rel_l2=max(rels), cases=cases, **t,
        gbs=_gbs(_int4_bytes({"w_i4p": w0, "scale": s0}), t["ms"]),
        **_bound(4 * kin * kout // 2, _int4_bytes({"w_i4p": w0, "scale": s0}) + _nbytes(x)
                 + 4 * kout, peak=PEAK_F32),
        library_ms=device_ms(lambda: torch.matmul(x, wd), 40),
        library="torch.matmul(x, W) on the dequantized bf16 weight",
        dma_to_cur=cases["cur"]["ms"] / cases["dma"]["ms"],
        blocks={f"{bo}x{gpb}": probe_int4.card_grid(kout // 2, kin // probe_int4.GROUP,
                                                    gpb)["blocks"]
                for bo, gpb in ((1024, 16),) + probe_int4.SWEEP},
        attributes={v: probe_int4.attributes(v, 1, kout // 2) for v in probe_int4.VARIANTS})
    rows["matvec"]["share_of_bound"] = rows["matvec"]["bound_ms"] / rows["matvec"]["ms"]
    # cur's device time by launch: the probe kernel, then the slices' reduce.
    rows["matvec"]["launch_ms"] = [t for _, t in device_launches(
        probe_int4._rotating(x, weights, variant="cur"), 20)]
    for case in cases.values():
        case["share_of_bound"] = rows["matvec"]["bound_ms"] / case["ms"]
    del weights, wd

    # K16: the five layer variants at [128, 577, 1024]; timed: combo.
    heads, s, d, dmid = pvv.HEADS, pvv.S, pvv.D, pvv.DMID
    xs = (torch.randn(pvv.N, s, d, generator=g, device=dev) * 0.5).to(bf)
    cases, errs = {}, []
    for name, opt in pvv.VARIANTS.items():
        params = pvv.make_params(g, opt)
        k16 = lambda params=params, opt=opt: pvv.probe_layer(xs, params, opt)  # noqa: E731
        ref = pvv.probe_layer_plain(xs, params, opt)
        e = _compare(f"K16 probe_layer {name}", k16(), ref)[0]
        errs.append(e)
        cases[name] = dict(max_abs_err=e, ms=device_ms(k16, 5))
        if name == "wfold":
            planted["K16 wfold weights without the fold flag"] = _planted(
                "K16 wfold weights without the fold flag",
                pvv.probe_layer(xs, params, pvv.VARIANTS["base"]), ref)
        if name == "combo":
            t = _timings(k16, lambda params=params, opt=opt: pvv.probe_layer_plain(
                xs, params, opt), 5, 1)
            nbytes = _nbytes(*params) + 2 * _nbytes(xs)
        del ref
    qa, ka, va = (torch.randn(pvv.N, heads, s, d // heads, generator=g, device=dev).to(bf)
                  for _ in range(3))
    rows["probe_layer"] = dict(
        shapes=f"x [{pvv.N}, {s}, {d}] bf16, ViT-L block, clamp softmax; timed: combo "
               "(wfold + ln1p, the ingest's form)",
        max_abs_err=max(errs), cases=cases, **t,
        **_bound(pvv.N * (2 * s * (4 * d * d + 2 * d * dmid) + 4 * heads * s * s * (d // heads)),
                 nbytes),
        library_ms=None, library="none for the whole layer; attention_library_ms: SDPA of its "
        f"attention alone, q/k/v [{pvv.N}, {heads}, {s}, {d // heads}]",
        attention_library_ms=device_ms(lambda: _sdpa(qa, ka, va), 5),
        attributes=dict(gemm=gemm_attributes(),
                        attention_clamp=prefill_attributes(False, d // heads, SOFTMAX["clamp"]),
                        attention_bf16s=prefill_attributes(False, d // heads,
                                                           SOFTMAX_CLAMP_BF16)))
    rows["probe_layer"]["share_of_bound"] = (rows["probe_layer"]["bound_ms"]
                                             / rows["probe_layer"]["ms"])
    del xs, qa, ka, va

    # K17: the four dot kinds; timed: qk64.
    cases, errs = {}, []
    for kind in pvv.DOT_KINDS:
        a, b = pvv.make_dot_inputs(kind, g)
        ref = pvv.dotk_plain(a, b)
        e, rel = _compare(f"K17 dotk {kind}", pvv.dotk(a, b), ref, row_rel=True)
        errs.append(e)
        pv = kind.startswith("pv")
        if kind in ("qk64", "pv64"):
            planted[f"K17 {kind}, one dot dropped"] = _planted(
                f"K17 {kind}, one dot dropped",
                pvv.dotk(a, b[:-1]) if pv else pvv.dotk(a[:-1], b), ref)
            # The operand the threads load into shared memory (qk: b [dh, S];
            # pv: a [S, S]) without its last column.
            cut = (a if pv else b).clone()
            cut[:, -1] = 0
            name = f"K17 {kind}, last column of the shared operand skipped"
            planted[name] = _planted(name, pvv.dotk(cut, b) if pv else pvv.dotk(a, cut), ref)
            del cut
        if pv:
            library = lambda a=a, b=b: torch.matmul(a, b).sum(0)  # noqa: E731
        else:
            a2 = a.permute(1, 0, 2).reshape(s, -1).contiguous()
            b2 = b.repeat(a.shape[0], 1)
            library = lambda a2=a2, b2=b2: torch.matmul(a2, b2)  # noqa: E731
        k17 = lambda a=a, b=b: pvv.dotk(a, b)  # noqa: E731
        ms = device_ms(k17, 50)
        cases[kind] = dict(max_abs_err=e, max_row_rel_l2=rel, ms=ms,
                           tflops=pvv.dot_flops() / (ms * 1e-3) / 1e12,
                           library_ms=device_ms(library, 50),
                           **_bound(pvv.dot_flops(), _nbytes(a, b, ref)),
                           attributes=pvv.dot_attributes(kind),
                           launch_ms=[t for _, t in device_launches(k17, 20)])
        cases[kind]["share_of_bound"] = cases[kind]["bound_ms"] / ms
        if kind == "qk64":
            timed = dict(**_timings(k17, lambda a=a, b=b: pvv.dotk_plain(a, b), 50, 10),
                         **{k: cases[kind][k] for k in ("bound_ms", "bound_by", "flops",
                                                        "bytes", "library_ms")})
        del ref
    rows["dotk"] = dict(
        shapes="qk64 96 x [577, 64] @ [64, 577], qk128 48 x [577, 128] @ [128, 577], pv64 "
               "[577, 577] @ 96 x [577, 64], pv128 [577, 577] @ 48 x [577, 128], each summed "
               "in f32 (4.09 GFLOP); timed: qk64",
        max_abs_err=max(errs), max_row_rel_l2=cases["qk64"]["max_row_rel_l2"], cases=cases,
        **timed,
        library="qk: one torch.matmul of [577, n dh] by [n dh, 577]; pv: torch.matmul(a, b) "
                "and the sum over n (two calls)")
    rows["dotk"]["share_of_bound"] = rows["dotk"]["bound_ms"] / rows["dotk"]["ms"]
    return rows, planted


def drive_probes():
    """The probes' main paths (K16 / K17's `probe_vit_variants`, K15's
    `probe_int4`), the launch counters zeroed before and read after ->
    (their results, counts)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.utils import probe_int4, probe_vit_variants

    kernels.reset_launch_counts()
    results = {"probe_vit_variants": probe_vit_variants.main([]),
               "probe_int4": probe_int4.main([])}
    counts = kernels.launch_counts()
    modes = kernels.launch_modes()
    missing = [n for n in ("matvec", "probe_layer", "dotk") if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"probes: kernels never launched: {missing}")
    want = {"probe_layer": {probe_vit_variants.variant_mode(o)
                            for o in probe_vit_variants.VARIANTS.values()},
            "dotk": set(probe_vit_variants.DOT_KINDS)}
    for wrapper, kinds in want.items():
        if set(modes.get(wrapper, {})) != kinds:
            raise AssertionError(f"probes: {wrapper} ran {modes.get(wrapper)}, "
                                 f"expected {sorted(kinds)}")
    if {m.split()[0] for m in modes.get("matvec", {})} != set(probe_int4.VARIANTS):
        raise AssertionError(f"probes: matvec ran {modes.get('matvec')}")
    print(f"probes: launches {json.dumps({n: c for n, c in counts.items() if c})}, "
          f"modes {json.dumps(modes)}", flush=True)
    return results, counts


def check_composed(model, g):
    """Small-input references for the composed ViT+projector and decode paths."""
    from streamchat_tpu_torch.models import decoder, paged_kv, vit
    from streamchat_tpu_torch.ops import paged_attention
    from streamchat_tpu_torch.ops.fused_vit import fused_ln_mlp_plain, fused_vit_layer_plain

    # encode_images runs the fused tower (folded once on its first call,
    # one-pass LN, clamp softmax): held to the twin chain of the same form
    # and to the exact unfolded chain; the clamp's domain checked on the
    # random tower's logits.
    cfg = model.vit_cfg
    pixels = torch.randn(2, 3, cfg.image_size, cfg.image_size, generator=g, device="cuda")
    got = model.encode_images(pixels).float()
    vp = model.vit_params
    if not all("fused" in p for p in vp["layers"]):
        raise AssertionError("encode_images did not fold the tower's weights")
    pp = model.proj_params
    out = {}
    for label, folded in (("folded_clamp", True), ("exact", False)):
        x = vit._embedded(vp, pixels, cfg)
        for p in vp["layers"][: cfg.num_layers + 1 + cfg.select_layer]:
            f = p["fused"] if folded else {"wqkv": p["attn"]["wqkv"], "bqkv": p["attn"]["bqkv"],
                                           "w1": p["mlp"]["fc1"]["w"], "b1": p["mlp"]["fc1"]["b"]}
            x = fused_vit_layer_plain(
                x, p["ln1"]["scale"], p["ln1"]["bias"], f["wqkv"], f["bqkv"],
                p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
                f["w1"], f["b1"], p["mlp"]["fc2"]["w"], p["mlp"]["fc2"]["b"],
                num_heads=cfg.num_heads, eps=cfg.layernorm_eps,
                softmax_mode="clamp" if folded else "exact", folded=folded,
                ln_onepass=folded)
        feats = x[:, 1:].reshape(-1, cfg.hidden_size)
        ref = fused_ln_mlp_plain(feats, None, None, pp["fc1"]["w"], pp["fc1"]["b"],
                                 pp["fc2"]["w"], pp["fc2"]["b"], activation="gelu",
                                 layernorm=False, residual=False).float()
        got = got.reshape(ref.shape)
        if got.shape != (2 * cfg.num_patches, model.dec_cfg.hidden_size):
            raise AssertionError(f"encode_images shape {tuple(got.shape)}")
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
        if not torch.isfinite(got).all() or cos < 0.99:
            raise AssertionError(f"fused ViT+projector vs plain ({label}): min token "
                                 f"cosine {cos}")
        out[f"vit_projector_min_cosine_{label}"] = cos
    bounds = vit.attention_logit_bounds(vp, pixels, cfg)
    lo, hi = bounds[:, 0].min().item(), bounds[:, 1].max().item()
    print(f"attention logit bounds of the random tower, per layer [min, max]: "
          f"{json.dumps(bounds.tolist())}", flush=True)
    if not (torch.isfinite(bounds).all() and -87.0 < lo and hi <= 80.0):
        raise AssertionError(f"attention logits [{lo}, {hi}] leave the clamp softmax's "
                             "domain (-87, 80]")
    out["attention_logit_bounds"] = [lo, hi]

    dcfg, dp = model.dec_cfg, model.dec_params
    s = 256
    embeds = (torch.randn(1, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(dp["embed"].dtype)
    length = torch.tensor([250], dtype=torch.int32, device="cuda")
    dense = decoder.KVCache.create(dcfg, 1, s, dtype=embeds.dtype, device="cuda")
    logits, dense = decoder.prefill(dp, dcfg, embeds, dense, length)
    cache = paged_kv.from_contiguous(dense, 3, 3)
    twin = paged_kv.from_contiguous(dense, 3, 3)
    tok = torch.argmax(logits, -1)
    got, _ = paged_kv.decode_step_paged(dp, dcfg, tok, cache, sequential_pages=True)
    ref, _ = paged_kv._decode_step(
        dp, dcfg, tok, twin,
        lambda q, i, ln: paged_attention.paged_decode_attention_table_plain(
            q, twin.k_pages[i], twin.v_pages[i], twin.page_table, ln))
    rel = ((got - ref).norm() / ref.norm()).item()
    if not torch.isfinite(got).all() or rel > 5e-2:
        raise AssertionError(f"decode step K4 vs page-table gather: relative L2 "
                             f"error {rel} past 5e-2")
    return {**out, "decode_logits_rel_l2_err": rel}


BREAKPOINTS = [
    {"question": "What is on the table in front of me?", "answer": "a cup",
     "class": "object", "time": 10},
    {"question": "Where did I put the keys?", "answer": "in the drawer",
     "class": "location", "time": 20},
]


def _video(seed=0):
    from streamchat_tpu_torch.video.reader import SyntheticVideoReader

    return SyntheticVideoReader(total_frames=600, frame_rate=30, height=360, width=640,
                                seed=seed)


def run_slice(pipe, breakpoints, online=False):
    """The off-line main path (`process_video`), or with `online` the
    on-line one (`process_video_online`), at full width -> (results,
    seconds, prompt lengths)."""
    from streamchat_tpu_torch.memory.bank import MemoryBank

    lengths = []
    splice = pipe.model.splice_prompt

    def recording_splice(*a, **kw):
        embeds, n = splice(*a, **kw)
        lengths.append(n)
        return embeds, n

    pipe.model.splice_prompt = recording_splice
    process = pipe.process_video_online if online else pipe.process_video
    with tempfile.TemporaryDirectory() as d:
        bank = MemoryBank(os.path.join(d, "memory.json"), pipe.bank_embed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = process(_video(), breakpoints, bank, user_name="User")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    pipe.model.splice_prompt = splice
    if len(results) != len(breakpoints) or any(
            not isinstance(r["predict"], str) for r in results):
        raise AssertionError(f"expected {len(breakpoints)} answers, got {results}")
    return results, seconds, lengths


@contextlib.contextmanager
def _observed(pipe):
    """Counts, for one run: captions made (`pipe._caption` and its batch
    method) with each call's host-clock span, LongVA's generate calls, the
    most rows one K4 / K6 launch served (a kept graph's replays call no
    wrapper: its capture did), the chunked prefill's re-run windows, the host-clock span
    of each `encode_segment` call (ingest), each dedup's frames in and out,
    and each on-line `ask`'s seconds. The kernel wrappers still count their
    own launches."""
    from streamchat_tpu_torch.models import decoder, longva, paged_kv
    from streamchat_tpu_torch.pipeline import runner

    seen = {"captions": 0, "max_decode_rows": 0, "reruns": 0, "caption_spans": [],
            "ingest_spans": [], "dedup": [], "ask_s": [], "generate_calls": 0}
    cap, rerun, gen = pipe._caption, decoder._rerun_last, longva.generate_paged
    encode, dedup, session = runner.encode_segment, runner.dedup_segment, runner.StreamingSession
    seq = {n: getattr(paged_kv, n) for n in ("paged_decode_attention_seq",
                                              "paged_decode_attention_seq_int8")}

    def spanned(fn, spans):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((t0, time.perf_counter()))
        return wrapped

    def caption(chunk):
        seen["captions"] += 1
        return cap(chunk)

    def caption_batch(chunks):
        seen["captions"] += len(chunks)
        return cap.batch(chunks)

    def rows(fn):
        def wrapped(q, *a):
            seen["max_decode_rows"] = max(seen["max_decode_rows"], q.shape[0])
            return fn(q, *a)
        return wrapped

    def counted_rerun(*a):
        seen["reruns"] += 1
        return rerun(*a)

    def counted_generate(*a, **kw):
        seen["generate_calls"] += 1
        return gen(*a, **kw)

    def counted_dedup(features, threshold):
        out = dedup(features, threshold)
        seen["dedup"].append((int(features.shape[0]), int(out.shape[0])))
        return out

    class TimedSession(session):
        def ask(self, answer_fn):
            t0 = time.perf_counter()
            try:
                return super().ask(answer_fn)
            finally:
                seen["ask_s"].append(time.perf_counter() - t0)

    timed = spanned(caption, seen["caption_spans"])
    timed.batch = spanned(caption_batch, seen["caption_spans"])
    timed.batch_size = cap.batch_size
    pipe._caption, decoder._rerun_last = timed, counted_rerun
    runner.encode_segment = spanned(encode, seen["ingest_spans"])
    runner.dedup_segment, runner.StreamingSession = counted_dedup, TimedSession
    longva.generate_paged = counted_generate
    for n, fn in seq.items():
        setattr(paged_kv, n, rows(fn))
    try:
        yield seen
    finally:
        pipe._caption, decoder._rerun_last, longva.generate_paged = cap, rerun, gen
        runner.encode_segment, runner.dedup_segment = encode, dedup
        runner.StreamingSession = session
        for n, fn in seq.items():
            setattr(paged_kv, n, fn)


def _overlap_s(spans_a, spans_b):
    """Seconds in which a span of one list overlaps a span of the other."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0))
               for a0, a1 in spans_a for b0, b1 in spans_b)


@contextlib.contextmanager
def dedup_threshold(pipe, threshold):
    """The pipeline with VideoConfig.dedup_threshold = threshold for the block."""
    import dataclasses

    cfg = pipe.cfg
    pipe.cfg = cfg.replace(video=dataclasses.replace(cfg.video, dedup_threshold=threshold))
    try:
        yield
    finally:
        pipe.cfg = cfg


def measure_dedup(pipe, end_s):
    """The first segment's scene-change scores 1 - sim (K12 on its frame
    descriptors) -> (the median of frames 1.., the scores): as a threshold
    it drops some of the segment's frames and keeps others."""
    from streamchat_tpu_torch.ops.dedup import frame_descriptors, select_changed_frames
    from streamchat_tpu_torch.pipeline.ingest import encode_segment

    feats = encode_segment(pipe.model, _video(), 0, end_s, pipe.cfg.video,
                           pipe.cfg.memory.chunk_size)
    _, sim = select_changed_frames(frame_descriptors(feats), return_similarity=True)
    change = (1.0 - sim[1:]).float().cpu()
    return float(change.median()), change.tolist()


def drive(pipe, label, breakpoints, online=False, captions=None,
          caption_min=CAPTION_TOKENS_MIN):
    """One process_video run (`online`: process_video_online) with the
    launch counters zeroed before it and read after it -> its report. Some
    caption prompt must pass `caption_min` tokens (a chunk-40 caption). A
    caption_batch run (label `*_cb2`) must decode a 2-row caption group
    through K4 / K6 at B = 2 and take the chunked prefill's re-run branch;
    an on-line run must make `captions` captions where given (the off-line
    run's over the same breakpoints), and a dedup run (label `*_dedup`)
    must drop some frames and keep others and make one caption per
    chunk_size kept frames of each segment, rounded up. Every generate
    call must replay a graph, captured in it or kept from an earlier call
    at its key (the graph figures and the reserved GiB are printed)."""
    from streamchat_tpu_torch import kernels

    m = pipe.model
    m.gen_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _observed(pipe) as seen:
        results, seconds, lengths = run_slice(pipe, breakpoints, online)
    counts = kernels.launch_counts()
    k1_modes = kernels.launch_modes().get("fused_vit_layer", {})
    gs = m.gen_stats
    # A vanilla step emits one token; a verify step emits accepted_tokens /
    # verify_steps on average.
    emitted = gs.get("accepted_tokens", gs["decode_steps"])
    phases = pipe.last_phase_totals
    # The on-line path times no phases: its captions are timed from outside.
    caption_span_s = sum(t1 - t0 for t0, t1 in seen["caption_spans"])
    caption_s = phases.get("caption", caption_span_s)
    report = dict(
        seconds=seconds, answers=len(results), generated_tokens=gs["generated_tokens"],
        decode_ms_per_step=1e3 * gs["decode_s"] / gs["decode_steps"],
        decode_ms_per_emitted_token=1e3 * gs["decode_s"] / emitted,
        accepted_tokens_per_verify_step=(gs["accepted_tokens"] / gs["verify_steps"]
                                         if "verify_steps" in gs else None),
        prefill_tokens_per_s=gs["prompt_tokens"] / gs["prefill_s"],
        captions=seen["captions"], caption_s=caption_s,
        caption_s_per_caption=caption_s / max(seen["captions"], 1),
        batched_rows=gs.get("batched_rows", 0), max_decode_rows=seen["max_decode_rows"],
        prefill_reruns=seen["reruns"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, prompt_lengths=lengths,
        weight_bytes_per_token=_decode_weight_bytes(m.dec_params),
        kv_bytes_per_token_at_max_prompt=_kv_bytes_per_token(m.dec_cfg, max(lengths),
                                                             m.kv_int8),
        launches={n: c for n, c in counts.items() if c}, k1_modes=k1_modes,
        phase_totals=phases, generate_calls=seen["generate_calls"],
        graph_captures=gs.get("graph_captures", 0), graph_reuses=gs.get("graph_reuses", 0),
        graph_replays=gs.get("graph_replays", 0), capture_s=gs.get("capture_s", 0.0),
        reserved_gib=torch.cuda.memory_reserved() / 2**30)
    if online:
        report.update(
            ask_s=seen["ask_s"], worker_caption_s=caption_span_s,
            ingest_s=sum(t1 - t0 for t0, t1 in seen["ingest_spans"]),
            caption_ingest_overlap_s=_overlap_s(seen["caption_spans"], seen["ingest_spans"]),
            dedup_frames_in_out=seen["dedup"])
    print(f"{'process_video_online' if online else 'process_video'} [{label}]: "
          f"{json.dumps(report)}", flush=True)
    report["predictions"] = results          # stage 1's records, for the judge
    missing = [n for n in RUNS[label] if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"run {label}: kernels never launched: {missing}")
    if k1_modes != {INGEST_K1_MODE: counts["fused_vit_layer"]}:
        raise AssertionError(f"run {label}: ingest launched K1 as {k1_modes}, not only as "
                             f"{INGEST_K1_MODE}")
    if gs["generated_tokens"] == 0:
        raise AssertionError(f"run {label}: the main path generated no token")
    if (not report["graph_replays"]
            or report["graph_captures"] + report["graph_reuses"] < report["generate_calls"]):
        raise AssertionError(f"run {label}: its decode loops did not replay CUDA graphs: "
                             f"{report['graph_captures']} captures, "
                             f"{report['graph_reuses']} reuses, {report['graph_replays']} "
                             f"replays, {report['generate_calls']} generate calls")
    if label.endswith("_dedup"):
        kept = [k for _, k in seen["dedup"]]
        total = sum(n for n, _ in seen["dedup"])
        chunk = pipe.cfg.memory.chunk_size
        if not 0 < sum(kept) < total:
            raise AssertionError(f"run {label}: dedup kept {kept} of {total} frames")
        captions = sum(-(-k // chunk) for k in kept)
    elif max(lengths) <= caption_min:
        raise AssertionError(f"run {label}: no chunk-40 caption prompt over "
                             f"{caption_min} tokens: {lengths}")
    if captions is not None and seen["captions"] != captions:
        raise AssertionError(f"run {label}: {seen['captions']} captions, expected {captions}")
    if label.endswith("_cb2") and (report["batched_rows"] < 2 or seen["max_decode_rows"] < 2
                                   or seen["reruns"] < 1):
        raise AssertionError(f"run {label}: no 2-row caption group decoded at B = 2 through "
                             f"the row-order kernel with a prefill re-run: {seen}, "
                             f"batched rows {report['batched_rows']}")
    return report, counts


# Stage 1's answer and memory options: the uni-modal answer (the CLI's
# default) with --ppl on a tree that merges (interval 2, so the uni-modal
# search descends a summarized root at full width), the on-line mode with
# --ppl and a visual-token budget, the off-line mode at compress_rate 2
# (each frame's 24 x 24 patch grid pooled to 12 x 12: 5.9k-token
# chunk-40 captions, one K3 pass each, no K5), and MaxSim and the one-shot
# trees at mxbai-colbert-large width. Generations are cut to keep the
# script short: the uni-modal answer to 64 tokens (its default is 512),
# summaries to 32 (256).
UNIMODAL_PPL = dict(multi_modal_memory=False, ppl=True, memory=dict(interval=2),
                    sampling=dict(max_answer_tokens_unimodal=64, max_summary_tokens=32))
VISUAL_TOKEN_BUDGET = 1024
ONLINE_PPL = dict(ppl=True, sampling=dict(max_answer_tokens=64, max_summary_tokens=32,
                                          max_visual_tokens=VISUAL_TOKEN_BUDGET))
COMPRESS_2 = dict(ppl=True, memory=dict(compress_rate=2),
                  sampling=dict(max_answer_tokens=64, max_summary_tokens=32,
                                max_visual_tokens=VISUAL_TOKEN_BUDGET))
# A chunk-40 caption at compress_rate 2: 40 frames x 144 tokens and the text.
CAPTION_TOKENS_MIN_C2 = 5700
# search_features's f32 scores against a float64 host recomputation.
SEARCH_RTOL = 1e-5
# The plain twin of K3 in the NLL check runs by kv head and by query blocks
# of this many rows (the partial twin's global causal mask), so that its f32
# scores stay a few GB at a 17k-token pass.
PLAIN_QUERY_BLOCK = 2048


@contextlib.contextmanager
def configured(pipe, memory=None, sampling=None, **fields):
    """The pipeline with these PipelineConfig fields, and these fields of
    its MemoryConfig and SamplingConfig, changed for the block; its
    captioner and summarizer are remade from the new SamplingConfig."""
    from streamchat_tpu_torch.pipeline.answer import make_captioner, make_summarizer

    cfg, cap, summarize = pipe.cfg, pipe._caption, pipe._summarize
    pipe.cfg = cfg.replace(memory=dataclasses.replace(cfg.memory, **(memory or {})),
                           sampling=dataclasses.replace(cfg.sampling, **(sampling or {})),
                           **fields)
    pipe._caption = make_captioner(pipe.model, pipe.cfg.sampling)
    pipe._summarize = make_summarizer(pipe.model, pipe.cfg.sampling)
    try:
        yield
    finally:
        pipe.cfg, pipe._caption, pipe._summarize = cfg, cap, summarize


@contextlib.contextmanager
def _answer_observed(pipe):
    """Records, for one run: each `_answer` call, the visual tokens each
    answer spliced (the blocks of a generate call whose image entry is a
    list of blocks), each `search_features` walk (its tree, query, path
    and each level's scores) and each NLL pass (its inputs, its mean NLL
    and its K3 launches)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.memory.tree import VisualMemoryTree
    from streamchat_tpu_torch.models import scoring

    seen = {"answers": 0, "visual_tokens": [], "walks": [], "nll": []}
    walk, nll = VisualMemoryTree._feature_walk, scoring.sequence_nll
    gen = pipe.model.generate_with_image_embedding

    def recorded_walk(self, q):
        path, levels = walk(self, q)
        seen["walks"].append(dict(tree=self, query=q.clone(), path=path, levels=levels))
        return path, levels

    def recorded_nll(params, cfg, embeds, length, target_ids):
        before = kernels.launch_counts().get("flash_attention", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = nll(params, cfg, embeds, length, target_ids)
        value = float(out)
        seen["nll"].append(dict(
            params=params, cfg=cfg, embeds=embeds.clone(), length=length,
            target_ids=target_ids.clone(), nll=value, s=time.perf_counter() - t0,
            k3=kernels.launch_counts().get("flash_attention", 0) - before))
        return out

    def counted_answer(*a, **kw):
        seen["answers"] += 1
        return answer(*a, **kw)

    def recorded_gen(prompt, image_embeddings=None, **kw):
        if image_embeddings and isinstance(image_embeddings[0], list):
            seen["visual_tokens"].append([int(b.shape[0]) for b in image_embeddings[0]])
        return gen(prompt, image_embeddings=image_embeddings, **kw)

    answer = pipe._answer
    VisualMemoryTree._feature_walk, scoring.sequence_nll = recorded_walk, recorded_nll
    pipe._answer, pipe.model.generate_with_image_embedding = counted_answer, recorded_gen
    try:
        yield seen
    finally:
        VisualMemoryTree._feature_walk, scoring.sequence_nll = walk, nll
        del pipe._answer, pipe.model.generate_with_image_embedding


def _plain_attention_blocked(q, k, v, kv_length=None, *, causal=True):
    """K3's plain twin by kv head and by PLAIN_QUERY_BLOCK query rows (the
    partial twin with its global causal mask, normalized): the same
    function as `flash_attention_plain` at a fraction of its memory."""
    from streamchat_tpu_torch.ops.attention import flash_attention_partial_plain

    g = q.shape[1] // k.shape[1]
    out = torch.empty_like(q)
    for h in range(k.shape[1]):
        for r0 in range(0, q.shape[2], PLAIN_QUERY_BLOCK):
            qb = q[:, h * g:(h + 1) * g, r0:r0 + PLAIN_QUERY_BLOCK]
            acc, _, l = flash_attention_partial_plain(qb, k[:, h:h + 1], v[:, h:h + 1], r0, 0,
                                                      kv_length, causal=causal)
            out[:, h * g:(h + 1) * g, r0:r0 + PLAIN_QUERY_BLOCK] = (
                acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).to(q.dtype)
    return out


def check_nll_pass(rec):
    """A run's NLL pass recomputed from its recorded inputs on the kernels
    and on their plain twins (K3 by kv head and query block, W8 where the
    head runs it). Held: the T hidden rows that predict the targets, and
    their logits, within STEP_REL_L2 a row of the twins' (the limit of the
    script's other whole-stack outputs: a logit row's error against its
    own size, not against the ~-log V offset that every log-prob carries);
    the per-target log-probs at the kernels' tolerance (|d| <= ATOL + RTOL
    |plain|, relative L2 <= ROW_REL_L2); and the run's mean NLL reproduced.
    Two planted faults must fail: the logits 10% too large (as a wrong
    head scale makes them; what the log-prob check alone reads of it is
    reported), and the log-probs read at the targets shifted by one
    position. Also reported, not held: the rows one position early against
    the twins'.
    At random weights a 17k-token pass leaves rows that are mostly one
    shared vector, so a one-position slip moves them about as much as
    bf16 rounding through 28 layers does; the log-probs at shifted targets
    are what catch a slip."""
    from streamchat_tpu_torch.models import decoder, scoring

    args = (rec["params"], rec["cfg"], rec["embeds"], rec["length"], rec["target_ids"])
    n0, t = rec["length"], rec["target_ids"].long()
    n1 = n0 + t.numel()

    def one_pass():
        hidden = scoring.pass_hidden(*args)
        rows = hidden[n0 - 1:n1 - 1]
        logits = decoder.logits_from_hidden(rec["params"], rec["cfg"], rows)
        torch.cuda.synchronize()
        return rows, hidden[n0 - 2:n1 - 2], logits, torch.log_softmax(logits, dim=-1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, early, logits, ls = one_pass()
    kernel_s = time.perf_counter() - t0
    with _plain_twins(k3=_plain_attention_blocked):
        t0 = time.perf_counter()
        prows, _, plogits, pls = one_pass()
        plain_s = time.perf_counter() - t0
    m = dict(hidden_rows_rel_l2=_row_rel_l2(rows, prows),
             logits_rel_l2=_row_rel_l2(logits, plogits),
             planted_scaled_logits_rel_l2=_row_rel_l2(1.1 * logits, plogits),
             early_rows_rel_l2=_row_rel_l2(early, prows))
    if (not torch.isfinite(logits).all() or m["hidden_rows_rel_l2"] > STEP_REL_L2
            or m["logits_rel_l2"] > STEP_REL_L2):
        raise AssertionError(f"NLL pass past a row relative L2 of {STEP_REL_L2}: {m}")
    if m["planted_scaled_logits_rel_l2"] <= STEP_REL_L2:
        raise AssertionError(f"planted fault 'NLL pass logits 10% too large' passed the "
                             f"check: {m}")
    lp, ref = ls.gather(1, t[:, None])[:, 0], pls.gather(1, t[:, None])[:, 0]
    abs_err, rel = _compare("NLL pass per-target log-probs", lp, ref, row_rel=True)
    scaled = torch.log_softmax(1.1 * logits, dim=-1).gather(1, t[:, None])[:, 0]
    m["scaled_logits_logprob_rel_l2"] = _errors(scaled, ref, row_rel=True)[1]
    nll = -lp.mean().item()
    if abs(nll - rec["nll"]) > 1e-5 * abs(rec["nll"]):
        raise AssertionError(f"NLL pass: the run's mean NLL {rec['nll']!r}, recomputed {nll!r}")
    shifted = ls.gather(1, t.roll(1)[:, None])[:, 0]
    planted = _planted("NLL pass targets shifted by one position", shifted, ref)
    return dict(prompt_tokens=rec["length"], targets=int(t.numel()), nll=rec["nll"],
                ppl=math.exp(rec["nll"]), plain_nll=-ref.mean().item(),
                shifted_nll=-shifted.mean().item(), **m, max_abs_err=abs_err, rel_l2=rel,
                planted_shifted_rel_l2=planted, run_pass_s=rec["s"], kernel_pass_s=kernel_s,
                plain_pass_s=plain_s, k3_launches=rec["k3"])


def _host_descent(tree, scores_of):
    """The feature search's walk on the host: every summarized root
    descended by argmax of `scores_of(children)` (float64) -> (path,
    levels)."""
    import numpy as np

    path, levels = [], []
    for root in tree.roots:
        if root.depth == 0 or not root.children:
            continue
        node = root
        while node.children:
            s = scores_of(node.children)
            levels.append(s)
            path.append(node.centroids)
            node = node.children[int(np.argmax(s))]
        path.append(node.centroids)
    return path, levels


def check_feature_search(tree, query, path, levels):
    """`search_features` (f32 on the card) against a float64 host
    recomputation: the same path (the same node tensors) and each level's
    scores within SEARCH_RTOL. A child's score, the sum of q @ C^T, is
    recomputed as (sum of q's rows) . (sum of C's rows), equal in exact
    arithmetic."""
    import numpy as np

    d = query.shape[-1]
    qsum = query.reshape(-1, d).double().sum(0).cpu()

    def scores(children):
        return np.array([float(qsum @ c.centroids.reshape(-1, d).double().sum(0).cpu())
                         for c in children])

    hpath, hlevels = _host_descent(tree, scores)
    if len(hpath) != len(path) or any(a is not b for a, b in zip(hpath, path)):
        raise AssertionError(f"search_features: path of {len(path)} levels differs from the "
                             f"float64 host's {len(hpath)}")
    rel = max((float(np.max(np.abs(a - b) / np.abs(b))) for a, b in zip(levels, hlevels)),
              default=0.0)
    if rel > SEARCH_RTOL:
        raise AssertionError(f"search_features: scores {levels} vs float64 {hlevels}: "
                             f"relative error {rel} > {SEARCH_RTOL}")
    return dict(levels=len(path), path_tokens=[int(p.shape[0] * p.shape[1]) for p in path],
                query_rows=int(query.reshape(-1, d).shape[0]),
                scores=[s.tolist() for s in levels], max_rel_err=rel)


MAXSIM_CAPTIONS = ("Clip {}: a person walks to the table and puts a cup on it.",
                   "Clip {}: the person opens a drawer and drops the keys inside.",
                   "Clip {}: someone sits down on the sofa and reads a book.")


def check_maxsim(pipe, state, question):
    """MaxSim at mxbai-colbert-large width: the run's tree rebuilt with
    `from_state` on the card and `embed_tokens_fn` set, its texts (a fixed
    caption for a text without tokens) re-embedded token by token (one
    batched forward), `search_maxsim` run
    for the question's unpadded token states, against a float64 host MaxSim
    with the same zero-pad convention: the same captions and node tensors."""
    import numpy as np

    from streamchat_tpu_torch.memory.tree import VisualMemoryTree

    emb = pipe.tree_embedder
    tree = VisualMemoryTree.from_state(state, pipe.cfg.memory.num_clusters, 2, emb.embed,
                                       None, None, embed_tokens_fn=emb.embed_tokens,
                                       device=pipe.model.device)
    nodes = tree.all_nodes()
    # The random decoder's tokens are almost all >= 256, which the byte
    # tokenizer decodes to nothing: a node whose text has no token gets a
    # fixed caption of its own here (a BERT tokenizer's [CLS] / [SEP] give
    # a real caption at least two).
    substituted = 0
    for i, n in enumerate(nodes):
        if not emb.tokenizer.encode(n.text):
            n.text = MAXSIM_CAPTIONS[i % len(MAXSIM_CAPTIONS)].format(i)
            substituted += 1
    for n, t in zip(nodes, tree._token_embs([n.text for n in nodes])):
        n.token_emb = t
    hidden, mask = emb.embed_tokens([question])
    q = hidden[0][mask[0] > 0]
    t0 = time.perf_counter()
    feats, texts = tree.search_maxsim(q)
    search_s = time.perf_counter() - t0
    qn = q.double().cpu().numpy()
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)

    def best(cands):
        docs = [n.token_emb.astype(np.float64) for n in cands]
        td = max(x.shape[0] for x in docs)
        scores = []
        for x in docs:
            sim = qn @ (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)).T
            top = sim.max(axis=1)
            scores.append(float(np.sum(np.maximum(top, 0.0) if x.shape[0] < td else top)))
        return int(np.argmax(scores))

    hfeats, htexts = tree._descend(best)
    if htexts != texts or any(a is not b for a, b in zip(hfeats, feats)):
        raise AssertionError(f"search_maxsim: {texts} vs the float64 host's {htexts}")
    return dict(nodes=len(nodes), texts_substituted=substituted,
                query_tokens=int(q.shape[0]), levels=len(texts),
                token_rows=[int(n.token_emb.shape[0]) for n in nodes],
                width=int(q.shape[1]), search_s=search_s)


def check_one_shot_trees(pipe, run_tree, query):
    """The one-shot builders on the card: `build_top_down` over the first
    segment's features (chunk_size chunks, each k-means reduced: depth-0
    nodes only, so `search_features` finds nothing, as on the host), and
    `build_bottom_up` (interval 2) over the run tree's leaves' centroids and
    the top-down nodes', each searched with the run's query against the
    float64 host recomputation."""
    from streamchat_tpu_torch.memory.tree import VisualMemoryTree
    from streamchat_tpu_torch.pipeline.ingest import encode_segment

    mem = pipe.cfg.memory
    merge = pipe.new_tree()._merge
    feats = encode_segment(pipe.model, _video(), 0, BREAKPOINTS[0]["time"], pipe.cfg.video,
                           mem.chunk_size)
    t0 = time.perf_counter()
    top = VisualMemoryTree.build_top_down(feats, mem.chunk_size, mem.num_clusters, merge)
    leaves = [n.centroids for n in run_tree.all_nodes() if not n.children]
    bottom = VisualMemoryTree.build_bottom_up(leaves + [r.centroids for r in top.roots],
                                              mem.num_clusters, 2, merge)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s, "frames": int(feats.shape[0])}
    for label, tree in (("top_down", top), ("bottom_up", bottom)):
        path, levels = tree._feature_walk(query)
        out[label] = dict(roots=len(tree), depths=tree.counts_by_depth(),
                          **check_feature_search(tree, query, path, levels))
    if out["top_down"]["levels"] != 0 or out["bottom_up"]["levels"] != 3:
        raise AssertionError(f"one-shot trees: {out}")
    return out


def drive_answer_options(pipe, planted):
    """The three runs of stage 1's answer and memory options, each through
    `drive` (counters zeroed before, read after) -> (reports, counts)."""
    runs, counts = {}, {}
    with phase("process_video int8, uni-modal, --ppl, interval 2, 1 breakpoint"), \
            configured(pipe, **UNIMODAL_PPL), _answer_observed(pipe) as seen:
        runs["int8_unimodal_ppl"], counts["int8_unimodal_ppl"] = drive(
            pipe, "int8_unimodal_ppl", BREAKPOINTS[:1], caption_min=CAPTION_TOKENS_MIN)
        run_tree = pipe.last_tree
    report = runs["int8_unimodal_ppl"]
    if seen["answers"] != 1 or len(seen["walks"]) != 1 or len(seen["nll"]) != 1:
        raise AssertionError(f"uni-modal --ppl run: {seen['answers']} answers, "
                             f"{len(seen['walks'])} feature searches, {len(seen['nll'])} "
                             "NLL passes")
    with phase("uni-modal run: NLL pass and feature search held to their references"):
        walk = seen["walks"][0]
        report["feature_search"] = check_feature_search(walk["tree"], walk["query"],
                                                        walk["path"], walk["levels"])
        report["nll_pass"] = check_nll_pass(seen["nll"][0])
    if report["feature_search"]["levels"] < 2:
        raise AssertionError(f"uni-modal run: the search found no summarized root: "
                             f"{report['feature_search']}")
    if report["nll_pass"]["k3_launches"] != pipe.model.dec_cfg.num_layers:
        raise AssertionError(f"NLL pass: {report['nll_pass']['k3_launches']} K3 launches")
    planted["NLL pass logits 10% too large"] = \
        report["nll_pass"]["planted_scaled_logits_rel_l2"]
    planted["NLL pass targets shifted by one position"] = \
        report["nll_pass"]["planted_shifted_rel_l2"]
    print(f"planted fault rejected: NLL pass logits 10% too large: row relative L2 err "
          f"{report['nll_pass']['planted_scaled_logits_rel_l2']:.6g} (limit {STEP_REL_L2}; "
          f"its log-probs alone {report['nll_pass']['scaled_logits_logprob_rel_l2']:.6g}, "
          f"limit {ROW_REL_L2})")
    print(f"planted fault rejected: NLL pass targets shifted by one position: per-target "
          f"log-prob relative L2 err {report['nll_pass']['planted_shifted_rel_l2']:.6g} "
          f"(limit {ROW_REL_L2})")
    record = report["predictions"][0]
    print(f"uni-modal --ppl: answer prompt {report['prompt_lengths'][-2]} tokens, path "
          f"{report['feature_search']['path_tokens']} visual tokens beside "
          f"{seen['visual_tokens'][0][0]} of short memory, nll {record['nll']!r} ppl "
          f"{record['ppl']!r}, {report['seconds']:.3f} s, "
          f"{report['decode_ms_per_step']:.2f} decode ms/step: "
          f"{json.dumps({k: report[k] for k in ('nll_pass', 'feature_search')})}", flush=True)
    query = walk["query"]
    state = run_tree.to_state()

    for label, change, online in (("online_int8_ppl", ONLINE_PPL, True),
                                  ("int8_compress2_ppl", COMPRESS_2, False)):
        with phase(f"{'process_video_online' if online else 'process_video'} {label}, "
                   "1 breakpoint"), configured(pipe, **change), \
                _answer_observed(pipe) as seen:
            runs[label], counts[label] = drive(
                pipe, label, BREAKPOINTS[:1], online=online,
                caption_min=CAPTION_TOKENS_MIN if online else CAPTION_TOKENS_MIN_C2)
        report = runs[label]
        records = report["predictions"]
        if seen["answers"] != len(records) or any(
                not ({"nll", "ppl"} <= set(r)) for r in records):
            raise AssertionError(f"run {label}: {seen['answers']} answers through _answer, "
                                 f"records {records}")
        kept = seen["visual_tokens"][0]
        if (len(seen["visual_tokens"]) != 1 or len(seen["nll"]) != 1
                or seen["nll"][0]["length"] != report["prompt_lengths"][-2]):
            raise AssertionError(f"run {label}: answers of {seen['visual_tokens']} visual "
                                 f"tokens, prompts {report['prompt_lengths']}, NLL passes "
                                 f"over {[r['length'] for r in seen['nll']]}")
        if sum(kept) > VISUAL_TOKEN_BUDGET and len(kept) > 2:
            raise AssertionError(f"run {label}: {kept} over the budget beyond the finest level")
        report["visual_tokens_kept"] = kept
        report["nll_pass"] = dict(prompt_tokens=seen["nll"][0]["length"],
                                  k3_launches=seen["nll"][0]["k3"], s=seen["nll"][0]["s"])
        if not online:
            if counts[label].get("flash_attention_partial", 0):
                raise AssertionError(f"run {label}: K5 launched at compress_rate 2")
            vit = pipe.model.vit_cfg
            pooled = (vit.image_size // vit.patch_size // 2) ** 2
            rows = {int(n.centroids.shape[1]) for n in pipe.last_tree.all_nodes()}
            if rows != {pooled}:
                raise AssertionError(f"run {label}: tree nodes of {rows} tokens a frame, "
                                     f"not {pooled}")
        print(f"{label}: caption prompts {report['prompt_lengths'][:-2]}, visual tokens kept "
              f"{kept} (budget {VISUAL_TOKEN_BUDGET}), nll {records[0]['nll']!r} ppl "
              f"{records[0]['ppl']!r}, {report['seconds']:.3f} s, "
              f"{report['decode_ms_per_step']:.2f} decode ms/step", flush=True)

    with phase("MaxSim and the one-shot trees (mxbai-colbert-large width)"):
        runs["int8_unimodal_ppl"]["maxsim"] = check_maxsim(
            pipe, state, BREAKPOINTS[0]["question"])
        runs["int8_unimodal_ppl"]["one_shot_trees"] = check_one_shot_trees(
            pipe, run_tree, query)
    print(f"MaxSim: {json.dumps(runs['int8_unimodal_ppl']['maxsim'])}")
    print(f"one-shot trees: {json.dumps(runs['int8_unimodal_ppl']['one_shot_trees'])}",
          flush=True)
    return runs, counts


# H2O eviction (`LongVA.kv_budget_tokens`, ROADMAP §A 6) at LongVA-7B width
# on the int8 tree, through `LongVA.generate_with_image_embedding`: budget
# 8,192 on a chunk-40 caption prompt (40 frames of the synthetic video,
# ~23k tokens: compressed right after the dense prefill, K3 + K5), and
# budget 512 on a one-frame prompt with enough new tokens that the decode
# loop compresses again and again. Every budgeted step collects the
# attention mass through the plain gather (no kernel materializes the
# probabilities; the JAX package's dispatch takes XLA's gather there too).
H2O_RUNS = {8192: (40, 128), 512: (1, 300)}          # budget: (frames, new tokens)
H2O_SAME = (8192, 8, 16)          # no compression fires: budget, frames, steps
H2O_MASS_RTOL = 1e-4              # mass against float64, relative L2 a kv head
H2O_MERGE_ATOL = 1e-5             # merged K/V, card against CPU
H2O_MASS_STEP = 1                 # the step whose layer-0 mass is recomputed


def _frame_features(model, frames: int):
    """`frames` frames of the smoke video, evenly over its 20 s, through the
    ingest's K1 / K2 -> [frames * 576, 3584] bf16."""
    from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames

    idx = [int(i) for i in torch.linspace(0, 599, frames).tolist()]
    pixels = preprocess_frames(_video().read_frames(idx), model.vit_cfg.image_size,
                               device=model.device)
    feats = model.encode_images(pixels)
    return feats.reshape(-1, feats.shape[-1])


@contextlib.contextmanager
def _h2o_observed(plant_rope=False):
    """Records, for one generate call: the first `compress_kv` call's
    inputs and outputs (the prefill's), `_seed_hh_from_prompt`'s input keys
    and result at the first and last layer (host float64 copies), each in-loop
    compression's step, and for each decode step its RoPE positions, its
    cache length and pool pages in use, whether it collected mass, its
    mass's sum a (layer, kv head), its logits (first steps) and, at
    H2O_MASS_STEP, layer 0's query, gathered keys and mass. With
    `plant_rope` the step after each compression (the prefill's or the
    loop's) ropes at the cache length (the planted fault). The H2O loop and
    a run without a budget's vanilla loop run eagerly here (graph=False):
    the records read each step's values on the host, which a captured step
    cannot."""
    from streamchat_tpu_torch.models import generate_paged as gp
    from streamchat_tpu_torch.models import paged_kv
    from streamchat_tpu_torch.ops import decode_glue

    seen = {"compress_kv": [], "seed": None, "loop_compressions": [], "steps": []}
    kept = dict(ckv=gp.compress_kv, seed=gp._seed_hh_from_prompt, cp=gp.compress_paged_,
                step=gp.decode_step_paged, rope=decode_glue.bias_rope_append,
                gather=paged_kv.paged_decode_attention, loop=gp._decode_loop,
                loop_h2o=gp._decode_loop_h2o)
    state = {"in_step": None, "layer": 0, "after_compression": False}

    def ckv(k, v, score, length, **kw):
        out = kept["ckv"](k, v, score, length, **kw)
        state["after_compression"] = True
        if not seen["compress_kv"]:
            seen["compress_kv"].append(dict(k=k, v=v, score=score.clone(), length=int(length),
                                            kw=kw, out=out))
        return out

    def seed(cache, length, *a):
        out = kept["seed"](cache, length, *a)
        layers = (0, out.shape[0] - 1)
        seen["seed"] = dict(length=int(length),
                            keys={i: cache.k[i, 0].double().cpu() for i in layers},
                            mass={i: out[i].double().cpu() for i in layers})
        return out

    def cp(cache, hh, **kw):
        seen["loop_compressions"].append(len(seen["steps"]))
        state["after_compression"] = True
        return kept["cp"](cache, hh, **kw)

    def step(params, cfg, tok, cache, positions=None, collect_mass=False, **kw):
        rec = dict(positions=[], length=int(cache.length[0]), collect_mass=collect_mass,
                   pool_pages=int(cache.k_pages.shape[1]), next_free=int(cache.next_free),
                   true_position=None if positions is None else int(positions[0]),
                   kernel="gather" if collect_mass else
                   "K4" if kw.get("sequential_pages") else "K8", t0=time.perf_counter())
        if plant_rope and state["after_compression"]:
            positions = None
        state.update(in_step=rec, layer=0, after_compression=False)
        try:
            out = kept["step"](params, cfg, tok, cache, positions=positions,
                               collect_mass=collect_mass, **kw)
        finally:
            state["in_step"] = None
        if len(seen["steps"]) < H2O_SAME[2]:
            rec["logits"] = out[0].float().clone()
        if collect_mass:
            rec["mass_sums"] = out[2].sum(-1)
        seen["steps"].append(rec)
        return out

    def rope(*args):
        # bias_rope_append(q, k, v, bias, positions, theta, ..., page_table, length)
        if state["in_step"] is not None:
            positions, length = args[4], args[-1]
            state["in_step"]["positions"].append(
                (length if positions is None else positions).clone())
        return kept["rope"](*args)

    def gather(q, k_pages, v_pages, page_table, length, sm_scale=None, return_mass=False):
        out = kept["gather"](q, k_pages, v_pages, page_table, length, sm_scale, return_mass)
        if (return_mass and state["layer"] == 0 and len(seen["steps"]) == H2O_MASS_STEP
                and "mass_probe" not in seen):
            rows = k_pages[page_table[0].clamp_min(0).long()].transpose(0, 1)
            seen["mass_probe"] = dict(q=q[0, :, 0].double().cpu(), length=int(length[0]),
                                      keys=rows.reshape(rows.shape[0], -1, rows.shape[-1])
                                      .double().cpu(), mass=out[1][0].double().cpu())
        state["layer"] += 1
        return out

    gp.compress_kv, gp._seed_hh_from_prompt, gp.compress_paged_ = ckv, seed, cp
    gp.decode_step_paged, decode_glue.bias_rope_append = step, rope
    paged_kv.paged_decode_attention = gather
    gp._decode_loop = lambda *a, **kw: kept["loop"](*a, **dict(kw, graph=False))
    gp._decode_loop_h2o = lambda *a, **kw: kept["loop_h2o"](*a, **dict(kw, graph=False))
    try:
        yield seen
    finally:
        gp._decode_loop, gp._decode_loop_h2o = kept["loop"], kept["loop_h2o"]
        gp.compress_kv, gp._seed_hh_from_prompt = kept["ckv"], kept["seed"]
        gp.compress_paged_, gp.decode_step_paged = kept["cp"], kept["step"]
        decode_glue.bias_rope_append = kept["rope"]
        paged_kv.paged_decode_attention = kept["gather"]


def _h2o_generate(model, budget, feats, new, plant_rope=False, observe=True):
    """One `generate_with_image_embedding` call of the caption prompt over
    `feats` under `budget` (None: no budget), greedy, counters zeroed before
    it and read after it -> (report, seen, counts). `observe`: through
    `_h2o_observed` (eager steps); otherwise as the model runs it (graphed
    on the card). seen["ids"] holds the generated token ids."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.pipeline import prompts

    model.kv_budget_tokens = budget
    model.gen_stats.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with (_h2o_observed(plant_rope) if observe else contextlib.nullcontext(
                {"loop_compressions": None})) as seen, _decoded_ids(model) as ids:
            text = model.generate_with_image_embedding(
                prompts.build_caption_prompt(), [feats], max_new_tokens=new, temperature=0.0)
        torch.cuda.synchronize()
    finally:
        model.kv_budget_tokens = None
    seen["ids"] = ids
    gs = dict(model.gen_stats)
    report = dict(
        budget=budget, seconds=time.perf_counter() - t0, prompt_tokens=gs["prompt_tokens"],
        prefill_s=gs["prefill_s"], decode_steps=gs["decode_steps"],
        decode_ms_per_step=1e3 * gs["decode_s"] / gs["decode_steps"],
        generated_tokens=gs["generated_tokens"], text_chars=len(text),
        compressions_at_prefill=gs.get("compressions_at_prefill", 0),
        compressions_in_loop=gs.get("compressions_in_loop", 0),
        loop_compression_steps=seen["loop_compressions"],
        graph_captures=gs.get("graph_captures", 0), graph_replays=gs.get("graph_replays", 0),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        reserved_gib=torch.cuda.memory_reserved() / 2**30)
    return report, seen, kernels.launch_counts()


def _host_mass(q, keys, length, g):
    """Softmax mass of q [Hq, D] (or probes [Hkv, Q, D]) over keys [Hkv, L, D]
    masked at `length`, in float64 on the host, summed per kv head -> [Hkv, L]."""
    d = keys.shape[-1]
    if q.dim() == 2:
        q = q.reshape(keys.shape[0], g, d)
    s = torch.einsum("hqd,hld->hql", q, keys) * d ** -0.5
    s[:, :, length:] = float("-inf")
    return torch.softmax(s, dim=-1).sum(1)


def h2o_figures(cfg, seen, cap, new):
    """The checks every budgeted run of `new` tokens is held to -> (figures,
    passed): it takes all `new` steps; each ropes at its global position
    (prompt length + step); a step collects mass exactly while a later
    compression of the run is still to come, and runs K4 after the last
    (the pool stays in page order); each mass step's mass sums to g a
    (layer, kv head); the pool never holds more than cap / 128 pages nor
    maps past them; the seeded mass (first and last layer) and, where that
    step collects mass, H2O_MASS_STEP's layer-0 mass against float64 host
    recomputations. Also the mean host interval from one step's start to
    the next's, by the kernel the step ran (a step ends in a device sync)."""
    g = cfg.num_heads // cfg.num_kv_heads
    steps = seen["steps"]
    n0 = steps[0]["true_position"]
    pos_err = max(int((torch.stack(s["positions"]) - (n0 + i)).abs().max())
                  for i, s in enumerate(steps))
    last = max(seen["loop_compressions"], default=-1)
    expect = ["gather" if i < last else "K4" for i in range(len(steps))]
    wrong_kernel = sum(s["kernel"] != e for s, e in zip(steps, expect))
    sums = [s["mass_sums"] for s in steps if s["collect_mass"]]
    mass_sum_err = ((torch.stack(sums) - g).abs() / g).max().item() if sums else 0.0
    ms = {}
    for a, b in zip(steps, steps[1:]):
        ms.setdefault(a["kernel"], []).append(1e3 * (b["t0"] - a["t0"]))
    pages = cap // 128
    over = [s for s in steps if s["pool_pages"] != pages or s["next_free"] > pages]
    sd = seen["seed"]
    seed_err = 0.0
    for i, keys in sd["keys"].items():
        start = min(max(sd["length"] - 16, 0), keys.shape[1] - 16)
        ref = _host_mass(keys[:, start:start + 16], keys, sd["length"], g)
        seed_err = max(seed_err, _row_rel_l2(sd["mass"][i], ref))
    mp = seen.get("mass_probe")
    step_err = (_row_rel_l2(mp["mass"], _host_mass(mp["q"], mp["keys"], mp["length"], g))
                if mp else None)
    figures = dict(position_err=pos_err, steps=len(steps), wrong_kernel_steps=wrong_kernel,
                   mass_steps=len(sums), mass_sum_rel_err=mass_sum_err,
                   seeded_mass_rel_l2=seed_err, step_mass_rel_l2=step_err,
                   step_ms_by_kernel={k: sum(v) / len(v) for k, v in ms.items()},
                   max_pool_pages=max(s["pool_pages"] for s in steps),
                   max_next_free=max(s["next_free"] for s in steps), cap_pages=pages)
    passed = not (pos_err or wrong_kernel or len(steps) != new
                  or mass_sum_err > H2O_MASS_RTOL or over or seed_err > H2O_MASS_RTOL
                  or (H2O_MASS_STEP < last and not step_err <= H2O_MASS_RTOL))
    return figures, passed


def _kept_higher_index_ties(score, length, c, hh, recent, sink):
    """The planted selection: `kv_compress._kept_slots`' heavy hitters with
    ties broken toward the HIGHER slot (the stable sort run on the reversed
    scores)."""
    n = score.shape[1]
    pos = torch.arange(n, device=score.device)[None]
    s = score.float().masked_fill(pos >= length - recent, float("-inf"))
    s = s.masked_fill(pos < sink, float("inf"))
    order = torch.sort(s.flip(1), dim=1, descending=True, stable=True).indices
    return (n - 1 - order[:, :sink + hh]).sort(dim=1).values


def check_compress_kv(rec, merge_rec, planted):
    """`compress_kv` on the card against the CPU's, given the same inputs
    copied to the host: the 8,192-budget prefill's (all 28 x 4 heads of
    ~23k slots, its seeded scores) and the same slots under tied scores
    (integers 0-2: most slots tie): kept slots equal, kept K / V / scores
    bit-equal. Planted: ties broken toward the higher slot, which must keep
    another set. Reported beside it: how many slots `torch.topk` on the
    card would keep differently. Then the merges ("avg", "weighted") at the
    512-budget prefill's shapes, within H2O_MERGE_ATOL of the CPU's, on its
    keys rounded to integers (k * 2, so that every similarity is exact in
    f32 and both devices pick the same nearest heavy hitter) and its values
    in f32."""
    from streamchat_tpu_torch.ops import kv_compress

    kw, length = rec["kw"], rec["length"]
    c = kw["sink_size"] + kw["hh_size"] + kw["recent_size"]
    sel = dict(hh=kw["hh_size"], recent=kw["recent_size"], sink=kw["sink_size"])
    gen = torch.Generator().manual_seed(17)
    ties = torch.randint(0, 3, rec["score"].shape, generator=gen).float()
    dev = rec["k"].device
    out = {}
    for name, score in (("run_scores", rec["score"]), ("tied_scores", ties.to(dev))):
        got = kv_compress.compress_kv(rec["k"], rec["v"], score, length, **kw)
        ref = kv_compress.compress_kv(rec["k"].cpu(), rec["v"].cpu(), score.cpu(), length, **kw)
        keep = kv_compress._kept_slots(score, torch.tensor(length, device=dev), c,
                                       sel["hh"], sel["recent"], sel["sink"])
        keep_ref = kv_compress._kept_slots(score.cpu(), torch.tensor(length), c, sel["hh"],
                                           sel["recent"], sel["sink"])
        bad = [n for n, a, b in (("slots", keep, keep_ref), ("k", got[0], ref[0]),
                                 ("v", got[1], ref[1]), ("scores", got[2], ref[2]),
                                 ("length", got[3], ref[3])) if not torch.equal(a.cpu(), b)]
        if bad:
            raise AssertionError(f"compress_kv on the card differs from the CPU's ({name}): "
                                 f"{bad}")
        hi = _kept_higher_index_ties(score, length, c, sel["hh"], sel["recent"], sel["sink"])
        wrong = int((hi.cpu() != keep_ref[:, :sel["sink"] + sel["hh"]]).sum())
        pos = torch.arange(score.shape[1], device=dev)[None]
        masked = score.float().masked_fill(pos >= length - sel["recent"], float("-inf"))
        masked = masked.masked_fill(pos < sel["sink"], float("inf"))
        top = torch.topk(masked, sel["sink"] + sel["hh"], dim=1).indices.sort(dim=1).values
        out[name] = dict(heads=int(score.shape[0]), slots=int(score.shape[1]), kept=c,
                         higher_index_ties_slots_differing=wrong,
                         topk_slots_differing=int((top.cpu()
                                                   != keep_ref[:, :sel["sink"] + sel["hh"]])
                                                  .sum()))
        if name == "tied_scores":
            if wrong == 0:
                raise AssertionError("planted fault 'H2O ties broken toward the higher slot' "
                                     "kept the stable set")
            planted["H2O compress_kv ties broken toward the higher slot"] = float(wrong)
            print(f"planted fault rejected: H2O compress_kv ties broken toward the higher "
                  f"slot: {wrong} kept slots differ from the CPU's (limit 0)")
    mkw, mlen = merge_rec["kw"], merge_rec["length"]
    k = (merge_rec["k"].float() * 2).round()
    v = merge_rec["v"].float()
    for merge in ("avg", "weighted"):
        kwm = dict(mkw, merge=merge)
        got = kv_compress.compress_kv(k, v, merge_rec["score"], mlen, **kwm)
        ref = kv_compress.compress_kv(k.cpu(), v.cpu(), merge_rec["score"].cpu(), mlen, **kwm)
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(got[:2], ref[:2]))
        out[f"merge_{merge}"] = dict(max_abs_err=err, heads=int(k.shape[0]),
                                     slots=int(k.shape[1]))
        if not err <= H2O_MERGE_ATOL or not torch.equal(got[2].cpu(), ref[2]):
            raise AssertionError(f"compress_kv merge {merge!r}: card against CPU {err} past "
                                 f"{H2O_MERGE_ATOL}, or its scores differ")
    return out


def check_gather_step(model, feats, budget):
    """One decode step of the caption prompt over `feats`, prefilled and
    paged into a pool of `budget` / 128 pages, taken twice on copies of the
    pool: with `collect_mass` (the plain gather) and through K4. Held: the
    logits within STEP_REL_L2 a row, the K/V the step wrote at layer 0
    (before either attention) equal, the mass summing to g a (layer, kv
    head) within H2O_MASS_RTOL -> figures."""
    from streamchat_tpu_torch.models import decoder, generate, paged_kv
    from streamchat_tpu_torch.pipeline import prompts

    cfg, params = model.dec_cfg, model.dec_params
    embeds, n = model.splice_prompt(prompts.build_caption_prompt(), [feats])
    dense = decoder.KVCache.create(cfg, 1, embeds.shape[1], dtype=embeds.dtype,
                                   device=embeds.device)
    logits, dense = generate._prefill_inline(params, cfg, embeds, dense,
                                             torch.tensor([n], dtype=torch.int32,
                                                          device=embeds.device))
    pages = budget // 128
    base = paged_kv.allocate_pages(paged_kv.from_contiguous(dense, pages, pages),
                                   torch.ones(1, dtype=torch.int32, device=embeds.device))
    del dense
    tok = logits.argmax(-1)
    out = {}
    for name, kw in (("gather", dict(collect_mass=True)), ("K4", dict(sequential_pages=True))):
        cache = dataclasses.replace(base, k_pages=base.k_pages.clone(),
                                    v_pages=base.v_pages.clone(), length=base.length.clone())
        out[name] = (paged_kv.decode_step_paged(params, cfg, tok, cache, **kw), cache)
    (lg, gcache, mass), (lk, kcache) = out["gather"][0], out["K4"][0]
    g = cfg.num_heads // cfg.num_kv_heads
    slot = n // 128
    written = all(torch.equal(getattr(gcache, n)[0, slot], getattr(kcache, n)[0, slot])
                  for n in ("k_pages", "v_pages"))
    figures = dict(prompt_tokens=n, pool_pages=pages, logits_rel_l2=_row_rel_l2(lg, lk),
                   written_kv_equal=written,
                   mass_sum_rel_err=((mass.sum(-1) - g).abs() / g).max().item())
    if (not torch.isfinite(lg).all() or figures["logits_rel_l2"] > STEP_REL_L2
            or not figures["written_kv_equal"] or figures["mass_sum_rel_err"] > H2O_MASS_RTOL):
        raise AssertionError(f"H2O collect_mass step against K4: {figures}")
    return figures


def drive_h2o(pipe, planted):
    """H2O eviction at full width on the pipeline's model -> (report, counts):
    the H2O_RUNS budgets (each step's checks in `h2o_figures`; compression
    at prefill in both and in the loop at least twice at 512), each run
    again graphed, as the model runs it, with tokens and launch counts equal
    to the observed eager run's, `compress_kv`
    card against CPU (`check_compress_kv`), the planted fault of a step after
    a compression roped at the cache length (the small budget, 8 new
    tokens), and
    H2O_SAME: a budget under which no compression fires, so every step runs
    K4, whose first steps' logits must match the unbudgeted run's within
    STEP_REL_L2 a row while their tokens agree; then one collect_mass step
    against K4 on the same cache (`check_gather_step`)."""
    m = pipe.model
    cfg = m.dec_cfg
    report, counts, recs = {}, {}, {}
    big, small = H2O_RUNS
    for budget, (frames, new) in H2O_RUNS.items():
        label = "h2o_budget_large" if budget == big else "h2o_budget_small"
        feats = _frame_features(m, frames)
        with phase(f"H2O budget {budget}: {frames}-frame caption prompt, {new} new tokens"):
            rep, seen, counts[label] = _h2o_generate(m, budget, feats, new)
            figures, passed = h2o_figures(cfg, seen, -(-budget // 128) * 128, new)
        rep.update(figures)
        if not passed:
            raise AssertionError(f"H2O budget {budget}: {figures}")
        recs[budget] = seen["compress_kv"][0]
        with phase(f"H2O budget {budget}, graphed (the same call as the card runs it)"):
            graphed, gseen, gcounts = _h2o_generate(m, budget, feats, new, observe=False)
        rep["graphed"] = dict(
            {k: graphed[k] for k in ("seconds", "prefill_s", "decode_ms_per_step",
                                     "compressions_at_prefill", "compressions_in_loop",
                                     "graph_captures", "graph_replays", "peak_gib",
                                     "reserved_gib")},
            tokens_bit_equal=gseen["ids"] == seen["ids"], launches_equal=gcounts == counts[label])
        print(f"H2O [{label}] graphed: {graphed['decode_ms_per_step']:.3f} ms a step against "
              f"{rep['decode_ms_per_step']:.3f} eager (observed), "
              f"{graphed['graph_captures']} captures, {graphed['graph_replays']} replays, tokens "
              f"bit-equal {rep['graphed']['tokens_bit_equal']}, launches equal "
              f"{rep['graphed']['launches_equal']}  [{_smi()}]", flush=True)
        if (not rep["graphed"]["tokens_bit_equal"] or not rep["graphed"]["launches_equal"]
                or not graphed["graph_captures"] or not graphed["graph_replays"]
                or graphed["compressions_in_loop"] != rep["compressions_in_loop"]):
            raise AssertionError(f"H2O budget {budget} graphed against eager: {rep['graphed']}")
        del feats, seen, gseen
        missing = [n for n in RUNS[label] if counts[label].get(n, 0) == 0]
        k4 = counts[label].get("paged_decode_attention_seq", 0)
        if (missing or k4 != (new - rep["mass_steps"]) * cfg.num_layers
                or counts[label].get("paged_decode_attention_table", 0)
                or rep["compressions_at_prefill"] != 1
                or rep["compressions_in_loop"] < (2 if budget == small else 0)):
            raise AssertionError(f"{label}: kernels never launched {missing}, K4 launches "
                                 f"{k4} for {new - rep['mass_steps']} steps without mass, or "
                                 f"compressions {rep}")
        rep["launches"] = {n: c for n, c in counts[label].items() if c}
        report[label] = rep
        print(f"H2O [{label}]: {json.dumps(rep)}", flush=True)
    with phase("H2O compress_kv, card against CPU"):
        report["compress_kv"] = check_compress_kv(recs[big], recs[small], planted)
    del recs
    print(f"H2O compress_kv: {json.dumps(report['compress_kv'])}", flush=True)

    with phase("H2O planted: the step after a compression roped at the cache length"):
        feats = _frame_features(m, H2O_RUNS[small][0])
        _, seen, _ = _h2o_generate(m, small, feats, 8, plant_rope=True)
        figures, passed = h2o_figures(cfg, seen, -(-small // 128) * 128, 8)
    if passed:
        raise AssertionError("planted fault 'H2O step after a compression roped at the cache "
                             f"length' passed the check: {figures}")
    err = figures["position_err"]
    planted["H2O step after a compression roped at the cache length"] = float(err)
    print(f"planted fault rejected: H2O step after a compression roped at the cache length: "
          f"max RoPE position error {err} (limit 0)")

    budget, frames, steps = H2O_SAME
    feats = _frame_features(m, frames)
    with phase(f"H2O budget {budget} without a compression against no budget (K4)"):
        same, seen_b, cb = _h2o_generate(m, budget, feats, steps)
        plain, seen_k, ck = _h2o_generate(m, None, feats, steps)
    toks = [[int(s["logits"].argmax()) for s in x["steps"]] for x in (seen_b, seen_k)]
    agree = next((i for i, (a, b) in enumerate(zip(*toks)) if a != b), steps)
    rel = max(_row_rel_l2(a["logits"], b["logits"])
              for a, b in zip(seen_b["steps"][:agree + 1], seen_k["steps"][:agree + 1]))
    same.update(compressions=same["compressions_at_prefill"] + same["compressions_in_loop"],
                logits_rel_l2_vs_k4=rel, steps_compared=min(agree + 1, steps),
                greedy_agreement=f"{agree}/{steps}",
                k4_launches_budgeted=cb.get("paged_decode_attention_seq", 0),
                k4_launches_unbudgeted=ck.get("paged_decode_attention_seq", 0),
                decode_ms_per_step_k4=plain["decode_ms_per_step"],
                prefill_s_k4=plain["prefill_s"])
    with phase("H2O collect_mass step against K4 on one cache"):
        same["gather_step"] = check_gather_step(m, feats, budget)
    report["h2o_no_compression"] = same
    print(f"H2O [budget {budget}, no compression vs K4]: {json.dumps(same)}", flush=True)
    if (same["compressions"] or rel > STEP_REL_L2
            or same["k4_launches_budgeted"] != steps * cfg.num_layers
            or same["k4_launches_unbudgeted"] != steps * cfg.num_layers):
        raise AssertionError(f"H2O without a compression against K4: {same}")
    return report, counts


# The memory-free baseline and the cross-benchmark runners (ROADMAP §A 8),
# each CLI through its `main(argv)` on LongVA-7B loaded from the checkpoint
# the smoke wrote (`--model_name`; bf16, as the CLIs load it), over inputs
# the smoke writes: an mp4 of the smoke video's first 10 s, StreamBench /
# ActivityNet-QA / Video-Bench annotations over it, and two PNG frames with
# SEED-Bench v2 items. Answers are cut to RUNNER_NEW_TOKENS tokens.
RUNNER_NEW_TOKENS = 16
RUNNER_FRAMES = 300               # the smoke video's first 10 s
# Each CLI's output files and the keys the JAX package's CLI writes there.
RUNNER_SCHEMAS = {
    "baseline_prefix": ("json_list", {"time", "question", "label", "predict", "class",
                                      "process_time"}),
    "baseline_ego": ("jsonl", {"id", "question", "answer", "class", "pred"}),
    "videoqa_8": ("jsonl", {"id", "question", "answer", "pred"}),
    "videoqa_128": ("jsonl", {"id", "question", "answer", "pred"}),
    "videobench": ("json_dict", {"video_id", "question", "output_sequence"}),
    "seedbench": ("jsonl", {"question_id", "prediction", "gt", "q_type_id"}),
}


def _write_runner_inputs(d):
    """The runners' inputs under `d` -> {label: (module name, argv, output
    file, items)} (argv without --model_name)."""
    import cv2

    videos = os.path.join(d, "videos")
    os.makedirs(os.path.join(videos, "ego"))
    os.makedirs(os.path.join(d, "vb", "Eval_QA"))
    os.makedirs(os.path.join(d, "imgs"))
    out = os.path.join(d, "out")
    os.makedirs(out)
    frames = _video().read_frames(range(RUNNER_FRAMES))
    clip = os.path.join(videos, "ego", "clip.mp4")
    w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                        (frames.shape[2], frames.shape[1]))
    if not w.isOpened():
        raise RuntimeError("cv2 cannot write an mp4 here")
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    shutil.copy(clip, os.path.join(videos, "v_clip.mp4"))
    for name, i in (("a.png", 0), ("b.png", RUNNER_FRAMES // 2)):
        cv2.imwrite(os.path.join(d, "imgs", name), cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))

    def dump(name, obj):
        path = os.path.join(d, name)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f)
        return path

    qs = [(q["question"], q["answer"], q["class"]) for q in BREAKPOINTS]
    baseline = dump("baseline.json", [{"info": {"class_1": "ego", "video_path": "clip.mp4"},
                                       "breakpoint": [dict(question=q, answer=a, **{"class": c},
                                                           time=t)
                                                      for (q, a, c), t in zip(qs, (5, 10))]}])
    gt = [{"video_name": "clip", "question": q, "answer": a, "question_id": f"q{i}"}
          for i, (q, a, _) in enumerate(qs)]
    gt8, gt128 = dump("videoqa.json", gt), dump("videoqa_one.json", gt[:1])
    choices = {"A": "a cup", "B": "a phone", "C": "a book", "D": "nothing", "E": "keys"}
    with open(os.path.join(d, "vb", "Eval_QA", "MSVD_QA_new.json"), "w") as f:
        json.dump({f"MSVD_{n}": {"video_id": "clip", "vid_path": "v_clip.mp4",
                                 "question": qs[0][0],
                                 "choices": dict(list(choices.items())[:n])} for n in (4, 5)}, f)
    common = {"subpart": "Single-Image & Text Comprehension", "version": "v2"}
    seed = dump("seed.json", {"questions": [
        {"question_id": "s0", "question": "<img>What is on the table?", "choice_a": "a cup",
         "choice_b": "a set of keys", "choice_c": "nothing at all",
         "choice_d": "two people talking", "answer": "A", "question_type_id": 1,
         "data_source": "SEED-Bench v2", "data_id": "a.png", "level": "L1", **common},
        {"question_id": "s1", "question": "Which frame comes first?",
         "choice_a": "the first one", "choice_b": "the second one",
         "choice_c": "both at once", "choice_d": "neither of them", "answer": "A",
         "question_type_id": 2, "data_source": "cc3m", "data_id": ["a.png", "b.png"],
         "level": "L2", **common}]})
    new = ["--max_new_tokens", str(RUNNER_NEW_TOKENS)]
    qa = ["videoqa", "--video_dir", videos, "--output_dir", out]
    return {
        "baseline_prefix": ("baseline", ["--video_dir", videos, "--annotations", baseline,
                                         "--save_file", os.path.join(out, "prefix.json")] + new,
                            os.path.join(out, "prefix.json"), 2),
        "baseline_ego": ("baseline", ["--video_dir", videos, "--annotations", baseline,
                                      "--save_file", os.path.join(out, "ego.jsonl"), "--ego"]
                         + new, os.path.join(out, "ego.jsonl"), 2),
        "videoqa_8": ("bench_runners", qa + ["--gt_file_question", gt8, "--output_name",
                                             "videoqa8"] + new,
                      os.path.join(out, "videoqa8.json"), len(gt)),
        "videoqa_128": ("bench_runners", qa + ["--gt_file_question", gt128, "--output_name",
                                               "videoqa128", "--num_frame", "128"] + new,
                        os.path.join(out, "videoqa128.json"), 1),
        "videobench": ("bench_runners", ["videobench", "--eval_qa_root", os.path.join(d, "vb"),
                                         "--eval_video_root", videos, "--output_dir", out,
                                         "--datasets", "MSVD"] + new,
                       os.path.join(out, "MSVD_eval.json"), 2),
        "seedbench": ("bench_runners", ["seedbench", "--anno_path", seed, "--output_dir", out,
                                        "--cc3m_dir", os.path.join(d, "imgs"),
                                        "--seed_bench_dir", os.path.join(d, "imgs")],
                      os.path.join(out, "results_longva.json"), 2),
    }


@contextlib.contextmanager
def _runner_observed():
    """Records, for one CLI run: the model `LongVA.from_pretrained` loaded
    (with the byte tokenizer: the checkpoint carries none) and its seconds,
    each generate call's rows, padded prompt and tokens emitted, each NLL
    pass's value beside the same pass on the plain twins (K3's by kv head
    and query block), and seedbench's accuracy summary."""
    from streamchat_tpu_torch.models import longva, scoring
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
    from streamchat_tpu_torch.pipeline import bench_runners

    seen = {"generate": [], "nll": [], "load_s": None, "summary": None}
    load, gen, nll = longva.LongVA.from_pretrained, longva.generate_paged, scoring.sequence_nll
    run_seed = bench_runners.run_seedbench

    def from_pretrained(cls, path, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = load.__func__(cls, path, *a, tokenizer=ByteTokenizer(), **kw)
        torch.cuda.synchronize()
        seen["load_s"] = time.perf_counter() - t0
        return model

    def generate(params, cfg, embeds, lengths, *a, **kw):
        toks, count = gen(params, cfg, embeds, lengths, *a, **kw)
        seen["generate"].append(dict(rows=len(lengths), prompt=int(embeds.shape[1]),
                                     valid=int(lengths[0]), emitted=int(count[0])))
        return toks, count

    def sequence_nll(params, cfg, embeds, length, target_ids):
        out = nll(params, cfg, embeds, length, target_ids)
        with _plain_twins(k3=_plain_attention_blocked):
            plain = float(nll(params, cfg, embeds, length, target_ids))
        seen["nll"].append(dict(prompt=int(length), targets=int(target_ids.numel()),
                                nll=float(out), plain=plain))
        return out

    def seedbench(model, args):
        seen["summary"] = run_seed(model, args)
        return seen["summary"]

    longva.LongVA.from_pretrained = classmethod(from_pretrained)
    longva.generate_paged, scoring.sequence_nll = generate, sequence_nll
    bench_runners.run_seedbench = seedbench
    try:
        yield seen
    finally:
        longva.LongVA.from_pretrained = classmethod(load.__func__)
        longva.generate_paged, scoring.sequence_nll = gen, nll
        bench_runners.run_seedbench = run_seed


def _runner_records(kind, path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if kind == "jsonl":
        return [json.loads(line) for line in text.splitlines()]
    data = json.loads(text)
    return data if kind == "json_list" else list(data.values())


def drive_runners(ckpt, root):
    """Each runner CLI once through its `main(argv)` with `--model_name
    ckpt`, the launch counters zeroed before and read after each ->
    (report, counts). Held: each output file has the JAX CLI's records and
    keys, one per item; each answer emitted at least one token (its text is
    mostly empty: the random decoder's tokens lie past the byte tokenizer's
    256 bytes); the CLI launched K1, K3 and (with answers) K4, and K5 at
    128 frames (a 73.8k-token prompt); seedbench's NLLs within the kernels'
    tolerance of the plain twins' (|d| <= ATOL + RTOL |plain|), its
    predictions among A-D and its accuracy summary written as JSON."""
    import importlib

    from streamchat_tpu_torch import kernels

    d = os.path.join(root, "runners")
    os.makedirs(d)
    with phase("runner inputs (mp4, annotations, PNGs)"):
        runs = _write_runner_inputs(d)
    report, counts = {}, {}
    for label, (mod, argv, out_file, items) in runs.items():
        main = importlib.import_module(f"streamchat_tpu_torch.pipeline.{mod}").main
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with phase(f"runner {label}"), _runner_observed() as seen:
            t0 = time.perf_counter()
            main(argv + ["--model_name", ckpt])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts[label] = kernels.launch_counts()
        kind, keys = RUNNER_SCHEMAS[label]
        records = _runner_records(kind, out_file)
        rep = dict(seconds=seconds, load_s=seen["load_s"],
                   s_per_item=(seconds - seen["load_s"]) / items, items=len(records),
                   generate=seen["generate"], peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches={n: c for n, c in counts[label].items() if c})
        bad = [r for r in records if set(r) != keys]
        expect = ("fused_vit_layer", "flash_attention") + (
            () if label == "seedbench" else ("paged_decode_attention_seq",)) + (
            ("flash_attention_partial",) if label == "videoqa_128" else ())
        missing = [n for n in expect if counts[label].get(n, 0) == 0]
        if label == "seedbench":
            errs = [abs(r["nll"] - r["plain"]) - (ATOL + RTOL * abs(r["plain"]))
                    for r in seen["nll"]]
            rep.update(nll=seen["nll"], summary=seen["summary"])
            summary_path = os.path.join(os.path.dirname(out_file), "seed_accuracy.json")
            with open(summary_path, "w") as f:
                json.dump(seen["summary"], f)
            with open(summary_path) as f:
                written = json.load(f)
            if (len(seen["nll"]) != 4 * items or max(errs) > 0
                    or any(r["prediction"] not in "ABCD" for r in records)
                    or written["count"] != items):
                raise AssertionError(f"runner seedbench: {rep}, written {written}")
        elif (len(seen["generate"]) != items
              or any(g["emitted"] < 1 or g["rows"] != 1 for g in seen["generate"])):
            raise AssertionError(f"runner {label}: answers {seen['generate']}, {items} items")
        if bad or len(records) != items or missing:
            raise AssertionError(f"runner {label}: {len(records)} records of {items}, keys "
                                 f"{[sorted(r) for r in bad]} (expected {sorted(keys)}), "
                                 f"kernels never launched {missing}")
        report[label] = rep
        print(f"runner [{label}]: {json.dumps(rep)}", flush=True)
    return report, counts


# Stage 2 at the v0.3 defaults (`eval/judge.py`'s main: batch 8, 64 new
# tokens), bf16, then the judge's two options. The predictions are the
# first JUDGE_BATCH of the stage-1 runs' (repeated to fill one batch).
JUDGE_BATCH, JUDGE_NEW_TOKENS = 8, 64
JUDGE_RUNS = {"judge_bf16": (False, 0), "judge_int8": (True, 0),
              "judge_int8_spec4": (True, SPEC_TOKENS)}
# LLaMA-3-8B's W8 shapes at decode (in, out): q / o, k / v, gate / up, down,
# and the head (f32 out).
JUDGE_W8_SHAPES = {"q / o": (4096, 4096, torch.bfloat16), "k / v": (4096, 1024, torch.bfloat16),
                   "gate / up": (4096, 14336, torch.bfloat16),
                   "down": (14336, 4096, torch.bfloat16),
                   "head": (4096, 128256, torch.float32)}


@contextlib.contextmanager
def _plain_twins(k3=None):
    """Every kernel wrapper the judge's path reaches swapped for its plain
    twin where the path looks it up (K3, K5, W8, K7), for the block; `k3`
    in place of `flash_attention_plain` where given."""
    from streamchat_tpu_torch.models import decoder, spec_decode
    from streamchat_tpu_torch.ops import attention, paged_attention, quant

    swaps = [(decoder, "flash_attention", k3 or attention.flash_attention_plain),
             (decoder, "flash_attention_partial", attention.flash_attention_partial_plain),
             (quant, "qmatvec_int8", quant.qmatvec_int8_plain),
             (spec_decode, "paged_seq_attention_partial",
              paged_attention.paged_seq_attention_partial_plain)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _judge_observed():
    """Records, for one judge run: each K3 launch's (B, Hq, Hkv, S), each
    quantized projection's (rows, in, out, out dtype, GEMV regime), each K7
    call's (B, Hq, Hkv, T), the first generation call's inputs and the first
    decode (or verify) step's inputs and logits. The wrappers still count
    their own launches."""
    from streamchat_tpu_torch.models import decoder, generate, spec_decode, textlm
    from streamchat_tpu_torch.ops import quant

    seen = {"k3": [], "w8": [], "k7": [], "call": None, "first": None}
    flash, qmatmul = decoder.flash_attention, quant.qmatmul
    k7 = spec_decode.paged_seq_attention_partial
    gen, paged, dec, spec = (generate.generate, textlm.generate_paged, generate._decode_inline,
                             spec_decode.decode_step_spec)

    def k3(q, k, *a, **kw):
        seen["k3"].append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return flash(q, k, *a, **kw)

    def w8(x, q, out_dtype=None):
        n = x.numel() // x.shape[-1]
        seen["w8"].append((n, x.shape[-1], q["w_i8"].shape[1], out_dtype or x.dtype,
                           quant._kernel_rows(x, n)))
        return qmatmul(x, q, out_dtype)

    def partial(q, k_pages, *a):
        seen["k7"].append((q.shape[0], q.shape[1], k_pages.shape[1], q.shape[2]))
        return k7(q, k_pages, *a)

    def call(fn):
        def wrapped(params, cfg, embeds, seq_length, *a, **kw):
            if seen["call"] is None:
                seen["call"] = dict(embeds=embeds, seq_length=seq_length.clone(), kw=kw)
            return fn(params, cfg, embeds, seq_length, *a, **kw)
        return wrapped

    def first(fn):
        def wrapped(params, cfg, tokens, cache, *a):
            logits, cache = fn(params, cfg, tokens, cache, *a)
            if seen["first"] is None:
                seen["first"] = dict(tokens=tokens.clone(), args=[x.clone() for x in a],
                                     logits=logits.clone())
                if isinstance(cache, decoder.KVCache):      # the K/V it appended
                    seen["first"]["appended"] = _appended(cache)
                else:                                       # the K/V a verify step wrote
                    seen["first"]["appended"] = _appended_pages(cache, tokens.shape[1])
            return logits, cache
        return wrapped

    patches = [(decoder, "flash_attention", k3), (quant, "qmatmul", w8),
               (spec_decode, "paged_seq_attention_partial", partial),
               (generate, "generate", call(gen)), (textlm, "generate_paged", call(paged)),
               (generate, "_decode_inline", first(dec)),
               (spec_decode, "decode_step_spec", first(spec))]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield seen
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def _appended(cache):
    """K and V [2, L, B, Hkv, Dh] at each row's last slot (length - 1) of a
    dense cache: what its last decode step appended."""
    b = cache.length.shape[0]
    rows, slot = torch.arange(b, device=cache.k.device), cache.length.long() - 1
    return torch.stack([cache.k[:, rows, :, slot], cache.v[:, rows, :, slot]]).transpose(1, 2)


def _appended_pages(cache, t):
    """K and V [2, L, B, Hkv, T, Dh] at each row's slots length .. length +
    T - 1 of a paged pool: what a verify step of T tokens wrote there."""
    slot = cache.length.long()[:, None] + torch.arange(t, device=cache.length.device)
    page = cache.page_table.long().gather(1, slot // cache.page_size)
    off = slot % cache.page_size

    def at(pages):                # the indexed dims lead: [B, T, L, Hkv, Dh]
        return pages[:, page, :, off].permute(2, 0, 3, 1, 4)

    return torch.stack([at(cache.k_pages), at(cache.v_pages)])


@contextlib.contextmanager
def _commits_at_row0():
    """A verify step whose commits all land at row 0's positions (the
    planted fault), each row in its own pages; its attention stays right."""
    from streamchat_tpu_torch.models import spec_decode

    commit = spec_decode._commit_staged

    def at_row0(cache, *staged):
        row0 = torch.full_like(cache.length, int(cache.length[0]))
        commit(dataclasses.replace(cache, length=row0), *staged)

    spec_decode._commit_staged = at_row0
    try:
        yield
    finally:
        spec_decode._commit_staged = commit


def _per_row_rel_l2(got, ref):
    """The largest relative L2 error of one batch row (dim 2 of [2, L, B, ...])."""
    b = ref.shape[2]
    got, ref = (x.float().transpose(0, 2).reshape(b, -1) for x in (got, ref))
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _row_rel_l2(got, ref):
    d = ref.shape[-1]
    got, ref = got.float().reshape(-1, d), ref.float().reshape(-1, d)
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _appends_at_row0(params, cfg, tokens, cache):
    """A decode step whose appends all land at row 0's length (the planted
    fault): each row's RoPE position and attended length stay its own."""
    from streamchat_tpu_torch.models import decoder

    length = cache.length
    fake = decoder.KVCache(k=cache.k, v=cache.v, length=torch.full_like(length, int(length[0])))
    embeds = decoder.embed_tokens(params, tokens)[:, None, :]
    hidden, _ = decoder.forward(params, cfg, embeds, length[:, None], fake,
                                length + 1 - int(length[0]), decode=True)
    return decoder.logits_from_hidden(params, cfg, hidden)[:, 0]


def judge_first_step(lm, seen, spec: bool, plant: bool):
    """The run's first decode (or verify) step held to the same step on the
    kernels' plain twins from the same inputs (prefill included): its logits
    (row relative L2) and the K/V it wrote at each row's own positions (a
    decode step's one slot at its length, a verify step's T slots from its
    length; relative L2 a batch row), each within STEP_REL_L2 -> report
    entries. With `plant`, a step whose writes all land at row 0's positions
    must fail the same check: one missing key among ~1.5k moves random
    weights' logits little, and a verify step's logits not at all (it
    attends its staged K/V), the K/V at each row's slots much."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import (decoder, generate, generate_paged, spec_decode,
                                             step_graph)

    call, first = seen["call"], seen["first"]
    params, cfg = lm.params, lm.cfg
    embeds, seq_length, kw = call["embeds"], call["seq_length"], call["kw"]
    kernels.reset_launch_counts()
    with _plain_twins():
        if spec:
            ws, _, _ = generate_paged._generate_paged_split(      # a workspace of its own
                params, cfg, embeds, seq_length, max_new_tokens=kw["max_new_tokens"],
                page_size=128, kv_int8=False, spec_tokens=kw["spec_tokens"],
                claim=lambda *a: step_graph.Workspace(params, None, embeds.device))
            cache = ws.tensors["cache"]
            if plant:
                faulty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                             v_pages=cache.v_pages.clone())
                with _commits_at_row0():
                    bad, _ = spec_decode.decode_step_spec(params, cfg, first["tokens"], faulty,
                                                          *first["args"])
            ref, cache = spec_decode.decode_step_spec(params, cfg, first["tokens"], cache,
                                                      *first["args"])
            appended = lambda c: _appended_pages(c, first["tokens"].shape[1])  # noqa: E731
        else:
            appended = _appended
            b, s, _ = embeds.shape
            cache = decoder.KVCache.create(cfg, b, -(-(s + kw["max_new_tokens"]) // 128) * 128,
                                           dtype=embeds.dtype, device=embeds.device)
            _, cache = generate._prefill_inline(params, cfg, embeds, cache, seq_length)
            if plant:
                faulty = decoder.KVCache(k=cache.k.clone(), v=cache.v.clone(),
                                         length=cache.length.clone())
                bad = _appends_at_row0(params, cfg, first["tokens"], faulty)
                faulty.length = faulty.length + 1
            ref, cache = decoder.decode_step(params, cfg, first["tokens"], cache)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain path launched kernels: {kernels.launch_counts()}")

    def check(logits, written):
        rel = _row_rel_l2(logits, ref)
        kv = _per_row_rel_l2(written, appended(cache))
        ok = bool(torch.isfinite(logits).all()) and rel <= STEP_REL_L2 and kv <= STEP_REL_L2
        return ok, rel, kv

    ok, rel, kv = check(first["logits"], first["appended"])
    if not ok:
        raise AssertionError(f"judge first step vs the plain path: logits row relative L2 "
                             f"error {rel}, appended K/V {kv}: past {STEP_REL_L2}")
    agree = first["logits"].argmax(-1) == ref.argmax(-1)
    out = dict(first_step_logits_row_rel_l2=rel, first_step_appended_kv_rel_l2=kv,
               first_step_greedy_agreement=f"{int(agree.sum())}/{agree.numel()}")
    if plant:
        lengths = cache.length.tolist()
        bad_ok, bad_rel, bad_kv = check(bad, appended(faulty))
        if bad_ok or len(set(lengths)) < 2:
            raise AssertionError(f"planted fault 'judge {'verify' if spec else 'decode'} "
                                 "writes at row 0's positions' "
                                 f"passed the first-step check (logits {bad_rel}, appended "
                                 f"K/V {bad_kv}, row lengths {lengths})")
        out["planted_appends_at_row0"] = dict(logits_row_rel_l2=bad_rel,
                                              appended_kv_rel_l2=bad_kv)
    return out


def drive_judge(lm, label, pred_file, out_dir, plant=False):
    """Stage 2 (`eval.judge.judge_predictions` with `TextLM.generate_batch`
    at batch 8 and 64 new tokens) over the prediction file, the launch
    counters zeroed before and read after -> (report, counts). Every run
    must launch K3 once a layer and batch at 4 query heads a kv head; an
    int8 vanilla run W8 at every LLaMA-3-8B decode shape at 8 rows; a spec
    run K7 at 20 folded rows a kv head over 8 kv heads and 8 rows. The first
    step's logits are held to the plain path (`judge_first_step`)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.eval.judge import judge_predictions

    with open(pred_file, encoding="utf-8") as f:
        predictions = json.load(f)
    spec = lm.spec_tokens > 0
    lm.gen_stats.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out_path = os.path.join(out_dir, f"{label}.jsonl")
    with _judge_observed() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        judged = judge_predictions(
            predictions, lambda prompts: lm.generate_batch(prompts,
                                                           max_new_tokens=JUDGE_NEW_TOKENS),
            output_path=out_path, batch_size=JUDGE_BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    gs, cfg = lm.gen_stats, lm.cfg
    rows = JUDGE_BATCH
    emitted = gs.get("accepted_tokens", gs["decode_steps"] * rows)
    weight_bytes = _decode_weight_bytes(lm.params)
    w8_kernel = sorted({(n, kin, out, str(dt).replace("torch.", ""))
                        for n, kin, out, dt, kern in seen["w8"] if kern})
    report = dict(
        seconds=seconds, judged=len(judged), rows=rows,
        prompt_tokens=seen["call"]["embeds"].shape[1],
        prompt_lengths=seen["call"]["seq_length"].tolist(),
        prefill_s=gs["prefill_s"], decode_steps=gs["decode_steps"],
        decode_ms_per_step=1e3 * gs["decode_s"] / gs["decode_steps"],
        decode_ms_per_emitted_token=1e3 * gs["decode_s"] * rows / emitted,
        emitted_tokens_per_row_per_verify_step=(gs["accepted_tokens"] / gs["verify_steps"] / rows
                                                if spec else None),
        peak_gib=peak, weight_bytes_per_step=weight_bytes,
        weight_bound_ms_per_step=1e3 * weight_bytes / PEAK_BYTES,
        k3_launches=[list(x) for x in sorted(set(seen["k3"]))],
        k7_calls=[list(x) for x in sorted(set(seen["k7"]))],
        w8_kernel_shapes=[list(x) for x in w8_kernel],
        launches={n: c for n, c in counts.items() if c},
        graph_captures=gs.get("graph_captures", 0), graph_reuses=gs.get("graph_reuses", 0),
        graph_replays=gs.get("graph_replays", 0),
        reserved_gib=torch.cuda.memory_reserved() / 2**30)
    report.update(judge_first_step(lm, seen, spec, plant))
    report["spec_run_launched"] = ({"K4 paged_decode_attention_seq":
                                    counts.get("paged_decode_attention_seq", 0),
                                    "W8 qmatvec_int8": counts.get("qmatvec_int8", 0)}
                                   if spec else None)
    print(f"judge [{label}]: {json.dumps(report)}", flush=True)
    missing = [n for n in RUNS[label] if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"judge run {label}: kernels never launched: {missing}")
    prefills = JUDGE_BATCH if spec else 1                 # spec: one prefill a row
    if (counts["flash_attention"] != cfg.num_layers * prefills
            or {(hq // hkv) for _, hq, hkv, _ in seen["k3"]} != {4}):
        raise AssertionError(f"judge run {label}: K3 launches {counts['flash_attention']}, "
                             f"shapes {report['k3_launches']}: expected {cfg.num_layers} a "
                             "prefill at 4 query heads a kv head")
    if not report["graph_captures"] + report["graph_reuses"] or not report["graph_replays"]:
        raise AssertionError(f"judge run {label}: its decode loops did not replay CUDA graphs")
    if len(judged) != JUDGE_BATCH or gs["generated_tokens"] == 0:
        raise AssertionError(f"judge run {label}: {len(judged)} verdicts, "
                             f"{gs['generated_tokens']} tokens")
    with open(out_path, encoding="utf-8") as f:
        lines = [json.loads(line) for line in f]
    if [r["question"] for r in lines] != [p["question"] for p in predictions] or not all(
            "score" in r or r.get("judge_parse_error") for r in lines):
        raise AssertionError(f"judge run {label}: JSONL rows {lines}")
    if label == "judge_int8":
        have = {(kin, out, dt) for n, kin, out, dt, kern in seen["w8"] if kern and n == rows}
        lacking = [k for k, shape in JUDGE_W8_SHAPES.items() if shape not in have]
        if lacking:
            raise AssertionError(f"judge run {label}: W8 never ran at 8 rows at {lacking}")
    if spec and (SPEC_TOKENS + 1) * 4 not in {hq // hkv * t for b, hq, hkv, t in seen["k7"]
                                              if b == rows and hkv == 8}:
        raise AssertionError(f"judge run {label}: K7 calls {report['k7_calls']}: expected "
                             f"{(SPEC_TOKENS + 1) * 4} rows a kv head, 8 kv heads, B {rows}")
    return report, counts


def score_judged(out_dir, label):
    """Stage 3 (`eval.scoring.main`) over a judge run's JSONL -> its
    <name>_res.json entries, checked against the JSONL's rows."""
    from streamchat_tpu_torch.eval import scoring

    scoring.main(["--output_dir", out_dir, "--output_name", label])
    with open(os.path.join(out_dir, f"{label}_res.json"), encoding="utf-8") as f:
        res = {k: v for entry in json.load(f) for k, v in entry.items()}
    rows = scoring.read_jsonl(os.path.join(out_dir, f"{label}.jsonl"))
    if (list(res) != ["Yes count", "No count", "Unparseable count", "Accuracy",
                      "Average score"]
            or res["Unparseable count"] != sum(1 for r in rows if r.get("judge_parse_error"))
            or res["Yes count"] + res["No count"] + res["Unparseable count"] > len(rows)):
        raise AssertionError(f"scoring {label}: {res} over {len(rows)} rows")
    return res


# ---------------------------------------------------------------------------
# Checkpoints: the random trees written in the HF layout and read back
# ---------------------------------------------------------------------------

# torch dtype -> safetensors dtype name.
ST_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8",
             torch.bool: "BOOL"}
SHARD_BYTES = 5 * 10**9          # HF's default max_shard_size, "5GB"
WRITE_CHUNK = 64 << 20           # bytes a tensor crosses to the host at a time
VIT_PREFIX = "model.vision_tower.vision_tower.vision_model."
# The planted loader faults' checkpoint: the written decoder cut to two
# layers (at full width) and this many vocabulary rows.
FAULT_LAYERS, FAULT_VOCAB = 2, 4096


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def write_checkpoint(path, config, tensors, header_dtypes=None) -> int:
    """Write `tensors` (HF name -> tensor in HF's layout, on any device;
    views do) under `path` as an HF checkpoint: config.json and safetensors
    shards of at most SHARD_BYTES in the dict's order, one
    model.safetensors when they fit in one, else model-0000i-of-0000n
    files and model.safetensors.index.json. A shard is an 8-byte
    little-endian header length, the JSON header (each tensor's dtype,
    shape and data offsets, padded with spaces to 8 bytes) and the raw
    bytes; each tensor crosses to the host in WRITE_CHUNK pieces.
    `header_dtypes` (name -> dtype name) writes a tensor's bytes under
    another dtype's name, a planted fault. -> bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    shards, size = [[]], 0
    for name, t in tensors.items():
        if shards[-1] and size + _tensor_bytes(t) > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += _tensor_bytes(t)
    n = len(shards)
    files = (["model.safetensors"] if n == 1
             else [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)])
    written = 0
    for fname, names in zip(files, shards):
        header, pos = {"__metadata__": {"format": "pt"}}, 0
        for name in names:
            t = tensors[name]
            header[name] = {"dtype": (header_dtypes or {}).get(name, ST_DTYPES[t.dtype]),
                            "shape": list(t.shape),
                            "data_offsets": [pos, pos + _tensor_bytes(t)]}
            pos += _tensor_bytes(t)
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(struct.pack("<Q", len(blob)) + blob)
            for name in names:
                flat = tensors[name].contiguous().reshape(-1).view(torch.uint8)
                for i in range(0, flat.numel(), WRITE_CHUNK):
                    f.write(flat[i:i + WRITE_CHUNK].cpu().numpy())
        written += 8 + len(blob) + pos
    if n > 1:
        index = {"metadata": {"total_size": sum(map(_tensor_bytes, tensors.values()))},
                 "weight_map": {name: fname for fname, names in zip(files, shards)
                                for name in names}}
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    return written


def hf_decoder(p, prefix="model."):
    """The port's decoder tree -> HF names and layout ([out, in] linears, as
    transposed views)."""
    out = {prefix + "embed_tokens.weight": p["embed"]}
    for i, layer in enumerate(p["layers"]):
        q = f"{prefix}layers.{i}."
        out[q + "input_layernorm.weight"] = layer["input_norm"]
        for n in ("q", "k", "v", "o"):
            lin = layer["attn"][n]
            out[f"{q}self_attn.{n}_proj.weight"] = lin["w"].t()
            if "b" in lin:
                out[f"{q}self_attn.{n}_proj.bias"] = lin["b"]
        out[q + "post_attention_layernorm.weight"] = layer["post_norm"]
        for n in ("gate", "up", "down"):
            out[f"{q}mlp.{n}_proj.weight"] = layer["mlp"][n].t()
    out[prefix + "norm.weight"] = p["final_norm"]
    if "lm_head" in p:
        out["lm_head.weight"] = p["lm_head"].t()
    return out


def hf_vit(p, cfg, prefix=VIT_PREFIX):
    """The port's ViT tree -> HF CLIP names and layout: the merged q|k|v
    split into three projections, the patch matmul back into a conv."""
    d, ps = cfg.hidden_size, cfg.patch_size
    out = {prefix + "embeddings.class_embedding": p["class_embed"],
           prefix + "embeddings.patch_embedding.weight":
               p["patch_embed"]["w"].t().reshape(d, 3, ps, ps),
           prefix + "embeddings.position_embedding.weight": p["pos_embed"],
           prefix + "pre_layrnorm.weight": p["pre_ln"]["scale"],
           prefix + "pre_layrnorm.bias": p["pre_ln"]["bias"]}
    for i, layer in enumerate(p["layers"]):
        q = f"{prefix}encoder.layers.{i}."
        attn = layer["attn"]
        for j, n in enumerate("qkv"):
            out[f"{q}self_attn.{n}_proj.weight"] = attn["wqkv"][:, j * d:(j + 1) * d].t()
            out[f"{q}self_attn.{n}_proj.bias"] = attn["bqkv"][j * d:(j + 1) * d]
        for name, lin in (("self_attn.out_proj", attn["o"]), ("mlp.fc1", layer["mlp"]["fc1"]),
                          ("mlp.fc2", layer["mlp"]["fc2"])):
            out[f"{q}{name}.weight"], out[f"{q}{name}.bias"] = lin["w"].t(), lin["b"]
        for name, ln in (("layer_norm1", layer["ln1"]), ("layer_norm2", layer["ln2"])):
            out[f"{q}{name}.weight"], out[f"{q}{name}.bias"] = ln["scale"], ln["bias"]
    return out


def hf_projector(p, prefix="model.mm_projector."):
    return {prefix + "0.weight": p["fc1"]["w"].t(), prefix + "0.bias": p["fc1"]["b"],
            prefix + "2.weight": p["fc2"]["w"].t(), prefix + "2.bias": p["fc2"]["b"]}


def hf_bert(p, prefix=""):
    """The port's BERT tree -> HF names (under `prefix`, e.g. "bert.") and layout."""
    def lin(name, q):
        return {f"{name}.weight": q["w"].t(), f"{name}.bias": q["b"]}

    def ln(name, q):
        return {f"{name}.weight": q["scale"], f"{name}.bias": q["bias"]}

    out = {"embeddings.word_embeddings.weight": p["word_embed"],
           "embeddings.position_embeddings.weight": p["pos_embed"],
           "embeddings.token_type_embeddings.weight": p["type_embed"],
           **ln("embeddings.LayerNorm", p["embed_ln"])}
    for i, layer in enumerate(p["layers"]):
        q = f"encoder.layer.{i}."
        for n, hf in (("q", "attention.self.query"), ("k", "attention.self.key"),
                      ("v", "attention.self.value"), ("o", "attention.output.dense")):
            out.update(lin(q + hf, layer["attn"][n]))
        out.update(ln(q + "attention.output.LayerNorm", layer["attn_ln"]))
        out.update(lin(q + "intermediate.dense", layer["mlp"]["fc1"]))
        out.update(lin(q + "output.dense", layer["mlp"]["fc2"]))
        out.update(ln(q + "output.LayerNorm", layer["mlp_ln"]))
    return {prefix + k: v for k, v in out.items()}


def _decoder_fields(cfg) -> dict:
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
            "tie_word_embeddings": cfg.tie_embeddings, "hidden_act": "silu",
            "torch_dtype": "bfloat16"}


def longva_config(dec, vit) -> dict:
    """config.json of an llava_qwen checkpoint (Qwen2-7B's fields, LongVA's
    224k-token limit as tokenizer_model_max_length)."""
    return {"architectures": ["LlavaQwenForCausalLM"], "model_type": "llava_qwen",
            **_decoder_fields(dec), "max_position_embeddings": 32768,
            "tokenizer_model_max_length": dec.max_position_embeddings,
            "bos_token_id": dec.pad_token_id, "eos_token_id": dec.eos_token_id,
            "pad_token_id": dec.pad_token_id,
            "mm_vision_tower": "openai/clip-vit-large-patch14-336",
            "mm_hidden_size": vit.hidden_size, "mm_projector_type": "mlp2x_gelu",
            "mm_vision_select_layer": vit.select_layer}


def llama3_config(dec) -> dict:
    """config.json of LLaMA-3-8B-Instruct: an eos list, no pad token, an
    untied head."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            **_decoder_fields(dec), "max_position_embeddings": dec.max_position_embeddings,
            "bos_token_id": 128000, "eos_token_id": [128001, 128009]}


def bert_config(cfg) -> dict:
    return {"architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.layernorm_eps,
            "hidden_act": "gelu", "torch_dtype": "float32"}


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def leaf_mismatches(written, loaded, path="") -> list:
    """Paths where `loaded` differs from `written`: the tree's structure, or
    a leaf's shape, dtype, device or bits."""
    if isinstance(written, dict):
        if not isinstance(loaded, dict) or written.keys() != loaded.keys():
            return [path or "/"]
        return [m for k in written for m in leaf_mismatches(written[k], loaded[k],
                                                            f"{path}/{k}")]
    if isinstance(written, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(written) != len(loaded):
            return [path or "/"]
        return [m for i, (w, q) in enumerate(zip(written, loaded))
                for m in leaf_mismatches(w, q, f"{path}/{i}")]
    same = (isinstance(loaded, torch.Tensor) and loaded.shape == written.shape
            and loaded.dtype == written.dtype and loaded.device == written.device
            and torch.equal(_bits(loaded), _bits(written)))
    return [] if same else [path]


def _disk_checked(root, need, label):
    """Print the free space under `root` before a write; raise if it is short."""
    usage = shutil.disk_usage(root)
    print(f"disk before writing {label}: {usage.free} bytes free of {usage.total} under "
          f"{root}, {need} to write", flush=True)
    if usage.free < need + (1 << 30):
        raise RuntimeError(f"{label}: {usage.free} bytes free under {root}, {need} bytes "
                           "needed (and 1 GiB to spare)")


def _written(path, config, tensors, label) -> dict:
    """write_checkpoint with the disk checked first -> seconds and bytes."""
    _disk_checked(os.path.dirname(path), sum(map(_tensor_bytes, tensors.values())), label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = write_checkpoint(path, config, tensors)
    return {"write_s": time.perf_counter() - t0, "bytes": nbytes,
            "disk_bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))}


def _raw_read(paths) -> dict:
    """Every file under `paths` read once into one WRITE_CHUNK buffer: the
    load's yardstick."""
    buf, nbytes = bytearray(WRITE_CHUNK), 0
    t0 = time.perf_counter()
    for path in paths:
        for fname in sorted(os.listdir(path)):
            with open(os.path.join(path, fname), "rb", buffering=0) as f:
                while k := f.readinto(buf):
                    nbytes += k
    seconds = time.perf_counter() - t0
    return {"raw_read_s": seconds, "raw_read_bytes": nbytes, "raw_read_gbs": nbytes / seconds / 1e9}


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20      # KiB on Linux


def _checked(label, bad):
    if bad:
        raise AssertionError(f"{label}: {len(bad)} loaded leaves or configs differ from the "
                             f"written ones: {bad[:8]}")


def load_pipeline(written, root):
    """The random pipeline's three models written under `root` as HF
    checkpoints (LongVA-7B as llava_qwen bf16 shards, mxbai-colbert-large
    in f32 under a "bert." prefix, MiniLM-L6 in f32 without), then the
    pipeline built from them with `build_pipeline` (the byte tokenizer: the
    checkpoints carry none), every leaf and config held to the written
    ones -> (pipeline, paths, report)."""
    from streamchat_tpu_torch.config import ModelPaths, PipelineConfig
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
    from streamchat_tpu_torch.pipeline.runner import build_pipeline

    m, tree, bank = written.model, written.tree_embedder, written.bank_embedder
    models = {
        "longva": (longva_config(m.dec_cfg, m.vit_cfg),
                   {**hf_vit(m.vit_params, m.vit_cfg), **hf_projector(m.proj_params),
                    **hf_decoder(m.dec_params)}),
        "colbert": (bert_config(tree.cfg), hf_bert(tree.params, prefix="bert.")),
        "minilm": (bert_config(bank.cfg), hf_bert(bank.params)),
    }
    report = {"peak_rss_gib_before_write": _peak_rss_gib()}
    paths = {}
    for name, (config, tensors) in models.items():
        paths[name] = os.path.join(root, name)
        report[name] = _written(paths[name], config, tensors, name)
    report["peak_rss_gib_after_write"] = _peak_rss_gib()
    report.update(_raw_read(paths.values()))
    report["peak_rss_gib_after_raw_read"] = _peak_rss_gib()
    cfg = PipelineConfig(paths=ModelPaths(**paths))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16, geometry="longva7b",
                          tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    report["load_s"] = time.perf_counter() - t0
    report["peak_rss_gib_after_load"] = _peak_rss_gib()
    report["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    disk = sum(report[n]["disk_bytes"] for n in paths)
    report.update(disk_bytes=disk, load_gbs=disk / report["load_s"] / 1e9,
                  write_s=sum(report[n]["write_s"] for n in paths),
                  load_over_raw_read=report["load_s"] / report["raw_read_s"])
    report["write_gbs"] = disk / report["write_s"] / 1e9
    got = pipe.model
    bad = (leaf_mismatches(m.vit_params, got.vit_params, "vit")
           + leaf_mismatches(m.proj_params, got.proj_params, "projector")
           + leaf_mismatches(m.dec_params, got.dec_params, "decoder")
           + leaf_mismatches(tree.params, pipe.tree_embedder.params, "colbert")
           + leaf_mismatches(bank.params, pipe.bank_embedder.params, "minilm")
           + [n for n, a, b in (("vit_cfg", m.vit_cfg, got.vit_cfg),
                                ("dec_cfg", m.dec_cfg, got.dec_cfg),
                                ("colbert cfg", tree.cfg, pipe.tree_embedder.cfg),
                                ("minilm cfg", bank.cfg, pipe.bank_embedder.cfg)) if a != b])
    leaves = [t for tr in (m.vit_params, m.proj_params, m.dec_params, tree.params, bank.params)
              for t in _leaves(tr)]
    report.update(leaves=len(leaves), leaf_bytes=sum(map(_tensor_bytes, leaves)))
    print(f"checkpoint load [LongVA-7B, mxbai-colbert-large, MiniLM-L6]: {json.dumps(report)}",
          flush=True)
    _checked("pipeline checkpoints", bad)
    return pipe, paths, report


def check_loader_faults(model, root) -> dict:
    """Three planted writer faults, each in its own checkpoint of the written
    decoder cut to FAULT_LAYERS layers (at full width) and FAULT_VOCAB
    vocabulary rows: layer 1's q and k projections swapped, layer 0's o
    projection written without its transpose (square: the shape still
    fits), and layer 1's down projection's BF16 bytes under an F16 header.
    The leaf check must reject each, and pass the same checkpoint written
    without a fault -> fault name -> leaves that differ."""
    from streamchat_tpu_torch.models import weights

    p, cfg = model.dec_params, model.dec_cfg
    vocab = min(FAULT_VOCAB, cfg.vocab_size)
    cut = dataclasses.replace(cfg, num_layers=FAULT_LAYERS, vocab_size=vocab)
    tree = {"embed": p["embed"][:vocab], "layers": p["layers"][:FAULT_LAYERS],
            "final_norm": p["final_norm"], "lm_head": p["lm_head"][:, :vocab]}
    config = {"model_type": "qwen2", **_decoder_fields(cut),
              "max_position_embeddings": cut.max_position_embeddings,
              "eos_token_id": cut.eos_token_id, "pad_token_id": cut.pad_token_id}
    hf = hf_decoder(tree)
    qk = [f"model.layers.1.self_attn.{n}_proj.{w}" for n in "qk" for w in ("weight", "bias")]
    o0 = "model.layers.0.self_attn.o_proj.weight"
    cases = {
        "loader: no fault (control)": (hf, None),
        "loader: layer 1 q and k projections swapped in the writer": (
            {**hf, **dict(zip(qk, [hf[qk[2]], hf[qk[3]], hf[qk[0]], hf[qk[1]]]))}, None),
        "loader: layer 0 o projection written without its transpose": (
            {**hf, o0: tree["layers"][0]["attn"]["o"]["w"]}, None),
        "loader: layer 1 down projection's BF16 bytes under an F16 header": (
            hf, {"model.layers.1.mlp.down_proj.weight": "F16"}),
    }
    rejected = {}
    for name, (tensors, header_dtypes) in cases.items():
        path = os.path.join(root, "fault")
        write_checkpoint(path, config, tensors, header_dtypes)
        got_cfg, got = weights.load_decoder(path, p["final_norm"].dtype,
                                            device=p["final_norm"].device)
        shutil.rmtree(path)
        bad = leaf_mismatches(tree, got) + (["cfg"] if got_cfg != cut else [])
        if name.endswith("(control)"):
            _checked(name, bad)
        elif not bad:
            raise AssertionError(f"planted fault passed the leaf check: {name}")
        else:
            rejected[name] = bad
    return rejected


def load_judge(root):
    """LLaMA-3-8B at full width and depth: random (seeded), written under
    `root` as an HF llama checkpoint (bf16 shards), loaded back with
    `TextLM.from_pretrained` (the byte tokenizer) and every leaf and the
    config held to the written ones; the written tree and the directory are
    freed, after the tree's first TP_LAYERS layers are written at full width
    for the TP judge phase (report["tp_path"]) -> (TextLM, report)."""
    from streamchat_tpu_torch.config import DecoderConfig
    from streamchat_tpu_torch.models.textlm import TextLM
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer

    torch.cuda.reset_peak_memory_stats()
    cfg = DecoderConfig.llama3_8b()
    written = TextLM.init_random(cfg, seed=7, device="cuda")
    path = os.path.join(root, "llama3")
    report = {"peak_rss_gib_before_write": _peak_rss_gib()}
    report.update(_written(path, llama3_config(cfg), hf_decoder(written.params), "llama3"))
    report["peak_rss_gib_after_write"] = _peak_rss_gib()
    report.update(_raw_read([path]))
    report["peak_rss_gib_after_raw_read"] = _peak_rss_gib()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = TextLM.from_pretrained(path, tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    report["load_s"] = time.perf_counter() - t0
    report["peak_rss_gib_after_load"] = _peak_rss_gib()
    report["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report.update(load_gbs=report["disk_bytes"] / report["load_s"] / 1e9,
                  write_gbs=report["disk_bytes"] / report["write_s"] / 1e9,
                  load_over_raw_read=report["load_s"] / report["raw_read_s"],
                  shards=sorted(f for f in os.listdir(path) if f.endswith(".safetensors")))
    # The HF config's eos is a list (the loader takes its first) and it has
    # no pad token.
    expected = dataclasses.replace(cfg, eos_token_id=128001, pad_token_id=0)
    bad = leaf_mismatches(written.params, lm.params, "llama3") + (
        ["cfg"] if lm.cfg != expected else [])
    leaves = list(_leaves(written.params))
    report.update(leaves=len(leaves), leaf_bytes=sum(map(_tensor_bytes, leaves)))
    print(f"checkpoint load [LLaMA-3-8B]: {json.dumps(report)}", flush=True)
    _checked("LLaMA-3-8B checkpoint", bad)
    shutil.rmtree(path)
    report["tp_path"] = os.path.join(root, "llama3_tp")      # the TP judge phase's
    p = written.params
    _written(report["tp_path"], llama3_config(dataclasses.replace(cfg, num_layers=TP_LAYERS)),
             hf_decoder(dict(p, layers=p["layers"][:TP_LAYERS])), "llama3 (TP phases)")
    del written, p
    torch.cuda.empty_cache()
    return lm, report


def run_judge(predictions, root, smi, graphs):
    """Stages 2 and 3 at LLaMA-3-8B width from a checkpoint written under
    `root` and loaded back (`load_judge`): the three judge runs on one
    model (int8 made from the bf16 tree and the bf16 tree freed), then
    scoring over each run's JSONL, and after the bf16 and int8 runs the
    dense loop's graphed steps against eager ones at 8 rows
    (`drive_graphs`, into `graphs`) -> (reports, scores, counts, load
    report)."""
    preds = list(itertools.islice(itertools.cycle(predictions), JUDGE_BATCH))
    with phase("judge: write LLaMA-3-8B (random, seeded) and load it back"):
        lm, load = load_judge(root)
    n_params = sum(t.numel() for t in _leaves(lm.params))
    print(f"judge: {n_params} parameters, {_decode_weight_bytes(lm.params)} weight bytes a "
          f"decode step (bf16), {len(predictions)} stage-1 predictions", flush=True)
    reports, scores, counts = {}, {}, {}
    with tempfile.TemporaryDirectory() as d:
        pred_file = os.path.join(d, "predictions.json")
        with open(pred_file, "w", encoding="utf-8") as f:
            json.dump(preds, f)
        for label, (int8, spec_tokens) in JUDGE_RUNS.items():
            if int8 and "w_i8" not in lm.params["layers"][0]["attn"]["q"]:
                lm.quantize()                              # frees the bf16 tree
            lm.spec_tokens = spec_tokens
            with phase(f"stage 2: judge {label}"):
                reports[label], counts[label] = drive_judge(lm, label, pred_file, d,
                                                            plant=label != "judge_int8")
            with phase(f"stage 3: scoring {label}"):
                scores[label] = score_judged(d, label)
            if label in GRAPH_CASES:
                with phase(f"decode steps as CUDA graphs against eager steps ({label})"):
                    graphs[label], counts[f"graphs_{label}"] = drive_graphs(
                        lm.params, lm.cfg, lm.generator, label, smi)
    return reports, scores, counts, load


# Host offload, the ingest variants and the library modules no entry point
# calls (S2 and anyres, the host frameproc, the resamplers, optical flow,
# clustering), and the StreamBench tools.
OFFLOAD_FLAGS = ["--offload_chunks", "--offload_residents"]
CLI_REQUIRED = ["--video_dir", "v", "--memory_basic_dir", "m", "--save_file", "s.json",
                "--annotations", "a.json"]
# What may stay allocated around the parked first caption beyond what the
# check counts (the caching allocator's 512-byte rounding, small tensors).
OFFLOAD_SLACK_BYTES = 16 << 20
S2_FRAMES, S2_SCALES = 64, (336, 672)
# LLaVA-NeXT's anyres grid pinpoints (image_grid_pinpoints at base 336).
ANYRES_PINPOINTS = [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]]
# The JAX package's own bound for the host preprocessing against the
# device op (tests/test_native.py): mean |host - card| over the interior.
FRAMEPROC_MEAN_DIFF = 0.08
# f32 on the card against float64 on the host: the resamplers' row relative
# L2, optical flow's magnitudes relative to the largest, soft-DTW's relative
# error, k-means' centroids and knn's distances relative to their scale.
F64_REL = 1e-4
MIN_COSINE = 0.99


def _smoke_frames(n):
    """n frames of the smoke video, every ninth (uint8 [n, 360, 640, 3])."""
    return _video().read_frames(range(0, 9 * n, 9))


@contextlib.contextmanager
def _decoded_ids(model):
    """Records the token ids of every text the model's tokenizer decodes
    (every generation's output, in order)."""
    tok = model.tokenizer
    decode, seen = tok.decode, []

    def recording(ids, *a, **kw):
        seen.append([int(i) for i in ids])
        return decode(ids, *a, **kw)

    tok.decode = recording
    try:
        yield seen
    finally:
        del tok.decode


def _generator_states(pipe):
    return pipe.generator.get_state(), pipe.model.generator.get_state()


def offload_pipeline(pipe):
    """A pipeline over the same models whose memory config takes the
    offload flags as `config_from_args` parses them from the CLI
    (--offload_chunks --offload_residents), its other settings kept and
    its answers cut to 64 tokens, as the bf16 run's."""
    from streamchat_tpu_torch.pipeline import runner

    cli = runner.config_from_args(runner.parse_args(CLI_REQUIRED + OFFLOAD_FLAGS))
    memory = dataclasses.replace(pipe.cfg.memory, offload_chunks=cli.memory.offload_chunks,
                                 offload_residents=cli.memory.offload_residents)
    if not (memory.offload_chunks and memory.offload_residents):
        raise AssertionError(f"config_from_args({OFFLOAD_FLAGS}) -> {cli.memory}")
    cfg = pipe.cfg.replace(memory=memory,
                           sampling=dataclasses.replace(pipe.cfg.sampling, **SHORT_ANSWER))
    return runner.StreamChatPipeline(pipe.model, pipe.tree_embedder, pipe.bank_embedder, cfg)


@contextlib.contextmanager
def _offload_observed(pipe):
    """Device bytes allocated around the run's first update_memory: at its
    entry (the boxed feature stack held), at its first caption (the stack
    cut and freed, the chunks and the idle trees parked) and after it
    returns (the trees restored); the stack's bytes and whether it was
    still alive at the first caption; the bytes of what stays on the card
    (the caption's chunk, the short memory and the tree's nodes); the bytes
    parking the trees freed; the residents' seconds each way, the restore
    timed until its last byte arrived."""
    import weakref

    from streamchat_tpu_torch.pipeline import runner

    seen = {}
    update, cap, res = runner.update_memory, pipe._caption, pipe.residents
    offload, restore = res.offload, res.restore

    def observed_update(box, *a, **kw):
        first = "stack_bytes" not in seen
        if first:
            seen["stack_bytes"] = box[0].nbytes
            seen["stack"] = weakref.ref(box[0])
            seen["allocated_at_entry"] = torch.cuda.memory_allocated()
        tree, short = update(box, *a, **kw)
        if first:
            seen["allocated_after_restore"] = torch.cuda.memory_allocated()
            seen["short_bytes"] = short.nbytes
            seen["node_bytes"] = sum(n.centroids.nbytes for n in tree.all_nodes())
        return tree, short

    def caption(chunk):
        if "allocated_at_first_caption" not in seen:
            seen["allocated_at_first_caption"] = torch.cuda.memory_allocated()
            seen["group_bytes"] = chunk.nbytes
            seen["stack_alive_at_first_caption"] = seen["stack"]() is not None
            seen["residents_parked_at_first_caption"] = res.offloaded == set(res.names)
        return cap(chunk)

    def observed_offload(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        offload(*a, **kw)
        seen["residents_d2h_s"] = time.perf_counter() - t0
        seen["parking_freed_bytes"] = before - torch.cuda.memory_allocated()

    def observed_restore(*a, **kw):
        t0 = time.perf_counter()
        restore(*a, **kw)
        torch.cuda.synchronize()
        seen["residents_h2d_s"] = time.perf_counter() - t0

    caption.batch, caption.batch_size = cap.batch, cap.batch_size
    runner.update_memory, pipe._caption = observed_update, caption
    res.offload, res.restore = observed_offload, observed_restore
    try:
        yield seen
    finally:
        runner.update_memory, pipe._caption = update, cap
        del res.offload, res.restore


def residents_not_restored(off) -> list:
    """The names of the offloader's trees that are not back on the devices
    they came from, bit for bit (each tensor against its host copy)."""
    from streamchat_tpu_torch.utils.offload import tensors

    bad = []
    for name in off.names:
        obj, attr = off._entries[name]
        _, host, devices = off._host[name]
        got, host = tensors(getattr(obj, attr)), tensors(host)
        if (name in off.offloaded or len(got) != len(host)
                or any(t.device != dev or not torch.equal(t.cpu(), h)
                       for t, h, dev in zip(got, host, devices))):
            bad.append(name)
    return bad


def check_restore_fault(pipe) -> int:
    """Planted: a restore that skips the last registered tree must fail
    `residents_not_restored`; the tree is put back after."""
    from streamchat_tpu_torch.utils.offload import WeightOffloader

    class SkipsOne(WeightOffloader):
        def restore(self, names=None, block=False):
            super().restore(self.names[:-1], block)

    off = SkipsOne()
    for name, obj, attr in (("vit", pipe.model, "vit_params"),
                            ("projector", pipe.model, "proj_params"),
                            ("tree_embedder", pipe.tree_embedder, "params"),
                            ("bank_embedder", pipe.bank_embedder, "params")):
        off.register(name, obj, attr)
    off.offload()
    off.restore(block=True)
    bad = residents_not_restored(off)
    WeightOffloader.restore(off, block=True)
    if bad != ["bank_embedder"] or residents_not_restored(off):
        raise AssertionError(f"planted fault 'a restore that skips the bank embedder' "
                             f"passed the check ({bad})")
    return len(bad)


def drive_offload(pipe, base_ids, states, base_report):
    """process_video bf16 over the first breakpoint with --offload_chunks
    --offload_residents (through `config_from_args`), from the generator
    states the bf16 run started from -> (report, counts). Its captions'
    and answer's tokens must equal the bf16 run's; its stack must be gone
    and the idle trees parked by the first caption, with the device's
    allocated bytes down by at least the stack's and the trees' bytes less
    what stays on the card; every tree must come back bit for bit."""
    opipe = offload_pipeline(pipe)
    opipe.generator.set_state(states[0])
    pipe.model.generator.set_state(states[1])
    with _offload_observed(opipe) as seen, _decoded_ids(pipe.model) as ids:
        report, counts = drive(opipe, "bf16_offload", BREAKPOINTS[:1])
    res, stats = opipe.residents, opipe.last_offload_stats
    parked = res.host_bytes()
    kept = seen["group_bytes"] + seen["short_bytes"] + seen["node_bytes"]
    fall = seen["allocated_at_entry"] - seen["allocated_at_first_caption"]
    chunk_bytes = stats["bytes"] // 2                 # each chunk crosses both ways
    out = dict(
        stack_bytes=seen["stack_bytes"], residents_bytes=parked,
        parking_freed_bytes=seen["parking_freed_bytes"],
        allocated_at_entry=seen["allocated_at_entry"],
        allocated_at_first_caption=seen["allocated_at_first_caption"],
        allocated_after_restore=seen["allocated_after_restore"],
        fall_at_first_caption=fall, kept_on_card_bytes=kept,
        stack_alive_at_first_caption=seen["stack_alive_at_first_caption"],
        host_pinned_bytes=parked + chunk_bytes, chunks=stats["chunks"],
        chunks_d2h_s=stats["d2h_s"], chunks_h2d_s=stats["h2d_s"],
        chunks_d2h_gbs=_gbs(chunk_bytes, 1e3 * stats["d2h_s"]),
        chunks_h2d_gbs=_gbs(chunk_bytes, 1e3 * stats["h2d_s"]),
        residents_d2h_s=seen["residents_d2h_s"], residents_h2d_s=seen["residents_h2d_s"],
        residents_d2h_gbs=_gbs(parked, 1e3 * seen["residents_d2h_s"]),
        residents_h2d_gbs=_gbs(parked, 1e3 * seen["residents_h2d_s"]),
        generations=len(ids), tokens=sum(len(i) for i in ids),
        tokens_equal_to_bf16_run=ids == base_ids,
        seconds=report["seconds"], bf16_run_seconds=base_report["seconds"],
        **{k: report[k] for k in ("generate_calls", "graph_captures", "graph_reuses",
                                  "reserved_gib")})
    print(f"host offload [bf16, --offload_chunks --offload_residents]: {json.dumps(out)}",
          flush=True)
    bad = residents_not_restored(res)
    if ids != base_ids or not ids:
        raise AssertionError(f"offloaded run: {len(ids)} generations, tokens differ from "
                             f"the bf16 run's ({len(base_ids)} generations)")
    if (bad or seen["stack_alive_at_first_caption"]
            or not seen["residents_parked_at_first_caption"] or stats["chunks"] < 2
            or fall < seen["stack_bytes"] + parked - kept - OFFLOAD_SLACK_BYTES
            or seen["parking_freed_bytes"] < parked - OFFLOAD_SLACK_BYTES):
        raise AssertionError(f"host offload: trees not restored {bad}, {out}")
    return out, counts


def _s2_observed():
    """Records the first K1 launch of 256 frames (the 672 scale's tiles):
    its arguments, for a check of that launch alone."""
    from streamchat_tpu_torch.models import vit

    seen, layer = {}, vit.fused_vit_layer

    def recording(x, *a, **kw):
        if x.shape[0] == 4 * S2_FRAMES and "args" not in seen:
            seen["args"] = (x.clone(),) + a
            seen["kwargs"] = dict(kw)
        return layer(x, *a, **kw)

    return seen, recording


@contextlib.contextmanager
def _vit_twins():
    """K1 and K2's wrappers swapped for their plain twins where the ViT and
    the projectors look them up."""
    from streamchat_tpu_torch.models import projector, vit
    from streamchat_tpu_torch.ops.fused_vit import fused_ln_mlp_plain, fused_vit_layer_plain

    kept = vit.fused_vit_layer, projector.fused_ln_mlp
    vit.fused_vit_layer, projector.fused_ln_mlp = fused_vit_layer_plain, fused_ln_mlp_plain
    try:
        yield
    finally:
        vit.fused_vit_layer, projector.fused_ln_mlp = kept


def _min_cosine(got, ref):
    d = got.shape[-1]
    return torch.nn.functional.cosine_similarity(
        got.float().reshape(-1, d), ref.float().reshape(-1, d), dim=-1).min().item()


def _timed(fn, reps=3):
    """(result, seconds of the fastest of `reps` calls after a warm-up),
    each call ended by a device synchronize."""
    fn()
    best, out = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best


def drive_s2_anyres(model, g, frames):
    """(b) S2 ingest of the frames at scales (336, 672): 64 + 256 tiles
    through K1, then a 2048 -> 3584 mlp2x_gelu through K2, against the twin
    chain (min token cosine) and, at the 256-tile launch and the 2048-wide
    projector, each kernel against its plain twin (the kernels'
    tolerance); frames/s against single-scale ingest. (c) anyres on one
    frame with LLaVA-NeXT's pinpoints, its tiles encoded (K1, K2) and held
    to the twin chain -> (report, counts)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import projector, vit
    from streamchat_tpu_torch.ops.fused_vit import (fused_ln_mlp, fused_ln_mlp_plain,
                                                    fused_vit_layer, fused_vit_layer_plain)
    from streamchat_tpu_torch.pipeline import anyres
    from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames

    cfg, counts, out = model.vit_cfg, {}, {}
    pixels = preprocess_frames(torch.from_numpy(frames).cuda(), cfg.image_size)
    model.encode_images(pixels[:2])                   # the fold, if not done yet
    vp = model.vit_params
    proj = projector.init(len(S2_SCALES) * cfg.hidden_size, model.dec_cfg.hidden_size, g,
                          device=pixels.device)

    def s2():
        return projector.apply(proj, vit.encode_s2(vp, pixels, cfg, scales=S2_SCALES))

    with phase(f"S2 ingest, {S2_FRAMES} frames at {S2_SCALES}"):
        s2()
        seen, recording = _s2_observed()
        kernels.reset_launch_counts()
        vit.fused_vit_layer = recording
        try:
            got = s2()
        finally:
            vit.fused_vit_layer = fused_vit_layer
        counts["s2_ingest"] = kernels.launch_counts()
        _, s2_s = _timed(s2, reps=2)
        _, single_s = _timed(lambda: model.encode_images(pixels), reps=2)
        feats = vit.encode_s2(vp, pixels, cfg, scales=S2_SCALES)
        with _vit_twins():
            ref = s2()
        cos = _min_cosine(got, ref)
        k1_err, _ = _compare("K1 at the S2 tiles' shape", fused_vit_layer(
            *seen["args"], **seen["kwargs"]), fused_vit_layer_plain(
            *seen["args"], **seen["kwargs"]))
        flat = feats.reshape(-1, feats.shape[-1])
        k2_args = (flat, None, None, proj["fc1"]["w"], proj["fc1"]["b"], proj["fc2"]["w"],
                   proj["fc2"]["b"])
        k2_kw = dict(activation="gelu", layernorm=False, residual=False)
        k2_err, _ = _compare("K2 at 2048 -> 3584", fused_ln_mlp(*k2_args, **k2_kw),
                             fused_ln_mlp_plain(*k2_args, **k2_kw))
    k1 = counts["s2_ingest"]["fused_vit_layer"]
    blocks = cfg.num_layers + 1 + cfg.select_layer
    out["s2"] = dict(
        frames=S2_FRAMES, scales=S2_SCALES, tiles=S2_FRAMES * (1 + 4), shape=list(got.shape),
        k1_launches=k1, k2_launches=counts["s2_ingest"]["fused_ln_mlp"],
        k1_256_tiles_max_abs_err=k1_err, k2_2048_max_abs_err=k2_err,
        min_token_cosine_vs_twin_chain=cos, s2_s=s2_s, single_scale_s=single_s,
        s2_frames_per_s=S2_FRAMES / s2_s, single_scale_frames_per_s=S2_FRAMES / single_s)
    print(f"S2 ingest: {json.dumps(out['s2'])}", flush=True)
    if (tuple(got.shape) != (S2_FRAMES, cfg.num_patches, model.dec_cfg.hidden_size)
            or not torch.isfinite(got).all() or cos < MIN_COSINE or k1 != 2 * blocks
            or counts["s2_ingest"]["fused_ln_mlp"] != 1):
        raise AssertionError(f"S2 ingest: {out['s2']}")
    del got, ref, feats, flat, seen
    torch.cuda.empty_cache()

    with phase("anyres: one 360x640 frame, LLaVA-NeXT pinpoints"):
        frame = frames[0]
        h, w = frame.shape[:2]
        t0 = time.perf_counter()
        tiles = anyres.process_anyres_image(frame, ANYRES_PINPOINTS, cfg.image_size)
        host_s = time.perf_counter() - t0
        best = anyres.select_best_resolution((w, h), ANYRES_PINPOINTS)
        grid = anyres.get_anyres_image_grid_shape((w, h), ANYRES_PINPOINTS, cfg.image_size)
        x = torch.from_numpy(tiles).cuda()
        kernels.reset_launch_counts()
        emb = model.encode_images(x)
        counts["anyres"] = kernels.launch_counts()
        with _vit_twins():
            ref = model.encode_images(x)
        cos = _min_cosine(emb, ref)
    out["anyres"] = dict(image=[h, w], best_resolution=list(best), grid=list(grid),
                         tiles=int(tiles.shape[0]), host_s=host_s, shape=list(emb.shape),
                         min_token_cosine_vs_twin_chain=cos,
                         k1_launches=counts["anyres"]["fused_vit_layer"],
                         k2_launches=counts["anyres"]["fused_ln_mlp"])
    print(f"anyres: {json.dumps(out['anyres'])}", flush=True)
    if (tiles.shape != (1 + grid[0] * grid[1], 3, cfg.image_size, cfg.image_size)
            or not torch.isfinite(emb).all() or cos < MIN_COSINE
            or counts["anyres"]["fused_vit_layer"] != blocks):
        raise AssertionError(f"anyres: {out['anyres']}")
    return out, counts


def drive_frameproc(frames):
    """(d) The host frameproc, built from the checkout's copy of the C++
    source, against the card's `preprocess_frames` on the same frames:
    interior mean difference under the JAX package's bound; frames/s of
    each (the card's with the frames' upload)."""
    from streamchat_tpu_torch.native import frameproc
    from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames

    with phase("frameproc: build, then the host against the card"):
        built = frameproc.build(force=True)
        frameproc.library()
        host, host_s = _timed(lambda: frameproc.preprocess_frames_host(frames, 336), reps=2)
        card, card_s = _timed(lambda: preprocess_frames(torch.from_numpy(frames).cuda(), 336),
                              reps=2)
        diff = (torch.from_numpy(host) - card.cpu()).abs()
        mean = diff[:, :, 2:-2, 2:-2].mean().item()
    out = dict(build_s=built["seconds"], frames=len(frames), shape=list(host.shape),
               interior_mean_abs_diff=mean, max_abs_diff=diff.max().item(),
               host_frames_per_s=len(frames) / host_s, host_threads=os.cpu_count(),
               card_frames_per_s=len(frames) / card_s)
    print(f"frameproc: {json.dumps(out)}", flush=True)
    if not mean < FRAMEPROC_MEAN_DIFF:
        raise AssertionError(f"frameproc against the card: {out}")
    return out


def _f64_rel(got, ref):
    """Max row relative L2 of a card result against a float64 host one."""
    got, ref = got.double().cpu(), ref.double()
    d = ref.shape[-1]
    return ((got - ref).reshape(-1, d).norm(dim=-1)
            / ref.reshape(-1, d).norm(dim=-1).clamp_min(1e-12)).max().item()


def _card_ms(fn, iters=5):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def drive_library_ops(g, frames):
    """(e) Perceiver (dim 1024, depth 6, 64 latents) and Q-Former (bert-base,
    32 queries, vision width 1024) over 16 x 576 features; (f) optical flow
    over the frames (each shown twice, so every other pair is static); (g)
    k-means, knn and soft-DTW; each on the card in f32 against the same
    code in float64 on the host -> report."""
    from streamchat_tpu_torch.models import resampler
    from streamchat_tpu_torch.ops import clustering, optical_flow
    from streamchat_tpu_torch.utils.offload import map_tensors

    out = {}
    with phase("resamplers: Perceiver and Q-Former, card against float64"):
        gh = torch.Generator().manual_seed(5)
        feats = torch.randn(16, 576, 1024, generator=gh)
        for name in ("perceiver", "qformer"):
            params, apply = resampler.build_parametric(name, 1024, gh)
            card = map_tensors(lambda t: t.cuda(), params)
            x = feats.cuda()
            got = apply(card, x)
            ref = apply(map_tensors(lambda t: t.double(), params), feats.double())
            out[name] = dict(shape=list(got.shape), row_rel_l2_vs_f64=_f64_rel(got, ref),
                             ms=_card_ms(lambda: apply(card, x)))
    with phase("optical flow: 64 frames at 360x640, card against float64"):
        rgb = torch.from_numpy(frames[: S2_FRAMES // 2]).repeat_interleave(2, 0)
        rgb = rgb.permute(0, 3, 1, 2)
        gray = optical_flow.grayscale(rgb.cuda())
        mags = optical_flow.flow_magnitude(gray[:-1], gray[1:])
        gray64 = optical_flow.grayscale(rgb.double())
        mags64 = optical_flow.flow_magnitude(gray64[:-1], gray64[1:])
        ordered = torch.sort(mags64).values
        cut = int(torch.argmax(ordered[1:] - ordered[:-1]))
        threshold = float(ordered[cut] + ordered[cut + 1]) / 2
        keep = optical_flow.keep_frames_optical_flow(gray, threshold).cpu()
        keep64 = optical_flow.keep_frames_optical_flow(gray64, threshold)
        out["optical_flow"] = dict(
            frames=int(gray.shape[0]), magnitude_range=[ordered[0].item(), ordered[-1].item()],
            rel_err_vs_f64=((mags.double().cpu() - mags64).abs().max()
                            / mags64.abs().max()).item(),
            threshold=threshold, kept=int(keep.sum()), keep_equal=bool(torch.equal(keep, keep64)),
            ms=_card_ms(lambda: optical_flow.flow_magnitude(gray[:-1], gray[1:])))
    with phase("clustering: k-means, knn, soft-DTW, card against float64"):
        centers = torch.randn(16, 64, generator=gh) * 10.0
        x = (centers.repeat_interleave(256, 0) + torch.randn(4096, 64, generator=gh))
        # One initial row in each blob: Lloyd's then settles on the blobs, and
        # no point lies near a boundary that f32 rounding could move.
        idx = torch.arange(16) * 256 + torch.randint(0, 256, (16,), generator=gh)
        c, labels = clustering.kmeans(x.cuda(), num_clusters=16, init_idx=idx)
        c64, labels64 = clustering.kmeans(x.double(), num_clusters=16, init_idx=idx)
        points = torch.randn(4096, 64, generator=gh)
        points[101], points[3000] = points[7], points[7]        # planted exact ties
        queries = torch.cat([points[7:8] + 1e-3, torch.randn(255, 64, generator=gh)])
        d, i = clustering.knn(queries.cuda(), points.cuda(), k=8)
        d64 = clustering.pairwise_distances(queries.double(), points.double(), "sq_euclidean")
        ranked = torch.sort(d64, dim=1).values[:, :8]
        chosen = d64.gather(1, i.cpu())
        scale = ranked.abs().max().item()
        xs = torch.randn(8, 64, 16, generator=gh)
        ys = torch.randn(8, 48, 16, generator=gh)
        sd = clustering.pairwise_soft_dtw(xs.cuda(), ys.cuda())
        sd64 = clustering.pairwise_soft_dtw(xs.double(), ys.double())
        out["clustering"] = dict(
            kmeans_labels_equal=bool(torch.equal(labels.cpu().long(), labels64.long())),
            kmeans_centroid_err=((c.double().cpu() - c64).abs().max() / c64.abs().max()).item(),
            knn_distance_err=((d.double().cpu() - ranked).abs().max() / scale).item(),
            knn_chosen_err=((chosen - ranked).abs().max() / scale).item(),
            knn_planted_ties=i[0, :3].tolist(),
            soft_dtw_rel_err=((sd.double().cpu() - sd64).abs() / sd64.abs()).max().item(),
            kmeans_ms=_card_ms(lambda: clustering.kmeans(x.cuda(), num_clusters=16,
                                                         init_idx=idx)),
            knn_ms=_card_ms(lambda: clustering.knn(queries.cuda(), points.cuda(), k=8)),
            soft_dtw_ms=_card_ms(lambda: clustering.pairwise_soft_dtw(xs.cuda(), ys.cuda())))
    print(f"library modules: {json.dumps(out)}", flush=True)
    cl, of = out["clustering"], out["optical_flow"]
    if (any(out[n]["row_rel_l2_vs_f64"] > F64_REL for n in ("perceiver", "qformer"))
            or of["rel_err_vs_f64"] > F64_REL or not of["keep_equal"]
            or not 0 < of["kept"] < of["frames"] or not cl["kmeans_labels_equal"]
            or cl["kmeans_centroid_err"] > F64_REL or cl["knn_distance_err"] > F64_REL
            or cl["knn_chosen_err"] > F64_REL or cl["knn_planted_ties"] != [7, 101, 3000]
            or cl["soft_dtw_rel_err"] > F64_REL):
        raise AssertionError(f"library modules against float64: {out}")
    return out


def drive_streambench(root):
    """(h) The StreamBench tools' CLI over the runner phase's mp4 and
    annotation file: stats, resample, check-videos (opening the video),
    extract-frames at 1 fps -> report."""
    import io

    from streamchat_tpu_torch.tools import streambench

    d = os.path.join(root, "runners")
    ann, videos = os.path.join(d, "baseline.json"), os.path.join(d, "videos")

    def cli(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            streambench.main(list(argv))
        return buf.getvalue()

    with phase("StreamBench tools over the runner phase's mp4"):
        stats = json.loads(cli("stats", "--annotations", ann))
        sampled = os.path.join(d, "sampled.json")
        cli("resample", "--annotations", ann, "--per_category", "1", "--output", sampled)
        with open(sampled) as f:
            resampled = len(json.load(f))
        check = json.loads(cli("check-videos", "--annotations", ann, "--video_dir", videos,
                               "--open_check"))
        missing = json.loads(cli("check-videos", "--annotations", ann, "--video_dir", d))
        frames = json.loads(cli("extract-frames", "--video",
                                os.path.join(videos, "ego", "clip.mp4"), "--output_folder",
                                os.path.join(d, "frames"), "--fps", "1"))
        written = sorted(os.listdir(frames["save_path"]))
    out = dict(num_videos=stats["num_videos"], num_questions=stats["num_questions"],
               resampled=resampled, missing=check["count"],
               missing_under_a_wrong_dir=missing["count"],
               extracted_frames=frames["extracted_frames"],
               total_frames=frames["total_frames"], duration=frames["duration"],
               files=len(written))
    print(f"StreamBench tools: {json.dumps(out)}", flush=True)
    if (out["num_videos"], out["num_questions"], resampled, check["count"],
            missing["count"]) != (1, 2, 1, 0, 1) or not (
            frames["extracted_frames"] == len(written) == RUNNER_FRAMES // 30
            and frames["total_frames"] == RUNNER_FRAMES):
        raise AssertionError(f"StreamBench tools: {out}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Multi-GPU (ROADMAP §A 9): tensor parallelism in rank processes that share
# the card, the per-rank kernel shapes, and the sequence-parallel ops
# ---------------------------------------------------------------------------

TP_WORLD, TP_ONLINE_WORLD = 4, 2
# The TP phases' models: LongVA-7B and LLaMA-3-8B at full width, the
# decoders cut to 4 layers (written from the smoke's random trees). At 28
# random layers bf16 rounding alone moves the logits 1.4-1.9% (the sharded
# run's f32 sums in another order, as the kernels against their twins in
# the composed checks), past the 1e-2 the first decode step is held to;
# and each layer costs each caption ~1.1 s of gloo's host staging.
TP_LAYERS = 4
# Seconds a collective waits for the other ranks before the phase fails.
TP_TIMEOUT_S = 300
TP_LOGITS_REL_L2 = 1e-2
# One breakpoint over the video's first 2 s at sample rate 0.1: 6 frames, a
# chunk of 4 (a 2.3k-token caption) and a tail of 2. Generations are cut
# (captions and answers to 16 tokens) so that few prefill tokens and steps
# pass through gloo's host staging.
TP_BREAKPOINT = {"question": "What is on the table in front of me?", "answer": "a cup",
                 "class": "object", "time": 2}
TP_CLI = ["--chunk_size", "4", "--num_clusters", "2", "--short_window", "4",
          "--remember_window", "2", "--sample_rate", "0.1", "--temperature", "0",
          "--multi_modal_memory"]
TP_SAMPLING = dict(max_answer_tokens=16, max_caption_tokens=16, max_summary_tokens=16,
                   caption_temperature=0.0)
# The sequence-parallel ops at LongVA-7B's 28 / 4 heads over 4 ranks.
SP_S, SP_RANKS, SP_LENGTHS = 16384, 4, (16384, 12000)


def _tree_bytes(tree) -> int:
    return sum(_tensor_bytes(t) for t in _leaves(tree) if isinstance(t, torch.Tensor))


def _token_hash(tokens) -> int:
    h = 0
    for t in tokens:
        h = (h * 1000003 + int(t) + 1) % (1 << 61)
    return h


def _leading_equal(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def write_tp_longva(model, root) -> str:
    """LongVA-7B's ViT, projector and first TP_LAYERS decoder layers (bf16,
    full width) written as an HF checkpoint for the TP phases -> its path."""
    p = model.dec_params
    path = os.path.join(root, "longva_tp")
    _written(path, longva_config(dataclasses.replace(model.dec_cfg, num_layers=TP_LAYERS),
                                 model.vit_cfg),
             {**hf_vit(model.vit_params, model.vit_cfg), **hf_projector(model.proj_params),
              **hf_decoder(dict(p, layers=p["layers"][:TP_LAYERS]))}, "longva (TP phases)")
    return path


def _tp_inputs(root, ckpts):
    """The runner's annotation file (one breakpoint) and the argv its TP
    runs share (the checkpoints written earlier; --mode, --shard and the
    output paths added per run)."""
    d = os.path.join(root, "tp")
    os.makedirs(os.path.join(d, "videos", "tp"), exist_ok=True)
    open(os.path.join(d, "videos", "tp", "v.mp4"), "wb").close()   # read as `_video()`
    anno = os.path.join(d, "anno.json")
    with open(anno, "w", encoding="utf-8") as f:
        json.dump([{"info": {"class_1": "tp", "video_path": "v.mp4"},
                    "breakpoint": [TP_BREAKPOINT]}], f)
    return d, ["--video_dir", os.path.join(d, "videos"), "--annotations", anno,
               "--model_name", ckpts["longva"], "--embedding_model", ckpts["colbert"],
               "--minilm_model", ckpts["minilm"]] + TP_CLI


@contextlib.contextmanager
def _tp_observed():
    """Records, for one runner run: every generate call's emitted tokens in
    call order, the first caption's prefill logits (the logits of its first
    token) and its first decode step's, the seconds of `run_inference`, and
    after `LongVA.shard` the rank's device bytes and its trees' bytes. The
    runner loads the byte tokenizer (the checkpoints carry none), reads the
    smoke's synthetic video and generates TP_SAMPLING's lengths."""
    from streamchat_tpu_torch.models import generate_paged, longva
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
    from streamchat_tpu_torch.pipeline import runner

    seen = {"tokens": [], "prefill_logits": None, "first_step_logits": None}
    build, config, infer = runner.build_pipeline, runner.config_from_args, runner.run_inference
    gen, loop, step = longva.generate_paged, generate_paged._decode_loop, \
        generate_paged.decode_step_paged
    shard = longva.LongVA.shard

    def configured(args):
        cfg = config(args)
        return cfg.replace(sampling=dataclasses.replace(cfg.sampling, **TP_SAMPLING))

    def generating(*a, **kw):
        toks, count = gen(*a, **kw)
        for r in range(len(count)):
            seen["tokens"].extend(int(t) for t in toks[r][:int(count[r])])
        return toks, count

    def looping(params, cfg, cache, logits, *a, **kw):
        if seen["prefill_logits"] is None:
            seen["prefill_logits"] = logits.float().cpu()
        return loop(params, cfg, cache, logits, *a, **kw)

    def stepping(*a, **kw):
        out = step(*a, **kw)
        if seen["first_step_logits"] is None:
            seen["first_step_logits"] = out[0].float().cpu()
        return out

    def sharding(self, mesh=None):
        out = shard(self, mesh)
        torch.cuda.synchronize()
        seen.update(coords=mesh.coords, mesh_shape=mesh.shape,
                    device_bytes_after_shard=torch.cuda.memory_allocated(),
                    decoder_bytes=_tree_bytes(self.dec_params),
                    vit_projector_bytes=_tree_bytes(self.vit_params)
                    + _tree_bytes(self.proj_params), dec_cfg=dataclasses.asdict(self.dec_cfg))
        return out

    def inferring(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer(*a, **kw)
        torch.cuda.synchronize()
        seen["run_s"] = time.perf_counter() - t0

    patches = [(runner, "build_pipeline",
                lambda *a, **kw: build(*a, tokenizer=ByteTokenizer(), **kw)),
               (runner, "config_from_args", configured),
               (runner, "open_video",
                lambda path: _video(seed=DP_VIDEOS.index(os.path.basename(path)))),
               (runner, "run_inference", inferring), (longva, "generate_paged", generating),
               (generate_paged, "_decode_loop", looping),
               (generate_paged, "decode_step_paged", stepping),
               (longva.LongVA, "shard", sharding)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield seen
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def _tp_reference(d, argv, label):
    """The runner run unsharded in this process (the TP runs' reference)
    -> its tokens, first logits and saved records."""
    from streamchat_tpu_torch.models import step_graph
    from streamchat_tpu_torch.pipeline import runner

    out = os.path.join(d, f"{label}_unsharded")
    with _tp_observed() as seen:
        runner.main(argv + ["--memory_basic_dir", out, "--save_file", out + ".json"])
    step_graph.release()                  # the run's model is gone: free its workspaces
    gc.collect()
    torch.cuda.empty_cache()
    if not seen["tokens"] or seen["first_step_logits"] is None:
        raise AssertionError(f"TP reference {label}: no tokens or decode step: {seen}")
    with open(out + ".json", encoding="utf-8") as f:
        records = json.load(f)
    return {**{k: seen[k] for k in ("tokens", "prefill_logits", "first_step_logits", "run_s")},
            "records": records}


def _judge_tokens(lm, preds, out_path):
    """One judge batch (`judge_predictions`, batch 8, 64 new tokens) ->
    (emitted tokens in order, the first decode step's logits)."""
    from streamchat_tpu_torch.eval.judge import judge_predictions
    from streamchat_tpu_torch.models import generate

    seen = {"first": None}
    gen, dec = generate.generate, generate._decode_inline

    def generating(*a, **kw):
        toks, count = gen(*a, **kw)
        seen["toks"] = (toks, count)
        return toks, count

    def decoding(*a, **kw):
        logits, cache = dec(*a, **kw)
        if seen["first"] is None:
            seen["first"] = logits.float().cpu()
        return logits, cache

    generate.generate, generate._decode_inline = generating, decoding
    try:
        judge_predictions(preds, lambda prompts: lm.generate_batch(
            prompts, max_new_tokens=JUDGE_NEW_TOKENS), output_path=out_path,
            batch_size=JUDGE_BATCH)
    finally:
        generate.generate, generate._decode_inline = gen, dec
    toks, count = (x.cpu() for x in seen["toks"])
    return [int(t) for r in range(len(count)) for t in toks[r][:int(count[r])]], seen["first"]


def _tp_judge_job(rank, world, spec, mesh):
    """LLaMA-3-8B from its checkpoint, int8, built in turn, rank 0's whole
    tree judging once before `shard` (the reference) -> the rank's report."""
    import torch.distributed as dist

    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models.textlm import TextLM
    from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
    from streamchat_tpu_torch.parallel import mesh as pmesh

    rep = {}
    for turn in range(world):
        if turn == rank:
            lm = TextLM.from_pretrained(spec["llama"], tokenizer=ByteTokenizer())
            lm.quantize()
            if rank == 0:
                rep["ref_tokens"], rep["ref_first_step_logits"] = _judge_tokens(
                    lm, spec["preds"], os.path.join(spec["dir"], "judge_whole.jsonl"))
            lm.shard(mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            rep.update(device_bytes_after_shard=torch.cuda.memory_allocated(),
                       decoder_bytes=_tree_bytes(lm.params),
                       dec_cfg=dataclasses.asdict(lm.cfg))
        dist.barrier()
    kernels.reset_launch_counts()
    pmesh.reset_collective_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep["tokens"], rep["first_step_logits"] = _judge_tokens(
        lm, spec["preds"], os.path.join(spec["dir"], f"judge_rank{rank}.jsonl"))
    torch.cuda.synchronize()
    rep["run_s"] = time.perf_counter() - t0
    return rep


def _tp_runner_job(rank, spec):
    """`runner.main` with --shard (the group already up, so the runner keeps
    it and its ranks build in turn on the shared card) -> the rank's report.
    With spec["shared"] every rank gets the same output paths, as under
    torchrun, and the report names the files the rank opened for writing
    (rank 0's also the saved records)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.memory import bank
    from streamchat_tpu_torch.parallel import mesh as pmesh
    from streamchat_tpu_torch.pipeline import runner

    shared = spec.get("shared", False)
    out = os.path.join(spec["dir"], spec["label"] if shared else f"{spec['label']}_rank{rank}")
    kernels.reset_launch_counts()
    pmesh.reset_collective_stats()
    written = set()

    def recording_open(path, mode="r", *a, **kw):
        if any(c in mode for c in "wax"):
            written.add(os.path.relpath(os.path.abspath(path), spec["dir"]))
        return open(path, mode, *a, **kw)

    runner.open = bank.open = recording_open
    try:
        with _tp_observed() as seen:
            runner.main(spec["argv"] + ["--shard", "--memory_basic_dir", out,
                                        "--save_file", out + ".json"])
    finally:
        del runner.open, bank.open
    seen["written"] = sorted(written)
    seen["saved"] = f"{os.path.basename(out)}.json" in written
    if shared and rank == 0:
        with open(out + ".json", encoding="utf-8") as f:
            seen["records"] = json.load(f)
    return seen


def _tp_rank(rank, world, spec):
    """One rank of a TP phase: joins the phase's group (gloo on the shared
    card, or NCCL on card `rank`), runs the job, checks with an all_reduce
    that every rank emitted the same tokens, and saves its report (tokens,
    logits, launch counts, all_reduce count / bytes / host seconds)."""
    import datetime

    import torch.distributed as dist

    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.kernels.build import library
    from streamchat_tpu_torch.parallel import make_mesh
    from streamchat_tpu_torch.parallel import mesh as pmesh

    nccl = spec["backend"] == "nccl"
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank if nccl else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    store = dist.FileStore(os.path.join(spec["dir"], f"{spec['label']}.store"), world)
    dist.init_process_group(spec["backend"], store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        if spec["job"] == "judge":
            rep = _tp_judge_job(rank, world, spec, make_mesh(kv_heads=8))
        else:
            rep = _tp_runner_job(rank, spec)
        rep["launches"] = {n: c for n, c in kernels.launch_counts().items() if c}
        rep["collectives"] = pmesh.collective_stats()
        if not spec.get("shared"):      # one model group: every rank's tokens alike
            h = _token_hash(rep["tokens"])
            both = torch.tensor([h, -h], dtype=torch.int64, device="cuda" if nccl else "cpu")
            dist.all_reduce(both, op=dist.ReduceOp.MAX)
            rep["tokens_equal_on_every_rank"] = both.tolist() == [h, -h]
        torch.save(rep, os.path.join(spec["dir"], f"{spec['label']}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_tp_phase(label, world, spec, ref=None):
    """Spawn `world` ranks for one TP phase and check them -> (report,
    rank 0's launch counts). Held: every rank's tokens equal (the
    all_reduce of a token hash), rank 0 writes the results alone (runner),
    the first decode step's logits within TP_LOGITS_REL_L2 of the unsharded
    model's on the same prompt (row relative L2) and its first token equal;
    printed: the leading tokens equal to the unsharded run, each rank's
    device bytes after `shard` and its all_reduce count, bytes and host
    seconds (gloo's host staging on the shared card)."""
    import torch.multiprocessing as mp

    spec = dict(spec, label=label, backend=spec.get("backend", "gloo"))
    free, total = torch.cuda.mem_get_info()
    print(f"TP [{label}]: {world} ranks over {spec['backend']}"
          f"{' (a card a rank)' if spec['backend'] == 'nccl' else ' on one card, all_reduce staged through pinned host buffers'}"
          f"; card free {free} of {total} bytes before the spawn", flush=True)
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(world, spec), nprocs=world, join=True)
    seconds = time.perf_counter() - t0
    reps = [torch.load(os.path.join(spec["dir"], f"{label}_rank{r}.pt"), weights_only=False)
            for r in range(world)]
    if ref is None:                     # the judge: rank 0's whole tree judged first
        ref = {"tokens": reps[0].pop("ref_tokens"),
               "first_step_logits": reps[0].pop("ref_first_step_logits")}
    first = reps[0]["first_step_logits"]
    rel = _row_rel_l2(first, ref["first_step_logits"])
    report = dict(
        seconds=seconds, ranks=world, backend=spec["backend"],
        tokens=len(reps[0]["tokens"]),
        tokens_equal_on_every_rank=all(r["tokens_equal_on_every_rank"] for r in reps)
        and all(r["tokens"] == reps[0]["tokens"] for r in reps),
        leading_tokens_equal_to_unsharded=_leading_equal(reps[0]["tokens"], ref["tokens"]),
        unsharded_tokens=len(ref["tokens"]), first_step_logits_row_rel_l2=rel,
        run_s=[r.get("run_s") for r in reps],
        device_bytes_after_shard=[r["device_bytes_after_shard"] for r in reps],
        decoder_bytes=[r["decoder_bytes"] for r in reps],
        rank_dec_cfg={k: reps[0]["dec_cfg"][k] for k in ("num_heads", "num_kv_heads",
                                                          "intermediate_size", "head_dim")},
        collectives=[r["collectives"] for r in reps], launches=reps[0]["launches"])
    if "vit_projector_bytes" in reps[0]:
        report.update(vit_projector_bytes=reps[0]["vit_projector_bytes"],
                      results_written=[r["saved"] for r in reps])
    if "prefill_logits" in ref:
        report["prefill_logits_row_rel_l2"] = _row_rel_l2(reps[0]["prefill_logits"],
                                                          ref["prefill_logits"])
    print(f"TP [{label}]: {json.dumps(report)}", flush=True)
    report["rank0_tokens"] = reps[0]["tokens"]
    bad = []
    if not report["tokens_equal_on_every_rank"] or not report["tokens"]:
        bad.append("ranks' tokens differ (or none emitted)")
    if not rel <= TP_LOGITS_REL_L2 or not bool(torch.isfinite(first).all()):
        bad.append(f"first decode step's logits {rel} from the unsharded model's")
    if report.get("results_written", [True] + [False] * (world - 1)) != \
            [True] + [False] * (world - 1):
        bad.append(f"results written by ranks {report['results_written']}")
    if report["leading_tokens_equal_to_unsharded"] == 0:
        bad.append("the first token differs from the unsharded run's")
    if any(c["count"] == 0 for c in report["collectives"]):
        bad.append("a rank took no all_reduce")
    missing = [n for n in RUNS[label.replace("_nccl", "")] if report["launches"].get(n, 0) == 0]
    if missing:
        bad.append(f"kernels never launched: {missing}")
    if bad:
        raise AssertionError(f"TP phase {label}: {'; '.join(bad)}")
    return report, reps[0]["launches"]


# The data axis: 8 ranks at Qwen2-7B's 4 kv heads make the 2 x 4 mesh an
# 8-card user gets (`best_mesh_shape`); two annotations, one a replica, each
# over its own video (the synthetic video of seed 0 and of seed 1), so that
# the replicas' captions differ.
DP_WORLD = 8
DP_VIDEOS = ("v.mp4", "v1.mp4")
DP_BREAKPOINTS = (TP_BREAKPOINT, dict(TP_BREAKPOINT, question="What is next to the cup?"))


def _dp_inputs(d, argv):
    """The data-axis phase's annotation file (two annotations, one
    breakpoint and one video each) -> the TP argv reading it."""
    anno = os.path.join(d, "anno_dp.json")
    open(os.path.join(d, "videos", "tp", DP_VIDEOS[1]), "wb").close()
    with open(anno, "w", encoding="utf-8") as f:
        json.dump([{"info": {"class_1": "tp", "video_path": v}, "breakpoint": [bp]}
                   for v, bp in zip(DP_VIDEOS, DP_BREAKPOINTS)], f)
    i = argv.index("--annotations")
    return argv[:i + 1] + [anno] + argv[i + 2:]


def _untimed(records):
    return [{k: v for k, v in r.items() if k != "process_time"} for r in records]


def check_data_axis(label, reps, refs, dp, tp):
    """Hold one data-axis phase's rank reports to `refs` (per replica d: the
    tokens and saved records of the tp-`tp` runner run with --num_chunks dp
    --chunk_idx d, and its unsharded run's report) -> list of faults: rank
    r at (r // tp, r % tp) of a dp x tp mesh; each replica's ranks emit the
    same tokens, equal to its tp-`tp` run's, and its first token and first
    decode step (within TP_LOGITS_REL_L2) those of the unsharded run; rank
    0's --save_file holds the tp-`tp` runs' records in annotation order;
    rank 0 writes it and replica 0's bank file, replica d's model rank 0 its
    own bank file, no other rank anything; every rank takes all_reduces;
    rank 0 launches the run's kernels."""
    bad = []
    for r, rep in enumerate(reps):
        if tuple(rep["coords"]) != divmod(r, tp) or rep["mesh_shape"] != {"data": dp,
                                                                          "model": tp}:
            bad.append(f"rank {r} at {rep['coords']} of {rep['mesh_shape']}, not "
                       f"{divmod(r, tp)} of {dp} x {tp}")
        if rep["collectives"]["count"] == 0:
            bad.append(f"rank {r} took no all_reduce")
    for d in range(dp):
        group, ref, whole = reps[d * tp:(d + 1) * tp], refs[d], refs[d]["unsharded"]
        if any(rep["tokens"] != group[0]["tokens"] for rep in group):
            bad.append(f"replica {d}: its ranks' tokens differ")
        if not group[0]["tokens"] or group[0]["tokens"] != ref["tokens"]:
            bad.append(f"replica {d}: {_leading_equal(group[0]['tokens'], ref['tokens'])} of "
                       f"{len(ref['tokens'])} leading tokens equal to its tp-{tp} run")
        first = group[0]["first_step_logits"]
        rel = _row_rel_l2(first, whole["first_step_logits"])
        if not rel <= TP_LOGITS_REL_L2 or not bool(torch.isfinite(first).all()):
            bad.append(f"replica {d}: first decode step {rel} from its unsharded run's")
        if _leading_equal(group[0]["tokens"], whole["tokens"]) == 0:
            bad.append(f"replica {d}: the first token differs from its unsharded run's")
    want = _untimed([r for d in range(dp) for r in refs[d]["records"]])
    if _untimed(reps[0].get("records", [])) != want:
        bad.append(f"{label}.json holds {_untimed(reps[0].get('records', []))}, not {want}")
    expect = [[] for _ in reps]
    expect[0].append(f"{label}.json")
    for d in range(dp):
        expect[d * tp].append(f"{label}/memory_{d}.json")
    for r, rep in enumerate(reps):
        if sorted(rep["written"]) != sorted(expect[r]):
            bad.append(f"rank {r} wrote {rep['written']}, expected {expect[r]}")
    missing = [n for n in RUNS[label.replace("_nccl", "")] if reps[0]["launches"].get(n, 0) == 0]
    if missing:
        bad.append(f"kernels never launched: {missing}")
    return bad


def data_axis_refs(tp_dir, tp, whole):
    """Each replica's references: the tp-4 runner run of its annotations
    (replica 0's is `tp4_runner_offline`, over the same annotation, video
    and seed; replica 1's `tp4_runner_chunk1`) -> its tokens and saved
    records, beside its unsharded run's report."""
    refs = []
    for d, label in enumerate(("tp4_runner_offline", "tp4_runner_chunk1")):
        with open(os.path.join(tp_dir, f"{label}_rank0.json"), encoding="utf-8") as f:
            refs.append(dict(tokens=tp[label]["rank0_tokens"], records=json.load(f),
                             unsharded=whole[d]))
    return refs


def run_data_axis_phase(label, spec, refs, planted, world=DP_WORLD):
    """`runner --shard` over `world` ranks on the (data, model) mesh, every
    rank given the same output paths -> (report, rank 0's launch counts).
    Held by `check_data_axis` to `refs`; two planted faults must fail it:
    replica 1 having run replica 0's annotation, and a rank placed in the
    other replica's model group."""
    import copy

    import torch.multiprocessing as mp

    from streamchat_tpu_torch.parallel import layout

    dp, tp = layout(world)
    spec = dict(spec, label=label, backend=spec.get("backend", "gloo"), shared=True)
    free, total = torch.cuda.mem_get_info()
    where = (" (a card a rank)" if spec["backend"] == "nccl" else
             " on one card, all_reduce staged through pinned host buffers")
    print(f"data axis [{label}]: {world} ranks, dp {dp} x tp {tp}, over {spec['backend']}{where}"
          f"; card free {free} of {total} bytes before the spawn", flush=True)
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(world, spec), nprocs=world, join=True)
    seconds = time.perf_counter() - t0
    reps = [torch.load(os.path.join(spec["dir"], f"{label}_rank{r}.pt"), weights_only=False)
            for r in range(world)]
    ranks = [dict(rank=r, coords=list(rep["coords"]),
                  device_bytes_after_shard=rep["device_bytes_after_shard"],
                  decoder_bytes=rep["decoder_bytes"], run_s=rep["run_s"],
                  all_reduce=dict(calls=rep["collectives"]["count"],
                                  bytes=rep["collectives"]["bytes"],
                                  host_s=rep["collectives"]["seconds"]),
                  tokens=len(rep["tokens"]), written=rep["written"])
             for r, rep in enumerate(reps)]
    report = dict(seconds=seconds, ranks=world, dp=dp, tp=tp, backend=spec["backend"],
                  first_step_logits_row_rel_l2=[
                      _row_rel_l2(reps[d * tp]["first_step_logits"],
                                  refs[d]["unsharded"]["first_step_logits"]) for d in range(dp)],
                  tokens_equal_to_tp_run=[reps[d * tp]["tokens"] == refs[d]["tokens"]
                                          for d in range(dp)],
                  leading_tokens_equal_to_unsharded=[
                      _leading_equal(reps[d * tp]["tokens"], refs[d]["unsharded"]["tokens"])
                      for d in range(dp)],
                  tokens=[len(reps[d * tp]["tokens"]) for d in range(dp)],
                  unsharded_run_s=[refs[d]["unsharded"]["run_s"] for d in range(dp)],
                  records=len(reps[0].get("records", [])), per_rank=ranks,
                  launches=reps[0]["launches"])
    print(f"data axis [{label}]: {json.dumps(report)}", flush=True)
    for rank in ranks:
        print(f"data axis [{label}] rank {rank['rank']} at (data, model) "
              f"{tuple(rank['coords'])}: {rank['device_bytes_after_shard']} B after shard, "
              f"all_reduce {rank['all_reduce']['calls']} calls / {rank['all_reduce']['bytes']} B"
              f" / {rank['all_reduce']['host_s']:.3f} s, run {rank['run_s']:.3f} s", flush=True)
    bad = check_data_axis(label, reps, refs, dp, tp)
    if bad:
        raise AssertionError(f"data axis phase {label}: {'; '.join(bad)}")
    faults = {}
    swapped = copy.deepcopy(reps)                 # replica 1 ran replica 0's annotation
    for rep in swapped[tp:2 * tp]:
        rep["tokens"] = list(reps[0]["tokens"])
    swapped[0]["records"] = list(reps[0]["records"][:1]) * 2
    faults["data axis: a replica writes the other's annotation"] = swapped
    moved = copy.deepcopy(reps)                   # rank tp - 1 in replica 1's model group
    moved[tp - 1]["coords"] = (1, tp - 1)
    faults["data axis: a rank put in the wrong model group"] = moved
    for name, reports in faults.items():
        found = check_data_axis(label, reports, refs, dp, tp)
        if not found:
            raise AssertionError(f"planted fault not rejected: {name}")
        planted[name] = float(len(found))
        print(f"planted fault rejected: {name}: {len(found)} checks failed (limit 0): "
              f"{found[0]}", flush=True)
    return report, reps[0]["launches"]


# The traced run: one off-line breakpoint in bf16 at full depth, its
# generations cut to 16 new tokens so that the trace stays small.
TRACE_SAMPLING = dict(max_answer_tokens=16, max_caption_tokens=16, max_summary_tokens=16)
# Phases of the traced run that launch kernels and must show device events.
TRACE_DEVICE_PHASES = ("ingest", "caption", "answer")


def _prefill_form(name):
    """(head dim, partial) of a flash_prefill_kernel instantiation named in
    a trace (demangled or not), else None."""
    import re

    m = re.search(r"flash_prefill_kernel<(\d+), (true|false)", name)
    if m:
        return int(m.group(1)), m.group(2) == "true"
    m = re.search(r"flash_prefill_kernelILi(\d+)ELb([01])", name)
    return (int(m.group(1)), m.group(2) == "1") if m else None


def traced_launches(ops) -> dict:
    """Launches of the path's kernels in a trace's device-op rows: K1 by its
    attention (`flash_prefill_kernel` at the ViT's head dim 64, once a K1
    launch), K3 / K5 by theirs at 128 (one a launch; K5 the partial form),
    K4 by `paged_tc_kernel` (one a launch, beside its merge)."""
    out = {"fused_vit_layer": 0, "flash_attention": 0, "flash_attention_partial": 0,
           "paged_decode_attention_seq": 0}
    for r in ops:
        form = _prefill_form(r["name"])
        if form == (64, False):
            out["fused_vit_layer"] += r["count"]
        elif form == (128, False):
            out["flash_attention"] += r["count"]
        elif form == (128, True):
            out["flash_attention_partial"] += r["count"]
        elif "paged_tc_kernel" in r["name"]:
            out["paged_decode_attention_seq"] += r["count"]
    return out


def _trace_with_annotation(src_dir, dst_dir, phase_name):
    """A copy of the trace in `src_dir` (its metadata, annotations and
    device events: what the per-phase device seconds read) with a
    `gpu_user_annotation` over every window of `phase_name` on a kernel's
    GPU lane (as Kineto mirrors a record_function) -> the copy's events."""
    from streamchat_tpu_torch.utils import traceparse

    keep = traceparse.DEVICE_CATS | {"user_annotation", "gpu_user_annotation"}
    events = [e for e in traceparse.load_trace_events(traceparse.find_trace_file(src_dir))
              if e.get("ph") == "M" or e.get("cat") in keep]
    lane = next(e for e in events if e.get("cat") == "kernel")
    events += [dict(e, pid=lane["pid"], tid=lane["tid"], cat="gpu_user_annotation")
               for e in events if e.get("name") == f"phase={phase_name}"
               and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, "planted.pt.trace.json"), "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events}, f)
    return events


def traced_attempt(pipe, d):
    """One off-line breakpoint in bf16 under `maybe_device_trace` into `d`,
    with the launch counters zeroed before it, the ViT's frame batches and
    the decoder's one-pass prefills counted -> (seconds, launch counts,
    {"batches", "one_pass"}, trace path, per-phase device seconds, device
    op rows, seconds to parse, the run's PhaseTimer totals, its answers)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import decoder
    from streamchat_tpu_torch.utils import traceparse
    from streamchat_tpu_torch.utils.profiling import TRACE_DIR_ENV, maybe_device_trace

    m = pipe.model
    seen = {"batches": 0, "one_pass": 0}
    forward, encode = decoder.forward, m.encode_images

    def counting_forward(*a, **kw):
        if not kw.get("decode") and not kw.get("chunked"):
            seen["one_pass"] += 1
        return forward(*a, **kw)

    def counting_encode(pixels):
        seen["batches"] += 1
        return encode(pixels)

    decoder.forward, m.encode_images = counting_forward, counting_encode
    os.environ[TRACE_DIR_ENV] = d
    kernels.reset_launch_counts()
    try:
        with configured(pipe, sampling=TRACE_SAMPLING), maybe_device_trace():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run_slice(pipe, BREAKPOINTS[:1])[0]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        decoder.forward = forward
        del m.encode_images, os.environ[TRACE_DIR_ENV]
    counts = kernels.launch_counts()
    t1 = time.perf_counter()
    path = traceparse.find_trace_file(d)
    phases = traceparse.device_seconds_by_phase(d)
    ops = traceparse.device_op_table(d, top=10**6)
    return (seconds, counts, seen, path, phases, ops, time.perf_counter() - t1,
            dict(pipe.last_phase_totals), [r["predict"] for r in results])


def untraced_run(pipe):
    """The traced run's breakpoint and settings with no profiler -> (seconds,
    the run's PhaseTimer totals, its answers)."""
    with configured(pipe, sampling=TRACE_SAMPLING):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = run_slice(pipe, BREAKPOINTS[:1])[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return seconds, dict(pipe.last_phase_totals), [r["predict"] for r in results]


def drive_traced(pipe, planted):
    """One off-line breakpoint in bf16 at full depth under
    `maybe_device_trace`, read back with `utils.traceparse` -> (report,
    launch counts). Held: every phase's device_s <= wall_s; ingest, caption
    and answer show device events; the trace's K1 launches equal the ViT's
    blocks run x frame batches and the K1 counter, its K3 launches the
    decoder's layers x one-pass prefills and the K3 counter, K5's and K4's
    their counters; every kernel of RUNS["traced_bf16"] launched. A trace
    that lost events is taken again, PROFILE_ATTEMPTS runs at most, then the
    phase fails. The same breakpoint, from the same generator states, then
    runs untraced: each phase's PhaseTimer total beside the traced run's is
    the profiler's inflation, and device_s over the untraced total the idle
    share's estimate without it. Planted: a gpu_user_annotation over the
    caption windows must leave caption's device_s unchanged."""
    from streamchat_tpu_torch.models import vit
    from streamchat_tpu_torch.utils import traceparse
    from streamchat_tpu_torch.utils.profiling import PROFILE_ATTEMPTS

    m = pipe.model
    blocks = vit._num_blocks(m.vit_cfg, None)
    root = tempfile.mkdtemp(prefix="sc_trace_")
    states = _generator_states(pipe)
    try:
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            d = os.path.join(root, f"attempt{attempt}")
            pipe.generator.set_state(states[0])
            m.generator.set_state(states[1])
            (seconds, counts, seen, path, phases, ops, parse_s, timer_traced,
             answers) = traced_attempt(pipe, d)
            traced = traced_launches(ops)
            expected = {"fused_vit_layer": blocks * seen["batches"],
                        "flash_attention": m.dec_cfg.num_layers * seen["one_pass"]}
            wrong = {n: (counts.get(n, 0), e) for n, e in expected.items()
                     if counts.get(n, 0) != e}
            if wrong or not seen["batches"] or not seen["one_pass"]:
                raise AssertionError(f"traced run: counters {wrong} against the expected "
                                     f"(blocks {blocks} x batches, layers x one-pass "
                                     f"prefills {seen})")
            lost = [f"{p}: no device events" for p in TRACE_DEVICE_PHASES
                    if phases.get(p, {}).get("device_events", 0) == 0]
            lost += [f"{n}: {traced[n]} traced, {counts.get(n, 0)} launched"
                     for n in traced if traced[n] != counts.get(n, 0)]
            if not lost:
                break
            print(f"traced run, attempt {attempt}: the trace lost events: {lost}", flush=True)
            shutil.rmtree(d, ignore_errors=True)
        else:
            raise AssertionError(f"traced run: the trace lost events in {PROFILE_ATTEMPTS} "
                                 f"attempts: {lost}")
        missing = [n for n in RUNS["traced_bf16"] if counts.get(n, 0) == 0]
        if missing:
            raise AssertionError(f"traced run: kernels never launched: {missing}")
        over = {p: r for p, r in phases.items() if not r["device_s"] <= r["wall_s"]}
        if over:
            raise AssertionError(f"traced run: device_s over wall_s in {over}")
        pipe.generator.set_state(states[0])
        m.generator.set_state(states[1])
        untraced_s, timer_untraced, untraced_answers = untraced_run(pipe)
        per_phase = {}
        for p, r in phases.items():
            plain = timer_untraced.get(p)
            per_phase[p] = dict(
                r, idle_share=1.0 - r["device_s"] / r["wall_s"] if r["wall_s"] else None,
                timer_traced_s=timer_traced.get(p), timer_untraced_s=plain,
                profiler_inflation=timer_traced.get(p, 0.0) / plain if plain else None,
                idle_share_untraced_est=1.0 - r["device_s"] / plain if plain else None)
        report = dict(seconds=seconds, untraced_seconds=untraced_s,
                      same_answers_untraced=untraced_answers == answers,
                      attempts=attempt, parse_s=parse_s,
                      trace_mb=os.path.getsize(path) / 1e6, phases=per_phase,
                      top_ops=ops[:10], traced_launches=traced,
                      expected=dict(expected, frame_batches=seen["batches"], vit_blocks=blocks,
                                    one_pass_prefills=seen["one_pass"],
                                    decoder_layers=m.dec_cfg.num_layers),
                      launches={n: c for n, c in counts.items() if c})
        print(f"traced run (bf16, full depth, 1 breakpoint, {TRACE_SAMPLING['max_caption_tokens']}"
              f"-token generations): {json.dumps(report)}", flush=True)
        for p, r in per_phase.items():
            print(f"traced phase {p}: wall_s {r['wall_s']} device_s {r['device_s']} host_gap_s "
                  f"{r['host_gap_s']} device_events {r['device_events']} idle share "
                  f"{r['idle_share']}; PhaseTimer traced {r['timer_traced_s']} s, untraced "
                  f"{r['timer_untraced_s']} s (inflation {r['profiler_inflation']}), idle "
                  f"share untraced (est.) {r['idle_share_untraced_est']}", flush=True)
        name = "trace: a gpu_user_annotation over the caption windows"
        _trace_with_annotation(d, os.path.join(root, "planted"), "caption")
        after = traceparse.device_seconds_by_phase(os.path.join(root, "planted"))["caption"]
        planted[name] = abs(after["device_s"] - phases["caption"]["device_s"])
        if planted[name] != 0 or after["device_events"] != phases["caption"]["device_events"]:
            raise AssertionError(f"planted fault not rejected: {name}: {phases['caption']} -> "
                                 f"{after}")
        print(f"planted fault rejected: {name}: caption device_s {after['device_s']} as before "
              f"(limit 0 change; counted as busy it would read its wall "
              f"{phases['caption']['wall_s']})", flush=True)
        return report, counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Decode steps replayed as CUDA graphs (models/step_graph.py), each path run
# twice from one generator state: graphed (the default on the card) and
# eager (graph=False). Short generations: GRAPH_NEW_TOKENS tokens after a
# prompt of GRAPH_PROMPT[0] valid tokens (rows after the first shorter),
# padded to GRAPH_PROMPT[1]; the judge's rows a 1,408-token bucket.
GRAPH_NEW_TOKENS = 24
GRAPH_PROMPT = (1000, 1024)
GRAPH_SAMPLING = {"greedy": dict(temperature=0.0), "temperature": dict(temperature=1.0),
                  "top_p": dict(temperature=0.8, top_p=0.9)}
# H2O on a 4-page pool (cap 512): the 1,024-token prompt is compressed at
# prefill to C = 492 slots and again in the loop at length 512 (step 20);
# the steps collect mass until then (the plain gather) and run K4 after:
# two step forms, each captured once.
GRAPH_H2O = dict(num_pages=4, max_pages_per_seq=4, hh_size=360, recent_size=128, sink_size=4)
# LongVA's paths, by the decoder's storage at each point of the script:
# name -> (rows' valid lengths, generate_paged keywords (None: the dense
# loop), kernels the path must launch).
GRAPH_CASES = {
    "bf16": {
        "bf16_b1": ([1000], {}, ("paged_decode_attention_seq",)),
        "caller_pool_bf16": ([1000, 500], dict(num_pages=18, max_pages_per_seq=10),
                             ("paged_decode_attention_table",)),
        "caller_pool_kv_int8": ([1000, 500], dict(num_pages=18, max_pages_per_seq=10,
                                                  kv_int8=True),
                                ("paged_decode_attention_table_int8",)),
        "spec4_bf16_pages": ([1000], dict(spec_tokens=4), ("paged_seq_attention_partial",)),
        "spec4_int8_pages": ([1000], dict(spec_tokens=4, kv_int8=True),
                             ("paged_seq_attention_partial_int8",)),
    },
    "int8": {
        "int8_b1": ([1000], {}, ("paged_decode_attention_seq", "qmatvec_int8")),
        "int8_caption_batch2": ([1000, 700], {}, ("paged_decode_attention_seq",
                                                  "qmatvec_int8")),
        "int8_h2o_b1": ([1000], GRAPH_H2O, ("paged_decode_attention_seq", "qmatvec_int8")),
    },
    "int4": {
        "int4_kv_int8_b1": ([1000], dict(kv_int8=True),
                            ("paged_decode_attention_seq_int8",) + INT4),
    },
    "judge_bf16": {
        "judge_dense_b8_bf16": ([1400, 1300, 1200, 1100, 1000, 900, 800, 700], None, ()),
    },
    "judge_int8": {
        "judge_dense_b8_int8": ([1400, 1300, 1200, 1100, 1000, 900, 800, 700], None,
                                ("qmatvec_int8",)),
    },
}


def _graph_run(params, cfg, embeds, ln, generator, kw, graph, sampling):
    """One generation of GRAPH_NEW_TOKENS tokens with the launch counters
    zeroed before it -> (tokens, counts, stats, seconds)."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import generate, generate_paged

    stats = {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    common = dict(max_new_tokens=GRAPH_NEW_TOKENS, stats=stats, graph=graph, **sampling)
    if kw is None:
        toks, _ = generate.generate(params, cfg, embeds, ln, generator, **common)
        toks = toks.cpu()
    else:
        toks, _ = generate_paged.generate_paged(params, cfg, embeds, ln, generator, **kw,
                                                **common)
        toks = torch.from_numpy(toks)
    torch.cuda.synchronize()
    return toks, kernels.launch_counts(), stats, time.perf_counter() - t0


def drive_graphs(params, cfg, generator, label, smi):
    """Every path of GRAPH_CASES[label] in each sampling mode (no top_p with
    speculative decode) run graphed and eager from the same generator state
    -> (report, summed launch counts of the graphed runs). Held: tokens
    bit-equal, launch counts equal (each replay counts what its capture
    recorded), one capture and a replay for every later step, the path's
    kernels launched. Printed a path and mode: eager and graphed ms a step
    (graphed: the loop's host seconds less the capture, over its steps,
    the first of which runs eagerly as the warm-up), capture s, launches a
    replay. The thread's kept workspaces are dropped first, so that every
    path captures anew; an H2O path captures each of its two step forms and
    must compress inside the loop."""
    from streamchat_tpu_torch.models import step_graph

    step_graph.release()
    report, total = {}, {}
    for name, (lengths, kw, expect) in GRAPH_CASES[label].items():
        s = GRAPH_PROMPT[1] if kw is not None else 1408
        b = len(lengths)
        embeds = (torch.randn(b, s, cfg.hidden_size, generator=generator, device="cuda")
                  * 0.02).to(torch.bfloat16)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for mode, sampling in GRAPH_SAMPLING.items():
            if kw and kw.get("spec_tokens") and "top_p" in sampling:
                continue
            state = generator.get_state()
            runs = {}
            for graph in (None, False):
                generator.set_state(state)
                runs["eager" if graph is False else "graphed"] = _graph_run(
                    params, cfg, embeds, ln, generator, kw, graph, sampling)
            (gt, gc_, gs, gsec), (et, ec, es, esec) = runs["graphed"], runs["eager"]
            steps = gs["decode_steps"]
            forms = 2 if kw and kw.get("hh_size") else 1
            row = dict(
                rows=b, steps=steps, tokens_bit_equal=bool(torch.equal(gt, et)),
                launches_equal=gc_ == ec, eager_ms_per_step=1e3 * es["decode_s"] / steps,
                graphed_ms_per_step=1e3 * (gs["decode_s"] - gs["capture_s"]) / steps,
                capture_s=gs["capture_s"], graph_captures=gs.get("graph_captures"),
                replays=gs.get("graph_replays"),
                launches_per_replay=gs["replayed_launches"] / max(gs["graph_replays"], 1),
                graphed_s=gsec, eager_s=esec, prefill_s=gs["prefill_s"],
                compressions_in_loop=gs.get("compressions_in_loop"),
                reserved_gib=torch.cuda.memory_reserved() / 2**30)
            report[f"{name} {mode}"] = row
            print(f"decode graph [{name}, {mode}]: {b} rows, {steps} steps, eager "
                  f"{row['eager_ms_per_step']:.3f} ms/step, graphed "
                  f"{row['graphed_ms_per_step']:.3f} ms/step, capture {row['capture_s']:.4f} s, "
                  f"{row['launches_per_replay']:.0f} launches a replay, tokens bit-equal "
                  f"{row['tokens_bit_equal']}, {row['reserved_gib']:.2f} GiB reserved  [{smi}]",
                  flush=True)
            missing = [n for n in expect if gc_.get(n, 0) == 0]
            if (not row["tokens_bit_equal"] or not row["launches_equal"] or missing
                    or gs.get("graph_captures") != forms
                    or gs.get("graph_replays") != steps - forms
                    or steps < 2 or "graph_captures" in es
                    or (forms == 2 and not gs.get("compressions_in_loop"))):
                raise AssertionError(f"decode graph [{name}, {mode}]: {row}, kernels never "
                                     f"launched {missing}, graphed counts {gc_}, eager {ec}")
            for n, c in gc_.items():
                total[n] = total.get(n, 0) + c
        del embeds
    return report, total


GLUE_PROMPT = (6800, 6912)       # the qa cells' prompt (valid, padded)
GLUE_STEPS = 256                 # an answer's decode steps


def drive_glue_steps(params, cfg, generator, label, smi):
    """The decode step's split before and after the glue kernels, untraced
    -> report: generate_paged over a 6,800-token prompt, 256 greedy steps,
    graphed, in turns with the plain glue twins patched in (the eager glue:
    "plain") and with the kernels ("fused"): plain, fused, fused, plain,
    each turn's workspaces dropped first so that it captures its own graph.
    From the program's spans of each turn's replayed steps (the warm-up and
    capture steps left out), as PERF.md's step split reads them: step ms
    (`decode.step`), launch ms (`decode.replay`), wait ms
    (`decode.readback`); and each glue kernel's launches a step from
    `kernels.launch_counts()` (fused turns: 2 L + 1, L and L, 113 at
    LongVA-7B; none in the plain turns). `label`: "int8" (bf16 pages) or
    "int4_kv_int8"."""
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.models import generate_paged, step_graph
    from streamchat_tpu_torch.ops import decode_glue
    from streamchat_tpu_torch.utils import profiling

    n, s = GLUE_PROMPT
    embeds = (torch.randn(1, s, cfg.hidden_size, generator=generator, device="cuda")
              * 0.02).to(torch.bfloat16)
    ln = torch.tensor([n], dtype=torch.int32, device="cuda")
    twins = {name: getattr(decode_glue, name + "_plain")
             for name in ("add_rmsnorm", "bias_rope_append", "silu_mul")}
    report = {"plain": [], "fused": []}
    tokens = {}
    for glue in ("plain", "fused", "fused", "plain"):
        kept = {name: getattr(decode_glue, name) for name in twins}
        if glue == "plain":
            for name, fn in twins.items():
                setattr(decode_glue, name, fn)
        step_graph.release()
        kernels.reset_launch_counts()
        stats = {}
        t0 = time.perf_counter_ns()
        try:
            toks, _ = generate_paged.generate_paged(
                params, cfg, embeds, ln, generator, max_new_tokens=GLUE_STEPS,
                kv_int8=label != "int8", temperature=0.0, stats=stats)
        finally:
            for name, fn in kept.items():
                setattr(decode_glue, name, fn)
        t1 = time.perf_counter_ns()
        if not profiling.intact_since(t0):
            raise AssertionError("drive_glue_steps: the span ring overflowed")
        spans = profiling.spans(t0, t1)
        mean = {}
        for span_name, key in (("decode.step", "step_ms"), ("decode.replay", "launch_ms"),
                               ("decode.readback", "wait_ms")):
            ds = [r.duration_ns for r in spans if r.name == span_name][2:]
            mean[key] = sum(ds) / len(ds) / 1e6
        counts = kernels.launch_counts()
        steps = stats["decode_steps"]
        by_kernel = {name: counts[name] / steps for name in twins}
        glue_launches = sum(counts[name] for name in twins)
        report[glue].append(dict(mean, steps=steps, replays=stats.get("graph_replays"),
                                 launches_a_step=by_kernel,
                                 glue_launches_a_step=glue_launches / steps,
                                 decode_ms=1e3 * (stats["decode_s"] - stats["capture_s"])
                                 / steps))
        tokens.setdefault(glue, toks)
        print(f"glue step split [{label}, {glue}]: step {mean['step_ms']:.4f} ms, launch "
              f"{mean['launch_ms']:.4f} ms, wait {mean['wait_ms']:.4f} ms over {steps - 2} "
              f"replayed steps, {glue_launches / steps:.1f} glue launches a step  [{smi}]",
              flush=True)
    step_graph.release()
    report["tokens_equal"] = bool((tokens["plain"] == tokens["fused"]).all())
    n = cfg.num_layers
    expected = dict(add_rmsnorm=2 * n + 1, bias_rope_append=n, silu_mul=n)
    if (any(r["launches_a_step"] != expected for r in report["fused"])
            or any(r["glue_launches_a_step"] for r in report["plain"])):
        raise AssertionError(f"drive_glue_steps [{label}]: glue launches {report}")
    return report


def _poison_pool(ws):
    """A kept workspace's cache overwritten: NaN in its bf16 pages (and f32
    scales), 7 in int8 pages, table, length and `next_free`. A call at its
    key pages its prompt in and resets the rest; no step may read a slot
    past a row's length."""
    for name, x in ws.tensors.items():
        if name == "cache":
            for f in dataclasses.fields(x):
                t = getattr(x, f.name)
                t.fill_(float("nan") if t.is_floating_point() else 7)


def drive_graph_reuse(params, cfg, generator, smi):
    """Graphs kept across generate calls (`step_graph.workspace`), on
    GRAPH_CASES' int8_b1 path at temperature 1 -> report. Calls: A at key K
    (captures); its kept pool poisoned; B at K with another prompt from
    generator state S (no warm-up, no capture: replays from its first step);
    C at another key (max_new_tokens + 1: captures); D at K from S again
    (replays after C's graph); F at K from S in a fresh workspace. Held: B
    and D capture nothing and reuse one graph, their tokens equal F's, and
    the thread's graph pool holds no live block after any call (every step
    leaves its outputs in workspace tensors). Printed: each call's
    first-step ms (A's and F's the eager warm-up, B's and D's a replay),
    the reserved GiB and the pool's bytes after it."""
    from streamchat_tpu_torch.models import generate_paged, step_graph

    lengths, kw, _ = GRAPH_CASES["int8"]["int8_b1"]
    embeds = [(torch.randn(1, GRAPH_PROMPT[1], cfg.hidden_size, generator=generator,
                           device="cuda") * 0.02).to(torch.bfloat16) for _ in range(2)]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sampling = GRAPH_SAMPLING["temperature"]
    step_graph.release()
    calls, toks = {}, {}

    def call(name, x, new=GRAPH_NEW_TOKENS):
        from streamchat_tpu_torch import kernels

        stats = {}
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[name], _ = generate_paged.generate_paged(params, cfg, x, ln, generator,
                                                      max_new_tokens=new, stats=stats,
                                                      **kw, **sampling)
        torch.cuda.synchronize()
        pool = step_graph.pool_bytes()
        calls[name] = dict(
            seconds=time.perf_counter() - t0, steps=stats["decode_steps"],
            graph_captures=stats["graph_captures"], graph_reuses=stats["graph_reuses"],
            graph_replays=stats["graph_replays"], first_step_ms=1e3 * stats["first_step_s"],
            decode_ms_per_step=1e3 * (stats["decode_s"] - stats["capture_s"])
            / stats["decode_steps"], launches=kernels.launch_counts()["qmatvec_int8"],
            workspaces=len(step_graph.workspaces()),
            reserved_gib=torch.cuda.memory_reserved() / 2**30,
            pool_reserved_bytes=None if pool is None else pool["reserved"],
            pool_active_bytes=None if pool is None else pool["active"])

    call("A", embeds[0])
    _poison_pool(step_graph.workspaces()[-1])
    state = generator.get_state()
    call("B", embeds[1])
    call("C", embeds[0], GRAPH_NEW_TOKENS + 1)
    generator.set_state(state)
    call("D", embeds[1])
    step_graph.release()
    generator.set_state(state)
    call("F", embeds[1])
    step_graph.release()
    report = dict(calls=calls, tokens_B_equal_F=bool((toks["B"] == toks["F"]).all()),
                  tokens_D_equal_F=bool((toks["D"] == toks["F"]).all()))
    for name, c in calls.items():
        print(f"decode graph reuse [{name}]: {json.dumps(c)}  [{smi}]", flush=True)
    print(f"decode graph reuse: tokens B == F {report['tokens_B_equal_F']}, D == F "
          f"{report['tokens_D_equal_F']}, first step ms A {calls['A']['first_step_ms']:.3f} "
          f"(warm-up) -> B {calls['B']['first_step_ms']:.3f} (replay)  [{smi}]", flush=True)
    kept = [calls[n] for n in "BD"]
    if (not report["tokens_B_equal_F"] or not report["tokens_D_equal_F"]
            or any(c["graph_captures"] or c["graph_reuses"] != 1
                   or c["graph_replays"] != c["steps"] for c in kept)
            or any(calls[n]["graph_captures"] != 1 for n in "ACF")
            or any(c["pool_active_bytes"] for c in calls.values())
            or calls["B"]["launches"] != calls["F"]["launches"]):
        raise AssertionError(f"decode graph reuse: {report}")
    return report


# Per-rank shapes at tp 4: Qwen2-7B (28 / 4 heads, ffn 18,944, vocab
# 152,064) gives a rank 7 query heads over 1 kv head, 4,736 MLP columns and
# 38,016 vocabulary columns; LLaMA-3-8B (32 / 8, 14,336, 128,256) 8 over 2,
# 3,584 and 32,064.
TP_W8 = {"qwen k/v": (1, 3584, 128, torch.bfloat16), "qwen q": (1, 3584, 896, torch.bfloat16),
         "qwen o": (1, 896, 3584, torch.bfloat16), "qwen gate/up": (1, 3584, 4736, torch.bfloat16),
         "qwen down": (1, 4736, 3584, torch.float32), "qwen head": (1, 3584, 38016, torch.float32),
         "llama q": (8, 4096, 1024, torch.bfloat16), "llama k/v": (8, 4096, 256, torch.bfloat16),
         "llama o": (8, 1024, 4096, torch.float32), "llama gate/up": (8, 4096, 3584, torch.bfloat16),
         "llama down": (8, 3584, 4096, torch.float32), "llama head": (8, 4096, 32064, torch.float32)}


def check_rank_shapes(g):
    """Each kernel at the shapes a tp-4 rank gives it, held to its plain
    twin (|d| <= ATOL + RTOL |plain| and row relative L2 <= ROW_REL_L2; the
    partial kernels through acc / l, m and l) -> {case: errors}. o and down
    write f32 under TP (their partial sums are all-reduced in f32)."""
    from streamchat_tpu_torch.ops import attention as att
    from streamchat_tpu_torch.ops import int4_matmul as i4
    from streamchat_tpu_torch.ops import paged_attention as pa
    from streamchat_tpu_torch.ops import quant

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    out = {}

    def held(name, got, ref, partial=False):
        err, rel = (_compare_partial if partial else
                    lambda n, a, b: _compare(n, a, b, row_rel=True))(name, got, ref)
        out[name] = dict(max_abs_err=err, max_row_rel_l2=rel)

    for name, (b, hq, hkv, s) in {"K3 qwen 7/1": (1, 7, 1, 4096),
                                  "K3 llama 8/2": (8, 8, 2, 1408)}.items():
        q, k, v = rnd(b, hq, s, 128), rnd(b, hkv, s, 128), rnd(b, hkv, s, 128)
        n = torch.randint(s // 2, s + 1, (b,), generator=g, device="cuda").to(torch.int32)
        held(name, att.flash_attention(q, k, v, n), att.flash_attention_plain(q, k, v, n))
    q, k, v = rnd(1, 7, 2048, 128), rnd(1, 1, 6144, 128), rnd(1, 1, 6144, 128)
    n = torch.tensor([6100], dtype=torch.int32, device="cuda")
    held("K5 qwen 7/1", att.flash_attention_partial(q, k, v, 4096, 0, n),
         att.flash_attention_partial_plain(q, k, v, 4096, 0, n), partial=True)
    length = torch.tensor([23105], dtype=torch.int32, device="cuda")
    pages = -(-23105 // 128) + 1
    kp, vp = rnd(pages, 1, 128, 128), rnd(pages, 1, 128, 128)
    ki, vi, ks, vs = _int8_pool(g, pages, 1, 23105)
    q1, q5 = rnd(1, 7, 1, 128), rnd(1, 7, 5, 128)
    held("K4 qwen 7/1", pa.paged_decode_attention_seq(q1, kp, vp, length),
         pa.paged_decode_attention_seq_plain(q1, kp, vp, length))
    held("K6 qwen 7/1", pa.paged_decode_attention_seq_int8(q1, ki, vi, ks, vs, length),
         pa.paged_decode_attention_seq_int8_plain(q1, ki, vi, ks, vs, length))
    held("K7 qwen 7/1 T 5", pa.paged_seq_attention_partial(q5, kp, vp, length),
         pa.paged_seq_attention_partial_plain(q5, kp, vp, length), partial=True)
    held("K7' qwen 7/1 T 5", pa.paged_seq_attention_partial_int8(q5, ki, vi, ks, vs, length),
         pa.paged_seq_attention_partial_int8_plain(q5, ki, vi, ks, vs, length), partial=True)
    lengths = [6100, 3050]
    table, _ = _shared_table(g, lengths, 128, 50, 98, hole=3)
    tlen = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kp, vp = rnd(98, 1, 128, 128), rnd(98, 1, 128, 128)
    ki, vi = (torch.randint(-127, 128, (98, 1, 128, 128), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(98, 1, 128, generator=g, device="cuda") * 0.04 + 0.01
              for _ in range(2))
    q2 = rnd(2, 7, 1, 128)
    held("K8 qwen 7/1", pa.paged_decode_attention_table(q2, kp, vp, table, tlen),
         pa.paged_decode_attention_table_plain(q2, kp, vp, table, tlen))
    held("K9 qwen 7/1", pa.paged_decode_attention_table_int8(q2, ki, vi, ks, vs, table, tlen),
         pa.paged_decode_attention_table_int8_plain(q2, ki, vi, ks, vs, table, tlen))
    for name, (rows, kin, cols, dt) in TP_W8.items():
        x = rnd(rows, kin)
        w = quant.quantize_weight(torch.randn(kin, cols, generator=g, device="cuda") * 0.02)
        held(f"W8 {name} {kin}->{cols}", quant.qmatvec_int8(x, w["w_i8"], w["scale"], dt),
             quant.qmatvec_int8_plain(x, w["w_i8"], w["scale"], dt))

    def w4(kin, cols):
        return quant.quantize_weight_int4(torch.randn(kin, cols, generator=g, device="cuda")
                                          * 0.02)

    x = rnd(1, 3584)
    for name, kin in (("o", 896), ("down", 4736)):
        w, xi = w4(kin, 3584), rnd(1, kin)
        held(f"K10 qwen {name} {kin}->3584", i4.qmatvec_int4(xi, w["w_i4p"], w["scale"]),
             i4.qmatvec_int4_plain(xi, w["w_i4p"], w["scale"]))
    for name, cols in (("q/k/v", (896, 128, 128)), ("gate/up", (4736, 4736))):
        flat = []
        for c in cols:
            w = w4(3584, c)
            flat += [w["w_i4p"], w["scale"]]
        got = i4.qmatvec_int4_fused(x, *flat, out_dtype=torch.bfloat16)
        ref = i4.qmatvec_int4_fused_plain(x, *flat, out_dtype=torch.bfloat16)
        for i, (a, b) in enumerate(zip(got, ref)):
            held(f"K11 qwen {name} part {i} 3584->{cols[i]}", a, b)
    print(f"per-rank kernel shapes (tp 4): {json.dumps(out)}", flush=True)
    return out


def _rotated(xs):
    """The list after one ring step: rank r now holds rank r - 1's entry."""
    return xs[-1:] + xs[:-1]


def _ring_emulated(q, k, v, layout, n, kv_length=None, fault=None):
    """`ring_attention` / `zigzag_ring_attention` / `stripe_ring_attention`
    for all n ranks in this process through their per-step functions, the
    K/V lists rotated a step at a time -> the whole output in natural
    order. `fault`: "skip rotation" (no rotation after step 0), "k_offset"
    (the last rank's own block one shard late), "no inverse" (zigzag's
    output left in the permuted order)."""
    from streamchat_tpu_torch.ops import ring_attention as ring

    qs, ks, vs = ([ring.sequence_shard(t, r, n, layout) for r in range(n)] for t in (q, k, v))
    sl = qs[0].shape[2]
    origins = list(range(n))
    if layout == "zigzag":
        states = [[ring.ring_init(x[:, :, :sl // 2]) for _ in range(2)] for x in qs]
    else:
        states = [ring.ring_init(x) for x in qs]
    for step in range(n):
        for r in range(n):
            o = origins[r]
            if layout == "zigzag":
                states[r] = ring.zigzag_step(states[r], qs[r], ks[r], vs[r], r, o, n)
            elif layout == "stripe":
                states[r] = ring.stripe_step(states[r], qs[r], ks[r], vs[r], r, o)
            else:
                late = fault == "k_offset" and step == 0 and r == n - 1
                states[r] = ring.ring_step(states[r], qs[r], ks[r], vs[r], r * sl,
                                           (o + late) * sl, kv_length=kv_length)
        if not (fault == "skip rotation" and step == 0):
            ks, vs, origins = _rotated(ks), _rotated(vs), _rotated(origins)
    outs = [torch.cat([ring.ring_finish(st, q.dtype) for st in s], 2) if layout == "zigzag"
            else ring.ring_finish(s, q.dtype) for s in states]
    full = torch.cat(outs, dim=2)
    if layout != "contiguous" and fault != "no inverse":
        idx = (ring.zigzag_indices if layout == "zigzag" else ring.stripe_indices)(q.shape[2], n)
        full = full.index_select(2, ring.inverse_permutation(idx).to(q.device).long())
    return full


def _ulysses_emulated(q, k, v, n, fault=None):
    """`ulysses_attention` for all n ranks: `exchange` scatters heads and
    gathers the sequence (split 1, concat 2), K3 on each rank's head slice,
    `exchange` back; fault "swapped axes" swaps split and concat both ways."""
    from streamchat_tpu_torch.ops import ring_attention as ring
    from streamchat_tpu_torch.ops import ulysses

    there, back = ((2, 1), (1, 2)) if fault == "swapped axes" else ((1, 2), (2, 1))
    qh, kh, vh = (ulysses.exchange([ring.sequence_shard(t, r, n) for r in range(n)], *there)
                  for t in (q, k, v))
    outs = [ulysses.ulysses_local(a, b, c) for a, b, c in zip(qh, kh, vh)]
    return torch.cat(ulysses.exchange(outs, *back), dim=2)


def _usp_emulated(q, k, v, nr=2, nu=2):
    """`usp_attention` on the nr x nu grid (rank a nu + u holds piece a nu +
    u): the Ulysses exchange within each row a, the ring over each column u
    at ring block a's offset, the exchange back."""
    from streamchat_tpu_torch.ops import ring_attention as ring
    from streamchat_tpu_torch.ops import ulysses

    n = nr * nu
    pieces = [[ring.sequence_shard(t, r, n) for r in range(n)] for t in (q, k, v)]
    grid = [[[None] * nu for _ in range(nr)] for _ in range(3)]
    for a in range(nr):
        for i in range(3):
            ex = ulysses.exchange(pieces[i][a * nu:(a + 1) * nu], 1, 2)
            for u in range(nu):
                grid[i][a][u] = ex[u]
    outs = [[None] * nu for _ in range(nr)]
    for u in range(nu):
        qs = [grid[0][a][u] for a in range(nr)]
        ks, vs, origins = [grid[1][a][u] for a in range(nr)], [grid[2][a][u] for a in range(nr)], \
            list(range(nr))
        block = qs[0].shape[2]
        states = [ring.ring_init(x) for x in qs]
        for _ in range(nr):
            for a in range(nr):
                states[a] = ring.ring_step(states[a], qs[a], ks[a], vs[a], a * block,
                                           origins[a] * block)
            ks, vs, origins = _rotated(ks), _rotated(vs), _rotated(origins)
        for a in range(nr):
            outs[a][u] = ring.ring_finish(states[a], q.dtype)
    back = [p for a in range(nr) for p in ulysses.exchange(outs[a], 2, 1)]
    return torch.cat(back, dim=2)


def drive_sp_ops(g, planted):
    """Ring (with a ragged kv_length), zigzag, stripe, Ulysses and USP (2 x
    2) at LongVA-7B's 28 / 4 heads, S = 16,384, B = 2, over 4 ranks emulated
    in this process (`_ring_emulated` and siblings: K5 a ring step, K3 a
    Ulysses head slice), each held to K3 over the whole sequence and to its
    plain twin (by kv head and query block) -> report. Planted faults must
    fail the same check: a rotation skipped, a block's k_offset one shard
    late, zigzag's inverse permutation left out, Ulysses' all-to-all with
    its split and concat axes swapped."""
    from streamchat_tpu_torch.ops.attention import flash_attention

    b, n = 2, SP_RANKS
    q = torch.randn(b, 28, SP_S, 128, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, 4, SP_S, 128, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kv_length = torch.tensor(SP_LENGTHS, dtype=torch.int32, device="cuda")
    refs = {}
    for name, kvl in (("full", None), ("ragged", kv_length)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k3 = flash_attention(q, k, v, kvl, causal=True)
        torch.cuda.synchronize()
        refs[name] = (k3, _plain_attention_blocked(q, k, v, kvl, causal=True),
                      time.perf_counter() - t0)
    cases = {"ring, ragged kv_length": (lambda f=None: _ring_emulated(
                 q, k, v, "contiguous", n, kv_length, f), "ragged"),
             "zigzag": (lambda f=None: _ring_emulated(q, k, v, "zigzag", n, fault=f), "full"),
             "stripe": (lambda f=None: _ring_emulated(q, k, v, "stripe", n, fault=f), "full"),
             "ulysses": (lambda f=None: _ulysses_emulated(q, k, v, n, f), "full"),
             "usp 2 x 2": (lambda f=None: _usp_emulated(q, k, v), "full")}
    report = {"k3_whole_s": refs["full"][2]}
    for name, (run, ref) in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k3, plain, _ = refs[ref]
        e_k3 = _compare(f"SP {name} vs K3 whole", got, k3, row_rel=True)
        e_plain = _compare(f"SP {name} vs plain", got, plain, row_rel=True)
        report[name] = dict(seconds=seconds, vs_k3=e_k3, vs_plain=e_plain)
    for name, (fault, case) in {"ring rotation skipped": ("skip rotation", "ring, ragged kv_length"),
                                "ring block k_offset one shard late": ("k_offset",
                                                                       "ring, ragged kv_length"),
                                "zigzag inverse permutation left out": ("no inverse", "zigzag"),
                                "ulysses all-to-all split / concat axes swapped": (
                                    "swapped axes", "ulysses")}.items():
        run, ref = cases[case]
        planted[f"SP {name}"] = _planted(f"SP {name}", run(fault), refs[ref][0])
        print(f"planted fault rejected: SP {name}: max row relative L2 err "
              f"{planted[f'SP {name}']:.6g} (limit {ROW_REL_L2})", flush=True)
    print(f"sequence-parallel ops (4 ranks emulated, S {SP_S}, 28 / 4 heads): "
          f"{json.dumps(report)}", flush=True)
    return report


def _sp_nccl_rank(rank, world, spec):
    """One rank of the SP ops over NCCL, a card a rank: the same seeded
    q / k / v on every card, this rank's shard of each layout through the
    ops' real transports (batch_isend_irecv, all_to_all_single), held to
    the same shard of K3 over the whole sequence."""
    import datetime

    import torch.distributed as dist

    from streamchat_tpu_torch.kernels.build import library
    from streamchat_tpu_torch.ops import ring_attention as ring
    from streamchat_tpu_torch.ops import ulysses
    from streamchat_tpu_torch.ops.attention import flash_attention
    from streamchat_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(rank)
    library()
    store = dist.FileStore(os.path.join(spec["dir"], "sp_nccl.store"), world)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        g = torch.Generator(device="cuda").manual_seed(99)
        q = torch.randn(2, 28, SP_S, 128, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(2, 4, SP_S, 128, generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        kv_length = torch.tensor(SP_LENGTHS, dtype=torch.int32, device="cuda")
        whole = {"full": flash_attention(q, k, v, causal=True),
                 "ragged": flash_attention(q, k, v, kv_length, causal=True)}
        mesh = make_mesh(2, 2)

        def shard(t, layout="contiguous"):
            return ring.sequence_shard(t, rank, world, layout)

        cases = {
            "ring, ragged kv_length": (lambda: ring.ring_attention(
                shard(q), shard(k), shard(v), kv_length=kv_length), "ragged", "contiguous"),
            "zigzag": (lambda: ring.zigzag_ring_attention(
                shard(q, "zigzag"), shard(k, "zigzag"), shard(v, "zigzag")), "full", "zigzag"),
            "stripe": (lambda: ring.stripe_ring_attention(
                shard(q, "stripe"), shard(k, "stripe"), shard(v, "stripe")), "full", "stripe"),
            "ulysses": (lambda: ulysses.ulysses_attention(shard(q), shard(k), shard(v)),
                        "full", "contiguous"),
            "usp 2 x 2": (lambda: ulysses.usp_attention(shard(q), shard(k), shard(v), mesh),
                          "full", "contiguous")}
        rep = {}
        for name, (run, ref, layout) in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            rep[name] = dict(seconds=time.perf_counter() - t0, errors=_compare(
                f"SP {name} over NCCL, rank {rank}", got, shard(whole[ref], layout),
                row_rel=True))
        torch.save(rep, os.path.join(spec["dir"], f"sp_nccl_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_nccl_phases(tp_dir, tp_argv, refs, counts, dp_argv, dp_refs, planted):
    """Phases 2 and 6 again over NCCL, one card a rank, through the real
    transports, where the machine has a card for each rank; else one line
    saying why they did not run -> report or None. The data-axis phase runs
    over NCCL where there are DP_WORLD cards."""
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    report = {}
    if cards >= DP_WORLD:
        with phase(f"data axis over NCCL: runner --shard, {DP_WORLD} ranks, a card a rank"):
            report["dp2_tp4_runner_nccl"], counts["dp2_tp4_runner_nccl"] = run_data_axis_phase(
                "dp2_tp4_runner_nccl", dict(job="runner", argv=dp_argv, dir=tp_dir,
                                            backend="nccl"), dp_refs, planted)
    else:
        print(f"data axis over NCCL: not run: {cards} CUDA device(s), it needs {DP_WORLD}",
              flush=True)
    if cards < max(TP_WORLD, SP_RANKS):
        print(f"NCCL phases (runner --shard over NCCL, the SP ops through batch_isend_irecv "
              f"and all_to_all_single): not run: {cards} CUDA device(s), they need "
              f"{max(TP_WORLD, SP_RANKS)} (NCCL takes one card a rank)", flush=True)
        return report or None
    with phase("TP over NCCL: runner --shard off-line int8, tp 4, a card a rank"):
        report["tp4_runner_offline_nccl"], counts["tp4_runner_offline_nccl"] = run_tp_phase(
            "tp4_runner_offline_nccl", TP_WORLD,
            dict(job="runner", argv=tp_argv, dir=tp_dir, backend="nccl"), refs["off_line"])
    with phase("SP ops over NCCL, a card a rank"):
        mp.spawn(_sp_nccl_rank, args=(SP_RANKS, dict(dir=tp_dir)), nprocs=SP_RANKS, join=True)
        report["sp_nccl"] = [torch.load(os.path.join(tp_dir, f"sp_nccl_rank{r}.pt"))
                             for r in range(SP_RANKS)]
    print(f"NCCL phases: {json.dumps(report)}", flush=True)
    return report


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from streamchat_tpu_torch.kernels.build import build, library

    t_start = time.perf_counter()
    smi = _smi()
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = build(force=True)
    library()
    print(f"kernel build: {info['seconds']:.2f} s", flush=True)

    root = tempfile.mkdtemp(prefix="sc_checkpoints_")
    try:
        run_all(info, smi, t_start, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_all(info, smi, t_start, root) -> None:
    """Every phase after the build, with checkpoints written under `root`."""
    from streamchat_tpu_torch.config import PipelineConfig
    from streamchat_tpu_torch.models import step_graph
    from streamchat_tpu_torch.pipeline.runner import build_pipeline

    torch.cuda.reset_peak_memory_stats()
    with phase("pipeline build (random LongVA-7B weights, seeded)"):
        written = build_pipeline(PipelineConfig(), device="cuda", dtype=torch.bfloat16,
                                 geometry="longva7b")
    with phase("write the pipeline's checkpoints and load them (build_pipeline)"):
        pipe, paths, loads = load_pipeline(written, root)
    with phase("planted loader faults"):
        planted = {name: float(len(bad)) for name, bad in
                   check_loader_faults(written.model, root).items()}
    with phase(f"write LongVA-7B cut to {TP_LAYERS} layers (the TP phases' checkpoint)"):
        paths_tp = dict(paths, longva=write_tp_longva(written.model, root))
    del written                                       # the written trees
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(1234)

    with phase("kernel checks K1-K4"):
        rows, kplanted = check_kernels(pipe.model, g)
    planted.update(kplanted)
    with phase("kernel checks W8, K10, K11, K6"):
        qrows, qplanted = check_quant_kernels(pipe.model, g)
    rows.update(qrows)
    planted.update(qplanted)
    with phase("kernel checks K5, K7, K7′"):
        prows, pplanted = check_partial_kernels(pipe.model, g)
    rows.update(prows)
    planted.update(pplanted)
    with phase("kernel checks K8, K9"):
        trows, tplanted = check_table_kernels(pipe.model, g)
    rows.update(trows)
    planted.update(tplanted)
    with phase("kernel checks: the decode step's glue"):
        grows, gplanted = check_glue_kernels(pipe.model, g)
    rows.update(grows)
    planted.update(gplanted)
    with phase("kernel checks K12, K13, K14"):
        vrows, vplanted = check_vit_kernels(pipe.model, g)
    rows.update(vrows)
    planted.update(vplanted)
    with phase("kernel checks K15, K16, K17"):
        brows, bplanted = check_probe_kernels(g)
    rows.update(brows)
    planted.update(bplanted)
    torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"{name}: max_abs_err {row['max_abs_err']:.6g}  max_row_rel_l2 "
              f"{row.get('max_row_rel_l2')}  kernel {row['ms']:.4f} ms (wall "
              f"{row['wall_ms']:.4f})  plain {row['plain_ms']:.4f} ms (wall "
              f"{row['plain_wall_ms']:.4f})  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library {row['library_ms']}  [{row['shapes']}]")
        for label, case in row.get("cases", {}).items():
            print(f"    {label}: {json.dumps(case)}")
        extra = {k: v for k, v in row.items() if k.startswith(
            ("share_of_bound", "attributes", "launch_ms", "gemm_", "attention_", "dma_to_cur",
             "blocks", "gbs", "host_us", "b2_", "t10_", "ms_length", "ms_row0", "caller_",
             "launch_floor", "wrapper_ms"))
            or k.endswith("_s4096")}
        if extra:
            print(f"    {json.dumps(extra)}")
    for name, err in planted.items():
        metric, limit = (("max |sim - plain sim|", SIM_ATOL) if name.startswith("K12")
                         else ("leaves not bit-equal", 0) if name.startswith("loader")
                         else ("max row relative L2 err", ROW_REL_L2))
        print(f"planted fault rejected: {name}: {metric} {err:.6g} (limit {limit})")
    with phase("composed checks (bf16)"):
        composed = check_composed(pipe.model, g)
        composed["verify_step_vs_decode_steps"] = check_composed_spec(pipe.model, g)
        composed["table_decode_step_b3"] = check_composed_table(pipe.model, g)
    with phase("chunk-40 caption prefill, one pass vs chunked"):
        prefill_cmp = compare_prefill(pipe.model, g)
    print(f"caption prefill one pass vs chunked: {json.dumps(prefill_cmp)}", flush=True)

    m = pipe.model
    runs, counts, caller = {}, {}, {}
    with phase("probes (K15 probe_int4, K16 / K17 probe_vit_variants)"):
        probes, counts["probes"] = drive_probes()
    torch.cuda.empty_cache()
    for kv_int8 in (False, True):
        label = "caller_pool_kv_int8" if kv_int8 else "caller_pool_bf16"
        with phase(f"generate_paged on a caller-sized pool ({label})"):
            caller[label], counts[label] = drive_caller_pool(m, g, kv_int8)
    with phase("generate_paged, spec_tokens 9, kv_int8 (70 rows a kv head)"):
        spec_rows, counts["spec9_kv_int8"] = drive_spec_rows(m, g)
    states = _generator_states(pipe)
    with phase("process_video bf16, 1 breakpoint"), configured(pipe, sampling=SHORT_ANSWER), \
            _decoded_ids(m) as bf16_ids:
        runs["bf16"], counts["bf16"] = drive(pipe, "bf16", BREAKPOINTS[:1])
    with phase("process_video bf16, 1 breakpoint, --offload_chunks --offload_residents"):
        offload, counts["bf16_offload"] = drive_offload(pipe, bf16_ids, states, runs["bf16"])
    with phase("planted: a restore that skips one tree"):
        name = "offload restore skips the bank embedder"
        planted[name] = float(check_restore_fault(pipe))
    print(f"planted fault rejected: {name}: trees not restored {planted[name]:.6g} (limit 0)")
    frames = _smoke_frames(S2_FRAMES)
    ingest, ingest_counts = drive_s2_anyres(m, g, frames)
    counts.update(ingest_counts)
    host_frames = drive_frameproc(frames)
    library = drive_library_ops(g, frames)
    del frames
    torch.cuda.empty_cache()
    with phase("traced run: process_video bf16, full depth, 1 breakpoint, under "
               "maybe_device_trace"):
        traced, counts["traced_bf16"] = drive_traced(pipe, planted)
    graphs = {}
    with phase("decode steps as CUDA graphs against eager steps (bf16 tree)"):
        graphs["bf16"], counts["graphs_bf16"] = drive_graphs(m.dec_params, m.dec_cfg, g,
                                                             "bf16", smi)
    bf16_tree = m.dec_params
    with phase("quantize int8 + composed check"):
        m.quantize()                                  # the CLI default, as `main` does
        composed["int8_step_logits_rel_l2_err"] = check_composed_quant(
            m, g, "int8", ("qmatvec_int8",))
    with phase("decode steps as CUDA graphs against eager steps (int8 tree)"):
        graphs["int8"], counts["graphs_int8"] = drive_graphs(m.dec_params, m.dec_cfg, g,
                                                             "int8", smi)
    with phase("decode graphs kept across generate calls (int8 tree)"):
        graph_reuse = drive_graph_reuse(m.dec_params, m.dec_cfg, g, smi)
    glue_steps = {}
    with phase("decode step split, plain glue against the glue kernels (int8 tree)"):
        glue_steps["int8"] = drive_glue_steps(m.dec_params, m.dec_cfg, g, "int8", smi)
    # The glue rows' launches a step: the counters of a graphed int8 step.
    for name, a_step in glue_steps["int8"]["fused"][0]["launches_a_step"].items():
        rows[name]["launches_a_step"] = a_step
    with phase("process_video int8, 2 breakpoints"):
        runs["int8"], counts["int8"] = drive(pipe, "int8", BREAKPOINTS)
    with phase("process_video_online int8, 2 breakpoints"):
        runs["online_int8"], counts["online_int8"] = drive(
            pipe, "online_int8", BREAKPOINTS, online=True, captions=runs["int8"]["captions"])
    with phase("dedup threshold from the first segment"):
        threshold, change = measure_dedup(pipe, BREAKPOINTS[0]["time"])
    print(f"dedup threshold {threshold!r} (median 1 - sim of the first segment's frames "
          f"1..; min {min(change)!r}, max {max(change)!r}, {len(change) + 1} frames)")
    with phase("process_video_online int8 + dedup, 1 breakpoint"), \
            dedup_threshold(pipe, threshold):
        runs["online_int8_dedup"], counts["online_int8_dedup"] = drive(
            pipe, "online_int8_dedup", BREAKPOINTS[:1], online=True)
    with phase(f"process_video int8, spec_tokens {SPEC_TOKENS}, 1 breakpoint"), \
            configured(pipe, sampling=SHORT_ANSWER):
        m.spec_tokens = SPEC_TOKENS
        runs["int8_spec"], counts["int8_spec"] = drive(pipe, "int8_spec", BREAKPOINTS[:1])
        m.spec_tokens = 0
    with phase("process_video int8, caption_batch 2, 1 breakpoint"), \
            configured(pipe, sampling=dict(SHORT_ANSWER, caption_batch=2)):
        runs["int8_cb2"], counts["int8_cb2"] = drive(pipe, "int8_cb2", BREAKPOINTS[:1])
    option_runs, option_counts = drive_answer_options(pipe, planted)
    runs.update(option_runs)
    counts.update(option_counts)
    h2o, h2o_counts = drive_h2o(pipe, planted)
    counts.update(h2o_counts)
    gc.collect()
    torch.cuda.empty_cache()
    runners, runner_counts = drive_runners(paths["longva"], root)
    counts.update(runner_counts)
    tools = drive_streambench(root)
    m.dec_params = bf16_tree                          # frees the int8 tree
    step_graph.release()                              # and its kept decode workspaces
    torch.cuda.empty_cache()
    with phase("quantize int4 + composed check"):
        m.quantize(bits=4)
        m.kv_int8 = True
        composed["int4_step_logits_rel_l2_err"] = check_composed_quant(
            m, g, "int4", ("qmatvec_int4", "qmatvec_int4_fused", "qmatvec_int8"))
    with phase("decode steps as CUDA graphs against eager steps (int4 tree, kv_int8)"):
        graphs["int4"], counts["graphs_int4"] = drive_graphs(m.dec_params, m.dec_cfg, g,
                                                             "int4", smi)
    with phase("decode step split, plain glue against the glue kernels (int4 tree, kv_int8)"):
        glue_steps["int4_kv_int8"] = drive_glue_steps(m.dec_params, m.dec_cfg, g,
                                                      "int4_kv_int8", smi)
    with phase("process_video int4 + kv_int8, 1 breakpoint"), \
            configured(pipe, sampling=SHORT_ANSWER):
        runs["int4_kv_int8"], counts["int4_kv_int8"] = drive(pipe, "int4_kv_int8",
                                                             BREAKPOINTS[:1])
    with phase(f"process_video int4 + kv_int8, spec_tokens {SPEC_TOKENS}, 1 breakpoint"), \
            configured(pipe, sampling=SHORT_ANSWER):
        m.spec_tokens = SPEC_TOKENS
        runs["int4_kv_int8_spec"], counts["int4_kv_int8_spec"] = drive(
            pipe, "int4_kv_int8_spec", BREAKPOINTS[:1])
        m.spec_tokens = 0
    with phase("process_video int4 + kv_int8, caption_batch 2, 1 breakpoint"), \
            configured(pipe, sampling=dict(SHORT_ANSWER, caption_batch=2)):
        runs["int4_kv_int8_cb2"], counts["int4_kv_int8_cb2"] = drive(
            pipe, "int4_kv_int8_cb2", BREAKPOINTS[:1])
    predictions = [r for v in runs.values() for r in v.pop("predictions")]
    process_video_graphs = {k: (v["generate_calls"], v["graph_captures"], v["graph_reuses"])
                            for k, v in {**runs, "bf16_offload": offload}.items()}
    calls, captures = (sum(c[i] for c in process_video_graphs.values()) for i in (0, 1))
    print(f"process_video decode graphs (generate calls, captures, reuses): "
          f"{json.dumps(process_video_graphs)}; {calls} calls, {captures} captures  [{smi}]",
          flush=True)
    if captures >= calls or process_video_graphs["bf16_offload"][1]:
        raise AssertionError("process_video runs did not replay kept graphs: "
                             f"{process_video_graphs}")
    del pipe, m, bf16_tree                            # LongVA's trees
    step_graph.release()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"LongVA freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated",
          flush=True)
    tp_dir, tp_argv = _tp_inputs(root, paths_tp)
    with phase("TP references: runner int8 unsharded, off-line and on-line"):
        tp_refs = {mode: _tp_reference(tp_dir, tp_argv + extra, f"ref_{mode}")
                   for mode, extra in (("off_line", []), ("on_line", ["--mode", "on_line"]))}
    tp = {}
    with phase(f"TP: runner --shard off-line int8, tp {TP_WORLD} (gloo, ranks sharing the card)"):
        tp["tp4_runner_offline"], counts["tp4_runner_offline"] = run_tp_phase(
            "tp4_runner_offline", TP_WORLD, dict(job="runner", argv=tp_argv, dir=tp_dir),
            tp_refs["off_line"])
    with phase(f"TP: runner --shard --mode on_line int8, tp {TP_ONLINE_WORLD} (gloo)"):
        tp["tp2_runner_online"], counts["tp2_runner_online"] = run_tp_phase(
            "tp2_runner_online", TP_ONLINE_WORLD,
            dict(job="runner", argv=tp_argv + ["--mode", "on_line"], dir=tp_dir),
            tp_refs["on_line"])
    dp_argv = _dp_inputs(tp_dir, tp_argv)
    with phase("data axis references: runner int8 unsharded, --num_chunks 2 --chunk_idx 0 / 1"):
        dp_whole = [_tp_reference(tp_dir, dp_argv + ["--num_chunks", "2", "--chunk_idx", str(c)],
                                  f"ref_dp{c}") for c in range(2)]
    with phase(f"data axis reference: runner --shard tp {TP_WORLD}, --num_chunks 2 --chunk_idx 1 "
               "(gloo)"):
        tp["tp4_runner_chunk1"], counts["tp4_runner_chunk1"] = run_tp_phase(
            "tp4_runner_chunk1", TP_WORLD, dict(job="runner", dir=tp_dir, argv=dp_argv + [
                "--num_chunks", "2", "--chunk_idx", "1"]), dp_whole[1])
    dp_refs = data_axis_refs(tp_dir, tp, dp_whole)
    with phase(f"data axis: runner --shard off-line int8, {DP_WORLD} ranks, dp 2 x tp 4 (gloo, "
               "ranks sharing the card)"):
        data_axis, counts["dp2_tp4_runner"] = run_data_axis_phase(
            "dp2_tp4_runner", dict(job="runner", argv=dp_argv, dir=tp_dir), dp_refs, planted)
    nccl = run_nccl_phases(tp_dir, tp_argv, tp_refs, counts, dp_argv, dp_refs, planted)
    for path in {**paths, "longva_tp": paths_tp["longva"]}.values():   # LongVA's checkpoints
        shutil.rmtree(path)
    judge_reports, judge_scores, judge_counts, judge_load = run_judge(predictions, root, smi,
                                                                      graphs)
    counts.update(judge_counts)
    gc.collect()
    torch.cuda.empty_cache()
    with phase(f"TP: judge TextLM.shard int8, LLaMA-3-8B, tp {TP_WORLD} (gloo)"):
        preds = list(itertools.islice(itertools.cycle(predictions), JUDGE_BATCH))
        tp["tp4_judge_int8"], counts["tp4_judge_int8"] = run_tp_phase(
            "tp4_judge_int8", TP_WORLD, dict(job="judge", llama=judge_load["tp_path"],
                                              preds=preds, dir=tp_dir))
    shutil.rmtree(judge_load["tp_path"])
    with phase("per-rank kernel shapes (tp 4) against their plain twins"):
        tp["rank_shapes"] = check_rank_shapes(g)
    with phase(f"sequence-parallel ops, {SP_RANKS} ranks emulated, S {SP_S}"):
        tp["sp_ops"] = drive_sp_ops(g, planted)
    tp["nccl"] = nccl
    for label, name in (("judge_bf16", "judge decode appends at row 0's length"),
                        ("judge_int8_spec4", "judge verify writes at row 0's positions")):
        fault = judge_reports[label]["planted_appends_at_row0"]
        planted[name] = fault["appended_kv_rel_l2"]
        print(f"planted fault rejected: {name}: written K/V relative L2 err "
              f"{fault['appended_kv_rel_l2']:.6g}, logits row relative L2 err "
              f"{fault['logits_row_rel_l2']:.6g} (limit {STEP_REL_L2})")
    print(f"stage 3 scores: {json.dumps(judge_scores)}")
    for label, load in (("LongVA-7B, mxbai-colbert-large, MiniLM-L6", loads),
                        ("LLaMA-3-8B", judge_load)):
        print(f"checkpoint [{label}]: {load['disk_bytes']} bytes on disk, {load['leaves']} "
              f"leaves bit-equal to the written tree, write {load['write_s']:.3f} s "
              f"({load['write_gbs']:.3f} GB/s), load {load['load_s']:.3f} s "
              f"({load['load_gbs']:.3f} GB/s), raw read {load['raw_read_s']:.3f} s "
              f"({load['raw_read_gbs']:.3f} GB/s; load / raw read "
              f"{load['load_over_raw_read']:.3f}), host peak RSS "
              f"{load['peak_rss_gib_before_write']:.3f} -> "
              f"{load['peak_rss_gib_after_write']:.3f} -> "
              f"{load['peak_rss_gib_after_raw_read']:.3f} -> "
              f"{load['peak_rss_gib_after_load']:.3f} GiB (before the write, after it, after "
              f"the raw read, after the load), device peak {load['device_peak_gib']:.3f} GiB  "
              f"[{smi}]")
    print(f"composed checks: {json.dumps(composed)}")
    print(f"decode graphs: {json.dumps(graphs)}  [{smi}]")
    print("decode graph summary (ms a step eager -> graphed, capture s, launches a replay): "
          + ", ".join(f"{k} {v['eager_ms_per_step']:.2f} -> {v['graphed_ms_per_step']:.2f}, "
                      f"{v['capture_s']:.3f} s, {v['launches_per_replay']:.0f}"
                      for rows in graphs.values() for k, v in rows.items())
          + f"; the graph phases' generations took "
          f"{sum(v['graphed_s'] + v['eager_s'] for r in graphs.values() for v in r.values()):.1f}"
          f" s in all  [{smi}]")
    print(f"decode graphs kept across calls: {json.dumps(graph_reuse)}  [{smi}]")
    print(f"decode step split, plain glue against the glue kernels: "
          f"{json.dumps(glue_steps)}  [{smi}]")
    print(f"spec_tokens 9 over int8 pages: {json.dumps(spec_rows)}")
    print(f"probe results: {json.dumps(probes)}")
    print(f"H2O: {json.dumps(h2o)}")
    print(f"runners: {json.dumps(runners)}")
    print(f"host offload: {json.dumps(offload)}")
    print(f"ingest variants: {json.dumps(ingest)}; frameproc: {json.dumps(host_frames)}")
    print(f"library modules: {json.dumps(library)}; StreamBench tools: {json.dumps(tools)}")
    print(f"data axis (dp 2 x tp 4 on one card over gloo): {data_axis['seconds']:.1f} s, "
          f"tokens equal to the tp-4 --num_chunks 2 runs {data_axis['tokens_equal_to_tp_run']}, "
          f"leading tokens equal to the unsharded ones "
          f"{data_axis['leading_tokens_equal_to_unsharded']} of {data_axis['tokens']}, "
          f"first step logits row rel L2 "
          f"{data_axis['first_step_logits_row_rel_l2']}, bytes a rank after shard "
          f"{[r['device_bytes_after_shard'] for r in data_axis['per_rank']]}  [{smi}]")
    print("traced run phases: " + ", ".join(
        f"{p} wall {r['wall_s']} s device {r['device_s']} s idle {r['idle_share']}"
        for p, r in traced["phases"].items()) + f"; trace {traced['trace_mb']:.1f} MB  [{smi}]")
    print("multi-GPU: " + ", ".join(
        f"{k} {v['seconds']:.1f} s ({v['backend']}, tokens equal on every rank "
        f"{v['tokens_equal_on_every_rank']}, {v['leading_tokens_equal_to_unsharded']} of "
        f"{v['unsharded_tokens']} leading tokens equal to the unsharded run, first step "
        f"logits row rel L2 {v['first_step_logits_row_rel_l2']:.3g}, all_reduce "
        f"{v['collectives'][0]['count']} calls / {v['collectives'][0]['bytes']} B / "
        f"{v['collectives'][0]['seconds']:.3f} s on rank 0)"
        for k, v in tp.items() if isinstance(v, dict) and "backend" in v) + f"  [{smi}]")

    report = []
    for n, row in rows.items():
        by_run = {label: c.get(n, 0) for label, c in counts.items()}
        report.append(dict(name=n, route="cuda", source=SOURCES[n][0], replaces=SOURCES[n][1],
                           launches=sum(by_run.values()), launches_by_run=by_run, **row))
    print(f"summary: kernel build {info['seconds']:.2f} s, runs "
          + ", ".join(f"{k} {v['seconds']:.3f} s ({v['decode_ms_per_step']:.2f} ms/step, "
                      f"{v['decode_ms_per_emitted_token']:.2f} ms/token, "
                      f"{v['caption_s_per_caption']:.3f} caption s/caption)"
                      for k, v in runs.items())
          + ", caller-sized pool " + ", ".join(
              f"{k} {v['seconds']:.3f} s ({v['decode_ms_per_step']:.2f} ms/step)"
              for k, v in caller.items())
          + ", judge " + ", ".join(
              f"{k} {v['seconds']:.3f} s (prefill {v['prefill_s']:.3f} s, "
              f"{v['decode_ms_per_step']:.2f} ms/step, {v['peak_gib']:.2f} GiB)"
              for k, v in judge_reports.items())
          + ", H2O " + ", ".join(
              f"{k} prefill {v['prefill_s']:.3f} s, {v['decode_ms_per_step']:.2f} ms/step eager "
              f"(observed), {v['graphed']['decode_ms_per_step']:.2f} graphed, "
              f"{v['compressions_at_prefill']} + {v['compressions_in_loop']} compressions"
              for k, v in h2o.items() if k.startswith("h2o_budget"))
          + ", runners " + ", ".join(f"{k} {v['s_per_item']:.3f} s/item"
                                     for k, v in runners.items())
          + f", host offload: stack {offload['stack_bytes']} B and trees "
          f"{offload['residents_bytes']} B parked, allocated down "
          f"{offload['fall_at_first_caption']} B at the first caption, tokens equal "
          f"{offload['tokens_equal_to_bf16_run']}"
          + f", S2 {ingest['s2']['s2_frames_per_s']:.1f} frames/s (single scale "
          f"{ingest['s2']['single_scale_frames_per_s']:.1f})"
          + ", probes: K16 combo "
          f"{probes['probe_vit_variants']['combo']['ms_per_layer_call']:.3f} ms/layer, K17 "
          f"qk64 {probes['probe_vit_variants']['dotk']['qk64']['us_per_call']:.2f} us, K15 "
          f"sweep on {probes['probe_int4']['sweep_variant']}"
          + f", planted faults rejected {len(planted)}, total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
