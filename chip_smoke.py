#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one output line each (or a few), every failure raising:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build: the seven CUDA sources of src/repro_torch/csrc (the nine
     kernels and the dequant-fused decode), compiled with one nvcc each,
     started together; then, per kernel
     function, the registers, stack and spills that ptxas reported
     (-Xptxas=-v, in the build logs) and the count of tensor-core
     instructions (IMMA / IGMMA / HMMA / HGMMA / BMMA) in cuobjdump -sass,
     required in B2's, B3's bf16, B1's, B5's and B6's kernel functions;
  3. int8: the int8-binary GEMM kernel against its plain version at the
     serving path's shapes (decode M = 1, 8 and 16, the speculative
     verify's M = 8 x 4 = 32, prefill M = 8 x 128 and 8 x 256, an
     interleaved prefill slice's M = 64 and 128, bin_in
     (N, K) = (6912, 2560) and bin_out (2560, 6912); minicpm3-4b's
     bin_in (6400, 2560) and bin_out (2560, 6400) at decode M = 8 and
     prefill M = 1024; qwen3-8b's bin_in (12288, 4096) at decode, and the
     bin_out of qwen3-8b (4096, 12288), llama-3.2-vision-11b (4096, 14336)
     and qwen2-72b (8192, 29568: K = 32 x 924) at decode and prefill;
     zamba2-2.7b's in_zx (10240, 2560) and out (2560, 5120) and rwkv6-3b's
     c_k (8960, 2560) and c_v (2560, 8960: K = 32 x 280) at decode M = 8
     and prefill M = 1024; a mesh rank's shards of stablelm-3b's (3456)
     and minicpm3-4b's (3200 = 32 x 100) binary FFNs),
     a ragged case and, with activations over all of [-128, 127], a
     decode and a prefill case, required to be exactly equal; times of the
     kernel, the plain version and one cuBLAS call on unpacked operands
     (torch._int_mm where it takes the shape, else an exact f32 torch.mm)
     beside the bound; then, for the serving path's shapes, the kernel at
     every K split it takes (1, 2, 4, 8 chunks), each exact, timed beside
     the split its host plan picks (the plan's model, measured);
  4. flash: the flash-attention kernel against its plain version in bf16 at
     B = 8, S = T = 128 and 256, 32 heads of 80, causal, full and ragged
     kv_len (a row of length 1), S = 152, a q_offset block, GQA and head
     dims 64 and 128, within bf16's tolerance of 3e-2
     (tests/test_attention.py TOLS); times beside the bound and
     scaled_dot_product_attention's (with enable_gqa for the GQA case, on
     torch >= 2.5); then MLA's head dims, q and k of width D, v of Dv:
     minicpm3-4b's (8, 128, 40 heads, 96 / 64) causal and with ragged
     kv_len, deepseek-v2's (8, 128, 128 heads, 192 / 128) causal, a mesh
     rank's 20 / 64 of those heads (6g), and the
     smoke configs' (2, 32, 4 heads, 24 / 16) in bf16 and f32 (2e-5), SDPA
     timed through the first backend that takes Dv != D (named); then
     non-causal, S != T, T off the 64-key tile: whisper-base's encoder (8,
     1500, 8 heads of 64) and cross-attention (S 32 and 1 over T 1500),
     llama-3.2-vision-11b's cross-attention (S 128 and 1 over 1601 patches,
     32 / 8 heads of 128), beside SDPA with no mask (enable_gqa for the
     VLM). Every bf16 case is also held to 2^-6 of each batch row's largest
     |output| (an output over 1500 keys is ~0.04), and every case, on v
     made constant along the keys, must give that constant within 1 bf16
     ulp (2e-5 in f32): an unmasked key of the last tile's zero-filled tail
     would pull it ~1.4% towards 0;
  5. kv_quant: the insert kernel (B4a / B4c: K and V encoded and written
     into the pool in one launch) bit for bit against its plain version
     (the encode pair, then the pool's torch scatter) at the serving shape:
     the decode insert (B 8, 32 kv heads of 80, T 256, bf16, lengths
     {144, 100, 17, 1, 0, 256, 48, 128}) on the contiguous pool and on a
     paged pool (block 16, shuffled blocks, holes, slot 4 free, len 256
     past the table's pages), every byte outside the written rows
     unchanged, the same bits on a second call, the paged rows equal to
     the contiguous ones; the prefill encode (B 8, S 128 into max_len 256,
     bf16 and f32); each timed beside the plain version, the path it
     replaced (two row-mode launches, then the torch scatter or
     zero-padding: before_ms) and the byte bound. Then the rows mode and
     the two dequantizers (B4b, B4d) at the decode insert (8, 1, 32, 80),
     the prefill encode (8, 128, 32, 80) in bf16 and f32, ragged row
     counts and D = 129 and 16, each with an all-zero row; times beside the
     byte bound (no PyTorch call computes any of them: no yardstick). The
     span insert (the speculative verify's write of S = 4 tokens a slot at
     the same lengths, clamped at T - S on the contiguous pool, through a
     table with pages up to each span's end on the paged one) is held the
     same way, bit for bit, beside its plain version and byte bound;
 5b. kv_decode: the dequant-fused decode attention (B4b's / B4d's math in
     registers) for int8 and binary on the contiguous pool and a paged pool
     (block 16, shuffled blocks, holes past each length) at B 8, T 256,
     lengths {144, 100, 17, 1, 0, 256, 48, 128}, 32 heads of 80 with bf16
     and f32 q, G 4 (Hq 32, Hkv 8), D 64 and 128, a mesh rank's 16 heads,
     qwen3-8b's 32 / 8 heads of 128 and qwen2-72b's 64 / 8: rows with len >= 1
     within 1e-4 (f32 q) / 2e-2 (bf16 q) of the plain version, len-0 rows
     zeros, the same bits on a second call and on both pools; times beside
     the plain recurrence, the earlier loop of per-block B4b / B4d
     launches, the byte bound and, as context only, SDPA over a bf16 cache
     of the same lengths; then the verify's attend with per-query lengths
     (S 4, query j below len + j + 1, bf16 q) within 2e-2, one launch a
     call, beside its plain version, bound and SDPA with the same masks,
     and the same at an interleaved prefill slice's S 8 (one launch) and
     S 16 (two launches of 8 query rows, each query keeping its length);
  6. serve: stablelm-3b at full width (d_model 2560, bf16, cut to 16 of
     its 32 layers for the script's time limit; random init
     from a seeded torch.Generator on the card) through
     ServeEngine(max_batch=8, max_len=256), 12 requests of 16 new tokens,
     on five paths, each with the launch counts zeroed just before it and
     read just after. Each decode tick is one CUDA graph replay (one replay
     a step, checked); what a replay adds to the counts (taken from the
     wrappers' counts during the capture) must equal, per family of our
     kernels, the captured graph's kernel nodes as libcuda names
     them; the bf16 and int8 runs are also traced, and there the device's
     kernel events must equal the counts plus the graph's warm-up step.
     Each path is run twice for the same tokens and once eagerly
     (cuda_graphs=False), whose tokens must equal the replayed ones, both
     tok/s kept: the bf16 pool, the int8 and the binary pools, and,
     on prompts that share a 64-token header with the first request served
     alone before the rest, the int8 pool and a paged int8 pool (block 16)
     with the radix prefix cache. On each: every request gets 16 tokens in
     range; launches are exactly 2 x 12 per wave and per step (int8 GEMM),
     16 per wave without a cached prefix (flash), 16 per wave and per step
     of the codec's insert kernel, 16 per step of its kv_decode, 2 x 16 of
     its dequantizer per wave on a cached prefix (its context), 0 of the
     rest; the pool's bytes are exact (335,544,320
     / 171,966,464 / 29,360,128); a second run gives the same tokens; the
     paged run hits the prefix cache. Logits are finite;
     layer 0 agrees with the plain attention on a small batch, and its
     int8 and binary caches decode as their materialized copies do (2e-2).
     The traced runs of the bf16 and int8 paths, replayed (the counted run)
     and eager, give the device time by kernel and the device's busy share
     of the unprofiled wall time, with every kernel symbol of csrc mapped
     to its family (B2 and B3 must show device time in both bf16 runs, and
     kv_decode and the insert kernel in both int8 runs);
 6b. spec: the same model with spec_k = 3 (the binarized self-draft: its
     4 float FFNs x 3 matrices through B1) on five paths: bf16, int8 and
     binary contiguous greedy, paged int8 with the prefix cache on the
     header prompts, and int8 sampled (temperature 0.8, beside a plain
     sampled int8 run), each wave one graph replay whose counts are held to
     the graph's kernel nodes as in 6: every request gets 16
     tokens in range; launches exactly, per wave, B1 3 x 4 x k, B2 2 x 12
     x (k + 1), the codec's insert kernel and kv_decode 16 x (k + 1) each
     (and per prefill wave as on the plain paths); one draft launch and one
     replay a wave; a second run's tokens and the eager waves' tokens equal;
     acceptance > 0 over the five paths (random weights: the greedy draft
     may never agree with the target, whose top-2 gaps are small; the
     sampled paths share the target's stream); layer 0's and layer 15's
     verify output within 2e-2 of 4 sequential decodes (bf16 and int8
     pools). Printed, not gated: the
     share of tokens equal to the plain graph path's, the plain model's
     top-2 logit gap at each request's first divergence, acceptance and
     tok/s (replayed and eager);
 6c. interleave: the same model with interleaved prefill (prefill slices
     run eagerly between the decode ticks' graph replays) on three paths:
     contiguous int8 and binary at the default slice (8 tokens) and paged
     int8 with the prefix cache on the header prompts at prefill_chunk 32.
     Each path's tokens equal the chunked blocking engine's at the same
     chunk, exactly; both runs' launches are held exactly to what their
     slices or chunks (B2 2 x 12, the insert kernel 16, kv_decode 16 x
     ceil(c / 8), B3 0 each), their cached-prefix suffix prefills and
     their replays imply, with each replay's counts held to its graph's
     kernel nodes; the share of tokens equal to the monolithic blocking
     path is printed, not gated. Telemetry on against off on the int8 path:
     the same tokens, launches and replays. TTFT and ITL (p50, p99, the
     worst gap) of the blocking and the interleaved int8 engine on a
     Poisson workload (16 requests, 0.5 a step, prompts of {16, 48, 100,
     128}, 16 new tokens), gated on structure only (prefill_slice spans and
     no prefill_wave interleaved, the reverse blocking, the slice histogram
     = the slices > 0, every request's 16 tokens). The HTTP front door
     (localhost, port 0) over an interleaved int8 engine: three concurrent
     SSE streams equal a direct engine's tokens, an over-long prompt gets
     400, close() leaves no thread of its own. The launcher as a user runs
     it (a subprocess: --kv-cache int8 --interleave --scheduler slo with
     --metrics-out, --trace-out and --torch-profile): exit 0, the metrics
     parse, the trace holds prefill_slice spans, the profile is written;
  6d. families: the attention families at full width through get_model,
     random init from the seed, each model freed before the next loads and
     its peak memory printed. Served through ServeEngine (contiguous pool,
     max_batch 8, max_len 256, the serve phase's 12 requests of 16 new
     tokens), each path with its counts zeroed just before and read just
     after (the first traced, but minicpm3-4b's: device events = counts +
     the warm-up), each replay's counts = its graph's kernel nodes, the
     pool's bytes exact, a second replayed run and an eager run giving the
     same tokens, warm tok/s, the busy share and device ms by family (of
     the traced runs): minicpm3-4b (62 layers,
     MLA; 58 binary FFNs at K 2560 and 6400) and deepseek-v2-236b cut to 5
     layers (dense block 0, float MoE blocks 1, 3 and 4, the binary MoE
     block 2; 160 experts, top-6, its experts plain torch) on the
     compressed cache (73,138,176 and 11,796,480 bytes: layers x 8 x 256 x
     (kv_lora + rope) x 2), B2 2 x 58 x (waves + steps) for minicpm3 and 0
     for deepseek, B3 one a layer a wave, the codec kernels 0, and layer 0's
     MLA prefill through B3 within 3e-2 of the plain attention; qwen3-8b
     (36 layers, qk-norm, GQA 32 / 8 of 128, 32 binary FFNs) on the bf16,
     int8 and binary pools (301,989,888 / 153,354,240 / 21,233,664 bytes)
     and on int8 with spec_k = 3 (a wave: B2 64 (k + 1), B1 3 x 4 x k, the
     insert kernel 36 (k + 1), kv_decode 36 (k + 2): the verify's 16 query
     rows a kv head take two launches of MAX_ROWS 8); qwen2-72b cut to 5
     layers (QKV bias, GQA 64 / 8, block 2 binary at d_ff 29568) on int8
     (21,299,200 bytes); deepseek-v3-671b cut to 4 layers (three dense
     blocks, a float MoE of 256 experts with the sigmoid router, MLA, the
     MTP head held but not served) on its compressed cache (9,437,184
     bytes). Launches exactly as 6 and 6b give them for each model. Then
     whisper-base (6 + 6 layers, layer norm, 1500 frames) and
     llama-3.2-vision-11b (40 self + 8 gated cross blocks, 1601 patches,
     the int8 pool, its gates opened from their zero init) through
     get_model's prefill and decode, as repro has no slot engine for them:
     batch 8 (prompts of 32 / 128 tokens), a prefill and 16 greedy decode
     steps, counted exactly (whisper B3 6 + 6 + 6 a prefill and 6 a step,
     B2 8 each; the VLM B3 40 + 8 a prefill and 8 a step, B2 72, the insert
     kernel 40 each, kv_decode 40 a step), a second run's tokens, a traced
     run whose kernel events per family are the counts or one fewer (a
     dropped record); prefill(S - 1) then decode(1) against prefill(S)
     (tests/test_decode_parity.py's bar), gated where no binary FFN's sign
     can turn path noise into O(1): f32 compute on the bf16 pool with
     float FFNs, and whisper's served weights with their binary FFNs in
     f32; printed beside them: the serving config, the VLM's binary FFNs
     in f32 and its float FFNs in f32 on the int8 pool; ms a decode step,
     tok/s, the busy share;
  6e. recurrent: zamba2-2.7b cut to 27 Mamba2 blocks (23 binary: in_zx
     and out through B2; the shared attention + MLP block, 32 heads of 80,
     invoked 4 times) and rwkv6-3b cut to 16 Finch blocks (12 binary: c_k
     and c_v through B2; 40 WKV heads of 64) at full width (half their
     depth, for the script's time limit), random
     init from the seed, bf16, each freed before the next loads, served
     through BucketEngine (max_batch 8, max_len 256; repro gives them no
     slot engine) on the serve phase's 12 requests of 16 new tokens:
     zamba2 on a bf16 and an int8 pool, rwkv6 on its state. Each path's
     first run is counted: launches exactly B2 2 x binary blocks x
     (prefills + steps), B3 4 x prefills (zamba2), on int8 the insert
     kernel 4 x (prefills + steps) and kv_decode 4 x steps, 0 of the
     rest; every cache the engine gets holds exactly the reckoned bytes
     per row, and init_cache(8, 256) exactly the reckoned bytes (zamba2's state
     593,436,672, its pool 188,743,680 bf16 / 96,731,136 int8; rwkv6's
     state 173,015,040); a second run gives the same tokens and the warm
     tok/s, prefill ms and ms a decode step. The longest prompts' group is
     served again alone, untraced and traced (CUDA activity only), its
     launches exact and the trace's kernel events the counts or one fewer.
     Printed: its busy share and device ms by family, the device ms of the
     SSD, the conv, one Mamba2 block's decode and the WKV loop (each timed
     alone at the served shapes), peak memory.
     Then prefill(S - 1) + decode(1) against prefill(S) in f32 (S 200 for
     zamba2: two SSD chunks with a ragged tail; S 64 for rwkv6), gated
     with float denses at 2e-3 of the logits' scale (rwkv6 at bf16's
     2^-7: its time-mix projections round to bf16 whatever the config
     says, as repro's), printed with the served binary ones; and each
     smoke config's loss and grads (f32, 8 x 40) on the card against the
     CPU: zamba2 (binary blocks kept) within 1e-5 and 1e-4 of each leaf's
     max-abs; rwkv6 with float denses within 5e-3 and 2^-3 (the grads'
     own spread under 1e-7 of param noise on the CPU reaches 0.065), its
     binary config printed beside;
  6f. mesh: tensor-parallel serving on a `model` mesh of two gloo ranks
     (launch/mesh.spawn), both on this card (NCCL needs a card per rank).
     First, on this process, the insert kernel at a rank's 16 of the 32
     kv heads bit for bit and kv_decode at 16 heads within 2e-2 against
     their plain versions (B2 at the shard's (3456, 2560) and (2560,
     3456) and B3 at 16 heads are rows of phases 3 and 4, kv_decode's of
     5b), and the smoke LM with float FFNs trained 200 f32 AdamW steps by
     the port's train step on the synthetic stream, served by the single
     device (eagerly) on bf16 / int8 x contiguous / paged. Then each
     rank: the smoke LM's four cells, whose tokens must equal the single
     device's, each rank holding half the pool's bytes; stablelm-3b at
     full width and depth (seed 0): binary FFN block 2 split over the
     ranks bit for bit equal to the block whole (decode M 8, prefill M
     1024, bf16: bin_out's int32 dot is summed before its cast); the
     serve phase's bf16, int8 and paged int8 + prefix cache paths (the
     header prompts, staged), each counted from 0: per rank exactly the
     single device's per-layer launches (B2 2 x 28 a wave and step, B3 32
     a wave without a cached prefix, the insert 32 a wave and step,
     kv_decode 32 a step), kv_bytes_per_device x 2 == kv_bytes == the
     pool's exact bytes, prefix hits, no CUDA graph, the same tokens on
     both ranks; the served model's prefill logits split and whole
     printed, not gated (random weights: row-parallel float sums round
     apart, and a binary FFN's signs amplify it); a decode step's ms (int8,
     median of the ticks without a prefill), one gloo all_reduce's ms and
     peak memory;
     then at 4 layers with float FFNs in f32 the mesh prefill's logits
     within 2e-3 of scale of the single device's (the cut: depth only).
     Last, launch.serve --mesh 1 on the card (NCCL, world 1) must give
     the single-device launcher's tokens (the smoke config). A rank's
     failure fails the phase; nothing falls back to one device;
  6g. mesh_families: in 6f's two ranks (no second start-up), the MLA and
     MoE families on the `model` mesh: minicpm3-4b at full width and depth
     (20 of 40 MLA heads a rank, its binary FFNs' d_ff 3200 a rank) and
     deepseek-v2-236b cut to 5 layers as the families phase serves it
     (64 of 128 heads, 80 of 160 experts a rank; block 2 its binary MoE
     block). Each rank builds the whole tree on the card in its turn (a
     barrier between: two whole deepseek trees at once would pass 80 GB)
     and keeps its shard; the reckoned peak (fake tensors) is printed
     beside max_memory_allocated. First both smoke configs (f32, deepseek
     at capacity_factor 16) on the mesh, as 6f's smoke LM cells: the single
     device's tokens, the whole pool on each rank. Then, per model: block
     2 split over the ranks bit for bit equal to the block whole on decode
     M 8 and prefill M 1024 bf16 inputs (minicpm3's binary FFN; deepseek's routed MoE
     output, the ranks' pair rows summed exactly); one decode step's
     all_reduces exactly 126 / 16 by the port's own counter
     (distributed/collectives.py); the families phase's 12 requests
     through ServeEngine(mesh=, max_batch 8, max_len 256), eager, counted
     from 0: the single device's launches a rank (minicpm3 B2 2 x 58 a
     wave and step at the shard's (N, K), B3 62 a wave at 20 heads;
     deepseek B3 5 a wave at 64 heads, B2 0), the engine's all_reduces
     exactly 126 / 16 x (waves + steps), kv_bytes_per_device == kv_bytes
     == 73,138,176 / 11,796,480 (MLA's compressed cache is whole on every
     rank), no CUDA graph, the same tokens on both ranks; last, the
     prefill logits in f32 with float FFNs and experts at full width, cut
     to 4 / 2 layers, within 2e-3 of scale of the whole model's. B2 at
     (3200, 2560) / (2560, 3200) and B3 at 20 heads (96 / 64) and 64
     heads (192 / 128) are rows of phases 3 and 4;
  6h. mesh_families_2: in the same ranks, the recurrent families,
     whisper and the VLM on the `model` mesh at full width: zamba2-2.7b
     cut to 12 Mamba2 blocks (40 of 80 heads a rank, two shared-block
     calls at 16 of 32 heads; int8 pool), rwkv6-3b cut to 8 blocks (20 of
     40 heads), whisper-base whole, llama-3.2-vision-11b cut to 10 layers
     (16 / 4 of 32 / 8 heads, two cross blocks; int8 pool), each built in
     turns. Per model: its binary layer (Mamba2 out, RWKV6 c_v, whisper's
     and the VLM's binary FFN) split bit for bit equal to whole on decode
     M 8 and prefill M 1024 inputs; a rank's cache bytes at 8 x 256 and
     kv_pool_bytes_per_device exactly MESH2_CACHE_BYTES; one decode step's
     all_reduces exactly MESH2_STEP_ALL_REDUCES; zamba2 and rwkv6 serve 8
     requests through BucketEngine(mesh=), whisper and the VLM a prefill
     and 8 greedy decodes under scoped_api, counted from 0: one device's
     launches a rank, the all_reduces exactly the prediction x (prefills
     + steps), the cache bytes a row exactly, the same tokens on both
     ranks; last the f32 prefill logits with float denses cut to 6 / 1 /
     6 + 6 / 5 layers within 2e-3 of scale of the whole model's. B2, B3,
     the insert kernel and kv_decode at the shard shapes are rows of
     phases 3, 4, 5b and 6f;
  7. xnor: the XNOR-popcount GEMM against its plain version, exactly, at
     the MNIST net's hidden layers (M = 1, 128, 256, 512; N = K = 1024),
     ragged K (40, 100, 384) and the spec draft's shapes (gate / up 8 x
     6912 x 2560, down 8 x 2560 x 6912); the
     yardstick is the same cuBLAS call as int8's, on unpacked signs; then
     the kernel at every K split it takes, each exact and repeatable,
     timed beside the split its host plan picks;
  8. hybrid_dense: the fused binary layer bit for bit against its plain
     version, twice, at the MNIST hidden layers (M = 256 first, then 1,
     128, 512; N = K = 1024), ragged M 77, ragged K 100 (N 64), K 384 (Kp
     12), a long K (8, 1024, 2560) that the plan splits, and scales and
     shifts that make y exactly +0.0 and -0.0; times beside the plain
     version, the bound, a flushed one-element fill_ and, as context, the
     unfused sequence it stands for (B1's kernel, then the f32 affine, the
     sign and pack_bits in torch: unfused_ms, its words equal to the
     kernel's); no single PyTorch call computes it, so no yardstick; then
     the kernel at every K split it takes, each exact and repeatable,
     timed beside the split its host plan picks;
  9. bf16_matmul: the bf16 GEMM within 2e-2 (tests/test_kernels.py), with
     hardtanh off and on, at (256, 1024, 512) and the MNIST float layers at
     batch 256 (fc0's K = 784, fc3's N = 10, fc1 / fc2's 1024 -> 1024);
     the yardstick is torch.mm; then each tile design (LARGE on wgmma,
     SMALL on mma.sync) at every K split, each within 2e-2 and the same bits
     on a second call, timed beside the plan's pick;
 10. mnist: the paper's net, the port's quickstart path: the hybrid net
     trains 2 epochs on SyntheticMnist, packs and runs packed inference,
     with the launch counts zeroed just before and read just after (B1
     exactly twice per forward); the float net trains too (no B1); both
     beat 0.6 test accuracy; packed logits through B1, through B2 and with
     latents are bitwise equal; packed inferences per second at batch 1
     and 256 (the paper's Table I protocol), warm, without an L2 flush;
 11. train: stablelm-3b at full width (bf16, remat "block", 28 binary
     FFNs) through the training launcher (``repro_torch.launch.train``, 6
     steps of batch 8 x 128 tokens from the synthetic stream), with the
     counts zeroed just before and read just after: exactly 112 B2 and 64
     B3 a step (the forward and remat's recompute; the backward runs the
     STE's f32 products and B3's plain recompute), none of the rest; every
     loss and grad norm finite, the grad norm > 0. Then the launcher's
     first step again: every block's wq / wk / wv / wo gets a finite,
     nonzero gradient; one step under the profiler (its counts exact,
     the device events the counts or one fewer, a dropped record; device
     ms by kernel family, busy share of the unprofiled step); every latent in [-1, 1] after it; the step time (median of
     steps 2-6) and the peak memory. B3's backward at the training shape
     within 3e-2 of autograd through its plain version. The smoke config
     60 steps (lr 3e-3, checkpoints every 30) with a falling loss
     (tests/test_system.py's bar), a resume for 3 steps (step 63, the data
     stream's position restored), the serve launcher with --ckpt-dir
     giving the tokens of an engine on the restored params; then
     examples/binary_llm (float and hybrid, 120 steps), both losses
     falling; every run's launches exact;
 11b. train_mesh: sharded training on two gloo ranks sharing this card.
     (a) stablelm-3b at full width and depth through the launcher's rank
     function (launch.train --mesh 1x2:data,model --backend gloo, 4 steps
     of 8 x 128, remat "block"): a rank holds 16 of 32 heads, d_ff 3456
     and half the vocab; per rank the step ms, the all_reduces a step
     (counted and timed by a wrapper around torch.distributed.all_reduce,
     a device sync on either side), the peak memory and B2 / B3 launches a
     step, exactly 112 / 64 at the shard's (N, K); step 0's loss within
     1e-2 and its grad norm within 5e-2 of the train phase's first ones
     (the same params and batch; the norm catches a gradient summed twice,
     which AdamW's steps would not show), the loss lower at step 4 than at
     step 1, both ranks' losses equal.
     (b) data parallel at full width cut to 8 layers (blocks 2..5 binary):
     --mesh 2x1 through make_train_step(plan=), 4 steps, each rank 4 of the
     8 rows: the gradient all_reduce's bytes and ms a step; step 0's loss
     within 1e-2 and its grad norm within 5e-2 of one device's at the cut
     on the same global batch.
     (c) on (b)'s gradients one full-precision sync (f32 buckets) and one
     1-bit sync (int8 signs and f32 scales, train/manual_dp.py) timed, with
     the bytes each hands to its all_reduces; then examples/onebit_dp on the
     card (4 gloo ranks, 40 steps): both loss curves fall (the mean of the
     last 5 below the first 5's). B2 at (b)'s M 512 is a row of phase 3;
     B3 at (a)'s 16 heads is phase 6f's row;
 11c. dryrun: launch/dryrun.py's predictions for the runs above, made
     after them on the CPU on fake tensors (no card, no process group):
     stablelm-3b's decode step on 6f's `model` mesh of 2 (8 x 256, the
     packed serving params), 11b's (a) and (b) and 11's single-device step
     (8 x 128). Gated exactly: the all_reduces a step and their payload
     bytes against those the ranks issued (counted by the wrapper around
     torch.distributed.all_reduce, independent of the recorder: one decode
     step a rank in 6f and every decode step of its bf16 engine, every
     step of (a) and (b)),
     and the params, pool and moment bytes a rank against the bytes of the
     rank's real trees (the bf16 mesh engine's params and pool; the trees
     the launcher's first step is given; (b)'s). Printed, not gated: the
     predicted peak of live bytes beside torch.cuda.max_memory_allocated,
     and the analytic t_compute / t_memory / t_collective as shares of
     the measured median step time (t_compute / step: the share of the
     bf16 / int8 peaks the step reaches);
 12. a JSON line of the nine kernels and the two kv_decode wrappers:
     launches summed over the paths (B2, B3, B4a-d and kv_decode on the
     serving, families and recurrent paths, B2 and B3 on the training
     paths, B1 on the spec and the MNIST paths, B5 and B6 on none; each
     serving and spec path's replayed counts held to its graph's kernel nodes, the bf16 and int8
     paths' and the profiled train step's to the device's kernel events
     of the same run), largest error, times and bounds;

and last, ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
and prints no result. Kernel times are CUDA-event medians of the device's
time for one call, with the 50 MB L2 flushed before each timed call (the
serving path meets its weights cold). Every trace records CUDA activity
only (what is read from it is the device's kernel events, and an eager
run's host ops would cost tens of seconds of the time limit to record
and sort) and ends with a pad of kernels that are not ours (trace_pad),
without which it can lose the records of the traced run's last kernels.
Every phase's lines also go to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import PrecisionPolicy, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import hybrid_mlp as H  # noqa: E402
from repro_torch.core.binarize import pack_bits, pack_signs_int8, packed_len, unpack_bits  # noqa: E402
from repro_torch.data.synthetic import SyntheticMnist  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import COUNTED, build  # noqa: E402
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul, binary_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.hybrid_dense import hybrid_dense, hybrid_dense_plain  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain  # noqa: E402
from repro_torch.kernels.ksplit import splits_for  # noqa: E402
from repro_torch.kernels import kv_decode as kvd  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402
from repro_torch.launch.dryrun import tree_nbytes  # noqa: E402
from repro_torch.models import get_model, lm_common as lc, mamba2, moe, rwkv6  # noqa: E402
from repro_torch.nn import attention as attn_lib  # noqa: E402
from repro_torch.nn.layers import embedding_lookup, rmsnorm_apply  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.serving.bucket import BucketEngine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# name -> wrapper, every counted one; every launch count is zeroed before each path
KERNELS = {w.__name__: w for w in COUNTED}
SOURCES = ["int8_matmul", "flash_attention", "binary_matmul", "hybrid_dense",
           "bf16_matmul", "kv_quant", "kv_decode"]   # src/repro_torch/csrc/<name>.cu

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, int8
# tensor-core ops/s, bf16 tensor-core flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
BF16_TOL = 3e-2          # tests/test_attention.py TOLS[bfloat16]
GEMM_TOL = 2e-2          # tests/test_kernels.py, bf16_matmul
TRAIN_TOL = {"grad": 1e-4, "param": 1e-3}   # tests/test_torch_cuda.py TRAIN_TOL
SEED = 0
OUT_DIR = Path(__file__).resolve().parent / "build"     # listed in .gitignore
RECORD: dict[str, list] = {}
# scaled_dot_product_attention takes Hq != Hkv (enable_gqa) from torch 2.5 on
SDPA_GQA = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)


def log(tag: str, **kw) -> None:
    RECORD.setdefault(tag, []).append(kw)
    print(f"{tag} " + json.dumps(kw), flush=True)


PHASE_SECONDS: dict[str, float] = {}


def timed(label: str, fn, *args):
    """fn(*args), its wall seconds kept under ``label`` (the phase_seconds
    line: where the script's time limit goes)."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[label] = time.perf_counter() - t0
    return out


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call.

    The device is held busy (torch.cuda._sleep) for twice the time the host
    takes to enqueue the call, so the start event, the call's kernels and
    the end event are all queued before the device reaches them: the
    interval is the device's time for the call, not the wrapper's Python
    time, which exceeds a small kernel's own. A sample is kept only if the
    device was still held when the host had queued the end event (the start
    event not yet reached); otherwise the hold doubles and the sample is
    taken again, and a hold that never covers the call raises."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device=device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 10 ** 7 / start.elapsed_time(end)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hold_ms = 2e3 * (time.perf_counter() - t0) + 0.05
        torch.cuda.synchronize()
        times = []
        while len(times) < reps:
            self.flush.zero_()
            torch.cuda._sleep(int(self.cycles_per_ms * hold_ms))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            covered = not start.query()
            end.synchronize()
            if covered:
                times.append(start.elapsed_time(end))
            elif hold_ms < 1e3:
                hold_ms *= 2
            else:
                raise RuntimeError("the device hold never covered the host's enqueue")
        return statistics.median(times)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: int8-binary GEMM
# ---------------------------------------------------------------------------

def int_library(a8, pw, k, want, timer, name) -> tuple[float, str]:
    """The yardstick of the binary GEMMs: one cuBLAS call on +-1 operands
    unpacked beforehand, checked equal to the plain version, and timed."""
    m, n = a8.shape[0], pw.shape[0]
    if m > 16 and n % 8 == 0 and k % 8 == 0:          # torch._int_mm's limits
        lib_call = "torch._int_mm(int8 (M,K), int8 (K,N))"
        w8t = unpack_bits(pw, k, torch.int8).T        # (K, N) column-major
        lib = lambda: torch._int_mm(a8, w8t)          # noqa: E731
    else:
        # f32 without TF32 (torch's default) is exact here: every partial
        # sum of +-1 terms is an integer below 2**24
        lib_call = "torch.mm(f32 (M,K), f32 (K,N)), TF32 off"
        af, wft = a8.float(), unpack_bits(pw, k, torch.float32).T
        lib = lambda: torch.mm(af, wft)               # noqa: E731
    lib_err = int((lib().to(torch.int32) - want).abs().max())
    if lib_err != 0:
        raise AssertionError(f"{lib_call} differs from plain at {name}: {lib_err}")
    return timer(lib), lib_call


INT8_CASES = [  # (name, M, N, K)
    ("decode bin_in", 8, 6912, 2560),
    ("decode bin_out", 8, 2560, 6912),
    ("prefill bin_in", 1024, 6912, 2560),
    ("prefill bin_out", 1024, 2560, 6912),
    ("prefill bin_out max bucket", 2048, 2560, 6912),
    ("ragged", 5, 40, 96),
    ("decode M 1 bin_in", 1, 6912, 2560),
    ("decode M 1 bin_out", 1, 2560, 6912),
    ("decode M 16 bin_in", 16, 6912, 2560),
    ("decode M 16 bin_out", 16, 2560, 6912),
    ("spec verify bin_in M 32", 32, 6912, 2560),
    ("spec verify bin_out M 32", 32, 2560, 6912),
    # an interleaved prefill slice: 8 rows x chunk 8, 4 rows x chunk 32
    ("slice bin_in M 64", 64, 6912, 2560),
    ("slice bin_out M 64", 64, 2560, 6912),
    ("slice bin_in M 128", 128, 6912, 2560),
    ("slice bin_out M 128", 128, 2560, 6912),
    # minicpm3-4b's binary FFNs (d_ff 6400)
    ("minicpm3 decode bin_in", 8, 6400, 2560),
    ("minicpm3 decode bin_out", 8, 2560, 6400),
    ("minicpm3 prefill bin_in", 1024, 6400, 2560),
    ("minicpm3 prefill bin_out", 1024, 2560, 6400),
    # the families phase's: qwen3-8b (d_ff 12288), llama-3.2-vision-11b
    # (14336), qwen2-72b (29568 = 32 x 924, not a multiple of 256), each
    # bin_out at decode M 8 and prefill M 8 x 128
    ("qwen3 decode bin_in", 8, 12288, 4096),
    ("qwen3 decode bin_out", 8, 4096, 12288),
    ("qwen3 prefill bin_out", 1024, 4096, 12288),
    ("vlm decode bin_out", 8, 4096, 14336),
    ("vlm prefill bin_out", 1024, 4096, 14336),
    ("qwen2 decode bin_out", 8, 8192, 29568),
    ("qwen2 prefill bin_out", 1024, 8192, 29568),
    # the recurrent phase's: zamba2-2.7b's in_zx (10240, 2560) and out
    # (2560, 5120), rwkv6-3b's c_k (8960, 2560) and c_v (2560, 8960: K = 32
    # x 280, which the TPU kernel's bk rule refuses), at decode M 8 and
    # prefill M 8 x 128
    ("zamba2 decode in_zx", 8, 10240, 2560),
    ("zamba2 decode out", 8, 2560, 5120),
    ("rwkv6 decode c_k", 8, 8960, 2560),
    ("rwkv6 decode c_v", 8, 2560, 8960),
    ("zamba2 prefill in_zx", 1024, 10240, 2560),
    ("zamba2 prefill out", 1024, 2560, 5120),
    ("rwkv6 prefill c_k", 1024, 8960, 2560),
    ("rwkv6 prefill c_v", 1024, 2560, 8960),
    # a rank's shard of stablelm-3b's binary FFN on a mesh of 2 (phase 6f):
    # bin_in's columns and bin_out's K = 6912 / 2 = 3456 = 32 x 108
    ("mesh 2 decode bin_in", 8, 3456, 2560),
    ("mesh 2 decode bin_out", 8, 2560, 3456),
    ("mesh 2 prefill bin_in", 1024, 3456, 2560),
    ("mesh 2 prefill bin_out", 1024, 2560, 3456),
    # a data-parallel rank's prefill in the train_mesh phase: 4 of 8 rows
    # x 128 tokens of stablelm-3b's full-width FFN
    ("train mesh 2x1 bin_in M 512", 512, 6912, 2560),
    ("train mesh 2x1 bin_out M 512", 512, 2560, 6912),
    # a rank's shard of minicpm3-4b's binary FFN on a mesh of 2 (phase 6g):
    # bin_in's columns and bin_out's K = 6400 / 2 = 3200 = 32 x 100
    ("mesh 2 minicpm3 decode bin_in", 8, 3200, 2560),
    ("mesh 2 minicpm3 decode bin_out", 8, 2560, 3200),
    ("mesh 2 minicpm3 prefill bin_in", 1024, 3200, 2560),
    ("mesh 2 minicpm3 prefill bin_out", 1024, 2560, 3200),
    # a rank's shards on a mesh of 2 (phase 6h): zamba2's binary in_zx (its
    # heads' z and x, 2 x 2560) and out (K 2560), rwkv6's c_k and c_v (K
    # 4480 = 32 x 140), whisper's bin_in / bin_out (K 1024), the VLM's (K
    # 7168); prefill at M 8 x 128 (whisper's 8 x 32)
    ("mesh 2 zamba2 decode in_zx", 8, 5120, 2560),
    ("mesh 2 zamba2 decode out", 8, 2560, 2560),
    ("mesh 2 rwkv6 decode c_k", 8, 4480, 2560),
    ("mesh 2 rwkv6 decode c_v", 8, 2560, 4480),
    ("mesh 2 whisper decode bin_in", 8, 1024, 512),
    ("mesh 2 whisper decode bin_out", 8, 512, 1024),
    ("mesh 2 vlm decode bin_in", 8, 7168, 4096),
    ("mesh 2 vlm decode bin_out", 8, 4096, 7168),
    ("mesh 2 zamba2 prefill in_zx", 1024, 5120, 2560),
    ("mesh 2 zamba2 prefill out", 1024, 2560, 2560),
    ("mesh 2 rwkv6 prefill c_k", 1024, 4480, 2560),
    ("mesh 2 rwkv6 prefill c_v", 1024, 2560, 4480),
    ("mesh 2 whisper prefill bin_in", 256, 1024, 512),
    ("mesh 2 whisper prefill bin_out", 256, 512, 1024),
    ("mesh 2 vlm prefill bin_in", 1024, 7168, 4096),
    ("mesh 2 vlm prefill bin_out", 1024, 4096, 7168),
]
# activations drawn from all of [-128, 127]: the kernel is exact for any
# int8, and so are the plain f32 version and the yardsticks (|sum| < 2**24)
INT8_RANGE_CASES = [("decode bin_out, int8 range", 8, 2560, 6912),
                    ("prefill bin_in, int8 range", 1024, 6912, 2560)]


def phase_int8(dev, gen, timer) -> list[dict]:
    rows = []
    cases = [(c, False) for c in INT8_CASES] + [(c, True) for c in INT8_RANGE_CASES]
    for (name, m, n, k), full_range in cases:
        if full_range:
            a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        else:
            a = pack_signs_int8(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        got, want = int8_matmul(a, pw), int8_matmul_plain(a, pw)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"int8 kernel differs from plain at {name}: {err}")
        ms = timer(lambda: int8_matmul(a, pw))
        plain_ms = timer(lambda: int8_matmul_plain(a, pw), reps=10)
        lib_ms, lib_call = int_library(a, pw, k, want, timer, name)
        b_ms, b_by = bound(m * k + n * k / 8 + 4 * m * n, 2.0 * m * n * k, INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_call=lib_call)
        log("int8", **row)
        rows.append(row)
    return rows


# the serving path's prefill and decode shapes, and the small prefill waves
SPLIT_CASES = INT8_CASES[:5] + [("prefill bin_in M 128", 128, 6912, 2560),
                                ("prefill bin_out M 256", 256, 2560, 6912)]


def _sweep(tag, name, dims, options, planned, same, timer, **extra) -> dict:
    """One kernel (B1, B2 or B6) at every launch its launcher takes:
    ``options`` maps a label (design / K chunks) to a call, each held by
    ``same`` to the plain result and required to give the same bits twice,
    and timed beside ``planned``, the label of the launch its host plan
    picks (the plan's model, measured)."""
    times = {}
    for label, call in options.items():
        got = call()
        same(got, f"{name}, {label}")
        if not torch.equal(got, call()):
            raise AssertionError(f"{tag}: a second call differs at {name}, {label}")
        times[label] = timer(call)
    best = min(times, key=times.get)
    row = dict(case=name, M=dims[0], N=dims[1], K=dims[2], **extra, ms_by_launch=times,
               planned=planned, best=best, planned_over_best=times[planned] / times[best])
    log(tag, **row)
    return row


def phase_int8_splits(dev, gen, timer) -> list[dict]:
    """B2 at each K split its kernel takes, each exact, beside the one
    plan() picks."""
    from repro_torch.kernels import int8_matmul as im
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k in SPLIT_CASES:
        a = pack_signs_int8(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        want = int8_matmul_plain(a, pw)
        design, planned = im.plan(m, n, k, n_sms)
        kp = k // 32
        units = -(-kp // im.STAGE_WORDS)
        options = {f"{s} chunks": (lambda kc=im.STAGE_WORDS * -(-units // s):
                                   im._launch(a, pw, design, kc))
                   for s in splits_for(units)}

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"int8 kernel differs from plain at {label}")
        rows.append(_sweep("int8_split", name, (m, n, k), options, f"{-(-kp // planned)} chunks",
                           same, timer,
                           design="decode" if design == im.DECODE else "prefill"))
    return rows


# ---------------------------------------------------------------------------
# phase 4: flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (name, B, S, T, Hq, Hkv, D, q_offset, kv_len or None)
    ("full length", 8, 128, 128, 32, 32, 80, 0, None),
    ("ragged kv_len", 8, 128, 128, 32, 32, 80, 0, [128, 100, 1, 64, 17, 128, 90, 3]),
    ("S = 152", 8, 152, 152, 32, 32, 80, 0, [152, 77, 1, 152, 130, 9, 64, 151]),
    ("q_offset 128", 8, 64, 192, 32, 32, 80, 128, [192, 150, 129, 192, 170, 180, 140, 160]),
    ("GQA 8/2, D 64", 2, 96, 96, 8, 2, 64, 0, [96, 50]),
    ("D 128", 2, 96, 96, 8, 8, 128, 0, [96, 1]),
    ("S = T = 256, largest bucket", 8, 256, 256, 32, 32, 80, 0, None),
    # a rank's 16 of the 32 heads on a mesh of 2 (phase 6f; zamba2's shared
    # block in 6h)
    ("mesh 2 shard, 16 heads", 8, 128, 128, 16, 16, 80, 0, None),
    ("mesh 2 shard, 16 heads, ragged kv_len", 8, 128, 128, 16, 16, 80, 0,
     [128, 100, 1, 64, 17, 128, 90, 3]),
    # the VLM's self prefill on a mesh of 2 (phase 6h): 16 / 4 heads of 128
    ("mesh 2 vlm self, 16 / 4 heads of 128", 8, 128, 128, 16, 4, 128, 0, None),
]


def _visible_pairs(s, kvl, q_offset, causal=True) -> int:
    """(query, key) pairs the causal mask and kv_len leave visible."""
    if not causal:
        return s * sum(kvl)
    return sum(min(n, i + q_offset + 1) for n in kvl for i in range(s))


def _sdpa_mask(b, s, t, kvl, q_offset, dev):
    cols = torch.arange(t, device=dev)
    rows = torch.arange(s, device=dev) + q_offset
    causal = rows[:, None] >= cols[None, :]
    lens = torch.as_tensor(kvl, device=dev)
    return (causal[None] & (cols[None, None, :] < lens[:, None, None]))[:, None]


# MLA's prefill: q and k [nope | rope] of width D, v of width Dv, G 1
MLA_FLASH_CASES = [  # (name, B, S, Hq, D, Dv, kv_len or None, dtype)
    ("minicpm3 96/64", 8, 128, 40, 96, 64, None, torch.bfloat16),
    ("minicpm3 96/64, ragged kv_len", 8, 128, 40, 96, 64, [128, 100, 1, 64, 17, 128, 90, 3],
     torch.bfloat16),
    ("deepseek-v2 192/128", 8, 128, 128, 192, 128, None, torch.bfloat16),
    # a rank's heads on a mesh of 2 (phase 6g): minicpm3's 20 of 40,
    # deepseek-v2's 64 of 128
    ("mesh 2 minicpm3 96/64, 20 heads", 8, 128, 20, 96, 64, None, torch.bfloat16),
    ("mesh 2 deepseek-v2 192/128, 64 heads", 8, 128, 64, 192, 128, None, torch.bfloat16),
    ("smoke 24/16 bf16", 2, 32, 4, 24, 16, None, torch.bfloat16),
    ("smoke 24/16 f32", 2, 32, 4, 24, 16, None, torch.float32),
]
# non-causal, S != T, T off the 64-key tile: whisper-base's encoder and
# cross-attention over 1500 frames (8 heads of 64), llama-3.2-vision-11b's
# cross-attention over 1601 patches (32 / 8 heads of 128), at the families
# phase's batch of 8: prefill S 32 / 128 and decode S 1
CROSS_FLASH_CASES = [  # (name, B, S, T, Hq, Hkv, D)
    ("whisper encoder", 8, 1500, 1500, 8, 8, 64),
    ("whisper cross prefill", 8, 32, 1500, 8, 8, 64),
    ("whisper cross decode", 8, 1, 1500, 8, 8, 64),
    ("vlm cross prefill", 8, 128, 1601, 32, 8, 128),
    ("vlm cross decode", 8, 1, 1601, 32, 8, 128),
    # a rank's heads on a mesh of 2 (phase 6h): whisper's 4 of 8, the
    # VLM's 16 / 4 of 32 / 8
    ("mesh 2 whisper encoder, 4 heads", 8, 1500, 1500, 4, 4, 64),
    ("mesh 2 whisper cross prefill, 4 heads", 8, 32, 1500, 4, 4, 64),
    ("mesh 2 whisper cross decode, 4 heads", 8, 1, 1500, 4, 4, 64),
    ("mesh 2 vlm cross prefill, 16 / 4 heads", 8, 128, 1601, 16, 4, 128),
    ("mesh 2 vlm cross decode, 16 / 4 heads", 8, 1, 1601, 16, 4, 128),
]
TOLS = {torch.bfloat16: BF16_TOL, torch.float32: 2e-5}   # tests/test_attention.py TOLS
# bf16 is also held to each batch row's own scale: over T 1500 an output's
# std is ~0.04, so 3e-2 alone is the size of a typical value. 2^-6 of a
# row's largest |output| is 2 to 4 bf16 ulps of it; the kernel reads 1.
BF16_REL = 2.0 ** -6
# with v constant along the keys every output is that constant (the
# weights sum to 1): within 1 bf16 ulp, or f32's bar. A key of the last
# tile's zero-filled tail left unmasked pulls it towards 0 by its share of
# the weights (~1.4% at T 1500, ~2.3% at T 1601)
CONST_V_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2e-5}


def flash_err(got, want, dt) -> tuple[float, float]:
    """-> (max |got - want|, the worst batch row's error over its bar); the
    bar is TOLS[dt], in bf16 no more than BF16_REL x the row's max |want|;
    the kernel passes at <= 1."""
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    bar = torch.full_like(err, TOLS[dt])
    if dt == torch.bfloat16:
        bar = torch.minimum(bar, BF16_REL * want.float().abs().flatten(1).amax(1))
    return float(err.max()), float((err / bar).max())


def flash_const_v(q, k, v, **kw) -> float:
    """The kernel on v made constant along the keys (each (batch, head,
    channel) keeps its first key's value) -> the largest relative error
    against that constant; the kernel passes at <= CONST_V_REL."""
    vc = v[:, :1].expand_as(v).contiguous()
    got = flash_attention(q, k, vc, **kw).float()
    want = vc[:, :1].float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    return float(((got - want) / want).abs().max())
# the lists as (name, B, S, T, Hq, Hkv, D, Dv, q_offset, kv_len, dtype, causal)
ALL_FLASH_CASES = ([(name, b, s, t, hq, hkv, d, d, off, kvl, torch.bfloat16, True)
                    for name, b, s, t, hq, hkv, d, off, kvl in FLASH_CASES]
                   + [(name, b, s, s, hq, hq, d, dv, 0, kvl, dt, True)
                      for name, b, s, hq, d, dv, kvl, dt in MLA_FLASH_CASES]
                   + [(name, b, s, t, hq, hkv, d, d, 0, None, torch.bfloat16, False)
                      for name, b, s, t, hq, hkv, d in CROSS_FLASH_CASES])


def _sdpa_dv(qt, kt, vt, timer, **kw) -> tuple[float | None, str]:
    """SDPA at Dv != D through the first backend that takes it -> (ms, the
    call named with its backend), or (None, why) when none does."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(qt, kt, vt, **kw)
        try:
            with warnings.catch_warnings():      # each refusal warns why
                warnings.simplefilter("ignore", UserWarning)
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        args = "is_causal=True" if "is_causal" in kw else "attn_mask=bool"
        return timer(call), f"scaled_dot_product_attention({args}), {be.name} backend"
    return None, "no SDPA backend takes Dv != D here"


def phase_flash(dev, gen, timer) -> list[dict]:
    rows = []
    for name, b, s, t, hq, hkv, d, dv, off, kvl, dt, causal in ALL_FLASH_CASES:
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, t, hkv, dv, generator=gen, device=dev).to(dt)
        lens = [t] * b if kvl is None else kvl
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, kv_len=kv, q_offset=off)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, over = flash_err(got, want, dt)
        if got.shape != (b, s, hq, dv) or not over <= 1.0:
            raise AssertionError(f"flash kernel vs plain at {name}: {tuple(got.shape)}, "
                                 f"{err}: {over} x its bar")
        const_err = flash_const_v(q, k, v, **kw)
        if not const_err <= CONST_V_REL[dt]:
            raise AssertionError(f"flash kernel at {name}, v constant along the keys: "
                                 f"{const_err} > {CONST_V_REL[dt]} of the constant")
        ms = timer(lambda: flash_attention(q, k, v, **kw))
        plain_ms = timer(lambda: flash_attention_plain(q, k, v, **kw), reps=10)
        # the yardstick: one SDPA call on the same inputs (heads-major views)
        lib_ms, lib_call = None, None
        gqa = {} if hq == hkv else {"enable_gqa": True}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if not causal:                       # the cross cases: no mask at all
            sdpa_kw = {}
        elif kvl is None and off == 0 and s == t:
            sdpa_kw = {"is_causal": True}
        else:
            sdpa_kw = {"attn_mask": _sdpa_mask(b, s, t, lens, off, dev)}
        if dv != d:
            lib_ms, lib_call = _sdpa_dv(qt, kt, vt, timer, **sdpa_kw)
        elif not gqa or SDPA_GQA:
            lib_call = ("scaled_dot_product_attention()" if not sdpa_kw else
                        "scaled_dot_product_attention(is_causal=True)" if "is_causal" in sdpa_kw
                        else "scaled_dot_product_attention(attn_mask=bool)")
            lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw,
                                                                  **gqa))
            if gqa:
                lib_call = lib_call[:-1] + (", " if sdpa_kw else "") + "enable_gqa=True)"
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + b * s * hq * dv)
        flops = 2.0 * hq * (d + dv) * _visible_pairs(s, lens, off, causal)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        row = dict(case=name, B=b, S=s, T=t, Hq=hq, Hkv=hkv, D=d, Dv=dv, causal=causal,
                   q_offset=off,
                   dtype=str(dt).replace("torch.", ""), max_abs_err=err, err_over_bar=over,
                   const_v_rel_err=const_err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_call=lib_call)
        log("flash", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 6: serve stablelm-3b at full width
# ---------------------------------------------------------------------------

N_REQUESTS, PROMPT_LENS, MAX_NEW = 12, (16, 48, 100, 128), 16
HEADER = 64           # tokens of the header the paged run's prompts share
# exact pool bytes of stablelm-3b at max_batch 8, max_len 256 (32 layers x
# 32 KV heads of 80: 327,680 / 167,936 / 28,672 bytes per token), served
# whole on the mesh (6f)
KV_BYTES = {"bf16": 671_088_640, "int8": 343_932_928, "binary": 58_720_256}
# the single-device serve path (6, 6b, 6c) at full width, cut to half its
# depth to keep the script's phases within 1,000 s: 16 layers,
# blocks 2..13 binary, half of KV_BYTES
SERVE_LAYERS = 16
SERVE_KV_BYTES = {"bf16": 335_544_320, "int8": 171_966_464, "binary": 29_360_128}
# the further serving paths: (label, ServeEngine options, header prompts).
# On the header prompts the first request runs alone, so the rest find its
# header on the radix tree; the contiguous int8 run on them is the paged
# run's like-for-like yardstick
KV_PATHS = [("int8", dict(kv_cache="int8"), False),
            ("binary", dict(kv_cache="binary"), False),
            ("int8, header prompts", dict(kv_cache="int8"), True),
            ("paged int8 + prefix cache", dict(kv_cache="int8", kv_block_size=16,
                                               prefix_cache=True), True)]


def _serve_once(api, params, prompts, staged=False, setup=None, **kw):
    """Serve ``prompts`` through a fresh engine; ``staged``, the first
    request runs to its end before the others arrive; ``setup`` is called
    with the engine before any request."""
    eng = ServeEngine(api, params, max_batch=8, max_len=256, **kw)
    if setup is not None:
        setup(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new=MAX_NEW) for p in prompts[:1]]
    if staged:
        eng.run()
    rids += [eng.add_request(p, max_new=MAX_NEW) for p in prompts[1:]]
    res = eng.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids], time.perf_counter() - t0, eng


OUR_KERNELS = {  # every __global__ function of src/repro_torch/csrc -> family
    "int8_matmul_mma_kernel": "int8_matmul (ours)",
    "int8_matmul_wgmma_kernel": "int8_matmul (ours)",
    "flash_fwd_mma_kernel": "flash_attention (ours)",
    "flash_fwd_simt_kernel": "flash_attention (ours)",
    "kv_encode_kernel": "kv_quant (ours)", "dequant_int8_kernel": "kv_quant (ours)",
    "dequant_binary_kernel": "kv_quant (ours)",
    "kv_decode_kernel": "kv_decode (ours)",
    "binary_matmul_mma_kernel": "binary_matmul (ours)",
    "hybrid_dense_mma_kernel": "hybrid_dense (ours)",
    "bf16_matmul_mma_kernel": "bf16_matmul (ours)",
    "bf16_matmul_wgmma_kernel": "bf16_matmul (ours)",
}


def _kernel_family(name: str) -> str:
    for sym, fam in OUR_KERNELS.items():
        if sym in name:
            return fam
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "float matmuls (cuBLAS)"
    return "other (elementwise, norms, copies, argmax)"


# wrapper -> the family its kernel functions' device events fall in (OUR_KERNELS)
WRAPPER_FAMILY = {name: ("kv_quant (ours)" if name.startswith(("kv_quant", "kv_dequant"))
                         else "kv_decode (ours)" if name.startswith("kv_decode")
                         else f"{name} (ours)") for name in KERNELS}


def _device_launches(prof) -> dict[str, int]:
    """Kernel events per family of ours in a profiled run: the device's own
    count of their launches, every node of every graph replay included."""
    from torch.autograd import DeviceType
    got = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and _kernel_family(evt.key) in got:
            got[_kernel_family(evt.key)] += evt.count
    return got


class _KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2, cuda.h
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x", "block_y",
                                     "block_z", "shared_mem")] + [
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_kernel_nodes(graph) -> dict[str, int]:
    """Kernel nodes per family of ours in a captured CUDA graph, named by
    libcuda (cuGraphGetNodes, cuGraphKernelNodeGetParams,
    cuFuncGetName / cuKernelGetName): the kernels one replay launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    got = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for node in nodes:
        node, kind = ctypes.c_void_p(node), ctypes.c_int()
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)), "cuGraphKernelNodeGetParams")
        # a node libcuda cannot name counts as none of ours (a node of
        # ours left unnamed then shows as a missing node)
        if (p.func and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)) == 0) or \
                (p.kern and cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)) == 0):
            fam = _kernel_family(name.value.decode())
            if fam in got:
                got[fam] += 1
    return got


def _by_family(per_wrapper: dict[str, int]) -> dict[str, int]:
    out = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for name, n in per_wrapper.items():
        out[WRAPPER_FAMILY[name]] += n
    return out


def _counted_run(label, api, params, prompts, staged=False, profiled=False, **kw):
    """A path's counted run: the launch counts zeroed just before it and
    read just after. What a replay adds to them (serving/graphs.py, from
    the wrappers' counts during the capture) must equal, per family of
    ours, the kernel nodes of the graph that replayed. ``profiled``: the
    run is traced (torch.profiler), and per family the device's kernel
    events must equal the counts plus the graph's warm-up (one eager step,
    which the counts leave out as set-up).
    -> (tokens, wall s, engine, counts, profiler or None)"""
    zero_counts()
    if profiled:
        with _trace() as prof:
            out, wall, eng = _serve_once(api, params, prompts, staged=staged, **kw)
    else:
        prof = None
        out, wall, eng = _serve_once(api, params, prompts, staged=staged, **kw)
    launches = counts()
    nodes = _graph_kernel_nodes(eng.graph.graph)
    per_replay = _by_family(dict(zip(KERNELS, eng.graph.per_replay)))
    if nodes != per_replay:
        raise AssertionError(f"{label}: the graph's kernel nodes {nodes}, but a replay adds "
                             f"{per_replay}")
    if prof is None:
        return out, wall, eng, launches, None
    warm = dict(zip(KERNELS, eng.graph.warmup))
    want = _by_family({name: n + warm[name] for name, n in launches.items()})
    got = _device_launches(prof)
    if got != want:
        raise AssertionError(f"{label}: kernel events on the device {got}, want {want}: the "
                             f"wrappers counted {launches}, the warm-up {warm}")
    return out, wall, eng, launches, prof


# a trace stopped right after a run loses the records of the run's last
# kernels: tools/trace_drops.py's traces of zamba2's eager group lost 3 and
# 16 of 1,609 in 2 of 8 trials, each at the end only, and none in 8 trials
# ended by a pad of 4,096 small kernels that are not ours
TRACE_PAD = 4096
PAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's


def trace_pad() -> None:
    """TRACE_PAD launches of torch.cuda._sleep's spin kernel (one cycle
    each), then a device sync: run inside a trace after the traced work, it
    keeps the trace from losing the records of that work's last kernels.
    _profile_summary leaves its kernels out."""
    for _ in range(TRACE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def _trace():
    """A torch.profiler trace of CUDA activity only, ended by trace_pad."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
        trace_pad()


def _profile(api, params, prompts, wall_unprofiled: float, **kw) -> dict:
    """The summary below of one profiled serving run."""
    with _trace() as prof:
        out, wall, _ = _serve_once(api, params, prompts, **kw)
    return {"out": out, **_profile_summary(prof, wall, wall_unprofiled)}


def _profile_summary(prof, wall: float, wall_unprofiled: float) -> dict:
    """Device time by kernel over one profiled serving run (kernel times
    come from the device's own clock), and the device's busy share of the
    same work run without the profiler, whose host-side recording stretches
    the profiled run's wall time."""
    from torch.autograd import DeviceType
    per_kernel = {}     # device-side events only: a CPU op's device time repeats its kernels'
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0 and \
                PAD_KERNEL not in evt.key:
            per_kernel[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    fam: dict[str, float] = {}
    for name, (ms, _) in per_kernel.items():
        fam[_kernel_family(name)] = fam.get(_kernel_family(name), 0.0) + ms
    busy = sum(fam.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profiled_wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall_unprofiled * 1e3),
            "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                            for n, (ms, c) in top]}


def _check_path(label, launches, eng, cfg, n_binary, kv: str, flash_waves: int) -> None:
    """Every kernel's launches on one serving path: B2 2 x binary blocks and
    the codec's insert kernel (K and V in one launch) once per layer per
    prefill wave and per decode step, the dequant-fused decode one per layer
    per decode step, the codec's dequantizer 2 x layers per wave on a cached
    prefix (the context's gather), B3 one per layer per wave without a
    cached prefix, all else 0."""
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    want = {k: 0 for k in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + steps)
    want["flash_attention"] = cfg.n_layers * flash_waves
    if kv != "bf16":
        want[f"kv_quant_{kv}"] = cfg.n_layers * (waves + steps)
        want[f"kv_decode_{kv}"] = cfg.n_layers * steps
        want[f"kv_dequant_{kv}"] = 2 * cfg.n_layers * (waves - flash_waves)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} for {waves} "
                             f"prefill waves + {steps} decode steps")


def _check_kv_bytes(label, eng, cfg, kv: str, want: int) -> None:
    """The pool's exact bytes at max_batch 8, max_len 256: ``want``, the
    engine's figure and layers x 8 x 256 x a token's bytes (the codec's
    rows for each kv head, or MLA's compressed (kv_lora + rope) x 2)."""
    per_tok = cfg.n_layers * ((cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 if cfg.use_mla else
                              kvc.get_codec(kv).bytes_per_token(cfg.n_kv_heads,
                                                                cfg.kv_head_dim()))
    if not eng.stats["kv_bytes"] == want == per_tok * 8 * 256:
        raise AssertionError(f"{label}: kv_bytes {eng.stats['kv_bytes']}, want {want}")


def _check_outputs(label, out, vocab) -> None:
    for o in out:
        if len(o) != MAX_NEW or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"{label}: bad output {o}")


def _fused_decode_layer0(params, cfg, toks, lens) -> dict:
    """Layer 0's K/V from a prefill, encoded by each quantized codec: the
    dequant-fused decode (the kv_decode kernel) against attention over the
    materialized cache (tests/test_kvcache.py's 2e-2)."""
    x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
    h = rmsnorm_apply(params["blocks"][0]["ln1"], x)
    pos = torch.arange(toks.shape[1], device=toks.device)
    q, k, v = lc.gqa_qkv(params["blocks"][0]["attn"], h, cfg, pos)
    errs = {}
    for kv in ("int8", "binary"):
        codec = kvc.get_codec(kv)
        cache = codec.from_prefill(k, v, 64)
        cache["len"] = lens.clone()
        q1 = q[:, -1:].contiguous()
        got = codec.decode_attention(q1, cache)
        km, vm = codec.materialize(cache, head_dim=cfg.kv_head_dim())
        want = attn_lib.decode_attention(q1, km, vm, kv_len=cache["len"])
        errs[kv] = float((got.float() - want.float()).abs().max())
        if not errs[kv] <= 2e-2:
            raise AssertionError(f"layer 0 fused {kv} decode vs materialized: {errs[kv]}")
    return errs


def _eager_equal(label, out, api, params, prompts, staged=False, **kw):
    """The same requests served with every tick (or wave) run eagerly, not
    replayed from its CUDA graph: the tokens must be the replayed ones.
    -> the eager run's wall seconds."""
    e_out, e_wall, e_eng = _serve_once(api, params, prompts, staged=staged, cuda_graphs=False,
                                       **kw)
    if e_out != out:
        raise AssertionError(f"{label}: the graph replays gave other tokens than eager")
    if e_eng.graph is not None:
        raise AssertionError(f"{label}: cuda_graphs=False built a graph")
    return e_wall


def _check_replays(label, eng) -> None:
    """One graph replay per tick or wave, and no eager step on the card."""
    if eng.graph is None or eng.graph.replays != eng.stats["decode_steps"] or \
            eng.graph.eager_calls:
        raise AssertionError(f"{label}: {eng.graph and eng.graph.replays} replays for "
                             f"{eng.stats['decode_steps']} steps")


def _device_time(label, profiles, families) -> None:
    """Each family shows device time in the replayed profile and in the
    eager one."""
    for prof, how in zip(profiles, ("replayed", "eager")):
        for fam in families:
            if not prof["device_ms_by_family"].get(fam, 0.0) > 0.0:
                raise AssertionError(f"{label}: the {how} profile shows no device time for "
                                     f"{fam}: {prof['device_ms_by_family']}")


def phase_serve(dev, card: str) -> dict:
    cfg = get_config("stablelm-3b").replace(n_layers=SERVE_LAYERS)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS)))
               for _ in range(N_REQUESTS)]
    header = rng.integers(0, cfg.vocab, HEADER)
    shared = [np.concatenate([header, p]) for p in prompts]

    # the main path, with the launch counts zeroed just before it and read
    # just after, under the profiler (its kernel events held to the
    # counts); each decode tick is one CUDA graph replay
    out, wall, eng, launches, prof_run = _counted_run("bf16", api, params, prompts,
                                                      profiled=True)
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    _check_outputs("bf16", out, cfg.vocab)
    _check_path("bf16", launches, eng, cfg, n_binary, "bf16", waves)
    _check_kv_bytes("bf16", eng, cfg, "bf16", SERVE_KV_BYTES["bf16"])
    _check_replays("bf16", eng)
    out2, wall2, _ = _serve_once(api, params, prompts)
    if out2 != out:
        raise AssertionError("a second run of the same requests gave other tokens")
    wall_eager = _eager_equal("bf16", out, api, params, prompts)
    prof = _profile_summary(prof_run, wall, wall2)
    prof_eager = _profile(api, params, prompts, wall_eager, cuda_graphs=False)
    if prof_eager.pop("out") != out:
        raise AssertionError("the profiled eager run gave other tokens")
    _device_time("bf16", (prof, prof_eager), ("int8_matmul (ours)", "flash_attention (ours)"))

    # the further paths: each with its counts zeroed just before and read
    # just after, run twice for the same tokens, then eagerly
    paths, plain = [], {"bf16": out}
    for label, kw, on_header in KV_PATHS:
        batch = shared if on_header else prompts
        k_out, k_wall, k_eng, k_launches, k_prof = _counted_run(
            label, api, params, batch, staged=on_header, profiled=label == "int8", **kw)
        _check_outputs(label, k_out, cfg.vocab)
        # with the prefix cache only the first, lone wave prefills without
        # a cached prefix: every later request matches the header
        _check_path(label, k_launches, k_eng, cfg, n_binary, kw["kv_cache"],
                    1 if kw.get("prefix_cache") else k_eng.stats["prefills"])
        _check_kv_bytes(label, k_eng, cfg, kw["kv_cache"], SERVE_KV_BYTES[kw["kv_cache"]])
        _check_replays(label, k_eng)
        if kw.get("prefix_cache") and not (k_eng.pool.stats["hits"] > 0 and
                                           k_eng.stats["cached_prompt_tokens"] > 0):
            raise AssertionError(f"{label}: no prefix hits {k_eng.pool.stats}")
        k_out2, k_wall2, _ = _serve_once(api, params, batch, staged=on_header, **kw)
        if k_out2 != k_out:
            raise AssertionError(f"{label}: a second run gave other tokens")
        k_wall_eager = _eager_equal(label, k_out, api, params, batch, staged=on_header, **kw)
        plain[label] = k_out
        n_tok = sum(len(o) for o in k_out)
        row = dict(path=label, tokens=n_tok, prefill_waves=k_eng.stats["prefills"],
                   decode_steps=k_eng.stats["decode_steps"], launches=k_launches,
                   graph_replays=k_eng.graph.replays,
                   kv_bytes=k_eng.stats["kv_bytes"],
                   kv_bytes_vs_bf16=SERVE_KV_BYTES["bf16"] / k_eng.stats["kv_bytes"],
                   prefilled_tokens=k_eng.stats["prefilled_tokens"],
                   cached_prompt_tokens=k_eng.stats["cached_prompt_tokens"],
                   wall_s_first=k_wall, wall_s=k_wall2, wall_s_eager=k_wall_eager,
                   tok_per_s_first=n_tok / k_wall, tok_per_s=n_tok / k_wall2,
                   tok_per_s_eager=n_tok / k_wall_eager)
        if kw.get("prefix_cache"):
            row["prefix_pool"] = dict(k_eng.pool.stats)
        elif not on_header:
            row["tokens_as_bf16"] = sum(a == b for o, w in zip(k_out, out)
                                        for a, b in zip(o, w)) / n_tok
        if label == "int8":
            row["profile"] = _profile_summary(k_prof, k_wall, k_wall2)
            row["profile_eager"] = _profile(api, params, batch, k_wall_eager,
                                            cuda_graphs=False, **kw)
            if row["profile_eager"].pop("out") != k_out:
                raise AssertionError("the profiled eager int8 run gave other tokens")
            _device_time("int8", (row["profile"], row["profile_eager"]),
                         ("kv_decode (ours)", "kv_quant (ours)"))
        log("serve_kv", **row)
        paths.append(row)

    # logits finite and of the padded vocab; layer 0 (a float block) through
    # the flash kernel agrees with the plain attention on a small batch, and
    # its quantized caches decode as their materialized copies do
    toks = torch.as_tensor(np.stack([np.resize(p, 48) for p in prompts[:2]]), device=dev)
    lens = torch.tensor([48, 20], dtype=torch.int32, device=dev)
    logits, _ = api.prefill(params, {"tokens": toks}, max_len=64, seq_lens=lens)
    if tuple(logits.shape) != (2, lc.padded_vocab(cfg.vocab)) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        raise AssertionError("prefill logits not finite / of the wrong shape")
    x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
    pos = torch.arange(48, device=dev)
    sig = lc.block_sig(cfg, 0)
    outs = [lc.block_prefill(params["blocks"][0], x, cfg.replace(attn_impl=impl), sig,
                             positions=pos, max_len=64, seq_lens=lens)[0]
            for impl in ("flash", "ref")]
    layer0_err = float((outs[0].float() - outs[1].float()).abs().max())
    if not torch.allclose(outs[0].float(), outs[1].float(), rtol=BF16_TOL, atol=BF16_TOL):
        raise AssertionError(f"layer 0 flash vs plain attention: {layer0_err}")
    fused_err = _fused_decode_layer0(params, cfg, toks, lens)
    n_tok = sum(len(o) for o in out)
    row = dict(card=card, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               binary_blocks=n_binary, requests=N_REQUESTS, tokens=n_tok,
               prefill_waves=waves, decode_steps=steps, launches=launches,
               graph_replays=eng.graph.replays, kv_bytes=eng.stats["kv_bytes"], init_s=init_s,
               wall_s_first=wall, wall_s=wall2, wall_s_eager=wall_eager,
               tok_per_s_first=n_tok / wall, tok_per_s=n_tok / wall2,
               tok_per_s_eager=n_tok / wall_eager,
               layer0_flash_vs_plain=layer0_err, layer0_fused_vs_materialized=fused_err,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    log("serve", **row)
    log("profile", card=card, **prof)
    log("profile_eager", card=card, **prof_eager)
    spec = timed("spec", phase_spec, api, params, cfg, prompts, shared, plain, n_binary, card)
    interleave = timed("interleave", phase_interleave, api, params, cfg, prompts, shared, plain,
                       n_binary, card)
    return {**row, "paths": paths, "spec": spec, "interleave": interleave, "plain": plain,
            "prompts": prompts, "shared": shared}


# ---------------------------------------------------------------------------
# phase 6b: speculative decoding at full width (the binarized self-draft)
# ---------------------------------------------------------------------------

SPEC_K = 3
# (label, ServeEngine options, header prompts, the plain path it is held to)
SPEC_PATHS = [("spec bf16", {}, False, "bf16"),
              ("spec int8", dict(kv_cache="int8"), False, "int8"),
              ("spec binary", dict(kv_cache="binary"), False, "binary"),
              ("spec paged int8 + prefix cache", dict(kv_cache="int8", kv_block_size=16,
                                                      prefix_cache=True), True,
               "paged int8 + prefix cache"),
              ("spec int8 sampled", dict(kv_cache="int8", temperature=0.8, seed=SEED), False,
               "int8 sampled")]


def _check_spec_path(label, launches, eng, cfg, n_binary, kv: str, flash_waves: int) -> None:
    """Every kernel's launches on a speculative path: per wave, k draft
    decodes and one verify of k + 1 tokens, so B1 3 x (float FFNs) x k (the
    draft's packed denses), B2 2 x (binary FFNs) x (k + 1), the codec's
    insert kernel layers x (k + 1) (the verify's one span insert), kv_decode
    layers x (k + the verify's launches: one for each MAX_ROWS query rows
    a kv head, G (k + 1) of them, so 1 at G 1 and 2 at G 4); per prefill
    wave as on the plain paths; one draft launch and one graph replay a
    wave."""
    waves, w, k = eng.stats["prefills"], eng.stats["spec_waves"], eng.spec_k
    n_float = cfg.n_layers - n_binary
    g = cfg.n_heads // cfg.n_kv_heads
    verify = -(-(k + 1) // (kvd.MAX_ROWS // g))
    want = {name: 0 for name in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + w * (k + 1))
    want["binary_matmul"] = 3 * n_float * k * w
    want["flash_attention"] = cfg.n_layers * flash_waves
    if kv != "bf16":
        want[f"kv_quant_{kv}"] = cfg.n_layers * (waves + w * (k + 1))
        want[f"kv_decode_{kv}"] = cfg.n_layers * w * (k + verify)
        want[f"kv_dequant_{kv}"] = 2 * cfg.n_layers * (waves - flash_waves)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} for {waves} "
                             f"prefill waves + {w} spec waves")
    if not (eng.stats["spec_draft_launches"] == w == eng.stats["decode_steps"] > 0):
        raise AssertionError(f"{label}: draft launches {eng.stats['spec_draft_launches']}, "
                             f"{w} waves")
    _check_replays(label, eng)


def _top2_gaps(api, params, prompts, out, plain_out, dev) -> list:
    """At each request's first token that differs from the plain path's,
    the plain model's top-2 logit gap there (a prefill over the prompt and
    the plain tokens before it): how close to a tie the two paths split."""
    gaps = []
    for p, o, w in zip(prompts, out, plain_out):
        j = next((i for i, (a, b) in enumerate(zip(o, w)) if a != b), None)
        if j is None:
            continue
        seq = torch.as_tensor(np.concatenate([p, np.asarray(w[:j], np.int64)]), device=dev)
        logits, _ = api.prefill(params, {"tokens": seq[None]}, max_len=len(seq))
        top = torch.topk(logits[0].float(), 2).values
        gaps.append({"index": j, "gap": float(top[0] - top[1])})
    return gaps


def _verify_vs_decode(params, cfg, dev) -> dict:
    """Layer 0's and the last layer's verify pass (float FFNs, k + 1 = 4 tokens,
    the bf16 and the int8 pool) against 4 sequential decodes from the same
    prefilled cache: the span insert and the attend with q_lens against the
    decode insert and attend, within 2e-2 (absolute and relative, as the
    layer 0 flash check: the outputs are bf16, whose step at |x| >= 4
    exceeds 2e-2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=dev)
    new = torch.randint(0, cfg.vocab, (2, SPAN_S), generator=gen, device=dev)
    lens = torch.tensor([40, 17], dtype=torch.int32, device=dev)
    errs = {}
    for kv in ("bf16", "int8"):
        c = cfg.replace(kv_cache=kv)
        for layer in (0, cfg.n_layers - 1):
            p, sig = params["blocks"][layer], lc.block_sig(cfg, layer)
            x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
            _, cache = lc.block_prefill(p, x, c, sig, positions=torch.arange(40, device=dev),
                                        max_len=64, seq_lens=lens)
            cache["len"].copy_(lens)
            seq = {n: a.clone() for n, a in cache.items()}
            xs = embedding_lookup(params["embed"], new, compute_dtype=lc.cdt(cfg))
            got, _ = lc.block_verify(p, xs, c, sig, cache)
            want = torch.cat([lc.block_decode(p, xs[:, j:j + 1], c, sig, seq)[0]
                              for j in range(SPAN_S)], dim=1)
            err = float((got.float() - want.float()).abs().max())
            errs[f"{kv} layer {layer}"] = err
            if not torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2) or \
                    not torch.equal(cache["len"], seq["len"]):
                raise AssertionError(f"verify vs sequential decode, {kv} layer {layer}: {err}")
    return errs


def phase_spec(api, params, cfg, prompts, shared, plain, n_binary, card) -> dict:
    """Full-width stablelm-3b with spec_k = 3 on five paths (bf16, int8,
    binary contiguous greedy; paged int8 with the prefix cache on the
    header prompts; int8 sampled at temperature 0.8), each wave one CUDA
    graph replay: every request gets its 16 tokens in range, the exact
    launches per wave, one draft launch a wave, a second run's tokens, the
    eager waves' tokens, acceptance > 0 over the five paths; printed beside
    them, not gated: the share of tokens equal to the plain graph path's,
    the plain logits' top-2 gap at each request's first divergence,
    acceptance and tok/s, and the draft's agreement with the target."""
    dev = params["embed"]["table"].device
    # the plain sampled int8 path the sampled spec path is held to
    s_out, _, s_eng, s_launches, _ = _counted_run("int8 sampled", api, params, prompts,
                                                  kv_cache="int8", temperature=0.8, seed=SEED)
    _check_outputs("int8 sampled", s_out, cfg.vocab)
    _check_path("int8 sampled", s_launches, s_eng, cfg, n_binary, "int8",
                s_eng.stats["prefills"])
    _check_kv_bytes("int8 sampled", s_eng, cfg, "int8", SERVE_KV_BYTES["int8"])
    _check_replays("int8 sampled", s_eng)
    s_out2, s_wall2, _ = _serve_once(api, params, prompts, kv_cache="int8", temperature=0.8,
                                     seed=SEED)
    if s_out2 != s_out:
        raise AssertionError("int8 sampled: a second run gave other tokens")
    plain = {**plain, "int8 sampled": s_out}
    s_row = dict(path="int8 sampled", tokens=sum(len(o) for o in s_out),
                 decode_steps=s_eng.stats["decode_steps"], wall_s=s_wall2,
                 tok_per_s=sum(len(o) for o in s_out) / s_wall2, launches=s_launches)
    log("serve_kv", **s_row)
    rows = []
    for label, kw, on_header, base in SPEC_PATHS:
        batch = shared if on_header else prompts
        kw = dict(kw, spec_k=SPEC_K)
        out, wall, eng, launches, _ = _counted_run(label, api, params, batch,
                                                   staged=on_header, **kw)
        _check_outputs(label, out, cfg.vocab)
        _check_spec_path(label, launches, eng, cfg, n_binary, kw.get("kv_cache", "bf16"),
                         1 if kw.get("prefix_cache") else eng.stats["prefills"])
        out2, wall2, _ = _serve_once(api, params, batch, staged=on_header, **kw)
        if out2 != out:
            raise AssertionError(f"{label}: a second run gave other tokens")
        wall_eager = _eager_equal(label, out, api, params, batch, staged=on_header, **kw)
        n_tok = sum(len(o) for o in out)
        same = sum(a == b for o, w in zip(out, plain[base]) for a, b in zip(o, w)) / n_tok
        row = dict(path=label, plain_path=base, spec_k=SPEC_K, tokens=n_tok,
                   prefill_waves=eng.stats["prefills"], spec_waves=eng.stats["spec_waves"],
                   spec_drafted=eng.stats["spec_drafted"],
                   spec_accepted=eng.stats["spec_accepted"],
                   acceptance=eng.acceptance_rate(),
                   spec_draft_launches=eng.stats["spec_draft_launches"],
                   graph_replays=eng.graph.replays, launches=launches,
                   tokens_as_plain=same,
                   top2_gap_at_divergence=(None if kw.get("temperature") else
                                           _top2_gaps(api, params, batch, out, plain[base],
                                                      dev)),
                   wall_s_first=wall, wall_s=wall2, wall_s_eager=wall_eager,
                   tok_per_s=n_tok / wall2, tok_per_s_eager=n_tok / wall_eager,
                   cached_prompt_tokens=eng.stats["cached_prompt_tokens"])
        log("spec", **row)
        rows.append(row)
    # random weights: the greedy draft may never agree with the target (a
    # float FFN's draft output correlates ~0.17 with the target's, PERF.md),
    # the sampled one does, from the same stream; tests/test_torch_cuda.py
    # gates acceptance per path on a trained smoke LM
    if not sum(r["spec_accepted"] for r in rows) > 0:
        raise AssertionError(f"no draft token accepted on any spec path: {rows}")
    errs = _verify_vs_decode(params, cfg, dev)
    log("spec_verify", card=card, verify_vs_sequential_decode=errs)
    return {"paths": rows, "plain_sampled": s_row, "verify_vs_decode": errs}


# ---------------------------------------------------------------------------
# phase 6c: interleaved and chunked prefill, telemetry, the front door
# ---------------------------------------------------------------------------

# (label, ServeEngine options, header prompts, chunk, the monolithic path
# whose tokens are compared, not gated); int8 and binary interleave at the
# default slice (the smallest bucket, 8), the paged run at prefill_chunk 32
INTERLEAVE_PATHS = [("interleave int8", dict(kv_cache="int8"), False, 8, "int8"),
                    ("interleave binary", dict(kv_cache="binary"), False, 8, "binary"),
                    ("interleave paged int8 + prefix cache",
                     dict(kv_cache="int8", kv_block_size=16, prefix_cache=True), True, 32,
                     "paged int8 + prefix cache")]
POISSON_N, POISSON_RATE = 16, 0.5          # requests, arrivals per decode step


def _prefill_calls(eng, calls: dict) -> None:
    """Count the engine's prefill work into ``calls``: chunks (of chunked
    prefills and slices) and their kv_decode launches per layer (one per 8
    query rows, G = 1), suffix prefills against a cached prefix, and
    monolithic prefills (the flash kernel)."""
    api = eng.api

    def chunked(p, b, chunk, **kw):
        s = b["tokens"].shape[1]
        c = min(chunk, s)
        calls["chunks"] += s // c
        calls["decode_rows"] += (s // c) * -(-c // kvd.MAX_ROWS)
        return api.prefill_chunked(p, b, chunk=chunk, **kw)

    def sliced(p, c, tok, h, sl, pos):
        calls["chunks"] += 1
        calls["decode_rows"] += -(-tok.shape[1] // kvd.MAX_ROWS)
        return api.prefill_slice(p, c, tok, h, sl, pos)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    eng.api = api._replace(prefill_chunked=chunked, prefill_slice=sliced,
                           prefill_ctx=counted("ctx", api.prefill_ctx),
                           prefill=counted("monolithic", api.prefill))


def _check_prefill_path(label, launches, eng, cfg, n_binary, kv, calls) -> None:
    """Every kernel's launches on a chunked or interleaved path: per chunk
    or slice B2 2 x binary blocks, the insert kernel one a layer (its span
    mode into the transient cache), kv_decode layers x ceil(c / 8), B3 0;
    per suffix prefill on a cached prefix B2, the insert kernel and the
    dequantizer's 2 a layer (its context); per monolithic prefill B3 one a
    layer; per decode step (a replay) B2, the insert kernel and kv_decode
    as on the plain paths."""
    steps, L = eng.stats["decode_steps"], cfg.n_layers
    waves = calls["chunks"] + calls["ctx"] + calls["monolithic"]
    want = {k: 0 for k in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + steps)
    want["flash_attention"] = L * calls["monolithic"]
    want[f"kv_quant_{kv}"] = L * (waves + steps)
    want[f"kv_decode_{kv}"] = L * (calls["decode_rows"] + steps)
    want[f"kv_dequant_{kv}"] = 2 * L * calls["ctx"]
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} for {calls} and "
                             f"{steps} decode steps")
    _check_replays(label, eng)


def _drive_poisson(eng, workload) -> list:
    """Feed (arrival step, prompt, max_new) requests into the engine by its
    step clock, skipping idle gaps; -> each request's tokens."""
    pending, base, rids = sorted(workload, key=lambda w: w[0]), eng.step_count, []
    while pending or eng.queue or any(r is not None for r in eng.slots) or eng._jobs:
        while pending and pending[0][0] <= eng.step_count - base:
            _, prompt, max_new = pending.pop(0)
            rids.append(eng.add_request(prompt, max_new=max_new))
        if not eng.step() and pending:
            eng.step_count = max(eng.step_count + 1, base + pending[0][0])
    torch.cuda.synchronize()
    return [eng.results[r] for r in rids]


def _latency(api, params, cfg, card) -> dict:
    """TTFT and ITL of the blocking and the interleaved int8 engine, each
    with telemetry, on one Poisson workload (warmed on every bucket first,
    then the registry reset). Gated on structure only: the interleaved run
    books prefill_slice spans and no prefill_wave, the blocking run the
    reverse, the slice histogram counts every slice, every request gets its
    tokens. Speed is printed, not gated."""
    from repro_torch.serving.scheduler import poisson_workload
    from repro_torch.serving.telemetry import ENGINE_PID, Telemetry
    wl = poisson_workload(POISSON_N, rate=POISSON_RATE, prompt_lens=PROMPT_LENS,
                          max_new=(MAX_NEW, MAX_NEW), vocab=cfg.vocab, seed=SEED)
    rows = {}
    for mode, kw in (("blocking", {}), ("interleaved", {"interleave": True})):
        tm = Telemetry()
        eng = ServeEngine(api, params, max_batch=8, max_len=256, kv_cache="int8",
                          telemetry=tm, **kw)
        for n in PROMPT_LENS:                                 # warm every bucket
            eng.add_request(np.arange(n) % cfg.vocab, max_new=2)
        eng.run()
        tm.reset()
        slices0, jobs0 = eng.stats["prefill_slices"], eng.stats["prefill_jobs"]
        t0 = time.perf_counter()
        out = _drive_poisson(eng, wl)
        wall = time.perf_counter() - t0
        if any(len(o) != MAX_NEW for o in out):
            raise AssertionError(f"latency, {mode}: a request ended early: {out}")
        spans = {e["name"] for e in tm.chrome_trace()["traceEvents"]
                 if e["ph"] == "X" and e["pid"] == ENGINE_PID}
        slices = eng.stats["prefill_slices"] - slices0
        if mode == "interleaved":
            ok = ("prefill_slice" in spans and "prefill_wave" not in spans
                  and tm.prefill_slice_s.count == slices > 0)
        else:
            ok = "prefill_wave" in spans and "prefill_slice" not in spans and slices == 0
        if not ok:
            raise AssertionError(f"latency, {mode}: spans {spans}, {slices} slices, "
                                 f"{tm.prefill_slice_s.count} slice observations")
        rows[mode] = dict(requests=POISSON_N, rate=POISSON_RATE, wall_s=wall,
                          tokens=sum(len(o) for o in out),
                          ttft_p50_ms=tm.ttft.percentile(50) * 1e3,
                          ttft_p99_ms=tm.ttft.percentile(99) * 1e3,
                          itl_p50_ms=tm.itl.percentile(50) * 1e3,
                          itl_p99_ms=tm.itl.percentile(99) * 1e3,
                          itl_max_ms=max(tm.itl.samples) * 1e3,
                          decode_tick_p50_ms=tm.decode_s.percentile(50) * 1e3,
                          prefill_slice_p50_ms=tm.prefill_slice_s.percentile(50) * 1e3,
                          prefill_wave_p50_ms=tm.prefill_s.percentile(50) * 1e3,
                          prefill_slices=slices,
                          prefill_jobs=eng.stats["prefill_jobs"] - jobs0,
                          decode_steps=eng.stats["decode_steps"])
    log("interleave_latency", card=card, **rows)
    return rows


def _sse(base: str, prompt, max_new: int) -> list[int]:
    import urllib.request
    req = urllib.request.Request(base + "/v1/generate", headers={"Content-Type":
                                                                 "application/json"},
                                 data=json.dumps({"prompt": [int(t) for t in prompt],
                                                  "max_new": max_new,
                                                  "stream": True}).encode())
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=300) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                ev = json.loads(line[len("data: "):])
                if "token" in ev:
                    toks.append(ev["token"])
                else:
                    done = ev
    if done != {"done": True, "tokens": toks}:
        raise AssertionError(f"front door: the stream ended with {done}")
    return toks


def _front_door(api, params, cfg) -> dict:
    """A FrontDoor on port 0 (localhost) over a full-width interleaved int8
    engine with telemetry, started as a user starts it (``start()``: the
    listener and the engine thread): three SSE clients, started together,
    each get the tokens a direct engine gives the same request. The three
    prompts lie in three buckets (16, 64, 128), so each prefill job holds
    one request however the HTTP threads happen to enqueue them, and every
    decode tick replays one graph over all the slots: a request's tokens do
    not depend on when its neighbours arrived. A prompt past max_len gets
    400; /metrics counts the tokens; close() leaves no live thread of the
    front door's."""
    import threading
    import urllib.error
    import urllib.request
    from repro_torch.launch.server import FrontDoor
    from repro_torch.serving.telemetry import Telemetry
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (16, 48, 100)]
    kw = dict(max_batch=8, max_len=256, kv_cache="int8", interleave=True)
    direct = ServeEngine(api, params, **kw)
    rids = [direct.add_request(p, max_new=MAX_NEW) for p in prompts]
    res = direct.run()
    want = [res[r] for r in rids]
    fd = FrontDoor(ServeEngine(api, params, telemetry=Telemetry(), **kw), port=0,
                   queue_limit=8).start()
    base = f"http://{fd.host}:{fd.port}"
    got, errs = [None] * 3, []

    def client(i):
        try:
            got[i] = _sse(base, prompts[i], MAX_NEW)
        except Exception as e:  # noqa: BLE001 - recorded and raised below
            errs.append(e)
    t0 = time.perf_counter()
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        stream_s = time.perf_counter() - t0
        try:
            urllib.request.urlopen(urllib.request.Request(
                base + "/v1/generate", data=json.dumps({"prompt": [1] * 300,
                                                        "max_new": 4}).encode()), timeout=60)
            status = 200
        except urllib.error.HTTPError as e:
            status, body = e.code, json.loads(e.read())
        metrics = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
    finally:
        fd.close()
    alive = [t.name for t in threading.enumerate() if t.name.startswith("frontdoor")]
    if errs or got != want:
        raise AssertionError(f"front door: streams {got}, direct {want}, errors {errs}")
    if status != 400 or body["error"]["code"] != "prompt_too_long":
        raise AssertionError(f"front door: an over-long prompt got {status}")
    if f"serve_tokens_total {3 * MAX_NEW}" not in metrics.splitlines() or alive \
            or health != {"ok": True}:
        raise AssertionError(f"front door: metrics, health {health} or live threads {alive}")
    return dict(clients=3, tokens=sum(len(o) for o in got), stream_s=stream_s,
                overlong_status=status)


def _http_launcher(card) -> dict:
    """The launcher's ``--http`` mode as a user runs it, at full width on the
    int8 pool (interleave on, its default there): it logs its port,
    /healthz answers, one JSON request gets MAX_NEW tokens, and SIGINT ends
    it with exit code 0 and a metrics file that counts those tokens."""
    import queue
    import re
    import signal
    import threading
    import urllib.request
    root = Path(__file__).resolve().parent
    out = OUT_DIR / "launcher"
    out.mkdir(parents=True, exist_ok=True)
    metrics = out / "http_metrics.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "stablelm-3b",
           "--kv-cache", "int8", "--prompt-lens", "48", "--max-new", str(MAX_NEW),
           "--http", "0", "--metrics-out", str(metrics)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(root / "src")})
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stderr], daemon=True)
    reader.start()
    err, base = [], None
    try:
        while base is None and time.perf_counter() - t0 < 300:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            err.append(line)
            m = re.search(r"serving on (http://[\d.]+:\d+)", line)
            base = m.group(1) if m else None
        if base is None:
            raise AssertionError(f"--http: no port logged: {''.join(err)[-3000:]}")
        up_s = time.perf_counter() - t0
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=60).read())
        prompt = [int(t) for t in np.random.default_rng(SEED + 3).integers(0, 256, 48)]
        r = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/v1/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({"prompt": prompt, "max_new": MAX_NEW}).encode()),
            timeout=300).read())
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        err.append(lines.get())
    if rc != 0 or health != {"ok": True} or len(r["tokens"]) != MAX_NEW:
        raise AssertionError(f"--http: rc {rc}, health {health}, answer {r}: "
                             f"{''.join(err)[-3000:]}")
    m = json.loads(metrics.read_text())
    if m["counters"]["serve_tokens_total"] != MAX_NEW:
        raise AssertionError(f"--http: metrics {m['counters']}")
    return dict(seconds=time.perf_counter() - t0, up_s=up_s, rc=rc,
                tokens=len(r["tokens"]),
                interleave_warned=any("--http turns --interleave on" in x for x in err))


def _launcher(card) -> dict:
    """The serving launcher as a user runs it, at full width, interleaved
    on the int8 pool with the SLO scheduler, telemetry files and a
    torch.profiler trace: it exits 0, the metrics JSON parses, the trace
    holds prefill_slice spans, the profile directory is not empty."""
    root = Path(__file__).resolve().parent
    out = OUT_DIR / "launcher"
    out.mkdir(parents=True, exist_ok=True)
    metrics, trace, prof = out / "metrics.json", out / "trace.json", out / "profile"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "stablelm-3b",
           "--requests", str(N_REQUESTS), "--prompt-lens", ",".join(map(str, PROMPT_LENS)),
           "--max-new", str(MAX_NEW), "--kv-cache", "int8", "--interleave", "--scheduler",
           "slo", "--metrics-out", str(metrics), "--trace-out", str(trace),
           "--torch-profile", str(prof)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    if proc.returncode != 0:
        raise AssertionError(f"launcher exited {proc.returncode}: {proc.stderr[-3000:]}")
    m = json.loads(metrics.read_text())
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e["ph"] == "X"}
    if "prefill_slice" not in spans or not any(prof.iterdir()) or \
            m["counters"]["serve_tokens_total"] != N_REQUESTS * MAX_NEW:
        raise AssertionError(f"launcher: spans {spans}, profile {list(prof.iterdir())}, "
                             f"metrics {m['counters']}")
    return dict(seconds=time.perf_counter() - t0, spans=sorted(spans),
                tokens=m["counters"]["serve_tokens_total"],
                ttft_p50_ms=m["histograms"]["serve_ttft_seconds"]["p50"] * 1e3,
                itl_p50_ms=m["histograms"]["serve_itl_seconds"]["p50"] * 1e3,
                profile_files=sorted(f.name for f in prof.iterdir()))


def phase_interleave(api, params, cfg, prompts, shared, plain, n_binary, card) -> dict:
    """Full-width stablelm-3b with interleaved prefill: on each path of
    INTERLEAVE_PATHS the interleaved engine's tokens equal the chunked
    blocking engine's at the same chunk exactly, and the launches of both
    runs equal what their slices, chunks, suffix prefills and replays
    imply; the share of tokens equal to the monolithic blocking path is
    printed, not gated. Then telemetry on against off (int8: the same
    tokens, launches and replays), TTFT and ITL on a Poisson workload, the
    front door, and the launcher in its batch and its --http mode."""
    from repro_torch.serving.telemetry import Telemetry
    rows, launches = [], []
    for label, kw, on_header, chunk, base in INTERLEAVE_PATHS:
        batch = shared if on_header else prompts
        kv = kw["kv_cache"]
        runs = {}
        for mode, extra in (("chunked", dict(prefill_chunk=chunk)),
                            ("interleaved", dict(interleave=True,
                                                 **({"prefill_chunk": chunk}
                                                    if chunk != 8 else {})))):
            calls = dict.fromkeys(("chunks", "decode_rows", "ctx", "monolithic"), 0)
            out, wall, eng, n, _ = _counted_run(
                f"{label}, {mode}", api, params, batch, staged=on_header,
                setup=lambda e, c=calls: _prefill_calls(e, c), **kw, **extra)
            _check_outputs(f"{label}, {mode}", out, cfg.vocab)
            _check_prefill_path(f"{label}, {mode}", n, eng, cfg, n_binary, kv, calls)
            runs[mode] = (out, wall, eng, n, calls)
            launches.append(n)
        (c_out, c_wall, c_eng, _, c_calls), (out, wall, eng, n, calls) = \
            runs["chunked"], runs["interleaved"]
        if out != c_out:
            raise AssertionError(f"{label}: interleaved tokens differ from chunked blocking")
        if not (eng.stats["prefill_slices"] == calls["chunks"] > 0
                and eng.stats["prefill_jobs"] > 0 and calls["monolithic"] == 0):
            raise AssertionError(f"{label}: stats {eng.stats}, calls {calls}")
        if kw.get("prefix_cache") and not (eng.pool.stats["hits"] > 0 and calls["ctx"] > 0):
            raise AssertionError(f"{label}: no prefix hits {eng.pool.stats}")
        n_tok = sum(len(o) for o in out)
        row = dict(path=label, chunk=chunk, tokens=n_tok, launches=n, calls=calls,
                   chunked_calls=c_calls, prefill_jobs=eng.stats["prefill_jobs"],
                   prefill_slices=eng.stats["prefill_slices"], prefills=eng.stats["prefills"],
                   decode_steps=eng.stats["decode_steps"], graph_replays=eng.graph.replays,
                   chunked_decode_steps=c_eng.stats["decode_steps"],
                   tokens_as_chunked=1.0,
                   tokens_as_monolithic=sum(a == b for o, w in zip(out, plain[base])
                                            for a, b in zip(o, w)) / n_tok,
                   wall_s_first=wall, wall_s_chunked_first=c_wall,
                   tok_per_s_first=n_tok / wall, tok_per_s_chunked_first=n_tok / c_wall)
        if label == "interleave int8":
            # telemetry on: the same tokens, launches per wrapper and replays
            t_out, _, t_eng, t_n, _ = _counted_run(f"{label}, telemetry", api, params, batch,
                                                   telemetry=Telemetry(), interleave=True, **kw)
            if (t_out, t_n, t_eng.graph.replays) != (out, n, eng.graph.replays):
                raise AssertionError(f"{label}: telemetry on changed the run: {t_n} vs {n}, "
                                     f"{t_eng.graph.replays} vs {eng.graph.replays} replays")
            launches.append(t_n)
            row["telemetry_on_equal"] = True
        log("interleave", **row)
        rows.append(row)
    latency = _latency(api, params, cfg, card)
    front = _front_door(api, params, cfg)
    log("interleave_front_door", card=card, **front)
    torch.cuda.empty_cache()
    launcher = _launcher(card)
    log("interleave_launcher", card=card, **launcher)
    http = _http_launcher(card)
    log("interleave_http_launcher", card=card, **http)
    return {"paths": rows, "latency": latency, "front_door": front, "launcher": launcher,
            "http_launcher": http, "launches": launches}


# ---------------------------------------------------------------------------
# phase 6d: the attention families at full width
# ---------------------------------------------------------------------------

def _mla_layer0(params, cfg, prompts, dev) -> float:
    """Layer 0's MLA prefill of a small right-padded batch through B3 (q and
    k [nope | rope], v of Dv) against the plain attention (3e-2); the
    logits finite and of the padded vocab."""
    toks = torch.as_tensor(np.stack([np.resize(p, 48) for p in prompts[:2]]), device=dev)
    lens = torch.tensor([48, 20], dtype=torch.int32, device=dev)
    logits, _ = get_model(cfg).prefill(params, {"tokens": toks}, max_len=64, seq_lens=lens)
    if tuple(logits.shape) != (2, lc.padded_vocab(cfg.vocab)) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        raise AssertionError(f"{cfg.name}: prefill logits not finite / of the wrong shape")
    x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
    pos = torch.arange(48, device=dev)
    outs = [lc.block_prefill(params["blocks"][0], x, cfg.replace(attn_impl=impl),
                             lc.block_sig(cfg, 0), positions=pos, max_len=64,
                             seq_lens=lens)[0] for impl in ("flash", "ref")]
    err = float((outs[0].float() - outs[1].float()).abs().max())
    if not torch.allclose(outs[0].float(), outs[1].float(), rtol=BF16_TOL, atol=BF16_TOL):
        raise AssertionError(f"{cfg.name}: layer 0 flash vs plain MLA attention: {err}")
    return err


def _free(dev) -> None:
    """Let the last model's tensors go before the next one loads, and start
    the peak-memory count anew."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


# (arch, the cut, [(label, ServeEngine options)], exact pool bytes of each
# codec at max_batch 8, max_len 256: GQA layers x 2 x 8 x 256 x kv heads x
# a row's bytes (bf16 256, int8 128 + 2, binary 4 words + 2); MLA layers x
# 8 x 256 x (kv_lora + rope) x 2)
SERVED_FAMILIES = [
    ("minicpm3-4b", {}, [("bf16", {})], {"bf16": 73_138_176}),
    ("deepseek-v2-236b", dict(n_layers=5), [("bf16", {})], {"bf16": 11_796_480}),
    ("qwen3-8b", {}, [("bf16", {}), ("int8", dict(kv_cache="int8")),
                      ("binary", dict(kv_cache="binary")),
                      ("spec int8", dict(kv_cache="int8", spec_k=SPEC_K))],
     {"bf16": 301_989_888, "int8": 153_354_240, "binary": 21_233_664}),
    ("qwen2-72b", dict(n_layers=5), [("int8", dict(kv_cache="int8"))], {"int8": 21_299_200}),
    ("deepseek-v3-671b", dict(n_layers=4), [("bf16", {})], {"bf16": 9_437_184}),
]
# served but not traced: minicpm3-4b's MLA path is traced on
# deepseek-v2-236b, and its own trace (62 layers of eager prefill waves)
# cost ~80 s of the script's time limit (PERF.md section 7)
UNTRACED = {"minicpm3-4b"}
ENCDEC_BATCH, WHISPER_PROMPT, VLM_PROMPT, ENCDEC_STEPS = 8, 32, 128, 16


def _check_cut(arch, sigs) -> None:
    """A cut keeps the block kinds it is there for: deepseek-v2's a binary
    MoE block, qwen2's one binary block, deepseek-v3's three dense blocks
    and a float MoE."""
    if arch == "deepseek-v2-236b" and not any(sg.ffn == "binary" and sg.moe for sg in sigs):
        raise AssertionError(f"{arch}: the cut holds no binary MoE block: {sigs}")
    if arch == "qwen2-72b" and sum(sg.ffn == "binary" for sg in sigs) != 1:
        raise AssertionError(f"{arch}: the cut should keep one binary block: {sigs}")
    if arch == "deepseek-v3-671b" and [(sg.moe, sg.ffn) for sg in sigs] != \
            [(False, "float")] * 3 + [(True, "float")]:
        raise AssertionError(f"{arch}: the cut should be 3 dense blocks and a float MoE: {sigs}")


def _served_family(arch, cut, paths, kv_bytes, dev, card) -> tuple[list, list]:
    """One model of SERVED_FAMILIES through ServeEngine on each of its paths,
    the serve phase's 12 requests: counted (the first path traced, unless
    the model is UNTRACED: device events = counts + the warm-up), each
    replay's counts = its graph's kernel nodes, exact launches and pool
    bytes, a second replayed run and an eager run with the same tokens; an
    MLA model's layer 0 through B3
    against the plain attention -> (rows, launches of each path)."""
    cfg = get_config(arch).replace(**cut)
    sigs = [lc.block_sig(cfg, i) for i in range(cfg.n_layers)]
    _check_cut(arch, sigs)
    n_binary = sum(sg.ffn == "binary" and not sg.moe for sg in sigs)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS)))
               for _ in range(N_REQUESTS)]
    rows, all_launches = [], []
    t_path = time.perf_counter()
    for i, (label, kw) in enumerate(paths):
        lab = f"{arch} {label}"
        kv = kw.get("kv_cache", "bf16")
        out, wall, eng, launches, prof = _counted_run(lab, api, params, prompts,
                                                      profiled=i == 0 and arch not in UNTRACED,
                                                      **kw)
        _check_outputs(lab, out, cfg.vocab)
        waves = eng.stats["prefills"]
        if kw.get("spec_k"):
            _check_spec_path(lab, launches, eng, cfg, n_binary, kv, waves)
        else:
            _check_path(lab, launches, eng, cfg, n_binary, kv, waves)
            _check_replays(lab, eng)
        _check_kv_bytes(lab, eng, cfg, kv, kv_bytes[kv])
        steps = eng.stats["decode_steps"]
        del eng
        out2, wall2, _ = _serve_once(api, params, prompts, **kw)
        if out2 != out:
            raise AssertionError(f"{lab}: a second run gave other tokens")
        wall_eager = _eager_equal(lab, out, api, params, prompts, **kw)
        n_tok = sum(len(o) for o in out)
        row = dict(card=card, arch=arch, path=label, cut=cut, n_layers=cfg.n_layers,
                   d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
                   binary_dense_ffns=n_binary, param_bytes=param_bytes, init_s=init_s,
                   tokens=n_tok, prefill_waves=waves, decode_steps=steps, launches=launches,
                   kv_bytes=kv_bytes[kv], wall_s_first=wall, wall_s=wall2,
                   wall_s_eager=wall_eager, tok_per_s_first=n_tok / wall,
                   tok_per_s=n_tok / wall2, tok_per_s_eager=n_tok / wall_eager,
                   peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        if prof is not None:
            row["profile"] = _profile_summary(prof, wall, wall2)
            row["busy_share"] = row["profile"]["busy_share"]
        if cfg.use_mla and i == 0:
            row["layer0_flash_vs_plain"] = _mla_layer0(params, cfg, prompts, dev)
        row["seconds"] = time.perf_counter() - t_path
        t_path = time.perf_counter()
        log("families", **row)
        rows.append(row)
        all_launches.append(launches)
        del prof
    del params, api
    return rows, all_launches


def _greedy(api, params, batch: dict, steps: int, max_len: int):
    """A prefill, then ``steps`` greedy decodes -> (tokens (B, steps + 1),
    prefill s, decode s), each closed by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = api.prefill(params, batch, max_len=max_len)
    toks = [logits.argmax(-1)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        logits, caches = api.decode(params, caches, toks[-1][:, None])
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    return torch.stack(toks, 1), t1 - t0, time.perf_counter() - t1


def _decode_parity(label, api, params, batch: dict, max_len: int, vocab: int,
                   gate: bool = True, rel: float = 2e-2, floor: float = 5e-2,
                   argmax: bool = True) -> dict:
    """prefill(S - 1) then decode(1) against prefill(S) at the last position
    (tests/test_decode_parity.py): within max(rel x scale, floor) and, with
    ``argmax``, the same argmax in every row (``gate``: else only measured);
    the padded vocab's -1e9 columns left out."""
    gold, _ = api.prefill(params, batch, max_len=max_len)
    _, caches = api.prefill(params, {**batch, "tokens": batch["tokens"][:, :-1]},
                            max_len=max_len)
    got, _ = api.decode(params, caches, batch["tokens"][:, -1:])
    gold, got = gold[:, :vocab].float(), got[:, :vocab].float()
    scale, err = float(gold.abs().max()), float((gold - got).abs().max())
    top = torch.topk(gold, 2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1]).tolist()
    same = torch.equal(gold.argmax(-1), got.argmax(-1))
    if gate and not (err < max(rel * scale, floor) and (same or not argmax)):
        raise AssertionError(f"{label}: prefill(S-1) + decode(1) vs prefill(S): {err} "
                             f"(scale {scale}), argmax {gold.argmax(-1).tolist()} vs "
                             f"{got.argmax(-1).tolist()}, top-2 gaps {gaps}")
    return {"max_abs_err": err, "scale": scale, "same_argmax": same, "top2_gaps": gaps}


def _encdec_launches(cfg, steps: int) -> dict[str, int]:
    """whisper's or the VLM's launches in a prefill and ``steps`` decodes:
    B2 2 x binary FFNs a call; B3 whisper's encoder, causal and cross
    layers a prefill and its cross layers a step, the VLM's self layers a
    prefill and its cross blocks a call; the VLM's int8 pool its insert a
    layer and call, kv_decode a layer and step; all else 0."""
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    want = {k: 0 for k in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (1 + steps)
    if cfg.family == "whisper":
        want["flash_attention"] = cfg.enc_layers + 2 * cfg.n_layers + cfg.n_layers * steps
    else:
        n_cross = cfg.n_layers // cfg.cross_every
        want["flash_attention"] = cfg.n_layers + n_cross * (1 + steps)
        want["kv_quant_int8"] = cfg.n_layers * (1 + steps)
        want["kv_decode_int8"] = cfg.n_layers * steps
    return want


def _encdec_batch(cfg, dev, rng, gen) -> tuple[dict, int, int]:
    """whisper's or the VLM's batch of ENCDEC_BATCH rows -> (the batch,
    its prompt length, max_len): whisper WHISPER_PROMPT tokens and its
    frames, the VLM the serve prompts each repeated out to VLM_PROMPT
    tokens and its patches."""
    b = ENCDEC_BATCH
    if cfg.family == "whisper":
        s, max_len = WHISPER_PROMPT, 64
        toks = rng.integers(0, cfg.vocab, (b, s))
        ctx = {"frames": torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=gen,
                                     device=dev).to(lc.cdt(cfg))}
    else:
        s, max_len = VLM_PROMPT, VLM_PROMPT + ENCDEC_STEPS + 16
        toks = np.stack([np.resize(rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS))), s)
                         for _ in range(b)])
        ctx = {"patches": torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen,
                                      device=dev).to(lc.cdt(cfg))}
    return {"tokens": torch.as_tensor(toks, device=dev), **ctx}, s, max_len


def _open_gates(params) -> None:
    """Random init leaves every VLM cross gate at 0, and tanh(0) = 0 would
    make each cross block add nothing: open them."""
    for blk in params.get("cross", []):
        blk["gate_attn"].fill_(0.5)
        blk["gate_ffn"].fill_(0.5)


def _encdec(arch, dev, card) -> tuple[dict, dict]:
    """whisper-base or llama-3.2-vision-11b at full width through
    get_model's prefill and decode (repro gives them no slot engine): batch
    8, a prefill and ENCDEC_STEPS greedy decodes with the counts zeroed just
    before and read just after, exact; a warm run of the same tokens; a
    traced run whose device events are the counts (or one fewer: a dropped
    record); the decode parity."""
    cfg = get_config(arch)
    if cfg.family == "vlm":
        cfg = cfg.replace(kv_cache="int8")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b = ENCDEC_BATCH
    batch, s, max_len = _encdec_batch(cfg, dev, np.random.default_rng(SEED), gen)
    ctx = {k: v for k, v in batch.items() if k != "tokens"}
    _open_gates(params)
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    steps = ENCDEC_STEPS
    zero_counts()
    out, prefill_s, decode_s = _greedy(api, params, batch, steps, max_len)
    launches = counts()
    want = _encdec_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    if not (out.shape == (b, steps + 1) and bool(((out >= 0) & (out < cfg.vocab)).all())):
        raise AssertionError(f"{arch}: bad tokens {out.tolist()}")
    out2, prefill2, decode2 = _greedy(api, params, batch, steps, max_len)
    if not torch.equal(out2, out):
        raise AssertionError(f"{arch}: a second run gave other tokens")
    zero_counts()
    with _trace() as prof:
        out3, prefill3, decode3 = _greedy(api, params, batch, steps, max_len)
    if counts() != launches or not torch.equal(out3, out):
        raise AssertionError(f"{arch}: the traced run differs: {counts()}, {launches}")
    # the trace's kernel events of each family are the counts, or one
    # fewer: a trace can drop a record (one B3 event of 114 in one whisper
    # run), and no graph's nodes hold these eager runs as they hold the
    # served ones; never one more
    device_events = _device_launches(prof)
    profile_row = _profile_summary(prof, prefill3 + decode3, prefill2 + decode2)
    del prof
    for fam, n in _by_family(launches).items():
        if not n - 1 <= device_events.get(fam, 0) <= n:
            raise AssertionError(f"{arch}: the trace's kernel events {device_events} are not "
                                 f"the counts {launches} (at most one dropped a family)")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # The parity is a check of the decode logic (caches, positions, cross
    # blocks), and it gates where path noise cannot reach the logits through
    # a binary FFN's sign: f32 compute (params stay bf16), the bf16 pool
    # (repro's default, which tests/test_decode_parity.py runs), float FFNs,
    # as that test gates MoE in f32 at capacity 16; and whisper's served
    # weights, binary FFNs included, in f32 on its bf16 pool, where 8 rows x
    # (512 + 2048) x 4 binary inputs leave ~0.1 expected within f32's path
    # noise of 0. A binary FFN mixes no positions, but it turns path noise
    # into O(1): the prefill's B3 and the decode's plain attention round
    # apart (~1e-2 in bf16, ~1e-6 in f32), an int8 pool's decode reads codes
    # where the prefill attended exact K/V, and one flipped sign of a binary
    # FFN's input moves each of its d_ff integer dots by 2, flipping the
    # signs the next dense reads; the VLM's 8 x (4096 + 14336) x 36 binary
    # inputs leave ~4 within f32's noise. Measured beside it, not gated: the
    # served config (bf16, the VLM's int8 pool), the VLM's binary FFNs in
    # f32, and the VLM's float FFNs in f32 on its int8 pool (ROADMAP C).
    parity_served = _decode_parity(arch, api, params, batch, max_len, cfg.vocab, gate=False)
    f32 = cfg.replace(compute_dtype="float32", kv_cache="auto")
    parity_binary_f32 = _decode_parity(f"{arch} f32", get_model(f32), params, batch, max_len,
                                       cfg.vocab, gate=cfg.family == "whisper")
    del params, api
    _free(dev)
    f32_float = f32.replace(policy=PrecisionPolicy(binary_ffn=False))
    f_api = get_model(f32_float)
    f_params = f_api.init(SEED, device=dev)
    _open_gates(f_params)
    parity = _decode_parity(f"{arch} f32, float FFNs", f_api, f_params, batch, max_len,
                            cfg.vocab)
    parity_int8_f32 = None
    if cfg.family == "vlm":
        parity_int8_f32 = _decode_parity(f"{arch} f32, float FFNs, int8 pool",
                                         get_model(f32_float.replace(kv_cache="int8")),
                                         f_params, batch, max_len, cfg.vocab, gate=False)
    del f_params, f_api
    row = dict(card=card, arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
               heads=[cfg.n_heads, cfg.n_kv_heads], kv_cache=cfg.kv_cache,
               binary_dense_ffns=n_binary, param_bytes=param_bytes, init_s=init_s,
               batch=b, prompt=s, context=int(next(iter(ctx.values())).shape[1]),
               decode_steps=steps, launches=launches, device_events=device_events,
               prefill_ms=prefill2 * 1e3,
               decode_step_ms=decode2 / steps * 1e3, tok_per_s=b * steps / decode2,
               busy_share=profile_row["busy_share"], decode_parity=parity,
               decode_parity_served=parity_served, decode_parity_binary_f32=parity_binary_f32,
               decode_parity_int8_f32=parity_int8_f32,
               peak_mem_gib=peak, seconds=time.perf_counter() - t0, profile=profile_row)
    log("families", **row)
    return row, launches


def phase_families(dev, card: str) -> dict:
    """minicpm3-4b, deepseek-v2-236b cut to 5 layers, qwen3-8b, qwen2-72b
    cut to 5 and deepseek-v3-671b cut to 4, served; whisper-base and
    llama-3.2-vision-11b, prefilled and decoded; all at full width, each
    model freed before the next loads (module note, 6d) -> {"rows",
    "launches"}."""
    rows, launches = [], []
    for arch, cut, paths, kv_bytes in SERVED_FAMILIES:
        _free(dev)
        r, ls = _served_family(arch, cut, paths, kv_bytes, dev, card)
        rows += r
        launches += ls
    for arch in ("whisper-base", "llama-3.2-vision-11b"):
        _free(dev)
        r, ls = _encdec(arch, dev, card)
        rows.append(r)
        launches.append(ls)
    _free(dev)
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 6e: the recurrent families at full width
# ---------------------------------------------------------------------------

# (arch, the cut: half the depth of 54 and 32 blocks, full width (the
# script's time limit), its paths: the shared block's pool codec, or
# "state"); exact bytes at 8 slots and max_len 256: zamba2's Mamba state
# (h + conv, f32) 27 x (80 x 64 x 64 + 3 x 5,248) x 4 x 8, its shared
# block's pool 4 invocations x 8 x 256 x a token's bytes (bf16 2 x 32 x 80
# x 2; int8 2 x 32 x (80 + 2)); rwkv6's state (tm_s + tm_x + cm_x, f32) 16
# x (40 x 64 x 64 + 2 x 2,560) x 4 x 8
RECURRENT = [("zamba2-2.7b", dict(n_layers=27), ["bf16", "int8"]),
             ("rwkv6-3b", dict(n_layers=16), ["state"])]
STATE_BYTES = {"zamba2-2.7b": 296_718_336, "rwkv6-3b": 86_507_520}
POOL_BYTES = {"bf16": 83_886_080, "int8": 42_991_616, "state": 0}
# decode parity's prompt (zamba2: two SSD chunks of 128 with a ragged tail)
# and its bar, of the logits' scale, in f32 with float denses. rwkv6's
# time-mix projections and c_r round to bf16 whatever the config says
# (models/rwkv6.py, as repro); cuBLAS sums the prefill's (504, 2560) and
# the decode's (8, 2560) products in other orders, so some round to the
# next bf16 (2^-8 of themselves), and over 32 blocks the logits move by
# ~5e-3 of their scale (on the CPU, whose sums per row do not depend on M,
# the smoke model's parity is exact): rwkv6 is held to bf16's 2^-7
PARITY_S = {"zamba2-2.7b": 200, "rwkv6-3b": 64}
PARITY_REL = {"zamba2-2.7b": 2e-3, "rwkv6-3b": 2 ** -7}
# the smoke loss (absolute) and grads (of each leaf's max-abs), card against
# CPU: zamba2's (binary blocks kept) as the train phase holds stablelm's.
# rwkv6's time-mix projections and c_r round to bf16 whatever the config
# says (models/rwkv6.py, as repro): card and CPU sum them in other orders,
# and a sum on a rounding edge moves by 2^-8 of itself. On the CPU alone,
# 1e-7 to 1e-5 of relative noise in every param moves its smoke grads at
# batch 8 x 40 by up to 0.065 of a leaf's max-abs with float denses, and by
# ~0.9 with its binary channel-mix, whose signs flip on that noise: it is
# gated with float denses (the loss within 2^-10 of its ~5.5) and its
# binary config printed beside
RECURRENT_TRAIN_TOL = {"zamba2-2.7b": {"loss": 1e-5, "grad": TRAIN_TOL["grad"]},
                       "rwkv6-3b": {"loss": 5e-3, "grad": 2 ** -3}}


def _recurrent_bytes(cfg, caches) -> tuple[int, int]:
    """(the recurrent state's bytes, the shared block's pool bytes)."""
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    if cfg.family == "mamba2_hybrid":
        return nbytes(caches["mamba"]), kvc.kv_pool_bytes(caches["attn"])
    return nbytes(caches), 0


class _Calls:
    """``api`` with its prefill and decode counted and timed (each call
    closed by a synchronize: the bucket engine reads every step's tokens
    on the host anyway) and the bytes per batch row of the caches each
    call returns kept."""

    def __init__(self, api):
        self.n = {"prefill": 0, "decode": 0}
        self.s = {"prefill": 0.0, "decode": 0.0}
        self.row_bytes: set = set()

        def wrap(name, fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = fn(*args, **kw)
                torch.cuda.synchronize()
                self.s[name] += time.perf_counter() - t0
                self.n[name] += 1
                self.row_bytes.add(tuple(b // logits.shape[0]
                                         for b in _recurrent_bytes(api.cfg, caches)))
                return logits, caches
            return call
        self.api = api._replace(prefill=wrap("prefill", api.prefill),
                                decode=wrap("decode", api.decode))


def _bucket_once(api, params, prompts):
    """The prompts through a fresh BucketEngine (max_batch 8, max_len 256)
    -> (tokens, wall s, the _Calls)."""
    calls = _Calls(api)
    eng = BucketEngine(calls.api, params, max_batch=8, max_len=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new=MAX_NEW) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids], time.perf_counter() - t0, calls


def _recurrent_launches(label, calls, n_binary, n_shared) -> dict[str, int]:
    """A recurrent path's launches: B2 2 x binary blocks per prefill and
    step, B3 once per shared invocation per prefill, on the int8 pool the
    insert kernel once per invocation per prefill and step and kv_decode
    once per invocation per step; every other kernel 0."""
    waves, steps = calls.n["prefill"], calls.n["decode"]
    want = {k: 0 for k in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + steps)
    want["flash_attention"] = n_shared * waves
    if label == "int8":
        want["kv_quant_int8"] = n_shared * (waves + steps)
        want["kv_decode_int8"] = n_shared * steps
    return want


def _recurrent_path(arch, label, api, params, prompts, n_binary, n_shared, card) -> dict:
    """One served path of a recurrent model through the bucket engine: the
    counted run (exact launches, every cache's bytes per row, tokens in
    range), a second run with the same tokens (warm tok/s, prefill and
    decode ms); then the longest prompts' group alone, untraced and traced
    (CUDA activity only: an eager step's host ops would be ~25,000 trace
    events), its launches exact and the trace's kernel events the counts or
    one fewer: its busy share and device ms by family."""
    lab = f"{arch} {label}"
    zero_counts()
    out, wall, calls = _bucket_once(api, params, prompts)
    launches = counts()
    want = _recurrent_launches(label, calls, n_binary, n_shared)
    if launches != want:
        raise AssertionError(f"{lab}: launches {launches}, want {want} for {calls.n}")
    _check_outputs(lab, out, api.cfg.vocab)
    row_bytes = (STATE_BYTES[arch] // 8, POOL_BYTES[label] // 8)
    if calls.row_bytes != {row_bytes}:
        raise AssertionError(f"{lab}: bytes per row {calls.row_bytes}, want {row_bytes}")
    out2, wall2, calls2 = _bucket_once(api, params, prompts)
    if out2 != out:
        raise AssertionError(f"{lab}: a second run gave other tokens")
    longest = max(len(p) for p in prompts)
    group = [p for p in prompts if len(p) == longest]
    g_out, g_wall, _ = _bucket_once(api, params, group)
    zero_counts()
    with _trace() as prof:
        g_out2, g_wall_traced, g_calls = _bucket_once(api, params, group)
    g_launches = counts()
    if g_out2 != g_out or g_launches != _recurrent_launches(label, g_calls, n_binary, n_shared):
        raise AssertionError(f"{lab}: the traced group run differs: {g_launches}")
    device_events = _device_launches(prof)
    for fam, n in _by_family(g_launches).items():
        if not n - 1 <= device_events.get(fam, 0) <= n:
            raise AssertionError(f"{lab}: the trace's kernel events {device_events} are not "
                                 f"the counts {g_launches} (at most one dropped a family)")
    profile_row = _profile_summary(prof, g_wall_traced, g_wall)
    del prof
    n_tok = sum(len(o) for o in out)
    return dict(card=card, arch=arch, path=label, prefills=calls.n["prefill"],
                decode_steps=calls.n["decode"], launches=launches,
                state_bytes=STATE_BYTES[arch], pool_bytes=POOL_BYTES[label],
                wall_s_first=wall, wall_s=wall2, tok_per_s=n_tok / wall2,
                prefill_ms=calls2.s["prefill"] / calls2.n["prefill"] * 1e3,
                decode_step_ms=calls2.s["decode"] / calls2.n["decode"] * 1e3,
                traced_group=dict(prompts=len(group), length=longest, wall_s=g_wall,
                                  launches=g_launches, device_events=device_events),
                busy_share=profile_row["busy_share"], profile=profile_row)


def _sequence_mixing_ms(cfg, params, dev, timer) -> dict[str, float]:
    """Device ms of one call of the plain-torch sequence mixing at the
    served shapes (8 rows; prefill 128 tokens): zamba2's SSD and causal
    conv over a prompt and one Mamba2 block's decode (its B2 products
    included); rwkv6's WKV loop over a prompt and over one token."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    b, s = 8, PROMPT_LENS[-1]
    if cfg.family == "mamba2_hybrid":
        di, nh = mamba2.dims(cfg)
        ds = cfg.d_state
        xt, alpha_log = rnd(b, s, nh, mamba2.HEAD_P), -F.softplus(rnd(b, s, nh))
        bm, cm, conv_in = rnd(b, s, ds), rnd(b, s, ds), rnd(b, s, di + 2 * ds)
        blk = params["blocks"][cfg.n_layers // 2]          # a binary block
        x1 = rnd(b, 1, cfg.d_model).to(lc.cdt(cfg))
        cache = mamba2.mamba_init_cache(cfg, b, device=dev)
        return {"ssd_chunked (8, 128)": timer(lambda: mamba2.ssd_chunked(
                    xt, alpha_log, bm, cm, chunk=min(cfg.ssm_chunk, s)), reps=10),
                "_causal_conv (8, 128)": timer(lambda: mamba2._causal_conv(
                    conv_in, blk["conv_w"], blk["conv_b"]), reps=10),
                "mamba_decode, one block (8, 1)": timer(lambda: mamba2.mamba_decode(
                    blk, x1, cfg, cache), reps=10)}
    nh, hd = rwkv6.heads(cfg)
    w = torch.sigmoid(rnd(b, s, cfg.d_model))
    r, k, v, u = rnd(b, s, cfg.d_model), rnd(b, s, cfg.d_model), rnd(b, s, cfg.d_model), \
        rnd(cfg.d_model)
    s0 = torch.zeros((b, nh, hd, hd), device=dev)
    return {"_wkv_scan (8, 128)": timer(lambda: rwkv6._wkv_scan(r, k, v, w, u, nh, hd, s0),
                                        reps=5),
            "_wkv_scan (8, 1)": timer(lambda: rwkv6._wkv_scan(
                r[:, :1], k[:, :1], v[:, :1], w[:, :1], u, nh, hd, s0), reps=10)}


def _recurrent_train_vs_cpu(arch, dev, binary: bool = True) -> dict:
    """The smoke config's loss and grads (f32, latents; ``binary=False``:
    float denses) on the card against the CPU, on the same params and
    batch (seq 40: zamba2's SSD carries a state over two chunks of 32 with
    a ragged tail) -> the loss error, the largest grad error relative to
    its leaf's max-abs and its leaf, the card's launches."""
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = smoke_config(arch).replace(compute_dtype="float32", param_dtype="float32")
    if not binary:
        cfg = cfg.replace(policy=PrecisionPolicy(binary_ffn=False))
    api = get_model(cfg)
    cpu = api.init(SEED, device="cpu", packed=False)
    batch = {k: torch.from_numpy(v)
             for k, v in next(SyntheticTokens(cfg.vocab, 40, 8, seed=SEED)).items()}
    zero_counts()
    got = loss_and_grads(api, tree_map(lambda t: t.to(dev), cpu),
                         {k: v.to(dev) for k, v in batch.items()})
    launches = counts()
    want = loss_and_grads(api, cpu, batch)
    err, worst = -1.0, ""
    for (path, g), (_, w) in zip(tree_leaves_with_path(got[2]), tree_leaves_with_path(want[2])):
        e = float((g.float().cpu() - w.float()).abs().max()) / max(float(w.abs().max()), 1e-30)
        if e > err:
            err, worst = e, path
    return {"binary": binary, "loss_err": abs(float(got[0]) - float(want[0])), "grad_err": err,
            "grad_leaf": worst, "b2_launches": launches["int8_matmul"]}


def _recurrent_model(arch, cut, paths, dev, card, timer) -> tuple[list, list]:
    """One recurrent model at full width, cut to ``cut`` (random init from the
    seed, bf16), served on each path, its empty caches' bytes at 8 slots,
    its sequence mixing timed; the decode parity in f32 (gated with float
    denses at PARITY_REL, printed with the served binary ones); the smoke
    config's loss and grads against the CPU (RECURRENT_TRAIN_TOL) ->
    (rows, launches of each path)."""
    t0 = time.perf_counter()
    cfg = get_config(arch).replace(**cut)
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    n_shared = cfg.n_layers // cfg.attn_every if cfg.family == "mamba2_hybrid" else 0
    params = get_model(cfg).init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS)))
               for _ in range(N_REQUESTS)]
    rows, launches = [], []
    for label in paths:
        api = get_model(cfg.replace(kv_cache=label) if label != "state" else cfg)
        t_path = time.perf_counter()
        row = _recurrent_path(arch, label, api, params, prompts, n_binary, n_shared, card)
        empty = _recurrent_bytes(cfg, api.init_cache(8, 256, device=dev))
        if empty != (STATE_BYTES[arch], POOL_BYTES[label]):
            raise AssertionError(f"{arch} {label}: init_cache(8, 256) holds {empty} bytes")
        row.update(n_layers=cfg.n_layers, d_model=cfg.d_model, binary_blocks=n_binary,
                   shared_calls=n_shared, param_bytes=param_bytes, init_s=init_s,
                   peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   seconds=time.perf_counter() - t_path)
        rows.append(row)
        launches.append(row["launches"])
    t1 = time.perf_counter()
    mixing = _sequence_mixing_ms(cfg, params, dev, timer)
    s = PARITY_S[arch]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (8, s)), device=dev)}
    f32 = cfg.replace(compute_dtype="float32")
    binary = _decode_parity(f"{arch} f32, binary denses", get_model(f32), params, batch, s,
                            cfg.vocab, gate=False)
    del params
    _free(dev)
    f_api = get_model(f32.replace(policy=PrecisionPolicy(binary_ffn=False)))
    f_params = f_api.init(SEED, device=dev)
    parity = _decode_parity(f"{arch} f32, float denses", f_api, f_params, batch, s, cfg.vocab,
                            rel=PARITY_REL[arch], floor=0.0, argmax=False)
    del f_params, f_api
    _free(dev)
    gated = cfg.family == "mamba2_hybrid"       # zamba2's binary smoke config; rwkv6's float
    train = [_recurrent_train_vs_cpu(arch, dev, binary=gated)]
    if not gated:
        train.append(_recurrent_train_vs_cpu(arch, dev))     # printed beside
    for row in rows:
        row.update(decode_parity=parity, decode_parity_bar=PARITY_REL[arch],
                   decode_parity_binary=binary, parity_prompt=s, sequence_mixing_ms=mixing,
                   smoke_train_vs_cpu=train, smoke_train_tol=RECURRENT_TRAIN_TOL[arch],
                   checks_s=time.perf_counter() - t1, model_s=time.perf_counter() - t0)
        log("recurrent", **row)
    tol = RECURRENT_TRAIN_TOL[arch]
    if not (train[0]["grad_err"] <= tol["grad"] and train[0]["loss_err"] <= tol["loss"]):
        raise AssertionError(f"{arch} smoke loss / grads, card vs CPU: {train[0]}")
    if train[-1]["b2_launches"] == 0:
        raise AssertionError(f"{arch} smoke loss: no B2 launch on the card")
    return rows, launches


def phase_recurrent(dev, card: str) -> dict:
    """zamba2-2.7b (bf16 and int8 pools) and rwkv6-3b at full width and
    half depth through the bucket engine, each freed before the next loads
    (module note, 6e) -> {"rows", "launches"}."""
    timer = Timer(dev)
    rows, launches = [], []
    for arch, cut, paths in RECURRENT:
        _free(dev)
        r, ls = _recurrent_model(arch, cut, paths, dev, card, timer)
        rows += r
        launches += ls
    del timer
    _free(dev)
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 6f: tensor-parallel serving, two gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_N = 2
# (label, ServeEngine options, header prompts)
MESH_PATHS = [("mesh bf16", dict(kv_cache="bf16"), False),
              ("mesh int8", dict(kv_cache="int8"), False),
              ("mesh paged int8 + prefix cache", dict(kv_cache="int8", kv_block_size=16,
                                                      prefix_cache=True), True)]
# the trained smoke LM's cells, each held to the single device's tokens
MESH_SMOKE_CELLS = [("bf16", dict(kv_cache="bf16")),
                    ("bf16 paged", dict(kv_cache="bf16", kv_block_size=8)),
                    ("int8", dict(kv_cache="int8")),
                    ("int8 paged", dict(kv_cache="int8", kv_block_size=8))]
MESH_SMOKE_ENGINE = dict(max_batch=2, max_len=64, seed=11)
SMOKE_LM_STEPS = 200
MESH_LOGITS_LAYERS = 4        # the f32 logits check's depth (full width)
MESH_LOGITS_REL = 2e-3        # of the logits' scale: the decode parity bar
MESH_BINARY_BLOCK = 2         # stablelm-3b's first binary block (edge_blocks_float 2)
# (Hq, Hkv, D) of a rank on a mesh of 2: stablelm-3b's and zamba2's shared
# block's 16 of 32 heads of 80 (6f, 6h), the VLM's 16 / 4 of 32 / 8 of 128
MESH_INSERT_SHAPES = [(16, 16, 80), (16, 4, 128)]


def _markov(start: int, n: int, vocab: int) -> list[int]:
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return out


def _smoke_lm(dev):
    """The smoke LM with float FFNs in f32, trained SMOKE_LM_STEPS AdamW
    steps by the port's train step on the synthetic stream (the recipe of
    tests/conftest.py's trained_lm) -> (cfg, params, last loss)."""
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = smoke_config("stablelm-3b").replace(policy=PrecisionPolicy(), compute_dtype="float32",
                                              param_dtype="float32")
    api = get_model(cfg)
    params = api.init(SEED, device=dev, packed=False)
    opt = adamw_init(params)
    step = make_train_step(api, cfg, peak_lr=1e-3, warmup=20, total=SMOKE_LM_STEPS)
    for _, batch in zip(range(SMOKE_LM_STEPS), SyntheticTokens(cfg.vocab, 32, 16, seed=SEED)):
        params, opt, m = step(params, opt, {k: torch.as_tensor(v, device=dev)
                                            for k, v in batch.items()})
    return cfg, params, float(m["loss"])


def _smoke_cells(api, params, prompts, mesh=None) -> dict:
    out = {}
    for label, kw in MESH_SMOKE_CELLS:
        eng = ServeEngine(api, params, mesh=mesh, cuda_graphs=False if mesh is None else None,
                          **MESH_SMOKE_ENGINE, **kw)
        rids = [eng.add_request(p, max_new=8) for p in prompts]
        res = eng.run()
        out[label] = dict(tokens=[res[r] for r in rids], kv_bytes=eng.stats["kv_bytes"],
                          kv_bytes_per_device=eng.stats["kv_bytes_per_device"])
    return out


def _mesh_decode_ms(api, params, prompts, mesh) -> float:
    """Median wall ms of an int8 mesh engine's decode steps (the ticks that
    ran no prefill wave), each ended by a synchronise."""
    eng = ServeEngine(api, params, max_batch=8, max_len=256, mesh=mesh, kv_cache="int8")
    for p in prompts[:8]:
        eng.add_request(p, max_new=MAX_NEW)
    ms, more = [], True
    while more:
        waves = eng.stats["prefills"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        if eng.stats["prefills"] == waves:
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _all_reduce_ms(dev, reps: int = 50) -> float:
    """Wall ms of one gloo all_reduce of a decode step's row-parallel
    partial, (8, 2560) f32 on the card (a device sync, the copy to the host
    and back), over ``reps`` in a row; a decode step makes 2 x 32 of them
    and two more (the embedding, the logits)."""
    import torch.distributed as dist
    x = torch.zeros(8, 2560, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _mesh_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of the mesh phase (module note, 6f), every check that needs
    the ranks' collectives: the smoke LM's cells, stablelm-3b's binary FFN
    block split and whole, its serving paths with their launches and bytes,
    a decode step's time, and the f32 logits at a cut depth. -> plain
    Python values."""
    from repro_torch.distributed.sharding import tensor_parallel
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.tree import tree_map
    dev = rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh((world,), ("model",))
    t0 = time.perf_counter()
    scfg = job["smoke_cfg"]
    sparams = tree_map(lambda t: t.to(dev), torch.load(job["smoke_path"]))
    out = {"rank": rank, "device": str(dev),
           "smoke": _smoke_cells(get_model(scfg), sparams, job["smoke_prompts"], mesh)}
    del sparams

    cfg = get_config("stablelm-3b")
    api = get_model(cfg)
    params = api.init(SEED, device=dev)
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    # a binary FFN block split over the ranks against the same block whole
    tp, rules = specs.mesh_tensor_parallel(cfg, mesh)
    local = specs.shard_params(api, params, mesh, tp, rules)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out["binary_ffn"] = {}
    for case, s in (("decode M 8", 1), ("prefill M 1024", 128)):
        x = torch.randn(8, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
        with tensor_parallel(tp):
            got = lc.ffn_apply(local["blocks"][MESH_BINARY_BLOCK]["ffn"], x, cfg)
        want = lc.ffn_apply(params["blocks"][MESH_BINARY_BLOCK]["ffn"], x, cfg)
        out["binary_ffn"][case] = dict(same_bits=_same_bits(got, want),
                                       max_abs_diff=float((got.float() - want.float())
                                                          .abs().max()))
    # the served bf16 model's prefill logits, split and whole: printed, as
    # the binary FFNs turn the row-parallel sums' rounding into sign flips
    toks = torch.as_tensor(np.stack([np.resize(p, 64) for p in job["prompts"][:8]]), device=dev)
    want, _ = api.prefill(params, {"tokens": toks}, max_len=64)
    with tensor_parallel(tp):
        got, _ = api.prefill(local, {"tokens": toks}, max_len=64)
    v = cfg.vocab
    out["served_logits_rel"] = (float((got[:, :v].float() - want[:, :v].float()).abs().max())
                                / float(want[:, :v].float().abs().max()))
    out["served_first_tokens_equal"] = int((got[:, :v].argmax(-1) == want[:, :v].argmax(-1))
                                           .sum())
    # one decode step on the rank's shard, its all_reduces counted by a
    # wrapper around torch.distributed.all_reduce (the dryrun phase's truth)
    with tensor_parallel(tp):
        caches = api.init_cache(8, 256, dev)
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    with _all_reduces_counted() as stats, torch.no_grad(), tensor_parallel(tp):
        api.decode(local, caches, tok)
    out["decode_all_reduces"] = dict(calls=stats["calls"], bytes=stats["bytes"])
    del local, want, got, caches

    # the serving paths, each counted from 0
    out["paths"] = []
    for label, kw, on_header in MESH_PATHS:
        batch = job["shared"] if on_header else job["prompts"]
        zero_counts()
        ticks = {"calls": 0, "bytes": 0}

        def count_ticks(eng):
            # the bf16 engine's own decode steps, their all_reduces counted
            # by the same wrapper (the dryrun phase holds them to the
            # predicted step times eng.stats["decode_steps"])
            step = eng._step_fn

            def counted():
                with _all_reduces_counted() as stats:
                    out = step()
                ticks["calls"] += stats["calls"]
                ticks["bytes"] += stats["bytes"]
                return out
            eng._step_fn = counted
        toks, wall, eng = _serve_once(api, params, batch, staged=on_header, mesh=mesh,
                                      setup=count_ticks if label == "mesh bf16" else None,
                                      **kw)
        launches = counts()
        _check_outputs(label, toks, cfg.vocab)
        _check_path(label, launches, eng, cfg, n_binary, kw["kv_cache"],
                    1 if kw.get("prefix_cache") else eng.stats["prefills"])
        kv_bytes, per_device = eng.stats["kv_bytes"], eng.stats["kv_bytes_per_device"]
        if not per_device * world == kv_bytes == KV_BYTES[kw["kv_cache"]]:
            raise AssertionError(f"{label}: rank {rank} holds {per_device} of {kv_bytes} pool "
                                 f"bytes, want {KV_BYTES[kw['kv_cache']]} / {world}")
        if kw.get("prefix_cache") and not eng.pool.stats["hits"] > 0:
            raise AssertionError(f"{label}: no prefix hits {eng.pool.stats}")
        if eng.graph is not None:
            raise AssertionError(f"{label}: a mesh engine built a CUDA graph")
        if label == "mesh bf16":
            out["bf16_trees"] = dict(params_bytes=tree_nbytes(eng.params),
                                     cache_bytes=tree_nbytes(eng.caches))
            out["bf16_engine_decode_all_reduces"] = dict(
                ticks, decode_steps=eng.stats["decode_steps"])
        out["paths"].append(dict(path=label, tokens=toks, launches=launches, wall_s=wall,
                                 prefill_waves=eng.stats["prefills"],
                                 decode_steps=eng.stats["decode_steps"], kv_bytes=kv_bytes,
                                 kv_bytes_per_device=per_device,
                                 cached_prompt_tokens=eng.stats["cached_prompt_tokens"]))
        del eng
    out["decode_step_ms_int8"] = _mesh_decode_ms(api, params, job["prompts"], mesh)
    out["all_reduce_ms"] = _all_reduce_ms(dev)
    out["peak_mem_gib_serve"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the mesh prefill's logits in f32 with float FFNs, at a cut depth
    fcfg = cfg.replace(n_layers=MESH_LOGITS_LAYERS, policy=PrecisionPolicy(),
                       compute_dtype="float32", param_dtype="float32")
    fapi = get_model(fcfg)
    fparams = fapi.init(SEED, device=dev)
    toks = torch.as_tensor(np.stack([np.resize(p, 64) for p in job["prompts"][:8]]), device=dev)
    want, _ = fapi.prefill(fparams, {"tokens": toks}, max_len=64)
    ftp, frules = specs.mesh_tensor_parallel(fcfg, mesh)
    flocal = specs.shard_params(fapi, fparams, mesh, ftp, frules)
    with tensor_parallel(ftp):
        got, _ = fapi.prefill(flocal, {"tokens": toks}, max_len=64)
    v = cfg.vocab
    scale = float(want[:, :v].abs().max())
    out["logits_rel"] = float((got[:, :v] - want[:, :v]).abs().max()) / scale
    out["logits_same_argmax"] = bool(torch.equal(got[:, :v].argmax(-1), want[:, :v].argmax(-1)))
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["seconds"] = time.perf_counter() - t0
    del fparams, flocal, want, got
    _free(dev)
    # phase 6g in the same ranks: no second start-up
    t0 = time.perf_counter()
    out["family_smoke"] = {arch: _family_smoke(arch, dev, job["smoke_prompts"], mesh)
                           for arch, *_ in MESH_FAMILIES}
    out["families"] = [_mesh_family(rank, world, mesh, dev, *fam) for fam in MESH_FAMILIES]
    out["families_seconds"] = time.perf_counter() - t0
    # phase 6h in the same ranks
    t0 = time.perf_counter()
    out["families_2"] = [_mesh2_family(rank, world, mesh, dev, *fam) for fam in MESH2_FAMILIES]
    out["families_2_seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 6g: tensor-parallel serving of MLA and MoE, in 6f's ranks
# ---------------------------------------------------------------------------

# (arch, the cut, the pool's exact bytes at 8 x 256 (MLA's compressed cache,
# whole on every rank: SERVED_FAMILIES'), the all_reduces of one decode
# step, the block held to one device). The all_reduces, from the call
# sites: a dense block 2 (wo, the FFN's down product), a MoE block 3 (wo,
# the routed pair rows, the shared experts' down product), the embedding
# and the logits 1 each: minicpm3-4b 62 x 2 + 2, deepseek-v2 x 5 (block 0
# dense, 1..4 MoE) 2 + 4 x 3 + 2. Block 2: minicpm3's first binary FFN
# (edge_blocks_float 2), deepseek-v2's binary MoE block
MESH_FAMILIES = [("minicpm3-4b", {}, 73_138_176, 62 * 2 + 2, 2),
                 ("deepseek-v2-236b", dict(n_layers=5), 11_796_480, 2 + 4 * 3 + 2, 2)]
# the f32 logits check's cuts, full width with float FFNs and experts:
# minicpm3 as 6f's 4 layers, deepseek-v2 a dense and a MoE block (~21 GB of
# f32 params whole)
MESH_FAMILY_LOGITS_LAYERS = {"minicpm3-4b": 4, "deepseek-v2-236b": 2}


def _family_smoke(arch: str, dev, prompts, mesh=None) -> dict:
    """The arch's smoke config in f32 (deepseek at capacity_factor 16, as
    tests/test_torch_mla.py runs it), random init from the seed on this
    card, served as 6f's smoke LM cells are -> tokens and pool bytes."""
    cfg = smoke_config(arch).replace(compute_dtype="float32", param_dtype="float32")
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=16.0)
    api = get_model(cfg)
    eng = ServeEngine(api, api.init(SEED, device=dev), mesh=mesh,
                      cuda_graphs=False if mesh is None else None, **MESH_SMOKE_ENGINE)
    rids = [eng.add_request(p, max_new=8) for p in prompts]
    res = eng.run()
    return dict(tokens=[res[r] for r in rids], kv_bytes=eng.stats["kv_bytes"],
                kv_bytes_per_device=eng.stats["kv_bytes_per_device"])


def _in_turns(rank: int, world: int, fn):
    """fn() on each rank in turn, rank 0 first, the others waiting at a
    barrier: two ranks that each built a whole deepseek-v2 x 5 tree (32 GiB)
    at once and then cut their shards would need more than the card's 80
    GB (a rank keeps only its shard after its turn)."""
    import torch.distributed as dist
    out = None
    for turn in range(world):
        if turn == rank:
            out = fn()
        dist.barrier()
    return out


def _family_block(p: dict, x, cfg):
    """The block checked against one device: a binary FFN (bin_out's int32
    dot summed before its cast) or a MoE layer's routed output (its shared
    experts left out: the pair rows summed exactly)."""
    if "bin_in" in p:
        return lc.ffn_apply(p, x, cfg)
    return moe.moe_apply({k: v for k, v in p.items() if k != "shared"}, x, cfg)[0]


def _park(tree, device):
    """``tree`` with every tensor on ``device``: a built rank's shard waits
    in host memory while the next rank builds its whole tree, so that the
    card holds one whole tree and one shard at most (deepseek-v2 x 5's:
    with rank 0's 16 GiB shard on the card beside rank 1's build, 75 of the
    H100's 79 GiB were in use)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _reckoned_peak(api, mesh, world: int) -> dict:
    """A rank's reckoned peak while it builds in its turn: the whole packed
    tree (FakeTensorMode: no storage) and its own copies of the split
    leaves (the other ranks' shards are parked in host memory meanwhile)."""
    from repro_torch.distributed.sharding import partition_specs
    from repro_torch.launch import specs
    p_abs = specs.abstract_params(api, packed=True)
    _, rules = specs.serving_plan(api.cfg, mesh)
    whole = split = kept = 0
    for t, sp in zip(tree_leaves(p_abs),
                     tree_leaves(partition_specs(p_abs, api.deployed_rules, mesh, rules))):
        n = t.numel() * t.element_size()
        whole += n
        if any(sp):
            split += n // world
        else:
            kept += n
    return {"process_gib": (whole + split) / 2 ** 30, "shard_gib": (kept + split) / 2 ** 30}


def _mesh_family(rank: int, world: int, mesh, dev, arch: str, cut: dict, kv_bytes: int,
                 per_step: int, block: int) -> dict:
    """One model of 6g on this rank (module note): built in turns, served
    on the families phase's 12 requests, counted; the block split against
    the block whole; the f32 logits at a cut depth. -> plain values."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import tensor_parallel
    from repro_torch.launch import specs
    cfg = get_config(arch).replace(**cut)
    api = get_model(cfg)
    label = f"mesh {arch}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    xs = {case: torch.randn(8, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
          for case, s in (("decode M 8", 1), ("prefill M 1024", 128))}
    reckoned = _reckoned_peak(api, mesh, world)

    def build():
        torch.cuda.reset_peak_memory_stats(dev)
        card_free = torch.cuda.mem_get_info(dev)[0]
        t0 = time.perf_counter()
        params = api.init(SEED, device=dev)
        # the block whole before the engine cuts the shard: the block's
        # transients and the shard's copies are never on the card together
        want = {case: _family_block(params["blocks"][block]["ffn"], x, cfg)
                for case, x in xs.items()}
        eng = ServeEngine(api, params, max_batch=8, max_len=256, mesh=mesh)
        torch.cuda.synchronize()
        built = dict(build_s=time.perf_counter() - t0, card_free_gib=card_free / 2 ** 30,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del params
        eng.params = _park(eng.params, "cpu")
        _free(dev)
        return eng, want, built
    t0 = time.perf_counter()
    eng, want, built = _in_turns(rank, world, build)
    eng.params = _park(eng.params, dev)
    turns_s = time.perf_counter() - t0
    out = dict(arch=arch, cut=cut, n_layers=cfg.n_layers, split=dict(
        attn=eng.tp.attn, ffn=eng.tp.ffn, vocab=eng.tp.vocab, experts=eng.tp.experts),
        turns_s=turns_s, reckoned_peak=reckoned, **built)
    # the block split over the ranks against the block whole
    out["block"] = {}
    for case, x in xs.items():
        with tensor_parallel(eng.tp):
            got = _family_block(eng.params["blocks"][block]["ffn"], x, cfg)
        out["block"][case] = dict(same_bits=_same_bits(got, want[case]),
                                  max_abs_diff=float((got.float() - want[case].float())
                                                     .abs().max()))
    # one decode step's all_reduces, by the port's own counter
    with tensor_parallel(eng.tp):
        caches = api.init_cache(8, 256, dev)
    collectives.zero_counts()
    with torch.no_grad(), tensor_parallel(eng.tp):
        api.decode(eng.params, caches, torch.zeros((8, 1), dtype=torch.int32, device=dev))
    one = collectives.counts()["all-reduce"]["model"]
    if one["calls"] != per_step:
        raise AssertionError(f"{label}: a decode step issued {one['calls']} all_reduces, want "
                             f"{per_step}")
    del caches
    # the families phase's 12 requests, counted from 0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS)))
               for _ in range(N_REQUESTS)]
    zero_counts()
    collectives.zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new=MAX_NEW) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    ar = collectives.counts()["all-reduce"]["model"]
    toks = [res[r] for r in rids]
    _check_outputs(label, toks, cfg.vocab)
    n_binary = sum(lc.block_sig(cfg, i).ffn == "binary" and not lc.block_sig(cfg, i).moe
                   for i in range(cfg.n_layers))
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    _check_path(label, launches, eng, cfg, n_binary, "bf16", waves)
    _check_kv_bytes(label, eng, cfg, "bf16", kv_bytes)
    if eng.stats["kv_bytes_per_device"] != kv_bytes:
        raise AssertionError(f"{label}: rank {rank} holds {eng.stats['kv_bytes_per_device']} "
                             f"pool bytes, want the whole pool {kv_bytes}")
    # every prefill wave and decode step issues one step's all_reduces
    if ar["calls"] != per_step * (waves + steps):
        raise AssertionError(f"{label}: {ar['calls']} all_reduces for {waves} waves + {steps} "
                             f"steps, want {per_step} each")
    if eng.graph is not None:
        raise AssertionError(f"{label}: a mesh engine built a CUDA graph")
    n_tok = sum(len(o) for o in toks)
    out.update(tokens=toks, launches=launches, wall_s=wall, tok_per_s=n_tok / wall,
               prefill_waves=waves, decode_steps=steps, kv_bytes=eng.stats["kv_bytes"],
               kv_bytes_per_device=eng.stats["kv_bytes_per_device"],
               decode_step_all_reduces=one, engine_all_reduces=ar,
               params_gib=tree_nbytes(eng.params) / 2 ** 30,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del eng, res
    _free(dev)

    # the f32 logits at a cut depth, float FFNs and experts, split and whole
    fcfg = get_config(arch).replace(n_layers=MESH_FAMILY_LOGITS_LAYERS[arch],
                                    policy=PrecisionPolicy(), compute_dtype="float32",
                                    param_dtype="float32")
    fapi = get_model(fcfg)
    ftoks = torch.as_tensor(np.stack([np.resize(p, 64) for p in prompts[:8]]), device=dev)

    def build_f32():
        fparams = fapi.init(SEED, device=dev)
        fwant = fapi.prefill(fparams, {"tokens": ftoks}, max_len=64)[0]
        ftp, frules = specs.mesh_tensor_parallel(fcfg, mesh)
        flocal = specs.shard_params(fapi, fparams, mesh, ftp, frules)
        del fparams
        _free(dev)
        return ftp, flocal, fwant
    ftp, flocal, fwant = _in_turns(rank, world, build_f32)
    with tensor_parallel(ftp):
        fgot, _ = fapi.prefill(flocal, {"tokens": ftoks}, max_len=64)
    v = cfg.vocab
    out["logits_rel"] = (float((fgot[:, :v] - fwant[:, :v]).abs().max())
                         / float(fwant[:, :v].abs().max()))
    out["logits_same_argmax"] = bool(torch.equal(fgot[:, :v].argmax(-1),
                                                 fwant[:, :v].argmax(-1)))
    out["logits_layers"] = fcfg.n_layers
    del flocal, fwant, fgot
    _free(dev)
    return out


# ---------------------------------------------------------------------------
# phase 6h: the recurrent families, whisper and the VLM on the mesh, in 6f's
# ranks
# ---------------------------------------------------------------------------

# (arch, the cut (depth only), the pool's codec, the f32 logits check's
# depth). zamba2 x 12: two shared invocations, blocks 2..9 binary; the VLM
# x 10: two cross blocks; whisper whole (6 + 6). rwkv6's f32 check is one
# block: its time-mix products round their inputs to bf16 whatever the
# config says (models/rwkv6.py, as repro), so a float c_v's row-parallel
# partials, which round apart from one device's sum in f32, flip some of
# the next block's bf16 roundings, and each flip moves a product by 2^-8 of
# itself. tools/rwkv6_split_rounding.py holds deeper cuts to one device
# that sums c_v as the mesh does, and to the mesh with c_v applied whole
# (PERF.md section 6; the CPU test: tests/test_torch_mesh_families.py)
MESH2_FAMILIES = [("zamba2-2.7b", dict(n_layers=12), "int8", 6),
                  ("rwkv6-3b", dict(n_layers=8), None, 1),
                  ("whisper-base", {}, None, 6),
                  ("llama-3.2-vision-11b", dict(n_layers=10), "int8", 5)]
# the predictions (PERF.md section 6), a rank of 2. All_reduces of one decode
# step, from the call sites: a Mamba2 block 2 (out, gnorm's mean square), a
# shared-block call 2 (wo, the FFN's down product), an RWKV6 block 4 (y and
# g gathered, w_o's columns gathered, c_v, the channel-mix's columns
# gathered), a whisper decoder block 3 (wo, the cross wo, the FFN), a VLM
# self or cross block 2; the embedding and the logits 1 each. A prefill
# issues as many, but whisper's also its encoder's 6 x 2
MESH2_STEP_ALL_REDUCES = {"zamba2-2.7b": 12 * 2 + 2 * 2 + 2, "rwkv6-3b": 8 * 4 + 2,
                          "whisper-base": 6 * 3 + 2, "llama-3.2-vision-11b": 10 * 2 + 2 * 2 + 2}
MESH2_PREFILL_ALL_REDUCES = dict(MESH2_STEP_ALL_REDUCES, **{"whisper-base": 6 * 3 + 6 * 2 + 2})
# a rank's cache bytes at 8 rows x 256: (the recurrent state, or the
# context's: whisper's cross K / V at its 4 of 8 heads, the VLM's patches
# whole; the attention pool at the rank's KV heads). zamba2: h 12 x 8 x 40
# heads x 64 x 64 x 4 + conv 12 x 8 x 3 x (2,560 + 128) x 4; its int8 pool
# 2 calls x 8 x 256 x 2 x 16 x (80 + 2). rwkv6: tm_s 8 x 8 x 20 x 64 x 64 x 4
# + tm_x, cm_x 8 x 8 x 2 x 2,560 x 4. whisper: ek / ev 6 x 2 x 8 x 1,500 x 4 x
# 64 x 2, k / v 6 x 2 x 8 x 256 x 4 x 64 x 2. The VLM: patches 8 x 1,601 x
# 4,096 x 2, its int8 pool 10 x 8 x 256 x 2 x 4 x (128 + 2)
MESH2_CACHE_BYTES = {"zamba2-2.7b": (66_011_136, 10_747_904), "rwkv6-3b": (22_282_240, 0),
                     "whisper-base": (73_728_000, 12_582_912),
                     "llama-3.2-vision-11b": (104_923_136, 21_299_200)}
MESH2_REQUESTS, MESH2_PROMPT_LENS, MESH2_NEW = 8, (16, 48), 8
MESH2_STEPS = 8           # whisper's and the VLM's decodes after the prefill


def _mesh2_cache_bytes(cfg, caches) -> tuple[int, int]:
    """(state or context bytes, attention pool bytes) of a cache tree (the
    keys of MESH2_CACHE_BYTES)."""
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    if cfg.family in ("mamba2_hybrid", "rwkv6"):
        return _recurrent_bytes(cfg, caches)
    if cfg.family == "whisper":
        return (sum(nbytes([c["ek"], c["ev"]]) for c in caches),
                sum(nbytes([c["k"], c["v"]]) for c in caches))
    return nbytes(caches["cross"]), kvc.kv_pool_bytes(caches["self"])


def _mesh2_layer(cfg, params, x, tp=None):
    """The split binary layer held to one device: Mamba2's out of block 2
    over y (the rank's columns where the mixer splits), RWKV6's c_v of
    block 2 over the squared relu (the rank's columns where the FFN
    splits), whisper's decoder FFN 1 and the VLM's FFN 2 (bin_out's int32
    dot summed before its cast)."""
    def cols(t, split):
        if tp is None or not split:
            return t
        n = t.shape[-1] // tp.size
        return t[..., tp.rank * n:(tp.rank + 1) * n].contiguous()
    if cfg.family == "mamba2_hybrid":
        return mamba2.out_proj(params["blocks"][2], cols(x, tp is not None and tp.mixer), cfg)
    if cfg.family == "rwkv6":
        return rwkv6.c_v(params["blocks"][2], cols(x, tp is not None and tp.ffn), cfg)
    blocks = params["dec_blocks"] if cfg.family == "whisper" else params["blocks"]
    return lc.ffn_apply(blocks[1 if cfg.family == "whisper" else 2]["ffn"], x, cfg)


def _mesh2_layer_width(cfg) -> int:
    if cfg.family == "mamba2_hybrid":
        return cfg.expand * cfg.d_model
    return cfg.d_ff if cfg.family == "rwkv6" else cfg.d_model


def _mesh2_family(rank: int, world: int, mesh, dev, arch: str, cut: dict, kv, f32_layers: int
                  ) -> dict:
    """One model of 6h on this rank (module note): built in turns and cut
    to the rank's shard, the binary layer split against whole, one decode
    step's all_reduces, then served (zamba2 and rwkv6 through
    BucketEngine(mesh=), whisper and the VLM by a prefill and MESH2_STEPS
    greedy decodes under scoped_api) with its launches, all_reduces and
    cache bytes exact; last the f32 prefill logits with float denses at
    ``f32_layers``, split against whole. -> plain values."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import scoped_api, tensor_parallel
    from repro_torch.launch import specs
    cfg = get_config(arch).replace(**cut)
    if kv:
        cfg = cfg.replace(kv_cache=kv)
    api = get_model(cfg)
    label = f"mesh {arch}"
    recurrent = cfg.family in ("mamba2_hybrid", "rwkv6")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    width = _mesh2_layer_width(cfg)
    xs = {case: torch.randn(8, s, width, generator=gen, device=dev).to(torch.bfloat16)
          for case, s in (("decode M 8", 1), ("prefill M 1024", 128))}
    if not recurrent:
        batch, _, max_len = _encdec_batch(cfg, dev, np.random.default_rng(SEED), gen)

    def build():
        # the layer whole before the cut; zamba2 and rwkv6 cut through the
        # engine, whisper and the VLM through shard_params
        t0 = time.perf_counter()
        params = api.init(SEED, device=dev)
        _open_gates(params)
        want = {case: _mesh2_layer(cfg, params, x) for case, x in xs.items()}
        tp, rules = specs.mesh_tensor_parallel(cfg, mesh)
        eng = calls = None
        if recurrent:
            calls = _Calls(api)
            eng = BucketEngine(calls.api, params, max_batch=8, max_len=256, mesh=mesh)
            local = eng.params
        else:
            local = specs.shard_params(api, params, mesh, tp, rules)
        torch.cuda.synchronize()
        built = dict(build_s=time.perf_counter() - t0,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del params
        local = _park(local, "cpu")
        _free(dev)
        return tp, local, want, built, eng, calls
    t0 = time.perf_counter()
    tp, local, want, built, eng, calls = _in_turns(rank, world, build)
    local = _park(local, dev)
    if eng is not None:
        eng.params = local
    out = dict(arch=arch, cut=cut, n_layers=cfg.n_layers, kv_cache=cfg.kv_cache,
               split=dict(attn=tp.attn, ffn=tp.ffn, vocab=tp.vocab, mixer=tp.mixer),
               turns_s=time.perf_counter() - t0, **built)
    out["layer"] = {}
    for case, x in xs.items():
        with tensor_parallel(tp):
            got = _mesh2_layer(cfg, local, x, tp)
        out["layer"][case] = dict(same_bits=_same_bits(got, want[case]),
                                  max_abs_diff=float((got.float() - want[case].float())
                                                     .abs().max()))
    sapi = scoped_api(api, tp)
    caches = sapi.init_cache(8, 256, dev)
    out["cache_bytes"] = _mesh2_cache_bytes(cfg, caches)
    whole = api.init_cache(8, 256, "meta")
    out["cache_bytes_per_device"] = kvc.kv_pool_bytes_per_device(
        whole, mesh, specs.mesh_tensor_parallel(cfg, mesh)[1])
    if out["cache_bytes"] != MESH2_CACHE_BYTES[arch] or \
            out["cache_bytes_per_device"] != sum(MESH2_CACHE_BYTES[arch]):
        raise AssertionError(f"{label}: a rank's cache holds {out['cache_bytes']} bytes "
                             f"(per device {out['cache_bytes_per_device']}), want "
                             f"{MESH2_CACHE_BYTES[arch]}")
    collectives.zero_counts()
    with torch.no_grad():
        sapi.decode(local, caches, torch.zeros((8, 1), dtype=torch.int32, device=dev))
    one = collectives.counts()["all-reduce"]["model"]
    if one["calls"] != MESH2_STEP_ALL_REDUCES[arch]:
        raise AssertionError(f"{label}: a decode step issued {one['calls']} all_reduces, want "
                             f"{MESH2_STEP_ALL_REDUCES[arch]}")
    del caches
    zero_counts()
    collectives.zero_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if recurrent:
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, int(rng.choice(MESH2_PROMPT_LENS)))
                   for _ in range(MESH2_REQUESTS)]
        rids = [eng.add_request(p, max_new=MESH2_NEW) for p in prompts]
        res = eng.run()
        toks = [res[r] for r in rids]
        prefills, steps = calls.n["prefill"], calls.n["decode"]
        n_shared = cfg.n_layers // cfg.attn_every if cfg.family == "mamba2_hybrid" else 0
        n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
        want_launches = _recurrent_launches("int8" if kv else "state", calls, n_binary, n_shared)
        row_bytes = {(a // 8, b // 8) for a, b in [MESH2_CACHE_BYTES[arch]]}
        if calls.row_bytes != row_bytes:
            raise AssertionError(f"{label}: the engine's caches hold {calls.row_bytes} bytes a "
                                 f"row, want {row_bytes}")
        ok = all(len(o) == MESH2_NEW and all(0 <= t < cfg.vocab for t in o) for o in toks)
    else:
        with torch.no_grad():
            got, _, _ = _greedy(sapi, local, batch, MESH2_STEPS, max_len)
        toks = got.tolist()
        prefills, steps = 1, MESH2_STEPS
        want_launches = _encdec_launches(cfg, MESH2_STEPS)
        ok = bool(((got >= 0) & (got < cfg.vocab)).all())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = counts()
    ar = collectives.counts()["all-reduce"]["model"]
    if not ok:
        raise AssertionError(f"{label}: bad tokens {toks}")
    if launches != want_launches:
        raise AssertionError(f"{label}: launches {launches}, want {want_launches} for "
                             f"{prefills} prefills + {steps} steps")
    want_ar = MESH2_PREFILL_ALL_REDUCES[arch] * prefills + MESH2_STEP_ALL_REDUCES[arch] * steps
    if ar["calls"] != want_ar:
        raise AssertionError(f"{label}: {ar['calls']} all_reduces for {prefills} prefills + "
                             f"{steps} steps, want {want_ar}")
    n_tok = sum(len(o) for o in toks)
    out.update(tokens=toks, launches=launches, wall_s=wall, tok_per_s=n_tok / wall,
               prefills=prefills, decode_steps=steps, decode_step_all_reduces=one,
               engine_all_reduces=ar, params_gib=tree_nbytes(local) / 2 ** 30,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del local, eng
    _free(dev)

    # the f32 prefill logits with float denses at a cut depth, split and whole
    fcfg = get_config(arch).replace(**({"n_layers": f32_layers}
                                       if cfg.family != "whisper" else {}),
                                    policy=PrecisionPolicy(), compute_dtype="float32",
                                    param_dtype="float32")
    fapi = get_model(fcfg)
    if recurrent:
        fbatch = {"tokens": torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (8, 64)), device=dev)}
    else:
        fbatch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}

    def build_f32():
        fparams = fapi.init(SEED, device=dev)
        _open_gates(fparams)
        fwant = fapi.prefill(fparams, fbatch, max_len=256)[0]
        ftp, frules = specs.mesh_tensor_parallel(fcfg, mesh)
        flocal = specs.shard_params(fapi, fparams, mesh, ftp, frules)
        del fparams
        _free(dev)
        return ftp, flocal, fwant
    ftp, flocal, fwant = _in_turns(rank, world, build_f32)
    with torch.no_grad():
        fgot = scoped_api(fapi, ftp).prefill(flocal, fbatch, max_len=256)[0]
    v = cfg.vocab
    out["logits_rel"] = (float((fgot[:, :v] - fwant[:, :v]).abs().max())
                         / float(fwant[:, :v].abs().max()))
    out["logits_same_argmax"] = bool(torch.equal(fgot[:, :v].argmax(-1), fwant[:, :v].argmax(-1)))
    out["logits_layers"] = fcfg.n_layers
    del flocal, fwant, fgot
    _free(dev)
    return out


def _mesh2_rows(ranks, card: str) -> list[dict]:
    """Phase 6h's gates across the ranks and its lines (the exact counts
    and bytes are gated inside each rank) -> each model's launches, both
    ranks' summed."""
    launches = []
    for i, (arch, *_) in enumerate(MESH2_FAMILIES):
        got = [r["families_2"][i] for r in ranks]
        if any(g["tokens"] != got[0]["tokens"] for g in got):
            raise AssertionError(f"mesh {arch}: the ranks gave other tokens")
        for g, r in zip(got, ranks):
            for case, b in g["layer"].items():
                if not b["same_bits"]:
                    raise AssertionError(f"mesh {arch} layer {case}: rank {r['rank']} differs "
                                         f"from the single device by {b['max_abs_diff']}")
            if not g["logits_rel"] <= MESH_LOGITS_REL:
                raise AssertionError(f"mesh {arch} f32 logits: {g['logits_rel']} of scale")
        n_tok = sum(len(o) for o in got[0]["tokens"])
        log("mesh_families_2", card=card, world=MESH_N, backend="gloo", arch=arch,
            **{k: got[0][k] for k in ("cut", "n_layers", "kv_cache", "split", "prefills",
                                      "decode_steps", "logits_layers")},
            tokens=n_tok, tok_per_s=n_tok / max(g["wall_s"] for g in got),
            predicted=dict(step_all_reduces=MESH2_STEP_ALL_REDUCES[arch],
                           prefill_all_reduces=MESH2_PREFILL_ALL_REDUCES[arch],
                           cache_bytes=MESH2_CACHE_BYTES[arch]),
            **{k: [g[k] for g in got] for k in (
                "launches", "cache_bytes", "cache_bytes_per_device", "decode_step_all_reduces",
                "engine_all_reduces", "layer", "logits_rel", "logits_same_argmax", "wall_s",
                "build_s", "turns_s", "peak_gib", "params_gib", "peak_mem_gib")},
            rank_seconds=[r["families_2_seconds"] for r in ranks])
        launches.append({k: sum(g["launches"][k] for g in got) for k in KERNELS})
    return launches


def _mesh_kernels_shard_heads(dev, gen, timer) -> dict:
    """The insert kernel (B4a / B4c) and kv_decode at a rank's heads on a
    mesh of 2 (MESH_INSERT_SHAPES), against their plain versions on CPU
    copies of the same inputs: the decode insert bit for bit, the decode
    within DECODE_TOL (bf16 q); the insert's time beside its byte bound.
    (B2, B3 and kv_decode at the shard shapes are timed as rows of phases
    3, 4 and 5b.)"""
    out = {}
    lens = torch.tensor([min(n, DECODE_T - 1) for n in DECODE_LENS], dtype=torch.int32,
                        device=dev)
    for hq, hkv, d in MESH_INSERT_SHAPES:
        for kv in ("int8", "binary"):
            label = f"{kv}, {hq} / {hkv} heads of {d}"
            codec = kvc.get_codec(kv)
            cache = codec.init(DECODE_B, DECODE_T, hkv, d, device=dev)
            cache["len"].copy_(lens)
            k, v = (torch.randn(DECODE_B, 1, hkv, d, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            plain = {n: t.cpu() for n, t in cache.items()}
            zero_counts()
            codec.insert_span(cache, k, v)
            codec.insert_span(plain, k.cpu(), v.cpu())
            torch.cuda.synchronize()
            if counts()[f"kv_quant_{kv}"] != 1:
                raise AssertionError(f"{label}: the insert did not launch its kernel once")
            bad = [n for n in cache if not _same_bits(cache[n].cpu(), plain[n])]
            if bad:
                raise AssertionError(f"{label}: the insert kernel differs from plain in {bad}")
            q = torch.randn(DECODE_B, 1, hq, d, generator=gen, device=dev).to(torch.bfloat16)
            got = codec.decode_attention(q, cache)
            want = codec.decode_attention(q.cpu(), plain)
            err = float((got.float().cpu() - want.float()).abs().max())
            if not err <= DECODE_TOL[torch.bfloat16]:
                raise AssertionError(f"{label}: kv_decode vs plain: {err}")
            leaves = {n: t for n, t in cache.items() if n != "len"}
            ms = timer(lambda: kvq.kv_insert(kv, leaves, k, v, lens))
            work = {n: t.clone() for n, t in leaves.items()}
            plain_ms = timer(lambda: kvq.kv_insert_plain(kv, work, k, v, lens), reps=10)
            nbytes, ops = _insert_bytes_ops(kv, DECODE_B * hkv, d, 2, DECODE_B * hkv)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            out[label] = dict(insert_same_bits=True, insert_ms=ms, insert_plain_ms=plain_ms,
                              insert_bound_ms=b_ms, insert_bound_by=b_by,
                              kv_decode_max_abs_err=err)
    return out


def phase_mesh(dev, card: str, serve: dict) -> dict:
    """Tensor-parallel serving on a `model` mesh of two gloo ranks, both on
    this card (module note, 6f) -> {"row", "launches"}."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.mesh import spawn
    from repro_torch.tree import tree_map
    _free(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    kernels_shard = _mesh_kernels_shard_heads(dev, gen, timer)
    del timer
    scfg, sparams, loss = _smoke_lm(dev)
    sprompts = [_markov(3 + i, 7 + (i % 4), scfg.vocab) for i in range(5)]
    single = _smoke_cells(get_model(scfg), sparams, sprompts)
    family_single = {arch: _family_smoke(arch, dev, sprompts) for arch, *_ in MESH_FAMILIES}
    path = OUT_DIR / "mesh" / "smoke_lm.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(tree_map(lambda t: t.cpu(), sparams), path)
    del sparams
    _free(dev)
    job = dict(smoke_cfg=scfg, smoke_path=str(path), smoke_prompts=sprompts,
               prompts=[p.tolist() for p in serve["prompts"]],
               shared=[p.tolist() for p in serve["shared"]])
    parent_gib = torch.cuda.memory_allocated(dev) / 2 ** 30
    t_ranks = time.perf_counter()
    ranks = spawn(_mesh_rank, MESH_N, backend="gloo", args=(job,), timeout=900)
    ranks_s = time.perf_counter() - t_ranks

    for r in ranks:
        for label, _ in MESH_SMOKE_CELLS:
            got, want = r["smoke"][label], single[label]
            if got["tokens"] != want["tokens"]:
                raise AssertionError(f"mesh smoke LM {label}: rank {r['rank']} tokens "
                                     f"{got['tokens']} != the single device's {want['tokens']}")
            if not got["kv_bytes_per_device"] * MESH_N == got["kv_bytes"] == want["kv_bytes"]:
                raise AssertionError(f"mesh smoke LM {label}: bytes {got}")
        for case, b in r["binary_ffn"].items():
            if not b["same_bits"]:
                raise AssertionError(f"mesh binary FFN {case}: rank {r['rank']} differs from "
                                     f"the single device by {b['max_abs_diff']}")
        if not r["logits_rel"] <= MESH_LOGITS_REL:
            raise AssertionError(f"mesh f32 logits: {r['logits_rel']} of scale")
        for p, p0 in zip(r["paths"], ranks[0]["paths"]):
            if p["tokens"] != p0["tokens"]:
                raise AssertionError(f"{p['path']}: ranks gave other tokens")

    # the launcher: --mesh 1 (NCCL, world 1) against the single-device run
    argv = ["--smoke", "--device", "cuda", "--requests", "4", "--prompt-lens", "8,16",
            "--max-new", "8"]
    t_l = time.perf_counter()
    want = serve_launcher.main(argv)
    got = serve_launcher.main(argv + ["--mesh", "1"])
    launcher_s = time.perf_counter() - t_l
    if got != want:
        raise AssertionError(f"launch.serve --mesh 1 gave {got}, without a mesh {want}")

    paths = []
    for i, (label, kw, _) in enumerate(MESH_PATHS):
        p0 = ranks[0]["paths"][i]
        n_tok = sum(len(o) for o in p0["tokens"])
        paths.append(dict(path=label, tokens=n_tok, prefill_waves=p0["prefill_waves"],
                          decode_steps=p0["decode_steps"],
                          launches_per_rank=[r["paths"][i]["launches"] for r in ranks],
                          kv_bytes=p0["kv_bytes"],
                          kv_bytes_per_device=[r["paths"][i]["kv_bytes_per_device"]
                                               for r in ranks],
                          cached_prompt_tokens=p0["cached_prompt_tokens"],
                          wall_s_per_rank=[r["paths"][i]["wall_s"] for r in ranks],
                          tok_per_s=n_tok / max(r["paths"][i]["wall_s"] for r in ranks)))
    row = dict(card=card, world=MESH_N, backend="gloo", devices=[r["device"] for r in ranks],
               arch="stablelm-3b", smoke_lm_loss=loss, smoke_cells=[c for c, _ in
                                                                    MESH_SMOKE_CELLS],
               binary_ffn={r["rank"]: r["binary_ffn"] for r in ranks},
               logits_rel=[r["logits_rel"] for r in ranks],
               logits_same_argmax=[r["logits_same_argmax"] for r in ranks],
               logits_layers=MESH_LOGITS_LAYERS,
               served_logits_rel=[r["served_logits_rel"] for r in ranks],
               served_first_tokens_equal_of_8=[r["served_first_tokens_equal"] for r in ranks],
               kernels_shard_heads=kernels_shard,
               decode_step_ms_int8=[r["decode_step_ms_int8"] for r in ranks],
               all_reduce_ms=[r["all_reduce_ms"] for r in ranks],
               peak_mem_gib_serve=[r["peak_mem_gib_serve"] for r in ranks],
               peak_mem_gib=[r["peak_mem_gib"] for r in ranks],
               rank_seconds=[r["seconds"] for r in ranks], ranks_wall_s=ranks_s,
               parent_mem_gib=parent_gib,
               decode_all_reduces=[r["decode_all_reduces"] for r in ranks],
               bf16_trees=[r["bf16_trees"] for r in ranks],
               bf16_engine_decode_all_reduces=[r["bf16_engine_decode_all_reduces"]
                                               for r in ranks],
               launcher_mesh1_equal=True, launcher_s=launcher_s, paths=paths,
               wall_s=time.perf_counter() - t0)
    log("mesh", **row)
    launches = [{k: sum(r["paths"][i]["launches"][k] for r in ranks) for k in KERNELS}
                for i in range(len(MESH_PATHS))]
    launches += _mesh_families_rows(ranks, card, family_single)
    launches += _mesh2_rows(ranks, card)
    return {"row": row, "launches": launches}


def _mesh_families_rows(ranks, card: str, single: dict) -> list[dict]:
    """Phase 6g's gates across the ranks and its lines (the exact counts
    and bytes are gated inside each rank; ``single``: the smoke configs'
    tokens on one device) -> each model's launches, both ranks' summed."""
    launches = []
    for i, (arch, *_) in enumerate(MESH_FAMILIES):
        for r in ranks:
            got, want = r["family_smoke"][arch], single[arch]
            if got["tokens"] != want["tokens"]:
                raise AssertionError(f"mesh {arch} smoke: rank {r['rank']} tokens "
                                     f"{got['tokens']} != the single device's {want['tokens']}")
            if not got["kv_bytes_per_device"] == got["kv_bytes"] == want["kv_bytes"]:
                raise AssertionError(f"mesh {arch} smoke: bytes {got}, one device {want}")
        got = [r["families"][i] for r in ranks]
        if any(g["tokens"] != got[0]["tokens"] for g in got):
            raise AssertionError(f"mesh {arch}: the ranks gave other tokens")
        for g, r in zip(got, ranks):
            for case, b in g["block"].items():
                if not b["same_bits"]:
                    raise AssertionError(f"mesh {arch} block {case}: rank {r['rank']} differs "
                                         f"from the single device by {b['max_abs_diff']}")
            if not g["logits_rel"] <= MESH_LOGITS_REL:
                raise AssertionError(f"mesh {arch} f32 logits: {g['logits_rel']} of scale")
        n_tok = sum(len(o) for o in got[0]["tokens"])
        log("mesh_families", card=card, world=MESH_N, backend="gloo", arch=arch,
            **{k: got[0][k] for k in ("cut", "n_layers", "split", "prefill_waves",
                                      "decode_steps", "kv_bytes", "logits_layers")},
            tokens=n_tok, tok_per_s=n_tok / max(g["wall_s"] for g in got),
            smoke_tokens_as_single_device=True,
            **{k: [g[k] for g in got] for k in (
                "launches", "kv_bytes_per_device", "decode_step_all_reduces",
                "engine_all_reduces", "block", "logits_rel", "logits_same_argmax", "wall_s",
                "build_s", "turns_s", "card_free_gib", "reckoned_peak", "peak_gib",
                "params_gib",
                "peak_mem_gib")},
            rank_seconds=[r["families_seconds"] for r in ranks])
        launches.append({k: sum(g["launches"][k] for g in got) for k in KERNELS})
    return launches


# ---------------------------------------------------------------------------
# phase 5: KV quantize / dequantize (B4a-d)
# ---------------------------------------------------------------------------

KV_CASES = [  # (name, shape (..., D), dtype): the serving path's, then ragged
    ("decode insert (8, 1, 32, 80), bf16", (8, 1, 32, 80), torch.bfloat16),
    ("prefill encode (8, 128, 32, 80), bf16", (8, 128, 32, 80), torch.bfloat16),
    ("prefill encode (8, 128, 32, 80), f32", (8, 128, 32, 80), torch.float32),
    ("ragged rows (3, 7, 5, 80), bf16", (3, 7, 5, 80), torch.bfloat16),
    ("ragged rows, D 129, f32", (1, 37, 3, 129), torch.float32),
    ("D 16, bf16", (5, 9, 2, 16), torch.bfloat16),
]
F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores (data sheet)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


INSERT_H, INSERT_D = 32, 80        # stablelm-3b's kv heads and head dim
PREFILL_S = 128                    # the serving path's prefill bucket, into max_len 256
FREE_SLOT = 4                      # DECODE_LENS' slot with len 0: all holes when paged
NO_YARDSTICK = "none: no single PyTorch call computes it"


def _random_leaves(kv, nb, t, dev, gen) -> dict:
    """A pool layer's leaves (nb, t, 32 heads, .) of random codes and
    scales, so rows the insert must not touch are told apart from zeros."""
    width = INSERT_D if kv == "int8" else packed_len(INSERT_D)
    lo, hi, dt = (-127, 128, torch.int8) if kv == "int8" else (-2 ** 31, 2 ** 31, torch.int32)

    def codes():
        return torch.randint(lo, hi, (nb, t, INSERT_H, width), generator=gen, device=dev,
                             dtype=dt)

    def scales():
        return torch.rand(nb, t, INSERT_H, generator=gen, device=dev).to(torch.bfloat16)
    return dict(zip(kvq.leaf_names(kv), (codes(), scales(), codes(), scales())))


def _insert_table(dev, gen, span: int = 1):
    """A paged layer's table for DECODE_LENS (block 16): each slot but the
    free one holds its pages up to the one its last token of ``span`` lands
    on, in shuffled blocks, holes past them; the slot at len 256 has every
    page, so its tokens land past the table. -> (table, n_blocks)."""
    n_pages = DECODE_T // PAGE
    used = [0 if i == FREE_SLOT else min((n + span - 1) // PAGE + 1, n_pages)
            for i, n in enumerate(DECODE_LENS)]
    n_blocks = sum(used) + 4
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((DECODE_B, n_pages), n_blocks + 3, dtype=torch.int32)
    for i, u in enumerate(used):
        for p in range(u):
            table[i, p] = perm.pop()
    return table.to(dev), n_blocks


def _insert_before(kv, leaves, k, v, lens, table):
    """The decode insert as it ran before the insert kernel: two quantizer
    launches (the kernel's rows mode stands in for the retired row
    kernel), then the pool's torch scatter and the length bump."""
    quant = getattr(kvq, f"kv_quant_{kv}")
    (kc, ks), (vc, vs) = quant(k), quant(v)
    new = dict(zip(kvq.leaf_names(kv), (kc, ks, vc, vs)))
    if table is None:
        kvq.write_span(leaves, new, lens)
    else:
        kvq.write_paged(leaves, new, lens, table)
    return lens + 1


def _prefill_before(kv, k, v, max_len):
    """The prefill encode as it ran before: two quantizer launches, then
    each leaf zero-padded to max_len."""
    quant = getattr(kvq, f"kv_quant_{kv}")
    (kc, ks), (vc, vs) = quant(k), quant(v)
    return {n: kvq.pad_time(a, max_len) for n, a in zip(kvq.leaf_names(kv), (kc, ks, vc, vs))}


def _insert_bytes_ops(kv, n_rows, d, isz, out_rows) -> tuple[int, int]:
    """Bytes (n_rows of K and of V read, out_rows of codes and scales
    written) and f32 operations (int8 ~4 an element: |x|, max, divide,
    round; binary 2: |x|, add) of one insert."""
    width_b = d if kv == "int8" else 4 * packed_len(d)
    return (2 * n_rows * d * isz + 2 * out_rows * (width_b + 2),
            (4 if kv == "int8" else 2) * 2 * n_rows * d)


def phase_kv_insert(dev, gen, timer) -> dict[str, list]:
    """The insert kernel (B4a, B4c) at the serving shape against its plain
    version, bit for bit: the decode insert on the contiguous and the paged
    pool (the addressed blocks exact; the spare block takes the free slot's
    and the len-256 slot's rows in no set order), every other byte
    unchanged, a second call the same, the paged rows equal to the
    contiguous ones; the prefill encode into the padded cache. Times beside
    the plain version, the path it replaced (before_ms) and the bound."""
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    table, n_blocks = _insert_table(dev, gen)
    n_rows = DECODE_B * INSERT_H
    rows: dict[str, list] = {"kv_quant_int8": [], "kv_quant_binary": []}
    for kv in ("int8", "binary"):
        kname = f"kv_quant_{kv}"
        names = kvq.leaf_names(kv)
        k, v = (torch.randn(DECODE_B, 1, INSERT_H, INSERT_D, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        k[1, 0, 3] = 0.0
        pools = {"contiguous": (_random_leaves(kv, DECODE_B, DECODE_T, dev, gen), None),
                 "paged": (_random_leaves(kv, n_blocks + 1, PAGE, dev, gen), table)}
        written = {}
        for pool, (start, tab) in pools.items():
            label = f"{kv}, {pool} decode insert"
            got, again, want = ({n: a.clone() for n, a in start.items()} for _ in range(3))
            got_lens = kvq.kv_insert(kv, got, k, v, lens, table=tab)
            kvq.kv_insert(kv, again, k, v, lens, table=tab)
            want_lens = kvq.kv_insert_plain(kv, want, k, v, lens, table=tab)
            torch.cuda.synchronize()
            cut = slice(None) if tab is None else slice(0, -1)     # the addressed blocks
            for n in names:
                if not (_same_bits(got[n][cut], want[n][cut]) and
                        _same_bits(again[n][cut], want[n][cut])):
                    raise AssertionError(f"kv_insert differs from plain at {label}, {n}")
            if not torch.equal(got_lens, want_lens):
                raise AssertionError(f"kv_insert's lengths differ at {label}")
            mask = torch.zeros(start[names[1]].shape[:2], dtype=torch.bool, device=dev)
            for i, n in enumerate(DECODE_LENS):
                if tab is None:
                    mask[i, min(n, DECODE_T - 1)] = True
                else:
                    page = n // PAGE
                    blk = int(tab[i, page]) if page < tab.shape[1] else n_blocks
                    mask[min(blk, n_blocks), n % PAGE] = True
            for n in names:
                if not _same_bits(got[n][~mask], start[n][~mask]):
                    raise AssertionError(f"kv_insert wrote outside its rows at {label}, {n}")
            written[pool] = got
            work, work_plain, work_before = ({n: a.clone() for n, a in start.items()}
                                             for _ in range(3))
            ms = timer(lambda: kvq.kv_insert(kv, work, k, v, lens, table=tab))
            plain_ms = timer(lambda: kvq.kv_insert_plain(kv, work_plain, k, v, lens,
                                                          table=tab), reps=10)
            before_ms = timer(lambda: _insert_before(kv, work_before, k, v, lens, tab),
                              reps=10)
            nbytes, ops = _insert_bytes_ops(kv, n_rows, INSERT_D, 2, n_rows)
            nbytes += 8 * DECODE_B + (4 * DECODE_B if tab is not None else 0)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=label, B=DECODE_B, T=DECODE_T, Hkv=INSERT_H, D=INSERT_D,
                       dtype="bfloat16", lens=DECODE_LENS, page=PAGE if tab is not None else None,
                       max_abs_err=0, ms=ms, plain_ms=plain_ms, before_ms=before_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
        for i, n in enumerate(DECODE_LENS):       # the paged pool got the contiguous rows
            page = n // PAGE
            blk = int(table[i, page]) if page < table.shape[1] else n_blocks
            if blk < n_blocks:
                for name in names:
                    if not _same_bits(written["paged"][name][blk, n % PAGE],
                                      written["contiguous"][name][i, n]):
                        raise AssertionError(f"kv_insert: paged differs from contiguous at "
                                             f"{kv}, slot {i}, {name}")
        rows[kname] += _span_insert(kv, lens, dev, gen, timer)
        for dt in (torch.bfloat16, torch.float32):
            label = f"{kv}, prefill encode ({DECODE_B}, {PREFILL_S} -> {DECODE_T}, " \
                    f"{INSERT_H}, {INSERT_D}), {str(dt).split('.')[-1]}"
            kp, vp = (torch.randn(DECODE_B, PREFILL_S, INSERT_H, INSERT_D, generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            kp[2, 5, 7] = 0.0
            got = kvq.kv_prefill(kv, kp, vp, DECODE_T)
            again = kvq.kv_prefill(kv, kp, vp, DECODE_T)
            want = kvq.kv_prefill_plain(kv, kp, vp, DECODE_T)
            torch.cuda.synchronize()
            if not all(_same_bits(got[n], want[n]) and _same_bits(again[n], want[n])
                       for n in names):
                raise AssertionError(f"kv_prefill differs from plain at {label}")
            ms = timer(lambda: kvq.kv_prefill(kv, kp, vp, DECODE_T))
            plain_ms = timer(lambda: kvq.kv_prefill_plain(kv, kp, vp, DECODE_T), reps=10)
            before_ms = timer(lambda: _prefill_before(kv, kp, vp, DECODE_T), reps=10)
            nbytes, ops = _insert_bytes_ops(kv, DECODE_B * PREFILL_S * INSERT_H, INSERT_D,
                                            kp.element_size(), DECODE_B * DECODE_T * INSERT_H)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=label, B=DECODE_B, S=PREFILL_S, max_len=DECODE_T, Hkv=INSERT_H,
                       D=INSERT_D, dtype=str(dt).split(".")[-1], max_abs_err=0, ms=ms,
                       plain_ms=plain_ms, before_ms=before_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
    return rows


SPAN_S = 4            # the speculative verify's span at spec_k = 3


def _span_insert(kv, lens, dev, gen, timer) -> list[dict]:
    """The insert kernel's span mode (the verify's write of k + 1 = 4
    tokens a slot) at the serving shape against its plain version, bit for
    bit, on the contiguous pool (the start clamped to T - S) and a paged
    pool whose slots hold pages up to their span's last token (the slot at
    len 256 runs past the table, the free slot meets holes): every other
    byte unchanged, a second call the same, the paged rows the contiguous
    ones where both address a row; timed beside the plain version and the
    byte bound."""
    names = kvq.leaf_names(kv)
    table, n_blocks = _insert_table(dev, gen, span=SPAN_S)
    k, v = (torch.randn(DECODE_B, SPAN_S, INSERT_H, INSERT_D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    pools = {"contiguous": (_random_leaves(kv, DECODE_B, DECODE_T, dev, gen), None),
             "paged": (_random_leaves(kv, n_blocks + 1, PAGE, dev, gen), table)}
    out, written = [], {}
    n_rows = DECODE_B * SPAN_S * INSERT_H
    for pool, (start, tab) in pools.items():
        label = f"{kv}, {pool} span insert (S {SPAN_S})"
        got, again, want = ({n: a.clone() for n, a in start.items()} for _ in range(3))
        got_lens = kvq.kv_insert(kv, got, k, v, lens, table=tab)
        kvq.kv_insert(kv, again, k, v, lens, table=tab)
        want_lens = kvq.kv_insert_plain(kv, want, k, v, lens, table=tab)
        torch.cuda.synchronize()
        cut = slice(None) if tab is None else slice(0, -1)
        for n in names:
            if not (_same_bits(got[n][cut], want[n][cut]) and
                    _same_bits(again[n][cut], want[n][cut])):
                raise AssertionError(f"kv_insert differs from plain at {label}, {n}")
        if not (torch.equal(got_lens, want_lens) and
                got_lens.tolist() == [n + SPAN_S for n in DECODE_LENS]):
            raise AssertionError(f"kv_insert's lengths differ at {label}")
        mask = torch.zeros(start[names[1]].shape[:2], dtype=torch.bool, device=dev)
        at = {}
        for i, n in enumerate(DECODE_LENS):
            for j in range(SPAN_S):
                if tab is None:
                    mask[i, min(n, DECODE_T - SPAN_S) + j] = True
                    at[i, n + j] = (i, min(n, DECODE_T - SPAN_S) + j)
                else:
                    p = n + j
                    blk = int(tab[i, p // PAGE]) if p // PAGE < tab.shape[1] else n_blocks
                    mask[min(blk, n_blocks), p % PAGE] = True
                    if blk < n_blocks:
                        at[i, p] = (blk, p % PAGE)
        for n in names:
            if not _same_bits(got[n][~mask], start[n][~mask]):
                raise AssertionError(f"kv_insert wrote outside its rows at {label}, {n}")
        written[pool] = (got, at)
        work, work_plain = ({n: a.clone() for n, a in start.items()} for _ in range(2))
        ms = timer(lambda: kvq.kv_insert(kv, work, k, v, lens, table=tab))
        plain_ms = timer(lambda: kvq.kv_insert_plain(kv, work_plain, k, v, lens, table=tab),
                         reps=10)
        nbytes, ops = _insert_bytes_ops(kv, n_rows, INSERT_D, 2, n_rows)
        nbytes += 8 * DECODE_B + (4 * DECODE_B * tab.shape[1] if tab is not None else 0)
        b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
        row = dict(case=label, B=DECODE_B, S=SPAN_S, T=DECODE_T, Hkv=INSERT_H, D=INSERT_D,
                   dtype="bfloat16", lens=DECODE_LENS, page=PAGE if tab is not None else None,
                   max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, library_call=NO_YARDSTICK)
        log(f"kv_quant_{kv}", **row)
        out.append(row)
    (cg, cat_), (pg, pat) = written["contiguous"], written["paged"]
    for (i, p), (blk, off) in pat.items():       # the same rows on both pools
        if DECODE_LENS[i] + SPAN_S <= DECODE_T:          # not clamped on the contiguous pool
            ci, ct = cat_[i, p]
            for n in names:
                if not _same_bits(pg[n][blk, off], cg[n][ci, ct]):
                    raise AssertionError(f"span insert: paged differs from contiguous at "
                                         f"{kv}, slot {i}, position {p}, {n}")
    return out


def phase_kvquant(dev, gen, timer) -> dict[str, list]:
    """The insert kernel at the serving shape (phase_kv_insert), then B4a-d
    as row kernels bit for bit against their plain versions, each case with
    one all-zero row; times beside the bound (bytes: each input read once,
    each output written once, over 3.35 TB/s; the few f32 operations per
    element over 67 TFLOP/s bind less). No single PyTorch call computes any
    of the four, so there is no yardstick."""
    rows: dict[str, list] = {"kv_dequant_int8": [], "kv_dequant_binary": [],
                             **phase_kv_insert(dev, gen, timer)}
    for name, shape, dt in KV_CASES:
        d = shape[-1]
        x = torch.randn(*shape, generator=gen, device=dev).to(dt)
        x.view(-1, d)[1] = 0.0
        n, kp, isz = x.numel() // d, packed_len(d), x.element_size()
        q, s = kvq.kv_quant_int8(x)
        p, ps = kvq.kv_quant_binary(x)
        calls = {  # kernel -> (kernel call, plain call, bytes, f32 operations)
            "kv_quant_int8": (lambda: kvq.kv_quant_int8(x), lambda: kvq.kv_quant_int8_plain(x),
                              n * d * (isz + 1) + 2 * n, 4 * n * d),
            "kv_dequant_int8": (lambda: kvq.kv_dequant_int8(q, s, dtype=torch.float32),
                                lambda: kvq.kv_dequant_int8_plain(q, s, torch.float32),
                                n * d * 5 + 2 * n, n * d),
            "kv_quant_binary": (lambda: kvq.kv_quant_binary(x),
                                lambda: kvq.kv_quant_binary_plain(x),
                                n * d * isz + 4 * n * kp + 2 * n, 2 * n * d),
            "kv_dequant_binary": (lambda: kvq.kv_dequant_binary(p, ps, d, dtype=torch.float32),
                                  lambda: kvq.kv_dequant_binary_plain(p, ps, d, torch.float32),
                                  4 * n * kp + 2 * n + 4 * n * d, n * d),
        }
        for kname, (fn, plain, nbytes, ops) in calls.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(_same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{kname} kernel differs from plain at {name}")
            ms = timer(fn)
            plain_ms = timer(plain, reps=10)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=name if kname.startswith("kv_dequant") else f"rows mode, {name}",
                       rows=n, D=d, dtype=str(dt).split(".")[-1], max_abs_err=0,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5b: dequant-fused decode attention (B4b's and B4d's decode use)
# ---------------------------------------------------------------------------

DECODE_B, DECODE_T, PAGE = 8, 256, 16
DECODE_LENS = [144, 100, 17, 1, 0, 256, 48, 128]   # one free slot (0) and a full one
DECODE_CASES = [  # (name, Hq, Hkv, D, q dtype) at B 8, T 256, S 1
    ("serving (8, 1, 32, 80), bf16 q", 32, 32, 80, torch.bfloat16),
    ("serving, f32 q", 32, 32, 80, torch.float32),
    ("G 4 (Hq 32, Hkv 8), bf16 q", 32, 8, 80, torch.bfloat16),
    ("D 64, bf16 q", 32, 32, 64, torch.bfloat16),
    ("D 128, f32 q", 32, 32, 128, torch.float32),
    ("mesh 2 shard (8, 1, 16, 80), bf16 q", 16, 16, 80, torch.bfloat16),
    # the VLM's self decode on a mesh of 2 (phase 6h): 16 / 4 heads of 128
    ("mesh 2 vlm shard (8, 1, 16 / 4 x 128), bf16 q", 16, 4, 128, torch.bfloat16),
    # the families phase's decode: qwen3-8b (G 4) and qwen2-72b (G 8), D 128
    ("qwen3-8b (8, 1, 32 / 8 x 128), bf16 q", 32, 8, 128, torch.bfloat16),
    ("qwen2-72b (8, 1, 64 / 8 x 128), bf16 q", 64, 8, 128, torch.bfloat16),
]
# f32 q: the kernel and the plain version sum in other orders; bf16 q: the
# output's rounding, tests/test_kvcache.py's fused-decode tolerance
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _decode_pools(kv, hkv, d, lens, dev, gen):
    """One layer's K/V encoded by the codec's quantizer on the contiguous
    pool (B, T, Hkv, .) and on a paged pool (block 16) holding the same
    values in shuffled blocks, with holes (past the pool) at and after each
    slot's ceil(len / 16)-th page. -> (contiguous leaves, paged leaves,
    table), leaves in the wrapper's order (k codes, k_s, v codes, v_s)."""
    quant = kvq.kv_quant_int8 if kv == "int8" else kvq.kv_quant_binary
    k = torch.randn(DECODE_B, DECODE_T, hkv, d, generator=gen, device=dev)
    v = torch.randn(DECODE_B, DECODE_T, hkv, d, generator=gen, device=dev)
    (kc, ks), (vc, vs) = quant(k.to(torch.bfloat16)), quant(v.to(torch.bfloat16))
    cont = [kc, ks, vc, vs]
    used = [-(-n // PAGE) for n in lens]
    n_blocks = sum(used) + 4
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((DECODE_B, DECODE_T // PAGE), n_blocks + 3, dtype=torch.int32)
    paged = [x.new_zeros((n_blocks + 1, PAGE, *x.shape[2:])) for x in cont]
    for i, u in enumerate(used):
        for p in range(u):
            blk = perm.pop()
            table[i, p] = blk
            for dst, src in zip(paged, cont):
                dst[blk] = src[i, p * PAGE:(p + 1) * PAGE]
    return cont, paged, table.to(dev)


def _block_loop_decode(kv, q, leaves, lens, d, table):
    """The decode as it ran before the kv_decode kernel: the plain
    recurrence over kv blocks of 128 (all pages gathered first on the paged
    pool), each block dequantized by a B4b or B4d launch."""
    names = ("k_q", "k_s", "v_q", "v_s") if kv == "int8" else ("k_p", "k_s", "v_p", "v_s")

    def block(blk):
        if kv == "int8":
            return (kvq.kv_dequant_int8(blk["k_q"], blk["k_s"], dtype=torch.float32),
                    kvq.kv_dequant_int8(blk["v_q"], blk["v_s"], dtype=torch.float32))
        return (kvq.kv_dequant_binary(blk["k_p"], blk["k_s"], d, dtype=torch.float32),
                kvq.kv_dequant_binary(blk["v_p"], blk["v_s"], d, dtype=torch.float32))
    return kvd.fused_decode_plain(q, dict(zip(names, leaves)), lens, block, table=table)


def _decode_sdpa(hq, hkv, d, lens, dev, gen, timer) -> float | None:
    """Context, not a yardstick: one SDPA call over a bf16 cache of the same
    lengths (it reads 2x the int8 pool's bytes and dequantizes nothing)."""
    gqa = {} if hq == hkv else {"enable_gqa": True}
    if gqa and not SDPA_GQA:
        return None
    q = torch.randn(DECODE_B, hq, 1, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev).to(torch.bfloat16)
    cols = torch.arange(DECODE_T, device=dev)
    mask = (cols[None, :] < torch.tensor(lens, device=dev)[:, None])[:, None, None, :]
    return timer(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **gqa))


def phase_kv_decode(dev, gen, timer) -> dict[str, list]:
    """The kv_decode kernel (int8 and binary, contiguous and paged) against
    its plain version at the serving shape and at G 4, D 64 and 128, bf16
    and f32 q: rows with len >= 1 within DECODE_TOL, len-0 rows zeros, the
    same bits on a second call and on both pools; times beside the plain
    recurrence, the earlier loop of per-block B4b / B4d launches
    (before_ms) and the bound (the bytes below len, plus q and out, over
    3.35 TB/s; 4 D f32 flops a (query, key) pair bind less)."""
    lens_t = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    live = lens_t > 0
    rows: dict[str, list] = {"kv_decode_int8": [], "kv_decode_binary": []}
    for name, hq, hkv, d, qdt in DECODE_CASES:
        q = torch.randn(DECODE_B, 1, hq, d, generator=gen, device=dev).to(qdt)
        ctx_ms = _decode_sdpa(hq, hkv, d, DECODE_LENS, dev, gen, timer)
        for kv in ("int8", "binary"):
            wrapper = getattr(kvd, f"kv_decode_{kv}")
            plain = getattr(kvd, f"kv_decode_{kv}_plain")
            extra = () if kv == "int8" else (d,)
            cont, paged, table = _decode_pools(kv, hkv, d, DECODE_LENS, dev, gen)
            outs = {}
            for pool, leaves, tab in (("contiguous", cont, None), ("paged", paged, table)):
                call = lambda: wrapper(q, *leaves, lens_t, *extra, table=tab)   # noqa: E731
                got, again = call(), call()
                want = plain(q, *leaves, lens_t, *extra, table=tab)
                torch.cuda.synchronize()
                label = f"{kv}, {pool}, {name}"
                if not _same_bits(got, again):
                    raise AssertionError(f"kv_decode: a second call differs at {label}")
                err = float((got[live].float() - want[live].float()).abs().max())
                if not err <= DECODE_TOL[qdt]:
                    raise AssertionError(f"kv_decode vs plain at {label}: {err}")
                if bool(got[~live].any()):
                    raise AssertionError(f"kv_decode: a len-0 slot is not zeros at {label}")
                outs[pool] = got
                ms = timer(call)
                plain_ms = timer(lambda: plain(q, *leaves, lens_t, *extra, table=tab), reps=10)
                before_ms = timer(lambda: _block_loop_decode(kv, q, leaves, lens_t, d, tab),
                                  reps=10)
                row_b = d + 2 if kv == "int8" else 4 * packed_len(d) + 2
                visible = sum(min(n, DECODE_T) for n in DECODE_LENS)
                nbytes = (2 * visible * hkv * row_b + 2 * q.numel() * q.element_size()
                          + 4 * DECODE_B + (4 * sum(-(-n // PAGE) for n in DECODE_LENS)
                                            if tab is not None else 0))
                b_ms, b_by = bound(nbytes, 4.0 * hq * d * visible, F32_FLOPS)
                row = dict(case=f"{pool}, {name}", codec=kv, pool=pool, B=DECODE_B, T=DECODE_T,
                           Hq=hq, Hkv=hkv, D=d, q_dtype=str(qdt).split(".")[-1],
                           lens=DECODE_LENS, page=PAGE if tab is not None else None,
                           max_abs_err=err, tol=DECODE_TOL[qdt], ms=ms, plain_ms=plain_ms,
                           before_ms=before_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           library_call="none: no single PyTorch call dequantizes and attends",
                           context_sdpa_bf16_ms=ctx_ms,
                           context_call="scaled_dot_product_attention(attn_mask=bool) over a "
                                        "bf16 cache of the same lengths: 2x the int8 bytes, "
                                        "not the same function")
                log("kv_decode", **row)
                rows[f"kv_decode_{kv}"].append(row)
            if not _same_bits(outs["contiguous"], outs["paged"]):
                raise AssertionError(f"kv_decode: paged differs from contiguous at {kv}, {name}")
    for kv in ("int8", "binary"):
        for s in (SPAN_S, *SLICE_S):
            rows[f"kv_decode_{kv}"] += _decode_q_lens(kv, dev, gen, timer, s)
    return rows


SLICE_S = (8, 16)     # an interleaved prefill slice's queries (chunk 8 and 16, G 1)


def _decode_q_lens(kv, dev, gen, timer, s: int) -> list[dict]:
    """kv_decode with per-query lengths at the serving shape (B 8, 32 heads
    of 80, bf16 q; query j of slot b below min(lens[b] + j + 1, T), so the
    free slot's queries see its first positions): S 4 is the verify's, S 8
    and 16 an interleaved prefill slice's. On the contiguous and the paged
    pool: within 2e-2 of the plain version, the same bits on a second call
    and on both pools, one launch per MAX_ROWS query rows (G S = 4 and 8:
    one; 16: two, each query keeping its own length); timed beside the
    plain recurrence, the byte bound and, as context, SDPA over a bf16
    cache with the same per-query masks."""
    hq = hkv = INSERT_H
    d = INSERT_D
    lens_t = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q_lens = torch.clamp(lens_t[:, None] + torch.arange(1, s + 1, device=dev)[None],
                         max=DECODE_T).to(torch.int32)
    q = torch.randn(DECODE_B, s, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    wrapper = getattr(kvd, f"kv_decode_{kv}")
    plain = getattr(kvd, f"kv_decode_{kv}_plain")
    extra = () if kv == "int8" else (d,)
    n_launch = len(kvd.query_chunks(s, hq // hkv))
    visible = [min(n + s, DECODE_T) for n in DECODE_LENS]
    cont, paged, table = _decode_pools(kv, hkv, d, visible, dev, gen)
    sdpa_q = torch.randn(DECODE_B, hq, s, d, generator=gen, device=dev).to(torch.bfloat16)
    sdpa_k, sdpa_v = (torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
    cols = torch.arange(DECODE_T, device=dev)
    mask = (cols[None, None, :] < q_lens[:, :, None])[:, None]        # (B, 1, S, T)
    ctx_ms = timer(lambda: F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v,
                                                          attn_mask=mask))
    out, outs = [], {}
    for pool, leaves, tab in (("contiguous", cont, None), ("paged", paged, table)):
        label = f"{kv}, {pool}, (8, {s}, 32, 80), bf16 q, q_lens"
        before = wrapper.launches
        call = lambda: wrapper(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)  # noqa: E731
        got, again = call(), call()
        want = plain(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)
        torch.cuda.synchronize()
        if wrapper.launches != before + 2 * n_launch:
            raise AssertionError(f"kv_decode with q_lens: {wrapper.launches - before} "
                                 f"launches for 2 calls at {label}")
        if not _same_bits(got, again):
            raise AssertionError(f"kv_decode: a second call differs at {label}")
        err = float((got.float() - want.float()).abs().max())
        if not err <= DECODE_TOL[torch.bfloat16]:
            raise AssertionError(f"kv_decode vs plain at {label}: {err}")
        outs[pool] = got
        ms = timer(call)
        plain_ms = timer(lambda: plain(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens),
                         reps=10)
        row_b = d + 2 if kv == "int8" else 4 * packed_len(d) + 2
        nbytes = (2 * sum(visible) * hkv * row_b + 2 * q.numel() * q.element_size()
                  + 4 * DECODE_B * (1 + s)
                  + (4 * sum(-(-n // PAGE) for n in visible) if tab is not None else 0))
        flops = 4.0 * hq * d * int(q_lens.sum())
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        what = "verify" if s == SPAN_S else "prefill slice"
        row = dict(case=f"{pool}, {what} S {s} with q_lens, bf16 q", codec=kv, pool=pool,
                   B=DECODE_B, S=s, T=DECODE_T, launches_per_call=n_launch, Hq=hq, Hkv=hkv, D=d, q_dtype="bfloat16",
                   lens=DECODE_LENS, page=PAGE if tab is not None else None,
                   max_abs_err=err, tol=DECODE_TOL[torch.bfloat16], ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library_call="none: no single PyTorch call dequantizes and attends",
                   context_sdpa_bf16_ms=ctx_ms,
                   context_call="scaled_dot_product_attention(attn_mask=bool (B, 1, S, T)) "
                                "over a bf16 cache with the same per-query lengths")
        log("kv_decode", **row)
        out.append(row)
    if not _same_bits(outs["contiguous"], outs["paged"]):
        raise AssertionError(f"kv_decode with q_lens: paged differs from contiguous at {kv}")
    return out


# ---------------------------------------------------------------------------
# phase 7: XNOR-popcount GEMM
# ---------------------------------------------------------------------------

XNOR_CASES = [  # (name, M, N, K)
    ("mnist hidden, batch 128 (training)", 128, 1024, 1024),
    ("mnist hidden, batch 1", 1, 1024, 1024),
    ("mnist hidden, batch 256", 256, 1024, 1024),
    ("mnist hidden, batch 512 (eval)", 512, 1024, 1024),
    ("ragged K 40", 8, 24, 40),
    ("ragged K 100", 32, 48, 100),
    ("K 384, Kp 12", 64, 64, 384),
    ("spec draft bin_in", 8, 6912, 2560),
    ("spec draft w_down", 8, 2560, 6912),
]


def phase_xnor(dev, gen, timer) -> list[dict]:
    rows = []
    for name, m, n, k in XNOR_CASES:
        pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        got, want = binary_matmul(pa, pw, k), binary_matmul_plain(pa, pw, k)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"xnor kernel differs from plain at {name}: {err}")
        ms = timer(lambda: binary_matmul(pa, pw, k))
        plain_ms = timer(lambda: binary_matmul_plain(pa, pw, k), reps=10)
        lib_ms, lib_call = int_library(unpack_bits(pa, k, torch.int8), pw, k, want,
                                       timer, name)
        kp = packed_len(k)
        b_ms, b_by = bound(4 * (m * kp + n * kp + m * n), 2.0 * m * n * k, INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_call=lib_call)
        log("xnor", **row)
        rows.append(row)
    return rows


def phase_xnor_splits(dev, gen, timer) -> list[dict]:
    """B1 at each K split it takes (1, 2, 4, 8 chunks of whole stages),
    each exact."""
    from repro_torch.kernels import binary_matmul as bm
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k in XNOR_CASES:
        pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        want = binary_matmul_plain(pa, pw, k)
        units = -(-packed_len(k) // bm.STAGE_WORDS)
        chunks = {s: bm.STAGE_WORDS * -(-units // s) for s in splits_for(units)}
        options = {f"{s} chunks": (lambda kc=kc: bm._launch(pa, pw, k, kc))
                   for s, kc in chunks.items()}
        planned = bm.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"xnor kernel differs from plain at {label}")
        rows.append(_sweep("xnor_split", name, (m, n, k), options,
                           f"{-(-packed_len(k) // planned)} chunks", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 8: fused hybrid dense
# ---------------------------------------------------------------------------

HYBRID_CASES = [  # (name, M, N, K, signed zero)
    ("mnist hidden, batch 256", 256, 1024, 1024, False),
    ("mnist hidden, batch 1", 1, 1024, 1024, False),
    ("mnist hidden, batch 128", 128, 1024, 1024, False),
    ("mnist hidden, batch 512", 512, 1024, 1024, False),
    ("ragged M 77", 77, 1024, 1024, False),
    ("ragged K 100", 32, 64, 100, False),
    ("K 384, Kp 12", 64, 1024, 384, False),
    ("long K 2560 (split)", 8, 1024, 2560, False),
    ("+-0.0 at the sign, batch 256", 256, 1024, 1024, True),
]


def _hybrid_inputs(m, n, k, signed_zero, dev, gen):
    """Packed signs and a scale / shift: random, or +-1 with shift -0.0
    (y = +0.0 / -0.0 where the dot is 0) and -+2 (y = +0.0 where it is 2),
    the second checked to put both zeros in y."""
    pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
    if not signed_zero:
        return (pa, pw, torch.randn(n, generator=gen, device=dev) * 0.1 + 0.5,
                torch.randn(n, generator=gen, device=dev) * 0.1)
    scale = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev).repeat(n // 4)
    shift = torch.tensor([-0.0, -0.0, -2.0, 2.0], device=dev).repeat(n // 4)
    y = binary_matmul_plain(pa, pw, k).float() * scale + shift
    if not (((y == 0) & torch.signbit(y)).any() and ((y == 0) & ~torch.signbit(y)).any()):
        raise AssertionError("the signed-zero case has no +0.0 or no -0.0 in y")
    return pa, pw, scale, shift


def _hybrid_unfused(pa, pw, scale, shift, k):
    """What B5 fuses, step by step: B1's kernel, then the f32 affine, the
    sign and pack_bits in torch."""
    return pack_bits(binary_matmul(pa, pw, k).float() * scale + shift)


def phase_hybrid(dev, gen, timer) -> list[dict]:
    """B5 bit for bit against its plain version at every case, twice; timed
    beside the plain version, the bound, a flushed one-element fill_ (the
    floor of one launch under this timer) and, as context, the unfused
    sequence it stands for (unfused_ms; its words must equal the
    kernel's)."""
    one = torch.zeros(1, device=dev)
    fill_ms = timer(lambda: one.fill_(1.0))
    rows = []
    for name, m, n, k, signed_zero in HYBRID_CASES:
        args = (*_hybrid_inputs(m, n, k, signed_zero, dev, gen), k)
        got, want = hybrid_dense(*args), hybrid_dense_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hybrid_dense kernel differs from plain at {name}: "
                                 f"{int((got != want).sum())} words")
        if not torch.equal(hybrid_dense(*args), got):
            raise AssertionError(f"hybrid_dense: a second call differs at {name}")
        if not torch.equal(_hybrid_unfused(*args), got):
            raise AssertionError(f"hybrid_dense: the unfused sequence differs at {name}")
        ms = timer(lambda: hybrid_dense(*args))
        plain_ms = timer(lambda: hybrid_dense_plain(*args), reps=10)
        unfused_ms = timer(lambda: _hybrid_unfused(*args))
        kp = packed_len(k)
        b_ms, b_by = bound(4 * (m * kp + n * kp + 2 * n + m * n / 32), 2.0 * m * n * k,
                           INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=NO_YARDSTICK,
                   unfused_ms=unfused_ms, fill_ms=fill_ms, over_fill=ms / fill_ms)
        log("hybrid_dense", **row)
        rows.append(row)
    return rows


def phase_hybrid_splits(dev, gen, timer) -> list[dict]:
    """B5 at each K split it takes (1, 2, 4, 8 chunks of whole stages),
    each bit-exact and repeatable, timed beside the plan's pick."""
    from repro_torch.kernels import hybrid_dense as hd
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k, signed_zero in HYBRID_CASES:
        args = (*_hybrid_inputs(m, n, k, signed_zero, dev, gen), k)
        want = hybrid_dense_plain(*args)
        units = -(-packed_len(k) // hd.STAGE_WORDS)
        chunks = {s: hd.STAGE_WORDS * -(-units // s) for s in splits_for(units)}
        options = {f"{s} chunks": (lambda kc=kc: hd._launch(*args, kc))
                   for s, kc in chunks.items()}
        planned = hd.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"hybrid_dense kernel differs from plain at {label}")
        rows.append(_sweep("hybrid_split", name, (m, n, k), options,
                           f"{-(-packed_len(k) // planned)} chunks", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 9: bf16 GEMM
# ---------------------------------------------------------------------------

BF16_CASES = [  # (name, M, N, K, hardtanh)
    ("mnist fc0, batch 256", 256, 1024, 784, False),
    ("mnist fc0, batch 256, hardtanh", 256, 1024, 784, True),
    ("mnist fc3, batch 256", 256, 10, 1024, False),
    ("mnist fc3, batch 256, hardtanh", 256, 10, 1024, True),
    ("256 x 1024 x 512", 256, 512, 1024, False),
    ("256 x 1024 x 512, hardtanh", 256, 512, 1024, True),
    ("mnist fc1 / fc2, batch 256", 256, 1024, 1024, False),
]


def _bf16_library(dev):
    """torch.mm on the bf16 operands, with an f32 output where the installed
    torch takes ``out_dtype`` (its CUDA mm.dtype overload)."""
    x = torch.ones(2, 2, dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except (TypeError, NotImplementedError, RuntimeError):
        return (lambda a, w: torch.mm(a, w)), "torch.mm(bf16, bf16) -> bf16 output"
    return ((lambda a, w: torch.mm(a, w, out_dtype=torch.float32)),
            "torch.mm(bf16, bf16, out_dtype=torch.float32)")


def phase_bf16(dev, gen, timer) -> list[dict]:
    mm, lib_call = _bf16_library(dev)
    rows = []
    for name, m, n, k, ht in BF16_CASES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
        got, want = bf16_matmul(a, w, hardtanh=ht), bf16_matmul_plain(a, w, hardtanh=ht)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=GEMM_TOL, atol=GEMM_TOL):
            raise AssertionError(f"bf16 kernel vs plain at {name}: {err}")
        lib_out = mm(a, w).float()
        if not torch.allclose(lib_out, bf16_matmul_plain(a, w), rtol=GEMM_TOL, atol=GEMM_TOL):
            raise AssertionError(f"{lib_call} vs plain at {name}")
        ms = timer(lambda: bf16_matmul(a, w, hardtanh=ht))
        plain_ms = timer(lambda: bf16_matmul_plain(a, w, hardtanh=ht), reps=10)
        lib_ms = timer(lambda: mm(a, w))
        b_ms, b_by = bound(2 * (m * k + k * n) + 4 * m * n, 2.0 * m * n * k, BF16_FLOPS)
        row = dict(case=name, M=m, N=n, K=k, hardtanh=ht, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_call=lib_call + (" (no clamp)" if ht else ""))
        log("bf16", **row)
        rows.append(row)
    return rows


def phase_bf16_splits(dev, gen, timer) -> list[dict]:
    """B6 at each tile design (LARGE, SMALL) and K split it takes, each
    within GEMM_TOL of the plain version."""
    from repro_torch.kernels import bf16_matmul as bfm
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = {bfm.LARGE: "large", bfm.SMALL: "small"}
    rows = []
    for name, m, n, k, ht in BF16_CASES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
        want = bf16_matmul_plain(a, w, hardtanh=ht)
        units = -(-k // bfm.STAGE_K)
        options = {f"{names[d]}/{s}": (lambda d=d, kc=bfm.STAGE_K * -(-units // s):
                                       bfm._launch(a, w, ht, d, kc))
                   for d in bfm.TILES for s in splits_for(units)}
        design, kchunk = bfm.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.allclose(got, want, rtol=GEMM_TOL, atol=GEMM_TOL):
                raise AssertionError(f"bf16 kernel vs plain at {label}: "
                                     f"{float((got - want).abs().max())}")
        rows.append(_sweep("bf16_split", name, (m, n, k), options,
                           f"{names[design]}/{-(-k // kchunk)}", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 10: the paper's MNIST net (the port's quickstart path)
# ---------------------------------------------------------------------------

MNIST_BATCHES = (1, 256)      # the paper's Table I
INFER_REPS = 200


def _train(hybrid: bool, data, dev) -> tuple[dict, list, float]:
    t0 = time.perf_counter()
    params = H.mlp_init(SEED, hybrid=hybrid, device=dev)
    params, accs = quickstart.train(params, data)
    torch.cuda.synchronize()
    return params, accs, time.perf_counter() - t0


def _infer_ms(fn) -> float:
    """Mean time of one call over INFER_REPS back-to-back calls, warm and
    without an L2 flush: the host's launch time counts, as it does for a
    user calling the model in a loop."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(INFER_REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / INFER_REPS


def phase_mnist(dev, card: str) -> dict:
    data = SyntheticMnist(n_train=2048, n_test=512, seed=SEED)
    xt = torch.from_numpy(data.test[0]).to(dev)
    steps = quickstart.EPOCHS * (len(data.train[0]) // quickstart.BATCH)
    forwards = steps + quickstart.EPOCHS + 1       # + an eval per epoch + packed inference

    # the main path, with the launch counts zeroed just before it: train,
    # pack, packed inference through B1
    zero_counts()
    params, accs, train_s = _train(True, data, dev)
    packed = H.mlp_pack(params)
    logits = H.mlp_apply_packed(packed, xt)
    torch.cuda.synchronize()
    launches = counts()
    if launches != {**{k: 0 for k in KERNELS}, "binary_matmul": 2 * forwards}:
        raise AssertionError(f"hybrid MNIST launches {launches}, {forwards} forwards")
    if not accs[-1] > 0.6:
        raise AssertionError(f"hybrid net test accuracy {accs}")

    zero_counts()
    fparams, faccs, ftrain_s = _train(False, data, dev)
    if any(counts().values()):
        raise AssertionError(f"the float net launched a kernel: {counts()}")
    if not faccs[-1] > 0.6:
        raise AssertionError(f"float net test accuracy {faccs}")

    # exact integer dots through the same f32 BatchNorm: B1, B2 and the
    # eval-with-latents path give the same logits, bit for bit
    logits_int8 = H.mlp_apply_packed(packed, xt, mode="int8")
    logits_latent, _ = H.mlp_apply(params, xt, training=False)
    if not (torch.equal(logits, logits_int8) and torch.equal(logits, logits_latent)):
        raise AssertionError("packed logits through B1, B2 and with latents differ")
    if tuple(logits.shape) != (512, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("packed logits not finite / of the wrong shape")
    packed_acc = float((logits.argmax(-1).cpu() == torch.from_numpy(data.test[1])).float().mean())

    fpacked = H.mlp_pack(fparams)
    infer = {}
    for label, p in (("float", fpacked), ("hybrid", packed)):
        for b in MNIST_BATCHES:
            xb = xt[:b].contiguous()
            ms = _infer_ms(lambda: H.mlp_apply_packed(p, xb))
            infer[f"{label}_b{b}"] = {"ms": ms, "inferences_per_s": b / ms * 1e3}
    row = dict(card=card, dims=list(H.DIMS), train_steps=steps, forwards=forwards,
               launches=launches, hybrid_test_acc=accs, float_test_acc=faccs,
               hybrid_packed_test_acc=packed_acc, hybrid_train_s=train_s,
               float_train_s=ftrain_s, packed_inference=infer,
               weight_bytes={"hybrid": H.weight_memory_bytes(hybrid=True),
                             "float": H.weight_memory_bytes(hybrid=False)})
    log("mnist", **row)
    return row


# ---------------------------------------------------------------------------
# phase 11: train stablelm-3b (the port's LM trainer)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6
TRAIN_ARGV = ["--arch", "stablelm-3b", "--steps", str(TRAIN_STEPS), "--batch", "8",
              "--seq", "128"]
SMOKE_TRAIN = ["--arch", "stablelm-3b", "--smoke", "--batch", "8", "--seq", "32",
               "--lr", "3e-3"]
BINARY_LLM_STEPS = 120


def _binary_blocks(cfg) -> int:
    return sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))


def _train_launches(cfg, steps: int) -> dict[str, int]:
    """A train step's launches: each binary dense's B2 and each block's B3
    once in the forward and, under remat "block" / "full", again in the
    recompute; none in the backward (the STE's f32 products, B3's plain
    recompute); every other kernel 0."""
    k = 2 if cfg.remat in ("block", "full") else 1
    return {**{name: 0 for name in KERNELS}, "int8_matmul": 2 * _binary_blocks(cfg) * k * steps,
            "flash_attention": cfg.n_layers * k * steps}


def _falling(losses) -> bool:
    """tests/test_system.py's bar: the mean of the last 5 losses below 0.7 x
    the mean of the first 5."""
    return bool(np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]))


def _step_vs_cpu(dev) -> dict:
    """One train step of the smoke config in f32 on the card (B2, B3, the
    STE's and B3's backwards, AdamW) against the same step on the CPU
    (their plain versions), on the same params and batch. -> for the
    gradients and for the updated params, the largest error of a leaf
    relative to that leaf's max-abs, and the leaf it is in."""
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    cpu = api.init(SEED, device="cpu", packed=False)
    batch = {k: torch.from_numpy(v)
             for k, v in next(SyntheticTokens(cfg.vocab, 32, 8, seed=SEED)).items()}
    to_dev = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
    step = make_train_step(api, cfg, peak_lr=1e-3, warmup=1, total=10)
    got, want = {}, {}
    for out, tree, b in ((got, to_dev(cpu), to_dev(batch)), (want, cpu, batch)):
        out["grad"] = loss_and_grads(api, tree, b)[2]
        out["param"] = step(tree, adamw_init(tree), b)[0]
    errs = {}
    for what in ("grad", "param"):
        for (path, a), (_, w) in zip(tree_leaves_with_path(got[what]),
                                     tree_leaves_with_path(want[what])):
            err = float((a.float().cpu() - w.float()).abs().max()) / \
                max(float(w.abs().max()), 1e-30)
            if err >= errs.get(what, (-1.0,))[0]:
                errs[what] = (err, path)
    return errs


def _check_step_vs_cpu(dev) -> dict:
    """_step_vs_cpu within TRAIN_TOL, and, to show that the check can
    fail, outside it with TF32 products switched on for one run."""
    errs = _step_vs_cpu(dev)
    for what, (err, path) in errs.items():
        if not err <= TRAIN_TOL[what]:
            raise AssertionError(f"train step card vs CPU: {what} {path} {err}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _step_vs_cpu(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not all(tf32[what][0] > TRAIN_TOL[what] for what in TRAIN_TOL):
        raise AssertionError(f"the card-vs-CPU check passes TF32 products: {tf32}")
    return {"f32": errs, "tf32_on": tf32}


def phase_train(dev, card: str) -> dict:
    """The trainer at full width through launch/train.py (the main path),
    then one step's gradients and profile; one smoke-config step's
    gradients and params on the card against the CPU; the smoke config's
    checkpoint, resume and serve round trip; examples/binary_llm."""
    import gc
    import shutil

    from repro_torch.core.binary_dense import pack_tree
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.examples import binary_llm
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw_init
    from repro_torch.train import checkpoint as C
    from repro_torch.train.step import loss_and_grads, make_train_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the STE's products must run in exact f32")
    cfg = get_config("stablelm-3b")
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)

    # the main path, with the launch counts zeroed just before it and read
    # just after: the launcher trains 6 steps at full width
    zero_counts()
    trees, undo = _first_step_bytes(train_cli)
    t0 = time.perf_counter()
    hist = train_cli.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    launches = counts()
    peak_gib = (torch.cuda.max_memory_allocated(dev) - mem0) / 2 ** 30
    if launches != _train_launches(cfg, TRAIN_STEPS):
        raise AssertionError(f"train launches {launches}, want "
                             f"{_train_launches(cfg, TRAIN_STEPS)}")
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                                           and h["grad_norm"] > 0 for h in hist):
        raise AssertionError(f"train history {hist}")
    step_s = statistics.median(h["step_s"] for h in hist[1:])

    # the launcher's first step again (its params, its first batch): every
    # block's attention weights get a finite, nonzero gradient (through
    # B3's Function), then one step under the profiler
    api = get_model(cfg)
    params = api.init(0, device=dev, packed=False)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticTokens(cfg.vocab, 128, 8, seed=0)).items()}
    loss, _, grads = loss_and_grads(api, params, batch)
    attn_grad_min = min(float(blk["attn"][n]["w"].abs().max()) for blk in grads["blocks"]
                        for n in ("wq", "wk", "wv", "wo"))
    finite = all(bool(torch.isfinite(blk["attn"][n]["w"]).all()) for blk in grads["blocks"]
                 for n in ("wq", "wk", "wv", "wo"))
    if not (finite and attn_grad_min > 0):
        raise AssertionError(f"attention grads: finite {finite}, smallest max-abs "
                             f"{attn_grad_min}")
    latent_grad_min = min(float(blk["ffn"][n]["w_latent"].abs().max()) for blk in grads["blocks"]
                          if "bin_in" in blk["ffn"] for n in ("bin_in", "bin_out"))
    del grads
    step = make_train_step(api, cfg, peak_lr=3e-4, warmup=1, total=TRAIN_STEPS)
    opt = adamw_init(params)
    zero_counts()
    with _trace() as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    one = counts()
    # the wrappers' counts are exact; the trace's kernel events of each
    # family are the counts or one fewer, never one more, as on the eager
    # families and recurrent paths: a trace can drop a record (one B3 event
    # of this step's 64 once)
    events = _device_launches(prof)
    if one != _train_launches(cfg, 1) or not all(
            n - 1 <= events.get(fam, 0) <= n for fam, n in _by_family(one).items()):
        raise AssertionError(f"profiled step: launches {one}, device events {events}")
    prof_row = _profile_summary(prof, prof_wall, step_s)
    for fam in ("int8_matmul (ours)", "flash_attention (ours)"):
        if not prof_row["device_ms_by_family"].get(fam, 0.0) > 0.0:
            raise AssertionError(f"the train step's profile shows no device time for {fam}")
    latent_max = max(float(blk["ffn"][n]["w_latent"].abs().max()) for blk in params["blocks"]
                     if "bin_in" in blk["ffn"] for n in ("bin_in", "bin_out"))
    if not latent_max <= 1.0:
        raise AssertionError(f"a latent left [-1, 1]: {latent_max}")
    del params, opt, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    step_vs_cpu = _check_step_vs_cpu(dev)
    row = dict(card=card, arch=cfg.name, argv=TRAIN_ARGV, remat=cfg.remat,
               binary_blocks=_binary_blocks(cfg), launches=launches,
               launches_per_step=_train_launches(cfg, 1), losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist], step_s=[h["step_s"] for h in hist],
               step_ms_median_2_6=step_s * 1e3, tokens_per_s=8 * 128 / step_s, wall_s=wall,
               peak_mem_gib=peak_gib, trees=trees, first_loss_again=float(loss),
               attn_grad_min_maxabs=attn_grad_min, latent_grad_min_maxabs=latent_grad_min,
               latent_max_after_step=latent_max, smoke_step_vs_cpu_max_rel=step_vs_cpu,
               profile=prof_row)
    log("train", **row)

    # the smoke config: 60 steps with checkpoints, a resume, and the serve
    # launcher on the checkpoint against an engine on the restored params
    scfg = smoke_config("stablelm-3b")
    ck = OUT_DIR / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    runs = []
    for argv, n in ((["--steps", "60", "--ckpt-dir", str(ck), "--ckpt-every", "30"], 60),
                    (["--steps", "3", "--ckpt-dir", str(ck), "--resume"], 3)):
        zero_counts()
        h = train_cli.main(SMOKE_TRAIN + argv)
        runs.append(counts())
        if runs[-1] != _train_launches(scfg, n) or len(h) != n or \
                not all(np.isfinite(x["loss"]) for x in h):
            raise AssertionError(f"smoke train {argv}: launches {runs[-1]}, {len(h)} steps")
        if n == 60:
            smoke_losses = [x["loss"] for x in h]
            smoke_step_ms = 1e3 * statistics.median(x["step_s"] for x in h[1:])
            if not _falling(smoke_losses):
                raise AssertionError(f"smoke losses do not fall: {smoke_losses}")
    _, meta = C.restore(str(ck), 63, {})
    if C.latest_step(str(ck)) != 63 or meta["data_state"]["step"] != 63:
        raise AssertionError(f"resume: latest step {C.latest_step(str(ck))}, meta {meta}")
    sargs = ["--smoke", "--ckpt-dir", str(ck), "--requests", "4", "--prompt-lens", "8,16",
             "--max-new", "8"]
    zero_counts()
    served = serve_cli.main(sargs)
    runs.append(counts())
    sapi = get_model(scfg)
    restored, _ = C.restore(str(ck), 63, {"params": sapi.init(0, device=dev, packed=False)})
    eng = ServeEngine(sapi, pack_tree(restored["params"]), max_batch=8, max_len=16 + 8 + 8)
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.add_request(rng.integers(0, scfg.vocab, int(rng.choice([8, 16]))), max_new=8)
    eng.run()
    if served != dict(eng.results) or not all(len(v) == 8 for v in served.values()):
        raise AssertionError(f"serve --ckpt-dir {served}, engine {dict(eng.results)}")

    # examples/binary_llm: the float baseline and the hybrid LM
    zero_counts()
    bl = binary_llm.main(["--steps", str(BINARY_LLM_STEPS),
                          "--ckpt-dir", str(OUT_DIR / "binary_llm_ckpt")])
    runs.append(counts())
    want = {name: 0 for name in KERNELS}
    for binary in (False, True):
        for k, n in _train_launches(binary_llm.make_cfg(binary), BINARY_LLM_STEPS).items():
            want[k] += n
    if runs[-1] != want:
        raise AssertionError(f"binary_llm launches {runs[-1]}, want {want}")
    for tag, out in bl.items():
        if not _falling([h["loss"] for h in out["history"]]):
            raise AssertionError(f"binary_llm {tag}: losses do not fall")
    smoke_row = dict(card=card, smoke_losses_first_last=[smoke_losses[0], smoke_losses[-1]],
                     smoke_step_ms_median=smoke_step_ms, resume_latest_step=63,
                     served_tokens=sum(len(v) for v in served.values()), launches=runs,
                     binary_llm={tag: dict(params=out["params"],
                                           deployed_bytes=out["deployed_bytes"],
                                           loss_first=out["history"][0]["loss"],
                                           loss_last=out["history"][-1]["loss"],
                                           step_ms_median=1e3 * statistics.median(
                                               h["step_s"] for h in out["history"][1:]))
                                 for tag, out in bl.items()})
    log("train_smoke", **smoke_row)
    return {**row, "smoke": smoke_row, "all_launches": [launches, *runs]}


# ---------------------------------------------------------------------------
# phase 11b: sharded training on two gloo ranks sharing the card
# ---------------------------------------------------------------------------

TRAIN_MESH_STEPS = 4
TRAIN_MESH_N = 2
# lr 3e-3 (the smoke runs'): at the launcher's 3e-4 four steps move a
# random full-width model's loss by less than its step-to-step noise
TP_ARGV = TRAIN_ARGV[:2] + ["--steps", str(TRAIN_MESH_STEPS), "--batch", "8", "--seq", "128",
                            "--lr", "3e-3", "--mesh", "1x2:data,model", "--backend", "gloo"]
DP_LAYERS = 8                 # (b)'s depth cut: blocks 2..5 binary
LOSS_REL = 1e-2               # a mesh's step-0 loss against one device's, bf16
# a mesh's step-0 grad norm against one device's (the card test's bf16 bar):
# AdamW does not see a gradient's scale, so the loss cannot show a
# collective whose backward sums a gradient twice (x N); this can. PR 27's
# runs read 5.4779 on each rank against 5.4628 (2.8e-3)
GNORM_REL = 5e-2


def _counted_all_reduces() -> dict:
    """Count, size and time every torch.distributed.all_reduce from here
    on (a device sync on either side, so a call's ms is its own) ->
    the running totals."""
    import torch.distributed as dist
    stats = {"calls": 0, "bytes": 0, "ms": 0.0}
    real = dist.all_reduce

    def counted(t, *args, **kw):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = real(t, *args, **kw)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        stats["calls"] += 1
        stats["bytes"] += t.numel() * t.element_size()
        return out
    dist.all_reduce = counted
    return stats


@contextlib.contextmanager
def _all_reduces_counted():
    """_counted_all_reduces for the enclosed calls only."""
    import torch.distributed as dist
    real = dist.all_reduce
    try:
        yield _counted_all_reduces()
    finally:
        dist.all_reduce = real


def _first_step_bytes(module) -> tuple[dict, object]:
    """Wrap ``module.make_train_step`` so that the first step it makes
    records the bytes of the params and moments it is given -> (the
    record, a function that undoes the wrap)."""
    make, seen = module.make_train_step, {}

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(params, opt, batch):
            if not seen:
                seen.update(params_bytes=tree_nbytes(params), opt_bytes=tree_nbytes(opt))
            return step(params, opt, batch)
        return run
    module.make_train_step = wrapped
    return seen, lambda: setattr(module, "make_train_step", make)


def _per_step(stats: dict, steps: int) -> dict:
    return {"all_reduces": stats["calls"] / steps, "all_reduce_bytes": stats["bytes"] / steps,
            "all_reduce_ms": stats["ms"] / steps, "all_reduce_calls_total": stats["calls"],
            "all_reduce_bytes_total": stats["bytes"]}


def _train_mesh_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of phase 11b: (a) the launcher's rank function at
    --mesh 1x2, (b) the 8-layer data-parallel cut at 2x1, (c) the two
    syncs on (b)'s gradients."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.optim import adamw_init
    from repro_torch.train.manual_dp import (init_error_feedback, onebit_psum_grads,
                                             onebit_wire_bytes)
    from repro_torch.train.step import loss_and_grads, make_train_step
    dev = rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    out = {"rank": rank, "device": str(dev)}
    stats = _counted_all_reduces()

    # (a) tensor parallel, full width and depth, through the launcher
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    trees, undo = _first_step_bytes(train_cli)
    t0 = time.perf_counter()
    hist = train_cli._mesh_rank(rank, world, TP_ARGV)
    torch.cuda.synchronize()
    undo()
    out["tp"] = dict(losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
                     step_ms=[1e3 * h["step_s"] for h in hist], launches=counts(),
                     peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                     wall_s=time.perf_counter() - t0, trees=trees,
                     **_per_step(stats, TRAIN_MESH_STEPS))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) data parallel at the depth cut, through make_train_step(plan=)
    cfg = get_config("stablelm-3b").replace(n_layers=DP_LAYERS)
    api = get_model(cfg)
    plan = specs.mesh_train_plan(cfg, make_mesh((2, 1), ("data", "model")),
                                 ShapeSpec("dp", 128, 8, "train"))
    params = plan.shard(api, api.init(SEED, device=dev, packed=False))
    opt = adamw_init(params)
    trees = dict(params_bytes=tree_nbytes(params), opt_bytes=tree_nbytes(opt))
    step = make_train_step(api, cfg, peak_lr=3e-4, warmup=1, total=TRAIN_MESH_STEPS, plan=plan)
    data = SyntheticTokens(cfg.vocab, 128, 8, seed=SEED)
    rows = lambda b: {k: torch.from_numpy(plan.dp.rows(v)).to(dev)  # noqa: E731
                      for k, v in b.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats.update(calls=0, bytes=0, ms=0.0)
    losses, grad_norms, step_ms = [], [], []
    for _ in range(TRAIN_MESH_STEPS):
        batch = rows(next(data))
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["dp"] = dict(losses=losses, grad_norms=grad_norms, step_ms=step_ms, launches=counts(),
                     peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30, trees=trees,
                     **_per_step(stats, TRAIN_MESH_STEPS))
    del opt

    # (c) one full-precision and one 1-bit sync of (b)'s gradients
    _, _, grads = loss_and_grads(api, params, rows(next(data)))
    leaves = tree_leaves(grads)
    err = init_error_feedback(grads)
    syncs = {}
    for name, fn, nbytes in (
            ("fp32", lambda: plan.dp.mean([g.to(torch.float32) for g in leaves]),
             4 * sum(g.numel() for g in leaves)),
            ("onebit", lambda: onebit_psum_grads(grads, err, plan.dp.group),
             onebit_wire_bytes(grads))):
        fn()                                  # warm: gloo's buffers, the allocator
        stats.update(calls=0, bytes=0, ms=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        syncs[name] = dict(ms=(time.perf_counter() - t0) * 1e3, bytes=nbytes,
                           all_reduces=stats["calls"], all_reduce_bytes=stats["bytes"],
                           all_reduce_ms=stats["ms"])
        if stats["bytes"] != nbytes:
            raise AssertionError(f"{name} sync handed {stats['bytes']} bytes to all_reduce, "
                                 f"want {nbytes}")
    out["syncs"] = syncs
    out["grad_elements"] = sum(g.numel() for g in leaves)
    return out


def phase_train_mesh(dev, card: str, train: dict) -> dict:
    """Sharded training (module note, 11b) -> {"row", "launches"}."""
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.examples import onebit_dp
    from repro_torch.launch.mesh import spawn
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.train.step import loss_and_grads
    _free(dev)
    t0 = time.perf_counter()
    cfg = get_config("stablelm-3b")
    cut = cfg.replace(n_layers=DP_LAYERS)
    binary = [i for i in range(DP_LAYERS) if cut.policy.block_is_binary(i, DP_LAYERS)]
    if binary != [2, 3, 4, 5]:
        raise AssertionError(f"the depth cut's binary blocks are {binary}")
    # one device's loss and grad norm at the cut, on the global batch
    # (b)'s ranks split
    api = get_model(cut)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticTokens(cut.vocab, 128, 8, seed=SEED)).items()}
    _, metrics, grads = loss_and_grads(api, api.init(SEED, device=dev, packed=False), batch)
    cut_loss = float(metrics["loss"])
    cut_gnorm = float(clip_by_global_norm(grads, 1.0)[1])
    del batch, metrics, grads
    _free(dev)

    t_ranks = time.perf_counter()
    ranks = spawn(_train_mesh_rank, TRAIN_MESH_N, backend="gloo", args=({},), timeout=900)
    ranks_s = time.perf_counter() - t_ranks
    # (c) the example on the card: 4 gloo ranks, fp32 against 1-bit
    t_ex = time.perf_counter()
    example = onebit_dp.main([])
    example_s = time.perf_counter() - t_ex
    single_loss, single_gnorm = train["losses"][0], train["grad_norms"][0]

    def rank_rows(what):
        return [r[what] for r in ranks]
    row = dict(card=card, world=TRAIN_MESH_N, backend="gloo",
               devices=[r["device"] for r in ranks],
               tp=dict(argv=TP_ARGV, shard=dict(heads=16, d_ff=3456, vocab_rows=25216,
                                               bin_in_nk=[3456, 2560], bin_out_nk=[2560, 3456]),
                       single_device_first_loss=single_loss,
                       single_device_first_grad_norm=single_gnorm,
                       launches_per_step=_train_launches(cfg, 1), ranks=rank_rows("tp")),
               dp=dict(layers=DP_LAYERS, binary_blocks=binary, rows_per_rank=4,
                       single_device_loss=cut_loss, single_device_grad_norm=cut_gnorm,
                       launches_per_step=_train_launches(cut, 1),
                       ranks=rank_rows("dp")),
               syncs=[r["syncs"] for r in ranks], grad_elements=ranks[0]["grad_elements"],
               onebit_dp=dict(losses_first_last={k: [v[0], v[-1]] for k, v in example.items()},
                              ranks=4, steps=len(example["1bit+EF"]), wall_s=example_s),
               ranks_wall_s=ranks_s, wall_s=time.perf_counter() - t0)
    log("train_mesh", **row)

    for r in ranks:
        tp, dp = r["tp"], r["dp"]
        if tp["launches"] != _train_launches(cfg, TRAIN_MESH_STEPS):
            raise AssertionError(f"train_mesh (a) rank {r['rank']}: launches {tp['launches']}, "
                                 f"want {_train_launches(cfg, TRAIN_MESH_STEPS)}")
        if dp["launches"] != _train_launches(cut, TRAIN_MESH_STEPS):
            raise AssertionError(f"train_mesh (b) rank {r['rank']}: launches {dp['launches']}, "
                                 f"want {_train_launches(cut, TRAIN_MESH_STEPS)}")
        for tag, losses, want in (("(a)", tp["losses"], single_loss),
                                  ("(b)", dp["losses"], cut_loss)):
            if len(losses) != TRAIN_MESH_STEPS or not np.all(np.isfinite(losses)):
                raise AssertionError(f"train_mesh {tag} rank {r['rank']}: losses {losses}")
            if not abs(losses[0] - want) <= LOSS_REL * abs(want):
                raise AssertionError(f"train_mesh {tag} rank {r['rank']}: step 0 loss "
                                     f"{losses[0]}, one device's {want}")
        for tag, norms, want in (("(a)", tp["grad_norms"], single_gnorm),
                                 ("(b)", dp["grad_norms"], cut_gnorm)):
            if not abs(norms[0] - want) <= GNORM_REL * want:
                raise AssertionError(f"train_mesh {tag} rank {r['rank']}: step 0 grad norm "
                                     f"{norms[0]}, one device's {want}")
        if not tp["losses"][-1] < tp["losses"][0]:
            raise AssertionError(f"train_mesh (a): the loss does not fall {tp['losses']}")
        if tp["losses"] != ranks[0]["tp"]["losses"] or dp["losses"] != ranks[0]["dp"]["losses"]:
            raise AssertionError("train_mesh: the ranks report other losses")
    for name, losses in example.items():
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError(f"onebit_dp {name}: the loss does not fall {losses}")
    launches = [{k: sum(r[what]["launches"][k] for r in ranks) for k in KERNELS}
                for what in ("tp", "dp")]
    return {"row": row, "launches": launches}


# ---------------------------------------------------------------------------
# phase 11c: the dry run's predictions against what the card counted
# ---------------------------------------------------------------------------

def _dryrun_cells() -> dict:
    """name -> (config, shape, (data, model), weights) of each run the dry
    run predicts: 6f's decode step, 11b's (a) and (b), 11's step."""
    cfg = get_config("stablelm-3b")
    train = ShapeSpec("train 8x128", 128, 8, "train")
    return {"mesh_decode": (cfg, ShapeSpec("decode 8x256", 256, 8, "decode"), (1, MESH_N),
                            "packed"),
            "train_tp": (cfg, train, (1, TRAIN_MESH_N), None),
            "train_dp": (cfg.replace(n_layers=DP_LAYERS), train, (TRAIN_MESH_N, 1), None),
            "train": (cfg, train, (1, 1), None)}


def _held(got: dict, label: str, predicted, measured, exact: bool) -> None:
    """Keep (prediction, measurement, ratio) under ``label``; an exact one
    that misses fails the phase."""
    got[label] = dict(predicted=predicted, measured=measured,
                      ratio=predicted / measured if measured else None)
    if exact and predicted != measured:
        raise AssertionError(f"dryrun {label}: predicted {predicted}, measured {measured}")


def phase_dryrun(card: str, mesh: dict, train: dict, train_mesh: dict) -> dict:
    """launch/dryrun.py's predictions (module note, 11c) for the runs of
    phases 6f, 11 and 11b, made here on fake CPU tensors, against what
    those runs counted -> the row."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    t0 = time.perf_counter()
    recs = {name: dryrun.run_cell("stablelm-3b", name, cfg_override=cfg, shape=shape,
                                  mesh=MeshShape(dims, ("data", "model")), weights=weights,
                                  out_dir=OUT_DIR / "dryrun")
            for name, (cfg, shape, dims, weights) in _dryrun_cells().items()}
    dry_s = time.perf_counter() - t0
    bad = {k: r.get("traceback", r.get("reason")) for k, r in recs.items() if r["status"] != "ok"}
    if bad:
        raise AssertionError(f"dry run cells not ok: {bad}")
    got: dict = {}

    def all_reduces(rec):
        a = rec["collectives"]["all-reduce"]
        if rec["collectives"]["total_bytes"] != a["bytes"]:
            raise AssertionError(f"dry run: collectives other than all_reduce {rec}")
        return a["count"], a["payload_bytes"]

    # 6f: one decode step a rank, the bf16 engine's decode steps, its
    # params and pool
    rec = recs["mesh_decode"]
    n, b = all_reduces(rec)
    row = mesh["row"]
    for i, (c, e, trees) in enumerate(zip(row["decode_all_reduces"],
                                          row["bf16_engine_decode_all_reduces"],
                                          row["bf16_trees"])):
        _held(got, f"mesh decode rank {i} all_reduces", n, c["calls"], True)
        _held(got, f"mesh decode rank {i} all_reduce bytes", b, c["bytes"], True)
        steps = e["decode_steps"]
        _held(got, f"mesh engine rank {i} all_reduces ({steps} decode steps)", n * steps,
              e["calls"], True)
        _held(got, f"mesh engine rank {i} all_reduce bytes ({steps} decode steps)", b * steps,
              e["bytes"], True)
        for k in ("params_bytes", "cache_bytes"):
            _held(got, f"mesh decode rank {i} {k}", rec["memory"][k], trees[k], True)
    # 11b (a) and (b): every step's all_reduces; the first step's trees
    for name, what in (("train_tp", "tp"), ("train_dp", "dp")):
        rec = recs[name]
        n, b = all_reduces(rec)
        for i, r in enumerate(train_mesh["row"][what]["ranks"]):
            tag = f"{name} rank {i}"
            _held(got, f"{tag} all_reduces ({TRAIN_MESH_STEPS} steps)", n * TRAIN_MESH_STEPS,
                  r["all_reduce_calls_total"], True)
            _held(got, f"{tag} all_reduce bytes ({TRAIN_MESH_STEPS} steps)",
                  b * TRAIN_MESH_STEPS, r["all_reduce_bytes_total"], True)
            for k in ("params_bytes", "opt_bytes"):
                _held(got, f"{tag} {k}", rec["memory"][k], r["trees"][k], True)
    # 11: the single device's trees
    rec = recs["train"]
    for k in ("params_bytes", "opt_bytes"):
        _held(got, f"train {k}", rec["memory"][k], train["trees"][k], True)
    # printed, not gated: the peak of live bytes beside the allocator's
    # peak, and the analytic roofline terms as shares of the step's time
    # (t_compute / step: the share of the bf16 / int8 peaks the step
    # reaches, what a benchmark would call its MFU)
    gib = 2 ** 30
    tp_ranks = train_mesh["row"]["tp"]["ranks"]
    for name, peak_gib, step_s in (
            ("train", train["peak_mem_gib"], train["step_ms_median_2_6"] / 1e3),
            ("train_tp", max(r["peak_mem_gib"] for r in tp_ranks),
             statistics.median(ms for r in tp_ranks for ms in r["step_ms"][1:]) / 1e3)):
        rec = recs[name]
        _held(got, f"{name} peak GiB", rec["memory"]["peak_bytes"] / gib, peak_gib, False)
        rl = rec["roofline"]
        for term in ("t_compute", "t_memory", "t_collective"):
            _held(got, f"{name} {term} s / step s", rl[term], step_s, False)
    out_row = dict(card=card, held=got, dry_run_s=dry_s,
                   cells={k: dict(mesh=r["mesh"], n_chips=r["n_chips"], split=r["split"],
                                  weights=r["weights"], memory=r["memory"],
                                  collectives={a: r["collectives"][a] for a in
                                               ("all-reduce", "by_axis", "total_bytes")},
                                  flops_counted=r["cost"]["flops_counted"],
                                  analytic=r["analytic"], roofline=r["roofline"],
                                  trace_s=r["trace_s"])
                          for k, r in recs.items()})
    log("dryrun", **out_row)
    return out_row


# ---------------------------------------------------------------------------
# phase 2b: what ptxas and the SASS say about each kernel function
# ---------------------------------------------------------------------------

def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return out if len(out) == len(names) else names


def phase_build_report() -> list[dict]:
    """Per kernel function of each library: registers, stack and spill
    bytes from ptxas (-Xptxas=-v output kept in build/kernels/<name>.log),
    and its tensor-core instructions (SASS opcodes ending in MMA: IMMA,
    HMMA, and IGMMA / HGMMA for wgmma) counted by opcode in cuobjdump -sass
    (None where the toolkit has no cuobjdump)."""
    import re
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    rows = []
    for src in SOURCES:
        log_text = (build.BUILD_DIR / f"{src}.log").read_text()
        funcs: dict[str, dict] = {}
        cur = None
        for line in log_text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = funcs.setdefault(m.group(1), {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        sass: dict[str, dict] | None = None
        if cuobjdump.exists():
            text = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(src))],
                                  capture_output=True, text=True, check=True).stdout
            sass, fn = {}, None
            for line in text.splitlines():
                m = re.search(r"Function : (\w+)", line)
                if m:
                    fn = sass.setdefault(m.group(1), {})
                    continue
                # an instruction line: /*addr*/ [@predicate] OPCODE.modifiers ...
                m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
                if m and m.group(1).endswith("MMA") and fn is not None:
                    fn[m.group(1)] = fn.get(m.group(1), 0) + 1
        for mangled, name in zip(funcs, _demangle(list(funcs))):
            if name.endswith(")"):          # drop the parameter list
                name = name[:name.rfind("(")]
            name = name.replace("(anonymous namespace)::", "")
            row = dict(source=f"src/repro_torch/csrc/{src}.cu", function=name,
                       **funcs[mangled],
                       tensor_core_ops=None if sass is None else sass.get(mangled, {}))
            log("kernel_build", **row)
            rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", torch_name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    build.build_all(SOURCES)
    log("build", seconds=time.perf_counter() - t0, dir=str(build.BUILD_DIR))
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    # B2's two designs, B3's bf16 instantiations, B1 and B5 (b1 BMMA) and
    # B6's two designs (HGMMA, HMMA) run on the tensor cores: each
    # function's SASS must hold its opcode
    build_rows = phase_build_report()
    for sym, kind in (("int8_matmul_mma_kernel", "IMMA"), ("int8_matmul_wgmma_kernel", "IGMMA"),
                      ("flash_fwd_mma_kernel", "HMMA"), ("binary_matmul_mma_kernel", "BMMA"),
                      ("hybrid_dense_mma_kernel", "BMMA"),
                      ("bf16_matmul_wgmma_kernel", "HGMMA"), ("bf16_matmul_mma_kernel", "HMMA")):
        counted = [r["tensor_core_ops"] for r in build_rows if sym in r["function"]]
        if not counted:
            raise AssertionError(f"no {sym} in the build logs")
        if any(c is not None and kind not in c for c in counted):
            raise AssertionError(f"{sym}: no {kind} instruction in its SASS: {counted}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    int8_rows = timed("int8", phase_int8, dev, gen, timer)
    timed("int8_splits", phase_int8_splits, dev, gen, timer)
    flash_rows = timed("flash", phase_flash, dev, gen, timer)
    kv_rows = timed("kv_quant", phase_kvquant, dev, gen, timer)
    decode_rows = timed("kv_decode", phase_kv_decode, dev, gen, timer)
    serve = timed("serve (spec and interleave inside)", phase_serve, dev, smi)
    families = timed("families", phase_families, dev, smi)
    recurrent = timed("recurrent", phase_recurrent, dev, smi)
    mesh = timed("mesh", phase_mesh, dev, smi, serve)
    xnor_rows = timed("xnor", phase_xnor, dev, gen, timer)
    timed("xnor_splits", phase_xnor_splits, dev, gen, timer)
    hybrid_rows = timed("hybrid_dense", phase_hybrid, dev, gen, timer)
    timed("hybrid_splits", phase_hybrid_splits, dev, gen, timer)
    bf16_rows = timed("bf16", phase_bf16, dev, gen, timer)
    timed("bf16_splits", phase_bf16_splits, dev, gen, timer)
    del timer
    mnist = timed("mnist", phase_mnist, dev, smi)
    train = timed("train", phase_train, dev, smi)
    train_mesh = timed("train_mesh", phase_train_mesh, dev, smi, train)
    timed("dryrun", phase_dryrun, smi, mesh, train, train_mesh)
    log("phase_seconds", **PHASE_SECONDS, total=time.perf_counter() - t0)

    # launches on every path: the serving paths (bf16, int8, binary, paged
    # int8 with the prefix cache, int8 sampled), the families phase's paths
    # (MLA's among them), the recurrent phase's, the speculative paths, the
    # MNIST net and the mesh paths (both ranks' counts), each counted from 0
    path_launches = [serve["launches"], mnist["launches"], *families["launches"],
                     *recurrent["launches"],
                     *(p["launches"] for p in serve["paths"]),
                     serve["spec"]["plain_sampled"]["launches"],
                     *(p["launches"] for p in serve["spec"]["paths"]),
                     *serve["interleave"]["launches"], *train["all_launches"],
                     *mesh["launches"], *train_mesh["launches"]]

    def entry(kname, source, replaces, rows):
        # the headline case is the first: decode bin_in, full-length flash,
        # the decode insert, the MNIST hidden layer at the training batch,
        # at batch 256, fc0
        head = rows[0]
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(pl[kname] for pl in path_launches),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "library_call": head["library_call"],
                "case": head["case"],
                "cases": rows}

    kernels = {"kernels": [
        entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
              "src/repro/kernels/int8_matmul.py:55", int8_rows),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:118", flash_rows),
        entry("binary_matmul", "src/repro_torch/csrc/binary_matmul.cu",
              "src/repro/kernels/binary_matmul.py:69", xnor_rows),
        entry("hybrid_dense", "src/repro_torch/csrc/hybrid_dense.cu",
              "src/repro/kernels/hybrid_dense.py:54", hybrid_rows),
        entry("bf16_matmul", "src/repro_torch/csrc/bf16_matmul.cu",
              "src/repro/kernels/bf16_matmul.py:42", bf16_rows),
        *(entry(k, "src/repro_torch/csrc/kv_quant.cu", f"src/repro/kernels/kv_quant.py:{line}",
                kv_rows[k])
          for k, line in (("kv_quant_int8", 161), ("kv_dequant_int8", 179),
                          ("kv_quant_binary", 195), ("kv_dequant_binary", 211))),
        *(entry(k, "src/repro_torch/csrc/kv_decode.cu",
                f"src/repro/kernels/kv_quant.py:{line} (decode use, "
                "src/repro/serving/kvcache.py:282, :696)", decode_rows[k])
          for k, line in (("kv_decode_int8", 179), ("kv_decode_binary", 211))),
    ]}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({**RECORD, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
