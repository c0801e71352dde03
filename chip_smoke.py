#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one JSON line each; any failure exits non-zero:
  device   the card (nvidia-smi name and power limit), torch/CUDA versions,
           and the kernels' build from dnet_tpu_torch/csrc (nvcc, sm_90a).
  ptxas    the decode, prefill and paged kernels' instantiations as `nvcc
           -Xptxas -v` reports them (registers, spill stores / loads, stack),
           each with its dynamic shared memory, and how many spill;
           compiled beside the build.  A bf16 (tensor-core) prefill, a bf16
           paged or a tensor-core decode / paged instantiation that spills,
           or a decode instantiation of 8 rows a block at head dim 128
           (which spilled; no dispatch reaches it), fails the run.
  kernels  each hand-written kernel against its plain PyTorch version at
           the main path's full widths (Llama-3.2-1B: H=32, KVH=8, D=64,
           S=4096): f32 within 1e-4; bf16 within 2e-2 of the plain version
           computed in f32 from the same bf16 inputs (the kernel rounds its
           output to bf16, ~4e-3 at |x| ~ 1, and sums in another order).
           Times (CUDA events), the plain version's and one PyTorch
           library call's (scaled_dot_product_attention, a yardstick the
           port never calls), and each call's bound on an H100 SXM; prefill
           rows add times_library = kernel_ms / library_ms (SDPA with the
           causal mask as a tensor, which every pos allows) and, at pos 0,
           library_causal_ms (SDPA with is_causal=True: its flash backend).
  wide_prefill  the prefill kernel at head width 128 (Llama-3-8B's H=32,
           KVH=8), T=512 and 2048, bf16 and f32, against its plain version
           under the same tolerances, timed beside both SDPA forms and its
           bound.
  parity   a small model served by the engine on the GPU (kernels) and on
           the CPU (plain versions) from the same weights: prefill logits
           within 2e-3, equal 16-token greedy streams.
  step     one full-width greedy decode step: its synchronised wall time,
           the host's time to issue it, the device's busy time (profiler),
           the attention kernels' share, and the step's bound (its weights
           read once); over a bf16 and an int8 KV cache, in turns.
  serve    full-width Llama-3.2-1B with synthetic bf16 weights from a seed,
           written as a checkpoint and served by the port's HTTP server on
           loopback: a greedy chat completion, a seeded sampled one, and
           the greedy request streamed (equal content; its TTFT and decode
           rate); every attention call on that path must
           have gone through the kernels.
Continuous batching over the paged KV pool (DNET_KV_PAGED=1
DNET_KV_RAGGED=1), the second path:
  paged_launches  device kernels per paged_attend call (torch.profiler,
               right after the build): must be 1, at the plan's budget of
               blocks and at the cap of 16 a slot.
  kernels      the ragged paged-attention kernel against its plain version
               at full width: 8 slots reading a pool of 2048 16-token blocks
               per layer x 16 layers through shuffled page tables, at the
               batch_serve mix of positions and at a ragged mix up to 4094;
               SDPA on a pre-gathered contiguous copy as the library call
               (times_library); the batch_serve mix's bf16 row also times
               every budget of 1 to 16 blocks a slot (kernel_ms_by_split).
  batch_parity the batched engine (4 slots, 8-token blocks) on the GPU and
               on the CPU from the same f32 weights: four ragged prompts
               decoded together, by single steps and by an 8-step chunk;
               equal greedy streams, logprobs within 2e-3.
  batch_step   one batched decode step at 8 active lanes: wall, host issue,
               device busy (profiler) and the paged kernel's share.
  batch_serve  the same synthetic checkpoint served with --batch-slots 8: 8
               concurrent streamed requests (prompts of ~27 to 1,500 tokens,
               64 tokens each, one sampled with a seed); the paged kernel
               runs 16 times per decode step, the single-sequence decode
               kernel never, the prefill kernel 16 times per prompt chunk.
The iteration-level scheduler (DNET_SCHED=1) with the paged prefix cache,
over the same slots:
  sched_parity the scheduler in process on the GPU and on the CPU from the
               same f32 weights (head dim 64): four concurrent greedy
               requests over 4 slots and a pool of 26 16-token blocks that
               holds their prompts but not their growth; a preemption on
               each device, equal texts.
  sched_serve  the batch_serve checkpoint behind DNET_SCHED=1: the
               batch_serve burst (decode lanes and prefill tokens per tick
               from GET /v1/debug/sched, lane tokens per decode step beside
               the legacy adapter's), then a two-turn conversation (a
               512-token prompt, then its prompt and answer plus a new
               message); the two turns again with DNET_API_PREFIX_CACHE=4
               (turn 2 prefills fewer tokens than its prompt, both texts
               equal); the burst over a pool of 300 blocks (a preemption,
               every request 64 tokens).  The paged kernel runs 16 times per
               decode forward step and the prefill kernel 16 times per
               prefill segment the tick records count.
The pipelined shard ring, the third path (API node + two shard processes
over gRPC, the qsparse8 hop codec):
  column_launches  device kernels per column_topk call and per call of the
               chain it replaced (torch.profiler, right after the build):
               column_topk must be 1, at R = 1 and 1500.
  kernels      the codec's three column kernels against their plain versions
               at the hop's widths (C=2048, K=1024 kept, gs=64; R=1, a decode
               hop, and R=1500, a prompt frame; bf16 and f32): norms within
               2e-5 relative, gather and dequant-scatter equal bit for bit;
               the norms kernel with its selection on (column_topk: one
               device kernel a call, its kept columns and bitmask equal
               topk_columns of its own norms, repeatable), beside the chain
               it replaced (the norms, then sorts: sort_chain_ms); library
               yardsticks torch.linalg.vector_norm (+ torch.topk and a sort),
               index_select and index_copy_ (on a pre-dequantized copy).
  codec        one hop's whole encode and decode (qsparse8 and lossless) at
               R=1 and R=1500: host wall time per call and its device work;
               the qsparse8 encode also as its select ran before column_topk
               (qsparse8_encode_sort_chain), with an equal payload.
  ring_serve   the serve phase's checkpoint served by two
               `dnet_tpu_torch.cli.shard` processes on the card (layers 0-7 and
               8-15) behind the port's API node with a hostfile on 127.0.0.1:
               lossless, the serve phase's requests, whose greedy and seeded
               sampled text must equal the serve phase's; qsparse8
               (DNET_WIRE_CODEC=qsparse8, pct 0.5, gs 64), the same plus a
               1,500-token prompt.  Every request returns 64 tokens; each
               shard's /health must show the column kernels launched once per
               hidden frame encoded (s0) or decoded (s1), and the attention
               kernels once per layer per step.  Per-frame host times on
               each shard are read after a warm-up request.
The quantized KV cache (DNET_KV_BITS=8|4), the fourth path, on the single
sequence, dense batched slots and the ring's shards:
  kernels       the decode kernel's q8 and q4 variants at the serve mix (B=1,
                S=4096, G=4, bf16 q at pos 0, 255, 4095 and the serve
                phase's last position; f32 q there too) on caches the port's
                write_kv quantized, against the plain version on the same
                codes (the plain decode's tolerances); the plain kernel with a
                lengths vector at the batch_serve lanes' positions, with bf16
                and f32 q, and with an f32 q over a bf16 cache (as the paged
                kernel over a bf16 pool: DNET_KV_BITS=16 on an f32 model);
                library yardstick SDPA on a dequantized bf16 copy (dequant not
                timed).
  quant_parity  q8, q4 and a bf16 cache under f32 params (DNET_KV_BITS=16):
                the single-sequence engine and dense batched slots (and, for
                the bf16 cache, paged + ragged slots) on the GPU against the
                CPU, as parity and batch_parity.
  quant_serve   DNET_KV_BITS=8 and =4 with the serve phase's requests, then
                DNET_KV_BITS=8 --batch-slots 8 over dense slots with the
                batch_serve burst: the q8 / q4 decode kernel 16 times per
                decode step, no other decode kernel, and the allocated KV
                bytes equal to cache_nbytes (71,303,168 B q8 and 37,748,736 B
                q4 per sequence; 8x over 8 slots).
  ring_serve    a third pass, lossless with kv_bits 8 in the topology: the
                greedy, streamed and seeded sampled requests, whose text must
                equal quant_serve's q8 run's, and
                each shard's q8 decode kernel once per layer per step.
gpt-oss-20b (MoE, sinks, YaRN, alternating sliding/full layers), the fifth
path, on the single-sequence engine:
  kernels         the decode kernel's rotating variant at its widths (B=1, a
                  ring of W=128 slots, H=64, KVH=8, D=64, sinks) at pos 0,
                  127, 128, 300 and 4095: f32 and bf16 rings, q8 / q4 rings
                  the port's write_kv_rotating filled (bf16 q), one bf16 row
                  with a window of 91; library yardstick SDPA over the
                  attended slots in position order with the sink as an extra
                  key column.
  gpt_oss_parity  a small gpt_oss (4 layers, head dim 64, G=8, W=32, 4
                  experts top-2, f32) on the GPU against the CPU: prefill
                  logits within 2e-3 and 48 equal greedy tokens past two
                  wraps, over an f32, an int8 and a packed int4 cache (the
                  rotating q8 / q4 forms' launches in the kernels line).
  gpt_oss_step    one full-width greedy decode step of all 24 layers (random
                  bf16 params made on the card, ~41.8 GB, dense MoE as the
                  reference's default) at pos ~300: wall, host issue, device
                  busy, the attention kernels' share, launches, the bound.
  gpt_oss_serve   the first 4 layers (2 sliding/full pairs) written as a
                  checkpoint and served: the serve phase's
                  requests plus a ~300-token prompt, 64 tokens each; the
                  rotating kernel 2 times per decode step, the plain one 2
                  times, the prefill kernel 2 times per prompt, and /health
                  engine.kv_bytes 17,301,504 (the paired cache; a flat one
                  would hold 33,554,432).
DeepSeek-V2-Lite (MLA, shared + routed MoE), the sixth path, on the
single-sequence engine:
  kernels          the prefill and decode kernels at the MLA widths (H = KVH
                   = 16, (Dqk, Dv) = (192, 128), S=4096, its softmax scale):
                   prefill at the served prompt's bucket, decode at pos 300,
                   f32 and bf16 caches and q8 / q4 caches the port's
                   write_kv filled (bf16 q); each against its plain version
                   at the plain decode's tolerances; library yardstick SDPA
                   with V's own head dim.
  deepseek_parity  a 3-layer model at the real head widths (1 dense + 2 MoE,
                   4 experts top-2 + 1 shared, f32) on the GPU against the
                   CPU: prefill logits within 2e-3 and 32 equal greedy
                   tokens, over an f32 and an int8 cache, every attention
                   call through the MLA kernels.
  deepseek_step    one full-width greedy decode step of all 27 layers
                   (random bf16 params made on the card, ~31.4 GB, dense
                   MoE) at pos ~300: wall, host issue, device busy, the
                   attention kernels' share, launches, the bound.
  deepseek_serve   the first 2 layers (1 dense + 1 MoE) written as a
                   checkpoint and served: the serve phase's
                   requests plus a ~300-token prompt in bf16, then a greedy
                   and a streamed request under DNET_KV_BITS=8 and =4;
                   exactly 2 MLA decode launches per step and 2 prefill
                   launches per prompt, and /health engine.kv_bytes
                   83,886,080 in bf16
                   (cache_nbytes under q8 / q4).
Sequence-parallel serving (MeshEngine, sp = 2: the KV cache sharded over two
ranks, both on one H100's cuda:0, so no cross-card copy is seen),
the seventh path, for llama, deepseek_v2 and gpt_oss and under DNET_KV_BITS:
  kernels    the decode kernel's LSE form (one rank's unnormalised partials)
             on R = 2 and 4 shards of a 4096-slot cache (H=32, KVH=8, D=64)
             at pos 0, 1023, 1024, 2047, 2048, 4095 and the sp_serve step's
             position, f32 and bf16 (timed at R = 2, the serve position and
             its empty rank at 2047); then its forms at DeepSeek-V2-Lite's
             MLA widths (H = KVH = 16, (192, 128), f32 and bf16) and over
             int8 / int4 codes at (64, 64) and (192, 128) (bf16 q), R = 2 at
             pos 2047 and the serve position: each rank's m, l and acc / l
             against the plain version (TOL), an empty rank's partials
             exactly (0, -1e30, 0), the combined ranks against flash_decode
             over the whole cache; library yardstick SDPA over the rank's
             live slots (a normalised output, not LSE partials).
  sp_parity  small f32 models at sp = 2 on cuda:0 x 2 against cpu x 2 and
             against the GPU's single-device engine: Llama (plain, q4),
             deepseek_v2 at the MLA head widths (plain, q8, q4), gpt_oss
             (plain, q8); prefill logits within 2e-3 across the shard
             boundary, 16 equal greedy tokens, exactly 2 x layers launches
             of the LSE form of the cache's variant per decode step and no
             other kernel (gpt_oss: none at all).
  sp_step    one full-width Llama-3.2-1B greedy decode step at sp = 2, pos
             ~2,100: wall, host issue, device busy, the LSE kernels' share,
             launches, the bound; the bf16 prefill logits' gap against the
             single-device engine.  deepseek_sp_step: the same for all 27
             DeepSeek-V2-Lite layers (the deepseek_step's params).
  sp_serve   the serve phase's checkpoint served with mesh sp = 2 on
             ["cuda:0", "cuda:0"]: its requests plus a ~2,100-token prompt
             whose KV crosses the shard boundary at 2,048, 64 tokens each;
             in f32 the greedy text equal to a single-device f32 serve,
             bf16 served once (no single-device bf16 pass); 2 x 16 LSE
             launches per decode step and no other kernel;
             /health both ranks' KV bytes.  Then DNET_KV_BITS=8 in f32
             without the sampled request (text equal to a single-device
             q8 serve, 2 x 16
             flash_decode_lse_q8 launches a step, 35,651,584 KV bytes a
             rank), and the gpt_oss and deepseek_v2 serve checkpoints a
             second time under sp = 2 in f32 against single-device f32
             serves (gpt_oss: no kernel, flat caches; deepseek_v2: 2 x 2
             flash_decode_lse_mla launches a step).
The qwen families, the eighth path: qwen2, qwen3, mixtral and qwen3_moe,
served at Qwen3-235B-A22B's widths through the decode and paged kernels'
forms for more than 8 query heads a KV head (row groups of blocks); a bf16
q over a bf16 cache at head dim 128 with more than 4 query heads a KV head
runs their tensor-core forms (16 query rows a block, counted on
launches_mma too):
  kernels          `flash_decode_wide` at H = 64 over KVH = 4, D = 128
                   (G = 16) on a 4096-slot cache at the qwen3_moe serve's
                   position and at 4095, `paged_attend_wide` at those
                   widths over the batch_serve mix, f32 and bf16 (the
                   tensor-core forms, held to MMA_TOL), each against its
                   plain version, beside SDPA (enable_gqa; paged on a
                   pre-gathered copy) and its bound; then the tensor-core
                   forms alone (`flash_decode_mma`, normalised and LSE, at
                   G = 5, 7, 8, 12, 16, 24 over 4 KV heads, lanes at
                   positions 0, 1, 63, 64, 65, 113, 2047, 4095 one at a
                   time and all eight in one launch, timed at 2047;
                   `paged_attend_mma` at G = 7, 8, 16 over the batch_serve
                   mix), within MMA_TOL of their plain versions.
  wide_group_decode  (above) G = 7, 8 and 16 at head dim 128, 2,048 live
                   slots: bf16 as row groups of 16 on the tensor cores
                   (dispatched) and of 4 on the CUDA cores, f32 as row
                   groups of 4; each names the layout the launcher
                   dispatches.
  qwen_parity      small f32 models at the published heads (head dim 128):
                   qwen2 at Qwen2.5-7B's 28 / 4 (qkv biases), qwen3 at
                   Qwen3-4B's 32 / 8 (q/k norms), mixtral at Mixtral-8x7B's
                   32 / 8 (8 experts top-2), qwen3_moe at Qwen3-235B-A22B's
                   64 / 4 (8 experts top-2, a dense first layer): GPU
                   against CPU, prefill logits within 2e-3, 24 equal greedy
                   tokens, exact launches (the wide counter at G = 16); then
                   qwen3_moe at sp = 2 on ["cuda:0", "cuda:0"] against cpu x 2
                   and the single device (the wide LSE form); then bf16
                   through the tensor-core decode form, qwen3_moe at
                   Qwen3-235B-A22B's heads (G = 16) and qwen3 at
                   Qwen3-30B-A3B's 32 / 4 (G = 8): each engine's greedy
                   stream (agreement and first divergence reported), then
                   the card's stream fed to both, the logits of every step
                   within BF16_LOGITS_TOL.
  qwen3_moe_step   one greedy decode step of all 48 Qwen3-30B-A3B layers
                   at full width (random bf16 params made on the card,
                   ~61 GB, dense MoE) at pos ~300: wall, host issue,
                   device busy, the attention kernels' share, launches
                   (48 tensor-core decode calls a step), the bound.
  qwen3_moe_serve  Qwen3-235B-A22B's first layer at full width (128
                   experts top-8 of 1536, ~7.5 GB with the edge) written as
                   a checkpoint and served: the
                   serve phase's requests single sequence (exactly 1
                   flash_decode_wide launch a decode step, also on
                   flash_decode_mma, 1 prefill launch a prompt, /health
                   kv_bytes 8,388,608), then the batch_serve burst with
                   --batch-slots 8 over the paged pool (1 paged_attend_wide
                   launch a batched decode step, also on paged_attend_mma, 1
                   prefill launch a prompt chunk, kv_bytes the pool's).
Continuous batching for every family and cache form, the ninth path: the
dense-gather paged decode (DNET_KV_PAGED=1 without DNET_KV_RAGGED, and
what the ragged kernel refuses), gpt_oss and deepseek_v2 on batched slots:
  lane_launches  device kernels per call of each lane form below (B = 8,
                 torch.profiler, right after the build): exactly 1.
  lane_kernels   the decode kernel's lane forms against their plain
                 versions, timed beside SDPA with a per-lane mask and their
                 bounds: gpt-oss-20b's ring (W = 128, H = 64, KVH = 8,
                 sinks) at B = 8 with lengths 0, 40, 128, 129, 300, 301,
                 700, 4096; DeepSeek-V2-Lite's (192, 128) at B = 8 (an idle
                 lane, the batch_serve mix); plain, int8 and int4 over a
                 Llama-3.2-1B view gathered from a 2,048-block pool through
                 shuffled page tables; f32, bf16 and (bf16 q) q8 / q4.  Then
                 the gather's own copies: a max_seq-wide view, the bucket of
                 the widest table, one step's scatter (bf16, int8).
  gather_parity  small f32 models on the GPU against the CPU: llama under
                 the dense gather (f32, q8, q4), gpt_oss on dense slots (f32,
                 q8, q4; a ring of 32 wrapping per lane), deepseek_v2 on
                 dense slots and under the gather (f32, q8, q4): equal greedy
                 streams, logprobs within 2e-3, exact launches.
  gather_serve   batch_serve's checkpoint and burst with DNET_KV_PAGED=1
                 (bf16), then DNET_KV_BITS=8 DNET_KV_PAGED=1
                 DNET_KV_RAGGED=1 (the ragged kernel refuses the pool): every
                 request 200 with 64 tokens, 16 decode launches of the
                 cache's form a step, no paged launch, no block held after;
                 the gather's and scatter's device ms per decode step; then
                 each form's lanes on in-process engines, dense slots against
                 the gather on one fixed schedule: equal greedy tokens.
  gpt_oss_batch_serve  the 4-layer gpt-oss-20b checkpoint with
                 --batch-slots 8: 8 concurrent streams of the batch_serve
                 prompts, 16 tokens each (rings wrapped per lane); 2 rotating
                 + 2 plain decode launches a step; then DNET_KV_PAGED=1,
                 which /health reports as dense slots.
  deepseek_batch_serve  the 2-layer DeepSeek-V2-Lite checkpoint with
                 --batch-slots 8, dense bf16 slots and the gather over an
                 int8 pool: 2 MLA decode launches a step, 2 MLA prefill
                 launches a prompt chunk.
  lane_kernels_summary  the lane forms with the kernels line's keys, each
                 with its launches on the path that ran it.
Weight-only int8 / int4 quantization (ops/quant.py: codes and scales made on
the card; the matmuls read them through the plain `dq`), the tenth path:
  wq_parity      small f32 models on the GPU against the CPU, each engine
                 quantizing the same params on its own device: llama (head
                 dim 64, a tied table in the projection layout), gpt_oss
                 (64), deepseek_v2 (MLA (192, 128)) and qwen3_moe (128,
                 G = 16) at bits 8 and 4: every code and scale bit-equal,
                 prefill logits within 2e-3, 16 equal greedy tokens.
  wq_serve       the serve phase's checkpoint as `<id>:int8` and
                 `<id>:int4` through the HTTP entry point (its requests, 64
                 tokens each, 16 decode and 16 prefill launches a step /
                 prompt, /health weight bytes equal to the reckoning: bf16
                 2,471,628,800, int8 1,255,190,528, int4 656,625,664), the
                 int8 variant with --batch-slots 8 over paged + ragged slots
                 (the batch_serve burst), and one greedy request through a
                 two-shard ring at weight_quant_bits 8 whose text equals the
                 int8 single process's; rates beside this run's bf16 passes.
  wq_step_70b    Llama-3.3-70B-Instruct's widths, all 80 layers, made on
                 the card a layer at a time and quantized to int8 as each is
                 made (72.7 GB of weights): peak memory, a 64-token prefill,
                 16 greedy decode steps (80 tensor-core decode launches a
                 step), 3 profiled steps (device busy, launches, matmul /
                 attention / elementwise kernels, the plain dq's own time)
                 against the bound: every weight byte read once.
Weight streaming (core/weights.py: layers packed in page-locked host memory,
copied a window at a time to the card on the cache's copy stream), the
eleventh path:
  stream_parity  small f32 models streamed on the GPU against the same
                 engines on the CPU: llama (4 layers) at the plans (2, 4)
                 offload, (2, 1) sliding_fit and (1, 1), deepseek_v2 (MLA
                 widths) and gpt_oss (W-row rings) at (2, 2): prefill logits
                 within 2e-3, 16 equal greedy tokens, one attention launch
                 a layer a step, each layer copied once a forward.
  stream_serve   the serve checkpoint through ring_serve's two shard
                 processes, the tail (layers 8-15) with window_size 2 and
                 residency_size 4 in its topology assignment: greedy and
                 streamed text equal to the single process's, 8 decode
                 launches a step on the tail, its /health weight cache
                 (loads, hits, evictions), the bytes copied a step (8
                 layers, 973 MB) and the rate against the resident ring's
                 in the same run.
  stream_step_70b  Llama-3.3-70B-Instruct's widths in bf16 at 38 layers
                 (65.0 GB page-locked; the depth fixed from the card
                 machine's MemAvailable, which the line prints with the
                 rest of the host's memory at the phase's start, after
                 the host caches are freed, and once the layers are
                 locked), the card
                 capped at 40 GB, window 8 and residency 16: a 64-token
                 prefill and 4 greedy decode steps, 38 prefill launches a
                 prompt and 38 tensor-core decode launches a step, the
                 bytes copied a step against a 1 GiB page-locked copy
                 probed in the same run, the device peak under the cap.
Speculative decoding and the snapshot prefix cache (A4), the twelfth path:
  spec_launches  device kernels per call of the prefill kernel's per-lane
                 form (B = 8 lanes, T = 5; bf16 and f32 at each width pair,
                 torch.profiler, right after the build): exactly 1.
  spec_kernels   the per-lane form (the batched verify block: each lane's
                 chunk at its own start) against its plain version over
                 per-lane masks: Llama-3.2-1B's heads, Llama-3-8B's at
                 (128, 128) and DeepSeek-V2-Lite's MLA widths, f32 and bf16,
                 B = 8 lanes at starts 100 to 4,000, T = 5 and 8; timed
                 beside SDPA with the per-lane mask as a tensor and its
                 bound (each lane's live K/V read once); then the scalar form
                 at the single-sequence verify's shape (T = 5, pos 113 and
                 2,048).
  spec_parity    a 2-layer f32 model at Llama-3.2-1B's heads on the GPU
                 against the CPU: the speculative greedy stream (L = 4) equal
                 to the plain one, single sequence and on 8 dense slots
                 (3 greedy lanes verifying together, a seeded sampled lane
                 on the plain step, equal to its serial stream on the same
                 device), one per-lane launch a layer a verify block; a
                 self-draft's first block emits L + 1 tokens; a prefix
                 hit's logits within 2e-3 of a cold prefill's.
  spec_serve     the serve checkpoint over HTTP in bf16, requests without
                 logit bias (a biased request does not speculate; the
                 first token's time is a 1-token request's): a greedy chat
                 and a two-turn chat, plain and with
                 DNET_API_SPEC_LOOKAHEAD=4 DNET_API_PREFIX_CACHE=4, a
                 self-draft (DNET_API_DRAFT_MODEL), and the batch_serve
                 prompts (greedy, concurrent, 32 tokens) with --batch-slots 8 plain and
                 speculating: tok/s, the first token's time, tokens a
                 verify block, visible-text agreement (reported), turn 2's
                 first token on a hit against the cold server and the
                 prefill tokens saved, a speculating bf16 engine's greedy
                 tokens against a plain one's in process (reported);
                 exactly one per-lane launch a layer a batched verify block.
Every decode row also counts its device kernels per wrapper call
(torch.profiler), which must be exactly 1: the splits and row groups of a
(lane, KV head) merge inside the one launch.  Then the kernels summary line (every row
with times_library = ms / library_ms, its decode rows with
kernels_per_call, both from this run), the card line, and the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import ctypes
import gc
import json
import os
import random
import resource
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for its type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
H, KVH, D, S, LAYERS = 32, 8, 64, 4096, 16
PREFILL_CASES = [(16, 0), (16, 100), (512, 0), (512, 100), (2048, 0), (2048, 100)]
DECODE_POSITIONS = [0, 255, 256, 1024, 4095]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MAX_TOKENS = 64
# printable ASCII: the byte tokenizer's visible characters, favoured with
# logit_bias so a random-weight model's completions are readable text
TEXT_BIAS = {str(t): 100.0 for t in range(32, 127)}
# continuous batching: slots, the default block size, the pool it sizes to
# (slots x S / BT blocks per layer), the serve burst's prompt lengths in
# tokens (chat template included) and the paged kernel's ragged mix
BATCH_SLOTS, BT = 8, 16
POOL_BLOCKS = BATCH_SLOTS * S // BT
BATCH_PROMPT_TOKENS = [27, 60, 150, 300, 520, 800, 1100, 1500]
PAGED_POSITIONS = [0, 15, 16, 100, 1023, 2047, 4000, 4094]
# the paged kernel's main mix: every batch_serve lane half-way through its output
BATCH_POSITIONS = [n + MAX_TOKENS // 2 for n in BATCH_PROMPT_TOKENS]
PAGED_ENV = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1"}
PREFILL_CHUNK = 256  # the batched adapter's prompt chunk (api/strategies.py)
# the ring's hop codec: hidden width, kept columns (pct 0.5), quant group,
# frame rows (a decode hop, a prompt frame) and input copies rotated per
# timed call (16 x 6 MB at R=1500 in bf16 exceeds the 50 MB L2)
COL_C, COL_K, COL_GS, COL_ROWS, COL_COPIES = 2048, 1024, 64, (1, 1500), 16
RING_LAYERS = ([*range(0, 8)], [*range(8, 16)])
RING_ENV = {"DNET_WIRE_QSPARSE_PCT": "0.5", "DNET_WIRE_GROUP_SIZE": "64"}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_ms(fn, layers: int, reps: int = 20) -> float:
    """Median device time of one call.  A sleep kernel holds the stream
    while the host enqueues `reps` calls, so they run back to back and the
    host's launch cost is not counted; call r reads layer r % layers of a
    16-layer cache (128 MB at S=4096), so it finds K/V cold in the 50 MB L2
    as the model's next layer would."""
    for r in range(3):
        fn(r % layers)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~30 ms
        start.record()
        for r in range(reps):
            fn(r % layers)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernels_per_call(fn) -> int:
    """Device kernels one call of `fn` launches, as torch.profiler traces
    them.  The call sits 2 ms inside the traced window on both sides (a
    few-microsecond kernel alone in a session was dropped now and then), and
    a session that traced none is traced again, up to 3 times: the profiler
    can drop a kernel record, never invent one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


def phase_decode_launches() -> dict:
    """Device kernels per wrapper call of every decode form (each counter of
    the decode wrapper), traced with torch.profiler right after the build,
    before any timed phase (later in the process the profiler was seen to
    drop these kernels' records): Llama-3.2-1B's widths for the plain, q8 /
    q4 and LSE forms, gpt-oss-20b's ring (W=128, H=64) for the rotating ones,
    DeepSeek-V2-Lite's (192, 128) for the MLA ones, Qwen3-235B-A22B's
    (H = 64 over KVH = 4, G = 16, D = 128) for the wide counter in the
    plain, q8, q4 and LSE forms, and Qwen3-30B-A3B's (H = 32 over KVH = 4,
    G = 8) in the plain and LSE forms, bf16 q, an empty and a long lane;
    the plain and LSE forms at head dim 128 run the tensor-core kernel and
    count on launches_mma too.  Every count must be exactly 1: a lane's
    splits and row groups merge inside the one launch.  Returns counter
    name -> kernels a call."""
    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, write_kv
    from dnet_tpu_torch.kernels import _counters
    from dnet_tpu_torch.ops.flash_decode import (
        COUNTERS,
        MMA_COUNTER,
        WIDE_COUNTER,
        flash_decode_attend,
        flash_decode_lse,
    )

    g = torch.Generator(device="cuda").manual_seed(13)
    attr_to_name = {attr: name for name, (fn, attr) in _counters().items() if fn is flash_decode_attend}
    counts = {}
    forms = [((bits, rot, mla, lse), attr, (MLA_H, MLA_H, MLA_DQK, MLA_DV) if mla
              else (OSS_H, OSS_KVH, OSS_D, OSS_D) if rot else (H, KVH, D, D))
             for (bits, rot, mla, lse), attr in COUNTERS.items()]
    forms += [((bits, False, False, lse), WIDE_COUNTER, (QW_H, QW_KVH, QW_D, QW_D))
              for bits, lse in ((0, False), (8, False), (4, False), (0, True))]
    forms += [((0, False, False, lse), COUNTERS[0, False, False, lse], (32, QW_KVH, QW_D, QW_D)) for lse in (False, True)]
    for (bits, rot, mla, lse), attr, (h, kvh, dqk, dv) in forms:
        mma = dqk == QW_D and not bits
        slots = OSS_W if rot else 2048
        kv = layer_slices(init_cache(KVConfig(1, 1, slots, kvh, dqk, v_head_dim=dv, quant_bits=bits),
                                     torch.device("cuda")), 0)
        write_kv(kv, torch.randn(1, slots, kvh, dqk, generator=g, device="cuda").to(torch.bfloat16),
                 torch.randn(1, slots, kvh, dv, generator=g, device="cuda").to(torch.bfloat16), 0)
        q = torch.randn(1, 1, h, dqk, generator=g, device="cuda").to(torch.bfloat16)
        scales = {n: kv[n] for n in ("k_scale", "v_scale") if n in kv}
        seen = []
        for length in (0 if lse else 1, 2048):
            lengths = torch.full((1,), length, dtype=torch.int32, device="cuda")
            live = min(length, slots)
            if lse:
                def call():
                    return flash_decode_lse(q, kv["k"], kv["v"], lengths, live, **scales)
            else:
                extra = {"rotating": True, "window": slots} if rot else {}

                def call():
                    return flash_decode_attend(q, kv["k"], kv["v"], lengths, live, **scales, **extra)
            call()  # built, loaded and its scratch allocated
            before = getattr(flash_decode_attend, attr), getattr(flash_decode_attend, MMA_COUNTER)
            seen.append(kernels_per_call(call))
            check(getattr(flash_decode_attend, attr) > before[0], f"{attr} did not count the traced call")
            check((getattr(flash_decode_attend, MMA_COUNTER) > before[1]) == mma,
                  f"{attr} at {(h, kvh, dqk)}: {MMA_COUNTER} counted {'no' if mma else 'a'} tensor-core call")
        name = attr_to_name[attr]
        check(seen == [1, 1], f"{name} q{bits} at {(h, kvh, dqk)}: {seen} device kernels in one call, expected 1")
        counts[name] = 1
        if mma:
            counts[attr_to_name[MMA_COUNTER]] = 1
        del kv
    emit({"phase": "decode_launches", "kernels_per_call": counts})
    torch.cuda.empty_cache()
    return counts


def ptxas_line(report: list, prefill_report: list, paged_report: list) -> dict:
    """The decode, prefill and paged kernels' instantiations as ptxas built
    them (registers, spills, stack) with each one's dynamic shared memory,
    and the count of those that spill.  Fails if a bf16 (tensor-core)
    prefill, a bf16 paged or a tensor-core decode / paged instantiation
    spills or is missing, or if a CUDA-core decode instantiation with 8
    rows a block at head dim 128 (which spilled, and which no dispatch
    reaches) is built."""
    import re

    from dnet_tpu_torch.ops import paged_attention
    from dnet_tpu_torch.ops.flash_attention import prefill_smem_bytes
    from dnet_tpu_torch.ops.flash_decode import kernel_smem_bytes

    types = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16, "unsigned char": torch.uint8}

    def args(m):  # cu++filt writes the non-type arguments as (int)0, (bool)1
        return [re.sub(r"^\((?:int|bool)\)", "", x.strip()) for x in m.group(1).split(",")]

    def rows_of(rep, smem):
        rows = []
        for k in rep:
            row = {key: k.get(key) for key in ("name", "registers", "spill_store_bytes", "spill_load_bytes",
                                                "stack_bytes", "static_smem_bytes")}
            row["dynamic_smem_bytes"] = smem(k["name"])
            rows.append(row)
        return {"instantiations": len(rows), "spilling": sum(1 for r in rows if r["spill_store_bytes"]),
                "kernels": rows}

    def decode_smem(name):
        if "flash_decode_mma_kernel" in name:
            return kernel_smem_bytes(torch.bfloat16, torch.bfloat16, 0, QW_D, QW_D, 16, 1)
        m = re.search(r"flash_decode_kernel<([^>]*)>", name)
        if not m:
            return None
        t, kv, qb, dqk, dv, gp, rot = args(m)
        return kernel_smem_bytes(types[t], types[kv], int(qb), int(dqk), int(dv), int(gp), 1, rot in ("1", "true"))

    def prefill_smem(name):  # flash_prefill_tc_kernel<DQK, DV, m-atoms a warp, lanes>, _f32_kernel<DQK, DV, lanes>
        m = re.search(r"flash_prefill_(tc|f32)_kernel<([^>]*)>", name)
        if not m:
            return None
        dims = [int(re.sub(r"^\((?:int|bool)\)", "", x.strip())) for x in m.group(2).split(",")][:-1]
        if m.group(1) == "f32":
            return prefill_smem_bytes(torch.float32, *dims)
        return prefill_smem_bytes(torch.bfloat16, dims[0], dims[1], 64 * dims[2])

    def paged_smem(name):  # paged_attention_kernel<T, KV, D, GP>, paged_attention_mma_kernel
        if "paged_attention_mma_kernel" in name:
            return paged_attention.kernel_smem_bytes(torch.bfloat16, torch.bfloat16, QW_D, 16, 1, rows=16)
        m = re.search(r"paged_attention_kernel<([^>]*)>", name)
        if not m:
            return None
        t, kv, d, gp = args(m)
        return paged_attention.kernel_smem_bytes(types[t], types[kv], int(d), int(gp), 1, rows=int(gp))

    prefill = rows_of(prefill_report, prefill_smem)
    tc = [r for r in prefill["kernels"] if "flash_prefill_tc_kernel" in r["name"]]
    # 4 scalar instantiations (128-row tiles at (64, 64)) and the per-lane form's 3
    check(len(tc) == 7 and not any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in tc),
          f"bf16 prefill instantiations spill or are missing: {tc}")
    paged = rows_of(paged_report, paged_smem)
    bf16 = [r for r in paged["kernels"] if "paged_attention_kernel<__nv_bfloat16" in r["name"]]
    check(len(bf16) == 6 and not any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in bf16),
          f"bf16 paged instantiations spill or are missing: {bf16}")
    decode = rows_of(report, decode_smem)
    mma = [r for r in decode["kernels"] + paged["kernels"] if "_mma_kernel" in r["name"]]
    check(len(mma) == 2 and not any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in mma),
          f"tensor-core decode / paged instantiations spill or are missing: {mma}")
    gone = [r["name"] for r in decode["kernels"]
            if re.search(r"flash_decode_kernel<[^>]*\(int\)128, \(int\)128, \(int\)8,", r["name"])]
    check(not gone, f"decode instantiations with 8 rows at (128, 128) are still built: {gone}")
    return {"phase": "ptxas", "source": "dnet_tpu_torch/csrc/flash_decode.cu", "flags": "-Xptxas -v",
            **decode, "tensor_core": mma,
            "prefill": {"source": "dnet_tpu_torch/csrc/flash_prefill.cu", **prefill},
            "paged": {"source": "dnet_tpu_torch/csrc/paged_attention.cu", **paged}}


def prefill_bound(T: int, pos: int, dtype, h: int = H, kvh: int = KVH, d: int = D) -> tuple:
    """(ms, bound_by) for causal prefill at (T, pos) over h query and kvh KV
    heads of width d: q, the live K/V rows and the output move once; 4*d
    operations per (head, query, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    keys = min(pos + T, S)
    nbytes = size * (2 * T * h * d + 2 * keys * kvh * d)
    pairs = sum(min(pos + i + 1, S) for i in range(T))
    return bytes_ops_bound(nbytes, 4 * h * d * pairs, dtype)


def decode_bound(pos: int, dtype, h: int = H, kvh: int = KVH, d: int = D) -> tuple:
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (2 * h * d + 2 * (pos + 1) * kvh * d)
    ops = 4 * h * d * (pos + 1)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


@contextlib.contextmanager
def paged_blocks_per_slot(n: int):
    """paged_attend planned at n blocks a slot (every KV head's budget n x
    slots) for the block, in place of `paged_plan`'s choice."""
    from dnet_tpu_torch.ops import paged_attention

    plan = paged_attention.paged_plan
    paged_attention.paged_plan = lambda max_live, slots, kv_heads, blocks_per_sm=1: n * slots
    try:
        yield
    finally:
        paged_attention.paged_plan = plan


@contextlib.contextmanager
def environ(values: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paged_bound(positions: list, dtype, h: int = H, kvh: int = KVH, d: int = D) -> tuple:
    """(ms, bound_by) for one ragged paged-attention call: q, the live K/V
    rows, the new rows and the output move once, with the live table
    entries and the positions; 4*d operations per (head, key) pair, the new
    row included."""
    size = torch.tensor([], dtype=dtype).element_size()
    B, live = len(positions), sum(positions)
    nbytes = size * (2 * B * h * d + 2 * live * kvh * d + 2 * B * kvh * d)
    nbytes += 4 * (sum(-(-p // BT) for p in positions) + B)
    ops = 4 * h * d * (live + B)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def paged_tables(positions: list) -> torch.Tensor:
    """Page tables [B, POOL_BLOCKS / BATCH_SLOTS] (int32, on the card) giving
    each slot its live blocks scattered through a POOL_BLOCKS pool; dead
    entries 0, as the engine pads them."""
    perm = torch.randperm(POOL_BLOCKS, generator=torch.Generator().manual_seed(2))
    per_slot = POOL_BLOCKS // BATCH_SLOTS
    tables = torch.zeros(len(positions), per_slot, dtype=torch.int32)
    for b, p in enumerate(positions):
        n = -(-p // BT)
        tables[b, :n] = perm[b * per_slot : b * per_slot + n].to(torch.int32)
    return tables.cuda()


def phase_paged_launches(main_positions: list) -> dict:
    """Device kernels per paged_attend call, traced with torch.profiler right
    after the build (as the decode forms'), in bf16 at the batch_serve mix
    and the ragged mix up to 4094, and at Qwen3-235B-A22B's G = 16 at the
    batch_serve mix (bf16: the tensor-core form, counted on launches_mma
    too), at the plan's budget and at the cap of 16 blocks a slot: each
    must be exactly 1 (the splits and row groups merge inside the
    launch)."""
    from dnet_tpu_torch.ops.flash_decode import MAX_SPLITS
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    g = torch.Generator(device="cuda").manual_seed(12)
    shape = (POOL_BLOCKS, BT, KVH, D)
    kp = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    seen = []
    for positions in (main_positions, PAGED_POSITIONS):
        B = len(positions)
        tables, pos = paged_tables(positions), torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn(B, KVH, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        def call():
            return paged_attend(q, kp, vp, tables, pos, kn, vn, max_live=max(positions))
        for cap in (False, True):
            with paged_blocks_per_slot(MAX_SPLITS) if cap else contextlib.nullcontext():
                call()  # built, loaded and its scratch allocated
                before = paged_attend.launches
                seen.append(kernels_per_call(call))
                check(paged_attend.launches > before, "paged_attend did not count the traced call")
    check(seen == [1] * 4, f"paged_attend: {seen} device kernels a call, expected 1")
    del kp, vp
    # Qwen3-235B-A22B's G = 16 (row groups of blocks) at the main mix
    shape = (POOL_BLOCKS, BT, QW_KVH, QW_D)
    kp = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    B = len(main_positions)
    tables, pos = paged_tables(main_positions), torch.tensor(main_positions, dtype=torch.int32, device="cuda")
    q = torch.randn(B, 1, QW_H, QW_D, generator=g, device="cuda").to(torch.bfloat16)
    kn, vn = (torch.randn(B, QW_KVH, QW_D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    wide = []
    for cap in (False, True):
        with paged_blocks_per_slot(MAX_SPLITS) if cap else contextlib.nullcontext():
            def call():
                return paged_attend(q, kp, vp, tables, pos, kn, vn, max_live=max(main_positions))
            call()
            before = paged_attend.launches_wide, paged_attend.launches_mma
            wide.append(kernels_per_call(call))
            check(paged_attend.launches_wide > before[0] and paged_attend.launches_mma > before[1],
                  "paged_attend_wide / paged_attend_mma did not count the traced call")
    check(wide == [1, 1], f"paged_attend_wide: {wide} device kernels a call, expected 1")
    emit({"phase": "paged_launches", "kernels_per_call": 1, "traced_calls": len(seen) + len(wide)})
    del kp, vp
    torch.cuda.empty_cache()
    return {"paged_attend": 1, "paged_attend_wide": 1, "paged_attend_mma": 1}


def phase_paged_kernels(main_positions: list) -> dict:
    """The paged kernel at full width: 8 slots over a 16-layer pool of
    POOL_BLOCKS blocks per layer, each slot's blocks scattered through it
    (dead table entries 0, as the engine pads them).  Returns the main
    path's bf16 case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_decode import MAX_SPLITS
    from dnet_tpu_torch.ops.paged_attention import blocks_per_sm, paged_attend, paged_attend_plain, paged_plan

    g = torch.Generator(device="cuda").manual_seed(2)
    per_slot = POOL_BLOCKS // BATCH_SLOTS
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        shape = (LAYERS, POOL_BLOCKS, BT, KVH, D)
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        for positions in (main_positions, PAGED_POSITIONS):
            B = len(positions)
            tables_d = paged_tables(positions)
            pos_cpu = torch.tensor(positions, dtype=torch.int32)
            pos = pos_cpu.cuda()
            q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
            kn = torch.randn(B, KVH, D, generator=g, device="cuda").to(dtype)
            vn = torch.randn(B, KVH, D, generator=g, device="cuda").to(dtype)
            max_live = max(positions)
            out = paged_attend(q, kp[0], vp[0], tables_d, pos, kn, vn, max_live=max_live)
            torch.cuda.synchronize()
            want = paged_attend_plain(q.float(), kp[0].float(), vp[0].float(), tables_d, pos_cpu,
                                      kn.float(), vn.float())
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "paged output")
            check(err <= TOL[dtype], f"paged positions={positions} {dtype}: max err {err}")
            # the library yardstick: each layer's live rows gathered once,
            # outside the timing, into contiguous [B, KVH, keys, D] with the
            # new row at pos[b]; rows past pos[b] are masked
            keys = max_live + 1
            j = torch.arange(keys, device="cuda")
            rows = (tables_d.long()[:, (j // BT).clamp(max=per_slot - 1)] * BT + j % BT)  # [B, keys]
            at_pos = j[None, :] == pos.long()[:, None]

            def contiguous(pool, new):
                flat = pool.reshape(LAYERS, POOL_BLOCKS * BT, KVH, D)
                c = flat[:, rows]  # [L, B, keys, KVH, D]
                c = torch.where(at_pos[None, :, :, None, None], new[None, :, None], c)
                return c.transpose(2, 3).contiguous()

            kc, vc = contiguous(kp, kn), contiguous(vp, vn)
            mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, kc[l], vc[l], attn_mask=mask, enable_gqa=True)

            lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
            check(lib_err <= TOL[dtype], f"paged library yardstick disagrees: {lib_err}")
            bound, by = paged_bound(positions, dtype)
            row = {
                "phase": "kernels", "kernel": "paged_attend", "dtype": str(dtype).split(".")[-1],
                "positions": positions, "sum_pos": sum(positions), "slots": B, "bt": BT,
                "pool_blocks": POOL_BLOCKS, "layers": LAYERS, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(
                    lambda l: paged_attend(q, kp[l], vp[l], tables_d, pos, kn, vn, max_live=max_live),
                    LAYERS),
                "plain_ms": device_time_ms(
                    lambda l: paged_attend_plain(q, kp[l], vp[l], tables_d, pos_cpu, kn, vn), LAYERS, 3),
                "library_ms": device_time_ms(lib, LAYERS),
                "library_call": "scaled_dot_product_attention on a pre-gathered contiguous copy "
                                "(the gather is not timed)",
                "library_max_err": lib_err,
                "bound_ms": bound, "bound_by": by,
                "blocks_per_kv_head": paged_plan(max_live, B, KVH, blocks_per_sm(dtype, dtype, D, H, KVH)),
            }
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            if dtype == torch.bfloat16 and positions is main_positions:
                # where the plan's budget sits among the others (n blocks a slot)
                row["kernel_ms_by_split"] = {}
                for n in range(1, MAX_SPLITS + 1):
                    with paged_blocks_per_slot(n):
                        row["kernel_ms_by_split"][n] = device_time_ms(
                            lambda l: paged_attend(q, kp[l], vp[l], tables_d, pos, kn, vn), LAYERS)
                main = row
            emit(row)
            if dtype == torch.float32 and positions is main_positions:
                # DNET_KV_BITS=16 on an f32 model: a bf16 pool under the f32 q
                # and new rows, held to the f32 tolerance
                kp16, vp16 = kp[0].to(torch.bfloat16), vp[0].to(torch.bfloat16)
                out = paged_attend(q, kp16, vp16, tables_d, pos, kn, vn, max_live=max_live)
                torch.cuda.synchronize()
                want16 = paged_attend_plain(q, kp16.float(), vp16.float(), tables_d, pos_cpu, kn, vn)
                err16 = (out - want16).abs().max().item()
                check(out.dtype == dtype and bool(torch.isfinite(out).all()) and err16 <= TOL[dtype],
                      f"paged bf16 pool under f32 q: max err {err16}")
                emit({"phase": "kernels", "kernel": "paged_attend", "dtype": "float32", "pool_dtype": "bfloat16",
                      "positions": positions, "max_err": err16, "tol": TOL[dtype]})
                del kp16, vp16
            del kc, vc
        del kp, vp
    torch.cuda.empty_cache()
    return main


def bytes_ops_bound(nbytes: int, ops: int, dtype) -> tuple:
    """(ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_column_launches() -> dict:
    """Device kernels one select of the hop codec takes at each COL_ROWS
    frame (bf16, the ring's widths): column_topk, which must be 1, and the
    chain it replaced (the norms kernel, then sorts, a slice and a cast).
    Traced right after the build, as the decode and paged calls: late in a
    long process the profiler was seen to trace no kernel at all."""
    from dnet_tpu_torch.compression.ops import column_sq_norms, column_topk, topk_columns

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for R in COL_ROWS:
        x = torch.randn(R, COL_C, generator=g, device="cuda").to(torch.bfloat16)
        column_topk(x, COL_K)
        topk_columns(column_sq_norms(x), COL_K)
        out[R] = {"column_topk": kernels_per_call(lambda: column_topk(x, COL_K)),
                  "sort_chain": kernels_per_call(lambda: topk_columns(column_sq_norms(x), COL_K))}
        check(out[R]["column_topk"] == 1, f"column_topk R={R}: {out[R]['column_topk']} device kernels")
    emit({"phase": "column_launches", "gpu": gpu_line(), "C": COL_C, "keep": COL_K, "per_call": out})
    return out


def phase_column_kernels(per_call: dict) -> dict:
    """The hop codec's kernels at the ring's widths; returns the decode
    hop's (R=1) bf16 row per kernel, the frame that runs once per token
    (for the norms kernel its column_topk form, which the send side runs).
    `per_call`: phase_column_launches' counts."""
    from dnet_tpu_torch.compression.ops import (
        column_sq_norms,
        column_sq_norms_plain,
        column_topk,
        column_topk_plain,
        dequant_scatter_columns,
        dequant_scatter_columns_plain,
        gather_columns,
        gather_columns_plain,
        pack_mask,
        quantize_q8,
        topk_columns,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    main = {}
    C, K, GS = COL_C, COL_K, COL_GS
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        name = str(dtype).split(".")[-1]
        for R in COL_ROWS:
            xs = [torch.randn(R, C, generator=g, device="cuda").mul_(3).to(dtype) for _ in range(COL_COPIES)]
            # the kept columns as the codec picks them: the top K norms
            idx = topk_columns(column_sq_norms_plain(xs[0]), K)
            idx_long = idx.long()
            shape = {"R": R, "C": C, "K": K}

            def emit_row(kernel, err, kernel_fn, plain_fn, lib_fn, lib_call, nbytes, ops, **extra):
                bound, by = bytes_ops_bound(nbytes, ops, torch.float32)
                row = {"phase": "kernels", "kernel": kernel, "dtype": name, **shape, **extra,
                       "max_err": err, "kernel_ms": device_time_ms(kernel_fn, COL_COPIES),
                       "plain_ms": device_time_ms(plain_fn, COL_COPIES, 3),
                       "library_ms": device_time_ms(lib_fn, COL_COPIES), "library_call": lib_call,
                       "bytes": nbytes, "bound_ms": bound, "bound_by": by}
                emit(row)
                if dtype == torch.bfloat16 and R == 1 and kernel not in main:
                    main[kernel] = row
                    if kernel == "column_topk":  # the norms kernel's row on the send side's path
                        main["column_sq_norms"] = row

            out = column_sq_norms(xs[0])
            torch.cuda.synchronize()
            want = column_sq_norms_plain(xs[0])
            rel = ((out - want).abs() / want.abs().clamp(min=1e-30)).max().item()
            check(out.shape == (C,) and bool(torch.isfinite(out).all()), "norms output")
            check(rel <= 2e-5, f"column_sq_norms R={R} {name}: relative err {rel}")
            check(torch.equal(out, column_sq_norms(xs[0])), "column_sq_norms is not repeatable")
            emit_row("column_sq_norms", (out - want).abs().max().item(),
                     lambda l: column_sq_norms(xs[l]), lambda l: column_sq_norms_plain(xs[l]),
                     lambda l: torch.linalg.vector_norm(xs[l], 2, 0, dtype=torch.float32),
                     "torch.linalg.vector_norm(x, 2, 0, dtype=float32) (the square root, not squared)",
                     R * C * size + C * 4, 2 * R * C, max_rel_err=rel, tol_rel=2e-5)

            # the norms with the selection on: the kept columns and the
            # wire's bitmask, equal to topk_columns of the kernel's own norms
            sel, mask = column_topk(xs[0], K)
            sel2, mask2 = column_topk(xs[0], K)
            torch.cuda.synchronize()
            check(torch.equal(sel, topk_columns(out, K)) and torch.equal(mask, pack_mask(sel, C)),
                  f"column_topk R={R} {name}: not topk_columns of its own norms")
            check(torch.equal(sel, sel2) and torch.equal(mask, mask2), "column_topk is not repeatable")
            plain_sel, _ = column_topk_plain(xs[0], K)
            emit_row("column_topk", 0.0, lambda l: column_topk(xs[l], K), lambda l: column_topk_plain(xs[l], K),
                     lambda l: torch.topk(torch.linalg.vector_norm(xs[l], 2, 0, dtype=torch.float32),
                                          K).indices.sort(),
                     "torch.topk(torch.linalg.vector_norm(x, 2, 0, dtype=float32), keep).indices.sort()",
                     R * C * size + 4 * K + C // 8, 2 * R * C,
                     sort_chain_ms=device_time_ms(lambda l: topk_columns(column_sq_norms(xs[l]), K), COL_COPIES),
                     kernels_per_call=per_call[R]["column_topk"],
                     sort_chain_kernels_per_call=per_call[R]["sort_chain"],
                     columns_as_plain=int(torch.isin(sel, plain_sel).sum()))

            out = gather_columns(xs[0], idx)
            torch.cuda.synchronize()
            check(torch.equal(out, gather_columns_plain(xs[0], idx)), f"gather_columns R={R} {name} not bit-equal")
            check(torch.equal(torch.index_select(xs[0], 1, idx), out), "index_select disagrees")
            # beside the kept bytes, the bound at sector granularity: the
            # 32-byte sectors of x the kept columns touch, read once
            offsets = torch.arange(R, device="cuda")[:, None] * C + idx_long[None, :]
            sectors = int(torch.unique(offsets * size // 32).numel())
            sector_bytes = 32 * sectors + R * K * size + K * 4
            emit_row("gather_columns", 0.0, lambda l: gather_columns(xs[l], idx),
                     lambda l: gather_columns_plain(xs[l], idx), lambda l: torch.index_select(xs[l], 1, idx),
                     "torch.index_select(x, 1, idx)", 2 * R * K * size + K * 4, 0,
                     sector_bytes=sector_bytes, sector_bound_ms=bytes_ops_bound(sector_bytes, 0, dtype)[0])

            kept = [gather_columns_plain(x, idx) for x in xs]
            q = [quantize_q8(k, GS) for k in kept]
            deq = [dequant_scatter_columns_plain(c, idx, C, dtype, sc, b, GS)[:, idx_long].contiguous()
                   for c, sc, b in q]
            outs = [torch.zeros(R, C, dtype=dtype, device="cuda") for _ in range(COL_COPIES)]
            codes, scale, bias = q[0]
            out = dequant_scatter_columns(codes, idx, C, dtype, scale, bias, GS)
            torch.cuda.synchronize()
            check(torch.equal(out, dequant_scatter_columns_plain(codes, idx, C, dtype, scale, bias, GS)),
                  f"dequant_scatter_columns R={R} {name} not bit-equal")
            check(torch.equal(outs[0].clone().index_copy_(1, idx_long, deq[0]), out), "index_copy_ disagrees")
            G = scale.shape[1]
            emit_row("dequant_scatter_columns", 0.0,
                     lambda l: dequant_scatter_columns(q[l][0], idx, C, dtype, q[l][1], q[l][2], GS),
                     lambda l: dequant_scatter_columns_plain(q[l][0], idx, C, dtype, q[l][1], q[l][2], GS),
                     lambda l: outs[l].index_copy_(1, idx_long, deq[l]),
                     "out.index_copy_(1, idx, kept) on a pre-dequantized copy (the dequant is not timed)",
                     R * K + 2 * R * G * 4 + K * 4 + R * C * size, 2 * R * K, gs=GS, form="qsparse8")
            out = dequant_scatter_columns(kept[0], idx, C)
            torch.cuda.synchronize()
            check(torch.equal(out, dequant_scatter_columns_plain(kept[0], idx, C)), "plain scatter not bit-equal")
            emit_row("dequant_scatter_columns", 0.0, lambda l: dequant_scatter_columns(kept[l], idx, C),
                     lambda l: dequant_scatter_columns_plain(kept[l], idx, C),
                     lambda l: outs[l].index_copy_(1, idx_long, kept[l]), "out.index_copy_(1, idx, kept)",
                     R * K * size + K * 4 + R * C * size, 0, form="sparse_v1")
            del xs, kept, q, deq, outs
    torch.cuda.empty_cache()
    return main


def _sort_chain_encode(x: torch.Tensor, drop_frac: float, gs: int) -> bytes:
    """The qsparse8 encode as the send side ran it before column_topk: the
    norms kernel, a stable sort, a slice, a second sort and a cast for the
    kept columns, the gather, and the bitmask built on the host from the
    indices (a host sync); the same payload bytes as compress_tensor's."""
    from dnet_tpu_torch.compression.ops import (
        column_sq_norms, gather_columns, keep_count, quantize_q8, topk_columns)

    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    idx = topk_columns(column_sq_norms(x2), keep_count(D, drop_frac))
    kept = gather_columns(x2, idx)
    mask = np.zeros(D, dtype=bool)
    mask[idx.cpu().numpy()] = True
    codes, scale, bias = quantize_q8(kept, gs)
    return (np.packbits(mask).tobytes() + codes.cpu().numpy().tobytes()
            + scale.float().cpu().numpy().tobytes() + bias.float().cpu().numpy().tobytes())


def phase_codec_host() -> None:
    """One hidden hop's encode and decode as a shard runs them, qsparse8
    against lossless at the ring's widths (bf16 [1, R, 2048]): the host's
    wall time per call, synchronised, and the device work of one call
    (kernel launches and device time, torch.profiler).  The qsparse8 encode
    is also timed as it ran before its select became one kernel
    (`qsparse8_encode_sort_chain`), its payload checked equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.compression.wire import compress_tensor, decompress_tensor_device
    from dnet_tpu_torch.utils.serialization import bytes_to_device, tensor_to_bytes

    def wall_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def device_work(fn) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return {"launches": len(kernels), "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3}

    g = torch.Generator(device="cuda").manual_seed(4)
    for R in COL_ROWS:
        x = torch.randn(1, R, COL_C, generator=g, device="cuda").to(torch.bfloat16)
        q = compress_tensor(x, 0.5, "bfloat16", 8, COL_GS)
        check(q[0] == _sort_chain_encode(x, 0.5, COL_GS), f"codec R={R}: the encodes' payloads differ")
        lossless = tensor_to_bytes(x, "bfloat16")
        calls = {
            "qsparse8_encode": lambda: compress_tensor(x, 0.5, "bfloat16", 8, COL_GS),
            "qsparse8_encode_sort_chain": lambda: _sort_chain_encode(x, 0.5, COL_GS),
            "qsparse8_decode": lambda: decompress_tensor_device(*q, "cuda"),
            "lossless_encode": lambda: tensor_to_bytes(x, "bfloat16"),
            "lossless_decode": lambda: bytes_to_device(*lossless, "cuda"),
        }
        emit({"phase": "codec", "gpu": gpu_line(), "R": R, "C": COL_C,
              "payload_bytes": {"qsparse8": len(q[0]), "lossless": len(lossless[0])},
              "host_wall_ms": {k: wall_ms(fn) for k, fn in calls.items()},
              "device": {k: device_work(fn) for k, fn in calls.items()}})


def phase_kernels(main_T: int, main_pos: int) -> dict:
    """Every case's line; returns the main path's bf16 case per kernel."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
    from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        for T, pos in dict.fromkeys(PREFILL_CASES + [(main_T, 0)]):
            q = torch.randn(1, T, H, D, generator=g, device="cuda").to(dtype)
            out = flash_prefill(q, kc[0], vc[0], pos)
            torch.cuda.synchronize()
            want = flash_prefill_plain(q.float(), kc[0].float(), vc[0].float(), pos)
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "prefill output")
            check(err <= TOL[dtype], f"prefill T={T} pos={pos} {dtype}: max err {err}")
            keys = pos + T
            qt = q.transpose(1, 2)
            mask = (torch.arange(keys, device="cuda")[None, :]
                    <= pos + torch.arange(T, device="cuda")[:, None])

            def lib(l):
                return sdpa(qt, kc[l, :, :keys].transpose(1, 2), vc[l, :, :keys].transpose(1, 2),
                            attn_mask=mask, enable_gqa=True)

            def lib_causal(l):
                return sdpa(qt, kc[l, :, :keys].transpose(1, 2), vc[l, :, :keys].transpose(1, 2),
                            is_causal=True, enable_gqa=True)

            bound, by = prefill_bound(T, pos, dtype)
            row = {
                "phase": "kernels", "kernel": "flash_prefill", "dtype": str(dtype).split(".")[-1],
                "T": T, "pos": pos, "S": S, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(lambda l: flash_prefill(q, kc[l], vc[l], pos), LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_prefill_plain(q, kc[l], vc[l], pos), LAYERS, 3),
                "library_ms": device_time_ms(lib, LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            if pos == 0:
                row["library_causal_ms"] = device_time_ms(lib_causal, LAYERS)
            emit(row)
            if dtype == torch.bfloat16 and (T, pos) == (main_T, 0):
                main["flash_prefill"] = row
        for pos in dict.fromkeys(DECODE_POSITIONS + [main_pos]):
            q = torch.randn(1, 1, H, D, generator=g, device="cuda").to(dtype)
            lengths = decode_lengths(1, pos, "cuda")
            out = flash_decode_attend(q, kc[0], vc[0], lengths, pos + 1)
            torch.cuda.synchronize()
            want = flash_decode_plain(q.float(), kc[0].float(), vc[0].float(), lengths)
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "decode output")
            check(err <= TOL[dtype], f"decode pos={pos} {dtype}: max err {err}")
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, kc[l, :, : pos + 1].transpose(1, 2),
                            vc[l, :, : pos + 1].transpose(1, 2), enable_gqa=True)

            bound, by = decode_bound(pos, dtype)
            row = {
                "phase": "kernels", "kernel": "flash_decode", "dtype": str(dtype).split(".")[-1],
                "pos": pos, "S": S, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(lambda l: flash_decode_attend(q, kc[l], vc[l], lengths, pos + 1),
                                            LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_decode_plain(q, kc[l], vc[l], lengths, max_live=pos + 1),
                                           LAYERS, 5),
                "library_ms": device_time_ms(lib, LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if dtype == torch.bfloat16 and pos == main_pos:
                main["flash_decode"] = row
        del kc, vc
    torch.cuda.empty_cache()
    return main


def phase_wide_group_decode() -> None:
    """The decode kernel at head dim 128 where more than 4 query heads share
    a KV head, in the layouts it can take: G = 7 (Qwen2.5-7B's 28 / 4),
    G = 8 (Llama-3-70B's and Qwen3-30B-A3B's grouping; H = 64 over KVH = 8
    here) and G = 16 (Qwen3-235B-A22B's 64 / 4).  bf16 as row groups of 16
    rows on the tensor cores (the launcher's) and as row groups of 4 on the
    CUDA cores (forced: PR 12's layout at G = 8 and 16); f32 as row groups
    of 4, its only layout (the 8-row instantiation at head dim 128 is not
    built).  One lane of 2,048 live slots, each layout held to the plain
    version (TOL; MMA_TOL for the tensor-core form) and timed beside it,
    SDPA and the bound.  `dispatch` is the layout the launcher picks,
    `faster` the one this run measured faster."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops import flash_decode as fd

    d, live = 128, 2048
    takes_mma = fd.takes_mma
    g = torch.Generator(device="cuda").manual_seed(14)
    try:
        for h, kvh in ((28, 4), (64, 8), (64, 4)):
            group = h // kvh
            for dtype in (torch.float32, torch.bfloat16):
                kc = torch.randn(LAYERS, 1, S, kvh, d, generator=g, device="cuda").to(dtype)
                vc = torch.randn(LAYERS, 1, S, kvh, d, generator=g, device="cuda").to(dtype)
                q = torch.randn(1, 1, h, d, generator=g, device="cuda").to(dtype)
                lengths = fd.decode_lengths(1, live - 1, "cuda")
                want = fd.flash_decode_plain(q.float(), kc[0].float(), vc[0].float(), lengths)
                errs, times, tols = {}, {}, {}
                for mma in ((True, False) if dtype == torch.bfloat16 else (False,)):
                    fd.takes_mma = takes_mma if mma else (lambda *a, **k: False)
                    _, rows, rg = fd.decode_layout(dtype, dtype, 0, d, d, group)
                    name = f"{rg}x{rows}"
                    before = fd.flash_decode_attend.launches_mma
                    out = fd.flash_decode_attend(q, kc[0], vc[0], lengths, live)
                    torch.cuda.synchronize()
                    check(fd.flash_decode_attend.launches_mma == before + mma, f"{name}: launches_mma")
                    errs[name] = (out.float() - want).abs().max().item()
                    tols[name] = fd.MMA_TOL[dtype] if mma else TOL[dtype]
                    check(out.shape == q.shape and bool(torch.isfinite(out).all()), "wide-group decode output")
                    check(errs[name] <= tols[name], f"decode G={group} D=128 {name} {dtype}: max err {errs[name]}")
                    times[name] = device_time_ms(lambda l: fd.flash_decode_attend(q, kc[l], vc[l], lengths, live),
                                                 LAYERS)
                fd.takes_mma = takes_mma
                _, rows, rg = fd.decode_layout(dtype, dtype, 0, d, d, group)
                dispatch = f"{rg}x{rows}"
                qt = q.transpose(1, 2)
                size = torch.tensor([], dtype=dtype).element_size()
                t_mem = size * (2 * h * d + 2 * live * kvh * d) / HBM_BYTES_PER_S
                t_ops = 4 * h * d * live / PEAK_OPS_PER_S[dtype]
                emit({
                    "phase": "wide_group_decode", "kernel": "flash_decode", "gpu": gpu_line(),
                    "dtype": str(dtype).split(".")[-1], "live": live, "S": S, "H": h, "KVH": kvh, "G": group, "D": d,
                    "max_err": errs[dispatch], "max_err_by_layout": errs, "tol": tols[dispatch], "tol_by_layout": tols,
                    "kernel_ms": times[dispatch], "kernel_ms_by_layout": times, "dispatch": dispatch,
                    "tensor_cores": rows == 16, "faster": min(times, key=times.get),
                    "plain_ms": device_time_ms(
                        lambda l: fd.flash_decode_plain(q, kc[l], vc[l], lengths, max_live=live), LAYERS, 3),
                    "library_ms": device_time_ms(lambda l: sdpa(qt, kc[l, :, :live].transpose(1, 2),
                                                                vc[l, :, :live].transpose(1, 2), enable_gqa=True),
                                                 LAYERS),
                    "bound_ms": max(t_mem, t_ops) * 1e3, "bound_by": "bytes" if t_mem >= t_ops else "operations",
                })
                del kc, vc
    finally:
        fd.takes_mma = takes_mma
    torch.cuda.empty_cache()


def phase_wide_prefill() -> None:
    """The prefill kernel at (Dqk, Dv) = (128, 128) with Llama-3-8B's heads
    (H = 32, KVH = 8, G = 4; Qwen2.5-7B's and Qwen3's head width too): one
    chunk of T = 512 and one of 2,048 from pos 0 over a 4096-slot cache, in
    bf16 and f32, held to the plain version under TOL and timed beside it,
    SDPA (the masked form of the kernels rows, and is_causal) and its
    bound.  No served model of this script runs this width, so it is a line
    of its own, not a kernels row."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain

    h, kvh, d = 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(15)
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(LAYERS, 1, S, kvh, d, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, kvh, d, generator=g, device="cuda").to(dtype)
        for T in (512, 2048):
            q = torch.randn(1, T, h, d, generator=g, device="cuda").to(dtype)
            out = flash_prefill(q, kc[0], vc[0], 0)
            torch.cuda.synchronize()
            want = flash_prefill_plain(q.float(), kc[0].float(), vc[0].float(), 0)
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "wide prefill output")
            check(err <= TOL[dtype], f"prefill (128, 128) T={T} {dtype}: max err {err}")
            qt = q.transpose(1, 2)
            mask = torch.arange(T, device="cuda")[None, :] <= torch.arange(T, device="cuda")[:, None]

            def lib(l, causal=False):
                return sdpa(qt, kc[l, :, :T].transpose(1, 2), vc[l, :, :T].transpose(1, 2),
                            attn_mask=None if causal else mask, is_causal=causal, enable_gqa=True)

            bound, by = prefill_bound(T, 0, dtype, h, kvh, d)
            row = {
                "phase": "wide_prefill", "kernel": "flash_prefill", "dtype": str(dtype).split(".")[-1],
                "T": T, "pos": 0, "S": S, "H": h, "KVH": kvh, "Dqk": d, "Dv": d, "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(lambda l: flash_prefill(q, kc[l], vc[l], 0), LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_prefill_plain(q, kc[l], vc[l], 0), LAYERS, 3),
                "library_ms": device_time_ms(lib, LAYERS),
                "library_causal_ms": device_time_ms(lambda l: lib(l, True), LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            emit(row)
        del kc, vc
    torch.cuda.empty_cache()


def quant_decode_bound(lengths: list, qbits: int, dtype, kv_dtype=None) -> tuple:
    """(ms, bound_by) for one decode call over a cache whose lanes hold
    `lengths` live slots: q and the output once (in `dtype`), each live
    slot's K and V once as the cache stores them (`kv_dtype` values, q's
    dtype by default, or codes plus a 4-byte f32 scale per slot and KV
    head); 4*D operations per (head, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    kv_size = torch.tensor([], dtype=kv_dtype or dtype).element_size()
    live = sum(lengths)
    row = {0: D * kv_size, 8: D + 4, 4: D // 2 + 4}[qbits]  # bytes per (slot, KV head)
    nbytes = 2 * len(lengths) * H * D * size + 2 * live * KVH * row
    return bytes_ops_bound(nbytes, 4 * H * D * live, dtype)


def phase_quant_kernels(main_pos: int, lane_positions: list) -> dict:
    """The decode kernel's quantized variants at the serve mix (B=1, S=4096,
    KVH=8, D=64, G=4, bf16 q; f32 q at the main position too), on caches
    the port's write_kv quantized from bf16 rows, against the plain version
    on the same codes; and the plain kernel with a lengths vector at the
    batch_serve lanes' positions (bf16, f32, and f32 q over a bf16 cache).
    Library yardstick: scaled_dot_product_attention over an
    already-dequantized bf16 copy of the live prefix (the dequant is not
    timed).  Returns the main rows."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, read_kv, write_kv
    from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    main = {}
    for bits in (8, 4):
        kv = init_cache(KVConfig(LAYERS, 1, S, KVH, D, quant_bits=bits), torch.device("cuda"))
        layers = [layer_slices(kv, l) for l in range(LAYERS)]
        for kvs in layers:
            write_kv(kvs, torch.randn(1, S, KVH, D, generator=g, device="cuda").to(torch.bfloat16),
                     torch.randn(1, S, KVH, D, generator=g, device="cuda").to(torch.bfloat16), 0)
        cases = [(torch.bfloat16, p) for p in dict.fromkeys([0, 255, 4095, main_pos])]
        for dtype, pos in cases + [(torch.float32, main_pos)]:
            q = torch.randn(1, 1, H, D, generator=g, device="cuda").to(dtype)
            lengths = decode_lengths(1, pos, "cuda")

            def kern(l):
                c = layers[l]
                return flash_decode_attend(q, c["k"], c["v"], lengths, pos + 1, k_scale=c["k_scale"],
                                           v_scale=c["v_scale"])

            def plain(l):
                c = layers[l]
                return flash_decode_plain(q, c["k"], c["v"], lengths, k_scale=c["k_scale"], v_scale=c["v_scale"],
                                          max_live=pos + 1)

            out = kern(0)
            torch.cuda.synchronize()
            want = flash_decode_plain(q.float(), layers[0]["k"], layers[0]["v"], lengths,
                                      k_scale=layers[0]["k_scale"], v_scale=layers[0]["v_scale"])
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all()), "q decode output")
            check(err <= TOL[dtype], f"decode q{bits} pos={pos} {dtype}: max err {err}")
            # the yardstick reads a dequantized bf16 copy of each layer's live prefix
            deq = [tuple(t.to(torch.bfloat16).transpose(1, 2).contiguous() for t in read_kv(c, upto=pos + 1))
                   for c in layers]
            qt = q.to(torch.bfloat16).transpose(1, 2)

            def lib(l):
                return sdpa(qt, deq[l][0], deq[l][1], enable_gqa=True)

            def lib_causal(l):
                return sdpa(qt, live[l][0], live[l][1], is_causal=True, scale=scale)

            lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
            check(lib_err <= TOL[torch.bfloat16], f"q{bits} library yardstick disagrees: {lib_err}")
            bound, by = quant_decode_bound([pos + 1], bits, dtype)
            row = {
                "phase": "kernels", "kernel": f"flash_decode_q{bits}", "dtype": str(dtype).split(".")[-1],
                "pos": pos, "S": S, "H": H, "KVH": KVH, "D": D, "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(kern, LAYERS), "plain_ms": device_time_ms(plain, LAYERS, 3),
                "library_ms": device_time_ms(lib, LAYERS),
                "library_call": "scaled_dot_product_attention on a dequantized bf16 copy of the live prefix "
                                "(the dequant is not timed)",
                "library_max_err": lib_err, "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if dtype == torch.bfloat16 and pos == main_pos:
                main[f"flash_decode_q{bits}"] = row
            del deq
        del kv, layers
    # the plain variant with one lane per batch_serve request, at its
    # position: bf16 (the batch_serve mix), f32 (where one length off by one
    # would show) and an f32 q over a bf16 cache (DNET_KV_BITS=16 on an f32
    # model); the library call reads the cache in q's dtype (the upcast is
    # not timed)
    B = len(lane_positions)
    lengths = torch.tensor([p + 1 for p in lane_positions], dtype=torch.int32, device="cuda")
    max_live = max(lane_positions) + 1
    j = torch.arange(max_live, device="cuda")
    mask = (j[None, :] < lengths.long()[:, None])[:, None, None, :]
    for dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16)):
        kc = torch.randn(LAYERS, B, S, KVH, D, generator=g, device="cuda").to(kv_dtype)
        vc = torch.randn(LAYERS, B, S, KVH, D, generator=g, device="cuda").to(kv_dtype)
        q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
        out = flash_decode_attend(q, kc[0], vc[0], lengths, max_live)
        torch.cuda.synchronize()
        want = flash_decode_plain(q.float(), kc[0].float(), vc[0].float(), lengths)
        err = (out.float() - want).abs().max().item()
        check(out.dtype == dtype and bool(torch.isfinite(out).all()) and err <= TOL[dtype],
              f"decode lengths vector, {dtype} q over a {kv_dtype} cache: max err {err}")
        kt, vt = (c[:, :, :max_live].transpose(2, 3).to(dtype) for c in (kc, vc))
        qt = q.transpose(1, 2)
        bound, by = quant_decode_bound([p + 1 for p in lane_positions], 0, dtype, kv_dtype)
        emit({
            "phase": "kernels", "kernel": "flash_decode", "dtype": str(dtype).split(".")[-1],
            "cache_dtype": str(kv_dtype).split(".")[-1], "lengths": lengths.tolist(),
            "lanes": B, "S": S, "H": H, "KVH": KVH, "D": D, "max_err": err, "tol": TOL[dtype],
            "kernel_ms": device_time_ms(lambda l: flash_decode_attend(q, kc[l], vc[l], lengths, max_live),
                                        LAYERS),
            "plain_ms": device_time_ms(lambda l: flash_decode_plain(q, kc[l], vc[l], lengths, max_live=max_live),
                                       LAYERS, 5),
            "library_ms": device_time_ms(lambda l: sdpa(qt, kt[l], vt[l], attn_mask=mask, enable_gqa=True),
                                         LAYERS),
            "library_call": "scaled_dot_product_attention with a per-lane length mask",
            "bound_ms": bound, "bound_by": by,
        })
        del kc, vc, kt, vt
    torch.cuda.empty_cache()
    return main


def _small_model(layers: int = 2):
    """The parity phases' model: small, f32, with the kernels' head dim."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_params

    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256,
        "intermediate_size": 512, "num_hidden_layers": layers, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64, "rope_theta": 500000.0,
        "tie_word_embeddings": True,
    })
    window, edge = random_llama_params(cfg, range(layers), torch.device("cpu"), torch.float32, seed=1)
    return cfg, window, edge


def phase_parity() -> None:
    """The engine on the GPU (kernels) against the engine on the CPU (plain
    versions), same f32 weights: a small model with the kernels' head dim."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    cfg, window, edge = _small_model()
    engines = {
        dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev)
        for dev in ("cuda", "cpu")
    }
    prompt = list(range(1, 70))
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, 512), "parity logits")
    check(err <= 2e-3, f"GPU vs CPU prefill logits: max err {err}")
    streams = {
        dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
        for dev, e in engines.items()
    }
    check(streams["cuda"] == streams["cpu"], f"greedy streams differ: {streams}")
    emit({"phase": "parity", "logits_max_err": err, "tol": 2e-3, "greedy_tokens": len(streams["cuda"])})


def phase_quant_parity() -> None:
    """The quantized caches and a bf16 cache under f32 params on the GPU
    (the q8 / q4 decode kernels, the f32 prefill kernel over the
    dequantized or upcast prefix) against the CPU (plain versions), same
    f32 weights: the single-sequence engine as phase_parity runs it, and
    dense batched slots (4 ragged prompts, 8 steps, the last 4 as one
    chunk); the bf16 cache also over paged + ragged slots."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg, window, edge = _small_model()
    prompt = list(range(1, 70))
    prompts = {f"p{n}": [(7 * i + n) % 500 + 1 for i in range(n)] for n in (5, 17, 40, 69)}
    decode_kernels = ("flash_decode", "flash_decode_q8", "flash_decode_q4")
    for kv_dtype, bits in ((None, 8), (None, 4), ("bfloat16", 0)):
        form = f"q{bits}" if bits else f"{kv_dtype} cache"
        kernel = f"flash_decode_q{bits}" if bits else "flash_decode"
        kw = dict(max_seq=256, param_dtype="float32", kv_dtype=kv_dtype, kv_quant_bits=bits)
        engines = {dev: LocalEngine.from_params(cfg, window, edge, device=dev, **kw) for dev in ("cuda", "cpu")}
        reset_launch_counts()
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(bool(torch.isfinite(logits["cuda"]).all()), f"{form} parity logits")
        check(err <= 2e-3, f"{form} GPU vs CPU prefill logits: max err {err}")
        streams = {
            dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
            for dev, e in engines.items()
        }
        check(streams["cuda"] == streams["cpu"], f"{form} greedy streams differ: {streams}")
        torch.cuda.synchronize()
        single = launch_counts()
        check(single[kernel] == cfg.num_hidden_layers * 15
              and all(single[k] == 0 for k in decode_kernels if k != kernel),
              f"{form} parity launches {single}")
        dec = DecodingParams(logprobs=True)
        batched = {}
        modes = {"dense": {}}
        if not bits:  # the ragged paged kernel refuses quantized pools
            modes["paged"] = dict(PAGED_ENV, DNET_KV_BLOCK_TOKENS="8")
        for mode, env in modes.items():
            got = {}
            for dev in ("cuda", "cpu"):
                with environ(env):
                    eng = BatchedEngine.from_params(cfg, window, edge, slots=4, device=dev, **kw)
                toks = {n: [int(eng.prefill_and_sample(n, ids, dec).token[0])] for n, ids in prompts.items()}
                lps = {n: [] for n in prompts}
                for step in range(8):
                    out, errs = eng.decode_batch({n: (t[-1], dec) for n, t in toks.items()},
                                                 budgets={n: 8 - step for n in prompts} if step >= 4 else None)
                    check(not errs, f"{mode} {form} batched errors: {errs}")
                    for n, r in out.items():
                        toks[n].append(int(r.token[0]))
                        lps[n].append(float(r.logprob[0]))
                got[dev] = (toks, lps, eng.decode_steps)
                eng.close()
            check(got["cuda"][0] == got["cpu"][0], f"{mode} {form} batched greedy streams differ: {got}")
            lp_err = max(abs(a - b) for n in prompts for a, b in zip(got["cuda"][1][n], got["cpu"][1][n]))
            check(lp_err <= 2e-3, f"{mode} {form} batched logprobs differ by {lp_err}")
            batched[mode] = {"slots": 4, "decode_steps": got["cuda"][2], "logprob_max_err": lp_err}
        emit({"phase": "quant_parity", "kv_bits": bits or 16, "kv_dtype": kv_dtype or "float32",
              "logits_max_err": err, "tol": 2e-3, "greedy_tokens": len(streams["cuda"]), "launches": single,
              "batched": batched})


def phase_batch_parity() -> None:
    """The batched engine on the GPU (paged kernel) against the batched
    engine on the CPU (plain version), same f32 weights: four prompts of
    ragged lengths across 8-token block edges decoded together, by single
    steps and then by one budgeted 8-step chunk."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    cfg, window, edge = _small_model()
    prompts = {f"p{n}": [(7 * i + n) % 500 + 1 for i in range(n)] for n in (5, 17, 40, 69)}
    dec = DecodingParams(logprobs=True)
    streams = {}
    for dev in ("cuda", "cpu"):
        with environ(dict(PAGED_ENV, DNET_KV_BLOCK_TOKENS="8")):
            eng = BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=256,
                                            param_dtype="float32", device=dev)
        paged_attend.launches = 0
        got = {}
        for n, ids in prompts.items():
            r = eng.prefill_and_sample(n, ids, dec)
            got[n] = [(int(r.token[0]), float(r.logprob[0]))]
        for step in range(16):
            reqs = {n: (got[n][-1][0], dec) for n in prompts}
            out, errs = eng.decode_batch(reqs, budgets={n: 16 - step for n in reqs} if step >= 8 else None)
            check(not errs, f"batched decode errors: {errs}")
            for n, r in out.items():
                got[n].append((int(r.token[0]), float(r.logprob[0])))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = paged_attend.launches
            steps = eng.decode_steps
        for n in prompts:
            eng.end_session(n)
        eng.kv_pool.check_conservation([])
        streams[dev] = got
    check(launches == cfg.num_hidden_layers * steps and steps == 16,
          f"paged launches {launches} for {steps} batched steps")
    toks = {dev: {n: [t for t, _ in s] for n, s in got.items()} for dev, got in streams.items()}
    check(toks["cuda"] == toks["cpu"], f"batched greedy streams differ: {toks}")
    err = max(abs(a[1] - b[1]) for n in prompts for a, b in zip(streams["cuda"][n], streams["cpu"][n]))
    check(err <= 2e-3, f"batched logprobs differ by {err}")
    emit({"phase": "batch_parity", "slots": 4, "bt": 8, "prompt_tokens": [len(p) for p in prompts.values()],
          "tokens_per_stream": len(toks["cuda"]["p5"]), "logprob_max_err": err, "tol": 2e-3,
          "paged_launches": launches, "decode_steps": steps})


def _batch_prompts() -> list:
    """Chat contents whose templated prompts are BATCH_PROMPT_TOKENS long
    under the byte tokenizer (distinct texts, so no two requests agree)."""
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    overhead = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": ""}])))
    rng = random.Random(0)
    words = ["GPU", "memory", "kernel", "block", "page", "table", "slot", "token", "batch", "cache"]
    out = []
    for i, n in enumerate(BATCH_PROMPT_TOKENS):
        text = f"Request {i}: " + " ".join(rng.choice(words) for _ in range(n))
        out.append(text[: n - overhead])
    return out


def phase_batch_step(cfg, window, edge, prompt_lens: list) -> dict:
    """Where one batched decode step's time goes at 8 active lanes (the
    batch_serve prompts, single steps): synchronised wall, host issue,
    device busy per step from torch.profiler, and the paged kernel's share
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams

    with environ(PAGED_ENV):
        eng = BatchedEngine.from_params(cfg, window, edge, slots=BATCH_SLOTS, max_seq=S, device="cuda")
    d = DecodingParams()
    last = {}
    for i, n in enumerate(prompt_lens):
        last[f"s{i}"] = int(eng.prefill_and_sample(f"s{i}", [(t % 250) + 1 for t in range(n)], d).token[0])

    def step():
        out, errs = eng.decode_batch({k: (t, d) for k, t in last.items()})
        check(not errs, f"batched step errors: {errs}")
        for k, r in out.items():
            last[k] = int(r.token[0])

    for _ in range(5):
        step()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        step()  # ends on the step's one device-to-host read
        wall.append((time.perf_counter() - t0) * 1e3)
        issue.append(eng.last_dispatch_ms)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    paged_ms = sum(e.self_device_time_total for e in kernels if "paged_" in e.name) / 1e3 / steps
    wall_ms = statistics.median(wall)
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += edge["embed"]["weight"].numel() * edge["embed"]["weight"].element_size()
    pos = [int(eng.pos[eng.slot_of[k]]) for k in last]
    kv_bytes = 2 * LAYERS * sum(pos) * KVH * D * eng.kv_store.kv["k"].element_size()
    row = {"phase": "batch_step", "gpu": gpu_line(), "active_lanes": len(last), "positions": pos,
           "steps": len(wall), "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue),
           "device_busy_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
           "paged_kernel_ms": paged_ms, "kernel_launches": len(kernels) // steps,
           "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
           "bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
           "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    emit(row)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return row


def _post(url: str, body: dict) -> dict:
    stream = body.get("stream", False)
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        if not stream:
            data = json.loads(resp.read())
            return {"status": status, "body": data, "s": time.perf_counter() - t0,
                    "content": data["choices"][0]["message"]["content"],
                    "tokens": data["usage"]["completion_tokens"]}
        content, t_first, tokens, arrivals = [], None, None, []
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            ev = json.loads(line[len("data: "):])
            check("error" not in ev, f"stream error event: {ev.get('error')}")
            for c in ev["choices"]:
                if c["delta"].get("content"):
                    t_first = t_first or time.perf_counter()
                    arrivals.append(time.perf_counter())
                    content.append(c["delta"]["content"])
            if ev.get("usage"):
                tokens = ev["usage"]["completion_tokens"]
        t_end = time.perf_counter()
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
        return {"status": status, "s": t_end - t0, "ttft_s": (t_first or t_end) - t0,
                "content": "".join(content), "tokens": tokens,
                "decode_s": t_end - (t_first or t_end), "t0": t0, "t_first": t_first, "t_end": t_end,
                "gap_median_s": statistics.median(gaps) if gaps else None,
                "gap_max_s": max(gaps) if gaps else None}


async def _drive(args: Namespace, requests: list, concurrent: bool = False, then: Sequence = (),
                 sched: bool = False) -> list:
    """Serve args' model in this process and send `requests` (in order, or
    all at once), then the `then` requests in order (a callable there is
    called with the results so far and returns its body); returns the
    results, the kernels' launches during the requests, the load time and
    /health after them (with `sched`, /v1/debug/sched under "sched")."""
    from dnet_tpu_torch.api.server import serve_async
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    loop = asyncio.get_running_loop()
    server = asyncio.ensure_future(serve_async(args))
    base = f"http://127.0.0.1:{args.http_port}"
    t0 = time.perf_counter()
    while True:
        check(not server.done(), "server exited during start-up")
        try:
            health = await loop.run_in_executor(
                None, lambda: json.loads(urllib.request.urlopen(base + "/health", timeout=5).read())
            )
            if health.get("model"):
                break
        except OSError:
            pass
        check(time.perf_counter() - t0 < 600, "server not ready within 600 s")
        await asyncio.sleep(0.5)
    load_s = time.perf_counter() - t0
    url = base + "/v1/chat/completions"
    try:
        reset_launch_counts()
        if concurrent:
            results = await asyncio.gather(
                *(loop.run_in_executor(None, _post, url, body) for body in requests))
        else:
            results = []
            for body in requests:
                results.append(await loop.run_in_executor(None, _post, url, body))
        for body in then:
            body = body(results) if callable(body) else body
            results.append(await loop.run_in_executor(None, _post, url, body))
        torch.cuda.synchronize()
        launches = launch_counts()
        health = await loop.run_in_executor(
            None, lambda: json.loads(urllib.request.urlopen(base + "/health", timeout=5).read()))
        if sched:
            health["sched"] = await loop.run_in_executor(
                None, lambda: json.loads(urllib.request.urlopen(base + "/v1/debug/sched", timeout=5).read()))
    finally:
        if not server.done():
            signal.raise_signal(signal.SIGTERM)  # the server's own shutdown path
        await server
        # the app and its engine sit in reference cycles: free the weights
        # before the next phase loads its own
        gc.collect()
        torch.cuda.empty_cache()
    return results, launches, load_s, health


def phase_step(cfg, window, edge, n_prompt: int, kv_quant_bits: int = 0) -> None:
    """Where a full-width greedy decode step's time goes: the synchronised
    wall time of a step, the host's time to issue its launches, and the
    device's busy time per step from torch.profiler (kernel time summed),
    with the attention kernels' share of it; over a bf16 cache, or an int8
    / int4 one (`kv_quant_bits`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    eng = LocalEngine.from_params(cfg, window, edge, max_seq=S, device="cuda", kv_quant_bits=kv_quant_bits)
    d = DecodingParams()
    tok = int(eng.prefill_and_sample("s", list(range(1, n_prompt + 1)), d).token[0])
    for _ in range(5):
        eng.decode_step("s", tok, d)
    torch.cuda.synchronize()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.decode_step("s", tok, d)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode_step("s", tok, d)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    attn_ms = sum(e.self_device_time_total for e in kernels if "flash_" in e.name) / 1e3 / steps
    wall_ms = statistics.median(wall)
    # a step reads every weight once: its bound at the memory rate
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += edge["embed"]["weight"].numel() * edge["embed"]["weight"].element_size()
    emit({"phase": "step", "kv_bits": kv_quant_bits, "steps": len(wall), "pos": eng.sessions["s"].pos,
          "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue),
          "device_busy_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
          "attention_kernels_ms": attn_ms, "kernel_launches": len(kernels) // steps,
          "weight_bytes": weight_bytes, "bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3})
    eng.end_session("s")


def phase_serve(prompt_text: str, n_prompt: int) -> tuple:
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG, random_llama_params

    tmp = os.path.join(tempfile.mkdtemp(prefix="dnet-torch-smoke-"), "llama-3.2-1b-synthetic")
    try:
        t0 = time.perf_counter()
        cfg = ModelConfig.from_hf(LLAMA_3_2_1B_CONFIG)
        window, edge = random_llama_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"),
                                           torch.bfloat16, seed=0)
        # bf16 and int8 caches in turns: host times drift within a run
        for bits in (0, 8, 8, 0):
            phase_step(cfg, window, edge, n_prompt, bits)
        batch_step = phase_batch_step(cfg, window, edge, BATCH_PROMPT_TOKENS)
        sp_step = phase_sp_step(cfg, window, edge)
        save_checkpoint(tmp, LLAMA_3_2_1B_CONFIG, hf_tensors(window, edge))
        del window, edge
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        args = Namespace(
            host="127.0.0.1", http_port=port, model=tmp, models_dir="", device="cuda",
            max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
        )
        chat = {"model": "llama-3.2-1b-synthetic", "max_tokens": MAX_TOKENS, "temperature": 0,
                "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
        sampled = dict(chat, temperature=0.8, top_p=0.95, seed=1234)
        bodies = [{"greedy": chat, "streamed": dict(chat, stream=True), "sampled": sampled}[k] for k in SERVE_KINDS]
        results, launches, load_s, health = asyncio.run(_drive(args, bodies))
        row = serve_row(results, launches, write_s, load_s)
        batched = phase_batch_serve(tmp, port, batch_step)
        phase_sched_serve(tmp, port, batched)
        quant = phase_quant_serve(tmp, port, bodies, row, batched)
        gathered = phase_gather_serve(tmp, port, batched)
        long_body = dict(chat, stream=True, messages=[{"role": "user", "content": _batch_prompts()[-1]}])
        ring, _, lossless = phase_ring_serve(tmp, bodies, results, row, long_body, quant)
        phase_stream_serve(tmp, bodies, results, row, lossless)
        sp_long = dict(chat, stream=True, messages=[{"role": "user", "content": _long_prompt(SP_LONG_TOKENS)}])
        sp_serve = phase_sp_serve(tmp, port, bodies, sp_long, sp_step)
        phase_wq_serve(tmp, port, bodies, row, health["engine"]["weight_bytes"], batched)
        spec = phase_spec_serve(tmp, port)
    finally:
        shutil.rmtree(os.path.dirname(tmp), ignore_errors=True)
    return row, batched, quant, ring, sp_serve, gathered, spec


# the serve and ring_serve requests: one greedy, one greedy streamed (its
# TTFT and decode rate) and one seeded sampled
SERVE_KINDS = ("greedy", "streamed", "sampled")


def streamed_rates(results: list) -> dict:
    """Median TTFT and decode rate of the streamed requests."""
    runs = [r for k, r in zip(SERVE_KINDS, results) if k == "streamed"]
    rates = [(r["tokens"] - 1) / max(r["decode_s"], 1e-9) for r in runs]
    return {"streamed_ttft_s": statistics.median(r["ttft_s"] for r in runs),
            "streamed_decode_tokens_per_s": statistics.median(rates),
            "streamed_runs": [{"ttft_s": r["ttft_s"], "decode_tokens_per_s": v} for r, v in zip(runs, rates)]}


def serve_row(results: list, launches: dict, write_s: float, load_s: float) -> dict:
    """Check the single-sequence serve's requests and launch counts; emit its line."""
    for name, r in zip(SERVE_KINDS, results):
        check(r["status"] == 200, f"{name} request: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"{name} request: empty or short completion")
        check(name != "streamed" or r["content"] == results[0]["content"],
              "streamed content differs from the non-streamed")
    n_prefill = len(results)
    # every decode step runs the 16 layers; a chunk dispatched past the
    # budget never happens (widths are capped by max_tokens)
    decode_steps = sum(r["tokens"] - 1 for r in results)
    check(launches["flash_prefill"] == LAYERS * n_prefill,
          f"prefill launches {launches['flash_prefill']} != {LAYERS} x {n_prefill} prefills")
    check(launches["flash_decode"] == LAYERS * decode_steps,
          f"decode launches {launches['flash_decode']} != {LAYERS} x {decode_steps} steps")
    row = {
        "phase": "serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
        "checkpoint_write_s": write_s, "load_s": load_s, "launches": launches,
        "prefills": n_prefill, "decode_steps": decode_steps,
        "requests": [
            {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
             "tokens_per_s": r["tokens"] / r["s"], "content_head": r["content"][:40]}
            for k, r in zip(SERVE_KINDS, results)
        ],
        **streamed_rates(results),
    }
    emit(row)
    return row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> dict:
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


def _post_json(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


async def _drive_ring(args: Namespace, model_dir: str, bodies: list, shard_urls: list, kv_bits: int = 0,
                      windows: Sequence[dict] = ({}, {})) -> tuple:
    """The API node in this process in ring mode: prepare the manual
    topology (each assignment with its `windows` entry: window_size /
    residency_size), fan the load out to the shards, send `bodies` in
    order; returns (results, load seconds, each shard's /health after the
    first request, which warms the shards up)."""
    from dnet_tpu_torch.api.server import serve_async

    loop = asyncio.get_running_loop()
    server = asyncio.ensure_future(serve_async(args))
    base = f"http://127.0.0.1:{args.http_port}"
    t0 = time.perf_counter()
    try:
        while True:
            check(not server.done(), "ring API exited during start-up")
            try:
                await loop.run_in_executor(None, _get, base + "/health")
                break
            except OSError:
                check(time.perf_counter() - t0 < 120, "ring API not up within 120 s")
                await asyncio.sleep(0.3)
        topo = await loop.run_in_executor(None, _post_json, base + "/v1/prepare_topology_manual", {
            "model": model_dir,
            "assignments": [{"instance": f"s{i}", "layers": ls, **w}
                            for i, (ls, w) in enumerate(zip(RING_LAYERS, windows))],
            "kv_bits": kv_bits,
        })
        check([a["next_instance"] for a in topo["topology"]["assignments"]] == ["s1", "s0"], f"ring {topo}")
        t_load = time.perf_counter()
        await loop.run_in_executor(None, _post_json, base + "/v1/load_model", {"model": model_dir})
        load_s = time.perf_counter() - t_load
        results, warm = [], None
        for body in bodies:
            results.append(await loop.run_in_executor(None, _post, base + "/v1/chat/completions", body))
            if warm is None:
                warm = [await loop.run_in_executor(None, _get, u + "/health") for u in shard_urls]
    finally:
        if not server.done():
            signal.raise_signal(signal.SIGTERM)  # the server's own shutdown path
        await server
    return results, load_s, warm


def _ring_pass(model_dir: str, codec: str, bodies: list, logdir: str, kv_bits: int = 0, tag: str = "",
               windows: Sequence[dict] = ({}, {})) -> tuple:
    """Start the two shard processes on the card, serve `bodies` through
    them with the hop codec `codec`, the topology's `kv_bits` and each
    shard's `windows` entry (its weight plan), read each shard's /health,
    and stop the shards; returns (results, [s0 health, s1 health], load
    seconds, the /health pair after the first request).  `tag` names the
    pass's hostfile and shard logs (default: codec and kv_bits); a
    streaming shard's repack cache goes under `logdir`."""
    env = dict(os.environ, DNET_WIRE_CODEC=codec, DNET_SHARD_REPACK_DIR=os.path.join(logdir, "repack"), **RING_ENV)
    shards = [(f"s{i}", _free_port(), _free_port()) for i in range(len(RING_LAYERS))]
    tag = tag or f"{codec}-kv{kv_bits}"
    hostfile = os.path.join(logdir, f"hostfile-{tag}")
    with open(hostfile, "w") as f:
        f.writelines(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in shards)
    procs, logs = [], []
    try:
        for name, http, grpc_port in shards:
            logs.append(os.path.join(logdir, f"shard-{tag}-{name}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dnet_tpu_torch.cli.shard", "--host", "127.0.0.1",
                     "--http-port", str(http), "--grpc-port", str(grpc_port), "--shard-name", name,
                     "--device", "cuda"],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        for (name, http, _), proc in zip(shards, procs):
            while True:
                check(proc.poll() is None, f"shard {name} exited with {proc.returncode}")
                try:
                    health = _get(f"http://127.0.0.1:{http}/health")
                    break
                except OSError:
                    check(time.perf_counter() - t0 < 120, f"shard {name} not up within 120 s")
                    time.sleep(0.3)
            # a fresh process: every launch count starts at 0
            check(not any(health["kernels"].values()), f"shard {name} counts not 0: {health['kernels']}")
        args = Namespace(
            host="127.0.0.1", http_port=_free_port(), grpc_port=_free_port(), hostfile=hostfile, model="",
            models_dir="", device="cuda", max_seq_len=S, param_dtype="bfloat16", max_concurrent=8,
            request_timeout_s=600.0,
        )
        with environ({"DNET_WIRE_CODEC": codec, **RING_ENV}):  # the API resolves the hop codec
            urls = [f"http://127.0.0.1:{http}" for _, http, _ in shards]
            results, load_s, warm = asyncio.run(_drive_ring(args, model_dir, bodies, urls, kv_bits, windows))
        healths = [_get(u + "/health") for u in urls]
    except Exception:
        for path in logs:
            with open(path) as f:
                print(f"--- {path} ---\n{f.read()[-4000:]}", file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return results, healths, load_s, warm


def _steady(after: dict, before: dict, requests: list) -> dict:
    """Per-frame host times on one shard over `requests` (all but the
    first, warm-up request): its compute thread's time per frame, and the
    hop encode and decode per single-row hop and per prompt frame."""
    frames = after["compute"]["frames"] - before["compute"]["frames"]
    hops = sum(r["tokens"] - 1 for r in requests)
    w = {k: after["wire"][k] - before["wire"][k] for k in after["wire"]}
    return {"compute_ms_per_frame": (after["compute"]["ms"] - before["compute"]["ms"]) / frames,
            "hop_encode_ms": w["hop_encode_ms"] / hops, "hop_decode_ms": w["hop_decode_ms"] / hops,
            "prompt_encode_ms": w["prompt_encode_ms"] / len(requests),
            "prompt_decode_ms": w["prompt_decode_ms"] / len(requests)}


def phase_ring_serve(model_dir: str, bodies: list, serve_results: list, served: dict, long_body: dict,
                     quant: dict) -> tuple:
    """The checkpoint served as a two-shard ring: lossless, qsparse8, then
    lossless with kv_bits 8 in the topology (an int8 cache on each shard);
    returns the qsparse8 pass's column-kernel launches, the kv_bits 8
    pass's row and the lossless pass's."""
    greedy, sampled = serve_results[0], serve_results[2]
    passes = (
        ("lossless", 0, SERVE_KINDS, bodies),
        ("qsparse8", 0, SERVE_KINDS + ("long_prompt_streamed",), bodies + [long_body]),
        # greedy, streamed and seeded sampled: the q8 single-process serve's
        ("lossless", 8, SERVE_KINDS[:3], bodies[:3]),
    )
    out, ring_q8, lossless = {}, None, None
    for codec, kv_bits, kinds, reqs in passes:
        results, (h0, h1), load_s, warm = _ring_pass(model_dir, codec, reqs, os.path.dirname(model_dir), kv_bits)
        for i, r in enumerate(results):
            check(r["status"] == 200, f"ring {codec} request {i}: HTTP {r['status']}")
            check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"ring {codec} request {i}: {r['tokens']} tokens")
        for k, r in zip(kinds, results):
            check(k != "streamed" or r["content"] == results[0]["content"],
                  f"ring {codec}: streamed differs from non-streamed")
        if codec == "lossless" and kv_bits == 0:
            check(results[0]["content"] == greedy["content"], "ring greedy text differs from the serve phase's")
            check(results[2]["content"] == sampled["content"], "ring seeded sampled text differs from the serve phase's")
        if kv_bits == 8:
            q8 = quant[8]["results"]
            check(results[0]["content"] == q8[0]["content"], "ring kv_bits 8 greedy text differs from quant_serve's")
            check(results[2]["content"] == q8[2]["content"],
                  "ring kv_bits 8 seeded sampled text differs from quant_serve's")
        k0, k1, w0, w1 = h0["kernels"], h1["kernels"], h0["wire"], h1["wire"]
        steps = sum(r["tokens"] for r in results)  # one hidden frame per generated token
        n_layers = len(RING_LAYERS[0])
        check(w0["frames_encoded"] == w1["frames_decoded"] == steps, f"ring {codec} hidden frames {w0} {w1}")
        check(w0["bytes_encoded"] == w1["bytes_decoded"], f"ring {codec} hidden bytes {w0} {w1}")
        decode = "flash_decode_q8" if kv_bits == 8 else "flash_decode"
        for k in (k0, k1):
            check(k["flash_prefill"] == n_layers * len(results), f"ring {codec} prefill launches {k}")
            check(k[decode] == n_layers * (steps - len(results)), f"ring {codec} kv{kv_bits} decode launches {k}")
            check(k["flash_decode"] + k["flash_decode_q8"] + k["flash_decode_q4"] == k[decode],
                  f"ring {codec} kv{kv_bits}: another decode variant launched {k}")
        if codec == "qsparse8":
            check(k0["column_sq_norms"] == k0["gather_columns"] == w0["frames_encoded"],
                  f"s0 column kernel launches {k0} != encoded frames {w0['frames_encoded']}")
            check(k1["dequant_scatter_columns"] == w1["frames_decoded"],
                  f"s1 dequant_scatter launches {k1} != decoded frames {w1['frames_decoded']}")
            check(k1["column_sq_norms"] == k1["gather_columns"] == k0["dequant_scatter_columns"] == 0,
                  "column kernels launched on the wrong shard")
        else:
            check(not any(k[n] for k in (k0, k1) for n in ("column_sq_norms", "gather_columns",
                                                           "dequant_scatter_columns")),
                  "a column kernel launched under the lossless codec")
        row = {
            "phase": "ring_serve", "codec": codec, "kv_bits": kv_bits, "gpu": gpu_line(),
            "transport": "real gRPC on 127.0.0.1: one process per shard, the API node in this process",
            "layers": [f"{ls[0]}-{ls[-1]}" for ls in RING_LAYERS], "load_s": load_s,
            "decode_hop_bytes": w0["decode_hop_bytes"], "wire": {"s0": w0, "s1": w1},
            # steady-state host times per frame on each shard (s0 encodes,
            # s1 decodes), the warm-up request left out
            "steady": {f"s{i}": _steady(h, w, results[1:]) for i, (h, w) in enumerate(zip((h0, h1), warm))},
            "launches": {"s0": k0, "s1": k1}, "decode_steps": steps - len(results),
            "requests": [
                {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
                 "content_head": r["content"][:40]}
                for k, r in zip(kinds, results)
            ],
            "single_process": {k: served[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
        }
        if "streamed" in kinds:
            row.update(streamed_rates(results))
        if codec == "qsparse8":
            long = results[-1]
            row["long_prompt"] = {"prompt_tokens": BATCH_PROMPT_TOKENS[-1], "ttft_s": long["ttft_s"],
                                  "decode_tokens_per_s": (long["tokens"] - 1) / max(long["decode_s"], 1e-9)}
            out = {"column_sq_norms": k0["column_sq_norms"], "gather_columns": k0["gather_columns"],
                   "dequant_scatter_columns": k1["dequant_scatter_columns"]}
        if kv_bits == 8:
            ring_q8 = row
        elif codec == "lossless":
            lossless = row
        emit(row)
    return out, ring_q8, lossless


def _batch_args(model_dir: str, port: int) -> Namespace:
    return Namespace(
        host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
        max_seq_len=S, param_dtype="bfloat16", max_concurrent=BATCH_SLOTS, request_timeout_s=600.0,
        batch_slots=BATCH_SLOTS,
    )


def _batch_bodies() -> list:
    """The batched burst: 8 streamed requests of BATCH_PROMPT_TOKENS, one
    sampled with a seed."""
    bodies = [
        {"model": "llama-3.2-1b-synthetic", "max_tokens": MAX_TOKENS, "temperature": 0, "stream": True,
         "messages": [{"role": "user", "content": c}], "logit_bias": TEXT_BIAS}
        for c in _batch_prompts()
    ]
    bodies[3] = dict(bodies[3], temperature=0.8, top_p=0.95, seed=4321)
    return bodies


def _burst_rates(results: list) -> dict:
    t_start = min(r["t0"] for r in results)
    t_first = min(r["t_first"] for r in results)
    t_end = max(r["t_end"] for r in results)
    tokens = sum(r["tokens"] for r in results)
    return {"burst_s": t_end - t_start, "completion_tokens": tokens,
            "aggregate_tokens_per_s": tokens / (t_end - t_start),
            "aggregate_decode_tokens_per_s": (tokens - len(results)) / (t_end - t_first)}


# cache_nbytes of one full-width sequence (16 layers x 4096 slots x 8 KV
# heads x head dim 64): int8 codes + f32 scales, packed int4 + f32 scales
QUANT_KV_BYTES = {8: 71_303_168, 4: 37_748_736}


def phase_quant_serve(model_dir: str, port: int, bodies: list, served: dict, batched: dict) -> dict:
    """The checkpoint served with a quantized KV cache: DNET_KV_BITS=8 and =4
    single-sequence with the serve phase's requests, then DNET_KV_BITS=8
    with --batch-slots 8 over dense slots (DNET_KV_PAGED unset) with the
    batch_serve burst.  Every decode step goes through the quantized decode
    kernel (16 launches a step, the bf16 one never) and the allocated KV
    bytes are cache_nbytes'.  Returns {8: row, 4: row, "dense": row}."""
    from dnet_tpu_torch.core.kvcache import KVConfig, cache_nbytes

    out = {}
    for bits in (8, 4):
        args = Namespace(
            host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
            max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
        )
        with environ({"DNET_KV_BITS": str(bits)}):
            results, launches, load_s, health = asyncio.run(_drive(args, bodies))
        for name, r in zip(SERVE_KINDS, results):
            check(r["status"] == 200, f"q{bits} {name} request: HTTP {r['status']}")
            check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"q{bits} {name} request: short completion")
            check(name != "streamed" or r["content"] == results[0]["content"],
                  f"q{bits} streamed content differs from the non-streamed")
        decode_steps = sum(r["tokens"] - 1 for r in results)
        name = f"flash_decode_q{bits}"
        check(launches[name] == LAYERS * decode_steps,
              f"{name} launches {launches[name]} != {LAYERS} x {decode_steps} steps")
        check(launches["flash_decode"] + launches["flash_decode_q8"] + launches["flash_decode_q4"]
              == launches[name], f"q{bits}: another decode variant launched {launches}")
        check(launches["flash_prefill"] == LAYERS * len(results), f"q{bits} prefill launches {launches}")
        engine = health["engine"]
        want_bytes = cache_nbytes(KVConfig(LAYERS, 1, S, KVH, D, quant_bits=bits))
        check(engine["kv_quant_bits"] == bits and engine["kv_bytes"] == want_bytes == QUANT_KV_BYTES[bits],
              f"q{bits} KV bytes {engine} != {want_bytes}")
        row = {
            "phase": "quant_serve", "kv_bits": bits, "mode": "single sequence", "gpu": gpu_line(),
            "load_s": load_s, "launches": launches, "prefills": len(results), "decode_steps": decode_steps,
            "kv_bytes": engine["kv_bytes"], "bf16_kv_bytes": 2 * LAYERS * S * KVH * D * 2,
            "requests": [
                {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
                 "content_head": r["content"][:40]}
                for k, r in zip(SERVE_KINDS, results)
            ],
            **streamed_rates(results),
            "bf16_serve": {k: served[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
        }
        emit(row)
        out[bits] = dict(row, results=results)
    # dense batched slots with an int8 cache
    with environ({"DNET_KV_BITS": "8"}):
        results, launches, load_s, health = asyncio.run(
            _drive(_batch_args(model_dir, port), _batch_bodies(), concurrent=True))
    for i, r in enumerate(results):
        check(r["status"] == 200, f"dense q8 batched request {i}: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"dense q8 batched request {i}: {r['tokens']} tokens")
    engine = health["engine"]
    steps = engine["decode_steps"]
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    check(engine["kv_mode"] == "dense" and engine["active"] == 0, f"dense slots: {engine}")
    check(steps > 0 and launches["flash_decode_q8"] == LAYERS * steps,
          f"dense q8 launches {launches['flash_decode_q8']} != {LAYERS} x {steps} batched decode steps")
    check(launches["flash_decode"] == launches["flash_decode_q4"] == launches["paged_attend"] == 0,
          f"dense q8: another decode kernel launched {launches}")
    check(launches["flash_prefill"] == LAYERS * chunks, f"dense q8 prefill launches {launches}")
    check(engine["kv_bytes"] == BATCH_SLOTS * QUANT_KV_BYTES[8], f"dense q8 KV bytes {engine}")
    row = {
        "phase": "quant_serve", "kv_bits": 8, "mode": "dense batched slots", "gpu": gpu_line(),
        "batch_slots": BATCH_SLOTS, "load_s": load_s, "launches": launches, "decode_steps": steps,
        "prefill_chunks": chunks, "kv_bytes": engine["kv_bytes"],
        **_burst_rates(results),
        "requests": [
            {"prompt_tokens": n, "sampled": i == 3, "status": r["status"], "completion_tokens": r["tokens"],
             "ttft_s": r["ttft_s"], "gap_median_ms": r["gap_median_s"] * 1e3, "content_head": r["content"][:24]}
            for i, (n, r) in enumerate(zip(BATCH_PROMPT_TOKENS, results))
        ],
        "paged_bf16_batch_serve": {k: batched[k] for k in ("aggregate_tokens_per_s", "aggregate_decode_tokens_per_s")},
    }
    emit(row)
    out["dense"] = row
    return out


def phase_batch_serve(model_dir: str, port: int, batch_step: dict) -> dict:
    """The checkpoint served with continuous batching: 8 concurrent streamed
    requests of ragged prompt lengths share the batched decode step."""
    args = _batch_args(model_dir, port)
    bodies = _batch_bodies()
    with environ(PAGED_ENV):
        results, launches, load_s, health = asyncio.run(_drive(args, bodies, concurrent=True))
    for i, r in enumerate(results):
        check(r["status"] == 200, f"batched request {i}: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"batched request {i}: {r['tokens']} tokens")
    engine = health["engine"]
    steps = engine["decode_steps"]
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    check(steps > 0 and launches["paged_attend"] == LAYERS * steps,
          f"paged launches {launches['paged_attend']} != {LAYERS} x {steps} batched decode steps")
    check(launches["flash_decode"] == 0, f"{launches['flash_decode']} single-sequence decode launches")
    check(launches["flash_prefill"] == LAYERS * chunks,
          f"prefill launches {launches['flash_prefill']} != {LAYERS} x {chunks} prompt chunks")
    check(engine["active"] == 0 and engine["kv_blocks_used"] == 0, f"slots or blocks leaked: {engine}")
    row = {
        "phase": "batch_serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
        "batch_slots": BATCH_SLOTS, "block_tokens": BT, "pool_blocks": engine["kv_pool_blocks"],
        "load_s": load_s, "launches": launches, "decode_steps": steps, "prefill_chunks": chunks,
        "kv_blocks_peak": engine["kv_blocks_peak"],
        **_burst_rates(results),
        "requests": [
            {"prompt_tokens": n, "sampled": i == 3, "status": r["status"], "completion_tokens": r["tokens"],
             "ttft_s": r["ttft_s"], "gap_median_ms": r["gap_median_s"] * 1e3, "gap_max_ms": r["gap_max_s"] * 1e3,
             "content_head": r["content"][:24]}
            for i, (n, r) in enumerate(zip(BATCH_PROMPT_TOKENS, results))
        ],
        "step_at_8_lanes": {k: batch_step[k] for k in ("wall_ms", "host_issue_ms", "device_busy_ms",
                                                       "device_idle_share", "paged_kernel_ms")},
    }
    emit(row)
    return row


# the iteration-level scheduler (DNET_SCHED=1) over paged + ragged slots; a
# pool that holds the burst's prompts (282 blocks of 16 with their first
# decode token) but not their growth to 64 tokens each (313); turn 1 of the
# two-turn pass is whole prefill chunks long, so turn 2 prefills the same
# chunks with the prefix cache and without it; the tick ring holds every
# tick of a pass
SCHED_ENV = dict(PAGED_ENV, DNET_SCHED="1", DNET_OBS_TICK_RECORDS="100000")
SCHED_POOL_BLOCKS = 300
SCHED_TURN_TOKENS = 2 * PREFILL_CHUNK


def _sched_ticks(debug: dict, mark: int, end: Optional[int] = None) -> list:
    """The tick records captured from index `mark` on (before `end`): the
    ring is the process's and spans every server it ran."""
    out = [r for r in debug["records"] if r["seq"] >= mark and (end is None or r["seq"] < end)]
    check(bool(out) and out[0]["seq"] == mark, f"tick records from {mark} fell out of the ring")
    return out


def _ticks_captured() -> int:
    from dnet_tpu_torch.sched.flight import get_tick_recorder

    return get_tick_recorder().snapshot()["summary"]["ticks_captured"]


def _sched_launch_checks(what: str, launches: dict, ticks: list, engine: dict) -> tuple:
    """The kernels the scheduler's ticks ran: the paged kernel once a layer
    per decode forward step, the prefill kernel once a layer per prefill
    segment, the single-sequence decode kernel never; every slot and block
    back.  Returns (decode steps, prefill segments)."""
    steps = sum(r["decode_steps"] for r in ticks)
    segments = sum(r["prefill_segments"] for r in ticks)
    check(steps > 0 and steps == engine["decode_steps"], f"{what}: tick decode steps {steps} vs {engine}")
    check(launches["paged_attend"] == LAYERS * steps,
          f"{what}: paged launches {launches['paged_attend']} != {LAYERS} x {steps} decode steps")
    check(launches["flash_prefill"] == LAYERS * segments,
          f"{what}: prefill launches {launches['flash_prefill']} != {LAYERS} x {segments} segments")
    check(launches["flash_decode"] == 0, f"{what}: {launches['flash_decode']} single-sequence decode launches")
    # a prefix cache's entries keep their blocks
    held = engine.get("prefix_cache", {}).get("blocks", 0)
    check(engine["active"] == 0 and engine["kv_blocks_used"] == held, f"{what}: slots or blocks leaked: {engine}")
    check(not any(r["errors"] for r in ticks), f"{what}: tick errors")
    return steps, segments


def _turns(model: str) -> tuple:
    """The two-turn pass's bodies: turn 1 a SCHED_TURN_TOKENS-token prompt,
    turn 2 (a function of turn 1's result) its prompt and answer plus a new
    user message; non-streamed, for their usage."""
    first = _long_prompt(SCHED_TURN_TOKENS)
    base = {"model": model, "max_tokens": MAX_TOKENS, "temperature": 0, "logit_bias": TEXT_BIAS}
    turn1 = dict(base, messages=[{"role": "user", "content": first}])

    def turn2(results):
        return dict(base, messages=[{"role": "user", "content": first},
                                    {"role": "assistant", "content": results[-1]["content"]},
                                    {"role": "user", "content": "Say that again in other words."}])
    return turn1, turn2


def phase_sched_serve(model_dir: str, port: int, batched: dict) -> dict:
    """The batch_serve checkpoint served through the iteration-level
    scheduler (DNET_SCHED=1, paged + ragged, --batch-slots 8, 16-token
    blocks): the batch_serve burst (lanes per tick and per decode step
    beside batch_serve's legacy adapter) then a two-turn conversation
    without a prefix cache; the two turns again with DNET_API_PREFIX_CACHE=4
    (turn 2 prefills fewer tokens than its prompt, same text); the burst
    over a pool too small for it (a preemption, every request whole)."""
    args = _batch_args(model_dir, port)
    turn1, turn2 = _turns("llama-3.2-1b-synthetic")
    marks = {}

    def mark(name, body):
        def build(results):
            marks[name] = _ticks_captured()
            return body(results) if callable(body) else body
        return build

    # pass 1: the burst, then the two turns with no prefix cache
    marks["burst"] = _ticks_captured()
    with environ(SCHED_ENV):
        results, launches, load_s, health = asyncio.run(_drive(
            args, _batch_bodies(), concurrent=True, sched=True,
            then=[mark("turn1", turn1), mark("turn2", turn2)]))
    burst, (plain1, plain2) = results[:BATCH_SLOTS], results[BATCH_SLOTS:]
    for i, r in enumerate(results):
        check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"sched request {i}: {r['status']}, {r['tokens']}")
    ticks = _sched_ticks(health["sched"], marks["burst"])
    _sched_launch_checks("sched_serve", launches, ticks, health["engine"])
    burst_ticks = _sched_ticks(health["sched"], marks["burst"], marks["turn1"])
    plain2_ticks = _sched_ticks(health["sched"], marks["turn2"])
    steps = sum(r["decode_steps"] for r in burst_ticks)
    lane_tokens = sum(r["tokens"] for r in burst) - len(burst)
    check(not any(r["preempted"] for r in ticks), "sched_serve: a preemption with the full pool")
    decoding = [r for r in burst_ticks if r["decode_lanes"]]
    prefilling = [r for r in burst_ticks if r["prefill_tokens"]]
    legacy_lane_tokens = batched["completion_tokens"] - BATCH_SLOTS
    row = {
        "phase": "sched_serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
        "batch_slots": BATCH_SLOTS, "block_tokens": BT, "load_s": load_s, "launches": launches,
        "burst": {
            "ticks": len(burst_ticks), "decode_steps": steps, "lane_tokens": lane_tokens,
            "lane_tokens_per_decode_step": lane_tokens / steps,
            "decode_lanes_per_tick": statistics.mean(r["decode_lanes"] for r in decoding),
            "prefill_tokens_per_tick": statistics.mean(r["prefill_tokens"] for r in prefilling),
            "prefill_ticks": len(prefilling), "tick_ms_mean": statistics.mean(r["tick_ms"] for r in burst_ticks),
            **_burst_rates(burst),
            "legacy_adapter": {"decode_steps": batched["decode_steps"], "lane_tokens": legacy_lane_tokens,
                               "lane_tokens_per_decode_step": legacy_lane_tokens / batched["decode_steps"],
                               "aggregate_decode_tokens_per_s": batched["aggregate_decode_tokens_per_s"]},
        },
    }

    # pass 2: the two turns with a prefix cache of 4 entries
    marks.clear()
    with environ(dict(SCHED_ENV, DNET_API_PREFIX_CACHE="4")):
        results, launches, _, health = asyncio.run(_drive(
            args, [], sched=True, then=[mark("turn1", turn1), mark("turn2", turn2)]))
    cached1, cached2 = results
    ticks = _sched_ticks(health["sched"], marks["turn1"])
    _sched_launch_checks("sched_serve prefix", launches, ticks, health["engine"])
    hit_prefill = sum(r["prefill_tokens"] for r in _sched_ticks(health["sched"], marks["turn2"]))
    plain_prefill = sum(r["prefill_tokens"] for r in plain2_ticks)
    prompt2 = cached2["body"]["usage"]["prompt_tokens"]
    cache = health["engine"]["prefix_cache"]
    check(plain_prefill == prompt2, f"turn 2 without the cache prefilled {plain_prefill} of {prompt2}")
    check(0 < hit_prefill < prompt2 and cache["hits"] >= 1, f"turn 2 prefilled {hit_prefill} of {prompt2}: {cache}")
    check(cached1["content"] == plain1["content"] and cached2["content"] == plain2["content"],
          "the two turns' text differs with the prefix cache")
    row["two_turn"] = {"turn1_prompt_tokens": cached1["body"]["usage"]["prompt_tokens"],
                       "turn2_prompt_tokens": prompt2, "turn2_prefill_tokens": hit_prefill,
                       "turn2_prefill_tokens_without_cache": plain_prefill, "prefix_cache": cache,
                       "turn2_s": cached2["s"], "turn2_s_without_cache": plain2["s"]}

    # pass 3: the burst over a pool too small for it
    mark_pool = _ticks_captured()
    with environ(dict(SCHED_ENV, DNET_KV_POOL_BLOCKS=str(SCHED_POOL_BLOCKS))):
        results, launches, _, health = asyncio.run(_drive(args, _batch_bodies(), concurrent=True, sched=True))
    for i, r in enumerate(results):
        check(r["status"] == 200 and r["tokens"] == MAX_TOKENS,
              f"small-pool request {i}: {r['status']}, {r['tokens']} tokens")
    ticks = _sched_ticks(health["sched"], mark_pool)
    _sched_launch_checks("sched_serve small pool", launches, ticks, health["engine"])
    preempted = sum(r["preempted"] for r in ticks)
    check(preempted >= 1, f"no preemption with a pool of {SCHED_POOL_BLOCKS} blocks")
    row["small_pool"] = {"pool_blocks": SCHED_POOL_BLOCKS, "preempted": preempted,
                         "requeued": sum(r["requeued"] for r in ticks), "ticks": len(ticks),
                         "decode_steps": sum(r["decode_steps"] for r in ticks),
                         "kv_blocks_peak": health["engine"]["kv_blocks_peak"], **_burst_rates(results)}
    emit(row)
    return row


def _sched_generate(engine, bodies: list) -> tuple:
    """Serve `bodies` concurrently through the scheduler's adapter over
    `engine`, in process (InferenceManager, the byte tokenizer): returns the
    completions' texts and the ticks they took."""
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.schemas import ChatCompletionRequest
    from dnet_tpu_torch.sched import SchedulerAdapter
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    async def go():
        adapter = SchedulerAdapter(engine)
        inference = InferenceManager(adapter, request_timeout_s=600.0, max_concurrent=len(bodies))
        inference.tokenizer, inference.model_id = ByteTokenizer(), "small"
        await adapter.start()
        try:
            outs = await asyncio.gather(*(inference.generate(ChatCompletionRequest.model_validate(b))
                                          for b in bodies))
        finally:
            await adapter.shutdown()
        return [o.choices[0].message.content for o in outs]

    from dnet_tpu_torch.sched.flight import get_tick_recorder

    mark = _ticks_captured()
    texts = asyncio.run(go())
    return texts, _sched_ticks(get_tick_recorder().snapshot(), mark)


def phase_sched_parity(devices: Sequence[str] = ("cuda", "cpu")) -> dict:
    """The scheduler on the GPU (paged and prefill kernels) against the
    scheduler on the CPU (plain versions), same f32 weights (head dim 64):
    four concurrent greedy requests over 4 slots and a pool of 16-token
    blocks that holds their prompts but not their growth, so a sequence is
    preempted, re-prefilled and resumed.  The texts must be equal."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    cfg, window, edge = _small_model()
    bodies = [{"model": "small", "max_tokens": 24, "temperature": 0, "logit_bias": TEXT_BIAS,
               "messages": [{"role": "user", "content": _long_prompt(n)}]} for n in (40, 70, 100, 130)]
    out = {}
    for dev in devices:
        with environ(dict(SCHED_ENV, DNET_KV_BLOCK_TOKENS="16", DNET_KV_POOL_BLOCKS="26")):
            eng = BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=256, param_dtype="float32",
                                            device=dev)
            paged_attend.launches = 0
            texts, ticks = _sched_generate(eng, bodies)
        steps = sum(r["decode_steps"] for r in ticks)
        out[dev] = {"texts": texts, "preempted": sum(r["preempted"] for r in ticks), "ticks": len(ticks),
                    "decode_steps": steps}
        check(eng.kv_pool.used == 0 and not eng.slot_of, f"sched_parity {dev}: slots or blocks leaked")
        check(out[dev]["preempted"] >= 1, f"sched_parity {dev}: no preemption")
        if dev == "cuda":
            torch.cuda.synchronize()
            check(paged_attend.launches == cfg.num_hidden_layers * steps,
                  f"sched_parity: paged launches {paged_attend.launches} for {steps} decode steps")
        del eng
    a, b = (out[dev]["texts"] for dev in devices)
    check(a == b, f"sched_parity texts differ: {out}")
    row = {"phase": "sched_parity", "slots": 4, "bt": 16, "pool_blocks": 26, "max_tokens": 24,
           "prompt_tokens": [40, 70, 100, 130], **{dev: {k: v for k, v in o.items() if k != "texts"}
                                                    for dev, o in out.items()},
           "text_heads": [t[:16] for t in a]}
    emit(row)
    return row


# gpt-oss-20b (the fifth path): heads, KV heads, head dim, the sliding
# window (= the ring's rows), its layers; the rotating decode kernel's
# positions (before, at and past the ring's wrap, and deep); the 4-layer
# serve's prompt in tokens (its ring wraps in prefill and decode)
OSS_H, OSS_KVH, OSS_D, OSS_W, OSS_LAYERS = 64, 8, 64, 128, 24
ROT_POSITIONS = [0, 127, 128, 300, 4095]
ROT_SHORT_WINDOW = 91
OSS_SERVE_LAYERS = 4
OSS_MODEL = "gpt-oss-20b-synthetic"
# /health engine.kv_bytes of one sequence at max_seq 4096, bf16: 2 full
# layers x 4096 rows + 2 sliding layers x 128 rows, k and v, 8 KV heads x 64
OSS_SERVE_KV_BYTES = 17_301_504


def rotating_bound(pos: int, window: int, qbits: int, dtype) -> tuple:
    """(ms, bound_by) for one rotating decode call: q and the output once
    (in `dtype`), the sinks, and each ring slot the query attends (its last
    min(pos + 1, window) positions) once as the cache stores it; 4*D
    operations per (head, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    keys = min(pos + 1, window)
    row = {0: OSS_D * size, 8: OSS_D + 4, 4: OSS_D // 2 + 4}[qbits]  # bytes per (slot, KV head)
    nbytes = 2 * OSS_H * OSS_D * size + 4 * OSS_H + 2 * keys * OSS_KVH * row
    return bytes_ops_bound(nbytes, 4 * OSS_H * OSS_D * keys, dtype)


def phase_rotating_kernels() -> dict:
    """The decode kernel's rotating variant at gpt-oss-20b's widths (B=1, a
    ring of W=128 slots, H=64, KVH=8, D=64, sinks) against its plain
    version: f32 and bf16 rings, and q8 / q4 rings that the port's
    write_kv_rotating filled from 3W bf16 rows (bf16 q), at ROT_POSITIONS
    with the served window (= W), and one bf16 row with a shorter window.
    Each timed call reads one of the 12 sliding layers' rings (1.5 MB in
    all: they stay in the 50 MB L2).  Library yardstick: SDPA over the
    attended slots unrolled into position order, with the sink as an extra
    key column (a zero key and value whose additive mask entry is the
    sink logit); the unrolling and dequant are not timed.  Returns the
    main rows (pos 300, the step's position)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, read_kv, write_kv_rotating
    from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(7)
    L = OSS_LAYERS // 2
    main = {}
    forms = [("float32", torch.float32, 0), ("bfloat16", torch.bfloat16, 0), ("q8", torch.bfloat16, 8),
             ("q4", torch.bfloat16, 4)]
    for form, dtype, bits in forms:
        if bits:
            kv = init_cache(KVConfig(L, 1, OSS_W, OSS_KVH, OSS_D, quant_bits=bits), torch.device("cuda"))
            rings = [layer_slices(kv, l) for l in range(L)]
            for ring in rings:
                rows = [torch.randn(1, 3 * OSS_W, OSS_KVH, OSS_D, generator=g, device="cuda").to(torch.bfloat16)
                        for _ in range(2)]
                write_kv_rotating(ring, rows[0], rows[1], 0)
        else:
            rings = [{n: torch.randn(1, OSS_W, OSS_KVH, OSS_D, generator=g, device="cuda").to(dtype)
                      for n in ("k", "v")} for _ in range(L)]
        scales = [{n: r[n] for n in ("k_scale", "v_scale")} if bits else {} for r in rings]
        cases = [(p, OSS_W) for p in ROT_POSITIONS] + ([(300, ROT_SHORT_WINDOW)] if form == "bfloat16" else [])
        for pos, window in cases:
            q = torch.randn(1, 1, OSS_H, OSS_D, generator=g, device="cuda").to(dtype)
            sinks = torch.randn(OSS_H, generator=g, device="cuda")
            lengths = decode_lengths(1, pos, "cuda")
            live = min(pos + 1, OSS_W)

            def kern(l):
                r = rings[l]
                return flash_decode_attend(q, r["k"], r["v"], lengths, live, sinks=sinks, rotating=True,
                                           window=window, **scales[l])

            def plain(l):
                r = rings[l]
                return flash_decode_plain(q, r["k"], r["v"], lengths, sinks=sinks, max_live=live, rotating=True,
                                          window=window, **scales[l])

            out = kern(0)
            torch.cuda.synchronize()
            r0 = rings[0]
            want = flash_decode_plain(q.float(), r0["k"] if bits else r0["k"].float(),
                                      r0["v"] if bits else r0["v"].float(), lengths, sinks=sinks, rotating=True,
                                      window=window, **scales[0])
            err = (out.float() - want).abs().max().item()
            tol = TOL[dtype]
            check(out.shape == q.shape and out.dtype == dtype and bool(torch.isfinite(out).all()),
                  "rotating decode output")
            check(err <= tol, f"rotating decode {form} pos={pos} window={window}: max err {err}")
            # the yardstick: the attended slots in position order plus a sink column
            keys = min(pos + 1, window)
            slots = torch.remainder(torch.arange(pos - keys + 1, pos + 1, device="cuda"), OSS_W)
            unrolled = []
            for l, r in enumerate(rings):
                kc, vc = read_kv({n: t[:, slots] for n, t in r.items()})
                kc, vc = (torch.cat([t.to(dtype), torch.zeros_like(t[:, :1], dtype=dtype)], dim=1).transpose(1, 2)
                          .contiguous() for t in (kc, vc))
                unrolled.append((kc, vc))
            bias = torch.zeros(1, OSS_H, 1, keys + 1, device="cuda", dtype=dtype)
            bias[0, :, 0, -1] = sinks.to(dtype)
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, unrolled[l][0], unrolled[l][1], attn_mask=bias, enable_gqa=True)

            def lib_causal(l):
                return sdpa(qt, live[l][0], live[l][1], is_causal=True, scale=scale)

            lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
            check(lib_err <= TOL[torch.bfloat16], f"rotating library yardstick disagrees: {lib_err}")
            bound, by = rotating_bound(pos, window, bits, dtype)
            name = "flash_decode_rotating" + (f"_q{bits}" if bits else "")
            row = {
                "phase": "kernels", "kernel": name, "dtype": str(dtype).split(".")[-1], "cache": form,
                "pos": pos, "window": window, "W": OSS_W, "H": OSS_H, "KVH": OSS_KVH, "D": OSS_D,
                "max_err": err, "tol": tol,
                "kernel_ms": device_time_ms(kern, L), "plain_ms": device_time_ms(plain, L, 3),
                "library_ms": device_time_ms(lib, L),
                "library_call": "scaled_dot_product_attention over the attended slots in position order, the "
                                "sink as an extra zero key whose additive mask entry is the sink logit (the "
                                "unrolling and dequant are not timed)",
                "library_max_err": lib_err, "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if pos == 300 and window == OSS_W and dtype == torch.bfloat16:
                main[name] = row
            del unrolled
        del rings, scales
    torch.cuda.empty_cache()
    return main


def _oss_small(layers: int = 4):
    """The gpt_oss parity model: small, f32, with the kernels' head dim and
    gpt-oss-20b's grouping (G = 8), a ring of W = 32, 4 layers (or
    `layers`, sliding / full pairs), 4 experts top-2, YaRN, sinks."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import GPT_OSS_20B_CONFIG, random_gpt_oss_params

    cfg = ModelConfig.from_hf(dict(
        GPT_OSS_20B_CONFIG, vocab_size=512, hidden_size=256, intermediate_size=128, num_hidden_layers=layers,
        num_attention_heads=16, num_key_value_heads=2, head_dim=64, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=32, layer_types=["sliding_attention", "full_attention"] * (layers // 2),
    ))
    window, edge = random_gpt_oss_params(cfg, range(layers), torch.device("cpu"), torch.float32, seed=2)
    return cfg, window, edge


def phase_gpt_oss_parity() -> dict:
    """gpt_oss's single-sequence engine on the GPU (the rotating decode
    kernel on the sliding half, the prefill and decode kernels on the full
    half) against the CPU (plain versions), same f32 weights: a 40-token
    prompt (the ring of 32 wraps in prefill) and 48 greedy tokens (two more
    wraps), over an f32 cache, an int8 one and a packed int4 one.  Returns
    each pass's launches, by kv bits: the q8 and q4 passes are where the
    rotating variant's quantized forms run on an engine path."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg, window, edge = _oss_small()
    prompt = [(11 * i) % 500 + 1 for i in range(40)]
    n_tokens = 48
    out = {}
    for bits in (0, 8, 4):
        engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev,
                                                kv_quant_bits=bits) for dev in ("cuda", "cpu")}
        reset_launch_counts()
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, 512), "gpt_oss logits")
        check(err <= 2e-3, f"gpt_oss q{bits} GPU vs CPU prefill logits: max err {err}")
        for e in engines.values():
            e.end_session("p")
        streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=n_tokens, nonce="g")]
                   for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"], f"gpt_oss q{bits} greedy streams differ: {streams}")
        torch.cuda.synchronize()
        launches = launch_counts()
        steps = n_tokens - 1
        rot = "flash_decode_rotating" + (f"_q{bits}" if bits else "")
        dec = "flash_decode" + (f"_q{bits}" if bits else "")
        check(launches[rot] == 2 * steps and launches[dec] == 2 * steps and launches["flash_prefill"] == 2 * 2,
              f"gpt_oss q{bits} parity launches {launches}")
        emit({"phase": "gpt_oss_parity", "kv_bits": bits, "layers": 4, "W": 32, "H": 16, "KVH": 2, "D": 64,
              "experts": 4, "top_k": 2, "prompt_tokens": len(prompt), "logits_max_err": err, "tol": 2e-3,
              "greedy_tokens": len(streams["cuda"]), "launches": {k: v for k, v in launches.items() if v}})
        out[bits] = launches
    return out


def phase_moe_step(phase: str, model: str, cfg, window, edge, n_prompt: int) -> dict:
    """Where a full-width MoE model's greedy decode step goes (every layer,
    the reference's default dense MoE, bf16, max_seq 4096) at pos ~n_prompt
    (gpt-oss-20b: past the ring's wrap): the synchronised wall time, the
    host's time to issue it, the device's busy time (profiler), the
    attention kernels' share, the launches, and the step's bound (every
    layer's weights and the LM head read once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    eng = LocalEngine.from_params(cfg, window, edge, max_seq=S, device="cuda")
    check(eng.model.moe_impl == "dense", f"moe_impl {eng.model.moe_impl}")
    d = DecodingParams()
    tok = int(eng.prefill_and_sample("s", [(7 * t) % 250 + 1 for t in range(n_prompt)], d).token[0])
    for _ in range(5):
        tok = int(eng.decode_step("s", tok, d).token[0])
    torch.cuda.synchronize()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        res = eng.decode_step("s", tok, d)
        issue.append((time.perf_counter() - t0) * 1e3)
        tok = int(res.token[0])  # waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = int(eng.decode_step("s", tok, d).token[0])
        torch.cuda.synchronize()
    per_step = {k: v / steps for k, v in launch_counts().items() if v}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    attn_ms = sum(e.self_device_time_total for e in kernels if "flash_" in e.name) / 1e3 / steps
    check(device_ms > 0, "the profiler saw no device time")
    # the matrix products' share (cuBLAS's gemm / gemv / nvjet kernels,
    # CUTLASS) and the kernels that take the most device time, per step
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1e3 / steps
    matmul_ms = sum(t for n, t in by_name.items() if any(w in n.lower() for w in ("gemm", "gemv", "nvjet", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    wall_ms = statistics.median(wall)
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += edge["lm_head"]["weight"].numel() * edge["lm_head"]["weight"].element_size()
    row = {"phase": phase, "gpu": gpu_line(), "model": model,
           "layers": cfg.num_hidden_layers, "moe_impl": "dense", "steps": len(wall), "pos": eng.sessions["s"].pos,
           "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue), "device_busy_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms, "attention_kernels_ms": attn_ms,
           "matmul_kernels_ms": matmul_ms, "top_kernels_ms": {n[:80]: t for n, t in top},
           "kernel_launches": len(kernels) // steps, "wrapper_launches_per_step": per_step,
           "attention_share": attn_ms / device_ms, "weight_bytes": weight_bytes,
           "bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3, "kv_bytes": eng.kv_bytes,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    eng.close()
    return row


def phase_gpt_oss(prompt_text: str, long_text: str, port: int) -> tuple:
    """gpt-oss-20b at full width: the 24-layer step from random params made
    on the card, then the first OSS_SERVE_LAYERS layers (2 sliding/full
    pairs) and the edge written as a checkpoint and served over HTTP."""
    from dnet_tpu_torch.core.kvcache import KVConfig
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import GPT_OSS_20B_CONFIG, random_gpt_oss_params

    tmp = os.path.join(tempfile.mkdtemp(prefix="dnet-torch-smoke-oss-"), OSS_MODEL)
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = ModelConfig.from_hf(GPT_OSS_20B_CONFIG)
        window, edge = random_gpt_oss_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"),
                                             torch.bfloat16, seed=0)
        init_s = time.perf_counter() - t0
        step = dict(phase_moe_step("gpt_oss_step", "gpt-oss-20b (synthetic bf16 weights, seed 0)", cfg, window,
                                   edge, 300), init_s=init_s)
        t0 = time.perf_counter()
        served_cfg = dict(GPT_OSS_20B_CONFIG, num_hidden_layers=OSS_SERVE_LAYERS,
                          layer_types=GPT_OSS_20B_CONFIG["layer_types"][:OSS_SERVE_LAYERS])
        save_checkpoint(tmp, served_cfg, hf_tensors(window[:OSS_SERVE_LAYERS], edge))
        del window, edge
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        serve = phase_gpt_oss_serve(tmp, port, prompt_text, long_text, write_s)
        batch = phase_gpt_oss_batch_serve(tmp, port)
        # the same checkpoint under sp = 2: flat caches, no kernel
        sp_serve = phase_sp_family_serve("gpt_oss", tmp, port, OSS_MODEL, prompt_text, None,
                                         KVConfig(OSS_SERVE_LAYERS // 2, 1, S // 2, OSS_KVH, OSS_D, "float32"), 2)
    finally:
        shutil.rmtree(os.path.dirname(tmp), ignore_errors=True)
    return step, dict(serve, sp_serve=sp_serve, batch_serve=batch)


def phase_gpt_oss_serve(model_dir: str, port: int, prompt_text: str, long_text: str, write_s: float) -> dict:
    """The 4-layer full-width gpt-oss checkpoint served single-sequence by
    the port's server: the serve phase's greedy, seeded sampled and
    streamed requests, then one streamed request with a ~300-token prompt,
    all 64 tokens, so the 128-row ring wraps in prefill and in decode.  The
    rotating kernel runs 2 times per decode step (the sliding half), the
    plain decode kernel 2 times (the full half), the prefill kernel 2 times
    per prompt, no other decode kernel; /health's KV bytes are the paired
    cache's."""
    args = Namespace(
        host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
        max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
    )
    chat = {"model": OSS_MODEL, "max_tokens": MAX_TOKENS, "temperature": 0,
            "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
    bodies = [{"greedy": chat, "streamed": dict(chat, stream=True),
               "sampled": dict(chat, temperature=0.8, top_p=0.95, seed=1234)}[k] for k in SERVE_KINDS]
    bodies.append(dict(chat, stream=True, messages=[{"role": "user", "content": long_text}]))
    results, launches, load_s, health = asyncio.run(_drive(args, bodies))
    kinds = list(SERVE_KINDS) + ["streamed_long"]
    for name, r in zip(kinds, results):
        check(r["status"] == 200, f"gpt_oss {name} request: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"gpt_oss {name} request: short completion")
        check(name != "streamed" or r["content"] == results[0]["content"],
              "gpt_oss streamed content differs from the non-streamed")
    half = OSS_SERVE_LAYERS // 2
    decode_steps = sum(r["tokens"] - 1 for r in results)
    check(launches["flash_decode_rotating"] == half * decode_steps,
          f"rotating launches {launches['flash_decode_rotating']} != {half} x {decode_steps} steps")
    check(launches["flash_decode"] == half * decode_steps,
          f"decode launches {launches['flash_decode']} != {half} x {decode_steps} steps")
    check(launches["flash_prefill"] == half * len(results),
          f"prefill launches {launches['flash_prefill']} != {half} x {len(results)} prompts")
    others = [k for k, v in launches.items() if v and k not in ("flash_decode_rotating", "flash_decode", "flash_prefill")]
    check(not others, f"gpt_oss serve launched other kernels: {launches}")
    engine = health["engine"]
    check(engine["kv_bytes"] == OSS_SERVE_KV_BYTES, f"gpt_oss KV bytes {engine} != {OSS_SERVE_KV_BYTES}")
    long = results[-1]
    row = {
        "phase": "gpt_oss_serve", "gpu": gpu_line(),
        "model": f"gpt-oss-20b widths, {OSS_SERVE_LAYERS} of 24 layers (synthetic bf16 weights, seed 0)",
        "checkpoint_write_s": write_s, "load_s": load_s, "launches": launches, "prefills": len(results),
        "decode_steps": decode_steps, "kv_bytes": engine["kv_bytes"],
        "flat_cache_kv_bytes": 2 * OSS_SERVE_LAYERS * S * OSS_KVH * OSS_D * 2,
        "requests": [
            {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
             "tokens_per_s": r["tokens"] / r["s"], "content_head": r["content"][:40]}
            for k, r in zip(kinds, results)
        ],
        **streamed_rates(results[: len(SERVE_KINDS)]),
        "long_prompt": {"ttft_s": long["ttft_s"], "decode_tokens_per_s": (long["tokens"] - 1) / long["decode_s"]},
    }
    emit(row)
    return row


# DeepSeek-V2-Lite's MLA attention: H = KVH = 16 (the cache holds one KV head
# per query head, G = 1), q/k head dim 192 (nope 128 + rope 64), v head dim
# 128; the kernels' rows read one of 26 layers' caches per call (1.1 GB of
# bf16 at S = 4096: K/V cold in the 50 MB L2, as the next MoE layer's); the
# decode rows sit at pos 300, the step's position
MLA_H, MLA_DQK, MLA_DV, MLA_LAYERS, MLA_POS = 16, 192, 128, 26, 300
DS_SERVE_LAYERS = 2
DS_MODEL = "deepseek-v2-lite-synthetic"
# /health engine.kv_bytes of one sequence at max_seq 4096, bf16: 2 layers x
# 4096 slots x 16 KV heads x (192 + 128) x 2 bytes
DS_SERVE_KV_BYTES = 83_886_080


def mla_bound(T: int, pos: int, qbits: int, dtype) -> tuple:
    """(ms, bound_by) for one MLA attention call of T query rows from
    position pos: q and the output once (in `dtype`), each attended slot's
    K (192) and V (128) once as the cache stores them (values in `dtype`,
    or codes plus two 4-byte f32 scales a slot and head); 2 * (192 + 128)
    operations per (head, query, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    keys = min(pos + T, S)
    row = {0: (MLA_DQK + MLA_DV) * size, 8: MLA_DQK + MLA_DV + 8, 4: (MLA_DQK + MLA_DV) // 2 + 8}[qbits]
    nbytes = T * MLA_H * (MLA_DQK + MLA_DV) * size + keys * MLA_H * row
    pairs = sum(min(pos + i + 1, S) for i in range(T))
    return bytes_ops_bound(nbytes, 2 * MLA_H * (MLA_DQK + MLA_DV) * pairs, dtype)


def _mla_scale() -> float:
    """DeepSeek-V2-Lite's softmax scale, as its model computes it: 192^-0.5
    times YaRN's mscale(40, 0.707)^2."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.deepseek_v2 import DeepseekV2RingModel
    from dnet_tpu_torch.utils.random_init import DEEPSEEK_V2_LITE_CONFIG

    return DeepseekV2RingModel(ModelConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG), [0], "cpu").softmax_scale


def phase_mla_kernels(main_T: int) -> dict:
    """The prefill and decode kernels at DeepSeek-V2-Lite's MLA widths
    against their plain versions, at its softmax scale: prefill at the
    served prompt's bucket (pos 0), decode at pos 300, f32 and bf16 caches,
    then q8 / q4 caches the port's write_kv quantized from bf16 rows (bf16
    q).  Library yardstick: scaled_dot_product_attention with V's own head
    dim (on a dequantized bf16 copy of a quantized cache; the dequant is not
    timed).  Returns the main rows (bf16 q)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, read_kv, write_kv
    from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
    from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    scale = _mla_scale()
    L = MLA_LAYERS
    main = {}
    forms = [("float32", torch.float32, 0), ("bfloat16", torch.bfloat16, 0), ("q8", torch.bfloat16, 8),
             ("q4", torch.bfloat16, 4)]
    for form, dtype, bits in forms:
        if bits:
            kv = init_cache(KVConfig(L, 1, S, MLA_H, MLA_DQK, v_head_dim=MLA_DV, quant_bits=bits),
                            torch.device("cuda"))
            layers = [layer_slices(kv, l) for l in range(L)]
            for c in layers:
                write_kv(c, torch.randn(1, S, MLA_H, MLA_DQK, generator=g, device="cuda").to(torch.bfloat16),
                         torch.randn(1, S, MLA_H, MLA_DV, generator=g, device="cuda").to(torch.bfloat16), 0)
        else:
            kv = {"k": torch.randn(L, 1, S, MLA_H, MLA_DQK, generator=g, device="cuda").to(dtype),
                  "v": torch.randn(L, 1, S, MLA_H, MLA_DV, generator=g, device="cuda").to(dtype)}
            layers = [layer_slices(kv, l) for l in range(L)]
        scales = [{n: c[n] for n in ("k_scale", "v_scale")} if bits else {} for c in layers]
        cases = [("decode", 1, MLA_POS)] + ([] if bits else [("prefill", main_T, 0)])
        for kind, T, pos in cases:
            q = torch.randn(1, T, MLA_H, MLA_DQK, generator=g, device="cuda").to(dtype)
            keys = pos + T
            c0 = layers[0]
            if kind == "prefill":
                name = "flash_prefill_mla"

                def kern(l):
                    return flash_prefill(q, layers[l]["k"], layers[l]["v"], pos, scale=scale)

                def plain(l):
                    return flash_prefill_plain(q, layers[l]["k"], layers[l]["v"], pos, scale=scale)

                want = flash_prefill_plain(q.float(), c0["k"].float(), c0["v"].float(), pos, scale=scale)
                mask = (torch.arange(keys, device="cuda")[None, :]
                        <= pos + torch.arange(T, device="cuda")[:, None])
            else:
                name = "flash_decode_mla" + (f"_q{bits}" if bits else "")
                lengths = decode_lengths(1, pos, "cuda")

                def kern(l):
                    return flash_decode_attend(q, layers[l]["k"], layers[l]["v"], lengths, pos + 1, scale=scale,
                                               **scales[l])

                def plain(l):
                    return flash_decode_plain(q, layers[l]["k"], layers[l]["v"], lengths, scale=scale,
                                              max_live=pos + 1, **scales[l])

                want = flash_decode_plain(q.float(), c0["k"] if bits else c0["k"].float(),
                                          c0["v"] if bits else c0["v"].float(), lengths, scale=scale, **scales[0])
                mask = None
            out = kern(0)
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            check(out.shape == (1, T, MLA_H, MLA_DV) and out.dtype == dtype and bool(torch.isfinite(out).all()),
                  f"{name} output")
            check(err <= TOL[dtype], f"{name} {form} T={T} pos={pos}: max err {err}")
            # the yardstick: each layer's attended prefix, dequantized to bf16 for a quantized cache
            live = []
            for c in layers:
                kc, vc = read_kv({n: t[:, :keys] for n, t in c.items()})
                live.append(tuple(t[:, :keys].to(dtype).transpose(1, 2) for t in (kc, vc)))
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, live[l][0], live[l][1], attn_mask=mask, scale=scale)

            def lib_causal(l):
                return sdpa(qt, live[l][0], live[l][1], is_causal=True, scale=scale)

            lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
            check(lib_err <= TOL[torch.bfloat16], f"{name} library yardstick disagrees: {lib_err}")
            bound, by = mla_bound(T, pos, bits, dtype)
            row = {
                "phase": "kernels", "kernel": name, "dtype": str(dtype).split(".")[-1], "cache": form,
                "T": T, "pos": pos, "S": S, "H": MLA_H, "KVH": MLA_H, "Dqk": MLA_DQK, "Dv": MLA_DV,
                "scale": scale, "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(kern, L), "plain_ms": device_time_ms(plain, L, 3),
                "library_ms": device_time_ms(lib, L),
                "library_call": "scaled_dot_product_attention with Dv != Dqk"
                                + (" on a dequantized bf16 copy (dequant not timed)" if bits else ""),
                "library_max_err": lib_err, "bound_ms": bound, "bound_by": by,
            }
            if kind == "prefill":
                row["times_library"] = row["kernel_ms"] / row["library_ms"]
                row["library_causal_ms"] = device_time_ms(lib_causal, L)
            emit(row)
            if dtype == torch.bfloat16:
                main[name] = row
            del live
        del kv, layers, scales
        torch.cuda.empty_cache()
    return main


def _ds_small():
    """The deepseek_v2 parity model: small and f32, at the kernels' MLA
    widths (q/k 192 = 128 + 64, v 128) with YaRN's mscale^2 scale, 3 layers
    (1 dense + 2 MoE), 4 heads, 4 experts top-2 + 1 shared."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import DEEPSEEK_V2_LITE_CONFIG, random_deepseek_v2_params

    cfg = ModelConfig.from_hf(dict(
        DEEPSEEK_V2_LITE_CONFIG, vocab_size=512, hidden_size=256, intermediate_size=256, moe_intermediate_size=64,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=64, n_routed_experts=4,
        n_shared_experts=1, num_experts_per_tok=2,
    ))
    window, edge = random_deepseek_v2_params(cfg, range(3), torch.device("cpu"), torch.float32, seed=4)
    return cfg, window, edge


def phase_deepseek_parity() -> None:
    """deepseek_v2's single-sequence engine on the GPU (the MLA prefill and
    decode kernels) against the CPU (plain versions), same f32 weights: a
    40-token prompt and 32 greedy tokens, over an f32 cache and an int8 one;
    every attention call takes the MLA-width kernels."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg, window, edge = _ds_small()
    prompt = [(13 * i) % 500 + 1 for i in range(40)]
    n_tokens = 32
    for bits in (0, 8):
        engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev,
                                                kv_quant_bits=bits) for dev in ("cuda", "cpu")}
        reset_launch_counts()
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, 512), "deepseek logits")
        check(err <= 2e-3, f"deepseek q{bits} GPU vs CPU prefill logits: max err {err}")
        for e in engines.values():
            e.end_session("p")
        streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=n_tokens, nonce="g")]
                   for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"], f"deepseek q{bits} greedy streams differ: {streams}")
        torch.cuda.synchronize()
        launches = launch_counts()
        dec = "flash_decode_mla" + (f"_q{bits}" if bits else "")
        expected = {"flash_prefill_mla": 3 * 2, dec: 3 * (n_tokens - 1)}
        check({k: v for k, v in launches.items() if v} == expected,
              f"deepseek q{bits} parity launches {launches} != {expected}")
        emit({"phase": "deepseek_parity", "kv_bits": bits, "layers": 3, "H": 4, "KVH": 4, "Dqk": MLA_DQK,
              "Dv": MLA_DV, "experts": 4, "top_k": 2, "prompt_tokens": len(prompt), "logits_max_err": err,
              "tol": 2e-3, "greedy_tokens": len(streams["cuda"]), "launches": expected})


def phase_deepseek(prompt_text: str, long_text: str, port: int) -> tuple:
    """DeepSeek-V2-Lite at full width: the 27-layer step from random params
    made on the card, then the first DS_SERVE_LAYERS layers (1 dense + 1
    MoE) and the edge written as a checkpoint and served over HTTP."""
    from dnet_tpu_torch.core.kvcache import KVConfig
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import DEEPSEEK_V2_LITE_CONFIG, random_deepseek_v2_params

    tmp = os.path.join(tempfile.mkdtemp(prefix="dnet-torch-smoke-ds-"), DS_MODEL)
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = ModelConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
        window, edge = random_deepseek_v2_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"),
                                                 torch.bfloat16, seed=0)
        init_s = time.perf_counter() - t0
        step = dict(phase_moe_step("deepseek_step", "DeepSeek-V2-Lite-Chat (synthetic bf16 weights, seed 0)", cfg,
                                   window, edge, 300), init_s=init_s)
        # the same 27 layers at sp = 2, past the shard boundary: the LSE form
        # at the MLA widths, 16 heads x (192 + 128) bf16 of K/V a layer and slot
        phase_sp_step(cfg, window, edge, "deepseek_sp_step", "DeepSeek-V2-Lite-Chat", "flash_decode_lse_mla",
                      MLA_H * (MLA_DQK + MLA_DV) * 2)
        t0 = time.perf_counter()
        save_checkpoint(tmp, dict(DEEPSEEK_V2_LITE_CONFIG, num_hidden_layers=DS_SERVE_LAYERS),
                        hf_tensors(window[:DS_SERVE_LAYERS], edge))
        del window, edge
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        serve = phase_deepseek_serve(tmp, port, prompt_text, long_text, write_s)
        batch = phase_deepseek_batch_serve(tmp, port)
        # the same checkpoint under sp = 2: the LSE form at the MLA widths
        sp_serve = phase_sp_family_serve("deepseek_v2", tmp, port, DS_MODEL, prompt_text, "flash_decode_lse_mla",
                                         KVConfig(DS_SERVE_LAYERS, 1, S // 2, MLA_H, MLA_DQK, "float32",
                                                  v_head_dim=MLA_DV), 1)
        serve = dict(serve, sp_serve=sp_serve, batch_serve=batch)
    finally:
        shutil.rmtree(os.path.dirname(tmp), ignore_errors=True)
    return step, serve


def phase_deepseek_serve(model_dir: str, port: int, prompt_text: str, long_text: str, write_s: float) -> dict:
    """The 2-layer full-width DeepSeek-V2-Lite checkpoint served
    single-sequence by the port's server: the serve phase's greedy, seeded
    sampled and streamed requests plus a streamed ~300-token prompt
    over a bf16 cache, then a greedy and a streamed request under
    DNET_KV_BITS=8 and =4.  Every attention call takes the MLA kernels: 4
    decode launches per step (of the cache's variant) and 4 prefill
    launches per prompt, no other kernel; /health's KV bytes are the
    asymmetric cache's."""
    from dnet_tpu_torch.core.kvcache import KVConfig, cache_nbytes

    args = Namespace(
        host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
        max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
    )
    chat = {"model": DS_MODEL, "max_tokens": MAX_TOKENS, "temperature": 0,
            "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
    by_kind = {"greedy": chat, "streamed": dict(chat, stream=True),
               "sampled": dict(chat, temperature=0.8, top_p=0.95, seed=1234)}
    passes = {0: [by_kind[k] for k in SERVE_KINDS] + [dict(chat, stream=True,
                                                          messages=[{"role": "user", "content": long_text}])],
              8: [by_kind["greedy"], by_kind["streamed"]], 4: [by_kind["greedy"], by_kind["streamed"]]}
    total, out = {}, {}
    for bits, bodies in passes.items():
        with environ({"DNET_KV_BITS": str(bits)}):
            results, launches, load_s, health = asyncio.run(_drive(args, bodies))
        for r in results:
            check(r["status"] == 200, f"deepseek q{bits} request: HTTP {r['status']}")
            check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"deepseek q{bits} request: short completion")
        decode_steps = sum(r["tokens"] - 1 for r in results)
        dec = "flash_decode_mla" + (f"_q{bits}" if bits else "")
        expected = {"flash_prefill_mla": DS_SERVE_LAYERS * len(results), dec: DS_SERVE_LAYERS * decode_steps}
        check({k: v for k, v in launches.items() if v} == expected,
              f"deepseek q{bits} serve launches {launches} != {expected}")
        want_kv = cache_nbytes(KVConfig(DS_SERVE_LAYERS, 1, S, MLA_H, MLA_DQK, v_head_dim=MLA_DV, quant_bits=bits))
        check(bits or want_kv == DS_SERVE_KV_BYTES, f"cache_nbytes {want_kv} != {DS_SERVE_KV_BYTES}")
        check(health["engine"]["kv_bytes"] == want_kv, f"deepseek q{bits} KV bytes {health['engine']} != {want_kv}")
        for k, v in expected.items():
            total[k] = total.get(k, 0) + v
        out[bits] = {"load_s": load_s, "decode_steps": decode_steps, "kv_bytes": want_kv, "results": results}
    base = out[0]["results"]
    check(all(base[i]["content"] == base[0]["content"] for i, k in enumerate(SERVE_KINDS) if k == "streamed"),
          "deepseek streamed content differs from the non-streamed")
    for bits in (8, 4):
        q = out[bits]["results"]
        check(q[1]["content"] == q[0]["content"], f"deepseek q{bits} streamed content differs from the greedy")
    long = base[-1]
    kinds = list(SERVE_KINDS) + ["streamed_long"]
    row = {
        "phase": "deepseek_serve", "gpu": gpu_line(),
        "model": f"DeepSeek-V2-Lite-Chat widths, {DS_SERVE_LAYERS} of 27 layers (1 dense + 1 MoE; synthetic bf16 "
                 "weights, seed 0)",
        "checkpoint_write_s": write_s, "load_s": out[0]["load_s"], "launches": total,
        "prefills": len(base), "decode_steps": out[0]["decode_steps"], "kv_bytes": out[0]["kv_bytes"],
        "requests": [
            {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
             "tokens_per_s": r["tokens"] / r["s"], "content_head": r["content"][:40]}
            for k, r in zip(kinds, base)
        ],
        **streamed_rates(base[: len(SERVE_KINDS)]),
        "long_prompt": {"ttft_s": long["ttft_s"], "decode_tokens_per_s": (long["tokens"] - 1) / long["decode_s"]},
        "quantized": {
            f"q{bits}": {"kv_bytes": out[bits]["kv_bytes"], "load_s": out[bits]["load_s"],
                         "streamed_ttft_s": out[bits]["results"][1]["ttft_s"],
                         "streamed_decode_tokens_per_s": (out[bits]["results"][1]["tokens"] - 1)
                         / out[bits]["results"][1]["decode_s"]}
            for bits in (8, 4)
        },
    }
    emit(row)
    return row


def phase_sp_family_serve(family: str, model_dir: str, port: int, model: str, prompt_text: str, lse,
                          rank_cfg, halves: int) -> dict:
    """A family's serve checkpoint served a second time, under sp = 2 on
    ["cuda:0", "cuda:0"], and once single-device to hold it against, both
    with f32 params (the checkpoint's bf16 weights upcast: in bf16 the sp
    prefill's dense sums and the single device's prefill kernel round
    apart): the serve phase's requests plus one streamed prompt of ~2,100
    tokens whose KV crosses the shard boundary at 2,048, 64 tokens each.
    The greedy texts must be equal; the mesh pass launches exactly 2 x
    layers `lse` forms a decode step (gpt_oss: none, no kernel at all); its
    /health shows each rank's KV bytes, cache_nbytes(rank_cfg) x `halves`
    (gpt_oss's two flat halves)."""
    from dnet_tpu_torch.core.kvcache import cache_nbytes

    chat = {"model": model, "max_tokens": MAX_TOKENS, "temperature": 0,
            "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
    by_kind = {"greedy": chat, "streamed": dict(chat, stream=True),
               "sampled": dict(chat, temperature=0.8, top_p=0.95, seed=1234)}
    kinds = list(SERVE_KINDS) + ["streamed_long"]
    reqs = [by_kind[k] for k in SERVE_KINDS] + [dict(chat, stream=True, messages=[
        {"role": "user", "content": _long_prompt(SP_LONG_TOKENS)}])]
    out = {}
    for mesh in (False, True):
        args = Namespace(host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
                         max_seq_len=S, param_dtype="float32", max_concurrent=8, request_timeout_s=600.0,
                         mesh="sp=2" if mesh else "", mesh_devices=SP_DEVICES if mesh else None)
        results, launches, load_s, health = asyncio.run(_drive(args, reqs))
        for k, r in zip(kinds, results):
            check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"{family} sp_serve mesh={mesh} {k}: {r['status']}")
        out[mesh] = (results, launches, load_s, health)
    results, launches, load_s, health = out[True]
    single = out[False][0]
    decode_steps = sum(r["tokens"] - 1 for r in results)
    layers = rank_cfg.n_layers * halves
    expected = {lse: 2 * layers * decode_steps} if lse else {}
    check({k: v for k, v in launches.items() if v} == expected, f"{family} sp_serve launches {launches} != {expected}")
    want_rank = cache_nbytes(rank_cfg) * halves
    engine = health["engine"]
    check(engine["sp"] == 2 and engine["devices"] == SP_DEVICES and engine["kv_bytes_per_rank"] == [want_rank] * 2,
          f"{family} sp_serve /health {engine} != {want_rank} a rank")
    greedy = [i for i, k in enumerate(kinds) if k != "sampled"]
    check(all(results[i]["content"] == single[i]["content"] for i in greedy),
          f"{family} sp f32 greedy text differs from the single-device f32 serve")
    row = {
        "phase": "sp_serve", "family": family, "gpu": gpu_line(), "sp": 2, "devices": SP_DEVICES,
        "param_dtype": "float32", "launches": expected, "decode_steps": decode_steps, "load_s": load_s,
        "single_device_load_s": out[False][2], "long_prompt_tokens": SP_LONG_TOKENS,
        "greedy_text_equal_single_device": True,
        "sampled_text_equal_single_device": results[2]["content"] == single[2]["content"],
        "kv_bytes_per_rank": engine["kv_bytes_per_rank"], "kv_bytes": engine["kv_bytes"],
        **streamed_rates(results[: len(SERVE_KINDS)]),
        "single_device": streamed_rates(single[: len(SERVE_KINDS)]),
        "long_prompt": {"ttft_s": results[-1]["ttft_s"],
                        "decode_tokens_per_s": (results[-1]["tokens"] - 1) / results[-1]["decode_s"],
                        "single_device_ttft_s": single[-1]["ttft_s"]},
        "content_head": results[0]["content"][:40],
    }
    emit(row)
    return row


# sequence-parallel serving (the seventh path): the ranks the kernels'
# rows split one 4096-slot cache into, the rows' positions (rank 0's last
# slot and rank 1's first at R = 2, and R = 4's boundaries), and the
# sp_serve long prompt's templated tokens (its KV crosses 2048 in prefill)
SP_RANKS = (2, 4)
LSE_POSITIONS = [0, 1023, 1024, 2047, 2048, 4095]
SP_LONG_TOKENS = 2100
SP_SERVE_POS = SP_LONG_TOKENS + MAX_TOKENS // 2  # the long request half-way through its output
SP_DEVICES = ["cuda:0", "cuda:0"]  # the script needs one card: both ranks share it


def lse_bound(live: int, dtype) -> tuple:
    """(ms, bound_by) for one rank's LSE call: q read once, the rank's live
    K and V rows once, acc [H, D] and m, l [H] written once in f32; 4*D
    operations per (head, live key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = H * D * size + 2 * live * KVH * D * size + (H * D + 2 * H) * 4
    return bytes_ops_bound(nbytes, 4 * H * D * live, dtype)


def lse_errors(out, want) -> dict:
    """The kernel's partials against the plain version's: m (live heads),
    l relative to itself, and the rank's output acc / l; an empty rank's
    partials must be exactly (0, NEG_INF, 0) on both sides."""
    from dnet_tpu_torch.ops.flash_decode import NEG_INF

    (acc, m, l), (wa, wm, wl) = out, want
    live = wl > 0
    B, kvh, g = m.shape
    empty_ok = bool((m[~live] == NEG_INF).all() and (l[~live] == 0).all()
                    and (acc.reshape(B, kvh, g, -1)[~live] == 0).all() and (wm[~live] == NEG_INF).all())
    check(empty_ok, "an empty rank's partials are not (0, NEG_INF, 0)")
    if not live.any():
        return {"m_err": 0.0, "l_rel_err": 0.0, "out_err": 0.0}

    def norm(a, d):
        return (a.reshape(B, kvh, g, -1) / d.clamp(min=1e-30)[..., None])[live]

    return {"m_err": (m - wm)[live].abs().max().item(),
            "l_rel_err": ((l - wl)[live] / wl[live]).abs().max().item(),
            "out_err": (norm(acc, l) - norm(wa, wl)).abs().max().item()}


def phase_lse_kernels(serve_pos: int) -> dict:
    """The decode kernel's LSE form (one sp rank's unnormalised partials)
    at Llama-3.2-1B's widths: a 4096-slot cache split into R = 2 and 4
    shards on cuda:0, at LSE_POSITIONS and the sp_serve step's position, f32
    and bf16.  Each rank's partials against the plain version at the plain
    decode's tolerances (TOL), the combined ranks against flash_decode over
    the whole cache.  Times (R = 2 at the serve position, and its empty
    rank at pos 2047): CUDA events, each call reading one of 16 layers'
    shards; library yardstick SDPA over the rank's live slots (a normalised
    output, not LSE partials; none for an empty rank).  Returns the main
    row: bf16, R = 2, rank 0 at the serve position."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_decode import (
        decode_lengths,
        flash_decode_attend,
        flash_decode_lse,
        flash_decode_lse_plain,
        rank_live,
        sp_lengths,
    )
    from dnet_tpu_torch.ops.ring_attention import lse_combine
    from dnet_tpu_torch.parallel.mesh import SpGroup

    g = torch.Generator(device="cuda").manual_seed(11)
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        for R in SP_RANKS:
            s_local = S // R
            sp = SpGroup(["cuda:0"] * R)
            for pos in dict.fromkeys(LSE_POSITIONS + [serve_pos]):
                q = torch.randn(1, 1, H, D, generator=g, device="cuda").to(dtype)
                lengths = sp_lengths(1, pos, s_local, sp.devices)
                parts = []
                for r in range(R):
                    live = rank_live(pos, r, s_local)
                    sl = slice(r * s_local, (r + 1) * s_local)
                    out = flash_decode_lse(q, kc[0][:, sl], vc[0][:, sl], lengths[r], live)
                    torch.cuda.synchronize()
                    want = flash_decode_lse_plain(q.float(), kc[0][:, sl].float(), vc[0][:, sl].float(), lengths[r])
                    errs = lse_errors(out, want)
                    check(max(errs.values()) <= TOL[dtype], f"lse R={R} pos={pos} rank {r} {dtype}: {errs}")
                    parts.append(out)
                    qt = q.transpose(1, 2)
                    bound, by = lse_bound(live, dtype)
                    row = {
                        "phase": "kernels", "kernel": "flash_decode_lse", "dtype": str(dtype).split(".")[-1],
                        "R": R, "rank": r, "pos": pos, "live": live, "S_local": s_local, "H": H, "KVH": KVH,
                        "D": D, **errs, "max_err": max(errs.values()), "tol": TOL[dtype],
                        "m_max": out[1].max().item(), "l_max": out[2].max().item(), "bound_ms": bound, "bound_by": by,
                    }
                    # timed: R = 2 at the serve position, and its empty rank at 2047
                    if R == 2 and (pos == serve_pos or (pos == 2047 and r == 1)):
                        row.update({
                            "kernel_ms": device_time_ms(
                                lambda l: flash_decode_lse(q, kc[l][:, sl], vc[l][:, sl], lengths[r], live), LAYERS),
                            "plain_ms": device_time_ms(
                                lambda l: flash_decode_lse_plain(q, kc[l][:, sl], vc[l][:, sl], lengths[r],
                                                                 max_live=live), LAYERS, 3),
                            "library_ms": device_time_ms(
                                lambda l: sdpa(qt, kc[l][:, r * s_local : r * s_local + live].transpose(1, 2),
                                               vc[l][:, r * s_local : r * s_local + live].transpose(1, 2),
                                               enable_gqa=True), LAYERS) if live else None,
                            "library_call": "scaled_dot_product_attention over the rank's live slots (a normalised "
                                            "output, not LSE partials)",
                        })
                    emit(row)
                    if dtype == torch.bfloat16 and R == 2 and pos == serve_pos and r == 0:
                        main = row
                combined = lse_combine(parts, sp, None, dtype)
                whole = flash_decode_attend(q, kc[0], vc[0], decode_lengths(1, pos, "cuda"), pos + 1)
                torch.cuda.synchronize()
                err = (combined.float() - whole.float()).abs().max().item()
                check(combined.shape == q.shape and err <= TOL[dtype], f"lse combine R={R} pos={pos} {dtype}: {err}")
                emit({"phase": "kernels", "kernel": "flash_decode_lse", "combined_vs_flash_decode": True,
                      "dtype": str(dtype).split(".")[-1], "R": R, "pos": pos, "max_err": err, "tol": TOL[dtype]})
        del kc, vc
    torch.cuda.empty_cache()
    return {"flash_decode_lse": main}


# the LSE form's MLA-width and code-reading forms: the kernels-line counter,
# qbits, (Dqk, Dv), H, KVH, and the layers whose caches the timed calls
# rotate through; DeepSeek-V2-Lite's MLA widths, or Llama-3.2-1B's for the
# (64, 64) codes
LSE_FORMS = [("flash_decode_lse_mla", 0, MLA_DQK, MLA_DV, MLA_H, MLA_H, MLA_LAYERS),
             ("flash_decode_lse_q8", 8, D, D, H, KVH, LAYERS), ("flash_decode_lse_q4", 4, D, D, H, KVH, LAYERS),
             ("flash_decode_lse_mla_q8", 8, MLA_DQK, MLA_DV, MLA_H, MLA_H, MLA_LAYERS),
             ("flash_decode_lse_mla_q4", 4, MLA_DQK, MLA_DV, MLA_H, MLA_H, MLA_LAYERS)]


def lse_form_bound(live: int, qbits: int, dqk: int, dv: int, heads: int, kv_heads: int, dtype) -> tuple:
    """(ms, bound_by) for one rank's LSE call: q read once (in `dtype`),
    each live slot's K and V once as the cache stores them (values in
    `dtype`, or codes plus two 4-byte f32 scales a slot and KV head), acc
    [H, Dv] and m, l [H] written once in f32; 2 * (Dqk + Dv) operations per
    (head, live key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    row = {0: (dqk + dv) * size, 8: dqk + dv + 8, 4: (dqk + dv) // 2 + 8}[qbits]
    nbytes = heads * dqk * size + live * kv_heads * row + (heads * dv + 2 * heads) * 4
    return bytes_ops_bound(nbytes, 2 * heads * (dqk + dv) * live, dtype)


def phase_lse_form_kernels(serve_pos: int) -> dict:
    """The LSE form at DeepSeek-V2-Lite's MLA widths (H = KVH = 16,
    (192, 128), G = 1, its softmax scale; f32 and bf16) and over int8 /
    packed-int4 codes the port's write_kv quantized from bf16 rows, at
    (64, 64) (Llama-3.2-1B's H=32, KVH=8) and at (192, 128), under bf16 q:
    R = 2 shards of a 4,096-slot cache at pos 2047 (rank 1 empty: exactly
    (0, NEG_INF, 0)) and at the sp_serve step's position (rank 0 with
    2,048 live slots).  Each rank's partials against the plain version
    (TOL), the combined ranks against flash_decode over the whole cache;
    times with CUDA events, each call reading one layer's shard of
    `layers`; library yardstick SDPA over the rank's live slots (on a
    dequantized bf16 copy of codes, the dequant not timed).  Returns the
    main rows: bf16, rank 0 at the serve position."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, read_kv, write_kv
    from dnet_tpu_torch.ops.flash_decode import (
        decode_lengths,
        flash_decode_attend,
        flash_decode_lse,
        flash_decode_lse_plain,
        rank_live,
        sp_lengths,
    )
    from dnet_tpu_torch.ops.ring_attention import lse_combine
    from dnet_tpu_torch.parallel.mesh import SpGroup

    g = torch.Generator(device="cuda").manual_seed(12)
    mla_scale = _mla_scale()
    R, s_local = 2, S // 2
    sp = SpGroup(["cuda:0"] * R)
    main = {}
    cases = [(LSE_FORMS[0], torch.float32)] + [(f, torch.bfloat16) for f in LSE_FORMS]
    for (name, bits, dqk, dv, heads, kv_heads, L), dtype in cases:
        scale = mla_scale if dqk == MLA_DQK else None
        if bits:
            kv = init_cache(KVConfig(L, 1, S, kv_heads, dqk, v_head_dim=dv, quant_bits=bits), torch.device("cuda"))
            for c in (layer_slices(kv, l) for l in range(L)):
                write_kv(c, torch.randn(1, S, kv_heads, dqk, generator=g, device="cuda").to(torch.bfloat16),
                         torch.randn(1, S, kv_heads, dv, generator=g, device="cuda").to(torch.bfloat16), 0)
        else:
            kv = {"k": torch.randn(L, 1, S, kv_heads, dqk, generator=g, device="cuda").to(dtype),
                  "v": torch.randn(L, 1, S, kv_heads, dv, generator=g, device="cuda").to(dtype)}
        for pos in (2047, serve_pos):
            q = torch.randn(1, 1, heads, dqk, generator=g, device="cuda").to(dtype)
            lengths = sp_lengths(1, pos, s_local, sp.devices)
            parts = []
            for r in range(R):
                live = rank_live(pos, r, s_local)
                shards = [{n: t[l][:, r * s_local : (r + 1) * s_local] for n, t in kv.items()} for l in range(L)]

                def kern(l):
                    c = shards[l]
                    return flash_decode_lse(q, c["k"], c["v"], lengths[r], live, scale=scale,
                                            k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))

                def plain(l):
                    c = shards[l]
                    return flash_decode_lse_plain(q, c["k"], c["v"], lengths[r], scale=scale, max_live=live,
                                                  k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))

                out = kern(0)
                torch.cuda.synchronize()
                c0 = shards[0]
                want = flash_decode_lse_plain(q.float(), c0["k"] if bits else c0["k"].float(),
                                              c0["v"] if bits else c0["v"].float(), lengths[r], scale=scale,
                                              k_scale=c0.get("k_scale"), v_scale=c0.get("v_scale"))
                errs = lse_errors(out, want)
                check(out[0].shape == (1, 1, heads, dv) and max(errs.values()) <= TOL[dtype],
                      f"{name} {dtype} pos={pos} rank {r}: {errs}")
                parts.append(out)
                # the yardstick: each layer's live slots of the rank, dequantized to bf16 for codes
                lib_kv = []
                for c in shards if live else ():
                    kc, vc = read_kv({n: t[:, :live] for n, t in c.items()})
                    lib_kv.append(tuple(t.to(dtype).transpose(1, 2) for t in (kc, vc)))
                qt = q.transpose(1, 2)
                bound, by = lse_form_bound(live, bits, dqk, dv, heads, kv_heads, dtype)
                row = {
                    "phase": "kernels", "kernel": name, "dtype": str(dtype).split(".")[-1],
                    "cache": {0: str(dtype).split(".")[-1], 8: "q8", 4: "q4"}[bits], "R": R, "rank": r, "pos": pos,
                    "live": live, "S_local": s_local, "H": heads, "KVH": kv_heads, "Dqk": dqk, "Dv": dv,
                    "scale": scale or dqk**-0.5, **errs, "max_err": max(errs.values()), "tol": TOL[dtype],
                    "empty_rank_exact": live == 0,
                    "kernel_ms": device_time_ms(kern, L), "plain_ms": device_time_ms(plain, L, 3),
                    "library_ms": device_time_ms(
                        lambda l: sdpa(qt, lib_kv[l][0], lib_kv[l][1], scale=scale, enable_gqa=True), L)
                    if live else None,
                    "library_call": "scaled_dot_product_attention over the rank's live slots (a normalised "
                                    "output, not LSE partials" + ("; on a dequantized bf16 copy, dequant not timed)"
                                                                  if bits else ")"),
                    "bound_ms": bound, "bound_by": by,
                }
                emit(row)
                if dtype == torch.bfloat16 and pos == serve_pos and r == 0:
                    main[name] = row
                del lib_kv, shards
            combined = lse_combine(parts, sp, None, dtype)
            whole = flash_decode_attend(q, kv["k"][0], kv["v"][0], decode_lengths(1, pos, "cuda"), pos + 1,
                                        scale=scale, **{n: kv[n][0] for n in ("k_scale", "v_scale") if n in kv})
            torch.cuda.synchronize()
            err = (combined.float() - whole.float()).abs().max().item()
            check(combined.shape == (1, 1, heads, dv) and err <= TOL[dtype], f"{name} combine pos={pos} {dtype}: {err}")
            emit({"phase": "kernels", "kernel": name, "combined_vs_flash_decode": True,
                  "dtype": str(dtype).split(".")[-1], "R": R, "pos": pos, "max_err": err, "tol": TOL[dtype]})
        del kv
        torch.cuda.empty_cache()
    return main


def phase_sp_parity() -> dict:
    """The sp engine on the card (two ranks on cuda:0, the LSE kernel) against
    the same engine with both ranks on the CPU (plain versions) and against
    the GPU's single-device engine, same f32 weights, max_seq 128: a 69-token
    prompt across the shard boundary at 64, prefill logits within 2e-3, 16
    equal greedy tokens, and exactly ranks x layers launches of the LSE form
    of the cache's variant per decode step with no other kernel.  Llama
    (plain and q4), deepseek_v2 at the real MLA head widths (3 layers;
    plain, q8 and q4) and gpt_oss (2 layers, head dim 64, G = 8; plain and
    q8, no kernel at all: the dense sp attention).  gpt_oss's single device
    attends a prompt's own keys unquantized in its sliding ring, so under q8
    its gap to the single device is printed, not held.  Under q4 the CPU
    ranks' gap is printed, not held: their K/V rows differ from the card's
    by f32 rounding before they are quantized, and a value that rounds to
    the next of int4's 15 codes moves by 1/7 of its row's max; the single
    device on the card computes the same rows as the sp ranks there.
    Returns the launches by kernel-line name, summed."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.parallel.engine import MeshEngine

    models = {"llama": _small_model(), "deepseek_v2": _ds_small(), "gpt_oss": _oss_small(layers=2)}
    cases = [("llama", 0), ("llama", 4), ("deepseek_v2", 0), ("deepseek_v2", 8), ("deepseek_v2", 4),
             ("gpt_oss", 0), ("gpt_oss", 8)]
    prompt = [(13 * i) % 500 + 1 for i in range(69)]
    steps, total = 15, {}
    for family, bits in cases:
        cfg, window, edge = models[family]
        kw = dict(max_seq=128, param_dtype="float32", kv_quant_bits=bits)
        engines = {"cuda": MeshEngine.from_params(cfg, window, edge, sp=2, devices=SP_DEVICES, **kw),
                   "cpu": MeshEngine.from_params(cfg, window, edge, sp=2, devices=["cpu", "cpu"], **kw),
                   "single": LocalEngine.from_params(cfg, window, edge, device="cuda", **kw)}
        held = {(True, False): ("cpu",), (False, True): ("single",)}.get(
            (family == "gpt_oss" and bits > 0, bits == 4), ("cpu", "single"))
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = {dev: (logits["cuda"] - logits[dev]).abs().max().item() for dev in ("cpu", "single")}
        check(bool(torch.isfinite(logits["cuda"]).all()) and max(err[d] for d in held) <= 2e-3,
              f"sp parity {family} q{bits} logits {err}")
        streams, launches = {}, None
        for dev, e in engines.items():
            torch.cuda.synchronize()
            reset_launch_counts()
            streams[dev] = [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
            torch.cuda.synchronize()
            if dev == "cuda":
                launches = {k: v for k, v in launch_counts().items() if v}
        check(all(streams["cuda"] == streams[d] for d in held), f"sp {family} q{bits} greedy streams differ: {streams}")
        layers = cfg.num_hidden_layers
        want = {}
        if family != "gpt_oss":
            name = "flash_decode_lse" + ("_mla" if family == "deepseek_v2" else "") + (f"_q{bits}" if bits else "")
            want = {name: 2 * layers * steps}
        check(launches == want, f"sp parity {family} q{bits} launches {launches} != {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "sp_parity", "family": family, "kv_bits": bits, "layers": layers, "sp": 2,
              "devices": SP_DEVICES, "max_seq": 128, "prompt_tokens": len(prompt), "logits_max_err": err,
              "held_against": list(held), "tol": 2e-3, "greedy_tokens": len(streams["cuda"]),
              "greedy_equal": {d: streams["cuda"] == streams[d] for d in ("cpu", "single")}, "launches": launches,
              "decode_steps": steps})
        del engines
    return total


def _long_prompt(n_tokens: int) -> str:
    """Chat content whose templated prompt is n_tokens long under the byte
    tokenizer."""
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    overhead = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": ""}])))
    rng = random.Random(1)
    words = ["ring", "rank", "shard", "slot", "sequence", "cache", "query", "key", "value", "combine"]
    text = "Long context: " + " ".join(rng.choice(words) for _ in range(n_tokens))
    return text[: n_tokens - overhead]


def _template_ids(content: str) -> list:
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    return tok.encode(tok.apply_chat_template([{"role": "user", "content": content}]))


def phase_sp_step(cfg, window, edge, phase: str = "sp_step", model: str = "Llama-3.2-1B",
                  lse: str = "flash_decode_lse", kv_row_bytes: int = KVH * 2 * D * 2) -> dict:
    """Where one full-width sp = 2 greedy decode step goes (bf16, max_seq
    4096, both ranks on cuda:0) at pos ~2,100, past the shard boundary:
    wall, host issue, device busy (profiler), the LSE kernels' share, the
    launches per step (exactly 2 x layers of the `lse`
    form), and the bound (the weights and the live K/V read once;
    `kv_row_bytes` per layer and position: Llama-3.2-1B's 8 KV heads x
    (64 + 64) bf16 by default).  Also the bf16 prefill logits' gap against
    the single-device engine on the same prompt (the sp prefill is the
    dense path, the single device's the prefill kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.parallel.engine import MeshEngine

    ids = _template_ids(_long_prompt(SP_LONG_TOKENS))
    single = LocalEngine.from_params(cfg, window, edge, max_seq=S, device="cuda")
    want = single.prefill("s", ids).float()
    single.end_session("s")
    del single
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = MeshEngine.from_params(cfg, window, edge, sp=2, max_seq=S, devices=SP_DEVICES)
    t0 = time.perf_counter()
    got = eng.prefill("s", ids).float()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    gap = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{phase} prefill logits")
    d = DecodingParams()
    tok = int(got[0].argmax())
    for _ in range(5):
        tok = int(eng.decode_step("s", tok, d).token[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        res = eng.decode_step("s", tok, d)
        issue.append((time.perf_counter() - t0) * 1e3)
        tok = int(res.token[0])  # waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in launch_counts().items() if v}
    layers = cfg.num_hidden_layers
    check(launches == {lse: 2 * layers * 20}, f"{phase} launches {launches}")
    steps = 5
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = int(eng.decode_step("s", tok, d).token[0])
        torch.cuda.synchronize()
    per_step = {k: v / steps for k, v in launch_counts().items() if v}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    lse_ms = sum(e.self_device_time_total for e in kernels if "flash_decode" in e.name) / 1e3 / steps
    check(device_ms > 0, "the profiler saw no device time")
    wall_ms = statistics.median(wall)
    pos = eng.sessions["s"].pos
    head = edge["lm_head"]["weight"] if "lm_head" in edge else edge["embed"]["weight"]
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += head.numel() * head.element_size()
    kv_bytes = layers * pos * kv_row_bytes
    row = {"phase": phase, "gpu": gpu_line(), "sp": 2, "devices": SP_DEVICES,
           "model": f"{model} (synthetic bf16 weights, seed 0)", "layers": layers, "prompt_tokens": len(ids),
           "prefill_s": prefill_s, "prefill_logits_gap_vs_single_device": gap, "steps": len(wall), "pos": pos,
           "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue), "device_busy_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms, "lse_kernels_ms": lse_ms,
           "lse_launches_per_step": launches[lse] // 20, "kernel_launches": len(kernels) // steps,
           "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
           "bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
           "kv_bytes_per_rank": eng.kv_bytes_per_rank, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    eng.close()
    return row


# /health engine.kv_bytes_per_rank at sp = 2, max_seq 4096: 16 layers x 2048
# slots x 8 KV heads x 64, k and v, per param dtype
SP_RANK_KV_BYTES = {"float32": 134_217_728, "bfloat16": 67_108_864}
# and under DNET_KV_BITS=8: int8 codes (64 + 64 B) plus two 4-byte f32 scales
# per slot and KV head
SP_RANK_Q8_KV_BYTES = 35_651_584


def phase_sp_serve(model_dir: str, port: int, bodies: list, long_body: dict, sp_step: dict) -> dict:
    """The serve phase's checkpoint served by the port's HTTP server through
    the model manager with a mesh of sp = 2 on ["cuda:0", "cuda:0"]: the
    serve phase's requests plus one streamed prompt of ~2,100 tokens, 64
    tokens each.  In f32 the greedy text must equal a single-device f32
    serve of the same checkpoint; in bf16 it is served once (sp prefill is
    the reference's dense path, the single device's the prefill kernel, so
    their texts part).  Every decode step
    launches the LSE form 2 x 16 times, and nothing else; /health shows both
    ranks' KV bytes.  Then DNET_KV_BITS=8 under sp, f32 params, against a
    single-device f32 q8 serve, with the greedy, streamed and long requests:
    equal greedy text, 2 x 16 launches of the
    LSE form over int8 codes a step, 35,651,584 KV bytes a rank."""
    from dnet_tpu_torch.core.kvcache import KVConfig, cache_nbytes

    kinds = list(SERVE_KINDS) + ["streamed_long"]
    reqs = bodies + [long_body]

    def serve(dtype: str, mesh: bool, requests: list, names: list = kinds):
        args = Namespace(host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
                         max_seq_len=S, param_dtype=dtype, max_concurrent=8, request_timeout_s=600.0,
                         mesh="sp=2" if mesh else "", mesh_devices=SP_DEVICES if mesh else None)
        results, launches, load_s, health = asyncio.run(_drive(args, requests))
        for k, r in zip(names, results):
            check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"sp_serve {dtype} mesh={mesh} {k}: {r['status']}")
        return results, launches, load_s, health

    single32 = serve("float32", False, reqs)
    passes, total = {}, {}
    for dtype in ("float32", "bfloat16"):
        results, launches, load_s, health = serve(dtype, True, reqs)
        decode_steps = sum(r["tokens"] - 1 for r in results)
        expected = {"flash_decode_lse": 2 * LAYERS * decode_steps}
        check({k: v for k, v in launches.items() if v} == expected,
              f"sp_serve {dtype} launches {launches} != {expected}")
        engine = health["engine"]
        check(engine["sp"] == 2 and engine["devices"] == SP_DEVICES
              and engine["kv_bytes_per_rank"] == [SP_RANK_KV_BYTES[dtype]] * 2, f"sp_serve {dtype} /health {engine}")
        for k, v in expected.items():
            total[k] = total.get(k, 0) + v
        passes[dtype] = {"results": results, "launches": expected, "load_s": load_s, "engine": engine,
                         "decode_steps": decode_steps}
    greedy = [i for i, k in enumerate(kinds) if k != "sampled"]
    mesh32 = passes["float32"]["results"]
    check(all(mesh32[i]["content"] == single32[0][i]["content"] for i in greedy),
          "sp f32 greedy text differs from the single-device f32 serve")
    # the quantized cache under sp (DNET_KV_BITS=8): f32 params, as the f32
    # pass, single device first, without the sampled request; 2 x 16
    # launches of the LSE form over codes
    q8_kinds = [k for k in kinds if k != "sampled"]
    q8_reqs = [r for k, r in zip(kinds, reqs) if k != "sampled"]
    with environ({"DNET_KV_BITS": "8"}):
        single_q8 = serve("float32", False, q8_reqs, q8_kinds)[0]
        q8, q8_launches, q8_load_s, q8_health = serve("float32", True, q8_reqs, q8_kinds)
    q8_steps = sum(r["tokens"] - 1 for r in q8)
    q8_expected = {"flash_decode_lse_q8": 2 * LAYERS * q8_steps}
    check({k: v for k, v in q8_launches.items() if v} == q8_expected,
          f"sp_serve q8 launches {q8_launches} != {q8_expected}")
    q8_engine = q8_health["engine"]
    want_q8 = cache_nbytes(KVConfig(LAYERS, 1, S // 2, KVH, D, quant_bits=8))
    check(q8_engine["kv_quant_bits"] == 8 and q8_engine["kv_bytes_per_rank"] == [want_q8] * 2
          and want_q8 == SP_RANK_Q8_KV_BYTES, f"sp_serve q8 /health {q8_engine} != {SP_RANK_Q8_KV_BYTES} a rank")
    check(all(a["content"] == b["content"] for a, b in zip(q8, single_q8)),
          "sp q8 greedy text differs from the single-device q8 serve")
    total.update(q8_expected)

    mesh16 = passes["bfloat16"]["results"]
    row = {
        "phase": "sp_serve", "gpu": gpu_line(), "sp": 2, "devices": SP_DEVICES,
        "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)", "launches": total,
        "long_prompt_tokens": SP_LONG_TOKENS,
        "float32": {
            "greedy_text_equal_single_device": True,
            "sampled_text_equal_single_device": mesh32[2]["content"] == single32[0][2]["content"],
            "load_s": passes["float32"]["load_s"], "decode_steps": passes["float32"]["decode_steps"],
            "kv_bytes_per_rank": passes["float32"]["engine"]["kv_bytes_per_rank"],
            **streamed_rates(mesh32[: len(SERVE_KINDS)]),
            "single_device": streamed_rates(single32[0][: len(SERVE_KINDS)]),
            "long_prompt": {"ttft_s": mesh32[-1]["ttft_s"],
                            "decode_tokens_per_s": (mesh32[-1]["tokens"] - 1) / mesh32[-1]["decode_s"],
                            "single_device_ttft_s": single32[0][-1]["ttft_s"]},
        },
        "bfloat16": {
            "text_chars": len(mesh16[0]["content"]),
            "prefill_logits_gap_vs_single_device": sp_step["prefill_logits_gap_vs_single_device"],
            "load_s": passes["bfloat16"]["load_s"], "decode_steps": passes["bfloat16"]["decode_steps"],
            "kv_bytes_per_rank": passes["bfloat16"]["engine"]["kv_bytes_per_rank"],
            **streamed_rates(mesh16[: len(SERVE_KINDS)]),
            "long_prompt": {"ttft_s": mesh16[-1]["ttft_s"],
                            "decode_tokens_per_s": (mesh16[-1]["tokens"] - 1) / mesh16[-1]["decode_s"]},
        },
        "q8": {
            "param_dtype": "float32", "greedy_text_equal_single_device_q8": True,
            "load_s": q8_load_s, "decode_steps": q8_steps, "kv_bytes_per_rank": q8_engine["kv_bytes_per_rank"],
            **streamed_rates(q8[:2]),
            "single_device_q8": streamed_rates(single_q8[:2]),
            "long_prompt": {"ttft_s": q8[-1]["ttft_s"],
                            "decode_tokens_per_s": (q8[-1]["tokens"] - 1) / q8[-1]["decode_s"]},
        },
    }
    emit(row)
    return row


# Qwen3-MoE (the eighth path): Qwen3-235B-A22B's attention, H = 64 query
# heads over KVH = 4 (G = 16, two row groups of 8 a KV head) at head dim
# 128; the 235B serve's layers; the serve's /health KV bytes (1 layer x 4096
# slots x 4 KV heads x (k 128 + v 128) x 2 B)
QW_H, QW_KVH, QW_D = 64, 4, 128
QW_SERVE_LAYERS = 1
QW_MODEL = "qwen3-235b-a22b-synthetic"
QW_SERVE_KV_BYTES = 8_388_608


def phase_wide_kernels(serve_pos: int) -> dict:
    """The decode and paged kernels at Qwen3-235B-A22B's G = 16 (row groups
    of blocks), f32 and bf16: decode over a 16-layer 4096-slot cache at the
    qwen3_moe serve's position and at 4095, paged over a 16-layer pool of
    POOL_BLOCKS blocks at the batch_serve mix; each against its plain
    version (TOL), one count on its wide counter a call, timed beside the
    plain version, SDPA (enable_gqa; for paged on a pre-gathered contiguous
    copy) and its bound; bf16 runs the tensor-core forms (MMA_TOL, counted
    on launches_mma too).  Returns the bf16 rows at the serve's position and
    the batch mix, also as the tensor-core forms' rows."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_decode import MMA_TOL, decode_lengths, flash_decode_attend, flash_decode_plain
    from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain

    g = torch.Generator(device="cuda").manual_seed(15)
    main = {}
    positions = BATCH_POSITIONS
    per_slot = POOL_BLOCKS // BATCH_SLOTS
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        kc = torch.randn(LAYERS, 1, S, QW_KVH, QW_D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, QW_KVH, QW_D, generator=g, device="cuda").to(dtype)
        for pos in (serve_pos, S - 1):
            q = torch.randn(1, 1, QW_H, QW_D, generator=g, device="cuda").to(dtype)
            lengths = decode_lengths(1, pos, "cuda")
            before = flash_decode_attend.launches_wide, flash_decode_attend.launches_mma
            out = flash_decode_attend(q, kc[0], vc[0], lengths, pos + 1)
            torch.cuda.synchronize()
            check(flash_decode_attend.launches_wide == before[0] + 1, "flash_decode_wide did not count the call")
            mma = dtype == torch.bfloat16  # bf16 over a bf16 cache at head dim 128: the tensor-core form
            check(flash_decode_attend.launches_mma == before[1] + mma, "flash_decode_mma miscounted the call")
            want = flash_decode_plain(q.float(), kc[0].float(), vc[0].float(), lengths)
            err = (out.float() - want).abs().max().item()
            tol = MMA_TOL[dtype] if mma else TOL[dtype]
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "wide decode output")
            check(err <= tol, f"wide decode pos={pos} {dtype}: max err {err}")
            qt = q.transpose(1, 2)
            bound, by = decode_bound(pos, dtype, QW_H, QW_KVH, QW_D)
            row = {
                "phase": "kernels", "kernel": "flash_decode_wide", "dtype": name, "pos": pos, "S": S,
                "H": QW_H, "KVH": QW_KVH, "D": QW_D, "tensor_cores": mma, "max_err": err, "tol": tol,
                "kernel_ms": device_time_ms(lambda l: flash_decode_attend(q, kc[l], vc[l], lengths, pos + 1), LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_decode_plain(q, kc[l], vc[l], lengths, max_live=pos + 1),
                                           LAYERS, 5),
                "library_ms": device_time_ms(lambda l: sdpa(qt, kc[l, :, : pos + 1].transpose(1, 2),
                                                            vc[l, :, : pos + 1].transpose(1, 2), enable_gqa=True),
                                             LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            emit(row)
            if dtype == torch.bfloat16 and pos == serve_pos:
                main["flash_decode_wide"] = main["flash_decode_mma"] = row
        del kc, vc
        shape = (LAYERS, POOL_BLOCKS, BT, QW_KVH, QW_D)
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        B, max_live = len(positions), max(positions)
        tables = paged_tables(positions)
        pos_cpu = torch.tensor(positions, dtype=torch.int32)
        pos = pos_cpu.cuda()
        q = torch.randn(B, 1, QW_H, QW_D, generator=g, device="cuda").to(dtype)
        kn, vn = (torch.randn(B, QW_KVH, QW_D, generator=g, device="cuda").to(dtype) for _ in range(2))
        before = paged_attend.launches_wide, paged_attend.launches_mma
        out = paged_attend(q, kp[0], vp[0], tables, pos, kn, vn, max_live=max_live)
        torch.cuda.synchronize()
        mma = dtype == torch.bfloat16
        check(paged_attend.launches_wide == before[0] + 1, "paged_attend_wide did not count the call")
        check(paged_attend.launches_mma == before[1] + mma, "paged_attend_mma miscounted the call")
        want = paged_attend_plain(q.float(), kp[0].float(), vp[0].float(), tables, pos_cpu, kn.float(), vn.float())
        err = (out.float() - want).abs().max().item()
        tol = MMA_TOL[dtype] if mma else TOL[dtype]
        check(out.shape == q.shape and bool(torch.isfinite(out).all()), "wide paged output")
        check(err <= tol, f"wide paged {dtype}: max err {err}")
        # the library yardstick over each layer's live rows gathered once,
        # outside the timing, with the new row at pos[b]
        keys = max_live + 1
        j = torch.arange(keys, device="cuda")
        rows = tables.long()[:, (j // BT).clamp(max=per_slot - 1)] * BT + j % BT
        at_pos = j[None, :] == pos.long()[:, None]

        def contiguous(pool, new):
            c = pool.reshape(LAYERS, POOL_BLOCKS * BT, QW_KVH, QW_D)[:, rows]
            c = torch.where(at_pos[None, :, :, None, None], new[None, :, None], c)
            return c.transpose(2, 3).contiguous()

        kg, vg = contiguous(kp, kn), contiguous(vp, vn)
        mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)

        def lib(l):
            return sdpa(qt, kg[l], vg[l], attn_mask=mask, enable_gqa=True)

        lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
        check(lib_err <= TOL[dtype], f"wide paged library yardstick disagrees: {lib_err}")
        bound, by = paged_bound(positions, dtype, QW_H, QW_KVH, QW_D)
        row = {
            "phase": "kernels", "kernel": "paged_attend_wide", "dtype": name, "positions": positions,
            "sum_pos": sum(positions), "slots": B, "bt": BT, "pool_blocks": POOL_BLOCKS, "layers": LAYERS,
            "H": QW_H, "KVH": QW_KVH, "D": QW_D, "tensor_cores": mma, "max_err": err, "tol": tol,
            "kernel_ms": device_time_ms(
                lambda l: paged_attend(q, kp[l], vp[l], tables, pos, kn, vn, max_live=max_live), LAYERS),
            "plain_ms": device_time_ms(lambda l: paged_attend_plain(q, kp[l], vp[l], tables, pos_cpu, kn, vn),
                                       LAYERS, 5),
            "library_ms": device_time_ms(lib, LAYERS),
            "library_call": "scaled_dot_product_attention on a pre-gathered contiguous copy (the gather is not timed)",
            "library_max_err": lib_err, "bound_ms": bound, "bound_by": by,
        }
        row["times_library"] = row["kernel_ms"] / row["library_ms"]
        emit(row)
        if dtype == torch.bfloat16:
            main["paged_attend_wide"] = main["paged_attend_mma"] = row
        del kp, vp, kg, vg
        torch.cuda.empty_cache()
    return main


MMA_GROUPS = [5, 7, 8, 12, 16, 24]
MMA_POSITIONS = [0, 1, 63, 64, 65, 113, 2047, 4095]
MMA_TIMED_POS = 2047


def phase_mma_kernels() -> None:
    """The decode and paged kernels' tensor-core forms (bf16 q over a bf16
    cache at head dim 128) against their plain versions within MMA_TOL
    (tests/test_torch_decode_mma.py states it from its emulation of their
    numerics): decode, normalised and LSE, at G = 5, 7, 8, 12, 16 and 24
    (row groups of 16: 24 takes two) over 4 KV heads of a 16-layer
    4096-slot cache, one lane at each of MMA_POSITIONS and the eight lanes
    in one launch, one count a call on launches_mma, timed with one lane at
    MMA_TIMED_POS beside the plain version, SDPA (enable_gqa; for LSE a
    normalised output, as the LSE rows) and the bound; paged at G = 7, 8
    and 16 over the batch_serve mix (SDPA on a pre-gathered copy)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_decode import (
        MMA_TOL,
        flash_decode_attend,
        flash_decode_lse,
        flash_decode_lse_plain,
        flash_decode_plain,
    )
    from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain

    g = torch.Generator(device="cuda").manual_seed(16)
    bf, kvh, d = torch.bfloat16, QW_KVH, QW_D
    kc = torch.randn(LAYERS, 8, S, kvh, d, generator=g, device="cuda").to(bf)
    vc = torch.randn(LAYERS, 8, S, kvh, d, generator=g, device="cuda").to(bf)
    kf, vf = kc[0].float(), vc[0].float()
    for G in MMA_GROUPS:
        h = G * kvh
        q = torch.randn(8, 1, h, d, generator=g, device="cuda").to(bf)
        for lse in (False, True):
            errs = []
            for lanes in [[b] for b in range(8)] + [list(range(8))]:
                lens = torch.tensor([MMA_POSITIONS[b] + 1 for b in lanes], dtype=torch.int32, device="cuda")
                live = int(lens.max())
                qs, ks, vs = q[lanes], kc[0, lanes], vc[0, lanes]
                before = flash_decode_attend.launches_mma
                out = (flash_decode_lse if lse else flash_decode_attend)(qs, ks, vs, lens, live)
                torch.cuda.synchronize()
                check(flash_decode_attend.launches_mma == before + 1, f"G={G}: launches_mma did not count")
                if lse:
                    want = flash_decode_lse_plain(qs.float(), kf[lanes], vf[lanes], lens)
                    errs.append(max(lse_errors(out, want).values()))
                else:
                    want = flash_decode_plain(qs.float(), kf[lanes], vf[lanes], lens)
                    check(bool(torch.isfinite(out).all()) and out.shape == qs.shape, "tensor-core decode output")
                    errs.append((out.float() - want).abs().max().item())
            tol = MMA_TOL[torch.float32 if lse else bf]
            check(max(errs) <= tol, f"tensor-core decode G={G} lse={lse}: max err {max(errs)} > {tol}")
            pos = MMA_TIMED_POS
            lens = torch.full((1,), pos + 1, dtype=torch.int32, device="cuda")
            q1 = q[:1]
            qt = q1.transpose(1, 2)
            fn = flash_decode_lse if lse else flash_decode_attend
            plain = flash_decode_lse_plain if lse else flash_decode_plain
            bound, by = decode_bound(pos, bf, h, kvh, d)
            row = {
                "phase": "kernels", "kernel": "flash_decode_mma", "form": "lse" if lse else "normalised",
                "dtype": "bfloat16", "G": G, "H": h, "KVH": kvh, "D": d, "S": S, "positions": MMA_POSITIONS,
                "lanes": [1, 8], "max_err": max(errs), "tol": tol, "timed_pos": pos,
                "kernel_ms": device_time_ms(lambda l: fn(q1, kc[l, :1], vc[l, :1], lens, pos + 1), LAYERS),
                "plain_ms": device_time_ms(lambda l: plain(q1, kc[l, :1], vc[l, :1], lens, max_live=pos + 1),
                                           LAYERS, 5),
                "library_ms": device_time_ms(lambda l: sdpa(qt, kc[l, :1, : pos + 1].transpose(1, 2),
                                                            vc[l, :1, : pos + 1].transpose(1, 2), enable_gqa=True),
                                             LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            emit(row)
    del kc, vc, kf, vf
    torch.cuda.empty_cache()
    positions = BATCH_POSITIONS
    per_slot = POOL_BLOCKS // BATCH_SLOTS
    shape = (LAYERS, POOL_BLOCKS, BT, kvh, d)
    kp = torch.randn(shape, generator=g, device="cuda").to(bf)
    vp = torch.randn(shape, generator=g, device="cuda").to(bf)
    B, max_live = len(positions), max(positions)
    tables = paged_tables(positions)
    pos_cpu = torch.tensor(positions, dtype=torch.int32)
    pos = pos_cpu.cuda()
    keys = max_live + 1
    j = torch.arange(keys, device="cuda")
    rows = tables.long()[:, (j // BT).clamp(max=per_slot - 1)] * BT + j % BT
    at_pos = j[None, :] == pos.long()[:, None]
    mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
    for G in (7, 8, 16):
        h = G * kvh
        q = torch.randn(B, 1, h, d, generator=g, device="cuda").to(bf)
        kn, vn = (torch.randn(B, kvh, d, generator=g, device="cuda").to(bf) for _ in range(2))
        before = paged_attend.launches_mma
        out = paged_attend(q, kp[0], vp[0], tables, pos, kn, vn, max_live=max_live)
        torch.cuda.synchronize()
        check(paged_attend.launches_mma == before + 1, f"paged G={G}: launches_mma did not count")
        want = paged_attend_plain(q.float(), kp[0].float(), vp[0].float(), tables, pos_cpu, kn.float(), vn.float())
        err = (out.float() - want).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err <= MMA_TOL[bf], f"tensor-core paged G={G}: max err {err}")

        def contiguous(pool, new):
            c = pool.reshape(LAYERS, POOL_BLOCKS * BT, kvh, d)[:, rows]
            c = torch.where(at_pos[None, :, :, None, None], new[None, :, None], c)
            return c.transpose(2, 3).contiguous()

        kg, vg = contiguous(kp, kn), contiguous(vp, vn)
        qt = q.transpose(1, 2)
        bound, by = paged_bound(positions, bf, h, kvh, d)
        row = {
            "phase": "kernels", "kernel": "paged_attend_mma", "dtype": "bfloat16", "G": G, "H": h, "KVH": kvh,
            "D": d, "positions": positions, "slots": B, "bt": BT, "max_err": err, "tol": MMA_TOL[bf],
            "kernel_ms": device_time_ms(
                lambda l: paged_attend(q, kp[l], vp[l], tables, pos, kn, vn, max_live=max_live), LAYERS),
            "plain_ms": device_time_ms(lambda l: paged_attend_plain(q, kp[l], vp[l], tables, pos_cpu, kn, vn),
                                       LAYERS, 5),
            "library_ms": device_time_ms(lambda l: sdpa(qt, kg[l], vg[l], attn_mask=mask, enable_gqa=True), LAYERS),
            "library_call": "scaled_dot_product_attention on a pre-gathered contiguous copy (the gather is not timed)",
            "bound_ms": bound, "bound_by": by,
        }
        row["times_library"] = row["kernel_ms"] / row["library_ms"]
        emit(row)
        del kg, vg
    del kp, vp
    torch.cuda.empty_cache()


def _qwen_small(family: str, **overrides):
    """A small f32 model of `family` at its published heads (head dim 128):
    qwen2 at Qwen2.5-7B's 28 / 4 (G = 7, qkv biases), qwen3 at Qwen3-4B's
    32 / 8 (q/k norms), mixtral at Mixtral-8x7B's 32 / 8 (8 experts top-2),
    qwen3_moe at Qwen3-235B-A22B's 64 / 4 (G = 16; 8 experts top-2, layer 0
    dense through mlp_only_layers); hidden 512, narrow FFNs, 2 layers (3
    for qwen3_moe); `overrides` replace config entries (other heads)."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils import random_init as ri

    narrow = dict(vocab_size=512, hidden_size=512, intermediate_size=256, head_dim=QW_D, num_hidden_layers=2)
    cfg = {
        "qwen2": dict(ri.QWEN2_5_7B_CONFIG, **narrow),
        "qwen3": dict(ri.QWEN3_4B_CONFIG, **narrow),
        "mixtral": dict(ri.MIXTRAL_8X7B_CONFIG, **dict(narrow, intermediate_size=128)),
        "qwen3_moe": dict(ri.QWEN3_235B_A22B_CONFIG, **dict(narrow, num_hidden_layers=3), moe_intermediate_size=128,
                          num_experts=8, num_experts_per_tok=2, mlp_only_layers=[0]),
    }[family]
    cfg = ModelConfig.from_hf(dict(cfg, **overrides))
    window, edge = ri.random_qwen_params(cfg, range(cfg.num_hidden_layers), torch.device("cpu"), torch.float32,
                                         seed=6)
    return cfg, window, edge


# the bf16 parity's logits tolerance: on the CPU these models' bf16 engines
# sit 0.012 (qwen3) and 0.027 (qwen3_moe) from their f32 engines over 24
# teacher-forced steps (logits up to ~1.5); the card's bf16 products round
# at other places than the CPU's
BF16_LOGITS_TOL = 0.1


def _qwen_bf16_parity(family: str, overrides: dict, model: str, n_tokens: int = 24) -> dict:
    """`family` in bf16 on the card (the tensor-core decode form) against the
    CPU (plain versions), same weights: each engine's own greedy stream
    (their agreement and first divergence reported), exactly layers
    tensor-core decode launches a step, then the card's stream fed to both
    (teacher forcing) with the logits of the prompt and of every decode
    step within BF16_LOGITS_TOL."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg, window, edge = _qwen_small(family, **overrides)
    layers, G = cfg.num_hidden_layers, cfg.num_attention_heads // cfg.num_key_value_heads
    engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="bfloat16", device=dev)
               for dev in ("cuda", "cpu")}
    prompt = [(17 * i) % 500 + 1 for i in range(40)]
    streams, launches = {}, None
    for dev, e in engines.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        streams[dev] = [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=n_tokens, nonce="g")]
        torch.cuda.synchronize()
        if dev == "cuda":
            launches = {k: v for k, v in launch_counts().items() if v}
    dec = "flash_decode_wide" if G > 8 else "flash_decode"
    want = {"flash_prefill": layers, dec: layers * (n_tokens - 1), "flash_decode_mma": layers * (n_tokens - 1)}
    check(launches == want, f"{family} bf16 parity launches {launches} != {want}")
    agree = next((i for i, (a, b) in enumerate(zip(streams["cuda"], streams["cpu"])) if a != b), None)
    errs = []
    logits = {dev: e.prefill("t", prompt).float().cpu() for dev, e in engines.items()}
    errs.append((logits["cuda"] - logits["cpu"]).abs().max().item())
    for tok in streams["cuda"][:-1]:
        for dev, e in engines.items():
            sess = e.sessions["t"]
            token = torch.full((1, 1), tok, dtype=torch.int64, device=e.device)
            logits[dev] = e._forward(token, sess.kv, sess.pos, 0).float().cpu()
            sess.pos += 1
        check(bool(torch.isfinite(logits["cuda"]).all()), f"{family} bf16 logits")
        errs.append((logits["cuda"] - logits["cpu"]).abs().max().item())
    check(max(errs) <= BF16_LOGITS_TOL, f"{family} bf16 GPU vs CPU logits: {errs}")
    row = {"phase": "qwen_parity", "family": family, "dtype": "bfloat16", "model_heads": model, "layers": layers,
           "H": cfg.num_attention_heads, "KVH": cfg.num_key_value_heads, "D": cfg.head_dim, "G": G,
           "prompt_tokens": len(prompt), "logits_max_err": max(errs), "logits_err_by_step": errs,
           "tol": BF16_LOGITS_TOL, "greedy_tokens": n_tokens,
           "greedy_agree": n_tokens if agree is None else agree, "first_divergence": agree, "launches": launches}
    emit(row)
    del engines
    return launches


def phase_qwen_parity() -> dict:
    """qwen2, qwen3, mixtral and qwen3_moe on the card against the CPU
    (plain versions), same f32 weights (`_qwen_small`): a 40-token prompt,
    prefill logits within 2e-3 and 24 equal greedy tokens on the
    single-sequence engine, with exactly layers launches of the prefill
    kernel a prompt and of the decode kernel's form a step (G = 16: the
    wide counter); then qwen3_moe at sp = 2 on ["cuda:0", "cuda:0"] against
    cpu x 2 and the card's single device (a 69-token prompt across the
    shard boundary at 64, 16 tokens, 2 x layers wide LSE launches a step).
    Returns the launches by counter, summed."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.parallel.engine import MeshEngine

    total = {}
    prompt = [(17 * i) % 500 + 1 for i in range(40)]
    n_tokens = 24
    for family in ("qwen2", "qwen3", "mixtral", "qwen3_moe"):
        cfg, window, edge = _qwen_small(family)
        layers, G = cfg.num_hidden_layers, cfg.num_attention_heads // cfg.num_key_value_heads
        engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev)
                   for dev in ("cuda", "cpu")}
        reset_launch_counts()
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, 512), f"{family} logits")
        check(err <= 2e-3, f"{family} GPU vs CPU prefill logits: max err {err}")
        for e in engines.values():
            e.end_session("p")
        streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=n_tokens, nonce="g")]
                   for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"], f"{family} greedy streams differ: {streams}")
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        dec = "flash_decode_wide" if G > 8 else "flash_decode"
        expected = {"flash_prefill": layers * 2, dec: layers * (n_tokens - 1)}
        check(launches == expected, f"{family} parity launches {launches} != {expected}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "qwen_parity", "family": family, "layers": layers, "H": cfg.num_attention_heads,
              "KVH": cfg.num_key_value_heads, "D": cfg.head_dim, "G": G, "experts": cfg.num_local_experts,
              "prompt_tokens": len(prompt), "logits_max_err": err, "tol": 2e-3,
              "greedy_tokens": len(streams["cuda"]), "launches": launches})
        del engines
    # qwen3_moe's sp = 2 mesh: the wide LSE form on the card
    cfg, window, edge = _qwen_small("qwen3_moe")
    prompt = [(13 * i) % 500 + 1 for i in range(69)]
    kw = dict(max_seq=128, param_dtype="float32")
    engines = {"cuda": MeshEngine.from_params(cfg, window, edge, sp=2, devices=SP_DEVICES, **kw),
               "cpu": MeshEngine.from_params(cfg, window, edge, sp=2, devices=["cpu", "cpu"], **kw),
               "single": LocalEngine.from_params(cfg, window, edge, device="cuda", **kw)}
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    err = {dev: (logits["cuda"] - logits[dev]).abs().max().item() for dev in ("cpu", "single")}
    check(bool(torch.isfinite(logits["cuda"]).all()) and max(err.values()) <= 2e-3, f"qwen3_moe sp logits {err}")
    streams, launches = {}, None
    for dev, e in engines.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        streams[dev] = [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
        torch.cuda.synchronize()
        if dev == "cuda":
            launches = {k: v for k, v in launch_counts().items() if v}
    check(streams["cuda"] == streams["cpu"] == streams["single"], f"qwen3_moe sp greedy streams differ: {streams}")
    want = {"flash_decode_wide": 2 * cfg.num_hidden_layers * 15}
    check(launches == want, f"qwen3_moe sp parity launches {launches} != {want}")
    total["flash_decode_wide"] += want["flash_decode_wide"]
    emit({"phase": "qwen_parity", "family": "qwen3_moe", "sp": 2, "devices": SP_DEVICES,
          "layers": cfg.num_hidden_layers, "H": QW_H, "KVH": QW_KVH, "max_seq": 128, "prompt_tokens": len(prompt),
          "logits_max_err": err, "tol": 2e-3, "greedy_tokens": len(streams["cuda"]), "launches": launches,
          "decode_steps": 15})
    del engines
    # bf16 through the tensor-core decode form: Qwen3-235B-A22B's heads
    # (G = 16) and Qwen3-30B-A3B's (32 / 4, G = 8)
    for family, overrides, model in (("qwen3_moe", {}, "Qwen3-235B-A22B (64 / 4)"),
                                     ("qwen3", {"num_key_value_heads": 4}, "Qwen3-30B-A3B (32 / 4)")):
        for k, v in _qwen_bf16_parity(family, overrides, model).items():
            total[k] = total.get(k, 0) + v
    return total


def phase_qwen3_moe(prompt_text: str, port: int) -> tuple:
    """Qwen3-MoE at full width: Qwen3-30B-A3B's step over all 48 layers from
    random params made on the card (~61 GB), then Qwen3-235B-A22B's first
    QW_SERVE_LAYERS layers and edge (~7.5 GB) written as a checkpoint and
    served over HTTP, single sequence and with --batch-slots 8."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import QWEN3_30B_A3B_CONFIG, QWEN3_235B_A22B_CONFIG, random_qwen_params

    tmp = os.path.join(tempfile.mkdtemp(prefix="dnet-torch-smoke-qwen-"), QW_MODEL)
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = ModelConfig.from_hf(QWEN3_30B_A3B_CONFIG)
        window, edge = random_qwen_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"), torch.bfloat16,
                                          seed=0)
        init_s = time.perf_counter() - t0
        step = dict(phase_moe_step("qwen3_moe_step", "Qwen3-30B-A3B (synthetic bf16 weights, seed 0)", cfg, window,
                                   edge, 300), init_s=init_s)
        # G = 8 at head dim 128 in bf16: every layer's decode through the tensor-core form
        layers = cfg.num_hidden_layers
        check(step["wrapper_launches_per_step"] == {"flash_decode": layers, "flash_decode_mma": layers},
              f"qwen3_moe step launches {step['wrapper_launches_per_step']}")
        del window, edge
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        served_cfg = dict(QWEN3_235B_A22B_CONFIG, num_hidden_layers=QW_SERVE_LAYERS)
        cfg = ModelConfig.from_hf(served_cfg)
        window, edge = random_qwen_params(cfg, range(QW_SERVE_LAYERS), torch.device("cuda"), torch.bfloat16, seed=0)
        save_checkpoint(tmp, served_cfg, hf_tensors(window, edge, "qwen3_moe"))
        del window, edge
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        serve = phase_qwen3_moe_serve(tmp, port, prompt_text, write_s)
        batched = phase_qwen3_moe_batch_serve(tmp, port)
    finally:
        shutil.rmtree(os.path.dirname(tmp), ignore_errors=True)
    return step, serve, batched


def phase_qwen3_moe_serve(model_dir: str, port: int, prompt_text: str, write_s: float) -> dict:
    """The 1-layer full-width Qwen3-235B-A22B checkpoint served single
    sequence: the serve phase's greedy, seeded sampled and streamed
    requests, 64 tokens each; the wide decode form QW_SERVE_LAYERS times a
    decode step, the prefill kernel (G = 16 at (128, 128)) QW_SERVE_LAYERS
    times a prompt, no other kernel; /health's KV bytes the cache's."""
    args = Namespace(
        host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
        max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
    )
    chat = {"model": QW_MODEL, "max_tokens": MAX_TOKENS, "temperature": 0,
            "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
    bodies = [{"greedy": chat, "streamed": dict(chat, stream=True),
               "sampled": dict(chat, temperature=0.8, top_p=0.95, seed=1234)}[k] for k in SERVE_KINDS]
    results, launches, load_s, health = asyncio.run(_drive(args, bodies))
    for name, r in zip(SERVE_KINDS, results):
        check(r["status"] == 200, f"qwen3_moe {name} request: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"qwen3_moe {name} request: short completion")
        check(name != "streamed" or r["content"] == results[0]["content"],
              "qwen3_moe streamed content differs from the non-streamed")
    decode_steps = sum(r["tokens"] - 1 for r in results)
    want = {"flash_decode_wide": QW_SERVE_LAYERS * decode_steps, "flash_decode_mma": QW_SERVE_LAYERS * decode_steps,
            "flash_prefill": QW_SERVE_LAYERS * len(results)}
    check({k: v for k, v in launches.items() if v} == want, f"qwen3_moe serve launches {launches} != {want}")
    engine = health["engine"]
    check(engine["kv_bytes"] == QW_SERVE_KV_BYTES, f"qwen3_moe KV bytes {engine} != {QW_SERVE_KV_BYTES}")
    row = {
        "phase": "qwen3_moe_serve", "mode": "single sequence", "gpu": gpu_line(),
        "model": f"Qwen3-235B-A22B widths, {QW_SERVE_LAYERS} of 94 layers (synthetic bf16 weights, seed 0)",
        "checkpoint_write_s": write_s, "load_s": load_s, "launches": launches, "prefills": len(results),
        "decode_steps": decode_steps, "kv_bytes": engine["kv_bytes"],
        "requests": [
            {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
             "tokens_per_s": r["tokens"] / r["s"], "content_head": r["content"][:40]}
            for k, r in zip(SERVE_KINDS, results)
        ],
        **streamed_rates(results),
    }
    emit(row)
    return row


def phase_qwen3_moe_batch_serve(model_dir: str, port: int) -> dict:
    """The same checkpoint with --batch-slots 8 over the paged pool (paged +
    ragged): the batch_serve burst; the wide paged form QW_SERVE_LAYERS
    times a batched decode step (the engine's decode_steps), the prefill
    kernel QW_SERVE_LAYERS times a prompt chunk, no other kernel; /health's
    KV bytes the pool's."""
    args = _batch_args(model_dir, port)
    bodies = [dict(b, model=QW_MODEL) for b in _batch_bodies()]
    with environ(PAGED_ENV):
        results, launches, load_s, health = asyncio.run(_drive(args, bodies, concurrent=True))
    for i, r in enumerate(results):
        check(r["status"] == 200, f"qwen3_moe batched request {i}: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"qwen3_moe batched request {i}: {r['tokens']} tokens")
    engine = health["engine"]
    steps = engine["decode_steps"]
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    want = {"paged_attend_wide": QW_SERVE_LAYERS * steps, "paged_attend_mma": QW_SERVE_LAYERS * steps,
            "flash_prefill": QW_SERVE_LAYERS * chunks}
    check(steps > 0 and {k: v for k, v in launches.items() if v} == want,
          f"qwen3_moe batched launches {launches} != {want}")
    pool_bytes = QW_SERVE_LAYERS * engine["kv_pool_blocks"] * BT * QW_KVH * 2 * QW_D * 2
    check(engine["kv_bytes"] == pool_bytes, f"qwen3_moe pool KV bytes {engine} != {pool_bytes}")
    check(engine["active"] == 0 and engine["kv_blocks_used"] == 0, f"slots or blocks leaked: {engine}")
    row = {
        "phase": "qwen3_moe_serve", "mode": "paged + ragged batched slots", "gpu": gpu_line(),
        "model": f"Qwen3-235B-A22B widths, {QW_SERVE_LAYERS} of 94 layers (synthetic bf16 weights, seed 0)",
        "batch_slots": BATCH_SLOTS, "block_tokens": BT, "pool_blocks": engine["kv_pool_blocks"],
        "load_s": load_s, "launches": launches, "decode_steps": steps, "prefill_chunks": chunks,
        "kv_bytes": engine["kv_bytes"], "kv_blocks_peak": engine["kv_blocks_peak"], **_burst_rates(results),
    }
    emit(row)
    return row


# continuous batching for every family and cache form (the ninth path): the
# decode kernel's lane forms at B = 8 (gpt-oss-20b's ring with per-lane
# lengths, some past W and one idle; DeepSeek-V2-Lite's MLA widths; int8 /
# int4 over a gathered Llama-3.2-1B view of the pool at BATCH_POSITIONS),
# the family serves' output length, and the dense gather's settings (the
# reference's default paged mode: DNET_KV_RAGGED unset)
LANE_ROT_LENGTHS = [0, 40, 128, 129, 300, 301, 700, 4096]
LANE_MLA_LENGTHS = [0] + [p + 1 for p in BATCH_POSITIONS[1:]]
LANE_MLA_LAYERS = 4
FAMILY_TOKENS = 16
GATHER_ENV = {"DNET_KV_PAGED": "1"}


def lane_bound(keys: list, h: int, kvh: int, dqk: int, dv: int, qbits: int, dtype, sinks: bool = False) -> tuple:
    """(ms, bound_by) for one decode call over lanes that attend `keys`
    slots each: q and the output once (in `dtype`), the lengths, the sinks,
    and each attended slot's K and V once as the cache stores them (values
    in `dtype`, or codes plus two 4-byte f32 scales a slot and KV head);
    2 * (dqk + dv) operations per (head, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    row = {0: (dqk + dv) * size, 8: dqk + dv + 8, 4: (dqk + dv) // 2 + 8}[qbits]
    nbytes = len(keys) * (h * (dqk + dv) * size + 4) + sum(keys) * kvh * row + (4 * h if sinks else 0)
    return bytes_ops_bound(nbytes, 2 * h * (dqk + dv) * sum(keys), dtype)


def _lane_caches(B: int, slots: int, kvh: int, dqk: int, dv: int, bits: int, dtype, layers: int, g,
                 rotating: bool = False) -> list:
    """`layers` layer slices of a [layers, B, slots, ...] cache: random
    values in `dtype`, or codes and scales the port's write_kv (a ring:
    write_kv_rotating, 3 x slots rows) made from random bf16 rows."""
    from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, write_kv, write_kv_rotating

    if not bits:
        kv = {"k": torch.randn(layers, B, slots, kvh, dqk, generator=g, device="cuda").to(dtype),
              "v": torch.randn(layers, B, slots, kvh, dv, generator=g, device="cuda").to(dtype)}
        return [layer_slices(kv, l) for l in range(layers)]
    kv = init_cache(KVConfig(layers, B, slots, kvh, dqk, v_head_dim=dv, quant_bits=bits), torch.device("cuda"))
    out = [layer_slices(kv, l) for l in range(layers)]
    n = 3 * slots if rotating else slots
    for c in out:
        k, v = (torch.randn(B, n, kvh, d, generator=g, device="cuda").to(torch.bfloat16) for d in (dqk, dv))
        (write_kv_rotating if rotating else write_kv)(c, k, v, 0)
    return out


def _lane_forms() -> list:
    """(row name, counter, shape, lengths, bits, dtype, extra) of every lane
    form lane_launches traces and lane_kernels times: the rotating ring at
    gpt-oss-20b's heads (sinks, window W), the MLA widths at
    DeepSeek-V2-Lite's (its softmax scale), Llama-3.2-1B's over a gathered
    view; f32, bf16 and (bf16 q) int8 / int4."""
    rot = (OSS_H, OSS_KVH, OSS_D, OSS_D, OSS_W)
    mla = (MLA_H, MLA_H, MLA_DQK, MLA_DV, S)
    gat = (H, KVH, D, D, S)
    forms = []
    for tag, dtype, bits in (("f32", torch.float32, 0), ("bf16", torch.bfloat16, 0), ("q8", torch.bfloat16, 8),
                             ("q4", torch.bfloat16, 4)):
        sfx = f"_q{bits}" if bits else ""
        forms.append((f"flash_decode_rotating{sfx}_lanes", f"flash_decode_rotating{sfx}", tag, rot,
                      LANE_ROT_LENGTHS, bits, dtype, {"rotating": True, "window": OSS_W}))
        forms.append((f"flash_decode_mla{sfx}_lanes", f"flash_decode_mla{sfx}", tag, mla, LANE_MLA_LENGTHS, bits,
                      dtype, {"scale": _mla_scale()}))
        forms.append((f"flash_decode{sfx}_gathered", f"flash_decode{sfx}", tag, gat,
                      [p + 1 for p in BATCH_POSITIONS], bits, dtype, {}))
    return forms


def phase_lane_launches() -> dict:
    """Device kernels per call of each lane form (B = 8, torch.profiler,
    right after the build as the other forms' counts): each must be
    exactly 1, its counter counting the call.  Returns row name -> 1."""
    from dnet_tpu_torch.kernels import launch_counts
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend

    g = torch.Generator(device="cuda").manual_seed(17)
    counts = {}
    for name, counter, tag, (h, kvh, dqk, dv, slots), lengths, bits, dtype, extra in _lane_forms():
        if tag == "f32":
            continue
        B = len(lengths)
        c = _lane_caches(B, slots, kvh, dqk, dv, bits, dtype, 1, g, rotating=bool(extra.get("rotating")))[0]
        q = torch.randn(B, 1, h, dqk, generator=g, device="cuda").to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        scales = {n: c[n] for n in ("k_scale", "v_scale") if n in c}
        sinks = {"sinks": torch.randn(h, generator=g, device="cuda")} if extra.get("rotating") else {}

        def call():
            return flash_decode_attend(q, c["k"], c["v"], lens, min(max(lengths), slots), **scales, **sinks, **extra)

        call()
        before = launch_counts()[counter]
        n = kernels_per_call(call)
        check(n == 1 and launch_counts()[counter] > before, f"{name} ({tag}): {n} device kernels in one call")
        counts[name] = 1
        del c
    emit({"phase": "lane_launches", "kernels_per_call": counts})
    torch.cuda.empty_cache()
    return counts


def event_time_ms(fn, reps: int = 10) -> float:
    """Median per-call time between CUDA events around `reps` calls, after a
    synchronise: for calls that upload their host index arrays, so the
    host's wait on each upload is in the time, as in serving."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _gathered_pool(bits: int, g):
    """A BlockStore of Llama-3.2-1B's layout (16 layers x POOL_BLOCKS blocks
    of BT tokens, bf16 or int8 / int4 codes with f32 scales) that the
    port's write_kv filled from random bf16 rows, and the shuffled page
    tables of the batch_serve mix."""
    from dnet_tpu_torch.core.kvcache import layer_slices, write_kv
    from dnet_tpu_torch.kv import BlockStore, PagedKVConfig
    from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG

    cfg = ModelConfig.from_hf(LLAMA_3_2_1B_CONFIG)
    model = get_ring_model_cls("llama")(cfg, range(LAYERS), "cuda")
    store = BlockStore(model, LAYERS, PagedKVConfig(BT, POOL_BLOCKS), "bfloat16", quant_bits=bits,
                       session_tokens=S)
    for l in range(LAYERS):  # a layer's pool is a cache of POOL_BLOCKS rows of BT slots
        k, v = (torch.randn(POOL_BLOCKS, BT, KVH, D, generator=g, device="cuda").to(torch.bfloat16) for _ in "kv")
        write_kv(layer_slices(store.kv, l), k, v, 0)
    return store, paged_tables(BATCH_POSITIONS).cpu().numpy()


def phase_lane_kernels(per_call: dict) -> dict:
    """Every lane form against its plain version on the card (TOL), timed
    beside SDPA and its bound: the rotating ring at B = 8 (gpt-oss-20b's
    heads, W = 128, sinks) with lengths LANE_ROT_LENGTHS (an idle lane, some
    past W); the MLA form at B = 8 over DeepSeek-V2-Lite's heads at its
    scale; plain, int8 and int4 over a Llama-3.2-1B view gathered from a
    pool of POOL_BLOCKS blocks through the batch_serve mix's shuffled page
    tables.  Library yardstick: SDPA over the attended slots with a per-lane
    mask (the ring with the sink as an extra zero key whose mask entry is
    its logit; quantized caches dequantized to a bf16 copy first, not
    timed); an idle lane's output (0) is held against the plain version
    only.  Then the dense gather's own cost: the pool gathered into a
    max_seq-wide view (an R-step chunk) and into the bucket of the widest
    table (a single step), and one step's scatter of each lane's block,
    bf16 and int8, timed with events around the calls (the index upload
    included).  Returns row name -> main row (bf16 q)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.core.kvcache import read_kv
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(19)
    main = {}
    pools = {}
    for name, counter, tag, (h, kvh, dqk, dv, slots), lengths, bits, dtype, extra in _lane_forms():
        B = len(lengths)
        rotating = bool(extra.get("rotating"))
        if name.endswith("_gathered"):
            if bits not in pools:
                pools[bits] = _gathered_pool(bits, g)
            store, ids = pools[bits]
            view = store.gather(ids)  # f32: an f32 q over the bf16 pool (DNET_KV_BITS=16, f32 model)
            layers = [{n: t[l] for n, t in view.items()} for l in range(LAYERS)]
        else:
            layers = _lane_caches(B, slots, kvh, dqk, dv, bits, dtype,
                                  OSS_LAYERS // 2 if rotating else LANE_MLA_LAYERS, g, rotating=rotating)
        L = len(layers)
        q = torch.randn(B, 1, h, dqk, generator=g, device="cuda").to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        live = min(max(lengths), slots)
        sinks = {"sinks": torch.randn(h, generator=g, device="cuda")} if rotating else {}
        scales = [{n: c[n] for n in ("k_scale", "v_scale") if n in c} for c in layers]

        def kern(l):
            c = layers[l]
            return flash_decode_attend(q, c["k"], c["v"], lens, live, **scales[l], **sinks, **extra)

        def plain(l):
            c = layers[l]
            return flash_decode_plain(q, c["k"], c["v"], lens, max_live=live, **scales[l], **sinks, **extra)

        out = kern(0)
        torch.cuda.synchronize()
        c0 = layers[0]
        want = flash_decode_plain(q.float(), c0["k"] if bits else c0["k"].float(),
                                  c0["v"] if bits else c0["v"].float(), lens, **scales[0], **sinks, **extra)
        err = (out.float() - want).abs().max().item()
        check(out.shape == (B, 1, h, dv) and out.dtype == dtype and bool(torch.isfinite(out).all()),
              f"{name} ({tag}) output")
        check(err <= TOL[dtype], f"{name} ({tag}): max err {err}")
        check(bool((out[lens == 0] == 0).all()), f"{name} ({tag}): an idle lane's output is not 0")
        # the yardstick: the attended slots of every lane under a mask
        keys = [min(n, slots) for n in lengths]
        width = max(keys)
        j = torch.arange(width, device="cuda")
        attend = j[None, :] < torch.tensor(keys, device="cuda")[:, None]  # [B, width]
        lib_kv = []
        for c in layers:
            kc, vc = read_kv({n: t[:, :width] for n, t in c.items()})
            if rotating:
                kc, vc = (torch.cat([t.to(dtype), torch.zeros_like(t[:, :1], dtype=dtype)], dim=1) for t in (kc, vc))
            lib_kv.append(tuple(t.to(dtype).transpose(1, 2).contiguous() for t in (kc, vc)))
        if rotating:
            mask = torch.full((B, h, 1, width + 1), float("-inf"), device="cuda", dtype=dtype)
            mask[..., :width].masked_fill_(attend[:, None, None, :], 0.0)
            mask[..., -1] = sinks["sinks"].to(dtype)[None, :, None]
        else:
            mask = attend[:, None, None, :]
        qt = q.transpose(1, 2)

        def lib(l):
            return sdpa(qt, lib_kv[l][0], lib_kv[l][1], attn_mask=mask, enable_gqa=True,
                        scale=extra.get("scale"))

        act = lens > 0
        lib_err = (lib(0).transpose(1, 2).float()[act] - want[act]).abs().max().item()
        check(lib_err <= TOL[torch.bfloat16], f"{name} ({tag}) library yardstick disagrees: {lib_err}")
        bound, by = lane_bound(keys, h, kvh, dqk, dv, bits, dtype, sinks=rotating)
        row = {
            "phase": "lane_kernels", "kernel": name, "counter": counter, "dtype": str(dtype).split(".")[-1],
            "cache": tag, "lanes": B, "lengths": lengths, "slots": slots, "H": h, "KVH": kvh, "Dqk": dqk, "Dv": dv,
            "max_err": err, "tol": TOL[dtype],
            "kernel_ms": device_time_ms(kern, L), "plain_ms": device_time_ms(plain, L, 3),
            "library_ms": device_time_ms(lib, L), "library_max_err": lib_err,
            "library_call": "scaled_dot_product_attention over the attended slots with a per-lane mask"
                            + (", the sink as an extra zero key" if rotating else "")
                            + (" (on a dequantized bf16 copy, not timed)" if bits else ""),
            "bound_ms": bound, "bound_by": by, "kernels_per_call": per_call.get(name),
        }
        row["times_library"] = row["kernel_ms"] / row["library_ms"]
        emit(row)
        if tag == "bf16" or bits:
            main[name] = row
        del layers, lib_kv
    # the dense gather's own cost per dispatch, bf16 and int8 pools
    for bits in (0, 8):
        store, ids = pools[bits]
        widest = max(-(-(p + 1) // BT) for p in BATCH_POSITIONS)
        bucket = 1 << (widest - 1).bit_length()
        triples = [(b, p // BT, int(ids[b, p // BT])) for b, p in enumerate(BATCH_POSITIONS)]
        view = store.gather(ids)
        per_token = sum(t[:, 0, 0].numel() * t.element_size() for t in store.kv.values())  # a token row, all layers
        for what, fn, blocks, rows in (
            ("kv_gather max_seq", lambda: store.gather(ids), ids, BATCH_SLOTS * S),
            ("kv_gather bucket", lambda: store.gather(ids[:, :bucket]), ids[:, :bucket], BATCH_SLOTS * bucket * BT),
            ("kv_scatter one block a lane", lambda: store.scatter(view, triples), [t[2] for t in triples],
             BATCH_SLOTS * BT),
        ):
            # each distinct block read once (a table's dead entries all read block 0), each row written once
            nbytes = (len(np.unique(blocks)) * BT + rows) * per_token
            emit({"phase": "lane_kernels", "kernel": what, "kv_bits": bits or 16, "rows": rows,
                  "ms": event_time_ms(fn), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                  "bytes": nbytes})
        del view
    del pools
    torch.cuda.empty_cache()
    return main


def _family_parity(what: str, cfg, window, edge, env: dict, prompts: dict, steps: int, expected, **kw) -> dict:
    """The batched engine (4 slots, max_seq 256) on the GPU and on the CPU
    from the same f32 weights, under `env`: every prompt prefilled, then
    `steps` batched steps (single steps, the second half as one budgeted
    chunk); equal greedy streams, logprobs within 2e-3, and the GPU's
    launches equal to expected(decode_steps) exactly.  Returns the emitted
    row."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    dec = DecodingParams(logprobs=True)
    got = {}
    for dev in ("cuda", "cpu"):
        with environ(env):
            eng = BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=256, param_dtype="float32",
                                            device=dev, **kw)
        reset_launch_counts()
        toks = {n: [int(eng.prefill_and_sample(n, ids, dec).token[0])] for n, ids in prompts.items()}
        lps = {n: [] for n in prompts}
        for step in range(steps):
            half = step >= steps // 2
            out, errs = eng.decode_batch({n: (t[-1], dec) for n, t in toks.items()},
                                         budgets={n: steps - step for n in prompts} if half else None)
            check(not errs, f"{what} batched errors: {errs}")
            for n, r in out.items():
                toks[n].append(int(r.token[0]))
                lps[n].append(float(r.logprob[0]))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts().items() if v}
            n_steps, stats = eng.decode_steps, eng.stats()
        for n in prompts:
            eng.end_session(n)
        if eng.kv_pool is not None:
            check(eng.kv_pool.used == 0, f"{what}: blocks leaked")
        eng.close()
        got[dev] = (toks, lps)
    check(got["cuda"][0] == got["cpu"][0], f"{what} greedy streams differ: {got}")
    lp_err = max(abs(a - b) for n in prompts for a, b in zip(got["cuda"][1][n], got["cpu"][1][n]))
    check(lp_err <= 2e-3, f"{what} logprobs differ by {lp_err}")
    want = expected(n_steps)
    check(n_steps == steps and launches == want, f"{what} launches {launches} != {want} ({n_steps} steps)")
    row = {"phase": "gather_parity", "case": what, "kv_mode": stats["kv_mode"], "kv_ragged": stats["kv_ragged"],
           "kv_quant_bits": stats["kv_quant_bits"], "slots": 4, "prompt_tokens": [len(p) for p in prompts.values()],
           "decode_steps": n_steps, "logprob_max_err": lp_err, "tol": 2e-3, "launches": launches}
    emit(row)
    return row


def phase_gather_parity() -> dict:
    """Small f32 models, GPU against CPU, on every new batched mode: llama
    under the dense gather (f32, q8, q4; 8-token blocks), gpt_oss on dense
    slots (f32, q8, q4: a ring of 32 that wraps per lane, in prefill for the
    69-token prompt and in decode for the others), deepseek_v2 on dense
    slots (f32) and under the dense gather (f32, q8, q4).  Returns each case's
    launches (the lane forms' launches on an engine path)."""
    cfg, window, edge = _small_model()
    prompts = {f"p{n}": [(7 * i + n) % 500 + 1 for i in range(n)] for n in (5, 17, 40, 69)}
    gather = dict(GATHER_ENV, DNET_KV_BLOCK_TOKENS="8")
    out = {}
    for bits in (0, 8, 4):
        dec = "flash_decode" + (f"_q{bits}" if bits else "")
        out[f"llama-gather-q{bits}"] = _family_parity(
            f"llama dense gather q{bits}", cfg, window, edge, gather, prompts, 16,
            lambda n, dec=dec: {dec: 2 * n, "flash_prefill": 2 * len(prompts)}, kv_quant_bits=bits)["launches"]
    cfg, window, edge = _oss_small()
    for bits in (0, 8, 4):
        sfx = f"_q{bits}" if bits else ""
        out[f"gpt_oss-dense-q{bits}"] = _family_parity(
            f"gpt_oss dense slots q{bits}", cfg, window, edge, {}, prompts, 40,
            lambda n, sfx=sfx: {f"flash_decode_rotating{sfx}": 2 * n, f"flash_decode{sfx}": 2 * n,
                                "flash_prefill": 2 * len(prompts)}, kv_quant_bits=bits)["launches"]
    cfg, window, edge = _ds_small()
    for mode, env, bits in (("dense", {}, 0), ("gather", gather, 0), ("gather", gather, 8), ("gather", gather, 4)):
        sfx = f"_q{bits}" if bits else ""
        out[f"deepseek_v2-{mode}-q{bits}"] = _family_parity(
            f"deepseek_v2 {mode} q{bits}", cfg, window, edge, env, prompts, 16,
            lambda n, sfx=sfx: {f"flash_decode_mla{sfx}": 3 * n, "flash_prefill_mla": 3 * len(prompts)},
            kv_quant_bits=bits)["launches"]
    return out


@contextlib.contextmanager
def store_timing():
    """CUDA events around every BlockStore gather and scatter the
    dense-gather decode makes in the block (a prompt's commit into the pool,
    which scatters too, apart), class-wide; yields the list of (op, start,
    end) events, read after a synchronise."""
    from dnet_tpu_torch.kv.store import BlockStore

    events = []
    saved = {op: getattr(BlockStore, op) for op in ("gather", "scatter", "commit_row")}
    inside_commit = []

    def timed(op, fn):
        def wrapper(self, *args):
            if op == "scatter" and inside_commit:
                return fn(self, *args)
            inside_commit.extend([op] if op == "commit_row" else [])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(self, *args)
            finally:
                end.record()
                events.append((op, start, end))
                if op == "commit_row":
                    inside_commit.pop()

        return wrapper

    for op, fn in saved.items():
        setattr(BlockStore, op, timed(op, fn))
    try:
        yield events
    finally:
        for op, fn in saved.items():
            setattr(BlockStore, op, fn)


def _burst_pass(what: str, args: Namespace, bodies: list, env: dict, n_tokens: int) -> tuple:
    """One concurrent burst under `env`: every request 200 with `n_tokens`
    tokens; returns (results, launches, /health's engine, load_s, the
    store's gather and scatter device ms in all)."""
    with environ(env), store_timing() as events:
        results, launches, load_s, health = asyncio.run(_drive(args, bodies, concurrent=True))
        torch.cuda.synchronize()
        copies = {op: 0.0 for op in ("gather", "scatter", "commit_row")}
        copies.update({f"{op}_calls": 0 for op in ("gather", "scatter", "commit_row")})
        for op, start, end in events:
            copies[op] += start.elapsed_time(end)
            copies[f"{op}_calls"] += 1
    for i, r in enumerate(results):
        check(r["status"] == 200, f"{what} request {i}: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == n_tokens, f"{what} request {i}: {r['tokens']} tokens")
    engine = health["engine"]
    check(engine["active"] == 0 and engine.get("kv_blocks_used", 0) == 0, f"{what}: slots or blocks leaked {engine}")
    return results, launches, engine, load_s, copies


def _burst_row(phase: str, what: str, results: list, launches: dict, engine: dict, load_s: float, copies: dict,
               prompt_tokens: list, **extra) -> dict:
    steps = engine["decode_steps"]
    row = {"phase": phase, "pass": what, "gpu": gpu_line(), "kv_mode": engine["kv_mode"],
           "kv_ragged": engine["kv_ragged"], "kv_quant_bits": engine["kv_quant_bits"], "batch_slots": BATCH_SLOTS,
           "load_s": load_s, "decode_steps": steps, "launches": {k: v for k, v in launches.items() if v},
           "kv_bytes": engine["kv_bytes"], **_burst_rates(results), **extra,
           "requests": [{"prompt_tokens": n, "completion_tokens": r["tokens"], "ttft_s": r["ttft_s"],
                         "gap_median_ms": r["gap_median_s"] * 1e3, "content_head": r["content"][:24]}
                        for n, r in zip(prompt_tokens, results)]}
    if copies["gather_calls"]:
        row.update(kv_gather_ms_per_step=copies["gather"] / steps, kv_scatter_ms_per_step=copies["scatter"] / steps,
                   kv_gather_calls=copies["gather_calls"], kv_scatter_calls=copies["scatter_calls"],
                   kv_gather_ms_per_call=copies["gather"] / copies["gather_calls"],
                   kv_scatter_ms_per_call=copies["scatter"] / copies["scatter_calls"],
                   kv_commit_calls=copies["commit_row_calls"], kv_commit_ms=copies["commit_row"])
    emit(row)
    return row


def _lane_streams(weights: tuple, env: dict, bits: int) -> tuple:
    """The batch_serve prompts on an in-process BatchedEngine over the
    checkpoint's `weights` (config, per-layer params, edge params; 8 slots,
    bf16) under `env`: every prompt prefilled in 256-token chunks, then
    MAX_TOKENS - 1 greedy decode steps over all 8 lanes with their budgets,
    a fixed schedule (the HTTP adapter's depends on arrival times, and a
    lane's split plan on the batch's longest lane).  Returns (tokens per
    lane, the engine's stats)."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = {f"l{i}": tok.encode(tok.apply_chat_template([{"role": "user", "content": c}]))
               for i, c in enumerate(_batch_prompts())}
    dec = DecodingParams(temperature=0.0)
    with environ(env):
        eng = BatchedEngine.from_params(*weights, slots=BATCH_SLOTS, max_seq=S, param_dtype="bfloat16",
                                        device="cuda", kv_quant_bits=bits)
    toks = {}
    for n, ids in prompts.items():
        eng.reserve_slot(n)
        for i in range(0, len(ids), PREFILL_CHUNK):
            logits = eng.prefill_chunk(n, ids[i : i + PREFILL_CHUNK])
        toks[n] = [int(eng.adopt_prefilled(n, logits, dec).token[0])]
    for step in range(1, MAX_TOKENS):
        out, errs = eng.decode_batch({n: (t[-1], dec) for n, t in toks.items()},
                                     budgets={n: MAX_TOKENS - step for n in toks})
        check(not errs, f"lane streams {env}: {errs}")
        for n, r in out.items():
            toks[n].append(int(r.token[0]))
    stats = eng.stats()
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return list(toks.values()), stats


def phase_gather_serve(model_dir: str, port: int, batched: dict) -> dict:
    """The batch_serve checkpoint and burst through the dense-gather paged
    decode: bf16 with DNET_KV_PAGED=1 alone (the reference's default paged
    mode), then DNET_KV_BITS=8 DNET_KV_PAGED=1 DNET_KV_RAGGED=1, which falls
    back from the ragged kernel to the gather.  Every request ends 200 with
    all its tokens, the decode kernel of the cache's form runs 16 times a
    decode step and the paged kernel never, the prefill kernel 16 times a
    prompt chunk, and no block is held after the burst.  Each form's lanes
    are then run on in-process engines, dense slots and the gather, on one
    fixed schedule: every lane's greedy tokens equal (the same kernel over
    the same values).  Prints the gather's and the scatter's device ms per
    decode step and the aggregate decode rates beside batch_serve's (paged
    + ragged, bf16)."""
    from dnet_tpu_torch.core.engine import LocalEngine

    args = _batch_args(model_dir, port)
    bodies = _batch_bodies()
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    loaded = LocalEngine(model_dir, max_seq=S, param_dtype="bfloat16", device="cuda", kv_paged=False)
    weights = (loaded.config, loaded.window_params, loaded.edge_params)  # read once for the lane streams
    del loaded
    out = {}
    for what, env, kernel, bits in (
        ("gather bf16", GATHER_ENV, "flash_decode", 0),
        ("gather q8 (ragged refused)", dict(GATHER_ENV, DNET_KV_RAGGED="1", DNET_KV_BITS="8"), "flash_decode_q8", 8),
    ):
        results, launches, engine, load_s, copies = _burst_pass(what, args, bodies, env, MAX_TOKENS)
        steps = engine["decode_steps"]
        check(engine["kv_mode"] == "paged" and engine["kv_ragged"] is False, f"{what}: {engine}")
        dense, dense_stats = _lane_streams(weights, {}, bits)
        gathered, gather_stats = _lane_streams(weights, {k: v for k, v in env.items() if k != "DNET_KV_BITS"}, bits)
        check(dense_stats["kv_mode"] == "dense" and gather_stats["kv_mode"] == "paged", f"{what}: lane streams' modes")
        for i, (a, b) in enumerate(zip(gathered, dense)):
            check(a == b, f"{what} lane {i}: tokens {a} differ from dense slots' {b}")
        check(steps > 0 and launches[kernel] == LAYERS * steps,
              f"{what}: {kernel} launches {launches[kernel]} != {LAYERS} x {steps} steps")
        others = {k: v for k, v in launches.items() if v and k not in (kernel, "flash_prefill")}
        check(not others, f"{what}: other kernels launched {others}")
        check(launches["flash_prefill"] == LAYERS * chunks, f"{what}: prefill launches {launches}")
        check(copies["gather_calls"] > 0 and copies["scatter_calls"] == copies["gather_calls"]
              and copies["commit_row_calls"] == len(bodies), f"{what}: {copies}")
        out[what] = _burst_row(
            "gather_serve", what, results, launches, engine, load_s, copies, BATCH_PROMPT_TOKENS,
            pool_blocks=engine["kv_pool_blocks"], kv_blocks_peak=engine["kv_blocks_peak"],
            lane_streams_equal_dense_slots=f"{len(dense)} lanes x {MAX_TOKENS} tokens",
            paged_ragged_bf16_batch_serve={k: batched[k] for k in ("aggregate_tokens_per_s",
                                                                   "aggregate_decode_tokens_per_s")})
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: v["launches"] for k, v in out.items()}, "rows": out}


def _family_bodies(model: str, n_tokens: int) -> list:
    """The batch_serve burst's 8 prompts (~27 to 1,500 tokens) for `model`,
    greedy, streamed, n_tokens each."""
    return [{"model": model, "max_tokens": n_tokens, "temperature": 0, "stream": True,
             "messages": [{"role": "user", "content": c}], "logit_bias": TEXT_BIAS} for c in _batch_prompts()]


def phase_gpt_oss_batch_serve(model_dir: str, port: int) -> dict:
    """The 4-layer gpt-oss-20b checkpoint with --batch-slots 8 on dense
    slots (the paired cache, a W = 128 ring a slot on the sliding half): 8
    concurrent streams of the batch_serve prompts (~27 to 1,500 tokens,
    every ring but the shortest's wrapped in prefill, each at its own
    position), FAMILY_TOKENS each.  The rotating kernel runs 4 times a
    decode step and the plain decode kernel 4 times, the prefill kernel 4
    times a prompt chunk (the full half), no other kernel.  Then the same
    with DNET_KV_PAGED=1: /health reports dense slots (the rings cannot be
    addressed by blocks, the reference's fallback); how many lanes' texts
    equal the first pass's is printed (the adapter's schedule, and so a
    lane's split plan, follows arrival times)."""
    args = _batch_args(model_dir, port)
    bodies = _family_bodies(OSS_MODEL, FAMILY_TOKENS)
    half = OSS_SERVE_LAYERS // 2
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    rows, first = {}, None
    for what, env in (("dense slots", {}), ("DNET_KV_PAGED=1 (falls back to dense slots)", GATHER_ENV)):
        results, launches, engine, load_s, copies = _burst_pass(f"gpt_oss {what}", args, bodies, env, FAMILY_TOKENS)
        steps = engine["decode_steps"]
        want = {"flash_decode_rotating": half * steps, "flash_decode": half * steps, "flash_prefill": half * chunks}
        got = {k: v for k, v in launches.items() if v}
        check(steps > 0 and got == want, f"gpt_oss {what}: launches {got} != {want}")
        check(engine["kv_mode"] == "dense", f"gpt_oss {what}: {engine}")
        first = first or results
        same = sum(r["content"] == d["content"] for r, d in zip(results, first))
        rows[what] = _burst_row("gpt_oss_batch_serve", what, results, launches, engine, load_s, copies,
                                BATCH_PROMPT_TOKENS, W=OSS_W, lanes_equal_first_pass=same)
    return {"launches": rows["dense slots"]["launches"], "rows": rows}


def phase_deepseek_batch_serve(model_dir: str, port: int) -> dict:
    """The 2-layer DeepSeek-V2-Lite checkpoint with --batch-slots 8: the 8
    batch_serve prompts, FAMILY_TOKENS each, on dense bf16 slots, then
    through the dense-gather paged decode (DNET_KV_PAGED=1) over an int8
    pool.  Exactly 2 MLA decode launches of the cache's form
    a decode step, 2 MLA prefill launches a prompt chunk, no other kernel,
    no block held after a burst.  Returns each pass's launches."""
    args = _batch_args(model_dir, port)
    bodies = _family_bodies(DS_MODEL, FAMILY_TOKENS)
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    out = {}
    for what, env, bits in (("dense bf16", {}, 0), ("gather q8", dict(GATHER_ENV, DNET_KV_BITS="8"), 8)):
        results, launches, engine, load_s, copies = _burst_pass(f"deepseek {what}", args, bodies, env,
                                                                FAMILY_TOKENS)
        steps = engine["decode_steps"]
        dec = "flash_decode_mla" + (f"_q{bits}" if bits else "")
        want = {dec: DS_SERVE_LAYERS * steps, "flash_prefill_mla": DS_SERVE_LAYERS * chunks}
        got = {k: v for k, v in launches.items() if v}
        check(steps > 0 and got == want, f"deepseek {what}: launches {got} != {want}")
        check(engine["kv_mode"] == ("paged" if bits else "dense") and engine["kv_quant_bits"] == bits,
              f"deepseek {what}: {engine}")
        out[what] = _burst_row("deepseek_batch_serve", what, results, launches, engine, load_s, copies,
                               BATCH_PROMPT_TOKENS)
    return {k: v["launches"] for k, v in out.items()}


# weight-only quantization (ops/quant.py): the bits' default groups
WQ_GROUP = {8: 128, 4: 64}
WQ_MODEL = "llama-3.2-1b-synthetic"
# Llama-3.3-70B-Instruct's step: all 80 layers at int8, a 64-token prompt,
# 16 greedy decode steps, 3 of them profiled
WQ_70B_PROMPT, WQ_70B_STEPS, WQ_70B_PROFILED = 64, 16, 3


def llama_weight_bytes(cfg: dict, bits: int) -> int:
    """Bytes of a llama model's weights as the engine holds them in bf16:
    every tensor at bits 0; else int8 / packed-int4 codes of each layer's
    seven matrices and of the LM projection (a tied table kept in the
    projection layout only), bf16 scales of the bits' default group, bf16
    norms, and an untied model's bf16 embedding."""
    D, F, V, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    HD, KD = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_key_value_heads"] * cfg["head_dim"]
    tied = cfg["tie_word_embeddings"]
    mats = [(D, HD), (D, KD), (D, KD), (HD, D), (D, F), (D, F), (F, D)]
    norms = (2 * L + 1) * D * 2
    if not bits:
        return 2 * (L * sum(i * o for i, o in mats) + V * D * (1 if tied else 2)) + norms

    def quantized(inn: int, out: int) -> int:
        g = WQ_GROUP[bits] if inn % WQ_GROUP[bits] == 0 else inn
        return inn * out * bits // 8 + inn // g * out * 2

    return L * sum(quantized(*m) for m in mats) + quantized(D, V) + norms + (0 if tied else V * D * 2)


def _quant_leaves(engine) -> list:
    """(path, tensor) of every code and scale tensor in an engine's params,
    in a fixed order."""
    from dnet_tpu_torch.ops.quant import is_quantized

    out = []

    def walk(node, path):
        if is_quantized(node):
            out.extend((f"{path}.{k}", node[k]) for k in sorted(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(engine.window_params, "window")
    walk(engine.edge_params, "edge")
    return out


def phase_wq_parity() -> dict:
    """Weight-only int8 and int4 on small f32 models, the card against the
    CPU: llama (head dim 64, a tied table quantized in the projection
    layout), gpt_oss (64, its paired experts), deepseek_v2 (MLA (192, 128))
    and qwen3_moe (128, G = 16, a dense and two MoE layers), each engine
    quantizing the same f32 params on its own device.  Every code and scale
    equal bit for bit, prefill logits within 2e-3, 16 greedy tokens equal.
    Returns {(family, bits): row}."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    makers = {"llama": _small_model, "gpt_oss": _oss_small, "deepseek_v2": _ds_small,
              "qwen3_moe": lambda: _qwen_small("qwen3_moe")}
    prompt = list(range(1, 70))
    out = {}
    for family, make in makers.items():
        cfg, window, edge = make()
        for bits in (8, 4):
            engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev,
                                                    weight_quant_bits=bits) for dev in ("cuda", "cpu")}
            leaves = {dev: _quant_leaves(e) for dev, e in engines.items()}
            check(len(leaves["cuda"]) == len(leaves["cpu"]) > 0
                  and [n for n, _ in leaves["cuda"]] == [n for n, _ in leaves["cpu"]], f"{family} q{bits} leaves")
            check(all(t.device.type == "cuda" for _, t in leaves["cuda"]), f"{family} q{bits}: codes off the card")
            unequal = [n for (n, a), (_, b) in zip(leaves["cuda"], leaves["cpu"]) if not torch.equal(a.cpu(), b)]
            check(not unequal, f"{family} q{bits}: the card's codes / scales differ from the CPU's at {unequal[:4]}")
            logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
            err = (logits["cuda"] - logits["cpu"]).abs().max().item()
            check(bool(torch.isfinite(logits["cuda"]).all()) and err <= 2e-3, f"{family} q{bits} logits err {err}")
            streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
                       for dev, e in engines.items()}
            check(streams["cuda"] == streams["cpu"], f"{family} q{bits} greedy streams differ: {streams}")
            row = {"phase": "wq_parity", "family": family, "weight_quant_bits": bits,
                   "head_dim": cfg.extra.get("qk_nope_head_dim", 0) + cfg.extra.get("qk_rope_head_dim", 0)
                   or cfg.head_dim, "quantized_tensors": len(leaves["cuda"]), "bit_equal": True,
                   "logits_max_err": err, "tol": 2e-3, "greedy_tokens": len(streams["cuda"]),
                   "weight_bytes": engines["cuda"].weight_stats()["weight_bytes"]}
            emit(row)
            out[(family, bits)] = row
            for e in engines.values():
                e.close()
    return out


def phase_wq_serve(model_dir: str, port: int, bodies: list, served: dict, bf16_weight_bytes: int,
                   batched: dict) -> dict:
    """The serve phase's checkpoint at `<id>:int8` and `<id>:int4` (the
    catalog's weight-only variants) through the HTTP entry point, with the
    serve phase's greedy, streamed and sampled requests: 64 tokens each,
    16 decode launches a step and 16 prefill launches a prompt (no other
    kernel), /health's weight bytes equal to the reckoning.  Then the int8
    variant with --batch-slots 8 over a paged pool decoded by the ragged
    kernel (the batch_serve burst), and one greedy request through a
    two-shard ring whose shards both load at weight_quant_bits 8: its text
    equal to the int8 single process's.  Rates beside the bf16 passes of
    this run."""
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG

    check(bf16_weight_bytes == llama_weight_bytes(LLAMA_3_2_1B_CONFIG, 0),
          f"bf16 weight bytes {bf16_weight_bytes} != {llama_weight_bytes(LLAMA_3_2_1B_CONFIG, 0)}")
    out = {}
    for bits in (8, 4):
        variant = f":int{bits}"
        args = Namespace(host="127.0.0.1", http_port=port, model=model_dir + variant, models_dir="", device="cuda",
                         max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0)
        reqs = [dict(b, model=WQ_MODEL + variant) for b in bodies]
        results, launches, load_s, health = asyncio.run(_drive(args, reqs))
        for name, r in zip(SERVE_KINDS, results):
            check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"wq{bits} {name}: {r['status']} {r['tokens']}")
            check(name != "streamed" or r["content"] == results[0]["content"], f"wq{bits}: streamed text differs")
        decode_steps = sum(r["tokens"] - 1 for r in results)
        want = {"flash_prefill": LAYERS * len(results), "flash_decode": LAYERS * decode_steps}
        check({k: v for k, v in launches.items() if v} == want, f"wq{bits} launches {launches} != {want}")
        engine = health["engine"]
        weight_bytes = llama_weight_bytes(LLAMA_3_2_1B_CONFIG, bits)
        check(engine["weight_quant_bits"] == bits and engine["weight_bytes"] == weight_bytes,
              f"wq{bits} /health {engine} != {weight_bytes} weight bytes")
        row = {
            "phase": "wq_serve", "mode": "single sequence", "model": f"{WQ_MODEL}{variant}", "gpu": gpu_line(),
            "weight_quant_bits": bits, "group": WQ_GROUP[bits], "load_s": load_s, "launches": launches,
            "decode_steps": decode_steps, "weight_bytes": weight_bytes, "bf16_weight_bytes": bf16_weight_bytes,
            "decode_weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
            "bf16_decode_weight_bound_ms": bf16_weight_bytes / HBM_BYTES_PER_S * 1e3,
            "requests": [{"kind": k, "completion_tokens": r["tokens"], "s": r["s"], "content_head": r["content"][:40]}
                         for k, r in zip(SERVE_KINDS, results)],
            **streamed_rates(results),
            "bf16_serve": {k: served[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
        }
        emit(row)
        out[bits] = dict(row, results=results)
    # the int8 variant under continuous batching: paged + ragged, 8 slots
    with environ(PAGED_ENV):
        results, launches, load_s, health = asyncio.run(
            _drive(_batch_args(model_dir + ":int8", port), [dict(b, model=WQ_MODEL + ":int8") for b in _batch_bodies()],
                   concurrent=True))
    for i, r in enumerate(results):
        check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"wq8 batched request {i}: {r['status']} {r['tokens']}")
    engine = health["engine"]
    steps = engine["decode_steps"]
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    want = {"paged_attend": LAYERS * steps, "flash_prefill": LAYERS * chunks}
    check(steps > 0 and {k: v for k, v in launches.items() if v} == want, f"wq8 batched launches {launches} != {want}")
    check(engine["weight_quant_bits"] == 8 and engine["weight_bytes"] == out[8]["weight_bytes"]
          and engine["active"] == 0 and engine["kv_blocks_used"] == 0, f"wq8 batched /health {engine}")
    burst = {"phase": "wq_serve", "mode": "batched, paged + ragged", "model": f"{WQ_MODEL}:int8", "gpu": gpu_line(),
             "batch_slots": BATCH_SLOTS, "load_s": load_s, "launches": launches, "decode_steps": steps,
             "prefill_chunks": chunks, **_burst_rates(results),
             "bf16_batch_serve": {k: batched[k] for k in ("aggregate_tokens_per_s", "aggregate_decode_tokens_per_s")}}
    emit(burst)
    out["batched"] = burst
    # the ring: the variant's id makes both shards load at weight_quant_bits 8
    greedy = dict(bodies[0], model=WQ_MODEL + ":int8")
    results, healths, load_s, _ = _ring_pass(model_dir + ":int8", "lossless", [greedy], os.path.dirname(model_dir),
                                             tag="wq8")
    r = results[0]
    check(r["status"] == 200 and r["tokens"] == MAX_TOKENS, f"wq8 ring: {r['status']} {r['tokens']}")
    check(r["content"] == out[8]["results"][0]["content"], "wq8 ring text differs from the int8 single process's")
    n_layers = len(RING_LAYERS[0])
    for h in healths:
        k, e = h["kernels"], h["engine"]
        check(k["flash_prefill"] == n_layers and k["flash_decode"] == n_layers * (MAX_TOKENS - 1),
              f"wq8 ring launches {k}")
        check(e["weight_quant_bits"] == 8, f"wq8 ring shard engine {e}")
    ring = {"phase": "wq_serve", "mode": "two-shard ring", "model": f"{WQ_MODEL}:int8", "gpu": gpu_line(),
            "layers": [f"{ls[0]}-{ls[-1]}" for ls in RING_LAYERS], "load_s": load_s, "text_equal_single_process": True,
            "shard_weight_bytes": [h["engine"]["weight_bytes"] for h in healths],
            "launches": {f"s{i}": h["kernels"] for i, h in enumerate(healths)}, "s": r["s"]}
    emit(ring)
    out["ring"] = ring
    return out


def phase_wq_step_70b() -> dict:
    """Llama-3.3-70B-Instruct's widths, all 80 layers, int8 weights on the
    one card: each layer drawn in bf16 on the card (seed 0) and quantized as
    it is made, its bf16 copy freed before the next (the LM head likewise;
    the untied embedding stays bf16).  Checks the weight bytes against the
    reckoning and the logits' finiteness; reports the peak memory, a 64-token
    prefill, 16 greedy decode steps (wall time each), and 3 profiled steps:
    device busy, launches, the matmuls', the attention kernels' and the
    elementwise kernels' (the plain dq's multiply) time, the dq's own time
    (one layer's seven weights and the LM head, CUDA events, scaled to the
    step), and the bound: every weight byte (codes, scales, norms, the LM
    head) read once at 3.35 TB/s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.ops.quant import dq
    from dnet_tpu_torch.utils.random_init import LLAMA_3_3_70B_CONFIG, random_llama_edge, random_llama_layers

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    raw = LLAMA_3_3_70B_CONFIG
    cfg = ModelConfig.from_hf(raw)
    L = cfg.num_hidden_layers
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    eng = LocalEngine.from_params(cfg, random_llama_layers(cfg, range(L), dev, torch.bfloat16, seed=0),
                                  random_llama_edge(cfg, dev, torch.bfloat16, seed=1), max_seq=S, device="cuda",
                                  weight_quant_bits=8)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    made_peak = torch.cuda.max_memory_allocated()
    weight_bytes = eng.weight_stats()["weight_bytes"]
    check(weight_bytes == llama_weight_bytes(raw, 8), f"70B int8 weight bytes {weight_bytes}")
    embed_bytes = cfg.vocab_size * cfg.hidden_size * 2
    d = DecodingParams()
    prompt = [(7 * t) % 250 + 1 for t in range(WQ_70B_PROMPT)]
    logits = eng.prefill("c", prompt)
    check(logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()), "70B prefill logits")
    eng.end_session("c")
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tok = int(eng.prefill_and_sample("s", prompt, d).token[0])
    prefill_ms = (time.perf_counter() - t) * 1e3
    prefill_launches = {k: v for k, v in launch_counts().items() if v}
    check(prefill_launches == {"flash_prefill": L}, f"70B prefill launches {prefill_launches}")
    reset_launch_counts()
    walls, tokens = [], [tok]
    for _ in range(WQ_70B_STEPS):
        t = time.perf_counter()
        tok = int(eng.decode_step("s", tok, d).token[0])
        walls.append((time.perf_counter() - t) * 1e3)
        tokens.append(tok)
    per_step = {k: v / WQ_70B_STEPS for k, v in launch_counts().items() if v}
    # G = 8 at head dim 128 in bf16: every layer's decode through the tensor-core form
    check(per_step == {"flash_decode": L, "flash_decode_mma": L} and all(0 <= x < cfg.vocab_size for x in tokens),
          f"70B decode launches per step {per_step}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WQ_70B_PROFILED):
            tok = int(eng.decode_step("s", tok, d).token[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1e3 / WQ_70B_PROFILED
    device_ms = sum(by_name.values())
    check(device_ms > 0, "the profiler saw no device time")

    def share(*words) -> float:
        return sum(t for n, t in by_name.items() if any(w in n.lower() for w in words))

    p, head = eng.window_params[0], eng.edge_params["lm_head"]["weight"]
    keys = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layer_dq_ms = event_time_ms(lambda: [dq(p[k]) for k in keys], reps=5)
    head_dq_ms = event_time_ms(lambda: dq(head), reps=5)
    pos = eng.sessions["s"].pos
    # bytes one step must read: every weight but the embedding (one row of
    # it) and the KV rows written so far
    kv_read = 2 * L * pos * cfg.num_key_value_heads * cfg.head_dim * 2
    step_bytes = weight_bytes - embed_bytes + cfg.hidden_size * 2 + kv_read
    row = {"phase": "wq_step_70b", "gpu": gpu_line(), "model": "Llama-3.3-70B-Instruct widths (synthetic, seed 0)",
           "layers": L, "weight_quant_bits": 8, "group": WQ_GROUP[8], "make_and_quantize_s": made_s,
           "weight_bytes": weight_bytes, "bf16_weight_bytes": llama_weight_bytes(raw, 0),
           "kv_bytes": eng.kv_bytes, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_memory_while_made_bytes": made_peak, "card_memory_bytes": torch.cuda.mem_get_info()[1],
           "prefill_tokens": WQ_70B_PROMPT, "prefill_ms": prefill_ms, "prefill_launches": prefill_launches,
           "decode_steps": WQ_70B_STEPS, "decode_wall_ms": walls, "decode_wall_ms_median": statistics.median(walls),
           "pos": pos, "wrapper_launches_per_step": per_step,
           "profiled_steps": WQ_70B_PROFILED, "device_busy_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / statistics.median(walls),
           "kernel_launches": len(kernels) // WQ_70B_PROFILED,
           "matmul_kernels_ms": share("gemm", "gemv", "nvjet", "cutlass"),
           "attention_kernels_ms": share("flash_"), "elementwise_kernels_ms": share("elementwise"),
           "dq_ms_per_step": L * layer_dq_ms + head_dq_ms, "dq_ms_one_layer": layer_dq_ms, "dq_ms_lm_head": head_dq_ms,
           "top_kernels_ms": {n[:80]: v for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]},
           "step_bytes": step_bytes, "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "busy_over_bound": device_ms / (step_bytes / HBM_BYTES_PER_S * 1e3), "tokens": tokens}
    emit(row)
    eng.close()
    del eng, p, head
    gc.collect()
    torch.cuda.empty_cache()
    return row


# weight streaming (core/weights.py): the parity plans (family, window,
# residency), the serve's tail shard plan, and Llama-3.3-70B-Instruct's
# widths in bf16 streamed at a fixed depth: 60% of the card machine's
# MemAvailable (108.4 GB at its start) over one layer's 1.711 GB
# is 38 layers of page-locked host memory (65.0 GB), with the card capped
# below them
STREAM_PLANS = [("llama", 2, 4), ("llama", 2, 1), ("llama", 1, 1), ("deepseek_v2", 2, 2), ("gpt_oss", 2, 2)]
STREAM_SERVE_WINDOWS = ({}, {"window_size": 2, "residency_size": 4})
STREAM_70B_LAYERS, STREAM_70B_WINDOW, STREAM_70B_RESIDENCY = 38, 8, 16
STREAM_70B_CAP_BYTES = 40 * 10**9  # the card's allowance: below the 38 layers' 65.0 GB
STREAM_70B_PROMPT, STREAM_70B_STEPS = 64, 4
PCIE_GEN5_X16_BYTES_PER_S = 64e9  # the link's nominal rate, one direction


def phase_stream_parity() -> dict:
    """Weight-streaming engines on the GPU against the same engines on the
    CPU, same f32 weights (small models at the kernels' head widths): llama
    (4 layers) at the plans (2, 4) offload, (2, 1) sliding_fit and (1, 1),
    deepseek_v2 (3 layers, MLA widths) and gpt_oss (4 layers, its sliding
    layers' W-row rings) at (2, 2).  Prefill logits within 2e-3, equal
    16-token greedy streams, and on the card each layer's attention kernel
    launched once per step (gpt_oss: the rotating form on its sliding
    layers, whose prompts attend the ring through the dense path, as in
    its fit engine) and each layer copied to the card once per step.
    Returns the launches of the whole phase."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    models = {"llama": lambda: _small_model(4), "deepseek_v2": _ds_small, "gpt_oss": _oss_small}
    prompt = [(17 * i) % 500 + 1 for i in range(40)]
    n_tokens = 16
    total = {}
    for family, w, r in STREAM_PLANS:
        cfg, window, edge = models[family]()
        L = cfg.num_hidden_layers
        engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev,
                                                window_size=w, residency_size=r) for dev in ("cuda", "cpu")}
        check(engines["cuda"].weight_cache is not None, f"{family} ({w}, {r}) did not stream")
        reset_launch_counts()
        logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, cfg.vocab_size),
              f"stream {family} logits")
        check(err <= 2e-3, f"stream {family} ({w}, {r}) GPU vs CPU prefill logits: max err {err}")
        for e in engines.values():
            e.end_session("p")
        torch.cuda.synchronize()
        prefill_launches = {k: v for k, v in launch_counts().items() if v}
        wc = engines["cuda"].weight_cache
        before = wc.snapshot()
        reset_launch_counts()
        streams = {dev: [r_.token_id for r_ in e.generate(prompt, DecodingParams(), max_tokens=n_tokens, nonce="g")]
                   for dev, e in engines.items()}
        torch.cuda.synchronize()
        check(streams["cuda"] == streams["cpu"], f"stream {family} ({w}, {r}) greedy streams differ: {streams}")
        launches = {k: v for k, v in launch_counts().items() if v}
        after = wc.snapshot()
        steps = n_tokens - 1
        want_prefill, want = {
            "llama": ({"flash_prefill": L}, {"flash_prefill": L, "flash_decode": L * steps}),
            "deepseek_v2": ({"flash_prefill_mla": L}, {"flash_prefill_mla": L, "flash_decode_mla": L * steps}),
            "gpt_oss": ({"flash_prefill": L // 2},
                        {"flash_prefill": L // 2, "flash_decode": L // 2 * steps,
                         "flash_decode_rotating": L // 2 * steps}),
        }[family]
        check(prefill_launches == want_prefill, f"stream {family} prefill launches {prefill_launches}")
        check(launches == want, f"stream {family} ({w}, {r}) launches {launches} != {want}")
        # every layer copied once per forward (the prompt's and each step's)
        check(after["loads"] - before["loads"] == L * n_tokens, f"stream {family} loads {before} {after}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "stream_parity", "family": family, "layers": L, "window_size": w, "residency_size": r,
              "plan": engines["cuda"].plan.name, "prompt_tokens": len(prompt), "logits_max_err": err, "tol": 2e-3,
              "greedy_tokens": len(streams["cuda"]), "prefill_launches": prefill_launches,
              "generate_launches": launches, "weight_cache": after})
        for e in engines.values():
            e.close()
    return total


def phase_stream_serve(model_dir: str, bodies: list, serve_results: list, served: dict, resident_ring: dict) -> dict:
    """The ring_serve checkpoint (full-width Llama-3.2-1B, bf16) as the same
    two shard processes, shard 1 (layers 8-15) streaming its weights with
    window_size 2 and residency_size 4 (offload: a decode step copies all 8
    layers to the card, 973 MB), shard 0 resident: greedy and greedy
    streamed requests, whose text must equal the single process's (which
    ring_serve holds the resident ring to).  Reports the decode rate beside
    the single process's and the resident ring's (`resident_ring`:
    ring_serve's lossless row), each shard's host ms per frame, the tail's
    weight cache counters (loads, hits, evictions) from /health, the bytes
    copied to the card a step and the rate they crossed at, against the
    step's bound at the link's nominal rate.  Returns s1's launches."""
    results, (h0, h1), load_s, warm = _ring_pass(model_dir, "lossless", bodies[:2], os.path.dirname(model_dir),
                                                 tag="stream", windows=STREAM_SERVE_WINDOWS)
    for i, r in enumerate(results):
        check(r["status"] == 200 and r["tokens"] == MAX_TOKENS,
              f"stream_serve request {i}: {r['status']} {r['tokens']}")
        check(r["content"] == serve_results[0]["content"], f"stream_serve request {i}: text differs from the serve's")
    e0, e1 = h0["engine"], h1["engine"]
    check(e0["weight_policy"] == "fit" and "weight_cache" not in e0, f"s0 engine {e0}")
    check(e1["weight_policy"] == "offload", f"s1 engine {e1}")
    wc, wc_warm = e1["weight_cache"], warm[1]["engine"]["weight_cache"]
    layers = len(RING_LAYERS[1])
    steps = sum(r["tokens"] for r in results) - len(results)  # decode steps (each prompt samples one token)
    k1 = h1["kernels"]
    check(k1["flash_prefill"] == layers * len(results) and k1["flash_decode"] == layers * steps,
          f"stream_serve s1 launches {k1}")
    # the second (streamed) request alone: its forwards' loads (counted as
    # they are issued; the copies run on the shard's loader threads)
    passes = results[1]["tokens"]  # its prompt's forward and its decode steps'
    layer_bytes = wc["slab_bytes"] // wc["slabs"]
    loads = wc["loads"] - wc_warm["loads"]
    check(loads == layers * passes, f"stream_serve loads {loads} over {passes} forwards of {layers} layers")
    step_bytes = loads * layer_bytes / passes
    streamed = results[1]
    decode_s_per_token = streamed["decode_s"] / max(streamed["tokens"] - 1, 1)
    row = {"phase": "stream_serve", "gpu": gpu_line(), "model": "Llama-3.2-1B widths (synthetic, seed 0, bf16)",
           "layers": [f"{ls[0]}-{ls[-1]}" for ls in RING_LAYERS], "windows": list(STREAM_SERVE_WINDOWS),
           "load_s": load_s, "weight_cache": wc, "host_pinned_bytes": wc["host_bytes"],
           "h2d_bytes_per_step": step_bytes, "layer_bytes": layer_bytes,
           "streamed_ttft_s": streamed["ttft_s"], "streamed_decode_tokens_per_s": 1.0 / decode_s_per_token,
           "decode_ms_per_token": decode_s_per_token * 1e3,
           "h2d_gb_per_s_achieved": step_bytes / decode_s_per_token / 1e9,
           "step_bound_ms_at_64_gb_per_s": step_bytes / PCIE_GEN5_X16_BYTES_PER_S * 1e3,
           "single_process": {k: served[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
           "resident_ring": {k: resident_ring[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
           # host ms per frame on each shard (s1's includes its wait for the copies)
           "steady": {f"s{i}": _steady(h, w, results[1:]) for i, (h, w) in enumerate(zip((h0, h1), warm))},
           "launches": {"s0": {k: v for k, v in h0["kernels"].items() if v}, "s1": {k: v for k, v in k1.items() if v}},
           "content_head": streamed["content"][:40]}
    emit(row)
    return k1


def pinned_copy_gb_per_s(nbytes: int = 1 << 30, reps: int = 5, trials: int = 3) -> list:
    """Host-to-device rates of one page-locked buffer (CUDA events), one
    a trial of `reps` copies; the link's rate is the best of them."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    rates = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        rates.append(nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9)
    del src, dst
    return rates


def _read_ints(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return None
    return None if text == "max" else int(text)


def host_memory() -> dict:
    """This machine's host memory as the kernel reports it: /proc/meminfo's
    totals (bytes), the memory cgroup's limit and use (v2, else v1; None
    where the file is absent or unlimited), this process's resident bytes
    and its live children's."""
    want = ("MemTotal", "MemFree", "MemAvailable", "Cached", "Shmem", "Mlocked", "AnonPages")
    with open("/proc/meminfo") as f:
        info = {k: int(v.split()[0]) * 1024 for k, v in (line.split(":", 1) for line in f) if k in want}

    def rss(pid) -> int:
        try:
            with open(f"/proc/{pid}/status") as f:
                return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))
        except (OSError, StopIteration):
            return 0

    children = []
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                children += f.read().split()
        except OSError:
            pass
    cg2, cg1 = "/sys/fs/cgroup/", "/sys/fs/cgroup/memory/"
    limit = _read_ints(cg2 + "memory.max") if os.path.exists(cg2 + "memory.max") else \
        _read_ints(cg1 + "memory.limit_in_bytes")
    used = _read_ints(cg2 + "memory.current") if os.path.exists(cg2 + "memory.current") else \
        _read_ints(cg1 + "memory.usage_in_bytes")
    return {**{f"{k}_bytes": v for k, v in info.items()}, "cgroup_limit_bytes": limit, "cgroup_used_bytes": used,
            "self_rss_bytes": rss("self"), "children": len(children),
            "children_rss_bytes": sum(rss(c) for c in children)}


def free_host_caches() -> None:
    """Hand back what freed tensors still hold: the caching allocators'
    blocks (page-locked host ones included) and glibc's free heap."""
    gc.collect()
    torch.cuda.empty_cache()
    # the page-locked host allocator's cache (its name differs by release)
    empty_host = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache")
    empty_host()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def phase_stream_step_70b() -> dict:
    """Llama-3.3-70B-Instruct's widths in bf16, streamed: 38 layers (65.0
    GB, more than the card may use here: it is capped at 40 GB with
    set_per_process_memory_fraction) made from a seed on the card one at a
    time and packed into page-locked host memory, the embedding and the LM
    head (4.2 GB) resident, window 8 and residency 16 (27.4 GB of slabs).
    A 64-token prompt and 4 greedy decode steps; reports the host bytes,
    the device peak, the prefill and step walls, the bytes copied a step,
    the rate achieved against a 1 GiB page-locked copy probed in this run
    (the best of 3 trials), and the step's bound (its bytes over the
    probe's rate, and over the link's nominal 64 GB/s); checks one prefill launch a layer a prompt and
    one decode launch a layer a step."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import LLAMA_3_3_70B_CONFIG, random_llama_edge, random_llama_layers

    free_host_caches()
    # the host memory the depth was fixed from, before any layer is locked
    mem_start = host_memory()
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.set_per_process_memory_fraction(STREAM_70B_CAP_BYTES / total)
    torch.cuda.reset_peak_memory_stats()
    eng = None
    try:
        probes = pinned_copy_gb_per_s()
        probe = max(probes)
        free_host_caches()  # the probe's page-locked buffer
        raw = dict(LLAMA_3_3_70B_CONFIG, num_hidden_layers=STREAM_70B_LAYERS)
        cfg = ModelConfig.from_hf(raw)
        L = cfg.num_hidden_layers
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        eng = LocalEngine.from_params(cfg, random_llama_layers(cfg, range(L), dev, torch.bfloat16, seed=0),
                                      random_llama_edge(cfg, dev, torch.bfloat16, seed=1), max_seq=256, device="cuda",
                                      window_size=STREAM_70B_WINDOW, residency_size=STREAM_70B_RESIDENCY)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        mem_locked = host_memory()
        wc = eng.weight_cache
        host_bytes = wc.store.host_bytes()
        layer_bytes = wc.store.host_layer(0).nbytes
        check(host_bytes == L * layer_bytes and host_bytes > STREAM_70B_CAP_BYTES,
              f"70B streamed host bytes {host_bytes} (cap {STREAM_70B_CAP_BYTES})")
        check(all(wc.store.host_layer(a).buf.is_pinned() for a in (0, L - 1)), "70B host layers not page-locked")
        d = DecodingParams()
        prompt = [(7 * t) % 250 + 1 for t in range(STREAM_70B_PROMPT)]
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = eng.prefill_and_sample("s", prompt, d)
        tok = int(res.token[0])
        prefill_ms = (time.perf_counter() - t) * 1e3
        prefill_launches = {k: v for k, v in launch_counts().items() if v}
        check(prefill_launches == {"flash_prefill": L}, f"70B streamed prefill launches {prefill_launches}")
        reset_launch_counts()
        before = wc.snapshot()
        walls, tokens = [], [tok]
        for _ in range(STREAM_70B_STEPS):
            t = time.perf_counter()
            tok = int(eng.decode_step("s", tok, d).token[0])
            walls.append((time.perf_counter() - t) * 1e3)
            tokens.append(tok)
        after = wc.snapshot()
        per_step = {k: v / STREAM_70B_STEPS for k, v in launch_counts().items() if v}
        check(per_step == {"flash_decode": L, "flash_decode_mma": L} and all(0 <= x < cfg.vocab_size for x in tokens),
              f"70B streamed decode launches per step {per_step}")
        loads = after["loads"] - before["loads"]
        check(loads == L * STREAM_70B_STEPS, f"70B streamed loads {loads} over {STREAM_70B_STEPS} steps")
        step_bytes = loads * layer_bytes / STREAM_70B_STEPS
        peak = torch.cuda.max_memory_allocated()
        check(peak < STREAM_70B_CAP_BYTES, f"70B streamed device peak {peak} over the cap {STREAM_70B_CAP_BYTES}")
        step_ms = statistics.median(walls)
        bound_ms = step_bytes / (probe * 1e9) * 1e3
        row = {"phase": "stream_step_70b", "gpu": gpu_line(), "host_mem_available_bytes": mem_start["MemAvailable_bytes"],
               # at the phase's start (after freeing the host caches) and
               # once every layer is locked
               "host_memory_at_start": mem_start, "host_memory_locked": mem_locked,
               # cudaHostRegister locks pages whatever this limit says
               "memlock_limit_bytes": resource.getrlimit(resource.RLIMIT_MEMLOCK)[0],
               "model": "Llama-3.3-70B-Instruct widths (synthetic, seed 0, bf16)", "layers": L,
               "layers_of_the_model": LLAMA_3_3_70B_CONFIG["num_hidden_layers"],
               "window_size": STREAM_70B_WINDOW, "residency_size": STREAM_70B_RESIDENCY, "plan": eng.plan.name,
               "make_s": made_s, "layer_bytes": layer_bytes, "host_pinned_bytes": host_bytes,
               "card_cap_bytes": STREAM_70B_CAP_BYTES, "card_memory_bytes": total, "device_peak_bytes": peak,
               "slabs": after["slabs"], "slab_bytes": after["slab_bytes"],
               "prefill_tokens": STREAM_70B_PROMPT, "prefill_ms": prefill_ms, "prefill_launches": prefill_launches,
               "decode_steps": STREAM_70B_STEPS, "decode_wall_ms": walls, "decode_wall_ms_median": step_ms,
               "wrapper_launches_per_step": per_step, "h2d_bytes_per_step": step_bytes,
               "h2d_gb_per_s_achieved": step_bytes / (step_ms / 1e3) / 1e9,
               "pinned_probe_gb_per_s": probe, "pinned_probe_trials_gb_per_s": probes, "step_bound_ms": bound_ms, "bound_by": "bytes (host-to-device)",
               "step_bound_ms_at_64_gb_per_s": step_bytes / PCIE_GEN5_X16_BYTES_PER_S * 1e3,
               "step_over_bound": step_ms / bound_ms, "weight_cache": after, "tokens": tokens}
        emit(row)
        return row
    finally:
        if eng is not None:
            eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(1.0)


# ---- speculative decoding and the prefix cache (A4) -----------------------------

SPEC_L = 4  # drafted tokens a verify block (DNET_API_SPEC_LOOKAHEAD)
# the batched verify's lane starts: a batch of long and short conversations
SPEC_LANE_STARTS = [100, 611, 1024, 1500, 2047, 2600, 3333, 4000]
SPEC_LANE_T = (SPEC_L + 1, 8)
SPEC_SCALAR_POS = (113, 2048)  # the single-sequence verify's shape (T = L + 1)
SPEC_KERNEL_LAYERS = 3  # caches rotated per timed call: each > the 50 MB L2 at B = 8
SPEC_TURN_TOKENS = PREFILL_CHUNK


def _spec_widths() -> list:
    """(name, H, KVH, Dqk, Dv, scale) of the per-lane rows: Llama-3.2-1B's
    heads (the served model's), Llama-3-8B's at (128, 128), and
    DeepSeek-V2-Lite's MLA widths at its softmax scale."""
    return [("Llama-3.2-1B", H, KVH, D, D, None), ("Llama-3-8B", 32, 8, 128, 128, None),
            ("DeepSeek-V2-Lite", MLA_H, MLA_H, MLA_DQK, MLA_DV, _mla_scale())]


def lanes_bound(starts: list, T: int, h: int, kvh: int, dqk: int, dv: int, dtype) -> tuple:
    """(ms, bound_by) of one per-lane prefill call: q and the output once,
    the positions, and each lane's live K and V rows (start + T) once;
    2 * (dqk + dv) operations per (head, query, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = len(starts) * (T * h * (dqk + dv) * size + 4) + sum(p + T for p in starts) * kvh * (dqk + dv) * size
    pairs = sum(p + i + 1 for p in starts for i in range(T))
    return bytes_ops_bound(nbytes, 2 * h * (dqk + dv) * pairs, dtype)


def _lanes_call(dtype, h, kvh, dqk, dv, T, layers: int, g, starts=SPEC_LANE_STARTS):
    """q [B, T, h, dqk] and `layers` caches [B, S, kvh, .] in `dtype`, the
    lane starts as the kernel takes them."""
    B = len(starts)
    q = torch.randn(B, T, h, dqk, generator=g, device="cuda").to(dtype)
    kv = [(torch.randn(B, S, kvh, dqk, generator=g, device="cuda").to(dtype),
           torch.randn(B, S, kvh, dv, generator=g, device="cuda").to(dtype)) for _ in range(layers)]
    return q, kv, torch.tensor(starts, dtype=torch.int32, device="cuda")


def phase_spec_launches() -> dict:
    """Device kernels per call of the prefill kernel's per-lane form (B = 8,
    T = L + 1, torch.profiler, right after the build as the other forms'
    counts), bf16 and f32 at each width pair: exactly 1, counted on
    flash_prefill_lanes.  Returns {"flash_prefill_lanes": 1}."""
    from dnet_tpu_torch.ops.flash_attention import flash_prefill

    g = torch.Generator(device="cuda").manual_seed(23)
    counts = {}
    for name, h, kvh, dqk, dv, scale in _spec_widths():
        for dtype in (torch.bfloat16, torch.float32):
            q, kv, pos = _lanes_call(dtype, h, kvh, dqk, dv, SPEC_L + 1, 1, g)

            def call():
                return flash_prefill(q, kv[0][0], kv[0][1], max(SPEC_LANE_STARTS), scale=scale, positions=pos)

            call()
            before = flash_prefill.launches_lanes
            n = kernels_per_call(call)
            check(n == 1 and flash_prefill.launches_lanes > before, f"per-lane prefill {name} {dtype}: {n} kernels")
            counts[f"{name} {str(dtype).split('.')[-1]}"] = n
            del q, kv
    emit({"phase": "spec_launches", "kernels_per_call": counts})
    torch.cuda.empty_cache()
    return {"flash_prefill_lanes": 1}


def phase_spec_kernels() -> dict:
    """The prefill kernel's per-lane form against its plain version (per-lane
    masks) at each width pair, f32 and bf16, B = 8 lanes at
    SPEC_LANE_STARTS, T = 5 (the verify block at L = 4) and 8, timed beside
    SDPA with the per-lane causal mask as a tensor and its bound (each
    lane's live K/V read once); then the scalar form at the single-sequence
    verify's shape (B = 1, T = 5 at pos 113 and 2,048).  Returns the main
    row: bf16 at Llama-3.2-1B's heads, T = 5."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain

    g = torch.Generator(device="cuda").manual_seed(29)
    main = {}
    top = max(SPEC_LANE_STARTS)
    for name, h, kvh, dqk, dv, scale in _spec_widths():
        for dtype in (torch.float32, torch.bfloat16):
            for T in SPEC_LANE_T:
                q, kv, pos = _lanes_call(dtype, h, kvh, dqk, dv, T, SPEC_KERNEL_LAYERS, g)
                out = flash_prefill(q, kv[0][0], kv[0][1], top, scale=scale, positions=pos)
                torch.cuda.synchronize()
                want = flash_prefill_plain(q.float(), kv[0][0].float(), kv[0][1].float(), top, scale=scale,
                                           positions=pos)
                err = (out.float() - want).abs().max().item()
                check(out.shape == (len(SPEC_LANE_STARTS), T, h, dv) and bool(torch.isfinite(out).all()),
                      f"per-lane prefill {name} output")
                check(err <= TOL[dtype], f"per-lane prefill {name} {dtype} T={T}: max err {err}")
                keys = top + T
                j = torch.arange(keys, device="cuda")
                mask = j[None, None, None, :] <= (pos.long()[:, None, None, None]
                                                  + torch.arange(T, device="cuda")[None, None, :, None])
                qt = q.transpose(1, 2)
                lib_kv = [(k[:, :keys].transpose(1, 2), v[:, :keys].transpose(1, 2)) for k, v in kv]

                def lib(l):
                    return sdpa(qt, lib_kv[l][0], lib_kv[l][1], attn_mask=mask, enable_gqa=True, scale=scale)

                lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
                check(lib_err <= TOL[torch.bfloat16], f"per-lane prefill {name} yardstick disagrees: {lib_err}")
                bound, by = lanes_bound(SPEC_LANE_STARTS, T, h, kvh, dqk, dv, dtype)
                row = {
                    "phase": "spec_kernels", "kernel": "flash_prefill_lanes", "heads_of": name,
                    "dtype": str(dtype).split(".")[-1], "lanes": len(SPEC_LANE_STARTS), "T": T,
                    "starts": SPEC_LANE_STARTS, "S": S, "H": h, "KVH": kvh, "Dqk": dqk, "Dv": dv,
                    "max_err": err, "tol": TOL[dtype],
                    "kernel_ms": device_time_ms(
                        lambda l: flash_prefill(q, kv[l][0], kv[l][1], top, scale=scale, positions=pos),
                        SPEC_KERNEL_LAYERS),
                    "plain_ms": device_time_ms(
                        lambda l: flash_prefill_plain(q, kv[l][0], kv[l][1], top, scale=scale, positions=pos),
                        SPEC_KERNEL_LAYERS, 3),
                    "library_ms": device_time_ms(lib, SPEC_KERNEL_LAYERS), "library_max_err": lib_err,
                    "library_call": "scaled_dot_product_attention, the per-lane causal mask as a tensor",
                    "bound_ms": bound, "bound_by": by,
                }
                row["times_library"] = row["kernel_ms"] / row["library_ms"]
                row["times_bound"] = row["kernel_ms"] / bound
                emit(row)
                if dtype == torch.bfloat16 and T == SPEC_L + 1 and name == "Llama-3.2-1B":
                    main["flash_prefill_lanes"] = row
                del q, kv, lib_kv
    # the scalar form at the single-sequence verify's shape
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        for p in SPEC_SCALAR_POS:
            T = SPEC_L + 1
            q = torch.randn(1, T, H, D, generator=g, device="cuda").to(dtype)
            out = flash_prefill(q, kc[0], vc[0], p)
            torch.cuda.synchronize()
            want = flash_prefill_plain(q.float(), kc[0].float(), vc[0].float(), p)
            err = (out.float() - want).abs().max().item()
            check(err <= TOL[dtype], f"verify-shape prefill pos={p} {dtype}: max err {err}")
            keys = p + T
            mask = torch.arange(keys, device="cuda")[None, :] <= p + torch.arange(T, device="cuda")[:, None]
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, kc[l, :, :keys].transpose(1, 2), vc[l, :, :keys].transpose(1, 2), attn_mask=mask,
                            enable_gqa=True)

            bound, by = prefill_bound(T, p, dtype)
            row = {"phase": "spec_kernels", "kernel": "flash_prefill", "shape": "single-sequence verify block",
                   "dtype": str(dtype).split(".")[-1], "T": T, "pos": p, "S": S, "H": H, "KVH": KVH, "D": D,
                   "max_err": err, "tol": TOL[dtype],
                   "kernel_ms": device_time_ms(lambda l: flash_prefill(q, kc[l], vc[l], p), LAYERS),
                   "plain_ms": device_time_ms(lambda l: flash_prefill_plain(q, kc[l], vc[l], p), LAYERS, 3),
                   "library_ms": device_time_ms(lib, LAYERS), "bound_ms": bound, "bound_by": by}
            row["times_library"] = row["kernel_ms"] / row["library_ms"]
            row["times_bound"] = row["kernel_ms"] / bound
            emit(row)
        del kc, vc
    torch.cuda.empty_cache()
    return main


def _spec_model():
    """spec_parity's model: 2 f32 layers at Llama-3.2-1B's heads (32 / 8,
    head dim 64), narrow elsewhere so that the CPU keeps up."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_params

    raw = {"model_type": "llama", "vocab_size": 512, "hidden_size": 512, "intermediate_size": 1024,
           "num_hidden_layers": 2, "num_attention_heads": H, "num_key_value_heads": KVH, "head_dim": D,
           "rope_theta": 500000.0, "tie_word_embeddings": True}
    cfg = ModelConfig.from_hf(raw)
    window, edge = random_llama_params(cfg, range(2), torch.device("cpu"), torch.float32, seed=3)
    return raw, cfg, window, edge


def _spec_lanes(eng, prompts: dict, decs: dict, n: int) -> dict:
    """Every prompt prefilled on a batched engine, then batched decode with
    budgets until each has n tokens."""
    toks = {k: [int(eng.prefill_and_sample(k, p, decs[k]).token[0])] for k, p in prompts.items()}
    while any(len(t) < n for t in toks.values()):
        live = {k: t for k, t in toks.items() if len(t) < n}
        out, errs = eng.decode_batch({k: (t[-1], decs[k]) for k, t in live.items()},
                                     budgets={k: n - len(t) for k, t in live.items()})
        check(not errs, f"spec lanes: {errs}")
        for k, r in out.items():
            toks[k].append(int(r.token[0]))
    for k in prompts:
        eng.end_session(k)
    return {k: t[:n] for k, t in toks.items()}


def phase_spec_parity() -> dict:
    """Speculation and the prefix cache on the GPU against the CPU, f32, a
    2-layer model at Llama-3.2-1B's heads: the single-sequence speculative
    greedy stream (L = 4) equals the plain one on both devices; on 8 dense
    slots, three greedy lanes verifying together beside a seeded sampled
    lane equal their plain streams (the sampled lane its serial stream on
    the same device), with one per-lane launch a layer for each verify
    block; a self-draft (the model written as a checkpoint and named as its
    own draft) emits L + 1 tokens from its first block; a prefix hit's
    first-token logits equal a cold prefill's within 2e-3.  Returns the
    launches of the per-lane form on the card."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint

    raw, cfg, window, edge = _spec_model()
    greedy, sampled = DecodingParams(temperature=0.0), DecodingParams(temperature=0.9, top_p=0.9, seed=7)
    prompts = {"g0": [7, 3, 11, 7, 3, 11, 7, 3] * 4, "g1": [5, 9, 5, 9, 5, 9, 2] * 3, "g2": list(range(40, 140)),
               "s": [250, 99, 13, 4]}
    kw = dict(max_seq=512, param_dtype="float32")
    row = {"phase": "spec_parity", "lookahead": SPEC_L, "model": "2 layers, H 32, KVH 8, head dim 64, f32"}
    single, lanes = {}, {}
    for dev in ("cuda", "cpu"):
        plain = LocalEngine.from_params(cfg, window, edge, device=dev, **kw)
        spec = LocalEngine.from_params(cfg, window, edge, device=dev, spec_lookahead=SPEC_L, **kw)
        want = {k: [r.token_id for r in plain.generate(p, greedy, max_tokens=32, nonce=k)]
                for k, p in prompts.items() if k != "s"}
        got = {k: [r.token_id for r in spec.generate(p, greedy, max_tokens=32, nonce=k)]
               for k, p in prompts.items() if k != "s"}
        check(got == want, f"spec_parity {dev}: the speculative stream differs from the plain one")
        check(spec.spec_blocks > 0, f"spec_parity {dev}: no verify block ran")
        single[dev] = got
        row[f"single_{dev}"] = {"blocks": spec.spec_blocks, "emitted": spec.spec_emitted}
        serial = [r.token_id for r in plain.generate(prompts["s"], sampled, max_tokens=24, nonce="s")]
        eng = BatchedEngine.from_params(cfg, window, edge, slots=BATCH_SLOTS, device=dev, spec_lookahead=SPEC_L,
                                        **kw)
        reset_launch_counts()
        got = _spec_lanes(eng, prompts, {k: sampled if k == "s" else greedy for k in prompts}, 24)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = launch_counts()["flash_prefill_lanes"]
            check(launched == cfg.num_hidden_layers * eng.spec_blocks > 0,
                  f"spec_parity: {launched} per-lane launches for {eng.spec_blocks} verify blocks")
            row["lanes_launches"] = launch_counts()
        check(got.pop("s") == serial, f"spec_parity {dev}: the sampled lane differs from its serial stream")
        check(got == {k: v[:24] for k, v in want.items()}, f"spec_parity {dev}: a greedy lane differs")
        lanes[dev] = got
        row[f"lanes_{dev}"] = {"blocks": eng.spec_blocks, "emitted": eng.spec_emitted}
        eng.close()
        del plain, spec
    check(single["cuda"] == single["cpu"] and lanes["cuda"] == lanes["cpu"], "spec_parity: GPU and CPU differ")
    tmp = tempfile.mkdtemp(prefix="dnet-torch-spec-")
    try:
        save_checkpoint(tmp, raw, hf_tensors(window, edge))
        draft = LocalEngine(tmp, device="cuda", spec_lookahead=SPEC_L, draft_dir=tmp, **kw)
        r0 = draft.prefill_and_sample("d", prompts["g2"], greedy)
        first = draft.decode_spec("d", int(r0.token[0]), greedy, 32)
        check(len(first) == SPEC_L + 1, f"self-draft block emitted {len(first)} of {SPEC_L + 1}")
        draft.end_session("d")
        got = [r.token_id for r in draft.generate(prompts["g2"], greedy, max_tokens=32, nonce="d")]
        check(got == single["cuda"]["g2"], "self-draft stream differs from the plain one")
        row["self_draft"] = {"first_block": len(first), "blocks": draft.spec_blocks, "emitted": draft.spec_emitted}
        draft.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    base = prompts["g2"]
    ext = base + [9, 8, 7, 6]
    cold = {dev: LocalEngine.from_params(cfg, window, edge, device=dev, **kw).prefill("c", ext).float().cpu()
            for dev in ("cuda", "cpu")}
    warm = LocalEngine.from_params(cfg, window, edge, device="cuda", prefix_cache_size=2, **kw)
    warm.prefill("a", base)
    warm.end_session("a")
    hit = warm.prefill("b", ext).float().cpu()
    check(warm.prefix_cache.stats["hits"] == 1, f"no prefix hit: {warm.prefix_cache.stats}")
    errs = {dev: (hit - c).abs().max().item() for dev, c in cold.items()}
    check(max(errs.values()) <= 2e-3, f"prefix hit logits vs cold: {errs}")
    row["prefix_hit"] = {"tokens_restored": len(base), "logits_max_err_vs_cold": errs, "tol": 2e-3}
    emit(row)
    torch.cuda.empty_cache()
    return row["lanes_launches"]


def _first_divergence(a: list, b: list) -> Optional[int]:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None if len(a) == len(b) else min(len(a), len(b)))


def phase_spec_serve(model_dir: str, port: int) -> dict:
    """The serve checkpoint (full-width Llama-3.2-1B, bf16) over HTTP with
    and without speculation and the prefix cache.  The requests carry no
    logit bias (a biased request does not speculate), so the random
    weights' greedy tokens are mostly outside the byte tokenizer's 256 and
    the visible text is short: the time to the first token is a 1-token
    request's wall time, rates are completion tokens over wall time, and
    token agreement is checked in process too.  Single sequence: a greedy
    chat (64 tokens) and its 1-token probe, then a two-turn chat whose
    turn 2 resends turn 1 (turn 2 a 1-token probe), on the plain server and
    on one with DNET_API_SPEC_LOOKAHEAD=4 and DNET_API_PREFIX_CACHE=4; a
    self-draft (DNET_API_DRAFT_MODEL naming the checkpoint); --batch-slots 8
    with the batch_serve prompts (greedy, no bias, concurrent), plain and
    speculating.  Reports tok/s, the first token's time, tokens a verify
    block, whether the visible text agrees with the plain pass (in bf16 a
    verify block's prefill kernel and a plain step's decode kernel may
    round a near-tie apart: reported, not required), turn 2's first token
    on a hit against the cold server and the prefill tokens saved, and the
    in-process greedy tokens of a speculating bf16 engine against a plain
    one; every batched verify block one per-lane launch a layer.  Returns
    the batched speculating pass's launches."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    model = "llama-3.2-1b-synthetic"
    text = "Count: one two three one two three one two three"
    chat = {"model": model, "max_tokens": MAX_TOKENS, "temperature": 0,
            "messages": [{"role": "user", "content": text}]}
    probe = dict(chat, max_tokens=1)
    warm = dict(chat, max_tokens=8, messages=[{"role": "user", "content": "Warm up."}])

    def turns(turn_text):
        turn1 = dict(chat, messages=[{"role": "user", "content": turn_text}])

        def turn2(results):
            return dict(probe, messages=[{"role": "user", "content": turn_text},
                                         {"role": "assistant", "content": results[-1]["content"]},
                                         {"role": "user", "content": "Say that again in other words."}])
        return [turn1, turn2]

    # a first request and a first two-turn pair warm the server (first-use
    # allocations and launches); the second pair is the measured one
    turn_text = _long_prompt(SPEC_TURN_TOKENS)
    requests = [warm, chat, probe]
    then = turns("Tell me a story. " + turn_text) + turns(turn_text)
    kinds = ["warm", "greedy", "first_token", "warm_turn1", "warm_turn2_first_token", "turn1", "turn2_first_token"]
    args = Namespace(host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
                     max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0)

    def summary(results, launches, load_s, health, names):
        out = {"load_s": load_s, "engine": {k: v for k, v in health["engine"].items() if k.startswith(("spec", "prefix"))}}
        for name, r in zip(names, results):
            want = 1 if name.endswith("first_token") else 8 if name == "warm" else MAX_TOKENS
            check(r["status"] == 200 and r["tokens"] == want, f"spec_serve {name}: {r['status']}, {r['tokens']}")
            out[name] = {"s": r["s"], "tokens_per_s": r["tokens"] / r["s"], "visible_chars": len(r["content"])}
        eng = health["engine"]
        if eng.get("spec_blocks"):
            out["tokens_per_block"] = eng["spec_emitted"] / eng["spec_blocks"]
        out["launches"] = {k: v for k, v in launches.items() if v}
        return out

    row = {"phase": "spec_serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
           "lookahead": SPEC_L}
    plain_res, launches, load_s, health = asyncio.run(_drive(args, requests, then=then))
    row["plain"] = summary(plain_res, launches, load_s, health, kinds)
    with environ({"DNET_API_SPEC_LOOKAHEAD": str(SPEC_L), "DNET_API_PREFIX_CACHE": "4"}):
        spec_res, launches, load_s, health = asyncio.run(_drive(args, requests, then=then))
    row["spec"] = summary(spec_res, launches, load_s, health, kinds)
    cache = health["engine"]["prefix_cache"]
    check(health["engine"]["spec_blocks"] > 0, "spec_serve: no verify block ran")
    check(cache["hits"] >= 2, f"spec_serve: the turns 2 did not hit the prefix cache: {cache}")
    row["speedup"] = row["spec"]["greedy"]["tokens_per_s"] / row["plain"]["greedy"]["tokens_per_s"]
    # the hit covers turn 1's whole prompt (its snapshot): those tokens are not prefilled again
    t2 = kinds.index("turn2_first_token")
    row["prefix"] = {"turn2_first_token_s_hit": spec_res[t2]["s"], "turn2_first_token_s_cold": plain_res[t2]["s"],
                     "prefill_tokens_saved": len(_template_ids(turn_text)), "prefix_cache": cache}
    row["visible_text_agrees"] = {k: a["content"] == b["content"] for k, a, b in zip(kinds, plain_res, spec_res)}
    with environ({"DNET_API_SPEC_LOOKAHEAD": str(SPEC_L), "DNET_API_DRAFT_MODEL": model_dir}):
        draft_res, launches, load_s, health = asyncio.run(_drive(args, requests))
    row["self_draft"] = summary(draft_res, launches, load_s, health, kinds[:3])
    row["self_draft"]["visible_text_agrees"] = draft_res[1]["content"] == plain_res[1]["content"]
    check(health["engine"].get("spec_draft") is True, "spec_serve: the draft model did not load")
    # half of batch_serve's tokens a request: the script's time limit
    burst = [{"model": model, "max_tokens": MAX_TOKENS // 2, "temperature": 0, "messages": b["messages"]}
             for b in _batch_bodies()]
    bargs = _batch_args(model_dir, port)

    def burst_row(results, load_s):
        for i, r in enumerate(results):
            check(r["status"] == 200 and r["tokens"] == MAX_TOKENS // 2, f"spec_serve burst {i}: {r['status']}")
        wall = max(r["s"] for r in results)  # the requests start together
        return {"load_s": load_s, "burst_s": wall, "aggregate_tokens_per_s": sum(r["tokens"] for r in results) / wall}

    plain_b, _, load_s, _ = asyncio.run(_drive(bargs, burst, concurrent=True))
    row["batched_plain"] = burst_row(plain_b, load_s)
    with environ({"DNET_API_SPEC_LOOKAHEAD": str(SPEC_L)}):
        spec_b, lanes_launches, load_s, health = asyncio.run(_drive(bargs, burst, concurrent=True))
    eng = health["engine"]
    check(eng["spec_blocks"] > 0, "spec_serve batched: no verify block ran")
    check(lanes_launches["flash_prefill_lanes"] == LAYERS * eng["spec_blocks"],
          f"per-lane launches {lanes_launches['flash_prefill_lanes']} != {LAYERS} x {eng['spec_blocks']} blocks")
    row["batched_spec"] = {**burst_row(spec_b, load_s), "verify_blocks": eng["spec_blocks"],
                           "lane_blocks": eng["spec_lane_blocks"],
                           "tokens_per_lane_block": eng["spec_emitted"] / eng["spec_lane_blocks"],
                           "launches": {k: v for k, v in lanes_launches.items() if v}}
    row["batched_speedup"] = row["batched_spec"]["aggregate_tokens_per_s"] / row["batched_plain"]["aggregate_tokens_per_s"]
    row["batched_visible_text_agrees"] = sum(a["content"] == b["content"] for a, b in zip(plain_b, spec_b))
    # the greedy tokens themselves, in process: a speculating bf16 engine against a plain one
    ids = _template_ids(text)
    streams = {}
    for name, kw in (("plain", {}), ("spec", {"spec_lookahead": SPEC_L})):
        eng = LocalEngine(model_dir, max_seq=S, device="cuda", **kw)
        streams[name] = [r.token_id for r in eng.generate(ids, DecodingParams(temperature=0.0), max_tokens=MAX_TOKENS)]
        eng.close()
        del eng
        gc.collect()
    row["bf16_tokens"] = {"agree": sum(a == b for a, b in zip(streams["plain"], streams["spec"])),
                          "of": MAX_TOKENS, "first_divergence": _first_divergence(streams["plain"], streams["spec"])}
    emit(row)
    torch.cuda.empty_cache()
    return {"launches": lanes_launches}


def lane_summary(rows: dict, paths: dict) -> dict:
    """The lane forms' line: each main row with the kernels line's keys,
    its launches taken from the path that ran it (`paths`: row name ->
    launches dict of that path)."""
    out = []
    for name, row in rows.items():
        counter = row["counter"]
        launches = paths[name].get(counter, 0)
        check(launches > 0, f"{name}: {counter} never launched on its path")
        out.append({"name": name, "route": "cuda", "source": "dnet_tpu_torch/csrc/flash_decode.cu",
                    "replaces": "dnet_tpu/ops/flash_decode.py:50 (" + row["cache"] + ", lanes)", "launches": launches,
                    "max_abs_err": row["max_err"], "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "times_library": row["times_library"], "kernels_per_call": row["kernels_per_call"]})
    line = {"phase": "lane_kernels_summary", "kernels": out}
    emit(line)
    return line


def row_extras(name: str, row: dict, per_call: dict) -> dict:
    """A row's time over the library call's and, for a decode row, its device
    kernels per call (phase_decode_launches), both from this run."""
    extras = {"times_library": row["kernel_ms"] / row["library_ms"]}
    if name in per_call:
        extras["kernels_per_call"] = per_call[name]
    return extras


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from dnet_tpu_torch.core.engine import bucket_length
    from dnet_tpu_torch.kernels.build import build_all, ptxas_report
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    card = gpu_line()
    t0 = time.perf_counter()
    # the decode, prefill and paged kernels' register / spill reports compile beside the build
    with ThreadPoolExecutor(3) as pool:
        report = pool.submit(ptxas_report, "flash_decode")
        prefill_report = pool.submit(ptxas_report, "flash_prefill")
        paged_report = pool.submit(ptxas_report, "paged_attention")
        build_all()
        build_s = time.perf_counter() - t0
        report, prefill_report, paged_report = report.result(), prefill_report.result(), paged_report.result()
    emit({"phase": "device", "gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "kernel_build_s": build_s, "ptxas_report_s": time.perf_counter() - t0})
    emit(ptxas_line(report, prefill_report, paged_report))
    column_per_call = phase_column_launches()
    per_call = phase_decode_launches()
    per_call.update(phase_paged_launches(BATCH_POSITIONS))
    lane_per_call = phase_lane_launches()
    per_call.update(phase_spec_launches())

    prompt_text = "Write one line about GPUs."
    tok = ByteTokenizer()
    n_prompt = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": prompt_text}])))
    main_path = phase_kernels(bucket_length(n_prompt), n_prompt + MAX_TOKENS - 2)
    phase_wide_group_decode()
    phase_wide_prefill()
    # the batched path's mix: every batch_serve lane half-way through its output
    main_path["paged_attend"] = phase_paged_kernels(BATCH_POSITIONS)
    # the ring's path: its decode hop (R=1, bf16) runs once per token
    main_path.update(phase_column_kernels(column_per_call))
    per_call["column_sq_norms"] = main_path["column_sq_norms"]["kernels_per_call"]
    # the quantized caches' path: the single-sequence serve's position
    main_path.update(phase_quant_kernels(n_prompt + MAX_TOKENS - 2, BATCH_POSITIONS))
    # gpt_oss's sliding layers: the ring at the step's position
    main_path.update(phase_rotating_kernels())
    # the decode kernel's lane forms (B = 8) and the dense gather's copies
    lane_rows = phase_lane_kernels(lane_per_call)
    # the batched verify block's per-lane prefill form, and the scalar form at the single-sequence verify's shape
    main_path.update(phase_spec_kernels())
    phase_codec_host()
    phase_parity()
    phase_batch_parity()
    phase_sched_parity()
    lane_parity = phase_gather_parity()
    phase_spec_parity()
    phase_quant_parity()
    phase_wq_parity()
    phase_stream_parity()
    oss_parity = phase_gpt_oss_parity()
    # sequence parallelism: the LSE form at the sp_serve step's position
    # (both sp ranks share cuda:0), at the MLA widths and over codes too,
    # then parity
    main_path.update(phase_lse_kernels(SP_SERVE_POS))
    main_path.update(phase_lse_form_kernels(SP_SERVE_POS))
    sp_parity = phase_sp_parity()
    served, batched, quant, ring, sp_served, gathered, spec_served = phase_serve(prompt_text, n_prompt)
    long_text = _batch_prompts()[BATCH_PROMPT_TOKENS.index(300)]
    _, oss_served = phase_gpt_oss(prompt_text, long_text, _free_port())
    # deepseek_v2 (after gpt_oss has freed its memory): the MLA-width
    # kernels at the served prompt's bucket and the step's position, parity,
    # the 27-layer step, the 2-layer serve
    main_path.update(phase_mla_kernels(bucket_length(n_prompt)))
    phase_deepseek_parity()
    _, ds_served = phase_deepseek(prompt_text, long_text, _free_port())
    # qwen3_moe (after deepseek_v2 has freed its memory): the G = 16 kernel
    # rows at the 235B serve's position and the batch mix, the qwen family
    # parity, Qwen3-30B-A3B's 48-layer step, the 1-layer 235B serves
    main_path.update(phase_wide_kernels(n_prompt + MAX_TOKENS - 2))
    phase_mma_kernels()
    phase_qwen_parity()
    _, qw_served, qw_batched = phase_qwen3_moe(prompt_text, _free_port())
    # Llama-3.3-70B-Instruct at int8 (after every earlier phase has freed
    # its memory): all 80 layers on the one card; then in bf16, streamed
    # from host memory past a capped card
    phase_wq_step_70b()
    phase_stream_step_70b()

    # each kernel with its launches on its own path: the single-sequence
    # serve for the dense prefill and decode kernels, the batched serve for
    # the paged one (whose prompts also went through the prefill kernel),
    # the qsparse8 ring for the column kernels (counted in the shards), the
    # quantized single-sequence serves for the q8 / q4 decode variants, the
    # gpt_oss serve for the rotating variant (its q8 / q4 forms on the
    # gpt_oss parity's q8 / q4 passes: the serve runs a bf16 cache), the
    # deepseek_v2 serve (bf16, q8 and q4 passes) for the MLA widths, the sp
    # serve (f32 and bf16 passes) for the LSE form and its q8 pass for the
    # form over int8 codes, deepseek_v2's sp serve for the MLA-width form,
    # and the sp parity's q4 and MLA q8 / q4 passes for those forms (no
    # serve runs them), and the Qwen3-235B-A22B serves (single sequence,
    # batched) for the G = 16 forms, which run bf16 through the tensor-core
    # kernels (their rows the G = 16 rows')
    sources = {
        "flash_prefill": ("dnet_tpu_torch/csrc/flash_prefill.cu", "dnet_tpu/ops/flash_attention.py:38", served),
        "flash_decode": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50", served),
        "flash_decode_q8": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50", quant[8]),
        "flash_decode_q4": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50", quant[4]),
        "flash_decode_rotating": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50 (rotating)",
                                  oss_served),
        "flash_decode_rotating_q8": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                     "dnet_tpu/ops/flash_decode.py:50 (rotating, qbits 8)", {"launches": oss_parity[8]}),
        "flash_decode_rotating_q4": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                     "dnet_tpu/ops/flash_decode.py:50 (rotating, qbits 4)", {"launches": oss_parity[4]}),
        "flash_prefill_mla": ("dnet_tpu_torch/csrc/flash_prefill.cu",
                              "dnet_tpu/ops/flash_attention.py:38 (Dqk 192, Dv 128)", ds_served),
        "flash_prefill_lanes": ("dnet_tpu_torch/csrc/flash_prefill.cu",
                                "dnet_tpu/ops/flash_attention.py:38 (per-lane positions: jax.vmap over lanes, "
                                "dnet_tpu/core/batch.py:336)", spec_served),
        "flash_decode_mla": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50 (Dqk 192, Dv 128)",
                             ds_served),
        "flash_decode_mla_q8": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                "dnet_tpu/ops/flash_decode.py:50 (qbits 8, Dqk 192, Dv 128)", ds_served),
        "flash_decode_mla_q4": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                "dnet_tpu/ops/flash_decode.py:50 (qbits 4, Dqk 192, Dv 128)", ds_served),
        "flash_decode_lse": ("dnet_tpu_torch/csrc/flash_decode.cu",
                             "dnet_tpu/ops/flash_decode.py:50 (with_lse, sp_flash_decode_attend :475)", sp_served),
        "flash_decode_lse_q8": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                "dnet_tpu/ops/flash_decode.py:50 (with_lse, qbits 8)", sp_served),
        "flash_decode_lse_q4": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                "dnet_tpu/ops/flash_decode.py:50 (with_lse, qbits 4)", {"launches": sp_parity}),
        "flash_decode_lse_mla": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                 "dnet_tpu/ops/flash_decode.py:50 (with_lse, Dqk 192, Dv 128)", ds_served["sp_serve"]),
        "flash_decode_lse_mla_q8": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                    "dnet_tpu/ops/flash_decode.py:50 (with_lse, qbits 8, Dqk 192, Dv 128)",
                                    {"launches": sp_parity}),
        "flash_decode_lse_mla_q4": ("dnet_tpu_torch/csrc/flash_decode.cu",
                                    "dnet_tpu/ops/flash_decode.py:50 (with_lse, qbits 4, Dqk 192, Dv 128)",
                                    {"launches": sp_parity}),
        "flash_decode_wide": ("dnet_tpu_torch/csrc/flash_decode.cu",
                              "dnet_tpu/ops/flash_decode.py:50 (G > 8, any form)", qw_served),
        "flash_decode_mma": ("dnet_tpu_torch/csrc/flash_decode.cu",
                             "dnet_tpu/ops/flash_decode.py:50 (bf16, D = 128, G > 4)", qw_served),
        "paged_attend": ("dnet_tpu_torch/csrc/paged_attention.cu", "dnet_tpu/ops/paged_attention.py:92", batched),
        "paged_attend_wide": ("dnet_tpu_torch/csrc/paged_attention.cu", "dnet_tpu/ops/paged_attention.py:92 (G > 8)",
                              qw_batched),
        "paged_attend_mma": ("dnet_tpu_torch/csrc/paged_attention.cu",
                             "dnet_tpu/ops/paged_attention.py:92 (bf16, D = 128, G > 4)", qw_batched),
        "column_sq_norms": ("dnet_tpu_torch/csrc/column_ops.cu",
                            "dnet_tpu/compression/ops.py:24 (+ the top_k of :198-205)", {"launches": ring}),
        "gather_columns": ("dnet_tpu_torch/csrc/column_ops.cu", "dnet_tpu/compression/ops.py:81",
                           {"launches": ring}),
        "dequant_scatter_columns": ("dnet_tpu_torch/csrc/column_ops.cu", "dnet_tpu/compression/ops.py:81",
                                    {"launches": ring}),
    }
    # the lane forms, each with its launches on the path that ran it
    lane_summary(lane_rows, {
        "flash_decode_rotating_lanes": oss_served["batch_serve"]["launches"],
        "flash_decode_rotating_q8_lanes": lane_parity["gpt_oss-dense-q8"],
        "flash_decode_rotating_q4_lanes": lane_parity["gpt_oss-dense-q4"],
        "flash_decode_mla_lanes": ds_served["batch_serve"]["dense bf16"],
        "flash_decode_mla_q8_lanes": ds_served["batch_serve"]["gather q8"],
        "flash_decode_mla_q4_lanes": lane_parity["deepseek_v2-gather-q4"],
        "flash_decode_gathered": gathered["launches"]["gather bf16"],
        "flash_decode_q8_gathered": gathered["launches"]["gather q8 (ragged refused)"],
        "flash_decode_q4_gathered": lane_parity["llama-gather-q4"],
    })
    from dnet_tpu_torch.kernels import launch_counts

    check(set(sources) == set(launch_counts()), f"the kernels line misses counters: {set(launch_counts()) - set(sources)}")
    for name, (_, _, path) in sources.items():
        check(path["launches"].get(name, 0) > 0, f"{name} never launched on its path")
    check(batched["launches"]["flash_prefill"] > 0, "flash_prefill never launched on the batched path")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path["launches"][name], "max_abs_err": main_path[name]["max_err"],
         "ms": main_path[name]["kernel_ms"], "plain_ms": main_path[name]["plain_ms"],
         "bound_ms": main_path[name]["bound_ms"], "bound_by": main_path[name]["bound_by"],
         "library_ms": main_path[name]["library_ms"], **row_extras(name, main_path[name], per_call)}
        for name, (src, rep, path) in sources.items()
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
