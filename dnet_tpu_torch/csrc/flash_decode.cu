// Single-token (T = 1) decode attention over the dense preallocated KV cache,
// for Hopper: one launch of a split-K kernel whose last block to finish
// merges the splits.
//
// Replaces the TPU kernel `_decode_kernel` (dnet_tpu/ops/flash_decode.py:50,
// launched by `_decode_pallas`) in every form it runs: its plain variant,
// its `qbits` 8/4 variant, its `rotating` variant (the gpt_oss sliding-window
// ring buffer, flash_decode.py:100-123 and :184-186) and its `with_lse` form
// (flash_decode.py:141-150, outputs :213-223, run by `sp_flash_decode_attend`
// on each sequence-parallel rank's shard of the cache).  q [B, 1, H, DQK];
// k [B, S, KVH, DQK] and v [B, S, KVH, DV] in q's dtype (or bf16 under an f32
// q: the DNET_KV_BITS=16 cache of an f32 model), or quantized: int8 codes of
// those widths, or int4 nibbles packed in pairs along the head dim (low
// nibble = even index, offset binary) as uint8 [.., DQK/2] and [.., DV/2],
// each with k_scale / v_scale [B, S, KVH, 1] f32.  (DQK, DV) is (64, 64),
// (128, 128) or MLA's (192, 128) (deepseek_v2, G = 1): scores run over DQK,
// everything after the softmax over DV.  Lane b's query attends cache slots
// [0, lengths[b]) (lengths = position + 1; 0 = an idle lane); G = H / KVH
// query heads share each KV head, any G: a block holds GP (1, 4 or 8 on the
// CUDA cores, 16 in the tensor-core form) of them, and a larger group is
// split over row groups of blocks (below).
//
// Rotating (ROT, DQK == DV): the cache is a ring of S = W slots written
// before the call, lane b's query sits at pos = lengths[b] - 1 (lengths may
// exceed S), its live slots are [0, min(lengths[b], S)), and slot s holds
// absolute position k_abs = pos - ((pos - s) mod S); a key is attended when
// k_abs >= 0 and k_abs > pos - window (window <= S).
//
// Epilogues.  Normalised (`dnet_flash_decode`): o [B, 1, H, DV] in q's dtype,
// the per-head sinks [H] folded into the denominator once; an idle lane gives
// zeros.  LSE (`dnet_flash_decode_lse`): the rank's UNNORMALISED partials, acc
// [B, 1, H, DV] f32 relative to the rank's max m, and m, l [B, KVH, G] f32; no
// sink, no division (the cross-rank combine, ops/ring_attention.py, does both
// once).  The rank's shard offset lives in the lengths the caller passes, so
// a rank wholly past pos has length 0 and writes exactly (0, -1e30, 0).  A
// quantized shard is read as codes, where the reference dequantizes it to
// f32 first (`read_kv`): both compute code * scale in f32.
//
// What bounds it on an H100.  One query row per head does 2 * G multiply-adds
// per K/V element it reads, far below the card's ~295 operations a byte, so
// its bound is the live cache it reads: lengths[b] * KVH * (DQK + DV) stored
// values (bf16 / f32, or codes plus two 4-byte scales) a lane.  At a decode's
// sizes (0.2 to 21 MB) that bound is 0.1 to 6 us, below what a call that
// folds nothing takes (chip_smoke.py's empty-rank rows), so what a call costs
// is its fixed latency plus, per tile, the block's work.  chip_smoke.py's
// rows show int8 and int4 codes taking about as long as bf16 values at
// (64, 64): there a tile's cost is the block's dependent arithmetic, not its
// bytes; only the MLA tiles (40 KB in bf16) get cheaper with fewer bytes.
// What the design does about it:
//   - One launch per call.  Each lane splits its own live tiles over
//     n_split <= 16 blocks (ceil(tiles / n_split) a block, so a short lane's
//     blocks stay balanced; a block past a lane's tiles folds nothing).  With
//     more than one, each block writes its state (m, l, acc per query row,
//     ~1 KB) to a scratch buffer and takes a ticket for its (lane, KV head)
//     with an acquire-release atomic; the block that takes the last one
//     reads every state from L2 and writes the outputs, and returns the
//     ticket to 0, so a stream's calls share one small buffer and no combine
//     kernel runs.  Why not a thread-block cluster merging through
//     distributed shared memory: an earlier version of this kernel did, and
//     on the card a clustered launch cost fixed time even with no tile to
//     fold, clusters of 16 did not all fit at once, and wider splits are
//     what a (64, 64) lane needs, its tiles being arithmetic-bound; the
//     ticket merge lets the plan spread a lane over 16 blocks, one block on
//     each of up to 132 SMs.
//   - K and V tiles are copied as the cache stores them (values, or codes
//     and the rows' scales) with 16-byte cp.async (4-byte for the scales,
//     zero-filled past the lane's live slots, so a dead row is never read)
//     into a ring of up to 80 KB of shared memory: tiles of 64 keys, or of
//     32 where a 64-key tile would pass 32 KB (MLA widths in bf16 or f32), 4
//     stages while they fit, never fewer than 2.  MLA in bf16 then keeps 3
//     tiles of 20 KB in flight while it folds the fourth, and two blocks fit
//     an SM.  One __syncthreads a tile.  Values are converted (bf16 -> f32,
//     code * scale in f32) as they are read into registers.
//   - The whole block works at every G.  Each of 8 warps owns an eighth of
//     every tile (8 or 4 keys): 8 lanes a key, each over 8-value units of
//     the row, so at G = 1 all 256 threads score and accumulate (16 warps of
//     4 keys were slower).  The arithmetic is cut where it is redundant: the dot of a
//     key reduces over its 8 lanes as a reduce-scatter (log2 GP halving
//     steps, then plain ones) that leaves each lane ONE query row's score, so
//     the online softmax (m, l in registers, exp2 on scores in log2 units: q
//     carries log2(e)) runs once per (key, row) instead of on every lane; p
//     and each row's rescale reach the PV lanes by shuffles, and a row's
//     rescale is skipped while its max stands.  PV runs in the lanes that
//     scored the key, each owning 8-value units of the accumulator.  Query
//     rows are sized to G (GP of 1, 4 or 8, a template parameter), and q is
//     kept pre-scaled in registers where it fits (GP * DQK / 8 <= 64
//     floats), read from shared memory otherwise.  The warps' states merge
//     once in shared memory after the loop.
//   - Any group size through the same instantiations.  A block folds one
//     row group: GP query rows (the launcher's `rows`: 1, 4 or 8), heads
//     kvh * G + r * GP .. min(G, (r + 1) * GP) - 1 of row group r; there are
//     RG = ceil(G / GP) row groups a KV head, so G = 16 (Qwen3-235B-A22B's
//     64 / 4 heads) runs as two blocks of 8 rows each and G = 12 as 8 + 4,
//     where the last group's rows past G load q as zeros and are never
//     written.  On the CUDA cores a GP of 16 would double the registers of
//     instantiations that spill at 8.  The RG blocks of one (split, KV head) are
//     adjacent in launch order (the row group is the fastest part of the
//     grid's x), so the second group reads the K/V tiles the first just
//     pulled into L2.  Each (lane, KV head, row group) has its own ticket
//     and its own states in the merge scratch, so a merge never mixes two
//     groups' rows or fires early, and the split plan counts blocks per
//     (KV head, row group).  At head dim 128 every group wider than 4
//     takes the tensor-core form (a bf16 q over a bf16 cache) or row
//     groups of 4 (an f32 q, a bf16 cache under an f32 q, int8 / int4
//     codes, the rotating ring): GP = 8 there held 128 f32 accumulators a
//     lane and spilled (316 / 456 B in bf16), and two row groups of 4 ran
//     G = 8 1.39x faster, so the launcher never asks for it and it is not
//     built.
//   - Latency paid once a call is cut: q and the lengths are loaded before
//     the first copies are issued, and the merging block loads every
//     block's state before it uses any.
//   - Numerics are the reference's up to f32 rounding: q * scale, scores,
//     P and PV in f32 FMAs on the CUDA cores, exp taken as exp2 of log2(e)
//     times the score; m leaves in natural units (an empty rank's exactly
//     -1e30).  The CUDA-core forms use no mma.sync: at G <= 4 a 16-row m
//     tile would be at most a quarter used (G = 1, MLA's, a sixteenth),
//     and the scores alone are about a third of a tile's instructions; an
//     f32 q keeps f32 FMAs; codes are dequantized in f32 as they are read.
//
// The tensor-core form (`flash_decode_mma_kernel`, csrc/mma.cuh): a bf16 q
// over a bf16 cache at (128, 128) with G >= 5 (Qwen2.5-7B's 7, Qwen3-30B-
// A3B's 8, Qwen3-235B-A22B's 16), never rotating.  There each K/V element
// costs 2 G multiply-adds on the CUDA cores (4x the G = 4, D = 64 tile's
// work a byte at G = 16), and a 64-key tile's scores are a 16 x 64 x 128
// product, mma.sync's m16 tile.  A block holds 16 query rows (rows past G
// load q as zeros and are never written; G = 24 takes two row groups), so
// a KV head's K/V tile is copied and converted once for all its heads,
// where row groups of the CUDA-core form copy it once per group.  It keeps
// this form's one launch, its split over up to 16 blocks a (lane, KV head,
// row group) merged by the last block through the same ticket and
// scratch, the cp.async ring of tiles in their stored type (4 stages of
// 64 keys, rows padded by 16 bytes so ldmatrix is free of bank conflicts:
// 139,264 bytes, one block an SM, which decode_plan's one wave allows),
// and both epilogues.  4 key groups of 16 keys split each tile, so a
// group's P fragment is one k-step of P V, and two warps share a group,
// each with half of the output's columns (64 f32 a thread; a probe on the
// card measured 8 warps faster than 4 from 2,048 live slots up).  q stays unscaled bf16 in A
// fragments; K comes by ldmatrix, V by ldmatrix.trans; the online softmax
// runs in the accumulator layout (a row's max and sum over its quad).
// Numerics: products of bf16 values are exact in f32, so the f32 scores
// scaled after the product by scale * log2(e) are the reference's
// (q * scale) . k up to f32 rounding; P enters P V as hi + lo, two bf16
// terms (about 16 bits of p, twice the P V instructions), the sums l taken
// from the unrounded p.  tests/test_torch_decode_mma.py emulates these
// numerics against the reference's kernel: about 1e-6 off in f32 with
// hi + lo, about 1e-3 with P rounded to bf16 alone (the prefill kernel's
// choice), which would miss the f32 tolerance (MMA_TOL, 1e-4) that the LSE
// partials are held to.  The warps' states merge once in shared memory,
// each row weighed once and the accumulators combined as float4 chunks,
// and the last block's merge reads the splits' states the same way: a
// loop over single elements left one warp a scheduler waiting on every
// step, which a probe on the card measured as most of a call's time.
//   - Host cost: the shared-memory attribute is set once per instantiation
//     and device; a call allocates its outputs, and its merge scratch only
//     the first time a stream needs more.

#include <atomic>

#include "mma.cuh"

namespace {

using dnet::NEG_INF;
using dnet::cp_async16;
using dnet::cp_commit;
using dnet::cp_wait;

constexpr int NTHREADS = 256;      // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int LPK = 8;             // lanes per key
constexpr int KPP = 32 / LPK;      // keys a warp scores per pass
constexpr int MAX_SPLIT = 16;      // blocks sharing one (lane, KV head)
constexpr int RING_BUDGET = 81920; // shared-memory bytes the ring aims at: two blocks an SM at MLA widths
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// bytes one row of D values takes as the cache stores it
template <typename KV, int QB, int D>
constexpr int row_bytes() {
  return QB == 8 ? D : QB == 4 ? D / 2 : D * (int)sizeof(KV);
}

// The shared-memory layout of one instantiation (bytes): the ring of NSTAGE
// stages, each [K tile | V tile | k scales | v scales]; after the loop the
// ring holds the 8 warps' states (m [GP], l [GP], acc [GP][DV]); then the
// pre-scaled q [GP][DQK] and the block's merged state, which it publishes
// for the merging block.
template <typename KV, int QB, int DQK, int DV, int GP>
struct Cfg {
  static constexpr int RK = row_bytes<KV, QB, DQK>();
  static constexpr int RV = row_bytes<KV, QB, DV>();
  // keys per tile: 64, or 32 where a 64-key tile of K and V would pass
  // 32 KB (MLA widths in bf16 or f32, f32 at 128): the ring then holds
  // more, smaller tiles, so more bytes stay in flight while one is folded
  static constexpr int BK = 64 * (RK + RV) > 32768 ? 32 : 64;
  static constexpr int WK = BK / NWARPS;  // keys a warp folds per tile
  static constexpr int PASSES = WK / KPP;
  static constexpr int KT = BK * RK;
  static constexpr int VT = BK * RV;
  static constexpr int SC = QB ? BK * 4 : 0;
  static constexpr int STAGE = KT + VT + 2 * SC;
  static constexpr int NSTAGE = 4 * STAGE <= RING_BUDGET ? 4 : 3 * STAGE <= RING_BUDGET ? 3 : 2;
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int UQ = DQK / (8 * LPK);  // 8-value units a lane holds of a K row
  static constexpr int UV = DV / (8 * LPK);   // and of a V row
  static constexpr bool QREG = GP * DQK / 8 <= 64;
  static constexpr int STATE = 2 * GP + GP * DV;  // floats: m, l, acc
  static constexpr int MERGE = NWARPS * STATE * 4;
  static constexpr int Q_OFF = RING > MERGE ? RING : MERGE;
  static constexpr int B_OFF = Q_OFF + GP * DQK * 4;
  static constexpr int BYTES = B_OFF + STATE * 4;
  static_assert(RK % 16 == 0 && RV % 16 == 0, "rows are copied as 16-byte chunks");
  static_assert(UQ * 8 * LPK == DQK && UV * 8 * LPK == DV, "head dims are multiples of 64");
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}


// Values 8u .. 8u + 7 of a row in shared memory, as the cache stores them,
// to f32 (codes times the row's scale s).
template <typename KV, int QB>
__device__ __forceinline__ void load_unit(const uint8_t* row, int u, float s, float* out) {
  if constexpr (QB == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + u * 8);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = (float)(int8_t)c[e] * s;
  } else if constexpr (QB == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(row + u * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t c = (raw >> (8 * e)) & 0xFFu;
      out[2 * e] = (float)((int)(c & 0xFu) - 8) * s;
      out[2 * e + 1] = (float)((int)(c >> 4) - 8) * s;
    }
  } else if constexpr (sizeof(KV) == 2) {
    dnet::load16<__nv_bfloat16>(reinterpret_cast<const __nv_bfloat16*>(row) + u * 8, out);
  } else {
    dnet::load16<float>(reinterpret_cast<const float*>(row) + u * 8, out);
    dnet::load16<float>(reinterpret_cast<const float*>(row) + u * 8 + 4, out + 4);
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (sizeof(T) == 4) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

// One call's arguments (pointers to device memory, shapes, the stream).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  float* part;         // [B, KVH, rg, n_split, STATE] f32: the blocks' states (n_split > 1)
  int* tickets;        // [B * KVH * rg] int32, 0 between calls: blocks done per (lane, KV head, row group)
  const float* sinks;  // normalised epilogue only; null: no sink
  void* o;             // q's dtype, or f32 in the LSE epilogue
  float* m;            // non-null selects the LSE epilogue
  float* l;
  int B, H, KVH, S, n_split;
  int rows, rg;        // query rows a block holds (GP) and row groups a KV head (ceil(G / GP))
  float scale;
  int rotating, window;
  cudaStream_t stream;
};

// KV: the cache's element type (T, bf16 under an f32 T, or uint8_t holding
// int8 / packed int4 codes); QB: 0, 8 or 4; GP: query rows a block holds
// (the launcher's rows); ROT: the rotating ring.  Grid (n_split * rg, KVH,
// B): n_split blocks per (lane, KV head, row group), the row group the
// fastest index of x.
template <typename T, typename KV, int QB, int DQK, int DV, int GP, bool ROT>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const Args a) {
  using C = Cfg<KV, QB, DQK, DV, GP>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* Bs = reinterpret_cast<float*>(smem + C::B_OFF);

  const int n_split = a.n_split;
  const int split = blockIdx.x / a.rg;
  const int rgi = blockIdx.x - split * a.rg;  // this block's row group
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = a.H, KVH = a.KVH, S = a.S;
  const int G = H / KVH;
  const int h0 = kvh * G + rgi * GP;  // the row group's first query head
  const int GB = min(GP, G - rgi * GP);  // and its rows; rows GB..GP-1 are masked
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kp = lane / LPK;   // which of the pass's keys
  const int sub = lane % LPK;  // which units of the row

  // q's elements this thread stages (loaded before the lengths' latency
  // is paid), then this block's tiles: the lane's live tiles, split evenly
  // over its n_split blocks
  constexpr int QPT = (GP * DQK + NTHREADS - 1) / NTHREADS;
  const T* qb = static_cast<const T*>(a.q) + ((long)b * H + h0) * DQK;
  const float q_scale = a.scale * LOG2E;  // scores in log2 units
  float qv[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = tid + r * NTHREADS;
    qv[r] = i < GB * DQK ? to_float(qb[i]) * q_scale : 0.f;
  }
  const int len = a.lengths[b];
  const int live = min(len, S);
  const int pos = len - 1;  // the query's absolute position (ROT)
  constexpr int BK = C::BK, WK = C::WK, PASSES = C::PASSES;
  const int n_tiles = (live + BK - 1) / BK;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int t_begin = min(split * per, n_tiles);
  const int t_end = min(t_begin + per, n_tiles);

  const long row0 = (long)b * S * KVH + kvh;  // row of (b, slot 0, kvh); a slot adds KVH
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) + row0 * C::RK;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) + row0 * C::RV;
  const long k_stride = (long)KVH * C::RK;
  const long v_stride = (long)KVH * C::RV;

  // copy tile `tile` into ring stage `stage`; rows past the live slots are
  // zero-filled without a read
  auto issue = [&](int tile, int stage) {
    uint8_t* st = smem + stage * C::STAGE;
    const int k0 = tile * BK;
    const int rows = min(BK, live - k0);
    constexpr int CK = C::RK / 16;
    constexpr int CV = C::RV / 16;
    for (int i = tid; i < BK * CK; i += NTHREADS) {
      const int r = i / CK, c = i - (i / CK) * CK;
      const bool ok = r < rows;
      cp_async16(st + r * C::RK + c * 16, kb + (ok ? (long)(k0 + r) * k_stride + c * 16 : 0), ok);
    }
    for (int i = tid; i < BK * CV; i += NTHREADS) {
      const int r = i / CV, c = i - (i / CV) * CV;
      const bool ok = r < rows;
      cp_async16(st + C::KT + r * C::RV + c * 16, vb + (ok ? (long)(k0 + r) * v_stride + c * 16 : 0), ok);
    }
    if constexpr (QB != 0) {
      for (int i = tid; i < 2 * BK; i += NTHREADS) {
        const int r = i % BK;
        const bool ok = r < rows;
        const float* src = (i < BK ? a.k_scale : a.v_scale) + row0 + (ok ? (long)(k0 + r) * KVH : 0);
        cp_async4(st + C::KT + C::VT + i * 4, src, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < C::NSTAGE - 1; ++s) {
    if (t_begin + s < t_end) issue(t_begin + s, s);
    cp_commit();
  }

  // the row group's query heads are contiguous: q[b, 0, h0 .. h0+GB-1, :]
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = tid + r * NTHREADS;
    if (i < GP * DQK) Qs[i] = qv[r];
  }
  __syncthreads();

  float qr[C::QREG ? GP : 1][C::QREG ? C::UQ : 1][8];
  if constexpr (C::QREG) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int uu = 0; uu < C::UQ; ++uu) {
        const float* src = Qs + g * DQK + (sub + LPK * uu) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][uu][e] = src[e];
      }
  }

  // The dot of a key reduces over its 8 lanes as a reduce-scatter: KB =
  // log2(GP) halving steps leave each lane one query row's sum, row
  // gl = sub >> (3 - KB), so the softmax runs once per (key, row); the
  // lanes of one row then share p and the rescale with the others by
  // shuffles.  Scores are in log2 units (q carries log2(e)), so p = exp2.
  constexpr int KB = GP == 1 ? 0 : GP == 4 ? 2 : 3;
  static_assert((1 << KB) == GP && LPK == 8, "GP is 1, 4 or 8 over 8 lanes a key");
  const int gl = sub >> (3 - KB);
  float m_r = NEG_INF, l_r = 0.f;  // row gl's running max (log2 units) and sum over the warp's keys
  float acc[GP][C::UV][8];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int uu = 0; uu < C::UV; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][uu][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_wait<C::NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();           // everyone's have, and stage (i - 1) % NSTAGE is free
    if (t + C::NSTAGE - 1 < t_end) issue(t + C::NSTAGE - 1, (i + C::NSTAGE - 1) % C::NSTAGE);
    cp_commit();

    const int k0 = t * BK;
    if (k0 + warp * WK >= live) continue;  // this warp's keys are all past the live slots
    const uint8_t* st = smem + (i % C::NSTAGE) * C::STAGE;
    const uint8_t* Kt = st;
    const uint8_t* Vt = st + C::KT;
    const float* ks = reinterpret_cast<const float*>(st + C::KT + C::VT);
    const float* vs = ks + BK;

    // scores of the warp's keys, key warp*WK + p*4 + kp: row gl's in sc[p]
    float sc[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int j = warp * WK + p * KPP + kp;
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.f;
#pragma unroll
      for (int uu = 0; uu < C::UQ; ++uu) {
        const int u = sub + LPK * uu;
        float kv[8];
        load_unit<KV, QB>(Kt + j * C::RK, u, QB ? ks[j] : 1.f, kv);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float qx = C::QREG ? qr[C::QREG ? g : 0][C::QREG ? uu : 0][e] : Qs[g * DQK + u * 8 + e];
            s[g] = fmaf(qx, kv[e], s[g]);
          }
      }
      // reduce-scatter: step `lvl` exchanges half the rows with lane ^ (4 >> lvl)
#pragma unroll
      for (int lvl = 0; lvl < KB; ++lvl) {
        const int off = 4 >> lvl;
        const int half = GP >> (lvl + 1);
        const bool up = sub & off;
#pragma unroll
        for (int r = 0; r < half; ++r) {
          const float send = up ? s[r] : s[r + half];
          const float keep = up ? s[r + half] : s[r];
          s[r] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = 4 >> KB; off > 0; off >>= 1) s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
      const int slot = k0 + j;
      bool valid = slot < live;
      if constexpr (ROT) {
        // the slot holds the most recent position <= pos congruent to it mod S
        int back = (pos - slot) % S;
        if (back < 0) back += S;
        const int k_abs = pos - back;
        valid = valid && k_abs >= 0 && k_abs > pos - a.window;
      }
      sc[p] = valid ? s[0] : NEG_INF;
    }

    // online softmax of row gl over the warp's WK keys (its lanes across the
    // 4 key groups), then p into sc
    float mt = sc[0];
#pragma unroll
    for (int p = 1; p < PASSES; ++p) mt = fmaxf(mt, sc[p]);
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m_r, mt);
    const float corr = exp2f(m_r - m_new);
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      sc[p] = exp2f(sc[p] - m_new);
      sum += sc[p];
    }
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_r = l_r * corr + sum;
    m_r = m_new;

    // every row's rescale, from the lanes holding it (warp-uniform: skipped
    // while a row's max stands)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float cg_ = GP == 1 ? corr : __shfl_sync(0xffffffffu, corr, g << (3 - KB));
      if (cg_ != 1.f) {
#pragma unroll
        for (int uu = 0; uu < C::UV; ++uu)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][uu][e] *= cg_;
      }
    }

    // acc[g][unit] += p[g][key] * v[key][unit], the same keys as the scores
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int j = warp * WK + p * KPP + kp;
      float pg[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g)
        pg[g] = GP == 1 ? sc[p] : __shfl_sync(0xffffffffu, sc[p], kp * LPK + (g << (3 - KB)));
#pragma unroll
      for (int uu = 0; uu < C::UV; ++uu) {
        float vv[8];
        load_unit<KV, QB>(Vt + j * C::RV, sub + LPK * uu, QB ? vs[j] : 1.f, vv);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][uu][e] = fmaf(pg[g], vv[e], acc[g][uu][e]);
      }
    }
  }

  // the 4 key groups of a warp share its rows' (m, l): sum their accumulators
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int uu = 0; uu < C::UV; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          acc[g][uu][e] += __shfl_xor_sync(0xffffffffu, acc[g][uu][e], off);

  cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states
  float* Ws = reinterpret_cast<float*>(smem) + warp * C::STATE;
  if (kp == 0 && (sub & ((8 >> KB) - 1)) == 0) {  // the first lane of row gl's
    Ws[gl] = m_r;
    Ws[GP + gl] = l_r;
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (kp == 0) {
#pragma unroll
      for (int uu = 0; uu < C::UV; ++uu)
#pragma unroll
        for (int e = 0; e < 8; ++e) Ws[2 * GP + g * DV + (sub + LPK * uu) * 8 + e] = acc[g][uu][e];
    }
  }
  __syncthreads();

  // the block's state: its warps merged with one log-sum-exp per head
  const float* W0 = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < GB * DV; e += NTHREADS) {
    const int g = e / DV, d = e - (e / DV) * DV;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, W0[w * C::STATE + g]);
    float x = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* Wsw = W0 + w * C::STATE;
      const float wt = exp2f(Wsw[g] - M);
      x = fmaf(wt, Wsw[2 * GP + g * DV + d], x);
      ll = fmaf(wt, Wsw[GP + g], ll);
    }
    Bs[2 * GP + g * DV + d] = x;
    if (d == 0) {
      Bs[g] = M;
      Bs[GP + g] = ll;
    }
  }
  __syncthreads();  // the block's state is in Bs

  // Several blocks share the (lane, KV head, row group): each publishes its
  // state, and the block that takes the last ticket merges them all.
  const int pair = (b * KVH + kvh) * a.rg + rgi;
  if (n_split > 1) {
    float* mine = a.part + ((long)pair * n_split + split) * C::STATE;
    for (int i = tid; i < C::STATE; i += NTHREADS) mine[i] = Bs[i];
    __syncthreads();
    // one thread takes the ticket with acquire-release semantics: the
    // barrier before it makes the block's writes part of its release, the
    // barrier after it gives the block what the earlier blocks released
    __shared__ int last;
    if (tid == 0) {
      int ticket;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                   : "=r"(ticket) : "l"(a.tickets + pair), "r"(1) : "memory");
      last = ticket == n_split - 1;
    }
    __syncthreads();
    if (!last) return;
  }

  // the merge: every block's (m, l, acc) loaded before any is used
  for (int e = tid; e < GB * DV; e += NTHREADS) {
    const int g = e / DV, d = e - (e / DV) * DV;
    float rm[MAX_SPLIT], rl[MAX_SPLIT], ra[MAX_SPLIT];
    if (n_split == 1) {
      rm[0] = Bs[g];
      rl[0] = Bs[GP + g];
      ra[0] = Bs[2 * GP + g * DV + d];
    } else {
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < n_split) {
          const float* R = a.part + ((long)pair * n_split + r) * C::STATE;  // __ldcg: from L2, not L1
          rm[r] = __ldcg(R + g);
          rl[r] = __ldcg(R + GP + g);
          ra[r] = __ldcg(R + 2 * GP + g * DV + d);
        }
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split) M = fmaxf(M, rm[r]);
    float x = 0.f, ll = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {
        const float wt = exp2f(rm[r] - M);
        x = fmaf(wt, ra[r], x);
        ll = fmaf(wt, rl[r], ll);
      }
    }
    const long h = (long)b * H + h0 + g;  // m and l are [B, KVH, G]: index b * H + head
    if (a.m) {
      static_cast<float*>(a.o)[h * DV + d] = x;
      if (d == 0) {
        a.m[h] = M == NEG_INF ? NEG_INF : M * LN2;  // natural units; an empty rank's exactly NEG_INF
        a.l[h] = ll;
      }
    } else {
      // an idle lane merges to (NEG_INF, 0, 0): 0 / 1 = 0, as the reference's
      // acc * corr / max(l, 1e-30) gives
      const float sink = a.sinks ? a.sinks[h0 + g] * LOG2E : NEG_INF;
      const float m_fin = fmaxf(M, sink);
      const float corr = exp2f(M - m_fin);
      const float l_fin = fmaxf(ll * corr + exp2f(sink - m_fin), 1e-30f);
      static_cast<T*>(a.o)[h * DV + d] = dnet::from_float<T>(x * corr / l_fin);
    }
  }
  if (n_split > 1 && tid == 0) a.tickets[pair] = 0;  // ready for the next call on this stream
}

// The tensor-core form (rows 16): bf16 q over a bf16 cache at
// DQK = DV = 128, never rotating.  Grid (n_split * rg, KVH, B) as above,
// rg = ceil(G / 16); 4 warps split every 64-key tile by keys (mma.cuh).
__global__ void __launch_bounds__(dnet::dmma::THREADS) flash_decode_mma_kernel(const Args a) {
  namespace M = dnet::dmma;
  using dnet::bf16;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + M::RING);
  float* Bs = reinterpret_cast<float*>(smem + M::RING + M::Q_BYTES);

  const int split = blockIdx.x / a.rg;
  const int rgi = blockIdx.x - split * a.rg;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = a.H, KVH = a.KVH, S = a.S;
  const int G = H / KVH;
  const int h0 = kvh * G + rgi * M::ROWS;
  const int GB = min(M::ROWS, G - rgi * M::ROWS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // q's 16 rows as 16-byte chunks, zero past the group, loaded before the
  // lengths' latency is paid
  constexpr int QCH = M::ROWS * M::D / 8;  // 16-byte chunks of q
  const bf16* qb = static_cast<const bf16*>(a.q) + ((long)b * H + h0) * M::D;
  uint4 qv[QCH / M::THREADS];
#pragma unroll
  for (int r = 0; r < QCH / M::THREADS; ++r) {
    const int i = tid + r * M::THREADS;
    qv[r] = i / (M::D / 8) < GB ? *reinterpret_cast<const uint4*>(qb + i * 8) : make_uint4(0, 0, 0, 0);
  }
  const int live = min(a.lengths[b], S);
  const int n_tiles = (live + M::BK - 1) / M::BK;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = min(split * per, n_tiles);
  const int t_end = min(t_begin + per, n_tiles);

  constexpr int RB = M::D * 2;  // bytes of a stored row
  const long row0 = (long)b * S * KVH + kvh;
  const uint8_t* kb = static_cast<const uint8_t*>(a.k) + row0 * RB;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) + row0 * RB;
  const long stride = (long)KVH * RB;

  // copy tile `tile` into ring stage `stage`, rows padded; rows past the
  // live slots are zero-filled without a read
  auto issue = [&](int tile, int stage) {
    uint8_t* st = smem + stage * M::STAGE_BYTES;
    const int k0 = tile * M::BK;
    const int rows = min(M::BK, live - k0);
    for (int i = tid; i < M::BK * (RB / 16); i += M::THREADS) {
      const int r = i / (RB / 16), c = i - r * (RB / 16);
      const bool ok = r < rows;
      const long off = ok ? (long)(k0 + r) * stride + c * 16 : 0;
      cp_async16(st + r * M::LD * 2 + c * 16, kb + off, ok);
      cp_async16(st + M::TILE_BYTES + r * M::LD * 2 + c * 16, vb + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < M::NSTAGE - 1; ++s) {
    if (t_begin + s < t_end) issue(t_begin + s, s);
    cp_commit();
  }
#pragma unroll
  for (int r = 0; r < QCH / M::THREADS; ++r) {
    const int i = tid + r * M::THREADS;
    *reinterpret_cast<uint4*>(Qs + (i / (M::D / 8)) * M::LD + (i % (M::D / 8)) * 8) = qv[r];
  }
  __syncthreads();

  M::Warp w;
  M::init(w, Qs, lane);
  const float sl2 = a.scale * LOG2E;
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_wait<M::NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();           // everyone's have, and stage (i - 1) % NSTAGE is free
    if (t + M::NSTAGE - 1 < t_end) issue(t + M::NSTAGE - 1, (i + M::NSTAGE - 1) % M::NSTAGE);
    cp_commit();
    const int n_valid = live - t * M::BK;
    if ((warp % M::KGROUPS) * 16 >= n_valid) continue;  // the warp's keys are all past the live slots
    const bf16* Kt = reinterpret_cast<const bf16*>(smem + (i % M::NSTAGE) * M::STAGE_BYTES);
    M::fold_tile(w, Kt, Kt + M::TILE_BYTES / 2, warp, lane, n_valid, sl2);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states
  M::block_state(w, reinterpret_cast<float*>(smem), Bs, warp, lane);

  // the merge, in float4 chunks: each row weighed once, then a
  // thread's chunks with their loads in flight
  const int pair = (b * KVH + kvh) * a.rg + rgi;
  const float* parts = a.part + (long)pair * a.n_split * M::STATE;
  if (a.n_split > 1 && !M::publish(Bs, a.part + ((long)pair * a.n_split + split) * M::STATE, a.tickets + pair,
                                   a.n_split))
    return;
  __shared__ float Wr[M::ROWS][MAX_SPLIT];
  __shared__ float Mr[M::ROWS], Lr[M::ROWS];
  M::merge_rows<MAX_SPLIT>(Bs, parts, a.n_split, GB, nullptr, Wr, Mr, Lr, nullptr);
  for (int e = tid; e < GB * (M::D / 4); e += M::THREADS) {
    const int g = e / (M::D / 4), d = (e % (M::D / 4)) * 4;
    const float4 x = M::merge_acc<MAX_SPLIT>(Bs, parts, a.n_split, Wr, g, d, make_float4(0.f, 0.f, 0.f, 0.f));
    const long h = (long)b * H + h0 + g;  // m and l are [B, KVH, G]: index b * H + head
    if (a.m) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.o) + h * M::D + d) = x;
      if (d == 0) {
        a.m[h] = Mr[g] == NEG_INF ? NEG_INF : Mr[g] * LN2;  // natural units; an empty rank's exactly NEG_INF
        a.l[h] = Lr[g];
      }
    } else {
      // the sink folded once; an idle lane merges to (NEG_INF, 0, 0): 0 / 1 = 0
      const float sink = a.sinks ? a.sinks[h0 + g] * LOG2E : NEG_INF;
      const float m_fin = fmaxf(Mr[g], sink);
      const float corr = exp2f(Mr[g] - m_fin);
      const float l_fin = fmaxf(Lr[g] * corr + exp2f(sink - m_fin), 1e-30f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * corr / l_fin, x.y * corr / l_fin);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * corr / l_fin, x.w * corr / l_fin);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned*>(&lo);
      packed.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(a.o) + h * M::D + d) = packed;
    }
  }
  if (a.n_split > 1 && tid == 0) a.tickets[pair] = 0;  // ready for the next call on this stream
}

// Launch `kernel` with `smem` bytes of dynamic shared memory over the
// call's grid (n_split * rg, KVH, B); its attribute is set once per device
// (`ready`: the caller's, a bit per device).
template <typename Kernel>
int launch_grid(Kernel kernel, std::atomic<unsigned long long>& ready, const Args& a, int smem, int threads) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  kernel<<<dim3(a.n_split * a.rg, a.KVH, a.B), threads, smem, a.stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch one CUDA-core instantiation (`query`: only return its dynamic
// shared memory).
template <typename T, typename KV, int QB, int DQK, int DV, int GP, bool ROT>
int launch_kernel(const Args& a, bool query) {
  constexpr int smem = Cfg<KV, QB, DQK, DV, GP>::BYTES;
  if (query) return smem;
  static std::atomic<unsigned long long> ready{0};
  return launch_grid(flash_decode_kernel<T, KV, QB, DQK, DV, GP, ROT>, ready, a, smem, NTHREADS);
}

// The tensor-core form: rows 16, bf16 q and cache at (128, 128), never
// rotating; -1 for any other call.
template <typename T, typename KV, int QB, int DQK, int DV>
int launch_mma(const Args& a, bool query) {
  if constexpr (sizeof(T) == 2 && sizeof(KV) == 2 && QB == 0 && DQK == dnet::dmma::D && DV == dnet::dmma::D) {
    if (a.rotating) return -1;
    constexpr int smem = dnet::dmma::RING + dnet::dmma::Q_BYTES + dnet::dmma::STATE * 4;
    if (query) return smem;
    static std::atomic<unsigned long long> ready{0};
    return launch_grid(flash_decode_mma_kernel, ready, a, smem, dnet::dmma::THREADS);
  }
  return -1;
}

// The query rows a block holds (GP = the launcher's rows: 1, 4 or 8 on the
// CUDA cores, 16 on the tensor cores) and the rotating ring, which is built
// only where DQK == DV (gpt_oss's sliding layers; MLA has none).  GP = 8 is
// not built at (128, 128): the launcher sends every group wider than 4 at
// head dim 128 to the tensor-core form or to row groups of 4.
template <typename T, typename KV, int QB, int DQK, int DV>
int launch_group(const Args& a, bool query) {
#define DNET_GROUP(GP_)                                                         \
  if (a.rows == GP_) {                                                          \
    if (!a.rotating) return launch_kernel<T, KV, QB, DQK, DV, GP_, false>(a, query); \
    if constexpr (DQK == DV) return launch_kernel<T, KV, QB, DQK, DV, GP_, true>(a, query); \
    return -1;                                                                  \
  }
  DNET_GROUP(1)
  DNET_GROUP(4)
  if constexpr (DQK != 128) {
    DNET_GROUP(8)
  }
#undef DNET_GROUP
  if (a.rows == dnet::dmma::ROWS) return launch_mma<T, KV, QB, DQK, DV>(a, query);
  return -1;
}

// The cache variant for one query dtype and (DQK, DV): kv_dtype is the
// cache's dtype code when qbits is 0 (q's own, or bf16 under an f32 q).
template <typename T, int DQK, int DV>
int launch_variant(int kv_dtype, int qbits, const Args& a, bool query) {
  if (qbits == 8) return launch_group<T, uint8_t, 8, DQK, DV>(a, query);
  if (qbits == 4) return launch_group<T, uint8_t, 4, DQK, DV>(a, query);
  if (qbits != 0) return -1;
  if (kv_dtype == dnet::DTYPE_BF16) return launch_group<T, __nv_bfloat16, 0, DQK, DV>(a, query);
  if constexpr (sizeof(T) == 4) {
    if (kv_dtype == dnet::DTYPE_F32) return launch_group<T, float, 0, DQK, DV>(a, query);
  }
  return -1;
}

template <typename T>
int launch_dims(int head_dim, int v_head_dim, int kv_dtype, int qbits, const Args& a, bool query) {
  if (head_dim == 64 && v_head_dim == 64) return launch_variant<T, 64, 64>(kv_dtype, qbits, a, query);
  if (head_dim == 128 && v_head_dim == 128) return launch_variant<T, 128, 128>(kv_dtype, qbits, a, query);
  if (head_dim == 192 && v_head_dim == 128) return launch_variant<T, 192, 128>(kv_dtype, qbits, a, query);
  return -1;
}

int launch_dtype(int dtype, int head_dim, int v_head_dim, int kv_dtype, int qbits, const Args& a, bool query) {
  if (!query && (a.n_split < 1 || a.n_split > MAX_SPLIT || (a.n_split > 1 && (!a.part || !a.tickets)))) return -1;
  if (dtype == dnet::DTYPE_BF16) return launch_dims<__nv_bfloat16>(head_dim, v_head_dim, kv_dtype, qbits, a, query);
  if (dtype == dnet::DTYPE_F32) return launch_dims<float>(head_dim, v_head_dim, kv_dtype, qbits, a, query);
  return -1;
}

// The row groups a KV head's G = H / KVH query heads split into, `rows`
// (1, 4, 8 or 16) a block; 0 for a grouping or rows this kernel does not
// take.
int row_groups(int H, int KVH, int rows) {
  if (H <= 0 || KVH <= 0 || H % KVH != 0 || (rows != 1 && rows != 4 && rows != 8 && rows != dnet::dmma::ROWS))
    return 0;
  return (H / KVH + rows - 1) / rows;
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/flash_decode.py).
// qbits 0: k/v in kv_dtype (q's dtype, or bf16 under an f32 q) and no
// scales; 8 / 4 (kv_dtype unused): int8 / packed-int4 codes with f32
// k_scale / v_scale.  head_dim is q's and k's, v_head_dim v's and the
// output's (unpacked widths).  lengths [B] int32 on the device.  rows (1, 4
// or 8 on the CUDA cores, 8 not at (128, 128); 16 selects the tensor-core
// form: bf16 q and cache at (128, 128), not rotating) query heads a block,
// so each KV head's G = H / KVH heads take RG = ceil(G / rows) row groups.  n_split (1..16) blocks share each (lane,
// KV head, row group); above 1 they need part, f32 scratch of
// B * KVH * RG * n_split * (2 + DV) * rows floats, and tickets,
// B * KVH * RG int32 that are 0 before the call and that it leaves 0 (one
// buffer a stream).  rotating 1
// (head_dim == v_head_dim only): S is the ring's W slots, lengths[b] = pos + 1
// may exceed S, and keys outside the last `window` positions are masked
// (0 < window <= S).  One kernel launch; returns its cudaError_t (0 =
// launched); -1 for a dtype, variant, head dims, grouping, split count or
// window this kernel was not built for.
extern "C" int dnet_flash_decode(int dtype, int kv_dtype, int qbits, int head_dim, int v_head_dim,
                                 const void* q, const void* k, const void* v, const float* k_scale,
                                 const float* v_scale, void* o, const float* sinks, const int* lengths,
                                 float* part, int* tickets, int B, int H, int KVH, int S, int n_split,
                                 int rows, float scale, int rotating, int window, void* stream) {
  if (rotating && (window <= 0 || window > S || head_dim != v_head_dim)) return -1;
  const int rg = row_groups(H, KVH, rows);
  if (!rg) return -1;
  const Args a{q, k, v, k_scale, v_scale, lengths, part, tickets, sinks, o, nullptr, nullptr, B, H, KVH, S,
               n_split, rows, rg, scale, rotating, window, static_cast<cudaStream_t>(stream)};
  return launch_dtype(dtype, head_dim, v_head_dim, kv_dtype, qbits, a, false);
}

// The LSE form (one sp rank's partials): q [B, 1, H, head_dim] in dtype; the
// cache as for dnet_flash_decode (qbits 0, 8 or 4; never rotating), the same
// (head_dim, v_head_dim) pairs and n_split.  lengths [B] int32 on the device:
// the rank's live slots per lane (0 = none); rows as for dnet_flash_decode.
// Writes o [B, 1, H, v_head_dim]
// f32 (unnormalised, relative to m), m and l [B, KVH, G] f32.  One kernel
// launch; returns its cudaError_t; -1 for what it was not built for.
extern "C" int dnet_flash_decode_lse(int dtype, int kv_dtype, int qbits, int head_dim, int v_head_dim,
                                     const void* q, const void* k, const void* v, const float* k_scale,
                                     const float* v_scale, float* o, float* m, float* l,
                                     const int* lengths, float* part, int* tickets, int B, int H, int KVH,
                                     int S, int n_split, int rows, float scale, void* stream) {
  const int rg = row_groups(H, KVH, rows);
  if (!m || !l || !rg) return -1;
  const Args a{q, k, v, k_scale, v_scale, lengths, part, tickets, nullptr, o, m, l, B, H, KVH, S, n_split,
               rows, rg, scale, 0, 0, static_cast<cudaStream_t>(stream)};
  return launch_dtype(dtype, head_dim, v_head_dim, kv_dtype, qbits, a, false);
}

// The dynamic shared memory (bytes) of the instantiation a call with these
// dtypes, cache form, head dims, grouping (H query over KVH KV heads) and
// rows a block launches; -1 for one this kernel was not built for.
extern "C" int dnet_flash_decode_smem(int dtype, int kv_dtype, int qbits, int head_dim, int v_head_dim,
                                      int H, int KVH, int rows, int rotating) {
  const int rg = row_groups(H, KVH, rows);
  if (!rg) return -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 1, H, KVH, 1, 1, rows, rg, 1.f, rotating, 1, nullptr};
  return launch_dtype(dtype, head_dim, v_head_dim, kv_dtype, qbits, a, true);
}
