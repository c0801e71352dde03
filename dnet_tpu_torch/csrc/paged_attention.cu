// Ragged paged attention for Hopper: single-token (T = 1) decode that reads
// each slot's KV rows in place from a shared block pool through its page
// table, in one launch of a split-K kernel whose last block to finish merges
// the splits and folds the step's new row.
//
// Replaces the TPU kernel `_paged_kernel` (dnet_tpu/ops/paged_attention.py:92,
// launched by `_paged_pallas`).  q/o [B, 1, H, D]; k_pool/v_pool
// [N_blocks, bt, KVH, D] (one layer) in q's dtype, or bf16 under an f32 q
// (the DNET_KV_BITS=16 pool of an f32 model); tables [B, nb] int32 page
// tables; pos [B] int32 live pool rows per slot; k_new/v_new [B, KVH, D] the
// current token's rows in q's dtype (attended unrounded, as the reference).
// Slot b's G = H / KVH query heads of each KV head (any G) attend pool rows
// [0, pos[b]) -- key `key` lives at row key % bt of physical block
// tables[b, key / bt] -- and then the new row, which the caller appends to
// the pool after the launch.  D is 64 or 128.
//
// What bounds it on an H100: as in flash_decode.cu, one query row per head
// does 2 * G multiply-adds per K/V element it reads, far below the card's
// balance point, so its bound is the live K/V it reads:
// 2 * sum_b(pos[b]) * KVH * D * sizeof(KV) per call (plus q, the new rows
// and the output).  At a batched decode's sizes (a few MB) that is a few
// microseconds, so what a call costs is its fixed latency plus, per tile,
// the block's work.  The design is the decode kernel's (flash_decode.cu's
// header says why each choice), over a page table:
//   - One launch per call, of nx blocks per KV head.  Every block reads the
//     slots' positions on the device and plans alike (`split_plan`): slot b
//     takes s_b = max(1, ceil(tiles_b / T)) <= 16 consecutive blocks, T a
//     number of tiles a block that fits every slot into nx, so ragged slots
//     are balanced by their work (batch_serve's lanes of 59 to 1,532 keys:
//     at most 4 tiles a block over 32 blocks a KV head, where one split
//     count for every slot would give the longest 6) and blocks past the
//     plan exit.
//     With more than one block a slot, each writes its state (m, l, acc per
//     query row) to a per-stream scratch buffer and takes a ticket for its
//     (slot, KV head); the block that takes the last one merges every
//     state, folds the new row, writes the outputs and returns the ticket to
//     0.  No combine kernel, no scratch allocated per call.  Where the fold
//     fits 128 registers a thread (G <= 4 at D = 64), two blocks share an SM,
//     and the host plans for two an SM.
//   - Each block stages its slice of the page table in shared memory once
//     (one coalesced load; entries past TBL_MAX are read from the table),
//     then copies K and V rows as the pool stores them (bf16, or f32 in the
//     f32 instantiation) with 16-byte cp.async, each row from its own table
//     entry: tbl[key / bt] * bt + key % bt (a shift and a mask for a
//     power-of-two bt).  Rows past the slot's live length are zero-filled
//     without a read, so table entries past its live blocks are never read
//     and a dead row, NaN or not, never meets a zero of P.  A ring of 2-4
//     stages (64-key tiles, 32 where a tile of f32 at D = 128 would pass
//     32 KB) keeps the next tiles' copies in flight while one is folded; one
//     __syncthreads a tile.  Values are widened to f32 as they are read into
//     registers.
//   - The whole block works at every G: each of 8 warps folds an eighth of
//     every tile, 8 lanes a key (16 at G = 8 and D = 128, so that a lane
//     holds 64 accumulators, not 128, and nothing spills), and a key's dot
//     reduces over its lanes as a reduce-scatter that leaves each lane one
//     query row's score, so the online softmax runs once per (key, row); at
//     G = 4 (Llama-3.2-1B's 32 / 8 heads) every lane scores and
//     accumulates.  Scores in log2 units (q carries log2(e)), P and PV in
//     f32 FMAs on the CUDA cores.  These CUDA-core forms use no mma.sync:
//     at G <= 4 a 16-row m tile would be at most a quarter used, and an f32
//     q keeps f32 FMAs (at G > 4 and D = 128 its 8-row blocks of 16 lanes a
//     key ran faster than row groups of 4 in a probe on the card, so they
//     stay).
//   - The tensor-core form (`paged_attention_mma_kernel`): a bf16 q over a
//     bf16 pool at D = 128 with G >= 5 (every G of the qwen families' wide
//     groups: Qwen3-235B-A22B's 16, Qwen3-30B-A3B's 8, Qwen2.5-7B's 7)
//     holds 16 query rows a block, row groups of 16 past that.  The
//     page-table staging, the per-row copies from each slot's own blocks
//     (rows past pos zero-filled without a read), the on-device split plan
//     and the new row folded once in the merge stay as above; the rows land
//     in the padded ring of csrc/mma.cuh and the decode kernel's tensor-core
//     tile fold (`dnet::dmma::fold_tile`, one device function for both
//     kernels) folds them, with its numerics (csrc/flash_decode.cu): exact
//     bf16 products summed in f32, P as hi + lo.  The new row's score is
//     q . k_new on the CUDA cores, products of bf16 values summed in f32
//     and scaled after, as the tiles' scores.  155,072 bytes of shared
//     memory: one block an SM, which the host's plan counts.
//   - The new row is one more state, folded once in the merge: every block
//     computes its score while its first copies are in flight, and the
//     merging block weighs v_new with it beside the splits' states.  It
//     always exists, so pos == 0 (nothing live, also every inactive lane)
//     gives exactly v_new and the denominator is never zero.
//   - Any group size through the same instantiations, as in
//     flash_decode.cu: a block holds the launcher's rows, GP = min(8, G
//     rounded up to 1, 4 or 8) on the CUDA cores or 16 on the tensor cores,
//     and a wider group splits over RG = ceil(G / GP) row groups, heads
//     kvh * G + r GP .. min(G, (r + 1) GP) - 1 (the last group's rows past
//     G are masked and never written).  Each (KV head, row group) has
//     its nx blocks, its own split plan, states and tickets; its blocks are
//     adjacent to the other row groups' of the same split (the row group is
//     the fastest part of the grid's x), so the second group's tiles come
//     from L2.
//   - Host cost: the shared-memory attribute is set once per instantiation
//     and device.

#include <atomic>

#include "mma.cuh"

namespace {

using dnet::NEG_INF;
using dnet::cp_async16;
using dnet::cp_commit;
using dnet::cp_wait;

constexpr int NTHREADS = 256;      // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_SPLIT = 16;      // blocks sharing one (slot, KV head)
constexpr int RING_BUDGET = 81920; // shared-memory bytes the ring aims at
constexpr int TBL_MAX = 512;       // page-table entries a block stages
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory layout of one instantiation (bytes): the ring of NSTAGE
// stages, each [K tile | V tile]; after the loop the ring holds the 8 warps'
// states (m [GP], l [GP], acc [GP][D]); then the pre-scaled q [GP][D], the
// block's merged state, the new row (its score per query row [GP], k_new
// [D], v_new [D], f32) and the staged page-table entries.
template <typename KV, int D, int GP>
struct Cfg {
  static constexpr int RB = D * (int)sizeof(KV);  // bytes of one K or V row
  static constexpr int BK = 64 * 2 * RB > 32768 ? 32 : 64;
  // lanes per key: 8, or 16 at G = 8 and D = 128, where 8 lanes would
  // hold 128 accumulators each and spill
  static constexpr int LPK = GP * D > 512 ? 16 : 8;
  static constexpr int LOG_LPK = LPK == 16 ? 4 : 3;
  static constexpr int KPP = 32 / LPK;    // keys a warp scores per pass
  static constexpr int WK = BK / NWARPS;  // keys a warp folds per tile
  static constexpr int PASSES = WK / KPP;
  static constexpr int KT = BK * RB;
  static constexpr int STAGE = 2 * KT;
  static constexpr int NSTAGE = 4 * STAGE <= RING_BUDGET ? 4 : 3 * STAGE <= RING_BUDGET ? 3 : 2;
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int U = D / (8 * LPK);  // 8-value units a lane holds of a row
  static constexpr bool QREG = GP * D / LPK <= 64;  // q's share of a lane in registers
  static constexpr int STATE = 2 * GP + GP * D;  // floats: m, l, acc
  static constexpr int MERGE = NWARPS * STATE * 4;
  static constexpr int Q_OFF = RING > MERGE ? RING : MERGE;
  static constexpr int B_OFF = Q_OFF + GP * D * 4;
  static constexpr int N_OFF = B_OFF + STATE * 4;
  static constexpr int T_OFF = N_OFF + (GP + 2 * D) * 4;
  static constexpr int BYTES = T_OFF + TBL_MAX * 4;
  // blocks an SM: two where the fold fits 128 registers a thread without
  // spilling (G <= 4 at D = 64, G = 1 at D = 128), else one
  static constexpr int MINB = GP * D <= 256 ? 2 : 1;
  static_assert(RB % 16 == 0, "rows are copied as 16-byte chunks");
  static_assert(U * 8 * LPK == D && PASSES * KPP == WK, "head dims are multiples of 8 x LPK");
};

// Values 8u .. 8u + 7 of a row in shared memory, as the pool stores it, to f32.
template <typename KV>
__device__ __forceinline__ void load_unit(const uint8_t* row, int u, float* out) {
  if constexpr (sizeof(KV) == 2) {
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
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* pos;
  const void* k_new;
  const void* v_new;
  void* o;
  float* part;   // [KVH, rg, nx, STATE] f32: the blocks' states (nx > B)
  int* tickets;  // [B * KVH * rg] int32, 0 between calls: blocks done per (slot, KV head, row group)
  int B, H, KVH, nb, bt, nx;
  int rows, rg;  // query rows a block holds (GP) and row groups a KV head (ceil(G / GP))
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The split plan, which every block of a KV head computes alike from pos
// (warp 0; the result in plan[]): each slot's live tiles split over
// s_b = max(1, ceil(tiles_b / T)) consecutive blocks of the nx, with
// T = ceil(total tiles / (nx - B)), which fits every slot into nx
// (sum_b s_b <= total / T + B), and no fewer than ceil(most / MAX_SPLIT)
// (at most MAX_SPLIT blocks a slot); with nx = B, one block a slot.  Writes
// this block's slot (-1: idle), split, the slot's split count and its first
// block.
template <int BK>
__device__ __forceinline__ void split_plan(const Args& a, int x, int lane, int* plan) {
  const int cap = a.nb * a.bt;
  const int rounds = (a.B + 31) / 32;
  int total = 0, most = 0;
  for (int i = 0; i < rounds; ++i) {
    const int b = lane + 32 * i;
    const int t = b < a.B ? (min(a.pos[b], cap) + BK - 1) / BK : 0;
    total += t;
    most = max(most, t);
  }
  total = warp_sum(total);
  most = warp_max(most);
  const int T = max(max(1, (most + MAX_SPLIT - 1) / MAX_SPLIT),
                    a.nx > a.B ? (total + a.nx - a.B - 1) / (a.nx - a.B) : most);
  if (lane == 0) plan[0] = -1;
  __syncwarp();
  int base = 0;
  for (int i = 0; i < rounds; ++i) {
    const int b = lane + 32 * i;
    const int sb = b < a.B ? max(1, ((min(a.pos[b], cap) + BK - 1) / BK + T - 1) / T) : 0;
    int incl = sb;  // inclusive scan over the warp's slots
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int first = base + incl - sb;
    if (sb && x >= first && x < first + sb) {
      plan[0] = b;
      plan[1] = x - first;
      plan[2] = sb;
      plan[3] = first;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// T: q's, the new rows' and the output's type; KV: the pool's (T, or bf16
// under an f32 T); GP: query rows a block holds (min(G, 8) rounded up).
// Grid (nx * rg, KVH): the nx blocks of a (KV head, row group) take the
// slots' splits in slot order (`split_plan`); blocks past them exit.
template <typename T, typename KV, int D, int GP>
__global__ void __launch_bounds__(NTHREADS, Cfg<KV, D, GP>::MINB) paged_attention_kernel(const Args a) {
  using C = Cfg<KV, D, GP>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* Bs = reinterpret_cast<float*>(smem + C::B_OFF);
  float* Ns = reinterpret_cast<float*>(smem + C::N_OFF);  // scores [GP], k_new [D], v_new [D]
  int* Ts = reinterpret_cast<int*>(smem + C::T_OFF);

  const int x = blockIdx.x / a.rg;
  const int rgi = blockIdx.x - x * a.rg;  // this block's row group
  const int kvh = blockIdx.y;
  const int H = a.H, KVH = a.KVH, bt = a.bt;
  const int G = H / KVH;
  const int h0 = kvh * G + rgi * GP;  // the row group's first query head
  const int GB = min(GP, G - rgi * GP);  // and its rows; rows GB..GP-1 are masked
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int LPK = C::LPK, KPP = C::KPP;
  constexpr int BK = C::BK, WK = C::WK, PASSES = C::PASSES;
  const int kp = lane / LPK;   // which of the pass's keys
  const int sub = lane % LPK;  // which units of the row

  // which slot and split this block takes
  __shared__ int plan[4];
  if (warp == 0) split_plan<BK>(a, x, lane, plan);
  __syncthreads();
  const int b = plan[0];
  if (b < 0) return;  // the slots' splits take fewer blocks than the grid has
  const int split = plan[1], n_split = plan[2], first = plan[3];

  // q's elements this thread stages and the new rows', then this block's
  // tiles: the slot's live tiles, split evenly over its n_split blocks
  constexpr int QPT = (GP * D + NTHREADS - 1) / NTHREADS;
  const T* qb = static_cast<const T*>(a.q) + ((long)b * H + h0) * D;
  const float q_scale = a.scale * LOG2E;  // scores in log2 units
  float qv[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = tid + r * NTHREADS;
    qv[r] = i < GB * D ? to_float(qb[i]) * q_scale : 0.f;
  }
  const long nrow = ((long)b * KVH + kvh) * D;
  const float kn = tid < D ? to_float(static_cast<const T*>(a.k_new)[nrow + tid]) : 0.f;
  const float vn = tid < D ? to_float(static_cast<const T*>(a.v_new)[nrow + tid]) : 0.f;

  const int* tbl = a.tables + (long)b * a.nb;
  const int live = min(a.pos[b], a.nb * bt);
  const int n_tiles = (live + BK - 1) / BK;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int t_begin = min(split * per, n_tiles);
  const int t_end = min(t_begin + per, n_tiles);

  // a power-of-two bt (the engine's) shifts and masks instead of dividing
  const bool pow2 = (bt & (bt - 1)) == 0;
  const int bsh = __ffs(bt) - 1;
  // the block's slice of the page table: entries [e0, e1), the first
  // TBL_MAX of them staged
  const int key0 = t_begin * BK;
  const int key1 = min(t_end * BK, live);
  const int e0 = pow2 ? key0 >> bsh : key0 / bt;
  const int e1 = key1 > key0 ? (pow2 ? (key1 - 1) >> bsh : (key1 - 1) / bt) + 1 : e0;
  for (int e = e0 + tid; e < min(e1, e0 + TBL_MAX); e += NTHREADS) Ts[e - e0] = tbl[e];

  // the row group's query heads are contiguous: q[b, 0, h0 .. h0+GB-1, :]
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = tid + r * NTHREADS;
    if (i < GP * D) Qs[i] = qv[r];
  }
  if (tid < D) {
    Ns[GP + tid] = kn;
    Ns[GP + D + tid] = vn;
  }
  __syncthreads();  // the table slice, q and the new row are staged

  const uint8_t* kpool = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.v_pool);
  // copy tile `tile` into ring stage `stage`, each row through its own table
  // entry; rows past the live length are zero-filled without a read
  auto copy_tile = [&](int tile, int stage) {
    uint8_t* st = smem + stage * C::STAGE;
    const int k0 = tile * BK;
    const int rows = min(BK, live - k0);
    constexpr int CH = C::RB / 16;
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool ok = r < rows;
      long off = 0;
      if (ok) {
        const int key = k0 + r;
        const int e = pow2 ? key >> bsh : key / bt;
        const long phys = e - e0 < TBL_MAX ? Ts[e - e0] : tbl[e];
        const int slot = pow2 ? key & (bt - 1) : key - e * bt;
        off = ((phys * bt + slot) * KVH + kvh) * C::RB + c * 16;
      }
      cp_async16(st + r * C::RB + c * 16, kpool + off, ok);
      cp_async16(st + C::KT + r * C::RB + c * 16, vpool + off, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < C::NSTAGE - 1; ++s) {
    if (t_begin + s < t_end) copy_tile(t_begin + s, s);
    cp_commit();
  }

  // the new row's score per query row, while the first copies fly
  for (int g = warp; g < GB; g += NWARPS) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(Qs[g * D + d], Ns[GP + d], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) Ns[g] = s;
  }

  float qr[C::QREG ? GP : 1][C::QREG ? C::U : 1][8];
  if constexpr (C::QREG) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int uu = 0; uu < C::U; ++uu) {
        const float* src = Qs + g * D + (sub + LPK * uu) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][uu][e] = src[e];
      }
  }

  // The dot of a key reduces over its LPK lanes as a reduce-scatter: KB =
  // log2(GP) halving steps leave each lane one query row's sum, row
  // gl = sub >> (LOG_LPK - KB), so the softmax runs once per (key, row);
  // the lanes of one row then share p and the rescale with the others by
  // shuffles.
  constexpr int KB = GP == 1 ? 0 : GP == 4 ? 2 : 3;
  constexpr int SH = C::LOG_LPK - KB;  // log2 of the lanes holding one row
  static_assert((1 << KB) == GP && (1 << C::LOG_LPK) == LPK, "GP is 1, 4 or 8 over 8 or 16 lanes a key");
  const int gl = sub >> SH;
  float m_r = NEG_INF, l_r = 0.f;  // row gl's running max (log2 units) and sum over the warp's keys
  float acc[GP][C::U][8];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int uu = 0; uu < C::U; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][uu][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_wait<C::NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();           // everyone's have, and stage (i - 1) % NSTAGE is free
    if (t + C::NSTAGE - 1 < t_end) copy_tile(t + C::NSTAGE - 1, (i + C::NSTAGE - 1) % C::NSTAGE);
    cp_commit();

    const int k0 = t * BK;
    if (k0 + warp * WK >= live) continue;  // this warp's keys are all past the live rows
    const uint8_t* Kt = smem + (i % C::NSTAGE) * C::STAGE;
    const uint8_t* Vt = Kt + C::KT;

    // scores of the warp's keys, key warp*WK + p*4 + kp: row gl's in sc[p]
    float sc[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int j = warp * WK + p * KPP + kp;
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.f;
#pragma unroll
      for (int uu = 0; uu < C::U; ++uu) {
        const int u = sub + LPK * uu;
        float kv[8];
        load_unit<KV>(Kt + j * C::RB, u, kv);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float qx = C::QREG ? qr[C::QREG ? g : 0][C::QREG ? uu : 0][e] : Qs[g * D + u * 8 + e];
            s[g] = fmaf(qx, kv[e], s[g]);
          }
      }
      // reduce-scatter: step `lvl` exchanges half the rows with lane ^ (LPK / 2 >> lvl)
#pragma unroll
      for (int lvl = 0; lvl < KB; ++lvl) {
        const int off = (LPK / 2) >> lvl;
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
      for (int off = (LPK / 2) >> KB; off > 0; off >>= 1) s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
      sc[p] = k0 + j < live ? s[0] : NEG_INF;
    }

    // online softmax of row gl over the warp's WK keys (its lanes across the
    // KPP key groups), then p into sc
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
      const float cg_ = GP == 1 ? corr : __shfl_sync(0xffffffffu, corr, g << SH);
      if (cg_ != 1.f) {
#pragma unroll
        for (int uu = 0; uu < C::U; ++uu)
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
        pg[g] = GP == 1 ? sc[p] : __shfl_sync(0xffffffffu, sc[p], kp * LPK + (g << SH));
#pragma unroll
      for (int uu = 0; uu < C::U; ++uu) {
        float vv[8];
        load_unit<KV>(Vt + j * C::RB, sub + LPK * uu, vv);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][uu][e] = fmaf(pg[g], vv[e], acc[g][uu][e]);
      }
    }
  }

  // the KPP key groups of a warp share its rows' (m, l): sum their accumulators
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int uu = 0; uu < C::U; ++uu)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          acc[g][uu][e] += __shfl_xor_sync(0xffffffffu, acc[g][uu][e], off);

  cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states
  float* Ws = reinterpret_cast<float*>(smem) + warp * C::STATE;
  if (kp == 0 && (sub & ((1 << SH) - 1)) == 0) {  // the first lane of row gl's
    Ws[gl] = m_r;
    Ws[GP + gl] = l_r;
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (kp == 0) {
#pragma unroll
      for (int uu = 0; uu < C::U; ++uu)
#pragma unroll
        for (int e = 0; e < 8; ++e) Ws[2 * GP + g * D + (sub + LPK * uu) * 8 + e] = acc[g][uu][e];
    }
  }
  __syncthreads();

  // the block's state: its warps merged with one log-sum-exp per head
  const float* W0 = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < GB * D; e += NTHREADS) {
    const int g = e / D, d = e - (e / D) * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, W0[w * C::STATE + g]);
    float x = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* Wsw = W0 + w * C::STATE;
      const float wt = exp2f(Wsw[g] - M);
      x = fmaf(wt, Wsw[2 * GP + g * D + d], x);
      ll = fmaf(wt, Wsw[GP + g], ll);
    }
    Bs[2 * GP + g * D + d] = x;
    if (d == 0) {
      Bs[g] = M;
      Bs[GP + g] = ll;
    }
  }
  __syncthreads();  // the block's state is in Bs

  // Several blocks share the (slot, KV head, row group): each publishes its
  // state, and the block that takes the last ticket merges them all.
  const int pair = (b * KVH + kvh) * a.rg + rgi;
  const long grp = (long)kvh * a.rg + rgi;  // the (KV head, row group)'s states in part
  if (n_split > 1) {
    float* mine = a.part + (grp * a.nx + x) * C::STATE;
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

  // the merge: every block's (m, l, acc) loaded before any is used, then
  // the new row (score Ns[g], value v_new) as one more state
  for (int e = tid; e < GB * D; e += NTHREADS) {
    const int g = e / D, d = e - (e / D) * D;
    float rm[MAX_SPLIT], rl[MAX_SPLIT], ra[MAX_SPLIT];
    if (n_split == 1) {
      rm[0] = Bs[g];
      rl[0] = Bs[GP + g];
      ra[0] = Bs[2 * GP + g * D + d];
    } else {
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < n_split) {
          const float* R = a.part + (grp * a.nx + first + r) * C::STATE;  // __ldcg: from L2, not L1
          rm[r] = __ldcg(R + g);
          rl[r] = __ldcg(R + GP + g);
          ra[r] = __ldcg(R + 2 * GP + g * D + d);
        }
      }
    }
    const float sn = Ns[g];
    float M = sn;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split) M = fmaxf(M, rm[r]);
    const float wn = exp2f(sn - M);
    float x = wn * Ns[GP + D + d], ll = wn;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {
        const float wt = exp2f(rm[r] - M);
        x = fmaf(wt, ra[r], x);
        ll = fmaf(wt, rl[r], ll);
      }
    }
    static_cast<T*>(a.o)[((long)b * H + h0 + g) * D + d] = dnet::from_float<T>(x / ll);
  }
  if (n_split > 1 && tid == 0) a.tickets[pair] = 0;  // ready for the next call on this stream
}

// The tensor-core form (rows 16): bf16 q over a bf16 pool at D = 128.
// Grid (nx * rg, KVH) as above, rg = ceil(G / 16); the pool's rows land in
// the padded ring and the decode form's tile fold (mma.cuh) folds them.
__global__ void __launch_bounds__(dnet::dmma::THREADS) paged_attention_mma_kernel(const Args a) {
  namespace M = dnet::dmma;
  using dnet::bf16;
  constexpr int D = M::D, BK = M::BK, RB = D * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + M::RING);
  float* Bs = reinterpret_cast<float*>(smem + M::RING + M::Q_BYTES);
  float* Ns = Bs + M::STATE;  // scores [ROWS], k_new [D], v_new [D]
  int* Ts = reinterpret_cast<int*>(Ns + M::ROWS + 2 * D);

  const int x = blockIdx.x / a.rg;
  const int rgi = blockIdx.x - x * a.rg;
  const int kvh = blockIdx.y;
  const int H = a.H, KVH = a.KVH, bt = a.bt;
  const int G = H / KVH;
  const int h0 = kvh * G + rgi * M::ROWS;
  const int GB = min(M::ROWS, G - rgi * M::ROWS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ int plan[4];
  if (warp == 0) split_plan<BK>(a, x, lane, plan);
  __syncthreads();
  const int b = plan[0];
  if (b < 0) return;
  const int split = plan[1], n_split = plan[2], first = plan[3];

  // q's 16 rows as 16-byte chunks (zero past the group) and the new rows
  constexpr int QCH = M::ROWS * D / 8;
  const bf16* qb = static_cast<const bf16*>(a.q) + ((long)b * H + h0) * D;
  uint4 qv[QCH / M::THREADS];
#pragma unroll
  for (int r = 0; r < QCH / M::THREADS; ++r) {
    const int i = tid + r * M::THREADS;
    qv[r] = i / (D / 8) < GB ? *reinterpret_cast<const uint4*>(qb + i * 8) : make_uint4(0, 0, 0, 0);
  }
  const long nrow = ((long)b * KVH + kvh) * D;
  const float kn = tid < D ? __bfloat162float(static_cast<const bf16*>(a.k_new)[nrow + tid]) : 0.f;
  const float vn = tid < D ? __bfloat162float(static_cast<const bf16*>(a.v_new)[nrow + tid]) : 0.f;

  const int* tbl = a.tables + (long)b * a.nb;
  const int live = min(a.pos[b], a.nb * bt);
  const int n_tiles = (live + BK - 1) / BK;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int t_begin = min(split * per, n_tiles);
  const int t_end = min(t_begin + per, n_tiles);
  const bool pow2 = (bt & (bt - 1)) == 0;
  const int bsh = __ffs(bt) - 1;
  const int key0 = t_begin * BK;
  const int key1 = min(t_end * BK, live);
  const int e0 = pow2 ? key0 >> bsh : key0 / bt;
  const int e1 = key1 > key0 ? (pow2 ? (key1 - 1) >> bsh : (key1 - 1) / bt) + 1 : e0;
  for (int e = e0 + tid; e < min(e1, e0 + TBL_MAX); e += M::THREADS) Ts[e - e0] = tbl[e];
#pragma unroll
  for (int r = 0; r < QCH / M::THREADS; ++r) {
    const int i = tid + r * M::THREADS;
    *reinterpret_cast<uint4*>(Qs + (i / (D / 8)) * M::LD + (i % (D / 8)) * 8) = qv[r];
  }
  if (tid < D) {
    Ns[M::ROWS + tid] = kn;
    Ns[M::ROWS + D + tid] = vn;
  }
  __syncthreads();  // the table slice, q and the new row are staged

  const uint8_t* kpool = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* vpool = static_cast<const uint8_t*>(a.v_pool);
  // copy tile `tile` into ring stage `stage`, rows padded, each row through
  // its own table entry; rows past the live length are zero-filled without
  // a read
  auto copy_tile = [&](int tile, int stage) {
    uint8_t* st = smem + stage * M::STAGE_BYTES;
    const int k0 = tile * BK;
    const int rows = min(BK, live - k0);
    for (int i = tid; i < BK * (RB / 16); i += M::THREADS) {
      const int r = i / (RB / 16), c = i - r * (RB / 16);
      const bool ok = r < rows;
      long off = 0;
      if (ok) {
        const int key = k0 + r;
        const int e = pow2 ? key >> bsh : key / bt;
        const long phys = e - e0 < TBL_MAX ? Ts[e - e0] : tbl[e];
        const int slot = pow2 ? key & (bt - 1) : key - e * bt;
        off = ((phys * bt + slot) * KVH + kvh) * RB + c * 16;
      }
      cp_async16(st + r * M::LD * 2 + c * 16, kpool + off, ok);
      cp_async16(st + M::TILE_BYTES + r * M::LD * 2 + c * 16, vpool + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < M::NSTAGE - 1; ++s) {
    if (t_begin + s < t_end) copy_tile(t_begin + s, s);
    cp_commit();
  }

  // the new row's score per query row (log2 units), while the copies fly:
  // exact bf16 products summed in f32, scaled after, as the tiles' scores
  const float sl2 = a.scale * LOG2E;
  for (int g = warp; g < GB; g += M::WARPS) {
    float sg = 0.f;
    for (int d = lane; d < D; d += 32) sg = fmaf(__bfloat162float(Qs[g * M::LD + d]), Ns[M::ROWS + d], sg);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, off);
    if (lane == 0) Ns[g] = sg * sl2;
  }

  M::Warp w;
  M::init(w, Qs, lane);
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    cp_wait<M::NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();           // everyone's have, and stage (i - 1) % NSTAGE is free
    if (t + M::NSTAGE - 1 < t_end) copy_tile(t + M::NSTAGE - 1, (i + M::NSTAGE - 1) % M::NSTAGE);
    cp_commit();
    const int n_valid = live - t * BK;
    if ((warp % M::KGROUPS) * 16 >= n_valid) continue;  // the warp's keys are all past the live rows
    const bf16* Kt = reinterpret_cast<const bf16*>(smem + (i % M::NSTAGE) * M::STAGE_BYTES);
    M::fold_tile(w, Kt, Kt + M::TILE_BYTES / 2, warp, lane, n_valid, sl2);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' states
  M::block_state(w, reinterpret_cast<float*>(smem), Bs, warp, lane);

  // the merge, in float4 chunks: each row weighed once (the new
  // row as one more state), then a thread's chunks with their loads in
  // flight
  const int pair = (b * KVH + kvh) * a.rg + rgi;
  const long grp = (long)kvh * a.rg + rgi;  // the (KV head, row group)'s states in part
  const float* parts = a.part + (grp * a.nx + first) * M::STATE;
  if (n_split > 1 && !M::publish(Bs, a.part + (grp * a.nx + x) * M::STATE, a.tickets + pair, n_split)) return;
  __shared__ float Wr[M::ROWS][MAX_SPLIT];
  __shared__ float Mr[M::ROWS], Lr[M::ROWS], Xr[M::ROWS];
  M::merge_rows<MAX_SPLIT>(Bs, parts, n_split, GB, Ns, Wr, Mr, Lr, Xr);
  for (int e = tid; e < GB * (D / 4); e += M::THREADS) {
    const int g = e / (D / 4), d = (e % (D / 4)) * 4;
    const float* vn4 = Ns + M::ROWS + D + d;
    const float4 xs = M::merge_acc<MAX_SPLIT>(
        Bs, parts, n_split, Wr, g, d, make_float4(Xr[g] * vn4[0], Xr[g] * vn4[1], Xr[g] * vn4[2], Xr[g] * vn4[3]));
    const float inv = 1.f / Lr[g];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(xs.x * inv, xs.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(xs.z * inv, xs.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<const unsigned*>(&lo);
    packed.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(a.o) + ((long)b * H + h0 + g) * D + d) = packed;
  }
  if (n_split > 1 && tid == 0) a.tickets[pair] = 0;  // ready for the next call on this stream
}

// what launch_kernel does: launch, or only return the instantiation's
// dynamic shared memory or its blocks an SM
constexpr int LAUNCH = 0, QUERY_SMEM = 1, QUERY_BLOCKS = 2;

// Launch `kernel` with `smem` bytes of dynamic shared memory over the
// call's grid (nx * rg, KVH); its attribute is set once per device
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
  kernel<<<dim3(a.nx * a.rg, a.KVH), threads, smem, a.stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch one CUDA-core instantiation, or answer a query about it.
template <typename T, typename KV, int D, int GP>
int launch_kernel(const Args& a, int query) {
  constexpr int smem = Cfg<KV, D, GP>::BYTES;
  if (query == QUERY_SMEM) return smem;
  if (query == QUERY_BLOCKS) return Cfg<KV, D, GP>::MINB;
  static std::atomic<unsigned long long> ready{0};
  return launch_grid(paged_attention_kernel<T, KV, D, GP>, ready, a, smem, NTHREADS);
}

// The tensor-core form (rows 16: bf16 q and pool at D = 128), or an
// answer about it (one block an SM); -1 for any other call.
template <typename T, typename KV, int D>
int launch_mma(const Args& a, int query) {
  if constexpr (sizeof(T) == 2 && sizeof(KV) == 2 && D == dnet::dmma::D) {
    namespace M = dnet::dmma;
    constexpr int smem = M::RING + M::Q_BYTES + (M::STATE + M::ROWS + 2 * D + TBL_MAX) * 4;
    if (query == QUERY_SMEM) return smem;
    if (query == QUERY_BLOCKS) return 1;
    static std::atomic<unsigned long long> ready{0};
    return launch_grid(paged_attention_mma_kernel, ready, a, smem, M::THREADS);
  }
  return -1;
}

// The query rows a block holds: the launcher's rows, 1, 4 or 8 on the CUDA
// cores, 16 on the tensor cores.
template <typename T, typename KV, int D>
int launch_group(const Args& a, int query) {
  if (a.rows == 1) return launch_kernel<T, KV, D, 1>(a, query);
  if (a.rows == 4) return launch_kernel<T, KV, D, 4>(a, query);
  if (a.rows == 8) return launch_kernel<T, KV, D, 8>(a, query);
  if (a.rows == dnet::dmma::ROWS) return launch_mma<T, KV, D>(a, query);
  return -1;
}

// The pool's dtype for one query dtype and head dim: q's own, or bf16 under
// an f32 q.
template <typename T, int D>
int launch_pool(int kv_dtype, const Args& a, int query) {
  if (kv_dtype == dnet::DTYPE_BF16) return launch_group<T, __nv_bfloat16, D>(a, query);
  if constexpr (sizeof(T) == 4) {
    if (kv_dtype == dnet::DTYPE_F32) return launch_group<T, float, D>(a, query);
  }
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

int launch_dtype(int dtype, int kv_dtype, int head_dim, const Args& a, int query) {
  if (a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.rg != row_groups(a.H, a.KVH, a.rows)) return -1;
  if (query == LAUNCH && (a.bt < 1 || a.nb < 1 || a.B < 1 || a.nx < a.B ||
                 a.nx > MAX_SPLIT * a.B || a.nx > 65535 || (a.nx > a.B && (!a.part || !a.tickets))))
    return -1;
  if (dtype == dnet::DTYPE_BF16) {
    if (head_dim == 64) return launch_pool<__nv_bfloat16, 64>(kv_dtype, a, query);
    if (head_dim == 128) return launch_pool<__nv_bfloat16, 128>(kv_dtype, a, query);
  } else if (dtype == dnet::DTYPE_F32) {
    if (head_dim == 64) return launch_pool<float, 64>(kv_dtype, a, query);
    if (head_dim == 128) return launch_pool<float, 128>(kv_dtype, a, query);
  }
  return -1;
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/paged_attention.py).
// kv_dtype is the pools' dtype code (q's, or bf16 under an f32 q).  B slots;
// rows (1, 4 or 8 on the CUDA cores; 16, the tensor-core form: bf16 q and
// pool at head dim 128) query heads a block, so each KV head's G = H / KVH
// query heads take RG = ceil(G / rows) row groups; nx (B..16 B) blocks per
// (KV head, row group), over which each slot's live tiles split
// (`split_plan`); above B they need part, f32 scratch of
// KVH * RG * nx * (2 + head_dim) * rows floats, and tickets, B * KVH * RG
// int32 that are 0 before the call and that it leaves 0 (one buffer a
// stream).  One kernel launch; returns its cudaError_t (0 = launched); -1
// for a dtype, head dim, grouping, rows, block size or block count this
// kernel was not built for.
extern "C" int dnet_paged_attention(int dtype, int kv_dtype, int head_dim, const void* q,
                                    const void* k_pool, const void* v_pool, const int* tables,
                                    const int* pos, const void* k_new, const void* v_new, void* o,
                                    float* part, int* tickets, int B, int H, int KVH, int nb, int bt,
                                    int nx, int rows, float scale, void* stream) {
  const int rg = row_groups(H, KVH, rows);
  if (!rg) return -1;
  const Args a{q, k_pool, v_pool, tables, pos, k_new, v_new, o, part, tickets, B, H, KVH, nb, bt,
               nx, rows, rg, scale, static_cast<cudaStream_t>(stream)};
  return launch_dtype(dtype, kv_dtype, head_dim, a, LAUNCH);
}

// The dynamic shared memory (bytes, what = 1) or the blocks an SM (what = 2)
// of the instantiation a call with these dtypes, head dim, grouping (H
// query over KVH KV heads) and rows a block launches; -1 for one this
// kernel was not built for.
extern "C" int dnet_paged_attention_query(int what, int dtype, int kv_dtype, int head_dim, int H, int KVH,
                                          int rows) {
  const int rg = row_groups(H, KVH, rows);
  if ((what != QUERY_SMEM && what != QUERY_BLOCKS) || !rg) return -1;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, H, KVH, 1, 1, 1, rows, rg, 1.f, nullptr};
  return launch_dtype(dtype, kv_dtype, head_dim, a, what);
}
