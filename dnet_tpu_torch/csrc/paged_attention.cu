// Ragged paged attention for Hopper: single-token (T = 1) decode that reads
// each slot's KV rows in place from a shared block pool through its page
// table, split-K across blocks (flash-decoding) plus a combine pass.
//
// Replaces the TPU kernel `_paged_kernel` (dnet_tpu/ops/paged_attention.py:92,
// launched by `_paged_pallas`).  q/o [B, 1, H, D]; k_pool/v_pool
// [N_blocks, bt, KVH, D] (one layer) in q's dtype, or bf16 under an f32 q
// (the DNET_KV_BITS=16 pool of an f32 model); tables [B, nb] int32 page
// tables; pos [B] int32 live pool rows per slot; k_new/v_new [B, KVH, D] the
// current token's rows in q's dtype (attended unrounded, as the reference).  Slot b's query heads attend pool rows [0, pos[b]) -- key
// `key` lives at row key % bt of physical block tables[b, key / bt] -- and then
// the new row, which the caller appends to the pool after the launch.
//
// What bounds it on an H100: as in flash_decode.cu, one query row per head does
// 2 * G multiply-adds per K/V element it reads, far below the card's balance
// point, so the kernel is bound by the bytes of live K/V it reads:
// 2 * sum_b(pos[b]) * KVH * D * sizeof(KV) per call.  What the design does
// about it:
//   - each slot's loop bound is its own live length pos[b].  The Pallas kernel
//     walks all nb table entries and clamps dead ones to the last live block so
//     the copy is elided (paged_attention.py:176-183); CUDA has no such thing,
//     so table entries past a slot's live blocks are never read at all.
//   - all G query heads of a KV group share each K/V tile read.
//   - the live range splits across blocks (grid = splits x KVH x slots), planned
//     on the host from an upper bound of the live lengths; splits past a slot's
//     live length write empty partials (m = -1e30, l = 0), and the last split
//     also takes any tiles past the plan, so a low bound costs balance, never
//     rows.
//   - a 64-key tile spans several physical blocks when bt < 64 (and part of
//     one when bt > 64): every staged row looks up its own block, so bt is a
//     runtime value, any divisor of the slot capacity.
//   - split 0 folds the new row into its accumulator exactly once per head; it
//     always exists, so pos == 0 (nothing live, also every inactive lane)
//     gives v_new and the combine never divides by zero.

#include "common.cuh"

namespace {

using dnet::NEG_INF;

constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr int GMAX = 8;        // query heads per KV head this kernel supports

template <int D>
struct Layout {
  static constexpr int LDK = BK + 4;  // Ks[d][j]
  static constexpr int LDV = D + 4;   // Vs[j][d]
  static constexpr int Q_OFF = 0;                     // Qs[g][d], pre-scaled
  static constexpr int K_OFF = Q_OFF + GMAX * D;
  static constexpr int V_OFF = K_OFF + D * LDK;
  static constexpr int S_OFF = V_OFF + BK * LDV;      // scores, then probabilities [g][j]
  static constexpr int M_OFF = S_OFF + GMAX * BK;     // running max per head
  static constexpr int L_OFF = M_OFF + GMAX;          // running denominator per head
  static constexpr int C_OFF = L_OFF + GMAX;          // this tile's rescale per head
  static constexpr int FLOATS = C_OFF + GMAX;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static constexpr int OUT_PER_THREAD = GMAX * D / NTHREADS;
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stage keys [k0, k0 + rows) of one slot's KV head `kvh` into shared memory as
// float, each row from its own physical block; rows >= rows are zero-filled
// and their table entries never read.
//   TRANSPOSE: dst[d * ld + r]   otherwise: dst[r * ld + d]
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void stage_paged_tile(float* dst, int ld, const T* __restrict__ pool,
                                                 const int* __restrict__ tbl, int bt, int KVH,
                                                 int kvh, int k0, int rows) {
  constexpr int VEC = dnet::Vec16<T>::N;
  constexpr int CHUNKS = D / VEC;
  for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += blockDim.x) {
    int r, c;
    if (TRANSPOSE) {
      r = idx % BK;
      c = idx / BK;
    } else {
      c = idx % CHUNKS;
      r = idx / CHUNKS;
    }
    float v[VEC];
    if (r < rows) {
      const int key = k0 + r;
      const long phys = tbl[key / bt];
      const long row = phys * bt + key % bt;
      dnet::load16<T>(pool + (row * KVH + kvh) * D + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (TRANSPOSE) {
        dst[(c * VEC + e) * ld + r] = v[e];
      } else {
        dst[r * ld + c * VEC + e] = v[e];
      }
    }
  }
}

// T: q's and the new rows' type; KV: the pool's (T, or bf16 under an f32 T)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool, const int* __restrict__ tables,
                   const int* __restrict__ pos, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, float* __restrict__ part_o,
                   float* __restrict__ part_ml, int H, int KVH, int nb, int bt,
                   int tiles_per_split, int n_split, float scale) {
  using L = Layout<D>;
  constexpr int NO = L::OUT_PER_THREAD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* ms = smem + L::M_OFF;
  float* ls = smem + L::L_OFF;
  float* cs = smem + L::C_OFF;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the G query heads of this KV group are contiguous: q[b, 0, kvh*G .. kvh*G+G-1, :]
  const T* qb = q + ((long)b * H + (long)kvh * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) Qs[i] = to_float<T>(qb[i]) * scale;
  if (tid < G) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  const int live = pos[b];
  const int* tbl = tables + (long)b * nb;
  const int n_tiles = (live + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = split == n_split - 1 ? n_tiles : min(t_begin + tiles_per_split, n_tiles);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // Qs/stats initialised; previous tile's Ks/Vs/Ss consumed
    const int rows = min(BK, live - k0);
    stage_paged_tile<KV, D, true>(Ks, L::LDK, k_pool, tbl, bt, KVH, kvh, k0, rows);
    stage_paged_tile<KV, D, false>(Vs, L::LDV, v_pool, tbl, bt, KVH, kvh, k0, rows);
    __syncthreads();

    // scores: thread -> key j, heads g = tid/64, tid/64 + 2, ...; rows at or
    // past the live length (the stale tail of the last live block) never score
    {
      const int j = tid & (BK - 1);
      const bool valid = j < rows;
      for (int g = tid / BK; g < G; g += NTHREADS / BK) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[d * L::LDK + j], s);
        Ss[g * BK + j] = valid ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax per head: one warp per head, two keys per lane
    for (int g = warp; g < G; g += NTHREADS / 32) {
      const float s0 = Ss[g * BK + lane];
      const float s1 = Ss[g * BK + lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mt);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[g * BK + lane] = p0;
      Ss[g * BK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ms[g] = m_new;
        ls[g] = ls[g] * corr + sum;
        cs[g] = corr;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_j p[g][j] * v[j][d]
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int oi = tid + i * NTHREADS;
      if (oi < G * D) {
        const int g = oi / D;
        const int d = oi % D;
        float a = acc[i] * cs[g];
#pragma unroll 16
        for (int j = 0; j < BK; ++j) a = fmaf(Ss[g * BK + j], Vs[j * L::LDV + d], a);
        acc[i] = a;
      }
    }
  }

  if (split == 0) {
    // the current token's row, not yet in the pool: one more key, folded once
    __syncthreads();  // Qs written; the last tile's Ss/cs consumed
    const T* kn = k_new + ((long)b * KVH + kvh) * D;
    for (int g = warp; g < G; g += NTHREADS / 32) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(Qs[g * D + d], to_float<T>(kn[d]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const float m_prev = ms[g];
        const float m_new = fmaxf(m_prev, s);
        const float corr = expf(m_prev - m_new);
        const float p = expf(s - m_new);
        ms[g] = m_new;
        ls[g] = ls[g] * corr + p;
        cs[g] = corr;
        Ss[g * BK] = p;
      }
    }
    __syncthreads();
    const T* vn = v_new + ((long)b * KVH + kvh) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int oi = tid + i * NTHREADS;
      if (oi < G * D) {
        const int g = oi / D;
        acc[i] = fmaf(Ss[g * BK], to_float<T>(vn[oi % D]), acc[i] * cs[g]);
      }
    }
  }

  const long base = ((long)b * KVH + kvh) * n_split + split;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int oi = tid + i * NTHREADS;
    if (oi < G * D) part_o[base * G * D + oi] = acc[i];
  }
  __syncthreads();
  if (tid < G) {
    part_ml[(base * G + tid) * 2] = ms[tid];
    part_ml[(base * G + tid) * 2 + 1] = ls[tid];
  }
}

// One block per (head, slot), one thread per output column: merge the
// splits' partials with one log-sum-exp.  Split 0 holds the new row, so the
// denominator is at least 1 at the running max.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ part_o,
                                     const float* __restrict__ part_ml, T* __restrict__ o,
                                     int H, int KVH, int D, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int G = H / KVH;
  const int kvh = h / G;
  const int g = h % G;
  const long base = ((long)b * KVH + kvh) * n_split;

  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[((base + s) * G + g) * 2]);
  float acc = 0.f, l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(part_ml[((base + s) * G + g) * 2] - M);
    acc = fmaf(w, part_o[(base + s) * G * D + g * D + d], acc);
    l = fmaf(w, part_ml[((base + s) * G + g) * 2 + 1], l);
  }
  o[((long)b * H + h) * D + d] = dnet::from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, typename KV, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* pos, const void* k_new, const void* v_new, void* o, float* part_o,
           float* part_ml, int B, int H, int KVH, int nb, int bt, int tiles_per_split,
           int n_split, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so on every launch: the call is cheap and does not synchronise)
  cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T, KV, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_split_kernel<T, KV, D><<<dim3(n_split, KVH, B), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool), static_cast<const KV*>(v_pool),
      tables, pos, static_cast<const T*>(k_new), static_cast<const T*>(v_new), part_o, part_ml,
      H, KVH, nb, bt, tiles_per_split, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T><<<dim3(H, B), D, 0, stream>>>(part_o, part_ml, static_cast<T*>(o), H,
                                                        KVH, D, n_split);
  return (int)cudaGetLastError();
}

// The pool's dtype for one query dtype and head dim: q's own, or bf16 under
// an f32 q.
template <typename T, int D>
int launch_pool(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
                const int* tables, const int* pos, const void* k_new, const void* v_new, void* o,
                float* part_o, float* part_ml, int B, int H, int KVH, int nb, int bt,
                int tiles_per_split, int n_split, float scale, cudaStream_t st) {
  if (kv_dtype == dnet::DTYPE_BF16)
    return launch<T, __nv_bfloat16, D>(q, k_pool, v_pool, tables, pos, k_new, v_new, o, part_o,
                                       part_ml, B, H, KVH, nb, bt, tiles_per_split, n_split,
                                       scale, st);
  if constexpr (sizeof(T) == 4) {
    if (kv_dtype == dnet::DTYPE_F32)
      return launch<T, float, D>(q, k_pool, v_pool, tables, pos, k_new, v_new, o, part_o,
                                 part_ml, B, H, KVH, nb, bt, tiles_per_split, n_split, scale, st);
  }
  return -1;
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/paged_attention.py).
// kv_dtype is the pools' dtype code (q's, or bf16 under an f32 q).  part_o [B, KVH, n_split, G, D] and part_ml [B, KVH, n_split, G, 2] are f32
// scratch the caller allocates.  Returns cudaGetLastError() after the
// launches (0 = launched); -1 for a dtype, head dim, grouping or block size
// this kernel was not built for.
extern "C" int dnet_paged_attention(int dtype, int kv_dtype, int head_dim, const void* q,
                                    const void* k_pool, const void* v_pool, const int* tables,
                                    const int* pos, const void* k_new, const void* v_new, void* o,
                                    float* part_o, float* part_ml, int B, int H, int KVH,
                                    int nb, int bt, int tiles_per_split, int n_split,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH != 0 || H / KVH > GMAX || bt < 1 || n_split < 1) return -1;
  if (dtype == dnet::DTYPE_BF16) {
    if (head_dim == 64)
      return launch_pool<__nv_bfloat16, 64>(kv_dtype, q, k_pool, v_pool, tables, pos, k_new,
                                            v_new, o, part_o, part_ml, B, H, KVH, nb, bt,
                                            tiles_per_split, n_split, scale, st);
    if (head_dim == 128)
      return launch_pool<__nv_bfloat16, 128>(kv_dtype, q, k_pool, v_pool, tables, pos, k_new,
                                             v_new, o, part_o, part_ml, B, H, KVH, nb, bt,
                                             tiles_per_split, n_split, scale, st);
  } else if (dtype == dnet::DTYPE_F32) {
    if (head_dim == 64)
      return launch_pool<float, 64>(kv_dtype, q, k_pool, v_pool, tables, pos, k_new, v_new, o,
                                    part_o, part_ml, B, H, KVH, nb, bt, tiles_per_split, n_split,
                                    scale, st);
    if (head_dim == 128)
      return launch_pool<float, 128>(kv_dtype, q, k_pool, v_pool, tables, pos, k_new, v_new, o,
                                     part_o, part_ml, B, H, KVH, nb, bt, tiles_per_split,
                                     n_split, scale, st);
  }
  return -1;
}
