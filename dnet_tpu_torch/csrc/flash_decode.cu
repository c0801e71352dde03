// Single-token (T = 1) decode attention over the dense preallocated KV cache,
// for Hopper: split-K flash-decoding plus a small combine pass.
//
// Replaces the TPU kernel `_decode_kernel` (dnet_tpu/ops/flash_decode.py:50,
// launched by `_decode_pallas`) in its plain variant, its `qbits` 8/4
// variant and its `rotating` variant (the gpt_oss sliding-window ring
// buffer, flash_decode.py:100-123 and :184-186), each over the same cache
// forms (with_lse = False, offset = 0; the with_lse form is below).  q
// [B, 1, H, DQK], o [B, 1, H, DV]; k [B, S, KVH, DQK] and v [B, S, KVH, DV]
// in q's dtype (or bf16 under an f32 q: the DNET_KV_BITS=16 cache of an f32
// model), or quantized: int8 codes of those widths, or int4 nibbles packed
// in pairs along the head dim (low nibble = even index, offset binary) as
// uint8 [.., DQK/2] and [.., DV/2], each with k_scale/v_scale
// [B, S, KVH, 1] f32.  DV differs from DQK for MLA (deepseek_v2: DQK 192,
// DV 128, KVH = H, dnet_tpu/ops/flash_decode.py:175): scores run over DQK,
// the V tile, accumulator, partials and combine over DV.  Under int4 a
// 192-wide K row packs 96 bytes (6 vectors of 32 nibbles), a 128-wide V row
// 64 bytes (4 vectors).  Lane b's query attends cache slots
// [0, lengths[b]) (lengths = position + 1; 0 = an idle lane, whose output is
// zeros); sinks [H] fold into the denominator.
//
// Rotating (ROT): the cache is a ring of S = W slots written before the
// call, lane b's query sits at pos = lengths[b] - 1 (so lengths may exceed
// S), its live slots are [0, min(lengths[b], S)), and slot s holds absolute
// position k_abs = pos - ((pos - s) mod S); a key is attended when
// k_abs >= 0 and k_abs > pos - window (window <= S; the served case is
// window == S).  Everything else is the plain variant's.
//
// What bounds it on an H100: one query row per head does 2 * G multiply-adds
// per K/V element it reads (G = H / KVH query heads per KV head), far below the
// card's balance point, so the kernel is bound by the bytes of live cache it
// reads: lengths[b] * KVH * ((DQK + DV) * sizeof(KV), or DQK + DV or
// (DQK + DV)/2 code bytes plus two 4-byte scales) per lane.  With G = 1
// (MLA's H KV heads) a block uses one of its GMAX query-head rows: slow
// per byte, correct.  What the design does about it:
//   - it reads only the live slots: each lane's loop is bounded by its own
//     length.  This replaces the Pallas trick of clamping dead tiles' block
//     indices so their copies are elided (flash_decode.py:14-17,181-191),
//     which has no CUDA counterpart; a literal port would read all S slots.
//   - a quantized cache is read as codes (16-byte vectors: 16 int8 codes or
//     32 packed nibbles) plus one scale per row, and dequantized on the way
//     into shared memory, so device memory carries the quantized bytes
//     only; the on-chip fold is the plain variant's.
//   - all G query heads of a KV group share each K/V tile read.
//   - the live range is split across blocks (grid = splits x KVH x B), so a
//     batch of one with KVH = 8 still puts enough blocks on the 132 SMs; each
//     block writes unnormalised (acc, m, l) partials and the combine kernel
//     merges them with one log-sum-exp per head.  The split plan covers the
//     longest lane; a split past a lane's length writes empty partials.
//
// LSE (sequence-parallel) form, `dnet_flash_decode_lse`: replaces the same
// TPU kernel with with_lse=True (flash_decode.py:141-150, outputs :213-223),
// which `sp_flash_decode_attend` runs on each sp rank's shard of the cache,
// in every cache form but the rotating one (bf16 / f32 values, int8 / int4
// codes) and at every (DQK, DV) pair above, MLA's (192, 128) included.  The
// reference dequantizes a quantized shard to f32 first (`read_kv`, then the
// kernel); this form reads the codes and dequantizes tile by tile, as the
// non-sp quantized decode does: both compute code * scale in f32.  The split
// kernel is the one above; a second combine kernel (one thread per V column)
// merges the splits with one log-sum-exp and writes the rank's UNNORMALISED
// partials: acc [B, 1, H, DV] f32 relative to the merged max, and m, l
// [B, KVH, G] f32.  It neither folds a sink nor divides by l: the cross-rank
// combine does both, once (ops/ring_attention.py).  The rank's shard offset
// is carried by the lengths the caller passes (clamp(pos + 1 - offset, 0, S)
// per lane), so a rank whose shard lies wholly past pos has length 0: its
// one planned split folds no tile and the combine writes m = NEG_INF, l = 0,
// acc = 0, which the cross-rank weight exp(m - m_global) then zeroes.

#include "common.cuh"

namespace {

using dnet::NEG_INF;

constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr int GMAX = 8;        // query heads per KV head this kernel supports

template <int DQK, int DV>
struct Layout {
  static constexpr int LDK = BK + 4;  // Ks[d][j]
  static constexpr int LDV = DV + 4;  // Vs[j][d]
  static constexpr int Q_OFF = 0;                     // Qs[g][d], pre-scaled
  static constexpr int K_OFF = Q_OFF + GMAX * DQK;
  static constexpr int V_OFF = K_OFF + DQK * LDK;
  static constexpr int S_OFF = V_OFF + BK * LDV;      // scores, then probabilities [g][j]
  static constexpr int M_OFF = S_OFF + GMAX * BK;     // running max per head
  static constexpr int L_OFF = M_OFF + GMAX;          // running denominator per head
  static constexpr int C_OFF = L_OFF + GMAX;          // this tile's rescale per head
  static constexpr int FLOATS = C_OFF + GMAX;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static constexpr int OUT_PER_THREAD = GMAX * DV / NTHREADS;
};

// Stage rows [0, rows) of a quantized [BK, D] tile (row stride `stride`
// bytes; one f32 scale per row at scale[r * scale_stride]) into shared
// memory as float code * scale; rows >= rows are zero-filled.  QB 8: int8
// codes, 16 per 16-byte vector; QB 4: offset-binary nibbles, low nibble first,
// 32 per vector.  Layouts as dnet::stage_tile's.
template <int QB, int D, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile_q(float* dst, int ld, const uint8_t* src, long stride,
                                             const float* scale, long scale_stride, int rows) {
  constexpr int VEC = QB == 8 ? 16 : 32;  // values per 16-byte vector
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
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long)r * stride + c * 16);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      const float s = scale[(long)r * scale_stride];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if constexpr (QB == 8) {
          v[e] = (float)(int8_t)b[e] * s;
        } else {
          v[2 * e] = (float)((int)(b[e] & 0xF) - 8) * s;
          v[2 * e + 1] = (float)((int)(b[e] >> 4) - 8) * s;
        }
      }
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

// KV: the cache's element type (T, bf16 under an f32 T, or uint8_t holding
// int8 / packed int4 codes); QB: 0, 8 or 4; ROT: the rotating ring.
template <typename T, typename KV, int QB, int DQK, int DV, bool ROT>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                          const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                          const int* __restrict__ lengths, float* __restrict__ part_o,
                          float* __restrict__ part_ml, int H, int KVH, int S, int tiles_per_split,
                          int n_split, float scale, int window) {
  using L = Layout<DQK, DV>;
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
  const T* qb = q + ((long)b * H + (long)kvh * G) * DQK;
  for (int i = tid; i < G * DQK; i += NTHREADS) {
    float x;
    if constexpr (sizeof(T) == 4) {
      x = (float)qb[i];
    } else {
      x = __bfloat162float(qb[i]);
    }
    Qs[i] = x * scale;
  }
  if (tid < G) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  constexpr int DSK = QB == 4 ? DQK / 2 : DQK;  // stored elements per K row
  constexpr int DSV = QB == 4 ? DV / 2 : DV;    // and per V row
  const long k_stride = (long)KVH * DSK;
  const long v_stride = (long)KVH * DSV;
  const KV* kb = k + ((long)b * S * KVH + kvh) * DSK;
  const KV* vb = v + ((long)b * S * KVH + kvh) * DSV;
  const long sc_base = (long)b * S * KVH + kvh;  // scales: one per (slot, KV head)
  const int live = min(lengths[b], S);
  const int pos = lengths[b] - 1;  // the query's absolute position (ROT)
  const int n_tiles = (live + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // Qs/stats initialised; previous tile's Ks/Vs/Ss consumed
    const int rows = min(BK, S - k0);
    if constexpr (QB == 0) {
      dnet::stage_tile<KV, DQK, BK, true>(Ks, L::LDK, kb + (long)k0 * k_stride, k_stride, rows, 1.f);
      dnet::stage_tile<KV, DV, BK, false>(Vs, L::LDV, vb + (long)k0 * v_stride, v_stride, rows, 1.f);
    } else {
      stage_tile_q<QB, DQK, true>(Ks, L::LDK, kb + (long)k0 * k_stride, k_stride,
                                  k_scale + sc_base + (long)k0 * KVH, KVH, rows);
      stage_tile_q<QB, DV, false>(Vs, L::LDV, vb + (long)k0 * v_stride, v_stride,
                                  v_scale + sc_base + (long)k0 * KVH, KVH, rows);
    }
    __syncthreads();

    // scores: thread -> key j, heads g = tid/64, tid/64 + 2, ...
    {
      const int j = tid & (BK - 1);
      bool valid = k0 + j < live;
      if constexpr (ROT) {
        // the slot holds the most recent position <= pos congruent to it mod S
        int back = (pos - (k0 + j)) % S;
        if (back < 0) back += S;
        const int k_abs = pos - back;
        valid = valid && k_abs >= 0 && k_abs > pos - window;
      }
      for (int g = tid / BK; g < G; g += NTHREADS / BK) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < DQK; ++d) s = fmaf(Qs[g * DQK + d], Ks[d * L::LDK + j], s);
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
      if (oi < G * DV) {
        const int g = oi / DV;
        const int d = oi % DV;
        float a = acc[i] * cs[g];
#pragma unroll 16
        for (int j = 0; j < BK; ++j) a = fmaf(Ss[g * BK + j], Vs[j * L::LDV + d], a);
        acc[i] = a;
      }
    }
  }

  const long base = ((long)b * KVH + kvh) * n_split + split;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int oi = tid + i * NTHREADS;
    if (oi < G * DV) part_o[base * G * DV + oi] = acc[i];
  }
  __syncthreads();
  if (tid < G) {
    part_ml[(base * G + tid) * 2] = ms[tid];
    part_ml[(base * G + tid) * 2 + 1] = ls[tid];
  }
}

// One block per (head, batch), one thread per output column of V's width
// Dv (the partials and the output are V-wide, never Q/K-wide): merge the
// splits' partials with one log-sum-exp and fold the sink exactly once.  An
// idle lane's partials are all empty (m = NEG_INF, l = 0, acc = 0): its
// output is 0, as the reference's acc * corr / max(l, 1e-30) gives.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            const float* __restrict__ sinks, T* __restrict__ o,
                                            int H, int KVH, int Dv, int n_split) {
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
    acc = fmaf(w, part_o[(base + s) * G * Dv + g * Dv + d], acc);
    l = fmaf(w, part_ml[((base + s) * G + g) * 2 + 1], l);
  }
  const float sink = sinks ? sinks[h] : NEG_INF;
  const float m_fin = fmaxf(M, sink);
  const float corr = expf(M - m_fin);
  const float l_fin = fmaxf(l * corr + expf(sink - m_fin), 1e-30f);
  o[((long)b * H + h) * Dv + d] = dnet::from_float<T>(acc * corr / l_fin);
}

// LSE form: one block per (head, batch), one thread per output column of
// V's width Dv (MLA: 128, while q and k are 192 wide).
// The splits' partials merge as in flash_decode_combine_kernel, but the
// rank's partials are written as they are: acc relative to the merged max
// M, and (M, l) per query head.  Empty partials (m = NEG_INF on every
// split) merge to M = NEG_INF, weights exp(0) = 1 on zero acc and l, so an
// empty rank writes (0, NEG_INF, 0).
__global__ void flash_decode_combine_lse_kernel(const float* __restrict__ part_o,
                                                const float* __restrict__ part_ml,
                                                float* __restrict__ o, float* __restrict__ m_out,
                                                float* __restrict__ l_out, int H, int KVH, int Dv,
                                                int n_split) {
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
    acc = fmaf(w, part_o[(base + s) * G * Dv + g * Dv + d], acc);
    l = fmaf(w, part_ml[((base + s) * G + g) * 2 + 1], l);
  }
  o[((long)b * H + h) * Dv + d] = acc;
  if (d == 0) {
    // m and l are [B, KVH, G]: index b * H + h, since h = kvh * G + g
    m_out[(long)b * H + h] = M;
    l_out[(long)b * H + h] = l;
  }
}

template <typename T, typename KV, int QB, int DQK, int DV, bool ROT>
int launch_split(const void* q, const void* k, const void* v, const float* k_scale,
                 const float* v_scale, float* part_o, float* part_ml, const int* lengths, int B,
                 int H, int KVH, int S, int tiles_per_split, int n_split, float scale, int window,
                 cudaStream_t stream) {
  const size_t smem = Layout<DQK, DV>::BYTES;
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so on every launch: the call is cheap and does not synchronise)
  cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<T, KV, QB, DQK, DV, ROT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_split_kernel<T, KV, QB, DQK, DV, ROT>
      <<<dim3(n_split, KVH, B), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, lengths, part_o, part_ml, H, KVH, S, tiles_per_split, n_split, scale, window);
  return (int)cudaGetLastError();
}

// The rotating ring is built only where DQK == DV (gpt_oss's sliding
// layers); MLA has no sliding layers.  m_out / l_out non-null selects the
// LSE form: the splits merge into the rank's unnormalised (acc, m, l), with
// o the f32 acc, and no sink folds.
template <typename T, typename KV, int QB, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const float* k_scale, const float* v_scale,
           void* o, float* m_out, float* l_out, const float* sinks, float* part_o, float* part_ml,
           const int* lengths, int B, int H, int KVH, int S, int tiles_per_split, int n_split,
           float scale, int rotating, int window, cudaStream_t stream) {
  int rc = -1;
  if (!rotating) {
    rc = launch_split<T, KV, QB, DQK, DV, false>(q, k, v, k_scale, v_scale, part_o, part_ml,
                                                 lengths, B, H, KVH, S, tiles_per_split, n_split,
                                                 scale, window, stream);
  } else if constexpr (DQK == DV) {
    rc = launch_split<T, KV, QB, DQK, DV, true>(q, k, v, k_scale, v_scale, part_o, part_ml,
                                                lengths, B, H, KVH, S, tiles_per_split, n_split,
                                                scale, window, stream);
  }
  if (rc != 0) return rc;
  if (m_out) {
    flash_decode_combine_lse_kernel<<<dim3(H, B), DV, 0, stream>>>(
        part_o, part_ml, static_cast<float*>(o), m_out, l_out, H, KVH, DV, n_split);
  } else {
    flash_decode_combine_kernel<T><<<dim3(H, B), DV, 0, stream>>>(part_o, part_ml, sinks,
                                                                  static_cast<T*>(o), H, KVH, DV,
                                                                  n_split);
  }
  return (int)cudaGetLastError();
}

// The cache variant for one query dtype and (DQK, DV): kv_dtype is the
// cache's dtype code when qbits is 0 (q's own, or bf16 under an f32 q).
template <typename T, int DQK, int DV>
int launch_variant(int kv_dtype, int qbits, const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale, void* o, float* m_out, float* l_out,
                   const float* sinks, float* part_o, float* part_ml, const int* lengths, int B,
                   int H, int KVH, int S, int tiles_per_split, int n_split, float scale,
                   int rotating, int window, cudaStream_t st) {
#define DNET_LAUNCH(KV_T, QB_)                                                                   \
  launch<T, KV_T, QB_, DQK, DV>(q, k, v, k_scale, v_scale, o, m_out, l_out, sinks, part_o,       \
                                part_ml, lengths, B, H, KVH, S, tiles_per_split, n_split, scale, \
                                rotating, window, st)
  if (qbits == 8) return DNET_LAUNCH(uint8_t, 8);
  if (qbits == 4) return DNET_LAUNCH(uint8_t, 4);
  if (qbits != 0) return -1;
  if (kv_dtype == dnet::DTYPE_BF16) return DNET_LAUNCH(__nv_bfloat16, 0);
  if constexpr (sizeof(T) == 4) {
    if (kv_dtype == dnet::DTYPE_F32) return DNET_LAUNCH(float, 0);
  }
#undef DNET_LAUNCH
  return -1;
}

template <typename T>
int launch_dims(int head_dim, int v_head_dim, int kv_dtype, int qbits, const void* q,
                const void* k, const void* v, const float* k_scale, const float* v_scale, void* o,
                float* m_out, float* l_out, const float* sinks, float* part_o, float* part_ml,
                const int* lengths, int B, int H, int KVH, int S, int tiles_per_split, int n_split,
                float scale, int rotating, int window, cudaStream_t st) {
#define DNET_DIMS(DQK_, DV_)                                                                     \
  launch_variant<T, DQK_, DV_>(kv_dtype, qbits, q, k, v, k_scale, v_scale, o, m_out, l_out,      \
                               sinks, part_o, part_ml, lengths, B, H, KVH, S, tiles_per_split,   \
                               n_split, scale, rotating, window, st)
  if (head_dim == 64 && v_head_dim == 64) return DNET_DIMS(64, 64);
  if (head_dim == 128 && v_head_dim == 128) return DNET_DIMS(128, 128);
  if (head_dim == 192 && v_head_dim == 128) return DNET_DIMS(192, 128);
#undef DNET_DIMS
  return -1;
}

template <typename... Args>
int launch_dtype(int dtype, Args... args) {
  if (dtype == dnet::DTYPE_BF16) return launch_dims<__nv_bfloat16>(args...);
  if (dtype == dnet::DTYPE_F32) return launch_dims<float>(args...);
  return -1;
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/flash_decode.py).
// qbits 0: k/v in kv_dtype (q's dtype, or bf16 under an f32 q) and no
// scales; 8 / 4 (kv_dtype unused): int8 / packed-int4 codes
// with f32 k_scale/v_scale.  head_dim is q's and k's, v_head_dim v's and
// the output's (unpacked widths).  lengths [B] int32 on the device.  part_o
// [B, KVH, n_split, G, v_head_dim] and part_ml [B, KVH, n_split, G, 2] are
// f32 scratch the caller allocates, n_split * tiles_per_split covering the
// longest lane.  rotating 1 (head_dim == v_head_dim only): S is the ring's
// W slots, lengths[b] = pos + 1 may exceed S, and keys outside the last
// `window` positions are masked (0 < window <= S).  Returns
// cudaGetLastError() after the launches (0 = launched); -1 for a dtype,
// variant, head dims, grouping or window this kernel was not built for.
extern "C" int dnet_flash_decode(int dtype, int kv_dtype, int qbits, int head_dim, int v_head_dim,
                                 const void* q, const void* k, const void* v, const float* k_scale,
                                 const float* v_scale, void* o, const float* sinks, float* part_o,
                                 float* part_ml, const int* lengths, int B, int H, int KVH, int S,
                                 int tiles_per_split, int n_split, float scale, int rotating,
                                 int window, void* stream) {
  if (H % KVH != 0 || H / KVH > GMAX) return -1;
  if (rotating && (window <= 0 || window > S || head_dim != v_head_dim)) return -1;
  return launch_dtype(dtype, head_dim, v_head_dim, kv_dtype, qbits, q, k, v, k_scale, v_scale, o,
                      (float*)nullptr, (float*)nullptr, sinks, part_o, part_ml, lengths, B, H, KVH,
                      S, tiles_per_split, n_split, scale, rotating, window,
                      static_cast<cudaStream_t>(stream));
}

// The LSE form (one sp rank's partials): q [B, 1, H, head_dim] in dtype; the
// cache as for dnet_flash_decode (qbits 0, 8 or 4; never rotating), the
// same (head_dim, v_head_dim) pairs.  lengths [B] int32 on the device: the
// rank's live slots per lane (0 = none).  Writes o [B, 1, H, v_head_dim]
// f32 (unnormalised, relative to m), m and l [B, KVH, G] f32; part_o /
// part_ml are the caller's f32 scratch as for dnet_flash_decode.  Returns
// cudaGetLastError() after the launches; -1 for a dtype, variant, head dims
// or grouping it was not built for.
extern "C" int dnet_flash_decode_lse(int dtype, int kv_dtype, int qbits, int head_dim,
                                     int v_head_dim, const void* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale, float* o,
                                     float* m, float* l, float* part_o, float* part_ml,
                                     const int* lengths, int B, int H, int KVH, int S,
                                     int tiles_per_split, int n_split, float scale, void* stream) {
  if (H % KVH != 0 || H / KVH > GMAX || !m || !l) return -1;
  return launch_dtype(dtype, head_dim, v_head_dim, kv_dtype, qbits, q, k, v, k_scale, v_scale,
                      static_cast<void*>(o), m, l, (const float*)nullptr, part_o, part_ml, lengths,
                      B, H, KVH, S, tiles_per_split, n_split, scale, 0, 0,
                      static_cast<cudaStream_t>(stream));
}
