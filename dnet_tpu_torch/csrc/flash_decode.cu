// Single-token (T = 1) decode attention over the dense preallocated KV cache,
// for Hopper: split-K flash-decoding plus a small combine pass.
//
// Replaces the TPU kernel `_decode_kernel` (dnet_tpu/ops/flash_decode.py:50,
// launched by `_decode_pallas`) in its plain variant: qbits = 0, rotating =
// False, with_lse = False, offset = 0.  q/o [B, 1, H, D], k/v [B, S, KVH, D];
// the query attends cache slots [0, pos]; sinks [H] fold into the denominator.
//
// What bounds it on an H100: one query row per head does 2 * G multiply-adds
// per K/V element it reads (G = H / KVH query heads per KV head), far below the
// card's balance point, so the kernel is bound by the bytes of live cache it
// reads: 2 * (pos + 1) * KVH * D * sizeof(T) per call.  What the design does
// about it:
//   - it reads only the live slots [0, pos]: the loop bound is the live
//     length.  This replaces the Pallas trick of clamping dead tiles' block
//     indices so their copies are elided (flash_decode.py:14-17,181-191),
//     which has no CUDA counterpart; a literal port would read all S slots.
//   - all G query heads of a KV group share each K/V tile read.
//   - the live range is split across blocks (grid = splits x KVH x B), so a
//     batch of one with KVH = 8 still puts enough blocks on the 132 SMs; each
//     block writes unnormalised (acc, m, l) partials and the combine kernel
//     merges them with one log-sum-exp per head.

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KVH,
                          int S, int live, int tiles_per_split, int n_split, float scale) {
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
  for (int i = tid; i < G * D; i += NTHREADS) {
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

  const long kv_stride = (long)KVH * D;
  const T* kb = k + ((long)b * S * KVH + kvh) * D;
  const T* vb = v + ((long)b * S * KVH + kvh) * D;
  const int n_tiles = (live + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // Qs/stats initialised; previous tile's Ks/Vs/Ss consumed
    const int rows = min(BK, S - k0);
    dnet::stage_tile<T, D, BK, true>(Ks, L::LDK, kb + (long)k0 * kv_stride, kv_stride, rows, 1.f);
    dnet::stage_tile<T, D, BK, false>(Vs, L::LDV, vb + (long)k0 * kv_stride, kv_stride, rows, 1.f);
    __syncthreads();

    // scores: thread -> key j, heads g = tid/64, tid/64 + 2, ...
    {
      const int j = tid & (BK - 1);
      const bool valid = k0 + j < live;
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

// One block per (head, batch), one thread per output column: merge the
// splits' partials with one log-sum-exp and fold the sink exactly once.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            const float* __restrict__ sinks, T* __restrict__ o,
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
  const float sink = sinks ? sinks[h] : NEG_INF;
  const float m_fin = fmaxf(M, sink);
  const float corr = expf(M - m_fin);
  const float l_fin = fmaxf(l * corr + expf(sink - m_fin), 1e-30f);
  o[((long)b * H + h) * D + d] = dnet::from_float<T>(acc * corr / l_fin);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const float* sinks,
           float* part_o, float* part_ml, int B, int H, int KVH, int S, int live,
           int tiles_per_split, int n_split, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so on every launch: the call is cheap and does not synchronise)
  cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_split_kernel<T, D><<<dim3(n_split, KVH, B), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_o,
      part_ml, H, KVH, S, live, tiles_per_split, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<T><<<dim3(H, B), D, 0, stream>>>(part_o, part_ml, sinks,
                                                               static_cast<T*>(o), H, KVH, D,
                                                               n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/flash_decode.py).
// part_o [B, KVH, n_split, G, D] and part_ml [B, KVH, n_split, G, 2] are f32
// scratch the caller allocates.  Returns cudaGetLastError() after the
// launches (0 = launched); -1 for a dtype, head dim or grouping this kernel
// was not built for.
extern "C" int dnet_flash_decode(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, void* o, const float* sinks, float* part_o,
                                 float* part_ml, int B, int H, int KVH, int S, int live,
                                 int tiles_per_split, int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KVH != 0 || H / KVH > GMAX) return -1;
  if (dtype == dnet::DTYPE_BF16) {
    if (head_dim == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, sinks, part_o, part_ml, B, H, KVH, S, live,
                                       tiles_per_split, n_split, scale, st);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, sinks, part_o, part_ml, B, H, KVH, S, live,
                                        tiles_per_split, n_split, scale, st);
  } else if (dtype == dnet::DTYPE_F32) {
    if (head_dim == 64)
      return launch<float, 64>(q, k, v, o, sinks, part_o, part_ml, B, H, KVH, S, live,
                               tiles_per_split, n_split, scale, st);
    if (head_dim == 128)
      return launch<float, 128>(q, k, v, o, sinks, part_o, part_ml, B, H, KVH, S, live,
                                tiles_per_split, n_split, scale, st);
  }
  return -1;
}
