// Causal prefill attention against a slot-addressed KV cache, for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` (dnet_tpu/ops/flash_attention.py:38,
// launched by `_flash_pallas`): query row i of the chunk attends cache slots
// [0, pos + i]; online softmax (m, l, acc) in f32; per-head sink logits folded
// into the denominator once, at emit.  Layouts are the reference's native ones:
// q [B, T, H, DQK], k [B, S, KVH, DQK], v [B, S, KVH, DV], o [B, T, H, DV];
// head h reads KV head h / (H / KVH).  DV may differ from DQK (MLA:
// deepseek_v2 attends with DQK = 192, nope 128 + rope 64, and DV = 128,
// dnet_tpu/ops/flash_attention.py:42-46): the score loop runs over DQK, the
// V tile, the accumulator and the output over DV.
//
// What bounds it on an H100: at prefill widths (T >= 16) the work is
// T * keys * (DQK + DV) multiply-adds per head, far above the card's
// bytes-to-operations balance point, so it is bound by arithmetic.  This first version does that
// arithmetic with f32 FMAs on the CUDA cores (both for bf16 and f32 inputs),
// not on the tensor cores: it is simple and exact to f32, and a later change
// can move the two products to mma/wgmma.  What the design does about the
// bound: each block keeps a 64-row Q tile in shared memory and streams 64-key
// K/V tiles past it, so every K/V element read from device memory feeds 64
// query rows; each thread computes a 4x4 register tile of scores and a 4-row
// slice of the output accumulator, so shared-memory loads are amortised over
// 16 (QK) and 4*DV/16 (PV) multiply-adds.  At (DQK, DV) = (192, 128) the
// tiles take 155,648 bytes of shared memory, one block per SM.
//
// TPU -> GPU translation: the TPU's sequential last grid axis (kv tiles, with
// the accumulator in VMEM scratch) becomes a loop inside the block; the
// above-diagonal `pl.when` skip becomes the loop bound pos + (last row of the
// q tile), which also stops before dead cache slots; ragged T and S edges are
// masked here instead of being refused by a tiling gate.

#include "common.cuh"

namespace {

using dnet::NEG_INF;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads; each owns 4 rows x 4 keys

template <int DQK, int DV>
struct Layout {
  static constexpr int LDQ = BQ + 4;  // Qs[d][i], q pre-scaled
  static constexpr int LDK = BK + 4;  // Ks[d][j]
  static constexpr int LDV = DV + 4;  // Vs[j][d]
  static constexpr int LDP = BK + 4;  // Ps[i][j]
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + DQK * LDQ;
  static constexpr int V_OFF = K_OFF + DQK * LDK;
  static constexpr int P_OFF = V_OFF + BK * LDV;
  static constexpr int FLOATS = P_OFF + BQ * LDP;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, const float* __restrict__ sinks, int T_len, int H,
                     int KVH, int S, int pos, float scale) {
  using L = Layout<DQK, DV>;
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ps = smem + L::P_OFF;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx*4 .. tx*4+3, output cols tx*DC ..
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);

  const int q_rows = min(BQ, T_len - q0);
  // last key any row of this tile may attend is pos + q0 + q_rows - 1
  const int key_end = min(pos + q0 + q_rows, S);
  const int n_tiles = (key_end + BK - 1) / BK;

  const long q_stride = (long)H * DQK;
  const long k_stride = (long)KVH * DQK;
  const long v_stride = (long)KVH * DV;
  const T* qb = q + (((long)b * T_len + q0) * H + h) * DQK;
  const T* kb = k + ((long)b * S * KVH + kvh) * DQK;
  const T* vb = v + ((long)b * S * KVH + kvh) * DV;

  dnet::stage_tile<T, DQK, BQ, true>(Qs, L::LDQ, qb, q_stride, q_rows, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    const int kv_rows = min(BK, S - k0);
    dnet::stage_tile<T, DQK, BK, true>(Ks, L::LDK, kb + (long)k0 * k_stride, k_stride, kv_rows, 1.f);
    dnet::stage_tile<T, DV, BK, false>(Vs, L::LDV, vb + (long)k0 * v_stride, v_stride, kv_rows, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * L::LDQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Ks + d * L::LDK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = pos + q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx * 4 + j;
        if (k_pos > q_pos || k_pos >= S) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads sharing a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rs += p[j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * L::LDP + tx * 4) = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * L::LDP + j);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(Vs + (j + jj) * L::LDV + tx * DC + c);
          vv[c] = t.x; vv[c + 1] = t.y; vv[c + 2] = t.z; vv[c + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i][jj], vv[c], acc[i][c]);
      }
    }
  }

  // emit: fold the sink (NEG_INF = none) into the denominator exactly once
  const float sink = sinks ? sinks[h] : NEG_INF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
    const float m_fin = fmaxf(m[i], sink);
    const float corr = expf(m[i] - m_fin);
    const float l_fin = fmaxf(l[i] * corr + expf(sink - m_fin), 1e-30f);
    T* orow = o + (((long)b * T_len + row) * H + h) * DV + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = dnet::from_float<T>(acc[i][c] * corr / l_fin);
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, const float* sinks, int B,
           int T_len, int H, int KVH, int S, int pos, float scale, cudaStream_t stream) {
  const size_t smem = Layout<DQK, DV>::BYTES;
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so on every launch: the call is cheap and does not synchronise)
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<T, DQK, DV><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sinks, T_len, H, KVH, S, pos, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(int head_dim, int v_head_dim, const void* q, const void* k, const void* v, void* o,
                const float* sinks, int B, int T_len, int H, int KVH, int S, int pos, float scale,
                cudaStream_t st) {
  if (head_dim == 64 && v_head_dim == 64)
    return launch<T, 64, 64>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  if (head_dim == 128 && v_head_dim == 128)
    return launch<T, 128, 128>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  if (head_dim == 192 && v_head_dim == 128)
    return launch<T, 192, 128>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  return -1;
}

}  // namespace

// C interface (bound with ctypes in dnet_tpu_torch/ops/flash_attention.py).
// head_dim is q's and k's, v_head_dim v's and the output's.  Returns
// cudaGetLastError() after the launch (0 = launched); -1 for a dtype or
// (head_dim, v_head_dim) pair this kernel was not built for.
extern "C" int dnet_flash_prefill(int dtype, int head_dim, int v_head_dim, const void* q,
                                  const void* k, const void* v, void* o, const float* sinks, int B,
                                  int T_len, int H, int KVH, int S, int pos, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dnet::DTYPE_BF16)
    return launch_dims<__nv_bfloat16>(head_dim, v_head_dim, q, k, v, o, sinks, B, T_len, H, KVH,
                                      S, pos, scale, st);
  if (dtype == dnet::DTYPE_F32)
    return launch_dims<float>(head_dim, v_head_dim, q, k, v, o, sinks, B, T_len, H, KVH, S, pos,
                              scale, st);
  return -1;
}
