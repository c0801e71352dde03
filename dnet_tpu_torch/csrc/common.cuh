// Helpers shared by the port's attention kernels: 16-byte vector loads of
// bf16/f32 rows into float registers, stores back in the tensor's type, the
// staging of a [ROWS, D] tile from device memory into shared memory, and
// 16-byte asynchronous copies (cp.async) into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dnet {

// Large negative instead of -inf, exactly as the reference kernels: a fully
// masked score contributes exp(NEG_INF - m) == 0 and never produces NaN.
constexpr float NEG_INF = -1e30f;

// dtype codes passed across the C interface (kernels/build.py DTYPE_CODES)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes at p (16-byte aligned) -> N floats
template <typename T> __device__ __forceinline__ void load16(const T* p, float* out);

template <> __device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Stage rows [0, rows) of a [ROWS, D] tile (row stride `stride` elements)
// into shared memory as float, times `mul`; rows >= rows are zero-filled so
// the ragged edge of T or S never reads past the tensor.
//   TRANSPOSE: dst[d * ld + r]   (row index fastest across threads)
//   otherwise: dst[r * ld + d]   (vector chunk fastest: coalesced reads)
template <typename T, int D, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const T* src, long stride,
                                           int rows, float mul) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CHUNKS = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += blockDim.x) {
    int r, c;
    if (TRANSPOSE) {
      r = idx % ROWS;
      c = idx / ROWS;
    } else {
      c = idx % CHUNKS;
      r = idx / CHUNKS;
    }
    float v[VEC];
    if (r < rows) {
      load16<T>(src + (long)r * stride + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (TRANSPOSE) {
        dst[(c * VEC + e) * ld + r] = v[e] * mul;
      } else {
        dst[r * ld + c * VEC + e] = v[e] * mul;
      }
    }
  }
}

// 16 bytes from src to shared memory at dst without passing through
// registers; ok == false zero-fills dst and reads nothing (src may then be
// any valid pointer), so a ragged edge never reads a dead or foreign row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dnet
