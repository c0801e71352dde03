// Column ops of the hop codec (compression/ops.py, compression/wire.py), for
// Hopper: per-column sums of squares, a column gather, and the receive side's
// fused dequant + column scatter.
//
// Replaces two TPU kernels of dnet_tpu/compression/ops.py:
//   - `_norms_kernel` (:24, via `_column_sq_norms_pallas` and
//     `column_l2_norms`): x [R, C] bf16/f32 -> [C] f32, the sum of squares of
//     each column, accumulated over row tiles in a sequential grid.
//   - `_matmul_kernel` (:81, via `_pallas_matmul`, `gather_columns` and
//     `scatter_columns`): a [R, D] @ one-hot [D, K] product on the MXU, which
//     is an exact column gather [R, D] -> [R, K], or a column scatter
//     [R, K] -> [R, D] with zeros elsewhere; on the receive side XLA fused the
//     q8 dequant into its operand read (compression/wire.py:181-202).
//
// What bounds them on an H100: each touches every input byte once and does a
// handful of operations per element, so all three are bound by the bytes they
// move (inputs read once, outputs written once) at 3.35 TB/s.  What the design
// does about it:
//   - no one-hot product: a gather is an indexed copy, so no [D, K] operand is
//     ever built or read (the MXU trick has no reason to exist here).
//   - the norms walk rows with one thread per column, so a warp reads
//     neighbouring columns of one row (coalesced).  The rows are split across
//     blocks to fill the card at small C; each split writes its partial sums
//     and a second pass adds them in split order.  No float atomics: the sums
//     are the same bits on every run, so the top-k that follows is steady.
//   - the scatter writes every output element exactly once (zeros included):
//     a block owns a strip of 256 output columns, finds the kept columns that
//     fall in it by binary search of the sorted `idx`, maps them in shared
//     memory, and writes its rows coalesced; no separate zero fill.
//   - the dequant is written with __fmul_rn/__fadd_rn so nvcc cannot contract
//     it into an FMA: it equals the plain version's `codes.float() * scale +
//     bias` bit for bit.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;  // columns per block

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// partial[s, c] = sum over rows [s * rows_per_split, (s + 1) * rows_per_split) of x[r, c]^2
// (with n_split == 1 `partial` is the output itself)
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
sq_norms_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int R, int C,
                        int rows_per_split) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(R, r0 + rows_per_split);
  const T* col = x + c;
  float acc = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float v = to_float<T>(col[(long)r * C]);
    acc = fmaf(v, v, acc);
  }
  partial[(long)blockIdx.y * C + c] = acc;
}

// out[c] = sum over s of partial[s, c], in split order
__global__ void __launch_bounds__(NTHREADS)
sq_norms_combine_kernel(const float* __restrict__ partial, float* __restrict__ out, int C,
                        int n_split) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += partial[(long)s * C + c];
  out[c] = acc;
}

// out[r, j] = x[r, idx[j]], copied as raw bits (U is the element's width)
template <typename U>
__global__ void __launch_bounds__(NTHREADS)
gather_kernel(const U* __restrict__ x, const int* __restrict__ idx, U* __restrict__ out, int R,
              int C, int K) {
  const int j = blockIdx.x * NTHREADS + threadIdx.x;
  if (j >= K) return;
  const int c = idx[j];
  for (int r = blockIdx.y; r < R; r += gridDim.y) out[(long)r * K + j] = x[(long)r * C + c];
}

// MODE_SCATTER: src is the kept columns [R, K] in T; MODE_TENSOR: src is
// uint8 codes [R, K] with one scale and one bias; MODE_GROUP: codes with
// per-(row, group of gs kept columns) scale and bias [R, G]
constexpr int MODE_SCATTER = 0;
constexpr int MODE_TENSOR = 1;
constexpr int MODE_GROUP = 2;

template <typename T, int MODE>
__global__ void __launch_bounds__(NTHREADS)
dequant_scatter_kernel(const void* __restrict__ src, const float* __restrict__ scale,
                       const float* __restrict__ bias, const int* __restrict__ idx,
                       T* __restrict__ out, int R, int D, int K, int gs, int G,
                       int rows_per_block) {
  __shared__ int kept_at[NTHREADS];  // strip column -> kept index, or -1
  __shared__ int bounds[2];
  const int c0 = blockIdx.x * NTHREADS;
  if (threadIdx.x < 2) {
    // first kept index whose column is >= the strip's start (resp. end)
    const int target = c0 + threadIdx.x * NTHREADS;
    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (idx[mid] < target) lo = mid + 1; else hi = mid;
    }
    bounds[threadIdx.x] = lo;
  }
  kept_at[threadIdx.x] = -1;
  __syncthreads();
  for (int j = bounds[0] + threadIdx.x; j < bounds[1]; j += NTHREADS) kept_at[idx[j] - c0] = j;
  __syncthreads();
  const int c = c0 + threadIdx.x;
  if (c >= D) return;
  const int j = kept_at[threadIdx.x];
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    T v;
    if (j < 0) {
      v = dnet::from_float<T>(0.f);
    } else if (MODE == MODE_SCATTER) {
      v = static_cast<const T*>(src)[(long)r * K + j];
    } else {
      const float code = static_cast<float>(static_cast<const uint8_t*>(src)[(long)r * K + j]);
      const long p = MODE == MODE_TENSOR ? 0 : (long)r * G + j / gs;
      v = dnet::from_float<T>(__fadd_rn(__fmul_rn(code, scale[p]), bias[p]));
    }
    out[(long)r * D + c] = v;
  }
}

template <typename T>
int launch_dequant_scatter(int mode, const void* src, const float* scale, const float* bias,
                           const int* idx, void* out, int R, int D, int K, int gs, int G,
                           int rows_per_block, cudaStream_t st) {
  const dim3 grid((D + NTHREADS - 1) / NTHREADS, (R + rows_per_block - 1) / rows_per_block);
  T* o = static_cast<T*>(out);
  if (mode == MODE_SCATTER) {
    dequant_scatter_kernel<T, MODE_SCATTER><<<grid, NTHREADS, 0, st>>>(
        src, scale, bias, idx, o, R, D, K, gs, G, rows_per_block);
  } else if (mode == MODE_TENSOR) {
    dequant_scatter_kernel<T, MODE_TENSOR><<<grid, NTHREADS, 0, st>>>(
        src, scale, bias, idx, o, R, D, K, gs, G, rows_per_block);
  } else if (mode == MODE_GROUP) {
    if (gs <= 0) return -1;
    dequant_scatter_kernel<T, MODE_GROUP><<<grid, NTHREADS, 0, st>>>(
        src, scale, bias, idx, o, R, D, K, gs, G, rows_per_block);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [R, C] (dtype code) -> out [C] f32.  n_split > 1 needs partial
// [n_split, C] f32 scratch; rows_per_split * n_split >= R.
extern "C" int dnet_column_sq_norms(int dtype, const void* x, float* partial, float* out, int R,
                                    int C, int n_split, int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || n_split < 1 || (long)rows_per_split * n_split < R) return -1;
  float* first = n_split == 1 ? out : partial;
  const dim3 grid((C + NTHREADS - 1) / NTHREADS, n_split);
  if (dtype == dnet::DTYPE_BF16) {
    sq_norms_partial_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), first, R, C, rows_per_split);
  } else if (dtype == dnet::DTYPE_F32) {
    sq_norms_partial_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), first, R, C, rows_per_split);
  } else {
    return -1;
  }
  if (n_split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sq_norms_combine_kernel<<<(C + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(partial, out, C,
                                                                               n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [R, K] = x [R, C][:, idx], elements of elem_bytes (2 or 4) bytes;
// idx [K] int32 in [0, C).  row_blocks (<= 65535) blocks stride over rows.
extern "C" int dnet_gather_columns(int elem_bytes, const void* x, const int* idx, void* out, int R,
                                   int C, int K, int row_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || row_blocks < 1 || row_blocks > 65535) return -1;
  const dim3 grid((K + NTHREADS - 1) / NTHREADS, row_blocks);
  if (elem_bytes == 2) {
    gather_kernel<uint16_t><<<grid, NTHREADS, 0, st>>>(
        static_cast<const uint16_t*>(x), idx, static_cast<uint16_t*>(out), R, C, K);
  } else if (elem_bytes == 4) {
    gather_kernel<uint32_t><<<grid, NTHREADS, 0, st>>>(
        static_cast<const uint32_t*>(x), idx, static_cast<uint32_t*>(out), R, C, K);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// out [R, D] (dtype code) with column idx[j] = src[:, j] (mode 0, src in the
// out dtype) or its dequant (mode 1: one scale/bias; mode 2: [R, G] scales
// and biases over groups of gs kept columns), zeros at every other column.
// idx [K] int32, sorted ascending, unique, in [0, D).
extern "C" int dnet_dequant_scatter_columns(int dtype, int mode, const void* src,
                                            const float* scale, const float* bias, const int* idx,
                                            void* out, int R, int D, int K, int gs, int G,
                                            int rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || D < 1 || K < 0 || K > D || rows_per_block < 1) return -1;
  if ((long)(R + rows_per_block - 1) / rows_per_block > 65535) return -1;
  if (dtype == dnet::DTYPE_BF16)
    return launch_dequant_scatter<__nv_bfloat16>(mode, src, scale, bias, idx, out, R, D, K, gs, G,
                                                 rows_per_block, st);
  if (dtype == dnet::DTYPE_F32)
    return launch_dequant_scatter<float>(mode, src, scale, bias, idx, out, R, D, K, gs, G,
                                         rows_per_block, st);
  return -1;
}
