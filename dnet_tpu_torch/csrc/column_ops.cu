// Column ops of the hop codec (compression/ops.py, compression/wire.py), for
// Hopper: per-column sums of squares, a column gather, and the receive side's
// fused dequant + column scatter.
//
// Replaces two TPU kernels of dnet_tpu/compression/ops.py:
//   - `_norms_kernel` (:24, via `_column_sq_norms_pallas` and
//     `column_l2_norms`): x [R, C] bf16/f32 -> [C] f32, the sum of squares of
//     each column, accumulated over row tiles in a sequential grid; here
//     with the `jax.lax.top_k` + sort that follows it on the send side
//     (:198-205, :238-249) fused in.
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
//   - the gather's block owns a strip of kept columns (32 threads x 16 bytes
//     of output a row: 256 bf16 or 128 f32 kept values) and a tile of 16
//     rows.  The codec's idx is sorted and unique, so a strip's kept columns
//     lie in the span [idx[j0], idx[j_last]] of x; where that span fits a
//     2 KB window a row, the block copies it for all its rows at once with
//     16-byte cp.async (contiguous, every row in flight), then each thread
//     picks its 8 (bf16) or 4 (f32) kept values out of shared memory and
//     writes them as one 16-byte store.  Where the span does not fit, x's
//     rows are not 16-byte multiples, or the tile has one row, the same
//     kernel reads element by element (a one-row frame, a decode hop, one
//     kept value a thread, as the launch-bound decode hop wants); and
//     a column outside the span (idx not sorted) is read from x directly, so
//     any idx in [0, C) gives the same bits.  The kept bytes are its bound;
//     the 32-byte sectors of x they touch are the bound a design that reads
//     x can reach.
//   - the norms and the codec's top-k are one launch (the TPU side ran the
//     norms kernel, then `jax.lax.top_k` and a sort inside one jitted
//     program, :198-205).  A block owns a strip of a warp's 512 bytes of a
//     row (256 bf16 or 128 f32 columns, 16 bytes a lane) and walks a range
//     of rows, its warps adding their rows in a fixed order through shared
//     memory; rows split over blocks until about two blocks an SM run.  Each
//     split writes its sums and takes its strip's ticket, and the last adds
//     the partials in split order (the decode kernel's ticket merge): no
//     float atomics, so a frame's norms, and the columns picked from them,
//     are the same on every run.  With a `keep`, the last strip to finish
//     holds all C norms in shared memory, radix-selects the keep-th largest
//     on their f32 bits (the norms are >= 0, so the bits order as the
//     floats; ties go to the lower index, as `jax.lax.top_k`), and writes
//     the kept columns ascending and the wire's packed bitmask.  A decode
//     hop's frame (R = 1) is launch-bound: this takes its select chain
//     (sorts, casts and a host sync for the mask) down to one kernel.
//   - the scatter writes every output element exactly once (zeros included),
//     16 bytes a thread a row (8 bf16 or 4 f32 columns; element stores where
//     D is not a multiple of that, so a row start is not 16-byte aligned): a
//     block owns a strip of 256 such column groups, maps the kept columns
//     that fall in it in shared memory from the slice of the sorted `idx`
//     that can reach it (one coalesced load a thread, no dependent search),
//     and writes a few rows; a thread reads a (row, group) scale and bias
//     once for the columns of that group it writes.  No separate zero fill.
//   - the dequant is written with __fmul_rn/__fadd_rn so nvcc cannot contract
//     it into an FMA: it equals the plain version's `codes.float() * scale +
//     bias` bit for bit.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;  // threads per block in every kernel
constexpr int NWARPS_GATHER = NTHREADS / 32;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int NORMS_WARPS = NTHREADS / 32;
constexpr int RADIX_BINS = 256;  // 8-bit digits: four passes over a 32-bit key
static_assert(RADIX_BINS == NTHREADS, "the selection's scan gives each thread one digit");

// The sum of v over the block's threads before this one (thread order),
// through `warp_tot` [NORMS_WARPS]; every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  __syncthreads();  // warp_tot is free for the next scan
  return before + incl - v;
}

// One thread of the block takes a ticket on `counter` with acquire-release
// semantics (the barrier before it makes the block's writes part of its
// release, the barrier after it gives the block what earlier blocks
// released); true in every thread of the block that took the last of `n`.
__device__ __forceinline__ bool last_ticket(int* counter, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                 : "=r"(ticket) : "l"(counter), "r"(1) : "memory");
    *flag = ticket == n - 1;
    if (ticket == n - 1) *counter = 0;  // ready for the next call on this stream
  }
  __syncthreads();
  return *flag;
}

// The selection, in the last block: the `keep` largest of norms [C] (NaN
// above +inf, ties to the lower index, as the plain version's stable sort)
// -> idx [keep] ascending and the packed bitmask [ceil(C / 8)] (bit 7 of
// byte b is column 8b, as np.packbits).  The norms are >= 0, so their f32
// bits order as the floats: a radix select over 8-bit digits, most
// significant first, finds the keep-th largest key (`prefix` at the end) and
// how many keys equal to it are kept (`k`); a prefix sum over the threads'
// runs of columns then places each kept column.
__device__ void select_top(const float* norms, uint32_t* keys, int C, int keep, int* idx_out,
                           uint8_t* mask_out) {
  __shared__ int hist[RADIX_BINS];
  __shared__ int warp_tot[NORMS_WARPS];
  __shared__ uint32_t s_prefix;
  __shared__ int s_k;
  const int tid = threadIdx.x;
  for (int i = tid; i < C; i += NTHREADS) {
    const float v = __ldcg(norms + i);
    keys[i] = isnan(v) ? 0x7fffffffu : __float_as_uint(v);
  }
  uint32_t prefix = 0, pmask = 0;
  int k = keep;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < C; i += NTHREADS) {
      const uint32_t u = keys[i];
      if ((u & pmask) == prefix) atomicAdd(&hist[(u >> shift) & (RADIX_BINS - 1)], 1);
    }
    __syncthreads();
    // thread t holds digit 255 - t: its exclusive sum counts the keys of
    // higher digits, and exactly one thread's digit holds the k-th largest
    const int digit = RADIX_BINS - 1 - tid;
    const int cnt = hist[digit];
    const int above = block_exclusive_scan(cnt, warp_tot);
    if (above < k && above + cnt >= k) {
      s_prefix = prefix | ((uint32_t)digit << shift);
      s_k = k - above;
    }
    __syncthreads();
    prefix = s_prefix;
    k = s_k;
    pmask |= (uint32_t)(RADIX_BINS - 1) << shift;
  }
  // each thread owns a run of columns, a multiple of 8 (whole mask bytes)
  const int run = ((C + NTHREADS - 1) / NTHREADS + 7) & ~7;
  const int a = min(C, tid * run), b = min(C, a + run);
  int n_gt = 0, n_eq = 0;
  for (int i = a; i < b; ++i) {
    n_gt += keys[i] > prefix;
    n_eq += keys[i] == prefix;
  }
  int eq_seen = block_exclusive_scan(n_eq, warp_tot);
  const int mine = n_gt + max(0, min(n_eq, k - eq_seen));
  int pos = block_exclusive_scan(mine, warp_tot);
  for (int i = a; i < b; i += 8) {
    unsigned byte = 0;
    for (int e = 0; e < 8 && i + e < b; ++e) {
      const uint32_t u = keys[i + e];
      const bool kept = u > prefix || (u == prefix && eq_seen++ < k);
      if (kept) {
        idx_out[pos++] = i + e;
        byte |= 0x80u >> e;
      }
    }
    mask_out[i >> 3] = static_cast<uint8_t>(byte);
  }
}

// norms[c] = sum over r of x[r, c]^2 in f32, and with keep > 0 the top-keep
// selection of them, in one launch.  Grid (strips, n_split): a block owns a
// strip of 32 x VEC columns (a warp's 512 bytes of a row) and the rows
// [split * rows_per_split, +rows_per_split); warp w walks rows w, w + 8, ...
// of them, a lane VEC neighbouring columns (one 16-byte load a row; VEC
// columns at stride 32 on the element path), and the warps' sums are added
// in warp order through shared memory.  With n_split > 1 each split writes
// its sums to partial [n_split, C] and takes its strip's ticket; the last
// adds the partials in split order.  Then with keep > 0 each strip takes
// the call's ticket and the last runs the selection.  Every product and sum
// is rounded on its own (__fmul_rn, __fadd_rn), in an order fixed by the
// shape: a frame's norms are the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
norms_topk_kernel(const T* __restrict__ x, float* __restrict__ partial, float* __restrict__ norms,
                  int* __restrict__ tickets, int* __restrict__ idx_out, uint8_t* __restrict__ mask_out,
                  int R, int C, int rows_per_split, int keep, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int JW = 32 * VEC;  // the strip: 256 bf16 or 128 f32 columns
  extern __shared__ __align__(16) float smem[];  // [NORMS_WARPS, JW] sums, then the keys
  __shared__ int flag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_split = gridDim.y;
  const int c0 = blockIdx.x * JW;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(R, r0 + rows_per_split);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (vec) {  // C % VEC == 0 and x 16-byte aligned: every row's chunk is aligned
    const int c = c0 + lane * VEC;
    if (c < C) {
#pragma unroll 4
      for (int r = r0 + warp; r < r1; r += NORMS_WARPS) {
        float v[VEC];
        dnet::load16<T>(x + (long)r * C + c, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], v[e]));
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) smem[warp * JW + lane * VEC + e] = acc[e];
  } else {
#pragma unroll 2
    for (int r = r0 + warp; r < r1; r += NORMS_WARPS) {
      const T* xr = x + (long)r * C + c0 + lane;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (c0 + e * 32 + lane < C) {
          const float v = to_float<T>(xr[e * 32]);
          acc[e] = __fadd_rn(acc[e], __fmul_rn(v, v));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) smem[warp * JW + e * 32 + lane] = acc[e];
  }
  __syncthreads();
  const int j = threadIdx.x;  // the strip column this thread adds up
  const bool mine = j < JW && c0 + j < C;
  float s = 0.f;
  if (mine)
    for (int w = 0; w < NORMS_WARPS; ++w) s = __fadd_rn(s, smem[w * JW + j]);
  if (n_split == 1) {
    if (mine) norms[c0 + j] = s;
  } else {
    if (mine) partial[(long)blockIdx.y * C + c0 + j] = s;
    if (!last_ticket(tickets + blockIdx.x, n_split, &flag)) return;
    if (mine) {
      float o = 0.f;
      for (int sp = 0; sp < n_split; ++sp) o = __fadd_rn(o, __ldcg(partial + (long)sp * C + c0 + j));
      norms[c0 + j] = o;
    }
  }
  if (keep <= 0) return;
  if (!last_ticket(tickets + gridDim.x, gridDim.x, &flag)) return;
  select_top(norms, reinterpret_cast<uint32_t*>(smem), C, keep, idx_out, mask_out);
}

template <typename T>
int launch_norms_topk(const void* x, float* partial, float* norms, int* tickets, int* idx,
                      uint8_t* mask, int R, int C, int n_split, int rows_per_split, int keep,
                      cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int JW = 32 * VEC;
  const size_t sums = NORMS_WARPS * JW * sizeof(float);
  const size_t keys = keep > 0 ? (size_t)C * sizeof(uint32_t) : 0;
  const size_t smem = keys > sums ? keys : sums;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        norms_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((C + JW - 1) / JW, n_split);
  norms_topk_kernel<T><<<grid, NTHREADS, smem, st>>>(static_cast<const T*>(x), partial, norms,
                                                     tickets, idx, mask, R, C, rows_per_split,
                                                     keep, vec);
  return static_cast<int>(cudaGetLastError());
}

constexpr int GATHER_ROWS = 16;      // rows a gather block owns
constexpr int GATHER_WINDOW = 2048;  // bytes of a row's span a gather block stages

// out[r, j] = x[r, idx[j]], copied as raw bits (U is the element's width).
// Grid (ceil(K / (32 * VEC)), row tiles): lane l of every warp owns kept
// columns j0 + l * VEC .. + VEC - 1 of the block's strip, warp w rows
// w, w + 8 of its tile.  A frame of one row (a decode hop) has nothing to
// reuse: every thread copies one kept value, and no shared memory is
// launched (the window is dynamic shared memory, GATHER_ROWS x
// GATHER_WINDOW bytes for R > 1).
template <typename U>
__global__ void __launch_bounds__(NTHREADS)
gather_kernel(const U* __restrict__ x, const int* __restrict__ idx, U* __restrict__ out, int R,
              int C, int K) {
  constexpr int VEC = 16 / sizeof(U);  // kept values a thread writes a row
  constexpr int JW = 32 * VEC;         // the block's strip of kept columns
  constexpr int WE = GATHER_WINDOW / sizeof(U);  // elements of a row's window
  extern __shared__ __align__(16) uint8_t win[];
  const int j0 = blockIdx.x * JW;
  const int jl = min(K, j0 + JW) - 1;  // the strip's last kept column
  if (R == 1) {
    for (int j = j0 + threadIdx.x; j <= jl; j += NTHREADS) out[j] = x[idx[j]];
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int jt = j0 + lane * VEC;      // this thread's first
  int col[VEC];
  if (jt + VEC <= K) {
    const int4* p = reinterpret_cast<const int4*>(idx + jt);
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const int4 v = p[e / 4];
      col[e] = v.x; col[e + 1] = v.y; col[e + 2] = v.z; col[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) col[e] = jt + e < K ? idx[jt + e] : -1;
  }
  // the window: x's columns [lo, hi_end), 16-byte aligned, holding the span
  // [idx[j0], idx[jl]] (sorted idx: every kept column of the strip)
  const int lo = idx[j0], hi = idx[jl];
  const int lo_al = lo & ~(VEC - 1);
  const int hi_end = (hi + VEC) & ~(VEC - 1);
  const bool rows_vec = (long)C * sizeof(U) % 16 == 0;
  const bool out_vec = (long)K * sizeof(U) % 16 == 0 && jt + VEC <= K;
  const int n_tiles = (R + GATHER_ROWS - 1) / GATHER_ROWS;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int r0 = tile * GATHER_ROWS;
    const int rows = min(GATHER_ROWS, R - r0);
    const bool staged = rows > 1 && rows_vec && lo <= hi && hi_end - lo_al <= WE;
    if (staged) {
      const int chunks = (hi_end - lo_al) / VEC;
      __syncthreads();  // the previous tile's window is consumed
      for (int r = warp; r < rows; r += NWARPS_GATHER)
        for (int c = lane; c < chunks; c += 32)
          dnet::cp_async16(win + r * GATHER_WINDOW + c * 16, x + (long)(r0 + r) * C + lo_al + c * VEC, true);
      dnet::cp_commit();
      dnet::cp_wait<0>();
      __syncthreads();
    }
    for (int r = warp; r < rows; r += NWARPS_GATHER) {
      const U* xr = x + (long)(r0 + r) * C;
      const U* wr = reinterpret_cast<const U*>(win + r * GATHER_WINDOW);
      __align__(16) U v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = col[e];
        v[e] = c < 0 ? U(0) : staged && c >= lo && c <= hi ? wr[c - lo_al] : xr[c];
      }
      U* orow = out + (long)(r0 + r) * K + jt;
      if (out_vec) {
        *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(v);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (col[e] >= 0) orow[e] = v[e];
      }
    }
  }
}

// MODE_SCATTER: src is the kept columns [R, K] in T; MODE_TENSOR: src is
// uint8 codes [R, K] with one scale and one bias; MODE_GROUP: codes with
// per-(row, group of gs kept columns) scale and bias [R, G]
constexpr int MODE_SCATTER = 0;
constexpr int MODE_TENSOR = 1;
constexpr int MODE_GROUP = 2;

// 16 bytes of T from VEC floats, each rounded to T as torch's cast rounds
template <typename T> struct Pack16;
template <> struct Pack16<float> {
  static __device__ __forceinline__ void store(float* dst, const float* y) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  }
};
template <> struct Pack16<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float* y) {
    uint4 u;
    __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = u;
  }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(NTHREADS)
dequant_scatter_kernel(const void* __restrict__ src, const float* __restrict__ scale,
                       const float* __restrict__ bias, const int* __restrict__ idx,
                       T* __restrict__ out, int R, int D, int K, int gs, int G,
                       int rows_per_block) {
  constexpr int VEC = dnet::Vec16<T>::N;  // columns a thread writes a row: 16 bytes
  constexpr int W = NTHREADS * VEC;       // a block's strip: 2,048 bf16 or 1,024 f32 columns
  __shared__ __align__(16) int kept_at[W];  // strip column -> kept index, or -1
  const int c0 = blockIdx.x * W;
#pragma unroll
  for (int e = 0; e < VEC; ++e) kept_at[e * NTHREADS + threadIdx.x] = -1;
  __syncthreads();
  // idx is sorted and unique in [0, D), so idx[j] >= j and idx[j] <= D - K + j:
  // only j in [c0 - (D - K), c0 + W) can land in the strip.  Every thread
  // loads its share of that slice at once (coalesced; no dependent search).
  const int j_end = min(K, c0 + W);
#pragma unroll 4
  for (int j = max(0, c0 - (D - K)) + threadIdx.x; j < j_end; j += NTHREADS) {
    const int c = idx[j] - c0;
    if (c >= 0 && c < W) kept_at[c] = j;
  }
  __syncthreads();
  const int c = c0 + threadIdx.x * VEC;  // this thread's first column
  if (c >= D) return;
  int jv[VEC];
  {
    const int4* m = reinterpret_cast<const int4*>(kept_at + threadIdx.x * VEC);
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const int4 x = m[e / 4];
      jv[e] = x.x; jv[e + 1] = x.y; jv[e + 2] = x.z; jv[e + 3] = x.w;
    }
  }
  // MODE_GROUP: this thread's kept columns fall in groups g0 and g0 + 1
  // whenever gs >= VEC - 1 (the hop's 16 and 64); their scales and biases
  // are read once a row, and a column in any later group reads its own.  A
  // power-of-two gs (the codec's) shifts: dividing by a runtime gs cost more
  // than the rest of a decode hop's call on the card.
  int g0 = -1, gsel[VEC];
  bool need1 = false;
  const int gsh = MODE == MODE_GROUP && (gs & (gs - 1)) == 0 ? __ffs(gs) - 1 : -1;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    gsel[e] = 0;
    if (MODE == MODE_GROUP && jv[e] >= 0) {
      const int gj = gsh >= 0 ? jv[e] >> gsh : jv[e] / gs;
      if (g0 < 0) g0 = gj;
      gsel[e] = gj - g0;
      need1 |= gsel[e] == 1;
    }
  }
  // 16-byte stores where every row's VEC columns are in bounds and aligned
  const bool vec_ok = D % VEC == 0;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  float sc0 = 0.f, bi0 = 0.f, sc1 = 0.f, bi1 = 0.f;
  if (MODE == MODE_TENSOR) {
    sc0 = scale[0];
    bi0 = bias[0];
  }
  for (int r = r0; r < r1; ++r) {
    T* orow = out + (long)r * D + c;
    if (MODE == MODE_SCATTER) {
      __align__(16) T x[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        x[e] = jv[e] >= 0 ? static_cast<const T*>(src)[(long)r * K + jv[e]] : dnet::from_float<T>(0.f);
      if (vec_ok) {
        *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (c + e < D) orow[e] = x[e];
      }
      continue;
    }
    // every load of the row first, then the arithmetic and the store
    unsigned code[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      code[e] = jv[e] >= 0 ? static_cast<const uint8_t*>(src)[(long)r * K + jv[e]] : 0u;
    if (MODE == MODE_GROUP && g0 >= 0) {
      sc0 = scale[(long)r * G + g0];
      bi0 = bias[(long)r * G + g0];
      if (need1) {
        sc1 = scale[(long)r * G + g0 + 1];
        bi1 = bias[(long)r * G + g0 + 1];
      }
    }
    float y[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float sc = gsel[e] == 1 ? sc1 : sc0, bi = gsel[e] == 1 ? bi1 : bi0;
      if (gsel[e] > 1) {
        sc = scale[(long)r * G + g0 + gsel[e]];
        bi = bias[(long)r * G + g0 + gsel[e]];
      }
      y[e] = jv[e] >= 0 ? __fadd_rn(__fmul_rn(static_cast<float>(code[e]), sc), bi) : 0.f;
    }
    if (vec_ok) {
      Pack16<T>::store(orow, y);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (c + e < D) orow[e] = dnet::from_float<T>(y[e]);
    }
  }
}

template <typename T>
int launch_dequant_scatter(int mode, const void* src, const float* scale, const float* bias,
                           const int* idx, void* out, int R, int D, int K, int gs, int G,
                           int rows_per_block, cudaStream_t st) {
  constexpr int W = NTHREADS * dnet::Vec16<T>::N;
  const dim3 grid((D + W - 1) / W, (R + rows_per_block - 1) / rows_per_block);
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

// x [R, C] (dtype code) -> norms [C] f32 and, with keep in [1, C], idx
// [keep] int32 ascending and mask [ceil(C / 8)] uint8 of the top keep.
// n_split > 1 needs partial [n_split, C] f32 scratch; n_split > 1 or
// keep > 0 needs tickets [strips + 1] int32, zero between calls (the kernel
// returns them to zero); rows_per_split * n_split >= R.
extern "C" int dnet_column_norms_topk(int dtype, const void* x, float* partial, float* norms,
                                      int* tickets, int* idx, uint8_t* mask, int R, int C,
                                      int n_split, int rows_per_split, int keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || n_split < 1 || n_split > 65535 || (long)rows_per_split * n_split < R) return -1;
  if ((n_split > 1 && (!partial || !tickets)) || keep > C) return -1;
  if (keep > 0 && (!tickets || !idx || !mask)) return -1;
  if (dtype == dnet::DTYPE_BF16)
    return launch_norms_topk<__nv_bfloat16>(x, partial, norms, tickets, idx, mask, R, C, n_split,
                                            rows_per_split, keep, st);
  if (dtype == dnet::DTYPE_F32)
    return launch_norms_topk<float>(x, partial, norms, tickets, idx, mask, R, C, n_split,
                                    rows_per_split, keep, st);
  return -1;
}

// out [R, K] = x [R, C][:, idx], elements of elem_bytes (2 or 4) bytes;
// idx [K] int32 in [0, C), fastest sorted; x, idx and out 16-byte aligned.
extern "C" int dnet_gather_columns(int elem_bytes, const void* x, const int* idx, void* out, int R,
                                   int C, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || (elem_bytes != 2 && elem_bytes != 4)) return -1;
  const int strip = 32 * 16 / elem_bytes;
  const dim3 grid((K + strip - 1) / strip, min((R + GATHER_ROWS - 1) / GATHER_ROWS, 65535));
  const size_t smem = R > 1 ? GATHER_ROWS * GATHER_WINDOW : 0;
  if (elem_bytes == 2) {
    gather_kernel<uint16_t><<<grid, NTHREADS, smem, st>>>(
        static_cast<const uint16_t*>(x), idx, static_cast<uint16_t*>(out), R, C, K);
  } else if (elem_bytes == 4) {
    gather_kernel<uint32_t><<<grid, NTHREADS, smem, st>>>(
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
