// Warp-level tensor-core helpers shared by the port's attention kernels
// (mma.sync m16n8k16 bf16 -> f32, operands loaded by ldmatrix), and the
// tile fold of the decode and paged kernels' tensor-core forms, written
// once for both (csrc/flash_decode.cu, csrc/paged_attention.cu).
#pragma once

#include "common.cuh"

namespace dnet {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i .. 8i + 7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(const bf16* p, unsigned& r0, unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const bf16* p, unsigned& r0, unsigned& r1,
                                              unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half: the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * grp + quad.  A (16x16)
// a0: row grp, cols 2quad..+1; a1: row grp+8; a2: row grp, cols 8+2quad..;
// a3: row grp+8, cols 8+2quad...  B (16x8): b0: rows 2quad..+1, col grp;
// b1: rows 8+2quad...  C (16x8): c0, c1: row grp, cols 2quad..+1; c2, c3: row
// grp+8.  So the C fragments of two neighbouring 8-key score tiles are,
// packed to bf16, the A fragment of P over those 16 keys.

// The decode and paged kernels' tensor-core form: a block holds 16 query
// rows (mma's m) of one KV head at head dim 128, bf16 q over bf16 K/V; 4
// key groups split every 64-key tile by keys, 16 each, so a group's P
// fragment is one whole k-step of P V.  DSPLIT warps share a key group:
// each scores its group's 16 keys and keeps D / DSPLIT of the 16 output
// rows' columns in registers.  The K/V ring holds rows padded by 16
// bytes, so the 8 rows one ldmatrix reads start in 8 different 16-byte
// bank groups.
namespace dmma {

constexpr int ROWS = 16;                    // query rows a block
constexpr int D = 128;                      // head dim (q, k, v and the output)
constexpr int LD = D + 8;                   // bf16 elements a padded row
constexpr int BK = 64;                      // keys a tile
constexpr int KGROUPS = 4;                  // 16 keys of every tile each
constexpr int DSPLIT = 2;                   // warps a key group, each with DW output columns
constexpr int DW = D / DSPLIT;
constexpr int WARPS = KGROUPS * DSPLIT;
constexpr int THREADS = 32 * WARPS;
constexpr int NSTAGE = 4;                   // tiles in the ring
constexpr int TILE_BYTES = BK * LD * 2;     // one K or V tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES; // [K tile | V tile]
constexpr int RING = NSTAGE * STAGE_BYTES;
constexpr int STATE = 2 * ROWS + ROWS * D;  // floats: a published state (m, l, acc [ROWS][D])
constexpr int WLD = D + 8;                  // a key group's acc rows in shared memory, padded
constexpr int WSTATE = 2 * ROWS + ROWS * WLD;
constexpr int Q_BYTES = ROWS * LD * 2;      // q [ROWS][LD] bf16
static_assert(KGROUPS * WSTATE * 4 + ROWS * KGROUPS * 4 <= RING, "the key groups' states fit the ring after the loop");
static_assert(BK == 16 * KGROUPS, "a key group folds 16 keys, one k-step of P V");
static_assert(DW % 16 == 0 && (ROWS * D / 4) % THREADS == 0, "columns split in 16s; float4 chunks a thread");

// One warp's share of the fold, in registers: q's A fragments (8 k-steps,
// unscaled bf16), its DW output columns as n-tiles of 8 (c0, c1 on row
// grp, c2, c3 on row grp + 8), and rows grp / grp + 8's running max (log2
// units) and this lane's part of their sums.
struct Warp {
  unsigned qf[D / 16][4];
  float o[DW / 8][4];
  float m[2], l[2];
};

// q rows [ROWS][LD] (bf16, rows past the group zero) from shared memory
// into the warp's fragments; the state empty
__device__ __forceinline__ void init(Warp& w, const bf16* Qs, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8, w.qf[kk][0], w.qf[kk][1], w.qf[kk][2],
            w.qf[kk][3]);
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) w.o[n][0] = w.o[n][1] = w.o[n][2] = w.o[n][3] = 0.f;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.f;
}

// p as hi + lo, two bf16 terms (about 16 bits of p): two neighbouring
// columns' A-fragment registers
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// Fold key group kg's 16 keys of one tile (Kt, Vt: [BK][LD] bf16 in
// shared memory; keys at or past n_valid are masked, and their rows must
// hold finite values: the copies zero-fill them) into the warp's state,
// its columns from c0 = (warp / KGROUPS) * DW.  The caller skips a key
// group whose keys are all masked (kg * 16 >= n_valid), so every row meets
// a finite score.  sl2 = softmax scale * log2(e): the f32 scores (exact
// bf16 products, f32 sums) are scaled after the product, as the
// reference's (q * scale) . k up to f32 rounding.
__device__ __forceinline__ void fold_tile(Warp& w, const bf16* Kt, const bf16* Vt, int warp, int lane,
                                          int n_valid, float sl2) {
  const int quad = lane & 3;
  const int kg = warp % KGROUPS, c0 = (warp / KGROUPS) * DW;
  float s[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned b0, b1, b2, b3;  // keys kg*16 .. +7 (b0, b1) and +8 .. +15 (b2, b3)
    ldsm_x4(Kt + (kg * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8, b0, b1, b2,
            b3);
    mma_bf16(s[0], w.qf[kk], b0, b1);
    mma_bf16(s[1], w.qf[kk], b2, b3);
  }

  // scores in log2 units, masked keys NEG_INF; the rows' max over the quad
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kg * 16 + n * 8 + 2 * quad + (e & 1);
      s[n][e] = key < n_valid ? s[n][e] * sl2 : NEG_INF;
      mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float m_new = fmaxf(w.m[i], mt[i]);
    corr[i] = exp2f(w.m[i] - m_new);
    w.m[i] = m_new;
    w.l[i] *= corr[i];
  }
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    w.o[n][0] *= corr[0];
    w.o[n][1] *= corr[0];
    w.o[n][2] *= corr[1];
    w.o[n][3] *= corr[1];
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - w.m[e >> 1]);
      s[n][e] = p;
      w.l[e >> 1] += p;  // the sums from the unrounded p
    }

  // O += P V with P = hi + lo: two products a V fragment
  unsigned ph[4], pl[4];
  split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
  split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
  split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
  split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
  for (int dp = 0; dp < DW / 16; ++dp) {
    unsigned b0, b1, b2, b3;  // columns c0 + dp*16 .. +7 (b0, b1) and +8 .. +15 (b2, b3)
    ldsm_x4_trans(Vt + (kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + dp * 16 + (lane >> 4) * 8, b0,
                  b1, b2, b3);
    mma_bf16(w.o[2 * dp], ph, b0, b1);
    mma_bf16(w.o[2 * dp], pl, b0, b1);
    mma_bf16(w.o[2 * dp + 1], ph, b2, b3);
    mma_bf16(w.o[2 * dp + 1], pl, b2, b3);
  }
}

// The key groups' states merged into the block's (m, l, acc [ROWS][D],
// acc and l relative to m) at Bs: each warp writes its share of its key
// group's state to W (the ring, free after the loop), one thread a row
// weighs the key groups once, then every thread combines float4 chunks of
// the rows with all its loads in flight (a sequential loop over the 2,048
// outputs left one warp per scheduler waiting on each step).  Every
// thread of the block calls it.
__device__ __forceinline__ void block_state(Warp& w, float* W, float* Bs, int warp, int lane) {
  const int grp = lane >> 2, quad = lane & 3;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 1);
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 2);
  }
  float* Ws = W + (warp % KGROUPS) * WSTATE;
  const int c0 = (warp / KGROUPS) * DW;
  if (quad == 0 && c0 == 0) {  // the key group's warps hold the same (m, l)
    Ws[grp] = w.m[0];
    Ws[grp + 8] = w.m[1];
    Ws[ROWS + grp] = w.l[0];
    Ws[ROWS + grp + 8] = w.l[1];
  }
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    *reinterpret_cast<float2*>(Ws + 2 * ROWS + grp * WLD + c0 + n * 8 + 2 * quad) = make_float2(w.o[n][0], w.o[n][1]);
    *reinterpret_cast<float2*>(Ws + 2 * ROWS + (grp + 8) * WLD + c0 + n * 8 + 2 * quad) =
        make_float2(w.o[n][2], w.o[n][3]);
  }
  __syncthreads();
  float* Wt = W + KGROUPS * WSTATE;  // [ROWS][KGROUPS] the key groups' weights
  if (tid < ROWS) {
    float M = NEG_INF;
#pragma unroll
    for (int v = 0; v < KGROUPS; ++v) M = fmaxf(M, W[v * WSTATE + tid]);
    float ll = 0.f;
#pragma unroll
    for (int v = 0; v < KGROUPS; ++v) {
      const float wt = exp2f(W[v * WSTATE + tid] - M);
      Wt[tid * KGROUPS + v] = wt;
      ll = fmaf(wt, W[v * WSTATE + ROWS + tid], ll);
    }
    Bs[tid] = M;
    Bs[ROWS + tid] = ll;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < ROWS * D / 4 / THREADS; ++c) {
    const int e = tid + c * THREADS;  // float4 chunk: row e / (D / 4)
    const int g = e / (D / 4), d = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < KGROUPS; ++v) {
      const float wt = Wt[g * KGROUPS + v];
      const float4 y = *reinterpret_cast<const float4*>(W + v * WSTATE + 2 * ROWS + g * WLD + d);
      x.x = fmaf(wt, y.x, x.x);
      x.y = fmaf(wt, y.y, x.y);
      x.z = fmaf(wt, y.z, x.z);
      x.w = fmaf(wt, y.w, x.w);
    }
    *reinterpret_cast<float4*>(Bs + 2 * ROWS + g * D + d) = x;
  }
  __syncthreads();  // the block's state is in Bs
}

// x += wt * y, four lanes
__device__ __forceinline__ void fma4(float4& x, float wt, const float4& y) {
  x.x = fmaf(wt, y.x, x.x);
  x.y = fmaf(wt, y.y, x.y);
  x.z = fmaf(wt, y.z, x.z);
  x.w = fmaf(wt, y.w, x.w);
}

// Publish the block's state Bs (STATE floats) at `mine` in the merge
// scratch and take its ticket with acquire-release semantics: the barrier
// before makes the block's writes part of its release, the barrier after
// gives the block what the earlier blocks released.  True in the block
// that takes the last of n_split tickets.
__device__ __forceinline__ bool publish(const float* Bs, float* mine, int* ticket, int n_split) {
  for (int i = threadIdx.x; i < STATE / 4; i += THREADS)
    reinterpret_cast<float4*>(mine)[i] = reinterpret_cast<const float4*>(Bs)[i];
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(t) : "l"(ticket), "r"(1) : "memory");
    last = t == n_split - 1;
  }
  __syncthreads();
  return last;
}

// The merging block's row step: each row's weights of the n_split states
// (from Bs when n_split is 1, else the scratch `parts`, STATE floats
// apart; __ldcg: from L2, not L1), and an extra state of weight exp2(xm -
// M) and sum 1 where xm is not null (the paged kernel's new row).  Row g
// (a thread each) writes Wr[g][r], its max at Mr[g], its sum at Lr[g] and
// the extra state's weight at Xr[g].
template <int MAX_SPLIT>
__device__ __forceinline__ void merge_rows(const float* Bs, const float* parts, int n_split, int GB, const float* xm,
                                           float (*Wr)[MAX_SPLIT], float* Mr, float* Lr, float* Xr) {
  const int g = threadIdx.x;
  if (g < GB) {
    float rm[MAX_SPLIT], rl[MAX_SPLIT];
    if (n_split == 1) {
      rm[0] = Bs[g];
      rl[0] = Bs[ROWS + g];
    } else {
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < n_split) {
          rm[r] = __ldcg(parts + (long)r * STATE + g);
          rl[r] = __ldcg(parts + (long)r * STATE + ROWS + g);
        }
      }
    }
    float M = xm ? xm[g] : NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split) M = fmaxf(M, rm[r]);
    float ll = 0.f;
    if (xm) {
      Xr[g] = exp2f(xm[g] - M);
      ll = Xr[g];
    }
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {
        const float wt = exp2f(rm[r] - M);
        Wr[g][r] = wt;
        ll = fmaf(wt, rl[r], ll);
      }
    }
    Mr[g] = M;
    Lr[g] = ll;
  }
  __syncthreads();
}

// The merged accumulator of float4 chunk (g, d .. d + 3): the n_split
// states weighed by the row step's Wr (x starts as the caller's extra
// state's share).
template <int MAX_SPLIT>
__device__ __forceinline__ float4 merge_acc(const float* Bs, const float* parts, int n_split,
                                            float (*Wr)[MAX_SPLIT], int g, int d, float4 x) {
  if (n_split == 1) {
    fma4(x, Wr[g][0], *reinterpret_cast<const float4*>(Bs + 2 * ROWS + g * D + d));
  } else {
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split)
        fma4(x, Wr[g][r], __ldcg(reinterpret_cast<const float4*>(parts + (long)r * STATE + 2 * ROWS + g * D + d)));
  }
  return x;
}

}  // namespace dmma
}  // namespace dnet
