// Causal prefill attention against a slot-addressed KV cache, for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` (dnet_tpu/ops/flash_attention.py:38,
// launched by `_flash_pallas`): query row i of the chunk attends cache slots
// [0, pos + i]; online softmax (m, l, acc) in f32; per-head sink logits folded
// into the denominator once, at emit.  Layouts are the reference's native ones:
// q [B, T, H, DQK], k [B, S, KVH, DQK], v [B, S, KVH, DV], o [B, T, H, DV];
// head h reads KV head h / G (G = H / KVH).  DV may differ from DQK (MLA:
// deepseek_v2 attends with DQK = 192, nope 128 + rope 64, and DV = 128,
// dnet_tpu/ops/flash_attention.py:42-46): the scores run over DQK, the V
// tile, the accumulator and the output over DV.  Width pairs (DQK, DV):
// (64, 64), (128, 128), (192, 128).
//
// What bounds it on an H100: at prefill widths (T >= 16) the work is
// T * keys * (DQK + DV) multiply-adds per head, far above the card's ~295
// operations a byte, so it is bound by arithmetic: by the tensor cores for
// bf16 inputs, by the CUDA cores' f32 FMAs for f32 inputs.
//
// bf16 inputs (`flash_prefill_tc_kernel`), in the FlashAttention-2 manner:
//   - Heads stacked into rows.  The G query heads that share a KV head fill
//     one tile's rows, packed row = t * G + g, so each K/V byte copied feeds
//     G times the rows and a T = 16 chunk at G = 4 fills a 64-row tile.  A
//     block owns a tile of 64 packed rows of one (batch, KV head), or of 128
//     at (64, 64) when that still gives TC_WIDE_BLOCKS (264) blocks, two an
//     SM: fewer blocks left SMs idle at T <= 512 on the card, more rows a
//     warp paid at T = 2048.  Blocks run the latest (heaviest) row tile
//     first, so the causal imbalance leaves no tail.  ops/flash_attention.py
//     `prefill_plan` states this layout for the CPU tests.
//   - Both products on the tensor cores, mma.sync m16n8k16 bf16 -> f32, with
//     operands loaded by ldmatrix (.trans for V).  Each of 4 warps owns one
//     or two 16-row m-atoms (each K/V fragment loaded then feeds both) and
//     keeps their Q fragments in registers for the whole key loop; S = Q K^T
//     accumulates in f32 registers; P is packed to bf16 in registers and fed
//     straight back as the A operand of P V; O stays in f32 registers.
//   - K/V tiles of 64 keys stay bf16 in shared memory, two stages deep, each
//     copied with 16-byte cp.async, so the next tile's copy overlaps this
//     tile's products; rows are padded by 16 bytes so that ldmatrix is free
//     of bank conflicts.  Keys at or past the block's last attended slot and
//     rows past T * G are zero-filled, never read: a dead cache slot (any bit
//     pattern, NaN included) never meets a zero of P.  Shared memory:
//     46,080 bytes at (64, 64) (55,296 with 128-row tiles), 87,040 at
//     (128, 128), 111,616 at (192, 128): two blocks an SM.
//   - Masks only where needed: key tiles wholly at or below every row's
//     causal limit take none; the diagonal tile and the T and S edges are
//     masked in registers; a warp skips the tiles wholly past its own rows,
//     and the block's loop stops at pos + (its last row's t).
//   - The softmax in registers: the row max over the raw f32 scores, then
//     p = 2^(s * scale * log2(e) - m * scale * log2(e)): one FMA and one
//     ex2.approx (relative error about 2^-22) a score.
//   Rounding: q and k enter the product as they are stored (products exact,
//   summed in f32 in another order than the plain version); the softmax
//   scale multiplies the f32 scores, never q in bf16; P rounded to bf16 for
//   the P V product is the one rounding the plain version, which keeps p in
//   f32, does not make.  The row sums l are taken from the unrounded p.
//
// f32 inputs (`flash_prefill_f32_kernel`): the exact CUDA-core fold of the
// port's first version (TF32 would keep 10 mantissa bits): a 64-row Q tile of
// one head in shared memory, q pre-scaled, 64-key K/V tiles widened to f32
// past it; each thread computes a 4x4 register tile of scores and a 4-row
// slice of the output, so shared-memory loads are amortised over 16 (QK) and
// 4*DV/16 (PV) multiply-adds.  155,648 bytes of shared memory at (192, 128).
//
// TPU -> GPU translation: the TPU's sequential last grid axis (kv tiles, with
// the accumulator in VMEM scratch) becomes a loop inside the block; the
// above-diagonal `pl.when` skip becomes the loop bound pos + (last row of the
// q tile), which also stops before dead cache slots; ragged T and S edges are
// masked here instead of being refused by a tiling gate.

#include "mma.cuh"

namespace {

using dnet::NEG_INF;
using dnet::cp_async16;
using dnet::cp_commit;
using dnet::cp_wait;
using dnet::bf16;
using dnet::ex2;
using dnet::ldsm_x4;
using dnet::ldsm_x4_trans;
using dnet::mma_bf16;
using dnet::pack_bf16;

constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int TC_KEYS = 64;    // keys a tile
constexpr int TC_WARPS = 4;    // 16 * MA packed rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_WIDE_BLOCKS = 2 * 132;  // 128-row tiles at (64, 64) from this many blocks

// MA: 16-row m-atoms a warp owns (a block's tile is 64 * MA packed rows)
template <int DQK, int DV, int MA>
struct TcLayout {
  static constexpr int ROWS = TC_WARPS * 16 * MA;
  // bf16 elements; every row padded by 8 (16 bytes), so the 8 rows one
  // ldmatrix reads start in 8 different 16-byte bank groups
  static constexpr int LDQ = DQK + 8;
  static constexpr int LDV = DV + 8;
  static constexpr int Q_ELEMS = ROWS * LDQ;
  static constexpr int K_ELEMS = TC_KEYS * LDQ;
  static constexpr int V_ELEMS = TC_KEYS * LDV;
  static constexpr int STAGE = K_ELEMS + V_ELEMS;
  static constexpr int STAGES = 2;
  static constexpr size_t BYTES = (size_t)(Q_ELEMS + STAGES * STAGE) * sizeof(bf16);
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");
};

// (mma.cuh notes the fragment layouts: the C fragments of two
// neighbouring 8-key score tiles are, packed to bf16, the A fragment of P
// over those 16 keys.)
template <int DQK, int DV, int MA>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        const float* __restrict__ sinks, int T_len, int H, int KVH, int S, int pos,
                        float scale, int row_tiles) {
  using L = TcLayout<DQK, DV, MA>;
  constexpr int ROWS = L::ROWS, STAGES = L::STAGES;
  constexpr int NT = TC_KEYS / 8;  // 8-key score tiles a key tile
  constexpr int KQ = DQK / 16;     // 16-deep steps of Q K^T
  constexpr int NO = DV / 8;       // 8-column output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + L::Q_ELEMS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, quad = lane & 3;
  const int G = H / KVH;
  const int rows = T_len * G;
  // prefill_plan's order: block i takes row tile row_tiles - 1 - i / (KVH * B)
  const int groups = gridDim.x / row_tiles;
  const int tile = row_tiles - 1 - (int)(blockIdx.x / groups);
  const int kvh = (int)(blockIdx.x % groups) % KVH;
  const int b = (int)(blockIdx.x % groups) / KVH;
  const int r0 = tile * ROWS;
  const int t_last = (min(r0 + ROWS, rows) - 1) / G;
  const int key_end = pos + t_last + 1;  // <= S: the wrapper checks pos + T <= S
  const int n_tiles = (key_end + TC_KEYS - 1) / TC_KEYS;

  const long k_stride = (long)KVH * DQK;
  const long v_stride = (long)KVH * DV;
  const bf16* kb = k + ((long)b * S * KVH + kvh) * DQK;
  const bf16* vb = v + ((long)b * S * KVH + kvh) * DV;

  // Q rows, zero past T * G; then K/V tiles, zero at and past key_end
  constexpr int QC = DQK / 8, VC = DV / 8;  // 16-byte chunks a row
  for (int i = tid; i < ROWS * QC; i += TC_THREADS) {
    const int r = i / QC, c = i % QC;
    const int R = r0 + r;
    const bool ok = R < rows;
    const bf16* src = ok ? q + (((long)b * T_len + R / G) * H + (long)kvh * G + R % G) * DQK + c * 8 : q;
    cp_async16(Qs + r * L::LDQ + c * 8, src, ok);
  }
  auto load_kv = [&](int kt) {
    bf16* st = ring + (kt % STAGES) * L::STAGE;
    const int k0 = kt * TC_KEYS;
    for (int i = tid; i < TC_KEYS * QC; i += TC_THREADS) {
      const int j = i / QC, c = i % QC;
      const bool ok = k0 + j < key_end;
      cp_async16(st + j * L::LDQ + c * 8, ok ? kb + (long)(k0 + j) * k_stride + c * 8 : kb, ok);
    }
    bf16* vs = st + L::K_ELEMS;
    for (int i = tid; i < TC_KEYS * VC; i += TC_THREADS) {
      const int j = i / VC, c = i % VC;
      const bool ok = k0 + j < key_end;
      cp_async16(vs + j * L::LDV + c * 8, ok ? vb + (long)(k0 + j) * v_stride + c * 8 : vb, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st);
    cp_commit();
  }

  // this warp's 16 * MA rows: the thread holds rows grp and grp + 8 of each m-atom
  const int wr0 = r0 + warp * 16 * MA;
  const bool active = wr0 < rows;
  const int wt_first = wr0 / G;
  const int wt_last = (min(wr0 + 16 * MA, rows) - 1) / G;
  const int warp_tiles = active ? (pos + wt_last) / TC_KEYS + 1 : 0;
  const int warp_full = (pos + wt_first + 1) / TC_KEYS;  // tiles [0, warp_full) need no mask
  int q_lim[MA][2];
#pragma unroll
  for (int a = 0; a < MA; ++a) {
    q_lim[a][0] = pos + (wr0 + 16 * a + grp) / G;
    q_lim[a][1] = pos + (wr0 + 16 * a + grp + 8) / G;
  }
  const float sl2 = scale * LOG2E;

  unsigned qf[MA][KQ][4];
  float oacc[MA][NO][4];
  float m[MA][2], l[MA][2];  // l: this thread's share of its rows' sums
#pragma unroll
  for (int a = 0; a < MA; ++a) {
#pragma unroll
    for (int n = 0; n < NO; ++n) oacc[a][n][0] = oacc[a][n][1] = oacc[a][n][2] = oacc[a][n][3] = 0.f;
    m[a][0] = m[a][1] = NEG_INF;
    l[a][0] = l[a][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile kt (and Q) have landed
    __syncthreads();        // everyone's have, and tile kt - 1's stage is free
    if (kt == 0) {
#pragma unroll
      for (int a = 0; a < MA; ++a)
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          ldsm_x4(Qs + (warp * 16 * MA + 16 * a + (lane & 15)) * L::LDQ + kk * 16 + (lane >> 4) * 8, qf[a][kk][0],
                  qf[a][kk][1], qf[a][kk][2], qf[a][kk][3]);
    }
    if (kt + STAGES - 1 < n_tiles) load_kv(kt + STAGES - 1);
    cp_commit();
    if (kt >= warp_tiles) continue;
    const bf16* Ks = ring + (kt % STAGES) * L::STAGE;
    const bf16* Vs = Ks + L::K_ELEMS;

    float s[MA][NT][4];
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int n = 0; n < NT; ++n) s[a][n][0] = s[a][n][1] = s[a][n][2] = s[a][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b0, b1, b2, b3;  // one K fragment feeds every m-atom
        ldsm_x4(Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * L::LDQ + kk * 16 + ((lane >> 3) & 1) * 8, b0,
                b1, b2, b3);
#pragma unroll
        for (int a = 0; a < MA; ++a) {
          mma_bf16(s[a][2 * np], qf[a][kk], b0, b1);
          mma_bf16(s[a][2 * np + 1], qf[a][kk], b2, b3);
        }
      }
    }

    // the diagonal tile and the T / S edges masked; the row max on raw scores
    const bool masked = kt >= warp_full;
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked && kt * TC_KEYS + n * 8 + 2 * quad + (e & 1) > q_lim[a][e >> 1]) s[a][n][e] = NEG_INF;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[a][n][e]);
        }
      float corr[2], ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the 4 lanes of a row are quad 0..3 of one grp
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[a][i], mt[i]);
        corr[i] = ex2((m[a][i] - m_new) * sl2);
        m[a][i] = m_new;
        ms[i] = m_new * sl2;
        l[a][i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        oacc[a][n][0] *= corr[0];
        oacc[a][n][1] *= corr[0];
        oacc[a][n][2] *= corr[1];
        oacc[a][n][3] *= corr[1];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[a][n][e], sl2, -ms[e >> 1]));
          s[a][n][e] = p;
          l[a][e >> 1] += p;
        }
    }

    // O += P V, P in bf16 straight from the score registers
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
      unsigned pa[MA][4];
#pragma unroll
      for (int a = 0; a < MA; ++a) {
        pa[a][0] = pack_bf16(s[a][2 * kk][0], s[a][2 * kk][1]);
        pa[a][1] = pack_bf16(s[a][2 * kk][2], s[a][2 * kk][3]);
        pa[a][2] = pack_bf16(s[a][2 * kk + 1][0], s[a][2 * kk + 1][1]);
        pa[a][3] = pack_bf16(s[a][2 * kk + 1][2], s[a][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LDV + dp * 16 + (lane >> 4) * 8,
                      b0, b1, b2, b3);
#pragma unroll
        for (int a = 0; a < MA; ++a) {
          mma_bf16(oacc[a][2 * dp], pa[a], b0, b1);
          mma_bf16(oacc[a][2 * dp + 1], pa[a], b2, b3);
        }
      }
    }
  }
  if (!active) return;

  // emit: fold the sink (NEG_INF = none) into the denominator exactly once
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[a][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int R = wr0 + 16 * a + grp + 8 * i;
      if (R >= rows) continue;
      const int t = R / G, h = kvh * G + R % G;
      const float sink = sinks ? sinks[h] * LOG2E : NEG_INF;
      const float m2 = m[a][i] * sl2;
      const float m_fin = fmaxf(m2, sink);
      const float c = exp2f(m2 - m_fin);
      const float inv = c / fmaxf(li * c + exp2f(sink - m_fin), 1e-30f);
      bf16* orow = o + (((long)b * T_len + t) * H + h) * DV + 2 * quad;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(oacc[a][n][2 * i] * inv, oacc[a][n][2 * i + 1] * inv);
    }
}

template <int DQK, int DV, int MA>
int launch_tc_tiles(const void* q, const void* k, const void* v, void* o, const float* sinks, int B,
                    int T_len, int H, int KVH, int S, int pos, float scale, cudaStream_t stream) {
  using L = TcLayout<DQK, DV, MA>;
  const size_t smem = L::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_tc_kernel<DQK, DV, MA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (T_len * (H / KVH) + L::ROWS - 1) / L::ROWS;
  const long blocks = (long)row_tiles * KVH * B;
  if (blocks > 0x7fffffffL) return -1;
  flash_prefill_tc_kernel<DQK, DV, MA><<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sinks, T_len, H, KVH, S, pos, scale, row_tiles);
  return (int)cudaGetLastError();
}

// prefill_plan's choice: at (64, 64), 128-row tiles (two m-atoms a warp: each
// K/V fragment feeds two products) once they still give TC_WIDE_BLOCKS
// blocks, two an SM; 64-row tiles otherwise, and at the wider pairs, whose
// registers hold one m-atom a warp
template <int DQK, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o, const float* sinks, int B,
              int T_len, int H, int KVH, int S, int pos, float scale, cudaStream_t stream) {
  if constexpr (DQK == 64 && DV == 64) {
    constexpr int WIDE = TcLayout<DQK, DV, 2>::ROWS;
    const long wide_blocks = (long)((T_len * (H / KVH) + WIDE - 1) / WIDE) * KVH * B;
    if (wide_blocks >= TC_WIDE_BLOCKS)
      return launch_tc_tiles<DQK, DV, 2>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, stream);
  }
  return launch_tc_tiles<DQK, DV, 1>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, stream);
}

// ---- f32: CUDA-core FMAs -----------------------------------------------------

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

template <int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         const float* __restrict__ sinks, int T_len, int H, int KVH, int S, int pos,
                         float scale) {
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
  const float* qb = q + (((long)b * T_len + q0) * H + h) * DQK;
  const float* kb = k + ((long)b * S * KVH + kvh) * DQK;
  const float* vb = v + ((long)b * S * KVH + kvh) * DV;

  dnet::stage_tile<float, DQK, BQ, true>(Qs, L::LDQ, qb, q_stride, q_rows, scale);

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
    const int kv_rows = min(BK, key_end - k0);  // zeros at and past key_end: no dead slot is read
    dnet::stage_tile<float, DQK, BK, true>(Ks, L::LDK, kb + (long)k0 * k_stride, k_stride, kv_rows, 1.f);
    dnet::stage_tile<float, DV, BK, false>(Vs, L::LDV, vb + (long)k0 * v_stride, v_stride, kv_rows, 1.f);
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
    float* orow = o + (((long)b * T_len + row) * H + h) * DV + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = acc[i][c] * corr / l_fin;
  }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, const float* sinks, int B,
               int T_len, int H, int KVH, int S, int pos, float scale, cudaStream_t stream) {
  const size_t smem = Layout<DQK, DV>::BYTES;
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so on every launch: the call is cheap and does not synchronise)
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_f32_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_prefill_f32_kernel<DQK, DV><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sinks, T_len, H, KVH, S, pos, scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, const float* sinks,
           int B, int T_len, int H, int KVH, int S, int pos, float scale, cudaStream_t st) {
  if (dtype == dnet::DTYPE_BF16)
    return launch_tc<DQK, DV>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  if (dtype == dnet::DTYPE_F32)
    return launch_f32<DQK, DV>(q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
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
  if (head_dim == 64 && v_head_dim == 64)
    return launch<64, 64>(dtype, q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  if (head_dim == 128 && v_head_dim == 128)
    return launch<128, 128>(dtype, q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  if (head_dim == 192 && v_head_dim == 128)
    return launch<192, 128>(dtype, q, k, v, o, sinks, B, T_len, H, KVH, S, pos, scale, st);
  return -1;
}
