// Flash attention (prefill / forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (body _fa_kernel).  Same contract: q (B,Sq,Hq,hd),
// k/v (B,Sk,Hkv,hd) -> o (B,Sq,Hq,hd); queries aligned to the end of K
// (q_pos = i + Sk - Sq); optional causal and sliding-window masks; GQA by
// mapping q-head h to kv-head h / (Hq/Hkv); K/V rows past Sk read as zeros;
// scores scaled by 1/sqrt(hd); an online softmax in float32 with the finite
// mask value -1e30; l floored at 1e-30.  Output in q's dtype.
//
// Bound on an H100: at the serving shape (minicpm-2b, batch 8, S = 512,
// causal, bf16) the function moves 4 x 18.9 MB of q/k/v/o (about 22.5 us at
// 3.35 TB/s) and does about 9.7 GFLOP (about 9.8 us at the bf16 tensor-core
// peak), so the card's bound is the memory traffic.
//
// Three bodies; the wrapper picks one (kernels/flash_attention.py,
// flash_body) and passes it to the C launcher below, which refuses a body
// at a head dim it was not built for:
//
// * bf16, two bodies with both products on the tensor cores.  S = Q K^T
//   is a wgmma m64nNk16 with Q and K in shared memory, both K-major; P V
//   is a wgmma m64nNk16 with P in registers (the S accumulator fragment
//   converted to bf16 lines up with the A-operand fragment, as in
//   FlashAttention-3) and V in shared memory, MN-major (transpose bit).
//   Each consumer warpgroup owns 64 q rows and every output column of
//   them, so it computes S only for its own rows: QK^T runs once per (q
//   row, key tile).  Tiles sit in shared memory as bf16 in 64-column
//   (128-byte) panels with the 128-byte swizzle the descriptors name;
//   narrower head dims are padded with zeros to whole panels.  Loads are
//   TMA copies: one 4-D tensor map per operand over the (B,S,H,hd) layout
//   with its own strides, whose zero fill gives the rows past Sk and the
//   padding columns.  One thread issues them by predicated instructions
//   that its whole warp runs (hopper.cuh), never behind a branch that
//   splits a warp ahead of a wgmma.  Each iteration issues S of tile j and
//   P V of tile j - 1 together and runs the softmax of tile j while P V is
//   on the tensor cores (FlashAttention-3's intra-warpgroup overlap).  The
//   online softmax runs on the accumulator fragments (quad shuffles).  Dead
//   tiles are skipped with _fa_kernel's tile test; only tiles that straddle
//   the diagonal, the window edge or Sk are masked.  q tiles run
//   heaviest-first, so the causal tail is short.
//   - hd 32 to 128 (fa_persist): one CTA an SM (193 KB of shared memory
//     at hd 128, 97 KB at hd 64, whose 384 threads of 168 registers fill
//     the register file), so a CTA that ran one q tile left its SM with
//     nothing else to run while it loaded its Q and stored its O.  The CTA
//     is persistent: the grid is at most one CTA an SM (flash_ctas), and
//     each CTA walks work tiles of 128 q rows of one head and batch row,
//     heaviest first, forwards and backwards through the grid's rounds in
//     turn, in one of two orders (flash_order: the heads fastest, or each
//     KV head's tiles together where the K/V outgrows the L2).  A CTA is
//     two consumer warpgroups and a producer warpgroup, whose registers
//     setmaxnreg hands to the consumers (232 a thread).  K/V tiles are 128
//     keys (S is m64n128k16: at 64 keys S's k-steps read as many shared-
//     memory bytes as the card's shared memory delivers, and the per-tile
//     softmax work was paid twice as often).  One producer warp streams the
//     K and V tiles of all the CTA's work tiles through a two-stage ring
//     each (at hd 64, three or four stages measured no faster), whose
//     index runs on across work tiles; each stage's "full"
//     barrier completes with its TMA bytes, its "empty" barrier with one
//     arrival of each of the eight consumer warps (K once S has read it, V
//     once P V has), so the next tile's first K/V loads run under the
//     current tile's last products and epilogue.  Each consumer warpgroup
//     loads its own 64 q rows into one of two Q slots, the next work
//     tile's during the current one's first K/V tile (at hd 64 four slots,
//     the Q two tiles ahead, measured no faster); O is staged into the
//     finished tile's slot and stored by TMA, and the store is waited on
//     only before that slot takes a new Q.  (Issuing a work tile's last
//     P V beside the next tile's first S, and its store after that tile's
//     first softmax, measured 1-2 % slower at bucket 8, at hd 64 and 128.)
//     The two consumer warpgroups
//     take turns to issue their products (two named barriers,
//     FlashAttention-3's ping-pong), so one's softmax runs under the
//     other's wgmma, and the exponent is one fused multiply-add
//     (online_softmax<true>).  At hd 32 and 64, Q, K and O are one panel
//     and P V is m64n64k16 into 32 registers; at hd 96 S takes 6 k-steps
//     and P V is m64n96k16 into 48 registers, with V in 32-column panels
//     under the 64-byte swizzle (a 96-column MN-major operand is whole
//     atoms of 32 columns, not of 64); hd 72 keeps 128 columns of P V (5
//     k-steps of S), since it runs only in reduced configs.
//   - hd 256 (fa_hd256, gemma3): FlashAttention-3's hd 256 layout without
//     its producer warp.  Each warpgroup holds the 64 x 256 f32 output
//     accumulator (128 registers a thread) beside S (32) and P (16): 202
//     registers, under the 255 that one CTA of 256 threads an SM leaves,
//     so no setmaxnreg is needed.  K/V tiles are 64 keys, and K and V have
//     rings of their own, two stages each: Q (32 KB a warpgroup) + 2 x (32
//     + 32) KB fits the 227 KB a CTA may have.  At the top of tile j, after
//     one CTA barrier, thread 0 refills the K stage that tile j - 1 left
//     (with tile j + 1) and the V stage that tile j - 2 left (with tile j),
//     so every load has one whole tile's products to land in.  (A producer
//     warpgroup with setmaxnreg and "empty" barriers in place of the CTA
//     barrier measured no faster at 128 rows and slower at 64, and was not
//     kept: at bucket 8 the grid is under one wave, so no next tile has
//     loads to overlap.)  The CTA is 128 q rows (two warpgroups) or 64
//     (one): the wrapper takes 64 where the 64-row grid fits one CTA per SM
//     (batch 1), 128 elsewhere (kernels/flash_attention.py, flash_block_q).
// * float32, fa_kernel_f32: the CUDA-core kernel of the port's first
//   version.  Full-f32 products are what the f32 tolerance needs (TF32 would
//   not meet it); f32 is on no serving path.
#include <cuda.h>

#include <cmath>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using repro::NEG_INF;

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------
// Grid: one block of 256 threads per (64-row q tile, q head, batch row).
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4*ty .. 4*ty+3 of the
// tile, score columns tx + 16*j and output columns tx + 16*c.
namespace f32core {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int HD>
struct Layout {
  static constexpr int QS = HD + 1;  // odd strides: conflict-free column reads
  static constexpr int KS = HD + 1;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int NC = (HD + 15) / 16;  // output columns per thread
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NT)
    fa_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int Hq, int Hkv, int causal, int window,
                  float scale) {
  using Lt = Layout<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * Lt::QS;
  float* Vs = Ks + BK * Lt::KS;
  float* Ps = Vs + BK * Lt::VS;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long q_row = (long)Hq * HD;   // elements between sequence positions
  const long kv_row = (long)Hkv * HD;
  const float* qb = q + (long)b * Sq * q_row + (long)h * HD;
  const float* kb = k + (long)b * Sk * kv_row + (long)hk * HD;
  const float* vb = v + (long)b * Sk * kv_row + (long)hk * HD;
  float* ob = o + (long)b * Sq * q_row + (long)h * HD;

  const int q0 = iq * BQ;
  repro::load_tile<float, HD, NT>(Qs, Lt::QS, qb + (long)q0 * q_row, q_row,
                                  min(BQ, Sq - q0), BQ, scale, tid);

  float acc[4][Lt::NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Lt::NC; ++c) acc[i][c] = 0.f;
  }

  // the tile-skip test of _fa_kernel, on 64-row tiles
  const int first_q = q0 + (Sk - Sq);
  const int last_q = first_q + BQ - 1;
  const int nk = (Sk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int first_k = ik * BK;
    if (causal && first_k > last_q) break;  // every later tile is dead too
    if (window > 0 && first_q - (first_k + BK - 1) >= window) continue;

    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    const int kv_valid = min(BK, Sk - first_k);
    repro::load_tile<float, HD, NT>(Ks, Lt::KS, kb + (long)first_k * kv_row,
                                    kv_row, kv_valid, BK, 1.f, tid);
    repro::load_tile<float, HD, NT>(Vs, Lt::VS, vb + (long)first_k * kv_row,
                                    kv_row, kv_valid, BK, 1.f, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * Lt::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * Lt::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = first_q + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = first_k + tx + 16 * j;
        bool live = kp < Sk;
        if (causal) live = live && qp >= kp;
        if (window > 0) live = live && (qp - kp) < window;
        if (!live) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * Lt::PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Lt::NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * Lt::PS + kk];
#pragma unroll
      for (int c = 0; c < Lt::NC; ++c) {
        const int d = tx + 16 * c;
        if (d < HD) {
          const float vv = Vs[kk * Lt::VS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < Lt::NC; ++c) {
      const int d = tx + 16 * c;
      if (d < HD) ob[(long)r * q_row + d] = acc[i][c] / den;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_kernel_f32<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv,
      causal, window, (float)(1.0 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace f32core

// --------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// --------------------------------------------------------------------------
namespace wg {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;
constexpr int BQ = 128;     // q rows a persistent work tile
constexpr int BK = 64;      // keys per K/V tile at hd 256

// hd 32..128 (fa_persist): K/V tiles of 128 keys; Q, K and O in 64-column
// panels, one at hd <= 64 and two above (hd 32 and 72 padded with zeros);
// V in as many such panels, or at hd 96 in three 32-column panels under
// the 64-byte swizzle; K and V in two-stage rings of their own
template <int HD>
struct CfgP {
  static_assert(HD % 8 == 0 && HD <= 128, "fa_persist takes hd 32 to 128");
  static constexpr int KEYS = 128;                 // keys per K/V tile
  static constexpr int PANELS = (HD + 63) / 64;    // of Q, K and O
  static constexpr int KSTEPS = (HD + 15) / 16;    // k-steps of S = Q K^T
  static constexpr bool V32 = HD == 96;            // V panels of 32 columns
  static constexpr int PV_N = V32 ? 96 : 64 * PANELS;  // columns of P V
  static constexpr int V_COLS = V32 ? 32 : 64;     // columns a V panel
  static constexpr int V_PANELS = PV_N / V_COLS;
  static constexpr int V_PANEL = KEYS * V_COLS * 2;  // bytes of a V panel
  static constexpr int QH_BYTES = 64 * 128 * PANELS;  // a warpgroup's q rows
  static constexpr int K_BYTES = KEYS * 128 * PANELS;
  static constexpr int V_BYTES = V_PANELS * V_PANEL;
  // Q: 2 slots x 2 warpgroups; the rings; +1024: the base is rounded up to
  // the swizzle atom; 12 barriers
  static constexpr int SMEM =
      4 * QH_BYTES + 2 * (K_BYTES + V_BYTES) + 1024 + 8 * 12;
  static constexpr int NT = 384;    // two consumer warpgroups, a producer
};

// hd 256: NWG warpgroups of 64 q rows; K and V in two-stage rings of their
// own; barriers: K full x 2, V full x 2, Q
template <int NWG>
struct Cfg256 {
  static constexpr int ROWS = 64 * NWG;
  static constexpr int Q_BYTES = ROWS * 256 * 2;
  static constexpr int T_BYTES = BK * 256 * 2;     // one K or V tile
  static constexpr int SMEM = Q_BYTES + 4 * T_BYTES + 1024 + 8 * 5;
};

// O += P V over one tile of KEYS keys: P's fragment for keys
// 16kk..16kk+15 is pk[4kk .. 4kk+3]; V at va, MN-major, in panels of 64
// columns (128-byte swizzle) or, with V32, of 32 columns (64-byte swizzle)
template <bool V32 = false, int KEYS = BK, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&pk)[KEYS / 4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint32_t pa[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                            pk[4 * kk + 3]};
    if constexpr (V32)
      wgmma_rs<1>(acc, pa,
                  make_desc(va + kk * (16 * 64), KEYS * 64, 512, 2));
    else
      wgmma_rs<1>(acc, pa,
                  make_desc(va + kk * (16 * 128), KEYS * 128, 1024));
  }
  wgmma_commit();
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The live K/V tiles of `bk` keys of a CTA whose q rows start at first_q:
// [lo, hi), the tile-skip test of _fa_kernel
struct TileRange {
  int lo, hi;
  __device__ TileRange(int first_q, int rows, int Sk, int causal, int window,
                       int bk = BK) {
    const int last_q = first_q + rows - 1;
    const int nk = (Sk + bk - 1) / bk;
    hi = nk;
    if (causal) hi = last_q < 0 ? 0 : min(nk, last_q / bk + 1);
    lo = 0;
    if (window > 0)
      while (lo < hi && first_q - (lo * bk + bk - 1) >= window) ++lo;
  }
};

// The online softmax of one 64 x 2N score tile s (accumulator fragment, N
// registers: 64 keys, or 128 in the persistent body) of
// the rows qp0 / qp1 = qp0 + 8: masks where the tile straddles Sk, the
// diagonal or the window, updates (m, l) and leaves P = exp2((s - m) *
// scale) in s; returns the factors a0 / a1 by which O's rows rescale.
// Scores stay unscaled until the exponent (the scale is positive, so the
// row max commutes with it).
// With FMA the exponent is one fused multiply-add, s * scale - m * scale;
// a row whose keys so far are all masked then takes P = 0 (its m * scale
// is read as 0), not the exact (s - m) = 0 of the two-step form.
template <bool FMA = false, int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], int first_k, int first_q, int last_q, int qp0, int Sk,
    int causal, int window, float scale_log2, int lane, float& m0, float& m1,
    float& l0, float& l1, float& a0, float& a1) {
  constexpr int KEYS = 2 * N;
  const int qp1 = qp0 + 8;
  const bool edge = first_k + KEYS > Sk ||
                    (causal && first_k + KEYS - 1 > first_q) ||
                    (window > 0 && last_q - first_k >= window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kp = first_k + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int qp = (i & 2) ? qp1 : qp0;
      bool live = kp < Sk;
      if (causal) live = live && qp >= kp;
      if (window > 0) live = live && qp - kp < window;
      if (!live) s[i] = NEG_INF;
    }
  }
  // row r: registers i with (i & 2) == 0; row r + 8: the others.  Four
  // partial maxima / sums a row keep the dependent chains short.
  float mx[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[0][j] = fmaxf(s[8 * j], s[8 * j + 1]);
    mx[1][j] = fmaxf(s[8 * j + 2], s[8 * j + 3]);
    mx[0][j] = fmaxf(mx[0][j], fmaxf(s[8 * j + 4], s[8 * j + 5]));
    mx[1][j] = fmaxf(mx[1][j], fmaxf(s[8 * j + 6], s[8 * j + 7]));
  }
#pragma unroll
  for (int j = 4; j < N / 8; ++j) {
    mx[0][j & 3] = fmaxf(mx[0][j & 3], fmaxf(s[8 * j], s[8 * j + 1]));
    mx[1][j & 3] = fmaxf(mx[1][j & 3], fmaxf(s[8 * j + 2], s[8 * j + 3]));
    mx[0][j & 3] = fmaxf(mx[0][j & 3], fmaxf(s[8 * j + 4], s[8 * j + 5]));
    mx[1][j & 3] = fmaxf(mx[1][j & 3], fmaxf(s[8 * j + 6], s[8 * j + 7]));
  }
  const float mn0 = fmaxf(m0, quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]),
                                             fmaxf(mx[0][2], mx[0][3]))));
  const float mn1 = fmaxf(m1, quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]),
                                             fmaxf(mx[1][2], mx[1][3]))));
  a0 = fast_exp2((m0 - mn0) * scale_log2);
  a1 = fast_exp2((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  // (s - m) * scale, not an fma: a masked score minus a masked max is
  // exactly 0, so a row whose processed keys are all masked averages them
  float rs[2][4] = {};
  const float mc0 = mn0 == NEG_INF ? 0.f : mn0 * scale_log2;
  const float mc1 = mn1 == NEG_INF ? 0.f : mn1 * scale_log2;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p =
        FMA ? fast_exp2(fmaf(s[i], scale_log2, -((i & 2) ? mc1 : mc0)))
            : fast_exp2((s[i] - ((i & 2) ? mn1 : mn0)) * scale_log2);
    s[i] = p;
    rs[(i >> 1) & 1][(i >> 3) & 3] += p;
  }
  const float rs0 = (rs[0][0] + rs[0][1]) + (rs[0][2] + rs[0][3]);
  const float rs1 = (rs[1][0] + rs[1][1]) + (rs[1][2] + rs[1][3]);
  l0 = l0 * a0 + rs0;              // per-thread partial; quad-summed at end
  l1 = l1 * a1 + rs1;
}

// O / l of one warpgroup's 64 rows (accumulator fragments of N columns
// starting at col0) into shared memory at `so` (row 0 of its rows, panels
// `panel` bytes apart), in the swizzled panel layout of the tensor maps
template <int N>
__device__ __forceinline__ void stage_out(const float (&acc)[N], int col0,
                                          uint32_t so, int panel, float d0,
                                          float d1, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int r = warp * 16 + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = col0 + 8 * (i >> 2) + 2 * (lane & 3);
    const float dn = (i & 2) ? d1 : d0;
    const uint32_t addr = so + (col >> 6) * panel + r * 128 +
                          ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                 "r"(pack_bf16(acc[i] * dn, acc[i + 1] * dn))
                 : "memory");
  }
}

// hd 32..128: a persistent CTA of two consumer warpgroups (64 q rows each)
// and a producer warpgroup (header).  Work tiles are 128 q rows of one head
// and batch row, numbered (tile_of) heads fastest, so the G heads of one KV
// head run side by side and share its K/V in L2, then batch rows, then the
// q tile, reversed, so the heaviest tiles come first; or, with GROUPS,
// each KV head's G x nq tiles together (the G heads fastest, then the q
// tile, reversed), where the launch's K/V would not stay in L2 over the
// rounds of the first order (flash_order).  Round j of the grid takes tiles
// j * gridDim.x to (j + 1) * gridDim.x - 1, CTA c the c-th of them in even
// rounds and the c-th from the end in odd ones (work, below).
template <int HD, bool GROUPS>
__device__ __forceinline__ void fa_persist(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* to, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, float scale_log2) {
  using C = CfgP<HD>;
  constexpr int KEYS = C::KEYS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;              // slot s, warpgroup g: + (2s+g)*QH
  const uint32_t sK = sQ + 4 * C::QH_BYTES;            // stage s at + s*K
  const uint32_t sV = sK + 2 * C::K_BYTES;             // stage s at + s*V
  // barriers, 8 bytes each: K full x 2, K empty x 2, V full x 2, V empty
  // x 2, Q (slot s, warpgroup g: 2s+g) x 4
  const uint32_t kfull = sV + 2 * C::V_BYTES, kempty = kfull + 16;
  const uint32_t vfull = kempty + 16, vempty = vfull + 16;
  const uint32_t qbar = vempty + 16;

  const int tid = threadIdx.x;
  const int nq = (Sq + BQ - 1) / BQ;
  const int tiles = nq * Hq * B;
  const int group = Hq / Hkv;
  for (int i = 0; i < 2; ++i) {
    mbar_init(kfull + 8 * i, 1, tid == 0);
    mbar_init(vfull + 8 * i, 1, tid == 0);
    mbar_init(kempty + 8 * i, 8, tid == 0);    // the eight consumer warps
    mbar_init(vempty + 8 * i, 8, tid == 0);
  }
  for (int i = 0; i < 4; ++i) mbar_init(qbar + 8 * i, 1, tid == 0);
  fence_mbar_init();
  __syncthreads();

  // work tile w's q tile, head and batch row
  auto tile_of = [&](int w, int& iq, int& h, int& b) {
    if constexpr (GROUPS) {
      const int t = w / group;
      iq = nq - 1 - t % nq;
      h = (t / nq) % Hkv * group + w % group;
      b = t / (nq * Hkv);
    } else {
      h = w % Hq;
      b = (w / Hq) % B;
      iq = nq - 1 - w / (Hq * B);
    }
  };
  // this CTA's j-th work tile (>= tiles past the last round)
  auto work = [&](int j) {
    const int c = j & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return j * gridDim.x + c;
  };

  // the warp's index, read from lane 0 so that the compiler sees it is the
  // same across the warp: a role branch on threadIdx.x alone leaves the
  // consumers' wgmma on a path it must take as divergent, and ptxas then
  // serialises them (C7520)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp_id >= 8) {
    // The producer warpgroup gives up its registers to the consumers
    // (setmaxnreg: 128 x 40 + 256 x 232 of the 384 x 168 the launch
    // bounds leave) and its first warp issues the loads: the K and V tiles
    // of this CTA's work tiles, in the order the consumers read them, the
    // n-th into stage n % 2 of its ring once both warpgroups have released
    // that stage's tile before (the first pass waits on the phase before a
    // fresh barrier's, which has passed).  K n + 1 follows V n, which
    // waits for P V of n - 2.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp_id > 8) return;
    const bool lead = tid == 256;
    int n = 0;
    for (int j = 0, w = work(0); w < tiles; w = work(++j)) {
      int iq, h, b;
      tile_of(w, iq, h, b);
      const int hk = h / group;
      const TileRange live(iq * BQ + (Sk - Sq), BQ, Sk, causal, window,
                           KEYS);
      for (int ik = live.lo; ik < live.hi; ++ik, ++n) {
        const int st = n & 1, phase = ((n >> 1) & 1) ^ 1;
        mbar_wait(kempty + 8 * st, phase);
        mbar_expect_tx(kfull + 8 * st, C::K_BYTES, lead);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma_load4(sK + st * C::K_BYTES + p * (KEYS * 128), tk, 64 * p, hk,
                    ik * KEYS, b, kfull + 8 * st, lead);
        mbar_wait(vempty + 8 * st, phase);
        mbar_expect_tx(vfull + 8 * st, C::V_BYTES, lead);
#pragma unroll
        for (int p = 0; p < C::V_PANELS; ++p)
          tma_load4(sV + st * C::V_BYTES + p * C::V_PANEL, tv,
                    C::V_COLS * p, hk, ik * KEYS, b, vfull + 8 * st, lead);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = warp_id >> 2;   // warpgroup: rows 64*wgi of a work tile
  const int warp = warp_id & 3, lane = tid & 31;
  const bool wg_lead = (tid & 127) == 0;
  // this warpgroup's 64 q rows of work tile w into Q slot `slot`
  auto load_q = [&](int w, int slot, bool on) {
    int iq, h, b;
    tile_of(w, iq, h, b);
    const uint32_t bar = qbar + 8 * (2 * slot + wgi);
    const uint32_t dst = sQ + (2 * slot + wgi) * C::QH_BYTES;
    mbar_expect_tx(bar, C::QH_BYTES, on);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_load4(dst + p * (64 * 128), tq, 64 * p, h, iq * BQ + 64 * wgi, b,
                bar, on);
  };
  // the next work tile's Q into the other slot, once the store of the
  // tile before this one (staged in that slot) has read it
  auto prefetch_q = [&](int j) {
    bulk_wait_read(wg_lead);
    const int next = work(j + 1);
    load_q(next, (j + 1) & 1, wg_lead && next < tiles);
  };
  load_q(work(0), 0, wg_lead);
  // The warpgroups take turns to issue a tile's products (named barriers 3
  // and 4: warpgroup g waits on 3 + g, then lets the other go), so that one
  // warpgroup's softmax runs under the other's products; warpgroup 0 first
  if (wgi == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

  int n = 0;                      // K/V tiles read so far: the rings' index
  for (int j = 0, w = work(0); w < tiles; w = work(++j)) {
    int iq, h, b;
    tile_of(w, iq, h, b);
    const int slot = j & 1;
    const uint32_t sq = sQ + (2 * slot + wgi) * C::QH_BYTES;
    const int q0 = iq * BQ;
    const int first_q = q0 + (Sk - Sq);
    const int last_q = first_q + BQ - 1;
    const TileRange live(first_q, BQ, Sk, causal, window, KEYS);
    mbar_wait(qbar + 8 * (2 * slot + wgi), (j >> 1) & 1);

    float acc[C::PV_N / 2];
#pragma unroll
    for (int i = 0; i < C::PV_N / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r, r+8
    const int qp0 = first_q + 64 * wgi + warp * 16 + (lane >> 2);
    uint32_t pk[KEYS / 4];           // P of tile ik - 1, as bf16 pairs
    float s[KEYS / 2];
    for (int ik = live.lo; ik < live.hi; ++ik, ++n) {
      const int st = n & 1, pst = st ^ 1;          // this tile's, the last
      mbar_wait(kfull + 8 * st, (n >> 1) & 1);
      const bool pv = ik > live.lo;
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wgi) : "memory");
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t qa = sq + (kk >> 2) * (64 * 128) + (kk & 3) * 32;
        const uint32_t ka = sK + st * C::K_BYTES + (kk >> 2) * (KEYS * 128) +
                            (kk & 3) * 32;
        wgmma_ss<0, 0>(s, make_desc(qa, 16, 1024), make_desc(ka, 16, 1024),
                       kk);
      }
      wgmma_commit();
      if (pv) {
        mbar_wait(vfull + 8 * pst, ((n - 1) >> 1) & 1);
        issue_pv<C::V32, KEYS>(acc, pk, sV + pst * C::V_BYTES);
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wgi) : "memory");
        wgmma_wait<1>();             // S has landed; P V may still run
      } else {
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wgi) : "memory");
        wgmma_wait<0>();
      }
      // this warp is done with this tile's K
      mbar_arrive(kempty + 8 * st, lane == 0);
      float a0, a1;
      online_softmax<true>(s, ik * KEYS, first_q, last_q, qp0, Sk, causal,
                           window, scale_log2, lane, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();               // P V of tile ik - 1 is in acc
      // and with the previous tile's V
      mbar_arrive(vempty + 8 * pst, pv && lane == 0);
      if (!pv) prefetch_q(j);
#pragma unroll
      for (int i = 0; i < C::PV_N / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
#pragma unroll
      for (int i = 0; i < KEYS / 4; ++i)
        pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
    if (live.hi > live.lo) {
      const int last = (n - 1) & 1;
      mbar_wait(vfull + 8 * last, ((n - 1) >> 1) & 1);
      wgmma_fence();
      issue_pv<C::V32, KEYS>(acc, pk, sV + last * C::V_BYTES);
      wgmma_wait<0>();
      mbar_arrive(vempty + 8 * last, lane == 0);
    } else {
      prefetch_q(j);
    }

    // O / l into this tile's Q slot (its last S has been read); then one
    // TMA store a panel, which drops the rows past Sq and the columns past
    // hd, waited on only before the slot takes a new Q
    const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
    const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
    stage_out(acc, 0, sq, 64 * 128, d0, d1, warp, lane);
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_store4(to, sq + p * (64 * 128), 64 * p, h, q0 + 64 * wgi, b,
                 wg_lead);
    bulk_commit(wg_lead);
  }
  // warpgroup 1's last turn
  if (wgi == 0) asm volatile("bar.sync 3, 256;\n" ::: "memory");
  bulk_wait_read(wg_lead);
}

// hd 256: NWG warpgroups, each 64 q rows and all 256 output columns (two
// m64n128 accumulators, 128 registers a thread).  K and V have two-stage
// rings of their own (header).
template <int NWG>
__device__ __forceinline__ void fa_hd256(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* to, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, float scale_log2) {
  using C = Cfg256<NWG>;
  constexpr int ROWS = C::ROWS, T_BYTES = C::T_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::Q_BYTES;                 // stage s at + s*T
  const uint32_t sV = sK + 2 * T_BYTES;
  const uint32_t kbar = sV + 2 * T_BYTES, vbar = kbar + 16, qbar = vbar + 16;

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;           // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;       // warpgroup: rows 64*wgi
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int wrow = wgi * 64;

  const int q0 = iq * ROWS;
  const int first_q = q0 + (Sk - Sq);
  const int last_q = first_q + ROWS - 1;
  const TileRange live(first_q, ROWS, Sk, causal, window);
  const int ik_lo = live.lo, ik_hi = live.hi;

  // one K or V tile (four 64-column panels of 64 keys) into `dst`,
  // completing on `bar`; thread 0's copies predicated (hopper.cuh)
  const bool lead = tid == 0;
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int ik,
                  bool on) {
    mbar_expect_tx(bar, T_BYTES, on);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      tma_load4(dst + p * (BK * 128), map, 64 * p, hk, ik * BK, b, bar, on);
  };
  for (int i = 0; i < 5; ++i) mbar_init(kbar + 8 * i, 1, lead);
  fence_mbar_init();
  __syncthreads();
  mbar_expect_tx(qbar, C::Q_BYTES, lead);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    tma_load4(sQ + p * (ROWS * 128), tq, 64 * p, h, q0, b, qbar, lead);
  load(tk, sK, kbar, ik_lo, lead && ik_lo < ik_hi);
  load(tv, sV, vbar, ik_lo, lead && ik_lo < ik_hi);
  mbar_wait(qbar, 0);

  float acc[2][64];                  // output columns 0..127, 128..255
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r, r+8
  const int qp0 = first_q + wrow + warp * 16 + (lane >> 2);
  auto pv = [&](const uint32_t (&pk)[BK / 4], uint32_t va) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                              pk[4 * kk + 3]};
      wgmma_rs<1>(acc[0], pa,
                  make_desc(va + kk * (16 * 128), BK * 128, 1024));
      wgmma_rs<1>(acc[1], pa,
                  make_desc(va + 2 * (BK * 128) + kk * (16 * 128), BK * 128,
                            1024));
    }
    wgmma_commit();
  };

  // Tile t = ik - ik_lo sits in K stage t & 1 and V stage t & 1.  At the
  // top of tile t every thread has finished tile t - 1 (S of t - 1, P V of
  // t - 2): K stage (t + 1) & 1 takes tile t + 1, V stage t & 1 tile t
  // (tile 0's V came with Q).
  uint32_t pk[BK / 4];               // P of tile ik - 1, as bf16 pairs
  float s[32];
  for (int ik = ik_lo; ik < ik_hi; ++ik) {
    const int t = ik - ik_lo, st = t & 1;
    mbar_wait(kbar + 8 * st, (t >> 1) & 1);              // K of tile t
    if (t > 0) mbar_wait(vbar + 8 * (st ^ 1), ((t - 1) >> 1) & 1);  // V t-1
    __syncthreads();
    // warp 0 alone, all its lanes together: the branch is uniform across
    // each warp, so it splits none, and spares the other warps the issue
    if (tid < 32) {
      load(tk, sK + (st ^ 1) * T_BYTES, kbar + 8 * (st ^ 1), ik + 1,
           lead && ik + 1 < ik_hi);
      load(tv, sV + st * T_BYTES, vbar + 8 * st, ik, lead && t > 0);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t qa = sQ + (kk >> 2) * (ROWS * 128) + wrow * 128 +
                          (kk & 3) * 32;
      const uint32_t ka = sK + st * T_BYTES + (kk >> 2) * (BK * 128) +
                          (kk & 3) * 32;
      wgmma_ss<0, 0>(s, make_desc(qa, 16, 1024), make_desc(ka, 16, 1024),
                     kk);
    }
    wgmma_commit();
    if (t > 0) {
      pv(pk, sV + (st ^ 1) * T_BYTES);
      wgmma_wait<1>();               // S has landed; P V may still run
    } else {
      wgmma_wait<0>();
    }
    float a0, a1;
    online_softmax(s, ik * BK, first_q, last_q, qp0, Sk, causal, window,
                   scale_log2, lane, m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();                 // P V of tile ik - 1 is in acc
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[0][i] *= (i & 2) ? a1 : a0;
      acc[1][i] *= (i & 2) ? a1 : a0;
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  if (ik_hi > ik_lo) {
    const int t = ik_hi - 1 - ik_lo;
    mbar_wait(vbar + 8 * (t & 1), (t >> 1) & 1);
    wgmma_fence();
    pv(pk, sV + (t & 1) * T_BYTES);
    wgmma_wait<0>();
  }

  // O / l into this warpgroup's rows of the Q region, then one TMA store a
  // panel (rows past Sq dropped)
  const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const uint32_t so = sQ + wrow * 128;
  stage_out(acc[0], 0, so, ROWS * 128, d0, d1, warp, lane);
  stage_out(acc[1], 128, so, ROWS * 128, d0, d1, warp, lane);
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  const bool wg_lead = (tid & 127) == 0;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    tma_store4(to, so + p * (ROWS * 128), 64 * p, h, q0 + wrow, b, wg_lead);
  bulk_commit(wg_lead);
  bulk_wait_read(wg_lead);
}

// fa_hd256: NWG warpgroups of 64 q rows (the wrapper picks 1 or 2), one
// CTA per q tile and one an SM, whose O accumulator alone takes 128
// registers, under the 255 a thread that one CTA an SM leaves.
template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    fa_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, int Sq, int Sk,
                    int Hq, int Hkv, int causal, int window,
                    float scale_log2) {
  static_assert(HD == 256, "fa_kernel_wgmma runs hd 256");
  fa_hd256<NWG>(&tq, &tk, &tv, &to, Sq, Sk, Hq, Hkv, causal, window,
                scale_log2);
}

// fa_persist (hd 32..128): 384 threads and one CTA an SM (its shared
// memory, and at hd <= 64 its registers); the launch bounds leave 168
// registers a thread, and setmaxnreg moves the producer warpgroup's to the
// consumers (232 a thread), whose S (64 registers), P (32) and output
// accumulator (64; 48 at hd 96, 32 at hd <= 64) would not fit 168.  The
// walk's order is a template argument (a runtime choice took 10-15 more
// registers).
template <int HD, bool GROUPS>
__global__ void __launch_bounds__(CfgP<HD>::NT, 1)
    fa_kernel_persist(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, int B, int Sq,
                      int Sk, int Hq, int Hkv, int causal, int window,
                      float scale_log2) {
  fa_persist<HD, GROUPS>(&tq, &tk, &tv, &to, B, Sq, Sk, Hq, Hkv, causal,
                         window, scale_log2);
}

inline float scale_log2(int hd) {            // log2(e) / sqrt(hd)
  return (float)(1.4426950408889634 / std::sqrt((double)hd));
}

template <int HD, int NWG>
int launch_rows(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                cudaStream_t stream) {
  constexpr int ROWS = 64 * NWG;
  CUtensorMap tq, tk, tv, to;
  if (!make_map_bshd(&tq, q, HD, Hq, Sq, B, ROWS) ||
      !make_map_bshd(&tk, k, HD, Hkv, Sk, B, BK) ||
      !make_map_bshd(&tv, v, HD, Hkv, Sk, B, BK) ||
      !make_map_bshd(&to, o, HD, Hq, Sq, B, 64))
    return -2;
  const int bytes = Cfg256<NWG>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_wgmma<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + ROWS - 1) / ROWS);
  fa_kernel_wgmma<HD, NWG><<<grid, 128 * NWG, bytes, stream>>>(
      tq, tk, tv, to, Sq, Sk, Hq, Hkv, causal, window, scale_log2(HD));
  return (int)cudaGetLastError();
}

// ctas: the persistent grid (flash_ctas), 1 to the number of work tiles;
// kv_groups: the walk's order (flash_order)
template <int HD>
int launch_persist(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, int ctas, int kv_groups, cudaStream_t stream) {
  using C = CfgP<HD>;
  if (ctas < 1 || ctas > B * Hq * ((Sq + BQ - 1) / BQ)) return -1;
  CUtensorMap tq, tk, tv, to;
  if (!make_map_bshd(&tq, q, HD, Hq, Sq, B, 64) ||
      !make_map_bshd(&tk, k, HD, Hkv, Sk, B, C::KEYS) ||
      !make_map_bshd(&tv, v, HD, Hkv, Sk, B, C::KEYS, C::V_COLS) ||
      !make_map_bshd(&to, o, HD, Hq, Sq, B, 64))
    return -2;
  auto kernel = kv_groups ? fa_kernel_persist<HD, true>
                          : fa_kernel_persist<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, C::NT, C::SMEM, stream>>>(tq, tk, tv, to, B, Sq, Sk, Hq,
                                            Hkv, causal, window,
                                            scale_log2(HD));
  return (int)cudaGetLastError();
}

}  // namespace wg

// The bodies, numbered as kernels/flash_attention.py's BODIES
enum Body { kPersist = 0, kHd256 = 1, kF32 = 2 };

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, -1 for a body, head dim, block_q or grid the kernels were
// not built for, or -2 if a TMA tensor map could not be made.  `body`
// (flash_body in the wrapper) picks the kernel: persist (bf16, hd 32, 64,
// 72, 96 and 128; `ctas` CTAs walking the work tiles in the order
// `kv_groups` names), hd256 (bf16; block_q 64 or 128), f32 (every head
// dim).  A body ignores the arguments it does not
// read.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int body,
                                     int B, int Sq, int Sk, int Hq, int Hkv,
                                     int hd, int causal, int window,
                                     int block_q, int ctas, int kv_groups,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kPersist:
      if (hd == 32)
        return wg::launch_persist<32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                                      window, ctas, kv_groups, s);
      if (hd == 64)
        return wg::launch_persist<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                                      window, ctas, kv_groups, s);
      if (hd == 72)
        return wg::launch_persist<72>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                                      window, ctas, kv_groups, s);
      if (hd == 96)
        return wg::launch_persist<96>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                                      window, ctas, kv_groups, s);
      if (hd == 128)
        return wg::launch_persist<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv,
                                       causal, window, ctas, kv_groups, s);
      return -1;
    case kHd256:
      if (hd != 256) return -1;
      if (block_q == 128)
        return wg::launch_rows<256, 2>(q, k, v, o, B, Sq, Sk, Hq, Hkv,
                                       causal, window, s);
      if (block_q == 64)
        return wg::launch_rows<256, 1>(q, k, v, o, B, Sq, Sk, Hq, Hkv,
                                       causal, window, s);
      return -1;
    case kF32:
      switch (hd) {
#define REPRO_FA_F32(HD)                                                    \
  case HD:                                                                  \
    return f32core::launch<HD>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,      \
                               window, s);
        REPRO_FA_F32(32)
        REPRO_FA_F32(64)
        REPRO_FA_F32(72)
        REPRO_FA_F32(96)
        REPRO_FA_F32(128)
        REPRO_FA_F32(256)
#undef REPRO_FA_F32
        default: return -1;
      }
    default:
      return -1;
  }
}
