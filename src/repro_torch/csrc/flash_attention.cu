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
// Two kernels, picked by dtype in the C launcher below:
//
// * bf16, fa_kernel_wgmma: both products on the tensor cores.  A CTA of two
//   warpgroups owns 128 q rows (64 each).  S = Q K^T is a wgmma m64n64k16
//   with Q and K in shared memory, both K-major; P V is a wgmma m64nDk16
//   with P in registers (the S accumulator fragment converted to bf16 lines
//   up with the A-operand fragment, as in FlashAttention-3) and V in shared
//   memory, MN-major (transpose bit).  Tiles sit in shared memory as bf16 in
//   64-column (128-byte) panels with the 128-byte swizzle the descriptors
//   name; hd 32/72/96 are padded with zeros to 64/128 columns.  Loads are
//   TMA copies: one 4-D tensor map per operand over the (B,S,H,hd) layout
//   with its own strides, whose zero fill gives the rows past Sk and the
//   padding columns.  One thread issues them; K/V tiles of 64 keys land in
//   a four-stage ring, each stage completing on its mbarrier, so the next
//   two tiles' loads overlap the current tile's products, with one CTA
//   barrier per tile.  Each iteration issues S of tile j and P V of
//   tile j - 1 together and runs the softmax of tile j while P V is on the
//   tensor cores (FlashAttention-3's intra-warpgroup overlap).  The online
//   softmax runs on the accumulator fragments (quad shuffles).  Dead tiles
//   are skipped with _fa_kernel's tile test; only tiles that straddle the
//   diagonal, the window edge or Sk are masked.  q tiles launch
//   heaviest-first (the q-tile index is the slowest grid dimension,
//   reversed), so the causal tail is short.
// * float32, fa_kernel_f32: the CUDA-core kernel of the port's first
//   version.  Full-f32 products are what the f32 tolerance needs (TF32 would
//   not meet it); f32 is on no serving path.
#include <cuda.h>

#include <cmath>

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

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;     // q rows per CTA: two consumer warpgroups
constexpr int BK = 64;      // keys per K/V tile
constexpr int NT = 256;
constexpr int STAGES = 4;   // K/V ring depth
constexpr int AHEAD = STAGES - 2;  // tiles loading while one is in use

template <int HD>
struct Cfg {
  static constexpr int HDP = HD <= 64 ? 64 : 128;  // padded to whole panels
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;
  static constexpr int NP = HDP / 64;              // 64-column panels
  // +1024: the base is rounded up to the swizzle atom; then the barriers
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024 +
                              8 * (STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and TMA.  A tile lands in shared memory in 64-column (128-byte)
// panels, panel p at +p*ROWS*128, row r at +r*128, its 16-byte chunk c at
// chunk c ^ (r % 8): the 128-byte swizzle of the tensor maps, which the
// wgmma descriptors name.  Rows past the tensor's end and columns past hd
// are zero-filled by the TMA unit.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one box of the 4-D map (hd, heads, sequence, batch) at (c0, c1, c2, c3),
// loaded into shared memory, or stored from it (clipped to the tensor)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define R8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64x64 f32 fragment) (+)= A (64x16, smem, K-major) * B (16x64 as 64
// rows of K, smem, K-major)^T; d is overwritten when acc == 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64xN f32 fragment) += A (64x16 bf16, registers) * B (16xN, smem,
// MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef R8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// O += P V over one tile: P's fragment for keys 16kk..16kk+15 is
// pk[4kk .. 4kk+3]; V at va, MN-major
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&pk)[BK / 4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                            pk[4 * kk + 3]};
    wgmma_rs(acc, pa, make_desc(va + kk * (16 * 128), BK * 128, 1024));
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

// Accumulator fragment of a 64xN wgmma (f32): thread t of the warpgroup,
// warp w = t/32, lane; register i holds row 16w + lane/4 + 8*((i>>1)&1),
// column 8*(i/4) + 2*(lane%4) + (i&1).
// Two CTAs an SM where the 128-register budget holds both accumulators
// (hd <= 64); one at hd 72..128, whose O accumulator alone takes 64.
template <int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 2 : 1)
    fa_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, int Sq, int Sk,
                    int Hq, int Hkv, int causal, int window,
                    float scale_log2) {
  using C = Cfg<HD>;
  constexpr int HDP = C::HDP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::Q_BYTES;                 // stage s at + s*KV
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t bars = sV + STAGES * C::KV_BYTES;     // STAGES full, then Q

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;           // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;                            // warpgroup: rows 64*wgi
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  const int q0 = iq * BQ;
  const int first_q = q0 + (Sk - Sq);
  const int last_q = first_q + BQ - 1;
  const int nk = (Sk + BK - 1) / BK;
  // the tile-skip test of _fa_kernel: live tiles are [ik_lo, ik_hi)
  int ik_hi = nk;
  if (causal) ik_hi = last_q < 0 ? 0 : min(nk, last_q / BK + 1);
  int ik_lo = 0;
  if (window > 0)
    while (ik_lo < ik_hi && first_q - (ik_lo * BK + BK - 1) >= window) ++ik_lo;

  // one thread issues every load: Q once, then each K/V tile into its
  // stage, completing on that stage's barrier
  const uint32_t qbar = bars + 8 * STAGES;
  auto load_kv = [&](int ik, int stage) {
    const uint32_t bar = bars + 8 * stage;
    mbar_expect_tx(bar, 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < C::NP; ++p) {
      tma_load(sK + stage * C::KV_BYTES + p * (BK * 128), &tk, 64 * p, hk,
               ik * BK, b, bar);
      tma_load(sV + stage * C::KV_BYTES + p * (BK * 128), &tv, 64 * p, hk,
               ik * BK, b, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
      tma_load(sQ + p * (BQ * 128), &tq, 64 * p, h, q0, b, qbar);
    for (int t = 0; t < AHEAD && ik_lo + t < ik_hi; ++t)
      load_kv(ik_lo + t, t);
  }
  mbar_wait(qbar, 0);

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r, r+8
  const int qp0 = first_q + wgi * 64 + warp * 16 + (lane >> 2);
  const int qp1 = qp0 + 8;

  // Each iteration issues S = Q K^T of tile ik and P V of tile ik - 1
  // together; the softmax of tile ik runs while P V is on the tensor cores
  // (FlashAttention-3's intra-warpgroup overlap).  The ring holds tile
  // ik - 1 (its V still read), tile ik and the two tiles in flight.
  uint32_t pk[BK / 4];               // P of tile ik - 1, as bf16 pairs
  float s[32];
  for (int ik = ik_lo, stage = 0; ik < ik_hi;
       ++ik, stage = stage + 1 == STAGES ? 0 : stage + 1) {
    mbar_wait(bars + 8 * stage, ((ik - ik_lo) / STAGES) & 1);
    // every thread is done with tile ik - 2, whose stage the load refills
    __syncthreads();
    const int ahead = ik + AHEAD;
    if (tid == 0 && ahead < ik_hi) load_kv(ahead, (ahead - ik_lo) % STAGES);

    const bool pv = ik > ik_lo;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t qa = sQ + (kk >> 2) * (BQ * 128) + wgi * (64 * 128) +
                          (kk & 3) * 32;
      const uint32_t ka = sK + stage * C::KV_BYTES + (kk >> 2) * (BK * 128) +
                          (kk & 3) * 32;
      wgmma_ss_n64(s, make_desc(qa, 16, 1024), make_desc(ka, 16, 1024), kk);
    }
    wgmma_commit();
    if (pv) {
      issue_pv(acc, pk, sV + (stage == 0 ? STAGES - 1 : stage - 1) *
                                 C::KV_BYTES);
      wgmma_wait<1>();               // S has landed; P V may still run
    } else {
      wgmma_wait<0>();
    }

    // masks only where the tile straddles Sk, the diagonal or the window;
    // scores stay unscaled until the exponent (the scale is positive, so
    // the row max commutes with it)
    const int first_k = ik * BK;
    const bool edge = first_k + BK > Sk ||
                      (causal && first_k + BK - 1 > first_q) ||
                      (window > 0 && last_q - first_k >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
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
    const float mn0 = fmaxf(m0, quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]),
                                               fmaxf(mx[0][2], mx[0][3]))));
    const float mn1 = fmaxf(m1, quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]),
                                               fmaxf(mx[1][2], mx[1][3]))));
    const float a0 = fast_exp2((m0 - mn0) * scale_log2);
    const float a1 = fast_exp2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    // (s - m) * scale, not an fma: a masked score minus a masked max is
    // exactly 0, so a row whose processed keys are all masked averages them
    float rs[2][4] = {};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2((s[i] - ((i & 2) ? mn1 : mn0)) * scale_log2);
      s[i] = p;
      rs[(i >> 1) & 1][i >> 3] += p;
    }
    const float rs0 = (rs[0][0] + rs[0][1]) + (rs[0][2] + rs[0][3]);
    const float rs1 = (rs[1][0] + rs[1][1]) + (rs[1][2] + rs[1][3]);
    l0 = l0 * a0 + rs0;              // per-thread partial; quad-summed at end
    l1 = l1 * a1 + rs1;
    wgmma_wait<0>();                 // P V of tile ik - 1 is in acc
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
    // P's A-operand fragment for keys 16kk..16kk+15 is s[8kk .. 8kk+7]
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }
  if (ik_hi > ik_lo) {
    const int last = (ik_hi - 1 - ik_lo) % STAGES;
    wgmma_fence();
    issue_pv(acc, pk, sV + last * C::KV_BYTES);
    wgmma_wait<0>();
  }

  // O / l into this warpgroup's rows of the Q region (its last S has been
  // read), in the swizzled panel layout of the tensor maps; then one TMA
  // store a panel, which drops the rows past Sq and the columns past hd
  const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const uint32_t so = sQ + wgi * (64 * 128);
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int r = warp * 16 + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    const float dn = (i & 2) ? d1 : d0;
    const uint32_t addr = so + (col >> 6) * (BQ * 128) + r * 128 +
                          ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                 "r"(pack_bf16(acc[i] * dn, acc[i + 1] * dn))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  if ((tid & 127) == 0) {
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
      tma_store(&to, so + p * (BQ * 128), 64 * p, h, q0 + wgi * 64, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry-point
// query (the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, S, H, hd) tensor as a 4-D map, innermost first, with its own
// strides; boxes of 64 columns x `rows` rows of one head and batch row,
// 128-byte swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int H, int S, int B,
              int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, HD, Hq, Sq, B, BQ) ||
      !make_map(&tk, k, HD, Hkv, Sk, B, BK) ||
      !make_map(&tv, v, HD, Hkv, Sk, B, BK) ||
      !make_map(&to, o, HD, Hq, Sq, B, BQ / 2))
    return -2;
  const int bytes = Cfg<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  fa_kernel_wgmma<HD><<<grid, NT, bytes, stream>>>(
      tq, tk, tv, to, Sq, Sk, Hq, Hkv, causal, window,
      (float)(1.4426950408889634 / std::sqrt((double)HD)));  // log2(e)/sqrt
  return (int)cudaGetLastError();
}

}  // namespace wg

template <bool BF16>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                int window, cudaStream_t s) {
#define REPRO_FA_CASE(HD)                                                   \
  case HD:                                                                  \
    return BF16 ? wg::launch<HD>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,    \
                                 window, s)                                 \
                : f32core::launch<HD>(q, k, v, o, B, Sq, Sk, Hq, Hkv,       \
                                      causal, window, s);
  switch (hd) {
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(72)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(128)
    default: return -1;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, -1 for a head dim the kernel was not built for, or -2 if
// a TMA tensor map could not be made.  The
// dtype picks the kernel: bf16 -> fa_kernel_wgmma, f32 -> fa_kernel_f32.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int is_bf16,
                                     int B, int Sq, int Sk, int Hq, int Hkv,
                                     int hd, int causal, int window,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<true>(hd, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                             window, s);
  return dispatch_hd<false>(hd, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                            window, s);
}
