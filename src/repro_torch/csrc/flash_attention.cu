// Flash attention (prefill / forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function flash_attention (body _fa_kernel).  Same contract: q (B,Sq,Hq,hd),
// k/v (B,Sk,Hkv,hd) -> o (B,Sq,Hq,hd); queries aligned to the end of K
// (q_pos = i + Sk - Sq); optional causal and sliding-window masks; GQA by
// mapping q-head h to kv-head h / (Hq/Hkv); K/V rows past Sk read as zeros;
// scores scaled by 1/sqrt(hd) on q; an online softmax in float32 with the
// finite mask value -1e30; l floored at 1e-30.  Output in q's dtype.
//
// Bound on an H100: at the serving shape (minicpm-2b, batch 8, S = 512,
// causal, bf16) the function moves 4 x 18.9 MB of q/k/v/o (about 22.5 us at
// 3.35 TB/s) and does about 9.7 GFLOP (about 9.8 us at the bf16 tensor-core
// peak), so the card's bound is the memory traffic.  This first version
// computes both products on the CUDA cores in float32 (no tensor cores):
// its own ceiling is the 67 TFLOP/s float32 rate, several times the bound.
// What the design does about the bound: each block reads its q tile once
// and each K/V tile once per q tile, straight from the (B,S,H,hd) layout by
// strides (no transposed copies), skips tiles the causal/window masks kill,
// and keeps scores, m, l and the accumulator on chip.  wgmma, TMA and
// pipelined loads are later work.
//
// Grid: one block of 256 threads per (64-row q tile, q head, batch row).
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4*ty .. 4*ty+3 of the
// tile, score columns tx + 16*j and output columns tx + 16*c.
#include <cmath>

#include "tile.cuh"

namespace {

using repro::NEG_INF;
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int Hq, int Hkv, int causal, int window, float scale) {
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
  const T* qb = q + (long)b * Sq * q_row + (long)h * HD;
  const T* kb = k + (long)b * Sk * kv_row + (long)hk * HD;
  const T* vb = v + (long)b * Sk * kv_row + (long)hk * HD;
  T* ob = o + (long)b * Sq * q_row + (long)h * HD;

  const int q0 = iq * BQ;
  repro::load_tile<T, HD, NT>(Qs, Lt::QS, qb + (long)q0 * q_row, q_row,
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
    repro::load_tile<T, HD, NT>(Ks, Lt::KS, kb + (long)first_k * kv_row,
                                kv_row, kv_valid, BK, 1.f, tid);
    repro::load_tile<T, HD, NT>(Vs, Lt::VS, vb + (long)first_k * kv_row,
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
      if (d < HD)
        ob[(long)r * q_row + d] = repro::from_float<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fa_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal,
      window, (float)(1.0 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                int window, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 72: return launch<T, 72>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 96: return launch<T, 96>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s);
    default: return -1;
  }
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a head dim the kernel was not built for.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int is_bf16,
                                     int B, int Sq, int Sk, int Hq, int Hkv,
                                     int hd, int causal, int window,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, Hq, Hkv,
                                      causal, window, s);
  return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                            window, s);
}
