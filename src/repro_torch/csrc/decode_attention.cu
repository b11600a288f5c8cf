// Flash-decoding (one query token per row over a KV cache) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (body _dec_kernel).  Same contract: q (B,Hq,hd),
// k/v (B,L,Hkv,hd) in prefix layout, valid_len (B,) int32 -> o (B,Hq,hd).
// Scores scaled by 1/sqrt(hd) on q; the G = Hq/Hkv query heads of a KV head
// are processed together; keys at or past min(valid_len, L) are masked (their
// K/V rows read as zeros) and tiles starting at or past valid_len are
// skipped; online softmax in float32 with the finite mask value -1e30; l
// floored at 1e-30, so a row with valid_len = 0 writes zeros.
//
// Bound on an H100: decoding reads every live K and V row once and does
// about 4 flops per K/V element, far below the ~295 flops/byte at which the
// card stops being memory-bound.  At the serving shape (minicpm-2b, batch 8,
// valid_len ~ 544, bf16) the bound is 2*8*544*36*64*2 B = 40 MB at
// 3.35 TB/s, about 12 us.  What the design does about it: K/V tiles stream
// with coalesced 16-byte loads straight from the cache layout by strides,
// only up to valid_len, and each K/V element is read from device memory
// exactly once (all G query rows of the KV head share the tile in shared
// memory).  One block per (KV head, batch row) gives 288 blocks at the
// serving shape; split-K over L and pipelined (TMA) loads are later work.
#include <cmath>

#include "tile.cuh"

namespace {

using repro::NEG_INF;
constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // threads per block (4 warps)
constexpr int MAXACC = 8;    // accumulator slots per thread: G*hd <= NT*MAXACC

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) *
         (G * HD + BK * (HD + 1) + BK * HD + G * BK + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ valid_len,
               T* __restrict__ o, int L, int Hq, int Hkv, float scale) {
  constexpr int KS = HD + 1;  // odd stride: conflict-free per-key dot products
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* Qs = smem;             // G x HD, pre-scaled
  float* Ks = Qs + G * HD;      // BK x KS
  float* Vs = Ks + BK * KS;     // BK x HD
  float* Ps = Vs + BK * HD;     // G x BK scores, then probabilities
  float* Ms = Ps + G * BK;      // running max per query row
  float* Ls = Ms + G;           // running denominator
  float* As = Ls + G;           // this tile's rescale factor

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long kv_row = (long)Hkv * HD;
  const long qo_off = ((long)b * Hq + (long)hk * G) * HD;  // G rows of HD
  const T* kb = k + (long)b * L * kv_row + (long)hk * HD;
  const T* vb = v + (long)b * L * kv_row + (long)hk * HD;
  const int vl = valid_len[b];
  const int n = min(vl, L);     // keys that attend

  repro::load_tile<T, HD, NT>(Qs, HD, q + qo_off, HD, G, G, scale, tid);
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // Q/state initialised; previous tile's readers done
    const int kv_valid = min(BK, n - k0);
    repro::load_tile<T, HD, NT>(Ks, KS, kb + (long)k0 * kv_row, kv_row,
                                kv_valid, BK, 1.f, tid);
    repro::load_tile<T, HD, NT>(Vs, HD, vb + (long)k0 * kv_row, kv_row,
                                kv_valid, BK, 1.f, tid);
    __syncthreads();

    for (int p = tid; p < G * BK; p += NT) {
      const int g = p / BK, j = p - g * BK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(Qs[g * HD + d], Ks[j * KS + d], s);
      Ps[p] = (j < kv_valid) ? s : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      const float m_old = Ms[g];
      const float s0 = Ps[g * BK + lane], s1 = Ps[g * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ps[g * BK + lane] = p0;
      Ps[g * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXACC; ++i) {
      const int p = tid + NT * i;
      if (p < G * HD) {
        const int g = p / HD, d = p - g * HD;
        float a = acc[i] * As[g];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(Ps[g * BK + j], Vs[j * HD + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int p = tid + NT * i;
    if (p < G * HD) {
      const int g = p / HD;
      o[qo_off + p] = repro::from_float<T>(acc[i] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* vlen,
           void* o, int B, int L, int Hq, int Hkv, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>(Hq / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      dec_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  dec_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vlen, static_cast<T*>(o), L, Hq, Hkv,
      (float)(1.0 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* vlen, void* o, int B, int L, int Hq, int Hkv,
                cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, vlen, o, B, L, Hq, Hkv, s);
    case 64: return launch<T, 64>(q, k, v, vlen, o, B, L, Hq, Hkv, s);
    case 72: return launch<T, 72>(q, k, v, vlen, o, B, L, Hq, Hkv, s);
    case 96: return launch<T, 96>(q, k, v, vlen, o, B, L, Hq, Hkv, s);
    case 128: return launch<T, 128>(q, k, v, vlen, o, B, L, Hq, Hkv, s);
    default: return -1;
  }
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a head dim the kernel was not built for.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid_len,
                                      void* o, int is_bf16, int B, int L,
                                      int Hq, int Hkv, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vlen = static_cast<const int*>(valid_len);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, vlen, o, B, L, Hq, Hkv, s);
  return dispatch_hd<float>(hd, q, k, v, vlen, o, B, L, Hq, Hkv, s);
}
