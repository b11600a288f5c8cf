// Flash-decoding (one query token per row over a KV cache) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (body _dec_kernel).  Same contract: q (B,Hq,hd),
// k/v (B,L,Hkv,hd) in prefix layout, valid_len (B,) int32 -> o (B,Hq,hd).
// Scores scaled by 1/sqrt(hd) on q; the G = Hq/Hkv query heads of a KV head
// are processed together; keys at or past min(valid_len, L) are masked and
// never read; online softmax in float32 with the finite mask value -1e30; l
// floored at 1e-30, so a row with valid_len = 0 writes zeros.
//
// Bound on an H100: decoding reads every live K and V row once and does
// about 4 flops per K/V element, far below the ~295 flops/byte at which the
// card stops being memory-bound, so it stays on the CUDA cores.  At the
// serving shape (minicpm-2b, batch 8, valid_len 544, bf16) the bound is
// 2*8*544*36*64*2 B = 40 MB at 3.35 TB/s, about 12 us.  The design is about
// bytes in flight:
//
// * Split over the cache.  The wrapper's plan (kernels/decode_attention.py,
//   split_plan) cuts L into n_split <= 8 contiguous ranges of `chunk` keys,
//   one CTA each, so that B * Hkv * n_split CTAs fill the 132 SMs at batch 1
//   as well as at batch 8.  A range at or past valid_len reads nothing.
// * Combine in the same launch.  The n_split CTAs of one (b, KV head) form
//   one thread-block cluster.  Each leaves its partial (m, l, acc) in its
//   shared memory; after a cluster barrier, rank 0 reads the others'
//   partials through distributed shared memory and combines them by
//   log-sum-exp.  No second kernel, global scratch or atomics.
// * Loads.  K/V tiles of 32 keys stream through a four-stage ring of
//   16-byte cp.async copies in the input's dtype (not widened), so three
//   tiles are in flight while one is scored.  The ring is small (32 KB at
//   hd 64 in bf16), so six CTAs fit on an SM and batch 8 runs in one wave.
//   At hd 256 in float32 four stages would take 256 KB, so that instance
//   keeps three (192 KB).
// * Scores.  Each of the 8 warps owns 4 keys of a tile and runs its own
//   online softmax: lanes span the head dim (two elements each), a shuffle
//   reduction gives each key's score, and all G query rows share the K/V
//   row.  The 8 warps' partials are combined in shared memory first.
#include <cmath>
#include <cooperative_groups.h>

#include "tile.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::NEG_INF;
constexpr int BK = 32;      // keys per tile
constexpr int NT = 256;     // threads per CTA (8 warps)
constexpr int NW = NT / 32;
constexpr int KG = 4;       // keys a warp scores together
constexpr float LOG2E = 1.4426950408889634f;

// GC: G rounded up to the compiled group capacity (1, 4, 16 or 32)
template <typename T, int HD, int GC>
struct Cfg {
  static constexpr int NCH = (HD + 63) / 64;     // element pairs per lane
  static constexpr int TILE = BK * HD * (int)sizeof(T);
  static constexpr int STAGES = 8 * TILE <= 128 * 1024 ? 4 : 3;  // ring depth
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int WPART = NW * (2 * GC + GC * HD) * 4;  // warps' partials
  static constexpr int PART = (2 * GC + GC * HD) * 4;        // the CTA's
  static constexpr int SCRATCH = RING > WPART ? RING : WPART;
  static constexpr int SMEM = SCRATCH + PART + 8 * GC * 4 + GC * 4;
};

template <typename T> struct Pair;
template <> struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <> struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(NT)
    dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ valid_len,
               T* __restrict__ o, int L, int Hq, int Hkv, int chunk,
               float scale_log2) {
  using C = Cfg<T, HD, GC>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;
  constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem + C::SCRATCH);  // m, l, acc
  float* wts = part + 2 * GC + GC * HD;   // rank 0: weight per (split, g)
  float* inv = wts + 8 * GC;              // rank 0: 1 / l per g

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;          // = the cluster's size
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long kv_row = (long)Hkv * HD;
  const long qo_off = ((long)b * Hq + (long)hk * G) * HD;
  const T* kb = k + (long)b * L * kv_row + (long)hk * HD;
  const T* vb = v + (long)b * L * kv_row + (long)hk * HD;
  const int n = max(0, min(valid_len[b], L));      // keys that attend
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, n);
  const int nt = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto load = [&](int t) {
    const int k0 = k_begin + t * BK;
    const int rows = min(BK, k_end - k0);
    const uint32_t ks = ring + (t % STAGES) * 2 * C::TILE;
    for (int i = tid; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = i - r * CPR;
      const bool ok = r < rows;
      const long off = ok ? (long)(k0 + r) * kv_row + c * (16 / sizeof(T)) : 0;
      cp_async16(ks + i * 16, kb + off, ok);
      cp_async16(ks + C::TILE + i * 16, vb + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) load(t);
    cp_async_commit();
  }

  // this lane's pairs of the head dim: d = 2*lane + 64*c
  float2 qv[GC][NCH], acc[GC][NCH];
  float m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = 2 * lane + 64 * c;
      float2 x = make_float2(0.f, 0.f);
      if (g < G && d < HD) x = Pair<T>::load(q + qo_off + (long)g * HD + d);
      qv[g][c] = make_float2(x.x * scale_log2, x.y * scale_log2);
      acc[g][c] = make_float2(0.f, 0.f);
    }
  }

  for (int t = 0; t < nt; ++t) {
    if (t + STAGES - 1 < nt) load(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();       // tile t has landed
    __syncthreads();
    const T* Ks = reinterpret_cast<const T*>(smem + (t % STAGES) * 2 * C::TILE);
    const T* Vs = Ks + BK * HD;
    const int valid = min(BK, k_end - (k_begin + t * BK));
#pragma unroll
    for (int kg = 0; kg < BK / NW / KG; ++kg) {
      const int j0 = warp * (BK / NW) + kg * KG;
      if (j0 >= valid) break;
      float2 kr[KG][NCH], vr[KG][NCH];
#pragma unroll
      for (int u = 0; u < KG; ++u)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int d = 2 * lane + 64 * c;
          const bool ok = d < HD;
          kr[u][c] = ok ? Pair<T>::load(Ks + (j0 + u) * HD + d)
                        : make_float2(0.f, 0.f);
          vr[u][c] = ok ? Pair<T>::load(Vs + (j0 + u) * HD + d)
                        : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        float s[KG];
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          float x = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            x = fmaf(qv[g][c].x, kr[u][c].x, fmaf(qv[g][c].y, kr[u][c].y, x));
          s[u] = j0 + u < valid ? warp_sum(x) : NEG_INF;
        }
        float mx = s[0];
#pragma unroll
        for (int u = 1; u < KG; ++u) mx = fmaxf(mx, s[u]);
        const float mn = fmaxf(m[g], mx);
        const float alpha = fast_exp2(m[g] - mn);
        m[g] = mn;
        float p[KG], ps = 0.f;
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          p[u] = fast_exp2(s[u] - mn);
          ps += p[u];
        }
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float2 a = make_float2(acc[g][c].x * alpha, acc[g][c].y * alpha);
#pragma unroll
          for (int u = 0; u < KG; ++u) {
            a.x = fmaf(p[u], vr[u][c].x, a.x);
            a.y = fmaf(p[u], vr[u][c].y, a.y);
          }
          acc[g][c] = a;
        }
      }
    }
    __syncthreads();                   // stage t % STAGES may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the partials

  // the 4 warps' partials -> the CTA's (m, l, acc) in `part`
  float* wp = reinterpret_cast<float*>(smem) + warp * (2 * GC + GC * HD);
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wp[g] = m[g];
      wp[GC + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = 2 * lane + 64 * c;
      if (d < HD) {
        wp[2 * GC + g * HD + d] = acc[g][c].x;
        wp[2 * GC + g * HD + d + 1] = acc[g][c].y;
      }
    }
  }
  __syncthreads();
  const float* w0 = reinterpret_cast<const float*>(smem);
  constexpr int WS = 2 * GC + GC * HD;  // one warp's partial, in floats
  for (int p = tid; p < G * HD; p += NT) {
    const int g = p / HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w0[w * WS + g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a = fmaf(fast_exp2(w0[w * WS + g] - M), w0[w * WS + 2 * GC + p], a);
    part[2 * GC + p] = a;
  }
  for (int g = tid; g < G; g += NT) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w0[w * WS + g]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      s = fmaf(fast_exp2(w0[w * WS + g] - M), w0[w * WS + GC + g], s);
    part[g] = M;
    part[GC + g] = s;
  }

  // the cluster's partials -> o, on rank 0, through distributed shared memory
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int g = tid; g < G; g += NT) {
      float M = NEG_INF;
      for (int r = 0; r < n_split; ++r)
        M = fmaxf(M, cluster.map_shared_rank(part, r)[g]);
      float s = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float w = fast_exp2(pr[g] - M);
        wts[r * GC + g] = w;
        s = fmaf(w, pr[GC + g], s);
      }
      inv[g] = 1.f / fmaxf(s, 1e-30f);
    }
    __syncthreads();
    for (int p = tid; p < G * HD; p += NT) {
      const int g = p / HD;
      float a = 0.f;
      for (int r = 0; r < n_split; ++r)
        a = fmaf(wts[r * GC + g], cluster.map_shared_rank(part, r)[2 * GC + p],
                 a);
      o[qo_off + p] = repro::from_float<T>(a * inv[g]);
    }
  }
  cluster.sync();                      // keep every partial alive until read
}

template <typename T, int HD, int GC>
int launch(const void* q, const void* k, const void* v, const int* vlen,
           void* o, int B, int L, int Hq, int Hkv, int n_split, int chunk,
           cudaStream_t stream) {
  // the capacity below GC; GC is compiled only where a G past it can meet
  // G * hd <= 1024 (the wrapper's MAX_GROUP_WIDTH)
  constexpr int PREV = GC == 1 ? 0 : GC == 4 ? 1 : GC == 16 ? 4 : 16;
  if constexpr (PREV >= 1024 / HD) {
    return -1;
  } else {
    const int bytes = Cfg<T, HD, GC>::SMEM;
    auto kern = dec_kernel<T, HD, GC>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_split, Hkv, B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                             static_cast<const T*>(k),
                             static_cast<const T*>(v), vlen,
                             static_cast<T*>(o), L, Hq, Hkv, chunk,
                             (float)(LOG2E / std::sqrt((double)HD)));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

template <typename T, int HD>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* vlen, void* o, int B, int L, int Hq, int Hkv,
               int n_split, int chunk, cudaStream_t s) {
  if (G <= 1)
    return launch<T, HD, 1>(q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
  if (G <= 16)
    return launch<T, HD, 16>(q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk,
                             s);
  if (G <= 32)
    return launch<T, HD, 32>(q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk,
                             s);
  return -1;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* vlen, void* o, int B, int L, int Hq, int Hkv,
                int n_split, int chunk, cudaStream_t s) {
  const int G = Hq / Hkv;
  switch (hd) {
    case 32: return dispatch_g<T, 32>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    case 72: return dispatch_g<T, 72>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    case 96: return dispatch_g<T, 96>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    case 256: return dispatch_g<T, 256>(G, q, k, v, vlen, o, B, L, Hq, Hkv, n_split, chunk, s);
    default: return -1;
  }
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a head dim or group the kernel was not built
// for.  n_split (1..8) CTAs of `chunk` keys each per (b, KV head), launched
// as one cluster: the wrapper's split_plan.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid_len,
                                      void* o, int is_bf16, int B, int L,
                                      int Hq, int Hkv, int hd, int n_split,
                                      int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vlen = static_cast<const int*>(valid_len);
  if (n_split < 1 || n_split > 8 || chunk < 1) return -1;
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, vlen, o, B, L, Hq, Hkv,
                                      n_split, chunk, s);
  return dispatch_hd<float>(hd, q, k, v, vlen, o, B, L, Hq, Hkv, n_split,
                            chunk, s);
}
