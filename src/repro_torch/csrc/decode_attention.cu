// Flash-decoding (one query token per row over a KV cache) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention (body _dec_kernel).  Same contract: q (B,Hq,hd),
// k/v (B,L,Hkv,hd) in prefix layout, valid_len (B,) int32 -> o (B,Hq,hd).
// Beyond it, an optional row index: with rows (B,) int32, k/v are (R,L,Hkv,
// hd), any R, and query row b attends over cache row rows[b], so that a
// serving step decodes against its slab of R slots in place; q, o and
// valid_len stay indexed by b, and the plan is the one of B rows.
// Scores scaled by 1/sqrt(hd); the G = Hq/Hkv query heads of a KV head
// are processed together; keys at or past min(valid_len, L) are masked and
// never read; online softmax in float32 with the finite mask value -1e30; l
// floored at 1e-30, so a row with valid_len = 0 writes zeros.
//
// Bound on an H100: decoding reads every live K and V row once and does G
// flops per byte of K and V (G = Hq / Hkv query heads a KV head), far below
// the ~295 flops/byte at which the card stops being memory-bound.  At the
// serving shape (minicpm-2b, batch 8, valid_len 544, bf16) the bound is
// 2*8*544*36*64*2 B = 40 MB at 3.35 TB/s, about 12 us; gemma3-1b's global
// layer at batch 1 and a 128k cache reads 2*131072*256*2 B = 134 MB, 40 us;
// a step at hd 128 over 8 KV heads (minitron-8b), batch 8 over 544 keys,
// 2*8*544*8*128*2 B = 17.8 MB, 5.4 us; phi-3's (hd 96, 32 heads) at
// batch 8, 2*8*544*32*96*2 B = 53.5 MB, 16 us.  Which body runs is the
// wrapper's decode_instance:
//   - dec_kernel, on the CUDA cores: float32 (its tolerance needs full-f32
//     products), and bf16 where no published config decodes: hd 32 and 72,
//     hd 128 with G = 1, hd 64 and 96 past G = 8.
//   - dec_kernel_tc, on the tensor cores: bf16 at hd 256 (gemma3-1b), at
//     hd 128 with 2 <= G <= 8 (minitron-8b, llama4-scout; mixtral-8x22b's
//     layers all slide a window and decode through plain attention) and at
//     hd 64 and 96 with G <= 8 (minicpm-2b's G 1, zamba2-1.2b,
//     whisper-tiny; phi3-mini's and phi-3-vision's G 1): every published
//     bf16 config.  There dec_kernel paid a 5-step shuffle reduction for
//     every score of every query head and could not score as fast as it
//     loaded: at hd 128, G 4 to 6, batch 8 over 544 keys it took
//     0.038-0.075 ms, 1.75-3.4x SDPA, where dec_kernel_tc takes
//     0.019-0.020; at hd 64, G 1, batch 1 over 32768 keys 0.139 ms against
//     0.115-0.119; at hd 96, G 1, batch 8 over 544 keys 0.041 ms against
//     0.032 (PERF.md, section 6).
// The design is about bytes in flight:
//
// * Split over the cache.  The wrapper's plan (kernels/decode_attention.py,
//   split_plan) cuts L into n_split contiguous ranges of `chunk` keys, one
//   CTA each.  Up to 8 ranges (one portable cluster) aim at four CTAs per
//   SM over B * Hkv * n_split; where B * Hkv is too small for 8 ranges each
//   to fill the card (one KV head at batch 1), a long cache is cut into as
//   many ranges as one CTA per SM gives, each of at least MIN_CHUNK keys.
//   The tensor-core body at hd 64 and 128 takes split_plan_tc instead: at
//   most one CTA per SM (but one range where B * Hkv alone passes the SMs)
//   and one cluster, ranges of about 256 keys or more, whose warps stream
//   two stages each; at hd 96 at most one CTA per two
//   SMs and ranges of about 1024 keys or more.  A range at or past
//   valid_len reads nothing.
// * Combine in the same launch, by one of two means (split_groups), or,
//   for a plan of one range, not at all: the CTA's 8 warps' partials go
//   straight into o, launched without a cluster (at hd 64, batch 8, that
//   saved 5-6 % of the launch; PERF.md, section 6):
//   - cluster (hd <= 128, n_split <= 8): the n_split CTAs of one (b, KV
//     head) form one thread-block cluster.  Each leaves its partial (m, l,
//     acc) in its shared memory; after a cluster barrier, rank 0 reads the
//     others' partials through distributed shared memory, combines them by
//     log-sum-exp and writes o; a second barrier keeps them alive until
//     read.  No global scratch or atomics.
//   - tickets (hd 256 at every plan, where one group is 1-3 % faster
//     than a cluster at batch 1 and level at batch 8; any head dim past 8
//     ranges): no cluster.  Each CTA writes its partial to global scratch
//     (the wrapper's torch.empty, one per launch), fences, and takes a
//     ticket of its group of `group` consecutive ranges; the last to
//     arrive combines the group's partials in range order and writes o,
//     or, with several groups, the group's partial, and takes a ticket of
//     the (b, KV head), whose last group combines the groups in order.
//     The others exit at once: no barrier between CTAs at all, and no CTA
//     waits for another to be scheduled.
//     The order of every sum is fixed, whichever CTA arrives last, so a
//     replay is equal bit for bit.  The tickets sit at the end of the
//     same scratch and the launcher zeroes them on the launch's stream
//     (cudaMemsetAsync, a memset node in a captured graph), so each launch
//     and each replay counts on its own: launches on two streams at once,
//     or a launch that aborted, share no counter.
// * Loads and scores, two ways:
//   - dec_kernel (decode_instance's "cuda_cores"): K/V tiles of 32 keys
//     stream through a four-stage ring of 16-byte cp.async copies by every
//     thread, in the input's dtype (not widened), so three tiles are in
//     flight while one is scored.  The ring is small (32 KB at hd 64 in
//     bf16), so six CTAs fit on an SM and batch 8 runs in one wave; at hd
//     256 in float32 four stages would take 256 KB, so that instance keeps
//     three (192 KB).  Each of the 8 warps owns 4 keys of a tile and runs
//     its own online softmax on the CUDA cores: lanes span the head dim
//     (two elements each), a shuffle reduction gives each key's score, and
//     all G query rows share the K/V row.
//   - dec_kernel_tc ("tensor_cores": bf16 at hd 256, at hd 128 with 2 <=
//     G <= 8, at hd 64 and 96 with G <= 8): each warp on its own 16-key
//     blocks loaded by TMA; see the comment above it.  On the CUDA cores
//     the G = 4 heads of hd 256 cost about 600 instructions a warp per 4
//     keys (4 KB of K and V), the G = 6 heads of hd 128 about 640 per 2
//     KB, and even G = 1 at hd 64 and 96 five shuffles for every score.
//   The 8 warps' partials are combined in shared memory first.
#include <cmath>
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

namespace cg = cooperative_groups;
namespace hp = repro::hopper;
using repro::NEG_INF;
constexpr int BK = 32;      // keys per tile
constexpr int NT = 256;     // threads per CTA (8 warps)
constexpr int NW = NT / 32;
constexpr int KG = 4;       // keys a warp scores together
constexpr int MAX_CLUSTER = 8;   // ranges of the cluster combine (portable)
constexpr int MAX_GROUP = 32;    // partials one ticket combine reads
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
  // then: the CTA's partial (cluster combine), the combine's weights and
  // its partials' l, 1 / l, the last-arrival flag
  static constexpr int WTS_OFF = SCRATCH + PART;
  static constexpr int LS_OFF = WTS_OFF + MAX_GROUP * GC * 4;
  static constexpr int INV_OFF = LS_OFF + MAX_GROUP * GC * 4;
  static constexpr int FLAG_OFF = INV_OFF + GC * 4;
  static constexpr int SMEM = FLAG_OFF + 16;
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

// The log-sum-exp combine of `count` partials at src (each `ps` floats:
// m[G], l[G], acc[G*HD]), in their order, by the whole CTA: into the
// partial at dst, or, where dst is null, o / l into o.  Reads bypass L1
// (other CTAs wrote them) and are issued together, not one partial after
// another: every m and l at once into shared memory (ml: m, then the
// weights, and ls: l, MAX_GROUP * GC floats each), then each thread's
// accumulator elements, four partials at a time.
template <typename T, int HD, int GC>
__device__ __forceinline__ void combine(const float* src, int count, int ps,
                                        int G, float* dst, T* o, float* ml,
                                        float* ls, float* inv, int tid) {
  for (int i = tid; i < count * G; i += NT) {
    const int r = i / G, g = i - r * G;
    ml[r * GC + g] = __ldcg(src + r * ps + g);
    ls[r * GC + g] = __ldcg(src + r * ps + G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    float M = NEG_INF;
    for (int r = 0; r < count; ++r) M = fmaxf(M, ml[r * GC + g]);
    float s = 0.f;
    for (int r = 0; r < count; ++r) {
      const float w = fast_exp2(ml[r * GC + g] - M);
      ml[r * GC + g] = w;
      s = fmaf(w, ls[r * GC + g], s);
    }
    if (dst) {
      dst[g] = M;
      dst[G + g] = s;
    } else {
      inv[g] = 1.f / fmaxf(s, 1e-30f);
    }
  }
  __syncthreads();
  constexpr int PER = (GC * HD + NT - 1) / NT;   // a thread's elements
  float a[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) a[j] = 0.f;
#pragma unroll 4
  for (int r = 0; r < count; ++r) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = tid + NT * j;
      if (p < G * HD)
        a[j] = fmaf(ml[r * GC + p / HD], __ldcg(src + r * ps + 2 * G + p),
                    a[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = tid + NT * j;
    if (p >= G * HD) break;
    if (dst)
      dst[2 * G + p] = a[j];
    else
      o[p] = repro::from_float<T>(a[j] * inv[p / HD]);
  }
}

// One ticket of `members` arrivals at *ticket: true for the last;
// broadcast to the CTA through *flag.  Thread 0's fences order the whole
// CTA's partial, which the barrier before them orders for it (fences are
// cumulative), before its arrival, and the others' partials after it, for
// the reads that follow the barrier after.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket,
                                               int members, int* flag,
                                               int tid) {
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(ticket, 1u) == (unsigned int)(members - 1);
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

// The 8 warps' partials at w0 (each WS = 2*GC + GC*HD floats: m, l, acc)
// -> the CTA's (m, l, acc): m at pm[g], l at pl[g], acc at pa[g * HD + d]
template <int HD, int GC>
__device__ __forceinline__ void cta_partial(const float* w0, float* pm,
                                            float* pl, float* pa, int G,
                                            int tid) {
  constexpr int WS = 2 * GC + GC * HD;
  for (int p = tid; p < G * HD; p += NT) {
    const int g = p / HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w0[w * WS + g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a = fmaf(fast_exp2(w0[w * WS + g] - M), w0[w * WS + 2 * GC + p], a);
    pa[p] = a;
  }
  for (int g = tid; g < G; g += NT) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w0[w * WS + g]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      s = fmaf(fast_exp2(w0[w * WS + g] - M), w0[w * WS + GC + g], s);
    pm[g] = M;
    pl[g] = s;
  }
}

// One range (n_split 1): the 8 warps' partials at w0 straight into o, by
// log-sum-exp in warp order, with no CTA partial and no cluster
template <typename T, int HD, int GC>
__device__ __forceinline__ void cta_output(const float* w0, T* o, int G,
                                           int tid) {
  constexpr int WS = 2 * GC + GC * HD;
  for (int p = tid; p < G * HD; p += NT) {
    const int g = p / HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, w0[w * WS + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = fast_exp2(w0[w * WS + g] - M);
      a = fmaf(e, w0[w * WS + 2 * GC + p], a);
      l = fmaf(e, w0[w * WS + GC + g], l);
    }
    o[p] = repro::from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

// The ticket combine, after the warps' partials are at w0: this CTA's
// partial into its slot of scratch (B * Hkv * (n_split + groups) slots of
// G * (HD + 2) floats, then the tickets: B * Hkv * groups of the groups,
// B * Hkv of the (b, KV head)s), then the last of its group of `group`
// ranges combines the group, and the last group the groups
template <typename T, int HD, int GC>
__device__ __forceinline__ void ticket_combine(
    const float* w0, float* scratch, T* o, float* wts, float* ls, float* inv,
    int* flag, int G, int group, int tid) {
  const int split = blockIdx.x, n_split = gridDim.x;
  const int ps = G * (HD + 2);
  const long bh = (long)blockIdx.z * gridDim.y + blockIdx.y;
  const int groups = (n_split + group - 1) / group;
  const int grp = split / group, first = grp * group;
  const int members = min(group, n_split - first);
  const long bhs = (long)gridDim.z * gridDim.y;
  float* slot = scratch + (bh * n_split + split) * ps;
  unsigned int* tickets =
      reinterpret_cast<unsigned int*>(scratch + bhs * (n_split + groups) * ps);
  cta_partial<HD, GC>(w0, slot, slot + G, slot + 2 * G, G, tid);
  if (!last_to_arrive(&tickets[bh * groups + grp], members, flag, tid))
    return;
  float* gslot = scratch + (bhs * n_split + bh * groups) * ps;
  combine<T, HD, GC>(scratch + (bh * n_split + first) * ps, members, ps, G,
                     groups > 1 ? gslot + grp * ps : nullptr, o, wts, ls,
                     inv, tid);
  if (groups == 1) return;
  if (!last_to_arrive(&tickets[bhs * groups + bh], groups, flag, tid))
    return;
  combine<T, HD, GC>(gslot, groups, ps, G, nullptr, o, wts, ls, inv, tid);
}

// The cluster combine, after the warps' partials are at w0 (the launch is
// one cluster of the n_split CTAs of each (b, KV head)): this CTA's partial
// into `part` in its shared memory; after a cluster barrier, rank 0 reads
// the n_split partials through distributed shared memory, combines them in
// range order and writes o; a second barrier keeps every partial alive
// until read
template <typename T, int HD, int GC>
__device__ __forceinline__ void cluster_combine(const float* w0, float* part,
                                                float* wts, float* inv, T* o,
                                                int G, int n_split, int tid) {
  cta_partial<HD, GC>(w0, part, part + GC, part + 2 * GC, G, tid);
  cg::cluster_group cluster = cg::this_cluster();
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
      o[p] = repro::from_float<T>(a * inv[g]);
    }
  }
  cluster.sync();
}

// CUDA cores: every launch that decode_instance does not put on the tensor
// cores.
// split = blockIdx.x of gridDim.x = n_split ranges of `chunk` keys;
// group: 0 for the cluster combine (the launch is one cluster of n_split
// CTAs per (b, KV head)), else the ticket combine's ranges per group, with
// scratch its partials (wrapper-allocated)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(NT)
    dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ valid_len,
               const int* __restrict__ rows, T* __restrict__ o,
               float* __restrict__ scratch, int L, int Hq, int Hkv, int chunk,
               int group, float scale_log2) {
  using C = Cfg<T, HD, GC>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;
  constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem + C::SCRATCH);  // m, l, acc
  float* wts = reinterpret_cast<float*>(smem + C::WTS_OFF);  // per (r, g)
  float* ls = reinterpret_cast<float*>(smem + C::LS_OFF);    // per (r, g)
  float* inv = reinterpret_cast<float*>(smem + C::INV_OFF);  // 1 / l per g
  int* flag = reinterpret_cast<int*>(smem + C::FLAG_OFF);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long kv_row = (long)Hkv * HD;
  const long qo_off = ((long)b * Hq + (long)hk * G) * HD;
  const long kr = rows ? rows[b] : b;               // the cache row
  const T* kb = k + kr * L * kv_row + (long)hk * HD;
  const T* vb = v + kr * L * kv_row + (long)hk * HD;
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

  // the 8 warps' partials, in the ring
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

  if (n_split == 1) {
    cta_output<T, HD, GC>(w0, o + qo_off, G, tid);
    return;
  }
  if (group == 0) {
    cluster_combine<T, HD, GC>(w0, part, wts, inv, o + qo_off, G, n_split,
                               tid);
    return;
  }
  ticket_combine<T, HD, GC>(w0, scratch, o + qo_off, wts, ls, inv, flag, G,
                            group, tid);
}

// -- bf16 on the tensor cores: hd 256, hd 128 with 2 <= G <= 8, hd 64 and 96
// with G <= 8 ----------------------------------------------------------------
// Each warp streams its own 16-key blocks of the CTA's range (blocks w, w +
// 8, ...) through its own stages: one TMA box of 16 rows a panel, panels of
// 64 columns under the 128-byte swizzle (HD / 64 of K and as many of V: 4
// KB a stage at hd 64, 8 KB at hd 128, 16 KB at hd 256) or, at hd 96, three
// of 32 columns under the 64-byte swizzle (6 KB), one mbarrier a stage.  A
// warp has two stages at hd 64 to 128, so that one block loads while the
// other is scored, and one at hd 256, where two would not fit.  At G = 1
// (minicpm-2b, phi-3) seven of the 8 head columns of each mma are zeros: they
// cost tensor-core issue slots, not bytes, in a kernel bound by its bytes,
// and the score of a key is one mma fragment, not a shuffle reduction.
// S^T = K q^T is mma.sync m16n8k16 with the 16 keys as rows (ldmatrix from
// the swizzled panels: no bank conflict) and q^T (the G <= 8 query heads,
// zero-padded to 8 columns) as a register operand loaded once: HD / 16
// k-steps.  The online softmax runs on the fragments (max over the 16 keys
// by three shuffles, the sum per lane until the end); P^T, rounded to bf16
// and moved by four shuffles into the B-operand layout, then gives O^T +=
// V^T P^T, HD / 16 mma of 16 head-dim rows (ldmatrix.trans of V).  A
// block's keys past the range score -1e30; the box's rows there are real
// keys or TMA's zeros, never stale, so P = 0 meets finite values.  No CTA
// barrier until the end; then the warps' partials, combined over a cluster
// (up to 8 ranges at hd 64 to 128) or by tickets (hd 256, and past 8
// ranges), as the wrapper's group says.
constexpr int TC_KB = 16;                     // keys per block

template <int HD>
struct TcCfg {
  // head capacity: G * HD <= 1024, and the mma's 8 columns
  static constexpr int GC = 1024 / HD < 8 ? 1024 / HD : 8;
  // a panel's columns: 64 (128-byte rows, 128-byte swizzle), or 32 (64-byte
  // rows, 64-byte swizzle) where 64 does not divide HD, so that hd 96 loads
  // no padding: three panels, 6 KB a stage, where two of 64 columns would
  // take 8 KB and allow one CTA an SM in place of two
  static constexpr int PCOLS = HD % 64 ? 32 : 64;
  static constexpr int ROWB = 2 * PCOLS;                // bytes a panel row
  static constexpr int PANEL = TC_KB * ROWB;            // 16 rows
  static constexpr int PANELS = (HD + PCOLS - 1) / PCOLS;
  static constexpr int SPP = PCOLS / 16;                // k-steps a panel
  static constexpr int STAGE = 2 * PANELS * PANEL;      // K and V of a block
  static constexpr int STAGES = HD <= 128 ? 2 : 1;      // a warp's
  static constexpr int WS = 2 * GC + GC * HD; // a warp's partial (floats)
  // the warps' partials and the CTA's (cluster combine) fit one stage a warp
  static_assert((NW + 1) * WS * 4 <= NW * STAGE, "the partials fit the ring");
  // from the base rounded up to 1024 (the swizzle atom): the warps'
  // mbarriers, the combine's weights and l, 1 / l, the flag; then the ring
  static constexpr int BAR_OFF = 0;
  static constexpr int WTS_OFF = BAR_OFF + 8 * NW * STAGES;
  static constexpr int LS_OFF = WTS_OFF + MAX_GROUP * GC * 4;
  static constexpr int INV_OFF = LS_OFF + MAX_GROUP * GC * 4;
  static constexpr int FLAG_OFF = INV_OFF + GC * 4;
  static constexpr int RING_OFF = (FLAG_OFF + 16 + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + RING_OFF + NW * STAGES * STAGE;
};

// The byte offset of 16-byte chunk c of row r in a TMA-swizzled panel of
// ROWB-byte rows at a 1024-byte boundary: the 128-byte swizzle XORs the
// chunk with r mod 8, the 64-byte one with (r / 2) mod 4.  Either way the 8
// rows that one ldmatrix phase reads at one chunk fall in 8 distinct 16-byte
// groups of banks: no bank conflict.
template <int ROWB>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * ROWB + ((c ^ (ROWB == 128 ? r & 7 : (r >> 1) & 3)) << 4);
}

// Three CTAs an SM at hd 64 (80 registers a thread and 67 KB of shared
// memory each), so that batch 8 of minicpm-2b's 36 heads, 288 CTAs of one
// range, runs in one wave; two at hd 96 (100 KB each), so that phi-3's
// 256 CTAs at batch 8 do too; one at hd 128 and 256.
template <int HD>
__global__ void __launch_bounds__(NT, HD == 64 ? 3 : HD == 96 ? 2 : 1)
    dec_kernel_tc(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __nv_bfloat16* __restrict__ q,
                  const int* __restrict__ valid_len,
                  const int* __restrict__ rows,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ scratch,
                  int L, int Hq, int Hkv, int chunk, int group,
                  float scale_log2) {
  using C = TcCfg<HD>;
  constexpr int GC = C::GC, PANELS = C::PANELS, KS = HD / 16;
  constexpr int ST = C::STAGES, PANEL = C::PANEL, SPP = C::SPP;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t raw = hp::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* basep = smem + (base - raw);
  float* wts = reinterpret_cast<float*>(basep + C::WTS_OFF);
  float* ls = reinterpret_cast<float*>(basep + C::LS_OFF);
  float* inv = reinterpret_cast<float*>(basep + C::INV_OFF);
  int* flag = reinterpret_cast<int*>(basep + C::FLAG_OFF);
  float* w0 = reinterpret_cast<float*>(basep + C::RING_OFF);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row group, column pair
  const long qo_off = ((long)b * Hq + (long)hk * G) * HD;
  const int n = max(0, min(valid_len[b], L));      // keys that attend
  const int kr = rows ? rows[b] : b;               // the cache row
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, n);
  const int nblk = k_end > k_begin ? (k_end - k_begin + TC_KB - 1) / TC_KB : 0;
  // this warp's blocks: u-th is block warp + NW * u, in stage u % ST
  const int mine = warp < nblk ? (nblk - 1 - warp) / NW + 1 : 0;

  const uint32_t ring = base + C::RING_OFF + warp * ST * C::STAGE;
  const uint32_t bar0 = base + C::BAR_OFF + 8 * ST * warp;
#pragma unroll
  for (int st = 0; st < ST; ++st) hp::mbar_init(bar0 + 8 * st, 1, lane == 0);
  hp::fence_mbar_init();
  __syncthreads();
  // the u-th block into its stage; lane 0 issues, predicated
  auto issue = [&](int u) {
    const int k0 = k_begin + (warp + NW * u) * TC_KB;
    const uint32_t sK = ring + (u % ST) * C::STAGE;
    const uint32_t sV = sK + PANELS * PANEL;
    const uint32_t bar = bar0 + 8 * (u % ST);
    const bool on = lane == 0;
    hp::mbar_expect_tx(bar, C::STAGE, on);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      hp::tma_load4(sK + p * PANEL, &tk, C::PCOLS * p, hk, k0, kr, bar, on);
      hp::tma_load4(sV + p * PANEL, &tv, C::PCOLS * p, hk, k0, kr, bar, on);
    }
  };
#pragma unroll
  for (int u = 0; u < ST; ++u)
    if (u < mine) issue(u);

  // q^T as the B operand of S^T: k-step st holds head dims 16st..16st+15;
  // column g is query head g (zero past G)
  uint32_t qf[KS][2];
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    const __nv_bfloat16* qp = q + qo_off + (long)g * HD + 16 * st + 2 * t4;
    qf[st][0] = g < G ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
    qf[st][1] = g < G ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
  }
  // O^T: rows 16mb + g (+ 8) of the head dim, columns (query heads) 2t4, +1
  float acc[KS][4];
#pragma unroll
  for (int mb = 0; mb < KS; ++mb)
    acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // heads 2t4, 2t4 + 1
  // ldmatrix: lane names row (lane & 7) of matrix lane >> 3
  const int mi = lane >> 3, rr = lane & 7;

  for (int u = 0; u < mine; ++u) {
    hp::mbar_wait(bar0 + 8 * (u % ST), (u / ST) & 1);
    const int k0 = k_begin + (warp + NW * u) * TC_KB;
    const uint32_t sK = ring + (u % ST) * C::STAGE;
    const uint32_t sV = sK + PANELS * PANEL;
    // S^T (16 keys x 8 heads): A = K (keys x dims) from the panels, k-step
    // st in panel st / SPP
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      const int row = rr + 8 * (mi & 1);
      const int chunk16 = 2 * (st % SPP) + (mi >> 1);
      uint32_t a[4];
      hp::ldsm_x4(a, sK + (st / SPP) * PANEL +
                         swizzled<C::ROWB>(row, chunk16));
      hp::mma_bf16(s, a, qf[st][0], qf[st][1]);
    }
    // s[0], s[1]: key g, heads 2t4, +1; s[2], s[3]: key g + 8
    if (k0 + g >= k_end) s[0] = s[1] = NEG_INF;
    if (k0 + g + 8 >= k_end) s[2] = s[3] = NEG_INF;
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(s[e], s[2 + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[e], mx);
      alpha[e] = fast_exp2((m[e] - mn) * scale_log2);
      m[e] = mn;
      // scores stay unscaled until the exponent, as in the flash kernel
      s[e] = fast_exp2((s[e] - mn) * scale_log2);
      s[2 + e] = fast_exp2((s[2 + e] - mn) * scale_log2);
      l[e] = l[e] * alpha[e] + (s[e] + s[2 + e]);   // per lane until the end
    }
    // P^T as the B operand: lane (g, t4) takes P^T rows 2t4, +1, +8, +9 of
    // column g, held by lanes 8t4 + g/2 (rows 2t4, +8) and + 4 (rows
    // 2t4 + 1, +9), at parity g & 1
    const uint32_t x0 = hp::pack_bf16(s[0], s[2]);
    const uint32_t x1 = hp::pack_bf16(s[1], s[3]);
    const int src = 8 * t4 + (g >> 1);
    const uint32_t a0 = __shfl_sync(0xffffffffu, x0, src);
    const uint32_t a1 = __shfl_sync(0xffffffffu, x1, src);
    const uint32_t c0 = __shfl_sync(0xffffffffu, x0, src + 4);
    const uint32_t c1 = __shfl_sync(0xffffffffu, x1, src + 4);
    const uint32_t u0 = (g & 1) ? a1 : a0, w = (g & 1) ? c1 : c0;
    const uint32_t pb0 = __byte_perm(u0, w, 0x5410);  // rows 2t4, 2t4 + 1
    const uint32_t pb1 = __byte_perm(u0, w, 0x7632);  // rows + 8, + 9
    // O^T += V^T P^T: A = V^T (dims x keys), ldmatrix.trans of V's rows
#pragma unroll
    for (int mb = 0; mb < KS; ++mb) {
      acc[mb][0] *= alpha[0];
      acc[mb][1] *= alpha[1];
      acc[mb][2] *= alpha[0];
      acc[mb][3] *= alpha[1];
      const int key = rr + 8 * (mi >> 1);
      const int chunk16 = 2 * (mb % SPP) + (mi & 1);
      uint32_t a[4];
      hp::ldsm_x4_trans(a, sV + (mb / SPP) * PANEL +
                               swizzled<C::ROWB>(key, chunk16));
      hp::mma_bf16(acc[mb], a, pb0, pb1);
    }
    __syncwarp();                      // every lane has read the stage
    if (u + ST < mine) issue(u + ST);
  }
  __syncthreads();                     // the ring is free for the partials

  // this warp's partial: m (in the log2 units the combine takes), l
  // (summed over the lanes of a column) and O
  float* wp = w0 + warp * C::WS;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
    const int qh = 2 * t4 + e;
    if (qh < G) {
      if (g == 0) {
        wp[qh] = m[e] * scale_log2;
        wp[GC + qh] = l[e];
      }
#pragma unroll
      for (int mb = 0; mb < KS; ++mb) {
        wp[2 * GC + qh * HD + 16 * mb + g] = acc[mb][e];
        wp[2 * GC + qh * HD + 16 * mb + g + 8] = acc[mb][2 + e];
      }
    }
  }
  __syncthreads();
  if (gridDim.x == 1) {
    cta_output<__nv_bfloat16, HD, GC>(w0, o + qo_off, G, tid);
    return;
  }
  if (group == 0) {
    cluster_combine<__nv_bfloat16, HD, GC>(w0, w0 + NW * C::WS, wts, inv,
                                           o + qo_off, G, gridDim.x, tid);
    return;
  }
  ticket_combine<__nv_bfloat16, HD, GC>(w0, scratch, o + qo_off, wts, ls, inv,
                                        flag, G, group, tid);
}

// the ticket combine's bounds: its groups and their number
inline bool tickets_fit(float* scratch, int n_split, int group) {
  const int groups = (n_split + group - 1) / group;
  return scratch && group >= 1 && group <= MAX_GROUP && groups <= MAX_GROUP;
}

// zero the ticket combine's tickets, after its partials in scratch, on the
// launch's stream
template <int HD>
cudaError_t zero_tickets(float* scratch, int B, int Hkv, int G, int n_split,
                         int group, cudaStream_t stream) {
  const long bhs = (long)B * Hkv, groups = (n_split + group - 1) / group;
  return cudaMemsetAsync(scratch + bhs * (n_split + groups) * G * (HD + 2),
                         0, bhs * (groups + 1) * sizeof(unsigned int),
                         stream);
}

// dec_kernel: the CUDA cores.  GC is compiled only where a G past the
// capacity below it can meet G * hd <= 1024 (the wrapper's
// MAX_GROUP_WIDTH)
template <typename T, int HD, int GC>
int launch(const void* q, const void* k, const void* v, const int* vlen,
           const int* rows, void* o, float* scratch, int B, int L, int Hq,
           int Hkv, int n_split, int chunk, int group, cudaStream_t stream) {
  constexpr int PREV = GC == 1 ? 0 : GC == 4 ? 1 : GC == 16 ? 4 : 16;
  if constexpr (PREV >= 1024 / HD) {
    return -1;
  } else {
    if (group == 0 ? n_split > MAX_CLUSTER
                   : !tickets_fit(scratch, n_split, group))
      return -1;
    if (group > 0) {
      const cudaError_t err =
          zero_tickets<HD>(scratch, B, Hkv, Hq / Hkv, n_split, group, stream);
      if (err != cudaSuccess) return (int)err;
    }
    const float scale_log2 = (float)(LOG2E / std::sqrt((double)HD));
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
    cfg.numAttrs = group == 0 && n_split > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                             static_cast<const T*>(k),
                             static_cast<const T*>(v), vlen, rows,
                             static_cast<T*>(o), scratch, L, Hq, Hkv, chunk,
                             group, scale_log2);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

template <typename T, int HD>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* vlen, const int* rows, void* o, float* scratch,
               int B, int L, int Hq, int Hkv, int n_split, int chunk,
               int group, cudaStream_t s) {
#define REPRO_DEC_G(GC)                                                     \
  if (G <= GC)                                                              \
    return launch<T, HD, GC>(q, k, v, vlen, rows, o, scratch, B, L, Hq,     \
                             Hkv, n_split, chunk, group, s);
  REPRO_DEC_G(1)
  REPRO_DEC_G(4)
  REPRO_DEC_G(16)
  REPRO_DEC_G(32)
#undef REPRO_DEC_G
  return -1;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* vlen, const int* rows, void* o, float* scratch,
                int B, int L, int Hq, int Hkv, int n_split, int chunk,
                int group, cudaStream_t s) {
  const int G = Hq / Hkv;
#define REPRO_DEC_HD(HD)                                                    \
  case HD:                                                                  \
    return dispatch_g<T, HD>(G, q, k, v, vlen, rows, o, scratch, B, L, Hq,  \
                             Hkv, n_split, chunk, group, s);
  switch (hd) {
    REPRO_DEC_HD(32)
    REPRO_DEC_HD(64)
    REPRO_DEC_HD(72)
    REPRO_DEC_HD(96)
    REPRO_DEC_HD(128)
    REPRO_DEC_HD(256)
    default: return -1;
  }
#undef REPRO_DEC_HD
}

// dec_kernel_tc (bf16): the cluster combine up to MAX_CLUSTER ranges where
// the wrapper asks for it (group 0), else tickets; the TMA maps span the R
// rows of the cache
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* vlen,
              const int* rows, void* o, float* scratch, int B, int R, int L,
              int Hq, int Hkv, int n_split, int chunk, int group,
              cudaStream_t stream) {
  using C = TcCfg<HD>;
  if (Hq / Hkv > C::GC) return -1;
  if (group == 0 ? n_split > MAX_CLUSTER
                 : !tickets_fit(scratch, n_split, group))
    return -1;
  if (group > 0) {
    const cudaError_t err =
        zero_tickets<HD>(scratch, B, Hkv, Hq / Hkv, n_split, group, stream);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap tk, tv;
  if (!hp::make_map_bshd(&tk, k, HD, Hkv, L, R, TC_KB, C::PCOLS) ||
      !hp::make_map_bshd(&tv, v, HD, Hkv, L, R, TC_KB, C::PCOLS))
    return -2;
  const int bytes = C::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      dec_kernel_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  // one range needs no combine: launched without a cluster, which saves
  // about a microsecond of a cluster launch's fixed cost (PERF.md,
  // section 6)
  cfg.numAttrs = group == 0 && n_split > 1 ? 1 : 0;
  const float scale_log2 = (float)(LOG2E / std::sqrt((double)HD));
  err = cudaLaunchKernelEx(&cfg, dec_kernel_tc<HD>, tk, tv,
                           static_cast<const __nv_bfloat16*>(q), vlen, rows,
                           static_cast<__nv_bfloat16*>(o), scratch, L, Hq,
                           Hkv, chunk, group, scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  Returns 0 on success, the cudaError_t of a
// refused launch, -1 for an instance, head dim, group or plan the kernel
// was not built for, or -2 if a TMA tensor map could not be made.  n_split
// CTAs of `chunk` keys each per (b, KV head): the wrapper's decode_plan;
// group: 0 to combine over one cluster of the n_split CTAs (n_split <= 8),
// else the ticket combine's ranges per group (split_groups),
// with `scratch` its float32 partials and then its B * Hkv * (groups + 1)
// tickets (zeroed here, on `stream`); tensor_cores: the body, which the
// wrapper's decode_instance alone chooses, 1 for dec_kernel_tc (bf16 at hd
// 64, 96, 128 and 256 only), 0 for dec_kernel (every dtype and head dim).
// rows: null for k/v of B rows, row b's cache at row b; else (B,) int32
// cache rows, each in [0, R), of k/v (R,L,Hkv,hd).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid_len,
                                      void* o, void* scratch,
                                      const void* rows, int is_bf16, int B,
                                      int R, int L, int Hq, int Hkv, int hd,
                                      int n_split, int chunk, int group,
                                      int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vlen = static_cast<const int*>(valid_len);
  const int* rw = static_cast<const int*>(rows);
  float* part = static_cast<float*>(scratch);
  if (n_split < 1 || chunk < 1 || group < 0 || R < 1 || (!rw && R != B))
    return -1;
  if (tensor_cores) {
    if (!is_bf16) return -1;
    if (hd == 64)
      return launch_tc<64>(q, k, v, vlen, rw, o, part, B, R, L, Hq, Hkv,
                           n_split, chunk, group, s);
    if (hd == 96)
      return launch_tc<96>(q, k, v, vlen, rw, o, part, B, R, L, Hq, Hkv,
                           n_split, chunk, group, s);
    if (hd == 128)
      return launch_tc<128>(q, k, v, vlen, rw, o, part, B, R, L, Hq, Hkv,
                            n_split, chunk, group, s);
    if (hd == 256)
      return launch_tc<256>(q, k, v, vlen, rw, o, part, B, R, L, Hq, Hkv,
                            n_split, chunk, group, s);
    return -1;
  }
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, vlen, rw, o, part, B, L,
                                      Hq, Hkv, n_split, chunk, group, s);
  return dispatch_hd<float>(hd, q, k, v, vlen, rw, o, part, B, L, Hq, Hkv,
                            n_split, chunk, group, s);
}
