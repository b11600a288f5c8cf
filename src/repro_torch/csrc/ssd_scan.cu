// Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py, function
// ssd_scan (body _ssd_kernel).  Same contract: x (B,S,H,P), dt (B,S,H)
// after softplus, A (H,) float32 <= 0, Bm and Cm (B,S,N) shared by every
// head, an optional init_state (B,H,P,N) float32 (null: zeros) -> y
// (B,S,H,P) in x's dtype and the final state (B,H,P,N) float32.  S is a
// multiple of the caller's chunk (the wrapper pads with dt = 0 steps).  For
// each chunk, with cum the inclusive cumulative sum of dA = dt * A[h] and
// total its last element:
//   y     = (exp(cum_i - cum_j) [i >= j] * C_i.B_j) . (x dt)
//         + exp(cum_i) * C_i . state^T
//   state = state * exp(total) + (x dt)^T . (B * exp(total - cum))
// The chunked form gives the same function for any chunk length (only the
// rounding moves), and the four exponents are <= 0, so nothing overflows.
//
// Bound on an H100: at the serving shape (mamba2-370m, batch 8, S = 512,
// H = 32, P = 64, N = 128, chunk 64, bf16) the function moves 44.3 MB (x, y,
// B, C, dt, the final state: 13.2 us at 3.35 TB/s) and does 7.5 GFLOP
// (7.6 us at the bf16 tensor-core peak), so the card's bound is the memory
// traffic.  The port's first kernel (one block per (b, h), chunks in order,
// f32 products on the CUDA cores) took 37x the bound: its products ran at a
// quarter of the f32 CUDA-core rate, and at batch 1 its 32 blocks left three
// quarters of the SMs idle.  Two kernels, picked by dtype in the C launcher:
//
// * bf16, ssd_kernel_wgmma.
//   - Chunks split across a thread-block cluster.  The wrapper's plan
//     (kernels/ssd_scan.py, ssd_plan) gives each (b, h) one cluster of
//     R <= 8 CTAs along the chunk axis, each owning a contiguous run of
//     64-row chunks, and takes the fewest ranks that give every SM a CTA:
//     batch 1 gets 4 ranks, batch 8 one.  Phase 1: every rank but the last
//     forms its run's local state from zero, and the run's summed decay.
//     Phase 2: after a cluster barrier, each rank folds the earlier ranks'
//     local states and the caller's init_state into its entering state,
//     nearest rank first, reading them through distributed shared memory; a
//     second barrier frees that memory.  Phase 3: each rank walks its run
//     again from that state and writes y; the last rank writes the final
//     state.  No per-chunk state goes to device memory.  A rank beyond one
//     CTA per SM costs more than it saves (the second walk and a 32 KB read
//     per earlier rank), so the plan splits only as far as the card needs.
//   - All four products on wgmma, one warpgroup per CTA.  The state (P x N)
//     stays in an f32 wgmma accumulator in registers for the whole scan, and
//     y is formed transposed (P x chunk), so that the state is the A operand
//     from registers:
//       S     = C B^T                m64n64,  C and B from shared memory
//       y^T   = state C^T            m64n64,  state from registers
//             + x^T W^T              m64n64,  x transposed from shared, W
//                                    written to shared from S's registers
//       state = state exp(total) + (x w)^T B   m64nN, (x w) from registers,
//                                              B transposed from shared
//     with W = S * exp(cum_i - cum_j) * dt_j masked to i >= j and w_j =
//     dt_j exp(total - cum_j).  C, B and x are the bf16 inputs; every f32
//     factor is folded into the operand that must be rounded (W, x w, the
//     state), and that operand goes in as a hi + lo pair of bf16 values (two
//     wgmmas), which keeps about 16 bits of it: one bf16 rounding of any
//     one of the three misses the bf16 tolerance against the f32 plain
//     version (tests/test_torch_ssd_split.py models each).  Every sum is
//     f32.
//     The chunk is always 64 rows (the wgmma M), whatever the caller's chunk.
//   - Loads are TMA copies with the 128-byte swizzle the descriptors name:
//     a 4-D map over x / y (B,S,H,P) and 3-D maps over B / C (B,S,N), whose
//     zero fill gives rows past S and columns past P and N (P pads to 64, N
//     to 64 or 128).  The products run over the padded columns, which add
//     zeros, so that no wgmma sits behind a branch.  x and B of the next
//     chunk load while this one computes (a two-slot ring); C has its own
//     two slots, which double as the exchange buffer of phase 2.  y leaves
//     by a TMA store.  Thread 0 issues every copy, but by a predicated
//     instruction that the whole warpgroup runs, never behind a branch that
//     splits warp 0 (the helpers of hopper.cuh).
//   - cum is a warp-level scan; dt of the next chunk is prefetched into
//     registers.  About 104 KB of shared memory at N = 128: two CTAs an SM.
// * float32, ssd_kernel_f32: the port's first kernel, unchanged.  Full-f32
//   products are what the f32 tolerance needs; f32 is on no serving path.
#include <cuda.h>

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------
// Grid: one block of 256 threads per (batch row, head), B*H blocks; the
// Pallas kernel's sequential chunk axis is a loop inside the block.
// Thread (tx, ty) = (tid % 16, tid / 16).  Shared memory, float32: the
// state (P x N+1), B and C of the chunk (Q x N+1 each), x*dt (Q x P), the
// masked decay-weighted C.B^T (Q x Q+1), cum and dt (Q each): 132 KB at
// P 64, N 128, Q 64, so dynamic shared memory above the 48 KB default.
namespace f32core {

constexpr int NT = 256;
constexpr int MAXR = 4;  // chunk rows per thread: Q / 16 for Q <= 64

template <int P, int N>
struct Layout {
  static constexpr int SS = N + 1;  // odd strides: conflict-free column reads
  static constexpr int BS = N + 1;
  static constexpr int CS = N + 1;
  static size_t bytes(int Q) {
    return sizeof(float) *
           ((size_t)P * SS + (size_t)Q * (BS + CS + P + (Q + 1) + 2));
  }
};

template <int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_kernel_f32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ st, int S, int H,
                   int Q) {
  using T = float;
  using Lt = Layout<P, N>;
  constexpr int PC = P / 16;  // y columns per thread; state rows per thread
  constexpr int NC = N / 16;  // state columns per thread
  extern __shared__ float smem[];
  float* state = smem;                 // P x SS
  float* Bs = state + P * Lt::SS;      // Q x BS
  float* Cs = Bs + Q * Lt::BS;         // Q x CS
  float* Xs = Cs + Q * Lt::CS;         // Q x P: x * dt
  float* Ls = Xs + Q * P;              // Q x Q+1
  float* cum = Ls + Q * (Q + 1);       // Q
  float* dts = cum + Q;                // Q

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int R = Q / 16;
  const int LS = Q + 1;  // odd: the two row groups of a warp hit two banks
  const float a = A[h];
  const long x_row = (long)H * P;  // elements between sequence positions
  const T* xb = x + (long)b * S * x_row + (long)h * P;
  const T* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * N;
  const T* Cb = Cm + (long)b * S * N;
  T* yb = y + (long)b * S * x_row + (long)h * P;

  // seed the carried state from the caller's, or zeros
  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N, n = e - p * N;
    state[p * Lt::SS + n] = s0 ? s0[(long)bh * P * N + e] : 0.f;
  }

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const int q0 = c * Q;
    __syncthreads();  // the previous chunk's readers are done
    repro::load_tile<T, P, NT>(Xs, P, xb + (long)q0 * x_row, x_row, Q, Q,
                               1.f, tid);
    repro::load_tile<T, N, NT>(Bs, Lt::BS, Bb + (long)q0 * N, N, Q, Q, 1.f,
                               tid);
    repro::load_tile<T, N, NT>(Cs, Lt::CS, Cb + (long)q0 * N, N, Q, Q, 1.f,
                               tid);
    if (tid < Q) dts[tid] = repro::to_float(dtb[(long)(q0 + tid) * H]);
    __syncthreads();
    if (tid == 0) {  // inclusive, in order, as jnp.cumsum
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }
    for (int e = tid; e < Q * P; e += NT) Xs[e] *= dts[e / P];
    __syncthreads();
    const float total = cum[Q - 1];

    // intra-chunk weights: Ls[i][j] = exp(cum_i - cum_j) * C_i.B_j, i >= j
    {
      float s[MAXR][MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int j = 0; j < MAXR; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[MAXR], bv[MAXR];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          cv[i] = i < R ? Cs[(ty * R + i) * Lt::CS + n] : 0.f;
#pragma unroll
        for (int j = 0; j < MAXR; ++j)
          bv[j] = j < R ? Bs[(tx + 16 * j) * Lt::BS + n] : 0.f;
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int j = 0; j < MAXR; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int j = 0; j < MAXR; ++j) {
          const int qi = ty * R + i, kj = tx + 16 * j;
          if (i < R && j < R)
            Ls[qi * LS + kj] =
                qi >= kj ? expf(cum[qi] - cum[kj]) * s[i][j] : 0.f;
        }
    }
    __syncthreads();

    // y rows ty*R + i, columns tx + 16*k: the intra-chunk term plus the
    // decayed contribution of the state entering the chunk
    {
      float yd[MAXR][PC], yo[MAXR][PC];
#pragma unroll
      for (int i = 0; i < MAXR; ++i)
#pragma unroll
        for (int k = 0; k < PC; ++k) yd[i][k] = yo[i][k] = 0.f;
      const int jmax = ty * R + R;  // Ls[i][j] = 0 for j > i
      for (int j = 0; j < jmax; ++j) {
        float lv[MAXR], xv[PC];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          lv[i] = i < R ? Ls[(ty * R + i) * LS + j] : 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = Xs[j * P + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int k = 0; k < PC; ++k) yd[i][k] = fmaf(lv[i], xv[k], yd[i][k]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[MAXR], sv[PC];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
          cv[i] = i < R ? Cs[(ty * R + i) * Lt::CS + n] : 0.f;
#pragma unroll
        for (int k = 0; k < PC; ++k) sv[k] = state[(tx + 16 * k) * Lt::SS + n];
#pragma unroll
        for (int i = 0; i < MAXR; ++i)
#pragma unroll
          for (int k = 0; k < PC; ++k) yo[i][k] = fmaf(cv[i], sv[k], yo[i][k]);
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        if (i >= R) continue;
        const int qi = ty * R + i;
        const float din = expf(cum[qi]);
#pragma unroll
        for (int k = 0; k < PC; ++k)
          yb[(long)(q0 + qi) * x_row + tx + 16 * k] =
              repro::from_float<T>(yd[i][k] + din * yo[i][k]);
      }
    }
    // B * exp(total - cum) in place: C.B^T above was its last plain reader
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      Bs[j * Lt::BS + n] *= expf(total - cum[j]);
    }
    __syncthreads();

    // state rows ty*PC + r, columns tx + 16*k:
    // state * exp(total) + sum_j (x dt)[j][p] * Bdecayed[j][n]
    {
      float acc[PC][NC];
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float xv[PC], bv[NC];
#pragma unroll
        for (int r = 0; r < PC; ++r) xv[r] = Xs[j * P + ty * PC + r];
#pragma unroll
        for (int k = 0; k < NC; ++k) bv[k] = Bs[j * Lt::BS + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < PC; ++r)
#pragma unroll
          for (int k = 0; k < NC; ++k) acc[r][k] = fmaf(xv[r], bv[k], acc[r][k]);
      }
      const float dec = expf(total);
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          float* s = &state[(ty * PC + r) * Lt::SS + tx + 16 * k];
          *s = *s * dec + acc[r][k];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N, n = e - p * N;
    st[(long)bh * P * N + e] = state[p * Lt::SS + n];
  }
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* s0, void* y, void* st, int B, int S,
           int H, int Q, cudaStream_t stream) {
  const size_t bytes = Layout<P, N>::bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_f32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_f32<P, N><<<B * H, NT, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(st), S, H, Q);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A,
               const void* Bm, const void* Cm, const void* s0, void* y,
               void* st, int B, int S, int H, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    default: return -1;
  }
}

}  // namespace f32core

// --------------------------------------------------------------------------
// bf16: a cluster per (b, h), wgmma on the tensor cores
// --------------------------------------------------------------------------
namespace wg {

using namespace repro::hopper;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
constexpr int T = 64;        // rows of a chunk: the wgmma M
constexpr int NT = 128;      // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the swizzle atom).  Tiles
// are bf16 in 64-column (128-byte) panels: panel k at +k*T*128, row r at
// +r*128, its 16-byte chunk c at chunk c ^ (r % 8).  NP: N padded to 64 or
// 128 columns.
template <int NP>
struct Cfg {
  static constexpr int X_BYTES = T * 64 * 2;      // x tile, P padded to 64
  static constexpr int BC_BYTES = T * NP * 2;     // a B or C tile
  static constexpr int XB_BYTES = X_BYTES + BC_BYTES;  // a slot of the x/B ring
  static constexpr int W_BYTES = T * T * 2;
  static constexpr int OFF_C = 2 * XB_BYTES;      // C ring = phase-2 exchange
  static constexpr int OFF_WHI = OFF_C + 2 * BC_BYTES;
  static constexpr int OFF_WLO = OFF_WHI + W_BYTES;
  static constexpr int OFF_Y = OFF_WLO + W_BYTES;  // y staging for the store
  static constexpr int OFF_CUM = OFF_Y + W_BYTES;  // 2 x (cum, dt)
  static constexpr int OFF_RUN = OFF_CUM + 4 * T * 4;  // the run's decay
  static constexpr int OFF_BAR = OFF_RUN + 16;     // x/B slots 0, 1; C 0, 1
  static constexpr int SMEM = OFF_BAR + 4 * 8 + 1024;  // + base alignment
  // the local state, one float4 per thread per 4 accumulator registers
  static_assert(NT * (NP / 2) * 4 == 2 * BC_BYTES, "exchange = C ring");
};

// a K-major tile (rows along M or N, K contiguous): k-step kk of 16
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (T * 128) + (kk & 3) * 32, 16, 1024);
}
// an MN-major tile (rows along K): k-step kk of 16 rows
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * (16 * 128), T * 128, 1024);
}

// v0, v1 as bf16 pairs hi and lo with hi + lo = v to about 16 bits
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (row, col) in a swizzled 64-column bf16 panel
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

// Accumulator fragment of a 64xN wgmma (f32): thread t of the warpgroup,
// warp w = t/32, lane; register i holds row 16w + lane/4 + 8*((i>>1)&1),
// column 8*(i/4) + 2*(lane%4) + (i&1).  Registers 8kk..8kk+7, packed in
// pairs, are the A fragment of k-step kk (columns 16kk..16kk+15 as K).
template <int NP>
__global__ void __launch_bounds__(NT, 2)
    ssd_kernel_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap ty,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const bf16* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ s0, float* __restrict__ st,
                     int S, int H, int P, int N, int cpc) {
  using C = Cfg<NP>;
  constexpr int NS = NP / 2;  // state accumulator registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same, as a pointer
  // per item t: cum (log2 units) then dt, T floats each, in buffer t & 1
  float* cums = reinterpret_cast<float*>(gbase + C::OFF_CUM);
  float* run_decay = reinterpret_cast<float*>(gbase + C::OFF_RUN);
  float* exch = reinterpret_cast<float*>(gbase + C::OFF_C);
  const uint32_t bars = base + C::OFF_BAR;
  const uint32_t whi = base + C::OFF_WHI, wlo = base + C::OFF_WLO;
  const uint32_t ysm = base + C::OFF_Y;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, R = gridDim.x;  // the cluster is one (b, h)
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nc = (S + T - 1) / T;
  const int c0 = rank * cpc;
  const int n = min(c0 + cpc, nc) - c0;  // this rank's chunks
  // Items t = 0 .. items-1: the phase-1 walk over the run, then the
  // phase-3 walk, through one x/B ring.  No rank reads the last rank's
  // local state, so it has no phase-1 walk.
  const int p1 = rank < R - 1 ? n : 0;
  const int items = p1 + n;
  const float a2 = A[h] * LOG2E;
  const bf16* dtb = dt + (long)b * S * H + h;

  auto chunk_of = [&](int t) { return c0 + (t < p1 ? t : t - p1); };
  auto xb_slot = [&](int t) { return base + (t & 1) * C::XB_BYTES; };
  auto c_slot = [&](int u) { return base + C::OFF_C + (u & 1) * C::BC_BYTES; };
  const bool lead = tid == 0;  // the thread that issues TMA copies
  auto load_xb = [&](int t) {
    const uint32_t bar = bars + 8 * (t & 1), dst = xb_slot(t);
    const int q0 = chunk_of(t) * T;
    mbar_expect_tx(bar, C::XB_BYTES, lead);
    tma_load4(dst, &tx, 0, h, q0, b, bar, lead);
#pragma unroll
    for (int k = 0; k < NP / 64; ++k)
      tma_load3(dst + C::X_BYTES + k * (T * 128), &tb, 64 * k, q0, b, bar,
                lead);
  };
  auto load_c = [&](int u) {
    const uint32_t bar = bars + 8 * (2 + (u & 1));
    mbar_expect_tx(bar, C::BC_BYTES, lead);
#pragma unroll
    for (int k = 0; k < NP / 64; ++k)
      tma_load3(c_slot(u) + k * (T * 128), &tc, 64 * k, (c0 + u) * T, b, bar,
                lead);
  };

  for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1, lead);
  fence_mbar_init();
  __syncthreads();
  for (int t = 0; t < 2 && t < items; ++t) load_xb(t);
  // with no phase 1 the C ring holds no exchange: load C at once
  if (p1 == 0)
    for (int u = 0; u < 2 && u < n; ++u) load_c(u);

  // Warp 0 keeps dt of the item after next in registers (rows lane and
  // lane + 32) and scans the next item's while the tensor cores run this
  // one's state update: cum = the inclusive sum of dt * A * log2(e), in
  // shared buffer t & 1 beside dt, published by the item's closing barrier.
  float dn0 = 0.f, dn1 = 0.f;
  auto load_dt = [&](int t) {
    const int q0 = chunk_of(t) * T;
    dn0 = q0 + lane < S ? __bfloat162float(dtb[(long)(q0 + lane) * H]) : 0.f;
    dn1 = q0 + lane + 32 < S
              ? __bfloat162float(dtb[(long)(q0 + lane + 32) * H])
              : 0.f;
  };
  auto scan = [&](int t) {  // warp 0: item t's cum and dt, then prefetch
    float* cum = cums + (t & 1) * 2 * T;
    float v0 = dn0 * a2, v1 = dn1 * a2;
    cum[T + lane] = dn0;
    cum[T + lane + 32] = dn1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
      const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    cum[lane] = v0;
    cum[lane + 32] = v1;
    if (t + 1 < items) load_dt(t + 1);
  };
  if (warp == 0 && items > 0) {
    load_dt(0);
    scan(0);
  }
  __syncthreads();

  float s[NS];  // the state: rows p, columns n (f32 accumulator fragment)
  // s <- s * exp(total) + (x w)^T B over item t's chunk, w_j = dt_j *
  // exp(total - cum_j), in two steps: prep_update decays s and forms
  // (x w)^T as hi + lo A fragments, issue_update queues the wgmmas.  Every
  // register that a wgmma reads or accumulates into is written before the
  // wgmma_fence that opens its stage, and left alone until the stage's
  // wait: a write inside a stage makes ptxas insert warpgroup arrives and
  // serialise the wgmmas.
  uint32_t ah[16], al[16];
  auto prep_update = [&](int t, uint32_t xs) {
    const float* cum = cums + (t & 1) * 2 * T;
    const float* dts = cum + T;
    const float total = cum[T - 1];
    const uint8_t* xg = gbase + (xs - base);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * warp + g + 8 * (r & 1);
        const int j = 16 * kk + 2 * t4 + 8 * (r >> 1);
        const float x0 = __bfloat162float(
            *reinterpret_cast<const bf16*>(xg + swz(j, p)));
        const float x1 = __bfloat162float(
            *reinterpret_cast<const bf16*>(xg + swz(j + 1, p)));
        split_bf16(x0 * dts[j] * fast_exp2(total - cum[j]),
                   x1 * dts[j + 1] * fast_exp2(total - cum[j + 1]),
                   ah[4 * kk + r], al[4 * kk + r]);
      }
    const float dec = fast_exp2(total);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= dec;
  };
  auto issue_update = [&](uint32_t bs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(s, ah + 4 * kk, desc_mn(bs, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(s, al + 4 * kk, desc_mn(bs, kk));
  };
  // commit what was issued, scan the next item meanwhile, wait for it all
  auto finish_item = [&](int t) {
    wgmma_commit();
    if (warp == 0 && t + 1 < items) scan(t + 1);
    wgmma_wait<0>();
  };
  // every thread is done with item t's slot: refill it with item t + 2
  auto end_item = [&](int t) {
    __syncthreads();
    if (t + 2 < items) {
      fence_async_smem();
      load_xb(t + 2);
    }
  };

  // -- phase 1: this run's local state from zero, and its summed decay ----
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float run = 0.f;
  for (int t = 0; t < p1; ++t) {
    mbar_wait(bars + 8 * (t & 1), (t >> 1) & 1);
    run += cums[(t & 1) * 2 * T + T - 1];
    prep_update(t, xb_slot(t));
    wgmma_fence();
    issue_update(xb_slot(t) + C::X_BYTES);
    finish_item(t);
    end_item(t);
  }

  // -- phase 2: the entering state, folded over the earlier ranks ---------
  if (R > 1) {
    if (p1 > 0) {
#pragma unroll
      for (int q = 0; q < NS / 4; ++q)
        reinterpret_cast<float4*>(exch)[q * NT + tid] =
            make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      *run_decay = run;  // the same value in every thread
    }
    cluster.sync();
  }
  // entering = init * exp(T_0 + .. + T_{r-1}) + sum_k local_k * exp(T_{k+1}
  // + .. + T_{r-1}), the nearest rank first: each CTA's exchange is read by
  // its successors at different times, not by all of them at once
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float decay = 1.f;
  for (int k = rank - 1; k >= 0; --k) {
    const float4* pe =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(exch, k));
    const float dk = decay;
    decay *= fast_exp2(*cluster.map_shared_rank(run_decay, k));
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      const float4 v = pe[q * NT + tid];
      s[4 * q] = fmaf(v.x, dk, s[4 * q]);
      s[4 * q + 1] = fmaf(v.y, dk, s[4 * q + 1]);
      s[4 * q + 2] = fmaf(v.z, dk, s[4 * q + 2]);
      s[4 * q + 3] = fmaf(v.w, dk, s[4 * q + 3]);
    }
  }
  if (s0) {
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int p = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t4;
      if (p < P && col < N) {
        const float2 v = *reinterpret_cast<const float2*>(
            s0 + (((long)b * H + h) * P + p) * N + col);
        s[i] = fmaf(v.x, decay, s[i]);
        s[i + 1] = fmaf(v.y, decay, s[i + 1]);
      }
    }
  }
  if (R > 1) {
    cluster.sync();  // every peer has read this CTA's exchange
    if (p1 > 0) {
      fence_async_smem();  // the exchange's generic accesses before TMA
      for (int u = 0; u < 2 && u < n; ++u) load_c(u);
    }
  }

  // -- phase 3: y over the run, from the entering state --------------------
  for (int u = 0; u < n; ++u) {
    const int t = p1 + u;
    const float* cum = cums + (t & 1) * 2 * T;
    const float* dts = cum + T;
    const uint32_t xs = xb_slot(t), bs = xs + C::X_BYTES, cs = c_slot(u);
    mbar_wait(bars + 8 * (t & 1), (t >> 1) & 1);
    mbar_wait(bars + 8 * (2 + (u & 1)), (u >> 1) & 1);

    // before the stage opens: the state as hi + lo A fragments, y^T zeroed
    float sc[32], yt[32];  // S = C B^T (rows i, columns j); y^T (rows p)
    uint32_t sh[NS / 2], sl[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i)
      split_bf16(s[2 * i], s[2 * i + 1], sh[i], sl[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) yt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss<0, 0>(sc, desc_k(cs, kk), desc_k(bs, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_rs<0>(yt, sh + 4 * kk, desc_k(cs, kk));
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_rs<0>(yt, sl + 4 * kk, desc_k(cs, kk));
    wgmma_commit();
    wgmma_wait<1>();  // S has landed; state C^T may still run

    // W = S * exp(cum_i - cum_j) * dt_j for i >= j, as hi and lo tiles
    // (rows i, K = j contiguous) for the B operand of x^T W^T
    uint8_t* wh = gbase + (whi - base);
    uint8_t* wl = gbase + (wlo - base);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t4;
      const float w0 = row >= col ? sc[i] * dts[col] *
                                        fast_exp2(cum[row] - cum[col])
                                  : 0.f;
      const float w1 = row >= col + 1 ? sc[i + 1] * dts[col + 1] *
                                            fast_exp2(cum[row] - cum[col + 1])
                                      : 0.f;
      uint32_t hi, lo;
      split_bf16(w0, w1, hi, lo);
      *reinterpret_cast<uint32_t*>(wh + swz(row, col)) = hi;
      *reinterpret_cast<uint32_t*>(wl + swz(row, col)) = lo;
    }
    fence_async_smem();
    wgmma_wait<0>();
    // the previous chunk's y store has read the staging tile
    bulk_wait_read(lead);
    __syncthreads();  // W is whole; every read of C slot u is done
    if (u + 2 < n) {
      fence_async_smem();
      load_c(u + 2);
    }
    // the state's term decays by exp(cum_i) along the columns of y^T
#pragma unroll
    for (int i = 0; i < 32; ++i)
      yt[i] *= fast_exp2(cum[8 * (i >> 2) + 2 * t4 + (i & 1)]);
    prep_update(t, xs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 0>(yt, desc_mn(xs, kk), desc_k(whi, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 0>(yt, desc_mn(xs, kk), desc_k(wlo, kk), 1);
    issue_update(bs);
    finish_item(t);

    // y^T -> the staging tile y[i][p], then one TMA store (clipped to S, P)
    uint8_t* yg = gbase + (ysm - base);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int q = 8 * (i >> 2) + 2 * t4 + (i & 1);
      *reinterpret_cast<bf16*>(yg + swz(q, p)) = __float2bfloat16_rn(yt[i]);
    }
    fence_async_smem();
    end_item(t);
    tma_store4(&ty, ysm, 0, h, (c0 + u) * T, b, lead);
    bulk_commit(lead);
  }
  // the last store has read its staging tile before the CTA's shared
  // memory goes
  bulk_wait_read(lead);

  if (rank == R - 1) {
    float* sb = st + ((long)b * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int p = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t4;
      if (p < P && col < N)
        *reinterpret_cast<float2*>(sb + (long)p * N + col) =
            make_float2(s[i], s[i + 1]);
    }
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

// A bf16 tensor as a `rank`-D map, innermost dimension first, with boxes of
// 64 columns x T rows (the other dimensions 1), 128-byte swizzle, zeros
// outside the tensor.  The row dimension is dims[rank - 2].
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  cuuint32_t box[4] = {64, 1, 1, 1};
  box[rank - 2] = T;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* s0, void* y, void* st, int B, int S,
           int H, int P, int N, int R, int cpc, cudaStream_t stream) {
  // (P, H, S, B) and (N, S, B); S >= 1 so that a map exists for S = 0
  const cuuint64_t S1 = S > 0 ? S : 1;
  const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)H, S1, (cuuint64_t)B};
  const cuuint64_t bd[3] = {(cuuint64_t)N, S1, (cuuint64_t)B};
  CUtensorMap tx, ty, tb, tc;
  if (!make_map(&tx, x, 4, xd) || !make_map(&ty, y, 4, xd) ||
      !make_map(&tb, Bm, 3, bd) || !make_map(&tc, Cm, 3, bd))
    return -2;
  const int bytes = Cfg<NP>::SMEM;
  auto kern = ssd_kernel_wgmma<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tx, ty, tb, tc,
                           static_cast<const bf16*>(dt),
                           static_cast<const float*>(A),
                           static_cast<const float*>(s0),
                           static_cast<float*>(st), S, H, P, N, cpc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// C interface for ctypes.  s0 may be null (a zero initial state).  The
// dtype picks the kernel: bf16 -> ssd_kernel_wgmma, one cluster of R CTAs
// per (b, h), each owning cpc 64-row chunks (the wrapper's ssd_plan; Q is
// not read); f32 -> ssd_kernel_f32 over chunks of Q (R and cpc are not
// read).  Returns 0 on success, the cudaError_t of a refused launch, -1 for
// a shape the kernel was not built for, or -2 if a TMA tensor map could not
// be made.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* s0,
                              void* y, void* st, int is_bf16, int B, int S,
                              int H, int P, int N, int Q, int R, int cpc,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P != 32 && P != 64) return -1;
  if (N != 16 && N != 32 && N != 64 && N != 128) return -1;
  if (is_bf16) {
    if (R < 1 || R > 8 || cpc < 1) return -1;
    return N <= 64
               ? wg::launch<64>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, P, N, R,
                                cpc, s)
               : wg::launch<128>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, P, N,
                                 R, cpc, s);
  }
  if (Q != 16 && Q != 32 && Q != 64) return -1;
  if (S % Q) return -1;
  return P == 32 ? f32core::dispatch_n<32>(N, x, dt, A, Bm, Cm, s0, y, st, B,
                                           S, H, Q, s)
                 : f32core::dispatch_n<64>(N, x, dt, A, Bm, Cm, s0, y, st, B,
                                           S, H, Q, s);
}
