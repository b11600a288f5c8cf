// Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py, function
// ssd_scan (body _ssd_kernel).  Same contract: x (B,S,H,P), dt (B,S,H)
// after softplus, A (H,) float32 <= 0, Bm and Cm (B,S,N) shared by every
// head, an optional init_state (B,H,P,N) float32 (null: zeros) -> y
// (B,S,H,P) in x's dtype and the final state (B,H,P,N) float32.  S is a
// multiple of the chunk Q (the wrapper pads with dt = 0 steps).  For each
// chunk, with cum the inclusive cumulative sum of dA = dt * A[h] and total
// its last element:
//   y     = (exp(cum_i - cum_j) [i >= j] * C_i.B_j) . (x dt)
//         + exp(cum_i) * C_i . state^T
//   state = state * exp(total) + (x dt)^T . (B * exp(total - cum))
// All decay math and every product in float32, as in _ssd_kernel; the four
// exponents are <= 0, so nothing overflows.
//
// Bound on an H100: at the serving shape (mamba2-370m, batch 8, S = 512,
// H = 32, P = 64, N = 128, Q = 64, bf16) the function moves 44.3 MB (x, y,
// B, C, dt, the final state: 13.2 us at 3.35 TB/s) and does 7.5 GFLOP
// (7.6 us at the bf16 tensor-core peak), so the card's bound is the memory
// traffic.  This first version computes the four products on the CUDA
// cores in float32 (no tensor cores): its own ceiling is the 67 TFLOP/s
// float32 rate, well above the bound.  What the design does about the
// bound: every input byte is read once, straight from the (B,S,H,P) and
// (B,S,N) layouts by strides (no transposed copies), dA is computed in the
// kernel instead of being materialised, and the (P,N) state stays in
// shared memory across the whole sequence, written once at the end.
//
// Grid: one block of 256 threads per (batch row, head), B*H blocks; the
// Pallas kernel's sequential chunk axis is a loop inside the block.  At the
// serving bucket of 8 that is 256 blocks, about two waves on 132 SMs; at
// bucket 1 only 32 blocks (a chunk-parallel split is later work).
// Thread (tx, ty) = (tid % 16, tid / 16).  Shared memory, float32: the
// state (P x N+1), B and C of the chunk (Q x N+1 each), x*dt (Q x P), the
// masked decay-weighted C.B^T (Q x Q+1), cum and dt (Q each): 132 KB at the
// serving shape, so dynamic shared memory above the 48 KB default.
#include "tile.cuh"

namespace {

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

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ st, int S, int H,
               int Q) {
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

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* s0, void* y, void* st, int B, int S,
           int H, int Q, cudaStream_t stream) {
  const size_t bytes = Layout<P, N>::bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T, P, N><<<B * H, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(st), S, H, Q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A,
               const void* Bm, const void* Cm, const void* s0, void* y,
               void* st, int B, int S, int H, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    default: return -1;
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const void* dt, const void* A,
               const void* Bm, const void* Cm, const void* s0, void* y,
               void* st, int B, int S, int H, int Q, cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
    default: return -1;
  }
}

}  // namespace

// C interface for ctypes.  s0 may be null (a zero initial state).  Returns
// 0 on success, the cudaError_t of a refused launch, or -1 for a shape the
// kernel was not built for.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* s0,
                              void* y, void* st, int is_bf16, int B, int S,
                              int H, int P, int N, int Q, void* stream) {
  if (Q != 16 && Q != 32 && Q != 64) return -1;
  if (S % Q) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, s0, y, st, B, S,
                                     H, Q, s);
  return dispatch_p<float>(P, N, x, dt, A, Bm, Cm, s0, y, st, B, S, H, Q, s);
}
