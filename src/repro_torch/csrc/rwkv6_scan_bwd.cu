// Backward of the RWKV-6 WKV recurrence (K6), for Hopper (sm_90a).
// The Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:52 rwkv6_scan has
// no backward: the reference trains through a checkpointed lax.scan
// (src/repro/models/ssm.py:20-46, :121-129). The port's model runs K6
// (rwkv6_scan.cu) on every RWKV time mix, so K6 needs a gradient of its
// own; this kernel is it, called from kernels/rwkv6_scan.py's
// torch.autograd.Function.
//
// For each (b, h), with S_t = diag(w_t) S_{t-1} + k_t v_t^T (row j: key
// index, column i: value index) and y_t = r_t^T (S_{t-1} + diag(u) k_t
// v_t^T), walking t from S_len down to 1 with dS = dS_final (or 0):
//   dr_t[j] = sum_i S_{t-1}[j][i] dy_t[i] + u[j] k_t[j] (v_t . dy_t)
//   dk_t[j] = r_t[j] u[j] (v_t . dy_t) + sum_i dS[j][i] v_t[i]
//   dv_t[i] = (sum_j r_t[j] u[j] k_t[j]) dy_t[i] + sum_j dS[j][i] k_t[j]
//   dw_t[j] = sum_i dS[j][i] S_{t-1}[j][i]
//   du[j]  += r_t[j] k_t[j] (v_t . dy_t)
//   dS[j][i] <- w_t[j] dS[j][i] + r_t[j] dy_t[i]          (dS_{t-1})
// and finally dstate0 = dS. du is written per (b, h); the caller sums it
// over b.
//
// S_{t-1} is never recovered by inverting the recurrence (that divides by
// w_t = exp(-exp(.)), which can come arbitrarily close to 0). The forward
// kernel stores the state at the start of every chunk of TC = 16 steps
// (`boundaries`); this kernel recomputes a chunk's states from its
// boundary with the forward's own arithmetic (fmaf(w, S, k * v)), so the
// states it differentiates are bit-equal to the forward's.
//
// What bounds it on the H100: per (b, t, h) 14 * hd^2 fp32 operations
// (recomputing the state, 3; the four sums, 2 each; the dS update, 3)
// against 5 * hd inputs and 4 * hd outputs and one saved state per 16
// steps: about 5 operations per byte at hd 64, so bytes and operations
// bound it about equally. As in the forward, the time is the sequential
// dependence on t.
//
// Design (simple, not yet tuned): one CTA of 8 warps per (b, h), grid
// (H, B). Lane l of warp g holds rows g*R .. g*R+R-1 (R = hd / 8) and
// columns l*CPT .. l*CPT+CPT-1 (CPT = hd / 32) of dS and of the state, in
// registers: a column split of dS over the lanes, a row split over the
// warps.
//  - A chunk's r, k, w, v (storage type) and dy (fp32) arrive by 16-byte
//    cp.async; then one warp per step takes v_t . dy_t and the bonus sum
//    r_t . (u k_t).
//  - The chunk is walked in sub-chunks of U = 8 steps, the last first:
//    from the chunk's boundary the state is stepped forward to the
//    sub-chunk, then through it, each thread storing the state before
//    each step in its own slots of shared memory (no barrier: no thread
//    reads another's); then the steps are walked backwards. A chunk of 16
//    recomputes 24 steps.
//  - Each step's row sums (dr, dk, dw: 3R values per lane) are reduced
//    over the warp's 32 lanes by recursive halving (31 shuffles at hd 64,
//    lane l ending with value l), and written by 3R lanes; the column
//    sums of dv (CPT per lane) go to shared memory and are added over the
//    warps after the sub-chunk, with the bonus term.
#include "common.cuh"

namespace {

constexpr int TC = 16;   // steps per saved state: rwkv6_scan.cu's TC_PREFILL
constexpr int U = 8;     // steps per sub-chunk whose states are kept
constexpr int NW = 8;    // warps per CTA
constexpr int NT = NW * 32;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int CPT = HD / 32;  // columns per lane
  static constexpr int R = HD / NW;    // rows per warp
  static constexpr int E = R * CPT;    // state elements per thread
  // the 3R row sums, padded to a power of two for the halving
  static constexpr int NV = 3 * R <= 16 ? 16 : 32;
  static_assert(3 * R <= NV && NV <= 32, "row sums per lane");
};

template <int HD, typename T>
struct alignas(16) Smem {
  static constexpr int E = Shape<HD>::E;
  T rkwv[4][TC][HD];      // r, k, w, v of a chunk's steps
  float dy[TC][HD];
  float hist[U][E][NT];   // each thread's state before each step, private
  float pcol[U][NW][HD];  // the warps' partial column sums of dv
  float vdy[TC];          // v_t . dy_t
  float bon[TC];          // sum_j r_t[j] u[j] k_t[j]
};

// Sum each of a lane's NV values over the warp's 32 lanes; lane l returns
// the sum of value l % NV. Levels with a stride of NV or more add all NV
// values; each later level halves them: a lane keeps the half its bit
// selects and sends the other half to its partner.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&a)[NV], int lane) {
#pragma unroll
  for (int off = 16; off >= NV; off >>= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i) a[i] += __shfl_xor_sync(FULL, a[i], off);
#pragma unroll
  for (int off = NV / 2; off >= 1; off >>= 1) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      // values, not references, into the selects: a conditional over the
      // two elements themselves would index the array at run time and
      // place it in local memory
      const float lo = a[i], hi = a[i + off];
      a[i] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, off);
    }
  }
  return a[0];
}

// cp.async steps [t0, t0 + nt) of (b, h): r, k, w, v and dy, whole rows
template <int HD, typename T>
__device__ __forceinline__ void stage(Smem<HD, T>& sm, const T* r,
                                      const T* k, const T* w, const T* v,
                                      const float* dy, int b, int h, int S,
                                      int H, int t0, int nt, int tid) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = HD / EPC;         // copies per row
  const size_t row0 = ((size_t)b * S + t0) * H + h;  // (b, t0, h)
  for (int idx = tid; idx < 4 * nt * RC; idx += NT) {
    const int a = idx / (nt * RC), t = idx / RC % nt, c = idx % RC;
    const T* src = a == 0 ? r : (a == 1 ? k : (a == 2 ? w : v));
    teola::cp_async16(&sm.rkwv[a][t][c * EPC],
                      src + (row0 + (size_t)t * H) * HD + c * EPC, true);
  }
  for (int idx = tid; idx < nt * (HD / 4); idx += NT) {
    const int t = idx / (HD / 4), c = idx % (HD / 4);
    teola::cp_async16(&sm.dy[t][c * 4],
                      dy + (row0 + (size_t)t * H) * HD + c * 4, true);
  }
}

// One forward step of a thread's elements: the forward kernel's arithmetic
template <int HD, typename T>
__device__ __forceinline__ void fwd_step(const Smem<HD, T>& sm, int t,
                                         int g, int lane,
                                         float (&s)[Shape<HD>::E]) {
  using Sh = Shape<HD>;
#pragma unroll
  for (int m = 0; m < Sh::R; ++m) {
    const float wm = teola::to_f(sm.rkwv[2][t][g * Sh::R + m]);
    const float km = teola::to_f(sm.rkwv[1][t][g * Sh::R + m]);
#pragma unroll
    for (int q = 0; q < Sh::CPT; ++q) {
      const float vq = teola::to_f(sm.rkwv[3][t][lane * Sh::CPT + q]);
      s[m * Sh::CPT + q] = fmaf(wm, s[m * Sh::CPT + q], km * vq);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(NT, 1)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ boundaries,
                      const float* __restrict__ dy,
                      const float* __restrict__ dstate,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du, float* __restrict__ dstate0,
                      int S, int H) {
  using Sh = Shape<HD>;
  constexpr int R = Sh::R, CPT = Sh::CPT, E = Sh::E, NV = Sh::NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, T>& sm = *reinterpret_cast<Smem<HD, T>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, g = tid / 32, lane = tid % 32;
  // element (g*R + m, lane*CPT + q) of the (b, h) state is at
  // sbase + m*HD + q
  const size_t sbase = ((size_t)b * H + h) * HD * HD +
                       (size_t)g * R * HD + lane * CPT;
  const size_t chunk_stride = (size_t)B * H * HD * HD;
  const int nchunks = (S + TC - 1) / TC;

  float ds[E];  // dS at this thread's elements
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      ds[m * CPT + q] =
          dstate == nullptr ? 0.f : dstate[sbase + (size_t)m * HD + q];
  float du_acc = 0.f;  // thread tid < HD: du[tid] over this (b, h)

  for (int n = nchunks - 1; n >= 0; --n) {
    const int t0 = n * TC, nt = min(TC, S - t0);
    stage(sm, r, k, w, v, dy, b, h, S, H, t0, nt, tid);
    teola::cp_async_commit();
    teola::cp_async_wait<0>();
    __syncthreads();
    // v_t . dy_t and the bonus sum, one warp per step
    for (int t = g; t < nt; t += NW) {
      float a = 0.f, bs = 0.f;
      for (int j = lane; j < HD; j += 32) {
        a += teola::to_f(sm.rkwv[3][t][j]) * sm.dy[t][j];
        bs += teola::to_f(sm.rkwv[0][t][j]) * u[(size_t)h * HD + j] *
              teola::to_f(sm.rkwv[1][t][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        bs += __shfl_xor_sync(FULL, bs, off);
      }
      if (lane == 0) {
        sm.vdy[t] = a;
        sm.bon[t] = bs;
      }
    }
    __syncthreads();
    if (tid < HD)
      for (int t = 0; t < nt; ++t)
        du_acc += teola::to_f(sm.rkwv[0][t][tid]) *
                  teola::to_f(sm.rkwv[1][t][tid]) * sm.vdy[t];
    float s0[E];  // the state before step t0
    const float* bp = boundaries + (size_t)n * chunk_stride + sbase;
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int q = 0; q < CPT; ++q)
        s0[m * CPT + q] = bp[(size_t)m * HD + q];

    for (int a0 = (nt - 1) / U * U; a0 >= 0; a0 -= U) {
      const int a1 = min(nt, a0 + U);
      float s[E];
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = s0[e];
      for (int t = 0; t < a0; ++t) fwd_step(sm, t, g, lane, s);
      for (int t = a0; t < a1; ++t) {
#pragma unroll
        for (int e = 0; e < E; ++e) sm.hist[t - a0][e][tid] = s[e];
        fwd_step(sm, t, g, lane, s);
      }
      for (int t = a1 - 1; t >= a0; --t) {
        float rr[R], kk[R], ww[R], vv[CPT], dd[CPT];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          rr[m] = teola::to_f(sm.rkwv[0][t][g * R + m]);
          kk[m] = teola::to_f(sm.rkwv[1][t][g * R + m]);
          ww[m] = teola::to_f(sm.rkwv[2][t][g * R + m]);
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          vv[q] = teola::to_f(sm.rkwv[3][t][lane * CPT + q]);
          dd[q] = sm.dy[t][lane * CPT + q];
        }
        float red[NV];  // dr, dk, dw partial row sums (R each), then 0
#pragma unroll
        for (int i = 0; i < NV; ++i) red[i] = 0.f;
        float pv[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) pv[q] = 0.f;
#pragma unroll
        for (int m = 0; m < R; ++m)
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const int e = m * CPT + q;
            const float sp = sm.hist[t - a0][e][tid];  // S_{t-1}
            red[m] = fmaf(sp, dd[q], red[m]);
            red[R + m] = fmaf(ds[e], vv[q], red[R + m]);
            red[2 * R + m] = fmaf(ds[e], sp, red[2 * R + m]);
            pv[q] = fmaf(ds[e], kk[m], pv[q]);
            ds[e] = fmaf(ww[m], ds[e], rr[m] * dd[q]);
          }
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          sm.pcol[t - a0][g][lane * CPT + q] = pv[q];
        const float sum = reduce_scatter<NV>(red, lane);
        if (lane < 3 * R) {
          const int which = lane / R, row = g * R + lane % R;
          const size_t o = (((size_t)b * S + t0 + t) * H + h) * HD + row;
          const float vdy = sm.vdy[t];
          const float ur = u[(size_t)h * HD + row];
          if (which == 0)
            dr[o] = sum + ur * teola::to_f(sm.rkwv[1][t][row]) * vdy;
          else if (which == 1)
            dk[o] = sum + teola::to_f(sm.rkwv[0][t][row]) * ur * vdy;
          else
            dw[o] = sum;
        }
      }
      __syncthreads();
      // dv of the sub-chunk's steps: the warps' column sums, the bonus term
      for (int idx = tid; idx < (a1 - a0) * HD; idx += NT) {
        const int t = a0 + idx / HD, col = idx % HD;
        float acc = 0.f;
#pragma unroll
        for (int gg = 0; gg < NW; ++gg) acc += sm.pcol[t - a0][gg][col];
        dv[(((size_t)b * S + t0 + t) * H + h) * HD + col] =
            acc + sm.bon[t] * sm.dy[t][col];
      }
      __syncthreads();  // pcol is free; after the last sub-chunk, the stage
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      dstate0[sbase + (size_t)m * HD + q] = ds[m * CPT + q];
  if (tid < HD) du[((size_t)b * H + h) * HD + tid] = du_acc;
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* boundaries, const float* dy,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, int B, int S, int H,
           cudaStream_t stream) {
  using Sm = Smem<HD, T>;
  auto kern = rwkv6_scan_bwd_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Sm));
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B), NT, sizeof(Sm), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, boundaries, dy,
      dstate, dr, dk, dv, dw, du, dstate0, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B,S,H,hd) in one dtype (TEOLA_F32 | TEOLA_BF16); u (H,hd);
// boundaries (ceil(S / 16), B, H, hd, hd) as rwkv6_scan_launch stores
// them; dy (B,S,H,hd); dstate (B,H,hd,hd) or null (no gradient of the
// final state); outputs dr, dk, dv, dw (B,S,H,hd), du (B,H,hd) per
// sequence, dstate0 (B,H,hd,hd). All float32 but r, k, v, w, all
// contiguous, none aliasing another; r, k, v, w and dy 16-byte aligned.
// hd in {32, 64}; S >= 1.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* boundaries, const float* dy,
    const float* dstate, float* dr, float* dk, float* dv, float* dw,
    float* du, float* dstate0, int B, int S, int H, int hd, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t ptrs = reinterpret_cast<size_t>(r) |
                      reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) |
                      reinterpret_cast<size_t>(w) |
                      reinterpret_cast<size_t>(dy);
  if (ptrs & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K6_BWD(HD_, T_)                                                      \
  return launch<HD_, T_>(r, k, v, w, u, boundaries, dy, dstate, dr, dk, dv, \
                         dw, du, dstate0, B, S, H, st)
  if (hd == 32 && dtype == TEOLA_F32) K6_BWD(32, float);
  if (hd == 32 && dtype == TEOLA_BF16) K6_BWD(32, __nv_bfloat16);
  if (hd == 64 && dtype == TEOLA_F32) K6_BWD(64, float);
  if (hd == 64 && dtype == TEOLA_BF16) K6_BWD(64, __nv_bfloat16);
#undef K6_BWD
  return (int)cudaErrorInvalidValue;
}
