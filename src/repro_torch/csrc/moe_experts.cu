// Grouped routed-expert products of a mixture-of-experts layer, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference's MoE (src/repro/models/moe.py)
// is plain products that XLA fuses on the TPU. It was added because the
// port's per-expert loop (one host read of the per-expert counts, then a
// gather, three products, an activation and a multiply for every touched
// expert) is what held the host in a decode step: the card waited while
// the host issued some 60 launches and a sync per layer. This kernel reads
// the routing on the device, so a layer's experts are two launches
// whatever the routing, with nothing read back.
//
// Inputs, as models/moe.py::routed computes them on the device: the T*k
// assignments sorted by expert, stably (order: assignment slot t*k + j of
// each sorted row; offsets (E+1): where expert e's rows start), and the
// gates (T, k). For expert e's rows r in [offsets[e], offsets[e+1]):
//   h[r]           = act(x[order[r] / k] . w_gate[e]) * (x[order[r] / k] . w_up[e])
//   y[order[r]]    = gates[order[r]] * (h[r] . w_down[e])
// h (T*k, f) is fp32 scratch; y (T*k, d) is in x's type, one row per
// assignment slot, each written once (no atomics): the caller sums each
// token's k rows in choice order.
//
// What bounds it on the H100: the bytes of the touched experts' three
// matrices. At a decode step a touched expert has one or a few rows, so
// each weight is used for as many multiply-adds as the expert has rows:
// 2 operations per 4-byte weight and row, far below the card's 20 per byte
// in fp32. At Qwen1.5-MoE's shapes (d 2048, f 1408, fp32) an expert is
// 34.6 MB: 10.3 us at 3.35 TB/s.
//
// Design: stream each touched expert's weights once for all of its rows.
//  - Grid (N / TN tiles of 32 output columns, min(E, T*k) expert slots).
//    Slot j's CTAs find the j-th expert with rows themselves (one warp
//    reads offsets, a ballot per 32 experts) and leave at once when fewer
//    experts have rows: the grid follows T*k, known on the host, and not
//    the routing, which the host never sees.
//  - A CTA holds up to RMAX = 8 rows per pass (more rows: more passes over
//    the same tile, from L2 when it still holds them); the rows' inputs
//    (x gathered through order, or h) are staged in shared memory as fp32,
//    KC reduction elements per chunk, zero past the row count and past K.
//  - 256 threads = 8 column groups x 32 lanes along the reduction. A thread
//    reads 4 consecutive weights of each of 4 consecutive reduction rows
//    (16-byte loads in fp32 where the row length allows, each warp row on
//    128 contiguous bytes) and keeps R x 4 sums per matrix in registers,
//    R the pass's row count rounded up to 1, 2, 4 or 8, so a row-1 expert
//    spends one multiply-add per weight. The gate and up matrices share
//    the CTA, so the gathered row is read once for both.
//  - Launch bounds hold two CTAs on an SM (at most 128 registers a
//    thread): a CTA's start (finding its expert, staging its rows) and its
//    end (the cross-lane sums) overlap the other CTA's weight stream. One
//    CTA an SM (140-198 registers) ran 1.74 / 1.41x the byte bound at T =
//    1 / 4 against 1.39 / 1.30x (PERF.md).
//  - The 32 lanes' partial sums are added in a fixed order (shuffles within
//    a warp, then the 8 warps through shared memory); the epilogue applies
//    the activation (or the gate) and writes the tile's rows. So the result
//    does not depend on scheduling.
// Arithmetic: fp32 multiply-adds on CUDA cores with fp32 sums (bf16 weights
// and inputs are widened on load); no tensor cores, no TF32.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CPT = 4;              // output columns per thread
constexpr int CG = 8;               // column groups of a tile
constexpr int TN = CG * CPT;        // output columns per CTA
constexpr int KL = THREADS / CG;    // lanes along the reduction
constexpr int WARPS = THREADS / 32;
constexpr int RMAX = 8;             // rows per pass
constexpr int KC = 2048;            // reduction elements staged per chunk
constexpr int ACT_SILU = 0, ACT_GELU = 1, ACT_RELU = 2;

// 4 consecutive weights of a row from column c0, as fp32; `left` columns
// of the row remain from c0 (zeros past the row's end).
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, int left, float (&w)[4]);

template <>
__device__ __forceinline__ void load4<float, true>(const float* p, int left,
                                                   float (&w)[4]) {
  if (left >= 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0.f;
  }
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, true>(
    const __nv_bfloat16* p, int left, float (&w)[4]) {
  if (left >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void load4_scalar(const T* p, int left,
                                             float (&w)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = c < left ? teola::to_f(p[c]) : 0.f;
}

template <>
__device__ __forceinline__ void load4<float, false>(const float* p, int left,
                                                    float (&w)[4]) {
  load4_scalar(p, left, w);
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, false>(
    const __nv_bfloat16* p, int left, float (&w)[4]) {
  load4_scalar(p, left, w);
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == ACT_SILU) return g / (1.f + expf(-g));
  if (act == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.f);
}

// The j-th expert (in expert order) with at least one row, and its rows
// [lo, hi); -1 when fewer than j + 1 experts have rows. Every thread of
// the CTA calls it; warp 0 reads offsets.
__device__ int find_expert(const long long* offsets, int E, int j,
                           long long& lo, long long& hi) {
  __shared__ int s_e;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int seen = 0, found = -1;
    for (int base = 0; base < E && found < 0; base += 32) {
      const int e = base + lane;
      const bool rows = e < E && offsets[e + 1] > offsets[e];
      unsigned m = __ballot_sync(0xffffffffu, rows);
      const int c = __popc(m);
      if (seen + c > j) {
        for (int skip = j - seen; skip > 0; --skip) m &= m - 1;
        found = base + __ffs(m) - 1;
      }
      seen += c;
    }
    if (lane == 0) s_e = found;
  }
  __syncthreads();
  const int e = s_e;
  if (e >= 0) {
    lo = offsets[e];
    hi = offsets[e + 1];
  }
  return e;
}

// Where the inputs of a pass's rows come from: row i (0 <= i < nr) of the
// pass starts at src + base[i] elements (base: in shared memory, written
// before the pass's first barrier).
template <typename TS>
struct Rows {
  const TS* src;
  const long long* base;
  int nr;
};

// One pass over R (>= nr) rows and one tile of NM matrices (K, N) of type
// TW: stage the rows, accumulate acc[m][r][c] = sum_i row_r[i] * W_m[i][c0
// + c], then add the 32 lanes' sums: out[m] of thread t < R * TN is row
// t / TN, column n0 + t % TN of the tile. xs: the shared buffer, rows of kc
// floats; it also holds the cross-warp sums.
template <typename TS, typename TW, int NM, int R, bool VEC>
__device__ __forceinline__ void tile_pass(const Rows<TS>& rows,
                                          const TW* const (&W)[NM], int K,
                                          int N, int n0, int kc, float* xs,
                                          float (&out)[NM]) {
  const int tid = threadIdx.x, cg = tid % CG, kl = tid / CG;
  const int c0 = n0 + cg * CPT, left = N - c0;
  float acc[NM][R][CPT];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int len = min(kc, K - k0);
    __syncthreads();  // the previous chunk (or pass) is done with xs
    for (int l = tid; l < R * kc; l += THREADS) {
      const int r = l / kc, i = l - r * kc;
      xs[l] = (r < rows.nr && i < len)
                  ? teola::to_f(rows.src[rows.base[r] + k0 + i])
                  : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int q = 4 * kl; q < len; q += 4 * KL) {
      float w[NM][4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = k0 + q + u;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          if (i < K)
            load4<TW, VEC>(W[m] + (size_t)i * N + c0, left, w[m][u]);
          else
            w[m][u][0] = w[m][u][1] = w[m][u][2] = w[m][u][3] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * kc + q);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int m = 0; m < NM; ++m)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              acc[m][r][c] = fmaf(xr[u], w[m][u][c], acc[m][r][c]);
      }
    }
  }

  // the 4 lanes of a warp that share a column group, by shuffles (lane =
  // 8 * (kl % 4) + cg), then the 8 warps in order through shared memory
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float v = acc[m][r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[m][r][c] = v;
      }
  __syncthreads();  // every thread is done reading xs
  const int warp = tid / 32, lane = tid % 32;
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          xs[((warp * NM + m) * R + r) * TN + lane * CPT + c] = acc[m][r][c];
  }
  __syncthreads();
  // thread t < R * TN: row t / TN, column t % TN of the tile
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    float s = 0.f;
    if (tid < R * TN) {
      const int r = tid / TN, col = tid % TN;
      for (int wp = 0; wp < WARPS; ++wp)
        s += xs[((wp * NM + m) * R + r) * TN + col];
    }
    out[m] = s;
  }
}

// Runs tile_pass with R = nr rounded up to 1, 2, 4 or 8.
template <typename TS, typename TW, int NM, bool VEC>
__device__ __forceinline__ void tile(const Rows<TS>& rows,
                                     const TW* const (&W)[NM], int K, int N,
                                     int n0, int kc, float* xs,
                                     float (&out)[NM], int& R) {
  if (rows.nr == 1) {
    R = 1;
    tile_pass<TS, TW, NM, 1, VEC>(rows, W, K, N, n0, kc, xs, out);
  } else if (rows.nr == 2) {
    R = 2;
    tile_pass<TS, TW, NM, 2, VEC>(rows, W, K, N, n0, kc, xs, out);
  } else if (rows.nr <= 4) {
    R = 4;
    tile_pass<TS, TW, NM, 4, VEC>(rows, W, K, N, n0, kc, xs, out);
  } else {
    R = 8;
    tile_pass<TS, TW, NM, 8, VEC>(rows, W, K, N, n0, kc, xs, out);
  }
}

// h[r] = act(x_r . w_gate[e]) * (x_r . w_up[e]) for a tile of f.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    moe_gate_up_kernel(const T* __restrict__ x,
                       const long long* __restrict__ order,
                       const long long* __restrict__ offsets,
                       const T* __restrict__ w_gate,
                       const T* __restrict__ w_up, float* __restrict__ h,
                       int d, int f, int E, int k, int kc, int act) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  long long lo = 0, hi = 0;
  const int e = find_expert(offsets, E, blockIdx.y, lo, hi);
  if (e < 0) return;
  const int n0 = blockIdx.x * TN;
  const T* const W[2] = {w_gate + (size_t)e * d * f, w_up + (size_t)e * d * f};
  __shared__ long long base[RMAX];
  for (long long r0 = lo; r0 < hi; r0 += RMAX) {
    const Rows<T> rows{x, base, (int)min((long long)RMAX, hi - r0)};
    if (threadIdx.x < rows.nr)
      base[threadIdx.x] = order[r0 + threadIdx.x] / k * d;
    float out[2];
    int R;
    tile<T, T, 2, VEC>(rows, W, d, f, n0, kc, xs, out, R);
    const int r = threadIdx.x / TN, col = n0 + threadIdx.x % TN;
    if (threadIdx.x < R * TN && r < rows.nr && col < f)
      h[(size_t)(r0 + r) * f + col] = activate(out[0], act) * out[1];
  }
}

// y[order[r]] = gates[order[r]] * (h[r] . w_down[e]) for a tile of d.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    moe_down_kernel(const float* __restrict__ h,
                    const long long* __restrict__ order,
                    const long long* __restrict__ offsets,
                    const float* __restrict__ gates,
                    const T* __restrict__ w_down, T* __restrict__ y, int d,
                    int f, int E, int kc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  long long lo = 0, hi = 0;
  const int e = find_expert(offsets, E, blockIdx.y, lo, hi);
  if (e < 0) return;
  const int n0 = blockIdx.x * TN;
  const T* const W[1] = {w_down + (size_t)e * f * d};
  __shared__ long long base[RMAX];
  for (long long r0 = lo; r0 < hi; r0 += RMAX) {
    const Rows<float> rows{h, base, (int)min((long long)RMAX, hi - r0)};
    if (threadIdx.x < rows.nr) base[threadIdx.x] = (r0 + threadIdx.x) * f;
    float out[1];
    int R;
    tile<float, T, 1, VEC>(rows, W, f, d, n0, kc, xs, out, R);
    const int r = threadIdx.x / TN, col = n0 + threadIdx.x % TN;
    if (threadIdx.x < R * TN && r < rows.nr && col < d) {
      const long long slot = order[r0 + r];
      y[(size_t)slot * d + col] = teola::from_f<T>(out[0] * gates[slot]);
    }
  }
}

// Shared memory of a CTA: RMAX rows of kc staged floats, and at least the
// cross-warp sums of two matrices.
size_t smem_bytes(int kc) {
  const size_t stage = (size_t)RMAX * kc, red = (size_t)WARPS * 2 * RMAX * TN;
  return (stage > red ? stage : red) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, bool VGU, bool VDN>
int launch(const void* x, const long long* order, const long long* offsets,
           const float* gates, const void* w_gate, const void* w_up,
           const void* w_down, float* h, void* y, int T_, int d, int f, int E,
           int k, int act, cudaStream_t st) {
  const int slots = (int)std::min((long long)E, (long long)T_ * k);
  // staged reduction elements per chunk: the whole reduction where it fits
  const int kc_gu = std::min(KC, (d + 3) / 4 * 4);
  const int kc_dn = std::min(KC, (f + 3) / 4 * 4);
  const size_t sm_gu = smem_bytes(kc_gu), sm_dn = smem_bytes(kc_dn);
  auto gu = moe_gate_up_kernel<T, VGU>;
  auto dn = moe_down_kernel<T, VDN>;
  cudaError_t err = allow_smem(gu, sm_gu);
  if (err == cudaSuccess) err = allow_smem(dn, sm_dn);
  if (err != cudaSuccess) return (int)err;
  gu<<<dim3((f + TN - 1) / TN, slots), THREADS, sm_gu, st>>>(
      static_cast<const T*>(x), order, offsets, static_cast<const T*>(w_gate),
      static_cast<const T*>(w_up), h, d, f, E, k, kc_gu, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dn<<<dim3((d + TN - 1) / TN, slots), THREADS, sm_dn, st>>>(
      h, order, offsets, gates, static_cast<const T*>(w_down),
      static_cast<T*>(y), d, f, E, kc_dn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(bool vgu, bool vdn, const void* x, const long long* order,
               const long long* offsets, const float* gates,
               const void* w_gate, const void* w_up, const void* w_down,
               float* h, void* y, int T_, int d, int f, int E, int k, int act,
               cudaStream_t st) {
  if (vgu && vdn)
    return launch<T, true, true>(x, order, offsets, gates, w_gate, w_up,
                                 w_down, h, y, T_, d, f, E, k, act, st);
  if (vgu)
    return launch<T, true, false>(x, order, offsets, gates, w_gate, w_up,
                                  w_down, h, y, T_, d, f, E, k, act, st);
  if (vdn)
    return launch<T, false, true>(x, order, offsets, gates, w_gate, w_up,
                                  w_down, h, y, T_, d, f, E, k, act, st);
  return launch<T, false, false>(x, order, offsets, gates, w_gate, w_up,
                                 w_down, h, y, T_, d, f, E, k, act, st);
}

}  // namespace

// x (T, d); order (T*k,) int64; offsets (E+1,) int64; gates (T, k) fp32;
// w_gate, w_up (E, d, f); w_down (E, f, d); h (T*k, f) fp32 scratch; y
// (T*k, d). x, the weights and y share `dtype` (TEOLA_F32 or TEOLA_BF16).
// Two launches on `stream`; returns the first launch error.
extern "C" int moe_experts_launch(const void* x, const long long* order,
                                  const long long* offsets,
                                  const float* gates, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  float* h, void* y, int T, int d, int f,
                                  int E, int k, int act, int dtype,
                                  void* stream) {
  if (T <= 0 || d <= 0 || f <= 0 || E <= 0 || E > 65535 || k <= 0 ||
      act < ACT_SILU || act > ACT_RELU)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte weight loads (8 for bf16) where every row starts aligned
  const size_t a = dtype == TEOLA_F32 ? 16 : 8;
  const bool vgu = f % 4 == 0 &&
                   reinterpret_cast<size_t>(w_gate) % a == 0 &&
                   reinterpret_cast<size_t>(w_up) % a == 0;
  const bool vdn = d % 4 == 0 && reinterpret_cast<size_t>(w_down) % a == 0;
  if (dtype == TEOLA_F32)
    return launch_vec<float>(vgu, vdn, x, order, offsets, gates, w_gate, w_up,
                             w_down, h, y, T, d, f, E, k, act, st);
  if (dtype == TEOLA_BF16)
    return launch_vec<__nv_bfloat16>(vgu, vdn, x, order, offsets, gates,
                                     w_gate, w_up, w_down, h, y, T, d, f, E,
                                     k, act, st);
  return (int)cudaErrorInvalidValue;
}
