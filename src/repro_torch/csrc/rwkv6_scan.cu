// RWKV-6 WKV recurrence, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// (_kernel).
//
// For each (b, h), with the hd x hd fp32 state S (row j: key index, column
// i: value index) and t = 0 .. S_len-1:
//   y_t[i] = sum_j r_t[j] * (S[j][i] + u[j] * k_t[j] * v_t[i])
//   S[j][i] = w_t[j] * S[j][i] + k_t[j] * v_t[i]
// The state is read from state0 at the start and written to state_out at
// the end; the two may be the same buffer (the engine's cache, updated in
// place), because every thread reads and writes only its own column.
//
// Design: the CUDA wkv6 structure the Pallas kernel's docstring cites. One
// CTA per (h, b) and HD threads; thread i holds column i of the state in
// registers for the whole scan, so the state never leaves the SM between
// timesteps (the TPU kernel keeps it in VMEM scratch for the same reason).
// Each step stages r_t, k_t, w_t in shared memory (double-buffered, so one
// __syncthreads per step), thread i keeps v_t[i] in a register, and the
// next step's four values are loaded into registers before this step's
// arithmetic so their latency overlaps it. No cross-thread reduction is
// needed: thread i owns y_t[i].
//
// What bounds it on the H100: per (b, t, h) about 7*hd^2 fp32 flops against
// 4*hd input values and hd fp32 outputs: 0.35*hd flops per byte in fp32
// (22 at hd=64; bf16 inputs 37), just above the card's fp32 ridge of ~20,
// so on paper it is compute-bound at 67 TFLOP/s. In practice the time is
// the sequential dependence: B*H CTAs (160 at batch 4 for RWKV-6 3B) of HD
// threads each walk S steps one after another, a small fraction of the
// card's lanes. A chunked formulation on tensor cores (intra-chunk
// products as matmuls, the state carried between chunks) is the later fix
// (ROADMAP.md Queue 2).
#include "common.cuh"

namespace {

template <int HD, typename T>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  float* __restrict__ y, float* state_out, int S, int H) {
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;
  const size_t tstride = (size_t)H * HD;  // one timestep in (B,S,H,hd)
  size_t off = ((size_t)b * S * H + h) * HD + i;

  float st[HD];  // column i of the state
#pragma unroll
  for (int j = 0; j < HD; ++j) st[j] = state0[sbase + (size_t)j * HD + i];
  us[i] = u[(size_t)h * HD + i];

  float rn = teola::to_f(r[off]), kn = teola::to_f(k[off]);
  float vn = teola::to_f(v[off]), wn = teola::to_f(w[off]);
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    rs[buf][i] = rn;
    ks[buf][i] = kn;
    ws[buf][i] = wn;
    const float vi = vn;
    const size_t cur = off;
    if (t + 1 < S) {  // next step's values, in flight during this one
      off += tstride;
      rn = teola::to_f(r[off]);
      kn = teola::to_f(k[off]);
      vn = teola::to_f(v[off]);
      wn = teola::to_f(w[off]);
    }
    // buffer buf was last read in step t-2; every thread passed step
    // t-1's barrier after finishing it
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HD; ++j) {
      const float kv = ks[buf][j] * vi;
      acc += rs[buf][j] * (st[j] + us[j] * kv);
      st[j] = ws[buf][j] * st[j] + kv;
    }
    y[cur] = acc;
  }

#pragma unroll
  for (int j = 0; j < HD; ++j) state_out[sbase + (size_t)j * HD + i] = st[j];
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, float* y, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<HD, T><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0, y,
      state_out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B,S,H,hd) in one dtype (TEOLA_F32 | TEOLA_BF16); u (H,hd),
// state0 and state_out (B,H,hd,hd), y (B,S,H,hd), all float32 and
// contiguous. state_out may alias state0. hd in {32, 64}; S >= 1.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const float* u,
                                 const float* state0, float* y,
                                 float* state_out, int B, int S, int H,
                                 int hd, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32 && dtype == TEOLA_F32)
    return launch<32, float>(r, k, v, w, u, state0, y, state_out, B, S, H,
                             st);
  if (hd == 32 && dtype == TEOLA_BF16)
    return launch<32, __nv_bfloat16>(r, k, v, w, u, state0, y, state_out, B,
                                     S, H, st);
  if (hd == 64 && dtype == TEOLA_F32)
    return launch<64, float>(r, k, v, w, u, state0, y, state_out, B, S, H,
                             st);
  if (hd == 64 && dtype == TEOLA_BF16)
    return launch<64, __nv_bfloat16>(r, k, v, w, u, state0, y, state_out, B,
                                     S, H, st);
  return (int)cudaErrorInvalidValue;
}
