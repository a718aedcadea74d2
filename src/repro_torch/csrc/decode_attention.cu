// Batched GQA decode attention over a dense KV cache, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (_kernel,
// _flash_block).
//
// One new query per sequence and head attends to the first length[b]
// slots of its cache (window: only slots >= length[b] - window).
//
// Design: one CTA per (kv head, sequence) holding the G = H / K query
// heads of that group, so each K/V tile is read once for all G heads (the
// reference keeps all H heads resident for the same reason). The CTA walks
// KV tiles of BK = 128 slots up to length[b] and never touches slots past
// it. Per tile: thread j scores key j against the G heads, one warp per
// head runs the fp32 online-softmax update (NEG_INF sentinel, 1e-30 floor
// on the denominator, as in the reference), and each thread accumulates
// its share of the G x hd output in registers.
//
// What bounds it on the H100: ~4*G*hd flops per KV row against 4*hd bytes
// (bf16 K and V), i.e. about 2*G flops per byte: memory-bound at any batch.
// With B*K CTAs (16 at batch 4 for TinyLlama) the card is far from
// saturated; splitting the KV range across CTAs with a combine pass
// (flash-decoding) is the later fix (ROADMAP.md Queue 2).
#include "common.cuh"

namespace {

constexpr int BK = 128;    // KV slots per tile (one per thread)
constexpr int NT = 128;
constexpr int MAX_G = 16;  // query heads per kv head

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) *
         ((size_t)G * HD + 2 * (size_t)BK * (HD + 1) + (size_t)G * BK + 3 * G);
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, TQ* __restrict__ o,
                        const int* __restrict__ length, int H, int K, int T,
                        float scale, int window, float cap) {
  using teola::NEG_INF;
  constexpr int LD = HD + 1;
  constexpr int OPT = MAX_G * HD / NT;   // output slots per thread
  const int G = H / K;
  extern __shared__ float smem[];
  float* Qs = smem;                 // G x HD
  float* Ks = Qs + G * HD;          // BK x LD
  float* Vs = Ks + BK * LD;         // BK x LD
  float* Ss = Vs + BK * LD;         // G x BK scores, then probabilities
  float* Ms = Ss + G * BK;          // running max per head
  float* Ls = Ms + G;               // running denominator per head
  float* As = Ls + G;               // this tile's rescale per head

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = length[b];
  const size_t qbase = ((size_t)b * H + (size_t)kvh * G) * HD;

  for (int idx = tid; idx < G * HD; idx += NT) {
    Qs[idx] = teola::to_f(q[qbase + idx]);
  }
  if (tid < G) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  float acc[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) acc[u] = 0.f;

  const int hi = min(len, T);
  int lo = window > 0 ? max(0, len - window) : 0;
  lo = (lo / BK) * BK;

  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();  // previous tile consumed; Qs / Ms / Ls initialized
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int jj = idx / HD, d = idx % HD, j = j0 + jj;
      float kk = 0.f, vv = 0.f;
      if (j < T) {
        const size_t off = (((size_t)b * T + j) * K + kvh) * HD + d;
        kk = teola::to_f(k[off]);
        vv = teola::to_f(v[off]);
      }
      Ks[jj * LD + d] = kk;
      Vs[jj * LD + d] = vv;
    }
    __syncthreads();

    {  // scores: thread tid owns key j0 + tid
      const int j = j0 + tid;
      const bool ok = j < len && j < T && (window <= 0 || j >= len - window);
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot += Qs[g * HD + d] * Ks[tid * LD + d];
        Ss[g * BK + tid] = ok ? teola::score(dot, scale, cap) : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {  // online softmax, warp/head
      float mx = NEG_INF;
      for (int jj = lane; jj < BK; jj += 32) mx = fmaxf(mx, Ss[g * BK + jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int jj = lane; jj < BK; jj += 32) {
        const float p = expf(Ss[g * BK + jj] - m_new);
        Ss[g * BK + jj] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + psum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < OPT; ++u) {  // acc[g][d] = acc*alpha + P[g] . V[:, d]
      const int idx = tid + u * NT;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        float a = acc[u] * As[g];
        for (int jj = 0; jj < BK; ++jj) a += Ss[g * BK + jj] * Vs[jj * LD + d];
        acc[u] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int idx = tid + u * NT;
    if (idx < G * HD) {
      const int g = idx / HD;
      o[qbase + idx] = teola::from_f<TQ>(acc[u] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <int HD, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* length, int B, int H, int K, int T, float scale,
           int window, float cap, cudaStream_t stream) {
  const int G = H / K;
  if (G > MAX_G) return (int)cudaErrorInvalidValue;
  auto kern = decode_attention_kernel<HD, TQ, TKV>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), length, H, K, T,
      scale, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,hd), k/v (B,T,K,hd), o (B,H,hd), all contiguous; length (B,)
// int32 on the device. window <= 0: none; cap <= 0: none.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int* length, int B, int H,
                                       int K, int T, int hd, int q_dtype,
                                       int kv_dtype, float scale, int window,
                                       float cap, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, launch, q, k, v, o, length, B, H, K,
                 T, scale, window, cap, static_cast<cudaStream_t>(stream));
}
