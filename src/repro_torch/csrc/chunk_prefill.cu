// Chunked-prefill attention over the block-paged KV pool, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
// src/repro/kernels/chunk_prefill.py:102 chunk_prefill_attention
// (_chunk_kernel).
//
// A chunk of Sq queries of sequence b sits at absolute positions
// start[b] + i; the pools (num_blocks, bs, K, hd) already hold the chunk's
// own K/V. Sequence b's logical key j lives in physical block
// table[b, j / bs] at row j % bs. Query i sees key j when
//   j <= start[b] + i  (and j > start[b] + i - window).
// As in the reference the mask is by position only: the rows of a
// bucket-padded chunk past its real tokens read whatever their table
// entries hold (the pad block), and the caller discards them.
//
// What bounds it on the H100: as for K1, ~4*hd flops per visible (query
// head, key) pair against 4*hd bytes of bf16 K/V per key and kv head, read
// once for the G heads of its group: far above the card's flop:byte
// ridge at the serving chunk sizes (64-128), so the arithmetic bounds it;
// 67 TFLOP/s in fp32 on the CUDA cores, 989 TFLOP/s in bf16 on the tensor
// cores at three bf16 products per fp32 one.
//
// Design (bf16 pools, every engine's): K1's kernel, flash_tile.cuh's
// flash_tile_kernel, over the block table (ChunkPagedKeys), with base =
// start and the key limit maxblk * bs:
//  - GQA packing: one CTA per (128 / G chunk positions x G heads = 128
//    rows, 64 at hd 256; kv head, sequence); each K/V tile is read once
//    for the group.
//  - K/V tiles of 64 logical keys, each key's row looked up through the
//    table and copied by 16-byte cp.async into a two-stage ring; the walk
//    runs from the window's first tile up to the CTA's causal limit
//    min(maxblk * bs, start[b] + last position + 1), the reference's
//    causal block skip: tiles past it are never loaded, and no table entry
//    past maxblk is read.
//  - Both products on wgmma with an fp32 q and the fp32 probabilities in
//    three bf16 pieces each; the reference's fp32 online softmax, its
//    NEG_INF sentinel and its 1e-30 floor (flash_tile.cuh).
//
// fp32 pools (dispatched, stored by no engine path) keep the first port's
// CUDA-core body as fp32kv::chunk_prefill_fp32kv_kernel: one CTA per
// (32-row q tile, query head, sequence), 128 threads, each tile's physical
// rows looked up once, K/V staged in shared memory as fp32, scalar fp32
// FMAs.
#include <type_traits>

#include "flash_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 pools only: the first port's CUDA-core body (see the header).
namespace fp32kv {

constexpr int BQ = 32;   // query rows per CTA
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 128;  // threads per CTA: 4 per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(long long) * BK +
         sizeof(float) *
             (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1));
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
chunk_prefill_fp32kv_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ kp,
                            const TKV* __restrict__ vp, TQ* __restrict__ o,
                            const int* __restrict__ tables,
                            const int* __restrict__ start, int Sq, int H,
                            int K, int bs, int maxblk, float scale,
                            int window, float cap) {
  using teola::NEG_INF;
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  constexpr int DPT = HD / 4;   // output dims per thread (d = c + 4*i)
  constexpr int KPT = BK / 4;   // keys per thread per tile (j = c + 4*i)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Roff = reinterpret_cast<long long*>(smem_raw);  // BK key rows
  float* Qs = reinterpret_cast<float*>(Roff + BK);  // BQ x LD
  float* Ks = Qs + BQ * LD;     // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Ps = Vs + BK * LD;     // BQ x LP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int r = tid >> 2;       // query row within the tile
  const int c = tid & 3;        // lane within the row's 4 threads
  const int pre = start[b];
  const int q_end = min(q0 + BQ, Sq);
  const int* table = tables + (size_t)b * maxblk;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int rr = idx / HD, d = idx % HD, qi = q0 + rr;
    Qs[rr * LD + d] =
        qi < Sq ? teola::to_f(q[((size_t)(b * Sq + qi) * H + h) * HD + d])
                : 0.f;
  }

  const int qpos = pre + q0 + r;
  const int kv_hi = min(maxblk * bs, pre + q_end);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, pre + q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    if (tid < BK) {
      const int j = j0 + tid;
      long long off = -1;
      if (j < kv_hi) {
        off = ((long long)table[j / bs] * bs + j % bs) * K + kvh;
      }
      Roff[tid] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int jj = idx / HD, d = idx % HD;
      const long long off = Roff[jj];
      float kk = 0.f, vv = 0.f;
      if (off >= 0) {
        kk = teola::to_f(kp[off * HD + d]);
        vv = teola::to_f(vp[off * HD + d]);
      }
      Ks[jj * LD + d] = kk;
      Vs[jj * LD + d] = vv;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] += qd * Ks[(c + 4 * i) * LD + d];
    }

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = j0 + c + 4 * i;
      const bool ok =
          j <= qpos && j < kv_hi && (window <= 0 || j > qpos - window);
      s[i] = ok ? teola::score(s[i], scale, cap) : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      Ps[r * LP + c + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same 4 lanes

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int jj = 0; jj < BK; ++jj) {
      const float p = Ps[r * LP + jj];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * Vs[jj * LD + c + 4 * i];
    }
    __syncwarp();
  }

  if (q0 + r < Sq) {
    const float den = fmaxf(l, 1e-30f);
    TQ* out = o + ((size_t)(b * Sq + q0 + r) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      out[c + 4 * i] = teola::from_f<TQ>(acc[i] / den);
  }
}

}  // namespace fp32kv

template <int HD, typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, void* o,
           const int* tables, const int* start, int B, int Sq, int H, int K,
           int bs, int maxblk, float scale, int window, float cap,
           cudaStream_t stream) {
  if constexpr (std::is_same<TKV, float>::value) {
    auto kern = fp32kv::chunk_prefill_fp32kv_kernel<HD, TQ, TKV>;
    constexpr size_t smem = fp32kv::smem_bytes<HD>();
    // once per instantiation, outside any CUDA-graph capture
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sq + fp32kv::BQ - 1) / fp32kv::BQ, H, B);
    kern<<<grid, fp32kv::NT, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
        static_cast<const TKV*>(vp), static_cast<TQ*>(o), tables, start, Sq,
        H, K, bs, maxblk, scale, window, cap);
    return (int)cudaGetLastError();
  } else {
    return teola::ft::flash_tile_launch<HD, TQ>(
        q, kp, vp, o, start, nullptr,
        teola::ChunkPagedKeys{{tables, bs, maxblk}}, B, Sq, H, K, scale,
        window, cap, stream);
  }
}

}  // namespace

// q/o (B,Sq,H,hd), pools (nb,bs,K,hd), tables (B,maxblk) int32, start (B,)
// int32, all contiguous on the device. window <= 0: none; cap <= 0: none.
extern "C" int chunk_prefill_launch(const void* q, const void* kp,
                                    const void* vp, void* o,
                                    const int* tables, const int* start,
                                    int B, int Sq, int H, int K, int bs,
                                    int maxblk, int hd, int q_dtype,
                                    int kv_dtype, float scale, int window,
                                    float cap, void* stream) {
  if (B <= 0 || Sq <= 0 || K <= 0 || H % K != 0 || bs <= 0 || maxblk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, launch, q, kp, vp, o, tables, start,
                 B, Sq, H, K, bs, maxblk, scale, window, cap,
                 static_cast<cudaStream_t>(stream));
}
