// Chunked-prefill flash attention against a resident dense KV prefix, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel
// src/repro/kernels/flash_prefill.py:75 flash_prefill (_kernel).
//
// A chunk of Sq queries of sequence b sits at absolute positions
// prefix[b] + i; K/V (B, T, K, hd) already hold the chunk at
// [prefix[b], prefix[b] + Sq). Query i sees key j when
//   j <= prefix[b] + i  and  j < total[b]  (and j > q_pos - window).
// GQA: query head h reads kv head h / (H / K); K/V are never repeated.
//
// What bounds it on the H100: at the main path's shapes (hd 64, G 8,
// Sq <= 512) about 4*hd flops per visible (query head, key) pair against
// 4*hd bytes of bf16 K/V per key and kv head: hundreds of flops per byte,
// above the ridge, so the arithmetic bounds it. On the CUDA cores in fp32
// that is 67 TFLOP/s; on the tensor cores in bf16, 989 TFLOP/s, at three
// bf16 products per fp32 one (below).
//
// Design (bf16 K/V, every engine's cache): flash_tile.cuh's
// flash_tile_kernel over the dense cache (DenseKeys{T}), with base =
// prefix and the key limit min(T, total[b]); K5 runs the same kernel over
// the block table.
//  - GQA packing: one CTA per (tile of BQ query positions, kv head,
//    sequence), its 128 rows (64 at hd 256, for shared memory) the
//    (position, head-in-group) pairs, position major: BQ = 128 / G
//    positions (16 at TinyLlama's G = 8; 64 / 2 = 32 at Gemma-2's hd 256).
//    Each K/V tile is read once for all G heads of its group. A G that
//    does not divide the rows pads them; a larger G takes more CTAs per kv
//    head.
//  - K/V tiles of 64 keys in bf16, copied by 16-byte cp.async into a ring
//    of two stages in shared memory, 128-byte swizzled; the next tile's
//    copies fly while this tile computes. The CTA walks tiles from the
//    window's first (0 without one) up to its causal limit min(T,
//    total[b], prefix[b] + last position + 1): tiles past it are never
//    loaded.
//  - Both products on the tensor cores: wgmma.mma_async m64nNk16, bf16
//    operands, fp32 accumulation. S = Q K^T reads Q's pieces and K from
//    shared memory; O += P V takes P from registers and V from shared
//    memory, all through 128-byte-swizzle matrix descriptors.
//  - Split precision: an fp32 q is stored once as three bf16 pieces, and
//    P is split into three pieces after the fp32 softmax; one MMA per
//    piece, into one fp32 accumulator. A bf16 q is exact in one piece. TF32
//    is not used. flash_tile.cuh gives the arithmetic and its accuracy.
//  - The softmax is the reference's fp32 online softmax in registers, with
//    its NEG_INF sentinel and its 1e-30 floor on the denominator.
//
// fp32 K/V (dispatched, stored by no engine path): K and V are not bf16,
// so they are not exact tensor-core operands. flash_prefill_fp32kv_kernel
// keeps the first port's CUDA-core body for that dtype pair only: one CTA
// per (32-row q tile, query head, sequence), K/V tiles staged in shared
// memory as fp32, scalar fp32 FMAs.
#include <type_traits>

#include "flash_tile.cuh"

namespace {

namespace ft = teola::ft;

// ---------------------------------------------------------------------------
// fp32 K/V only: the first port's CUDA-core body (see the header).
namespace fp32kv {

constexpr int BQ = 32;   // query rows per CTA
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 128;  // threads per CTA: 4 per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1));
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
flash_prefill_fp32kv_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, TQ* __restrict__ o,
                     const int* __restrict__ prefix,
                     const int* __restrict__ total, int Sq, int H, int K,
                     int T, float scale, int window, float cap,
                     float* __restrict__ lse) {
  using teola::NEG_INF;
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  constexpr int DPT = HD / 4;   // output dims per thread (d = c + 4*i)
  constexpr int KPT = BK / 4;   // keys per thread per tile (j = c + 4*i)
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
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
  const int pre = prefix[b];
  const int tot = total[b];
  const int q_end = min(q0 + BQ, Sq);

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int rr = idx / HD, d = idx % HD, qi = q0 + rr;
    Qs[rr * LD + d] =
        qi < Sq ? teola::to_f(q[((size_t)(b * Sq + qi) * H + h) * HD + d])
                : 0.f;
  }

  const int qpos = pre + q0 + r;
  // a negative prefix or total (a sequence slice) gives kv_hi <= 0: no
  // tile; kv_lo is clamped to 0 before it is rounded down to a tile
  const int kv_hi = min(min(T, tot), pre + q_end);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, pre + q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int jj = idx / HD, d = idx % HD, j = j0 + jj;
      float kk = 0.f, vv = 0.f;
      if (j < T) {
        const size_t off = ((size_t)(b * T + j) * K + kvh) * HD + d;
        kk = teola::to_f(k[off]);
        vv = teola::to_f(v[off]);
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
      const bool ok = j <= qpos && j < tot && j < T &&
                      (window <= 0 || j > qpos - window);
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
    // with an LSE output, a row that saw no key gives o = 0, lse = -inf
    const bool empty = lse != nullptr && m <= NEG_INF;
    const size_t row = (size_t)(b * Sq + q0 + r) * H + h;
    if (lse != nullptr && c == 0)
      lse[row] = empty ? NEG_INF_LSE : m + logf(l);
    TQ* out = o + row * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      out[c + 4 * i] = teola::from_f<TQ>(empty ? 0.f : acc[i] / den);
  }
}

}  // namespace fp32kv

template <int HD, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* prefix, const int* total, int B, int Sq, int H, int K,
           int T, float scale, int window, float cap, cudaStream_t stream,
           float* lse) {
  if constexpr (std::is_same<TKV, float>::value) {
    auto kern = fp32kv::flash_prefill_fp32kv_kernel<HD, TQ, TKV>;
    constexpr size_t smem = fp32kv::smem_bytes<HD>();
    // once per instantiation, outside any CUDA-graph capture
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sq + fp32kv::BQ - 1) / fp32kv::BQ, H, B);
    kern<<<grid, fp32kv::NT, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), static_cast<TQ*>(o), prefix, total, Sq,
        H, K, T, scale, window, cap, lse);
    return (int)cudaGetLastError();
  } else {
    return ft::flash_tile_launch<HD, TQ>(q, k, v, o, prefix, total,
                                         teola::DenseKeys{T}, B, Sq, H, K,
                                         scale, window, cap, stream, lse);
  }
}

}  // namespace

// q (B,Sq,H,hd), k/v (B,T,K,hd), o (B,Sq,H,hd), all contiguous; prefix
// and total (B,) int32 on the device. window <= 0: none; cap <= 0: none.
// lse: null, or (B,Sq,H) fp32 on the device for each query row's
// log-sum-exp of its scores (after scale and cap; -inf, with o = 0, for a
// row that sees no key). prefix may be negative and total below it (a
// rank's slice of a sequence-split cache): rows then see no key.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int* prefix, const int* total,
                                    int B, int Sq, int H, int K, int T,
                                    int hd, int q_dtype, int kv_dtype,
                                    float scale, int window, float cap,
                                    float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || K <= 0 || H % K != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, launch, q, k, v, o, prefix, total,
                 B, Sq, H, K, T, scale, window, cap,
                 static_cast<cudaStream_t>(stream), lse);
}
