// Chunked-prefill attention over the block-paged KV pool, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
// src/repro/kernels/chunk_prefill.py::chunk_prefill_attention
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
// Design: K1's (flash_prefill.cu), reading K/V through the block table.
// One CTA per (q tile of BQ rows, query head, sequence), 128 threads, 4
// per query row. The CTA walks tiles of BK logical keys up to the tile's
// causal limit min(maxblk * bs, start[b] + q_tile_end) (tiles past it are
// never loaded: the reference's causal block skip) and, with a window,
// from the first tile the window reaches. Per tile, threads look up each
// key's physical row through the table once, then the tile is staged in
// shared memory as fp32 (rows padded by one word against bank conflicts);
// scores, the running max / denominator and the output accumulator stay in
// registers: the fp32 online softmax of the reference, with its NEG_INF
// sentinel and its 1e-30 floor on the denominator. Ragged Sq is masked in
// the kernel, so no Sq % bq rule remains.
//
// What bounds it on the H100: as for K1, ~4*Sq*T_eff*hd flops per head
// against 2*T_eff*K*hd*2 bytes of K/V per sequence, far above the card's
// flop:byte ridge at the serving chunk sizes (64-128), so it is
// compute-bound. This first version computes in fp32 on the CUDA cores
// from shared memory and uses no tensor cores; wgmma on bf16 tiles and
// table-driven TMA loads are later work (ROADMAP.md Queue 2).
#include "common.cuh"

namespace {

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
chunk_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                     const TKV* __restrict__ vp, TQ* __restrict__ o,
                     const int* __restrict__ tables,
                     const int* __restrict__ start, int Sq, int H, int K,
                     int bs, int maxblk, float scale, int window, float cap) {
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
    for (int i = 0; i < DPT; ++i) out[c + 4 * i] = teola::from_f<TQ>(acc[i] / den);
  }
}

template <int HD, typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, void* o,
           const int* tables, const int* start, int B, int Sq, int H, int K,
           int bs, int maxblk, float scale, int window, float cap,
           cudaStream_t stream) {
  auto kern = chunk_prefill_kernel<HD, TQ, TKV>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<TQ*>(o), tables, start, Sq, H,
      K, bs, maxblk, scale, window, cap);
  return (int)cudaGetLastError();
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
