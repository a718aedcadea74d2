// Paged GQA attention over the block-paged KV pool, for Hopper (sm_90a):
// decode (one query per sequence, K4) and speculative verification (a
// chunk of Sq queries per sequence, K3). Replaces the Pallas TPU kernels
// src/repro/kernels/decode_attention.py:281 paged_decode_attention
// (_paged_kernel) and :232 verify_attention (_verify_kernel).
//
// Sequence b's logical key j lives in physical block table[b, j / bs] at
// row j % bs of the (num_blocks, bs, K, hd) pools. Query s of the chunk sits
// at absolute position length[b] - Sq + s and sees key j when
//   j <= length[b] - Sq + s  (and j > that position - window).
// Decode is the Sq = 1 case: keys j < length[b].
//
// K3 (verify_attention_launch): split-KV, the paged instance of
// split_kv.cuh. A CTA holds all R = Sq * G query rows of one (kv head,
// sequence) in the reference's (K, Sq*G) row layout over one 64-key chunk,
// looking each key's physical row up through the table; a combine pass
// merges the chunks. What bounds it on the H100: bytes, at about Sq*G
// flops per byte of K/V (32 for a k=3 verify chunk at TinyLlama's G = 8),
// under the ridge; fp32 q, no tensor cores. The split gives
// ceil(maxblk*bs / 64) * K * B CTAs (128 at batch 4 over 512 keys), which
// is what the latency of a short decode-time call needs. Only rows of
// visible keys are copied, so out-of-table positions and the shared pad
// block are never read by a real row.
//
// K4 (paged_decode_launch): one CTA per (kv head, sequence) walking
// tiles of BK = 128 logical keys up to min(length, maxblk * bs). Each
// thread looks up one key's physical row, and the tile is staged in
// shared memory as fp32; per tile, thread j scores key j against the G
// rows, one warp per row runs the fp32 online-softmax update (NEG_INF
// sentinel, 1e-30 floor, as in the reference), and each thread
// accumulates its share of the G x hd output in registers. It is bound by
// latency with B*K CTAs (16 at batch 4); moving it onto split_kv.cuh as
// K3 is ROADMAP.md Queue 2's next step.
#include "split_kv.cuh"

namespace {

constexpr int BK = 128;  // logical keys per tile (one per thread)
constexpr int NT = 128;

template <int HD>
size_t smem_bytes(int R) {
  return sizeof(float) * ((size_t)R * HD + 2 * (size_t)BK * (HD + 1) +
                          (size_t)R * BK + 3 * (size_t)R) +
         sizeof(long long) * BK;
}

template <int HD, int MAXR, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp, TQ* __restrict__ o,
                       const int* __restrict__ tables,
                       const int* __restrict__ length, int Sq, int H, int K,
                       int bs, int maxblk, float scale, int window,
                       float cap) {
  using teola::NEG_INF;
  constexpr int LD = HD + 1;
  constexpr int OPT = MAXR * HD / NT;  // output slots per thread
  const int G = H / K;
  const int R = Sq * G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Roff = reinterpret_cast<long long*>(smem_raw);  // BK key rows
  float* Qs = reinterpret_cast<float*>(Roff + BK);  // R x HD
  float* Ks = Qs + R * HD;          // BK x LD
  float* Vs = Ks + BK * LD;         // BK x LD
  float* Ss = Vs + BK * LD;         // R x BK scores, then probabilities
  float* Ms = Ss + R * BK;          // running max per row
  float* Ls = Ms + R;               // running denominator per row
  float* As = Ls + R;               // this tile's rescale per row

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = length[b];
  const int* table = tables + (size_t)b * maxblk;

  // q/o element (s, g, d) of this group: ((b*Sq + s)*H + kvh*G + g)*HD + d
  for (int idx = tid; idx < R * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, s = r / G, g = r % G;
    Qs[idx] = teola::to_f(q[((size_t)(b * Sq + s) * H + kvh * G + g) * HD + d]);
  }
  for (int r = tid; r < R; r += NT) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }

  float acc[OPT];
#pragma unroll
  for (int u = 0; u < OPT; ++u) acc[u] = 0.f;

  const int q0 = len - Sq;  // position of chunk row 0
  const int hi = min(len, maxblk * bs);
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;

  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();  // previous tile consumed; Qs / Ms / Ls initialized
    {
      const int j = j0 + tid;  // NT == BK: one key row per thread
      long long off = -1;
      if (j < hi) {
        const int phys = table[j / bs];
        off = ((long long)phys * bs + j % bs) * K + kvh;
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

    {  // scores: thread tid owns key j0 + tid
      const int j = j0 + tid;
      for (int r = 0; r < R; ++r) {
        const int qpos = q0 + r / G;
        const bool ok =
            j < hi && j <= qpos && (window <= 0 || j > qpos - window);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot += Qs[r * HD + d] * Ks[tid * LD + d];
        Ss[r * BK + tid] = ok ? teola::score(dot, scale, cap) : NEG_INF;
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += NT / 32) {  // online softmax, warp/row
      float mx = NEG_INF;
      for (int jj = lane; jj < BK; jj += 32) mx = fmaxf(mx, Ss[r * BK + jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int jj = lane; jj < BK; jj += 32) {
        const float p = expf(Ss[r * BK + jj] - m_new);
        Ss[r * BK + jj] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[r] = alpha;
        Ls[r] = alpha * Ls[r] + psum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < OPT; ++u) {  // acc[r][d] = acc*alpha + P[r] . V[:, d]
      const int idx = tid + u * NT;
      if (idx < R * HD) {
        const int r = idx / HD, d = idx % HD;
        float a = acc[u] * As[r];
        for (int jj = 0; jj < BK; ++jj) a += Ss[r * BK + jj] * Vs[jj * LD + d];
        acc[u] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int idx = tid + u * NT;
    if (idx < R * HD) {
      const int r = idx / HD, d = idx % HD, s = r / G, g = r % G;
      o[((size_t)(b * Sq + s) * H + kvh * G + g) * HD + d] =
          teola::from_f<TQ>(acc[u] / fmaxf(Ls[r], 1e-30f));
    }
  }
}

// decode holds at most MAXR = 16 rows (G <= 16)
template <int HD, typename TQ, typename TKV>
int launch_decode(const void* q, const void* kp, const void* vp, void* o,
                  const int* tables, const int* length, int B, int Sq, int H,
                  int K, int bs, int maxblk, float scale, int window,
                  float cap, cudaStream_t stream) {
  constexpr int MAXR = 16;
  const int R = Sq * (H / K);
  if (R > MAXR) return (int)cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<HD, MAXR, TQ, TKV>;
  const size_t smem = smem_bytes<HD>(R);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<TQ*>(o), tables, length, Sq,
      H, K, bs, maxblk, scale, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o (B,H,hd), pools (nb,bs,K,hd), tables (B,maxblk) int32, length (B,)
// int32, all contiguous on the device. window <= 0: none; cap <= 0: none.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, void* o, const int* tables,
                                   const int* length, int B, int H, int K,
                                   int bs, int maxblk, int hd, int q_dtype,
                                   int kv_dtype, float scale, int window,
                                   float cap, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || bs <= 0 || maxblk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, launch_decode, q, kp, vp, o, tables,
                 length, B, 1, H, K, bs, maxblk, scale, window, cap,
                 static_cast<cudaStream_t>(stream));
}

// q/o (B,Sq,H,hd); pools, tables, length as paged_decode_launch; ws:
// ws_floats fp32 scratch on the device (split_kv_workspace(B, K,
// maxblk*bs, Sq*H/K, hd) of them). length counts the Sq chunk positions:
// query s sits at length - Sq + s.
extern "C" int verify_attention_launch(const void* q, const void* kp,
                                       const void* vp, void* o,
                                       const int* tables, const int* length,
                                       float* ws, long long ws_floats, int B,
                                       int Sq, int H, int K, int bs,
                                       int maxblk, int hd, int q_dtype,
                                       int kv_dtype, float scale, int window,
                                       float cap, void* stream) {
  if (B <= 0 || Sq <= 0 || K <= 0 || H % K != 0 || bs <= 0 || maxblk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, teola::split_kv_launch, q, kp, vp, o,
                 length, (teola::PagedKeys{tables, bs, maxblk}), maxblk * bs,
                 ws, ws_floats, B, Sq, H, K, scale, window, cap,
                 static_cast<cudaStream_t>(stream));
}
