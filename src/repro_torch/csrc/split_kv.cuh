// Split-KV (flash-decoding) GQA attention for a few query rows per
// sequence, for Hopper (sm_90a): the shared body of K2 (dense decode,
// decode_attention.cu), K3 (paged speculative verification) and K4 (paged
// decode, both paged_attention.cu). They differ only in how key j of
// sequence b is addressed (DenseKeys, PagedKeys, PagedDecodeKeys in
// common.cuh).
//
// Rows. A CTA holds the R = Sq * G query rows of one (kv head, sequence)
// in the reference's GQA-grouped layout: row s*G + g is chunk position s
// of head kvh*G + g, at absolute position length[b] - Sq + s. K2 and K4
// are the Sq = 1 cases. Row r sees key j when j <= its position, j < span
// and (window > 0) j > position - window; scores are scale * q.k, then
// cap * tanh(s / cap) when cap > 0, exactly as in the reference.
//
// Split pass, grid (NS, K, B) with NS = ceil(span / CH): CTA s takes keys
// [s*CH, (s+1)*CH). NS comes from the shapes alone; the CTA reads
// length[b] on the device, and one whose keys are visible to none of its
// rows (past the length, before the window) returns at once. A live CTA
//   1. issues 16-byte cp.async copies of its K, then its V chunk, into
//      shared memory in the storage type (rows outside the visible range
//      are zero-filled, never read), swizzled so that 8 lanes reading 8
//      keys (or 8 chunks of one key) hit 8 distinct bank groups;
//   2. stages Q in fp32 while the copies fly;
//   3. S = Q K^T: each thread owns a 4-row x 4-key tile over a share of
//      hd (8 FMAs per shared load at bf16), partial sums reduced through
//      shared memory when the tiles are fewer than the threads;
//   4. softmax of the chunk, one warp per row, with warp shuffles; masked
//      keys get NEG_INF for the max and exactly 0 for the sum;
//   5. P V: each thread owns a 4-row x 8-dim tile over a share of the
//      keys (6.4 FMAs per shared load);
// and writes the chunk's max m, sum l and unnormalised acc (R x hd, fp32)
// to the caller's workspace.
//
// Combine pass, grid (ceil(R*hd / CB), K, B): recomputes the live splits
// from length and window, reads only theirs (the rest of the workspace is
// uninitialised) and merges them: m* = max m_i, l = sum e^(m_i - m*) l_i,
// o = sum e^(m_i - m*) acc_i / max(l, 1e-30), written in q's dtype in the
// reference's (B, Sq, H, hd) layout; on request each row's log-sum-exp
// m* + log(l) (-inf, with o = 0, where no key is visible: a length of 0).
//
// What bounds it on the H100: bytes. Each K/V row (4*hd bytes in bf16) is
// read once for all R rows: about 4*R*hd flops per 4*hd bytes, ~2*G flops
// per byte for K2 and ~Sq*G for K3 (16 and 32 at TinyLlama's G = 8, k = 3),
// against the card's ridge of ~295 (bf16 tensor cores) or ~20 (fp32 CUDA
// cores at 67 TFLOP/s over 3.35 TB/s). No wgmma and no TMA: the work sits
// under the ridge, and the reference's fp32 q (tests hold 2e-5) would have
// to be rounded to bf16 to use the tensor cores. At decode sizes the real
// limit is latency: B*K CTAs (16 at batch 4) cannot cover a 132-SM card
// or hide a DRAM round trip. The split gives NS times as many CTAs (128 at
// batch 4 over 512 keys), each a short chunk whose K and V copies are in
// flight together while Q is staged.
//
// The workspace comes from the caller on every call (torch.empty from the
// caching allocator): stream-ordered, private to the call, and valid under
// CUDA-graph capture. Nothing here reads a length on the host.
#pragma once

#include "common.cuh"

namespace teola {

constexpr int SKV_CH = 64;     // keys per split (a multiple of block sizes)
constexpr int SKV_LDS = 65;    // row stride of the P tile (bank spread)
constexpr int SKV_NT = 128;    // threads per CTA, both passes
constexpr int SKV_MAXR = 64;   // query rows per CTA (Sq * G)
constexpr int SKV_CB = 128;    // output elements per combine CTA
constexpr int SKV_RB = 4096;   // floats of the partial-sum buffer

// Keys [lo, hi) that some row of a sequence of total length len may see:
// rows sit at len - Sq .. len - 1.
__device__ __forceinline__ void visible_keys(int len, int Sq, int span,
                                             int window, int* lo, int* hi) {
  *hi = min(len, span);
  *lo = window > 0 ? max(0, len - Sq - window + 1) : 0;
}

// Element offset of 16-byte chunk i of key c in a swizzled K or V tile.
template <int NCHK, int EPC>
__device__ __forceinline__ int swz(int c, int i) {
  return (c * NCHK + (i ^ (c & 7))) * EPC;
}

// One 16-byte chunk of a K/V tile as floats (8 bf16 or 4 fp32 values).
__device__ __forceinline__ void chunk_to_f(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void chunk_to_f(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

template <int HD, typename TKV>
__host__ __device__ constexpr size_t split_kv_smem(int R4) {
  return SKV_CH * sizeof(long long) + 2 * (size_t)SKV_CH * HD * sizeof(TKV) +
         (size_t)R4 * (HD + SKV_LDS) * sizeof(float) +
         (size_t)SKV_RB * sizeof(float);
}
// The largest instantiation, hd 256 with fp32 K/V at SKV_MAXR rows: 512 +
// 131,072 + 82,176 + 16,384 = 230,144 of the 232,448 bytes a CTA can have.
// The partial sums stay within SKV_RB at any hd: DS * R4 * CH <= 2048 and,
// when KS > 1, KS * R4 * hd <= NT * 32 = 4096 floats.
static_assert(split_kv_smem<256, float>(SKV_MAXR) <= 232448,
              "split pass over 227 KB at hd 256");

template <int HD, typename TQ, typename TKV, typename Keys>
__global__ void __launch_bounds__(SKV_NT)
split_kv_partial(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const int* __restrict__ length,
                 Keys keys, float* __restrict__ ws_acc,
                 float* __restrict__ ws_ml, int Sq, int H, int K, float scale,
                 int window, float cap) {
  constexpr int CH = SKV_CH, NT = SKV_NT, LDS = SKV_LDS;
  constexpr int EPC = 16 / sizeof(TKV);  // elements per 16-byte chunk
  constexpr int NCHK = HD / EPC;         // chunks per key row (>= 8)
  constexpr int NDG = HD / 8;            // 8-dim groups per row (P V)
  const int G = H / K, R = Sq * G, R4 = (R + 3) & ~3;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = length[b];
  const int span = keys.span();
  int lo, hi;
  visible_keys(len, Sq, span, window, &lo, &hi);
  const int c0 = s * CH;
  if (lo >= hi || c0 >= hi || c0 + CH <= lo) return;  // nothing visible

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Roff = reinterpret_cast<long long*>(smem_raw);  // CH rows
  TKV* Ks = reinterpret_cast<TKV*>(Roff + CH);  // CH x HD, swizzled
  TKV* Vs = Ks + CH * HD;                       // CH x HD, swizzled
  float* Qs = reinterpret_cast<float*>(Vs + CH * HD);  // R4 x HD
  float* Ss = Qs + R4 * HD;                     // R4 x LDS scores, then P
  float* Rb = Ss + R4 * LDS;                    // partial sums

  // 1. element offset of each key row of the chunk (-1: not visible)
  if (tid < CH) {
    const int j = c0 + tid;
    Roff[tid] = (j >= lo && j < hi) ? keys.row(b, j, kvh, K) * HD : -1;
  }
  __syncthreads();
  for (int idx = tid; idx < CH * NCHK; idx += NT) {
    const int c = idx / NCHK, i = idx % NCHK;
    const long long off = Roff[c];
    cp_async16(Ks + swz<NCHK, EPC>(c, i), off >= 0 ? k + off + i * EPC : k,
               off >= 0);
  }
  cp_async_commit();
  for (int idx = tid; idx < CH * NCHK; idx += NT) {
    const int c = idx / NCHK, i = idx % NCHK;
    const long long off = Roff[c];
    cp_async16(Vs + swz<NCHK, EPC>(c, i), off >= 0 ? v + off + i * EPC : v,
               off >= 0);
  }
  cp_async_commit();

  // 2. Q rows in fp32; rows R..R4-1 are zero
  const int q0 = len - Sq;  // position of chunk row 0
  for (int idx = tid; idx < R4 * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    if (r < R) {
      const int sq = r / G, g = r % G;
      x = to_f(q[(((size_t)b * Sq + sq) * H + kvh * G + g) * HD + d]);
    }
    Qs[idx] = x;
  }
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // 3. S = Q K^T in 4 x 4 tiles: keys kg + 16*j, hd split DS ways
  const int ntq = (R4 / 4) * (CH / 4);
  const int DS = ntq >= NT ? 1 : NT / ntq;
  for (int w = tid; w < ntq * DS; w += NT) {
    const int tile = w % ntq, ds = w / ntq;
    const int r0 = (tile / (CH / 4)) * 4, kg = tile % (CH / 4);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
    for (int i = ds; i < NCHK; i += DS) {
      float kf[4][EPC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        chunk_to_f(Ks + swz<NCHK, EPC>(kg + 16 * j, i), kf[j]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* qr = Qs + (r0 + a) * HD + i * EPC;
        float qf[EPC];
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr + e);
          qf[e] = x.x;
          qf[e + 1] = x.y;
          qf[e + 2] = x.z;
          qf[e + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[a][j] += qf[e] * kf[j][e];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* dst =
          DS == 1 ? Ss + (r0 + a) * LDS : Rb + (ds * R4 + r0 + a) * CH;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[kg + 16 * j] = acc[a][j];
    }
  }
  __syncthreads();

  // 4. the chunk's softmax, one warp per row; (m, l) to the workspace
  float* ml = ws_ml + (((size_t)b * K + kvh) * NS + s) * R * 2;
  for (int r = warp; r < R4; r += NT / 32) {
    const int qpos = q0 + r / G;
    float sc[2];
    bool vis[2];
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u, j = c0 + c;
      float x = 0.f;
      if (DS == 1) {
        x = Ss[r * LDS + c];
      } else {
        for (int ds = 0; ds < DS; ++ds) x += Rb[(ds * R4 + r) * CH + c];
      }
      vis[u] = r < R && j < span && j <= qpos &&
               (window <= 0 || j > qpos - window);
      sc[u] = vis[u] ? score(x, scale, cap) : NEG_INF;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float p = vis[u] ? expf(sc[u] - mx) : 0.f;
      Ss[r * LDS + lane + 32 * u] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && r < R) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = sum;
    }
  }
  cp_async_wait<0>();  // this thread's V copies have landed
  __syncthreads();

  // 5. acc = P V in 4-row x 8-dim tiles, keys split KS ways
  const int ntv = (R4 / 4) * NDG;
  const int KS = ntv >= NT ? 1 : NT / ntv;
  float* wacc = ws_acc + (((size_t)b * K + kvh) * NS + s) * R * HD;
  for (int w = tid; w < ntv * KS; w += NT) {
    const int tile = w % ntv, ks = w / ntv;
    const int r0 = (tile / NDG) * 4, dg = tile % NDG;
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
    for (int c = ks; c < CH; c += KS) {
      float vf[8];
#pragma unroll
      for (int h = 0; h < 8 / EPC; ++h)
        chunk_to_f(Vs + swz<NCHK, EPC>(c, dg * (8 / EPC) + h), vf + h * EPC);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Ss[(r0 + a) * LDS + c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] += p * vf[e];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* dst = KS == 1 ? (r0 + a < R ? wacc + (r0 + a) * HD : nullptr)
                           : Rb + (ks * R4 + r0 + a) * HD;
      if (dst == nullptr) continue;
      *reinterpret_cast<float4*>(dst + dg * 8) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(dst + dg * 8 + 4) =
          make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    }
  }
  if (KS > 1) {
    __syncthreads();
    for (int idx = tid; idx < R * HD; idx += NT) {
      float x = 0.f;
      for (int ks = 0; ks < KS; ++ks) x += Rb[ks * R4 * HD + idx];
      wacc[idx] = x;
    }
  }
}

template <int HD, typename TQ, typename Keys>
__global__ void __launch_bounds__(SKV_NT)
split_kv_combine(const float* __restrict__ ws_acc,
                 const float* __restrict__ ws_ml,
                 const int* __restrict__ length, Keys keys, TQ* __restrict__ o,
                 int Sq, int H, int K, int window, float* __restrict__ lse) {
  constexpr int CH = SKV_CH, NT = SKV_NT;
  const int G = H / K, R = Sq * G;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int NS = (keys.span() + CH - 1) / CH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Mst = reinterpret_cast<float*>(smem_raw);  // R merged maxima
  float* Den = Mst + SKV_MAXR;                      // R merged sums

  int lo, hi;
  visible_keys(length[b], Sq, keys.span(), window, &lo, &hi);
  const int s_lo = lo < hi ? lo / CH : 0;
  const int s_hi = lo < hi ? (hi + CH - 1) / CH : 0;
  const size_t base = ((size_t)b * K + kvh) * NS;  // split 0 of (b, kvh)

  const int e0 = blockIdx.x * SKV_CB;
  const int e1 = min(e0 + SKV_CB, R * HD);
  for (int r = e0 / HD + warp; r <= (e1 - 1) / HD; r += NT / 32) {
    float mx = NEG_INF;
    for (int sp = s_lo + lane; sp < s_hi; sp += 32)
      mx = fmaxf(mx, ws_ml[((base + sp) * R + r) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int sp = s_lo + lane; sp < s_hi; sp += 32) {
      const float* p = ws_ml + ((base + sp) * R + r) * 2;
      l += expf(p[0] - mx) * p[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      Mst[r] = mx;
      Den[r] = fmaxf(l, 1e-30f);
      // the row's log-sum-exp, by the CTA that holds its first element;
      // -inf where no key is visible (l = 0: o is 0 there too)
      if (lse != nullptr && r * HD >= e0)
        lse[((size_t)b * Sq + r / G) * H + kvh * G + r % G] =
            l > 0.f ? mx + logf(l) : NEG_INF_LSE;
    }
  }
  __syncthreads();

  for (int idx = e0 + tid; idx < e1; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    for (int sp0 = s_lo; sp0 < s_hi; sp0 += 8) {  // 8 splits' loads at once
      float m[8], a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int sp = sp0 + u;
        m[u] = sp < s_hi ? ws_ml[((base + sp) * R + r) * 2] : NEG_INF;
        a[u] = sp < s_hi ? ws_acc[(base + sp) * R * HD + idx] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) x += expf(m[u] - Mst[r]) * a[u];
    }
    const int sq = r / G, g = r % G;
    o[(((size_t)b * Sq + sq) * H + kvh * G + g) * HD + d] =
        from_f<TQ>(x / Den[r]);
  }
}

// Floats of the workspace one call needs: (B, K, NS) splits of R x hd
// partial sums, then their (m, l) pairs.
inline long long split_kv_workspace(int B, int K, int span, int R, int hd) {
  const long long NS = (span + SKV_CH - 1) / SKV_CH;
  return (long long)B * K * NS * R * (hd + 2);
}

// Both passes on one stream. ws holds ws_floats floats (at least
// split_kv_workspace(...)); k / v must be 16-byte aligned. lse: null, or
// (B, Sq, H) fp32 for each query row's log-sum-exp (the combine pass's
// merged m + log(l)).
template <int HD, typename TQ, typename TKV, typename Keys>
int split_kv_launch(const void* q, const void* k, const void* v, void* o,
                    const int* length, Keys keys, int span, float* ws,
                    long long ws_floats, int B, int Sq, int H, int K,
                    float scale, int window, float cap, cudaStream_t stream,
                    float* lse = nullptr) {
  const int R = Sq * (H / K), R4 = (R + 3) & ~3;
  if (R > SKV_MAXR || span <= 0) return (int)cudaErrorInvalidValue;
  if (ws_floats < split_kv_workspace(B, K, span, R, HD))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v)) & 15)
    return (int)cudaErrorMisalignedAddress;
  auto part = split_kv_partial<HD, TQ, TKV, Keys>;
  // once per instantiation, so that no attribute call falls inside a
  // CUDA-graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      part, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_kv_smem<HD, TKV>(SKV_MAXR));
  if (attr != cudaSuccess) return (int)attr;
  const int NS = (span + SKV_CH - 1) / SKV_CH;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * K * NS * R * HD;
  part<<<dim3(NS, K, B), SKV_NT, split_kv_smem<HD, TKV>(R4), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), length, keys, ws_acc, ws_ml, Sq, H, K,
      scale, window, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto comb = split_kv_combine<HD, TQ, Keys>;
  comb<<<dim3((R * HD + SKV_CB - 1) / SKV_CB, K, B), SKV_NT,
         2 * SKV_MAXR * sizeof(float), stream>>>(
      ws_acc, ws_ml, length, keys, static_cast<TQ*>(o), Sq, H, K, window,
      lse);
  return (int)cudaGetLastError();
}

}  // namespace teola
