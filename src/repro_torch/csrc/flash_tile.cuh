// Tile core of the port's tensor-core flash attention, for Hopper (sm_90a):
// the pieces of a kernel that walks 64-key K/V tiles for 64 or 128 packed
// query rows, and that kernel, flash_tile_kernel, one template over the key
// addressing (common.cuh). K1 flash_prefill (flash_prefill.cu) runs it over
// the dense cache (DenseKeys), K5 chunk_prefill_attention (chunk_prefill.cu)
// over the block table of the paged pool (ChunkPagedKeys).
//
// Rows. A CTA holds rows<HD>() query rows, a warpgroup per 64 and a warp
// per 16: 128 rows (two warpgroups, 256 threads) at hd 64 and 128, 64 rows
// (one warpgroup, 128 threads) at hd 256, where three fp32 pieces of 128
// query rows (192 KB) would not fit beside the K/V ring (128 KB) in the
// 227 KB a CTA can have. Warp w holds rows 16w..16w+15. Each thread holds
// two of its warp's rows, r0 = lane/4 and r1 = r0 + 8, in wgmma's m64nN
// accumulator layout: element 4*nb + e of an accumulator is row r0 (e < 2)
// or r1 (e >= 2), column 8*nb + 2*(lane%4) + e%2. At hd 256 the output
// accumulator is 128 floats a thread beside the S tile's 32, with no
// second warpgroup to share them (a split of the output columns over two
// warpgroups would compute S twice, or pass P through 24 KB of shared
// memory there is not). So P's bf16 pieces are formed one at a time
// (pv_tile_lean: 16 registers, not 48) and the operand descriptors are
// formed where they are used, to stay within the 255 a thread can have.
//
// Shared memory, all in wgmma's 128-byte-swizzle layout (hd/64 column
// blocks of R rows x 128 B, 16-byte chunk i of row c at chunk (i ^ c) % 8
// of its row; 1024-byte aligned): Q's pieces (R = rows<HD>(), written
// once), then a ring of STAGES stages, each a K tile and a V tile (R = 64
// keys). K and V arrive by 16-byte cp.async in their storage type (bf16);
// keys at or past the caller's limit are zero-filled, never read.
//
// Products, both on the tensor cores (wgmma.mma_async m64nNk16, bf16
// operands, fp32 accumulation):
//   S = Q K^T with A (Q) and B (K) from shared memory, both K-major;
//   O += P V with A (P) in registers, converted from the fp32 softmax
//     (FlashAttention-3's register reuse), and B (V) from shared memory,
//     MN-major (wgmma transposes 16-bit B).
// Split precision: an fp32 operand (Q, P) is the sum of NP = 3 bf16
// pieces, x = x0 + x1 + x2 with x_i = bf16(x - x_0 - ... - x_{i-1}); each
// remainder is exact in fp32, and the pieces carry 24 significand bits,
// fp32's own. One MMA per piece goes into the same fp32 accumulator, the
// smallest piece first. K and V are bf16 already, so exact operands; a
// bf16 q is its own single piece. Measured on the H100 against a float64
// evaluation, this is as close as the fp32 reference computed on the card
// at unit-scale inputs, and 2.5-3.7x closer at q, k ~ 3 N(0,1), where fp32
// scores near 40 carry 4e-6 of rounding; one piece is not
// (tests/test_torch_kernels.py).
//
// Softmax (softmax_tile): the reference's fp32 online softmax. A key is
// visible to a row at position qpos when j < lim, j <= qpos and (window >
// 0) j > qpos - window; its score is scale * s, then cap * tanh(s / cap)
// when cap > 0; invisible keys score NEG_INF, and p = exp(s - m_new) for
// every key as in the reference (a row that has seen no key yet counts
// its masked keys until a visible key's alpha = 0 clears them). Row maxima
// are reduced over the quad of lanes that share a row; each lane keeps a
// partial denominator, summed over the quad at the end (finish_rows).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace teola {
namespace ft {

constexpr int BK = 64;      // keys per K/V tile
constexpr int STAGES = 2;   // K/V tiles in flight (a ring)
constexpr int NP = 3;       // bf16 pieces of an fp32 operand

// query rows per CTA (a warpgroup per 64), and threads (a warp per 16)
template <int HD>
__host__ __device__ constexpr int rows() {
  return HD <= 128 ? 128 : 64;
}
template <int HD>
__host__ __device__ constexpr int threads() {
  return 2 * rows<HD>();
}

// bytes of one K or V tile, of one Q piece, and of one stage (K, V)
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return BK * HD * 2;
}
template <int HD>
__host__ __device__ constexpr int q_bytes() {
  return rows<HD>() * HD * 2;
}
template <int HD>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * tile_bytes<HD>();
}
// dynamic shared memory of a kernel with NQ pieces of Q, plus slack to
// align it to 1024 bytes: at hd 256 and an fp32 q, 1024 + 3 x 32 KB + 2 x
// 64 KB = 230,400 of the 232,448 bytes a CTA can have
template <int HD, int NQ>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)NQ * q_bytes<HD>() + STAGES * stage_bytes<HD>();
}
static_assert(smem_bytes<256, NP>() <= 232448, "hd 256 tile over 227 KB");

// Byte offset of 16-byte chunk i (dims 8i..8i+7) of row c in a buffer of
// R rows.
template <int R>
__device__ __forceinline__ uint32_t swz(int c, int i) {
  return (uint32_t)((i >> 3) * (R * 128) + c * 128 +
                    (((i & 7) ^ (c & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async the hd-wide bf16 rows of keys [j0, j0 + BK) of (b, kvh) from
// src (a K or V cache addressed by keys) into the tile at dst; rows of
// keys j >= hi are zero-filled.
template <int HD, typename Keys>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          const Keys& keys, int b, int kvh,
                                          int K, int j0, int hi, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per key row
  constexpr int NT = threads<HD>();
#pragma unroll
  for (int u = 0; u < BK * CPR / NT; ++u) {
    const int idx = tid + u * NT, c = idx / CPR, i = idx % CPR;
    const bool ok = j0 + c < hi;
    const __nv_bfloat16* g =
        ok ? src + keys.row(b, j0 + c, kvh, K) * HD + i * 8 : src;
    cp_async16(dst + swz<BK>(c, i), g, ok);
  }
}

// 8 consecutive values as floats, and back as 8 bf16 in 16 bytes
__device__ __forceinline__ void ld8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void st8(unsigned char* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
      pack2(x[6], x[7]));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Quarter qt of query row `row` (src: its hd values, null for a padding
// row) into Q's NQ pieces at qs: three pieces of an fp32 row, a bf16 row
// as it is.
template <int HD, int NQ, typename TQ>
__device__ __forceinline__ void store_q(unsigned char* qs, int row,
                                        const TQ* src, int qt) {
  constexpr int CH = HD / 32;  // 16-byte chunks per quarter row
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
    if (src) ld8(src + (qt * CH + u) * 8, x);
    const uint32_t off = swz<rows<HD>()>(row, qt * CH + u);
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
      float pc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pc[e] = __bfloat162float(__float2bfloat16(x[e]));
        x[e] -= pc[e];
      }
      st8(qs + a * q_bytes<HD>() + off, pc);
    }
  }
}

// The NP free bf16 pieces of the pair (lo, hi), packed as A-fragment
// registers (lo in the low half), largest piece first.
__device__ __forceinline__ void split_pair(float lo, float hi,
                                           uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    lo -= f.x;
    hi -= f.y;
  }
}

// P's A fragments for the 4 k-steps of a 64-key tile, from the fp32
// probabilities in the accumulator s: all NP pieces (p_frags), or piece p
// alone (p_piece; 0 is the largest).
__device__ __forceinline__ void p_frags(const float (&s)[32],
                                        uint32_t (&pa)[NP][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {  // n-block 2kk + reg/2, row reg%2
      const int e = 8 * kk + 4 * (reg >> 1) + 2 * (reg & 1);
      uint32_t pc[NP];
      split_pair(s[e], s[e + 1], pc);
#pragma unroll
      for (int i = 0; i < NP; ++i) pa[i][kk][reg] = pc[i];
    }
  }
}
__device__ __forceinline__ void p_piece(const float (&s)[32], int p,
                                        uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int e = 8 * kk + 4 * (reg >> 1) + 2 * (reg & 1);
      uint32_t pc[NP];
      split_pair(s[e], s[e + 1], pc);
      pa[kk][reg] = pc[p];
    }
  }
}

// One online-softmax step over a tile: s holds the raw dot products of the
// thread's rows with keys j0.. (in, accumulator layout) and leaves as p;
// m, l are the rows' running max and this lane's partial denominator;
// the output accumulator o is rescaled by alpha.
template <int HD>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             float (&o)[HD / 2],
                                             float (&m)[2], float (&l)[2],
                                             const int (&qpos)[2], int j0,
                                             int lim, int window, float scale,
                                             float cap, int lane) {
  const int c = j0 + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * nb + 2 * r + e, j = c + 8 * nb + e;
        const bool vis = j < lim && j <= qpos[r] &&
                         (window <= 0 || j > qpos[r] - window);
        s[idx] = vis ? score(s[idx], scale, cap) : NEG_INF;
        mx = fmaxf(mx, s[idx]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float alpha = expf(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * nb + 2 * r + e;
        s[idx] = expf(s[idx] - m_new);
        sum += s[idx];
      }
    }
    l[r] = alpha * l[r] + sum;
    m[r] = m_new;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      o[4 * nb + 2 * r] *= alpha;
      o[4 * nb + 2 * r + 1] *= alpha;
    }
  }
}

// o / max(l, 1e-30) in TQ to the rows at row[0], row[1] (null: not
// stored); l summed over the quad first. With an LSE output (lse not
// null: (B, Sq, H) fp32, row i of out's (B, Sq, H, hd) at lse[i]), each
// stored row's log-sum-exp m + log(l) is written by the quad's first lane,
// and a row that saw no key (m still NEG_INF) gives o = 0 and lse = -inf;
// without one nothing else changes. The LSE row is found from the output
// row's offset at the end, so the tile loop holds no pointer for it.
template <int HD, typename TQ>
__device__ __forceinline__ void finish_rows(const float (&o)[HD / 2],
                                            float (&l)[2],
                                            const float (&m)[2],
                                            TQ* const (&row)[2],
                                            const TQ* out, float* lse,
                                            int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    if (row[r] == nullptr) continue;
    const bool empty = lse != nullptr && m[r] <= NEG_INF;
    if (lse != nullptr && (lane & 3) == 0)
      lse[(row[r] - out) / HD] = empty ? NEG_INF_LSE : m[r] + logf(l[r]);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      st2(row[r] + 8 * nb + c, empty ? 0.f : o[4 * nb + 2 * r] / den,
          empty ? 0.f : o[4 * nb + 2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// The products as warpgroup MMAs (wgmma.mma_async, sm_90a).

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}
// K-major operand of R rows, k-step kk: 32*kk bytes into its 64-dim
// column block; 8-row groups 1024 B apart
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  return gmma_desc(base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 1, 64);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across the async MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// shared-memory writes (generic proxy: st.shared, cp.async) made visible
// to wgmma's operand reads (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (m64 x n64, fp32) += A (m64 x k16) x B (k16 x n64), both bf16 in shared
// memory through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t adesc,
                                             uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// D (m64 x n64, fp32) += A (m64 x k16, bf16, registers) x B (k16 x n64,
// bf16, shared memory through bdesc, MN-major: wgmma's transpose flag 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// D (m64 x n128, fp32) += A (m64 x k16, bf16, registers) x B (k16 x n128,
// bf16, shared memory through bdesc, MN-major: wgmma's transpose flag 1);
// D is elements O..O+63 of d.
template <int O, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                          const uint32_t (&a)[4],
                                          uint64_t bdesc) {
  static_assert(O + 64 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// S = Q K^T over one tile for one warpgroup: qa is its 64 rows of Q's NQ
// pieces (piece stride q_bytes), kt the K tile; NQ x hd/16 m64n64k16.
template <int HD, int NQ>
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t qa,
                                        uint32_t kt) {
  // at hd 256 Q's NQ x 16 descriptors are formed here, each tile, not
  // hoisted out of the tile loop into live registers (see pv_tile_lean)
  if constexpr (HD > 128) asm volatile("" : "+r"(qa), "+r"(kt));
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int a = NQ - 1; a >= 0; --a)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<rows<HD>()>(qa + a * q_bytes<HD>(), kk),
                   kmajor_desc<BK>(kt, kk));
  wg_commit_wait();
  fence_regs(s);
}

// O += P V over the tile at vt (hd 64 and 128): NP pieces x 4 k-steps of
// m64n{hd}k16. MN-major B: k-step kk starts at key row 16*kk (2048 B);
// 8-row groups 1024 B apart, 64-dim column blocks 8192 B apart.
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const uint32_t (&pa)[NP][4][4],
                                        uint32_t vt) {
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int p = NP - 1; p >= 0; --p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = gmma_desc(vt + kk * 2048, (BK * 128) >> 4, 64);
      if constexpr (HD == 64)
        wgmma_rs_n64(o, pa[p][kk], d);
      else
        wgmma_rs_n128<0>(o, pa[p][kk], d);
    }
  wg_commit_wait();
  fence_regs(o);
}

// O += P V over the tile at vt at hd 256, where the accumulator alone is
// 128 registers a thread: P's pieces are formed from the fp32
// probabilities in s one at a time, smallest first, and each is waited for
// before the next, so that 16 fragment registers are live instead of 48.
// Per piece and k-step, two m64n128k16 over output columns 0-127 and
// 128-255 (o's elements 0-63 and 64-127; V's column blocks 0-1 and 2-3).
// vt passes through an empty asm so that its 8 descriptors are formed here
// and not hoisted out of the tile loop into live registers.
template <int HD>
__device__ __forceinline__ void pv_tile_lean(float (&o)[HD / 2],
                                             const float (&s)[32],
                                             uint32_t vt) {
  static_assert(HD == 256, "the lean P V is hd 256's");
  asm volatile("" : "+r"(vt));
#pragma unroll
  for (int p = NP - 1; p >= 0; --p) {
    uint32_t pa[4][4];
    p_piece(s, p, pa);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t v0 = vt + kk * 2048;
      wgmma_rs_n128<0>(o, pa[kk], gmma_desc(v0, (BK * 128) >> 4, 64));
      wgmma_rs_n128<64>(o, pa[kk], gmma_desc(v0 + 2 * BK * 128,
                                             (BK * 128) >> 4, 64));
    }
    wg_commit_wait();
    fence_regs(o);
  }
}

// ---------------------------------------------------------------------------
// The kernel. Chunk row i of sequence b sits at position base[b] + i; it
// sees key j when j < lim = min(keys.span(), total[b]) (keys.span() when
// total is null), j <= its position and (window > 0) j > position -
// window. q and o are (B, Sq, H, hd); K and V are addressed by keys.
//
// GQA packing: one CTA per (tile of BQ query positions, kv head, sequence),
// its ROWS = rows<HD>() rows the (position, head-in-group) pairs, position
// major: GC = min(G, ROWS) heads of the group, BQ = ROWS / GC positions (16
// at TinyLlama's G = 8, 32 at Gemma-2's G = 2 and hd 256). Each K/V tile is
// read once for all GC heads. A G that does not divide ROWS pads rows; G >
// ROWS takes NHC = ceil(G / ROWS) CTAs per kv head. The CTA walks tiles
// from the window's first (0 without one) up to its causal limit min(lim,
// base[b] + last position + 1): tiles past it are never loaded, and no key
// at or past that limit is addressed (for paged keys: no table entry past
// maxblk is read).
template <int HD, typename TQ, typename Keys>
__global__ void __launch_bounds__(threads<HD>(), 1)
flash_tile_kernel(const TQ* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, TQ* __restrict__ o,
                  const int* __restrict__ base,
                  const int* __restrict__ total, Keys keys, int Sq, int H,
                  int K, int GC, int NHC, float scale, int window,
                  float cap, float* __restrict__ lse) {
  // pieces of Q: three of an fp32 q, a bf16 q as it is
  constexpr int NQ = std::is_same<TQ, float>::value ? NP : 1;
  constexpr int TB = tile_bytes<HD>(), SB = stage_bytes<HD>();
  constexpr int ROWS = rows<HD>(), NT = threads<HD>();
  const int G = H / K, BQ = ROWS / GC;
  const int q0 = blockIdx.x * BQ, b = blockIdx.z;
  const int kvh = blockIdx.y / NHC, hc = blockIdx.y % NHC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pre = base[b];
  const int npos = min(BQ, Sq - q0);   // query positions of this tile
  const int lim = total ? min(keys.span(), total[b]) : keys.span();
  const int hi = min(lim, pre + q0 + npos);
  int lo = window > 0 ? max(0, pre + q0 - window + 1) : 0;
  lo = lo / BK * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* ring = qs + NQ * q_bytes<HD>();
  // stage st: the K tile at ring + st*SB, the V tile after it
  if (ntiles > 0) {
    load_tile<HD>(ring, k, keys, b, kvh, K, lo, hi, tid);
    cp_async_commit();
    load_tile<HD>(ring + TB, v, keys, b, kvh, K, lo, hi, tid);
    cp_async_commit();
  }

  // CTA row r is position r / GC of the tile and head hc*GC + r % GC of
  // the group; returns the element offset of its q / o row, or -1
  auto row_off = [&](int r) -> long long {
    const int p = r / GC, g = hc * GC + r % GC;
    if (p >= npos || g >= G) return -1;
    return (((long long)b * Sq + q0 + p) * H + kvh * G + g) * HD;
  };
  // Q's pieces, four lanes per row, while the first tile's copies fly
#pragma unroll
  for (int pass = 0; pass < ROWS / (NT / 4); ++pass) {
    const int r = pass * (NT / 4) + (tid >> 2);
    const long long off = row_off(r);
    store_q<HD, NQ>(qs, r, off >= 0 ? q + off : nullptr, tid & 3);
  }
  // this thread's accumulator rows r0, r1 (16*warp + lane/4 + 8r)
  int qpos[2];
  TQ* orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;
    const long long off = row_off(row);
    qpos[r] = off >= 0 ? pre + q0 + row / GC : -1;  // -1: sees no key
    orow[r] = off >= 0 ? o + off : nullptr;
  }
  // a warpgroup whose first row is past the tile's positions has no row
  const int wg = warp >> 2;
  const bool live = (64 * wg) / GC < npos;
  const uint32_t qa = smem_addr(qs) + wg * 64 * 128;

  float acc[HD / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = lo + t * BK;
    unsigned char* kt = ring + (t & 1) * SB;
    if (t + 1 < ntiles) {  // the next tile into the other stage
      unsigned char* nk = ring + ((t + 1) & 1) * SB;
      load_tile<HD>(nk, k, keys, b, kvh, K, j0 + BK, hi, tid);
      cp_async_commit();
      load_tile<HD>(nk + TB, v, keys, b, kvh, K, j0 + BK, hi, tid);
    } else {
      cp_async_commit();  // empty groups keep the count uniform
    }
    cp_async_commit();
    cp_async_wait<3>();  // this tile's K
    fence_async_smem();
    __syncthreads();
    float s[32];
    uint32_t pa[NP][4][4];  // hd <= 128; at hd 256 pv_tile_lean forms P
    if (live) {
      qk_tile<HD, NQ>(s, qa, smem_addr(kt));
      softmax_tile<HD>(s, acc, m, l, qpos, j0, lim, window, scale, cap,
                       lane);
      if constexpr (HD <= 128) p_frags(s, pa);
    }
    cp_async_wait<2>();  // this tile's V
    fence_async_smem();
    __syncthreads();
    if (live) {
      if constexpr (HD <= 128)
        pv_tile<HD>(acc, pa, smem_addr(kt + TB));
      else
        pv_tile_lean<HD>(acc, s, smem_addr(kt + TB));
    }
    __syncthreads();  // the stage is free for tile t + 2
  }
  finish_rows<HD>(acc, l, m, orow, o, lse, lane);
}

// Launch flash_tile_kernel for q (B, Sq, H, hd) and bf16 K/V addressed by
// keys; returns a cudaError_t. lse: null, or (B, Sq, H) fp32 for each
// row's log-sum-exp (finish_rows). The shared-memory attribute is set once
// per instantiation (a function-local static), so a launch under
// CUDA-graph capture makes no other runtime call.
template <int HD, typename TQ, typename Keys>
int flash_tile_launch(const void* q, const void* k, const void* v, void* o,
                      const int* base, const int* total, const Keys& keys,
                      int B, int Sq, int H, int K, float scale, int window,
                      float cap, cudaStream_t stream,
                      float* lse = nullptr) {
  if ((reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v)) & 15)
    return (int)cudaErrorMisalignedAddress;
  constexpr int ROWS = rows<HD>();
  const int G = H / K, GC = G < ROWS ? G : ROWS;
  const int NHC = (G + GC - 1) / GC, BQ = ROWS / GC;
  auto kern = flash_tile_kernel<HD, TQ, Keys>;
  constexpr size_t smem =
      smem_bytes<HD, std::is_same<TQ, float>::value ? NP : 1>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, K * NHC, B);
  kern<<<grid, threads<HD>(), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<TQ*>(o), base, total,
      keys, Sq, H, K, GC, NHC, scale, window, cap, lse);
  return (int)cudaGetLastError();
}

}  // namespace ft
}  // namespace teola
