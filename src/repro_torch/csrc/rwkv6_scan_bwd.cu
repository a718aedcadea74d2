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
// bound it about equally (0.035 ms of operations at batch 2, S 512, 40
// heads). Nothing in it is a chain: each element (j, i) of S and of dS
// follows its own scalar recurrence, two fmaf per step each way, and the
// sums over i (dr, dk, dw) and over j (dv) only read S_{t-1} and dS_t.
// So about 8 fp32 instructions per element and step are needed, and what
// the design adds on top of them (loads, the partial sums' trips through
// shared memory, their reduction, the recompute, the barriers) is what it
// has to keep small. On an H100 SXM at 700 W (chip_smoke.py --timing) it
// takes about 7x its bound at batch 2, and at batch 1, with about one CTA
// per SM, within a fifth of that: what bounds it is one CTA's serial path
// (the steps, then each sub-chunk's reduction and barriers and the
// recompute), not the card's issue rate.
//
// Design: a row split across a thread block cluster.
//  - Grid (hd / RB, H, B), one cluster of NS = hd / RB CTAs per (b, h):
//    CTA `rank` owns rows rank*RB .. rank*RB + RB - 1 (RB = 16) of the
//    state and of dS, every column (320 CTAs of 128 threads at batch 2,
//    H = 40, hd = 64; three fit on an SM). A row split keeps the three row
//    sums (dr, dk, dw), du and v_t . dy_t inside the CTA; only dv, a sum
//    over rows, crosses CTAs. A CTA stages r, k, w of its own rows only.
//  - Thread (rg, cg) holds R = 2 rows x C = 4 columns of dS in registers
//    for the whole walk (rows rg*2, rg*2+1 of the CTA's, columns cg*4 ..
//    cg*4+3): a step reads r, k, w of its 2 rows and v, dy of its 4
//    columns once for 8 elements.
//  - No barrier and no shuffle inside a step. Each step a thread writes
//    its partial sums, dr, dk, dw of its 2 rows over its 4 columns and dv
//    of its 4 columns over its 2 rows, to shared memory; after each
//    sub-chunk of U = 8 steps all threads add the NCG = hd / 4 partials
//    of every (step, row) and the RG = 8 of every (step, column) in one
//    pass, in a fixed order, and add the bonus terms there.
//  - The CTA's dv sums go to an exchange buffer that the cluster reads
//    through distributed shared memory once per chunk of 16 steps: CTA
//    `rank` sums the NS CTAs' values of its hd / NS columns in rank order.
//    A CTA arrives at the cluster barrier once the chunk's exchange is
//    written and waits only after its last row sums and du, so they
//    overlap the barrier; the exchange is double-buffered, so one barrier
//    per chunk suffices (one per sub-chunk was slower).
//    Every sum has a fixed order and nothing is atomic: a call is
//    deterministic, and a CUDA graph replays it bit for bit.
//  - Recompute: a sub-chunk's 8 states live in each thread's registers
//    (64 values), recomputed from the chunk's boundary: the later
//    sub-chunk first (15 steps forward), then the earlier (7 more), 22 per
//    16 steps. The boundary itself is loaded into registers one chunk
//    ahead.
//  - A chunk's r, k, w (this CTA's rows, storage type), v (storage type)
//    and dy (fp32) arrive by 16-byte cp.async, double-buffered: the next
//    chunk's copies fly while this one computes. v_t . dy_t and the CTA's
//    share of the bonus sum of each step are taken once per chunk (hd / 8
//    lanes per step), between the chunk's barrier and its steps.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TC = 16;   // steps per saved state: rwkv6_scan.cu's TC_PREFILL
constexpr int U = 8;     // steps per sub-chunk whose states a thread keeps
constexpr int RB = 16;   // state rows per CTA
constexpr int R = 2;     // state rows per thread
constexpr int C = 4;     // state columns per thread
constexpr int RG = RB / R;  // row groups per CTA
constexpr int MIN_CTAS = 3;  // CTAs per SM the registers must allow
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int NS = HD / RB;   // CTAs per (b, h): the cluster
  static constexpr int NCG = HD / C;   // column groups
  static constexpr int NT = RG * NCG;  // threads per CTA
  static constexpr int LPS = NT / TC;  // lanes per step of a chunk's dots
  static constexpr int CF = HD / NS;   // dv columns each CTA finishes
  // row partials of one (step, sum): [column group][row], rows padded so
  // that a warp's 8-byte stores of two rows hit distinct banks; planes
  // 16 words apart modulo 32, so that two planes' reads do too
  static constexpr int RBP = RB + 2;
  static constexpr int PP = NCG * RBP + (48 - NCG * RBP % 32) % 32;
  static_assert(NS >= 2 && NT % 32 == 0 && 32 % LPS == 0 &&
                    HD % LPS == 0 && RB % LPS == 0,
                "CTA shape");
};

template <int HD, typename T>
struct alignas(16) Stage {
  T rkw[3][TC][RB];  // r, k, w of a chunk's steps, this CTA's rows
  T v[TC][HD];       // v of a chunk's steps, every column
  float dy[TC][HD];
};

template <int HD, typename T>
struct alignas(16) Smem {
  using Sh = Shape<HD>;
  Stage<HD, T> st[2];
  float prow[U * 3][Sh::PP];  // (step, dr | dk | dw) partials over columns
  float pcol[U][RG][HD];      // dv partials over rows, per row group
  float xv[2][TC][HD];        // this CTA's dv sums over its rows (exchange)
  float xb[2][TC];            // this CTA's share of each bonus sum
  float vdy[TC];              // v_t . dy_t
  float bonp[TC];             // sum over this CTA's rows of r_t u k_t
  float u[RB];
};

// two (R) or four (C) consecutive values as floats, 8- or 16-byte aligned
__device__ __forceinline__ void ld2(const float* p, float (&x)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  x[0] = a.x;
  x[1] = a.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float (&x)[2]) {
  const unsigned a = *reinterpret_cast<const unsigned*>(p);
  x[0] = __uint_as_float(a << 16);
  x[1] = __uint_as_float(a & 0xffff0000u);
}
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(a.x << 16);
  x[1] = __uint_as_float(a.x & 0xffff0000u);
  x[2] = __uint_as_float(a.y << 16);
  x[3] = __uint_as_float(a.y & 0xffff0000u);
}

// cp.async steps [t0, t0 + nt) of (b, h), row0 = (b*S + t0)*H + h: r, k,
// w of rows [r0, r0 + RB), v and dy whole
template <int HD, typename T>
__device__ __forceinline__ void stage(Stage<HD, T>& st, const T* r,
                                      const T* k, const T* w, const T* v,
                                      const float* dy, size_t row0, int H,
                                      int r0, int nt, int tid) {
  constexpr int NT = Shape<HD>::NT;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = RB / EPC;         // copies per r, k or w row
  constexpr int VC = HD / EPC;         // copies per v row
  constexpr int DC = HD / 4;           // copies per dy row
  for (int idx = tid; idx < 3 * TC * RC; idx += NT) {
    const int a = idx / (TC * RC), t = idx / RC % TC, c = idx % RC;
    const T* src = a == 0 ? r : (a == 1 ? k : w);
    if (t < nt)
      teola::cp_async16(&st.rkw[a][t][c * EPC],
                        src + (row0 + (size_t)t * H) * HD + r0 + c * EPC,
                        true);
  }
  for (int idx = tid; idx < TC * VC; idx += NT) {
    const int t = idx / VC, c = idx % VC;
    if (t < nt)
      teola::cp_async16(&st.v[t][c * EPC],
                        v + (row0 + (size_t)t * H) * HD + c * EPC, true);
  }
  for (int idx = tid; idx < TC * DC; idx += NT) {
    const int t = idx / DC, c = idx % DC;
    if (t < nt)
      teola::cp_async16(&st.dy[t][c * 4],
                        dy + (row0 + (size_t)t * H) * HD + c * 4, true);
  }
}

// One forward step of a thread's elements: the forward kernel's arithmetic
template <int HD, typename T>
__device__ __forceinline__ void fwd_step(const Stage<HD, T>& st, int t,
                                         int rg, int cgi,
                                         float (&s)[R][C]) {
  float kk[R], ww[R], vv[C];
  ld2(&st.rkw[1][t][rg * R], kk);
  ld2(&st.rkw[2][t][rg * R], ww);
  ld4(&st.v[t][cgi * C], vv);
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < C; ++q)
      s[m][q] = fmaf(ww[m], s[m][q], kk[m] * vv[q]);
}

// The operands of one step: r, k, w of a thread's rows, v, dy of its
// columns
struct Ops {
  float r[R], k[R], w[R], v[C], dy[C];
};
template <int HD, typename T>
__device__ __forceinline__ void load_ops(const Stage<HD, T>& st, int t,
                                         int rg, int cgi, Ops& o) {
  ld2(&st.rkw[0][t][rg * R], o.r);
  ld2(&st.rkw[1][t][rg * R], o.k);
  ld2(&st.rkw[2][t][rg * R], o.w);
  ld4(&st.v[t][cgi * C], o.v);
  ld4(&st.dy[t][cgi * C], o.dy);
}

// One backward step (slot e of the sub-chunk) of a thread's elements, sp
// = S_{t-1}: its partial sums to shared memory, dS_t -> dS_{t-1}
template <int HD, typename T>
__device__ __forceinline__ void bwd_step(Smem<HD, T>& sm, const Ops& o,
                                         int e, int rg, int cgi,
                                         const float (&sp)[R][C],
                                         float (&ds)[R][C]) {
  using Sh = Shape<HD>;
  float pr[R], pk[R], pw[R], pv[C];
#pragma unroll
  for (int m = 0; m < R; ++m) pr[m] = pk[m] = pw[m] = 0.f;
#pragma unroll
  for (int q = 0; q < C; ++q) pv[q] = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < C; ++q) {
      pr[m] = fmaf(sp[m][q], o.dy[q], pr[m]);
      pk[m] = fmaf(ds[m][q], o.v[q], pk[m]);
      pw[m] = fmaf(ds[m][q], sp[m][q], pw[m]);
      pv[q] = fmaf(ds[m][q], o.k[m], pv[q]);
      ds[m][q] = fmaf(o.w[m], ds[m][q], o.r[m] * o.dy[q]);
    }
  float* pl = &sm.prow[e * 3][cgi * Sh::RBP + rg * R];
  *reinterpret_cast<float2*>(pl) = make_float2(pr[0], pr[1]);
  *reinterpret_cast<float2*>(pl + Sh::PP) = make_float2(pk[0], pk[1]);
  *reinterpret_cast<float2*>(pl + 2 * Sh::PP) = make_float2(pw[0], pw[1]);
  *reinterpret_cast<float4*>(&sm.pcol[e][rg][cgi * C]) =
      make_float4(pv[0], pv[1], pv[2], pv[3]);
}

// The cluster barrier in its two halves: a thread arrives once what it
// wrote for the cluster is written, and waits before it reads what the
// others wrote; in between it does work of its own.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int HD, typename T>
__global__ void __launch_bounds__(Shape<HD>::NT, MIN_CTAS)
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
  constexpr int NS = Sh::NS, NCG = Sh::NCG, NT = Sh::NT, LPS = Sh::LPS;
  constexpr int CF = Sh::CF, RBP = Sh::RBP;
  static_assert(R == 2 && C == 4, "ld2 / ld4 and the float2 stores");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, T>& sm = *reinterpret_cast<Smem<HD, T>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // blockIdx.x
  const int h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int r0 = rank * RB;
  const int tid = threadIdx.x, rg = tid / NCG, cgi = tid % NCG;
  // element (r0 + rg*R + m, cgi*C + q) of the (b, h) state is at
  // sbase + m*HD + q
  const size_t sbase =
      (((size_t)b * H + h) * HD + r0 + rg * R) * HD + cgi * C;
  const size_t chunk_stride = (size_t)B * H * HD * HD;
  const int nch = (S + TC - 1) / TC;
  if (tid < RB) sm.u[tid] = u[(size_t)h * HD + r0 + tid];

  float ds[R][C];  // dS at this thread's elements
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (dstate == nullptr) {
#pragma unroll
      for (int q = 0; q < C; ++q) ds[m][q] = 0.f;
    } else {
      ld4(dstate + sbase + (size_t)m * HD, ds[m]);
    }
  }
  float bn[R][C];  // the next chunk's boundary, loaded one chunk ahead
#pragma unroll
  for (int m = 0; m < R; ++m)
    ld4(boundaries + (size_t)(nch - 1) * chunk_stride + sbase +
            (size_t)m * HD, bn[m]);

  const size_t rowb = (size_t)b * S * H + h;  // (b, 0, h)
  stage(sm.st[0], r, k, w, v, dy, rowb + (size_t)(nch - 1) * TC * H, H, r0,
        S - (nch - 1) * TC, tid);
  teola::cp_async_commit();
  if (nch > 1)
    stage(sm.st[1], r, k, w, v, dy, rowb + (size_t)(nch - 2) * TC * H, H,
          r0, TC, tid);
  teola::cp_async_commit();

  float du_acc = 0.f;  // thread tid < RB: du[r0 + tid] over this (b, h)
  int par = 0;         // exchange buffer of this chunk
  for (int i = 0; i < nch; ++i) {
    const int n = nch - 1 - i, t0 = n * TC, nt = min(TC, S - t0);
    const Stage<HD, T>& st = sm.st[i & 1];
    teola::cp_async_wait<1>();  // chunk n
    __syncthreads();
    float p0[R][C];  // the state before step t0
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int q = 0; q < C; ++q) p0[m][q] = bn[m][q];
    if (n > 0)
#pragma unroll
      for (int m = 0; m < R; ++m)
        ld4(boundaries + (size_t)(n - 1) * chunk_stride + sbase +
                (size_t)m * HD, bn[m]);
    {  // v_t . dy_t and this CTA's share of the bonus sum, LPS lanes per
       // step; read after the first sub-chunk's barrier
      constexpr int VP = HD / LPS, BP = RB / LPS;
      const int t = tid / LPS, l = tid % LPS;
      float a = 0.f, bs = 0.f;
#pragma unroll
      for (int x = 0; x < VP; ++x)
        a = fmaf(teola::to_f(st.v[t][l * VP + x]), st.dy[t][l * VP + x], a);
#pragma unroll
      for (int x = 0; x < BP; ++x) {
        const int j = l * BP + x;
        bs = fmaf(teola::to_f(st.rkw[0][t][j]) * sm.u[j],
                  teola::to_f(st.rkw[1][t][j]), bs);
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        bs += __shfl_xor_sync(FULL, bs, off);
      }
      if (l == 0 && t < nt) {
        sm.vdy[t] = a;
        sm.bonp[t] = bs;
      }
    }

    for (int a0 = (nt - 1) / U * U; a0 >= 0; a0 -= U) {
      float s[R][C];
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int q = 0; q < C; ++q) s[m][q] = p0[m][q];
      for (int t = 0; t < a0; ++t) fwd_step(st, t, rg, cgi, s);
      float hist[U][R][C];  // S_{a0 + e - 1}: the state before step a0 + e
#pragma unroll
      for (int e = 0; e < U; ++e) {
#pragma unroll
        for (int m = 0; m < R; ++m)
#pragma unroll
          for (int q = 0; q < C; ++q) hist[e][m][q] = s[m][q];
        if (e + 1 < U && a0 + e + 1 < nt) fwd_step(st, a0 + e, rg, cgi, s);
      }
      __syncthreads();  // the previous sub-chunk's row sums are read
      // the steps backwards, each step's operands loaded before the
      // previous step's stores (a0 + U - 1 < TC: any slot may be read)
      Ops nx;
      load_ops(st, a0 + U - 1, rg, cgi, nx);
#pragma unroll
      for (int e = U - 1; e >= 0; --e) {
        const Ops cur = nx;
        if (e > 0) load_ops(st, a0 + e - 1, rg, cgi, nx);
        if (a0 + e < nt) bwd_step(sm, cur, e, rg, cgi, hist[e], ds);
      }
      __syncthreads();
      // this CTA's dv sums over its rows: RG partials each, to the exchange
      for (int g = tid; g < U * (HD / 4); g += NT) {
        const int e = g / (HD / 4), c = g % (HD / 4) * 4;
        if (a0 + e >= nt) continue;
        float4 acc = *reinterpret_cast<const float4*>(&sm.pcol[e][0][c]);
#pragma unroll
        for (int x = 1; x < RG; ++x) {
          const float4 p =
              *reinterpret_cast<const float4*>(&sm.pcol[e][x][c]);
          acc.x += p.x;
          acc.y += p.y;
          acc.z += p.z;
          acc.w += p.w;
        }
        *reinterpret_cast<float4*>(&sm.xv[par][a0 + e][c]) = acc;
      }
      if (tid < U && a0 + tid < nt) sm.xb[par][a0 + tid] = sm.bonp[a0 + tid];
      // after the chunk's last sub-chunk this CTA's exchange is written:
      // the row sums below and du overlap the wait for the other CTAs'
      if (a0 == 0) cluster_arrive();
      // dr, dk, dw of the sub-chunk's steps: NCG partials each, then the
      // bonus terms
      for (int o = tid; o < U * 3 * RB; o += NT) {
        const int e = o / (3 * RB), q = o / RB % 3, j = o % RB, t = a0 + e;
        if (t >= nt) continue;
        const float* p = &sm.prow[e * 3 + q][j];
        float acc = p[0];
#pragma unroll
        for (int c = 1; c < NCG; ++c) acc += p[c * RBP];
        const size_t og = (((size_t)b * S + t0 + t) * H + h) * HD + r0 + j;
        if (q == 0)
          dr[og] = acc + sm.u[j] * teola::to_f(st.rkw[1][t][j]) * sm.vdy[t];
        else if (q == 1)
          dk[og] = acc + teola::to_f(st.rkw[0][t][j]) * sm.u[j] * sm.vdy[t];
        else
          dw[og] = acc;
      }
    }
    if (tid < RB)
      for (int t = 0; t < nt; ++t)
        du_acc += teola::to_f(st.rkw[0][t][tid]) *
                  teola::to_f(st.rkw[1][t][tid]) * sm.vdy[t];
    cluster_wait();
    // dv of the chunk's steps at this CTA's CF columns: the NS CTAs' sums
    // in rank order, then the bonus term
    for (int o = tid; o < TC * CF; o += NT) {
      const int t = o / CF, col = rank * CF + o % CF;
      if (t >= nt) continue;
      float* xv = &sm.xv[par][t][col];
      float* xb = &sm.xb[par][t];
      float acc = *cluster.map_shared_rank(xv, 0);
      float bon = *cluster.map_shared_rank(xb, 0);
#pragma unroll
      for (int c = 1; c < NS; ++c) {
        acc += *cluster.map_shared_rank(xv, c);
        bon += *cluster.map_shared_rank(xb, c);
      }
      dv[(((size_t)b * S + t0 + t) * H + h) * HD + col] =
          acc + bon * st.dy[t][col];
    }
    par ^= 1;
    __syncthreads();  // this chunk's buffer is free
    if (i + 2 < nch)
      stage(sm.st[i & 1], r, k, w, v, dy, rowb + (size_t)(n - 2) * TC * H,
            H, r0, TC, tid);
    teola::cp_async_commit();  // empty groups keep the count uniform
  }
  cluster_arrive();  // no CTA leaves while the cluster reads its exchange
  cluster_wait();
#pragma unroll
  for (int m = 0; m < R; ++m)
    *reinterpret_cast<float4*>(dstate0 + sbase + (size_t)m * HD) =
        make_float4(ds[m][0], ds[m][1], ds[m][2], ds[m][3]);
  if (tid < RB) du[((size_t)b * H + h) * HD + r0 + tid] = du_acc;
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* boundaries, const float* dy,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, int B, int S, int H,
           cudaStream_t stream) {
  using Sh = Shape<HD>;
  auto kern = rwkv6_scan_bwd_kernel<HD, T>;
  // once per instantiation, so that no attribute call falls inside a
  // CUDA-graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<HD, T>));
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = Sh::NS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Sh::NS, H, B);
  cfg.blockDim = dim3(Sh::NT);
  cfg.dynamicSmemBytes = sizeof(Smem<HD, T>);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, boundaries, dy,
      dstate, dr, dk, dv, dw, du, dstate0, S, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B,S,H,hd) in one dtype (TEOLA_F32 | TEOLA_BF16); u (H,hd);
// boundaries (ceil(S / 16), B, H, hd, hd) as rwkv6_scan_launch stores
// them; dy (B,S,H,hd); dstate (B,H,hd,hd) or null (no gradient of the
// final state); outputs dr, dk, dv, dw (B,S,H,hd), du (B,H,hd) per
// sequence, dstate0 (B,H,hd,hd). All float32 but r, k, v, w, all
// contiguous, none aliasing another; r, k, v, w, dy, boundaries, dstate
// and dstate0 16-byte aligned. hd in {32, 64}; S >= 1.
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
                      reinterpret_cast<size_t>(dy) |
                      reinterpret_cast<size_t>(boundaries) |
                      reinterpret_cast<size_t>(dstate) |
                      reinterpret_cast<size_t>(dstate0);
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
