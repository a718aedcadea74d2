// RWKV-6 WKV recurrence, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:52
// rwkv6_scan (_kernel).
//
// For each (b, h), with the hd x hd fp32 state S (row j: key index, column
// i: value index) and t = 0 .. S_len-1:
//   y_t[i] = sum_j r_t[j] * S[j][i] + v_t[i] * sum_j r_t[j] * u[j] * k_t[j]
//   S[j][i] = w_t[j] * S[j][i] + k_t[j] * v_t[i]
// which is the reference's y_t = r_t . (S + diag(u) k_t v_t^T) with its
// bonus term, the same for every column, taken out of the sum: one dot
// product of hd terms per step. The state is read from state0 at the start
// and written to state_out at the end; the two may be the same buffer (the
// engine's cache, updated in place): each CTA reads its whole tile of the
// state before it writes any of it (a decode step: each thread its own
// elements), and no other CTA touches that tile.
//
// What bounds it on the H100: per (b, t, h) 5*hd^2 fp32 operations (k*v,
// then w*S + kv and r*S as multiply-adds; 7*hd^2 as chip_smoke.py's bound
// has counted them since the first port) against 4*hd input values and hd
// fp32 outputs, 16 operations per byte in fp32 against the card's 20, so a
// prefill is bound by its bytes and its arithmetic about equally; a decode
// step (S_len = 1) moves the state in and out (2 * B*H*hd^2 * 4 bytes, 2.6
// MB at batch 4 for RWKV-6 3B) and is bound by those bytes. In practice
// the time is the sequential dependence on t: the work that can run at
// once is B*H*hd columns, each a chain of S_len steps.
//
// Design: a column split. Value column i of the state evolves on its own,
// so one (b, h) is spread over hd / CW CTAs with no reduction across CTAs:
//  - Grid (hd / CW, H, B). Each thread holds R rows x CPT = 2 columns of
//    the state in registers for the whole scan: row group g = tid / (CW /
//    2) of the hd / R groups, columns c0 + 2 * (tid % (CW / 2)) and the
//    next. A step reads r, k, w of its R rows (shared by the lanes of its
//    group) and v of its 2 columns once for 2R state elements.
//  - Each step a thread adds its rows' share of sum_j r_t[j] S[j][i] for
//    its columns into shared memory; after the chunk the hd / R partials
//    of each (step, column) are summed, the bonus term added, and y
//    written as coalesced rows. No barrier and no shuffle inside a chunk's
//    steps; the loads of 4 steps are issued before their arithmetic.
//  - r, k, w (all hd rows) and v (the CTA's columns) of a chunk of TC steps
//    arrive by 16-byte cp.async in their storage type, double-buffered: the
//    next chunk's copies fly while this one computes, and a step never
//    waits on a global load. The bonus term of each step is a dot product
//    over hd shared by hd / 8 lanes, 8 terms each.
//  - The state tile (hd rows x CW columns) is loaded once and stored once,
//    through shared memory, as 16-byte accesses, lanes on neighbouring
//    columns; its space holds the partial sums in between.
//  - A prefill (S_len > 1) takes CW = 32, R = 8 (320 CTAs of 128 threads
//    at batch 4, H = 40, hd = 64; TC = 16): every CTA of a (b, h) stages
//    r, k, w whole, so wider CTAs make fewer copies. Sharing one copy among
//    a (b, h)'s CTAs through a thread block cluster's shared memory was
//    slower: the copy between the cluster's barrier and the steps overlaps
//    nothing.
//  - A decode step (S_len = 1) is a kernel of its own, rwkv6_decode_kernel,
//    so a profile shows the two apart. It is bound by latency, not by the
//    state's bytes: a decode step of one sequence moves 0.66 MB. So it
//    stages nothing: each thread loads its R = 4 rows x 2 columns of the
//    state and r, k, w, u of its rows, v of its columns, straight from
//    global memory, all at once; computes its columns' partial sums and
//    its rows' share of the bonus term; stores its state; and one barrier
//    later CW = 16 threads sum the hd / R partials of each column into y
//    (640 CTAs of 128 threads at batch 4, 160 at batch 1). The chunked
//    kernel at TC = 1 spent six barriers and two trips of the state
//    through shared memory on that one step.
//  - For training, the caller may pass `boundaries` (nchunks, B, H, hd,
//    hd): the chunked kernel then stores the state at the start of every
//    chunk of TC = 16 steps (chunk 0's is state0), from its registers,
//    whatever S_len (S_len = 1 included). The backward kernel
//    (rwkv6_scan_bwd.cu) recomputes each chunk's states from them.
#include "common.cuh"

namespace {

constexpr int CPT = 2;        // value columns per thread
constexpr int MIN_CTAS = 5;   // CTAs per SM the registers must allow
constexpr int TC_PREFILL = 16;  // steps per staged chunk when S_len > 1
constexpr int STEPS_U = 4;    // steps whose loads are issued together

// The prefill CTA's shape (see the header): CW columns, R rows x CPT
// columns of the state per thread; the decode step's
constexpr int CW_SCAN = 32, R_SCAN = 8;
constexpr int CW_DECODE = 16, R_DECODE = 4;
template <int HD, int CW, int R>
__host__ __device__ constexpr int threads() {
  return CW / CPT * (HD / R);
}

template <int HD, typename T, int TC>
struct alignas(16) Smem {
  static constexpr int CW = CW_SCAN, JS = HD / R_SCAN;
  T rkw[2][3][TC][HD];          // r, k, w of a chunk's steps (two chunks)
  T v[2][TC][CW];               // v of a chunk's steps, the CTA's columns
  union {
    float st[HD][CW];           // the state tile, on its way in and out
    float part[TC][JS][CW];     // row groups' partial sums of y
  } x;
  float bonus[TC];              // sum_j r_t[j] u[j] k_t[j], per step
};

// N consecutive values, 16-byte aligned (fp32) or 8-byte (bf16), as floats
template <int N>
__device__ __forceinline__ void ld_f(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = a.x;
    x[4 * i + 1] = a.y;
    x[4 * i + 2] = a.z;
    x[4 * i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void ld_f(const __nv_bfloat16* p,
                                        float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint2 a = reinterpret_cast<const uint2*>(p)[i];
    x[4 * i] = __uint_as_float(a.x << 16);
    x[4 * i + 1] = __uint_as_float(a.x & 0xffff0000u);
    x[4 * i + 2] = __uint_as_float(a.y << 16);
    x[4 * i + 3] = __uint_as_float(a.y & 0xffff0000u);
  }
}

// cp.async steps [t0, t0 + nt) of (b, h) into chunk buffer bi: r, k, w
// whole, v for columns [c0, c0 + CW)
template <int HD, typename T, int TC>
__device__ __forceinline__ void stage_chunk(Smem<HD, T, TC>& sm, int bi,
                                            const T* r, const T* k,
                                            const T* w, const T* v, int b,
                                            int h, int c0, int S, int H,
                                            int t0, int nt, int tid) {
  constexpr int NT = threads<HD, CW_SCAN, R_SCAN>(), CW = CW_SCAN;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = HD / EPC;         // copies per r, k or w row
  constexpr int VC = CW / EPC;         // copies per v row
  const size_t row0 = ((size_t)b * S + t0) * H + h;  // (b, t0, h)
  for (int idx = tid; idx < 3 * TC * RC; idx += NT) {
    const int a = idx / (TC * RC), t = idx / RC % TC, c = idx % RC;
    const T* src = a == 0 ? r : (a == 1 ? k : w);
    if (t < nt)
      teola::cp_async16(&sm.rkw[bi][a][t][c * EPC],
                        src + (row0 + (size_t)t * H) * HD + c * EPC, true);
  }
  for (int idx = tid; idx < TC * VC; idx += NT) {
    const int t = idx / VC, c = idx % VC;
    if (t < nt)
      teola::cp_async16(&sm.v[bi][t][c * EPC],
                        v + (row0 + (size_t)t * H) * HD + c0 + c * EPC, true);
  }
}

// U steps from t of a thread's R rows x CPT columns (state s): every load
// of the U steps first, then their arithmetic and their partial sums, so
// that no load waits behind an earlier step's store to shared memory
template <int U, int HD, typename T, int TC, int R>
__device__ __forceinline__ void steps(Smem<HD, T, TC>& sm, int bi, int t,
                                      int g, int c, float (&s)[R][CPT]) {
  float rr[U][R], kk[U][R], ww[U][R], vv[U][CPT];
#pragma unroll
  for (int e = 0; e < U; ++e) {
    ld_f(&sm.rkw[bi][0][t + e][g * R], rr[e]);
    ld_f(&sm.rkw[bi][1][t + e][g * R], kk[e]);
    ld_f(&sm.rkw[bi][2][t + e][g * R], ww[e]);
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      vv[e][q] = teola::to_f(sm.v[bi][t + e][c + q]);
  }
#pragma unroll
  for (int e = 0; e < U; ++e) {
    float acc[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        acc[q] = fmaf(rr[e][m], s[m][q], acc[q]);
        s[m][q] = fmaf(ww[e][m], s[m][q], kk[e][m] * vv[e][q]);
      }
#pragma unroll
    for (int q = 0; q < CPT; ++q) sm.x.part[t + e][g][c + q] = acc[q];
  }
}

template <int HD, typename T, int TC>
__global__ void __launch_bounds__(threads<HD, CW_SCAN, R_SCAN>(), MIN_CTAS)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  float* __restrict__ y, float* state_out,
                  float* __restrict__ boundaries, int S, int H) {
  constexpr int R = R_SCAN, JS = HD / R, CW = CW_SCAN;
  constexpr int NT = threads<HD, CW, R>();
  static_assert(R % 4 == 0 && HD % R == 0 && NT % 32 == 0, "CTA shape");
  constexpr int SC = CW / 4;  // 16-byte copies per state-tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, T, TC>& sm = *reinterpret_cast<Smem<HD, T, TC>*>(smem_raw);
  const int c0 = blockIdx.x * CW, h = blockIdx.y, b = blockIdx.z;
  constexpr int JP = HD / 8;  // lanes per step of the bonus dot product
  constexpr int CT = CW / CPT;  // column threads per row group
  const int tid = threadIdx.x, g = tid / CT, c = tid % CT * CPT;
  // element (0, c0) of this CTA's tile of the (b, h) state
  const size_t sbase = ((size_t)b * H + h) * HD * HD + c0;
  const int nchunks = (S + TC - 1) / TC;

  for (int idx = tid; idx < HD * SC; idx += NT) {
    const int j = idx / SC, q = idx % SC;
    teola::cp_async16(&sm.x.st[j][4 * q],
                      state0 + sbase + (size_t)j * HD + 4 * q, true);
  }
  stage_chunk(sm, 0, r, k, w, v, b, h, c0, S, H, 0, min(TC, S), tid);
  teola::cp_async_commit();
  if (nchunks > 1)
    stage_chunk(sm, 1, r, k, w, v, b, h, c0, S, H, TC, min(TC, S - TC),
                tid);
  teola::cp_async_commit();
  float uq[8];  // u at this thread's 8 rows of the bonus dot product
#pragma unroll
  for (int e = 0; e < 8; ++e) uq[e] = u[(size_t)h * HD + (tid % JP) * 8 + e];

  teola::cp_async_wait<1>();  // the state and chunk 0
  __syncthreads();
  float s[R][CPT];  // rows g*R + m of columns c0 + c + q
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < CPT; ++q) s[m][q] = sm.x.st[g * R + m][c + q];
  __syncthreads();  // the tile's space now takes the partial sums

  for (int n = 0; n < nchunks; ++n) {
    const int bi = n & 1, t0 = n * TC, nt = min(TC, S - t0);
    if (n > 0) {
      teola::cp_async_wait<1>();  // chunk n
      __syncthreads();
    }
    if (boundaries != nullptr) {  // the state before step t0 (training)
      float* bp = boundaries + (size_t)n * gridDim.z * H * HD * HD + sbase;
#pragma unroll
      for (int m = 0; m < R; ++m)
        *reinterpret_cast<float2*>(bp + (size_t)(g * R + m) * HD + c) =
            make_float2(s[m][0], s[m][1]);
    }
    // the bonus term of each step: JP neighbouring lanes per step, 8 rows
    // each (every thread takes each pass, so the shuffles see full warps)
    for (int t0p = 0; t0p < nt; t0p += NT / JP) {
      const int t = t0p + tid / JP;
      float p = 0.f;
      if (t < nt) {
        float rq[8], kq[8];
        ld_f(&sm.rkw[bi][0][t][(tid % JP) * 8], rq);
        ld_f(&sm.rkw[bi][1][t][(tid % JP) * 8], kq);
#pragma unroll
        for (int e = 0; e < 8; ++e) p += rq[e] * uq[e] * kq[e];
      }
#pragma unroll
      for (int off = JP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (t < nt && tid % JP == 0) sm.bonus[t] = p;
    }
    // the steps: this thread's R rows of its CPT columns, STEPS_U at once
    int t = 0;
    for (; t + STEPS_U <= nt; t += STEPS_U)
      steps<STEPS_U>(sm, bi, t, g, c, s);
    for (; t < nt; ++t) steps<1>(sm, bi, t, g, c, s);
    __syncthreads();
    // y: the JS partials of each (step, column), then the bonus term
    for (int idx = tid; idx < nt * CW; idx += NT) {
      const int t = idx / CW, cc = idx % CW;
      float acc = 0.f;
#pragma unroll
      for (int gg = 0; gg < JS; ++gg) acc += sm.x.part[t][gg][cc];
      acc += teola::to_f(sm.v[bi][t][cc]) * sm.bonus[t];
      y[(((size_t)b * S + t0 + t) * H + h) * HD + c0 + cc] = acc;
    }
    __syncthreads();  // buffer bi, the partials and the bonus are free
    if (n + 2 < nchunks)
      stage_chunk(sm, bi, r, k, w, v, b, h, c0, S, H, t0 + 2 * TC,
                  min(TC, S - t0 - 2 * TC), tid);
    teola::cp_async_commit();  // empty groups keep the count uniform
  }

#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int q = 0; q < CPT; ++q) sm.x.st[g * R + m][c + q] = s[m][q];
  __syncthreads();
  for (int idx = tid; idx < HD * SC; idx += NT) {
    const int j = idx / SC, q = idx % SC;
    *reinterpret_cast<float4*>(state_out + sbase + (size_t)j * HD + 4 * q) =
        *reinterpret_cast<const float4*>(&sm.x.st[j][4 * q]);
  }
}

// One step (S_len = 1) of each (b, h): see the header. Thread (g, c) owns
// rows g*R .. g*R+R-1 of columns c0 + c and c0 + c + 1.
template <int HD, typename T>
__global__ void __launch_bounds__(threads<HD, CW_DECODE, R_DECODE>())
rwkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, const float* state0,
                    float* __restrict__ y, float* state_out, int H) {
  constexpr int R = R_DECODE, CW = CW_DECODE, JS = HD / R, CT = CW / CPT;
  static_assert(R == 4 && CPT == 2, "one 4-value load per operand row");
  __shared__ float part[JS][CW];  // row groups' partial sums of y
  __shared__ float bon[JS];       // row groups' shares of the bonus term
  const int c0 = blockIdx.x * CW, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = tid / CT, c = tid % CT * CPT;
  const size_t x0 = ((size_t)b * H + h) * HD;  // (b, 0, h, 0) of r .. y
  const size_t s0 = x0 * HD + c0 + c;          // (b, h, 0, c0 + c)

  float2 s[R];
#pragma unroll
  for (int m = 0; m < R; ++m)
    s[m] = *reinterpret_cast<const float2*>(state0 + s0 +
                                            (size_t)(g * R + m) * HD);
  float rr[R], kk[R], ww[R], uu[R];
  ld_f(r + x0 + g * R, rr);
  ld_f(k + x0 + g * R, kk);
  ld_f(w + x0 + g * R, ww);
#pragma unroll
  for (int m = 0; m < R; ++m) uu[m] = u[(size_t)h * HD + g * R + m];
  const float v0 = teola::to_f(v[x0 + c0 + c]);
  const float v1 = teola::to_f(v[x0 + c0 + c + 1]);

  float a0 = 0.f, a1 = 0.f, bonus = 0.f;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    bonus += rr[m] * uu[m] * kk[m];
    a0 = fmaf(rr[m], s[m].x, a0);
    a1 = fmaf(rr[m], s[m].y, a1);
    s[m].x = fmaf(ww[m], s[m].x, kk[m] * v0);
    s[m].y = fmaf(ww[m], s[m].y, kk[m] * v1);
  }
  // every element of the state was read above by the thread that writes it
#pragma unroll
  for (int m = 0; m < R; ++m)
    *reinterpret_cast<float2*>(state_out + s0 + (size_t)(g * R + m) * HD) =
        s[m];
  part[g][c] = a0;
  part[g][c + 1] = a1;
  if (tid % CT == 0) bon[g] = bonus;
  __syncthreads();
  if (tid < CW) {
    float acc = 0.f, bsum = 0.f;
#pragma unroll
    for (int gg = 0; gg < JS; ++gg) {
      acc += part[gg][tid];
      bsum += bon[gg];
    }
    y[x0 + c0 + tid] = acc + teola::to_f(v[x0 + c0 + tid]) * bsum;
  }
}

template <int HD, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, float* y, float* state_out,
           float* boundaries, int B, int S, int H, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  if (S == 1 && boundaries == nullptr) {
    rwkv6_decode_kernel<HD, T>
        <<<dim3(HD / CW_DECODE, H, B), threads<HD, CW_DECODE, R_DECODE>(), 0,
           stream>>>(rt, kt, vt, wt, u, state0, y, state_out, H);
    return (int)cudaGetLastError();
  }
  // under 48 KB of shared memory: no attribute to set before a launch
  using Sm = Smem<HD, T, TC_PREFILL>;
  static_assert(sizeof(Sm) <= 48 * 1024, "shared memory");
  rwkv6_scan_kernel<HD, T, TC_PREFILL>
      <<<dim3(HD / CW_SCAN, H, B), threads<HD, CW_SCAN, R_SCAN>(),
         sizeof(Sm), stream>>>(rt, kt, vt, wt, u, state0, y, state_out,
                               boundaries, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B,S,H,hd) in one dtype (TEOLA_F32 | TEOLA_BF16); u (H,hd),
// state0 and state_out (B,H,hd,hd), y (B,S,H,hd), all float32 and
// contiguous; every pointer but u 16-byte aligned. state_out may alias
// state0. boundaries: null, or float32 (ceil(S / 16), B, H, hd, hd),
// 16-byte aligned, not aliasing the others. hd in {32, 64}; S >= 1.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const float* u,
                                 const float* state0, float* y,
                                 float* state_out, float* boundaries, int B,
                                 int S, int H, int hd, int dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t ptrs = reinterpret_cast<size_t>(r) |
                      reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) |
                      reinterpret_cast<size_t>(w) |
                      reinterpret_cast<size_t>(state0) |
                      reinterpret_cast<size_t>(state_out) |
                      reinterpret_cast<size_t>(boundaries);
  if (ptrs & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32 && dtype == TEOLA_F32)
    return launch<32, float>(r, k, v, w, u, state0, y, state_out, boundaries,
                             B, S, H, st);
  if (hd == 32 && dtype == TEOLA_BF16)
    return launch<32, __nv_bfloat16>(r, k, v, w, u, state0, y, state_out,
                                     boundaries, B, S, H, st);
  if (hd == 64 && dtype == TEOLA_F32)
    return launch<64, float>(r, k, v, w, u, state0, y, state_out, boundaries,
                             B, S, H, st);
  if (hd == 64 && dtype == TEOLA_BF16)
    return launch<64, __nv_bfloat16>(r, k, v, w, u, state0, y, state_out,
                                     boundaries, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}
