// Shared helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace teola {

// Masked-score sentinel of the reference kernels (finite, so that
// exp(NEG_INF - NEG_INF) = 1 and exp(NEG_INF - m) = 0 as in Pallas).
constexpr float NEG_INF = -2.0e38f;
// The log-sum-exp of a row that sees no key: -inf (a true infinity, not
// the sentinel), so that its weight exp(lse - lse_total) in a merge is 0.
#define NEG_INF_LSE (__uint_as_float(0xff800000u))

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Scale, optional tanh softcap (cap <= 0: none), in the reference's order.
__device__ __forceinline__ float score(float dot, float scale, float cap) {
  float s = dot * scale;
  if (cap > 0.f) s = cap * tanhf(s / cap);
  return s;
}

}  // namespace teola

// Dtype codes shared with the Python wrappers (repro_torch/kernels/build.py).
#define TEOLA_F32 0
#define TEOLA_BF16 1

// Instantiate LAUNCH<HD, TQ, TKV>(...) for hd in {64, 128, 256}, q in
// {float32, bfloat16}, k/v in {float32, bfloat16}; unsupported
// combinations return cudaErrorInvalidValue.
#define TEOLA_DISPATCH_TYPES(HD, qd, kvd, LAUNCH, ...)                      \
  do {                                                                      \
    if (qd == TEOLA_F32 && kvd == TEOLA_BF16)                               \
      return LAUNCH<HD, float, __nv_bfloat16>(__VA_ARGS__);                 \
    if (qd == TEOLA_BF16 && kvd == TEOLA_BF16)                              \
      return LAUNCH<HD, __nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);         \
    if (qd == TEOLA_F32 && kvd == TEOLA_F32)                                \
      return LAUNCH<HD, float, float>(__VA_ARGS__);                         \
    if (qd == TEOLA_BF16 && kvd == TEOLA_F32)                               \
      return LAUNCH<HD, __nv_bfloat16, float>(__VA_ARGS__);                 \
  } while (0)
#define TEOLA_DISPATCH(hd, qd, kvd, LAUNCH, ...)                            \
  do {                                                                      \
    if (hd == 64)                                                           \
      TEOLA_DISPATCH_TYPES(64, qd, kvd, LAUNCH, __VA_ARGS__);               \
    else if (hd == 128)                                                     \
      TEOLA_DISPATCH_TYPES(128, qd, kvd, LAUNCH, __VA_ARGS__);              \
    else if (hd == 256)                                                     \
      TEOLA_DISPATCH_TYPES(256, qd, kvd, LAUNCH, __VA_ARGS__);              \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace teola {

// 16-byte asynchronous copy global -> shared (cp.async, sm_80+); with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where key j of sequence b, kv head kvh, lives: row(...) * hd is the
// element offset of its K (and V) row. The split-KV template
// (split_kv.cuh) and the flash tile kernel (flash_tile.cuh) take one of
// these as their addressing policy.

// Dense cache (B, T, K, hd): key j of sequence b is row (b*T + j)*K + kvh.
struct DenseKeys {
  int T;
  __device__ __forceinline__ int span() const { return T; }
  __device__ __forceinline__ long long row(int b, int j, int kvh,
                                           int K) const {
    return ((long long)b * T + j) * K + kvh;
  }
};

// Paged pool (nb, bs, K, hd) read through tables (B, maxblk): key j of
// sequence b is row (table[b, j / bs]*bs + j % bs)*K + kvh.
struct PagedKeys {
  const int* tables;
  int bs, maxblk;
  __device__ __forceinline__ int span() const { return maxblk * bs; }
  __device__ __forceinline__ long long row(int b, int j, int kvh,
                                           int K) const {
    const int phys = tables[(size_t)b * maxblk + j / bs];
    return ((long long)phys * bs + j % bs) * K + kvh;
  }
};

// K4's paged addressing: PagedKeys under a name of its own, so that its
// instantiations (and the profiler's kernel names) stay apart from K3's.
struct PagedDecodeKeys : PagedKeys {};

// K5's paged addressing for the flash tile core (flash_tile.cuh), under a
// name of its own for the same reason.
struct ChunkPagedKeys : PagedKeys {};

}  // namespace teola
