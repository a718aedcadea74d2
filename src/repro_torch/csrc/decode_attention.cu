// Batched GQA decode attention over a dense KV cache, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:107 decode_attention (_kernel,
// _flash_block).
//
// One new query per sequence and head attends to the first length[b]
// slots of its cache (window: only slots >= length[b] - window).
//
// Design: split-KV (flash-decoding), the Sq = 1 instance of split_kv.cuh
// with dense addressing (key j of sequence b is row (b*T + j)*K + kvh).
// A CTA holds the G = H / K query heads of one (kv head, sequence) over
// one 64-key chunk, so each K/V row is read once for all G heads; a
// combine pass merges the chunks' (m, l, acc) partials. One C call
// launches both passes.
//
// What bounds it on the H100: bytes, at about 2*G flops per byte of K/V
// (16 at TinyLlama's G = 8), far under the ridge; no tensor cores (fp32
// q, as the reference computes). At serve sizes the limit is latency,
// which the split addresses: ceil(T / 64) * K * B CTAs (128 at batch 4
// over 512 slots, against 16 for a CTA per (kv head, sequence)), with K
// and V copied by cp.async while Q is staged. See split_kv.cuh.
#include "split_kv.cuh"

// q (B,H,hd), k/v (B,T,K,hd), o (B,H,hd), all contiguous; length (B,)
// int32 on the device; ws: ws_floats fp32 scratch on the device
// (split_kv_workspace(B, K, T, H/K, hd) of them). window <= 0: none;
// cap <= 0: none. lse: null, or (B,H) fp32 on the device for each row's
// log-sum-exp of its scores (-inf, with o = 0, at length 0: a rank's slice
// of a sequence-split cache that holds none of the sequence's keys).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int* length, float* ws,
                                       long long ws_floats, int B, int H,
                                       int K, int T, int hd, int q_dtype,
                                       int kv_dtype, float scale, int window,
                                       float cap, float* lse, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || T <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, teola::split_kv_launch, q, k, v, o,
                 length, teola::DenseKeys{T}, T, ws, ws_floats, B, 1, H, K,
                 scale, window, cap, static_cast<cudaStream_t>(stream), lse);
}
