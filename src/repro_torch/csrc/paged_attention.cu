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
// Both are the paged instance of split_kv.cuh (split-KV, flash-decoding).
// A CTA holds all R = Sq * G query rows of one (kv head, sequence) in the
// reference's (K, Sq*G) row layout over one 64-key chunk, looking each
// key's physical row up through the table; a combine pass merges the
// chunks. K4 is K3 at Sq = 1 (R = G rows), under its own addressing type
// (PagedDecodeKeys) so that the two keep separate instantiations and
// separate kernel names in a profile.
//
// What bounds them on the H100: bytes, at about Sq*G flops per byte of K/V
// (8 for decode and 32 for a k=3 verify chunk at TinyLlama's G = 8), under
// the ridge; fp32 q, no tensor cores. At decode sizes the limit is
// latency: the split gives ceil(maxblk*bs / 64) * K * B CTAs (128 at batch
// 4 over 512 keys, against 16 for a CTA per (kv head, sequence)). Only
// rows of visible keys are copied, so out-of-table positions and the
// shared pad block are never read by a real row.
#include "split_kv.cuh"

// q/o (B,H,hd), pools (nb,bs,K,hd), tables (B,maxblk) int32, length (B,)
// int32, all contiguous on the device; ws: ws_floats fp32 scratch on the
// device (split_kv_workspace(B, K, maxblk*bs, H/K, hd) of them). window
// <= 0: none; cap <= 0: none.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, void* o, const int* tables,
                                   const int* length, float* ws,
                                   long long ws_floats, int B, int H, int K,
                                   int bs, int maxblk, int hd, int q_dtype,
                                   int kv_dtype, float scale, int window,
                                   float cap, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || bs <= 0 || maxblk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TEOLA_DISPATCH(hd, q_dtype, kv_dtype, teola::split_kv_launch, q, kp, vp, o,
                 length, (teola::PagedDecodeKeys{{tables, bs, maxblk}}),
                 maxblk * bs, ws, ws_floats, B, 1, H, K, scale, window, cap,
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
