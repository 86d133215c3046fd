// Serving kernels of the PyTorch port, for Hopper (sm_90a).
//
// Five kernels carry the steps of the continuous-batching engine:
//   kv_chunk_write          chunked prefill: quantize + store a chunk's K/V
//   paged_prefill           chunked prefill: the chunk attends to its cache
//   kv_append               decode: quantize + store one K/V row per slot
//   paged_decode            decode: one query token per slot attends to its
//                           pages
//   paged_multitoken_decode speculative decode: gamma draft tokens per slot,
//                           each up to its own position (the same kernel)
//
// Sequence sharding (context-parallel serving, the JAX package's
// serving/seq_sharded_decode.py): a shard's cache holds every
// page_stride-th global page of a sequence starting at page_offset, global
// page g at local logical page (g - offset) / stride.  kv_chunk_write skips
// the rows of other shards' pages; the attention kernels
// take key positions from the global page (lp * stride + offset) and
// optionally write each row's online-softmax l and m (base 2), which the
// host merges across shards.  Stride 1, offset 0, no global lengths and no
// l/m is the single-shard kernel.
//
// Layouts are the JAX package's (serving/kv_cache.py); pack = tokens per
// stored row, 2 for int4, else 1; page_rows = page_size / pack:
//   pages   (n_kv, n_pages, page_rows, d_store)  int8 | fp8 | int4 pairs |
//                                                float | bf16
//   scales  (n_kv, n_pages, pack, page_rows)      float (quantized only)
//   tables  (max_seqs, max_pages) int32, lengths (max_seqs) int32
// int4 byte row r holds token 2r in its low nibble and token 2r+1 in its
// high nibble; scale sublane 0 the even tokens', sublane 1 the odd ones'.
//
// Each extern "C" entry launches one kernel on the caller's stream,
// allocates nothing, and returns cudaGetLastError().  Activations are float
// or bf16; the cache payload is int8, fp8 (e4m3, e5m2) or int4 (quantized,
// one float scale per token) or the activations' type.  The attention
// kernels round q and p to the "compute type" before the two products, as
// the reference kernels do: bf16 for a quantized cache (every payload value
// is exact in bf16), else the payload type.  Built without --use_fast_math:
// the quantizer's division, round-half-to-even and fp8 rounding must match
// the reference bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kF16 = 3, kE4M3 = 4, kE5M2 = 5, kI4 = 6 };

// one-byte payloads besides int8: fp8 bit patterns, and int4 pairs (one
// byte of a byte row: the nibbles of two tokens' same feature)
struct fp8e4m3 { uint8_t x; };
struct fp8e5m2 { uint8_t x; };
struct int4x2 { int8_t x; };

// per payload: tokens per stored row, whether it carries scales, and the
// value the largest magnitude of a token maps to (kv_cache.py:126-135)
template <typename P> struct Payload {
  static constexpr int kPack = 1;
  static constexpr bool kQuant = false;
};
template <> struct Payload<int8_t> {
  static constexpr int kPack = 1;
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 127.f;
};
template <> struct Payload<fp8e4m3> {
  static constexpr int kPack = 1;
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 448.f;
};
template <> struct Payload<fp8e5m2> {
  static constexpr int kPack = 1;
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 57344.f;
};
template <> struct Payload<int4x2> {
  static constexpr int kPack = 2;
  static constexpr bool kQuant = true;
  static constexpr float kQmax = 7.f;
};

__device__ __forceinline__ float neg_inf() {
  // the 0xFA byte pattern: a finite "-inf", so exp2(s - m) is 0, never NaN
  return __int_as_float(static_cast<int>(0xFAFAFAFAu));
}

// fp8 -> half is exact (both fp8 formats are subsets of fp16), half -> float
__device__ __forceinline__ float fp8_to_f(uint8_t x, __nv_fp8_interpretation_t kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, kind)));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(fp8e4m3 x) { return fp8_to_f(x.x, __NV_E4M3); }
__device__ __forceinline__ float to_f(fp8e5m2 x) { return fp8_to_f(x.x, __NV_E5M2); }

// the nibble of int4 byte b that holds token t's value, sign-extended with
// shifts as kv_cache.py:171-177 does: the low nibble for even t
__device__ __forceinline__ int nibble(int b, int t) {
  const int shift = (t & 1) ? 24 : 28;
  return static_cast<int>(static_cast<uint32_t>(b) << shift) >> 28;
}

// token t's value of feature j in a stored page (or stage) of rows of D
template <typename P>
__device__ __forceinline__ float tok_val(const P* page, int t, int D, int j) {
  return to_f(page[static_cast<size_t>(t) * D + j]);
}
template <>
__device__ __forceinline__ float tok_val<int4x2>(const int4x2* page, int t, int D, int j) {
  return static_cast<float>(nibble(page[static_cast<size_t>(t >> 1) * D + j].x, t));
}

// index of token t's scale in its page's (pack, page_rows) scale block
template <int PACK>
__device__ __forceinline__ int scale_idx(int t, int page_rows) {
  return PACK == 1 ? t : (t & 1) * page_rows + (t >> 1);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// round a float to the compute type C and back
template <typename C> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// mask_rules: left-to-right order always; a LocalRule adds its window
__device__ __forceinline__ bool visible(int q_pos, int kv_pos, int window,
                                        int log2_stride, int is_local) {
  bool ok = kv_pos <= q_pos;
  if (is_local) {
    int diff = q_pos - kv_pos;
    ok = ok && ((diff >> log2_stride) < window);
    if (log2_stride) ok = ok && ((diff & ((1 << log2_stride) - 1)) == 0);
  }
  return ok;
}

// ---------------------------------------------------------------------------
// Row stores shared by kv_chunk_write and kv_append (one warp per row).
//
// Per-token symmetric quantization, kv_cache.py:138-153:
//   amax -> scale = amax == 0 ? 1 : amax / qmax -> y = x / scale
//   int8, int4: clamp(rint(y), -qmax, qmax); fp8: round y to nearest even
// IEEE division (not a multiply by the reciprocal), rintf (half to even)
// and the cvt.rn fp8 conversion make it bit-identical to the reference.
// Unquantized payloads are a cast.  Lanes past d store zeros (the
// reference pads the feature dim with zeros before quantizing).

// the token's scale (warp-uniform)
template <typename T>
__device__ __forceinline__ float token_scale(const T* __restrict__ src, int d, float qmax,
                                             int lane) {
  float amax = 0.f;
  for (int j = lane; j < d; j += 32) amax = fmaxf(amax, fabsf(to_f(src[j])));
  amax = warp_max(amax);
  return amax == 0.f ? 1.f : amax / qmax;
}

template <typename P> __device__ __forceinline__ P quantize(float y);
template <> __device__ __forceinline__ int8_t quantize<int8_t>(float y) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(y), -127.f), 127.f)));
}
template <> __device__ __forceinline__ fp8e4m3 quantize<fp8e4m3>(float y) {
  return fp8e4m3{__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3)};
}
template <> __device__ __forceinline__ fp8e5m2 quantize<fp8e5m2>(float y) {
  return fp8e5m2{__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E5M2)};
}

// an int4 value in [-7, 7], as the low 4 bits of an int
__device__ __forceinline__ int quantize_nibble(float y) {
  return static_cast<int>(fminf(fmaxf(rintf(y), -7.f), 7.f)) & 0xF;
}

template <typename T, typename P>
__device__ __forceinline__ void store_row(const T* __restrict__ src, int d, int d_store,
                                          P* __restrict__ dst, float* scale_dst,
                                          int lane) {
  if constexpr (Payload<P>::kQuant) {
    const float scale = token_scale(src, d, Payload<P>::kQmax, lane);
    for (int j = lane; j < d_store; j += 32)
      dst[j] = quantize<P>((j < d ? to_f(src[j]) : 0.f) / scale);
    if (lane == 0) *scale_dst = scale;
  } else {
    for (int j = lane; j < d_store; j += 32)
      dst[j] = from_f<P>(j < d ? to_f(src[j]) : 0.f);
  }
}

// int4: tokens 2r (src0) and 2r + 1 (src1) into byte row dst, their
// scales into sublanes 0 and 1 (kv_cache.py:156-168)
template <typename T>
__device__ __forceinline__ void store_byte_row(const T* __restrict__ src0,
                                               const T* __restrict__ src1, int d, int d_store,
                                               int4x2* __restrict__ dst, float* scale0,
                                               float* scale1, int lane) {
  const float s0 = token_scale(src0, d, 7.f, lane), s1 = token_scale(src1, d, 7.f, lane);
  for (int j = lane; j < d_store; j += 32) {
    const int lo = quantize_nibble((j < d ? to_f(src0[j]) : 0.f) / s0);
    const int hi = quantize_nibble((j < d ? to_f(src1[j]) : 0.f) / s1);
    dst[j].x = static_cast<int8_t>(lo | (hi << 4));
  }
  if (lane == 0) {
    *scale0 = s0;
    *scale1 = s1;
  }
}

// int4 append: the token's nibble of every feature, read-modify-write
// (kv_cache.py:548-600): an even token owns the byte (its odd partner does
// not exist yet), an odd token keeps the even one's low nibble
template <typename T>
__device__ __forceinline__ void store_nibble(const T* __restrict__ src, int d, int d_store,
                                             int odd, int4x2* dst, float* scale_dst,
                                             int lane) {
  const float scale = token_scale(src, d, 7.f, lane);
  for (int j = lane; j < d_store; j += 32) {
    const int q = quantize_nibble((j < d ? to_f(src[j]) : 0.f) / scale);
    dst[j].x = static_cast<int8_t>(odd ? (dst[j].x & 0xF) | (q << 4) : q);
  }
  if (lane == 0) *scale_dst = scale;
}

// ---------------------------------------------------------------------------
// K3 kv_chunk_write.  Replaces serving/kv_cache.py::_chunk_write_kernel
// (and the quantization XLA ran before it).  One warp per (K or V, kv head,
// stored row): a token row, or for int4 a byte row of two tokens (the chunk
// starts at an even position and is even, so byte rows are whole).  It
// quantizes in registers and stores the row and its scales at (table[(pos
// / page) % max_pages], pos % page).  A row whose (first) token is past
// true_len is not this slot's: the TPU kernel stores it to the trash page,
// which nothing reads, so this one skips it.  Sharded (stride > 1): a row
// whose global page g = pos / page is not this shard's (g % stride !=
// offset) is skipped too, and an owned one goes to table[((g - offset) /
// stride) % max_pages]; an int4 byte row follows its even token (pages hold
// an even number of tokens).  Bound by bytes: it reads the owned rows'
// activations once and writes their payload once; rows are stored whole and
// coalesced, so no page is read back (the TPU kernel's block-aligned copy
// is not needed, nor its alignment precondition).
template <typename T, typename P>
__global__ void kv_chunk_write_kernel(const T* __restrict__ k, const T* __restrict__ v,
                                      P* k_pages, P* v_pages, float* k_scales,
                                      float* v_scales, const int* __restrict__ table_row,
                                      int n_kv, int chunk, int d, int d_store, int page_size,
                                      int n_pages, int max_pages, int start, int true_len,
                                      int page_stride, int page_offset) {
  constexpr int PACK = Payload<P>::kPack;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk_rows = chunk / PACK, page_rows = page_size / PACK;
  const int rows = n_kv * chunk_rows;
  if (warp >= 2 * rows) return;  // warp-uniform
  const bool is_v = warp >= rows;
  const int r = is_v ? warp - rows : warp;
  const int h = r / chunk_rows, t = PACK * (r % chunk_rows);
  const int pos = start + t;
  const int gp = pos / page_size;
  if (t >= true_len || gp % page_stride != page_offset) return;  // warp-uniform
  const int phys = table_row[((gp - page_offset) / page_stride) % max_pages];
  const size_t page = static_cast<size_t>(h) * n_pages + phys;
  const size_t row = page * page_rows + (pos % page_size) / PACK;
  const T* src = (is_v ? v : k) + (static_cast<size_t>(h) * chunk + t) * d;
  P* dst = (is_v ? v_pages : k_pages) + row * d_store;
  float* sc = is_v ? v_scales : k_scales;
  if constexpr (PACK == 2) {
    sc += page * page_size + (pos % page_size) / 2;
    store_byte_row<T>(src, src + d, d, d_store, dst, sc, sc + page_rows, lane);
  } else {
    store_row<T, P>(src, d, d_store, dst, sc ? sc + row : nullptr, lane);
  }
}

// ---------------------------------------------------------------------------
// K4 kv_append.  Replaces serving/kv_cache.py::_append_rmw_kernel.  One
// warp per (K or V, slot, kv head): the row goes to
// (table[s, (len / page) % max_pages], len % page), or to the trash page
// for an inactive slot; for int4 the token read-modify-writes its nibble of
// byte row (len % page) / 2 and writes its scale sublane.  The TPU kernel
// read-modify-wrote a whole page per slot; here only the row and its scale
// are touched, so the kernel moves 2 * S * n_kv rows of d_store bytes and
// is bound by launch latency.  Two appends to one int4 byte row must be
// separate launches, in order: each reads the byte the other writes.
template <typename T, typename P>
__global__ void kv_append_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                                 P* k_pages, P* v_pages, float* k_scales, float* v_scales,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lengths,
                                 const uint8_t* __restrict__ active, int S, int n_kv, int d,
                                 int d_store, int page_size, int n_pages, int max_pages,
                                 int trash) {
  constexpr int PACK = Payload<P>::kPack;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = S * n_kv;
  if (warp >= 2 * rows) return;
  const bool is_v = warp >= rows;
  const int r = is_v ? warp - rows : warp;
  const int s = r / n_kv, h = r % n_kv;
  const int len = lengths[s];
  const int phys = active[s] ? tables[s * max_pages + (len / page_size) % max_pages] : trash;
  const int off = len % page_size, page_rows = page_size / PACK;
  const size_t page = static_cast<size_t>(h) * n_pages + phys;
  const size_t row = page * page_rows + off / PACK;
  const T* src = (is_v ? v_new : k_new) + static_cast<size_t>(r) * d;
  P* dst = (is_v ? v_pages : k_pages) + row * d_store;
  float* sc = is_v ? v_scales : k_scales;
  if constexpr (PACK == 2) {
    store_nibble<T>(src, d, d_store, off & 1, dst,
                    sc + page * page_size + scale_idx<2>(off, page_rows), lane);
  } else {
    store_row<T, P>(src, d, d_store, dst, sc ? sc + row : nullptr, lane);
  }
}

// ---------------------------------------------------------------------------
// K1 paged_decode and K5 paged_multitoken_decode.  Replace
// serving/decode.py::_decode_kernel at gamma 1 (paged_decode_attention) and
// at gamma > 1 (paged_multitoken_decode).  The g query heads of a kv head
// times gamma draft positions make g * gamma query rows (gamma-minor: row r
// is head r / gamma of the group at draft r % gamma), unpadded (the TPU's
// 8-row padding was a tiling artefact).  One block per (slot, kv head, group
// of at most 16 of those rows, chunk of at most 1024 output columns) takes
// its rows; loops over them are unrolled to GM, the group's rows rounded up
// to a power of two.  Any number of rows and any stored width D (a multiple
// of 128) run: more rows or columns add blocks on grid z, each reading the
// slot's pages again (through L2) and, for a column chunk, recomputing the
// logits.
// Row r sits at position length - gamma + r % gamma and sees keys up to and
// including itself: the same page stream serves every row, with a per-row
// bound on the logits, so verifying gamma drafts costs one pass over the
// pages.  A loop over the slot's live pages [first, count) takes the place
// of the TPU's sequential page grid axis and its VMEM carry.
//
// Bound by KV bytes: every live page is read once per kv head, and at the
// serving shape a block has only its own (slot, head) to work on, so the
// kernel must keep many bytes in flight per block.  A page's stored rows
// are one contiguous range: the kernel stages up to 32 KB of K and 32 KB of
// V at a time into shared memory, all 16-byte loads issued before any is
// used, and computes from there.  Quantized payloads are only cast (int8,
// fp8) or sign-extended by shifts (int4) after staging; the stage holds the
// payload's own bytes, so int4 and fp8 halve and keep the bytes of int8.
// Per page:
//   A  each group of 8 lanes takes a token, each lane D/8 contiguous
//      features, a 3-step shuffle reduction per query row; the K scale
//      (staged with the V scale in shared memory) folds into the logits;
//   B  one warp per query row: page max, exp2, V scale into p, round p;
//   C  each thread takes 4 columns of every (256 / (D/4))-th token;
//      the token groups' partial outputs are summed at the end.
// An int4 token t reads byte row t / 2 of the stage and its nibble t % 2,
// so A and C keep one token per lane group, as for the other payloads.
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kStageBytes = 32 * 1024;   // per operand
constexpr int kDecMaxRows = 16;          // query rows a block
constexpr int kDecCols = 1024;           // output columns a block

// features j .. j + 3 of token t in a stage of stored rows of D elements
template <typename P>
__device__ __forceinline__ void load4(const unsigned char* buf, int t, int D, int j, float* o);
template <>
__device__ __forceinline__ void load4<int8_t>(const unsigned char* buf, int t, int D, int j,
                                              float* o) {
  const char4 c = *reinterpret_cast<const char4*>(buf + static_cast<size_t>(t) * D + j);
  o[0] = c.x; o[1] = c.y; o[2] = c.z; o[3] = c.w;
}
template <>
__device__ __forceinline__ void load4<int4x2>(const unsigned char* buf, int t, int D, int j,
                                              float* o) {
  const char4 c = *reinterpret_cast<const char4*>(buf + static_cast<size_t>(t >> 1) * D + j);
  o[0] = nibble(c.x, t); o[1] = nibble(c.y, t); o[2] = nibble(c.z, t); o[3] = nibble(c.w, t);
}
template <>
__device__ __forceinline__ void load4<fp8e4m3>(const unsigned char* buf, int t, int D, int j,
                                               float* o) {
  const uchar4 c = *reinterpret_cast<const uchar4*>(buf + static_cast<size_t>(t) * D + j);
  o[0] = fp8_to_f(c.x, __NV_E4M3); o[1] = fp8_to_f(c.y, __NV_E4M3);
  o[2] = fp8_to_f(c.z, __NV_E4M3); o[3] = fp8_to_f(c.w, __NV_E4M3);
}
template <>
__device__ __forceinline__ void load4<fp8e5m2>(const unsigned char* buf, int t, int D, int j,
                                               float* o) {
  const uchar4 c = *reinterpret_cast<const uchar4*>(buf + static_cast<size_t>(t) * D + j);
  o[0] = fp8_to_f(c.x, __NV_E5M2); o[1] = fp8_to_f(c.y, __NV_E5M2);
  o[2] = fp8_to_f(c.z, __NV_E5M2); o[3] = fp8_to_f(c.w, __NV_E5M2);
}
template <>
__device__ __forceinline__ void load4<bf16>(const unsigned char* buf, int t, int D, int j,
                                            float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(buf + (static_cast<size_t>(t) * D + j) * 2);
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(b[i]);
}
template <>
__device__ __forceinline__ void load4<float>(const unsigned char* buf, int t, int D, int j,
                                             float* o) {
  const float4 f = *reinterpret_cast<const float4*>(buf + (static_cast<size_t>(t) * D + j) * 4);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}

// block-wide copy of one or two contiguous, 16-byte aligned ranges of
// `bytes` each into shared memory; 8 loads per range and thread in flight
__device__ __forceinline__ void stage_copy(const void* __restrict__ src_a, void* dst_a,
                                           const void* __restrict__ src_b, void* dst_b,
                                           int bytes) {
  const uint4* sa = static_cast<const uint4*>(src_a);
  const uint4* sb = static_cast<const uint4*>(src_b);
  uint4* da = static_cast<uint4*>(dst_a);
  uint4* db = static_cast<uint4*>(dst_b);
  const int n = bytes / 16;
  for (int base = threadIdx.x; base < n; base += 8 * blockDim.x) {
    uint4 ra[8], rb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = base + k * blockDim.x;
      if (i < n) {
        ra[k] = sa[i];
        if (sb) rb[k] = sb[i];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = base + k * blockDim.x;
      if (i < n) {
        da[i] = ra[k];
        if (sb) db[i] = rb[k];
      }
    }
  }
}

template <typename T, typename P, typename C, int GM>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const int* __restrict__ glob_lengths,
                    T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
                    int n_q, int n_kv, int d, int D, int page_size, int n_pages, int max_pages,
                    int gamma, int page_stride, int page_offset, float scale_log2e, int window,
                    int log2_stride, int is_local) {
  constexpr int PACK = Payload<P>::kPack;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = n_q / n_kv;
  // this block's rows [r_first, r_first + rows) of the g * gamma, and
  // output columns [cc0, cc0 + W) of the D
  const int n_cc = (D + kDecCols - 1) / kDecCols;
  const int r_first = static_cast<int>(blockIdx.z) / n_cc * kDecMaxRows;
  const int cc0 = static_cast<int>(blockIdx.z) % n_cc * kDecCols;
  const int rows = min(g * gamma - r_first, kDecMaxRows);   // <= GM
  const int W = min(D - cc0, kDecCols);
  unsigned char* kbuf = smem_raw;
  unsigned char* vbuf = smem_raw + kStageBytes;
  float* q_sh = reinterpret_cast<float*>(smem_raw + 2 * kStageBytes);  // rows * D
  float* p_sh = q_sh + rows * D;             // rows * page_size: logits, then p
  float* ks_sh = p_sh + rows * page_size;    // page_size
  float* vs_sh = ks_sh + page_size;          // page_size
  float* m_sh = vs_sh + page_size;           // rows
  float* l_sh = m_sh + rows;                 // rows
  float* a_sh = l_sh + rows;                 // rows
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool quantized = k_scales != nullptr;
  const int page_rows = page_size / PACK;
  const int row_bytes = D * static_cast<int>(sizeof(P));   // one stored row
  const int stage_rows = min(page_size, kStageBytes / row_bytes * PACK);   // tokens
  const bool whole_page = stage_rows == page_size;
  // phase A: token t = tb + sub for lanes 8 sub .. 8 sub + 7
  const int sub = lane >> 3, sl = lane & 7, epl = D / 8;
  // phase C: columns cc0 + c4 .. + 3 of every `groups`-th token from grp;
  // threads past the last group idle there
  const int quads = W / 4;
  const int c4 = 4 * (tid % quads), groups = kDecThreads / quads, grp = tid / quads;
  // q (S, gamma, n_q, d): the block's row r is row r_first + r of the
  // group, draft (r_first + r) % gamma of head h g + (r_first + r) / gamma
  auto q_index = [&](int r) {
    const int gr = r_first + r;
    return ((static_cast<size_t>(b) * gamma + gr % gamma) * n_q + h * g + gr / gamma) * d;
  };

  for (int i = tid; i < rows * D; i += kDecThreads) {
    const int r = i / D, j = i % D;
    q_sh[i] = round_to<C>(j < d ? to_f(q[q_index(r) + j]) : 0.f);
  }
  for (int r = tid; r < rows; r += kDecThreads) {
    m_sh[r] = neg_inf();
    l_sh[r] = 0.f;
  }
  // the page count from the local length; positions from the global one
  const int len = lengths[b];
  const int glen = glob_lengths ? glob_lengths[b] : len;
  const int q_pos0 = glen - gamma;           // row r's position: q_pos0 + r % gamma
  const int count = (len + page_size - 1) / page_size;
  int first = 0;
  if (is_local) {
    // the local index of the first live global page (decode.py:90-108)
    const int gfp = max(0, glen - gamma - ((window << log2_stride) - 1)) / page_size;
    first = page_stride == 1 ? gfp
            : (gfp > page_offset ? (gfp - page_offset + page_stride - 1) / page_stride : 0);
  }

  float acc[GM][4];
#pragma unroll
  for (int r = 0; r < GM; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
  __syncthreads();

  for (int lp = first; lp < count; ++lp) {
    const int phys = tables[b * max_pages + lp % max_pages];
    const size_t page = static_cast<size_t>(h) * n_pages + phys;
    const P* kp = k_pages + page * page_rows * D;
    const P* vp = v_pages + page * page_rows * D;
    if (quantized) {
      for (int i = tid; i < page_size; i += kDecThreads) {
        ks_sh[i] = k_scales[page * page_size + scale_idx<PACK>(i, page_rows)];
        vs_sh[i] = v_scales[page * page_size + scale_idx<PACK>(i, page_rows)];
      }
    }

    // A: logits of tokens [t0, t0 + n) from kbuf
    auto logits = [&](int t0, int n) {
      for (int tb = warp * 4; tb < n; tb += kDecWarps * 4) {
        const int t = tb + sub;
        float part[GM];
#pragma unroll
        for (int r = 0; r < GM; ++r) part[r] = 0.f;
        if (t < n) {
          for (int j0 = sl * epl; j0 < (sl + 1) * epl; j0 += 4) {
            float kv[4];
            load4<P>(kbuf, t, D, j0, kv);
#pragma unroll
            for (int r = 0; r < GM; ++r) {
              if (r < rows) {
                const float4 qv = *reinterpret_cast<const float4*>(q_sh + r * D + j0);
                part[r] += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
              }
            }
          }
        }
        const int kv_pos = (lp * page_stride + page_offset) * page_size + t0 + t;
        const float mul = quantized ? ks_sh[min(t0 + t, page_size - 1)] * scale_log2e
                                    : scale_log2e;
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          float s = part[r];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          if (r < rows && sl == 0 && t < n) {
            const bool ok =
                visible(q_pos0 + (r_first + r) % gamma, kv_pos, window, log2_stride, is_local);
            p_sh[r * page_size + t0 + t] = ok ? s * mul : neg_inf();
          }
        }
      }
    };
    // C: this thread's partial p @ V over tokens [t0, t0 + n) from vbuf
    float pv[GM][4];
#pragma unroll
    for (int r = 0; r < GM; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) pv[r][k] = 0.f;
    auto values = [&](int t0, int n) {
      if (grp >= groups) return;
      for (int t = grp; t < n; t += groups) {
        float vv[4];
        load4<P>(vbuf, t, D, cc0 + c4, vv);
#pragma unroll
        for (int r = 0; r < GM; ++r) {
          if (r < rows) {
            const float p = p_sh[r * page_size + t0 + t];
#pragma unroll
            for (int k = 0; k < 4; ++k) pv[r][k] += p * vv[k];
          }
        }
      }
    };

    if (whole_page) {   // K and V of the page in flight together
      stage_copy(kp, kbuf, vp, vbuf, page_rows * row_bytes);
      __syncthreads();
      logits(0, page_size);
    } else {
      for (int t0 = 0; t0 < page_size; t0 += stage_rows) {
        const int n = min(stage_rows, page_size - t0);
        stage_copy(kp + static_cast<size_t>(t0 / PACK) * D, kbuf, nullptr, nullptr,
                   n / PACK * row_bytes);
        __syncthreads();
        logits(t0, n);
        __syncthreads();
      }
    }
    __syncthreads();

    // B: online-softmax statistics, one warp per query row
    for (int r = warp; r < rows; r += kDecWarps) {
      float* row = p_sh + r * page_size;
      float mx = neg_inf();
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_next);
      // a row with no visible key yet keeps m == NEG_INF: zero its p
      const bool live = m_next > neg_inf() * 0.5f;
      float lsum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        const float p = live ? exp2f(row[t] - m_next) : 0.f;
        lsum += p;
        row[t] = round_to<C>(quantized ? p * vs_sh[t] : p);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        m_sh[r] = m_next;
        l_sh[r] = alpha * l_sh[r] + lsum;
        a_sh[r] = alpha;
      }
    }
    __syncthreads();

    if (whole_page) {
      values(0, page_size);
    } else {
      for (int t0 = 0; t0 < page_size; t0 += stage_rows) {
        const int n = min(stage_rows, page_size - t0);
        stage_copy(vp + static_cast<size_t>(t0 / PACK) * D, vbuf, nullptr, nullptr,
                   n / PACK * row_bytes);
        __syncthreads();
        values(t0, n);
        __syncthreads();
      }
    }
    // acc = acc * alpha + p @ V
#pragma unroll
    for (int r = 0; r < GM; ++r) {
      if (r < rows) {
        const float alpha = a_sh[r];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = acc[r][k] * alpha + pv[r][k];
      }
    }
    // the next page's writes to the stages, p_sh and a_sh wait for these reads
    __syncthreads();
  }

  // each row's statistics, before acc is normalised; a (slot, kv head)
  // with no local page writes l = 0 and m = NEG_INF (and o = 0 below)
  if (l_out && cc0 == 0) {
    for (int r = tid; r < rows; r += kDecThreads) {
      const size_t i = q_index(r) / d;
      l_out[i] = l_sh[r];
      m_out[i] = m_sh[r];
    }
  }
  // sum the token groups' partial outputs (the stages are free now:
  // groups * rows * W floats <= 4096 rows bytes <= 2 stages); an empty slot
  // has l == 0 and gives exact zeros
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    if (r < rows && grp < groups) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[(grp * rows + r) * W + c4 + k] = acc[r][k];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * W; i += kDecThreads) {
    const int r = i / W, col = cc0 + i % W;
    if (col >= d) continue;
    float sum = 0.f;
    for (int k = 0; k < groups; ++k) sum += red[(k * rows + r) * W + col - cc0];
    const float l = l_sh[r];
    o[q_index(r) + col] = from_f<T>(sum / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// K2 paged_prefill.  Replaces serving/prefill.py::_prefill_kernel.  Its
// tensor-core body (prefill_tc.cuh) takes bf16 activations at
// head_dim_store 128 on pages of a multiple of 64 tokens; this scalar body
// takes the rest (float32 activations, other stored widths, pages of 8-32
// tokens).  One block per (q head, tile of kPfTQ chunk rows, DC of the D output columns)
// loops over the sequence's live pages [first_live, count).  Per page, in
// sub-tiles of kPfTK keys (a page of fewer keys, or its ragged last
// sub-tile, stages zeros past its end and leaves those columns alone) staged
// in shared memory as float (int8 and fp8 cast, int4 sign-extended
// from its nibble: token t of a page is nibble t % 2 of byte row t / 2, so
// the even and odd halves share one online softmax, as in the reference):
//   S = Q K^T with a 2x4 register micro-tile per thread, K scale, and the
//     mask kv_pos < total && visible(q_pos, kv_pos) on edge pages only
//     (interior pages, entirely behind the chunk, skip it);
//   then per-row online softmax over the whole page (as the reference does,
//   so p is rounded against the same running max);
//   then acc = acc * alpha + P V, each warp owning 8 rows, each lane the
//   columns lane + 32 c.
// Bound by compute: chunk x live context x d multiply-adds, here on the
// scalar FP32 pipes (no tensor cores yet).  q arrives prescaled by
// scale * log2(e), so the logits feed exp2 directly.  Sharded: first_live
// and count are local (the host computes them, prefill.py:241-253); key
// positions and the interior test use the global page lp * stride + offset.
constexpr int kPfThreads = 128;
constexpr int kPfTQ = 32;
constexpr int kPfTK = 32;

// DK: the stored width D at compile time (the common 128 and 256: the
// staging loops' divisions become shifts), or 0 to read it from d_store
template <typename T, typename P, typename C, int DC, int DK>
__global__ void __launch_bounds__(kPfThreads)
paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                     const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales, const int* __restrict__ table_row,
                     T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
                     int chunk, int n_q, int n_kv, int d, int d_store, int page_size, int n_pages,
                     int max_pages, int page_stride, int page_offset, int start, int total,
                     int first_live, int count, int window, int log2_stride, int is_local) {
  const int D = DK ? DK : d_store;
  const int QS = D + 1;  // padded row strides: no bank conflicts in S
  constexpr int NC = DC / 32;
  const int cc0 = blockIdx.z * DC;  // this block's output columns
  extern __shared__ float smem[];
  const int SS = page_size + 1;
  float* q_sh = smem;                  // kPfTQ * QS
  float* kv_sh = q_sh + kPfTQ * QS;    // kPfTK * QS
  float* s_sh = kv_sh + kPfTK * QS;    // kPfTQ * SS
  float* ks_sh = s_sh + kPfTQ * SS;    // page_size
  float* vs_sh = ks_sh + page_size;    // page_size
  float* m_sh = vs_sh + page_size;     // kPfTQ
  float* l_sh = m_sh + kPfTQ;
  float* a_sh = l_sh + kPfTQ;
  const int hq = blockIdx.x;
  const int g = n_q / n_kv;
  const int hk = hq / g;
  const int row0 = blockIdx.y * kPfTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool quantized = k_scales != nullptr;

  for (int i = tid; i < kPfTQ * D; i += kPfThreads) {
    const int r = i / D, j = i % D;
    const int row = row0 + r;
    const float x = (row < chunk && j < d)
                        ? to_f(q[(static_cast<size_t>(row) * n_q + hq) * d + j]) : 0.f;
    q_sh[r * QS + j] = round_to<C>(x);
  }
  for (int r = tid; r < kPfTQ; r += kPfThreads) {
    m_sh[r] = neg_inf();
    l_sh[r] = 0.f;
  }
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  // S micro-tile of this thread: rows rg + 16 i (i < 2), cols cg + 8 j (j < 4)
  const int rg = tid / 8, cg = tid % 8;
  const int sw = window << log2_stride;
  // pages past the tile's last row are fully masked for it: skipping them
  // leaves the online softmax exactly unchanged (the local pages whose
  // global page is at most the last row's)
  const int last_gp = (start + min(row0 + kPfTQ, chunk) - 1) / page_size;
  const int tile_count = min(count, last_gp >= page_offset
                                        ? (last_gp - page_offset) / page_stride + 1 : 0);
  __syncthreads();

  constexpr int PACK = Payload<P>::kPack;
  const int page_rows = page_size / PACK;
  for (int lp = first_live; lp < tile_count; ++lp) {
    const int phys = table_row[lp % max_pages];
    const size_t page = static_cast<size_t>(hk) * n_pages + phys;
    const P* kp = k_pages + page * page_rows * D;
    const P* vp = v_pages + page * page_rows * D;
    if (quantized) {
      for (int i = tid; i < page_size; i += kPfThreads) {
        ks_sh[i] = k_scales[page * page_size + scale_idx<PACK>(i, page_rows)];
        vs_sh[i] = v_scales[page * page_size + scale_idx<PACK>(i, page_rows)];
      }
    }
    const int gp = lp * page_stride + page_offset;
    bool interior = (gp + 1) * page_size <= start;
    if (is_local)
      interior = interior && !log2_stride &&
                 gp * page_size >= start + chunk - sw;

    for (int t0 = 0; t0 < page_size; t0 += kPfTK) {
      const int n = min(kPfTK, page_size - t0);
      for (int i = tid; i < kPfTK * D; i += kPfThreads) {
        const int t = i / D, j = i % D;
        kv_sh[t * QS + j] = t < n ? tok_val<P>(kp, t0 + t, D, j) : 0.f;
      }
      __syncthreads();
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        const float q0 = q_sh[rg * QS + kk], q1 = q_sh[(rg + 16) * QS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kv = kv_sh[(cg + 8 * j) * QS + kk];
          s[0][j] += q0 * kv;
          s[1][j] += q1 * kv;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + 16 * i;
        const int q_pos = start + row0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cg + 8 * j >= n) continue;
          const int t = t0 + cg + 8 * j;
          float v = quantized ? s[i][j] * ks_sh[t] : s[i][j];
          if (!interior) {
            const int kv_pos = gp * page_size + t;
            if (!(kv_pos < total && visible(q_pos, kv_pos, window, log2_stride, is_local)))
              v = neg_inf();
          }
          s_sh[r * SS + t] = v;
        }
      }
      __syncthreads();
    }

    // online-softmax statistics over the whole page, one warp per 8 rows
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      float* row = s_sh + r * SS;
      float mx = neg_inf();
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_sh[r];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_next);
      const bool live = m_next > neg_inf() * 0.5f;
      float lsum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        const float p = live ? exp2f(row[t] - m_next) : 0.f;
        lsum += p;
        row[t] = round_to<C>(quantized ? p * vs_sh[t] : p);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        m_sh[r] = m_next;
        l_sh[r] = alpha * l_sh[r] + lsum;
        a_sh[r] = alpha;
      }
    }
    __syncthreads();

    float pv[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) pv[i][c] = 0.f;
    for (int t0 = 0; t0 < page_size; t0 += kPfTK) {
      const int n = min(kPfTK, page_size - t0);
      for (int i = tid; i < n * DC; i += kPfThreads) {
        const int t = i / DC, j = i % DC;
        kv_sh[t * QS + j] = tok_val<P>(vp, t0 + t, D, cc0 + j);
      }
      __syncthreads();
      for (int t = 0; t < n; ++t) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = kv_sh[t * QS + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = s_sh[(warp * 8 + i) * SS + t0 + t];
#pragma unroll
          for (int c = 0; c < NC; ++c) pv[i][c] += p * vv[c];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_sh[warp * 8 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] * alpha + pv[i][c];
    }
    // the next page's S writes wait for every warp's reads of a_sh/s_sh
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    const int row = row0 + r;
    if (row >= chunk) break;
    const float l = l_sh[r];
    if (l_out && lane == 0 && cc0 == 0) {
      l_out[static_cast<size_t>(row) * n_q + hq] = l;
      m_out[static_cast<size_t>(row) * n_q + hq] = m_sh[r];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cc0 + lane + 32 * c;
      if (col < d)
        o[(static_cast<size_t>(row) * n_q + hq) * d + col] =
            from_f<T>(acc[i][c] / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace

#include "prefill_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// Host-side dispatch on (activation type, payload type).

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// calls F::template run<T, P, C>() for the activation type T and the payload
// type P; C is bf16 for a quantized cache, else the payload type
template <typename T, typename F>
int dispatch_kv(int kv, F f) {
  switch (kv) {
    case kI8: return f.template run<T, int8_t, bf16>();
    case kE4M3: return f.template run<T, fp8e4m3, bf16>();
    case kE5M2: return f.template run<T, fp8e5m2, bf16>();
    case kI4: return f.template run<T, int4x2, bf16>();
    default: break;
  }
  // an unquantized cache holds the activations' type
  if constexpr (std::is_same<T, float>::value) {
    if (kv == kF32) return f.template run<T, float, float>();
  } else {
    if (kv == kBF16) return f.template run<T, bf16, bf16>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int dispatch(int act, int kv, F f) {
  if (act == kF32) return dispatch_kv<float>(kv, f);
  if (act == kBF16) return dispatch_kv<bf16>(kv, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct ChunkWrite {
  const void *k, *v;
  void *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int* table_row;
  // trash: the plain version's target for the skipped rows; the kernel
  // stores nothing there
  int n_kv, chunk, d, d_store, page_size, n_pages, max_pages, start, true_len, trash,
      page_stride, page_offset;
  cudaStream_t stream;
  template <typename T, typename P, typename C>
  int run() const {
    if (chunk % Payload<P>::kPack || start % Payload<P>::kPack || page_stride < 1 ||
        page_offset < 0 || page_offset >= page_stride)
      return static_cast<int>(cudaErrorInvalidValue);
    const int warps = 2 * n_kv * chunk / Payload<P>::kPack;
    const int threads = 256;
    const int blocks = (warps * 32 + threads - 1) / threads;
    if (blocks == 0) return 0;
    kv_chunk_write_kernel<T, P><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<P*>(k_pages),
        static_cast<P*>(v_pages), k_scales, v_scales, table_row, n_kv, chunk, d, d_store,
        page_size, n_pages, max_pages, start, true_len, page_stride, page_offset);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Append {
  const void *k_new, *v_new;
  void *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int *tables, *lengths;
  const uint8_t* active;
  int S, n_kv, d, d_store, page_size, n_pages, max_pages, trash;
  cudaStream_t stream;
  template <typename T, typename P, typename C>
  int run() const {
    const int warps = 2 * S * n_kv;
    const int threads = 256;
    const int blocks = (warps * 32 + threads - 1) / threads;
    if (blocks == 0) return 0;
    kv_append_kernel<T, P><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<P*>(k_pages),
        static_cast<P*>(v_pages), k_scales, v_scales, tables, lengths, active, S, n_kv, d,
        d_store, page_size, n_pages, max_pages, trash);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Decode {
  const void* q;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *tables, *lengths, *glob_lengths;
  void* o;
  float *l, *m;
  int S, gamma, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, page_stride, page_offset;
  float scale_log2e;
  int window, log2_stride, is_local;
  cudaStream_t stream;
  template <typename T, typename P, typename C, int GM>
  int launch() const {
    const int rows = n_q / n_kv * gamma, block_rows = min(rows, kDecMaxRows);
    const size_t smem = 2 * kStageBytes +
                        sizeof(float) * (static_cast<size_t>(block_rows) * (d_store + page_size) +
                                         2 * page_size + 3 * block_rows);
    const int z = (rows + kDecMaxRows - 1) / kDecMaxRows * ((d_store + kDecCols - 1) / kDecCols);
    if (smem > 232448 || z > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = paged_decode_kernel<T, P, C, GM>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(S, n_kv, z), kDecThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const P*>(k_pages),
        static_cast<const P*>(v_pages), k_scales, v_scales, tables, lengths, glob_lengths,
        static_cast<T*>(o), l, m, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, gamma,
        page_stride, page_offset, scale_log2e, window, log2_stride, is_local);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T, typename P, typename C>
  int run() const {
    const int rows = n_q / n_kv * gamma;
    // a stored row must fit one stage (the memory guard of the staging)
    if (n_q % n_kv || gamma < 1 || page_size % Payload<P>::kPack || d_store < 128 ||
        d_store % 128 || d_store * static_cast<int>(sizeof(P)) > kStageBytes ||
        page_stride < 1 || page_offset < 0 || page_offset >= page_stride ||
        (l == nullptr) != (m == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (S == 0) return 0;
    if (rows <= 1) return launch<T, P, C, 1>();
    if (rows <= 2) return launch<T, P, C, 2>();
    if (rows <= 4) return launch<T, P, C, 4>();
    if (rows <= 8) return launch<T, P, C, 8>();
    return launch<T, P, C, kDecMaxRows>();
  }
};

struct Prefill {
  const void* q;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int* table_row;
  void* o;
  float *l, *m;
  int chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, page_stride, page_offset,
      start, total, first_live, count, window, log2_stride, is_local;
  int* body;
  cudaStream_t stream;
  template <typename T, typename P, typename C, int DC, int DK>
  int launch() const {
    const size_t smem = sizeof(float) * (static_cast<size_t>(2 * kPfTQ) * (d_store + 1) +
                                         static_cast<size_t>(kPfTQ) * (page_size + 1) +
                                         2 * page_size + 3 * kPfTQ);
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = paged_prefill_kernel<T, P, C, DC, DK>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(n_q, (chunk + kPfTQ - 1) / kPfTQ, d_store / DC);
    kernel<<<grid, kPfThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const P*>(k_pages),
        static_cast<const P*>(v_pages), k_scales, v_scales, table_row, static_cast<T*>(o), l, m,
        chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, page_stride, page_offset,
        start, total, first_live, count, window, log2_stride, is_local);
    return static_cast<int>(cudaGetLastError());
  }
  // the body: bf16 activations at head_dim_store 128 on pages of a multiple
  // of 64 tokens on the tensor cores (native.prefill_body mirrors this
  // rule), the rest on the scalar body; *body (nullable) says which the
  // rule chose (1: the tensor cores), set before the launch, empty or not
  template <typename T, typename P, typename C>
  int run() const {
    if (page_size % Payload<P>::kPack || n_q % n_kv || d_store < 128 || d_store % 128 ||
        page_stride < 1 || page_offset < 0 || page_offset >= page_stride ||
        (l == nullptr) != (m == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (std::is_same<T, bf16>::value) {
      if (d_store == 128 && page_size % tc::kPfKeys == 0) {
        const tc::PfArgs a{static_cast<const bf16*>(q), k_pages, v_pages, k_scales, v_scales,
                           table_row, static_cast<bf16*>(o), l, m, chunk, n_q, n_kv, d,
                           page_size, n_pages, max_pages, page_stride, page_offset, start, total,
                           first_live, count, window, log2_stride, is_local};
        return tc::prefill_tc<P>(a, d_store, body, stream);
      }
    }
    if (body) *body = 0;
    if (chunk == 0) return 0;
    if (d_store == 128) return launch<T, P, C, 128, 128>();
    if (d_store == 256) return launch<T, P, C, 256, 256>();
    // wider: output columns in chunks of 256 where they divide the width,
    // else 128
    if (d_store % 256 == 0) return launch<T, P, C, 256, 0>();
    return launch<T, P, C, 128, 0>();
  }
};

}  // namespace

extern "C" {

int fa_kv_chunk_write(int act, int kv, const void* k, const void* v, void* k_pages,
                      void* v_pages, void* k_scales, void* v_scales, const void* table_row,
                      int n_kv, int chunk, int d, int d_store, int page_size, int n_pages,
                      int max_pages, int start, int true_len, int trash, int page_stride,
                      int page_offset, void* stream) {
  const ChunkWrite f{k, v, k_pages, v_pages, static_cast<float*>(k_scales),
                     static_cast<float*>(v_scales), static_cast<const int*>(table_row),
                     n_kv, chunk, d, d_store, page_size, n_pages, max_pages, start, true_len,
                     trash, page_stride, page_offset, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_kv_append(int act, int kv, const void* k_new, const void* v_new, void* k_pages,
                 void* v_pages, void* k_scales, void* v_scales, const void* tables,
                 const void* lengths, const void* active, int S, int n_kv, int d, int d_store,
                 int page_size, int n_pages, int max_pages, int trash, void* stream) {
  const Append f{k_new, v_new, k_pages, v_pages, static_cast<float*>(k_scales),
                 static_cast<float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), static_cast<const uint8_t*>(active), S,
                 n_kv, d, d_store, page_size, n_pages, max_pages, trash,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_paged_decode(int act, int kv, const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales, const void* tables,
                    const void* lengths, const void* glob_lengths, void* o, void* l, void* m,
                    int S, int n_q, int n_kv, int d, int d_store, int page_size, int n_pages,
                    int max_pages, int page_stride, int page_offset, float scale_log2e,
                    int window, int log2_stride, int is_local, void* stream) {
  const Decode f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                 static_cast<const float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), static_cast<const int*>(glob_lengths), o,
                 static_cast<float*>(l), static_cast<float*>(m), S, 1, n_q, n_kv, d, d_store,
                 page_size, n_pages, max_pages, page_stride, page_offset, scale_log2e, window,
                 log2_stride, is_local, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_paged_multitoken_decode(int act, int kv, const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scales, const void* v_scales,
                               const void* tables, const void* lengths,
                               const void* glob_lengths, void* o, void* l, void* m, int S,
                               int gamma, int n_q, int n_kv, int d, int d_store, int page_size,
                               int n_pages, int max_pages, int page_stride, int page_offset,
                               float scale_log2e, int window, int log2_stride, int is_local,
                               void* stream) {
  const Decode f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                 static_cast<const float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), static_cast<const int*>(glob_lengths), o,
                 static_cast<float*>(l), static_cast<float*>(m), S, gamma, n_q, n_kv, d,
                 d_store, page_size, n_pages, max_pages, page_stride, page_offset, scale_log2e,
                 window, log2_stride, is_local, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_paged_prefill(int act, int kv, const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scales, const void* v_scales, const void* table_row,
                     void* o, void* l, void* m, int chunk, int n_q, int n_kv, int d,
                     int d_store, int page_size, int n_pages, int max_pages, int page_stride,
                     int page_offset, int start, int total, int first_live, int count,
                     int window, int log2_stride, int is_local, int* body, void* stream) {
  const Prefill f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales), static_cast<const int*>(table_row), o,
                  static_cast<float*>(l), static_cast<float*>(m), chunk, n_q, n_kv, d,
                  d_store, page_size, n_pages, max_pages, page_stride, page_offset, start,
                  total, first_live, count, window, log2_stride, is_local, body,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

}  // extern "C"
