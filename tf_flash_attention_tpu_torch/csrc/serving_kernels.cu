// Serving kernels of the PyTorch port, for Hopper (sm_90a).
//
// Five kernels carry the steps of the continuous-batching engine:
//   kv_chunk_write          chunked prefill: quantize + store a chunk's K/V
//   paged_prefill           chunked prefill: the chunk attends to its cache
//   kv_append               decode: quantize + store a slot's K/V rows (one
//                           token, or speculation's gamma) and advance its
//                           length
//   paged_decode            decode: one query token per slot attends to its
//                           pages
//   paged_multitoken_decode speculative decode: gamma draft tokens per slot,
//                           each up to its own position (the same kernel)
// The experiment tools' decode sites (fa_exp_int4_*, the int4 unpack
// tool's six; fa_exp_paged_decode, exp_decode's variants; off the serving
// path) run the decode's tensor-core body as compiled policies
// (decode_tc.cuh), so their entries live here beside the decode's.
//
// Sequence sharding (context-parallel serving, the JAX package's
// serving/seq_sharded_decode.py): a shard's cache holds every
// page_stride-th global page of a sequence starting at page_offset, global
// page g at local logical page (g - offset) / stride.  kv_chunk_write skips
// the rows of other shards' pages, kv_append the tokens whose global
// position is on them; the attention kernels
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

#include <initializer_list>
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
// Row stores shared by kv_chunk_write and kv_append.
//
// Per-token symmetric quantization, kv_cache.py:138-153:
//   amax -> scale = amax == 0 ? 1 : amax / qmax -> y = x / scale
//   int8, int4: clamp(rint(y), -qmax, qmax); fp8: round y to nearest even
// IEEE division (not a multiply by the reciprocal), rintf (half to even)
// and the cvt.rn fp8 conversion make it bit-identical to the reference.
// Unquantized payloads are a cast.  Features past d store zeros (the
// reference pads the feature dim with zeros before quantizing).
//
// A job is a stored row: a token row, or for int4 a byte row of two
// tokens.  Two bodies do the jobs, each a warp a row.  The vector body:
// each lane takes VEC = d_store / 32 contiguous features loaded with the
// widest aligned loads (VEC 4 at d_store 128: 8 bytes of bf16, 16 of
// float32; at 256, 8 features); the amax comes from registers by one
// shuffle reduction, the quantization from the same registers, and the
// payload is stored packed (four one-byte values a word: a 128-byte row is
// one coalesced store a warp).  The writes are latency-bound (a few
// microseconds for a few megabytes), so what counts is the chain each warp
// waits through (no integer division on it: page_of, table_slot) and how
// many warps hide it.  The scalar body (features strided over lanes, the
// source read twice) takes the shapes the vector one cannot: other stored
// widths, d not a multiple of VEC, or source rows not aligned to a lane's
// load (kv_vec, mirrored by native.kv_write_body).

// one stored row: the sources of its tokens (an int4 byte row's even and
// odd token; nullptr where the launch writes no token there: an append's
// first token at an odd position, or its last at an even one), its payload
// row, and its tokens' scale slots (nullptr for an unquantized cache)
template <typename T, typename P>
struct RowJob {
  const T* src[Payload<P>::kPack];
  P* dst;
  float* scale[Payload<P>::kPack];
};

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

// a one-byte payload value's bits
__device__ __forceinline__ uint32_t bits(int8_t x) { return static_cast<uint8_t>(x); }
__device__ __forceinline__ uint32_t bits(fp8e4m3 x) { return x.x; }
__device__ __forceinline__ uint32_t bits(fp8e5m2 x) { return x.x; }

// an int4 value in [-7, 7], as the low 4 bits of an int
__device__ __forceinline__ int quantize_nibble(float y) {
  return static_cast<int>(fminf(fmaxf(rintf(y), -7.f), 7.f)) & 0xF;
}

// ---- the scalar body ----

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

// int4 append of one token alone in its byte row, read-modify-write
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

template <typename T, typename P>
__device__ __forceinline__ void store_scalar(const RowJob<T, P>& job, int d, int d_store,
                                             int lane) {
  if constexpr (Payload<P>::kPack == 2) {
    if (job.src[0] && job.src[1])
      store_byte_row<T>(job.src[0], job.src[1], d, d_store, job.dst, job.scale[0],
                        job.scale[1], lane);
    else if (job.src[0])
      store_nibble<T>(job.src[0], d, d_store, 0, job.dst, job.scale[0], lane);
    else
      store_nibble<T>(job.src[1], d, d_store, 1, job.dst, job.scale[1], lane);
  } else {
    store_row<T, P>(job.src[0], d, d_store, job.dst, job.scale[0], lane);
  }
}

// ---- the vector body ----

// W 32-bit words from W * 4 aligned bytes (W 1, 2 or a multiple of 4)
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (W == 2) {
    const uint2 a = *static_cast<const uint2*>(p);
    w[0] = a.x;
    w[1] = a.y;
  } else {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 a = static_cast<const uint4*>(p)[c];
      w[4 * c] = a.x;
      w[4 * c + 1] = a.y;
      w[4 * c + 2] = a.z;
      w[4 * c + 3] = a.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    *static_cast<uint32_t*>(p) = w[0];
  } else if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      static_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  }
}

// VEC activations (float or bf16) widened to float; bf16 -> float is exact
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* src, float (&x)[VEC]) {
  constexpr int W = VEC * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
  load_words<W>(src, w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (std::is_same<T, float>::value)
      x[i] = __uint_as_float(w[i]);
    else
      x[i] = __uint_as_float((i & 1) ? (w[i >> 1] & 0xFFFF0000u) : (w[i >> 1] << 16));
  }
}

// one job from registers: x[p] holds token p's VEC features of this lane
// (zeros past d, or where the job has no such token).  Every lane of the
// warp calls it (the shuffles)
template <typename T, typename P, int VEC>
__device__ __forceinline__ void store_vec(const RowJob<T, P>& job,
                                          const float (&x)[Payload<P>::kPack][VEC], int lane) {
  constexpr int PACK = Payload<P>::kPack;
  P* dst = job.dst + lane * VEC;
  if constexpr (!Payload<P>::kQuant) {
    constexpr int W = VEC * static_cast<int>(sizeof(P)) / 4;
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (std::is_same<P, float>::value)
        w[i] = __float_as_uint(x[0][i]);
      else  // round to nearest even, as torch and XLA
        w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(x[0][2 * i]))) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(x[0][2 * i + 1])))
                << 16);
    }
    store_words<W>(dst, w);
  } else {
    constexpr int W = VEC / 4;  // one byte a value, four a word
    float s[PACK];
#pragma unroll
    for (int p = 0; p < PACK; ++p) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(x[p][i]));
      amax = warp_max(amax);
      s[p] = amax == 0.f ? 1.f : amax / Payload<P>::kQmax;
    }
    uint32_t w[W];
    if constexpr (PACK == 1) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        w[c] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) w[c] |= bits(quantize<P>(x[0][4 * c + b] / s[0])) << (8 * b);
      }
    } else {
      // an odd token alone keeps the even one's low nibble; an even token
      // alone owns the byte
      uint32_t old[W];
      if (!job.src[0]) load_words<W>(dst, old);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        w[c] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 4 * c + b;
          const uint32_t lo = job.src[0] ? quantize_nibble(x[0][i] / s[0])
                                         : (old[c] >> (8 * b)) & 0xFu;
          const uint32_t hi = job.src[1] ? quantize_nibble(x[1][i] / s[1]) : 0u;
          w[c] |= (lo | (hi << 4)) << (8 * b);
        }
      }
    }
    store_words<W>(dst, w);
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < PACK; ++p)
        if (job.src[p]) *job.scale[p] = s[p];
    }
  }
}

// one job on a warp, its loads issued before the reduction
template <typename T, typename P, int VEC>
__device__ __forceinline__ void run_vec(const RowJob<T, P>& job, int d, int lane) {
  constexpr int PACK = Payload<P>::kPack;
  float x[PACK][VEC];
  const bool live = lane * VEC < d;  // d is a multiple of VEC
#pragma unroll
  for (int p = 0; p < PACK; ++p) {
    if (live && job.src[p]) {
      load_vec<T, VEC>(job.src[p] + lane * VEC, x[p]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[p][i] = 0.f;
    }
  }
  store_vec<T, P, VEC>(job, x, lane);
}

// jobs [0, n) of a CTA or a grid, a warp a job: VEC 0 is the scalar body,
// else the vector body
template <typename T, typename P, int VEC, typename JobAt>
__device__ __forceinline__ void run_jobs(const JobAt& job_at, int n, int warp, int warps, int d,
                                         int d_store, int lane) {
  for (int j = warp; j < n; j += warps) {
    if constexpr (VEC == 0)
      store_scalar<T, P>(job_at(j), d, d_store, lane);
    else
      run_vec<T, P, VEC>(job_at(j), d, lane);
  }
}

// the page of local position loc: a shift where the page size is a power of
// two (page_shift >= 0), and the logical page's table slot (the table
// wraps, as the reference's modulo): no integer division on the common path
__device__ __forceinline__ int page_of(int loc, int page_size, int page_shift) {
  return page_shift >= 0 ? loc >> page_shift : loc / page_size;
}
__device__ __forceinline__ int table_slot(int lp, int max_pages) {
  return lp < max_pages ? lp : lp % max_pages;
}

// the payload row and scale slots of local position `off` of page `page`
// (h * n_pages + phys) for a stored width d_store
template <typename T, typename P>
__device__ __forceinline__ void locate(RowJob<T, P>& job, P* pages, float* scales, size_t page,
                                       int off, int page_size, int d_store) {
  constexpr int PACK = Payload<P>::kPack;
  const int page_rows = page_size / PACK;
  const size_t row = page * page_rows + off / PACK;
  job.dst = pages + row * d_store;
  float* sc = scales ? scales + page * page_size + off / PACK : nullptr;
#pragma unroll
  for (int p = 0; p < PACK; ++p) job.scale[p] = sc ? sc + p * page_rows : nullptr;
}

// ---------------------------------------------------------------------------
// K3 kv_chunk_write.  Replaces serving/kv_cache.py::_chunk_write_kernel
// (and the quantization XLA ran before it).  A job per (K or V, kv head,
// stored row this shard keeps): the chunk's tokens [start, start +
// true_len), rounded up to whole stored rows (an int4 byte row follows its
// even token; the chunk starts at an even position and is even), on this
// shard's pages.  The per-call scalars come from the device, as the
// reference's scalar prefetch brings them: meta = (slot, start, total,
// trash_page, page_offset) (kv_cache.py:386-389), and every thread derives
// from it the kept rows (chunk_span, the host's kv_cache._owned_rows): a run
// of the shard's local positions, [local0, local0 + PACK * units): local
// position l is global position ((l / page) * stride + offset) * page + l %
// page (stride 1, offset 0: the positions themselves), stored at
// (table[(l / page) % max_pages], l % page).  The grid covers the chunk's
// rows, a static shape, so one graph capture serves every chunk; the warps
// past the kept rows (padding rows and other shards' rows, which the TPU
// kernel stored to the trash page: nothing reads it) leave at once.  The source is K and V as
// the projection leaves them: any head and row strides, unit feature
// stride.  One thread also sets the slot's length to the owned-token count
// (the whole sequence's on this shard), so the wrapper runs no torch op.
// Bound by bytes: the kept rows' activations read once, their payload and
// scales written once; rows are stored whole and coalesced, so no page is
// read back (the TPU kernel's block-aligned copy is not needed, nor its
// alignment precondition).
template <typename T, typename P>
struct ChunkRows {
  const T *k, *v;
  P *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int* tables;  // (max_seqs, max_pages)
  int* lengths;       // (max_seqs,)
  const int* meta;    // slot, start, total, trash_page, page_offset
  long long head_stride, row_stride;
  int n_kv, d, d_store, page_size, page_shift, n_pages, max_pages, page_stride;
};

// tokens in [0, total) on the shard owning every stride-th page from offset
// (kv_cache._owned_token_count)
__device__ __forceinline__ int owned_count(int total, int page_size, int page_shift, int stride,
                                           int offset) {
  if (stride == 1) return total;
  const int n_g = page_of(total, page_size, page_shift);
  const int full = n_g > offset ? (n_g - offset + stride - 1) / stride : 0;
  return full * page_size + (n_g % stride == offset ? total - n_g * page_size : 0);
}

// what a launch reads from its meta vector: the slot's table row and
// length, the chunk's start, the kept rows [local0, local0 + PACK * units)
// and the slot's owned-token count after the write (kv_cache._owned_rows)
struct ChunkSpan {
  const int* table_row;
  int* length;
  int start, local0, units, owned, page_offset;
};

template <typename P, typename A>
__device__ __forceinline__ ChunkSpan chunk_span(const A& a) {
  constexpr int PACK = Payload<P>::kPack;
  const int slot = a.meta[0], start = a.meta[1], total = a.meta[2], off = a.meta[4];
  const int rounded = start + (total - start + PACK - 1) / PACK * PACK;
  const int local0 = owned_count(start, a.page_size, a.page_shift, a.page_stride, off);
  const int end = owned_count(rounded, a.page_size, a.page_shift, a.page_stride, off);
  // an int4 chunk starts at an even position (the wrapper checks a host
  // start); an odd one writes nothing rather than read before the chunk
  const int units = start % PACK ? 0 : (end - local0) / PACK;
  return {a.tables + static_cast<size_t>(slot) * a.max_pages, a.lengths + slot, start, local0,
          units, owned_count(total, a.page_size, a.page_shift, a.page_stride, off), off};
}

// the jobs of one (K or V, kv head): the kept rows u = 0 .. units - 1
template <typename T, typename P>
struct HeadRows {
  const ChunkRows<T, P> a;
  const ChunkSpan s;
  bool is_v;
  int h;

  __device__ __forceinline__ RowJob<T, P> operator()(int u) const {
    constexpr int PACK = Payload<P>::kPack;
    const int loc = s.local0 + PACK * u;
    const int lp = page_of(loc, a.page_size, a.page_shift), off = loc - lp * a.page_size;
    const int t = (lp * a.page_stride + s.page_offset) * a.page_size + off - s.start;
    RowJob<T, P> job;
    const T* src = (is_v ? a.v : a.k) + h * a.head_stride + t * a.row_stride;
#pragma unroll
    for (int p = 0; p < PACK; ++p) job.src[p] = src + p * a.row_stride;
    const size_t page =
        static_cast<size_t>(h) * a.n_pages + s.table_row[table_slot(lp, a.max_pages)];
    locate(job, is_v ? a.v_pages : a.k_pages, is_v ? a.v_scales : a.k_scales, page, off,
           a.page_size, a.d_store);
    return job;
  }
};

constexpr int kChunkThreads = 256;

// grid: (blocks of the chunk's stored rows, K and V of each kv head)
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kChunkThreads)
kv_chunk_write_kernel(const ChunkRows<T, P> a) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const ChunkSpan s = chunk_span<P>(a);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *s.length = s.owned;
  const bool is_v = static_cast<int>(blockIdx.y) >= a.n_kv;
  const HeadRows<T, P> rows{a, s, is_v, static_cast<int>(blockIdx.y) - (is_v ? a.n_kv : 0)};
  run_jobs<T, P, VEC>(rows, s.units, warp, warps, a.d, a.d_store, lane);
}

// ---------------------------------------------------------------------------
// K4 kv_append.  Replaces serving/kv_cache.py::_append_rmw_kernel.  A CTA
// per slot appends T >= 1 tokens a slot, (S, T, n_kv, d) at any slot,
// token and head strides, in order: the tokens this cache owns land at its
// length and after, and one thread advances the length by their count
// after the CTA's barrier (so no warp reads a length another advanced).
// A token is owned when the slot is active and, sequence sharded (stride
// > 1), its global position glob[s] + i lies on one of this shard's pages:
// (glob[s] + i) / page % stride == offset, the JAX engine's `mine = active
// & (owner == me)` (tf_flash_attention_tpu/serving/engine.py:515-520); an
// inactive or non-owned token stores nothing (the TPU kernel wrote the
// trash page).  Jobs are (K or V, kv head, stored row): for int4 the byte
// rows the owned tokens touch, each with one or both of its tokens from
// this launch, so the two tokens of a byte row are paired in registers and
// a row with one token read-modify-writes its byte as T ordered launches
// of one token would.  The TPU kernel read-modify-wrote a whole page a
// slot; this one touches only the rows and their scales, 2 * S * T * n_kv
// rows of d_store bytes: bound by launch latency.
template <typename T, typename P>
struct AppendRows {
  const T *k, *v;
  P *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int* tables;
  int* lengths;
  const uint8_t* active;
  const int* glob;  // nullptr when not sharded
  long long slot_stride, tok_stride, head_stride;
  int T_, n_kv, d, d_store, page_size, page_shift, n_pages, max_pages, page_stride,
      page_offset;

  __device__ __forceinline__ bool owns(int s, int i) const {
    return page_stride == 1 ||
           page_of(glob[s] + i, page_size, page_shift) % page_stride == page_offset;
  }
  // the token of the q-th owned one
  __device__ __forceinline__ int owned_token(int s, int q) const {
    if (page_stride == 1) return q;
    int i = 0;
    for (int seen = -1;; ++i)
      if (owns(s, i) && ++seen == q) return i;
  }
};

// the jobs of slot s: stored rows from local position first (len, or for
// int4 its byte row's even position) on, units of them
template <typename T, typename P>
struct SlotRows {
  const AppendRows<T, P> a;
  int s, len, n_own, first, units;

  __device__ __forceinline__ RowJob<T, P> operator()(int j) const {
    constexpr int PACK = Payload<P>::kPack;
    const int per = a.n_kv * units;
    const bool is_v = j >= per;
    const int r = is_v ? j - per : j;
    const int h = r / units;
    const int loc = first + PACK * (r - h * units);
    const int lp = page_of(loc, a.page_size, a.page_shift), off = loc - lp * a.page_size;
    const T* base = (is_v ? a.v : a.k) + s * a.slot_stride + h * a.head_stride;
    RowJob<T, P> job;
#pragma unroll
    for (int p = 0; p < PACK; ++p) {
      const int q = loc + p - len;  // this position's owned token, if in the launch
      job.src[p] = q >= 0 && q < n_own ? base + a.owned_token(s, q) * a.tok_stride : nullptr;
    }
    const size_t page = static_cast<size_t>(h) * a.n_pages +
                        a.tables[static_cast<size_t>(s) * a.max_pages +
                                 table_slot(lp, a.max_pages)];
    locate(job, is_v ? a.v_pages : a.k_pages, is_v ? a.v_scales : a.k_scales, page, off,
           a.page_size, a.d_store);
    return job;
  }
};

// warps of an append CTA at most, by body (more warps leave the scalar
// body too few registers); the launch sizes the CTA to the slot's jobs
__host__ __device__ constexpr int append_warps(int vec) { return vec ? 32 : 4; }

template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(32 * append_warps(VEC), 1)
kv_append_kernel(const AppendRows<T, P> a) {
  constexpr int PACK = Payload<P>::kPack;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = a.lengths[s];
  int n_own = 0;
  if (a.active[s])
    for (int i = 0; i < a.T_; ++i) n_own += a.owns(s, i);
  const int first = len - len % PACK;
  const int units = n_own ? (len + n_own - 1 - first) / PACK + 1 : 0;
  const SlotRows<T, P> rows{a, s, len, n_own, first, units};
  run_jobs<T, P, VEC>(rows, 2 * a.n_kv * units, warp, blockDim.x >> 5, a.d, a.d_store, lane);
  __syncthreads();
  if (threadIdx.x == 0 && n_own) a.lengths[s] = len + n_own;
}

// ---------------------------------------------------------------------------
// K1 paged_decode and K5 paged_multitoken_decode.  Replace
// serving/decode.py::_decode_kernel at gamma 1 (paged_decode_attention) and
// at gamma > 1 (paged_multitoken_decode).  bf16 activations at
// head_dim_store 128 run the tensor-core body of decode_tc.cuh (pages split
// over CTAs, a bulk-copy ring, mma.sync); this scalar body takes float32
// activations and other stored widths.  The g query heads of a kv head
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
// scale * log2(e), so the logits feed exp2 directly.  The per-call scalars
// come from the device: meta = (slot, count, total, start, first_live,
// page_offset), the reference's scalar-prefetch vector (prefill.py:254-257),
// built by device arithmetic in serving/prefill.py::prefill_meta, and the
// slot's table row is tables + slot * max_pages; the grid follows the
// chunk's static shape, so one graph capture serves every chunk.  Sharded:
// first_live and count are local; key positions and the interior test use
// the global page lp * stride + offset.
constexpr int kPfThreads = 128;
constexpr int kPfTQ = 32;
constexpr int kPfTK = 32;

// DK: the stored width D at compile time (the common 128 and 256: the
// staging loops' divisions become shifts), or 0 to read it from d_store
template <typename T, typename P, typename C, int DC, int DK>
__global__ void __launch_bounds__(kPfThreads)
paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                     const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales, const int* __restrict__ tables,
                     const int* __restrict__ meta, T* __restrict__ o, float* __restrict__ l_out,
                     float* __restrict__ m_out, int chunk, int n_q, int n_kv, int d, int d_store,
                     int page_size, int n_pages, int max_pages, int page_stride, int window,
                     int log2_stride, int is_local) {
  const int count = meta[1], total = meta[2], start = meta[3], first_live = meta[4],
            page_offset = meta[5];
  const int* table_row = tables + static_cast<size_t>(meta[0]) * max_pages;
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
#include "decode_tc.cuh"

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

// the body of a KV write (native.kv_write_body mirrors this rule): the
// vector body's VEC = d_store / 32 at a stored width of 128 or 256 when d
// is a multiple of VEC and every source row starts aligned to a lane's
// load (VEC values, at most 16 bytes: the bases and every stride), else 0,
// the scalar body; *body (nullable) reports it (1: the vector body)
template <typename T>
int kv_vec(int d, int d_store, const void* k, const void* v,
           std::initializer_list<long long> strides, int* body) {
  int vec = d_store == 128 || d_store == 256 ? d_store / 32 : 0;
  const long long align = min(16, vec * static_cast<int>(sizeof(T)));
  if (vec && (d % vec || reinterpret_cast<uintptr_t>(k) % align ||
              reinterpret_cast<uintptr_t>(v) % align))
    vec = 0;
  for (long long st : strides)
    if (vec && (st * static_cast<long long>(sizeof(T))) % align) vec = 0;
  if (body) *body = vec != 0;
  return vec;
}

// log2 of a power of two, else -1 (page_of)
inline int shift_of(int n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

// launches F::launch<T, P, VEC>(a) for the body kv_vec chose
template <typename T, typename P, typename F, typename A>
int launch_kv(const F& f, const A& a, int vec) {
  if (vec == 0) return f.template launch<T, P, 0>(a);
  if (vec == 4) return f.template launch<T, P, 4>(a);
  return f.template launch<T, P, 8>(a);
}

struct ChunkWrite {
  const void *k, *v;
  void *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int* tables;
  int* lengths;
  const int* meta;
  int chunk, n_kv;
  long long head_stride, row_stride;
  int d, d_store, page_size, n_pages, max_pages, page_stride;
  int* body;
  cudaStream_t stream;
  template <typename T, typename P, int VEC>
  int launch(const ChunkRows<T, P>& a) const {
    constexpr int PACK = Payload<P>::kPack;
    constexpr int per_block = kChunkThreads / 32;
    // the most stored rows a call keeps, from the static shape: the chunk's
    // rows, and on a shard the pages of it that the shard can own (a chunk
    // touches at most ceil(chunk / page) + 1 consecutive pages, every
    // stride-th of them the shard's); one block at least: it sets the
    // slot's length.  The warps loop over the kept rows, so any grid is
    // right; this one starts no more warps than the shape allows rows
    int rows = chunk / PACK;
    if (page_stride > 1) {
      const int spanned = (chunk + page_size - 1) / page_size + 1;
      rows = min(rows, (spanned + page_stride - 1) / page_stride * (page_size / PACK));
    }
    const dim3 grid(max(1, (rows + per_block - 1) / per_block), 2 * n_kv);
    kv_chunk_write_kernel<T, P, VEC><<<grid, kChunkThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T, typename P, typename C>
  int run() const {
    constexpr int PACK = Payload<P>::kPack;
    if (chunk < 0 || chunk % PACK || page_size % PACK || page_stride < 1 || d > d_store)
      return static_cast<int>(cudaErrorInvalidValue);
    const ChunkRows<T, P> a{static_cast<const T*>(k), static_cast<const T*>(v),
                            static_cast<P*>(k_pages), static_cast<P*>(v_pages), k_scales,
                            v_scales, tables, lengths, meta, head_stride, row_stride, n_kv, d,
                            d_store, page_size, shift_of(page_size), n_pages, max_pages,
                            page_stride};
    return launch_kv<T, P>(*this, a, kv_vec<T>(d, d_store, k, v, {head_stride, row_stride}, body));
  }
};

struct Append {
  const void *k, *v;
  void *k_pages, *v_pages;
  float *k_scales, *v_scales;
  const int* tables;
  int* lengths;
  const uint8_t* active;
  const int* glob;
  int S, T_, n_kv;
  long long slot_stride, tok_stride, head_stride;
  int d, d_store, page_size, n_pages, max_pages, page_stride, page_offset;
  int* body;
  cudaStream_t stream;
  template <typename T, typename P, int VEC>
  int launch(const AppendRows<T, P>& a) const {
    // a slot's jobs at most, a warp each: K and V of each kv head for each
    // stored row its T tokens touch
    constexpr int PACK = Payload<P>::kPack;
    const int jobs = 2 * n_kv * (PACK == 1 ? T_ : T_ / 2 + 1);
    const int warps = min(append_warps(VEC), jobs);
    kv_append_kernel<T, P, VEC><<<S, 32 * warps, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T, typename P, typename C>
  int run() const {
    if (T_ < 1 || page_size % Payload<P>::kPack || page_stride < 1 || page_offset < 0 ||
        page_offset >= page_stride || (page_stride > 1 && glob == nullptr) || d > d_store)
      return static_cast<int>(cudaErrorInvalidValue);
    const AppendRows<T, P> a{static_cast<const T*>(k), static_cast<const T*>(v),
                             static_cast<P*>(k_pages), static_cast<P*>(v_pages), k_scales,
                             v_scales, tables, lengths, active, glob, slot_stride, tok_stride,
                             head_stride, T_, n_kv, d, d_store, page_size, shift_of(page_size),
                             n_pages, max_pages, page_stride, page_offset};
    const int vec = kv_vec<T>(d, d_store, k, v, {slot_stride, tok_stride, head_stride}, body);
    if (S == 0) return 0;
    return launch_kv<T, P>(*this, a, vec);
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
  float* ws;     // the tensor-core body's partials and tickets (decode_tc.cuh)
  int* tickets;
  int splits;
  int* walk;     // nullable, host: {body (1: the tensor cores), splits, CTAs}
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
    // the body: bf16 activations at head_dim_store 128 on pages of 16, 32 or
    // a multiple of 64 tokens on the tensor cores (native.decode_body mirrors
    // this rule), the rest on the scalar body
    if constexpr (std::is_same<T, bf16>::value) {
      if (d_store == tc::kDcD &&
          (page_size % tc::kDcKeys == 0 || page_size == 16 || page_size == 32)) {
        const tc::DcArgs a{static_cast<const bf16*>(q), k_pages, v_pages, k_scales, v_scales,
                           tables, lengths, glob_lengths, static_cast<bf16*>(o), l, m, ws,
                           tickets, n_q, n_kv, d, page_size, n_pages, max_pages, gamma,
                           page_stride, page_offset, scale_log2e, window, log2_stride, is_local,
                           splits, (rows + tc::kDcRows - 1) / tc::kDcRows, 0};
        return tc::decode_tc<P>(a, S, d_store, walk, stream);
      }
    }
    if (walk) {
      walk[0] = 0;
      walk[1] = 1;
      walk[2] = S * n_kv * ((rows + kDecMaxRows - 1) / kDecMaxRows) *
                ((d_store + kDecCols - 1) / kDecCols);
    }
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
  const int *tables, *meta;
  void* o;
  float *l, *m;
  int chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, page_stride, window,
      log2_stride, is_local;
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
        static_cast<const P*>(v_pages), k_scales, v_scales, tables, meta, static_cast<T*>(o), l,
        m, chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, page_stride, window,
        log2_stride, is_local);
    return static_cast<int>(cudaGetLastError());
  }
  // the body: bf16 activations at head_dim_store 128 on pages of a multiple
  // of 64 tokens on the tensor cores (native.prefill_body mirrors this
  // rule), the rest on the scalar body; *body (nullable) says which the
  // rule chose (1: the tensor cores), set before the launch, empty or not
  template <typename T, typename P, typename C>
  int run() const {
    if (page_size % Payload<P>::kPack || n_q % n_kv || d_store < 128 || d_store % 128 ||
        page_stride < 1 || (l == nullptr) != (m == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (std::is_same<T, bf16>::value) {
      if (d_store == 128 && page_size % tc::kPfKeys == 0) {
        const tc::PfArgs a{static_cast<const bf16*>(q), k_pages, v_pages, k_scales, v_scales,
                           tables, meta, static_cast<bf16*>(o), l, m, chunk, n_q, n_kv, d,
                           page_size, n_pages, max_pages, page_stride, window, log2_stride,
                           is_local};
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
                      void* v_pages, void* k_scales, void* v_scales, const void* tables,
                      void* lengths, const void* meta, int chunk, int n_kv,
                      long long head_stride, long long row_stride, int d, int d_store,
                      int page_size, int n_pages, int max_pages, int page_stride, int* body,
                      void* stream) {
  const ChunkWrite f{k, v, k_pages, v_pages, static_cast<float*>(k_scales),
                     static_cast<float*>(v_scales), static_cast<const int*>(tables),
                     static_cast<int*>(lengths), static_cast<const int*>(meta), chunk, n_kv,
                     head_stride, row_stride, d, d_store, page_size, n_pages, max_pages,
                     page_stride, body, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_kv_append(int act, int kv, const void* k, const void* v, void* k_pages, void* v_pages,
                 void* k_scales, void* v_scales, const void* tables, void* lengths,
                 const void* active, const void* glob, int S, int T, int n_kv,
                 long long slot_stride, long long tok_stride, long long head_stride, int d,
                 int d_store, int page_size, int n_pages, int max_pages, int page_stride,
                 int page_offset, int* body, void* stream) {
  const Append f{k, v, k_pages, v_pages, static_cast<float*>(k_scales),
                 static_cast<float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<int*>(lengths), static_cast<const uint8_t*>(active),
                 static_cast<const int*>(glob), S, T, n_kv, slot_stride, tok_stride,
                 head_stride, d, d_store, page_size, n_pages, max_pages, page_stride,
                 page_offset, body, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_paged_decode(int act, int kv, const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales, const void* tables,
                    const void* lengths, const void* glob_lengths, void* o, void* l, void* m,
                    int S, int n_q, int n_kv, int d, int d_store, int page_size, int n_pages,
                    int max_pages, int page_stride, int page_offset, float scale_log2e,
                    int window, int log2_stride, int is_local, void* ws, void* tickets,
                    int splits, int* walk, void* stream) {
  const Decode f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                 static_cast<const float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), static_cast<const int*>(glob_lengths), o,
                 static_cast<float*>(l), static_cast<float*>(m), S, 1, n_q, n_kv, d, d_store,
                 page_size, n_pages, max_pages, page_stride, page_offset, scale_log2e, window,
                 log2_stride, is_local, static_cast<float*>(ws), static_cast<int*>(tickets),
                 splits, walk, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

int fa_paged_multitoken_decode(int act, int kv, const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scales, const void* v_scales,
                               const void* tables, const void* lengths,
                               const void* glob_lengths, void* o, void* l, void* m, int S,
                               int gamma, int n_q, int n_kv, int d, int d_store, int page_size,
                               int n_pages, int max_pages, int page_stride, int page_offset,
                               float scale_log2e, int window, int log2_stride, int is_local,
                               void* ws, void* tickets, int splits, int* walk, void* stream) {
  const Decode f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                 static_cast<const float*>(v_scales), static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), static_cast<const int*>(glob_lengths), o,
                 static_cast<float*>(l), static_cast<float*>(m), S, gamma, n_q, n_kv, d,
                 d_store, page_size, n_pages, max_pages, page_stride, page_offset, scale_log2e,
                 window, log2_stride, is_local, static_cast<float*>(ws),
                 static_cast<int*>(tickets), splits, walk, static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

// The int4 unpack tool's sites (tools/exp_int4_unpack.py) on the decode's
// tensor-core body, each a compiled policy (decode_tc.cuh: the payload, the
// unpack, the merge's cap, the split accumulators): q (B, n_kv, G, 128) bf16
// over K/V pages (n_kv, pages, rows, 128) of int8 (a page rows keys) or of
// int4 pairs (2 rows keys), scales (n_kv, pages, pack, rows).  Every row
// reads all pages: tables (B, pages) the identity and lengths (B,) pages x
// page, int32.  A merge is NPG pages; ws, tickets and splits as the
// decode's (native.exp_int4_plan); walk (3 ints out) as the decode's.
#define FA_TOOL_ENTRY(name, P, UNPACK, NPG, SPLIT)                                              \
  int name(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* o, \
           const void* tables, const void* lengths, void* ws, void* tickets, int B, int n_kv,    \
           int G, int pages, int rows, int splits, float scale_log2e, int* walk, void* stream) { \
    constexpr int pack = Payload<P>::kPack;                                                     \
    const tc::DcArgs a{static_cast<const bf16*>(q), k, v, static_cast<const float*>(ks),         \
                       static_cast<const float*>(vs), static_cast<const int*>(tables),          \
                       static_cast<const int*>(lengths), nullptr, static_cast<bf16*>(o),        \
                       nullptr, nullptr, static_cast<float*>(ws), static_cast<int*>(tickets),   \
                       n_kv * G, n_kv, tc::kDcD, pack * rows, pages, pages, 1, 1, 0,            \
                       scale_log2e, 0, 0, 0, splits, 1, NPG * pack * rows};                     \
    return tc::decode_tc_tool<P, tc::DcPolicy<UNPACK, 256 * NPG, SPLIT, true>>(                 \
        a, B, walk, static_cast<cudaStream_t>(stream));                                         \
  }

FA_TOOL_ENTRY(fa_exp_int4_int8ref, int8_t, tc::kDcPermute, 1, false)
FA_TOOL_ENTRY(fa_exp_int4_s32, int4x2, tc::kDcShift, 1, false)
FA_TOOL_ENTRY(fa_exp_int4_twopage, int4x2, tc::kDcShift, 2, false)
FA_TOOL_ENTRY(fa_exp_int4_fourpage, int4x2, tc::kDcShift, 4, false)
FA_TOOL_ENTRY(fa_exp_int4_int8_2pg, int8_t, tc::kDcPermute, 2, false)
FA_TOOL_ENTRY(fa_exp_int4_bitcast, int4x2, tc::kDcMagic, 1, true)

// exp_decode's paged decode (tools/exp_decode.py) on the decode's
// tensor-core body, variant 0 current (kDcDequant), 1 postscale (the serving
// decode's int8 instantiation), 2 int8mm (kDcS8, one split).  q (S, n_kv G,
// 128) bf16; k_pages, v_pages (n_kv, n_pages, page, 128) int8; scales
// (n_kv, n_pages, page) float32 in either of the tool's layouts (the same
// bytes); tables (S, max_pages), lengths (S,) int32; q_codes, s_int,
// p_codes nullable (int8mm: q codes as q, integer scores and p codes (S,
// n_kv G, max_pages x page)); ws, tickets and splits as the decode's
// (native.exp_decode_plan); walk (3 ints out) as the decode's.
int fa_exp_paged_decode(int variant, const void* q, const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales, const void* tables,
                        const void* lengths, void* o, void* q_codes, void* s_int, void* p_codes,
                        void* ws, void* tickets, int S, int n_kv, int G, int n_pages, int page,
                        int max_pages, int splits, float scale_log2e, int* walk, void* stream) {
  const tc::DcArgs a{static_cast<const bf16*>(q), k_pages, v_pages,
                     static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
                     static_cast<const int*>(tables), static_cast<const int*>(lengths), nullptr,
                     static_cast<bf16*>(o), nullptr, nullptr, static_cast<float*>(ws),
                     static_cast<int*>(tickets), n_kv * G, n_kv, tc::kDcD, page, n_pages,
                     max_pages, 1, 1, 0, scale_log2e, 0, 0, 0, splits, 1, page};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return tc::decode_tc_exp<tc::DcPolicy<tc::kDcDequant, tc::kDcMaxMerge, false>>(
                a, S, walk, st);
    case 1: return tc::decode_tc_exp<tc::DcServing>(a, S, walk, st);
    case 2: return tc::decode_tc_exp<tc::DcPolicy<tc::kDcS8, tc::kDcMaxMerge, false>>(
                tc::DcS8Args{a, static_cast<int8_t*>(q_codes), static_cast<int*>(s_int),
                             static_cast<int8_t*>(p_codes)},
                S, walk, st);
    default: return cudaErrorInvalidValue;
  }
}

int fa_paged_prefill(int act, int kv, const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scales, const void* v_scales, const void* tables,
                     const void* meta, void* o, void* l, void* m, int chunk, int n_q, int n_kv,
                     int d, int d_store, int page_size, int n_pages, int max_pages,
                     int page_stride, int window, int log2_stride, int is_local, int* body,
                     void* stream) {
  const Prefill f{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                  static_cast<const float*>(v_scales), static_cast<const int*>(tables),
                  static_cast<const int*>(meta), o, static_cast<float*>(l),
                  static_cast<float*>(m), chunk, n_q, n_kv, d, d_store, page_size, n_pages,
                  max_pages, page_stride, window, log2_stride, is_local, body,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(act, kv, f);
}

}  // extern "C"
