// The tensor-core body of paged_decode and paged_multitoken_decode for
// Hopper (sm_90a): bf16 activations, head_dim_store 128, pages of 16 or 32
// tokens or of a multiple of 64, every payload (int8, fp8 e4m3 / e5m2, int4
// pairs, the unquantized bf16 cache), gamma 1 and gamma > 1, causal and
// LocalRule windows, and the sequence-sharded form (page stride and offset,
// global lengths, l and m out).  Replaces serving/decode.py::_decode_kernel
// with the scalar body of serving_kernels.cu, which keeps float32
// activations and other stored widths (Decode::run; native.decode_body names
// the body).  Included by serving_kernels.cu after prefill_tc.cuh (Payload,
// the fp8 types, neg_inf, visible, nibble).
//
// What bounds it on this card is memory: a slot's K and V rows are read
// once, D + 4 bytes a key and kv head for a one-byte payload, against 4 D
// flops a key and query row (64 rows at most).  The design:
//   split    a slot's live pages (from its length on the device: no host
//            sync) are cut into `splits` equal runs of whole merge units, one
//            CTA each; grid (splits, kv heads x row groups, slots).  The host
//            fixes `splits` from the grid size alone (two waves of 132 SMs at
//            the CTAs an SM holds, so that slots of unequal lengths even
//            out); a CTA whose run is empty exits at once.
//   rows     every one of the g x gamma query rows of a (slot, kv head), up
//            to 64, in one CTA, padded to row tiles of 16: the pages are read
//            once for all of them.
//   loads    one producer thread copies each 64-key stage with 1-d bulk
//            copies (cp.async.bulk) into a ring of kDcRing items completing
//            on mbarriers: a stage's raw K rows with its K and V scales, then
//            (after the merge's K) its raw V rows.  A page of 16 or 32 keys takes several
//            copies a stage; a stage past the slot's last page copies that
//            page again and is masked.
//   products eight consumer warps.  S = Q K^T by mma.sync m16n8k16 on bf16,
//            each warp 8 keys of a stage for all rows: K fragments come
//            straight from the raw rows, widened in registers (exact: every
//            payload value is a bf16 value; integers by a byte permute into a
//            float's bits, not the conversion unit), the reduction dimension
//            permuted so that a thread reads 16 contiguous bytes and a
//            quarter warp no bank twice; Q is staged in the same order.  O +=
//            P V, each warp 16 output columns: the raw V stage is first
//            widened into a row-major bf16 tile (two, alternating), whose
//            fragments ldmatrix.trans reads.
//   merge    once a page, as the reference, where the rows' scores of a
//            page fit kDcScoreBudget (page <= 512): the page's scores are
//            held in shared memory, then m, l and P = bf16(p x V scale) per
//            row, P in place of the scores, a warp a row; else (64 rows at
//            page 512, pages past 512) and on pages of 16 or 32, once a
//            64-key stage.
//   finish   each CTA writes its float32 (acc, m, l) to a workspace and takes
//            a ticket from its (slot, kv head, row group) counter; the last of
//            the non-empty runs merges all of them in run order (the result
//            is the same bits whatever order the CTAs end in), writes o and
//            l, m where asked, and zeroes the counter.  A single non-empty
//            run writes o itself (the same bits as the merge).
// Measured on the card (PERF.md): the consumers' work on a stage, not the
// bytes, sets the time; the copies alone take a CTA's stages at about
// twice the rate the consumers do.
//
// The experiment tools' decode sites run the same body as compiled
// policies (DcPolicy), never as run-time flags, with entries in
// serving_kernels.cu.  The int4 unpack tool (tools/exp_int4_unpack.py):
//   fa_exp_int4_int8ref  <- kern_int8ref (:69, call :254)       int8 kDcPermute, merges of 256
//   fa_exp_int4_int8_2pg <- kern_int8ref_npg, npg 2 (call :294) int8 kDcPermute, 512 keys
//   fa_exp_int4_s32      <- kern_s32, npg 1 (:92, call :264)    kDcShift, 256
//   fa_exp_int4_twopage  <- kern_s32, npg 2 (call :274)         kDcShift, 512
//   fa_exp_int4_fourpage <- kern_s32, npg 4 (call :284)         kDcShift, 1,024
//   fa_exp_int4_bitcast  <- kern_bitcast (:149, call :314)      kDcMagic, 256, split
// and the paged decode of tools/exp_decode.py (_decode_kernel :35, call
// :159) on the port's int8 cache, a page a merge:
//   postscale   the serving decode's int8 instantiation (DcServing)
//   current     kDcDequant: the serving unpack, then each K and V value times
//               bf16(its key's scale), rounded to bf16 once (a bf16x2
//               multiply: the product of two bf16 values is exact in
//               float32, as the reference's); s takes only the softmax
//               scale and P = bf16(p)
//   int8mm      kDcS8: q and p as int8 codes (the reference's IEEE division
//               and rounding, half to even) and both products on the
//               integer mma.sync m16n8k32 (int32 sums: exact, so any order
//               of d and of keys gives the same scores).  The raw K rows are
//               the B fragments (four consecutive d bytes of a key a
//               register); V is restaged at a 144-byte pitch and read by
//               ldmatrix.trans, whose b16 pairs a byte permute sorts into
//               four keys of one column (a tile's even columns, then its odd
//               ones).  The p codes take each page's running maximum, so a
//               (slot, kv head) walks its pages in order in one CTA.
// The unpack is what the int4 tool measures: kDcPermute (the serving
// decode's, above), kDcShift (kern_s32's: sign-extend the byte, (b << 28)
// >> 28 or b >> 4, the conversion unit) or kDcMagic (the TPU's s4 -> bf16
// convert has no Hopper counterpart: bias by 8, lop3 a nibble pair into the
// low mantissa of the bf16 pair 128.0, 128.0, one bf16x2 subtraction of
// 136).  Every nibble is a bf16 value, so the three are exact and differ in
// time only.  A merge of the int4 tool's sites is npg whole pages (the
// tool's grid step) and a unit of the split.  With split, even and odd keys
// accumulate apart and finish as the tool's runner does (each half divided
// by l and rounded to bf16, the halves summed in bf16): a stage's columns
// hold its 32 even keys, then its 32 odd ones (as its scales lie in the
// ring), so the widened V tile's rows 0-31 feed the even accumulator and
// rows 32-63 the odd one, and a byte row is read once for both.  The tool's
// 16 rows share one K/V: what bounds these sites is the per-stage consumer
// work of the 128 (row, kv head) cells' 16,384 stages (8.9 MB of unique K/V
// for int4, 17.3 MB for int8), not the bytes.

#pragma once

namespace {
namespace tc {

constexpr int kDcKeys = 64;                    // keys a stage
constexpr int kDcRing = 4;                     // items in flight (a stage's K or V)
constexpr int kDcWarps = 8;                    // consumer warps
constexpr int kDcConsumers = 32 * kDcWarps;
constexpr int kDcThreads = kDcConsumers + 32;  // and one producer warp
constexpr int kDcD = 128;                      // head_dim_store
constexpr int kDcRows = 64;                    // query rows a CTA at most
constexpr int kDcQStride = 132;                // bf16 a Q row
constexpr int kDcVStride = 136;                // bf16 a row of the widened V tile
constexpr int kDcMaxMerge = 512;               // keys of a page merge at most (serving)
constexpr int kDcScoreBudget = 72 * 1024;      // the rows' scores of a merge
constexpr int kDcKW = kDcKeys / kDcWarps;      // a warp's keys of a stage's scores
constexpr int kDcKT = kDcKW / 8;               // their n-tiles
constexpr int kDcCW = kDcD / kDcWarps;         // a warp's output columns
constexpr int kDcVT = kDcCW / 8;               // their n-tiles
static_assert(kDcKT >= 1 && kDcVT >= 1, "a warp takes whole n-tiles");

// how the payload enters the products: widened to bf16 (dc_word:
// kDcPermute, kDcShift, kDcMagic; kDcDequant widens as kDcPermute, then
// scales K and V in bf16) or, kDcS8, as raw int8 bytes into integer products
enum DcUnpack { kDcPermute = 0, kDcShift = 1, kDcMagic = 2, kDcDequant = 3, kDcS8 = 4 };

// the compiled policies of an instantiation: the unpack, the keys a merge
// at most (the size of the merge's register row and V scales), whether
// even and odd keys accumulate apart, and the merge rule: the tool's (TOOL,
// the int4 unpack tool's six sites) merge npg whole pages, a unit of the
// split each; the others follow dc_merge_keys, a page a unit
template <int UNPACK, int MAX_MERGE, bool SPLIT, bool TOOL = false>
struct DcPolicy {
  static constexpr int kUnpack = UNPACK, kMaxMerge = MAX_MERGE;
  static constexpr int kWiden = UNPACK == kDcDequant ? kDcPermute : UNPACK;  // dc_word's
  static constexpr bool kSplit = SPLIT, kTool = TOOL;
  static constexpr int kAcc = SPLIT ? 2 : 1;  // accumulators
  static_assert(!SPLIT || TOOL, "the split accumulators are the tool's");
  static_assert(!TOOL || UNPACK <= kDcMagic, "the tool's sites widen");
};
using DcServing = DcPolicy<kDcPermute, kDcMaxMerge, false>;

// floats of a CTA's partial: its accumulators, m and l
template <typename Pol>
__host__ __device__ constexpr int dc_partial() {
  return kDcRows * (Pol::kAcc * kDcD + 2);
}

struct DcArgs {
  const bf16* q;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *tables, *lengths, *glob_lengths;
  bf16* o;
  float *l, *m;
  float* ws;     // (slots, kv heads x row groups, splits) partials (dc_partial)
  int* tickets;  // (slots, kv heads x row groups), zero between launches
  int n_q, n_kv, d, page_size, n_pages, max_pages, gamma, page_stride, page_offset;
  float scale_log2e;
  int window, log2_stride, is_local, splits, row_groups, merge_keys;
};

// kDcS8's kernel argument (exp_decode's int8mm): DcArgs and its outputs,
// nullable: q codes as q; integer scores and p codes (slots, n_q,
// max_pages x page), zero past the live pages.  Every other instantiation
// takes DcArgs alone.
struct DcS8Args : DcArgs {
  int8_t* q_codes;
  int* s_int;
  int8_t* p_codes;
};
template <typename Pol>
using DcArgsOf = typename std::conditional<Pol::kUnpack == kDcS8, DcS8Args, DcArgs>::type;

// the payload bytes of one item (64 keys), and an item's slot in the ring
// (payload, then the stage's 64 K and 64 V scales)
template <typename P>
__host__ __device__ constexpr int dc_payload() {
  return kDcKeys / Payload<P>::kPack * kDcD * static_cast<int>(sizeof(P));
}
template <typename P>
__host__ __device__ constexpr int dc_slot() {
  return dc_payload<P>() + 2 * kDcKeys * 4;
}

// keys a merge of `rows` query rows (native.decode_merge_keys mirrors this
// rule)
__host__ __device__ inline int dc_merge_keys(int page_size, int rows) {
  const bool page_merge = page_size >= kDcKeys && page_size <= kDcMaxMerge &&
                          rows * (page_size + 4) * 4 <= kDcScoreBudget;
  return page_merge ? page_size : kDcKeys;
}

// shared memory of a CTA of `rows` query rows (native.decode_tc_smem and
// native._dc_smem mirror it): the ring, Q (rows padded to 16), two widened V
// tiles, the rows' scores (stride merge + 4 floats), the V scales of a
// merge, m, l and alpha a padded row, the barriers and the ticket flag
template <typename P, typename Pol = DcServing>
inline int dc_smem(int rows, int merge) {
  const int padded = (rows + 15) / 16 * 16;
  return kDcRing * dc_slot<P>() + padded * kDcQStride * 2 + 2 * kDcKeys * kDcVStride * 2 +
         rows * (merge + 4) * 4 + Pol::kMaxMerge * 4 + 3 * padded * 4 + 2 * kDcRing * 8 + 16;
}

// the physical dimension of logical k 2t (k-step ks, thread t = lane % 4):
// k 2t, 2t + 1, 2t + 8, 2t + 9 are the four contiguous dimensions from here
__device__ __forceinline__ int dc_dim(int ks, int t) {
  return (ks >> 2) * 64 + 16 * t + 4 * (ks & 3);
}

// kDcMagic's pair: the nibbles (biased by 8) in the low bits of each half
// of x into the low mantissa of bf16 128.0 (one lop3: (x & 0xF) | 128.0),
// then 136 off both halves (one bf16x2 subtraction): the signed values
__device__ __forceinline__ uint32_t dc_magic_pair(uint32_t x) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;" : "=r"(r) : "r"(x), "r"(0x000F000Fu), "r"(0x43004300u));
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kDcDequant: a bf16 pair times a bf16 pair, each product rounded to bf16
// once (the product of two bf16 values is exact in float32)
__device__ __forceinline__ uint32_t dc_mul_bf16x2(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// a one-byte payload word's four values (bytes 0-3) as two bf16 pairs,
// (0, 1) in lo and (2, 3) in hi, exact (every payload value is a bf16
// value); int4: the nibbles of key parity `odd`.  kDcPermute: integers go
// without the conversion unit: byte u (0-255, the value offset to be
// unsigned) under the bits of 1.5 x 2^23 (one byte permute), the offset
// then subtracted.  kDcShift and kDcMagic: the tool's int4 methods.
template <typename P, int UNPACK = kDcPermute>
__device__ __forceinline__ void dc_word(uint32_t wd, int odd, uint32_t& lo, uint32_t& hi) {
  static_assert(UNPACK == kDcPermute || Payload<P>::kPack == 2, "the tool's methods are int4's");
  if constexpr (UNPACK == kDcShift) {
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = static_cast<int>(wd << (24 - 8 * k)) >> 24;
      f[k] = static_cast<float>(odd ? b >> 4 : (b << 28) >> 28);
    }
    lo = pack2<bf16>(f[0], f[1]);
    hi = pack2<bf16>(f[2], f[3]);
  } else if constexpr (UNPACK == kDcMagic) {
    const uint32_t y = (odd ? wd >> 4 : wd) ^ 0x08080808u;
    lo = dc_magic_pair(__byte_perm(y, 0, 0x4140));  // bytes 0, 1 in the halves' low bytes
    hi = dc_magic_pair(__byte_perm(y, 0, 0x4342));  // bytes 2, 3
  } else if constexpr (std::is_same<P, int8_t>::value || Payload<P>::kPack == 2) {
    uint32_t u;
    float off;
    if constexpr (Payload<P>::kPack == 2) {  // nibbles: 4-bit two's complement
      u = ((odd ? wd >> 4 : wd) & 0x0F0F0F0Fu) ^ 0x08080808u;
      off = 12582912.f + 8.f;
    } else {
      u = wd ^ 0x80808080u;
      off = 12582912.f + 128.f;
    }
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7640 | k)) - off;
    lo = pack2<bf16>(f[0], f[1]);
    hi = pack2<bf16>(f[2], f[3]);
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        std::is_same<P, fp8e4m3>::value ? __NV_E4M3 : __NV_E5M2;
    const float2 a = __half22float2(__half2(
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(wd & 0xFFFF), kind)));
    const float2 b = __half22float2(__half2(
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(wd >> 16), kind)));
    lo = pack2<bf16>(a.x, a.y);
    hi = pack2<bf16>(b.x, b.y);
  }
}

// four 8 x 8 bf16 matrices from shared memory, transposed (ldmatrix): lane
// l gives a row address of matrix l / 8 and gets rows 2 (l % 4), + 1 of
// column l / 4 of each, the B fragments of a row-major k x n tile
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// the split finish (the tool's de-interleave): each half over l rounded to
// bf16, the halves summed and rounded
__device__ __forceinline__ bf16 dc_halves(float even, float odd, float div) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(even / div)) +
                          __bfloat162float(__float2bfloat16(odd / div)));
}

// ---- kDcS8 (exp_decode's int8mm): the integer path's steps, each called
// where the widened path does its own ----

// bytes a row of q codes, and the V tile restaged for ldmatrix (a 144-byte
// pitch puts a matrix's eight key rows on eight bank groups)
constexpr int kDcQ8Stride = 136;
constexpr int kDcV8Stride = 144;
static_assert(16 * kDcQ8Stride + 2 * 16 * 4 <= 16 * kDcQStride * 2, "codes and scales in Q's room");
static_assert(kDcKeys * kDcV8Stride <= kDcKeys * kDcVStride * 2, "the restaged tile in V's room");

// one warp's D += A B on int8 (mma.sync m16n8k32, int32 sums): lane l holds
// a0 (row l/4, k 4(l%4) + {0..3}), a1 (row l/4 + 8), a2 and a3 (k + 16);
// b0 (k 4(l%4) + {0..3}, column l/4) and b1 (k + 16); d as mma_16816's
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the byte of a 32-key step's p code row that holds key k (0-31), so that
// a0 (and a2) of lane t are four contiguous bytes: keys 2t, 2t + 1, 8 + 2t,
// 9 + 2t (and 16 on), the keys ldmatrix.trans gives lane t's column in its
// four matrices' b16 pairs
__device__ __forceinline__ int dc_s8_pos(int k) {
  return (k & 16) | ((k & 6) << 1) | ((k & 8) >> 2) | (k & 1);
}

// the q codes of rows w, w + 8, .. below `rows`, a warp a row, as the scalar
// body's: qs = max |q| / 127 (IEEE, 1 where 0), codes rint(q / qs), four
// columns a lane (d 128), written out where asked; rows from R on: codes 0,
// qs 1.  With Qc, staged: a row's codes at kDcQ8Stride, its qs in qs_sh.
template <typename QIndex>
__device__ __forceinline__ void dc_s8_q_codes(const DcS8Args& a, QIndex q_index, int R, int rows,
                                              int w, int lane, unsigned char* Qc, float* qs_sh) {
  for (int r = w; r < rows; r += kDcWarps) {
    float qs = 1.f;
    uint32_t word = 0;
    if (r < R) {
      const uint2 raw = *reinterpret_cast<const uint2*>(a.q + q_index(r) + 4 * lane);
      const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      const float f[4] = {f01.x, f01.y, f23.x, f23.y};
      const float amax =
          warp_max(fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))));
      qs = __fdiv_rn(amax, 127.f);
      qs = qs == 0.f ? 1.f : qs;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= (static_cast<uint32_t>(static_cast<int>(rintf(__fdiv_rn(f[e], qs)))) & 0xFFu)
                << (8 * e);
      if (a.q_codes != nullptr)
        *reinterpret_cast<uint32_t*>(a.q_codes + q_index(r) + 4 * lane) = word;
    }
    if (Qc != nullptr) {
      *reinterpret_cast<uint32_t*>(Qc + r * kDcQ8Stride + 4 * lane) = word;
      if (lane == 0) qs_sh[r] = qs;
    }
  }
}

// the rows' q code fragments, held throughout (k-step ks is d 32 t + 8 ks
// .. + 7 of lane t: a0 the first four, a2 the next, an order the K
// fragments share), and their q scales
__device__ __forceinline__ void dc_s8_q_frags(const unsigned char* Qc, const float* qs_sh, int gq,
                                              int t, uint32_t (&qa)[4][4], float (&qs)[2]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint2 lo = *reinterpret_cast<const uint2*>(Qc + gq * kDcQ8Stride + 32 * t + 8 * ks);
    const uint2 hi = *reinterpret_cast<const uint2*>(Qc + (gq + 8) * kDcQ8Stride + 32 * t + 8 * ks);
    qa[ks][0] = lo.x;
    qa[ks][1] = hi.x;
    qa[ks][2] = lo.y;
    qa[ks][3] = hi.y;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) qs[h] = qs_sh[gq + 8 * h];
}

// a key's K fragments (k-steps 0-3): its raw bytes are the B fragments, d
// 32 t .. + 31, the halves in another order on odd keys (a quarter warp's
// two rows, 128 bytes apart, on other banks)
__device__ __forceinline__ void dc_s8_k_frags(const unsigned char* row, int t, int par,
                                              uint32_t (&bf)[8][2]) {
  const uint4 u0 = *reinterpret_cast<const uint4*>(row + 32 * t + 16 * par);
  const uint4 u1 = *reinterpret_cast<const uint4*>(row + 32 * t + 16 * (par ^ 1));
  const uint4 x0 = par ? u1 : u0, x1 = par ? u0 : u1;
  const uint32_t wd[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    bf[ks][0] = wd[2 * ks];
    bf[ks][1] = wd[2 * ks + 1];
  }
}

// a stage's integer scores of the warp's keys, and s = si x ((qs x ks) x
// c) in the scalar body's order, each product rounded (no contraction),
// into the rows' score rows at Ss (the warp's first key of the stage) and,
// where asked, into s_int at the keys' places in the slot's pages (key0:
// the warp's first)
template <typename QIndex>
__device__ __forceinline__ void dc_s8_scores(const DcS8Args& a, QIndex q_index,
                                             const uint32_t (&qa)[4][4],
                                             const uint32_t (&bf)[kDcKT][8][2],
                                             const float (&kscale)[kDcKT][2], const float (&qs)[2],
                                             const int (&q_pos)[2], int kv0, int key0, float* Ss,
                                             int SST, int R, int gq, int t, size_t t_total) {
  int si[kDcKT][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nt = 0; nt < kDcKT; ++nt)
      mma_16832_s8(si[nt], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], bf[nt][ks][0],
                   bf[nt][ks][1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int nt = 0; nt < kDcKT; ++nt) {
      float2 v;
      const int kp = kv0 + 8 * nt + 2 * t;
      v.x = visible(q_pos[h], kp, a.window, a.log2_stride, a.is_local)
                ? __fmul_rn(static_cast<float>(si[nt][2 * h]),
                            __fmul_rn(__fmul_rn(qs[h], kscale[nt][0]), a.scale_log2e))
                : neg_inf();
      v.y = visible(q_pos[h], kp + 1, a.window, a.log2_stride, a.is_local)
                ? __fmul_rn(static_cast<float>(si[nt][2 * h + 1]),
                            __fmul_rn(__fmul_rn(qs[h], kscale[nt][1]), a.scale_log2e))
                : neg_inf();
      *reinterpret_cast<float2*>(Ss + r * SST + 8 * nt + 2 * t) = v;
      if (a.s_int != nullptr)
        *reinterpret_cast<int2*>(a.s_int + q_index(r) / a.d * t_total + key0 + 8 * nt + 2 * t) =
            make_int2(si[nt][2 * h], si[nt][2 * h + 1]);
    }
  }
}

// one row's merge of its held scores x (U keys): p = 2^(s - m_next), y =
// p x V scale, the row's p scale ps = max y / 127 (IEEE, 1 where 0) and its
// p codes rint(y / ps), in place over the row (a code a byte, dc_s8_pos's
// order) and, where asked, at out.  Returns the lane's sum of p.
template <int N>
__device__ __forceinline__ float dc_s8_p_codes(float (&x)[N], int U, bool alive, float m_next,
                                               const float* vs, int lane, float* row, int8_t* out,
                                               float& pscale) {
  float lsum = 0.f, ymax = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (32 * i < U) {
      const float p = alive ? exp2f(__fsub_rn(x[i], m_next)) : 0.f;
      lsum += p;
      x[i] = __fmul_rn(p, vs[lane + 32 * i]);
      ymax = fmaxf(ymax, x[i]);
    }
  ymax = warp_max(ymax);
  pscale = __fdiv_rn(ymax, 127.f);
  pscale = pscale == 0.f ? 1.f : pscale;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (32 * i < U) {
      const int8_t code = static_cast<int8_t>(static_cast<int>(rintf(__fdiv_rn(x[i], pscale))));
      reinterpret_cast<int8_t*>(row)[32 * i + dc_s8_pos(lane)] = code;
      if (out != nullptr) out[32 * i + lane] = code;
    }
  return lsum;
}

// P V of one stage into the integer sums pv: the raw V rows (vb) restaged
// at kDcV8Stride in t8 (a unit a key and 16 bytes: a quarter warp reads
// and writes 128 in a row), the ring item released (done), then for each
// 32-key step ldmatrix.trans of four 8-key matrices of the warp's 16
// columns: lane t of column pair gq gets keys 2t, 2t + 1 (+ 8 i in matrix
// i) of columns 16 w + 2 gq and + 1, and the permutes sort them into the
// even column's four keys and the odd one's.  P is the rows' p codes of the
// stage (pc: row 0's, a row pitch bytes on; rows from R on: 0).
__device__ __forceinline__ void dc_s8_pv_stage(const unsigned char* vb, unsigned char* t8,
                                               uint64_t* done, const unsigned char* pc, int pitch,
                                               int R, int tid, int w, int lane, int gq, int t,
                                               int (&pv)[kDcVT][4]) {
#pragma unroll
  for (int u2 = 0; u2 < kDcKeys * 8 / kDcConsumers; ++u2) {
    const int u = tid + kDcConsumers * u2, c16 = u & 7, key = u >> 3;
    *reinterpret_cast<uint4*>(t8 + key * kDcV8Stride + 16 * c16) =
        *reinterpret_cast<const uint4*>(vb + key * kDcD + 16 * c16);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(done);
  named_sync(1, kDcConsumers);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t x[4];
    ldsm_x4_trans(t8 + (32 * kk + 8 * (lane >> 3) + (lane & 7)) * kDcV8Stride + kDcCW * w, x[0],
                  x[1], x[2], x[3]);
    const uint32_t vf[kDcVT][2] = {
        {__byte_perm(x[0], x[1], 0x6420), __byte_perm(x[2], x[3], 0x6420)},
        {__byte_perm(x[0], x[1], 0x7531), __byte_perm(x[2], x[3], 0x7531)}};
    const unsigned char* p0 = pc + gq * pitch + 32 * kk + 4 * t;
    const unsigned char* p1 = p0 + 8 * pitch;
    const uint32_t a0 = gq < R ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    const uint32_t a2 = gq < R ? *reinterpret_cast<const uint32_t*>(p0 + 16) : 0u;
    const uint32_t a1 = gq + 8 < R ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    const uint32_t a3 = gq + 8 < R ? *reinterpret_cast<const uint32_t*>(p1 + 16) : 0u;
#pragma unroll
    for (int nt = 0; nt < kDcVT; ++nt) mma_16832_s8(pv[nt], a0, a1, a2, a3, vf[nt][0], vf[nt][1]);
  }
}

// the merge's end: acc += float(P V's integer sums) x the row's p scale, as
// the scalar body (n-tile 0 holds the warp's even columns, 1 its odd ones)
__device__ __forceinline__ void dc_s8_add_pv(float (&acc)[kDcVT][4], const int (&pv)[kDcVT][4],
                                             const float* ps_sh, int gq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float pscale = ps_sh[gq + 8 * h];
#pragma unroll
    for (int nt = 0; nt < kDcVT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[nt][2 * h + e] += __fmul_rn(static_cast<float>(pv[nt][2 * h + e]), pscale);
  }
}

// one row tile of a one-byte payload: two CTAs an SM (288 threads of at
// most 112 registers); the bf16 cache (whose body a cap spills) or more
// rows: one
template <typename P, int RT, typename Pol = DcServing>
__global__ void __launch_bounds__(kDcThreads, RT == 1 && sizeof(P) == 1 ? 2 : 1)
    decode_tc_kernel(const __grid_constant__ DcArgsOf<Pol> a) {
  constexpr int PACK = Payload<P>::kPack;
  constexpr bool QUANT = Payload<P>::kQuant;
  constexpr bool WIDE = sizeof(P) == 2;  // the bf16 cache: 256-byte rows
  constexpr bool SPLIT = Pol::kSplit;    // a stage's columns: its even keys, then its odd ones
  constexpr bool DEQ = Pol::kUnpack == kDcDequant;  // K and V scaled in bf16
  constexpr bool S8 = Pol::kUnpack == kDcS8;        // integer products
  static_assert(!(DEQ || S8) || (std::is_same<P, int8_t>::value && RT == 1),
                "exp_decode's policies: int8, one row tile");
  static_assert(!S8 || Pol::kMaxMerge <= kDcMaxMerge, "kDcS8 holds a merge's row in registers");
  constexpr int RP = 16 * RT;
  constexpr int PAYLOAD = dc_payload<P>(), SLOT = dc_slot<P>(), PART = dc_partial<Pol>();
  constexpr int ML = Pol::kAcc * kDcRows * kDcD;  // m and l in a partial
  static_assert(!SPLIT || (PACK == 2 && RT == 1), "the split accumulators: int4, one row tile");
  constexpr int ROW = kDcD * static_cast<int>(sizeof(P));  // bytes a stored row
  extern __shared__ __align__(128) unsigned char smem[];
  const int U = a.merge_keys, SST = U + 4;
  const int g = a.n_q / a.n_kv, SR = min(g * a.gamma, kDcRows);  // rows of stored scores
  unsigned char* ring = smem;
  bf16* Qs = reinterpret_cast<bf16*>(ring + kDcRing * SLOT);
  bf16* Vt = Qs + RP * kDcQStride;  // two tiles of kDcKeys rows of kDcVStride
  float* Ss = reinterpret_cast<float*>(Vt + 2 * kDcKeys * kDcVStride);
  float* vs_sh = Ss + SR * SST;
  float* m_sh = vs_sh + Pol::kMaxMerge;
  float* l_sh = m_sh + RP;
  float* al_sh = l_sh + RP;
  uint64_t* full = reinterpret_cast<uint64_t*>(al_sh + RP);
  uint64_t* empty = full + kDcRing;
  int* flag = reinterpret_cast<int*>(empty + kDcRing);

  const int split = blockIdx.x, hk = blockIdx.y / a.row_groups, b = blockIdx.z;
  const int r0 = blockIdx.y % a.row_groups * kDcRows;
  const int R = min(g * a.gamma - r0, kDcRows);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // q, o (S, gamma, n_q, d): CTA row r is row r0 + r of the group, draft
  // (r0 + r) % gamma of q head hk g + (r0 + r) / gamma
  auto q_index = [&](int r) {
    const int gr = r0 + r;
    return ((static_cast<size_t>(b) * a.gamma + gr % a.gamma) * a.n_q + hk * g + gr / a.gamma) *
           a.d;
  };

  // the slot's live pages [first, count) from its local length; positions
  // from the global one (decode.py:_first_live_page)
  const int ps = a.page_size, len = a.lengths[b];
  const int glen = a.glob_lengths ? a.glob_lengths[b] : len;
  const int count = (len + ps - 1) / ps;
  int first = 0;
  if (a.is_local) {
    const int gfp = max(0, glen - a.gamma - ((a.window << a.log2_stride) - 1)) / ps;
    first = a.page_stride == 1 ? gfp
            : (gfp > a.page_offset ? (gfp - a.page_offset + a.page_stride - 1) / a.page_stride
                                   : 0);
  }
  // stages: a page of >= 64 keys is spp stages and a unit of the split; a
  // stage of pages of 16 or 32 is ppst pages and a unit; the tool's unit is
  // a merge of U / ps whole pages, spu stages
  const int spp = ps >= kDcKeys ? ps / kDcKeys : 1, ppst = ps >= kDcKeys ? 1 : kDcKeys / ps;
  const int live = max(0, count - first);
  int units, spu = spp;
  if constexpr (Pol::kTool) {
    units = (live + U / ps - 1) / (U / ps);
    spu = U / kDcKeys;
  } else {
    units = ps >= kDcKeys ? live : (live + ppst - 1) / ppst;
  }
  const int per = (units + a.splits - 1) / a.splits;
  const int runs = per ? (units + per - 1) / per : 0;  // non-empty runs
  if (split >= max(runs, 1)) return;
  if (runs == 0) {  // no local page: o = 0, l = 0, m = NEG_INF (kDcS8: the q codes still)
    if constexpr (S8)
      if (w < kDcWarps) dc_s8_q_codes(a, q_index, R, R, w, lane, nullptr, nullptr);
    for (int i = tid; i < R * a.d; i += kDcThreads) a.o[q_index(i / a.d) + i % a.d] = __float2bfloat16(0.f);
    if (a.l != nullptr)
      for (int r = tid; r < R; r += kDcThreads) {
        a.l[q_index(r) / a.d] = 0.f;
        a.m[q_index(r) / a.d] = neg_inf();
      }
    return;
  }
  const int s0 = split * per * spu, s1 = min(split * per + per, units) * spu;
  const int mg = U / kDcKeys;  // stages a merge (divides the run)

  if (tid == 0) {
    for (int s = 0; s < kDcRing; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kDcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage s, piece i (of ppst): its local page and first key in the page
  auto page_of = [&](int s, int i) { return ps >= kDcKeys ? first + s / spp : first + s * ppst + i; };
  auto key0_of = [&](int s) { return ps >= kDcKeys ? (s % spp) * kDcKeys : 0; };

  if (w == kDcWarps) {  // ---- the producer ----
    if (lane != 0) return;
    const int pt = min(ps, kDcKeys);  // keys a piece
    const uint32_t piece_bytes = pt / PACK * ROW;
    int it = 0;
    for (int sg = s0; sg < s1; sg += mg) {
      for (int kv = 0; kv < 2; ++kv) {
        for (int j = 0; j < mg; ++j, ++it) {
          const int st = it % kDcRing, s = sg + j;
          if (it >= kDcRing) mbar_wait(empty + st, ((it / kDcRing) & 1) ^ 1);
          unsigned char* dst = ring + st * SLOT;
          mbar_expect_tx(full + st, PAYLOAD + (QUANT && kv == 0 ? 2 * kDcKeys * 4 : 0));
          const unsigned char* pages =
              static_cast<const unsigned char*>(kv ? a.v_pages : a.k_pages);
          for (int i = 0; i < ppst; ++i) {
            const int lp = min(page_of(s, i), count - 1), t0 = key0_of(s);
            const int phys = a.tables[b * a.max_pages + lp % a.max_pages];
            const size_t page = static_cast<size_t>(hk) * a.n_pages + phys;
            bulk_load(dst + i * piece_bytes,
                      pages + (page * (ps / PACK) + t0 / PACK) * ROW, piece_bytes, full + st);
            if (QUANT && kv == 0) {
              float* sc = reinterpret_cast<float*>(dst + PAYLOAD) + i * pt;
              for (int u = 0; u < 2; ++u) {
                const float* src = (u ? a.v_scales : a.k_scales) + page * ps;
                if (PACK == 1) {
                  bulk_load(sc + u * kDcKeys, src + t0, pt * 4, full + st);
                } else {  // even tokens' scales, then odd ones'
                  bulk_load(sc + u * kDcKeys, src + t0 / 2, pt * 2, full + st);
                  bulk_load(sc + u * kDcKeys + pt / 2, src + ps / 2 + t0 / 2, pt * 2, full + st);
                }
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warps ----
  const int gq = lane >> 2, t = lane & 3, par = gq & 1;
  // kDcS8: Q's room holds the rows' int8 codes, then their q and p scales
  unsigned char* Qc = reinterpret_cast<unsigned char*>(Qs);
  float* qs_sh = reinterpret_cast<float*>(Qc + RP * kDcQ8Stride);
  float* ps_sh = qs_sh + RP;
  if constexpr (S8) {
    dc_s8_q_codes(a, q_index, R, RP, w, lane, Qc, qs_sh);
  } else {
    for (int i = tid; i < RP * kDcD; i += kDcConsumers) {
      const int r = i / kDcD, c = i % kDcD;
      Qs[r * kDcQStride + c] = r < R && c < a.d ? a.q[q_index(r) + c] : __float2bfloat16(0.f);
    }
  }
  for (int r = tid; r < RP; r += kDcConsumers) {
    m_sh[r] = neg_inf();
    l_sh[r] = 0.f;
    al_sh[r] = 1.f;
  }
  named_sync(1, kDcConsumers);
  // a scale per key and the rows' positions
  const int pt = min(ps, kDcKeys), lpt = 31 - __clz(pt);  // keys a piece: 16, 32 or 64
  int q_pos[RT][2];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) q_pos[rt][h] = glen - a.gamma + (r0 + 16 * rt + gq + 8 * h) % a.gamma;

  float acc[RT][kDcVT][4];
  float acc_odd[SPLIT ? RT : 1][kDcVT][4];  // SPLIT: the odd keys'
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int nt = 0; nt < kDcVT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[rt][nt][e] = 0.f;
        if constexpr (SPLIT) acc_odd[rt][nt][e] = 0.f;
      }
  uint32_t qa8[4][4];  // kDcS8: the rows' q code fragments and q scales
  float qsr[2];
  if constexpr (S8) dc_s8_q_frags(Qc, qs_sh, gq, t, qa8, qsr);
  const size_t t_total = static_cast<size_t>(a.max_pages) * ps;  // kDcS8: a code row's keys

  int it = 0, vt = 0;
  for (int sg = s0; sg < s1; sg += mg) {
    // -- scores of the merge's stages: this warp's kDcKW keys of each --
    for (int j = 0; j < mg; ++j, ++it) {
      const int st = it % kDcRing, s = sg + j;
      mbar_wait(full + st, (it / kDcRing) & 1);
      const unsigned char* kb = ring + st * SLOT;
      const float* ksc = reinterpret_cast<const float*>(kb + PAYLOAD);
      // key k's scale in the item: int4 pieces hold the even tokens' first
      // (SPLIT: column k's is the item's k-th, the columns lie so)
      auto scale_at = [&](int k) {
        if constexpr (SPLIT) return k;
        const int ki = k & (pt - 1);
        return PACK == 2 ? k - ki + (ki & 1) * (pt >> 1) + (ki >> 1) : k;
      };
      const int k0 = kDcKW * w;  // this warp's first key (SPLIT: column) of the stage
      if (QUANT && lane < kDcKW)  // the V scales of this warp's keys, for the merge
        vs_sh[j * kDcKeys + k0 + lane] = ksc[kDcKeys + scale_at(k0 + lane)];
      // this warp's keys lie in one piece (pt >= 16): the position of its
      // first; this thread's are KS (8 nt + 2 t + e) on from it.  SPLIT
      // (pages of >= 64 keys): column c is key 2 (c % 32) + c / 32
      constexpr int KS = SPLIT ? 2 : 1;
      int kv0;
      if constexpr (SPLIT)
        kv0 = (page_of(s, 0) * a.page_stride + a.page_offset) * ps + key0_of(s) +
              2 * (k0 & 31) + (k0 >> 5);
      else
        kv0 = (page_of(s, k0 >> lpt) * a.page_stride + a.page_offset) * ps + key0_of(s) +
              (k0 & (pt - 1));
      float mul[kDcKT][2];  // kDcS8: the key's scale alone
#pragma unroll
      for (int nt = 0; nt < kDcKT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (S8)
            mul[nt][e] = ksc[scale_at(k0 + 8 * nt + 2 * t + e)];
          else
            mul[nt][e] = QUANT && !DEQ ? ksc[scale_at(k0 + 8 * nt + 2 * t + e)] * a.scale_log2e
                                       : a.scale_log2e;
        }
      uint32_t bf[kDcKT][8][2];  // K fragments: n-tile, k-step, register (kDcS8: 4 k-steps)
#pragma unroll
      for (int nt = 0; nt < kDcKT; ++nt) {
        const int key = k0 + 8 * nt + gq;
        // SPLIT: column key is byte row key % 32's nibble key / 32
        const unsigned char* row = kb + (SPLIT ? key & 31 : PACK == 2 ? key >> 1 : key) * ROW;
        const int nib = SPLIT ? k0 >> 5 : par;
        if constexpr (S8) {
          dc_s8_k_frags(row, t, par, bf[nt]);
        } else if constexpr (WIDE) {
          // the halves in another order on odd keys: a quarter warp's two
          // rows (256 bytes apart) on other banks
          uint4 x[2][2];
#pragma unroll
          for (int grp = 0; grp < 2; ++grp) {
            const unsigned char* at = row + grp * 128 + 32 * t;
            const uint4 u0 = *reinterpret_cast<const uint4*>(at + 16 * par);
            const uint4 u1 = *reinterpret_cast<const uint4*>(at + 16 * (par ^ 1));
            x[grp][0] = par ? u1 : u0;
            x[grp][1] = par ? u0 : u1;
          }
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const uint4 v = x[ks >> 2][(ks >> 1) & 1];
            bf[nt][ks][0] = (ks & 1) ? v.z : v.x;
            bf[nt][ks][1] = (ks & 1) ? v.w : v.y;
          }
        } else {
          // the groups in another order on odd keys: a quarter warp's two
          // rows (128 bytes apart) on other banks
          const uint4 u0 = *reinterpret_cast<const uint4*>(row + 64 * par + 16 * t);
          const uint4 u1 = *reinterpret_cast<const uint4*>(row + 64 * (par ^ 1) + 16 * t);
          const uint4 x[2] = {par ? u1 : u0, par ? u0 : u1};
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const uint4 v = x[ks >> 2];
            const uint32_t wd = (ks & 3) == 0 ? v.x : (ks & 3) == 1 ? v.y : (ks & 3) == 2 ? v.z : v.w;
            dc_word<P, Pol::kWiden>(wd, nib, bf[nt][ks][0], bf[nt][ks][1]);
          }
          if constexpr (DEQ) {  // bf16(k) x bf16(its scale), rounded once
            const uint32_t s2 = pack2<bf16>(ksc[scale_at(key)], ksc[scale_at(key)]);
#pragma unroll
            for (int ks = 0; ks < 8; ++ks) {
              bf[nt][ks][0] = dc_mul_bf16x2(bf[nt][ks][0], s2);
              bf[nt][ks][1] = dc_mul_bf16x2(bf[nt][ks][1], s2);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // K rows and scales are in registers
      if constexpr (S8) {
        dc_s8_scores(a, q_index, qa8, bf, mul, qsr, q_pos[0], kv0,
                     page_of(s, 0) * ps + key0_of(s) + k0, Ss + j * kDcKeys + k0, SST, R, gq, t,
                     t_total);
      } else {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          float sc[kDcKT][4] = {};
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const bf16* qa = Qs + (16 * rt + gq) * kDcQStride + dc_dim(ks, t);
            const uint2 lo = *reinterpret_cast<const uint2*>(qa);
            const uint2 hi = *reinterpret_cast<const uint2*>(qa + 8 * kDcQStride);
#pragma unroll
            for (int nt = 0; nt < kDcKT; ++nt)
              mma_16816(sc[nt], lo.x, hi.x, lo.y, hi.y, bf[nt][ks][0], bf[nt][ks][1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * rt + gq + 8 * h;
            if (r >= R) continue;
#pragma unroll
            for (int nt = 0; nt < kDcKT; ++nt) {
              float2 v;
              const int kp = kv0 + KS * (8 * nt + 2 * t);
              v.x = visible(q_pos[rt][h], kp, a.window, a.log2_stride, a.is_local)
                        ? sc[nt][2 * h] * mul[nt][0] : neg_inf();
              v.y = visible(q_pos[rt][h], kp + KS, a.window, a.log2_stride, a.is_local)
                        ? sc[nt][2 * h + 1] * mul[nt][1] : neg_inf();
              *reinterpret_cast<float2*>(Ss + r * SST + j * kDcKeys + k0 + 8 * nt + 2 * t) = v;
            }
          }
        }
      }
    }
    named_sync(1, kDcConsumers);
    // -- the merge: m, l and P = bf16(p x V scale) in place, a warp a row
    // (every float of a row is read before its bf16 P is written over the
    // row's first half: P of keys 32 i.. lies on floats 16 i.., which the
    // warp read at step i / 2).  Up to 512 keys the row is held in
    // registers; past that (the tool's 1,024) it is read twice, so that the
    // body keeps its registers.  kDcDequant: P = bf16(p).  kDcS8: y = p x V
    // scale, the row's p scale ps = max y / 127 (IEEE, 1 where 0) and its p
    // codes rint(y / ps), in place (a code a byte, dc_s8_pos's order) --
    constexpr bool HOLD = Pol::kMaxMerge <= kDcMaxMerge;
    for (int r = w; r < R; r += kDcWarps) {
      float* row = Ss + r * SST;
      float x[HOLD ? Pol::kMaxMerge / 32 : 1];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < Pol::kMaxMerge / 32; ++i)
        if (32 * i < U) {
          const float xi = row[lane + 32 * i];
          if constexpr (HOLD) x[i] = xi;
          mx = fmaxf(mx, xi);
        }
      mx = warp_max(mx);
      const float m_prev = m_sh[r], m_next = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_next);
      const bool alive = m_next > neg_inf() * 0.5f;  // a row with no visible key yet
      float lsum = 0.f;
      __syncwarp();
      if constexpr (S8) {
        // a merge is a page: its codes' place in the slot's pages
        int8_t* out = a.p_codes == nullptr ? nullptr
                      : a.p_codes + q_index(r) / a.d * t_total + page_of(sg, 0) * ps;
        float pscale;
        lsum = dc_s8_p_codes(x, U, alive, m_next, vs_sh, lane, row, out, pscale);
        if (lane == 0) ps_sh[r] = pscale;
      } else {
#pragma unroll
        for (int i = 0; i < Pol::kMaxMerge / 32; ++i)
          if (32 * i < U) {
            const int k = lane + 32 * i;
            float xi;
            if constexpr (HOLD) {
              xi = x[i];
            } else {
              xi = row[k];
              __syncwarp();  // the warp's step-i floats are read before any P lands on them
            }
            const float p = alive ? exp2f(xi - m_next) : 0.f;
            lsum += p;
            reinterpret_cast<bf16*>(row)[k] = __float2bfloat16(QUANT && !DEQ ? p * vs_sh[k] : p);
          }
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        m_sh[r] = m_next;
        l_sh[r] = alpha * l_sh[r] + lsum;
        al_sh[r] = alpha;
      }
    }
    named_sync(1, kDcConsumers);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float alpha = al_sh[16 * rt + gq + 8 * h];
#pragma unroll
        for (int nt = 0; nt < kDcVT; ++nt) {
          acc[rt][nt][2 * h] *= alpha;
          acc[rt][nt][2 * h + 1] *= alpha;
          if constexpr (SPLIT) {
            acc_odd[rt][nt][2 * h] *= alpha;
            acc_odd[rt][nt][2 * h + 1] *= alpha;
          }
        }
      }
    // -- O += P V over the merge's stages (kDcS8: integer sums of the merge,
    // then acc += float(sum) x ps, as the scalar body) --
    int pv8[kDcVT][4] = {};
    for (int j = 0; j < mg; ++j, ++it, ++vt) {
      const int st = it % kDcRing;
      mbar_wait(full + st, (it / kDcRing) & 1);
      const unsigned char* vb = ring + st * SLOT;
      bf16* vtile = Vt + (vt & 1) * kDcKeys * kDcVStride;
      if constexpr (S8) {
        dc_s8_pv_stage(vb, reinterpret_cast<unsigned char*>(vtile), empty + st,
                       reinterpret_cast<const unsigned char*>(Ss) + j * kDcKeys, SST * 4, R, tid,
                       w, lane, gq, t, pv8);
      } else {
        // widen the stage's V rows to a row-major bf16 tile: a unit is a key
        // and 16 columns (16 raw bytes: a quarter warp reads 128 in a row).
        // SPLIT: a unit is a byte row c and 16 columns, its low nibbles tile
        // row c (an even key), its high ones row 32 + c
        if constexpr (SPLIT) {
          static_assert(kDcKeys / 2 * 8 == kDcConsumers, "a unit a consumer thread");
          const int c16 = tid & 7, brow = tid >> 3;
          const uint4 x = *reinterpret_cast<const uint4*>(vb + brow * ROW + 16 * c16);
          const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
          uint32_t ev[8], od[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dc_word<P, Pol::kWiden>(wd[i], 0, ev[2 * i], ev[2 * i + 1]);
            dc_word<P, Pol::kWiden>(wd[i], 1, od[2 * i], od[2 * i + 1]);
          }
          uint4* de = reinterpret_cast<uint4*>(vtile + brow * kDcVStride + 16 * c16);
          uint4* dd = reinterpret_cast<uint4*>(vtile + (32 + brow) * kDcVStride + 16 * c16);
          de[0] = make_uint4(ev[0], ev[1], ev[2], ev[3]);
          de[1] = make_uint4(ev[4], ev[5], ev[6], ev[7]);
          dd[0] = make_uint4(od[0], od[1], od[2], od[3]);
          dd[1] = make_uint4(od[4], od[5], od[6], od[7]);
        }
#pragma unroll
        for (int u2 = 0; u2 < (SPLIT ? 0 : kDcKeys * 8 / kDcConsumers); ++u2) {
          const int u = tid + kDcConsumers * u2, c16 = u & 7, key = u >> 3;
          uint32_t words[8];
          if constexpr (WIDE) {
            const uint4 x0 = *reinterpret_cast<const uint4*>(vb + key * ROW + 32 * c16);
            const uint4 x1 = *reinterpret_cast<const uint4*>(vb + key * ROW + 32 * c16 + 16);
            words[0] = x0.x; words[1] = x0.y; words[2] = x0.z; words[3] = x0.w;
            words[4] = x1.x; words[5] = x1.y; words[6] = x1.z; words[7] = x1.w;
          } else {
            const uint4 x = *reinterpret_cast<const uint4*>(
                vb + (PACK == 2 ? key >> 1 : key) * ROW + 16 * c16);
            const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dc_word<P, Pol::kWiden>(wd[i], key & 1, words[2 * i], words[2 * i + 1]);
            }
            if constexpr (DEQ) {  // bf16(v) x bf16(its scale), rounded once
              const uint32_t s2 = pack2<bf16>(vs_sh[j * kDcKeys + key], vs_sh[j * kDcKeys + key]);
#pragma unroll
              for (int i = 0; i < 8; ++i) words[i] = dc_mul_bf16x2(words[i], s2);
            }
          }
          uint4* dst = reinterpret_cast<uint4*>(vtile + key * kDcVStride + 16 * c16);
          dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
          dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
        named_sync(1, kDcConsumers);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kq = j * kDcKeys + 16 * kk + 2 * t;  // this thread's key in the merge
          // V fragments by ldmatrix.trans: matrix lane / 8 is keys 16 kk + 8
          // (lane / 8 % 2), columns of the warp's n-tile lane / 16
          uint32_t vf[kDcVT][2];
#pragma unroll
          for (int np = 0; np < kDcVT; np += 2) {
            const int mi = lane >> 3;
            const bf16* at = vtile + (16 * kk + 8 * (mi & 1) + (lane & 7)) * kDcVStride +
                             kDcCW * w + 8 * (np + (mi >> 1));
            ldsm_x4_trans(at, vf[np][0], vf[np][1], vf[np + 1][0], vf[np + 1][1]);
          }
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            // P of rows past the CTA's is 0 (their scores are not stored)
            const int r = 16 * rt + gq;
            const uint32_t* p0 = reinterpret_cast<const uint32_t*>(Ss + r * SST) + kq / 2;
            const uint32_t* p1 = p0 + 8 * SST;
            const uint32_t a0 = r < R ? p0[0] : 0u, a2 = r < R ? p0[4] : 0u;
            const uint32_t a1 = r + 8 < R ? p1[0] : 0u, a3 = r + 8 < R ? p1[4] : 0u;
#pragma unroll
            for (int nt = 0; nt < kDcVT; ++nt) {
              // SPLIT: k-steps 0-1 are the even keys (tile rows 0-31), 2-3 the odd
              if (SPLIT && kk >= 2)
                mma_16816(acc_odd[SPLIT ? rt : 0][nt], a0, a1, a2, a3, vf[nt][0], vf[nt][1]);
              else
                mma_16816(acc[rt][nt], a0, a1, a2, a3, vf[nt][0], vf[nt][1]);
            }
          }
        }
      }
    }
    if constexpr (S8) dc_s8_add_pv(acc[0], pv8, ps_sh, gq);
    named_sync(1, kDcConsumers);  // every warp is done with P before the next merge's scores
  }

  // ---- the finish: a single run writes o; else partials, a ticket, the merge ----
  // (kDcS8 takes one run: the host gives it one split)
  const int cta_rows = blockIdx.y;
  if (S8 || runs == 1) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rt + gq + 8 * h;
        if (r >= R) continue;
        const float l = l_sh[r], div = l == 0.f ? 1.f : l;
        const size_t oi = q_index(r);
#pragma unroll
        for (int nt = 0; nt < kDcVT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // kDcS8: n-tile 0 is the warp's even columns, 1 its odd ones
            const int c = S8 ? kDcCW * w + 4 * t + 2 * e + nt : kDcCW * w + 8 * nt + 2 * t + e;
            if constexpr (SPLIT) {
              if (c < a.d) a.o[oi + c] = dc_halves(acc[rt][nt][2 * h + e],
                                                   acc_odd[rt][nt][2 * h + e], div);
            } else {
              if (c < a.d) a.o[oi + c] = __float2bfloat16(acc[rt][nt][2 * h + e] / div);
            }
          }
      }
    if (a.l != nullptr)
      for (int r = tid; r < R; r += kDcConsumers) {
        a.l[q_index(r) / a.d] = l_sh[r];
        a.m[q_index(r) / a.d] = m_sh[r];
      }
    return;
  }
  const size_t cell = static_cast<size_t>(b) * gridDim.y + cta_rows;
  float* mine = a.ws + (cell * a.splits + split) * PART;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rt + gq + 8 * h;
      if (r >= R) continue;
#pragma unroll
      for (int nt = 0; nt < kDcVT; ++nt) {
        *reinterpret_cast<float2*>(mine + r * kDcD + kDcCW * w + 8 * nt + 2 * t) =
            make_float2(acc[rt][nt][2 * h], acc[rt][nt][2 * h + 1]);
        if constexpr (SPLIT)  // the odd keys' accumulator after the even one's
          *reinterpret_cast<float2*>(mine + (kDcRows + r) * kDcD + kDcCW * w + 8 * nt + 2 * t) =
              make_float2(acc_odd[rt][nt][2 * h], acc_odd[rt][nt][2 * h + 1]);
      }
    }
  for (int r = tid; r < R; r += kDcConsumers) {
    mine[ML + r] = m_sh[r];
    mine[ML + kDcRows + r] = l_sh[r];
  }
  __threadfence();
  named_sync(1, kDcConsumers);
  if (tid == 0) {
    const int ticket = atomicAdd(a.tickets + cell, 1);
    *flag = ticket == runs - 1;
    if (*flag) a.tickets[cell] = 0;  // every run has arrived: ready for the next launch
  }
  named_sync(1, kDcConsumers);
  if (!*flag) return;
  __threadfence();
  const float* parts = a.ws + cell * a.splits * PART;
  for (int i = tid; i < R * kDcD; i += kDcConsumers) {
    const int r = i / kDcD, c = i % kDcD;
    float M = neg_inf();
    for (int sp = 0; sp < runs; ++sp) M = fmaxf(M, __ldcg(parts + sp * PART + ML + r));
    float L = 0.f, O = 0.f, O_odd = 0.f;
    for (int sp = 0; sp < runs; ++sp) {
      const float* part = parts + sp * PART;
      const float f = exp2f(__ldcg(part + ML + r) - M);
      L += __ldcg(part + ML + kDcRows + r) * f;
      O += __ldcg(part + r * kDcD + c) * f;
      if constexpr (SPLIT) O_odd += __ldcg(part + (kDcRows + r) * kDcD + c) * f;
    }
    const float div = L == 0.f ? 1.f : L;
    if (c < a.d) a.o[q_index(r) + c] = SPLIT ? dc_halves(O, O_odd, div) : __float2bfloat16(O / div);
    if (c == 0 && a.l != nullptr) {
      a.l[q_index(r) / a.d] = L;
      a.m[q_index(r) / a.d] = M;
    }
  }
}

// The launch: grid (splits, kv heads x row groups, slots), 288 threads, and
// a.merge_keys keys a merge (dc_merge_keys; the tool's: npg pages).  walk
// (nullable, host) gets {1 (the tensor-core body), splits, CTAs} before
// anything can fail.
template <typename P, int RT, typename Pol = DcServing>
int decode_tc_launch(const DcArgsOf<Pol>& a, int S, cudaStream_t stream) {
  const int rows = min(a.n_q / a.n_kv * a.gamma, kDcRows);
  const int smem = dc_smem<P, Pol>(rows, a.merge_keys);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = decode_tc_kernel<P, RT, Pol>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.splits, a.n_kv * a.row_groups, S), kDcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename P>
int decode_tc(const DcArgs& a, int S, int d_store, int* walk, cudaStream_t stream) {
  const int rows = a.n_q / a.n_kv * a.gamma;
  if (walk) {
    walk[0] = 1;
    walk[1] = a.splits;
    walk[2] = a.splits * a.n_kv * a.row_groups * S;
  }
  const int ps = a.page_size;
  if (d_store != kDcD || a.d < 1 || a.d > kDcD || a.splits < 1 || a.ws == nullptr ||
      a.tickets == nullptr || a.row_groups != (rows + kDcRows - 1) / kDcRows ||
      !(ps % kDcKeys == 0 || ps == 16 || ps == 32) ||
      a.n_kv * a.row_groups > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const int rp = min(rows, kDcRows);
  DcArgs args = a;
  args.merge_keys = dc_merge_keys(ps, rp);
  if (rp <= 16) return decode_tc_launch<P, 1>(args, S, stream);
  if (rp <= 32) return decode_tc_launch<P, 2>(args, S, stream);
  return decode_tc_launch<P, 4>(args, S, stream);
}

// One of the int4 unpack tool's sites: S rows of g <= 16 query rows a kv
// head (one row tile), gamma 1, head dim 128, over pages (int8, or int4
// pairs) of a multiple of 64 keys in merges of npg pages (a.merge_keys, at
// most the policy's cap); the caller gives the tables, lengths, workspace,
// tickets and splits (native.exp_int4_plan).  walk as decode_tc's.
template <typename P, typename Pol>
int decode_tc_tool(const DcArgs& a, int S, int* walk, cudaStream_t stream) {
  static_assert(Pol::kTool, "the tool's policies");
  if (walk) {
    walk[0] = 1;
    walk[1] = a.splits;
    walk[2] = a.splits * a.n_kv * S;
  }
  const int ps = a.page_size, U = a.merge_keys;
  if (a.n_kv < 1 || a.n_q % a.n_kv || a.n_q / a.n_kv > 16 || a.gamma != 1 || a.d != kDcD ||
      a.splits < 1 || a.ws == nullptr || a.tickets == nullptr || a.row_groups != 1 ||
      ps < kDcKeys || ps % kDcKeys || U < ps || U % ps || U > Pol::kMaxMerge ||
      a.n_kv > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  return decode_tc_launch<P, 1, Pol>(a, S, stream);
}

// One of exp_decode's variants (tools/exp_decode.py) on the port's int8
// cache: S slots of g <= 16 query rows a kv head (one row tile), gamma 1,
// causal, head dim 128, pages of 64-512 keys (a multiple of 64), a page a
// merge (a.merge_keys = page); the caller gives the workspace, tickets and
// splits (native.exp_decode_plan: the decode's rule; one for kDcS8, whose p
// codes take each page's running maximum).  walk as decode_tc's.
template <typename Pol>
int decode_tc_exp(const DcArgsOf<Pol>& a, int S, int* walk, cudaStream_t stream) {
  static_assert(!Pol::kTool, "a page a merge");
  if (walk) {
    walk[0] = 1;
    walk[1] = a.splits;
    walk[2] = a.splits * a.n_kv * S;
  }
  const int ps = a.page_size;
  if (a.n_kv < 1 || a.n_q % a.n_kv || a.n_q / a.n_kv > 16 || a.gamma != 1 || a.d != kDcD ||
      a.splits < 1 || (Pol::kUnpack == kDcS8 && a.splits != 1) || a.ws == nullptr ||
      a.tickets == nullptr || a.row_groups != 1 || ps < kDcKeys || ps % kDcKeys ||
      ps > kDcMaxMerge || a.merge_keys != ps || a.page_stride != 1 || a.page_offset != 0 ||
      a.is_local || a.glob_lengths != nullptr || a.l != nullptr || a.n_kv > 65535 || S > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  return decode_tc_launch<int8_t, 1, Pol>(a, S, stream);
}

}  // namespace tc
}  // namespace
