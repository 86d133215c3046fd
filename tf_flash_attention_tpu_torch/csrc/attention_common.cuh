// Shared device code of the op path's attention kernels (sm_90a), included
// by attention_kernels.cu (the table-driven kernels) and band_kernels.cu
// (the banded and single-window kernels).
//
// Layouts are sequence-major and contiguous: q (B, q_len, d), k (B_kv, k_len,
// d), v (B_kv, k_len, v_d), B = g * B_kv; query row b reads kv row b / g
// (grouped-query attention).  A CTA walks the schedule's blocks in smaller
// tiles of its own (BM query rows x BN key rows, fixed per head-dim class),
// each of which divides every schedule block (a multiple of 128).
//
// Numerics follow the JAX kernels: the online softmax runs in the log2
// domain on a prescaled operand (q * scale * log2e, or k for the dK/dV
// kernel), in float32; masked logits take the finite 0xFA value, never
// -inf; dead rows (no visible key) get O = 0, l = 0, m = NEG_INF; the
// forwards round p to the input type before PV while l sums the float32 p,
// as the JAX kernels do.  Inputs are float32, bf16 or fp16.  This file's
// bodies compute every product as a float32 FMA on values staged in float32
// (no TF32), so float32 inputs are computed at full float32 precision; the
// bf16 / fp16 forward of the table, banded and resident walks at d <= 512
// runs on the tensor-core body of attention_fwd_tc.cuh instead, and the
// fused backward at max(d, v_d) <= 128 on that of attention_bwd_tc.cuh.  The backwards round p
// to the input type before dV, and dS before dK and dQ, as the JAX kernels
// do.  Built without --use_fast_math (exp2f stays accurate).
//
// What bounds the scalar bodies: the scalar FMA rate and shared-memory
// bandwidth.  Each thread holds a 4 x 4 (or 2 x 2, or 1 x 1) register tile
// of the score product and reads two operands from shared memory per FMA
// row, so they run far below the tensor cores' rate; the design keeps every
// operand of a tile in shared memory once (odd row strides, no bank
// conflicts) and skips dead tiles entirely.
//
// Head dims: three tile classes by max(d, v_d) (<= 128, <= 256, wider; see
// the launch helpers).  The widest class holds 512 output columns in
// registers; wider heads split the output columns over grid z, each CTA of
// a row recomputing the scores for its chunk, with q, k and v staged whole
// (the staged widths are bounded by shared memory only).
//
// The kernels differ in how a CTA finds its work (the Walk):
//   kTable  - the schedule's kv_table / kv_counts / needs_mask rows;
//   kBanded - four ints per row, [start, i0, i1, end) in blocks
//             (Schedule.banded_segments): one loop over the band, the
//             blocks of the interior [i0, i1) on the body compiled without
//             the predicate, the masked prefix and suffix on the other;
//   kWindow - one lane-aligned band [starts[row / sub], + band) of the
//             other sequence per sub-block (schedule.window_band_table*),
//             every tile masked.
//   kResident - the banded walk for every query tile of a row, in one CTA
//               (the tensor-core body: persistent CTAs over the rows' tiles
//               in row order).
//
// Each extern "C" entry launches one kernel on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The sync pack and mask rule (mask_rules.py, sync_modes.py) as plain ints;
// native.py's FaRule mirrors this layout.  Outside the anonymous namespace:
// the extern "C" entries take it, and must keep external linkage.
struct FaRule {
  int ndim;  // 1 or 2 sequence dims
  int q_shape[2], q_stride[2], q_offset[2];
  int k_shape[2], k_stride[2], k_offset[2];
  int shift0;  // flattening shift of dim 0: log2 of reference dim 1 (2d only)
  int kind, window, log2_stride, is_causal;
  int q_len, k_len;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads per CTA: a 16 x 16 grid (ty, tx)
constexpr int MAX_SMEM = 232448;  // opt-in shared memory per block (227 KB)
constexpr float INV_LOG2E = 0.6931471805599453f;
constexpr float DEAD_LSE2 = 3e38f;  // lse2 of a row outside q_len: P = 0

enum DType { kF32 = 0, kBF16 = 1, kF16 = 3 };
enum RuleKind { kFull = 0, kCausal = 1, kLocal = 2 };
enum Walk { kTable = 0, kBanded = 1, kWindow = 2, kResident = 3 };

struct AttnArgs {
  const void* q;       // forward / dQ / fused: q prescaled; dK-dV: q
  const void* k;       // dK-dV: k prescaled; others: k
  const void* v;
  const void* dout;
  const float* lse2;   // (B, q_len): m * log2e + log2 l, or 3e38 where l == 0
  const float* delta;  // (B, q_len): rowsum(dO * O)
  void* o;             // forward (B, q_len, v_d)
  float* l;            // forward (B, q_len)
  float* m;            // forward (B, q_len), natural log
  void* dq;            // split dQ (B, q_len, d)
  float* dq_acc;       // fused: zeroed float32 (B, q_len, d), unscaled
  void* dk;            // (B_kv, k_len, d)
  void* dv;            // (B_kv, k_len, v_d)
  const int* table;    // kTable: kv_table; kBanded: (rows, 4) segments;
                       // kWindow: per-sub-block band starts
  const int* counts;
  const int* needs;
  int num_steps, block_q, block_kv, B, g, d, v_d;
  int band, sub;    // kWindow: band width and sub-block rows
  int* next_item;   // the tensor-core kResident: a zeroed work counter
  float out_scale;  // dQ: scale; fused dK: 1/log2e; dK-dV: scale
  float s_scale;    // the tool forwards' kExpGroups: the scores' scale (kv_unroll's)
  FaRule rule;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xFAFAFAFAu));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// x rounded to T and back (p before PV in the forwards; p before dV, dS
// before dK and dQ in the backwards)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// kernel_common.kernel_orders: order coordinates and flattened order of a
// flattened sequence position
__device__ __forceinline__ int seq_orders(const FaRule& r, const int* shape, const int* stride,
                                          const int* offset, int pos, int c[2]) {
  if (r.ndim == 1) {
    c[0] = pos * stride[0] + offset[0];
    c[1] = 0;
    return c[0];
  }
  const int i0 = pos / shape[1], i1 = pos - i0 * shape[1];
  c[0] = i0 * stride[0] + offset[0];
  c[1] = i1 * stride[1] + offset[1];
  return (c[0] << r.shift0) + c[1];
}

// A sequence position as the rule predicate reads it: in bounds, its order
// coordinates and flattened order (computed once per row or column).
struct SeqPos {
  bool in;
  int f, c[2];
};

__device__ __forceinline__ SeqPos q_pos_of(const FaRule& r, int pos) {
  SeqPos p;
  p.in = pos < r.q_len;
  p.f = seq_orders(r, r.q_shape, r.q_stride, r.q_offset, pos, p.c);
  return p;
}

__device__ __forceinline__ SeqPos k_pos_of(const FaRule& r, int pos) {
  SeqPos p;
  p.in = pos < r.k_len;
  p.f = seq_orders(r, r.k_shape, r.k_stride, r.k_offset, pos, p.c);
  return p;
}

// The rule predicate: kernel_common.build_tile_mask with mask_rules.py's
// check (causal :127-128, local :168-178) and the sequence bounds.
__device__ __forceinline__ bool visible(const FaRule& r, const SeqPos& q, const SeqPos& k) {
  if (!q.in || !k.in) return false;
  if (r.kind == kFull) return true;
  if (r.kind == kCausal) return q.f >= k.f;
  bool ok = true;
#pragma unroll
  for (int dim = 0; dim < 2; ++dim) {
    if (dim < r.ndim) {
      const int diff = abs(q.c[dim] - k.c[dim]);
      ok = ok && (diff >> r.log2_stride) < r.window;
      if (r.log2_stride) ok = ok && (diff & ((1 << r.log2_stride) - 1)) == 0;
    }
  }
  if (r.is_causal) ok = ok && q.f >= k.f;
  return ok;
}

__device__ __forceinline__ bool visible(const FaRule& r, int q_pos, int k_pos) {
  return visible(r, q_pos_of(r, q_pos), k_pos_of(r, k_pos));
}

// dst[r * ld + c] = src row (row0 + r), column c, as float; rows past n_rows
// are zero (the padding the JAX wrappers materialize)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int row0, int rows, int n_rows, int cols) {
  const int total = rows * cols;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] =
        row0 + r < n_rows ? to_f(src[static_cast<size_t>(row0 + r) * cols + c]) : 0.f;
  }
}

__device__ __forceinline__ void load_stats(float* lse_s, float* d_s, const AttnArgs& a, int b,
                                           int row0, int rows) {
  const int q_len = a.rule.q_len;
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int row = row0 + r;
    const size_t i = static_cast<size_t>(b) * q_len + row;
    lse_s[r] = row < q_len ? a.lse2[i] : DEAD_LSE2;
    d_s[r] = row < q_len ? a.delta[i] : 0.f;
  }
}

// s[i][j] += A[ty + 16 i][:n] . B[tx + 16 j][:n]  (rows of two staged tiles)
template <int RI, int CJ>
__device__ __forceinline__ void rows_dot(float (&s)[RI][CJ], const float* A, int lda,
                                         const float* B, int ldb, int n, int ty, int tx) {
  for (int kk = 0; kk < n; ++kk) {
    float x[RI], y[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = A[(ty + 16 * i) * lda + kk];
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[j] = B[(tx + 16 * j) * ldb + kk];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][j] += sum_n P[ty + 16 i][off + n] * X[n][tx + 16 j]  (n < BN, j < cols)
template <int RI, int XJ, int BN>
__device__ __forceinline__ void acc_pv(float (&acc)[RI][XJ], const float* P, int ldp, int off,
                                       const float* X, int ldx, int cols, int ty, int tx) {
  for (int n = 0; n < BN; ++n) {
    float p[RI], x[XJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) p[i] = P[(ty + 16 * i) * ldp + off + n];
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int c = tx + 16 * j;
      x[j] = c < cols ? X[n * ldx + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < XJ; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// The forward finalize (forward.py:225-243): dead rows get O = 0, l = 0,
// m = NEG_INF; m is published in the natural-log domain.  m_s is log2.  acc
// holds the output columns [vc0, vc0 + 16 VJ); chunk 0 writes l and m.
template <typename T, int RI, int VJ>
__device__ __forceinline__ void fwd_finalize(const AttnArgs& a, int b, int row0,
                                             const float (&acc)[RI][VJ], const float* m_s,
                                             const float* l_s, int ty, int tx) {
  const int q_len = a.rule.q_len, v_d = a.v_d, vc0 = blockIdx.z * 16 * VJ;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    if (row >= q_len) continue;
    const float m = m_s[r];
    const bool dead = m <= neg_inf();
    const float l = dead ? 0.f : l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;
    const size_t orow = static_cast<size_t>(b) * q_len + row;
    T* o = static_cast<T*>(a.o) + orow * v_d;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int c = vc0 + tx + 16 * j;
      if (c < v_d) o[c] = from_f<T>(dead ? 0.f : acc[i][j] / l_safe);
    }
    if (tx == 0 && blockIdx.z == 0) {
      a.l[orow] = l;
      a.m[orow] = dead ? neg_inf() : m * INV_LOG2E;
    }
  }
}

// ---------------------------------------------------------------------------
// The online-softmax forward: fa_flash_fwd (kTable, <- ops/forward.py::
// _fwd_kernel) and fa_banded_fwd (kBanded, <- ops/forward_banded.py::
// _banded_kernel).  One CTA per (query row b, BM query rows); it walks its
// kv blocks in BN-row sub-tiles, carrying (m, l, acc) in float32: scores in
// shared memory, the output accumulator in registers.

struct FwdSmem {
  float *Qs, *Ks, *Vs, *Ss, *m_s, *l_s, *a_s;
};

// one kv block [c_begin, c_end) of the online softmax
template <typename T, int BM, int BN, int DMAX, bool MASKED>
__device__ __forceinline__ void fwd_block(const AttnArgs& a, const FwdSmem& sm, const T* kb,
                                          const T* vb, int row0, int c_begin, int c_end,
                                          float (&acc)[BM / 16][DMAX / 16]) {
  constexpr int RI = BM / 16, CJ = BN / 16, VJ = DMAX / 16, LDS = BN + 1, TPR = NT / BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1, k_len = a.rule.k_len;
  for (int c0 = c_begin; c0 < c_end; c0 += BN) {
    __syncthreads();  // the previous sub-tile's readers are done
    load_tile(sm.Ks, ldq, kb, c0, BN, k_len, d);
    load_tile(sm.Vs, ldv, vb, c0, BN, k_len, v_d);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    rows_dot(s, sm.Qs, ldq, sm.Ks, ldq, d, ty, tx);  // log2-domain logits
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sm.Ss[r * LDS + c] =
            MASKED && !visible(a.rule, row0 + r, c0 + c) ? neg_inf() : s[i][j];
      }
    __syncthreads();
    {  // online softmax: TPR threads per row
      const int r = tid / TPR, part = tid % TPR;
      float mx = neg_inf();
      for (int c = part; c < BN; c += TPR) mx = fmaxf(mx, sm.Ss[r * LDS + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm.m_s[r], m_next = fmaxf(m_prev, mx);
      // masked logits hold NEG_INF: exp2(NEG_INF - m) == 0 for a live row;
      // a row with no visible key yet is repaired at the end
      float sum = 0.f;
      for (int c = part; c < BN; c += TPR) {
        const float p = exp2f(sm.Ss[r * LDS + c] - m_next);
        sm.Ss[r * LDS + c] = round_to<T>(p);
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = exp2f(m_prev - m_next);
        sm.a_s[r] = alpha;
        sm.l_s[r] = alpha * sm.l_s[r] + sum;
        sm.m_s[r] = m_next;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = sm.a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < VJ; ++j) acc[i][j] *= alpha;
    }
    const int vc0 = blockIdx.z * DMAX;  // this CTA's output columns
    acc_pv<RI, VJ, BN>(acc, sm.Ss, LDS, 0, sm.Vs + vc0, ldv, v_d - vc0, ty, tx);
  }
}

// the query rows [row0, row0 + BM) of row b, over the kv blocks of the walk
template <typename T, int BM, int BN, int DMAX, int WALK>
__device__ __forceinline__ void fwd_rows(const AttnArgs& a, const FwdSmem& sm, int b, int row0) {
  constexpr int RI = BM / 16, VJ = DMAX / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = a.d, v_d = a.v_d, ldq = d | 1;
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b / a.g) * k_len * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b / a.g) * k_len * v_d;
  __syncthreads();  // a previous tile's finalize has read m_s and l_s
  load_tile(sm.Qs, ldq, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0,
            BM, q_len, d);
  for (int r = tid; r < BM; r += NT) {
    sm.m_s[r] = neg_inf();
    sm.l_s[r] = 0.f;
  }
  float acc[RI][VJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;

  const int qi = row0 / a.block_q, bkv = a.block_kv;
  auto block_end = [&](int blk) { return min((blk + 1) * bkv, k_len); };
  if constexpr (WALK == kTable) {
    const int n_steps = a.counts[qi];
    for (int step = 0; step < n_steps; ++step) {
      const int blk = a.table[qi * a.num_steps + step];
      if (a.needs[qi * a.num_steps + step] != 0)
        fwd_block<T, BM, BN, DMAX, true>(a, sm, kb, vb, row0, blk * bkv, block_end(blk), acc);
      else
        fwd_block<T, BM, BN, DMAX, false>(a, sm, kb, vb, row0, blk * bkv, block_end(blk), acc);
    }
  } else {  // kBanded: masked prefix [seg0, i0), interior [i0, i1), masked suffix
    const int* seg = a.table + 4 * qi;
    const int i0 = seg[1], i1 = seg[2];
    for (int blk = seg[0]; blk < seg[3]; ++blk) {
      if (blk < i0 || blk >= i1)
        fwd_block<T, BM, BN, DMAX, true>(a, sm, kb, vb, row0, blk * bkv, block_end(blk), acc);
      else
        fwd_block<T, BM, BN, DMAX, false>(a, sm, kb, vb, row0, blk * bkv, block_end(blk), acc);
    }
  }
  __syncthreads();
  fwd_finalize<T>(a, b, row0, acc, sm.m_s, sm.l_s, ty, tx);
}

// kTable and kBanded: one CTA per (query row b, BM query rows).  kResident
// (fa_resident_fwd on float32 and d > 512, <- ops/forward_banded.py::
// _resident_kernel): one CTA per query row b, walking all of the row's
// query tiles in order with the banded walk, so one SM reads the row's K/V
// (through L2) for the whole row.
template <typename T, int BM, int BN, int DMAX, int WALK>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(AttnArgs a) {
  constexpr int LDS = BN + 1;
  extern __shared__ float smem[];
  const int ldq = a.d | 1, ldv = a.v_d | 1;  // odd strides
  FwdSmem sm;
  sm.Qs = smem;
  sm.Ks = sm.Qs + BM * ldq;
  sm.Vs = sm.Ks + BN * ldq;
  sm.Ss = sm.Vs + BN * ldv;
  sm.m_s = sm.Ss + BM * LDS;
  sm.l_s = sm.m_s + BM;
  sm.a_s = sm.l_s + BM;
  if constexpr (WALK == kResident) {
    for (int row0 = 0; row0 < a.rule.q_len; row0 += BM)
      fwd_rows<T, BM, BN, DMAX, kBanded>(a, sm, blockIdx.x, row0);
  } else {
    fwd_rows<T, BM, BN, DMAX, WALK>(a, sm, blockIdx.y, blockIdx.x * BM);
  }
}

// ---------------------------------------------------------------------------
// The kv-outer backward: fa_flash_bwd_fused (kTable, FUSED, <- ops/
// backward.py::_fused_kernel), fa_flash_bwd_dkv (kTable, <- ::_dkv_kernel),
// fa_banded_bwd (kBanded, FUSED, <- ::_fused_banded_kernel) and
// fa_window_bwd (kWindow, FUSED, <- ::_fused_window_kernel).  One CTA per
// (kv row, BN kv rows); for every live q tile of BM rows, and every query
// head of the GQA group:
//   P = exp2(s - lse2) (masked: 0),  dS = P * (dO V^T - D),
//   dV += P^T dO,  dK += dS^T q,     FUSED: dQ += dS K.
// dK and dV accumulate in registers.  The TPU kernels keep dQ in a
// whole-sequence VMEM scratch; here it is a float32 global accumulator fed
// by atomicAdd (so dQ's last bits vary from run to run), scaled and cast by
// one elementwise pass after the kernel.  The fused kernels take q * scale
// * log2e (and finish dK with 1/log2e), the dK/dV one takes k * scale *
// log2e and unscaled q (and finishes dK with scale); out_scale carries that
// factor.

struct BwdSmem {
  float *Ks, *Vs, *Qs, *dOs, *Ps, *dSs, *lse_s, *d_s;
};

// the q rows [r0, r0 + BM) against the CTA's kv tile, every GQA member
template <typename T, int BM, int BN, int DMAX, bool FUSED, bool MASKED>
__device__ __forceinline__ void bwd_kv_rows(const AttnArgs& a, const BwdSmem& sm, int bkv,
                                            int col0, int r0, float (&dk_acc)[BN / 16][DMAX / 16],
                                            float (&dv_acc)[BN / 16][DMAX / 16]) {
  constexpr int RI = BM / 16, CJ = BN / 16, NI = BN / 16, DJ = DMAX / 16, LDS = BN + 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1, q_len = a.rule.q_len;
  const int cc0 = blockIdx.z * DMAX;  // this CTA's columns of dK, dV and dQ
  for (int mem = 0; mem < a.g; ++mem) {
    const int b = bkv * a.g + mem;
    __syncthreads();
    load_tile(sm.Qs, ldq, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, r0,
              BM, q_len, d);
    load_tile(sm.dOs, ldv, static_cast<const T*>(a.dout) + static_cast<size_t>(b) * q_len * v_d,
              r0, BM, q_len, v_d);
    load_stats(sm.lse_s, sm.d_s, a, b, r0, BM);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    rows_dot(s, sm.Qs, ldq, sm.Ks, ldq, d, ty, tx);
    rows_dot(dp, sm.dOs, ldv, sm.Vs, ldv, v_d, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool vis = !MASKED || visible(a.rule, r0 + r, col0 + c);
        const float p = vis ? exp2f(s[i][j] - sm.lse_s[r]) : 0.f;
        // p before dV, dS before dK and dQ, rounded to T as the JAX kernels
        sm.Ps[r * LDS + c] = round_to<T>(p);
        sm.dSs[r * LDS + c] = round_to<T>(p * (dp[i][j] - sm.d_s[r]));
      }
    __syncthreads();
    for (int rr = 0; rr < BM; ++rr) {
      float pn[NI], dsn[NI], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        pn[i] = sm.Ps[rr * LDS + ty + 16 * i];
        dsn[i] = sm.dSs[rr * LDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = cc0 + tx + 16 * j;
        dov[j] = c < v_d ? sm.dOs[rr * ldv + c] : 0.f;
        qv[j] = c < d ? sm.Qs[rr * ldq + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pn[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsn[i], qv[j], dk_acc[i][j]);
        }
    }
    if constexpr (FUSED) {
      float t[RI][DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) t[i][j] = 0.f;
      acc_pv<RI, DJ, BN>(t, sm.dSs, LDS, 0, sm.Ks + cc0, ldq, d - cc0, ty, tx);
      float* dq = a.dq_acc + static_cast<size_t>(b) * q_len * d;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= q_len) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int c = cc0 + tx + 16 * j;
          if (c < d) atomicAdd(dq + static_cast<size_t>(row) * d + c, t[i][j]);
        }
      }
    }
  }
}

// the q rows [r_begin, r_end) in BM-row tiles
template <typename T, int BM, int BN, int DMAX, bool FUSED, bool MASKED>
__device__ __forceinline__ void bwd_kv_span(const AttnArgs& a, const BwdSmem& sm, int bkv,
                                            int col0, int r_begin, int r_end,
                                            float (&dk_acc)[BN / 16][DMAX / 16],
                                            float (&dv_acc)[BN / 16][DMAX / 16]) {
  for (int r0 = r_begin; r0 < r_end; r0 += BM)
    bwd_kv_rows<T, BM, BN, DMAX, FUSED, MASKED>(a, sm, bkv, col0, r0, dk_acc, dv_acc);
}

template <typename T, int BM, int BN, int DMAX, bool FUSED, int WALK>
__global__ void __launch_bounds__(NT, 1) flash_bwd_kv_kernel(AttnArgs a) {
  constexpr int NI = BN / 16, DJ = DMAX / 16, LDS = BN + 1;
  extern __shared__ float smem[];
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1;
  BwdSmem sm;
  sm.Ks = smem;
  sm.Vs = sm.Ks + BN * ldq;
  sm.Qs = sm.Vs + BN * ldv;
  sm.dOs = sm.Qs + BM * ldq;
  sm.Ps = sm.dOs + BM * ldv;
  sm.dSs = sm.Ps + BM * LDS;
  sm.lse_s = sm.dSs + BM * LDS;
  sm.d_s = sm.lse_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bkv = blockIdx.y, col0 = blockIdx.x * BN;
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  load_tile(sm.Ks, ldq, static_cast<const T*>(a.k) + static_cast<size_t>(bkv) * k_len * d, col0,
            BN, k_len, d);
  load_tile(sm.Vs, ldv, static_cast<const T*>(a.v) + static_cast<size_t>(bkv) * k_len * v_d,
            col0, BN, k_len, v_d);
  float dk_acc[NI][DJ], dv_acc[NI][DJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int bq = a.block_q;
  auto block_end = [&](int blk) { return min((blk + 1) * bq, q_len); };
  if constexpr (WALK == kTable) {
    const int ki = col0 / a.block_kv;
    const int n_steps = a.counts[ki];
    for (int step = 0; step < n_steps; ++step) {
      const int blk = a.table[ki * a.num_steps + step];
      if (a.needs[ki * a.num_steps + step] != 0)
        bwd_kv_span<T, BM, BN, DMAX, FUSED, true>(a, sm, bkv, col0, blk * bq, block_end(blk),
                                                  dk_acc, dv_acc);
      else
        bwd_kv_span<T, BM, BN, DMAX, FUSED, false>(a, sm, bkv, col0, blk * bq, block_end(blk),
                                                   dk_acc, dv_acc);
    }
  } else if constexpr (WALK == kBanded) {
    const int* seg = a.table + 4 * (col0 / a.block_kv);
    const int i0 = seg[1], i1 = seg[2];
    for (int blk = seg[0]; blk < seg[3]; ++blk) {
      if (blk < i0 || blk >= i1)
        bwd_kv_span<T, BM, BN, DMAX, FUSED, true>(a, sm, bkv, col0, blk * bq, block_end(blk),
                                                  dk_acc, dv_acc);
      else
        bwd_kv_span<T, BM, BN, DMAX, FUSED, false>(a, sm, bkv, col0, blk * bq, block_end(blk),
                                                   dk_acc, dv_acc);
    }
  } else {  // kWindow: one q band per kv sub-block, every tile masked
    const int start = a.table[col0 / a.sub];
    bwd_kv_span<T, BM, BN, DMAX, FUSED, true>(a, sm, bkv, col0, start,
                                              min(start + a.band, q_len), dk_acc, dv_acc);
  }
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int col = col0 + ty + 16 * i;
    if (col >= k_len) continue;
    const size_t row = static_cast<size_t>(bkv) * k_len + col;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = blockIdx.z * DMAX + tx + 16 * j;
      if (c < d) dk[row * d + c] = from_f<T>(dk_acc[i][j] * a.out_scale);
      if (c < v_d) dv[row * v_d + c] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch helpers

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, const AttnArgs& a, cudaStream_t stream) {
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

size_t floats(size_t n) { return n * sizeof(float); }

// shared memory of each kernel (float32 tiles, odd row strides)
size_t fwd_smem(int bm, int bn, int d, int v_d) {
  return floats((bm + bn) * (d | 1) + bn * (v_d | 1) + bm * (bn + 1) + 3 * bm);
}
size_t bwd_smem(int bm, int bn, int d, int v_d, int score_tiles) {
  return floats((bm + bn) * ((d | 1) + (v_d | 1)) + score_tiles * bm * (bn + 1) + 2 * bm);
}

bool dims_ok(const AttnArgs& a) {
  return a.d >= 1 && a.v_d >= 1 && a.g >= 1 && a.B % a.g == 0 && a.B / a.g <= 65535 &&
         a.B <= 65535;
}

// the schedule's blocks are multiples of 128 and of the CTA tiles
bool blocks_ok(const AttnArgs& a, int bm, int bn) {
  return dims_ok(a) && a.block_q % bm == 0 && a.block_kv % bn == 0 && a.block_q % 128 == 0 &&
         a.block_kv % 128 == 0;
}

int blocks(int n, int b) { return (n + b - 1) / b; }

// output-column chunks of a backward CTA row: dK, dQ (d) and dV (v_d)
int col_chunks(const AttnArgs& a, int cols) {
  return blocks(a.d > a.v_d ? a.d : a.v_d, cols);
}

template <typename F>
int dispatch(int dtype, F f) {
  switch (dtype) {
    case kF32: return f(float());
    case kBF16: return f(bf16());
    case kF16: return f(__half());
    default: return cudaErrorInvalidValue;
  }
}

// the head-dim class of the scalar bodies: 0 for max(d, v_d) <= 128, 1 for
// <= 256, 2 above (16-row tiles, 512 output columns a CTA, more on grid z)
int dim_class(const AttnArgs& a) {
  const int w = a.d > a.v_d ? a.d : a.v_d;
  return w <= 128 ? 0 : w <= 256 ? 1 : 2;
}
constexpr int WIDE_COLS = 512;

template <typename T, int BM, int BN, int DMAX, int WALK>
int fwd(const AttnArgs& a, cudaStream_t stream) {
  if (!blocks_ok(a, BM, BN)) return cudaErrorInvalidValue;
  const int chunks = blocks(a.v_d, DMAX);
  const dim3 grid = WALK == kResident ? dim3(a.B, 1, chunks)
                                      : dim3(blocks(a.rule.q_len, BM), a.B, chunks);
  return launch(flash_fwd_kernel<T, BM, BN, DMAX, WALK>, grid, fwd_smem(BM, BN, a.d, a.v_d), a,
                stream);
}

template <typename T, int BM, int BN, int DMAX, bool FUSED, int WALK>
int bwd_kv(const AttnArgs& a, cudaStream_t stream) {
  const bool ok = WALK == kWindow
                      ? dims_ok(a) && a.sub % BN == 0 && a.sub % 128 == 0 && a.band % BM == 0
                      : blocks_ok(a, BM, BN);
  if (!ok) return cudaErrorInvalidValue;
  return launch(flash_bwd_kv_kernel<T, BM, BN, DMAX, FUSED, WALK>,
                dim3(blocks(a.rule.k_len, BN), a.B / a.g, col_chunks(a, DMAX)),
                bwd_smem(BM, BN, a.d, a.v_d, 2), a, stream);
}

// the scalar forward's and the fused backward's CTA tiles per head-dim class
template <typename T, int WALK>
int fwd_scalar_any(const AttnArgs& a, cudaStream_t s) {
  switch (dim_class(a)) {
    case 0: return fwd<T, 64, 64, 128, WALK>(a, s);
    case 1: return fwd<T, 64, 32, 256, WALK>(a, s);
    default: return fwd<T, 16, 16, WIDE_COLS, WALK>(a, s);
  }
}

template <typename T, bool FUSED, int WALK>
int bwd_kv_any(const AttnArgs& a, cudaStream_t s) {
  switch (dim_class(a)) {
    case 0: return bwd_kv<T, 64, 64, 128, FUSED, WALK>(a, s);
    case 1: return bwd_kv<T, 32, 32, 256, FUSED, WALK>(a, s);
    default: return bwd_kv<T, 16, 16, WIDE_COLS, FUSED, WALK>(a, s);
  }
}

AttnArgs make_args(const void* q, const void* k, const void* v, int B, int g, int d, int v_d,
                   const FaRule* rule) {
  AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.g = g;
  a.d = d;
  a.v_d = v_d;
  a.rule = *rule;
  return a;
}

void set_bwd(AttnArgs& a, const void* dout, const float* lse2, const float* delta) {
  a.dout = dout;
  a.lse2 = lse2;
  a.delta = delta;
}

// calls f(blk, masked) for every schedule block of row `row` of the walk,
// in order: kTable the kv_table / kv_counts / needs_mask row, kBanded the
// four band ints (masked prefix [seg0, i0), interior [i0, i1), masked
// suffix)
template <int WALK, typename F>
__device__ __forceinline__ void for_each_block(const AttnArgs& a, int row, F&& f) {
  if constexpr (WALK == kTable) {
    const int n_steps = a.counts[row];
    for (int step = 0; step < n_steps; ++step)
      f(a.table[row * a.num_steps + step], a.needs[row * a.num_steps + step] != 0);
  } else {
    const int* seg = a.table + 4 * row;
    for (int blk = seg[0]; blk < seg[3]; ++blk) f(blk, blk < seg[1] || blk >= seg[2]);
  }
}

}  // namespace
