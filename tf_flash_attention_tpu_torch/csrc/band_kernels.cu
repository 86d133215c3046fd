// The banded and single-window attention kernels of the PyTorch port's op
// path, for Hopper (sm_90a).  Shared device code: attention_common.cuh.
//
//   fa_banded_fwd  <- ops/forward_banded.py::_banded_kernel (forward over one band per q block;
//                     bf16 and fp16 on the tensor-core body of attention_fwd_tc.cuh)
//   fa_banded_bwd  <- ops/backward.py::_fused_banded_kernel (fused backward, one band per kv
//                     block; bf16 and fp16 at max(d, v_d) <= 128 on the tensor-core body of
//                     attention_bwd_tc.cuh)
//   fa_window_fwd  <- ops/forward_banded.py::_window_kernel (single-window forward; bf16 and
//                     fp16 at d <= 512 on the tensor-core body of attention_fwd_tc.cuh,
//                     float32 and wider heads on the closed-form scalar body below)
//   fa_window_bwd  <- ops/backward.py::_fused_window_kernel (fused backward over one q band;
//                     bf16 and fp16 at max(d, v_d) <= 128 on the tensor-core body of
//                     attention_bwd_tc.cuh)
//   fa_resident_fwd <- ops/forward_banded.py::_resident_kernel (the banded walk; bf16 and fp16
//                     on the tensor-core body of attention_fwd_tc.cuh, persistent CTAs walking
//                     the rows in order; float32 on the scalar body, a CTA per row)
//
// The TPU kernels exist to keep K/V (forward) or q/dO/stats (backward)
// resident in VMEM and to replace the grid's kv axis by in-kernel loops
// over a band.  VMEM residency has no counterpart here: a CTA has at most
// 227 KB of shared memory, less than one 2048-row K/V pair in bf16, so the
// band kernels stream their tiles like the table kernels and rely on the
// 50 MB L2 for reuse across the CTAs of a row.  What carries over is the
// walk: the banded kernels read four ints per row instead of a table row
// and run the band's interior on the body compiled without the rule
// predicate; the window kernels visit one lane-aligned band per
// sub-block; the resident forward walks the rows in order, so few rows'
// K/V are live in L2 at once (attention_fwd_tc.cuh).
//
// The window kernels.  What bounds them on this card is the tensor cores'
// rate over the band's scheduled pairs (a 128-row tile's live blocks of
// 128, masked elements included: 40.6M pairs for 32.5M visible at B 8, an
// 8192-token window of 512): the bytes are one read of q, k, v (dO) a band.
// On bf16 and fp16 each kernel is the banded walk (kBanded) of the
// tensor-core bodies over blocks of 128, the host's four ints a 128-row
// tile ([start, i0, i1, end): the live blocks of the sub-block's band and
// their interior, from the 128 x 128 fine schedule,
// ops/forward.py::window_segments): the forward's 128-row items walk their
// key band in stages of 128, 64 or 32 keys through the TMA ring with the
// online softmax in registers; the backward's 128 kv rows walk their query
// band in 64-row stages, dQ by TMA reduce-add; the interior's stages run
// the body compiled without the predicate.  The TPU
// kernel's closed form (the whole band's scores at once, no merge chain)
// was the remedy for the TPU's per-step merge cost; here a merge is a
// rescale of registers, and a band-wide score tile in shared memory is
// what bounded the band.  float32 (TF32 would not hold the float32 limit)
// and wider heads keep the scalar bodies: the forward below in the TPU
// kernel's closed form, the whole band's scores in shared memory (that
// bounds the band width: window_fwd_smem; native.py routes wider bands
// elsewhere), and the kv-outer scalar backward with every tile masked.

#include "attention_bwd_tc.cuh"
#include "attention_common.cuh"
#include "attention_fwd_tc.cuh"

namespace {

constexpr int WBM = 32;  // window forward: query rows per CTA

// ---------------------------------------------------------------------------
// fa_window_fwd.  Replaces ops/forward_banded.py::_window_kernel.  One CTA
// per (query row b, WBM query rows).  Its sub-block's band [start, start +
// band) of keys: pass 1 writes the whole band's log2-domain scores into
// shared memory, the row max and sum come in one go (no online merge), and
// pass 2 multiplies P by V.  MASKED is false where window_band_table found
// every element of every window live.
template <typename T, int BN, int DMAX, bool MASKED>
__global__ void __launch_bounds__(NT, 1) window_fwd_kernel(AttnArgs a) {
  constexpr int BM = WBM, RI = BM / 16, CJ = BN / 16, VJ = DMAX / 16, TPR = NT / BM;
  extern __shared__ float smem[];
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1, W = a.band, ldw = W + 1;
  float* Qs = smem;                             // BM x ldq
  float* KVs = Qs + BM * ldq;                   // BN x max(ldq, ldv): K, then V tiles
  float* Ps = KVs + BN * (ldq > ldv ? ldq : ldv);  // BM x ldw: scores, then P
  float* m_s = Ps + BM * ldw;
  float* l_s = m_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  const int start = a.table[row0 / a.sub];
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b / a.g) * k_len * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b / a.g) * k_len * v_d;
  load_tile(Qs, ldq, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0, BM,
            q_len, d);
  for (int c0 = 0; c0 < W; c0 += BN) {  // pass 1: the band's scores
    __syncthreads();
    load_tile(KVs, ldq, kb, start + c0, BN, k_len, d);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    rows_dot(s, Qs, ldq, KVs, ldq, d, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = c0 + tx + 16 * j;
        Ps[r * ldw + c] = MASKED && !visible(a.rule, row0 + r, start + c) ? neg_inf() : s[i][j];
      }
  }
  __syncthreads();
  {  // closed-form softmax over the band: TPR threads per row
    const int r = tid / TPR, part = tid % TPR;
    float mx = neg_inf();
    for (int c = part; c < W; c += TPR) mx = fmaxf(mx, Ps[r * ldw + c]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = mx <= neg_inf() ? 0.f : mx;  // a dead row: every p is 0
    float sum = 0.f;
    for (int c = part; c < W; c += TPR) {
      const float p = exp2f(Ps[r * ldw + c] - m_safe);
      Ps[r * ldw + c] = round_to<T>(p);
      sum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  float acc[RI][VJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;
  const int vc0 = blockIdx.z * DMAX;      // this CTA's output columns
  for (int c0 = 0; c0 < W; c0 += BN) {  // pass 2: O = P V
    __syncthreads();
    load_tile(KVs, ldv, vb, start + c0, BN, k_len, v_d);
    __syncthreads();
    acc_pv<RI, VJ, BN>(acc, Ps, ldw, c0, KVs + vc0, ldv, v_d - vc0, ty, tx);
  }
  fwd_finalize<T>(a, b, row0, acc, m_s, l_s, ty, tx);
}

size_t window_fwd_smem(int bn, int d, int v_d, int W) {
  const int ld = (d | 1) > (v_d | 1) ? (d | 1) : (v_d | 1);
  return floats(WBM * (d | 1) + bn * ld + WBM * (W + 1) + 2 * WBM);
}

template <typename T, int BN, int DMAX, bool MASKED>
int window_fwd(const AttnArgs& a, cudaStream_t stream) {
  if (!dims_ok(a) || a.sub % WBM || a.sub % 128 || a.band % BN || a.band < BN)
    return cudaErrorInvalidValue;
  return launch(window_fwd_kernel<T, BN, DMAX, MASKED>,
                dim3(blocks(a.rule.q_len, WBM), a.B, blocks(a.v_d, DMAX)),
                window_fwd_smem(BN, a.d, a.v_d, a.band), a, stream);
}

template <typename T, bool MASKED>
int window_fwd_scalar(const AttnArgs& a, cudaStream_t s) {
  switch (dim_class(a)) {
    case 0: return window_fwd<T, 64, 128, MASKED>(a, s);
    case 1: return window_fwd<T, 32, 256, MASKED>(a, s);
    default: return window_fwd<T, 16, WIDE_COLS, MASKED>(a, s);
  }
}

// a window launch as the tensor-core bodies walk it: kBanded over blocks of
// 128, seg the band's four ints a 128-row tile
AttnArgs banded_window(AttnArgs a, const int* seg) {
  a.table = seg;
  a.block_q = a.block_kv = 128;
  return a;
}

// the window kernels on their bodies: bf16 and fp16 on the tensor-core
// body (the forward under fwd_on_tc, the backward under tc_bwd_takes),
// everything else on the scalar body (kWindow over the band starts).  A
// dispatch by shape, not a fallback: a refused launch returns its error.
// body (nullable, host): 1 for the tensor-core body, 0 for the scalar.
template <typename T>
int window_fwd_any(const AttnArgs& a, const int* seg, bool masked, cudaStream_t s, int* body) {
  if constexpr (!std::is_same<T, float>::value) {
    if (fwd_on_tc<T>(a)) {
      if (body) *body = 1;
      return fwd_tc_any<T, kBanded>(banded_window(a, seg), s);
    }
  }
  if (body) *body = 0;
  return masked ? window_fwd_scalar<T, true>(a, s) : window_fwd_scalar<T, false>(a, s);
}

template <typename T>
int window_bwd_any(const AttnArgs& a, const int* seg, cudaStream_t s, int* body) {
  if constexpr (!std::is_same<T, float>::value) {
    if (tc_bwd_takes(a)) {
      if (body) *body = 1;
      return tc::bwd_tc<T, kBanded>(banded_window(a, seg), s);
    }
  }
  if (body) *body = 0;
  return bwd_kv_any<T, true, kWindow>(a, s);
}

void set_window(AttnArgs& a, const int* starts, int band, int sub) {
  a.table = starts;
  a.band = band;
  a.sub = sub;
}

void set_fwd_out(AttnArgs& a, void* o, float* l, float* m) {
  a.o = o;
  a.l = l;
  a.m = m;
}

void set_fused_out(AttnArgs& a, float* dq_acc, void* dk, void* dv, float dk_scale) {
  a.dq_acc = dq_acc;
  a.dk = dk;
  a.dv = dv;
  a.out_scale = dk_scale;
}

}  // namespace

extern "C" {

// q prescaled; seg (ceil(q_len / block_q), 4) int32 band segments in blocks
int fa_banded_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* l,
                  float* m, const int* seg, int block_q, int block_kv, int B, int g, int d,
                  int v_d, const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  a.table = seg;
  a.block_q = block_q;
  a.block_kv = block_kv;
  set_fwd_out(a, o, l, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return fwd_any<decltype(tag), kBanded>(a, s); });
}

// as fa_banded_fwd, the rows' query tiles walked in row order: bf16 and
// fp16 by persistent CTAs on the tensor-core body, float32 and d > 512 one
// CTA a row on the scalar body (next_item a zeroed int32 counter; walk
// nullable, 4 host ints: the launch's CTAs, work items, rows a group and 1
// on the tensor-core body)
int fa_resident_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* l,
                    float* m, const int* seg, int* next_item, int block_q, int block_kv, int B,
                    int g, int d, int v_d, int* walk, const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  a.table = seg;
  a.next_item = next_item;
  a.block_q = block_q;
  a.block_kv = block_kv;
  set_fwd_out(a, o, l, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return fwd_any<decltype(tag), kResident>(a, s, walk); });
}

// q prescaled; starts (q_pad / sub_q,) int32 key-band starts, band width W
// (the scalar body); seg (ceil(q_len / 128), 4) int32 the band's segments a
// 128-row tile in blocks of 128 (the tensor-core body); body (nullable): 1
// int out, the body the launch ran (1 tensor-core, 0 scalar)
int fa_window_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* l,
                  float* m, const int* starts, const int* seg, int band, int sub_q, int masked,
                  int B, int g, int d, int v_d, int* body, const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_window(a, starts, band, sub_q);
  set_fwd_out(a, o, l, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype,
                  [&](auto tag) { return window_fwd_any<decltype(tag)>(a, seg, masked, s, body); });
}

// q prescaled; seg (ceil(k_len / block_kv), 4) segments of the transposed
// schedule; dq_acc zeroed float32 (B, q_len, d)
int fa_banded_bwd(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse2, const float* delta, float* dq_acc, void* dk, void* dv,
                  const int* seg, int block_q, int block_kv, int B, int g, int d, int v_d,
                  float dk_scale, const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  a.table = seg;
  a.block_q = block_q;
  a.block_kv = block_kv;
  set_bwd(a, dout, lse2, delta);
  set_fused_out(a, dq_acc, dk, dv, dk_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return bwd_fused_any<decltype(tag), kBanded>(a, s); });
}

// q prescaled; starts (k_pad / sub_kv,) int32 query-band starts, band width
// W (the scalar body); seg (ceil(k_len / 128), 4) int32 the transposed
// band's segments a 128-row kv tile in blocks of 128 (the tensor-core body);
// dq_acc zeroed float32 (B, q_len, d); body (nullable): 1 int out, as
// fa_window_fwd's
int fa_window_bwd(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse2, const float* delta, float* dq_acc, void* dk, void* dv,
                  const int* starts, const int* seg, int band, int sub_kv, int B, int g, int d,
                  int v_d, float dk_scale, int* body, const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_window(a, starts, band, sub_kv);
  set_bwd(a, dout, lse2, delta);
  set_fused_out(a, dq_acc, dk, dv, dk_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype,
                  [&](auto tag) { return window_bwd_any<decltype(tag)>(a, seg, s, body); });
}

}  // extern "C"
