// The forward kernels of the experiment tools, for Hopper (sm_90a).
//
//   fa_exp_resident_fwd <- tools/exp_resident.py::resident_forward (kernel :47, call :96)
//   fa_exp_vpu_ladder   <- tools/exp_vpu_attrib.py::kern (:39, call :96)
//   fa_exp_kv_unroll    <- tools/exp_kv_unroll.py::kern / kern_fused (:41, :78, call :115)
//
// exp_resident runs on the op path's resident tensor-core forward
// (attention_fwd_tc.cuh, kResident with the tool's Merge): causal bf16 attention at
// d <= 128, q prescaled, the tool's merge p = bf16(exp2(bf16(s - m))) with
// l summing the rounded p, no l or m out, walked by persistent CTAs in the
// op path's resident order (row groups, a work counter).  The tool's
// (block_q, block_kv) pair sets what it sets on the TPU: an item is a q
// block of block_q rows (block_q / 128 query tiles that one CTA walks, the
// TPU kernel's grid step), and p rounds against the running maximum of
// block_kv keys, as the tool and its plain version merge: 64-key halves of
// a 128-key stage, one merge a stage at 128, and past 128 a first pass of
// the step's S products for its row maximum.  A tile walks keys [0, 128 t
// + 128), the last stage masked per element: exact causal attention at
// every pair (the tool masks only a q block's last step, wrong when
// block_q > block_kv).  On this card a larger block_q gives fewer and
// longer items (32 at (1024, .) on the tool's (8, 4096), for 132 SMs), and
// block_kv > 128 costs a second S product on each key.
//
// The ladder and kv unroll are one kernel, exp_fwd_kernel: a bf16 forward
// over (B, S, d) sequences (d <= 128) on the tile helpers of
// attention_common.cuh (load_tile, rows_dot, acc_pv) that walks its keys in
// steps.  Each step's scores
// are computed in full before any softmax (the TPU kernels' one grid step,
// or the hoisted matmuls of exp_kv_unroll), kept in shared memory, then
// merged into the running (m, l, acc) one group of keys at a time: the
// step itself, or, for the unrolled kernel without ``fused``, each of its
// nkv blocks in turn.  The merge therefore sees the same row maximum as the
// TPU kernel, so p rounds to bf16 at the same values, which the ladder's
// rungs (noexp above all: p = s - m) depend on.  What differs between the
// two sites is a policy of the merge (the ladder's rungs) and the walk:
//   vpu ladder  - block-causal: q block i sees kv blocks 0..i whole, no
//                 element mask (BQ = BK = 2048 in the tool);
//   kv unroll   - full attention in steps of nkv * block_kv keys.
//
// What bounds them: the scalar FMA rate and shared-memory bandwidth, as the
// op kernels of attention_common.cuh (float32 FMAs on bf16 values staged in
// shared memory; no tensor cores).  A step of up to 2048 keys keeps BM x
// step float32 scores in shared memory (BM = 16 rows at 2048 keys, 32 at up
// to 1024), so a CTA holds few rows and rereads K/V from L2 per row tile.  The ladder on this
// card therefore measures what the softmax chain costs next to scalar
// products, not next to tensor-core ones.
//
// Each extern "C" entry launches one kernel on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include "attention_common.cuh"
#include "attention_fwd_tc.cuh"

namespace {

// the merge policy: the ladder's rungs (exp_vpu_attrib.py:57-80), kProd also
// exp_kv_unroll's merge
enum Policy { kProd = 0, kNoMax = 1, kNoExp = 2, kNoSum = 3, kBf16Exp = 4, kMM = 5 };

constexpr int XBN = 64;  // keys per staged K or V chunk
constexpr int XDMAX = 128;

struct ExpFwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, S, d;
  int step;       // keys whose scores are computed before any merge
  int group;      // keys per merge (divides step)
  int block_q;    // the q block that counts live steps and decides masking
  int causal;     // live steps of q block qi: ceil((qi + 1) * block_q / step), else all
  int elem_mask;  // mask key > query in each step crossing the q block's diagonal
  float score_scale;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int BM, int POL>
__global__ void __launch_bounds__(NT, 1) exp_fwd_kernel(ExpFwdArgs a) {
  constexpr int RI = BM / 16, CJ = XBN / 16, VJ = XDMAX / 16, TPR = NT / BM;
  extern __shared__ float smem[];
  const int d = a.d, ld = d | 1, W = a.step, ldw = W + 1, S = a.S;
  float* Qs = smem;             // BM x ld
  float* KVs = Qs + BM * ld;    // XBN x ld: a K, then a V chunk
  float* Ss = KVs + XBN * ld;   // BM x ldw: the step's scores, then p
  float* m_s = Ss + BM * ldw;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * BM;
  const size_t base = static_cast<size_t>(b) * S * d;
  load_tile(Qs, ld, a.q + base, row0, BM, S, d);
  for (int r = tid; r < BM; r += NT) {
    m_s[r] = neg_inf();
    l_s[r] = 0.f;
  }
  float acc[RI][VJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < VJ; ++j) acc[i][j] = 0.f;

  const int qi = row0 / a.block_q, q_first = qi * a.block_q;
  const int n_steps = a.causal ? ((qi + 1) * a.block_q + W - 1) / W : S / W;
  for (int st = 0; st < n_steps; ++st) {
    const int k0 = st * W;
    const bool masked = a.elem_mask && k0 + W - 1 > q_first;
    for (int c0 = 0; c0 < W; c0 += XBN) {  // pass 1: the whole step's scores
      __syncthreads();
      load_tile(KVs, ld, a.k + base, k0 + c0, XBN, S, d);
      __syncthreads();
      float s[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
      rows_dot(s, Qs, ld, KVs, ld, d, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = c0 + tx + 16 * j;
          const float x = s[i][j] * a.score_scale;
          Ss[r * ldw + c] = masked && k0 + c > row0 + r ? neg_inf() : x;
        }
    }
    for (int g0 = 0; g0 < W; g0 += a.group) {  // pass 2: merge each group
      __syncthreads();
      {  // TPR threads per row
        const int r = tid / TPR, part = tid % TPR;
        float* srow = Ss + r * ldw;
        const float m_prev = m_s[r];
        float m_next = 8.f;  // kNoMax: a constant in place of the running max
        if (POL != kNoMax) {
          float mx = neg_inf();
          for (int c = g0 + part; c < g0 + a.group; c += TPR) mx = fmaxf(mx, srow[c]);
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          m_next = fmaxf(m_prev, mx);
        }
        float sum = 0.f;
        for (int c = g0 + part; c < g0 + a.group; c += TPR) {
          const float x = srow[c];
          float p;
          if (POL == kMM) {
            p = bf16r(x);
          } else if (POL == kBf16Exp) {
            p = __bfloat162float(hexp2(__float2bfloat16_rn(x - m_next)));
            sum += p;
          } else if (POL == kNoExp) {
            const float p32 = x - m_next;
            p = bf16r(p32);
            sum += p32;
          } else {
            const float p32 = exp2f(x - m_next);
            p = bf16r(p32);
            sum += p32;
          }
          srow[c] = p;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (part == 0) {
          const float alpha = POL == kMM ? 1.f : exp2f(m_prev - m_next);
          a_s[r] = alpha;
          if (POL != kMM && POL != kNoSum) l_s[r] = alpha * l_s[r] + sum;
          if (POL != kMM) m_s[r] = m_next;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float alpha = a_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < VJ; ++j) acc[i][j] *= alpha;
      }
      for (int c0 = g0; c0 < g0 + a.group; c0 += XBN) {
        __syncthreads();
        load_tile(KVs, ld, a.v + base, k0 + c0, XBN, S, d);
        __syncthreads();
        acc_pv<RI, VJ, XBN>(acc, Ss, ldw, c0, KVs, ld, d, ty, tx);
      }
    }
  }
  __syncthreads();
  // finalize (exp_vpu_attrib.py:89-91): l == 0 (nosum, mm) leaves o = acc
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    const float l = l_s[r], l_safe = l == 0.f ? 1.f : l;
    bf16* o = a.o + base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = __float2bfloat16_rn(acc[i][j] / l_safe);
    }
  }
}

template <int BM>
size_t exp_fwd_smem(const ExpFwdArgs& a) {
  return floats(static_cast<size_t>(BM + XBN) * (a.d | 1) + static_cast<size_t>(BM) * (a.step + 1) +
                3 * BM);
}

template <int BM, int POL>
int exp_fwd(const ExpFwdArgs& a, cudaStream_t stream) {
  auto kernel = exp_fwd_kernel<BM, POL>;
  const size_t smem = exp_fwd_smem<BM>(a);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.S / BM, a.B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Only what the tools run is instantiated: kProd (exp_kv_unroll, the
// ladder) and kBf16Exp (the ladder) take 32-row CTAs up to
// 1024-key steps and 16 rows at 2048, where 32 rows' scores would not fit;
// the other rungs run only at the ladder's 2048-key steps, on 16 rows at
// every step.
template <int POL>
int exp_fwd_any(const ExpFwdArgs& a, cudaStream_t s) {
  const bool ok = a.B >= 1 && a.B <= 65535 && a.d >= 1 && a.d <= XDMAX && a.step >= XBN &&
                  a.step <= 2048 && a.group >= XBN && a.step % a.group == 0 &&
                  a.group % XBN == 0 && a.S % a.step == 0 && a.block_q % 32 == 0 &&
                  a.S % a.block_q == 0;
  if (!ok) return cudaErrorInvalidValue;
  if constexpr (POL == kProd || POL == kBf16Exp) {
    if (a.step <= 1024) return exp_fwd<32, POL>(a, s);
  }
  return exp_fwd<16, POL>(a, s);
}

ExpFwdArgs exp_args(const void* q, const void* k, const void* v, void* o, int B, int S, int d) {
  ExpFwdArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.B = B;
  a.S = S;
  a.d = d;
  a.score_scale = 1.f;
  return a;
}

}  // namespace

extern "C" {

// q prescaled (bf16 of q * scale * log2e); o (B, S, d) bf16; next_item a
// zeroed int32 counter; walk nullable, 4 host ints as fa_resident_fwd's
int fa_exp_resident_fwd(const void* q, const void* k, const void* v, void* o, int* next_item,
                        int B, int S, int d, int block_q, int block_kv, int* walk,
                        void* stream) {
  if (B < 1 || S < 1 || d < 1 || d > 128 || S % block_kv)
    return cudaErrorInvalidValue;
  FaRule r = {};
  r.ndim = 1;
  r.q_shape[0] = r.k_shape[0] = S;
  r.q_stride[0] = r.k_stride[0] = 1;
  r.kind = kCausal;
  r.q_len = r.k_len = S;
  AttnArgs a = make_args(q, k, v, B, 1, d, d, &r);
  a.next_item = next_item;
  a.block_q = block_q;
  a.block_kv = block_kv;
  a.o = o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_kv == 64) return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpHalves>(a, s, walk);
  if (block_kv == 128) return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpStage>(a, s, walk);
  return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpStep>(a, s, walk);
}

// rung: 0 prod, 1 nomax, 2 noexp, 3 nosum, 4 bf16exp, 5 mm; q prescaled
int fa_exp_vpu_ladder(int rung, const void* q, const void* k, const void* v, void* o, int B,
                      int S, int d, int block_q, int block_kv, void* stream) {
  ExpFwdArgs a = exp_args(q, k, v, o, B, S, d);
  a.step = a.group = block_kv;
  a.block_q = block_q;
  a.causal = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case kProd: return exp_fwd_any<kProd>(a, s);
    case kNoMax: return exp_fwd_any<kNoMax>(a, s);
    case kNoExp: return exp_fwd_any<kNoExp>(a, s);
    case kNoSum: return exp_fwd_any<kNoSum>(a, s);
    case kBf16Exp: return exp_fwd_any<kBf16Exp>(a, s);
    case kMM: return exp_fwd_any<kMM>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// full attention, q unscaled (scores times scale_log2e); nkv blocks of
// block_kv keys a step, one merge per block or (fused) one per step
int fa_exp_kv_unroll(int nkv, int fused, const void* q, const void* k, const void* v, void* o,
                     int B, int S, int d, int block_kv, float scale_log2e, void* stream) {
  ExpFwdArgs a = exp_args(q, k, v, o, B, S, d);
  a.step = nkv * block_kv;
  a.group = fused ? a.step : block_kv;
  a.block_q = S;
  a.score_scale = scale_log2e;
  return exp_fwd_any<kProd>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
