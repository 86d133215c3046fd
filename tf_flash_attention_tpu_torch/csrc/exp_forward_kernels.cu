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
// exp_vpu_ladder and exp_kv_unroll run on the same persistent tensor-core
// body (kResident, Merge kExpGroups): bf16 attention at d <= 128, S
// products and PV products on wgmma fed by TMA (plain loads where d is
// not a multiple of 8), items of 128 query rows taken from a work counter
// (8 x 4096 / 128 = 256 items at the tools' shape, for 132 SMs), each
// walking the block-causal keys [0, ceil((qi + 1) block_q / block_kv)
// block_kv) of its query block qi in groups of block_kv keys with no
// element mask.  What differs between the two sites:
//   vpu ladder  - block-causal (block_q = block_kv = 2048 in the tool: the
//                 second query block's tiles walk twice the keys and go
//                 first in each group of rows); each rung is a compiled
//                 Policy of the merge;
//   kv unroll   - full attention (block_q = S), q unscaled (the S
//                 accumulator times scale_log2e before the maximum), the
//                 kProd policy in groups of block_kv keys (fused: nkv
//                 block_kv).
// The tools' merges need the group's row maximum before any exponential
// (p rounds to bf16 against it, which the rungs, noexp above all, depend
// on), while registers hold one 128-key S tile: so where the policy takes
// a maximum and a group spans more than 128 keys, its K stages are walked
// twice, first for the maximum (S products only), then K and V.  nomax
// and mm take no maximum and merge once a 128-key stage: the same
// function, the float32 sums of l and PV in another order; prod - nomax
// on the ladder is the price of that first pass.  The tool's step (nkv
// block_kv keys of products before any merge) sets nothing here: every
// variant walks group by group, so base, unroll2 and unroll4 run one
// schedule (512-key groups) and unroll2f 1024-key groups; issuing the
// next stage's S products ahead of the current softmax is left open.
//
// What bounds them: the tensor cores' rate (989 TFLOP/s bf16) for the
// products, the first pass adding a second S product on every key it
// covers; the busiest CTA sets the time (the ladder's 64 items of the
// second query block are 2x the first's).
//
// Each extern "C" entry launches one kernel on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include "attention_common.cuh"
#include "attention_fwd_tc.cuh"

namespace {

// the AttnArgs of a tool forward over bf16 (B, S, d) at q_len == k_len == S,
// under a causal rule (exp_resident) or a full one, whose lengths are all
// kExpGroups reads
AttnArgs exp_args(const void* q, const void* k, const void* v, void* o, int* next_item, int B,
                  int S, int d, int block_q, int block_kv, int kind) {
  FaRule r = {};
  r.ndim = 1;
  r.q_shape[0] = r.k_shape[0] = S;
  r.q_stride[0] = r.k_stride[0] = 1;
  r.kind = kind;
  r.q_len = r.k_len = S;
  AttnArgs a = make_args(q, k, v, B, 1, d, d, &r);
  a.next_item = next_item;
  a.block_q = block_q;
  a.block_kv = block_kv;
  a.o = o;
  a.s_scale = 1.f;
  return a;
}

// the ladder and kv_unroll: one body a policy
template <int POL>
int exp_groups(const AttnArgs& a, cudaStream_t s, int* walk) {
  return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpGroups, POL>(a, s, walk);
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
  const AttnArgs a = exp_args(q, k, v, o, next_item, B, S, d, block_q, block_kv, kCausal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_kv == 64)
    return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpHalves, tc::kBf16Exp>(a, s, walk);
  if (block_kv == 128)
    return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpStage, tc::kBf16Exp>(a, s, walk);
  return tc::fwd_tc<bf16, kResident, 128, 128, tc::kExpStep, tc::kBf16Exp>(a, s, walk);
}

// rung: 0 prod, 1 nomax, 2 noexp, 3 nosum, 4 bf16exp, 5 mm (tc::Policy);
// q prescaled; block-causal at block_q, merges of block_kv keys
int fa_exp_vpu_ladder(int rung, const void* q, const void* k, const void* v, void* o,
                      int* next_item, int B, int S, int d, int block_q, int block_kv, int* walk,
                      void* stream) {
  if (B < 1 || S < 1 || d < 1 || d > 128) return cudaErrorInvalidValue;
  const AttnArgs a = exp_args(q, k, v, o, next_item, B, S, d, block_q, block_kv, kFull);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case tc::kProd: return exp_groups<tc::kProd>(a, s, walk);
    case tc::kNoMax: return exp_groups<tc::kNoMax>(a, s, walk);
    case tc::kNoExp: return exp_groups<tc::kNoExp>(a, s, walk);
    case tc::kNoSum: return exp_groups<tc::kNoSum>(a, s, walk);
    case tc::kBf16Exp: return exp_groups<tc::kBf16Exp>(a, s, walk);
    case tc::kMM: return exp_groups<tc::kMM>(a, s, walk);
    default: return cudaErrorInvalidValue;
  }
}

// full attention, q unscaled (scores times scale_log2e); merges of block_kv
// keys or (fused) of the step's nkv block_kv
int fa_exp_kv_unroll(int nkv, int fused, const void* q, const void* k, const void* v, void* o,
                     int* next_item, int B, int S, int d, int block_kv, float scale_log2e,
                     int* walk, void* stream) {
  if (B < 1 || S < 1 || d < 1 || d > 128 || nkv < 1) return cudaErrorInvalidValue;
  AttnArgs a = exp_args(q, k, v, o, next_item, B, S, d, S, fused ? nkv * block_kv : block_kv,
                        kFull);
  a.s_scale = scale_log2e;
  return exp_groups<tc::kProd>(a, static_cast<cudaStream_t>(stream), walk);
}

}  // extern "C"
