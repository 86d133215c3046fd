// The table-driven attention kernels of the PyTorch port's op path, for
// Hopper (sm_90a).  Shared device code: attention_common.cuh.
//
//   fa_flash_fwd        <- ops/forward.py::_fwd_kernel   (table-driven forward; bf16 and
//                          fp16 on the tensor-core body of attention_fwd_tc.cuh)
//   fa_flash_bwd_fused  <- ops/backward.py::_fused_kernel (kv-outer 5-product backward; bf16
//                          and fp16 at max(d, v_d) <= 128 on the tensor-core body of
//                          attention_bwd_tc.cuh)
//   fa_flash_bwd_dq     <- ops/backward.py::_dq_kernel    (split pair: dQ, q-outer)
//   fa_flash_bwd_dkv    <- ops/backward.py::_dkv_kernel   (split pair: dK/dV, kv-outer)
//   fa_flash_bwd_qouter <- ops/backward.py::_fused_qouter_kernel (q-outer 5-product backward;
//                          bf16 and fp16 at max(d, v_d) <= 128 on the tensor-core body of
//                          attention_qouter_tc.cuh)
//
// The block-skip schedule of schedule.py arrives as three int32 device
// tables (kv_table, kv_counts, needs_mask; the kv-outer kernels get the
// transposed schedule): a CTA visits only the live blocks of its schedule
// row, and evaluates the rule predicate only on tiles with needs_mask != 0.

#include "attention_bwd_tc.cuh"
#include "attention_common.cuh"
#include "attention_fwd_tc.cuh"
#include "attention_qouter_tc.cuh"

namespace {

// dq rows [row0, row0 + 16 RI), columns [cc0, cc0 + 16 DJ) = acc * out_scale
template <typename T, int RI, int DJ>
__device__ __forceinline__ void store_dq(const AttnArgs& a, const float (&acc)[RI][DJ], int b,
                                         int row0, int cc0, int ty, int tx) {
  const int q_len = a.rule.q_len, d = a.d;
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= q_len) continue;
    const size_t base = (static_cast<size_t>(b) * q_len + row) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cc0 + tx + 16 * j;
      if (c < d) dq[base + c] = from_f<T>(acc[i][j] * a.out_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fa_flash_bwd_dq.  Replaces ops/backward.py::_dq_kernel.  One CTA per
// (query row b, BM query rows), q-outer over the schedule like the forward:
// q (prescaled), dO and the stats stay in shared memory, dQ accumulates in
// registers and is multiplied by scale once at the end.  Deterministic.
template <typename T, int BM, int BN, int DMAX>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_kernel(AttnArgs a) {
  constexpr int RI = BM / 16, CJ = BN / 16, DJ = DMAX / 16, LDS = BN + 1;
  extern __shared__ float smem[];
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1;
  float* Qs = smem;
  float* dOs = Qs + BM * ldq;
  float* Ks = dOs + BM * ldv;
  float* Vs = Ks + BN * ldq;
  float* dSs = Vs + BN * ldv;
  float* lse_s = dSs + BM * LDS;
  float* d_s = lse_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * BM, cc0 = blockIdx.z * DMAX;
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b / a.g) * k_len * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b / a.g) * k_len * v_d;
  load_tile(Qs, ldq, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0, BM,
            q_len, d);
  load_tile(dOs, ldv, static_cast<const T*>(a.dout) + static_cast<size_t>(b) * q_len * v_d, row0,
            BM, q_len, v_d);
  load_stats(lse_s, d_s, a, b, row0, BM);
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int qi = row0 / a.block_q;
  const int n_steps = a.counts[qi];
  for (int step = 0; step < n_steps; ++step) {
    const int kblk = a.table[qi * a.num_steps + step];
    const bool masked = a.needs[qi * a.num_steps + step] != 0;
    const int c_end = min((kblk + 1) * a.block_kv, k_len);
    for (int c0 = kblk * a.block_kv; c0 < c_end; c0 += BN) {
      __syncthreads();
      load_tile(Ks, ldq, kb, c0, BN, k_len, d);
      load_tile(Vs, ldv, vb, c0, BN, k_len, v_d);
      __syncthreads();
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
      rows_dot(s, Qs, ldq, Ks, ldq, d, ty, tx);
      rows_dot(dp, dOs, ldv, Vs, ldv, v_d, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool vis = !masked || visible(a.rule, row0 + r, c0 + c);
          const float p = vis ? exp2f(s[i][j] - lse_s[r]) : 0.f;
          dSs[r * LDS + c] = round_to<T>(p * (dp[i][j] - d_s[r]));  // as _dq_kernel
        }
      __syncthreads();
      acc_pv<RI, DJ, BN>(acc, dSs, LDS, 0, Ks + cc0, ldq, d - cc0, ty, tx);
    }
  }
  store_dq<T>(a, acc, b, row0, cc0, ty, tx);
}

// ---------------------------------------------------------------------------
// fa_flash_bwd_qouter.  Replaces ops/backward.py::_fused_qouter_kernel, the
// fused backward in the q-outer orientation: the scalar body of float32 and
// of max(d, v_d) > 128 (bwd_qouter_any).  One CTA per (query row b, BM
// query rows) walking the q-outer schedule, as the dQ kernel: q (prescaled),
// dO and the stats stay in shared memory and dQ accumulates in registers
// (deterministic, scaled at the end).  The TPU kernel accumulates dK and dV
// in whole-sequence VMEM scratch across its sequential grid; here every
// (q tile, kv tile) adds its P^T dO and dS^T q into float32 global buffers
// (B_kv, k_len, ·) with atomicAdd (their last bits vary from run to run),
// scaled (dK by 1/log2e) and cast by one elementwise pass after the kernel.
template <typename T, int BM, int BN, int DMAX>
__global__ void __launch_bounds__(NT, 1) flash_bwd_qouter_kernel(AttnArgs a) {
  constexpr int RI = BM / 16, CJ = BN / 16, NI = BN / 16, DJ = DMAX / 16, LDS = BN + 1;
  extern __shared__ float smem[];
  const int d = a.d, v_d = a.v_d, ldq = d | 1, ldv = v_d | 1;
  float* Qs = smem;
  float* dOs = Qs + BM * ldq;
  float* Ks = dOs + BM * ldv;
  float* Vs = Ks + BN * ldq;
  float* Ps = Vs + BN * ldv;
  float* dSs = Ps + BM * LDS;
  float* lse_s = dSs + BM * LDS;
  float* d_s = lse_s + BM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * BM, bkv = b / a.g, cc0 = blockIdx.z * DMAX;
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(bkv) * k_len * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(bkv) * k_len * v_d;
  float* dk_acc = static_cast<float*>(a.dk) + static_cast<size_t>(bkv) * k_len * d;
  float* dv_acc = static_cast<float*>(a.dv) + static_cast<size_t>(bkv) * k_len * v_d;
  load_tile(Qs, ldq, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0, BM,
            q_len, d);
  load_tile(dOs, ldv, static_cast<const T*>(a.dout) + static_cast<size_t>(b) * q_len * v_d, row0,
            BM, q_len, v_d);
  load_stats(lse_s, d_s, a, b, row0, BM);
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // out[n][c] += sum_r X[r][n] * Y[r][c] over the BM rows, added to dst
  // (rows of `cols` floats), the columns c of this CTA's chunk
  auto add_transposed = [&](const float* X, const float* Y, int ldy, int cols, float* dst,
                            int c0) {
    float t[NI][DJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) t[i][j] = 0.f;
    for (int rr = 0; rr < BM; ++rr) {
      float xn[NI], yv[DJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) xn[i] = X[rr * LDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = cc0 + tx + 16 * j;
        yv[j] = c < cols ? Y[rr * ldy + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) t[i][j] = fmaf(xn[i], yv[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int col = c0 + ty + 16 * i;
      if (col >= k_len) continue;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = cc0 + tx + 16 * j;
        if (c < cols) atomicAdd(dst + static_cast<size_t>(col) * cols + c, t[i][j]);
      }
    }
  };

  const int qi = row0 / a.block_q;
  const int n_steps = a.counts[qi];
  for (int step = 0; step < n_steps; ++step) {
    const int kblk = a.table[qi * a.num_steps + step];
    const bool masked = a.needs[qi * a.num_steps + step] != 0;
    const int c_end = min((kblk + 1) * a.block_kv, k_len);
    for (int c0 = kblk * a.block_kv; c0 < c_end; c0 += BN) {
      __syncthreads();
      load_tile(Ks, ldq, kb, c0, BN, k_len, d);
      load_tile(Vs, ldv, vb, c0, BN, k_len, v_d);
      __syncthreads();
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
      rows_dot(s, Qs, ldq, Ks, ldq, d, ty, tx);
      rows_dot(dp, dOs, ldv, Vs, ldv, v_d, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool vis = !masked || visible(a.rule, row0 + r, c0 + c);
          const float p = vis ? exp2f(s[i][j] - lse_s[r]) : 0.f;
          Ps[r * LDS + c] = round_to<T>(p);  // as _fused_qouter_kernel
          dSs[r * LDS + c] = round_to<T>(p * (dp[i][j] - d_s[r]));
        }
      __syncthreads();
      acc_pv<RI, DJ, BN>(acc, dSs, LDS, 0, Ks + cc0, ldq, d - cc0, ty, tx);  // dQ += dS K
      add_transposed(Ps, dOs, ldv, v_d, dv_acc, c0);                          // dV += P^T dO
      add_transposed(dSs, Qs, ldq, d, dk_acc, c0);                            // dK += dS^T q
    }
  }
  store_dq<T>(a, acc, b, row0, cc0, ty, tx);
}

template <typename T, int BM, int BN, int DMAX>
int bwd_qouter(const AttnArgs& a, cudaStream_t stream) {
  if (!blocks_ok(a, BM, BN)) return cudaErrorInvalidValue;
  return launch(flash_bwd_qouter_kernel<T, BM, BN, DMAX>,
                dim3(blocks(a.rule.q_len, BM), a.B, col_chunks(a, DMAX)),
                bwd_smem(BM, BN, a.d, a.v_d, 2), a, stream);
}

// the fused q-outer backward: bf16 and fp16 with max(d, v_d) <= 128 on the
// tensor-core body, everything else on the scalar body (native.bwd_body
// mirrors this rule, as for bwd_fused_any).  body (nullable, host): 1 where
// the launch took the tensor-core body, else 0.
template <typename T>
int bwd_qouter_any(const AttnArgs& a, cudaStream_t s, int* body) {
  if constexpr (!std::is_same<T, float>::value) {
    if (a.d <= 128 && a.v_d <= 128 && a.rule.q_len > 0 && a.rule.k_len > 0) {
      if (body) *body = 1;
      return tc::qouter_tc<T>(a, s);
    }
  }
  if (body) *body = 0;
  switch (dim_class(a)) {
    case 0: return bwd_qouter<T, 64, 64, 128>(a, s);
    case 1: return bwd_qouter<T, 32, 32, 256>(a, s);
    default: return bwd_qouter<T, 16, 16, WIDE_COLS>(a, s);
  }
}

template <typename T, int BM, int BN, int DMAX>
int bwd_dq(const AttnArgs& a, cudaStream_t stream) {
  if (!blocks_ok(a, BM, BN)) return cudaErrorInvalidValue;
  return launch(flash_bwd_dq_kernel<T, BM, BN, DMAX>,
                dim3(blocks(a.rule.q_len, BM), a.B, blocks(a.d, DMAX)),
                bwd_smem(BM, BN, a.d, a.v_d, 1), a, stream);
}

void set_table(AttnArgs& a, const int* table, const int* counts, const int* needs,
               int num_steps, int block_q, int block_kv) {
  a.table = table;
  a.counts = counts;
  a.needs = needs;
  a.num_steps = num_steps;
  a.block_q = block_q;
  a.block_kv = block_kv;
}

}  // namespace

extern "C" {

// q prescaled (B, q_len, d) -> o (B, q_len, v_d), l and natural-log m (B, q_len)
int fa_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* l,
                 float* m, const int* table, const int* counts, const int* needs,
                 int num_steps, int block_q, int block_kv, int B, int g, int d, int v_d,
                 const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_table(a, table, counts, needs, num_steps, block_q, block_kv);
  a.o = o;
  a.l = l;
  a.m = m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return fwd_any<decltype(tag), kTable>(a, s); });
}

// q prescaled; transposed schedule; dq_acc zeroed float32 (B, q_len, d)
int fa_flash_bwd_fused(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse2, const float* delta, float* dq_acc,
                       void* dk, void* dv, const int* table, const int* counts,
                       const int* needs, int num_steps, int block_q, int block_kv, int B,
                       int g, int d, int v_d, float dk_scale, const FaRule* rule,
                       void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_table(a, table, counts, needs, num_steps, block_q, block_kv);
  set_bwd(a, dout, lse2, delta);
  a.dq_acc = dq_acc;
  a.dk = dk;
  a.dv = dv;
  a.out_scale = dk_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return bwd_fused_any<decltype(tag), kTable>(a, s); });
}

// q prescaled; q-outer schedule; dq (B, q_len, d) = acc * scale
int fa_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                    const float* lse2, const float* delta, void* dq, const int* table,
                    const int* counts, const int* needs, int num_steps, int block_q,
                    int block_kv, int B, int g, int d, int v_d, float scale,
                    const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_table(a, table, counts, needs, num_steps, block_q, block_kv);
  set_bwd(a, dout, lse2, delta);
  a.dq = dq;
  a.out_scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    switch (dim_class(a)) {
      case 0: return bwd_dq<T, 64, 64, 128>(a, s);
      case 1: return bwd_dq<T, 32, 32, 256>(a, s);
      default: return bwd_dq<T, 16, 16, WIDE_COLS>(a, s);
    }
  });
}

// k prescaled, q unscaled; transposed schedule; dk = acc * scale
int fa_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse2, const float* delta, void* dk, void* dv,
                     const int* table, const int* counts, const int* needs, int num_steps,
                     int block_q, int block_kv, int B, int g, int d, int v_d, float scale,
                     const FaRule* rule, void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_table(a, table, counts, needs, num_steps, block_q, block_kv);
  set_bwd(a, dout, lse2, delta);
  a.dk = dk;
  a.dv = dv;
  a.out_scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype,
                  [&](auto tag) { return bwd_kv_any<decltype(tag), false, kTable>(a, s); });
}

// q prescaled; q-outer schedule; dq (B, q_len, d) = acc * scale; dk_acc
// (B_kv, k_len, d) and dv_acc (B_kv, k_len, v_d) zeroed float32, unscaled;
// body (nullable, one int out): 1 for the tensor-core body, 0 the scalar
int fa_flash_bwd_qouter(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse2, const float* delta, void* dq,
                        float* dk_acc, float* dv_acc, const int* table, const int* counts,
                        const int* needs, int num_steps, int block_q, int block_kv, int B,
                        int g, int d, int v_d, float scale, int* body, const FaRule* rule,
                        void* stream) {
  AttnArgs a = make_args(q, k, v, B, g, d, v_d, rule);
  set_table(a, table, counts, needs, num_steps, block_q, block_kv);
  set_bwd(a, dout, lse2, delta);
  a.dq = dq;
  a.dk = dk_acc;
  a.dv = dv_acc;
  a.out_scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) { return bwd_qouter_any<decltype(tag)>(a, s, body); });
}

// the tensor-core building blocks on one tile (tc::tile_check): a, k (64,
// 64) and v (64, 128) of bf16 or fp16 -> s = a k^T (64, 64) and o = s v
// (64, 128), s rounded to the input type before the second product
int fa_tc_tile_check(int dtype, const void* a, const void* k, const void* v, float* s, float* o,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return tc::tile_check<bf16>(a, k, v, s, o, st);
  if (dtype == kF16) return tc::tile_check<__half>(a, k, v, s, o, st);
  return cudaErrorInvalidValue;
}

// the tensor-core backward's products on one tile (tc::bwd_tile_check): x,
// y (64, 64), z (64, 128), dst (128, 64) and kt (128, 128) of bf16 or fp16
// -> st = x y^T (64, 64), o = st z (64, 128) with st rounded to the input
// type, and dq = dst^T kt (64, 128)
int fa_tc_bwd_tile_check(int dtype, const void* x, const void* y, const void* z, const void* dst,
                         const void* kt, float* st, float* o, float* dq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return tc::bwd_tile_check<bf16>(x, y, z, dst, kt, st, o, dq, s);
  if (dtype == kF16) return tc::bwd_tile_check<__half>(x, y, z, dst, kt, st, o, dq, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
