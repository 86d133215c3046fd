// The tensor-core forward of the op path for Hopper (sm_90a): the tile body
// of fa_flash_fwd (kTable, <- ops/forward.py::_fwd_kernel) and fa_banded_fwd
// (kBanded, <- ops/forward_banded.py::_banded_kernel) on bf16 and fp16
// inputs.  Included by attention_kernels.cu and band_kernels.cu after
// attention_common.cuh; float32 inputs stay on the scalar body there (full
// float32 products: TF32 would not hold the float32 limit).
//
// What bounds the forward on this card is the tensor cores' rate (989
// TFLOP/s bf16): at d 128 a query row does 4 d = 512 flops per visible key
// against 2 d bytes of K/V read per key per 128-row CTA.  The design keeps
// the tensor cores fed:
//   CTA      one per (query row b, 128 query rows, 256-column chunk of v_d):
//            two consumer warpgroups of 64 rows and one producer warp.  The
//            CTA walks its schedule row as the scalar body does (kTable: the
//            kv_table / kv_counts / needs_mask row; kBanded: the four band
//            ints) in stages of BN keys.  Query tiles launch last-first, so
//            a causal row's long tiles start first and the short ones fill
//            the tail.
//   operands stay in the input type in shared memory, in slabs of 64
//            columns (128 bytes a row) in the 128-byte swizzle that wgmma's
//            descriptors read: Q once, K and V in a ring of two stages.
//   loads    the producer issues TMA copies (cp.async.bulk.tensor, 3-d maps
//            (cols, rows, batch) so rows past q_len / k_len and columns past
//            d / v_d arrive as zeros) completing on mbarriers; where a row
//            pitch is not a multiple of 16 bytes (d or v_d not a multiple of
//            8) the producer warp stages the same layout with plain loads.
//            Consumers release a stage on its empty barrier once their
//            products have read it.
//   products S = Q K^T: wgmma m64nBNk16, both operands in shared memory,
//            unrolled over the class's width (d padded with zeros to 128,
//            256 or 512: 128-, 64- or 32-key stages) so the products
//            pipeline.  O += P V: wgmma m64nVNk16 with P from registers (the
//            S accumulator fragments rounded to T pairs) and V MN-major
//            through the descriptor's transpose bit.  The two wide classes
//            (VN = 256) hold 128 accumulators a thread, and ptxas serializes
//            their products for want of registers.
//   softmax  in registers on the accumulator fragments, in the log2 domain
//            as the scalar body: row max and sum across each quad by
//            shuffles, m and l in registers, no score tile in shared memory
//            and no barrier per tile.  p is rounded to T for PV while l sums
//            the float32 p, as the JAX kernels do.  Masked stages run a body
//            compiled with visible() per element (the orders of the thread's
//            rows and columns computed once a stage); interior stages run one
//            compiled without it: a single body with a run-time test paid the
//            predicate on every stage.  Masked logits take the finite 0xFA
//            value; dead rows get O = 0, l = 0, m = NEG_INF.
// The building blocks (barriers, TMA, swizzle, descriptors, wgmma) are
// tc_common.cuh's, shared with the backward of attention_bwd_tc.cuh.

#pragma once

#include "tc_common.cuh"

namespace {
namespace tc {

constexpr int kBM = 128;                     // query rows per CTA
constexpr int kThreads = kConsumers + 32;    // two consumer warpgroups, a producer warp
// the 64-column slabs of Q and K of each class (by its stage of BN keys):
// d <= 128, <= 256, <= 512
__host__ __device__ constexpr int slabs_of(int bn) { return bn == 128 ? 2 : bn == 64 ? 4 : 8; }
constexpr int kStages = 2;  // the K/V ring (a third stage measured no faster)

// calls f(c0, masked) for every BN-key stage of the CTA's walk, in order
template <int WALK, int BN, typename F>
__device__ __forceinline__ void for_each_stage(const AttnArgs& a, int qi, F&& f) {
  const int bkv = a.block_kv, k_len = a.rule.k_len;
  for_each_block<WALK>(a, qi, [&](int blk, bool masked) {
    const int end = min((blk + 1) * bkv, k_len);
    for (int c0 = blk * bkv; c0 < end; c0 += BN) f(c0, masked);
  });
}

template <typename T, int WALK, int BN, int VN>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_tc_kernel(const __grid_constant__ AttnArgs a, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, int tma) {
  constexpr int VS = VN / kSlabCols;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int d = a.d, v_d = a.v_d, q_len = a.rule.q_len, k_len = a.rule.k_len;
  constexpr int ds = slabs_of(BN);  // Q and K slabs: d padded to the class's width
  const int k_bytes = ds * BN * kRowBytes, stage_bytes = k_bytes + VS * BN * kRowBytes;
  unsigned char* stages = Qs + ds * kBM * kRowBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kStages * stage_bytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x, row0 = (gridDim.y - 1 - blockIdx.y) * kBM, vc0 = blockIdx.z * VN;
  const int qi = row0 / a.block_q, bkv_row = b / a.g;
  if (tid == 0) {
    mbar_init(q_full, tma ? 1 : 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, tma ? 1 : 32);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warp ----
    const int lane = tid - kConsumers;
    const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(bkv_row) * k_len * d;
    const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(bkv_row) * k_len * v_d;
    if (tma) {
      if (lane != 0) return;
      mbar_expect_tx(q_full, ds * kBM * kRowBytes);
      for (int s = 0; s < ds; ++s)
        tma_load(Qs + s * kBM * kRowBytes, &qmap, q_full, s * kSlabCols, row0, b);
    } else {
      stage_plain(Qs, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0, kBM,
                  q_len, 0, ds, d, lane);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    int it = 0;
    for_each_stage<WALK, BN>(a, qi, [&](int c0, bool) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
      unsigned char* ks = stages + st * stage_bytes;
      if (tma) {
        mbar_expect_tx(full + st, stage_bytes);
        for (int s = 0; s < ds; ++s)
          tma_load(ks + s * BN * kRowBytes, &kmap, full + st, s * kSlabCols, c0, bkv_row);
        for (int s = 0; s < VS; ++s)
          tma_load(ks + k_bytes + s * BN * kRowBytes, &vmap, full + st, vc0 + s * kSlabCols, c0,
                   bkv_row);
      } else {
        stage_plain(ks, kb, c0, BN, k_len, 0, ds, d, lane);
        stage_plain(ks + k_bytes, vb, c0, BN, k_len, vc0, VS, v_d, lane);
        fence_proxy_async();
        mbar_arrive(full + st);
      }
      ++it;
    });
    return;
  }

  // ---- the consumer warpgroups: rows row0 + 64 wg + [0, 64) ----
  const int wg = tid / 128, w = (tid / 32) & 3, lane = tid & 31;
  const int r_base = row0 + 64 * wg + 16 * w + (lane >> 2);  // and r_base + 8
  float o_acc[VN / 2];
#pragma unroll
  for (int i = 0; i < VN / 2; ++i) o_acc[i] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_part[2] = {0.f, 0.f};
  const uint64_t q_desc = make_desc(Qs + 64 * wg * kRowBytes, 16, 1024);
  mbar_wait(q_full, 0);

  // one stage; MASKED (a compile-time tag) applies the rule predicate, the
  // interior stages compile without it
  int it = 0;
  auto body = [&](int c0, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int st = it % kStages;
    unsigned char* ks = stages + st * stage_bytes;
    mbar_wait(full + st, (it / kStages) & 1);

    // S = Q K^T (log2-domain logits: q arrives prescaled): every k-step of
    // the class, unrolled so the products pipeline (Q and K past d are zero)
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    const uint64_t k_desc = make_desc(ks, 16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * ds; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      mma_qk<BN, T>(s, q_desc + ((slab * kBM * kRowBytes + off) >> 4),
                    k_desc + ((slab * BN * kRowBytes + off) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // element i of the fragment: row r_base + 8 ((i >> 1) & 1), column
    // c0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1); the orders of the thread's
    // two rows and BN / 4 columns come once a stage
    if constexpr (MASKED) {
      const SeqPos rows[2] = {q_pos_of(a.rule, r_base), q_pos_of(a.rule, r_base + 8)};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const SeqPos col = k_pos_of(a.rule, c0 + 8 * j + 2 * (lane & 3) + e);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (!visible(a.rule, rows[h], col)) s[4 * j + 2 * h + e] = neg_inf();
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
    }
    // masked logits hold NEG_INF: exp2(NEG_INF - m) == 0 for a live row; a
    // row with no visible key yet is repaired at the end
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m_run[h]);
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_part[h] = alpha[h] * l_part[h] + rs[h];
#pragma unroll
    for (int i = 0; i < VN / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    // P as the A fragments of BN / 16 k-slices, rounded to T
    uint32_t p[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);

    // O += P V
    const uint64_t v_desc = make_desc(ks + k_bytes, BN * kRowBytes, 1024);
    fence_regs(o_acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      mma_pv<VN, T>(o_acc, p + 4 * kk, v_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    mbar_arrive(empty + st);
    ++it;
  };
  for_each_stage<WALK, BN>(a, qi, [&](int c0, bool masked) {
    if (masked)
      body(c0, std::true_type{});
    else
      body(c0, std::false_type{});
  });

  // the forward finalize (forward.py:225-243), as fwd_finalize
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_part[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r_base + 8 * h;
    if (row >= q_len) continue;
    const bool dead = m_run[h] <= neg_inf();
    if (dead) l = 0.f;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const size_t orow = static_cast<size_t>(b) * q_len + row;
    T* o = static_cast<T*>(a.o) + orow * v_d;
#pragma unroll
    for (int j = 0; j < VN / 8; ++j) {
      const int c = vc0 + 8 * j + 2 * (lane & 3);
      const float x = dead ? 0.f : o_acc[4 * j + 2 * h] * inv;
      const float y = dead ? 0.f : o_acc[4 * j + 2 * h + 1] * inv;
      if (c < v_d) o[c] = from_f<T>(x);
      if (c + 1 < v_d) o[c + 1] = from_f<T>(y);
    }
    if (blockIdx.z == 0 && (lane & 3) == 0) {
      a.l[orow] = l;
      a.m[orow] = dead ? neg_inf() : m_run[h] * INV_LOG2E;
    }
  }
}

// The building blocks on one tile, for the card tests: one warpgroup
// stages a (64 x 64), k (64 x 64) and v (64 x 128) as the forward does and
// computes s = a k^T (the S product, N = 64) and o = T(s) v (the PV
// product, P from registers, V through the transpose bit), both float32.
template <typename T>
__global__ void __launch_bounds__(128) tile_check_kernel(const T* a, const T* k, const T* v,
                                                         float* s_out, float* o_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);
  unsigned char* Ks = As + 64 * kRowBytes;
  unsigned char* Vs = Ks + 64 * kRowBytes;
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31;
  stage_plain(As, a, 0, 64, 64, 0, 1, 64, tid, 128);
  stage_plain(Ks, k, 0, 64, 64, 0, 1, 64, tid, 128);
  stage_plain(Vs, v, 0, 64, 64, 0, 2, 128, tid, 128);
  fence_proxy_async();
  __syncthreads();
  float s[32], o[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint64_t da = make_desc(As, 16, 1024), dk = make_desc(Ks, 16, 1024);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_qk<64, T>(s, da + ((kk * 32) >> 4), dk + ((kk * 32) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
  const uint64_t dv = make_desc(Vs, 64 * kRowBytes, 1024);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_pv<128, T>(o, p + 4 * kk, dv + ((kk * 16 * kRowBytes) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  const int r = 16 * w + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[(r + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = s[i];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    o_out[(r + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = o[i];
}

template <typename T>
int tile_check(const void* a, const void* k, const void* v, float* s, float* o,
               cudaStream_t stream) {
  const int smem = 1024 + 4 * 64 * kRowBytes;
  tile_check_kernel<T><<<1, 128, smem, stream>>>(static_cast<const T*>(a),
                                                 static_cast<const T*>(k),
                                                 static_cast<const T*>(v), s, o);
  return cudaGetLastError();
}

size_t fwd_tc_smem(int bn, int vn) {
  const int ds = slabs_of(bn);
  return 1024 + static_cast<size_t>(ds) * kBM * kRowBytes +
         static_cast<size_t>(kStages) * (ds + vn / kSlabCols) * bn * kRowBytes +
         8 * (1 + 2 * kStages);
}

template <typename T, int WALK, int BN, int VN>
int fwd_tc(const AttnArgs& a, cudaStream_t stream) {
  if (a.d < 1 || a.v_d < 1 || a.d > kSlabCols * slabs_of(BN) || a.g < 1 || a.B % a.g ||
      a.block_q % kBM || a.block_kv % BN || a.block_kv % 128 || a.rule.q_len < 1)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_tc_smem(BN, VN);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  const int B_kv = a.B / a.g, q_len = a.rule.q_len, k_len = a.rule.k_len;
  CUtensorMap qm, km, vm;
  memset(&qm, 0, sizeof(qm));
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  const bool tma = a.d % 8 == 0 && a.v_d % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && k_len > 0;
  if (tma && !(tensor_map<T>(&qm, a.q, a.d, q_len, a.B, kBM) &&
               tensor_map<T>(&km, a.k, a.d, k_len, B_kv, BN) &&
               tensor_map<T>(&vm, a.v, a.v_d, k_len, B_kv, BN)))
    return cudaErrorInvalidValue;
  auto kernel = fwd_tc_kernel<T, WALK, BN, VN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, blocks(q_len, kBM), blocks(a.v_d, VN));
  kernel<<<grid, kThreads, smem, stream>>>(a, qm, km, vm, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

// the forward of kTable and kBanded: bf16 and fp16 on the tensor-core body
// (its class by d and v_d), float32 on the scalar body
template <typename T, int WALK>
int fwd_any(const AttnArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    return fwd_scalar_any<T, WALK>(a, s);
  } else {
    if (a.d <= 128 && a.v_d <= 128) return tc::fwd_tc<T, WALK, 128, 128>(a, s);
    if (a.d <= 256) return tc::fwd_tc<T, WALK, 64, 256>(a, s);
    return tc::fwd_tc<T, WALK, 32, 256>(a, s);
  }
}

}  // namespace
