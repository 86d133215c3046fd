// The tensor-core q-outer backward of the op path for Hopper (sm_90a): the
// tile body of fa_flash_bwd_qouter (<- ops/backward.py::_fused_qouter_kernel,
// the GQA orientation of the 5-product backward) on bf16 and fp16 inputs
// with max(d, v_d) <= 128.  Included by attention_kernels.cu; float32
// inputs and wider heads stay on the scalar body there (bwd_qouter_any,
// native.bwd_body names the body).
//
// What bounds it on this card is the tensor cores' rate, as for the
// kv-outer body (attention_bwd_tc.cuh), whose mirror it is: the roles of
// the two sides swap.  The TPU kernel keeps dK and dV for the whole
// sequence in VMEM across its sequential grid; here blocks run in parallel,
// so each (CTA, stage) adds its dK and dV partials into float32
// accumulators in device memory, as the kv-outer body adds dQ's.
//   CTA      one per (query row b, 128 query rows), grid (B, query tiles)
//            with the last tiles first (a causal row's longest walks start
//            first): two consumer warpgroups of 64 query rows and a
//            producer warpgroup, of which one warp loads; setmaxnreg gives
//            the producers' registers to the consumers (24 / 240).  The CTA
//            walks its q-outer schedule row (kv_table / kv_counts /
//            needs_mask) in stages of 64 keys.
//   loads    Q, dO and the rows' lse2 and delta once (TMA, 128-row boxes;
//            rows past q_len and columns past d arrive as zeros; the stats
//            by the producer's lanes, DEAD_LSE2 past q_len); K and V through
//            a ring of two 64-key stages (TMA; where a row pitch is not a
//            multiple of 16 bytes the producer warp stages the same swizzled
//            layout with plain loads).  Consumers release a stage once dQ's
//            product has read it.
//   products in the log2 domain on prescaled q, each warpgroup its 64 rows:
//            S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands in
//            shared memory, K-major); P = exp2(S - lse2) on the fragments,
//            masked only in the masked stages (a second compiled body);
//            dS = P (dP - delta); dQ += T(dS) K (m64n128k16, A from the
//            fragments rounded to T pairs, K MN-major through the transpose
//            bit), in registers across the whole walk: deterministic, as in
//            JAX.  p and dS are rounded to T where _fused_qouter_kernel
//            rounds them (before dV; before dK and dQ).
//   dK, dV   each warpgroup writes its rows of T(P) and T(dS) to two shared
//            tiles (128 query rows x 64 keys); after a barrier of the
//            consumers, warpgroup 0 takes the stage's dV partial T(P)^T dO
//            and warpgroup 1 dK's T(dS)^T Q, 64 keys x 128 columns over all
//            128 rows (m64n128k16, A and B MN-major: both transpose bits),
//            writes it to a float box in shared memory and adds the box to
//            the zeroed float32 dv_acc / dk_acc with TMA reduce-adds (two
//            64-column halves; scalar atomics where the widths take no
//            TMA).  The GQA members of a kv row add into the same rows, so
//            dK's and dV's last bits vary from run to run.
//   shared   Q and dO 64 KB, the K/V ring 64 KB, the T(P) and T(dS) tiles
//            32 KB, a 32 KB box a warpgroup: 226 KB of the 227.  So one box
//            a warpgroup, not two: the wait before a box is rewritten is on
//            the reduction's read of it (cp.async.bulk.wait_group.read), so
//            stage i's reduction runs under stage i + 1's products; and one
//            pair of tiles, rewritten after a barrier that the other
//            warpgroup passes only once its partial has read them.
//   finish   dQ * out_scale cast to T, rows past q_len not stored; dK's
//            1/log2e and the casts of dK and dV stay the wrapper's.

#pragma once

#include "attention_bwd_tc.cuh"

namespace {
namespace tc {

constexpr int kQoBM = 128;                          // query rows per CTA
constexpr int kQoBN = 64;                           // keys per stage
constexpr int kQoStages = 2;                        // the K / V ring
constexpr int kQoQTile = 2 * kQoBM * kRowBytes;     // Q or dO: 128 rows, d padded to 128
constexpr int kQoKTile = 2 * kQoBN * kRowBytes;     // a stage's K or V
constexpr int kQoPTile = kQoBM * kRowBytes;         // T(P) or T(dS): query rows x 64 keys
constexpr int kQoBox = kQoBN * 128 * 4;             // a warpgroup's float partial

// calls f(c0, masked) for every 64-key stage of query block qi's schedule row
template <typename F>
__device__ __forceinline__ void for_each_kv_stage(const AttnArgs& a, int qi, F&& f) {
  const int bkv = a.block_kv, k_len = a.rule.k_len;
  for_each_block<kTable>(a, qi, [&](int blk, bool masked) {
    const int end = min((blk + 1) * bkv, k_len);
    for (int c0 = blk * bkv; c0 < end; c0 += kQoBN) f(c0, masked);
  });
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    qouter_tc_kernel(const __grid_constant__ AttnArgs a, const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dkmap,
                     const __grid_constant__ CUtensorMap dvmap, int tma) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Os = Qs + kQoQTile;                      // dO
  unsigned char* KVst = Os + kQoQTile;                    // kQoStages x (K, V)
  unsigned char* Ps = KVst + kQoStages * 2 * kQoKTile;    // T(P)
  unsigned char* Ds = Ps + kQoPTile;                      // T(dS)
  unsigned char* Boxes = Ds + kQoPTile;                   // a float partial per warpgroup
  float* stats = reinterpret_cast<float*>(Boxes + 2 * kQoBox);  // lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + 2 * kQoBM);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kQoStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x, bkv = b / a.g, row0 = (gridDim.y - 1 - blockIdx.y) * kQoBM;
  const int d = a.d, v_d = a.v_d, q_len = a.rule.q_len, k_len = a.rule.k_len;
  const int qi = row0 / a.block_q;
  if (tid == 0) {
    mbar_init(q_full, 32);
    for (int s = 0; s < kQoStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warpgroup: one warp loads ----
    regs_dec<24>();
    if (tid >= kConsumers + 32) return;
    const int lane = tid - kConsumers;
    for (int r = lane; r < kQoBM; r += 32) {
      const int row = row0 + r;
      const size_t i = static_cast<size_t>(b) * q_len + row;
      stats[r] = row < q_len ? a.lse2[i] : DEAD_LSE2;
      stats[kQoBM + r] = row < q_len ? a.delta[i] : 0.f;
    }
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * kQoQTile);
        for (int s = 0; s < 2; ++s) {
          tma_load(Qs + s * kQoBM * kRowBytes, &qmap, q_full, s * kSlabCols, row0, b);
          tma_load(Os + s * kQoBM * kRowBytes, &omap, q_full, s * kSlabCols, row0, b);
        }
      } else {
        mbar_arrive(q_full);
      }
    } else {
      stage_plain(Qs, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0,
                  kQoBM, q_len, 0, 2, d, lane);
      stage_plain(Os, static_cast<const T*>(a.dout) + static_cast<size_t>(b) * q_len * v_d,
                  row0, kQoBM, q_len, 0, 2, v_d, lane);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    int it = 0;
    for_each_kv_stage(a, qi, [&](int c0, bool) {
      const int st = it % kQoStages;
      if (it >= kQoStages) mbar_wait(empty + st, ((it / kQoStages) & 1) ^ 1);
      unsigned char* ks = KVst + st * 2 * kQoKTile;
      unsigned char* vs = ks + kQoKTile;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * kQoKTile);
          for (int s = 0; s < 2; ++s) {
            tma_load(ks + s * kQoBN * kRowBytes, &kmap, full + st, s * kSlabCols, c0, bkv);
            tma_load(vs + s * kQoBN * kRowBytes, &vmap, full + st, s * kSlabCols, c0, bkv);
          }
        } else {
          mbar_arrive(full + st);
        }
      } else {
        stage_plain(ks, static_cast<const T*>(a.k) + static_cast<size_t>(bkv) * k_len * d, c0,
                    kQoBN, k_len, 0, 2, d, lane);
        stage_plain(vs, static_cast<const T*>(a.v) + static_cast<size_t>(bkv) * k_len * v_d, c0,
                    kQoBN, k_len, 0, 2, v_d, lane);
        fence_proxy_async();
        mbar_arrive(full + st);
      }
      ++it;
    });
    return;
  }

  // ---- the consumer warpgroups: query rows row0 + 64 wg + [0, 64) ----
  regs_inc<240>();
  const int wg = tid / 128, w = (tid / 32) & 3, lane = tid & 31;
  // fragment element i of S, dP and dQ: tile row qr + 8 ((i >> 1) & 1),
  // key (or column) 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  const int qr = 64 * wg + 16 * w + (lane >> 2);
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const uint64_t q_desc = make_desc(Qs + 64 * wg * kRowBytes, 16, 1024);
  const uint64_t o_desc = make_desc(Os + 64 * wg * kRowBytes, 16, 1024);
  // the partial's operands: warpgroup 0 dV's (T(P), dO), warpgroup 1 dK's
  // (T(dS), Q), both MN-major
  const uint64_t pa_desc = make_desc(wg == 0 ? Ps : Ds, kQoPTile, 1024);
  const uint64_t pb_desc = make_desc(wg == 0 ? Os : Qs, kQoBM * kRowBytes, 1024);
  const int part_cols = wg == 0 ? v_d : d;
  mbar_wait(q_full, 0);
  float l2[2], dl[2];
  SeqPos qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] = stats[qr + 8 * h];
    dl[h] = stats[kQoBM + qr + 8 * h];
    qpos[h] = q_pos_of(a.rule, row0 + qr + 8 * h);
  }

  int it = 0;
  auto body = [&](int c0, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int st = it % kQoStages;
    unsigned char* ks = KVst + st * 2 * kQoKTile;
    unsigned char* vs = ks + kQoKTile;
    mbar_wait(full + st, (it / kQoStages) & 1);

    // S = Q K^T and dP = dO V^T over the padded width
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    const uint64_t k_desc = make_desc(ks, 16, 1024), v_desc = make_desc(vs, 16, 1024);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<T>(s, q_desc + ((slab * kQoBM * kRowBytes + off) >> 4),
                      k_desc + ((slab * kQoBN * kRowBytes + off) >> 4));
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<T>(dp, o_desc + ((slab * kQoBM * kRowBytes + off) >> 4),
                      v_desc + ((slab * kQoBN * kRowBytes + off) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = exp2(S - lse2) (masked: 0) and dS = P (dP - delta), per key
    // column of the thread
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool vis[2] = {true, true};
        if constexpr (MASKED) {
          const SeqPos kp = k_pos_of(a.rule, c0 + 8 * j + 2 * (lane & 3) + e);
#pragma unroll
          for (int h = 0; h < 2; ++h) vis[h] = visible(a.rule, qpos[h], kp);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float p = vis[h] ? exp2f(s[i] - l2[h]) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl[h]);
        }
      }
    }
    // rounded to T as the A fragments of four 16-key k-slices
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
      da[i] = pack2<T>(dp[2 * i], dp[2 * i + 1]);
    }

    // dQ += T(dS) K, K through the transpose bit
    const uint64_t kt_desc = make_desc(ks, kQoBN * kRowBytes, 1024);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<T>(dq, da + 4 * kk, kt_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();

    // this warpgroup's rows of T(P) and T(dS) into the tiles, once the other
    // warpgroup's partial of the last stage has read them
    consumers_sync();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = swz(qr + 8 * (j & 1), 16 * kk + 8 * (j >> 1) + 2 * (lane & 3), kQoBM);
        *reinterpret_cast<uint32_t*>(Ps + off) = pa[4 * kk + j];
        *reinterpret_cast<uint32_t*>(Ds + off) = da[4 * kk + j];
      }
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(dq);
    mbar_arrive(empty + st);  // K and V have been read
    consumers_sync();         // both warpgroups' rows are in the tiles

    // the stage's partial over the 128 rows: warpgroup 0 dV = T(P)^T dO,
    // warpgroup 1 dK = T(dS)^T Q (64 keys x 128 columns)
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQoBM / 16; ++kk)
      wgmma_ss_n128<T, 1, 1>(part, pa_desc + ((kk * 16 * kRowBytes) >> 4),
                             pb_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    // element i: key c0 + 16 w + (lane >> 2) + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2 (lane & 3) + (i & 1)
    if (tma) {
      float* box = reinterpret_cast<float*>(Boxes + wg * kQoBox);  // two 64 x 64 halves
      if (tid % 128 == 0) bulk_wait_read();  // the last stage's box has been read
      warpgroup_sync(wg);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(box + (j >> 3) * 64 * 64 +
                                     (16 * w + (lane >> 2) + 8 * h) * 64 + 8 * (j & 7) +
                                     2 * (lane & 3)) =
              make_float2(part[4 * j + 2 * h], part[4 * j + 2 * h + 1]);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (tid % 128 == 0)
        for (int half = 0; half < 2 && 64 * half < part_cols; ++half)
          tma_reduce_add(wg == 0 ? &dvmap : &dkmap, box + half * 64 * 64, 64 * half, c0, bkv);
    } else {
      float* acc = (wg == 0 ? static_cast<float*>(a.dv) : static_cast<float*>(a.dk)) +
                   static_cast<size_t>(bkv) * k_len * part_cols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = c0 + 16 * w + (lane >> 2) + 8 * h;
        if (key >= k_len) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane & 3) + e;
            if (c < part_cols)
              atomicAdd(acc + static_cast<size_t>(key) * part_cols + c, part[4 * j + 2 * h + e]);
          }
      }
    }
    ++it;
  };
  for_each_kv_stage(a, qi, [&](int c0, bool masked) {
    if (masked)
      body(c0, std::true_type{});
    else
      body(c0, std::false_type{});
  });
  if (tid % 128 == 0) bulk_wait();  // the reductions are done with shared memory

  // dQ * out_scale, cast to T
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + qr + 8 * h;
    if (row >= q_len) continue;
    const size_t base = (static_cast<size_t>(b) * q_len + row) * d;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        if (c < d) dqp[base + c] = from_f<T>(dq[4 * j + 2 * h + e] * a.out_scale);
      }
  }
}

// ---- host side ----

constexpr size_t kQoSmem = 1024 + 2 * kQoQTile + kQoStages * 2 * kQoKTile + 2 * kQoPTile +
                           2 * kQoBox + 2 * kQoBM * sizeof(float) + 8 * (1 + 2 * kQoStages);
static_assert(kQoSmem <= MAX_SMEM, "the q-outer body's tiles exceed a block's shared memory");

template <typename T>
int qouter_tc(const AttnArgs& a, cudaStream_t stream) {
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  const int tiles = blocks(q_len, kQoBM);
  if (a.d < 1 || a.v_d < 1 || a.d > 128 || a.v_d > 128 || !dims_ok(a) || a.block_q % kQoBM ||
      a.block_kv % kQoBN || q_len < 1 || k_len < 1 || tiles > 65535)
    return cudaErrorInvalidValue;
  const int B_kv = a.B / a.g;
  CUtensorMap qm, om, km, vm, dkm, dvm;
  memset(&qm, 0, sizeof(qm));
  memset(&om, 0, sizeof(om));
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  memset(&dkm, 0, sizeof(dkm));
  memset(&dvm, 0, sizeof(dvm));
  const bool tma = a.d % 8 == 0 && a.v_d % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout) && aligned16(a.dk) && aligned16(a.dv);
  // dk_acc's and dv_acc's float (64 columns x 64 rows) boxes, unswizzled
  if (tma && !(tensor_map<T>(&qm, a.q, a.d, q_len, a.B, kQoBM) &&
               tensor_map<T>(&om, a.dout, a.v_d, q_len, a.B, kQoBM) &&
               tensor_map<T>(&km, a.k, a.d, k_len, B_kv, kQoBN) &&
               tensor_map<T>(&vm, a.v, a.v_d, k_len, B_kv, kQoBN) &&
               encode_map(&dkm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dk, {a.d, k_len, B_kv}, 64,
                          kQoBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
               encode_map(&dvm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dv, {a.v_d, k_len, B_kv},
                          64, kQoBN, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  auto kernel = qouter_tc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kQoSmem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.B, tiles), kBwdThreads, kQoSmem, stream>>>(a, qm, om, km, vm, dkm, dvm,
                                                             tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
