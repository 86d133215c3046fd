// The tensor-core backward of the op path for Hopper (sm_90a): the tile body
// of fa_flash_bwd_fused (kTable, <- ops/backward.py::_fused_kernel) and
// fa_banded_bwd (kBanded, <- ops/backward.py::_fused_banded_kernel) on bf16
// and fp16 inputs with max(d, v_d) <= 128.  Included by attention_kernels.cu
// and band_kernels.cu; float32 inputs, wider heads, the window walk and the
// split dK/dV kernel stay on the scalar body of attention_common.cuh.
//
// What bounds the backward on this card is the tensor cores' rate (989
// TFLOP/s bf16): five products of 2 d flops per visible (query, key) pair
// and head dim, against one read of q, k, v, dO and the stats.  The design,
// on the forward's building blocks (tc_common.cuh):
//   CTA      one per (kv row b_kv, 128 kv rows): two consumer warpgroups of
//            64 kv rows and a producer warpgroup, of which one warp loads;
//            setmaxnreg gives the producers' registers to the consumers
//            (240 a thread: dK, dV, S^T and dP^T alone take 192; at the
//            even share of 168 they spilled and ptxas serialized their
//            products).  The CTA walks the transposed schedule as the
//            scalar body does (kTable: the kv_table / kv_counts / needs_mask
//            row; kBanded: the four band ints) in stages of 64 query rows,
//            and within each stage every query head of the GQA group (JAX's
//            member loop).  dK and dV accumulate in registers across the
//            whole walk.
//   loads    K and V once (TMA, 128-row boxes); Q, dO and the stage's lse2
//            and delta rows through a ring of two stages, Q and dO by TMA
//            (64-row boxes; rows past q_len and columns past d arrive as
//            zeros), the stats by the producer's lanes (DEAD_LSE2 past
//            q_len).  Where a row pitch is not a multiple of 16 bytes the
//            producer warp stages the same swizzled layout with plain loads.
//            Consumers release a stage on its empty barrier once dV and dK
//            have read it.
//   products in the log2 domain on prescaled q, each warpgroup its 64 kv
//            rows: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//            operands in shared memory, K-major); P^T = exp2(S^T - lse2) on
//            the accumulator fragments, masked only in the masked stages (a
//            second compiled body: the interior stages carry no visible());
//            dS^T = P^T (dP^T - delta); dV += T(P^T) dO and dK += T(dS^T) Q
//            (m64n128k16, A from the fragments rounded to T pairs, dO and Q
//            MN-major through the transpose bit).  p and dS are rounded to T
//            where the JAX kernels round them.
//   dQ       each warpgroup writes its rows of T(dS^T) to a shared tile (two
//            buffers); after a barrier of the consumers, warpgroup w takes
//            dQ's columns 64 w + [0, 64) over all 128 kv rows (m64n64k16, A =
//            the dS^T tile MN-major, B = K MN-major: both transpose bits),
//            writes them to a float tile in shared memory and adds the tile
//            to the zeroed float32 accumulator dq_acc with one TMA
//            reduce-add (scalar atomics where the widths take no TMA): the
//            (kv tile, stage) pairs of the training slice add about 570 MB,
//            and float2 atomics straight from the fragments, eight rows a
//            warp instruction, took most of the kernel's time on the H100.
//            dQ's last bits vary from run to run.  A null dq_acc skips this
//            part (a measurement of what it costs).
//   finish   dK * out_scale and dV cast to T, rows past k_len not stored.

#pragma once

#include "attention_common.cuh"
#include "tc_common.cuh"

namespace {
namespace tc {

constexpr int kBKV = 128;      // kv rows per CTA: 64 per consumer warpgroup
constexpr int kBQ = 64;        // query rows per stage
constexpr int kBwdSlabs = 2;   // d and v_d padded to 128 with zeros
constexpr int kBwdStages = 2;  // the Q / dO ring
constexpr int kBwdThreads = kConsumers + 128;  // and the producer warpgroup

// calls f(r0, mem, masked) for every 64-row query stage of the CTA's walk
// over the transposed schedule, for every member of the GQA group, in order
template <int WALK, typename F>
__device__ __forceinline__ void for_each_q_stage(const AttnArgs& a, int ki, F&& f) {
  const int bq = a.block_q, q_len = a.rule.q_len;
  for_each_block<WALK>(a, ki, [&](int blk, bool masked) {
    const int end = min((blk + 1) * bq, q_len);
    for (int r0 = blk * bq; r0 < end; r0 += kBQ)
      for (int mem = 0; mem < a.g; ++mem) f(r0, mem, masked);
  });
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}
// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// the byte sizes of the CTA's shared tiles
constexpr int kKVTile = kBwdSlabs * kBKV * kRowBytes;  // K or V
constexpr int kQTile = kBwdSlabs * kBQ * kRowBytes;    // a stage's Q or dO
constexpr int kDsTile = kBKV * kRowBytes;              // dS^T: kv rows x 64 queries
constexpr int kDqTile = kBQ * 64 * 4;                  // a warpgroup's float dQ box

template <typename T, int WALK>
__global__ void __launch_bounds__(kBwdThreads, 1)
    bwd_tc_kernel(const __grid_constant__ AttnArgs a, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap dqmap, int tma) {
  constexpr int S = kBwdSlabs;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + kKVTile;
  unsigned char* Qst = Vs + kKVTile;               // kBwdStages Q tiles
  unsigned char* Ost = Qst + kBwdStages * kQTile;  // kBwdStages dO tiles
  unsigned char* Dst = Ost + kBwdStages * kQTile;  // two dS^T tiles
  unsigned char* DQs = Dst + 2 * kDsTile;          // a float dQ box per warpgroup
  float* stats = reinterpret_cast<float*>(DQs + 2 * kDqTile);  // lse2, delta per stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + kBwdStages * 2 * kBQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kBwdStages;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.y, col0 = blockIdx.x * kBKV, ki = col0 / a.block_kv;
  const int d = a.d, v_d = a.v_d, q_len = a.rule.q_len, k_len = a.rule.k_len;
  if (tid == 0) {
    mbar_init(kv_full, 32);
    for (int s = 0; s < kBwdStages; ++s) {
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
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kKVTile);
        for (int s = 0; s < S; ++s) {
          tma_load(Ks + s * kBKV * kRowBytes, &kmap, kv_full, s * kSlabCols, col0, bkv);
          tma_load(Vs + s * kBKV * kRowBytes, &vmap, kv_full, s * kSlabCols, col0, bkv);
        }
      } else {
        mbar_arrive(kv_full);
      }
    } else {
      stage_plain(Ks, static_cast<const T*>(a.k) + static_cast<size_t>(bkv) * k_len * d, col0,
                  kBKV, k_len, 0, S, d, lane);
      stage_plain(Vs, static_cast<const T*>(a.v) + static_cast<size_t>(bkv) * k_len * v_d, col0,
                  kBKV, k_len, 0, S, v_d, lane);
      fence_proxy_async();
      mbar_arrive(kv_full);
    }
    int it = 0;
    for_each_q_stage<WALK>(a, ki, [&](int r0, int mem, bool) {
      const int st = it % kBwdStages, b = bkv * a.g + mem;
      if (it >= kBwdStages) mbar_wait(empty + st, ((it / kBwdStages) & 1) ^ 1);
      float* lse = stats + st * 2 * kBQ;
      for (int r = lane; r < kBQ; r += 32) {
        const int row = r0 + r;
        const size_t i = static_cast<size_t>(b) * q_len + row;
        lse[r] = row < q_len ? a.lse2[i] : DEAD_LSE2;
        lse[kBQ + r] = row < q_len ? a.delta[i] : 0.f;
      }
      unsigned char* qs = Qst + st * kQTile;
      unsigned char* os = Ost + st * kQTile;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * kQTile);
          for (int s = 0; s < S; ++s) {
            tma_load(qs + s * kBQ * kRowBytes, &qmap, full + st, s * kSlabCols, r0, b);
            tma_load(os + s * kBQ * kRowBytes, &omap, full + st, s * kSlabCols, r0, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      } else {
        stage_plain(qs, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, r0,
                    kBQ, q_len, 0, S, d, lane);
        stage_plain(os, static_cast<const T*>(a.dout) + static_cast<size_t>(b) * q_len * v_d,
                    r0, kBQ, q_len, 0, S, v_d, lane);
        fence_proxy_async();
        mbar_arrive(full + st);
      }
      ++it;
    });
    return;
  }

  // ---- the consumer warpgroups: kv rows col0 + 64 wg + [0, 64) ----
  regs_inc<240>();
  const int wg = tid / 128, w = (tid / 32) & 3, lane = tid & 31;
  // fragment element i: kv row kr + 8 ((i >> 1) & 1) of the tile, query (or
  // column) 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  const int kr = 64 * wg + 16 * w + (lane >> 2);
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t k_desc = make_desc(Ks + 64 * wg * kRowBytes, 16, 1024);
  const uint64_t v_desc = make_desc(Vs + 64 * wg * kRowBytes, 16, 1024);
  mbar_wait(kv_full, 0);

  int it = 0;
  auto body = [&](int r0, int mem, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int st = it % kBwdStages;
    unsigned char* qs = Qst + st * kQTile;
    unsigned char* os = Ost + st * kQTile;
    const float* lse = stats + st * 2 * kBQ;
    mbar_wait(full + st, (it / kBwdStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over the padded width
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    const uint64_t q_desc = make_desc(qs, 16, 1024), o_desc = make_desc(os, 16, 1024);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * S; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<T>(s, k_desc + ((slab * kBKV * kRowBytes + off) >> 4),
                      q_desc + ((slab * kBQ * kRowBytes + off) >> 4));
    }
#pragma unroll
    for (int kk = 0; kk < 4 * S; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<T>(dp, v_desc + ((slab * kBKV * kRowBytes + off) >> 4),
                      o_desc + ((slab * kBQ * kRowBytes + off) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S^T - lse2) (masked: 0) and dS^T = P^T (dP^T - delta), per
    // query column of the thread
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        const float l2 = lse[c], dl = lse[kBQ + c];
        bool vis[2] = {true, true};
        if constexpr (MASKED) {
          const SeqPos qp = q_pos_of(a.rule, r0 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            vis[h] = visible(a.rule, qp, k_pos_of(a.rule, col0 + kr + 8 * h));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float p = vis[h] ? exp2f(s[i] - l2) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl);
        }
      }
    }
    // rounded to T as the A fragments of four 16-query k-slices
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
      da[i] = pack2<T>(dp[2 * i], dp[2 * i + 1]);
    }

    // dV += T(P^T) dO and dK += T(dS^T) Q, dO and Q through the transpose bit
    const uint64_t ot_desc = make_desc(os, kBQ * kRowBytes, 1024);
    const uint64_t qt_desc = make_desc(qs, kBQ * kRowBytes, 1024);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<T>(dv, pa + 4 * kk, ot_desc + ((kk * 16 * kRowBytes) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<T>(dk, da + 4 * kk, qt_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();

    // this warpgroup's rows of T(dS^T) into the stage's dS^T tile
    unsigned char* dst = Dst + (it & 1) * kDsTile;
    if (a.dq_acc != nullptr) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(
              dst + swz(kr + 8 * (j & 1), 16 * kk + 8 * (j >> 1) + 2 * (lane & 3), kBKV)) =
              da[4 * kk + j];
      fence_proxy_async();
    }
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(empty + st);

    if (a.dq_acc != nullptr) {
      // dQ[:, 64 wg + [0, 64)] = T(dS) K over the CTA's 128 kv rows
      consumers_sync();
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      const uint64_t ds_desc = make_desc(dst, kDsTile, 1024);
      const uint64_t kt_desc = make_desc(Ks + wg * kBKV * kRowBytes, kBKV * kRowBytes, 1024);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        wgmma_ss_n64<T, 1, 1>(dq, ds_desc + ((kk * 16 * kRowBytes) >> 4),
                              kt_desc + ((kk * 16 * kRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      // rows r0 + 16 w + (lane >> 2) (+ 8) of query head b, columns
      // 64 wg + 8 j + 2 (lane & 3) (+ 1)
      const int b = bkv * a.g + mem;
      if (tma) {
        float* box = reinterpret_cast<float*>(DQs + wg * kDqTile);
        if (tid % 128 == 0) bulk_wait_read();  // the last stage's box has been read
        warpgroup_sync(wg);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(box + (16 * w + (lane >> 2) + 8 * h) * 64 + 8 * j +
                                       2 * (lane & 3)) =
                make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        fence_proxy_async();
        warpgroup_sync(wg);
        if (tid % 128 == 0 && 64 * wg < d) tma_reduce_add(&dqmap, box, 64 * wg, r0, b);
      } else {
        float* dqb = a.dq_acc + static_cast<size_t>(b) * q_len * d;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * w + (lane >> 2) + 8 * h;
          if (row >= q_len) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 64 * wg + 8 * j + 2 * (lane & 3) + e;
              if (c < d) atomicAdd(dqb + static_cast<size_t>(row) * d + c, dq[4 * j + 2 * h + e]);
            }
        }
      }
    }
    ++it;
  };
  for_each_q_stage<WALK>(a, ki, [&](int r0, int mem, bool masked) {
    if (masked)
      body(r0, mem, std::true_type{});
    else
      body(r0, mem, std::false_type{});
  });
  if (tid % 128 == 0) bulk_wait();  // the dQ reductions are done with shared memory

  // dK * out_scale and dV, cast to T
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col0 + kr + 8 * h;
    if (col >= k_len) continue;
    const size_t row = static_cast<size_t>(bkv) * k_len + col;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        if (c < d) dkp[row * d + c] = from_f<T>(dk[4 * j + 2 * h + e] * a.out_scale);
        if (c < v_d) dvp[row * v_d + c] = from_f<T>(dv[4 * j + 2 * h + e]);
      }
    }
  }
}

// The backward's products on one tile, for the card tests.  Warpgroup 0
// stages x, y (64 x 64) and z (64 x 128) and computes st = x y^T (the S^T
// and dP^T product) and o = T(st) z (the dV and dK product: A from the
// fragments, z MN-major through the transpose bit); both warpgroups stage
// dst (128 x 64, the dS^T tile: kv rows by queries) and kt (128 x 128, K)
// and compute dq = dst^T kt, warpgroup w the columns 64 w + [0, 64) (the dQ
// product: A and B MN-major).  All float32.
template <typename T>
__global__ void __launch_bounds__(kConsumers)
    bwd_tile_check_kernel(const T* x, const T* y, const T* z, const T* dst, const T* kt,
                          float* st_out, float* o_out, float* dq_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Xs = align1024(smem_raw);
  unsigned char* Ys = Xs + 64 * kRowBytes;
  unsigned char* Zs = Ys + 64 * kRowBytes;
  unsigned char* Ds = Zs + 2 * 64 * kRowBytes;
  unsigned char* Kt = Ds + kDsTile;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) & 3, lane = tid & 31;
  stage_plain(Xs, x, 0, 64, 64, 0, 1, 64, tid, kConsumers);
  stage_plain(Ys, y, 0, 64, 64, 0, 1, 64, tid, kConsumers);
  stage_plain(Zs, z, 0, 64, 64, 0, 2, 128, tid, kConsumers);
  stage_plain(Ds, dst, 0, kBKV, kBKV, 0, 1, 64, tid, kConsumers);
  stage_plain(Kt, kt, 0, kBKV, kBKV, 0, 2, 128, tid, kConsumers);
  fence_proxy_async();
  __syncthreads();
  float st[32], o[64], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const uint64_t dx = make_desc(Xs, 16, 1024), dy = make_desc(Ys, 16, 1024);
  fence_regs(st);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n64<T>(st, dx + ((kk * 32) >> 4), dy + ((kk * 32) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st);
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack2<T>(st[2 * i], st[2 * i + 1]);
  const uint64_t dz = make_desc(Zs, 64 * kRowBytes, 1024);
  const uint64_t dd = make_desc(Ds, kDsTile, 1024);
  const uint64_t dk = make_desc(Kt + wg * kBKV * kRowBytes, kBKV * kRowBytes, 1024);
  fence_regs(o);
  fence_regs(pa);
  fence_regs(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128<T>(o, pa + 4 * kk, dz + ((kk * 16 * kRowBytes) >> 4));
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    wgmma_ss_n64<T, 1, 1>(dq, dd + ((kk * 16 * kRowBytes) >> 4), dk + ((kk * 16 * kRowBytes) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(dq);
  // element i of a fragment: row 16 w + (lane >> 2) + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  auto row = [&](int i) { return 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1); };
  auto col = [&](int i) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); };
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dq_out[row(i) * 128 + 64 * wg + col(i)] = dq[i];
    if (wg == 0) st_out[row(i) * 64 + col(i)] = st[i];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (wg == 0) o_out[row(i) * 128 + col(i)] = o[i];
}

template <typename T>
int bwd_tile_check(const void* x, const void* y, const void* z, const void* dst, const void* kt,
                   float* st, float* o, float* dq, cudaStream_t stream) {
  const int smem = 1024 + 4 * 64 * kRowBytes + kDsTile + kKVTile;
  auto kernel = bwd_tile_check_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kConsumers, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const T*>(dst), static_cast<const T*>(kt), st, o, dq);
  return cudaGetLastError();
}

// ---- host side ----

constexpr size_t kBwdSmem = 1024 + 2 * kKVTile + 2 * kBwdStages * kQTile + 2 * kDsTile +
                            2 * kDqTile + kBwdStages * 2 * kBQ * sizeof(float) +
                            8 * (1 + 2 * kBwdStages);

template <typename T, int WALK>
int bwd_tc(const AttnArgs& a, cudaStream_t stream) {
  const int q_len = a.rule.q_len, k_len = a.rule.k_len;
  if (a.d < 1 || a.v_d < 1 || a.d > kBwdSlabs * kSlabCols || a.v_d > kBwdSlabs * kSlabCols ||
      !dims_ok(a) || a.block_q % 128 || a.block_kv % kBKV || q_len < 1 || k_len < 1)
    return cudaErrorInvalidValue;
  const int B_kv = a.B / a.g;
  CUtensorMap qm, om, km, vm, dqm;
  memset(&qm, 0, sizeof(qm));
  memset(&om, 0, sizeof(om));
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  memset(&dqm, 0, sizeof(dqm));
  const bool tma = a.d % 8 == 0 && a.v_d % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout);
  if (tma && !(tensor_map<T>(&qm, a.q, a.d, q_len, a.B, kBQ) &&
               tensor_map<T>(&om, a.dout, a.v_d, q_len, a.B, kBQ) &&
               tensor_map<T>(&km, a.k, a.d, k_len, B_kv, kBKV) &&
               tensor_map<T>(&vm, a.v, a.v_d, k_len, B_kv, kBKV)))
    return cudaErrorInvalidValue;
  // dq_acc's float (64 columns x 64 rows) boxes, unswizzled
  if (tma && a.dq_acc != nullptr &&
      !encode_map(&dqm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dq_acc, {a.d, q_len, a.B}, 64,
                  kBQ, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  auto kernel = bwd_tc_kernel<T, WALK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks(k_len, kBKV), B_kv), kBwdThreads, kBwdSmem, stream>>>(
      a, qm, om, km, vm, dqm, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

// the fused kv-outer backward of kTable and kBanded: bf16 and fp16 with
// max(d, v_d) <= 128 on the tensor-core body, everything else on the scalar
// body (native.py's bwd_body mirrors this rule)
template <typename T, int WALK>
int bwd_fused_any(const AttnArgs& a, cudaStream_t s) {
  if constexpr (!std::is_same<T, float>::value) {
    if (a.d <= 128 && a.v_d <= 128 && a.rule.q_len > 0 && a.rule.k_len > 0)
      return tc::bwd_tc<T, WALK>(a, s);
  }
  return bwd_kv_any<T, true, WALK>(a, s);
}

}  // namespace
