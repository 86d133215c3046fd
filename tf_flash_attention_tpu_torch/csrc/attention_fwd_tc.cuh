// The tensor-core forward of the op path for Hopper (sm_90a): the tile body
// of fa_flash_fwd (kTable, <- ops/forward.py::_fwd_kernel), fa_banded_fwd
// (kBanded, <- ops/forward_banded.py::_banded_kernel), fa_window_fwd
// (kBanded over its bands' segments, <- ops/forward_banded.py::
// _window_kernel) and fa_resident_fwd
// (kResident, <- ops/forward_banded.py::_resident_kernel) on bf16 and fp16
// inputs at d <= 512, and of the experiment tools' forwards: fa_exp_resident_fwd
// (kResident with the tool's bf16 merge, <- tools/exp_resident.py::
// resident_forward), fa_exp_vpu_ladder and fa_exp_kv_unroll (kResident on
// the block-causal walk with a compiled policy a rung, <-
// tools/exp_vpu_attrib.py::kern, tools/exp_kv_unroll.py::kern).  Included by
// attention_kernels.cu, band_kernels.cu and exp_forward_kernels.cu after
// attention_common.cuh; float32 inputs (full float32 products: TF32 would
// not hold the float32 limit) and half inputs at d > 512 (fwd_any) run the
// scalar body there.
//
// What bounds the forward on this card is the tensor cores' rate (989
// TFLOP/s bf16): at d 128 a query row does 4 d = 512 flops per visible key
// against 2 d bytes of K/V read per key per 128-row CTA.  The design keeps
// the tensor cores fed:
//   work     items of (query row b, 128 query rows, 256-column chunk of
//            v_d): two consumer warpgroups of 64 rows and one producer warp
//            a CTA.  An item walks its schedule row as the scalar body does
//            (kTable: the kv_table / kv_counts / needs_mask row; kBanded,
//            kResident: the four band ints) in stages of BN keys.
//   kTable, kBanded: one CTA an item, grid (B, q tiles, v chunks); query
//            tiles launch last-first, so a causal row's long tiles start
//            first and the short ones fill the tail.
//   kResident: persistent CTAs walking the items in row-major order (below).
//   operands stay in the input type in shared memory, in slabs of 64
//            columns (128 bytes a row) in the 128-byte swizzle that wgmma's
//            descriptors read: Q once, K and V in a ring of two stages.
//   loads    the producer issues TMA copies (cp.async.bulk.tensor, 3-d maps
//            (cols, rows, batch) so rows past q_len / k_len and columns past
//            d / v_d arrive as zeros) completing on mbarriers; where a row
//            pitch is not a multiple of 16 bytes (d or v_d not a multiple of
//            8) the producer warp stages the same layout with plain loads.
//            Consumers release a stage on its empty barrier once their
//            products have read it, and Q on q_empty after their item's last
//            S product.
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
//            the float32 p, as the JAX kernels do (the tools' merges are
//            policies of it, Policy: exp_resident's p = bf16(exp2(bf16(s -
//            m))) with l summing the rounded p, the ladder's rungs; no l or
//            m out).  Masked stages run a body compiled with visible() per
//            element (the orders of the thread's rows and columns computed
//            once a stage); interior stages run one compiled without it: a
//            single body with a run-time test paid the predicate on every
//            stage.  Masked logits take the finite 0xFA value; dead rows get
//            O = 0, l = 0, m = NEG_INF.
//
// The resident walk.  The TPU kernel keeps a batch row's whole K/V in VMEM
// (one DMA per operand per row) and loops over the row's q blocks inside
// one grid step.  A CTA here has at most 227 KB of shared memory, less than
// one row's K/V (2048 x 128 bf16 keys and values: 1 MB), so what carries
// over is what the residency buys: each row's K/V read from HBM about once.
// On Hopper that is L2 (50 MB), provided the CTAs in flight cover few rows.
// So the grid is persistent, min(SMs x CTAs an SM holds, items) (132 x 1
// at d 128: 161 KB of shared memory a CTA), and the items go out row-major
// by groups of rows: group g holds rows [gR, gR + R), R the whole rows one
// wave of the grid covers, floor(grid / items a row) (at least 1, worked
// out from gridDim.x), so a group's items take at most one wave; all of
// group g's items go before group g + 1's, and inside a group the last
// query tile of every row first, then the one before it (for a causal
// rule the longest band first, the short tail last).  At the training
// slice, (B.H, S, d) = (64, 2048, 128), a row has 16 items of 1 MB of K/V:
// R = 8 rows, one or two groups, 8-16 MB, in flight, inside the 50 MB; the
// one-CTA-an-item grid of kBanded instead starts a tile of every one of
// the 64 rows at once: all 64 MB of the slice's K/V live, more than L2
// holds.  At the experiment tool's shape, (8, 4096, 128), a row has 32
// items of 2 MB: R = 4, 8-16 MB.
// The CTAs take their items from a global counter (atomicAdd; the wrapper
// zeroes it), so a CTA that drew short items takes more: with the longest
// items of a group first, that is list scheduling close to longest-first.
// A static stride (item blockIdx.x + i gridDim.x) needs no counter, but
// counting stages (causal tile t takes t + 1, an epilogue half of one), it
// gives the busiest of 132 CTAs 61 stages against an average of 33 at the
// tool's 1.9 items a CTA, and 84 against 70 at the slice; the counter over
// these groups gives 33 and 72, the counter in strict row order (R = 1) 52
// and 79.5, as it leaves a row's longest items to the CTAs that come late.
// On the card strict row order took 5% longer at the slice and 27% at the
// tool's shape (PERF.md).
// Across items the producer runs ahead: once the consumers have issued the
// item's last S product it takes the next item, writes it beside the
// barriers and loads its Q, and the K/V ring carries on into the next
// item's first stages while the consumers run the last PV and the
// epilogue; every mbarrier's phase carries across items.  An item past the
// count is the end: the producer arrives on Q's barrier without a load.
//
// The experiment tool's pairs (fa_exp_resident_fwd, Merge): block_q sets
// the item, block_q / 128 consecutive query tiles of one row that one CTA
// walks last tile first (the TPU kernel's grid step of a q block), so at
// the tool's shape (1024, .) leaves 32 items for 132 SMs and (256, .) 128;
// block_kv sets the merge step, as the tool's plain version merges: at 64
// keys each 128-key stage merges as two halves, each with its own PV
// product; at 128 once a stage; past 128 the step's stages are walked
// twice, first K alone for the step's row maximum (S products only), then
// K and V with that maximum, so p rounds against the maximum of the whole
// step as in the tool (a second S product on each key: 1.5x the products).
//
// The ladder and kv_unroll (kExpGroups): items of one 128-row query tile,
// whatever block_q (the ladder's 2048 would leave 16 items for 132 SMs, as
// exp_resident's 2048 x 512 pair does), so the tools' (8, 4096) gives 256;
// block_q only sets the keys a tile sees, the block-causal [0, ceil((qi +
// 1) block_q / block_kv) block_kv), or every key at block_q = k_len.  The
// merge groups block_kv keys, with a first pass for the group's maximum
// where the policy takes one and the group spans more than a stage; the
// policies without one (nomax, mm) merge every stage, the same function.
// What bounds them is the busiest CTA's stages: at the ladder's shape 64
// long items (the second query block: 32 stages and 12.8 of first pass)
// ahead of 64 short ones a group of rows; at kv_unroll's 256 equal items
// (32 + 12.8 at 512-key groups) two for some CTAs.
//
// The building blocks (barriers, TMA, swizzle, descriptors, wgmma) are
// tc_common.cuh's, shared with the backward of attention_bwd_tc.cuh.

#pragma once

#include "attention_common.cuh"
#include "tc_common.cuh"

namespace {
namespace tc {

constexpr int kBM = 128;                     // query rows per CTA
constexpr int kThreads = kConsumers + 32;    // two consumer warpgroups, a producer warp
// the 64-column slabs of Q and K of each class (by its stage of BN keys):
// d <= 128, <= 256, <= 512
__host__ __device__ constexpr int slabs_of(int bn) { return bn == 128 ? 2 : bn == 64 ? 4 : 8; }
constexpr int kStages = 2;  // the K/V ring (a third stage measured no faster)

// The walk and grouping of a tile's merges: the op path's (its schedule
// row, one merge a BN-key stage, l and m out, dead rows repaired), or a
// tool's (no l or m out; o = acc / l with l == 0 read as 1, the tools'
// finalize).  exp_resident's pairs (exact causal keys [0, row0 + 128),
// items of block_q rows) merge once a BN-key stage (block_kv 128), twice
// (64: each half its own maximum and PV product), or once a step of
// block_kv > BN keys, whose stages are walked twice: K alone for the
// step's row maximum, then K and V.  kExpGroups (the ladder, kv_unroll:
// items of 128 rows) walks the block-causal keys [0, ceil((qi + 1) block_q
// / block_kv) block_kv) of query block qi, no element mask, with block_q
// = k_len for full attention, in groups of block_kv keys: where the policy
// takes a maximum and block_kv > BN, first K alone for the group's
// maximum, then K and V; the policies without one merge once a stage.
// One compiled body each: with the choice made at run time ptxas spilled
// the 128-key body's accumulators to local memory.  The halves' body still
// spills (ptxas -v); no pair of the tool runs it, only the card test's
// (128, 64).
enum Merge { kOpMerge = 0, kExpStage = 1, kExpHalves = 2, kExpStep = 3, kExpGroups = 4 };

// The arithmetic of a merge (exp_vpu_attrib.py:57-85, _steps.py::merge_step):
//   kProd    m the maximum, p = exp2(s - m) rounded to T, l sums the float32
//            p (the op merge, kv_unroll's)
//   kNoMax   m the constant 8 (alpha 0 at the first merge, 1 after)
//   kNoExp   p = s - m, l sums it
//   kNoSum   as kProd, l never updated
//   kBf16Exp p = bf16(exp2(bf16(s - m))), l sums the rounded p (exp_resident's)
//   kMM      p = bf16(s), no m, no l, alpha 1
// The codes are the ladder's rungs (native.LADDER_RUNGS).
enum Policy { kProd = 0, kNoMax = 1, kNoExp = 2, kNoSum = 3, kBf16Exp = 4, kMM = 5 };

__host__ __device__ constexpr bool takes_max(int pol) { return pol != kNoMax && pol != kMM; }

// exp_resident's pairs: items of block_q rows, exact causal walk
__host__ __device__ constexpr bool is_pair(int merge) {
  return merge == kExpStage || merge == kExpHalves || merge == kExpStep;
}

// calls f(c0, masked, max_only) for every load of a BN-key stage in the
// tile's walk, in order: K and V (max_only false) for each stage of the
// schedule row of query block qi; exp_resident's pairs (the causal walk of
// keys [0, row0 + 128), the last stage masked) with kExpStep walk each
// step's stages twice, first K alone (max_only) for the step's maximum;
// kExpGroups the block-causal groups (see Merge), each twice where POL
// takes a maximum and block_kv > BN
template <int WALK, int BN, int MERGE, int POL, typename F>
__device__ __forceinline__ void for_each_load(const AttnArgs& a, int qi, int row0, F&& f) {
  if constexpr (MERGE == kExpGroups) {
    const int bkv = a.block_kv;
    const int end = min(((qi + 1) * a.block_q + bkv - 1) / bkv * bkv, a.rule.k_len);
    const int passes = takes_max(POL) && bkv > BN ? 2 : 1;
    for (int k0 = 0; k0 < end; k0 += bkv)
      for (int pass = 0; pass < passes; ++pass)
        for (int c0 = k0; c0 < k0 + bkv; c0 += BN) f(c0, false, pass + 1 < passes);
  } else if constexpr (MERGE != kOpMerge) {
    constexpr int passes = MERGE == kExpStep ? 2 : 1;
    const int end = row0 + kBM, step = passes == 2 ? a.block_kv : end;
    for (int k0 = 0; k0 < end; k0 += step) {
      const int e = min(k0 + step, end);
      for (int pass = 0; pass < passes; ++pass)
        for (int c0 = k0; c0 < e; c0 += BN) f(c0, c0 + BN > row0, pass + 1 < passes);
    }
  } else {
    const int bkv = a.block_kv, k_len = a.rule.k_len;
    for_each_block<WALK>(a, qi, [&](int blk, bool masked) {
      const int end = min((blk + 1) * bkv, k_len);
      for (int c0 = blk * bkv; c0 < end; c0 += BN) f(c0, masked, false);
    });
  }
}

// The work items: (row, `per` query tiles of 128 rows, VN-column chunk of
// v_d), per = 1 but for exp_resident's block_q.  kResident walks them
// all, by groups of `group` rows (see the header); the other walks take the
// one item of blockIdx.
struct Items {
  int blocks, per, chunks, count, group;
};

template <int WALK, int VN, int MERGE>
__device__ __forceinline__ Items items_of(const AttnArgs& a) {
  Items w;
  w.per = is_pair(MERGE) ? a.block_q / kBM : 1;
  w.blocks = (a.rule.q_len + kBM * w.per - 1) / (kBM * w.per);
  w.chunks = (a.v_d + VN - 1) / VN;
  w.count = WALK == kResident ? a.B * w.blocks * w.chunks : 1;
  w.group = min(a.B, max(1, static_cast<int>(gridDim.x) / (w.blocks * w.chunks)));
  return w;
}

// tile (item x per + the item's tile so far) -> (query row b, first query
// row, first output column)
template <int WALK, int VN>
__device__ __forceinline__ void item_at(const AttnArgs& a, const Items& w, int tile, int& b,
                                        int& row0, int& vc0) {
  if constexpr (WALK == kResident) {
    const int item = tile / w.per, sub = tile - item * w.per;
    const int g0 = item / (w.group * w.blocks * w.chunks) * w.group;  // the group's first row
    const int rows = min(w.group, a.B - g0), j = item - g0 * w.blocks * w.chunks;
    const int p = j / (rows * w.chunks), rem = j - p * rows * w.chunks;
    b = g0 + rem / w.chunks;
    row0 = ((w.blocks - 1 - p) * w.per + w.per - 1 - sub) * kBM;
    vc0 = (rem % w.chunks) * VN;
  } else {
    b = blockIdx.x;
    row0 = (gridDim.y - 1 - blockIdx.y) * kBM;
    vc0 = blockIdx.z * VN;
  }
}

template <typename T, int WALK, int BN, int VN, int MERGE, int POL, bool CUSTOM>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_tc_kernel(const __grid_constant__ AttnArgs a, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, int tma) {
  constexpr bool TOOL = MERGE != kOpMerge;  // no l or m out, no dead-row repair
  // a first pass of K alone for the maximum of a step (kExpStep) or a group
  constexpr bool FIRST_PASS = MERGE == kExpStep || (MERGE == kExpGroups && takes_max(POL));
  constexpr int VS = VN / kSlabCols;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  const int d = a.d, v_d = a.v_d, q_len = a.rule.q_len, k_len = a.rule.k_len;
  constexpr int ds = slabs_of(BN);  // Q and K slabs: d padded to the class's width
  const int k_bytes = ds * BN * kRowBytes, stage_bytes = k_bytes + VS * BN * kRowBytes;
  unsigned char* stages = Qs + ds * kBM * kRowBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kStages * stage_bytes);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kStages;
  int* item_slot = reinterpret_cast<int*>(bars + 2 + 2 * kStages);  // kResident
  constexpr bool kPersistent = WALK == kResident;

  const int tid = threadIdx.x;
  const Items w = items_of<WALK, VN, MERGE>(a);
  const int end_tile = w.count * w.per;  // kResident: the slot's value past the last tile
  if (tid == 0) {
    mbar_init(q_full, tma ? 1 : 32);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, tma ? 1 : 32);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warp ----
    const int lane = tid - kConsumers;
    if (tma && lane != 0) return;
    int it = 0;    // stage loads so far: the ring's phases
    int item = 0;  // kResident: the item drawn last
    for (int n = 0; kPersistent || n == 0; ++n) {  // n: tiles so far, Q's phases
      const int sub = n % w.per;  // the item's tiles so far
      if constexpr (kPersistent) {
        if (sub == 0) {
          if (lane == 0) item = atomicAdd(a.next_item, 1);
          item = __shfl_sync(__activemask(), item, 0);
        }
      }
      if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the last tile's S products are done
      const int tile = item >= w.count ? end_tile : item * w.per + sub;
      if constexpr (kPersistent) {
        if (lane == 0) *item_slot = tile;
        if (tile == end_tile) {  // the end: Q's phase completes without a load
          mbar_arrive(q_full);
          break;
        }
      }
      int b, row0, vc0;
      item_at<WALK, VN>(a, w, tile, b, row0, vc0);
      const int qi = row0 / a.block_q, bkv_row = b / a.g;
      const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(bkv_row) * k_len * d;
      const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(bkv_row) * k_len * v_d;
      if (tma) {
        mbar_expect_tx(q_full, ds * kBM * kRowBytes);
        for (int s = 0; s < ds; ++s)
          tma_load(Qs + s * kBM * kRowBytes, &qmap, q_full, s * kSlabCols, row0, b);
      } else {
        stage_plain(Qs, static_cast<const T*>(a.q) + static_cast<size_t>(b) * q_len * d, row0,
                    kBM, q_len, 0, ds, d, lane);
        fence_proxy_async();
        mbar_arrive(q_full);
      }
      for_each_load<WALK, BN, MERGE, POL>(a, qi, row0, [&](int c0, bool, bool max_only) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        unsigned char* ks = stages + st * stage_bytes;
        if (tma) {
          mbar_expect_tx(full + st, max_only ? k_bytes : stage_bytes);
          for (int s = 0; s < ds; ++s)
            tma_load(ks + s * BN * kRowBytes, &kmap, full + st, s * kSlabCols, c0, bkv_row);
          for (int s = 0; s < VS && !max_only; ++s)
            tma_load(ks + k_bytes + s * BN * kRowBytes, &vmap, full + st, vc0 + s * kSlabCols,
                     c0, bkv_row);
        } else {
          stage_plain(ks, kb, c0, BN, k_len, 0, ds, d, lane);
          if (!max_only) stage_plain(ks + k_bytes, vb, c0, BN, k_len, vc0, VS, v_d, lane);
          fence_proxy_async();
          mbar_arrive(full + st);
        }
        ++it;
      });
    }
    return;
  }

  // ---- the consumer warpgroups: rows row0 + 64 wg + [0, 64) of each tile ----
  const int wg = tid / 128, wp = (tid / 32) & 3, lane = tid & 31;
  const uint64_t q_desc = make_desc(Qs + 64 * wg * kRowBytes, 16, 1024);
  int it = 0;
  for (int n = 0; kPersistent || n == 0; ++n) {
    mbar_wait(q_full, n & 1);
    int tile = 0;
    if constexpr (kPersistent) {
      tile = *static_cast<volatile int*>(item_slot);
      if (tile == end_tile) break;
    }
    int b, row0, vc0;
    item_at<WALK, VN>(a, w, tile, b, row0, vc0);
    const int qi = row0 / a.block_q;
    const int r_base = row0 + 64 * wg + 16 * wp + (lane >> 2);  // and r_base + 8
    int n_loads = 0;
    for_each_load<WALK, BN, MERGE, POL>(a, qi, row0, [&](int, bool, bool) { ++n_loads; });
    if (n_loads == 0) mbar_arrive(q_empty);
    float o_acc[VN / 2];
#pragma unroll
    for (int i = 0; i < VN / 2; ++i) o_acc[i] = 0.f;
    float m_run[2] = {neg_inf(), neg_inf()}, l_part[2] = {0.f, 0.f};
    // FIRST_PASS: the maximum of the steps (groups) so far
    float m_step[2] = {neg_inf(), neg_inf()};

    // one load; MASKED (a compile-time tag) applies the rule predicate, the
    // interior stages compile without it; max_only: the step's first pass
    int j = 0;  // the tile's loads so far
    auto body = [&](int c0, auto masked_tag, bool max_only) {
      constexpr bool MASKED = decltype(masked_tag)::value;
      const int st = it % kStages;
      unsigned char* ks = stages + st * stage_bytes;
      mbar_wait(full + st, (it / kStages) & 1);

      // S = Q K^T (log2-domain logits: q arrives prescaled, but for
      // kv_unroll's scale below): every k-step of the class, unrolled so the
      // products pipeline (Q and K past d are zero)
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
      if (++j == n_loads) mbar_arrive(q_empty);  // the producer may load the next Q
      if constexpr (MERGE == kExpGroups) {  // kv_unroll's unscaled q: 1 for the ladder
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] *= a.s_scale;
      }

      // element i of the fragment: row r_base + 8 ((i >> 1) & 1), column
      // c0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1); the orders of the thread's
      // two rows and BN / 4 columns come once a stage
      if constexpr (MASKED) {
        const SeqPos rows[2] = {q_pos_t<CUSTOM>(a.rule, r_base),
                                q_pos_t<CUSTOM>(a.rule, r_base + 8)};
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const SeqPos col = k_pos_t<CUSTOM>(a.rule, c0 + 8 * jj + 2 * (lane & 3) + e);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (!visible_t<CUSTOM>(a.rule, rows[h], col)) s[4 * jj + 2 * h + e] = neg_inf();
          }
        }
      }
      if constexpr (FIRST_PASS) {
        if (max_only) {  // the first pass: the step's row maximum, nothing merged
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            m_step[(i >> 1) & 1] = fmaxf(m_step[(i >> 1) & 1], s[i]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m_step[h] = fmaxf(m_step[h], __shfl_xor_sync(0xffffffffu, m_step[h], 1));
            m_step[h] = fmaxf(m_step[h], __shfl_xor_sync(0xffffffffu, m_step[h], 2));
          }
          mbar_arrive(empty + st);
          ++it;
          return;
        }
      }
      const uint64_t v_desc = make_desc(ks + k_bytes, BN * kRowBytes, 1024);
      // the online merge of the fragment's elements [LO, HI) (keys c0 + 2 LO
      // to c0 + 2 HI, 8 elements a 16-key slice), then O += P V over them
      auto merge = [&](auto lo_tag, auto hi_tag) {
        constexpr int LO = decltype(lo_tag)::value, HI = decltype(hi_tag)::value;
        if constexpr (POL != kMM) {  // kMM: p = s, alpha 1, no m or l
          float mx[2] = {8.f, 8.f};  // kNoMax: the constant in place of the maximum
          if constexpr (takes_max(POL)) {
            mx[0] = m_run[0];
            mx[1] = m_run[1];
            if constexpr (FIRST_PASS) {  // the step's maximum, from its first pass
              mx[0] = fmaxf(mx[0], m_step[0]);
              mx[1] = fmaxf(mx[1], m_step[1]);
            }
#pragma unroll
            for (int i = LO; i < HI; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
              mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            }
          }
          float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            alpha[h] = exp2f(m_run[h] - mx[h]);
            m_run[h] = mx[h];
          }
          // masked logits hold NEG_INF: exp2(NEG_INF - m) == 0 for a live row; a
          // row with no visible key yet is repaired at the end
#pragma unroll
          for (int i = LO; i < HI; ++i) {
            const int h = (i >> 1) & 1;
            if constexpr (POL == kBf16Exp)
              s[i] = __bfloat162float(hexp2(__float2bfloat16_rn(s[i] - m_run[h])));
            else if constexpr (POL == kNoExp)
              s[i] = s[i] - m_run[h];
            else
              s[i] = exp2f(s[i] - m_run[h]);
            rs[h] += s[i];
          }
          if constexpr (POL != kNoSum) {
#pragma unroll
            for (int h = 0; h < 2; ++h) l_part[h] = alpha[h] * l_part[h] + rs[h];
          }
#pragma unroll
          for (int i = 0; i < VN / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
        }
        // P as the A fragments of (HI - LO) / 8 k-slices, rounded to T
        uint32_t p[(HI - LO) / 2];
#pragma unroll
        for (int i = 0; i < (HI - LO) / 2; ++i) p[i] = pack2<T>(s[LO + 2 * i], s[LO + 2 * i + 1]);
        fence_regs(o_acc);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < (HI - LO) / 8; ++kk)
          mma_pv<VN, T>(o_acc, p + 4 * kk, v_desc + (((LO / 8 + kk) * 16 * kRowBytes) >> 4));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o_acc);
      };
      using lo = std::integral_constant<int, 0>;
      using mid = std::integral_constant<int, BN / 4>;
      using hi = std::integral_constant<int, BN / 2>;
      if constexpr (MERGE == kExpHalves) {  // the tool's 64-key merges: two halves
        merge(lo{}, mid{});
        merge(mid{}, hi{});
      } else {
        merge(lo{}, hi{});
      }
      mbar_arrive(empty + st);
      ++it;
    };
    for_each_load<WALK, BN, MERGE, POL>(a, qi, row0, [&](int c0, bool masked, bool max_only) {
      if constexpr (MERGE == kExpGroups) {  // no element mask: one body
        body(c0, std::false_type{}, max_only);
      } else {
        if (masked)
          body(c0, std::true_type{}, max_only);
        else
          body(c0, std::false_type{}, max_only);
      }
    });

    // the forward finalize (forward.py:225-243), as fwd_finalize; a tool's
    // (exp_vpu_attrib.py:89-91) only reads l == 0 as 1: kNoSum and kMM leave
    // o = acc, and kMM's m stays NEG_INF
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_part[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r_base + 8 * h;
      if (row >= q_len) continue;
      const bool dead = !TOOL && m_run[h] <= neg_inf();
      if (dead) l = 0.f;
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const size_t orow = static_cast<size_t>(b) * q_len + row;
      T* o = static_cast<T*>(a.o) + orow * v_d;
#pragma unroll
      for (int jj = 0; jj < VN / 8; ++jj) {
        const int c = vc0 + 8 * jj + 2 * (lane & 3);
        const float x = dead ? 0.f : o_acc[4 * jj + 2 * h] * inv;
        const float y = dead ? 0.f : o_acc[4 * jj + 2 * h + 1] * inv;
        if (c < v_d) o[c] = from_f<T>(x);
        if (c + 1 < v_d) o[c + 1] = from_f<T>(y);
      }
      if (!TOOL && vc0 == 0 && (lane & 3) == 0) {
        a.l[orow] = l;
        a.m[orow] = dead ? neg_inf() : m_run[h] * INV_LOG2E;
      }
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
         8 * (2 + 2 * kStages) + 8;  // the barriers, kResident's item
}

// The launch of fwd_tc_kernel: kTable and kBanded one CTA an item, (B, q
// tiles, v chunks); kResident one persistent CTA for each that the SMs
// hold at once, at most one an item.  walk (nullable, host): the launch's
// grid of CTAs, its work items, its rows a group (as the kernel works them
// out from the grid) and 1 for the tensor-core body.
template <typename T, int WALK, int BN, int VN, int MERGE = kOpMerge, int POL = kProd>
int fwd_tc(const AttnArgs& a, cudaStream_t stream, int* walk = nullptr) {
  // the tools: query blocks of block_q rows (exp_resident's items), merges
  // of block_kv keys (the merge's own), over q_len == k_len
  const int merge_keys = MERGE == kExpHalves ? BN / 2 : MERGE == kExpStage ? BN : a.block_kv;
  const bool pair_ok =
      MERGE != kOpMerge
          ? a.block_q % kBM == 0 && a.rule.q_len % a.block_q == 0 &&
                a.rule.q_len == a.rule.k_len && a.block_kv == merge_keys &&
                (MERGE != kExpStep || (a.block_kv > BN && a.block_kv % BN == 0)) &&
                (MERGE != kExpGroups || (a.block_kv % BN == 0 && a.rule.k_len % a.block_kv == 0))
          : a.block_q % kBM == 0 && a.block_kv % BN == 0 && a.block_kv % 128 == 0;
  if (a.d < 1 || a.v_d < 1 || a.d > kSlabCols * slabs_of(BN) || a.g < 1 || a.B % a.g ||
      !pair_ok || a.rule.q_len < 1 || (WALK == kResident && a.next_item == nullptr))
    return cudaErrorInvalidValue;
  // a custom rule's masked stages on a body of their own (the tools' rules
  // are built-in)
  auto kernel = fwd_tc_kernel<T, WALK, BN, VN, MERGE, POL, false>;
  if constexpr (MERGE == kOpMerge)
    if (a.rule.kind == kCustom) kernel = fwd_tc_kernel<T, WALK, BN, VN, MERGE, POL, true>;
  const size_t smem = fwd_tc_smem(BN, VN);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int per = is_pair(MERGE) ? a.block_q / kBM : 1;
  const int q_blocks = blocks(a.rule.q_len, kBM * per), chunks = blocks(a.v_d, VN);
  const int items = a.B * q_blocks * chunks;
  dim3 grid(a.B, q_blocks, chunks);
  if (WALK == kResident) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
            cudaSuccess)
      return err;
    const int resident = sms * per_sm > 1 ? sms * per_sm : 1;
    grid = dim3(resident < items ? resident : items);
  }
  if (walk) {
    walk[0] = static_cast<int>(grid.x * grid.y * grid.z);
    walk[1] = items;
    const int wave_rows = static_cast<int>(grid.x) / (q_blocks * chunks);  // as items_of
    walk[2] = WALK != kResident || wave_rows < 1 ? 1 : wave_rows < a.B ? wave_rows : a.B;
    walk[3] = 1;
  }
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
  kernel<<<grid, kThreads, smem, stream>>>(a, qm, km, vm, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

// the widest class of the tensor-core forward: Q and K in 8 slabs of 64
constexpr int kTcMaxD = 512;

// The body of a forward (native.fwd_body): bf16 and fp16 at d <= kTcMaxD on
// the tensor cores, float32 and wider heads on the scalar body (the window
// forward's too: window_fwd_any in band_kernels.cu).
template <typename T>
bool fwd_on_tc(const AttnArgs& a) {
  return !std::is_same<T, float>::value && a.d <= kTcMaxD;
}

// the tensor-core forward's class by d and v_d: 128-key stages with 128
// output columns, 64-key stages with 256, 32-key stages with 256
template <typename T, int WALK>
int fwd_tc_any(const AttnArgs& a, cudaStream_t s, int* walk = nullptr) {
  if (a.d <= 128 && a.v_d <= 128) return tc::fwd_tc<T, WALK, 128, 128>(a, s, walk);
  if (a.d <= 256) return tc::fwd_tc<T, WALK, 64, 256>(a, s, walk);
  return tc::fwd_tc<T, WALK, 32, 256>(a, s, walk);
}

// the forward of kTable, kBanded and kResident on its body (the
// tensor-core class by d and v_d): wider heads go to the scalar body as
// bwd_fused_any sends the backward's wide classes there.  A dispatch by
// shape, not a fallback: a refused launch still returns its error.  walk
// (nullable): what the launch used, as tc::fwd_tc reports it; the scalar
// body's kResident grid is a CTA for each (row, v_d chunk), its item.
template <typename T, int WALK>
int fwd_any(const AttnArgs& a, cudaStream_t s, int* walk = nullptr) {
  if constexpr (!std::is_same<T, float>::value) {
    if (fwd_on_tc<T>(a)) return fwd_tc_any<T, WALK>(a, s, walk);
  }
  if (walk) {
    const int cls = dim_class(a);
    walk[0] = walk[1] = a.B * blocks(a.v_d, cls == 0 ? 128 : cls == 1 ? 256 : WIDE_COLS);
    walk[2] = 1;
    walk[3] = 0;
  }
  return fwd_scalar_any<T, WALK>(a, s);
}

}  // namespace
