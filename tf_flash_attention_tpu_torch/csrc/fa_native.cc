// Native runtime components for the TPU flash-attention framework.
//
// TPU-native analog of the reference's host-side C++ (the op layer and
// launcher logic around the CUDA kernels): the pieces that run on the CPU
// per compiled specialisation or per serving step are implemented here and
// exposed through a C ABI consumed via ctypes (tf_flash_attention_tpu/
// native.py), with pure-Python fallbacks kept as the behavioural spec.
//
// Components:
//  1. Block-skip schedule builder — the trace-time replacement for the
//     reference's in-kernel IsSkipped tests (flash_attention.h:49-115):
//     classifies every (q-block, kv-block) tile as dead / partial /
//     interior from exact per-tile order bounds.  O(n_q_blocks *
//     n_kv_blocks * ndim); the hot trace-time loop for 64k-token
//     schedules.
//  2. Analytic FLOPs estimator — the reference's skip-aware cost model
//     (flash_attention.cu:2090-2113) summed over live tiles.
//  3. Continuous-batching scheduler — FCFS admission with page budget
//     (serving control plane; spec in serving/scheduler.py).
//
// Build: make -C tf_flash_attention_tpu/csrc   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. Schedule builder
// ---------------------------------------------------------------------------

// Per-dimension affine order placement: order = offset + stride * i, with the
// row-major flattening over power-of-two reference dims (shift/mask codec,
// flash_attention.h:11-41).
struct SeqDesc {
  int32_t ndim;
  const int32_t* shape;    // [ndim]
  const int32_t* stride;   // [ndim]
  const int32_t* offset;   // [ndim]
};

namespace {

struct TileBounds {
  // [ndim][n_tiles] coordinate min/max + [n_tiles] flat min/max
  std::vector<std::vector<int32_t>> lo, hi;
  std::vector<int64_t> flat_lo, flat_hi;
  int32_t n_tiles;
};

// Exact per-tile bounds for a row-major-flattened sequence cut into blocks.
TileBounds tile_bounds(const SeqDesc& d, const int32_t* shifts, int32_t block) {
  int64_t length = 1;
  for (int32_t i = 0; i < d.ndim; ++i) length *= d.shape[i];
  const int32_t n_tiles = static_cast<int32_t>((length + block - 1) / block);

  TileBounds tb;
  tb.n_tiles = n_tiles;
  tb.lo.assign(d.ndim, std::vector<int32_t>(n_tiles, INT32_MAX));
  tb.hi.assign(d.ndim, std::vector<int32_t>(n_tiles, INT32_MIN));
  tb.flat_lo.assign(n_tiles, INT64_MAX);
  tb.flat_hi.assign(n_tiles, INT64_MIN);

  std::vector<int32_t> idx(d.ndim, 0);
  for (int64_t pos = 0; pos < length; ++pos) {
    const int32_t t = static_cast<int32_t>(pos / block);
    int64_t flat = 0;
    for (int32_t k = 0; k < d.ndim; ++k) {
      const int32_t c = d.offset[k] + d.stride[k] * idx[k];
      tb.lo[k][t] = std::min(tb.lo[k][t], c);
      tb.hi[k][t] = std::max(tb.hi[k][t], c);
      flat += static_cast<int64_t>(c) << shifts[k];
    }
    tb.flat_lo[t] = std::min(tb.flat_lo[t], flat);
    tb.flat_hi[t] = std::max(tb.flat_hi[t], flat);
    // row-major increment
    for (int32_t k = d.ndim - 1; k >= 0; --k) {
      if (++idx[k] < d.shape[k]) break;
      idx[k] = 0;
    }
  }
  return tb;
}

}  // namespace

// Rule kinds (mask_rules.py): 0 = full, 1 = causal, 2 = local.
//
// Outputs (caller-allocated):
//   live, partial: [n_q_tiles * n_k_tiles] uint8 (row-major)
// Returns 0 on success.
int32_t fa_build_tile_classes(
    int32_t ndim,
    const int32_t* q_shape, const int32_t* q_stride, const int32_t* q_offset,
    const int32_t* k_shape, const int32_t* k_stride, const int32_t* k_offset,
    const int32_t* ref_log2,       // [ndim]
    int32_t rule_kind, int32_t window_size, int32_t log2_stride_size,
    int32_t is_causal,
    int32_t block_q, int32_t block_kv,
    int32_t q_pad_tail,            // 1 if q_len % block_q != 0
    int32_t k_pad_tail,
    uint8_t* live_out, uint8_t* partial_out,
    int32_t* n_q_tiles_out, int32_t* n_k_tiles_out) {
  std::vector<int32_t> shifts(ndim, 0);
  for (int32_t d2 = 0; d2 < ndim; ++d2)
    for (int32_t j = d2 + 1; j < ndim; ++j) shifts[d2] += ref_log2[j];

  SeqDesc qd{ndim, q_shape, q_stride, q_offset};
  SeqDesc kd{ndim, k_shape, k_stride, k_offset};
  TileBounds qb = tile_bounds(qd, shifts.data(), block_q);
  TileBounds kb = tile_bounds(kd, shifts.data(), block_kv);
  *n_q_tiles_out = qb.n_tiles;
  *n_k_tiles_out = kb.n_tiles;

  const int64_t sw = rule_kind == 2
      ? (static_cast<int64_t>(window_size) << log2_stride_size) : 0;

  for (int32_t qi = 0; qi < qb.n_tiles; ++qi) {
    for (int32_t kj = 0; kj < kb.n_tiles; ++kj) {
      bool lv = true;
      bool full = true;
      if (rule_kind == 1) {  // causal
        lv = kb.flat_lo[kj] <= qb.flat_hi[qi];
        full = kb.flat_hi[kj] <= qb.flat_lo[qi];
      } else if (rule_kind == 2) {  // local
        for (int32_t d2 = 0; d2 < ndim && lv; ++d2) {
          lv = kb.hi[d2][kj] >= qb.lo[d2][qi] - (sw - 1) &&
               kb.lo[d2][kj] <= qb.hi[d2][qi] + (sw - 1);
        }
        if (log2_stride_size > 0) {
          full = false;
        } else {
          for (int32_t d2 = 0; d2 < ndim && full; ++d2) {
            full = kb.lo[d2][kj] >= qb.hi[d2][qi] - (sw - 1) &&
                   kb.hi[d2][kj] <= qb.lo[d2][qi] + (sw - 1);
          }
        }
        if (is_causal) {
          lv = lv && (kb.flat_lo[kj] <= qb.flat_hi[qi]);
          full = full && (kb.flat_hi[kj] <= qb.flat_lo[qi]);
        }
      }
      if (q_pad_tail && qi == qb.n_tiles - 1) full = false;
      if (k_pad_tail && kj == kb.n_tiles - 1) full = false;
      live_out[static_cast<int64_t>(qi) * kb.n_tiles + kj] = lv ? 1 : 0;
      partial_out[static_cast<int64_t>(qi) * kb.n_tiles + kj] =
          (lv && !full) ? 1 : 0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 2. Analytic FLOPs estimator (flash_attention.cu:2090-2113, skip-aware)
// ---------------------------------------------------------------------------

double fa_estimate_forward_flops(
    const uint8_t* live, int32_t n_q_tiles, int32_t n_k_tiles,
    int64_t q_len, int64_t k_len,
    int32_t block_q, int32_t block_kv,
    int32_t d, int32_t v_d, int64_t batch) {
  double total = 0.0;
  for (int32_t qi = 0; qi < n_q_tiles; ++qi) {
    const double br = std::min<int64_t>(block_q, q_len - static_cast<int64_t>(qi) * block_q);
    for (int32_t kj = 0; kj < n_k_tiles; ++kj) {
      if (!live[static_cast<int64_t>(qi) * n_k_tiles + kj]) continue;
      const double bc = std::min<int64_t>(block_kv, k_len - static_cast<int64_t>(kj) * block_kv);
      total += br * bc * (2.0 * d - 1.0)   // S = Q K^T
             + 2.0 * br * (bc - 1.0)       // max + sum row reductions
             + 2.0 * br * bc               // numerator exp/sub
             + 7.0 * br                    // (l, m) merge
             + br * (bc + v_d)             // P and O reweighting
             + br * v_d * (2.0 * bc - 1.0);  // O += P V
    }
  }
  return total * static_cast<double>(batch);
}

// ---------------------------------------------------------------------------
// 3. Continuous-batching scheduler (FCFS + page budget)
// ---------------------------------------------------------------------------

namespace {

struct NativeScheduler {
  int32_t page_size;
  int64_t budget;
  std::deque<std::pair<int64_t, int64_t>> queue;  // (rid, pages_needed)
  std::vector<int32_t> free_slots;
};

}  // namespace

void* fa_sched_create(int32_t max_seqs, int64_t n_pages, int32_t page_size) {
  auto* s = new NativeScheduler();
  s->page_size = page_size;
  s->budget = n_pages;
  for (int32_t i = max_seqs - 1; i >= 0; --i) s->free_slots.push_back(i);
  return s;
}

void fa_sched_destroy(void* h) { delete static_cast<NativeScheduler*>(h); }

void fa_sched_enqueue(void* h, int64_t rid, int64_t prompt_len,
                      int64_t max_new_tokens) {
  auto* s = static_cast<NativeScheduler*>(h);
  const int64_t total = prompt_len + max_new_tokens;
  const int64_t pages = (total + s->page_size - 1) / s->page_size;
  s->queue.emplace_back(rid, pages);
}

// Like fa_sched_enqueue with a cap on the pages reserved (sliding-window
// models hold a window-bounded live page set; mirrors Request.pages_cap).
void fa_sched_enqueue_capped(void* h, int64_t rid, int64_t prompt_len,
                             int64_t max_new_tokens, int64_t pages_cap) {
  auto* s = static_cast<NativeScheduler*>(h);
  const int64_t total = prompt_len + max_new_tokens;
  int64_t pages = (total + s->page_size - 1) / s->page_size;
  if (pages_cap >= 0 && pages_cap < pages) pages = pages_cap;
  s->queue.emplace_back(rid, pages);
}

int64_t fa_sched_queued(void* h) {
  return static_cast<NativeScheduler*>(h)->queue.size();
}

// Fills rids/slots (capacity max_admit); returns number admitted.
int32_t fa_sched_admit(void* h, int64_t* rids, int32_t* slots,
                       int32_t max_admit) {
  auto* s = static_cast<NativeScheduler*>(h);
  int32_t n = 0;
  while (n < max_admit && !s->queue.empty() && !s->free_slots.empty()) {
    auto [rid, pages] = s->queue.front();
    if (pages > s->budget) break;  // FCFS: never skip ahead
    s->queue.pop_front();
    s->budget -= pages;
    rids[n] = rid;
    slots[n] = s->free_slots.back();
    s->free_slots.pop_back();
    ++n;
  }
  return n;
}

void fa_sched_release(void* h, int32_t slot, int64_t pages_held) {
  auto* s = static_cast<NativeScheduler*>(h);
  s->free_slots.push_back(slot);
  s->budget += pages_held;
}

// Budget refund for pages an active slot released early (sliding-window
// eviction; mirrors Scheduler.refund in scheduler.py).
void fa_sched_refund(void* h, int64_t n_pages) {
  static_cast<NativeScheduler*>(h)->budget += n_pages;
}

}  // extern "C"
