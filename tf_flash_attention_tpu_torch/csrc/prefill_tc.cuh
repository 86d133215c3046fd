// The tensor-core body of paged_prefill for Hopper (sm_90a): bf16
// activations, head_dim_store 128, pages of a multiple of 64 tokens, every
// payload (int8, fp8 e4m3 / e5m2, int4 pairs, the unquantized bf16 cache),
// and the sequence-sharded form (page stride and offset, l and m out).
// Replaces serving/prefill.py::_prefill_kernel with the scalar body of
// serving_kernels.cu, which keeps float32 activations, other stored widths
// and pages of 8, 16 or 32 (Prefill::run; native.prefill_body names the
// body).  Included by serving_kernels.cu after its payload helpers (Payload,
// the fp8 types, neg_inf, visible, scale_idx).
//
// What bounds it on this card is the tensor cores' rate: a chunk row does
// 4 D = 512 flops per visible key against D + 4 bytes of one-byte payload a
// key and kv head, read once per item.  The design:
//   items    64 rows of one q head's chunk, a consumer warpgroup and a
//            producer warpgroup; grid (q heads, row tiles), the last rows of
//            the chunk (the most keys) first.  A 512-row chunk at 8 q heads
//            gives 64 CTAs for 132 SMs; items of 128 rows (half the K/V loads
//            and widening, half the CTAs) timed slower at every serving shape.
//   walk     the slot's live pages [first_live, tile_count) through its
//            table row, as the scalar body walks them (the [cp] global page
//            lp * stride + offset), in stages of 64 keys: a page of P keys
//            is P / 64 stages.  The slot, the page range and the positions
//            come from the device meta vector (pf_span), as the reference's
//            scalar prefetch brings them, so one graph capture serves every
//            chunk of every prompt.
//   loads    the producer's first thread issues TMA copies of each stage's
//            raw payload rows through 4-d maps over (D, page rows, n_pages,
//            n_kv), a physical page a coordinate: 128-byte rows of int8 or
//            fp8 (64 a stage), of int4 pairs (32 a stage: token t is nibble
//            t % 2 of byte row t / 2), or the bf16 cache's two 64-column
//            slabs straight into the 128-byte swizzle wgmma reads.  One-byte
//            payloads land raw (a ring of two, the next stage's copy in
//            flight while this one is widened) and the producer warpgroup
//            widens them to bf16 into the swizzled K and V tiles (exact: every
//            payload value is a bf16 value), int4 into token order, and
//            stages the 64 K and V scales of the stage.
//   products S = Q K^T (wgmma m64n64k16, both operands in shared memory), the
//            K scale on the S fragments per key column, then the mask on edge
//            pages only (kv_pos < total && visible; interior pages, wholly
//            behind the chunk and inside the window, run a second compiled
//            body without it); O += P V (m64n128k16, P from the fragments,
//            V MN-major through the transpose bit).
//   merge    once a 64-key stage: m the running maximum, p = exp2(s - m), l
//            sums the float32 p, P = bf16(p x V scale).  The reference merges
//            once a page; a page of 256 or 512 keys has more float32 scores
//            per row than registers hold, so merging a page at once would
//            take a first pass of S products for its maximum (1.5x the
//            products).  Merging a stage rounds P against the stage's
//            maximum; the CPU model test of the stage merge
//            (test_torch_prefill.py) holds it within the card's gate for
//            every payload and page size, and the card holds the kernel to
//            the same gate.
//   finish   o = acc / l (0 where no key is visible: l = 0, acc = 0), and the
//            rows' l and base-2 m where asked.

#pragma once

namespace {
namespace tc {

constexpr int kPfKeys = 64;                           // keys a stage
constexpr int kPfRing = 2;                            // stages in flight
constexpr int kPfKV = 2 * kPfKeys * kRowBytes;        // a stage's bf16 K or V: 128 columns
constexpr int kPfRaw = kPfKeys * kRowBytes;           // a stage's raw K or V rows (int4: half)
constexpr int kPfQ = 2 * 64 * kRowBytes;              // 64 query rows of Q

constexpr int kPfSmem =
    1024 + kPfQ + kPfRing * (2 * kPfKV + 2 * kPfRaw + 2 * kPfKeys * 4) + 8 * 3 * kPfRing;
static_assert(kPfSmem <= 232448, "the prefill body's tiles exceed a block's shared memory");

struct PfArgs {
  const bf16* q;
  const void *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int* tables;  // (max_seqs, max_pages)
  const int* meta;    // slot, count, total, start, first_live, page_offset
  bf16* o;
  float *l, *m;
  int chunk, n_q, n_kv, d, page_size, n_pages, max_pages, page_stride, window, log2_stride,
      is_local;
};

// what a launch reads from its meta vector: the slot's table row, its local
// page count, the chunk's end and start, the first live local page and the
// shard's page offset
struct PfSpan {
  const int* table_row;
  int count, total, start, first_live, page_offset;
};

__device__ __forceinline__ PfSpan pf_span(const PfArgs& a) {
  return {a.tables + static_cast<size_t>(a.meta[0]) * a.max_pages, a.meta[1], a.meta[2],
          a.meta[3], a.meta[4], a.meta[5]};
}

// a one-byte payload value as float (exact in bf16)
template <typename P>
__device__ __forceinline__ float byte_val(uint32_t b) {
  if constexpr (std::is_same<P, int8_t>::value)
    return static_cast<float>(static_cast<int8_t>(b));
  else
    return to_f(P{static_cast<uint8_t>(b)});
}

__device__ __forceinline__ uint32_t bf16x2(float x, float y) { return pack2<bf16>(x, y); }

// the raw rows of a stage (64 tokens, or 32 int4 byte rows) widened to bf16
// into a swizzled 64 x 128 tile, the producer warpgroup's thread `id`
template <typename P>
__device__ __forceinline__ void widen(unsigned char* dst, const unsigned char* raw, int id) {
  if constexpr (Payload<P>::kPack == 1) {
    for (int u = id; u < kPfKeys * 8; u += 128) {
      const int t = u >> 3, c = u & 7;  // token, 16-byte chunk of its row
      const uint4 x = *reinterpret_cast<const uint4*>(raw + t * kRowBytes + 16 * c);
      const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[2 * i] = bf16x2(byte_val<P>(wd[i] & 0xFF), byte_val<P>((wd[i] >> 8) & 0xFF));
        h[2 * i + 1] = bf16x2(byte_val<P>((wd[i] >> 16) & 0xFF), byte_val<P>(wd[i] >> 24));
      }
      *reinterpret_cast<uint4*>(dst + swz(t, 16 * c, kPfKeys)) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(dst + swz(t, 16 * c + 8, kPfKeys)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
  } else {  // int4: byte row r holds tokens 2 r (low nibbles) and 2 r + 1
    for (int u = id; u < kPfKeys / 2 * 8; u += 128) {
      const int r = u >> 3, c = u & 7;
      const uint4 x = *reinterpret_cast<const uint4*>(raw + r * kRowBytes + 16 * c);
      const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // bytes 2 i and 2 i + 1: columns 16 c + 2 i, + 1
        const int b0 = static_cast<int>((wd[i >> 1] >> (16 * (i & 1))) & 0xFF);
        const int b1 = static_cast<int>((wd[i >> 1] >> (16 * (i & 1) + 8)) & 0xFF);
        lo[i] = bf16x2(static_cast<float>(nibble(b0, 0)), static_cast<float>(nibble(b1, 0)));
        hi[i] = bf16x2(static_cast<float>(nibble(b0, 1)), static_cast<float>(nibble(b1, 1)));
      }
      *reinterpret_cast<uint4*>(dst + swz(2 * r, 16 * c, kPfKeys)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(dst + swz(2 * r, 16 * c + 8, kPfKeys)) =
          make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(dst + swz(2 * r + 1, 16 * c, kPfKeys)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + swz(2 * r + 1, 16 * c + 8, kPfKeys)) =
          make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// the local pages [first_live, tile_count) a tile of rows [row0, row0 +
// rows) walks: pages past its last row's are fully masked for it
__device__ __forceinline__ int pf_stages(const PfArgs& a, const PfSpan& m, int row0, int rows) {
  const int last_gp = (m.start + min(row0 + rows, a.chunk) - 1) / a.page_size;
  const int tile_count =
      min(m.count, last_gp >= m.page_offset ? (last_gp - m.page_offset) / a.page_stride + 1 : 0);
  return max(0, tile_count - m.first_live) * (a.page_size / kPfKeys);
}

template <typename P>
__global__ void __launch_bounds__(256, 1)
    prefill_tc_kernel(const __grid_constant__ PfArgs a, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap) {
  constexpr bool WIDEN = Payload<P>::kQuant;  // a one-byte payload (bf16 lands as it is)
  constexpr int PACK = Payload<P>::kPack;
  constexpr int R = 64;  // rows an item
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Wst = Qs + kPfQ;                    // kPfRing x (K, V) in bf16
  unsigned char* Raw = Wst + kPfRing * 2 * kPfKV;    // kPfRing x (K, V) raw rows
  float* Sc = reinterpret_cast<float*>(Raw + kPfRing * 2 * kPfRaw);  // kPfRing x (K, V) scales
  uint64_t* bars = reinterpret_cast<uint64_t*>(Sc + kPfRing * 2 * kPfKeys);
  uint64_t* raw_full = bars;
  uint64_t* full = bars + kPfRing;
  uint64_t* empty = bars + 2 * kPfRing;

  const int tid = threadIdx.x;
  const int hq = blockIdx.x, row0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int hk = hq / (a.n_q / a.n_kv), ps = a.page_size, spp = ps / kPfKeys;
  const PfSpan span = pf_span(a);
  const int n = pf_stages(a, span, row0, R);
  if (tid == 0) {
    for (int s = 0; s < kPfRing; ++s) {
      mbar_init(raw_full + s, 1);
      mbar_init(full + s, WIDEN ? 128 : 1);
      mbar_init(empty + s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // ---- the producer warpgroup ----
    const int id = tid - 128;
    // stage `it`: page lp = first_live + it / spp, keys 64 (it % spp) on
    auto phys_of = [&](int it) { return span.table_row[(span.first_live + it / spp) % a.max_pages]; };
    if constexpr (WIDEN) {
      constexpr int raw_rows = kPfKeys / PACK, raw_bytes = raw_rows * kRowBytes;
      auto issue = [&](int it) {
        const int st = it % kPfRing, phys = phys_of(it), r0 = (it % spp) * raw_rows;
        unsigned char* raw = Raw + st * 2 * kPfRaw;
        mbar_expect_tx(raw_full + st, 2 * raw_bytes);
        tma_load4(raw, &kmap, raw_full + st, 0, r0, phys, hk);
        tma_load4(raw + kPfRaw, &vmap, raw_full + st, 0, r0, phys, hk);
      };
      if (id == 0 && n > 0) issue(0);
      const int page_rows = ps / PACK;
      for (int it = 0; it < n; ++it) {
        const int st = it % kPfRing;
        if (id == 0 && it + 1 < n) issue(it + 1);  // its raw buffer was widened at it - 1
        if (it >= kPfRing) mbar_wait(empty + st, ((it / kPfRing) & 1) ^ 1);
        mbar_wait(raw_full + st, (it / kPfRing) & 1);
        const unsigned char* raw = Raw + st * 2 * kPfRaw;
        unsigned char* kw = Wst + st * 2 * kPfKV;
        widen<P>(kw, raw, id);
        widen<P>(kw + kPfKV, raw + kPfRaw, id);
        // the stage's K scales (threads 0-63) and V scales (64-127)
        const size_t page = static_cast<size_t>(hk) * a.n_pages + phys_of(it);
        const int t = (it % spp) * kPfKeys + (id & (kPfKeys - 1));
        const float* sc = id < kPfKeys ? a.k_scales : a.v_scales;
        Sc[st * 2 * kPfKeys + id] = sc[page * ps + scale_idx<PACK>(t, page_rows)];
        fence_proxy_async();
        mbar_arrive(full + st);
        named_sync(1, 128);  // every thread is done with the raw rows before they are reused
      }
    } else {
      if (id != 0) return;
      for (int it = 0; it < n; ++it) {
        const int st = it % kPfRing, phys = phys_of(it), r0 = (it % spp) * kPfKeys;
        if (it >= kPfRing) mbar_wait(empty + st, ((it / kPfRing) & 1) ^ 1);
        unsigned char* kw = Wst + st * 2 * kPfKV;
        mbar_expect_tx(full + st, 2 * kPfKV);
        for (int s = 0; s < 2; ++s) {
          tma_load4(kw + s * kPfKeys * kRowBytes, &kmap, full + st, s * kSlabCols, r0, phys, hk);
          tma_load4(kw + kPfKV + s * kPfKeys * kRowBytes, &vmap, full + st, s * kSlabCols, r0,
                    phys, hk);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: chunk rows row0 + [0, 64) ----
  const int w = tid / 32, lane = tid & 31;
  // Q (prescaled bf16, zero past d and past the chunk) into the swizzled tile
  for (int i = tid; i < 64 * 128; i += 128) {
    const int r = i >> 7, c = i & 127, row = row0 + r;
    const bf16 x = row < a.chunk && c < a.d
                       ? a.q[(static_cast<size_t>(row) * a.n_q + hq) * a.d + c]
                       : __float2bfloat16(0.f);
    *reinterpret_cast<bf16*>(Qs + swz(r, c, R)) = x;
  }
  fence_proxy_async();
  named_sync(2, 128);
  const uint64_t q_desc = make_desc(Qs, 16, 1024);
  // fragment element i: row row0 + 16 w + (lane >> 2) + 8 ((i >> 1) & 1) of
  // the chunk, key (or column) 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  const int r_base = row0 + 16 * w + (lane >> 2);
  const int q_pos[2] = {span.start + r_base, span.start + r_base + 8};
  const int sw = a.window << a.log2_stride;
  float o[64], m_run[2] = {neg_inf(), neg_inf()}, l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;

  auto body = [&](int it, int kv0, auto masked_tag) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    const int st = it % kPfRing;
    unsigned char* kw = Wst + st * 2 * kPfKV;
    const float* ksc = Sc + st * 2 * kPfKeys;
    const float* vsc = ksc + kPfKeys;
    mbar_wait(full + st, (it / kPfRing) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t k_desc = make_desc(kw, 16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int slab = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss_n64<bf16>(s, q_desc + ((slab * R * kRowBytes + off) >> 4),
                         k_desc + ((slab * kPfKeys * kRowBytes + off) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    // the K scale per key column, then the mask on an edge page
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if constexpr (WIDEN) s[i] *= ksc[col];
      if constexpr (MASKED) {
        const int kv_pos = kv0 + col;
        if (!(kv_pos < span.total &&
              visible(q_pos[(i >> 1) & 1], kv_pos, a.window, a.log2_stride, a.is_local)))
          s[i] = neg_inf();
      }
    }
    // the stage's merge
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], rs[2] = {0.f, 0.f};
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m_run[h] - mx[h]);
      live[h] = mx[h] > neg_inf() * 0.5f;  // a row with no visible key yet
      m_run[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = live[h] ? exp2f(s[i] - mx[h]) : 0.f;
      rs[h] += p;
      s[i] = WIDEN ? p * vsc[8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] : p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_part[h] = alpha[h] * l_part[h] + rs[h];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack2<bf16>(s[2 * i], s[2 * i + 1]);
    // O += P V, V through the transpose bit
    const uint64_t v_desc = make_desc(kw + kPfKV, kPfKeys * kRowBytes, 1024);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<bf16>(o, pa + 4 * kk, v_desc + ((kk * 16 * kRowBytes) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty + st);
  };
  for (int it = 0; it < n; ++it) {
    const int gp = (span.first_live + it / spp) * a.page_stride + span.page_offset;  // global page
    // an interior page: wholly behind the chunk, and inside every row's window
    bool interior = (gp + 1) * ps <= span.start;
    if (a.is_local) interior = interior && !a.log2_stride && gp * ps >= span.start + a.chunk - sw;
    const int kv0 = gp * ps + (it % spp) * kPfKeys;
    if (interior)
      body(it, kv0, std::false_type{});
    else
      body(it, kv0, std::true_type{});
  }

  // o = acc / l (l == 0: no visible key, acc == 0), l and m where asked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_part[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r_base + 8 * h;
    if (row >= a.chunk) continue;
    const size_t orow = static_cast<size_t>(row) * a.n_q + hq;
    const float div = l == 0.f ? 1.f : l;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      if (c < a.d) a.o[orow * a.d + c] = __float2bfloat16(o[4 * jj + 2 * h] / div);
      if (c + 1 < a.d) a.o[orow * a.d + c + 1] = __float2bfloat16(o[4 * jj + 2 * h + 1] / div);
    }
    if (a.l != nullptr && (lane & 3) == 0) {
      a.l[orow] = l;
      a.m[orow] = m_run[h];
    }
  }
}

// The launch: grid (q heads, 64-row tiles).  *body (nullable, host) is set
// to 1, the tensor-core body, before anything can fail.
template <typename P>
int prefill_tc(const PfArgs& a, int d_store, int* body, cudaStream_t stream) {
  constexpr int PACK = Payload<P>::kPack;
  if (body) *body = 1;
  if (d_store != 128 || a.d < 1 || a.d > 128 || a.page_size % kPfKeys || a.n_q % a.n_kv)
    return cudaErrorInvalidValue;
  if (a.chunk == 0) return cudaSuccess;
  const int tiles = (a.chunk + 63) / 64;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap km, vm;
  memset(&km, 0, sizeof(km));
  memset(&vm, 0, sizeof(vm));
  // (D, page rows, n_pages, n_kv): a physical page is a coordinate
  const int dims[4] = {d_store, a.page_size / PACK, a.n_pages, a.n_kv};
  bool ok;
  if constexpr (Payload<P>::kQuant)
    ok = encode_map(&km, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.k_pages, dims, d_store,
                    kPfKeys / PACK, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_map(&vm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.v_pages, dims, d_store,
                    kPfKeys / PACK, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    ok = encode_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.k_pages, dims, kSlabCols,
                    kPfKeys, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.v_pages, dims, kSlabCols,
                    kPfKeys, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(prefill_tc_kernel<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kPfSmem);
  if (e != cudaSuccess) return e;
  prefill_tc_kernel<P><<<dim3(a.n_q, tiles), 256, kPfSmem, stream>>>(a, km, vm);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
