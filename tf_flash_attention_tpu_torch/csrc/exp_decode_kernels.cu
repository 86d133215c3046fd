// The decode kernels of the experiment tools still on a scalar body, for
// Hopper (sm_90a).
//
//   fa_exp_int4_int8ref  <- tools/exp_int4_unpack.py::kern_int8ref (:69, call :254)
//   fa_exp_int4_int8_2pg <- tools/exp_int4_unpack.py::kern_int8ref_npg, npg 2 (:123, call :294)
//   fa_exp_paged_decode  <- tools/exp_decode.py::_decode_kernel (:35, call :159)
//
// The int4 unpack tool's four int4 sites run the serving decode's
// tensor-core body as compiled policies (decode_tc.cuh, entries in
// serving_kernels.cu).
//
// One kernel, decode_kernel: single-token attention of G query rows (one
// kv head's group) over a K/V of int8 token rows, d = 128, with per-token
// float32 scales.  The TPU kernels' grid (row, page) becomes one CTA per
// (row b, kv head h) that loops over its pages in steps of npg pages; a
// step's pages are staged in shared memory (int8 bytes, rows padded to 33
// words), scored in full, merged into the running (m, l, acc) with one
// online-softmax update (the step's maximum, as the TPU kernel's grid
// step), then multiplied into acc.  npg therefore keeps its meaning: pages
// loaded per loop iteration before their softmax.  Scales (pages, 1, page).
//
// Variants (exp_decode.py): kCurrent dequantizes K/V (bf16(bf16(x) *
// bf16(scale))); kPostscale puts the scales on s and p, which is also the
// int8ref kernels' math; kInt8mm quantizes q per row and p per row per
// page (IEEE division, round half to even) and takes int8 products with
// __dp4a (int32 sums, exact): the codes and the integer scores equal the
// plain version's bit for bit, and the float steps around them are written
// with __fmul_rn / __fsub_rn / __fdiv_rn so nvcc contracts nothing into an
// FMA the plain version does not take.  Token bounds (paged only):
// pages p < ceil(lengths[b] / page), tokens p * page + t < lengths[b]
// (exp_decode.py:52-56).  The two scale layouts of exp_decode (page-major
// (n_kv, pages, page, 1) and the cache's rows (n_kv, pages, 1, page)) are
// the same bytes, so one kernel reads both.
//
// What bounds it: these are memory-bound functions (one pass over the
// payload: 276.8 MB for exp_decode's 16 x 8192 tokens), but a CTA streams
// its pages with plain 16-byte loads, one step at a time, with no copy in
// flight during the step's arithmetic, and the 128 CTAs hold one each on
// 132 SMs; scores and P V are scalar FP32 FMA, a thread a staged row, six
// __syncthreads a step.  The kernel runs at what one SM's loads in flight
// and FMA lanes give.  The redesign is the decode's tensor-core body with
// an int8 payload, as the int4 sites have had.
//
// Each extern "C" entry launches one kernel on the caller's stream,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256, NW = NT / 32;
constexpr int D = 128;     // head dim
constexpr int LDW = 33;    // words per staged row (32 + 1: conflict-free rows)
constexpr int GMAX = 8;
constexpr int MAX_SMEM = 232448;

enum Variant { kCurrent = 0, kPostscale = 1, kInt8mm = 2 };

struct DecArgs {
  const bf16* q;                 // (B, n_kv, G, D)
  const int8_t* k;               // (n_kv, n_pages, rows, D)
  const int8_t* v;
  const float* ks;               // (n_kv, n_pages, 1, rows)
  const float* vs;
  const int* tables;             // (B, max_pages), or null: page p is p
  const int* lengths;            // (B,), or null: every token live
  bf16* o;                       // (B, n_kv, G, D)
  int8_t* q_codes;               // kInt8mm, nullable: (B, n_kv, G, D)
  int* s_int;                    // kInt8mm, nullable: (B, n_kv, G, max_pages * page)
  int8_t* p_codes;               // kInt8mm, nullable: as s_int
  int B, n_kv, G, n_pages, rows, max_pages, npg;
  float scale_log2e;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xFAFAFAFAu));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the four signed bytes of a word, as floats
__device__ __forceinline__ void bytes4(uint32_t x, float (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = static_cast<float>(static_cast<int>(x << (24 - 8 * e)) >> 24);
}

template <int VAR>
__global__ void __launch_bounds__(NT, 1) decode_kernel(DecArgs a) {
  extern __shared__ float smem[];
  const int G = a.G, rows = a.rows, PT = rows, TR = a.npg * rows, T = TR;
  const int WPR = NW / G;  // warps per query row
  float* Qf = smem;                                            // G x D (kInt8mm: G x 32 code words)
  uint32_t* Ks = reinterpret_cast<uint32_t*>(Qf + GMAX * D);   // TR x LDW
  uint32_t* Vs = Ks + TR * LDW;
  float* ksc = reinterpret_cast<float*>(Vs + TR * LDW);        // T: the step's scales
  float* vsc = ksc + T;
  float* Sc = vsc + T;                                         // G x T: scores, then p
  float* red = Sc + G * T;                                     // 2 NW
  float* m_s = red + 2 * NW;
  float* l_s = m_s + GMAX;
  float* a_s = l_s + GMAX;
  float* ps_s = a_s + GMAX;
  float* qs_s = ps_s + GMAX;
  int8_t* Pc = reinterpret_cast<int8_t*>(qs_s + GMAX);         // kInt8mm: G x T p codes

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t qrow0 = (static_cast<size_t>(b) * a.n_kv + h) * G;  // (b, h, 0)
  const int len = a.lengths ? a.lengths[b] : 0;
  const int n_live = a.lengths ? min((len + PT - 1) / PT, a.max_pages) : a.max_pages;
  const int n_steps = n_live / a.npg;
  const int t_total = a.max_pages * PT;
  const float c = a.scale_log2e;

  if (VAR == kInt8mm) {  // q codes: warp g quantizes row g, 4 columns a lane
    if (warp < G) {
      const bf16* qr = a.q + (qrow0 + warp) * D + 4 * lane;
      float f[4], amax = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = __bfloat162float(qr[e]);
        amax = fmaxf(amax, fabsf(f[e]));
      }
      amax = warp_max(amax);
      float qs = __fdiv_rn(amax, 127.f);
      qs = qs == 0.f ? 1.f : qs;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int code = static_cast<int>(rintf(__fdiv_rn(f[e], qs)));
        word |= (static_cast<uint32_t>(code) & 0xFFu) << (8 * e);
        if (a.q_codes) a.q_codes[(qrow0 + warp) * D + 4 * lane + e] = static_cast<int8_t>(code);
      }
      reinterpret_cast<uint32_t*>(Qf)[warp * 32 + lane] = word;
      if (lane == 0) qs_s[warp] = qs;
    }
  } else {
    for (int i = tid; i < G * D; i += NT) Qf[i] = __bfloat162float(a.q[qrow0 * D + i]);
  }
  if (tid < GMAX) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  const int g_pv = warp / WPR, part = warp % WPR;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int st = 0; st < n_steps; ++st) {
    __syncthreads();  // the previous step's readers are done
    for (int j = 0; j < a.npg; ++j) {  // stage the step's pages and scales
      const int p = st * a.npg + j;
      const int phys = a.tables ? a.tables[static_cast<size_t>(b) * a.max_pages + p] : p;
      const size_t page = static_cast<size_t>(h) * a.n_pages + phys;
      const uint4* kp = reinterpret_cast<const uint4*>(a.k + page * rows * D);
      const uint4* vp = reinterpret_cast<const uint4*>(a.v + page * rows * D);
#pragma unroll 4
      for (int i = tid; i < rows * (D / 16); i += NT) {
        const uint4 kx = kp[i], vx = vp[i];
        const int r = j * rows + i / (D / 16), w = 4 * (i % (D / 16));
        uint32_t* kd = Ks + r * LDW + w;
        uint32_t* vd = Vs + r * LDW + w;
        kd[0] = kx.x, kd[1] = kx.y, kd[2] = kx.z, kd[3] = kx.w;
        vd[0] = vx.x, vd[1] = vx.y, vd[2] = vx.z, vd[3] = vx.w;
      }
      for (int i = tid; i < PT; i += NT) {
        ksc[j * PT + i] = a.ks[page * PT + i];
        vsc[j * PT + i] = a.vs[page * PT + i];
      }
    }
    __syncthreads();

    // scores: a thread per byte row, every query row of the group
    for (int rr = tid; rr < TR; rr += NT) {
      const int j = rr / rows, r = rr - j * rows, p = st * a.npg + j;
      float s[GMAX];
      int si[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        si[g] = 0;
        s[g] = 0.f;
      }
      const uint32_t* krow = Ks + rr * LDW;
      const float ks_b = VAR == kCurrent ? bf16r(ksc[rr]) : 0.f;
      for (int w = 0; w < D / 4; ++w) {
        const uint32_t x = krow[w];
        if (VAR == kInt8mm) {
          const uint32_t* qc = reinterpret_cast<const uint32_t*>(Qf);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) si[g] = __dp4a(static_cast<int>(x), static_cast<int>(qc[g * 32 + w]), si[g]);
          continue;
        }
        float kv[4];
        bytes4(x, kv);
        if (VAR == kCurrent) {
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[e] = bf16r(kv[e] * ks_b);
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float4 qv = reinterpret_cast<const float4*>(Qf)[g * 32 + w];
          float t = s[g];
          t = fmaf(qv.x, kv[0], t);
          t = fmaf(qv.y, kv[1], t);
          t = fmaf(qv.z, kv[2], t);
          t = fmaf(qv.w, kv[3], t);
          s[g] = t;
        }
      }
      const int tok = j * PT + r;                        // index in the step
      const int pos = p * PT + r;
      const bool live = !a.lengths || pos < len;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float x;
        if (VAR == kCurrent) {
          x = __fmul_rn(s[g], c);
        } else if (VAR == kPostscale) {
          x = __fmul_rn(s[g], __fmul_rn(ksc[tok], c));
        } else {
          x = __fmul_rn(static_cast<float>(si[g]), __fmul_rn(__fmul_rn(qs_s[g], ksc[tok]), c));
          if (a.s_int) a.s_int[(qrow0 + g) * t_total + pos] = si[g];
        }
        Sc[g * T + tok] = live ? x : neg_inf();
      }
    }
    __syncthreads();

    {  // the step's online-softmax update: WPR warps a query row
      const int g = warp / WPR;
      float* srow = Sc + g * T;
      float mx = neg_inf();
      for (int t = part * 32 + lane; t < T; t += WPR * 32) mx = fmaxf(mx, srow[t]);
      mx = warp_max(mx);
      if (lane == 0) red[warp] = mx;
      __syncthreads();
      for (int i = 0; i < WPR; ++i) mx = fmaxf(mx, red[g * WPR + i]);
      const float m_prev = m_s[g], m_next = fmaxf(m_prev, mx);
      __syncthreads();  // red is reused
      float sum = 0.f, pmax = 0.f;
      for (int t = part * 32 + lane; t < T; t += WPR * 32) {
        const float pw = exp2f(__fsub_rn(srow[t], m_next));
        sum += pw;
        if (VAR == kCurrent) {
          srow[t] = bf16r(pw);
        } else if (VAR == kPostscale) {
          srow[t] = bf16r(__fmul_rn(pw, vsc[t]));
        } else {
          const float y = __fmul_rn(pw, vsc[t]);
          srow[t] = y;
          pmax = fmaxf(pmax, y);
        }
      }
      sum = warp_sum(sum);
      pmax = warp_max(pmax);
      if (lane == 0) {
        red[warp] = sum;
        red[NW + warp] = pmax;
      }
      __syncthreads();
      float sum_all = 0.f, pmax_all = 0.f;
      for (int i = 0; i < WPR; ++i) {
        sum_all += red[g * WPR + i];
        pmax_all = fmaxf(pmax_all, red[NW + g * WPR + i]);
      }
      if (VAR == kInt8mm) {  // p codes, per row per page
        float ps = __fdiv_rn(pmax_all, 127.f);
        ps = ps == 0.f ? 1.f : ps;
        for (int t = part * 32 + lane; t < T; t += WPR * 32) {
          const int code = static_cast<int>(rintf(__fdiv_rn(srow[t], ps)));
          Pc[g * T + t] = static_cast<int8_t>(code);
          if (a.p_codes) a.p_codes[(qrow0 + g) * t_total + st * T + t] = static_cast<int8_t>(code);
        }
        if (part == 0 && lane == 0) ps_s[g] = ps;
      }
      if (part == 0 && lane == 0) {
        const float alpha = exp2f(__fsub_rn(m_prev, m_next));
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum_all;
        m_s[g] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V: warp (g, part) takes every WPR-th row of the
    // step, a lane four columns
    {
      const float alpha = a_s[g_pv];
      const float* prow = Sc + g_pv * T;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] *= alpha;
      if (VAR == kInt8mm) {
        int pv[4] = {0, 0, 0, 0};
        const int8_t* pc = Pc + g_pv * T;
        for (int qd = part; 4 * qd < TR; qd += WPR) {  // four tokens a __dp4a
          const uint32_t x0 = Vs[(4 * qd) * LDW + lane], x1 = Vs[(4 * qd + 1) * LDW + lane];
          const uint32_t x2 = Vs[(4 * qd + 2) * LDW + lane], x3 = Vs[(4 * qd + 3) * LDW + lane];
          const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), lo23 = __byte_perm(x2, x3, 0x5140);
          const uint32_t hi01 = __byte_perm(x0, x1, 0x7362), hi23 = __byte_perm(x2, x3, 0x7362);
          const uint32_t col[4] = {
              __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
              __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
          const int pw4 = *reinterpret_cast<const int*>(pc + 4 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[e] = __dp4a(static_cast<int>(col[e]), pw4, pv[e]);
        }
        const float ps = ps_s[g_pv];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += __fmul_rn(static_cast<float>(pv[e]), ps);
      } else {
        for (int rr = part; rr < TR; rr += WPR) {
          const uint32_t x = Vs[rr * LDW + lane];
          float vv[4];
          bytes4(x, vv);
          if (VAR == kCurrent) {
            const float vs_b = bf16r(vsc[rr]);
#pragma unroll
            for (int e = 0; e < 4; ++e) vv[e] = bf16r(vv[e] * vs_b);
          }
          const float pr = prow[rr];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = fmaf(pr, vv[e], acc[e]);
        }
      }
    }
  }

  // sum the parts of each query row (in the K staging area), then finish
  __syncthreads();
  float* part_acc = reinterpret_cast<float*>(Ks);  // NW x D
  if (WPR > 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part_acc[warp * D + 4 * lane + e] = acc[e];
    __syncthreads();
    if (part == 0) {
      for (int i = 1; i < WPR; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part_acc[(warp + i) * D + 4 * lane + e];
    }
  }
  if (part == 0) {
    const float l = l_s[g_pv], l_safe = l == 0.f ? 1.f : l;
    bf16* o = a.o + (qrow0 + g_pv) * D + 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __float2bfloat16_rn(acc[e] / l_safe);
  }
}

size_t decode_smem(const DecArgs& a) {
  const size_t T = static_cast<size_t>(a.npg) * a.rows;
  return sizeof(float) * (GMAX * D + 2 * T * LDW + 2 * T + a.G * T + 2 * NW + 5 * GMAX) +
         a.G * T;
}

template <int VAR>
int decode(const DecArgs& a, cudaStream_t stream) {
  const int T = a.npg * a.rows;
  const bool ok = a.B >= 1 && a.B <= 65535 && a.n_kv >= 1 && a.n_kv <= 65535 &&
                  (a.G == 1 || a.G == 2 || a.G == 4 || a.G == 8) && a.npg >= 1 && a.rows >= 4 &&
                  a.rows % 4 == 0 && T % 4 == 0 && a.max_pages % a.npg == 0 &&
                  (a.tables || a.max_pages <= a.n_pages) && (a.lengths == nullptr || a.npg == 1);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = decode_kernel<VAR>;
  const size_t smem = decode_smem(a);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_kv, a.B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// the shared K/V of exp_int4_unpack: every row b reads pages 0 .. pages - 1
DecArgs shared_args(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                    void* o, int B, int n_kv, int G, int pages, int rows, int npg,
                    float scale_log2e) {
  DecArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.o = static_cast<bf16*>(o);
  a.B = B;
  a.n_kv = n_kv;
  a.G = G;
  a.n_pages = a.max_pages = pages;
  a.rows = rows;
  a.npg = npg;
  a.scale_log2e = scale_log2e;
  return a;
}

}  // namespace

#define FA_SHARED_ENTRY(name, NPG)                                                              \
  int name(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* o, \
           int B, int n_kv, int G, int pages, int rows, float scale_log2e, void* stream) {     \
    return decode<kPostscale>(                                                                 \
        shared_args(q, k, ks, v, vs, o, B, n_kv, G, pages, rows, NPG, scale_log2e),            \
        static_cast<cudaStream_t>(stream));                                                    \
  }

extern "C" {

// q (B, n_kv, G, 128) bf16; k, v (n_kv, pages, rows, 128) int8, rows =
// page; ks, vs (n_kv, pages, 1, rows) float32
FA_SHARED_ENTRY(fa_exp_int4_int8ref, 1)
FA_SHARED_ENTRY(fa_exp_int4_int8_2pg, 2)

// variant: 0 current, 1 postscale, 2 int8mm.  q (S, n_kv * G, 128) bf16;
// k_pages, v_pages (n_kv, n_pages, page, 128) int8; scales (n_kv, n_pages,
// page) float32 in either of the tool's layouts; tables (S, max_pages),
// lengths (S,) int32; q_codes, s_int, p_codes nullable (int8mm)
int fa_exp_paged_decode(int variant, const void* q, const void* k_pages, const void* v_pages,
                        const void* k_scales, const void* v_scales, const int* tables,
                        const int* lengths, void* o, void* q_codes, void* s_int, void* p_codes,
                        int S, int n_kv, int G, int n_pages, int page, int max_pages,
                        float scale_log2e, void* stream) {
  DecArgs a = shared_args(q, k_pages, k_scales, v_pages, v_scales, o, S, n_kv, G, n_pages, page,
                          1, scale_log2e);
  a.max_pages = max_pages;
  a.tables = tables;
  a.lengths = lengths;
  a.q_codes = static_cast<int8_t*>(q_codes);
  a.s_int = static_cast<int*>(s_int);
  a.p_codes = static_cast<int8_t*>(p_codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kCurrent: return decode<kCurrent>(a, s);
    case kPostscale: return decode<kPostscale>(a, s);
    case kInt8mm: return decode<kInt8mm>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
