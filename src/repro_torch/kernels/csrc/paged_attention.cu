// Paged decode attention: one GQA decode step over the paged KV block pool.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_decode_attention_pallas
//   (body _kernel).
// Same function: q [B,H,D] attends to the positions p < context_lens[b] of
// its block table (a context past max_pages * page counts as the table's
// full width); the online softmax keeps m/l/acc in fp32; a row with
// context_lens[b] == 0 gives zeros. No sliding window.
//
// What bounds it on an H100: bytes. Each live K/V row is read once and
// used for G = H/Kv query heads and two tiny products, so the work is a few
// FLOP per byte, far below the card's ~295 FLOP/byte balance point; the
// least time is (K/V bytes of the live context + q + out) / 3.35 TB/s.
//
// What the design does about it (split-K, "flash decoding"):
// - Grid: one block per (split, kv_head, b), a split being kSplit = 256
//   consecutive positions of the context. The wrapper sizes the grid from
//   the table width, ceil(max_pages * page / kSplit), and never reads
//   context_lens on the host. A block whose split starts at or past
//   min(ctx, max_pages * page) writes an empty partial (m = -1e30, l = 0)
//   and exits. At the full-width decode shapes this turns 64 blocks into
//   a few hundred working ones, enough to keep every SM streaming.
// - Loads: the block first looks up the pool row of each of its positions
//   through block_tables (any page size) into shared memory. Each lane
//   then loads K and V rows as 16-byte vectors along D (8 bf16 or 4 fp32),
//   D*sizeof/16 lanes per row, up to 8 tokens per warp step (at most four
//   16-byte loads of K and four of V per lane), and prefetches the warp's
//   next step into registers while it computes on the current one: at
//   bf16 D = 128, 2 steps x 8 rows x 512 bytes of K and V per warp, 32 KB
//   per block.
// - Compute: one K row serves all G query heads (held in registers, up to
//   8 per pass, more in several passes). Dot products are reduced with
//   warp shuffles; the online softmax runs in fp32, in base 2. No tensor
//   cores: at G = 4 there is nothing to feed them.
// - Merge: each block combines its 4 warps and writes (m, l, acc[G][D]) in
//   fp32 to scratch the wrapper allocates. A second small kernel merges the
//   splits of each (b, kv_head) in split order, with no atomics, so a
//   result repeats bit for bit from run to run; a split with l == 0
//   weighs nothing, and a lane with no context (ctx = 0) comes out as
//   exactly 0.
//
// Left for a later PR: cp.async/TMA staging in place of register
// prefetch, and fusing the merge into the last block of each (b, kv_head).

#include <stdint.h>

#include "common.cuh"

namespace cronus {
namespace {

constexpr int kSplit = 256;  // context positions per split (one block)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 8;  // tokens a warp takes per step (at most)
constexpr unsigned kFull = 0xffffffffu;

// the EPL elements of a 16-byte vector, widened to fp32
template <typename T, int EPL>
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[EPL]) {
  if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// Partial attention of one split for up to GB query heads per pass.
// part_ml [B, Kv, n_splits, G, 2] (m in base 2, l); part_acc [B, Kv,
// n_splits, G, D] (unnormalised).
template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages,
             const int* __restrict__ block_tables,
             const int* __restrict__ context_lens,
             float* __restrict__ part_ml, float* __restrict__ part_acc,
             int H, int Kv, int page, int max_pages, int n_splits,
             float scale_log2) {
  constexpr int EPL = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPT = D / EPL;         // lanes per token row (4..32)
  constexpr int TPI = 32 / LPT;        // tokens per warp load (1..8)
  // loads per lane per step (K or V), at most 4 so that two steps' rows
  // fit in registers; tokens per warp step
  constexpr int NI = kStep / TPI < 4 ? kStep / TPI : 4;
  constexpr int STEP = NI * TPI;
  static_assert(LPT >= 4 && LPT <= 32 && NI >= 1, "head dim");
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPT;  // which 16 bytes of the row
  const int tk = lane / LPT;   // which token of a warp load

  // a context longer than the table covers is the table's full width, as
  // in the plain version: never read past block_tables[b, max_pages - 1]
  const int ctx = min(context_lens[b], max_pages * page);
  const int t0 = split * kSplit;
  const int n = min(kSplit, ctx - t0);  // positions of this split
  const size_t part = (static_cast<size_t>(b) * Kv + kvh) * n_splits + split;
  float* ml = part_ml + part * G * 2;
  float* pacc = part_acc + part * G * D;
  if (n <= 0) {  // empty split
    for (int g = tid; g < G; g += kThreads) {
      ml[2 * g] = kNegInf;
      ml[2 * g + 1] = 0.f;
    }
    return;
  }

  __shared__ long long rows[kSplit];  // pool row of each position
  __shared__ float w_m[kWarps][GB], w_l[kWarps][GB];
  __shared__ float w_acc[kWarps][GB][D];
  for (int i = tid; i < n; i += kThreads) {
    const int pos = t0 + i;
    rows[i] = static_cast<long long>(
                  block_tables[static_cast<size_t>(b) * max_pages + pos / page]) *
                  page +
              pos % page;
  }
  __syncthreads();

  // 16-byte vector `sub` of token i's K or V row (i < n)
  auto row_ptr = [&](const T* pool, int i) {
    return reinterpret_cast<const uint4*>(
        pool + (static_cast<size_t>(rows[i]) * Kv + kvh) * D + sub * EPL);
  };
  auto load_step = [&](int base, uint4 (&kr)[NI], uint4 (&vr)[NI]) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int i = base + j * TPI + tk;
      if (i < n) {
        kr[j] = __ldg(row_ptr(k_pages, i));
        vr[j] = __ldg(row_ptr(v_pages, i));
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  for (int g0 = 0; g0 < G; g0 += GB) {
    // this lane's slice of the pass's query heads, scaled into base 2
    float qr[GB][EPL];
    const T* qb = q + (static_cast<size_t>(b) * H + kvh * G + g0) * D;
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        qr[g][e] = g0 + g < G ? to_float(qb[g * D + sub * EPL + e]) * scale_log2
                              : 0.f;

    float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    uint4 kc[NI], vc[NI];
    int base = warp * STEP;
    if (base < n) load_step(base, kc, vc);
    for (; base < n; base += kWarps * STEP) {
      uint4 kn[NI], vn[NI];
      const int next = base + kWarps * STEP;
      if (next < n) load_step(next, kn, vn);  // in flight during the math

      float s[NI][GB];
      bool ok[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        ok[j] = base + j * TPI + tk < n;
        float kx[EPL];
        widen<T, EPL>(kc[j], kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kx[e], dot);
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(kFull, dot, o);
          s[j][g] = dot;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NI; ++j)
          if (ok[j]) mx = fmaxf(mx, s[j][g]);
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        m[g] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          s[j][g] = ok[j] ? exp2f(s[j][g] - m_new) : 0.f;
          ps += s[j][g];
        }
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float vx[EPL];
        widen<T, EPL>(vc[j], vx);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(s[j][g], vx[e], acc[g][e]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        kc[j] = kn[j];
        vc[j] = vn[j];
      }
    }

    // the warp's lanes of one row slice hold different tokens: sum them
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1)
          acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    if (tk == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) w_acc[warp][g][sub * EPL + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        w_m[warp][g] = m[g];
        w_l[warp][g] = l[g];
      }
    }
    __syncthreads();

    // combine the warps (a warp that saw no token has m = -1e30, l = 0)
    for (int i = tid; i < GB * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      if (g0 + g >= G) continue;
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w_m[w][g]);
      float a = 0.f, ll = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(w_m[w][g] - mm);
        a = fmaf(f, w_acc[w][g][d], a);
        ll = fmaf(f, w_l[w][g], ll);
      }
      pacc[(g0 + g) * D + d] = a;
      if (d == 0) {
        ml[2 * (g0 + g)] = mm;
        ml[2 * (g0 + g) + 1] = ll;
      }
    }
    __syncthreads();  // w_* are reused by the next pass
  }
}

// out[b, kvh*G + g, :] from the splits' partials, in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_ml,
             const float* __restrict__ part_acc, T* __restrict__ out, int H,
             int Kv, int D, int n_splits) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Kv;
  const size_t part0 = (static_cast<size_t>(b) * Kv + kvh) * n_splits;
  T* ob = out + (static_cast<size_t>(b) * H + kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mm = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      mm = fmaxf(mm, part_ml[((part0 + s) * G + g) * 2]);
    float a = 0.f, ll = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* ml = part_ml + ((part0 + s) * G + g) * 2;
      if (ml[1] > 0.f) {  // an empty split weighs nothing
        const float f = exp2f(ml[0] - mm);
        a = fmaf(f, part_acc[((part0 + s) * G + g) * D + d], a);
        ll = fmaf(f, ml[1], ll);
      }
    }
    ob[i] = from_float<T>(ll > 0.f ? a / ll : 0.f);
  }
}

template <typename T, int D, int GB>
cudaError_t launch_splits(const void* q, const void* k, const void* v,
                          const int* tables, const int* ctx, float* part_ml,
                          float* part_acc, int B, int H, int Kv, int page,
                          int max_pages, int n_splits, float scale_log2,
                          cudaStream_t stream) {
  split_kernel<T, D, GB><<<dim3(n_splits, Kv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, ctx, part_ml, part_acc, H, Kv, page,
      max_pages, n_splits, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* tables, const int* ctx, float* part_ml,
                     float* part_acc, int B, int H, int Kv, int page,
                     int max_pages, int n_splits, float scale_log2,
                     cudaStream_t stream) {
  const int G = H / Kv;  // heads per pass: the least power of 2 >= G, <= 8
  if (G <= 1)
    return launch_splits<T, D, 1>(q, k, v, tables, ctx, part_ml, part_acc, B,
                                  H, Kv, page, max_pages, n_splits,
                                  scale_log2, stream);
  if (G <= 2)
    return launch_splits<T, D, 2>(q, k, v, tables, ctx, part_ml, part_acc, B,
                                  H, Kv, page, max_pages, n_splits,
                                  scale_log2, stream);
  if (G <= 4)
    return launch_splits<T, D, 4>(q, k, v, tables, ctx, part_ml, part_acc, B,
                                  H, Kv, page, max_pages, n_splits,
                                  scale_log2, stream);
  return launch_splits<T, D, 8>(q, k, v, tables, ctx, part_ml, part_acc, B, H,
                                Kv, page, max_pages, n_splits, scale_log2,
                                stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* ctx, void* out,
                   float* part_ml, float* part_acc, int B, int H, int Kv,
                   int D, int page, int max_pages, int n_splits, float scale,
                   cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_d<T, 32>(q, k, v, tables, ctx, part_ml, part_acc, B, H, Kv,
                            page, max_pages, n_splits, scale_log2, stream);
      break;
    case 64:
      err = launch_d<T, 64>(q, k, v, tables, ctx, part_ml, part_acc, B, H, Kv,
                            page, max_pages, n_splits, scale_log2, stream);
      break;
    case 128:
      err = launch_d<T, 128>(q, k, v, tables, ctx, part_ml, part_acc, B, H,
                             Kv, page, max_pages, n_splits, scale_log2,
                             stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  merge_kernel<T><<<dim3(Kv, B), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), H, Kv, D, n_splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cronus

// Context positions per split: the wrapper sizes the grid and the scratch
// from it, n_splits = ceil(max_pages * page / split).
extern "C" int paged_decode_split_tokens() { return cronus::kSplit; }

// q [B,H,D]; k/v_pages [P,page,Kv,D] (16-byte aligned); block_tables
// [B,max_pages] int32; context_lens [B] int32; out [B,H,D]; part_ml
// [B,Kv,n_splits,G,2] and part_acc [B,Kv,n_splits,G,D] fp32 scratch. All
// contiguous, q/k/v/out of one dtype (0 = float32, 1 = bfloat16). Launches
// the split kernel, then the merge kernel. Returns a cudaError_t code.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, void* out,
    float* part_ml, float* part_acc, int B, int H, int Kv, int D, int page,
    int max_pages, int n_splits, float scale, int dtype, void* stream) {
  using namespace cronus;
  if (B == 0) return cudaSuccess;
  if (n_splits < 1 ||
      static_cast<long long>(n_splits) * kSplit <
          static_cast<long long>(max_pages) * page)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k_pages, v_pages, block_tables, context_lens, out,
                         part_ml, part_acc, B, H, Kv, D, page, max_pages,
                         n_splits, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                 context_lens, out, part_ml, part_acc, B, H,
                                 Kv, D, page, max_pages, n_splits, scale, s);
  return cudaErrorInvalidValue;
}
