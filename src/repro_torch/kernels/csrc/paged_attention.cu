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
// What the design does about it: one thread block per (b, kv_head), so
// every page is read from device memory once for all G query heads (the
// TPU grid (B, Kv, pages) ran pages in order; here the page loop is inside
// the block). The block walks the context in tiles of 32 tokens, looks up
// each token's pool row through block_tables itself (any page size), and
// stops at ctx: pages past the context are never read. K/V tiles are
// staged in shared memory so that loads are coalesced along D.
// Left for later: split-K over the context (flash decoding) to fill all
// SMs when B * Kv is small, vectorised 16-byte loads, and cp.async/TMA
// double buffering.

#include "common.cuh"

namespace cronus {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // tokens per tile: one warp lane per token

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens,
                    T* __restrict__ out, int H, int Kv, int page,
                    int max_pages, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                    // [G][D]
  float* ks = qs + G * D;              // [kTile][D + 1] (padded: no conflicts)
  float* vs = ks + kTile * (D + 1);    // [kTile][D]
  float* ps = vs + kTile * D;          // [G][kTile] scores, then probs
  float* acc = ps + G * kTile;         // [G][D]
  float* m = acc + G * D;              // [G] running max
  float* l = m + G;                    // [G] running denominator
  float* alpha = l + G;                // [G] rescale of this tile
  __shared__ long long rows[kTile];    // pool row of each tile token

  // a context longer than the table covers is the table's full width, as
  // in the plain version: never read past block_tables[b, max_pages - 1]
  const int ctx = min(context_lens[b], max_pages * page);
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  const T* qb = q + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < ctx; t0 += kTile) {
    const int n = min(kTile, ctx - t0);
    if (tid < n) {
      const int pos = t0 + tid;
      const long long blk =
          block_tables[static_cast<size_t>(b) * max_pages + pos / page];
      rows[tid] = blk * page + pos % page;
    }
    __syncthreads();
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D;
      const int d = i % D;
      const size_t off = (static_cast<size_t>(rows[t]) * Kv + kvh) * D + d;
      ks[t * (D + 1) + d] = to_float(k_pages[off]);
      vs[t * D + d] = to_float(v_pages[off]);
    }
    __syncthreads();

    // scores s[g][t] = q_g . k_t * scale (tokens past n are masked below)
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      float s = kNegInf;
      if (t < n) {
        const float* qg = qs + g * D;
        const float* kt = ks + t * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kt[d], dot);
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per token
    for (int g = warp; g < G; g += kThreads / 32) {
      const bool valid = lane < n;
      const float s = ps[g * kTile + lane];
      float mc = valid ? s : kNegInf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mc);
      const float p = valid ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v[t][d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pg = ps + g * kTile;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < n; ++t) a = fmaf(pg[t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float lf = l[i / D];
    ob[i] = from_float<T>(acc[i] / (lf == 0.f ? 1.f : lf));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* ctx, void* out, int B,
                   int H, int Kv, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem =
      sizeof(float) * (2 * G * D + kTile * (D + 1) + kTile * D +
                       G * kTile + 3 * G);
  return launch_with_smem(paged_decode_kernel<T, D>, dim3(B, Kv),
                          dim3(kThreads), smem, stream,
                          static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), tables, ctx,
                          static_cast<T*>(out), H, Kv, page, max_pages,
                          scale);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* tables, const int* ctx, void* out, int B,
                         int H, int Kv, int D, int page, int max_pages,
                         float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, tables, ctx, out, B, H, Kv, page,
                           max_pages, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, tables, ctx, out, B, H, Kv, page,
                           max_pages, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, tables, ctx, out, B, H, Kv, page,
                            max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace cronus

// q [B,H,D]; k/v_pages [P,page,Kv,D]; block_tables [B,max_pages] int32;
// context_lens [B] int32; out [B,H,D]. All contiguous, q/k/v/out of one
// dtype (0 = float32, 1 = bfloat16). Returns a cudaError_t code.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, void* out, int B,
    int H, int Kv, int D, int page, int max_pages, float scale, int dtype,
    void* stream) {
  using namespace cronus;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dtype<float>(q, k_pages, v_pages, block_tables,
                               context_lens, out, B, H, Kv, D, page,
                               max_pages, scale, s);
  if (dtype == kBFloat16)
    return launch_dtype<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                       context_lens, out, B, H, Kv, D, page,
                                       max_pages, scale, s);
  return cudaErrorInvalidValue;
}
