// Chunked-prefill attention: flash attention of a prefill chunk over the
// request's gathered KV context.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/chunked_prefill_attention.py::
//   chunked_prefill_attention_pallas (body _kernel).
// Same function: q [B,C,H,D] attends to k/v [B,S,Kv,D]; a (query, key)
// pair is valid iff 0 <= kv_pos <= q_pos, and also kv_pos > q_pos - window
// when window > 0; -1 positions mark padding; explicit softmax scale;
// m/l/acc in fp32; a row with no valid key gives zeros.
//
// What bounds it on an H100: operations. A chunk of C queries against S
// keys does 4*C*S*H*D FLOP on (C*H + 2*S*Kv)*D elements, hundreds of FLOP
// per byte at C = 512, so the least time is that count over the tensor
// cores' 989 TFLOP/s (bf16).
//
// What the design does about it, for now: one thread block per
// (query tile, kv_head, b). The query tile folds the GQA group into its
// rows (bq * G = 64 rows) and stays in shared memory while the block loops
// over K/V tiles of 64 keys, so each K/V element is read once per query
// tile for all G heads. Each thread keeps a 4x4 register tile of scores
// and a 4x(D/16) register tile of the output, so every shared-memory load
// feeds several FMAs. The kernel masks by q_pos/kv_pos/window and masks
// the ragged C and S edges itself: there is no padding of C, S or D (the
// TPU wrapper padded C/S to tile multiples and D to 128 for the MXU).
// This first version multiplies on the CUDA cores in fp32; the tensor
// cores (wgmma fed by TMA, with warp specialisation) are the next step.

#include "common.cuh"

namespace cronus {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // query rows (query, group member) per block
constexpr int kKeys = 64;  // keys per K/V tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int C, int S, int H, int Kv, int bq, int window,
                       float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kCols = D / 16;  // output columns per thread
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kv;
  const int R = bq * G;  // live rows of this block (<= kRows)
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / column group
  const int ty = tid >> 4;  // row group

  extern __shared__ float smem[];
  float* qs = smem;                      // [kRows][D + 1]
  float* ks = qs + kRows * (D + 1);      // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);      // [kKeys][D]
  float* ss = vs + kKeys * D;            // [kRows][kKeys + 1] scores/probs
  float* rm = ss + kRows * (kKeys + 1);  // [kRows] running max
  float* rl = rm + kRows;                // [kRows] running denominator
  float* ra = rl + kRows;                // [kRows] rescale of this tile
  int* qp = reinterpret_cast<int*>(ra + kRows);  // [kRows] query positions
  int* kp = qp + kRows;                          // [kKeys] key positions

  // query tile: row r is query q0 + r / G, head kvh * G + r % G
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int qi = q0 + r / G;
    float x = 0.f;
    if (r < R && qi < C) {
      const size_t off =
          ((static_cast<size_t>(b) * C + qi) * H + kvh * G + r % G) * D + d;
      x = to_float(q[off]);
    }
    qs[r * (D + 1) + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int qi = q0 + r / G;
    qp[r] = (r < R && qi < C) ? q_pos[static_cast<size_t>(b) * C + qi] : -1;
    rm[r] = kNegInf;
    rl[r] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    const int n = min(kKeys, S - k0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int t = i / D;
      const int d = i % D;
      float kx = 0.f, vx = 0.f;
      if (t < n) {
        const size_t off =
            ((static_cast<size_t>(b) * S + k0 + t) * Kv + kvh) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      ks[t * (D + 1) + d] = kx;
      vs[t * D + d] = vx;
    }
    for (int t = tid; t < kKeys; t += kThreads)
      kp[t] = t < n ? kv_pos[static_cast<size_t>(b) * S + k0 + t] : -1;
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(ty + 16 * i) * (kKeys + 1) + tx + 16 * j] = sc[i][j] * scale;
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 keys each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      const int qpr = qp[r];
      float* srow = ss + r * (kKeys + 1) + part * 16;
      float mc = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int kvp = kp[part * 16 + jj];
        const bool valid = kvp >= 0 && kvp <= qpr &&
                           (window <= 0 || kvp > qpr - window);
        if (valid) mc = fmaxf(mc, srow[jj]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_prev = rm[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int kvp = kp[part * 16 + jj];
        const bool valid = kvp >= 0 && kvp <= qpr &&
                           (window <= 0 || kvp > qpr - window);
        const float p = valid ? expf(srow[jj] - m_new) : 0.f;
        srow[jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float a = expf(m_prev - m_new);
        ra[r] = a;
        rl[r] = rl[r] * a + sum;
        rm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = ra[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
    for (int t = 0; t < n; ++t) {
      float p[4], c[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * (kKeys + 1) + t];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = vs[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r / G;
    if (r >= R || qi >= C) continue;
    const float lf = rl[r];
    const float inv = 1.f / (lf == 0.f ? 1.f : lf);
    T* orow = out +
              ((static_cast<size_t>(b) * C + qi) * H + kvh * G + r % G) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int C, int S, int H, int Kv, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / Kv;
  const int bq = kRows / G;
  const size_t smem =
      sizeof(float) * (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D +
                       kRows * (kKeys + 1) + 3 * kRows) +
      sizeof(int) * (kRows + kKeys);
  const dim3 grid((C + bq - 1) / bq, Kv, B);
  return launch_with_smem(chunked_prefill_kernel<T, D>, grid,
                          dim3(kThreads), smem, stream,
                          static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), q_pos, kv_pos,
                          static_cast<T*>(out), C, S, H, Kv, bq, window,
                          scale);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int C, int S, int H, int Kv, int D,
                         int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace cronus

// q [B,C,H,D]; k/v [B,S,Kv,D]; q_pos [B,C] and kv_pos [B,S] int32 (-1 =
// padding); out [B,C,H,D]. All contiguous, q/k/v/out of one dtype
// (0 = float32, 1 = bfloat16); H / Kv <= 64. Returns a cudaError_t code.
extern "C" int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, int B, int C, int S, int H, int Kv, int D,
    int window, float scale, int dtype, void* stream) {
  using namespace cronus;
  if (B == 0 || C == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dtype<float>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv,
                               D, window, scale, s);
  if (dtype == kBFloat16)
    return launch_dtype<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, C, S,
                                       H, Kv, D, window, scale, s);
  return cudaErrorInvalidValue;
}
