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
// keys does 4*H*D FLOP per valid (query, key) pair on (C*H + 2*S*Kv)*D
// elements, hundreds of FLOP per byte at C = 512, so the least time is
// the valid pairs' FLOP over the tensor cores' 989 TFLOP/s (bf16).
//
// What the bf16 design (tc::kernel) does about it:
// - Grid: one block of two warpgroups per (query tile, kv_head, b). The
//   tile folds the GQA group into its 128 rows: row r is query q0 + r / G,
//   head kv_head * G + r % G, so each K/V tile is read once for all G
//   heads. Each warpgroup owns 64 rows.
// - Products on the tensor cores with wgmma, fp32 accumulators in
//   registers: S = Q K^T (m64n64k16, Q from registers, K from shared
//   memory) and O += P V (m64nDk16, P from registers, V from shared
//   memory through the transposed-B descriptor, since V's D is
//   contiguous). P never leaves registers: the S accumulator of a 16-key
//   slice, as bf16, is element for element the A fragment of P V.
// - Loads: the Q tile and a 3-stage ring of 64-key K/V tiles (and their
//   kv_pos) are filled with 16-byte cp.async copies, straight into the
//   128-byte swizzled layout wgmma reads, one tile ahead of its scores.
//   D = 32 is held zero-padded to 64 columns. Q is then held in
//   registers as the A operand of S.
// - Overlap, in FlashAttention-3's order: tile i's S and tile i-1's P V
//   are issued together, tile i's softmax runs while P V (2/3 of the
//   tensor work) multiplies, and O is rescaled and P packed only after
//   the wait. ptxas serializes every wgmma of a kernel that writes an
//   accumulator while a wgmma is in flight (warning C7515); an earlier
//   order that rescaled O under the next tile's S did, and was ~13%
//   slower.
// - Skip rule: before the loop the block reads every tile's kv_pos and
//   keeps only tiles in which some pair can be valid. A tile is skipped
//   when it holds no kv_pos >= 0, when its least kv_pos exceeds the
//   block's greatest q_pos, or (window > 0) when its greatest kv_pos is
//   <= the block's least q_pos - window. That holds for any positions,
//   sorted or not. Skipped tiles are neither loaded nor multiplied, and a
//   query tile whose rows are all padding writes zeros and exits, so the
//   executor's power-of-two padding of C and S costs almost nothing.
// - Softmax: online in registers, in base 2 (the scale carries log2 e),
//   on the special-function unit's exp2. Its instructions, not the
//   products, set the pace, so a tile whose pairs are all valid (no
//   padding, every key at or before every query and inside the window)
//   skips the mask, and O is rescaled only when a row's max moved.
//   Elsewhere p is exactly 0 for an invalid pair, so a row whose tile
//   holds no valid key adds nothing; zeros where l == 0.
// - Ragged C and S edges are masked here (zero-filled copies past S, rows
//   past C never written): nothing is padded.
// P V takes P as two bf16 terms, its rounding and the rounding of the
// rest (two products on the same V tile): P rounded to bf16 alone (2^-9
// of each term) put outputs of short rows, whose errors do not average
// out, up to 11x past the one-ulp tolerance of the on-card check.
//
// The fp32 instantiation (fp32::chunked_prefill_kernel) keeps the first
// port's CUDA-core body unchanged: TF32 tensor cores would miss the fp32
// tolerance of 2e-5, and fp32 runs only in parity checks; the main path
// runs bf16.
//
// Left for a later PR: the two warpgroups run the same phases at the same
// time (one barrier per tile), and S waits for nothing to hide it. Warp
// specialisation (a producer warp on mbarriers, ping-pong between the
// warpgroups: tried only while the wgmmas were still serialized), TMA
// loads, a persistent grid that evens out the blocks' unequal tile
// counts, and reading K/V pages through the block table instead of the
// executor's gather.

#include <stdint.h>

#include <climits>

#include "common.cuh"

namespace cronus {
namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA-core body (parity checks only)
// ---------------------------------------------------------------------------
namespace fp32 {

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

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: tensor cores (the main path)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;           // two warpgroups of 64 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows (query, group member)
constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kStages = 3;          // K/V tiles in the ring
constexpr unsigned kFull = 0xffffffffu;
// descriptor strides of V, the transposed (MN-major) B operand of P V:
// between its 64-column blocks, and between groups of 8 keys
constexpr uint32_t kVBlockStride = kKeys * 128;
constexpr uint32_t kVGroupStride = 8 * 128;

// Operand tiles sit in shared memory as wgmma's 128-byte swizzle reads
// them: a tile of `rows` rows by DP (64 or 128) bf16 columns is DP / 64
// column blocks, each `rows` rows of 128 bytes at a 1024-byte aligned
// address, and 16-byte chunk c of row r of a block lies at chunk
// c ^ (r % 8). Byte offset of chunk c (0 .. DP/8 - 1) of row r:
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor of wgmma, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled and
// the source is not read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// this thread's finished shared-memory writes, made visible to wgmma's
// (asynchronous) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma operand
// registers across a wgmma fence or wait (no instruction)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A B on one warpgroup, m64n64k16, A from registers (per warp,
// the mma.sync A-fragment layout), B from shared memory (K-major);
// scale_d == 0 ignores d's old value
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d += A B on one warpgroup, m64n64k16, A from registers (per warp,
// the mma.sync A-fragment layout), B from shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B on one warpgroup, m64n128k16, A from registers (per warp,
// the mma.sync A-fragment layout), B from shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64_t(o, a, db);
  } else {
    wgmma_rs_n128_t(o, a, db);
  }
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) = head + tail, both bf16 pairs: the head is (x0, x1) rounded,
// the tail the rounding of what is left, so head + tail is within 2^-16
// of x relatively
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& head,
                                           uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// columns held in shared memory: D = 32 is zero-padded to one 64-column
// block
template <int D>
struct Held {
  static constexpr int kCols = D < 64 ? 64 : D;
};

// dynamic shared memory without the live-tile list (1024 bytes of slack
// for the alignment of the swizzled tiles)
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * (kRows + 2 * kStages * kKeys) * Held<D>::kCols +
         sizeof(int) * kStages * kKeys;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const int* __restrict__ q_pos,
       const int* __restrict__ kv_pos, bf16* __restrict__ out, int C, int S,
       int H, int Kv, int bq, int window, float scale_log2) {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  constexpr int DP = Held<D>::kCols;
  constexpr int kChunks = DP / 8;  // 16-byte chunks per held row
  constexpr int kLive = D / 8;     // chunks that hold data
  constexpr int kSteps = DP / 16;  // k-steps of Q K^T
  constexpr uint32_t kTileBytes = kKeys * DP * sizeof(bf16);
  constexpr int kFullBit = 1 << 30;  // in a live-tile id: every pair valid
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Kv;
  const int R = bq * G;  // live rows of this block (<= kRows)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (S + kKeys - 1) / kKeys;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;          // [DP/64][kRows][64]
  const uint32_t ks = qs + kRows * DP * sizeof(bf16);  // [kStages] tiles
  const uint32_t vs = ks + kStages * kTileBytes;       // [kStages] tiles
  int* kps = reinterpret_cast<int*>(smem_raw + (vs - raw) +
                                    kStages * kTileBytes);  // [kStages][kKeys]
  int* live = kps + kStages * kKeys;  // [n_tiles]: flags, then live ids
  __shared__ int w_qmin[kWarps], w_qmax[kWarps];
  __shared__ int s_n_live;

  // the Q tile: row r is query q0 + r / G, head kvh * G + r % G
  const size_t head0 = static_cast<size_t>(b) * C * H + kvh * G;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int qi = q0 + r / G;
    const bool ok = r < R && qi < C && c < kLive;
    const bf16* src =
        ok ? q + (head0 + static_cast<size_t>(qi) * H + r % G) * D + c * 8 : q;
    cp_async16(qs + sw128(kRows, r, c), src, ok);
  }
  cp_async_commit();

  // this lane's two rows (lane/4 and lane/4 + 8 of its warp's 16)
  const int r_lo = 16 * warp + (lane >> 2);
  int qp[2];
  bool pad = false;  // a row this block writes is padding
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const int qi = q0 + r / G;
    const bool writes = r < R && qi < C;
    qp[h] = writes ? q_pos[static_cast<size_t>(b) * C + qi] : -1;
    pad |= writes && qp[h] < 0;
  }
  {
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qp[h] >= 0) lo = min(lo, qp[h]);
      hi = max(hi, qp[h]);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      w_qmin[warp] = lo;
      w_qmax[warp] = hi;
    }
  }
  pad = __syncthreads_or(pad);
  int qmin = INT_MAX, qmax = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qmin = min(qmin, w_qmin[w]);
    qmax = max(qmax, w_qmax[w]);
  }

  // Which K/V tiles can hold a valid pair, from their kv_pos alone; and
  // which hold only valid pairs (no padding key or row, every key at or
  // before every query and inside the window): those skip the masks.
  if (qmax >= 0) {
    for (int t = warp; t < n_tiles; t += kWarps) {
      int lo = INT_MAX, hi = -1;
      bool holes = false;
      for (int j = lane; j < kKeys; j += 32) {
        const int key = t * kKeys + j;
        const int p = key < S ? kv_pos[static_cast<size_t>(b) * S + key] : -1;
        if (p >= 0) {
          lo = min(lo, p);
          hi = max(hi, p);
        } else {
          holes = true;
        }
      }
      lo = __reduce_min_sync(kFull, lo);
      hi = __reduce_max_sync(kFull, hi);
      holes = __any_sync(kFull, holes);
      if (lane == 0) {
        const bool any =
            hi >= 0 && lo <= qmax && !(window > 0 && hi <= qmin - window);
        const bool all = !holes && !pad && hi <= qmin &&
                         (window <= 0 || lo > qmax - window);
        live[t] = any ? 1 + all : 0;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact the flags into the ids of live tiles, in order
    int n = 0;
    if (qmax >= 0) {
      for (int t0 = 0; t0 < n_tiles; t0 += 32) {
        const int t = t0 + lane;
        const int f = t < n_tiles ? live[t] : 0;
        const unsigned mask = __ballot_sync(kFull, f != 0);
        __syncwarp();
        if (f)
          live[n + __popc(mask & ((1u << lane) - 1u))] =
              t | (f == 2 ? kFullBit : 0);
        n += __popc(mask);
        __syncwarp();
      }
    }
    if (lane == 0) s_n_live = n;
  }
  __syncthreads();
  const int n_live = s_n_live;

  // stage i % kStages receives live tile i; live tile i is loaded while
  // tile i - (kStages - 2) is multiplied
  auto load_tile = [&](int i) {
    const int t = live[i] & (kFullBit - 1);
    const int s = i % kStages;
    const uint32_t kd = ks + s * kTileBytes;
    const uint32_t vd = vs + s * kTileBytes;
    for (int x = tid; x < kKeys * kChunks; x += kThreads) {
      const int r = x / kChunks;
      const int c = x % kChunks;
      const int key = t * kKeys + r;
      const bool ok = key < S && c < kLive;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * S + key) * Kv + kvh) * D + c * 8 : 0;
      const uint32_t o = sw128(kKeys, r, c);
      cp_async16(kd + o, k + off, ok);
      cp_async16(vd + o, v + off, ok);
    }
    if (tid < kKeys) {
      const int key = t * kKeys + tid;
      int* dst = kps + s * kKeys + tid;
      if (key < S)
        cp_async4(smem_addr(dst), kv_pos + static_cast<size_t>(b) * S + key);
      else
        *dst = -1;  // past the ragged S edge: padding
    }
  };
  // S = Q K^T of live tile i for this warpgroup's 64 rows, issued (the
  // caller commits and waits)
  uint32_t qf[kSteps][4];  // this warp's 16 rows of Q, A fragments
  auto issue_scores = [&](int i, float (&acc)[32]) {
    const uint32_t kd = ks + (i % kStages) * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_rs_n64(acc, qf[kk],
                   desc(kd + (kk >> 2) * kKeys * 128 + (kk & 3) * 32, 16,
                        1024),
                   kk > 0);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_live) load_tile(i);
    cp_async_commit();
  }

  // O accumulator in the wgmma layout: o[4j + 2h + e] is row r_lo + 8h,
  // column 8j + 2(lane % 4) + e; the running max; this lane's share of
  // the row sums; the scores of the current tile; the previous tile's P
  // as A fragments of P V, a bf16 head and the bf16 rounding of the rest
  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float cur[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) cur[j] = 0.f;
  uint32_t hi[4][4], lo[4][4];

  // mask and online softmax of live tile i in place; cur[4j + 2h + e] is
  // row r_lo + 8h, key 8j + 2(lane % 4) + e. A tile whose pairs are all
  // valid needs no mask; elsewhere p is set to exactly 0 for an invalid
  // pair. Returns O's rescale factors in alpha.
  auto softmax = [&](int i, float (&alpha)[2]) {
    const int entry = live[i];
    const int s = i % kStages;
    float mx[2] = {kNegInf, kNegInf};
    uint32_t valid = 0xffffffffu;
    if (entry & kFullBit) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        cur[x] *= scale_log2;
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], cur[x]);
      }
    } else {
      const int* kp = kps + s * kKeys;
      valid = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kp[8 * j + 2 * (lane & 3) + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = kpos >= 0 && kpos <= qp[h] &&
                            (window <= 0 || kpos > qp[h] - window);
            valid |= static_cast<uint32_t>(ok) << (4 * j + 2 * h + e);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        cur[x] *= scale_log2;
        if ((valid >> x) & 1u)
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], cur[x]);
      }
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
    if (entry & kFullBit) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        cur[x] = ex2(cur[x] - m[(x >> 1) & 1]);
        ls[(x >> 1) & 1] += cur[x];
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        cur[x] = (valid >> x) & 1u ? ex2(cur[x] - m[(x >> 1) & 1]) : 0.f;
        ls[(x >> 1) & 1] += cur[x];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
  };
  // With no P V in flight: rescale O (only where some row of the warp
  // raised its max) and turn P into the A fragments of P V, 16 keys a
  // slice. The S accumulator is, element for element, P's A fragment.
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
    }
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_bf16(cur[8 * tt + 2 * x], cur[8 * tt + 2 * x + 1], hi[tt][x],
                   lo[tt][x]);
  };
  // O += P V of live tile i, issued (the caller commits and waits)
  auto issue_pv = [&](int i) {
    const uint32_t vd = vs + (i % kStages) * kTileBytes;
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const uint64_t dv =
          desc(vd + tt * 16 * 128, kVBlockStride, kVGroupStride);
      wgmma_pv<DP>(o, hi[tt], dv);
      wgmma_pv<DP>(o, lo[tt], dv);
    }
  };

  float alpha[2];
  if (n_live > 0) {
    cp_async_wait<kStages - 2>();  // the Q tile and live tile 0
    fence_async_shared();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldsm_x4(qs + sw128(kRows, 16 * warp + (lane & 15), 2 * kk + (lane >> 4)),
              qf[kk]);
    fence_regs(cur);
    wgmma_fence();
    issue_scores(0, cur);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cur);
    softmax(0, alpha);
    rescale_and_pack(alpha);
  }
  // Tile i's S and tile i-1's P V are issued together; tile i's softmax
  // runs while P V multiplies. No register that a wgmma in flight
  // accumulates into is written meanwhile (O is rescaled after the wait),
  // so ptxas keeps the wgmmas asynchronous.
  for (int i = 1; i < n_live; ++i) {
    cp_async_wait<kStages - 3>();  // live tile i has landed
    fence_async_shared();
    __syncthreads();  // ... for every thread; tile i-2 is done with
    if (i + kStages - 2 < n_live) load_tile(i + kStages - 2);
    cp_async_commit();
    fence_regs(cur);
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_scores(i, cur);  // scale_d = 0 on the first k-step: no reset
    wgmma_commit();
    issue_pv(i - 1);
    wgmma_commit();
    wgmma_wait<1>();  // tile i's scores
    fence_regs(cur);
    softmax(i, alpha);
    wgmma_wait<0>();  // tile i-1's P V
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    rescale_and_pack(alpha);
  }
  if (n_live > 0) {
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_pv(n_live - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lf = l[h];
    lf += __shfl_xor_sync(kFull, lf, 1);
    lf += __shfl_xor_sync(kFull, lf, 2);
    const int r = r_lo + 8 * h;
    const int qi = q0 + r / G;
    if (r >= R || qi >= C) continue;
    const float inv = lf == 0.f ? 0.f : 1.f / lf;
    bf16* orow = out + (head0 + static_cast<size_t>(qi) * H + r % G) * D +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

}  // namespace tc

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int B,
                        int C, int S, int H, int Kv, int window, float scale,
                        cudaStream_t stream) {
  using namespace fp32;
  const int G = H / Kv;
  const int bq = kRows / G;
  const size_t smem =
      sizeof(float) * (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D +
                       kRows * (kKeys + 1) + 3 * kRows) +
      sizeof(int) * (kRows + kKeys);
  const dim3 grid((C + bq - 1) / bq, Kv, B);
  return launch_with_smem(chunked_prefill_kernel<float, D>, grid,
                          dim3(kThreads), smem, stream,
                          static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v), q_pos, kv_pos,
                          static_cast<float*>(out), C, S, H, Kv, bq, window,
                          scale);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int B,
                        int C, int S, int H, int Kv, int window, float scale,
                        cudaStream_t stream) {
  using namespace tc;
  const int G = H / Kv;
  const int bq = kRows / G;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const size_t smem = smem_bytes<D>() + sizeof(int) * (n_tiles > 0 ? n_tiles : 1);
  if (smem > 232448) return cudaErrorInvalidValue;  // S too long
  const dim3 grid((C + bq - 1) / bq, Kv, B);
  return launch_with_smem(kernel<D>, grid, dim3(kThreads), smem, stream,
                          static_cast<const bf16*>(q),
                          static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), q_pos, kv_pos,
                          static_cast<bf16*>(out), C, S, H, Kv, bq, window,
                          scale * 1.4426950408889634f);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int C, int S, int H, int Kv, int window, float scale,
                   int dtype, cudaStream_t stream) {
  if (dtype == kFloat32)
    return launch_fp32<D>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv, window,
                          scale, stream);
  if (dtype == kBFloat16)
    return launch_bf16<D>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv, window,
                          scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cronus

// q [B,C,H,D]; k/v [B,S,Kv,D]; q_pos [B,C] and kv_pos [B,S] int32 (-1 =
// padding); out [B,C,H,D]. All contiguous and 16-byte aligned, q/k/v/out
// of one dtype (0 = float32, 1 = bfloat16); H / Kv <= 64. Returns a
// cudaError_t code.
extern "C" int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, int B, int C, int S, int H, int Kv, int D,
    int window, float scale, int dtype, void* stream) {
  using namespace cronus;
  if (B == 0 || C == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv, window,
                        scale, dtype, s);
    case 64:
      return launch<64>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv, window,
                        scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, q_pos, kv_pos, out, B, C, S, H, Kv, window,
                         scale, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
