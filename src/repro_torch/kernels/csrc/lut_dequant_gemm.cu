// Packed low-bit-code GEMM with in-kernel value-LUT decode, for Hopper (sm_90a).
//
//   y[B, F] = (x[B, K] @ grid[codes][F, K]^T) * scale[F]      (f32 out)
//
// Replaces the TPU kernel src/repro/kernels/lut_dequant_gemm.py::lut_dequant_gemm
// (body _decode_kernel_body).  Same function: codes are bw-bit (bw in 1,2,4,8),
// bit-packed little-endian within each uint8 byte, [F, ceil(K/cpb)] row-major;
// each code is decoded through the 2^bw-entry value grid; products accumulate
// in f32; the per-output-channel scale is applied once, after the K sum.
//
// What bounds it on an H100: at decode (B = the serve batch, 4) the F*K*bw/8
// code bytes, read once; at prefill (B = batch x prompt bucket, up to 512) the
// 2*B*F*K multiply-adds.  This first version is simple and right: one CTA per
// [TB_B x TB_F] output tile, a loop over K chunks inside the block (the TPU's
// sequential kk grid axis), the chunk's packed bytes read from device memory
// as 32-bit words (one chunk ahead, in registers, to overlap their latency)
// and decoded through the grid held in shared memory into an f32 weight tile,
// the x chunk staged as f32, and a register tile of f32 accumulators per
// thread.  Two tile shapes: a 4-row one for decode (no wasted rows at batch 4,
// many CTAs along F), a 64x64 one with a 4x4 register tile for prefill.
// No wgmma, TMA, shared-memory pipelining or split-K yet.
//
// Determinism: every output accumulates k = 0 .. K-1 in order with fmaf, the
// same in both tile shapes, so a row's result never depends on B, on the
// other rows, or on which tile it fell into (the serving contracts of the
// reference: scan == loop, per-row invariance).  Codes at k >= K (the packing
// pad) and rows/columns past B/F are masked to zero, not read from x.
//
// Plain C interface for ctypes; the caller passes the stream and allocates y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct GridVals {
  float v[256];
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BW, typename T, int TB_B, int TB_F, int RB, int RF, int KC>
__global__ void __launch_bounds__((TB_B / RB) * (TB_F / RF))
lut_dequant_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                        const float* __restrict__ scale, float* __restrict__ y,
                        int B, int K, int F, int KB, int words_aligned, GridVals grid) {
  constexpr int CPB = 8 / BW;
  constexpr int MASK = (1 << BW) - 1;
  constexpr int NG = 1 << BW;
  constexpr int WORDS = KC / CPB / 4;           // 32-bit code words per row per chunk
  constexpr int CPW = 4 * CPB;                  // codes per word
  constexpr int TF_T = TB_F / RF;               // threads along F
  constexpr int TB_T = TB_B / RB;               // threads along B
  constexpr int THREADS = TF_T * TB_T;
  constexpr int X_ITERS = (TB_B * KC + THREADS - 1) / THREADS;
  constexpr int W_ITERS = (TB_F * WORDS + THREADS - 1) / THREADS;
  static_assert(KC % (4 * CPB) == 0, "a chunk holds whole 32-bit words of codes");

  __shared__ float gs[NG];
  __shared__ float xs[TB_B][KC + 1];            // +1: conflict-free column reads
  __shared__ float ws[TB_F][KC + 1];

  const int tid = threadIdx.x;
  const int tf = tid % TF_T;
  const int tb = tid / TF_T;
  const int b0 = blockIdx.y * TB_B;
  const int f0 = blockIdx.x * TB_F;

  for (int i = tid; i < NG; i += THREADS) gs[i] = grid.v[i];

  // A chunk's x and code words are loaded into registers one chunk ahead, so
  // their device-memory latency overlaps the previous chunk's arithmetic.
  float xr[X_ITERS];
  uint32_t wr[W_ITERS];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / KC, c = i % KC;
      const int b = b0 + r, k = k0 + c;
      xr[it] = (i < TB_B * KC && b < B && k < K) ? to_f32(x[(size_t)b * K + k]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / WORDS, c = i % WORDS;
      const int f = f0 + r, kb = k0 / CPB + 4 * c;
      uint32_t w = 0u;
      if (i < TB_F * WORDS && f < F && kb < KB) {
        const uint8_t* row = codes + (size_t)f * KB;
        if (words_aligned) {
          w = *reinterpret_cast<const uint32_t*>(row + kb);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kb + j < KB) w |= (uint32_t)row[kb + j] << (8 * j);
        }
      }
      wr[it] = w;
    }
  };

  float acc[RB][RF];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < RF; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                            // previous chunk's reads are done
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int i = tid + it * THREADS;
      if (i < TB_B * KC) xs[i / KC][i % KC] = xr[it];
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * THREADS;
      if (i < TB_F * WORDS) {
        const int r = i / WORDS, c = i % WORDS;
        const bool row_ok = f0 + r < F;
#pragma unroll
        for (int j = 0; j < CPW; ++j) {
          const int kk = c * CPW + j;
          // Codes past K (the packing pad) contribute nothing.
          ws[r][kk] = (row_ok && k0 + kk < K) ? gs[(wr[it] >> (j * BW)) & MASK] : 0.f;
        }
      }
    }
    __syncthreads();
    if (k0 + KC < K) load_chunk(k0 + KC);
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float xv[RB], wv[RF];
#pragma unroll
      for (int i = 0; i < RB; ++i) xv[i] = xs[tb + i * TB_T][kk];
#pragma unroll
      for (int j = 0; j < RF; ++j) wv[j] = ws[tf + j * TF_T][kk];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RF; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + tb + i * TB_T;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < RF; ++j) {
      const int f = f0 + tf + j * TF_T;
      if (f < F) y[(size_t)b * F + f] = acc[i][j] * scale[f];
    }
  }
}

template <int BW, typename T, int TB_B, int TB_F, int RB, int RF, int KC>
void launch_tile(const void* x, const void* codes, const void* scale, void* y, int B,
                 int K, int F, int KB, const GridVals& g, cudaStream_t stream) {
  constexpr int THREADS = (TB_B / RB) * (TB_F / RF);
  const dim3 grid_dim((F + TB_F - 1) / TB_F, (B + TB_B - 1) / TB_B);
  // Whole 32-bit loads need every row start 4-byte aligned.
  const int words_aligned =
      KB % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  lut_dequant_gemm_kernel<BW, T, TB_B, TB_F, RB, RF, KC>
      <<<grid_dim, THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const uint8_t*>(codes),
          static_cast<const float*>(scale), static_cast<float*>(y), B, K, F, KB,
          words_aligned, g);
}

// Decode tile: 4 rows x 32 columns, one output per thread, long K chunks.
// Prefill tile: 64 x 64, a 4 x 4 register tile per thread.
constexpr int SMALL_B = 4;

template <int BW, typename T>
void launch_bw(const void* x, const void* codes, const void* scale, void* y, int B,
               int K, int F, int KB, const GridVals& g, cudaStream_t stream) {
  if (B <= SMALL_B)
    launch_tile<BW, T, SMALL_B, 32, 1, 1, 256>(x, codes, scale, y, B, K, F, KB, g,
                                               stream);
  else
    launch_tile<BW, T, 64, 64, 4, 4, 64>(x, codes, scale, y, B, K, F, KB, g, stream);
}

template <typename T>
void launch_dtype(int bw, const void* x, const void* codes, const void* scale, void* y,
                  int B, int K, int F, int KB, const GridVals& g, cudaStream_t stream) {
  switch (bw) {
    case 1: launch_bw<1, T>(x, codes, scale, y, B, K, F, KB, g, stream); break;
    case 2: launch_bw<2, T>(x, codes, scale, y, B, K, F, KB, g, stream); break;
    case 4: launch_bw<4, T>(x, codes, scale, y, B, K, F, KB, g, stream); break;
    case 8: launch_bw<8, T>(x, codes, scale, y, B, K, F, KB, g, stream); break;
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else the launch's own status (cudaGetLastError right after it).
extern "C" int lut_dequant_gemm(const void* x, int x_is_bf16, const void* codes,
                                const void* scale, void* y, int B, int K, int F, int KB,
                                int bw, const float* grid, int n_grid, void* stream) {
  if (!(bw == 1 || bw == 2 || bw == 4 || bw == 8) || n_grid != (1 << bw) ||
      B <= 0 || K <= 0 || F <= 0 || KB != (K + 8 / bw - 1) / (8 / bw))
    return (int)cudaErrorInvalidValue;
  GridVals g;
  for (int i = 0; i < 256; ++i) g.v[i] = i < n_grid ? grid[i] : 0.f;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    launch_dtype<__nv_bfloat16>(bw, x, codes, scale, y, B, K, F, KB, g, s);
  else
    launch_dtype<float>(bw, x, codes, scale, y, B, K, F, KB, g, s);
  return (int)cudaGetLastError();
}
