// Canonical-LUT slice-streaming GEMM for Hopper (sm_90a).
//
//   out[M, N] = sum_g canonical[reordering[wpacked[m, g], permid[g, n]], msrank[g, n]]
//
// (int32 accumulation; every operand int32, row-major).  Replaces the TPU
// kernel src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm (body
// _stream_kernel_body), the paper's §IV-C dataflow: per K-group g and
// activation column n, one canonical-LUT column (msrank) and one
// reordering-LUT column (permid) are streamed into a local buffer and reused
// by every weight row m.  Both the TPU version and this one fold the
// reordering lookup into the canonical gather once per streamed column pair,
//
//   composed[g][r][t] = canonical[reordering[r, permid[g, n0+t]], msrank[g, n0+t]],
//
// so each (m, g, t) costs a single lookup composed[g][wpacked[m, g]][t].
//
// What bounds it on an H100: at decode (N = the serve batch, 4) the M*G*4
// bytes of wpacked, read once (278 MB for one stablelm-12b layer at W1A3
// p=4, 83 us at 3.35 TB/s); at prefill (N up to 512) the M*G*N lookup-adds
// (35.6 G per layer).  This first version is simple and right:
//
// * A block owns TM = 256 weight rows (one per thread) x NT columns
//   (NT in 4, 8, 16; columns past N are masked) and a range of K-groups.
//   grid.x runs over column tiles, so the blocks that share a weight tile run
//   side by side and read it from L2 rather than HBM.
// * It walks its K-groups in chunks of gc: it loads the chunk's (permid,
//   msrank) pairs, stages the [TM, gc] tile of wpacked in shared memory with
//   coalesced loads (consecutive threads on consecutive g of one row: the
//   array is row-major [M, G], so a thread-per-row load would be strided by
//   G), composes the chunk's [gc, R, NT] table in shared memory (the LUTs
//   themselves are read through the read-only cache), and then every thread
//   adds composed[g][wpacked[m, g]][0..NT) into NT int32 registers with
//   16-byte shared loads.  The table's row stride is padded (NT + 4 for
//   NT = 8, 16) so that the 16-byte loads of 8 threads with different rows
//   fall into distinct banks.
// * At decode there are too few (M, N) tiles to fill 132 SMs, so the
//   K-groups are split across blocks (grid.z) and the partial sums meet in
//   int32 atomics on a zeroed output.  Integer addition is exact in any
//   order, so the bits are the same at every split and every N.
//
// No tensor cores, TMA or software pipelining yet.  The kernel trusts the
// index values (wpacked < R, permid < P, msrank < C, reordering < R): they
// come from the engine's own packing and canonicalization.
//
// Plain C interface for ctypes; the caller passes the stream and allocates out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 256;                 // weight rows per block = threads per block
constexpr int GC_MAX = 16;              // K-groups per shared-memory chunk, at most
constexpr int SMEM_BUDGET = 48 * 1024;  // static-launch limit: no opt-in attribute needed
constexpr int MIN_G_PER_BLOCK = 8;

__host__ __device__ constexpr int row_stride(int nt) { return nt % 8 == 0 ? nt + 4 : nt; }

// Shared bytes of one block: composed [gc][R][S] + (permid, msrank) [2][gc][NT]
// + the wpacked tile [TM][gc + 1].
inline size_t smem_bytes(int nt, int r, int gc) {
  return 4 * ((size_t)gc * r * row_stride(nt) + 2 * (size_t)gc * nt + (size_t)TM * (gc + 1));
}

template <int NT>
__global__ void __launch_bounds__(TM)
lut_stream_gemm_kernel(const int32_t* __restrict__ wpacked, const int32_t* __restrict__ msrank,
                       const int32_t* __restrict__ permid, const int32_t* __restrict__ canonical,
                       const int32_t* __restrict__ reordering, int32_t* __restrict__ out,
                       int M, int G, int N, int R, int C, int P, int gc, int g_per_block,
                       int atomic) {
  constexpr int S = row_stride(NT);
  extern __shared__ int4 smem[];                       // 16-byte aligned
  int32_t* composed = reinterpret_cast<int32_t*>(smem);   // [gc][R][S]
  int32_t* pid_s = composed + (size_t)gc * R * S;          // [gc][NT]
  int32_t* ms_s = pid_s + gc * NT;                         // [gc][NT]
  int32_t* ws = ms_s + gc * NT;                            // [TM][gc + 1]
  const int wstride = gc + 1;                              // odd: conflict-free column reads

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NT;
  const int m0 = blockIdx.y * TM;
  const int gb0 = blockIdx.z * g_per_block;
  const int gb1 = min(G, gb0 + g_per_block);
  const int m = m0 + tid;

  int acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0;

  for (int g0 = gb0; g0 < gb1; g0 += gc) {
    const int gn = min(gc, gb1 - g0);
    // 1. The chunk's column pairs (columns past N address pair 0; their sums
    //    are never stored) and its weight tile.
    for (int i = tid; i < gn * NT; i += TM) {
      const int gl = i / NT, n = n0 + i % NT;
      const size_t off = (size_t)(g0 + gl) * N + n;
      pid_s[i] = n < N ? permid[off] : 0;
      ms_s[i] = n < N ? msrank[off] : 0;
    }
    for (int i = tid; i < TM * gn; i += TM) {
      const int r = i / gn, gl = i % gn;
      ws[r * wstride + gl] = m0 + r < M ? wpacked[(size_t)(m0 + r) * G + g0 + gl] : 0;
    }
    __syncthreads();
    // 2. Compose: fold the reordering lookup into the canonical gather, once
    //    per (g, r, t) instead of once per (m, g, t).
    for (int i = tid; i < gn * R * NT; i += TM) {
      const int gl = i / (R * NT), rem = i % (R * NT), r = rem / NT, t = rem % NT;
      const int row = __ldg(reordering + (size_t)r * P + pid_s[gl * NT + t]);
      composed[((size_t)gl * R + r) * S + t] = __ldg(canonical + (size_t)row * C + ms_s[gl * NT + t]);
    }
    __syncthreads();
    // 3. Reuse: every weight row gathers from the composed table.
    if (m < M) {
      for (int gl = 0; gl < gn; ++gl) {
        const int w = ws[tid * wstride + gl];
        const int4* src = reinterpret_cast<const int4*>(composed + ((size_t)gl * R + w) * S);
#pragma unroll
        for (int q = 0; q < NT / 4; ++q) {
          const int4 v = src[q];
          acc[4 * q + 0] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
    }
    __syncthreads();                                   // the next chunk overwrites the tables
  }

  if (m < M) {
    int32_t* row = out + (size_t)m * N;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n = n0 + t;
      if (n < N) {
        if (atomic)
          atomicAdd(row + n, acc[t]);
        else
          row[n] = acc[t];
      }
    }
  }
}

template <int NT>
int launch(const int32_t* wpacked, const int32_t* msrank, const int32_t* permid,
           const int32_t* canonical, const int32_t* reordering, int32_t* out, int M, int G,
           int N, int R, int C, int P, cudaStream_t stream) {
  // K-groups per chunk: as many as the shared-memory budget holds, at most GC_MAX.
  int gc = GC_MAX;
  while (gc > 1 && smem_bytes(NT, R, gc) > SMEM_BUDGET) --gc;
  const size_t smem = smem_bytes(NT, R, gc);

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles_n = (N + NT - 1) / NT;
  const int tiles_m = (M + TM - 1) / TM;
  // Split K-groups across blocks until there are about four blocks per SM,
  // keeping at least MIN_G_PER_BLOCK groups in each.
  const long long tiles = (long long)tiles_n * tiles_m;
  const long long want = 4LL * sms;
  int split = tiles >= want ? 1 : (int)((want + tiles - 1) / tiles);
  split = max(1, min(split, (G + MIN_G_PER_BLOCK - 1) / MIN_G_PER_BLOCK));
  const int g_per_block = (G + split - 1) / split;
  split = (G + g_per_block - 1) / g_per_block;
  if (tiles_m > 65535 || split > 65535) return (int)cudaErrorInvalidValue;

  if (split > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(tiles_n, tiles_m, split);
  lut_stream_gemm_kernel<NT><<<grid, TM, smem, stream>>>(
      wpacked, msrank, permid, canonical, reordering, out, M, G, N, R, C, P, gc, g_per_block,
      split > 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else the launch's own status (cudaGetLastError right after it).
// ``nt`` (4, 8 or 16) is the column tile; it is halved while one K-group's
// composed table would not fit the shared-memory budget (large R).
extern "C" int lut_stream_gemm(const void* wpacked, const void* msrank, const void* permid,
                               const void* canonical, const void* reordering, void* out, int M,
                               int G, int N, int R, int C, int P, int nt, void* stream) {
  if (!(nt == 4 || nt == 8 || nt == 16)) return (int)cudaErrorInvalidValue;
  while (nt > 4 && smem_bytes(nt, R, 1) > SMEM_BUDGET) nt /= 2;
  if (M <= 0 || G <= 0 || N <= 0 || R <= 0 || C <= 0 || P <= 0 ||
      smem_bytes(nt, R, 1) > SMEM_BUDGET)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int32_t*>(wpacked);
  const auto* ms = static_cast<const int32_t*>(msrank);
  const auto* pid = static_cast<const int32_t*>(permid);
  const auto* cn = static_cast<const int32_t*>(canonical);
  const auto* ro = static_cast<const int32_t*>(reordering);
  auto* o = static_cast<int32_t*>(out);
  switch (nt) {
    case 4: return launch<4>(w, ms, pid, cn, ro, o, M, G, N, R, C, P, s);
    case 8: return launch<8>(w, ms, pid, cn, ro, o, M, G, N, R, C, P, s);
    default: return launch<16>(w, ms, pid, cn, ro, o, M, G, N, R, C, P, s);
  }
}
