// Canonical-LUT GEMM by lookups on Hopper (sm_90a): the composed LUT slices
// streamed through shared memory, for the packs with 32 < R <= 256.
//
//   out[M, N] = sum_g S[n / NT, g, wpacked[m, g], n % NT] - 128 G
//   S[t, g, r, c] = canonical[reordering[r, permid[g, n]], msrank[g, n]] + 128,   n = NT t + c
//
// Replaces the TPU kernel src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm
// (body _stream_kernel_body): per K-group g the canonical and reordering LUT
// columns addressed by an N tile are composed once into an [R, NT] slice and
// every weight row m reads the slice's row wpacked[m, g].  The slices come
// from the canonicalize-and-compose kernel (lut_canon.cu, modes 3 and 4),
// tiled for this kernel, [ceil(N/NT), G, R, NT] bytes, each entry stored as u8
// entry + 128: the GC groups of one stage of one column tile are one
// contiguous run of GC*R*NT bytes.  The sums are integers, exact in any order,
// so the result is the plain version's bit for bit.  The wrapper routes the
// integer packs with b_o == 1 and 32 < R <= 256 here by the pack alone
// (kernels/lut_stream_gemm.py::route: the p = 6-8 layers of a capacity plan at
// W1A3); R <= 32 runs on the int8 tensor cores (lut_stream_gemm_sm90.cu: a
// one-hot operand G*R columns wide, whose cost grows with R), and everything
// else on the CUDA-core kernel (lut_stream_gemm.cu).
//
// What bounds it on an H100: at decode (N = the serve batch) the M*G*4 bytes
// of wpacked (40.5 MB for one stablelm-12b w_up at p = 7, 12 us at 3.35 TB/s);
// at prefill the M*G*N lookup-adds (5.18e9 for w_up at p = 7 and N = 512,
// 0.077 ms at the 67 T/s of the CUDA cores' f32 rate).  In practice the int32
// lane rate and shared memory's bandwidth come first: a lookup is a 16-byte
// shared load at a random row (bank conflicts among the eight lanes of a
// phase), and each of its bytes costs about one integer operation.  What the
// design does about it:
//
// * A CTA owns TM = 1024 weight rows x NT columns (NT = 16 above N = 8, else 4
//   or 8), 4 rows a consumer thread, so each streamed slice serves 1024 rows.
//   The CTAs of one column tile run together, row tiles fastest, so the
//   tile's slices are read from L2 by all of them (the whole operand, 84 MB at
//   p = 8 and N = 512, does not fit the 50 MB L2; one column tile's does).
// * A ring of 3-4 stages in dynamic shared memory, each GC = 8 groups: the
//   stage's slices (GC*R*NT bytes, 32 KB at R = 256) by one 1-D bulk copy and
//   its [TM, GC] tile of wpacked by four 2-D TMA boxes of 256 rows where the
//   row pitch 4G is a multiple of 16 bytes, else by 8-byte (G even) or 4-byte
//   cp.async from the four producer warps (zero fill past M and G either way).
//   Stages hand over through full / empty mbarriers.  A cp.async stage is
//   released by each producer thread with cp.async.wait_group and a plain
//   arrive (release semantics), one stage behind: released by
//   cp.async.mbarrier.arrive.noinc, consumers at times read stale words of
//   wpacked (repeated calls differed at G = 854).
// * A consumer reads a row's GC words of wpacked with two 16-byte loads, then
//   per group one shared load of NT bytes, and adds the biased bytes as 16-bit
//   lanes: two byte permutes and (for two groups together) one three-input
//   add per 4 entries.  A lane holds at most 65535 = 255 x 257, so the lanes
//   are flushed into int32 every 256 groups; at the end 128 per group is
//   subtracted.  Unsigned lanes never borrow, so the sums are exact.
// * At decode there are too few (M, N) tiles for 132 SMs: the K-groups are
//   cut into S slices (kernels/lut_stream_gemm.py::lookup_split), one CTA
//   each, whose sums meet in int32 atomics on a zeroed output.
//
// Plain C interface for ctypes; the caller passes the stream and allocates
// out.  The kernel trusts the indices (wpacked < R).  cuTensorMapEncodeTiled
// lives in libcuda.so.1 and is looked up there with dlsym.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NCW = 8;                      // consumer warps
constexpr int RPT = 4;                      // weight rows per consumer thread
constexpr int CTHREADS = 32 * NCW;
constexpr int TM = CTHREADS * RPT;          // weight rows per CTA
constexpr int PTHREADS = 128;               // producer threads (the cp.async path uses all)
constexpr int THREADS = CTHREADS + PTHREADS;
constexpr int GC = 8;                       // K-groups per stage
constexpr int BOX_ROWS = 256;               // rows of one wpacked TMA box (TMA's limit)
constexpr int FLUSH_CHUNKS = 256 / GC;      // stages between flushes of the 16-bit lanes
constexpr int MAX_NST = 4;
constexpr int SMEM_BUDGET = 200 * 1024;     // for the ring of stages
constexpr int WB = TM * GC * 4;             // wpacked bytes per stage: [TM][GC] int32
constexpr int SMEM_MAX = SMEM_BUDGET + 128 + 16 * MAX_NST;

struct Params {
  const uint8_t* slices;   // [T, G, R, NT] entries + 128
  const int32_t* wp;       // [M, G] packed weight indices, values < R
  int32_t* out;            // [M, N]
  int M, G, N, R;
  int gps;                 // K-groups per slice of K (a multiple of GC)
  int nst;                 // ring stages
  int tma_w;               // wpacked by TMA (4G % 16 == 0, 16-byte aligned), else by cp.async
  int atomic;              // more than one K slice: add into a zeroed out
};

// Bytes 0 and 2 (columns 4q and 4q + 2) of a word as 16-bit lanes; bytes 1 and 3.
__device__ __forceinline__ uint32_t even_bytes(uint32_t x) { return __byte_perm(x, 0u, 0x4240); }
__device__ __forceinline__ uint32_t odd_bytes(uint32_t x) { return __byte_perm(x, 0u, 0x4341); }

template <int NT>
__device__ __forceinline__ void load_row(uint32_t (&x)[NT / 4], const uint8_t* p) {
  if constexpr (NT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (NT == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
lut_stream_gemm_lookup_kernel(const __grid_constant__ CUtensorMap tw, const Params P) {
  constexpr int NW = NT / 4;                             // 32-bit words of a slice row
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  const int sb = GC * P.R * NT;                          // slice bytes per stage
  uint8_t* ss = smem;                                    // [nst][GC][R][NT]
  int32_t* sw = reinterpret_cast<int32_t*>(smem + P.nst * sb);        // [nst][TM][GC]
  const uint32_t bars = smem_addr(smem + P.nst * (sb + WB));          // full[4], empty[4]
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (MAX_NST + st); };

  const int tiles_m = (P.M + TM - 1) / TM;
  const int mt = blockIdx.x % tiles_m, sp = blockIdx.x / tiles_m;    // row tiles fastest
  const int m0 = mt * TM, ct = blockIdx.y, n0 = ct * NT;
  const int g_begin = sp * P.gps, g_end = min(P.G, g_begin + P.gps);  // g_begin < G
  const int nloc = (g_end - g_begin + GC - 1) / GC;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < P.nst; ++st) {
      // TMA: one arrival (with the bytes); cp.async: each producer thread's
      // arrival once its copies have landed, and thread 0's for the slices' bytes.
      mbar_init(full(st), P.tma_w ? 1 : PTHREADS + 1);
      mbar_init(empty(st), CTHREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CTHREADS) {
    // ---- producer: thread 0 issues the bulk copy and the TMA boxes; every
    // producer thread the wpacked tile's cp.async where TMA cannot address it ----
    const int pt = tid - CTHREADS;
    if (pt == 0 || !P.tma_w) {
      const uint8_t* src = P.slices + ((size_t)ct * P.G + g_begin) * P.R * NT;
      int st = 0, ph = 0;
      for (int i = 0; i < nloc; ++i) {
        const int g0 = g_begin + i * GC, gn = min(GC, g_end - g0);
        mbar_wait(empty(st), ph ^ 1);
        if (pt == 0) {
          const uint32_t bytes = (uint32_t)(gn * P.R * NT);
          mbar_arrive_expect_tx(full(st), bytes + (P.tma_w ? WB : 0));
          bulk_load_1d(smem_addr(ss + st * sb), src + (size_t)i * sb, bytes, full(st));
          if (P.tma_w) {
#pragma unroll
            for (int b = 0; b < TM / BOX_ROWS; ++b)
              tma_load_2d(smem_addr(sw + (st * TM + b * BOX_ROWS) * GC), &tw, full(st), g0,
                          m0 + b * BOX_ROWS);
          }
        }
        if (!P.tma_w) {
          // Each thread keeps one column of the tile (words gl .. gl + W/4 - 1
          // of a row, W = 8 or 4 bytes) and walks down the rows, THREADS_ROW
          // rows apart: one address add per copy.  The W-byte words of eight
          // or four neighbouring threads make one row's 32 bytes.
          const uint32_t dst = smem_addr(sw + st * TM * GC);
          if (P.G % 2 == 0) {
            // Pairs of groups: 8-byte aligned, since G and g0 are even.
            constexpr int PER_ROW = GC / 2, ROWS = PTHREADS / PER_ROW;
            const int gl = 2 * (pt % PER_ROW), r = pt / PER_ROW;
            const uint32_t bytes = g0 + gl < P.G ? 8u : 0u;
            const int32_t* src = P.wp + (size_t)(m0 + r) * P.G + g0 + gl;
#pragma unroll 8
            for (int row = r; row < TM; row += ROWS, src += (size_t)ROWS * P.G)
              cp_async_8(dst + 4 * (row * GC + gl), src, m0 + row < P.M ? bytes : 0u);
          } else {
            constexpr int ROWS = PTHREADS / GC;
            const int gl = pt % GC, r = pt / GC;
            const uint32_t bytes = g0 + gl < P.G ? 4u : 0u;
            const int32_t* src = P.wp + (size_t)(m0 + r) * P.G + g0 + gl;
#pragma unroll 8
            for (int row = r; row < TM; row += ROWS, src += (size_t)ROWS * P.G)
              cp_async_4(dst + 4 * (row * GC + gl), src, m0 + row < P.M ? bytes : 0u);
          }
          // A stage's words are released once this thread's copies of it
          // have landed (wait_group, then an arrive with release semantics):
          // the previous stage's here, this one still in flight.
          cp_async_commit();
          if (i > 0) {
            cp_async_wait_group<1>();
            mbar_arrive(full(st == 0 ? P.nst - 1 : st - 1));
          }
        }
        if (++st == P.nst) { st = 0; ph ^= 1; }
      }
      if (!P.tma_w) {
        cp_async_wait_group<0>();
        mbar_arrive(full(st == 0 ? P.nst - 1 : st - 1));
      }
    }
  } else {
    // ---- consumers: rows rl + 256 rr of the tile, rr < RPT ----
    const int rl = tid;
    uint32_t pk[RPT][NT / 2];              // 16-bit lanes: [2q] columns 4q, 4q+2; [2q+1] 4q+1, 4q+3
    int acc[RPT][NT];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) pk[rr][j] = 0u;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[rr][t] = 0;
    }
    auto flush = [&]() {
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          acc[rr][4 * q] += (int)(pk[rr][2 * q] & 0xffffu);
          acc[rr][4 * q + 2] += (int)(pk[rr][2 * q] >> 16);
          acc[rr][4 * q + 1] += (int)(pk[rr][2 * q + 1] & 0xffffu);
          acc[rr][4 * q + 3] += (int)(pk[rr][2 * q + 1] >> 16);
          pk[rr][2 * q] = pk[rr][2 * q + 1] = 0u;
        }
      }
    };
    const int rstride = P.R * NT;          // bytes between the slices of two groups
    int st = 0, ph = 0;
    for (int i = 0; i < nloc; ++i) {
      const int gn = min(GC, g_end - (g_begin + i * GC));   // groups of this stage (uniform)
      mbar_wait(full(st), ph);
      const uint8_t* sl = ss + st * sb;
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const int4* wq = reinterpret_cast<const int4*>(sw + (st * TM + rl + CTHREADS * rr) * GC);
        const int4 wa = wq[0], wb = wq[1];
        const int w[GC] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int gl = 0; gl < GC; gl += 2) {
          uint32_t x0[NW], x1[NW];
          if (gl < gn) {
            load_row<NT>(x0, sl + gl * rstride + w[gl] * NT);
          } else {
#pragma unroll
            for (int q = 0; q < NW; ++q) x0[q] = 0u;
          }
          if (gl + 1 < gn) {
            load_row<NT>(x1, sl + (gl + 1) * rstride + w[gl + 1] * NT);
          } else {
#pragma unroll
            for (int q = 0; q < NW; ++q) x1[q] = 0u;
          }
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            pk[rr][2 * q] += even_bytes(x0[q]) + even_bytes(x1[q]);
            pk[rr][2 * q + 1] += odd_bytes(x0[q]) + odd_bytes(x1[q]);
          }
        }
      }
      mbar_arrive(empty(st));           // each thread once its own reads of the stage are done
      if ((i + 1) % FLUSH_CHUNKS == 0) flush();
      if (++st == P.nst) { st = 0; ph ^= 1; }
    }
    flush();

    // Epilogue: 128 per group of this slice of K comes off every sum.
    const int bias = 128 * (g_end - g_begin);
    const bool vec = !P.atomic && P.N % 4 == 0 && n0 + NT <= P.N;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int m = m0 + rl + CTHREADS * rr;
      if (m >= P.M) continue;
      int32_t* row = P.out + (size_t)m * P.N + n0;
      if (vec) {
#pragma unroll
        for (int q = 0; q < NW; ++q)
          reinterpret_cast<int4*>(row)[q] =
              make_int4(acc[rr][4 * q] - bias, acc[rr][4 * q + 1] - bias,
                        acc[rr][4 * q + 2] - bias, acc[rr][4 * q + 3] - bias);
      } else {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (n0 + t < P.N) {
            if (P.atomic)
              atomicAdd(row + t, acc[rr][t] - bias);
            else
              row[t] = acc[rr][t] - bias;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 2-D map over wpacked, a row-major [M, G] int32 array: boxes of BOX_ROWS rows
// x GC groups, zero fill out of bounds.
int make_wpacked_map(CUtensorMap* map, const int32_t* wp, int M, int G) {
  const cuuint64_t dims[2] = {(cuuint64_t)G, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)G * 4};
  const cuuint32_t box[2] = {(cuuint32_t)GC, (cuuint32_t)BOX_ROWS};
  const cuuint32_t estr[2] = {1, 1};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int32_t*>(wp), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int NT>
int launch(const Params& P, int S, cudaStream_t stream) {
  CUtensorMap tw = {};
  if (P.tma_w) {
    const int r = make_wpacked_map(&tw, P.wp, P.M, P.G);
    if (r != 0) return r;
  }
  auto kern = lut_stream_gemm_lookup_kernel<NT>;
  static bool smem_set[64] = {};   // per device: set once, not at every launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  if (P.atomic) {
    err = cudaMemsetAsync(P.out, 0, (size_t)P.M * P.N * sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = 128 + (size_t)P.nst * (GC * P.R * NT + WB) + 16 * MAX_NST;
  const dim3 grid(S * ((P.M + TM - 1) / TM), (P.N + NT - 1) / NT);
  kern<<<grid, THREADS, smem, stream>>>(tw, P);
  return (int)cudaGetLastError();
}

}  // namespace

// wpacked [M, G] int32 (values < R), slices [ceil(N/nt), G, R, nt] u8 (entries
// + 128, from lut_canon modes 3 / 4), out [M, N] int32.  nt: the column tile
// (4 at N <= 4, 8 at N <= 8, else 16, as the slices were composed); S: K
// slices, one CTA each (kernels/lut_stream_gemm.py::lookup_split), summed in
// int32 atomics on out, which is zeroed first.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take, else the
// launch's own status), -1 when libcuda.so.1's cuTensorMapEncodeTiled is not
// found, or 10000 + the CUresult of a tensor map it refused.
extern "C" int lut_stream_lookup_sm90(const void* wpacked, const void* slices, void* out, int M,
                                      int G, int N, int R, int nt, int S, void* stream) {
  const int want_nt = N <= 4 ? 4 : N <= 8 ? 8 : 16;
  if (M <= 0 || G <= 0 || N <= 0 || !(R == 64 || R == 128 || R == 256) || nt != want_nt ||
      S < 1 || wpacked == nullptr || slices == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(slices) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpacked) % 4 != 0 || (N + nt - 1) / nt > 65535 ||
      (long long)S * ((M + TM - 1) / TM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int chunks = (G + GC - 1) / GC;
  const int per = (chunks + S - 1) / S;          // stages per K slice
  Params P;
  P.slices = static_cast<const uint8_t*>(slices);
  P.wp = static_cast<const int32_t*>(wpacked);
  P.out = static_cast<int32_t*>(out);
  P.M = M; P.G = G; P.N = N; P.R = R;
  P.gps = per * GC;
  if ((long long)(S - 1) * P.gps >= G) return (int)cudaErrorInvalidValue;   // an empty slice
  const int stage = GC * R * nt + WB;
  P.nst = SMEM_BUDGET / stage < MAX_NST ? SMEM_BUDGET / stage : MAX_NST;
  P.tma_w = G % 4 == 0 && reinterpret_cast<uintptr_t>(wpacked) % 16 == 0;
  P.atomic = S > 1;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 4: return launch<4>(P, S, s);
    case 8: return launch<8>(P, S, s);
    default: return launch<16>(P, S, s);
  }
}
