// Canonical-LUT GEMM on Hopper's int8 tensor cores: a one-hot weight operand
// (u8, decoded in registers) times the composed LUT slices (s8), s32 sums, for
// sm_90a.
//
//   out[M, N] = onehot(wpacked)[M, G*R] . B[N, G*R]^T
//             = sum_g B[n, g*R + wpacked[m, g]]
//   B[n, g*R + r] = canonical[reordering[r, permid[g, n]], msrank[g, n]]
//
// Replaces the TPU kernel src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm
// (body _stream_kernel_body), which composes the streamed canonical and
// reordering columns per (g, n) and runs onehot(wpacked[:, g]) @ composed as
// an int32 MXU product.  This kernel runs the same product on the int8 tensor
// cores for packs whose canonical entries fit s8 (b_o == 1) and whose weight
// index has R = 2^(bw p) <= 32 values; every other pack stays on the CUDA-core
// kernel (lut_stream_gemm.cu).  The wrapper routes by the pack alone
// (kernels/lut_stream_gemm.py::route).  B is written by the canonicalize-and-
// compose kernel (lut_canon.cu): [N, ldb] s8 rows, K (= G*R) contiguous, the
// K-major layout int8 wgmma takes for both operands.  Integer sums are exact
// in any order, so the result is the plain version's bit for bit.
//
// What bounds it on an H100: at prefill (N = batch x bucket, 512) the
// 2*M*G*R*N one-hot operations at the 1979 TOP/s int8 tensor-core peak
// (R x the M*G*N lookups: 0.575 ms for one stablelm-12b layer at W1A3 p=4,
// R = 16); at decode (N = 4) the M*G*4 bytes of wpacked at 3.35 TB/s.  What
// the design does about each:
//
// * Swap-AB as in lut_dequant_gemm_sm90.cu: the weight rows are wgmma's A
//   operand, 64 rows per consumer warpgroup, decoded in registers; B (the
//   composed slices of N columns) is the K-major shared-memory operand,
//   N = 8, 64, 128 or 256 columns per CTA.  One k32 step covers 32 / R
//   K-groups.
// * The one-hot A fragment never touches memory: thread t (warp w, lane l)
//   owns rows 16w + l/4 (+8) and, in each k32 step, bytes 4(l%4) + {0..3}
//   (+16): one register is the four bytes (w - c0 == j), j = 0..3, of the
//   group whose columns c0 .. c0 + 3 they are (two groups per register at
//   R = 2).
// * The producer keeps a ring of stages in flight, each KC = 128 one-hot
//   columns (256 at decode, N = 8: fewer, longer steps for the latency-bound
//   chain): B by TMA, boxes of [N rows x 128 bytes] with the 128-byte
//   swizzle (zero fill past N and past G*R), and the stage's [128 rows x KC/R
//   groups] of wpacked by TMA where its row pitch 4G is a multiple of 16
//   bytes (every serve shape), else by 4-byte cp.async from all four producer
//   warps (zero fill past M and G either way).  A cp.async stage is released
//   one stage behind: each producer thread waits for its copies of the stage
//   (cp.async.wait_group 1) and then arrives on the stage's mbarrier, whose
//   release orders the words before the consumers' acquire.  TMA comes first because a stage is 1024 such 4-byte requests
//   at R = 16: issued by one warp, they hold the whole kernel back.  A
//   zero-filled group decodes as r = 0 and meets B's zero fill.  3 to 12 stages, as many as 200 KB of shared memory holds.  Each
//   consumer warpgroup decodes chunk c + 1 while chunk c's products run; at
//   R >= 16 a row's words of a stage are read with 16-byte loads.
// * Filling the card: the K chunks may be cut into S slices
//   (kernels/lut_stream_gemm.py::tc_split: at decode while the output tiles
//   alone would leave SMs idle; at prefill where fewer, shorter waves of
//   CTAs pay for the partial sums' traffic), one CTA each; each writes its
//   int32 sum to a workspace and the last CTA of a tile to arrive (an
//   arrival counter, reset by that CTA) adds the S sums.  Integer addition
//   is exact in any order.
//
// No branch that the compiler cannot prove warpgroup-uniform touches an
// accumulator (ptxas would serialize every wgmma: warning C7518): the stores
// are predicated and the split's destination chosen by select.
//
// Plain C interface for ctypes; the caller passes the stream and allocates
// out, the workspace and the (zeroed once) counters.  cuTensorMapEncodeTiled
// lives in libcuda.so.1 and is looked up there with dlsym.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NCWG = 2;                  // consumer warpgroups
constexpr int FM = 64 * NCWG;            // weight rows (M) per CTA
constexpr int THREADS = 128 * (NCWG + 1);
constexpr int SMEM_BUDGET = 200 * 1024;  // for the ring of stages
constexpr int MAX_SPLIT = 8;             // K slices at most
constexpr int PTHREADS = 128;            // producer threads (the cp.async path uses all)

__host__ __device__ constexpr int kc_of(int n) { return n == 8 ? 256 : 128; }

template <int R, int N>
struct Cfg {
  static constexpr int KC = kc_of(N);             // one-hot columns (bytes of a B row) per stage
  static constexpr int KS = KC / 32;              // k32 steps per stage
  static constexpr int GC = KC / R;               // K-groups per stage
  static constexpr int WB = FM * GC * 4;          // wpacked bytes per stage: [FM][GC] int32
  static constexpr int BB = N * KC;               // B bytes per stage: KC / 128 swizzled boxes
  static constexpr int NST_FIT = SMEM_BUDGET / (BB + WB);
  static constexpr int NST = NST_FIT > 12 ? 12 : NST_FIT;
  static constexpr int SMEM = NST * (BB + WB) + 16 * NST + 16 + 1024;
  static_assert(NST >= 3, "a ring of at least 3 stages");
};

struct Params {
  const int32_t* wp;     // [M, G] packed weight indices, values < R
  int32_t* out;          // [M, N]
  int32_t* ws;           // [S, M, N] partial sums (S > 1)
  int* counters;         // one per output tile, zero between launches (S > 1)
  int M, G, N, nk, S;    // nk: chunks of KC one-hot columns; S: K slices, one CTA each
  int tma_w;             // wpacked by TMA (4G % 16 == 0, 16-byte aligned), else by cp.async
};

__device__ __forceinline__ uint32_t hot4(int d) {
  return (uint32_t)d < 4u ? 1u << (8 * d) : 0u;
}

// The A register of one row: the four one-hot bytes of columns c0 .. c0 + 3
// of a stage, w the row's words (int32 group indices) of the stage.
template <int R>
__device__ __forceinline__ uint32_t onehot4(const int32_t* w, int c0) {
  if constexpr (R == 2) {
    const int g = c0 / 2;
    return (w[g] ? 0x100u : 0x1u) | ((w[g + 1] ? 0x100u : 0x1u) << 16);
  } else {
    return hot4(w[c0 / R] - c0 % R);
  }
}

template <int N>
__device__ __forceinline__ void mma(uint32_t (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 8) wgmma_rs_m64n8k32_u8s8(d, a, db);
  else if constexpr (N == 64) wgmma_rs_m64n64k32_u8s8(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128k32_u8s8(d, a, db);
  else wgmma_rs_m64n256k32_u8s8(d, a, db);
}

template <int R, int N>
__global__ void __launch_bounds__(THREADS, 1)
lut_stream_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tb,
                            const __grid_constant__ CUtensorMap tw, const Params P) {
  using C = Cfg<R, N>;
  constexpr int KC = C::KC, KS = C::KS, GC = C::GC, NST = C::NST;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);   // swizzle atoms
  uint8_t* sb = smem;                                    // [NST][KC / 128][N][128] s8, swizzled
  int32_t* sw = reinterpret_cast<int32_t*>(sb + NST * C::BB);        // [NST][FM][GC]
  const uint32_t bars = smem_addr(sb + NST * (C::BB + C::WB));       // full[NST], empty[NST]
  volatile int* last_flag = reinterpret_cast<volatile int*>(sb + NST * (C::BB + C::WB) + 16 * NST);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NST + st); };

  const int sp = blockIdx.x % P.S;                   // this CTA's K slice
  const int mt = blockIdx.x / P.S;
  const int m0 = mt * FM, n0 = blockIdx.y * N;
  const int c_begin = (int)((long long)sp * P.nk / P.S);
  const int nloc = (int)((long long)(sp + 1) * P.nk / P.S) - c_begin;   // >= 1: S <= nk

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      // TMA: one arrival (with the bytes); cp.async: each producer thread's
      // plain arrival once its copies have landed, and thread 0's for B's bytes.
      mbar_init(full(st), P.tma_w ? 1 : PTHREADS + 1);
      mbar_init(empty(st), NCWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NCWG) {
    // ---- producer: thread 0 issues the TMA boxes; every producer thread the
    // wpacked tile's cp.async where TMA cannot address wpacked ----
    setmaxnreg_dec<40>();
    const int pt = tid - NCWG * 128;
    if (pt == 0 || !P.tma_w) {
      for (int i = 0; i < nloc; ++i) {
        const int st = i % NST;
        const int c = c_begin + i;
        mbar_wait(empty(st), ((i / NST) & 1) ^ 1);
        if (pt == 0) {
          mbar_arrive_expect_tx(full(st), C::BB + (P.tma_w ? C::WB : 0));
#pragma unroll
          for (int bx = 0; bx < KC / 128; ++bx)
            tma_load_2d(smem_addr(sb + st * C::BB + bx * N * 128), &tb, full(st),
                        c * KC + 128 * bx, n0);
          if (P.tma_w) tma_load_2d(smem_addr(sw + st * FM * GC), &tw, full(st), c * GC, m0);
        }
        if (!P.tma_w) {
          const int g0 = c * GC;
          const uint32_t dst = smem_addr(sw + st * FM * GC);
#pragma unroll 4
          for (int e = pt; e < FM * GC; e += PTHREADS) {
            const int row = e / GC, gl = e % GC;
            const int m = m0 + row, g = g0 + gl;
            const bool ok = m < P.M && g < P.G;
            cp_async_4(dst + 4 * e, P.wp + (ok ? (size_t)m * P.G + g : 0), ok ? 4u : 0u);
          }
          // A stage's words are released once this thread's copies of it
          // have landed (wait_group, then an arrive with release semantics):
          // the previous stage's here, this one still in flight.
          cp_async_commit();
          if (i > 0) {
            cp_async_wait_group<1>();
            mbar_arrive(full((i - 1) % NST));
          }
        }
      }
      if (!P.tma_w) {
        cp_async_wait_group<0>();
        mbar_arrive(full((nloc - 1) % NST));
      }
    }
  } else {
    // ---- consumers: 64 weight rows each ----
    setmaxnreg_inc<232>();
    const int t = tid % 128, warp = t / 32, lane = t % 32, q = lane % 4;
    const int rl = wg * 64 + warp * 16 + lane / 4;   // this thread's rows rl and rl + 8 of FM

    // Waits for chunk i's stage and decodes its wpacked words into one-hot A fragments.
    auto decode = [&](uint32_t (&a)[KS][4], int i) {
      const int st = i % NST;
      mbar_wait(full(st), (i / NST) & 1);
      const int32_t* w0 = sw + st * FM * GC + rl * GC;
      const int32_t* w1 = w0 + 8 * GC;
      if constexpr (R >= 16) {
        // A register's four columns lie in group (32kk + 16h) / R, from r0 on.
        int32_t v0[GC], v1[GC];
#pragma unroll
        for (int j = 0; j < GC / 4; ++j) {
          const int4 x0 = reinterpret_cast<const int4*>(w0)[j];
          const int4 x1 = reinterpret_cast<const int4*>(w1)[j];
          v0[4 * j] = x0.x; v0[4 * j + 1] = x0.y; v0[4 * j + 2] = x0.z; v0[4 * j + 3] = x0.w;
          v1[4 * j] = x1.x; v1[4 * j + 1] = x1.y; v1[4 * j + 2] = x1.z; v1[4 * j + 3] = x1.w;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = 32 * kk + 16 * h, r0 = cc % R + 4 * q;
            a[kk][2 * h] = hot4(v0[cc / R] - r0);
            a[kk][2 * h + 1] = hot4(v1[cc / R] - r0);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c0 = 32 * kk + 16 * h + 4 * q;
            a[kk][2 * h] = onehot4<R>(w0, c0);
            a[kk][2 * h + 1] = onehot4<R>(w1, c0);
          }
        }
      }
    };
    uint32_t acc[N / 2];
    // Issues chunk i's KS products on its B stage as one wgmma group.
    auto issue = [&](const uint32_t (&a)[KS][4], int i) {
      fence_regs(acc);
      wgmma_fence();
      const uint32_t bs = smem_addr(sb + (i % NST) * C::BB);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma<N>(acc, a[kk], desc_sw128(bs + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024));
      wgmma_commit();
    };
    auto fence_a = [&](uint32_t (&a)[KS][4]) {   // read by in-flight wgmmas until here
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) fence_regs(a[kk]);
    };

#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0u;
    uint32_t aA[KS][4], aB[KS][4];
    // Chunk c + 1 is decoded while chunk c's products run: two groups in
    // flight, wait<1> retires the older one and frees its stage and A.
    decode(aA, 0);
    issue(aA, 0);
    for (int c = 1;; c += 2) {
      if (c == nloc) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_a(aA);
        mbar_arrive(empty((c - 1) % NST));
        break;
      }
      decode(aB, c);
      issue(aB, c);
      wgmma_wait<1>();
      fence_a(aA);
      mbar_arrive(empty((c - 1) % NST));
      if (c + 1 == nloc) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_a(aB);
        mbar_arrive(empty(c % NST));
        break;
      }
      decode(aA, c + 1);
      issue(aA, c + 1);
      wgmma_wait<1>();
      fence_a(aB);
      mbar_arrive(empty(c % NST));
    }

    // Epilogue: acc[4j + e] is weight row rl (+8 for e >= 2), column 8j + 2q + (e & 1).
    // S == 1: out; else this slice's sum to the workspace.  Predicated stores only.
    const bool whole = P.S == 1;
    int32_t* dst = whole ? P.out : P.ws + (size_t)sp * P.M * P.N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + rl + 8 * (e >> 1), n = n0 + 8 * j + 2 * q + (e & 1);
        int32_t* p = dst + (size_t)min(m, P.M - 1) * P.N + min(n, P.N - 1);
        st_global_b32_if(p, acc[4 * j + e], m < P.M && n < P.N);
      }
    }

    if (!whole) {
      // The last CTA of this tile to arrive adds the S partial sums.
      __threadfence();
      bar_sync(1, NCWG * 128);
      const int tile = blockIdx.y * (gridDim.x / P.S) + mt;
      if (tid == 0) *last_flag = atomicAdd(P.counters + tile, 1) == P.S - 1;
      bar_sync(1, NCWG * 128);
      if (*last_flag) {
        __threadfence();
        const size_t plane = (size_t)P.M * P.N;
        if (P.N % 4 == 0) {
          // Whole int4s of a tile row, all S partials of one loaded before the
          // sum: the loads of several rows in flight, not one L2 round trip each.
          constexpr int SLOTS = N / 4;
#pragma unroll 4
          for (int e = tid; e < FM * SLOTS; e += NCWG * 128) {
            const int m = m0 + e / SLOTS, n = n0 + 4 * (e % SLOTS);
            if (m < P.M && n < P.N) {
              const size_t o = (size_t)m * P.N + n;
              int4 v[MAX_SPLIT];
#pragma unroll
              for (int s2 = 0; s2 < MAX_SPLIT; ++s2)
                if (s2 < P.S) v[s2] = __ldcg(reinterpret_cast<const int4*>(P.ws + s2 * plane + o));
              int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
              for (int s2 = 0; s2 < MAX_SPLIT; ++s2) {
                if (s2 < P.S) {
                  sum.x += v[s2].x; sum.y += v[s2].y; sum.z += v[s2].z; sum.w += v[s2].w;
                }
              }
              *reinterpret_cast<int4*>(P.out + o) = sum;
            }
          }
        } else {
          for (int e = tid; e < FM * N; e += NCWG * 128) {
            const int m = m0 + e / N, n = n0 + e % N;
            if (m < P.M && n < P.N) {
              const size_t o = (size_t)m * P.N + n;
              int32_t sum = 0;
              for (int s2 = 0; s2 < P.S; ++s2) sum += __ldcg(P.ws + s2 * plane + o);
              P.out[o] = sum;
            }
          }
        }
        if (tid == 0) P.counters[tile] = 0;   // zero again for the next launch
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

// 2-D map over a row-major [rows, cols] array (row pitch `pitch` bytes), boxes
// of box_rows x box_cols, zero fill out of bounds.
int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long rows,
             long long cols, long long pitch, int box_rows, int box_cols,
             CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int R, int N>
int launch(const void* b, int ldb, const Params& P, cudaStream_t stream) {
  using C = Cfg<R, N>;
  // B: [N rows, G*R bytes], row pitch ldb, boxes of N rows x 128 bytes with the
  // 128-byte swizzle; wpacked: [M, G] int32, boxes of FM rows x GC groups
  // (when tma_w; else the map is not read).
  CUtensorMap tb, tw = {};
  int r = make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, P.N, (long long)P.G * R, ldb, N, 128,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0 && P.tma_w)
    r = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_INT32, P.wp, P.M, P.G, 4LL * P.G, FM, C::GC,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != 0) return r;
  auto kern = lut_stream_gemm_sm90_kernel<R, N>;
  static bool smem_set[64] = {};   // per device: set once, not at every launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  const dim3 grid(P.S * ((P.M + FM - 1) / FM), (P.N + N - 1) / N);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tb, tw, P);
  return (int)cudaGetLastError();
}

template <int R>
int launch_r(int n_tile, const void* b, int ldb, const Params& P, cudaStream_t s) {
  switch (n_tile) {
    case 8: return launch<R, 8>(b, ldb, P, s);
    case 64: return launch<R, 64>(b, ldb, P, s);
    case 128: return launch<R, 128>(b, ldb, P, s);
    default: return launch<R, 256>(b, ldb, P, s);
  }
}

}  // namespace

// wpacked [M, G] int32 (values < R), b [N, ldb] s8 (columns 0 .. G*R - 1 read),
// out [M, N] int32.  n_tile: B columns per CTA (8, 64, 128, 256); S: K slices,
// one CTA each; when S > 1, ws [S, M, N] int32 and counters (zero, one per
// output tile).  The wrapper's tc_split chooses n_tile and S.  Returns a
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not take,
// else the launch's own status), -1 when libcuda.so.1's cuTensorMapEncodeTiled
// is not found, or 10000 + the CUresult of a tensor map it refused.
extern "C" int lut_stream_gemm_sm90(const void* wpacked, const void* b, void* out, void* ws,
                                    void* counters, int M, int G, int N, int R, int ldb,
                                    int n_tile, int S, void* stream) {
  const long long kk = (long long)G * R;
  const int kc = kc_of(n_tile);
  const int nk = (int)((kk + kc - 1) / kc);
  if (!(R == 2 || R == 4 || R == 8 || R == 16 || R == 32) || M <= 0 || G <= 0 || N <= 0 ||
      kk >= (1LL << 31) || ldb < kk || ldb % 16 != 0 ||
      !(n_tile == 8 || n_tile == 64 || n_tile == 128 || n_tile == 256) || S < 1 || S > nk ||
      S > MAX_SPLIT || (S > 1 && (ws == nullptr || counters == nullptr)) ||
      (N + n_tile - 1) / n_tile > 65535 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpacked) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.wp = static_cast<const int32_t*>(wpacked);
  P.out = static_cast<int32_t*>(out);
  P.ws = static_cast<int32_t*>(ws);
  P.counters = static_cast<int*>(counters);
  P.M = M; P.G = G; P.N = N; P.nk = nk; P.S = S;
  P.tma_w = G % 4 == 0 && reinterpret_cast<uintptr_t>(wpacked) % 16 == 0;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: return launch_r<2>(n_tile, b, ldb, P, s);
    case 4: return launch_r<4>(n_tile, b, ldb, P, s);
    case 8: return launch_r<8>(n_tile, b, ldb, P, s);
    case 16: return launch_r<16>(n_tile, b, ldb, P, s);
    default: return launch_r<32>(n_tile, b, ldb, P, s);
  }
}
