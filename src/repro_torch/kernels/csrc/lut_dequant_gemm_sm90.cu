// Packed low-bit-code GEMM with in-register value-LUT decode on Hopper's tensor
// cores: bf16 activations, weights decoded to bf16 straight into wgmma's A
// registers, f32 accumulation, for sm_90a.
//
//   y[B, F] = (x[B, K] @ grid[codes][F, K]^T) * scale[F]      (f32 out)
//
// Replaces the TPU kernel src/repro/kernels/lut_dequant_gemm.py::lut_dequant_gemm
// (body _decode_kernel_body) for bf16 x and a grid whose values are all exact
// in bf16 (the int and uint grids at bw 1/2/4/8: integers of magnitude 255 or
// less).  Then every product x * grid[code] is exact in bf16 and the tensor
// cores' f32 sums compute the reference's function up to the order of the f32
// additions.  f32 x, the fp grid and K whose rows TMA cannot address stay on
// the CUDA-core kernel (lut_dequant_gemm.cu); the wrapper routes by dtype,
// grid and K (kernels/lut_dequant_gemm.py::route), never by B.  Codes are
// bw-bit, bit-packed little-endian within each uint8 byte, [F, ceil(K/cpb)]
// row-major, as the reference stores them.
//
// What bounds it on an H100: at prefill (B = batch x bucket, 512; gemma2-2b's
// forward, 8192) the 2*B*F*K operations at the 989 TFLOP/s bf16 tensor-core
// peak; at decode (B = 4) the F*K*bw/8 code bytes at 3.35 TB/s.  What the
// design does about each:
//
// * Swap-AB: y^T[F, B] = W[F, K] . x^T[K, B].  The decoded weights are the A
//   operand, 64 rows of F per consumer warpgroup, in registers; x is B,
//   K-major in shared memory (no transpose bit), N = 8, 64, 128 or 256 rows
//   of x per CTA (kernels/lut_dequant_gemm.py::tile_plan).  At prefill every
//   product is an m64nNk16 wgmma with N up to 256; nothing but the packed
//   codes and x is read from device memory.
// * A code is decoded by a table lookup in registers and shared memory, not
//   by the TPU's one-hot contraction: each consumer thread loads its two
//   rows' packed bytes of a stage (16-byte shared-memory loads), and for each
//   k16 step looks up the bf16 pair of two neighbouring codes (2*bw bits) in a
//   table of 2^(2 bw) bf16x2 entries (bw 1, 2, 4; 1 KB at bw 4; bw 8 looks up
//   each code in a 256-entry bf16 table) straight into the A fragment:
//   rows 16w + l/4 (+8), columns 2(l%4) (+1) (+8).  The decoded tile never
//   touches shared memory.
// * One producer warp keeps a ring of stages in flight by TMA: x boxes of
//   [N rows x 64 columns] with the 128-byte swizzle (as flash_attention_sm90's
//   K tiles) and the code box [128 rows x 16-64 bytes] unswizzled; TMA's zero
//   fill covers ragged B, ragged F and the K tail (x past K reads 0, so the
//   packing pad's codes add grid[c] * 0 = 0).  3 to 8 stages, as many as
//   200 KB of shared memory holds.  Each consumer warpgroup decodes chunk
//   c + 1 while chunk c's products run (two wgmma groups in flight).
// * Filling the card at decode: K is cut into S slices, S = min(n_sm /
//   F_tiles, 4, chunks / 8) and at least 1 (kernels/lut_dequant_gemm.py::
//   split_k), from F, K and the SM count only: a layer with few 128-row F
//   tiles (stablelm-12b's wk/wv: 10) gets 4.  Each slice's products
//   accumulate from zero; the slices' sums are added in the order
//   s = 0 .. S-1 into a running total that starts at -0 (-0 + x == x).
//   Where the output tiles alone would leave SMs idle (decode), each slice
//   runs on a CTA of its own, writes its sum to an f32 workspace, and the
//   last CTA of a tile to arrive (an int arrival counter, reset by that CTA)
//   adds the S sums in that order and applies the scale; elsewhere
//   (prefill) one CTA runs every slice and adds the sums in registers.  The
//   two do the same f32 operations, so the choice may follow B.  A split
//   layer runs with N <= 128 (the running total needs N / 2 registers more);
//   N = 256 serves S = 1 layers, whose y = acc * scale is the same bits as
//   -0 + acc.  No float atomics.
//
// One reduction order per row at every B (the serving contracts: per-row
// invariance, a kill + replay that re-buckets, scan == loop): the same
// kernel, K chunks of 64 (128 at bw 1) in order, the same k16 steps and the
// same S serve B = 1 and B = 8192; a row's k16 products and sums never mix
// with another row's.  N and the CTAs per tile change with B; a wgmma's
// columns are computed independently of its width, and the card tests and
// chip_smoke.py hold rows of B = 1 .. 8192 batches bit-equal.  No promotion
// of the accumulator inside a slice: over K = 13824 the tensor cores' f32
// sums stay far inside the kernel-vs-plain tolerance (1e-4 of max |y|;
// measured in chip_smoke.py phase 2).
//
// No branch that the compiler cannot prove warpgroup-uniform touches an
// accumulator (ptxas would serialize every wgmma: warning C7518): the stores
// are predicated, and S == 1 picks its destination and multiplier by select.
//
// Plain C interface for ctypes; the caller passes the stream and allocates y,
// the workspace and the (zeroed once) counters.  cuTensorMapEncodeTiled lives
// in libcuda.so.1 and is looked up there with dlsym, so no -lcuda is needed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NCWG = 2;                  // consumer warpgroups
constexpr int FM = 64 * NCWG;            // weight rows (F) per CTA
constexpr int THREADS = 128 * (NCWG + 1);
constexpr int SMEM_BUDGET = 200 * 1024;  // for the ring of stages
constexpr int MAX_SPLIT = 4;             // K slices at most

struct GridVals {
  float v[256];
};

template <int BW>
struct Shape {
  static constexpr int CPB = 8 / BW;
  static constexpr int KC = BW == 1 ? 128 : 64;   // K columns per stage (a TMA code row >= 16 B)
  static constexpr int KCB = KC / CPB;            // code bytes per row per stage
  static constexpr int KS = KC / 16;              // k16 steps per stage
  static constexpr int WORDS = KCB / 4;           // 32-bit code words per row per stage
  static constexpr int CB = FM * KCB;             // code bytes per stage
  static constexpr int TABLE = BW == 8 ? 2 * 256 : 4 << (2 * BW);   // decode table bytes
};

template <int BW, int N>
struct Cfg : Shape<BW> {
  static constexpr int XB = (Shape<BW>::KC / 64) * N * 128;   // x bytes per stage
  static constexpr int NST_FIT = SMEM_BUDGET / (XB + Shape<BW>::CB);
  static constexpr int NST = NST_FIT > 8 ? 8 : NST_FIT;
  static constexpr int SMEM = NST * (XB + Shape<BW>::CB) + Shape<BW>::TABLE + 16 * NST + 16 + 1024;
  static_assert(NST >= 3, "a ring of at least 3 stages");
};

struct Params {
  float* y;
  float* ws;             // [S, B, F] partials (P > 1)
  int* counters;         // one per output tile, zero between launches (P > 1)
  const float* scale;
  int B, F, nk, S;       // nk: K chunks of KC; S: K slices
  int P;                 // CTAs per output tile: 1 (every slice) or S (one each)
  int vec4;              // F % 4 == 0 and scale 16-byte aligned: float4 reduction
};

// The bf16 pair (low half: column c, high: c + 1) of the two codes at columns
// c = 16 kk + 8 half + 2q of a row whose stage codes are w (compile-time kk
// and half: the word index is a constant, q a shift).
template <int BW>
__device__ __forceinline__ uint32_t code_pair(const uint32_t (&w)[Shape<BW>::WORDS], int kk,
                                              int half, int q, const uint32_t* t2,
                                              const uint16_t* t1) {
  if constexpr (BW == 8) {
    const int base = 4 * kk + 2 * half;
    const uint32_t wv = (q & 2) ? w[base + 1] : w[base];
    const uint32_t hw = wv >> (16 * (q & 1));
    return (uint32_t)t1[hw & 0xFFu] | ((uint32_t)t1[(hw >> 8) & 0xFFu] << 16);
  } else {
    const int bit = (16 * kk + 8 * half) * BW;
    const uint32_t idx = (w[bit / 32] >> (bit % 32 + 2 * q * BW)) & ((1u << (2 * BW)) - 1u);
    return t2[idx];
  }
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 8) wgmma_rs_m64n8_kb(d, a, db);
  else if constexpr (N == 64) wgmma_rs_m64n64_kb(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128_kb(d, a, db);
  else wgmma_rs_m64n256_kb(d, a, db);
}

template <int BW, int N>
__global__ void __launch_bounds__(THREADS, 1)
lut_dequant_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tc, const Params P,
                             const GridVals g) {
  using C = Cfg<BW, N>;
  constexpr int KC = C::KC, KS = C::KS, WORDS = C::WORDS, NST = C::NST;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);   // swizzle atoms
  uint8_t* sx = smem;                                  // [NST][KC / 64][N][64] bf16, swizzled
  uint8_t* sc = sx + NST * C::XB;                      // [NST][FM][KCB] code bytes
  uint8_t* stab = sc + NST * C::CB;                    // decode table
  const uint32_t bars = smem_addr(stab + C::TABLE);    // full[NST], empty[NST]
  volatile int* last_flag = reinterpret_cast<volatile int*>(stab + C::TABLE + 16 * NST);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NST + st); };

  // This CTA's K slices: all S (P.P == 1), or slice sp alone (P.P == S).
  const int sp = blockIdx.x % P.P;
  const int ft = blockIdx.x / P.P;
  const int f0 = ft * FM, b0 = blockIdx.y * N;
  const int sl0 = P.P == 1 ? 0 : sp, sl1 = P.P == 1 ? P.S : sp + 1;
  auto slice_begin = [&](int sl) { return (int)((long long)sl * P.nk / P.S); };
  const int c_begin = slice_begin(sl0);
  const int nloc = slice_begin(sl1) - c_begin;   // >= 1: S <= nk

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NCWG * 128);
    }
    mbar_fence_init();
  }
  // The decode table: bf16 pairs of two codes (bw 1, 2, 4) or single codes (bw 8).
  if constexpr (BW == 8) {
    uint16_t* t1 = reinterpret_cast<uint16_t*>(stab);
    for (int i = tid; i < 256; i += THREADS) {
      const __nv_bfloat16 v = __float2bfloat16_rn(g.v[i]);
      t1[i] = *reinterpret_cast<const uint16_t*>(&v);
    }
  } else {
    uint32_t* t2 = reinterpret_cast<uint32_t*>(stab);
    for (int i = tid; i < (1 << (2 * BW)); i += THREADS) {
      __nv_bfloat162 v = __floats2bfloat162_rn(g.v[i & ((1 << BW) - 1)], g.v[i >> BW]);
      t2[i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NCWG) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (tid == NCWG * 128) {
      for (int i = 0; i < nloc; ++i) {
        const int st = i % NST;
        const uint32_t ph = (i / NST) & 1;
        const int k0 = (c_begin + i) * KC;
        mbar_wait(empty(st), ph ^ 1);
        mbar_arrive_expect_tx(full(st), C::XB + C::CB);
#pragma unroll
        for (int bx = 0; bx < KC / 64; ++bx)
          tma_load_2d(smem_addr(sx + st * C::XB + bx * N * 128), &tx, full(st), k0 + 64 * bx, b0);
        tma_load_2d(smem_addr(sc + st * C::CB), &tc, full(st), k0 / C::CPB, f0);
      }
    }
  } else {
    // ---- consumers: 64 weight rows each ----
    setmaxnreg_inc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32, q = lane % 4;
    const int rl = wg * 64 + warp * 16 + lane / 4;   // this thread's rows rl and rl + 8 of FM
    const uint32_t* t2 = reinterpret_cast<const uint32_t*>(stab);
    const uint16_t* t1 = reinterpret_cast<const uint16_t*>(stab);

    // Waits for chunk i's stage and decodes its codes into A fragments.
    auto decode = [&](uint32_t (&a)[KS][4], int i) {
      const int st = i % NST;
      mbar_wait(full(st), (i / NST) & 1);
      uint32_t w0[WORDS], w1[WORDS];
      const uint4* r0 = reinterpret_cast<const uint4*>(sc + st * C::CB + rl * C::KCB);
      const uint4* r1 = reinterpret_cast<const uint4*>(sc + st * C::CB + (rl + 8) * C::KCB);
#pragma unroll
      for (int v = 0; v < WORDS / 4; ++v) {
        const uint4 u0 = r0[v], u1 = r1[v];
        w0[4 * v] = u0.x; w0[4 * v + 1] = u0.y; w0[4 * v + 2] = u0.z; w0[4 * v + 3] = u0.w;
        w1[4 * v] = u1.x; w1[4 * v + 1] = u1.y; w1[4 * v + 2] = u1.z; w1[4 * v + 3] = u1.w;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        a[kk][0] = code_pair<BW>(w0, kk, 0, q, t2, t1);
        a[kk][1] = code_pair<BW>(w1, kk, 0, q, t2, t1);
        a[kk][2] = code_pair<BW>(w0, kk, 1, q, t2, t1);
        a[kk][3] = code_pair<BW>(w1, kk, 1, q, t2, t1);
      }
    };
    float acc[N / 2];
    // Issues chunk i's KS products on its x stage as one wgmma group.
    auto issue = [&](const uint32_t (&a)[KS][4], int i) {
      fence_regs(acc);
      wgmma_fence();
      const uint32_t xs = smem_addr(sx + (i % NST) * C::XB);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma<N>(acc, a[kk], desc_sw128(xs + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024));
      wgmma_commit();
    };
    auto fence_a = [&](uint32_t (&a)[KS][4]) {   // read by in-flight wgmmas until here
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) fence_regs(a[kk]);
    };

    // Each slice's products accumulate from zero in acc; the slices' sums
    // are added in order into total (from -0, so -0 + x == x for every x):
    // the same f32 operations whether a CTA runs every slice (P.P == 1) or the
    // last CTA of a tile adds the other CTAs' partials.  N == 256 serves
    // only S == 1 layers (no room for total): y = acc * scale, the same bits.
    constexpr bool SLICED = N < 256;
    float total[SLICED ? N / 2 : 1];
#pragma unroll
    for (int j = 0; j < (SLICED ? N / 2 : 1); ++j) total[j] = -0.f;
    uint32_t aA[KS][4], aB[KS][4];
    int i = 0;                                        // chunk counter: stage i % NST
    for (int sl = sl0; sl < sl1; ++sl) {
      const int n = slice_begin(sl + 1) - slice_begin(sl);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
      // Chunk c + 1 is decoded while chunk c's products run: two groups in
      // flight, wait<1> retires the older one and frees its stage and A.
      decode(aA, i);
      issue(aA, i);
      for (int c = 1;; c += 2) {
        if (c == n) {
          wgmma_wait<0>();
          fence_regs(acc);
          fence_a(aA);
          mbar_arrive(empty((i + c - 1) % NST));
          break;
        }
        decode(aB, i + c);
        issue(aB, i + c);
        wgmma_wait<1>();
        fence_a(aA);
        mbar_arrive(empty((i + c - 1) % NST));
        if (c + 1 == n) {
          wgmma_wait<0>();
          fence_regs(acc);
          fence_a(aB);
          mbar_arrive(empty((i + c) % NST));
          break;
        }
        decode(aA, i + c + 1);
        issue(aA, i + c + 1);
        wgmma_wait<1>();
        fence_a(aB);
        mbar_arrive(empty((i + c) % NST));
      }
      i += n;
      if constexpr (SLICED) {
#pragma unroll
        for (int j = 0; j < N / 2; ++j) total[j] += acc[j];
      }
    }

    // Epilogue: out[4j + e] is weight row rl (+8 for e >= 2), x row 8j + 2q + (e & 1).
    // P.P == 1: y = out * scale; else this slice's sum to the workspace.
    // Predicated stores and selects only: no branch touches the accumulators.
    const float* out = SLICED ? total : acc;
    const bool whole = P.P == 1;
    float* dst = whole ? P.y : P.ws + (size_t)sp * P.B * P.F;
    float mul[2];
    int fr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      fr[r] = f0 + rl + 8 * r;
      mul[r] = whole ? __ldg(P.scale + min(fr[r], P.F - 1)) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, b = b0 + 8 * j + 2 * q + (e & 1);
        float* p = dst + (size_t)min(b, P.B - 1) * P.F + min(fr[r], P.F - 1);
        st_global_b32_if(p, __float_as_uint(out[4 * j + e] * mul[r]), b < P.B && fr[r] < P.F);
      }
    }

    if (!whole) {
      // The last CTA of this tile to arrive adds the S partials in order.
      __threadfence();
      bar_sync(1, NCWG * 128);
      const int tile = blockIdx.y * (gridDim.x / P.P) + ft;
      if (tid == 0) *last_flag = atomicAdd(P.counters + tile, 1) == P.S - 1;
      bar_sync(1, NCWG * 128);
      if (*last_flag) {
        __threadfence();
        const size_t plane = (size_t)P.B * P.F;
        if (P.vec4) {
          // Whole float4s of a tile row (F % 4 == 0, 16-byte aligned scale): all
          // S partials of a float4 loaded before the ordered sum.
          constexpr int SLOTS = FM / 4;
#pragma unroll 4
          for (int e = tid; e < N * SLOTS; e += NCWG * 128) {
            const int b = b0 + e / SLOTS, f = f0 + 4 * (e % SLOTS);
            if (b < P.B && f < P.F) {
              const size_t o = (size_t)b * P.F + f;
              float4 v[MAX_SPLIT];
#pragma unroll
              for (int s2 = 0; s2 < MAX_SPLIT; ++s2)
                if (s2 < P.S) v[s2] = __ldcg(reinterpret_cast<const float4*>(P.ws + s2 * plane + o));
              float4 sum = make_float4(-0.f, -0.f, -0.f, -0.f);
#pragma unroll
              for (int s2 = 0; s2 < MAX_SPLIT; ++s2) {
                if (s2 < P.S) {
                  sum.x += v[s2].x; sum.y += v[s2].y; sum.z += v[s2].z; sum.w += v[s2].w;
                }
              }
              const float4 sc = __ldg(reinterpret_cast<const float4*>(P.scale + f));
              *reinterpret_cast<float4*>(P.y + o) =
                  make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
            }
          }
        } else {
          for (int e = tid; e < FM * N; e += NCWG * 128) {
            const int b = b0 + e / FM, f = f0 + e % FM;
            if (b < P.B && f < P.F) {
              const size_t o = (size_t)b * P.F + f;
              float sum = -0.f;
              for (int s2 = 0; s2 < P.S; ++s2) sum += __ldcg(P.ws + s2 * plane + o);
              P.y[o] = sum * __ldg(P.scale + f);
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
int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows, int cols,
             long long pitch, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
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

template <int BW, int N>
int launch(const void* x, const void* codes, const Params& P, int K, int KB, const GridVals& g,
           cudaStream_t stream) {
  using C = Cfg<BW, N>;
  CUtensorMap tx, tc;
  int r = make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, P.B, K, 2LL * K, N, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0)
    r = make_map(&tc, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, P.F, KB, KB, FM, C::KCB,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != 0) return r;
  auto kern = lut_dequant_gemm_sm90_kernel<BW, N>;
  static bool smem_set[64] = {};   // per device: set once, not at every launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  const dim3 grid(P.P * ((P.F + FM - 1) / FM), (P.B + N - 1) / N);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tx, tc, P, g);
  return (int)cudaGetLastError();
}

template <int BW>
int launch_bw(int N, const void* x, const void* codes, const Params& P, int K, int KB,
              const GridVals& g, cudaStream_t s) {
  switch (N) {
    case 8: return launch<BW, 8>(x, codes, P, K, KB, g, s);
    case 64: return launch<BW, 64>(x, codes, P, K, KB, g, s);
    case 128: return launch<BW, 128>(x, codes, P, K, KB, g, s);
    default: return launch<BW, 256>(x, codes, P, K, KB, g, s);
  }
}

}  // namespace

// bf16 x [B, K], codes [F, KB] uint8, scale [F] f32, y [B, F] f32.  N: x rows
// per CTA (8, 64, 128; 256 only for S == 1); S: K slices; P: CTAs per output
// tile, 1 or S; when P > 1, ws [S, B, F] f32 and counters (zero, one per
// output tile).  The wrapper's tile_plan chooses N, S and P.  Returns a
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not take,
// else the launch's own status), -1 when libcuda.so.1's cuTensorMapEncodeTiled
// is not found, or 10000 + the CUresult of a tensor map it refused.
extern "C" int lut_dequant_gemm_sm90(const void* x, const void* codes, const void* scale, void* y,
                                     void* ws, void* counters, int B, int K, int F, int KB,
                                     int bw, int N, int S, int P_ctas, const float* grid,
                                     int n_grid, void* stream) {
  const int kc = bw == 1 ? 128 : 64;
  const int nk = (K + kc - 1) / kc;
  if (!(bw == 1 || bw == 2 || bw == 4 || bw == 8) || n_grid != (1 << bw) || B <= 0 ||
      K <= 0 || F <= 0 || KB != (K + 8 / bw - 1) / (8 / bw) || K % 8 != 0 || KB % 16 != 0 ||
      !(N == 8 || N == 64 || N == 128 || N == 256) || S < 1 || S > nk || S > MAX_SPLIT ||
      (N == 256 && S != 1) || !(P_ctas == 1 || P_ctas == S) ||
      (P_ctas > 1 && (ws == nullptr || counters == nullptr)) || (B + N - 1) / N > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  GridVals g;
  for (int i = 0; i < 256; ++i) g.v[i] = i < n_grid ? grid[i] : 0.f;
  Params P;
  P.y = static_cast<float*>(y);
  P.ws = static_cast<float*>(ws);
  P.counters = static_cast<int*>(counters);
  P.scale = static_cast<const float*>(scale);
  P.B = B; P.F = F; P.nk = nk; P.S = S; P.P = P_ctas;
  P.vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bw) {
    case 1: return launch_bw<1>(N, x, codes, P, K, KB, g, s);
    case 2: return launch_bw<2>(N, x, codes, P, K, KB, g, s);
    case 4: return launch_bw<4>(N, x, codes, P, K, KB, g, s);
    default: return launch_bw<8>(N, x, codes, P, K, KB, g, s);
  }
}
