// Online-softmax (flash) attention on Hopper's tensor cores: bf16 q, k, v,
// f32 softmax and accumulation, GQA, causal and sliding-window masks and a
// logit softcap, for sm_90a.
//
//   out[b, s, h, :] = softmax_t(mask(cap * tanh(q[b,s,h,:] . k[b,t,h/rep,:] * scale / cap)))
//                     @ v[b, :, h/rep, :]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_body) for bf16 inputs with head dim 64, 128 or 256.  It
// computes the same function with the same update per key block:
//
//   m' = max(m, rowmax s)            p = where(mask, exp(s - m'), 0)
//   l' = l * e^{m - m'} + rowsum p   acc' = acc * e^{m - m'} + p @ V
//   out = acc / max(l, 1e-30)
//
// with s = q.k * scale, then the softcap, then masked scores set to -1e30.
// Other head dims (16, 32, 96, 160) and f32 inputs stay on the CUDA-core
// kernel (flash_attention.cu); the wrapper routes by dtype and head dim.
//
// What bounds it on an H100: 4 * hd operations per visible (query, key) pair
// and head (the two products) at the 989 TFLOP/s bf16 tensor-core peak; its
// bytes (q, k, v read once, out written once) are two orders below that at
// gemma2-2b's S = 8192.  What the design does about it:
//
// * Both products run on the tensor cores as wgmma, f32 accumulation.
//   S = Q K^T: m64n64k16 with Q and K from shared memory (both K-major: hd is
//   contiguous).  O += P V: m64n{hd}k16 with P from registers -- the S
//   accumulator fragment, rounded to bf16 and packed in pairs, is the
//   A-register fragment of the next product -- and V from shared memory,
//   MN-major (hd contiguous) through the transpose bit.
// * One CTA owns 128 query rows of one (b, h): two consumer warpgroups of 64
//   rows each, O in their wgmma accumulator registers (hd / 2 f32 a thread),
//   m and l in registers; one producer warp issues the TMA loads.
//   setmaxnreg gives the consumers 240 registers and the producer 24.
// * K and V arrive by TMA (4-D tensor maps over the [B, T, Hkv, hd] views
//   with their real strides, 128-byte swizzle, boxes of 64 keys x 64
//   columns; a head of 256 is four boxes, and the wgmma descriptors step
//   across them) into a ring of 3 stages (2 at hd 256), full and empty
//   mbarriers per stage, so the next block's copy overlaps this block's math.
//   Q arrives once the same way.  TMA's zero fill covers the ragged S and T
//   tails: no padding copies, no transposes.
// * The softmax hides behind the products twice over: each warpgroup issues
//   S_i = Q K_i^T together with block i-1's P V and runs block i's softmax
//   while P V runs, and the two warpgroups take turns to issue (named
//   barriers), so one's softmax runs under the other's products.
// * No branch that the compiler cannot prove uniform over a warpgroup
//   touches an accumulator: the first block is peeled, the masks are
//   per-row key bounds applied by selects, the softcap is a template
//   parameter and rows past S are dropped by predicated stores.  Otherwise
//   ptxas makes every wgmma wait for the one before (warning C7518).
// * Key blocks wholly past the causal edge or wholly outside the window are
//   not loaded (the masks cost a compare and a select per score in the
//   blocks that are).  Query blocks are issued longest first.
// * Deterministic: no split over keys, no atomics; one CTA writes each
//   output tile, so the same inputs give the same bits.
//
// What it rounds that the reference does not: P is rounded to bf16 before
// P @ V (as the TPU's MXU does at default precision, and FA2/FA3 do); the
// row sums l are taken over the unrounded f32 P.  Approximate intrinsics:
// exp as ex2.approx.ftz.f32 with log2(e) folded into the scale (relative
// error about 2^-22), and the softcap's tanh written as
// 1 - 2 / (1 + e^{2u}) with ex2.approx and rcp.approx.ftz.f32 (absolute
// error about cap x 2^-21 on the capped score); not tanh.approx.f32, whose
// 2^-11 relative error would reach 0.02 on a score near the cap of 50.
//
// Plain C interface for ctypes; the caller passes the stream and allocates
// out.  cuTensorMapEncodeTiled lives in libcuda.so.1, not in the CUDA
// runtime: it is looked up there with dlsym, so no -lcuda is needed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NCWG = 2;                  // consumer warpgroups
constexpr int BQ = 64 * NCWG;            // query rows per CTA
constexpr int BK = 64;                   // keys per key block
constexpr int THREADS = 128 * (NCWG + 1);
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int NCHUNK = HD / 64;             // 128-byte column boxes of a row
  static constexpr int NST = HD == 256 ? 2 : 3;      // K/V ring stages
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;       // one stage of K (or of V)
  static constexpr int NBAR = 1 + 4 * NST;           // q_full; k/v full; k/v empty
  static constexpr int SMEM = Q_BYTES + 2 * NST * KV_BYTES + 8 * NBAR + 1024;
};

struct Params {
  int S, T, H, Hkv;
  long long o_b, o_s, o_h;               // output strides, elements
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// S = Q K^T for one warpgroup's 64 rows: hd / 16 steps of 16 -- box kk / 4,
// 32 bytes a step within its 128-byte rows (both operands K-major).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_m64n64(s, desc_sw128(qa + (kk / 4) * BQ * 128 + off, 16, 1024),
                    desc_sw128(kb + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
  }
}

// O += P V: BK / 16 steps of 16 keys; V is MN-major (hd contiguous), 16 rows
// a step, its 64-column boxes BK * 128 bytes apart.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[4][4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc_sw128(vb + kk * 16 * 128, BK * 128, 1024);
    if constexpr (HD == 64) wgmma_rs_m64n64(o, pa[kk], dv);
    else if constexpr (HD == 128) wgmma_rs_m64n128(o, pa[kk], dv);
    else wgmma_rs_m64n256(o, pa[kk], dv);
  }
}

// One key block's online-softmax step on this thread's scores: rows r = 0, 1
// (row0 and row0 + 8), keys kpos0 + 8j + {0, 1}.  A key is visible to row r
// iff lo[r] < kpos < hi[r].  On return s holds p = where(mask, 2^(y - m'), 0)
// in f32, m the new running max (log2 units), l the running partial sum
// rescaled and increased by this thread's p, and alpha = 2^(m - m') per row.
// No branch touches s: a branch that the compiler cannot prove uniform over
// the warpgroup makes it serialize every wgmma of the kernel.
template <bool CAP>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kpos0, const int (&lo)[2],
                                             const int (&hi)[2], float C1, float C2, float A,
                                             float B2) {
  // Scores in log2 units, y = s * log2(e), so that p = 2^(y - m).  Softcap:
  // s = cap * tanh(x / cap) with x = q.k * scale, written as
  // cap - 2 cap / (1 + e^(2x / cap)), so y = A - B2 / (1 + 2^(x * C2)).
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kpos = kpos0 + 8 * j + (e & 1);
      float y = CAP ? A - B2 * rcp_approx(1.f + ex2_approx(s[4 * j + e] * C2))
                    : s[4 * j + e] * C1;
      y = kpos > lo[r] && kpos < hi[r] ? y : NEG_INF;
      s[4 * j + e] = y;
      mx[r] = fmaxf(mx[r], y);
    }
  }
  float mu[2];   // the max subtracted: 0 while a row has seen no visible key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    mu[r] = m_new == NEG_INF ? 0.f : m_new;
    alpha[r] = ex2_approx(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  // A masked y is -1e30: 2^(y - mu) flushes to exactly 0.  Summed in f32
  // over the unrounded p.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_approx(s[4 * j + e] - mu[e >> 1]);
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// P rounded to bf16 pairs in the A-register fragment of m64k16: for key step
// kk, pa[kk][0] = (row, 16kk + col0 + {0,1}), [1] = row + 8, [2] and [3] the
// same at 16kk + 8 -- the accumulator blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(s[4 * j + 0], s[4 * j + 1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(s[4 * j + 2], s[4 * j + 3]);
    pa[j / 2][(j % 2) * 2 + 0] = *reinterpret_cast<uint32_t*>(&lo);
    pa[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<uint32_t*>(&hi);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

__device__ __forceinline__ void fence_pa(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, const Params P) {
  using C = Cfg<HD>;
  constexpr int ND = HD / 2;             // O accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t sq = base;                                       // [NCHUNK][BQ][64]
  const uint32_t sk = sq + C::Q_BYTES;                            // [NST][NCHUNK][BK][64]
  const uint32_t sv = sk + C::NST * C::KV_BYTES;                  // [NST][NCHUNK][BK][64]
  const uint32_t bars = sv + C::NST * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + C::NST + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * C::NST + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * C::NST + st); };

  const int bh = blockIdx.x;
  const int b = bh / P.H, h = bh - b * P.H;
  const int hk = h / (P.H / P.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest (latest) query blocks first

  // Key blocks that can hold a visible key for some row of this query block.
  const int q_last = min(q0 + BQ, P.S) - 1;
  int k_begin = 0, k_end = P.T;
  if (P.causal) k_end = min(k_end, q_last + 1);
  if (P.has_window) k_begin = max(0, q0 - P.window + 1);
  k_begin = k_begin / BK * BK;
  // At least one block, so that no branch skips the products: where no key
  // is visible (possible only with a window and T < S) the block is wholly
  // masked (TMA fills a box past T with zeros) and the rows get 0.
  const int nblk = max(1, (k_end - k_begin + BK - 1) / BK);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::NST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), NCWG * 128);
      mbar_init(v_empty(st), NCWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NCWG) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (tid == NCWG * 128) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCHUNK; ++c)
        tma_load_4d(sq + c * BQ * 128, &tq, q_full, c * 64, q0, h, b);
      for (int i = 0; i < nblk; ++i) {
        const int st = i % C::NST;
        const uint32_t ph = (i / C::NST) & 1;
        const int k0 = k_begin + i * BK;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load_4d(sk + st * C::KV_BYTES + c * BK * 128, &tk, k_full(st), c * 64, k0, hk, b);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load_4d(sv + st * C::KV_BYTES + c * BK * 128, &tv, v_full(st), c * 64, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int q0w = q0 + wg * 64;                     // this warpgroup's first row
    const int row0 = q0w + warp * 16 + lane / 4;      // rows row0 and row0 + 8
    const int col0 = 2 * (lane % 4);                  // column of d[4j] within block j
    const uint32_t qa = sq + wg * 64 * 128;
    const float C1 = P.scale * LOG2E;                 // see softmax_step
    const float C2 = CAP ? 2.f * P.scale * LOG2E / P.softcap : 0.f;
    const float A = P.softcap * LOG2E, B2 = 2.f * P.softcap * LOG2E;
    // Row r sees the keys lo[r] < kpos < hi[r]: causal kpos <= qpos, window
    // kpos > qpos - window, and the ragged tail kpos < T.
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      hi[r] = P.causal ? min(P.T, qpos + 1) : P.T;
      lo[r] = P.has_window ? qpos - P.window : -1;
    }

    float o[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    uint32_t pa[4][4];                                // bf16 P of the block before
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

    // Iteration i issues S_i = Q K_i^T and block i-1's O += P V together,
    // then runs block i's softmax while P V runs on the tensor cores.  The
    // two warpgroups take turns to issue (named barriers 1 and 2), so one
    // runs its softmax while the other's products run: warpgroup 0 first,
    // nblk + 1 turns each (the last issues the last P V).  No branch touches
    // the products' registers, so they pipeline.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) bar_arrive(1, 2 * 128);
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    fence_regs(s);
    bar_sync(my_turn, 2 * 128);
    wgmma_fence();
    issue_qk<HD>(s, qa, sk);
    wgmma_commit();
    bar_arrive(their_turn, 2 * 128);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty(0));
    softmax_step<CAP>(s, m, l, alpha, k_begin + col0, lo, hi, C1, C2, A, B2);
    pack_p(s, pa);
    for (int i = 1; i < nblk; ++i) {
      const int st = i % C::NST, pst = (i - 1) % C::NST;
      mbar_wait(k_full(st), (i / C::NST) & 1);
      mbar_wait(v_full(pst), ((i - 1) / C::NST) & 1);
      fence_regs(s);
      fence_regs(o);
      fence_pa(pa);
      bar_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_qk<HD>(s, qa, sk + st * C::KV_BYTES);
      wgmma_commit();
      issue_pv<HD>(o, pa, sv + pst * C::KV_BYTES);
      wgmma_commit();
      bar_arrive(their_turn, 2 * 128);
      wgmma_wait<1>();                 // S_i done; P V may still run
      fence_regs(s);
      mbar_arrive(k_empty(st));
      softmax_step<CAP>(s, m, l, alpha, k_begin + i * BK + col0, lo, hi, C1, C2, A, B2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_pa(pa);
      mbar_arrive(v_empty(pst));
      rescale(o, alpha);
      pack_p(s, pa);
    }
    const int lst = (nblk - 1) % C::NST;
    mbar_wait(v_full(lst), ((nblk - 1) / C::NST) & 1);
    fence_regs(o);
    fence_pa(pa);
    bar_sync(my_turn, 2 * 128);
    wgmma_fence();
    issue_pv<HD>(o, pa, sv + lst * C::KV_BYTES);
    wgmma_commit();
    if (wg == 0) bar_arrive(their_turn, 2 * 128);   // warpgroup 1's last turn is the last
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty(lst));

    // out = O / max(l, 1e-30), l summed over the four lanes of each row;
    // rows past S are not stored (a predicated store, no branch).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + b * P.o_b + (long long)min(row, P.S - 1) * P.o_s + h * P.o_h + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        __nv_bfloat162 v2 = __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                                  o[4 * j + 2 * r + 1] * inv);
        st_global_b32_if(orow + 8 * j, *reinterpret_cast<uint32_t*>(&v2), row < P.S);
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

// 4-D map over a [B, N, Hh, hd] bf16 view (strides in elements, last dim 1),
// boxes of `rows` x 64 columns, 128-byte swizzle, zero fill out of bounds.
// A dim of extent 1 is never stepped; its stride is replaced by 16 bytes.
int make_map(CUtensorMap* map, const void* ptr, int B, int N, int Hh, int hd,
             const long long* st /* b, n, h */, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)N, (cuuint64_t)Hh, (cuuint64_t)B};
  const cuuint64_t strides[3] = {N > 1 ? (cuuint64_t)st[1] * 2 : 16,
                                 Hh > 1 ? (cuuint64_t)st[2] * 2 : 16,
                                 B > 1 ? (cuuint64_t)st[0] * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* out,
           const Params& P, int B, cudaStream_t stream) {
  auto kern = P.has_softcap ? flash_attention_sm90_kernel<HD, true>
                            : flash_attention_sm90_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<HD>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * P.H, (P.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, Cfg<HD>::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                                  P);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, out; head dims 64, 128 and 256.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take, else the
// launch's own status), -1 when libcuda.so.1's cuTensorMapEncodeTiled is not
// found, or 10000 + the CUresult of a tensor map it refused.
extern "C" int flash_attention_sm90(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int T, int H, int Hkv, int hd,
                                    const long long* strides,  // q, k, v, out: (b, s, h) each
                                    int causal, int has_window, int window, int has_softcap,
                                    float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (hd != 64 && hd != 128 && hd != 256) || (S + BQ - 1) / BQ > 65535 ||
      (has_window && window <= 0) || (has_softcap && !(softcap > 0.f)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int r = make_map(&tq, q, B, S, H, hd, strides, BQ);
  if (r == 0) r = make_map(&tk, k, B, T, Hkv, hd, strides + 3, BK);
  if (r == 0) r = make_map(&tv, v, B, T, Hkv, hd, strides + 6, BK);
  if (r != 0) return r;
  Params P;
  P.S = S; P.T = T; P.H = H; P.Hkv = Hkv;
  P.o_b = strides[9]; P.o_s = strides[10]; P.o_h = strides[11];
  P.causal = causal; P.has_window = has_window; P.window = window;
  P.has_softcap = has_softcap; P.softcap = softcap; P.scale = scale;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(tq, tk, tv, out, P, B, s);
    case 128: return launch<128>(tq, tk, tv, out, P, B, s);
    default: return launch<256>(tq, tk, tv, out, P, B, s);
  }
}
