// Canonicalize-and-compose for the canonical-LUT GEMM, one launch per
// projection.
//
// For each K-group g of p activation codes and each column n:
//
//   sort the p codes stably            -> sorted codes s, permutation perm
//   msrank[g, n] = sum_i C(s_i + i, i + 1)             (multiset rank)
//   permid[g, n] = sum_i #{j > i: perm_j < perm_i} (p-1-i)!   (Lehmer id)
//   B[n, g*R + r] = canonical[reordering[r, permid], msrank]  (s8, compose)
//
// The JAX package computes the first three with XLA (src/repro/core/
// multiset.py:139-170: a stable argsort, take_along_axis, the rank and the
// Lehmer code; src/repro/core/engine.py:136), and the TPU kernel
// src/repro/kernels/lut_stream_gemm.py::lut_stream_gemm composes the streamed
// canonical and reordering columns per (g, n) (_stream_kernel_body).  This
// kernel does all of it in registers, one thread per (g, n):
//
// * The p codes are sorted by an odd-even transposition network (p rounds) on
//   the distinct keys code * p + i: the network's order on distinct keys is
//   the one sorted order, which is the stable argsort's order under ties.
//   sorted_i = key_i / p, perm_i = key_i % p.
// * The binomial table (v + p rows, p + 1 columns, the pack's) is read
//   through the read-only cache; the pack's canonical [R, C] and reordering
//   [R, P!] LUTs are staged in shared memory as bytes (5.7 KB at W1A3 p=4)
//   when they fit 32 KB, else read from device memory.
// * The codes come as given: [K, N] with any strides (the activation
//   quantizer's codes are a transposed view, [N, K] in memory, so a group is
//   p contiguous int32: one 16-byte load at p = 4).  A partial last group is
//   padded with the pack's zero code, as engine.canonicalize_activations
//   pads.
// * A tile is 32 groups x TN columns (TN = 8 or 32); threads walk it along g
//   (coalesced code reads and B writes) and msrank / permid go out through a
//   shared-memory transpose along n (they are [G, N] row-major).  A grid of at
//   most 4 CTAs per SM walks the tiles, so the tables are staged once per CTA.
//
// Modes: 0 canonicalizes (msrank, permid); 1 also composes B (the tensor-core
// route of lut_stream_gemm); 2 composes B from given msrank / permid (the
// public lut_stream_gemm entry on that route).  B is [N, ldb] s8, columns
// g*R + r, K-major as int8 wgmma takes it (lut_stream_gemm_sm90.cu); columns
// G*R .. ldb-1 are not written.  Modes 3 and 4 do the same as 1 and 2 for the
// lookup route (lut_stream_lookup_sm90.cu, 32 < R <= 256): the slices tiled
// for it, S [ceil(N/NT), G, R, NT] u8, each entry stored as entry + 128
// (columns past N hold 128, entry 0), composed from byte copies of the tables
// transposed, canonical [C, R] s8 and reordering [P!, R] u8, so that a (g, n)
// reads two contiguous R-byte rows, S[.., g, r, ..] = canonT[ms][reordT[pid][r]].
// A warp composes one (g, column tile): lane l rows 4l .. 4l+3 (+128), one
// 4-byte load of reordT and four byte loads of canonT per column, and writes
// its 4 x NT bytes in one piece (consecutive lanes, consecutive bytes).
//
// What bounds it on an H100: bytes.  Each code read once (4 bytes), msrank and
// permid written once (8 bytes per group) and B (R bytes per group): 26 MB for
// one stablelm-12b q projection at N = 512, 7.8 us at 3.35 TB/s; the lookup
// route's slices for w_up at N = 512, G*R*N bytes, 28 / 48 / 84 MB at p = 6 /
// 7 / 8 (8-25 us).
//
// Plain C interface for ctypes; the caller passes the stream and allocates the
// outputs.  The kernel trusts the codes (< v) and the indices (msrank < C,
// permid < P!, reordering < R): they come from the engine's own quantizer and
// canonicalization.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TG = 32;                      // groups per tile
constexpr int MAX_P = 12;                   // the LUT packs' largest p (luts.max_p_canonical)
constexpr int TABLE_SMEM = 32 * 1024;       // canonical + reordering bytes staged, at most
constexpr int CTAS_PER_SM = 4;

struct Params {
  const int32_t* codes;                     // [K, N] activation codes (modes 0, 1, 3)
  long long s_k, s_n;                       // their strides, in elements
  const int32_t* binom;                     // [v + p, p + 1] binomial table (modes 0, 1, 3)
  int32_t* msrank;                          // [G, N] (written in modes 0, 1, 3; read in 2, 4)
  int32_t* permid;
  const int32_t* canonical;                 // [R, C] (modes 1, 2)
  const int32_t* reordering;                // [R, PF]
  const uint8_t* canon_t;                   // [C, R] s8 bytes (modes 3, 4)
  const uint8_t* reord_t;                   // [PF, R] u8
  int8_t* b;                                // [N, ldb] (modes 1, 2); S [T, G, R, NT] (modes 3, 4)
  int ldb, K, N, G, R, C, PF, pad_code, mode, tn, nt, tables_in_smem, vec4;
};

__host__ __device__ constexpr int factorial(int n) { return n <= 1 ? 1 : n * factorial(n - 1); }

// msrank and permid of group g of column n.
template <int P>
__device__ __forceinline__ void canon_one(const Params& Q, int g, int n, int& ms, int& pid) {
  int key[P];
  const int k0 = g * P;
  if constexpr (P == 4) {
    if (Q.vec4 && k0 + 4 <= Q.K) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(Q.codes + (size_t)n * Q.s_n + k0));
      key[0] = v.x * 4; key[1] = v.y * 4 + 1; key[2] = v.z * 4 + 2; key[3] = v.w * 4 + 3;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        key[i] = (k0 + i < Q.K ? __ldg(Q.codes + (k0 + i) * Q.s_k + n * Q.s_n) : Q.pad_code) * 4 + i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      key[i] = (k0 + i < Q.K ? __ldg(Q.codes + (k0 + i) * Q.s_k + n * Q.s_n) : Q.pad_code) * P + i;
  }
  // Odd-even transposition: P rounds sort P keys.
#pragma unroll
  for (int round = 0; round < P; ++round) {
#pragma unroll
    for (int i = round & 1; i + 1 < P; i += 2) {
      const int lo = min(key[i], key[i + 1]), hi = max(key[i], key[i + 1]);
      key[i] = lo;
      key[i + 1] = hi;
    }
  }
  const int bc = P + 1;
  int rank = 0, lehmer = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    rank += __ldg(Q.binom + (key[i] / P + i) * bc + i + 1);
    int smaller = 0;
#pragma unroll
    for (int j = i + 1; j < P; ++j) smaller += (key[j] % P) < (key[i] % P);
    lehmer += smaller * factorial(P - 1 - i);
  }
  ms = rank;
  pid = lehmer;
}

// Writes the R composed bytes of (g, n) to B.
__device__ __forceinline__ void compose_one(const Params& Q, const int8_t* sc, const uint8_t* sr,
                                            int g, int n, int ms, int pid) {
  uint32_t words[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * w + j;
      if (r < Q.R) {
        int val;
        if (Q.tables_in_smem) {
          val = sc[sr[r * Q.PF + pid] * Q.C + ms];
        } else {
          const int row = __ldg(Q.reordering + (size_t)r * Q.PF + pid);
          val = __ldg(Q.canonical + (size_t)row * Q.C + ms);
        }
        v |= (uint32_t)(uint8_t)(int8_t)val << (8 * j);
      }
    }
    words[w] = v;
  }
  int8_t* dst = Q.b + (size_t)n * Q.ldb + (size_t)g * Q.R;
  switch (Q.R) {
    case 32:
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(words[0], words[1], words[2], words[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(words[4], words[5], words[6], words[7]);
      break;
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]); break;
    case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = words[0]; break;
    default: *reinterpret_cast<uint16_t*>(dst) = (uint16_t)words[0]; break;
  }
}

// Writes the lookup route's slice of group g for the NT columns n0 .. n0 + NT
// (ms_t / pid_t: their msrank and permid, nvalid of them inside N) at dst, [R,
// NT] bytes: one warp, lane l rows 4l .. 4l + 3 and every 128 rows on.
template <int NT>
__device__ __forceinline__ void compose_lookup(const Params& Q, const int32_t* ms_t,
                                               const int32_t* pid_t, int nvalid, uint8_t* dst,
                                               int lane) {
  for (int r0 = 4 * lane; r0 < Q.R; r0 += 128) {
    uint32_t words[4][NT / 4];             // rows r0 + j, columns 4q .. 4q + 3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < NT / 4; ++q) words[j][q] = 0u;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t v[4] = {0x80u, 0x80u, 0x80u, 0x80u};
      if (t < nvalid) {
        const uint8_t* crow = Q.canon_t + (size_t)ms_t[t] * Q.R;
        const uint32_t rows =
            __ldg(reinterpret_cast<const uint32_t*>(Q.reord_t + (size_t)pid_t[t] * Q.R + r0));
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldg(crow + ((rows >> (8 * j)) & 0xffu)) ^ 0x80u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) words[j][t / 4] |= v[j] << (8 * (t % 4));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* row = dst + (size_t)(r0 + j) * NT;
      if constexpr (NT == 16)
        *reinterpret_cast<uint4*>(row) =
            make_uint4(words[j][0], words[j][1], words[j][2], words[j][3]);
      else if constexpr (NT == 8)
        *reinterpret_cast<uint2*>(row) = make_uint2(words[j][0], words[j][1]);
      else
        *reinterpret_cast<uint32_t*>(row) = words[j][0];
    }
  }
}

// dst[i] = (byte) src[i] for i < n: 16-byte loads where src and dst allow, the
// loads of a thread batched (a table is read once per CTA, from L2).
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const int32_t* src, int n, int tid) {
  int done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 4 == 0) {
    const int n4 = n / 4;
#pragma unroll 8
    for (int i = tid; i < n4; i += THREADS) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src) + i);
      reinterpret_cast<uint32_t*>(dst)[i] = (uint32_t)(uint8_t)v.x | (uint32_t)(uint8_t)v.y << 8 |
                                            (uint32_t)(uint8_t)v.z << 16 |
                                            (uint32_t)(uint8_t)v.w << 24;
    }
    done = 4 * n4;
  }
#pragma unroll 8
  for (int i = done + tid; i < n; i += THREADS) dst[i] = (uint8_t)__ldg(src + i);
}

template <int P>
__global__ void __launch_bounds__(THREADS)
lut_canon_kernel(const Params Q) {
  extern __shared__ int4 smem4[];
  int32_t* ms_t = reinterpret_cast<int32_t*>(smem4);      // [TG][33]
  int32_t* pid_t = ms_t + TG * 33;                         // [TG][33]
  int8_t* sc = reinterpret_cast<int8_t*>(pid_t + TG * 33); // [R][C]
  uint8_t* sr = reinterpret_cast<uint8_t*>(sc + Q.R * Q.C);   // [R][PF]
  const int tid = threadIdx.x;
  const bool compose = Q.mode == 1 || Q.mode == 2;    // the tensor-core layout
  const bool given = Q.mode == 2 || Q.mode == 4;      // msrank / permid read, not computed
  if (compose && Q.tables_in_smem) {
    stage_bytes(reinterpret_cast<uint8_t*>(sc), Q.canonical, Q.R * Q.C, tid);
    stage_bytes(sr, Q.reordering, Q.R * Q.PF, tid);
  }
  __syncthreads();
  const int tiles_g = (Q.G + TG - 1) / TG, tiles_n = (Q.N + Q.tn - 1) / Q.tn;
  const int per_tile = TG * Q.tn;
  for (int tile = blockIdx.x; tile < tiles_g * tiles_n; tile += gridDim.x) {
    const int g0 = (tile % tiles_g) * TG, n0 = (tile / tiles_g) * Q.tn;
    if (given) {
      // Given indices, read along n (they are [G, N] row-major).
      for (int e = tid; e < per_tile; e += THREADS) {
        const int nl = e % Q.tn, gl = e / Q.tn, g = g0 + gl, n = n0 + nl;
        if (g < Q.G && n < Q.N) {
          ms_t[gl * 33 + nl] = Q.msrank[(size_t)g * Q.N + n];
          pid_t[gl * 33 + nl] = Q.permid[(size_t)g * Q.N + n];
        }
      }
      __syncthreads();
    }
    // Along g: coalesced code reads and B writes.
    for (int e = tid; e < per_tile; e += THREADS) {
      const int gl = e % TG, nl = e / TG, g = g0 + gl, n = n0 + nl;
      if (g < Q.G && n < Q.N) {
        int ms, pid;
        if (given) {
          ms = ms_t[gl * 33 + nl];
          pid = pid_t[gl * 33 + nl];
        } else {
          canon_one<P>(Q, g, n, ms, pid);
          ms_t[gl * 33 + nl] = ms;
          pid_t[gl * 33 + nl] = pid;
        }
        if (compose) compose_one(Q, sc, sr, g, n, ms, pid);
      }
    }
    __syncthreads();
    if (Q.mode >= 3) {
      // The lookup route's slices: one warp per (group, column tile of NT).
      const int warp = tid / 32, lane = tid % 32, subs = Q.tn / Q.nt;
      for (int task = warp; task < TG * subs; task += THREADS / 32) {
        const int gl = task % TG, c0 = n0 + (task / TG) * Q.nt, g = g0 + gl;
        if (g >= Q.G || c0 >= Q.N) continue;
        const int nl = c0 - n0, nvalid = min(Q.nt, Q.N - c0);
        uint8_t* dst = reinterpret_cast<uint8_t*>(Q.b) +
                       ((size_t)(c0 / Q.nt) * Q.G + g) * Q.R * Q.nt;
        const int32_t* ms = ms_t + gl * 33 + nl;
        const int32_t* pid = pid_t + gl * 33 + nl;
        if (Q.nt == 16) compose_lookup<16>(Q, ms, pid, nvalid, dst, lane);
        else if (Q.nt == 8) compose_lookup<8>(Q, ms, pid, nvalid, dst, lane);
        else compose_lookup<4>(Q, ms, pid, nvalid, dst, lane);
      }
    }
    if (!given) {
      // msrank / permid out along n.
      for (int e = tid; e < per_tile; e += THREADS) {
        const int nl = e % Q.tn, gl = e / Q.tn, g = g0 + gl, n = n0 + nl;
        if (g < Q.G && n < Q.N) {
          Q.msrank[(size_t)g * Q.N + n] = ms_t[gl * 33 + nl];
          Q.permid[(size_t)g * Q.N + n] = pid_t[gl * 33 + nl];
        }
      }
    }
    __syncthreads();                       // the next tile overwrites the transposes
  }
}

template <int P>
int launch(const Params& Q, cudaStream_t stream) {
  const size_t smem = 2 * TG * 33 * sizeof(int32_t) +
                      (Q.mode != 0 && Q.tables_in_smem ? (size_t)Q.R * (Q.C + Q.PF) : 0);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((Q.G + TG - 1) / TG) * ((Q.N + Q.tn - 1) / Q.tn);
  const int grid = (int)(tiles < (long long)CTAS_PER_SM * sms ? tiles : (long long)CTAS_PER_SM * sms);
  lut_canon_kernel<P><<<grid, THREADS, smem, stream>>>(Q);
  return (int)cudaGetLastError();
}

}  // namespace

// codes [K, N] int32 (strides s_k, s_n elements; modes 0, 1, 3), binom [v + p,
// p + 1] int32, msrank / permid [G, N] int32; modes 1, 2: canonical [R, C] /
// reordering [R, PF] int32 (entries that fit s8 / u8), b [N, ldb] s8; modes 3,
// 4: canonical [C, R] s8 / reordering [PF, R] u8 (the transposed byte copies),
// b the slices [ceil(N/nt), G, R, nt] u8, nt = 4 at N <= 4, 8 at N <= 8, else
// 16 (ldb unused).  Returns a cudaError_t: cudaErrorInvalidValue for arguments
// the kernel does not take, else the launch's own status.
extern "C" int lut_canon(const void* codes, long long s_k, long long s_n, const void* binom,
                         void* msrank, void* permid, const void* canonical,
                         const void* reordering, void* b, int ldb, int K, int N, int G, int p,
                         int R, int C, int PF, int pad_code, int mode, int nt, void* stream) {
  const bool compose = mode == 1 || mode == 2;
  const bool lookup = mode == 3 || mode == 4;
  const bool given = mode == 2 || mode == 4;
  if (!(mode >= 0 && mode <= 4) || p < 1 || p > MAX_P || N <= 0 || G <= 0 ||
      (!given && (codes == nullptr || binom == nullptr || K <= 0 || (long long)G * p < K ||
                  (long long)(G - 1) * p >= K)) ||
      msrank == nullptr || permid == nullptr ||
      (compose && (canonical == nullptr || reordering == nullptr || b == nullptr ||
                   !(R == 2 || R == 4 || R == 8 || R == 16 || R == 32) || C <= 0 || PF <= 0 ||
                   (long long)ldb < (long long)G * R || ldb % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(b) % 16 != 0)) ||
      (lookup && (canonical == nullptr || reordering == nullptr || b == nullptr ||
                  !(R == 64 || R == 128 || R == 256) || C <= 0 || PF <= 0 ||
                  nt != (N <= 4 ? 4 : N <= 8 ? 8 : 16) ||
                  reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(reordering) % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  Params Q;
  Q.codes = static_cast<const int32_t*>(codes);
  Q.s_k = s_k;
  Q.s_n = s_n;
  Q.binom = static_cast<const int32_t*>(binom);
  Q.msrank = static_cast<int32_t*>(msrank);
  Q.permid = static_cast<int32_t*>(permid);
  Q.canonical = static_cast<const int32_t*>(canonical);
  Q.reordering = static_cast<const int32_t*>(reordering);
  Q.canon_t = static_cast<const uint8_t*>(canonical);
  Q.reord_t = static_cast<const uint8_t*>(reordering);
  Q.b = static_cast<int8_t*>(b);
  Q.nt = nt;
  Q.ldb = ldb; Q.K = K; Q.N = N; Q.G = G; Q.R = R; Q.C = C; Q.PF = PF;
  Q.pad_code = pad_code;
  Q.mode = mode;
  Q.tn = N <= 8 ? 8 : 32;
  Q.tables_in_smem = compose && (long long)R * (C + PF) <= TABLE_SMEM;
  Q.vec4 = p == 4 && s_k == 1 && s_n % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch<1>(Q, s);
    case 2: return launch<2>(Q, s);
    case 3: return launch<3>(Q, s);
    case 4: return launch<4>(Q, s);
    case 5: return launch<5>(Q, s);
    case 6: return launch<6>(Q, s);
    case 7: return launch<7>(Q, s);
    case 8: return launch<8>(Q, s);
    case 9: return launch<9>(Q, s);
    case 10: return launch<10>(Q, s);
    case 11: return launch<11>(Q, s);
    default: return launch<12>(Q, s);
  }
}
