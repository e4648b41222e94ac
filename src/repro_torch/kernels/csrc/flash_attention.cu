// Online-softmax (flash) attention with GQA, causal and sliding-window masks
// and a logit softcap, for Hopper (sm_90a).
//
//   out[b, s, h, :] = softmax_t(mask(cap * tanh(q[b,s,h,:] . k[b,t,h/rep,:] * scale / cap)))
//                     @ v[b, :, h/rep, :]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_body).  Same function and the same update per key block:
//
//   m' = max(m, rowmax s)            p = where(mask, exp(s - m'), 0)
//   l' = l * e^{m - m'} + rowsum p   acc' = acc * e^{m - m'} + p @ V
//   out = acc / max(l, 1e-30)
//
// with s = q.k * scale, then the softcap, then masked scores set to -1e30.
// Inputs are f32 or bf16 (q, k and v alike); everything is computed in f32
// and the output is written in the inputs' type.
//
// What bounds it on an H100: the 2 * 2 * S * T_seen * hd multiply-adds per
// head (T_seen: the keys the causal and window masks leave), not its bytes
// (q, k, v and out are read or written once each).  This first version is
// simple and right, on the CUDA cores with fmaf: one CTA per (query block of
// 64, b*h); the key blocks of 64 run in order in a loop inside the CTA (the
// TPU's sequential kk grid axis).  Each block's q tile, and each key block's
// k and v tiles, are staged in shared memory as f32 (dynamic shared memory:
// 214 KB at hd = 256); a thread holds a 4 x 4 tile of scores and a
// 4 x hd/16 tile of the accumulator in registers.  Key blocks wholly masked
// by the causal mask or wholly outside the window are skipped (they change
// neither m, l nor acc); the ragged S and T tails are masked in the kernel.
// Query blocks are issued longest first, so the causal tail does not idle
// the card.  q, k, v and out are read and written in place through their
// [B, S|T, H|Hkv, hd] strides (the last dim contiguous); the kv head of
// head h is h / (H / Hkv).  No wgmma, TMA or warp specialisation yet.
//
// A query row with no visible key (impossible under the causal mask) gets
// 0, as _flash_body gives it.
//
// Plain C interface for ctypes; the caller passes the stream and allocates out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per key block
constexpr int THREADS = 256;     // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Strides {
  long long b, s, h;             // in elements; the head dim has stride 1
};

struct Params {
  int B, S, T, H, Hkv;
  Strides q, k, v, o;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// Copy rows [r0, r0 + rows) of one head of x (f32 or bf16) into a shared f32
// tile with row stride ld; rows at or past n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* __restrict__ x,
                                          const Strides& st, int b, int head, int r0, int rows,
                                          int n, int hd) {
  for (int i = threadIdx.x; i < rows * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int row = r0 + r;
    tile[r * ld + d] = row < n ? to_f32(x[b * st.b + row * st.s + head * st.h + d]) : 0.f;
  }
}

// NJ = hd / 16: the accumulator columns of one thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Params P) {
  constexpr int HD = 16 * NJ;
  constexpr int LDQ = HD + 1;    // odd strides: conflict-free column reads
  constexpr int LDS = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][LDQ]
  float* ks = qs + BQ * LDQ;                 // [BK][LDQ]
  float* vs = ks + BK * LDQ;                 // [BK][HD]
  float* ss = vs + BK * HD;                  // [BQ][LDS] scores, then p
  float* m_s = ss + BQ * LDS;                // [BQ] running max
  float* l_s = m_s + BQ;                     // [BQ] running sum
  float* a_s = l_s + BQ;                     // [BQ] e^{m - m'} of this block

  const int bh = blockIdx.x;
  const int b = bh / P.H, h = bh - b * P.H;
  const int hk = h / (P.H / P.Hkv);
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;   // longest (latest) query blocks first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(qs, LDQ, q, P.q, b, h, q0, BQ, P.S, HD);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // Key blocks that can hold a visible key for some row of this query block.
  const int q_last = min(q0 + BQ, P.S) - 1;
  int k_begin = 0, k_end = P.T;
  if (P.causal) k_end = min(k_end, q_last + 1);
  if (P.has_window) k_begin = max(0, q0 - P.window + 1);
  k_begin = k_begin / BK * BK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous block's k, v and p are no longer read
    load_tile(ks, LDQ, k, P.k, b, hk, k0, BK, P.T, HD);
    load_tile(vs, HD, v, P.v, b, hk, k0, BK, P.T, HD);
    __syncthreads();

    // s = q . k * scale -> softcap -> mask; a 4 x 4 tile per thread.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float s = sc[i][j] * P.scale;
        if (P.has_softcap) s = P.softcap * tanhf(s / P.softcap);
        bool keep = kpos < P.T;
        if (P.causal) keep = keep && kpos <= qpos;
        if (P.has_window) keep = keep && kpos > qpos - P.window;
        ss[r * LDS + c] = keep ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online-softmax update: four consecutive lanes per query row.
    {
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      const int qpos = q0 + r;
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, ss[r * LDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const int kpos = k0 + c;
        bool keep = kpos < P.T;
        if (P.causal) keep = keep && kpos <= qpos;
        if (P.has_window) keep = keep && kpos > qpos - P.window;
        const float p = keep ? expf(ss[r * LDS + c] - m_new) : 0.f;
        ss[r * LDS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v; rows ty + 16 i, columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ss[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vb = vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= P.S) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + b * P.o.b + row * P.o.s + h * P.o.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(o + tx + 16 * j, acc[i][j] * inv_l);
  }
}

template <int NJ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (16 * NJ + 1) + BK * (16 * NJ + 1) + BK * 16 * NJ +
                                  BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, const Params& P,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NJ>();
  auto kern = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P.B * P.H, (P.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int nj, const void* q, const void* k, const void* v, void* out, const Params& P,
              cudaStream_t s) {
  switch (nj) {
    case 1: return launch<T, 1>(q, k, v, out, P, s);
    case 2: return launch<T, 2>(q, k, v, out, P, s);
    case 4: return launch<T, 4>(q, k, v, out, P, s);
    case 6: return launch<T, 6>(q, k, v, out, P, s);
    case 8: return launch<T, 8>(q, k, v, out, P, s);
    case 10: return launch<T, 10>(q, k, v, out, P, s);
    case 16: return launch<T, 16>(q, k, v, out, P, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Head dims 16, 32, 64, 96, 128, 160 and 256.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else the
// launch's own status (cudaGetLastError right after it).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int is_bf16, int B, int S, int T, int H, int Hkv, int hd,
                               const long long* strides,  // q, k, v, out: (b, s, h) each
                               int causal, int has_window, int window, int has_softcap,
                               float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || hd % 16 != 0 ||
      (S + BQ - 1) / BQ > 65535 || (has_window && window <= 0) ||
      (has_softcap && !(softcap > 0.f)))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.B = B; P.S = S; P.T = T; P.H = H; P.Hkv = Hkv;
  Strides* st[4] = {&P.q, &P.k, &P.v, &P.o};
  for (int i = 0; i < 4; ++i) {
    st[i]->b = strides[3 * i];
    st[i]->s = strides[3 * i + 1];
    st[i]->h = strides[3 * i + 2];
  }
  P.causal = causal; P.has_window = has_window; P.window = window;
  P.has_softcap = has_softcap; P.softcap = softcap; P.scale = scale;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(hd / 16, q, k, v, out, P, s)
                 : launch_hd<float>(hd / 16, q, k, v, out, P, s);
}
