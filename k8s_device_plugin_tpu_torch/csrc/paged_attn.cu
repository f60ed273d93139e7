// Paged attention for Hopper (sm_90a), CUDA C++: kernel B2.
//
// Replaces k8s_device_plugin_tpu/models/transformer.py
// `Attention._paged_attention_fused` (:476-536), an XLA lax.scan over the
// block table: the attention read of the paged serving engine, at every
// decode step and every prefill chunk. It computes what that scan
// computes: for each (row, kv head), the n_rep * L query rows (q after
// RoPE, [b, L, heads, d]) attend the row's keys through its block table
// (bt [b, W]: key position w * P + j lives at page bt[row, w], offset j of
// the pools [pool_pages, P, kv_heads, d]), a key visible iff its position
// <= the query's q_pos ([b, L], read from device memory); scores scaled
// by `scale` in fp32, an fp32 online softmax (running max m, sum l,
// accumulator acc * alpha), out = acc / l (l > 0 guarded) in the input
// dtype, [b, L, heads, d].
//
// What differs from the scan, and why:
// - The scan visits all W table slots of the page bucket; a block here
//   stops at its rows' last live page (max q_pos / P), since the slots
//   past it are masked for every row and add nothing.
// - No gathered copy and no [b, P, kv, d] page block per step: each lane
//   reads its key's row straight from the pool through the table.
// - GQA reads the shared kv head in place: the block owns query rows of
//   one (row, kv head), the q heads h = kv * n_rep + r.
// - Determinism: the block's four warps take fixed, interleaved 32-key
//   chunks of the positions (warp w: chunks w, w + 4, ...) with their own
//   (m, l, acc), reduced over the lanes by fixed butterfly trees and
//   combined in warp order at the end. No atomics: two launches on the
//   same inputs are bit-equal.
//
// Layout of the work: grid (b, kv_heads, ceil(n_rep * L / 8)); a block of
// 128 threads owns 8 query rows (query row i = l * n_rep + r). Lane j of a
// warp looks up key c0 + j's page once and scores the key against the 8
// rows (an fp32 dot product over d, four 16-byte loads of its K row in
// flight, the q rows in shared memory as fp32); the warp's max and sum
// come from shuffles; acc += P V runs with each lane owning two columns
// of every 64, each key's pool offset and probabilities broadcast from
// its lane and its V row read by the whole warp (coalesced), eight keys
// unrolled so their loads overlap. A load is latency, not bandwidth, at
// these sizes: the design keeps several in flight per warp. Products run
// on the CUDA cores in fp32, which keeps the float32 path exact to
// summation order.
//
// The launch grid depends only on (b, kv_heads, L): lens and the table are
// read on the device, so a later caller can capture it in a CUDA graph.
//
// What bounds it on an H100: at a decode step (L = 1) it reads each live
// K/V page once and does 4 * d FLOP per key and query row: the bytes
// bound it by far (PERF.md has its times beside that bound).
//
// Head dims: instances at 64, 128 and 256 columns take any d up to them
// that is a multiple of 8 (lanes past d are idle).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;     // query rows a block owns
constexpr int kChunk = 32;   // key positions a warp takes at a time
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

constexpr int kErrUnsupported = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eight consecutive elements (16-byte aligned for bf16, 32 for fp32).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A bf16 is the high half of the fp32 with the same bits, so the widening
// is a shift or a mask (no local array whose address is taken).
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Offset of (position, kv head) in a pool [pool_pages, P, kv_heads, d],
// through row `bt_row`'s table; a page id outside the pool reads page 0
// (the engine's scratch page) instead of memory past the pool.
__device__ __forceinline__ size_t pool_offset(const int* bt_row, int pos,
                                              int page_tokens, int kv_heads,
                                              int g, int d, int pool_pages) {
  int page = __ldg(bt_row + pos / page_tokens);
  if (page < 0 || page >= pool_pages) page = 0;
  return (((size_t)page * page_tokens + pos % page_tokens) * kv_heads + g) *
         d;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ bt,
                  const int* __restrict__ q_pos, T* __restrict__ out, int L,
                  int heads, int kv_heads, int d, int page_tokens, int W,
                  int pool_pages, float scale) {
  constexpr int NC = DMAX / 64;  // column pairs a lane owns: 2 lane + 64 t
  __shared__ float qs[kRows][DMAX];
  __shared__ float part_m[kWarps][kRows];
  __shared__ float part_l[kWarps][kRows];
  __shared__ float part_acc[kWarps][kRows][DMAX];

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int n_rep = heads / kv_heads;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, n_rep * L - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The block's query rows into shared memory as fp32, zeros past nr / d.
  for (int idx = threadIdx.x; idx < kRows * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    float x = 0.f;
    if (r < nr && c < d) {
      const int i = r0 + r;
      x = to_f32(q[(((size_t)b * L + i / n_rep) * heads + g * n_rep +
                    i % n_rep) * d + c]);
    }
    qs[r][c] = x;
  }
  // Each row's position, and the keys through the last page any row sees.
  int pos_r[kRows];
  int qmax = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    pos_r[r] = r < nr ? __ldg(q_pos + (size_t)b * L + (r0 + r) / n_rep) : -1;
    qmax = max(qmax, pos_r[r]);
  }
  const int n_keys = min(W * page_tokens,
                         (qmax / page_tokens + 1) * page_tokens);
  const int* bt_row = bt + (size_t)b * W;
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][NC][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) acc[r][t][0] = acc[r][t][1] = 0.f;
  }

  for (int c0 = warp * kChunk; c0 < n_keys; c0 += kWarps * kChunk) {
    // This lane's key and its row's offset in the pools (K and V share
    // it). A lane past the last key reads the last key instead and weighs
    // it 0 below, so the loops need no guard.
    const int pos = c0 + lane;
    const bool live = pos < n_keys;
    const size_t off = pool_offset(bt_row, live ? pos : n_keys - 1,
                                   page_tokens, kv_heads, g, d, pool_pages);
    // Scores of the key against the block's rows, 32 columns (four
    // 16-byte loads in flight) at a time, then 8.
    const T* krow = k_pages + off;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    int c = 0;
    for (; c + 32 <= d; c += 32) {
      float kx[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) load8(krow + c + 8 * u, kx[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s[r] = fmaf(qs[r][c + 8 * u + e], kx[u][e], s[r]);
    }
    for (; c < d; c += 8) {
      float kx[8];
      load8(krow + c, kx);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r] = fmaf(qs[r][c + e], kx[e], s[r]);
    }
    // Online softmax: masked keys take probability 0 outright, so a warp
    // whose keys are all past a row's position leaves it at (m = -1e30,
    // l = 0, acc = 0), which the combine weighs by 0.
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool vis = live && pos <= pos_r[r];
      const float sc = vis ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      p[r] = vis ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        acc[r][t][0] *= alpha;
        acc[r][t][1] *= alpha;
      }
    }
    // acc += P V: key c0 + j's offset and probabilities from lane j, its V
    // row read by the whole warp, two columns a lane; unrolled so that
    // several rows' loads are in flight at once.
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      const T* vrow = v_pages + __shfl_sync(kFull, off, j);
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int col = 2 * lane + 64 * t;
        if (col < d) {
          const float2 vv = load2(vrow + col);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][t][0] = fmaf(pj[r], vv.x, acc[r][t][0]);
            acc[r][t][1] = fmaf(pj[r], vv.y, acc[r][t][1]);
          }
        }
      }
    }
  }

  // Combine the warps' partial states in warp order.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      part_acc[warp][r][2 * lane + 64 * t] = acc[r][t][0];
      part_acc[warp][r][2 * lane + 64 * t + 1] = acc[r][t][1];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx % d;
    float mt = part_m[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, part_m[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(part_m[w][r] - mt);
      lt = fmaf(part_l[w][r], f, lt);
      at = fmaf(part_acc[w][r][c], f, at);
    }
    const int i = r0 + r;
    out[(((size_t)b * L + i / n_rep) * heads + g * n_rep + i % n_rep) * d +
        c] = from_f32<T>(at / (lt > 0.f ? lt : 1.f));
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* bt, const int* q_pos, void* out, int batch, int L,
           int heads, int kv_heads, int d, int page_tokens, int W,
           int pool_pages, float scale, cudaStream_t stream) {
  const dim3 grid(batch, kv_heads,
                  (heads / kv_heads * L + kRows - 1) / kRows);
  paged_attn_kernel<T, DMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), bt, q_pos, static_cast<T*>(out), L,
      heads, kv_heads, d, page_tokens, W, pool_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int dmax, const void* q, const void* k_pages,
                 const void* v_pages, const int* bt, const int* q_pos,
                 void* out, int batch, int L, int heads, int kv_heads, int d,
                 int page_tokens, int W, int pool_pages, float scale,
                 cudaStream_t s) {
  if (dmax == 64)
    return launch<T, 64>(q, k_pages, v_pages, bt, q_pos, out, batch, L,
                         heads, kv_heads, d, page_tokens, W, pool_pages,
                         scale, s);
  if (dmax == 128)
    return launch<T, 128>(q, k_pages, v_pages, bt, q_pos, out, batch, L,
                          heads, kv_heads, d, page_tokens, W, pool_pages,
                          scale, s);
  if (dmax == 256)
    return launch<T, 256>(q, k_pages, v_pages, bt, q_pos, out, batch, L,
                          heads, kv_heads, d, page_tokens, W, pool_pages,
                          scale, s);
  return kErrUnsupported;
}

}  // namespace

// C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. q and out are
// contiguous [batch, L, heads, head_dim]; the pools [pool_pages,
// page_tokens, kv_heads, head_dim]; bt [batch, W] and q_pos [batch, L]
// int32, all in device memory. head_dim must be a multiple of 8 and at most
// `dmax` (64, 128 or 256: the instance). Returns 0, the CUDA error of the
// launch, or -1 for a dtype or dmax not built.
extern "C" int paged_attn(const void* q, const void* k_pages,
                          const void* v_pages, const int* bt,
                          const int* q_pos, void* out, int batch, int L,
                          int heads, int kv_heads, int head_dim, int dmax,
                          int page_tokens, int W, int pool_pages, int dtype,
                          float scale, void* stream) {
  if (head_dim % 8 || head_dim > dmax || heads % kv_heads || L < 1 ||
      page_tokens < 1 || W < 1)
    return kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(dmax, q, k_pages, v_pages, bt, q_pos, out,
                               batch, L, heads, kv_heads, head_dim,
                               page_tokens, W, pool_pages, scale, s);
  if (dtype == 1)
    return launch_typed<bf16>(dmax, q, k_pages, v_pages, bt, q_pos, out,
                              batch, L, heads, kv_heads, head_dim,
                              page_tokens, W, pool_pages, scale, s);
  return kErrUnsupported;
}
