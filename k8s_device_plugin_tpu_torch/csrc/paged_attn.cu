// Paged attention for Hopper (sm_90a), CUDA C++: kernel B2.
//
// Replaces k8s_device_plugin_tpu/models/transformer.py
// `Attention._paged_attention_fused` (:476-536), an XLA lax.scan over the
// block table: the attention read of the paged serving engine, at every
// decode step and every prefill chunk. It computes what that scan
// computes: for each (row, kv head), the n_rep * L query rows (q after
// RoPE, [b, L, heads, d]; query row i = l * n_rep + r is q head
// kv * n_rep + r at block position l) attend the row's keys through its
// block table (bt [b, W]: key position w * P + j lives at page bt[row, w],
// offset j of the pools [pool_pages, P, kv_heads, d]), a key visible iff
// its position <= the query's q_pos ([b, L], read from device memory);
// scores scaled by `scale` in fp32, masked keys at -1e30, an fp32 online
// softmax (running max m, sum l, accumulator acc * alpha), out = acc / l
// (l > 0 guarded) in the input dtype, [b, L, heads, d]. A page id outside
// the pool reads scratch page 0. bt and q_pos are int64, as the serving
// engine holds them.
//
// What bounds it on an H100: a decode step reads each live K/V page once
// and does 4 * d FLOP per key and query row, ~1 FLOP a byte: the bytes
// bound it, ~2.5 us for the 8.5 MB of a 4-row decode step at ~1000
// tokens. Reaching that takes every SM pulling pages at once, while one
// block per (row, kv head) gives 64 blocks at that step for 132 SMs, each
// walking ~1000 keys in series.
//
// The design:
// - Split over pages. Each block owns one (row, kv head, query tile) and
//   one fixed, contiguous range of key positions (a whole number of pages
//   and of key tiles): grid (b, kv_heads, query tiles x splits). The
//   launch plan (ops/paged_attention.py `paged_attn_plan`) picks the keys
//   per split so that the grid fills the card (~4 blocks an SM) and owns
//   every tile size; the entry point refuses a plan its build disagrees
//   with. The grid and the workspace depend on shapes only, never on the
//   row lengths: a block reads its tile's largest q_pos on the device and
//   stops there; a split wholly past it writes (m = -1e30, l = 0) without
//   reading a page. So a launch can be captured in a CUDA graph and
//   replayed with new tables and positions.
// - Staging. K/V tiles are copied into shared memory with cp.async (16
//   bytes a thread, each key row found through the table) in a ring of
//   two stages: the next tile's copy is in flight while this one is
//   computed. Rows are padded by 16 bytes, so the row-wise 16-byte reads
//   of the products hit distinct banks. Keys past the split's end are
//   zero-filled (cp.async's source size 0), never left as stale bytes.
// - Two routes, by what the products need:
//   * decode (every float32 call; bfloat16 with fewer than 16 query rows
//     per (row, kv head)): 16-row query tiles, only the live rows
//     computed; fp32 products on the CUDA cores (the float32 path's 1e-5
//     bar rules out TF32), the scores of a tile in shared memory, one warp
//     per query row for the softmax, each thread a fixed set of (row,
//     column) accumulators for P V.
//   * chunk (bfloat16 with >= 16 query rows: prefill chunks, GQA with
//     many q heads a kv head): 64-row query tiles, four warps of 16 rows;
//     S = Q K^T and O += P V on the tensor cores with mma.sync m16n8k16
//     (fp32 accumulators; operands by ldmatrix, V through ldmatrix.trans).
//     The work is bound by bytes, not by operations, so the warp-level
//     mma is enough: wgmma's 64-row warpgroup tiles and TMA would need
//     page-aligned boxes and buy nothing a byte-bound read can use. The
//     online softmax stays in registers, P is rounded to bf16 for P V (as
//     the reference's gather rounds its probabilities, transformer.py
//     :471), and each live K/V page is read once per (row, kv head, query
//     tile).
// - Combine. With one split a block normalises and writes the output
//   itself. With more, each block writes its fp32 partial (m, l, acc[d])
//   to a workspace the wrapper allocates, and a second small kernel,
//   launched from the same entry point (one call from the host), combines
//   the splits in split order: M = max m_s, out = sum acc_s e^(m_s - M) /
//   sum l_s e^(m_s - M), skipping splits with l_s = 0. A second launch
//   rather than a last-block counter: no counter that a failed or
//   concurrent launch could leave behind, and the launch costs the host
//   nothing extra (the same ctypes call).
// - Determinism: fixed tiles, fixed reduction trees, the combine in split
//   order, no atomics. Two launches on the same inputs are bit-equal.
//
// Head dims: instances at 64, 128 and 256 columns take any d up to them
// that is a multiple of 8. Shared memory above 48 KB is dynamic
// (cudaFuncSetAttribute); each instance's bytes are in `Decode` / `Chunk`
// below and in the plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // every route: four warps
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

constexpr int kErrUnsupported = -1;
constexpr int kErrPlan = -2;

constexpr int kRouteDecode = 0;
constexpr int kRouteChunk = 1;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

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

// Eight consecutive elements as fp32 (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A bf16 is the high half of the fp32 with the same bits.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 1 / l for a softmax sum; 1 where l = 0 (a row that saw no key).
__device__ __forceinline__ float recip(float l) {
  return l > 0.f ? 1.f / l : 1.f;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element i of an int64 index tensor (a page id or a position).
__device__ __forceinline__ int load_index(const long long* p, size_t i) {
  return (int)__ldg(p + i);
}

// What every block of a launch shares.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const long long* bt;
  const long long* q_pos;
  void* out;
  float* ws_ml;   // [rows, n_splits, 2]: (m, l) of each partial
  float* ws_acc;  // [rows, n_splits, d]: acc of each partial
  int L, heads, kv_heads, d, page_tokens, W, pool_pages;
  int keys_per_split, n_splits;
  float scale;
};

// Copy key positions [k0, k0 + rows) of kv head g of row b into a stage
// of `rows` rows of `stride` elements (d of them used); positions at or
// past `k_end` are zero-filled. 16 bytes a thread and turn.
template <typename T>
__device__ __forceinline__ void load_kv_tile(const Args& a, int b, int g,
                                             int k0, int k_end, int rows,
                                             int stride, T* ks, T* vs) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = a.d / kVec;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  for (int ch = threadIdx.x; ch < rows * per_row; ch += kThreads) {
    const int j = ch / per_row;
    const int c = (ch % per_row) * kVec;
    const int pos = k0 + j;
    const bool live = pos < k_end;
    size_t off = 0;
    if (live) {
      int page = load_index(a.bt, (size_t)b * a.W + pos / a.page_tokens);
      if (page < 0 || page >= a.pool_pages) page = 0;
      off = (((size_t)page * a.page_tokens + pos % a.page_tokens) *
                 a.kv_heads + g) * a.d + c;
    }
    cp_async16(ks + j * stride + c, kp + off, live ? 16 : 0);
    cp_async16(vs + j * stride + c, vp + off, live ? 16 : 0);
  }
}

__device__ __forceinline__ size_t q_offset(const Args& a, int b, int g,
                                           int i) {
  const int n_rep = a.heads / a.kv_heads;
  return (((size_t)b * a.L + i / n_rep) * a.heads + g * n_rep + i % n_rep) *
         a.d;
}

// Row id of query row i of (b, g) in the workspace: [b, kv_heads, n_rep*L].
__device__ __forceinline__ size_t ws_row(const Args& a, int b, int g, int i) {
  const int nq = a.heads / a.kv_heads * a.L;
  return ((size_t)b * a.kv_heads + g) * nq + i;
}

// ---------------------------------------------------------------------------
// decode route: fp32 products on the CUDA cores
// ---------------------------------------------------------------------------

// Shared-memory plan of the decode route (bytes; the launch plan states
// the same). Keys per tile: 64 while a row is at most 256 bytes, 32 at
// 512, 16 at 1024 (float32 at d = 256), which keeps two stages near 70 KB.
// 45,312 / 82,176 / 86,272 bytes in bf16 and 78,080 / 78,080 / 84,224 in
// float32 at d = 64 / 128 / 256.
template <typename T, int DMAX>
struct Decode {
  static constexpr int kRows = 16;  // query rows a block owns
  static constexpr int kRowBytes = DMAX * (int)sizeof(T);
  static constexpr int kKeys = kRowBytes <= 256 ? 64
                               : kRowBytes == 512 ? 32 : 16;
  static constexpr int kStride = DMAX + 16 / (int)sizeof(T);  // elements
  static constexpr int kStage = kKeys * kStride * (int)sizeof(T);
  static constexpr int kK = 0;                    // K stages
  static constexpr int kV = kK + 2 * kStage;      // V stages
  static constexpr int kQ = kV + 2 * kStage;      // q rows, fp32
  static constexpr int kS = kQ + kRows * DMAX * 4;  // scores / probs, fp32
  static constexpr int kAlpha = kS + kRows * kKeys * 4;
  static constexpr int kM = kAlpha + kRows * 4;
  static constexpr int kL = kM + kRows * 4;
  static constexpr int kPos = kL + kRows * 4;
  static constexpr int kSmem = kPos + kRows * 4;
  static constexpr int kAcc = kRows * DMAX / kThreads;  // per thread
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
paged_attn_decode_kernel(const Args a) {
  using C = Decode<T, DMAX>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ks = reinterpret_cast<T*>(smem + C::kK);
  T* vs = reinterpret_cast<T*>(smem + C::kV);
  float* qs = reinterpret_cast<float*>(smem + C::kQ);
  float* ss = reinterpret_cast<float*>(smem + C::kS);
  float* alpha_s = reinterpret_cast<float*>(smem + C::kAlpha);
  float* m_s = reinterpret_cast<float*>(smem + C::kM);
  float* l_s = reinterpret_cast<float*>(smem + C::kL);
  int* pos_s = reinterpret_cast<int*>(smem + C::kPos);

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tile = blockIdx.z / a.n_splits;
  const int split = blockIdx.z % a.n_splits;
  const int nq = a.heads / a.kv_heads * a.L;
  const int n_rep = a.heads / a.kv_heads;
  const int r0 = tile * C::kRows;
  const int nr = min(C::kRows, nq - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = a.d;

  // The tile's positions and the keys through its largest.
  int qmax = 0;
  for (int r = 0; r < nr; ++r)
    qmax = max(qmax, load_index(a.q_pos, (size_t)b * a.L + (r0 + r) / n_rep));
  const int n_keys = min(a.W * a.page_tokens, qmax + 1);
  const int k_begin = split * a.keys_per_split;
  const int k_end = min(k_begin + a.keys_per_split, n_keys);
  // A split wholly past the tile's last key reads nothing and leaves
  // (m, l) = (-1e30, 0): the combine weighs it 0.
  const bool empty = k_begin >= k_end;
  const int n_tiles = empty ? 0 : (k_end - k_begin + C::kKeys - 1) / C::kKeys;
  if (!empty) {
    load_kv_tile(a, b, g, k_begin, k_end, C::kKeys, C::kStride, ks, vs);
    cp_async_commit();
  }

  const T* q = static_cast<const T*>(a.q);
  for (int idx = threadIdx.x; idx < (empty ? 0 : nr * d); idx += kThreads) {
    const int r = idx / d;
    qs[r * DMAX + idx % d] = to_f32(q[q_offset(a, b, g, r0 + r) + idx % d]);
  }
  if (threadIdx.x < nr)
    pos_s[threadIdx.x] =
        load_index(a.q_pos, (size_t)b * a.L + (r0 + threadIdx.x) / n_rep);

  float m[C::kRows / 4], l[C::kRows / 4];  // rows warp, warp + 4, ...
  float acc[C::kAcc];                      // entry threadIdx.x + 128 u
#pragma unroll
  for (int u = 0; u < C::kRows / 4; ++u) {
    m[u] = kNegInf;
    l[u] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < C::kAcc; ++u) acc[u] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv_tile(a, b, g, k_begin + (t + 1) * C::kKeys, k_end, C::kKeys,
                   C::kStride, ks + (stage ^ 1) * C::kKeys * C::kStride,
                   vs + (stage ^ 1) * C::kKeys * C::kStride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = k_begin + t * C::kKeys;
    const int nk = min(C::kKeys, k_end - k0);
    const T* kt = ks + stage * C::kKeys * C::kStride;
    const T* vt = vs + stage * C::kKeys * C::kStride;

    // Scores of the tile's keys against the live rows, scaled.
    for (int e = threadIdx.x; e < nr * C::kKeys; e += kThreads) {
      const int r = e / C::kKeys;
      const int j = e % C::kKeys;
      float s = 0.f;
      if (j < nk) {
        const float* qr = qs + r * DMAX;
        const T* kr = kt + j * C::kStride;
        for (int c = 0; c < d; c += 8) {
          float kx[8], qx[8];
          load8(kr + c, kx);
          load8(qr + c, qx);
#pragma unroll
          for (int u = 0; u < 8; ++u) s = fmaf(qx[u], kx[u], s);
        }
      }
      ss[r * C::kKeys + j] = s * a.scale;
    }
    __syncthreads();

    // Online softmax, one warp a row: masked keys take probability 0.
#pragma unroll
    for (int u = 0; u < C::kRows / 4; ++u) {
      const int r = warp + 4 * u;
      if (r < nr) {
        constexpr int kPer = (C::kKeys + 31) / 32;
        float sc[kPer];
        bool vis[kPer];
        float tmax = kNegInf;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int j = lane + 32 * v;
          vis[v] = j < nk && k0 + j <= pos_s[r];
          sc[v] = vis[v] ? ss[r * C::kKeys + j] : kNegInf;
          tmax = fmaxf(tmax, sc[v]);
        }
        const float m_new = fmaxf(m[u], warp_max(tmax));
        float psum = 0.f;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int j = lane + 32 * v;
          const float p = vis[v] ? expf(sc[v] - m_new) : 0.f;
          psum += p;
          if (j < C::kKeys) ss[r * C::kKeys + j] = p;
        }
        const float alpha = expf(m[u] - m_new);
        l[u] = l[u] * alpha + warp_sum(psum);
        m[u] = m_new;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the tile's keys.
#pragma unroll
    for (int u = 0; u < C::kAcc; ++u) {
      const int e = threadIdx.x + kThreads * u;
      const int r = e / DMAX;
      const int c = e % DMAX;
      if (r < nr && c < d) {
        const float* pr = ss + r * C::kKeys;
        float x = acc[u] * alpha_s[r];
        for (int j = 0; j < nk; ++j)
          x = fmaf(pr[j], to_f32(vt[j * C::kStride + c]), x);
        acc[u] = x;
      }
    }
    __syncthreads();  // the stage and the scores are reused next turn
  }

  // Each row's (m, l) and 1 / l (in the alpha slots) for the writers.
#pragma unroll
  for (int u = 0; u < C::kRows / 4; ++u) {
    const int r = warp + 4 * u;
    if (r < nr && lane == 0) {
      m_s[r] = m[u];
      l_s[r] = l[u];
      alpha_s[r] = recip(l[u]);
    }
  }
  __syncthreads();
  if (a.n_splits == 1) {
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int u = 0; u < C::kAcc; ++u) {
      const int e = threadIdx.x + kThreads * u;
      const int r = e / DMAX;
      const int c = e % DMAX;
      if (r < nr && c < d)
        out[q_offset(a, b, g, r0 + r) + c] =
            from_f32<T>(acc[u] * alpha_s[r]);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < C::kAcc; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int r = e / DMAX;
    const int c = e % DMAX;
    if (!empty && r < nr && c < d)
      a.ws_acc[(ws_row(a, b, g, r0 + r) * a.n_splits + split) * d + c] =
          acc[u];
  }
  if (threadIdx.x < nr) {
    float* ml = a.ws_ml + 2 * (ws_row(a, b, g, r0 + threadIdx.x) *
                                   a.n_splits + split);
    ml[0] = m_s[threadIdx.x];
    ml[1] = l_s[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// chunk route: bf16 tensor-core tiles (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory plan of the chunk route (bytes; the launch plan states the
// same): the 64-row Q tile and two stages of 64-key K and V tiles, rows
// padded by 16 bytes (ldmatrix's eight row addresses then fall on
// distinct banks), and the tile's positions. 46,336 / 87,296 / 169,216
// bytes at d = 64 / 128 / 256.
template <int DMAX>
struct Chunk {
  static constexpr int kRows = 64;  // query rows: four warps of 16
  static constexpr int kKeys = 64;  // keys per K/V tile
  static constexpr int kStride = DMAX + 8;  // elements
  static constexpr int kTile = 64 * kStride * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + 2 * kTile;
  static constexpr int kPos = kV + 2 * kTile;
  static constexpr int kSmem = kPos + kRows * 4;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
paged_attn_chunk_kernel(const Args a) {
  using C = Chunk<DMAX>;
  constexpr int S = C::kStride;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + C::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + C::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + C::kV);
  int* pos_s = reinterpret_cast<int*>(smem + C::kPos);

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tile = blockIdx.z / a.n_splits;
  const int split = blockIdx.z % a.n_splits;
  const int n_rep = a.heads / a.kv_heads;
  const int nq = n_rep * a.L;
  const int r0 = tile * C::kRows;
  const int nr = min(C::kRows, nq - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = a.d;

  // Positions of the tile's rows (-1 past its last: never visible).
  if (threadIdx.x < C::kRows)
    pos_s[threadIdx.x] =
        threadIdx.x < nr
            ? load_index(a.q_pos, (size_t)b * a.L + (r0 + threadIdx.x) / n_rep)
            : -1;
  __syncthreads();
  int qmax = 0;
  for (int r = 0; r < nr; ++r) qmax = max(qmax, pos_s[r]);
  const int n_keys = min(a.W * a.page_tokens, qmax + 1);
  const int k_begin = split * a.keys_per_split;
  const int k_end = min(k_begin + a.keys_per_split, n_keys);
  // A split wholly past the tile's last key reads nothing and leaves
  // (m, l) = (-1e30, 0): the combine weighs it 0.
  const bool empty = k_begin >= k_end;
  const int n_tiles = empty ? 0 : (k_end - k_begin + C::kKeys - 1) / C::kKeys;

  // The Q tile (zeros past the last row) and the first K/V tile in one
  // group; a head dim that is not a multiple of 16 reads zero columns up
  // to the next one in every tile.
  const bf16* q = static_cast<const bf16*>(a.q);
  const int per_row = d / 8;
  for (int ch = threadIdx.x; ch < (empty ? 0 : C::kRows * per_row);
       ch += kThreads) {
    const int r = ch / per_row;
    const int c = (ch % per_row) * 8;
    const bool live = r < nr;
    cp_async16(qs + r * S + c, live ? q + q_offset(a, b, g, r0 + r) + c : q,
               live ? 16 : 0);
  }
  const int d16 = (d + 15) / 16 * 16;
  if (d16 != d)
    for (int r = threadIdx.x; r < 5 * C::kRows; r += kThreads)
      *reinterpret_cast<uint4*>(qs + r * S + d) = make_uint4(0, 0, 0, 0);
  if (!empty) {
    load_kv_tile(a, b, g, k_begin, k_end, C::kKeys, S, ks, vs);
    cp_async_commit();
  }

  // This thread's rows of the warp's 16: a = lane / 4 and b = a + 8.
  const int wr = warp * 16;
  const int pos_a = pos_s[wr + lane / 4];
  const int pos_b = pos_s[wr + lane / 4 + 8];
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[DMAX / 8][4];
#pragma unroll
  for (int nt = 0; nt < DMAX / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv_tile(a, b, g, k_begin + (t + 1) * C::kKeys, k_end, C::kKeys,
                   S, ks + (stage ^ 1) * C::kKeys * S,
                   vs + (stage ^ 1) * C::kKeys * S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = k_begin + t * C::kKeys;
    const bf16* kt = ks + stage * C::kKeys * S;
    const bf16* vt = vs + stage * C::kKeys * S;

    // S = Q K^T: 16 rows x 64 keys a warp, eight n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < d) {
        uint32_t af[4];
        ldmatrix_x4(af, qs + (wr + lane % 16) * S + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * S +
                              kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], af, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }

    // Online softmax on the accumulators: row a in s[.][0..1], row b in
    // s[.][2..3]; a row's 64 scores lie in the four threads of a quad.
    float tmax_a = kNegInf, tmax_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        const bool vis = key < k_end && key <= (e < 2 ? pos_a : pos_b);
        s[nt][e] = vis ? s[nt][e] * a.scale : -INFINITY;
        if (e < 2) tmax_a = fmaxf(tmax_a, s[nt][e]);
        else tmax_b = fmaxf(tmax_b, s[nt][e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tmax_a = fmaxf(tmax_a, __shfl_xor_sync(kFull, tmax_a, off));
      tmax_b = fmaxf(tmax_b, __shfl_xor_sync(kFull, tmax_b, off));
    }
    const float mn_a = fmaxf(m_a, tmax_a), mn_b = fmaxf(m_b, tmax_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // -inf marks a masked key: probability 0 outright.
        const float p = s[nt][e] == -INFINITY
                            ? 0.f
                            : expf(s[nt][e] - (e < 2 ? mn_a : mn_b));
        s[nt][e] = p;
        if (e < 2) ps_a += p;
        else ps_b += p;
      }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt) {
      o[nt][0] *= al_a;
      o[nt][1] *= al_a;
      o[nt][2] *= al_b;
      o[nt][3] *= al_b;
    }

    // O += P V: P's accumulators as bf16 A operands (k-step kk from
    // n-tiles 2kk, 2kk + 1), V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        if (np * 16 < d) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + (kk * 16 + ((lane / 8) % 2) * 8 +
                                      lane % 8) * S +
                                    np * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is reused next turn
  }

  // A row's sum from its quad; then the output or the partial.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const int ia = r0 + wr + lane / 4;
  const int ib = ia + 8;
  const int col0 = 2 * (lane % 4);
  if (a.n_splits == 1) {
    bf16* out = static_cast<bf16*>(a.out);
    const float inv_a = recip(l_a);
    const float inv_b = recip(l_b);
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt) {
      const int c = nt * 8 + col0;
      if (c < d) {
        if (ia < r0 + nr)
          *reinterpret_cast<__nv_bfloat162*>(out + q_offset(a, b, g, ia) +
                                             c) =
              __floats2bfloat162_rn(o[nt][0] * inv_a, o[nt][1] * inv_a);
        if (ib < r0 + nr)
          *reinterpret_cast<__nv_bfloat162*>(out + q_offset(a, b, g, ib) +
                                             c) =
              __floats2bfloat162_rn(o[nt][2] * inv_b, o[nt][3] * inv_b);
      }
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < DMAX / 8; ++nt) {
    const int c = nt * 8 + col0;
    if (!empty && c < d) {
      if (ia < r0 + nr)
        *reinterpret_cast<float2*>(
            a.ws_acc + (ws_row(a, b, g, ia) * a.n_splits + split) * d + c) =
            make_float2(o[nt][0], o[nt][1]);
      if (ib < r0 + nr)
        *reinterpret_cast<float2*>(
            a.ws_acc + (ws_row(a, b, g, ib) * a.n_splits + split) * d + c) =
            make_float2(o[nt][2], o[nt][3]);
    }
  }
  if (lane % 4 == 0) {
    if (ia < r0 + nr) {
      float* ml = a.ws_ml + 2 * (ws_row(a, b, g, ia) * a.n_splits + split);
      ml[0] = m_a;
      ml[1] = l_a;
    }
    if (ib < r0 + nr) {
      float* ml = a.ws_ml + 2 * (ws_row(a, b, g, ib) * a.n_splits + split);
      ml[0] = m_b;
      ml[1] = l_b;
    }
  }
}

// ---------------------------------------------------------------------------
// combine: the splits of each query row, in split order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_combine_kernel(const Args a, int rows) {
  constexpr int kCols = 256 / 32;  // columns a lane owns, d <= 256
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (size_t)rows) return;
  const int d = a.d;
  const float* ml = a.ws_ml + 2 * row * a.n_splits;
  // Every split's (m, l) at once, 32 splits a turn: the max, then each
  // split's weight e^(m_s - M) (0 for an empty split) and the sum of l.
  float mt = kNegInf;
  for (int s0 = 0; s0 < a.n_splits; s0 += 32)
    if (s0 + lane < a.n_splits) mt = fmaxf(mt, ml[2 * (s0 + lane)]);
  mt = warp_max(mt);
  float lt = 0.f, acc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
  for (int s0 = 0; s0 < a.n_splits; s0 += 32) {
    const int sl = s0 + lane;
    const float ls = sl < a.n_splits ? ml[2 * sl + 1] : 0.f;
    const float f = ls > 0.f ? expf(ml[2 * sl] - mt) : 0.f;
    lt += warp_sum(ls * f);
    // acc in split order; an empty split's acc (never written) is read
    // but not used, so the loads need not wait on the weights.
    const int n = min(32, a.n_splits - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float fj = __shfl_sync(kFull, f, j);
      const float* src = a.ws_acc + (row * a.n_splits + s0 + j) * d;
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (lane + 32 * u < d) {
          const float v = src[lane + 32 * u];
          if (fj > 0.f) acc[u] = fmaf(v, fj, acc[u]);
        }
    }
  }
  const int nq = a.heads / a.kv_heads * a.L;
  const int i = (int)(row % nq);
  const int g = (int)(row / nq % a.kv_heads);
  const int b = (int)(row / nq / a.kv_heads);
  T* out = static_cast<T*>(a.out) + q_offset(a, b, g, i);
  const float inv = recip(lt);
#pragma unroll
  for (int u = 0; u < kCols; ++u)
    if (lane + 32 * u < d) out[lane + 32 * u] = from_f32<T>(acc[u] * inv);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The build's (tile rows, keys per tile, shared-memory bytes) of a route,
// dtype and column instance; {0, 0, 0} where none is built.
template <typename T, int DMAX>
int3 build_of(int route) {
  if (route == kRouteDecode) {
    using C = Decode<T, DMAX>;
    return make_int3(C::kRows, C::kKeys, C::kSmem);
  }
  if constexpr (sizeof(T) == 2) {
    using C = Chunk<DMAX>;
    return make_int3(C::kRows, C::kKeys, C::kSmem);
  }
  return make_int3(0, 0, 0);
}

// Allow `smem` bytes of dynamic shared memory once per kernel and device
// (`set` is the caller's, one per instance): later launches, and launches
// under CUDA graph capture, call no attribute API.
template <typename K>
void allow_smem(K* kernel, int smem, bool (&set)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && set[dev]) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if (dev >= 0 && dev < 64) set[dev] = true;
}

template <typename T, int DMAX>
int launch(const Args& a, int batch, int route, int q_tiles, int smem,
           cudaStream_t stream) {
  const dim3 grid(batch, a.kv_heads, q_tiles * a.n_splits);
  if (route == kRouteDecode) {
    static bool set[64] = {};
    auto* kernel = paged_attn_decode_kernel<T, DMAX>;
    allow_smem(kernel, smem, set);
    kernel<<<grid, kThreads, smem, stream>>>(a);
  } else if constexpr (sizeof(T) == 2) {
    static bool set[64] = {};
    auto* kernel = paged_attn_chunk_kernel<DMAX>;
    allow_smem(kernel, smem, set);
    kernel<<<grid, kThreads, smem, stream>>>(a);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0 || a.n_splits == 1) return rc;
  const int rows = batch * a.heads * a.L;  // b * kv_heads * n_rep * L
  const int per_block = kThreads / 32;
  paged_attn_combine_kernel<T><<<(rows + per_block - 1) / per_block, kThreads,
                                 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int dmax, const Args& a, int batch, int route, int tile_rows,
                 int tile_keys, int smem, cudaStream_t s) {
  int3 built;
  if (dmax == 64) built = build_of<T, 64>(route);
  else if (dmax == 128) built = build_of<T, 128>(route);
  else if (dmax == 256) built = build_of<T, 256>(route);
  else return kErrUnsupported;
  if (built.x == 0) return kErrUnsupported;
  if (built.x != tile_rows || built.y != tile_keys || built.z != smem ||
      a.keys_per_split % tile_keys)
    return kErrPlan;
  const int nq = a.heads / a.kv_heads * a.L;
  const int q_tiles = (nq + tile_rows - 1) / tile_rows;
  if ((long long)q_tiles * a.n_splits > 65535) return kErrPlan;
  if (dmax == 64) return launch<T, 64>(a, batch, route, q_tiles, smem, s);
  if (dmax == 128) return launch<T, 128>(a, batch, route, q_tiles, smem, s);
  return launch<T, 256>(a, batch, route, q_tiles, smem, s);
}

}  // namespace

// C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. q and out are
// contiguous [batch, L, heads, head_dim]; the pools [pool_pages,
// page_tokens, kv_heads, head_dim]; bt [batch, W] and q_pos [batch, L],
// int64; `ws` fp32 scratch of
// batch * heads * L * n_splits * (2 + head_dim) floats when n_splits > 1
// (else unused), all in device memory. head_dim must be a multiple of 8 and
// at most `dmax` (64, 128 or 256: the instance). The plan (route 0 decode /
// 1 chunk, tile rows, keys per tile, keys per split, splits, shared-memory
// bytes) comes from ops/paged_attention.py `paged_attn_plan`. Returns 0, the
// CUDA error of a launch, -1 for a dtype, dmax or route not built, or -2 for
// a plan that does not match the build or the shapes.
extern "C" int paged_attn(const void* q, const void* k_pages,
                          const void* v_pages, const void* bt,
                          const void* q_pos, void* out, void* ws, int batch,
                          int L, int heads, int kv_heads, int head_dim,
                          int dmax, int page_tokens, int W, int pool_pages,
                          int dtype, int route,
                          int tile_rows, int tile_keys, int keys_per_split,
                          int n_splits, int smem_bytes, float scale,
                          void* stream) {
  if (head_dim % 8 || head_dim > dmax || heads % kv_heads || L < 1 ||
      page_tokens < 1 || W < 1 || (route != kRouteDecode &&
                                   route != kRouteChunk))
    return kErrUnsupported;
  if (keys_per_split < 1 || n_splits < 1 ||
      (long long)n_splits * keys_per_split < (long long)W * page_tokens ||
      (long long)(n_splits - 1) * keys_per_split >=
          (long long)W * page_tokens ||
      (n_splits > 1 && ws == nullptr))
    return kErrPlan;
  const size_t rows = (size_t)batch * heads * L;
  float* wsf = static_cast<float*>(ws);
  const Args a{q, k_pages, v_pages, static_cast<const long long*>(bt),
               static_cast<const long long*>(q_pos), out, wsf,
               wsf == nullptr ? nullptr : wsf + 2 * rows * n_splits, L, heads,
               kv_heads, head_dim, page_tokens, W, pool_pages,
               keys_per_split, n_splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(dmax, a, batch, route, tile_rows, tile_keys,
                               smem_bytes, s);
  if (dtype == 1)
    return launch_typed<bf16>(dmax, a, batch, route, tile_rows, tile_keys,
                              smem_bytes, s);
  return kErrUnsupported;
}
