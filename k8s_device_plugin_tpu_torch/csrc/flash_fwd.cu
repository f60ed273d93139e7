// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel k8s_device_plugin_tpu/ops/attention.py
// `_flash_forward` -> `_attn_kernel` (the forward grid cell, pallas_call at
// attention.py:192). It computes what that kernel computes: softmax(QK^T *
// scale) V with an online (running max / running sum) softmax over K/V
// tiles, fp32 statistics and accumulation, O in the input dtype, and the
// per-row logsumexp LSE = m + log(l) in fp32.
//
// What differs from the TPU kernel, and why:
// - The TPU walks the k-block grid axis in order and carries m/l/acc in
//   VMEM scratch across grid steps. Blocks here run in no order, so one
//   thread block owns one (batch*head, 64-row q tile) and loops over the
//   K/V tiles itself.
// - Causal blocks stop at the diagonal instead of clamping the fetch
//   index: tiles above it are never loaded.
// - LSE is written as one fp32 per row, not a 128-lane broadcast (that
//   layout was a Mosaic constraint), and the head dim is not padded to
//   128: d = 64 and d = 128 are compiled as they are.
// - Any sequence length: the ragged last tile is masked (q rows past the
//   end are not stored, keys past the end score -1e30).
// - GQA without expanding K/V: q head h reads kv head h / (heads /
//   kv_heads), the repeat_kv order of models/transformer.py.
//
// What bounds it on an H100: at [4, 16, 1024, 64] bf16 causal it must move
// about 34 MB (Q, K, V read once, O written once), about 10 us at 3.35 TB/s,
// and do about 8.6 GFLOP of products (4.3 GFLOP causal), about 9 us (4 us)
// at the 989 TFLOP/s bf16 tensor-core rate: memory-bound at the roofline.
//
// Two kernels, by input type:
// - bfloat16 (the serving path): tensor cores through mma.sync m16n8k16.
//   Four warps own 16 query rows each; Q stays in registers as A
//   fragments, S = QK^T lands in fp32 accumulators, the softmax runs on
//   those registers (row statistics reduced across the four lanes that
//   share a row), and P is repacked to bf16 in registers as the A operand
//   of PV — the score tile never touches shared memory. K/V tiles are
//   staged in shared memory with plain 16-byte loads; wgmma, TMA and
//   pipelined copies are later work.
// - float32: FP32 FMA on the CUDA cores (a tensor-core product would be
//   TF32 and lose the float32 reference's precision). 256 threads, a
//   64x64 score tile, each thread a 4x4 micro-tile of scores and a
//   4 x (d/16) slice of the accumulator; Q^T and K^T sit transposed in
//   shared memory so the score loop reads float4 rows without bank
//   conflicts.
// Times against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per K/V tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 (fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, K, V tiles of [64][D + 8] bf16 (8 elements of padding per row
  // spread the fragment loads over all banks)
  return sizeof(__nv_bfloat16) * 3 * kBQ * (D + 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of a [rows, D] bf16 matrix into a [64][D + 8]
// shared tile, 16 bytes per load, zeros past `rows`.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int S = D + 8;
  for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kMmaThreads) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * S + c) = x;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int heads, int kv_heads, int seq_q, int seq_k,
                      float scale) {
  constexpr int S = D + 8;     // shared row stride, elements
  constexpr int KS = D / 16;   // k-steps of QK^T
  constexpr int NT = kBK / 8;  // score n-tiles (8 keys each)
  constexpr int DT = D / 8;    // output n-tiles (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * S;
  __nv_bfloat16* vs = ks + kBK * S;
  const unsigned short* vh = reinterpret_cast<const unsigned short*>(vs);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;   // fragment column pair
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const size_t kv_off = (size_t)(b * kv_heads + kvh) * seq_k * D;
  const __nv_bfloat16* kp = k + kv_off;
  const __nv_bfloat16* vp = v + kv_off;

  load_tile<D>(qs, q + (size_t)bh * seq_q * D, q0, seq_q);
  __syncthreads();
  // This warp's 16 query rows as A fragments, one set per k-step.
  const int r0 = warp * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = qs + r0 * S + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * S);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * S + 8);
  }

  // Each lane holds two rows of the warp's 16: g ("lo") and g + 8 ("hi").
  const int row_lo = q0 + r0;
  const int row_hi = row_lo + 8;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[dt][j] = 0.f;

  const int k_end = CAUSAL ? min(seq_k, q0 + kBQ) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, kp, k0, seq_k);
    load_tile<D>(vs, vp, k0, seq_k);
    __syncthreads();

    // S = Q K^T: B fragment (k = d, n = key) is K row-major, read as pairs.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* p = ks + (nt * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], ld32(p), ld32(p + 8));
      }
    }

    // Scale, mask, and the online softmax on the accumulators.
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + nt * 8 + 2 * t + j;
        const bool in = kc < seq_k;
        s[nt][j] = (in && (!CAUSAL || kc <= row_lo)) ? s[nt][j] * scale
                                                     : kNegInf;
        s[nt][2 + j] = (in && (!CAUSAL || kc <= row_hi))
                           ? s[nt][2 + j] * scale
                           : kNegInf;
        mx_lo = fmaxf(mx_lo, s[nt][j]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo);
    const float a_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - mn_lo);
        s[nt][2 + j] = expf(s[nt][2 + j] - mn_hi);
        sum_lo += s[nt][j];
        sum_hi += s[nt][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= a_lo;
      oacc[dt][1] *= a_lo;
      oacc[dt][2] *= a_hi;
      oacc[dt][3] *= a_hi;
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are
    // exactly the A fragment of k-step kk; the B fragment (k = key,
    // n = d) pairs two V rows of one column.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = (uint32_t)vh[key * S + col] |
                            ((uint32_t)vh[(key + 1) * S + col] << 16);
        const uint32_t b1 = (uint32_t)vh[(key + 8) * S + col] |
                            ((uint32_t)vh[(key + 9) * S + col] << 16);
        mma_bf16(oacc[dt], pa, b0, b1);
      }
    }
  }

  // O = acc / max(l, 1e-30); LSE = m + log(max(l, 1e-30)).
  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* o_lo = o + ((size_t)bh * seq_q + row_lo) * D;
  __nv_bfloat16* o_hi = o_lo + 8 * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_lo < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
          __floats2bfloat162_rn(oacc[dt][0] / d_lo, oacc[dt][1] / d_lo);
    if (row_hi < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + col) =
          __floats2bfloat162_rn(oacc[dt][2] / d_hi, oacc[dt][3] / d_hi);
  }
  if (t == 0) {
    if (row_lo < seq_q) lse[(size_t)bh * seq_q + row_lo] = m_lo + logf(d_lo);
    if (row_hi < seq_q) lse[(size_t)bh * seq_q + row_hi] = m_hi + logf(d_hi);
  }
}

// ---------------------------------------------------------------------------
// float32: FP32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

template <int D>
constexpr size_t fma_smem_bytes() {
  // Q^T [D][BQ], K^T [D][BK], V [BK][D], scores [BQ][BK+1], m/l/alpha [BQ]
  return sizeof(float) *
         (D * kBQ + D * kBK + kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int kv_heads,
                     int seq_q, int seq_k, float scale) {
  constexpr int NC = D / 64;  // 64-wide column groups of the accumulator
  extern __shared__ float smem[];
  float* qt = smem;                     // [D][BQ], pre-scaled
  float* kt = qt + D * kBQ;             // [D][BK]
  float* vs = kt + D * kBK;             // [BK][D]
  float* ss = vs + kBK * D;             // [BQ][BK+1]: scores, then probs
  float* row_m = ss + kBQ * (kBK + 1);  // running max
  float* row_l = row_m + kBQ;           // running sum
  float* row_a = row_l + kBQ;           // this tile's correction factor

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns / output columns
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const float* qp = q + (size_t)bh * seq_q * D;
  const size_t kv_off = (size_t)(b * kv_heads + kvh) * seq_k * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;

  // Q tile, transposed and pre-scaled (as the TPU kernel scales q).
  for (int idx = tid; idx < kBQ * (D / 4); idx += kFmaThreads) {
    const int r = idx % kBQ;
    const int c = (idx / kBQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < seq_q)
      x = *reinterpret_cast<const float4*>(qp + (size_t)(q0 + r) * D + c);
    qt[(c + 0) * kBQ + r] = x.x * scale;
    qt[(c + 1) * kBQ + r] = x.y * scale;
    qt[(c + 2) * kBQ + r] = x.z * scale;
    qt[(c + 3) * kBQ + r] = x.w * scale;
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  float acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;

  // Causal: keys past the tile's last query row are all masked.
  const int k_end = CAUSAL ? min(seq_k, q0 + kBQ) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * (D / 4); idx += kFmaThreads) {
      const int r = idx % kBK;
      const int c = (idx / kBK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < seq_k)
        x = *reinterpret_cast<const float4*>(kp + (size_t)(k0 + r) * D + c);
      kt[(c + 0) * kBK + r] = x.x;
      kt[(c + 1) * kBK + r] = x.y;
      kt[(c + 2) * kBK + r] = x.z;
      kt[(c + 3) * kBK + r] = x.w;
    }
    for (int idx = tid; idx < kBK * (D / 4); idx += kFmaThreads) {
      const int c = (idx % (D / 4)) * 4;
      const int r = idx / (D / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < seq_k)
        x = *reinterpret_cast<const float4*>(vp + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<float4*>(vs + r * D + c) = x;
    }
    __syncthreads();

    // S = (Q * scale) K^T for this thread's 4x4 micro-tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool keep = kj < seq_k && (!CAUSAL || kj <= qi);
        ss[(ty * 4 + i) * (kBK + 1) + tx * 4 + j] = keep ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: four lanes per row, sixteen columns each.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* srow = ss + r * (kBK + 1) + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    float p_scale[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p_scale[i] = row_a[ty * 4 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= p_scale[i];
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int gc = 0; gc < NC; ++gc) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + kk * D + gc * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][gc * 4 + 0] = fmaf(p[i], vv.x, acc[i][gc * 4 + 0]);
          acc[i][gc * 4 + 1] = fmaf(p[i], vv.y, acc[i][gc * 4 + 1]);
          acc[i][gc * 4 + 2] = fmaf(p[i], vv.z, acc[i][gc * 4 + 2]);
          acc[i][gc * 4 + 3] = fmaf(p[i], vv.w, acc[i][gc * 4 + 3]);
        }
      }
    }
  }
  __syncthreads();

  // O = acc / max(l, 1e-30); LSE = m + log(max(l, 1e-30)).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= seq_q) continue;
    const float denom = fmaxf(row_l[r], 1e-30f);
    float* orow = o + ((size_t)bh * seq_q + q0 + r) * D;
#pragma unroll
    for (int gc = 0; gc < NC; ++gc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[gc * 64 + tx * 4 + j] = acc[i][gc * 4 + j] / denom;
  }
  if (tid < kBQ && q0 + tid < seq_q) {
    lse[(size_t)bh * seq_q + q0 + tid] =
        row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const void* q,
           const void* k, const void* v, void* o, float* lse, int batch,
           int heads, int kv_heads, int seq_q, int seq_k, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq_q + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads, kv_heads,
      seq_q, seq_k, scale);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_typed(int dtype, const void* q, const void* k, const void* v,
                 void* o, float* lse, int batch, int heads, int kv_heads,
                 int seq_q, int seq_k, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float>(flash_fwd_f32_kernel<D, CAUSAL>, fma_smem_bytes<D>(),
                         kFmaThreads, q, k, v, o, lse, batch, heads, kv_heads,
                         seq_q, seq_k, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_fwd_bf16_kernel<D, CAUSAL>,
                                 mma_smem_bytes<D>(), kMmaThreads, q, k, v, o,
                                 lse, batch, heads, kv_heads, seq_q, seq_k,
                                 scale, s);
  return -1;
}

template <int D>
int launch_dim(int dtype, int causal, const void* q, const void* k,
               const void* v, void* o, float* lse, int batch, int heads,
               int kv_heads, int seq_q, int seq_k, float scale,
               cudaStream_t s) {
  return causal ? launch_typed<D, true>(dtype, q, k, v, o, lse, batch, heads,
                                        kv_heads, seq_q, seq_k, scale, s)
                : launch_typed<D, false>(dtype, q, k, v, o, lse, batch, heads,
                                         kv_heads, seq_q, seq_k, scale, s);
}

}  // namespace

// C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. Inputs are
// contiguous [batch, heads, seq_q, d] (q, o) and [batch, kv_heads, seq_k, d]
// (k, v); lse is [batch, heads, seq_q] fp32. Returns 0, the CUDA error of
// the launch, or -1 for a dtype / head dim this kernel does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int batch, int heads, int kv_heads,
                         int seq_q, int seq_k, int head_dim, int dtype,
                         int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dim<64>(dtype, causal, q, k, v, o, lse, batch, heads,
                          kv_heads, seq_q, seq_k, scale, s);
  if (head_dim == 128)
    return launch_dim<128>(dtype, causal, q, k, v, o, lse, batch, heads,
                           kv_heads, seq_q, seq_k, scale, s);
  return -1;
}
