// Flash-attention forward for Hopper (sm_90a), CUDA C++: kernel B1.
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
//   thread block owns one (batch*head, q tile) and loops over the K/V
//   tiles itself.
// - Causal blocks stop at the diagonal instead of clamping the fetch
//   index: tiles above it are never loaded.
// - LSE is written as one fp32 per row, not a 128-lane broadcast (that
//   layout was a Mosaic constraint), and the head dim is not padded to
//   128: d = 64, 128 and 256 are compiled as they are.
// - Any sequence length: the ragged last tile is masked (q rows past the
//   end are not stored, keys past the end are masked out).
// - GQA without expanding K/V: q head h reads kv head h / (heads /
//   kv_heads), the repeat_kv order of models/transformer.py.
//
// What bounds it on an H100: at the training shape [8, 8, 2048, 128] bf16
// causal it does 68.7 GFLOP of products, 0.069 ms at the 989 TFLOP/s bf16
// tensor-core rate, against ~0.03 ms to move its bytes: compute-bound. At
// the serving shape [4, 16, 1024, 64] the two are close (0.010 ms of
// bytes, 0.009 ms of products).
//
// Two kernels, by input type:
// - bfloat16, built for Hopper's tensor cores. A block owns 128 q rows and
//   runs three warpgroups. One producer thread issues TMA loads (Q once,
//   then K and V tiles of 128 keys, 64 at d = 256, into a ring of stages,
//   completion on mbarriers); two consumer warpgroups of 64 q rows each
//   compute, so copies overlap products. setmaxnreg moves registers from
//   the producer to the consumers. S = Q K^T is a wgmma with both operands
//   in shared memory (K-major); the softmax runs on the fp32 accumulator
//   in base 2 with scale * log2(e) folded into one FFMA per score; P is
//   rounded to bf16 and repacked in registers as the A operand of
//   O += P V, whose B operand is V read MN-major from the same swizzled
//   tile (no transposed copy). Only the diagonal tile and the ragged last
//   tile are masked. Which q tile a block owns and which K/V tiles it
//   loops over come from the launch plan's schedule (ops/attention.py
//   `flash_fwd_plan`), one int4 per block: it launches the heaviest causal
//   tiles first, so the short ones fill the tail.
// - float32: FP32 FMA on the CUDA cores (a tensor-core product would be
//   TF32 and lose the float32 reference's precision). 256 threads, a
//   64x64 score tile, each thread a 4x4 micro-tile of scores and a
//   4 x (d/16) slice of the accumulator; Q^T and K^T sit transposed in
//   shared memory so the score loop reads float4 rows without bank
//   conflicts. At d = 256 its tiles take 214,016 bytes of shared memory,
//   within the 232,448 a block may use.
// Times against the bound are in PERF.md.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBQ = 64;            // float32: query rows per block
constexpr int kBK = 64;            // float32: keys per K/V tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kTileQ = 64 * kConsumers;  // q rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan (byte offsets; operand tiles 1024-byte aligned). The
// launch plan in ops/attention.py (`flash_fwd_plan`) states the same
// numbers and the entry point refuses a plan that disagrees.
template <int D>
struct FwdPlan {
  // Keys per K/V stage: 128, and 64 at d = 256, where a consumer's O
  // accumulator alone is 128 fp32 registers (64 rows x 256 over 128
  // threads); 64 keys keep S (32) and P's bf16 operands (16) beside it
  // within 240 registers.
  static constexpr int kTileK = D == 256 ? 64 : 128;
  // As many stages as fit beside Q: 148,552 / 230,456 / 197,672 bytes at
  // d = 64 / 128 / 256.
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int kQBytes = kTileQ * D * 2;
  static constexpr int kKVBytes = kTileK * D * 2;  // one K (or V) stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // + barriers, + slack to align the dynamic window to 1024 bytes
  static constexpr int kSmem = 1024 + kBar + (2 * kStages + 1) * 8;
};

template <int D, bool CAUSAL>
__global__ void __maxnreg__(kEntryRegs)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      const int4* __restrict__ schedule, int heads,
                      int kv_heads, int seq_q, int seq_k, float scale) {
  using P = FwdPlan<D>;
  constexpr int kTileK = P::kTileK;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = tma_smem + ((1024 - (smem_u32(tma_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* empty = full + P::kStages;
  uint64_t* qbar = empty + P::kStages;

  // This block's work, from the launch plan: (b*h, q tile, first K/V tile,
  // end K/V tile).
  const int4 work = __ldg(schedule + blockIdx.x);
  const int bh = work.x;
  const int q0 = work.y * kTileQ;
  const int b = bh / heads;
  const int bkv = b * kv_heads + (bh - b * heads) / (heads / kv_heads);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    // Producer warpgroup: one thread keeps the ring of K/V stages full.
    regs_shrink<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(qbar, P::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(smem + P::kQ + c * kTileQ * 128, &tq, qbar, c * 64, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = work.z; kt < work.w; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * P::kKVBytes);
        uint8_t* ks = smem + P::kK + stage * P::kKVBytes;
        uint8_t* vs = smem + P::kV + stage * P::kKVBytes;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(ks + c * kTileK * 128, &tk, &full[stage], c * 64,
                   kt * kTileK, bkv);
          tma_load(vs + c * kTileK * 128, &tv, &full[stage], c * 64,
                   kt * kTileK, bkv);
        }
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: q rows q0 + 64 wg .. + 63. Each thread holds
    // two rows (lo, hi = lo + 8) of the wgmma accumulator layout.
    regs_grow<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int row_hi = row_lo + 8;
    const int cp = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint8_t* qs = smem + P::kQ + wg * 64 * 128;

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = work.z; kt < work.w; ++kt) {
      const int k0 = kt * kTileK;
      const uint8_t* ks = smem + P::kK + stage * P::kKVBytes;
      const uint8_t* vs = smem + P::kV + stage * P::kKVBytes;
      mbar_wait(&full[stage], phase);

      // S = Q K^T, both K-major in shared memory.
      float s[kTileK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kTileK, 0>(
            s,
            desc_sw128(qs + (kk / 4) * kTileQ * 128 + (kk % 4) * 32, 16, 1024),
            desc_sw128(ks + (kk / 4) * kTileK * 128 + (kk % 4) * 32, 16, 1024),
            kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      // Mask only the tile on the diagonal and the ragged last tile.
      if ((CAUSAL && k0 + kTileK - 1 > q0) || k0 + kTileK > seq_k) {
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + cp + e;
            if (key >= seq_k || (CAUSAL && key > row_lo))
              s[4 * j + e] = -INFINITY;
            if (key >= seq_k || (CAUSAL && key > row_hi))
              s[4 * j + 2 + e] = -INFINITY;
          }
      }

      // Online softmax in base 2: p = 2^(s * scale * log2(e) - m').
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // A row that has seen no key yet keeps -inf; offset it by 0 so its
      // probabilities come out 0, not NaN.
      const float ms_lo = mx_lo == -INFINITY ? 0.f : mx_lo * sl2;
      const float ms_hi = mx_hi == -INFINITY ? 0.f : mx_hi * sl2;
      const float a_lo = exp2_approx(m_lo * sl2 - ms_lo);
      const float a_hi = exp2_approx(m_hi * sl2 - ms_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= a_lo;  // this thread's share of the row sum
      l_hi *= a_hi;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], sl2, -ms_lo));
          s[4 * j + 2 + e] = exp2_approx(fmaf(s[4 * j + 2 + e], sl2, -ms_hi));
          l_lo += s[4 * j + e];
          l_hi += s[4 * j + 2 + e];
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= a_lo;
        acc[4 * j + 1] *= a_lo;
        acc[4 * j + 2] *= a_hi;
        acc[4 * j + 3] *= a_hi;
      }

      // O += P V: P from registers (bf16), V MN-major from shared memory.
      uint32_t p[kTileK / 16][4];
      acc_to_a<kTileK>(p, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk)
        wgmma_rs_mn<D>(acc, p[kk], vs + kk * 2048, kTileK * 128);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      if (t == 0) mbar_arrive(&empty[stage]);
      if (++stage == P::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // O = acc / max(l, 1e-30); LSE = m * scale + log(max(l, 1e-30)).
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float d_lo = fmaxf(l_lo, 1e-30f);
    const float d_hi = fmaxf(l_hi, 1e-30f);
    const float inv_lo = 1.f / d_lo;
    const float inv_hi = 1.f / d_hi;
    bf16* o_lo = o + ((size_t)bh * seq_q + row_lo) * D;
    bf16* o_hi = o_lo + 8 * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cp;
      if (row_lo < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
      if (row_hi < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(o_hi + col) = __floats2bfloat162_rn(
            acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
    }
    if (lane % 4 == 0) {
      if (row_lo < seq_q)
        lse[(size_t)bh * seq_q + row_lo] = m_lo * scale + logf(d_lo);
      if (row_hi < seq_q)
        lse[(size_t)bh * seq_q + row_hi] = m_hi * scale + logf(d_hi);
    }
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

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int heads, int kv_heads, int seq_q,
               int seq_k, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D, CAUSAL>;
  const size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq_q + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, heads,
      kv_heads, seq_q, seq_k, scale);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int heads, int kv_heads, int seq_q,
                int seq_k, const int* plan, const int* schedule, float scale,
                cudaStream_t stream) {
  using P = FwdPlan<D>;
  if (plan[0] != kTileQ || plan[1] != P::kTileK || plan[2] != P::kStages ||
      plan[3] != P::kSmem || plan[4] <= 0 || schedule == nullptr)
    return kErrPlan;
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = make_map_bf16(&tq, q, D, seq_q, batch * heads, kTileQ)) ||
      (err = make_map_bf16(&tk, k, D, seq_k, batch * kv_heads, P::kTileK)) ||
      (err = make_map_bf16(&tv, v, D, seq_k, batch * kv_heads, P::kTileK)))
    return err;
  auto kernel = flash_fwd_bf16_kernel<D, CAUSAL>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<plan[4], kThreads, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse,
      reinterpret_cast<const int4*>(schedule), heads, kv_heads, seq_q, seq_k,
      scale);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_typed(int dtype, const void* q, const void* k, const void* v,
                 void* o, float* lse, int batch, int heads, int kv_heads,
                 int seq_q, int seq_k, const int* plan, const int* schedule,
                 float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D, CAUSAL>(q, k, v, o, lse, batch, heads, kv_heads,
                                 seq_q, seq_k, scale, s);
  if (dtype == 1)
    return launch_bf16<D, CAUSAL>(q, k, v, o, lse, batch, heads, kv_heads,
                                  seq_q, seq_k, plan, schedule, scale, s);
  return kErrUnsupported;
}

template <int D>
int launch_dim(int dtype, int causal, const void* q, const void* k,
               const void* v, void* o, float* lse, int batch, int heads,
               int kv_heads, int seq_q, int seq_k, const int* plan,
               const int* schedule, float scale, cudaStream_t s) {
  return causal ? launch_typed<D, true>(dtype, q, k, v, o, lse, batch, heads,
                                        kv_heads, seq_q, seq_k, plan,
                                        schedule, scale, s)
                : launch_typed<D, false>(dtype, q, k, v, o, lse, batch, heads,
                                         kv_heads, seq_q, seq_k, plan,
                                         schedule, scale, s);
}

}  // namespace

// C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. Inputs are
// contiguous [batch, heads, seq_q, d] (q, o) and [batch, kv_heads, seq_k, d]
// (k, v); lse is [batch, heads, seq_q] fp32. The bfloat16 kernel's launch
// plan comes from ops/attention.py: q rows per block, keys per stage,
// stages and shared-memory bytes, which must match this build, and the
// schedule, `blocks` int4s in device memory (b*h, q tile, first and end K/V
// tile), one per block in launch order. float32 takes none (0s, NULL).
// Returns 0, the CUDA error of the launch, or a negative hopper::kErr* code.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* schedule, int batch, int heads,
                         int kv_heads, int seq_q, int seq_k, int head_dim,
                         int dtype, int causal, int block_q, int block_k,
                         int stages, int smem_bytes, int blocks, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plan[5] = {block_q, block_k, stages, smem_bytes, blocks};
  if (head_dim == 64)
    return launch_dim<64>(dtype, causal, q, k, v, o, lse, batch, heads,
                          kv_heads, seq_q, seq_k, plan, schedule, scale, s);
  if (head_dim == 128)
    return launch_dim<128>(dtype, causal, q, k, v, o, lse, batch, heads,
                           kv_heads, seq_q, seq_k, plan, schedule, scale, s);
  if (head_dim == 256)
    return launch_dim<256>(dtype, causal, q, k, v, o, lse, batch, heads,
                           kv_heads, seq_q, seq_k, plan, schedule, scale, s);
  return hopper::kErrUnsupported;
}
