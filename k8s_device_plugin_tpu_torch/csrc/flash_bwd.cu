// Flash-attention backward for Hopper (sm_90a), CUDA C++: kernels B3 (dQ)
// and B4 (dK/dV).
//
// Replaces the Pallas TPU kernels of k8s_device_plugin_tpu/ops/attention.py
// driven by `_flash_backward`:
// - B3 `_bwd_dq_kernel` (attention.py:221, pallas_call at :382):
//   dQ = scale * sum_k dS K;
// - B4 `_bwd_dkv_kernel` (attention.py:275, pallas_call at :413):
//   dV = sum_q P^T dO, dK = scale * sum_q dS^T Q.
// Both recompute the score tile from Q, K and the forward's saved
// logsumexp: S = scale * Q K^T (masked above the diagonal when causal),
// P = exp(S - LSE), dP = dO V^T, dS = P * (dP - delta), where
// delta = rowsum(dO * O) - g_lse comes in precomputed (the reference
// computes it in XLA outside its kernels; the port in plain torch).
//
// What differs from the TPU kernels, and why:
// - The TPU walks the reduction axis of each kernel as a sequential grid
//   dimension and carries the accumulator in VMEM scratch. Blocks here run
//   in no order, so each block owns its output tile and loops itself:
//   B3 one block per (batch*head, q tile), looping over K/V stages up to
//   the diagonal when causal; B4 one block per (batch, KV HEAD, key tile),
//   looping over that kv head's n_rep q heads and, when causal, over the
//   q steps from the diagonal on (the TPU's index-map clamps at :396-405
//   become loop bounds: skipped tiles are never loaded).
// - GQA: B4 sums the n_rep q heads that share a kv head inside the block,
//   in fp32 registers, so dK/dV come out unexpanded ([b, kv_heads, s, d]),
//   with no atomics and no expanded buffer: the result is deterministic.
//   B3 reads kv head h / n_rep in place, as the forward does, and one
//   block owns each dQ row: it is deterministic too.
// - LSE and delta are one fp32 per row ([b, h, s]); the TPU's 128-lane
//   broadcast of them (:366-367) was a Mosaic constraint.
// - Any sequence length: tiles straddling the ragged edge or the diagonal
//   mask inside (probabilities set to 0); rows past the end are not stored.
// - d = 64 and d = 128 are compiled as they are; the wrapper zero-pads
//   other head dims up to one of them (exact: zero lanes add nothing).
//
// What bounds them on an H100: at the flagship training shape
// [8, 8, 2048, 128] bf16 causal, B3 does three products (S, dP, dQ) and
// B4 four (S, dP, dV, dK), each 2*b*h*d*s(s+1)/2 FLOP: 0.104 ms and
// 0.139 ms at 989 TFLOP/s, against ~0.05 ms and ~0.06 ms to move their
// bytes at 3.35 TB/s. Both are compute-bound at the roofline.
//
// Implementations, by kernel and input type. The two bfloat16 kernels are
// built for Hopper's tensor cores on the pieces of hopper.cuh: a block of
// three warpgroups, one producer that issues TMA loads into a ring of
// shared-memory stages (completion on mbarriers) and two consumers of 64
// rows each that compute, so copies overlap products; setmaxnreg moves
// registers from the producer to the consumers. Which tile a block owns
// and which steps it loops over come from the launch plan's schedule
// (ops/attention.py), one int4 per block.
// - B3, bfloat16: the forward's pipeline (flash_fwd.cu) with one more
//   product. A block owns 128 q rows: Q and dO are loaded once by TMA,
//   then K and V stream through the ring in stages of keys up to the
//   diagonal. Per stage each consumer computes S = Q K^T and dP = dO V^T
//   with every operand K-major in shared memory, P = 2^(S * scale *
//   log2(e) - LSE * log2(e)) from the two rows' LSE and delta it holds in
//   registers, dS = P (dP - delta) rounded to bf16 and repacked in
//   registers as the A operand of dQ += dS K, whose B operand is K read
//   MN-major from the same swizzled stage. Only the diagonal stage and
//   the ragged last stage are masked; a stage wholly past a consumer's
//   rows is skipped. The schedule (`flash_bwd_dq_plan`) launches the
//   heaviest causal q tiles first, so the short ones fill the tail.
// - B4, bfloat16. A block owns 128 keys of one kv head: K and V are loaded
//   once by TMA; the producer warp then streams the Q and dO tiles of each
//   q step into the ring with the step's LSE (times log2(e)) and delta
//   beside them. The score tile is kept transposed, keys as the wgmma
//   M dimension: S^T = K Q^T and dP^T = V dO^T read every operand K-major
//   from shared memory; P^T = 2^(S^T * scale * log2(e) - LSE * log2(e)) and
//   dS^T = P^T (dP^T - delta) are rounded to bf16 and repacked in registers
//   as the A operands of dV += P^T dO and dK += dS^T Q, whose B operands
//   (dO, Q) are read MN-major from the same swizzled tiles. Only steps on
//   the diagonal are masked; a q row past the end has LSE = +inf, so its
//   probabilities are 0 without a mask. The schedule
//   (`flash_bwd_dkv_plan`) launches the lowest key tiles first, which own
//   the most q steps under a causal mask.
// - float32: FP32 FMA on the CUDA cores (tensor cores would be TF32), 256
//   threads each owning a 4x4 micro-tile of the 64x64 score tile, dS (and
//   P) passed through shared memory to the accumulating products.
// Times against the bound are in PERF.md.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Rows a float32 block owns: q rows (B3), keys (B4). Masked probabilities
// are set to 0 directly, which is what exp(-1e30 - LSE) gives the
// reference.
constexpr int kBlk = 64;

// ---------------------------------------------------------------------------
// B3, bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

// Both bfloat16 kernels: two consumer warpgroups of 64 rows and one
// producer warpgroup.
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

namespace dq {

using namespace hopper;

constexpr int kTileQ = 64 * kConsumers;  // q rows per block

// Shared-memory plan for K/V stages of BK keys in a ring of STAGES (byte
// offsets; operand tiles 1024-byte aligned): Q and dO of the block, then
// the K and V stages.
template <int D, int BK, int STAGES>
struct Plan {
  static constexpr int kStepK = BK;
  static constexpr int kStages = STAGES;
  static constexpr int kQBytes = kTileQ * D * 2;  // Q (or dO) of the block
  static constexpr int kKVBytes = BK * D * 2;     // one K (or V) stage
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + STAGES * kKVBytes;
  static constexpr int kBar = kV + STAGES * kKVBytes;
  // + barriers, + slack to align the dynamic window to 1024 bytes
  static constexpr int kSmem = 1024 + kBar + (2 * STAGES + 1) * 8;
};

// The build's plan at each head dim; `flash_bwd_dq_plan` in
// ops/attention.py states the same numbers and the entry point refuses a
// plan that disagrees. Keys per stage: at d = 128 a 64-key stage keeps a
// consumer's dQ accumulator (64 fp32), S and dP (32 fp32 each) and dS as
// bf16 A operands (16) within its 240 registers; at d = 64 the
// accumulator is half as large and a 128-key stage fits, and runs faster
// than a 64-key one. Stages: five at d = 128 (230,488 bytes) ran faster
// than three or four; at d = 64 three to six ran alike (ops/tune_dq.py,
// PERF.md).
template <int D>
using Build = Plan<D, D == 64 ? 128 : 64, D == 64 ? 4 : 5>;

template <int D, int BK, int STAGES, bool CAUSAL>
__global__ void __maxnreg__(kEntryRegs)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   const int4* __restrict__ schedule, int heads,
                   int kv_heads, int seq_q, int seq_k, float scale) {
  using P = Plan<D, BK, STAGES>;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = tma_smem + ((1024 - (smem_u32(tma_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // This block's work, from the launch plan: (b*h, q tile, first K/V
  // stage, end K/V stage).
  const int4 work = __ldg(schedule + blockIdx.x);
  const int bh = work.x;
  const int q0 = work.y * kTileQ;
  const int b = bh / heads;
  const int bkv = b * kv_heads + (bh - b * heads) / (heads / kv_heads);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    // Producer warpgroup: one thread loads Q and dO once, then keeps the
    // ring of K/V stages full.
    regs_shrink<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(qbar, 2 * P::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(smem + P::kQ + c * kTileQ * 128, &tq, qbar, c * 64, q0, bh);
        tma_load(smem + P::kDO + c * kTileQ * 128, &tdo, qbar, c * 64, q0,
                 bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = work.z; kt < work.w; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * P::kKVBytes);
        uint8_t* ks = smem + P::kK + stage * P::kKVBytes;
        uint8_t* vs = smem + P::kV + stage * P::kKVBytes;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(ks + c * BK * 128, &tk, &full[stage], c * 64, kt * BK, bkv);
          tma_load(vs + c * BK * 128, &tv, &full[stage], c * 64, kt * BK, bkv);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: q rows q0 + 64 wg .. + 63. Each thread holds
    // two rows (lo, hi = lo + 8) of the wgmma accumulator layout, and
    // their LSE (times log2(e)) and delta in registers for the whole
    // loop. A row past the end reads LSE = +inf: its probabilities are 0.
    regs_grow<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_first = q0 + wg * 64;
    const int row_lo = row_first + (t / 32) * 16 + lane / 4;
    const int row_hi = row_lo + 8;
    const int cp = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;
    const float* lse_bh = lse + (size_t)bh * seq_q;
    const float* delta_bh = delta + (size_t)bh * seq_q;
    const float l2_lo = row_lo < seq_q ? lse_bh[row_lo] * kLog2e : INFINITY;
    const float l2_hi = row_hi < seq_q ? lse_bh[row_hi] * kLog2e : INFINITY;
    const float d_lo = row_lo < seq_q ? delta_bh[row_lo] : 0.f;
    const float d_hi = row_hi < seq_q ? delta_bh[row_hi] : 0.f;
    // Whether this warpgroup has a row before the end (the last q tile's
    // second warpgroup has none when seq_q % 128 is 1 to 64).
    const bool live = row_first < seq_q;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint8_t* qs = smem + P::kQ + wg * 64 * 128;
    const uint8_t* dos = smem + P::kDO + wg * 64 * 128;

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = work.z; kt < work.w; ++kt) {
      const int k0 = kt * BK;
      mbar_wait(&full[stage], phase);
      // Causal: a stage wholly past this warpgroup's last row adds 0.
      if (live && (!CAUSAL || k0 <= row_first + 63)) {
        const uint8_t* ks = smem + P::kK + stage * P::kKVBytes;
        const uint8_t* vs = smem + P::kV + stage * P::kKVBytes;

        // S = Q K^T and dP = dO V^T, all operands K-major.
        float s[BK / 2], dp[BK / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK, 0>(
              s,
              desc_sw128(qs + (kk / 4) * kTileQ * 128 + (kk % 4) * 32, 16,
                         1024),
              desc_sw128(ks + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
              kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK, 0>(
              dp,
              desc_sw128(dos + (kk / 4) * kTileQ * 128 + (kk % 4) * 32, 16,
                         1024),
              desc_sw128(vs + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
              kk);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P = 2^(S scale log2(e) - LSE log2(e)), masked only on the
        // diagonal stage and the ragged last stage; dS = P (dP - delta)
        // into dp. A key past the end reads a zero K row from TMA, so it
        // would add dS 0 to dQ; it is masked all the same, so that an
        // infinite P there cannot make 0 x inf.
        const bool edge =
            (CAUSAL && k0 + BK - 1 > row_first) || k0 + BK > seq_k;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + cp + e;
            float p_lo = exp2_approx(fmaf(s[4 * j + e], sl2, -l2_lo));
            float p_hi = exp2_approx(fmaf(s[4 * j + 2 + e], sl2, -l2_hi));
            if (edge) {
              if (key >= seq_k || (CAUSAL && key > row_lo)) p_lo = 0.f;
              if (key >= seq_k || (CAUSAL && key > row_hi)) p_hi = 0.f;
            }
            dp[4 * j + e] = p_lo * (dp[4 * j + e] - d_lo);
            dp[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - d_hi);
          }

        // dQ += dS K: dS from registers (bf16), K MN-major from the same
        // swizzled stage (no transposed copy).
        uint32_t da[BK / 16][4];
        acc_to_a<BK>(da, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D, 1>(acc, da[kk],
                         desc_sw128(ks + kk * 2048, BK * 128, 1024), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(da);
      }
      if (t == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // dQ = scale * acc, rows past the end not stored.
    bf16* o_lo = dq + ((size_t)bh * seq_q + row_lo) * D;
    bf16* o_hi = o_lo + 8 * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cp;
      if (row_lo < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row_hi < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(o_hi + col) = __floats2bfloat162_rn(
            acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

template <int D, int BK, int STAGES, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int batch,
           int heads, int kv_heads, int seq_q, int seq_k, const int* plan,
           const int* schedule, float scale, cudaStream_t stream) {
  using P = Plan<D, BK, STAGES>;
  if (plan[0] != kTileQ || plan[1] != BK || plan[2] != STAGES ||
      plan[3] != P::kSmem || plan[4] <= 0 || schedule == nullptr)
    return kErrPlan;
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = make_map_bf16(&tq, q, D, seq_q, batch * heads, kTileQ)) ||
      (err = make_map_bf16(&tdo, dout, D, seq_q, batch * heads, kTileQ)) ||
      (err = make_map_bf16(&tk, k, D, seq_k, batch * kv_heads, BK)) ||
      (err = make_map_bf16(&tv, v, D, seq_k, batch * kv_heads, BK)))
    return err;
  auto kernel = bwd_dq_bf16_kernel<D, BK, STAGES, CAUSAL>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<plan[4], kThreads, P::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq),
      reinterpret_cast<const int4*>(schedule), heads, kv_heads, seq_q, seq_k,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace dq

// ---------------------------------------------------------------------------
// B4, bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace dkv {

using namespace hopper;

constexpr int kTileK = 64 * kConsumers;  // keys per block
// q rows per step. 64 keeps a consumer's dK and dV accumulators (2 x d/2
// fp32) and its S^T and dP^T tiles (2 x 32 fp32) within the consumers'
// 240 registers at d = 128 without spills; 32-row steps (narrower wgmma)
// ran slower on the card.
constexpr int kStepQ = 64;

// Shared-memory plan for q steps of BQ rows (byte offsets; operand tiles
// 1024-byte aligned). `flash_bwd_dkv_plan` in ops/attention.py states
// the same numbers and the entry point refuses a plan that disagrees.
template <int D, int BQ>
struct Plan {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kKBytes = kTileK * D * 2;  // K (or V) of the block
  static constexpr int kQBytes = BQ * D * 2;      // one Q (or dO) step
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kRows = kDO + kStages * kQBytes;  // LSE*log2e, delta
  static constexpr int kBar = kRows + kStages * 2 * BQ * 4;
  // + barriers, + slack to align the dynamic window to 1024 bytes
  static constexpr int kSmem = 1024 + kBar + (2 * kStages + 1) * 8;
};

template <int D, int BQ, bool CAUSAL>
__global__ void __maxnreg__(kEntryRegs)
bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, const int4* __restrict__ schedule,
                    int heads, int kv_heads, int seq_q, int seq_k,
                    float scale) {
  using P = Plan<D, BQ>;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = tma_smem + ((1024 - (smem_u32(tma_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* empty = full + P::kStages;
  uint64_t* kvbar = empty + P::kStages;

  // This block's work, from the launch plan: (b*kv_heads, key tile, first q
  // step, end q step), the steps taken for each of the group's q heads.
  const int4 work = __ldg(schedule + blockIdx.x);
  const int bkv = work.x;
  const int k0 = work.y * kTileK;
  const int b = bkv / kv_heads;
  const int kvh = bkv - b * kv_heads;
  const int n_rep = heads / kv_heads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == kConsumers) {
    // Producer warp: K and V once, then Q, dO (TMA) and the step's LSE and
    // delta (plain loads by the 32 lanes) for every q step.
    regs_shrink<kProducerRegs>();
    if (threadIdx.x < kConsumers * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_map(&tq);
        prefetch_map(&tdo);
        mbar_expect_tx(kvbar, 2 * P::kKBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(smem + P::kK + c * kTileK * 128, &tk, kvbar, c * 64, k0,
                   bkv);
          tma_load(smem + P::kV + c * kTileK * 128, &tv, kvbar, c * 64, k0,
                   bkv);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0; r < n_rep; ++r) {
        const int bh = b * heads + kvh * n_rep + r;
        const float* lse_bh = lse + (size_t)bh * seq_q;
        const float* delta_bh = delta + (size_t)bh * seq_q;
        for (int i = work.z; i < work.w; ++i) {
          const int q0 = i * BQ;
          mbar_wait(&empty[stage], phase ^ 1);
          float* rows =
              reinterpret_cast<float*>(smem + P::kRows + stage * 2 * BQ * 4);
          for (int j = lane; j < BQ; j += 32) {
            const int q = q0 + j;
            // A row past the end: LSE = +inf makes its probabilities 0.
            rows[j] = q < seq_q ? lse_bh[q] * kLog2e : INFINITY;
            rows[BQ + j] = q < seq_q ? delta_bh[q] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(&full[stage], 2 * P::kQBytes);
            uint8_t* qs = smem + P::kQ + stage * P::kQBytes;
            uint8_t* dos = smem + P::kDO + stage * P::kQBytes;
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_load(qs + c * BQ * 128, &tq, &full[stage], c * 64, q0, bh);
              tma_load(dos + c * BQ * 128, &tdo, &full[stage], c * 64, q0,
                       bh);
            }
          } else {
            mbar_arrive(&full[stage]);
          }
          if (++stage == P::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys k0 + 64 wg .. + 63. Each thread holds two
    // keys (lo, hi = lo + 8) of the wgmma accumulator layout.
    regs_grow<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int key_first = k0 + wg * 64;
    const int key_lo = key_first + (t / 32) * 16 + lane / 4;
    const int key_hi = key_lo + 8;
    const int cp = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint8_t* ks = smem + P::kK + wg * 64 * 128;
    const uint8_t* vs = smem + P::kV + wg * 64 * 128;

    mbar_wait(kvbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int r = 0; r < n_rep; ++r) {
      for (int i = work.z; i < work.w; ++i) {
        const int q0 = i * BQ;
        mbar_wait(&full[stage], phase);
        // Causal: a step wholly before this warpgroup's first key adds 0.
        if (!CAUSAL || q0 + BQ > key_first) {
          const uint8_t* qs = smem + P::kQ + stage * P::kQBytes;
          const uint8_t* dos = smem + P::kDO + stage * P::kQBytes;
          const float* rows =
              reinterpret_cast<const float*>(smem + P::kRows + stage * 2 * BQ * 4);

          // S^T = K Q^T and dP^T = V dO^T, all operands K-major.
          float s[BQ / 2], dp[BQ / 2];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ, 0>(
                s,
                desc_sw128(ks + (kk / 4) * kTileK * 128 + (kk % 4) * 32, 16,
                           1024),
                desc_sw128(qs + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
                kk);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ, 0>(
                dp,
                desc_sw128(vs + (kk / 4) * kTileK * 128 + (kk % 4) * 32, 16,
                           1024),
                desc_sw128(dos + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16,
                           1024),
                kk);
          wg_commit();
          wg_wait<0>();
          fence_regs(s);
          fence_regs(dp);

          // P^T (masked only on the diagonal) into s, dS^T into dp.
          const bool diag = CAUSAL && key_first + 63 > q0;
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(rows + 8 * j + cp);
            const float2 dl =
                *reinterpret_cast<const float2*>(rows + BQ + 8 * j + cp);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float lv = e ? l2.y : l2.x;
              const float dv_ = e ? dl.y : dl.x;
              const int q = q0 + 8 * j + cp + e;
              float p_lo = exp2_approx(fmaf(s[4 * j + e], sl2, -lv));
              float p_hi = exp2_approx(fmaf(s[4 * j + 2 + e], sl2, -lv));
              if (diag) {
                if (key_lo > q) p_lo = 0.f;
                if (key_hi > q) p_hi = 0.f;
              }
              s[4 * j + e] = p_lo;
              s[4 * j + 2 + e] = p_hi;
              dp[4 * j + e] = p_lo * (dp[4 * j + e] - dv_);
              dp[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - dv_);
            }
          }

          // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major.
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
          acc_to_a<BQ>(pa, s);
          acc_to_a<BQ>(da, dp);
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)
            wgmma_rs<D, 1>(dva, pa[kq],
                           desc_sw128(dos + kq * 2048, BQ * 128, 1024), 1);
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)
            wgmma_rs<D, 1>(dka, da[kq],
                           desc_sw128(qs + kq * 2048, BQ * 128, 1024), 1);
          wg_commit();
          wg_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
          fence_regs(pa);
          fence_regs(da);
        }
        if (t == 0) mbar_arrive(&empty[stage]);
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    const size_t base = (size_t)bkv * seq_k;
    bf16* dk_lo = dk + (base + key_lo) * D;
    bf16* dv_lo = dv + (base + key_lo) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cp;
      if (key_lo < seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dk_lo + col) = __floats2bfloat162_rn(
            dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_lo + col) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      }
      if (key_hi < seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dk_lo + 8 * D + col) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                  dka[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_lo + 8 * D + col) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

template <int D, int BQ, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           int batch, int heads, int kv_heads, int seq_q, int seq_k,
           const int* plan, const int* schedule, float scale,
           cudaStream_t stream) {
  using P = Plan<D, BQ>;
  if (plan[2] != P::kStages || plan[3] != P::kSmem || plan[4] <= 0 ||
      schedule == nullptr)
    return kErrPlan;
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = make_map_bf16(&tq, q, D, seq_q, batch * heads, BQ)) ||
      (err = make_map_bf16(&tdo, dout, D, seq_q, batch * heads, BQ)) ||
      (err = make_map_bf16(&tk, k, D, seq_k, batch * kv_heads, kTileK)) ||
      (err = make_map_bf16(&tv, v, D, seq_k, batch * kv_heads, kTileK)))
    return err;
  auto kernel = bwd_dkv_bf16_kernel<D, BQ, CAUSAL>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<plan[4], kThreads, P::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), reinterpret_cast<const int4*>(schedule), heads,
      kv_heads, seq_q, seq_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace dkv

// ---------------------------------------------------------------------------
// float32: FP32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16 threads, 4 x 4 micro-tiles

// Rows [row0, row0 + 64) of a [rows, D] fp32 matrix into shared memory:
// row-major with stride D + 1 (`rm`, scalar reads by row), transposed
// [D][64] (`tr`, float4 reads along rows) and/or row-major with stride D
// (`rv`, float4 reads along d); null destinations are skipped. Zeros past
// `rows`.
template <int D>
__device__ __forceinline__ void load_f32(const float* src, int row0, int rows,
                                         float* rm, float* tr, float* rv) {
  for (int idx = threadIdx.x; idx < kBlk * (D / 4); idx += kFmaThreads) {
    const int r = idx % kBlk;  // row fastest: conflict-free transposed stores
    const int c = (idx / kBlk) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    if (rm) {
      float* p = rm + r * (D + 1) + c;
      p[0] = x.x;
      p[1] = x.y;
      p[2] = x.z;
      p[3] = x.w;
    }
    if (tr) {
      tr[(c + 0) * kBlk + r] = x.x;
      tr[(c + 1) * kBlk + r] = x.y;
      tr[(c + 2) * kBlk + r] = x.z;
      tr[(c + 3) * kBlk + r] = x.w;
    }
    if (rv) *reinterpret_cast<float4*>(rv + r * D + c) = x;
  }
}

// Two 64 x 64 products over d at once for this thread's 4 x 4 micro-tile:
// x[i][j] += A1[row i][d] B1[col j][d], y[i][j] += A2[row i][d] B2[col j][d],
// with A row-major (stride D + 1) and B transposed ([D][64]).
template <int D>
__device__ __forceinline__ void two_products(float (&x)[4][4],
                                             float (&y)[4][4], const float* a1,
                                             const float* b1, const float* a2,
                                             const float* b2, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float u[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = a1[(ty * 4 + i) * (D + 1) + d];
      w[i] = a2[(ty * 4 + i) * (D + 1) + d];
    }
    const float4 p = *reinterpret_cast<const float4*>(b1 + d * kBlk + tx * 4);
    const float4 o = *reinterpret_cast<const float4*>(b2 + d * kBlk + tx * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(u[i], pv[j], x[i][j]);
        y[i][j] = fmaf(w[i], ov[j], y[i][j]);
      }
  }
}

// acc[i][gc*4 + j] += sum_kk T[row i][kk] M[kk][gc*64 + tx*4 + j], T a
// [64][65] shared tile, M row-major [64][D].
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16],
                                           const float* tile, const float* m,
                                           int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kBlk; ++kk) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = tile[(ty * 4 + i) * (kBlk + 1) + kk];
#pragma unroll
    for (int gc = 0; gc < D / 64; ++gc) {
      const float4 v =
          *reinterpret_cast<const float4*>(m + kk * D + gc * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][gc * 4 + 0] = fmaf(a[i], v.x, acc[i][gc * 4 + 0]);
        acc[i][gc * 4 + 1] = fmaf(a[i], v.y, acc[i][gc * 4 + 1]);
        acc[i][gc * 4 + 2] = fmaf(a[i], v.z, acc[i][gc * 4 + 2]);
        acc[i][gc * 4 + 3] = fmaf(a[i], v.w, acc[i][gc * 4 + 3]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][D / 16],
                                           float mul, int row0, int rows,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int gc = 0; gc < D / 64; ++gc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(size_t)r * D + gc * 64 + tx * 4 + j] = acc[i][gc * 4 + j] * mul;
  }
}

template <int D>
constexpr size_t dq_f32_smem() {
  // Q, dO [64][D+1]; K^T, V^T [D][64]; K [64][D]; dS [64][65]; LSE, delta
  return sizeof(float) * (2 * kBlk * (D + 1) + 2 * D * kBlk + kBlk * D +
                          kBlk * (kBlk + 1) + 2 * kBlk);
}

// B3, float32: one block per (batch*head, 64 q rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int heads, int kv_heads, int seq_q, int seq_k, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                      // [64][D+1]
  float* dos = qs + kBlk * (D + 1);       // [64][D+1]
  float* kt = dos + kBlk * (D + 1);       // [D][64]
  float* vt = kt + D * kBlk;              // [D][64]
  float* kr = vt + D * kBlk;              // [64][D]
  float* dss = kr + kBlk * D;             // [64][65]
  float* lse_s = dss + kBlk * (kBlk + 1);
  float* delta_s = lse_s + kBlk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns (S), d columns (dQ)
  const int ty = tid >> 4;  // q rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBlk;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const size_t kv_off = (size_t)(b * kv_heads + kvh) * seq_k * D;

  load_f32<D>(q + (size_t)bh * seq_q * D, q0, seq_q, qs, nullptr, nullptr);
  load_f32<D>(dout + (size_t)bh * seq_q * D, q0, seq_q, dos, nullptr, nullptr);
  if (tid < kBlk) {
    const int row = q0 + tid;
    lse_s[tid] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    delta_s[tid] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int k_end = CAUSAL ? min(seq_k, q0 + kBlk) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += kBlk) {
    __syncthreads();  // the previous tile's readers are done
    load_f32<D>(k + kv_off, k0, seq_k, nullptr, kt, kr);
    load_f32<D>(v + kv_off, k0, seq_k, nullptr, vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(s, dp, qs, kt, dos, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool keep = kj < seq_k && (!CAUSAL || kj <= qi);
        const float p =
            keep ? expf(s[i][j] * scale - lse_s[ty * 4 + i]) : 0.f;
        dss[(ty * 4 + i) * (kBlk + 1) + tx * 4 + j] =
            p * (dp[i][j] - delta_s[ty * 4 + i]);
      }
    }
    __syncthreads();
    accumulate<D>(acc, dss, kr, ty, tx);
  }
  store_rows<D>(dq + (size_t)bh * seq_q * D, acc, scale, q0, seq_q, ty, tx);
}

template <int D>
constexpr size_t dkv_f32_smem() {
  // K, V [64][D+1]; Q^T, dO^T [D][64]; Q, dO [64][D]; P / dS [64][65];
  // LSE, delta
  return sizeof(float) * (2 * kBlk * (D + 1) + 2 * D * kBlk + 2 * kBlk * D +
                          kBlk * (kBlk + 1) + 2 * kBlk);
}

// B4, float32: one block per (batch, kv head, 64 keys).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int heads, int kv_heads, int seq_q,
                   int seq_k, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;                 // [64][D+1]
  float* vs = ks + kBlk * (D + 1);   // [64][D+1]
  float* qt = vs + kBlk * (D + 1);   // [D][64]
  float* dot = qt + D * kBlk;        // [D][64]
  float* qr = dot + D * kBlk;        // [64][D]
  float* dor = qr + kBlk * D;        // [64][D]
  float* buf = dor + kBlk * D;       // [64][65]: P^T, then dS^T
  float* lse_s = buf + kBlk * (kBlk + 1);
  float* delta_s = lse_s + kBlk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q columns (S^T), d columns (dK, dV)
  const int ty = tid >> 4;  // keys ty*4 .. ty*4+3
  const int k0 = blockIdx.x * kBlk;
  const int bkv = blockIdx.y;
  const int b = bkv / kv_heads;
  const int kvh = bkv - b * kv_heads;
  const int n_rep = heads / kv_heads;
  const size_t kv_off = (size_t)bkv * seq_k * D;

  load_f32<D>(k + kv_off, k0, seq_k, ks, nullptr, nullptr);
  load_f32<D>(v + kv_off, k0, seq_k, vs, nullptr, nullptr);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int r = 0; r < n_rep; ++r) {
    const int bh = b * heads + kvh * n_rep + r;
    const float* qp = q + (size_t)bh * seq_q * D;
    const float* dop = dout + (size_t)bh * seq_q * D;
    for (int q0 = CAUSAL ? k0 : 0; q0 < seq_q; q0 += kBlk) {
      __syncthreads();  // the previous tile's readers are done
      load_f32<D>(qp, q0, seq_q, nullptr, qt, qr);
      load_f32<D>(dop, q0, seq_q, nullptr, dot, dor);
      if (tid < kBlk) {
        const int row = q0 + tid;
        lse_s[tid] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
        delta_s[tid] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, dP^T = V dO^T
      float s[4][4], dp[4][4];
      two_products<D>(s, dp, ks, qt, vs, dot, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = q0 + tx * 4 + j;
          const bool keep = qc < seq_q && (!CAUSAL || key <= qc);
          const float p =
              keep ? expf(s[i][j] * scale - lse_s[tx * 4 + j]) : 0.f;
          buf[(ty * 4 + i) * (kBlk + 1) + tx * 4 + j] = p;
          dp[i][j] = p * (dp[i][j] - delta_s[tx * 4 + j]);
        }
      }
      __syncthreads();
      accumulate<D>(dva, buf, dor, ty, tx);  // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          buf[(ty * 4 + i) * (kBlk + 1) + tx * 4 + j] = dp[i][j];
      __syncthreads();
      accumulate<D>(dka, buf, qr, ty, tx);  // dK += dS^T Q (scale below)
    }
  }
  store_rows<D>(dk + kv_off, dka, scale, k0, seq_k, ty, tx);
  store_rows<D>(dv + kv_off, dva, 1.f, k0, seq_k, ty, tx);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch, heads, kv_heads, seq_q, seq_k;
  float scale;
  cudaStream_t stream;
  const int* plan;      // bfloat16: rows per block, rows per step,
                        // stages, shared-memory bytes, blocks
  const int* schedule;  // bfloat16: one int4 per block (device memory)
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool CAUSAL>
int launch_dq(int dtype, const Args& a) {
  if (dtype == 0) {
    const dim3 grid((a.seq_q + kBlk - 1) / kBlk, a.batch * a.heads);
    auto kernel = bwd_dq_f32_kernel<D, CAUSAL>;
    int err;
    if ((err = set_smem(kernel, dq_f32_smem<D>())) != 0) return err;
    kernel<<<grid, kFmaThreads, dq_f32_smem<D>(), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.heads, a.kv_heads,
        a.seq_q, a.seq_k, a.scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return hopper::kErrUnsupported;
  using B = dq::Build<D>;
  return dq::launch<D, B::kStepK, B::kStages, CAUSAL>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.batch, a.heads,
      a.kv_heads, a.seq_q, a.seq_k, a.plan, a.schedule, a.scale, a.stream);
}

template <int D, bool CAUSAL>
int launch_dkv(int dtype, const Args& a) {
  if (dtype == 0) {
    const dim3 grid((a.seq_k + kBlk - 1) / kBlk, a.batch * a.kv_heads);
    auto kernel = bwd_dkv_f32_kernel<D, CAUSAL>;
    int err;
    if ((err = set_smem(kernel, dkv_f32_smem<D>())) != 0) return err;
    kernel<<<grid, kFmaThreads, dkv_f32_smem<D>(), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.heads, a.kv_heads, a.seq_q, a.seq_k, a.scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return hopper::kErrUnsupported;
  if (a.plan[0] != dkv::kTileK || a.plan[1] != dkv::kStepQ)
    return hopper::kErrPlan;
  return dkv::launch<D, dkv::kStepQ, CAUSAL>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.batch, a.heads,
      a.kv_heads, a.seq_q, a.seq_k, a.plan, a.schedule, a.scale, a.stream);
}

// which: 0 = B3 (dQ), 1 = B4 (dK/dV).
template <int D, bool CAUSAL>
int launch_one(int which, int dtype, const Args& a) {
  return which == 0 ? launch_dq<D, CAUSAL>(dtype, a)
                    : launch_dkv<D, CAUSAL>(dtype, a);
}

int dispatch(int which, int head_dim, int dtype, int causal, const Args& a) {
  if (head_dim == 64)
    return causal ? launch_one<64, true>(which, dtype, a)
                  : launch_one<64, false>(which, dtype, a);
  if (head_dim == 128)
    return causal ? launch_one<128, true>(which, dtype, a)
                  : launch_one<128, false>(which, dtype, a);
  return -1;
}

}  // namespace

// C entry points for ctypes. dtype: 0 = float32, 1 = bfloat16. Inputs are
// contiguous [batch, heads, seq_q, d] (q, dout, and dq) and [batch,
// kv_heads, seq_k, d] (k, v, dk, dv); lse and delta are [batch, heads,
// seq_q] fp32. Outputs are in the input dtype. The bfloat16 kernels take
// their launch plan from ops/attention.py: rows per block (B3: q rows, B4:
// keys), rows per step (B3: keys of a K/V stage, B4: q rows of a Q/dO
// stage), stages and shared-memory bytes, which must match this build,
// and the schedule, `blocks` int4s in device memory (group, tile, first
// and end step), one per block in launch order. float32 takes none (0s,
// NULL). Each returns 0, the CUDA error of the launch, or a negative
// hopper::kErr* code (-1: dtype / head dim not taken).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, const int* schedule,
                            int batch, int heads, int kv_heads, int seq_q,
                            int seq_k, int head_dim, int dtype, int causal,
                            int block_q, int block_k, int stages,
                            int smem_bytes, int blocks, float scale,
                            void* stream) {
  const int plan[5] = {block_q, block_k, stages, smem_bytes, blocks};
  const Args a{q,     k,       v,       dout,  lse,   delta,
               dq,    nullptr, nullptr, batch, heads, kv_heads,
               seq_q, seq_k,   scale,   static_cast<cudaStream_t>(stream),
               plan,  schedule};
  return dispatch(0, head_dim, dtype, causal, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const int* schedule, int batch, int heads,
                             int kv_heads, int seq_q, int seq_k, int head_dim,
                             int dtype, int causal, int block_k, int block_q,
                             int stages, int smem_bytes, int blocks,
                             float scale, void* stream) {
  const int plan[5] = {block_k, block_q, stages, smem_bytes, blocks};
  const Args a{q,     k,     v,     dout,  lse,   delta,
               nullptr, dk,  dv,    batch, heads, kv_heads,
               seq_q, seq_k, scale, static_cast<cudaStream_t>(stream), plan,
               schedule};
  return dispatch(1, head_dim, dtype, causal, a);
}
