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
// - d = 64, 128 and 256 are compiled as they are; the wrapper zero-pads
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
//   threads each owning a 4x4 micro-tile of the 64x64 score tile (2x2 of
//   32x32 at d = 256, for shared memory), dS (and P) passed through shared
//   memory to the accumulating products. Masked probabilities are set to 0
//   directly, which is what exp(-1e30 - LSE) gives the reference.
// Times against the bound are in PERF.md.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
// PERF.md). At d = 256 the accumulator is 128 registers and Q + dO take
// 128 KiB: 32-key stages (S and dP 16 fp32 each, dS 8) in a ring of three
// (230,456 bytes).
template <int D>
using Build = Plan<D, D == 64 ? 128 : D == 128 ? 64 : 32,
                   D == 64 ? 4 : D == 128 ? 5 : 3>;

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
          wgmma_rs_mn<D>(acc, da[kk], ks + kk * 2048, BK * 128);
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

// Shared-memory plan for q steps of BQ rows (byte offsets; operand tiles
// 1024-byte aligned). `flash_bwd_dkv_plan` in ops/attention.py states
// the same numbers and the entry point refuses a plan that disagrees.
template <int D, int BQ>
struct Plan {
  // Q/dO stages as fit beside K and V: 4 / 3 / 3 at d = 64 / 128 / 256
  // (231,224 bytes at d = 256 with 32-row steps).
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

// The build's q step and output split at each head dim. A 64-row step
// keeps a consumer's dK and dV accumulators (2 x d/2 fp32) and its S^T
// and dP^T tiles (2 x 32 fp32) within the consumers' 240 registers at
// d = 128 without spills; 32-row steps (narrower wgmma) ran slower on the
// card. At d = 256 the two accumulators alone would be 256 registers, so
// each schedule row runs as two blocks, one per 128-column half of dK and
// dV: each recomputes S^T and dP^T over the full d and accumulates its
// half (64 + 64 registers), with 32-row steps for the 128 KiB of K and V.
// One block still owns each output element: no atomics.
template <int D>
struct Build {
  static constexpr int kStepQ = D == 256 ? 32 : 64;
  static constexpr int kCols = D == 256 ? 128 : D;  // dK/dV columns a block
  static constexpr int kSplits = D / kCols;         // blocks a schedule row
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
  constexpr int DC = Build<D>::kCols;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = tma_smem + ((1024 - (smem_u32(tma_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* empty = full + P::kStages;
  uint64_t* kvbar = empty + P::kStages;

  // This block's work, from the launch plan: (b*kv_heads, key tile, first q
  // step, end q step), the steps taken for each of the group's q heads;
  // the schedule row's kSplits blocks are neighbours, each owning the dK /
  // dV columns c0 .. c0 + DC - 1.
  const int4 work = __ldg(schedule + blockIdx.x / Build<D>::kSplits);
  const int c0 = (blockIdx.x % Build<D>::kSplits) * DC;
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
    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
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

          // dV += P^T dO and dK += dS^T Q over this block's columns: A
          // from registers, B MN-major from the boxes of columns c0 on.
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
          acc_to_a<BQ>(pa, s);
          acc_to_a<BQ>(da, dp);
          const int cbox = (c0 / 64) * BQ * 128;
          wg_fence();
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)
            wgmma_rs_mn<DC>(dva, pa[kq], dos + cbox + kq * 2048, BQ * 128);
#pragma unroll
          for (int kq = 0; kq < BQ / 16; ++kq)
            wgmma_rs_mn<DC>(dka, da[kq], qs + cbox + kq * 2048, BQ * 128);
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
    bf16* dk_lo = dk + (base + key_lo) * D + c0;
    bf16* dv_lo = dv + (base + key_lo) * D + c0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
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
  kernel<<<plan[4] * Build<D>::kSplits, kThreads, P::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), reinterpret_cast<const int4*>(schedule), heads,
      kv_heads, seq_q, seq_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace dkv

// ---------------------------------------------------------------------------
// float32: FP32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16 threads

// Rows of a float32 tile (q rows of B3, keys of B4, and the other side's
// step): 64, and 32 at d = 256, where 64-row tiles would need 345,344
// (B3) and 410,880 (B4) bytes of shared memory. Each thread owns an
// M x M micro-tile of the BLK x BLK score tile (M = BLK / 16) and M rows
// of a d/16-wide slice of the accumulators.
template <int D>
struct F32Tile {
  static constexpr int kBlk = D == 256 ? 32 : 64;
};

// Rows [row0, row0 + BLK) of a [rows, D] fp32 matrix into shared memory:
// row-major with stride D + 1 (`rm`, scalar reads by row), transposed
// [D][BLK] (`tr`, vector reads along rows) and/or row-major with stride D
// (`rv`, float4 reads along d); null destinations are skipped. Zeros past
// `rows`.
template <int D, int BLK>
__device__ __forceinline__ void load_f32(const float* src, int row0, int rows,
                                         float* rm, float* tr, float* rv) {
  for (int idx = threadIdx.x; idx < BLK * (D / 4); idx += kFmaThreads) {
    const int r = idx % BLK;  // row fastest: conflict-free transposed stores
    const int c = (idx / BLK) * 4;
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
      tr[(c + 0) * BLK + r] = x.x;
      tr[(c + 1) * BLK + r] = x.y;
      tr[(c + 2) * BLK + r] = x.z;
      tr[(c + 3) * BLK + r] = x.w;
    }
    if (rv) *reinterpret_cast<float4*>(rv + r * D + c) = x;
  }
}

// M consecutive floats of shared memory (M = 4 or 2), as one vector read.
template <int M>
__device__ __forceinline__ void load_m(float (&out)[M], const float* p) {
  if constexpr (M == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(M == 2, "micro-tiles of 4 or 2");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

// Two BLK x BLK products over d at once for this thread's M x M
// micro-tile: x[i][j] += A1[row i][d] B1[col j][d], y[i][j] += A2[row i][d]
// B2[col j][d], with A row-major (stride D + 1) and B transposed ([D][BLK]).
template <int D, int BLK>
__device__ __forceinline__ void two_products(float (&x)[BLK / 16][BLK / 16],
                                             float (&y)[BLK / 16][BLK / 16],
                                             const float* a1, const float* b1,
                                             const float* a2, const float* b2,
                                             int ty, int tx) {
  constexpr int M = BLK / 16;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float u[M], w[M], pv[M], ov[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      u[i] = a1[(ty * M + i) * (D + 1) + d];
      w[i] = a2[(ty * M + i) * (D + 1) + d];
    }
    load_m<M>(pv, b1 + d * BLK + tx * M);
    load_m<M>(ov, b2 + d * BLK + tx * M);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        x[i][j] = fmaf(u[i], pv[j], x[i][j]);
        y[i][j] = fmaf(w[i], ov[j], y[i][j]);
      }
  }
}

// acc[i][gc*4 + j] += sum_kk T[row i][kk] Mx[kk][gc*64 + tx*4 + j], T a
// [BLK][BLK+1] shared tile, Mx row-major [BLK][D].
template <int D, int BLK>
__device__ __forceinline__ void accumulate(float (&acc)[BLK / 16][D / 16],
                                           const float* tile, const float* m,
                                           int ty, int tx) {
  constexpr int M = BLK / 16;
#pragma unroll 4
  for (int kk = 0; kk < BLK; ++kk) {
    float a[M];
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = tile[(ty * M + i) * (BLK + 1) + kk];
#pragma unroll
    for (int gc = 0; gc < D / 64; ++gc) {
      const float4 v =
          *reinterpret_cast<const float4*>(m + kk * D + gc * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        acc[i][gc * 4 + 0] = fmaf(a[i], v.x, acc[i][gc * 4 + 0]);
        acc[i][gc * 4 + 1] = fmaf(a[i], v.y, acc[i][gc * 4 + 1]);
        acc[i][gc * 4 + 2] = fmaf(a[i], v.z, acc[i][gc * 4 + 2]);
        acc[i][gc * 4 + 3] = fmaf(a[i], v.w, acc[i][gc * 4 + 3]);
      }
    }
  }
}

template <int D, int BLK>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[BLK / 16][D / 16],
                                           float mul, int row0, int rows,
                                           int ty, int tx) {
  constexpr int M = BLK / 16;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int r = row0 + ty * M + i;
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
  // Q, dO [BLK][D+1]; K^T, V^T [D][BLK]; K [BLK][D]; dS [BLK][BLK+1];
  // LSE, delta
  constexpr int B = F32Tile<D>::kBlk;
  return sizeof(float) * (2 * B * (D + 1) + 2 * D * B + B * D +
                          B * (B + 1) + 2 * B);
}

// B3, float32: one block per (batch*head, BLK q rows).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int heads, int kv_heads, int seq_q, int seq_k, float scale) {
  constexpr int BLK = F32Tile<D>::kBlk;
  constexpr int M = BLK / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                    // [BLK][D+1]
  float* dos = qs + BLK * (D + 1);      // [BLK][D+1]
  float* kt = dos + BLK * (D + 1);      // [D][BLK]
  float* vt = kt + D * BLK;             // [D][BLK]
  float* kr = vt + D * BLK;             // [BLK][D]
  float* dss = kr + BLK * D;            // [BLK][BLK+1]
  float* lse_s = dss + BLK * (BLK + 1);
  float* delta_s = lse_s + BLK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns (S), d columns (dQ)
  const int ty = tid >> 4;  // q rows ty*M .. ty*M+M-1
  const int q0 = blockIdx.x * BLK;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const size_t kv_off = (size_t)(b * kv_heads + kvh) * seq_k * D;

  load_f32<D, BLK>(q + (size_t)bh * seq_q * D, q0, seq_q, qs, nullptr,
                   nullptr);
  load_f32<D, BLK>(dout + (size_t)bh * seq_q * D, q0, seq_q, dos, nullptr,
                   nullptr);
  if (tid < BLK) {
    const int row = q0 + tid;
    lse_s[tid] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    delta_s[tid] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
  }

  float acc[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int k_end = CAUSAL ? min(seq_k, q0 + BLK) : seq_k;
  for (int k0 = 0; k0 < k_end; k0 += BLK) {
    __syncthreads();  // the previous tile's readers are done
    load_f32<D, BLK>(k + kv_off, k0, seq_k, nullptr, kt, kr);
    load_f32<D, BLK>(v + kv_off, k0, seq_k, nullptr, vt, nullptr);
    __syncthreads();

    float s[M][M], dp[M][M];
    two_products<D, BLK>(s, dp, qs, kt, dos, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int qi = q0 + ty * M + i;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int kj = k0 + tx * M + j;
        const bool keep = kj < seq_k && (!CAUSAL || kj <= qi);
        const float p =
            keep ? expf(s[i][j] * scale - lse_s[ty * M + i]) : 0.f;
        dss[(ty * M + i) * (BLK + 1) + tx * M + j] =
            p * (dp[i][j] - delta_s[ty * M + i]);
      }
    }
    __syncthreads();
    accumulate<D, BLK>(acc, dss, kr, ty, tx);
  }
  store_rows<D, BLK>(dq + (size_t)bh * seq_q * D, acc, scale, q0, seq_q, ty,
                     tx);
}

template <int D>
constexpr size_t dkv_f32_smem() {
  // K, V [BLK][D+1]; Q^T, dO^T [D][BLK]; Q, dO [BLK][D]; P / dS
  // [BLK][BLK+1]; LSE, delta
  constexpr int B = F32Tile<D>::kBlk;
  return sizeof(float) * (2 * B * (D + 1) + 2 * D * B + 2 * B * D +
                          B * (B + 1) + 2 * B);
}

// B4, float32: one block per (batch, kv head, BLK keys).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kFmaThreads)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int heads, int kv_heads, int seq_q,
                   int seq_k, float scale) {
  constexpr int BLK = F32Tile<D>::kBlk;
  constexpr int M = BLK / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;                // [BLK][D+1]
  float* vs = ks + BLK * (D + 1);   // [BLK][D+1]
  float* qt = vs + BLK * (D + 1);   // [D][BLK]
  float* dot = qt + D * BLK;        // [D][BLK]
  float* qr = dot + D * BLK;        // [BLK][D]
  float* dor = qr + BLK * D;        // [BLK][D]
  float* buf = dor + BLK * D;       // [BLK][BLK+1]: P^T, then dS^T
  float* lse_s = buf + BLK * (BLK + 1);
  float* delta_s = lse_s + BLK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q columns (S^T), d columns (dK, dV)
  const int ty = tid >> 4;  // keys ty*M .. ty*M+M-1
  const int k0 = blockIdx.x * BLK;
  const int bkv = blockIdx.y;
  const int b = bkv / kv_heads;
  const int kvh = bkv - b * kv_heads;
  const int n_rep = heads / kv_heads;
  const size_t kv_off = (size_t)bkv * seq_k * D;

  load_f32<D, BLK>(k + kv_off, k0, seq_k, ks, nullptr, nullptr);
  load_f32<D, BLK>(v + kv_off, k0, seq_k, vs, nullptr, nullptr);

  float dka[M][D / 16], dva[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int r = 0; r < n_rep; ++r) {
    const int bh = b * heads + kvh * n_rep + r;
    const float* qp = q + (size_t)bh * seq_q * D;
    const float* dop = dout + (size_t)bh * seq_q * D;
    for (int q0 = CAUSAL ? k0 : 0; q0 < seq_q; q0 += BLK) {
      __syncthreads();  // the previous tile's readers are done
      load_f32<D, BLK>(qp, q0, seq_q, nullptr, qt, qr);
      load_f32<D, BLK>(dop, q0, seq_q, nullptr, dot, dor);
      if (tid < BLK) {
        const int row = q0 + tid;
        lse_s[tid] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
        delta_s[tid] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, dP^T = V dO^T
      float s[M][M], dp[M][M];
      two_products<D, BLK>(s, dp, ks, qt, vs, dot, ty, tx);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int key = k0 + ty * M + i;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int qc = q0 + tx * M + j;
          const bool keep = qc < seq_q && (!CAUSAL || key <= qc);
          const float p =
              keep ? expf(s[i][j] * scale - lse_s[tx * M + j]) : 0.f;
          buf[(ty * M + i) * (BLK + 1) + tx * M + j] = p;
          dp[i][j] = p * (dp[i][j] - delta_s[tx * M + j]);
        }
      }
      __syncthreads();
      accumulate<D, BLK>(dva, buf, dor, ty, tx);  // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          buf[(ty * M + i) * (BLK + 1) + tx * M + j] = dp[i][j];
      __syncthreads();
      accumulate<D, BLK>(dka, buf, qr, ty, tx);  // dK += dS^T Q (scale below)
    }
  }
  store_rows<D, BLK>(dk + kv_off, dka, scale, k0, seq_k, ty, tx);
  store_rows<D, BLK>(dv + kv_off, dva, 1.f, k0, seq_k, ty, tx);
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
    constexpr int kBlk = F32Tile<D>::kBlk;
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
    constexpr int kBlk = F32Tile<D>::kBlk;
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
  constexpr int BQ = dkv::Build<D>::kStepQ;
  if (a.plan[0] != dkv::kTileK || a.plan[1] != BQ) return hopper::kErrPlan;
  return dkv::launch<D, BQ, CAUSAL>(
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
  if (head_dim == 256)
    return causal ? launch_one<256, true>(which, dtype, a)
                  : launch_one<256, false>(which, dtype, a);
  return hopper::kErrUnsupported;
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
