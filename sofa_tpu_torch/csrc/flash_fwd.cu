// sofa_flash_fwd: fused attention forward for Hopper (sm_90a), bf16 in,
// f32 online softmax, bf16 out plus a per-row logsumexp in f32.
//
// Replaces the TPU kernel sofa_tpu/workloads/flash_pallas.py:_flash_kernel
// (launched as name="sofa_flash_fwd" by _flash_forward, flash_pallas.py:282)
// and computes the same function:
//   - key j is visible to query i iff j <= i + shift (0 = causal, >= Tk =
//     full attention, <= -Tk = nothing visible: out 0, lse ~ -1e29);
//   - optional segment ids mask pairs whose ids differ (packed sequences);
//   - GQA is native: query head h reads compact KV head h / (H / KVH);
//   - m is clamped at -1e29, masked scores are NEG_INF = -1e30, so a row
//     with no visible key accumulates exact zeros;
//   - p rounds to bf16 before the P.V product, l sums the unrounded p.
// The one deliberate difference: the running max starts at the clamp floor
// (-1e29) instead of NEG_INF, so a fully masked row reports lse ~ -1e29
// whatever the tiling (the TPU kernel gives -1e30 when it skips every block
// and -1e29 when it visits one).  Every visible row is unaffected.
//
// What bounds it on an H100: bf16 tensor-core operations.  Under causal
// masking the work is 4*B*H*D*T*(T+1)/2 flops against 2*(q+k+v+out) bytes;
// at the Llama-3-8B attention shape (B=4, T=2048, H=32, D=128) that is
// ~1.4e11 flops against ~0.17 GB, about 800 flops per byte, well above the
// card's ~295 flops/byte ridge.  Only wgmma reaches the tensor cores' rate,
// and it has to be fed from shared memory without stalls.  The design:
//   - one block per (batch*head, 128-row q-tile), two warpgroups of 64
//     rows each; a loop inside the block walks the 128-key K/V tiles only
//     up to the causal frontier of the runtime shift (the TPU's sequential
//     k axis and its pl.when skip); the heaviest q-tiles (nearest the end
//     of a causal sequence) are scheduled first to even out the grid's
//     tail;
//   - Q is loaded once, K and V through a three-stage ring, all by TMA into
//     128B-swizzled panels (csrc/hopper.cuh) under mbarriers: one thread
//     refills a stage as soon as both warpgroups have released it, two
//     tiles ahead of the products, and rows past T or Tk arrive as zeros
//     (no ragged-edge branch in the loads);
//   - S = Q K^T is wgmma m64n128k16 with both operands read from shared
//     memory by descriptor (K as stored is the K-major B); O += P V is
//     wgmma m64nDk16 with P taken from S's accumulators in registers,
//     rounded to bf16 (the accumulator layout repacks into the register A
//     layout as is), and V read through the transpose bit, so no copy of V
//     is ever transposed and no fragment is loaded by hand;
//   - a warpgroup issues S for tile i and P V for tile i - 1 together and
//     runs tile i's softmax while P V is still on the tensor cores; O is
//     rescaled and the new P packed only once that product is done;
//   - the softmax state (m, l) and O stay in f32 registers; m is kept in
//     log2 units so each score costs one multiply and one ex2;
//   - the causal, length and segment masks are applied only to the tiles
//     that cross a warpgroup's diagonal, the ragged end of Tk, or a
//     segmented call; a tile every row of the warpgroup sees fully skips
//     the per-element compare.
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's kernel
// phase): 0.313-0.316 ms at the Llama shape, 44 % of its 0.139 ms
// tensor-core bound.  What holds it there: the loads are not the limit (a
// separate producer warp was no faster in development builds, and with
// two stages the overlap above stalls on them); S = Q K^T still waits for
// nothing but itself, and the two warpgroups are not scheduled against
// each other (a plain ping-pong on named barriers was slower).  A producer
// warpgroup that gives its registers to the consumers (setmaxnreg) would
// make room for a second S accumulator, so one tile's softmax can overlap
// the next tile's Q K^T as well.
// ptxas -v (CUDA 12.8, sm_90a): 220 registers at D 128 and 196 at D 64, no
// spills; dynamic shared memory 230,480 / 115,792 bytes a block at D 128 /
// D 64 (sofa_flash_fwd_smem_bytes), so one block per SM.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 128;            // query rows per block
constexpr int BLOCK_N = 128;            // keys per K/V tile
constexpr int WG_ROWS = 64;             // query rows per consumer warpgroup
constexpr int CONSUMERS = BLOCK_M / WG_ROWS;
constexpr int FWD_THREADS = CONSUMERS * 128;
// The ring depth is the one tile constant a build may set
// (-DFLASH_STAGES=N, tools/tune_flash.py); BLOCK_M and BLOCK_N fix the
// warpgroup and wgmma layouts.
#ifndef FLASH_STAGES
#define FLASH_STAGES 3
#endif
constexpr int STAGES = FLASH_STAGES;   // K/V ring depth
static_assert(STAGES >= 2,
              "tile i + STAGES - 2 refills the stage of tile i - 2");
constexpr int PANEL_COLS = 64;          // bf16 columns of a 128-byte panel
constexpr float LN2 = 0.6931471805599453f;
constexpr float M2_FLOOR = M_FLOOR * LOG2E;   // the clamp in log2 units

// Shared memory of one block, from a 1024-byte aligned base: Q (D / 64
// panels of BLOCK_M rows), then per stage K and V (D / 64 panels of BLOCK_N
// rows each), then the barriers: q_full, k_full[STAGES], v_full[STAGES],
// empty[STAGES].
template <int D>
struct Smem {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int Q_PANEL = BLOCK_M * 128;
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;     // one K or V tile
  static constexpr int BARS = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1) sofa_flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int Tk,
    int H, int KVH, long long shift, float scale_log2) {
  using S = Smem<D>;
  constexpr int KS = D / 16;            // k16 steps of S = Q K^T
  constexpr int NS = BLOCK_N / 8;       // 8-key column groups of S
  constexpr int NO = D / 8;             // 8-column groups of O

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + S::BARS;
  const uint32_t q_full = bar;
  auto k_s = [&](int st) { return base + S::Q_BYTES + st * 2 * S::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + S::KV_BYTES; };
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + STAGES + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + 2 * STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;             // this warpgroup's 64 rows
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // accumulator row group / col pair
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;

  // Causal frontier: the last key any row of this block can see.
  const long long last = static_cast<long long>(q0) + BLOCK_M - 1 + shift;
  int n_tiles = 0;
  if (last >= 0) {
    const long long by_mask = last / BLOCK_N + 1;
    const long long by_len = (Tk + BLOCK_N - 1) / BLOCK_N;
    n_tiles = static_cast<int>(by_mask < by_len ? by_mask : by_len);
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);   // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Tile j of K and V into stage j % STAGES (one thread).
  const CUtensorMap* k_mp = &k_map;
  const CUtensorMap* v_mp = &v_map;
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    mbar_arrive_expect_tx(k_full(st), S::KV_BYTES);
    for (int p = 0; p < S::PANELS; ++p) {
      tma_load_4d(k_s(st) + p * S::KV_PANEL, k_mp, k_full(st),
                  p * PANEL_COLS, kvh, j * BLOCK_N, b);
    }
    mbar_arrive_expect_tx(v_full(st), S::KV_BYTES);
    for (int p = 0; p < S::PANELS; ++p) {
      tma_load_4d(v_s(st) + p * S::KV_PANEL, v_mp, v_full(st),
                  p * PANEL_COLS, kvh, j * BLOCK_N, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(k_mp);
    tma_prefetch_map(v_mp);
    mbar_arrive_expect_tx(q_full, S::Q_BYTES);
    for (int p = 0; p < S::PANELS; ++p) {
      tma_load_4d(q_s + p * S::Q_PANEL, &q_map, q_full, p * PANEL_COLS, h, q0,
                  b);
    }
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_kv(j);
  }
  __syncwarp();

  // This thread's two rows: r0 and r0 + 8 within its warp's 16.
  const int wrow = q0 + wg * WG_ROWS;   // first row of the warpgroup
  const int row0 = wrow + warp * 16 + g, row1 = row0 + 8;
  const bool segmented = seg_q != nullptr;
  int sq0 = 0, sq1 = 0;
  if (segmented) {
    sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
    sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
  }
  const int* seg_kb = segmented ? seg_k + static_cast<long long>(b) * Tk
                                : nullptr;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = M2_FLOOR, m1 = M2_FLOOR, l0 = 0.f, l1 = 0.f;

  // Q rows of this warpgroup: rows [wg * 64, wg * 64 + 64) of each panel.
  const uint32_t q_wg = q_s + wg * WG_ROWS * 128;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  float s[NS][4];
  uint32_t pa[BLOCK_N / 16][4];

  // Scale tile i's scores to log2 units, mask where needed, and turn them
  // into p = exp2(x - m) in place; updates m and l, returns alpha per row.
  auto softmax = [&](int i, float& alpha0, float& alpha1) {
    const int k0 = i * BLOCK_N;
    const bool need_mask =
        segmented || k0 + BLOCK_N > Tk ||
        static_cast<long long>(k0) + BLOCK_N - 1 > wrow + shift;
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          bool masked = key >= Tk || key > row + shift;
          if (segmented && !masked) {
            masked = seg_kb[key] != (e < 2 ? sq0 : sq1);
          }
          s[n][e] = masked ? NEG_INF : s[n][e] * scale_log2;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    alpha0 = fast_exp2(m0 - mn0);
    alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = fast_exp2(s[n][0] - mn0);
      s[n][1] = fast_exp2(s[n][1] - mn0);
      s[n][2] = fast_exp2(s[n][2] - mn1);
      s[n][3] = fast_exp2(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + quad_sum(ps0);
    l1 = l1 * alpha1 + quad_sum(ps1);
  };
  // O *= alpha, then P (bf16) into the register A layout for P.V.
  auto rescale_pack = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha0; o[j][1] *= alpha0;
      o[j][2] *= alpha1; o[j][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n / 2][(n % 2) * 2] = pack_f32(s[n][0], s[n][1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_f32(s[n][2], s[n][3]);
    }
  };
  auto issue_s = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int p = ks / 4, kc = ks % 4;
      const uint64_t da = desc_sw128(q_wg + p * S::Q_PANEL + kc * 32, 16,
                                     SW128_SBO);
      const uint64_t db = desc_sw128(k_s(st) + p * S::KV_PANEL + kc * 32, 16,
                                     SW128_SBO);
      wgmma_ss<BLOCK_N, 0>(s, da, db, ks > 0);
    }
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint64_t db = desc_sw128(v_s(st) + kk * 16 * 128, S::KV_PANEL,
                                     SW128_SBO);
      wgmma_rs<D, 1>(o, pa[kk], db, 1);
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  if (n_tiles > 0) {
    // Tile 0: S, then its softmax with nothing to overlap.
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    float a0, a1;
    softmax(0, a0, a1);
    rescale_pack(a0, a1);
  }
  // Tile i: S_i and P_{i-1} V_{i-1} are issued together; tile i's softmax
  // runs while P_{i-1} V_{i-1} is still on the tensor cores.
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % STAGES, sp = (i - 1) % STAGES;
    // Refill: tile i + STAGES - 2 goes to the stage of tile i - 2, which
    // both warpgroups released in iteration i - 1; it lands while this
    // iteration and the next one compute.
    if (tid == 0 && i >= 2 && i + STAGES - 2 < n_tiles) {
      const int j = i + STAGES - 2;
      mbar_wait(empty(j % STAGES), ((i - 2) / STAGES) & 1);
      load_kv(j);
    }
    __syncwarp();
    mbar_wait(k_full(st), (i / STAGES) & 1);
    mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
    fence_operands(o);
    fence_operands(pa);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    float a0, a1;
    softmax(i, a0, a1);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);
    release(sp);
    rescale_pack(a0, a1);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(sp), ((n_tiles - 1) / STAGES) & 1);
    fence_operands(o);
    fence_operands(pa);
    wgmma_fence();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);
    release(sp);
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  const long long q_stride = static_cast<long long>(H) * D;
  __nv_bfloat16* out_bh = out + static_cast<long long>(b) * T * q_stride +
                         static_cast<long long>(h) * D;
  float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
  // A row that saw no key keeps m at the floor: report it as M_FLOOR
  // exactly, not through a rounding of M2_FLOOR * LN2.
  const float ml0 = m0 > M2_FLOOR ? m0 * LN2 : M_FLOOR;
  const float ml1 = m1 > M2_FLOOR ? m1 * LN2 : M_FLOOR;
  if (row0 < T) {
    store_row(out_bh + row0 * q_stride, false, o, 0, inv0, t);
    if (t == 0) lse_bh[row0] = ml0 + logf(lc0);
  }
  if (row1 < T) {
    store_row(out_bh + row1 * q_stride, false, o, 1, inv1, t);
    if (t == 0) lse_bh[row1] = ml1 + logf(lc1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, void* out, float* lse,
                   int B, int T, int Tk, int H, int KVH, long long shift,
                   float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = encode_heads(&q_map, q, D, H, T, B, BLOCK_M);
  if (err == cudaSuccess) err = encode_heads(&k_map, k, D, KVH, Tk, B, BLOCK_N);
  if (err == cudaSuccess) err = encode_heads(&v_map, v, D, KVH, Tk, B, BLOCK_N);
  if (err != cudaSuccess) return err;
  const int smem = Smem<D>::BYTES;
  err = allow_smem(sofa_flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + BLOCK_M - 1) / BLOCK_M);
  sofa_flash_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(
      q_map, k_map, v_map, seg_q, seg_k, static_cast<__nv_bfloat16*>(out),
      lse, T, Tk, H, KVH, shift, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B,T,H,D], k/v [B,Tk,KVH,D]
// contiguous bf16, 16-byte aligned; seg_q [B,T] / seg_k [B,Tk] int32 or both
// null; out [B,T,H,D] bf16 and lse [B,H,T] f32 are allocated by the caller.
// Launches on `stream` without synchronizing and returns cudaGetLastError()
// (cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int sofa_flash_fwd(const void* q, const void* k, const void* v,
                              const int* seg_q, const int* seg_k, void* out,
                              float* lse, int B, int T, int Tk, int H, int KVH,
                              int D, long long shift, float scale,
                              void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + BLOCK_M - 1) / BLOCK_M > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, seg_q, seg_k, out, lse, B, T,
                                         Tk, H, KVH, shift, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, seg_q, seg_k, out, lse, B,
                                          T, Tk, H, KVH, shift, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block asks for at head dim d (0 if unsupported).
extern "C" int sofa_flash_fwd_smem_bytes(int d) {
  return d == 64 ? Smem<64>::BYTES : d == 128 ? Smem<128>::BYTES : 0;
}
