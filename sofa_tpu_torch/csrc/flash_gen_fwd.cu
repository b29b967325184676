// sofa_flash_gen_fwd: fused attention forward for every (dtype, head dim)
// the Hopper kernel sofa_flash_fwd does not take: q/k/v in bfloat16,
// float16 or float32 at any head dim 1..256, out in q's dtype plus a
// per-row logsumexp in float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_flash_kernel (launched as
// name="sofa_flash_fwd" by _flash_forward, flash_pallas.py:282), which
// takes any float dtype and any head dim, and computes the same function as
// flash_cuda._flash_forward_plain:
//   - key j is visible to query i iff j <= i + shift (0 = causal, >= Tk =
//     full attention, <= -Tk = nothing visible: out 0, lse ~ -1e29);
//   - optional segment ids mask pairs whose ids differ (packed sequences);
//   - GQA is native: query head h reads compact KV head h / (H / KVH);
//   - scores in float32 over the true D, times the true D's scale;
//   - the running max starts at, and so is clamped at, -1e29; masked scores
//     are NEG_INF = -1e30, so a row with no visible key sums exact zeros;
//   - p rounds to V's dtype before the P.V product, l sums the unrounded p.
//
// What bounds it on an H100: operations, 4*B*H*D*T*(T+1)/2 flops under
// causal masking against 2*(q+k+v+out) bytes (bf16 D 256 at B 1, T 8192, H
// 8 / 4: 2.75e11 flops, 0.278 ms at 989 TFLOP/s; the float32 flagship, B 4,
// T 512, H 8 / 4, D 64: 1.1e9 flops, ~85 a byte, above the ridge of the
// card's 67 TFLOP/s float32 rate).  Two designs (flash_gen.cuh):
//
// bfloat16 and float16: the tensor cores, as the Hopper kernel.  One block
// per (batch * head, 128-row q-tile), two warpgroups of 64 rows, heaviest
// q-tiles first, a loop over the K/V tiles up to the causal frontier of the
// runtime shift.  Q is loaded once, K and V through rings of two stages
// each, into 128B-swizzled panels in their own type: by TMA under
// mbarriers (one thread refills a K stage once both warpgroups' S product
// has read it, a V stage once their P.V has), or, when TMA cannot describe
// the rows (D % 8 != 0, unaligned bases), by every thread into the same
// panels.  S = Q K^T is wgmma with both operands in shared memory, over
// DC / 16 k-steps (the zero columns past D add exact zeros); O += P V takes
// P from S's accumulators in registers, rounded to the input type, with V
// through the transpose bit, in O chunks of 64 or 128 columns (caps 16 and
// 32 pad O to 64 columns, which the exp rate hides; cap 256 runs two n128
// halves).  S of tile i is issued with P.V of tile i - 1 and tile i's
// online softmax (float32 registers, log2 units, ex2) runs while P.V is on
// the tensor cores.  Tiles: 128 keys to cap 128 (Q plus four K/V tiles:
// 83,016 / 83,016 / 83,016 / 164,936 bytes at caps 16 / 32 / 64 / 128), 64
// keys at cap 256 (Q 64 KB plus four 32 KB tiles: 197,704 bytes), so one
// block per SM.
//
// float32: the FMA tile loop on the CUDA cores, which is what float32
// needs (no TF32): one block per (batch * head, 64-row q-tile), heaviest
// q-tiles first; Q staged once, K and V tiles of 64 keys (32 at D > 128)
// streamed through shared memory up to the causal frontier; the online
// softmax's m, l and rescale factor per row in shared memory, four threads
// a row; O in registers, 16 x 16 threads each holding a strided (rows,
// dims) patch.  Measured (PERF.md; NVIDIA H100 80GB HBM3, 700 W, PR 21):
// 0.095 ms at the float32 flagship shape, 17 % of its float32 bound;
// 30,976 / 43,264 / 67,840 / 116,992 / 141,184 bytes of shared memory at
// caps 16 / 32 / 64 / 128 / 256.
//
// Measured, tensor-core path (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py's kernel phase, in turns with SDPA): bf16 D 256 (B 1, T
// 8192, H 8 / 4) 0.513 ms, 54 % of its bound, 1.06x SDPA's forward (17.98
// ms on the FMA loop before); bf16 D 16 (B 8, T 2048, H 4 / 2) 0.059-0.068
// ms, about SDPA's time, held by the exp rate and the padded P.V, not the
// 0.0043 ms bound; f16 at the Llama-3-8B attention shape (B 4, T 2048, H
// 32 / 8, D 128) 0.324 ms, 43 %, 1.03x the Hopper bf16 kernel.
// ptxas -v (CUDA 12.8, sm_90a): the tensor-core kernel 241 / 224 / 194 /
// 200 / 168 registers a thread at caps 256 / 128 / 64 / 32 / 16 in bf16
// and f16 alike, the FMA loop 127 / 124 / 64 / 62 / 64, no spills.

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: Q [ROWS][LD], K and V [COLS][LD],
// the scores / probabilities [ROWS][LP], m, l and alpha [ROWS], then the
// segment ids of the rows [ROWS] and of the key tile [COLS].
template <int DC>
constexpr int fwd_smem() {
  using G = Gen<DC>;
  return 4 * ((G::ROWS + 2 * G::COLS) * G::LD + G::ROWS * G::LP +
              3 * G::ROWS + G::ROWS + G::COLS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_fwd_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, E* __restrict__ out,
    float* __restrict__ lse, int T, int Tk, int H, int KVH, int D,
    long long shift, float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + G::ROWS * G::LD;
  float* vs = ks + G::COLS * G::LD;
  float* ps = vs + G::COLS * G::LD;
  float* m_s = ps + G::ROWS * G::LP;
  float* l_s = m_s + G::ROWS;
  float* a_s = l_s + G::ROWS;
  int* sq_s = reinterpret_cast<int*>(a_s + G::ROWS);
  int* sk_s = sq_s + G::ROWS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int q_valid = min(G::ROWS, T - q0);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long q_off = (static_cast<long long>(b) * T + q0) * q_stride +
                          static_cast<long long>(h) * D;
  const E* k_bh = k + static_cast<long long>(b) * Tk * kv_stride +
                  static_cast<long long>(kvh) * D;
  const E* v_bh = v + static_cast<long long>(b) * Tk * kv_stride +
                  static_cast<long long>(kvh) * D;
  const bool segmented = seg_q != nullptr;

  load_tile<E, DC>(qs, q + q_off, q_stride, G::ROWS, q_valid, D);
  if (tid < G::ROWS) {
    m_s[tid] = M_FLOOR;
    l_s[tid] = 0.f;
    if (segmented) {
      sq_s[tid] = tid < q_valid
                      ? seg_q[static_cast<long long>(b) * T + q0 + tid]
                      : 0;
    }
  }
  // The keys any row of the block can see: [0, n_keys).
  const long long last = static_cast<long long>(q0) + q_valid - 1 + shift;
  const int n_keys =
      last < 0 ? 0 : static_cast<int>(last + 1 < Tk ? last + 1 : Tk);

  float o[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += G::COLS) {
    const int k_valid = min(G::COLS, Tk - k0);
    __syncthreads();   // the last tile's K, V and P are consumed
    load_tile<E, DC>(ks, k_bh + k0 * kv_stride, kv_stride, G::COLS, k_valid,
                     D);
    load_tile<E, DC>(vs, v_bh + k0 * kv_stride, kv_stride, G::COLS, k_valid,
                     D);
    if (segmented && tid < G::COLS) {
      sk_s[tid] = tid < k_valid
                      ? seg_k[static_cast<long long>(b) * Tk + k0 + tid]
                      : 0;
    }
    __syncthreads();

    float s[G::RI][G::CJ];
    products<DC>(s, qs, ks, D);
#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < G::CJ; ++j) {
        const int c = tx + 16 * j;
        bool vis = r < q_valid && c < k_valid &&
                   static_cast<long long>(k0) + c <=
                       static_cast<long long>(q0) + r + shift;
        if (segmented && vis) vis = sq_s[r] == sk_s[c];
        ps[r * G::LP + c] = vis ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // The online softmax, four threads a row (a quad of one warp), each
    // over every fourth column.
    {
      constexpr int TPR = GEN_THREADS / G::ROWS;
      static_assert(TPR == 4, "quad_max / quad_sum reduce four lanes");
      const int r = tid / TPR, part = tid % TPR;
      float* row = ps + r * G::LP;
      float mx = NEG_INF;
      for (int c = part; c < G::COLS; c += TPR) mx = fmaxf(mx, row[c]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, quad_max(mx));
      float sum = 0.f;
      for (int c = part; c < G::COLS; c += TPR) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = round_as<E>(p);
      }
      sum = quad_sum(sum);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < G::DJ; ++j) o[i][j] *= alpha;
    }
    accumulate<DC, G::COLS>(o, ps, vs);
  }
  __syncthreads();   // m and l of every row are final

  float lc[G::RI];   // l clamped, as the plain version clamps it
#pragma unroll
  for (int i = 0; i < G::RI; ++i) lc[i] = fmaxf(l_s[ty + 16 * i], 1e-30f);
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) {
      const int c = tx + 16 * j;
      if (r < q_valid && c < D) {
        out[q_off + r * q_stride + c] = from_f<E>(o[i][j] / lc[i]);
      }
    }
  }
  if (tid < q_valid) {
    lse[(static_cast<long long>(b) * H + h) * T + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// ---- the tensor-core path (bfloat16, float16) ------------------------------

constexpr float LN2 = 0.6931471805599453f;
constexpr float M2_FLOOR = M_FLOOR * LOG2E;   // the clamp in log2 units

// Tile geometry of the tensor-core forward at cap DC, and its shared
// memory from a 1024-byte aligned base: Q (PANELS panels of BLOCK_M rows),
// the K ring and the V ring (STAGES tiles of PANELS panels of BLOCK_N rows
// each), then the barriers q_full, k_full[STAGES], v_full[STAGES],
// k_empty[STAGES], v_empty[STAGES].
template <int DC>
struct TcFwd {
  static constexpr int BLOCK_M = 128;           // query rows per block
  static constexpr int WG_ROWS = 64;            // query rows per warpgroup
  static constexpr int CONSUMERS = BLOCK_M / WG_ROWS;
  static constexpr int THREADS = CONSUMERS * 128;
  static constexpr int BLOCK_N = DC <= 128 ? 128 : 64;   // keys per tile
  static constexpr int STAGES = 2;              // K ring and V ring depth
  static constexpr int PANELS = DC <= 64 ? 1 : DC / 64;
  static constexpr int KS = DC / 16;            // k16 steps of S = Q K^T
  static constexpr int NS = BLOCK_N / 8;        // 8-key column groups of S
  static constexpr int ON = DC <= 64 ? 64 : 128;   // columns of an O chunk
  static constexpr int OC = PANELS * 64 / ON;   // O chunks
  static constexpr int Q_PANEL = BLOCK_M * 128;
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;   // one K or V tile
  static constexpr int K_RING = Q_BYTES;
  static constexpr int V_RING = K_RING + STAGES * KV_BYTES;
  static constexpr int BARS = V_RING + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <typename E, int DC>
__global__ void __launch_bounds__(TcFwd<DC>::THREADS, 1)
    sofa_flash_gen_fwd_tc_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map, bool tma,
        const E* __restrict__ q, const E* __restrict__ k,
        const E* __restrict__ v, const int* __restrict__ seg_q,
        const int* __restrict__ seg_k, E* __restrict__ out,
        float* __restrict__ lse, int T, int Tk, int H, int KVH, int D,
        long long shift, float scale_log2) {
  using S = TcFwd<DC>;
  constexpr int BLOCK_M = S::BLOCK_M, BLOCK_N = S::BLOCK_N;
  constexpr int STAGES = S::STAGES;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + S::BARS;
  const uint32_t q_full = bar;
  auto k_s = [&](int st) { return base + S::K_RING + st * S::KV_BYTES; };
  auto v_s = [&](int st) { return base + S::V_RING + st * S::KV_BYTES; };
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return bar + 8 * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return bar + 8 * (1 + 3 * STAGES + st); };

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
    // a full barrier completes on TMA's bytes (one arrival) or on every
    // thread's arrival after its own stores
    const int fills = tma ? 1 : S::THREADS;
    mbar_init(q_full, fills);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), fills);
      mbar_init(v_full(st), fills);
      mbar_init(k_empty(st), S::CONSUMERS * 4);   // one arrival per warp
      mbar_init(v_empty(st), S::CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long kv_off = static_cast<long long>(b) * Tk * kv_stride +
                           static_cast<long long>(kvh) * D;

  // Tile j of K (is_v false) or V into its ring stage, which the caller has
  // seen released: by TMA (one thread), or by every thread.
  const CUtensorMap* k_mp = &k_map;
  const CUtensorMap* v_mp = &v_map;
  auto load_kv = [&](bool is_v, int j) {
    const int st = j % STAGES;
    const uint32_t dst = is_v ? v_s(st) : k_s(st);
    const uint32_t full = is_v ? v_full(st) : k_full(st);
    if (tma) {
      if (tid == 0) {
        const CUtensorMap* map = is_v ? v_mp : k_mp;
        mbar_arrive_expect_tx(full, S::KV_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(dst + p * S::KV_PANEL, map, full, p * 64, kvh,
                      j * BLOCK_N, b);
        }
      }
    } else {
      const int k0 = j * BLOCK_N;
      load_panels<E>(dst, S::PANELS, S::KV_PANEL,
                     (is_v ? v : k) + kv_off + k0 * kv_stride, kv_stride,
                     BLOCK_N, min(BLOCK_N, Tk - k0), D, tid, S::THREADS);
      fence_proxy_async();
      mbar_arrive(full);
    }
  };
  // Waits until a ring stage is free, where this thread will refill it.
  auto wait_free = [&](uint32_t empty, int parity) {
    if (!tma || tid == 0) mbar_wait(empty, parity);
  };

  if (n_tiles > 0) {
    if (tma) {
      if (tid == 0) {
        tma_prefetch_map(&q_map);
        tma_prefetch_map(k_mp);
        tma_prefetch_map(v_mp);
        mbar_arrive_expect_tx(q_full, S::Q_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(q_s + p * S::Q_PANEL, &q_map, q_full, p * 64, h, q0,
                      b);
        }
      }
    } else {
      load_panels<E>(q_s, S::PANELS, S::Q_PANEL,
                     q + (static_cast<long long>(b) * T + q0) * q_stride +
                         static_cast<long long>(h) * D,
                     q_stride, BLOCK_M, min(BLOCK_M, T - q0), D, tid,
                     S::THREADS);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    for (int j = 0; j < STAGES && j < n_tiles; ++j) {
      load_kv(false, j);
      load_kv(true, j);
    }
  }
  __syncwarp();

  // This thread's two rows: r0 and r0 + 8 within its warp's 16.
  const int wrow = q0 + wg * S::WG_ROWS;   // first row of the warpgroup
  const int row0 = wrow + warp * 16 + g, row1 = row0 + 8;
  const bool segmented = seg_q != nullptr;
  int sq0 = 0, sq1 = 0;
  if (segmented) {
    sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
    sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
  }
  const int* seg_kb = segmented ? seg_k + static_cast<long long>(b) * Tk
                                : nullptr;

  float o[S::OC][S::ON / 8][4];
#pragma unroll
  for (int c = 0; c < S::OC; ++c) {
#pragma unroll
    for (int j = 0; j < S::ON / 8; ++j) {
      o[c][j][0] = o[c][j][1] = o[c][j][2] = o[c][j][3] = 0.f;
    }
  }
  float m0 = M2_FLOOR, m1 = M2_FLOOR, l0 = 0.f, l1 = 0.f;

  // Q rows of this warpgroup: rows [wg * 64, wg * 64 + 64) of each panel.
  const uint32_t q_wg = q_s + wg * S::WG_ROWS * 128;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  float s[S::NS][4];
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
      for (int n = 0; n < S::NS; ++n) {
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
      for (int n = 0; n < S::NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < S::NS; ++n) {
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
    for (int n = 0; n < S::NS; ++n) {
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
  // O *= alpha, then P (rounded to E) into the register A layout for P.V.
  auto rescale_pack = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int c = 0; c < S::OC; ++c) {
#pragma unroll
      for (int j = 0; j < S::ON / 8; ++j) {
        o[c][j][0] *= alpha0; o[c][j][1] *= alpha0;
        o[c][j][2] *= alpha1; o[c][j][3] *= alpha1;
      }
    }
#pragma unroll
    for (int n = 0; n < S::NS; ++n) {
      pa[n / 2][(n % 2) * 2] = pack2<E>(s[n][0], s[n][1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack2<E>(s[n][2], s[n][3]);
    }
  };
  auto fence_o = [&] {
#pragma unroll
    for (int c = 0; c < S::OC; ++c) fence_operands(o[c]);
    fence_operands(pa);
  };
  auto issue_s = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      const int p = ks / 4, kc = ks % 4;
      const uint64_t da = desc_sw128(q_wg + p * S::Q_PANEL + kc * 32, 16,
                                     SW128_SBO);
      const uint64_t db = desc_sw128(k_s(st) + p * S::KV_PANEL + kc * 32, 16,
                                     SW128_SBO);
      wgmma_ss<BLOCK_N, 0, E>(s, da, db, ks > 0);
    }
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < S::OC; ++c) {
        const uint64_t db = desc_sw128(
            v_s(st) + c * (S::ON / 64) * S::KV_PANEL + kk * 16 * 128,
            S::KV_PANEL, SW128_SBO);
        wgmma_rs<S::ON, 1, E>(o[c], pa[kk], db, 1);
      }
    }
  };
  auto release = [&](uint32_t empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  if (n_tiles > 0) {
    // Tile 0: S, then its softmax with nothing to overlap.
    mbar_wait(k_full(0), 0);
    __syncwarp();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    release(k_empty(0));
    float a0, a1;
    softmax(0, a0, a1);
    rescale_pack(a0, a1);
  }
  // Tile i: S_i and P_{i-1} V_{i-1} are issued together; tile i's softmax
  // runs while P_{i-1} V_{i-1} is still on the tensor cores.
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % STAGES, sp = (i - 1) % STAGES;
    // Refills, a tile ahead of their use: K_{i+1} into the stage whose S
    // both warpgroups finished in iteration i - 1 (or earlier), V_i into
    // the stage whose P.V they finished there.
    if (i + 1 < n_tiles && i + 1 >= STAGES) {
      wait_free(k_empty((i + 1) % STAGES), ((i + 1 - STAGES) / STAGES) & 1);
      load_kv(false, i + 1);
    }
    if (i >= STAGES) {
      wait_free(v_empty(i % STAGES), ((i - STAGES) / STAGES) & 1);
      load_kv(true, i);
    }
    __syncwarp();
    mbar_wait(k_full(st), (i / STAGES) & 1);
    mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
    __syncwarp();
    fence_o();
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    release(k_empty(st));
    float a0, a1;
    softmax(i, a0, a1);
    wgmma_wait<0>();
    fence_o();
    release(v_empty(sp));
    rescale_pack(a0, a1);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(sp), ((n_tiles - 1) / STAGES) & 1);
    __syncwarp();
    fence_o();
    wgmma_fence();
    issue_pv(sp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o();
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  E* out_bh = out + static_cast<long long>(b) * T * q_stride +
              static_cast<long long>(h) * D;
  float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
  // A row that saw no key keeps m at the floor: report it as M_FLOOR
  // exactly, not through a rounding of M2_FLOOR * LN2.
  const float ml0 = m0 > M2_FLOOR ? m0 * LN2 : M_FLOOR;
  const float ml1 = m1 > M2_FLOOR ? m1 * LN2 : M_FLOOR;
  if (row0 < T) {
#pragma unroll
    for (int c = 0; c < S::OC; ++c) {
      store_acc_row<E>(out_bh + row0 * q_stride, o[c], 0, inv0, t,
                       c * S::ON, D);
    }
    if (t == 0) lse_bh[row0] = ml0 + logf(lc0);
  }
  if (row1 < T) {
#pragma unroll
    for (int c = 0; c < S::OC; ++c) {
      store_acc_row<E>(out_bh + row1 * q_stride, o[c], 1, inv1, t,
                       c * S::ON, D);
    }
    if (t == 0) lse_bh[row1] = ml1 + logf(lc1);
  }
}

template <typename E, int DC>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* seg_q, const int* seg_k, void* out,
                      float* lse, int B, int T, int Tk, int H, int KVH, int D,
                      long long shift, float scale, cudaStream_t stream) {
  using S = TcFwd<DC>;
  CUtensorMap q_map{}, k_map{}, v_map{};
  const bool tma = tma_fits(D, {q, k, v});
  if (tma) {
    cudaError_t err = encode_heads(&q_map, q, D, H, T, B, S::BLOCK_M,
                                   tma_type<E>());
    if (err == cudaSuccess) {
      err = encode_heads(&k_map, k, D, KVH, Tk, B, S::BLOCK_N, tma_type<E>());
    }
    if (err == cudaSuccess) {
      err = encode_heads(&v_map, v, D, KVH, Tk, B, S::BLOCK_N, tma_type<E>());
    }
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = allow_smem(sofa_flash_gen_fwd_tc_kernel<E, DC>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + S::BLOCK_M - 1) / S::BLOCK_M);
  sofa_flash_gen_fwd_tc_kernel<E, DC><<<grid, S::THREADS, S::BYTES, stream>>>(
      q_map, k_map, v_map, tma, static_cast<const E*>(q),
      static_cast<const E*>(k), static_cast<const E*>(v), seg_q, seg_k,
      static_cast<E*>(out), lse, T, Tk, H, KVH, D, shift, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B,T,H,D], k/v [B,Tk,KVH,D]
// contiguous, all of the element type `dtype` (GenDtype: float32 runs the
// FMA loop, bfloat16 and float16 the tensor cores, by TMA when the rows and
// bases allow it, else by the threads' own loads); seg_q [B,T] /
// seg_k [B,Tk] int32 or both null; out [B,T,H,D] in that type and lse
// [B,H,T] f32 are allocated by the caller.  Launches on `stream` without
// synchronizing and returns cudaGetLastError() (cudaErrorInvalidValue for
// a dtype, head dim or shape it does not take).
extern "C" int sofa_flash_gen_fwd(const void* q, const void* k,
                                  const void* v, const int* seg_q,
                                  const int* seg_k, void* out, float* lse,
                                  int dtype, int B, int T, int Tk, int H,
                                  int KVH, int D, long long shift,
                                  float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fma = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = fwd_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_fwd_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_fwd_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), seg_q, seg_k, static_cast<E*>(out), lse,
        T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  };
  auto tc = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    return launch_tc<E, decltype(cap)::value>(q, k, v, seg_q, seg_k, out,
                                              lse, B, T, Tk, H, KVH, D, shift,
                                              scale, st);
  };
  return static_cast<int>(dispatch_paths(dtype, D, fma, tc));
}

// Dynamic shared memory one block of the bfloat16 / float16 (tensor-core)
// path asks for at head dim d (0 if unsupported); the float32 path's is in
// the header note.
extern "C" int sofa_flash_gen_fwd_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return TcFwd<16>::BYTES;
    case 32: return TcFwd<32>::BYTES;
    case 64: return TcFwd<64>::BYTES;
    case 128: return TcFwd<128>::BYTES;
    case 256: return TcFwd<256>::BYTES;
    default: return 0;
  }
}
