// sofa_flash_gen_bwd_dq: the dQ half of the fused attention backward for
// every (dtype, head dim) the Hopper kernel sofa_flash_bwd_dq does not
// take: bfloat16, float16 or float32 at any head dim 1..256, float32
// accumulation, dq out in the inputs' dtype or float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_bwd_q_kernel (launched as
// name="sofa_flash_bwd_dq" by _flash_backward, flash_pallas.py:673) and
// computes the same function as flash_cuda._flash_bwd_dq_plain: for each
// query row, over every key the causal rule (key j visible to query i iff
// j <= i + shift) and the optional segment ids let it see,
//   p  = exp(s * scale - max(lse, -1e29))           s = Q K^T (float32)
//   dp = dO V^T
//   ds = round_q(p * (dp - delta))                   delta = rowsum(dO * O)
//   dQ = ds K,  times scale after the product
// with query head h reading compact KV head h / (H / KVH).  A row with no
// visible key writes exact zeros.  Every design keeps dQ in registers over
// the whole key loop, with no split over keys and no atomics: two launches
// agree bit for bit.
//
// What bounds it on an H100: operations, three products over the visible
// (query, key) pairs, 6*B*H*D*T*(T+1)/2 flops under causal masking (bf16 D
// 256 at B 1, T 8192, H 8 / 4: 0.417 ms at 989 TFLOP/s; f16 at the
// Llama-3-8B attention shape B 4, T 2048, H 32 / 8, D 128: 0.209 ms).  Two
// designs (flash_gen.cuh):
//
// bfloat16 and float16: the tensor cores, as the Hopper kernel.  One block
// per (batch * head, 128-row q-tile), heaviest q-tiles first, two consumer
// warpgroups of 64 rows; the rows' clamped lse and delta in registers.  Q
// and dO are loaded once and K/V tiles stream through a ring up to the
// causal frontier of the runtime shift, into 128B-swizzled panels in their
// own type: by TMA under mbarriers, or, when TMA cannot describe the rows
// (D % 8 != 0, unaligned bases), by the consumers' threads into the same
// panels (load_panels).  s = Q K^T and dp = dO V^T are wgmma with both
// operands in shared memory over DC / 16 k-steps (the zero columns past D
// add exact zeros), committed apart, so that p is formed while dp is still
// on the tensor cores; ds repacks from dp's accumulator straight into the
// register A operand of dQ += ds K, rounded to the input type there (once),
// with K through the transpose bit.  Masks run only on the tiles that cross
// a warpgroup's diagonal, the ragged end of Tk or a segmented call; a tile
// no row of a warpgroup can see skips its products, and a warpgroup wholly
// past T computes nothing but still releases every stage, so every
// barrier's arrivals come.  By cap:
//   - 16, 32, 64: one 64-column panel (caps 16 and 32 pad to it), 128-key
//     tiles (s and dp m64n128, dQ m64n64), four stages, no producer:
//     thread 0 refills the stage both warpgroups released at the end of
//     the previous tile (every thread on the thread-by-thread path);
//   - 128: 64-key tiles (s and dp m64n64, dQ m64n128), four stages, and a
//     producer warpgroup that refills the ring by TMA as the consumers
//     release it, at 24 registers (setmaxnreg), the consumers at 240.  On
//     the thread-by-thread path the producer only gives up its registers and
//     the consumers refill the ring themselves, as at the other caps;
//   - 256: Q and dO alone take 128 KB, so 32-key tiles in three stages
//     (230,456 bytes of the 232,448 a block may have); s and dp m64n32, dQ
//     two m64n128 halves over K's four panels (128 accumulator registers a
//     thread), no producer (253 registers a thread).
// Shared memory 164,936 / 164,936 / 164,936 / 197,704 / 230,456 bytes a
// block at caps 16 / 32 / 64 / 128 / 256 (sofa_flash_gen_bwd_dq_smem_bytes),
// so one block per SM.
//
// float32: the FMA tile loop on the CUDA cores (no TF32): one block per
// (batch * head, 64-row q-tile), heaviest q-tiles first; Q, dO and the
// rows' clamped lse, delta and segment ids staged once as float32; K and V
// tiles of 64 keys (32 at D > 128) streamed up to the causal frontier;
// dQ in registers.  Shared memory 35,072 / 51,456 / 84,224 / 149,760 /
// 206,720 bytes a block at caps 16 / 32 / 64 / 128 / 256.
//
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py's
// kernel phase, in turns with SDPA): bf16 D 256 (B 1, T 8192, H 8 / 4)
// 0.9029 ms, 46 % of its bound, 0.53x SDPA's whole backward (24.35-24.74
// ms on the FMA loop before); f16 at the Llama-3-8B attention shape
// 0.4144-0.4174 ms, 50 %, against the Hopper bf16 kernel's 0.3726-0.3872
// ms in the same run (11.24-11.38 ms before); bf16 D 16 (B 8, T 2048, H 4 /
// 2) 0.0618-0.0641 ms (0.416-0.420 before), held by the 67 M causal
// scores' ex2 (~0.02 ms of the SFUs) and the products padded to 64
// columns, not by its 0.0065 ms bound; float32 at the flagship shape (B 4,
// T 512, H 8 / 4, D 64) 0.1250-0.1253 ms, 19 % of the float32 bound.  At
// cap 128 the producer was timed once against the same kernel without it
// (consumers refilling, 213 registers), in turns in one call at the Llama-3-8B
// attention shape: 0.4178-0.4179 ms (f16) and 0.4190-0.4238 ms (bf16) with
// it, 0.4499-0.4503 and 0.4464-0.4502 ms without.
// ptxas -v (CUDA 12.8, sm_90a): the tensor-core kernel 253 / 168 / 244 /
// 244 / 245 registers a thread at caps 256 / 128 / 64 / 32 / 16 in bf16 and
// f16 alike (at cap 128, 65,536 / 384 at launch, before setmaxnreg gives
// each consumer 240), no spills;
// the FMA loop 128 / 127 / 79 / 64 / 64, no spills but 12 bytes at caps 32
// and 16.

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: Q and dO [ROWS][LD], K and V
// [COLS][LD], ds [ROWS][LP], the rows' lse, delta and segment ids [ROWS],
// the key tile's segment ids [COLS].
template <int DC>
constexpr int dq_smem() {
  using G = Gen<DC>;
  return 4 * (2 * (G::ROWS + G::COLS) * G::LD + G::ROWS * G::LP +
              3 * G::ROWS + G::COLS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_bwd_dq_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, void* dq,
    bool out_f32, int T, int Tk, int H, int KVH, int D, long long shift,
    float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + G::ROWS * G::LD;
  float* ks = gs + G::ROWS * G::LD;
  float* vs = ks + G::COLS * G::LD;
  float* ds = vs + G::COLS * G::LD;
  float* lse_s = ds + G::ROWS * G::LP;
  float* dl_s = lse_s + G::ROWS;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::ROWS);
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
  load_tile<E, DC>(gs, dout + q_off, q_stride, G::ROWS, q_valid, D);
  if (tid < G::ROWS) {
    const bool in = tid < q_valid;
    const long long row = (static_cast<long long>(b) * H + h) * T + q0 + tid;
    lse_s[tid] = in ? fmaxf(lse[row], M_FLOOR) : 0.f;
    dl_s[tid] = in ? delta[row] : 0.f;
    if (segmented) {
      sq_s[tid] = in ? seg_q[static_cast<long long>(b) * T + q0 + tid] : 0;
    }
  }
  // The keys any row of the block can see: [0, n_keys).
  const long long last = static_cast<long long>(q0) + q_valid - 1 + shift;
  const int n_keys =
      last < 0 ? 0 : static_cast<int>(last + 1 < Tk ? last + 1 : Tk);

  float dq_acc[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += G::COLS) {
    const int k_valid = min(G::COLS, Tk - k0);
    __syncthreads();   // the last tile's K and ds are consumed
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

    float s[G::RI][G::CJ], dp[G::RI][G::CJ];
    products<DC>(s, qs, ks, D);
    products<DC>(dp, gs, vs, D);
#pragma unroll
    for (int i = 0; i < G::RI; ++i) {
      const int r = ty + 16 * i;   // query
#pragma unroll
      for (int j = 0; j < G::CJ; ++j) {
        const int c = tx + 16 * j;   // key
        bool vis = r < q_valid && c < k_valid &&
                   static_cast<long long>(k0) + c <=
                       static_cast<long long>(q0) + r + shift;
        if (segmented && vis) vis = sq_s[r] == sk_s[c];
        float dsv = 0.f;
        if (vis) {
          // the product, then the difference, as the plain version
          const float p =
              expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_s[r]));
          dsv = round_as<E>(p * (dp[i][j] - dl_s[r]));
        }
        ds[r * G::LP + c] = dsv;
      }
    }
    __syncthreads();
    accumulate<DC, G::COLS>(dq_acc, ds, ks);
  }

  if (out_f32) {
    store_tile<float, DC>(static_cast<float*>(dq) + q_off, q_stride, q_valid,
                          D, dq_acc, scale);
  } else {
    store_tile<E, DC>(static_cast<E*>(dq) + q_off, q_stride, q_valid, D,
                      dq_acc, scale);
  }
}

// ---- the tensor-core path (bfloat16, float16) ------------------------------

// Tile geometry of the tensor-core dQ kernel at cap DC, and its shared
// memory from a 1024-byte aligned base: Q then dO (PANELS panels of BLOCK_M
// rows each), per stage K then V (PANELS panels of BLOCK_N rows each), then
// the barriers q_full, full[STAGES], empty[STAGES].
template <int DC>
struct TcDq {
  static constexpr int BLOCK_M = 128;           // query rows per block
  static constexpr int WG_ROWS = 64;            // query rows per warpgroup
  static constexpr int CONSUMERS = BLOCK_M / WG_ROWS;
  // At cap 128 a producer warpgroup refills the ring by TMA, and the
  // consumers may hold 240 registers; the other caps need more than that.
  static constexpr bool PRODUCER = DC == 128;
  static constexpr int CONSUMER_THREADS = CONSUMERS * 128;
  static constexpr int THREADS = CONSUMER_THREADS + (PRODUCER ? 128 : 0);
  // the thread that issues TMA
  static constexpr int LOADER = PRODUCER ? CONSUMER_THREADS : 0;
  static constexpr int BLOCK_N = DC <= 64 ? 128 : DC <= 128 ? 64 : 32;
  static constexpr int STAGES = DC <= 128 ? 4 : 3;   // K/V ring depth
  static constexpr int PANELS = DC <= 64 ? 1 : DC / 64;
  static constexpr int KS = DC / 16;            // k16 steps of s and dp
  static constexpr int NS = BLOCK_N / 8;        // 8-key column groups of s
  static constexpr int KP = BLOCK_N / 16;       // k16 steps of dQ
  static constexpr int ON = DC <= 64 ? 64 : 128;   // columns of a dQ chunk
  static constexpr int OC = PANELS * 64 / ON;   // dQ chunks
  static constexpr int Q_PANEL = BLOCK_M * 128;
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;     // Q or dO
  static constexpr int KV_BYTES = PANELS * KV_PANEL;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <typename E, int DC>
__global__ void __launch_bounds__(TcDq<DC>::THREADS, 1)
    sofa_flash_gen_bwd_dq_tc_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap do_map, bool tma,
        const E* __restrict__ q, const E* __restrict__ k,
        const E* __restrict__ v, const E* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
        void* __restrict__ dq, bool out_f32, int T, int Tk, int H, int KVH,
        int D, long long shift, float scale) {
  using S = TcDq<DC>;
  constexpr int BLOCK_M = S::BLOCK_M, BLOCK_N = S::BLOCK_N;
  constexpr int STAGES = S::STAGES;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + S::Q_BYTES;
  const uint32_t bar = base + S::BARS;
  const uint32_t q_full = bar;
  auto k_s = [&](int st) { return base + S::RING + st * S::STAGE_BYTES; };
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;             // this warpgroup's 64 rows
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // accumulator row group / col pair
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const bool segmented = seg_q != nullptr;

  // Causal frontier: the last key any row of this block (below T) can see.
  const long long last =
      static_cast<long long>(min(q0 + BLOCK_M, T)) - 1 + shift;
  int n_tiles = 0;
  if (last >= 0) {
    const long long by_mask = last / BLOCK_N + 1;
    const long long by_len = (Tk + BLOCK_N - 1) / BLOCK_N;
    n_tiles = static_cast<int>(by_mask < by_len ? by_mask : by_len);
  }

  if (tid == 0) {
    // a full barrier completes on TMA's bytes (one arrival) or on every
    // thread's arrival after its own stores
    const int fills = tma ? 1 : S::CONSUMER_THREADS;
    mbar_init(q_full, fills);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), fills);
      mbar_init(empty(st), S::CONSUMERS * 4);   // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long q_off = static_cast<long long>(b) * T * q_stride +
                          static_cast<long long>(h) * D;
  const long long kv_off = static_cast<long long>(b) * Tk * kv_stride +
                           static_cast<long long>(kvh) * D;

  // Tile j of K and V into its ring stage, which the caller has seen
  // released: by TMA (one thread), or by every thread.
  const CUtensorMap* k_mp = &k_map;
  const CUtensorMap* v_mp = &v_map;
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    if (tma) {
      if (tid == S::LOADER) {
        mbar_arrive_expect_tx(full(st), S::STAGE_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(k_s(st) + p * S::KV_PANEL, k_mp, full(st), p * 64, kvh,
                      j * BLOCK_N, b);
          tma_load_4d(k_s(st) + S::KV_BYTES + p * S::KV_PANEL, v_mp,
                      full(st), p * 64, kvh, j * BLOCK_N, b);
        }
      }
    } else {
      const int k0 = j * BLOCK_N;
      const int valid = min(BLOCK_N, Tk - k0);
      load_panels<E>(k_s(st), S::PANELS, S::KV_PANEL,
                     k + kv_off + k0 * kv_stride, kv_stride, BLOCK_N, valid,
                     D, tid, S::CONSUMER_THREADS);
      load_panels<E>(k_s(st) + S::KV_BYTES, S::PANELS, S::KV_PANEL,
                     v + kv_off + k0 * kv_stride, kv_stride, BLOCK_N, valid,
                     D, tid, S::CONSUMER_THREADS);
      fence_proxy_async();
      mbar_arrive(full(st));
    }
  };

  // Q and dO once, and the ring's first STAGES tiles.
  if (n_tiles > 0) {
    if (tma) {
      if (tid == S::LOADER) {
        tma_prefetch_map(k_mp);
        tma_prefetch_map(v_mp);
        mbar_arrive_expect_tx(q_full, 2 * S::Q_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(q_s + p * S::Q_PANEL, &q_map, q_full, p * 64, h, q0,
                      b);
          tma_load_4d(do_s + p * S::Q_PANEL, &do_map, q_full, p * 64, h, q0,
                      b);
        }
      }
    } else if (tid < S::CONSUMER_THREADS) {
      const int valid = min(BLOCK_M, T - q0);
      load_panels<E>(q_s, S::PANELS, S::Q_PANEL, q + q_off + q0 * q_stride,
                     q_stride, BLOCK_M, valid, D, tid, S::CONSUMER_THREADS);
      load_panels<E>(do_s, S::PANELS, S::Q_PANEL,
                     dout + q_off + q0 * q_stride, q_stride, BLOCK_M, valid,
                     D, tid, S::CONSUMER_THREADS);
      fence_proxy_async();
      mbar_arrive(q_full);
    }
    if (tma || tid < S::CONSUMER_THREADS) {
      for (int j = 0; j < STAGES && j < n_tiles; ++j) load_kv(j);
    }
  }
  __syncwarp();

  if constexpr (S::PRODUCER) {
    if (wg == S::CONSUMERS) {
      // The producer warpgroup: one thread refills the ring by TMA as the
      // consumers release it; the others only give up their registers.  On
      // the thread-by-thread path the consumers refill it themselves.
      setmaxnreg_dec<24>();
      if (tma && tid == S::LOADER) {
        for (int j = STAGES; j < n_tiles; ++j) {
          mbar_wait(empty(j % STAGES), ((j / STAGES) + 1) & 1);
          load_kv(j);
        }
      }
      return;
    }
    setmaxnreg_inc<240>();
  }

  // This thread's two rows: row0 and row0 + 8 within its warp's 16.  Rows
  // past T are never stored; their lse and delta are never read.
  const int wrow = q0 + wg * S::WG_ROWS;   // first row of the warpgroup
  const int row0 = wrow + warp * 16 + g, row1 = row0 + 8;
  const bool dead = wrow >= T;             // every row past T
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * T;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * T;
  const float lse0 = row0 < T ? fmaxf(lse_bh[row0], M_FLOOR) : 0.f;
  const float lse1 = row1 < T ? fmaxf(lse_bh[row1], M_FLOOR) : 0.f;
  const float dlt0 = row0 < T ? delta_bh[row0] : 0.f;
  const float dlt1 = row1 < T ? delta_bh[row1] : 0.f;
  int sq0 = 0, sq1 = 0;
  if (segmented) {
    sq0 = row0 < T ? seg_q[static_cast<long long>(b) * T + row0] : 0;
    sq1 = row1 < T ? seg_q[static_cast<long long>(b) * T + row1] : 0;
  }
  const int* seg_kb = segmented ? seg_k + static_cast<long long>(b) * Tk
                                : nullptr;

  float dq_acc[S::OC][S::ON / 8][4];
#pragma unroll
  for (int c = 0; c < S::OC; ++c) {
#pragma unroll
    for (int j = 0; j < S::ON / 8; ++j) {
      dq_acc[c][j][0] = dq_acc[c][j][1] = dq_acc[c][j][2] = dq_acc[c][j][3] =
          0.f;
    }
  }
  float s[S::NS][4], dp[S::NS][4];
  uint32_t da[S::KP][4];
  // This warpgroup's Q and dO rows: rows [wg * 64, wg * 64 + 64) of each
  // panel (8 KB in, a multiple of the swizzle's 1024 bytes).
  const uint32_t q_wg = q_s + wg * S::WG_ROWS * 128;
  const uint32_t do_wg = do_s + wg * S::WG_ROWS * 128;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const int kt = j * BLOCK_N;
    // Refill: tile j + STAGES - 1 into the stage both warpgroups released
    // at the end of tile j - 1; it lands while this tile and the next ones
    // compute.
    if (j >= 1 && j + STAGES - 1 < n_tiles && (!S::PRODUCER || !tma)) {
      if (!tma || tid == S::LOADER) {
        mbar_wait(empty((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      }
      load_kv(j + STAGES - 1);
    }
    __syncwarp();
    mbar_wait(full(st), (j / STAGES) & 1);
    // no row of this warpgroup sees any key of the tile
    const bool blind =
        dead || kt > static_cast<long long>(wrow) + S::WG_ROWS - 1 + shift;
    if (!blind) {
      // s = Q K^T and dp = dO V^T, issued together, committed apart
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const int off_a = (ks / 4) * S::Q_PANEL + (ks % 4) * 32;
        const int off_b = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
        wgmma_ss<BLOCK_N, 0, E>(
            s, desc_sw128(q_wg + off_a, 16, SW128_SBO),
            desc_sw128(k_s(st) + off_b, 16, SW128_SBO), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const int off_a = (ks / 4) * S::Q_PANEL + (ks % 4) * 32;
        const int off_b = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
        wgmma_ss<BLOCK_N, 0, E>(
            dp, desc_sw128(do_wg + off_a, 16, SW128_SBO),
            desc_sw128(k_s(st) + S::KV_BYTES + off_b, 16, SW128_SBO),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(s);

      // p = exp(s * scale - lse) in place of s, exactly 0 where masked,
      // while dp is still on the tensor cores
      const bool need_mask =
          segmented || kt + BLOCK_N > Tk ||
          static_cast<long long>(kt) + BLOCK_N - 1 > wrow + shift;
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < S::NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + n * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            bool masked =
                key >= Tk || key > static_cast<long long>(row) + shift;
            if (segmented && !masked) {
              masked = seg_kb[key] != (e < 2 ? sq0 : sq1);
            }
            s[n][e] = masked ? 0.f
                             : bwd_p(s[n][e], scale, e < 2 ? lse0 : lse1);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < S::NS; ++n) {
          s[n][0] = bwd_p(s[n][0], scale, lse0);
          s[n][1] = bwd_p(s[n][1], scale, lse0);
          s[n][2] = bwd_p(s[n][2], scale, lse1);
          s[n][3] = bwd_p(s[n][3], scale, lse1);
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
      // ds = p (dp - delta), rounded to E as it packs into the register A
      // operand of dQ += ds K
#pragma unroll
      for (int n = 0; n < S::NS; ++n) {
        da[n / 2][(n % 2) * 2] = pack2<E>(s[n][0] * (dp[n][0] - dlt0),
                                          s[n][1] * (dp[n][1] - dlt0));
        da[n / 2][(n % 2) * 2 + 1] = pack2<E>(s[n][2] * (dp[n][2] - dlt1),
                                              s[n][3] * (dp[n][3] - dlt1));
      }
      // dQ += ds K, K read through the transpose bit, chunk c over K's
      // panels [c * ON / 64, (c + 1) * ON / 64)
#pragma unroll
      for (int c = 0; c < S::OC; ++c) fence_operands(dq_acc[c]);
      fence_operands(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::KP; ++kk) {
#pragma unroll
        for (int c = 0; c < S::OC; ++c) {
          wgmma_rs<S::ON, 1, E>(
              dq_acc[c], da[kk],
              desc_sw128(k_s(st) + c * (S::ON / 64) * S::KV_PANEL +
                             kk * 16 * 128,
                         S::KV_PANEL, SW128_SBO),
              1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < S::OC; ++c) fence_operands(dq_acc[c]);
      fence_operands(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  auto store = [&](int row, int half) {
    const long long at = q_off + row * q_stride;
#pragma unroll
    for (int c = 0; c < S::OC; ++c) {
      if (out_f32) {
        store_acc_row<float>(static_cast<float*>(dq) + at, dq_acc[c], half,
                             scale, t, c * S::ON, D);
      } else {
        store_acc_row<E>(static_cast<E*>(dq) + at, dq_acc[c], half, scale, t,
                         c * S::ON, D);
      }
    }
  };
  if (row0 < T) store(row0, 0);
  if (row1 < T) store(row1, 1);
}

template <typename E, int DC>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* seg_q, const int* seg_k, void* dq,
                      bool out_f32, int B, int T, int Tk, int H, int KVH,
                      int D, long long shift, float scale,
                      cudaStream_t stream) {
  using S = TcDq<DC>;
  CUtensorMap q_map{}, k_map{}, v_map{}, do_map{};
  const bool tma = tma_fits(D, {q, k, v, dout});
  if (tma) {
    constexpr CUtensorMapDataType ty = tma_type<E>();
    cudaError_t err = encode_heads(&q_map, q, D, H, T, B, S::BLOCK_M, ty);
    if (err == cudaSuccess) {
      err = encode_heads(&do_map, dout, D, H, T, B, S::BLOCK_M, ty);
    }
    if (err == cudaSuccess) {
      err = encode_heads(&k_map, k, D, KVH, Tk, B, S::BLOCK_N, ty);
    }
    if (err == cudaSuccess) {
      err = encode_heads(&v_map, v, D, KVH, Tk, B, S::BLOCK_N, ty);
    }
    if (err != cudaSuccess) return err;
  }
  cudaError_t err =
      allow_smem(sofa_flash_gen_bwd_dq_tc_kernel<E, DC>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T + S::BLOCK_M - 1) / S::BLOCK_M);
  sofa_flash_gen_bwd_dq_tc_kernel<E, DC>
      <<<grid, S::THREADS, S::BYTES, stream>>>(
          q_map, k_map, v_map, do_map, tma, static_cast<const E*>(q),
          static_cast<const E*>(k), static_cast<const E*>(v),
          static_cast<const E*>(dout), lse, delta, seg_q, seg_k, dq, out_f32,
          T, Tk, H, KVH, D, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/dout [B,T,H,D], k/v
// [B,Tk,KVH,D] contiguous, all of the element type `dtype` (GenDtype:
// float32 runs the FMA loop, bfloat16 and float16 the tensor cores, by TMA
// when the rows and bases allow it, else by the threads' own loads); lse
// and delta [B,H,T] f32; seg_q [B,T] / seg_k [B,Tk] int32 or both null; dq
// [B,T,H,D] in float32 when out_f32 != 0, else in `dtype`, allocated by the
// caller.  Launches on `stream` without synchronizing and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype, head dim or shape
// it does not take).
extern "C" int sofa_flash_gen_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* seg_q, const int* seg_k,
                                     void* dq, int out_f32, int dtype, int B,
                                     int T, int Tk, int H, int KVH, int D,
                                     long long shift, float scale,
                                     void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (T + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fma = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = dq_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_bwd_dq_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_bwd_dq_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        seg_q, seg_k, dq, out_f32 != 0, T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  };
  auto tc = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    return launch_tc<E, decltype(cap)::value>(
        q, k, v, dout, lse, delta, seg_q, seg_k, dq, out_f32 != 0, B, T, Tk,
        H, KVH, D, shift, scale, st);
  };
  return static_cast<int>(dispatch_paths(dtype, D, fma, tc));
}

// Dynamic shared memory one block of the bfloat16 / float16 (tensor-core)
// path asks for at head dim d (0 if unsupported); the float32 path's is in
// the header note.
extern "C" int sofa_flash_gen_bwd_dq_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return TcDq<16>::BYTES;
    case 32: return TcDq<32>::BYTES;
    case 64: return TcDq<64>::BYTES;
    case 128: return TcDq<128>::BYTES;
    case 256: return TcDq<256>::BYTES;
    default: return 0;
  }
}
