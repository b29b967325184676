// sofa_flash_gen_bwd_kv: the dK/dV half of the fused attention backward
// for every (dtype, head dim) the Hopper kernel sofa_flash_bwd_kv does not
// take: bfloat16, float16 or float32 at any head dim 1..256, float32
// accumulation, dk/dv out in the inputs' dtype or float32.
//
// Replaces, on that part of its domain, the TPU kernel
// sofa_tpu/workloads/flash_pallas.py:_bwd_kv_kernel (launched as
// name="sofa_flash_bwd_kv" by _flash_backward, flash_pallas.py:619) and
// computes the same function as flash_cuda._flash_bwd_kv_plain.  For one
// compact K/V head and one key tile, summed over every query head of its
// GQA group and every query the causal rule (key j visible to query i iff
// j <= i + shift) and the optional segment ids let see it:
//   p^T  = exp(s^T * scale - max(lse, -1e29))      s^T = K Q^T (float32)
//   dV  += round_dO(p^T) dO
//   dp^T = V dO^T
//   ds^T = round_q(p^T * (dp^T - delta))            delta = rowsum(dO * O)
//   dK  += ds^T Q,  times scale after the product
// Masked pairs and query rows past T give p = 0 exactly, so a row with no
// visible key (lse ~ -1e29 from the forward) contributes nothing, and a key
// tile that no query sees writes exact zeros.  In every design the block
// walks the group's query heads and, for each, the query tiles from the
// first one that can see the block's first key to the end of T, with dK
// and dV in registers across the whole walk: the group sum needs no
// atomics and no second pass, and two launches agree bit for bit.
//
// What bounds it on an H100: operations, four products over the visible
// (key, query) pairs, 8*B*H*D*T*(T+1)/2 flops under causal masking (bf16 D
// 256 at B 1, T 8192, H 8 / 4: 0.556 ms at 989 TFLOP/s).  Two designs
// (flash_gen.cuh):
//
// bfloat16 and float16: the tensor cores, as the Hopper kernel but without
// its producer warpgroup.  Two warpgroups, so a thread may hold 255
// registers: at cap 128 it holds dK and dV of 128 columns, s^T, dp^T and
// the packed operands, which did not fit the 240 that setmaxnreg can give
// a consumer beside a producer warpgroup without spilling.  K and V are
// loaded once; 64-query Q and dO tiles stream through a ring of
// 128B-swizzled panels in their own type, the tile's clamped lse, delta and
// segment ids copied beside them by the first 64 threads.  At the top of
// each tile the stage both warpgroups released at the end of the previous
// one is refilled: by TMA (thread 0), or, when TMA cannot describe the rows
// (D % 8 != 0, unaligned bases), by every thread into the same panels.
// s^T = K Q^T and dp^T = V dO^T are wgmma over DC / 16 k-steps, p^T and
// ds^T float32 in registers, then dV += p^T dO and dK += ds^T Q with dO and
// Q read through the transpose bit.  To cap 128 each warpgroup owns 64 keys
// of a 128-key block and all of the head dim (accumulators of 64 or 128
// columns; caps 16 and 32 pad to 64), p^T and ds^T repack from their
// accumulators straight into the register A operands, and the ring has 3
// stages.  At cap 256 dK and dV for 64 keys x 256 columns alone would take
// 256 registers a thread, so both warpgroups share a 64-key block: each
// forms s^T and dp^T for half of the query tile (m64n32) and accumulates
// half of the head dim (128 + 128 registers), and they exchange p^T and
// ds^T through two double-buffered swizzled panels in shared memory (a
// named barrier a tile), which feed the dV / dK products as shared-memory A
// operands; the ring has 2 stages.  Shared memory: 85,304 / 85,304 /
// 85,304 / 167,224 / 231,976 bytes a block at caps 16 / 32 / 64 / 128 /
// 256, so one block per SM.
//
// float32: the FMA tile loop on the CUDA cores (no TF32): one block per
// (batch * KV head, 64-key tile), the earliest key tiles first; K and V
// staged once, then for each query tile (64 rows, 32 at D > 128) Q, dO and
// the tile's lse, delta and segment ids staged as float32.  Shared memory
// 51,712 / 68,096 / 100,864 / 166,400 / 214,912 bytes at caps 16 / 32 / 64
// / 128 / 256 (PR 21).
//
// Measured, tensor-core path (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py's kernel phase, in turns with SDPA): bf16 D 256 (B 1, T
// 8192, H 8 / 4) 1.23-1.28 ms, 44-45 % of its bound, 0.73-0.74x SDPA's
// whole backward (28.1 ms on the FMA loop before); bf16 D 16 (B 8, T 2048,
// H 4 / 2) 0.106-0.108 ms; f16 at the Llama-3-8B attention shape 0.64-0.67
// ms, 42-43 %, against the Hopper bf16 kernel's 0.46 ms in the same runs.
// ptxas -v (CUDA 12.8, sm_90a): the tensor-core kernel 212 / 252 / 188 /
// 188 / 188 registers a thread at caps 256 / 128 / 64 / 32 / 16 in bf16
// and f16 alike, no spills; the FMA loop 234 / 128 / 127 / 122 / 64, no
// spills but 16 / 52 bytes at cap 16.

#include "flash_gen.cuh"

namespace {

// Shared memory of one block at cap DC: K and V [ROWS][LD], Q and dO
// [COLS][LD], p^T and ds^T [ROWS][LP], the query tile's lse, delta and
// segment ids [COLS], the key tile's segment ids [ROWS].
template <int DC>
constexpr int kv_smem() {
  using G = Gen<DC>;
  return 4 * (2 * (G::ROWS + G::COLS) * G::LD + 2 * G::ROWS * G::LP +
              3 * G::COLS + G::ROWS);
}

template <typename E, int DC>
__global__ void __launch_bounds__(GEN_THREADS) sofa_flash_gen_bwd_kv_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, void* dk,
    void* dv, bool out_f32, int T, int Tk, int H, int KVH, int D,
    long long shift, float scale) {
  using G = Gen<DC>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + G::ROWS * G::LD;
  float* qs = vs + G::ROWS * G::LD;
  float* gs = qs + G::COLS * G::LD;
  float* ps = gs + G::COLS * G::LD;
  float* ds = ps + G::ROWS * G::LP;
  float* lse_s = ds + G::ROWS * G::LP;
  float* dl_s = lse_s + G::COLS;
  int* sq_s = reinterpret_cast<int*>(dl_s + G::COLS);
  int* sk_s = sq_s + G::COLS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * G::ROWS;
  const int k_valid = min(G::ROWS, Tk - k0);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const long long kv_off = (static_cast<long long>(b) * Tk + k0) * kv_stride +
                           static_cast<long long>(kvh) * D;
  const bool segmented = seg_q != nullptr;

  load_tile<E, DC>(ks, k + kv_off, kv_stride, G::ROWS, k_valid, D);
  load_tile<E, DC>(vs, v + kv_off, kv_stride, G::ROWS, k_valid, D);
  if (segmented && tid < G::ROWS) {
    sk_s[tid] = tid < k_valid
                    ? seg_k[static_cast<long long>(b) * Tk + k0 + tid]
                    : 0;
  }

  float dk_acc[G::RI][G::DJ], dv_acc[G::RI][G::DJ];
#pragma unroll
  for (int i = 0; i < G::RI; ++i) {
#pragma unroll
    for (int j = 0; j < G::DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  // The first query that can see key k0: i >= k0 - shift.
  const long long first = static_cast<long long>(k0) - shift;
  const int q_first =
      first <= 0 ? 0 : first >= T ? T : static_cast<int>(first);
  const int qt0 = q_first / G::COLS * G::COLS;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long row0 = (static_cast<long long>(b) * H + h) * T;
    for (int q0 = qt0; q0 < T; q0 += G::COLS) {
      const int q_valid = min(G::COLS, T - q0);
      const long long q_off = (static_cast<long long>(b) * T + q0) * q_stride +
                              static_cast<long long>(h) * D;
      __syncthreads();   // the last tile's Q, dO, p^T and ds^T are consumed
      load_tile<E, DC>(qs, q + q_off, q_stride, G::COLS, q_valid, D);
      load_tile<E, DC>(gs, dout + q_off, q_stride, G::COLS, q_valid, D);
      if (tid < G::COLS) {
        const bool in = tid < q_valid;
        lse_s[tid] = in ? fmaxf(lse[row0 + q0 + tid], M_FLOOR) : 0.f;
        dl_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
        if (segmented) {
          sq_s[tid] = in ? seg_q[static_cast<long long>(b) * T + q0 + tid]
                         : 0;
        }
      }
      __syncthreads();

      float st[G::RI][G::CJ], dpt[G::RI][G::CJ];
      products<DC>(st, ks, qs, D);
      products<DC>(dpt, vs, gs, D);
#pragma unroll
      for (int i = 0; i < G::RI; ++i) {
        const int r = ty + 16 * i;   // key
#pragma unroll
        for (int j = 0; j < G::CJ; ++j) {
          const int c = tx + 16 * j;   // query
          bool vis = r < k_valid && c < q_valid &&
                     static_cast<long long>(k0) + r <=
                         static_cast<long long>(q0) + c + shift;
          if (segmented && vis) vis = sk_s[r] == sq_s[c];
          float p = 0.f, dsv = 0.f;
          if (vis) {
            // the product, then the difference, as the plain version
            p = expf(__fsub_rn(__fmul_rn(st[i][j], scale), lse_s[c]));
            dsv = round_as<E>(p * (dpt[i][j] - dl_s[c]));
          }
          ps[r * G::LP + c] = round_as<E>(p);
          ds[r * G::LP + c] = dsv;
        }
      }
      __syncthreads();
      accumulate<DC, G::COLS>(dv_acc, ps, gs);
      accumulate<DC, G::COLS>(dk_acc, ds, qs);
    }
  }

  if (out_f32) {
    store_tile<float, DC>(static_cast<float*>(dk) + kv_off, kv_stride,
                          k_valid, D, dk_acc, scale);
    store_tile<float, DC>(static_cast<float*>(dv) + kv_off, kv_stride,
                          k_valid, D, dv_acc, 1.f);
  } else {
    store_tile<E, DC>(static_cast<E*>(dk) + kv_off, kv_stride, k_valid, D,
                      dk_acc, scale);
    store_tile<E, DC>(static_cast<E*>(dv) + kv_off, kv_stride, k_valid, D,
                      dv_acc, 1.f);
  }
}

// ---- the tensor-core path (bfloat16, float16) ------------------------------

// Tile geometry of the tensor-core dK/dV kernel at cap DC, and its shared
// memory from a 1024-byte aligned base: K then V (PANELS panels of BLOCK_N
// rows each), per stage Q then dO (PANELS panels of BLOCK_M rows each), at
// cap 256 the exchange (two buffers of p^T and ds^T panels, 64 keys x 64
// queries each), per stage the aux rows (lse clamped at M_FLOOR, delta,
// segment ids: BLOCK_M each), then the barriers kv_full, full[STAGES],
// empty[STAGES].
template <int DC>
struct TcKv {
  // both warpgroups share the block's 64 keys, each half of the head dim
  static constexpr bool SPLIT = DC > 128;
  static constexpr int CONSUMERS = 2;
  // no producer warpgroup: every thread may hold 255 registers, which a
  // cap-128 thread needs beside dK and dV of 128 columns
  static constexpr int THREADS = CONSUMERS * 128;
  static constexpr int BLOCK_N = SPLIT ? 64 : 128;        // keys per block
  static constexpr int BLOCK_M = 64;                      // queries a tile
  static constexpr int WG_KEYS = 64;          // keys of a warpgroup's rows
  // queries of s^T a warpgroup forms
  static constexpr int SQ = SPLIT ? BLOCK_M / 2 : BLOCK_M;
  static constexpr int STAGES = SPLIT ? 2 : 3;            // Q/dO ring depth
  static constexpr int PANELS = DC <= 64 ? 1 : DC / 64;
  static constexpr int KS = DC / 16;           // k16 steps of s^T and dp^T
  static constexpr int NA = SPLIT ? 128 : PANELS * 64;   // dK/dV columns
  static constexpr int KV_PANEL = BLOCK_N * 128;
  static constexpr int QS_PANEL = BLOCK_M * 128;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;     // K or V
  static constexpr int QS_BYTES = PANELS * QS_PANEL;     // one Q or dO tile
  static constexpr int STAGE_BYTES = 2 * QS_BYTES;
  static constexpr int RING = 2 * KV_BYTES;
  static constexpr int X_PANEL = WG_KEYS * 128;  // p^T or ds^T of a tile
  static constexpr int XCHG = RING + STAGES * STAGE_BYTES;
  static constexpr int XCHG_BYTES = SPLIT ? 2 * 2 * X_PANEL : 0;
  static constexpr int AUX = XCHG + XCHG_BYTES;
  static constexpr int AUX_BYTES = 3 * BLOCK_M * 4;
  static constexpr int BARS = AUX + STAGES * AUX_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  // + 1024 so the base can be rounded up to the swizzle's alignment
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;
};

template <typename E, int DC>
__global__ void __launch_bounds__(TcKv<DC>::THREADS, 1)
    sofa_flash_gen_bwd_kv_tc_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap do_map, bool tma,
        const E* __restrict__ q, const E* __restrict__ k,
        const E* __restrict__ v, const E* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
        void* __restrict__ dk, void* __restrict__ dv, bool out_f32, int T,
        int Tk, int H, int KVH, int D, long long shift, float scale) {
  using S = TcKv<DC>;
  constexpr bool SPLIT = S::SPLIT;
  constexpr int BLOCK_M = S::BLOCK_M, BLOCK_N = S::BLOCK_N;
  constexpr int STAGES = S::STAGES, SQ = S::SQ;
  constexpr int NS = SQ / 8;            // 8-query column groups of s^T
  constexpr int KP = BLOCK_M / 16;      // k16 steps of dV and dK
  constexpr int NO = S::NA / 8;         // 8-column groups of dK / dV

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + S::KV_BYTES;
  const uint32_t bar = base + S::BARS;
  const uint32_t kv_full = bar;
  auto q_s = [&](int st) { return base + S::RING + st * S::STAGE_BYTES; };
  auto do_s = [&](int st) { return q_s(st) + S::QS_BYTES; };
  auto aux = [&](int st) {
    return reinterpret_cast<float*>(base_ptr + S::AUX + st * S::AUX_BYTES);
  };
  auto full = [&](int st) { return bar + 8 * (1 + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.y * BLOCK_N;
  const bool segmented = seg_q != nullptr;

  // The walk: for each query head of the group, the q-tiles from the first
  // whose last row can see this block's first key (iq * 64 + 63 + shift >=
  // k0) to the end.
  const int n_q = (T + BLOCK_M - 1) / BLOCK_M;
  const long long need = static_cast<long long>(k0) - shift - (BLOCK_M - 1);
  const long long first = need <= 0 ? 0 : (need + BLOCK_M - 1) / BLOCK_M;
  const int iq0 = first < n_q ? static_cast<int>(first) : n_q;
  const int per_head = n_q - iq0;
  const int n_walk = group * per_head;

  if (tid == 0) {
    // TMA completes kv_full on its bytes (one arrival) and a stage on its
    // bytes and the 64 arrivals of the threads that copy the aux rows; the
    // threads' own loads on every thread's arrival after its stores.
    mbar_init(kv_full, tma ? 1 : S::THREADS);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), tma ? BLOCK_M : S::THREADS);
      mbar_init(empty(st), S::CONSUMERS * 4);    // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Row strides of q / dO and k / v, and the offset of the block's first
  // key row, computed where they are needed, so that no 64-bit value stays
  // live across the loop.
  auto q_stride = [&] { return static_cast<long long>(H) * D; };
  auto kv_stride = [&] { return static_cast<long long>(KVH) * D; };
  auto kv_off = [&] {
    return (static_cast<long long>(b) * Tk + k0) * kv_stride() +
           static_cast<long long>(kvh) * D;
  };
  // The threads that write a stage: with TMA the first two warps (each
  // copies one query's lse, delta and segment id; thread 0 issues the
  // loads), else every thread.
  const bool filler = !tma || tid < BLOCK_M;
  // Tile j of the walk into stage j % STAGES, which its fillers have seen
  // released: Q and dO, and the tile's aux rows.
  auto fill = [&](int j) {
    const int st = j % STAGES;
    const int hh = j / per_head;
    const int h = kvh * group + hh;
    const int q0 = (iq0 + j - hh * per_head) * BLOCK_M;
    if (tid < BLOCK_M) {
      float* a = aux(st);
      const long long row = (static_cast<long long>(b) * H + h) * T;
      const int query = q0 + tid;
      const bool in = query < T;          // past T: masked, never read
      a[tid] = in ? fmaxf(lse[row + query], M_FLOOR) : 0.f;
      a[BLOCK_M + tid] = in ? delta[row + query] : 0.f;
      if (segmented) {
        reinterpret_cast<int*>(a)[2 * BLOCK_M + tid] =
            in ? seg_q[static_cast<long long>(b) * T + query] : 0;
      }
    }
    if (tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(full(st), S::STAGE_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(q_s(st) + p * S::QS_PANEL, &q_map, full(st), p * 64,
                      h, q0, b);
          tma_load_4d(do_s(st) + p * S::QS_PANEL, &do_map, full(st), p * 64,
                      h, q0, b);
        }
      } else if (tid < BLOCK_M) {
        mbar_arrive(full(st));
      }
    } else {
      const long long q_off =
          (static_cast<long long>(b) * T + q0) * q_stride() +
          static_cast<long long>(h) * D;
      const int valid = min(BLOCK_M, T - q0);
      load_panels<E>(q_s(st), S::PANELS, S::QS_PANEL, q + q_off, q_stride(),
                     BLOCK_M, valid, D, tid, S::THREADS);
      load_panels<E>(do_s(st), S::PANELS, S::QS_PANEL, dout + q_off,
                     q_stride(), BLOCK_M, valid, D, tid, S::THREADS);
      fence_proxy_async();
      mbar_arrive(full(st));
    }
  };

  // K and V once, and the ring's first STAGES tiles.
  if (n_walk > 0) {
    if (tma) {
      if (tid == 0) {
        tma_prefetch_map(&q_map);
        tma_prefetch_map(&do_map);
        mbar_arrive_expect_tx(kv_full, 2 * S::KV_BYTES);
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load_4d(k_s + p * S::KV_PANEL, &k_map, kv_full, p * 64, kvh,
                      k0, b);
          tma_load_4d(v_s + p * S::KV_PANEL, &v_map, kv_full, p * 64, kvh,
                      k0, b);
        }
      }
    } else {
      const int valid = min(BLOCK_N, Tk - k0);
      load_panels<E>(k_s, S::PANELS, S::KV_PANEL, k + kv_off(), kv_stride(),
                     BLOCK_N, valid, D, tid, S::THREADS);
      load_panels<E>(v_s, S::PANELS, S::KV_PANEL, v + kv_off(), kv_stride(),
                     BLOCK_N, valid, D, tid, S::THREADS);
      fence_proxy_async();
      mbar_arrive(kv_full);
    }
    for (int j = 0; j < STAGES && j < n_walk; ++j) fill(j);
  }
  __syncwarp();

  // Rows are keys [kw, kw + 64): to cap 128 warpgroup wg owns its own 64
  // keys and every column, at cap 256 both own the block's 64 keys and
  // columns [wg * 128, wg * 128 + 128).
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // accumulator row group / col pair
  const int kw = SPLIT ? k0 : k0 + wg * S::WG_KEYS;
  const int qh = SPLIT ? wg * SQ : 0;     // first s^T query of a tile
  const int key0 = kw + warp * 16 + g, key1 = key0 + 8;
  const bool dead = kw >= Tk;             // every key past Tk
  int sk0 = 0, sk1 = 0;
  if (segmented) {
    sk0 = key0 < Tk ? seg_k[static_cast<long long>(b) * Tk + key0] : 0;
    sk1 = key1 < Tk ? seg_k[static_cast<long long>(b) * Tk + key1] : 0;
  }

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }
  float s[NS][4], dp[NS][4];
  [[maybe_unused]] uint32_t pa[KP][4], da[KP][4];   // to cap 128
  // This warpgroup's K and V rows (8 KB into each panel to cap 128: a
  // multiple of the swizzle's 1024 bytes) and its s^T queries' Q / dO
  // rows (2 KB at cap 256), K-major; Q and dO transposed from the
  // warpgroup's first column.  A k16 step or another stage adds its
  // offset (desc_add).
  const uint32_t k_wg = k_s + (SPLIT ? 0 : wg * S::WG_KEYS * 128);
  const uint32_t v_wg = v_s + (SPLIT ? 0 : wg * S::WG_KEYS * 128);
  const uint64_t desc_k = desc_sw128(k_wg, 16, SW128_SBO);
  const uint64_t desc_v = desc_sw128(v_wg, 16, SW128_SBO);
  const uint64_t desc_q = desc_sw128(q_s(0) + qh * 128, 16, SW128_SBO);
  const uint64_t tdesc_q = desc_sw128(
      q_s(0) + (SPLIT ? wg * 2 * S::QS_PANEL : 0), S::QS_PANEL, SW128_SBO);
  if (n_walk > 0) mbar_wait(kv_full, 0);

  for (int j = 0; j < n_walk; ++j) {
    const int st = j % STAGES;
    const int hh = j / per_head;
    const int q0 = (iq0 + j - hh * per_head) * BLOCK_M;
    // Refill: tile j + STAGES - 1 into the stage both warpgroups released
    // at the end of tile j - 1; it lands while this tile and the next
    // ones compute.
    if (j >= 1 && j + STAGES - 1 < n_walk) {
      if (filler) mbar_wait(empty((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      fill(j + STAGES - 1);
    }
    __syncwarp();
    mbar_wait(full(st), (j / STAGES) & 1);
    // no key of this warpgroup is visible to any query of the tile (both
    // warpgroups always compute at cap 256, where they exchange)
    const bool blind =
        !SPLIT &&
        (dead || kw > static_cast<long long>(q0) + BLOCK_M - 1 + shift);
    if (!blind) {
      // s^T = K Q^T and dp^T = V dO^T, issued together
      wgmma_fence();
      const uint64_t desc_q_st = desc_add(desc_q, st * S::STAGE_BYTES);
      const uint64_t desc_do_st = desc_add(desc_q_st, S::QS_BYTES);
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const int off_a = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
        const int off_b = (ks / 4) * S::QS_PANEL + (ks % 4) * 32;
        wgmma_ss<SQ, 0, E>(s, desc_add(desc_k, off_a),
                           desc_add(desc_q_st, off_b), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const int off_a = (ks / 4) * S::KV_PANEL + (ks % 4) * 32;
        const int off_b = (ks / 4) * S::QS_PANEL + (ks % 4) * 32;
        wgmma_ss<SQ, 0, E>(dp, desc_add(desc_v, off_a),
                           desc_add(desc_do_st, off_b), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);

      // p^T = exp(s^T * scale - lse) in place of s^T, exactly 0 where
      // masked; columns are queries qh + 8n + 2t + {0, 1} of the tile.
      const float* a = aux(st);
      const int* segq = reinterpret_cast<const int*>(a) + 2 * BLOCK_M;
      const bool need_mask =
          segmented || q0 + BLOCK_M > T || kw + S::WG_KEYS > Tk ||
          static_cast<long long>(kw) + S::WG_KEYS - 1 > q0 + qh + shift;
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(a + qh + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = qh + n * 8 + 2 * t + (e & 1);
            const int query = q0 + jj;
            const int key = e < 2 ? key0 : key1;
            bool masked = query >= T || key >= Tk ||
                          key > static_cast<long long>(query) + shift;
            if (segmented && !masked) {
              masked = segq[jj] != (e < 2 ? sk0 : sk1);
            }
            s[n][e] = masked ? 0.f
                             : bwd_p(s[n][e], scale, (e & 1) ? l2.y : l2.x);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(a + qh + n * 8 + 2 * t);
          s[n][0] = bwd_p(s[n][0], scale, l2.x);
          s[n][1] = bwd_p(s[n][1], scale, l2.y);
          s[n][2] = bwd_p(s[n][2], scale, l2.x);
          s[n][3] = bwd_p(s[n][3], scale, l2.y);
        }
      }
      // ds^T = p^T (dp^T - delta); p^T and ds^T rounded to E into the
      // register A operands to cap 128 (s^T and dp^T die as they are
      // packed, which keeps a cap-128 thread inside its 240 registers),
      // into this tile's exchange buffer at cap 256 (the other buffer may
      // still feed the other warpgroup's last products until it reaches
      // this tile's barrier)
      [[maybe_unused]] const uint32_t x =
          base + S::XCHG + (j & 1) * 2 * S::X_PANEL;
      [[maybe_unused]] const int r0 = warp * 16 + g;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(
            a + BLOCK_M + qh + n * 8 + 2 * t);
        dp[n][0] = s[n][0] * (dp[n][0] - dl.x);
        dp[n][1] = s[n][1] * (dp[n][1] - dl.y);
        dp[n][2] = s[n][2] * (dp[n][2] - dl.x);
        dp[n][3] = s[n][3] * (dp[n][3] - dl.y);
        if constexpr (!SPLIT) {
          pa[n / 2][(n % 2) * 2] = pack2<E>(s[n][0], s[n][1]);
          pa[n / 2][(n % 2) * 2 + 1] = pack2<E>(s[n][2], s[n][3]);
          da[n / 2][(n % 2) * 2] = pack2<E>(dp[n][0], dp[n][1]);
          da[n / 2][(n % 2) * 2 + 1] = pack2<E>(dp[n][2], dp[n][3]);
        } else {
          const int c = qh + n * 8 + 2 * t;
          st_shared_u32(x + sw128(r0, c), pack2<E>(s[n][0], s[n][1]));
          st_shared_u32(x + sw128(r0 + 8, c), pack2<E>(s[n][2], s[n][3]));
          st_shared_u32(x + S::X_PANEL + sw128(r0, c),
                        pack2<E>(dp[n][0], dp[n][1]));
          st_shared_u32(x + S::X_PANEL + sw128(r0 + 8, c),
                        pack2<E>(dp[n][2], dp[n][3]));
        }
      }
      const uint64_t tdesc_q_st = desc_add(tdesc_q, st * S::STAGE_BYTES);
      const uint64_t tdesc_do_st = desc_add(tdesc_q_st, S::QS_BYTES);
      if constexpr (!SPLIT) {
        // dV += p^T dO and dK += ds^T Q, issued together
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_rs<S::NA, 1, E>(dv_acc, pa[kk],
                                desc_add(tdesc_do_st, kk * 16 * 128), 1);
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_rs<S::NA, 1, E>(dk_acc, da[kk],
                                desc_add(tdesc_q_st, kk * 16 * 128), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pa);
        fence_operands(da);
      } else {
        fence_proxy_async();
        named_bar_sync(1, S::CONSUMERS * 128);
        // dV += p^T dO and dK += ds^T Q over this warpgroup's columns,
        // p^T and ds^T K-major from the exchange
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_ss<S::NA, 1, E>(dv_acc,
                                desc_sw128(x + kk * 32, 16, SW128_SBO),
                                desc_add(tdesc_do_st, kk * 16 * 128), 1);
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          wgmma_ss<S::NA, 1, E>(
              dk_acc, desc_sw128(x + S::X_PANEL + kk * 32, 16, SW128_SBO),
              desc_add(tdesc_q_st, kk * 16 * 128), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  const int col0 = SPLIT ? wg * S::NA : 0;
  const long long off = kv_off(), stride = kv_stride();
  auto store = [&](void* dst, const float (&acc)[NO][4], int half, int key,
                   float mul) {
    const long long at = off + (key - k0) * stride;
    if (out_f32) {
      store_acc_row<float>(static_cast<float*>(dst) + at, acc, half, mul,
                           t, col0, D);
    } else {
      store_acc_row<E>(static_cast<E*>(dst) + at, acc, half, mul, t, col0,
                       D);
    }
  };
  // dK's rows first, so that its registers are free for dV's stores
  if (key0 < Tk) store(dk, dk_acc, 0, key0, scale);
  if (key1 < Tk) store(dk, dk_acc, 1, key1, scale);
  if (key0 < Tk) store(dv, dv_acc, 0, key0, 1.f);
  if (key1 < Tk) store(dv, dv_acc, 1, key1, 1.f);
}

template <typename E, int DC>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* seg_q, const int* seg_k, void* dk, void* dv,
                      bool out_f32, int B, int T, int Tk, int H, int KVH,
                      int D, long long shift, float scale,
                      cudaStream_t stream) {
  using S = TcKv<DC>;
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
      allow_smem(sofa_flash_gen_bwd_kv_tc_kernel<E, DC>, S::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KVH, (Tk + S::BLOCK_N - 1) / S::BLOCK_N);
  sofa_flash_gen_bwd_kv_tc_kernel<E, DC>
      <<<grid, S::THREADS, S::BYTES, stream>>>(
          q_map, k_map, v_map, do_map, tma, static_cast<const E*>(q),
          static_cast<const E*>(k), static_cast<const E*>(v),
          static_cast<const E*>(dout), lse, delta, seg_q, seg_k, dk, dv,
          out_f32, T, Tk, H, KVH, D, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q/dout [B,T,H,D], k/v
// [B,Tk,KVH,D] contiguous, all of the element type `dtype` (GenDtype:
// float32 runs the FMA loop, bfloat16 and float16 the tensor cores, by TMA
// when the rows and bases allow it, else by the threads' own loads); lse
// and delta [B,H,T] f32; seg_q [B,T] / seg_k [B,Tk] int32 or both null; dk
// and dv [B,Tk,KVH,D] in float32 when out_f32 != 0, else in `dtype`,
// allocated by the caller.  Launches on `stream` without synchronizing and
// returns cudaGetLastError() (cudaErrorInvalidValue for a dtype, head dim
// or shape it does not take).
extern "C" int sofa_flash_gen_bwd_kv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const int* seg_q, const int* seg_k,
                                     void* dk, void* dv, int out_f32,
                                     int dtype, int B, int T, int Tk, int H,
                                     int KVH, int D, long long shift,
                                     float scale, void* stream) {
  if (B <= 0 || T <= 0 || Tk <= 0 || KVH <= 0 || H % KVH != 0 ||
      (Tk + GEN_ROWS - 1) / GEN_ROWS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fma = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    constexpr int DC = decltype(cap)::value;
    const int smem = kv_smem<DC>();
    cudaError_t err = allow_smem(sofa_flash_gen_bwd_kv_kernel<E, DC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * KVH, (Tk + GEN_ROWS - 1) / GEN_ROWS);
    sofa_flash_gen_bwd_kv_kernel<E, DC><<<grid, GEN_THREADS, smem, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
        seg_q, seg_k, dk, dv, out_f32 != 0, T, Tk, H, KVH, D, shift, scale);
    return cudaGetLastError();
  };
  auto tc = [&](auto elem, auto cap) {
    using E = typename decltype(elem)::type;
    return launch_tc<E, decltype(cap)::value>(
        q, k, v, dout, lse, delta, seg_q, seg_k, dk, dv, out_f32 != 0, B, T,
        Tk, H, KVH, D, shift, scale, st);
  };
  return static_cast<int>(dispatch_paths(dtype, D, fma, tc));
}

// Dynamic shared memory one block of the bfloat16 / float16 (tensor-core)
// path asks for at head dim d (0 if unsupported); the float32 path's is in
// the header note.
extern "C" int sofa_flash_gen_bwd_kv_smem_bytes(int d) {
  switch (gen_cap(d)) {
    case 16: return TcKv<16>::BYTES;
    case 32: return TcKv<32>::BYTES;
    case 64: return TcKv<64>::BYTES;
    case 128: return TcKv<128>::BYTES;
    case 256: return TcKv<256>::BYTES;
    default: return 0;
  }
}
