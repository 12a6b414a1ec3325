// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel`, launched by `_flash_forward`
// (horovod_tpu/parallel/flash_attention.py).  It computes what that kernel
// computes: softmax(Q·Kᵀ·scale, masked)·V with the online-softmax
// recurrence, causal or not, GQA through the index map
//   kv row of q row bh = (bh / H)·KVH + (bh % H) / (H / KVH),
// keys >= seq_len masked, P rounded to the storage dtype before P·V, the
// row sum clamped at 1e-30, and the per-row log-sum-exp written in f32 with
// the natural log (the backward kernels read it unchanged).
//
// Bound on an H100 SXM.  Tensor-core bound at both shapes of the port's
// main paths (chip_smoke.py `_flash_bound`): 4·B·H·D·(causal pairs) FLOP
// (Q·Kᵀ and P·V over the lower triangle) against 989 TFLOP/s bf16 is
// 0.0348 ms for generate's prefill (B=4, L=1024, H=32, KVH=8, D=128) and
// 0.139 ms for the training shape (B=1, L=4096), while q, k, v and o once
// each take 0.010 ms and 0.013 ms at 3.35 TB/s.
//
// Two kernels, two C entries:
//
// `hvd_flash_fwd` (bf16, fp16): `flash_fwd_wgmma_kernel`, designed for
// Hopper.  One block per (b·h, 128-row query tile), 384 threads in three
// warpgroups.  Warpgroup 0 is the producer: `setmaxnreg` drops it to 24
// registers, and one of its threads issues every copy by TMA (the Q tile
// once, then K and V tiles of 128 keys into a two-stage ring, with a full
// mbarrier per tile and stage and an empty mbarrier per stage).  Warpgroups
// 1 and 2 are consumers of 64 query rows each, raised to 240 registers at
// run time (ptxas of CUDA 12.9 still compiles every warp within the 168
// registers a 384-thread block allows: `nvcc -Xptxas -v` reports 168 and
// the SASS uses no register above R160); no consumer thread issues a
// load.  S = Q·Kᵀ is eight wgmma m64n128k16 with
// both operands in shared memory (K stored [key, d] is already the K-major
// B operand); the online softmax runs on the f32 accumulator in registers
// (exp2 with log2(e)·scale folded in, row max and sum over the four lanes
// of a row); P is rounded to the storage dtype straight into the wgmma A
// fragment, which for 16-bit types is the accumulator layout itself, so P
// never touches shared memory; O += P·V is eight wgmma with A from
// registers and V from shared memory through a transposing (MN-major)
// descriptor.  Every tile is 128-byte swizzled by TMA and read through
// matching wgmma descriptors (panels of 64 columns).  Q, K, V and O are
// described by 3-D tensor maps over [rows, L, D], so a tail tile reads
// zeros past L within its own head and the O store (staged in the Q tile's
// shared memory, written by TMA) clips rows >= L instead of overwriting the
// next head.  Tiles above the causal diagonal are skipped; only the
// diagonal tile and the tile holding key L-1 are masked.  Query tiles are
// issued longest first (blockIdx.y runs the causal triangle from its
// bottom, blockIdx.x over heads).
//
// `hvd_flash_fwd_mma` (bf16, fp16, f32; D = 64 or 128):
// `flash_fwd_mma_kernel`, the earlier design, kept for f32 (wgmma's only
// 32-bit path is TF32, which would break the f32 exactness the plain
// version and the CPU tests rely on) at D = 128 and at D = 64 (the ViT
// head width; bf16 and fp16 there take flash_fwd_d64.cu), and as the
// same-run yardstick of chip_smoke.py.  One block per
// (b·h, 64-row query tile), four warps of 16 rows, 64-key tiles loaded
// synchronously, mma.sync m16n8k16 (plain FMAs in the same fragment layout
// for f32), P through shared memory.  At D = 64 a row of a tile is 128 B
// (bf16) plus the 16-byte pad, so the 16-byte vector loads stay aligned,
// each warp holds eight n8 accumulator tiles of O, and the block takes
// 36,864 B of shared memory (73,728 B for f32).  At the ViT-B/16 shape
// (B=64, L=196, H=12, non-causal, bf16) the work is 4·B·H·D·L² = 7.55
// GFLOP, 7.6 µs at 989 TFLOP/s, against 77.7 MB of q, k, v, o and LSE,
// 23.2 µs at 3.35 TB/s: bound by bytes, not by the tensor cores.
//
// What the Hopper design still leaves on the table, measured with
// chip_smoke.py's timing on an H100 80GB HBM3 at 700 W (PERF.md, PR 3):
// the softmax is not hidden behind the products.  The same kernel with the
// softmax taken out runs the training shape (B=1, L=4096) in 0.194 ms, 71 %
// of the bound, against 0.270 ms; leaving out the K/V loads changes
// nothing.  Hiding it inside a warpgroup means issuing the next tile's
// Q·Kᵀ before this tile's softmax, with O, S and P live at once (160
// accumulator registers, 190 in all without a cap): over the 168 above, so
// ptxas spills and serializes the wgmmas.  Ping-pong of the two consumer
// warpgroups on named barriers, a persistent grid with a second Q buffer,
// a cheaper softmax (ex2.approx, split reductions) and 64-key tiles with
// the overlap (112 accumulator registers) each measured no faster.  Not
// tried: GQA packing (the H/KVH query heads of a KV head each load its K/V
// tiles from L2), skipping the lower warpgroup's masked half of the
// diagonal tile, 256-thread blocks without a producer warpgroup (the only
// shape that lifts the cap to 255 registers).

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

// ---------------------------------------------------------------------------
// hvd_flash_fwd: the Hopper kernel (bf16, fp16; D = 128).

constexpr int WBQ = 128;                 // query rows per block
constexpr int WBK = 128;                 // keys per K/V tile
constexpr int WD = 128;                  // head width
constexpr int STAGES = 2;                // K/V ring depth
constexpr int WTHREADS = 384;            // producer + two consumer warpgroups
constexpr uint32_t TILE_BYTES = 128 * WD * 2;      // a [128, 128] 16-bit tile
constexpr uint32_t PANEL_BYTES = TILE_BYTES / 2;   // its 64 columns: [128][128 B]
constexpr uint32_t Q_OFF = 0;
constexpr uint32_t KV_OFF = TILE_BYTES;  // stage s: K at + 2s·TILE, V after it
constexpr uint32_t BAR_OFF = KV_OFF + 2 * STAGES * TILE_BYTES;
constexpr int N_BARS = 1 + 3 * STAGES;   // q full; per stage k full, v full, empty
constexpr size_t WSMEM = BAR_OFF + 8 * N_BARS + 1024;   // + alignment slack
static_assert(WSMEM <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t q_full(uint32_t base) { return base + BAR_OFF; }
__device__ __forceinline__ uint32_t k_full(uint32_t base, int s) {
  return base + BAR_OFF + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t v_full(uint32_t base, int s) {
  return base + BAR_OFF + 8 * (1 + STAGES + s);
}
__device__ __forceinline__ uint32_t kv_empty(uint32_t base, int s) {
  return base + BAR_OFF + 8 * (1 + 2 * STAGES + s);
}

template <typename T>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       float* __restrict__ lse, int L, int H, int KVH,
                       int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // 128-byte swizzle needs 1024-byte aligned tiles.
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = wg_smem + (base - raw);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
  const int q0 = qt * WBQ;
  const int kvbh = (bh / H) * KVH + (bh % H) / (H / KVH);
  int n_kt = (L + WBK - 1) / WBK;
  if (causal) n_kt = min(n_kt, qt + 1);        // stop at the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full(base), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(base, s), 1);
      mbar_init(v_full(base, s), 1);
      mbar_init(kv_empty(base, s), 8);         // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: one thread issues every TMA copy.
    setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full(base), TILE_BYTES);
      tma_load_3d(base + Q_OFF, &map_q, q_full(base), 0, q0, bh);
      tma_load_3d(base + Q_OFF + PANEL_BYTES, &map_q, q_full(base), 64, q0, bh);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = (j / STAGES) & 1;
        const uint32_t ks = base + KV_OFF + 2 * s * TILE_BYTES;
        const uint32_t vs = ks + TILE_BYTES;
        mbar_wait(kv_empty(base, s), parity ^ 1);
        mbar_expect_tx(k_full(base, s), TILE_BYTES);
        tma_load_3d(ks, &map_k, k_full(base, s), 0, j * WBK, kvbh);
        tma_load_3d(ks + PANEL_BYTES, &map_k, k_full(base, s), 64, j * WBK, kvbh);
        mbar_expect_tx(v_full(base, s), TILE_BYTES);
        tma_load_3d(vs, &map_v, v_full(base, s), 0, j * WBK, kvbh);
        tma_load_3d(vs + PANEL_BYTES, &map_v, v_full(base, s), 64, j * WBK, kvbh);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    setmaxnreg_inc<240>();
    const int wg = warp / 4 - 1;
    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const int rr = 16 * w + g;                 // this lane's first row in the warpgroup
    const int row[2] = {q0 + 64 * wg + rr, q0 + 64 * wg + rr + 8};
    const float c = scale * 1.4426950408889634f;   // log2(e)·scale
    const uint32_t qa = base + Q_OFF + wg * 64 * 128;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};       // running max of the raw scores
    float l[2] = {0.f, 0.f};                   // this lane's share of the row sum

    mbar_wait(q_full(base), 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      const uint32_t ka = base + KV_OFF + 2 * s * TILE_BYTES;
      const uint32_t va = ka + TILE_BYTES;

      // S = Q·Kᵀ: 8 steps of 16 along D, both operands K-major.
      float sc[64];
      mbar_wait(k_full(base, s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) {
        const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
        wgmma_ss<T>(sc, gmma_desc(qa + off, 16, 1024),
                    gmma_desc(ka + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Mask the diagonal tile and the tile holding key L-1 only.
      const int k0 = j * WBK;
      if ((causal && j == n_kt - 1) || k0 + WBK > L) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
          if (col >= L || (causal && col > row[(i >> 1) & 1])) sc[i] = -INFINITY;
        }
      }

      // Online softmax on the accumulator; the four lanes of a quad share a row.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2], msc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        msc[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;
        corr[r] = exp2f(m[r] * c - msc[r]);
        m[r] = mx[r];
      }
      // P = exp(S·scale − m), rounded into the wgmma A fragment: pf[n] holds
      // columns 2n, 2n+1 of the accumulator, so keys 16kk..16kk+15 are
      // pf[4kk..4kk+3].
      uint32_t pf[32];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int r = n & 1;
        const float p0 = exp2f(fmaf(sc[2 * n], c, -msc[r]));
        const float p1 = exp2f(fmaf(sc[2 * n + 1], c, -msc[r]));
        ps[r] += p0 + p1;
        pf[n] = pack_f2<T>(p0, p1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P·V: 8 steps of 16 keys, P from registers, V transposed.
      mbar_wait(v_full(base, s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk) {
        const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                               pf[4 * kk + 3]};
        wgmma_rs<T>(o, a, gmma_desc(va + kk * 16 * 128, PANEL_BYTES, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(base, s));   // this stage may be refilled
    }

    // Epilogue: o / l in the storage dtype into this warpgroup's rows of the
    // Q tile (swizzled as TMA reads it), then one TMA store per panel.
    float lc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lc[r] = fmaxf(l[r], 1e-30f);
    }
    unsigned char* ob = smem + Q_OFF + wg * 64 * 128;
#pragma unroll
    for (int jn = 0; jn < WD / 8; ++jn) {
      const int panel = jn / 8, chunk = jn % 8;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int orow = rr + 8 * r;
        const uint32_t off = panel * PANEL_BYTES + orow * 128 +
                             ((chunk ^ (orow & 7)) * 16) + t * 4;
        *reinterpret_cast<uint32_t*>(ob + off) =
            pack_f2<T>(o[4 * jn + 2 * r] / lc[r], o[4 * jn + 2 * r + 1] / lc[r]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    const int r0 = q0 + 64 * wg;
    if (w == 0 && lane == 0 && r0 < L) {
      const uint32_t src = base + Q_OFF + wg * 64 * 128;
      tma_store_3d(&map_o, src, 0, r0, bh);
      tma_store_3d(&map_o, src + PANEL_BYTES, 64, r0, bh);
      tma_store_wait();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (t == 0 && row[r] < L)
        lse[(size_t)bh * L + row[r]] = m[r] * scale + logf(lc[r]);
  }
}

template <typename T>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int H, int KVH, int L, int causal,
                 float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int err = encode_rows_map<T>(&mq, q, B * H, L, WD, WBQ);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, WD, WBK);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, WD, WBK);
  if (!err) err = encode_rows_map<T>(&mo, o, B * H, L, WD, 64);
  if (err) return err;
  return launch_kernel<flash_fwd_wgmma_kernel<T>, WSMEM>(
      dim3(B * H, (L + WBQ - 1) / WBQ), WTHREADS, stream, mq, mk, mv, mo,
      static_cast<float*>(lse), L, H, KVH, causal, scale);
}

// ---------------------------------------------------------------------------
// hvd_flash_fwd_mma: the earlier mma.sync / FMA kernel (bf16, fp16, f32).

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int L, int H, int KVH, int causal,
                 float scale) {
  constexpr int LDS = D + PAD;
  constexpr int LDP = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LDS;
  T* Vs = Ks + BK * LDS;
  T* Ps = Vs + BK * LDS;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int kvbh = (bh / H) * KVH + (bh % H) / (H / KVH);
  const T* qp = q + (size_t)bh * L * D;
  const T* kp = k + (size_t)kvbh * L * D;
  const T* vp = v + (size_t)kvbh * L * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = Qs + warp * 16 * LDS;
  T* pw = Ps + warp * 16 * LDP;

  load_tile<T, D, 64, NTHREADS>(Qs, qp, q0, L, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  int n_kt = (L + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is no longer read
    load_tile<T, D, 64, NTHREADS>(Ks, kp, k0, L, tid);
    load_tile<T, D, 64, NTHREADS>(Vs, vp, k0, L, tid);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mma_tile<T, false>(s[j], qw + kk, LDS, Ks + j * 8 * LDS + kk, LDS, lane);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = k0 + j * 8 + 2 * t + (i & 1);
        const bool ok = col < L && (!causal || row[r] >= col);
        const float x = ok ? s[j][i] * scale : NEG_INF;
        s[j][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the four lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = expf(s[j][i] - m[r]);
        psum[r] += p;
        pw[(g + 8 * r) * LDP + j * 8 + 2 * t + (i & 1)] = from_f<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i >> 1];
    __syncwarp();                    // this warp's P tile is written
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma_tile<T, true>(acc[j], pw + kk, LDP, Vs + kk * LDS + j * 8, LDS, lane);
    __syncwarp();                    // P is read before the next tile rewrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * L + row[r]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[j * 8 + 2 * t] = from_f<T>(acc[j][2 * r] / lc);
      orow[j * 8 + 2 * t + 1] = from_f<T>(acc[j][2 * r + 1] / lc);
    }
    if (t == 0) lse[(size_t)bh * L + row[r]] = m[r] + logf(lc);
  }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int KVH, int L, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(T) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + PAD));
  return launch_kernel<flash_fwd_mma_kernel<T, D>, smem>(
      dim3((L + BQ - 1) / BQ, B * H), NTHREADS, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), L, H, KVH, causal, scale);
}

// The mma.sync kernel's launch for each storage dtype at head width D.
template <int D>
int dispatch_mma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int H, int KVH, int L, int dtype,
                 int causal, float scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_mma<__nv_bfloat16, D>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    case 1:
      return launch_mma<__half, D>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    case 2:
      return launch_mma<float, D>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B·H, L, D], k/v [B·KVH, L, D], o [B·H, L, D] in one dtype
// (0 = bf16, 1 = fp16, 2 = f32); lse [B·H, L] f32.  All contiguous and
// 16-byte aligned.  Returns a cudaError_t: 0 when the launch was accepted,
// cudaErrorInvalidValue for a shape or dtype the entry does not take.
//
// The Hopper kernel: bf16 and fp16 at D = 128 (the Llama-3 head width).
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int KVH, int L, int D, int dtype,
                  int causal, float scale, void* stream) {
  if (B < 1 || L < 1 || KVH < 1 || H % KVH != 0 || D != WD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_wgmma<__nv_bfloat16>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    case 1:
      return launch_wgmma<__half>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The mma.sync / FMA kernel, every dtype, at D = 64 (the ViT head width)
// or D = 128; same arguments.
int hvd_flash_fwd_mma(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int KVH, int L, int D, int dtype,
                      int causal, float scale, void* stream) {
  if (B < 1 || L < 1 || KVH < 1 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_mma<64>(q, k, v, o, lse, B, H, KVH, L, dtype, causal, scale, s);
    case 128:
      return dispatch_mma<128>(q, k, v, o, lse, B, H, KVH, L, dtype, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of the Hopper kernel, in bytes.
int hvd_flash_fwd_smem_bytes() { return (int)WSMEM; }

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
