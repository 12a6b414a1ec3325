// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// the dQ kernel and the dK/dV kernel.
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`,
// launched by `_flash_backward` (horovod_tpu/parallel/flash_attention.py).
// Both compute, from Q, K, V, dO, the forward's per-row log-sum-exp LSE and
// Δ = rowsum(dO∘O) (f32, computed by the caller as the reference does):
//
//   S  = Q·Kᵀ·scale, masked (keys >= L, and above the diagonal if causal)
//   P  = exp(S − LSE)            dP = dO·Vᵀ
//   dS = P∘(dP − Δ)·scale
//   dQ = Σ_k dS'·K               dS' = dS rounded to the storage dtype
//   dV = Σ_q P'ᵀ·dO              P'  = P rounded to the storage dtype
//   dK = Σ_q dS'ᵀ·Q
//
// with the reference's three rounding points, f32 accumulation, and dQ, dK,
// dV each rounded once at the end.  dK/dV are written per *query* head
// ([B·H, L, D]) and group-summed to the KV heads by the caller, as the
// reference does, so the GQA heads of a group never race.  GQA reads KV row
// (bh / H)·KVH + (bh % H) / (H / KVH) for q row bh, the forward's index map.
//
// Bound on an H100 SXM: causal backward at Llama-3-8B widths is tensor-core
// bound: dQ runs three products, dK/dV four, each 2·B·H·D·L(L+1)/2 FLOP over
// the causal triangle, against 989 TFLOP/s bf16 (0.209 and 0.278 ms at the
// training shape B=1, L=4096, H=32, KVH=8, D=128); the bytes (q, dO, k, v,
// LSE, Δ once, the gradients written once) take a small fraction of that at
// 3.35 TB/s.
//
// Two kernels per product, four C entries:
//
// `hvd_flash_bwd_dkv`, `hvd_flash_bwd_dq` (bf16, fp16): the Hopper kernels
// `flash_bwd_dkv_wgmma_kernel` and `flash_bwd_dq_wgmma_kernel`.  Tiles of
// 64 queries × 64 keys.  A block is one warpgroup of 128 threads, two
// blocks to an SM (~98 KB of shared memory each), so one block's products
// run under the other's exponentials: a 384-thread block is held to 168
// registers a thread by ptxas, and dK/dV's accumulators alone are 128.
// Thread 0 issues every copy by TMA through 3-D tensor maps over
// [rows, L, D] (128-byte swizzle, boxes of 64 rows): a tail tile reads
// zeros past L within its own head and the TMA stores clip rows >= L.
//
//   dK/dV: one block per (b·h, 64-key tile), walking the query tiles from
//   the causal diagonal down (key tile 0 first: it sees the most).  K and V
//   are loaded once; Q and dO come through a two-stage ring on mbarriers.
//   Per query tile four wgmma products, keys as rows so nothing is
//   transposed: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n64k16, both operands
//   K-major in shared memory); dV += P'ᵀ·dO and dK += dS'ᵀ·Q (m64n128k16,
//   A from registers, B the dO or Q tile read MN-major, as the forward
//   reads V).  Sᵀ's accumulator layout is the A fragment of the next
//   wgmma, so P'ᵀ and dS'ᵀ are packed straight from it and never touch
//   shared memory.  LSE and Δ broadcast along the columns (queries): they
//   are staged per query tile in shared memory by ordinary loads (a TMA map
//   needs 16-byte strides, and L·4 bytes is not one for every L), the next
//   tile's prefetched into a register during this one.
//
//   dQ: one block per (b·h, 64-query tile), longest first, walking the K/V
//   tiles up to the diagonal through a two-stage ring, Q and dO loaded
//   once: S = Q·Kᵀ and dP = dO·Vᵀ (m64n64k16, K-major), dQ += dS'·K
//   (m64n128k16, A = dS' from registers, B = the K tile read MN-major).
//   LSE and Δ of the thread's two rows stay in registers.
//
// Query rows >= L are masked explicitly (they have no LSE; a zero-filled Q
// row gives S = 0, not −∞), keys >= L too; only the diagonal tile and the
// tiles holding row or key L-1 test the mask.
//
// `hvd_flash_bwd_dq_mma`, `hvd_flash_bwd_dkv_mma` (bf16, fp16, f32; D = 64
// or 128): the earlier design, kept for f32 (wgmma's only 32-bit path is
// TF32, which would break the f32 contract) at both head widths, and as
// chip_smoke.py's same-run yardstick.  bf16/fp16 at D = 64 (the ViT path)
// take the Hopper kernels of flash_bwd_d64.cu.
//
//   dQ: one block per (b·h, 64-row query tile), four warps of 16 query
//   rows.  Q and dO stay in shared memory; the block walks the K/V tiles
//   up to the causal diagonal (synchronous loads), computes S and dP with
//   `mma.sync.m16n8k16`, forms dS in f32 registers, rounds it into a
//   per-warp shared-memory tile and accumulates dS·K into f32 registers.
//
//   dK/dV: one block per (b·h, 64-key tile), eight warps.  Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ, Pᵀ and dSᵀ rounded into shared memory and read back as
//   the left operand of Pᵀ·dO and dSᵀ·Q.  For Sᵀ/dPᵀ warp w owns keys
//   16·(w%4) and queries 32·(w/4); for dK/dV keys 16·(w%4) and head
//   columns D/2·(w/4), D/2 accumulators a thread for each of dK and dV.
//   At D = 64 a warp covers 16 keys × 32 head columns (four n8 tiles), so
//   the eight warps still tile the 64 × 64 output once.  Rows >= L are
//   zero-filled on load and masked.  For float32 the same fragment layout
//   is computed with plain FMAs (no TF32).
//
//   At D = 64 a shared-memory row is 128 B (bf16) plus the 16-byte pad, so
//   the 16-byte vector loads stay aligned; dQ takes 46,080 B of shared
//   memory, dK/dV 55,808 B (bf16; 92,160 and 111,104 B in f32).  At the
//   ViT-B/16 shape (B=64, L=196, H=12, non-causal, bf16) dQ's three
//   products are 11.3 GFLOP (11.5 µs at 989 TFLOP/s) against 97 MB moved
//   (q, k, v, dO read, dQ written, LSE and Δ: 29 µs at 3.35 TB/s), and
//   dK/dV's four 15.1 GFLOP (15.3 µs) against 117 MB (35 µs): both bound
//   by bytes at this short sequence.

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int DQ_THREADS = 128;    // four warps, 16 query rows each
constexpr int DKV_THREADS = 256;   // eight warps

__device__ __forceinline__ int kv_row(int bh, int H, int KVH) {
  return (bh / H) * KVH + (bh % H) / (H / KVH);
}

template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int L, int H, int KVH, int causal, float scale) {
  constexpr int LDS = D + PAD;
  constexpr int LDP = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * LDS;
  T* Ks = dOs + BQ * LDS;
  T* Vs = Ks + BK * LDS;
  T* dSs = Vs + BK * LDS;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int kvbh = kv_row(bh, H, KVH);
  const T* kp = k + (size_t)kvbh * L * D;
  const T* vp = v + (size_t)kvbh * L * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = Qs + warp * 16 * LDS;
  const T* dow = dOs + warp * 16 * LDS;
  T* dsw = dSs + warp * 16 * LDP;

  load_tile<T, D, BQ, DQ_THREADS>(Qs, q + (size_t)bh * L * D, q0, L, tid);
  load_tile<T, D, BQ, DQ_THREADS>(dOs, dout + (size_t)bh * L * D, q0, L, tid);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < L;
    lse_r[r] = in ? lse[(size_t)bh * L + row[r]] : 0.f;
    delta_r[r] = in ? delta[(size_t)bh * L + row[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_kt = (L + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous K/V tile is no longer read
    load_tile<T, D, BK, DQ_THREADS>(Ks, kp, k0, L, tid);
    load_tile<T, D, BK, DQ_THREADS>(Vs, vp, k0, L, tid);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] =
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mma_tile<T, false>(s[j], qw + kk, LDS, Ks + j * 8 * LDS + kk, LDS, lane);
        mma_tile<T, false>(dp[j], dow + kk, LDS, Vs + j * 8 * LDS + kk, LDS, lane);
      }

#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int c = j * 8 + 2 * t + (i & 1);
        const int col = k0 + c;
        const bool ok = col < L && (!causal || row[r] >= col);
        const float x = ok ? s[j][i] * scale : NEG_INF;
        const float p = expf(x - lse_r[r]);
        const float ds = p * (dp[j][i] - delta_r[r]) * scale;
        dsw[(g + 8 * r) * LDP + c] = from_f<T>(ds);   // dS rounded, as K's dtype
      }
    __syncwarp();                    // this warp's dS tile is written
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma_tile<T, true>(acc[j], dsw + kk, LDP, Ks + kk * LDS + j * 8, LDS, lane);
    __syncwarp();                    // dS is read before the next tile rewrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    T* drow = dq + ((size_t)bh * L + row[r]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      drow[j * 8 + 2 * t] = from_f<T>(acc[j][2 * r]);
      drow[j * 8 + 2 * t + 1] = from_f<T>(acc[j][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int L, int H, int KVH, int causal,
                     float scale) {
  constexpr int LDS = D + PAD;
  constexpr int LDP = BQ + PAD;
  constexpr int DH = D / 2;          // head columns per warp in dK/dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * LDS;
  T* Qs = Vs + BK * LDS;
  T* dOs = Qs + BQ * LDS;
  T* Pt = dOs + BQ * LDS;            // Pᵀ  [BK keys][BQ queries]
  T* dSt = Pt + BK * LDP;            // dSᵀ [BK keys][BQ queries]
  float* lse_s = reinterpret_cast<float*>(dSt + BK * LDP);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;    // causal: the first key tiles see the most queries
  const int kvbh = kv_row(bh, H, KVH);
  const T* qp = q + (size_t)bh * L * D;
  const T* dop = dout + (size_t)bh * L * D;
  const float* lsep = lse + (size_t)bh * L;
  const float* deltap = delta + (size_t)bh * L;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = 16 * (warp & 3);   // this warp's 16 keys (rows of the tile)
  const int qc0 = 32 * (warp >> 2);  // its 32 queries for Sᵀ and dPᵀ
  const int dc0 = DH * (warp >> 2);  // its 64 head columns for dK and dV
  const int key[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};

  load_tile<T, D, BK, DKV_THREADS>(Ks, k + (size_t)kvbh * L * D, k0, L, tid);
  load_tile<T, D, BK, DKV_THREADS>(Vs, v + (size_t)kvbh * L * D, k0, L, tid);

  float acc_dk[DH / 8][4], acc_dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[j][i] = acc_dv[j][i] = 0.f;

  const int n_qt = (L + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();                 // the previous query tile is no longer read
    load_tile<T, D, BQ, DKV_THREADS>(Qs, qp, q0, L, tid);
    load_tile<T, D, BQ, DKV_THREADS>(dOs, dop, q0, L, tid);
    for (int i = tid; i < BQ; i += DKV_THREADS) {
      const bool in = q0 + i < L;
      lse_s[i] = in ? lsep[q0 + i] : 0.f;
      delta_s[i] = in ? deltap[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];       // 16 keys × 32 queries of Sᵀ and dPᵀ
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tile<T, false>(st[j], Ks + kr0 * LDS + kk, LDS,
                           Qs + (qc0 + j * 8) * LDS + kk, LDS, lane);
        mma_tile<T, false>(dpt[j], Vs + kr0 * LDS + kk, LDS,
                           dOs + (qc0 + j * 8) * LDS + kk, LDS, lane);
      }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int c = qc0 + j * 8 + 2 * t + (i & 1);
        const int qpos = q0 + c;
        const bool ok = key[r] < L && qpos < L && (!causal || qpos >= key[r]);
        const float x = ok ? st[j][i] * scale : NEG_INF;
        const float p = expf(x - lse_s[c]);
        const float ds = p * (dpt[j][i] - delta_s[c]) * scale;
        Pt[(kr0 + g + 8 * r) * LDP + c] = from_f<T>(p);     // as dO's dtype
        dSt[(kr0 + g + 8 * r) * LDP + c] = from_f<T>(ds);   // as Q's dtype
      }
    __syncthreads();                 // the whole Pᵀ and dSᵀ tiles are written

#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16)
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        mma_tile<T, true>(acc_dv[j], Pt + kr0 * LDP + kk, LDP,
                          dOs + kk * LDS + dc0 + j * 8, LDS, lane);
        mma_tile<T, true>(acc_dk[j], dSt + kr0 * LDP + kk, LDP,
                          Qs + kk * LDS + dc0 + j * 8, LDS, lane);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= L) continue;
    T* dkrow = dk + ((size_t)bh * L + key[r]) * D + dc0;
    T* dvrow = dv + ((size_t)bh * L + key[r]) * D + dc0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dkrow[j * 8 + 2 * t] = from_f<T>(acc_dk[j][2 * r]);
      dkrow[j * 8 + 2 * t + 1] = from_f<T>(acc_dk[j][2 * r + 1]);
      dvrow[j * 8 + 2 * t] = from_f<T>(acc_dv[j][2 * r]);
      dvrow[j * 8 + 2 * t + 1] = from_f<T>(acc_dv[j][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int KVH, int L, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) +
                                       (size_t)BQ * (BK + PAD));
  return launch_kernel<flash_bwd_dq_mma_kernel<T, D>, smem>(
      dim3((L + BQ - 1) / BQ, B * H), DQ_THREADS, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), L, H, KVH, causal, scale);
}

template <typename T, int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int KVH, int L, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) +
                                       (size_t)2 * BK * (BQ + PAD)) +
                          sizeof(float) * 2 * BQ;
  return launch_kernel<flash_bwd_dkv_mma_kernel<T, D>, smem>(
      dim3((L + BK - 1) / BK, B * H), DKV_THREADS, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, KVH, causal, scale);
}

bool bad_shape(int B, int H, int KVH, int L) {
  return B < 1 || L < 1 || KVH < 1 || H % KVH != 0;
}

// ---------------------------------------------------------------------------
// The Hopper kernels (bf16, fp16; D = 128).

constexpr int HB = 64;                        // rows of every tile: queries or keys
constexpr int HD = 128;                       // head width
constexpr int HTHREADS = 128;                 // one warpgroup
constexpr int HSTAGES = 2;                    // ring depth
constexpr uint32_t HTILE = HB * HD * 2;       // a [64, 128] 16-bit tile: 16 KB
constexpr uint32_t HPANEL = HTILE / 2;        // its 64 columns: [64][128 B]
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV: K, V, then per stage Q and dO; LSE·log2(e) and Δ [2][64] each.
constexpr uint32_t DKV_K_OFF = 0;
constexpr uint32_t DKV_V_OFF = HTILE;
constexpr uint32_t DKV_RING_OFF = 2 * HTILE;  // stage s: Q at + 2s·HTILE, dO after it
constexpr uint32_t DKV_ROWS_OFF = DKV_RING_OFF + 2 * HSTAGES * HTILE;
constexpr uint32_t DKV_BAR_OFF = DKV_ROWS_OFF + 2 * 2 * HB * 4;
constexpr size_t DKV_SMEM = DKV_BAR_OFF + 8 * (1 + 2 * HSTAGES) + 1024;
// dQ: Q, dO, then per stage K and V.
constexpr uint32_t DQ_Q_OFF = 0;
constexpr uint32_t DQ_DO_OFF = HTILE;
constexpr uint32_t DQ_RING_OFF = 2 * HTILE;   // stage s: K at + 2s·HTILE, V after it
constexpr uint32_t DQ_BAR_OFF = DQ_RING_OFF + 2 * HSTAGES * HTILE;
constexpr size_t DQ_SMEM = DQ_BAR_OFF + 8 * (1 + 2 * HSTAGES) + 1024;
static_assert(2 * (DKV_SMEM + 1024) <= 233472 && 2 * (DQ_SMEM + 1024) <= 233472,
              "two blocks must fit one SM's 228 KB");

// Barrier i of a kernel's barrier array: 0 = the tiles loaded once;
// 1 + s = the first tile of stage s, 1 + HSTAGES + s = the second.
__device__ __forceinline__ uint32_t bar(uint32_t base, uint32_t off, int i) {
  return base + off + 8 * i;
}

// K-major descriptor of step kk (16 of D) over a 128-byte-swizzled tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk / 4) * HPANEL + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor of step kk (16 rows) over the same tile: the B
// operand [rows][D] of a product that sums over the tile's rows.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, HPANEL, 1024);
}

// Rows [row0, row0 + 64) of head `outer` of a map into a tile, both panels,
// counted on `b` (whose expected bytes the caller has announced).
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t b, int row0, int outer) {
  tma_load_3d(dst, map, b, 0, row0, outer);
  tma_load_3d(dst + HPANEL, map, b, 64, row0, outer);
}

// A [64, 128] f32 accumulator rounded to T into a tile, swizzled as TMA
// reads it: warp w's lane holds rows 16w + g and 16w + g + 8, columns
// 8jn + 2t + {0, 1}.
template <typename T>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[64], int w,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int jn = 0; jn < HD / 8; ++jn) {
    const int panel = jn / 8, chunk = jn % 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + g + 8 * r;
      const uint32_t off = panel * HPANEL + row * 128 +
                           ((chunk ^ (row & 7)) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_f2<T>(acc[4 * jn + 2 * r], acc[4 * jn + 2 * r + 1]);
    }
  }
}

// Both panels of a staged tile out through a map at rows [row0, row0 + 64)
// of head `outer`; rows >= L are clipped.
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               uint32_t src, int row0,
                                               int outer) {
  tma_store_3d(map, src, 0, row0, outer);
  tma_store_3d(map, src + HPANEL, 64, row0, outer);
}

template <typename T>
__global__ void __launch_bounds__(HTHREADS, 2)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_dk,
                           const __grid_constant__ CUtensorMap map_dv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int L, int H,
                           int KVH, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  const uint32_t raw = smem_u32(dkv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle alignment
  unsigned char* smem = dkv_smem + (base - raw);
  float* lse_s = reinterpret_cast<float*>(smem + DKV_ROWS_OFF);   // [2][64]
  float* dlt_s = lse_s + 2 * HB;                                  // [2][64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * HB;            // key tile 0 sees the most queries
  const int kvbh = kv_row(bh, H, KVH);
  const int qt0 = causal ? blockIdx.y : 0;   // from the diagonal down
  const int n = (L + HB - 1) / HB - qt0;     // query tiles to walk, >= 1
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * LOG2E;
  const uint32_t ka = base + DKV_K_OFF, va = base + DKV_V_OFF;

  auto load_q_do = [&](int s, int q0) {
    const uint32_t qa = base + DKV_RING_OFF + 2 * s * HTILE;
    mbar_expect_tx(bar(base, DKV_BAR_OFF, 1 + s), HTILE);
    tma_tile(qa, &map_q, bar(base, DKV_BAR_OFF, 1 + s), q0, bh);
    mbar_expect_tx(bar(base, DKV_BAR_OFF, 1 + HSTAGES + s), HTILE);
    tma_tile(qa + HTILE, &map_do, bar(base, DKV_BAR_OFF, 1 + HSTAGES + s), q0,
             bh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * HSTAGES; ++i) mbar_init(bar(base, DKV_BAR_OFF, i), 1);
    mbar_fence_init();
    mbar_expect_tx(bar(base, DKV_BAR_OFF, 0), 2 * HTILE);
    tma_tile(ka, &map_k, bar(base, DKV_BAR_OFF, 0), k0, kvbh);
    tma_tile(va, &map_v, bar(base, DKV_BAR_OFF, 0), k0, kvbh);
    for (int s = 0; s < HSTAGES && s < n; ++s) load_q_do(s, (qt0 + s) * HB);
  }

  // Threads 0-63 stage LSE·log2(e), threads 64-127 Δ, one query row each.
  const int ri = tid % HB;
  const float* rsrc = (tid < HB ? lse : delta) + (size_t)bh * L;
  const float rmul = tid < HB ? LOG2E : 1.f;
  float* rdst = tid < HB ? lse_s : dlt_s;
  auto row_val = [&](int q0) {
    return q0 + ri < L ? rsrc[q0 + ri] * rmul : 0.f;
  };
  rdst[ri] = row_val(qt0 * HB);
  __syncthreads();                           // barriers initialised, rows staged

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const int key[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};

  mbar_wait(bar(base, DKV_BAR_OFF, 0), 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % HSTAGES;
    const uint32_t parity = (it / HSTAGES) & 1;
    const int q0 = (qt0 + it) * HB;
    const uint32_t qa = base + DKV_RING_OFF + 2 * s * HTILE, da = qa + HTILE;
    const float* ls = lse_s + (it & 1) * HB;
    const float* dl = dlt_s + (it & 1) * HB;
    const float next = it + 1 < n ? row_val(q0 + HB) : 0.f;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 8 steps of 16 along D each.
    float st[32], dpt[32];
    mbar_wait(bar(base, DKV_BAR_OFF, 1 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(st, kmajor(ka, kk), kmajor(qa, kk), kk > 0);
    wgmma_commit();
    mbar_wait(bar(base, DKV_BAR_OFF, 1 + HSTAGES + s), parity);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(dpt, kmajor(va, kk), kmajor(da, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P'ᵀ (dO's dtype) and dS'ᵀ (Q's dtype) packed into A fragments: pf[m]
    // holds columns 2m, 2m+1 of the accumulator, so queries 16kk..16kk+15
    // are pf[4kk..4kk+3].  Column 8j + 2t + e is query q0 + 8j + 2t + e.
    const bool edge = (causal && q0 < k0 + HB) || q0 + HB > L || k0 + HB > L;
    uint32_t pf[16], sf[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        float p0 = exp2f(fmaf(st[i], c, -l2.x));
        float p1 = exp2f(fmaf(st[i + 1], c, -l2.y));
        if (edge) {
          const int qc = q0 + 8 * j + 2 * t;
          if (key[r] >= L || qc >= L || (causal && qc < key[r])) p0 = 0.f;
          if (key[r] >= L || qc + 1 >= L || (causal && qc + 1 < key[r])) p1 = 0.f;
        }
        pf[2 * j + r] = pack_f2<T>(p0, p1);
        sf[2 * j + r] = pack_f2<T>(p0 * (dpt[i] - d2.x) * scale,
                                   p1 * (dpt[i + 1] - d2.y) * scale);
      }
    }

    // dV += P'ᵀ·dO and dK += dS'ᵀ·Q: 4 steps of 16 queries each.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HB / 16; ++kk) {
      const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                             pf[4 * kk + 3]};
      wgmma_rs<T>(dv, a, mnmajor(da, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < HB / 16; ++kk) {
      const uint32_t a[4] = {sf[4 * kk], sf[4 * kk + 1], sf[4 * kk + 2],
                             sf[4 * kk + 3]};
      wgmma_rs<T>(dk, a, mnmajor(qa, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);

    rdst[((it + 1) & 1) * HB + ri] = next;
    __syncthreads();                         // stage s is read; next rows staged
    if (tid == 0 && it + HSTAGES < n) load_q_do(s, (qt0 + it + HSTAGES) * HB);
  }

  // dK and dV rounded once into the K and V tiles, then out by TMA.
  stage_acc<T>(smem + DKV_K_OFF, dk, w, lane);
  stage_acc<T>(smem + DKV_V_OFF, dv, w, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_tile(&map_dk, ka, k0, bh);
    tma_store_tile(&map_dv, va, k0, bh);
    tma_store_wait();
  }
}

template <typename T>
__global__ void __launch_bounds__(HTHREADS, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int L, int H,
                          int KVH, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle alignment
  unsigned char* smem = dq_smem + (base - raw);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;      // longest tiles first
  const int q0 = qt * HB;
  const int kvbh = kv_row(bh, H, KVH);
  int n = (L + HB - 1) / HB;
  if (causal) n = min(n, qt + 1);                 // stop at the diagonal
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * LOG2E;
  const uint32_t qa = base + DQ_Q_OFF, doa = base + DQ_DO_OFF;

  auto load_kv = [&](int s, int k0) {
    const uint32_t ka = base + DQ_RING_OFF + 2 * s * HTILE;
    mbar_expect_tx(bar(base, DQ_BAR_OFF, 1 + s), HTILE);
    tma_tile(ka, &map_k, bar(base, DQ_BAR_OFF, 1 + s), k0, kvbh);
    mbar_expect_tx(bar(base, DQ_BAR_OFF, 1 + HSTAGES + s), HTILE);
    tma_tile(ka + HTILE, &map_v, bar(base, DQ_BAR_OFF, 1 + HSTAGES + s), k0,
             kvbh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * HSTAGES; ++i) mbar_init(bar(base, DQ_BAR_OFF, i), 1);
    mbar_fence_init();
    mbar_expect_tx(bar(base, DQ_BAR_OFF, 0), 2 * HTILE);
    tma_tile(qa, &map_q, bar(base, DQ_BAR_OFF, 0), q0, bh);
    tma_tile(doa, &map_do, bar(base, DQ_BAR_OFF, 0), q0, bh);
    for (int s = 0; s < HSTAGES && s < n; ++s) load_kv(s, s * HB);
  }

  // LSE·log2(e) and Δ of this lane's two query rows.
  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < L;
    l2[r] = in ? lse[(size_t)bh * L + row[r]] * LOG2E : 0.f;
    d2[r] = in ? delta[(size_t)bh * L + row[r]] : 0.f;
  }
  __syncthreads();                                // barriers initialised

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;

  mbar_wait(bar(base, DQ_BAR_OFF, 0), 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % HSTAGES;
    const uint32_t parity = (j / HSTAGES) & 1;
    const int k0 = j * HB;
    const uint32_t ka = base + DQ_RING_OFF + 2 * s * HTILE, va = ka + HTILE;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 8 steps of 16 along D each.
    float sc[32], dp[32];
    mbar_wait(bar(base, DQ_BAR_OFF, 1 + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(sc, kmajor(qa, kk), kmajor(ka, kk), kk > 0);
    wgmma_commit();
    mbar_wait(bar(base, DQ_BAR_OFF, 1 + HSTAGES + s), parity);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(dp, kmajor(doa, kk), kmajor(va, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS' (K's dtype) packed into A fragments; column 8jj + 2t + e is key
    // k0 + 8jj + 2t + e.
    const bool edge = (causal && j == n - 1) || k0 + HB > L || q0 + HB > L;
    uint32_t sf[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * jj + 2 * r;
        float p0 = exp2f(fmaf(sc[i], c, -l2[r]));
        float p1 = exp2f(fmaf(sc[i + 1], c, -l2[r]));
        if (edge) {
          const int kc = k0 + 8 * jj + 2 * t;
          if (row[r] >= L || kc >= L || (causal && kc > row[r])) p0 = 0.f;
          if (row[r] >= L || kc + 1 >= L || (causal && kc + 1 > row[r])) p1 = 0.f;
        }
        sf[2 * jj + r] = pack_f2<T>(p0 * (dp[i] - d2[r]) * scale,
                                    p1 * (dp[i + 1] - d2[r]) * scale);
      }
    }

    // dQ += dS'·K: 4 steps of 16 keys, K read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HB / 16; ++kk) {
      const uint32_t a[4] = {sf[4 * kk], sf[4 * kk + 1], sf[4 * kk + 2],
                             sf[4 * kk + 3]};
      wgmma_rs<T>(dq, a, mnmajor(ka, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    __syncthreads();                              // stage s is read
    if (tid == 0 && j + HSTAGES < n) load_kv(s, (j + HSTAGES) * HB);
  }

  // dQ rounded once into the Q tile, then out by TMA.
  stage_acc<T>(smem + DQ_Q_OFF, dq, w, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_tile(&map_dq, qa, q0, bh);
    tma_store_wait();
  }
}

// Asks for the largest shared-memory carveout once per kernel, so two
// ~98 KB blocks fit one SM.
template <auto kernel>
int prefer_max_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <typename T>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int KVH, int L,
                     int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int err = encode_rows_map<T>(&mq, q, B * H, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mdo, dout, B * H, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mdk, dk, B * H, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mdv, dv, B * H, L, HD, HB);
  if (!err) err = prefer_max_smem<flash_bwd_dkv_wgmma_kernel<T>>();
  if (err) return err;
  return launch_kernel<flash_bwd_dkv_wgmma_kernel<T>, DKV_SMEM>(
      dim3(B * H, (L + HB - 1) / HB), HTHREADS, stream, mq, mk, mv, mdo, mdk,
      mdv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      L, H, KVH, causal, scale);
}

template <typename T>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int H, int KVH, int L, int causal,
                    float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  int err = encode_rows_map<T>(&mq, q, B * H, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mdo, dout, B * H, L, HD, HB);
  if (!err) err = encode_rows_map<T>(&mdq, dq, B * H, L, HD, HB);
  if (!err) err = prefer_max_smem<flash_bwd_dq_wgmma_kernel<T>>();
  if (err) return err;
  return launch_kernel<flash_bwd_dq_wgmma_kernel<T>, DQ_SMEM>(
      dim3(B * H, (L + HB - 1) / HB), HTHREADS, stream, mq, mk, mv, mdo, mdq,
      static_cast<const float*>(lse), static_cast<const float*>(delta), L, H,
      KVH, causal, scale);
}

// The mma.sync kernels' launches for each storage dtype at head width D.
template <int D>
int dispatch_dq_mma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int H, int KVH, int L, int dtype,
                    int causal, float scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_dq_mma<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dq, B,
                                             H, KVH, L, causal, scale, s);
    case 1:
      return launch_dq_mma<__half, D>(q, k, v, dout, lse, delta, dq, B, H, KVH,
                                      L, causal, scale, s);
    case 2:
      return launch_dq_mma<float, D>(q, k, v, dout, lse, delta, dq, B, H, KVH,
                                     L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int dispatch_dkv_mma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int KVH, int L,
                     int dtype, int causal, float scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_dkv_mma<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dk,
                                              dv, B, H, KVH, L, causal, scale,
                                              s);
    case 1:
      return launch_dkv_mma<__half, D>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                       KVH, L, causal, scale, s);
    case 2:
      return launch_dkv_mma<float, D>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                      KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout [B·H, L, D]; k/v [B·KVH, L, D]; dq [B·H, L, D], all in one dtype
// (0 = bf16, 1 = fp16, 2 = f32); lse, delta [B·H, L] f32.  All contiguous
// and 16-byte aligned.  Returns a cudaError_t: 0 when the launch was
// accepted, cudaErrorInvalidValue for a shape or dtype the entry does not
// take.
//
// The Hopper dQ kernel: bf16 and fp16 at D = 128 (f32 is refused).
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int KVH, int L, int D, int dtype,
                     int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L) || D != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq_wgmma<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B,
                                            H, KVH, L, causal, scale, s);
    case 1:
      return launch_dq_wgmma<__half>(q, k, v, dout, lse, delta, dq, B, H, KVH,
                                     L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As hvd_flash_bwd_dq; dk/dv are per *query* head, [B·H, L, D] in the
// inputs' dtype, for the caller to sum over each GQA group.  The Hopper
// dK/dV kernel: bf16 and fp16 at D = 128.
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int KVH, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L) || D != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dkv_wgmma<__nv_bfloat16>(q, k, v, dout, lse, delta, dk,
                                             dv, B, H, KVH, L, causal, scale,
                                             s);
    case 1:
      return launch_dkv_wgmma<__half>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                      KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of each Hopper kernel, in bytes.
int hvd_flash_bwd_dq_smem_bytes() { return (int)DQ_SMEM; }
int hvd_flash_bwd_dkv_smem_bytes() { return (int)DKV_SMEM; }

// The mma.sync / FMA kernels, every dtype, at D = 64 (the ViT head width)
// or D = 128; same arguments.
int hvd_flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int KVH, int L, int D, int dtype,
                     int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_dq_mma<64>(q, k, v, dout, lse, delta, dq, B, H, KVH, L,
                                 dtype, causal, scale, s);
    case 128:
      return dispatch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, KVH, L,
                                  dtype, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int hvd_flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int KVH, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH,
                                  L, dtype, causal, scale, s);
    case 128:
      return dispatch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   KVH, L, dtype, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
