// Flash-attention backward at head dim 64 for NVIDIA Hopper (sm_90a), plain
// C interface: the dQ kernel and the dK/dV kernel of the ViT path.
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`,
// launched by `_flash_backward` (horovod_tpu/parallel/flash_attention.py),
// at D = 64 in bf16 and fp16.  The contract is flash_bwd.cu's (its header):
// S = Q·Kᵀ·scale with the tail and causal masks, P = exp(S − LSE),
// dS = P∘(dO·Vᵀ − Δ)·scale, dQ = Σ_k dS'·K, dV = Σ_q P'ᵀ·dO,
// dK = Σ_q dS'ᵀ·Q, P' and dS' rounded to the storage dtype, f32
// accumulation, each gradient rounded once, dK/dV per *query* head for the
// caller's GQA group-sum, and every output element owned by one block (no
// atomics).
//
// Bound on an H100 SXM: at the ViT-B/16 shape (B = 64, L = 196, 12 heads,
// non-causal, bf16) both kernels are bound by bytes: dQ moves 97 MB (q, k,
// v, dO read, dQ written, LSE and Δ: 29 µs at 3.35 TB/s) against 11.3 GFLOP
// (11.5 µs at 989 TFLOP/s), dK/dV 117 MB (35 µs) against 15.1 GFLOP
// (15.3 µs).  A head is 25 KB a tensor and four 64-row tiles, the last one
// holding 4 rows.
//
// Design.  One block per (b·h, 64-row tile), one warpgroup of 128 threads,
// four blocks an SM (at most 128 registers a thread, ~50 KB of shared
// memory a block), the grid ordered tile-fastest so that a head's blocks
// run together and re-read its streamed operands from L2.  The kernels are
// bound by latency more than by either roofline (a head is four tiles: a
// block's walk is short), so the layout buys blocks in flight: three
// blocks an SM ran 12 % (dQ) and 20 % (dK/dV) slower, and a whole ViT head
// in one block (two warpgroups of two 64-row tiles) 1.4× slower.  Thread
// 0 issues every copy by TMA through 3-D tensor maps over [rows, L, 64]
// (128-byte swizzle: a row of 64 16-bit values is one swizzled panel;
// boxes of 64 rows, tails zero-filled, stores clipped at L).  Every
// product is wgmma:
//
//   dK/dV: the block's K and V tiles loaded once, Q and dO through a
//   two-stage ring on mbarriers.  Each 64-query tile in two halves of 32
//   queries: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n32k16, both operands K-major
//   in shared memory), then dV += P'ᵀ·dO and dK += dS'ᵀ·Q (m64n64k16) with
//   P'ᵀ and dS'ᵀ packed from the Sᵀ/dPᵀ accumulators straight into the A
//   fragments (registers) and dO, Q read MN-major.  Halves keep the
//   transient accumulators at 32 registers beside dK's and dV's 64, which
//   is what lets four blocks share an SM, and a half wholly past L is
//   skipped (at L = 196 the last tile holds 4 queries).  Pᵀ is formed
//   while dPᵀ is still in the tensor cores.  LSE and Δ are staged per
//   query tile in shared memory.
//
//   dQ: the block's Q and dO tiles loaded once, K and V through the ring;
//   S = Q·Kᵀ, dP = dO·Vᵀ (m64n64k16), dQ += dS'·K (m64n64k16) with dS' from
//   registers and K read MN-major; P is formed while dP is in flight.  LSE
//   and Δ of a thread's rows stay in registers.

#include "flash_d64.cuh"

namespace {

using namespace hvd_flash;
using namespace hvd_flash::d64;

constexpr int QW = 32;                        // queries of a dK/dV product
constexpr int THREADS = 128;                  // one warpgroup
constexpr int MINB = 4;                       // blocks an SM
constexpr int STAGES = 2;                     // the streamed operands' ring

// Shared memory: the block's own two tiles (K and V, or Q and dO), the ring
// (stage s: two tiles at RING_OFF + 2s·TILE), LSE·log2(e) and Δ [2][64]
// each (dK/dV), the mbarriers (0: the block's tiles; 1 + s: stage s's
// first tile; 1 + STAGES + s: its second), and 1024 bytes of slack for the
// 1024-byte alignment of the tiles.
constexpr uint32_t A_OFF = 0;
constexpr uint32_t B_OFF = TILE;
constexpr uint32_t RING_OFF = 2 * TILE;
constexpr uint32_t ROWS_OFF = RING_OFF + 2 * STAGES * TILE;
constexpr uint32_t BAR_OFF = ROWS_OFF + 2 * 2 * TB * 4;
constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
static_assert(MINB * (SMEM + 1024) <= 233472, "blocks must fit one SM");

template <typename T>
__global__ void __launch_bounds__(THREADS, MINB)
flash_bwd_dkv_d64_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dk,
                         const __grid_constant__ CUtensorMap map_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int L, int H,
                         int KVH, int causal, float scale, int tiles) {
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  const uint32_t raw = smem_u32(dkv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle alignment
  unsigned char* smem = dkv_smem + (base - raw);
  float* lse_s = reinterpret_cast<float*>(smem + ROWS_OFF);   // [2][64]
  float* dlt_s = lse_s + 2 * TB;                              // [2][64]
  const uint32_t bars = base + BAR_OFF;
  const uint32_t ka = base + A_OFF, va = base + B_OFF;

  const int bh = blockIdx.x / tiles;              // tile-fastest: a head's
  const int k0 = (blockIdx.x % tiles) * TB;       // blocks run together
  const int kvbh = kv_row(bh, H, KVH);
  const int qt0 = causal ? k0 / TB : 0;           // from the diagonal down
  const int n = (L + TB - 1) / TB - qt0;          // query tiles, >= 1
  const int tid = threadIdx.x, w = tid / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const float c = scale * LOG2E;

  auto load_q_do = [&](int s, int q0) {
    const uint32_t qa = base + RING_OFF + 2 * s * TILE;
    mbar_expect_tx(bars + 8 * (1 + s), TILE);
    tma_load_3d(qa, &map_q, bars + 8 * (1 + s), 0, q0, bh);
    mbar_expect_tx(bars + 8 * (1 + STAGES + s), TILE);
    tma_load_3d(qa + TILE, &map_do, bars + 8 * (1 + STAGES + s), 0, q0, bh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bars, 2 * TILE);
    tma_load_3d(ka, &map_k, bars, 0, k0, kvbh);
    tma_load_3d(va, &map_v, bars, 0, k0, kvbh);
    for (int s = 0; s < STAGES && s < n; ++s) load_q_do(s, (qt0 + s) * TB);
  }

  // Threads 0-63 stage LSE·log2(e), threads 64-127 Δ, one query row each.
  const bool lse_row = tid < TB;
  const int ri = tid % TB;
  const float* rsrc = (lse_row ? lse : delta) + (size_t)bh * L;
  const float rmul = lse_row ? LOG2E : 1.f;
  float* rdst = lse_row ? lse_s : dlt_s;
  auto row_val = [&](int q0) {
    return q0 + ri < L ? rsrc[q0 + ri] * rmul : 0.f;
  };
  rdst[ri] = row_val(qt0 * TB);
  __syncthreads();                                // barriers initialised

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const int key[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};

  mbar_wait(bars, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int q0 = (qt0 + it) * TB;
    const uint32_t qa = base + RING_OFF + 2 * s * TILE, da = qa + TILE;
    const float* ls = lse_s + (it & 1) * TB;
    const float* dl = dlt_s + (it & 1) * TB;
    const float next = it + 1 < n ? row_val(q0 + TB) : 0.f;
    mbar_wait(bars + 8 * (1 + s), parity);
    mbar_wait(bars + 8 * (1 + STAGES + s), parity);

#pragma unroll
    for (int h = 0; h < TB / QW; ++h) {
      const int qh = q0 + h * QW;
      if (qh >= L) continue;                      // every query of the half
      const uint32_t qha = qa + h * QW * 128, dha = da + h * QW * 128;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the half's QW queries: 4 steps of
      // 16 along D each, two commit groups, so P is formed while dPᵀ is
      // still in the tensor cores.
      float st[QW / 2], dpt[QW / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss32<T>(st, kmajor(ka, kk), kmajor(qha, kk), kk > 0);
      wgmma_commit();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss32<T>(dpt, kmajor(va, kk), kmajor(dha, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // Pᵀ in place of Sᵀ; column 8jj + 2t + e is query qh + 8jj + 2t + e.
      const bool edge =
          (causal && qh < k0 + TB) || qh + QW > L || k0 + TB > L;
#pragma unroll
      for (int jj = 0; jj < QW / 8; ++jj) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + h * QW + 8 * jj + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * jj + 2 * r;
          st[i] = exp2f(fmaf(st[i], c, -l2.x));
          st[i + 1] = exp2f(fmaf(st[i + 1], c, -l2.y));
          if (edge) {
            const int qc = qh + 8 * jj + 2 * t;
            if (key[r] >= L || qc >= L || (causal && qc < key[r]))
              st[i] = 0.f;
            if (key[r] >= L || qc + 1 >= L || (causal && qc + 1 < key[r]))
              st[i + 1] = 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);

      // P'ᵀ (dO's dtype) and dS'ᵀ (Q's dtype) packed into A fragments:
      // pf[m] holds columns 2m, 2m+1.
      uint32_t pf[QW / 4], sf[QW / 4];
#pragma unroll
      for (int jj = 0; jj < QW / 8; ++jj) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl + h * QW + 8 * jj + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * jj + 2 * r;
          pf[2 * jj + r] = pack_f2<T>(st[i], st[i + 1]);
          sf[2 * jj + r] = pack_f2<T>(st[i] * (dpt[i] - d2.x) * scale,
                                      st[i + 1] * (dpt[i + 1] - d2.y) * scale);
        }
      }

      // dV += P'ᵀ·dO and dK += dS'ᵀ·Q: 2 steps of 16 queries each.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t a[4];
        frag(a, pf, kk);
        wgmma_rs64<T>(dv, a, mnmajor(dha, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t a[4];
        frag(a, sf, kk);
        wgmma_rs64<T>(dk, a, mnmajor(qha, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }

    rdst[((it + 1) & 1) * TB + ri] = next;
    __syncthreads();                              // stage s is read
    if (tid == 0 && it + STAGES < n)
      load_q_do(s, (qt0 + it + STAGES) * TB);
  }

  // dK and dV rounded once into the K and V tiles, then out by TMA.
  stage_acc<T>(smem + A_OFF, dk, w, lane);
  stage_acc<T>(smem + B_OFF, dv, w, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_3d(&map_dk, ka, 0, k0, bh);
    tma_store_3d(&map_dv, va, 0, k0, bh);
    tma_store_wait();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MINB)
flash_bwd_dq_d64_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int L, int H,
                        int KVH, int causal, float scale, int tiles) {
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle alignment
  unsigned char* smem = dq_smem + (base - raw);
  const uint32_t bars = base + BAR_OFF;
  const uint32_t qa = base + A_OFF, doa = base + B_OFF;

  const int bh = blockIdx.x / tiles;              // tile-fastest, and in a
  const int q0 = (tiles - 1 - blockIdx.x % tiles) * TB;   // head the longest
  const int kvbh = kv_row(bh, H, KVH);            // walks first
  int n = (L + TB - 1) / TB;                      // key tiles
  if (causal) n = min(n, q0 / TB + 1);            // to the diagonal
  const int tid = threadIdx.x, w = tid / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const float c = scale * LOG2E;

  auto load_kv = [&](int s, int k0) {
    const uint32_t ka = base + RING_OFF + 2 * s * TILE;
    mbar_expect_tx(bars + 8 * (1 + s), TILE);
    tma_load_3d(ka, &map_k, bars + 8 * (1 + s), 0, k0, kvbh);
    mbar_expect_tx(bars + 8 * (1 + STAGES + s), TILE);
    tma_load_3d(ka + TILE, &map_v, bars + 8 * (1 + STAGES + s), 0, k0, kvbh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bars, 2 * TILE);
    tma_load_3d(qa, &map_q, bars, 0, q0, bh);
    tma_load_3d(doa, &map_do, bars, 0, q0, bh);
    for (int s = 0; s < STAGES && s < n; ++s) load_kv(s, s * TB);
  }

  // LSE·log2(e) and Δ of this lane's two rows.
  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < L;
    l2[r] = in ? lse[(size_t)bh * L + row[r]] * LOG2E : 0.f;
    d2[r] = in ? delta[(size_t)bh * L + row[r]] : 0.f;
  }
  __syncthreads();                                // barriers initialised

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = it * TB;
    const uint32_t ka = base + RING_OFF + 2 * s * TILE, va = ka + TILE;
    mbar_wait(bars + 8 * (1 + s), parity);

    // S = Q·Kᵀ and dP = dO·Vᵀ: 4 steps of 16 along D each, two commit
    // groups, so P is formed while dP is still in the tensor cores.
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(sc, kmajor(qa, kk), kmajor(ka, kk), kk > 0);
    wgmma_commit();
    mbar_wait(bars + 8 * (1 + STAGES + s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T>(dp, kmajor(doa, kk), kmajor(va, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in place of S; column 8jj + 2t + e is key k0 + 8jj + 2t + e.
    const bool edge = (causal && k0 + TB > q0) || k0 + TB > L || q0 + TB > L;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * jj + 2 * r;
        sc[i] = exp2f(fmaf(sc[i], c, -l2[r]));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], c, -l2[r]));
        if (edge) {
          const int kc = k0 + 8 * jj + 2 * t;
          if (row[r] >= L || kc >= L || (causal && kc > row[r])) sc[i] = 0.f;
          if (row[r] >= L || kc + 1 >= L || (causal && kc + 1 > row[r]))
            sc[i + 1] = 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS' (K's dtype) packed into A fragments.
    uint32_t sf[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * jj + 2 * r;
        sf[2 * jj + r] = pack_f2<T>(sc[i] * (dp[i] - d2[r]) * scale,
                                    sc[i + 1] * (dp[i + 1] - d2[r]) * scale);
      }

    // dQ += dS'·K: 4 steps of 16 keys, K read MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TB / 16; ++kk) {
      uint32_t a[4];
      frag(a, sf, kk);
      wgmma_rs64<T>(dq, a, mnmajor(ka, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    __syncthreads();                              // stage s is read
    if (tid == 0 && it + STAGES < n) load_kv(s, (it + STAGES) * TB);
  }

  // dQ rounded once into the Q tile, then out by TMA.
  stage_acc<T>(smem + A_OFF, dq, w, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_3d(&map_dq, qa, 0, q0, bh);
    tma_store_wait();
  }
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int KVH, int L, int causal, float scale,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int err = encode_rows_map<T>(&mq, q, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mdo, dout, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mdk, dk, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mdv, dv, B * H, L, HD, TB);
  if (!err) err = prefer_max_smem<flash_bwd_dkv_d64_kernel<T>>();
  if (err) return err;
  const int tiles = (L + TB - 1) / TB;
  return launch_kernel<flash_bwd_dkv_d64_kernel<T>, SMEM>(
      dim3(tiles * B * H), THREADS, stream, mq, mk, mv, mdo, mdk, mdv,
      static_cast<const float*>(lse), static_cast<const float*>(delta), L, H,
      KVH, causal, scale, tiles);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int KVH, int L, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  int err = encode_rows_map<T>(&mq, q, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mdo, dout, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mdq, dq, B * H, L, HD, TB);
  if (!err) err = prefer_max_smem<flash_bwd_dq_d64_kernel<T>>();
  if (err) return err;
  const int tiles = (L + TB - 1) / TB;
  return launch_kernel<flash_bwd_dq_d64_kernel<T>, SMEM>(
      dim3(tiles * B * H), THREADS, stream, mq, mk, mv, mdo, mdq,
      static_cast<const float*>(lse), static_cast<const float*>(delta), L, H,
      KVH, causal, scale, tiles);
}

}  // namespace

extern "C" {

// q, dout [B·H, L, 64]; k/v [B·KVH, L, 64]; dq [B·H, L, 64], all in one
// dtype (0 = bf16, 1 = fp16); lse, delta [B·H, L] f32.  All contiguous and
// 16-byte aligned.  Returns a cudaError_t: 0 when the launch was accepted,
// cudaErrorInvalidValue for a shape or dtype the entry does not take (D
// other than 64, f32).
int hvd_flash_bwd_dq_d64(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int H, int KVH, int L, int D,
                         int dtype, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L) || D != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H,
                                      KVH, L, causal, scale, s);
    case 1:
      return launch_dq<__half>(q, k, v, dout, lse, delta, dq, B, H, KVH, L,
                               causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As hvd_flash_bwd_dq_d64; dk/dv are per *query* head, [B·H, L, 64] in the
// inputs' dtype, for the caller to sum over each GQA group.
int hvd_flash_bwd_dkv_d64(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int H,
                          int KVH, int L, int D, int dtype, int causal,
                          float scale, void* stream) {
  if (bad_shape(B, H, KVH, L) || D != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, KVH, L, causal, scale, s);
    case 1:
      return launch_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH,
                                L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of each kernel, in bytes.
int hvd_flash_bwd_dq_d64_smem_bytes() { return (int)SMEM; }
int hvd_flash_bwd_dkv_d64_smem_bytes() { return (int)SMEM; }

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
