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
// with the reference's three rounding points.  dK/dV are written per *query*
// head ([B·H, L, D]) and group-summed to the KV heads by the caller, as the
// reference does, so the GQA heads of a group never race.  GQA reads KV row
// (bh / H)·KVH + (bh % H) / (H / KVH) for q row bh, the forward's index map.
//
// Design, for Llama-3's head width D = 128, tiles of 64 queries × 64 keys.
//
// dQ: one block per (b·h, 64-row query tile), four warps of 16 query rows,
// the forward's structure.  Q and dO stay in shared memory; the block walks
// the K/V tiles up to the causal diagonal, computes S and dP on the tensor
// cores (`mma.sync.m16n8k16`, bf16/fp16 operands, f32 accumulation), forms
// dS in f32 registers, rounds it into a per-warp shared-memory tile and
// accumulates dS·K into f32 registers.  dQ is written once; no atomics.
//
// dK/dV: one block per (b·h, 64-key tile), eight warps.  The block keeps its
// K and V tiles in shared memory and walks the query tiles from the diagonal
// down.  It computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, keys as rows, so
// LSE and Δ broadcast along the columns and Pᵀ and dSᵀ come out with keys as
// rows: they are rounded into shared memory and read back as the left
// operand of Pᵀ·dO and dSᵀ·Q without a transpose.  The accumulators are the
// register hazard (2 × 64 × 128 f32 per block): with four warps each thread
// would hold 128 of them besides S and dP, so eight warps split the work.
// For Sᵀ/dPᵀ warp w owns keys 16·(w%4) and queries 32·(w/4); for dK/dV it
// owns keys 16·(w%4) and head columns 64·(w/4), 64 accumulators a thread.
//
// Tails: rows >= L are zero-filled on load; keys >= L and queries >= L are
// masked explicitly (a query row past L has no LSE, so it is masked rather
// than trusted), so the caller pads nothing.  A masked entry has
// P = exp(NEG_INF − LSE) = 0, as in the reference.  For float32 inputs the
// same fragment layout is computed with plain FMAs (no TF32).
//
// Bound on an H100 SXM: causal backward at Llama-3-8B widths is tensor-core
// bound: dQ runs three products, dK/dV four, each 2·B·H·D·L(L+1)/2 FLOP over
// the causal triangle, against 989 TFLOP/s bf16; the bytes (q, dO, k, v,
// LSE, Δ once, the gradients written once) take a small fraction of that at
// 3.35 TB/s.  What this simple design leaves on the table is the forward's
// list: no wgmma, no TMA or cp.async pipelining, scalar fragment loads, P
// and dS round-tripped through shared memory.

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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int KVH, int L, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) +
                                       (size_t)BQ * (BK + PAD));
  return launch_kernel<flash_bwd_dq_kernel<T, D>, smem>(
      dim3((L + BQ - 1) / BQ, B * H), DQ_THREADS, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), L, H, KVH, causal, scale);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int KVH, int L, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) +
                                       (size_t)2 * BK * (BQ + PAD)) +
                          sizeof(float) * 2 * BQ;
  return launch_kernel<flash_bwd_dkv_kernel<T, D>, smem>(
      dim3((L + BK - 1) / BK, B * H), DKV_THREADS, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, KVH, causal, scale);
}

bool bad_shape(int B, int H, int KVH, int L, int D) {
  return B < 1 || L < 1 || KVH < 1 || H % KVH != 0 || D != 128;
}

}  // namespace

extern "C" {

// q, dout [B·H, L, D]; k/v [B·KVH, L, D]; dq [B·H, L, D], all in one dtype
// (0 = bf16, 1 = fp16, 2 = f32); lse, delta [B·H, L] f32.  All contiguous;
// D must be 128.  Returns a cudaError_t: 0 when the launch was accepted.
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int KVH, int L, int D, int dtype,
                     int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H,
                                           KVH, L, causal, scale, s);
    case 1:
      return launch_dq<__half, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH,
                                    L, causal, scale, s);
    case 2:
      return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, KVH, L,
                                   causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As hvd_flash_bwd_dq; dk/dv are per *query* head, [B·H, L, D] in the
// inputs' dtype, for the caller to sum over each GQA group.
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int KVH, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                            B, H, KVH, L, causal, scale, s);
    case 1:
      return launch_dkv<__half, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                     KVH, L, causal, scale, s);
    case 2:
      return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
