// Riccati backward sweep of one HS-DDP iteration for a batch of scenarios,
// from materialized LQ data (A, B and every cost partial in device memory).
//
// Replaces hkdmpc_tpu/ops/pallas_backward.py:_kernel, the TPU kernel behind
// backward_sweep_pallas (reached through solver/backward.py:riccati_backward
// under vmap). Wrapper, plain PyTorch version and launch counter:
// hkdmpc_tpu_torch/ops/riccati_dense.py.
//
// What it computes, per scenario, with the value carry (G 24, H 24x24) held
// in shared memory:
//   - seed G/H with the terminal partials phix/phixx of the scenario's last
//     active node;
//   - for t = T-1 .. 0: Gn = G + H * defect[t+1], then
//     DYN: Q expansion from A[t], B[t], lxx[t], luu[t], lx[t], lu[t] with
//     the per-scenario reg on the Qxx and Quu diagonals, Gaussian
//     elimination with the PSD gate pivot > 1e-9 on [Quu | Qux | Qu] and
//     back-substitution, K = -Quu^-1 Qux, dU = -Quu^-1 Qu, and the value
//     update H = sym(Qxx - Qux' S), G = Qx - Qux' s, dv = Qu' s;
//     RESET (A holds Px): G = phix[t] + Px' Gn, H = phixx[t] + Px' H Px;
//     PAD: the value carries through, K and dU are zero.
// There is no lux input (the JAX package's array interface drops it). The
// Pallas kernel pivots a Gauss-Jordan split sweep; this kernel runs the
// Gaussian elimination K1 runs (riccati_step.cuh, shared with
// riccati_hkd.cu). The PSD gate can flip at the ulp level between the two
// orders, so `ok` is compared on a share of scenarios, not bit for bit.
//
// What bounds it on the H100: at B = 4096, T = 75 each DYN step reads four
// 24x24 tiles (9.2 KB) per scenario, about 2.8 GB per sweep with K's 0.7 GB
// written back: roughly 1 ms of HBM bandwidth. The serial chain inside each
// scenario (75 steps, each with 24 dependent pivots, dense 24-term products
// and block-wide barriers) bounds it, as it bounds K1. The design is K1's:
// one 32-thread block per scenario (4096 independent blocks fill the 132
// SMs; every barrier is a single-warp barrier), the carry and the working
// tiles (about 29 KB) in shared memory, each 24x24 tile loaded by the
// block's threads on consecutive addresses, rows of each product and of
// each elimination step spread over the threads, pivots in sequence, and K
// and dU written straight into their (B, T, ...) layout.

#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using namespace riccati;

struct Smem {
  float H[NX][NX];
  float A[NX][NX];     // DYN: A[t]; RESET: Px
  float B[NX][NX];
  float HA[NX][NX];
  float HB[NX][NX];
  float Qxx[NX][NX];   // lxx[t], then lxx + A'HA + reg I
  float Qux[NX][NX];
  float Luu[NX][NX];
  float Pxx[NX][NX];   // RESET: phixx of the source node
  float W[NX][NW];     // elimination tableau
  float Sol[NX][25];   // Quu^-1 [Qux | Qu]
  float G[NX], Gn[NX], Qx[NX], Qu[NX], Lx[NX], Lu[NX], Px[NX], fac[NX];
  float dnext[NX];
};

// n floats from device memory into shared memory, the block's threads on
// consecutive addresses
__device__ __forceinline__ void load(float* dst,
                                     const float* __restrict__ src, int n,
                                     int tid) {
  for (int e = tid; e < n; e += NT) dst[e] = src[e];
}

__global__ void __launch_bounds__(NT)
riccati_dense_kernel(const int* __restrict__ kind,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ lxx,
                     const float* __restrict__ luu,
                     const float* __restrict__ lx,
                     const float* __restrict__ lu,
                     const float* __restrict__ defect,
                     const float* __restrict__ phix,
                     const float* __restrict__ phixx,
                     const float* __restrict__ reg,
                     const int* __restrict__ last_node,
                     float* __restrict__ dU, float* __restrict__ K,
                     float* __restrict__ dv1_out, float* __restrict__ dv2_out,
                     unsigned char* __restrict__ ok_out, int T) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t Tn = (size_t)T + 1;
  constexpr size_t M = NX * NX;

  const int* kind_b = kind + b * T;
  const float* def_b = defect + b * Tn * NX;
  const float* phix_b = phix + b * Tn * NX;
  const float* phixx_b = phixx + b * Tn * M;
  const float reg_b = reg[b];
  const size_t last = (size_t)last_node[b];

  float dv1 = 0.f, dv2 = 0.f;   // meaningful in thread 0
  bool okb = true;

  // seed: the terminal partials of the last active node
  load(&s.H[0][0], phixx_b + last * M, (int)M, tid);
  load(s.G, phix_b + last * NX, NX, tid);

  for (int t = T - 1; t >= 0; --t) {
    const int kd = kind_b[t];
    const size_t bt = b * T + t;
    float* K_bt = K + bt * M;
    float* dU_bt = dU + bt * NX;
    if (kd != KIND_DYN && kd != KIND_RESET) {   // PAD: the value carries
      for (int e = tid; e < (int)M; e += NT) K_bt[e] = 0.f;
      for (int i = tid; i < NX; i += NT) dU_bt[i] = 0.f;
      continue;
    }
    // the previous step ended synchronized: every tile below is free
    load(s.dnext, def_b + (size_t)(t + 1) * NX, NX, tid);
    load(&s.A[0][0], A + bt * M, (int)M, tid);
    if (kd == KIND_DYN) {
      load(&s.B[0][0], B + bt * M, (int)M, tid);
      load(&s.Qxx[0][0], lxx + bt * M, (int)M, tid);
      load(&s.Luu[0][0], luu + bt * M, (int)M, tid);
      load(s.Lx, lx + bt * NX, NX, tid);
      load(s.Lu, lu + bt * NX, NX, tid);
    } else {
      load(s.Px, phix_b + (size_t)t * NX, NX, tid);
      load(&s.Pxx[0][0], phixx_b + (size_t)t * M, (int)M, tid);
    }
    __syncthreads();
    defect_correction(s, tid);
    __syncthreads();
    if (kd == KIND_DYN) {
      dyn_step(s, tid, reg_b, K_bt, dU_bt, dv1, dv2, okb);
    } else {
      for (int e = tid; e < (int)M; e += NT) K_bt[e] = 0.f;
      for (int i = tid; i < NX; i += NT) dU_bt[i] = 0.f;
      reset_step(s, tid);
    }
  }
  if (tid == 0) {
    dv1_out[b] = dv1;
    dv2_out[b] = dv2;
    ok_out[b] = okb ? 1 : 0;
  }
}

}  // namespace

extern "C" int riccati_dense_launch(
    const int* kind, const float* A, const float* B, const float* lxx,
    const float* luu, const float* lx, const float* lu, const float* defect,
    const float* phix, const float* phixx, const float* reg,
    const int* last_node, float* dU, float* K, float* dv1, float* dv2,
    unsigned char* ok, int batch, int T, void* stream) {
  if (batch <= 0 || T <= 0) return 0;
  riccati_dense_kernel<<<batch, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg, last_node, dU,
      K, dv1, dv2, ok, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* riccati_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
