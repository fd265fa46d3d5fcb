// Batched blocked Cholesky with diagonal-block inverses, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/pallas_chol.py
// `_chol_kernel` (called by `_batched_chol_with_inv_jit`, the "row"/"col"
// assemblies of `batched_chol_with_inv`), with its block step
// `_factor_block`.  For K (n x n), padded with an identity tail to N (a
// multiple of nb), it writes L (N x N, zero above the diagonal) and Dinv
// (N x nb), the stack of the inverses of L's nb x nb diagonal blocks.
// L^{-1} is assembled from them outside the kernel, with matmuls, as the
// JAX package leaves it to XLA.
//
// The block step is `chol_blocked::factor` (chol_blocked.cuh), shared
// with the factor-and-solve kernel (csrc/cholsolve.cu).
//
// What bounds it on the H100: the serial pivot chain (two block-wide
// barriers per pivot, N pivots) and one thread block per matrix.  The
// design keeps the whole working matrix in shared memory when it fits
// (N <= 236 in f32, which covers the main path's N = 224 for n = 200 and
// N = 64 for n = 50 at nb = 32), with odd row strides for the matrix and
// X so that column walks hit distinct banks; larger N work in a global
// scratch that the caller allocates.  Every product accumulates in f32
// with FMA (no TF32), as the TPU kernel's matmuls run at
// Precision.HIGHEST.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

using chol_blocked::kMaxNb;
using chol_blocked::odd;
using chol_blocked::small_bytes;

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block

__host__ inline size_t smem_bytes(int N, int nb) {
    return small_bytes(nb) + chol_blocked::matrix_bytes(N);
}

__global__ void __launch_bounds__(kThreads)
chol_dinv_kernel(const float* __restrict__ K, int n, int N, int nb,
                 int use_smem,
                 float* __restrict__ a_scratch,  // (B, N, N) or null (smem)
                 float* __restrict__ L,          // (B, N, N)
                 float* __restrict__ Dinv)       // (B, N, nb)
{
    extern __shared__ float smem[];
    const int b = blockIdx.x;
    const int ld = use_smem ? odd(N) : N;
    float* A = use_smem ? smem + small_bytes(nb) / sizeof(float)
                        : a_scratch + (size_t)b * N * N;
    chol_blocked::factor(K + (size_t)b * n * n, n, N, nb, A, ld, smem,
                         L + (size_t)b * N * N, Dinv + (size_t)b * N * nb);
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Whether a padded order N at block nb is factored in shared memory (1)
// or needs the (B, N, N) global scratch `a_scratch` (0).
int chol_dinv_uses_smem(int N, int nb) {
    return smem_bytes(N, nb) <= (size_t)kMaxSmemBytes ? 1 : 0;
}

// L (B, N, N) and Dinv (B, N, nb) of a batch K (B, n, n), f32,
// contiguous; N = max(ceil(n / nb) nb, nb), 1 <= nb <= 64.
int chol_dinv_launch(const float* K, float* L, float* Dinv, float* a_scratch,
                     int B, int n, int N, int nb, void* stream) {
    if (nb < 1 || nb > kMaxNb || N % nb != 0 || N < n) return -1;
    const int use_smem = chol_dinv_uses_smem(N, nb);
    const size_t smem = use_smem ? smem_bytes(N, nb) : small_bytes(nb);
    cudaError_t err = cudaFuncSetAttribute(
        chol_dinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_dinv_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        K, n, N, nb, use_smem, use_smem ? nullptr : a_scratch, L, Dinv);
    return (int)cudaGetLastError();
}

}  // extern "C"
