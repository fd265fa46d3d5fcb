// Batched Cholesky kernels of the fit and of the cache refresh, for Hopper
// (sm_90a).  Two kernels, one per Pallas TPU kernel of
// bayesian_cbf_tpu/ops/pallas_chol.py that they replace:
//
//   * `kinv_logdet_kernel` (entry point `kinv_logdet_launch`) replaces
//     `_cholkinv_kernel` (batched_kinv_logdet_chol), the fit's inverse:
//     K^{-1} = L^{-T} L^{-1} and logdet K = 2 sum_i log max(L_ii, 1e-20)
//     of K (n x n) padded with an identity tail to N (a multiple of nb).
//     It is the TPU kernel's algorithm (`_factor_assemble` + one product)
//     on the device code of chol_blocked.cuh, one thread block per matrix:
//       1. `factor<W, false>`: the blocked factor of csrc/chol_blocked.cu
//          into the working matrix A (pivots floored at 1e-12, NaN passed
//          on); the diagonal blocks' inverses Dinv go to a global scratch
//          (they do not fit beside A in shared memory at N = 224), L is
//          not written out;
//       2. the logdet from A's diagonal, one fixed order of summation;
//       3. `linv_rows`: L^{-1} in place over L by block rows,
//          L^{-1}[r, :r] = -Dinv_r (L[r, :r] L^{-1}[:r, :r]): no second
//          N x N matrix exists anywhere;
//       4. `gram_of_rows`: the lower triangle of L^{-T} L^{-1}, written to
//          both halves of the (n x n) output.
//     Every product accumulates in f32 with FMA on register tiles (no
//     TF32), as the TPU kernel's matmuls run at Precision.HIGHEST.
//     What bounds it on the H100: one thread block per matrix and per SM
//     (A takes 204 KB of shared memory at N = 224, which covers the main
//     path's n = 200, and N = 64 for n = 50; larger N work in a global
//     scratch that the caller allocates, one inlined copy of the body per
//     home so that shared memory is addressed as such), so a batch of 256
//     takes two waves; within a matrix the factor's serial pivot chain
//     (see chol_blocked.cu), then stages 3 and 4, n^3/3 multiply-adds
//     each, which at 7 block rows have fewer tiles than the block has
//     warps in the early rows and pay two to four barriers per block row.
//
//   * `chol_linv_kernel` (entry point `chol_linv_launch`) replaces
//     `_chol_linv_kernel` (batched_chol_with_inv, assembly="kernel"), the
//     cache refresh's L and L^{-1}.  The TPU kernel is `_factor_assemble`
//     with L written on the way; here it is the launch above with the
//     product replaced by two copy-outs:
//       1. `factor<W, false>` as above (Dinv to the global scratch);
//       2. L's lower triangle copied out of A to L (n x n), zero above the
//          diagonal (the factor leaves the upper part of a diagonal block
//          of A unspecified), lanes along the row;
//       3. `linv_rows`, in place over L;
//       4. the lower triangle of A, now L^{-1}, copied out likewise.
//     What bounds it: as above, one block per matrix and two waves, the
//     factor's pivot chain and the barriers of stage 3; the copy-outs are
//     two thirds of the bytes the function must move (its bound is bytes)
//     and a tenth of its time.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block

// The leading n x n of A's lower triangle to `out` (n x n, row stride n),
// zero above the diagonal: a warp per row, lanes along it.  Nothing here
// synchronises: the caller makes A visible to the block first.
__device__ __forceinline__ void store_lower(const float* A, int ld, int n,
                                            float* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int r = warp; r < n; r += nwarps) {
        const float* Ar = A + (size_t)r * ld;
        float* o = out + (size_t)r * n;
        for (int c = lane; c < n; c += 32) o[c] = c <= r ? Ar[c] : 0.0f;
    }
}

// The two bodies: what a thread block does with its matrix of the batch.
// A is the working matrix's home, W = chol_blocked::row_width(nb): 32 with
// 512 threads, 64 with 256.  The block's pointers into the batch are
// formed where each stage needs them, not held in registers across the
// factor's diagonal blocks.

// The fit inverse: out0 = K^{-1} (B, n, n), out1 = logdet K (B,).
struct KinvLogdet {
    template <int W>
    static __device__ __forceinline__ void run(
        const float* __restrict__ K, int n, int N, int nb, float* A, int ld,
        float* small, float* dinv, float* __restrict__ Kinv,
        float* __restrict__ logdet) {
        const size_t b = blockIdx.x;
        chol_blocked::factor<W, false>(K + b * n * n, n, N, nb, A, ld, small,
                                       nullptr, dinv + b * N * nb);
        if (threadIdx.x < 32) {
            const float ld2 = chol_blocked::logdet_of_diag(A, ld, n);
            if (threadIdx.x == 0) logdet[b] = ld2;
        }
        __syncthreads();  // the diagonal is read before L^{-1} overwrites it
        chol_blocked::linv_rows(A, ld, dinv + b * N * nb, N, nb, small);
        chol_blocked::gram_of_rows(A, ld, n, Kinv + b * n * n);
    }
};

// The refresh factorization: out0 = L, out1 = L^{-1}, (B, n, n) each: the
// factor, L out, L^{-1} in place over L, L^{-1} out.
struct CholLinv {
    template <int W>
    static __device__ __forceinline__ void run(
        const float* __restrict__ K, int n, int N, int nb, float* A, int ld,
        float* small, float* dinv, float* __restrict__ L,
        float* __restrict__ Linv) {
        const size_t b = blockIdx.x;
        chol_blocked::factor<W, false>(K + b * n * n, n, N, nb, A, ld, small,
                                       nullptr, dinv + b * N * nb);
        store_lower(A, ld, n, L + b * n * n);
        __syncthreads();  // L is read before L^{-1} overwrites it
        const float* D = dinv + b * N * nb;
        chol_blocked::linv_rows(A, ld, D, N, nb, small);
        store_lower(A, ld, n, Linv + b * n * n);
    }
};

// One inlined copy of Body per home of the working matrix, so that the
// copy in shared memory addresses it as shared memory.
template <class Body, int W>
__device__ __forceinline__ void at_home(
    const float* __restrict__ K, int n, int N, int nb, int use_smem,
    float* a_scratch, float* dinv, float* __restrict__ out0,
    float* __restrict__ out1) {
    extern __shared__ __align__(16) float smem[];
    if (use_smem)
        Body::template run<W>(
            K, n, N, nb, smem + chol_blocked::small_bytes(nb) / sizeof(float),
            chol_blocked::stride(N), smem, dinv, out0, out1);
    else
        Body::template run<W>(K, n, N, nb,
                              a_scratch + (size_t)blockIdx.x * N * N, N, smem,
                              dinv, out0, out1);
}

// Both kernels: K (B, n, n); a_scratch (B, N, N) or null (shared memory);
// dinv a (B, N, nb) scratch, written and read; the body's two outputs.
#define BLOCKED_KERNEL_ARGS                                               \
    const float *__restrict__ K, int n, int N, int nb, int use_smem,      \
        float *a_scratch, float *dinv, float *__restrict__ out0,          \
        float *__restrict__ out1

template <int W, int THREADS>
__global__ void __launch_bounds__(THREADS)
kinv_logdet_kernel(BLOCKED_KERNEL_ARGS) {
    at_home<KinvLogdet, W>(K, n, N, nb, use_smem, a_scratch, dinv, out0, out1);
}

template <int W, int THREADS>
__global__ void __launch_bounds__(THREADS)
chol_linv_kernel(BLOCKED_KERNEL_ARGS) {
    at_home<CholLinv, W>(K, n, N, nb, use_smem, a_scratch, dinv, out0, out1);
}

using BlockedKernel = void (*)(BLOCKED_KERNEL_ARGS);

__host__ inline size_t matrix_smem_bytes(int N, int nb) {
    return chol_blocked::small_bytes(nb) + chol_blocked::matrix_bytes(N);
}

bool matrix_in_smem(int N, int nb) {
    return matrix_smem_bytes(N, nb) <= (size_t)kMaxSmemBytes;
}

// One thread block per matrix: `wide` (W = 32, 512 threads) up to nb = 32,
// `narrow` (W = 64, 256 threads) beyond.  -1 unless (n, N, nb) is a padded
// order and block size that the blocked kernels take.
int launch(BlockedKernel wide, BlockedKernel narrow, const float* K,
           float* out0, float* out1, float* dinv, float* a_scratch, int B,
           int n, int N, int nb, void* stream) {
    if (!(nb >= 4 && nb <= chol_blocked::kMaxNb && nb % 4 == 0 &&
          N % nb == 0 && N >= n && n >= 1))
        return -1;
    const int use_smem = matrix_in_smem(N, nb);
    const BlockedKernel kernel = nb <= 32 ? wide : narrow;
    const int threads = nb <= 32 ? 512 : 256;
    const size_t smem =
        use_smem ? matrix_smem_bytes(N, nb) : chol_blocked::small_bytes(nb);
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        K, n, N, nb, use_smem, use_smem ? nullptr : a_scratch, dinv, out0,
        out1);
    return (int)cudaGetLastError();
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Whether the launches below factor a padded order N at block nb in shared
// memory (1) or need the (B, N, N) global scratch `a_scratch` (0).
int chol_matrix_in_smem(int N, int nb) { return matrix_in_smem(N, nb); }

// (L, L^{-1}) (B, n, n) each, exactly lower triangular, of a batch
// K (B, n, n), f32, contiguous; N, nb and dinv as for kinv_logdet_launch
// below.
int chol_linv_launch(const float* K, float* L, float* Linv, float* dinv,
                     float* a_scratch, int B, int n, int N, int nb,
                     void* stream) {
    return launch(chol_linv_kernel<32, 512>, chol_linv_kernel<64, 256>, K, L,
                  Linv, dinv, a_scratch, B, n, N, nb, stream);
}

// (K^{-1} (B, n, n), logdet K (B,)) of a batch K (B, n, n), f32,
// contiguous; N = max(ceil(n / nb) nb, nb), nb a multiple of 4 up to 64.
// dinv: a (B, N, nb) scratch.
int kinv_logdet_launch(const float* K, float* Kinv, float* logdet,
                       float* dinv, float* a_scratch, int B, int n, int N,
                       int nb, void* stream) {
    return launch(kinv_logdet_kernel<32, 512>, kinv_logdet_kernel<64, 256>, K,
                  Kinv, logdet, dinv, a_scratch, B, n, N, nb, stream);
}

}  // extern "C"
