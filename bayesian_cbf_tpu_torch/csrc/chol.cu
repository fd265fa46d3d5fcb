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
//   * `chol_core_kernel` (entry point `chol_linv_launch`) replaces
//     `_chol_linv_kernel` (batched_chol_with_inv, assembly="kernel"), the
//     cache refresh's L and L^{-1}.  One thread block per matrix, a
//     right-looking Cholesky one column at a time and a Gauss-Jordan
//     elimination that builds L^{-1} in the same column loop, with the TPU
//     kernel's pivot floor (L[j][j] = d * rsqrt(max(d, 1e-12))).  What
//     bounds it: the serial column recurrence (three block-wide barriers
//     per column, a trailing update with no register reuse, L^{-1}
//     accumulated in global memory).  The working matrix is in shared
//     memory up to n = 241, else in a global scratch.  It is to be rebuilt
//     on `factor` + `linv_rows` like the kernel above.

#include <cuda_runtime.h>

#include "chol_blocked.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block

__global__ void __launch_bounds__(kThreads)
chol_core_kernel(const float* __restrict__ K, int n,
                 float* __restrict__ a_scratch,  // (B, n, n) or null (smem)
                 float* __restrict__ X,          // (B, n, n): L^{-1}
                 float* __restrict__ L_out)      // (B, n, n)
{
    extern __shared__ float smem[];
    __shared__ float piv_s;
    const size_t nn = (size_t)n * n;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const float* Kb = K + b * nn;
    float* A = a_scratch ? a_scratch + b * nn : smem;
    float* Xb = X + b * nn;

    for (size_t t = tid; t < nn; t += nt) {
        A[t] = Kb[t];
        const int i = (int)(t / n), c = (int)(t % n);
        Xb[t] = (i == c) ? 1.0f : 0.0f;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
        if (tid == 0) {
            const float d = A[(size_t)j * n + j];
            const float s = rsqrtf(fmaxf(d, 1e-12f));
            piv_s = s;
            A[(size_t)j * n + j] = d * s;
        }
        __syncthreads();
        const float s = piv_s;
        // scale column j below the pivot, and row j of the inverse
        for (int i = j + 1 + tid; i < n; i += nt) A[(size_t)i * n + j] *= s;
        for (int c = tid; c <= j; c += nt) Xb[(size_t)j * n + c] *= s;
        __syncthreads();
        // trailing rank-1 update of the lower triangle, and elimination of
        // column j from the rows of the inverse below row j
        const int m = n - j - 1;
        const size_t mm = (size_t)m * m;
        for (size_t t = tid; t < mm; t += nt) {
            const int i = j + 1 + (int)(t / m);
            const int k = j + 1 + (int)(t % m);
            if (k <= i)
                A[(size_t)i * n + k] -= A[(size_t)i * n + j] * A[(size_t)k * n + j];
        }
        const size_t mx = (size_t)m * (j + 1);
        for (size_t t = tid; t < mx; t += nt) {
            const int i = j + 1 + (int)(t / (j + 1));
            const int c = (int)(t % (j + 1));
            Xb[(size_t)i * n + c] -= A[(size_t)i * n + j] * Xb[(size_t)j * n + c];
        }
        __syncthreads();
    }

    float* Lb = L_out + b * nn;
    for (size_t t = tid; t < nn; t += nt) {
        const int i = (int)(t / n), c = (int)(t % n);
        Lb[t] = (c <= i) ? A[t] : 0.0f;
    }
}

int launch_core(const float* K, int B, int n, float* a_scratch, float* X,
                float* L, cudaStream_t stream) {
    const size_t smem = (size_t)n * n * sizeof(float);
    const bool use_smem = smem <= (size_t)kMaxSmemBytes;
    if (use_smem) {
        cudaError_t err = cudaFuncSetAttribute(
            chol_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    chol_core_kernel<<<B, kThreads, use_smem ? smem : 0, stream>>>(
        K, n, use_smem ? nullptr : a_scratch, X, L);
    return (int)cudaGetLastError();
}

// One matrix of the batch, by its thread block; A is the working matrix's
// home.  W = chol_blocked::row_width(nb): 32 with 512 threads, 64 with 256.
// The block's pointers into the batch are formed where each stage needs
// them, not held in registers across the factor's diagonal blocks.
template <int W>
__device__ __forceinline__ void kinv_logdet_body(
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

template <int W, int THREADS>
__global__ void __launch_bounds__(THREADS)
kinv_logdet_kernel(const float* __restrict__ K, int n, int N, int nb,
                   int use_smem,
                   float* a_scratch,  // (B, N, N) or null (smem)
                   float* dinv,       // (B, N, nb) scratch, written and read
                   float* __restrict__ Kinv,    // (B, n, n)
                   float* __restrict__ logdet)  // (B,)
{
    extern __shared__ __align__(16) float kinv_smem[];
    // one inlined copy of the body per home of the working matrix, so that
    // the copy in shared memory addresses it as shared memory
    if (use_smem)
        kinv_logdet_body<W>(
            K, n, N, nb,
            kinv_smem + chol_blocked::small_bytes(nb) / sizeof(float),
            chol_blocked::stride(N), kinv_smem, dinv, Kinv, logdet);
    else
        kinv_logdet_body<W>(K, n, N, nb,
                            a_scratch + (size_t)blockIdx.x * N * N, N,
                            kinv_smem, dinv, Kinv, logdet);
}

__host__ inline size_t kinv_smem_bytes(int N, int nb) {
    return chol_blocked::small_bytes(nb) + chol_blocked::matrix_bytes(N);
}

template <int W, int THREADS>
int launch_kinv(const float* K, float* Kinv, float* logdet, float* dinv,
                float* a_scratch, int B, int n, int N, int nb, int use_smem,
                cudaStream_t stream) {
    const size_t smem =
        use_smem ? kinv_smem_bytes(N, nb) : chol_blocked::small_bytes(nb);
    cudaError_t err = cudaFuncSetAttribute(
        kinv_logdet_kernel<W, THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kinv_logdet_kernel<W, THREADS><<<B, THREADS, smem, stream>>>(
        K, n, N, nb, use_smem, use_smem ? nullptr : a_scratch, dinv, Kinv,
        logdet);
    return (int)cudaGetLastError();
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Whether a matrix of order n is factored in shared memory (1) or needs
// the (B, n, n) global scratch `a_scratch` (0).
int chol_uses_smem(int n) {
    return (size_t)n * n * sizeof(float) <= (size_t)kMaxSmemBytes ? 1 : 0;
}

// (L, L^{-1}) of a batch K (B, n, n), f32, contiguous.
int chol_linv_launch(const float* K, float* L, float* Linv, float* a_scratch,
                     int B, int n, void* stream) {
    return launch_core(K, B, n, a_scratch, Linv, L, (cudaStream_t)stream);
}

// Whether kinv_logdet_launch factors a padded order N at block nb in shared
// memory (1) or needs the (B, N, N) global scratch `a_scratch` (0).
int kinv_logdet_uses_smem(int N, int nb) {
    return kinv_smem_bytes(N, nb) <= (size_t)kMaxSmemBytes ? 1 : 0;
}

// (K^{-1} (B, n, n), logdet K (B,)) of a batch K (B, n, n), f32,
// contiguous; N = max(ceil(n / nb) nb, nb), nb a multiple of 4 up to 64.
// dinv: a (B, N, nb) scratch.
int kinv_logdet_launch(const float* K, float* Kinv, float* logdet,
                       float* dinv, float* a_scratch, int B, int n, int N,
                       int nb, void* stream) {
    if (nb < 4 || nb > chol_blocked::kMaxNb || nb % 4 != 0 || N % nb != 0 ||
        N < n || n < 1)
        return -1;
    const int use_smem = kinv_logdet_uses_smem(N, nb);
    if (nb <= 32)
        return launch_kinv<32, 512>(K, Kinv, logdet, dinv, a_scratch, B, n, N,
                                    nb, use_smem, (cudaStream_t)stream);
    return launch_kinv<64, 256>(K, Kinv, logdet, dinv, a_scratch, B, n, N, nb,
                                use_smem, (cudaStream_t)stream);
}

}  // extern "C"
