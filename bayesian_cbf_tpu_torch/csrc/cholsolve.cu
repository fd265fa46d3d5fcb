// Batched blocked Cholesky solve for Hopper (sm_90a): factor + solve +
// logdet, and the solve against a saved factor.
//
// Replaces two Pallas TPU kernels of bayesian_cbf_tpu/ops/pallas_chol.py:
//   * `_cholsolve_kernel` (batched_cholsolve_logdet): for K (n x n) padded
//     with an identity tail to N (a multiple of nb) and a right-hand side
//     RHS (n x r), the blocked factor L (N x N) with the inverses of its
//     diagonal blocks Dinv (N x nb) -- the same arrays as
//     csrc/chol_blocked.cu, from the same device code
//     (chol_blocked::factor) -- then the two block sweeps
//         forward   y_j = Dinv_j (b_j - sum_{k<j} L_jk y_k)
//         backward  x_j = Dinv_j^T (y_j - sum_{k>j} L_kj^T x_k)
//     and logdet K = 2 sum_i log max(L_ii, 1e-20);
//   * `_solve_with_factor_kernel` (batched_solve_with_factor): the same
//     two sweeps against a saved (L, Dinv).
// The identity padding is not stored: the RHS rows n..N-1 are zero in the
// kernel's working copy, and only rows < n are written out.
//
// Mapping: one thread block per matrix.  The working RHS (N x r) lives in
// shared memory beside an (nb x r) block buffer; the factor's working
// matrix joins them there when all fit in the 227 KB a block may use
// (N = 224 at r = 16: 219 KB), else it works in a global scratch the
// caller allocates, as does an RHS too large for shared memory
// (N x r > ~57k floats).  A sweep step reads one block row (forward) or
// block column (backward) of L per block of the solution: L is read once
// per sweep, the RHS from shared memory.
//
// What bounds it on the H100: the factor's serial pivot chain (two
// block-wide barriers per pivot, N pivots), then 2 N / nb sweep steps of
// two barriers each; one block per matrix.  The solve against a saved
// factor reads L (N^2 floats) once and is bound by those bytes at large
// batch.

#include <cuda_runtime.h>
#include <math.h>

#include "chol_blocked.cuh"

namespace {

using chol_blocked::kMaxNb;
using chol_blocked::odd;
using chol_blocked::small_bytes;

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block
constexpr int kMaxR = 64;
constexpr int kMaxN = 1024;

// Which working arrays live in shared memory: bit 1 the RHS (N x r), bit
// 0 the factor's working matrix (only with the RHS there too).
__host__ inline int plan(int N, int nb, int r, int factor) {
    const size_t base = (size_t)nb * r * sizeof(float)
                        + (factor ? small_bytes(nb) : 0);
    const size_t rhs = (size_t)N * r * sizeof(float);
    if (base + rhs > (size_t)kMaxSmemBytes) return 0;
    if (factor && base + rhs + chol_blocked::matrix_bytes(N)
                      <= (size_t)kMaxSmemBytes)
        return 3;
    return 2;
}

__host__ inline size_t smem_bytes(int N, int nb, int r, int factor, int p) {
    size_t s = (size_t)nb * r * sizeof(float);
    if (factor) s += small_bytes(nb);
    if (p & 2) s += (size_t)N * r * sizeof(float);
    if (p & 1) s += chol_blocked::matrix_bytes(N);
    return s;
}

// Copy RHS rows < n into the working X (N x r), zero rows n..N-1.
__device__ inline void load_rhs(const float* __restrict__ R, int n, int N,
                                int r, float* X) {
    for (int t = threadIdx.x; t < N * r; t += blockDim.x)
        X[t] = (t / r < n) ? R[t] : 0.0f;
}

__device__ inline void store_sol(const float* X, int n, int r,
                                 float* __restrict__ S) {
    for (int t = threadIdx.x; t < n * r; t += blockDim.x) S[t] = X[t];
}

// Both sweeps in place on X (N x r); T is an (nb x r) buffer.  Lm: L with
// row stride ld (only its block panels below the diagonal blocks are
// read); D: Dinv (N x nb).  Neither is marked __restrict__: the factor
// kernel writes both earlier in the same launch, so they must not be read
// through the non-coherent read-only path.
__device__ inline void sweeps(const float* Lm, int ld, const float* D,
                              int N, int nb,
                              int r, float* X, float* T) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int nbr = nb * r;
    for (int o = 0; o < N; o += nb) {
        for (int t = tid; t < nbr; t += nt) {
            const int i = t / r, c = t % r;
            const float* Lrow = Lm + (size_t)(o + i) * ld;
            float acc = X[(o + i) * r + c];
            for (int k = 0; k < o; ++k)
                acc = fmaf(-Lrow[k], X[k * r + c], acc);
            T[t] = acc;
        }
        __syncthreads();
        for (int t = tid; t < nbr; t += nt) {
            const int i = t / r, c = t % r;
            const float* Drow = D + (size_t)(o + i) * nb;
            float acc = 0.0f;
            for (int k = 0; k <= i; ++k)
                acc = fmaf(Drow[k], T[k * r + c], acc);
            X[(o + i) * r + c] = acc;
        }
        __syncthreads();
    }
    for (int o = N - nb; o >= 0; o -= nb) {
        for (int t = tid; t < nbr; t += nt) {
            const int i = t / r, c = t % r;
            float acc = X[(o + i) * r + c];
            for (int k = o + nb; k < N; ++k)
                acc = fmaf(-Lm[(size_t)k * ld + o + i], X[k * r + c], acc);
            T[t] = acc;
        }
        __syncthreads();
        for (int t = tid; t < nbr; t += nt) {
            const int i = t / r, c = t % r;
            float acc = 0.0f;
            for (int k = i; k < nb; ++k)
                acc = fmaf(D[(size_t)(o + k) * nb + i], T[k * r + c], acc);
            X[(o + i) * r + c] = acc;
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads)
cholsolve_kernel(const float* __restrict__ K, const float* __restrict__ RHS,
                 int n, int N, int nb, int r, int p,
                 float* __restrict__ a_scratch,  // (B, N, N) unless p & 1
                 float* __restrict__ x_scratch,  // (B, N, r) unless p & 2
                 float* __restrict__ sol,        // (B, n, r)
                 float* __restrict__ L,          // (B, N, N)
                 float* __restrict__ Dinv,       // (B, N, nb)
                 float* __restrict__ logdet)     // (B,)
{
    extern __shared__ float smem[];
    const int b = blockIdx.x;
    float* small = smem;
    float* T = small + small_bytes(nb) / sizeof(float);
    float* X = (p & 2) ? T + nb * r : x_scratch + (size_t)b * N * r;
    float* A = (p & 1) ? X + (size_t)N * r : a_scratch + (size_t)b * N * N;
    const int ld = (p & 1) ? odd(N) : N;
    float* Lb = L + (size_t)b * N * N;
    float* Db = Dinv + (size_t)b * N * nb;

    load_rhs(RHS + (size_t)b * n * r, n, N, r, X);
    chol_blocked::factor(K + (size_t)b * n * n, n, N, nb, A, ld, small, Lb,
                         Db);
    if (threadIdx.x < 32) {
        float acc = 0.0f;
        for (int i = threadIdx.x; i < N; i += 32)
        {
            const float d = A[(size_t)i * ld + i];
            acc += logf(isnan(d) ? d : fmaxf(d, 1e-20f));
        }
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (threadIdx.x == 0) logdet[b] = 2.0f * acc;
    }
    sweeps(A, ld, Db, N, nb, r, X, T);
    store_sol(X, n, r, sol + (size_t)b * n * r);
}

__global__ void __launch_bounds__(kThreads)
solve_with_factor_kernel(const float* __restrict__ L,
                         const float* __restrict__ Dinv,
                         const float* __restrict__ RHS, int n, int N, int nb,
                         int r, int p,
                         float* __restrict__ x_scratch,  // unless p & 2
                         float* __restrict__ sol)
{
    extern __shared__ float smem[];
    const int b = blockIdx.x;
    float* T = smem;
    float* X = (p & 2) ? T + nb * r : x_scratch + (size_t)b * N * r;
    load_rhs(RHS + (size_t)b * n * r, n, N, r, X);
    __syncthreads();
    sweeps(L + (size_t)b * N * N, N, Dinv + (size_t)b * N * nb, N, nb, r, X,
           T);
    store_sol(X, n, r, sol + (size_t)b * n * r);
}

int check_shape(int n, int N, int nb, int r) {
    if (nb < 1 || nb > kMaxNb || N % nb != 0 || N < n || n < 1 ||
        N > kMaxN + kMaxNb || r < 1 || r > kMaxR)
        return -1;
    return 0;
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Which working arrays fit in shared memory (bit 1: the (N, r) RHS; bit
// 0: the factor's (N, N) matrix); a cleared bit means the caller passes a
// (B, N, r) or (B, N, N) global scratch.  factor = 1 for
// cholsolve_logdet_launch, 0 for solve_with_factor_launch.
int cholsolve_plan(int N, int nb, int r, int factor) {
    return plan(N, nb, r, factor);
}

// sol (B, n, r), L (B, N, N), Dinv (B, N, nb) and logdet (B,) of a batch K
// (B, n, n) and RHS (B, n, r), f32, contiguous; N = max(ceil(n / nb) nb,
// nb), 1 <= nb <= 64, 1 <= r <= 64.
int cholsolve_logdet_launch(const float* K, const float* RHS, float* sol,
                            float* L, float* Dinv, float* logdet,
                            float* a_scratch, float* x_scratch, int B, int n,
                            int N, int nb, int r, void* stream) {
    if (check_shape(n, N, nb, r)) return -1;
    const int p = plan(N, nb, r, 1);
    const size_t smem = smem_bytes(N, nb, r, 1, p);
    cudaError_t err = cudaFuncSetAttribute(
        cholsolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cholsolve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        K, RHS, n, N, nb, r, p, a_scratch, x_scratch, sol, L, Dinv, logdet);
    return (int)cudaGetLastError();
}

// sol (B, n, r) against a saved factor L (B, N, N), Dinv (B, N, nb) and
// RHS (B, n, r), f32, contiguous.
int solve_with_factor_launch(const float* L, const float* Dinv,
                             const float* RHS, float* sol, float* x_scratch,
                             int B, int n, int N, int nb, int r,
                             void* stream) {
    if (check_shape(n, N, nb, r)) return -1;
    const int p = plan(N, nb, r, 0);
    const size_t smem = smem_bytes(N, nb, r, 0, p);
    cudaError_t err = cudaFuncSetAttribute(
        solve_with_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    solve_with_factor_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        L, Dinv, RHS, n, N, nb, r, p, x_scratch, sol);
    return (int)cudaGetLastError();
}

}  // extern "C"
