// Batched Cholesky factor with explicit triangular inverse, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * bayesian_cbf_tpu/ops/pallas_chol.py `_cholkinv_kernel`
//     (batched_kinv_logdet_chol): K^{-1} = L^{-T} L^{-1} and logdet K,
//     entry point `kinv_logdet_launch`;
//   * bayesian_cbf_tpu/ops/pallas_chol.py `_chol_linv_kernel`
//     (batched_chol_with_inv, assembly="kernel"): L and L^{-1},
//     entry point `chol_linv_launch`.
//
// Both share one core: one thread block per matrix, a right-looking
// Cholesky one column at a time (the block synchronises per column), and
// a Gauss-Jordan elimination that builds L^{-1} in the same column loop.
// Semantics kept from the TPU kernel: the pivot is floored at 1e-12 before
// its reciprocal square root (L[j][j] = d * rsqrt(max(d, 1e-12))), and the
// log of each factor diagonal is floored at 1e-20.
//
// What bounds it on the H100: the serial column recurrence.  Each of the n
// columns costs three block-wide barriers, and the trailing update of a
// column is an O((n-j)^2) pass with little reuse.  The design keeps the
// working matrix in shared memory whenever it fits (n <= 241 in f32, which
// covers the main path's n = 50 and n = 200), so the trailing updates hit
// shared memory rather than L2; larger n work in a global scratch buffer
// that the caller allocates.  The inverse is accumulated in the output
// buffer (or a caller-allocated scratch), which stays L2-resident at the
// main-path sizes.  One block per matrix gives two waves at B = 256 on
// 132 SMs; splitting a matrix across blocks is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block

__global__ void __launch_bounds__(kThreads)
chol_core_kernel(const float* __restrict__ K, int n,
                 float* __restrict__ a_scratch,  // (B, n, n) or null (smem)
                 float* __restrict__ X,          // (B, n, n) inverse accumulator
                 float* __restrict__ L_out,      // (B, n, n) or null
                 float* __restrict__ Kinv_out,   // (B, n, n) or null
                 float* __restrict__ logdet_out) // (B,) or null
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

    if (L_out) {
        float* Lb = L_out + b * nn;
        for (size_t t = tid; t < nn; t += nt) {
            const int i = (int)(t / n), c = (int)(t % n);
            Lb[t] = (c <= i) ? A[t] : 0.0f;
        }
    }
    if (logdet_out && tid == 0) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j)
            acc += 2.0f * logf(fmaxf(A[(size_t)j * n + j], 1e-20f));
        logdet_out[b] = acc;
    }
    if (Kinv_out) {
        // Kinv = X^T X with X lower triangular:
        // Kinv[r][c] = sum_{i >= max(r, c)} X[i][r] X[i][c]
        float* Kb_out = Kinv_out + b * nn;
        for (size_t t = tid; t < nn; t += nt) {
            const int r = (int)(t / n), c = (int)(t % n);
            if (c > r) continue;
            float acc = 0.0f;
            for (int i = r; i < n; ++i)
                acc += Xb[(size_t)i * n + r] * Xb[(size_t)i * n + c];
            Kb_out[(size_t)r * n + c] = acc;
            Kb_out[(size_t)c * n + r] = acc;
        }
    }
}

int launch_core(const float* K, int B, int n, float* a_scratch, float* X,
                float* L, float* Kinv, float* logdet, cudaStream_t stream) {
    const size_t smem = (size_t)n * n * sizeof(float);
    const bool use_smem = smem <= (size_t)kMaxSmemBytes;
    if (use_smem) {
        cudaError_t err = cudaFuncSetAttribute(
            chol_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    chol_core_kernel<<<B, kThreads, use_smem ? smem : 0, stream>>>(
        K, n, use_smem ? nullptr : a_scratch, X, L, Kinv, logdet);
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
    return launch_core(K, B, n, a_scratch, Linv, L, nullptr, nullptr,
                       (cudaStream_t)stream);
}

// (K^{-1}, logdet K) of a batch K (B, n, n), f32, contiguous.  x_scratch
// (B, n, n) holds L^{-1}.
int kinv_logdet_launch(const float* K, float* Kinv, float* logdet,
                       float* x_scratch, float* a_scratch, int B, int n,
                       void* stream) {
    return launch_core(K, B, n, a_scratch, x_scratch, nullptr, Kinv, logdet,
                       (cudaStream_t)stream);
}

}  // extern "C"
