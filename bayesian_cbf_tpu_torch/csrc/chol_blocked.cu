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
// Same arithmetic as the TPU body, one block column at a time:
//   * the diagonal block D is factored by nb masked rank-1 steps over the
//     FULL nb x nb square: with s = rsqrt(max(D[i][i], 1e-12)), column i
//     (rows >= i) and row i (columns >= i) are scaled by s, columns > i of
//     every row get -= Lcol[r] * Lrow[c], and column i becomes Lcol (zero
//     above i).  The row is read directly rather than as the transposed
//     column, as the TPU kernel does, so the upper half of D is carried
//     along.  The inverse X (Gauss-Jordan) is built in the same loop;
//   * the panel below is Lp = P X^T and the trailing matrix
//     W -= Lp Lp^T (lower block triangle and full diagonal blocks: the
//     only entries the later steps read).
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

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block
constexpr int kMaxNb = 64;

__host__ __device__ inline int odd(int x) { return x | 1; }

__host__ inline size_t small_bytes(int nb) {
    return ((size_t)nb * odd(nb) + 3 * (size_t)nb) * sizeof(float);
}

__host__ inline size_t smem_bytes(int N, int nb) {
    return small_bytes(nb) + (size_t)N * odd(N) * sizeof(float);
}

__device__ inline float inv_sqrt_pivot(float d) {
    return rsqrtf(isnan(d) ? d : fmaxf(d, 1e-12f));
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
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int xs = odd(nb);
    float* X = smem;                       // (nb, xs) block inverse
    float* colbuf = X + nb * xs;           // (nb) column i of D
    float* rowbuf = colbuf + nb;           // (nb) row i of D
    float* xrow = rowbuf + nb;             // (nb) row i of X
    const int ld = use_smem ? odd(N) : N;
    float* A = use_smem ? xrow + nb : a_scratch + (size_t)b * N * N;
    const size_t NN = (size_t)N * N;
    const float* Kb = K + (size_t)b * n * n;
    float* Lb = L + b * NN;
    float* Db = Dinv + (size_t)b * N * nb;

    for (size_t t = tid; t < NN; t += nt) {
        const int r = (int)(t / N), c = (int)(t % N);
        A[(size_t)r * ld + c] = (r < n && c < n) ? Kb[(size_t)r * n + c]
                                                 : (r == c ? 1.0f : 0.0f);
        Lb[t] = 0.0f;
    }

    for (int o = 0; o < N; o += nb) {
        for (int t = tid; t < nb * nb; t += nt)
            X[(t / nb) * xs + t % nb] = (t / nb == t % nb) ? 1.0f : 0.0f;
        __syncthreads();
        // ---- factor the diagonal block and invert it
        for (int i = 0; i < nb; ++i) {
            const float s = inv_sqrt_pivot(A[(size_t)(o + i) * ld + o + i]);
            for (int k = tid; k < nb; k += nt) {
                colbuf[k] = A[(size_t)(o + k) * ld + o + i];
                rowbuf[k] = A[(size_t)(o + i) * ld + o + k];
                xrow[k] = X[i * xs + k];
            }
            __syncthreads();
            for (int t = tid; t < nb * nb; t += nt) {
                const int r = t / nb, c = t % nb;
                const float lcol = (r >= i) ? colbuf[r] * s : 0.0f;
                float* a = &A[(size_t)(o + r) * ld + o + c];
                if (c > i)
                    *a = *a - lcol * (rowbuf[c] * s);
                else if (c == i)
                    *a = lcol;
                float* x = &X[r * xs + c];
                if (r == i)
                    *x = xrow[c] * s;
                else if (r > i)
                    *x = *x - lcol * (xrow[c] * s);
            }
            __syncthreads();
        }
        for (int t = tid; t < nb * nb; t += nt) {
            const int r = t / nb, c = t % nb;
            if (c <= r)
                Lb[(size_t)(o + r) * N + o + c] = A[(size_t)(o + r) * ld + o + c];
            Db[(size_t)(o + r) * nb + c] = X[r * xs + c];
        }
        const int rows = N - o - nb;
        if (rows == 0) break;
        // ---- panel Lp = P X^T, into L
        for (int t = tid; t < rows * nb; t += nt) {
            const int r = o + nb + t / nb, c = t % nb;
            float acc = 0.0f;
            for (int k = 0; k <= c; ++k)
                acc = fmaf(A[(size_t)r * ld + o + k], X[c * xs + k], acc);
            Lb[(size_t)r * N + o + c] = acc;
        }
        __syncthreads();
        for (int t = tid; t < rows * nb; t += nt) {
            const int r = o + nb + t / nb, c = t % nb;
            A[(size_t)r * ld + o + c] = Lb[(size_t)r * N + o + c];
        }
        __syncthreads();
        // ---- trailing update W -= Lp Lp^T on the lower block triangle
        for (size_t t = tid; t < (size_t)rows * rows; t += nt) {
            const int r = o + nb + (int)(t / rows);
            const int c = o + nb + (int)(t % rows);
            if (c / nb > r / nb) continue;
            float acc = 0.0f;
            for (int k = 0; k < nb; ++k)
                acc = fmaf(A[(size_t)r * ld + o + k], A[(size_t)c * ld + o + k],
                           acc);
            float* a = &A[(size_t)r * ld + c];
            *a = *a - acc;
        }
        __syncthreads();
    }
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
