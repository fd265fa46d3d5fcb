// Device-side blocked Cholesky with diagonal-block inverses, shared by
// csrc/chol_blocked.cu (factor only) and csrc/cholsolve.cu (factor, solve
// and logdet).
//
// The arithmetic of the Pallas TPU kernels' block step `_factor_block`
// (bayesian_cbf_tpu/ops/pallas_chol.py), one block column at a time:
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
// Every product accumulates in f32 with FMA (no TF32), as the TPU
// kernels' matmuls run at Precision.HIGHEST.
#pragma once

#include <cuda_runtime.h>

namespace chol_blocked {

constexpr int kMaxNb = 64;

__host__ __device__ inline int odd(int x) { return x | 1; }

// Shared memory of the block-step buffers: X (nb x odd(nb)) and three
// nb-vectors.
__host__ __device__ inline size_t small_bytes(int nb) {
    return ((size_t)nb * odd(nb) + 3 * (size_t)nb) * sizeof(float);
}

// Shared memory of the working matrix at padded order N.
__host__ __device__ inline size_t matrix_bytes(int N) {
    return (size_t)N * odd(N) * sizeof(float);
}

__device__ inline float inv_sqrt_pivot(float d) {
    return rsqrtf(isnan(d) ? d : fmaxf(d, 1e-12f));
}

// Factor one matrix with the whole thread block.  Kb: the input (n x n);
// A: the working matrix (N x N, row stride ld), in shared memory or a
// global scratch; small: small_bytes(nb) of shared memory; Lb (N x N) and
// Db (N x nb): the outputs.  On return A's panels (below the diagonal
// blocks) hold L as well, and every write is visible to the block.
__device__ inline void factor(const float* __restrict__ Kb, int n, int N,
                              int nb, float* A, int ld, float* small,
                              float* __restrict__ Lb,
                              float* __restrict__ Db) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int xs = odd(nb);
    float* X = small;                      // (nb, xs) block inverse
    float* colbuf = X + nb * xs;           // (nb) column i of D
    float* rowbuf = colbuf + nb;           // (nb) row i of D
    float* xrow = rowbuf + nb;             // (nb) row i of X
    const size_t NN = (size_t)N * N;

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
    __syncthreads();
}

}  // namespace chol_blocked
