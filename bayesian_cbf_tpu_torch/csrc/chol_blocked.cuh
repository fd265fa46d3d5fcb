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
// kernels' matmuls run at Precision.HIGHEST, and every entry keeps one
// fixed chain of operations (k ascending), whatever thread computes it.
//
// How the work is laid out on a thread block (one matrix per block):
//   * diagonal block: one warp, lane l holding row l (rows l and l + 32
//     for nb > 32) of D and of X in registers; the pivot lane publishes
//     its scaled row through a double-buffered line of shared memory and
//     the warp meets at one `__syncwarp()` per pivot: no block-wide
//     barrier inside the pivot loop (see factor_diag);
//   * panel: a warp takes 128 rows x 4 columns (lane l rows l, l + 32,
//     ..., a 4 x 4 register tile per thread), so that the triangular
//     k-range is uniform over the warp; the tiles are written back in
//     place after one block-wide barrier: no staging through global
//     memory;
//   * trailing update: a warp takes 16 rows x 32 columns of the lower
//     block triangle, 4 x 4 register tiles with rows and columns
//     interleaved over the lanes;
//   * the working matrix's row stride is 4 (mod 8) floats when it lives in
//     shared memory: with nb a multiple of 4 the k-loops of panel and
//     trailing update read float4 (2 shared loads for 16 FMAs), and both
//     those loads and the tiles' read-modify-write fall in distinct banks;
//   * L's block column and Dinv's block are copied out once, lanes along
//     the row, from the working matrix; the blocks above the diagonal are
//     zeroed during the load.
#pragma once

#include <cuda_runtime.h>

namespace chol_blocked {

constexpr int kMaxNb = 64;

__host__ __device__ inline int odd(int x) { return x | 1; }

// Registers per row of the diagonal block: 32 for nb <= 32, else 64.
__host__ __device__ inline int row_width(int nb) { return nb <= 32 ? 32 : 64; }

// Shared memory of the block-step buffer: X (nb x odd(nb)).
__host__ __device__ inline size_t small_bytes(int nb) {
    return (2 * (size_t)row_width(nb) + (size_t)nb * odd(nb)) * sizeof(float);
}

// Row stride of the working matrix in shared memory: a multiple of 4
// floats (float4 loads along a row) whose quarter is odd (rows 0..7 then
// start in the 8 distinct 16-byte bank groups).
__host__ __device__ inline int stride(int N) {
    return 4 * (((N + 3) / 4) | 1);
}

// Shared memory of the working matrix at padded order N.
__host__ __device__ inline size_t matrix_bytes(int N) {
    return (size_t)N * stride(N) * sizeof(float);
}

__device__ inline float inv_sqrt_pivot(float d) {
    return rsqrtf(isnan(d) ? d : fmaxf(d, 1e-12f));
}

// Factor the nb x nb diagonal block at offset o and invert it, by the
// block's first warp (all 32 lanes must call, no other thread).  On return
// A's block holds L's lower triangle and X (nb x xs) its inverse.
//
// Lane l holds rows l + 32 h (h < W / 32) in registers, as one line of W
// values per row: at pivot i, v[0 .. nb-1-i] are columns i .. nb-1 of D,
// v[W-i .. W-1] are columns 0 .. i-1 of X, and what lies between is zero.
// A pivot shifts the line left by one: column i of D leaves as L's column,
// column i of X enters at the right.  So the loop over pivots indexes
// registers statically without being unrolled (unrolled, its straight-line
// code ran at the speed of instruction fetch), and D's dead columns and
// X's zero columns cost nothing: W - 1 updates per row and pivot.  The
// pivot lane scales its line by s = rsqrt(pivot) and publishes it in
// `stage` (two lines of W floats, s in front), so one `__syncwarp()` per
// pivot orders the line's write before its reads and the next write but
// one after them.  Rows at and above the pivot multiply the pivot row by
// zero: a non-finite pivot row spreads to the whole block, as the plain
// version marks a failed factorization as a whole.
template <int W>
__device__ __forceinline__ void factor_diag(float* A, int ld, int o, int nb,
                                            float* stage, float* X, int xs) {
    constexpr int H = W / 32;
    const int lane = threadIdx.x;
    float v[H][W];
    float* Ar[H];
    bool own[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
        const int r = lane + 32 * h;
        own[h] = r < nb;
        Ar[h] = A + (size_t)(o + (own[h] ? r : 0)) * ld + o;
#pragma unroll
        for (int k = 0; k < W; ++k)
            v[h][k] = (own[h] && k < nb) ? Ar[h][k] : 0.0f;
    }
#pragma unroll
    for (int hp = 0; hp < H; ++hp) {
#pragma unroll 1
        for (int il = 0; il < 32; ++il) {
            const int i = 32 * hp + il;
            if (i >= nb) break;
            float4* buf = reinterpret_cast<float4*>(stage + (i & 1) * W);
            if (lane == il) {
                const float s = inv_sqrt_pivot(v[hp][0]);
#pragma unroll
                for (int k = 1; k < W; ++k) v[hp][k] = v[hp][k] * s;
                buf[0] = make_float4(s, v[hp][1], v[hp][2], v[hp][3]);
#pragma unroll
                for (int k4 = 1; k4 < W / 4; ++k4)
                    buf[k4] = make_float4(v[hp][4 * k4], v[hp][4 * k4 + 1],
                                          v[hp][4 * k4 + 2],
                                          v[hp][4 * k4 + 3]);
            }
            __syncwarp();
            float t[W];
#pragma unroll
            for (int k4 = 0; k4 < W / 4; ++k4) {
                const float4 q = buf[k4];
                t[4 * k4] = q.x, t[4 * k4 + 1] = q.y, t[4 * k4 + 2] = q.z,
                       t[4 * k4 + 3] = q.w;
            }
            const float s = t[0];
            // m: the row's multiplier, zero for the rows at and above the
            // pivot (their line only shifts)
            float m[H];
#pragma unroll
            for (int h = 0; h < H; ++h) {
                const int r = lane + 32 * h;
                const float lcol = (r >= i) ? v[h][0] * s : 0.0f;
                if (own[h]) Ar[h][i] = lcol;
                m[h] = (r > i) ? lcol : 0.0f;
            }
#pragma unroll
            for (int k = 1; k < W; ++k) {
#pragma unroll
                for (int h = 0; h < H; ++h)
                    v[h][k - 1] = v[h][k] - m[h] * t[k];
            }
#pragma unroll
            for (int h = 0; h < H; ++h)
                v[h][W - 1] =
                    (lane + 32 * h == i) ? s : 0.0f - m[h] * s;
        }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
        if (!own[h]) continue;
        float* Xr = X + (lane + 32 * h) * xs;
#pragma unroll
        for (int k = 0; k < W; ++k)
            if (k >= W - nb) Xr[k - (W - nb)] = v[h][k];
    }
}

// acc[i][j] += sum over k0 <= k < k0 + 4 of av[i][k] * bv[j][k], k ascending.
__device__ __forceinline__ void fma4x4x4(const float4 (&av)[4],
                                         const float4 (&bv)[4],
                                         float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
}

// Panel Lp = P X^T below the diagonal block at o, in place in A.  A warp
// takes 128 rows x 4 columns c0..c0+3 (entry (r, c) sums k = 0..c); VEC:
// nb and ld multiples of 4, A 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void panel(float* A, int ld, int o, int nb, int N,
                                      const float* X, int xs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int tc = (nb + 3) >> 2;
    const int base = o + nb;
    const int nchunk = (N - base + 127) >> 7;
    const int nwt = nchunk * tc;
    // column tiles in descending order: a pass overwrites only columns
    // that no later pass reads
    for (int wt0 = 0; wt0 < nwt; wt0 += nwarps) {
        const int wt = wt0 + warp;
        const bool work = wt < nwt;
        const int tjr = wt / nchunk, chunk = wt - tjr * nchunk;
        const int c0 = 4 * (tc - 1 - tjr);
        const int r0 = base + 128 * chunk + lane;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        if (work) {
            const float* ar[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ar[i] = A + (size_t)min(r0 + 32 * i, N - 1) * ld + o;
            if constexpr (VEC) {
                for (int k0 = 0; k0 < c0; k0 += 4) {
                    float4 av[4], xv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        av[i] = *reinterpret_cast<const float4*>(ar[i] + k0);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float* xr = X + (c0 + j) * xs + k0;
                        xv[j] = make_float4(xr[0], xr[1], xr[2], xr[3]);
                    }
                    fma4x4x4(av, xv, acc);
                }
                float av[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float4 t =
                        *reinterpret_cast<const float4*>(ar[i] + c0);
                    av[i][0] = t.x, av[i][1] = t.y, av[i][2] = t.z,
                    av[i][3] = t.w;
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int kk = 0; kk <= j; ++kk) {
                        const float xv = X[(c0 + j) * xs + c0 + kk];
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            acc[i][j] = fmaf(av[i][kk], xv, acc[i][j]);
                    }
            } else {
                const int kmax = min(nb - 1, c0 + 3);
                for (int k = 0; k <= kmax; ++k) {
                    float av[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) av[i] = ar[i][k];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int c = c0 + j;
                        if (c < nb && k <= c) {
                            const float xv = X[c * xs + k];
#pragma unroll
                            for (int i = 0; i < 4; ++i)
                                acc[i][j] = fmaf(av[i], xv, acc[i][j]);
                        }
                    }
                }
            }
        }
        __syncthreads();
        if (work) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = r0 + 32 * i;
                if (r >= N) continue;
                float* out = A + (size_t)r * ld + o + c0;
                if constexpr (VEC) {
                    *reinterpret_cast<float4*>(out) = make_float4(
                        acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (c0 + j < nb) out[j] = acc[i][j];
                }
            }
        }
    }
    __syncthreads();
}

// Trailing update W -= Lp Lp^T on the lower block triangle (full diagonal
// blocks) below and right of the block column at o.  A warp takes 16 rows
// x 32 columns of one block; lane (ti, tj) = (lane / 8, lane % 8) owns
// rows 2 ti + {0, 1, 8, 9} and columns tj + {0, 8, 16, 24} of it.  VEC as
// for the panel.
template <bool VEC>
__device__ __forceinline__ void trailing(float* A, int ld, int o, int nb,
                                         int N) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int base = o + nb;
    const int m = (N - base) / nb;
    const int wtr = (nb + 15) >> 4, wtc = (nb + 31) >> 5;
    const int wtpb = wtr * wtc;
    const int total = (m * (m + 1) / 2) * wtpb;
    const int ti = lane >> 3, tj = lane & 7;
    for (int wq = warp; wq < total; wq += nwarps) {
        const int p = wq / wtpb, w = wq - p * wtpb;
        const int wr = w / wtc, wc = w - wr * wtc;
        int bi = (int)((sqrtf(8.0f * (float)p + 1.0f) - 1.0f) * 0.5f);
        while (bi * (bi + 1) / 2 > p) --bi;
        while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
        const int bj = p - bi * (bi + 1) / 2;
        const int R0 = base + bi * nb, C0 = base + bj * nb;
        int ri[4], cj[4];
        bool rv[4], cv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int rl = 16 * wr + 2 * ti + (e & 1) + 8 * (e >> 1);
            const int cl = 32 * wc + tj + 8 * e;
            rv[e] = rl < nb;
            cv[e] = cl < nb;
            ri[e] = R0 + min(rl, nb - 1);
            cj[e] = C0 + min(cl, nb - 1);
        }
        const float* ar[4];
        const float* ac[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            ar[e] = A + (size_t)ri[e] * ld + o;
            ac[e] = A + (size_t)cj[e] * ld + o;
        }
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        if constexpr (VEC) {
#pragma unroll 2
            for (int k0 = 0; k0 < nb; k0 += 4) {
                float4 av[4], bv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    av[e] = *reinterpret_cast<const float4*>(ar[e] + k0);
                    bv[e] = *reinterpret_cast<const float4*>(ac[e] + k0);
                }
                fma4x4x4(av, bv, acc);
            }
        } else {
#pragma unroll 4
            for (int k = 0; k < nb; ++k) {
                float av[4], bv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    av[e] = ar[e][k];
                    bv[e] = ac[e][k];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (rv[i] && cv[j]) {
                    float* a = A + (size_t)ri[i] * ld + cj[j];
                    *a = *a - acc[i][j];
                }
    }
}

// Factor one matrix with the whole thread block (blockDim.x a multiple of
// 32; W = row_width(nb)).  Kb: the input (n x n); A: the working
// matrix (N x N, row stride ld), in shared memory or a global scratch;
// small: small_bytes(nb) of shared memory, 16-byte aligned; Lb (N x N) and
// Db (N x nb): the outputs.  On return A's diagonal blocks and the panels
// below them hold L as well, and every write is visible to the block.
// Inlined into each caller, once per home of A: a call whose A is derived
// from the kernel's shared array addresses it as shared memory, which the
// tiles' loads need (through a pointer that may be either, panel and
// trailing update took a third longer).
template <int W>
__device__ __forceinline__ void factor(const float* __restrict__ Kb, int n,
                                       int N, int nb, float* A, int ld,
                                       float* small, float* __restrict__ Lb,
                                       float* __restrict__ Db) {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const int xs = odd(nb);
    float* stage = small;      // two lines of W floats
    float* X = small + 2 * W;  // (nb, xs) block inverse

    const bool vec = (nb & 3) == 0 && (ld & 3) == 0;

    // ---- load the lower block triangle; zero L above the diagonal blocks
    // (two rows and 256 columns, 16 loads, in flight per lane)
    for (int r0 = warp; r0 < N; r0 += 2 * nwarps) {
        for (int c0 = lane; c0 < N; c0 += 256) {
            float v[2][8];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int r = r0 + q * nwarps;
                const int end = (r / nb + 1) * nb;
                const float* Kr = Kb + (size_t)r * n;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int c = c0 + 32 * u;
                    v[q][u] = (r < n && c < n && c < end)
                                  ? Kr[c] : (r == c ? 1.0f : 0.0f);
                }
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int r = r0 + q * nwarps;
                if (r >= N) continue;
                const int end = (r / nb + 1) * nb;
                float* Ar = A + (size_t)r * ld;
                float* Lr = Lb + (size_t)r * N;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int c = c0 + 32 * u;
                    if (c < end)
                        Ar[c] = v[q][u];
                    else if (c < N)
                        Lr[c] = 0.0f;
                }
            }
        }
    }
    __syncthreads();

    for (int o = 0; o < N; o += nb) {
        // ---- factor the diagonal block and invert it
        if (tid < 32) factor_diag<W>(A, ld, o, nb, stage, X, xs);
        __syncthreads();
        const bool more = o + nb < N;

        // ---- panel Lp = P X^T, in place
        if (more) {
            if (vec)
                panel<true>(A, ld, o, nb, N, X, xs);
            else
                panel<false>(A, ld, o, nb, N, X, xs);
        }

        // ---- L's block column and Dinv's block, lanes along the row
        for (int r0 = o + warp; r0 < N; r0 += 4 * nwarps) {
            for (int c = lane; c < nb; c += 32) {
                float v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int r = r0 + u * nwarps;
                    v[u] = (r < N && !(r - o < nb && c > r - o))
                               ? A[(size_t)r * ld + o + c] : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int r = r0 + u * nwarps;
                    if (r < N) Lb[(size_t)r * N + o + c] = v[u];
                    if (r - o < nb)
                        Db[(size_t)r * nb + c] = X[(r - o) * xs + c];
                }
            }
        }

        // ---- trailing update W -= Lp Lp^T on the lower block triangle
        if (more) {
            if (vec)
                trailing<true>(A, ld, o, nb, N);
            else
                trailing<false>(A, ld, o, nb, N);
        }
        __syncthreads();
    }
}

}  // namespace chol_blocked
