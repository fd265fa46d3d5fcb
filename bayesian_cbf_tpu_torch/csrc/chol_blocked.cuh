// Device-side blocked Cholesky with diagonal-block inverses, shared by
// csrc/chol_blocked.cu (factor only), csrc/cholsolve.cu (factor, solve
// and logdet) and csrc/chol.cu (factor, L^{-1} assembled in place over L,
// K^{-1} = L^{-T} L^{-1} and logdet: `linv_rows`, `gram_of_rows`,
// `logdet_of_diag` below).
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

// L's block column at o (zero above the diagonal) and Dinv's block, copied
// out of the working matrix and X, lanes along the row.
__device__ __forceinline__ void store_column(const float* A, int ld, int o,
                                             int nb, int N, const float* X,
                                             int xs, float* __restrict__ Lb,
                                             float* __restrict__ Db) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
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
// trailing update took a third longer).  STORE_L = false is for a caller
// that goes on working in A and returns no L: Lb is not written (pass
// null), and A's blocks above the diagonal blocks are zeroed instead, so
// that A is a whole N x N matrix whose lower block triangle holds L.
template <int W, bool STORE_L = true>
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
                float* Zr = STORE_L ? Lb + (size_t)r * N : Ar;
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int c = c0 + 32 * u;
                    if (c < end)
                        Ar[c] = v[q][u];
                    else if (c < N)
                        Zr[c] = 0.0f;
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

        // ---- L's block column and Dinv's block
        if constexpr (STORE_L) {
            store_column(A, ld, o, nb, N, X, xs, Lb, Db);
        } else {
            for (int t = tid; t < nb * nb; t += nt)
                Db[(size_t)o * nb + t] = X[(t / nb) * xs + t % nb];
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

// logdet K = 2 sum_{i < n} log max(L_ii, 1e-20) from the diagonal of the
// factored A, by the block's first warp (all 32 lanes call; lane 0 holds
// the result).  A NaN diagonal is passed on, and the sum has one fixed
// order: lane l adds rows l, l + 32, ..., then a shuffle tree.
__device__ __forceinline__ float logdet_of_diag(const float* A, int ld,
                                                int n) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += 32) {
        const float d = A[(size_t)i * ld + i];
        acc += logf(isnan(d) ? d : fmaxf(d, 1e-20f));
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
    return 2.0f * acc;
}

// row[j] += s * b.j
__device__ __forceinline__ void axpy4(float s, const float4& b,
                                      float (&row)[4]) {
    row[0] = fmaf(s, b.x, row[0]);
    row[1] = fmaf(s, b.y, row[1]);
    row[2] = fmaf(s, b.z, row[2]);
    row[3] = fmaf(s, b.w, row[3]);
}

// An 8 x 32 tile of a product P Q by one warp, on 2 x 4 register tiles:
// lane (ti, tj) = (lane / 8, lane % 8) owns rows 2 ti + {0, 1} and columns
// 4 tj .. 4 tj + 3.  p0, p1: the lane's two rows of P; q: Q's row 0 at the
// lane's first column, row stride ldq.  acc[i][j] += sum over k0 <= k < k1
// of P[i][k] Q[k][j], k ascending; k0, k1, ldq multiples of 4 and every
// pointer 16-byte aligned.  A k-step of 4 is 6 float4 loads for 32 FMAs:
// the loads of P are shared by the 8 lanes of a ti, those of Q run along
// one row.
__device__ __forceinline__ void product_tile(const float* p0, const float* p1,
                                             const float* q, int ldq, int k0,
                                             int k1, float (&acc)[2][4]) {
#pragma unroll 2
    for (int k = k0; k < k1; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(p0 + k);
        const float4 a1 = *reinterpret_cast<const float4*>(p1 + k);
        float4 b[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            b[kk] = *reinterpret_cast<const float4*>(
                q + (size_t)(k + kk) * ldq);
        axpy4(a0.x, b[0], acc[0]);
        axpy4(a0.y, b[1], acc[0]);
        axpy4(a0.z, b[2], acc[0]);
        axpy4(a0.w, b[3], acc[0]);
        axpy4(a1.x, b[0], acc[1]);
        axpy4(a1.y, b[1], acc[1]);
        axpy4(a1.z, b[2], acc[1]);
        axpy4(a1.w, b[3], acc[1]);
    }
}

// L^{-1} in place over L, by block rows (the "row" assembly of the TPU
// kernels' `_factor_assemble`), with the whole thread block.  On entry A
// (N x N, row stride ld) holds L in its lower block triangle and zeros
// above the diagonal blocks, as factor<W, false> leaves it, and D (N x nb)
// the diagonal blocks' inverses; on return A's lower triangle holds L^{-1}
// (zero above the diagonal inside the diagonal blocks too) and every write
// is visible to the block.  buf: nb x nb floats of shared memory, 16-byte
// aligned (the factor's `small` is large enough).  nb and ld multiples of
// 4, A 16-byte aligned.
//
// Block row r of L is read by step r only, and the rows above it already
// hold L^{-1}, so no second matrix exists:
//   T = L[r, :r] L^{-1}[:r, :r]    over L[r, :r]   (phase A)
//   L^{-1}[r, :r] = -Dinv_r T      over T          (phase B)
//   L^{-1}[r, r]  = Dinv_r.
// Both phases are products on `product_tile`s held in registers across one
// block-wide barrier, then stored.  When a phase has more tiles than the
// block has warps, it takes them in an order in which a pass overwrites
// nothing that a later pass reads: phase A by ascending columns (a tile at
// columns c.. reads L[r, k] for k >= c only, L^{-1} being lower
// triangular), phase B by descending rows (Dinv_r is lower triangular, so
// a tile reads the rows of T at and above its own).  D is not read through
// the read-only path: the factor wrote it in the same launch.
__device__ __forceinline__ void linv_rows(float* A, int ld, const float* D,
                                          int N, int nb, float* buf) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const int ti = lane >> 3, tj = lane & 7;
    const int nrt = (nb + 7) >> 3;
    for (int t = tid; t < nb * nb; t += nt)
        A[(size_t)(t / nb) * ld + t % nb] = D[t];
    __syncthreads();
    for (int R0 = nb; R0 < N; R0 += nb) {
        for (int t = tid; t < nb * nb; t += nt)
            buf[t] = D[(size_t)R0 * nb + t];
        const int nct = (R0 + 31) >> 5;
        const int ntile = nrt * nct;
        float* Ar = A + (size_t)R0 * ld;
        // ---- phase A: T = L[r, :r] Linv[:r, :r]
        for (int w0 = 0; w0 < ntile; w0 += nwarps) {
            const int idx = w0 + warp;
            const int ct = idx / nrt, rt = idx - ct * nrt;
            const int i0 = 8 * rt + 2 * ti, j0 = 32 * ct + 4 * tj;
            const bool own = idx < ntile && i0 < nb && j0 < R0;
            float acc[2][4] = {};
            if (idx < ntile) {
                const int ic = min(i0, nb - 2), jc = min(j0, R0 - 4);
                product_tile(Ar + (size_t)ic * ld, Ar + (size_t)(ic + 1) * ld,
                             A + jc, ld, 32 * ct, R0, acc);
            }
            __syncthreads();
            if (own) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    *reinterpret_cast<float4*>(Ar + (size_t)(i0 + i) * ld + j0)
                        = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                      acc[i][3]);
            }
        }
        __syncthreads();
        // ---- phase B: Linv[r, :r] = -Dinv_r T
        for (int w0 = 0; w0 < ntile; w0 += nwarps) {
            const int idx = w0 + warp;
            const int rt = nrt - 1 - idx / nct, ct = idx % nct;
            const int i0 = 8 * rt + 2 * ti, j0 = 32 * ct + 4 * tj;
            const bool own = idx < ntile && i0 < nb && j0 < R0;
            float acc[2][4] = {};
            if (idx < ntile) {
                const int ic = min(i0, nb - 2), jc = min(j0, R0 - 4);
                product_tile(buf + ic * nb, buf + (ic + 1) * nb, Ar + jc, ld,
                             0, min(nb, 8 * rt + 8), acc);
            }
            __syncthreads();
            if (own) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    *reinterpret_cast<float4*>(Ar + (size_t)(i0 + i) * ld + j0)
                        = make_float4(-acc[i][0], -acc[i][1], -acc[i][2],
                                      -acc[i][3]);
            }
        }
        for (int t = tid; t < nb * nb; t += nt)
            Ar[(size_t)(t / nb) * ld + R0 + t % nb] = buf[t];
        __syncthreads();
    }
}

// Kout (n x n, row stride n) = M^T M for the lower-triangular M in the
// leading n rows and columns of A (row stride ld, a multiple of 4; A
// 16-byte aligned; A has at least max(n, 4) rounded up to 4 columns):
// entry (i, j) sums M[k][i] M[k][j] over k >= max(i, j), k ascending.
// With M = L^{-1} this is K^{-1}; the rows below n of an identity-padded
// L^{-1} are zero in the first n columns and are skipped.
//
// The lower triangle is computed once and stored to both halves.  A warp
// takes 16 rows x 32 columns of it on 4 x 4 register tiles (lane (ti, tj)
// owns rows 4 ti .. and columns 4 tj ..): both operands of a k-step lie
// along row k of A, one float4 each for 16 FMAs.  The k-range of a tile
// starts at its first row, so the tiles are dealt to the warps in
// descending length, back and forth.  Nothing here synchronises: the
// caller makes A visible to the block first.
__device__ __forceinline__ void gram_of_rows(const float* A, int ld, int n,
                                             float* __restrict__ Kout) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int ti = lane >> 3, tj = lane & 7;
    // row tile rt (16 rows) meets the lower triangle in (rt >> 1) + 1
    // column tiles (32 columns)
    const int nrt = (n + 15) >> 4, half = nrt >> 1;
    const int total = (nrt & 1) ? (half + 1) * (half + 1) : half * (half + 1);
    const int last = 4 * ((max(n, 4) + 3) / 4) - 4;
    const bool vec = (n & 3) == 0;
    for (int w0 = 0, pass = 0; w0 < total; w0 += nwarps, ++pass) {
        const int idx = w0 + ((pass & 1) ? nwarps - 1 - warp : warp);
        if (idx >= total) continue;
        int rt = 0, base = 0;
        while (idx >= base + (rt >> 1) + 1) base += (rt >> 1) + 1, ++rt;
        const int ct = idx - base;
        const int i0 = 16 * rt + 4 * ti, j0 = 32 * ct + 4 * tj;
        const float* ai = A + min(i0, last);
        const float* aj = A + min(j0, last);
        float acc[4][4] = {};
#pragma unroll 4
        for (int k = 16 * rt; k < n; ++k) {
            const float4 a =
                *reinterpret_cast<const float4*>(ai + (size_t)k * ld);
            const float4 b =
                *reinterpret_cast<const float4*>(aj + (size_t)k * ld);
            axpy4(a.x, b, acc[0]);
            axpy4(a.y, b, acc[1]);
            axpy4(a.z, b, acc[2]);
            axpy4(a.w, b, acc[3]);
        }
        if (vec && i0 + 3 < n && j0 + 3 < i0) {
            // the lane's 4 x 4 lies below the diagonal
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(Kout + (size_t)(i0 + i) * n + j0) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float4*>(Kout + (size_t)(j0 + j) * n + i0) =
                    make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
            continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = i0 + i, c = j0 + j;
                if (r < n && c <= r) {
                    Kout[(size_t)r * n + c] = acc[i][j];
                    if (c < r) Kout[(size_t)c * n + r] = acc[i][j];
                }
            }
    }
}

}  // namespace chol_blocked
