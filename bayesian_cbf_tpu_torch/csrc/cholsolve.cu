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
// kernel's working copy X, and only rows < n are written out.
//
// The sweeps (`sweeps`, one device function for both kernels) are both
// right-looking.  Step j solves its diagonal block with Dinv_j (one thread
// per row and 4 columns, a chain of at most nb terms), then updates the
// rest of X with that block's solution:
//     forward   X[o+nb:] -= L[o+nb:, o:o+nb] y_j   (the panel below),
//     backward  X[:o]    -= L[o:o+nb, :o]^T x_j    (the block row left).
// Every update entry is a chain of nb terms; a thread owns a 4 x 4 tile of
// them (4 rows of X, 4 columns) and reads L as float4: along the panel's
// rows forward, along the block row backward.  Each entry keeps one fixed
// chain of operations (blocks in sweep order, k ascending within a block)
// whatever thread computes it, so both kernels give the same bits.  The
// forward chains are those of the left-looking sweeps this replaced; the
// backward ones add the blocks in the opposite order.
//
// Where L comes from (`InPlace`, `Staged`):
//   * kernel 6 reads its working matrix where the factor left it (in
//     shared memory when it fits, a global scratch otherwise: one inlined
//     body per home), a whole panel per step;
//   * kernel 7 streams L's panels and Dinv's blocks through a ring of
//     kStages slots in shared memory with cp.async, the next tile copied
//     while this one is used.  A slot holds the sweeps' largest tile where
//     one block may hold that (solve_tile), so that at (256, 200, 16) a
//     step's panel is one tile.  A block solves `width`
//     columns of one matrix (grid B x groups): the wrapper cuts the columns
//     into groups only while the batch alone gives fewer blocks than SMs,
//     and each group re-reads L (from L2).
//
// What bounds it on the H100: kernel 6, the factor's serial pivot chain
// (one warp per diagonal block, see chol_blocked.cuh).  Kernel 7: each
// block's chain of 4 N / nb phases (a triangle, then an update, each
// between two meetings of the block), not the bytes: at (256, 200, 16) two
// blocks share an SM and each runs ~45 us, its cp.async waits near zero;
// a phase is the time of one thread's chain or tile plus the copy issue
// of every thread, and the 4 x 4 tiles read half a float of shared memory
// per multiply-add.  Column groups fill the card at small batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "chol_blocked.cuh"

namespace {

using chol_blocked::kMaxNb;

constexpr int kThreads = 256;          // the solve against a saved factor
constexpr int kStages = 2;             // slots of its ring
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block
constexpr int kMaxR = 64;
constexpr int kMaxN = 1024;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of the factor's block-step buffer, rounded so that T after it
// is 16-byte aligned.
__host__ __device__ inline int small_floats(int nb) {
    return round4((int)(chol_blocked::small_bytes(nb) / sizeof(float)));
}

// Kernel 6: which working arrays live in shared memory: bit 1 the RHS
// (N x round4(r)), bit 0 the factor's working matrix (only with the RHS
// there too).
__host__ inline int plan(int N, int nb, int r) {
    const size_t base =
        (size_t)(small_floats(nb) + nb * round4(r)) * sizeof(float);
    const size_t rhs = (size_t)N * round4(r) * sizeof(float);
    if (base + rhs > (size_t)kMaxSmemBytes) return 0;
    if (base + rhs + chol_blocked::matrix_bytes(N) <= (size_t)kMaxSmemBytes)
        return 3;
    return 2;
}

__host__ inline size_t smem_bytes(int N, int nb, int r, int p) {
    size_t s = (size_t)(small_floats(nb) + nb * round4(r)) * sizeof(float);
    if (p & 2) s += (size_t)N * round4(r) * sizeof(float);
    if (p & 1) s += chol_blocked::matrix_bytes(N);
    return s;
}

// Kernel 7's tiles: rows of Dinv and of a panel at stride tile_ld (16-byte
// copies: a multiple of 4 whose quarter is odd, so that 8 consecutive rows
// start in distinct bank groups; 4-byte copies: odd); a tile holds at
// least Dinv's block and 4 columns of a block row.
__host__ __device__ inline int tile_ld(int nb, bool vec) {
    return vec ? chol_blocked::stride(nb) : chol_blocked::odd(nb);
}

__host__ __device__ inline int min_tile(int nb) {
    return round4(nb * max(max(tile_ld(nb, true), tile_ld(nb, false)), 4));
}

// Kernel 7: the ring, T (nb x round4(w)) and X (N x round4(w)).
__host__ inline size_t solve_smem_bytes(int N, int nb, int w, int tile) {
    return ((size_t)kStages * tile + (size_t)(nb + N) * round4(w)) *
           sizeof(float);
}

// Kernel 7: floats of a ring slot for blocks of `w` columns: the largest
// tile of the sweeps, no more than one block may hold beside T and X, no
// less than min_tile (then the launch refuses a shape that does not fit).
__host__ inline int solve_tile(int N, int nb, int w) {
    const long long room =
        ((long long)kMaxSmemBytes / (long long)sizeof(float) -
         (long long)(nb + N) * round4(w)) / kStages;
    const long long most =
        round4(max((N - nb) * tile_ld(nb, true), nb * round4(N - nb)));
    const long long tile = min(room, max(most, (long long)min_tile(nb)));
    return (int)max(tile & ~3LL, (long long)min_tile(nb));
}

// ---- cp.async (16 bytes bypass L1; 4 bytes through it)
__device__ inline void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ inline void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ inline float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ inline void st4(float* p, const float4& v) {
    *reinterpret_cast<float4*>(p) = v;
}

// Start copying the RHS rows < n (w columns of R, row stride r) into X
// (N x xs, shared memory); zero rows n..N-1.  The caller commits.
__device__ inline void load_rhs_async(const float* R, int n, int N, int r,
                                      int w, float* X, int xs) {
    for (int t = threadIdx.x; t < N * w; t += blockDim.x) {
        const int i = t / w, c = t - i * w;
        if (i < n)
            cp_async4(X + i * xs + c, R + (size_t)i * r + c);
        else
            X[i * xs + c] = 0.0f;
    }
}

// Start copying a rows x cols block (row stride sld in global memory, dld
// in shared memory): 16-byte pieces when VEC (cols, the strides and both
// addresses multiples of 4 floats), else 4-byte.  Thread t copies pieces
// t, t + blockDim.x, ...; one division per call.
template <bool VEC>
__device__ inline void copy_tile(float* dst, int dld, const float* src,
                                 int sld, int rows, int cols) {
    const int q = VEC ? cols / 4 : cols, nt = blockDim.x;
    if (q == 0) return;
    const int di = nt / q, dk = nt - di * q;
    int i = threadIdx.x / q, k = threadIdx.x - (threadIdx.x / q) * q;
    while (i < rows) {
        if constexpr (VEC)
            cp_async16(dst + i * dld + 4 * k, src + (size_t)i * sld + 4 * k);
        else
            cp_async4(dst + i * dld + k, src + (size_t)i * sld + k);
        i += di;
        k += dk;
        if (k >= q) k -= q, ++i;
    }
}

// A block of L or Dinv as the sweep reads it: element (row, col) at
// p[row * ld + col].
struct Tile {
    const float* p;
    int ld;
};

// L and Dinv read where they lie: the factor's working matrix A (row
// stride ld) and Dinv (N x nb), a whole panel per tile.
struct InPlace {
    const float* A;
    int ld;
    const float* D;
    int nb;
    int rows, cols;  // rows of a panel tile, columns of a block-row tile

    __device__ InPlace(const float* A_, int ld_, const float* D_, int nb_,
                       int N)
        : A(A_), ld(ld_), D(D_), nb(nb_), rows(N), cols(N) {}
    __device__ Tile dinv(int o) {
        __syncthreads();
        return {D + (size_t)o * nb, nb};
    }
    __device__ Tile below(int o, int h0) {
        __syncthreads();
        return {A + (size_t)(o + nb + h0) * ld + o, ld};
    }
    __device__ Tile left(int o, int i0) {
        __syncthreads();
        return {A + (size_t)o * ld + i0, ld};
    }
};

// L (N x N) and Dinv (N x nb) in global memory, streamed through a ring of
// kStages slots of `tile` floats in shared memory: tile t + kStages - 1 is
// copied while tile t is used.  The tiles come in the order `sweeps` asks
// for them: per forward step Dinv's block, then the panel below in chunks
// of `rows` rows; per backward step Dinv's block, then the block row left
// of it in chunks of `cols` columns.  Every thread copies a share of each
// tile and commits one cp.async group per tile, so tile t is complete for
// all once each thread has waited for its own copies and the block has
// met.  VEC: 16-byte copies (nb a multiple of 4, L and Dinv 16-byte
// aligned).
template <bool VEC>
struct Staged {
    const float* L;
    const float* D;
    int N, nb, ld, tile;
    int rows, cols;
    float* ring;
    int taken, issued;
    int phase, j, pos;  // the next tile to copy; pos -1: Dinv's block

    __device__ Staged(const float* L_, const float* D_, int N_, int nb_,
                      int tile_, float* ring_)
        : L(L_), D(D_), N(N_), nb(nb_), ld(tile_ld(nb_, VEC)), tile(tile_),
          rows(tile_ / tile_ld(nb_, VEC)), cols((tile_ / nb_) & ~3),
          ring(ring_), taken(0), issued(0), phase(0), j(0), pos(-1) {}

    // Copy the next tile into its slot (an empty group once all are
    // copied) and move on.
    __device__ void issue() {
        float* dst = ring + (issued++ % kStages) * tile;
        if (phase < 2) {
            const int o = j * nb;
            const int extent = phase == 0 ? N - o - nb : o;
            if (pos < 0)
                copy_tile<VEC>(dst, ld, D + (size_t)o * nb, nb, nb, nb);
            else if (phase == 0)
                copy_tile<VEC>(dst, ld, L + (size_t)(o + nb + pos) * N + o,
                               N, min(rows, extent - pos), nb);
            else
                copy_tile<VEC>(dst, cols, L + (size_t)o * N + pos, N, nb,
                               min(cols, extent - pos));
            pos = pos < 0 ? 0 : pos + (phase == 0 ? rows : cols);
            if (pos >= extent) {
                pos = -1;
                if (phase == 0) {
                    if (++j == N / nb) phase = 1, j = N / nb - 1;
                } else if (--j < 0) {
                    phase = 2;
                }
            }
        }
        cp_async_commit();
    }

    __device__ void start() {
        for (int s = 0; s < kStages - 1; ++s) issue();
    }

    __device__ const float* take() {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue();
        return ring + (taken++ % kStages) * tile;
    }
    __device__ Tile dinv(int) { return {take(), ld}; }
    __device__ Tile below(int, int) { return {take(), ld}; }
    __device__ Tile left(int, int) { return {take(), cols}; }
};

// T (nb x ts) = Dinv_j Xj (forward) or Dinv_j^T Xj (backward) for the
// block's rows Xj (row stride ts); a thread owns one row and 4 columns.
template <bool FORWARD>
__device__ __forceinline__ void solve_block(Tile d, int nb, int ts,
                                            const float* Xj, float* T) {
    const int nq = ts >> 2;
    for (int it = threadIdx.x; it < nb * nq; it += blockDim.x) {
        const int i = it / nq, c0 = 4 * (it - i * nq);
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int k0 = FORWARD ? 0 : i, k1 = FORWARD ? i + 1 : nb;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
            const float a = FORWARD ? d.p[i * d.ld + k] : d.p[k * d.ld + i];
            const float4 x = ld4(Xj + k * ts + c0);
            acc.x = fmaf(a, x.x, acc.x);
            acc.y = fmaf(a, x.y, acc.y);
            acc.z = fmaf(a, x.z, acc.z);
            acc.w = fmaf(a, x.w, acc.w);
        }
        st4(T + i * ts + c0, acc);
    }
}

__device__ __forceinline__ void copy_block(const float* T, int nb, int ts,
                                           float* Xj) {
    for (int t = threadIdx.x; t < nb * ts / 4; t += blockDim.x)
        st4(Xj + 4 * t, ld4(T + 4 * t));
}

// acc[0..3] -= a * y
__device__ __forceinline__ void axpy(float a, const float4& y, float4& acc) {
    acc.x = fmaf(-a, y.x, acc.x);
    acc.y = fmaf(-a, y.y, acc.y);
    acc.z = fmaf(-a, y.z, acc.z);
    acc.w = fmaf(-a, y.w, acc.w);
}

// Xr[h] -= P[h] y for the h < R rows of X below the block (Xr, row stride
// ts) and the panel tile P (R x nb); y = T (nb x ts).  A thread owns rows
// g, g + G, g + 2G, g + 3G (G = ceil(R / 4)) and 4 columns.
template <bool VEC>
__device__ __forceinline__ void update_below(Tile P, int R, int nb, int ts,
                                             float* Xr, const float* T) {
    const int nq = ts >> 2, G = (R + 3) >> 2;
    for (int it = threadIdx.x; it < G * nq; it += blockDim.x) {
        const int g = it / nq, c0 = 4 * (it - g * nq);
        float4 acc[4];
        int row[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int h = min(g + u * G, R - 1);
            row[u] = h * P.ld;
            acc[u] = ld4(Xr + h * ts + c0);
        }
        if constexpr (VEC) {
            for (int k0 = 0; k0 < nb; k0 += 4) {
                const float* y = T + k0 * ts + c0;
                const float4 y0 = ld4(y), y1 = ld4(y + ts),
                             y2 = ld4(y + 2 * ts), y3 = ld4(y + 3 * ts);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 l = ld4(P.p + row[u] + k0);
                    axpy(l.x, y0, acc[u]);
                    axpy(l.y, y1, acc[u]);
                    axpy(l.z, y2, acc[u]);
                    axpy(l.w, y3, acc[u]);
                }
            }
        } else {
#pragma unroll 4
            for (int k = 0; k < nb; ++k) {
                const float4 y = ld4(T + k * ts + c0);
#pragma unroll
                for (int u = 0; u < 4; ++u) axpy(P.p[row[u] + k], y, acc[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (g + u * G < R) st4(Xr + (g + u * G) * ts + c0, acc[u]);
    }
}

// Xr[i] -= Q[:, i]^T x for the i < C rows of X left of the block (Xr, row
// stride ts) and the block-row tile Q (nb x C); x = T (nb x ts).  A thread
// owns rows 4g .. 4g + 3 and 4 columns.
template <bool VEC>
__device__ __forceinline__ void update_left(Tile Q, int C, int nb, int ts,
                                            float* Xr, const float* T) {
    const int nq = ts >> 2, G = (C + 3) >> 2;
    for (int it = threadIdx.x; it < G * nq; it += blockDim.x) {
        const int g = it / nq, c0 = 4 * (it - g * nq);
        const int i0 = 4 * g;
        float4 acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            acc[u] = ld4(Xr + min(i0 + u, C - 1) * ts + c0);
        const float* q = Q.p + i0;
#pragma unroll 4
        for (int k = 0; k < nb; ++k) {
            float l[4];
            if constexpr (VEC) {
                const float4 t = ld4(q + k * Q.ld);
                l[0] = t.x, l[1] = t.y, l[2] = t.z, l[3] = t.w;
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    l[u] = i0 + u < C ? q[k * Q.ld + u] : 0.0f;
            }
            const float4 y = ld4(T + k * ts + c0);
#pragma unroll
            for (int u = 0; u < 4; ++u) axpy(l[u], y, acc[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (i0 + u < C) st4(Xr + (i0 + u) * ts + c0, acc[u]);
    }
}

// Both sweeps in place on X (N rows of ts = round4(w) columns; the
// columns past w are carried along and never read into the others); T: nb
// x ts floats of shared memory.  X and T 16-byte aligned.  src hands out
// the tiles (InPlace or Staged) and meets the block before each.  Ends
// with a barrier: X is complete for every thread.
template <bool VEC, class Src>
__device__ __forceinline__ void sweeps(Src& src, int N, int nb, int ts,
                                       float* X, float* T) {
    const int nblk = N / nb;
    for (int j = 0; j < nblk; ++j) {
        const int o = j * nb, m = N - o - nb;
        solve_block<true>(src.dinv(o), nb, ts, X + o * ts, T);
        if (m == 0) {
            __syncthreads();
            copy_block(T, nb, ts, X + o * ts);
        }
        for (int h0 = 0; h0 < m; h0 += src.rows) {
            const Tile P = src.below(o, h0);
            if (h0 == 0) copy_block(T, nb, ts, X + o * ts);
            update_below<VEC>(P, min(src.rows, m - h0), nb, ts,
                              X + (o + nb + h0) * ts, T);
        }
    }
    for (int j = nblk - 1; j >= 0; --j) {
        const int o = j * nb;
        solve_block<false>(src.dinv(o), nb, ts, X + o * ts, T);
        if (o == 0) {
            __syncthreads();
            copy_block(T, nb, ts, X);
        }
        for (int i0 = 0; i0 < o; i0 += src.cols) {
            const Tile Q = src.left(o, i0);
            if (i0 == 0) copy_block(T, nb, ts, X + o * ts);
            update_left<VEC>(Q, min(src.cols, o - i0), nb, ts, X + i0 * ts,
                             T);
        }
    }
    __syncthreads();
}
// Kernel 6's sweeps over its working matrix A, at home wherever A is.
template <bool VEC>
__device__ __forceinline__ void sweeps_in_place(const float* A, int ld,
                                                const float* D, int N,
                                                int nb, int ts, float* X,
                                                float* T) {
    InPlace src(A, ld, D, nb, N);
    sweeps<VEC>(src, N, nb, ts, X, T);
}

// W = chol_blocked::row_width(nb): 32 with 512 threads, 64 with 256.
// VEC: nb a multiple of 4 (float4 reads of L).  One instance per VEC: at
// 512 threads a block has 128 registers a thread, and the two sweeps'
// bodies inlined beside the factor in one instance spill.
template <int W, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
cholsolve_kernel(const float* __restrict__ K, const float* __restrict__ RHS,
                 int n, int N, int nb, int r, int p,
                 float* __restrict__ a_scratch,  // (B, N, N) unless p & 1
                 float* __restrict__ x_scratch,  // (B, N, ts) unless p & 2
                 float* __restrict__ sol,        // (B, n, r)
                 float* __restrict__ L,          // (B, N, N)
                 float* __restrict__ Dinv,       // (B, N, nb)
                 float* __restrict__ logdet)     // (B,)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int ts = round4(r);
    float* small = smem;
    float* T = small + small_floats(nb);
    float* Xs = T + nb * ts;
    float* X = (p & 2) ? Xs : x_scratch + (size_t)b * N * ts;
    const int ld = (p & 1) ? chol_blocked::stride(N) : N;
    float* Lb = L + (size_t)b * N * N;
    float* Db = Dinv + (size_t)b * N * nb;

    // the RHS arrives while the factor runs
    const float* R = RHS + (size_t)b * n * r;
    if (p & 2) {
        load_rhs_async(R, n, N, r, r, X, ts);
        cp_async_commit();
    } else {
        for (int t = threadIdx.x; t < N * r; t += blockDim.x) {
            const int i = t / r, c = t - i * r;
            X[i * ts + c] = i < n ? R[t] : 0.0f;
        }
    }
    // one inlined copy of the factor and the sweeps per home of the
    // working matrix, so that the copy in shared memory addresses it as
    // shared memory
    const float* Kb = K + (size_t)b * n * n;
    if (p & 1) {
        float* A = Xs + (size_t)N * ts;
        chol_blocked::factor<W>(Kb, n, N, nb, A, ld, small, Lb, Db);
        if (threadIdx.x < 32) {
            const float ld2 = chol_blocked::logdet_of_diag(A, ld, N);
            if (threadIdx.x == 0) logdet[b] = ld2;
        }
        cp_async_wait<0>();
        sweeps_in_place<VEC>(A, ld, Db, N, nb, ts, X, T);
    } else {
        float* A = a_scratch + (size_t)b * N * N;
        chol_blocked::factor<W>(Kb, n, N, nb, A, ld, small, Lb, Db);
        if (threadIdx.x < 32) {
            const float ld2 = chol_blocked::logdet_of_diag(A, ld, N);
            if (threadIdx.x == 0) logdet[b] = ld2;
        }
        cp_async_wait<0>();
        sweeps_in_place<VEC>(A, ld, Db, N, nb, ts, X, T);
    }
    float* S = sol + (size_t)b * n * r;
    for (int t = threadIdx.x; t < n * r; t += blockDim.x) {
        const int i = t / r, c = t - i * r;
        S[t] = X[i * ts + c];
    }
}

// Block (b, g) of the grid B x groups solves columns g * width ..
// min(r, (g + 1) * width) - 1 of matrix b, with a ring of `tile`-float
// slots.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
solve_with_factor_kernel(const float* __restrict__ L,
                         const float* __restrict__ Dinv,
                         const float* __restrict__ RHS, int n, int N, int nb,
                         int r, int groups, int width, int tile,
                         float* __restrict__ sol)
{
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x / groups, g = blockIdx.x - b * groups;
    const int c0 = g * width, w = min(width, r - c0), ts = round4(w);
    float* T = smem + (size_t)kStages * tile;
    float* X = T + nb * ts;
    const float* R = RHS + (size_t)b * n * r + c0;
    load_rhs_async(R, n, N, r, w, X, ts);  // joins the first tile's group
    Staged<VEC> src(L + (size_t)b * N * N, Dinv + (size_t)b * N * nb, N, nb,
                    tile, smem);
    src.start();
    sweeps<VEC>(src, N, nb, ts, X, T);
    float* S = sol + (size_t)b * n * r + c0;
    for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
        const int i = t / w, c = t - i * w;
        S[(size_t)i * r + c] = X[i * ts + c];
    }
}

template <int W, int THREADS, bool VEC>
int launch_cholsolve(const float* K, const float* RHS, float* sol, float* L,
                     float* Dinv, float* logdet, float* a_scratch,
                     float* x_scratch, int B, int n, int N, int nb, int r,
                     int p, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        cholsolve_kernel<W, THREADS, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cholsolve_kernel<W, THREADS, VEC><<<B, THREADS, smem, stream>>>(
        K, RHS, n, N, nb, r, p, a_scratch, x_scratch, sol, L, Dinv, logdet);
    return (int)cudaGetLastError();
}

// Once per device and instance: kernel 7 may take up to kMaxSmemBytes of
// dynamic shared memory, with all of L1 as shared memory (its blocks are
// sized to fill it).  Devices past the mask's 64 are set at every launch.
template <bool VEC>
cudaError_t allow_solve_smem() {
    static std::atomic<unsigned long long> done{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (bit & done.load(std::memory_order_relaxed)) return cudaSuccess;
    err = cudaFuncSetAttribute(solve_with_factor_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            solve_with_factor_kernel<VEC>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return err;
}

template <bool VEC>
int launch_solve(const float* L, const float* Dinv, const float* RHS,
                 float* sol, int B, int n, int N, int nb, int r, int groups,
                 int width, int tile, cudaStream_t stream) {
    const cudaError_t err = allow_solve_smem<VEC>();
    if (err != cudaSuccess) return (int)err;
    solve_with_factor_kernel<VEC>
        <<<B * groups, kThreads, solve_smem_bytes(N, nb, width, tile),
           stream>>>(L, Dinv, RHS, n, N, nb, r, groups, width, tile, sol);
    return (int)cudaGetLastError();
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

// Kernel 6: which working arrays fit in shared memory (bit 1: the (N, r)
// RHS; bit 0: the factor's (N, N) matrix); a cleared bit means the caller
// passes a (B, N, r) or (B, N, N) global scratch.
int cholsolve_plan(int N, int nb, int r) { return plan(N, nb, r); }

// sol (B, n, r), L (B, N, N), Dinv (B, N, nb) and logdet (B,) of a batch K
// (B, n, n) and RHS (B, n, r), f32, contiguous; N = max(ceil(n / nb) nb,
// nb), 1 <= nb <= 64, 1 <= r <= 64.
int cholsolve_logdet_launch(const float* K, const float* RHS, float* sol,
                            float* L, float* Dinv, float* logdet,
                            float* a_scratch, float* x_scratch, int B, int n,
                            int N, int nb, int r, void* stream) {
    if (check_shape(n, N, nb, r)) return -1;
    const int p = plan(N, nb, r);
    const size_t smem = smem_bytes(N, nb, r, p);
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = (nb & 3) == 0;
    if (nb <= 32)
        return vec ? launch_cholsolve<32, 512, true>(
                         K, RHS, sol, L, Dinv, logdet, a_scratch, x_scratch,
                         B, n, N, nb, r, p, smem, s)
                   : launch_cholsolve<32, 512, false>(
                         K, RHS, sol, L, Dinv, logdet, a_scratch, x_scratch,
                         B, n, N, nb, r, p, smem, s);
    return vec ? launch_cholsolve<64, 256, true>(K, RHS, sol, L, Dinv, logdet,
                                                 a_scratch, x_scratch, B, n,
                                                 N, nb, r, p, smem, s)
               : launch_cholsolve<64, 256, false>(K, RHS, sol, L, Dinv,
                                                  logdet, a_scratch,
                                                  x_scratch, B, n, N, nb, r,
                                                  p, smem, s);
}

// Kernel 7: the most RHS columns one block holds at (N, nb) with the
// smallest tiles, a multiple of 4 up to 64; 0 if the shape is refused.
int solve_with_factor_width(int N, int nb) {
    if (nb < 1 || nb > kMaxNb || N % nb != 0 || N > kMaxN + kMaxNb) return 0;
    for (int w = kMaxR; w >= 4; w -= 4)
        if (solve_smem_bytes(N, nb, w, min_tile(nb)) <= (size_t)kMaxSmemBytes)
            return w;
    return 0;
}

// sol (B, n, r) against a saved factor L (B, N, N), Dinv (B, N, nb) and
// RHS (B, n, r), f32, contiguous: `groups` blocks per matrix, each solving
// `width` columns (the last the rest), with ring slots of solve_tile floats.
int solve_with_factor_launch(const float* L, const float* Dinv,
                             const float* RHS, float* sol, int B, int n,
                             int N, int nb, int r, int groups, int width,
                             void* stream) {
    if (check_shape(n, N, nb, r) || groups < 1 || width < 1 ||
        (long long)groups * width < r || (groups - 1) * width >= r)
        return -1;
    const int tile = solve_tile(N, nb, width);
    if (solve_smem_bytes(N, nb, width, tile) > (size_t)kMaxSmemBytes)
        return -1;
    const bool vec = (nb & 3) == 0 && ((uintptr_t)L & 15) == 0 &&
                     ((uintptr_t)Dinv & 15) == 0;
    if (vec)
        return launch_solve<true>(L, Dinv, RHS, sol, B, n, N, nb, r, groups,
                                  width, tile, (cudaStream_t)stream);
    return launch_solve<false>(L, Dinv, RHS, sol, B, n, N, nb, r, groups,
                               width, tile, (cudaStream_t)stream);
}

}  // extern "C"
