// The masked fit-Gram of the MVGP's marginal likelihood and its pull-back,
// batched, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves `ops/gramsolve.km_expr`
// and its VJP to XLA, which fuses each into loops over (k, k).  Eager
// PyTorch has no such fusion: it materialises the (B, K, K, x_dim)
// differences and some ten (B, K, K) intermediates in the forward, and
// autograd runs through them again in the backward.  These two kernels
// each make one pass over (K, K):
//
//   Km[i][j] = rbf_ij ubu_ij m_i m_j + [i == j] (nug m_i + 1 - m_i),
//   rbf_ij = exp(-1/2 sum_a ((X_ia - X_ja) il_a)^2),  ubu_ij = UB_i . UH_j
//
// for X (K, xd) raw states, UB = UH (s B) (K, mh), UH (K, mh), the inverse
// lengthscales il (xd), the nugget nug and the row mask m (K).
//
// fit_gram_kernel writes Km, each entry in km_expr's order: the raw
// differences scaled by il, their squares summed over a, exp(-0.5 d2),
// then (rbf ubu) (m_i m_j), the diagonal's two terms added after; products
// and sums rounded one at a time as in the eager expression (no
// contraction), ubu as one multiply-add chain.
//
// fit_gram_backward_kernel takes Kinv = Km^-1, dY = Kinv dS and S = Kinv Y
// (K, n) and dlogdet; it forms w_ij = dlogdet Kinv_ij - dY_i . S_j, the
// entry of dKm (never stored), recomputes rbf_ij and ubu_ij, and returns
//   dUB_i = sum_j w_ij rbf_ij m_i m_j UH_j                   (a row's sum)
//   sum_ij w_ij rbf_ij ubu_ij m_i m_j (X_ia - X_ja)^2, a < xd  (a band's)
//   sum_i w_ii m_i                                            (a band's)
// The wrapper (ops/gramsolve.py) sums the bands' partials in band order
// and scales the first by -il_a: d il_a and d nug.  No atomics: every sum
// has one order, so two calls give the same bits.
//
// What bounds them on the H100: the bytes of the (B, K, K) matrix, written
// once (forward) or read once (backward): 655 MB at (4096, 200), 0.20 ms
// at 3.35 TB/s; 2.15 GB at (131072, 64), 0.64 ms.  An entry's arithmetic
// (25-40 instructions with one expf) is of the same order, so the design
// keeps the matrix's traffic coalesced and in flight and the rest cheap:
//  - Persistent blocks over bands of rows (ops/gram.py `gram_plan`, kernel
//    4's cut, with row groups of one warp): block g walks the items
//    [g N / grid, (g + 1) N / grid) of N = B ceil(K / R); an item is R
//    consecutive rows of one matrix, each of the 8 warps taking every 8th.
//  - One warp a row, lanes over its columns: the 32 lanes' accesses are one
//    contiguous 128-byte span, so every store (forward) or streaming load
//    (backward) is coalesced whatever K and the row's alignment are.  In
//    the backward a lane issues the loads of all its columns of the row
//    before it uses them, so that enough bytes are in flight.
//  - Inputs in registers: a lane's columns (lane + 32 c, c < CK) once an
//    item, a row's once a row (one broadcast load per value for the warp),
//    so that an entry reads nothing but Kinv.  Reading the columns through
//    L1 at every entry instead (xd-strided: ~28 L1 wavefronts per 32
//    entries at xd = 1+m = n = 3) held the first build to 18-45% of the
//    bound (PERF.md).
//  - A row's dUB by a warp shuffle tree; a band's sums by a shuffle tree
//    in each warp, then the warps in order through shared memory.
//  - Instances: xd = 1+m = n = 3 (the unicycle) and = 2 (the pendulum),
//    with loops of fixed length and CK = 2 (K <= 64) or 7 (K <= 224)
//    columns a lane; any widths up to 16 or any K (loops of 16 steps, the
//    steps past a width reading zeros, which add nothing; the columns'
//    inputs read through L1 at each entry).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 16;
constexpr int kUnroll = 4;  // columns whose Kinv a lane loads at once (CK 0)
constexpr unsigned kFull = 0xffffffffu;

// An instance serves xd = 1+m = n = N exactly (N > 0) or any of them up to
// kMaxDim (N = 0: loops of kMaxDim steps, each step past a width reading
// zeros).
template <int N>
struct Dims {
    static constexpr int D = N ? N : kMaxDim;
    __device__ static bool on(int a, int n) { return N || a < n; }
};

struct FitArgs {
    const float* X;     // (B, K, xd)
    const float* UB;    // (B, K, mh)
    const float* UH;    // (B, K, mh)
    const float* il;    // (B, xd) inverse lengthscales
    const float* nug;   // (B,), forward
    const float* mask;  // (B, K)
    const float* Kinv;  // (B, K, K), backward
    const float* dY;    // (B, K, n), backward
    const float* S;     // (B, K, n), backward
    const float* dl;    // (B,) dlogdet, backward
    float* out;         // forward: Km (B, K, K); backward: dUB (B, K, mh)
    float* part;        // backward: (items, xd + 1) band sums
    int K, xd, mh, n;
    int R;      // rows per band
    int bands;  // bands per matrix, ceil(K / R)
    int items;  // B * bands
};

// The inputs of one row or column `row` (b K + i): x, ub (rows), uh
// (columns), and for the backward dy (rows) or s (columns); zeros past the
// widths.
template <int N>
struct Point {
    static constexpr int D = Dims<N>::D;
    float x[D], u[D], y[D], m;

    // as row i: UB and dY; as column j: UH and S
    __device__ void load(const FitArgs& g, size_t row, bool as_row,
                         bool backward) {
        const int xd = N ? N : g.xd, mh = N ? N : g.mh, n = N ? N : g.n;
        const float* U = as_row ? g.UB : g.UH;
        const float* Y = as_row ? g.dY : g.S;
#pragma unroll
        for (int a = 0; a < D; ++a) {
            x[a] = Dims<N>::on(a, xd) ? __ldg(g.X + row * xd + a) : 0.0f;
            u[a] = Dims<N>::on(a, mh) ? __ldg(U + row * mh + a) : 0.0f;
            y[a] = (backward && Dims<N>::on(a, n)) ? __ldg(Y + row * n + a)
                                                   : 0.0f;
        }
        m = __ldg(g.mask + row);
    }

    __device__ void zero() {
#pragma unroll
        for (int a = 0; a < D; ++a) x[a] = u[a] = y[a] = 0.0f;
        m = 0.0f;
    }
};

// A lane's columns lane + 32 c (c < CK) of one matrix, held in registers
// for an item; none for CK = 0 (the columns are read at each entry).
template <int N, int CK>
struct Cols {
    Point<N> c[CK];

    __device__ void load(const FitArgs& g, size_t base, int lane,
                         bool backward) {
#pragma unroll
        for (int k = 0; k < CK; ++k) {
            const int j = lane + 32 * k;
            if (j < g.K)
                c[k].load(g, base + j, false, backward);
            else
                c[k].zero();
        }
    }
};

template <int N>
struct Cols<N, 0> {
    __device__ void load(const FitArgs&, size_t, int, bool) {}
};

// rbf and ubu of row r and column c, in km_expr's order; diff[a] =
// X_ia - X_ja is kept for the backward.
template <int N>
__device__ inline void pair(const Point<N>& r, const Point<N>& c,
                            const float* il, float* diff, float& rbf,
                            float& ubu) {
    constexpr int D = Dims<N>::D;
    float d2 = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
        diff[a] = __fsub_rn(r.x[a], c.x[a]);
        const float d = __fmul_rn(diff[a], il[a]);
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
    }
    ubu = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) ubu = fmaf(r.u[a], c.u[a], ubu);
    rbf = expf(__fmul_rn(-0.5f, d2));
}

// Km[i][j] of row r and column c.
template <int N>
__device__ inline float km_entry(const Point<N>& r, const Point<N>& c,
                                 const float* il, float nterm, float dterm,
                                 bool diagonal) {
    float diff[Dims<N>::D], rbf, ubu;
    pair<N>(r, c, il, diff, rbf, ubu);
    const float v = __fmul_rn(__fmul_rn(rbf, ubu), __fmul_rn(r.m, c.m));
    const float dv = __fadd_rn(__fadd_rn(v, nterm), dterm);
    return diagonal ? dv : v;
}

// Entry (i, j)'s part of the pull-back: w_ij, then the row's dUB and the
// lane's band sums (acc[a] for a < D, acc[D] the nugget's).
template <int N>
__device__ inline void pull_entry(const Point<N>& r, const Point<N>& c,
                                  const float* il, float dl, float kv,
                                  bool diagonal, float* dub, float* acc) {
    constexpr int D = Dims<N>::D;
    float diff[D], rbf, ubu;
    pair<N>(r, c, il, diff, rbf, ubu);
    float sd = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) sd = fmaf(r.y[a], c.y[a], sd);
    const float w = fmaf(dl, kv, -sd);
    const float t = __fmul_rn(__fmul_rn(w, rbf), __fmul_rn(r.m, c.m));
#pragma unroll
    for (int a = 0; a < D; ++a) dub[a] = fmaf(t, c.u[a], dub[a]);
    const float t2 = __fmul_rn(t, ubu);
#pragma unroll
    for (int a = 0; a < D; ++a)
        acc[a] = fmaf(t2, __fmul_rn(diff[a], diff[a]), acc[a]);
    if (diagonal) acc[D] = fmaf(w, r.m, acc[D]);
}

// Block g's items [g N / grid, (g + 1) N / grid), N = items; item it is
// rows [(it % bands) R, + R) of matrix it / bands.
__device__ inline int first_item(int block, int grid, int items) {
    return (int)((long long)block * items / grid);
}

// The inverse lengthscales of matrix b, zeros past xd.
template <int N>
__device__ inline void load_il(const FitArgs& g, int b,
                               float (&il)[Dims<N>::D]) {
    const int xd = N ? N : g.xd;
#pragma unroll
    for (int a = 0; a < Dims<N>::D; ++a)
        il[a] = Dims<N>::on(a, xd) ? __ldg(g.il + (size_t)b * xd + a) : 0.0f;
}

// N: Dims; CK: columns a lane holds in registers (0: read at each entry).
template <int N, int CK>
__global__ void __launch_bounds__(kThreads) fit_gram_kernel(const FitArgs g) {
    constexpr int D = Dims<N>::D;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = g.K;
    const int last = first_item(blockIdx.x + 1, gridDim.x, g.items);
    for (int it = first_item(blockIdx.x, gridDim.x, g.items); it < last;
         ++it) {
        const int b = it / g.bands;
        const int i0 = (it - b * g.bands) * g.R;
        const int rows = min(g.R, K - i0);
        const size_t base = (size_t)b * K;
        float il[D];
        load_il<N>(g, b, il);
        const float nug = __ldg(g.nug + b);
        Cols<N, CK> cols;
        cols.load(g, base, lane, false);
        for (int r = warp; r < rows; r += kWarps) {
            const int i = i0 + r;
            Point<N> ri;
            ri.load(g, base + i, true, false);
            const float dterm = 1.0f - ri.m;
            const float nterm = __fmul_rn(nug, ri.m);
            float* orow = g.out + (base + i) * K;
            if constexpr (CK > 0) {
#pragma unroll
                for (int k = 0; k < CK; ++k) {
                    const int j = lane + 32 * k;
                    if (j < K)
                        __stcs(orow + j, km_entry<N>(ri, cols.c[k], il,
                                                     nterm, dterm, j == i));
                }
            } else {
#pragma unroll 4
                for (int j = lane; j < K; j += 32) {
                    Point<N> cj;
                    cj.load(g, base + j, false, false);
                    __stcs(orow + j,
                           km_entry<N>(ri, cj, il, nterm, dterm, j == i));
                }
            }
        }
    }
}

template <int N, int CK>
__global__ void __launch_bounds__(kThreads)
    fit_gram_backward_kernel(const FitArgs g) {
    constexpr int D = Dims<N>::D;
    __shared__ float red[kWarps][kMaxDim + 1];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = g.K;
    const int xd = N ? N : g.xd, mh = N ? N : g.mh;
    const int last = first_item(blockIdx.x + 1, gridDim.x, g.items);
    for (int it = first_item(blockIdx.x, gridDim.x, g.items); it < last;
         ++it) {
        const int b = it / g.bands;
        const int i0 = (it - b * g.bands) * g.R;
        const int rows = min(g.R, K - i0);
        const size_t base = (size_t)b * K;
        float il[D];
        load_il<N>(g, b, il);
        const float dl = __ldg(g.dl + b);
        Cols<N, CK> cols;
        cols.load(g, base, lane, true);
        float acc[D + 1];  // the lane's sums: a < D the lengthscales', D nug's
#pragma unroll
        for (int a = 0; a <= D; ++a) acc[a] = 0.0f;
        for (int r = warp; r < rows; r += kWarps) {
            const int i = i0 + r;
            Point<N> ri;
            ri.load(g, base + i, true, true);
            const float* krow = g.Kinv + (base + i) * K;
            float dub[D];
#pragma unroll
            for (int a = 0; a < D; ++a) dub[a] = 0.0f;
            if constexpr (CK > 0) {
                float kv[CK];
#pragma unroll
                for (int k = 0; k < CK; ++k) {
                    const int j = lane + 32 * k;
                    kv[k] = j < K ? __ldcs(krow + j) : 0.0f;
                }
#pragma unroll
                for (int k = 0; k < CK; ++k) {
                    const int j = lane + 32 * k;
                    if (j < K)
                        pull_entry<N>(ri, cols.c[k], il, dl, kv[k], j == i,
                                      dub, acc);
                }
            } else {
                for (int j0 = lane; j0 < K; j0 += 32 * kUnroll) {
                    float kv[kUnroll];
#pragma unroll
                    for (int u = 0; u < kUnroll; ++u) {
                        const int j = j0 + 32 * u;
                        kv[u] = j < K ? __ldcs(krow + j) : 0.0f;
                    }
#pragma unroll
                    for (int u = 0; u < kUnroll; ++u) {
                        const int j = j0 + 32 * u;
                        if (j >= K) continue;
                        Point<N> cj;
                        cj.load(g, base + j, false, true);
                        pull_entry<N>(ri, cj, il, dl, kv[u], j == i, dub,
                                      acc);
                    }
                }
            }
            // the row's dUB: a shuffle tree to lane 0
#pragma unroll
            for (int a = 0; a < D; ++a)
#pragma unroll
                for (int off = 16; off; off >>= 1)
                    dub[a] += __shfl_down_sync(kFull, dub[a], off);
            if (lane == 0) {
#pragma unroll
                for (int a = 0; a < D; ++a)
                    if (Dims<N>::on(a, mh)) g.out[(base + i) * mh + a] = dub[a];
            }
        }
        // the band's sums: a shuffle tree in each warp, then the warps in
        // order
#pragma unroll
        for (int a = 0; a <= D; ++a) {
#pragma unroll
            for (int off = 16; off; off >>= 1)
                acc[a] += __shfl_down_sync(kFull, acc[a], off);
            if (lane == 0) red[warp][a] = acc[a];
        }
        __syncthreads();
        if (threadIdx.x <= xd) {
            const int a = threadIdx.x < xd ? threadIdx.x : D;
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s += red[w][a];
            g.part[(size_t)it * (xd + 1) + threadIdx.x] = s;
        }
        __syncthreads();
    }
}

typedef void (*FitKernel)(const FitArgs);

// The instance for (xd, mh, n, K): its forward and backward kernels, or
// none if a width is out of range.
struct Instance {
    FitKernel forward, backward;
};

template <int N, int CK>
Instance instance() {
    return Instance{fit_gram_kernel<N, CK>, fit_gram_backward_kernel<N, CK>};
}

// Columns a lane holds for K: 2 to K = 64, 7 to K = 224, else none.
template <int N>
Instance by_columns(int K) {
    if (K <= 64) return instance<N, 2>();
    if (K <= 224) return instance<N, 7>();
    return instance<N, 0>();
}

Instance pick(int xd, int mh, int n, int K) {
    if (xd < 1 || xd > kMaxDim || mh < 1 || mh > kMaxDim || n < 1 ||
        n > kMaxDim)
        return Instance{nullptr, nullptr};
    if (xd == 3 && mh == 3 && n == 3) return by_columns<3>(K);
    if (xd == 2 && mh == 2 && n == 2) return by_columns<2>(K);
    return instance<0, 0>();
}

bool plan_ok(int B, int K, int R, int grid) {
    if (B < 1 || K < 1 || R < 1 || grid < 1) return false;
    const long long items = (long long)B * ((K + R - 1) / R);
    return items <= 0x7fffffff && grid <= items;
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Thread blocks of 256 threads that one SM holds at once of the forward
// (backward 0) or backward (1) kernel for (xd, mh, n, K), or -1 if a width
// is out of range (1..16): the wrapper's cut into items (ops/gram.py
// `gram_plan`) needs it.
int fit_gram_blocks_per_sm(int backward, int xd, int mh, int n, int K) {
    const Instance c = pick(xd, mh, n, K);
    const FitKernel k = backward ? c.backward : c.forward;
    int blocks = 0;
    if (!k ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0))
        return -1;
    return blocks;
}

// Km (B, K, K) of X (B, K, xd), UB, UH (B, K, mh), il (B, xd), nug (B,),
// mask (B, K); all f32, contiguous; 1 <= xd, mh <= 16.  `grid` persistent
// blocks walk bands of R rows.
int fit_gram_launch(const float* X, const float* UB, const float* UH,
                    const float* il, const float* nug, const float* mask,
                    float* out, int B, int K, int xd, int mh, int R, int grid,
                    void* stream) {
    const Instance c = pick(xd, mh, xd, K);
    if (!c.forward || !plan_ok(B, K, R, grid)) return -1;
    const int bands = (K + R - 1) / R;
    const FitArgs g{X, UB, UH, il, nug, mask, nullptr, nullptr, nullptr,
                    nullptr, out, nullptr, K, xd, mh, xd, R, bands,
                    B * bands};
    c.forward<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}

// dUB (B, K, mh) and the band sums part (B ceil(K / R), xd + 1) of the
// pull-back of dKm = dl Kinv - dY S^T through Km, for Kinv (B, K, K),
// dY, S (B, K, n), dl (B,) and the forward's inputs; all f32, contiguous;
// 1 <= xd, mh, n <= 16.
int fit_gram_backward_launch(const float* X, const float* UB, const float* UH,
                             const float* il, const float* mask,
                             const float* Kinv, const float* dY,
                             const float* S, const float* dl, float* dUB,
                             float* part, int B, int K, int xd, int mh, int n,
                             int R, int grid, void* stream) {
    const Instance c = pick(xd, mh, n, K);
    if (!c.backward || !plan_ok(B, K, R, grid)) return -1;
    const int bands = (K + R - 1) / R;
    const FitArgs g{X, UB, UH, il, nullptr, mask, Kinv, dY, S, dl, dUB,
                    part, K, xd, mh, n, R, bands, B * bands};
    c.backward<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}

}  // extern "C"
