// Fused masked MVGP Gram, batched, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/gram.py
// `_gram_kernel` (`fused_gram_kb`), which builds one matrix per grid step
// in one VMEM-resident block:
//
//   out[i][j] = s exp(-1/2 sum_a (Xs[i][a] - Xs[j][a])^2) (UHB[i] . UHB[j])
//               m_i m_j + (1 - m_i) [i == j] + jitter m_i [i == j]
//
// for Xs = X / lengthscale (K, n), UHB = UH chol(B) (K, 1+m), the row mask
// m (K,) and the outputscale s.  Distances use the exact per-dimension
// differences, never |a|^2 + |b|^2 - 2 a.b, which cancels in f32 for the
// near-duplicate consecutive states of a training buffer.  Each entry is
// the same expression, in the same order, as in the kernel this one
// replaced (the fmaf chains over a and c, s expf(-d2 / 2), then the
// masks and the diagonal), so both give the same bits.
//
// What bounds it on the H100: the bytes of the (B, K, K) output (41 MB at
// B = 256, K = 200, against 0.4 MB of input): 12.7 us at 3.35 TB/s.  The
// entries' arithmetic (n + 1+m multiply-adds, one expf, four multiplies:
// ~40 instructions an entry with the loads and the loop) is of the same
// order, so the design keeps the stores streaming, never waiting on a
// load, and the arithmetic lean enough to run under them:
//  - Persistent blocks.  A work item is one band of R consecutive rows of
//    one matrix; the grid is at most the SMs times the blocks resident on
//    each, and block g walks the items [g N / grid, (g+1) N / grid) in
//    order (ops/gram.py `gram_plan` makes the cut).
//  - Inputs read in place.  Each thread loads the inputs of its columns
//    into registers once per band (through L1) and each row's inputs as it
//    reaches the row (one broadcast load per value for the whole warp).
//    The inputs are 0.4 MB against 41 MB of output, so they stay in L2 and
//    no load stands in the way of a store.  Staging each matrix's inputs
//    in shared memory with cp.async, double-buffered, was built and
//    measured slower at every shape timed (PERF.md), so there is no
//    size at which an input must be staged: any K runs.
//  - Stores that stream.  A band of one matrix is R K 4 contiguous bytes.
//    Each thread walks every G-th row of the band (G row groups share the
//    block's 256 threads), writing each 4-column chunk of a row with one
//    16-byte streaming store (__stcs of a float4); the 32 stores of a warp
//    are one contiguous span.  Chunks follow the 16-byte alignment of each
//    row's address, so a row whose start is not aligned (K % 4 != 0)
//    begins and ends with a partial chunk written entry by entry; G is a
//    multiple of 4 there where it can be, so that a thread's rows share
//    one alignment (else it loads its columns again when it changes).
//  - Arithmetic that overlaps.  n = 1+m = 3 (the unicycle's Gram) and
//    n = 1+m = 2 (the pendulum's) have instances whose loops have a fixed
//    length and whose threads own two chunks each (8 entries a row: 8
//    independent chains, the row's inputs loaded once for both); the
//    entries have no branch between them (the guards are selects, the
//    diagonal is added after).  The instance for any other n, 1+m holds 16
//    inputs of 4 columns in registers (~212 of them: one block per SM),
//    and is slower than the tile kernel it replaced at every shape timed
//    (PERF.md): no model of the repo runs it.
// One bulk (TMA) store per band from shared memory was also built and
// timed against these stores (probe_gram.py); see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 16;

// An instance serves n = 1+m = N exactly (N > 0: loops of fixed length,
// each thread owning P = 2 chunks of 4 columns) or any n, 1+m <= kMaxDim
// (N = 0: loops of kMaxDim steps, each step past n or 1+m selected away;
// P = 1, so that the columns' inputs stay in registers).
template <int N>
struct Dims {
    static constexpr int D = N ? N : kMaxDim;
    static constexpr int P = N ? 2 : 1;
    static constexpr int W = 4 * P;  // columns of one thread
    __device__ static bool on(int a, int n) { return N || a < n; }
};

struct GramArgs {
    const float* Xs;     // (B, K, n)
    const float* U;      // (B, K, mh)
    const float* mask;   // (B, K)
    const float* scale;  // (B,) outputscale
    float* out;          // (B, K, K)
    float jitter;
    int K, n, mh;
    int R;      // rows per band
    int G;      // row groups of a band
    int bands;  // bands per matrix, ceil(K / R)
    int items;  // B * bands
};

// Column chunks of 4 columns in a band row, aligned to the row's address:
// a misaligned row (K % 4 != 0) has a partial chunk at each end.
__device__ inline int row_chunks(int K, const float* out) {
    const bool aligned = K % 4 == 0 && ((uintptr_t)out & 15) == 0;
    return (K + (aligned ? 0 : 3) + 3) / 4;
}

// One matrix's inputs, read through L1.
struct Matrix {
    const float* X;
    const float* U;
    const float* M;
    int n, mh;
    __device__ float x(int a, int j) const { return __ldg(X + j * n + a); }
    __device__ float u(int c, int j) const { return __ldg(U + j * mh + c); }
    __device__ float m(int j) const { return __ldg(M + j); }
};

// The inputs of the thread's columns, 4 from each of its P chunks, the
// chunk p starting at j0[p] (zeros outside [0, K)), held in registers.
template <int N>
struct Cols {
    static constexpr int D = Dims<N>::D, W = Dims<N>::W;
    float x[D][W], u[D][W], m[W];

    __device__ void load(const Matrix& src, const int* j0, int K) {
#pragma unroll
        for (int q = 0; q < W; ++q) {
            const int j = j0[q / 4] + q % 4;
            const bool in = j >= 0 && j < K;
#pragma unroll
            for (int a = 0; a < D; ++a) {
                x[a][q] = (in && Dims<N>::on(a, src.n)) ? src.x(a, j) : 0.0f;
                u[a][q] = (in && Dims<N>::on(a, src.mh)) ? src.u(a, j) : 0.0f;
            }
            m[q] = in ? src.m(j) : 0.0f;
        }
    }
};

// The inputs of row i.
template <int N>
struct Row {
    static constexpr int D = Dims<N>::D;
    float x[D], u[D], m;

    __device__ void load(const Matrix& src, int i) {
#pragma unroll
        for (int a = 0; a < D; ++a) {
            x[a] = Dims<N>::on(a, src.n) ? src.x(a, i) : 0.0f;
            u[a] = Dims<N>::on(a, src.mh) ? src.u(a, i) : 0.0f;
        }
        m = src.m(i);
    }
};

// Entries of row i in the thread's W columns: the replaced kernel's
// expression, in its order; the diagonal is added by the caller.  No
// branch: the guards are selects, so that the W entries' chains
// interleave.
template <int N>
__device__ inline void entries(const Row<N>& r, const Cols<N>& c, int n,
                               int mh, float s, float* v) {
    constexpr int D = Dims<N>::D;
#pragma unroll
    for (int q = 0; q < Dims<N>::W; ++q) {
        float d2 = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) {
            const float diff = r.x[a] - c.x[a][q];
            const float next = fmaf(diff, diff, d2);
            d2 = Dims<N>::on(a, n) ? next : d2;
        }
        float ubu = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) {
            const float next = fmaf(r.u[a], c.u[a][q], ubu);
            ubu = Dims<N>::on(a, mh) ? next : ubu;
        }
        const float rbf = s * expf(-0.5f * d2);
        v[q] = rbf * ubu * (r.m * c.m[q]);
    }
}

// Rows i0 .. i0 + rows - 1 of one matrix (output `ob`), each thread's 4
// entries of a chunk written with one 16-byte streaming store.  A row's
// nch chunks of 4 columns are split into P parts: thread c of a row group
// owns chunks c, c + nh, ... (nh = ceil(nch / P)), so that each of its
// stores meets its neighbours' in one span.
template <int N>
__device__ void band(const GramArgs& g, const Matrix& src, float s,
                     float* ob, int i0, int rows) {
    constexpr int P = Dims<N>::P, W = Dims<N>::W;
    const int K = g.K, n = g.n, mh = g.mh, G = g.G;
    const int nch = row_chunks(K, g.out), nh = (nch + P - 1) / P;
    for (int t = threadIdx.x; t < G * nh; t += kThreads) {
        const int grp = t / nh, chunk = t - grp * nh;
        Cols<N> c;
        int cached = -1;  // the alignment the columns were loaded for
        for (int r = grp; r < rows; r += G) {
            const int i = i0 + r;
            float* row = ob + (size_t)i * K;
            const int h = (int)((uintptr_t)row >> 2) & 3;  // floats past 16 B
            int j0[P];
#pragma unroll
            for (int p = 0; p < P; ++p) j0[p] = 4 * (chunk + p * nh) - h;
            if (j0[0] >= K) continue;
            if (h != cached) {
                c.load(src, j0, K);
                cached = h;
            }
            Row<N> ri;
            ri.load(src, i);
            float v[W];
            entries<N>(ri, c, n, mh, s, v);
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int dq = i - j0[p];  // the diagonal's place
                if ((unsigned)dq < 4u) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        if (q == dq) {
                            float& e = v[4 * p + q];
                            e = e + (1.0f - ri.m);
                            e = e + g.jitter * ri.m;
                        }
                    }
                }
                float* dst = row + j0[p];
                const float* w = v + 4 * p;
                if (j0[p] >= 0 && j0[p] + 4 <= K) {
                    __stcs(reinterpret_cast<float4*>(dst),
                           make_float4(w[0], w[1], w[2], w[3]));
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (j0[p] + q >= 0 && j0[p] + q < K)
                            __stcs(dst + q, w[q]);
                }
            }
        }
    }
}

// Block g's items [g N / grid, (g + 1) N / grid), N = g.items; item it is
// rows [(it % bands) R, + R) of matrix it / bands.
__device__ inline int first_item(int block, int grid, int items) {
    return (int)((long long)block * items / grid);
}

// N: Dims.
template <int N>
__global__ void __launch_bounds__(kThreads) gram_kernel(const GramArgs g) {
    const int last = first_item(blockIdx.x + 1, gridDim.x, g.items);
    for (int it = first_item(blockIdx.x, gridDim.x, g.items); it < last;
         ++it) {
        const int b = it / g.bands;
        const int i0 = (it - b * g.bands) * g.R;
        const Matrix src{g.Xs + (size_t)b * g.K * g.n,
                         g.U + (size_t)b * g.K * g.mh,
                         g.mask + (size_t)b * g.K, g.n, g.mh};
        band<N>(g, src, g.scale[b], g.out + (size_t)b * g.K * g.K, i0,
                min(g.R, g.K - i0));
    }
}

typedef void (*GramKernel)(const GramArgs);

// The instance for (n, mh) and the chunks each of its threads owns; no
// kernel if (n, mh) is out of range.
struct Instance {
    GramKernel kernel;
    int P;
};

template <int N>
Instance instance() {
    return Instance{gram_kernel<N>, Dims<N>::P};
}

Instance pick(int n, int mh) {
    if (n < 1 || n > kMaxDim || mh < 1 || mh > kMaxDim)
        return Instance{nullptr, 0};
    if (n == mh && n == 3) return instance<3>();
    if (n == mh && n == 2) return instance<2>();
    return instance<0>();
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Chunks of 4 columns that one thread owns in a row for (n, mh): the
// wrapper's cut into items (ops/gram.py `gram_plan`) needs it.
int gram_thread_chunks(int n, int mh) { return pick(n, mh).P; }

// Thread blocks of 256 threads that one SM holds at once for (n, mh), or
// -1 if (n, mh) is out of range (1 <= n, mh <= 16): the wrapper's cut into
// items (ops/gram.py `gram_plan`) needs it.
int gram_blocks_per_sm(int n, int mh) {
    const Instance c = pick(n, mh);
    int blocks = 0;
    if (!c.kernel || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, c.kernel, kThreads, 0))
        return -1;
    return blocks;
}

// The masked Gram (B, K, K) of Xs (B, K, n), UHB (B, K, mh), mask (B, K),
// outputscale (B,); all f32, contiguous; 1 <= n, mh <= 16.  `grid`
// persistent blocks of 256 threads walk bands of R rows, each band's rows
// in G groups (ops/gram.py `gram_plan`).
int gram_launch(const float* Xs, const float* UHB, const float* mask,
                const float* outputscale, float jitter, float* out, int B,
                int K, int n, int mh, int R, int G, int grid, void* stream) {
    const Instance c = pick(n, mh);
    if (!c.kernel || B < 1 || K < 1 || R < 1 || G < 1 || grid < 1) return -1;
    const int bands = (K + R - 1) / R;
    if ((long long)B * bands > 0x7fffffff || grid > B * bands) return -1;
    const GramArgs g{Xs, UHB, mask, outputscale, out, jitter, K, n, mh,
                     R, G, bands, B * bands};
    c.kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}

}  // extern "C"
