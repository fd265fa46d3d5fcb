// Batched inverse + logdet by recursive Schur complements over
// symmetric-sweep base blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/pallas_sweep.py
// `batched_kinv_logdet` (`_kernel`, `_inv_logdet`, `_sweep_block`): the
// TPU body recurses over VMEM values, splitting each diagonal block of
// the identity-padded matrix at h = (s // (2 base)) base, combining with
// f32 matmuls and inverting base x base leaves with the sweep operator.
//
// Two kernels, chosen by the wrapper (ops/sweep_kernels.py `sweep_route`)
// from the schedule's shape:
//
// sweep_kernel: any schedule.  One thread block owns one matrix and runs
// the recursion in place.  The host (ops/sweep_kernels.py `schedule`)
// flattens the recursion into a list of events, so the kernel is a loop
// over three kinds of step:
//   SWEEP (o, r):   sweep pivots o..o+r-1 of the r x r block at (o, o):
//                   d = max(M[i][i], 1e-12), ld += log d, then
//                   M[j][k] -= M[j][i] (M[i][k] / d) off row/col i,
//                   row i and col i scaled by 1/d, M[i][i] = -1/d;
//                   after the last pivot the block holds -inverse and is
//                   negated;
//   PRE (o, h, rc): with A = [o, o+h) holding Ainv and C = [o+h, o+h+rc):
//                   T = Ainv B, C -= B^T T, B <- T   (B = M[A][C]);
//   POST (o, h, rc): with C holding Sinv:
//                   T = W Sinv, A += T W^T, B <- -T, B^T <- -T^T.
// The identity padding of the TPU kernel never couples to the n x n block
// (its products with the block are exact zeros), so it is not stored; the
// event list keeps the padded recursion's split points, which fix the
// rounding.  The 1e-12 pivot floor is the TPU kernel's; a NaN pivot stays
// NaN (as jnp.maximum keeps it) instead of being floored.
// What bounds it on the H100: the serial pivot chain (two block-wide
// barriers per pivot, every element loaded and stored through shared
// memory, an integer division per element) and, for the base-8
// recursion, leaves too small to occupy 512 threads.  The matrix and the
// one h x rc panel scratch stay in shared memory whenever they fit
// (n <= ~215 for the recursion, ~236 for one full sweep), with an odd row
// stride so that column walks hit distinct banks; larger n work in place
// in the output buffer with a global scratch.  Every product accumulates
// in f32 with FMA (no TF32), as the TPU kernel's combine matmuls run at
// Precision.HIGHEST.
//
// sweep_regs_kernel: a schedule that is one SWEEP of all n pivots (the
// fit's "sweep_full", n <= 224).  Its bound is the same
// serial chain of n pivots, each an n x n rank-1 update; the design cuts
// what each pivot costs.  One thread block of TY x TX threads owns one
// matrix and holds it in registers: thread (ty, tx) owns rows ty + TY a
// (a < RA) and columns tx + TX c (c < CA).  Shared memory holds only the
// pivot's row and column (unscaled) and its d and 1/d, double-buffered:
// the owners of row, column and diagonal of pivot i+1 publish them right
// after applying pivot i, so each pivot costs one barrier.  Pivot i lives
// in row slot i / TY and column slot i / TX; the pivot loop is unrolled
// over the row slots by template recursion, so that every slot index is a
// compile-time constant and the matrix never leaves the registers.  The
// arithmetic is sweep_kernel's SWEEP element for element (the row scaled
// by 1/d, the rank-1 update as one FMA, the column scaled after it, the
// logdet summed by one thread in pivot order), so both give the same
// bits.  Entries beyond n hold zeros and never feed one below n.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB opt-in limit per block
constexpr int kSweep = 0, kPre = 1, kPost = 2;

__host__ __device__ inline int smem_stride(int n) { return n | 1; }

__host__ inline size_t smem_bytes(int n, int tsize) {
    return ((size_t)2 * n + (size_t)n * smem_stride(n) + tsize)
           * sizeof(float);
}

__device__ inline float floor_pivot(float d) {
    return isnan(d) ? d : fmaxf(d, 1e-12f);
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ K, int n,
             const int4* __restrict__ events, int n_events, int tsize,
             int use_smem,
             float* __restrict__ Kinv,       // (B, n, n)
             float* __restrict__ logdet,     // (B,)
             float* __restrict__ t_scratch)  // (B, tsize) or null (smem)
{
    extern __shared__ float smem[];
    const size_t nn = (size_t)n * n;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    float* rowbuf = smem;            // (n) pivot row / d
    float* colbuf = smem + n;        // (n) pivot column
    const int ld = use_smem ? smem_stride(n) : n;
    float* M = use_smem ? smem + 2 * n : Kinv + b * nn;
    float* T = use_smem ? M + (size_t)n * ld : t_scratch + (size_t)b * tsize;

    const float* Kb = K + b * nn;
    for (size_t t = tid; t < nn; t += nt)
        M[(t / n) * ld + t % n] = Kb[t];
    __syncthreads();

    float ld_acc = 0.0f;  // meaningful in thread 0
    for (int e = 0; e < n_events; ++e) {
        const int4 ev = events[e];
        const int o = ev.y;
        if (ev.x == kSweep) {
            const int r = ev.z;
            for (int p = 0; p < r; ++p) {
                const int i = o + p;
                const float d = floor_pivot(M[(size_t)i * ld + i]);
                const float idv = 1.0f / d;
                if (tid == 0) ld_acc += logf(d);
                for (int k = tid; k < r; k += nt) {
                    rowbuf[k] = M[(size_t)i * ld + o + k] * idv;
                    colbuf[k] = M[(size_t)(o + k) * ld + i];
                }
                __syncthreads();
                for (int t = tid; t < r * r; t += nt) {
                    const int j = t / r, k = t % r;
                    float* m = &M[(size_t)(o + j) * ld + o + k];
                    if (j == p)
                        *m = (k == p) ? -idv : rowbuf[k];
                    else if (k == p)
                        *m = colbuf[j] * idv;
                    else
                        *m = *m - colbuf[j] * rowbuf[k];
                }
                __syncthreads();
            }
            for (int t = tid; t < r * r; t += nt) {
                float* m = &M[(size_t)(o + t / r) * ld + o + t % r];
                *m = -*m;
            }
            __syncthreads();
            continue;
        }
        const int h = ev.z, rc = ev.w, c0 = o + h;
        const int hr = h * rc;
        if (ev.x == kPre) {
            // T = Ainv B
            for (int t = tid; t < hr; t += nt) {
                const int i = t / rc, k = t % rc;
                float acc = 0.0f;
                for (int l = 0; l < h; ++l)
                    acc = fmaf(M[(size_t)(o + i) * ld + o + l],
                               M[(size_t)(o + l) * ld + c0 + k], acc);
                T[t] = acc;
            }
            __syncthreads();
            // S = C - B^T T
            for (int t = tid; t < rc * rc; t += nt) {
                const int j = t / rc, k = t % rc;
                float acc = 0.0f;
                for (int i = 0; i < h; ++i)
                    acc = fmaf(M[(size_t)(o + i) * ld + c0 + j], T[i * rc + k],
                               acc);
                float* m = &M[(size_t)(c0 + j) * ld + c0 + k];
                *m = *m - acc;
            }
            __syncthreads();
            // B <- W
            for (int t = tid; t < hr; t += nt)
                M[(size_t)(o + t / rc) * ld + c0 + t % rc] = T[t];
            __syncthreads();
        } else {
            // T = W Sinv
            for (int t = tid; t < hr; t += nt) {
                const int i = t / rc, k = t % rc;
                float acc = 0.0f;
                for (int j = 0; j < rc; ++j)
                    acc = fmaf(M[(size_t)(o + i) * ld + c0 + j],
                               M[(size_t)(c0 + j) * ld + c0 + k], acc);
                T[t] = acc;
            }
            __syncthreads();
            // A += T W^T
            for (int t = tid; t < h * h; t += nt) {
                const int i = t / h, l = t % h;
                float acc = 0.0f;
                for (int k = 0; k < rc; ++k)
                    acc = fmaf(T[i * rc + k], M[(size_t)(o + l) * ld + c0 + k],
                               acc);
                float* m = &M[(size_t)(o + i) * ld + o + l];
                *m = *m + acc;
            }
            __syncthreads();
            // B <- -T, B^T <- -T^T
            for (int t = tid; t < hr; t += nt) {
                const int i = t / rc, k = t % rc;
                M[(size_t)(o + i) * ld + c0 + k] = -T[t];
                M[(size_t)(c0 + k) * ld + o + i] = -T[t];
            }
            __syncthreads();
        }
    }

    if (use_smem) {
        float* out = Kinv + b * nn;
        for (size_t t = tid; t < nn; t += nt)
            out[t] = M[(t / n) * ld + t % n];
    }
    if (tid == 0) logdet[b] = ld_acc;
}

// ---- the one-sweep route: the matrix in registers ----

template <int TY, int TX, int RA, int CA>
struct RegsShared {
    float row[2][TX * CA];  // pivot row, unscaled
    float col[2][TY * RA];  // pivot column, unscaled
    float piv[2][2];        // the pivot's d and 1/d
};

// The largest order an instance holds.
template <int TY, int TX, int RA, int CA>
constexpr int regs_limit() {
    return TY * RA < TX * CA ? TY * RA : TX * CA;
}

// Thread (ty, tx)'s part of pivot i's row (from row slot A, if the thread
// owns row i) and column (from column slot C, if it owns column i) into
// buffer q; the owner of both also writes d = max(M[i][i], 1e-12) and 1/d.
template <int TY, int TX, int RA, int CA>
__device__ __forceinline__ void publish(const float (&m)[RA][CA], int A,
                                        int C, bool own_row, bool own_col,
                                        int ty, int tx, int q,
                                        RegsShared<TY, TX, RA, CA>& s) {
    if (own_row) {
#pragma unroll
        for (int c = 0; c < CA; ++c) s.row[q][tx + TX * c] = m[A][c];
        if (own_col) {
            const float d = floor_pivot(m[A][C]);
            s.piv[q][0] = d;
            s.piv[q][1] = 1.0f / d;
        }
    }
    if (own_col) {
#pragma unroll
        for (int a = 0; a < RA; ++a) s.col[q][ty + TY * a] = m[a][C];
    }
}

// Pivots TY A .. TY A + TY - 1 (those below n), then the next row slot.
// They share row slot A and column slot A / (TX / TY).
template <int TY, int TX, int RA, int CA, int A>
__device__ __forceinline__ void sweep_row_slot(
        float (&m)[RA][CA], int n, int ty, int tx, float& ld,
        RegsShared<TY, TX, RA, CA>& s) {
    if constexpr (A < RA) {
        constexpr int Q = TX / TY, C = A / Q;
        // row and column slot of pivot TY (A + 1), clamped where no such
        // pivot is below n
        constexpr int A1 = A + 1 < RA ? A + 1 : A;
        constexpr int C1 = (A + 1) / Q < CA ? (A + 1) / Q : C;
        const int tn = min(TY, n - TY * A);
        for (int t = 0; t < tn; ++t) {
            const int i = TY * A + t, p = i & 1;
            const int cx = TY * (A % Q) + t;  // the tx that owns column i
            const bool own_col = tx == cx;
            const float idv = s.piv[p][1];
            if (threadIdx.x == 0) ld += logf(s.piv[p][0]);
            float rv[CA];
#pragma unroll
            for (int c = 0; c < CA; ++c) rv[c] = s.row[p][tx + TX * c] * idv;
            // column i in the same pass: fma(-M[j][i], -1/d, -0) is the
            // product M[j][i] * (1/d), rounded once, signed zeros included
            const float rc = own_col ? -idv : rv[C];
#pragma unroll
            for (int a = 0; a < RA; ++a) {
                const float cv = s.col[p][ty + TY * a];
#pragma unroll
                for (int c = 0; c < CA; ++c) {
                    if (c == C)
                        m[a][c] = fmaf(-cv, rc, own_col ? -0.0f : m[a][c]);
                    else
                        m[a][c] = fmaf(-cv, rv[c], m[a][c]);
                }
            }
            if (ty == t) {
#pragma unroll
                for (int c = 0; c < CA; ++c) m[A][c] = rv[c];
                if (own_col) m[A][C] = -idv;
            }
            if (i + 1 < n) {
                if (t + 1 < TY)
                    publish(m, A, C, ty == t + 1, tx == cx + 1, ty, tx, p ^ 1,
                            s);
                else
                    publish(m, A1, C1, ty == 0, tx == TY * ((A + 1) % Q), ty,
                            tx, p ^ 1, s);
            }
            __syncthreads();
        }
        sweep_row_slot<TY, TX, RA, CA, A + 1>(m, n, ty, tx, ld, s);
    }
}

template <int TY, int TX, int RA, int CA>
__global__ void __launch_bounds__(TY * TX)
sweep_regs_kernel(const float* __restrict__ K, int n,
                  float* __restrict__ Kinv,    // (B, n, n)
                  float* __restrict__ logdet)  // (B,)
{
    static_assert(TX % TY == 0, "a pivot's column slot follows its row slot");
    __shared__ RegsShared<TY, TX, RA, CA> s;
    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    const size_t nn = (size_t)n * n;
    const float* Kb = K + blockIdx.x * nn;
    float m[RA][CA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int j = ty + TY * a;
#pragma unroll
        for (int c = 0; c < CA; ++c) {
            const int k = tx + TX * c;
            m[a][c] = (j < n && k < n) ? Kb[(size_t)j * n + k] : 0.0f;
        }
    }
    publish(m, 0, 0, ty == 0, tx == 0, ty, tx, 0, s);
    __syncthreads();
    float ld = 0.0f;  // meaningful in thread 0
    sweep_row_slot<TY, TX, RA, CA, 0>(m, n, ty, tx, ld, s);
    float* out = Kinv + blockIdx.x * nn;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int j = ty + TY * a;
#pragma unroll
        for (int c = 0; c < CA; ++c) {
            const int k = tx + TX * c;
            if (j < n && k < n) out[(size_t)j * n + k] = -m[a][c];
        }
    }
    if (threadIdx.x == 0) logdet[blockIdx.x] = ld;
}

template <int TY, int TX, int RA, int CA>
int launch_regs(const float* K, float* Kinv, float* logdet, int B, int n,
                cudaStream_t stream) {
    if (n < 1 || n > regs_limit<TY, TX, RA, CA>())
        return (int)cudaErrorInvalidValue;
    sweep_regs_kernel<TY, TX, RA, CA><<<B, TY * TX, 0, stream>>>(
        K, n, Kinv, logdet);
    return (int)cudaGetLastError();
}

// The instances, smallest first: the fit's coarse first stage (n = 50;
// 16 x 16 threads beat 8 x 16, 16 x 32 and 8 x 8 there) and its full
// buffer (n = 200; 14 x 7 slots take 128 registers and spill nothing)
// (probe_sweep.py).
struct RegsInstance {
    int limit;
    int (*launch)(const float*, float*, float*, int, int, cudaStream_t);
};
constexpr RegsInstance kRegsInstances[] = {
    {regs_limit<16, 16, 4, 4>(), launch_regs<16, 16, 4, 4>},
    {regs_limit<16, 32, 14, 7>(), launch_regs<16, 32, 14, 7>},
};
constexpr int kNumRegsInstances =
    sizeof(kRegsInstances) / sizeof(kRegsInstances[0]);

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Whether the matrix (order n) and its panel scratch (tsize floats) are
// kept in shared memory (1), or the kernel works in place in Kinv with a
// (B, tsize) global scratch (0).
int sweep_uses_smem(int n, int tsize) {
    return smem_bytes(n, tsize) <= (size_t)kMaxSmemBytes ? 1 : 0;
}

// (K^{-1}, logdet K) of a batch K (B, n, n), f32, contiguous.  events:
// device array of n_events int4 (kind, o, a, b) from `schedule`; tsize:
// the largest h * rc of its PRE/POST events; t_scratch: (B, tsize) when
// sweep_uses_smem(n, tsize) is 0, else ignored.
int sweep_launch(const float* K, float* Kinv, float* logdet,
                 const int* events, int n_events, float* t_scratch, int B,
                 int n, int tsize, void* stream) {
    const int use_smem = sweep_uses_smem(n, tsize);
    const size_t smem = use_smem ? smem_bytes(n, tsize)
                                 : (size_t)2 * n * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        K, n, reinterpret_cast<const int4*>(events), n_events, tsize,
        use_smem, Kinv, logdet, t_scratch);
    return (int)cudaGetLastError();
}

// The largest order instance `instance` of sweep_regs_kernel holds, or 0
// past the last instance.
int sweep_regs_limit(int instance) {
    return instance >= 0 && instance < kNumRegsInstances
               ? kRegsInstances[instance].limit : 0;
}

// (K^{-1}, logdet K) of a batch K (B, n, n), f32, contiguous, by one sweep
// of all n pivots with the matrix in registers, through instance
// `instance` (n <= sweep_regs_limit(instance), else cudaErrorInvalidValue).
int sweep_regs_launch(const float* K, float* Kinv, float* logdet, int B,
                      int n, int instance, void* stream) {
    if (instance < 0 || instance >= kNumRegsInstances)
        return (int)cudaErrorInvalidValue;
    return kRegsInstances[instance].launch(K, Kinv, logdet, B, n,
                                           (cudaStream_t)stream);
}

}  // extern "C"
