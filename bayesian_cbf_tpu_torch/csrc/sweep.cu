// Batched inverse + logdet by recursive Schur complements over
// symmetric-sweep base blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/pallas_sweep.py
// `batched_kinv_logdet` (`_kernel`, `_inv_logdet`, `_sweep_block`): the
// TPU body recurses over VMEM values, splitting each diagonal block of
// the identity-padded matrix at h = (s // (2 base)) base, combining with
// f32 matmuls and inverting base x base leaves with the sweep operator.
//
// Here one thread block owns one matrix and runs the recursion in place.
// The host (ops/sweep_kernels.py `schedule`) flattens the recursion into a
// list of events, so the kernel is a loop over three kinds of step:
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
//
// What bounds it on the H100: the serial pivot chain (two block-wide
// barriers per pivot) and, for the base-8 recursion, leaves too small to
// occupy 512 threads.  The design keeps the matrix and the one h x rc
// panel scratch in shared memory whenever they fit (n <= ~215 for the
// recursion, ~236 for one full sweep; the main path's n = 200 and n = 50
// do), with an odd row stride so that column walks hit distinct banks;
// larger n work in place in the output buffer with a global scratch.
// Every product accumulates in f32 with FMA (no TF32), as the TPU
// kernel's combine matmuls run at Precision.HIGHEST.

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

}  // extern "C"
