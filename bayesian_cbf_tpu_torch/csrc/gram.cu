// Fused masked MVGP Gram, batched, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/gram.py
// `_gram_kernel` (`fused_gram_kb`):
//
//   out[i][j] = s exp(-1/2 sum_a (Xs[i][a] - Xs[j][a])^2) (UHB[i] . UHB[j])
//               m_i m_j + (1 - m_i) [i == j] + jitter m_i [i == j]
//
// for Xs = X / lengthscale (K, n), UHB = UH chol(B) (K, 1+m), the row mask
// m (K,) and the outputscale s.  Distances use the exact per-dimension
// differences, never |a|^2 + |b|^2 - 2 a.b, which cancels in f32 for the
// near-duplicate consecutive states of a training buffer.
//
// What bounds it on the H100: writing the (B, K, K) output (41 MB at
// B = 256, K = 200); each entry costs n + (1+m) multiply-adds and one exp.
// The design gives each thread block a 32 x 32 output tile of one matrix:
// the tile's 32 + 32 rows of Xs and UHB and their masks are staged in
// shared memory (row stride 17, conflict-free), and a warp writes 32
// consecutive entries of an output row (coalesced).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;
constexpr int kMaxDim = 16;
constexpr int kStride = kMaxDim + 1;

__global__ void __launch_bounds__(kTile * kRowsPerPass)
gram_kernel(const float* __restrict__ Xs,    // (B, K, n)
            const float* __restrict__ UHB,   // (B, K, mh)
            const float* __restrict__ mask,  // (B, K)
            const float* __restrict__ scale, // (B,) outputscale
            float jitter, int K, int n, int mh,
            float* __restrict__ out)         // (B, K, K)
{
    __shared__ float xi[kTile][kStride], xj[kTile][kStride];
    __shared__ float ui[kTile][kStride], uj[kTile][kStride];
    __shared__ float mi[kTile], mj[kTile];
    const int b = blockIdx.z;
    const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTile + tx;
    const float* Xb = Xs + (size_t)b * K * n;
    const float* Ub = UHB + (size_t)b * K * mh;
    const float* mb = mask + (size_t)b * K;

    for (int t = tid; t < kTile * n; t += kTile * kRowsPerPass) {
        const int r = t / n, a = t % n;
        xi[r][a] = (i0 + r < K) ? Xb[(size_t)(i0 + r) * n + a] : 0.0f;
        xj[r][a] = (j0 + r < K) ? Xb[(size_t)(j0 + r) * n + a] : 0.0f;
    }
    for (int t = tid; t < kTile * mh; t += kTile * kRowsPerPass) {
        const int r = t / mh, c = t % mh;
        ui[r][c] = (i0 + r < K) ? Ub[(size_t)(i0 + r) * mh + c] : 0.0f;
        uj[r][c] = (j0 + r < K) ? Ub[(size_t)(j0 + r) * mh + c] : 0.0f;
    }
    if (tid < kTile) {
        mi[tid] = (i0 + tid < K) ? mb[i0 + tid] : 0.0f;
        mj[tid] = (j0 + tid < K) ? mb[j0 + tid] : 0.0f;
    }
    __syncthreads();

    const int j = j0 + tx;
    if (j >= K) return;
    const float s = scale[b];
    float* ob = out + (size_t)b * K * K;
    for (int r = ty; r < kTile; r += kRowsPerPass) {
        const int i = i0 + r;
        if (i >= K) break;
        float d2 = 0.0f;
        for (int a = 0; a < n; ++a) {
            const float diff = xi[r][a] - xj[tx][a];
            d2 = fmaf(diff, diff, d2);
        }
        float ubu = 0.0f;
        for (int c = 0; c < mh; ++c) ubu = fmaf(ui[r][c], uj[tx][c], ubu);
        const float rbf = s * expf(-0.5f * d2);
        float v = rbf * ubu * (mi[r] * mj[tx]);
        if (i == j) {
            v = v + (1.0f - mi[r]);
            v = v + jitter * mi[r];
        }
        ob[(size_t)i * K + j] = v;
    }
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// The masked Gram (B, K, K) of Xs (B, K, n), UHB (B, K, mh), mask (B, K),
// outputscale (B,); all f32, contiguous; 1 <= n, mh <= 16.
int gram_launch(const float* Xs, const float* UHB, const float* mask,
                const float* outputscale, float jitter, float* out, int B,
                int K, int n, int mh, void* stream) {
    if (n < 1 || n > kMaxDim || mh < 1 || mh > kMaxDim) return -1;
    const int tiles = (K + kTile - 1) / kTile;
    dim3 grid(tiles, tiles, B), block(kTile, kRowsPerPass);
    gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        Xs, UHB, mask, outputscale, jitter, K, n, mh, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
