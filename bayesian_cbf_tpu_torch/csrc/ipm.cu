// Whole-batch SOCP interior-point solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bayesian_cbf_tpu/ops/pallas_ipm.py
// `_ipm_kernel` (batched_ipm): every Mehrotra predictor-corrector
// iteration of the Nesterov-Todd scaled IPM on zero-padded cone blocks,
// for a whole batch of small problems, in one launch.  It follows
// `_solve_padded_plain` (bayesian_cbf_tpu/solvers/socp.py) step for step:
// the same 1e-14 guards, the 1e-12 tr(H) regularisation of the KKT
// normal matrix, sigma = clip((mu_aff / mu)^3, 0, 1), the 0.99 step rule,
// per-problem `done = score < tol` and non-finite-step rejection, and the
// final best-or-current choice.
//
// Mapping: one thread per problem, as the TPU kernel puts the batch on the
// vector lanes.  NX (variables), C (cones) and D (padded cone dimension)
// are template parameters, so every per-cone and per-variable loop unrolls
// and the state lives in registers.  All arrays are batch-fastest
// ((..., B) layout), so neighbouring threads read neighbouring addresses.
//
// What bounds it on the H100: latency of a long dependent chain of scalar
// f32 operations per thread (two KKT solves, the NT scaling and the step
// length search per iteration), and register pressure — the iterate, its
// best copy and the scaling state are several hundred floats at
// (4, 4, 4), so the compiler spills some of them to local memory (L1).
// A padded 1-dimensional cone (the nonnegative ray) carries zero rows of G
// and h beyond its head; its tail coordinates start at zero and stay there
// through the same arithmetic, exactly as in the plain version.
// The problem data G and h are read from global memory through the
// read-only path on each use instead of being held in registers.  The
// launch has ceil(B / 128) blocks; at B = 256 only two SMs are busy,
// which is the price of keeping each problem's chain in one thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-14f;
constexpr float kBig = 1e10f;
constexpr int kThreads = 128;

template <int D>
__device__ __forceinline__ float jdot(const float* U) {
    float a = U[0] * U[0];
#pragma unroll
    for (int d = 1; d < D; ++d) a -= U[d] * U[d];
    return a;
}

template <int D>
__device__ __forceinline__ void jmul(const float* U, const float* V, float* out) {
    float h = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) h += U[d] * V[d];
#pragma unroll
    for (int d = 1; d < D; ++d) out[d] = U[0] * V[d] + V[0] * U[d];
    out[0] = h;
}

template <int D>
__device__ __forceinline__ void jinv_mul(const float* L, const float* V, float* out) {
    float det = jdot<D>(L);
    det = fabsf(det) < kEps ? kEps : det;
    const float l0 = fabsf(L[0]) < kEps ? kEps : L[0];
    float num = L[0] * V[0];
#pragma unroll
    for (int d = 1; d < D; ++d) num -= L[d] * V[d];
    const float u0 = num / det;
#pragma unroll
    for (int d = 1; d < D; ++d) out[d] = (V[d] - u0 * L[d]) / l0;
    out[0] = u0;
}

template <int D>
__device__ __forceinline__ void nt_scaling(const float* S, const float* Z, float* Wb,
                                           float& eta) {
    const float ss = sqrtf(fmaxf(jdot<D>(S), kEps));
    const float zz = sqrtf(fmaxf(jdot<D>(Z), kEps));
    float sz = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) sz += (S[d] / ss) * (Z[d] / zz);
    const float gam = sqrtf(fmaxf((1.0f + sz) * 0.5f, kEps));
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float zb = Z[d] / zz;
        Wb[d] = (S[d] / ss + (d == 0 ? zb : -zb)) / (2.0f * gam);
    }
    eta = sqrtf(ss / zz);
}

// W V per cone, Wbar = [[w0, w1^T], [w1, I + w1 w1^T / (1 + w0)]]
template <int D>
__device__ __forceinline__ void w_mul(const float* Wb, float eta, const float* V,
                                      float* out) {
    float dot = 0.0f;
#pragma unroll
    for (int d = 1; d < D; ++d) dot += Wb[d] * V[d];
    const float head = Wb[0] * V[0] + dot;
    const float q = dot / (1.0f + Wb[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) out[d] = eta * (V[0] * Wb[d] + V[d] + Wb[d] * q);
    out[0] = eta * head;
}

// W^{-1} V = J Wbar J V / eta
template <int D>
__device__ __forceinline__ void winv_mul(const float* Wb, float eta, const float* V,
                                         float* out) {
    float JV[D];
#pragma unroll
    for (int d = 0; d < D; ++d) JV[d] = d == 0 ? V[d] : -V[d];
    w_mul<D>(Wb, 1.0f, JV, out);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = (d == 0 ? out[d] : -out[d]) / eta;
}

// W^{-2} V = eta^{-2} (2 (J wbar)(J wbar)^T - J) V
template <int D>
__device__ __forceinline__ void winv2_mul(const float* Wb, float eta, const float* V,
                                          float* out) {
    float dots = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) dots += (d == 0 ? Wb[d] : -Wb[d]) * V[d];
    const float e2 = eta * eta;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float jw = d == 0 ? Wb[d] : -Wb[d];
        const float jv = d == 0 ? V[d] : -V[d];
        out[d] = (2.0f * jw * dots - jv) / e2;
    }
}

// largest t in [0, BIG] with P + t Dd in the cone (P interior)
template <int D>
__device__ __forceinline__ float max_step(const float* P, const float* Dd) {
    const float a = jdot<D>(Dd);
    float b = P[0] * Dd[0];
#pragma unroll
    for (int d = 1; d < D; ++d) b -= P[d] * Dd[d];
    b *= 2.0f;
    const float cq = fmaxf(jdot<D>(P), kEps);
    const float disc = b * b - 4.0f * a * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float denom = fabsf(a) > kEps ? 2.0f * a : kEps;
    const float r1 = (-b - sq) / denom;
    const float r2 = (-b + sq) / denom;
    const float lo = fminf(r1, r2), hi = fmaxf(r1, r2);
    const float root = lo > 0.0f ? lo : (hi > 0.0f ? hi : kBig);
    const float lin_root = b < 0.0f ? -cq / b : kBig;
    const float t_quad = fabsf(a) > kEps ? (disc > 0.0f ? root : kBig) : lin_root;
    const float t_head = Dd[0] < 0.0f ? -P[0] / Dd[0] : kBig;
    return fminf(fmaxf(fminf(t_quad, t_head), 0.0f), kBig);
}

template <int NX, int C, int D>
struct Problem {
    const float* __restrict__ G;  // (C, D, NX, B)
    const float* __restrict__ h;  // (C, D, B)
    const float* __restrict__ c;  // (NX, B)
    int B, p;
    __device__ __forceinline__ float g(int ci, int d, int i) const {
        return __ldg(G + ((size_t)((ci * D + d) * NX + i)) * B + p);
    }
    __device__ __forceinline__ float hv(int ci, int d) const {
        return __ldg(h + ((size_t)(ci * D + d)) * B + p);
    }
    __device__ __forceinline__ float cv(int i) const {
        return __ldg(c + (size_t)i * B + p);
    }
};

template <int NX, int C, int D>
__device__ __forceinline__ float residuals(const Problem<NX, C, D>& P, const float* x,
                                           const float (*S)[D], const float (*Z)[D],
                                           float* rx, float (*rz)[D], float hnorm,
                                           float cnorm) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        float a = P.cv(i);
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
            for (int d = 0; d < D; ++d) a += P.g(ci, d, i) * Z[ci][d];
        rx[i] = a;
    }
    float rzn = 0.0f, sz = 0.0f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            float a = 0.0f;
#pragma unroll
            for (int i = 0; i < NX; ++i) a += P.g(ci, d, i) * x[i];
            a = a + S[ci][d] - P.hv(ci, d);
            rz[ci][d] = a;
            rzn += a * a;
            sz += S[ci][d] * Z[ci][d];
        }
    float rxn = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) rxn += rx[i] * rx[i];
    const float mu = fabsf(sz) / (float)C;
    return fmaxf(fmaxf(sqrtf(rzn) / hnorm, sqrtf(rxn) / cnorm), mu);
}

template <int NX, int C, int D>
__global__ void __launch_bounds__(kThreads)
ipm_kernel(const float* __restrict__ cT, const float* __restrict__ GT,
           const float* __restrict__ hT, const float* __restrict__ sxT,
           const float* __restrict__ sST, const float* __restrict__ sZT,
           float* __restrict__ xT, float* __restrict__ ST, float* __restrict__ ZT,
           int B, int iters, float tol) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= B) return;
    const Problem<NX, C, D> P{GT, hT, cT, B, p};
    const float nu = (float)C;

    float hn = 0.0f, cn = 0.0f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
        for (int d = 0; d < D; ++d) hn += P.hv(ci, d) * P.hv(ci, d);
#pragma unroll
    for (int i = 0; i < NX; ++i) cn += P.cv(i) * P.cv(i);
    const float hnorm = fmaxf(1.0f, sqrtf(hn));
    const float cnorm = fmaxf(1.0f, sqrtf(cn));

    float x[NX], S[C][D], Z[C][D];
    float bx[NX], bS[C][D], bZ[C][D];
    float bscore = INFINITY;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        x[i] = sxT[(size_t)i * B + p];
        bx[i] = 0.0f;
    }
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            S[ci][d] = sST[(size_t)(ci * D + d) * B + p];
            Z[ci][d] = sZT[(size_t)(ci * D + d) * B + p];
            bS[ci][d] = d == 0 ? 1.0f : 0.0f;
            bZ[ci][d] = d == 0 ? 1.0f : 0.0f;
        }

    float rx[NX], rz[C][D];
    for (int it = 0; it < iters; ++it) {
        const float score = residuals<NX, C, D>(P, x, S, Z, rx, rz, hnorm, cnorm);
        if (score < bscore) {
#pragma unroll
            for (int i = 0; i < NX; ++i) bx[i] = x[i];
#pragma unroll
            for (int ci = 0; ci < C; ++ci)
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    bS[ci][d] = S[ci][d];
                    bZ[ci][d] = Z[ci][d];
                }
        }
        bscore = fminf(score, bscore);
        const bool done = score < tol;

        float mu = 0.0f;
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
            for (int d = 0; d < D; ++d) mu += S[ci][d] * Z[ci][d];
        mu /= nu;

        float Wb[C][D], eta[C], lam[C][D], jg[C][NX];
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
            nt_scaling<D>(S[ci], Z[ci], Wb[ci], eta[ci]);
            w_mul<D>(Wb[ci], eta[ci], Z[ci], lam[ci]);
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                float a = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d)
                    a += (d == 0 ? Wb[ci][d] : -Wb[ci][d]) * P.g(ci, d, i);
                jg[ci][i] = a;
            }
        }

        // H = G^T W^{-2} G (+ 1e-12 tr H I), lower triangle, then Cholesky
        float Lf[NX][NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j) {
                float a = 0.0f;
#pragma unroll
                for (int ci = 0; ci < C; ++ci) {
                    const float e2 = eta[ci] * eta[ci];
#pragma unroll
                    for (int d = 0; d < D; ++d) {
                        const float jw = d == 0 ? Wb[ci][d] : -Wb[ci][d];
                        const float gj = P.g(ci, d, j);
                        const float w2g = (2.0f * jw * jg[ci][j] - (d == 0 ? gj : -gj)) / e2;
                        a += P.g(ci, d, i) * w2g;
                    }
                }
                Lf[i][j] = a;
            }
        float trH = 0.0f;
#pragma unroll
        for (int i = 0; i < NX; ++i) trH += Lf[i][i];
#pragma unroll
        for (int i = 0; i < NX; ++i) Lf[i][i] += 1e-12f * trH;
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j) {
                float acc = Lf[i][j];
#pragma unroll
                for (int k = 0; k < j; ++k) acc -= Lf[i][k] * Lf[j][k];
                Lf[i][j] = (i == j) ? sqrtf(fmaxf(acc, kEps)) : acc / Lf[j][j];
            }

        // KKT solve: W dz + W^{-T} ds = -Dscaled
        auto kkt_solve = [&](const float (*Ds)[D], float* dx, float (*dS)[D],
                             float (*dZ)[D]) {
            float rhs_cd[C][D], w2r[C][D];
#pragma unroll
            for (int ci = 0; ci < C; ++ci) {
                float wd[D];
                w_mul<D>(Wb[ci], eta[ci], Ds[ci], wd);
#pragma unroll
                for (int d = 0; d < D; ++d) rhs_cd[ci][d] = rz[ci][d] - wd[d];
                winv2_mul<D>(Wb[ci], eta[ci], rhs_cd[ci], w2r[ci]);
            }
            float y[NX];
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                float a = 0.0f;
#pragma unroll
                for (int ci = 0; ci < C; ++ci)
#pragma unroll
                    for (int d = 0; d < D; ++d) a += P.g(ci, d, i) * w2r[ci][d];
                float acc = -rx[i] - a;
#pragma unroll
                for (int k = 0; k < i; ++k) acc -= Lf[i][k] * y[k];
                y[i] = acc / Lf[i][i];
            }
#pragma unroll
            for (int i = NX - 1; i >= 0; --i) {
                float acc = y[i];
#pragma unroll
                for (int k = i + 1; k < NX; ++k) acc -= Lf[k][i] * dx[k];
                dx[i] = acc / Lf[i][i];
            }
#pragma unroll
            for (int ci = 0; ci < C; ++ci) {
                float t[D];
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    float gdx = 0.0f;
#pragma unroll
                    for (int i = 0; i < NX; ++i) gdx += P.g(ci, d, i) * dx[i];
                    dS[ci][d] = -rz[ci][d] - gdx;
                    t[d] = gdx + rhs_cd[ci][d];
                }
                winv2_mul<D>(Wb[ci], eta[ci], t, dZ[ci]);
            }
        };

        // affine (predictor) direction
        float dxa[NX], dSa[C][D], dZa[C][D];
        kkt_solve(lam, dxa, dSa, dZa);
        float amin = kBig;
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
            amin = fminf(amin, max_step<D>(S[ci], dSa[ci]));
            amin = fminf(amin, max_step<D>(Z[ci], dZa[ci]));
        }
        const float alpha_a = fminf(1.0f, amin);
        float mu_a = 0.0f;
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
            for (int d = 0; d < D; ++d)
                mu_a += (S[ci][d] + alpha_a * dSa[ci][d]) * (Z[ci][d] + alpha_a * dZa[ci][d]);
        mu_a /= nu;
        const float ratio = mu_a / fmaxf(mu, kEps);
        const float sigma = fminf(fmaxf(ratio * ratio * ratio, 0.0f), 1.0f);

        // corrector
        float Dc[C][D];
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
            float a1[D], a2[D], corr[D], ll[D], rs[D];
            winv_mul<D>(Wb[ci], eta[ci], dSa[ci], a1);
            w_mul<D>(Wb[ci], eta[ci], dZa[ci], a2);
            jmul<D>(a1, a2, corr);
            jmul<D>(lam[ci], lam[ci], ll);
#pragma unroll
            for (int d = 0; d < D; ++d)
                rs[d] = ll[d] + corr[d] - (d == 0 ? sigma * mu : 0.0f);
            jinv_mul<D>(lam[ci], rs, Dc[ci]);
        }
        float dx[NX], dS[C][D], dZ[C][D];
        kkt_solve(Dc, dx, dS, dZ);
        amin = kBig;
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
            amin = fminf(amin, max_step<D>(S[ci], dS[ci]));
            amin = fminf(amin, max_step<D>(Z[ci], dZ[ci]));
        }
        const float alpha = fminf(0.99f * amin, 1.0f);

        float xn[NX], Sn[C][D], Zn[C][D];
        bool finite = true;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            xn[i] = x[i] + alpha * dx[i];
            finite = finite && isfinite(xn[i]);
        }
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
            for (int d = 0; d < D; ++d) {
                Sn[ci][d] = S[ci][d] + alpha * dS[ci][d];
                Zn[ci][d] = Z[ci][d] + alpha * dZ[ci][d];
                finite = finite && isfinite(Sn[ci][d]) && isfinite(Zn[ci][d]);
            }
        if (!(done || !finite)) {
#pragma unroll
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
#pragma unroll
            for (int ci = 0; ci < C; ++ci)
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    S[ci][d] = Sn[ci][d];
                    Z[ci][d] = Zn[ci][d];
                }
        }
    }

    const float score = residuals<NX, C, D>(P, x, S, Z, rx, rz, hnorm, cnorm);
    const bool better = score < bscore;
#pragma unroll
    for (int i = 0; i < NX; ++i) xT[(size_t)i * B + p] = better ? x[i] : bx[i];
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            ST[(size_t)(ci * D + d) * B + p] = better ? S[ci][d] : bS[ci][d];
            ZT[(size_t)(ci * D + d) * B + p] = better ? Z[ci][d] : bZ[ci][d];
        }
}

template <int NX, int C, int D>
int launch(const float* c, const float* G, const float* h, const float* sx,
           const float* sS, const float* sZ, float* x, float* S, float* Z, int B,
           int iters, float tol, cudaStream_t stream) {
    const int blocks = (B + kThreads - 1) / kThreads;
    ipm_kernel<NX, C, D><<<blocks, kThreads, 0, stream>>>(c, G, h, sx, sS, sZ, x, S, Z,
                                                         B, iters, tol);
    return (int)cudaGetLastError();
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// Batch-fastest layout: c (nx, B), G (C, d, nx, B), h / S / Z (C, d, B).
// Instantiated shapes (nx, C, d): (4, 4, 4), the unicycle controller's
// [u (2), relax, t] with four cones of dimension 4; (4, 3, 3), the
// pendulum controller's [u, delta, y, s] with cones of dimensions (3, 3, 1)
// padded to 3.  Returns cudaErrorInvalidValue for any other shape.
int ipm_launch(const float* c, const float* G, const float* h, const float* sx,
               const float* sS, const float* sZ, float* x, float* S, float* Z,
               int B, int nx, int C, int d, int iters, float tol, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nx == 4 && C == 4 && d == 4)
        return launch<4, 4, 4>(c, G, h, sx, sS, sZ, x, S, Z, B, iters, tol, s);
    if (nx == 4 && C == 3 && d == 3)
        return launch<4, 3, 3>(c, G, h, sx, sS, sZ, x, S, Z, B, iters, tol, s);
    return (int)cudaErrorInvalidValue;
}

// 1 when (nx, C, d) has a compiled instantiation.
int ipm_supported(int nx, int C, int d) {
    return ((nx == 4 && C == 4 && d == 4) || (nx == 4 && C == 3 && d == 3))
               ? 1 : 0;
}

}  // extern "C"
