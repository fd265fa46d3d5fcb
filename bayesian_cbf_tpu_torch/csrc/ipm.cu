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
// Mapping: one lane per cone, a group of GW neighbouring lanes per problem,
// GW the smaller of 4 and 8 that holds the C cones (lanes past C mirror
// cone 0 and are never read: the fourth at C = 3, three at C = 5), so a
// 32-thread block holds 8 problems of 4 lanes or 4 of 8, a batch of 256
// spreads over 32 or 64 SMs and each warp has a scheduler to itself.  NX
// (variables), C (cones), D (padded cone dimension) and GW are template
// parameters, so every loop unrolls.  A lane loads its cone's block of G
// (D x NX floats, contiguous in the callers' (B, C, D, NX) layout) and of
// h once and keeps them, its slices of S and Z, their best copies and the
// scaling state in registers: the per-cone algebra (NT scaling, W
// products, step lengths, the corrector) runs in parallel over the lanes.
// What couples the cones (the dual residual, the normal matrix, the KKT
// right-hand sides, the norms, the step minimum, the finite flag) goes
// over the group by shuffles.  Every sum over the cones is one chain in
// cone order (`gchain`), continued from lane to lane: the order of the
// plain version's contractions, and all lanes of a problem hold
// bit-identical values and take the same branches; the NX x NX Cholesky
// and its solves are computed redundantly by each lane.  Inputs and
// outputs are in the callers' layout: no transposed copies around the
// launch.
//
// What bounds it on the H100: latency of the dependent chain of scalar
// f32 operations of one iteration (residuals -> scaling -> normal matrix
// -> factor -> two KKT solves -> step lengths), with one warp per
// scheduler and nothing to overlap it with; the bytes (a few hundred per
// problem) and the operations are far below the card's rates.
// A padded 1-dimensional cone (the nonnegative ray) carries zero rows of G
// and h beyond its head; its tail coordinates start at zero and stay there
// through the same arithmetic, exactly as in the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-14f;
constexpr float kBig = 1e10f;
constexpr int kThreads = 32;   // 8 problems of 4 lanes, or 4 of 8
constexpr unsigned kFull = 0xffffffffu;

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

// A sum over all cones and their coordinates, as one chain in cone order:
// `term(a)` returns a with this lane's cone's terms added, d ascending.  In
// round ci every lane continues the chain from the value so far and the
// group keeps the lane of cone ci's result, so the sum is the one chain
// init + cone 0's terms + cone 1's terms + ..., the order in which the
// plain version's contraction over (cone, d) adds them, and every lane of
// the group holds the same bits.
template <int C, class Term>
__device__ __forceinline__ float gchain(float init, int gbase, Term term) {
    float acc = init;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
        acc = __shfl_sync(kFull, term(acc), gbase + ci);
    return acc;
}

template <int C>
__device__ __forceinline__ float gmin(float v, int gbase) {
    float t = kBig;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
        t = fminf(t, __shfl_sync(kFull, v, gbase + ci));
    return t;
}

// This lane's cone: its block of G, of h and of the iterate.
template <int NX, int D>
struct Cone {
    float g[D][NX], h[D], S[D], Z[D];
};

// The scale-relative KKT score of the point (x, S, Z), with the residuals
// rx (group-wide) and rz (this cone) and s^T z (group-wide) as by-products.
template <int NX, int C, int D>
__device__ __forceinline__ float residuals(const Cone<NX, D>& k, const float* c,
                                           const float* x, float* rx, float* rz,
                                           float& sz, float hnorm, float cnorm,
                                           int gbase) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
        rx[i] = gchain<C>(c[i], gbase, [&](float a) {
#pragma unroll
            for (int d = 0; d < D; ++d) a += k.g[d][i] * k.Z[d];
            return a;
        });
#pragma unroll
    for (int d = 0; d < D; ++d) {
        float a = 0.0f;
#pragma unroll
        for (int i = 0; i < NX; ++i) a += k.g[d][i] * x[i];
        rz[d] = a + k.S[d] - k.h[d];
    }
    const float rzn = gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
        for (int d = 0; d < D; ++d) a += rz[d] * rz[d];
        return a;
    });
    sz = gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
        for (int d = 0; d < D; ++d) a += k.S[d] * k.Z[d];
        return a;
    });
    float rxn = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) rxn += rx[i] * rx[i];
    const float mu = fabsf(sz) / (float)C;
    return fmaxf(fmaxf(sqrtf(rzn) / hnorm, sqrtf(rxn) / cnorm), mu);
}

template <int NX, int C, int D, int GW>
__global__ void __launch_bounds__(kThreads)
ipm_kernel(const float* __restrict__ cG,   // (B, NX)
           const float* __restrict__ G,    // (B, C, D, NX)
           const float* __restrict__ hG,   // (B, C, D)
           const float* __restrict__ sx,   // (B, NX)
           const float* __restrict__ sS,   // (B, C, D)
           const float* __restrict__ sZ,   // (B, C, D)
           float* __restrict__ xo, float* __restrict__ So,
           float* __restrict__ Zo, int B, int iters, float tol) {
    static_assert((GW == 4 || GW == 8) && C <= GW,
                  "one lane per cone in a group of 4 or 8");
    const int lane = threadIdx.x & 31;
    const int gl = lane & (GW - 1);
    const int gbase = lane - gl;
    const int slot = (blockIdx.x * kThreads + threadIdx.x) / GW;
    // lanes past the batch repeat its last problem and lanes past the
    // cones repeat cone 0: they run the same shuffles and store nothing
    const bool store = slot < B && gl < C;
    const int p = min(slot, B - 1);
    const int ci = gl < C ? gl : 0;
    const float nu = (float)C;

    Cone<NX, D> k;
    float c[NX], x[NX];
    {
        const float* gp = G + ((size_t)p * C + ci) * D * NX;
        const float* hp = hG + ((size_t)p * C + ci) * D;
        const float* Sp = sS + ((size_t)p * C + ci) * D;
        const float* Zp = sZ + ((size_t)p * C + ci) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
            for (int i = 0; i < NX; ++i) k.g[d][i] = __ldg(gp + d * NX + i);
            k.h[d] = __ldg(hp + d);
            k.S[d] = __ldg(Sp + d);
            k.Z[d] = __ldg(Zp + d);
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            c[i] = __ldg(cG + (size_t)p * NX + i);
            x[i] = __ldg(sx + (size_t)p * NX + i);
        }
    }

    const float hn = gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
        for (int d = 0; d < D; ++d) a += k.h[d] * k.h[d];
        return a;
    });
    float cn = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) cn += c[i] * c[i];
    const float hnorm = fmaxf(1.0f, sqrtf(hn));
    const float cnorm = fmaxf(1.0f, sqrtf(cn));

    float bx[NX], bS[D], bZ[D];
    float bscore = INFINITY;
#pragma unroll
    for (int i = 0; i < NX; ++i) bx[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        bS[d] = d == 0 ? 1.0f : 0.0f;
        bZ[d] = d == 0 ? 1.0f : 0.0f;
    }

    float rx[NX], rz[D], sz;
    for (int it = 0; it < iters; ++it) {
        const float score = residuals<NX, C, D>(k, c, x, rx, rz, sz, hnorm,
                                                cnorm, gbase);
        if (score < bscore) {
#pragma unroll
            for (int i = 0; i < NX; ++i) bx[i] = x[i];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                bS[d] = k.S[d];
                bZ[d] = k.Z[d];
            }
        }
        bscore = fminf(score, bscore);
        const bool done = score < tol;
        const float mu = sz / nu;

        float Wb[D], eta, lam[D], jg[NX];
        nt_scaling<D>(k.S, k.Z, Wb, eta);
        w_mul<D>(Wb, eta, k.Z, lam);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            float a = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d)
                a += (d == 0 ? Wb[d] : -Wb[d]) * k.g[d][i];
            jg[i] = a;
        }

        // H = G^T W^{-2} G (+ 1e-12 tr H I), lower triangle, each entry one
        // chain over the group's cones; then its Cholesky factor
        float Lf[NX][NX], w2g[D][NX];
        const float e2 = eta * eta;
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
            for (int j = 0; j < NX; ++j) {
                const float jw = d == 0 ? Wb[d] : -Wb[d];
                const float gj = k.g[d][j];
                w2g[d][j] = (2.0f * jw * jg[j] - (d == 0 ? gj : -gj)) / e2;
            }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j)
                Lf[i][j] = gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
                    for (int d = 0; d < D; ++d) a += k.g[d][i] * w2g[d][j];
                    return a;
                });
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
                for (int q = 0; q < j; ++q) acc -= Lf[i][q] * Lf[j][q];
                Lf[i][j] = (i == j) ? sqrtf(fmaxf(acc, kEps)) : acc / Lf[j][j];
            }

        // KKT solve: W dz + W^{-T} ds = -Dscaled
        auto kkt_solve = [&](const float* Ds, float* dx, float* dS, float* dZ) {
            float rhs_cd[D], w2r[D], wd[D];
            w_mul<D>(Wb, eta, Ds, wd);
#pragma unroll
            for (int d = 0; d < D; ++d) rhs_cd[d] = rz[d] - wd[d];
            winv2_mul<D>(Wb, eta, rhs_cd, w2r);
            float y[NX];
#pragma unroll
            for (int i = 0; i < NX; ++i)
                y[i] = -rx[i] - gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
                    for (int d = 0; d < D; ++d) a += k.g[d][i] * w2r[d];
                    return a;
                });
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                float acc = y[i];
#pragma unroll
                for (int q = 0; q < i; ++q) acc -= Lf[i][q] * y[q];
                y[i] = acc / Lf[i][i];
            }
#pragma unroll
            for (int i = NX - 1; i >= 0; --i) {
                float acc = y[i];
#pragma unroll
                for (int q = i + 1; q < NX; ++q) acc -= Lf[q][i] * dx[q];
                dx[i] = acc / Lf[i][i];
            }
            float t[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                float gdx = 0.0f;
#pragma unroll
                for (int i = 0; i < NX; ++i) gdx += k.g[d][i] * dx[i];
                dS[d] = -rz[d] - gdx;
                t[d] = gdx + rhs_cd[d];
            }
            winv2_mul<D>(Wb, eta, t, dZ);
        };

        // affine (predictor) direction
        float dxa[NX], dSa[D], dZa[D];
        kkt_solve(lam, dxa, dSa, dZa);
        float amin = gmin<C>(fminf(max_step<D>(k.S, dSa), max_step<D>(k.Z, dZa)),
                             gbase);
        const float alpha_a = fminf(1.0f, amin);
        float Sa[D], Za[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            Sa[d] = k.S[d] + alpha_a * dSa[d];
            Za[d] = k.Z[d] + alpha_a * dZa[d];
        }
        const float mu_a = gchain<C>(0.0f, gbase, [&](float a) {
#pragma unroll
            for (int d = 0; d < D; ++d) a += Sa[d] * Za[d];
            return a;
        }) / nu;
        const float ratio = mu_a / fmaxf(mu, kEps);
        const float sigma = fminf(fmaxf(ratio * ratio * ratio, 0.0f), 1.0f);

        // corrector
        float Dc[D];
        {
            float a1[D], a2[D], corr[D], ll[D], rs[D];
            winv_mul<D>(Wb, eta, dSa, a1);
            w_mul<D>(Wb, eta, dZa, a2);
            jmul<D>(a1, a2, corr);
            jmul<D>(lam, lam, ll);
#pragma unroll
            for (int d = 0; d < D; ++d)
                rs[d] = ll[d] + corr[d] - (d == 0 ? sigma * mu : 0.0f);
            jinv_mul<D>(lam, rs, Dc);
        }
        float dx[NX], dS[D], dZ[D];
        kkt_solve(Dc, dx, dS, dZ);
        amin = gmin<C>(fminf(max_step<D>(k.S, dS), max_step<D>(k.Z, dZ)), gbase);
        const float alpha = fminf(0.99f * amin, 1.0f);

        float xn[NX], Sn[D], Zn[D];
        bool fin = true;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            xn[i] = x[i] + alpha * dx[i];
            fin = fin && isfinite(xn[i]);
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
            Sn[d] = k.S[d] + alpha * dS[d];
            Zn[d] = k.Z[d] + alpha * dZ[d];
            fin = fin && isfinite(Sn[d]) && isfinite(Zn[d]);
        }
        // the step is taken only if it is finite on every cone
        constexpr unsigned cones = (1u << C) - 1u;
        const bool finite =
            ((__ballot_sync(kFull, fin) >> gbase) & cones) == cones;
        if (!(done || !finite)) {
#pragma unroll
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                k.S[d] = Sn[d];
                k.Z[d] = Zn[d];
            }
        }
    }

    const float score = residuals<NX, C, D>(k, c, x, rx, rz, sz, hnorm, cnorm,
                                            gbase);
    const bool better = score < bscore;
    if (store) {
        float* So_p = So + ((size_t)p * C + ci) * D;
        float* Zo_p = Zo + ((size_t)p * C + ci) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            So_p[d] = better ? k.S[d] : bS[d];
            Zo_p[d] = better ? k.Z[d] : bZ[d];
        }
        if (gl == 0) {
#pragma unroll
            for (int i = 0; i < NX; ++i)
                xo[(size_t)p * NX + i] = better ? x[i] : bx[i];
        }
    }
}

// the group width of C cones: the smaller of 4 and 8 that holds them
template <int C>
constexpr int group_width() { return C <= 4 ? 4 : 8; }

template <int NX, int C, int D>
int launch(const float* c, const float* G, const float* h, const float* sx,
           const float* sS, const float* sZ, float* x, float* S, float* Z, int B,
           int iters, float tol, cudaStream_t stream) {
    constexpr int GW = group_width<C>();
    const int per_block = kThreads / GW;
    const int blocks = (B + per_block - 1) / per_block;
    ipm_kernel<NX, C, D, GW><<<blocks, kThreads, 0, stream>>>(
        c, G, h, sx, sS, sZ, x, S, Z, B, iters, tol);
    return (int)cudaGetLastError();
}

template <int NX_, int C_, int D_>
struct Shape {
    static constexpr int NX = NX_, C = C_, D = D_;
};

// The instantiated shapes (nx, C, d), group width 4 unless named:
//  (4, 4, 4)  the unicycle controller's [u (2), relax, t] with four cones
//             of dimension 4 (objective, CLC, two CBCs);
//  (4, 3, 3)  the pendulum controller's [u, delta, y, s] with cones of
//             dimensions (3, 3, 1) padded to 3;
//  (3, 5, 3)  group width 8: the pendulum's ground-truth CLF-CBF QP, [u,
//             slack, y] with cones of dimensions (3, 1, 1, 1, 1);
//  (4, 6, 4)  group width 8: the deterministic mean-CLF QP, [u (2), relax,
//             t] with cones of dimensions (4, 1, 1, 1, 1, 1);
//  (4, 2, 4)  the unicycle controller without obstacles (objective, CLC).
// A source that includes this file after defining IPM_SHAPES instantiates
// its own list instead (csrc/ipm_exact.cu).
#ifndef IPM_SHAPES
#define IPM_SHAPES Shape<4, 4, 4>, Shape<4, 3, 3>, Shape<3, 5, 3>, \
                   Shape<4, 6, 4>, Shape<4, 2, 4>
#endif
template <class... S>
struct ShapeList {};
using Shapes = ShapeList<IPM_SHAPES>;

// f(S{}) for the shape S of Shapes that is (nx, C, d); false if none is.
template <class F, class... S>
bool with_shape(int nx, int C, int d, F f, ShapeList<S...>) {
    return ((nx == S::NX && C == S::C && d == S::D ? (f(S{}), true) : false) || ...);
}

// Writes the (nx, C, d) of the first `cap` shapes to out[3 i .. 3 i + 2], in
// their order; returns how many there are.
template <class... S>
int list_shapes(int* out, int cap, ShapeList<S...>) {
    const int all[][3] = {{S::NX, S::C, S::D}...};
    const int n = (int)sizeof...(S);
    for (int i = 0; i < n && i < cap; ++i)
        for (int j = 0; j < 3; ++j) out[3 * i + j] = all[i][j];
    return n;
}

}  // namespace

// ---- host launchers (plain C interface, loaded with ctypes) ----
extern "C" {

// The callers' layout, contiguous: c, sx, x (B, nx); G (B, C, d, nx); h, sS,
// sZ, S, Z (B, C, d).
// One of the shapes of `Shapes` (the wrapper asks `ipm_group_width` and
// raises before any other reaches here); cudaErrorInvalidValue for any other.
int ipm_launch(const float* c, const float* G, const float* h, const float* sx,
               const float* sS, const float* sZ, float* x, float* S, float* Z,
               int B, int nx, int C, int d, int iters, float tol, void* stream) {
    int rc = (int)cudaErrorInvalidValue;
    with_shape(nx, C, d, [&](auto shape) {
        using Sh = decltype(shape);
        rc = launch<Sh::NX, Sh::C, Sh::D>(c, G, h, sx, sS, sZ, x, S, Z, B, iters,
                                          tol, (cudaStream_t)stream);
    }, Shapes{});
    return rc;
}

// The lanes per problem of the instantiation at (nx, C, d), 4 or 8; 0 when
// (nx, C, d) has none.
int ipm_group_width(int nx, int C, int d) {
    int gw = 0;
    with_shape(nx, C, d, [&](auto shape) {
        gw = group_width<decltype(shape)::C>();
    }, Shapes{});
    return gw;
}

// The instantiated (nx, C, d), in the order of `Shapes`: the first `cap` to
// out (3 ints each); returns how many there are.
int ipm_shapes(int* out, int cap) { return list_shapes(out, cap, Shapes{}); }

}  // extern "C"
