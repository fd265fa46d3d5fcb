"""The fit-Gram's pull-back (ops/gramsolve.py) on the CPU, in f64: the
closed-form plain version of the backward kernel against autograd of
`km_expr`, and the dispatch of `gram_solve_logdet` between its two routes.
On the CPU the pull-back route runs through the wrappers' plain versions
(`km_expr`, `km_backward_plain`).  The CUDA kernels are tested on the card
by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import gramsolve as gs


def _case(B, K, xd, mh, n, masked, seed=0):
    """Random-walk states, UH = [1, u], UB = UH sB, inverse lengthscales,
    nugget, mask; Kinv the inverse of Km, S = Kinv Y, dY = Kinv dS and
    dlogdet, all f64."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.3 * rng.normal(size=(B, K, xd)), 1)
    UH = np.concatenate([np.ones((B, K, 1)), rng.normal(size=(B, K, mh - 1))],
                        -1)
    sB = np.eye(mh) + 0.2 * rng.normal(size=(mh, mh))
    UB = UH @ (sB @ sB.T)
    il = rng.uniform(0.5, 2.0, size=(B, xd))
    nug = rng.uniform(1e-3, 0.3, size=B)
    mask = np.ones((B, K))
    if masked == "some":
        mask = (rng.uniform(size=(B, K)) > 0.3).astype(float)
    elif masked == "tail":
        mask[:, K // 2:] = 0.0
    ins = [torch.tensor(a) for a in (X, UB, UH, il, nug, mask)]
    Kinv = torch.linalg.inv(gs.km_expr(*ins))
    Y = torch.tensor(rng.normal(size=(B, K, n))) * ins[5][..., None]
    dS = torch.tensor(rng.normal(size=(B, K, n)))
    return ins + [Kinv, Kinv @ dS, Kinv @ Y, torch.tensor(rng.normal(size=B))]


@pytest.mark.parametrize("masked", ["none", "some", "tail"])
@pytest.mark.parametrize("B,K,xd,mh,n", [(2, 9, 2, 2, 2), (3, 13, 3, 3, 3),
                                         (1, 6, 16, 16, 16), (2, 11, 1, 4, 3),
                                         (2, 37, 5, 1, 2)])
def test_km_backward_plain_matches_autograd(B, K, xd, mh, n, masked):
    """(dUB, d inv_ell, d nug) in closed form equal autograd of km_expr
    pulled back from dKm = dlogdet Kinv - dY S^T, to f64 roundoff."""
    X, UB, UH, il, nug, mask, Kinv, dY, S, dl = _case(B, K, xd, mh, n, masked)
    leaves = [a.clone().requires_grad_(True) for a in (UB, il, nug)]
    Km = gs.km_expr(X, leaves[0], UH, leaves[1], leaves[2], mask)
    dKm = dl[:, None, None] * Kinv - dY @ S.transpose(-1, -2)
    want = torch.autograd.grad(Km, leaves, dKm)
    got = gs.km_backward_plain(X, UB, UH, il, mask, Kinv, dY, S, dl)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(w.abs().max()))
    assert float((got[0] * (1.0 - mask)[..., None]).abs().sum()) == 0.0


@pytest.fixture
def plain_backward_calls(monkeypatch):
    """The calls of the backward's plain version, counted."""
    calls = []
    plain = gs.km_backward_plain
    monkeypatch.setattr(gs, "km_backward_plain",
                        lambda *a: calls.append(1) or plain(*a))
    return calls


def _mll_like(X, UB0, UH, il, mask, Y, k_eps, method="chol"):
    """(S, logdet) as `MVGP.mll` builds them: UB from a scale times UB0,
    and a nugget of 1e-3 + k_eps times the clamped mean of the Gram's
    diagonal (a gradient through the nugget only where that mean is above
    1)."""
    diag = torch.sum(UB0 * UH, -1)
    nug = 1e-3 + k_eps * torch.clamp(torch.mean(diag.abs(), -1), min=1.0)
    return gs.gram_solve_logdet(X, UB0, UH, il, nug, mask, Y, method=method)


@pytest.mark.parametrize("masked", ["none", "some"])
@pytest.mark.parametrize("diag_scale", [0.1, 3.0])
def test_kernel_route_gives_the_recompute_routes_gradients(
        plain_backward_calls, diag_scale, masked):
    """Through `gram_solve_logdet`, the pull-back route (here the plain
    versions) gives the recompute route's values and gradients w.r.t. UB,
    inv_ell, Y and, through the MLL's nugget, the Gram's scale: with the
    diagonal's mean below 1 (the nugget clamped, no gradient through it)
    and above."""
    X, UB, UH, il, _, mask, *_, = _case(2, 12, 3, 3, 3, masked, seed=4)
    Y = torch.tensor(np.random.default_rng(5).normal(size=(2, 12, 3)))
    scale0 = torch.tensor([diag_scale, 2 * diag_scale])

    def run(X_needs_grad):
        scale = scale0.clone().requires_grad_(True)
        leaves = [a.clone().requires_grad_(True) for a in (il, Y)]
        Xl = X.clone().requires_grad_(X_needs_grad)
        S, ld = _mll_like(Xl, scale[:, None, None] * UB, UH, leaves[0], mask,
                          leaves[1], 1e-2)
        loss = (S * S).sum() + (ld * torch.tensor([1.0, -0.5])).sum()
        return [S, ld] + list(torch.autograd.grad(loss, [scale] + leaves))

    kernel = run(False)
    assert len(plain_backward_calls) == 1
    recompute = run(True)
    assert len(plain_backward_calls) == 1
    for a, b in zip(kernel, recompute):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-9, atol=1e-12)


def _route_case(change):
    X, UB, UH, il, nug, mask, *_ = _case(2, 7, 3, 3, 3, "some", seed=6)
    Y = torch.ones((2, 7, 3), dtype=torch.float64)
    ins = dict(X=X, UB=UB.requires_grad_(True), UH=UH, il=il, nug=nug,
               mask=mask, Y=Y)
    if change in ("X", "UH", "mask"):
        ins[change] = ins[change].clone().requires_grad_(True)
    elif change == "f32":
        ins = {k: v.detach().float().requires_grad_(v.requires_grad)
               for k, v in ins.items()}
    elif change == "wide":
        ins["UB"] = torch.ones((2, 7, 17), dtype=torch.float64,
                               requires_grad=True)
        ins["UH"] = torch.ones((2, 7, 17), dtype=torch.float64)
    return ins


@pytest.mark.parametrize("change,kernels", [
    ("none", True), ("X", False), ("UH", False), ("mask", False),
    ("f32", True), ("wide", True)])
def test_gram_solve_logdet_routes_by_its_inputs(plain_backward_calls, change,
                                                kernels):
    """The pull-back route runs wherever no gradient is wanted for X, UH
    or mask, whatever the dtype and widths (the wrappers pick kernel or
    plain version); otherwise the recompute route runs, and on the CPU
    counts no `gramsolve.recompute` (a CUDA backward's counter)."""
    ins = _route_case(change)
    with tracing.recording():
        S, ld = gs.gram_solve_logdet(*ins.values(), method="chol")
        (S.sum() + ld.sum()).backward()
    assert len(plain_backward_calls) == int(kernels)
    assert "gramsolve.recompute" not in tracing.report()["counters"]


def test_cpu_calls_take_the_plain_versions(monkeypatch):
    """On the CPU the pull-back route reaches the kernels' wrappers, which
    take their plain versions and launch nothing."""
    calls = []
    for name in ("fit_gram", "fit_gram_backward"):
        wrapper = getattr(gs, name)
        monkeypatch.setattr(gs, name, lambda *a, w=wrapper, n=name:
                            calls.append(n) or w(*a))
    ins = _route_case("none")
    with tracing.recording():
        S, ld = gs.gram_solve_logdet(*ins.values(), method="chol")
        (S.sum() + ld.sum()).backward()
    assert calls == ["fit_gram", "fit_gram_backward"]
    assert not any(k.startswith("launches.")
                   for k in tracing.report()["counters"])
    assert torch.isfinite(ins["UB"].grad).all()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    ins = _case(2, 9, 3, 3, 3, "some")
    with tracing.recording():
        assert torch.equal(gs.fit_gram(*ins[:6]), gs.km_expr(*ins[:6]))
        got = gs.fit_gram_backward(*ins[:4], *ins[5:])
    want = gs.km_backward_plain(*ins[:4], *ins[5:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(k.startswith("launches.")
                   for k in tracing.report()["counters"])
