"""The IPM wrapper's contract on the CPU (bayesian_cbf_tpu_torch/ops/
ipm_kernel.py): one argument check for both devices, the callers' layout
in and out, and `solve_socp` handing the wrapper what it requires.  The
kernel itself is held against `ipm_plain` on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
from bayesian_cbf_tpu_torch.solvers import socp


def _problems(B, seed, nx=4, dims=(4, 4, 4, 1), dtype=torch.float64):
    rng = np.random.default_rng(seed)
    C, d = len(dims), max(dims)
    c = rng.normal(size=(B, nx))
    G = np.zeros((B, C, d, nx))
    h = np.zeros((B, C, d))
    for ci, dd in enumerate(dims):
        G[:, ci, 0] = -rng.normal(size=(B, nx)) * 0.2
        G[:, ci, 1:dd] = -rng.normal(size=(B, dd - 1, nx)) * 0.5
        h[:, ci, 0] = 1.5 + rng.uniform(size=B)
        h[:, ci, 1:dd] = rng.normal(size=(B, dd - 1)) * 0.1
    e = np.zeros((B, C, d))
    e[..., 0] = 1.0
    return [torch.tensor(a, dtype=dtype)
            for a in (c, G, h, np.zeros((B, nx)), e, e)]


@pytest.mark.parametrize("dims", [(4, 4, 4, 1), (3, 3, 1)])
@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ipm_on_cpu_is_plain_in_the_callers_layout(B, dims, dtype):
    args = _problems(B, B + len(dims), dims=dims, dtype=dtype)
    C, d = len(dims), max(dims)
    assert ik.check_ipm_args(*args) == (B, C, d, 4)
    with tracing.recording():
        got = ik.ipm(*args, 6, 1e-10)
    want = ik.ipm_plain(*args, 6, 1e-10)
    assert "launches.ipm" not in tracing.report()["counters"]
    assert [tuple(t.shape) for t in got] == [(B, 4), (B, C, d), (B, C, d)]
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == dtype
        assert torch.equal(g, w)


def _broken(args, which, how):
    args = list(args)
    a = args[which]
    if how == "dtype":
        args[which] = a.to(torch.float32 if a.dtype == torch.float64
                           else torch.float64)
    elif how == "integer":
        args = [t.to(torch.int64) for t in args]
    elif how == "batch":
        args[which] = a[:-1].contiguous()
    elif how == "transposed":
        # the former batch-fastest layout, viewed back: right shape, wrong
        # strides
        args[which] = a.movedim(0, -1).contiguous().movedim(-1, 0)
    elif how == "rank":
        args[which] = a[..., None]
    return args


@pytest.mark.parametrize("which", range(6))
@pytest.mark.parametrize("how", ["dtype", "batch", "transposed", "rank"])
def test_check_ipm_args_rejects(which, how):
    args = _broken(_problems(3, 0), which, how)
    with pytest.raises(ValueError):
        ik.check_ipm_args(*args)
    with pytest.raises(ValueError):
        ik.ipm(*args, 5, 1e-10)


def test_check_ipm_args_rejects_integers_and_empty_batches():
    with pytest.raises(ValueError):
        ik.check_ipm_args(*_broken(_problems(3, 0), 0, "integer"))
    with pytest.raises(ValueError):
        ik.check_ipm_args(*(a[:0] for a in _problems(3, 0)))
    with pytest.raises(ValueError):
        ik.check_ipm_args(*(a[..., :0] for a in _problems(3, 0)))


def test_check_is_the_same_on_a_card_but_for_the_dtype():
    """On a card the kernel is float32 only; the rule is decided from the
    tensors' device, so the meta device shows it without a card."""
    args = [a.to("meta") for a in _problems(3, 0, dtype=torch.float32)]
    assert ik.check_ipm_args(*args) == (3, 4, 4, 4)
    with pytest.raises(ValueError):
        ik.ipm(*args, 5, 1e-10)          # no kernel for that device


@pytest.mark.parametrize("dims,shared_c", [((4, 4, 4, 1), True),
                                           ((3, 3, 1), False)])
def test_solve_socp_gives_the_wrapper_what_it_requires(monkeypatch, dims,
                                                       shared_c):
    """`solve_socp` pads, expands a shared objective and warm-starts; every
    tensor it hands to `ipm` passes the check, and its solution is the
    wrapper's output in the (B, C, d) layout."""
    B, nx = 6, 4
    c, Gp, hp, *_ = _problems(B, 5, dims=dims)
    G = torch.cat([Gp[:, i, :d] for i, d in enumerate(dims)], 1)
    h = torch.cat([hp[:, i, :d] for i, d in enumerate(dims)], 1)
    seen = []
    real = socp.ipm

    def spy(*args):
        seen.append(ik.check_ipm_args(*args[:6]))
        return real(*args)

    monkeypatch.setattr(socp, "ipm", spy)
    cold = socp.solve_socp(c[0] if shared_c else c, G, h, dims, iters=12)
    warm = socp.solve_socp(c[0] if shared_c else c, G, h + 1e-3, dims,
                           iters=8, warm=(cold.x, cold.s, cold.z))
    C, d = len(dims), max(dims)
    assert seen == [(B, C, d, nx)] * 2
    for sol in (cold, warm):
        assert tuple(sol.x.shape) == (B, nx)
        assert tuple(sol.s.shape) == tuple(sol.z.shape) == (B, C, d)
        assert sol.x.is_contiguous() and sol.s.is_contiguous()
    assert float(warm.gap.max()) < 1e-6
