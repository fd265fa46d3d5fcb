"""The plain reference against the program on the CPU, the control that
`correct` must refuse, and the faults it must catch."""
import math

import pytest
import torch

from benchmark import harness as H
from benchmark.calibrate import control_numbers
from benchmark.faults import FAULTS
from benchmark.tests.conftest import run_small, small_cell


def test_rehearsal_is_correct(small_run):
    """Each cell's rehearsal repeats itself bit for bit and passes every
    limit of its configuration."""
    r = small_run
    prints = torch.stack(r["prints"])
    assert bool((prints == prints[0]).all())
    assert r["bad"] == [0, 0]
    assert r["ok"], (r["nums"], r["cfg"]["limits"])
    assert r["nums"]["start_gap"] == 0.0


def test_control_is_refused(small_run):
    """The reference in TF32 put in the program's place fails a limit."""
    r = small_run
    fam, limits = r["fam"], r["cfg"]["limits"]
    nums = control_numbers(fam, r["inputs"], r["refs"]["tf32"],
                           r["refs"]["f64"])
    assert any(nums[k] > limits[k] for k in limits), nums


def test_reference_matches_program_in_f64(cell_name):
    """In float64 the program and the reference agree to the solver's
    floor: the reference computes the same thing."""
    fam, cfg = small_cell(cell_name, dtype="float64")
    inputs, kept, full, _, _ = run_small(fam, 5, n_rollouts=1)
    nums, _, _, _ = H.judge(fam, inputs, kept, full, cfg["limits"])
    assert nums["start_gap"] == 0.0
    assert nums["step_gap"] < 1e-12
    assert nums["u_gap_p50"] < 1e-7
    assert nums["u_off_share"] == 0.0
    for k in ("fit_gap", "post_gap"):
        if k in nums:
            assert nums[k] < 1e-8, (k, nums[k])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_refused(cell_name, fault):
    """Each fault a cell can have, planted under a run, makes `correct`
    false (one card: no exchange between cards to leave out)."""
    fam, cfg = small_cell(cell_name)
    FAULTS[fault](fam)
    inputs, kept, full, _, _ = run_small(fam, 11, n_rollouts=2)
    nums, ok, _, _ = H.judge(fam, inputs, kept, full, cfg["limits"])
    assert not ok, nums


def test_rate_counts_whole_rollouts():
    """Episode-steps of every rollout over first start to last end."""
    times = [(10.0, 12.0), (12.5, 14.0), (14.0, 16.0)]
    assert H.rate(times, 1000) == pytest.approx(3000 / 6.0)
    assert H.rate([(0.0, 4.0)], 10) == pytest.approx(2.5)


def test_samples_are_distinct_episodes():
    idx = [H.sample_idx(64, 8, 3, k, torch.device("cpu")) for k in range(8)]
    allidx = torch.cat(idx)
    assert allidx.unique().numel() == 64
    assert torch.equal(idx[0], H.sample_idx(64, 8, 3, 0,
                                            torch.device("cpu")))
    assert not math.isnan(float(allidx.float().mean()))
