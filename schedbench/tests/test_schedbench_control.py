"""The control and the planted faults come out not correct; the program
as it is comes out correct (all on the CPU, the kernels' plain twins)."""

import pytest
import torch

from schedbench.control import run_control, traffic_order
from schedbench.spec import find_cell

from .conftest import cpu_run, tiny_bench


@pytest.mark.parametrize("kind", ["spread", "tiebreak"])
def test_control_is_not_correct(tmp_path, kind):
    root = tiny_bench(tmp_path)
    cell = find_cell(root, "tiny.small", package_dir=root / "schedbench")
    for seed in (1, 2, 3):
        counts = run_control(cell, seed, rollouts=6, kind=kind)
        assert counts["placement_mismatch"] > 0, (kind, seed, counts)


def test_traffic_order_follows_the_mix(tmp_path):
    root = tiny_bench(tmp_path)
    cell = find_cell(root, "tiny.small", package_dir=root / "schedbench")
    order = traffic_order(cell, 5, rollouts=3)
    # each rollout after the first deletes the one before it
    assert [s[0] for s in order] == (["create"] * 24
                                     + (["delete"] * 24 + ["create"] * 24)
                                     * 2)
    assert len({s[1] for s in order if s[0] == "create"}) == 3 * 24


def test_the_program_as_it_is_is_correct(tmp_path):
    _run, counts, line = cpu_run(tiny_bench(tmp_path), seed=11)
    assert line["correct"], counts
    assert line["attempted"] > 0 and line["failed"] == 0


def _state_unchanged(monkeypatch):
    """A scan step that returns the nodes' state unchanged."""
    from minisched_tpu_torch.ops import sequential

    monkeypatch.setattr(sequential, "_store_nodes", lambda state, new: None)


def _half_left_out(monkeypatch):
    """Half of each batch of winners never bound."""
    from minisched_tpu_torch.engine.device_scheduler import DeviceScheduler

    orig = DeviceScheduler._commit_winners

    def half(self, winners):
        return orig(self, winners[: (len(winners) + 1) // 2])

    monkeypatch.setattr(DeviceScheduler, "_commit_winners", half)


def _answer_altered(monkeypatch):
    """``select_hosts`` answers the last feasible node, not the best."""
    from minisched_tpu_torch.ops import fused

    orig = fused.select_hosts

    def altered(scores, mask, seeds, node_base=0):
        choice, best = orig(scores, mask, seeds, node_base)
        n = mask.shape[1]
        last = n - 1 - torch.flip(mask, [1]).int().argmax(dim=1)
        return torch.where(choice >= 0, last.to(choice.dtype), choice), best

    monkeypatch.setattr(fused, "select_hosts", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    _run, counts, line = cpu_run(tiny_bench(tmp_path, drain_s=3), seed=11)
    assert not line["correct"], counts
