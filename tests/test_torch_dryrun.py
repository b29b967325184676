"""sofa_tpu_torch's ``dryrun_multigpu`` against the JAX dry run's meshes.

``__graft_entry__.py:dryrun_multichip(8)`` prints three lines on its
eight virtual devices (``MULTICHIP_r05.json``'s tail): the (data, seq,
model) transformer with FSDP and remat on {'data': 2, 'seq': 2, 'model':
2}, expert parallelism on {'data': 4, 'expert': 2}, the pipeline on
{'data': 4, 'stage': 2}, each with a finite loss and ``ok``.  The port's
runs eight spawned gloo ranks on the CPU and must print the same meshes;
one rank skips expert parallelism as the JAX dry run does; without a card
the default device raises before any rank starts.
"""

import math
import re

import pytest
import torch

from sofa_tpu_torch.entry import dryrun_multigpu

LINE = re.compile(r"dryrun_multigpu: (?:(ep|pp) )?mesh=(\{[^}]*\}) "
                  r".*loss=(\S+) ok$")
#: the JAX dry run's meshes at 8 devices, line by line
MESHES = [{"data": 2, "seq": 2, "model": 2}, {"data": 4, "expert": 2},
          {"data": 4, "stage": 2}]


@pytest.fixture(scope="module")
def eight_ranks():
    return dryrun_multigpu(8, device="cpu", timeout=240.0)


@pytest.mark.parametrize("i", range(3), ids=["dp_sp_tp", "ep", "pp"])
def test_each_mesh_steps_to_a_finite_loss(eight_ranks, i):
    assert len(eight_ranks) == 3
    m = LINE.match(eight_ranks[i])
    assert m, eight_ranks[i]
    assert eval(m.group(2)) == MESHES[i]        # a dict literal
    assert math.isfinite(float(m.group(3)))


def test_the_transformer_line_names_the_jax_shapes(eight_ranks):
    """batch 2 x data and seq 16 x seq, as the JAX dry run derives them;
    two experts on the expert axis of 2; two stages."""
    assert "batch=4 seq=32 " in eight_ranks[0]
    assert "experts=2 " in eight_ranks[1]
    assert "stages=2 " in eight_ranks[2]


def test_one_rank_skips_expert_parallelism(capfd):
    lines = dryrun_multigpu(1, device="cpu", timeout=120.0)
    assert lines[1] == "dryrun_multigpu: ep skipped (needs >= 2 devices)"
    assert lines[0].startswith(
        "dryrun_multigpu: mesh={'data': 1, 'seq': 1, 'model': 1}")
    assert lines[2].startswith("dryrun_multigpu: pp mesh={'data': 1, "
                               "'stage': 1} stages=1")
    assert capfd.readouterr().out.splitlines()[-3:] == lines


def test_no_card_raises_before_any_rank_starts(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multigpu(2)
