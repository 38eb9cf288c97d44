"""The device-side control flow of the one-launch CUDA graph, on the CPU.

On the card a loop of the compiled step is a conditional WHILE node that
runs the block while the flag the block computed on the device is true (at
most the eager loop's block count, a guard), and detect_every's branch is a
pair (a batched step: three) of IF nodes taken on a one-hot predicate
computed on the device (rso_torch.graphs).  Here the same decisions run on
the CPU, read back:

- `flag_only_loop` runs blocks while the carry's stop flag is true, with no
  block count: for bundle adjustment's LM loop (the flag now holds the cap
  n < max_iters) and for the pose solver's GN loops it ends after as many
  blocks as `eager_blocks` and gives the same carry, bit for bit, at every
  max_iters and block size;
- the branches' device predicate (`Branches.flags`) is one-hot and picks
  the branch `detects_this_frame` / `lanes_detect` read on the host.
"""
import dataclasses

import numpy as np
import pytest
import torch

import rso_torch.ba.ba as T
import rso_torch.solver.robust_gn as G
import test_torch_ba as TBA
from rso_torch.engine import (MIXED, detects_this_frame, engine_branches,
                              init_state, lanes_detect)
from rso_torch.graphs import tree_map
from rso_torch.parallel import lanes_branches
from rso_torch.synthetic import synthetic_config
from test_torch_ba_compiled import _args, _case
from test_torch_solver import CASES, TCAM, make_problem

LM_BLOCKS = (1, 2, 3, 4, 5, 8, 15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Blocks:
    """A loop runner that counts the blocks it ran."""

    def __init__(self, runner):
        self.runner, self.blocks = runner, 0

    def __call__(self, block, carry, n_blocks):
        def counted(c):
            self.blocks += 1
            return block(c)

        return self.runner(counted, carry, n_blocks)


def flag_only_loop(block, carry, n_blocks):
    """The WHILE node's loop without its guard: the first block always
    runs, then blocks while the carry's flag is true; n_blocks unused (but
    a flag still true after 100 times as many blocks fails the test)."""
    if n_blocks == 0:
        return carry
    carry = block(carry)
    for _ in range(100 * n_blocks):
        if not bool(carry.stop_flag()[1]):
            return carry
        carry = block(carry)
    raise AssertionError("the loop's flag never fell")


def _same(a, b, what):
    for field, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: {field} differs"


@pytest.mark.parametrize("block", LM_BLOCKS)
@pytest.mark.parametrize("max_iters", [1, 3, 5, 15])
@pytest.mark.parametrize("case", ["tol0", "early", "batch"])
def test_lm_flag_holds_the_cap(monkeypatch, case, max_iters, block):
    """tol0 runs every window to max_iters, so only the cap stops it;
    early stops on convergence; batch has a padding slot."""
    monkeypatch.setattr(T, "LM_BLOCK", block)
    prob, kw, active = _case(case)
    args = _args(kw, max_iters)
    eager, flags = _Blocks(G.eager_blocks), _Blocks(flag_only_loop)
    want = T.levenberg_marquardt(TBA.TCAM, prob, **args, active=active,
                                 loop=eager)
    got = T.levenberg_marquardt(TBA.TCAM, prob, **args, active=active,
                                loop=flags)
    _same(got, want, f"{case} max_iters {max_iters} LM_BLOCK {block}")
    assert flags.blocks == eager.blocks
    assert eager.blocks <= -(-max_iters // min(block, max_iters))


@pytest.mark.parametrize("gn_block", [1, 2, 4])
@pytest.mark.parametrize("iters", [(1, 1), (3, 5), (10, 100)])
@pytest.mark.parametrize("lm", [False, True])
def test_gn_flag_holds_the_cap(monkeypatch, gn_block, iters, lm):
    """The GN's flag (`active`) holds it < max_iters: both phases end where
    the eager blocks do, at every cap and block size."""
    monkeypatch.setattr(G, "GN_BLOCK", gn_block)
    ls = G.LeastSquaresParams(initial_max_iters=iters[0], max_iters=iters[1],
                              use_lm=lm)
    prev, cur, mask = (torch.from_numpy(a) for a in
                       make_problem(2, **CASES["outliers"]))
    eager, flags = _Blocks(G.eager_blocks), _Blocks(flag_only_loop)
    want = G.solve_pose(TCAM, prev, cur, mask, ls, loop=eager)
    got = G.solve_pose(TCAM, prev, cur, mask, ls, loop=flags)
    _same(got, want, f"GN {iters} block {gn_block}")
    assert flags.blocks == eager.blocks


def _states(cfg, n=24, seed=0):
    """Engine states with every input of detect_flag varied."""
    r = np.random.default_rng(seed)
    base = init_state(cfg, (32, 48), device="cpu")
    out = []
    for _ in range(n):
        octs = tuple(o._replace(matches=o.matches._replace(
            valid=torch.from_numpy(r.random(o.matches.valid.shape[0])
                                   < r.choice([0.0, 0.02, 0.5]))))
                     for o in base.prev.octaves)
        out.append(base._replace(
            prev=base.prev._replace(octaves=octs),
            have_prev=torch.tensor(bool(r.random() < 0.8)),
            since_detect=torch.tensor(int(r.integers(0, 4)), dtype=torch.int32),
            err_streak=torch.tensor(int(r.random() < 0.2), dtype=torch.int32)))
    return out


def test_engine_predicate_is_the_host_branch():
    cfg = synthetic_config()
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=3))
    br = engine_branches(cfg)
    seen = set()
    for st in _states(cfg):
        flags = br.flags(st)
        assert flags.dtype == torch.bool and int(flags.sum()) == 1
        key = br.keys[int(flags.nonzero())]
        assert key == detects_this_frame(cfg, st) == br.read(st)
        seen.add(key)
    assert seen == {True, False}


def test_lanes_predicate_is_the_host_branch():
    cfg = synthetic_config()
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=3))
    br = lanes_branches(cfg)
    states = _states(cfg, n=30, seed=1)
    seen = set()
    for i in range(0, 30, 3):
        lanes = states[i:i + 3]
        for pick in ((0, 1, 2), (0, 0, 0), (1, 1, 1), (2, 2, 2)):
            batch = tree_map(lambda *xs: torch.stack(xs),
                             *[lanes[j] for j in pick])
            flags = br.flags(batch)
            assert flags.dtype == torch.bool and int(flags.sum()) == 1
            key = br.keys[int(flags.nonzero())]
            assert key == lanes_detect(cfg, batch) == br.read(batch)
            seen.add(key)
    assert seen == {True, False, MIXED}
