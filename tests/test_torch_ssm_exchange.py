"""The SSM core's column exchange (``models/collectives.py``): the plan,
which is index arithmetic, and the differentiable all-to-all that moves
the columns, on two gloo processes of the CPU against the gathered
columns of one process.

Split by heads over a model axis of ``m`` cards, card ``r`` holds the
``r``-th even column block of the in-projection's output ``[z | x | B |
C | dt]`` and of the conv channels ``[x | B | C]``; its heads read their
own z, x and dt columns and all of B and C. The tests build those sets
here from the widths alone and hold the plan to them.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_gloo
from repro_torch.models.collectives import (column_blocks,
                                            exchange_columns, exchange_plan,
                                            ssm_columns)
from repro_torch.models.ssm import ssm_dims

ARCHS = ("mamba2-780m", "hymba-1.5b")
# the all-to-all against the gathered columns, fp32
RTOL, ATOL = 1e-4, 1e-5
# the 2-rank run: rows of the exchanged tensor, its seed
ROWS, SEED = (3, 5), 0


def _dims(arch):
    d_inner, n_heads, _, n, _ = ssm_dims(get_config(arch, smoke=True))
    return d_inner, n_heads, n


def _heads_reads(d_inner, n_heads, n, m, r):
    """The columns of the projection and of the conv channels that card
    ``r``'s heads read, as sets, from the widths alone."""
    k, hp = n_heads // m, d_inner // n_heads
    ch = set(range(r * k * hp, (r + 1) * k * hp))
    z, x = ch, {d_inner + c for c in ch}
    bc = set(range(2 * d_inner, 2 * d_inner + 2 * n))
    dt = set(range(2 * d_inner + 2 * n + r * k,
                   2 * d_inner + 2 * n + (r + 1) * k))
    return z | x | bc | dt, ch | set(range(d_inner, d_inner + 2 * n))


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_gives_each_card_its_heads_columns(arch, m):
    d_inner, n_heads, n = _dims(arch)
    cols = ssm_columns(d_inner, n_heads, n, m)
    for held, need, reads in (
            ("proj_blocks", "proj_heads", 0), ("conv_blocks", "conv_heads", 1),
            # the new conv state back to the spec's blocks
            ("conv_heads", "conv_blocks", None)):
        plan = exchange_plan(cols[held], cols[need])
        for d in range(m):
            want = (set(cols[need][d]) if reads is None
                    else _heads_reads(d_inner, n_heads, n, m, d)[reads])
            assert set(cols[need][d]) == want
            assert len(cols[need][d]) == len(want)
            got = [c for s in range(m) for c in plan[s][d]]
            # exactly the needed columns the card lacks, each once, each
            # from a card that holds it; nothing to itself
            assert sorted(got) == sorted(want - set(cols[held][d]))
            assert not plan[d][d]
            for s in range(m):
                assert set(plan[s][d]) <= set(cols[held][s])
        if reads is None:
            # every card computes B and C whole: only x channels go back
            moved = {c for s in range(m) for d in range(m)
                     for c in plan[s][d]}
            assert moved and max(moved) < d_inner


def test_plan_takes_each_column_from_its_lowest_holder():
    plan = exchange_plan([[0, 1, 2], [2, 3], [1, 3]], [[3], [0, 1], [0, 2]])
    assert plan == [[[], [0, 1], [0, 2]], [[3], [], []], [[], [], []]]
    with pytest.raises(ValueError, match="no rank holds"):
        exchange_plan([[0], [1]], [[2], []])
    with pytest.raises(ValueError, match="do not split"):
        column_blocks(10, 4)
    with pytest.raises(ValueError, match="do not split"):
        ssm_columns(512, 8, 16, 3)


def _cases():
    """(name, held, need, whole width) of the three exchanges of mamba2's
    smoke dims on two cards."""
    d_inner, n_heads, n = _dims("mamba2-780m")
    cols = ssm_columns(d_inner, n_heads, n, 2)
    width = 2 * d_inner + 2 * n + n_heads
    return [("proj", cols["proj_blocks"], cols["proj_heads"], width),
            ("conv", cols["conv_blocks"], cols["conv_heads"], d_inner + 2 * n),
            ("back", cols["conv_heads"], cols["conv_blocks"],
             d_inner + 2 * n)]


def _inputs(width):
    """The whole tensor and the generator that draws each card's weight
    of its output in the loss, from numpy's seed."""
    rng = np.random.default_rng(SEED)
    whole = torch.from_numpy(rng.standard_normal(ROWS + (width,),
                                                 dtype=np.float32))
    return whole, rng


def _rank(rank, store, out):
    init_gloo(f"file://{store}", rank, 2)
    try:
        res = {}
        for name, held, need, width in _cases():
            whole, rng = _inputs(width)
            w = [torch.from_numpy(rng.standard_normal(
                ROWS + (len(need[r]),), dtype=np.float32)) for r in range(2)]
            x = whole[..., list(held[rank])].clone().requires_grad_()
            y = exchange_columns(x, dist.group.WORLD, held, need, rank)
            (y * w[rank]).sum().backward()
            res[name] = (y.detach(), x.grad)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _gathered(whole, held, need, w):
    """One process's outputs and gradients: each card's block a leaf of
    its own, every card's output taken from the blocks gathered side by
    side (a column the card holds from its own block, else from the
    lowest card that holds it)."""
    m = len(held)
    blocks = [whole[..., list(held[r])].clone().requires_grad_()
              for r in range(m)]
    where = {}
    for r in reversed(range(m)):
        where.update({c: (r, i) for i, c in enumerate(held[r])})
    outs = []
    for d in range(m):
        mine = {c: i for i, c in enumerate(held[d])}
        outs.append(torch.stack(
            [blocks[d][..., mine[c]] if c in mine
             else blocks[where[c][0]][..., where[c][1]]
             for c in need[d]], dim=-1))
    sum((o * wr).sum() for o, wr in zip(outs, w)).backward()
    return [o.detach() for o in outs], [b.grad for b in blocks]


def test_all_to_all_matches_the_gathered_columns(tmp_path):
    """Each card's output is the columns it needs, and the gradient of
    the sum over the cards of their outputs' weighted sums reaches each
    card's block as in one process that gathers the blocks (B's and C's
    summed over the cards that read them)."""
    mp.start_processes(_rank, args=(tmp_path / "store", tmp_path), nprocs=2,
                       start_method="spawn", join=True)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for name, held, need, width in _cases():
        whole, rng = _inputs(width)
        w = [torch.from_numpy(rng.standard_normal(
            ROWS + (len(need[r]),), dtype=np.float32)) for r in range(2)]
        outs, grads = _gathered(whole, held, need, w)
        for r in range(2):
            y, g = got[r][name]
            torch.testing.assert_close(y, outs[r], rtol=RTOL, atol=ATOL,
                                       msg=f"{name} rank {r}")
            torch.testing.assert_close(g, grads[r], rtol=RTOL, atol=ATOL,
                                       msg=f"{name} grad rank {r}")
