"""Port parity: ``bench/profile_refine.py`` (the descriptor refine's
gather layouts) against ``scripts/profile_refine.py``'s level functions
(``tests/torch_profile_refine_jax.py``) on the same numpy inputs, at 24x32
with the script's F = 24, r = 3.

Tolerance: both sides round the descriptors to bf16 and sum the products
in float32, in different orders, so a window whose best and second-best
scores are within those sums' rounding can pick either. A position must be
equal wherever its best and second-best scores (float64 sums of the same
bf16 values) differ by more than ``MARGIN``; along the five levels of "B
full" the smallest margin over the levels of the JAX path counts. The
count of near-ties is printed and stays under 1% of the positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_profile_refine_jax as J
from mast3r_slam_tpu_torch.bench import profile_refine as P
from torch_parity import torch_one_thread  # noqa: F401

HW = (24, 32)
MARGIN = 1e-3


def _inputs():
    return P.make_inputs(HW)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)).astype(np.float64)


def _margins(D11, D21, pq, dil):
    """Best minus second-best window score of every position, float64 sums
    of the bf16-rounded descriptors, candidates wrapping as the rolls do.
    Two offsets that wrap onto the same pixel (at dilation 4 on 24 rows)
    score the same bits in either package, and both take the first: the
    second best is the best of the other pixels."""
    H, W = D11.shape[1:3]
    D, q = _bf16(D11[0]), _bf16(D21[0])
    offs = P.offsets(P.R, dil)
    pu = np.clip(pq[0, :, 0], 0, W - 1)
    pv = np.clip(pq[0, :, 1], 0, H - 1)
    rows = np.stack([(pv + dv) % H for _, dv in offs], -1)
    cols = np.stack([(pu + du) % W for du, _ in offs], -1)
    sc = (D[rows, cols] * q[:, None]).sum(-1)
    cell = rows * W + cols
    best = sc.argmax(-1)[:, None]
    same = cell == np.take_along_axis(cell, best, -1)
    other = np.where(same, -np.inf, sc).max(-1)
    return np.take_along_axis(sc, best, -1)[:, 0] - other


def _check(got, want, margin, what):
    got = got.numpy()
    clear = margin > MARGIN
    ties = int((~clear).sum())
    print(f"{what}: {ties} near-ties of {clear.size} positions")
    assert ties <= 0.01 * clear.size, (what, ties)
    np.testing.assert_array_equal(got[0][clear], want[0][clear])


@pytest.mark.parametrize("name", ["A", "B", "D"])
def test_level_matches_the_script(name):
    D11, D21, p1 = _inputs()
    port = getattr(P, f"level_{name}")(torch.from_numpy(D11),
                                       torch.from_numpy(p1),
                                       torch.from_numpy(D21), P.DIL)
    want = np.asarray(getattr(J, f"level_{name}")(
        jnp.asarray(D11), jnp.asarray(p1.astype(np.int32)),
        jnp.asarray(D21), dil=P.DIL))
    assert port.shape == want.shape and port.dtype == torch.int64
    _check(port, want, _margins(D11, D21, p1, P.DIL), f"level {name}")


def test_full_B_matches_the_script():
    D11, D21, p1 = _inputs()
    port = P.full_B(torch.from_numpy(D11), torch.from_numpy(p1),
                    torch.from_numpy(D21))
    want, path = J.full_B(jnp.asarray(D11),
                          jnp.asarray(p1.astype(np.int32)),
                          jnp.asarray(D21))
    margin = np.min([_margins(D11, D21, pq, d) for d, pq in path], 0)
    _check(port, np.asarray(want), margin, "B full 5 levels")


def test_margin_check_sees_a_moved_position():
    """The check itself: one position moved by a pixel where its margin is
    clear fails it."""
    D11, D21, p1 = _inputs()
    port = P.level_B(torch.from_numpy(D11), torch.from_numpy(p1),
                     torch.from_numpy(D21), P.DIL)
    margin = _margins(D11, D21, p1, P.DIL)
    bad = port.clone()
    bad[0, int(np.argmax(margin)), 0] += 1
    with pytest.raises(AssertionError):
        _check(bad, port.numpy(), margin, "moved")


def test_tool_runs_every_variant_on_the_cpu(capsys):
    """``main(device="cpu")``: one JSON record a variant and the production
    search, each with its ms, digest and "cpu"; the script's variants at
    one level agree with level B's digest where B has no near-tie."""
    records = P.main(["--device", "cpu", "--hw", *map(str, HW), "--reps",
                      "1"], device="cpu")
    names = [r["variant"] for r in records]
    assert names == [f"{v} dil=5" for v in P.VARIANTS] + [
        "B full 5 levels", "production _search dil=5",
        "production refine_matches (joint)"]
    for r in records:
        assert r["device"] == "cpu" and r["ms"] > 0 and len(r["digest"]) == 16
    out = capsys.readouterr().out
    assert out.count('"variant"') == len(records)


def test_production_search_is_the_refine_first_level():
    """The production line times what ``refine_matches`` runs: a level of
    it is ``production_search`` (at dilation 1, its only level), and its
    five levels are ``production_refine``."""
    from mast3r_slam_tpu_torch.ops import matching

    D11, D21, p1 = (torch.from_numpy(a) for a in _inputs())
    one = P.production_search(D11, p1, D21, dil=1)
    assert torch.equal(one, matching.refine_matches(D11, D21, p1, 3, 1,
                                                    "joint", 1))
    assert torch.equal(P.production_refine(D11, p1, D21),
                       matching.refine_matches(D11, D21, p1, 3, 5, "joint",
                                               1))
