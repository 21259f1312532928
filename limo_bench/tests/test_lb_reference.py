"""The output check on the CPU at a tiny size: the reference agrees with
the port's CPU path, and ``correct`` comes out false under the control and
under each fault a cell can have."""

import pytest
import torch

from lbcore import check
from lbcore import main as lb
from reference import control, host

ARGS = ["--seed", "2147483659", "--seconds", "2"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["tiny.live", "tiny.replay4"])
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, cell):
    result, lines = lb.run(["--workload", cell] + ARGS, tiny_root, device="cpu")
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks" and lines[-len(check.NAMES):][0].startswith("pos_gap_m")


def _unchanged(inner):
    def step(state, *packs):
        _, out = inner(state, *packs)
        return state, out._replace(pos=state.x.pos + 0 * out.pos, quat=state.x.rot + 0 * out.quat)
    return step


def _half_batch(inner):
    def step(state, scan_pack, imu_pack):
        n = scan_pack.shape[-2]
        sp = scan_pack.clone()
        sp[..., n // 2:, :] = 0          # zero rows fall to the distance filter
        return inner(state, sp, imu_pack)
    return step


def _altered(inner):
    def step(state, *packs):
        new, out = inner(state, *packs)
        return (new._replace(x=new.x._replace(pos=new.x.pos + 0.01)),
                out._replace(pos=out.pos + 0.01))
    return step


def _no_insert(inner):
    def step(state, *packs):
        new, out = inner(state, *packs)
        return new._replace(map=state.map), out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _no_insert],
                         ids=["state-unchanged", "half-the-batch", "answer-altered",
                              "insert-stores-nothing"])
def test_a_broken_step_is_not_correct(tiny_root, fault):
    for cell in ("tiny.live", "tiny.replay4"):
        result, lines = lb.run(["--workload", cell] + ARGS, tiny_root, device="cpu",
                               fault=fault)
        assert not result["correct"], (cell, lines)
        if fault is _no_insert:     # caught by the map alone
            assert result["checks"]["map_gap"]["value"] == 1.0, lines


def test_the_bfloat16_control_is_not_correct(tiny_root):
    ctx = lb.measure(["--workload", "tiny.live"] + ARGS, tiny_root, "cpu")
    worst = {k: 0.0 for k in check.NAMES}
    for s in ctx.samples:
        ref_post, ref_outs = host.step(ctx.stream, s.scans, s.pre, "cpu")
        with control.Bfloat16():
            c_post, c_outs = host.step(ctx.stream, s.scans, s.pre, "cpu")
        outs = tuple(torch.stack([getattr(o, f) for o in c_outs]) for f in ("pos", "quat", "vel"))
        g = check.gaps(s.pre, c_post, outs, ref_post, ref_outs)
        worst = {k: max(worst[k], g[k]) for k in check.NAMES}
    ok, lines = check.judge(worst, ctx.cell.limits)
    assert not ok, lines
