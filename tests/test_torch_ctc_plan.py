"""The CTC kernels' launch plan (`ops/kernels/ctc.py::ctc_plan`), a pure
function of the lattice: pure Python, no kernel runs."""
import pytest

from mtasr_tpu_torch.ops.kernels import ctc as kc


def _route_ok(S, K, warps, halo):
    """What `csrc/ctc.cu`'s `ctc_launch` takes: one warp of one position a
    lane, or at most 32 warps of one or two positions a lane with halo
    lanes (an even number of halo positions, at most 16 lanes), the warps'
    own lanes covering S."""
    if K not in (1, 2) or not 1 <= warps <= 32:
        return False
    if warps == 1:
        return halo == 0 and K == 1 and S <= 32
    return 1 <= halo <= 16 and halo * K % 2 == 0 and \
        warps * (32 - halo) * K >= S


@pytest.mark.parametrize("T", [1, 499, 4000])
def test_ctc_plan_covers_every_lattice(T):
    for S in range(1, kc.MAX_S + 1):
        p = kc.ctc_plan(S, T)
        assert _route_ok(S, p.K, p.warps, p.halo), (S, p)
        assert p.K * 32 * p.warps >= S, S
        if S <= 32:
            assert (p.K, p.warps) == (1, 1), S
        assert p.Tc >= 1 and p.stages in (1, 2), S
        assert p.smem_bytes == kc.smem_bytes(1, S, p.K, p.warps, p.halo,
                                             p.Tc, p.stages)
        assert kc.smem_bytes(0, S, p.K, p.warps, p.halo, p.Tc,
                             p.stages) <= p.smem_bytes <= kc.SMEM_MAX, S
        # the ring does not grow with T
        assert p.smem_bytes <= kc.ctc_plan(S, 10 ** 6).smem_bytes, S


def test_ctc_routes_fit_a_block():
    for S in range(1, kc.MAX_S + 1):
        routes = kc.ctc_routes(S)
        p = kc.ctc_plan(S, 499)
        assert (p.K, p.halo) in routes, S
        for K, H in routes:
            q = kc.plan_for(S, 499, K, H)
            assert _route_ok(S, q.K, q.warps, q.halo), (S, q)
            assert q.smem_bytes <= kc.SMEM_MAX, (S, q)


def test_ctc_plan_refuses_lattices_past_a_block():
    for S in (0, kc.MAX_S + 1):
        with pytest.raises(ValueError, match="S = "):
            kc.ctc_plan(S, 499)
