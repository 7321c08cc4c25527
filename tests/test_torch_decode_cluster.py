"""The cluster-size chooser of the decode kernel (#4): how many blocks,
one thread-block cluster, split one (batch row, kv head)'s cache. Pure
Python: the card runs what it chooses (`tests/test_torch_cuda.py`)."""
import itertools

from mtasr_tpu_torch.ops.kernels import decode_attention as da


def test_cluster_size_covers_the_card_and_gives_every_block_a_key():
    for B, Hkv, S, sms, D in itertools.product(
            (1, 3, 8, 16, 64, 512), (1, 2, 8), (1, 2, 7, 8, 100, 214, 20000),
            (132, 114, 16), (2, 40, 64, 128, 256)):
        C = da.cluster_size(B, Hkv, S, sms, D)
        assert 1 <= C <= 8 and C <= S
        # the kernel's split: block r of C holds [S r / C, S (r + 1) / C)
        assert all(S * (r + 1) // C > S * r // C for r in range(C))
        if B * Hkv >= sms:
            assert C == 1
            continue
        least = min(8, S, -(-sms // (B * Hkv)))    # covers the SMs
        tile = 4096 // (-(-D // 8) * 8)            # keys of a ring slot
        assert C >= least and B * Hkv * C >= min(sms, B * Hkv * min(8, S))
        if C > least:                              # raised to one tile
            assert -(-S // C) <= tile < -(-S // (C - 1))


def test_cluster_size_at_the_served_shapes():
    # LLaMA-3.2-1B: 8 kv heads of 64, the smoke's S = 214, on 132 SMs; at
    # B = 8 the 3 blocks that cover the card would hold 72 keys, two ring
    # tiles, and 4 hold 54
    assert [da.cluster_size(B, 8, 214) for B in (1, 8, 16, 17, 32, 64)] == \
        [8, 4, 4, 1, 1, 1]
    assert da.cluster_size(8, 8, 1000) == 3        # no C <= 8 gives a tile


def test_card_test_shapes_reach_every_cluster_size():
    # the shapes of test_torch_cuda.py::
    # test_decode_kernel_covers_every_cluster_size, in order
    shapes = [(64, 214, 8, 64), (11, 120, 6, 64), (8, 150, 8, 64),
              (5, 214, 8, 64), (4, 300, 8, 128), (3, 214, 8, 64),
              (1, 7, 8, 64), (1, 1000, 8, 64)]
    assert [da.cluster_size(B, hkv, S, 132, D) for B, S, hkv, D in shapes] \
        == list(range(1, 9))
