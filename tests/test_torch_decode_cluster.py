"""The cluster-size choosers of the decode kernels (#4, and #6 over the
int8 cache): how many blocks, one thread-block cluster, split one (batch
row, kv head)'s cache. Pure Python: the card runs what they choose
(`tests/test_torch_cuda.py`)."""
import itertools

import torch

from mtasr_tpu_torch.ops.kernels import decode_attention as da
from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


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


def test_int8_cluster_size_covers_the_card_and_gives_every_block_a_key():
    """#6's chooser (`cluster_size_int8`): the same rule over the int8
    kernel's ring tile: the groups of 4 key rows, padded to 16 bytes, that
    fit 8 KB."""
    for B, Hkv, S, sms, D in itertools.product(
            (1, 3, 8, 16, 64, 512), (1, 2, 8), (1, 2, 5, 7, 8, 100, 214,
                                                20000),
            (132, 114, 16), (4, 40, 48, 64, 128, 256)):
        C = di.cluster_size_int8(B, Hkv, S, sms, D)
        assert 1 <= C <= min(8, S)
        assert all(S * (r + 1) // C > S * r // C for r in range(C))
        if B * Hkv >= sms:
            assert C == 1
            continue
        least = min(8, S, -(-sms // (B * Hkv)))    # covers the SMs
        tile = 8192 // (-(-D // 16) * 16) // 4 * 4  # keys of a ring slot
        assert C >= least and B * Hkv * C >= min(sms, B * Hkv * min(8, S))
        if C > least:                              # raised to one tile
            assert -(-S // C) <= tile < -(-S // (C - 1))


def test_int8_card_test_shapes_reach_every_cluster_size():
    # the shapes of test_torch_cuda.py::
    # test_decode_int8_kernel_covers_every_cluster_size, with the C each
    # asserts
    shapes = [(64, 214, 8, 64, 1), (11, 120, 6, 64, 2), (8, 150, 8, 64, 3),
              (5, 214, 8, 64, 4), (4, 300, 8, 128, 5), (3, 214, 8, 64, 6),
              (1, 7, 8, 64, 7), (1, 1000, 8, 64, 8), (1, 5, 8, 64, 5),
              (2, 3, 2, 64, 3), (2, 9, 2, 40, 8), (3, 50, 4, 256, 8),
              (3, 77, 8, 64, 6), (1, 30000, 8, 64, 8),
              (17, 20000, 8, 64, 1), (17, 700, 8, 48, 1)]
    assert [di.cluster_size_int8(B, hkv, S, 132, D)
            for B, S, hkv, D, _ in shapes] == [C for *_, C in shapes]
    assert {C for *_, C in shapes} == set(range(1, 9))


def test_int8_cluster_size_at_the_served_shapes():
    # LLaMA-3.2-1B at the smoke's S = 214: the fewest blocks that cover
    # 132 SMs already give a slice of one 128-key tile (B = 8: 3 blocks of
    # 72 keys; on the H100 C = 1, 3 and 4 read within 3 % there)
    assert [di.cluster_size_int8(B, 8, 214) for B in (1, 8, 16, 17, 64)] \
        == [8, 3, 2, 1, 1]
    assert di.cluster_size_int8(8, 8, 1000) == 8   # raised to one tile
