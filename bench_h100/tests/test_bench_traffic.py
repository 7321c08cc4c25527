"""The traffic is a function of the seed, and every seed offers the same
work."""
import numpy as np
import pytest
import torch

from bench_h100 import cells, traffic

MIX = cells.read_json("mixes", "sot_b256")


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345])
def test_same_seed_same_inputs(seed):
    a = traffic.serve_calls(dict(MIX, batch=8), seed, torch.device("cpu"))
    b = traffic.serve_calls(dict(MIX, batch=8), seed, torch.device("cpu"))
    assert len(a) == MIX["distinct_calls"]
    for ca, cb in zip(a, b):
        assert ca.audio_s == cb.audio_s
        for x, y in zip(ca.wavs, cb.wavs):
            np.testing.assert_array_equal(x, y)


def test_every_seed_offers_the_same_lengths():
    lens = [sorted(len(w) for w in traffic.serve_calls(
        dict(MIX, batch=16), s, torch.device("cpu"))[0].wavs)
        for s in (1, 2, 3_000_000_000)]
    assert lens[0] == lens[1] == lens[2]
    a = traffic.serve_calls(dict(MIX, batch=16), 1, torch.device("cpu"))
    b = traffic.serve_calls(dict(MIX, batch=16), 2, torch.device("cpu"))
    assert [len(w) for w in a[0].wavs] != [len(w) for w in b[0].wavs]
    assert not np.array_equal(a[0].wavs[0][:100], b[0].wavs[0][:100])


def test_lengths_cover_the_mix_range_in_one_bucket():
    n = traffic.stratified_lengths(*MIX["lengths_s"], MIX["batch"])
    assert n.min() > 6 * 16000 and n.max() < 10 * 16000
    assert abs(n.mean() / 16000 - 8.0) < 1e-3
