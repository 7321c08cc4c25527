"""The byte and operation counts behind the rooflines, against hand counts
at the cells' geometries."""
import pytest

from bench_h100 import cells, roofline as R

SMOL = cells.read_json("configs", "wavlm-large_smollm2-1.7b")
MIS = cells.read_json("configs", "wavlm-large_mistral-7b-v0.3_w8a8")


def test_decode_attention_bf16_hand_count():
    # SmolLM2: D 64, 32 q / 32 kv heads, 24 layers. Two rows with 62 and
    # 50 valid speech frames in a 63-frame block, 2 steps: valid keys
    # (1 + 62 + t) + (1 + 50 + t) = 116, 118; mask slots 2 (1 + 63 + t)
    # = 130, 132; a key's K and V 2 * 32 * 64 * 2 B; q and out 2 * 32 *
    # 64 * 2 B a row and step
    b, o = R.decode_attention_call(SMOL["decoder"], [62, 50], 63, 2, False)
    per_layer = 234 * 8192 + 4 * 8192 + 262
    assert b == 24 * per_layer == 46_798_992
    assert o == 24 * 4 * 64 * 32 * 234 == 46_006_272


def test_decode_attention_int8_hand_count():
    # Mistral w8a8: D 128, 32 q / 8 kv heads, 32 layers; a key's int8 K
    # and V 2 * 8 * 128 B and its bf16 scales 2 * 8 * 2 B
    b, o = R.decode_attention_call(MIS["decoder"], [62, 50], 63, 2, True)
    per_layer = 234 * 2080 + 4 * 16384 + 262
    assert b == 32 * per_layer == 17_680_576
    assert o == 32 * 4 * 128 * 32 * 234 == 122_683_392


def test_flash_attention_hand_count():
    # WavLM-Large: 24 layers of 16 heads of 64; two rows of 499 frames,
    # 499 and 300 valid keys: q, k, v, out 2 * 499 * 1024 * 2 B each, the
    # bias table 16 * 499^2 * 2 B, the gate 2 * 16 * 499 * 2 B, 2 lengths
    b, o = R.flash_attention_call(SMOL["encoder"], 2, 499, [499, 300])
    per_layer = 4 * 2 * 499 * 1024 * 2 + 16 * 499 * 499 * 2 \
        + 2 * 16 * 499 * 2 + 4 * 2
    assert b == 24 * per_layer == 388_214_208
    assert o == 24 * 4 * 64 * 16 * 499 * 799 == 39_193_903_104


def test_lengths_of_a_10_s_bucket():
    enc = SMOL["encoder"]
    assert R.conv_len(enc, 160000) == 499
    assert R.adapter_lens(enc, 499) == [250, 125, 63]


def test_bound_takes_the_larger_side():
    t, by = R.bound(3.35e12, 1.0, "bf16")
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = R.bound(1.0, 989e12 * 2, "bf16")
    assert by == "operations" and t == pytest.approx(2.0)
    assert R.bound(0.0, 1979e12, "int8")[0] == pytest.approx(1.0)


def test_sot_call_ops_scale_with_steps_and_split_int8():
    rows = [128000] * 4
    a = R.sot_call_ops(SMOL["encoder"], SMOL["decoder"], rows, 160000, 10,
                       False)
    b = R.sot_call_ops(SMOL["encoder"], SMOL["decoder"], rows, 160000, 20,
                       False)
    assert a["int8"] == 0 and b["bf16"] > a["bf16"]
    m = R.sot_call_ops(MIS["encoder"], MIS["decoder"], rows, 160000, 10,
                       True)
    # the decoder's linears alone: 2 * rows * params a step
    lin = 2 * 4 * (32 * R.decoder_layer_params(MIS["decoder"])
                   + 4096 * 32776)
    assert m["int8"] > 10 * lin
    assert R.decoder_layer_params(MIS["decoder"]) == (
        4096 * 48 * 128 + 4096 * 4096 + 3 * 4096 * 14336)
