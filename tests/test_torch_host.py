"""The port's host modules (config, tokenizer, waveform input, decode
batches, transcript clean-up) against their JAX-package counterparts, on
the same seeded inputs: equal values, equal ids, equal arrays (exact, or
float32 atol 1e-6 where scipy / numpy arithmetic is involved)."""
import dataclasses

import numpy as np
import pytest
import torch

from mtasr_tpu import config as jconfig
from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.data import audio as jaudio
from mtasr_tpu.data import tokenizer as jtok
from mtasr_tpu.utils.wer import clean_decoded_text as jclean
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data import audio as taudio
from mtasr_tpu_torch.data import tokenizer as ttok
from mtasr_tpu_torch.utils.wer import clean_decoded_text
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def _assert_fields_equal(port, ref):
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if f.name in tconfig.DEEPSEEK_FIELDS and not hasattr(ref, f.name):
            # the port's own decoder fields: the JAX package has no such
            # decoder, so they hold their defaults
            assert value == f.default, f.name
            continue
        if dataclasses.is_dataclass(value):
            _assert_fields_equal(value, getattr(ref, f.name))
        else:
            assert value == getattr(ref, f.name), f.name


@pytest.mark.parametrize("name,kw", [
    ("wavlm_large_config", {}),
    ("wavlm_large_config", dict(mask_time_prob=0.0, num_hidden_layers=2)),
    ("llama_1b_config", {}),
    ("llama_1b_config", dict(vocab_size=128264, eos_token_id=2)),
    ("WavLMConfig", {}),
    ("LlamaConfig", {}),
    ("SpeechEncoderDecoderConfig", {}),
    ("GenerationConfig", {}),
    ("DataConfig", {}),
    ("TrainingConfig", {}),
    ("TrainingConfig", dict(learning_rate=1e-3,
                            gradient_accumulation_steps=4)),
])
def test_config_defaults_and_builders_match(name, kw):
    """Every field the port has holds the JAX package's value."""
    _assert_fields_equal(getattr(tconfig, name)(**kw),
                         getattr(jconfig, name)(**kw))


def test_config_length_arithmetic_and_from_fields():
    ref = tiny_cfg(train_mode="attention", instruct=True,
                   bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                   eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)
    port = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, ref)
    _assert_fields_equal(port, ref)
    port.validate()
    assert port.decoder.head_dim_ == ref.decoder.head_dim_
    assert port.encoder.out_hidden == ref.encoder.out_hidden
    for enc in (port.encoder, tconfig.wavlm_large_config()):
        jenc = jconfig.WavLMConfig(**{f.name: getattr(enc, f.name)
                                      for f in dataclasses.fields(enc)})
        for n in (1, 400, 4000, 160000, 160001):
            assert enc.conv_output_length(n) == jenc.conv_output_length(n)
            assert enc.adapter_output_length(n) == \
                jenc.adapter_output_length(n)
            assert enc.adapter_output_length(n, 2) == \
                jenc.adapter_output_length(n, 2)
    bad = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, ref)
    bad.eosr_token_id = ref.decoder.vocab_size
    with pytest.raises(ValueError, match="resize vocab"):
        bad.validate()


def test_hybrid_config_fields_and_validation_match():
    """The separator / CTC-head fields and properties of a talker_ctc
    config, and the same refusals as the JAX config's validate."""
    ref = tiny_cfg(train_mode="hybrid", talker_ctc=True,
                   separator_dropout=0.1)
    port = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, ref)
    _assert_fields_equal(port, ref)
    port.validate()
    assert (port.ctc_blank_id, port.ctc_odim) == (ref.ctc_blank_id,
                                                  ref.ctc_odim)
    for bad in (dict(talker_ctc=False), dict(talker_numbers=1),
                dict(talker_ctc=False, train_mode="ctc"),
                dict(talker_ctc=False, talker_ctc_refine=True)):
        jbad = dataclasses.replace(ref, **bad)
        tbad = dataclasses.replace(port, **bad)
        with pytest.raises(ValueError) as jerr:
            jbad.validate()
        with pytest.raises(ValueError) as terr:
            tbad.validate()
        assert "talker" in str(jerr.value) and "talker" in str(terr.value)


@pytest.mark.parametrize("instruct", [False, True])
def test_char_tokenizer_matches(instruct):
    jt, tt = jtok.CharTokenizer(), ttok.CharTokenizer()
    assert dataclasses.asdict(tt.add_special_tokens(instruct)) == \
        dataclasses.asdict(jt.add_special_tokens(instruct))
    assert len(tt) == len(jt)
    texts = ["hello <sc> world", "a<b>c <pad>", "ünïcode 42's <eos_prompt",
             "<bos_prompt>both<eos_prompt><bos_speech>"]
    for text in texts:
        for add_bos in (False, True):
            assert tt.encode(text, add_bos) == jt.encode(text, add_bos)
    ids = np.random.default_rng(0).integers(0, len(jt) + 5, 200)
    for skip in (False, True):
        assert tt.decode(ids, skip) == jt.decode(ids, skip)
    assert tt.decode([len(tt) + 3]) == ""
    assert ttok.build_prompt_and_input("p", "r") == \
        jtok.build_prompt_and_input("p", "r")


@pytest.mark.parametrize("width,sr", [(2, 16000), (2, 8000)])
def test_waveform_input_matches(tmp_path, width, sr):
    wav = (np.random.default_rng(1).standard_normal(3000) * 0.2)\
        .astype(np.float32)
    path = str(tmp_path / "x.wav")
    jaudio.write_wav(path, wav, sr)
    data, rate = taudio.read_wav(path)
    ref, ref_rate = jaudio.read_wav(path)
    assert rate == ref_rate
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_allclose(taudio.resample(data, rate, 16000),
                               jaudio.resample(ref, rate, 16000), atol=1e-6)
    np.testing.assert_allclose(taudio.normalize_waveform(data),
                               jaudio.normalize_waveform(ref), atol=1e-6)


@pytest.mark.parametrize("instruct", [False, True])
def test_decode_batches_match(tmp_path, instruct):
    """Mixed lengths over three buckets, one past the last bucket (which
    gets a bucket of its own), one WAV path at 8 kHz: the same batches, in
    the same order, with the same arrays as the JAX Transcriber's. (In
    instruct mode the JAX Transcriber gives a WAV path's example labels,
    and a batch that mixes it with a waveform fails its label checks; the
    instruct case therefore takes waveforms only.)"""
    cfg = tiny_cfg(train_mode="attention")
    jt, tt = jtok.CharTokenizer(), ttok.CharTokenizer()
    sp = jt.add_special_tokens(instruct=instruct)
    tt.add_special_tokens(instruct=instruct)
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    if instruct:
        cfg.instruct = True
        for name in ("bosp", "eosp", "boss", "eoss", "bosr", "eosr"):
            setattr(cfg, f"{name}_token_id", getattr(sp, f"{name}_token_id"))
    dc = jconfig.DataConfig(min_duration_in_seconds=0.0,
                            max_duration_in_seconds=1e9,
                            bucket_boundaries_seconds=(0.25, 0.5))
    rng = np.random.default_rng(2)
    path = str(tmp_path / "y.wav")
    jaudio.write_wav(path, (rng.standard_normal(2500) * 0.2)
                     .astype(np.float32), 8000)
    audio = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (3000, 7000, 12000, 2000, 3900)]
    if not instruct:
        audio.append(path)
    prompt = "Both Speakers"
    ref = JaxTranscriber(cfg, None, jt, dc=dc)
    port = Transcriber(
        tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg), None,
        tt, dc=tconfig.from_fields(tconfig.DataConfig, dc))
    got = list(port._batches(port._examples(audio, prompt), 2))
    want = list(ref._batches(ref._examples(audio, prompt), 2))
    assert [b.utt_ids for b in got] == [b.utt_ids for b in want]
    for g, w in zip(got, want):
        assert set(g.arrays) == {k for k in w.arrays
                                 if k in ("input_values", "audio_mask",
                                          "prompt_ids")}
        for key, value in g.arrays.items():
            np.testing.assert_allclose(value, w.arrays[key], atol=1e-6,
                                       err_msg=key)


def test_clean_decoded_text_matches():
    for text in ["a b<sc>c  d", "<bos_response>hi<eos_response><pad><pad>",
                 "x<unk>y <sc><sc> z<eos>", "", "   <sc>   "]:
        assert clean_decoded_text(text) == jclean(text)


def _sot_labels(rng, B, sc, pad_rows=True):
    rows = []
    for _ in range(B):
        rows.append(list(rng.integers(3, 40, rng.integers(2, 6))) + [sc]
                    + list(rng.integers(3, 40, rng.integers(2, 6))))
    L = max(len(r) for r in rows) + (2 if pad_rows else 0)
    out = np.full((B, L), -100, np.int64)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    return out


@pytest.mark.parametrize("instruct,split", [(False, True), (False, False),
                                            (True, True)])
def test_label_surgery_matches(instruct, split):
    from mtasr_tpu.data import labels as jlabels
    from mtasr_tpu_torch.data import labels as tlabels
    rng = np.random.default_rng(3)
    raw = _sot_labels(rng, 4, 51)
    kw = dict(pad_token_id=50, decoder_start_token_id=1, eos_token_id=2,
              sc_token_id=51, talker_numbers=2, split_speakers=split)
    if instruct:
        pre = np.tile([52, 20, 21, 53, 54, 55, 56], (4, 1))
        raw = np.concatenate([pre, raw, np.full((4, 1), -100)], axis=1)
        for b in range(4):          # <eosr> at the end of the response
            raw[b, np.argmax(raw[b] == -100)] = 57
        kw.update(instruct=True, eosr_token_id=57, bosp_token_id=52,
                  eosp_token_id=53, bosr_token_id=56)
    for pad_to in (None, 12):
        got = tlabels.build_training_arrays(raw, label_spk_pad_to=pad_to,
                                            **kw)
        want = jlabels.build_training_arrays(raw, label_spk_pad_to=pad_to,
                                             **kw)
        assert set(got) == set(want)
        for key, value in got.items():
            np.testing.assert_array_equal(value, want[key], err_msg=key)
    bad = raw.copy()
    bad[0][bad[0] == 51] = 7                     # no <sc>: refused by both
    if split:
        with pytest.raises(ValueError, match="separators"):
            tlabels.build_training_arrays(bad, **kw)


@pytest.mark.parametrize("prob,length,min_masks", [(0.05, 10, 2),
                                                   (0.3, 4, 0), (0.0, 10, 0),
                                                   (0.65, 10, 2)])
def test_spec_augment_masks_identical(prob, length, min_masks):
    from mtasr_tpu.data.specaugment import compute_mask_indices as jmask
    from mtasr_tpu_torch.data.specaugment import compute_mask_indices
    lens = np.asarray([499, 321, 12, 499])
    att = (np.arange(499)[None] < lens[:, None]).astype(int)
    for seed in range(3):
        got = compute_mask_indices((4, 499), prob, length, att, min_masks,
                                   np.random.default_rng(seed))
        want = jmask((4, 499), prob, length, att, min_masks,
                     np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        compute_mask_indices((2, 50), 0.2, 5, rng=np.random.default_rng(9)),
        jmask((2, 50), 0.2, 5, rng=np.random.default_rng(9)))


@pytest.mark.parametrize("instruct", [False, True])
def test_training_batches_match(instruct):
    """`batches_from_examples` (training collate: label surgery, the
    SpecAugment time mask from the shared numpy stream, padding to
    max_label_length) gives the JAX package's batches, in its order."""
    from mtasr_tpu.data import pipeline as jpipe
    from mtasr_tpu_torch.data import pipeline as tpipe
    cfg = tiny_cfg(train_mode="attention")
    cfg.encoder.mask_time_prob = 0.05
    cfg.encoder.mask_time_length = 4
    prompt = [52, 20, 21, 53, 54, 55, 56] if instruct else []
    if instruct:
        cfg.instruct = True
        for i, name in enumerate(("bosp", "eosp", "boss", "eoss", "bosr",
                                  "eosr")):
            setattr(cfg, f"{name}_token_id", 52 + i)
    rng = np.random.default_rng(4)
    jex, tex = [], []
    for i in range(9):
        wav = (rng.standard_normal(int(rng.integers(2000, 7000))) * 0.2)\
            .astype(np.float32)
        lab = [int(x) for x in _sot_labels(rng, 1, cfg.sc_token_id,
                                           False)[0]]
        if instruct:
            lab = [52, 20, 21, 53, 54, 55, 56] + lab + [57]
        pr = prompt[:4] if instruct else []
        jex.append(jpipe.PreparedExample(f"u{i}", wav, lab, pr, len(wav)))
        tex.append(tpipe.PreparedExample(f"u{i}", wav, pr, lab))
    dc = jconfig.DataConfig(bucket_boundaries_seconds=(0.25, 0.5),
                            max_label_length=30)
    tdc = tconfig.from_fields(tconfig.DataConfig, dc)
    tcfg = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)
    for kw in (dict(seed=5), dict(seed=6, pad_partial=True, shuffle=True),
               dict(training=False, shuffle=False, drop_last=False)):
        got = list(tpipe.batches_from_examples(tex, tcfg, tdc, 2, **kw))
        want = list(jpipe.batches_from_examples(jex, cfg, dc, 2, **kw))
        assert [b.utt_ids for b in got] == [b.utt_ids for b in want]
        for g, w in zip(got, want):
            assert g.splice_index == w.splice_index
            keys = {k for k in w.arrays if not k.startswith("label_spk")}
            assert set(g.arrays) == keys
            for key in keys:
                np.testing.assert_array_equal(g.arrays[key], w.arrays[key],
                                              err_msg=key)
        assert any("mask_time_indices" in b.arrays for b in got) == \
            kw.get("training", True)


def test_wer_calculator_matches():
    from mtasr_tpu.utils.wer import Calculator as JCalc
    from mtasr_tpu.utils.wer import wer as jwer
    from mtasr_tpu_torch.utils.wer import Calculator, wer
    rng = np.random.default_rng(5)
    words = ["a", "b", "<sc>", "C", "dd", "<unk>"]
    got, want = Calculator(), JCalc(use_native=False)
    for i in range(40):
        lab = " ".join(rng.choice(words, rng.integers(0, 8)))
        rec = " ".join(rng.choice(words, rng.integers(0, 8)))
        g, w = got.calculate(str(i), lab, rec), want.calculate(str(i), lab,
                                                               rec)
        assert (g.all, g.cor, g.sub, g.dele, g.ins) == \
            (w.all, w.cor, w.sub, w.dele, w.ins)
        assert wer(lab, rec, char_mode=i % 2 == 1) == \
            jwer(lab, rec, char_mode=i % 2 == 1)
    assert got.overall().wer == want.overall().wer
