"""The port's host C++ (`mtasr_tpu_torch/native/`, bound by
`mtasr_tpu_torch/utils/native.py`) against the JAX package's
(`native/`, `mtasr_tpu/utils/native.py`), both built by g++ with the same
flags from their own copies of the sources: bit-equal results.

* The batch WAV loader across the PCM widths and channel counts of
  `tests/test_native.py:136-159` (and float32), the header, the per-row
  status codes (another sample rate, a missing file, a good row beside
  them), and rows longer than the buffer;
* `wer_align`, `wer_align_ops`, `wer_align_batch` and `cpwer_native` on
  seeded id sequences (empty ones included);
* the port's `Calculator` and `cpwer` with the native alignment against
  their Python path: equal counts and alignments;
* the port's `collate` against the JAX package's on lazy examples (mixed
  lengths, an 8 kHz row that the native loader refuses and Python
  resamples), both with their native loaders and both without: bit-equal;
* the library is built under `mtasr_tpu_torch/` and never from the
  repo-root `native/`.
"""
import os
import wave

import numpy as np
import pytest
import torch

from mtasr_tpu.utils import native as jnative
from mtasr_tpu_torch.utils import native as tnative
from mtasr_tpu_torch.utils import wer as twer

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(tnative.__file__ + "/.."))


def _write_wav(path, data, sr=16000, width=2, channels=1):
    """`tests/test_native.py::_write_test_wav`, plus float32 (width 0)."""
    data = np.asarray(data, np.float32)
    if channels > 1:
        data = np.stack([data * (c + 1) / channels for c in range(channels)],
                        axis=1)
    flat = np.clip(data, -1.0, 1.0).reshape(-1)
    if width == 0:               # IEEE float: a hand-written header
        payload = flat.astype("<f4").tobytes()
        fmt = (np.array([3, channels], "<u2").tobytes()
               + np.array([sr, sr * 4 * channels], "<u4").tobytes()
               + np.array([4 * channels, 32], "<u2").tobytes())
        with open(path, "wb") as f:
            f.write(b"RIFF" + np.uint32(36 + len(payload)).tobytes()
                    + b"WAVEfmt " + np.uint32(16).tobytes() + fmt
                    + b"data" + np.uint32(len(payload)).tobytes() + payload)
        return
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        if width == 2:
            w.writeframes((flat * 32767.0).astype("<i2").tobytes())
        elif width == 4:
            w.writeframes((flat.astype(np.float64) * 2147483647.0)
                          .astype("<i4").tobytes())
        elif width == 1:
            w.writeframes(((flat * 127.0) + 128.0).astype(np.uint8).tobytes())
        else:
            v = (flat * float((1 << 23) - 1)).astype(np.int32)
            b = np.zeros((len(v), 3), np.uint8)
            for i in range(3):
                b[:, i] = (v >> (8 * i)) & 0xFF
            w.writeframes(b.tobytes())


def test_libraries_build_under_the_port():
    for name in ("wer", "audio"):
        assert tnative.get_lib(name) is not None, name
        path = tnative.library_path(name)
        assert path.exists()
        assert str(path).startswith(os.path.join(PKG, "native", "build"))
    assert str(tnative.NATIVE) == os.path.join(PKG, "native")


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (4, 1), (1, 1),
                                            (3, 1), (0, 1), (0, 3)])
def test_wav_load_is_bit_equal_to_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    paths = []
    for i, n in enumerate((4321, 3000, 4999)):
        p = tmp_path / f"w{width}c{channels}_{i}.wav"
        _write_wav(p, rng.standard_normal(n) * 0.2, width=width,
                   channels=channels)
        paths.append(str(p))
    got, want = np.zeros((3, 5000), np.float32), np.zeros((3, 5000),
                                                          np.float32)
    lens, status = tnative.wav_load_batch_native(paths, got, 16000)
    jlens, jstatus = jnative.wav_load_batch_native(paths, want, 16000)
    assert status.tolist() == jstatus.tolist() == [0, 0, 0]
    assert lens.tolist() == jlens.tolist() == [4321, 3000, 4999]
    assert got.tobytes() == want.tobytes()
    for p in paths:
        assert tnative.wav_header_native(p) == jnative.wav_header_native(p)
    # not normalised, one thread: still the JAX bits
    got[:], want[:] = 0, 0
    tnative.wav_load_batch_native(paths, got, 16000, normalize=False,
                                  n_threads=1)
    jnative.wav_load_batch_native(paths, want, 16000, normalize=False,
                                  n_threads=1)
    assert got.tobytes() == want.tobytes()


def test_header_and_status_codes(tmp_path):
    ok, sr8 = tmp_path / "ok.wav", tmp_path / "sr8k.wav"
    _write_wav(ok, np.ones(100, np.float32) * 0.1)
    _write_wav(sr8, np.ones(777, np.float32) * 0.1, sr=8000, channels=2)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00JUNK")
    assert tnative.wav_header_native(str(sr8)) == (777, 8000, 2) == \
        jnative.wav_header_native(str(sr8))
    for p in (tmp_path / "missing.wav", bad):
        assert tnative.wav_header_native(str(p)) is None
    paths = [str(ok), str(sr8), str(tmp_path / "nope.wav"), str(bad),
             str(ok)]
    got, want = np.zeros((5, 60), np.float32), np.zeros((5, 60), np.float32)
    lens, status = tnative.wav_load_batch_native(paths, got, 16000)
    jlens, jstatus = jnative.wav_load_batch_native(paths, want, 16000)
    assert status.tolist() == jstatus.tolist() == [0, 2, 1, 1, 0]
    # a row longer than the buffer is cut to it
    assert lens.tolist() == jlens.tolist() == [60, 0, 0, 0, 60]
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        tnative.wav_load_batch_native(paths[:2], got, 16000)
    with pytest.raises(ValueError):
        tnative.wav_load_batch_native(paths, got.astype(np.float64), 16000)


def _seqs(rng, n, vocab, max_len):
    return [rng.integers(0, vocab, rng.integers(0, max_len)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_wer_alignment_is_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    labs, recs = _seqs(rng, 12, 6, 30), _seqs(rng, 12, 6, 30)
    labs[0], recs[1] = [], []
    for lab, rec in zip(labs, recs):
        assert tnative.wer_align_native(lab, rec) == \
            jnative.wer_align_native(lab, rec)
        counts, ops = tnative.wer_align_ops_native(lab, rec)
        jcounts, jops = jnative.wer_align_ops_native(lab, rec)
        assert counts == jcounts and ops.tobytes() == jops.tobytes()
    got = tnative.wer_align_batch_native(labs, recs)
    np.testing.assert_array_equal(got,
                                  jnative.wer_align_batch_native(labs, recs))
    for K in (1, 2, 3):
        refs, hyps = _seqs(rng, K, 5, 12), _seqs(rng, K + (seed % 2), 5, 12)
        assert tnative.cpwer_native(refs, hyps) == \
            jnative.cpwer_native(refs, hyps)


def test_calculator_and_cpwer_native_equal_python():
    rng = np.random.default_rng(7)
    words = ["a", "b", "<sc>", "C", "dd", "ee"]
    nat, py = twer.Calculator(), twer.Calculator(use_native=False)
    for i in range(30):
        lab = " ".join(rng.choice(words, rng.integers(0, 9)))
        rec = " ".join(rng.choice(words, rng.integers(0, 9)))
        for need in (False, True):
            n = nat.calculate(f"{i}{need}", lab, rec, need_alignment=need)
            p = py.calculate(f"{i}{need}", lab, rec, need_alignment=need)
            assert (n.all, n.cor, n.sub, n.dele, n.ins) == \
                (p.all, p.cor, p.sub, p.dele, p.ins)
            if need:
                assert (n.lab_align, n.rec_align) == (p.lab_align,
                                                      p.rec_align)
    assert nat.summary() == py.summary()
    refs = ["hello world how are you", "good day to you sir", "x y"]
    hyps = ["good day to you sir", "x", "hello world how are u"]
    got = twer.cpwer(refs, hyps)
    real = tnative.cpwer_native
    try:
        tnative.cpwer_native = lambda *a: None
        assert twer.cpwer(refs, hyps) == got
    finally:
        tnative.cpwer_native = real
    assert got[1] == (2, 0, 1)


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------
def _examples(tmp_path):
    """Lazy examples of both packages over the same WAVs: three 16 kHz rows
    of other lengths and widths and an 8 kHz row (status 2: Python
    resamples it)."""
    from mtasr_tpu.config import DataConfig
    from mtasr_tpu.data import pipeline as jpl
    from mtasr_tpu.data.audio import Utterance
    from mtasr_tpu.data.tokenizer import CharTokenizer
    from mtasr_tpu_torch import config as tconfig
    from mtasr_tpu_torch.data import pipeline as tpl
    from mtasr_tpu_torch.data.audio import Utterance as TUtterance
    from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TTok
    from tests.test_composite import tiny_cfg

    cfg = tiny_cfg(train_mode="hybrid", talker_ctc=True)
    tok, ttok = CharTokenizer(), TTok()
    sp = tok.add_special_tokens()
    ttok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    rng = np.random.default_rng(3)
    rows = [(3000, 16000, 2), (4500, 16000, 4), (2500, 16000, 3),
            (4000, 8000, 2)]
    utts = []
    for i, (n, sr, width) in enumerate(rows):
        p = tmp_path / f"u{i}.wav"
        _write_wav(p, rng.standard_normal(n) * 0.3, sr=sr, width=width)
        utts.append((f"u{i}", str(p), f"ab<sc>ba{i}"))
    dc = DataConfig(min_duration_in_seconds=0.01,
                    max_duration_in_seconds=2.0,
                    bucket_boundaries_seconds=(0.5, 1.0))
    jex = [jpl.prepare_example(Utterance(*u), tok, dc, lazy=True)
           for u in utts]
    tdc = tconfig.from_fields(tconfig.DataConfig, dc)
    tex = [tpl.prepare_example(TUtterance(*u), ttok, tdc, lazy=True)
           for u in utts]
    assert [e.n_samples for e in jex] == [e.n_samples for e in tex]
    return (jpl, cfg, dc, jex), (tpl, tconfig.from_fields(
        tconfig.SpeechEncoderDecoderConfig, cfg), tdc, tex)


@pytest.mark.parametrize("native", [True, False])
def test_collate_is_bit_equal_to_jax(tmp_path, monkeypatch, native):
    (jpl, cfg, dc, jex), (tpl, tcfg, tdc, tex) = _examples(tmp_path)
    if not native:
        monkeypatch.setattr(jnative, "wav_load_batch_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(tpl, "wav_load_batch_native",
                            lambda *a, **k: None)
    for rows in ([0, 1, 2, 3], [3, 1], [0, 2]):
        want = jpl.collate([jex[i] for i in rows], cfg, dc, training=False)
        got = tpl.collate([tex[i] for i in rows], tcfg, tdc)
        for key in ("input_values", "audio_mask"):
            assert got.arrays[key].dtype == want.arrays[key].dtype
            assert got.arrays[key].tobytes() == want.arrays[key].tobytes(), \
                (rows, key)
    if native:     # the native rows differ from Python's reader, in bits
        off = tpl.collate(tex[:3], tcfg, tdc)
        with monkeypatch.context() as m:
            m.setattr(tpl, "wav_load_batch_native", lambda *a, **k: None)
            py = tpl.collate(tex[:3], tcfg, tdc)
        np.testing.assert_allclose(off.arrays["input_values"],
                                   py.arrays["input_values"], atol=2e-4)
