"""Waveform input (counterpart of `mtasr_tpu/data/audio.py`): read and
write a WAV file, resample it to the model's rate, and normalise it to
zero mean and unit variance (the Wav2Vec2 feature extractor's
`do_normalize`); read a Kaldi data directory (`wav.scp`, `text`, an
optional `prompt`) and the LibriMix split layout."""
from __future__ import annotations

import os
import wave
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(mono float32 waveform in [-1, 1], sample rate); PCM 8/16/24/32."""
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        ch, width = w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample(wav_data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if sr == target_sr:
        return wav_data
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(sr, target_sr)
    return resample_poly(wav_data, target_sr // g, sr // g).astype(np.float32)


def normalize_waveform(wav_data: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    mean, var = wav_data.mean(), wav_data.var()
    return ((wav_data - mean) / np.sqrt(var + eps)).astype(np.float32)


def write_wav(path: str, wav_data: np.ndarray, sr: int = 16000) -> None:
    """Mono 16-bit PCM."""
    pcm = (np.clip(wav_data, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_scp(path: str) -> Dict[str, str]:
    """`wav.scp` / `text`: "utt_id <value...>" a line."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:
                out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


@dataclass
class Utterance:
    utt_id: str
    wav_path: str
    text: str
    prompt: str = ""


def load_kaldi_dir(data_dir: str, prompt: str = "") -> List[Utterance]:
    """The utterances of a Kaldi directory that have both a wav and a
    text line, in `wav.scp`'s order; a `prompt` file overrides `prompt`
    per utterance."""
    wavs = read_scp(os.path.join(data_dir, "wav.scp"))
    texts = read_scp(os.path.join(data_dir, "text"))
    ppath = os.path.join(data_dir, "prompt")
    prompts = read_scp(ppath) if os.path.exists(ppath) else {}
    return [Utterance(u, p, texts[u], prompts.get(u, prompt))
            for u, p in wavs.items() if u in texts]


def build_file_paths(root: str, dataset_name: str) -> Dict[str, str]:
    """LibriMix's split directories under `root`; a `_mini` dataset uses
    its train directory for every split."""
    mini = dataset_name.endswith("_mini")
    base = os.path.join(root, dataset_name[:-5] if mini else dataset_name)
    if mini:
        return dict.fromkeys(("train", "validation", "test"),
                             os.path.join(base, "train"))
    return {"train": os.path.join(base, "train"),
            "validation": os.path.join(base, "dev"),
            "test": os.path.join(base, "test")}
