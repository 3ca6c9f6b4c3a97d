"""Audio features on the host: the MSPI log-spectrogram recipe in numpy.

Counterpart of the numpy path of `mspi_tpu/data/audio.py` (reference
avsp_dataloader.py:51-80 and inference.py:24-63): wav -> 16 kHz mono ->
window [start/fps, (start+len+1)/fps] -> |STFT|^2 (n_fft 512, hop 160,
centred reflect padding, periodic Hann) -> log(. + 1e-6) -> standardise
each time column over frequency (unbiased std) -> pad/crop to (257, 111)
with fill 0.02; missing audio gives the constant 0.02.

`spectrogram_torch` is the device twin of `stft_power` (the JAX package's
`spectrogram_jax`): |STFT|^2 by `torch.stft` on the waveform's device.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    return (0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))).astype(np.float32)


def stft_power(audio: np.ndarray, n_fft: int = 512, hop_length: int = 160) -> np.ndarray:
    """|STFT|^2 with torch.stft conventions. audio: [T] -> [n_fft//2+1, frames]."""
    pad = n_fft // 2
    x = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx] * hann_window(n_fft)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    return (np.abs(spec) ** 2).T.astype(np.float32)


def spectrogram_torch(audio: torch.Tensor, n_fft: int = 512,
                      hop_length: int = 160) -> torch.Tensor:
    """|STFT|^2 of audio [T] on its device, [n_fft // 2 + 1, frames] as
    `stft_power`: periodic Hann window, centred reflect padding."""
    window = torch.hann_window(n_fft, periodic=True, dtype=audio.dtype, device=audio.device)
    spec = torch.stft(audio, n_fft, hop_length=hop_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.abs().square()


def _standardise_pad(power: np.ndarray, spectro_shape=(257, 111), fill=0.02) -> np.ndarray:
    """log -> standardise each time column over frequencies -> pad/crop."""
    aud = np.log(power + 1e-6)
    means = aud.mean(axis=0, keepdims=True)
    stds = aud.std(axis=0, keepdims=True, ddof=1)
    aud = (aud - means) / (stds + 1e-6)
    out = np.full(spectro_shape, fill, dtype=np.float32)
    if aud.shape[-1] <= spectro_shape[1]:
        out[:, : aud.shape[-1]] = aud
    else:
        out = aud[:, : spectro_shape[1]].astype(np.float32)
    return out


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Minimal WAV reader (PCM8/16/32), [channels, samples] float32."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return data.reshape(-1, ch).T, sr


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), bandlimited like torchaudio Resample."""
    if orig_sr == new_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(audio, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def get_audio_spectrogram(
    audio_path: Optional[str],
    start_idx: int,
    videos_fps: float,
    len_snippet: int = 16,
    sample_rate: int = 16000,
    spectro_shape: Tuple[int, int] = (257, 111),
    flip: bool = False,
    audio_cache: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[F, T] = spectro_shape log-spectrogram of one window. `flip` reverses
    the waveform window (the temporal-flip trick for the first len-1
    frames); `audio_cache` is the whole 16 kHz mono waveform, read once."""
    if audio_cache is not None:
        audio = audio_cache
    elif audio_path is not None and os.path.exists(audio_path):
        audio = load_audio_mono_16k(audio_path, sample_rate)
    else:
        return np.full(spectro_shape, 0.02, dtype=np.float32)
    fps = float(videos_fps)
    start = int(np.round((start_idx / fps) * sample_rate))
    end = int(np.round(((start_idx + len_snippet + 1) / fps) * sample_rate))
    clip = audio[start:end]
    if flip:
        clip = clip[::-1]
    return _standardise_pad(stft_power(clip), spectro_shape)


def load_audio_mono_16k(audio_path: str, sample_rate: int = 16000) -> Optional[np.ndarray]:
    """Load, downmix stereo and resample once; None when the file is missing."""
    if not os.path.exists(audio_path):
        return None
    wav, sr = load_wav(audio_path)
    if wav.shape[0] == 2:
        wav = wav.mean(axis=0, keepdims=True)
    return resample(wav[0], sr, sample_rate)
