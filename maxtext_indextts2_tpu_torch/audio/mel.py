"""Mel / filterbank features on the device.

Counterpart of the JAX package's ``audio/mel.py``: the SeamlessM4T front end
of the semantic tokenizer (16 kHz wav -> kaldi-style 80-dim log-mel fbank ->
per-utterance mean/var normalisation -> 2 frames stacked -> 160-dim at
50 Hz) and the general log-mel spectrogram of codec/vocoder training. STFT by
strided framing + ``torch.fft.rfft`` in float32; HTK mel scale; the
filterbank is this package's own copy of the JAX package's numpy function
(``tests/test_torch_port_hygiene.py`` holds the two equal).

Windows are built in float32 on the CPU and then moved: on the GPU, dividing
a tensor by a Python number multiplies by the rounded reciprocal, which is
not the division the JAX package does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# kaldi fbank defaults used by SeamlessM4T / w2v-BERT
SAMPLE_RATE = 16_000
N_FFT = 512  # kaldi: 400-sample window padded to 512
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
N_MELS = 80


def hz_to_mel(f, htk: bool = True):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def mel_to_hz(m, htk: bool = True):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_min + f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = N_MELS,
    n_fft: int = N_FFT,
    sample_rate: int = SAMPLE_RATE,
    fmin: float = 20.0,
    fmax: float | None = None,
    htk: bool = True,
    mel_space_triangles: bool = False,
) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filters (host-side, cached).

    mel_space_triangles=True matches kaldi/SeamlessM4T: the triangles are
    linear in MEL space rather than Hz space.
    """
    fmax = fmax or sample_rate / 2
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    fb = np.zeros((len(bins), n_mels))
    if mel_space_triangles:
        mel_bins = hz_to_mel(bins, htk)
        for i in range(n_mels):
            lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
            up = (mel_bins - lo) / max(ctr - lo, 1e-10)
            down = (hi - mel_bins) / max(hi - ctr, 1e-10)
            fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    else:
        for i in range(n_mels):
            lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
            up = (bins - lo) / max(ctr - lo, 1e-10)
            down = (hi - bins) / max(hi - ctr, 1e-10)
            fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int,
                 center: bool = False) -> torch.Tensor:
    """[..., T] -> [..., num_frames, frame_length] (a strided view; with
    ``center`` the signal is first reflect-padded by frame_length // 2)."""
    if center:
        pad = frame_length // 2
        lead = wav.shape[:-1]
        wav = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad), mode="reflect")
        wav = wav.reshape(*lead, wav.shape[-1])
    return wav.unfold(-1, frame_length, hop)


def _window(kind: str, win_length: int) -> torch.Tensor:
    """The analysis window in float32, computed on the CPU."""
    if kind == "hann":
        if win_length == 1:
            return torch.ones(1)
        n = win_length + 1  # symmetric of length N+1, last sample dropped
        k = torch.arange(n, dtype=torch.float32)
        return (0.5 - 0.5 * torch.cos(2 * math.pi * k / (n - 1)))[:-1]
    if kind == "povey":  # kaldi's default: symmetric hann^0.85
        k = torch.arange(win_length, dtype=torch.float32)
        return (0.5 - 0.5 * torch.cos(2 * math.pi * k / (win_length - 1))) ** 0.85
    return torch.ones(win_length)


def stft_magnitude(
    wav: torch.Tensor,
    n_fft: int = N_FFT,
    win_length: int = WIN_LENGTH,
    hop: int = HOP_LENGTH,
    window: str = "povey",
    center: bool = False,
    power: float = 2.0,
    preemphasis: float = 0.0,
    remove_dc: bool = True,
) -> torch.Tensor:
    """[..., T] -> [..., frames, n_fft//2+1] magnitude^power spectrum."""
    frames = frame_signal(wav, win_length, hop, center)
    if remove_dc:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    if preemphasis > 0.0:
        first = frames[..., :1]
        frames = torch.cat(
            [first * (1 - preemphasis), frames[..., 1:] - preemphasis * frames[..., :-1]], dim=-1)
    frames = frames * _window(window, win_length).to(device=frames.device, dtype=frames.dtype)
    if n_fft > win_length:
        frames = F.pad(frames, (0, n_fft - win_length))
    mag = torch.abs(torch.fft.rfft(frames.float(), n=n_fft, dim=-1))
    return mag if power == 1.0 else mag ** power


def log_mel_fbank(
    wav: torch.Tensor,
    n_mels: int = N_MELS,
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    win_length: int = WIN_LENGTH,
    hop: int = HOP_LENGTH,
    mel_floor: float = 1.192092955078125e-7,
) -> torch.Tensor:
    """kaldi-style log-mel fbank: [..., T] -> [..., frames, n_mels].

    The input is scaled by 2**15 (kaldi int16 convention, as in the
    reference's SeamlessM4T front end), which changes where mel_floor clips.
    """
    wav = wav * 32768.0
    power = stft_magnitude(wav, n_fft, win_length, hop, window="povey", center=False,
                           power=2.0, preemphasis=0.97, remove_dc=True)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate, mel_space_triangles=True))
    mel = torch.clamp(power @ fb.to(power.device), min=mel_floor)
    return torch.log(mel)


def w2vbert_features(
    wav: torch.Tensor,
    wav_lengths: torch.Tensor | None = None,
    stride: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SeamlessM4T front end: log-mel fbank -> per-utterance mean/var norm ->
    stack ``stride`` frames. ``wav [B, T]`` -> (``[B, frames // stride,
    80 * stride]``, feature lengths ``[B]`` int32).

    ``wav_lengths`` masks padding samples out of the normalisation
    statistics: unbiased variance (ddof=1) over the valid frames, at least
    two counted; padded frames become 0.
    """
    feats = log_mel_fbank(wav)  # [..., F, 80]
    f = feats.shape[-2]
    if wav_lengths is not None:
        num_frames = torch.clamp(
            (wav_lengths.to(torch.int64) - WIN_LENGTH) // HOP_LENGTH + 1, min=1)
        mask = (torch.arange(f, device=feats.device)[None, :] < num_frames[:, None])[..., None]
        cnt = torch.clamp(torch.sum(mask, dim=-2, keepdim=True), min=2).float()
        mean = torch.sum(feats * mask, dim=-2, keepdim=True) / cnt
        var = torch.sum(torch.square(feats - mean) * mask, dim=-2, keepdim=True) / (cnt - 1)
        feats = (feats - mean) / torch.sqrt(var + 1e-7)
        feats = torch.where(mask, feats, torch.zeros((), dtype=feats.dtype, device=feats.device))
        feat_lengths = (num_frames // stride).to(torch.int32)
    else:
        mean = torch.mean(feats, dim=-2, keepdim=True)
        var = torch.var(feats, dim=-2, keepdim=True, correction=1)
        feats = (feats - mean) / torch.sqrt(var + 1e-7)
        feat_lengths = torch.full(feats.shape[:-2], f // stride, dtype=torch.int32,
                                  device=feats.device)

    # stack `stride` consecutive frames
    f2 = (f // stride) * stride
    feats = feats[..., :f2, :]
    shape = feats.shape[:-2] + (f2 // stride, feats.shape[-1] * stride)
    return feats.reshape(shape), feat_lengths


def mel_spectrogram(
    wav: torch.Tensor,
    n_mels: int = 100,
    sample_rate: int = 24_000,
    n_fft: int = 1024,
    hop: int = 256,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> torch.Tensor:
    """Vocos/BigVGAN-style log-mel for codec/vocoder losses ([..., F, n_mels])."""
    mag = stft_magnitude(wav, n_fft, n_fft, hop, window="hann", center=True, power=1.0,
                         preemphasis=0.0, remove_dc=False)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate, fmin=fmin, fmax=fmax))
    mel = torch.clamp(mag @ fb.to(mag.device), min=1e-5)
    return torch.log(mel)
