"""Semantic tokenizer: 16 kHz wav -> 8192-vocab semantic token ids.

Counterpart of the JAX package's ``audio/semantic_tokenizer.py``:
SeamlessM4T features (``audio/mel.py``) -> the w2v-BERT conformer tapped at
layer 17 and normalised by its statistics (``conformer.SemanticEncoder``) ->
``RepCodec.quantize``. Batched; each row's true length drives the feature
normalisation and the conformer's pad mask. The parameter tree is
``{"encoder": ..., "repcodec": ...}`` as there. The reference's three weight
artifacts load into the running module: a HF ``Wav2Vec2BertModel`` state dict
(``load_hf_encoder``), a RepCodec state dict (``load_torch_repcodec``) and the
``wav2vec2bert_stats.pt`` dict ``{"mean", "var"}`` (``set_stats``; std =
sqrt(var)); ``load_torch_weights`` takes all three.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio import mel
from maxtext_indextts2_tpu_torch.audio.conformer import (
    ConformerConfig, SemanticEncoder, params_from_hf,
)
from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
from maxtext_indextts2_tpu_torch.audio.torch_ckpt import repcodec_params_from_torch
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device


def _float32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def stats_mean_std(stats) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) of a ``wav2vec2bert_stats.pt`` dict: std = sqrt(var),
    in float32."""
    return _float32(stats["mean"]), np.sqrt(_float32(stats["var"]))


class SemanticTokenizer(nn.Module):
    """The semantic encoder and RepCodec as one module with a ``tokenize``
    call. Runs on the GPU unless ``device="cpu"``."""

    def __init__(self, encoder_cfg: ConformerConfig | None = None,
                 repcodec_kwargs: dict | None = None, device=None, seed: int = 0):
        super().__init__()
        self._device = resolve_device(device)
        self.encoder_cfg = encoder_cfg or ConformerConfig()
        self.repcodec_kwargs = dict(repcodec_kwargs or {})
        self.init_params(seed)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights for both halves (tests and smoke runs before
        checkpoint conversion); returns the state dict."""
        gen = torch.Generator(device=self._device).manual_seed(int(seed))
        self.encoder = SemanticEncoder(self.encoder_cfg, device=self._device, generator=gen)
        self.repcodec = RepCodec(hidden_size=self.encoder_cfg.hidden_size,
                                 **self.repcodec_kwargs, device=self._device, generator=gen)
        self.eval()
        return self.state_dict()

    @property
    def device(self) -> torch.device:
        return self.encoder.stat_mean.device

    @torch.no_grad()
    def tokenize(self, wav, wav_lengths=None) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, T] (or [T]) 16 kHz float wav -> ([B, T'] ids int64, [B] lengths
        int32), on this module's device. ``wav_lengths`` (default: every row
        full) marks each row's true number of samples."""
        if not torch.is_tensor(wav):
            wav = torch.from_numpy(np.asarray(wav, np.float32))
        wav = wav.to(device=self.device, dtype=torch.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if wav_lengths is None:
            wav_lengths = torch.full((wav.shape[0],), wav.shape[1], dtype=torch.int32)
        wav_lengths = torch.as_tensor(wav_lengths, device=self.device)
        feats, feat_lengths = mel.w2vbert_features(wav, wav_lengths)
        pad_mask = torch.arange(feats.shape[1], device=self.device)[None, :] < feat_lengths[:, None]
        hidden = self.encoder(feats, pad_mask)
        return self.repcodec.quantize(hidden), feat_lengths

    def load_hf_encoder(self, state_dict, stat_mean=None, stat_std=None):
        """The encoder half from a HF ``Wav2Vec2BertModel`` state dict, with
        the tap's statistics (identity by default); returns the state dict."""
        self.encoder.load_state_dict(
            params_from_hf(state_dict, self.encoder_cfg, stat_mean, stat_std))
        return self.state_dict()

    def load_torch_repcodec(self, state_dict):
        """The codec half from a reference RepCodec state dict."""
        self.repcodec.load_state_dict(repcodec_params_from_torch(state_dict))
        return self.state_dict()

    def set_stats(self, stats):
        """The tap's statistics (``{"mean": [H], "var": [H]}``) on the
        current encoder, its weights untouched."""
        mean, std = stats_mean_std(stats)
        with torch.no_grad():
            self.encoder.stat_mean.copy_(torch.from_numpy(mean))
            self.encoder.stat_std.copy_(torch.from_numpy(std))
        return self.state_dict()

    def load_torch_weights(self, encoder_state_dict, repcodec_state_dict, stats=None):
        """All three reference artifacts: the HF w2v-BERT state dict, the
        RepCodec state dict and, optionally, the statistics dict."""
        mean = std = None
        if stats is not None:
            mean, std = stats_mean_std(stats)
        self.load_hf_encoder(encoder_state_dict, mean, std)
        return self.load_torch_repcodec(repcodec_state_dict)
