"""Semantic tokenizer: 16 kHz wav -> 8192-vocab semantic token ids.

Counterpart of the JAX package's ``audio/semantic_tokenizer.py``:
SeamlessM4T features (``audio/mel.py``) -> the w2v-BERT conformer tapped at
layer 17 and normalised by its statistics (``conformer.SemanticEncoder``) ->
``RepCodec.quantize``. Batched; each row's true length drives the feature
normalisation and the conformer's pad mask. The parameter tree is
``{"encoder": ..., "repcodec": ...}`` as there. The loaders of published
checkpoints (``load_hf_encoder``, ``load_torch_repcodec``,
``load_torch_weights``, ``set_stats``) wait until such files are in the repo.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio import mel
from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig, SemanticEncoder
from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.unported import _unsupported

_CHECKPOINTS = "4b, rest of training: weight import, item 4b.1"


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
        _unsupported("SemanticTokenizer.load_hf_encoder (HF w2v-BERT checkpoints)", _CHECKPOINTS)

    def load_torch_repcodec(self, state_dict):
        _unsupported("SemanticTokenizer.load_torch_repcodec (RepCodec checkpoints)", _CHECKPOINTS)

    def load_torch_weights(self, encoder_state_dict, repcodec_state_dict, stats=None):
        _unsupported("SemanticTokenizer.load_torch_weights (published checkpoints)", _CHECKPOINTS)

    def set_stats(self, stats):
        _unsupported("SemanticTokenizer.set_stats (published layer statistics)", _CHECKPOINTS)
