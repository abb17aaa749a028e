"""Multimodal preprocessing: image normalization, tiling, token fusion.

Counterpart of the JAX package's ``utils/multimodal.py``, every function, on
numpy (the host side: images, token rows) and torch (the fusion). Resizing is
the JAX package's ``jax.image.resize(..., "bilinear")``: a separable
triangle filter with half-pixel centres and, when shrinking, the filter
widened by the scale (antialiasing), each output's weights normalised to sum
to one; it is written here as one weight matrix an axis
(:func:`resize_weights`) and applied with two matrix products, so the same
image gives the same pixels (to the float32 sums' order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# SigLIP-style normalization used by the gemma3 tower; llama4 uses plain
# [0,1] -> [-1,1].
_SIGLIP_MEAN = (0.5, 0.5, 0.5)
_SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class ImagePreprocessConfig:
    image_size: int = 224  # square model input
    num_tiles: int = 1  # llama4-style tiling: split into t x t tiles + global
    mean: tuple = _SIGLIP_MEAN
    std: tuple = _SIGLIP_STD


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` float32 weights of a bilinear resize along one axis, as
    ``jax.image.scale_and_translate`` computes them, in float32 (its sample
    positions carry the float32 rounding of in / out, which grows with the
    index, and are rounded once): triangle kernel, kernel scale ``max(in / out, 1)``, weights
    normalised, samples outside the input zero."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, f32(1.0))
    # one rounding of (i + 0.5) * inv - 0.5, as the fused multiply-add XLA emits
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64) * float(inv)
              - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))  # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, f32(0.0))
    return w.T.astype(f32)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, C] float32 -> [height, width, C] (``jax.image.resize``'s
    bilinear, antialiased when shrinking)."""
    img = np.asarray(img, np.float32)
    if img.shape[:2] == (height, width):
        return img
    wh = resize_weights(img.shape[0], height)
    ww = resize_weights(img.shape[1], width)
    cols = np.matmul(ww, img)  # [H, width, C]: every row's columns resampled
    h, _, c = cols.shape
    return (wh @ cols.reshape(h, width * c)).reshape(height, width, c).astype(np.float32)


def _to_unit(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def preprocess_image(image, cfg: ImagePreprocessConfig = ImagePreprocessConfig()) -> np.ndarray:
    """uint8 HWC image -> [num_tiles^2 (+1 global if tiling), S, S, 3]
    float32. With num_tiles == 1 returns [1, S, S, 3]."""
    img = _to_unit(image)
    s = cfg.image_size
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)

    def norm(x):
        return (x - mean) / std

    if cfg.num_tiles <= 1:
        return norm(resize_bilinear(img, s, s))[None]
    t = cfg.num_tiles
    big = resize_bilinear(img, s * t, s * t)
    tiles = big.reshape(t, s, t, s, 3).transpose(0, 2, 1, 3, 4).reshape(t * t, s, s, 3)
    glob = resize_bilinear(img, s, s)
    return norm(np.concatenate([tiles, glob[None]], axis=0))


def insert_image_tokens(text_tokens: np.ndarray, image_placeholder_id: int,
                        tokens_per_image: int, image_token_id: int,
                        max_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Expand each placeholder into ``tokens_per_image`` image-token slots.
    Returns (tokens [max_length] int32, image_mask [max_length] bool),
    truncated or zero-padded to ``max_length``."""
    out, mask = [], []
    for tok in np.asarray(text_tokens).tolist():
        if tok == image_placeholder_id:
            out.extend([image_token_id] * tokens_per_image)
            mask.extend([True] * tokens_per_image)
        else:
            out.append(tok)
            mask.append(False)
    out, mask = out[:max_length], mask[:max_length]
    pad = max_length - len(out)
    return np.asarray(out + [0] * pad, np.int32), np.asarray(mask + [False] * pad, np.bool_)


def fuse_vision_embeddings(token_embeddings: torch.Tensor, vision_embeddings: torch.Tensor,
                           image_mask: torch.Tensor) -> torch.Tensor:
    """Place the vision embeddings at the masked positions: each masked
    position i takes vision row rank(i) (a cumulative-rank gather), unmasked
    rows keep their token embedding."""
    rank = torch.clamp(torch.cumsum(image_mask.to(torch.int32), dim=1) - 1, 0,
                       vision_embeddings.shape[1] - 1)
    gathered = torch.gather(vision_embeddings, 1,
                            rank[..., None].long().expand(-1, -1, vision_embeddings.shape[-1]))
    return torch.where(image_mask[..., None], gathered, token_embeddings)


# ------------------------------------------------------------------ family
# Per-family preprocessing and prompt conventions (gemma3, llama4).

GEMMA3_IMAGE_SIZE = 896
GEMMA3_TOKENS_PER_IMAGE = 256
LLAMA4_TILE_SIZE = 336
LLAMA4_MAX_TILES = 16
LLAMA4_PATCHES_PER_TILE = 144  # (336/14)^2 / 4 pixel-shuffle


def supported_tile_grids(max_tiles: int = LLAMA4_MAX_TILES) -> list[tuple[int, int]]:
    """All (rows, cols) grids with rows*cols <= max_tiles (llama4's
    candidate canvases)."""
    grids = []
    for n in range(1, max_tiles + 1):
        for rows in range(1, n + 1):
            if n % rows == 0:
                grids.append((rows, n // rows))
    return sorted(set(grids))


def best_tile_grid(height: int, width: int, tile: int = LLAMA4_TILE_SIZE,
                   max_tiles: int = LLAMA4_MAX_TILES) -> tuple[int, int]:
    """The tile grid whose canvas best fits the image: canvases the image
    fits into without downscaling first (least upscaling wins), otherwise the
    largest downscale; ties: fewer wasted pixels, then fewer tiles."""
    best = None
    for rows, cols in supported_tile_grids(max_tiles):
        ch, cw = rows * tile, cols * tile
        scale = min(ch / height, cw / width)
        waste = ch * cw - (height * scale) * (width * scale)
        key = (0 if scale >= 1 else 1, scale if scale >= 1 else -scale, waste, rows * cols)
        if best is None or key < best[0]:
            best = (key, (rows, cols))
    return best[1]


def preprocess_image_gemma3(image) -> np.ndarray:
    """gemma3: one 896 x 896 bilinear resize, SigLIP [-1, 1] normalization.
    Returns [1, 896, 896, 3]."""
    return preprocess_image(image, ImagePreprocessConfig(image_size=GEMMA3_IMAGE_SIZE,
                                                         num_tiles=1))


def preprocess_image_llama4(image) -> tuple[np.ndarray, tuple[int, int]]:
    """llama4: aspect-ratio best-fit tiling at 336 px and a global thumbnail
    when tiled. Returns ([n_tiles(+1), 336, 336, 3], (rows, cols))."""
    img = _to_unit(image)
    h, w = img.shape[0], img.shape[1]
    rows, cols = best_tile_grid(h, w)
    s = LLAMA4_TILE_SIZE
    canvas = resize_bilinear(img, rows * s, cols * s)
    tiles = canvas.reshape(rows, s, cols, s, 3).transpose(0, 2, 1, 3, 4).reshape(
        rows * cols, s, s, 3)
    out = 2.0 * tiles - 1.0  # llama4: [0,1] -> [-1,1]
    if rows * cols > 1:
        glob = 2.0 * resize_bilinear(img, s, s) - 1.0
        out = np.concatenate([out, glob[None]], axis=0)
    return out.astype(np.float32), (rows, cols)


def tokens_for_image(family: str, aspect_ratio: tuple[int, int] = (1, 1)) -> int:
    """Total image-token count one image expands to, with llama4's per-tile
    separator structure (per tile a separator and the patches; the global
    tile when tiled; the begin / end markers)."""
    if family == "gemma3":
        return GEMMA3_TOKENS_PER_IMAGE
    if family == "llama4":
        rows, cols = aspect_ratio
        n_tiles = rows * cols
        total = n_tiles * (LLAMA4_PATCHES_PER_TILE + 1)
        if n_tiles > 1:
            total += LLAMA4_PATCHES_PER_TILE + 1
        return total + 2
    raise ValueError(f"unknown multimodal family: {family}")


def format_vision_prompt(prompt: str, family: str, placeholder: str = "<image>") -> str:
    """Rewrite a generic prompt's image placeholder into the family's
    convention."""
    if family == "gemma3":
        body = prompt.replace(placeholder, "\n\n<start_of_image>\n\n")
        return f"<start_of_turn>user\n{body}<end_of_turn>\n<start_of_turn>model\n"
    if family == "llama4":
        body = prompt.replace(placeholder, "<|image|>")
        return ("<|begin_of_text|><|header_start|>user<|header_end|>\n\n"
                f"{body}<|eot|><|header_start|>assistant<|header_end|>\n\n")
    raise ValueError(f"unknown multimodal family: {family}")
