from maxtext_indextts2_tpu_torch.models.attention import (
    MODE_AUTOREGRESSIVE,
    MODE_PREFILL,
    MODE_TRAIN,
    MODE_VERIFY,
    Attention,
    KVCache,
)
from maxtext_indextts2_tpu_torch.models.registry import BLOCK_STYLES, get_block_style
from maxtext_indextts2_tpu_torch.models.transformer import Transformer
