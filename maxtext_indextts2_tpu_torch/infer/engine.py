"""Inference engine: prefill / insert / generate continuous-batching slots.

Counterpart of the JAX package's ``infer/engine.py``. The decode state is a
dictionary::

    {"cache": per-layer KVCaches, batch dim = num_slots,
     "tokens": [slots] int32 last sampled token,
     "pos": [slots] int32 next position,
     "active": [slots] bool}

With ``paged_attention`` the cache is a per-layer pool of pages instead
(``infer/paged_attention.PagedKVCache``, ``pagedattn_num_pages`` pages of
``pagedattn_tokens_per_page`` rows) and the state gains ``"page_state"``
(``infer/page_manager.PageState``: which pages each slot owns, and its
length): ``insert`` reserves ``ceil(length / tokens_per_page)`` pages and
writes the prompt's rows into them, each decode step first advances every
active slot (``allocate_decode_step``, taking a page at each boundary), and a
release gives the slot's pages back. A slot's length SATURATES at
``max_pages_per_slot * tokens_per_page`` (see ``page_manager``).

``prefill`` runs the model over one prompt and returns a prefix (a cache of
batch 1 plus the first token); ``insert`` copies that prefix into a slot of
the decode state; ``generate`` advances every slot one token;
``prefill_insert_many`` admits several prompts with one packed prefill.

A prompt is not padded to ``max_prefill_predict_length``: prefill runs
eagerly. A decode dispatch on a CUDA device is ONE captured CUDA graph
(``infer/cuda_graphs.py``), the counterpart of the JAX engine's jitted
``generate`` / ``generate_n``: one graph for each step count (and, with
``decode_attention=bucketed``, each bucket width), replayed over the decode
state's own tensors. ``impl="plain"`` (comparisons only) and the private
``_eager=True`` (the kernels' eager route, for on-device comparisons and
``tools/profile_decode.py``) run the steps one launch at a time.
``refresh_decode`` drops the graphs (the JAX engine drops its compiled decode
programs); ``refresh_prefill`` is a no-op kept so that callers port unchanged.

Sampling draws its uniform noise for a whole dispatch from the engine's
``torch.Generator`` before the steps run, on every route, so a replay draws
fresh noise and the eager and captured routes give the same tokens from one
seed. With ``decode_attention=bucketed`` the engine keeps, on the host, a
bound on every slot's cache length (insert lengths plus the steps
dispatched) and gives each dispatch the smallest bucket that covers it; the
JAX engine picks the bucket per step from the device's lengths, which a
captured step cannot read.

On several ranks (``mesh``, ``parallel/mesh.py``) every rank builds an
engine on the same mesh and calls the same methods in the same order; the
slots are whole on every rank. A tensor split (``tensor`` x
``autoregressive``) gives each rank its heads, ``mlp`` columns and
vocabulary rows (``set_params`` cuts each whole weight to the rank's piece
of ``parallel/tensor.compute_spec``), the logits are all-gathered before
sampling, and every rank draws the same noise from the same seeded generator,
so every rank samples the same tokens. An expert split gives each rank its
experts (each dispatches its chunk of the slots' rows); a
``context_autoregressive`` split gives each rank its rows of every slot's
decode cache (``decode_attention=dot_product`` only, dense only, as in the
JAX package). On a mesh with such an axis the decode dispatch runs eagerly
(``graphs.captures`` stays 0): gloo's collectives go through host memory,
which a CUDA graph cannot capture.

IN-PLACE: where the JAX engine returns a new decode state from a donated
one, this engine MUTATES the decode state it is given and returns the same
object, and every tensor of it keeps its storage from ``init_decode_state``
on (a captured step writes those addresses). ``insert`` writes only the prefix's valid rows into the slot and
resets the slot's segment ids and write index; rows beyond the prefix keep
the previous occupant's bytes and are never read, since every decode mask is
bounded by the slot's ``cache_index`` and segment ids.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer import page_manager
from maxtext_indextts2_tpu_torch.infer.cuda_graphs import GraphCache, state_tensors
from maxtext_indextts2_tpu_torch.infer.paged_attention import (
    paged_decode_step,
    prefill_rows,
    write_rows,
)
from maxtext_indextts2_tpu_torch.infer.sampling import gumbel_from_uniform, sample_tokens
from maxtext_indextts2_tpu_torch.models import (
    MODE_AUTOREGRESSIVE,
    MODE_PREFILL,
    Transformer,
)
from maxtext_indextts2_tpu_torch.models.layers import to_dtype
from maxtext_indextts2_tpu_torch.models.registry import get_block_style
from maxtext_indextts2_tpu_torch.ops.quantization import quantize_params_for_serving


def set_cuda_numerics() -> None:
    """float32 products and convolutions on the GPU in full float32, never
    TF32. PyTorch's default runs float32 convolutions in TF32 (about three
    decimal digits); the codec encoder's and the conformer's convolutions
    feed argmax/argmin decisions (RVQ and RepCodec ids), where a TF32 rounding
    can flip an id and, in a residual quantizer, every later stage with it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, and no GPU is an error: entry points never
    fall back to the CPU on their own. Tests pass ``device="cpu"``. A CUDA
    device gets :func:`set_cuda_numerics`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the GPU unless the caller "
                "asks for the CPU explicitly (device='cpu')")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        set_cuda_numerics()
    return device


def _flat_caches(cache) -> list:
    """The per-unit / per-sub-layer nesting flattened to a list of KVCaches."""
    return [c for unit in cache for c in unit]


def bucket_widths(max_length: int) -> list[int]:
    """``decode_attention=bucketed``'s cache prefixes: powers of two from 256,
    the last one the whole cache (the JAX attention's ``lax.switch`` branches)."""
    widths = [256]
    while widths[-1] < max_length:
        widths.append(min(widths[-1] * 2, max_length))
    return widths


def _set_page_state(decode_state, new: page_manager.PageState):
    """Write ``new`` into the decode state's page-state tensors (their storage
    stays: a captured step reads and writes it)."""
    for dst, src in zip(decode_state["page_state"], new):
        if dst is not src:
            dst.copy_(src)


class Engine:
    def __init__(self, cfg: Config, device=None, model: Transformer | None = None,
                 params=None, mesh=None):
        self.device = resolve_device(device)
        if cfg.ici_context_autoregressive_parallelism > 1 \
                or cfg.dcn_context_autoregressive_parallelism > 1:
            # the JAX engine's guards: a sequence-split cache is read by the
            # dot_product decode only (the port merges the ranks' partial
            # softmaxes there), and the page pool is not split
            if cfg.decode_attention != "dot_product":
                raise ValueError("ici/dcn_context_autoregressive_parallelism > 1 requires "
                                 f"decode_attention=dot_product, got {cfg.decode_attention!r}")
            if cfg.paged_attention:
                raise ValueError("context_autoregressive parallelism is incompatible with "
                                 "paged_attention (page pool is not sequence-sharded)")
        if cfg.paged_attention:
            # the prompt's dense prefill KV is written into per-layer page
            # pools: no layer-stacked cache and no int8 codes with scales
            if cfg.scan_layers and not cfg.serve_unroll_layers:
                raise ValueError(
                    "paged_attention=true requires scan_layers=false (per-layer page "
                    "pools; a scan-stacked cache has a layer axis the page writes "
                    "cannot address)")
            if cfg.quantize_kvcache:
                raise ValueError(
                    "paged_attention=true is incompatible with quantize_kvcache (the "
                    "page pool stores raw KV)")
            if get_block_style(cfg.decoder_block).use_mla:
                # the JAX engine builds such an engine and serves wrong streams:
                # its insert never writes the prompt's latents (ROADMAP queue 3)
                raise ValueError(
                    "paged_attention=true does not serve multi-head latent attention "
                    f"(decoder_block={cfg.decoder_block}): its decode cache is the "
                    "compressed latent, which has no paged layout; serve it with "
                    "paged_attention=false")
        # serve_unroll_layers=false: the JAX engine serves a scan-stacked
        # model; this one keeps its layout at the edges only. The model is
        # always built unrolled (scan-stacked checkpoints are unstacked by name
        # in load_params) and the engine's own checkpoints are written stacked
        # (tools/quantize_checkpoint.py, checkpoint_params)
        self.scanned_layout = bool(cfg.scan_layers and not cfg.serve_unroll_layers)
        if cfg.scan_layers:
            cfg = dataclasses.replace(cfg, scan_layers=False)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            from maxtext_indextts2_tpu_torch.parallel import tensor

            tensor.check_model(cfg, self.mesh)
            for ax in ("sequence", "tensor_sequence"):
                if self.mesh.shape.get(ax, 1) > 1:
                    tensor.refuse(f"serving with the {ax} axis (it splits training sequences)")
        built = model is None
        if built:
            # on a mesh the model is built on the host, where its whole
            # weights are allocated but never written, and each parameter
            # then becomes a placeholder of its piece (_piece_placeholders)
            # until its weight arrives: a rank never holds the whole model
            model = Transformer(cfg, device="cpu" if self.mesh is not None else self.device)
        self.model = model
        self.model.eval()
        # the whole shape of every parameter (a split model's hold pieces)
        self._shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        self._seq_split = None
        if self.mesh is not None:
            if built:
                self._piece_placeholders()
            tensor.split_model(self.model, self.mesh)
            for m in self.model.modules():
                if hasattr(m, "rows_replicated"):
                    m.rows_replicated = True
            self._seq_split = tensor.cache_split(self.mesh)
        self.params = None  # set by load_params / set_params: the model's state dict
        self.num_slots = int(cfg.per_device_batch_size * cfg.num_devices)
        self.generator = torch.Generator(device=self.device).manual_seed(int(cfg.seed))
        self.graphs = GraphCache()  # the captured decode dispatches (CUDA)
        # decode_attention=bucketed: id(state["tokens"]) -> (weak reference to
        # it, host-side bound on each slot's cache length)
        self._length_bounds: dict = {}
        if params is not None:
            self.set_params(params)

    # ------------------------------------------------------------- params
    def _cast_for_serving(self, cast_dtype=None):
        if cast_dtype is None and self.cfg.serve_params_dtype:
            cast_dtype = to_dtype(self.cfg.serve_params_dtype)
        if cast_dtype is None:
            return
        for name, p in self.model.named_parameters():
            # float32 weights only, and anything named "scale" (norm scales,
            # quantization scales) stays float32, as in the JAX engine
            if p.dtype == torch.float32 and "scale" not in name:
                p.data = p.data.to(cast_dtype)

    @property
    def _serve_int8(self) -> bool:
        return self.cfg.quantization == "int8w_serve"

    def load_params(self, path: str | None = None, cast_dtype=None):
        """Weights from ``path or cfg.load_parameters_path`` (a params-only
        checkpoint or a training checkpoint's params, ``train/checkpointing.py``;
        scan-stacked or unrolled, served unrolled), or seeded random weights
        (``init_weights_seed``) when there is no path; then the serving cast
        (``cast_dtype``, else ``serve_params_dtype``).

        ``quantization=int8w_serve``: float weights (a float checkpoint, or
        the seeded weights of the unquantized model) are quantized into the
        int8 kernels and float32 scales (:meth:`set_params`); with
        ``checkpoint_is_quantized`` the checkpoint already holds them
        (``tools/quantize_checkpoint.py``) and is read as it is."""
        path = path or self.cfg.load_parameters_path
        if not path and (self._serve_int8 or self.mesh is not None):
            # the float weights of the unquantized model, drawn one module
            # at a time: each is quantized and cut to this rank's piece
            # before the next is drawn
            return self._take(self._seeded_weights(), self._serve_int8, cast_dtype)
        if not path:
            self.model.init_params(self.cfg.init_weights_seed)
            self._cast_for_serving(cast_dtype)
            self.params = self.model.state_dict()
            self.graphs.clear()  # the graphs read the old weights' addresses
            return self.params
        from maxtext_indextts2_tpu_torch.train import checkpointing

        params = checkpointing.load_params_only(path)
        quantized = any(k.endswith("kernel_scale") for k in params)
        if self._serve_int8 and quantized != self.cfg.checkpoint_is_quantized:
            raise ValueError(
                f"{path}: an {'int8' if quantized else 'float'} checkpoint, but "
                f"checkpoint_is_quantized={self.cfg.checkpoint_is_quantized}")
        if checkpointing.names_are_scanned(params):
            params = checkpointing.unroll_scanned_params(params)
        return self.set_params(params, cast_dtype)

    def checkpoint_params(self) -> dict:
        """The loaded weights in the layout of this engine's config: stacked
        on a leading layer axis (``decoder.layers.*``) for a scan-stacked
        engine, as the JAX scanned engine's parameter tree is; else as loaded."""
        self._check_params()
        if not self.scanned_layout:
            return self.params
        from maxtext_indextts2_tpu_torch.train.checkpointing import stack_unrolled_params

        return stack_unrolled_params(self.params)

    def set_params(self, state_dict, cast_dtype=None):
        """Take weights from a state dict (e.g. ``utils.param_bridge
        .params_from_jax``), then the serving cast. An ``int8w_serve`` engine
        given float weights (no ``kernel_scale``) quantizes them first
        (``ops/quantization.quantize_params_for_serving``). On a mesh the
        weights are whole and each parameter takes this rank's piece."""
        quantize = self._serve_int8 and not any(k.endswith("kernel_scale") for k in state_dict)
        want = set(self.model.state_dict())
        # the names after quantization, checked before any weight is taken
        self._check_names(set(state_dict) | {f"{k}_scale" for k in state_dict
                                             if quantize and f"{k}_scale" in want})
        return self._take(state_dict.items(), quantize, cast_dtype)

    def _check_names(self, given: set):
        want = set(self.model.state_dict())
        missing, extra = sorted(want - given), sorted(given - want)
        if missing or extra:
            raise KeyError(f"state dict mismatch: missing {missing}, unexpected {extra}")

    def _take(self, weights, quantize: bool, cast_dtype=None):
        """:meth:`set_params` of ``(name, whole weight)`` pairs, one at a
        time: each float weight quantized where ``quantize``, then cut to
        this rank's piece on a mesh, before the next is read. (No reference
        to an old weight is kept: each is freed as its successor arrives.)"""
        dtypes = {k: v.dtype for k, v in self.model.state_dict().items()}
        params = dict(self.model.named_parameters())
        seen = set()
        with torch.no_grad():
            for name, src in weights:
                if name not in dtypes:
                    seen.add(name)
                    continue
                one = {name: torch.as_tensor(src)}
                if quantize:  # over the whole weight's axes (a rank's piece may have 1 head)
                    one = quantize_params_for_serving(
                        {name: one[name].to(self.device)},
                        {k: torch.empty(self._shapes[k], dtype=dtypes[k], device="meta")
                         for k in (name, f"{name}_scale") if k in dtypes})
                for k, v in one.items():
                    if tuple(v.shape) != self._shapes[k]:
                        raise ValueError(f"{k}: shape {tuple(v.shape)} != {self._shapes[k]}")
                    if self.mesh is not None:
                        v = self._piece(k, v)
                    v = v.to(device=self.device, dtype=dtypes[k]).clone()
                    if params[k].is_meta:
                        self._fill_placeholder(params[k], v)
                    else:
                        params[k].data = v
                    seen.add(k)
        self._check_names(seen)
        self._cast_for_serving(cast_dtype)
        self.params = self.model.state_dict()
        self.graphs.clear()  # the graphs read the old weights' addresses
        return self.params

    def _seeded_weights(self):
        """``(name, whole weight)`` of the unquantized model's seeded weights:
        ``Transformer.init_params``'s draws, in its order from one generator
        on the device, one module's weights at a time (freed when the next
        module's are drawn; a weight no module draws is missing for
        :meth:`_take`)."""
        twin = Transformer(dataclasses.replace(self.cfg, quantization=""), device="meta")
        gen = torch.Generator(device=self.device).manual_seed(int(self.cfg.init_weights_seed))
        for prefix, module in twin.named_modules():
            if module is twin or not hasattr(module, "reset_parameters"):
                continue
            module.to_empty(device=self.device, recurse=False)
            with torch.no_grad():
                module.reset_parameters(gen)
            for n, p in module.named_parameters(recurse=False):
                if n not in ("lora_a", "lora_b"):  # drawn after every base weight
                    yield f"{prefix}.{n}", p.data
            module.to_empty(device="meta", recurse=False)

    def _piece_placeholders(self):
        """Each parameter of the host-built model becomes a placeholder
        (on the meta device) of this rank's piece, filled by :meth:`_take`
        (a weight shared by modules stays shared); the buffers move to the
        device whole."""
        pieces = {}
        for prefix, module in self.model.named_modules():
            for n, p in list(module._parameters.items()):
                if p is None:
                    continue
                if id(p) not in pieces:
                    shape = self._piece(f"{prefix}.{n}" if prefix else n, p).shape
                    pieces[id(p)] = torch.nn.Parameter(
                        torch.empty(shape, dtype=p.dtype, device="meta"),
                        requires_grad=p.requires_grad)
                module._parameters[n] = pieces[id(p)]
            for n, b in module._buffers.items():
                if b is not None:
                    module._buffers[n] = b.to(self.device)

    def _fill_placeholder(self, placeholder, value: torch.Tensor):
        """Every module's reference to ``placeholder`` becomes ``value``."""
        param = torch.nn.Parameter(value, requires_grad=placeholder.requires_grad)
        for module in self.model.modules():
            for n, p in module._parameters.items():
                if p is placeholder:
                    module._parameters[n] = param

    def _piece(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        from maxtext_indextts2_tpu_torch.parallel.sharding import local_piece
        from maxtext_indextts2_tpu_torch.parallel.tensor import compute_spec

        spec = compute_spec(name, tuple(whole.shape), self.cfg.emb_dim, self.mesh)
        return local_piece(whole, spec, self.mesh)

    @torch.no_grad()
    def load_lora_adapter(self, lora_params: dict, alpha: float = 16.0):
        """Merge a LoRA adapter into the loaded weights, in place: for every
        module with ``<module>.lora_a`` [in, r] and ``<module>.lora_b`` [r,
        out] in the state dict ``lora_params`` (a JAX adapter tree converts
        with ``utils.param_bridge.tree_to_state_dict``), ``kernel += (a @ b) *
        alpha / r`` reshaped to the kernel and cast to its dtype (the JAX
        engine's ``load_lora_adapter``). The merged engine serves with the
        base model's structure; the captured decode graphs read the same
        weights. Returns the state dict."""
        self._check_params()
        params = dict(self.model.named_parameters())
        for name in sorted(n for n in lora_params if n.endswith(".lora_a")):
            module = name[: -len(".lora_a")]
            kernel = params.get(f"{module}.kernel")
            if kernel is None or f"{module}.lora_b" not in lora_params:
                raise KeyError(f"{module}: an adapter needs lora_a, lora_b and a kernel")
            if kernel.dtype == torch.int8:
                raise ValueError(f"{module}: an adapter merges into float kernels, not int8")
            a = torch.as_tensor(lora_params[name], device=self.device)
            b = torch.as_tensor(lora_params[f"{module}.lora_b"], device=self.device)
            delta = (a @ b) * torch.tensor(alpha / a.shape[-1], dtype=a.dtype, device=a.device)
            kernel.copy_(kernel + delta.reshape(kernel.shape).to(kernel.dtype))
        self.params = self.model.state_dict()
        return self.params

    def refresh_decode(self):
        """Drop the captured decode graphs: the next dispatch captures anew."""
        self.graphs.clear()

    def refresh_prefill(self):
        """No-op: eager PyTorch holds no compiled prefill programs."""

    def _noise_width(self) -> int:
        """The width of one draw's noise: the candidates a categorical draw
        picks from (``top_k`` for ``topk``, else the vocabulary); 0 for greedy."""
        cfg = self.cfg
        if cfg.decode_sampling_strategy == "greedy":
            return 0
        return cfg.decode_sampling_top_k if cfg.decode_sampling_strategy == "topk" \
            else cfg.vocab_size

    def _draw_uniform(self, *shape) -> torch.Tensor | None:
        """Uniform noise ``[*shape, width]`` from the engine's generator, or
        None when greedy sampling draws nothing."""
        width = self._noise_width()
        if not width:
            return None
        return torch.rand((*shape, width), generator=self.generator, device=self.device,
                          dtype=torch.float32)

    def _sample(self, logits: torch.Tensor, uniform: torch.Tensor | None = None) -> torch.Tensor:
        """Tokens [B] from logits [B, V]; ``uniform`` [B, width] is the draw's
        noise (drawn here from the generator when not given)."""
        cfg = self.cfg
        if uniform is None:
            uniform = self._draw_uniform(logits.shape[0])
        return sample_tokens(
            logits, self.generator, cfg.decode_sampling_strategy,
            cfg.decode_sampling_temperature, cfg.decode_sampling_top_k,
            cfg.decode_sampling_nucleus_p,
            noise=None if uniform is None else gumbel_from_uniform(uniform),
        )

    def _check_params(self):
        if self.params is None:
            raise RuntimeError("load_params() or set_params() first")

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, true_length: int, vision_embeddings=None):
        """One prompt -> (prefix, first_token [1] on the device). The prefix
        cache holds ``true_length`` rows (no padding to a bucket).
        ``vision_embeddings`` ``[1, T_img, E]`` (numpy or a tensor): image soft
        tokens fused at the prompt's ``image_token_id`` positions (multimodal
        serving; the decode steps that follow are the usual ones)."""
        self._check_params()
        cfg = self.cfg
        n = int(true_length)
        if not 1 <= n <= cfg.max_prefill_predict_length:
            raise ValueError(f"prompt length {n} outside [1, {cfg.max_prefill_predict_length}]")
        toks = torch.as_tensor(np.asarray(tokens[:n], np.int32), device=self.device)[None, :]
        positions = torch.arange(n, dtype=torch.int32, device=self.device)[None, :]
        segs = torch.ones_like(toks)
        cache = self.model.init_cache(1, n, self.device)
        if vision_embeddings is not None:
            vision_embeddings = torch.as_tensor(vision_embeddings, device=self.device)
        logits = self.model(toks, positions, segs, mode=MODE_PREFILL, cache=cache,
                            vision_embeddings=vision_embeddings)
        last = logits[:, n - 1]  # [1, V]
        first_token = self._sample(last)
        prefix = {
            "cache": cache,
            "token": first_token,
            "pos": torch.tensor([n], dtype=torch.int32, device=self.device),
            "length": n,
            "logits": last,
        }
        return prefix, first_token

    @torch.no_grad()
    def prefill_multisampling(self, tokens: np.ndarray, true_length: int, num_samples: int,
                              noise: torch.Tensor | None = None):
        """One prefill, ``num_samples`` independently sampled first tokens from
        its last logits; the prefix is shared (each sample can go into its own
        slot). ``noise``: standard Gumbel ``[num_samples, width]`` (the JAX
        package's draw, fed by a test), else drawn from the generator.
        Returns (prefix, tokens [num_samples] as numpy)."""
        prefix, _ = self.prefill(tokens, true_length)
        logits = prefix["logits"].expand(int(num_samples), -1)
        if noise is None:
            toks = self._sample(logits)
        else:
            cfg = self.cfg
            toks = sample_tokens(logits, None, cfg.decode_sampling_strategy,
                                 cfg.decode_sampling_temperature, cfg.decode_sampling_top_k,
                                 cfg.decode_sampling_nucleus_p,
                                 noise=torch.as_tensor(noise, device=self.device))
        return prefix, toks.cpu().numpy()

    def _packed_prefill(self, prompts: list[np.ndarray], limit: int):
        """k prompts packed into one prefill (segment ids 1..k, positions
        restarting at each prompt). Returns (logits [1, total, V], the packed
        cache, starts, lengths)."""
        lengths = [len(t) for t in prompts]
        total = sum(lengths)
        if not prompts or min(lengths) < 1 or total > limit:
            raise ValueError(f"prompt lengths {lengths}: each >= 1 and {total} in all <= {limit}")
        inputs = np.zeros((1, total), np.int32)
        positions = np.zeros((1, total), np.int32)
        segs = np.zeros((1, total), np.int32)
        starts = []
        off = 0
        for i, t in enumerate(prompts):
            n = len(t)
            starts.append(off)
            inputs[0, off:off + n] = t
            positions[0, off:off + n] = np.arange(n)
            segs[0, off:off + n] = i + 1
            off += n
        dev = self.device
        cache = self.model.init_cache(1, total, dev)
        logits = self.model(
            torch.as_tensor(inputs, device=dev), torch.as_tensor(positions, device=dev),
            torch.as_tensor(segs, device=dev), mode=MODE_PREFILL, cache=cache)
        return logits, cache, starts, lengths

    @torch.no_grad()
    def prefill_concat(self, prompts: list[np.ndarray]):
        """Packed multi-prompt prefill: the prompts share ONE prefill, then
        each prompt's rows are copied out into its own prefix. Returns a list
        of (prefix, first_token [1])."""
        self._check_params()
        logits, cache, starts, lengths = self._packed_prefill(
            prompts, self.cfg.max_prefill_predict_length)
        last_rows = torch.as_tensor([s + n - 1 for s, n in zip(starts, lengths)],
                                    dtype=torch.long, device=self.device)
        lasts = logits[0, last_rows]  # [k, V]
        firsts = self._sample(lasts)
        out = []
        for i, (start, n) in enumerate(zip(starts, lengths)):
            tok = firsts[i:i + 1]
            prefix = {
                "cache": [[c.copy_rows(start, n) for c in unit] for unit in cache],
                "token": tok,
                "pos": torch.tensor([n], dtype=torch.int32, device=self.device),
                "length": n,
                "logits": lasts[i:i + 1],
            }
            out.append((prefix, tok))
        return out

    @torch.no_grad()
    def prefill_chunked(self, tokens: np.ndarray, true_length: int, chunk_size: int):
        """Prefill in chunks of ``chunk_size`` tokens, each attending over
        everything cached so far (``cache_offset``): a prompt longer than
        ``max_prefill_predict_length`` (up to ``max_target_length``) prefills
        this way, at a chunk's peak memory. The last chunk is not padded.
        Returns (prefix, first_token [1]), as :meth:`prefill`."""
        return self._prefill_chunks(tokens, true_length, chunk_size, None)

    @torch.no_grad()
    def prefill_cached(self, tokens: np.ndarray, true_length: int, prefix_cache):
        """Chunked prefill that resumes from the longest chunk-aligned prefix
        ``prefix_cache`` (``infer/prefix_cache.PrefixCache``) holds, and stores
        a copy of the cache at every chunk boundary short of the prompt's end."""
        return self._prefill_chunks(tokens, true_length, prefix_cache.chunk_size, prefix_cache)

    def _prefill_chunks(self, tokens, true_length, chunk_size, prefix_cache):
        self._check_params()
        cfg, dev = self.cfg, self.device
        n, chunk = int(true_length), int(chunk_size)
        if not 1 <= n <= cfg.max_target_length:
            raise ValueError(f"prompt length {n} outside [1, {cfg.max_target_length}]")
        if chunk < 1:
            raise ValueError(f"chunk size {chunk} < 1")
        cache = self.model.init_cache(1, n, dev)
        start = 0
        if prefix_cache is not None:
            start, snapshot = prefix_cache.lookup(tokens, n)
            if snapshot is not None:
                for dst, src in zip(_flat_caches(cache), _flat_caches(snapshot)):
                    dst.load_rows(src, start)
        toks = torch.as_tensor(np.asarray(tokens[:n], np.int32), device=dev)[None, :]
        for off in range(start, n, chunk):
            end = min(off + chunk, n)
            positions = torch.arange(off, end, dtype=torch.int32, device=dev)[None, :]
            logits = self.model(toks[:, off:end], positions, torch.ones_like(positions),
                                mode=MODE_PREFILL, cache=cache, cache_offset=off)
            if prefix_cache is not None and end <= n - 1:
                # a copy owned by the prefix cache, never aliased to a live prefix
                prefix_cache.insert(tokens, end, [[c.copy_rows(0, end) for c in unit]
                                                  for unit in cache])
        last = logits[:, n - 1 - off]  # [1, V]
        first_token = self._sample(last)
        prefix = {
            "cache": cache,
            "token": first_token,
            "pos": torch.tensor([n], dtype=torch.int32, device=dev),
            "length": n,
            "logits": last,
        }
        return prefix, first_token

    # ------------------------------------------------------- decode state
    @property
    def _tokens_per_page(self) -> int:
        return int(self.cfg.pagedattn_tokens_per_page)

    @property
    def _max_pages_per_slot(self) -> int:
        tpp = self._tokens_per_page
        return (int(self.cfg.max_target_length) + tpp - 1) // tpp

    def init_decode_state(self):
        """A fresh decode state. Every later engine call writes into ITS
        tensors, so a captured step keeps reading the right addresses."""
        cfg = self.cfg
        slots = self.num_slots
        state = {
            "tokens": torch.zeros((slots,), dtype=torch.int32, device=self.device),
            "pos": torch.zeros((slots,), dtype=torch.int32, device=self.device),
            "active": torch.zeros((slots,), dtype=torch.bool, device=self.device),
        }
        if not cfg.paged_attention:
            state["cache"] = self.model.init_cache(slots, cfg.max_target_length, self.device,
                                                   self._seq_split)
        else:
            if cfg.pagedattn_num_pages <= slots:
                raise ValueError(f"page pool must exceed the slot count "
                                 f"({cfg.pagedattn_num_pages} pages, {slots} slots)")
            state["cache"] = self.model.init_paged_cache(
                cfg.pagedattn_num_pages, self._tokens_per_page, self.device)
            state["page_state"] = page_manager.init_page_state(
                cfg.pagedattn_num_pages, slots, self._max_pages_per_slot, self.device)
        self._length_bound(state)[:] = 0
        return state

    def _length_bound(self, decode_state) -> np.ndarray:
        """The host-side bound on each slot's cache length (``cache_index``;
        every slot's grows by one a step, released or not) that picks
        ``decode_attention=bucketed``'s width. A state this engine did not make
        starts at the whole cache."""
        tokens = decode_state["tokens"]
        rec = self._length_bounds.get(id(tokens))
        if rec is None or rec[0]() is not tokens:
            for k in [k for k, r in self._length_bounds.items() if r[0]() is None]:
                del self._length_bounds[k]
            rec = (weakref.ref(tokens),
                   np.full(self.num_slots, self.cfg.max_target_length, np.int64))
            self._length_bounds[id(tokens)] = rec
        return rec[1]

    def _decode_width(self, decode_state, n: int) -> int | None:
        """``decode_attention=bucketed``: the smallest bucket that covers every
        slot's cache length through the next ``n`` steps (None otherwise)."""
        cfg = self.cfg
        if cfg.decode_attention != "bucketed" or cfg.paged_attention:
            return None
        need = int(self._length_bound(decode_state).max()) + n
        return next((w for w in bucket_widths(cfg.max_target_length) if w >= need),
                    cfg.max_target_length)

    # ------------------------------------------------------------- insert
    def _insert_rows(self, decode_state, pre, slot: int, start: int, length: int):
        """Rows [start, start+length) of the prefix cache ``pre`` into ``slot``:
        dense or paged, in place."""
        if self.cfg.paged_attention:
            self._insert_paged(decode_state, pre, slot, start, length)
        else:
            self._insert_cache(decode_state["cache"], pre, slot, start, length)
        self._length_bound(decode_state)[slot] = length

    def _insert_paged(self, decode_state, pre, slot: int, start: int, length: int):
        """Reserve ``ceil(length / tokens_per_page)`` pages for the slot (after
        releasing what it held) and write the prompt's rows into them in
        every layer's pools. Only the prompt's rows are written: no padded
        page, never the null page."""
        state, page_ids = page_manager.allocate_prefill(
            decode_state["page_state"], slot, length, self._tokens_per_page,
            self._max_pages_per_slot)
        _set_page_state(decode_state, state)
        rows = prefill_rows(page_ids, length, self._tokens_per_page)  # once for every layer
        for pool, src in zip(_flat_caches(decode_state["cache"]), _flat_caches(pre)):
            write_rows(pool, rows, src.cached_key[0, start:start + length],
                       src.cached_value[0, start:start + length])

    @staticmethod
    def _insert_cache(full, pre, slot: int, start: int, length: int):
        """Copy rows [start, start+length) of batch row 0 of the prefix cache
        ``pre`` to rows [0, length) of ``slot`` in ``full``; reset the slot's
        segment ids and write index. Touches only this slot, in place."""
        for dst, src in zip(_flat_caches(full), _flat_caches(pre)):
            dst.insert_rows(src, slot, start, length)

    @torch.no_grad()
    def insert(self, prefix, decode_state, slot: int):
        """Put a prefix into ``slot``. Mutates and returns ``decode_state``."""
        slot, n = int(slot), int(prefix["length"])
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} outside [0, {self.num_slots})")
        self._insert_rows(decode_state, prefix["cache"], slot, 0, n)
        decode_state["tokens"][slot] = prefix["token"][0]
        decode_state["pos"][slot] = n
        decode_state["active"][slot] = True
        return decode_state

    @torch.no_grad()
    def prefill_insert_many(self, decode_state, prompts: list[np.ndarray],
                            slots: list[int], bucket: int | None = None):
        """Fused admission: pack k prompts into one prefill (segment ids
        1..k, positions restarting at each prompt), copy each prompt's span
        into its slot and sample each first token, with no device-to-host
        copy. ``bucket`` bounds the packed length as in the JAX engine (there
        it is also the padded width; here nothing is padded). Mutates
        ``decode_state``; returns (decode_state, first_tokens [k] on the
        device)."""
        self._check_params()
        cfg = self.cfg
        p = bucket or cfg.max_prefill_predict_length
        if p > cfg.max_prefill_predict_length:
            raise ValueError(f"bucket {p} > prefill limit {cfg.max_prefill_predict_length}")
        k = len(prompts)
        if k < 1 or k != len(slots) or len(set(slots)) != k:
            raise ValueError(f"need one distinct slot per prompt, got {k} prompts, slots {slots}")
        if not all(0 <= int(s) < self.num_slots for s in slots):
            raise ValueError(f"slots {slots} outside [0, {self.num_slots})")
        logits, cache, starts, lengths = self._packed_prefill(prompts, p)
        dev = self.device
        last_rows = torch.as_tensor(
            [s + n - 1 for s, n in zip(starts, lengths)], dtype=torch.long, device=dev)
        first_tokens = self._sample(logits[0, last_rows])  # [k]

        for slot, start, n in zip(slots, starts, lengths):
            self._insert_rows(decode_state, cache, int(slot), start, n)
        slot_idx = torch.as_tensor([int(s) for s in slots], dtype=torch.long, device=dev)
        decode_state["tokens"][slot_idx] = first_tokens
        decode_state["pos"][slot_idx] = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        decode_state["active"][slot_idx] = True
        return decode_state, first_tokens

    # ------------------------------------------------------------ release
    @torch.no_grad()
    def release_slot(self, decode_state, slot: int):
        """Mark a finished request's slot inactive (its ``pos`` stops) and,
        paged, give its pages back to the pool."""
        return self.release_slots(decode_state, [int(slot)])

    @torch.no_grad()
    def release_slots(self, decode_state, slots):
        slots = [int(s) for s in slots]
        mask = np.zeros(self.num_slots, bool)
        mask[slots] = True
        decode_state["active"] &= ~torch.as_tensor(mask, device=self.device)
        if self.cfg.paged_attention:
            state = decode_state["page_state"]
            for s in slots:
                state = page_manager.release_slot(state, s)
            _set_page_state(decode_state, state)
        return decode_state

    # ------------------------------------------------------------ generate
    @torch.no_grad()
    def _generate_step(self, decode_state, impl: str | None = None,
                       uniform: torch.Tensor | None = None, width: int | None = None):
        """One token for every slot, with no device-to-host read (a captured
        step runs it). ``uniform`` [slots, width]: this step's sampling noise;
        ``width``: the bucketed decode's cache prefix. Returns (new_tokens
        [slots], logits [slots, V]); every state tensor is written in place."""
        cfg = self.cfg
        tokens = decode_state["tokens"]
        pos = decode_state["pos"]
        active = decode_state["active"]
        step = None
        if cfg.paged_attention:
            # advance every active slot one token (a page at each boundary)
            # BEFORE the model call: attention writes at seq_lens - 1
            _set_page_state(decode_state, page_manager.allocate_decode_step(
                decode_state["page_state"], self._tokens_per_page, active=active))
            step = paged_decode_step(decode_state["page_state"], self._tokens_per_page)
        logits = self.model(
            tokens[:, None], pos[:, None], torch.ones_like(tokens[:, None]),
            mode=MODE_AUTOREGRESSIVE, cache=decode_state["cache"], impl=impl, paged_step=step,
            decode_width=width,
        )[:, 0]
        new_tokens = self._sample(logits, uniform)
        tokens.copy_(torch.where(active, new_tokens, tokens))
        # SATURATE at the cache end: a slot whose stream finished host-side
        # but was never released keeps active=True and would otherwise step
        # past max_target_length; a cache row past the end is an illegal
        # address on CUDA and ends the context for the whole process
        pos.copy_(torch.clamp(pos + active.to(torch.int32), max=cfg.max_target_length - 1))
        return new_tokens, logits

    def _steps(self, decode_state, n: int, impl, uniform, width) -> torch.Tensor:
        """n steps; tokens [n, slots]."""
        return torch.stack([
            self._generate_step(decode_state, impl, None if uniform is None else uniform[i],
                                width)[0] for i in range(n)])

    def generate(self, decode_state, impl: str | None = None, _eager: bool = False):
        """One decode step (a captured graph's replay on a CUDA device).
        ``impl="plain"`` routes the kernels to their plain versions (on-device
        comparisons only). Returns (decode_state, new_tokens [slots] on the
        device)."""
        decode_state, toks = self.generate_n(decode_state, 1, impl, _eager)
        return decode_state, toks[0]

    @torch.no_grad()
    def generate_n(self, decode_state, n: int, impl: str | None = None, _eager: bool = False):
        """n decode steps with no device-to-host copy in between: on a CUDA
        device ONE replay of the graph captured for n steps over this state
        (``infer/cuda_graphs.py``); eagerly with ``impl`` (comparisons) or
        ``_eager`` (the kernels launched one by one) or on the CPU. Returns
        (decode_state, tokens [n, slots] on the device): the caller fetches
        them with ONE copy."""
        self._check_params()
        n = int(n)
        uniform = self._draw_uniform(n, self.num_slots)
        width = self._decode_width(decode_state, n)
        if impl is not None or _eager or self.device.type != "cuda" or self.mesh is not None:
            toks = self._steps(decode_state, n, impl, uniform, width)
        else:
            toks = self.graphs.run(
                ("generate", n, width), state_tensors(decode_state),
                lambda u: self._steps(decode_state, n, None, u, width), [uniform])
        bound = self._length_bound(decode_state)
        np.minimum(bound + n, self.cfg.max_target_length, out=bound)
        return decode_state, toks

    # --------------------------------------------------------- convenience
    def generate_stream(self, prompt_tokens: np.ndarray, max_new_tokens: int):
        """Single-stream decode helper: prefill -> insert(0) -> generate loop."""
        prefix, first = self.prefill(prompt_tokens, len(prompt_tokens))
        state = self.init_decode_state()
        state = self.insert(prefix, state, 0)
        steps = [first[:1]]
        for _ in range(max_new_tokens - 1):
            state, toks = self.generate(state)
            steps.append(toks[:1])
        return [int(t) for t in torch.cat(steps).cpu().tolist()]
