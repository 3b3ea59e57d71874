"""Transformer models: blocks built from each layer's signature (a GQA or
MLA attention, Mamba, mLSTM or sLSTM mixer; a SwiGLU, the encoder's GELU
MLP, a MoE or no FFN), the model module, dense and paged caches beside
dense recurrent states, the forward (from token ids, or from a stub
frontend's embeddings with optional explicit and M-RoPE positions) with
the paper's per-layer fake-quant, and the converter from the JAX
package's parameter tree.

The reference groups layers into segments of one repeated block pattern
(``layer_segments``: e.g. DeepSeek-V3's 3 dense layers then its MoE
layers; Llama 4's dense/MoE interleave) and runs each under ``lax.scan``
over stacked parameters; here the model is an ``nn.ModuleList`` of one
:class:`DecoderBlock` per layer and the forward is a Python loop, with one
cache per layer (the layout of the reference's ``_segment_unrolled``).

Per-layer quantization (all optional, driven by :class:`ModelQuant`):
  * weights: fake-quant of every >= 2-D float tensor of a block before use
    (the paper's "weights"; :func:`_quant_weights`), expert stacks, router
    and MLA projections included,
  * residual stream: fake-quant of the embedding output and of each
    block's output (the paper's "data"),
  * KV: integer-grid storage in dense slabs or paged pools; an MLA layer
    stores its latent on the grid, in a dense slab only,
  * recurrent state: a Mamba or mLSTM layer puts its state on the layer's
    KV grid at chunk boundaries (``state_quant``).

The encoder (hubert-xlarge) differs from a dense decoder only in its GELU
FFN and its bidirectional attention (``cfg.causal``); its norms are
RMSNorm, as the reference's.

Training (:func:`train_loss`): a trainable model (``trainable=True``)
holds float32 master weights (``cfg.param_dtype``) with gradients on and
casts each weight at use to the compute dtype, as the reference casts its
float32 parameters per use; a serving model holds the compute dtype
already, and the cast is free. The three fake-quant sites (weights, the
residual, the embedding output) are straight-through estimators: their
forward is ``fake_quant`` bit for bit, their gradient passes inside the
grid's range. (The reference calls the plain ``fake_quant`` there, whose
rounding has a zero derivative, so its quantized training moves no block
weight; the port does not copy that fault.)
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs.counting import (layer_segments, layer_signatures,
                                segment_layers)
from ..core.fixedpoint import fake_quant_ste
from ..parallel.hints import (constrain, full, gather_cols, kv_heads,
                              reduce_rows, row_piece)
from ..core.paged_kv import (PagedCacheSpec, PagedKVLayout, init_paged_pool,
                             per_row)
from .attention import (GQAttention, KVQuantSpec, MLAttention, gqa_apply,
                        init_gqa, init_kv_cache, init_mla, init_mla_cache,
                        mla_apply)
from .common import (chunked_ce_loss, cross_entropy, dense_init, embed_init,
                     embed_tokens, frozen, lm_head, rmsnorm)
from .mlp import (GeluMLP, SwiGLU, gelu_mlp_apply, init_gelu_mlp,
                  init_swiglu, swiglu_apply)
from .moe import MoE, init_moe, moe_apply
from .ssm import MIXERS


# ---------------------------------------------------------------------------
# Quantization plumbing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelQuant:
    """Per-layer Q(I,F) formats: one python int per layer in each tuple.

    ``w_int``/``w_frac`` fake-quantize the weights and ``a_int``/``a_frac``
    the residual stream (None: off); ``kv_int``/``kv_frac`` give each
    layer's KV grid (None: float KV) in the uniform ``kv_container``, or,
    with ``kv_containers`` (a per-layer profile, paged caches only), in
    each layer's own container, "fp" marking a layer that stores float
    pages. ``kv_scale_mode`` ("static" | "page") picks the paged dequant
    scale calibration. The reference's ``kv_unroll`` (its
    ``--kv-profile-scan unroll``) picks one of two XLA lowerings of one
    computation and has no counterpart: the port's forward is one
    per-layer loop either way.
    Built from a PrecisionPolicy by
    ``repro_torch.quant.apply.build_model_quant``."""

    w_int: Optional[Tuple[int, ...]] = None
    w_frac: Optional[Tuple[int, ...]] = None
    a_int: Optional[Tuple[int, ...]] = None
    a_frac: Optional[Tuple[int, ...]] = None
    kv_int: Optional[Tuple[int, ...]] = None
    kv_frac: Optional[Tuple[int, ...]] = None
    kv_container: str = "int8"
    kv_containers: Optional[Tuple[str, ...]] = None
    kv_scale_mode: str = "static"

    def layer_container(self, li: int) -> str:
        """Layer ``li``'s KV container ("fp": float K/V)."""
        if self.kv_int is None:
            return "fp"
        if self.kv_containers is not None:
            return self.kv_containers[li]
        return self.kv_container

    def layer_kv(self, li: int) -> Optional[KVQuantSpec]:
        """Layer ``li``'s KV spec (None: the layer stores float K/V)."""
        cont = self.layer_container(li)
        if cont == "fp":
            return None
        return KVQuantSpec(self.kv_int[li], self.kv_frac[li], cont,
                           scale_mode=self.kv_scale_mode)

    def layer_weight(self, li: int) -> Optional[Tuple[int, int]]:
        """Layer ``li``'s weight (I, F), or None when weights stay float."""
        return None if self.w_int is None else (self.w_int[li],
                                                self.w_frac[li])

    def layer_data(self, li: int) -> Optional[Tuple[int, int]]:
        """Layer ``li``'s residual-stream (I, F), or None."""
        return None if self.a_int is None else (self.a_int[li],
                                                self.a_frac[li])

    def layer_state(self, li: int) -> Optional[Tuple[int, int]]:
        """Layer ``li``'s recurrent-state (I, F): its KV format, None
        where the layer's KV stays float."""
        if self.layer_container(li) == "fp":
            return None
        return self.kv_int[li], self.kv_frac[li]


def _quant_weights(mod: nn.Module, fmt: Optional[Tuple[int, int]]):
    """``mod`` with every >= 2-D float tensor fake-quantized to ``fmt``
    (the paper's weight quantization, straight-through; 1-D tensors,
    biases and norm scales, stay full precision), then each tensor of a
    trainable model's ``cast_at_use`` cast to its compute dtype,
    submodules (a MoE's shared expert) included. Returns a namespace read
    like the module, or ``mod`` itself when there is nothing to do."""
    cast = getattr(mod, "cast_at_use", None)
    if fmt is None and not cast:
        return mod
    view = types.SimpleNamespace(**{k: v for k, v in vars(mod).items()
                                    if not k.startswith("_")})
    for name, t in mod.named_parameters(recurse=False):
        if fmt is not None and t.dim() >= 2 and t.is_floating_point():
            t = fake_quant_ste(t, *fmt)
        if cast and name in cast:
            t = t.to(cast[name])
        setattr(view, name, t)
    for name, child in mod.named_children():
        setattr(view, name, _quant_weights(child, fmt))
    return view


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class DecoderBlock(nn.Module):
    """Pre-norm residual block of signature ``sig`` = (kind, ffn):
    x += mixer(norm1(x)); x += mlp(norm2(x)). For kind "attn" the mixer
    is ``attn``, an :class:`MLAttention` for an MLA config, else a
    :class:`GQAttention`; for "mamba", "mlstm" and "slstm" it is
    ``mixer``, the :mod:`models.ssm` module of that kind (``attn`` is
    then None). ``mlp`` (the reference's "ffn") is a :class:`MoE` for ffn
    "moe", a SwiGLU of ``d_ff`` for "mlp", and for "none" (the xLSTM
    blocks) ``mlp`` and ``norm2`` are None; an encoder's "mlp" is a
    :class:`GeluMLP`. Norm scales stay float32 (the
    reference reads them as float32); the projections are stored in the
    compute dtype."""

    def __init__(self, cfg, dtype, device=None, sig=("attn", "mlp")):
        super().__init__()
        self.sig = tuple(sig)
        kind, ffn = self.sig
        D = cfg.d_model
        self.norm1 = frozen(torch.empty(D, dtype=torch.float32,
                                        device=device))
        self.attn = self.mixer = None
        if kind == "attn":
            self.attn = (MLAttention(cfg, dtype, device)
                         if cfg.attention_type == "mla"
                         else GQAttention(cfg, dtype, device))
        elif kind in MIXERS:
            self.mixer = MIXERS[kind].module(cfg, dtype, device)
        else:
            raise ValueError(kind)
        self.norm2 = self.mlp = None
        if ffn != "none":
            self.norm2 = frozen(torch.empty(D, dtype=torch.float32,
                                            device=device))
            if ffn == "moe":
                self.mlp = MoE(cfg, dtype, device)
            elif cfg.family == "encoder":
                self.mlp = GeluMLP(D, cfg.d_ff, dtype, device)
            else:
                self.mlp = SwiGLU(D, cfg.d_ff, dtype, device)


class MTP(nn.Module):
    """The multi-token-prediction module (``cfg.mtp_depth`` > 0): ``proj``
    (2D, D), an ("attn", "mlp") block and a norm. The served forward does
    not use it; :func:`train_loss` adds its loss."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        self.proj = frozen(torch.empty(2 * D, D, dtype=dtype, device=device))
        self.block = DecoderBlock(cfg, dtype, device, ("attn", "mlp"))
        self.norm = frozen(torch.empty(D, dtype=torch.float32,
                                       device=device))


class Transformer(nn.Module):
    """The decoder. ``embed`` is (V, D) and ``head`` (D, V), both in the
    compute dtype; ``head`` is None for tied embeddings; ``layers[i]`` is
    built from ``layer_signatures(cfg)[i]``; ``mtp`` is None without
    multi-token prediction.

    ``trainable=True`` builds the training model: every parameter in
    ``cfg.param_dtype`` (float32 masters) with gradients on, and each
    module's ``cast_at_use`` (name -> compute dtype) naming the tensors
    the serving model holds in the compute dtype; the forward casts them
    at use (:func:`_quant_weights`, :meth:`embed_rows`,
    :meth:`head_weight`)."""

    def __init__(self, cfg, device=None, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_torch_dtype if trainable else cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = frozen(torch.empty(V, D, dtype=dt, device=device))
        self.final_norm = frozen(torch.empty(D, dtype=torch.float32,
                                             device=device))
        self.head = (None if cfg.tie_embeddings else
                     frozen(torch.empty(D, V, dtype=dt, device=device)))
        self.layers = nn.ModuleList(DecoderBlock(cfg, dt, device, sig)
                                    for sig in layer_signatures(cfg))
        self.mtp = MTP(cfg, dt, device) if cfg.mtp_depth > 0 else None
        self.trainable = trainable
        if trainable:
            self._mark_casts()

    def _mark_casts(self) -> None:
        """Name, module by module, the parameters the serving model holds
        in another dtype than this one (read off a serving model built on
        the meta device), and turn every gradient on."""
        serving = dict(Transformer(self.cfg, "meta").named_parameters())
        for mname, mod in self.named_modules():
            cast = {}
            for n, p in mod.named_parameters(recurse=False):
                want = serving[f"{mname}.{n}" if mname else n].dtype
                if want != p.dtype:
                    cast[n] = want
                p.requires_grad_(True)
            if cast:
                mod.cast_at_use = cast

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _at_use(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` cast as a trainable model casts its parameter ``name``
        at use (a serving model's ``t`` as it is)."""
        dt = getattr(self, "cast_at_use", {}).get(name)
        return t if dt is None else t.to(dt)

    def embed_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``ids`` in the compute dtype (rows first,
        then the cast: the same values as casting the table)."""
        rows = gather_cols(embed_tokens(self.embed, ids), self.embed)
        return self._at_use("embed", rows)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The LM head over ``x`` (…, D): (…, V) logits, whole on every
        rank under a tensor-parallel plan (the vocab shards gathered; a
        tied head, the table's D shards, is row-parallel: its partial
        products are summed)."""
        if self.head is not None:
            return gather_cols(lm_head(self.head_weight(), x), self.head)
        w = self.head_weight()
        if getattr(self.embed, "tp_dim", None) == 1:
            w.tp_dim = 0
        return reduce_rows(lm_head(w, row_piece(x, w)), w)

    def head_weight(self) -> torch.Tensor:
        if self.head is None:
            return self._at_use("embed", self.embed.T)
        return self._at_use("head", self.head)


def _init_block(blk: DecoderBlock, g: torch.Generator) -> None:
    blk.norm1.fill_(1.0)
    if blk.attn is not None:
        (init_mla if isinstance(blk.attn, MLAttention)
         else init_gqa)(blk.attn, g)
    else:
        MIXERS[blk.sig[0]].init(blk.mixer, g)
    if blk.mlp is not None:
        blk.norm2.fill_(1.0)
        init = {MoE: init_moe, GeluMLP: init_gelu_mlp}.get(type(blk.mlp),
                                                           init_swiglu)
        init(blk.mlp, g)


@torch.no_grad()
def init_model(cfg, *, seed: int = 0, device="cuda",
               trainable: bool = False) -> Transformer:
    """Random model with the reference's init distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers
    differ from the JAX init's). Expert stacks are drawn one expert at a
    time straight into their buffers. ``trainable``: float32 masters with
    gradients on (:class:`Transformer`)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, trainable=trainable)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model.embed.copy_(embed_init(model.embed.shape, torch.float32, g, dev))
    model.final_norm.fill_(1.0)
    if model.head is not None:
        model.head.copy_(dense_init(model.head.shape, torch.float32, g, dev))
    for blk in model.layers:
        _init_block(blk, g)
    if model.mtp is not None:
        model.mtp.proj.copy_(dense_init(model.mtp.proj.shape, torch.float32,
                                        g, dev))
        _init_block(model.mtp.block, g)
        model.mtp.norm.fill_(1.0)
    return model


_MIXER_LEAVES = {"gqa": ("wq", "wk", "wv", "wo"),
                 "mla": ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                         "wkv_b", "wo"),
                 "mamba": ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                           "D_skip", "norm", "out_proj"),
                 "mlstm": ("up_proj", "wq", "wk", "wv", "w_i", "w_f",
                           "f_bias", "norm", "down_proj"),
                 "slstm": ("w_in", "r", "b", "norm", "out_proj")}


def block_leaves(blk: DecoderBlock, cfg):
    """(reference path, tensor) of every parameter of a block, the path
    the reference's block tree gives it: ``mixer/<name>`` (a norm scale's
    leaf is ``<name>/scale``), ``ffn/<name>`` of a SwiGLU or a GELU MLP
    (its biases are 1-D, so weight fake-quant leaves them float), or
    ``ffn/router``, ``ffn/experts/<name>`` and ``ffn/shared/<name>`` of a
    MoE, and ``norm1/scale``, ``norm2/scale`` (no ``norm2`` or ``ffn``
    without an FFN)."""
    out = [(("norm1", "scale"), blk.norm1)]
    if blk.attn is not None:
        mixer, names = blk.attn, list(_MIXER_LEAVES[cfg.attention_type])
        if cfg.attention_type == "gqa" and cfg.attention_bias:
            names += ["bq", "bk", "bv"]
    else:
        mixer, names = blk.mixer, _MIXER_LEAVES[blk.sig[0]]
    for n in names:
        path = (("mixer", n, "scale") if n.endswith("norm")
                else ("mixer", n))
        out.append((path, getattr(mixer, n)))
    if blk.mlp is None:
        return out
    out.append((("norm2", "scale"), blk.norm2))
    swiglu = ("w_gate", "w_up", "w_down")
    if isinstance(blk.mlp, MoE):
        out.append((("ffn", "router"), blk.mlp.router))
        out += [(("ffn", "experts", n), getattr(blk.mlp, n)) for n in swiglu]
        if blk.mlp.shared is not None:
            out += [(("ffn", "shared", n), getattr(blk.mlp.shared, n))
                    for n in swiglu]
    else:
        names = (("w_in", "b_in", "w_out", "b_out")
                 if isinstance(blk.mlp, GeluMLP) else swiglu)
        out += [(("ffn", n), getattr(blk.mlp, n)) for n in names]
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg, *, device="cuda",
                      trainable: bool = False) -> Transformer:
    """A :class:`Transformer` holding the JAX package's parameters.

    ``tree`` is the reference's ``init_model`` tree with every leaf already
    mapped to numpy (no jax needed here). The reference stacks layers for
    ``lax.scan``: ``segments[si][j]`` holds pattern position j of segment
    si, every leaf with a leading period axis, and period p of it is layer
    ``start + p * len(pattern) + j`` (``segment_layers``); it is unstacked
    here into one :class:`DecoderBlock` per layer (:func:`block_leaves`
    names the leaves). ``mtp`` (unstacked in the reference) is carried.
    Weights keep their ``(in, out)`` layout and are cast to the compute
    dtype once here, which equals the reference's per-use
    ``.astype(compute_dtype)``; norm scales stay float32. ``trainable``
    keeps them as float32 masters (:class:`Transformer`)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, trainable=trainable)

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))

    segs = layer_segments(cfg)
    if len(tree["segments"]) != len(segs) or any(
            len(t) != len(pat) for t, (pat, _, _) in zip(tree["segments"],
                                                         segs)):
        raise ValueError(f"the tree's segments do not fit {cfg.name}'s "
                         f"layer segments {segs}")
    params = dict(model.named_parameters())
    for name, src in unstack_reference_tree(tree, model, cfg).items():
        put(params[name], src)
    return model


def reference_layout(model: Transformer, cfg):
    """[(parameter name, reference path, period)] of every parameter: its
    ``named_parameters`` name, its path in the reference's tree
    (``("segments", si, j) + block path`` for a layer) and, for a layer
    leaf, its index p on the reference's leading period axis (None for the
    unstacked embed, head, final norm and MTP leaves)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = [(names[id(model.embed)], ("embed", "table"), None),
           (names[id(model.final_norm)], ("final_norm", "scale"), None)]
    if model.head is not None:
        out.append((names[id(model.head)], ("head", "kernel"), None))
    for li, si, j, p in segment_layers(cfg):
        out += [(names[id(t)], ("segments", si, j) + path, p)
                for path, t in block_leaves(model.layers[li], cfg)]
    if model.mtp is not None:
        out += [(names[id(model.mtp.proj)], ("mtp", "proj"), None),
                (names[id(model.mtp.norm)], ("mtp", "norm", "scale"), None)]
        out += [(names[id(t)], ("mtp", "block") + path, None)
                for path, t in block_leaves(model.mtp.block, cfg)]
    return out


def _listify(node):
    """Nested dicts whose keys are all ints become lists (the reference's
    ``segments`` is a list of lists)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def reference_tree(values: Dict[str, Any], model: Transformer, cfg, *,
                   stack=np.stack) -> Dict[str, Any]:
    """Per-parameter values (``name -> leaf``, or ``name -> {key: leaf}``
    as an int8 moment's ``{"q", "scale"}``) nested in the reference's
    tree, each layer leaf stacked with ``stack`` on the reference's
    leading period axis (:func:`reference_layout`). The inverse of
    :func:`unstack_reference_tree`."""
    tree: Dict[Any, Any] = {}
    stacked: Dict[tuple, Dict[int, Any]] = {}

    def put(path, v):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    for name, path, p in reference_layout(model, cfg):
        if p is None:
            put(path, values[name])
        else:
            stacked.setdefault(path, {})[p] = values[name]
    for path, parts in stacked.items():
        parts = [parts[i] for i in range(len(parts))]
        put(path, ({k: stack([q[k] for q in parts]) for k in parts[0]}
                   if isinstance(parts[0], dict) else stack(parts)))
    return _listify(tree)


def unstack_reference_tree(tree, model: Transformer, cfg) -> Dict[str, Any]:
    """``name -> value`` of every parameter from a tree in the reference's
    layout (a layer leaf sliced at its period)."""
    out = {}
    for name, path, p in reference_layout(model, cfg):
        v = _leaf(tree, path)
        if p is not None:
            v = ({k: x[p] for k, x in v.items()} if isinstance(v, dict)
                 else v[p])
        out[name] = v
    return out


def params_to_numpy(model: Transformer, cfg) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the model's parameters as
    the reference's tree of numpy arrays, layers restacked by
    ``segment_layers``. A bf16 tensor comes out as float32 (exactly: numpy
    has no bf16)."""
    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return reference_tree({n: host(t) for n, t in model.named_parameters()},
                          model, cfg)


# ---------------------------------------------------------------------------
# Caches / forward
# ---------------------------------------------------------------------------
def init_block_cache(cfg, batch, max_len, dtype,
                     kv_quant: Optional[KVQuantSpec],
                     paged: Optional[PagedCacheSpec], device,
                     kind: str = "attn", kv_heads: Optional[int] = None):
    """One layer's cache. An attention layer's: a paged pool when
    ``paged`` is given (``kv_quant`` picks its container), else a dense
    (batch, max_len, KV, hd) slab of :func:`models.attention.init_kv_cache`;
    an MLA layer's is a dense latent slab
    (:func:`models.attention.init_mla_cache`), and a paged one raises the
    reference's NotImplementedError. A recurrent layer's (``kind``
    "mamba", "mlstm" or "slstm") is its dense ``(batch, ...)`` state at
    its initial value (:mod:`models.ssm`), paged cache or not.
    ``kv_heads``: the KV heads of an attention layer's pool or slab
    (default ``cfg.num_kv_heads``; a tensor-parallel rank's shard)."""
    KV = cfg.num_kv_heads if kv_heads is None else kv_heads
    if kind != "attn":
        return MIXERS[kind].init_state(batch, cfg, dtype, device)
    if cfg.attention_type == "mla":
        if paged is not None:
            raise NotImplementedError(
                "paged KV cache supports GQA attention; MLA latent "
                "paging is future work")
        return init_mla_cache(batch, max_len, cfg, dtype, kv_quant, device)
    if paged is not None:
        layout = PagedKVLayout(
            num_pages=paged.num_pages, page_size=paged.page_size,
            num_kv_heads=KV, head_dim=cfg.head_dim,
            container="fp" if kv_quant is None else kv_quant.container,
            dtype=dtype)
        return init_paged_pool(layout, device)
    return init_kv_cache(batch, max_len, KV, cfg.head_dim, dtype, kv_quant,
                         device)


def init_cache(cfg, quant: Optional[ModelQuant] = None,
               paged: Optional[PagedCacheSpec] = None, device="cuda", *,
               batch: int = 0, max_len: int = 0,
               kv_heads: Optional[int] = None
               ) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer: paged pools sharing one page table when
    ``paged`` is given, else dense ``(batch, max_len)`` slabs. A quantized
    dense slab stores the int8/int16 grid of ``quant.kv_container`` (int4
    raises: it exists only lane-packed in pages). A per-layer profile
    (``quant.kv_containers``) gives each layer a pool in its own
    container, float pages for "fp" layers; it needs a paged cache. MLA
    layers hold dense latent slabs only; recurrent layers hold dense
    ``(batch, ...)`` states beside paged pools too. ``kv_heads``: the KV
    heads of every attention layer's pool or slab (default
    ``cfg.num_kv_heads``; a tensor-parallel rank's shard,
    ``parallel.hints.kv_heads``)."""
    kinds = [sig[0] for sig in layer_signatures(cfg)]
    if paged is None and (batch <= 0 or max_len <= 0):
        raise ValueError("a dense cache needs batch and max_len")
    if batch <= 0 and any(k != "attn" for k in kinds):
        raise ValueError("recurrent states are per row: the cache needs "
                         "batch")
    if (paged is None and quant is not None
            and quant.kv_containers is not None):
        raise ValueError("per-layer KV containers require a paged cache "
                         "(--page-size > 0)")
    dev = resolve_device(device)
    return [init_block_cache(cfg, batch, max_len, cfg.torch_dtype,
                             quant.layer_kv(li) if quant is not None
                             else None, paged, dev, kind, kv_heads)
            for li, kind in enumerate(kinds)]


def block_apply(blk: DecoderBlock, x, positions, *, cfg, cache, cache_pos,
                kv_quant=None, w_fmt=None, a_fmt=None, page_table=None,
                attn_impl="gather", kv_valid_len=None, state_quant=None,
                mrope_positions=None):
    """One pre-norm block, dispatched on its signature. Returns (x, cache,
    aux): ``aux`` is the MoE's {"moe_lb_loss", "moe_z_loss"} for a MoE
    block, else empty. ``w_fmt``/``a_fmt`` (I, F) fake-quantize the
    block's weights before use and its output (the residual stream) after
    it. A recurrent block reads and returns its state as ``cache`` (None:
    from the initial state, and the new state is returned) and puts it on
    the ``state_quant`` (I, F) grid at chunk boundaries.
    ``mrope_positions`` (B, S, 3) reach a GQA attention (M-RoPE); MLA
    ignores them, as the reference does."""
    h = rmsnorm(full(blk.norm1), x, cfg.norm_eps)
    if blk.attn is None:
        y, cache = MIXERS[blk.sig[0]].apply(
            _quant_weights(blk.mixer, w_fmt), h, cfg=cfg, state=cache,
            state_quant=state_quant)
        out = getattr(blk.mixer, "out_proj", None)
        y = reduce_rows(y, blk.mixer.down_proj if out is None else out)
    elif isinstance(blk.attn, MLAttention):
        y, cache = mla_apply(_quant_weights(blk.attn, w_fmt), h, positions,
                             cfg=cfg, cache=cache, cache_pos=cache_pos,
                             kv_quant=kv_quant, absorbed=cfg.mla_absorbed)
    else:
        y, cache = gqa_apply(_quant_weights(blk.attn, w_fmt), h, positions,
                             cfg=cfg, cache=cache, cache_pos=cache_pos,
                             kv_quant=kv_quant,
                             mrope_positions=mrope_positions,
                             page_table=page_table, attn_impl=attn_impl,
                             kv_valid_len=kv_valid_len)
        y = reduce_rows(y, blk.attn.wo)      # row-parallel under a plan
    x = x + y
    aux = {}
    if blk.mlp is not None:
        mlp = _quant_weights(blk.mlp, w_fmt)
        h = rmsnorm(full(blk.norm2), x, cfg.norm_eps)
        if isinstance(blk.mlp, MoE):
            y, aux = moe_apply(mlp, h, cfg=cfg)
        elif isinstance(blk.mlp, GeluMLP):
            y = gelu_mlp_apply(mlp, h)
        else:
            y = reduce_rows(swiglu_apply(mlp, h), blk.mlp.w_down)
        x = x + y
    if a_fmt is not None:
        x = fake_quant_ste(x, *a_fmt)      # the paper's "data" bits
    return x, cache, aux


def forward_hidden(model: Transformer, tokens, cfg, *, embeds=None,
                   positions=None, mrope_positions=None,
                   quant: Optional[ModelQuant] = None, caches=None,
                   cache_pos=None, page_table=None, attn_impl="gather",
                   kv_valid_len=None):
    """Backbone only: returns (hidden after the final norm, caches, aux);
    ``aux["moe_lb_loss"]`` is the sum of the MoE layers' load-balance
    losses (a float32 scalar, 0 without MoE layers), as the reference's
    segment scans sum it.

    tokens: (B, S) ids, or None with ``embeds`` (B, S, D), a stub
    frontend's frame or patch embeddings, cast to the compute dtype (and,
    under ``quant``, fake-quantized with layer 0's data format as the
    token embedding would be); ``positions`` (B, S): explicit RoPE
    positions (default ``cache_pos`` + arange(S); cache writes still go
    to ``cache_pos``); ``mrope_positions`` (B, S, 3): M-RoPE ids for an
    M-RoPE config. ``caches``: None (attend within the sequence: the
    training / whole-prompt forward) or :func:`init_cache`'s per-layer
    list, updated in place; ``cache_pos``: scalar or (B,) position of each
    row's first token; ``page_table`` (B, NP) int32 drives paged caches;
    ``attn_impl`` ("gather" | "kernel") picks the paged attention route
    for every chunk shape; ``kv_valid_len`` masks padded prefill chunk
    tails. A recurrent layer's entry of ``caches`` is its (B, ...) state,
    read and replaced. ``quant`` fake-quantizes the embedding output with
    layer 0's data format, then each block as :func:`block_apply`, a
    recurrent layer's state on its KV format; under a per-layer KV profile
    each layer writes and reads its own pool at its own width (both of the
    reference's ``kv_profile_scan`` lowerings are this one per-layer
    loop)."""
    if embeds is not None:
        x = embeds.to(cfg.torch_dtype)
    else:
        x = model.embed_rows(tokens)
    B, S = x.shape[0], x.shape[1]
    x = constrain(x, "dp", None, None)   # batch over the data axes
    if positions is None:
        base = per_row(0 if cache_pos is None else cache_pos, B, x.device)
        positions = base[:, None] + torch.arange(S, device=x.device)[None, :]
    if quant is not None and quant.a_int is not None:
        x = fake_quant_ste(x, *quant.layer_data(0))  # the embedding output
    lb = None
    for li, blk in enumerate(model.layers):
        kvq = wf = af = sq = None
        if quant is not None:
            kvq, wf, af, sq = (quant.layer_kv(li), quant.layer_weight(li),
                               quant.layer_data(li), quant.layer_state(li))
        x, cache, aux = block_apply(
            blk, x, positions, cfg=cfg,
            cache=None if caches is None else caches[li],
            cache_pos=cache_pos, kv_quant=kvq, w_fmt=wf, a_fmt=af,
            page_table=page_table, attn_impl=attn_impl,
            kv_valid_len=kv_valid_len, state_quant=sq,
            mrope_positions=mrope_positions)
        if caches is not None:
            caches[li] = cache
        if "moe_lb_loss" in aux:
            lb = aux["moe_lb_loss"] if lb is None else lb + aux["moe_lb_loss"]
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, {"moe_lb_loss": lb}


def forward(model: Transformer, tokens, cfg, **kw):
    """Returns (hidden, logits, caches, aux), as the reference's
    ``forward``; ``tokens`` and keywords as :func:`forward_hidden`."""
    x, caches, aux = forward_hidden(model, tokens, cfg, **kw)
    return x, model.logits(x), caches, aux


def train_loss(model: Transformer, batch, cfg, *,
               quant: Optional[ModelQuant] = None, lb_coeff: float = 0.01):
    """The training loss of ``batch``, the reference's batch: "tokens"
    (B, S) or, from a stub frontend, "embeds" (B, S, D); "labels" (B, S);
    optional "positions" (B, S), "mrope_positions" (B, S, 3) and "mask"
    (B, S), the first three as :func:`forward_hidden` takes them. The
    loss is token cross-entropy (:func:`chunked_ce_loss` when
    ``cfg.loss_chunk`` > 0), plus ``lb_coeff`` times the MoE load-balance
    loss for a MoE config, plus 0.3 times the multi-token-prediction loss
    when ``cfg.mtp_depth`` > 0 (the hidden state at t beside the embedding
    of token t + 1, projected, through the MTP block and norm, against
    label t + 1; it reads ``batch["tokens"]``, as the reference's does).
    Returns (loss, metrics): ``ce_loss``, ``moe_lb_loss``, ``mtp_loss``
    (with MTP) and ``loss``, float32 scalars, as the reference's."""
    labels = batch["labels"]
    hidden, _, aux = forward_hidden(
        model, batch.get("tokens"), cfg, quant=quant,
        embeds=batch.get("embeds"), positions=batch.get("positions"),
        mrope_positions=batch.get("mrope_positions"))
    if cfg.loss_chunk > 0:
        loss = chunked_ce_loss(hidden, model.head_weight(), labels,
                               chunk=cfg.loss_chunk, mask=batch.get("mask"))
    else:
        loss = cross_entropy(lm_head(model.head_weight(), hidden), labels,
                             batch.get("mask"))
    metrics = {"ce_loss": loss, "moe_lb_loss": aux["moe_lb_loss"]}
    if cfg.num_experts:
        loss = loss + lb_coeff * aux["moe_lb_loss"]
    if cfg.mtp_depth > 0:
        mtp = _quant_weights(model.mtp, None)
        nxt = model.embed_rows(batch["tokens"][:, 1:])
        h = torch.cat([hidden[:, :-1], nxt], dim=-1) @ mtp.proj
        pos = torch.arange(h.shape[1], device=h.device)[None, :].expand(
            h.shape[0], -1)
        h, _, _ = block_apply(model.mtp.block, h, pos, cfg=cfg, cache=None,
                              cache_pos=None)
        h = rmsnorm(model.mtp.norm, h, cfg.norm_eps)
        if cfg.loss_chunk > 0:
            mtp_loss = chunked_ce_loss(h, model.head_weight(), labels[:, 1:],
                                       chunk=cfg.loss_chunk)
        else:
            mtp_loss = cross_entropy(lm_head(model.head_weight(), h),
                                     labels[:, 1:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def prefill(model: Transformer, tokens, cfg, *,
            quant: Optional[ModelQuant] = None, max_len: int, **inputs):
    """Run the prompt (B, S) through the model into fresh dense
    ``max_len`` caches; ``tokens`` may be None with ``embeds`` (B, S, D),
    which then gives B and S; ``inputs`` (``embeds``, ``positions``,
    ``mrope_positions``) as :func:`forward_hidden`. Returns (logits at the
    last position (B, V), caches, next position S)."""
    emb = inputs.get("embeds")
    B, S = tokens.shape if emb is None else emb.shape[:2]
    caches = init_cache(cfg, quant, None, model.device, batch=B,
                        max_len=max_len, kv_heads=kv_heads(cfg))
    _, logits, caches, _ = forward(model, tokens, cfg, quant=quant,
                                   caches=caches, cache_pos=0, **inputs)
    return logits[:, -1], caches, S


def decode_step(model: Transformer, tokens, pos, caches, cfg, *,
                quant: Optional[ModelQuant] = None, page_table=None,
                attn_impl="gather"):
    """One decode step. tokens: (B,) int32; pos: scalar or (B,) current
    lengths. Returns (logits (B, V), caches)."""
    _, logits, caches, _ = forward(model, tokens[:, None], cfg, quant=quant,
                                   caches=caches, cache_pos=pos,
                                   page_table=page_table,
                                   attn_impl=attn_impl)
    return logits[:, 0], caches
