"""Batched serving launcher: continuous-batching prefill + decode over a
dense or paged quantized KV cache.

A REQUEST = (prompt token ids, max_new_tokens). The server packs up to
``batch_size`` requests into fixed slots and decodes step by step with
per-slot positions; finished slots are refilled from the queue, idle slots
write harmlessly (their own dense row, or the scratch page).

* Dense caches (``page_size=0``, the default): one (batch, max_len) slab
  per layer; ``kv_bits`` > 0 stores the int8 grid of Q(2, kv_bits - 2) at
  every width, 0 keeps float K/V in the compute dtype. Admission prefills
  token at a time (stepwise) through the shared decode step.
* Paged pools (``page_size`` > 0): one pool per layer plus a per-slot page
  table; pages are allocated as a request grows and freed when it ends.
  ``kv_bits`` 8 stores int8 pages, 4 packs a 4-bit grid 8 per int32 word,
  0 keeps float pages in the compute dtype.
* FIFO admission preflights each request's worst-case page demand: a
  request that can never fit is rejected with ``OutOfPagesError`` (raised
  after the serviceable traffic drained), one that must wait is deferred.
* Bucketed chunked prefill: one forward per power-of-two prompt chunk
  (``prefill_bucket`` caps it), and same-bucket chunks of several
  admissions stack into one [rows, bucket] forward. ``prefill="stepwise"``
  keeps the token-at-a-time reference path, and is what a MoE model in
  ``moe_mode="scatter"`` gets (its expert capacity depends on the
  forward's token count) and an arch with recurrent layers, as in the
  reference.
* MoE models (Llama 4, DeepSeek-V3) serve on either cache; an MLA model
  (DeepSeek-V3) keeps its latent in dense slabs only (a paged cache
  raises, as in the reference).
* Recurrent archs (xLSTM; Jamba's Mamba layers beside paged or dense
  attention) keep one dense state row per slot. Admission restarts the
  slot's rows from their initial values, and a stepwise prefill step
  leaves the other slots' rows as they were (the reference does
  neither). A preempted request parks its rows with its pages and
  resumes on them (the reference parks pages only). The prefix cache, a
  per-layer KV profile and fused rounds are refused for them.
* The VLM (Qwen2-VL) serves from token ids with plain RoPE, as the
  reference does (M-RoPE with three equal ids); the encoder
  (hubert-xlarge) has no decode, and the CLI refuses it in the
  reference's words.
* Fused rounds (``fused="on"``, paged and bucketed only): ONE ragged
  [batch, bucket] program per scheduler cycle, in which prefill chunks
  and the other slots' decode tokens share one forward; the steady state
  runs the same program at S = 1.
* Attention (``attn_impl``, paged only): ``"kernel"`` routes prefill
  chunks AND decode through the CUDA paged-attention kernel; ``"gather"``
  reads the pool through the dense gather (the reference route).
* Decode runs in spans between slot events; next-token ids stay on the
  device within a span and come to the host once, at its end.
* Prefix sharing (``prefix_cache="on"``, paged only): prompts are indexed
  page by page in a radix trie (``core.prefix_cache``); a new request
  aliases the fully matched pages, copies the page it diverges inside
  (copy-on-write) and prefills only its suffix. Same-wave prompts that
  share full pages alias the first one's fresh pages (wave dedupe).
  Unreferenced cached pages are evicted least recently used first under
  pool pressure.
* Per-page scales (``kv_scale="page"``): each page's dequant scale is the
  max-abs of what was written to it, raised (and the page requantized) in
  place; such pages are shared only once full.
* Per-layer KV profile (``kv_profile``, a ``PrecisionPolicy``): each layer
  stores int4 pages for <= 4 data bits, int8 for <= 8, float pages for a
  float layer.
* ``metrics="on"`` records request-lifecycle spans on ``self.tracer``
  (Chrome trace JSON, ``slo_summary``); ``snapshot_out`` streams registry
  snapshots as JSONL.
* Tiered page store (``kv_offload="host"``, ``core.page_store``): pool
  pressure demotes unreferenced cached prefixes to a host tier, bytes in
  their containers, instead of destroying them, and admission promotes
  matched host pages back. ``pager_async="on"`` issues those copies on a
  side CUDA stream through pinned memory and resolves them at span
  boundaries, and prefetches the pages the queue head will promote.
  ``snapshot_prefix_cache`` / ``restore_prefix_cache``
  (``--prefix-snapshot``) persist the cached chains across restarts.
* Online precision adaptation (``kv_adapt="on"``, prefix cache on): pool
  pressure first narrows cold cached pages one container step (fp ->
  int8 -> int4) into a byte-bounded device tier, and a hit widens them
  back.
* SLO scheduling (``sched="slo"``): admission orders the queue by
  (priority, deadline, arrival), may admit up to ``admit_window``
  requests past a deferred head, and (with the host tier) preempts a
  strictly less urgent running request: its private pages go to the host
  tier, its cached prompt pages stay pinned, its recurrent state rows
  stay on the device, and it resumes later from the same bytes without a
  re-prefill. ``predictor="on"`` gates new
  no-deadline admissions on an online deadline-miss model.

* Tensor-parallel serving (``mesh=``, the CLI's ``--tp N``): SPMD over
  the ranks of ``launch.mesh.make_serving_mesh``'s "model" axis. Every
  rank runs the same host scheduler, allocator and prefix cache (they are
  deterministic, so their counters agree; the one wall-clock input, the
  predictor's TPOT slowdown, is the first rank's on every rank), and holds its shards of the
  weights and of the paged pool as ``parallel.sharding`` lays them out:
  query and KV heads, ``d_ff``, the embedding's D and the head's vocab
  over "model". The row-parallel products (``wo``, ``w_down``)
  all-reduce, the embedding rows and the logits all-gather, and a page
  scale's absmax is maxed over every rank (``parallel.hints``). A MoE
  layer's experts are split E / tp over "model": every rank routes every
  token with the global capacity, runs its own experts' rows and the
  partial outputs are summed (``models.moe``); where tp does not divide
  the experts the stacks stay whole and only the shared expert's
  row-parallel product is summed. Where tp does not divide the KV heads
  the pool is replicated and every rank attends over every head
  (``models.attention.gqa_apply``). A recurrent mixer (Jamba's Mamba,
  xLSTM's mLSTM and sLSTM) runs whole on every rank on whole
  activations and replicated states, only its output projection
  row-parallel (``models.ssm``). The quant tier requantizes a page with
  the max-abs over every rank's heads and quotes the whole pool's bytes
  (``core.page_store.QuantTierStore``). Every family serves on paged
  pools; an MLA model refuses pages (the reference's words).

  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --requests 8 --batch-size 4 --max-new 8 --page-size 16 --kv-bits 8
  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --kv-bits 8                                    # dense cache
  python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \\
      --smoke --device cpu --page-size 16 --kv-bits 8
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --num-layers 4 \\
      --kv-bits 8                                    # dense latent cache
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke \\
      --device cpu --page-size 16 --kv-bits 8        # Mamba + attention
  python -m repro_torch.launch.serve --arch qwen2-vl-2b --smoke \\
      --device cpu --page-size 16 --kv-bits 8        # the VLM, from tokens
  python -m repro_torch.launch.serve --arch qwen2-72b --num-layers 8 \\
      --page-size 16 --kv-bits 8 --attn-impl kernel --fused on
  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --page-size 8 --kv-bits 8 --prefix-cache on --kv-scale page \\
      --trace-out trace.json
  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --page-size 8 --kv-bits 8 --num-pages 24 --prefix-cache on \\
      --kv-offload host --sched slo --pager-async on
  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --page-size 8 --kv-bits 8 --tp 2               # 2 gloo ranks
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs.counting import layer_signatures
from ..configs.registry import get_config, get_smoke_config
from ..core.fixedpoint import FixedPointFormat
from ..core.page_store import (HostPageStore, QuantTierStore, TieredPager,
                               cache_geometry, extract_page,
                               load_prefix_snapshot, save_prefix_snapshot,
                               snapshot_path)
from ..core.paged_kv import (SCRATCH_PAGE, OutOfPagesError, PageAllocator,
                             PagedCacheSpec, caches_kv_bytes, copy_pool_pages,
                             map_kv_pools, max_pages_per_seq)
from ..core.policy import LayerPolicy, PrecisionPolicy
from ..core.prefix_cache import PrefixCache
from ..models.attention import ATTN_IMPLS
from ..models.common import frozen
from ..models.transformer import Transformer, init_cache, init_model
from ..parallel.hints import activation_hints, first_rank_value, kv_heads
from ..parallel.sharding import (local_shard, paged_pool_specs, param_specs,
                                 plan_for_mesh)
from ..quant.apply import (build_model_quant, kv_profile_key,
                           transformer_layer_names)
from ..runtime.telemetry import (MetricsRegistry, MetricsSnapshotter,
                                 SLOMonitor, make_tracer, metric_attr)
from .scheduler import DeadlineMissPredictor, SchedPolicy, SLOScheduler
from .steps import make_chunk_prefill_step, make_decode_step, \
    make_fused_step


@dataclasses.dataclass
class PreemptedState:
    """A preempted request's slot state, captured at a span boundary: the
    cache position, the next token, the generated count, one entry per
    slot page in page-table order, either ``("host", handle)`` (the page's
    bytes went to the host tier) or ``("alias", node)`` (the page is a
    still-resident prefix-cache node: the slot's reference was dropped and
    the node pinned, and resume aliases it again), and the slot's row of
    every recurrent state (layer -> name -> a copy on the device; empty for
    an attention-only arch). The reference parks no states and resumes a
    request on whatever its new slot holds (ROADMAP queue C item C4)."""

    pos: int
    token: int
    gen: int
    entries: List[tuple]
    states: Dict[int, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0           # higher = more urgent (SLO scheduling)
    deadline_step: Optional[int] = None  # SLO: finish by this decode step
    arrive_step: int = 0        # becomes visible to admission at this step
    error: Optional[Exception] = None    # set when admission rejects
    finish_step: Optional[int] = None    # decode-step clock at retirement
    preemptions: int = 0
    _paused: Optional[PreemptedState] = None
    # the admission cycle's predictor features (predictor on, deadlined
    # requests): the training example its met/missed outcome labels
    _risk_feat: Optional[list] = None


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n, clipped to cap (the max bucket)."""
    return min(cap, 1 << max(0, n - 1).bit_length())


def _shared_page_tokens(a: np.ndarray, b: np.ndarray, ps: int) -> int:
    """The common prefix of two prompts that both requests write (each
    writes prompt[:-1]), rounded down to full ``ps``-token pages: the span
    one admission-wave prompt can alias off another's fresh pages."""
    n = min(len(a), len(b)) - 1
    if n <= 0:
        return 0
    eq = a[:n] == b[:n]
    common = n if eq.all() else int(np.argmin(eq))
    return (common // ps) * ps


@dataclasses.dataclass
class _PrefillJob:
    """One planned bucketed prefill (slot already reserved or aliased):
    feed ``req.prompt[start:-1]`` into the pool. ``done`` counts written
    tokens across the batched rounds; ``finished`` flips once the slot's
    clock and token are final. ``wait_for = (leader_job, shared)`` marks a
    wave-dedupe follower: it sits out rounds until the leader has written
    through token ``shared``, then aliases the leader's pages for
    [start, shared) and jumps ``start`` there."""

    slot: int
    req: Request
    start: int
    done: int = 0
    finished: bool = False
    wait_for: Optional[tuple] = None

    @property
    def total(self) -> int:
        return max(0, len(self.req.prompt) - 1 - self.start)


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """A private device copy of a host buffer the serving loop mutates in
    place (pos, tokens, page table). ``np.array`` snapshots it and the
    copy to the device is blocking, so no later host write can race the
    device read."""
    return torch.from_numpy(np.array(x)).to(device)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP queue A "
                               f"item {item}")


@torch.no_grad()
def shard_model(model: Transformer, cfg, plan) -> Transformer:
    """This rank's shards of ``model``'s parameters under ``plan``, the
    reference's inference placements (``parallel.sharding.param_specs``):
    a :class:`Transformer` of the same structure whose every parameter is
    its local shard, marked with its sharded dim as ``tp_dim`` (the
    collectives of ``parallel.hints`` key on it). An unsharded dim stays
    a view of ``model``'s tensor."""
    local = Transformer(cfg, device="meta")
    src = dict(model.named_parameters())
    specs = param_specs(model, cfg, plan, inference=True)
    if set(specs) != set(src):
        raise ValueError(f"parameters without a placement: "
                         f"{sorted(set(src) - set(specs))}")
    for name, spec in specs.items():
        p = frozen(local_shard(src[name].detach(), spec, plan))
        dims = [d for d, ax in enumerate(spec) if ax == plan.model_axis]
        if dims:
            p.tp_dim = dims[0]
        mod, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(mod), leaf, p)
    return local


def _under(plan, fn):
    """``fn`` run with ``plan``'s collectives active."""
    def step(*args, **kwargs):
        with activation_hints(plan):
            return fn(*args, **kwargs)
    return step


class BatchedServer:
    """Fixed-slot continuous batching with per-slot positions.

    Invariant per occupied slot i: cache positions [0, pos[i]) hold the KV
    of the request's consumed tokens and ``tokens[i]`` is the next token to
    consume. Free slots sit at pos 0 with their page-table row on the
    scratch page, so the shared decode step runs them harmlessly.

    ``model`` is a ``models.transformer.Transformer`` on ``device``; the
    caches are allocated there. ``page_size`` 0 = dense caches, > 0 =
    paged pools (an MLA model's latent cache is dense only). ``prefill``:
    "auto" = bucketed where it is output-equivalent to stepwise (a paged
    cache, and exact MoE routing: no experts, or ``moe_mode`` "eval_all"),
    else stepwise; "bucketed" = bucketed chunked prefill (raises where
    "auto" would not take it);
    "stepwise" = the token-at-a-time reference. ``prefill_batch`` caps
    how many same-bucket prompts stack into one prefill forward (0 = the
    batch size). ``fused="on"`` runs one ragged program per scheduler
    cycle (needs bucketed prefill). ``prefix_cache``, ``kv_scale``,
    ``kv_profile`` (with ``kv_profile_scan``, "group" or "unroll": one
    per-layer loop in the port either way, but the page store groups its
    records as the reference's pools of that scan mode), ``metrics`` (with
    ``snapshot_out``/``snapshot_every``), ``kv_offload`` (with
    ``host_pages``, ``pager_async``), ``kv_adapt`` (with ``adapt_pages``,
    ``adapt_floor_bits``) and ``sched`` (with ``admit_window``,
    ``preempt``, ``predictor``) are as in the module docstring.
    ``registry`` injects the server's metrics registry (the replica
    frontend's namespaced ones); the default is one of its own. ``mesh``
    (``launch.mesh.make_serving_mesh``) serves tensor-parallel: ``model``
    is the whole model on every rank, and the server keeps this rank's
    shards of it (``self.model``).
    """

    prefill_forwards = metric_attr("serve.prefill_forwards")
    prefill_tokens = metric_attr("serve.prefill_tokens")
    prefill_s = metric_attr("serve.prefill_s")
    decode_steps = metric_attr("serve.decode_steps")
    program_launches = metric_attr("serve.program_launches")
    cycles = metric_attr("serve.cycles")
    wave_dedup_pages = metric_attr("serve.wave_dedup_pages")
    _gen_tokens = metric_attr("serve.gen_tokens")
    prefix_hit_tokens = metric_attr("serve.prefix_hit_tokens")
    prefill_forwards_saved = metric_attr("serve.prefill_forwards_saved")
    preempt_count = metric_attr("serve.preempt_count")
    resume_count = metric_attr("serve.resume_count")
    realias_skipped = metric_attr("serve.realias_skipped")

    def __init__(self, cfg, model, *, batch_size: int, max_len: int,
                 kv_bits: int = 0, page_size: int = 0,
                 num_pages: Optional[int] = None,
                 attn_impl: str = "gather", prefill: str = "auto",
                 prefill_bucket: int = 32, prefill_batch: int = 0,
                 kv_profile: Optional[PrecisionPolicy] = None,
                 kv_scale: str = "static", prefix_cache: str = "off",
                 kv_profile_scan: str = "group",
                 kv_offload: str = "none",
                 host_pages: Optional[int] = None,
                 sched: str = "fifo", admit_window: int = 4,
                 preempt: Optional[bool] = None,
                 kv_adapt: str = "off", adapt_pages: int = 0,
                 adapt_floor_bits: int = 4, fused: str = "off",
                 metrics: str = "off",
                 registry: Optional[MetricsRegistry] = None,
                 snapshot_out: Optional[str] = None,
                 snapshot_every: int = 50, predictor: str = "off",
                 pager_async: str = "off", mesh=None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, server asked "
                             f"for {self.device}")
        self.paged = page_size > 0
        if self.paged and cfg.attention_type == "mla":
            raise NotImplementedError("paged KV serving supports GQA archs")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        if attn_impl == "kernel" and not self.paged:
            raise ValueError("--attn-impl kernel routes the paged attention "
                             "kernel; it needs --page-size > 0")
        if prefill not in ("auto", "bucketed", "stepwise"):
            raise ValueError(f"prefill must be auto|bucketed|stepwise, "
                             f"got {prefill!r}")
        attn_only = all(k == "attn" for k in cfg.layer_kinds)
        # bucketed prefill is only offered where it is output-equivalent to
        # the stepwise reference: SSM states are per-slot dense, and
        # capacity-bounded scatter MoE routes differently at chunk batch
        # shapes (capacity scales with the forward's token count)
        bucketed_ok = (self.paged and attn_only
                       and (cfg.num_experts == 0
                            or cfg.moe_mode == "eval_all"))
        if prefill == "bucketed" and not bucketed_ok:
            raise ValueError("bucketed prefill needs a paged cache, an "
                             "attention-only arch (SSM states are per-slot "
                             "dense), and exact MoE routing (scatter-mode "
                             "expert capacity depends on the forward's "
                             "token count); use prefill='stepwise'")
        self.prefill_mode = ("bucketed" if prefill in ("auto", "bucketed")
                             and bucketed_ok else "stepwise")
        if kv_scale not in ("static", "page"):
            raise ValueError(f"kv_scale must be 'static' or 'page', "
                             f"got {kv_scale!r}")
        if kv_scale == "page" and not (self.paged
                                       and (kv_bits or kv_profile)):
            raise ValueError("--kv-scale page calibrates per-page dequant "
                             "scales; it needs a quantized paged cache "
                             "(--page-size > 0 and --kv-bits/--kv-profile)")
        self.kv_scale = kv_scale
        if prefix_cache not in ("on", "off"):
            raise ValueError(f"prefix_cache must be 'on' or 'off', "
                             f"got {prefix_cache!r}")
        if prefix_cache == "on" and not self.paged:
            raise ValueError("--prefix-cache on shares pool pages; it needs "
                             "--page-size > 0")
        if prefix_cache == "on" and not attn_only:
            raise ValueError("prefix sharing needs an attention-only arch: "
                             "an SSM state folds the whole prefix, so "
                             "cached KV pages cannot stand in for skipped "
                             "prefill forwards")
        if kv_offload not in ("none", "host"):
            raise ValueError(f"kv_offload must be 'none' or 'host', "
                             f"got {kv_offload!r}")
        if kv_offload == "host" and not self.paged:
            raise ValueError("--kv-offload host demotes pool pages; it "
                             "needs --page-size > 0")
        if kv_adapt not in ("off", "on"):
            raise ValueError(f"kv_adapt must be 'off' or 'on', "
                             f"got {kv_adapt!r}")
        if kv_adapt == "on" and not (self.paged and prefix_cache == "on"):
            raise ValueError("--kv-adapt on requantizes cold CACHED prefix "
                             "pages under pool pressure; it needs "
                             "--page-size > 0 and --prefix-cache on")
        if adapt_floor_bits not in (4, 8):
            raise ValueError(f"adapt_floor_bits must be 4 or 8, "
                             f"got {adapt_floor_bits}")
        if sched not in ("fifo", "slo"):
            raise ValueError(f"sched must be 'fifo' or 'slo', got {sched!r}")
        if sched == "slo" and not self.paged:
            raise ValueError("--sched slo schedules page-pool admission; "
                             "it needs --page-size > 0")
        if preempt is None:
            preempt = sched == "slo" and kv_offload == "host"
        if preempt and kv_offload != "host":
            raise ValueError("preemption parks victim pages in the host "
                             "tier; it needs --kv-offload host")
        if preempt and sched != "slo":
            raise ValueError("preemption is driven by the SLO scheduler; "
                             "it needs --sched slo")
        if predictor not in ("off", "on"):
            raise ValueError(f"predictor must be 'off' or 'on', "
                             f"got {predictor!r}")
        if predictor == "on" and sched != "slo":
            raise ValueError("--predictor on gates speculative admissions "
                             "inside the SLO admission loop; it needs "
                             "--sched slo")
        if pager_async not in ("off", "on"):
            raise ValueError(f"pager_async must be 'off' or 'on', "
                             f"got {pager_async!r}")
        if pager_async == "on" and kv_offload != "host":
            raise ValueError("--pager-async on overlaps host-tier page "
                             "transfers with decode; it needs "
                             "--kv-offload host")
        if kv_profile_scan not in ("group", "unroll"):
            raise ValueError(f"kv_profile_scan must be 'group' or 'unroll', "
                             f"got {kv_profile_scan!r}")
        # the page store's record grouping: the reference unrolls only a
        # per-layer profile
        self.kv_scan = kv_profile_scan if kv_profile is not None else "group"
        if fused not in ("on", "off"):
            raise ValueError(f"fused must be 'on' or 'off', got {fused!r}")
        if fused == "on" and self.prefill_mode != "bucketed":
            raise ValueError("--fused on runs ONE ragged prefill+decode "
                             "program per scheduler cycle; it needs the "
                             "bucketed prefill path (paged cache, "
                             "attention-only arch, exact MoE routing)")
        if prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        if prefill_batch < 0:
            raise ValueError("prefill_batch must be >= 0 (0 = auto)")
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = make_tracer(metrics)
        self.scheduler = (SLOScheduler(SchedPolicy(admit_window=admit_window,
                                                   preempt=preempt),
                                       metrics=self.metrics)
                          if sched == "slo" else None)
        self._snapshotter = (MetricsSnapshotter(self.metrics, snapshot_out,
                                                every=snapshot_every)
                             if snapshot_out else None)
        self._clock = 0
        self.cfg = cfg
        self.model = model
        self.B = batch_size
        self.max_len = max_len
        self.attn_impl = attn_impl
        self.prefill_bucket = prefill_bucket
        self.prefill_batch = prefill_batch
        self.slo_monitor = SLOMonitor(self.metrics)
        self.predictor = (DeadlineMissPredictor(metrics=self.metrics)
                          if predictor == "on" else None)
        self._risk_feat_last: Optional[list] = None
        self.quant = None
        if kv_profile is not None:
            if kv_bits:
                raise ValueError("--kv-profile supersedes --kv-bits; "
                                 "pass only one")
            if not (self.paged and attn_only):
                raise ValueError("--kv-profile (per-layer KV containers) "
                                 "needs a paged cache and an attention-only "
                                 "arch")
            # serving quantizes the cache only: the data formats pick the
            # containers, and weight formats (a search's output has them)
            # are dropped
            kv_profile = PrecisionPolicy(
                kv_profile.names,
                tuple(LayerPolicy(None, lp.data) for lp in kv_profile.layers))
            self.quant = build_model_quant(
                kv_profile, cfg, quantize_kv=True,
                quantize_activations=False, per_layer_kv=True,
                kv_scale_mode=kv_scale)
        elif kv_bits:
            # dense slabs store int8 at every width; pages pack <= 4 bits
            container = "int4" if (self.paged and kv_bits <= 4) else "int8"
            pol = PrecisionPolicy.uniform(transformer_layer_names(cfg), None,
                                          FixedPointFormat(2, kv_bits - 2))
            self.quant = build_model_quant(pol, cfg, quantize_kv=True,
                                           quantize_activations=False,
                                           kv_container=container,
                                           kv_scale_mode=kv_scale)
        # pages are shared only between identically quantized configs:
        # the prefix cache namespaces its trie by this key
        self.profile_key = kv_profile_key(kv_profile, kv_bits=kv_bits,
                                          kv_scale_mode=kv_scale)
        # tensor-parallel placement: ONE replica over the mesh's "model"
        # ranks (see the module docstring)
        self.mesh = mesh
        self.mesh_plan = None
        if mesh is not None:
            if not self.paged:
                raise ValueError("mesh-sharded serving shards the paged KV "
                                 "pool; it needs --page-size > 0")
            self.mesh_plan = plan_for_mesh(mesh)
            self._check_backend()
            self.model = shard_model(model, cfg, self.mesh_plan)
        self.decode = make_decode_step(cfg, quant=self.quant,
                                       attn_impl=attn_impl)
        self._chunk_prefill = (
            make_chunk_prefill_step(cfg, quant=self.quant,
                                    attn_impl=attn_impl)
            if self.prefill_mode == "bucketed" else None)
        self.fused = fused == "on"
        self._fused = (make_fused_step(cfg, quant=self.quant,
                                       attn_impl=attn_impl)
                       if self.fused else None)
        if self.mesh_plan is not None:
            self.decode = _under(self.mesh_plan, self.decode)
            if self._chunk_prefill is not None:
                self._chunk_prefill = _under(self.mesh_plan,
                                             self._chunk_prefill)
            if self._fused is not None:
                self._fused = _under(self.mesh_plan, self._fused)
        if self.fused:
            # steady-state span constants: every row decodes (valid_len 1)
            # and every row emits
            self._ones_dev = torch.ones((batch_size,), dtype=torch.int32,
                                        device=self.device)
            self._arange_dev = torch.arange(batch_size, dtype=torch.int32,
                                            device=self.device)

        self.page_size = page_size
        spec = None
        self.prefix_cache: Optional[PrefixCache] = None
        self.host_store: Optional[HostPageStore] = None
        self.pager: Optional[TieredPager] = None
        if self.paged:
            self.np_max = max_pages_per_seq(max_len, page_size)
            if num_pages is None:
                num_pages = 1 + batch_size * self.np_max  # full capacity
            spec = PagedCacheSpec(page_size=page_size, num_pages=num_pages)
            self.allocator = PageAllocator(num_pages, metrics=self.metrics)
            self.page_table = np.full((batch_size, self.np_max),
                                      SCRATCH_PAGE, np.int32)
            self.slot_pages: List[List[int]] = [[] for _ in
                                                range(batch_size)]
            self.slot_reserved = [0] * batch_size  # worst-case page demand
            self._pt_dev = _upload(self.page_table, self.device)
            self._pt_dirty = False
            if kv_offload == "host":
                self.host_store = HostPageStore(max_pages=host_pages,
                                                metrics=self.metrics)
                self.pager = TieredPager(
                    self.allocator, self.host_store, lambda: self.caches,
                    metrics=self.metrics, async_mode=pager_async == "on",
                    tracer=self.tracer, scan=self.kv_scan)
                self.allocator.host_inventory = \
                    lambda: self.host_store.num_pages
            if prefix_cache == "on":
                self.prefix_cache = PrefixCache(self.allocator, page_size,
                                                self.profile_key,
                                                pager=self.pager,
                                                metrics=self.metrics,
                                                tracer=self.tracer)
                # pool pressure requantizes, demotes or drops cold cached
                # prefixes before an allocation fails
                self.allocator.reclaim = self.prefix_cache.evict
        self.caches = init_cache(cfg, self.quant, spec, self.device,
                                 batch=batch_size, max_len=max_len,
                                 kv_heads=kv_heads(cfg, self.mesh_plan))
        if self.mesh_plan is not None:
            self._mark_pool_shards(cfg, spec, batch_size, max_len)
        # recurrent layers' per-slot states, each layer's initial row: a
        # slot admitting a request restarts from it
        self._state0 = {li: {k: t[:1].clone()
                             for k, t in self.caches[li].items()}
                        for li, (kind, _) in enumerate(layer_signatures(cfg))
                        if kind != "attn"}
        # the adaptation tier probes the pools' geometry, so it follows
        # the caches
        self.quant_tier: Optional[QuantTierStore] = None
        if kv_adapt == "on":
            self.quant_tier = QuantTierStore(
                lambda: self.caches,
                pages=adapt_pages or self.allocator.num_usable,
                floor_bits=adapt_floor_bits, metrics=self.metrics,
                scan=self.kv_scan, plan=self.mesh_plan)
            self.prefix_cache.tier = self.quant_tier
            self.allocator.requant_inventory = \
                self.prefix_cache.requantizable_pages
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros((batch_size,), np.int32)     # host-side lengths
        self.tokens = np.zeros((batch_size,), np.int32)  # host-side tokens
        self.slot_gen = [0] * batch_size                 # generated counts
        self.prefill_forwards = 0   # forward executions in prefill
        self.prefill_tokens = 0     # prompt tokens consumed by prefill
        self.prefill_s = 0.0
        self.decode_steps = 0
        self.program_launches = 0   # every forward executed
        self.cycles = 0             # scheduler cycles (decode span steps)
        self.wave_dedup_pages = 0   # pages aliased off a same-wave leader
        self._gen_tokens = 0        # generated tokens (all run() calls)
        self.prefix_hit_tokens = 0        # prompt tokens served from cache
        self.prefill_forwards_saved = 0   # forwards prefix hits avoided
        self.preempt_count = 0            # victim slots parked + re-queued
        self.resume_count = 0             # preempted requests resumed
        self.realias_skipped = 0          # victim pages kept resident by
        #                                   re-aliasing cache nodes
        self.rejected: List[Request] = []
        if self.paged:
            reg = self.metrics.register_gauge
            reg("kv.device_bytes",
                lambda: sum(caches_kv_bytes(self.caches).values()))
            reg("kv.device_pages_free", lambda: self.allocator.num_free)
            reg("kv.device_pages_usable", lambda: self.allocator.num_usable)
            reg("kv.host_bytes",
                lambda: self.host_store.nbytes if self.host_store else 0)
            reg("kv.host_pages",
                lambda: self.host_store.num_pages if self.host_store else 0)
            reg("kv.tier_bytes",
                lambda: self.quant_tier.nbytes if self.quant_tier else 0)
            reg("kv.tier_pages",
                lambda: self.quant_tier.num_pages if self.quant_tier else 0)

    def _check_backend(self):
        """The mesh's collectives run on the server's device: NCCL for a
        card's tensors, gloo for the CPU's, never one for the other."""
        want = "nccl" if self.device.type == "cuda" else "gloo"
        backend = dist.get_backend(self.mesh_plan.model_group())
        if backend != want:
            raise ValueError(f"a {self.device.type} server's mesh needs "
                             f"{want}; its model group runs {backend}")

    def _mark_pool_shards(self, cfg, spec, batch: int, max_len: int):
        """Check this rank's pools against the plan's layout of the whole
        pools (``parallel.sharding.paged_pool_specs``) and mark each
        sharded one with its dim."""
        whole = init_cache(cfg, self.quant, spec, "meta", batch=batch,
                           max_len=max_len)
        plan = self.mesh_plan
        for li, (local, specs, w) in enumerate(
                zip(self.caches, paged_pool_specs(whole, plan), whole)):
            for key, t in local.items():
                dims = [d for d, ax in enumerate(specs[key])
                        if ax == plan.model_axis]
                want = tuple(n // plan.model_size if d in dims else n
                             for d, n in enumerate(w[key].shape))
                if tuple(t.shape) != want:
                    raise AssertionError(f"layer {li} {key}: local "
                                         f"{tuple(t.shape)} != {want}")
                if dims:
                    t.tp_dim = dims[0]

    # -- page bookkeeping ---------------------------------------------------
    def _ensure_page(self, slot: int, position: int):
        """Allocate pages so logical ``position`` of ``slot`` is backed."""
        blk = position // self.page_size
        if self.kv_scale == "page" and blk < len(self.slot_pages[slot]):
            # the page-scale sharing contract
            # (core.paged_kv._paged_update_page_scale): a scale raise
            # rewrites the page in place, so a write target must be this
            # slot's alone; _cache_insert never shares a page its owner
            # still writes, so a violation is a refcount bug
            assert self.allocator.refcount(self.slot_pages[slot][blk]) == 1, \
                "page-scale write into a CoW-shared page"
        while len(self.slot_pages[slot]) <= blk:
            page = self.allocator.alloc()
            self.page_table[slot, len(self.slot_pages[slot])] = page
            self.slot_pages[slot].append(page)
            self._pt_dirty = True

    def _release_slot(self, slot: int):
        if self.paged:
            if self.slot_pages[slot]:
                self.allocator.free(self.slot_pages[slot])
                self.slot_pages[slot] = []
                self.page_table[slot, :] = SCRATCH_PAGE
                self._pt_dirty = True
            self.slot_reserved[slot] = 0
        self.pos[slot] = 0
        self.slot_gen[slot] = 0

    def _page_table_dev(self) -> torch.Tensor:
        if self._pt_dirty:
            self._pt_dev = _upload(self.page_table, self.device)
            self._pt_dirty = False
        return self._pt_dev

    def _pages_needed(self, req: Request) -> int:
        """Worst-case pages ``req`` can occupy: prompt + generation (at
        least one token), clipped by the max_len - 1 position ceiling."""
        tokens = min(len(req.prompt) - 1 + max(req.max_new, 1),
                     self.max_len - 1)
        return -(-max(tokens, 1) // self.page_size)

    def _outstanding_reservation(self) -> int:
        """Pages promised to live requests but not yet allocated."""
        return sum(max(0, self.slot_reserved[i] - len(self.slot_pages[i]))
                   for i in range(self.B) if self.slots[i] is not None)

    # -- stepwise prefill ---------------------------------------------------
    def _sync_step(self):
        """One whole-batch decode step from the host-side state (the
        token-at-a-time prefill path; output tokens are discarded)."""
        pt = self._page_table_dev() if self.paged else None
        self.decode(self.model, _upload(self.tokens, self.device),
                    _upload(self.pos, self.device), self.caches, pt)
        self.prefill_forwards += 1
        self.program_launches += 1

    def _reset_states(self, slot: int):
        """The slot's rows of every recurrent state back to its initial
        value (the sLSTM stabilizer's is -1e30, not 0)."""
        for li, init in self._state0.items():
            for k, t in self.caches[li].items():
                t[slot] = init[k][0]

    def _keep_other_states(self, held, slot: int):
        """After a stepwise prefill step: every recurrent state row but
        ``slot``'s back to ``held`` (the states before the step; a mixer
        returns new tensors and never writes the ones it is given)."""
        if not held:
            return
        rows = torch.arange(self.B, device=self.device) == slot
        for li, old in held.items():
            new = self.caches[li]
            self.caches[li] = {
                k: torch.where(rows.view(-1, *[1] * (t.dim() - 1)), t,
                               old[k]) for k, t in new.items()}

    def _prefill_slot(self, slot: int, req: Request, start: int = 0):
        """Feed prompt[start:-1] through shared decode steps, leaving the
        last prompt token in ``tokens`` for the decode loop (``start`` > 0:
        a prefix hit already backs positions [0, start)). Other slots
        rewrite their current position with identical values. Recurrent
        states restart from their initial value in ``slot`` and stay as
        they were in the other slots (the reference carries a slot's
        states over from its last request and advances the other slots'
        states with every step)."""
        t0 = time.perf_counter()
        self.pos[slot] = start
        self._reset_states(slot)
        for t in req.prompt[start:-1]:
            if self.paged:
                self._ensure_page(slot, int(self.pos[slot]))
            self.tokens[slot] = int(t)
            held = {li: dict(self.caches[li]) for li in self._state0}
            self._sync_step()
            self._keep_other_states(held, slot)
            self.pos[slot] += 1
        self.tokens[slot] = int(req.prompt[-1])
        self.prefill_forwards_saved += start
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += len(req.prompt)
        self.slot_gen[slot] = 0

    def _n_chunks(self, n: int) -> int:
        """Bucketed-prefill forwards needed for ``n`` prompt tokens."""
        c, done = 0, 0
        while done < n:
            done += min(_pow2_bucket(n - done, self.prefill_bucket), n - done)
            c += 1
        return c

    # -- batched bucketed prefill -------------------------------------------
    def _prefill_group_cap(self) -> int:
        return self.prefill_batch or self.B

    def _plan_wave_dedupe(self, pending: List[_PrefillJob]) -> None:
        """Pair each wave job with the earlier same-wave job (leader) whose
        prompt shares the most full pages beyond the job's own prefix hit;
        the follower waits (``wait_for``) until the leader has written
        through the shared span, then :meth:`_apply_wave_aliases` aliases
        those pages, so their forwards run once per wave. A follower must
        start page-aligned, with a leader that starts at or below it, and
        only fully written pages are aliased (the leader never writes them
        again, which keeps the page-scale sharing contract)."""
        ps = self.page_size
        leaders: List[_PrefillJob] = []
        for job in pending:
            best, best_shared = None, job.start
            if job.done == 0 and job.start % ps == 0:
                for lead in leaders:
                    if lead.start > job.start:
                        continue
                    shared = _shared_page_tokens(lead.req.prompt,
                                                 job.req.prompt, ps)
                    if shared > best_shared:
                        best, best_shared = lead, shared
            if best is not None:
                job.wait_for = (best, best_shared)
            else:
                leaders.append(job)

    def _apply_wave_aliases(self, pending: List[_PrefillJob]) -> None:
        """Unblock followers whose leader has written through the shared
        span: one incref per leader page for [start, shared) into the
        follower's table, no forward, and ``start`` jumps to ``shared``.
        Runs at every round boundary, so a leader that just finished its
        prefill unblocks its followers before it can retire."""
        ps = self.page_size
        for job in pending:
            if job.wait_for is None or job.finished:
                continue
            lead, shared = job.wait_for
            if lead.start + lead.done < shared:
                continue
            b0, b1 = job.start // ps, shared // ps
            assert len(self.slot_pages[job.slot]) == b0, \
                "wave-dedupe follower holds pages past its start"
            chunks_before = self._n_chunks(job.total)
            for b in range(b0, b1):
                page = self.slot_pages[lead.slot][b]
                self.allocator.incref(page)   # the follower's reference
                self.page_table[job.slot, b] = page
                self.slot_pages[job.slot].append(page)
            self._pt_dirty = True
            job.start = shared
            job.wait_for = None
            self.pos[job.slot] = shared
            self.wave_dedup_pages += b1 - b0
            self.prefill_forwards_saved += (chunks_before
                                            - self._n_chunks(job.total))
            if job.total == 0:
                self._finish_job(job)

    def _prefill_group(self, rows: List[_PrefillJob], bucket: int):
        """ONE batched prefill forward: each row's next ``bucket``-sized
        chunk, stacked into [n_rows, bucket] with per-row page tables,
        start positions and valid lengths. Rows are independent sequences
        writing disjoint pages."""
        n = len(rows)
        chunk = np.zeros((n, bucket), np.int32)
        starts = np.zeros((n,), np.int32)
        valids = np.zeros((n,), np.int32)
        pts = np.empty((n, self.np_max), np.int32)
        for r, job in enumerate(rows):
            off = job.start + job.done
            toks = job.req.prompt[off:len(job.req.prompt) - 1]
            valid = min(bucket, len(toks))
            self._ensure_page(job.slot, off + valid - 1)
            chunk[r, :valid] = toks[:valid]
            starts[r], valids[r] = off, valid
            pts[r] = self.page_table[job.slot]
        dev = self.device
        # private host arrays nobody mutates later: plain blocking copies
        with self.tracer.span("prefill_chunk",
                              args={"rows": n, "bucket": bucket,
                                    "step": self._clock}):
            self.caches = self._chunk_prefill(
                self.model, torch.from_numpy(chunk).to(dev),
                torch.from_numpy(starts).to(dev),
                torch.from_numpy(valids).to(dev), self.caches,
                torch.from_numpy(pts).to(dev))
        self.prefill_forwards += 1
        self.program_launches += 1
        for r, job in enumerate(rows):
            job.done += int(valids[r])
            self.pos[job.slot] = job.start + job.done

    def _finish_job(self, job: _PrefillJob):
        """Seal a prefilled slot: clock at the last prompt token, which the
        decode loop consumes, and its fresh pages indexed in the prefix
        cache."""
        self.pos[job.slot] = len(job.req.prompt) - 1
        self.tokens[job.slot] = int(job.req.prompt[-1])
        if self.prefix_cache is not None:
            self._cache_insert(job.slot, job.req)
        job.finished = True

    def _rollback_admission(self, job: _PrefillJob, err) -> None:
        """Undo one partially executed admission after a failed batch:
        release the row's pages and reservation and vacate the slot."""
        i = job.slot
        self.slots[i] = None
        if self.slot_pages[i]:
            self.allocator.free(self.slot_pages[i])
            self.slot_pages[i] = []
        self.page_table[i, :] = SCRATCH_PAGE
        self._pt_dirty = True
        self.slot_reserved[i] = 0
        self.pos[i] = 0
        self.tokens[i] = 0
        self.slot_gen[i] = 0
        self._discard_paused(job.req)
        job.req.error = err

    def _run_prefills(self, jobs: List[_PrefillJob]):
        """Execute one admission cycle's bucketed prefills. Round-robin:
        every round, each unfinished row contributes its next power-of-two
        chunk and rows sharing a bucket share a forward (at most
        ``_prefill_group_cap`` rows). An ``OutOfPagesError`` mid-batch
        rolls back every unfinished row before re-raising."""
        t0 = time.perf_counter()
        cap = self._prefill_group_cap()
        try:
            pending = self._start_jobs(jobs)
            if self.prefix_cache is not None and cap > 1:
                # same-wave sharing: followers alias a leader's fresh pages
                self._plan_wave_dedupe(pending)
            while pending:
                groups = {}
                for job in pending:
                    if job.wait_for is not None:
                        continue        # follower: leader still writing
                    b = _pow2_bucket(job.total - job.done,
                                     self.prefill_bucket)
                    groups.setdefault(b, []).append(job)
                for bucket in sorted(groups):
                    grp = groups[bucket]
                    for k in range(0, len(grp), cap):
                        self._prefill_group(grp[k:k + cap], bucket)
                self._apply_wave_aliases(pending)
                nxt = []
                for job in pending:
                    if job.finished:
                        continue        # the alias jump covered the job
                    if job.wait_for is None and job.done >= job.total:
                        self._finish_job(job)
                    else:
                        nxt.append(job)
                pending = nxt
        except OutOfPagesError as err:
            for job in jobs:
                if not job.finished:
                    self._rollback_admission(job, err)
            raise
        finally:
            self.prefill_s += time.perf_counter() - t0

    def _start_jobs(self, jobs: List[_PrefillJob]) -> List[_PrefillJob]:
        """Count an admission cycle's prompts, seal 1-token prompts, and
        return the jobs that still need forwards."""
        pending = []
        for job in jobs:
            self.prefill_tokens += len(job.req.prompt)
            self.prefill_forwards_saved += (
                self._n_chunks(len(job.req.prompt) - 1)
                - self._n_chunks(job.total))
            if job.total == 0:
                self._finish_job(job)   # full-chain hit / 1-token prompt
            else:
                pending.append(job)
        return pending

    # -- fused ragged cycles (fused="on") ------------------------------------
    def _fused_round(self, pending: List[_PrefillJob]) -> List[_PrefillJob]:
        """ONE ragged [B, bucket] program: every unfinished prefill job
        contributes its next prompt chunk (padded to the round's shared
        bucket, tail masked through valid_len) and every OTHER live slot
        decodes one token in the same launch. Returns the jobs still
        pending after the round."""
        ready = [j for j in pending if j.wait_for is None]
        bucket = max(_pow2_bucket(j.total - j.done, self.prefill_bucket)
                     for j in ready)
        prefilling = {j.slot for j in pending}
        decode = [i for i in range(self.B) if self.slots[i] is not None
                  and i not in prefilling]
        tokens = np.zeros((self.B, bucket), np.int32)
        starts = np.zeros((self.B,), np.int32)
        valids = np.ones((self.B,), np.int32)
        emit = np.zeros((self.B,), np.int32)   # fixed shape; the host
        #                                        discards padding entries
        for j in ready:
            off = j.start + j.done
            toks = j.req.prompt[off:len(j.req.prompt) - 1]
            valid = min(bucket, len(toks))
            self._ensure_page(j.slot, off + valid - 1)
            tokens[j.slot, :valid] = toks[:valid]
            starts[j.slot] = off
            valids[j.slot] = valid
        for k, i in enumerate(decode):
            self._ensure_page(i, int(self.pos[i]))
            tokens[i, 0] = self.tokens[i]
            starts[i] = self.pos[i]
            emit[k] = i
        waiting = [j.slot for j in pending if j.wait_for is not None]
        if waiting:
            # a waiting follower's row writes its default (token 0 at
            # position 0); its table may already alias cached prefix pages
            # (a page-aligned hit), so the round gives it the scratch page
            table = self.page_table.copy()
            table[waiting, :] = SCRATCH_PAGE
            pt = _upload(table, self.device)
        else:
            pt = self._page_table_dev()
        dev = self.device
        # private host arrays nobody mutates later: plain blocking copies
        with self.tracer.span("fused_round",
                              args={"bucket": bucket,
                                    "prefill_rows": len(ready),
                                    "decode_rows": len(decode),
                                    "step": self._clock}):
            nxt, _, self.caches = self._fused(
                self.model, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(starts).to(dev),
                torch.from_numpy(valids).to(dev), self.caches, pt,
                torch.from_numpy(emit).to(dev))
        self.program_launches += 1
        self.cycles += 1
        self.prefill_forwards += 1
        for j in ready:
            j.done += int(valids[j.slot])
            self.pos[j.slot] = j.start + j.done
        still = []
        for j in pending:
            if j.wait_for is None and j.done >= j.total:
                self._finish_job(j)     # decode-eligible next round
            else:
                still.append(j)
        # unblock followers before a retirement can free a leader's pages
        self._apply_wave_aliases(still)
        still = [j for j in still if not j.finished]
        if decode:
            arr = nxt.cpu().numpy()
            self.decode_steps += 1
            self._gen_tokens += len(decode)
            for k, i in enumerate(decode):
                tok = int(arr[k])
                req = self.slots[i]
                if not req.out:
                    self.tracer.req_first_token(req.rid)
                    self.slo_monitor.note_first_token(req.rid)
                req.out.append(tok)
                self.tokens[i] = tok
                self.pos[i] += 1
                self.slot_gen[i] += 1
                if (self.slot_gen[i] >= req.max_new
                        or self.pos[i] >= self.max_len - 1):
                    req.done = True
                    self.slots[i] = None
                    self._release_slot(i)
                    # fused admission rounds decode without advancing the
                    # run clock; the cycle's clock is the finish step
                    self._note_finish(req, self._clock)
        return still

    def _run_fused_rounds(self, jobs: List[_PrefillJob]):
        """Fused-mode admission: ``_run_prefills``'s accounting and
        rollback, but every round is one ragged fused program that also
        advances all non-prefilling decode slots, so admitting prompts
        costs no extra program launch per cycle."""
        t0 = time.perf_counter()
        try:
            pending = self._start_jobs(jobs)
            if self.prefix_cache is not None:
                self._plan_wave_dedupe(pending)
            while pending:
                pending = self._fused_round(pending)
        except OutOfPagesError as err:
            for job in jobs:
                if not job.finished:
                    self._rollback_admission(job, err)
            raise
        finally:
            self.prefill_s += time.perf_counter() - t0

    # -- prefix sharing -----------------------------------------------------
    def _copy_pool_pages(self, src: int, dst: int):
        """Copy page ``src`` -> ``dst`` in every layer's pool (one page-id
        space across layers: copy-on-write of a partly shared page)."""
        self.caches = map_kv_pools(
            self.caches, lambda pool: copy_pool_pages(pool, src, dst))

    def _cache_insert(self, slot: int, req: Request):
        """Index the request's prefilled prompt pages (tokens [0, P-1)) in
        the prefix cache; chunks already cached dedupe. In page-scale mode
        the partial tail page is left out: its owner keeps writing it, and
        a scale raise rewrites it in place under any reader (the sharing
        contract). Static mode shares the tail safely: later writes land
        past every sharer's valid length."""
        n_tok = len(req.prompt) - 1
        if self.kv_scale == "page":
            n_tok = (n_tok // self.page_size) * self.page_size
        if n_tok <= 0:
            return
        n_pages = -(-n_tok // self.page_size)
        self.prefix_cache.insert(req.prompt[:n_tok],
                                 self.slot_pages[slot][:n_pages])

    # -- admission ----------------------------------------------------------
    def _admission_plan(self, req: Request):
        """Preflight one request against the pool: ``(verdict, info)`` with
        verdict in {"admit", "defer", "reject"}. The worst-case demand,
        less the fully matched resident pages of a prefix hit, plus one
        page per matched node off the device (host or quant tier), is
        checked against the free list less outstanding reservations, plus
        the cached pages eviction could free, so ``_ensure_page`` can never
        find the free list empty mid-run. A preempted request needs only
        its host pages. On "admit" the hit's chain is pinned
        (``info["hit"]``) until ``_do_admit`` unpins it; a request that is
        deferred or rejected leaves nothing pinned. Malformed requests
        raise before any pin."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"request {req.rid} prompt length "
                             f"{len(req.prompt)} >= max_len {self.max_len}")
        if not self.paged:
            return "admit", {"hit": None, "total": 0}
        total = self._pages_needed(req)
        hit = None
        if req._paused is not None:
            # resume allocates only the host pages; re-aliased (pinned)
            # cache nodes cost nothing
            need_new = total - sum(1 for kind, _ in req._paused.entries
                                   if kind == "alias")
        elif self.prefix_cache is not None:
            # record=False: a deferred request retries this lookup every
            # span; the hit rate counts once, at admission
            hit = self.prefix_cache.lookup(req.prompt[:-1], record=False)
            self.prefix_cache.pin(hit)
            need_new = (total - len(hit.nodes)
                        + self.prefix_cache.host_nodes_in(hit))
        else:
            need_new = total
        avail = self.allocator.num_free - self._outstanding_reservation()
        evictable = 0
        if need_new > avail and self.prefix_cache is not None:
            evictable = self.prefix_cache.evictable_pages()
            avail += evictable
        if need_new <= avail:
            return "admit", {"hit": hit, "total": total,
                             "need_new": need_new}
        if hit is not None:
            self.prefix_cache.unpin(hit)
        if (need_new > self.allocator.num_usable
                or not any(s is not None for s in self.slots)):
            written = len(set().union(*map(set, self.slot_pages)))
            err = OutOfPagesError(
                needed=need_new, free=self.allocator.num_free,
                total=self.allocator.num_usable, rid=req.rid,
                reserved=self._outstanding_reservation(), written=written,
                evictable=evictable,
                requantizable=self.allocator.requant_pages(),
                host_pages=self.allocator.host_pages())
            return "reject", {"err": err}
        return "defer", {"total": total, "need_new": need_new,
                         "shortfall": need_new - avail}

    def _do_admit(self, i: int, req: Request, info: dict,
                  jobs: List[_PrefillJob]):
        """Claim free slot ``i`` for ``req``: make the pinned prefix chain
        resident and alias it, copy a page the prompt diverges inside, and
        stage the suffix's prefill (or resume a preempted request).
        Bucketed prefills are appended to ``jobs`` and run batched (or
        fused) at the end of the admission cycle (at once with
        ``prefill_batch=1``, so the next admission can alias them); a dense
        cache or stepwise mode prefills the slot here."""
        if (self.predictor is not None and req.deadline_step is not None
                and req._risk_feat is None):
            # this cycle's features; the request's outcome is their label
            req._risk_feat = self._risk_feat_last
        if not self.paged:
            self.tracer.req_admit(req.rid, self._clock)
            self._prefill_slot(i, req)
            self.slots[i] = req
            return
        if req._paused is not None:
            self._resume_slot(i, req, info["total"])
            return
        self.tracer.req_admit(req.rid, self._clock)
        hit = info["hit"]
        self.slot_reserved[i] = info["total"]
        start = 0
        if hit is not None:
            for j, node in enumerate(hit.nodes):
                # a host or quant-tier node comes back to the device first
                page = self.prefix_cache.ensure_resident(node)
                self.allocator.incref(page)   # the slot's alias
                self.page_table[i, j] = page
                self.slot_pages[i].append(page)
                self._pt_dirty = True
            start = len(hit.nodes) * self.page_size
            if hit.cow_node is not None and hit.cow_valid > 0:
                # divergence inside a shared page: a private copy
                src = self.prefix_cache.ensure_resident(hit.cow_node)
                dst = self.allocator.alloc()   # the reclaim hook may evict
                self.page_table[i, len(hit.nodes)] = dst
                self.slot_pages[i].append(dst)
                self._pt_dirty = True
                self._copy_pool_pages(int(src), int(dst))
                self.prefix_cache.cow_copies += 1
                start += hit.cow_valid
            self.prefix_cache.unpin(hit)
            self.prefix_cache.note_lookup(len(req.prompt) - 1, start)
            self.prefix_hit_tokens += start
        self.slots[i] = req
        self.pos[i] = start
        self.slot_gen[i] = 0
        if self.prefill_mode == "bucketed":
            job = _PrefillJob(i, req, start)
            if self.fused or self._prefill_group_cap() > 1:
                jobs.append(job)
            else:
                self._run_prefills([job])
        else:
            self._prefill_slot(i, req, start)
            if self.prefix_cache is not None:
                self._cache_insert(i, req)

    def _discard_paused(self, req: Request) -> None:
        """Release a preempted request's parked resources once it will
        never resume (a reject or a rollback): unpin each re-aliased prefix
        node and drop each host page of its resume state."""
        st = req._paused
        if st is None:
            return
        for kind, val in st.entries:
            if kind == "alias":
                self.prefix_cache.unpin_node(val)
            else:
                self.host_store.drop(val)
        req._paused = None

    def _reject(self, queue: List[Request], idx: int, err) -> None:
        """Drop a never-fit request from the queue; the error is recorded
        on the request (FIFO mode re-raises it once the serviceable traffic
        drained). A preempted request releases its parked state first."""
        req = queue.pop(idx)
        self._discard_paused(req)
        req.error = err
        req.done = True
        self.rejected.append(req)
        self.metrics.counter("sched.rejects").inc()
        self.slo_monitor.note_finish(req.rid, False, 0)
        self.tracer.req_reject(req.rid, self._clock,
                               reason=type(err).__name__)

    def _admit_fifo(self, queue: List[Request], jobs: List[_PrefillJob]):
        """FIFO admission: strict queue order; a never-fit head is rejected
        instead of stalling the queue behind it."""
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            while queue:
                verdict, info = self._admission_plan(queue[0])
                if verdict == "reject":
                    self._reject(queue, 0, info["err"])
                    continue              # next head, same free slot
                if verdict == "defer":
                    self.metrics.counter("sched.defers").inc()
                    self.tracer.req_defer(queue[0].rid, self._clock)
                    return                # wait for live requests' pages
                self._do_admit(i, queue.pop(0), info, jobs)
                break

    def _admit_slo(self, queue: List[Request], jobs: List[_PrefillJob],
                   spec_budget: Optional[int] = None):
        """Priority / EDF admission: up to ``admit_window`` requests past a
        deferred head may still be admitted, and a request that lacks a
        slot or pages may preempt strictly less urgent running requests
        (into the host tier). ``spec_budget`` (predictor on) caps new
        speculative admissions this cycle: no-deadline, non-resumed
        requests past it stay queued; deadlined and resuming requests are
        never gated."""
        pol = self.scheduler.policy
        self.scheduler.sort_queue(queue)
        preempts_left = pol.max_preempt_per_admit
        deferred = False
        examined = 0          # requests examined past the deferred head
        idx = 0
        while idx < len(queue):
            if deferred:
                examined += 1
                if examined > pol.admit_window:
                    break
            req = queue[idx]
            speculative = (req.deadline_step is None
                           and req._paused is None)
            if speculative and spec_budget is not None and spec_budget <= 0:
                # gate before planning: a plan pins the hit chain
                self.predictor.gated += 1
                self.tracer.req_defer(req.rid, self._clock)
                idx += 1
                continue
            free = [i for i in range(self.B) if self.slots[i] is None]
            if not free:
                # batch full: claim a slot by preempting a strictly less
                # urgent running request
                n = self._preempt_for(req, queue, 0, preempts_left)
                if n:
                    preempts_left -= n
                    continue
                break
            verdict, info = self._admission_plan(req)
            if verdict == "reject":
                self._reject(queue, idx, info["err"])
                continue
            if verdict == "admit":
                queue.pop(idx)
                self._do_admit(free[0], req, info, jobs)
                if speculative and spec_budget is not None:
                    spec_budget -= 1
                if deferred:
                    self.scheduler.ooo_admissions += 1
                continue
            # defer: try preemption before stepping past this request
            n = self._preempt_for(req, queue, info["shortfall"],
                                  preempts_left)
            if n:
                preempts_left -= n
                continue                  # plan the same request again
            self.metrics.counter("sched.defers").inc()
            self.tracer.req_defer(req.rid, self._clock)
            deferred = True
            idx += 1

    def _risk_features(self, queue: List[Request]) -> list:
        """The predictor's feature vector for this cycle. Queue depth and
        prefill debt count deadlined requests only, so a gated backlog of
        speculative work cannot feed the gate that holds it."""
        deadlined = [r for r in queue if r.deadline_step is not None]
        live = sum(1 for s in self.slots if s is not None)
        if self.paged:
            usable = max(1, self.allocator.num_usable)
            free = max(0, self.allocator.num_free
                       - self._outstanding_reservation())
            free_frac = free / usable
        else:
            free_frac = 1.0 - live / self.B
        return self.predictor.features(
            queue_deadlined=len(deadlined), batch=self.B,
            free_frac=free_frac,
            prefill_debt=sum(len(r.prompt) for r in deadlined),
            debt_cap=self.B * self.prefill_bucket,
            live_frac=live / self.B,
            arrival_ewma=self.slo_monitor.arrival_rate.get(),
            tpot_slowdown=self._tpot_slowdown())

    def _tpot_slowdown(self) -> float:
        """The predictor's one wall-clock feature. Under ``mesh=`` every
        rank takes the model group's first rank's reading: each rank's
        clock differs, and ranks that admitted differently would run
        different batches into one collective."""
        slowdown = self.slo_monitor.tpot_slowdown()
        if self.mesh_plan is None:
            return slowdown
        return first_rank_value(slowdown, self.mesh_plan, self.device)

    def _admit(self, queue: List[Request]):
        """One admission cycle: claim as many queued requests as slots and
        pages allow, then run their prefills batched."""
        if not queue:
            return
        self.metrics.histogram("sched.queue_depth").observe(len(queue))
        self.slo_monitor.note_queue_depth(len(queue))
        spec_budget: Optional[int] = None
        if self.predictor is not None:
            feat = self._risk_features(queue)
            self._risk_feat_last = feat
            self.predictor.consult(feat)
            spec_budget = self.predictor.spec_budget(self.B)
            if (spec_budget <= 0
                    and all(s is None for s in self.slots)
                    and not any(r.deadline_step is not None
                                or r._paused is not None for r in queue)):
                # nothing live and nothing the gate would let through:
                # admit one row so speculative traffic still drains
                spec_budget = 1
        with self.tracer.span("admission", args={"queued": len(queue),
                                                 "step": self._clock}):
            jobs: List[_PrefillJob] = []
            if self.scheduler is not None:
                self._admit_slo(queue, jobs, spec_budget)
            else:
                self._admit_fifo(queue, jobs)
            if jobs:
                if self.fused:
                    self._run_fused_rounds(jobs)
                else:
                    self._run_prefills(jobs)

    # -- preemption ---------------------------------------------------------
    def _preempt_gain(self, i: int) -> int:
        """Device pages preempting slot ``i`` recovers: its exclusively held
        pages (a shared page only drops a reference) plus its unallocated
        reservation."""
        freed = sum(1 for p in self.slot_pages[i]
                    if self.allocator.refcount(p) == 1)
        return freed + max(0, self.slot_reserved[i] - len(self.slot_pages[i]))

    def _realias_plan(self, i: int) -> dict:
        """Slot pages of ``i`` that alias still-resident prefix-cache nodes
        (page-table index -> node). Copying such a page to the host frees
        nothing (the cache's reference keeps it), so preemption pins the
        node and drops only the slot's reference, and resume aliases it
        again."""
        req = self.slots[i]
        if self.prefix_cache is None or req is None:
            return {}
        hit = self.prefix_cache.lookup(req.prompt[:-1], record=False)
        plan = {}
        for j, node in enumerate(hit.nodes):
            if (j < len(self.slot_pages[i]) and node.resident
                    and node.page == self.slot_pages[i][j]):
                plan[j] = node
            else:
                return plan     # a private page (a CoW copy): chain ends
        j = len(hit.nodes)
        if (hit.cow_node is not None and j < len(self.slot_pages[i])
                and hit.cow_node.resident
                and hit.cow_node.page == self.slot_pages[i][j]):
            plan[j] = hit.cow_node   # the victim's own partial leaf page
        return plan

    def _preempt_for(self, req: Request, queue: List[Request],
                     shortfall: int, budget: int) -> int:
        """Preempt strictly less urgent running slots so ``req`` becomes
        admissible (``shortfall`` pages short; 0 = it needs only a slot),
        at most ``budget`` victims. Victims go to the host tier (their
        cache-aliased pages are pinned instead and need no host room) and
        re-queue. Returns the slots preempted."""
        if self.scheduler is None or self.host_store is None or budget <= 0:
            return 0
        running = [(i, self.slots[i], 0) for i in range(self.B)
                   if self.slots[i] is not None]
        victims = self.scheduler.choose_victims(
            req, running, max(0, shortfall), self._preempt_gain,
            limit=budget)
        preempted = 0
        for i in victims:
            plan = self._realias_plan(i)
            need_room = len(self.slot_pages[i]) - len(plan)
            while not self.host_store.has_room(need_room):
                # make host room by dropping cold demoted prefixes
                if (self.prefix_cache is None
                        or not self.prefix_cache.drop_host_lru()):
                    return preempted      # the host tier is full
            queue.append(self._preempt_slot(i, plan))
            preempted += 1
        return preempted

    def _preempt_slot(self, i: int, plan: Optional[dict] = None) -> Request:
        """Evict the request in slot ``i`` at a span boundary: each private
        page goes to the host tier (``pager.offload``) and each
        cache-aliased page stays resident as a pinned node; the slot's
        pages and reservation are released and the resume state captured,
        the slot's recurrent state rows included. Returns the request, to
        re-queue."""
        if plan is None:
            plan = self._realias_plan(i)
        req = self.slots[i]
        self.tracer.req_preempt(req.rid, self._clock)
        entries = []
        with self.tracer.req_span(req.rid, "offload",
                                  args={"pages": len(self.slot_pages[i]),
                                        "step": self._clock}):
            for j, p in enumerate(self.slot_pages[i]):
                node = plan.get(j)
                if node is not None:
                    # the cache's reference keeps the page; the pin keeps
                    # eviction off it until resume
                    self.prefix_cache.pin_node(node)
                    entries.append(("alias", node))
                    self.realias_skipped += 1
                else:
                    entries.append(("host", self.pager.offload(p)))
                self.allocator.free([p])
        self.slot_pages[i] = []
        self.page_table[i, :] = SCRATCH_PAGE
        self._pt_dirty = True
        self.slot_reserved[i] = 0
        states = {li: {k: t[i].clone() for k, t in self.caches[li].items()}
                  for li in self._state0}
        req._paused = PreemptedState(pos=int(self.pos[i]),
                                     token=int(self.tokens[i]),
                                     gen=int(self.slot_gen[i]),
                                     entries=entries, states=states)
        req.preemptions += 1
        self.preempt_count += 1
        self.pos[i] = 0
        self.slot_gen[i] = 0
        self.tokens[i] = 0
        self.slots[i] = None
        return req

    def _resume_slot(self, i: int, req: Request, total: int):
        """Re-admit a preempted request: its host pages go into freshly
        allocated pages (the same bytes; ``pager.resume`` uses the upload
        ``_prefetch_promotes`` staged), its pinned nodes are aliased again,
        and the slot's clock, token, count and recurrent state rows are
        restored. No prefill runs (so no state reset)."""
        st = req._paused
        self.slot_reserved[i] = total
        with self.tracer.req_span(req.rid, "resume",
                                  args={"pages": len(st.entries),
                                        "step": self._clock}):
            for j, (kind, val) in enumerate(st.entries):
                if kind == "alias":
                    assert val.resident, "pinned prefix node lost residency"
                    page = val.page
                    self.allocator.incref(page)  # the slot's alias
                    self.prefix_cache.unpin_node(val)
                else:
                    page = self.pager.resume(val)  # reclaim may evict
                self.page_table[i, j] = page
                self.slot_pages[i].append(page)
                self._pt_dirty = True
        for li, rows in st.states.items():
            for k, t in self.caches[li].items():
                t[i] = rows[k]
        self.pos[i] = st.pos
        self.tokens[i] = st.token
        self.slot_gen[i] = st.gen
        req._paused = None
        self.resume_count += 1
        self.tracer.req_admit(req.rid, self._clock, resumed=True)
        self.slots[i] = req

    # -- decode -------------------------------------------------------------
    def _run_span(self) -> int:
        """Decode steps until the next slot event (a completion), computable
        from counts alone."""
        spans = [min(req.max_new - self.slot_gen[i],
                     (self.max_len - 1) - int(self.pos[i]))
                 for i, req in enumerate(self.slots) if req is not None]
        return max(1, min(spans))

    def _note_finish(self, req: Request, step: int) -> None:
        req.finish_step = step
        missed = req.deadline_step is not None and step > req.deadline_step
        if missed:
            self.metrics.counter("sched.deadline_misses").inc()
        if self.predictor is not None and req._risk_feat is not None:
            self.predictor.observe(req._risk_feat, missed)
        self.slo_monitor.note_finish(req.rid, not missed, len(req.out))
        self.tracer.req_finish(req.rid, step, len(req.out))

    def start_loop(self, requests: List[Request]) -> "ServeLoop":
        return ServeLoop(self, requests)

    def _prefetch_promotes(self, queue: List[Request]) -> None:
        """Async pager: requests still queued after admission are next
        cycle's candidates, so stage the upload of their host-parked pages
        (prefix-chain nodes and preempted state) now, behind the decode
        span about to run. Pure staging through ``peek_chain`` (no trie
        stamps, no allocation): tokens are the same with it on or off."""
        pager = self.pager
        if pager is None or not pager.async_mode or not queue:
            return
        budget = pager.stage_room()
        # only the queue head can be admitted next cycle
        for req in queue[:max(2, self.B)]:
            if budget <= 0:
                return
            if req._paused is not None:
                for kind, val in req._paused.entries:
                    if kind == "host" and budget > 0:
                        budget -= pager.prefetch(val)
                continue
            if self.prefix_cache is None:
                continue
            for node in self.prefix_cache.peek_chain(req.prompt[:-1]):
                if node.host is not None and budget > 0:
                    budget -= pager.prefetch(node.host)

    def run(self, requests: List[Request], *, verbose: bool = False):
        t0 = time.perf_counter()
        gen0 = self._gen_tokens
        steps0, pf0 = self.decode_steps, self.prefill_forwards
        rejected0 = len(self.rejected)
        loop = self.start_loop(requests)
        while loop.tick():
            pass
        loop.close()
        dt = time.perf_counter() - t0
        if verbose:
            steps = self.decode_steps - steps0
            cache = (f"paged ps={self.page_size} "
                     f"free={self.allocator.num_free}" if self.paged
                     else f"dense max_len={self.max_len}")
            print(f"[serve] {steps} decode steps, "
                  f"{self.prefill_forwards - pf0} prefill forwards "
                  f"({self.prefill_mode}), {len(requests)} requests, "
                  f"{(self._gen_tokens - gen0) / max(dt, 1e-9):,.1f} tok/s "
                  f"({cache}, attn={self.attn_impl}, "
                  f"fused={'on' if self.fused else 'off'}, "
                  f"{self.program_launches} programs / {self.cycles} "
                  f"cycles, device={self.device})")
            if self.prefix_cache is not None:
                s = self.prefix_cache.stats()
                print(f"[serve] prefix cache: {s['hits']}/{s['lookups']} "
                      f"hits, {s['hit_tokens']} tokens reused, "
                      f"{self.prefill_forwards_saved} prefill forwards "
                      f"saved, {s['cow_copies']} CoW copies, "
                      f"{s['cached_pages']} pages cached + "
                      f"{s['host_pages']} host ({s['evictions']} evicted, "
                      f"{s['demotions']} demoted, {s['promotions']} "
                      f"promoted)")
            if self.quant_tier is not None:
                s = self.prefix_cache.stats()
                print(f"[serve] quant tier: {self.quant_tier.num_pages} "
                      f"pages / {self.quant_tier.nbytes / 2**20:.2f} MiB "
                      f"parked (peak {self.quant_tier.peak_pages}), "
                      f"{s['requants']} requants, {s['deepens']} deepens, "
                      f"{s['tier_promotions']} promotions")
            if self.host_store is not None:
                print(f"[serve] host tier: {self.host_store.num_pages} "
                      f"pages / {self.host_store.nbytes / 2**20:.2f} MiB "
                      f"(peak {self.host_store.peak_pages}), "
                      f"{self.preempt_count} preemptions, "
                      f"{self.resume_count} resumes, "
                      f"{self.realias_skipped} pages re-aliased")
        new_rejects = self.rejected[rejected0:]
        if new_rejects and self.scheduler is None:
            # FIFO: the first impossible request surfaces once the
            # serviceable traffic drained; SLO mode records the errors on
            # the requests
            raise new_rejects[0].error
        return requests

    def release_prefix_cache(self) -> int:
        """Drop every unreferenced cached prefix page back to the free list
        (and every parked one out of the host and quant tiers). Returns the
        device pages the cache still holds: 0 once every request has
        finished, anything else is a refcount leak."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.clear()

    def kv_inventory(self) -> dict:
        """The KV store's bytes per container and page counts on the device,
        the host tier and the quant tier, with the reference's keys.
        Scalars read the registered ``kv.*`` gauges, so this dict and the
        snapshot stream share one schema; ``host_pinned_bytes`` (the port's
        own) is the pinned host memory the pager holds for its transfers
        (the host tier itself is ordinary memory)."""
        inv = {"device_bytes": 0, "device_by_container": {},
               "device_pages_free": 0, "device_pages_usable": 0,
               "host_bytes": 0, "host_pages": 0, "host_by_container": {},
               "tier_bytes": 0, "tier_pages": 0, "tier_by_container": {},
               "host_pinned_bytes": 0}
        if self.paged:
            g = self.metrics.gauge
            hs, qt = self.host_store, self.quant_tier
            inv.update(
                device_bytes=g("kv.device_bytes").value,
                device_by_container=caches_kv_bytes(self.caches),
                device_pages_free=g("kv.device_pages_free").value,
                device_pages_usable=g("kv.device_pages_usable").value,
                host_bytes=g("kv.host_bytes").value,
                host_pages=g("kv.host_pages").value,
                host_by_container=hs.bytes_by_container() if hs else {},
                tier_bytes=g("kv.tier_bytes").value,
                tier_pages=g("kv.tier_pages").value,
                tier_by_container=qt.bytes_by_container() if qt else {},
                host_pinned_bytes=(self.pager.pinned_bytes
                                   if self.pager else 0))
        return inv

    def snapshot_prefix_cache(self, path: str) -> int:
        """Write every cached prefix page (resident ones read off the
        pools, parked ones from their tier, widened back to the pools'
        containers) to ``path`` in the reference's format, namespaced by
        profile key, with the pool-geometry signature. Returns the pages
        written."""
        if self.prefix_cache is None:
            raise ValueError("snapshot needs --prefix-cache on")
        entries = []
        for key, tokens, node in self.prefix_cache.iter_chain_nodes():
            if node.host is not None:
                blob = self.host_store.get(node.host)
            elif node.tier is not None:
                blob = self.quant_tier.export(node.tier)
            else:
                blob = extract_page(self.caches, node.page,
                                    scan=self.kv_scan)
            entries.append((key, tokens, blob))
        return save_prefix_snapshot(
            path, entries, page_size=self.page_size,
            geometry=cache_geometry(self.caches, scan=self.kv_scan))

    def restore_prefix_cache(self, path: str) -> int:
        """Load a snapshot into the HOST tier: each chain page becomes a
        host-state trie node (no device page until a hit promotes it).
        Chains of another profile key stay in their own namespace. Returns
        the pages restored (fewer when the host tier fills)."""
        if self.prefix_cache is None:
            raise ValueError("restore needs --prefix-cache on")
        if self.host_store is None:
            raise ValueError("restore lands pages in the host tier; it "
                             "needs --kv-offload host")
        meta, entries = load_prefix_snapshot(path)
        if meta["page_size"] != self.page_size:
            raise ValueError(f"snapshot page_size {meta['page_size']} != "
                             f"server page_size {self.page_size}")
        if meta["geometry"] != cache_geometry(self.caches, scan=self.kv_scan):
            raise ValueError("snapshot pool geometry does not match this "
                             "server's architecture/profile")
        n = 0
        for key, tokens, blob in entries:
            if not self.host_store.has_room(1):
                break
            h = self.host_store.put(blob)
            if self.prefix_cache.insert_host(tokens, h, key):
                n += 1
            else:
                self.host_store.drop(h)   # a duplicate or orphaned chain
        return n


class ServeLoop:
    """One in-flight :meth:`BatchedServer.run`, steppable one scheduler
    cycle at a time: arrivals (on the decode-step clock), admission, the
    promote prefetch, one decode span, then the pager's drain.

    A multi-replica frontend (``launch.frontend.ReplicaFrontend``) drives
    N loops on one shared clock: :meth:`add` delivers a request mid-run,
    and ``tick(limit_step=)`` never moves the clock past ``limit_step``,
    acting exactly as a pending arrival at that step would (a span cap
    while busy, a clock jump while idle). ``limit_step=None`` is
    :meth:`BatchedServer.run`'s tick sequence, so one replica's tokens
    equal the plain server's bit for bit."""

    def __init__(self, srv: BatchedServer, requests: List[Request]):
        self.srv = srv
        self.pending = sorted(requests, key=lambda r: r.arrive_step)
        self.queue: List[Request] = []
        self.clock = 0
        self.finished = False

    @property
    def live(self) -> bool:
        return any(s is not None for s in self.srv.slots)

    def add(self, req: Request) -> None:
        """Deliver one more request mid-run. A stable insert: same-step
        arrivals keep their delivery order, as the sort in ``__init__``."""
        i = len(self.pending)
        while i > 0 and self.pending[i - 1].arrive_step > req.arrive_step:
            i -= 1
        self.pending.insert(i, req)
        self.finished = False

    def tick(self, limit_step: Optional[int] = None) -> bool:
        """One scheduler cycle, never moving ``clock`` past ``limit_step``
        (when given). Returns True while the loop works or moves its
        clock; False once drained (``finished`` is then set)."""
        srv = self.srv
        pending, queue = self.pending, self.queue
        if not (pending or queue or self.live):
            if limit_step is not None and limit_step > self.clock:
                # empty but clock-limited: the frontend may still route
                # arrivals here, so follow the shared clock
                self.clock = limit_step
                return True
            self.finished = True
            return False
        clock = self.clock
        srv._clock = clock
        while pending and pending[0].arrive_step <= clock:
            req = pending.pop(0)
            srv.tracer.req_arrive(req.rid, req.arrive_step,
                                  req.deadline_step)
            srv.slo_monitor.note_arrive(req.rid)
            queue.append(req)
        srv._admit(queue)
        srv._prefetch_promotes(queue)
        live = [i for i in range(srv.B) if srv.slots[i] is not None]
        if not live:
            if pending:
                nxt = pending[0].arrive_step
                if limit_step is not None:
                    nxt = min(nxt, limit_step)
                self.clock = max(clock, nxt)
                return True
            if limit_step is not None and limit_step > clock:
                # idle, and the frontend may still route arrivals here
                self.clock = limit_step
                return True
            self.finished = True
            return False
        span = srv._run_span()
        if pending:
            # cap the span at the next arrival so it gets admitted promptly
            span = max(1, min(span, pending[0].arrive_step - clock))
        if limit_step is not None:
            span = max(1, min(span, limit_step - clock))
        dev = srv.device
        # device-resident span state: tokens advance device-to-device and
        # come to the host once, at the span boundary
        tokens_dev = _upload(srv.tokens, dev)
        pos_dev = _upload(srv.pos, dev)
        live_mask = np.zeros((srv.B,), bool)
        live_mask[live] = True
        all_live = bool(live_mask.all())
        live_mask_dev = _upload(live_mask, dev)
        live_inc = live_mask_dev.to(torch.int32)
        fetches, owners = [], []
        with srv.tracer.span("decode_span",
                             args={"steps": span, "rows": len(live),
                                   "step": clock}):
            for _ in range(span):
                if srv.paged:
                    for i in live:
                        srv._ensure_page(i, int(srv.pos[i]))
                pt = srv._page_table_dev() if srv.paged else None
                if srv.fused:
                    # steady state: the fused program of the admission
                    # rounds at S = 1, every row decoding and emitting
                    nxt, _, srv.caches = srv._fused(
                        srv.model, tokens_dev[:, None], pos_dev,
                        srv._ones_dev, srv.caches, pt, srv._arange_dev)
                else:
                    nxt, _, srv.caches = srv.decode(
                        srv.model, tokens_dev, pos_dev, srv.caches, pt)
                srv.program_launches += 1
                srv.cycles += 1
                fetches.append(nxt)
                owners.append(tuple(srv.slots))
                # idle slots hold their token
                tokens_dev = (nxt if all_live
                              else torch.where(live_mask_dev, nxt,
                                               tokens_dev))
                pos_dev = pos_dev + live_inc
                for i in live:
                    srv.pos[i] += 1
                    srv.slot_gen[i] += 1
                srv.decode_steps += 1
                srv._gen_tokens += len(live)
            # span boundary: one device -> host copy of the span's tokens
            arr = torch.stack(fetches).cpu().numpy()
            for row, slots in zip(arr, owners):
                for i, req in enumerate(slots):
                    if req is not None:
                        if not req.out:
                            srv.tracer.req_first_token(req.rid)
                            srv.slo_monitor.note_first_token(req.rid)
                        req.out.append(int(row[i]))
        if srv.pager is not None:
            # span boundary: resolve the async transfers that ran behind
            # the span
            srv.pager.drain()
        for i in live:
            srv.tokens[i] = int(arr[-1][i])
            req = srv.slots[i]
            if (srv.slot_gen[i] >= req.max_new
                    or srv.pos[i] >= srv.max_len - 1):
                req.done = True
                srv.slots[i] = None
                srv._release_slot(i)
                srv._note_finish(req, clock + span)
        self.clock = clock + span
        srv.slo_monitor.advance(span)
        if srv._snapshotter is not None:
            srv._snapshotter.maybe_emit(srv.cycles)
        return True

    def close(self) -> None:
        """The final pager drain."""
        if self.srv.pager is not None:
            self.srv.pager.drain()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the config's depth to this many layers "
                         "(0 = the config's own); widths stay as published")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 4, 8],
                    help="0 = float pages, 8 = int8 pages, 4 = 4-bit grid "
                         "packed 8 per int32 word")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page; 0 = dense max_len cache")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared pool pages (0 = full capacity)")
    ap.add_argument("--attn-impl", choices=list(ATTN_IMPLS),
                    default="gather",
                    help="paged attention route: the dense gather reference "
                         "or the CUDA kernel (its plain version on CPU); "
                         "kernel needs --page-size > 0")
    ap.add_argument("--prefill", choices=["auto", "bucketed", "stepwise"],
                    default="auto")
    ap.add_argument("--prefill-bucket", type=int, default=32)
    ap.add_argument("--prefill-batch", type=int, default=0)
    ap.add_argument("--fused", choices=["on", "off"], default="off",
                    help="on = ONE ragged [batch, bucket] program per "
                         "scheduler cycle (prefill chunks and decode tokens "
                         "in one forward); needs --page-size > 0 and "
                         "bucketed prefill")
    ap.add_argument("--kv-profile", default="",
                    help="path to a PrecisionPolicy JSON: per-layer KV "
                         "containers (int4 pages for <= 4 data bits, int8 "
                         "for <= 8, float pages for float layers); needs "
                         "--page-size > 0, supersedes --kv-bits")
    ap.add_argument("--kv-profile-scan", choices=["group", "unroll"],
                    default="group",
                    help="the reference's two lowerings of the per-layer "
                         "forward; the port runs one per-layer loop for "
                         "both")
    ap.add_argument("--kv-scale", choices=["static", "page"],
                    default="static",
                    help="paged dequant scales: static = the layer's Q(I,F) "
                         "grid; page = per-page max-abs calibration")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="off",
                    help="share page-aligned common prompt prefixes across "
                         "requests (refcounted aliasing, copy-on-write, LRU "
                         "eviction under pool pressure)")
    ap.add_argument("--kv-offload", choices=["none", "host"], default="none",
                    help="host = a host-memory page tier: pool pressure "
                         "demotes cached prefixes (containers and scales "
                         "ride along) instead of destroying them; enables "
                         "preemption and snapshots")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-tier capacity in pages (0 = unbounded)")
    ap.add_argument("--kv-adapt", choices=["off", "on"], default="off",
                    help="on = pool pressure first requantizes cold cached "
                         "prefix pages one container step narrower (fp -> "
                         "int8 -> int4) into a bounded device tier; needs "
                         "--prefix-cache on")
    ap.add_argument("--kv-adapt-pages", type=int, default=0,
                    help="adaptation-tier byte budget in floor-container "
                         "pages (0 = the pool's usable page count)")
    ap.add_argument("--kv-adapt-floor", type=int, choices=[4, 8], default=4,
                    help="narrowest container requantization may reach")
    ap.add_argument("--sched", choices=["fifo", "slo"], default="fifo",
                    help="admission order: fifo, or slo = priority + "
                         "earliest deadline with bounded out-of-order "
                         "admission and preemption")
    ap.add_argument("--admit-window", type=int, default=4,
                    help="SLO sched: requests examined past a deferred "
                         "head per cycle")
    ap.add_argument("--no-preempt", action="store_true",
                    help="SLO sched: never preempt running requests")
    ap.add_argument("--predictor", choices=["off", "on"], default="off",
                    help="on = an online deadline-miss predictor gates new "
                         "no-deadline admissions; needs --sched slo")
    ap.add_argument("--pager-async", choices=["off", "on"], default="off",
                    help="on = host-tier copies on a side CUDA stream "
                         "through pinned memory, resolved at decode-span "
                         "boundaries, and promote prefetch; needs "
                         "--kv-offload host")
    ap.add_argument("--prefix-snapshot", default="",
                    help="path: restore the prefix cache from it at start "
                         "(if it exists) and snapshot it back at exit")
    ap.add_argument("--metrics", choices=["off", "on"], default="off",
                    help="on = record request-lifecycle spans and print an "
                         "SLO summary (p50/p99 TTFT and TPOT, goodput); "
                         "tokens are identical either way")
    ap.add_argument("--trace-out", default="",
                    help="path: write the request-lifecycle trace as Chrome "
                         "trace-event JSON; implies --metrics on")
    ap.add_argument("--metrics-out", default="",
                    help="path: append a JSONL registry snapshot every "
                         "--metrics-every scheduler cycles; implies "
                         "--metrics on")
    ap.add_argument("--metrics-every", type=int, default=50)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of ONE serving replica: "
                         "spawns tp ranks (gloo on --device cpu, NCCL on "
                         "the cards), a (world // tp, tp) data x model mesh "
                         "(launch.mesh.make_serving_mesh), heads, d_ff, "
                         "vocab and the paged pool's KV heads sharded over "
                         "'model' (a pool whose KV heads tp does not divide "
                         "replicated), every family; needs --page-size > 0; "
                         "1 = one device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.trace_out or args.metrics_out:
        args.metrics = "on"
    if args.tp > 1:
        _config(args)       # the reference's refusals before any rank starts
        return _spawn_tp(args)
    return _serve(args)


def _config(args):
    """The CLI's config; an encoder exits in the reference's words."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only archs have no decode path")
    return cfg


def _spawn_tp(args):
    """``--tp N``: N ranks on this host, one device each, serve the same
    requests; rank 0 prints and its requests are returned. Raises the
    reference's ValueError when N does not divide the visible cards."""
    from .mesh import spawn_ranks
    if torch.device(args.device).type == "cuda":
        resolve_device(args.device)
        n = torch.cuda.device_count()
        if n % args.tp:
            raise ValueError(f"tp={args.tp} does not divide {n} visible "
                             f"devices")
    reqs = []
    for d in spawn_ranks(_tp_rank, args.tp, args, device=args.device)[0]:
        r = Request(d["rid"], np.asarray(d["prompt"], np.int32),
                    d["max_new"])
        r.out, r.done, r.finish_step = d["out"], d["done"], d["finish_step"]
        reqs.append(r)
    return reqs


def _tp_rank(rank: int, args):
    """One rank of ``--tp``: its requests' outcomes (rank 0's only)."""
    from .mesh import make_serving_mesh
    if rank:
        # every rank holds its own shards: rank r > 0 writes path.rank<r>
        args = argparse.Namespace(**vars(args))
        for k in ("prefix_snapshot", "trace_out", "metrics_out"):
            if getattr(args, k):
                setattr(args, k, f"{getattr(args, k)}.rank{rank}")
    mesh = make_serving_mesh(args.tp, device=args.device)
    reqs = _serve(args, mesh=mesh, verbose=rank == 0)
    if rank:
        return None
    return [{"rid": r.rid, "prompt": r.prompt.tolist(), "max_new": r.max_new,
             "out": list(r.out), "done": r.done,
             "finish_step": r.finish_step} for r in reqs]


def _serve(args, mesh=None, verbose: bool = True):
    """The CLI's run on this process (one rank of ``mesh`` when given)."""
    say = print if verbose else (lambda *a, **k: None)
    cfg = _config(args)
    kv_profile = None
    if args.kv_profile:
        with open(args.kv_profile) as f:
            kv_profile = PrecisionPolicy.from_json(f.read())
    device = resolve_device(args.device)
    model = init_model(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                    args.max_new)
            for i in range(args.requests)]
    srv = BatchedServer(cfg, model, batch_size=args.batch_size,
                        max_len=args.max_len, kv_bits=args.kv_bits,
                        page_size=args.page_size,
                        num_pages=args.num_pages or None,
                        attn_impl=args.attn_impl, prefill=args.prefill,
                        prefill_bucket=args.prefill_bucket,
                        prefill_batch=args.prefill_batch,
                        kv_profile=kv_profile, kv_scale=args.kv_scale,
                        prefix_cache=args.prefix_cache,
                        kv_profile_scan=args.kv_profile_scan,
                        kv_offload=args.kv_offload,
                        host_pages=args.host_pages or None,
                        sched=args.sched, admit_window=args.admit_window,
                        preempt=False if args.no_preempt else None,
                        kv_adapt=args.kv_adapt,
                        adapt_pages=args.kv_adapt_pages,
                        adapt_floor_bits=args.kv_adapt_floor,
                        fused=args.fused, metrics=args.metrics,
                        snapshot_out=args.metrics_out or None,
                        snapshot_every=args.metrics_every,
                        predictor=args.predictor,
                        pager_async=args.pager_async, mesh=mesh,
                        device=device)
    if args.prefix_snapshot and os.path.exists(
            snapshot_path(args.prefix_snapshot)):
        n = srv.restore_prefix_cache(args.prefix_snapshot)
        say(f"[serve] restored {n} prefix pages from "
              f"{args.prefix_snapshot} (host tier)")
    srv.run(reqs, verbose=verbose)
    if args.prefix_snapshot:
        n = srv.snapshot_prefix_cache(args.prefix_snapshot)
        say(f"[serve] snapshotted {n} prefix pages to "
              f"{args.prefix_snapshot}")
    if args.metrics == "on":
        slo = srv.tracer.slo_summary()
        ttft, tpot = slo.get("ttft_p50_s"), slo.get("tpot_p50_s")
        ttft99, goodput = slo.get("ttft_p99_s"), slo.get("goodput")
        say(f"[serve] slo: "
              f"goodput={'n/a' if goodput is None else format(goodput, '.3f')}"
              f" ({slo['finished']}/{slo['requests']} finished, "
              f"{slo['deadline_misses']} deadline misses), "
              f"ttft p50={0.0 if ttft is None else ttft * 1e3:.1f}ms "
              f"p99={0.0 if ttft99 is None else ttft99 * 1e3:.1f}ms, "
              f"tpot p50={0.0 if tpot is None else tpot * 1e3:.2f}ms")
    if args.trace_out:
        srv.tracer.export_chrome(args.trace_out)
        say(f"[serve] wrote {len(srv.tracer.events)} trace events to "
              f"{args.trace_out}")
    for r in reqs[:4]:
        say(f"  req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
