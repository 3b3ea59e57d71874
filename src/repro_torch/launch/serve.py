"""Batched serving launcher: continuous-batching prefill + decode over the
paged quantized KV pool.

A REQUEST = (prompt token ids, max_new_tokens). The server packs up to
``batch_size`` requests into fixed slots and decodes step by step with
per-slot positions; finished slots are refilled from the queue, idle slots
write to the scratch page.

* Paged pools (``page_size``): one pool per layer plus a per-slot page
  table; pages are allocated as a request grows and freed when it ends.
  ``kv_bits`` 8 stores int8 pages, 4 packs a 4-bit grid 8 per int32 word,
  0 keeps float pages in the compute dtype.
* FIFO admission preflights each request's worst-case page demand: a
  request that can never fit is rejected with ``OutOfPagesError`` (raised
  after the serviceable traffic drained), one that must wait is deferred.
* Bucketed chunked prefill: one forward per power-of-two prompt chunk
  (``prefill_bucket`` caps it), and same-bucket chunks of several
  admissions stack into one [rows, bucket] forward. ``prefill="stepwise"``
  keeps the token-at-a-time reference path.
* Attention (``attn_impl``): ``"kernel"`` routes prefill chunks AND decode
  through the CUDA paged-attention kernel; ``"gather"`` reads the pool
  through the dense gather (the reference route).
* Decode runs in spans between slot events; next-token ids stay on the
  device within a span and come to the host once, at its end.

Options of the reference that are not ported yet raise
``NotImplementedError`` naming their ROADMAP item.

  python -m repro_torch.launch.serve --arch qwen2-72b --smoke --device cpu \\
      --requests 8 --batch-size 4 --max-new 8 --page-size 16 --kv-bits 8
  python -m repro_torch.launch.serve --arch qwen2-72b --num-layers 8 \\
      --page-size 16 --kv-bits 8 --attn-impl kernel
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.registry import get_config, get_smoke_config
from ..core.fixedpoint import FixedPointFormat
from ..core.paged_kv import (SCRATCH_PAGE, OutOfPagesError, PageAllocator,
                             PagedCacheSpec, caches_kv_bytes,
                             max_pages_per_seq)
from ..core.policy import PrecisionPolicy
from ..models.attention import ATTN_IMPLS
from ..models.transformer import init_cache, init_model
from ..quant.apply import build_model_quant, transformer_layer_names
from ..runtime.telemetry import (MetricsRegistry, SLOMonitor, make_tracer,
                                 metric_attr)
from .steps import make_chunk_prefill_step, make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_step: Optional[int] = None  # SLO: finish by this decode step
    arrive_step: int = 0        # becomes visible to admission at this step
    error: Optional[Exception] = None    # set when admission rejects
    finish_step: Optional[int] = None    # decode-step clock at retirement


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n, clipped to cap (the max bucket)."""
    return min(cap, 1 << max(0, n - 1).bit_length())


@dataclasses.dataclass
class _PrefillJob:
    """One planned bucketed prefill (slot already reserved): feed
    ``req.prompt[start:-1]`` into the pool. ``done`` counts written tokens
    across the batched rounds; ``finished`` flips once the slot's clock and
    token are final."""

    slot: int
    req: Request
    start: int
    done: int = 0
    finished: bool = False

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


class BatchedServer:
    """Fixed-slot continuous batching with per-slot positions.

    Invariant per occupied slot i: cache positions [0, pos[i]) hold the KV
    of the request's consumed tokens and ``tokens[i]`` is the next token to
    consume. Free slots sit at pos 0 with their page-table row on the
    scratch page, so the shared decode step runs them harmlessly.

    ``model`` is a ``models.transformer.Transformer`` on ``device``; the
    pools are allocated there. ``prefill``: "auto"/"bucketed" = bucketed
    chunked prefill, "stepwise" = the token-at-a-time reference.
    ``prefill_batch`` caps how many same-bucket prompts stack into one
    prefill forward (0 = the batch size).
    """

    prefill_forwards = metric_attr("serve.prefill_forwards")
    prefill_tokens = metric_attr("serve.prefill_tokens")
    prefill_s = metric_attr("serve.prefill_s")
    decode_steps = metric_attr("serve.decode_steps")
    program_launches = metric_attr("serve.program_launches")
    cycles = metric_attr("serve.cycles")
    _gen_tokens = metric_attr("serve.gen_tokens")

    def __init__(self, cfg, model, *, batch_size: int, max_len: int,
                 kv_bits: int = 0, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 attn_impl: str = "gather", prefill: str = "auto",
                 prefill_bucket: int = 32, prefill_batch: int = 0,
                 kv_profile: Optional[PrecisionPolicy] = None,
                 kv_scale: str = "static", prefix_cache: str = "off",
                 kv_offload: str = "none", sched: str = "fifo",
                 kv_adapt: str = "off", fused: str = "off",
                 metrics: str = "off", tp: int = 1, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, server asked "
                             f"for {self.device}")
        if page_size <= 0:
            raise _not_ported("the dense KV cache (--page-size 0)", "6")
        if fused != "off":
            raise _not_ported("--fused on", "5")
        if prefix_cache != "off":
            raise _not_ported("--prefix-cache on", "8")
        if kv_scale != "static":
            raise _not_ported("--kv-scale page", "8")
        if kv_profile is not None:
            raise _not_ported("--kv-profile", "8")
        if kv_offload != "none":
            raise _not_ported("--kv-offload host", "9")
        if sched != "fifo":
            raise _not_ported("--sched slo", "9")
        if kv_adapt != "off":
            raise _not_ported("--kv-adapt on", "9")
        if tp != 1:
            raise _not_ported("tensor-parallel serving (--tp)", "13")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        if prefill not in ("auto", "bucketed", "stepwise"):
            raise ValueError(f"prefill must be auto|bucketed|stepwise, "
                             f"got {prefill!r}")
        if prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        if prefill_batch < 0:
            raise ValueError("prefill_batch must be >= 0 (0 = auto)")
        self.metrics = MetricsRegistry()
        self.tracer = make_tracer(metrics)
        self._clock = 0
        self.cfg = cfg
        self.model = model
        self.B = batch_size
        self.max_len = max_len
        self.attn_impl = attn_impl
        # the port serves only dense attention-only decoders, where the
        # bucketed path is output-equivalent to the stepwise reference
        self.prefill_mode = "stepwise" if prefill == "stepwise" \
            else "bucketed"
        self.prefill_bucket = prefill_bucket
        self.prefill_batch = prefill_batch
        self.slo_monitor = SLOMonitor(self.metrics)
        self.quant = None
        if kv_bits:
            container = "int4" if kv_bits <= 4 else "int8"
            pol = PrecisionPolicy.uniform(transformer_layer_names(cfg), None,
                                          FixedPointFormat(2, kv_bits - 2))
            self.quant = build_model_quant(pol, cfg, quantize_kv=True,
                                           quantize_activations=False,
                                           kv_container=container,
                                           kv_scale_mode=kv_scale)
        self.decode = make_decode_step(cfg, quant=self.quant,
                                       attn_impl=attn_impl)
        self._chunk_prefill = make_chunk_prefill_step(cfg, quant=self.quant,
                                                      attn_impl=attn_impl)

        self.np_max = max_pages_per_seq(max_len, page_size)
        if num_pages is None:
            num_pages = 1 + batch_size * self.np_max  # full capacity
        spec = PagedCacheSpec(page_size=page_size, num_pages=num_pages)
        self.allocator = PageAllocator(num_pages, metrics=self.metrics)
        self.page_size = page_size
        self.page_table = np.full((batch_size, self.np_max), SCRATCH_PAGE,
                                  np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_size)]
        self.slot_reserved = [0] * batch_size  # worst-case page demand
        self._pt_dev = _upload(self.page_table, self.device)
        self._pt_dirty = False
        self.caches = init_cache(cfg, self.quant, spec, self.device)
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
        self._gen_tokens = 0        # generated tokens (all run() calls)
        self.rejected: List[Request] = []
        reg = self.metrics.register_gauge
        reg("kv.device_bytes",
            lambda: sum(caches_kv_bytes(self.caches).values()))
        reg("kv.device_pages_free", lambda: self.allocator.num_free)
        reg("kv.device_pages_usable", lambda: self.allocator.num_usable)

    # -- page bookkeeping ---------------------------------------------------
    def _ensure_page(self, slot: int, position: int):
        """Allocate pages so logical ``position`` of ``slot`` is backed."""
        blk = position // self.page_size
        while len(self.slot_pages[slot]) <= blk:
            page = self.allocator.alloc()
            self.page_table[slot, len(self.slot_pages[slot])] = page
            self.slot_pages[slot].append(page)
            self._pt_dirty = True

    def _release_slot(self, slot: int):
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
        self.decode(self.model, _upload(self.tokens, self.device),
                    _upload(self.pos, self.device), self.caches,
                    self._page_table_dev())
        self.prefill_forwards += 1
        self.program_launches += 1

    def _prefill_slot(self, slot: int, req: Request):
        """Feed prompt[:-1] through shared decode steps, leaving the last
        prompt token in ``tokens`` for the decode loop. Other slots rewrite
        their current position with identical values."""
        t0 = time.perf_counter()
        self.pos[slot] = 0
        for t in req.prompt[:-1]:
            self._ensure_page(slot, int(self.pos[slot]))
            self.tokens[slot] = int(t)
            self._sync_step()
            self.pos[slot] += 1
        self.tokens[slot] = int(req.prompt[-1])
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += len(req.prompt)
        self.slot_gen[slot] = 0

    # -- batched bucketed prefill -------------------------------------------
    def _prefill_group_cap(self) -> int:
        return self.prefill_batch or self.B

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
        with self.tracer.span("prefill_chunk"):
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
        decode loop consumes."""
        self.pos[job.slot] = len(job.req.prompt) - 1
        self.tokens[job.slot] = int(job.req.prompt[-1])
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
            pending = []
            for job in jobs:
                self.prefill_tokens += len(job.req.prompt)
                if job.total == 0:
                    self._finish_job(job)   # 1-token prompt
                else:
                    pending.append(job)
            while pending:
                groups = {}
                for job in pending:
                    b = _pow2_bucket(job.total - job.done,
                                     self.prefill_bucket)
                    groups.setdefault(b, []).append(job)
                for bucket in sorted(groups):
                    grp = groups[bucket]
                    for k in range(0, len(grp), cap):
                        self._prefill_group(grp[k:k + cap], bucket)
                nxt = []
                for job in pending:
                    if job.done >= job.total:
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

    # -- admission ----------------------------------------------------------
    def _admission_plan(self, req: Request):
        """Preflight one request against the pool: ``(verdict, info)`` with
        verdict in {"admit", "defer", "reject"}. The worst-case demand is
        checked against the free list less outstanding reservations, so
        ``_ensure_page`` can never find the free list empty mid-run."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"request {req.rid} prompt length "
                             f"{len(req.prompt)} >= max_len {self.max_len}")
        total = self._pages_needed(req)
        avail = self.allocator.num_free - self._outstanding_reservation()
        if total <= avail:
            return "admit", {"total": total}
        if (total > self.allocator.num_usable
                or not any(s is not None for s in self.slots)):
            written = len(set().union(*map(set, self.slot_pages)))
            err = OutOfPagesError(
                needed=total, free=self.allocator.num_free,
                total=self.allocator.num_usable, rid=req.rid,
                reserved=self._outstanding_reservation(), written=written)
            return "reject", {"err": err}
        return "defer", {"total": total}

    def _do_admit(self, i: int, req: Request, info: dict,
                  jobs: List[_PrefillJob]):
        """Claim free slot ``i`` for ``req`` and stage its prefill: bucketed
        prefills are appended to ``jobs`` and run batched at the end of the
        admission cycle (or at once with ``prefill_batch=1``)."""
        self.tracer.req_admit(req.rid, self._clock)
        self.slot_reserved[i] = info["total"]
        self.slots[i] = req
        self.pos[i] = 0
        self.slot_gen[i] = 0
        if self.prefill_mode == "bucketed":
            job = _PrefillJob(i, req, 0)
            if self._prefill_group_cap() > 1:
                jobs.append(job)
            else:
                self._run_prefills([job])
        else:
            self._prefill_slot(i, req)

    def _reject(self, queue: List[Request], idx: int, err) -> None:
        """Drop a never-fit request from the queue; the error is recorded
        on the request and re-raised once the serviceable traffic drained."""
        req = queue.pop(idx)
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

    def _admit(self, queue: List[Request]):
        """One admission cycle: claim as many queued requests as slots and
        pages allow, then run their prefills batched."""
        if not queue:
            return
        self.metrics.histogram("sched.queue_depth").observe(len(queue))
        self.slo_monitor.note_queue_depth(len(queue))
        jobs: List[_PrefillJob] = []
        self._admit_fifo(queue, jobs)
        if jobs:
            self._run_prefills(jobs)

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
        self.slo_monitor.note_finish(req.rid, not missed, len(req.out))
        self.tracer.req_finish(req.rid, step, len(req.out))

    def start_loop(self, requests: List[Request]) -> "ServeLoop":
        return ServeLoop(self, requests)

    def run(self, requests: List[Request], *, verbose: bool = False):
        t0 = time.perf_counter()
        gen0 = self._gen_tokens
        steps0, pf0 = self.decode_steps, self.prefill_forwards
        rejected0 = len(self.rejected)
        loop = self.start_loop(requests)
        while loop.tick():
            pass
        dt = time.perf_counter() - t0
        if verbose:
            steps = self.decode_steps - steps0
            print(f"[serve] {steps} decode steps, "
                  f"{self.prefill_forwards - pf0} prefill forwards "
                  f"({self.prefill_mode}), {len(requests)} requests, "
                  f"{(self._gen_tokens - gen0) / max(dt, 1e-9):,.1f} tok/s "
                  f"(paged ps={self.page_size} "
                  f"free={self.allocator.num_free}, attn={self.attn_impl}, "
                  f"{self.program_launches} programs / {self.cycles} "
                  f"cycles, device={self.device})")
        new_rejects = self.rejected[rejected0:]
        if new_rejects:
            raise new_rejects[0].error
        return requests


class ServeLoop:
    """One in-flight :meth:`BatchedServer.run`, steppable one scheduler
    cycle at a time: arrivals (on the decode-step clock), admission, then
    one decode span. The frontend's ``limit_step`` clock cap is still to
    port (ROADMAP queue A item 13)."""

    def __init__(self, srv: BatchedServer, requests: List[Request]):
        self.srv = srv
        self.pending = sorted(requests, key=lambda r: r.arrive_step)
        self.queue: List[Request] = []
        self.clock = 0
        self.finished = False

    @property
    def live(self) -> bool:
        return any(s is not None for s in self.srv.slots)

    def tick(self) -> bool:
        """One scheduler cycle. Returns True while there is work left."""
        srv = self.srv
        pending, queue = self.pending, self.queue
        if not (pending or queue or self.live):
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
        live = [i for i in range(srv.B) if srv.slots[i] is not None]
        if not live:
            if pending:
                self.clock = max(clock, pending[0].arrive_step)
                return True
            self.finished = True
            return False
        span = srv._run_span()
        if pending:
            # cap the span at the next arrival so it gets admitted promptly
            span = max(1, min(span, pending[0].arrive_step - clock))
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
        with srv.tracer.span("decode_span"):
            for _ in range(span):
                for i in live:
                    srv._ensure_page(i, int(srv.pos[i]))
                nxt, _, srv.caches = srv.decode(
                    srv.model, tokens_dev, pos_dev, srv.caches,
                    srv._page_table_dev())
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
        return True


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
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (0 = dense cache, not ported)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared pool pages (0 = full capacity)")
    ap.add_argument("--attn-impl", choices=list(ATTN_IMPLS),
                    default="gather",
                    help="paged attention route: the dense gather reference "
                         "or the CUDA kernel (its plain version on CPU)")
    ap.add_argument("--prefill", choices=["auto", "bucketed", "stepwise"],
                    default="auto")
    ap.add_argument("--prefill-bucket", type=int, default=32)
    ap.add_argument("--prefill-batch", type=int, default=0)
    ap.add_argument("--fused", choices=["on", "off"], default="off")
    ap.add_argument("--kv-profile", default="")
    ap.add_argument("--kv-scale", choices=["static", "page"],
                    default="static")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="off")
    ap.add_argument("--kv-offload", choices=["none", "host"], default="none")
    ap.add_argument("--kv-adapt", choices=["off", "on"], default="off")
    ap.add_argument("--sched", choices=["fifo", "slo"], default="fifo")
    ap.add_argument("--metrics", choices=["off", "on"], default="off")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only archs have no decode path")
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
                        kv_offload=args.kv_offload, sched=args.sched,
                        kv_adapt=args.kv_adapt, fused=args.fused,
                        metrics=args.metrics, tp=args.tp, device=device)
    srv.run(reqs, verbose=True)
    for r in reqs[:4]:
        print(f"  req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
