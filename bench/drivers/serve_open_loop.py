"""Open-loop serving of a shared-document mix through the port's
``BatchedServer``, stepped as ``launch/frontend.py`` steps it
(``ServeLoop.add``, ``ServeLoop.tick(limit_step=)``), on the wall clock.

Set-up (``setup_s``: process start to window start): the program's
kernels (cached in the checkout), the weights drawn on the card, the
server with its int8 pool of ``num_pages`` pages, every document
prefilled into the prefix cache, then a ramp of the same open-loop
traffic until the live rows settle. The window: before each scheduler cycle every
request whose due time has passed is delivered; a decode span is capped
at ``span_cap`` steps so an arrival waits a few steps at most; idle, the
loop sleeps until the next due time. A request's clock starts at its due
time; its tokens are stamped when ``tick`` returns, after the span's
token copy to the host (a device sync). After the window the loop goes
on, arrivals included, until every request due in the window has its
first token (or ``follow_s`` passes); a traced run profiles a slice of
``trace_s`` seconds from the window's close, under the same load (the
arrivals' clock stands still while the profiler starts), so the window
itself carries no profiler, and counts the model FLOPs of the tokens
served in it. Then the peak memory is read, the program freed,
and a sample of the finished requests, from two documents, is held
against the plain reference (``reference/decoder.py``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import List

import numpy as np
import torch

from .. import core, port
from ..counts import decoder as counts
from ..counts import paged_attention as b1counts
from ..reference import decoder as ref
from ..reference.weights import Dims
from ..trace import DeviceSlice, Phases
from ..traffic import generator

DOC_RID = 10 ** 9          # request ids of the document warm-up
B1_KERNELS = ("paged_attn", "merge_partials")
WORK = ("decode_tokens", "decode_keys", "prefill_tokens", "prefill_keys")


class Rec:
    """One request of the stream and what the host saw of it."""

    __slots__ = ("r", "due", "prompt_len", "doc_len", "req", "n", "stamps",
                 "first_t", "done_t", "admit_t", "failed")

    def __init__(self, r, prompt_len: int, doc_len: int):
        self.r, self.due = r, r.due_s
        self.prompt_len, self.doc_len = prompt_len, doc_len
        self.req = None
        self.n = 0
        self.stamps: List[tuple] = []       # (time, tokens new)
        self.first_t = self.done_t = self.admit_t = None
        self.failed = False


def _settings(spec) -> dict:
    s = dict(spec.config["serve"])
    s.update(spec.cell.get("serve", {}))
    s.update(spec.overrides.get("serve", {}))
    return s


class B1Recorder:
    """Records the arguments of each paged-attention call the model makes
    through ``models.attention``'s two entry points, inside its ``with``;
    a decode call's query start is its length less one."""

    def __init__(self):
        import repro_torch.models.attention as attn
        self.attn = attn
        self.calls: list = []
        self.orig = (attn.paged_kv_attention_chunk,
                     attn.paged_kv_attention_decode)

    def __enter__(self):
        chunk, decode = self.orig

        def rec_chunk(q, kp, vp, ks, vs, pt, q_start, kv_len, *, bits=8,
                      **kw):
            self.calls.append((tuple(q.shape), q.element_size(),
                               tuple(kp.shape), bits, pt, q_start, kv_len))
            return chunk(q, kp, vp, ks, vs, pt, q_start, kv_len, bits=bits,
                         **kw)

        def rec_decode(q, kp, vp, ks, vs, pt, kv_len, *, bits=8):
            B, H, hd = q.shape
            self.calls.append(((B, 1, H, hd), q.element_size(),
                               tuple(kp.shape), bits, pt, None, kv_len))
            return decode(q, kp, vp, ks, vs, pt, kv_len, bits=bits)

        self.attn.paged_kv_attention_chunk = rec_chunk
        self.attn.paged_kv_attention_decode = rec_decode
        return self

    def __exit__(self, *exc):
        (self.attn.paged_kv_attention_chunk,
         self.attn.paged_kv_attention_decode) = self.orig

    def costs(self, page_size: int) -> tuple:
        """Summed (FLOPs, bytes) of the recorded calls (the layers of one
        step share a page table and lengths: counted once, used for
        each)."""
        host = lambda x: (x.cpu().numpy() if torch.is_tensor(x)
                          else np.asarray(x))
        fl = by = 0.0
        seen = {}
        for shape, qsz, kshape, bits, pt, qs, kl in self.calls:
            B, S, H, hd = shape
            kl = host(kl)
            qs = kl - 1 if qs is None else host(qs)
            key = (id(pt), shape, qsz, kshape, bits, kl.tobytes(),
                   np.asarray(qs).tobytes())
            if key not in seen:
                seen[key] = b1counts.call_cost(
                    B=B, S=S, H=H, hd=hd, q_itemsize=qsz,
                    kv_heads=kshape[2], page_size=page_size, bits=bits,
                    page_table=host(pt), q_start=qs, kv_len=kl)
            fl += seen[key][0]
            by += seen[key][1]
        return fl, by


def _counters(srv) -> dict:
    return {"decode_steps": srv.decode_steps, "gen_tokens": srv._gen_tokens,
            "prefill_tokens": srv.prefill_tokens,
            "prefix_hit_tokens": srv.prefix_hit_tokens,
            "prefill_forwards": srv.prefill_forwards}


def setup(spec, seed: int, device: str):
    """The program's side of a run up to its traffic: kernels, weights,
    the server with its pool, and every document of the stream's mix in
    the prefix cache. Returns (settings, dims, server, pages, stream
    maker)."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import BatchedServer, Request
    s = _settings(spec)
    dev = torch.device(device)
    if dev.type == "cuda":
        build.build_all(["paged_kv_attention"])
        build.load("paged_kv_attention")
    dims = Dims.from_config(spec.config)
    cfg, model = port.build_model(spec.config, seed, dev)

    def stream_at(rate: float, n: int):
        return generator.shared_documents(spec.mix, seed=seed, rate=rate,
                                          n=n, vocab=dims.vocab)

    docs = stream_at(1.0, 1).docs
    pages = int(s["num_pages"])
    # "program" overrides reach the server only (a control run of the
    # program's own lower-precision path); the reference keeps ``s``
    p = dict(s, **spec.overrides.get("program", {}))
    srv = BatchedServer(
        cfg, model, batch_size=p["slots"],
        max_len=generator.max_prompt_tokens(spec.mix) + 1,
        kv_bits=p["kv_bits"], page_size=p["page_size"], num_pages=pages,
        attn_impl=p["attn_impl"], prefill="bucketed",
        prefill_bucket=p["prefill_bucket"], prefix_cache="on", device=dev)
    # every document into the prefix cache (one decode step each)
    srv.run([Request(rid=DOC_RID + d, prompt=doc.astype(np.int32),
                     max_new=1) for d, doc in enumerate(docs)])
    return s, dims, srv, pages, stream_at


class OpenLoop:
    """One stream driven through a server's ``ServeLoop`` on the wall
    clock: ``drive`` delivers, ticks and stamps until the window and the
    follow-up end. ``backlog`` keeps (time, requests queued) per tick."""

    def __init__(self, srv, stream, *, cap: int, phases: Phases,
                 pages: int):
        self.srv, self.stream, self.cap, self.phases = srv, stream, cap, \
            phases
        self.pages = pages
        self.loop = srv.start_loop([])
        self.recs = [Rec(r, len(stream.docs[r.doc]) + len(r.question),
                         len(stream.docs[r.doc])) for r in stream.requests]
        self.backlog: list = []
        # the model work of the tokens served while the traced slice runs
        self.work = dict.fromkeys(WORK, 0)
        self.w0 = self.w1 = None
        self.snap0 = self.snap1 = self.held = None
        self.slice_ = self.recorder = None
        self.start_stall = 0.0
        self.retries = 1

    def _deliver(self, t: float, nxt: int, active: list) -> int:
        from repro_torch.launch.serve import Request
        recs, loop = self.recs, self.loop
        while nxt < len(recs) and recs[nxt].due <= t:
            rec = recs[nxt]
            rec.req = Request(rid=rec.r.rid, prompt=self.stream.prompt(
                rec.r).astype(np.int32), max_new=rec.r.max_new,
                arrive_step=loop.clock)
            loop.add(rec.req)
            active.append(rec)
            nxt += 1
        return nxt

    def _stamp(self, tb: float, active: list, in_slice: bool) -> list:
        live_ids = {id(q) for q in self.srv.slots if q is not None}
        keep = []
        for rec in active:
            req = rec.req
            if rec.admit_t is None and (id(req) in live_ids or req.out
                                        or req.done):
                rec.admit_t = tb
                if in_slice and req.error is None:
                    h = rec.doc_len - 1
                    self.work["prefill_tokens"] += rec.prompt_len - 1 - h
                    self.work["prefill_keys"] += (
                        counts.causal_keys(rec.prompt_len - 1)
                        - counts.causal_keys(h))
            k = len(req.out)
            if k > rec.n:
                if rec.first_t is None:
                    rec.first_t = tb
                rec.stamps.append((tb, k - rec.n))
                if in_slice:
                    self.work["decode_tokens"] += k - rec.n
                    self.work["decode_keys"] += (
                        (k - rec.n) * (rec.prompt_len - 1)
                        + counts.causal_keys(k) - counts.causal_keys(rec.n))
                rec.n = k
            if req.done:
                rec.done_t = tb
                rec.failed = req.error is not None
            else:
                keep.append(rec)
        return keep

    def _close_window(self, tb: float) -> None:
        srv = self.srv
        self.w1, self.snap1 = tb, _counters(srv)
        inv = srv.kv_inventory()
        in_use = inv["device_pages_usable"] - inv["device_pages_free"]
        self.held = {"bytes": in_use * inv["device_bytes"] / self.pages,
                     "tokens": int(sum(int(srv.pos[i]) for i in range(srv.B)
                                       if srv.slots[i] is not None))}

    def drive(self, *, ramp: float, seconds: float, follow: float,
              slice_s: float = 0.0, cuda: bool = True,
              arrivals: bool = True) -> None:
        """Ramp, window and follow-up (and, with ``slice_s``, a traced
        slice of that many seconds from the window's close, under the same
        load). ``arrivals`` False delivers nothing more (a drain)."""
        loop, recs, phases = self.loop, self.recs, self.phases
        nxt = 0 if arrivals else len(recs)
        active: list = []
        t_origin = self.t_origin = time.perf_counter()
        while True:
            nxt = self._deliver(time.perf_counter() - t_origin, nxt, active)
            if not (loop.pending or loop.queue or loop.live):
                if nxt >= len(recs) or self._done(follow, slice_s, None):
                    break
                pause = recs[nxt].due - (time.perf_counter() - t_origin)
                if pause > 0:
                    t_s = time.perf_counter()
                    time.sleep(pause)
                    phases.add("idle_wait", t_s)
                continue
            t_tick = time.perf_counter()
            loop.tick(limit_step=loop.clock + self.cap)
            tb = time.perf_counter() - t_origin
            phases.add("tick_other", t_tick)
            in_win = self.w0 is not None and self.w1 is None
            # a tick's work falls in the slice when the slice was running
            # before the tick began (ticks end on a device sync)
            active = self._stamp(tb, active, self.slice_ is not None
                                 and self.slice_.t1 is None)
            self.backlog.append((tb, len(loop.queue)))
            if self.w0 is None and tb >= ramp:
                self.w0, self.snap0 = tb, _counters(self.srv)
            elif in_win and tb >= self.w0 + seconds:
                self._close_window(tb)
            if slice_s and self.w1 is not None:
                if self.slice_ is None:
                    t_s = time.perf_counter()
                    self.slice_ = DeviceSlice(cuda)
                    self.recorder = B1Recorder().__enter__()
                    self.slice_.start()
                    # the profiler's start holds the host for seconds: the
                    # arrivals' clock stops with it, so the slice opens on
                    # the window's load and not on the backlog of the stall
                    stall = time.perf_counter() - t_s
                    self.start_stall += stall
                    t_origin += stall
                elif self.slice_.t1 is None and \
                        time.perf_counter() >= self.slice_.t0 + slice_s:
                    self._stop_slice()
            if self._done(follow, slice_s, tb):
                break
        if self.slice_ is not None and self.slice_.t1 is None:
            self._stop_slice()
        loop.close()

    def _stop_slice(self) -> None:
        self.slice_.stop()
        self.recorder.__exit__()
        if self.slice_.cuda and not self.slice_.events and self.retries:
            # the profiler now and then records no device activity at all
            # (seen once in twelve traced runs): take the slice again
            self.retries -= 1
            self.slice_ = self.recorder = None
            self.work = dict.fromkeys(WORK, 0)

    def _done(self, follow: float, slice_s: float, tb) -> bool:
        if self.w1 is None:
            return False
        if tb is not None and tb > self.w1 + follow:
            return True
        sliced = not slice_s or (self.slice_ is not None
                                 and self.slice_.t1 is not None)
        return sliced and _followed(self.recs, self.w0, self.w1)


def run(spec, *, seed: int, seconds: float, trace: bool, device: str):
    t_proc = core.process_start_time()
    origin_perf = time.perf_counter() - (time.time() - t_proc)
    cell = spec.cell
    cuda = torch.device(device).type == "cuda"
    s, dims, srv, pages, stream_at = setup(spec, seed, device)
    t_setup = time.perf_counter() - origin_perf
    rate = float(spec.overrides.get("rate_rps", cell["rate_rps"]))
    ramp, follow = float(cell["ramp_s"]), float(cell["follow_s"])
    stream = stream_at(rate, int(math.ceil(rate * (ramp + seconds
                                                   + follow))) + 8)
    phases = Phases(trace)
    if trace:
        srv.decode = phases.wrap("decode_launch", srv.decode)
        srv._chunk_prefill = phases.wrap("prefill_launch", srv._chunk_prefill)
    ol = OpenLoop(srv, stream, cap=int(s["span_cap"]), phases=phases,
                  pages=pages)
    ol.drive(ramp=ramp, seconds=seconds, follow=follow, cuda=cuda,
             slice_s=min(float(cell.get("trace_s", 3.0)), seconds / 3)
             if trace else 0.0)
    w0, w1 = ol.w0, ol.w1
    t_drive = time.perf_counter()
    device_blk = core.device_block(device)
    ctx = _window_ctx(ol.recs, w0, w1, ol.snap0, ol.snap1, dims)
    ctx.update(window_s=w1 - w0, setup_s=(ol.t_origin + w0) - origin_perf,
               follow_ms=(seconds + follow) * 1e3,
               dims=dims, held=ol.held,
               device=device_blk)
    notes = {"setup_before_ramp_s": t_setup, "ramp_s": ramp,
             "after_window_s": t_drive - ol.t_origin - w1,
             "requests_due": ctx["attempted"],
             "backlog_at_window": [q for t, q in ol.backlog
                                   if t >= w0][:1] + [q for t, q in
                                                      ol.backlog
                                                      if t <= w1][-1:]}
    sl = ol.slice_
    if sl is not None:
        b1_time = sum(v for k, v in sl.by_name.items()
                      if any(x in k for x in B1_KERNELS))
        fl, by = ol.recorder.costs(s["page_size"])
        ctx.update(busy_s=sl.busy_s, slice_s=sl.window_s,
                   slice_work=ol.work, b1_device_s=b1_time, b1_flops=fl,
                   b1_bytes=by, b1_calls=len(ol.recorder.calls))
        device_blk.update(busy_s=sl.busy_s, window_s=sl.window_s)
        ctx["breakdown"] = {"device_ops": sl.top_ops(),
                            "idle_gaps": sl.idle_by_phase(phases.spans)}
        notes["trace_read_s"] = time.perf_counter() - t_drive
        notes.update(profiler_start_s=ol.start_stall,
                     trace_events=len(sl.events), trace_markers=sl.markers)
    sample = _sample(ol.recs, w1, seed, s)
    del ol, srv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.update(_check(spec, dims, stream, sample, seed,
                      torch.device(device), s))
    notes["reference_s"] = ctx.pop("ref_s")
    ctx["notes"] = notes
    return ctx


def _followed(recs, w0, w1) -> bool:
    return all(r.req is not None and (r.first_t is not None
                                      or r.done_t is not None)
               for r in recs if w0 <= r.due < w1)


def _window_ctx(recs, w0, w1, snap0, snap1, dims) -> dict:
    due = [r for r in recs if w0 <= r.due < w1]
    ttft, tpot = [], []
    failed = 0
    tokens = 0
    for r in recs:
        tokens += sum(k for t, k in r.stamps if w0 < t <= w1)
    for r in due:
        if r.failed or r.first_t is None:
            failed += 1
            ttft.append(None)
        else:
            ttft.append((r.first_t - r.due) * 1e3)
    for r in recs:
        st = [(t, k) for t, k in r.stamps if w0 < t <= w1]
        n = sum(k for _, k in st)
        if n >= 2:
            # the first window token's stamp to the last one's, over the
            # gaps between them (tokens stamped together are 0 apart)
            tpot.append((st[-1][0] - st[0][0]) * 1e3 / (n - 1)
                        if len(st) > 1 else 0.0)
    delta = {k: snap1[k] - snap0[k] for k in snap0}
    return {"attempted": len(due), "failed": failed, "ttft_ms": ttft,
            "tpot_ms": tpot, "window_tokens": tokens, "counters": delta}


def _sample(recs, w1, seed, s) -> list:
    """Finished requests to check, from two documents: that of the request
    with the most served tokens, and one drawn from the seed among the
    others; each document's requests in an order drawn from the seed (the
    longest request first), taken from the two in turn until
    ``sample_tokens`` served tokens or ``sample_max`` requests. The
    requests finished in the window, or where they hold fewer tokens than
    that (a loaded CPU in tests), every one finished by the loop's close.
    Returns (document, question, served tokens) triples."""
    done = [r for r in recs if r.done_t is not None and not r.failed
            and r.req is not None and len(r.req.out) > 0]
    win = [r for r in done if r.done_t <= w1]
    if sum(len(r.req.out) for r in win) < s["sample_tokens"]:
        win = done
    if not win:
        return []
    rng = np.random.default_rng([seed, 1])
    top = max(win, key=lambda r: (len(r.req.out), -r.r.rid))
    others = sorted({r.r.doc for r in win} - {top.r.doc})
    docs = [top.r.doc] + ([others[int(rng.integers(len(others)))]]
                          if others else [])
    queues = []
    for d in docs:
        rest = [r for r in win if r.r.doc == d and r is not top]
        queues.append([rest[i] for i in rng.permutation(len(rest))])
    queues[0].insert(0, top)
    out, tok = [], 0
    while any(queues):
        for q in queues:
            if not q:
                continue
            if tok >= s["sample_tokens"] or len(out) >= s["sample_max"]:
                return out
            r = q.pop(0)
            out.append((r.r.doc, r.r.question, list(r.req.out)))
            tok += len(r.req.out)
    return out


def _gaps(logits, tokens) -> torch.Tensor:
    """Per position, how far the reference's logit of ``tokens`` lies below
    its best (0 where the token is the reference's first choice)."""
    t = torch.as_tensor(tokens, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]


def _check(spec, dims, stream, sample, seed, dev, s) -> dict:
    """The gaps by which served tokens' reference logits lie below the
    reference's best over the sample: the widest (a token altered, or a
    path far off) and the mean over every sampled token (a path that is
    off a little everywhere: weights or KV a precision step too low). With
    a control asked for, the same numbers for the token that the
    reference with float8 weights puts first at each position."""
    limits = {k: float(v) for k, v in s["limits"].items()}
    if not sample:
        return {"correct": False, "checks": {k: {
            "value": None, "limit": v, "ok": False}
            for k, v in limits.items()}}
    groups, order = [], []
    for doc in dict.fromkeys(d for d, _, _ in sample):
        items = [(q, out) for d, q, out in sample if d == doc]
        order += items
        groups.append((stream.docs[doc], [
            (np.concatenate([q, np.asarray(out[:-1], np.int64)]), len(q) - 1)
            for q, out in items]))
    kv_fmt = (2, s["kv_bits"] - 2)
    dt = port.served_dtype(spec.config)
    t0 = time.perf_counter()
    logits = [L for g in ref.group_logits(dims, seed, groups, device=dev,
                                          served_dtype=dt, kv_fmt=kv_fmt)
              for L in g]
    gaps = torch.cat([_gaps(L, out) for L, (_, out) in zip(logits, order)])
    got = {"logit_gap": float(gaps.max()),
           "mean_logit_gap": float(gaps.mean())}
    res = {"ref_s": time.perf_counter() - t0,
           "sample": {"docs": len(groups), "tokens": [len(o) for _, o in
                                                       order],
                      "off_first_choice": float((gaps > 0).float().mean())}}
    if spec.overrides.get("control"):
        cl = [C for g in ref.group_logits(dims, seed, groups, device=dev,
                                          served_dtype=dt, kv_fmt=kv_fmt,
                                          weight_map=ref.fp8_columns)
              for C in g]
        cg = torch.cat([_gaps(L, C.argmax(dim=-1))
                        for L, C in zip(logits, cl)])
        res.update(control_logit_gap=float(cg.max()),
                   control_mean_logit_gap=float(cg.mean()),
                   control_off_first_choice=float((cg > 0).float().mean()))
    checks = {k: {"value": got[k], "limit": v, "ok": got[k] <= v}
              for k, v in limits.items()}
    res.update(correct=all(c["ok"] for c in checks.values()), checks=checks)
    return res
