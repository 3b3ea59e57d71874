"""Rank functions for ``tests/test_torch_tp.py``, run on spawned gloo
ranks by ``launch.mesh.spawn_ranks`` (as the CLI's ``--tp``): they import
only torch, numpy and the port (no JAX), so each rank starts fast."""
from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def load_model(cfg, state_path):
    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, device=CPU)
    model.load_state_dict(torch.load(state_path))
    return model


def host_counters(srv) -> dict:
    """Every counter of the server's registry but the timers."""
    return {k: v for k, v in srv.metrics.snapshot()["counters"].items()
            if not k.endswith("_s")}


def serve_case(cfg, model, kw, requests, forced, *, mesh=None):
    """Serve ``requests`` ((rid, prompt, max_new) triples) teacher-forced
    by ``forced`` (rid -> tokens); returns (tokens, step logits, host
    counters, server)."""
    from repro_torch.benchmarks.lm_precision import DecodeTap
    from repro_torch.launch.serve import BatchedServer, Request
    srv = BatchedServer(cfg, model, mesh=mesh, device=CPU, **kw)
    tap = DecodeTap(srv, forced)
    srv.decode = tap
    reqs = srv.run([Request(rid, np.asarray(p, np.int32), m)
                    for rid, p, m in requests])
    logits = {k: v.numpy().copy() for k, v in tap.logits.items()}
    return ([list(r.out) for r in reqs], logits, host_counters(srv), srv)


def serve_tp(rank, cfg, state_path, cases, requests, forced):
    """Every case at tp = 2: rank 0's tokens and step logits, each rank's
    counters, its page scales and its pools' local shapes; plus a per-shard
    host round trip and the shared store's namespaces."""
    from repro_torch.core.page_store import (HostPageStore, extract_page,
                                             inject_page)
    from repro_torch.launch.frontend import SharedPrefixStore
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import BatchedServer
    model = load_model(cfg, state_path)
    mesh = make_serving_mesh(2, device="cpu")
    out = {}
    for name, kw in cases.items():
        toks, logits, counters, srv = serve_case(cfg, model, kw, requests,
                                                 forced[name], mesh=mesh)
        scales = [np.concatenate([layer["k_scale"].numpy(),
                                  layer["v_scale"].numpy()])
                  for layer in srv.caches]
        res = {"tokens": toks, "counters": counters, "scales": scales,
               "pool": tuple(srv.caches[0]["k_pages"].shape),
               "weights": {n: tuple(p.shape) for n, p
                           in srv.model.named_parameters()}}
        if rank == 0:
            res["logits"] = logits
        # a page's local shard through the host tier and back, byte for byte
        src, dst = 1, srv.allocator.num_usable
        blob = extract_page(srv.caches, src)
        host = HostPageStore()
        inject_page(srv.caches, host.pop(host.put(blob)), dst)
        res["round_trip"] = all(
            torch.equal(layer[k][src], layer[k][dst])
            for layer in srv.caches for k in layer)
        res["blob_heads"] = blob.arrays[0]["k"].shape
        if name == "kv8-page-kernel":
            one = BatchedServer(cfg, model, device=CPU, **kw)
            res["namespaces_differ"] = (
                SharedPrefixStore()._namespace(srv)
                != SharedPrefixStore()._namespace(one))
            store = SharedPrefixStore()
            res["published"] = store.publish(srv)
            res["installed_into_tp1"] = store.install(one)
        out[name] = res
    return out


def traps(rank):
    """The parity traps on 2 ranks: a page-scale write over each rank's
    KV-head shard against the whole write, the argmax over vocab shards
    with ties, and a wall-clock input to the scheduler that differs
    between ranks; plus the host and test meshes over the group."""
    from functools import partial

    from repro_torch.core.paged_kv import (PagedKVLayout, init_paged_pool,
                                           paged_update)
    from repro_torch.launch.mesh import (make_host_mesh, make_serving_mesh,
                                         make_test_mesh)
    from repro_torch.parallel.hints import (activation_hints, gather_cols,
                                            pool_max)
    from repro_torch.parallel.sharding import plan_for_mesh
    mesh = make_serving_mesh(2, device="cpu")
    plan = plan_for_mesh(mesh)
    out = {"meshes": {}}
    for name, build in (("host", lambda: make_host_mesh(device="cpu")),
                        ("test", lambda: make_test_mesh((1, 2))),
                        ("test_default", make_test_mesh)):
        try:
            m = build()
            out["meshes"][name] = (tuple(m.shape), tuple(m.mesh_dim_names))
        except ValueError as e:
            out["meshes"][name] = str(e)
    gen = torch.Generator().manual_seed(0)
    KV, hd, ps, NP = 4, 16, 8, 6
    lo, hi = rank * KV // 2, (rank + 1) * KV // 2
    for container, bits in (("int8", 8), ("int4", 4)):
        whole = init_paged_pool(PagedKVLayout(NP, ps, KV, hd, container),
                                CPU)
        local = init_paged_pool(PagedKVLayout(NP, ps, KV // 2, hd,
                                              container), CPU)
        alone = init_paged_pool(PagedKVLayout(NP, ps, KV // 2, hd,
                                              container), CPU)
        local["k_pages"].tp_dim = local["v_pages"].tp_dim = 2
        pt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
        for pos, S in ((0, 5), (5, 6)):        # the second raises scales
            k = torch.randn(2, S, KV, hd, generator=gen) * (1 + pos)
            v = torch.randn(2, S, KV, hd, generator=gen) * (1 + pos)
            # rank 1's first head holds the largest values: rank 0's
            # shard alone would scale its pages lower
            k[:, :, KV // 2] *= 3.0
            p = torch.full((2,), pos, dtype=torch.int64)
            kw = dict(page_size=ps, container=container, int_bits=2,
                      frac_bits=bits - 2, scale_mode="page")
            paged_update(whole, k, v, pt, p, **kw)
            with activation_hints(plan):
                paged_update(local, k[:, :, lo:hi], v[:, :, lo:hi], pt, p,
                             amax_reduce=partial(pool_max,
                                                 pages=local["k_pages"]),
                             **kw)
            paged_update(alone, k[:, :, lo:hi], v[:, :, lo:hi], pt, p, **kw)
        out[container] = {
            "scales_equal": all(torch.equal(local[s], whole[s])
                                for s in ("k_scale", "v_scale")),
            "pages_equal": all(torch.equal(local[s], whole[s][:, :, lo:hi])
                               for s in ("k_pages", "v_pages")),
            "alone_scales_equal": torch.equal(alone["k_scale"],
                                              whole["k_scale"])}
    # argmax over vocab shards: ties across and within the shards
    V = 16
    full = torch.zeros(3, V)
    full[0, [3, 11]] = 5.0        # a tie across shards: index 3 wins
    full[1, [9, 12]] = 4.0        # a tie inside shard 1: index 9
    full[2, 13] = 2.0
    w = torch.zeros(2, V // 2)
    w.tp_dim = 1
    mine = full[:, rank * V // 2:(rank + 1) * V // 2].clone()
    with activation_hints(plan):
        got = gather_cols(mine, w)
    out["argmax"] = torch.argmax(got, dim=-1).tolist()
    out["want"] = torch.argmax(full, dim=-1).tolist()
    out["shard_argmax"] = (torch.argmax(mine, dim=-1) + rank * V // 2).tolist()
    # a pool not marked as a KV-head shard under a plan: its scales would
    # part between ranks, so the reduction refuses it
    with activation_hints(plan):
        try:
            pool_max(torch.ones(2, 3), alone["k_pages"])
            out["unmarked"] = None
        except RuntimeError as e:
            out["unmarked"] = str(e)
    out["predictor"] = predictor_case(rank, mesh)
    return out


def predictor_case(rank, mesh):
    """The deadline-miss predictor under ``mesh``, with each rank's wall
    clock reading a different TPOT slowdown (rank 0: -0.2, rank 1: 0.2):
    the features each rank consulted, its tokens and its counters; rank 0
    also serves at tp = 1 with rank 0's reading."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("qwen2-72b")
    model = init_model(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(5)
    kw = dict(batch_size=2, max_len=48, page_size=8, kv_bits=8,
              prefix_cache="on", sched="slo", predictor="on", device=CPU)

    def run(srv, reading):
        srv.slo_monitor.tpot_slowdown = lambda: reading
        seen, consult = [], srv.predictor.consult
        srv.predictor.consult = lambda x: (seen.append(list(x)),
                                           consult(x))[1]
        reqs = [Request(i, rng_prompts[i], 4 + i % 3,
                        deadline_step=(8 + i if i % 2 else None),
                        arrive_step=i // 2) for i in range(6)]
        done = srv.run(reqs)
        return {"features": seen, "tokens": [list(r.out) for r in done],
                "counters": host_counters(srv)}

    rng_prompts = [rng.integers(0, cfg.vocab_size, 5 + i).astype(np.int32)
                   for i in range(6)]
    out = {"tp2": run(BatchedServer(cfg, model, mesh=mesh, **kw),
                      0.2 if rank else -0.2)}
    if rank == 0:
        out["tp1"] = run(BatchedServer(cfg, model, **kw), -0.2)
    return out


def page_scales(srv) -> list:
    """Each paged layer's k and v page scales, one array a layer."""
    return [np.concatenate([layer["k_scale"].numpy(),
                            layer["v_scale"].numpy()])
            for layer in srv.caches if "k_scale" in layer]


def pool_layout(srv) -> list:
    """Each cache leaf's local shape and its mark (``tp_dim``, or None),
    one dict a layer."""
    return [{k: (tuple(t.shape), getattr(t, "tp_dim", None))
             for k, t in layer.items()} for layer in srv.caches]


def serve_families(rank, tp, cases, embeds=None):
    """Every case on a (1, ``tp``) serving mesh. ``cases``: {name: {"cfg",
    "path" (the model's state dict), "kw", "requests", "forced", and
    optionally "alone" (rid -> forced tokens: each request served alone
    on a batch-1 server, as the reference's alone runs)}}. Returns each
    case's tokens, host counters, page scales and cache layout, the step
    logits (rank 0), and the alone runs' step logits (rank 0). With
    ``embeds`` ({"cfg", "path", "embeds", "mrope", "steps", "max_len"}),
    also the embeds prefill and the embed decode steps under the plan:
    their logits and the dense caches' local shapes."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import shard_model
    from repro_torch.launch.steps import (make_embed_decode_step,
                                          make_prefill_step)
    from repro_torch.parallel.hints import activation_hints
    from repro_torch.parallel.sharding import plan_for_mesh
    mesh = make_serving_mesh(tp, device="cpu")
    models = {}

    def model_of(c):
        if c["path"] not in models:
            models[c["path"]] = load_model(c["cfg"], c["path"])
        return models[c["path"]]

    out = {}
    for name, c in cases.items():
        cfg, model = c["cfg"], model_of(c)
        toks, logits, counters, srv = serve_case(
            cfg, model, c["kw"], c["requests"], c["forced"], mesh=mesh)
        res = {"tokens": toks, "counters": counters,
               "scales": page_scales(srv), "layout": pool_layout(srv),
               "weights": {n: tuple(p.shape) for n, p
                           in srv.model.named_parameters()}}
        if rank == 0:
            res["logits"] = logits
        if c.get("alone"):
            kw = dict(c["kw"], batch_size=1)
            toks, logits, _, _ = serve_case(cfg, model, kw, c["requests"],
                                            c["alone"], mesh=mesh)
            res["alone_tokens"] = toks
            if rank == 0:
                res["alone_logits"] = logits
        out[name] = res
    if embeds is not None:
        cfg, model = embeds["cfg"], model_of(embeds)
        local = shard_model(model, cfg, plan_for_mesh(mesh))
        prefill = make_prefill_step(cfg, max_len=embeds["max_len"])
        dec = make_embed_decode_step(cfg)
        emb = torch.from_numpy(embeds["embeds"])
        S = embeds["mrope"].shape[1]
        with activation_hints(plan_for_mesh(mesh)):
            last, caches = prefill(local, None, embeds=emb[:, :S],
                                   mrope_positions=torch.from_numpy(
                                       embeds["mrope"]))
            got = [last.numpy().copy()]
            for i in range(embeds["steps"]):
                _, lg, caches = dec(local, emb[:, S + i:S + i + 1], S + i,
                                    caches)
                got.append(lg.numpy().copy())
        out["embeds"] = {"logits": got,
                         "caches": [tuple(c["k"].shape) for c in caches]}
    return out
