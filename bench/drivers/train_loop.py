"""Training through the port's ``launch.steps.make_train_step``, fed
batches the benchmark makes from the seed.

Set-up (``setup_s``: process start to window start) builds one train
state (float32 masters holding the benchmark's weights, int8 AdamW
moments), the step with the configuration's fake-quant, and drives it
through its first ``setup_steps`` steps on the window's own call and
feed; those steps are the warm-up and the ones the reference follows:
their losses, each leaf's first gradient as the optimizer took it (from
the first moment after step 1) and each leaf's change after the last of
them are kept. The window then steps the same state until ``seconds``
have passed and ends at the device sync after its last step. A traced
run then profiles ``trace_steps`` more steps and times the optimizer with
CUDA events in ``adamw_steps`` steps after those. Then the
peak memory is read, the state freed, and the reference
(``reference/train.py``) runs the same steps on the same batches.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from .. import core, port
from ..reference import train as ref
from ..reference.weights import Dims, make_embed, make_head, make_layer
from ..trace import DeviceSlice, Phases
from ..traffic import generator


def _settings(spec) -> dict:
    s = dict(spec.config["train"])
    s.update(spec.overrides.get("train", {}))
    return s


def program_name(ref_name: str) -> str:
    """The port's parameter name of a reference leaf."""
    if not ref_name.startswith("layers."):
        return ref_name
    _, li, leaf = ref_name.split(".")
    if leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        return f"layers.{li}.attn.{leaf}"
    if leaf in ("w_gate", "w_up", "w_down"):
        return f"layers.{li}.mlp.{leaf}"
    return f"layers.{li}.{leaf}"


@torch.no_grad()
def _changes(model, dims: Dims, seed: int, dev) -> dict:
    """Each leaf's distance from its initial value, drawn again from the
    seed (reference names)."""
    params = dict(model.named_parameters())
    out = {}
    for li in range(dims.layers):
        for n, t0 in make_layer(dims, seed, li, torch.float32, dev).items():
            out[f"layers.{li}.{n}"] = float(torch.linalg.vector_norm(
                params[program_name(f"layers.{li}.{n}")] - t0))
    out["embed"] = float(torch.linalg.vector_norm(
        params["embed"] - make_embed(dims, seed, torch.float32, dev)))
    out["head"] = float(torch.linalg.vector_norm(
        params["head"] - make_head(dims, seed, torch.float32, dev)))
    out["final_norm"] = float(torch.linalg.vector_norm(
        params["final_norm"] - 1.0))
    return out


def _moment_norms(state, b1: float) -> dict:
    out = {}
    for name, mc in state["opt"]["m"].items():
        m = mc["q"].to(torch.float32) * mc["scale"]
        out[name] = float(torch.linalg.vector_norm(m)) / (1.0 - b1)
    return out


def lr_at(s: dict, step: int) -> float:
    """The configuration's schedule: linear warm-up over ``warmup_steps``
    to ``lr``, then constant (step counts from 0)."""
    return s["lr"] * min(1.0, (step + 1) / s["warmup_steps"])


def run(spec, *, seed: int, seconds: float, trace: bool, device: str):
    import repro_torch.launch.steps as steps_mod
    from repro_torch.launch.train import build_quant
    from repro_torch.optim.adamw import AdamWConfig
    t_proc = core.process_start_time()
    origin_perf = time.perf_counter() - (time.time() - t_proc)
    cell, s = spec.cell, _settings(spec)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dims = Dims.from_config(spec.config)
    mix = spec.mix
    cfg, model = port.build_model(spec.config, seed, dev, trainable=True)
    adam_cfg = AdamWConfig(quantize_moments=bool(s["int8_moments"]))
    hp = steps_mod.TrainHParams(lr=s["lr"], adamw=adam_cfg)
    quant = build_quant(cfg, weight_bits=s["weight_bits"],
                        data_bits=s["data_bits"], kv_bits=s["kv_bits"],
                        policy_json="")
    state = steps_mod.init_train_state(cfg, hp, model=model)
    step_fn = steps_mod.make_train_step(cfg, hp, quant=quant)

    def batch(i):
        return generator.train_batch(mix, seed=seed, step=i,
                                     vocab=dims.vocab, device=dev)

    n0 = int(cell["setup_steps"])
    losses, g1 = [], None
    for i in range(n0):
        state, m = step_fn(state, batch(i), lr=lr_at(s, i))
        losses.append(m["loss"])
        if i == 0:
            g1 = _moment_norms(state, adam_cfg.b1)
    losses = [float(x) for x in losses]
    change = _changes(state["params"], dims, seed, dev)
    phases = Phases(trace)
    if trace:
        orig = (steps_mod.loss_and_grads, steps_mod.adamw_update)
        steps_mod.loss_and_grads = phases.wrap("forward_backward", orig[0])
        steps_mod.adamw_update = phases.wrap("optimizer", orig[1])
    if cuda:
        torch.cuda.synchronize()
    w0 = time.perf_counter()
    i, ran = n0, 0
    while time.perf_counter() - w0 < seconds:
        state, _ = step_fn(state, batch(i), lr=lr_at(s, i))
        i += 1
        ran += 1
    if cuda:
        torch.cuda.synchronize()
    w1 = time.perf_counter()
    slice_ = None
    # the traced steps follow the window, on the same state and feed; a
    # slice in which the profiler recorded nothing is taken once more
    for _ in range(2 if trace else 0):
        slice_ = DeviceSlice(cuda)
        slice_.start()
        for _ in range(int(cell.get("trace_steps", 3))):
            t_b = time.perf_counter()
            b = batch(i)
            phases.add("batch", t_b)
            state, _ = step_fn(state, b, lr=lr_at(s, i))
            i += 1
        slice_.stop()
        if slice_.events or not cuda:
            break
    rows, seq = mix["rows"], mix["seq"]
    ctx = {"kind": "train", "window_s": w1 - w0,
           "setup_s": w0 - origin_perf, "train_steps": ran,
           "train_tokens": ran * rows * seq, "rows": rows, "seq": seq,
           "dims": dims, "attempted": ran, "failed": 0}
    if trace:
        steps_mod.loss_and_grads, steps_mod.adamw_update = orig
        if cuda:
            ctx.update(_time_adamw(steps_mod, step_fn, state, batch, s, i,
                                   int(cell.get("adamw_steps", 3))))
    device_blk = core.device_block(device)
    if slice_ is not None and slice_.busy_s:
        ctx.update(busy_s=slice_.busy_s, slice_s=slice_.window_s)
        device_blk.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
        ctx["breakdown"] = {"device_ops": slice_.top_ops(),
                            "idle_gaps": slice_.idle_by_phase(phases.spans)}
    ctx["device"] = device_blk
    del state, model, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    prog = {"losses": losses, "g1": g1, "change": change}
    ctx.update(_check(spec, dims, seed, s, prog, batch, n0, dev,
                      adam_cfg))
    return ctx


def _time_adamw(steps_mod, step_fn, state, batch, s, i0, n) -> dict:
    """``n`` steps, each begun after a device sync, with CUDA events around
    the whole step and around its ``adamw_update`` call."""
    orig = steps_mod.adamw_update
    marks = []

    def timed(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = orig(*a, **k)
        e1.record()
        marks.append((e0, e1))
        return out

    steps_mod.adamw_update = timed
    whole = []
    try:
        for j in range(n):
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            step_fn(state, batch(i0 + j), lr=lr_at(s, i0 + j))
            e1.record()
            whole.append((e0, e1))
        torch.cuda.synchronize()
    finally:
        steps_mod.adamw_update = orig
    return {"adamw_s": sum(a.elapsed_time(b) for a, b in marks) / 1e3,
            "adamw_step_s": sum(a.elapsed_time(b) for a, b in whole) / 1e3}


def leaf_gaps(prog: dict, refv: dict, grads: dict) -> tuple:
    """Worst leaf of |prog norm - ref norm| over the larger of the ref
    leaf's norm and the median leaf's, leaving out leaves whose reference
    gradient is under a thousandth of the median leaf's. Returns (gap,
    leaf, leaves left out)."""
    med_g = statistics.median(grads.values())
    keep = [n for n in refv if grads[n] >= 1e-3 * med_g]
    med = statistics.median(refv[n] for n in keep)
    worst, leaf = 0.0, None
    for n in keep:
        g = abs(prog[program_name(n)] - refv[n]) / max(refv[n], med)
        if g > worst:
            worst, leaf = g, n
    return worst, leaf, sorted(set(refv) - set(keep))


def compare(prog: dict, r: dict) -> dict:
    """The numbers compared: the worst step's loss gap over the
    reference's loss, and the worst leaf's first-gradient and change
    gaps (``leaf_gaps``)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       r["losses"]))
    prog_change = {program_name(n): v for n, v in prog["change"].items()}
    grad_gap, gleaf, out1 = leaf_gaps(prog["g1"], r["g1"], r["g1_raw"])
    change_gap, cleaf, _ = leaf_gaps(prog_change, r["change"], r["g1_raw"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": gleaf,
            "change_leaf": cleaf, "left_out": out1}


def _check(spec, dims, seed, s, prog, batch, n0, dev, adam_cfg) -> dict:
    limits = spec.cell["limits"]
    adam = {"b1": adam_cfg.b1, "b2": adam_cfg.b2, "eps": adam_cfg.eps,
            "wd": adam_cfg.weight_decay, "clip_norm": adam_cfg.grad_clip_norm}
    fmts = {"w_fmt": (2, s["weight_bits"] - 2),
            "a_fmt": (4, s["data_bits"] - 4)}
    batches = [batch(i) for i in range(n0)]
    lrs = [lr_at(s, i) for i in range(n0)]
    t0 = time.perf_counter()
    r = ref.train_reference(dims, seed, batches, lrs, adam=adam, device=dev,
                            **fmts)
    res = {"notes": {"reference_s": time.perf_counter() - t0,
                     "losses": prog["losses"], "ref_losses": r["losses"]}}
    got = compare(prog, r)
    res["notes"].update({k: got[k] for k in (
        "loss_gap", "grad_leaf", "change_leaf", "left_out")})
    for extra in spec.overrides.get("controls", ()):
        kw = ({"control": "fp8"} if extra == "fp8"
              else {"fault": extra})
        c = ref.train_reference(dims, seed, batches, lrs, adam=adam,
                                device=dev, **fmts, **kw)
        cg = compare({"losses": c["losses"], "g1": {
            program_name(n): v for n, v in c["g1"].items()},
            "change": c["change"]}, r)
        res[f"control_{extra}"] = {k: cg[k] for k in limits}
    checks = {k: {"value": got[k], "limit": float(limits[k]),
                  "ok": got[k] <= float(limits[k])} for k in limits}
    res.update(checks=checks, correct=all(c["ok"] for c in checks.values()))
    return res
