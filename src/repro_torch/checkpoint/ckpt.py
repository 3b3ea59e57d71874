"""Atomic, async checkpoints on the reference's on-disk layout
(``checkpoint/ckpt.py``)::

    <dir>/step_000000420/
        arrays.npz          # flattened key -> full ndarray
        manifest.json       # step, keys, extra state, quantized leaves
        COMMIT              # written LAST: the completeness marker

* Keys are the reference's tree paths joined by ``::`` (dict keys, list
  indices), so a train state nested as the reference's
  (``launch.steps.train_state_tree``: ``params::segments::0::0::mixer::wq``,
  ``opt::m::...``) is written and read under the same keys by either
  package.
* Atomic: arrays, manifest and COMMIT go to ``step_N.tmp``, which is then
  renamed; a directory without COMMIT is skipped. The newest ``keep``
  steps are kept.
* Async: the state is copied to host memory when ``save_checkpoint`` is
  called (a leaf already on the host too: the train step updates its
  tensors in place, so the writer must not share their storage); a
  thread writes the copy to disk. ``wait()`` joins it.
* Quantized checkpoints (the paper's bounded memory on disk): with a
  ``policy``, a >= 2-D float leaf whose key contains a layer's name is
  stored on that layer's weight Q(I,F) grid in an int8/int16 container;
  restore dequantizes.
* Under a mesh (``plan``) the ranks share one global-shape checkpoint,
  cross-loadable with the reference's and between meshes: the trainer
  gathers each leaf whole (``launch.steps.train_state_tree(plan=)``),
  rank 0 writes today's layout, and every rank waits for its COMMIT
  (a barrier) before it goes on; on restore every rank reads the global
  leaves and keeps its shard (``launch.steps.load_train_state(plan=)``).
* bf16 leaves: numpy has no bf16, so a bf16 leaf is stored as its 16-bit
  pattern (``uint16``) and the manifest's ``dtypes`` records
  ``"bfloat16"``; restore rebuilds it bit for bit. (The reference saves
  an ``ml_dtypes.bfloat16`` leaf that ``np.savez`` writes as raw ``V2``
  records and cannot restore; the port restores such a leaf too, as bf16
  bits.)
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "::"

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """key -> leaf of nested dicts, lists and tuples (dict keys in sorted
    order, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _host(leaf, copy: bool = False):
    """(numpy array, dtype name) of a leaf; bf16 as its uint16 pattern.
    With ``copy`` the array never shares the leaf's storage (``.cpu()``
    and ``np.asarray`` return the leaf's own memory when it is already on
    the host)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            arr, dt = t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        else:
            arr, dt = t.cpu().numpy(), str(t.dtype).replace("torch.", "")
        if copy and t.device.type == "cpu":
            arr = arr.copy()
        return arr, dt
    arr = np.array(leaf, copy=True) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray],
           manifest: dict, keep: int):
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def _fmt_for_key(policy, key: str):
    """Per-layer weight format lookup by layer name appearing in the key."""
    for name, lp in zip(policy.names, policy.layers):
        if name in key and lp.weight is not None:
            return lp.weight
    return None


def _shared(plan) -> bool:
    """True when ``plan``'s ranks share the checkpoint (more than one)."""
    import torch.distributed as dist
    return (plan is not None and dist.is_initialized()
            and dist.get_world_size() > 1)


def _writes(plan) -> bool:
    """True on the rank that writes (rank 0 of a shared checkpoint)."""
    import torch.distributed as dist
    return not _shared(plan) or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, state, *,
                    extra: Optional[dict] = None, keep: int = 3,
                    async_: bool = False, policy=None, plan=None):
    """``state``: nested dicts / lists of tensors, arrays or scalars.
    Returns a join()-able thread when ``async_``, else None. ``plan``:
    every rank of the mesh calls this with the same global ``state``;
    rank 0 writes it (synchronously) and every rank returns after its
    COMMIT."""
    if _shared(plan):
        import torch.distributed as dist
        if dist.get_rank() == 0:
            save_checkpoint(directory, step, state, extra=extra, keep=keep,
                            policy=policy)
        dist.barrier()
        return None
    os.makedirs(directory, exist_ok=True)
    arrays, qmeta, dtypes = {}, {}, {}
    for k, v in _flatten(state).items():
        arr, dt = _host(v, copy=async_)
        if policy is not None and arr.ndim >= 2 and dt != "bfloat16" and \
                np.issubdtype(arr.dtype, np.floating):
            fmt = _fmt_for_key(policy, k)
            if fmt is not None:
                scale = float(2 ** fmt.frac_bits)
                q = np.clip(np.round(arr.astype(np.float32) * scale),
                            fmt.qmin, fmt.qmax)
                arr = q.astype(np.int8 if fmt.total_bits <= 8 else np.int16)
                qmeta[k] = {"int_bits": fmt.int_bits,
                            "frac_bits": fmt.frac_bits,
                            "orig_dtype": dt}
        if dt == "bfloat16":
            dtypes[k] = dt
        arrays[k] = arr
    manifest = {"step": step, "extra": extra or {}, "quant": qmeta,
                "keys": sorted(arrays.keys())}
    if dtypes:
        manifest["dtypes"] = dtypes
    if async_:
        t = threading.Thread(target=_write,
                             args=(directory, step, arrays, manifest, keep),
                             daemon=True)
        t.start()
        return t
    _write(directory, step, arrays, manifest, keep)
    return None


def _unflatten_like(template, leaves: Dict[str, Any], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves[_SEP.join(prefix)]


def restore_checkpoint(directory: str, template, *,
                       step: Optional[int] = None, device="cpu"):
    """Restore into the structure of ``template`` (nested dicts / lists of
    tensors; tensors on the meta device will do). Returns (step, state,
    extra): each leaf a tensor of the template leaf's shape and dtype on
    ``device``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    bf16_keys = manifest.get("dtypes", {})
    npz = np.load(os.path.join(d, "arrays.npz"))
    leaves = {}
    for key, leaf in _flatten(template).items():
        arr = npz[key]
        if key in bf16_keys or (arr.dtype.kind == "V" and
                                arr.dtype.itemsize == 2):
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif key in manifest["quant"]:
            meta = manifest["quant"][key]
            t = torch.from_numpy(arr.astype(np.float32)
                                 / 2 ** meta["frac_bits"])
            t = t.to(_TORCH[meta["orig_dtype"]])
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != "
                             f"template {tuple(leaf.shape)}")
        leaves[key] = t.to(leaf.dtype).to(device)
    return step, _unflatten_like(template, leaves), manifest["extra"]


class CheckpointManager:
    """Step-gated async save + restore-latest, used by ``launch.train``.
    ``plan``: the mesh's ranks share the checkpoints; every rank calls
    each method at the same steps with the same global state, rank 0
    writes in the background, and :meth:`wait` (before the next save, a
    restore and at the end) returns on every rank once the write is
    committed."""

    def __init__(self, directory: str, *, interval: int = 100, keep: int = 3,
                 policy=None, plan=None):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.policy = policy
        self.plan = plan
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state, extra=None, force=False):
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()
        if _writes(self.plan):
            self._pending = save_checkpoint(
                self.directory, step, state, extra=extra, keep=self.keep,
                async_=True, policy=self.policy)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if _shared(self.plan):
            import torch.distributed as dist
            dist.barrier()

    def restore_latest(self, template, device="cpu"):
        self.wait()
        return restore_checkpoint(self.directory, template, device=device)
