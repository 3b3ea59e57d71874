"""The paper's CNNs (LeNet / Convnet / AlexNet-small) with per-layer
precision boundaries, in PyTorch.

Layer grouping follows the paper's Appendix A: a "layer" is the main
conv/fc stage plus its activation/pool stages, and carries ONE (weight, data)
format pair.

``cnn_forward(params, x, spec, policy)`` applies the paper's §2.1 conversion:
weights are fake-quantized before use, each layer's output data (and the
network input) is fake-quantized at the memory boundary. Compute stays
float32: every forward here runs inside :func:`fp32_exact` (no TF32,
deterministic cuDNN without autotuning), so on the card one policy always
gives the same accuracy, as the search's strict ``>`` needs.

Layout: the reference runs NHWC activations and HWIO conv weights; the port
runs NCHW and OIHW, so images are converted once at load
(:func:`images_nchw`), conv weights in :func:`cnn_params_from_numpy`, and
the activations are flattened in NHWC order before the first fc layer so
that fc weights keep the reference's ``(in, out)`` rows. The parameter tree
is the reference's ``{layer: {"w", "b"}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.fixedpoint import fake_quant
from ..core.policy import PrecisionPolicy
from ..core.traffic import LayerTraffic, TrafficModel


@dataclasses.dataclass(frozen=True)
class CNNLayerSpec:
    name: str
    kind: str                 # "conv" | "fc"
    features: int             # out channels / out features
    kernel: int = 0           # conv kernel size (square)
    pool: int = 0             # maxpool window/stride after activation (0=off)
    relu: bool = True
    padding: str = "VALID"


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    input_shape: Tuple[int, int, int]     # (H, W, C), as the reference's
    num_classes: int
    layers: Tuple[CNNLayerSpec, ...]

    @property
    def layer_names(self):
        return tuple(l.name for l in self.layers)


# ---------------------------------------------------------------------------
# The paper's three networks (Appendix A structures; AlexNet is width/kernel-
# scaled to 32x32 synthetic data), at the reference's widths.
# ---------------------------------------------------------------------------
LENET = CNNSpec(
    name="lenet", input_shape=(28, 28, 1), num_classes=10,
    layers=(
        CNNLayerSpec("layer1", "conv", 20, kernel=5, pool=2, relu=False),
        CNNLayerSpec("layer2", "conv", 50, kernel=5, pool=2, relu=False),
        CNNLayerSpec("layer3", "fc", 500, relu=True),
        CNNLayerSpec("layer4", "fc", 10, relu=False),
    ))

CONVNET = CNNSpec(
    name="convnet", input_shape=(32, 32, 3), num_classes=10,
    layers=(
        CNNLayerSpec("layer1", "conv", 32, kernel=5, pool=2, padding="SAME"),
        CNNLayerSpec("layer2", "conv", 32, kernel=5, pool=2, padding="SAME"),
        CNNLayerSpec("layer3", "conv", 64, kernel=5, pool=2, padding="SAME"),
        CNNLayerSpec("layer4", "fc", 64, relu=True),
        CNNLayerSpec("layer5", "fc", 10, relu=False),
    ))

ALEXNET_SMALL = CNNSpec(
    name="alexnet_small", input_shape=(32, 32, 3), num_classes=10,
    layers=(
        CNNLayerSpec("layer1", "conv", 48, kernel=3, pool=2, padding="SAME"),
        CNNLayerSpec("layer2", "conv", 96, kernel=3, pool=2, padding="SAME"),
        CNNLayerSpec("layer3", "conv", 128, kernel=3, padding="SAME"),
        CNNLayerSpec("layer4", "conv", 128, kernel=3, padding="SAME"),
        CNNLayerSpec("layer5", "conv", 96, kernel=3, pool=2, padding="SAME"),
        CNNLayerSpec("layer6", "fc", 256, relu=True),
        CNNLayerSpec("layer7", "fc", 256, relu=True),
        CNNLayerSpec("layer8", "fc", 10, relu=False),
    ))

SPECS = {"lenet": LENET, "convnet": CONVNET, "alexnet_small": ALEXNET_SMALL}


@contextlib.contextmanager
def fp32_exact():
    """float32 convolutions and matmuls in full precision (TF32 off), cuDNN
    deterministic and without autotuning; the previous settings come back
    on exit, so the serving path keeps its own. It uses the legacy
    ``allow_tf32`` flags, as the rest of the port does (torch refuses a mix
    of them with the ``fp32_precision`` settings)."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             mm.allow_tf32)
    cudnn.benchmark, cudnn.deterministic = False, True
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         mm.allow_tf32) = saved


# ---------------------------------------------------------------------------
# Init / weight converters
# ---------------------------------------------------------------------------
def _shapes_through(spec: CNNSpec):
    """Activation shape after each layer (H, W, C) or (F,) — drives init and
    the traffic model."""
    h, w, c = spec.input_shape
    shapes = []
    for l in spec.layers:
        if l.kind == "conv":
            if l.padding == "VALID":
                h, w = h - l.kernel + 1, w - l.kernel + 1
            c = l.features
            if l.pool:
                h, w = h // l.pool, w // l.pool
            shapes.append((h, w, c))
        else:
            shapes.append((l.features,))
    return tuple(shapes)


def _weight_shapes(spec: CNNSpec):
    """[(reference HWIO or (in, out) shape, fan_in)] per layer."""
    shapes = _shapes_through(spec)
    c = spec.input_shape[2]
    in_feat = None
    out = []
    for i, l in enumerate(spec.layers):
        if l.kind == "conv":
            out.append(((l.kernel, l.kernel, c, l.features),
                        l.kernel * l.kernel * c))
            c = l.features
        else:
            if in_feat is None:
                in_feat = int(np.prod(shapes[i - 1] if i
                                      else spec.input_shape))
            out.append(((in_feat, l.features), in_feat))
            in_feat = l.features
    return out


def _to_port_layout(w, kind: str):
    """reference layout -> port layout (HWIO -> OIHW; fc unchanged)."""
    return w.permute(3, 2, 0, 1) if kind == "conv" else w


def init_cnn(generator: torch.Generator, spec: CNNSpec,
             dtype=torch.float32, device="cuda") -> Dict[str, dict]:
    """Random weights as the reference draws them: a normal truncated to
    [-2, 2] times sqrt(2 / fan_in), zero biases. ``generator`` lives on
    ``device`` and fixes every draw."""
    dev = resolve_device(device)
    params = {}
    for l, (shape, fan_in) in zip(spec.layers, _weight_shapes(spec)):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        w = _to_port_layout(w * float(np.sqrt(2.0 / fan_in)), l.kind)
        params[l.name] = {
            "w": w.to(dtype).contiguous(),
            "b": torch.zeros((l.features,), dtype=dtype, device=dev),
        }
    return params


def cnn_params_from_numpy(tree, spec: CNNSpec, device="cuda"):
    """The reference's ``{layer: {"w", "b"}}`` tree of numpy arrays (conv
    weights HWIO, fc ``(in, out)``) as the port's float32 tensors on
    ``device`` (conv weights OIHW)."""
    dev = resolve_device(device)
    params = {}
    for l, (shape, _) in zip(spec.layers, _weight_shapes(spec)):
        w = np.array(tree[l.name]["w"], np.float32)
        b = np.array(tree[l.name]["b"], np.float32)
        if w.shape != shape or b.shape != (l.features,):
            raise ValueError(f"{l.name}: w {w.shape}, b {b.shape} do not "
                             f"fit {shape}, ({l.features},)")
        params[l.name] = {
            "w": _to_port_layout(torch.from_numpy(w), l.kind).contiguous()
            .to(dev),
            "b": torch.from_numpy(b).to(dev),
        }
    return params


def cnn_params_to_numpy(params, spec: CNNSpec):
    """The port's parameters in the reference's layout, as numpy arrays
    (copies): the inverse of :func:`cnn_params_from_numpy`, bit for bit."""
    out = {}
    for l in spec.layers:
        w = params[l.name]["w"].detach().cpu()
        if l.kind == "conv":
            w = w.permute(2, 3, 1, 0)
        out[l.name] = {"w": np.array(w, order="C"),
                       "b": np.array(params[l.name]["b"].detach().cpu())}
    return out


def images_nchw(images, device="cuda") -> torch.Tensor:
    """The datasets' (B, H, W, C) numpy images as a (B, C, H, W) float32
    tensor on ``device``: the one layout change of the input."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    return x.permute(0, 3, 1, 2).contiguous().to(resolve_device(device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _layer(x, w, b, l: CNNLayerSpec):
    """One layer's main stage, activation and pool (no quantization)."""
    if l.kind == "conv":
        pad = "same" if l.padding == "SAME" else 0
        x = F.conv2d(x, w, padding=pad) + b[:, None, None]
    else:
        if x.ndim > 2:   # NHWC order, so fc rows are the reference's
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = x @ w + b
    if l.relu:
        x = torch.relu(x)
    if l.kind == "conv" and l.pool:
        x = F.max_pool2d(x, l.pool)
    return x


def _maybe_fq(x, fmt):
    if fmt is None:
        return x
    return fake_quant(x, fmt.int_bits, fmt.frac_bits)


def cnn_forward(params, x, spec: CNNSpec,
                policy: Optional[PrecisionPolicy] = None):
    """x: (B, C, H, W) float32 in [0, 1]. Returns logits (B, classes)."""
    pol = {n: policy[n] for n in spec.layer_names} if policy is not None \
        else {n: None for n in spec.layer_names}
    with fp32_exact():
        # the network input is the first layer's input data (paper counts
        # it as data)
        first = pol[spec.layers[0].name]
        if first is not None:
            x = _maybe_fq(x, first.data)
        for l in spec.layers:
            lp = pol[l.name]
            w = params[l.name]["w"]
            if lp is not None:
                w = _maybe_fq(w, lp.weight)
            x = _layer(x, w, params[l.name]["b"], l)
            if lp is not None:
                x = _maybe_fq(x, lp.data)   # the paper's "data" boundary
    return x


def cnn_loss(params, batch, spec: CNNSpec):
    """Mean cross-entropy: logsumexp of the logits minus the label's.
    ``batch``: {"image": (B, C, H, W), "label": (B,) int64}."""
    logits = cnn_forward(params, batch["image"], spec)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, batch["label"][:, None])[:, 0]
    return torch.mean(lse - ll)


def policy_bit_arrays(spec: CNNSpec, policy: Optional[PrecisionPolicy]):
    """policy -> ((L,2) weight bits, (L,2) data bits) float32 numpy arrays
    with a (-1,-1) sentinel for float32 layers. They stay on the host: the
    reference traces them to avoid a recompile per policy; eager torch has
    no compile, and bits read from a device tensor would sync per policy."""
    L = len(spec.layers)
    wb = np.full((L, 2), -1.0, np.float32)
    db = np.full((L, 2), -1.0, np.float32)
    if policy is not None:
        for i, lp in enumerate(policy.layers):
            if lp.weight is not None:
                wb[i] = (lp.weight.int_bits, lp.weight.frac_bits)
            if lp.data is not None:
                db[i] = (lp.data.int_bits, lp.data.frac_bits)
    return wb, db


def _maybe_fq_bits(x, bits2):
    """bits2: (I, F) on the host; (-1, -1) = no quantization."""
    i, f = int(bits2[0]), int(bits2[1])
    if i < 0:
        return x
    return fake_quant(x, max(i, 1), max(f, 0))


def cnn_forward_bits(params, x, spec: CNNSpec, wbits, dbits):
    """:func:`cnn_forward` with per-layer bit arrays (see
    :func:`policy_bit_arrays`)."""
    with fp32_exact():
        x = _maybe_fq_bits(x, dbits[0])
        for li, l in enumerate(spec.layers):
            w = _maybe_fq_bits(params[l.name]["w"], wbits[li])
            x = _layer(x, w, params[l.name]["b"], l)
            x = _maybe_fq_bits(x, dbits[li])
    return x


@torch.no_grad()
def cnn_accuracy(params, images, labels, spec: CNNSpec,
                 policy: Optional[PrecisionPolicy] = None,
                 batch: int = 1024) -> float:
    """Top-1 accuracy under a policy (the search's eval_fn): ``images``
    (N, C, H, W) and ``labels`` (N,) on the parameters' device; one host
    sync per call."""
    n = images.shape[0]
    wbits, dbits = policy_bit_arrays(spec, policy)
    correct = torch.zeros((), dtype=torch.int64, device=images.device)
    for i in range(0, n, batch):
        logits = cnn_forward_bits(params, images[i:i + batch], spec,
                                  wbits, dbits)
        correct += (logits.argmax(-1) == labels[i:i + batch]).sum()
    return int(correct) / n


# ---------------------------------------------------------------------------
# Traffic model (paper §2.4): each datum touched once per layer.
# ---------------------------------------------------------------------------
def cnn_traffic_model(spec: CNNSpec) -> TrafficModel:
    """Per layer: its weights and biases, the data it reads (the previous
    layer's output, or the image) and the data it writes."""
    layers = []
    prev = int(np.prod(spec.input_shape))
    for l, out_shape, (wshape, _) in zip(spec.layers, _shapes_through(spec),
                                         _weight_shapes(spec)):
        out = int(np.prod(out_shape))
        layers.append(LayerTraffic(l.name, int(np.prod(wshape)) + l.features,
                                   prev, out))
        prev = out
    return TrafficModel(tuple(layers))
