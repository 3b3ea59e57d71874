"""The port's CNN training against the JAX package: the loss and its
gradients, and the reference's SGD-momentum recipe step by step. Same
seeded numpy inputs through both packages, one process, single-threaded
torch.

Tolerances: loss and gradients 1e-5, training losses 1e-4 relative and
parameters 1e-4. A max-pool window whose top two values are a near tie may
route its gradient to another element in each package (ROADMAP queue C,
known differences): such images or steps are counted, never hidden.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cnn_images as images, cnn_ref_tree as ref_tree  # noqa: E402
from _torch_parity import cnn_port as port, nhwc, numpy_tree  # noqa: E402
import benchmarks.common as jcommon
from repro.models import cnn as J
from repro_torch.benchmarks import common as tcommon
from repro_torch.models import cnn as T

NETS = ["lenet", "convnet", "alexnet_small"]
TOL = dict(rtol=1e-4, atol=1e-4)


def pool_routing_differs(net, tree, x):
    """Images where some max-pool window routes its gradient to another
    element in the two packages, asserting that each such window is a near
    tie: in both packages its top two values lie within 1e-5 (abs + rel) of
    each other, so float ULPs of the convolutions decide the pick. Each
    package runs its own forward to the pooled layer with the pool off."""
    jspec, tspec = J.SPECS[net], T.SPECS[net]
    tparams = T.cnn_params_from_numpy(tree, tspec, "cpu")
    out = np.zeros(len(x), bool)
    for i, l in enumerate(jspec.layers):
        if not l.pool:
            continue
        jsub = dataclasses.replace(jspec, layers=jspec.layers[:i] + (
            dataclasses.replace(l, pool=0),))
        tsub = dataclasses.replace(tspec, layers=tspec.layers[:i] + (
            dataclasses.replace(tspec.layers[i], pool=0),))
        wins = []
        for a in (np.asarray(J.cnn_forward(tree, jnp.asarray(x), jsub)),
                  nhwc(T.cnn_forward(tparams, T.images_nchw(x, "cpu"),
                                     tsub))):
            b, h, w, c = a.shape
            p, h2, w2 = l.pool, h // l.pool, w // l.pool
            wins.append(a[:, :h2 * p, :w2 * p].reshape(
                b, h2, p, w2, p, c).transpose(0, 1, 3, 5, 2, 4).reshape(
                b, h2, w2, c, p * p))
        differ = wins[0].argmax(-1) != wins[1].argmax(-1)
        for wv in wins:
            top2 = np.sort(wv[differ], -1)[:, -2:]
            np.testing.assert_allclose(top2[:, 0], top2[:, 1], rtol=1e-5,
                                       atol=1e-5)
        out |= differ.reshape(len(x), -1).any(1)
    return out


def loss_and_grads(net, tree, x, y):
    """(reference loss, reference grads, port loss, port grads), the port's
    grads in the reference's layout."""
    jloss, jgrad = jax.value_and_grad(
        lambda p: J.cnn_loss(p, {"image": jnp.asarray(x),
                                 "label": jnp.asarray(y)}, J.SPECS[net]))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = T.cnn_params_from_numpy(tree, T.SPECS[net], "cpu")
    leaves = [v.requires_grad_(True) for d in params.values()
              for v in d.values()]
    loss = T.cnn_loss(params, {"image": T.images_nchw(x, "cpu"),
                               "label": torch.from_numpy(y).long()},
                      T.SPECS[net])
    it = iter(torch.autograd.grad(loss, leaves))
    gtree = T.cnn_params_to_numpy(
        {k: {kk: next(it) for kk in d} for k, d in params.items()},
        T.SPECS[net])
    return float(jloss), numpy_tree(jgrad), float(loss.detach()), gtree


def trees_close(a, b, **tol):
    return all(np.allclose(a[k][kk], b[k][kk], **tol)
               for k in a for kk in ("w", "b"))


@pytest.mark.parametrize("net", NETS)
def test_loss_and_gradients_match(net):
    """One batch of 64. Where a max-pool window is a near tie the two
    packages may route its gradient to different elements (ROADMAP queue C,
    known differences): such images are counted and the gradients are held
    on the rest of the batch."""
    x, y = images(net, 64, seed=7)
    jl, jg, tl, tg = loss_and_grads(net, ref_tree(net), x, y)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    if not trees_close(tg, jg, rtol=1e-5, atol=1e-5):
        routed = pool_routing_differs(net, ref_tree(net), x)
        assert 0 < routed.sum() <= 2, routed.sum()      # counted, and rare
        x, y = x[~routed], y[~routed]
        jl, jg, tl, tg = loss_and_grads(net, ref_tree(net), x, y)
    for k in tg:
        for kk in ("w", "b"):
            np.testing.assert_allclose(tg[k][kk], jg[k][kk], rtol=1e-5,
                                       atol=1e-5)


def reference_steps(net, steps):
    """The reference's recipe (benchmarks/common.py::train_cnn), with the
    loss, parameters and momentum kept at every step."""
    spec, lr = J.SPECS[net], jcommon._LR[net]
    xs, ys = images(net, 4096, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, ref_tree(net))
    grad = jax.jit(jax.value_and_grad(lambda p, b: J.cnn_loss(p, b, spec)))
    mom = jax.tree_util.tree_map(jnp.zeros_like, params)
    n, trace = (len(xs) // 64) * 64, [(None, numpy_tree(params),
                                       numpy_tree(mom))]
    for i in range(steps):
        sl = slice((i * 64) % n, (i * 64) % n + 64)
        loss, g = grad(params, {"image": jnp.asarray(xs[sl]),
                                "label": jnp.asarray(ys[sl])})
        mom = jax.tree_util.tree_map(lambda m, g: 0.9 * m + g, mom, g)
        params = jax.tree_util.tree_map(lambda p, m: p - lr * m, params, mom)
        trace.append((float(loss), numpy_tree(params), numpy_tree(mom)))
    return trace, (xs, ys)


def test_sgd_momentum_steps_match():
    """LeNet, 20 steps end to end from the converted init: losses within
    1e-4 relative at every step, parameters within 1e-4 at the end. (The
    other nets are held step by step below: a near-tie max-pool window sends
    a gradient elsewhere and the trajectories then drift apart.)"""
    trace, _ = reference_steps("lenet", 20)
    own = numpy_tree(jcommon.train_cnn("lenet", steps=20, verbose=False))
    assert trees_close(own, trace[-1][1], rtol=0, atol=0)  # the recipe
    params, losses = tcommon.train_cnn("lenet", device="cpu",
                                       params=port("lenet"), steps=20,
                                       verbose=False)
    np.testing.assert_allclose(losses, [t[0] for t in trace[1:]], rtol=1e-4)
    got = T.cnn_params_to_numpy(params, T.LENET)
    assert trees_close(got, trace[-1][1], **TOL)


@pytest.mark.parametrize("net", ["lenet", "convnet"])
def test_sgd_momentum_step_by_step(net):
    """Each of 20 steps of ``sgd_momentum_step`` from the reference's own
    parameters and momentum: the loss within 1e-4 relative, the new
    parameters and momentum within 1e-4 except on batches holding a
    near-tie max-pool window (counted)."""
    trace, (xs, ys) = reference_steps(net, 20)
    spec, routed = T.SPECS[net], 0
    for i in range(20):
        _, p0, m0 = trace[i]
        loss1, p1, m1 = trace[i + 1]
        params = T.cnn_params_from_numpy(p0, spec, "cpu")
        for d in params.values():
            for v in d.values():
                v.requires_grad_(True)
        mom = T.cnn_params_from_numpy(m0, spec, "cpu")
        batch = {"image": T.images_nchw(xs[i * 64:(i + 1) * 64], "cpu"),
                 "label": torch.from_numpy(ys[i * 64:(i + 1) * 64]).long()}
        loss = tcommon.sgd_momentum_step(params, mom, batch, spec,
                                         tcommon._LR[net])
        np.testing.assert_allclose(float(loss), loss1, rtol=1e-4)
        if not (trees_close(T.cnn_params_to_numpy(params, spec), p1, **TOL)
                and trees_close(T.cnn_params_to_numpy(mom, spec), m1,
                                **TOL)):
            assert pool_routing_differs(net, p0, xs[i * 64:(i + 1) * 64]).any()
            routed += 1
    assert routed <= 3, routed
