"""The port's packages export the reference packages' public names (C9):
every name of ``repro.core``, ``repro.quant`` and ``repro.runtime``'s
``__all__`` resolves on the port's package of the same name, but the
elastic restore's two names, which come with distributed training
(ROADMAP queue A item 13). Also the two names that had no counterpart:
the process-wide metrics registry and the one-layer paged pool."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402
import repro.quant  # noqa: E402
import repro.runtime  # noqa: E402
from repro.models.attention import KVQuantSpec as JSpec  # noqa: E402
from repro.models.attention import \
    init_paged_kv_cache as jinit_paged_kv_cache  # noqa: E402
from repro_torch.models.attention import (KVQuantSpec,  # noqa: E402
                                          init_paged_kv_cache)
from repro_torch.runtime import default_registry  # noqa: E402
from repro_torch.runtime.telemetry import MetricsRegistry  # noqa: E402

# part 3 of item 13 (distributed training) brings these
LATER = {"repro.runtime": {"elastic_restore", "divisor_meshes"}}
PACKAGES = (repro.core, repro.quant, repro.runtime)
NAMES = [(pkg.__name__, name) for pkg in PACKAGES for name in pkg.__all__
         if name not in LATER.get(pkg.__name__, ())]


@pytest.mark.parametrize("package,name", NAMES,
                         ids=[f"{p}.{n}" for p, n in NAMES])
def test_reference_name_resolves_on_the_port(package, name):
    port = importlib.import_module(package.replace("repro", "repro_torch", 1))
    assert name in port.__all__
    obj = getattr(port, name)
    ref = getattr(importlib.import_module(package), name)
    assert callable(obj) == callable(ref)
    if isinstance(ref, type):
        assert isinstance(obj, type) and obj.__name__ == ref.__name__
    elif not callable(ref):
        assert obj == ref                  # FIELDS, BASELINE_BITS


def test_port_all_is_the_reference_all():
    for pkg in PACKAGES:
        port = importlib.import_module(
            pkg.__name__.replace("repro", "repro_torch", 1))
        want = [n for n in pkg.__all__
                if n not in LATER.get(pkg.__name__, ())]
        assert list(port.__all__) == want


def test_default_registry_is_process_wide():
    reg = default_registry()
    assert isinstance(reg, MetricsRegistry) and default_registry() is reg
    assert reg.namespace == ""


@pytest.mark.parametrize("container,bits", [("int8", 8), ("int4", 4),
                                            ("fp", 0)])
def test_init_paged_kv_cache_matches_the_reference(container, bits):
    quant = None if not bits else KVQuantSpec(2, bits - 2,
                                              container=container)
    jquant = None if not bits else JSpec(2, bits - 2, container=container)
    got = init_paged_kv_cache(6, 8, 2, 16, torch.float32, quant,
                              device="cpu")
    want = jinit_paged_kv_cache(6, 8, 2, 16, jnp.float32, jquant)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), w)
