"""The serving benches' gates raise the reference's words: the same
fault put into both packages' benches (their server swapped for one
with an option forced) at ``--fast`` on the CPU, and the two
``RuntimeError`` messages compared whole."""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench import reference_model, scratch_results  # noqa: E402

from benchmarks import paged_serve as jps  # noqa: E402
from repro_torch.benchmarks import paged_serve as tps  # noqa: E402


def forcing(cls, **forced):
    """``cls`` with the ``forced`` options over whatever a caller asks."""
    def make(*a, **kw):
        return cls(*a, **dict(kw, **forced))
    return make


# workload: (the option forced into every server, the message's start)
FAULTS = {
    # FIFO admission never preempts
    "overcommit": (dict(sched="fifo"),
                   "overcommit trace failed to trigger preemption"),
    # adaptation off in the adapt-on arm: nothing requantizes
    "adapt": (dict(kv_adapt="off"),
              "adapt run performed no requantizations"),
    # the fused arm served by separate programs: more programs than cycles
    "ragged": (dict(fused="off"), "fused serving launched"),
}


@pytest.fixture(scope="module")
def model():
    return reference_model()


@pytest.mark.parametrize("workload", list(FAULTS))
def test_gate_raises_the_reference_words(model, workload, tmp_path,
                                         monkeypatch):
    forced, start = FAULTS[workload]
    cfg, tmodel = model
    errors = []
    with scratch_results(tmp_path):
        for mod, call in ((jps, lambda: jps.run(fast=True, workload=workload,
                                                verbose=False)),
                          (tps, lambda: tps.run(cfg, tmodel, fast=True,
                                                workload=workload,
                                                verbose=False))):
            monkeypatch.setattr(mod, "BatchedServer",
                                forcing(mod.BatchedServer, **forced))
            with pytest.raises(RuntimeError) as e:
                call()
            errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith(start)
