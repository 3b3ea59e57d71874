"""Port parity of the roofline, the perf diff and the report's dry-run
sections (``repro_torch.benchmarks.{roofline,perf,report,run}``) against
the reference's (``benchmarks/``), on the same hand-made dry-run records
in one temporary results directory (the reference's under ``dryrun/``,
the port's under ``torch_dryrun/``).

* ``analyze_record``, ``table`` and ``perf.diff`` equal the reference's
  with its constants patched to the port's (the H100's), but for the
  memory fit: the port's is the recorder's tracked peak, the reference's
  its arguments and temporaries less the donated ones (a difference by
  design).
* ``dryrun_section``, ``roofline_section`` and ``perf_section``: the
  same table rows and bullets; the words about the chip and the
  compiler differ.
* ``run.py --only roofline`` with no records prints the reference's
  message, naming the port's dry run.
"""
import contextlib
import io
import json

import pytest

import benchmarks.perf as jperf
import benchmarks.report as jreport
import benchmarks.roofline as jroofline
from repro_torch.benchmarks import common
from repro_torch.benchmarks import perf as tperf
from repro_torch.benchmarks import report as treport
from repro_torch.benchmarks import roofline as troofline
from repro_torch.benchmarks import run as trun


def _record(arch, shape, mesh, kind, *, flops, hbm, wire, s):
    n_params, n_active = 7.0e10, 7.0e10 if arch != "moe" else 1.7e10
    tokens = {"train": 256 * 4096, "prefill": 32 * 32768, "decode": 128}
    return {
        "arch": arch, "shape": shape, "mesh": mesh,
        "mesh_shape": ({"pod": 2, "data": 16, "model": 16}
                       if mesh == "multi" else {"data": 16, "model": 16}),
        "kv_bits": 0, "overrides": {}, "tp_decode": False, "skipped": False,
        "lower_s": s, "compile_s": s,
        "memory": {"argument_size_in_bytes": 1_000_000_000,
                   "output_size_in_bytes": 0,
                   "temp_size_in_bytes": 500_000_000,
                   "alias_size_in_bytes": 0,
                   "peak_memory_in_bytes": 1_500_000_000},
        "cost": {}, "collectives": {},
        "loop_cost": {"flops": flops, "hbm_bytes": hbm, "wire_bytes": wire,
                      "collectives": {"all-gather": wire / 2,
                                      "all-reduce": wire / 2},
                      "warnings": []},
        "model": {"n_params": n_params, "n_active_params": n_active,
                  "tokens_per_step": tokens[kind],
                  "model_flops": float((6 if kind == "train" else 2)
                                       * n_active * tokens[kind]),
                  "seq_len": 4096, "global_batch": 256, "kind": kind}}


RECORDS = [
    _record("dense", "train_4k", "single", "train", flops=3.0e16,
            hbm=2.5e14, wire=4.0e11, s=96.0),
    _record("dense", "decode_32k", "single", "decode", flops=7.6e11,
            hbm=1.2e12, wire=8.5e9, s=75.0),
    _record("moe", "prefill_32k", "single", "prefill", flops=6.2e15,
            hbm=6.4e14, wire=4.5e14, s=86.5),
    _record("dense", "train_4k", "multi", "train", flops=1.5e16,
            hbm=1.3e14, wire=2.0e11, s=120.0),
]
PERF_LOG = [{"iter": 1, "arch": "dense", "shape": "decode_32k",
             "why": "memory-bound", "title": "int8 KV",
             "hypothesis": "halves the cache bytes", "change": "--kv-bits 8",
             "before": "1.0 s", "after": "0.6 s", "verdict": "kept"}]


@pytest.fixture
def results(tmp_path, monkeypatch):
    for sub in ("dryrun", "torch_dryrun"):
        d = tmp_path / sub / "baseline"
        d.mkdir(parents=True)
        for r in RECORDS + [{"skipped": True, "reason": "not applicable"}]:
            name = (f"{r['mesh']}_{r['arch']}_{r['shape']}.json"
                    if not r.get("skipped") else "single_enc_decode.json")
            (d / name).write_text(json.dumps(r))
    (tmp_path / "perf_log.json").write_text(json.dumps(PERF_LOG))
    (tmp_path / "torch_perf_log.json").write_text(json.dumps(PERF_LOG))
    for mod in (jroofline, jperf, jreport):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
    for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES"):
        monkeypatch.setattr(jroofline, k, getattr(troofline, k))
    with common.results_in(tmp_path):
        yield tmp_path


def test_analyze_record_and_table_are_the_references(results):
    for rec in RECORDS:
        got, want = troofline.analyze_record(rec), \
            jroofline.analyze_record(rec)
        assert set(got) == set(want)
        for k in want:
            if k != "fit_bytes":
                assert got[k] == want[k], k
        # the fit: the tracked peak against the arguments and
        # temporaries less the donated
        assert got["fit_bytes"] == rec["memory"]["peak_memory_in_bytes"]
    got, want = troofline.load_all(), jroofline.load_all()
    assert len(got) == len(want) == len(RECORDS)
    for mesh in ("single", "multi"):
        t, j = (troofline.table(got, mesh=mesh),
                jroofline.table(want, mesh=mesh))
        assert t == j.replace("fits 16G", "fits 80G")


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_perf_diff_is_the_references(results):
    # a second tag: the decode cell with its memory term cut
    for sub, mod in (("dryrun", jperf), ("torch_dryrun", tperf)):
        d = results / sub / "int8kv"
        d.mkdir()
        rec = dict(RECORDS[1], loop_cost=dict(RECORDS[1]["loop_cost"],
                                               hbm_bytes=6.0e11))
        (d / "single_dense_decode_32k.json").write_text(json.dumps(rec))
    got = _printed(tperf.diff, "dense", "decode_32k", "int8kv")
    want = _printed(jperf.diff, "dense", "decode_32k", "int8kv")
    assert [x for x in got if "fit GiB" not in x] == \
        [x for x in want if "fit GiB" not in x]
    assert len(got) == len(want) == 7


def _rows(text):
    """The table rows (past the header) and bullet lines of a section."""
    lines = text.splitlines()
    return [x for x in lines if (x.startswith("| ") and "---" not in x
                                 and not x.startswith("| arch"))
            or x.startswith("- ")]


def test_report_sections_are_the_references(results):
    got, want = treport.dryrun_section(), jreport.dryrun_section()
    assert _rows(got) == _rows(want) and len(_rows(got)) == len(RECORDS)
    assert "**4 cells laid out OK** (31 applicable cells x 2 meshes; 9 " \
        "skips" in got
    assert "**4 cells compiled OK** (31 applicable cells x 2 meshes; 9 " \
        "skips" in want
    got, want = treport.roofline_section(), jreport.roofline_section()
    assert _rows(got) == _rows(want)
    assert "NVIDIA H100 80GB HBM3 (700 W)" in got
    assert treport.perf_section() == jreport.perf_section()
    doc = treport.build()
    for part in ("## §Dry-run", "## §Roofline", "## §Perf"):
        assert part in doc
    treport.main(["--write"])
    assert (results / "torch_EXPERIMENTS.md").read_text() == doc


def test_roofline_stage_without_records(tmp_path, monkeypatch):
    monkeypatch.setattr(jroofline, "RESULTS", str(tmp_path))
    want = _printed(jroofline.run)
    with common.results_in(tmp_path):
        got = _printed(trun.main, ["--only", "roofline", "--device", "cpu"])
    assert want == ["[roofline] no dry-run records found; run python -m "
                    "repro.launch.dryrun first"]
    assert want[0].replace("repro.launch", "repro_torch.launch") in got
