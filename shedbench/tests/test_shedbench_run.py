"""A whole run of a cell at a CPU size: the reference agrees with the
port, the result line keeps its schema, every planted fault and the
bfloat16 control come out not correct, and the command refuses to run
without a card or without the program."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from shedbench_tiny import BENCH, ROOT, tiny

from shedharness.cell import run_cell
from shedharness.standin import VARIANTS, make_variant

CELLS = ("shed_c128_t8", "cascade_c128_t8")


def run(cell, trace=False, **kw):
    return run_cell(tiny(cell), seed=2**31 + 99, seconds=0.3, trace=trace,
                    device="cpu", t_origin=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    out, lines = run(cell)
    assert out["correct"] is True, out["check"]
    assert out["check"]["checked_steps"]["value"] >= 2
    assert out["check"]["control_mismatches"]["value"] == 0
    assert lines[-1].startswith("check control_mismatches 0 ")


@pytest.mark.parametrize("cell", CELLS)
def test_the_last_line_keeps_its_schema(cell):
    out, _ = run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"frames_per_s", "step_p95_ms", "setup_s"} <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for n in out["check"].values():
        assert set(n) == {"value", "limit", "rule"}
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_keeps_its_schema(cell):
    out, _ = run(cell, trace=True)
    assert out["correct"] is True, out["check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "check"
    # no device here: only the harness's own span is read
    assert set(out["metrics"]) == ({"scorer_ms"} if "cascade" in cell else set())


def test_the_device_stretch_ends_before_the_profiler_stops(monkeypatch):
    from shedharness import window
    start = window.start_profiler

    class SlowStop:
        """A profiler whose stop and flush take half a second."""
        def __init__(self, host):
            self.prof = start(host)

        def __exit__(self, *exc):
            time.sleep(0.5)
            return self.prof.__exit__(*exc)

        def __getattr__(self, name):
            return getattr(self.prof, name)

    monkeypatch.setattr(window, "start_profiler", SlowStop)
    out, _ = run("shed_c128_t8", trace=True)
    assert 0 < out["device"]["window_s"] < 0.5


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_control_and_faults_are_not_correct(cell, variant):
    out, _ = run(cell, make_program=make_variant(variant), sample_gap=2)
    assert out["correct"] is False, (variant, out["check"])


def test_the_float32_reference_in_the_programs_place_is_correct():
    from functools import partial

    import torch

    from shedharness.standin import RefProgram
    out, _ = run("cascade_c128_t8", make_program=partial(
        RefProgram, dtype=torch.float32), sample_gap=2)
    assert out["correct"] is True, out["check"]


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "shedbench/run.py", "--workload", "shed_c128_t8",
         "--seed", "3", "--seconds", "1", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "shedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
