"""Cells, configurations, traffic and metrics are found by name, and a
cell added as files is found without an edit."""
import json
import re
import shutil

import pytest

from shedbench_tiny import BENCH, ROOT

from shedharness.spec import load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_loads_with_its_readers(cell):
    spec = load_cell(ROOT, cell)
    assert spec.chips == 1
    assert spec.config["frame_shape"] == [720, 1280]
    names = [m.name for m in spec.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer and all(callable(m.read) for m in spec.per_layer)
    cascade = spec.config["cascade"] is not None
    assert ("scorer_ms" in [m.name for m in spec.per_layer]) == cascade


def test_names_units_and_files_keep_to_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == cfg["reduced"]
    for w in b["workloads"]:
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "shedbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "workloads" / "c128_t8.json").read_text())
    traffic.update(name="c16_t4", cameras=16, frames_per_step=4)
    (bench / "workloads" / "c16_t4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_per_camera_s.py").write_text(
        "def read(rec):\n    return rec.window.frames / rec.window.window_s"
        " / rec.shapes['C']\n")
    b["workloads"].append({"name": "shed_c16_t4", "config": "shed_720p_red_yellow",
                           "traffic": "c16_t4", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "frames_per_camera_s", "unit": "frames/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["shed_c16_t4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = load_cell(root, "shed_c16_t4", bench_dir=bench)
    assert spec.traffic["cameras"] == 16
    assert [m.name for m in spec.end_to_end][-1] == "frames_per_camera_s"
    assert "frames_per_camera_s" not in [
        m.name for m in load_cell(root, "shed_c128_t8", bench_dir=bench).end_to_end]
    with pytest.raises(KeyError):
        load_cell(root, "no_such_cell", bench_dir=bench)
