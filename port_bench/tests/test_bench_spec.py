"""BENCHMARK.json against the benchmark's contract: names, units and text
in the allowed characters, each entry's keys, and every piece a file of its
own that the harness finds by name."""

import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == [BENCH.name]
    assert 1 <= len(SPEC["command"]) <= 32 and all(text_ok(w) for w in SPEC["command"])
    assert (BENCH.parent / SPEC["command"][1]).is_file() and SPEC["command"][1].startswith(BENCH.name + "/")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_texts():
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[group]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert text_ok(c["why"]) and text_ok(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert text_ok(m["layer"]) and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_entry_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }
    for group, keys in allowed.items():
        for entry in SPEC[group]:
            assert set(entry) <= keys and set(entry) >= keys - {"workloads"}, (group, entry)


def test_every_per_layer_metric_moves_one_its_cells_report():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])


def test_every_piece_is_a_file_found_by_name():
    for c in SPEC["configs"]:
        conf = json.loads((BENCH.parent / c["file"]).read_text())
        assert c["file"].startswith(BENCH.name + "/") and conf["source"] == c["source"]
        assert (BENCH / "reference" / f"{conf['reference']}.py").is_file()
        assert conf["reduced"] == c["reduced"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for w in SPEC["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
    for m in METRICS:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(len(SPEC["workloads"]) // 4, 1)


def test_a_full_check_fits_its_time():
    cells = 24  # later PRs may add cells up to the contract's most
    runs = 2 + 14 * cells
    assert runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
