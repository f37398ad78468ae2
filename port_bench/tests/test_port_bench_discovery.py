"""BENCHMARK.json and the files it names: every cell finds its pieces by
name, and the file keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from port_bench.harness.cells import (BENCH_DIR, LOOP_API, ROOT, find_cell, load_benchmark,
                                     load_loop, load_reader)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_pieces(name):
    cell = find_cell(name)
    assert all(callable(getattr(cell.loop, f)) for f in LOOP_API)
    assert {"init_net", "settle_net", "feat"} <= set(cell.limits)
    assert {"pose", "disp"} & set(cell.limits)        # what BA produced
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m, _ in cell.per_layer}
    assert cell.per_layer and moved <= e2e


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in BENCH[k]])
def test_every_metric_has_a_reader_that_agrees(metric):
    entry = next(m for k in ("end_to_end", "per_layer") for m in BENCH[k] if m["name"] == metric)
    reader = load_reader(metric)
    assert reader.UNIT == entry["unit"] and reader.BETTER == entry["better"]
    if "layer" in entry:
        assert reader.LAYER == entry["layer"]


def test_a_split_metric_shares_its_quantity_s_reader():
    assert load_reader("mfu.stream").__file__ == load_reader("mfu.backend").__file__
    assert load_reader("mfu.stream").__file__.endswith(os.path.join("metrics", "mfu.py"))
    with pytest.raises(FileNotFoundError):
        load_reader("no_such_metric.stream")


def test_an_unknown_loop_is_refused():
    assert {load_loop(n).__name__ for n in ("stream", "terminate")} == {
        "port_bench_loop_stream", "port_bench_loop_terminate"}
    with pytest.raises(FileNotFoundError, match="no loop"):
        load_loop("no_such_loop")


def test_configs_record_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg["assumed"])
        assert cfg["precision"] == {**cfg["precision"], "compute_dtype": "float32", "tf32": False}
        assert cfg["network"]["fnet_dim"] == 128 and cfg["network"]["cnet_dim"] == 256
