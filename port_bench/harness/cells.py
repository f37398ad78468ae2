"""Finding a cell's pieces by name: its entry in BENCHMARK.json, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the loop that mix names
(``loops/<loop>.py``), its limits (``limits/<cell>.json``) and the reader
of each metric it reports (``metrics/<metric>.py``, or, where there is
none, ``metrics/<the metric's name up to its first dot>.py``: one reader
serves a quantity that is split by the end-to-end metric it moves)."""
import dataclasses
import importlib.util
import json
import os
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
LOOP_API = ("frames_needed", "run", "check")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _load_module(kind, path):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name, bench_dir=BENCH_DIR):
    """The reader of metric ``name``, loaded by path (names hold dots)."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(bench_dir, "metrics", stem + ".py")
        if os.path.exists(path):
            return _load_module("metric", path)
    raise FileNotFoundError(f"no reader for metric {name!r}: metrics/{name}.py or "
                            f"metrics/{name.split('.')[0]}.py")


def load_loop(name, bench_dir=BENCH_DIR):
    """The module ``loops/<name>.py``: ``frames_needed(cfg, mix)``,
    ``run(runner, seed, seconds, cfg)`` and ``check(nets, cfg, frames, intr,
    rec, gaps, device)``."""
    path = os.path.join(bench_dir, "loops", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no loop {name!r}: there is no loops/{name}.py")
    mod = _load_module("loop", path)
    missing = [f for f in LOOP_API if not callable(getattr(mod, f, None))]
    if missing:
        raise TypeError(f"loops/{name}.py lacks {missing}")
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    loop: types.ModuleType  # loops/<traffic's loop>.py
    limits: dict          # limits/<cell>.json
    end_to_end: list      # BENCHMARK.json metrics this cell reports, with their readers
    per_layer: list

    @property
    def droid_config(self):
        return dict(self.config["droid_config"])


def _reported(metrics, cell, bench_dir):
    out = []
    for m in metrics:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = load_reader(m["name"], bench_dir)
        for key in ("unit", "better", "layer"):
            if key in m and getattr(reader, key.upper()) != m[key]:
                raise ValueError(f"the reader of {m['name']} says {key} "
                                 f"{getattr(reader, key.upper())!r}, BENCHMARK.json {m[key]!r}")
        out.append((m, reader))
    return out


def find_cell(name, root=ROOT, bench_dir=BENCH_DIR):
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))
    return Cell(name, w, config, traffic, load_loop(traffic["loop"], bench_dir), limits,
                _reported(bench["end_to_end"], name, bench_dir),
                _reported(bench["per_layer"], name, bench_dir))
