"""Discovery by name, the refusal of unknown names, a dummy cell and
metric added as files alone, and BENCHMARK.json against the contract's
shape."""

import json
import re

import pytest

from portbench import registry

UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads_with_its_files():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.load_metric(m["name"]).read)


@pytest.mark.parametrize("kind, load", [("workload", registry.load_cell), ("configuration", registry.load_config),
                                        ("traffic mix", registry.load_traffic), ("metric", registry.load_metric)])
def test_unknown_names_are_refused(kind, load):
    with pytest.raises(KeyError):
        load("no_such_thing")
    with pytest.raises(KeyError):
        load("../configs/realesrgan")


def test_a_dummy_cell_and_metric_come_from_files_alone(tmp_path):
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "model": "egvsr"}))
    (here / "traffic" / "burst.json").write_text(json.dumps({"name": "burst", "source_fps": 5}))
    (here / "metrics" / "toy_count.v2.py").write_text("def read(run):\n    return run.n * 2\n")
    (here / "metrics" / "setup_s.py").write_text("def read(run):\n    return 1.0\n")
    bench = {"workloads": [{"name": "toy.burst", "config": "toy", "traffic": "burst", "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "toy_count.v2", "moves": "setup_s"}]}
    cell = registry.load_cell("toy.burst", bench, here=here)
    assert cell.config["model"] == "egvsr" and cell.traffic["source_fps"] == 5
    assert [m["name"] for m in cell.per_layer] == ["toy_count.v2"]

    class Run:
        n = 21

    assert registry.load_metric("toy_count.v2", here=here).read(Run()) == 42


def test_benchmark_json_keeps_the_contracts_shape():
    bench = registry.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert registry.NAME.match(n), n
    for c in bench["configs"]:
        assert (registry.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
