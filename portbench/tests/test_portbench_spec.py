"""BENCHMARK.json against the contract's form, and every configuration,
traffic mix, driver, metric and limit it names loads by name."""
import json
import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_has_the_contract_keys_and_names():
    spec = common.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in common.spec()["workloads"]])
def test_each_cell_loads_its_files_by_name(workload):
    spec = common.spec()
    w, conf, cfg, traffic = common.cell(spec, workload)
    assert cfg["name"] == w["config"] == conf["name"]
    assert common.module("drivers", traffic["driver"]).run
    assert common.module("cameras", cfg["cameras"]["kind"]).make
    assert common.module("splats", cfg["layout"]["kind"]).make
    lim = common.load_json(common.HERE / "limits" / f"{workload}.json")
    assert lim and all(v > 0 for v in lim.values())
    e2e = common.metrics_of(spec, workload, 0)
    per_layer = common.metrics_of(spec, workload, 1)
    assert "setup_s" in dict(e2e) and len(e2e) >= 2 and per_layer
    for name, _ in e2e + per_layer:
        assert callable(common.module("metrics", name).read)


def test_each_config_lists_what_it_cut_and_assumed():
    for conf in common.spec()["configs"]:
        cfg = common.load_json(common.ROOT / conf["file"])
        assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
        assert cfg["assumed"] and cfg["source"] == conf["source"]
