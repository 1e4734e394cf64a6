"""BENCHMARK.json against the contract's form, and the harness finding
every part of a cell by name, also one dropped in by a later change."""
import json
import os
import re

from conftest import ROOT

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.benchmark()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k], (e["name"], k)
            assert e.get("better", "lower") in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in b["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in b[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(ms) == len(set(ms))


def test_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(b, "end_to_end",
                                                  w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(b, "per_layer", w["name"])


def test_every_layer_metric_moves_what_its_cells_report():
    b = bench()
    for m in b["per_layer"]:
        for w in m.get("workloads", [w["name"] for w in b["workloads"]]):
            e2e = [e["name"] for e in spec.metrics_of(b, "end_to_end", w)]
            assert m["moves"] in e2e, (m["name"], w)


def test_a_split_name_is_read_by_its_base_reader():
    ctx = {"pictures": 10, "window_s": 4.0, "t0": 0.0,
           "steps": [0.1 * i for i in range(1, 11)]}
    assert spec.metric_reader("fps.kbit")(ctx) == 2.5
    p90 = spec.metric_reader("frame_ms_p90.kbit")(ctx)
    assert abs(p90 - 100.0) < 1e-6


def test_parts_found_by_name():
    b = bench()
    for c in b["configs"]:
        conf = spec.config(c["name"])
        assert os.path.exists(conf["cfg_path"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert conf["reduced"] == c["reduced"]
        assert conf["chips"] == 1
    for w in b["workloads"]:
        spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        assert mix["width"] > 0 and mix["height"] > 0
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_new_part_dropped_into_a_copy_is_found(tiny_bench):
    d = tiny_bench
    with open(os.path.join(d, "traffic", "new_mix.json"), "w") as fh:
        json.dump({"width": 64, "height": 64}, fh)
    with open(os.path.join(d, "metrics", "new_metric.py"), "w") as fh:
        fh.write("def read(ctx):\n    return 42.0\n")
    conf = spec.load_json(os.path.join(d, "configs", "ldp_main.json"))
    conf["bit_depth"] = 8
    with open(os.path.join(d, "configs", "new_conf.json"), "w") as fh:
        json.dump(conf, fh)
    assert spec.traffic("new_mix", d)["width"] == 64
    assert spec.metric_reader("new_metric", d)({}) == 42.0
    assert spec.config("new_conf", d)["cfg_path"].startswith(d)


def test_shared_code_names_no_cell():
    b = bench()
    words = ([w["name"] for w in b["workloads"]]
             + [c["name"] for c in b["configs"]]
             + [w["traffic"] for w in b["workloads"]])
    hdir = os.path.join(ROOT, "benchmark", "harness")
    for f in os.listdir(hdir):
        if f.endswith(".py"):
            text = open(os.path.join(hdir, f)).read()
            for wd in words:
                assert wd not in text, (f, wd)
