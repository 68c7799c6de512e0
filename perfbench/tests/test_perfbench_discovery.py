"""Configs, mixes, model families and metric readers are found by name:
a file dropped in is read without any edit to the harness."""
import json
import time

import pytest

from perfbench import families, harness
from perfbench import metrics as readers
from perfbench.traffic import generator as gen

from conftest import DATA


def test_a_new_mix_config_and_reader_are_found(tmp_path, monkeypatch):
    mixes, mets = tmp_path / "traffic", tmp_path / "metrics"
    mixes.mkdir()
    mets.mkdir()
    (mixes / "new-mix.json").write_text((DATA / "tiny-decode.json").read_text())
    (mets / "new_metric.py").write_text(
        "def read(run):\n    return run['window']['seconds'] * 2\n")
    (tmp_path / "new-config.json").write_text(
        (DATA / "tiny-dense.json").read_text())
    bench = {"configs": [{"name": "new-config", "file": "new-config.json"}],
             "workloads": [{"name": "new-config.new-mix", "config": "new-config",
                            "traffic": "new-mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "ttft_mean_s", "unit": "s",
                             "workloads": ["elsewhere"]}],
             "per_layer": [{"name": "new_metric", "unit": "s",
                            "moves": "setup_s"},
                           {"name": "other", "unit": "%", "moves": "setup_s",
                            "workloads": ["elsewhere"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(gen, "HERE", mixes)
    monkeypatch.setattr(readers, "HERE", mets)
    cell = harness.load_cell("new-config.new-mix", tmp_path / "BENCHMARK.json")
    assert cell["mix"]["sessions"]["prompt_len"] == 32
    assert cell["config"]["arch"]["name"] == "perfbench-tiny-dense"
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric"]
    assert readers.read("new_metric", {"window": {"seconds": 1.5}}) == 3.0
    with pytest.raises(FileNotFoundError):
        readers.read("missing_metric", {})
    with pytest.raises(FileNotFoundError):
        gen.load("missing-mix")


def test_every_benchmark_metric_has_a_reader():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert readers.reader_path(m["name"]).is_file(), m["name"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], harness.ROOT / "BENCHMARK.json")
        assert cell["config"]["name"] == w["config"]


# appended to the toy family: each call the harness makes is recorded
_RECORD_CALLS = """

CALLS = []


def _recorded(fn):
    def call(*a, **k):
        CALLS.append(fn.__name__)
        return fn(*a, **k)
    return call


make, hidden, logits, span_flops = (_recorded(make), _recorded(hidden),
                                    _recorded(logits), _recorded(span_flops))
"""


def _toy_bench(tmp_path, monkeypatch, family):
    fams, mixes = tmp_path / "families", tmp_path / "traffic"
    fams.mkdir()
    mixes.mkdir()
    (fams / "toy.py").write_text(
        families.family_path("gqa_swiglu").read_text() + _RECORD_CALLS)
    (mixes / "toy-mix.json").write_text(
        (DATA / "tiny-decode.json").read_text())
    config = dict(json.loads((DATA / "tiny-dense.json").read_text()),
                  name="toy-config", family=family)
    (tmp_path / "toy-config.json").write_text(json.dumps(config))
    bench = {"configs": [{"name": "toy-config", "file": "toy-config.json"}],
             "workloads": [{"name": "toy-config.toy-mix",
                            "config": "toy-config", "traffic": "toy-mix",
                            "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "mfu", "unit": "%", "moves": "setup_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(families, "HERE", fams)
    monkeypatch.setattr(gen, "HERE", mixes)
    return tmp_path / "BENCHMARK.json"


def test_a_new_family_is_found_and_run(tmp_path, monkeypatch):
    bench = _toy_bench(tmp_path, monkeypatch, "toy")
    cell = harness.load_cell("toy-config.toy-mix", bench)
    toy = cell["family"]
    assert toy.__file__ == str(tmp_path / "families" / "toy.py")
    out = harness.run_cell(cell, 5, 1.5, True, "cpu", time.perf_counter())
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["info"]["tokens_compared"] > 0
    # weights, the reference and the FLOP count all came from the toy
    assert {"make", "hidden", "logits", "span_flops"} <= set(toy.CALLS)
    assert out["info"]["window"]["flops"] > 0
    assert out["result"]["metrics"]["mfu"]["value"] > 0


def test_a_missing_family_names_the_config(tmp_path, monkeypatch):
    bench = _toy_bench(tmp_path, monkeypatch, "no_such_family")
    with pytest.raises(FileNotFoundError, match="toy-config"):
        harness.load_cell("toy-config.toy-mix", bench)
    with pytest.raises(KeyError, match="toy-config"):
        families.load({"name": "toy-config"})
