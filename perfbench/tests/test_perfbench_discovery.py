"""Configs, mixes and metric readers are found by name: a file dropped
in is read without any edit to the harness."""
import json

import pytest

from perfbench import harness
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
