"""The harness finds a configuration, a cell, a traffic mix and a
per-layer metric that later changes drop in as new files, by their names
in BENCHMARK.json, with no edit to a file that is there."""

import json
import shutil

from portbench import harness
from portbench.tests.conftest import ROOT


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((bench / "configs" / "tacotron1-lj22k.json").read_text())
    conf["config"]["dataset"]["sample_rate"] = 24000
    conf["config"]["dataset"]["mel_fmax"] = 12000.0
    (bench / "configs" / "tacotron1-lj24k.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "stream_b32.json").read_text())
    traffic["batch"] = 16
    (bench / "traffic" / "stream_b16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "lj24k-batch16.json").write_text('{"limits": {"mag_rel": 0.5}}')
    (bench / "metrics" / "host_share.synth.py").write_text(
        "def read(trace):\n    return None if not trace.units else 42.0\n")
    spec["configs"].append({"name": "tacotron1-lj24k", "source": "https://example.org",
                            "file": "portbench/configs/tacotron1-lj24k.json", "reduced": [],
                            "why": "a later configuration"})
    spec["workloads"].append({"name": "lj24k-batch16", "config": "tacotron1-lj24k",
                              "traffic": "stream_b16", "chips": 1, "why": "a later cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "audio_rtf":
            m["workloads"].append("lj24k-batch16")
    spec["per_layer"].append({"name": "host_share.synth", "unit": "%", "better": "lower",
                              "source": "program_span", "layer": "synthesize",
                              "moves": "audio_rtf", "workloads": ["lj24k-batch16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    got = harness.benchmark_spec(tmp_path)
    cell = harness.cell_spec(got, "lj24k-batch16")
    conf_file = harness.load_json(tmp_path / harness.config_spec(got, cell["config"])["file"])
    cfg = harness.config_from_dict(conf_file["config"])
    assert cfg.dataset.sample_rate == 24000 and cfg.dataset.extra_chars == ()
    assert harness.traffic_file(cell["traffic"], bench)["batch"] == 16
    assert harness.limits_file("lj24k-batch16", bench)["limits"]["mag_rel"] == 0.5
    assert "audio_rtf" in [m["name"] for m in harness.end_to_end_metrics(got, "lj24k-batch16")]
    names = [m["name"] for m in harness.per_layer_metrics(got, "lj24k-batch16")]
    assert names == ["host_share.synth"]
    read = harness.metric_reader("host_share.synth", bench)
    trace = harness.Trace({}, [{"B": 1}], 1.0, [], [])
    assert read(trace) == 42.0
    # The cells that were there keep their metrics.
    assert "host_share.synth" not in [m["name"] for m in harness.per_layer_metrics(
        got, "lj22k-batch32")]


def test_every_named_file_is_there():
    spec = harness.benchmark_spec(ROOT)
    for c in spec["configs"]:
        conf = harness.load_json(ROOT / c["file"])
        harness.config_from_dict(conf["config"])
    for w in spec["workloads"]:
        harness.traffic_file(w["traffic"])
        harness.limits_file(w["name"])
        harness.config_spec(spec, w["config"])
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
