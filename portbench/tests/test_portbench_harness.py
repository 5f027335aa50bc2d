"""Discovery by name, ``BENCHMARK.json`` against the contract's limits, and the
result line's keys."""

import hashlib
import json
import re
import shutil

import pytest

import harness
import run as runmod

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_benchmark_json_keeps_the_contract():
    b = harness.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.fullmatch(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:   # the moved metric is reported where this one is
            assert harness.reports(e2e[m["moves"]], w)
    for w in cells:
        got = {m["name"] for m in harness.cell_metrics(b, w, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(b, w, True)


def test_every_name_finds_its_files():
    b = harness.load_benchmark()
    for w in b["workloads"]:
        cfg = harness.config(b, w["config"])
        assert cfg["name"] == w["config"]
        mix = harness.traffic(w["traffic"])
        assert harness.driver(mix["driver"]).run
        assert harness.work(w["config"])
        lim = harness.limits(w["name"])
        assert lim and all(v > 0 for v in lim.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    with pytest.raises(ValueError):
        harness.traffic("../BENCHMARK")


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a metric and a cell are added as new
    files and new entries; the harness finds them and no file changes."""
    pb = tmp_path / "portbench"
    shutil.copytree(harness.PB, pb, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(pb)
    b = harness.load_benchmark()
    cfg = json.loads((harness.ROOT / b["configs"][0]["file"]).read_text())
    (pb / "configs" / "new_model.json").write_text(json.dumps(cfg))
    mix = dict(harness.traffic(b["workloads"][0]["traffic"]), batch=64, request_rows=64)
    (pb / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "new_metric.sample.py").write_text(
        "def read(obs):\n    return 1.0 if obs.get('kind') == 'sample' else None\n")
    (pb / "limits" / "new_model.new_mix.json").write_text(json.dumps({"img_err_mean": 1.0}))
    (pb / "work" / "new_model.py").write_text("from peaks import PEAK_FLOPS  # noqa\n")
    b["configs"].append(dict(b["configs"][0], name="new_model",
                             file="portbench/configs/new_model.json"))
    b["workloads"].append(dict(name="new_model.new_mix", config="new_model",
                               traffic="new_mix", chips=1, why="a later cell"))
    b["per_layer"].append(dict(name="new_metric.sample", unit="%", better="higher",
                               source="device_trace", layer="sampler",
                               moves="sample_img_per_s", workloads=["new_model.new_mix"]))
    for m in b["end_to_end"]:
        if m["name"] == "sample_img_per_s":
            m["workloads"].append("new_model.new_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "PB", pb)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    nb = harness.load_benchmark(tmp_path)
    cell = harness.cell(nb, "new_model.new_mix")
    assert harness.config(nb, cell["config"])["model"] == cfg["model"]
    assert harness.traffic(cell["traffic"])["batch"] == 64
    assert harness.limits(cell["name"]) == {"img_err_mean": 1.0}
    assert harness.work("new_model").PEAK_FLOPS
    names = [m["name"] for m in harness.cell_metrics(nb, "new_model.new_mix", True)]
    assert names == ["new_metric.sample"]
    assert harness.reader("new_metric.sample").read({"kind": "sample"}) == 1.0
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())


def test_result_line_keys(monkeypatch):
    import torch

    from tracing import Trace

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    b = harness.load_benchmark()
    w = next(c["name"] for c in b["workloads"] if c["traffic"] == "sample_b128")
    tr = Trace(device=[("k", 10, 20)], host=[("aten::mm", 0, 40)], window=(0, 40), calls=1)
    obs = dict(kind="sample", setup_s=12.5, window_s=2.0, latencies=[0.1, 0.12, 0.11],
               images=384, chips=1, trace=tr, peak_bytes=2 ** 30,
               rate=dict(seconds=2.0, flops=1e12, peak=989e12))
    out = dict(obs=obs, correct=True, attempted=3, failed=0, memory_peak_bytes=2 ** 30,
               checks=[dict(name="img_err_mean", value=0.01, limit=0.02, ok=True)])
    for trace in (False, True):
        line = runmod.result_line(out, harness.cell_metrics(b, w, trace), 1)
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["checks"] == {"img_err_mean": {"value": 0.01, "limit": 0.02}}
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert dev["memory_peak_bytes"] == 2 ** 30
        if trace:
            assert dev["busy_s"] == 1e-8 and dev["window_s"] == 4e-8
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert "launches.sample" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"setup_s", "sample_img_per_s", "sample_p95_ms"}
            assert line["metrics"]["sample_img_per_s"] == {"value": 192.0, "unit": "img/s"}
    json.dumps(line)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = harness.load_benchmark()
    rc = runmod.main(["--workload", b["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
                      "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_weights_load_by_name():
    """Both sides load the state drawn over the reference's keys by name: a
    leaf the program adds is drawn apart and moves no other leaf's value."""
    import torch

    from weights import make_state, materialize, shapes_of

    rules = [["*.bias", "const", 0.0], ["*", "normal", 1.0]]

    def net(extra):
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
        if extra:
            m.register_buffer("added", torch.zeros(5))
        return m

    with torch.device("meta"):
        ref_net, prog_net = net(False), net(True)
    state = make_state(shapes_of(ref_net), rules, 2 ** 40 + 3, "cpu")
    ref_net = materialize(ref_net, state, "cpu", rules, 2 ** 40 + 3)
    prog_net = materialize(prog_net, state, "cpu", rules, 2 ** 40 + 3)
    for k, v in ref_net.state_dict().items():
        assert torch.equal(prog_net.state_dict()[k], v)
    added = prog_net.state_dict()["added"]
    assert added.shape == (5,) and added.abs().sum() > 0
