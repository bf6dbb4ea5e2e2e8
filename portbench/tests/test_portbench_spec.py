"""BENCHMARK.json against the benchmark's contract, and the harness finding
configurations, mixes and metrics by name."""

import json
import re
import shutil

import pytest

from portbench.harness.spec import BENCH_DIR, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    e2e = m in SPEC["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    spec = Spec()
    cells = m.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for w in cells:
        assert m["moves"] in {e["name"] for e in spec.end_to_end(w)}, (m["name"], w)
        assert m in spec.per_layer(w)
    assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    spec = Spec()
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg = spec.config(w["config"])
    assert callable(spec.reference(cfg["reference"]).MODEL)
    assert spec.mix(w["traffic"])["kind"] == "train_epoch"
    assert spec.limits(w["name"])
    reported = {e["name"] for e in spec.end_to_end(w["name"])}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer(w["name"])


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds a configuration's cell, a mix and a metric as
    new files and entries: the harness reads them with no edit of its own."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR / "configs", bench / "configs")
    shutil.copytree(BENCH_DIR / "mixes", bench / "mixes")
    shutil.copytree(BENCH_DIR / "metrics", bench / "metrics")
    shutil.copytree(BENCH_DIR / "limits", bench / "limits")
    spec_data = json.loads(json.dumps(SPEC))
    mix = json.loads((BENCH_DIR / "mixes" / "train_celeba_b128.json").read_text())
    mix["batch"] = 64
    (bench / "mixes" / "train_celeba_b64.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy_ms.train.py").write_text(
        "SPANS = ['m:f']\n\ndef read(ctx):\n    return 1.5\n")
    (bench / "limits" / "train.celeba64_attn.b64.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.1}}))
    spec_data["workloads"].append({"name": "train.celeba64_attn.b64", "config": "celeba64_attn",
                                   "traffic": "train_celeba_b64", "chips": 1, "why": "x"})
    spec_data["per_layer"].append({"name": "dummy_ms.train", "unit": "ms", "better": "lower",
                                   "source": "device_trace", "layer": "kernels",
                                   "moves": "train_images_per_s",
                                   "workloads": ["train.celeba64_attn.b64"]})
    spec_data["end_to_end"][0]["workloads"].append("train.celeba64_attn.b64")
    for c in spec_data["configs"]:
        c["file"] = "portbench/configs/" + c["name"] + ".json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_data))
    spec = Spec(tmp_path, bench)
    assert spec.mix("train_celeba_b64")["batch"] == 64
    names = [m["name"] for m in spec.per_layer("train.celeba64_attn.b64")]
    assert "dummy_ms.train" in names and "step_device_ms.train" not in names
    reader = spec.reader("dummy_ms.train")
    assert reader.SPANS == ["m:f"] and reader.read(None) == 1.5
    assert spec.driver(spec.mix("train_celeba_b64")["kind"]).run
    assert spec.limits("train.celeba64_attn.b64") == {"loss_gap": 0.1}


def test_a_reference_module_is_found_by_name(tmp_path):
    """A configuration's ``reference`` names a new file of ``reference/``;
    an unknown name fails with the path it looked for."""
    bench = tmp_path / "portbench"
    (bench / "reference").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (bench / "reference" / "plain_x.py").write_text(
        "from .dit import DiTRef\n\n\nclass MODEL(DiTRef):\n    pass\n\n\n"
        "def fwd_flops(m, batch):\n    return 5 * batch\n")
    spec = Spec(tmp_path, bench)
    mod = spec.reference("plain_x")
    assert mod.MODEL.__mro__[1].__name__ == "DiTRef" and mod.fwd_flops({}, 3) == 15
    with pytest.raises(FileNotFoundError, match=str(bench / "reference" / "nope.py")):
        spec.reference("nope")
    (bench / "reference" / "no_model.py").write_text("X = 1\n")
    with pytest.raises(AttributeError, match="no MODEL"):
        spec.reference("no_model")


def test_a_metric_of_another_cell_takes_the_reader_its_name_begins_with():
    have = ["mfu.train", "mfu", "train_images_per_s", "setup_s"]
    assert Spec.base("mfu.train", have) == "mfu.train"
    assert Spec.base("mfu.train_256", have) == "mfu.train"
    assert Spec.base("mfu.serve", have) == "mfu"
    assert Spec.base("train_images_per_s_256", have) == "train_images_per_s"
    assert Spec.base("mfux", have) is None and Spec.base("setup", have) is None
    spec = Spec()
    assert spec.reader("step_device_ms.train_256").__file__.endswith("step_device_ms.train.py")


def test_command_names_only_the_benchmark():
    assert SPEC["command"][0] == "python3"
    for word in SPEC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in SPEC["paths"])
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
