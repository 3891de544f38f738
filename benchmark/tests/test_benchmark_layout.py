"""The benchmark is driven by its files: a new workload file is a new
cell with no edit to code; names it does not define are refused; names
and units keep the contract's characters; traffic repeats per seed; and
nothing it runs imports JAX or the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from benchmark import spec, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def test_every_cell_loads():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m.name for m in cell.end_to_end]


def test_a_new_workload_file_is_a_new_cell(tmp_path):
    root = tiny.copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "cub_sample_plain_bf16_b128", "config": "cub_dmgan",
        "traffic": "sample_cub_b128", "chips": 1, "why": "plain tail"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].split(".")[-1] == "sample" or m["name"] in (
                "sample_images_per_s", "sample_p95_ms"):
            m["workloads"].append("cub_sample_plain_bf16_b128")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "workloads" / "cub_sample_plain_bf16_b128.json").write_text(
        json.dumps({"entry": "sample", "fused_tail": False,
                    "limits": {"img_gap": 1}}))
    cell = spec.load_cell("cub_sample_plain_bf16_b128", root)
    assert (cell.entry, cell.fused_tail) == ("sample", False)
    assert {m.name for m in cell.end_to_end} == {
        "sample_images_per_s", "sample_p95_ms", "setup_s"}
    assert "k3_roofline.sample" in {m.name for m in cell.per_layer}


@pytest.mark.parametrize("field, value", [
    ("workload", "no_such_cell"), ("config", "no_such_config"),
    ("traffic", "no_such_traffic"), ("entry", "no_such_entry"),
    ("metric", "no_such_metric.train")])
def test_unknown_names_are_refused(tmp_path, field, value):
    root = tiny.copy(tmp_path)
    name = "cub_train_bf16_b16"
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == name)
    if field in ("config", "traffic"):
        w[field] = value
    elif field == "metric":
        bench["per_layer"].append({
            "name": value, "unit": "%", "better": "higher",
            "source": "device_trace", "layer": "device",
            "moves": "train_images_per_s", "workloads": [name]})
    elif field == "entry":
        path = root / "workloads" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["entry"] = value
        path.write_text(json.dumps(cell))
    else:
        name = value
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError):
        spec.load_cell(name, root)


@pytest.mark.parametrize("name, ok", [
    ("cub_train_bf16_b16", True), ("mfu.train", True), ("_x-1.y", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a,b", False), ("a/b", False), (".lead", False), ("", False),
    ("µs", False)])
def test_name_rule(name, ok):
    if ok:
        assert spec.check_name(name, "x") == name
    else:
        with pytest.raises(spec.SpecError):
            spec.check_name(name, "x")


@pytest.mark.parametrize("unit, ok", [
    ("images/s", True), ("%", True), ("ms", True), ("kernels", True),
    ("a" * 16, True), ("a" * 17, False), ("images per s", False),
    ("", False), ("µs", False)])
def test_unit_rule(unit, ok):
    if ok:
        assert spec.check_unit(unit, "x") == unit
    else:
        with pytest.raises(spec.SpecError):
            spec.check_unit(unit, "x")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    spec.load_benchmark(ROOT)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "traffic").glob("*.json")))
def test_traffic_repeats_per_seed(name):
    t = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    t.update({k: v for k, v in tiny.TINY_TRAFFIC.items() if k in t})
    w = json.loads((ROOT / "configs" / "cub_dmgan.json").read_text())[
        "widths"]
    seed = 2 ** 31 + 77

    def flat(batches):
        out = []
        for b in batches:
            for k in sorted(b):
                out += b[k] if k == "images" else [b[k]]
        return out

    a = flat(traffic.batches(t, seed, "cpu", w))
    b = flat(traffic.batches(t, seed, "cpu", w))
    c = flat(traffic.batches(t, seed + 1, "cpu", w))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    # Every seed the same sizes.
    assert [x.shape for x in a] == [x.shape for x in c]
    first = traffic.batches(t, seed, "cpu", w)[0]
    n = first["mask"].sum(-1) - 2
    lo, hi = t["caption_tokens"]
    assert int(n.min()) >= lo and int(n.max()) <= hi
    assert (first["ids"][:, 0] == traffic.SOS).all()
    if "mis_captions" in t:
        m1 = traffic.MisCaptions(t, seed, w)
        m2 = traffic.MisCaptions(t, seed, w)
        cls = np.arange(t["batch"]) % t["classes"]
        (i1, k1), (i2, k2) = m1.draw(cls), m2.draw(cls)
        assert np.array_equal(i1, i2) and np.array_equal(k1, k2)
        assert i1.shape == (t["batch"], t["mis_captions"], w["WORDS_NUM"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "t2igan"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in ROOT.rglob("*.py")))
def test_no_jax_import(path):
    """Top-level names compared whole: ``t2igan_torch`` is not
    ``t2igan``; the reference imports nothing of the port either."""
    tops = {m.split(".")[0] for m in _imports(ROOT / path)}
    assert not tops & FORBIDDEN
    if path.startswith("reference"):
        assert "t2igan_torch" not in tops


def test_what_a_run_loads_holds_no_jax():
    """Every module of the benchmark and what it loads of the program, in
    a fresh interpreter: no module of JAX or the JAX package."""
    code = (
        "import sys, pathlib\n"
        "from benchmark import run, harness, spec\n"
        "root = spec.HERE\n"
        "for d in ('entries', 'metrics'):\n"
        "    for p in sorted((root / d).glob('*.py')):\n"
        "        spec.load_module(p, d + '_' + p.stem)\n"
        "import benchmark.reference.train, benchmark.reference.infer\n"
        "import t2igan_torch.train.train_gan, t2igan_torch.generate\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "t2igan_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
