"""The harness on the CPU: ``BENCHMARK.json`` keeps the contract's forms,
every per-layer metric moves an end-to-end metric that its cells report,
a configuration, a traffic mix, a traffic kind and a metric added as new
files are found without an edit to any file, a cell loads nothing of JAX,
and the command without a card fails loudly instead of falling back to the
CPU."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.run import Bench, run_cell

from .tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["port_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])


def test_names_units_and_texts_use_the_allowed_characters():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    texts = [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]
    texts += [c["source"] for c in SPEC["configs"]] + [c["why"] for c in SPEC["configs"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert all(m["better"] in ("lower", "higher") for m in SPEC["end_to_end"] + SPEC["per_layer"])


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    bench = Bench()
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])
        assert w["chips"] in (1, 4)
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = Bench()
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(cell)}, (m["name"], cell)
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").exists()


def test_configurations_and_traffic_files_are_found_by_name():
    bench = Bench()
    for w in SPEC["workloads"]:
        cfg = bench.config(w["config"])
        assert (ROOT / "port_bench" / "families" / f"{cfg['family']}.py").exists()
        kind = bench.traffic(w["traffic"])["kind"]
        assert (ROOT / "port_bench" / "loops" / f"{kind}.py").exists()
    for c in SPEC["configs"]:
        assert c["file"].startswith("port_bench/") and c["reduced"] == []


def test_new_files_are_found_without_an_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic kind, a
    traffic mix of that kind, a metric and a cell as new files and entries
    only; the harness runs the new cell through the new kind, hands it the
    cell's count of cards, takes what it reports of its devices, and
    reports the new metric."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    base = json.loads((ROOT / "port_bench/configs/gpt_flowers256.json").read_text())
    (tmp_path / "port_bench/configs/gpt_tiny.json").write_text(json.dumps(tiny(base)))
    (tmp_path / "port_bench/loops/serve_tagged.py").write_text(
        "from port_bench.loops.serve_closed import run as closed\n\n\n"
        "def run(fam, cfg, traffic, seed, seconds, trace, device, setup_started, chips=1):\n"
        "    res = closed(fam, cfg, traffic, seed, seconds, trace, device, setup_started, chips)\n"
        "    res['device'] = {'ranks_seen': chips}\n"
        "    return res\n")
    (tmp_path / "port_bench/traffic/serve_tagged_2.json").write_text(json.dumps(
        {"kind": "serve_tagged", "images": 2, "greedy_every": 2, "profile_after": 1,
         "profile_requests": 1}))
    (tmp_path / "port_bench/metrics/requests_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['result']['attempted'])\n")
    spec["configs"].append({"name": "gpt_tiny", "source": "https://example.org/tiny",
                            "file": "port_bench/configs/gpt_tiny.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "gpt_tiny.serve", "config": "gpt_tiny",
                              "traffic": "serve_tagged_2", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("serve_images_per_s", "serve_p90_s"):
            m["workloads"].append("gpt_tiny.serve")
    spec["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "whole request",
                              "moves": "serve_images_per_s", "workloads": ["gpt_tiny.serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path, tmp_path / "port_bench")
    line = run_cell(bench, "gpt_tiny.serve", 2 ** 33 + 5, 0.5, True, device="cpu")
    assert line["correct"] is True
    assert line["metrics"]["requests_seen"]["value"] == line["attempted"]
    assert line["device"]["ranks_seen"] == line["device"]["count"] == 1


def test_a_kind_of_one_card_refuses_a_cell_on_four(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["chips"] = 4
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path, ROOT / "port_bench")
    name = spec["workloads"][0]["name"]
    cfg = tiny(Bench().config(bench.cell(name)["config"]))
    with pytest.raises(ValueError, match="4 cards"):
        run_cell(bench, name, 7, 0.1, False, device="cpu", config=cfg)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_cell_loads_nothing_of_jax(cell):
    code = ("import json, sys; from port_bench.run import Bench, run_cell, forbidden_modules;"
            "from port_bench.tests.tiny import tiny; b = Bench(); c = b.cell(sys.argv[1]);"
            "run_cell(b, sys.argv[1], 3, 0.2, False, 'cpu', tiny(b.config(c['config'])));"
            "print(json.dumps(forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, cell], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "gpt.serve",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_the_command_without_a_card_fails_loudly():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _command(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
