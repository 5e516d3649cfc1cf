"""BENCHMARK.json finds every file it names, and every cell reports
set-up, another end-to-end metric and a per-layer one."""
import re

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_its_file():
    b = spec.benchmark()
    for c in b["configs"]:
        f = spec.config_file(b, c["name"])
        assert NAME.match(c["name"]) and f["arch"] and f["run"]
        assert c["source"] == f["source"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert {"prompt_tokens", "output_tokens"} <= set(
            spec.traffic(w["traffic"]))
        limits = spec.cell(w["name"])["check"]["limits"]
        assert limits and set(limits) <= {"max_gap", "mean_gap"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and callable(spec.reader(m["name"]))


def test_every_cell_reports_what_the_contract_asks():
    b = spec.benchmark()
    for w in b["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(b, w["name"], False)]
        layer = spec.metrics_of(b, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def _run(cwd, root):
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, str(root / "perfbench" / "run.py"), "--workload",
         "glm4-9b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_no_result_without_a_card():
    p = _run(spec.ROOT, spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
