"""A run's last line and its exits, driven on the CPU at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from ._tiny import ROOT, run_tiny

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["pt1080-sponza", "bake4096-sponza",
                                  "pt1080-sponza-alpha"])
def test_last_line_keys(cell):
    result, lines = run_tiny(cell)
    json.loads(json.dumps(result))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert DEVICE_KEYS <= set(result["device"])
    assert "setup_s" in result["metrics"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for name, c in result["check"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check {name} ") for line in lines)


def test_traced_line_keys():
    result, _ = run_tiny("pt1080-sponza", trace=1, seconds=4.0)
    assert list(result)[-1] == "check"
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    assert "setup_s" not in result["metrics"]
    assert "sun_grid_build_s" in result["metrics"]


def _main(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload", "pt1080-sponza",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_no_result():
    proc = _main(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _main(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
