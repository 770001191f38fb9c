"""The harness finds every configuration, traffic mix, scene, mode, metric
and limit by the name BENCHMARK.json gives, files added later included,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from ptbench import run as R

from ._tiny import ROOT, bench, cell_parts

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_is_found_by_name():
    b = bench()
    for cell in b["workloads"]:
        config = R.load_config(cell["config"])
        traffic = R.load_traffic(cell["traffic"])
        assert R.load_limits(cell["name"])
        mode = R.load_mode(config["mode"])
        assert hasattr(mode, "Runner")
        assert (R.ROOT / "scenes" / f"{traffic['scene']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(R.load_metric(m["name"]).read)


@pytest.mark.parametrize("traffic,tris,materials,opacity", [
    ("sponza", 246_084, 25, 0), ("sponza-alpha", 246_852, 26, 1)])
def test_scenes_build_by_name(traffic, tris, materials, opacity):
    """Each traffic's scene at its triangle count, with Sponza's materials
    and a map of the traffic's size in each of four slots a material."""
    t = R.load_traffic(traffic)
    assert t["texture_size"] == 1024
    desc = R.load_scene(dict(t, texture_size=8))
    assert sum(m.indices.size // 3 for m in desc.meshes) == tris
    assert len(desc.materials) == materials
    used = {m.material_idx for m in desc.meshes}
    assert used == set(range(materials))
    sizes = {name: data.shape for name, data in desc.textures}
    for m in desc.materials:
        for slot in ("albedo", "normal", "roughness", "metallic"):
            assert sizes[m[slot]] == (8, 8, 4)
        assert sizes[m["emissive"]] == (1, 1, 4)
    assert sum(m["has_opacity"] for m in desc.materials) == opacity
    assert len(sizes) == 6 + 4 * materials + opacity


def _new_files(tmp_path, monkeypatch):
    """A copy of the harness's data files under tmp_path with a new
    configuration (`pt64`, mode `frame2`: frame.py under another name),
    traffic mix, scene, metric (`frames_done`) and limits for a cell
    `pt64-boxes`; ptbench's ROOT points at it. Returns (BENCHMARK.json
    with the cell and `frames_done` added, the cell)."""
    root = tmp_path / "ptbench"
    for kind in ("configs", "workloads", "scenes", "modes", "metrics",
                 "limits"):
        shutil.copytree(R.ROOT / kind, root / kind)
    (root / "configs" / "pt64.json").write_text(json.dumps({
        "mode": "frame2", "width": 32, "height": 16,
        "settings": {"max_path_length": 2, "sqrt_num_samples": 2,
                     "benchmark_mode": True},
        "traced_steps": 1, "check": {"count": 64, "what": "pixels"}}))
    (root / "workloads" / "boxes.json").write_text(json.dumps({
        "scene": "two_boxes",
        "camera": {"position": [0.0, 2.5, -10.0], "rotation": [0.0, 0.0]},
        "sun_direction": [0.26, 0.987, -0.16]}))
    (root / "scenes" / "two_boxes.py").write_text(
        "from ._materials import SceneDesc, default_material, "
        "default_textures\n"
        "from ._procedural import make_box\n\n\n"
        "def build(traffic):\n"
        "    return SceneDesc(meshes=[make_box((2.0, 2.0, 2.0), "
        "(0.0, 1.5, 0.0)), make_box((10.0, 0.25, 10.0))],\n"
        "                     textures=default_textures(),\n"
        "                     materials=[default_material()])\n")
    shutil.copy(R.ROOT / "modes" / "frame.py", root / "modes" / "frame2.py")
    (root / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    (root / "limits" / "pt64-boxes.json").write_text(
        json.dumps({"bad_px_pct": 0.0}))
    monkeypatch.setattr(R, "ROOT", root)

    b = bench()
    cell = {"name": "pt64-boxes", "config": "pt64", "traffic": "boxes",
            "chips": 1, "why": "test"}
    b["workloads"].append(cell)
    b["end_to_end"].append({"name": "frames_done", "unit": "frames",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["pt64-boxes"]})
    return b, cell


def _run_new_cell(b, cell, trace=0):
    import argparse
    args = argparse.Namespace(workload="pt64-boxes", seed=2**31 + 99,
                              seconds=0.3, trace=trace)
    result, _ = R.run(args, b, cell, R.load_config("pt64"),
                      R.load_traffic("boxes"), R.load_limits("pt64-boxes"),
                      "cpu")
    return result


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, traffic mix, scene, mode, metric and limits added as
    files, with a cell and a metric added to BENCHMARK.json's lists, are
    picked up by name, and the new cell runs end to end."""
    b, cell = _new_files(tmp_path, monkeypatch)
    config = R.load_config("pt64")
    traffic = R.load_traffic("boxes")
    assert R.load_scene(traffic).meshes
    names = [m["name"] for m in R.cell_metrics(b, "pt64-boxes",
                                                "end_to_end")]
    assert "frames_done" in names and "setup_s" in names
    assert "frame_ms" not in names  # listed for other cells only

    result = _run_new_cell(b, cell)
    assert result["correct"] is True
    assert result["metrics"]["frames_done"]["value"] == result["attempted"]


def test_a_renamed_frame_mode_reports_the_frame_metrics(tmp_path,
                                                        monkeypatch):
    """A mode under another name whose STEP is "frame" reports frame_ms and
    frame_ms_p95, and host_syncs.frame traced, once its cell is listed in
    their workloads: the readers key on the step, not on the mode's
    name."""
    b, cell = _new_files(tmp_path, monkeypatch)
    assert R.load_config("pt64")["mode"] == "frame2"
    assert R.load_mode("frame2").STEP == "frame"
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("frame_ms", "frame_ms_p95", "host_syncs.frame"):
            m["workloads"].append("pt64-boxes")
    result = _run_new_cell(b, cell)
    assert result["correct"] is True
    got = result["metrics"]
    assert {"frame_ms", "frame_ms_p95", "frames_done", "setup_s"} == set(got)
    assert got["frame_ms"]["value"] > 0 and got["frame_ms"]["unit"] == "ms"
    assert got["frame_ms_p95"]["value"] > 0
    traced = _run_new_cell(b, cell, trace=1)
    assert traced["correct"] is True
    # the CPU counts no host syncs
    assert traced["metrics"] == {"host_syncs.frame": {"value": 0.0,
                                                      "unit": "syncs/frame"}}


def test_a_mode_without_step_is_refused_by_name(tmp_path, monkeypatch):
    root = tmp_path / "ptbench"
    (root / "modes").mkdir(parents=True)
    text = (R.ROOT / "modes" / "frame.py").read_text()
    (root / "modes" / "nostep.py").write_text(
        "\n".join(line for line in text.splitlines()
                  if not line.startswith("STEP =")) + "\n")
    monkeypatch.setattr(R, "ROOT", root)
    with pytest.raises(SystemExit, match=r"mode nostep \(modes/nostep.py\) "
                       r"declares no STEP"):
        R.load_mode("nostep")


def test_every_mode_declares_its_step():
    modes = [p.stem for p in (R.ROOT / "modes").glob("*.py")
             if not p.stem.startswith("_")]
    steps = {m: R.load_mode(m).STEP for m in modes}
    assert all(steps.values()), steps
    assert steps["frame"] == "frame" and steps["bake"] == "bake"


WIDTH_KEYS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                        r"projection|head|expansion|per_tok")


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["ptbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("ptbench/")
        assert (ROOT / c["file"]).is_file()
        assert not any(WIDTH_KEYS.search(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    cells = {w["name"]: w for w in b["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)

    def reports(m, cell):
        return cell in m.get("workloads", list(cells))

    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", list(cells)):
            assert cell in cells and reports(e2e[m["moves"]], cell), (
                m["name"], cell)
    for cell in cells:
        got = [m for m in b["end_to_end"] if reports(m, cell)]
        assert len(got) >= 2 and any(m["name"] == "setup_s" for m in got)
        assert any(reports(m, cell) for m in b["per_layer"])


@pytest.mark.parametrize("cell", ["pt1080-sponza", "bake4096-sponza",
                                  "pt1080-sponza-alpha"])
def test_cell_files_name_each_other(cell):
    _, c, config, traffic, limits = cell_parts(cell)
    assert config["mode"] in ("frame", "bake") and traffic["scene"]
    assert set(limits) and all(v >= 0 for v in limits.values())
