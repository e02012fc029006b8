"""A cell, a traffic mix, a configuration and a per-layer metric are
added by new files and new ``BENCHMARK.json`` entries alone: a throwaway
cell in a copy of the benchmark runs with its new metric, no existing
file edited."""

import dataclasses
import hashlib
import json
import shutil

import tiny

from hhbench import harness


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_throwaway_cell_by_new_files(tmp_path):
    root = tmp_path / "hhbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(root)
    # new files only: a configuration, a traffic mix, a cell and a metric
    cfg = json.loads((root / "configs" / "hh-tsf-l14-16f.json").read_text())
    cfg["name"] = "hh-tsf-l14-8f"
    cfg["visual"]["num_frames"] = cfg["decoder"]["num_frames"] = 8
    (root / "configs" / "hh-tsf-l14-8f.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "store_b64.json").read_text())
    (root / "traffic" / "store_b8.json").write_text(json.dumps(dict(traffic, batch=8)))
    cell = {"config": "hh-tsf-l14-8f", "traffic": "store_b8", "chips": 1, "why": "a throwaway cell",
            "params": {}, "limits": {"embed_rel_gap": 0.05, "boxes_gap": 0.05}}
    (root / "workloads" / "embed8.store_b8.json").write_text(json.dumps(cell))
    (root / "metrics" / "clips_traced.embed8.py").write_text("def read(run):\n    return run.traced_items or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "embed8.store_b8", "config": "hh-tsf-l14-8f", "traffic": "store_b8",
                               "chips": 1, "why": "a throwaway cell"})
    bench["end_to_end"][0]["workloads"].append("embed8.store_b8")
    bench["per_layer"].append({"name": "clips_traced.embed8", "unit": "clips", "better": "higher",
                               "source": "host_clock", "layer": "the harness", "moves": "embed_clips_per_s",
                               "workloads": ["embed8.store_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    new = harness.load_cell("embed8.store_b8", root=root)
    assert new.driver == "embed_store" and new.params["batch"] == 8
    assert [m["name"] for m in new.per_layer][-1] == "clips_traced.embed8"
    run = harness.Run(cell=dataclasses.replace(new, cfg=tiny.tiny_cfg(new.cfg),
                                               params={**new.params, **tiny.PARAMS["store_b64"], "batch": 2}),
                      seed=3, seconds=0.5, trace=True, device="cpu")
    run.cell.cfg["precision"]["visual"] = "float32"
    result = harness.load_driver(new.driver).run(run)
    values = harness.per_layer_values(run, root=root)
    assert values["clips_traced.embed8"]["value"] == 4.0
    assert harness.judge(result.check(), new.limits)[0]
    changed = {k for k, v in digest(root).items() if before.get(k, v) != v}
    assert not changed  # no existing file of the benchmark was edited
