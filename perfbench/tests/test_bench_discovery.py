"""A configuration, a cell, a metric and a kernel name added as files of
their own are found with no edit of any file already there."""

import json
import os
import shutil

from perfbench import harness, trace


def copy_root(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    return str(tmp_path)


def test_new_config_cell_and_metric(tmp_path):
    root = copy_root(tmp_path)
    man = harness.manifest(root)
    conf = harness.load_json(os.path.join(root, "perfbench/configs/"
                                          "r4rn.json"))
    conf["name"] = "r4rn_copy"
    with open(os.path.join(root, "perfbench/configs/r4rn_copy.json"),
              "w") as f:
        json.dump(conf, f)
    traffic = harness.load_json(harness.workload_path("r5blend.drive",
                                                      root))
    with open(harness.workload_path("r4rn_copy.drive", root), "w") as f:
        json.dump(dict(traffic, envs=64), f)
    with open(harness.metric_path("extra_ms.drive", root), "w") as f:
        f.write('UNIT = "ms"\nBETTER = "lower"\nSOURCE = "program_span"\n'
                'LAYER = "sampler"\nMOVES = "frames_per_s"\n\n'
                'def read(run):\n    return 1.5\n')
    man["configs"].append(dict(man["configs"][1], name="r4rn_copy",
                               file="perfbench/configs/r4rn_copy.json"))
    man["workloads"].append({"name": "r4rn_copy.drive",
                             "config": "r4rn_copy", "traffic": "drive",
                             "chips": 1, "why": "a copy"})
    for m in man["end_to_end"]:
        if "workloads" in m and "r5blend.drive" in m["workloads"]:
            m["workloads"].append("r4rn_copy.drive")
    man["per_layer"].append({"name": "extra_ms.drive", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "sampler", "moves": "frames_per_s",
                             "workloads": ["r4rn_copy.drive"]})
    entry, found, c = harness.find_cell(man, "r4rn_copy.drive", root)
    assert found["envs"] == 64 and c["name"] == "r4rn_copy"
    e2e, layer = harness.cell_metrics(man, "r4rn_copy.drive")
    assert {"frames_per_s", "frame_ms_p95", "setup_s"} <= \
        {m["name"] for m in e2e}
    assert [m["name"] for m in layer] == ["extra_ms.drive"]
    assert harness.reader("extra_ms.drive", root).read(None) == 1.5
    assert harness.generator(found).__name__.endswith("generators.drive")


def test_new_kernel_name_file(tmp_path):
    where = tmp_path / "rooflines"
    shutil.copytree(trace.ROOFLINES, where,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = trace.kernel_names("attention", str(where))
    (where / "attention.k7.names").write_text("# a new kernel\nk7_attn\n")
    after = trace.kernel_names("attention", str(where))
    assert after == before + ["k7_attn"]
    assert set(trace.roofline_ops(str(where))) == {"attention",
                                                    "texel_gather"}
