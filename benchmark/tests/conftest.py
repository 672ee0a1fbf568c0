"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at Tiny
sizes in a temporary directory, found by the same names."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_SSM = {
    "base": {"layer": "Mamba", "d_state": 8, "d_conv": 4, "expand": 2, "dt_rank": 4},
    "base_m2": {"layer": "Mamba2", "d_state": 16, "d_conv": 4, "expand": 2, "headdim": 16,
                "ngroups": 1, "chunk_size": 8, "norm_epsilon": 1e-5},
}
TINY_LIMITS = {"stream": {"pool_err": 0.03, "state_err": 0.03},
               "train": {"loss_err": 0.005, "grad_err": 0.03, "leaf_grad_err": 0.06,
                         "change_err": 0.06}}


def make_tiny(dest) -> str:
    """The benchmark copied under ``dest`` with Tiny configurations
    (embed 32, depth 2, 32 x 32 frames), small mixes and Tiny limits.
    Returns the copy's root (holding BENCHMARK.json and benchmark/)."""
    root = os.path.join(dest, "tiny")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    files = os.path.join(root, "benchmark")
    for name, ssm in TINY_SSM.items():
        path = os.path.join(files, "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(img_size=32, patch_size=16, embed_dim=32, depth=2, num_frames=4, ssm_cfg=ssm)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tweaks = {"stream64": dict(streams=2, chunk_frames=4, video_chunks=3, height=32, width=32,
                               checked_cycles=2, checked_chunks=2, traced_chunks=3),
              "pretrain": dict(batch=4, frames=4, height=32, width=32, mask_ratio=0.5,
                               batch_pool=2, reference_rows=2, traced_steps=2)}
    for mix, over in tweaks.items():
        path = os.path.join(files, "traffic", f"{mix}.json")
        with open(path) as f:
            data = json.load(f)
        data.update(over)
        with open(path, "w") as f:
            json.dump(data, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell in spec["workloads"]:
        kind = "stream" if cell["traffic"] == "stream64" else "train"
        path = os.path.join(files, "limits", f"{cell['name']}.json")
        with open(path) as f:
            launches = json.load(f)["launches"]
        with open(path, "w") as f:
            json.dump(dict(TINY_LIMITS[kind], launches=launches), f)
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("bench")))
