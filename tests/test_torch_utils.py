"""The port's training utilities vs videomamba_tpu's on the CPU.

The config, DeepSpeed / ZeRO, MetricLogger and compute-helper cases of
tests/test_utils.py, run on the port's modules; the config loaders' output
held equal to the JAX ``Config``'s on the same files; the logger's per-rank
files, the trackers degrading without their packages, and
``profiling.trace`` writing a trace on the CPU.
"""

import json
import logging
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from videomamba_tpu.utils.config import Config as JConfig
from videomamba_tpu_torch.utils.config import Config, eval_dict_leaf, eval_string
from videomamba_tpu_torch.utils.config_utils import (
    setup_deepspeed_config,
    setup_deepspeed_zero_config,
    zero_stage_to_mesh_plan,
)
from videomamba_tpu_torch.utils.easydict import EasyDict


def test_setup_deepspeed_zero_config_invalid_stage_raises_value_error():
    with pytest.raises(ValueError, match="Wrong stage for deepspeed 4"):
        setup_deepspeed_zero_config(4)


def test_zero_stage_to_mesh_plan():
    from videomamba_tpu.utils.config_utils import zero_stage_to_mesh_plan as j_plan

    assert zero_stage_to_mesh_plan(0, 8) == {"dp": 8, "fsdp": 1, "tp": 1}
    assert zero_stage_to_mesh_plan(3, 8) == {"dp": 1, "fsdp": 8, "tp": 1}
    plan = zero_stage_to_mesh_plan(2, 16)
    assert plan["dp"] * plan["fsdp"] * plan["tp"] == 16
    for stage in range(4):
        for n in (1, 2, 4, 8, 16, 32):
            assert zero_stage_to_mesh_plan(stage, n) == j_plan(stage, n)


def _ds_config(tmp_path, name, fp16):
    config = SimpleNamespace(
        output_dir=str(tmp_path / name),
        batch_size=4,
        optimizer=SimpleNamespace(lr=1e-4, weight_decay=0.01, opt_betas=(0.9, 0.999)),
        deepspeed=SimpleNamespace(stage=1, enable=True),
        fp16=fp16,
        bf16=True,
    )
    config.get = lambda key, default=None: getattr(config, key, default)
    return config


def test_setup_deepspeed_config_uses_world_size_one_without_dist_init(tmp_path):
    config = _ds_config(tmp_path, "ds_cfg", fp16=True)
    setup_deepspeed_config(config)
    with open(config.deepspeed_config, "r") as f:
        ds_config = json.load(f)
    assert ds_config["train_batch_size"] == 4
    assert ds_config["train_micro_batch_size_per_gpu"] == 4


def test_setup_deepspeed_config_accepts_bf16_without_fp16(tmp_path):
    """The JSON, byte for byte the JAX module's for the same config."""
    from videomamba_tpu.utils.config_utils import setup_deepspeed_config as j_setup

    config = _ds_config(tmp_path, "ds_cfg_bf16", fp16=False)
    setup_deepspeed_config(config)
    with open(config.deepspeed_config, "r") as f:
        text = f.read()
    ds_config = json.loads(text)
    assert ds_config["zero_optimization"]["stage"] == 1
    assert ds_config["bf16"]["enabled"] is True
    assert "fp16" not in ds_config
    jconfig = _ds_config(tmp_path, "ds_cfg_bf16_jax", fp16=False)
    j_setup(jconfig)
    with open(jconfig.deepspeed_config, "r") as f:
        assert f.read() == text


class TestConfig:
    def test_config_from_file_python_module_cache_does_not_collide(self, tmp_path):
        cfg_a_dir = tmp_path / "a"
        cfg_b_dir = tmp_path / "b"
        cfg_a_dir.mkdir()
        cfg_b_dir.mkdir()
        (cfg_a_dir / "cfg.py").write_text("value = 1\n", encoding="utf-8")
        (cfg_b_dir / "cfg.py").write_text("value = 2\n", encoding="utf-8")

        assert Config.from_file(str(cfg_a_dir / "cfg.py")).value == 1
        assert Config.from_file(str(cfg_b_dir / "cfg.py")).value == 2

    def test_base_inheritance_and_duplicate_rejection(self, tmp_path):
        (tmp_path / "base1.py").write_text("a = 1\n")
        (tmp_path / "base2.py").write_text("b = 2\n")
        (tmp_path / "child.py").write_text(
            "_base_ = ['base1.py', 'base2.py']\nc = 3\na = 10\n"
        )
        cfg = Config.from_file(str(tmp_path / "child.py"))
        assert cfg.a == 10 and cfg.b == 2 and cfg.c == 3
        assert cfg == JConfig.from_file(str(tmp_path / "child.py"))

        (tmp_path / "dup1.py").write_text("x = 1\n")
        (tmp_path / "dup2.py").write_text("x = 2\n")
        (tmp_path / "bad.py").write_text("_base_ = ['dup1.py', 'dup2.py']\n")
        with pytest.raises(KeyError, match="Duplicate key"):
            Config.from_file(str(tmp_path / "bad.py"))

    def test_yaml_and_json(self, tmp_path):
        (tmp_path / "c.yaml").write_text("a: 1\nnested:\n  b: two\n")
        cfg = Config.from_file(str(tmp_path / "c.yaml"))
        assert cfg.a == 1 and cfg.nested.b == "two"
        (tmp_path / "c.json").write_text('{"a": 5}')
        assert Config.from_file(str(tmp_path / "c.json")).a == 5

    def test_merge_list_dotted_overrides(self):
        cfg = EasyDict({"a": {"b": 1}, "c": 2})
        out = Config.merge_list(cfg, ["a.b", 7, "c", 9])
        assert out.a.b == 7 and out.c == 9
        with pytest.raises(ValueError, match="not exist"):
            Config.merge_list(cfg, ["a.zz", 1])

    def test_eval_string_coercions(self):
        d = EasyDict({"lr": 0.1, "sched": {"steps": 100}})
        assert eval_string("0", d) == 0
        assert eval_string("0.2", d) == 0.2
        assert eval_string("[0, 1, 2]", d) == [0, 1, 2]
        assert eval_string("eval(1+2)", d) == 3
        assert eval_string("eval(list(range(5)))", d) == [0, 1, 2, 3, 4]
        assert eval_string("${lr}", d) == 0.1
        assert eval_string("${sched.steps}", d) == 100
        assert eval_string("plain_string", d) == "plain_string"

    def test_eval_string_is_sandboxed(self):
        d = EasyDict({})
        with pytest.raises(Exception):
            eval_string("eval(__import__('os').system('true'))", d)

    def test_eval_dict_leaf(self):
        d = EasyDict({"a": "1", "nested": {"b": "eval(2*3)", "ref": "${a}"}})
        out = eval_dict_leaf(d)
        assert out.a == 1 and out.nested.b == 6


@pytest.mark.parametrize("suffix", [".py", ".yaml", ".json"])
def test_loaders_match_the_jax_config(tmp_path, suffix):
    """The same files (a base and a child overriding a nested key) through
    both packages' ``Config.from_file``, the leaves evaluated and the
    pretty text: equal."""
    tree = {"model": {"depth": 24, "embed_dim": 768, "name": "base"},
            "optimizer": {"lr": "1e-4", "betas": [0.9, 0.999]},
            "steps": "eval(2*50)", "warmup": "${steps}"}
    child = {"_base_": "base" + suffix, "model": {"depth": 4}, "tag": "run"}
    for name, data in (("base", tree), ("child", child)):
        path = tmp_path / (name + suffix)
        if suffix == ".py":
            path.write_text("".join(f"{k} = {v!r}\n" for k, v in data.items()))
        elif suffix == ".yaml":
            import yaml

            path.write_text(yaml.safe_dump(data))
        else:
            path.write_text(json.dumps(data))
    got = Config.from_file(str(tmp_path / ("child" + suffix)))
    want = JConfig.from_file(str(tmp_path / ("child" + suffix)))
    assert got == want and got.model.depth == 4 and got.model.embed_dim == 768
    assert Config.pretty_text(got) == JConfig.pretty_text(want)
    from videomamba_tpu.utils.config import eval_dict_leaf as j_eval

    assert eval_dict_leaf(got) == j_eval(want)
    assert got.warmup == got.steps == 100 and got.optimizer.lr == 1e-4


def test_smoothed_value_and_metric_logger():
    from videomamba_tpu_torch.utils.basic_utils import MetricLogger, SmoothedValue

    v = SmoothedValue(window=3)
    for x in (1.0, 2.0, 3.0, 4.0):
        v.update(x)
    assert v.value == 4.0
    assert v.median == 3.0
    assert v.global_avg == pytest.approx(2.5)
    assert v.max == 4.0

    ml = MetricLogger()
    ml.update(loss=torch.tensor(0.5), acc=1.0)
    assert "loss" in str(ml)
    assert ml.get_global_avg_dict("p/")["p/loss"] == pytest.approx(0.5)
    with pytest.raises(TypeError, match="scalar"):
        ml.update(loss=torch.zeros(2))


def test_log_every_prints_no_memory_column_without_a_card(caplog):
    from videomamba_tpu_torch.utils.basic_utils import MetricLogger

    ml = MetricLogger()
    with caplog.at_level(logging.INFO, logger="videomamba_tpu_torch.utils.basic_utils"):
        for i in ml.log_every(range(3), log_freq=1, header="train"):
            ml.update(loss=float(i))
    lines = [r.getMessage() for r in caplog.records]
    assert any("[0/3]" in m and "loss: " in m for m in lines)
    assert not any("max mem" in m for m in lines) and "Total time" in lines[-1]


def test_compute_helpers():
    from videomamba_tpu_torch.utils.basic_utils import compute_acc, compute_n_params

    logits = torch.tensor([[0.1, 0.9], [0.8, 0.2]])
    labels = torch.tensor([1, 1])
    assert compute_acc(logits, labels) == pytest.approx(0.5)
    assert compute_acc(logits, labels, reduction="none").tolist() == [1.0, 0.0]

    params = {"a": torch.zeros((10, 10)), "b": torch.zeros((5,))}
    assert compute_n_params(params, return_str=False) == 105
    assert compute_n_params({"a": torch.zeros((2_000_000,))}) == "2.0M"
    assert compute_n_params(torch.nn.Linear(10, 10), return_str=False) == 110


def test_setup_seed_goes_through_configure_determinism():
    from videomamba_tpu_torch.utils.basic_utils import setup_seed

    saved = (torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        cfg = setup_seed(3)
        a = (np.random.rand(), torch.rand(1).item())
        setup_seed(3)
        assert (np.random.rand(), torch.rand(1).item()) == a and cfg.seed == 3
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_logger_files_per_rank(tmp_path, monkeypatch):
    from videomamba_tpu_torch.utils import logger as lg

    assert lg._rank_log_filename(str(tmp_path), 0) == str(tmp_path / "train.log")
    assert lg._rank_log_filename(str(tmp_path), 3) == str(tmp_path / "train.log") + ".rank3"
    assert lg._rank_log_filename(str(tmp_path / "x.txt"), 0) == str(tmp_path / "x.txt")
    saved = logging.root.handlers[:]
    try:
        for rank, name in ((0, "main"), (2, "other")):
            monkeypatch.setattr(lg, "get_rank", lambda r=rank: r)
            log = lg.setup_logger(output=str(tmp_path / name), color=False,
                                  name=f"vmt_test_{name}")
            log.info("hello %s", name)
            for h in log.handlers:
                h.flush()
            consoles = [h for h in log.handlers if getattr(h, "stream", None) is sys.stdout]
            assert len(consoles) == (1 if rank == 0 else 0)
        assert "hello main" in (tmp_path / "main" / "train.log").read_text()
        assert "hello other" in (tmp_path / "other" / "train.log.rank2").read_text()
    finally:
        for h in logging.root.handlers[:]:
            logging.root.removeHandler(h)
        for h in saved:
            logging.root.addHandler(h)
        logging.captureWarnings(False)


def test_trackers_degrade_without_their_packages(monkeypatch):
    from videomamba_tpu_torch.utils import logger as lg

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    cfg = SimpleNamespace(wandb=SimpleNamespace(enable=True, project="p", entity="e"),
                          output_dir="run")
    assert lg.setup_wandb(cfg) is None
    lg.log_dict_to_wandb({"loss": torch.tensor(1.0)}, step=0)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        lg.TensorboardLogger(log_folder="unused")


def test_profiling_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from videomamba_tpu_torch.utils.profiling import (
        StepTimer,
        annotate,
        device_memory_summary,
        trace,
    )

    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("two_products"):
            y = x @ x @ x
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "two_products" in names and "aten::mm" in names
    timer = StepTimer()
    assert timer.tick(y) >= 0.0 and timer.tick({"a": [y]}) >= 0.0
    assert "steps=2" in timer.summary()
    assert device_memory_summary() == {}
