"""The frozen operation and byte counts against hand counts at Base shapes,
and the weight layout against the port's parameters."""

import json
import math
import os

import pytest
import torch

from conftest import ROOT

from benchmark import weights
from benchmark.flops import kernels, model

L = 1569  # one 8-frame Base clip with CLS
BASE = dict(batch=1, seqlen=L, embed=768, d_inner=1536, d_state=16, dt_rank=48, width=4)
BASE_M2 = dict(batch=1, seqlen=L, embed=768, nheads=24, hdim=64, ngroups=1, d_state=64,
               width=4, chunk=128)


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_block_fused_counts_by_hand():
    in_proj, out_proj = 2 * L * 768 * 3072, 2 * L * 1536 * 768
    x_proj, dt_proj = 2 * L * 1536 * 80, 2 * L * 48 * 1536
    conv, walk, norm = 2 * 4 * L * 1536, 6 * L * 1536 * 16, 8 * L * 768
    assert kernels.block_flops(BASE, "bf16") == {
        "bf16": in_proj + out_proj + x_proj + dt_proj, "fp32": conv + walk + norm}
    weights_bf16 = 2 * (3072 * 768 + 768 * 1536 + 1536 * 4 + 1536 + 80 * 1536 + 1536 * 48)
    params_fp32 = 4 * (768 + 1536 + 1536 * 16 + 1536)
    reads = L * 768 * (2 + 4) + weights_bf16 + params_fp32 + 4 * (1536 * 16 + 1536 * 4)
    writes = L * 768 * (2 + 4) + 4 * 1536 * 16
    assert kernels.block_fused_bytes(BASE, "bf16") == reads + writes
    # The bound chip_smoke.py printed for K4 bf16 at this shape (PERF.md's table).
    assert kernels.bound(reads + writes, kernels.block_flops(BASE, "bf16"))["bound_ms"] == \
        pytest.approx(0.0157, abs=5e-5)


def test_mixer_bwd_counts_by_hand():
    products = 3 * (2 * L * 1536 * 80 + 2 * L * 48 * 1536)
    fp32 = 3 * 2 * 4 * L * 1536 + 26 * L * 16 * 1536
    assert kernels.mixer_flops(L, 1, 1536, 16, 48, 4, "fp32", backward=True) == \
        {"fp32": products + fp32}
    assert kernels.mixer_flops(1, L, 1536, 16, 48, 4, "bf16", backward=True) == \
        {"bf16": products, "fp32": fp32}
    acts = L * 1536
    w = 2 * (1536 * 4 + 1536 + 80 * 1536 + 1536 * 48) + 4 * (1536 + 1536 * 16 + 1536)
    grads = 4 * (1536 * 4 + 1536 + 80 * 1536 + 1536 * 48 + 1536 + 1536 * 16 + 1536)
    states = 4 * (1536 * 4 + 1536 * 16)
    assert kernels.mixer_bwd_bytes(BASE, "bf16") == \
        3 * 2 * acts + w + states + 2 * 2 * acts + grads + states
    assert kernels.bound(0, kernels.mixer_flops(1, L, 1536, 16, 48, 4, "fp32", True)
                         )["bound_ms"] == pytest.approx(0.0435, abs=5e-5)


def test_ssd_counts_by_hand():
    di, cd, dpj = 1536, 1536 + 128, 2 * 1536 + 128 + 24
    chunk_products = L * (128 * (64 + 1536) + 4 * 24 * 64 * 64)
    projections = 2 * L * 768 * (dpj + di)
    epilogue = L * (2 * 4 * cd + 12 * di)
    assert kernels.ssd_flops(BASE_M2, "bf16") == {
        "bf16": chunk_products + projections, "fp32": epilogue}
    assert kernels.bound(0, kernels.ssd_flops(BASE_M2, "fp32"))["bound_ms"] == \
        pytest.approx(0.1860, abs=5e-5)
    bwd = 2 * L * (64 * (64 + 2 * 24 * 128) + 4 * 24 * 64 * 64)
    assert kernels.ssd_bwd_flops(BASE_M2, "bf16") == {
        "bf16": bwd, "fp32": L * (4 * 4 * cd + 20 * di)}
    assert kernels.bound(0, kernels.ssd_bwd_flops(BASE_M2, "fp32"))["bound_ms"] == \
        pytest.approx(0.0384, abs=5e-5)
    w = 2 * (dpj * 768 + 768 * di + cd * 4 + cd) + 4 * (3 * 24 + di)
    states = 4 * (24 * 64 * 64 + cd * 4)
    assert kernels.ssd_pmixer_bytes(BASE_M2, "bf16") == \
        2 * 2 * L * 768 + w + states + 4 * 24 * 64 * 64
    params = 4 * (cd * 4 + cd + 2 * 24 + di)
    assert kernels.ssd_mixer_bwd_bytes(BASE_M2, "bf16") == (
        2 * L * (dpj + di) + 4 * L * 24 + params + states) + (
        2 * L * dpj + 4 * L * 24 + params + states)


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert kernels.bound(int(3.35e12), {"bf16": 0.0})["bound_ms"] == pytest.approx(1e3)
    assert kernels.bound(0, {"bf16": 989e12, "fp32": 67e12})["bound_by"] == "operations"
    assert kernels.bound(0, {"bf16": 989e12, "fp32": 67e12})["bound_ms"] == pytest.approx(2e3)


def test_model_step_operations_by_hand():
    base = 2 * (768 * 3072 + 1536 * 80 + 48 * 1536 + 1536 * 768) + 6 * 1536 * 16 + 2 * 4 * 1536
    assert model.block_forward_flops_per_token(config("base")) == base
    assert 24 * base == 183_140_352  # about 183 MFLOP a token
    m2 = (2 * (768 * (2 * 1536 + 128 + 24) + 1536 * 768)
          + 128 * (64 + 1536) + 4 * 24 * 64 * 64 + 2 * 4 * 1664)
    assert model.block_forward_flops_per_token(config("base_m2")) == m2
    assert model.patch_flops_per_token(config("base")) == 2 * 768 * 768
    assert model.train_step_flops(config("base"), 10, 20) == \
        3 * (24 * 10 * base + 20 * 2 * 768 * 768)


@pytest.mark.parametrize("name", ["base", "base_m2"])
def test_weight_layout_is_the_ports(name):
    """The names and shapes of weights.spec are the port's parameters, at a
    small width (the same code builds every width), and the count matches
    the configuration file's."""
    from benchmark import program

    cfg = config(name)
    assert weights.count(cfg) == cfg["parameters"]
    small = dict(cfg, embed_dim=64, depth=2, img_size=32)
    ssm = dict(small["ssm_cfg"])
    if ssm["layer"] == "Mamba":
        ssm["dt_rank"] = 4
    else:
        ssm.update(headdim=16, d_state=16)
    small["ssm_cfg"] = ssm
    w = weights.make(small, 7, "cpu")
    net = program.build_model(small, weights.make(small, 7, "cpu"))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in w.items()}
    assert torch.equal(weights.make(small, 7, "cpu")["norm.weight"], w["norm.weight"])
    assert not torch.equal(weights.make(small, 8, "cpu")["norm.weight"], w["norm.weight"])
    assert sum(math.prod(s) for _, s, _, _ in weights.spec(small)) == \
        sum(p.numel() for p in net.parameters())
