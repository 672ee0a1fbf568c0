"""The hybrid Mamba-2 / attention language model (``models/hybrid_lm.py``,
IBM Granite-4.0-H's layer equations) against the benchmark's plain fp32
reference (``benchmark/reference/granite_hybrid.py``, loaded by its path)
at a small size on the CPU: the full forward, streaming through
``runtime.StreamingSession`` in uneven chunks (conv, SSM and KV state), a
prefill followed by one-token chunks, bf16, planted faults, the state
contract's attention entry, and the video models left as they were. The ``cuda`` tests (the attention kernel, the small model
in bf16 on the card) skip without a card; on the GPU machine (this file
imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_hybrid_lm.py -q
"""

import copy
import importlib.util
import os

import pytest
import torch

from videomamba_tpu_torch.models import granite_4_0_h_micro
from videomamba_tpu_torch.models.attention import Attention
from videomamba_tpu_torch.models.block import create_block
from videomamba_tpu_torch.models.hybrid_lm import HybridMambaLM
from videomamba_tpu_torch.models.presets import GRANITE_4_0_H_MICRO, videomamba_tiny
from videomamba_tpu_torch.ops.kernels.attention import attention_plain
from videomamba_tpu_torch.ops.norm import fused_add_norm
from videomamba_tpu_torch.runtime import DecodeSession, StreamingSession
from videomamba_tpu_torch.streaming import (
    KVCache,
    KVStateShape,
    StateShape,
    expected_state_shapes,
    validate_state,
)
from videomamba_tpu_torch.utils.precision import cast_module_for_compute


def _load_reference():
    """The benchmark's reference module, which imports torch alone."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "reference", "granite_hybrid.py")
    spec = importlib.util.spec_from_file_location("granite_hybrid_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()
ATTN = 5
SMALL = dict(GRANITE_4_0_H_MICRO, vocab_size=512, hidden_size=128, num_hidden_layers=10,
             layer_types=["attention" if i == ATTN else "mamba" for i in range(10)],
             intermediate_size=256, shared_intermediate_size=256, num_attention_heads=4,
             num_key_value_heads=2, attention_multiplier=1 / 32, mamba_n_heads=16,
             mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=32, max_position_embeddings=256)
FP32_BAR = 1e-5   # the port's fp32 bar (ROADMAP: the JAX kernels' own)
BF16_BAR = 3e-2   # bf16 products and weights against fp32: measured 5.4e-3 on these weights
CHUNKS = (37, 32, 50, 9)  # uneven; 37, 50 and 9 are no multiple of the SSD's chunk of 32


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.fixture(scope="module")
def small():
    """The small model, fp32, its weights as the reference takes them, and
    two rows of ids. q_proj and k_proj are drawn four times wider than the
    init's 0.02, so that the attention is far from uniform and its scale
    and cache show in the logits."""
    model = HybridMambaLM(SMALL, device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        for name in ("q_proj", "k_proj"):
            getattr(model.layers[ATTN].mixer, name).weight.mul_(4.0)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids = torch.randint(0, SMALL["vocab_size"], (2, sum(CHUNKS)),
                        generator=torch.Generator().manual_seed(2))
    return model, weights, ids


def stream(model, ids, chunks, max_len=160):
    """Each chunk's logits through a session, and the session."""
    session = StreamingSession(model, batch_size=ids.shape[0], max_len=max_len)
    outs, lo = [], 0
    for n in chunks:
        outs.append(session.process(ids[:, lo:lo + n]))
        lo += n
    return outs, session


def ends(chunks):
    return [sum(chunks[:k + 1]) - 1 for k in range(len(chunks))]


@torch.no_grad()
def test_full_forward_matches_the_reference(small):
    model, w, ids = small
    want, _ = ref.forward(w, SMALL, ids)
    assert rel(model(ids), want[:, 0]) < FP32_BAR


@torch.no_grad()
def test_streaming_uneven_chunks_matches_the_reference_logits_and_state(small):
    model, w, ids = small
    outs, session = stream(model, ids, CHUNKS)
    want, states = ref.forward(w, SMALL, ids, logits_at=ends(CHUNKS))
    for k, got in enumerate(outs):
        assert rel(got, want[:, k]) < FP32_BAR, k
    assert session.offset == ids.shape[1]
    for i, (got, (a, b)) in enumerate(zip(session.state, states)):
        if i == ATTN:
            assert got.length == ids.shape[1]
            assert rel(got.key[:, :, :got.length], a) < FP32_BAR
            assert rel(got.value[:, :, :got.length], b) < FP32_BAR
            assert not got.key[:, :, got.length:].any()
        else:
            assert rel(got[0], a) < FP32_BAR and rel(got[1], b) < FP32_BAR, i


@torch.no_grad()
def test_prefill_then_one_token_chunks_equals_the_full_forward(small):
    model, w, ids = small
    chunks = (40,) + (1,) * 6
    outs, _ = stream(model, ids[:, :46], chunks, max_len=64)
    want, _ = ref.forward(w, SMALL, ids[:, :46], logits_at=ends(chunks))
    for k, got in enumerate(outs):
        assert rel(got, want[:, k]) < FP32_BAR, k


@torch.no_grad()
def test_bf16_model_stays_within_its_tolerance(small):
    model, w, ids = small
    served = cast_module_for_compute(copy.deepcopy(model), torch.bfloat16)
    assert served.layers[0].norm2.weight.dtype == torch.float32  # norms stay fp32
    assert served.layers[ATTN].mixer.q_proj.weight.dtype == torch.bfloat16
    outs, session = stream(served, ids, CHUNKS)
    assert session.state[ATTN].key.dtype == torch.bfloat16  # the cache takes the model's dtype
    want, _ = ref.forward(w, SMALL, ids, logits_at=ends(CHUNKS))
    for k, got in enumerate(outs):
        assert rel(got, want[:, k]) < BF16_BAR, k


def _scale_of_one_over_sqrt_d(model):
    layer = model.layers[ATTN].mixer
    layer.scale = layer.head_dim ** -0.5


def _multiplier_dropped(model):
    for layer in model.layers:
        layer.residual_multiplier = 1.0


def _cache_not_carried(model):
    """The attention layer attends within each chunk alone, the cache's fill
    advanced as if it had been written."""
    layer = model.layers[ATTN].mixer
    plain = Attention.forward.__get__(layer)

    def forward(x, state=None, return_state=False):
        out = plain(x)
        return (out, state._replace(length=state.length + x.shape[1])) if return_state else out

    layer.forward = forward


FAULTS = [_scale_of_one_over_sqrt_d, _multiplier_dropped, _cache_not_carried]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
@torch.no_grad()
def test_each_planted_fault_fails_the_comparison(small, fault):
    model, w, ids = small
    broken = copy.deepcopy(model)
    fault(broken)
    outs, _ = stream(broken, ids, CHUNKS)
    want, _ = ref.forward(w, SMALL, ids, logits_at=ends(CHUNKS))
    assert max(rel(got, want[:, k]) for k, got in enumerate(outs)) > 100 * FP32_BAR


def test_attention_kernel_plain_is_bottom_right_causal_gqa():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, h, n, 8, generator=g) for h, n in ((4, 3), (2, 7), (2, 7)))
    got = attention_plain(q, k, v, 0.5)
    for i in range(3):  # query i sees keys 0 .. 7 - 3 + i
        s = (q[:, :, i:i + 1] @ k.repeat_interleave(2, 1)[:, :, :5 + i].transpose(-1, -2)) * 0.5
        want = torch.softmax(s, -1) @ v.repeat_interleave(2, 1)[:, :, :5 + i]
        assert torch.allclose(got[:, :, i:i + 1], want, atol=1e-6)
    with pytest.raises(ValueError, match="S >= L"):
        attention_plain(q, k[:, :, :2], v[:, :, :2], 0.5)


@torch.no_grad()
def test_a_chunk_past_the_cache_raises(small):
    model, _, ids = small
    session = StreamingSession(model, batch_size=2, max_len=40)
    session.process(ids[:, :32])
    with pytest.raises(ValueError, match="max_len 40"):
        session.process(ids[:, 32:41])


@torch.no_grad()
def test_reset_empties_the_cache_and_refuses_rows(small):
    model, w, ids = small
    session = StreamingSession(model, batch_size=2, max_len=64)
    session.process(ids[:, :20])
    key = session.state[ATTN].key
    session.reset()
    assert session.offset == 0 and session.state[ATTN].length == 0
    assert session.state[ATTN].key is key  # the same buffers, emptied
    assert all(not t.any() for i, s in enumerate(session.state) if i != ATTN for t in s)
    got = session.process(ids[:, 20:30])
    want, _ = ref.forward(w, SMALL, ids[:, 20:30])
    assert rel(got, want[:, 0]) < FP32_BAR
    with pytest.raises(ValueError, match="attention layers"):
        session.reset([0])
    with pytest.raises(ValueError, match="max_len"):
        StreamingSession(model, batch_size=2)


def test_decode_session_and_create_block_refuse_what_they_do_not_take(small):
    model, _, _ = small
    with pytest.raises(ValueError, match="attention or MLP"):
        DecodeSession(model, batch_size=1)
    with pytest.raises(ValueError, match="'Mamba', 'Mamba2', 'attention'"):
        create_block(16, {"layer": "rwkv"}, device="cpu")


def test_state_contract_has_the_kv_entry(small):
    model, _, _ = small
    with pytest.raises(ValueError, match="needs max_len"):
        expected_state_shapes(model, 2)
    shapes = expected_state_shapes(model, 2, max_len=64)
    assert shapes[ATTN] == KVStateShape(key=(2, 2, 64, 32), value=(2, 2, 64, 32))
    assert shapes[0] == StateShape(conv_state=(2, 128 * 2 + 32, 4), ssm_state=(2, 16, 16, 16))
    state = model.allocate_state(2, max_len=64)
    validate_state(model, state, 2)
    bad = list(state)
    bad[ATTN] = KVCache(state[ATTN].key, state[ATTN].value, 65)
    with pytest.raises(ValueError, match="length 65"):
        validate_state(model, bad, 2)
    bad[ATTN] = state[0]
    with pytest.raises(TypeError, match="KVCache"):
        validate_state(model, bad, 2)


def test_video_models_keep_their_state_shapes_and_plain_block():
    """The video models' contract entries and a Block without MLP are as
    before: the mixer's output with the post-add residual, K4's gate on."""
    model = videomamba_tiny(device="cpu", depth=2, img_size=32, num_frames=2)
    mx = model.layers[0].mixer
    assert expected_state_shapes(model, 3) == {
        i: StateShape(conv_state=(3, mx.d_inner, mx.d_conv), ssm_state=(3, mx.d_inner, mx.d_state))
        for i in range(2)}
    block = model.layers[0]
    assert block.mlp is None and block.residual_multiplier == 1.0 and block._use_block_fused()
    g = torch.Generator().manual_seed(4)
    hidden, residual = torch.randn(2, 9, 192, generator=g), torch.randn(2, 9, 192, generator=g)
    with torch.no_grad():
        out, res = block(hidden, residual)
        normed, want_res = fused_add_norm(hidden, block.norm.weight, None, residual=residual,
                                          prenorm=True, residual_in_fp32=True,
                                          norm_type="rms")
        want = mx(normed)
    assert torch.allclose(out, want, atol=1e-5) and torch.equal(res, want_res)
    with_mlp = create_block(192, device="cpu", mlp_cfg={"hidden_features": 64})
    assert not with_mlp._use_block_fused()


def test_the_preset_builds_every_published_width():
    with torch.device("meta"):
        model = granite_4_0_h_micro(device="meta")
    assert sum(p.numel() for p in model.parameters()) == 3_191_396_096
    assert model.attention_layers == [5, 15, 25, 35] and len(model.layers) == 40
    attn, mamba = model.layers[5].mixer, model.layers[0].mixer
    assert (attn.n_heads, attn.n_kv_heads, attn.head_dim, attn.scale) == (32, 8, 64, 1 / 64)
    assert (mamba.nheads, mamba.headdim, mamba.d_state, mamba.chunk_size) == (64, 64, 128, 256)
    assert model.embed_tokens.weight.shape == (100352, 2048)
    assert model.layers[0].mlp.input_linear.weight.shape == (16384, 2048)
    with pytest.raises(ValueError, match="num_local_experts=4"):
        HybridMambaLM(dict(GRANITE_4_0_H_MICRO, num_local_experts=4), device="meta")


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", [(256, 256), (256, 1024), (8, 4096)])
def test_attention_kernel_matches_its_plain_version_on_the_card(dev, L, S):
    """The flash kernel through the wrapper against the plain fp32 version,
    bf16 q over a view into a longer bf16 cache (B 2, 8 heads over 2)."""
    from videomamba_tpu_torch.ops.kernels.attention import attention

    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(2, 8, L, 64, generator=g, device=dev).to(torch.bfloat16)
    cache = torch.randn(2, 2, 2, S + 64, 64, generator=g, device=dev).to(torch.bfloat16)
    k, v = cache[0][:, :, :S], cache[1][:, :, :S]
    before = attention.launches
    got = attention(q, k, v, 1 / 64)
    assert attention.launches == before + 1
    want = attention_plain(q.cpu(), k.cpu(), v.cpu(), 1 / 64).float()
    assert rel(got.cpu(), want) < 1e-2


@pytest.mark.cuda
@torch.no_grad()
def test_small_bf16_model_streams_on_the_card_against_the_reference(dev):
    """The small model in bf16 on the card (K12, the attention kernel, K2),
    streamed in uneven chunks, against the fp32 reference."""
    model = HybridMambaLM(SMALL, device=dev, generator=torch.Generator().manual_seed(1)).eval()
    w = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cast_module_for_compute(model, torch.bfloat16)
    ids = torch.randint(0, SMALL["vocab_size"], (2, sum(CHUNKS)),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    outs, session = stream(model, ids, CHUNKS)
    with ref.no_tf32():
        want, states = ref.forward(w, SMALL, ids, logits_at=ends(CHUNKS))
    for k, got in enumerate(outs):
        assert rel(got, want[:, k]) < BF16_BAR, k
    kv = session.state[ATTN]
    assert rel(kv.key[:, :, :kv.length], states[ATTN][0]) < BF16_BAR
