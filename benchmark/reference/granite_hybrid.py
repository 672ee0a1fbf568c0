"""Plain PyTorch reference of IBM Granite-4.0-H, fp32 with TF32 off.

The forward of Hugging Face's ``GraniteMoeHybridForCausalLM`` for a
configuration without experts (https://huggingface.co/ibm-granite/
granite-4.0-h-micro/blob/main/config.json; ``cfg`` holds its keys):

    h = E[ids] * embedding_multiplier
    for each layer (``layer_types``: "mamba" or "attention"):
        h = h + residual_multiplier * mixer(RMSNorm(h))
        h = h + residual_multiplier * mlp(RMSNorm(h))
    logits = RMSNorm(h) E^T / logits_scaling

with the Mamba-2 mixer (in_proj to [z | x B C | dt], a causal depthwise
conv with bias and SiLU over [x B C], dt = softplus(dt + dt_bias), the SSD
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D
x_t, the gated RMSNorm norm(y silu(z)), out_proj), causal GQA attention
(scores scaled by ``attention_multiplier``, no positional encoding) and the
gated MLP (silu(g) * u of [g | u] = x W_in^T, then W_out).

Departures from the Hugging Face forward, none of which changes the
mathematics:

* fp32 throughout, TF32 off (:func:`no_tf32`); Hugging Face runs in the
  checkpoint's bf16 with its residual stream in bf16;
* no cache: every layer runs the whole sequence at once, the SSD in its
  chunked matrix form (``mamba_chunk_size`` chunks, a pass over chunks,
  computed ``segment`` positions at a time with the state carried between
  segments) and attention in blocks of queries, each query's softmax over
  exactly its causal keys;
* no padding mask (every row is a whole sequence), no sampling: logits at
  the positions asked for;
* weights are a name -> tensor dict in the port's names
  (``embed_tokens.weight``; ``layers.{i}.norm.weight`` for
  ``input_layernorm``, ``layers.{i}.mixer.*`` for ``mamba.*`` or
  ``self_attn.*``, ``layers.{i}.norm2.weight`` for
  ``post_attention_layernorm``, ``layers.{i}.mlp.*`` for ``shared_mlp.*``;
  ``norm.weight``);
* each Mamba-2 layer's state after the sequence is returned as the port's
  streaming state has it: the conv window of the last ``mamba_d_conv`` raw
  [x B C] inputs (B, conv_dim, d_conv) and the SSM state (B, heads,
  head_dim, d_state); each attention layer's keys and values (B,
  kv_heads, L, head_dim).

It imports torch alone. ``Products("fp8")`` is the control: every weight
product's operands and result rounded to fp8 (e4m3, one scale a tensor).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Weights = Dict[str, Tensor]


@contextlib.contextmanager
def no_tf32():
    """fp32 products and convolutions in full fp32 (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(t: Tensor) -> Tensor:
    scale = 448.0 / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class Products:
    """The weight products ``x @ w.T``: fp32, or for the control ("fp8")
    both operands and the result rounded to fp8."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.precision = precision

    def __call__(self, x: Tensor, w: Tensor) -> Tensor:
        if self.precision == "fp8":
            return _fp8(_fp8(x) @ _fp8(w).t())
        return x @ w.t()


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rows(fn, x: Tensor, rows: int) -> Tensor:
    """``fn`` applied to blocks of ``rows`` positions of x (B, L, ...)."""
    return torch.cat([fn(x[:, lo:lo + rows]) for lo in range(0, x.shape[1], rows)], dim=1)


def ssd_segment(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, h0: Tensor,
                chunk: int) -> Tuple[Tensor, Tensor]:
    """The SSD recurrence over one segment in its chunked matrix form: x (B,
    L, H, P), dt (B, L, H), A (H,), Bm and Cm (B, L, G, N), h0 (B, H, P, N).
    Returns y (B, L, H, P) without the D skip, and the state after."""
    b, L, h, p = x.shape
    g, n = Bm.shape[2:]
    nc = -(-L // chunk)
    pad = nc * chunk - L

    def chunks(t):
        t = F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xdt = chunks(x * dt[..., None]).reshape(b, nc, chunk, g, h // g, p)
    Bc, Cc = chunks(Bm), chunks(Cm)  # (b, nc, Q, g, n)
    cs = torch.cumsum(chunks(dt) * A, dim=2).reshape(b, nc, chunk, g, h // g)
    seg = cs[:, :, :, None] - cs[:, :, None, :]  # (b, nc, q, s, g, hg)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None, None], float("-inf")))
    scores = torch.einsum("bcqgn,bcsgn->bcqsg", Cc, Bc)[..., None] * decay
    y = torch.einsum("bcqsgh,bcsghp->bcqghp", scores, xdt)
    to_end = torch.exp(cs[:, :, -1:] - cs)  # (b, nc, Q, g, hg)
    states = torch.einsum("bcsgn,bcsgh,bcsghp->bcghpn", Bc, to_end, xdt)
    chunk_decay = torch.exp(cs[:, :, -1])  # (b, nc, g, hg)
    state = h0.reshape(b, g, h // g, p, n)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = chunk_decay[:, c, :, :, None, None] * state + states[:, c]
    starts = torch.stack(starts, dim=1)  # (b, nc, g, hg, p, n)
    y = y + torch.einsum("bcqgn,bcqgh,bcghpn->bcqghp", Cc, torch.exp(cs), starts)
    return y.reshape(b, nc * chunk, h, p)[:, :L], state.reshape(b, h, p, n)


def ssd(x, dt, A, Bm, Cm, chunk: int, segment: int) -> Tuple[Tensor, Tensor]:
    """The SSD over the whole sequence from a zero state, ``segment``
    positions (a multiple of ``chunk``) at a time."""
    b, L, h, p = x.shape
    state = x.new_zeros((b, h, p, Bm.shape[-1]))
    ys = []
    for lo in range(0, L, segment):
        sl = slice(lo, lo + segment)
        y, state = ssd_segment(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], state, chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mamba2_mixer(w: Weights, m: str, x: Tensor, cfg: dict, prod: Products, segment: int):
    """A Mamba-2 layer's mixer (prefix ``m``) on x (B, L, D): its output
    and its final (conv window, SSM state)."""
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n, width = cfg["mamba_n_groups"], cfg["mamba_d_state"], cfg["mamba_d_conv"]
    di, cd = h * p, h * p + 2 * g * n
    b, L = x.shape[:2]
    zxbcdt = prod(x, w[m + "in_proj.weight"])
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]
    seq = torch.cat([xbc.new_zeros((b, cd, width)), xbc.transpose(1, 2)], dim=2)
    conv = F.conv1d(seq[:, :, 1:], w[m + "conv1d.weight"], w[m + "conv1d.bias"], groups=cd)
    u = F.silu(conv).transpose(1, 2)
    xs = u[..., :di].reshape(b, L, h, p)
    Bm = u[..., di:di + g * n].reshape(b, L, g, n)
    Cm = u[..., di + g * n:].reshape(b, L, g, n)
    dt = F.softplus(dt + w[m + "dt_bias"])
    y, ssm_state = ssd(xs, dt, -torch.exp(w[m + "A_log"]), Bm, Cm, cfg["mamba_chunk_size"],
                       segment)
    y = (y + w[m + "D"][:, None] * xs).reshape(b, L, di)
    gated = rms_norm(y * F.silu(z), w[m + "norm.weight"], cfg["rms_norm_eps"])
    return prod(gated, w[m + "out_proj.weight"]), (seq[:, :, -width:].clone(), ssm_state)


def attention_mixer(w: Weights, m: str, x: Tensor, cfg: dict, prod: Products,
                    budget: int = 1 << 29):
    """An attention layer's mixer on x (B, L, D): its output and its keys
    and values (B, kv_heads, L, head_dim). Queries go in blocks whose
    scores hold at most ``budget`` elements; a block's queries of the heads
    that share a key head are the rows of one product with that head's
    keys, and the softmax's sum divides the product with the values."""
    hq, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    g = hq // hk
    d = x.shape[-1]
    hd = cfg.get("head_dim") or d // hq
    b, L = x.shape[:2]
    q = prod(x, w[m + "q_proj.weight"]).reshape(b, L, hk, g, hd).transpose(1, 2)
    q = q * cfg["attention_multiplier"]  # (b, hk, L, g, hd)
    k = prod(x, w[m + "k_proj.weight"]).reshape(b, L, hk, hd).transpose(1, 2)
    v = prod(x, w[m + "v_proj.weight"]).reshape(b, L, hk, hd).transpose(1, 2)
    block = max(1, min(L, budget // (b * hq * L)))
    outs = []
    for lo in range(0, L, block):
        hi = min(L, lo + block)
        n = hi - lo
        scores = q[:, :, lo:hi].reshape(b, hk, n * g, hd) @ k[:, :, :hi].transpose(-1, -2)
        # the causal mask touches only the block's own keys
        future = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
        scores.view(b, hk, n, g, hi)[..., lo:].masked_fill_(future[:, None], float("-inf"))
        scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
        out = (scores @ v[:, :, :hi]) / scores.sum(dim=-1, keepdim=True)
        outs.append(out.view(b, hk, n, g, hd))
    y = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, L, hq * hd)
    return prod(y, w[m + "o_proj.weight"]), (k, v)


def mlp(w: Weights, m: str, x: Tensor, prod: Products) -> Tensor:
    gu = prod(x, w[m + "input_linear.weight"])
    gate, up = gu.chunk(2, dim=-1)
    return prod(F.silu(gate) * up, w[m + "output_linear.weight"])


def forward(w: Weights, cfg: dict, ids: Tensor, logits_at: Sequence[int] = (-1,),
            prod: Optional[Products] = None, rows: int = 16384, segment: int = 8192,
            attention_out: Optional[Dict[int, Tensor]] = None, attention_from: int = 0):
    """ids (B, L) -> (logits (B, len(logits_at), vocab) at those positions,
    every layer's state after the sequence). ``rows``: positions a block
    of the MLP; ``segment``: positions a block of the SSD. With a dict
    ``attention_out``, each attention layer ``i``'s mixer output (before
    the residual multiplier) at positions ``attention_from`` on goes into
    ``attention_out[i]`` (B, L - attention_from, D)."""
    prod = prod or Products()
    eps, mult = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = F.embedding(ids, w["embed_tokens.weight"]) * cfg["embedding_multiplier"]
    states: List[Tuple[Tensor, Tensor]] = []
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}."
        normed = rms_norm(h, w[p + "norm.weight"], eps)
        if kind == "mamba":
            out, state = mamba2_mixer(w, p + "mixer.", normed, cfg, prod, segment)
        else:
            out, state = attention_mixer(w, p + "mixer.", normed, cfg, prod)
            if attention_out is not None:
                attention_out[i] = out[:, attention_from:].clone()
        states.append(state)
        h = h + mult * out
        h = h + mult * _rows(
            lambda t: mlp(w, p + "mlp.", rms_norm(t, w[p + "norm2.weight"], eps), prod), h, rows)
    last = rms_norm(h[:, list(logits_at)], w["norm.weight"], eps)
    return prod(last, w["embed_tokens.weight"]) / cfg["logits_scaling"], states
