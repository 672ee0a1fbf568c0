"""Plain PyTorch reference of VideoMamba, fp32 with TF32 off.

Written from the published description (VideoMamba, arXiv:2403.06977;
Mamba, arXiv:2312.00752; Mamba-2, arXiv:2405.21060) as this repository
defines the model: a 3D-tubelet patch embedding, spatial and temporal
positions (the temporal embedding interpolated linearly to the chunk's
horizon and sliced at its offset), CLS in a stream's first chunk only,
``depth`` prenorm residual Blocks (add, RMSNorm, a unidirectional mixer),
a final RMSNorm and an average pool under a LayerNorm. Each Block carries
(conv_state, ssm_state) from one chunk of a stream to the next. The
weights are a name -> tensor dict in the published checkpoint layout.

It imports neither JAX nor anything of the program, and it is vectorised
over time in blocks: the Mamba-1 scan runs each block of ``T`` steps from a
zero state, joins the blocks' end states in a short pass, then runs the
blocks again from their true starts; the SSD scan is the chunked matrix
form with a pass over chunks. ``Products("fp8")`` is the control: every
weight product's operands and result rounded to fp8 (e4m3, one scale a
tensor).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Weights = Dict[str, Tensor]
State = List[Tuple[Tensor, Tensor]]


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


class _Fp8(torch.autograd.Function):
    """Round to fp8 e4m3 under one per-tensor scale; the cotangent passes."""

    @staticmethod
    def forward(ctx, t):
        scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Products:
    """The weight products ``x @ w.T``: fp32, or for the control ("fp8")
    computed in fp8: both operands and the result rounded to fp8, as the
    configurations' bf16 compute rounds its products' operands and the
    activations they make (the residual stream, the scans and the norms
    stay fp32 on both)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.precision = precision

    def __call__(self, x: Tensor, w: Tensor) -> Tensor:
        if self.precision == "fp8":
            return _Fp8.apply(_Fp8.apply(x) @ _Fp8.apply(w).t())
        return x @ w.t()


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _time_block(seqlen: int) -> int:
    return max(8, int(round(math.sqrt(seqlen / 2))))


def _pad_time(t: Tensor, total: int) -> Tensor:
    """Zero-pad (B, L, ...) to ``total`` steps: zero dt keeps the state."""
    pad = total - t.shape[1]
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)


def selective_scan(u, delta, A, Bm, Cm, h0):
    """h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t, y_t = C_t . h_t.

    u, delta (B, L, D); A (D, N); Bm, Cm (B, L, N); h0 (B, D, N).
    Returns y (B, L, D) and the last state (B, D, N)."""
    b, L, d = u.shape
    T = _time_block(L)
    nc = -(-L // T)
    dl = _pad_time(delta, nc * T).view(b, nc, T, d)
    du = _pad_time(delta * u, nc * T).view(b, nc, T, d)
    Bc = _pad_time(Bm, nc * T).view(b, nc, T, -1)
    Cc = _pad_time(Cm, nc * T).view(b, nc, T, -1)

    def advance(h, t):
        return (torch.exp(dl[:, :, t, :, None] * A) * h
                + du[:, :, t, :, None] * Bc[:, :, t, None, :])

    h = u.new_zeros((b, nc, d, A.shape[1]))
    for t in range(T):
        h = advance(h, t)
    decay = torch.exp(dl.sum(2)[..., None] * A)  # (b, nc, d, n): the block's whole decay
    starts, state = [], h0
    for c in range(nc):
        starts.append(state)
        state = decay[:, c] * state + h[:, c]
    h = torch.stack(starts, dim=1)
    ys = []
    for t in range(T):
        h = advance(h, t)
        ys.append(torch.einsum("bcdn,bcn->bcd", h, Cc[:, :, t]))
    y = torch.stack(ys, dim=2).reshape(b, nc * T, d)[:, :L]
    return y, state


def ssd(x, dt, A, Bm, Cm, h0, chunk: int = 64):
    """The Mamba-2 recurrence h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, chunked: x (B, L, H, P), dt (B, L, H), A (H,),
    Bm, Cm (B, L, G, N), h0 (B, H, P, N). Returns y and the last state."""
    b, L, h, p = x.shape
    g = Bm.shape[2]
    nc = -(-L // chunk)
    total = nc * chunk
    Bh = _pad_time(Bm, total).repeat_interleave(h // g, dim=2).view(b, nc, chunk, h, -1)
    Ch = _pad_time(Cm, total).repeat_interleave(h // g, dim=2).view(b, nc, chunk, h, -1)
    dtc = _pad_time(dt, total).view(b, nc, chunk, h)
    xdt = (_pad_time(x, total).view(b, nc, chunk, h, p) * dtc[..., None])
    cs = torch.cumsum(dtc * A, dim=2)  # (b, nc, Q, h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b, nc, q, s, h)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh) * decay
    y = torch.einsum("bcqsh,bcshp->bcqhp", scores, xdt)
    to_end = torch.exp(cs[:, :, -1:, :] - cs)
    chunk_states = torch.einsum("bcshn,bcshp->bchpn", Bh * to_end[..., None], xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (b, nc, h)
    starts, state = [], h0
    for c in range(nc):
        starts.append(state)
        state = chunk_decay[:, c, :, None, None] * state + chunk_states[:, c]
    starts = torch.stack(starts, dim=1)  # (b, nc, h, p, n)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp", Ch * torch.exp(cs)[..., None], starts)
    return y.reshape(b, total, h, p)[:, :L], state


def _causal_conv(x: Tensor, weight: Tensor, bias: Tensor, conv_state: Tensor):
    """Depthwise causal conv of x (B, L, C) over [last W-1 raw inputs of the
    window || x] with SiLU; the new window holds the last W raw inputs."""
    width = weight.shape[-1]
    seq = torch.cat([conv_state, x.transpose(1, 2)], dim=2)  # (B, C, W + L)
    out = F.conv1d(seq[:, :, 1:], weight, bias, groups=weight.shape[0])
    return F.silu(out).transpose(1, 2), seq[:, :, -width:]


def mamba_mixer(w: Weights, m: str, x: Tensor, state, prod: Products):
    """The Mamba-1 mixer of Block prefix ``m`` on x (B, L, E)."""
    di = w[m + "D"].shape[0]
    r = w[m + "dt_proj.weight"].shape[1]
    n = w[m + "A_log"].shape[1]
    xz = prod(x, w[m + "in_proj.weight"])
    xi, z = xz[..., :di], xz[..., di:]
    u, conv_state = _causal_conv(xi, w[m + "conv1d.weight"], w[m + "conv1d.bias"], state[0])
    dbc = prod(u, w[m + "x_proj.weight"])
    delta = F.softplus(prod(dbc[..., :r], w[m + "dt_proj.weight"]) + w[m + "dt_proj.bias"])
    y, ssm_state = selective_scan(u, delta, -torch.exp(w[m + "A_log"]), dbc[..., r:r + n],
                                  dbc[..., r + n:], state[1])
    y = (y + u * w[m + "D"]) * F.silu(z)
    return prod(y, w[m + "out_proj.weight"]), (conv_state, ssm_state)


def mamba2_mixer(w: Weights, m: str, x: Tensor, state, prod: Products, cfg: dict):
    """The Mamba-2 (SSD) mixer of Block prefix ``m`` on x (B, L, E)."""
    ssm = cfg["ssm_cfg"]
    h = w[m + "A_log"].shape[0]
    di = w[m + "norm.weight"].shape[0]
    p, n, g = di // h, ssm["d_state"], ssm.get("ngroups", 1)
    cd = di + 2 * g * n
    zxbcdt = prod(x, w[m + "in_proj.weight"])
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]
    xbc, conv_state = _causal_conv(xbc, w[m + "conv1d.weight"], w[m + "conv1d.bias"], state[0])
    b, L = x.shape[:2]
    xs = xbc[..., :di].reshape(b, L, h, p)
    Bm = xbc[..., di:di + g * n].reshape(b, L, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, L, g, n)
    dt = F.softplus(dt + w[m + "dt_bias"])
    y, ssm_state = ssd(xs, dt, -torch.exp(w[m + "A_log"]), Bm, Cm, state[1])
    y = (y + w[m + "D"][:, None] * xs).reshape(b, L, di)
    gated = rms_norm(y * F.silu(z), w[m + "norm.weight"], ssm.get("norm_epsilon", 1e-5))
    return prod(gated, w[m + "out_proj.weight"]), (conv_state, ssm_state)


def zero_state(w: Weights, cfg: dict, batch: int, device) -> State:
    """Every Block's zero (conv window, SSM state), fp32."""
    ssm = cfg["ssm_cfg"]
    out = []
    for i in range(cfg["depth"]):
        m = f"layers.{i}.mixer."
        conv = w[m + "conv1d.weight"]
        shape = (batch,) + tuple(w[m + "A_log"].shape)
        if ssm.get("layer", "Mamba") == "Mamba2":
            di = w[m + "norm.weight"].shape[0]
            h = shape[1]
            shape = (batch, h, di // h, ssm["d_state"])
        out.append((torch.zeros((batch, conv.shape[0], conv.shape[-1]), device=device),
                    torch.zeros(shape, device=device)))
    return out


def _temporal_positions(w: Weights, tokens: int, offset: int) -> Tensor:
    """(1, tokens, E): the embedding interpolated linearly to offset + tokens
    positions where that passes its length, then sliced at ``offset``."""
    pos = w["temporal_pos_embedding"]
    end = offset + tokens
    if end > pos.shape[1]:
        pos = F.interpolate(pos.transpose(1, 2), size=end, mode="linear",
                            align_corners=False).transpose(1, 2)
    return pos[:, offset:end]


def embed(w: Weights, cfg: dict, video: Tensor, offset: int, has_cls: bool,
          prod: Products) -> Tensor:
    """Tokens (B, [1 +] T' H' W', E) of a normalised clip (B, C, T, H, W)."""
    b, c, t, hh, ww = video.shape
    kt, p = cfg["tubelet_size"], cfg["patch_size"]
    gt, gh, gw = t // kt, hh // p, ww // p
    patches = video.reshape(b, c, gt, kt, gh, p, gw, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
    patches = patches.reshape(b, gt, gh * gw, c * kt * p * p)
    weight = w["patch_embed.proj.weight"].reshape(w["patch_embed.proj.weight"].shape[0], -1)
    tokens = prod(patches, weight) + w["patch_embed.proj.bias"]
    tokens = tokens + w["pos_embed"][:, None, 1:]
    tokens = tokens + _temporal_positions(w, gt, offset)[:, :, None]
    tokens = tokens.reshape(b, gt * gh * gw, -1)
    if has_cls:
        cls = (w["cls_token"] + w["pos_embed"][:, :1]).expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
    return tokens


def visible_positions(mask: np.ndarray) -> np.ndarray:
    """Each row's visible token positions (mask True = hidden), ascending."""
    rows = [np.flatnonzero(~row) for row in np.asarray(mask, dtype=bool)]
    if len({len(r) for r in rows}) != 1:
        raise ValueError("every row must keep the same number of visible tokens")
    return np.stack(rows)


def _block(w: Weights, cfg: dict, i: int, hidden, residual, state, prod):
    residual = hidden if residual is None else hidden + residual
    normed = rms_norm(residual, w[f"layers.{i}.norm.weight"], cfg["norm_epsilon"])
    m = f"layers.{i}.mixer."
    if cfg["ssm_cfg"].get("layer", "Mamba") == "Mamba2":
        out, new = mamba2_mixer(w, m, normed, state, prod, cfg)
    else:
        out, new = mamba_mixer(w, m, normed, state, prod)
    return out, residual, new


def forward(w: Weights, cfg: dict, video: Tensor, state: Optional[State] = None,
            offset: int = 0, mask: Optional[np.ndarray] = None,
            prod: Optional[Products] = None, remat: bool = False):
    """One clip or one stream chunk: returns (patch tokens after the final
    norm, the pooled features (B, 1, E), the new state). ``state`` None is a
    clip (a zero state, CLS); a chunk at ``offset`` > 0 has no CLS. ``mask``
    (B, [1 +] tokens, True = hidden) runs the Blocks on the visible tokens.
    ``remat`` recomputes each Block in the backward (memory, not values)."""
    prod = prod or Products()
    b = video.shape[0]
    has_cls = state is None or offset == 0
    if state is None:
        state = zero_state(w, cfg, b, video.device)
    tokens = embed(w, cfg, video, offset, has_cls, prod)
    if mask is not None:
        index = torch.from_numpy(visible_positions(mask)).to(tokens.device)
        tokens = torch.gather(tokens, 1, index[:, :, None].expand(-1, -1, tokens.shape[-1]))
    hidden, residual, new_state = tokens, None, []
    for i in range(cfg["depth"]):
        if remat and torch.is_grad_enabled():
            def run(hd, rs, s0, s1, i=i):
                out, res, (n0, n1) = _block(w, cfg, i, hd, rs, (s0, s1), prod)
                return out, res, n0, n1
            if residual is None:
                residual = torch.zeros_like(hidden)
            hidden, residual, n0, n1 = checkpoint(run, hidden, residual, *state[i],
                                                  use_reentrant=False)
            new_state.append((n0, n1))
        else:
            hidden, residual, new = _block(w, cfg, i, hidden, residual, state[i], prod)
            new_state.append(new)
    x = rms_norm(hidden + residual, w["norm.weight"], cfg["norm_epsilon"])
    patch_tokens = x[:, 1:] if has_cls else x
    pooled = F.layer_norm(patch_tokens.mean(1, keepdim=True), (x.shape[-1],),
                          w["pool_norm.weight"], w["pool_norm.bias"], eps=1e-5)
    return patch_tokens, pooled, new_state


# ------------------------------------------------------------- training

def adamw_update(params: Weights, grads: Weights, moments: dict, step: int, recipe: dict):
    """torch.optim.AdamW's update (decoupled decay, bias-corrected moments),
    in place, for every parameter that has a gradient."""
    lr, wd, eps = recipe["lr"], recipe["weight_decay"], recipe["eps"]
    b1, b2 = recipe["betas"]
    for name, g in grads.items():
        m, v = moments.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p = params[name]
        p.mul_(1 - lr * wd)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def loss_and_grads(w: Weights, cfg: dict, video: Tensor, mask: np.ndarray, target: Tensor,
                   rows: int, prod: Products):
    """The masked feature-regression loss (mean square of the visible patch
    tokens against ``target``) and its gradients, summed over blocks of
    ``rows`` clips so that the activations fit."""
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = target.numel()
    loss = 0.0
    for lo in range(0, video.shape[0], rows):
        sl = slice(lo, lo + rows)
        tokens, _, _ = forward(leaves, cfg, video[sl], mask=mask[sl], prod=prod, remat=True)
        part = (tokens - target[sl]).square().sum() / total
        part.backward()
        loss += float(part.detach())
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    return loss, grads


def leaf_norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train(w: Weights, cfg: dict, batches, recipe: dict, rows: int,
          prod: Optional[Products] = None):
    """``len(batches)`` AdamW steps from ``w`` on (video, mask, target)
    batches. Returns each step's loss, every leaf's norm of the first
    step's gradient, and every leaf's norm of its change after the last."""
    prod = prod or Products()
    params = {k: v.detach().clone() for k, v in w.items()}
    moments, losses, first = {}, [], None
    for step, (video, mask, target) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, cfg, video, mask, target, rows, prod)
        losses.append(loss)
        if first is None:
            first = leaf_norms(grads)
        with torch.no_grad():
            adamw_update(params, grads, moments, step, recipe)
        del grads
    change = leaf_norms({k: params[k] - w[k] for k in moments})
    return losses, first, change
