"""Primus/PrimusV2: EVA-style 3D ViT with conv tokenizer + patch decoder.

Functional JAX reconstruction of the reference's `anatomix-dev-vit` model
(`/root/reference/anatomix/model/load_from_hf.py:25-35` config;
`anatomix/model/vit3d/architectures.py` wrapper). The transformer follows
the EVA-02 design the upstream Primus builds on: pre-norm blocks with
separate q/k/v projections (k without bias), optional per-head QK LayerNorm
(the anatomix extension, `architectures.py:108-115`), 3-axis axial rotary
position embeddings on non-register tokens, learned absolute position
embeddings, LayerScale (init 0.1), optional inner attention norm
(`scale_attn_inner`), SwiGLU MLP, register tokens re-initialized to
`register_init_std` (`architectures.py:117-120`), and configurable output
volume normalization (`build_out_norm`, `architectures.py:55-86`).

NOTE ON PARITY: the upstream `dynamic-network-architectures` source and the
pretrained `.pth` are not available in this environment, so this is a
faithful-by-design reconstruction of the documented architecture (EVA-02
block + PatchEmbed_deeper tokenizer + transposed-conv decoder) with the
exact registry configuration surface; the checkpoint converter maps the
upstream key layout best-effort and hard-fails on unknown keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.backend import attention_implementation
from anatomix_tpu.ops.conv import conv3d
from anatomix_tpu.ops.norms import (
    channel_demean,
    channel_layer_norm,
    instance_norm,
)

PRIMUS_CONFIGS = {
    "S": {"eva_depth": 12, "eva_numheads": 6, "embed_dim": 396},
    "B": {"eva_depth": 12, "eva_numheads": 12, "embed_dim": 792},
    "M": {"eva_depth": 16, "eva_numheads": 12, "embed_dim": 864},
    "L": {"eva_depth": 24, "eva_numheads": 16, "embed_dim": 1056},
}


@dataclasses.dataclass(frozen=True)
class PrimusConfig:
    input_channels: int = 1
    num_classes: int = 32
    embed_dim: int = 396
    eva_depth: int = 12
    eva_numheads: int = 6
    patch_embed_size: tuple = (8, 8, 8)
    input_shape: tuple = (128, 128, 128)
    num_register_tokens: int = 8
    init_values: float | None = 0.1
    scale_attn_inner: bool = False
    qk_norm: bool = False
    out_norm: str = "none"
    out_norm_eps: float = 1e-5
    register_init_std: float = 1e-6
    in_eps: float = 1e-5  # tokenizer InstanceNorm eps (V2)
    mlp_ratio: float = 4 * 2 / 3  # EVA-02 SwiGLU ratio
    use_rot_pos_emb: bool = True
    use_abs_pos_embed: bool = True
    version: str = "v2"  # 'v1' single-conv patch embed; 'v2' deep tokenizer
    tokenizer_base_features: int = 32
    tokenizer_depth_per_level: tuple = (1, 1, 1)
    rope_theta: float = 100.0

    @property
    def grid_shape(self):
        return tuple(
            s // p for s, p in zip(self.input_shape, self.patch_embed_size)
        )

    @property
    def num_tokens(self):
        g = self.grid_shape
        return g[0] * g[1] * g[2]

    @property
    def head_dim(self):
        return self.embed_dim // self.eva_numheads

    @property
    def mlp_hidden(self):
        return int(self.embed_dim * self.mlp_ratio)


def build_out_norm(mode, eps: float):
    """Output-volume normalization factory (`architectures.py:55-86`)."""
    if isinstance(mode, bool):
        mode = "instance" if mode else "none"
    mode = (mode or "none").lower()
    if mode in ("none", "identity", "off"):
        return lambda x: x
    if mode in ("instance", "instancenorm", "in"):
        return lambda x: instance_norm(x, eps=eps)
    if mode in ("demean", "center"):
        return channel_demean
    if mode in ("layernorm", "layer", "ln"):
        return lambda x: channel_layer_norm(x, eps=eps)
    raise ValueError(f"unsupported output normalization: {mode!r}")


# -----------------------------------------------------------------------------
# Init

def _trunc_normal(key, shape, std=0.02, dtype=jnp.float32):
    return jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype) * std


def _linear(key, fan_in, fan_out, bias=True, std=0.02):
    kw, _ = jax.random.split(key)
    p = {"w": _trunc_normal(kw, (fan_in, fan_out), std)}
    if bias:
        p["b"] = jnp.zeros((fan_out,))
    return p


def _ln(dim):
    return {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))}


def _conv_p(key, shape, bias=True):
    fan_in = shape[0] * shape[1] * shape[2] * shape[3]
    std = math.sqrt(2.0 / fan_in)
    p = {"w": jax.random.normal(key, shape) * std}
    if bias:
        p["b"] = jnp.zeros((shape[-1],))
    return p


def init_primus_params(cfg: PrimusConfig, key: jax.Array) -> dict[str, Any]:
    keys = iter(jax.random.split(key, 64 + 16 * cfg.eva_depth))

    params: dict[str, Any] = {}

    # ---- tokenizer -----------------------------------------------------------
    if cfg.version == "v2":
        base = cfg.tokenizer_base_features
        tok: dict[str, Any] = {
            "stem": _conv_p(next(keys), (3, 3, 3, cfg.input_channels, base)),
        }
        ch = base
        stages = []
        for level, depth in enumerate(cfg.tokenizer_depth_per_level):
            out_ch = min(ch * 2, cfg.embed_dim)
            stage = {
                "down": _conv_p(next(keys), (3, 3, 3, ch, out_ch)),
                "blocks": [
                    {
                        "conv1": _conv_p(
                            next(keys), (3, 3, 3, out_ch, out_ch)
                        ),
                        "conv2": _conv_p(
                            next(keys), (3, 3, 3, out_ch, out_ch)
                        ),
                    }
                    for _ in range(depth)
                ],
            }
            stages.append(stage)
            ch = out_ch
        tok["stages"] = stages
        tok["proj"] = _conv_p(next(keys), (1, 1, 1, ch, cfg.embed_dim))
        params["tokenizer"] = tok
    else:  # v1: single strided conv patch embed + token LayerNorm
        p = cfg.patch_embed_size
        params["tokenizer"] = {
            "proj": _conv_p(
                next(keys),
                (p[0], p[1], p[2], cfg.input_channels, cfg.embed_dim),
            ),
            "norm": _ln(cfg.embed_dim),
        }

    # ---- embeddings ----------------------------------------------------------
    if cfg.use_abs_pos_embed:
        params["pos_embed"] = _trunc_normal(
            next(keys), (cfg.num_tokens, cfg.embed_dim), 0.02
        )
    if cfg.num_register_tokens > 0:
        params["register_tokens"] = (
            jax.random.normal(
                next(keys), (cfg.num_register_tokens, cfg.embed_dim)
            )
            * cfg.register_init_std
        )

    # ---- EVA blocks -----------------------------------------------------------
    d = cfg.embed_dim
    blocks = []
    for _ in range(cfg.eva_depth):
        block = {
            "norm1": _ln(d),
            "q_proj": _linear(next(keys), d, d, bias=True),
            "k_proj": _linear(next(keys), d, d, bias=False),
            "v_proj": _linear(next(keys), d, d, bias=True),
            "proj": _linear(next(keys), d, d, bias=True),
            "norm2": _ln(d),
            # SwiGLU: hidden = silu(x@w1) * (x@w2); out = hidden @ w3
            "mlp_w1": _linear(next(keys), d, cfg.mlp_hidden, bias=True),
            "mlp_w2": _linear(next(keys), d, cfg.mlp_hidden, bias=True),
            "mlp_w3": _linear(next(keys), cfg.mlp_hidden, d, bias=True),
        }
        if cfg.qk_norm:
            block["q_norm"] = _ln(cfg.head_dim)
            block["k_norm"] = _ln(cfg.head_dim)
        if cfg.scale_attn_inner:
            block["attn_inner_norm"] = _ln(d)
        if cfg.init_values is not None:
            block["gamma1"] = jnp.full((d,), cfg.init_values)
            block["gamma2"] = jnp.full((d,), cfg.init_values)
        blocks.append(block)
    params["blocks"] = blocks
    params["norm"] = _ln(d)

    # ---- decoder: 3 transposed-conv ×2 stages to invert the 8³ patch ----------
    n_up = int(round(math.log2(cfg.patch_embed_size[0])))
    dec = []
    ch = d
    for i in range(n_up):
        out_ch = cfg.num_classes if i == n_up - 1 else max(ch // 2, 32)
        dec.append(_conv_p(next(keys), (2, 2, 2, ch, out_ch)))  # DHWIO
        ch = out_ch
    params["decoder"] = dec
    return params


def primus_param_count(params) -> int:
    return sum(int(np.prod(p.shape)) for p in
               jax.tree_util.tree_leaves(params))


# -----------------------------------------------------------------------------
# Forward pieces

def _layer_norm(x, p, eps=1e-6):
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).astype(x.dtype)


def _apply_linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _rope_tables(cfg: PrimusConfig):
    """Axial 3-D rotary tables (cos, sin) of shape (N, head_dim//2)."""
    hd = cfg.head_dim
    per_axis = (hd // 2) // 3  # rotary pairs per axis
    g = cfg.grid_shape
    coords = np.stack(
        np.meshgrid(
            np.arange(g[0]), np.arange(g[1]), np.arange(g[2]), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)
    freqs = cfg.rope_theta ** (
        -np.arange(per_axis, dtype=np.float64) / max(per_axis, 1)
    )
    angle_list = []
    for axis in range(3):
        angle_list.append(coords[:, axis: axis + 1] * freqs[None, :])
    angles = np.concatenate(angle_list, axis=1)  # (N, 3*per_axis)
    pad = hd // 2 - angles.shape[1]
    if pad > 0:
        angles = np.concatenate(
            [angles, np.zeros((angles.shape[0], pad))], axis=1
        )
    return (
        jnp.asarray(np.cos(angles), jnp.float32),
        jnp.asarray(np.sin(angles), jnp.float32),
    )


def _apply_rope(x, cos, sin):
    """x (..., N, head_dim); rotate interleaved pairs."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = jnp.stack([r1, r2], axis=-1)
    return out.reshape(x.shape)


def _apply_rope_half(x, cos, sin):
    """Rotate-half form: x's rotation pairs live at (i, i + hd//2) instead
    of (2i, 2i+1) — contiguous half-slices replace the stride-2
    deinterleave + interleave relayouts of `_apply_rope`. Exact same math
    when q/k channels are pre-permuted (see `_rope_half_perm`): the attention
    scores q·k are invariant to any fixed channel permutation applied to
    both."""
    hd = x.shape[-1]
    x1 = x[..., : hd // 2]
    x2 = x[..., hd // 2:]
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1
    )


def _rope_half_perm(hd: int) -> np.ndarray:
    """Channel permutation mapping rotate-half layout to interleaved:
    new channel i reads old channel perm[i]."""
    half = hd // 2
    perm = np.empty((hd,), np.int32)
    perm[:half] = 2 * np.arange(half)
    perm[half:] = 2 * np.arange(half) + 1
    return perm


def dot_product_attention(q, k, v, *, scale: float, implementation: str):
    """Multi-head attention on (B, N, H, hd) q/k/v, no mask.

    `implementation`: 'einsum' is the plain reference (f32 logits and
    softmax, (B, H, N, N) materialized); 'xla' and 'cudnn' go through
    `jax.nn.dot_product_attention`. For those the head dim is zero-padded
    to a multiple of 8, which cuDNN's fused kernel requires; zero channels
    add nothing to q·k, their outputs are sliced off, and the scale is
    passed explicitly so it stays 1/sqrt(true head dim)."""
    if implementation == "einsum":
        logits = jnp.einsum(
            "bnhd,bmhd->bhnm", q, k, preferred_element_type=jnp.float32
        ) * scale
        attn = jax.nn.softmax(logits, axis=-1)
        return jnp.einsum(
            "bhnm,bmhd->bnhd", attn.astype(v.dtype), v,
            preferred_element_type=jnp.float32,
        )
    hd = q.shape[-1]
    pad = (-hd) % 8
    if pad:
        widths = ((0, 0), (0, 0), (0, 0), (0, pad))
        q, k, v = (jnp.pad(t, widths) for t in (q, k, v))
    out = jax.nn.dot_product_attention(
        q, k, v, scale=scale, implementation=implementation
    )
    return out[..., :hd]


def _attention(cfg, block, x, rope, n_prefix, compute_dtype=None,
               attn_impl=None):
    B, N, D = x.shape
    H = cfg.eva_numheads
    hd = cfg.head_dim
    dt = compute_dtype or x.dtype

    # rotate-half RoPE: apply a fixed per-head channel permutation to the
    # q/k PROJECTION WEIGHTS (attention scores are invariant to a shared
    # q/k channel permutation) so the rotation pairs are contiguous
    # half-slices instead of stride-2 interleaved channels.
    rope_half = cfg.use_rot_pos_emb and hd % 2 == 0
    if rope_half:
        perm = _rope_half_perm(hd)
        cols = (np.arange(H)[:, None] * hd + perm[None, :]).reshape(-1)

        def proj_perm(p):
            w = p["w"][:, cols]
            return {"w": w, "b": p["b"][cols]} if "b" in p else {"w": w}

        def norm_perm(p):
            return {"scale": p["scale"][perm], "bias": p["bias"][perm]}

        q = _apply_linear(proj_perm(block["q_proj"]), x).reshape(B, N, H, hd)
        k = _apply_linear(proj_perm(block["k_proj"]), x).reshape(B, N, H, hd)
        if cfg.qk_norm:
            q = _layer_norm(q, norm_perm(block["q_norm"]), eps=1e-5)
            k = _layer_norm(k, norm_perm(block["k_norm"]), eps=1e-5)
    else:
        q = _apply_linear(block["q_proj"], x).reshape(B, N, H, hd)
        k = _apply_linear(block["k_proj"], x).reshape(B, N, H, hd)
        if cfg.qk_norm:
            q = _layer_norm(q, block["q_norm"], eps=1e-5)
            k = _layer_norm(k, block["k_norm"], eps=1e-5)
    v = _apply_linear(block["v_proj"], x).reshape(B, N, H, hd)

    if cfg.use_rot_pos_emb:
        cos, sin = rope
        cos, sin = cos[:, None, :], sin[:, None, :]  # broadcast over heads
        apply = _apply_rope_half if rope_half else _apply_rope
        q_spatial = apply(q[:, n_prefix:], cos, sin)
        k_spatial = apply(k[:, n_prefix:], cos, sin)
        q = jnp.concatenate([q[:, :n_prefix], q_spatial], axis=1)
        k = jnp.concatenate([k[:, :n_prefix], k_spatial], axis=1)

    out = dot_product_attention(
        q.astype(dt), k.astype(dt), v.astype(dt),
        scale=1.0 / math.sqrt(hd),
        implementation=attn_impl or attention_implementation(dt),
    )
    out = out.reshape(B, N, D).astype(x.dtype)
    if cfg.scale_attn_inner:
        out = _layer_norm(out, block["attn_inner_norm"], eps=1e-6)
    return _apply_linear(block["proj"], out)


def _mlp(block, x):
    h = jax.nn.silu(_apply_linear(block["mlp_w1"], x)) * _apply_linear(
        block["mlp_w2"], x
    )
    return _apply_linear(block["mlp_w3"], h)


def _tokenizer_v2(cfg, tok, x, compute_dtype=None):
    """Residual conv tokenizer (PatchEmbed_deeper equivalent): stem +
    stride-2 stages with InstanceNorm(in_eps)/LeakyReLU residual blocks +
    1×1×1 projection."""

    def conv(p, v, stride=1):
        return conv3d(
            v, p["w"], p.get("b"), stride=stride, padding="SAME"
            if stride == 1 else [(1, 1)] * 3,
            compute_dtype=compute_dtype,
        )

    def norm_act(v):
        return jax.nn.leaky_relu(
            instance_norm(v, eps=cfg.in_eps), negative_slope=0.01
        )

    y = norm_act(conv(tok["stem"], x))
    for stage in tok["stages"]:
        y = norm_act(conv(stage["down"], y, stride=2))
        for blk in stage["blocks"]:
            r = y
            y = norm_act(conv(blk["conv1"], y))
            y = conv(blk["conv2"], y)
            y = jax.nn.leaky_relu(
                instance_norm(y, eps=cfg.in_eps) + r, negative_slope=0.01
            )
    y = conv3d(y, tok["proj"]["w"], tok["proj"].get("b"),
               compute_dtype=compute_dtype)
    return y  # (B, d, h, w, embed)


def _depth_to_space2(y, co):
    """(B, d, h, w, 8·co) with (kd, kh, kw, co)-major channels ->
    (B, 2d, 2h, 2w, co)."""
    B, d, h, w, _ = y.shape
    y = y.reshape(B, d, h, w, 2, 2, 2, co)
    y = y.transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(B, 2 * d, 2 * h, 2 * w, co)


def _decoder(dec, grid, compute_dtype=None):
    """Transposed-conv ×2 stages back to full resolution.

    A stride-2 kernel-2 transposed conv has non-overlapping windows, so
    each stage is exactly ONE GEMM into (kd, kh, kw, co)-major channels
    followed by a depth-to-space reshape. Between stages the volume stays
    in the compute dtype; the inter-stage LayerNorm takes its statistics
    in f32 and the decoder output is f32."""
    y = grid
    n = len(dec)
    for i, p in enumerate(dec):
        w = p["w"]  # (2, 2, 2, in, out)
        ci, co = w.shape[3], w.shape[4]
        dt = compute_dtype or y.dtype
        w2 = jnp.transpose(w, (3, 0, 1, 2, 4)).reshape(ci, 8 * co)
        yb = jnp.einsum(
            "bdhwc,ce->bdhwe", y.astype(dt), w2.astype(dt),
            preferred_element_type=jnp.float32,
        ).astype(dt)
        y = _depth_to_space2(yb, co)
        if "b" in p:
            y = y + p["b"].astype(y.dtype)
        if i < n - 1:
            y = jax.nn.gelu(channel_layer_norm(y, eps=1e-6))
    return y.astype(jnp.float32)


def primus_apply(
    cfg: PrimusConfig,
    params: dict[str, Any],
    x: jax.Array,  # (B, D, H, W, C) — spatial must equal cfg.input_shape
    *,
    layers=None,
    encode_only: bool = False,
    compute_dtype=None,
    attn_impl: str | None = None,
):
    """Forward pass with the anatomix pretraining interface
    (`architectures.py:126-165`): plain -> normalized volume; `layers`
    truthy -> (volume, [volume]) or, with `encode_only`, [volume].

    `attn_impl` forces one attention implementation ('einsum', 'xla' or
    'cudnn', see `dot_product_attention`); by default the platform's
    fastest that supports the compute dtype
    (`backend.attention_implementation`)."""
    if tuple(x.shape[1:4]) != tuple(cfg.input_shape):
        raise ValueError(
            f"Primus is bound to input_shape={cfg.input_shape}; got "
            f"{x.shape[1:4]} (use sliding windows for other sizes)."
        )
    B = x.shape[0]

    if cfg.version == "v2":
        grid = _tokenizer_v2(
            cfg, params["tokenizer"], x, compute_dtype=compute_dtype
        )
    else:
        p = cfg.patch_embed_size
        grid = conv3d(
            x,
            params["tokenizer"]["proj"]["w"],
            params["tokenizer"]["proj"].get("b"),
            stride=p, padding="VALID", compute_dtype=compute_dtype,
        )
        grid = _layer_norm(grid, params["tokenizer"]["norm"])

    gd, gh, gw = cfg.grid_shape
    tokens = grid.reshape(B, gd * gh * gw, cfg.embed_dim)
    if cfg.use_abs_pos_embed:
        tokens = tokens + params["pos_embed"]

    n_prefix = cfg.num_register_tokens
    if n_prefix > 0:
        regs = jnp.broadcast_to(
            params["register_tokens"],
            (B, n_prefix, cfg.embed_dim),
        )
        tokens = jnp.concatenate([regs, tokens], axis=1)

    rope = _rope_tables(cfg) if cfg.use_rot_pos_emb else None

    for block in params["blocks"]:
        attn_out = _attention(
            cfg, block, _layer_norm(tokens, block["norm1"]), rope,
            n_prefix, compute_dtype=compute_dtype, attn_impl=attn_impl,
        )
        if "gamma1" in block:
            attn_out = attn_out * block["gamma1"]
        tokens = tokens + attn_out
        mlp_out = _mlp(block, _layer_norm(tokens, block["norm2"]))
        if "gamma2" in block:
            mlp_out = mlp_out * block["gamma2"]
        tokens = tokens + mlp_out

    tokens = _layer_norm(tokens, params["norm"])
    tokens = tokens[:, n_prefix:]
    grid = tokens.reshape(B, gd, gh, gw, cfg.embed_dim)

    volume = _decoder(params["decoder"], grid, compute_dtype=compute_dtype)
    output = build_out_norm(cfg.out_norm, cfg.out_norm_eps)(volume)

    if layers:
        features = [output]
        return features if encode_only else (output, features)
    return output


def load_primus_v2(vit_kwargs: dict, cache_path=None, repo_id=None,
                   revision=None, variant=None, seed: int = 0):
    """Build PrimusV2 from registry kwargs; load converted weights when a
    cache path is given, else random init (the upstream `.pth` layout is
    converted by `convert_primus_state_dict` when available)."""
    cfg = PrimusConfig(
        input_channels=vit_kwargs["input_channels"],
        num_classes=vit_kwargs["num_classes"],
        embed_dim=vit_kwargs["embed_dim"],
        eva_depth=vit_kwargs["eva_depth"],
        eva_numheads=vit_kwargs["eva_numheads"],
        patch_embed_size=tuple(vit_kwargs["patch_embed_size"]),
        input_shape=tuple(vit_kwargs["input_shape"]),
        num_register_tokens=vit_kwargs["num_register_tokens"],
        init_values=vit_kwargs.get("init_values", 0.1),
        scale_attn_inner=vit_kwargs.get("scale_attn_inner", False),
        qk_norm=vit_kwargs.get("qk_norm", False),
        out_norm=vit_kwargs.get("out_norm", "none"),
        out_norm_eps=vit_kwargs.get("out_norm_eps", 1e-5),
        register_init_std=vit_kwargs.get("register_init_std", 1e-6),
        in_eps=vit_kwargs.get("in_eps", 1e-5),
        version="v2",
    )
    if cache_path is not None and str(cache_path).endswith(".npz"):
        from anatomix_tpu.utils.checkpoint import load_pytree

        return cfg, load_pytree(cache_path)
    params = init_primus_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params
