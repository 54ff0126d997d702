"""The anatomix UNet in functional JAX.

Design
------
The reference builds a *flat* `nn.Sequential` encoder-decoder with skip
bookkeeping via index lists (`/root/reference/anatomix/model/network.py:
210-548`). Downstream code depends on those flat indices twice over:
checkpoint keys are `model.<idx>.*`, and the contrastive pretraining taps
activations at indices (default 27,31,38,45,52,65).

Here the architecture is a static *layer plan* — a tuple of layer specs
computed once from the config with the exact same index scheme — and a pure
`unet_apply(plan, params, x)` function that iterates it at trace time. Under
`jax.jit` the whole network compiles to one XLA program (fused conv+norm+act,
no Python dispatch at runtime), data is channel-last (NDHWC) for the
GPU's 3D conv kernels, and batch-norm state is handled functionally.

Constructor surface matches `Unet(dimension, input_nc, output_nc, num_downs,
ngf, norm, final_act, activation, pad_type, doubleconv,
residual_connection, pooling, interp, use_skip_connection, norm_eps)`
(`network.py:262-279`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.ops.activations import get_activation
from anatomix_tpu.ops.conv import conv3d
from anatomix_tpu.ops.norms import (
    batch_norm_inference,
    batch_norm_train,
    instance_norm,
    tiled_instance_norm,
)
from anatomix_tpu.ops.pool import avg_pool, max_pool
from anatomix_tpu.ops.resize import upsample2x


@dataclasses.dataclass(frozen=True)
class UnetConfig:
    """Mirrors the reference `Unet.__init__` signature (`network.py:262`)."""

    dimension: int = 3
    input_nc: int = 1
    output_nc: int = 16
    num_downs: int = 4
    ngf: int = 24
    norm: str = "batch"
    final_act: str = "none"
    activation: str = "relu"
    pad_type: str = "reflect"
    doubleconv: bool = True
    residual_connection: bool = False
    pooling: str = "Max"
    interp: str = "nearest"
    use_skip_connection: bool = True
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.dimension not in (1, 2, 3):
            raise ValueError(
                f"dimension must be 1-3 (network.py:289); got "
                f"{self.dimension}"
            )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # 'conv' | 'norm' | 'act' | 'pool' | 'upsample' | 'final_act'
    in_ch: int = 0
    out_ch: int = 0


@dataclasses.dataclass(frozen=True)
class UnetPlan:
    """Static layer plan with the reference's flat-Sequential index scheme."""

    config: UnetConfig
    layers: tuple[LayerSpec, ...]
    encoder_idx: tuple[int, ...]
    decoder_idx: tuple[int, ...]
    res_source: tuple[int, ...]
    res_dest: tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def conv_indices(self) -> tuple[int, ...]:
        return tuple(
            i for i, s in enumerate(self.layers) if s.kind == "conv"
        )

    def tap_channels(self, layers: Sequence[int]) -> tuple[int, ...]:
        """Channel width of the activation collected at each tap index.

        Needed so the pretraining projector MLPs can be built statically
        (the reference creates them lazily at first forward,
        `pretraining/models/pretraining_networks.py:409-410`).
        """
        widths = {}
        ch = self.config.input_nc
        enc_stack: list[int] = []
        for i, spec in enumerate(self.layers):
            if spec.kind == "conv":
                ch = spec.out_ch
            if self.config.use_skip_connection:
                if i in self.decoder_idx:
                    ch = enc_stack.pop() + ch
                if i in self.encoder_idx:
                    enc_stack.append(ch)
            widths[i] = ch
        return tuple(widths[i] for i in layers)


def build_plan(config: UnetConfig) -> UnetPlan:
    """Reproduce the reference constructor's layer/index layout
    (`network.py:286-465`)."""
    cfg = config
    has_norm = cfg.norm != "none"
    has_act = cfg.activation != "none"
    has_final_act = cfg.final_act != "none"

    layers: list[LayerSpec] = []
    res_source: list[int] = []
    res_dest: list[int] = []
    encoder_idx: list[int] = []
    decoder_idx: list[int] = []

    def add_conv_block(in_ch, out_ch):
        layers.append(LayerSpec("conv", in_ch, out_ch))
        res_source.append(len(layers) - 1)
        if has_norm:
            layers.append(LayerSpec("norm", out_ch, out_ch))
        if has_act:
            layers.append(LayerSpec("act"))
        res_dest.append(len(layers) - 1)

    # Stem
    add_conv_block(cfg.input_nc, cfg.ngf)

    # Encoder
    in_ngf = cfg.ngf
    for i in range(cfg.num_downs):
        mult = 1 if i == 0 else 2
        add_conv_block(in_ngf, in_ngf * mult)
        if cfg.doubleconv:
            add_conv_block(in_ngf * mult, in_ngf * mult)
        encoder_idx.append(len(layers) - 1)
        layers.append(LayerSpec("pool"))
        in_ngf *= mult

    # Bottleneck
    add_conv_block(in_ngf, in_ngf * 2)
    if cfg.doubleconv:
        add_conv_block(in_ngf * 2, in_ngf * 2)

    # Decoder
    mult = 2 ** cfg.num_downs
    for i in range(cfg.num_downs):
        decoder_idx.append(len(layers))
        layers.append(LayerSpec("upsample"))
        m = mult + mult // 2 if cfg.use_skip_connection else mult
        add_conv_block(cfg.ngf * m, cfg.ngf * (mult // 2))
        if cfg.doubleconv:
            add_conv_block(cfg.ngf * (mult // 2), cfg.ngf * (mult // 2))
        mult //= 2

    # Final conv (+ optional final activation), no norm
    layers.append(LayerSpec("conv", cfg.ngf * mult, cfg.output_nc))
    if has_final_act:
        layers.append(LayerSpec("final_act"))

    return UnetPlan(
        config=cfg,
        layers=tuple(layers),
        encoder_idx=tuple(encoder_idx),
        decoder_idx=tuple(decoder_idx),
        res_source=tuple(res_source),
        res_dest=tuple(res_dest),
    )


# -----------------------------------------------------------------------------
# Parameters

def init_params(
    plan: UnetPlan,
    key: jax.Array,
    *,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
    dtype=jnp.float32,
) -> dict[str, Any]:
    """Initialize a parameter pytree (keys = flat layer indices as strings).

    Matches the reference's `init_weights` options
    (`pretraining/models/pretraining_networks.py`): kaiming = He normal
    fan_in, xavier = Glorot normal with gain, normal = N(0, gain),
    orthogonal not supported. Conv bias -> 0; batch-norm scale ~ N(1, gain),
    bias -> 0.
    """
    cfg = plan.config
    use_bias = cfg.norm == "instance"
    params: dict[str, Any] = {}
    # 1D/2D models run as degenerate 3D: leading singleton kernel axes
    # (see `unet_apply`), so the 3D conv path applies unchanged.
    kshape = (1,) * (3 - cfg.dimension) + (3,) * cfg.dimension
    taps = 3 ** cfg.dimension
    if cfg.activation == "prelu":
        # torch nn.PReLU() default: ONE learnable scalar, init 0.25 — and
        # the reference appends the SAME module instance at every act slot
        # (`network.py:301,324` — `Activation` built once), so the weight
        # is shared across all activation layers.
        params["prelu"] = {"w": jnp.full((1,), 0.25, dtype)}
    if cfg.final_act == "prelu":
        # FinalActivation is a separate module instance (`network.py:302`).
        params["final_prelu"] = {"w": jnp.full((1,), 0.25, dtype)}
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            key, sub = jax.random.split(key)
            shape = kshape + (spec.in_ch, spec.out_ch)
            fan_in = spec.in_ch * taps
            fan_out = spec.out_ch * taps
            if init_type == "kaiming":
                std = math.sqrt(2.0 / fan_in)
            elif init_type == "xavier":
                std = init_gain * math.sqrt(2.0 / (fan_in + fan_out))
            elif init_type == "normal":
                std = init_gain
            else:
                raise ValueError(f"Unsupported init_type: {init_type}")
            p = {"w": jax.random.normal(sub, shape, dtype) * std}
            if use_bias:
                p["b"] = jnp.zeros((spec.out_ch,), dtype)
            params[str(idx)] = p
        elif spec.kind == "norm":
            if cfg.norm == "batch":
                key, sub = jax.random.split(key)
                params[str(idx)] = {
                    "scale": 1.0
                    + jax.random.normal(sub, (spec.out_ch,), dtype)
                    * init_gain,
                    "bias": jnp.zeros((spec.out_ch,), dtype),
                    "mean": jnp.zeros((spec.out_ch,), jnp.float32),
                    "var": jnp.ones((spec.out_ch,), jnp.float32),
                }
            elif cfg.norm == "instance_affine":
                params[str(idx)] = {
                    "scale": jnp.ones((spec.out_ch,), dtype),
                    "bias": jnp.zeros((spec.out_ch,), dtype),
                }
            # plain instance norm: parameter-free
    return params


def param_count(params) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))


# -----------------------------------------------------------------------------
# Forward

def unet_apply(
    plan: UnetPlan,
    params: dict[str, Any],
    x: jax.Array,
    *,
    layers: Sequence[int] = (),
    encode_only: bool = False,
    train: bool = False,
    compute_dtype=None,
    bn_axis_name: str | None = None,
    spatial_axis_name: str | None = None,
    eval_norm_layers: Sequence[int] = (),
    in_tile_counts: tuple[int, int, int] | None = None,
    verbose: bool = False,
):
    """Run the UNet on NDHWC input `x`.

    Semantics match `Unet.forward` (`network.py:467-548`):
      * no `layers`: returns the output volume (and batch-stat updates when
        `train=True` with batch norm).
      * `layers=[...]`: returns `(out, [activations at those flat indices])`.
      * `encode_only=True`: early-exits after the last tap, returning only
        the activation list.

    `train=True` makes batch norm use current-batch statistics and also
    returns `new_stats`, a dict of `{layer_idx: (mean, var)}` running-stat
    updates (momentum 0.1, torch-style unbiased update).
    """
    cfg = plan.config
    if cfg.activation == "prelu":
        from anatomix_tpu.ops.activations import prelu

        act = lambda v: prelu(v, params["prelu"]["w"])  # noqa: E731
    else:
        act = get_activation(cfg.activation)
    if cfg.final_act == "prelu":
        from anatomix_tpu.ops.activations import prelu

        final_act = lambda v: prelu(  # noqa: E731
            v, params["final_prelu"]["w"]
        )
    else:
        final_act = get_activation(cfg.final_act)
    layers = tuple(layers)
    want_taps = len(layers) > 0

    # 1D/2D inputs run as degenerate 3D volumes (leading singleton spatial
    # axes, kernels already (1,)*off + (3,)*dim from init/convert); outputs
    # and taps are deflated back to the caller's rank.
    off = 3 - cfg.dimension
    if off:
        x = x.reshape(x.shape[:1] + (1,) * off + x.shape[1:])

    def _deflate(v):
        if not off:
            return v
        return v.reshape((v.shape[0],) + v.shape[1 + off:])

    feat = x
    feats: list[jax.Array] = []
    enc_feats: list[jax.Array] = []
    res_tmp = None
    new_stats: dict[str, tuple] = {}

    for idx, spec in enumerate(plan.layers):
        p = params.get(str(idx))
        if spec.kind == "conv":
            if spatial_axis_name is not None:
                # sharded D axis: halo-exchange pad, local H/W pad, VALID
                from anatomix_tpu.parallel.spatial import halo_pad_d

                padded = halo_pad_d(
                    feat, spatial_axis_name, cfg.pad_type
                )
                mode = {"reflect": "reflect", "replicate": "edge",
                        "zeros": "constant"}[cfg.pad_type]
                padded = jnp.pad(
                    padded,
                    ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)),
                    mode=mode,
                )
                feat = conv3d(
                    padded,
                    p["w"],
                    p.get("b"),
                    padding="VALID",
                    compute_dtype=compute_dtype,
                )
            else:
                feat = conv3d(
                    feat,
                    p["w"],
                    p.get("b"),
                    padding="SAME",
                    pad_type=cfg.pad_type,
                    compute_dtype=compute_dtype,
                )
        elif spec.kind == "norm":
            if cfg.norm == "batch":
                if train and idx not in eval_norm_layers:
                    feat, m, v = batch_norm_train(
                        feat,
                        p["mean"],
                        p["var"],
                        p["scale"],
                        p["bias"],
                        eps=cfg.norm_eps,
                        axis_name=bn_axis_name,
                    )
                    new_stats[str(idx)] = (m, v)
                else:
                    feat = batch_norm_inference(
                        feat,
                        p["mean"],
                        p["var"],
                        p["scale"],
                        p["bias"],
                        eps=cfg.norm_eps,
                    )
            elif cfg.norm == "instance":
                if in_tile_counts is not None:
                    feat = tiled_instance_norm(
                        feat, in_tile_counts, eps=cfg.norm_eps
                    )
                else:
                    feat = instance_norm(
                        feat, eps=cfg.norm_eps, axis_name=spatial_axis_name
                    )
            elif cfg.norm == "instance_affine":
                if in_tile_counts is not None:
                    feat = tiled_instance_norm(
                        feat, in_tile_counts, eps=cfg.norm_eps,
                        scale=p["scale"], bias=p["bias"],
                    )
                else:
                    feat = instance_norm(
                        feat, eps=cfg.norm_eps, scale=p["scale"],
                        bias=p["bias"], axis_name=spatial_axis_name,
                    )
        elif spec.kind == "act":
            feat = act(feat)
        elif spec.kind == "pool":
            win = (1,) * off + (2,) * cfg.dimension
            feat = (
                max_pool(feat, win)
                if cfg.pooling == "Max"
                else avg_pool(feat, win)
            )
        elif spec.kind == "upsample":
            if off:
                from anatomix_tpu.ops.resize import resize3d

                size = tuple(
                    s if i < off else 2 * s
                    for i, s in enumerate(feat.shape[1:4])
                )
                feat = resize3d(
                    feat, size,
                    mode="nearest" if cfg.interp == "nearest"
                    else "trilinear",
                )
            else:
                feat = upsample2x(
                    feat,
                    "nearest" if cfg.interp == "nearest" else "trilinear",
                )
        elif spec.kind == "final_act":
            feat = final_act(feat)

        if cfg.residual_connection and idx in plan.res_source:
            res_tmp = feat
        if cfg.residual_connection and idx in plan.res_dest:
            feat = feat + 0.1 * res_tmp

        if cfg.use_skip_connection:
            if idx in plan.decoder_idx:
                # torch concatenates (encoder, decoder) on the channel axis
                # (`network.py:502`); channel-last keeps the same order.
                feat = jnp.concatenate([enc_feats.pop(), feat], axis=-1)
            if idx in plan.encoder_idx:
                enc_feats.append(feat)

        if verbose:  # reference's layer-shape tracing (`network.py:484-522`)
            print(idx, spec.kind, tuple(feat.shape))

        if want_taps and idx in layers:
            feats.append(_deflate(feat))
            if encode_only and idx == layers[-1]:
                return feats

    feat = _deflate(feat)
    if want_taps:
        return (feat, feats) if not train else (feat, feats, new_stats)
    return feat if not train else (feat, new_stats)


# -----------------------------------------------------------------------------
# Standalone conv block (reference API parity)

def conv_block(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    norm: str = "none",
    norm_params: dict | None = None,
    activation: str = "relu",
    pad_type: str = "zeros",
    stride: int = 1,
    norm_eps: float = 1e-5,
    lrelu_slope: float = 0.2,
    prelu_weight: jax.Array | float = 0.25,
) -> jax.Array:
    """conv + optional norm + activation — the reference's standalone
    `ConvBlock` (`network.py:13-124`, 1-3D: unused by the UNet itself but
    part of the public surface; note its LeakyReLU slope is 0.2 vs the UNet
    factory's 0.3).

    `x` is channel-last with 1-3 spatial dims ((B, L, C) / (B, H, W, C) /
    (B, D, H, W, C)); `w` may be native rank ((k..., I, O)) or degenerate-3D
    DHWIO from `torch_conv_weight_to_jax`. 1D/2D run as degenerate 3D.
    `prelu_weight` is torch `nn.PReLU()`'s learnable scalar (init 0.25).
    """
    ndims = x.ndim - 2
    assert 1 <= ndims <= 3, f"expected 1-3 spatial dims, got input {x.shape}"
    off = 3 - ndims
    if w.ndim == ndims + 2 and off:
        w = w.reshape((1,) * off + w.shape)
    assert w.ndim == 5, f"kernel rank {w.ndim} does not match input"
    if off:
        x = x.reshape(x.shape[:1] + (1,) * off + x.shape[1:])
    if isinstance(stride, int):
        stride = (1,) * off + (stride,) * ndims
    y = conv3d(
        x, w, b, stride=stride, padding="SAME", pad_type=pad_type
    )
    if norm == "batch":
        p = norm_params
        y = batch_norm_inference(
            y, p["mean"], p["var"], p["scale"], p["bias"], eps=norm_eps
        )
    elif norm == "instance":
        y = instance_norm(y, eps=norm_eps)
    if activation == "prelu":
        from anatomix_tpu.ops.activations import prelu

        y = prelu(y, prelu_weight)
    else:
        act = get_activation(activation, lrelu_slope=lrelu_slope)
        y = act(y) if act is not None else y
    if off:
        y = y.reshape((y.shape[0],) + y.shape[1 + off:])
    return y


# -----------------------------------------------------------------------------
# Convenience object

class Unet:
    """Thin convenience wrapper bundling a plan with params.

    Functional code should use `build_plan` + `unet_apply` directly; this
    class exists for API familiarity with the reference's `Unet(...)`.
    """

    def __init__(self, *args, params=None, **kwargs):
        # Accept the reference's positional signature:
        # Unet(dimension, input_nc, output_nc, num_downs, ngf=..., ...)
        names = ["dimension", "input_nc", "output_nc", "num_downs"]
        for name, val in zip(names, args):
            kwargs[name] = val
        self.config = UnetConfig(**kwargs)
        self.plan = build_plan(self.config)
        self.params = params

    def init(self, key, **kw):
        self.params = init_params(self.plan, key, **kw)
        return self.params

    def __call__(self, x, layers=(), encode_only=False, **kw):
        if self.params is None:
            raise ValueError("Call .init(key) or set .params first.")
        return unet_apply(
            self.plan,
            self.params,
            x,
            layers=layers,
            encode_only=encode_only,
            **kw,
        )
