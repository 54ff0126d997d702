"""Segmentation model: pretrained backbone + 1×1×1 output head.

Matches `segmentation_utils.load_model` (`/root/reference/anatomix/
segmentation/segmentation_utils.py:36-116`): backbone from hf-variant /
local ckpt / 'scratch', plus a MONAI `UnetOutBlock(3, feat_ch, n_classes+1)`
— a single 1×1×1 conv with bias, no norm, no activation.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.models.load import load_from_hf, load_model as _load_backbone
from anatomix_tpu.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu.models.unet import UnetPlan, unet_apply


def init_head(
    key: jax.Array, feat_channels: int, n_classes: int
) -> dict[str, Any]:
    """1×1×1 conv head for (n_classes + 1) output channels, torch-default
    kaiming-uniform init like MONAI's conv."""
    n_out = n_classes + 1
    bound = 1.0 / np.sqrt(feat_channels)
    kw, kb = jax.random.split(key)
    return {
        "w": jax.random.uniform(
            kw, (1, 1, 1, feat_channels, n_out), jnp.float32,
            -np.sqrt(6.0 / feat_channels), np.sqrt(6.0 / feat_channels),
        ),
        "b": jax.random.uniform(kb, (n_out,), jnp.float32, -bound, bound),
    }


def apply_head(head: dict[str, Any], feats: jax.Array) -> jax.Array:
    return (
        jnp.einsum(
            "bdhwc,co->bdhwo",
            feats.astype(jnp.float32),
            head["w"][0, 0, 0].astype(jnp.float32),
        )
        + head["b"]
    )


def load_seg_model(
    n_classes: int,
    *,
    ckpt_path: str | None = None,
    hf_variant: str | None = None,
    num_downs: int = 4,
    ngf: int = 16,
    output_nc: int = 16,
    norm: str = "batch",
    interp: str = "nearest",
    pooling: str = "Max",
    seed: int = 0,
):
    """Returns (plan, params) where params = {'backbone': ..., 'head': ...}."""
    if (ckpt_path is None) == (hf_variant is None):
        raise ValueError("Provide exactly one of `ckpt_path` or `hf_variant`.")

    if hf_variant is not None:
        plan, backbone = load_from_hf(hf_variant)
        feat_channels = ANATOMIX_VARIANTS[hf_variant]["output_channels"]
    else:
        plan, backbone = _load_backbone(
            ckpt_path=ckpt_path, num_downs=num_downs, ngf=ngf,
            output_nc=output_nc, norm=norm, interp=interp, pooling=pooling,
            allow_scratch=True, seed=seed,
        )
        feat_channels = output_nc

    head = init_head(jax.random.PRNGKey(seed + 1), feat_channels, n_classes)
    return plan, {"backbone": backbone, "head": head}


def seg_forward(
    plan: UnetPlan,
    params: dict[str, Any],
    x: jax.Array,
    *,
    train: bool = False,
    compute_dtype=None,
):
    """Backbone features -> class logits. With train=True returns
    (logits, new_bn_stats)."""
    if train:
        feats, new_stats = unet_apply(
            plan, params["backbone"], x, train=True,
            compute_dtype=compute_dtype,
        )
        return apply_head(params["head"], feats), new_stats
    feats = unet_apply(
        plan, params["backbone"], x, compute_dtype=compute_dtype,
    )
    return apply_head(params["head"], feats)
