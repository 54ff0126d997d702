"""Model-variant end-to-end coverage: dev-style UNet (instance norm, Avg,
trilinear) and the ViT through the sliding-window extractor; conversion CLI
round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.extract import make_feature_extractor
from anatomix_tpu.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu.models.vit3d import PrimusConfig, init_primus_params
from tests.conftest import requires_reference


def test_dev_unet_sliding_extraction(rng):
    """anatomix-dev semantics at test scale: instance norm -> auto picks
    sliding windows."""
    cfg = UnetConfig(
        dimension=3, input_nc=1, output_nc=8, num_downs=3, ngf=8,
        norm="instance", pooling="Avg", interp="trilinear", norm_eps=1e-2,
    )
    plan = build_plan(cfg)
    params = init_params(plan, jax.random.PRNGKey(0))
    extract = make_feature_extractor(
        plan, params, strategy="auto", roi_size=(16, 16, 16),
        sw_batch_size=2, overlap=0.5,
    )
    vol = jnp.asarray(
        rng.standard_normal((1, 24, 20, 18, 1)).astype(np.float32)
    )
    feats = extract(vol)
    assert feats.shape == (1, 24, 20, 18, 8)
    assert np.isfinite(np.asarray(feats)).all()


def test_vit_sliding_extraction(rng):
    """ViT backbone (fixed window) through the extractor."""
    cfg = PrimusConfig(
        input_channels=1, num_classes=4, embed_dim=32, eva_depth=1,
        eva_numheads=2, patch_embed_size=(8, 8, 8),
        input_shape=(16, 16, 16), num_register_tokens=2,
        qk_norm=True, out_norm="demean", version="v2",
    )
    params = init_primus_params(cfg, jax.random.PRNGKey(0))
    extract = make_feature_extractor(
        cfg, params, sw_batch_size=1, overlap=0.25,
    )
    vol = jnp.asarray(
        rng.standard_normal((1, 20, 16, 24, 1)).astype(np.float32)
    )
    feats = extract(vol)
    assert feats.shape == (1, 20, 16, 24, 4)
    assert np.isfinite(np.asarray(feats)).all()


@requires_reference
def test_convert_cli_roundtrip(tmp_path):
    import torch
    import sys

    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    from anatomix.model.network import Unet as TorchUnet

    from anatomix_tpu.models.convert_cli import main
    from anatomix_tpu.models.load import load_model
    from anatomix_tpu.models.unet import unet_apply

    kwargs = dict(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4)
    model = TorchUnet(**kwargs)
    model.eval()
    src = str(tmp_path / "m.pth")
    torch.save(model.state_dict(), src)
    dst = str(tmp_path / "m.npz")
    main([src, dst, "--num_downs", "2", "--ngf", "4", "--output_nc", "4"])

    plan, params = load_model(
        ckpt_path=dst, num_downs=2, ngf=4, output_nc=4,
    )
    x = np.random.default_rng(0).standard_normal(
        (1, 16, 16, 16, 1)
    ).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    got = np.asarray(unet_apply(plan, params, jnp.asarray(x)))
    np.testing.assert_allclose(
        got, np.moveaxis(ref, 1, -1), atol=5e-4, rtol=1e-3
    )
