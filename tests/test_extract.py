"""Feature-extraction pipeline tests: BN folding and end-to-end extraction."""

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.extract import (
    extract_features,
    fold_batchnorm,
    make_feature_extractor,
    minmax,
    unit_normalize,
)
from anatomix_tpu.models.unet import (
    UnetConfig,
    build_plan,
    init_params,
    unet_apply,
)

SMALL = UnetConfig(
    dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4, norm="batch",
)


def _model():
    plan = build_plan(SMALL)
    params = init_params(plan, jax.random.PRNGKey(0))
    # non-trivial running stats
    for key, sub in params.items():
        if "mean" in sub:
            rng = np.random.default_rng(int(key))
            sub["mean"] = jnp.asarray(
                rng.standard_normal(sub["mean"].shape[0]).astype(np.float32)
                * 0.2
            )
            sub["var"] = jnp.asarray(
                (rng.random(sub["var"].shape[0]) + 0.5).astype(np.float32)
            )
    return plan, params


def test_fold_batchnorm_preserves_output():
    plan, params = _model()
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(
            (1, 16, 16, 16, 1), dtype=np.float32
        )
    )
    ref = unet_apply(plan, params, x)
    fplan, fparams = fold_batchnorm(plan, params)
    got = unet_apply(fplan, fparams, x)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), atol=1e-4, rtol=1e-4
    )
    # no norm params remain
    for idx, spec in enumerate(fplan.layers):
        assert spec.kind != "norm"


def test_extractor_single_window_matches_direct():
    plan, params = _model()
    x = np.random.default_rng(1).standard_normal(
        (1, 16, 16, 16, 1)
    ).astype(np.float32)
    extractor = make_feature_extractor(
        plan, params, roi_size=(16, 16, 16), sw_batch_size=1
    )
    got = np.asarray(extractor(jnp.asarray(x)))
    ref = np.asarray(unet_apply(plan, params, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_extract_features_pair():
    plan, params = _model()
    rng = np.random.default_rng(2)
    fixed = rng.random((20, 16, 18)) * 1000 - 200
    moving = rng.random((20, 16, 18)) * 3
    ffix, fmov = extract_features(
        fixed, moving, plan, params, roi_size=(16, 16, 16), sw_batch_size=2,
    )
    assert ffix.shape == (1, 20, 16, 18, 4)
    assert fmov.shape == (1, 20, 16, 18, 4)
    assert np.isfinite(np.asarray(ffix)).all()


def test_minmax():
    arr = np.array([-5.0, 0.0, 10.0])
    out = minmax(arr)
    assert out.min() == 0 and out.max() == 1
    out = minmax(arr, minclip=-1, maxclip=5)
    assert out.min() == 0 and out.max() == 1


def test_unit_normalize():
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((1, 4, 4, 4, 8))
        .astype(np.float32)
    )
    n = np.linalg.norm(np.asarray(unit_normalize(x)), axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-5)


def test_full_strategy_self_consistency():
    """'full' on an aligned volume equals a direct forward; on an unaligned
    volume it pads to 2^num_downs and crops back."""
    plan, params = _model()
    rng = np.random.default_rng(5)
    vol = jnp.asarray(
        rng.standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    )
    full = np.asarray(
        make_feature_extractor(plan, params, strategy="full")(vol)
    )
    direct = np.asarray(unet_apply(plan, params, vol))
    np.testing.assert_allclose(full, direct, atol=1e-4, rtol=1e-4)

    odd = jnp.asarray(
        rng.standard_normal((1, 18, 13, 21, 1)).astype(np.float32)
    )
    out = make_feature_extractor(plan, params, strategy="full")(odd)
    assert out.shape == (1, 18, 13, 21, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_tiled_instance_norm_matches_per_tile():
    """Per-tile stats equal manual per-tile instance norm, even when the
    axes don't divide evenly; (1,1,1) tiles reduce to plain instance norm."""
    from anatomix_tpu.ops.norms import instance_norm, tiled_instance_norm

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 10, 9, 8, 3)).astype(np.float32))

    got = np.asarray(tiled_instance_norm(x, (2, 3, 2), eps=1e-5))
    # manual: split axes into even-ish chunks, normalize each block
    want = np.empty_like(got)
    xb = np.asarray(x)

    def chunks(size, n):
        # boundaries from the library contract (the per-tile statistics
        # below stay an independent numpy oracle)
        from anatomix_tpu.ops.norms import _even_chunk_sizes

        off, out = 0, []
        for s in _even_chunk_sizes(size, n):
            out.append((off, off + s))
            off += s
        return out

    for d0, d1 in chunks(10, 2):
        for h0, h1 in chunks(9, 3):
            for w0, w1 in chunks(8, 2):
                blk = xb[:, d0:d1, h0:h1, w0:w1, :]
                m = blk.mean(axis=(1, 2, 3), keepdims=True)
                v = blk.var(axis=(1, 2, 3), keepdims=True)
                want[:, d0:d1, h0:h1, w0:w1, :] = (blk - m) / np.sqrt(
                    v + 1e-5
                )
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    one = np.asarray(tiled_instance_norm(x, (1, 1, 1), eps=1e-5))
    np.testing.assert_allclose(
        one, np.asarray(instance_norm(x, eps=1e-5)), atol=1e-6
    )


def _instance_model():
    plan = build_plan(
        UnetConfig(
            dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4,
            norm="instance",
        )
    )
    return plan, init_params(plan, jax.random.PRNGKey(3))


def test_full_tiled_single_tile_equals_sliding():
    """With volume == roi there is one window and one tile, so 'full_tiled'
    and 'sliding' are the same computation."""
    plan, params = _instance_model()
    vol = jnp.asarray(
        np.random.default_rng(7)
        .standard_normal((1, 16, 16, 16, 1))
        .astype(np.float32)
    )
    tiled = np.asarray(
        make_feature_extractor(
            plan, params, strategy="full_tiled", roi_size=(16, 16, 16)
        )(vol)
    )
    sliding = np.asarray(
        make_feature_extractor(
            plan, params, strategy="sliding", roi_size=(16, 16, 16)
        )(vol)
    )
    np.testing.assert_allclose(tiled, sliding, atol=1e-4, rtol=1e-4)


def _mean_cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float((num / np.maximum(den, 1e-8)).mean())


def test_full_tiled_vs_sliding():
    """Parity quantification for the documented fast variant: per-voxel
    cosine similarity between 'full_tiled' and reference-exact 'sliding'
    features on a 2×roi volume with octant-varying statistics.

    At this toy scale (random-init ngf=4 net, 16³ windows) per-window
    normalization is intrinsically noisy — even sliding at overlap 0.5 vs
    0.8 agrees at only ~0.8 mean cosine on this input — so the assertions
    are (a) per-tile stats track the sliding output strictly better than
    global stats do, and (b) a sanity floor. Real-scale quantification
    (94M dev model, 256³) is carried by bench.py
    (`dev_full_tiled_vs_sliding_cosine`, random-init weights: about 0.8) —
    the two are different feature *definitions* (per-tile vs per-128³-
    window instance-norm statistics), so ~0.8 is the honest agreement
    level, not a bug.
    """
    plan, params = _instance_model()
    rng = np.random.default_rng(11)
    # smooth volume with octant-dependent gain: tiles/windows see
    # genuinely different statistics, the regime tiled stats are for
    low = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    vol = np.repeat(np.repeat(np.repeat(low, 4, 1), 4, 2), 4, 3)
    gain = np.ones((1, 32, 32, 32, 1), np.float32)
    gain[:, :16] *= 3.0
    gain[:, :, 16:] *= 0.5
    vol = jnp.asarray(vol * gain)

    roi = (16, 16, 16)
    sliding = make_feature_extractor(
        plan, params, strategy="sliding", roi_size=roi, overlap=0.8
    )(vol)
    tiled = make_feature_extractor(
        plan, params, strategy="full_tiled", roi_size=roi
    )(vol)
    glob = make_feature_extractor(plan, params, strategy="full")(vol)

    cos_tiled = _mean_cos(tiled, sliding)
    cos_global = _mean_cos(glob, sliding)
    assert cos_tiled > cos_global, (
        f"tiled {cos_tiled:.3f} should beat global {cos_global:.3f}"
    )
    assert cos_tiled > 0.45, f"mean cosine {cos_tiled:.3f}"


def test_auto_strategy_selection():
    from anatomix_tpu.models.unet import UnetConfig, build_plan, init_params
    import jax as _jax

    plan_in = build_plan(
        UnetConfig(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4,
                   norm="instance")
    )
    params_in = init_params(plan_in, _jax.random.PRNGKey(0))
    # instance norm -> sliding (per-window normalization context)
    fn = make_feature_extractor(
        plan_in, params_in, strategy="auto", roi_size=(16, 16, 16)
    )
    vol = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    assert fn(vol).shape == (1, 16, 16, 16, 4)
