"""Pretraining train-step tests: loss sanity, learning signal, DP equivalence,
and SupPatchNCE parity vs the reference torch implementation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.models.unet import UnetConfig, build_plan
from anatomix_tpu.pretraining import (
    build_train_step,
    init_train_state,
    sup_patch_nce_loss,
)

TINY = UnetConfig(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4)


def _setup(mesh=None, batch=2):
    plan = build_plan(TINY)
    taps = (plan.encoder_idx[-1], plan.num_layers - 1)
    state = init_train_state(
        plan, jax.random.PRNGKey(0), tap_layers=taps, num_patches=32,
        netf_nc=16, lr=1e-3,
    )
    step = build_train_step(
        plan, tap_layers=taps, num_patches=32, nce_temperature=0.33,
        lr=1e-3, mesh=mesh, donate=False,
    )
    rng = np.random.default_rng(0)
    views = jnp.asarray(
        rng.standard_normal((batch, 2, 16, 16, 16, 1)).astype(np.float32)
    )
    segs = jnp.asarray(
        rng.integers(0, 3, (batch, 16, 16, 16, 1)).astype(np.int32)
    )
    return plan, state, step, views, segs


def test_train_step_runs_and_learns():
    plan, state, step, views, segs = _setup()
    losses = []
    for i in range(8):
        state, metrics = step(state, views, segs, jax.random.PRNGKey(42))
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert float(metrics["grad_norm_G"]) > 0
        assert float(metrics["grad_norm_F"]) > 0
    # same batch + same sampling rng: loss must go down
    assert losses[-1] < losses[0]
    assert int(state.step) == 8


def test_multidevice_dp_matches_single():
    """Raw pre-update gradients must match between a single-device pass
    and a 4-device DP pass at tight tolerance (ADVICE r3 #4: comparing
    post-Adam weights hid sub-2e-3 errors behind a 2*lr knife-edge
    bound — the optimizer normalizes away gradient magnitude).

    The gradient comparison runs with eval-mode norms: BN-train batch
    statistics are f32 reductions over the sharded batch axis, whose
    GSPMD reassociation injects ~1e-7 activation noise, and the NCE
    gradient of this tiny config is measurably chaotic at that scale
    (a 1e-6 input perturbation moves gradient elements by ~1e-2 via
    activation-kink crossings while the loss moves <1e-6). Eval-mode gradients exercise every DP-relevant path
    (batch sharding, cross-patch NCE coupling, gather backward, grad
    all-reduce) and match at 1e-5; train-mode forward semantics are
    pinned separately by the loss equality below."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from anatomix_tpu.pretraining.train_step import NCEOptions, nce_forward

    devices = np.array(jax.devices()[:4])
    mesh = Mesh(devices, ("data",))
    plan, state, _, views, segs = _setup(batch=4)
    taps = (plan.encoder_idx[-1], plan.num_layers - 1)
    rng = jax.random.PRNGKey(7)

    def make_loss(train):
        def loss_fn(params_g, params_f, views, segs):
            return nce_forward(
                plan, params_g, params_f, views, segs, rng,
                tap_layers=taps, num_patches=32, nce=NCEOptions(),
                train=train,
            )
        return loss_fn

    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P("data"))
    args_repl = (state.params_g, state.params_f, views, segs)
    args_shard = (
        jax.device_put(state.params_g, repl),
        jax.device_put(state.params_f, repl),
        jax.device_put(views, data),
        jax.device_put(segs, data),
    )

    # (a) tight raw-gradient parity, eval-mode norms
    grad_fn = jax.value_and_grad(
        make_loss(train=False), argnums=(0, 1), has_aux=True
    )
    (l1, _), (gg1, gf1) = jax.jit(grad_fn)(*args_repl)
    (l2, _), (gg2, gf2) = jax.jit(
        grad_fn,
        in_shardings=(repl, repl, data, data),
        out_shardings=(repl, repl),
    )(*args_shard)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for g1, g2 in ((gg1, gg2), (gf1, gf2)):
        flat1 = jax.tree_util.tree_leaves_with_path(g1)
        flat2 = jax.tree_util.tree_leaves(g2)
        for (path, a), b in zip(flat1, flat2):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-5,
                err_msg=jax.tree_util.keystr(path),
            )

    # (b) train-mode (BN batch stats) forward semantics: loss equality
    loss_t = make_loss(train=True)
    lt1, _ = jax.jit(loss_t)(*args_repl)
    lt2, _ = jax.jit(
        loss_t,
        in_shardings=(repl, repl, data, data),
        out_shardings=(repl, repl),
    )(*args_shard)
    assert float(lt1) == pytest.approx(float(lt2), rel=1e-5)


def test_running_stats_updated():
    plan, state, step, views, segs = _setup()
    before = np.asarray(state.params_g["1"]["mean"])
    state, _ = step(state, views, segs, jax.random.PRNGKey(0))
    after = np.asarray(state.params_g["1"]["mean"])
    assert not np.allclose(before, after)


def _torch_nce_oracle(features, labels, temperature, weigh_rarity,
                      balance_denominator, weighting_mode):
    """Reference SupPatchNCELoss math re-derived in numpy/torch for testing.

    (The reference module needs an `opt` namespace + a (1,1,D,H,W) seg; this
    oracle reproduces `supcl_model.py:74-226` directly on sampled labels.)
    """
    import torch

    f = torch.from_numpy(features)  # (2, P, C)
    ntps, P, C = f.shape
    feat = torch.nn.functional.normalize(f.reshape(ntps * P, C), dim=-1)
    logits = (feat @ feat.t()) / temperature
    logits = logits - logits.max(dim=1, keepdim=True)[0].detach()
    lab = torch.from_numpy(labels).reshape(1, -1)
    mask = torch.eq(lab, lab.t()).float()
    mask = mask.repeat(ntps, ntps)
    class_counts = mask.sum(1)
    logits_mask = 1 - torch.eye(ntps * P)
    same_class = mask.clone()
    mask = mask * logits_mask
    if balance_denominator:
        n_per_class = class_counts.unsqueeze(0) - same_class
        if weighting_mode == "sqrt":
            n_per_class = n_per_class.sqrt()
        log_w = torch.log(logits_mask / n_per_class)
        log_prob = logits - torch.logsumexp(logits + log_w, dim=1,
                                            keepdim=True)
    else:
        exp_logits = torch.exp(logits) * logits_mask
        log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(1) / mask.sum(1)
    loss = -mean_log_prob_pos
    if weigh_rarity:
        counts = class_counts.sqrt() if weighting_mode == "sqrt" \
            else class_counts
        w = 1.0 / counts
        return float((w * loss).sum() / w.sum())
    return float(loss.reshape(ntps, P).mean())


@pytest.mark.parametrize(
    "rarity,balance,mode",
    [
        (False, False, "raw"),
        (True, False, "raw"),
        (False, True, "raw"),
        (True, True, "sqrt"),
    ],
)
def test_sup_patch_nce_matches_reference_math(rng, rarity, balance, mode):
    pytest.importorskip("torch")
    P = 24
    features = rng.standard_normal((2, P, 8)).astype(np.float32)
    labels = rng.integers(0, 3, P).astype(np.int64)
    ref = _torch_nce_oracle(features, labels, 0.33, rarity, balance, mode)
    got = float(
        sup_patch_nce_loss(
            jnp.asarray(features),
            jnp.asarray(labels),
            temperature=0.33,
            weigh_rarity=rarity,
            balance_denominator=balance,
            weighting_mode=mode,
        )
    )
    assert got == pytest.approx(ref, rel=1e-4, abs=1e-5)


def test_sample_patch_coords_foreground_mask():
    """Masked sampling draws distinct foreground voxels; background only
    fills in when the foreground is smaller than num_patches."""
    from anatomix_tpu.pretraining.patch_sample import (
        nearest_downsample,
        sample_patch_coords,
    )

    spatial = (8, 8, 8)
    mask = np.zeros(spatial, np.float32)
    mask[2:5, 1:7, 3:6] = 1.0  # 54 foreground voxels
    m = jnp.asarray(mask)

    coords = np.asarray(
        sample_patch_coords(jax.random.PRNGKey(0), spatial, 32, mask=m)
    )
    assert coords.shape == (32, 3)
    assert (mask[coords[:, 0], coords[:, 1], coords[:, 2]] == 1).all()
    flat = (coords[:, 0] * 8 + coords[:, 1]) * 8 + coords[:, 2]
    assert len(np.unique(flat)) == 32  # without replacement

    # num_patches > foreground: every fg voxel selected, rest background
    coords2 = np.asarray(
        sample_patch_coords(jax.random.PRNGKey(1), spatial, 100, mask=m)
    )
    fg_hits = mask[coords2[:, 0], coords2[:, 1], coords2[:, 2]].sum()
    assert fg_hits == 54
    flat2 = (coords2[:, 0] * 8 + coords2[:, 1]) * 8 + coords2[:, 2]
    assert len(np.unique(flat2)) == 100

    # two keys give different draws
    coords3 = np.asarray(
        sample_patch_coords(jax.random.PRNGKey(2), spatial, 32, mask=m)
    )
    assert not np.array_equal(coords, coords3)

    # nearest_downsample matches torch F.interpolate(mode='nearest')
    import torch
    import torch.nn.functional as F

    vol = np.arange(9 * 10 * 12, dtype=np.float32).reshape(9, 10, 12)
    ours = np.asarray(nearest_downsample(jnp.asarray(vol), (3, 5, 5)))
    ref = (
        F.interpolate(torch.from_numpy(vol)[None, None], size=(3, 5, 5),
                      mode="nearest")[0, 0]
        .numpy()
    )
    np.testing.assert_array_equal(ours, ref)


def test_train_step_fg_mask_option():
    """use_fg_mask=True compiles and runs; loss stays finite."""
    plan = build_plan(TINY)
    taps = (plan.encoder_idx[-1], plan.num_layers - 1)
    state = init_train_state(
        plan, jax.random.PRNGKey(0), tap_layers=taps, num_patches=16,
        netf_nc=16, lr=1e-3,
    )
    step = build_train_step(
        plan, tap_layers=taps, num_patches=16, nce_temperature=0.33,
        lr=1e-3, donate=False, use_fg_mask=True,
    )
    rng = np.random.default_rng(0)
    views = jnp.asarray(
        rng.standard_normal((1, 2, 16, 16, 16, 1)).astype(np.float32)
    )
    segs = np.zeros((1, 16, 16, 16, 1), np.int32)
    segs[:, 4:12, 4:12, 4:12] = rng.integers(1, 3, (1, 8, 8, 8, 1))
    state, metrics = step(state, views, jnp.asarray(segs),
                          jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["loss"]))


def test_sample_patch_coords_uniform_without_replacement():
    """Unmasked sampling (Gumbel top-k) draws distinct coords whose
    marginal frequency is uniform — the reference randperm's distribution
    (`pretraining_networks.py:436-460`)."""
    import jax

    from anatomix_tpu.pretraining.patch_sample import sample_patch_coords

    spatial = (4, 4, 8)
    n = 4 * 4 * 8
    p = 16
    counts = np.zeros(n, np.int64)
    trials = 400
    for t in range(trials):
        c = np.asarray(
            sample_patch_coords(jax.random.PRNGKey(t), spatial, p)
        )
        flat = (c[:, 0] * 4 + c[:, 1]) * 8 + c[:, 2]
        assert len(np.unique(flat)) == p  # without replacement
        assert flat.min() >= 0 and flat.max() < n
        counts[flat] += 1
    expected = trials * p / n
    # each voxel's selection count is Binomial(trials, p/n); 5 sigma
    sigma = np.sqrt(trials * (p / n) * (1 - p / n))
    assert np.all(np.abs(counts - expected) < 5 * sigma), (
        counts.min(), counts.max(), expected
    )


def test_sample_patch_coords_exhaustive_when_p_equals_n():
    import jax

    from anatomix_tpu.pretraining.patch_sample import sample_patch_coords

    c = np.asarray(
        sample_patch_coords(jax.random.PRNGKey(0), (2, 2, 2), 8)
    )
    flat = sorted((c[:, 0] * 2 + c[:, 1]) * 2 + c[:, 2])
    assert flat == list(range(8))


def test_multidevice_dp_raw_grads_match_single():
    """Raw gradients BEFORE the optimizer, tight tolerance (ADVICE r3):
    the after-Adam comparison above bounds knife-edge sign flips by the
    step size, which would hide a genuine sub-2e-3 per-element gradient
    bug. Pre-update gradients remove the Adam amplification; a norm-free
    config removes the OTHER amplifier (train-mode BN backward rsqrt on a
    tiny random net turns reduction-order noise into ~1e-4..1e-2 diffs —
    measured 1-vs-4-device; 2e-7 without norms). A missing psum or wrong
    DP scaling still produces O(grad)-sized errors and fails loudly."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from anatomix_tpu.pretraining.train_step import NCEOptions, nce_forward

    plan = build_plan(
        UnetConfig(dimension=3, input_nc=1, output_nc=4, num_downs=2,
                   ngf=4, norm="none")
    )
    taps = (plan.encoder_idx[-1], plan.num_layers - 1)
    state = init_train_state(
        plan, jax.random.PRNGKey(0), tap_layers=taps, num_patches=32,
        netf_nc=16, lr=1e-3,
    )
    nce = NCEOptions(
        temperature=0.33, lambda_nce=1.0, weigh_rarity=False,
        balance_denominator=False, weighting_mode="raw",
    )
    rng = np.random.default_rng(0)
    views = jnp.asarray(
        rng.standard_normal((4, 2, 16, 16, 16, 1)).astype(np.float32)
    )
    segs = jnp.asarray(
        rng.integers(0, 3, (4, 16, 16, 16, 1)).astype(np.int32)
    )

    @jax.jit
    def grads_of(pg, pf, v, s):
        def loss_fn(pg, pf):
            loss, _ = nce_forward(
                plan, pg, pf, v, s, jax.random.PRNGKey(7),
                tap_layers=taps, num_patches=32, nce=nce, train=True,
            )
            return loss
        return jax.grad(loss_fn, argnums=(0, 1))(pg, pf)

    g_single = grads_of(state.params_g, state.params_f, views, segs)

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    v_sh = jax.device_put(views, NamedSharding(mesh, P("data")))
    s_sh = jax.device_put(segs, NamedSharding(mesh, P("data")))
    pg_r = jax.device_put(state.params_g, NamedSharding(mesh, P()))
    pf_r = jax.device_put(state.params_f, NamedSharding(mesh, P()))
    g_dp = grads_of(pg_r, pf_r, v_sh, s_sh)

    flat1 = jax.tree_util.tree_leaves(g_single)
    flat2 = jax.tree_util.tree_leaves(g_dp)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-4
        )
