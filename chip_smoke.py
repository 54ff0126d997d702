"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py            # six phases on one card
    python chip_smoke.py --four     # the cross-device paths on four cards

Every phase goes through the public entry points at the published widths
of `models/registry.py`, with weights made from a fixed seed, and checks
its result against a plain reference on the card:

1. 6M `anatomix`: full 256³ and reference-exact sliding 256³ extraction;
   bf16 against f32 at `highest` matmul precision at 128³, and f32 on the
   card against f32 on the host CPU at 64³.
2. 94M `anatomix-dev`: full_tiled 256³ and one reference-exact window at
   128³, with the same two parity checks.
3. 26M `anatomix-dev-vit`: forward at 128³ and sliding at 256³; attention
   per block and the whole forward against the f32 einsum reference.
4. Registration of a synthetic 192³ pair with 6M features: Dice improves.
5. Few-shot segmentation: five DiceCE steps at crop 128; the loss falls.
6. Pretraining: three steps of the reference config on synthgen views;
   the built step's loss and gradient norms in bf16 against f32, and the
   gradients of the train walk's ops, f32 on the card against the host.

Each phase prints its compile seconds, steady seconds (host clock around
`block_until_ready`: a smoke timing, not a benchmark), the device's peak
bytes so far and its parity numbers. All phases run; the script exits
non-zero if any failed, and only a full pass prints the JSON last line.
With no GPU it exits non-zero before any phase.

`--four` runs only what spans cards, each against its one-card result:
data-parallel pretraining (global batch 4), window-sharded sliding
extraction and the spatially sharded full forward of the 6M at 256³.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

# the f32 parity checks compare the card with the host CPU in-process, so
# the CPU backend must stay available beside the GPU
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from anatomix_tpu.backend import (  # noqa: E402
    card_name_and_power_limit,
    enable_compile_cache,
    platform,
)
from anatomix_tpu.extract import make_feature_extractor  # noqa: E402
from anatomix_tpu.models.registry import ANATOMIX_VARIANTS  # noqa: E402
from anatomix_tpu.models.unet import (  # noqa: E402
    UnetConfig,
    build_plan,
    init_params,
)
from anatomix_tpu.models.vit3d import load_primus_v2, primus_apply  # noqa: E402
from anatomix_tpu.utils.benchtools import time_calls  # noqa: E402

# bf16 production path against f32 at `highest` precision
COS_MIN = 0.999
REL_BF16 = 3e-2
# The random-init 94M instance-norm UNet amplifies bf16 rounding: the same
# comparison on the host CPU gives cosine 0.9975, rel 0.071 at 64³
# (PERF.md, Findings, PR 1).
COS_DEV = 0.995
REL_DEV = 0.1
# f32 on the card against f32 on the host CPU (TF32 would fail this)
REL_F32 = 1e-4
# The built pretraining step, bf16 against f32: its loss, and its gradient
# norms. The whole model's gradient is a poorly conditioned function of its
# forward: rounding moves a ReLU input across zero, which flips that
# voxel's gradient. On the host CPU, f32 itself is 2.2e-2 (rel L2) from
# f64 over the UNet's gradient, and bf16's UNet gradient norm is 2.4e-2
# from f32's at crop 64 (PERF.md, Findings, PR 1). The ops one at a time
# are well conditioned and are held to REL_F32 (`train_ops_parity`).
REL_STEP = 1e-3
REL_STEP_GRAD_NORM = 0.1
# the same computation on four cards against one
REL_SHARDED = 1e-4
# The gradient norms after a data-parallel step, for the same reason: on
# 4 virtual CPU devices against 1, the UNet's differs by 2.4e-4, and each
# is 8.6e-5 and 3.2e-4 from f64 (PERF.md, Findings, PR 1).
REL_SHARDED_GRAD = 1e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Model widths and volume sides of a run."""

    unet6m: dict
    dev: dict
    vit: dict
    vol: int  # full-volume side
    roi: int  # window side (= the ViT's input side)
    cpu_side: int  # side of the f32 card-vs-host parity
    reg: int  # registration pair side
    overlap: float
    sw_batch: int
    patches: int
    taps: tuple
    netf_nc: int


FULL = Sizes(
    unet6m=ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"],
    dev=ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"],
    vit=ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"],
    vol=256, roi=128, cpu_side=64, reg=192, overlap=0.8, sw_batch=4,
    patches=512, taps=(27, 31, 38, 45, 52, 65), netf_nc=256,
)

# The same code paths at sizes a CPU runs in seconds (the tests use it).
TINY = Sizes(
    unet6m=dict(FULL.unet6m, num_downs=2, ngf=4, output_nc=4),
    dev=dict(FULL.dev, num_downs=2, ngf=4, output_nc=4),
    vit=dict(FULL.vit, num_classes=4, embed_dim=48, eva_depth=2,
             eva_numheads=4, input_shape=(16, 16, 16)),
    vol=32, roi=16, cpu_side=16, reg=32, overlap=0.5, sw_batch=2,
    patches=16, taps=(5, 8), netf_nc=16,
)


class Phase:
    """Prints a phase's numbers and collects its failed checks."""

    def __init__(self, name: str):
        self.name = name
        self.failures: list[str] = []

    def note(self, key: str, value) -> None:
        if isinstance(value, float):
            value = f"{value:.6g}"
        print(f"[{self.name}] {key}={value}", flush=True)

    def check(self, key: str, value: float, limit: float, op: str) -> None:
        ok = value >= limit if op == ">=" else value <= limit
        verdict = "ok" if ok else "FAIL"
        print(f"[{self.name}] {key}={value:.6g} (need {op} {limit:g}) "
              f"{verdict}", flush=True)
        if not ok:
            self.failures.append(f"{key}={value:.6g} not {op} {limit:g}")

    def check_true(self, key: str, ok: bool) -> None:
        print(f"[{self.name}] {key} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(key)

    def timed(self, label: str, fn, *args):
        """First call (compile included) and one warm call; returns the
        warm call's output."""
        first, steady, out = time_calls(fn, *args, reps=1)
        self.note(f"{label}.compile_s", first - steady)
        self.note(f"{label}.steady_s", steady)
        return out

    def peak_bytes(self) -> None:
        stats = jax.devices()[0].memory_stats() or {}
        self.note("peak_bytes_in_use", stats.get("peak_bytes_in_use",
                                                 "not reported"))

    def finite(self, key: str, y, shape) -> None:
        y = np.asarray(y.astype(jnp.float32) if hasattr(y, "astype") else y)
        self.check_true(f"{key}.shape {tuple(y.shape)}",
                        tuple(y.shape) == tuple(shape))
        self.check_true(f"{key}.finite", bool(np.isfinite(y).all()))


def mean_cosine(a, b) -> float:
    """Mean over voxels of the cosine between channel vectors."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    num = jnp.sum(a * b, axis=-1)
    den = jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1)
    return float(jnp.mean(num / jnp.maximum(den, 1e-12)))


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randn(seed: int, shape, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)


def _unet(kwargs: dict, seed: int):
    plan = build_plan(UnetConfig(**kwargs))
    return plan, init_params(plan, jax.random.PRNGKey(seed))


def parity_bf16(ph: Phase, key: str, make, x, y16=None,
                cos_min=COS_MIN, rel_max=REL_BF16) -> None:
    """`make(compute_dtype)` builds a `volume -> features` fn; its bf16
    output (`y16`, computed here unless given) is held to the f32 output
    at `highest` matmul precision."""
    if y16 is None:
        y16 = make(jnp.bfloat16)(x)
    with jax.default_matmul_precision("highest"):
        y32 = make(None)(x)
    ph.check(f"{key}.cosine", mean_cosine(y16, y32), cos_min, ">=")
    ph.check(f"{key}.rel_l2", rel_l2(y16, y32), rel_max, "<=")


def parity_host(ph: Phase, key: str, make, *args) -> None:
    """f32 on the default device against the same function on the host
    CPU backend; each leaf of the output is checked."""
    with jax.default_matmul_precision("highest"):
        y_dev = make()(*args)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            y_cpu = make()(*jax.device_put(args, cpu))
    leaves = list(zip(jax.tree_util.tree_leaves(y_dev),
                      jax.tree_util.tree_leaves(y_cpu)))
    for i, (a, b) in enumerate(leaves):
        name = key if len(leaves) == 1 else f"{key}.{i}"
        ph.check(f"{name}.rel_l2_vs_cpu", rel_l2(a, b), REL_F32, "<=")


# ---------------------------------------------------------------------------
# Phases


def phase_6m(sz: Sizes) -> Phase:
    ph = Phase("6m")
    plan, params = _unet(sz.unet6m, 0)
    c = plan.config.output_nc
    vol = randn(1, (1, sz.vol, sz.vol, sz.vol, 1))

    full = make_feature_extractor(plan, params, strategy="full",
                                  compute_dtype=jnp.bfloat16)
    ph.finite("full", ph.timed("full", full, vol), vol.shape[:4] + (c,))
    sliding = make_feature_extractor(
        plan, params, strategy="sliding", roi_size=(sz.roi,) * 3,
        overlap=sz.overlap, sw_batch_size=sz.sw_batch,
        compute_dtype=jnp.bfloat16,
    )
    ph.finite("sliding", ph.timed("sliding", sliding, vol),
              vol.shape[:4] + (c,))

    def make(dtype=None):
        return make_feature_extractor(plan, params, strategy="full",
                                      compute_dtype=dtype)

    parity_bf16(ph, "full_roi", make, randn(2, (1,) + (sz.roi,) * 3 + (1,)))
    parity_host(ph, "full_f32", make,
                randn(3, (1,) + (sz.cpu_side,) * 3 + (1,)))
    ph.peak_bytes()
    return ph


def phase_dev(sz: Sizes) -> Phase:
    ph = Phase("dev")
    plan, params = _unet(sz.dev, 6)
    c = plan.config.output_nc
    vol = randn(1, (1, sz.vol, sz.vol, sz.vol, 1))
    roi = (sz.roi,) * 3

    tiled = make_feature_extractor(plan, params, strategy="full_tiled",
                                   roi_size=roi, compute_dtype=jnp.bfloat16)
    ph.finite("full_tiled", ph.timed("full_tiled", tiled, vol),
              vol.shape[:4] + (c,))

    def window(dtype=None):
        # a roi-sized volume is exactly one reference-exact window
        return make_feature_extractor(plan, params, strategy="sliding",
                                      roi_size=roi, compute_dtype=dtype)

    x = randn(2, (1,) + roi + (1,))
    y16 = ph.timed("window", window(jnp.bfloat16), x)
    ph.finite("window", y16, x.shape[:4] + (c,))
    parity_bf16(ph, "window", window, x, y16, COS_DEV, REL_DEV)

    def full(dtype=None):
        return make_feature_extractor(plan, params, strategy="full",
                                      compute_dtype=dtype)

    parity_host(ph, "full_f32", full,
                randn(3, (1,) + (sz.cpu_side,) * 3 + (1,)))
    ph.peak_bytes()
    return ph


def attention_parity(cfg, params, ph: Phase | None = None, seed: int = 4):
    """Each block's attention in bf16 with the default implementation
    against the f32 einsum reference at `highest` precision, forward and
    input gradient. Returns the worst (cosine, rel_l2) of each."""
    from anatomix_tpu.models.vit3d.primus import _attention, _rope_tables

    n = cfg.num_tokens + cfg.num_register_tokens
    x = randn(seed, (1, n, cfg.embed_dim))
    t = randn(seed + 1, (1, n, cfg.embed_dim))
    rope = _rope_tables(cfg)

    def loss(block, x, dtype, impl):
        y = _attention(cfg, block, x, rope, cfg.num_register_tokens,
                       compute_dtype=dtype, attn_impl=impl)
        return jnp.sum(y.astype(jnp.float32) * t), y

    grad = jax.jit(jax.grad(loss, argnums=1, has_aux=True),
                   static_argnums=(2, 3))
    worst = {"fwd": (1.0, 0.0), "grad": (1.0, 0.0)}
    for i, block in enumerate(params["blocks"]):
        g16, y16 = grad(block, x, jnp.bfloat16, None)
        with jax.default_matmul_precision("highest"):
            g32, y32 = grad(block, x, None, "einsum")
        for key, a, b in (("fwd", y16, y32), ("grad", g16, g32)):
            cos, rel = mean_cosine(a, b), rel_l2(a, b)
            worst[key] = (min(worst[key][0], cos), max(worst[key][1], rel))
            if ph is not None:
                ph.note(f"attn_block{i}.{key}.cosine", cos)
                ph.note(f"attn_block{i}.{key}.rel_l2", rel)
    if ph is not None:
        for key, (cos, rel) in worst.items():
            ph.check(f"attn_{key}.worst_cosine", cos, COS_MIN, ">=")
            ph.check(f"attn_{key}.worst_rel_l2", rel, REL_BF16, "<=")
    return worst


def phase_vit(sz: Sizes) -> Phase:
    ph = Phase("vit")
    cfg, params = load_primus_v2(sz.vit, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    c = cfg.num_classes
    x = randn(2, (1,) + cfg.input_shape + (1,))

    fwd = jax.jit(lambda v, p: primus_apply(cfg, p, v,
                                            compute_dtype=jnp.bfloat16))
    y16 = ph.timed("fwd", fwd, x, params)
    ph.finite("fwd", y16, x.shape[:4] + (c,))
    vol = randn(1, (1, sz.vol, sz.vol, sz.vol, 1))
    sliding = make_feature_extractor(cfg, params, overlap=sz.overlap,
                                     compute_dtype=jnp.bfloat16)
    ph.finite("sliding", ph.timed("sliding", sliding, vol),
              vol.shape[:4] + (c,))

    attention_parity(cfg, params, ph)
    with jax.default_matmul_precision("highest"):
        y32 = jax.jit(lambda v, p: primus_apply(cfg, p, v,
                                                attn_impl="einsum"))(x, params)
    ph.check("fwd.cosine", mean_cosine(y16, y32), COS_MIN, ">=")
    ph.check("fwd.rel_l2", rel_l2(y16, y32), REL_BF16, "<=")
    ph.peak_bytes()
    return ph


def _sphere(size, center, radius):
    g = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(g - np.asarray(center, np.float32), axis=-1)
    img = np.clip(1.0 - dist / radius, 0, 1).astype(np.float32) * 200.0
    return img, (dist < radius).astype(np.float32)


def phase_registration(sz: Sizes) -> Phase:
    from anatomix_tpu.registration.pipeline import macro_dice, register_pair
    from anatomix_tpu.registration.warp import warp_volume

    ph = Phase("registration")
    plan, params = _unet(sz.unet6m, 0)
    s = sz.reg
    r = s // 4
    fixed, fixed_seg = _sphere(s, (s // 2,) * 3, r)
    moving, moving_seg = _sphere(s, (s // 2 + 3, s // 2 - 2, s // 2 + 1), r)
    t0 = time.perf_counter()
    disp, solver_s = register_pair(
        fixed, moving, plan, params, grid_sp=2, disp_hw=1,
        selected_niter=80, grid_sp_adam=2, ic=True,
        extract_strategy="full", compute_dtype=jnp.bfloat16,
    )
    ph.note("register_pair.first_call_s", time.perf_counter() - t0)
    ph.note("solver.steady_s", solver_s)
    moved = np.asarray(warp_volume(
        jnp.asarray(moving_seg)[None, ..., None], disp, mode="nearest"
    ))[0, ..., 0]
    before = macro_dice(fixed_seg, moving_seg)
    after = macro_dice(fixed_seg, moved)
    ph.note("dice_before", before)
    ph.check("dice_after", after, before + 1e-3, ">=")
    ph.peak_bytes()
    return ph


def phase_segmentation(sz: Sizes, steps: int = 5) -> Phase:
    import optax

    from anatomix_tpu.segmentation.model import init_head
    from anatomix_tpu.segmentation.train import build_seg_train_step

    ph = Phase("segmentation")
    plan, backbone = _unet(sz.unet6m, 0)
    n_classes = 2
    params = {
        "backbone": backbone,
        "head": init_head(jax.random.PRNGKey(1), plan.config.output_nc,
                          n_classes),
    }
    s = sz.roi
    img_a, seg_a = _sphere(s, (s // 3,) * 3, s // 5)
    img_b, seg_b = _sphere(s, (2 * s // 3,) * 3, s // 4)
    image = jnp.asarray((img_a + 0.5 * img_b) / 200.0)[None, ..., None]
    labels = jnp.asarray(np.maximum(seg_a, 2 * seg_b), jnp.int32)[None]
    tx = optax.adam(2e-4)
    opt_state = tx.init(params)
    step = build_seg_train_step(plan, tx, compute_dtype=jnp.bfloat16)
    losses = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, image, labels))
        ph.note(f"step{i}.{'compile' if i == 0 else 'steady'}_s",
                time.perf_counter() - t0)
        losses.append(float(loss))
    ph.note("losses", [round(v, 5) for v in losses])
    ph.check_true("loss.finite", bool(np.isfinite(losses).all()))
    ph.check("loss.last_over_first", losses[-1] / losses[0], 1.0 - 1e-6,
             "<=")
    ph.peak_bytes()
    return ph


def synth_views(sz: Sizes, batch: int, seed: int = 0):
    """`batch` pairs of synthgen views of random sphere ensembles, through
    the pretraining augmentation. Returns (views, segs) on the device."""
    from anatomix_tpu.pretraining.config import PretrainConfig
    from anatomix_tpu.pretraining.dataset import make_pair_augment
    from anatomix_tpu.synthgen.core import (
        draw_perlin,
        generate_voxel_sphere,
        sample_gmm,
        transform_uniform,
    )
    from anatomix_tpu.synthgen.transforms_np import view_corruption_chain

    rng = np.random.default_rng(seed)
    s = sz.roi
    augment = make_pair_augment(PretrainConfig(crop_size=s))
    views, segs = [], []
    for b in range(batch):
        label = np.zeros((s,) * 3, np.uint8)
        for k in range(1, 6):
            radius = int(s * rng.uniform(0.1, 0.25))
            shift = rng.integers(-s // 4, s // 4, 3)
            label[generate_voxel_sphere(radius, (s,) * 3, shift) > 0] = k
        ids = np.unique(label)
        pair = []
        for _ in range(2):
            means = transform_uniform(rng.random(len(ids)), 25, 255)
            stds = transform_uniform(rng.random(len(ids)), 5, 20)
            img = sample_gmm(means, stds, label, rng=rng)
            img = img * (1 + 0.02 * draw_perlin((s,) * 3, (4, 8), 0.0, 5.0,
                                                rng))
            pair.append(view_corruption_chain(img, rng).astype(np.float32))
        v, sg = augment(jax.random.PRNGKey(seed + b), jnp.asarray(pair[0]),
                        jnp.asarray(pair[1]), jnp.asarray(label))
        views.append(v)
        segs.append(sg.astype(jnp.int32))
    return jnp.stack(views), jnp.stack(segs)


def _pretrain_parts(sz: Sizes, plan, dtype, mesh=None, donate=True):
    from anatomix_tpu.pretraining.train_step import (
        build_train_step,
        init_train_state,
    )

    state = init_train_state(plan, jax.random.PRNGKey(0),
                             tap_layers=sz.taps, num_patches=sz.patches,
                             netf_nc=sz.netf_nc, lr=2e-4)
    step = build_train_step(plan, tap_layers=sz.taps,
                            num_patches=sz.patches, nce_temperature=0.33,
                            lr=2e-4, compute_dtype=dtype, mesh=mesh,
                            donate=donate)
    return state, step


def train_ops_parity(ph: Phase, channels: int, side: int) -> None:
    """The 6M train walk's ops one at a time (conv with reflect padding,
    batch norm with batch statistics, ReLU, max pool, nearest upsample):
    f32 gradients of a random linear functional, on the card against the
    host CPU. Fed the same inputs, each op is well conditioned."""
    from anatomix_tpu.ops.conv import conv3d
    from anatomix_tpu.ops.norms import batch_norm_train
    from anatomix_tpu.ops.pool import max_pool
    from anatomix_tpu.ops.resize import upsample2x

    c = channels
    x = randn(10, (2, side, side, side, c)) + 0.5

    def bn(x, scale, bias):
        return batch_norm_train(x, jnp.zeros_like(scale),
                                jnp.ones_like(scale), scale, bias)[0]

    ops = {
        "conv": (lambda x, w, b: conv3d(x, w, b, padding="SAME",
                                        pad_type="reflect"),
                 (x, 0.1 * randn(11, (3, 3, 3, c, c)), randn(12, (c,)))),
        "batch_norm": (bn, (x, 1 + 0.1 * randn(13, (c,)), randn(14, (c,)))),
        "relu": (jax.nn.relu, (x,)),
        "max_pool": (max_pool, (x,)),
        "upsample": (upsample2x, (x,)),
    }
    for name, (op, args) in ops.items():
        t = randn(15, jax.eval_shape(op, *args).shape)

        def make(op=op, n=len(args)):
            return jax.jit(jax.grad(lambda t, *a: jnp.sum(op(*a) * t),
                                    argnums=tuple(range(1, n + 1))))

        parity_host(ph, f"train_grad.{name}.c{c}", make, t, *args)


def phase_pretraining(sz: Sizes, steps: int = 3) -> Phase:
    ph = Phase("pretraining")
    plan = build_plan(UnetConfig(**sz.unet6m))
    views, segs = synth_views(sz, batch=1)
    state, step = _pretrain_parts(sz, plan, jnp.bfloat16, donate=False)

    losses = []
    new = state
    for i in range(steps):
        t0 = time.perf_counter()
        new, m = jax.block_until_ready(
            step(new, views, segs, jax.random.PRNGKey(5 + i)))
        ph.note(f"step{i}.{'compile' if i == 0 else 'steady'}_s",
                time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i == 0:
            m16 = m
    ph.note("losses", [round(v, 5) for v in losses])
    ph.check_true("loss.finite", bool(np.isfinite(losses).all()))

    # the first step again in f32 at `highest` precision, from the same state
    _, step32 = _pretrain_parts(sz, plan, None, donate=False)
    with jax.default_matmul_precision("highest"):
        _, m32 = step32(state, views, segs, jax.random.PRNGKey(5))
    for k, limit in (("loss", REL_STEP), ("grad_norm_G", REL_STEP_GRAD_NORM),
                     ("grad_norm_F", REL_STEP_GRAD_NORM)):
        a, b = float(m16[k]), float(m32[k])
        ph.check(f"step.{k}.rel", abs(a - b) / abs(b), limit, "<=")

    ngf = sz.unet6m["ngf"]
    train_ops_parity(ph, ngf, sz.cpu_side)
    train_ops_parity(ph, 8 * ngf, sz.cpu_side // 4)
    ph.peak_bytes()
    return ph


PHASES = (phase_6m, phase_dev, phase_vit, phase_registration,
          phase_segmentation, phase_pretraining)


# ---------------------------------------------------------------------------
# Four cards


def four_pretraining(sz: Sizes, devices) -> Phase:
    """One data-parallel step over the devices (global batch = their
    count) against the same step on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anatomix_tpu.parallel.mesh import data_mesh

    ph = Phase("four.pretraining")
    n = len(devices)
    plan = build_plan(UnetConfig(**sz.unet6m))
    s = sz.roi
    views = randn(3, (n, 2, s, s, s, 1))
    segs = jax.random.randint(jax.random.PRNGKey(4), (n, s, s, s, 1), 0, 6)
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        state, step = _pretrain_parts(sz, plan, None, donate=False)
        _, m1 = jax.block_until_ready(step(state, views, segs, key))
        mesh = data_mesh(devices)
        state_n, step_n = _pretrain_parts(sz, plan, None, mesh=mesh,
                                          donate=False)
        state_n = jax.device_put(state_n, NamedSharding(mesh, P()))
        data = NamedSharding(mesh, P("data"))
        t0 = time.perf_counter()
        _, mn = jax.block_until_ready(step_n(
            state_n, jax.device_put(views, data), jax.device_put(segs, data),
            key))
        ph.note("sharded_step.first_call_s", time.perf_counter() - t0)
    for k, limit in (("loss", REL_SHARDED), ("grad_norm_G", REL_SHARDED_GRAD),
                     ("grad_norm_F", REL_SHARDED_GRAD)):
        a, b = float(mn[k]), float(m1[k])
        ph.check(f"{k}.rel", abs(a - b) / max(abs(b), 1e-30), limit, "<=")
    return ph


def four_sliding(sz: Sizes, devices) -> Phase:
    """Window-sharded sliding extraction against one device."""
    from anatomix_tpu.parallel.mesh import data_mesh

    ph = Phase("four.sliding")
    plan, params = _unet(sz.unet6m, 0)
    vol = randn(1, (1, sz.vol, sz.vol, sz.vol, 1))
    kw = dict(strategy="sliding", roi_size=(sz.roi,) * 3,
              overlap=sz.overlap, sw_batch_size=sz.sw_batch,
              compute_dtype=jnp.bfloat16)
    one = make_feature_extractor(plan, params, **kw)(vol)
    sharded = make_feature_extractor(plan, params, mesh=data_mesh(devices),
                                     **kw)
    ph.check("rel_l2", rel_l2(ph.timed("sharded", sharded, vol), one),
             REL_SHARDED, "<=")
    return ph


def four_spatial(sz: Sizes, devices) -> Phase:
    """The full forward with the volume sharded over a 'space' axis
    against one device, both f32 at `highest` precision."""
    from anatomix_tpu.parallel.mesh import space_mesh

    ph = Phase("four.spatial")
    plan, params = _unet(sz.unet6m, 0)
    vol = randn(1, (1, sz.vol, sz.vol, sz.vol, 1))
    with jax.default_matmul_precision("highest"):
        one = make_feature_extractor(plan, params, strategy="full")(vol)
        sharded = make_feature_extractor(
            plan, params, strategy="full",
            mesh=space_mesh(devices, space=len(devices)),
        )
        y = ph.timed("sharded", sharded, vol)
    ph.check("rel_l2", rel_l2(y, one), REL_SHARDED, "<=")
    return ph


FOUR = (four_pretraining, four_sliding, four_spatial)


# ---------------------------------------------------------------------------


def run(phases, sz: Sizes, *args) -> list[str]:
    """Run every phase; return the failures, each named by its phase."""
    failures = []
    for fn in phases:
        t0 = time.perf_counter()
        try:
            ph = fn(sz, *args)
        except Exception:  # noqa: BLE001 — a crashed phase fails the run
            traceback.print_exc()
            failures.append(f"{fn.__name__}: raised")
            continue
        print(f"[{ph.name}] phase_wall_s={time.perf_counter() - t0:.1f}",
              flush=True)
        failures += [f"{ph.name}: {f}" for f in ph.failures]
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    if platform() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    print(f"card: {card_name_and_power_limit()}", flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x {dev.device_kind}",
          flush=True)

    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: need 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        failures = run(FOUR, FULL, devices[:4])
    else:
        failures = run(PHASES, FULL)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
