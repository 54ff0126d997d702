"""Benchmark harness — prints a cumulative JSON line after EVERY section.

Primary metric: wall-clock seconds to extract features of a full 256³
volume with the 6M anatomix UNet on one card, using a single full-volume
forward (the tiling-free limit of MONAI-style Gaussian stitching for the
batch-norm eval model; see `anatomix_tpu/extract.py`).

Sections: 6M full and reference-exact sliding 256³, the registration
solver on a 192³ pair, the 26M ViT forward at 128³ and sliding at 256³,
the 94M dev UNet forward at 128³ and full_tiled at 256³, dev reference-
exact sliding with the full_tiled-vs-sliding cosine, one pretraining
step at the reference 128³ crop, the 3D conv rates at the UNet's widths
(with the 1-channel entry conv's share of the primary forward), and the
ViT's attention per block for each implementation.

Every time is the host clock around calls that end in
`jax.block_until_ready` (`utils/benchtools.time_calls`): the first call
(compilation included) is reported apart from the median of the warm
ones. A failed section is reported on stderr, its keys stay null, and the
process exits non-zero after printing the last line.

`ANATOMIX_BENCH_SMOKE=1` runs the same code paths at tiny sizes on the
host CPU to test the harness; it records no time under a metric name.
On the GPU the 6M full forward and the ViT forward are also traced with
`jax.profiler`, and their top device ops (`trace_attrib.py`) go into the
line.
"""

import json
import os
import sys
import time as _walltime

import jax

_T0 = _walltime.perf_counter()
_SMOKE = bool(os.environ.get("ANATOMIX_BENCH_SMOKE"))
if _SMOKE:
    jax.config.update("jax_platforms", "cpu")

from anatomix_tpu.backend import (  # noqa: E402
    card_name_and_power_limit,
    enable_compile_cache,
    platform,
)

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from anatomix_tpu.extract import make_feature_extractor  # noqa: E402
from anatomix_tpu.models.registry import ANATOMIX_VARIANTS  # noqa: E402
from anatomix_tpu.models.unet import (  # noqa: E402
    UnetConfig,
    build_plan,
    init_params,
)
from anatomix_tpu.utils.benchtools import time_calls  # noqa: E402


def _progress(msg: str) -> None:
    """Stage timestamps on stderr (stdout carries only the JSON lines)."""
    elapsed = _walltime.perf_counter() - _T0
    print(f"[bench +{elapsed:7.1f}s] {msg}", file=sys.stderr, flush=True)


_FAILED: list[str] = []


def _section(name: str, fn):
    """Run one section; record a failure and go on to the next."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — reported, and fails the run
        _FAILED.append(name)
        _progress(f"SECTION FAILED {name}: {type(e).__name__}: "
                  f"{str(e)[:300]}")
        return None


def _randn(key, shape):
    return jax.jit(
        lambda k: jax.random.normal(k, shape, jnp.float32)
    )(jax.random.PRNGKey(key))


def _top_ops(fn, *args) -> dict | None:
    """Device time per op of two traced calls of the warm `fn` (GPU only:
    `trace_attrib` reads the GPU planes)."""
    if platform() != "gpu":
        return None
    import tempfile

    from trace_attrib import device_op_times

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for _ in range(2):
                out = fn(*args)
            jax.block_until_ready(out)
        summary = device_op_times(tdir, reps=2, top=15)
    summary.pop("planes")
    return summary


def main() -> int:
    compute_dtype = jnp.bfloat16
    VOL = 64 if _SMOKE else 256
    ROI = (32, 32, 32) if _SMOKE else (128, 128, 128)
    NGF = 4 if _SMOKE else 16
    REG_SIZE = 64 if _SMOKE else 192
    OVERLAP = 0.5 if _SMOKE else 0.8
    NPATCH = 64 if _SMOKE else 512
    dev0 = jax.devices()[0]
    extra: dict = {
        "compute_dtype": "bfloat16",
        "platform": platform(),
        "device_kind": dev0.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power_limit(),
    }
    times: dict = {}

    def record(key, seconds, nd=4):
        times[key] = None if seconds is None else round(seconds, nd)

    def emit():
        extra["failed"] = list(_FAILED)
        if _SMOKE:
            extra["smoke"] = True
            metrics = {k: None for k in times}
        else:
            metrics = dict(times)
        value = metrics.pop("feature_extraction_256ct_seconds_per_chip", None)
        extra.update(metrics)
        print(json.dumps({
            "metric": "feature_extraction_256ct_seconds_per_chip",
            "value": value,
            "unit": "s",
            "extra": extra,
        }), flush=True)

    plan = build_plan(
        UnetConfig(dimension=3, input_nc=1, output_nc=16, num_downs=4,
                   ngf=NGF)
    )
    params = init_params(plan, jax.random.PRNGKey(0))
    vol256 = _randn(1, (1, VOL, VOL, VOL, 1))

    # --- primary: full-volume 256³ extraction -------------------------------
    def _full():
        ext = make_feature_extractor(
            plan, params, strategy="full", compute_dtype=compute_dtype
        )
        extra["trace_6m_full"] = _top_ops(ext, vol256)
        return time_calls(ext, vol256, reps=3)[1]

    record("feature_extraction_256ct_seconds_per_chip",
           _section("full", _full))
    _progress(f"6M full 256 done: {times}")
    emit()

    # --- reference-exact sliding-window mode --------------------------------
    def _sw():
        ext = make_feature_extractor(
            plan, params, strategy="sliding", roi_size=ROI,
            sw_batch_size=4, overlap=OVERLAP, compute_dtype=compute_dtype,
        )
        return time_calls(ext, vol256, reps=2)[1]

    record("sliding_window_mode_seconds", _section("sliding", _sw), 3)
    emit()

    # --- registration solver on a 192³ pair (the reference's 'case time'
    # bracket: features extracted first, solver timed) -----------------------
    from anatomix_tpu.registration.pipeline import register_pair

    rng = np.random.default_rng(3)
    fixed = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500
    moving = rng.random((REG_SIZE,) * 3).astype(np.float32) * 500

    def _reg():
        return register_pair(
            fixed, moving, plan, params, grid_sp=2, disp_hw=1,
            selected_niter=80, grid_sp_adam=2, ic=True,
            extract_strategy="full", compute_dtype=compute_dtype,
        )[1]

    record("registration_solver_seconds_192", _section("registration", _reg),
           3)
    emit()

    # --- anatomix-dev-vit 26M ViT: 128³ forward + 256³ sliding --------------
    if not _SMOKE:
        from anatomix_tpu.models.vit3d import load_primus_v2, primus_apply

        def _vit():
            vit_cfg, vit_params = load_primus_v2(
                ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"]
            )
            fwd = jax.jit(lambda v, p: primus_apply(
                vit_cfg, p, v, compute_dtype=compute_dtype))
            x = _randn(2, (1, 128, 128, 128, 1))
            t1 = time_calls(fwd, x, vit_params, reps=5)[1]
            extra["trace_vit_fwd"] = _top_ops(fwd, x, vit_params)
            ext = make_feature_extractor(
                vit_cfg, vit_params, sw_batch_size=2, overlap=0.8,
                compute_dtype=compute_dtype,
            )
            t2 = time_calls(ext, vol256, reps=2)[1]
            return t1, t2

        t_fwd, t_sw = _section("vit", _vit) or (None, None)
        record("vit_fwd_seconds_128", t_fwd)
        record("vit_sliding_256_seconds", t_sw, 3)
        emit()

    # --- anatomix-dev 94M UNet: 128³ forward + 256³ full_tiled, then
    # reference-exact sliding and the full_tiled-vs-sliding cosine ----------
    if not _SMOKE:
        def _dev():
            dplan = build_plan(
                UnetConfig(**ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"])
            )
            dparams = init_params(dplan, jax.random.PRNGKey(6))
            tiled = make_feature_extractor(
                dplan, dparams, strategy="full_tiled", roi_size=(128,) * 3,
                compute_dtype=compute_dtype,
            )
            x = _randn(2, (1, 128, 128, 128, 1))
            t1 = time_calls(tiled, x, reps=3)[1]
            t2, y_tiled = time_calls(tiled, vol256, reps=2)[1:]
            sliding = make_feature_extractor(
                dplan, dparams, strategy="sliding", roi_size=(128,) * 3,
                overlap=0.8, compute_dtype=compute_dtype,
            )
            t3, y_sw = time_calls(sliding, vol256, reps=1)[1:]

            @jax.jit
            def _cos(a, b):
                a = a.astype(jnp.float32)
                b = b.astype(jnp.float32)
                num = jnp.sum(a * b, axis=-1)
                den = jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(
                    b, axis=-1
                ) + 1e-8
                return jnp.mean(num / den)

            return t1, t2, t3, float(_cos(y_tiled, y_sw))

        t1, t2, t3, cos = _section("dev", _dev) or (None,) * 4
        record("dev_unet_fwd_seconds_128", t1)
        record("dev_unet_full_tiled_256_seconds", t2, 3)
        record("dev_sliding_256_seconds", t3, 3)
        extra["dev_full_tiled_vs_sliding_cosine"] = (
            None if cos is None else round(cos, 4)
        )
        emit()

    # --- pretraining step (reference config: 128³ crop, bs 1, 512 patches,
    # 6 NCE taps) -------------------------------------------------------------
    def _pretrain():
        from anatomix_tpu.pretraining.train_step import (
            build_train_step,
            init_train_state,
        )

        taps = (27, 31, 38, 45, 52, 65)
        crop = ROI[0]
        state = init_train_state(
            plan, jax.random.PRNGKey(0), tap_layers=taps,
            num_patches=NPATCH, netf_nc=256, lr=2e-4,
        )
        step = build_train_step(
            plan, tap_layers=taps, num_patches=NPATCH, nce_temperature=0.33,
            lr=2e-4, compute_dtype=compute_dtype, donate=False,
        )
        views = _randn(4, (1, 2, crop, crop, crop, 1))
        segs = jnp.asarray(
            rng.integers(0, 10, (1, crop, crop, crop, 1)).astype(np.int32)
        )
        return time_calls(
            step, state, views, segs, jax.random.PRNGKey(5), reps=5
        )[1]

    record("pretrain_step_seconds_128crop", _section("pretrain_step",
                                                     _pretrain))
    emit()

    # --- 3D conv rates at the UNet's widths (bf16, reflect padding; nominal
    # FLOPs 2·27·Cin·Cout per voxel) and the entry conv's share -------------
    def _convs():
        from anatomix_tpu.ops.conv import conv3d

        f = jax.jit(lambda a, b: conv3d(a, b, padding="SAME",
                                        pad_type="reflect",
                                        compute_dtype=compute_dtype))
        for ci, co, s in ((NGF, NGF, VOL), (2 * NGF, 2 * NGF, ROI[0]),
                          (1, NGF, VOL)):
            x = _randn(5, (1, s, s, s, ci)).astype(compute_dtype)
            sec = time_calls(f, x, _randn(6, (3, 3, 3, ci, co)), reps=10)[1]
            name = f"conv_{ci}to{co}_{s}"
            record(f"{name}_seconds", sec, 6)
            record(f"{name}_tflops", 2 * 27 * ci * co * s ** 3 / sec / 1e12, 2)
        full = times["feature_extraction_256ct_seconds_per_chip"]
        if full:
            record("entry_conv_share_of_full", sec / full, 4)

    _section("conv_rates", _convs)
    emit()

    # --- ViT attention per block at the production shape, per
    # implementation (`primus.dot_product_attention`) ------------------------
    def _attention():
        from anatomix_tpu.models.vit3d.primus import dot_product_attention

        n, heads, hd = (72, 2, 12) if _SMOKE else (4104, 6, 66)
        q, k, v = (_randn(7 + i, (1, n, heads, hd)).astype(compute_dtype)
                   for i in range(3))
        impls = ("cudnn", "xla", "einsum") if platform() == "gpu" else (
            "xla", "einsum")
        for impl in impls:
            def fwd(q, k, v, impl=impl):
                return dot_product_attention(q, k, v, scale=hd ** -0.5,
                                             implementation=impl)

            def loss(q, k, v, fwd=fwd):
                return jnp.sum(fwd(q, k, v).astype(jnp.float32))

            bwd = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
            record(f"attention_{impl}_fwd_seconds",
                   time_calls(jax.jit(fwd), q, k, v, reps=10)[1], 6)
            record(f"attention_{impl}_fwd_bwd_seconds",
                   time_calls(bwd, q, k, v, reps=10)[1], 6)

    _section("attention", _attention)
    emit()
    _progress(f"bench complete, failed sections: {_FAILED or 'none'}")
    return 1 if _FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
