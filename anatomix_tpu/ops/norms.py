"""Normalization layers matching torch semantics, channel-last (NDHWC).

Matches the reference norm factory (`/root/reference/anatomix/model/
network.py:127-168`):

* 'batch'    -> BatchNorm3d(eps): affine, running stats (eval uses them).
* 'instance' -> InstanceNorm3d(eps): per-sample/channel spatial stats,
                no affine, no running stats (train == eval).
* 'instance_affine' -> instance norm with learned scale/bias.

Normalization statistics are always computed in float32 regardless of the
activations' dtype (the replacement for AMP: bf16 convs with fp32 norms).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def instance_norm(
    x: jax.Array,
    *,
    eps: float = 1e-5,
    scale: jax.Array | None = None,
    bias: jax.Array | None = None,
    axis_name: str | None = None,
) -> jax.Array:
    """InstanceNorm over spatial dims of an NDHWC array.

    torch InstanceNorm3d(track_running_stats=False) uses biased variance and
    identical behavior in train and eval. With `axis_name`, statistics are
    all-reduced over that mesh axis (spatially sharded volumes; shards must
    be equal-sized).
    """
    # one-pass E[x²]−E[x]² statistics: the (x − mean)² form has two uses
    # of a full-size f32 intermediate, which XLA materializes to device memory (a
    # ~0.5 GB copy per norm at 128³×32ch); the moment form keeps the only
    # full-size pass inside the final normalize fusion. f32 moments are
    # ample for unit-scale activations.
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=(1, 2, 3), keepdims=True)
    m2 = jnp.mean(jnp.square(x32), axis=(1, 2, 3), keepdims=True)
    if axis_name is not None:
        mean = jax.lax.pmean(mean, axis_name)
        m2 = jax.lax.pmean(m2, axis_name)
    var = jnp.maximum(m2 - jnp.square(mean), 0.0)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def _even_chunk_sizes(size: int, n: int) -> list[int]:
    """Split `size` into `n` contiguous chunks as evenly as possible,
    with the invariant `_even_chunk_sizes(2*s, n) == 2*_even_chunk_sizes(s, n)`
    whenever `s >= n` (recursing while the size stays even and splittable).

    The invariant makes tile boundaries line up between a level and the
    level below it (half the size) at EVERY depth, so per-tile statistics
    of a halved volume cover the same voxels; a single halving level is
    not enough (e.g. 352/3: [118,118,116] vs 2*[60,58,58]).
    """
    if size < n:
        raise ValueError(
            f"cannot split size {size} into {n} non-empty tiles "
            "(tile_counts too large for this level's spatial dims)"
        )
    if size % 2 == 0 and size // 2 >= n:
        return [2 * c for c in _even_chunk_sizes(size // 2, n)]
    base, rem = divmod(size, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _chunk_sum(x: jax.Array, axis: int, sizes: list[int]) -> jax.Array:
    """Sum contiguous chunks along `axis` (static boundaries — compiles to a
    handful of slice-reductions; chunk counts are small, typically ≤ 4)."""
    if len(sizes) == 1:
        return jnp.sum(x, axis=axis, keepdims=True)
    parts = []
    off = 0
    for sz in sizes:
        sl = jax.lax.slice_in_dim(x, off, off + sz, axis=axis)
        parts.append(jnp.sum(sl, axis=axis, keepdims=True))
        off += sz
    return jnp.concatenate(parts, axis=axis)


def tiled_instance_norm(
    x: jax.Array,
    tile_counts: tuple[int, int, int],
    *,
    eps: float = 1e-5,
    scale: jax.Array | None = None,
    bias: jax.Array | None = None,
) -> jax.Array:
    """Instance norm with statistics per spatial *tile* of an NDHWC array.

    Each axis is split into `tile_counts[i]` contiguous, as-even-as-possible
    chunks; mean/var are computed per (tile, channel) and each voxel is
    normalized with its own tile's statistics. With `tile_counts=(1,1,1)`
    this is exactly `instance_norm`.

    This is the statistics model of the 'full_tiled' extraction strategy:
    one fully-convolutional forward whose instance-norm context is a
    roi-sized subvolume instead of the whole volume — approximating the
    reference's per-sliding-window normalization
    (`convex_adam_utils.py:202-219`) at 1/27th of the overlap-0.8 FLOPs.
    """
    nt = tuple(tile_counts)
    if nt == (1, 1, 1):
        return instance_norm(x, eps=eps, scale=scale, bias=bias)
    spatial = x.shape[1:4]
    if all(
        len(set(_even_chunk_sizes(s, n))) == 1
        for s, n in zip(spatial, nt)
    ):
        # EVEN tiles: free major-dim splits + cast-fused reductions and
        # a broadcast apply — the generic path materializes f32 squares
        # and rebroadcasts stats via jnp.repeat (while-loops + dynamic-
        # update-slices)
        B, D, H, W, C = x.shape
        t0, t1, t2 = nt
        d0, h0, w0 = D // t0, H // t1, W // t2
        v = x.reshape(B, t0, d0, t1, h0, t2, w0, C)
        cnt = jnp.float32(d0 * h0 * w0)
        mean = jnp.sum(v, axis=(2, 4, 6), dtype=jnp.float32) / cnt
        m2 = jnp.sum(
            jnp.square(v.astype(jnp.float32)), axis=(2, 4, 6)
        ) / cnt
        var = jnp.maximum(m2 - jnp.square(mean), 0.0)
        a = jax.lax.rsqrt(var + eps)
        if scale is not None:
            a = a * scale.astype(jnp.float32)
        bsh = jnp.zeros_like(mean)
        if bias is not None:
            bsh = bsh + bias.astype(jnp.float32)

        def bc(t):
            return t[:, :, None, :, None, :, None, :]

        y = (v.astype(jnp.float32) - bc(mean)) * bc(a) + bc(bsh)
        return y.reshape(x.shape).astype(x.dtype)
    x32 = x.astype(jnp.float32)
    sizes = [_even_chunk_sizes(s, n) for s, n in zip(spatial, nt)]

    s1 = x32
    s2 = jnp.square(x32)
    for ax, sz in zip((1, 2, 3), sizes):
        s1 = _chunk_sum(s1, ax, sz)
        s2 = _chunk_sum(s2, ax, sz)
    counts = (
        np.array(sizes[0], np.float32)[:, None, None]
        * np.array(sizes[1], np.float32)[None, :, None]
        * np.array(sizes[2], np.float32)[None, None, :]
    )[None, ..., None]
    mean = s1 / counts
    var = jnp.maximum(s2 / counts - jnp.square(mean), 0.0)
    inv = jax.lax.rsqrt(var + eps)
    # broadcast per-tile stats back to per-voxel (static uneven repeats)
    for ax, (s, sz) in enumerate(zip(spatial, sizes), start=1):
        reps = np.array(sz)
        mean = jnp.repeat(mean, reps, axis=ax, total_repeat_length=s)
        inv = jnp.repeat(inv, reps, axis=ax, total_repeat_length=s)
    y = (x32 - mean) * inv
    if scale is not None:
        y = y * scale.astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def batch_norm_inference(
    x: jax.Array,
    mean: jax.Array,
    var: jax.Array,
    scale: jax.Array,
    bias: jax.Array,
    *,
    eps: float = 1e-5,
) -> jax.Array:
    """BatchNorm3d in eval mode: running stats + affine, per channel."""
    inv = jax.lax.rsqrt(var.astype(jnp.float32) + eps) * scale.astype(
        jnp.float32
    )
    shift = bias.astype(jnp.float32) - mean.astype(jnp.float32) * inv
    return (x.astype(jnp.float32) * inv + shift).astype(x.dtype)


def _bn_train_impl(x, scale, bias, eps, axis_name):
    """Shared forward: returns (y, mean, biased var, inv)."""
    x32 = x.astype(jnp.float32)
    # reduce every non-channel axis
    reduce_axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(x32, axis=reduce_axes)
    mean_sq = jnp.mean(jnp.square(x32), axis=reduce_axes)
    if axis_name is not None:
        mean = jax.lax.pmean(mean, axis_name)
        mean_sq = jax.lax.pmean(mean_sq, axis_name)
    var = mean_sq - jnp.square(mean)  # biased
    inv = jax.lax.rsqrt(var + eps)
    if x.dtype == jnp.float32:
        y = (x32 - mean) * inv
        y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    else:
        # sub-f32 inputs: fold (mean, invstd, scale, bias) into a
        # per-channel affine applied in the input dtype — the f32
        # materialization of the normalized volume (plus its VJP) was
        # a large share of the pretraining step. Subtract-first form:
        # (x - mean_b) is exact in bf16 near the mean (Sterbenz), so the
        # rounding error scales with the DEVIATION, not the DC offset —
        # the naive x*a + b form loses |mean*a|*2^-8 to cancellation when
        # |mean| >> std (ADVICE r3; test_ops_parity covers N(50, 1)).
        # The channel-mean's own bf16 quantization is folded back into
        # the shift in f32.
        a = inv * scale.astype(jnp.float32)
        m_b = mean.astype(x.dtype)
        bshift = bias.astype(jnp.float32) + (
            m_b.astype(jnp.float32) - mean
        ) * a
        y = (x - m_b) * a.astype(x.dtype) + bshift.astype(x.dtype)
    return y.astype(x.dtype), mean, var, inv


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _bn_train_norm(x, scale, bias, eps, axis_name):
    """(y, mean, biased var) with a hand 2-reduction backward.

    XLA's autodiff through the mean/var graph re-materializes several
    full-size f32 intermediates; the analytic BN adjoint is two fused
    reductions (sum dy, sum dy·x̂) plus one elementwise pass."""
    y, mean, var, _ = _bn_train_impl(x, scale, bias, eps, axis_name)
    return y, mean, var


def _bn_train_norm_fwd(x, scale, bias, eps, axis_name):
    y, mean, var, inv = _bn_train_impl(x, scale, bias, eps, axis_name)
    return (y, mean, var), (x, mean, inv, scale)


def _bn_train_norm_bwd(eps, axis_name, res, cots):
    x, mean, inv, scale = res
    dy, dmean, dvar = cots
    reduce_axes = tuple(range(x.ndim - 1))
    n = int(np.prod([x.shape[a] for a in reduce_axes]))
    dy32 = dy.astype(jnp.float32)
    xc = x.astype(jnp.float32) - mean
    xhat = xc * inv
    s_dy = jnp.sum(dy32, axis=reduce_axes)
    s_dyx = jnp.sum(dy32 * xhat, axis=reduce_axes)
    if axis_name is not None:
        n = n * jax.lax.psum(1, axis_name)
        s_dy = jax.lax.psum(s_dy, axis_name)
        s_dyx = jax.lax.psum(s_dyx, axis_name)
    a = scale.astype(jnp.float32) * inv
    dx = a * (dy32 - s_dy / n - xhat * (s_dyx / n))
    # running-stat cotangents: zero in the training step (the loss does
    # not read the updated stats) but handled exactly — d mean/dx = 1/n,
    # d var/dx = 2(x − mean)/n; rides the same elementwise fusion
    dx = dx + (dmean + dvar * 2.0 * xc) / n
    return (
        dx.astype(x.dtype),
        s_dyx.astype(scale.dtype),
        s_dy.astype(scale.dtype),
    )


_bn_train_norm.defvjp(_bn_train_norm_fwd, _bn_train_norm_bwd)


def batch_norm_train(
    x: jax.Array,
    running_mean: jax.Array,
    running_var: jax.Array,
    scale: jax.Array,
    bias: jax.Array,
    *,
    eps: float = 1e-5,
    momentum: float = 0.1,
    axis_name: str | None = None,
):
    """BatchNorm3d in train mode.

    Normalizes with current-batch statistics (biased variance) and returns
    `(y, new_running_mean, new_running_var)` where the running stats are
    updated with the *unbiased* variance, exactly like torch.

    If `axis_name` is given, statistics are all-reduced across that mesh axis
    (the equivalent of SyncBatchNorm). The backward is the hand analytic
    adjoint (`_bn_train_norm`).
    """
    y, mean, var = _bn_train_norm(x, scale, bias, eps, axis_name)
    n = int(np.prod(x.shape[:-1]))
    if axis_name is not None:
        n = n * jax.lax.psum(1, axis_name)
    unbiased = var * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * running_mean + momentum * mean
    new_var = (1 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def channel_demean(x: jax.Array) -> jax.Array:
    """Subtract each channel's *spatial* mean (the ViT 'demean' output norm,
    `/root/reference/anatomix/model/vit3d/architectures.py:28-33`: NDHWC
    equivalent of `x - x.mean(dim=(2,3,4))`)."""
    return x - jnp.mean(x, axis=(1, 2, 3), keepdims=True)


def channel_layer_norm(x: jax.Array, *, eps: float = 1e-5) -> jax.Array:
    """Per-voxel LayerNorm over channels, no affine (ViT ChannelLayerNorm).

    Statistics are computed in f32; for sub-f32 inputs the normalize is
    applied in the input dtype (a bf16 apply halves the traffic of the
    broadcast mean/rsqrt and changes values by less than bf16 rounding of
    the f32 result)."""
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    if x.dtype == jnp.float32:
        return (x32 - mean) * jax.lax.rsqrt(var + eps)
    inv = jax.lax.rsqrt(var + eps)
    m_b = mean.astype(x.dtype)
    # fold the per-voxel mean's bf16 quantization back in (f32, shape
    # (..., 1)): without it a large DC offset leaves a systematic
    # |mean|*2^-9*inv shift on the ~unit-scale output (ADVICE r3)
    corr = (m_b.astype(jnp.float32) - mean) * inv
    return (x - m_b) * inv.astype(x.dtype) + corr.astype(x.dtype)
