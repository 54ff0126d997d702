"""Correlation volume + coupled convex solver (ConvexAdam stage 1).

Semantics match `correlate` / `coupled_convex` (`/root/reference/anatomix/
registration/convex_adam_utils.py:409-552`) including:

* displacement flattening order f = shift_D·K² + shift_W·K + shift_H (the
  reference arrives at this via F.unfold + a transpose; verified in
  SURVEY.md) and the matching `disp_mesh` channel order (dH, dW, dD);
* the double 3³ zero-padded box smoothing of each SSD slice
  (count_include_pad semantics);
* the *accumulating* coupled-convex penalty: the reference adds each
  iteration's coupling penalty into the SSD volume in place
  (`coupled += ...` on a view of `ssd`, `convex_adam_utils.py:537-540`), so
  iteration j optimizes ssd + Σ_{j'<=j} coeff_{j'}·penalty_{j'} — faithfully
  reproduced here functionally.

Design: the reference's Python loop over z-shifts + per-row argmin loops
become K³ statically-unrolled shifted SSDs and full-tensor argmins under one
jit — no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.ops.pool import avg_pool3d, box_filter

COUPLED_COEFFS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)


def displacement_mesh(disp_hw: int) -> np.ndarray:
    """(K³, 3) displacement table in grid units, channels (dH, dW, dD),
    flat order f = sd·K² + sw·K + sh (matching `correlate`'s SSD order and
    the reference's affine_grid-derived mesh, `instance_optimization.py:
    169-174`)."""
    K = 2 * disp_hw + 1
    rng = np.arange(K) - disp_hw
    sd, sw, sh = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack(
        [sh.reshape(-1), sw.reshape(-1), sd.reshape(-1)], axis=-1
    ).astype(np.float32)


def correlate(
    feat_fix: jax.Array,  # (1, H', W', D', C) grid-spaced features
    feat_mov: jax.Array,
    disp_hw: int,
) -> tuple[jax.Array, jax.Array]:
    """Brute-force SSD over the (2·hw+1)³ displacement search.

    Returns (ssd (K³, H', W', D'), argmin (H', W', D')). The moving features
    are zero-padded (reference F.pad default).
    """
    K = 2 * disp_hw + 1
    _, H, W, D, C = feat_fix.shape
    # Zero channels pad C to a multiple of 32 and add nothing to the SSD.
    # With them the GPU sums channels with its reduction emitter; a shorter
    # row is summed by an unrolled loop per output element.
    cpad = -C % 32
    fix = jnp.pad(feat_fix[0].astype(jnp.float32),
                  ((0, 0), (0, 0), (0, 0), (0, cpad)))
    mov_pad = jnp.pad(
        feat_mov[0].astype(jnp.float32),
        ((disp_hw,) * 2, (disp_hw,) * 2, (disp_hw,) * 2, (0, cpad)),
    )

    # One reduction over a stacked (K³, C) tail. K³ separate channel sums
    # read the same two inputs, and XLA fuses them into one many-output GPU
    # kernel whose compile takes minutes. The K³ displacement axis stays
    # minor (contiguous) for the box filter and the argmin.
    mov_s = jnp.stack([
        jax.lax.slice(mov_pad, (sh, sw, sd, 0),
                      (sh + H, sw + W, sd + D, C + cpad))
        for sd in range(K) for sw in range(K) for sh in range(K)
    ], axis=-2)  # (H', W', D', K³, C)
    ssd_cl = jnp.sum((fix[..., None, :] - mov_s) ** 2, axis=-1)

    # double 3³ zero-padded box smoothing, channel-last over K³
    ssd_cl = box_filter(ssd_cl[None], kernel_size=3, num_repeats=2)[0]
    ssd = jnp.moveaxis(ssd_cl, -1, 0)  # (K³, H', W', D') public layout
    return ssd, jnp.argmin(ssd_cl, axis=-1)


def coupled_convex(
    ssd: jax.Array,  # (K³, H', W', D')
    ssd_argmin: jax.Array,  # (H', W', D')
    disp_mesh: jax.Array,  # (K³, 3) from displacement_mesh
    coeffs=COUPLED_COEFFS,
) -> jax.Array:
    """Iterative discrete-continuous regularization.

    Returns the regularized displacement field (1, H', W', D', 3) in grid
    units, channels (dH, dW, dD).
    """
    spatial = ssd.shape[1:]

    def soft_from_argmin(argmin):
        disp = jnp.take(disp_mesh, argmin.reshape(-1), axis=0).reshape(
            *spatial, 3
        )
        return avg_pool3d(disp[None], 3, stride=1, padding=1)  # (1,...,3)

    disp_soft = soft_from_argmin(ssd_argmin)
    # channel-last K³ for the elementwise/argmin (see correlate)
    ssd_acc = jnp.moveaxis(ssd, 0, -1)  # (H', W', D', K³)

    for coeff in coeffs:
        # penalty (H', W', D', K³) = ||mesh_f - disp_soft(x)||²
        delta = (
            disp_mesh[None, None, None, :, :]
            - disp_soft[0][..., None, :]
        )
        ssd_acc = ssd_acc + coeff * jnp.sum(delta ** 2, axis=-1)
        disp_soft = soft_from_argmin(jnp.argmin(ssd_acc, axis=-1))

    return disp_soft
