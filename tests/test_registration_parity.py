"""Registration-stack parity vs the reference torch implementation.

The reference hard-codes `.cuda()`; for CPU oracles we no-op it (pure
testing shim — the math is unchanged).
"""

import sys

import numpy as np
import pytest

from tests.conftest import requires_reference

REF_PATH = "/root/reference"


@pytest.fixture(scope="module")
def ref_reg():
    """Import the reference registration modules with .cuda() neutralized
    and its unavailable deps (monai, the removed scipy.ndimage.filters
    alias) stubbed — the functions under test use neither."""
    import sys as _sys
    import types

    torch = pytest.importorskip("torch")
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    # the reference runs stage-1 mesh/scale in fp16 on GPU; CPU torch lacks
    # half kernels, and the fp32 oracle is the right parity target anyway
    torch.Tensor.half = lambda self: self.float()

    if "monai" not in _sys.modules:
        monai = types.ModuleType("monai")
        inferers = types.ModuleType("monai.inferers")
        inferers.sliding_window_inference = None
        monai.inferers = inferers
        _sys.modules["monai"] = monai
        _sys.modules["monai.inferers"] = inferers
    if "scipy.ndimage.filters" not in _sys.modules:
        import scipy.ndimage

        filters = types.ModuleType("scipy.ndimage.filters")
        filters.gaussian_filter = scipy.ndimage.gaussian_filter
        _sys.modules["scipy.ndimage.filters"] = filters
    if "nibabel" not in _sys.modules:
        nib = types.ModuleType("nibabel")
        nib.load = None
        nib.save = None
        nib.Nifti1Image = None
        _sys.modules["nibabel"] = nib

    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    from anatomix.registration import convex_adam_utils as cau
    from anatomix.registration import instance_optimization as io_ref

    return cau, io_ref


def cl(x):
    """torch (1, C, H, W, D) -> channel-last numpy (1, H, W, D, C)."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


@requires_reference
def test_mindssc_parity(rng, ref_reg):
    import torch

    cau, _ = ref_reg
    from anatomix_tpu.registration.mind import mindssc

    img = rng.standard_normal((1, 1, 12, 14, 16)).astype(np.float32)
    ref = cl(cau.MINDSSC(torch.from_numpy(img), 1, 2))
    got = np.asarray(mindssc(np.moveaxis(img, 1, -1), 1, 2))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


@requires_reference
def test_correlate_parity(rng, ref_reg):
    import torch

    cau, _ = ref_reg
    from anatomix_tpu.registration.correlate import correlate

    H = W = D = 12
    hw = 1
    fix = rng.standard_normal((1, 5, H, W, D)).astype(np.float32)
    mov = rng.standard_normal((1, 5, H, W, D)).astype(np.float32)
    ssd_ref, argmin_ref = cau.correlate(
        torch.from_numpy(fix), torch.from_numpy(mov), hw, 1, (H, W, D), 5
    )
    ssd, argmin = correlate(
        np.moveaxis(fix, 1, -1), np.moveaxis(mov, 1, -1), hw
    )
    np.testing.assert_allclose(
        np.asarray(ssd), ssd_ref.numpy(), atol=1e-4, rtol=1e-4
    )
    np.testing.assert_array_equal(np.asarray(argmin), argmin_ref.numpy())


def _correlate_oracle(fix, mov, hw):
    """Direct numpy SSD over the (2·hw+1)³ shifts of the zero-padded moving
    features, smoothed twice by a zero-padded 3³ box mean; fix and mov are
    channel-last (H, W, D, C)."""
    from scipy.ndimage import uniform_filter

    K = 2 * hw + 1
    H, W, D, _ = fix.shape
    mp = np.pad(mov, ((hw, hw),) * 3 + ((0, 0),)).astype(np.float64)
    ssd = np.stack([
        ((fix - mp[sh:sh + H, sw:sw + W, sd:sd + D]) ** 2).sum(-1)
        for sd in range(K) for sw in range(K) for sh in range(K)
    ])
    for _ in range(2):
        ssd = uniform_filter(ssd, size=(1, 3, 3, 3), mode="constant")
    return ssd


@pytest.mark.parametrize("channels,hw,shape", [
    (28, 1, (10, 9, 8)),  # the registration's merged feature width
    (5, 2, (8, 8, 8)),
    (33, 1, (7, 6, 9)),   # padded past one multiple of 32
])
def test_correlate_matches_numpy_oracle(rng, channels, hw, shape):
    from anatomix_tpu.registration.correlate import correlate

    fix = rng.standard_normal(shape + (channels,)).astype(np.float32)
    mov = rng.standard_normal(shape + (channels,)).astype(np.float32)
    ssd, argmin = correlate(fix[None], mov[None], hw)
    ref = _correlate_oracle(fix, mov, hw)
    np.testing.assert_allclose(np.asarray(ssd), ref, rtol=1e-5, atol=1e-4)
    # argmin where the oracle's best shift is clearly ahead of the next
    top2 = np.sort(ref, axis=0)[:2]
    clear = top2[1] - top2[0] > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(argmin)[clear],
                                  ref.argmin(0)[clear])


@requires_reference
def test_displacement_mesh_matches_affine_grid(ref_reg):
    import torch
    import torch.nn.functional as F

    from anatomix_tpu.registration.correlate import displacement_mesh

    hw = 2
    K = 2 * hw + 1
    ref = F.affine_grid(
        hw * torch.eye(3, 4).unsqueeze(0),
        (1, 1, K, K, K),
        align_corners=True,
    ).permute(0, 4, 1, 2, 3).reshape(3, -1).numpy()
    got = displacement_mesh(hw).T  # (3, K³)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@requires_reference
def test_coupled_convex_parity(rng, ref_reg):
    import torch
    import torch.nn.functional as F

    cau, _ = ref_reg
    from anatomix_tpu.registration.correlate import (
        coupled_convex,
        correlate,
        displacement_mesh,
    )

    H = W = D = 12
    hw = 1
    fix = rng.standard_normal((1, 4, H, W, D)).astype(np.float32)
    mov = rng.standard_normal((1, 4, H, W, D)).astype(np.float32)

    ssd_ref, argmin_ref = cau.correlate(
        torch.from_numpy(fix), torch.from_numpy(mov), hw, 1, (H, W, D), 4
    )
    mesh_ref = F.affine_grid(
        hw * torch.eye(3, 4).unsqueeze(0),
        (1, 1, 2 * hw + 1, 2 * hw + 1, 2 * hw + 1),
        align_corners=True,
    ).permute(0, 4, 1, 2, 3).reshape(3, -1, 1)
    disp_ref = cau.coupled_convex(
        ssd_ref, argmin_ref, mesh_ref, 1, (H, W, D)
    )  # (1, 3, H, W, D)

    ssd, argmin = correlate(
        np.moveaxis(fix, 1, -1), np.moveaxis(mov, 1, -1), hw
    )
    disp = coupled_convex(ssd, argmin, displacement_mesh(hw))
    np.testing.assert_allclose(
        np.asarray(disp), cl(disp_ref), atol=1e-4, rtol=1e-3
    )


@requires_reference
def test_inverse_consistency_parity(rng, ref_reg):
    import torch

    cau, _ = ref_reg
    from anatomix_tpu.registration.warp import inverse_consistency

    d1 = (rng.standard_normal((1, 3, 8, 9, 10)) * 0.05).astype(np.float32)
    d2 = (rng.standard_normal((1, 3, 8, 9, 10)) * 0.05).astype(np.float32)
    r1, r2 = cau.inverse_consistency(
        torch.from_numpy(d1), torch.from_numpy(d2), iterations=5
    )
    g1, g2 = inverse_consistency(
        np.moveaxis(d1, 1, -1), np.moveaxis(d2, 1, -1), iterations=5
    )
    np.testing.assert_allclose(np.asarray(g1), cl(r1), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(g2), cl(r2), atol=1e-5, rtol=1e-4)


@requires_reference
def test_instance_opt_parity(rng, ref_reg):
    import torch

    _, io_ref = ref_reg
    from anatomix_tpu.registration.solver import run_instance_opt

    H = W = D = 16
    C = 6
    feat_fix = rng.standard_normal((1, C, H, W, D)).astype(np.float32)
    feat_mov = rng.standard_normal((1, C, H, W, D)).astype(np.float32)
    disp0 = (rng.standard_normal((1, 3, H, W, D)) * 0.5).astype(np.float32)

    ref = io_ref.run_instance_opt(
        torch.from_numpy(disp0),
        torch.from_numpy(feat_fix),
        torch.from_numpy(feat_mov),
        grid_sp_adam=2,
        lambda_weight=0.75,
        sizes=(H, W, D),
        selected_niter=5,
        selected_smooth=0,
        lr=1,
    )
    got = run_instance_opt(
        np.moveaxis(disp0, 1, -1),
        np.moveaxis(feat_fix, 1, -1),
        np.moveaxis(feat_mov, 1, -1),
        grid_sp_adam=2,
        lambda_weight=0.75,
        selected_niter=5,
        selected_smooth=0,
        lr=1.0,
    )
    np.testing.assert_allclose(
        np.asarray(got), cl(ref), atol=5e-3, rtol=1e-2
    )


@requires_reference
def test_stage1_parity(rng, ref_reg):
    import torch

    _, io_ref = ref_reg
    from anatomix_tpu.registration.solver import run_stage1_registration

    H = W = D = 16
    grid_sp = 2
    C = 4
    fix = rng.standard_normal(
        (1, C, H // grid_sp, W // grid_sp, D // grid_sp)
    ).astype(np.float32)
    mov = rng.standard_normal(
        (1, C, H // grid_sp, W // grid_sp, D // grid_sp)
    ).astype(np.float32)

    ref = io_ref.run_stage1_registration(
        torch.from_numpy(fix), torch.from_numpy(mov), 1, grid_sp,
        (H, W, D), C, True,
    )
    got = run_stage1_registration(
        np.moveaxis(fix, 1, -1), np.moveaxis(mov, 1, -1), 1, grid_sp,
        (H, W, D), True,
    )
    # fp16 mesh/scale in the reference vs fp32 here -> loose-ish tolerance
    np.testing.assert_allclose(
        np.asarray(got), cl(ref), atol=5e-3, rtol=1e-2
    )


def test_macro_dice_matches_sklearn(rng):
    sklearn = pytest.importorskip("sklearn")
    from sklearn.metrics import f1_score

    from anatomix_tpu.registration.pipeline import macro_dice

    fixed = rng.integers(0, 4, (10, 10, 10))
    moved = rng.integers(0, 4, (10, 10, 10))
    ref = f1_score(
        fixed.flatten(), moved.flatten(), average="macro",
        labels=np.unique(fixed).astype(int).tolist()[1:],
    )
    assert macro_dice(fixed, moved) == pytest.approx(ref, abs=1e-9)
