"""GPU tier: runs on an NVIDIA card (`python -m pytest tests -m gpu --gpu`)
and skips elsewhere. `chip_smoke.py` calls the same checks in-process."""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from anatomix_tpu.models.vit3d import load_primus_v2


@pytest.mark.gpu
def test_default_attention_matches_einsum_reference(gpu):
    """Each ViT block's bf16 attention with the platform default (cuDNN)
    against the f32 einsum reference, forward and input gradient."""
    cfg, params = load_primus_v2(chip_smoke.FULL.vit, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    worst = chip_smoke.attention_parity(cfg, params)
    for key, (cos, rel) in worst.items():
        assert cos >= chip_smoke.COS_MIN, (key, cos)
        assert rel <= chip_smoke.REL_BF16, (key, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda f: f.__name__)
def test_smoke_phase_on_card(gpu, phase):
    ph = phase(chip_smoke.FULL)
    assert not ph.failures, ph.failures
