"""3D ViT (Primus/PrimusV2) — EVA-style transformer over 3D patches.

Rebuilds the reference's `anatomix/model/vit3d/` (which wraps the upstream
`dynamic-network-architectures` Primus; the upstream EVA blocks, tokenizer
and patch decoder are functionally part of the model and are reimplemented
here in JAX — SURVEY.md §2.7).
"""

from anatomix_tpu.models.vit3d.primus import (
    PRIMUS_CONFIGS,
    PrimusConfig,
    build_out_norm,
    init_primus_params,
    load_primus_v2,
    primus_apply,
    primus_param_count,
)

__all__ = [
    "PRIMUS_CONFIGS",
    "PrimusConfig",
    "build_out_norm",
    "init_primus_params",
    "load_primus_v2",
    "primus_apply",
    "primus_param_count",
]

from anatomix_tpu.models.vit3d.convert import convert_primus_state_dict  # noqa: E402

__all__.append("convert_primus_state_dict")
