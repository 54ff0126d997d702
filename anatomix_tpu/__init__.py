"""anatomix-tpu: a JAX/XLA rebuild of anatomix, run on NVIDIA GPUs.

General-purpose 3D biomedical feature extraction (6M `anatomix` UNet, 94M
`anatomix-dev` UNet, 26M `anatomix-dev-vit` 3D ViT), jit-compiled
sliding-window inference with Gaussian-blend stitching, training-free
multimodal registration, few-shot segmentation finetuning, and supervised
PatchNCE contrastive pretraining.

Public API mirrors the reference (`/root/reference/anatomix/__init__.py:7-17`
lazily re-exports `network`, `registration`, `segmentation`): here the
equivalents are `anatomix_tpu.models`, `anatomix_tpu.registration`,
`anatomix_tpu.segmentation`, with `Unet` / `load_from_hf` re-exported at the
top level.
"""

__version__ = "0.1.0"

_LAZY = {
    "models": "anatomix_tpu.models",
    "ops": "anatomix_tpu.ops",
    "registration": "anatomix_tpu.registration",
    "segmentation": "anatomix_tpu.segmentation",
    "pretraining": "anatomix_tpu.pretraining",
    "synthgen": "anatomix_tpu.synthgen",
    "parallel": "anatomix_tpu.parallel",
    "utils": "anatomix_tpu.utils",
}

_LAZY_ATTRS = {
    "Unet": ("anatomix_tpu.models.unet", "Unet"),
    "UnetConfig": ("anatomix_tpu.models.unet", "UnetConfig"),
    "load_from_hf": ("anatomix_tpu.models.load", "load_from_hf"),
    "load_model": ("anatomix_tpu.models.load", "load_model"),
    "ANATOMIX_VARIANTS": ("anatomix_tpu.models.registry", "ANATOMIX_VARIANTS"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        val = getattr(importlib.import_module(mod_name), attr)
        globals()[name] = val
        return val
    raise AttributeError(f"module 'anatomix_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY) + list(_LAZY_ATTRS))
