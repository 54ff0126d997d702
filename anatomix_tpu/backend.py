"""The one place that decides which platform the program runs on.

Every model walk is plain XLA (cuDNN convolutions, XLA fusion), so the
platform changes only which library call XLA is asked for: fused cuDNN
attention on the GPU, the XLA attention lowering on the CPU. A platform
this program was not built for is an error, never a silent fallback.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}


def platform() -> str:
    """'cpu' or 'gpu' for JAX's default backend; raises otherwise."""
    name = jax.default_backend()
    if name not in _PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: this program runs on "
            "'cpu' or 'gpu' (CUDA)"
        )
    return _PLATFORMS[name]


def attention_implementation(dtype) -> str:
    """Default ViT attention implementation (see
    `models/vit3d/primus.dot_product_attention`): cuDNN's fused kernel on
    the GPU for the 16-bit types it takes, XLA's lowering otherwise."""
    half = jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
    return "cudnn" if half and platform() == "gpu" else "xla"


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<repo>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, read in
    a child process that stays off JAX; 'unknown' where there is none."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "unknown"
