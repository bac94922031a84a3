"""PyTorch + CUDA port of ``nerf_prv_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's layout (``core/``, ``nerf/``, ``ops/``, ``scene/``,
``viewspace/``, ``pipeline/``, ``runtime/``) and names.
Entry points take an explicit ``device`` (default ``"cuda"``); every
hand-written kernel sits in ``ops/`` beside its plain PyTorch version.
"""
