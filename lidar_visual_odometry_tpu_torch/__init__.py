"""PyTorch + CUDA port of the lidar odometry engine, for NVIDIA Hopper.

A second package beside ``lidar_visual_odometry_tpu`` (the JAX reference).
Module names mirror the reference's (``ops/``, ``models/``, ``data/``,
``eval/``, ``utils/``); each TPU Pallas kernel on the ported path has a
hand-written CUDA kernel in ``kernels/`` (sources in ``csrc/``). The package
imports torch and numpy only — never jax, and nothing of the JAX package.

Ported so far: the lidar odometry chain (polar ingest → features →
association → fused Gauss-Newton) through
``models.pipeline.OdometryPipeline.run_chunked``.
"""

__version__ = "0.1.0"
