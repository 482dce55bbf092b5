"""PyTorch/CUDA port of face_mask_inpaint_tpu for NVIDIA Hopper (H100).

The JAX package ``face_mask_inpaint_tpu`` is the reference this package is
held against; the module layout mirrors it (``ops/``, ``nn/``, ``models/``,
``data/``, ``evaluations/``, ``utils/``, ``cli/``). Internally everything is
NCHW; the public entry points (``MaskDetector.predict_mask``,
``ReferenceFill.forward``, the CLI's ``infer_batch``) take NHWC images and
``[N, H, W]`` masks, as the JAX package does.

Hand-written kernels live in ``kernels/`` (wrappers, plain versions, launch
counts) with CUDA sources under ``csrc/``. This package never imports JAX.
"""
