"""PyTorch/CUDA port of MASt3R-SLAM for NVIDIA Hopper: tracking, the
backend (retrieval, relocalization, factor graph and bundle adjustment),
the datasets, export and checkpoints, and the command line
(``python -m mast3r_slam_tpu_torch.main``).

The JAX package ``mast3r_slam_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find. This
package imports no JAX. Its entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.

Hand-written CUDA kernels (sources in ``csrc/``, built at first use by
``_build.py``) carry the attention (with and without RoPE), the DPT 3x3
convolutions and the bundle adjustment's Gram; every kernel wrapper takes
its plain PyTorch version only for CPU tensors.
"""
