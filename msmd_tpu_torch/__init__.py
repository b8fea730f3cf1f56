"""msmd_tpu_torch: the PyTorch / CUDA port of msmd_tpu for an NVIDIA H100.

The JAX package ``msmd_tpu`` is the reference and stays as it is; this
package imports nothing from it and no JAX. Its entry points
(``get_diffusion_model``, ``sample``, ``infer_coeffs``,
``flame_vertices``) run on the card unless the caller passes
``device="cpu"``. The TPU's Pallas kernels on the main path are
hand-written CUDA here (``csrc/``), each with a plain PyTorch version
beside it in ``ops/kernels/``.
"""

__version__ = "0.1.0"

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig  # noqa: F401
