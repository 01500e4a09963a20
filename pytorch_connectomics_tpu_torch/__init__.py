"""PyTorch/CUDA port of pytorch_connectomics_tpu: the inference path of the
MedNeXt recipes, with hand-written Hopper kernels for the fused MedNeXt block.

The package imports torch, numpy and scipy, and nothing of JAX or of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
