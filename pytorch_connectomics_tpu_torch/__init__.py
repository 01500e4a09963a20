"""PyTorch/CUDA port of pytorch_connectomics_tpu: training and inference of
the MedNeXt recipes and RSUNet inference with bcd decoding, with
hand-written Hopper kernels for the fused MedNeXt block (inference), the
depthwise 3^3 conv and its weight gradient (training) and RSUNet's dense
3^3 conv.

The package imports torch, numpy and scipy, and nothing of JAX or of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
