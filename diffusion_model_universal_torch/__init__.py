"""PyTorch / CUDA port of the diffusion-model-universal framework.

A second package beside ``diffusion_model_universal_tpu`` (the JAX
reference, which it never imports). Subpackages mirror the reference's
names (``ops``, ``models``, ``models.layers``, ``utils``, ``scripts``) so
each module's counterpart is found under the same relative path.

The hot GroupNorm and attention ops, and the conv-experiment ops, run as
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use; on CPU tensors the same ops run their plain PyTorch versions. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

#: Message of every option that the port does not run yet.
NOT_PORTED = "not yet ported in the torch package"
