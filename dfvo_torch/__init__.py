"""DF-VO in PyTorch for NVIDIA Hopper.

The counterpart of ``dfvo_tpu`` (JAX for the TPU), module for module: the
same YAML schema, NHWC tensors and ``[x, y]`` pixel coordinates at every
public function, and hand-written CUDA kernels (``csrc/``) where the JAX
package has Pallas kernels. Imports torch and numpy only.
"""
