"""autolabel_tpu_torch — the PyTorch + CUDA (Hopper) port of autolabel_tpu.

Same param tree, checkpoint payload and model-hash strings as the JAX
package, which stays the reference. Plain tensor code is PyTorch; the
TPU's Pallas kernels are hand-written CUDA C++ kernels for sm_90a under
csrc/, built lazily on first use on a CUDA device (ops/_kernels.py), so
importing this package compiles nothing.

Entry points run on 'cuda' unless the caller passes device='cpu'; with no
card and no explicit CPU request they raise (device.resolve_device).
"""

__version__ = "0.1.0"
