"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The layout mirrors ``src/repro/`` (``core/``, ``core/predictors/``,
``cluster/``, ``kernels/``, ``obs/``) so each counterpart sits at the same
path.  The package imports ``torch``, ``numpy`` and the standard library
only: never ``jax`` and nothing of ``repro``.  ``repro_torch.convert`` turns
the JAX package's numpy-convertible state, forests and views into this
package's tensors, which is how the parity tests feed both packages the
same inputs.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``repro_torch.device.resolve_device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
