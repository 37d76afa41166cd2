"""LM serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
